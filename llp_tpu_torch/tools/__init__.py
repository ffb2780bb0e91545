"""Probes run by hand on a card (``probes.py``); nothing here is imported by
the package."""
