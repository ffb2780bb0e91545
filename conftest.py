"""Test configuration loaded before ``tests/conftest.py``: give each xdist
worker an equal share of the cores for its intra-op threads.

PyTorch's pool defaults to a thread per core in every worker; on the suite's
small graphs those threads only contend with the other workers'.  Only
workers set it (the controller's export would reach them first), before torch
is imported, and a value exported beforehand wins.  Processes the tests start
inherit it.
"""

import os

if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    _threads = str(max(1, os.cpu_count() // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))
    os.environ.setdefault("OMP_NUM_THREADS", _threads)
    os.environ.setdefault("MKL_NUM_THREADS", os.environ["OMP_NUM_THREADS"])
