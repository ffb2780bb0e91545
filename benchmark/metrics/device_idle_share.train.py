"""device_idle_share.train: 100 · (1 - the union of device activity in
the traced slice / the slice's length), in a training cell."""

from llpbench.readers import idle_share


def read(ctx):
    return idle_share(ctx) if ctx.traffic["driver"] == "train" else None
