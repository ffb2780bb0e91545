"""device_idle_share.step: 100 · the traced slice's idle gaps that open
while the host is inside a program ``<model>.step`` span or one of its
children (placed on the trace's clock by the program's own marker) / the
slice's length, in %."""

from llpbench.program_spans import idle_share


def read(ctx):
    return idle_share(ctx, "step")
