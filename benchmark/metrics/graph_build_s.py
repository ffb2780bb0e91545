"""graph_build_s: the benchmark's span around the program building its
graph (``build_graph``: both sorted views) and moving the inputs onto the
device, from the generated host arrays, in seconds."""


def read(ctx):
    return ctx.host_spans.get("graph_build")
