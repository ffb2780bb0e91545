from llp_tpu_torch.core.graph import Graph, build_graph  # noqa: F401
