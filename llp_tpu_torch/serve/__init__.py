from llp_tpu_torch.serve.engine import (  # noqa: F401
    encode_graph_nodes,
    encode_nodes,
    load_serving_artifacts,
    score_pairs,
    top_k_partners,
)
