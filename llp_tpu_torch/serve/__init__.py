from llp_tpu_torch.serve.engine import (  # noqa: F401
    encode_graph_nodes,
    encode_nodes,
    load_serving_artifacts,
    score_pairs,
    top_k_partners,
)
from llp_tpu_torch.serve.quant import QuantTable, quantize_table  # noqa: F401
from llp_tpu_torch.serve.server import (  # noqa: F401
    BackgroundServer,
    BatchingEngine,
    ServingState,
    make_server,
    serve_forever,
)
