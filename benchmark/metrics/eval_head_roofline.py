"""eval_head_roofline: the least time the pairs of the slice's
``edge_score.unfused`` spans (``llp_tpu_torch/ops/edge_score.py``: a head
that the fused kernel does not take, scored in pair blocks) need on the
card, over the spans' summed device time, in %.

The least time of a span's ``pairs`` is the larger of the head's
operations (``roofline.mlp_head_flops`` at the configuration's
``hidden_channels`` and the span's ``head_layers``; 'inner', with none,
a multiply and an add a feature) at the fp32 peak and its bytes at HBM's
3.35 TB/s: two gathered fp32 rows of ``hidden_channels`` a pair, its two
int64 ids and its fp32 score.  These count the work, not this
implementation: a fused head would be held to the same bound.  None
where the slice holds no such span."""

from llpbench import roofline
from llpbench.program_spans import session

SPAN = "edge_score.unfused"


def least_s(pairs: int, hidden: int, head_layers: int) -> float:
    flops = (roofline.mlp_head_flops(pairs, hidden, head_layers) if head_layers
             else 2.0 * pairs * hidden)
    nbytes = pairs * (2 * 4.0 * hidden + 2 * 8.0 + 4.0)
    return max(flops / roofline.FP32_FLOP_PER_S, nbytes / roofline.HBM_BYTES_PER_S)


def read(ctx):
    found = session(ctx)
    if found is None:
        return None
    spans = [sp for sp in found[0] if sp.name == SPAN]
    if not spans or any(sp.device_ms is None for sp in spans):
        return None
    ms = sum(sp.device_ms for sp in spans)
    if ms <= 0:
        return None
    hidden = int(ctx.config["hidden_channels"])
    need = sum(least_s(sp.counts["pairs"], hidden, sp.counts["head_layers"]) for sp in spans)
    return 100.0 * need / (ms * 1e-3)
