"""eval_device_ms: the device time of the evaluator's ``eval`` spans in
the traced slice (``evaln/transductive.py``: encode, the four edge sets'
scores, the metrics and their one host transfer) over their number, in
ms."""

from llpbench.program_spans import eval_ms


def read(ctx):
    return eval_ms(ctx)
