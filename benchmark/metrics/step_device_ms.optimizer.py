"""step_device_ms.optimizer: the device time of the trainer's
``<model>.optimizer`` spans in the traced slice (``llp_tpu_torch.utils.profiling``:
the stream's time from the end of the work queued before a span to the
end of its own) over the number of ``<model>.step`` spans, in ms."""

from llpbench.program_spans import step_phase_ms


def read(ctx):
    return step_phase_ms(ctx, "optimizer")
