"""train_step_mfu.teacher: the SAGE teacher's training steps and evals in
the traced slice, their model operations (forward and backward, no
recompute; ``llpbench.roofline.sage_teacher_step``) over the slice's time
and the fp32 peak (67 TFLOP/s), in %."""

from llpbench.readers import step_mfu


def read(ctx):
    return step_mfu(ctx) if ctx.config["model"] == "sage-teacher" else None
