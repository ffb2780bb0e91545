"""train_step_mfu.student: the MLP student's distillation steps and evals
in the traced slice, their model operations (the MLP over the gathered
rows, the student's head on the context and link pairs forward and
backward, the frozen teacher head forward;
``llpbench.roofline.mlp_student_step``) over the slice's time and the fp32
peak (67 TFLOP/s), in %."""

from llpbench.readers import step_mfu


def read(ctx):
    return step_mfu(ctx) if ctx.config["model"] == "mlp-student" else None
