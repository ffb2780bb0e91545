"""segsum_roofline: the bytes every neighbour-mean SpMM (forward and
backward) and gathers' backward of the slice's steps and evals needs
(``llpbench.roofline.segsum_bytes``: input rows, output rows, int32
indices and offsets once), at HBM's 3.35 TB/s, over the device time of
the kernels below (``llp_tpu_torch/csrc/segsum.cu``, B1), in %."""

from llpbench import roofline

KERNELS = ("segsum_vec_kernel", "segsum_scalar_kernel")


def read(ctx):
    s = ctx.slice
    if s is None or not s.work.get("steps") or not s.work.get("segsum_bytes_step"):
        return None
    us = s.kernel_us(KERNELS)
    if us <= 0:
        return None
    nbytes = (s.work["steps"] * s.work["segsum_bytes_step"]
              + s.work["evals"] * s.work["segsum_bytes_eval"])
    return 100.0 * nbytes / roofline.HBM_BYTES_PER_S / (us * 1e-6)
