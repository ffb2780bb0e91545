"""llp_tpu_torch — Linkless Link Prediction in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The port of the JAX package ``llp_tpu``: the same checkpoints, datasets and
CLI flags, on a GPU.  It imports neither JAX nor ``llp_tpu``.  Entry points
run on the card unless the caller passes ``--device cpu``; on a CPU tensor
each kernel's wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
