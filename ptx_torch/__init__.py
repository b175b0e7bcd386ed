"""ptx_torch — the PyTorch / CUDA port of ptx, for NVIDIA Hopper.

A second package beside :mod:`ptx` (JAX + Pallas for the TPU), laid out
module for module like it, so each counterpart sits at the same path.
The JAX package is the reference: every module here is tested against
its JAX counterpart on identical inputs.  This package imports torch and
never jax.

Conventions:

- plain functions on tensors; every function that creates tensors takes
  an explicit ``device``;
- random draws come from :mod:`ptx_torch.core.rng`, a bit-exact port of
  ``jax.random``'s threefry, so both packages draw the same numbers from
  the same key;
- float32 throughout;
- each Pallas kernel of the JAX package becomes a hand-written CUDA
  kernel under ``csrc/``, with its plain PyTorch version beside the
  wrapper in ``ops/``.
"""

import torch

# float32 everywhere, including contractions.  TF32 keeps ~3 decimal
# digits; reduced precision in geometry contractions is the fault class
# of the JAX package's bf16 plane-interval bug (fixed by pinning
# precision=HIGHEST, commit 828be98).  Matmuls default to full f32
# already; convolutions through cuDNN do not.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
