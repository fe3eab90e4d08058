"""PyTorch + CUDA port of the MX training-instability system (H100, sm_90a).

The JAX package ``repro`` is the reference; this package keeps its module
names so the counterpart of each file is easy to find.  Every Pallas kernel
on the serving path is a hand-written CUDA C++ kernel here
(``repro_torch.kernels.csrc``), built at first use and bound with ctypes.

Entry points (``ServeEngine``, ``lm_init``, ``params_from_jax``) run on
``cuda`` unless the caller passes ``device="cpu"``; without a CUDA device
they raise instead of quietly running on the CPU.

The reference's fp32 math is IEEE fp32, so TF32 and reduced-precision bf16
reductions are switched off for every matmul this package issues.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

from .devices import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
