"""Plain PyTorch ops and the hand-written CUDA kernels K1-K4.

Importing this package builds nothing; a kernel is built at its first CUDA
call (:mod:`dcc_tpu_torch.ops.cuda_build`).
"""

from .cuda_build import LAUNCHES, reset_launches
from .cuda_gae import compute_gae_cuda
from .gae import compute_gae, discounted_returns

__all__ = [
    "LAUNCHES",
    "compute_gae",
    "compute_gae_cuda",
    "discounted_returns",
    "reset_launches",
]
