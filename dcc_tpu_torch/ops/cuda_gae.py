"""K1: GAE as one CUDA kernel (``csrc/gae.cu``).

Counterpart of :func:`dcc_tpu.ops.pallas_gae.compute_gae_pallas`: the same
drop-in signature for the ``bad_masks=None`` path. On a CUDA tensor the
kernel runs (or the call raises); on a CPU tensor the plain version,
:func:`dcc_tpu_torch.ops.gae.compute_gae`, computes the same recurrence.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_build as cb
from .gae import compute_gae


def gae_columns_cuda(r, vn, vc, m, gamma: float, gae_lambda: float):
    """Launch K1 on (T, B) f32 contiguous CUDA columns; returns (adv, ret)."""
    T, B = r.shape
    for name, t in (("rewards", r), ("v_next", vn), ("v_cur", vc), ("m_next", m)):
        cb.require(t, name, (torch.float32,), (T, B), r.device)
    adv = torch.empty_like(r)
    ret = torch.empty_like(r)
    code = cb.library("gae").dcc_gae(
        r.data_ptr(), vn.data_ptr(), vc.data_ptr(), m.data_ptr(), adv.data_ptr(),
        ret.data_ptr(), T, B, float(gamma), float(gamma * gae_lambda), cb.stream_of(r),
    )
    cb.check("gae", code, "gae")
    cb.LAUNCHES["gae"] += 1
    return adv, ret


def compute_gae_cuda(
    rewards: torch.Tensor,  # (T, ..., 1)
    values: torch.Tensor,  # (T+1, ..., 1) denormalized
    masks: torch.Tensor,  # (T+1, ..., 1)
    gamma: float,
    gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (advantages, returns) shaped like ``rewards``."""
    if not rewards.is_cuda:
        return compute_gae(rewards, values, masks, gamma, gae_lambda)
    r, vn, vc, m = torch.broadcast_tensors(rewards, values[1:], values[:-1], masks[1:])
    T, trailing = r.shape[0], r.shape[1:]
    cols = [x.reshape(T, -1).to(torch.float32).contiguous() for x in (r, vn, vc, m)]
    adv, ret = gae_columns_cuda(*cols, gamma, gae_lambda)
    shape = (T,) + tuple(trailing)
    return adv.reshape(shape).to(r.dtype), ret.reshape(shape).to(r.dtype)
