"""K1: GAE as one CUDA kernel (``csrc/gae.cu``).

Counterpart of :func:`dcc_tpu.ops.pallas_gae.compute_gae_pallas`: the same
drop-in signature for the ``bad_masks=None`` path. On a CUDA tensor the
kernel runs (or the call raises); on a CPU tensor the plain version,
:func:`dcc_tpu_torch.ops.gae.compute_gae`, computes the same recurrence.

The kernel cuts time into segments: a block is a stripe of ``W`` columns
times ``S`` segments of ``L`` steps, one thread per (column, segment), and
:func:`gae_plan` picks the numbers.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from . import cuda_build as cb
from .gae import compute_gae

MAX_COLS = 32  # columns of a block's stripe: one warp's 128-byte row
MAX_SEGMENT = 32  # steps a thread holds in registers
MAX_SEGMENTS = 32  # segments of a plan
# threads whose loads in flight fill the card's memory rate (the best of the
# plans that scripts/gae_plans.py times on the H100 at T = 150, 16,384 columns)
TARGET_THREADS = 262144


def max_block_threads(L: int) -> int:
    """Threads a block may have for segments of ``L`` steps (the kernel's
    launch bounds, ``max_threads`` in ``csrc/gae.cu``: 64 registers a thread
    up to 8 steps, 128 above)."""
    return 1024 if L <= 8 else 512


@functools.lru_cache(maxsize=None)
def gae_plan(T: int, B: int) -> Tuple[int, int, int, int]:
    """``(W, S, L, blocks)`` of K1 for ``T >= 1`` steps of ``B >= 1`` columns.

    As many segments (at most 32) as keep about 262,144 threads in flight,
    so fewer where ``B`` is large, and no more than ``T`` needs:
    (16, 30, 5, 1) at T = 150, B = 16 and (32, 15, 10, 512) at B = 16,384.
    Where ``S * L < T`` (at most 32 steps a segment and the block's thread
    limit) the kernel walks time in rounds of ``S * L`` steps from the end.
    """
    W = min(B, MAX_COLS)
    L = min(MAX_SEGMENT, -(-T // min(MAX_SEGMENTS, -(-TARGET_THREADS // B))))
    S = min(-(-T // L), MAX_SEGMENTS, max_block_threads(L) // W)
    return W, S, L, -(-B // W)


def gae_columns_cuda(r, values, masks, gamma: float, gae_lambda: float):
    """Launch K1 on (T, B) rewards and (T + 1, B) values and masks, f32
    contiguous CUDA columns; returns (adv, ret), each (T, B)."""
    cb.require(r, "rewards", (torch.float32,))
    if r.dim() != 2:
        raise ValueError(f"rewards must be (T, B), got shape {tuple(r.shape)}")
    T, B = r.shape
    cb.require(values, "values", (torch.float32,), (T + 1, B), r.device)
    cb.require(masks, "masks", (torch.float32,), (T + 1, B), r.device)
    adv = torch.empty_like(r)
    ret = torch.empty_like(r)
    if r.numel() == 0:
        return adv, ret
    W, S, L, _ = gae_plan(T, B)
    code = cb.library("gae").dcc_gae_seg(
        r.data_ptr(), values.data_ptr(), masks.data_ptr(), adv.data_ptr(), ret.data_ptr(),
        T, B, W, S, L, float(gamma), float(gamma * gae_lambda), cb.stream_of(r),
    )
    cb.check("gae", code, "gae")
    cb.LAUNCHES["gae"] += 1
    cb.ENTRY["gae"] = "dcc_gae_seg"
    return adv, ret


def compute_gae_cuda(
    rewards: torch.Tensor,  # (T, ..., 1)
    values: torch.Tensor,  # (T+1, ..., 1) denormalized
    masks: torch.Tensor,  # (T+1, ..., 1)
    gamma: float,
    gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (advantages, returns) of the three's broadcast trailing
    shape (separated policies: (T, E, 1, 1) rewards and masks against
    (T+1, E, A, 1) values give (T, E, A, 1))."""
    if not rewards.is_cuda:
        return compute_gae(rewards, values, masks, gamma, gae_lambda)
    trailing = rewards.shape[1:]
    if values.shape[1:] != trailing or masks.shape[1:] != trailing:
        trailing = torch.broadcast_shapes(trailing, values.shape[1:], masks.shape[1:])

    def columns(x):  # (rows, ...) -> (rows, prod(trailing)) f32, copied only if needed
        if x.shape[1:] != trailing:
            x = x.expand((x.shape[0],) + tuple(trailing))
        return x.reshape(x.shape[0], -1).to(torch.float32).contiguous()

    adv, ret = gae_columns_cuda(columns(rewards), columns(values), columns(masks), gamma,
                                gae_lambda)
    shape = (rewards.shape[0],) + tuple(trailing)
    return adv.reshape(shape).to(rewards.dtype), ret.reshape(shape).to(rewards.dtype)
