"""Shared utilities: device selection and the optax-style gradient clip."""

from __future__ import annotations

from typing import Iterable, Optional

import torch


def resolve_device(device: Optional[str] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Without a GPU, the default raises rather than run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU"
        )
    return dev


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all tensors (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Clip the ``.grad`` of ``params`` in place as ``optax.clip_by_global_norm``
    does (``g / norm * max_norm`` when norm >= max_norm; unlike
    ``torch.nn.utils.clip_grad_norm_`` no 1e-6 is added to the norm).
    Returns the norm before clipping. Runs on the device without a sync."""
    grads = [p.grad for p in params]
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


__all__ = ["clip_by_global_norm_", "global_norm", "resolve_device"]
