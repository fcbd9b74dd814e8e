"""K2: the fused MLP trunk forward (``csrc/fused_mlp.cu``) and its plain
PyTorch version.

Counterpart of :func:`dcc_tpu.ops.fused_mlp.fused_mlp` (forward only; the
fused-trunk backward ``_bwd_kernel`` is ROADMAP item K2b). The trunk is
feature LN -> [Dense -> act -> LN] x L with the JAX package's numerics:
LN statistics in f32 with ``var = max(E[x^2] - E[x]^2, 0)`` and eps 1e-6;
in bf16 mode matmul operands are rounded to bf16 with f32 accumulation, the
Dense result is rounded and the bias added in bf16, activation and LN run in
f32 and the LN output is rounded to bf16; f32 mode is full f32.

``params`` is the flat list ``[fn_scale, fn_bias]? + [W_i, b_i, s_i, c_i]
* L`` with ``W_i`` shaped (d_in, d_out) as a flax Dense kernel and 1-D
vectors. The plain version is differentiable (autograd passes through the
bf16 rounding); the kernel has no backward and refuses a tensor that needs
a gradient.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import cuda_build as cb

EPS = 1e-6


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to the nearest bf16, keeping the f32 dtype."""
    return x.to(torch.bfloat16).to(torch.float32)


def ln_stats(x: torch.Tensor):
    """f32 mean and 1/sqrt(var + eps) per row, fast variance."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return mu, torch.rsqrt(var + EPS)


def dense(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor, bf16: bool) -> torch.Tensor:
    """a @ w + b in the given mode (w is (d_in, d_out)); f32 result."""
    if bf16:
        z = bf16_round(bf16_round(a) @ bf16_round(w))
        return bf16_round(z + bf16_round(b))
    return a.to(torch.float32) @ w + b


def activation(z: torch.Tensor, use_relu: bool, bf16: bool) -> torch.Tensor:
    if use_relu:
        return torch.relu(z)
    r = torch.tanh(z)
    return bf16_round(r) if bf16 else r


def trunk_forward_plain(
    x: torch.Tensor,
    params: Sequence[torch.Tensor],
    n_layers: int,
    use_fn: bool = True,
    use_relu: bool = True,
    bf16: bool = False,
) -> torch.Tensor:
    """Plain PyTorch K2 on (rows, d_in); returns (rows, H) in bf16 or f32."""
    a = x.to(torch.float32)
    i = 0
    if use_fn:
        mu, inv = ln_stats(a)
        a = (a - mu) * inv * params[0] + params[1]
        a = bf16_round(a) if bf16 else a
        i = 2
    for _ in range(n_layers):
        w, b, s, c = params[i : i + 4]
        i += 4
        r = activation(dense(a, w, b, bf16), use_relu, bf16)
        mu, inv = ln_stats(r)
        a = (r - mu) * inv * s + c
        a = bf16_round(a) if bf16 else a
    return a.to(torch.bfloat16) if bf16 else a


def trunk_param_shapes(d_in: int, hidden: int, n_layers: int, use_fn: bool) -> list:
    """Shapes of the flat trunk list for ``d_in``-wide rows."""
    shapes = [(d_in,), (d_in,)] if use_fn else []
    d = d_in
    for _ in range(n_layers):
        shapes += [(d, hidden), (hidden,), (hidden,), (hidden,)]
        d = hidden
    return shapes


def require_shapes(tensors: Sequence[torch.Tensor], want: list, what: str) -> None:
    """Raise unless the kernel's parameters have the shapes it will index."""
    got = [tuple(t.shape) for t in tensors]
    if got != want:
        raise ValueError(f"{what} shapes {got}, expected {want}")


def pack_params(params: Sequence[torch.Tensor], device) -> tuple:
    """Concatenate f32 parameters into one buffer; returns (buffer, offsets)."""
    flat = [p.detach().to(device=device, dtype=torch.float32).reshape(-1) for p in params]
    offs, o = [], 0
    for p in flat:
        offs.append(o)
        o += p.numel()
    return torch.cat(flat).contiguous(), offs


def tile_rows(width: int, floats_per_row_fn, budget: int = 232448) -> int:
    """Largest row tile the kernels are built for (32, 8 or 1) whose shared
    memory, ``4 * floats_per_row_fn(tile)`` bytes, fits one H100 block."""
    for br in (32, 8, 1):
        if 4 * floats_per_row_fn(br) <= budget:
            return br
    raise ValueError(f"a {width}-wide row does not fit the shared-memory budget")


def trunk_forward_cuda(
    x: torch.Tensor,
    params: Sequence[torch.Tensor],
    n_layers: int,
    use_fn: bool = True,
    use_relu: bool = True,
    bf16: bool = False,
    packed: Optional[tuple] = None,
) -> torch.Tensor:
    """Launch K2 on (rows, d_in) f32 or bf16 CUDA rows. ``packed`` is
    ``pack_params(params, x.device)`` made beforehand, or None to pack here."""
    rows, d_in = x.shape
    cb.require(x, "x", (torch.float32, torch.bfloat16), device=x.device)
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        raise RuntimeError(
            "the fused trunk kernel has no backward yet (ROADMAP K2b); run it "
            "under torch.no_grad()"
        )
    hidden = params[-4].shape[1]
    require_shapes(params, trunk_param_shapes(d_in, hidden, n_layers, use_fn), "trunk")
    pb, offs = pack_params(params, x.device) if packed is None else packed
    cb.require(pb, "packed parameters", (torch.float32,),
               (sum(p.numel() for p in params),), x.device)
    if not use_fn:
        offs = [0, 0] + offs
    br = tile_rows(d_in, lambda b: b * (max(d_in, hidden) + hidden))
    out = torch.empty(
        (rows, hidden), dtype=torch.bfloat16 if bf16 else torch.float32, device=x.device
    )
    offs_c = (cb._L * len(offs))(*offs)
    code = cb.library("fused_mlp").dcc_trunk_fwd(
        x.data_ptr(), int(x.dtype == torch.bfloat16), rows, d_in, hidden, n_layers,
        int(use_fn), int(use_relu), int(bf16), br, pb.data_ptr(), offs_c, len(offs),
        out.data_ptr(), cb.stream_of(x),
    )
    cb.check("fused_mlp", code, "fused_mlp")
    cb.LAUNCHES["fused_mlp"] += 1
    return out


def fused_mlp(
    x: torch.Tensor,
    params: Sequence[torch.Tensor],
    *,
    n_layers: int,
    use_feature_norm: bool = True,
    use_relu: bool = True,
    bf16: bool = False,
    packed: Optional[tuple] = None,
) -> torch.Tensor:
    """Apply the trunk to ``x`` of shape (..., d_in): the K2 kernel for a
    CUDA tensor (with ``packed`` as in :func:`trunk_forward_cuda`), the
    plain version for a CPU tensor."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda:
        out = trunk_forward_cuda(
            x2.contiguous(), params, n_layers, use_feature_norm, use_relu, bf16, packed
        )
    else:
        out = trunk_forward_plain(x2, params, n_layers, use_feature_norm, use_relu, bf16)
    return out.reshape(*lead, out.shape[-1])
