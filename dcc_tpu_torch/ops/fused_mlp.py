"""K2 / K2b: the fused MLP trunk forward (``csrc/fused_mlp.cu``) and backward
(``csrc/fused_mlp_bwd.cu``), their plain PyTorch versions, and the autograd
Function that joins them.

Counterpart of :func:`dcc_tpu.ops.fused_mlp.fused_mlp` and its custom VJP.
The trunk is feature LN -> [Dense -> act -> LN] x L with the JAX package's
numerics: LN statistics in f32 with ``var = max(E[x^2] - E[x]^2, 0)`` and eps
1e-6; in bf16 mode matmul operands are rounded to bf16 with f32
accumulation, the Dense result is rounded and the bias added in bf16,
activation and LN run in f32 and the LN output is rounded to bf16; f32 mode
is full f32.

The backward (``_bwd_kernel`` of the JAX package) recomputes the forward
from ``x`` and runs the chain in f32: LN backward with affine, the
activation's derivative, ``db`` from the un-rounded cotangent, and in bf16
mode ``dW = bf16(a)^T bf16(g)`` and ``g_prev = bf16(g) bf16(W)^T`` with f32
accumulation. That is not autograd of the bf16 forward (which would round
the cotangents where the forward rounds its values), so the plain backward
writes the chain out.

``params`` is the flat list ``[fn_scale, fn_bias]? + [W_i, b_i, s_i, c_i]
* L`` with ``W_i`` shaped (d_in, d_out) as a flax Dense kernel and 1-D
vectors. :func:`fused_mlp` goes through :class:`FusedTrunk`, so it is
differentiable on both devices; the raw launcher :func:`trunk_forward_cuda`
has no backward and refuses a tensor that needs a gradient.

In bf16 K2 and K2b run on the tensor cores (``csrc/trunk_mma.cuh``) and
read a bf16 copy of each weight, zero-padded to multiples of 16
(:func:`pack_mma_weights`); :func:`pack_trunk` makes it beside the f32
buffer of the vectors, once per parameter version (``MLPBase.packed_params``),
and :class:`FusedTrunk` hands the forward's pack to the backward. K2b
re-sums in sequential order every relu pre-activation whose side the tensor
cores' summation order could change, so that its relu masks agree with the
plain version's. In f32 both stay on full-f32 FMA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from . import cuda_build as cb
from . import tiles
from .tiles import SMEM_MAX

EPS = 1e-6
# distance from a relu kink within which two f32 summation orders may take
# opposite sides (the f32 kink rule of the kernel checks)
F32_KINK_EPS = 1e-5


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


def _forward_chain(x, params, n_layers, use_fn, use_relu, bf16):
    """The trunk on (rows, d_in) f32, keeping what the backward needs: the
    feature norm's (xhat, inv) and per layer (a, r, xhat, inv), with ``a``
    the layer's input and ``r`` its activation as the chain rounds them.
    Returns (output f32, feature-norm cache or None, layer caches)."""
    a = x.to(torch.float32)
    i, fn_cache = 0, None
    if use_fn:
        mu, inv = ln_stats(a)
        xhat = (a - mu) * inv
        fn_cache = (xhat, inv)
        a = xhat * params[0] + params[1]
        a = bf16_round(a) if bf16 else a
        i = 2
    layers = []
    for _ in range(n_layers):
        w, b, s, c = params[i : i + 4]
        i += 4
        r = activation(dense(a, w, b, bf16), use_relu, bf16)
        mu, inv = ln_stats(r)
        xhat = (r - mu) * inv
        layers.append((a, r, xhat, inv))
        a = xhat * s + c
        a = bf16_round(a) if bf16 else a
    return a, fn_cache, layers


def trunk_forward_plain(
    x: torch.Tensor,
    params: Sequence[torch.Tensor],
    n_layers: int,
    use_fn: bool = True,
    use_relu: bool = True,
    bf16: bool = False,
) -> torch.Tensor:
    """Plain PyTorch K2 on (rows, d_in); returns (rows, H) in bf16 or f32."""
    a, _, _ = _forward_chain(x, params, n_layers, use_fn, use_relu, bf16)
    return a.to(torch.bfloat16) if bf16 else a


def _ln_bwd(g, xhat, inv, scale):
    """d(input), d(scale), d(bias) of y = xhat * scale + bias (f32)."""
    gg = g * scale
    dx = inv * (gg - gg.mean(dim=-1, keepdim=True)
                - xhat * (gg * xhat).mean(dim=-1, keepdim=True))
    return dx, (g * xhat).sum(dim=0), g.sum(dim=0)


def trunk_bwd_chain(g, params, fn_cache, layers, n_layers: int, use_fn: bool,
                    use_relu: bool, bf16: bool):
    """The backward of the chain that :func:`_forward_chain` cached: the
    cotangent ``g`` (rows, H) of the trunk output back to (f32 cotangent of
    the trunk's input, [f32 gradient of each parameter])."""
    mm = (lambda p, q: bf16_round(p) @ bf16_round(q)) if bf16 else torch.matmul
    g = g.to(torch.float32)
    grads = [None] * len(params)
    i = len(params)
    for li in reversed(range(n_layers)):
        a, r, xhat, inv = layers[li]
        i -= 4
        g, grads[i + 2], grads[i + 3] = _ln_bwd(g, xhat, inv, params[i + 2])
        g = g * (r > 0).to(g.dtype) if use_relu else g * (1.0 - r * r)
        grads[i] = mm(a.t(), g)
        grads[i + 1] = g.sum(dim=0)
        g = mm(g, params[i].t())
    if use_fn:
        xhat, inv = fn_cache
        g, grads[0], grads[1] = _ln_bwd(g, xhat, inv, params[0])
    return g, grads


def trunk_backward_plain(
    x: torch.Tensor,
    params: Sequence[torch.Tensor],
    g: torch.Tensor,
    n_layers: int,
    use_fn: bool = True,
    use_relu: bool = True,
    bf16: bool = False,
):
    """Plain PyTorch K2b: the cotangent ``g`` (rows, H) of the trunk output
    back to (dx in x.dtype, [f32 gradient of each parameter])."""
    with torch.no_grad():
        _, fn_cache, layers = _forward_chain(x, params, n_layers, use_fn, use_relu, bf16)
        g, grads = trunk_bwd_chain(g, params, fn_cache, layers, n_layers, use_fn, use_relu,
                                   bf16)
    return g.to(x.dtype), grads


def relu_kink_rows(x, params, n_layers: int, use_fn: bool = True,
                   bf16: bool = False) -> torch.Tensor:
    """(rows,) bool: rows with a relu pre-activation z within
    ``F32_KINK_EPS`` of 0, and in bf16 also those with z no farther from
    the kink than the bf16 spacing at its pre-rounding accumulator. There
    two summation orders (kernel and plain version) may take opposite sides
    of the kink: in f32 by rounding, in bf16 because another order (the tensor cores') can move
    the accumulator across a bf16 rounding boundary. The row's gradient then
    differs at full size; the kernel checks give these rows a zero
    cotangent (:func:`dcc_tpu_torch.ops.fused_ppo.relu_kink_rows_folded` is
    the folded chain's rule)."""
    with torch.no_grad():
        _, _, layers = _forward_chain(x, params, n_layers, use_fn, True, bf16)
        first = 2 if use_fn else 0
        near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
        for li, (a, *_) in enumerate(layers):
            w, b = params[first + 4 * li], params[first + 4 * li + 1]
            z = dense(a, w, b, bf16).abs()
            near |= (z < F32_KINK_EPS).any(dim=1)
            if bf16:
                acc = (bf16_round(a) @ bf16_round(w)).abs().clamp_min(1e-30)
                near |= (z <= torch.exp2(torch.floor(torch.log2(acc)) - 7)).any(dim=1)
    return near


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


def pad16(n: int) -> int:
    return -(-n // 16) * 16


def pack_mma_weights(mats: Sequence[torch.Tensor], device) -> tuple:
    """bf16 copies of the (d_in, d_out) matrices for the tensor-core kernels
    in one buffer, each rounded to nearest bf16 and zero-padded to
    (pad16(d_in), pad16(d_out)); returns (buffer, element offsets)."""
    shapes = [(pad16(w.shape[0]), pad16(w.shape[1])) for w in mats]
    offs, o = [], 0
    for k, n in shapes:
        offs.append(o)
        o += k * n
    buf = torch.zeros(o, dtype=torch.bfloat16, device=device)
    for w, off, (k, n) in zip(mats, offs, shapes):
        buf[off : off + k * n].view(k, n)[: w.shape[0], : w.shape[1]].copy_(w.detach())
    return buf, offs


class TrunkPack(NamedTuple):
    """K2's parameters packed for one launch: every parameter in one f32
    buffer (:func:`pack_params`) and, for bf16, the weights' bf16 copies
    (:func:`pack_mma_weights`)."""

    buffer: torch.Tensor
    offsets: list
    weights: Optional[torch.Tensor] = None
    weight_offsets: Optional[list] = None


def pack_trunk(params: Sequence[torch.Tensor], device, n_layers: int, use_fn: bool,
               bf16: bool) -> TrunkPack:
    """Pack the flat trunk list for :func:`trunk_forward_cuda`."""
    pb, offs = pack_params(params, device)
    if not bf16:
        return TrunkPack(pb, offs)
    first = 2 if use_fn else 0
    wb, woffs = pack_mma_weights([params[first + 4 * li] for li in range(n_layers)], device)
    return TrunkPack(pb, offs, wb, woffs)


def check_mma_width(hidden: int) -> None:
    """Raise unless the tensor-core kernels' tiling takes ``hidden``."""
    if hidden % 8 or hidden > 256:
        raise ValueError(f"the bf16 tensor-core kernels take a hidden width that is a "
                         f"multiple of 8 and at most 256, not {hidden}")


def tile_rows(width: int, floats_per_row_fn, sizes: Sequence[int]) -> int:
    """Largest row tile among the ``sizes`` a kernel is built for whose
    shared memory, ``4 * floats_per_row_fn(tile)`` bytes, fits one H100
    block."""
    for br in sizes:
        if 4 * floats_per_row_fn(br) <= SMEM_MAX:
            return br
    raise ValueError(f"a {width}-wide row does not fit the shared-memory budget")


def mma_tile_rows(rows: int, width: int, floats_per_row_fn, sms: int,
                  sizes: Sequence[int]) -> int:
    """Row tile of a tensor-core gradient kernel (K3, K4, K2b): among the
    ``sizes`` (largest first) whose shared memory fits one block, the
    largest that still gives every SM a tile, else the smallest."""
    fit = [b for b in sizes if 4 * floats_per_row_fn(b) <= SMEM_MAX]
    if not fit:
        raise ValueError(f"a {width}-wide row does not fit the shared-memory budget")
    return next((b for b in fit if -(-rows // b) >= sms), fit[-1])


def grads_blocks(tiles: int, sms: int, mma: bool) -> int:
    """Blocks of a K3, K4 or K2b launch: one per SM, each looping over row
    tiles and adding every tile after its first into its gradient slot. The
    tensor-core kernels take one block per tile while the tiles fit in two
    waves: every block then stores its slot once, and no block's second
    tile waits on re-reading its slot (one shared-memory-sized block fits
    an SM, so the second wave starts as the first ends)."""
    if mma and tiles <= 2 * sms:
        return max(1, tiles)
    return max(1, min(tiles, sms))


def _check_trunk(x, params, n_layers, use_fn):
    cb.require(x, "x", (torch.float32, torch.bfloat16), device=x.device)
    hidden = params[-4].shape[1]
    require_shapes(params, trunk_param_shapes(x.shape[1], hidden, n_layers, use_fn), "trunk")
    return hidden


def trunk_forward_cuda(
    x: torch.Tensor,
    params: Sequence[torch.Tensor],
    n_layers: int,
    use_fn: bool = True,
    use_relu: bool = True,
    bf16: bool = False,
    packed: Optional[TrunkPack] = None,
) -> torch.Tensor:
    """Launch K2 on (rows, d_in) f32 or bf16 CUDA rows: the tensor-core
    kernel in bf16, the FMA kernel in f32. ``packed`` is
    ``pack_trunk(params, x.device, n_layers, use_fn, bf16)`` made
    beforehand, or None to pack here."""
    rows, d_in = x.shape
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        raise RuntimeError(
            "trunk_forward_cuda has no backward: call fused_mlp (its FusedTrunk "
            "backward is the K2b kernel) or run under torch.no_grad()"
        )
    hidden = _check_trunk(x, params, n_layers, use_fn)
    if bf16:
        check_mma_width(hidden)
    if packed is None:
        packed = pack_trunk(params, x.device, n_layers, use_fn, bf16)
    pb, offs = packed.buffer, packed.offsets
    cb.require(pb, "packed parameters", (torch.float32,),
               (sum(p.numel() for p in params),), x.device)
    if not use_fn:
        offs = [0, 0] + offs
    out = torch.empty(
        (rows, hidden), dtype=torch.bfloat16 if bf16 else torch.float32, device=x.device
    )
    lib = cb.library("fused_mlp")
    smem = lambda b: tiles.smem_bytes("fused_mlp", bf16, b, d_in, hidden, n_layers) // 4
    offs_c = (cb._L * len(offs))(*offs)
    x_bf16 = int(x.dtype == torch.bfloat16)
    if bf16:
        if packed.weights is None:
            raise ValueError("bf16 K2 needs the bf16 weight copies: pack_trunk(..., bf16=True)")
        cb.require(packed.weights, "bf16 weights", (torch.bfloat16,), device=x.device)
        sms = cb.sm_count(x.device)
        # the smallest row tile that still gives every SM a tile
        br = 16 if rows <= 16 * sms else 32 if rows <= 32 * sms else 64
        br = tile_rows(d_in, smem, [b for b in tiles.SIZES[("fused_mlp", True)] if b <= br])
        n_blocks = max(1, min(-(-rows // br), 2 * sms))
        woffs = packed.weight_offsets
        entry = "dcc_trunk_fwd_mma"
        code = lib.dcc_trunk_fwd_mma(
            x.data_ptr(), x_bf16, rows, d_in, hidden, n_layers, int(use_fn), int(use_relu), br,
            pb.data_ptr(), offs_c, len(offs), packed.weights.data_ptr(),
            (cb._L * len(woffs))(*woffs), len(woffs), n_blocks, out.data_ptr(),
            cb.stream_of(x),
        )
    else:
        br = tile_rows(d_in, smem, tiles.SIZES[("fused_mlp", False)])
        entry = "dcc_trunk_fwd"
        code = lib.dcc_trunk_fwd(
            x.data_ptr(), x_bf16, rows, d_in, hidden, n_layers, int(use_fn), int(use_relu), br,
            pb.data_ptr(), offs_c, len(offs), out.data_ptr(), cb.stream_of(x),
        )
    cb.check("fused_mlp", code, "fused_mlp")
    cb.LAUNCHES["fused_mlp"] += 1
    cb.ENTRY["fused_mlp"] = entry
    cb.TILE["fused_mlp"] = br
    return out


def trunk_backward_cuda(
    x: torch.Tensor,
    params: Sequence[torch.Tensor],
    g: torch.Tensor,
    n_layers: int,
    use_fn: bool = True,
    use_relu: bool = True,
    bf16: bool = False,
    packed: Optional[TrunkPack] = None,
):
    """Launch K2b (+ its slot reduction) on (rows, d_in) f32 or bf16 CUDA
    rows and the (rows, H) cotangent: the tensor-core kernel in bf16, which
    reads K2's bf16 weight copies (``packed`` as in
    :func:`trunk_forward_cuda`, or None to pack here), the FMA kernel in f32.
    Same returns as the plain version."""
    rows, d_in = x.shape
    hidden = _check_trunk(x, params, n_layers, use_fn)
    g = g.to(torch.float32).contiguous()
    cb.require(g, "g", (torch.float32,), (rows, hidden), x.device)
    lib = cb.library("fused_mlp_bwd")
    smem = lambda b: tiles.smem_bytes("fused_mlp_bwd", bf16, b, d_in, hidden, n_layers) // 4
    sms = cb.sm_count(x.device)
    if bf16:
        check_mma_width(hidden)
        if packed is None:
            packed = pack_trunk(params, x.device, n_layers, use_fn, True)
        if packed.weights is None:
            raise ValueError("bf16 K2b needs the bf16 weight copies: pack_trunk(..., bf16=True)")
        cb.require(packed.weights, "bf16 weights", (torch.bfloat16,), device=x.device)
        pb, offs = packed.buffer, packed.offsets
        br = mma_tile_rows(rows, d_in, smem, sms, tiles.SIZES[("fused_mlp_bwd", True)])
    else:
        # the FMA kernel reads W^T (d_out, d_in) for g_prev = g W^T, after the params
        first = 2 if use_fn else 0
        wts = [params[first + 4 * li].t() for li in range(n_layers)]
        pb, offs = pack_params(list(params) + wts, x.device)
        br = tile_rows(d_in, smem, tiles.SIZES[("fused_mlp_bwd", False)])
    cb.require(pb, "packed parameters", (torch.float32,), device=x.device)
    if not use_fn:
        offs = [0, 0] + offs
    # each block owns one slot laid out as the flat parameter list
    used = sum(p.numel() for p in params)
    slot = -(-used // 4) * 4  # 16-byte aligned slots; the tail is not read
    n_blocks = grads_blocks(-(-rows // br), sms, bf16)
    slots = torch.empty((n_blocks, slot), dtype=torch.float32, device=x.device)
    out = torch.empty((slot,), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    offs_c = (cb._L * len(offs))(*offs)
    weights = ()
    if bf16:
        woffs = packed.weight_offsets
        weights = (packed.weights.data_ptr(), (cb._L * len(woffs))(*woffs), len(woffs))
    entry = "dcc_trunk_bwd_mma" if bf16 else "dcc_trunk_bwd"
    code = getattr(lib, entry)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), g.data_ptr(), rows, d_in, hidden,
        n_layers, int(use_fn), int(use_relu), br, pb.data_ptr(), offs_c, len(offs), *weights,
        slots.data_ptr(), slot, n_blocks, out.data_ptr(), dx.data_ptr(), cb.stream_of(x),
    )
    cb.check("fused_mlp_bwd", code, "fused_mlp_bwd")
    cb.LAUNCHES["fused_mlp_bwd"] += 1
    cb.ENTRY["fused_mlp_bwd"] = entry
    cb.TILE["fused_mlp_bwd"] = br
    grads = [t.view(p.shape) for t, p in zip(out[:used].split([p.numel() for p in params]),
                                             params)]
    return dx, grads


class FusedTrunk(torch.autograd.Function):
    """The trunk as one differentiable op: K2 forward and K2b backward on
    CUDA tensors, their plain versions on CPU tensors. As the JAX package's
    custom VJP, it saves only ``x`` and the parameters; the backward
    recomputes the forward (reusing the forward's ``packed`` parameters on
    CUDA)."""

    @staticmethod
    def forward(ctx, x, cfg, packed, *params):
        ctx.cfg = cfg
        ctx.packed = packed
        ctx.save_for_backward(x, *params)
        if x.is_cuda:
            return trunk_forward_cuda(x, params, *cfg, packed=packed)
        return trunk_forward_plain(x, params, *cfg)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        if g.is_cuda:
            dx, grads = trunk_backward_cuda(x, params, g, *ctx.cfg, packed=ctx.packed)
        else:
            dx, grads = trunk_backward_plain(x, params, g, *ctx.cfg)
        return (dx if ctx.needs_input_grad[0] else None, None, None, *grads)


def fused_mlp(
    x: torch.Tensor,
    params: Sequence[torch.Tensor],
    *,
    n_layers: int,
    use_feature_norm: bool = True,
    use_relu: bool = True,
    bf16: bool = False,
    packed: Optional[TrunkPack] = None,
) -> torch.Tensor:
    """Apply the trunk to ``x`` of shape (..., d_in) through
    :class:`FusedTrunk`: the kernels for a CUDA tensor (``packed`` as in
    :func:`trunk_forward_cuda`), the plain versions for a CPU tensor."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    cfg = (n_layers, use_feature_norm, use_relu, bf16)
    out = FusedTrunk.apply(x2, cfg, packed, *params)
    return out.reshape(*lead, out.shape[-1])
