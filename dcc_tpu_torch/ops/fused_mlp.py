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

bf16 K2 at rows too wide for a staged row tile (critic rows past 5,632
columns, e.g. 4 UAVs x 300 PoIs, ``ops.tiles.plan``) launches its chunked
kernel, which streams layer 0 over d_in in column chunks (counted under
``fused_mlp_chunked``).
bf16 K2b at such rows (the 20-UAV preset's 4,840-wide critic rows) runs as
three launches: the chunked kernel streams layer 0 the same way and stops
at layer 0's cotangent g0 (plain version :func:`trunk_bwd_chunked_plain`),
then :func:`layer0_tail`: the layer-0 input backward gives the feature
norm's gradients and dx (:func:`layer0_input_bwd_cuda`, dx only where a
caller reads it: ``FusedTrunk`` asks for it only when its input needs a
gradient), and the dV0 kernel gives W_0's (:func:`dv0_cuda`), both on the
warpgroup tensor cores (``csrc/layer0_tail.cu``; dx and hidden widths past
256 on the row-tiled kernel); the chunked K3, K4, K3u and K4u end in the
same two kernels.

The CUDA entries take a trunk of any depth: they read the parameters'
offsets from a device table (:attr:`TrunkPack.table`, ``cuda_build.
offsets_table``), and past the depth whose activations fit one block
(13 to 15 layers at hidden 256) the bf16 K2b, K3, K4, K3u and K4u take
their depth layout (``ops.tiles.plan``'s ``deep``), which keeps each
layer's saved tile in a scratch in device memory (``cuda_build.
deep_scratch``) and one layer's in shared memory. The bf16 kernels take
any hidden width: each layer runs in column passes of at most 256
(``csrc/trunk_mma.cuh``), widths off multiples of 16 are zero-padded and
masked, and past the widths whose smallest row tile fits one block's
shared memory in the staged, chunked or depth layout (about 1,024 at two
layers for the gradient kernels, 2,800 for K2 at 440-wide rows) they take
their column-blocked layout (``ops.tiles.plan``'s ``blocked``, the
``*_blocked`` libraries), which keeps every tile as wide as the hidden
layer in the per-block scratch and streams it through shared memory, and
count those launches under their names with ``_blocked`` appended
(:func:`check_mma_width` guards each launch).

Every bf16 K2, K2b, K3, K4, K3u and K4u wrapper takes ``relu_masks``, an
(L, rows, H) uint8 CUDA tensor that the kernel fills with each layer's
relu mask (z > 0) as its epilogue decides it, for the kernel checks; the
main path passes None. The plain versions take the same masks
(``masks``) in place of their own decisions.
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


class _RoundForward(torch.autograd.Function):
    """bf16 rounding in the forward only: the gradient passes unrounded."""

    @staticmethod
    def forward(ctx, t):
        return bf16_round(t)

    @staticmethod
    def backward(ctx, g):
        return g


def dense(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor, bf16: bool,
          round_grads: bool = True) -> torch.Tensor:
    """a @ w + b in the given mode (w is (d_in, d_out)); f32 result. In bf16
    autograd rounds w's and b's gradients, sums over the rows, to bf16, as
    JAX's bf16 Dense does; with ``round_grads`` False it leaves them the f32
    sums, for a caller that adds them over ranks first and rounds the total
    (``MAPPO`` under a mesh)."""
    if bf16:
        rp = bf16_round if round_grads else _RoundForward.apply
        z = bf16_round(bf16_round(a) @ rp(w))
        return bf16_round(z + rp(b))
    return a.to(torch.float32) @ w + b


def activation(z: torch.Tensor, use_relu: bool, bf16: bool, mask=None) -> torch.Tensor:
    """relu (with ``mask``, a kernel's relu mask: z where it is set, else
    0) or tanh, rounded to bf16 in bf16 mode."""
    if use_relu:
        return torch.relu(z) if mask is None else torch.where(mask.bool(), z, 0.0)
    r = torch.tanh(z)
    return bf16_round(r) if bf16 else r


def relu_grad_mask(r: torch.Tensor, mask=None) -> torch.Tensor:
    """The relu derivative of a layer with activation ``r``: r > 0, or the
    kernel's ``mask`` where one is given."""
    return (r > 0 if mask is None else mask.bool()).to(r.dtype)


def _layer_mask(masks, li):
    return None if masks is None else masks[li]


def _forward_chain(x, params, n_layers, use_fn, use_relu, bf16, masks=None,
                   round_grads=True):
    """The trunk on (rows, d_in) f32, keeping what the backward needs: the
    feature norm's (xhat, inv) and per layer (a, r, xhat, inv), with ``a``
    the layer's input and ``r`` its activation as the chain rounds them.
    ``masks``: each layer's relu mask to take instead of z > 0 (a kernel's,
    ``relu_masks``), or None; ``round_grads``: :func:`dense`'s. Returns
    (output f32, feature-norm cache or None, layer caches)."""
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
    for li in range(n_layers):
        w, b, s, c = params[i : i + 4]
        i += 4
        r = activation(dense(a, w, b, bf16, round_grads), use_relu, bf16,
                       _layer_mask(masks, li))
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
    masks=None,
    round_grads: bool = True,
) -> torch.Tensor:
    """Plain PyTorch K2 on (rows, d_in); returns (rows, H) in bf16 or f32.
    ``masks``: the relu masks to take (a kernel's ``relu_masks``), or None;
    ``round_grads``: :func:`dense`'s, for autograd through it."""
    a, _, _ = _forward_chain(x, params, n_layers, use_fn, use_relu, bf16, masks, round_grads)
    return a.to(torch.bfloat16) if bf16 else a


def _ln_bwd(g, xhat, inv, scale):
    """d(input), d(scale), d(bias) of y = xhat * scale + bias (f32)."""
    gg = g * scale
    dx = inv * (gg - gg.mean(dim=-1, keepdim=True)
                - xhat * (gg * xhat).mean(dim=-1, keepdim=True))
    return dx, (g * xhat).sum(dim=0), g.sum(dim=0)


def trunk_bwd_chain(g, params, fn_cache, layers, n_layers: int, use_fn: bool,
                    use_relu: bool, bf16: bool, to_layer0: bool = False, masks=None):
    """The backward of the chain that :func:`_forward_chain` cached: the
    cotangent ``g`` (rows, H) of the trunk output back to (f32 cotangent of
    the trunk's input, [f32 gradient of each parameter]). With
    ``to_layer0``, as the chunked kernels split it: it stops at layer 0's
    cotangent (after its activation) and returns that instead, with no
    gradient (None) for W_0 and the feature norm. ``masks``: the relu
    masks the forward took, or None."""
    mm = (lambda p, q: bf16_round(p) @ bf16_round(q)) if bf16 else torch.matmul
    g = g.to(torch.float32)
    grads = [None] * len(params)
    i = len(params)
    for li in reversed(range(n_layers)):
        a, r, xhat, inv = layers[li]
        i -= 4
        g, grads[i + 2], grads[i + 3] = _ln_bwd(g, xhat, inv, params[i + 2])
        g = g * relu_grad_mask(r, _layer_mask(masks, li)) if use_relu else g * (1.0 - r * r)
        grads[i + 1] = g.sum(dim=0)
        if to_layer0 and li == 0:
            return g, grads
        grads[i] = mm(a.t(), g)
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
    need_dx: bool = True,
    masks=None,
):
    """Plain PyTorch K2b: the cotangent ``g`` (rows, H) of the trunk output
    back to (dx in x.dtype, or None without ``need_dx``, [f32 gradient of
    each parameter]). ``masks``: the relu masks to take, or None."""
    with torch.no_grad():
        _, fn_cache, layers = _forward_chain(x, params, n_layers, use_fn, use_relu, bf16, masks)
        g, grads = trunk_bwd_chain(g, params, fn_cache, layers, n_layers, use_fn, use_relu,
                                   bf16, masks=masks)
    return (g.to(x.dtype) if need_dx else None), grads


# ---------------------------------------------------------------------------
# layer 0 at rows too wide to stage (ROADMAP B2): the chunked K2b stops at
# layer 0's cotangent g0; the dV0 kernel gives W_0's gradient and the
# layer-0 input backward the feature norm's gradients and dx. The chunked
# K4 / K4u (ops.fused_ppo) end in the same two kernels.
# ---------------------------------------------------------------------------

def input_stats(x, use_fn: bool) -> torch.Tensor:
    """(R, 2) f32: each row's feature-norm mean and 1/sqrt(var + eps), or
    (0, 1) without the feature norm, as the chunked kernels write them."""
    if not use_fn:
        return torch.cat([torch.zeros_like(x[:, :1], dtype=torch.float32),
                          torch.ones_like(x[:, :1], dtype=torch.float32)], dim=1)
    return torch.cat(ln_stats(x), dim=1)


def trunk_bwd_chunked_plain(x, params, g, n_layers: int, use_fn: bool = True,
                            use_relu: bool = True, bf16: bool = True, masks=None):
    """Plain chunked K2b (its first launch): the chain down to layer 0's
    cotangent. Returns (the gradients of ``params`` from layer 0's bias on,
    layer 0's bf16 cotangent g0 (rows, H), :func:`input_stats`)."""
    with torch.no_grad():
        _, fn_cache, layers = _forward_chain(x, params, n_layers, use_fn, use_relu, bf16, masks)
        g0, grads = trunk_bwd_chain(g, params, fn_cache, layers, n_layers, use_fn, use_relu,
                                    bf16, to_layer0=True, masks=masks)
    first = 2 if use_fn else 0
    return grads[first + 1:], g0.to(torch.bfloat16), input_stats(x, use_fn)


def dv0_plain(x, xstats, g0, hidden: int, affine=None):
    """Plain dV0 kernel: bf16((x - mu) * inv)^T @ g0[:, :hidden] in f32, with
    ``xstats`` = (mu, inv) per row and ``g0`` layer 0's bf16 cotangent; with
    ``affine`` = (fs, fb), the feature norm's scale and bias, the unfolded
    chain's operand bf16((x - mu) * inv * fs + fb) (dW0 of K2b and K4u)."""
    xhat = (x.to(torch.float32) - xstats[:, :1]) * xstats[:, 1:]
    if affine is not None:
        xhat = xhat * affine[0] + affine[1]
    return bf16_round(xhat).t() @ g0[:, :hidden].to(torch.float32)


def layer0_input_bwd_plain(x, xstats, g0, w0b, fs, hidden: int, need_dx: bool = True):
    """Plain layer-0 input backward: g_prev = g0 @ W_0^T (f32) from layer 0's
    bf16 cotangent ``g0`` and the bf16 W_0 ``w0b`` (padded, as
    :func:`pack_mma_weights` packs it), then the feature norm's backward
    with its scale ``fs`` (None: no feature norm, dx = g_prev). Returns (dx
    in x.dtype or None without ``need_dx``, d fs, d fb; None, None without
    the feature norm)."""
    d_in = x.shape[1]
    gp = g0[:, :hidden].to(torch.float32) @ w0b[:d_in, :hidden].to(torch.float32).t()
    if fs is None:
        return (gp.to(x.dtype) if need_dx else None), None, None
    xhat = (x.to(torch.float32) - xstats[:, :1]) * xstats[:, 1:]
    dx, dfs, dfb = _ln_bwd(gp, xhat, xstats[:, 1:], fs)
    return (dx.to(x.dtype) if need_dx else None), dfs, dfb


def dv0_cuda(x, xstats, g0, hidden: int, affine=None, unfolded: bool = False,
             kind: str = "critic"):
    """Launch the dV0 kernel (``dcc_dv0_wgmma``, ``csrc/layer0_tail.cu``:
    the product on row splits on the warpgroup tensor cores, then the
    splits summed in order); same return as :func:`dv0_plain`. Counts under
    ``critic_ppo_grads_dv0`` or ``actor_ppo_grads_dv0`` (the folded K4's or
    K3's dV0, by ``kind``) or, with ``unfolded``, ``dv0_unfolded`` (dW0 of
    the chunked K2b, K3u and K4u, with the feature norm's ``affine`` where
    they have one)."""
    rows, d_in = x.shape
    cb.require(x, "x", (torch.float32, torch.bfloat16), device=x.device)
    cb.require(xstats, "xstats", (torch.float32,), (rows, 2), x.device)
    cb.require(g0, "g0", (torch.bfloat16,), (rows, pad16(hidden)), x.device)
    fs = fb = None
    if affine is not None:
        fs, fb = affine
        cb.require(fs, "fs", (torch.float32,), (d_in,), x.device)
        cb.require(fb, "fb", (torch.float32,), (d_in,), x.device)
    splits = tiles.tail_plan("dv0", rows, d_in, hidden, cb.sm_count(x.device))[0]
    part = torch.empty((splits, d_in, hidden), dtype=torch.float32, device=x.device)
    out = torch.empty((d_in, hidden), dtype=torch.float32, device=x.device)
    name = "dv0_unfolded" if unfolded else f"{kind}_ppo_grads_dv0"
    code = cb.library("layer0_tail").dcc_dv0_wgmma(
        x.data_ptr(), int(x.dtype == torch.bfloat16), rows, d_in, xstats.data_ptr(),
        g0.data_ptr(), hidden, splits, None if fs is None else fs.data_ptr(),
        None if fb is None else fb.data_ptr(), part.data_ptr(), out.data_ptr(),
        cb.stream_of(x))
    cb.check("layer0_tail", code, name)
    cb.LAUNCHES[name] += 1
    cb.ENTRY[name] = "dcc_dv0_wgmma"
    return out


def layer0_input_bwd_cuda(x, xstats, g0, w0b, fs, hidden: int, need_dx: bool = True,
                          _blocked: bool = False):
    """Launch the layer-0 input backward; same returns as
    :func:`layer0_input_bwd_plain`. With the feature norm, without dx and
    at hidden widths to ``tiles.TAIL_HMAX`` (the update's calls) the
    warpgroup kernel (``dcc_layer0_input_bwd_wgmma``, ``csrc/layer0_tail.cu``:
    W_0's slice resident, g_prev and the column sums over row splits, the
    splits summed in order); else the row-tiled one
    (``dcc_layer0_input_bwd_mma``, and with the feature norm its slot
    reduction; at hidden widths whose g0 rows fit no block, or with
    ``_blocked``, its column-blocked build, counted under
    ``layer0_input_bwd_blocked``). The others count under
    ``layer0_input_bwd``."""
    rows, d_in = x.shape
    cb.require(x, "x", (torch.float32, torch.bfloat16), device=x.device)
    cb.require(xstats, "xstats", (torch.float32,), (rows, 2), x.device)
    cb.require(g0, "g0", (torch.bfloat16,), (rows, pad16(hidden)), x.device)
    cb.require(w0b, "w0b", (torch.bfloat16,), (pad16(d_in), pad16(hidden)), x.device)
    use_fn = fs is not None
    if not (use_fn or need_dx):
        raise ValueError("layer0_input_bwd_cuda computes nothing without fs or dx")
    sms = cb.sm_count(x.device)
    if use_fn:
        cb.require(fs, "fs", (torch.float32,), (d_in,), x.device)
    out = torch.empty((2 * d_in,), dtype=torch.float32, device=x.device) if use_fn else None
    if use_fn and not need_dx and pad16(hidden) <= tiles.TAIL_HMAX and not _blocked:
        splits = tiles.tail_plan("layer0_input_bwd", rows, d_in, hidden, sms)[0]
        slots = torch.empty((splits, 2 * d_in), dtype=torch.float32, device=x.device)
        code = cb.library("layer0_tail").dcc_layer0_input_bwd_wgmma(
            x.data_ptr(), int(x.dtype == torch.bfloat16), rows, d_in, xstats.data_ptr(),
            g0.data_ptr(), hidden, w0b.data_ptr(), splits, slots.data_ptr(), out.data_ptr(),
            cb.stream_of(x))
        cb.check("layer0_tail", code, "layer0_input_bwd")
        cb.LAUNCHES["layer0_input_bwd"] += 1
        cb.ENTRY["layer0_input_bwd"] = "dcc_layer0_input_bwd_wgmma"
        cb.TILE["layer0_input_bwd"] = tiles.TAIL_STEP["layer0_input_bwd"]
        return None, out[:d_in], out[d_in:]
    # g0's rows staged whole, or past the widths whose tile fits a block
    # (about 4,700), streamed by the products (the column-blocked library)
    tp = check_mma_width("layer0_input_bwd", d_in, hidden, 1, blocked=_blocked)
    smem = lambda b: tiles.smem_bytes("layer0_input_bwd", True, b, d_in, hidden, 1,
                                      blocked=tp.blocked) // 4
    br = mma_tile_rows(rows, d_in, smem, sms, tp.tiles)
    n_blocks = grads_blocks(-(-rows // br), sms, True)
    dx = torch.empty_like(x) if need_dx else None
    slots = None
    if use_fn:
        slots = torch.empty((n_blocks, 2 * d_in), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    code = cb.mma_library("fused_mlp_bwd", hidden, tp.blocked).dcc_layer0_input_bwd_mma(
        x.data_ptr(), int(x.dtype == torch.bfloat16), rows, d_in, xstats.data_ptr(),
        g0.data_ptr(), hidden, w0b.data_ptr(), ptr(fs), int(use_fn), br, ptr(slots), n_blocks,
        ptr(out), ptr(dx), cb.stream_of(x))
    name = launch_name("layer0_input_bwd", tp)
    cb.check("fused_mlp_bwd", code, name)
    cb.LAUNCHES[name] += 1
    cb.ENTRY[name] = "dcc_layer0_input_bwd_mma"
    cb.TILE[name] = br
    if not use_fn:
        return dx, None, None
    return dx, out[:d_in], out[d_in:]


def layer0_tail(x, xstats, g0, w0b, fs, fb, hidden: int, need_dx: bool = False):
    """The layer-0 tail of the unfolded chunked chain (the chunked K2b, K3u
    and K4u): from layer 0's bf16 cotangent ``g0``, the rows' statistics
    ``xstats``, the bf16 W_0 ``w0b`` (as :func:`pack_mma_weights` pads it)
    and the feature norm's scale and bias ``fs``, ``fb`` (None without the
    feature norm), returns (dx or None, [d fs, d fb (with the feature
    norm), dW0]). On CUDA tensors the layer-0 input backward (with the
    feature norm, or for dx) and the dV0 kernel in its affine mode, two
    launches; on CPU tensors their plain versions."""
    use_fn = fs is not None
    affine = (fs, fb) if use_fn else None
    dx, lead = None, []
    if x.is_cuda:
        if use_fn or need_dx:
            dx, dfs, dfb = layer0_input_bwd_cuda(x, xstats, g0, w0b, fs, hidden, need_dx)
            lead = [dfs, dfb] if use_fn else []
        return dx, lead + [dv0_cuda(x, xstats, g0, hidden, affine, unfolded=True)]
    if use_fn or need_dx:
        dx, dfs, dfb = layer0_input_bwd_plain(x, xstats, g0, w0b, fs, hidden, need_dx)
        lead = [dfs, dfb] if use_fn else []
    return dx, lead + [dv0_plain(x, xstats, g0, hidden, affine)]


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


# a relu mask of a kernel may differ from the plain version's where a change
# of one bf16 step (relative 2^-8) in every element of the layer's input can
# move the pre-activation across the kink (the relu mask rule of the kernel
# checks, relu_mask_gap)
MASK_STEP = 2.0 ** -8


def mask_gap(layers, masks, bf16: bool = True) -> tuple:
    """How a kernel's relu masks differ from the plain version's. ``layers``:
    per layer (its input a, W, b) on the plain chain that took the kernel's
    ``masks`` (L, rows, H), so each layer's input is the kernel's up to
    rounding. Returns (elements whose mask differs from z > 0, the largest
    |z| / bound over them, 0 if none), with z the plain pre-activation and
    bound = ``MASK_STEP`` * sum_k |a_k w_k| + the bf16 step at z's
    accumulator: how far z moves when every element of a moves by one bf16
    step. A ratio above 1 is a mask the kernel's rounding cannot explain."""
    n, worst = 0, 0.0
    with torch.no_grad():
        for li, (a, w, b) in enumerate(layers):
            z = dense(a, w, b, bf16)
            ar, wr = (bf16_round(a), bf16_round(w)) if bf16 else (a, w)
            acc = (ar @ wr).abs().clamp_min(1e-30)
            bound = MASK_STEP * (ar.abs() @ wr.abs()) + torch.exp2(torch.floor(torch.log2(acc))
                                                                    - 7)
            diff = (z > 0) != masks[li].bool()
            k = int(diff.sum())
            if k:
                n += k
                worst = max(worst, float((z.abs() / bound)[diff].max()))
    return n, worst


def relu_mask_gap(x, params, n_layers: int, use_fn: bool, masks, bf16: bool = True) -> tuple:
    """:func:`mask_gap` of the unfolded chain (K2, K2b, K3u, K4u) on rows
    ``x`` with the flat trunk list ``params``."""
    with torch.no_grad():
        _, _, layers = _forward_chain(x, params, n_layers, use_fn, True, bf16, masks)
    first = 2 if use_fn else 0
    return mask_gap([(a, params[first + 4 * li], params[first + 4 * li + 1])
                     for li, (a, *_) in enumerate(layers)], masks, bf16)


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
    (:func:`pack_mma_weights`); ``table`` and ``weight_table`` are the
    kernels' device tables of ``offsets`` (with the feature norm's two
    entries in front, zeros without it) and ``weight_offsets``, made once
    per trunk shape (``cuda_build.offsets_table``)."""

    buffer: torch.Tensor
    offsets: list
    weights: Optional[torch.Tensor] = None
    weight_offsets: Optional[list] = None
    table: Optional[torch.Tensor] = None
    weight_table: Optional[torch.Tensor] = None


def kernel_offsets(offs: list, use_fn: bool) -> list:
    """The trunk kernels' offsets of the flat list: the feature norm's two
    entries are zeros without it."""
    return offs if use_fn else [0, 0] + offs


def pack_trunk(params: Sequence[torch.Tensor], device, n_layers: int, use_fn: bool,
               bf16: bool) -> TrunkPack:
    """Pack the flat trunk list for :func:`trunk_forward_cuda`."""
    pb, offs = pack_params(params, device)
    table = cb.offsets_table(kernel_offsets(offs, use_fn), device)
    if not bf16:
        return TrunkPack(pb, offs, table=table)
    first = 2 if use_fn else 0
    wb, woffs = pack_mma_weights([params[first + 4 * li] for li in range(n_layers)], device)
    return TrunkPack(pb, offs, wb, woffs, table, cb.offsets_table(woffs, device))


def check_mma_width(kernel: str, d_in: int, hidden: int, n_layers: int,
                    n_head: int = 1, blocked: bool = False) -> tiles.Plan:
    """The bf16 ``kernel``'s tile plan at this width (``ops.tiles.plan``;
    ``blocked`` forces the column-blocked layout); raises where no row tile
    fits one block (none at any width since that layout)."""
    p = tiles.plan(kernel, True, d_in, hidden, n_layers, n_head, blocked=blocked)
    if not p.tiles:
        raise ValueError(f"bf16 {kernel} has no row tile at hidden width {hidden} "
                         f"({d_in}-wide rows, {n_layers} layers) that fits one block's "
                         f"{tiles.SMEM_MAX} bytes of shared memory")
    return p


def scratch_ptr(kernel: str, p: tiles.Plan, br: int, d_in: int, hidden: int, n_layers: int,
                n_blocks: int, device):
    """The scratch argument of a bf16 launch on the plan ``p``: None (the
    staged and chunked layouts) or, in the depth and column-blocked
    layouts, the pointer of a cached device buffer of ``n_blocks`` blocks'
    slices (``ops.tiles.scratch_bytes``)."""
    nbytes = n_blocks * tiles.scratch_bytes(kernel, p, br, d_in, hidden, n_layers)
    return cb.deep_scratch(nbytes, device).data_ptr() if nbytes else None


def launch_name(name: str, p: tiles.Plan) -> str:
    """The ``LAUNCHES`` key of a launch on the plan ``p``: ``name``, with
    ``_blocked`` in the column-blocked layout."""
    return f"{name}_blocked" if p.blocked else name


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


def _mask_ptr(relu_masks, n_layers: int, rows: int, hidden: int, bf16: bool, device):
    """The relu masks' debug output for a tensor-core launch: None (the main
    path) or the pointer of an (L, rows, H) uint8 tensor."""
    if relu_masks is None:
        return None
    if not bf16:
        raise ValueError("relu_masks is an output of the bf16 tensor-core kernels")
    cb.require(relu_masks, "relu_masks", (torch.uint8,), (n_layers, rows, hidden), device)
    return relu_masks.data_ptr()


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
    relu_masks: Optional[torch.Tensor] = None,
    _blocked: bool = False,
) -> torch.Tensor:
    """Launch K2 on (rows, d_in) f32 or bf16 CUDA rows: the tensor-core
    kernel in bf16 (its chunked layout at rows too wide for a staged tile,
    its column-blocked one at hidden widths no other tile takes,
    ``ops.tiles.plan``), the FMA kernel in f32. ``packed`` is
    ``pack_trunk(params, x.device, n_layers, use_fn, bf16)`` made
    beforehand, or None to pack here. ``relu_masks`` (bf16 only): None, or
    an (L, rows, H) uint8 tensor the kernel fills with its relu masks.
    ``_blocked`` (bf16): the column-blocked layout forced, for holding it
    against the others."""
    rows, d_in = x.shape
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        raise RuntimeError(
            "trunk_forward_cuda has no backward: call fused_mlp (its FusedTrunk "
            "backward is the K2b kernel) or run under torch.no_grad()"
        )
    hidden = _check_trunk(x, params, n_layers, use_fn)
    mask_ptr = _mask_ptr(relu_masks, n_layers, rows, hidden, bf16, x.device)
    if packed is None:
        packed = pack_trunk(params, x.device, n_layers, use_fn, bf16)
    pb, table = packed.buffer, packed.table
    cb.require(pb, "packed parameters", (torch.float32,),
               (sum(p.numel() for p in params),), x.device)
    cb.require(table, "offsets table", (torch.int64,), (2 + 4 * n_layers,), x.device)
    out = torch.empty(
        (rows, hidden), dtype=torch.bfloat16 if bf16 else torch.float32, device=x.device
    )
    smem = lambda b: tiles.smem_bytes("fused_mlp", bf16, b, d_in, hidden, n_layers) // 4
    x_bf16 = int(x.dtype == torch.bfloat16)
    name = "fused_mlp"
    if bf16:
        if packed.weights is None:
            raise ValueError("bf16 K2 needs the bf16 weight copies: pack_trunk(..., bf16=True)")
        cb.require(packed.weights, "bf16 weights", (torch.bfloat16,), device=x.device)
        cb.require(packed.weight_table, "weight offsets table", (torch.int64,), (n_layers,),
                   x.device)
        sms = cb.sm_count(x.device)
        tp = check_mma_width("fused_mlp", d_in, hidden, n_layers, blocked=_blocked)
        lib = cb.mma_library("fused_mlp", hidden, tp.blocked)
        # the smallest row tile that still gives every SM a tile (every
        # layout, staged or chunked, has a 16-row one)
        target = 16 if rows <= 16 * sms else 32 if rows <= 32 * sms else 64
        br = next(b for b in tp.tiles if b <= target)
        n_blocks = max(1, min(-(-rows // br), 2 * sms))
        entry = "dcc_trunk_fwd_chunked_mma" if tp.chunked else "dcc_trunk_fwd_mma"
        name = launch_name("fused_mlp_chunked" if tp.chunked else name, tp)
        code = getattr(lib, entry)(
            x.data_ptr(), x_bf16, rows, d_in, hidden, n_layers, int(use_fn), int(use_relu), br,
            pb.data_ptr(), table.data_ptr(), table.numel(), packed.weights.data_ptr(),
            packed.weight_table.data_ptr(), n_layers, n_blocks, out.data_ptr(), mask_ptr,
            scratch_ptr("fused_mlp", tp, br, d_in, hidden, n_layers, n_blocks, x.device),
            cb.stream_of(x),
        )
    else:
        lib = cb.library("fused_mlp")
        br = tile_rows(d_in, smem, tiles.SIZES[("fused_mlp", False)])
        entry = "dcc_trunk_fwd"
        code = lib.dcc_trunk_fwd(
            x.data_ptr(), x_bf16, rows, d_in, hidden, n_layers, int(use_fn), int(use_relu), br,
            pb.data_ptr(), table.data_ptr(), table.numel(), out.data_ptr(), cb.stream_of(x),
        )
    cb.check("fused_mlp", code, name)
    cb.LAUNCHES[name] += 1
    cb.ENTRY[name] = entry
    cb.TILE[name] = br
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
    need_dx: bool = True,
    relu_masks: Optional[torch.Tensor] = None,
    _deep: bool = False,
    _blocked: bool = False,
):
    """Launch K2b (+ its slot reduction) on (rows, d_in) f32 or bf16 CUDA
    rows and the (rows, H) cotangent: the tensor-core kernel in bf16, which
    reads K2's bf16 weight copies (``packed`` as in
    :func:`trunk_forward_cuda`, or None to pack here), the FMA kernel in f32.
    bf16 rows too wide for a staged tile (``ops.tiles.plan``) take the
    chunked K2b, then the layer-0 input backward (with the feature norm, or
    for dx) and the dV0 kernel in its affine mode; there dx is computed only
    with ``need_dx``. ``relu_masks`` as in :func:`trunk_forward_cuda` (of
    the forward recompute). ``_deep`` (bf16): the depth layout on the tiles
    ``ops.tiles.plan`` gives, for holding it against the staged layout on
    the same tile; ``_blocked`` (bf16): the column-blocked layout forced.
    Same returns as the plain version (dx None where it was not
    computed)."""
    rows, d_in = x.shape
    hidden = _check_trunk(x, params, n_layers, use_fn)
    g = g.to(torch.float32).contiguous()
    cb.require(g, "g", (torch.float32,), (rows, hidden), x.device)
    mask_ptr = _mask_ptr(relu_masks, n_layers, rows, hidden, bf16, x.device)
    if bf16:
        tp = check_mma_width("fused_mlp_bwd", d_in, hidden, n_layers, blocked=_blocked)
        tp = tp._replace(deep=True) if _deep else tp
        lib = cb.mma_library("fused_mlp_bwd", hidden, tp.blocked)
    else:
        tp = tiles.plan("fused_mlp_bwd", False, d_in, hidden, n_layers)
        lib = cb.library("fused_mlp_bwd")
    chunked, sizes, deep, blocked = tp
    smem = lambda b: tiles.smem_bytes("fused_mlp_bwd", bf16, b, d_in, hidden, n_layers,
                                      chunked=chunked, deep=deep, blocked=blocked) // 4
    sms = cb.sm_count(x.device)
    if bf16:
        if packed is None:
            packed = pack_trunk(params, x.device, n_layers, use_fn, True)
        if packed.weights is None:
            raise ValueError("bf16 K2b needs the bf16 weight copies: pack_trunk(..., bf16=True)")
        cb.require(packed.weights, "bf16 weights", (torch.bfloat16,), device=x.device)
        pb, offs = packed.buffer, packed.offsets
        br = mma_tile_rows(rows, d_in, smem, sms, sizes)
    else:
        # the FMA kernel reads W^T (d_out, d_in) for g_prev = g W^T, after the params
        first = 2 if use_fn else 0
        wts = [params[first + 4 * li].t() for li in range(n_layers)]
        pb, offs = pack_params(list(params) + wts, x.device)
        br = tile_rows(d_in, smem, tiles.SIZES[("fused_mlp_bwd", False)])
    cb.require(pb, "packed parameters", (torch.float32,), device=x.device)
    offs = kernel_offsets(offs, use_fn)
    table = cb.offsets_table(offs, x.device)
    if chunked:
        return _trunk_backward_chunked(x, params, g, n_layers, use_fn, use_relu, packed, offs,
                                       br, need_dx, mask_ptr, tp)
    # each block owns one slot laid out as the flat parameter list
    used = sum(p.numel() for p in params)
    slot = -(-used // 4) * 4  # 16-byte aligned slots; the tail is not read
    n_blocks = grads_blocks(-(-rows // br), sms, bf16)
    slots = torch.empty((n_blocks, slot), dtype=torch.float32, device=x.device)
    out = torch.empty((slot,), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    weights, mask = (), ()
    if bf16:
        wtable = cb.offsets_table(packed.weight_offsets, x.device)
        weights = (packed.weights.data_ptr(), wtable.data_ptr(), wtable.numel())
        mask = (mask_ptr,
                scratch_ptr("fused_mlp_bwd", tp, br, d_in, hidden, n_layers, n_blocks, x.device))
    entry = "dcc_trunk_bwd_mma" if bf16 else "dcc_trunk_bwd"
    code = getattr(lib, entry)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), g.data_ptr(), rows, d_in, hidden,
        n_layers, int(use_fn), int(use_relu), br, pb.data_ptr(), table.data_ptr(), table.numel(),
        *weights, slots.data_ptr(), slot, n_blocks, out.data_ptr(), dx.data_ptr(), *mask,
        cb.stream_of(x),
    )
    name = launch_name("fused_mlp_bwd", tp)
    cb.check("fused_mlp_bwd", code, name)
    cb.LAUNCHES[name] += 1
    cb.ENTRY[name] = entry
    cb.TILE[name] = br
    grads = [t.view(p.shape) for t, p in zip(out[:used].split([p.numel() for p in params]),
                                             params)]
    return (dx if need_dx else None), grads


def _trunk_backward_chunked(x, params, g, n_layers, use_fn, use_relu, packed, offs, br,
                            need_dx, mask_ptr, tp: tiles.Plan):
    """bf16 K2b at rows too wide for a staged tile: the chunked kernel
    (``dcc_trunk_bwd_chunked_mma``: the chain to layer 0's cotangent g0,
    its slot starting at layer 0's bias; in the depth or column-blocked
    layout where the plan ``tp`` says so), then the layer-0 input backward
    and the dV0 kernel (affine mode) for the 4,840-wide gradients."""
    rows, d_in = x.shape
    hidden = params[-4].shape[1]
    sms = cb.sm_count(x.device)
    first = 2 if use_fn else 0
    rest = params[first + 1:]  # layer 0's bias on: the slot's gradients
    used = sum(p.numel() for p in rest)
    slot = -(-used // 4) * 4
    n_blocks = grads_blocks(-(-rows // br), sms, True)
    slots = torch.empty((n_blocks, slot), dtype=torch.float32, device=x.device)
    out = torch.empty((slot,), dtype=torch.float32, device=x.device)
    g0 = torch.empty((rows, pad16(hidden)), dtype=torch.bfloat16, device=x.device)
    xstats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    pb, woffs = packed.buffer, packed.weight_offsets
    table, wtable = cb.offsets_table(offs, x.device), cb.offsets_table(woffs, x.device)
    code = cb.mma_library("fused_mlp_bwd", hidden, tp.blocked).dcc_trunk_bwd_chunked_mma(
        x.data_ptr(), int(x.dtype == torch.bfloat16), g.data_ptr(), rows, d_in, hidden,
        n_layers, int(use_fn), int(use_relu), br, pb.data_ptr(), table.data_ptr(), table.numel(),
        packed.weights.data_ptr(), wtable.data_ptr(), wtable.numel(), slots.data_ptr(), slot,
        n_blocks, out.data_ptr(), g0.data_ptr(), xstats.data_ptr(), mask_ptr,
        scratch_ptr("fused_mlp_bwd", tp, br, d_in, hidden, n_layers, n_blocks, x.device),
        cb.stream_of(x),
    )
    name = launch_name("fused_mlp_bwd_chunked", tp)
    cb.check("fused_mlp_bwd", code, name)
    cb.LAUNCHES[name] += 1
    cb.ENTRY[name] = "dcc_trunk_bwd_chunked_mma"
    cb.TILE[name] = br
    dx, lead = finish_layer0_cuda(x, xstats, g0, pb, offs, packed.weights, woffs, hidden,
                                  use_fn, need_dx)
    return dx, lead + [t.view(p.shape) for t, p in
                       zip(out[:used].split([p.numel() for p in rest]), rest)]


def finish_layer0_cuda(x, xstats, g0, pb, offs, weights, woffs, hidden: int, use_fn: bool,
                       need_dx: bool):
    """The launches after a chunked K2b or K4u (:func:`layer0_tail`), from
    the kernel's g0 and xstats and its packed parameters (``pb`` at the
    flat list's offsets ``offs``, the bf16 W_0 at ``weights`` +
    ``woffs[0]``). Returns (dx or None, [d fs, d fb (with the feature
    norm), dW0])."""
    d_in = x.shape[1]
    kp0, hp = pad16(d_in), pad16(hidden)
    w0b = weights[woffs[0]: woffs[0] + kp0 * hp].view(kp0, hp)
    fs = pb[offs[0]: offs[0] + d_in] if use_fn else None
    fb = pb[offs[1]: offs[1] + d_in] if use_fn else None
    return layer0_tail(x, xstats, g0, w0b, fs, fb, hidden, need_dx)


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
        need_dx = ctx.needs_input_grad[0]
        if g.is_cuda:
            dx, grads = trunk_backward_cuda(x, params, g, *ctx.cfg, packed=ctx.packed,
                                            need_dx=need_dx)
        else:
            dx, grads = trunk_backward_plain(x, params, g, *ctx.cfg, need_dx=need_dx)
        return (dx, None, None, *grads)


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
