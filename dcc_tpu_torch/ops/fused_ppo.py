"""K3 / K4 and K3u / K4u: fused PPO loss + gradient kernels
(``csrc/fused_ppo.cu``) and their plain PyTorch versions.

Counterparts of :func:`dcc_tpu.ops.fused_ppo.actor_ppo_grads_packed` and
:func:`dcc_tpu.ops.fused_ppo.critic_value_grads_packed`: one call per
network computes the SUM-reduced loss and every parameter gradient over all
rows. With ``fold=True`` (K3 / K4) the trunk runs folded
(:func:`fold_trunk` absorbs each LN affine into the next matmul;
:func:`unfold_trunk_grads` maps the gradients back). With ``fold=False``
(K3u / K4u) it runs as the trunk writes it: the LN affines are applied in
the chain (:func:`~dcc_tpu_torch.ops.fused_mlp._forward_chain`, bf16
rounding of each affine output) and every LN scale and bias gradient comes
out of the backward directly. The caller divides by the row count and
applies the loss coefficients.

The plain versions write the backward out explicitly, with JAX's autodiff
tie rules (min / max split the cotangent 50/50 on ties, clip composes the
two) and the bf16 rounding points of the kernel, so they mirror the
kernel's algorithm rather than autograd. On CUDA tensors the wrappers
launch the kernels or raise (in bf16 the tensor-core kernels, on padded
bf16 copies of the weights; in f32 the FMA ones); on CPU tensors they run
the plain versions. bf16 K3, K4, K3u and K4u at rows too wide for a
staged row tile (the 20-UAV preset's 4,840-wide critic rows; 4 UAVs x 300
PoIs, whose actor rows are 1,510 wide, ``ops.tiles.plan``) launch their
chunked kernel, which streams layer 0 over d_in in column chunks and
leaves layer 0's weight gradient to a second kernel, the dV0 kernel
(:func:`~dcc_tpu_torch.ops.fused_mlp.dv0_cuda`, counted under
``actor_ppo_grads_dv0`` / ``critic_ppo_grads_dv0``, for K3u / K4u, with
the feature norm's affine, under ``dv0_unfolded``), and K3u / K4u the
feature norm's gradients to the layer-0 input backward
(``layer0_input_bwd``). The chunked launch counts under the kernel's own
name (plain version of K4u's first launch:
:func:`critic_grads_unfolded_chunked_plain`).

Aux layout (row-major, the GPU needs no lane-padding workaround): actor rows
``[action (A), old_log_prob, advantage, valid]``, critic rows ``[vpred,
ret_raw, valid]``; ``norm = [shift, scale]`` normalizes the raw returns
inside the critic kernel.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from . import cuda_build as cb
from . import tiles
from .fused_mlp import (
    F32_KINK_EPS,
    _forward_chain,
    activation,
    bf16_round,
    check_mma_width,
    launch_name,
    scratch_ptr,
    dense,
    _mask_ptr,
    mask_gap,
    relu_grad_mask,
    dv0_cuda,
    finish_layer0_cuda,
    grads_blocks,
    input_stats,
    kernel_offsets,
    ln_stats,
    mma_tile_rows,
    pack_mma_weights,
    pad16,
    pack_params,
    require_shapes,
    tile_rows,
    trunk_bwd_chain,
    trunk_param_shapes,
)

LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# folding (O(H^2) host-side math, torch.matmul allowed)
# ---------------------------------------------------------------------------

def fold_trunk(params, head_w, head_b, n_layers: int, use_fn: bool):
    """Fold LN affines into the consuming matmuls. ``params`` is the flat
    [fn_scale, fn_bias]? + [W, b, s, c] * L list (W (d_in, d_out), 1-D
    vectors); returns ([V, u] * L, head_w', head_b') with V = s_in^T * W
    and u = c_in @ W + b for each consumer of an LN output."""
    i = 2 if use_fn else 0
    s_in = params[0] if use_fn else None
    c_in = params[1] if use_fn else None
    out = []
    for _ in range(n_layers):
        w, b = params[i], params[i + 1]
        if s_in is not None:
            out += [s_in[:, None] * w, c_in @ w + b]
        else:
            out += [w, b]
        s_in, c_in = params[i + 2], params[i + 3]
        i += 4
    return out, s_in[:, None] * head_w, c_in @ head_w + head_b


def unfold_trunk_grads(kgrads, dhead_w, dhead_b, params, head_w, n_layers: int, use_fn: bool):
    """Map folded grads [dV, du] * L + (dW'_h, db'_h) back onto the original
    parameters: dW = s_in^T * dV + c_in^T (x) du, db = du, ds_in = sum_d
    dV * W, dc_in = du @ W^T."""
    i = 2 if use_fn else 0
    s_in = params[0] if use_fn else None
    c_in = params[1] if use_fn else None
    out: List[torch.Tensor] = [None] * len(params)
    for li in range(n_layers):
        w = params[i]
        dv, du = kgrads[2 * li], kgrads[2 * li + 1]
        if s_in is not None:
            out[i] = s_in[:, None] * dv + c_in[:, None] * du[None, :]
            out[i - 2] = torch.sum(dv * w, dim=1)
            out[i - 1] = w @ du
        else:
            out[i] = dv
        out[i + 1] = du
        s_in, c_in = params[i + 2], params[i + 3]
        i += 4
    dwh = s_in[:, None] * dhead_w + c_in[:, None] * dhead_b[None, :]
    out[i - 2] = torch.sum(dhead_w * head_w, dim=1)
    out[i - 1] = head_w @ dhead_b
    return out, dwh, dhead_b


def pack_actor_aux(act, old_lp, adv) -> torch.Tensor:
    """(R, A+3) f32 rows [action, old_log_prob, advantage, valid=1]; built
    once per update (loop-invariant across the epochs)."""
    ones = torch.ones_like(old_lp, dtype=torch.float32)
    return torch.cat(
        [act.float(), old_lp.float(), adv.float(), ones], dim=1
    ).contiguous()


def pack_critic_aux(vpred, ret_raw) -> torch.Tensor:
    """(Rv, 3) f32 rows [vpred, RAW return, valid=1]."""
    ones = torch.ones_like(vpred, dtype=torch.float32)
    return torch.cat([vpred.float(), ret_raw.float(), ones], dim=1).contiguous()


# ---------------------------------------------------------------------------
# plain versions (explicit folded forward / backward)
# ---------------------------------------------------------------------------

def _mm(a, b, bf16: bool):
    return bf16_round(a) @ bf16_round(b) if bf16 else a @ b


def _balanced_lt(x, y):
    """d min(x, y) / dx: 1 where x<y, 0 where x>y, 0.5 on ties."""
    return torch.where(x < y, 1.0, torch.where(x > y, 0.0, 0.5))


def _clip_grad(x, lo: float, hi: float):
    """d clip(x, lo, hi) / dx for clip = min(max(x, lo), hi), balanced ties."""
    gmax = torch.where(x > lo, 1.0, torch.where(x < lo, 0.0, 0.5))
    m = torch.clamp(x, min=lo)
    gmin = torch.where(m < hi, 1.0, torch.where(m > hi, 0.0, 0.5))
    return gmax * gmin


def _fwd_folded(x, kp, n_layers, use_fn, use_relu, bf16, masks=None):
    """The folded chain's forward; ``masks``: each layer's relu mask to take
    instead of z > 0 (a kernel's ``relu_masks``), or None."""
    a = x.to(torch.float32)
    if use_fn:
        mu, inv = ln_stats(a)
        a = (a - mu) * inv
        a = bf16_round(a) if bf16 else a
    cache = []
    for li in range(n_layers):
        m = None if masks is None else masks[li]
        r = activation(dense(a, kp[2 * li], kp[2 * li + 1], bf16), use_relu, bf16, m)
        mu, inv = ln_stats(r)
        xhat = (r - mu) * inv
        cache.append((a, r, xhat, inv))
        a = bf16_round(xhat) if bf16 else xhat
    return a, cache


def _bwd_folded(g, cache, kp, n_layers, use_relu, bf16, to_layer0=False, masks=None):
    """The folded chain's backward: [dV, du] * L. With ``to_layer0``, as the
    chunked K3 / K4 split it, it stops at layer 0's cotangent (after its
    activation) and returns (that cotangent, the gradients with None for
    layer 0's dV). ``masks``: the relu masks the forward took, or None."""
    grads = [None] * (2 * n_layers)
    for li in reversed(range(n_layers)):
        a, r, xhat, inv = cache[li]
        g = inv * (
            g - g.mean(dim=-1, keepdim=True)
            - xhat * (g * xhat).mean(dim=-1, keepdim=True)
        )
        if use_relu:
            g = g * relu_grad_mask(r, None if masks is None else masks[li])
        else:
            g = g * (1.0 - r * r)
        grads[2 * li + 1] = g.sum(dim=0)
        if to_layer0 and li == 0:
            return g, grads
        grads[2 * li] = _mm(a.t(), g, bf16)
        if li > 0:
            g = _mm(g, kp[2 * li].t(), bf16)
    return grads


def _actor_head(feat, aux, whf, bhf, log_std, bf16, clip_param):
    """Gaussian head and clipped surrogate on the trunk output ``feat``:
    returns (dWh, dbh, dlog_std, [loss_sum, ratio_sum], the cotangent of
    ``feat``)."""
    act_dim = whf.shape[1]
    mean = dense(feat, whf, bhf, bf16)
    a, old_lp = aux[:, :act_dim], aux[:, act_dim : act_dim + 1]
    adv, valid = aux[:, act_dim + 1 : act_dim + 2], aux[:, act_dim + 2 : act_dim + 3]
    inv_std = torch.exp(-log_std)
    z = (a - mean) * inv_std
    lp = torch.sum(-0.5 * z * z - log_std - LOG_SQRT_2PI, dim=1, keepdim=True)
    ratio = torch.exp(lp - old_lp)
    lo, hi = 1.0 - clip_param, 1.0 + clip_param
    s1, s2 = ratio * adv, torch.clamp(ratio, lo, hi) * adv
    met = torch.stack([torch.sum(-torch.minimum(s1, s2)), torch.sum(ratio * valid)])
    w1 = _balanced_lt(s1, s2)
    dratio = -(w1 * adv + (1.0 - w1) * adv * _clip_grad(ratio, lo, hi))
    dlp = dratio * ratio
    dmean = dlp * z * inv_std
    dls = torch.sum(dlp * (z * z - 1.0), dim=0)
    dbh = torch.sum(dmean, dim=0)
    dwh = _mm(feat.t(), dmean, bf16)
    g = _mm(dmean, whf.t(), bf16)
    return dwh, dbh, dls, met, g


def actor_grads_plain(x, aux, kp, whf, bhf, log_std, *, n_layers, use_fn,
                      use_relu, bf16, clip_param, masks=None):
    """Plain K3 on folded params; returns ([dV, du] * L, dWh', dbh', dlog_std,
    [loss_sum, ratio_sum]). ``masks``: the relu masks to take (a kernel's
    ``relu_masks``), or None."""
    feat, cache = _fwd_folded(x, kp, n_layers, use_fn, use_relu, bf16, masks)
    dwh, dbh, dls, met, g = _actor_head(feat, aux, whf, bhf, log_std, bf16, clip_param)
    kg = _bwd_folded(g, cache, kp, n_layers, use_relu, bf16, masks=masks)
    return kg, dwh, dbh, dls, met


def actor_grads_unfolded_plain(x, aux, params, wh, bh, log_std, *, n_layers, use_fn,
                               use_relu, bf16, clip_param, masks=None):
    """Plain K3u on the flat trunk list ``params`` (``[fn_scale, fn_bias]? +
    [W, b, s, c] * L``): the unfolded chain, the head, and the chain's
    backward without d(input). Returns (trunk gradients shaped like
    ``params``, dWh, dbh, dlog_std, [loss_sum, ratio_sum])."""
    feat, fn_cache, layers = _forward_chain(x, params, n_layers, use_fn, use_relu, bf16, masks)
    dwh, dbh, dls, met, g = _actor_head(feat, aux, wh, bh, log_std, bf16, clip_param)
    _, tg = trunk_bwd_chain(g, params, fn_cache, layers, n_layers, use_fn, use_relu, bf16,
                            masks=masks)
    return tg, dwh, dbh, dls, met


def relu_mask_gap_folded(x, kp, n_layers: int, use_fn: bool, masks,
                         bf16: bool = True) -> tuple:
    """:func:`~dcc_tpu_torch.ops.fused_mlp.mask_gap` of the folded chain (K3,
    K4) on rows ``x`` with the folded [V, u] * L ``kp``."""
    with torch.no_grad():
        _, cache = _fwd_folded(x, kp, n_layers, use_fn, True, bf16, masks)
    return mask_gap([(a, kp[2 * li], kp[2 * li + 1]) for li, (a, *_) in enumerate(cache)],
                    masks, bf16)


def relu_kink_rows_folded(x, kp, n_layers: int, use_fn: bool,
                          bf16: bool = True) -> torch.Tensor:
    """(rows,) bool: rows of the folded bf16 relu chain with a pre-activation
    z no farther from the kink than the bf16 spacing at its pre-rounding
    accumulator. There a summation order other than the plain version's
    (the tensor cores') can move the accumulator across a bf16 rounding
    boundary and z across the kink, which changes the row's whole cotangent;
    the bf16 K3 checks give these rows a zero advantage. With ``bf16=False``,
    rows of the f32 chain with z within ``F32_KINK_EPS`` of the kink, where two f32
    summation orders may take opposite sides
    (:func:`dcc_tpu_torch.ops.fused_mlp.relu_kink_rows` is the unfolded
    chain's rule)."""
    with torch.no_grad():
        _, cache = _fwd_folded(x, kp, n_layers, use_fn, True, bf16)
        near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
        for li, (a, *_) in enumerate(cache):
            z = dense(a, kp[2 * li], kp[2 * li + 1], bf16)
            if not bf16:
                near |= (z.abs() < F32_KINK_EPS).any(dim=1)
                continue
            acc = _mm(a, kp[2 * li], True).abs().clamp_min(1e-30)
            near |= (z.abs() <= torch.exp2(torch.floor(torch.log2(acc)) - 7)).any(dim=1)
    return near


def huber(e, delta):
    """The reference's one-sided Huber: a*e^2/2 + b*delta*(|e| - delta/2)."""
    a = (torch.abs(e) <= delta).to(e.dtype)
    b = (e > delta).to(e.dtype)
    return a * e * e / 2.0 + b * delta * (torch.abs(e) - delta / 2.0)


def _huber_grad(e, delta):
    a = (torch.abs(e) <= delta).to(e.dtype)
    b = (e > delta).to(e.dtype)
    return a * e + b * delta


def _critic_head(feat, aux, norm, wvf, bvf, bf16, clip_param, huber_delta, use_huber,
                 use_clipped):
    """Value head and clipped / Huber value loss on the trunk output
    ``feat``: returns (dwv, dbv, [value_loss_sum], the cotangent of
    ``feat``)."""
    v = dense(feat, wvf, bvf, bf16)
    vpred, valid = aux[:, 0:1], aux[:, 2:3]
    ret = (aux[:, 1:2] - norm[0]) / norm[1]
    if use_huber:
        lf, dlf = (lambda e: huber(e, huber_delta)), (lambda e: _huber_grad(e, huber_delta))
    else:
        lf, dlf = (lambda e: e * e / 2.0), (lambda e: e)
    err = ret - v
    if use_clipped:
        dv_raw = v - vpred
        err_c = ret - (vpred + torch.clamp(dv_raw, -clip_param, clip_param))
        h1, h2 = lf(err), lf(err_c)
        loss_rows = torch.maximum(h1, h2) * valid
        w1 = _balanced_lt(h2, h1)
        dloss = -(
            w1 * dlf(err)
            + (1.0 - w1) * dlf(err_c) * _clip_grad(dv_raw, -clip_param, clip_param)
        )
    else:
        loss_rows = lf(err) * valid
        dloss = -dlf(err)
    dv = dloss * valid
    dwv = _mm(feat.t(), dv, bf16)
    g = _mm(dv, wvf.t(), bf16)
    return dwv, dv.sum(dim=0), loss_rows.sum().reshape(1), g


def critic_grads_plain(x, aux, norm, kp, wvf, bvf, *, n_layers, use_fn, use_relu,
                       bf16, clip_param, huber_delta, use_huber, use_clipped, masks=None):
    """Plain K4 on folded params; returns ([dV, du] * L, dwv', dbv',
    [value_loss_sum]). ``masks`` as in :func:`actor_grads_plain`."""
    feat, cache = _fwd_folded(x, kp, n_layers, use_fn, use_relu, bf16, masks)
    dwv, dbv, met, g = _critic_head(feat, aux, norm, wvf, bvf, bf16, clip_param,
                                    huber_delta, use_huber, use_clipped)
    kg = _bwd_folded(g, cache, kp, n_layers, use_relu, bf16, masks=masks)
    return kg, dwv, dbv, met


def critic_grads_unfolded_plain(x, aux, norm, params, wv, bv, *, n_layers, use_fn,
                                use_relu, bf16, clip_param, huber_delta, use_huber,
                                use_clipped, masks=None):
    """Plain K4u on the flat trunk list ``params``; returns (trunk gradients
    shaped like ``params``, dwv, dbv, [value_loss_sum])."""
    feat, fn_cache, layers = _forward_chain(x, params, n_layers, use_fn, use_relu, bf16, masks)
    dwv, dbv, met, g = _critic_head(feat, aux, norm, wv, bv, bf16, clip_param, huber_delta,
                                    use_huber, use_clipped)
    _, tg = trunk_bwd_chain(g, params, fn_cache, layers, n_layers, use_fn, use_relu, bf16,
                            masks=masks)
    return tg, dwv, dbv, met


def critic_grads_unfolded_chunked_plain(x, aux, norm, params, wv, bv, *, n_layers, use_fn,
                                        use_relu, bf16, clip_param, huber_delta, use_huber,
                                        use_clipped, masks=None):
    """Plain chunked K4u (its first launch): the unfolded chain, the head and
    the backward down to layer 0's cotangent. Returns (the trunk gradients
    from layer 0's bias on, dwv, dbv, [value_loss_sum], layer 0's bf16
    cotangent g0, ``input_stats``); the dV0 kernel (affine mode) and the
    layer-0 input backward give the rest."""
    feat, fn_cache, layers = _forward_chain(x, params, n_layers, use_fn, use_relu, bf16, masks)
    dwv, dbv, met, g = _critic_head(feat, aux, norm, wv, bv, bf16, clip_param, huber_delta,
                                    use_huber, use_clipped)
    g0, tg = trunk_bwd_chain(g, params, fn_cache, layers, n_layers, use_fn, use_relu, bf16,
                             to_layer0=True, masks=masks)
    first = 2 if use_fn else 0
    return tg[first + 1:], dwv, dbv, met, g0.to(torch.bfloat16), input_stats(x, use_fn)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _kernel_params(kp, head: Sequence[torch.Tensor], device, mma: bool = False):
    """Packed f32 buffer + offsets: per layer [V, V^T (or a dummy), u], then
    head. For the tensor-core kernel (``mma``) V and V^T are dummies and the
    V's go into a bf16 buffer (:func:`pack_mma_weights`); returns (buffer,
    offsets, bf16 buffer or None, its offsets or None)."""
    flat = []
    for li in range(len(kp) // 2):
        v = kp[2 * li]
        if mma:
            flat += [v[:0], v[:0], kp[2 * li + 1]]
        else:
            flat += [v, v.t().contiguous() if li > 0 else v[:0], kp[2 * li + 1]]
    pb, offs = pack_params(flat + list(head), device)
    if not mma:
        return pb, offs, None, None
    return (pb, offs, *pack_mma_weights(kp[0::2], device))


def _slot_split(out, shapes):
    """Split a reduced gradient slot into consecutive tensors of ``shapes``."""
    res, o = [], 0
    for shape in shapes:
        n = math.prod(shape)
        res.append(out[o : o + n].view(shape))
        o += n
    return res


def _unfolded_params(trunk, head, n_layers, use_fn, device, mma: bool):
    """Packed f32 buffer + offsets of K3u / K4u: the flat trunk list (the fn
    offsets are dummies without the feature norm), then each W^T for the FMA
    kernel, then the head; for the tensor-core kernel also the padded bf16
    W's. Returns (buffer, offsets, bf16 buffer or None, its offsets or
    None)."""
    first = 2 if use_fn else 0
    ws = [trunk[first + 4 * li] for li in range(n_layers)]
    flat = list(trunk) + ([] if mma else [w.t().contiguous() for w in ws]) + list(head)
    pb, offs = pack_params(flat, device)
    offs = kernel_offsets(offs, use_fn)
    if not mma:
        return pb, offs, None, None
    return (pb, offs, *pack_mma_weights(ws, device))


def _launch_grads(kind, x, aux, trunk, head, *, n_layers, use_fn, use_relu, bf16,
                  act_dim, fn_args, unfolded=False, relu_masks=None, _deep=False,
                  _blocked=False):
    """Launch K3 / K4 (``trunk`` the folded [V, u] * L) or K3u / K4u (the
    flat trunk list) and its slot reduction; returns (trunk gradients,
    head gradients and metrics). ``relu_masks`` (bf16): None, or an (L,
    rows, H) uint8 tensor the kernel fills with its relu masks. ``_deep``
    (bf16): the depth layout on the tiles ``ops.tiles.plan`` gives, for
    holding it against the staged layout on the same tile; ``_blocked``
    (bf16): the column-blocked layout forced."""
    rows, d_in = x.shape
    hidden = head[0].shape[0]
    cb.require(x, "x", (torch.float32, torch.bfloat16), device=x.device)
    cb.require(aux, "aux", (torch.float32,), (rows, act_dim + 3 if kind == "actor" else 3),
               x.device)
    if unfolded:
        trunk_shapes = trunk_param_shapes(d_in, hidden, n_layers, use_fn)
    else:
        dims = [d_in] + [hidden] * (n_layers - 1)
        trunk_shapes = [s for d in dims for s in ((d, hidden), (hidden,))]
    if kind == "actor":
        extra = [(hidden, act_dim), (act_dim,), (act_dim,), (2,)]
    else:
        extra = [(hidden, 1), (1,), (1,)]
    # the head's parameters have the shapes of its gradients
    require_shapes([*trunk, *head], trunk_shapes + extra[: len(head)],
                   "unfolded parameter" if unfolded else "folded parameter")
    mask_ptr = _mask_ptr(relu_masks, n_layers, rows, hidden, bf16, x.device)
    if unfolded:
        pb, offs, wb, woffs = _unfolded_params(trunk, head, n_layers, use_fn, x.device, bf16)
    else:
        pb, offs, wb, woffs = _kernel_params(trunk, head, x.device, bf16)
    n_head = 1 if kind == "critic" else act_dim
    tag = "_unfolded" if unfolded else ""
    name = f"{kind}_ppo_grads{tag}"
    # rows too wide for a staged tile: the chunked layer 0, then the dV0
    # kernel (and unfolded the layer-0 input backward)
    # bf16 runs on the tensor cores, f32 on FMA
    if bf16:
        tp = check_mma_width(name, d_in, hidden, n_layers, n_head, blocked=_blocked)
        tp = tp._replace(deep=True) if _deep else tp
        lib = cb.mma_library("fused_ppo", hidden, tp.blocked)
    else:
        tp = tiles.plan(name, False, d_in, hidden, n_layers, n_head)
        lib = cb.library("fused_ppo")
    chunked, sizes, deep, blocked = tp
    smem = lambda b: tiles.smem_bytes(name, bf16, b, d_in, hidden, n_layers, n_head,
                                      chunked, deep, blocked) // 4
    if bf16:
        br = mma_tile_rows(rows, d_in, smem, cb.sm_count(x.device), sizes)
    else:
        br = tile_rows(d_in, smem, tiles.SIZES[(name, False)])
    shapes = trunk_shapes + extra
    if chunked:  # layer 0's dV (unfolded: also the feature norm's gradients)
        # come from the kernels that finish layer 0, not the slots
        shapes = shapes[1 + (2 if unfolded and use_fn else 0):]
    used = sum(math.prod(s) for s in shapes)
    slot = -(-used // 4) * 4  # 16-byte aligned slots; the tail is not read
    n_blocks = grads_blocks(-(-rows // br), cb.sm_count(x.device), bf16)
    slots = torch.empty((n_blocks, slot), dtype=torch.float32, device=x.device)
    out = torch.empty((slot,), dtype=torch.float32, device=x.device)
    # the offsets as the kernels read them: device tables, one per trunk shape
    table = cb.offsets_table(offs, x.device)
    x_bf16 = int(x.dtype == torch.bfloat16)
    weights = ()
    if bf16:
        wtable = cb.offsets_table(woffs, x.device)
        weights = (wb.data_ptr(), wtable.data_ptr(), wtable.numel())
    entry = f"dcc_{kind}_grads{tag}" + ("_chunked" if chunked else "") + ("_mma" if bf16 else "")
    if chunked:
        g0 = torch.empty((rows, pad16(hidden)), dtype=torch.bfloat16, device=x.device)
        xstats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
        outs = (g0.data_ptr(), xstats.data_ptr(), out.data_ptr())
    else:
        outs = (out.data_ptr(),)
    if bf16:
        outs += (mask_ptr, scratch_ptr(name, tp, br, d_in, hidden, n_layers, n_blocks, x.device))
    if kind == "actor":
        code = getattr(lib, entry)(
            x.data_ptr(), x_bf16, aux.data_ptr(), rows, d_in, hidden, n_layers, act_dim,
            int(use_fn), int(use_relu), *fn_args, br, pb.data_ptr(), table.data_ptr(),
            table.numel(), *weights, slots.data_ptr(), slot, n_blocks, *outs, cb.stream_of(x),
        )
    else:
        norm = fn_args[0]
        cb.require(norm, "norm", (torch.float32,), (2,), x.device)
        code = getattr(lib, entry)(
            x.data_ptr(), x_bf16, aux.data_ptr(), norm.data_ptr(), rows, d_in, hidden,
            n_layers, int(use_fn), int(use_relu), *fn_args[1:], br, pb.data_ptr(),
            table.data_ptr(), table.numel(), *weights, slots.data_ptr(), slot, n_blocks, *outs,
            cb.stream_of(x),
        )
    counted = launch_name(name, tp)
    cb.check("fused_ppo", code, counted)
    cb.LAUNCHES[counted] += 1
    cb.ENTRY[counted] = entry
    cb.TILE[counted] = br
    parts = _slot_split(out, shapes)
    if chunked and unfolded:
        parts = finish_layer0_cuda(x, xstats, g0, pb, offs, wb, woffs, hidden, use_fn,
                                   need_dx=False)[1] + parts
    elif chunked:
        parts = [dv0_cuda(x, xstats, g0, hidden, kind=kind)] + parts
    n_trunk = len(trunk_shapes)
    return parts[:n_trunk], parts[n_trunk:]


def actor_grads_cuda(x, aux, kp, whf, bhf, log_std, *, n_layers, use_fn, use_relu,
                     bf16, clip_param, relu_masks=None, _deep=False, _blocked=False):
    """Launch K3 (+ its slot reduction); same returns as the plain version.
    ``relu_masks`` as in :func:`_launch_grads`."""
    kg, (dwh, dbh, dls, met) = _launch_grads(
        "actor", x, aux, kp, [whf, bhf, log_std], n_layers=n_layers, use_fn=use_fn,
        use_relu=use_relu, bf16=bf16, act_dim=whf.shape[1], fn_args=(float(clip_param),),
        relu_masks=relu_masks, _deep=_deep, _blocked=_blocked,
    )
    return kg, dwh, dbh, dls, met


def actor_grads_unfolded_cuda(x, aux, params, wh, bh, log_std, *, n_layers, use_fn,
                              use_relu, bf16, clip_param, relu_masks=None, _deep=False,
                              _blocked=False):
    """Launch K3u (+ its slot reduction); same returns as the plain version."""
    tg, (dwh, dbh, dls, met) = _launch_grads(
        "actor", x, aux, list(params), [wh, bh, log_std], n_layers=n_layers, use_fn=use_fn,
        use_relu=use_relu, bf16=bf16, act_dim=wh.shape[1], fn_args=(float(clip_param),),
        unfolded=True, relu_masks=relu_masks, _deep=_deep, _blocked=_blocked,
    )
    return tg, dwh, dbh, dls, met


def _critic_args(norm, clip_param, huber_delta, use_huber, use_clipped):
    return (norm, float(clip_param), float(huber_delta), int(use_huber), int(use_clipped))


def critic_grads_cuda(x, aux, norm, kp, wvf, bvf, *, n_layers, use_fn, use_relu, bf16,
                      clip_param, huber_delta, use_huber, use_clipped, relu_masks=None,
                      _deep=False, _blocked=False):
    """Launch K4 (+ its slot reduction); same returns as the plain version."""
    kg, (dwv, dbv, met) = _launch_grads(
        "critic", x, aux, kp, [wvf, bvf], n_layers=n_layers, use_fn=use_fn,
        use_relu=use_relu, bf16=bf16, act_dim=1,
        fn_args=_critic_args(norm, clip_param, huber_delta, use_huber, use_clipped),
        relu_masks=relu_masks, _deep=_deep, _blocked=_blocked,
    )
    return kg, dwv, dbv, met


def critic_grads_unfolded_cuda(x, aux, norm, params, wv, bv, *, n_layers, use_fn, use_relu,
                               bf16, clip_param, huber_delta, use_huber, use_clipped,
                               relu_masks=None, _deep=False, _blocked=False):
    """Launch K4u (+ its slot reduction); same returns as the plain version."""
    tg, (dwv, dbv, met) = _launch_grads(
        "critic", x, aux, list(params), [wv, bv], n_layers=n_layers, use_fn=use_fn,
        use_relu=use_relu, bf16=bf16, act_dim=1,
        fn_args=_critic_args(norm, clip_param, huber_delta, use_huber, use_clipped),
        unfolded=True, relu_masks=relu_masks, _deep=_deep, _blocked=_blocked,
    )
    return tg, dwv, dbv, met


# ---------------------------------------------------------------------------
# public wrappers (the dcc_tpu.ops.fused_ppo API)
# ---------------------------------------------------------------------------

def actor_ppo_grads_packed(
    x, aux, trunk_params, head_kernel, head_bias, log_std, *, n_layers,
    use_feature_norm=True, use_relu=True, bf16=False, clip_param=0.2, fold=True,
):
    """SUM-reduced clipped-surrogate loss and gradients over all rows of
    ``x`` (R, d_in) with packed ``aux`` from :func:`pack_actor_aux`, through
    K3 (``fold``) or K3u. Returns (trunk_grads shaped like ``trunk_params``,
    d_head_kernel, d_head_bias, d_log_std, [policy_loss_sum, ratio_sum])."""
    kw = dict(n_layers=n_layers, use_fn=use_feature_norm, use_relu=use_relu, bf16=bf16,
              clip_param=clip_param)
    if not fold:
        fn = actor_grads_unfolded_cuda if x.is_cuda else actor_grads_unfolded_plain
        return fn(x, aux, list(trunk_params), head_kernel, head_bias, log_std, **kw)
    kp, whf, bhf = fold_trunk(trunk_params, head_kernel, head_bias, n_layers,
                              use_feature_norm)
    fn = actor_grads_cuda if x.is_cuda else actor_grads_plain
    kg, dwh, dbh, dls, met = fn(x, aux, kp, whf, bhf, log_std, **kw)
    tg, dwh, dbh = unfold_trunk_grads(kg, dwh, dbh, trunk_params, head_kernel,
                                      n_layers, use_feature_norm)
    return tg, dwh, dbh, dls, met


def critic_value_grads_packed(
    x, aux, norm, trunk_params, head_kernel, head_bias, *, n_layers,
    use_feature_norm=True, use_relu=True, bf16=False, clip_param=0.2,
    huber_delta=10.0, use_huber=True, use_clipped=True, fold=True,
):
    """SUM-reduced clipped / Huber value loss and gradients over all rows of
    ``x`` (Rv, d_in) with packed ``aux`` from :func:`pack_critic_aux` and
    ``norm = [shift, scale]``, through K4 (``fold``) or K4u. Returns
    (trunk_grads, d_head_kernel, d_head_bias, [value_loss_sum])."""
    kw = dict(n_layers=n_layers, use_fn=use_feature_norm, use_relu=use_relu, bf16=bf16,
              clip_param=clip_param, huber_delta=huber_delta, use_huber=use_huber,
              use_clipped=use_clipped)
    if not fold:
        fn = critic_grads_unfolded_cuda if x.is_cuda else critic_grads_unfolded_plain
        return fn(x, aux, norm, list(trunk_params), head_kernel, head_bias, **kw)
    kp, wvf, bvf = fold_trunk(trunk_params, head_kernel, head_bias, n_layers,
                              use_feature_norm)
    fn = critic_grads_cuda if x.is_cuda else critic_grads_plain
    kg, dwv, dbv, met = fn(x, aux, norm, kp, wvf, bvf, **kw)
    tg, dwv, dbv = unfold_trunk_grads(kg, dwv, dbv, trunk_params, head_kernel,
                                      n_layers, use_feature_norm)
    return tg, dwv, dbv, met
