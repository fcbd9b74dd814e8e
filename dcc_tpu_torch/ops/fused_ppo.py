"""K3 / K4: fused PPO loss + gradient kernels (``csrc/fused_ppo.cu``) and
their plain PyTorch versions.

Counterparts of :func:`dcc_tpu.ops.fused_ppo.actor_ppo_grads_packed` and
:func:`dcc_tpu.ops.fused_ppo.critic_value_grads_packed` with ``fold=True``:
one call per network computes the SUM-reduced loss and every parameter
gradient over all rows. The trunk runs folded (:func:`fold_trunk` absorbs
each LN affine into the next matmul; :func:`unfold_trunk_grads` maps the
gradients back). The caller divides by the row count and applies the loss
coefficients.

The plain versions write the folded backward out explicitly, with JAX's
autodiff tie rules (min / max split the cotangent 50/50 on ties, clip
composes the two) and the bf16 rounding points of the kernel, so they mirror
the kernel's algorithm rather than autograd. On CUDA tensors the wrappers
launch the kernels or raise; on CPU tensors they run the plain versions.

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
from .fused_mlp import (
    activation,
    bf16_round,
    dense,
    ln_stats,
    pack_params,
    require_shapes,
    tile_rows,
)

LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
_NOT_FOLDED = (
    "the unfolded fused-loss kernels (fused_fold=False) are not ported yet "
    "(ROADMAP: fused_fold=False)"
)


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


def _fwd_folded(x, kp, n_layers, use_fn, use_relu, bf16):
    a = x.to(torch.float32)
    if use_fn:
        mu, inv = ln_stats(a)
        a = (a - mu) * inv
        a = bf16_round(a) if bf16 else a
    cache = []
    for li in range(n_layers):
        r = activation(dense(a, kp[2 * li], kp[2 * li + 1], bf16), use_relu, bf16)
        mu, inv = ln_stats(r)
        xhat = (r - mu) * inv
        cache.append((a, r, xhat, inv))
        a = bf16_round(xhat) if bf16 else xhat
    return a, cache


def _bwd_folded(g, cache, kp, n_layers, use_relu, bf16):
    grads = [None] * (2 * n_layers)
    for li in reversed(range(n_layers)):
        a, r, xhat, inv = cache[li]
        g = inv * (
            g - g.mean(dim=-1, keepdim=True)
            - xhat * (g * xhat).mean(dim=-1, keepdim=True)
        )
        g = g * (r > 0).to(g.dtype) if use_relu else g * (1.0 - r * r)
        grads[2 * li] = _mm(a.t(), g, bf16)
        grads[2 * li + 1] = g.sum(dim=0)
        if li > 0:
            g = _mm(g, kp[2 * li].t(), bf16)
    return grads


def actor_grads_plain(x, aux, kp, whf, bhf, log_std, *, n_layers, use_fn,
                      use_relu, bf16, clip_param):
    """Plain K3 on folded params; returns ([dV, du] * L, dWh', dbh', dlog_std,
    [loss_sum, ratio_sum])."""
    act_dim = whf.shape[1]
    feat, cache = _fwd_folded(x, kp, n_layers, use_fn, use_relu, bf16)
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
    kg = _bwd_folded(g, cache, kp, n_layers, use_relu, bf16)
    return kg, dwh, dbh, dls, met


def huber(e, delta):
    """The reference's one-sided Huber: a*e^2/2 + b*delta*(|e| - delta/2)."""
    a = (torch.abs(e) <= delta).to(e.dtype)
    b = (e > delta).to(e.dtype)
    return a * e * e / 2.0 + b * delta * (torch.abs(e) - delta / 2.0)


def _huber_grad(e, delta):
    a = (torch.abs(e) <= delta).to(e.dtype)
    b = (e > delta).to(e.dtype)
    return a * e + b * delta


def critic_grads_plain(x, aux, norm, kp, wvf, bvf, *, n_layers, use_fn, use_relu,
                       bf16, clip_param, huber_delta, use_huber, use_clipped):
    """Plain K4 on folded params; returns ([dV, du] * L, dwv', dbv',
    [value_loss_sum])."""
    feat, cache = _fwd_folded(x, kp, n_layers, use_fn, use_relu, bf16)
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
    kg = _bwd_folded(g, cache, kp, n_layers, use_relu, bf16)
    return kg, dwv, dv.sum(dim=0), loss_rows.sum().reshape(1)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _kernel_params(kp, head: Sequence[torch.Tensor], device):
    """Packed buffer + offsets: per layer [V, V^T (or a dummy), u], then head."""
    flat = []
    for li in range(len(kp) // 2):
        v = kp[2 * li]
        flat += [v, v.t().contiguous() if li > 0 else v[:0], kp[2 * li + 1]]
    return pack_params(flat + list(head), device)


def _slot_split(out, dims, hidden, extra):
    """Split a reduced gradient slot into ([dV, du] * L, *extras)."""
    res, o = [], 0
    for d in dims:
        res.append(out[o : o + d * hidden].view(d, hidden))
        o += d * hidden
        res.append(out[o : o + hidden])
        o += hidden
    for shape in extra:
        n = math.prod(shape)
        res.append(out[o : o + n].view(shape))
        o += n
    return res


def _launch_grads(kind, x, aux, kp, head, *, n_layers, use_fn, use_relu, bf16,
                  act_dim, fn_args):
    rows, d_in = x.shape
    hidden = kp[1].shape[0]
    cb.require(x, "x", (torch.float32, torch.bfloat16), device=x.device)
    cb.require(aux, "aux", (torch.float32,), (rows, act_dim + 3 if kind == "actor" else 3),
               x.device)
    dims = [d_in] + [hidden] * (n_layers - 1)
    if kind == "actor":
        extra = [(hidden, act_dim), (act_dim,), (act_dim,), (2,)]
    else:
        extra = [(hidden, 1), (1,), (1,)]
    # the head's parameters have the shapes of its gradients
    require_shapes([*kp, *head], [s for d in dims for s in ((d, hidden), (hidden,))]
                   + extra[: len(head)], "folded parameter")
    pb, offs = _kernel_params(kp, head, x.device)
    lib = cb.library("fused_ppo")
    n_head = 1 if kind == "critic" else act_dim
    br = tile_rows(
        d_in, lambda b: lib.dcc_ppo_smem_bytes(b, d_in, hidden, n_layers, n_head) // 4
    )
    slot =sum(d * hidden + hidden for d in dims) + sum(math.prod(s) for s in extra)
    n_blocks = max(1, min(-(-rows // br), cb.sm_count(x.device)))
    slots = torch.empty((n_blocks, slot), dtype=torch.float32, device=x.device)
    out = torch.empty((slot,), dtype=torch.float32, device=x.device)
    offs_c = (cb._L * len(offs))(*offs)
    common = (int(use_fn), int(use_relu), int(bf16))
    if kind == "actor":
        code = lib.dcc_actor_grads(
            x.data_ptr(), int(x.dtype == torch.bfloat16), aux.data_ptr(), rows, d_in, hidden,
            n_layers, act_dim, *common, *fn_args, br, pb.data_ptr(), offs_c, len(offs),
            slots.data_ptr(), slot, n_blocks, out.data_ptr(), cb.stream_of(x),
        )
    else:
        norm = fn_args[0]
        cb.require(norm, "norm", (torch.float32,), (2,), x.device)
        code = lib.dcc_critic_grads(
            x.data_ptr(), int(x.dtype == torch.bfloat16), aux.data_ptr(), norm.data_ptr(), rows,
            d_in, hidden, n_layers, *common, *fn_args[1:], br, pb.data_ptr(), offs_c,
            len(offs), slots.data_ptr(), slot, n_blocks, out.data_ptr(), cb.stream_of(x),
        )
    cb.check("fused_ppo", code, f"{kind}_ppo_grads")
    cb.LAUNCHES[f"{kind}_ppo_grads"] += 1
    parts = _slot_split(out, dims, hidden, extra)
    return parts[: 2 * n_layers], parts[2 * n_layers :]


def actor_grads_cuda(x, aux, kp, whf, bhf, log_std, *, n_layers, use_fn, use_relu,
                     bf16, clip_param):
    """Launch K3 (+ its slot reduction); same returns as the plain version."""
    kg, (dwh, dbh, dls, met) = _launch_grads(
        "actor", x, aux, kp, [whf, bhf, log_std], n_layers=n_layers, use_fn=use_fn,
        use_relu=use_relu, bf16=bf16, act_dim=whf.shape[1], fn_args=(float(clip_param),),
    )
    return kg, dwh, dbh, dls, met


def critic_grads_cuda(x, aux, norm, kp, wvf, bvf, *, n_layers, use_fn, use_relu, bf16,
                      clip_param, huber_delta, use_huber, use_clipped):
    """Launch K4 (+ its slot reduction); same returns as the plain version."""
    kg, (dwv, dbv, met) = _launch_grads(
        "critic", x, aux, kp, [wvf, bvf], n_layers=n_layers, use_fn=use_fn,
        use_relu=use_relu, bf16=bf16, act_dim=1,
        fn_args=(norm, float(clip_param), float(huber_delta), int(use_huber),
                 int(use_clipped)),
    )
    return kg, dwv, dbv, met


# ---------------------------------------------------------------------------
# public wrappers (the dcc_tpu.ops.fused_ppo API)
# ---------------------------------------------------------------------------

def actor_ppo_grads_packed(
    x, aux, trunk_params, head_kernel, head_bias, log_std, *, n_layers,
    use_feature_norm=True, use_relu=True, bf16=False, clip_param=0.2, fold=True,
):
    """SUM-reduced clipped-surrogate loss and gradients over all rows of
    ``x`` (R, d_in) with packed ``aux`` from :func:`pack_actor_aux`. Returns
    (trunk_grads shaped like ``trunk_params``, d_head_kernel, d_head_bias,
    d_log_std, [policy_loss_sum, ratio_sum])."""
    if not fold:
        raise NotImplementedError(_NOT_FOLDED)
    kp, whf, bhf = fold_trunk(trunk_params, head_kernel, head_bias, n_layers,
                              use_feature_norm)
    fn = actor_grads_cuda if x.is_cuda else actor_grads_plain
    kg, dwh, dbh, dls, met = fn(
        x, aux, kp, whf, bhf, log_std, n_layers=n_layers, use_fn=use_feature_norm,
        use_relu=use_relu, bf16=bf16, clip_param=clip_param,
    )
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
    ``norm = [shift, scale]``. Returns (trunk_grads, d_head_kernel,
    d_head_bias, [value_loss_sum])."""
    if not fold:
        raise NotImplementedError(_NOT_FOLDED)
    kp, wvf, bvf = fold_trunk(trunk_params, head_kernel, head_bias, n_layers,
                              use_feature_norm)
    fn = critic_grads_cuda if x.is_cuda else critic_grads_plain
    kg, dwv, dbv, met = fn(
        x, aux, norm, kp, wvf, bvf, n_layers=n_layers, use_fn=use_feature_norm,
        use_relu=use_relu, bf16=bf16, clip_param=clip_param, huber_delta=huber_delta,
        use_huber=use_huber, use_clipped=use_clipped,
    )
    tg, dwv, dbv = unfold_trunk_grads(kg, dwv, dbv, trunk_params, head_kernel,
                                      n_layers, use_feature_norm)
    return tg, dwv, dbv, met
