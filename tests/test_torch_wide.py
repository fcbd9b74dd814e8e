"""The 20-UAV preset's bf16 path (``dcc_20uav_16k_dist``: 20 UAVs, 40 PoIs,
242-wide actor rows, 4,840-wide team-concat critic rows, hidden 256, two
layers, bf16) against the JAX package's on the CPU, at 2 envs, an 8-step
episode and 2 epochs (the widths intact; the scale cut for the CPU): the
deterministic rollout (K2's plain version against JAX's interpreted fused
trunk) gives JAX's trajectory, the stored bf16 observations and bf16
values within one bf16 step on fewer than 1 % of their elements and
everything else within 1e-4; one fused update (K3 / K4's plain versions
against JAX's interpreted kernels, compiled with
``xla_allow_excess_precision`` off as in tests/test_torch_bf16_path.py)
gives JAX's parameter change within a relative L2 distance of 0.02, where
the same update in f32 lies outside it. The preset's ``update_chunks`` 4 and
``use_remat`` take no part in the fused update, in JAX's dispatch and the
port's. The same holds for the updates that run the chunked K2b and K4u on
the card: the fused loss off (autograd through the trunk, 4 update chunks
with remat; JAX's K2b interpreted), unfolded (JAX's K4u interpreted) and
the recurrent policy (JAX's K2b interpreted). And the plain split of each
chunked kernel equals its one-pass plain version: the chunked K4's second
launch (dV0 from layer 0's bf16 cotangent and the rows' statistics,
``dv0_plain``) gives the one-pass plain K4's layer-0 dV; the chunked K2b
(the chain to layer 0's cotangent, then the layer-0 input backward and dV0
with the feature norm's affine) and K4u (the same without dx) give
``trunk_backward_plain`` and ``critic_grads_unfolded_plain``."""

import functools

import jax
import numpy as np
import pytest
import torch

from dcc_tpu.algos import MAPPO as JMAPPO
from dcc_tpu.configs import load_preset as j_load_preset
from dcc_tpu_torch.algos import MAPPO, Trajectory
from dcc_tpu_torch.compat import flax_to_state_dict
from dcc_tpu_torch.configs import load_preset
from dcc_tpu_torch.ops import fused_mlp as FM
from dcc_tpu_torch.ops import fused_ppo as FP
from dcc_tpu_torch.ops.fused_mlp import bf16_round

PRESET = "20uav_16k_dist"
SMALL = {"n_rollout_threads": 2, "max_ep_len": 8, "ppo_epoch": 2}
KERNELS = dict(fused_loss="on", fused_trunk="on")


def _jax(compute_dtype, **over):
    """JAX's MAPPO on the cut preset, its kernels interpreted in bf16 (off in
    f32), with the config fields ``over`` set."""
    _, jenv, jcfg = j_load_preset(PRESET, overrides=SMALL)
    kernels = "interpret" if compute_dtype == "bfloat16" else "off"
    return JMAPPO(jcfg._replace(**{**dict(fused_loss=kernels, fused_trunk=kernels,
                                          gae_backend="xla", compute_dtype=compute_dtype),
                                   **over}), jenv)


def _port(jts, compute_dtype, **over):
    """The port's MAPPO from JAX's state ``jts``: bf16 through the kernels'
    plain versions (``KERNELS``, then ``over``), f32 without them."""
    _, env_cfg, cfg = load_preset(PRESET, overrides=SMALL)
    bf16 = compute_dtype == "bfloat16"
    kernels = KERNELS if bf16 else dict(fused_loss="off", fused_trunk="off")
    if not bf16:
        over = {k: v for k, v in over.items() if k not in kernels}
    cfg = cfg._replace(compute_dtype=compute_dtype, **{**kernels, **over})
    algo = MAPPO(cfg, env_cfg, device="cpu")
    actor, critic = algo.make_networks()
    actor.load_state_dict(flax_to_state_dict(jax.device_get(jts.actor_params)))
    critic.load_state_dict(flax_to_state_dict(jax.device_get(jts.critic_params)))
    return algo, algo.init_state(actor=actor, critic=critic)


def _to_torch(jtraj):
    return Trajectory(*(None if getattr(jtraj, f) is None
                        else torch.from_numpy(np.array(getattr(jtraj, f), np.float32))
                        for f in Trajectory._fields))


@functools.lru_cache(maxsize=None)
def _jax_start():
    jalgo = _jax("bfloat16")
    return jalgo, jalgo.init_state(jax.random.PRNGKey(0))


def test_preset_widths():
    _, env_cfg, cfg = load_preset(PRESET)
    assert (env_cfg.n_agents, env_cfg.n_pois) == (20, 40)
    assert (env_cfg.obs_dim, env_cfg.share_obs_dim) == (242, 4840)
    assert (cfg.hidden_size, cfg.layer_n + 1, cfg.compute_dtype) == (256, 2, "bfloat16")
    assert (cfg.update_chunks, cfg.use_remat, cfg.ppo_epoch) == (4, True, 15)


def test_wide_rollout_matches_jax():
    jalgo, jts = _jax_start()
    algo, ts = _port(jts, "bfloat16")
    jtraj = jax.jit(lambda t, k: jalgo.rollout(t, k, 2, deterministic=True))(
        jts, jax.random.PRNGKey(1))
    traj = algo.rollout(ts, 2, deterministic=True)
    for f in Trajectory._fields[:8]:
        got = getattr(traj, f).float().numpy()
        want = np.asarray(getattr(jtraj, f), np.float32)
        if f in ("obs", "values"):  # stored or computed in bf16
            assert (np.abs(got - want) > 1e-4).mean() < 1e-2, f
            np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=1e-4, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, atol=1e-4, err_msg=f)


def _change(params, start):
    return {k: params[k] - start[k] for k in start}


def _distance(got, want):
    num = sum(float((got[k] - want[k]).square().sum()) for k in want)
    return (num / sum(float(w.square().sum()) for w in want.values())) ** 0.5


def test_wide_fused_update_matches_jax(monkeypatch):
    jalgo, jts = _jax_start()
    jtraj = jax.jit(lambda t, k: jalgo.rollout(t, k, 2))(jts, jax.random.PRNGKey(3))
    jadv, jret = jalgo.compute_returns(jts, jtraj)
    args = (jts, jax.random.PRNGKey(4), jtraj, jadv, jret)
    jts2, jm = jax.jit(jalgo.update).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)
    changes = {}
    for dtype in ("bfloat16", "float32"):
        algo, ts = _port(jts, dtype)
        if dtype == "bfloat16":  # the fused update bypasses update_chunks and remat
            assert algo.fused_loss and algo.cfg.update_chunks == 4 and algo.cfg.use_remat
            monkeypatch.setattr(algo, "_update_ff_chunked", None)
            monkeypatch.setattr(algo, "_minibatch_update", None)
        m = algo.update(ts, _to_torch(jtraj), torch.from_numpy(np.array(jadv)),
                        torch.from_numpy(np.array(jret)))
        if dtype == "bfloat16":
            np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=2e-3, atol=1e-5)
        changes[dtype] = {"actor": ts.actor.state_dict(), "critic": ts.critic.state_dict()}
    for net, name in (("actor", "actor_params"), ("critic", "critic_params")):
        start = flax_to_state_dict(jax.device_get(getattr(jts, name)))
        want = _change(flax_to_state_dict(jax.device_get(getattr(jts2, name))), start)
        bf16 = _distance(_change(changes["bfloat16"][net], start), want)
        f32 = _distance(_change(changes["float32"][net], start), want)
        print(f"{net}: bf16 {bf16:.4f}, f32 {f32:.4f}")
        assert bf16 < 0.02 < f32, (net, bf16, f32)


def _jax_update(jalgo, jts):
    """JAX's sampled rollout and its update (compiled with excess precision
    off), from ``jts``: returns (trajectory, advantages, returns, the
    updated state)."""
    jtraj = jax.jit(lambda t, k: jalgo.rollout(t, k, 2))(jts, jax.random.PRNGKey(3))
    jadv, jret = jalgo.compute_returns(jts, jtraj)
    args = (jts, jax.random.PRNGKey(4), jtraj, jadv, jret)
    jts2, _ = jax.jit(jalgo.update).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)
    return jtraj, jadv, jret, jts2


# the updates whose bf16 critic runs the chunked K2b or K4u on the card:
# (the port's config, JAX's); the recurrent one with 4-step chunks of the
# 8-step episode and no update chunks (JAX and the port refuse them there)
RECURRENT = dict(fused_loss="off", use_recurrent_policy=True, data_chunk_length=4,
                 update_chunks=1)
WIDE_UPDATES = {
    "fused-loss-off": (dict(fused_loss="off"), dict(fused_loss="off")),
    "unfolded": (dict(fused_fold=False), dict(fused_fold=False)),
    "recurrent": (RECURRENT, RECURRENT),
}


@pytest.mark.parametrize("case", list(WIDE_UPDATES))
def test_wide_chunked_kernel_updates_match_jax(case):
    """The preset's bf16 update with the fused loss off (K2b on the 4,840-wide
    critic rows, 4 update chunks with remat), unfolded (K4u) or recurrent
    (K2b): the port's plain versions give JAX's interpreted kernels'
    parameter change within a relative L2 distance of 0.02 per network, the
    port's f32 update lies outside it. Measured on the CPU: at most 7e-4
    but for the recurrent critic, 0.0172 (f32 0.134), nine tenths of it in
    layer 0's 4,840 x 256 weight, whose gradient reaches it through the GRU
    as well."""
    over, jover = WIDE_UPDATES[case]
    jalgo = _jax("bfloat16", **jover)
    jts = jalgo.init_state(jax.random.PRNGKey(0))
    jtraj, jadv, jret, jts2 = _jax_update(jalgo, jts)
    changes = {}
    for dtype in ("bfloat16", "float32"):
        algo, ts = _port(jts, dtype, **over)
        if dtype == "bfloat16":  # the path whose critic runs K2b / K4u on the card
            assert algo.fused_loss == (case == "unfolded") and algo.fused_trunk
            assert algo.recurrent == (case == "recurrent")
            assert algo.cfg.fused_fold == (case != "unfolded")
        algo.update(ts, _to_torch(jtraj), torch.from_numpy(np.array(jadv)),
                    torch.from_numpy(np.array(jret)))
        changes[dtype] = {"actor": ts.actor.state_dict(), "critic": ts.critic.state_dict()}
    for net, name in (("actor", "actor_params"), ("critic", "critic_params")):
        start = flax_to_state_dict(jax.device_get(getattr(jts, name)))
        want = _change(flax_to_state_dict(jax.device_get(getattr(jts2, name))), start)
        bf16 = _distance(_change(changes["bfloat16"][net], start), want)
        f32 = _distance(_change(changes["float32"][net], start), want)
        print(f"{case} {net}: bf16 {bf16:.4f}, f32 {f32:.4f}")
        assert bf16 < 0.02 < f32, (case, net, bf16, f32)


def _layer0_cotangent(monkeypatch, d_in):
    """Keep the operands of the plain K4's layer-0 weight product
    (``_mm(a.t(), g)``, the one whose left operand has ``d_in`` rows)."""
    seen, mm = [], FP._mm

    def spy(a, b, bf16):
        if a.shape[0] == d_in:
            seen.append(b)
        return mm(a, b, bf16)

    monkeypatch.setattr(FP, "_mm", spy)
    return seen


@pytest.mark.parametrize("use_fn,use_relu", [(True, True), (False, False)])
def test_split_plain_equals_one_pass(monkeypatch, use_fn, use_relu):
    """The chunked K4's split: the dV0 kernel's plain version, fed the rows'
    statistics and layer 0's bf16 cotangent, gives the one-pass plain K4's
    layer-0 dV at the preset's critic width to the bit (the same product on
    the same bf16 operands)."""
    rng = np.random.default_rng(7)
    rows, d_in, hidden = 40, 4840, 256
    t = lambda *s, scale=1.0: torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32))
    x = t(rows, d_in).to(torch.bfloat16)
    kp = [t(d_in, hidden, scale=d_in ** -0.5), t(hidden, scale=0.1),
          t(hidden, hidden, scale=hidden ** -0.5), t(hidden, scale=0.1)]
    aux = FP.pack_critic_aux(t(rows, 1), t(rows, 1))
    kw = dict(n_layers=2, use_fn=use_fn, use_relu=use_relu, bf16=True, clip_param=0.2,
              huber_delta=10.0, use_huber=True, use_clipped=True)
    norm = torch.tensor([0.1, 1.3])
    seen = _layer0_cotangent(monkeypatch, d_in)
    one = FP.critic_grads_plain(x, aux, norm, kp, t(hidden, 1, scale=0.1), t(1, scale=0.1),
                                **kw)
    (g0,) = seen
    dv0 = FM.dv0_plain(x, FM.input_stats(x, use_fn), bf16_round(g0), hidden)
    assert torch.equal(dv0, one[0][0])
    assert float(dv0.abs().max()) > 0


def _wide_trunk(rng, rows, use_fn, use_relu):
    """4,840-wide bf16 rows, the preset's critic trunk (hidden 256, two
    layers; the feature norm and relu, or neither and tanh) with its biases
    and LN affines off their init values, a cotangent of its output, and
    the bf16 W_0 as the kernels read it."""
    d_in, hidden = 4840, 256
    t = lambda *s, scale=1.0: torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32))
    x = t(rows, d_in).to(torch.bfloat16)
    params = [1 + t(d_in, scale=0.1), t(d_in, scale=0.1)] if use_fn else []
    for d in (d_in, hidden):
        params += [t(d, hidden, scale=d ** -0.5), t(hidden, scale=0.1), 1 + t(hidden, scale=0.1),
                   t(hidden, scale=0.1)]
    w0 = params[2 if use_fn else 0]
    w0b = FM.pack_mma_weights([w0], "cpu")[0].view(FM.pad16(d_in), FM.pad16(hidden))
    return x, params, t(rows, hidden), w0b


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        rel = float((g.float() - w.float()).norm() / w.float().norm().clamp_min(1e-30))
        assert rel <= 1e-6, (i, rel)


@pytest.mark.parametrize("use_fn,use_relu", [(True, True), (False, False)])
@pytest.mark.parametrize("rows", [1, 37, 2400])
def test_chunked_trunk_backward_split_equals_one_pass(rows, use_fn, use_relu):
    """The chunked K2b's split at the preset's critic width: the chain to
    layer 0's cotangent (``trunk_bwd_chunked_plain``), then the layer-0
    input backward (dx and the feature norm's gradients) and dV0 with the
    feature norm's affine, gives ``trunk_backward_plain``'s dx and every
    gradient within 1e-6 relative."""
    rng = np.random.default_rng(rows + 2 * use_fn)
    x, params, g, w0b = _wide_trunk(rng, rows, use_fn, use_relu)
    kw = dict(n_layers=2, use_fn=use_fn, use_relu=use_relu, bf16=True)
    dx, want = FM.trunk_backward_plain(x, params, g, **kw)
    rest, g0, xstats = FM.trunk_bwd_chunked_plain(x, params, g, **kw)
    assert g0.dtype == torch.bfloat16 and xstats.shape == (rows, 2)
    fs = params[0] if use_fn else None
    dx2, dfs, dfb = FM.layer0_input_bwd_plain(x, xstats, g0, w0b, fs, 256)
    affine = (params[0], params[1]) if use_fn else None
    dw0 = FM.dv0_plain(x, xstats, g0, 256, affine)
    _assert_same([dx2, *([dfs, dfb] if use_fn else []), dw0, *rest], [dx, *want])
    assert float(dw0.abs().max()) > 0


@pytest.mark.parametrize("use_fn,use_relu", [(True, True), (False, False)])
@pytest.mark.parametrize("rows", [1, 37, 2400])
def test_chunked_critic_unfolded_split_equals_one_pass(rows, use_fn, use_relu):
    """The chunked K4u's split at the preset's critic width: its first launch
    (``critic_grads_unfolded_chunked_plain``: the loss, the head and the
    chain to layer 0's cotangent), then the layer-0 input backward without
    dx and dV0 with the affine, gives ``critic_grads_unfolded_plain``
    within 1e-6 relative."""
    rng = np.random.default_rng(rows + 2 * use_fn + 1)
    x, params, _, w0b = _wide_trunk(rng, rows, use_fn, use_relu)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    vpred = t(rows, 1)
    aux = FP.pack_critic_aux(vpred, vpred + 3.0 * t(rows, 1))
    wv, bv, norm = 0.1 * t(256, 1), 0.1 * t(1), torch.tensor([0.5, 2.0])
    kw = dict(n_layers=2, use_fn=use_fn, use_relu=use_relu, bf16=True, clip_param=0.2,
              huber_delta=10.0, use_huber=True, use_clipped=True)
    tg, dwv, dbv, met = FP.critic_grads_unfolded_plain(x, aux, norm, params, wv, bv, **kw)
    rest, dwv2, dbv2, met2, g0, xstats = FP.critic_grads_unfolded_chunked_plain(
        x, aux, norm, params, wv, bv, **kw)
    fs = params[0] if use_fn else None
    dx, dfs, dfb = FM.layer0_input_bwd_plain(x, xstats, g0, w0b, fs, 256, need_dx=False)
    assert dx is None
    dw0 = FM.dv0_plain(x, xstats, g0, 256, (params[0], params[1]) if use_fn else None)
    _assert_same([*([dfs, dfb] if use_fn else []), dw0, *rest, dwv2, dbv2, met2],
                 [*tg, dwv, dbv, met])
