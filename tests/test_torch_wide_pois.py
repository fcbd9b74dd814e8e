"""The many-PoI swarm's bf16 path (the default env with 300 PoIs: 4 UAVs,
actor rows 1,510 wide, team-concat critic rows 6,040 wide, hidden 256, two
layers, bf16) against the JAX package's on the CPU, at 2 envs, an 8-step
episode and 2 epochs (the widths intact; the scale cut for the CPU). On the
card these rows take the chunked bf16 kernels: K2 on the critic's rows
(past the staged tile's 5,632 columns), K3 and K3u on the actor's (past
1,472 and 1,088), K4, K4u and K2b on the critic's. Here the port runs their
plain versions, JAX its interpreted Pallas kernels, compiled with
``xla_allow_excess_precision`` off (as tests/test_torch_wide.py):

- the deterministic rollout (K2 on the actor's and the critic's rows) gives
  JAX's trajectory, the stored bf16 observations and bf16 values within
  one bf16 step on fewer than 1 % of their elements and everything else
  within 1e-4;
- one fused update, folded (K3 / K4) and unfolded (K3u / K4u), gives JAX's
  parameter change within a relative L2 distance of 0.02 per network,
  where the same update in f32 lies outside it.

And the plain split of each new chunked mode equals its one-pass plain
version within 1e-6 relative: the chunked K2 forward (the rows' statistics,
then layer 0 on the operand they give, then the rest) at the critic widths
6,040 and 5,840 (the 20-UAV preset with 50 PoIs), and the chunked K3 and
K3u (their first launch, then dV0, and for K3u the layer-0 input backward)
at 1,510."""

import functools

import jax
import numpy as np
import pytest
import torch

from dcc_tpu.algos import MAPPO as JMAPPO
from dcc_tpu.configs import load as j_load
from dcc_tpu_torch.algos import MAPPO, Trajectory
from dcc_tpu_torch.compat import flax_to_state_dict
from dcc_tpu_torch.configs import load
from dcc_tpu_torch.ops import fused_mlp as FM
from dcc_tpu_torch.ops import fused_ppo as FP

SMALL = {"num_pois": 300, "n_rollout_threads": 2, "max_ep_len": 8, "ppo_epoch": 2}
KERNELS = dict(fused_loss="on", fused_trunk="on")
ACTOR_W, CRITIC_W, HIDDEN = 1510, 6040, 256


def _jax(compute_dtype, **over):
    """JAX's MAPPO on the cut config, its kernels interpreted in bf16 (off in
    f32), with the config fields ``over`` set."""
    _, jenv, jcfg = j_load(overrides=SMALL)
    kernels = "interpret" if compute_dtype == "bfloat16" else "off"
    return JMAPPO(jcfg._replace(**{**dict(fused_loss=kernels, fused_trunk=kernels,
                                          gae_backend="xla", compute_dtype=compute_dtype),
                                   **over}), jenv)


def _port(jts, compute_dtype, **over):
    """The port's MAPPO from JAX's state ``jts``: bf16 through the kernels'
    plain versions (``KERNELS``, then ``over``), f32 without them."""
    _, env_cfg, cfg = load(overrides=SMALL)
    bf16 = compute_dtype == "bfloat16"
    kernels = KERNELS if bf16 else dict(fused_loss="off", fused_trunk="off")
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


def test_pois_widths():
    _, env_cfg, cfg = load(overrides=SMALL)
    assert (env_cfg.n_agents, env_cfg.n_pois) == (4, 300)
    assert (env_cfg.obs_dim, env_cfg.share_obs_dim) == (ACTOR_W, CRITIC_W)
    assert (cfg.hidden_size, cfg.layer_n + 1) == (HIDDEN, 2)


def test_pois_rollout_matches_jax():
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


@functools.lru_cache(maxsize=None)
def _jax_rollout():
    """JAX's sampled rollout from the start state, and its returns."""
    jalgo, jts = _jax_start()
    jtraj = jax.jit(lambda t, k: jalgo.rollout(t, k, 2))(jts, jax.random.PRNGKey(3))
    jadv, jret = jalgo.compute_returns(jts, jtraj)
    return jtraj, jadv, jret


@pytest.mark.parametrize("fold", [True, False], ids=["folded", "unfolded"])
def test_pois_fused_update_matches_jax(fold):
    """One fused bf16 update, folded (K3 / K4) or unfolded (K3u / K4u): the
    port's plain versions give the parameter change of JAX's interpreted
    kernels within a relative L2 distance of 0.02 per network; the port's
    f32 update lies outside it."""
    _, jts = _jax_start()
    jalgo = _jax("bfloat16", fused_fold=fold)
    jtraj, jadv, jret = _jax_rollout()
    args = (jts, jax.random.PRNGKey(4), jtraj, jadv, jret)
    jts2, jm = jax.jit(jalgo.update).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)
    changes = {}
    for dtype in ("bfloat16", "float32"):
        algo, ts = _port(jts, dtype, fused_fold=fold)
        if dtype == "bfloat16":
            assert algo.fused_loss and algo.cfg.fused_fold == fold
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
        print(f"{'folded' if fold else 'unfolded'} {net}: bf16 {bf16:.4f}, f32 {f32:.4f}")
        assert bf16 < 0.02 < f32, (fold, net, bf16, f32)


def _tensor(rng):
    return lambda *s, scale=1.0: torch.from_numpy(
        (scale * rng.standard_normal(s)).astype(np.float32))


def _trunk(rng, d_in, use_fn):
    """The flat trunk list at ``d_in`` (hidden 256, two layers), its biases
    and LN affines off their init values."""
    t = _tensor(rng)
    params = [1 + t(d_in, scale=0.1), t(d_in, scale=0.1)] if use_fn else []
    for d in (d_in, HIDDEN):
        params += [t(d, HIDDEN, scale=d ** -0.5), t(HIDDEN, scale=0.1),
                   1 + t(HIDDEN, scale=0.1), t(HIDDEN, scale=0.1)]
    return params


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        rel = float((g.float() - w.float()).norm() / w.float().norm().clamp_min(1e-30))
        assert rel <= 1e-6, (i, rel)


# The plain splits, as the chunked kernels split the work; the package runs
# the one-pass plain versions on the CPU, so these live here.
def _trunk_forward_split(x, params, n_layers, use_fn, use_relu, bf16):
    """The chunked K2's split: the rows' statistics (``input_stats``), layer 0
    on the operand they give, ``bf16((x - mu) * inv * fs + fb)`` (each step
    rounded on its own), then the later layers."""
    xstats = FM.input_stats(x, use_fn)
    a = (x.to(torch.float32) - xstats[:, :1]) * xstats[:, 1:]
    first = 0
    if use_fn:
        a, first = a * params[0] + params[1], 2
    a = FM.bf16_round(a) if bf16 else a
    w, b, s, c = params[first : first + 4]
    r = FM.activation(FM.dense(a, w, b, bf16), use_relu, bf16)
    mu, inv = FM.ln_stats(r)
    a = (r - mu) * inv * s + c
    a = FM.bf16_round(a) if bf16 else a
    if n_layers > 1:
        a, _, _ = FM._forward_chain(a, params[first + 4 :], n_layers - 1, False, use_relu, bf16)
    return a.to(torch.bfloat16) if bf16 else a


def _actor_split(x, aux, kp, whf, bhf, log_std, *, n_layers, use_fn, use_relu, bf16,
                 clip_param):
    """The chunked K3's first launch: the folded chain, the head and the
    backward down to layer 0's cotangent. Returns ([du_0, dV_1, du_1, ...],
    dWh', dbh', dlog_std, [loss_sum, ratio_sum], layer 0's bf16 cotangent
    g0, ``input_stats``); the dV0 kernel gives dV_0."""
    feat, cache = FP._fwd_folded(x, kp, n_layers, use_fn, use_relu, bf16)
    dwh, dbh, dls, met, g = FP._actor_head(feat, aux, whf, bhf, log_std, bf16, clip_param)
    g0, kg = FP._bwd_folded(g, cache, kp, n_layers, use_relu, bf16, to_layer0=True)
    return kg[1:], dwh, dbh, dls, met, g0.to(torch.bfloat16), FM.input_stats(x, use_fn)


def _actor_unfolded_split(x, aux, params, wh, bh, log_std, *, n_layers, use_fn, use_relu,
                          bf16, clip_param):
    """The chunked K3u's first launch: the unfolded chain, the head and the
    backward down to layer 0's cotangent. Returns (the trunk gradients from
    layer 0's bias on, dWh, dbh, dlog_std, [loss_sum, ratio_sum], g0,
    ``input_stats``); the dV0 kernel (affine mode) and the layer-0 input
    backward give the rest."""
    feat, fn_cache, layers = FM._forward_chain(x, params, n_layers, use_fn, use_relu, bf16)
    dwh, dbh, dls, met, g = FP._actor_head(feat, aux, wh, bh, log_std, bf16, clip_param)
    g0, tg = FM.trunk_bwd_chain(g, params, fn_cache, layers, n_layers, use_fn, use_relu, bf16,
                                to_layer0=True)
    first = 2 if use_fn else 0
    return (tg[first + 1:], dwh, dbh, dls, met, g0.to(torch.bfloat16),
            FM.input_stats(x, use_fn))


# the split's trunks: the feature norm with relu, and neither with tanh
TRUNKS = [(True, True), (False, False)]
ROWS = [1, 37, 2400]


@pytest.mark.parametrize("use_fn,use_relu", TRUNKS)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("d_in", [CRITIC_W, 5840])
def test_chunked_trunk_forward_split_equals_one_pass(d_in, rows, use_fn, use_relu):
    """The chunked K2's split (``_trunk_forward_split``: the rows'
    statistics, layer 0 on ``bf16((x - mu) * inv * fs + fb)``, the later
    layers) gives ``trunk_forward_plain`` within 1e-6 relative, on f32 rows
    as the rollout gives them."""
    rng = np.random.default_rng(rows + d_in + use_fn)
    x = _tensor(rng)(rows, d_in)
    params = _trunk(rng, d_in, use_fn)
    kw = dict(n_layers=2, use_fn=use_fn, use_relu=use_relu, bf16=True)
    got = _trunk_forward_split(x, params, **kw)
    assert got.dtype == torch.bfloat16
    _assert_same([got], [FM.trunk_forward_plain(x, params, **kw)])


def _actor_case(rng, rows):
    """bf16 actor rows at 1,510 and their aux: actions, old log-probs and
    advantages."""
    t = _tensor(rng)
    x = t(rows, ACTOR_W).to(torch.bfloat16)
    aux = FP.pack_actor_aux(0.5 * t(rows, 2), -2.0 + 0.3 * t(rows, 1), t(rows, 1))
    return x, aux, 0.1 * t(HIDDEN, 2), 0.1 * t(2), torch.tensor([-0.3, 0.2])


@pytest.mark.parametrize("use_fn,use_relu", TRUNKS)
@pytest.mark.parametrize("rows", ROWS)
def test_chunked_actor_split_equals_one_pass(rows, use_fn, use_relu):
    """The chunked K3's split at 1,510: its first launch
    (``_actor_split``: the loss, the Gaussian head and the
    folded chain to layer 0's cotangent), then dV0 from layer 0's bf16
    cotangent and the rows' statistics, gives ``actor_grads_plain`` within
    1e-6 relative."""
    rng = np.random.default_rng(rows + 2 * use_fn + 3)
    x, aux, wh, bh, log_std = _actor_case(rng, rows)
    kp, whf, bhf = FP.fold_trunk(_trunk(rng, ACTOR_W, use_fn), wh, bh, 2, use_fn)
    kw = dict(n_layers=2, use_fn=use_fn, use_relu=use_relu, bf16=True, clip_param=0.2)
    if rows == 1:  # keep the row's surrogate unclipped, so that its gradients flow
        ratio = float(FP.actor_grads_plain(x, aux, kp, whf, bhf, log_std, **kw)[4][1])
        aux[0, 3] = -aux[0, 3].abs() if ratio > 1.0 else aux[0, 3].abs()
    kg, dwh, dbh, dls, met = FP.actor_grads_plain(x, aux, kp, whf, bhf, log_std, **kw)
    rest, dwh2, dbh2, dls2, met2, g0, xstats = _actor_split(x, aux, kp, whf, bhf, log_std,
                                                            **kw)
    assert g0.dtype == torch.bfloat16 and xstats.shape == (rows, 2)
    dv0 = FM.dv0_plain(x, xstats, g0, HIDDEN)
    _assert_same([dv0, *rest, dwh2, dbh2, dls2, met2], [*kg, dwh, dbh, dls, met])
    assert float(dv0.abs().max()) > 0


@pytest.mark.parametrize("use_fn,use_relu", TRUNKS)
@pytest.mark.parametrize("rows", ROWS)
def test_chunked_actor_unfolded_split_equals_one_pass(rows, use_fn, use_relu):
    """The chunked K3u's split at 1,510: its first launch
    (``_actor_unfolded_split``), then the layer-0 input backward
    without dx and dV0 with the feature norm's affine, gives
    ``actor_grads_unfolded_plain`` within 1e-6 relative."""
    rng = np.random.default_rng(rows + 2 * use_fn + 5)
    x, aux, wh, bh, log_std = _actor_case(rng, rows)
    params = _trunk(rng, ACTOR_W, use_fn)
    kw = dict(n_layers=2, use_fn=use_fn, use_relu=use_relu, bf16=True, clip_param=0.2)
    tg, dwh, dbh, dls, met = FP.actor_grads_unfolded_plain(x, aux, params, wh, bh, log_std,
                                                           **kw)
    rest, dwh2, dbh2, dls2, met2, g0, xstats = _actor_unfolded_split(
        x, aux, params, wh, bh, log_std, **kw)
    w0 = params[2 if use_fn else 0]
    w0b = FM.pack_mma_weights([w0], "cpu")[0].view(FM.pad16(ACTOR_W), FM.pad16(HIDDEN))
    fs = params[0] if use_fn else None
    dx, dfs, dfb = FM.layer0_input_bwd_plain(x, xstats, g0, w0b, fs, HIDDEN, need_dx=False)
    assert dx is None
    dw0 = FM.dv0_plain(x, xstats, g0, HIDDEN, (params[0], params[1]) if use_fn else None)
    _assert_same([*([dfs, dfb] if use_fn else []), dw0, *rest, dwh2, dbh2, dls2, met2],
                 [*tg, dwh, dbh, dls, met])
