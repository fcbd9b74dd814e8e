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
port's. And the plain version of the chunked K4's second launch (dV0 from
layer 0's bf16 cotangent and the rows' statistics, ``dv0_plain``) equals
the one-pass plain K4's layer-0 dV."""

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
from dcc_tpu_torch.ops import fused_ppo as FP
from dcc_tpu_torch.ops.fused_mlp import bf16_round

PRESET = "20uav_16k_dist"
SMALL = {"n_rollout_threads": 2, "max_ep_len": 8, "ppo_epoch": 2}
KERNELS = dict(fused_loss="on", fused_trunk="on")


def _jax(compute_dtype):
    _, jenv, jcfg = j_load_preset(PRESET, overrides=SMALL)
    kernels = "interpret" if compute_dtype == "bfloat16" else "off"
    return JMAPPO(jcfg._replace(fused_loss=kernels, fused_trunk=kernels, gae_backend="xla",
                                compute_dtype=compute_dtype), jenv)


def _port(jts, compute_dtype):
    _, env_cfg, cfg = load_preset(PRESET, overrides=SMALL)
    bf16 = compute_dtype == "bfloat16"
    cfg = cfg._replace(compute_dtype=compute_dtype, **(KERNELS if bf16 else
                                                       dict(fused_loss="off",
                                                            fused_trunk="off")))
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
    dv0 = FP.dv0_plain(x, FP.input_stats(x, use_fn), bf16_round(g0), hidden)
    assert torch.equal(dv0, one[0][0])
    assert float(dv0.abs().max()) > 0
