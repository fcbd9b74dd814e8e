"""The bf16 main path against the JAX package's at the default config's full
shape (16 envs, T = 150, hidden 256), where the learning gate's bf16 arm
runs it: the deterministic bf16 rollout (the fused trunk K2's plain version
against JAX's interpreted kernel) gives JAX's trajectory, the stored bf16
observations and the bf16 values within one bf16 step on fewer than 1 % of
their elements (f32 rounding-order differences of the env that land on a
bf16 rounding boundary; the 16 envs are identical here, so one step is
16 values: measured 16 of 2,416 values and 64 of 1,063,040 observations),
everything else within 1e-4; and the fused-loss
update (K3 / K4's plain versions against JAX's interpreted kernels, 3
epochs) gives JAX's parameter change within a relative L2 distance of 0.02,
where the same update in f32 lies outside it (measured: 0.008 / 0.0007 for
the actor / critic in bf16, 0.088 / 0.054 for f32 against bf16). JAX's bf16
update is compiled with ``xla_allow_excess_precision`` off, which keeps its
bf16 roundings (tests/test_torch_unfolded.py)."""

import functools

import jax
import numpy as np
import pytest
import torch

from dcc_tpu.algos import MAPPO as JMAPPO
from dcc_tpu.algos import MAPPOConfig as JMAPPOConfig
from dcc_tpu.envs import EnvConfig as JEnvConfig
from dcc_tpu_torch.algos import MAPPO, MAPPOConfig, Trajectory
from dcc_tpu_torch.compat import flax_to_state_dict
from dcc_tpu_torch.envs import EnvConfig

FULL = dict(n_rollout_threads=16, episode_length=150, ppo_epoch=3, n_iters=200)


def _jax(compute_dtype):
    kernels = "interpret" if compute_dtype == "bfloat16" else "off"
    return JMAPPO(JMAPPOConfig(fused_loss=kernels, fused_trunk=kernels, gae_backend="xla",
                               compute_dtype=compute_dtype, **FULL), JEnvConfig())


def _port(jts, compute_dtype):
    bf16 = compute_dtype == "bfloat16"
    algo = MAPPO(MAPPOConfig(fused_loss="on" if bf16 else "off",
                             fused_trunk="on" if bf16 else "off",
                             compute_dtype=compute_dtype, **FULL), EnvConfig(), device="cpu")
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


def test_bf16_rollout_matches_jax():
    jalgo, jts = _jax_start()
    algo, ts = _port(jts, "bfloat16")
    jtraj = jax.jit(lambda t, k: jalgo.rollout(t, k, 16, deterministic=True))(
        jts, jax.random.PRNGKey(1))
    traj = algo.rollout(ts, 16, deterministic=True)
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


def test_bf16_fused_update_matches_jax():
    jalgo, jts = _jax_start()
    jtraj = jax.jit(lambda t, k: jalgo.rollout(t, k, 16))(jts, jax.random.PRNGKey(3))
    jadv, jret = jalgo.compute_returns(jts, jtraj)
    args = (jts, jax.random.PRNGKey(4), jtraj, jadv, jret)
    jts2, jm = jax.jit(jalgo.update).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)
    changes = {}
    for dtype in ("bfloat16", "float32"):
        algo, ts = _port(jts, dtype)
        m = algo.update(ts, _to_torch(jtraj), torch.from_numpy(np.array(jadv)),
                        torch.from_numpy(np.array(jret)))
        if dtype == "bfloat16":
            np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=2e-3, atol=1e-5)
        changes[dtype] = {net: net_params for net, net_params in
                          (("actor", ts.actor.state_dict()), ("critic", ts.critic.state_dict()))}
    for net, name in (("actor", "actor_params"), ("critic", "critic_params")):
        start = flax_to_state_dict(jax.device_get(getattr(jts, name)))
        want = _change(flax_to_state_dict(jax.device_get(getattr(jts2, name))), start)
        bf16 = _distance(_change(changes["bfloat16"][net], start), want)
        f32 = _distance(_change(changes["float32"][net], start), want)
        print(f"{net}: bf16 {bf16:.4f}, f32 {f32:.4f}")
        assert bf16 < 0.02 < f32, (net, bf16, f32)


if __name__ == "__main__":
    pytest.main([__file__, "-s", "-q"])
