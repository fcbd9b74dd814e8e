"""Separated per-agent MAPPO (``share_policy=False``) against
``dcc_tpu.algos.MAPPO``'s, from identical converted per-agent parameters, at
4 UAVs, 20 PoIs, E = A = 4 envs, T = 8 steps, hidden 32 and 2 epochs.

Each agent owns an actor, a critic, two Adams and a ValueNorm or PopArt
state (JAX stacks them with a leading agent axis; the port keeps one state
per agent, ``TrainState.agents``, converted by
``compat.stacked_flax_to_state_dicts`` and ``compat.unstack_states``). As in
JAX, the fused trunk and the fused loss are off and forcing either raises;
unlike JAX, whose scan takes the per-agent values, the GAE kernel K1 runs
on their (env, agent) columns. A deterministic rollout gives JAX's per-agent
values (T+1, E, A, 1) and log-probs, feed-forward and recurrent;
``compute_returns`` JAX's returns with per-agent normalizers at E == A,
where a missing agent axis would pair the masks' env axis with the values'
agent axis. Stacked parameters and normalizer states convert both ways; a
checkpoint resumes training exactly; the Learner refuses to render a
separated policy; the CLI trains one. The update against JAX's is
``tests/test_torch_separated_update.py``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from dcc_tpu.algos import MAPPO as JMAPPO
from dcc_tpu.algos import MAPPOConfig as JMAPPOConfig
from dcc_tpu.envs import EnvConfig as JEnvConfig
from dcc_tpu.models import valuenorm as JVN
from dcc_tpu_torch import train
from dcc_tpu_torch.algos import MAPPO, MAPPOConfig, Trajectory
from dcc_tpu_torch.compat import (stack_states, stacked_flax_to_state_dicts,
                                  state_dicts_to_stacked_flax, unstack_states)
from dcc_tpu_torch.envs import EnvConfig
from dcc_tpu_torch.models import popart as PA
from dcc_tpu_torch.models import valuenorm as VN
from dcc_tpu_torch.runtime import checkpoint as ckpt
from dcc_tpu_torch.runtime.learner import Learner
from test_torch_cuda import pretend_cuda

SMALL = dict(n_rollout_threads=4, episode_length=8, ppo_epoch=2, n_iters=5, hidden_size=32,
             share_policy=False)
RECURRENT = dict(use_recurrent_policy=True, data_chunk_length=4)


def _pair(compute_dtype="float32", **kw):
    jalgo = JMAPPO(JMAPPOConfig(gae_backend="xla", compute_dtype=compute_dtype, **SMALL, **kw),
                   JEnvConfig())
    jts = jalgo.init_state(jax.random.PRNGKey(0))
    algo = MAPPO(MAPPOConfig(compute_dtype=compute_dtype, **SMALL, **kw), EnvConfig(),
                 device="cpu")
    actor, critic = algo.make_networks()
    for nets, jparams in ((actor, jts.actor_params), (critic, jts.critic_params)):
        for net, sd in zip(nets, stacked_flax_to_state_dicts(jax.device_get(jparams))):
            net.load_state_dict(sd)
    return jalgo, jts, algo, algo.init_state(actor=actor, critic=critic)


def nets(ts, name):
    """Every agent's ``name`` ("actor", "critic", "vnorm", "popart")."""
    return [getattr(a, name) for a in ts.agents]


def _to_torch(jtraj):
    return Trajectory(*(None if getattr(jtraj, f) is None
                        else torch.from_numpy(np.array(getattr(jtraj, f), np.float32))
                        for f in Trajectory._fields))


@functools.lru_cache(maxsize=None)
def _jax_rollout(recurrent: bool):
    """JAX's sampled rollout of the seed-0 per-agent networks, shared by the
    update tests of one policy kind (the other options change only the
    update)."""
    kw = RECURRENT if recurrent else {}
    jalgo = JMAPPO(JMAPPOConfig(gae_backend="xla", **SMALL, **kw), JEnvConfig())
    return jax.jit(lambda ts, k: jalgo.rollout(ts, k, 4))(
        jalgo.init_state(jax.random.PRNGKey(0)), jax.random.PRNGKey(3))


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(compute_dtype="bfloat16"), dict(use_recurrent_policy=True),
     dict(compute_dtype="bfloat16", use_naive_recurrent=True)],
    ids=["f32", "bf16", "recurrent", "naive-bf16"],
)
def test_dispatch_launches_no_kernel_on_cuda(monkeypatch, kw):
    """JAX's dispatch on a pretended CUDA device: "auto" resolves the fused
    trunk and the fused loss off under separated policies, so that no
    kernel but K1 launches; K1 is on (JAX keeps its scan there)."""
    pretend_cuda(monkeypatch)
    algo = MAPPO(MAPPOConfig(share_policy=False, **kw), EnvConfig(), device="cuda")
    assert algo.separated
    assert (algo.fused_trunk, algo.fused_loss, algo.gae_kernel) == (False, False, True)


@pytest.mark.parametrize(
    "kw,exc,match",
    [(dict(fused_trunk="on"), ValueError, "share_policy"),
     (dict(fused_loss="on"), ValueError, "separated"),
     (dict(update_chunks=4), NotImplementedError, "update_chunks")],
    ids=["fused-trunk-on", "fused-loss-on", "update-chunks"],
)
def test_forced_kernels_and_chunks_raise(monkeypatch, kw, exc, match):
    """Forcing a kernel must not silently do nothing, and gradient
    accumulation has no separated path (JAX's messages)."""
    pretend_cuda(monkeypatch)
    with pytest.raises(exc, match=match):
        MAPPO(MAPPOConfig(share_policy=False, **kw), EnvConfig(), device="cuda")


@pytest.mark.parametrize("kw", [dict(), RECURRENT], ids=["ff", "recurrent"])
def test_deterministic_rollout_matches_jax(kw):
    jalgo, jts, algo, ts = _pair(**kw)
    jtraj = jax.jit(lambda t, k: jalgo.rollout(t, k, 4, deterministic=True))(
        jts, jax.random.PRNGKey(1))
    traj = algo.rollout(ts, 4, deterministic=True)
    assert traj.values.shape == (9, 4, 4, 1)
    fields = Trajectory._fields[:8] + (("actor_h", "critic_h") if kw else ())
    if kw:
        assert traj.actor_h.shape == traj.critic_h.shape == (8, 4, 4, 1, 32)
    for f in fields:
        np.testing.assert_allclose(getattr(traj, f).float().numpy(),
                                   np.asarray(getattr(jtraj, f), np.float32),
                                   atol=1e-4, err_msg=f)


@pytest.mark.parametrize("use_gae", [True, False], ids=["gae", "discounted"])
def test_compute_returns_matches_jax_at_e_equal_a(use_gae):
    """E == A == 4, with a different ValueNorm state per agent."""
    jalgo, jts, algo, ts = _pair(use_gae=use_gae)
    jtraj = _jax_rollout(False)
    ret0 = np.random.default_rng(0).normal(size=(4, 8, 4, 1)).astype(np.float32)
    ret0 = ret0 * np.arange(1, 5, dtype=np.float32)[:, None, None, None] * 3 + 2
    jts = jts.replace(vnorm=jax.vmap(JVN.update)(jts.vnorm, ret0))
    for a, st in zip(ts.agents, unstack_states(jts.vnorm, VN.ValueNormState)):
        a.vnorm = st
    jadv, jret = jalgo.compute_returns(jts, jtraj)
    adv, ret = algo.compute_returns(ts, _to_torch(jtraj))
    assert adv.shape == ret.shape == (8, 4, 4, 1)
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=1e-5, atol=1e-4)


def test_gae_kernel_takes_agent_columns(monkeypatch):
    """Separated runs take K1 on CUDA, and forcing it ("pallas") runs its
    wrapper on any device: on the CPU its plain version, which gives JAX's
    advantages at E == A (``tests/test_torch_cuda.py`` holds the kernel on
    this layout)."""
    pretend_cuda(monkeypatch)
    assert MAPPO(MAPPOConfig(share_policy=False), EnvConfig(), device="cuda").gae_kernel
    monkeypatch.undo()
    jalgo, jts, _, ts = _pair()
    algo = MAPPO(MAPPOConfig(gae_backend="pallas", **SMALL), EnvConfig(), device="cpu")
    assert algo.gae_kernel
    jtraj = _jax_rollout(False)
    jadv, jret = jalgo.compute_returns(jts, jtraj)
    adv, ret = algo.compute_returns(ts, _to_torch(jtraj))
    assert adv.shape == ret.shape == (8, 4, 4, 1)
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=1e-5, atol=1e-4)


def test_stacked_conversion_round_trip():
    """JAX's stacked per-agent parameters and normalizer states to the
    port's per-agent ones and back give JAX's arrays."""
    _, jts, _, ts = _pair(use_popart=True, use_valuenorm=False)
    for name, jparams in (("actor", jts.actor_params), ("critic", jts.critic_params)):
        back = state_dicts_to_stacked_flax([m.state_dict() for m in nets(ts, name)])
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
                               back, jax.device_get(jparams))
    for k, v in stack_states(unstack_states(jts.popart, PA.PopArtState)).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jts.popart, k)), err_msg=k)


def test_checkpoint_round_trip(tmp_path):
    """Per-agent networks, optimizers and PopArt states, the counters and
    the generator survive a save and a load: training resumes exactly."""
    cfg = MAPPOConfig(use_popart=True, use_valuenorm=False, **SMALL)
    algo = MAPPO(cfg, EnvConfig(), device="cpu")
    ts = algo.init_state(seed=0)
    algo.train_iteration(ts)
    ckpt.save(str(tmp_path / "sep.pt"), ts)
    resumed = ckpt.load(str(tmp_path / "sep.pt"), algo.init_state(seed=7))
    assert (resumed.update_count, resumed.iteration) == (ts.update_count, ts.iteration) == (2, 1)
    assert all(isinstance(p, PA.PopArtState) for p in nets(resumed, "popart"))
    for name in ("actor", "critic"):
        for a, b in zip(nets(ts, name), nets(resumed, name)):
            for k, v in a.state_dict().items():
                assert torch.equal(v, b.state_dict()[k]), k
    np.testing.assert_array_equal(algo.train_iteration(resumed), algo.train_iteration(ts))


def test_learner_refuses_render():
    """JAX renders a separated policy with one actor and fails; the port
    refuses the combination at construction."""
    with pytest.raises(ValueError, match="ScopeParamShapeError"):
        Learner({"use_separated_policy": True, "save_gifs": True, "save_model": True},
                device="cpu")


def test_cli_trains_on_cpu():
    learner = train.main(["--device", "cpu", "--use-separated-policy", "true", "--n-iters", "1",
                          "--n-rollout-threads", "2", "--save-gifs", "false", "--save-model",
                          "false", "--max-ep-len", "20", "--ppo-epoch", "2",
                          "--algo-hidden-size", "32", "--n-eval-rollout-threads", "2",
                          "--eval-interval", "1"])
    assert learner.algo.separated and learner.ts.iteration == 1
    assert len(learner.ts.agents) == 4 and learner.ts.update_count == 2
    assert all(np.isfinite(v) for v in learner.last_metrics)
