"""The port's data-parallel program (``MAPPO`` / ``MADDPG`` with a
``parallel.Mesh``) on 2 gloo ranks on the CPU, held as the JAX package's
mesh tests hold its own (tests/test_parallel.py:47-64,
tests/test_fused_mesh.py:72-91):

* every case of ``tests/torch_mesh_ranks.py``'s ``MAPPO_CASES``, 2
  iterations at 16 envs (8 a rank; the uneven case 15, 8 and 7), against
  the port's one-process run of the same case: reward within rtol 1e-4,
  value loss within 1e-3, parameters, normalizers and Adam moments within
  rtol 2e-4 / atol 2e-5 (tests/test_fused_mesh.py:62-70), the first
  step's all-reduced gradients within 1e-5 of the largest entry, the two
  ranks bit for bit, each rank's rollout its rows of the one-process
  rollout (a bf16 autograd case at the bf16 update's bound, below);
* MADDPG's sharded collection: the replicated buffer and the networks
  equal to the one-process run's;
* the slice against JAX: the port's fused f32 update (K1, K3 / K4 plain
  twins) on 2 ranks against ``dcc_tpu``'s ``_update_fused_full_sharded``
  on a 2-device mesh (interpreted kernels), from the same parameters (JAX's
  init) and trajectory (the port's rollout), at the same bounds;
* the dispatch rules raise where JAX's raise, with matching messages;
  where JAX's ``auto`` leaves a kernel, the port's keeps it (the
  ``kernels-*`` cases run those flags through the plain twins);
* C7: a rank-3 ``obs_shape`` makes ``MAPPO`` raise, naming ROADMAP A9.

One job of 2 ranks and the one-process reference (3 processes, a thread
each) runs every case, from a module fixture; the JAX side runs in this
process meanwhile, and the ranks take its inputs last."""

import os
import re
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from dcc_tpu.algos import MAPPO as JMAPPO
from dcc_tpu.algos import MAPPOConfig as JMAPPOConfig
from dcc_tpu.algos.mappo import Trajectory as JTrajectory
from dcc_tpu.algos.maddpg import MADDPG as JMADDPG
from dcc_tpu.algos.maddpg import MADDPGConfig as JMADDPGConfig
from dcc_tpu.envs import EnvConfig as JEnvConfig
from dcc_tpu.parallel import make_mesh as j_make_mesh
from dcc_tpu_torch.algos import MAPPO, MAPPOConfig, Trajectory
from dcc_tpu_torch.compat import flax_to_state_dict
from dcc_tpu_torch.envs import EnvConfig, get_scenario, register_scenario
from dcc_tpu_torch.parallel import make_mesh

RTOL, ATOL = 2e-4, 2e-5  # parameters (tests/test_fused_mesh.py:62-70)
# the first optimizer step's all-reduced gradients against one process's:
# only the f32 summation order of the rows differs (max |diff| over the
# largest |entry|, a tensor at a time)
GRAD_RTOL = 1e-5
# a bf16 case whose update runs autograd (no fused loss): its heads' weight
# gradients leave bf16 GEMMs rounded to bf16, a rank's rows apart from one
# process's, so its steps are held to the bf16 update's bound of
# chip_smoke.py (check_update_against_cpu: parameters 1e-3, metrics rtol
# 2e-3 / atol 3e-5), the trunk's gradients (K2b's plain twin, f32 sums) to
# GRAD_RTOL
BF16_PARAM, BF16_RTOL, BF16_ATOL = 1e-3, 2e-3, 3e-5
HEADS = ("act_out", "v_out")


def _jax_inputs(out_dir):
    """JAX's 2-device algorithm and its initial state, and a trajectory the
    port rolls out from the same parameters; writes the parameters and the
    trajectory for the ranks."""
    cfg = JMAPPOConfig(fused_loss="interpret", fused_trunk="off", gae_backend="xla", **R.SMALL)
    jalgo = JMAPPO(cfg, JEnvConfig(), mesh=j_make_mesh(jax.devices()[:2]))
    jts = jalgo.init_state(jax.random.PRNGKey(0))
    algo = MAPPO(MAPPOConfig(**R.JAX_CASE), EnvConfig(), device="cpu")
    actor, critic = algo.make_networks()
    blob = dict(actor=flax_to_state_dict(jax.device_get(jts.actor_params)),
                critic=flax_to_state_dict(jax.device_get(jts.critic_params)))
    actor.load_state_dict(blob["actor"])
    critic.load_state_dict(blob["critic"])
    traj = algo.rollout(algo.init_state(actor=actor, critic=critic),
                        R.SMALL["n_rollout_threads"])
    blob["traj"] = {f: getattr(traj, f).float() for f in Trajectory._fields
                    if getattr(traj, f) is not None}
    path = os.path.join(out_dir, "jax_in.pt")
    torch.save(blob, path + ".tmp")
    os.replace(path + ".tmp", path)  # the ranks wait for it to appear whole
    jtraj = JTrajectory(**{f: jax.numpy.asarray(v.numpy()) for f, v in blob["traj"].items()})
    return jalgo, jts, jtraj


def _jax_update(jalgo, jts, jtraj) -> dict:
    """JAX's sharded fused update (``_update_fused_full_sharded``)."""
    jadv, jret = jalgo.compute_returns(jts, jtraj)
    update = jax.jit(lambda ts, tr, a, r: jalgo.update(ts, jax.random.PRNGKey(4), tr, a, r))
    jts2, jm = update(jts, jtraj, jadv, jret)
    return dict(actor=flax_to_state_dict(jax.device_get(jts2.actor_params)),
                critic=flax_to_state_dict(jax.device_get(jts2.critic_params)),
                vnorm=[np.asarray(x) for x in jts2.vnorm[:3]], metrics=np.asarray(jm))


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh_job"))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(R.launch, "mesh", out, 2, True)
        jax_side = _jax_update(*_jax_inputs(out))
        ranks.result()
    load = lambda name: torch.load(os.path.join(out, f"mesh_{name}.pt"), weights_only=True)
    return dict(ref=load("ref"), ranks=[load(0), load(1)], jax=jax_side)


def _close(got: dict, want: dict, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(), want[k].float().numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


def _identical(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("case", list(R.MAPPO_CASES))
def test_mesh_matches_one_process(job, case):
    ref, r0, r1 = job["ref"][f"mappo/{case}"], *(r[f"mappo/{case}"] for r in job["ranks"])
    bf16_autograd = (R.MAPPO_CASES[case].get("compute_dtype") == "bfloat16"
                     and not ref["fused"][1])
    for k, g in ref["grads1"].items():
        if not (bf16_autograd and k.split(".")[2] in HEADS):
            gap = float((r0["grads1"][k] - g).abs().max() / g.abs().max().clamp_min(1e-30))
            assert gap <= GRAD_RTOL, (k, gap)
    for m_ref, m0 in zip(ref["metrics"], r0["metrics"]):
        np.testing.assert_allclose(m0[0], m_ref[0], rtol=1e-4)  # reward
        np.testing.assert_allclose(m0[2], m_ref[2], rtol=1e-3)  # value loss
        np.testing.assert_allclose(m0, m_ref, rtol=BF16_RTOL if bf16_autograd else 1e-3,
                                   atol=BF16_ATOL if bf16_autograd else 1e-5)
    if bf16_autograd:
        _close(r0["state"], ref["state"], rtol=0.0, atol=BF16_PARAM)
    else:
        _close(r0["state"], ref["state"])
    assert r0["update_count"] == ref["update_count"]
    assert r0["fused"] == ref["fused"]
    if R.MAPPO_CASES[case].get("kernels"):
        assert r0["fused"] == (True, "recurrent" not in case)
    # the ranks took the same steps, bit for bit
    _identical(r0["state"], r1["state"])
    assert r0["metrics"] == r1["metrics"]
    # each rank rolled out its block of the envs, the draws those of all
    # (the networks' f32 products on the CPU round by the row count: 1e-5)
    n = R.MAPPO_CASES[case].get("n_rollout_threads", R.SMALL["n_rollout_threads"])
    assert (r0["rollout"]["actions"].shape[1], r1["rollout"]["actions"].shape[1]) == \
        (n - n // 2, n // 2)
    for f, full in ref["rollout"].items():
        np.testing.assert_allclose(torch.cat([r0["rollout"][f], r1["rollout"][f]], dim=1),
                                   full, rtol=1e-5, atol=1e-5, err_msg=f)


def test_maddpg_mesh_matches_one_process(job):
    """The replicated buffer holds the one-process run's transitions in
    global env order, and the update, run on every rank alike, gives its
    networks (JAX's test_maddpg_mesh_matches_single_device,
    tests/test_parallel.py:84-127)."""
    ref, r0, r1 = job["ref"]["maddpg"], *(r["maddpg"] for r in job["ranks"])
    assert (r0["farm_rows"], r1["farm_rows"], ref["farm_rows"]) == (8, 8, 16)
    _identical(r0["buffer"], ref["buffer"])
    _identical(r0["buffer"], r1["buffer"])
    _identical(r0["state"], r1["state"])
    _close(r0["state"], ref["state"], rtol=1e-5, atol=1e-6)
    for m_ref, m0 in zip(ref["metrics"], r0["metrics"]):
        for k in m_ref:
            np.testing.assert_allclose(m0[k], m_ref[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_fused_update_matches_jax_sharded(job):
    """The port's 2-rank fused update against JAX's 2-device
    ``_update_fused_full_sharded``: parameters, the value normalizer and
    the metrics."""
    want = job["jax"]
    r0, r1 = (r["jax"] for r in job["ranks"])
    assert r0["local_envs"] == r1["local_envs"] == R.SMALL["n_rollout_threads"] // 2
    for net in ("actor", "critic"):
        _close(r0[net], want[net])
        _identical(r0[net], r1[net])
    for got, w in zip(r0["vnorm"], want["vnorm"]):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(r0["metrics"].numpy(), want["metrics"], rtol=1e-3, atol=1e-5)
    assert torch.equal(r0["metrics"], r1["metrics"])


# where each rule raises: JAX's and the port's messages both match
RULE_MATCH = {"fused-loss-nmb2": "num_mini_batch", "fused-loss-15": "divisible",
              "fused-trunk-15": "divisible", "gae-kernel-15": "divisible",
              "maddpg-15": "must divide"}


def _jax_rule(name):
    mesh = j_make_mesh(jax.devices()[:2])
    if name == "maddpg-15":
        JMADDPG(JMADDPGConfig(**{**R.MADDPG_CASE, "n_envs": 15}), JEnvConfig(), mesh=mesh)
        return
    cfg = JMAPPOConfig(**{**R.SMALL, "episode_length": 4, **R.RULES[name]})
    jalgo = JMAPPO(cfg, JEnvConfig(), mesh=mesh)
    jts = jalgo.init_state(jax.random.PRNGKey(0))
    # the fields compute_returns reads, of T = 4 steps of the envs
    T, E = cfg.episode_length, cfg.n_rollout_threads
    z = lambda *shape: jax.numpy.zeros(shape, jax.numpy.float32)
    traj = JTrajectory(obs=None, actions=None, log_probs=None, values=z(T + 1, E, 1),
                       rewards=z(T, E, 1), masks=z(T + 1, E, 1) + 1.0, coverage=None)
    jalgo.compute_returns(jts, traj)


@pytest.mark.parametrize("name", list(RULE_MATCH))
def test_dispatch_rules_raise_as_jax(job, name):
    with pytest.raises(ValueError, match=RULE_MATCH[name]):
        _jax_rule(name)
    for rank in job["ranks"]:
        kind, msg = rank["rules"][name]
        assert kind == "ValueError" and re.search(RULE_MATCH[name], msg), msg


@pytest.mark.parametrize("kw", [dict(num_mini_batch=2), dict(n_rollout_threads=15),
                                dict(use_recurrent_policy=True, data_chunk_length=5)],
                         ids=["nmb2", "uneven-15", "recurrent"])
def test_auto_keeps_every_kernel_on_a_mesh(monkeypatch, kw):
    """Where JAX's ``auto`` leaves a kernel under a mesh (minibatches, an
    env count that does not divide, the recurrent trunk), the port's keeps
    it on CUDA: each rank runs it on its rows (the ``kernels-*`` cases of
    the mesh job run these flags). A CUDA device and a 2-rank mesh are
    pretended; construction builds nothing."""
    from types import SimpleNamespace

    from dcc_tpu_torch.algos import mappo
    from test_torch_cuda import pretend_cuda

    pretend_cuda(monkeypatch)
    monkeypatch.setattr(mappo.distributed, "local_first", lambda fn: None)
    mesh = SimpleNamespace(size=2, rank=0, device=torch.device("cuda"),
                           divides=lambda n: n % 2 == 0, all_sum=None)
    algo = MAPPO(MAPPOConfig(**{**R.SMALL, "compute_dtype": "bfloat16", **kw}), EnvConfig(),
                 device="cuda", mesh=mesh)
    assert (algo.gae_kernel, algo.fused_trunk, algo.fused_loss) == \
        (True, True, not algo.recurrent)


def test_one_rank_mesh_keeps_the_one_device_rules():
    """A mesh of one rank (no process group) splits nothing: the fused loss
    with minibatches stays allowed, as on JAX's one device."""
    mesh = make_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.rows(16)) == (1, 0, slice(0, 16))
    algo = MAPPO(MAPPOConfig(**{**R.SMALL, "fused_loss": "on", "num_mini_batch": 2}),
                 EnvConfig(), device="cpu", mesh=mesh)
    assert algo.fused_loss


# ---------------------------------------------------------------------------
# C7: a rank-3 obs (the toy pixel scenario of tests/test_cnn_dispatch.py:19-40)
# ---------------------------------------------------------------------------

GRID = 8


class _PixelConfig(EnvConfig):
    """The default env's fields, with each agent's observation a GRID x
    GRID x 2 occupancy map."""

    @property
    def obs_shape(self):
        return (GRID, GRID, 2)

    @property
    def obs_dim(self) -> int:
        return GRID * GRID * 2


def _pixel_obs(cfg, state):
    ij = ((state.pos + 1.0) * 0.5 * GRID).long().clamp(0, GRID - 1)  # (E, N, 2)
    img = torch.zeros(state.pos.shape[0], GRID, GRID, 2)
    img[torch.arange(img.shape[0])[:, None], ij[..., 0], ij[..., 1], 0] = 255.0
    return img[:, None].expand(-1, cfg.n_agents, -1, -1, -1)


def test_rank3_obs_raises_naming_a9():
    """JAX builds a CNN actor for this scenario (tests/test_cnn_dispatch.py);
    the port refuses it at construction rather than train an MLP on the
    flattened image."""
    from dcc_tpu_torch.envs import coverage

    try:
        register_scenario("pixel_toy", config_cls=_PixelConfig, reset_fn=coverage.reset,
                          step_fn=coverage.step, observation_fn=_pixel_obs)
    except ValueError:
        pass  # registered in this process already
    cfg = _PixelConfig(n_agents=2)
    states = get_scenario("pixel_toy")["reset"](cfg, 3, device="cpu")
    assert get_scenario("pixel_toy")["observation"](cfg, states).shape == (3, 2, GRID, GRID, 2)
    with pytest.raises(NotImplementedError, match="A9"):
        MAPPO(MAPPOConfig(**R.SMALL), cfg, device="cpu", scenario="pixel_toy")
