"""One update of separated per-agent MAPPO (``share_policy=False``) against
``dcc_tpu.algos.MAPPO``'s ``_update_separated``, from identical converted
per-agent parameters, on JAX's sampled rollout at the size of
``tests/test_torch_separated.py`` (4 UAVs, 20 PoIs, E = A = 4, T = 8, hidden
32, 2 epochs), with JAX's per-agent permutations (``split(key, A)``, then
``split(key_i, ppo_epoch)`` and ``permutation(key_e, n)``), over JAX's own
matrix (``tests/test_mappo.py:288-296``): JAX's parameters, normalizer
states and metrics at the f32 bounds of ``tests/test_torch_slice.py``
(parameters atol 3e-5, metrics rtol 1e-4 / atol 1e-6).

In bf16 the separated path runs the flax trunk on both sides (no fused
kernel), and no bound on single parameters as tight as 1e-4 holds: JAX's
own update compiled with and without ``xla_allow_excess_precision``
differs by more than that on a parameter (the test checks it; measured
6.8e-4), since Adam turns each bf16 rounding that flips a near-zero
gradient into a step of the learning rate. The bf16 check therefore holds
each agent's actor and critic against JAX's (compiled with every bf16
rounding kept) on its own: the relative L2 distance of its parameter
change below 0.05 and its largest parameter gap below 1e-3 (measured at
most 0.022 and 6.95e-4; JAX's other build 0.091 and 6.8e-4), while the
port's update computed in f32 exceeds both on some network (0.29 and
1.56e-3); the metrics stay within test_torch_slice's bf16 bounds (rtol
2e-3 / atol 1e-5).
"""

import jax
import numpy as np
import pytest
import torch

from dcc_tpu.algos import MAPPO as JMAPPO
from dcc_tpu.algos import MAPPOConfig as JMAPPOConfig
from dcc_tpu.envs import EnvConfig as JEnvConfig
from dcc_tpu_torch.compat import stack_states, stacked_flax_to_state_dicts
from test_torch_separated import RECURRENT, SMALL, _jax_rollout, _pair, _to_torch, nets


def jax_agent_perms(key, n, agents, epochs):
    """The permutations JAX's separated update draws: per agent, one of
    ``n`` per epoch."""
    return np.stack([np.stack([np.asarray(jax.random.permutation(k, n))
                               for k in jax.random.split(key_a, epochs)])
                     for key_a in jax.random.split(key, agents)])


def _assert_params(ts, jts, atol):
    for name, jparams in (("actor", jts.actor_params), ("critic", jts.critic_params)):
        wants = stacked_flax_to_state_dicts(jax.device_get(jparams))
        assert len(wants) == len(ts.agents) == 4
        for i, (net, want) in enumerate(zip(nets(ts, name), wants)):
            got = net.state_dict()
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k].float().numpy(), want[k].numpy(), atol=atol,
                                           err_msg=f"agent {i} {k}")


MATRIX = [
    ("nmb1", {}),
    ("nmb2", dict(num_mini_batch=2)),
    ("recurrent", RECURRENT),
    ("recurrent_nmb2", dict(RECURRENT, num_mini_batch=2)),
    ("naive_recurrent", dict(use_naive_recurrent=True)),
    ("popart", dict(use_popart=True, use_valuenorm=False)),
    ("popart_nmb2", dict(use_popart=True, use_valuenorm=False, num_mini_batch=2)),
]


def run_update(kw, compute_dtype="float32"):
    """One update of each side on JAX's sampled rollout, the port with
    JAX's per-agent permutations. Returns (port state, port metrics, JAX
    state, JAX metrics, JAX initial state)."""
    jalgo, jts, algo, ts = _pair(compute_dtype, **kw)
    jtraj = _jax_rollout(algo.recurrent)
    jadv, jret = jalgo.compute_returns(jts, jtraj)
    key = jax.random.PRNGKey(4)
    args = (jts, key, jtraj, jadv, jret)
    # in bf16 with every bf16 rounding kept, as on a TPU (XLA on the CPU
    # otherwise drops bf16 round trips, tests/test_torch_unfolded.py)
    options = {"xla_allow_excess_precision": False} if compute_dtype == "bfloat16" else {}
    jts2, jm = jax.jit(jalgo.update).lower(*args).compile(compiler_options=options)(*args)
    T, E, A, _ = jtraj.actions.shape
    L = {True: 4, False: T}[bool(kw.get("use_recurrent_policy"))]
    n = E * T // L if algo.recurrent else T * E
    perms = jax_agent_perms(key, n, A, algo.cfg.ppo_epoch)
    m = algo.update(ts, _to_torch(jtraj), torch.from_numpy(np.array(jadv)),
                    torch.from_numpy(np.array(jret)), perms=perms)
    return ts, m, jts2, jm, jts


@pytest.mark.parametrize("kw", [m[1] for m in MATRIX], ids=[m[0] for m in MATRIX])
def test_update_matches_jax(kw):
    ts, m, jts2, jm, _ = run_update(kw)
    _assert_params(ts, jts2, 3e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-4, atol=1e-6)
    norm = "popart" if kw.get("use_popart") else "vnorm"
    want = getattr(jts2, norm)._asdict()
    for k, v in stack_states(nets(ts, norm)).items():
        np.testing.assert_allclose(v, np.asarray(want[k]), rtol=1e-6, err_msg=k)
    nmb = kw.get("num_mini_batch", 1)
    assert ts.update_count == int(jts2.update_count) == 2 * nmb
    assert ts.iteration == int(jts2.iteration) == 1


# the bf16 update's bounds, each agent's actor and critic on its own: the
# relative distance of its parameter change from JAX's, and its largest
# parameter gap, about 1.5 times JAX's own largest gap between two builds
# of the same update (6.8e-4, below)
BF16_REL, BF16_ABS = 0.05, 1e-3


def _port_params(ts):
    return {name: [n.state_dict() for n in nets(ts, name)] for name in ("actor", "critic")}


def _jax_params(jts):
    return {name: stacked_flax_to_state_dicts(jax.device_get(getattr(jts, name + "_params")))
            for name in ("actor", "critic")}


def _update_gaps(params, jts0, jts2):
    """Per agent and network, keyed ("actor", i) / ("critic", i): the
    relative distance ||change - JAX's change|| / ||JAX's change|| of
    ``params`` from JAX's update ``jts0`` -> ``jts2``, and the largest
    |parameter - JAX's|."""
    starts, ends, gaps = _jax_params(jts0), _jax_params(jts2), {}
    for name, per_agent in params.items():
        for i, (got, start, end) in enumerate(zip(per_agent, starts[name], ends[name])):
            num = den = worst = 0.0
            for k, want in end.items():
                diff = got[k].float() - want
                num += float(diff.square().sum())
                den += float((want - start[k]).square().sum())
                worst = max(worst, float(diff.abs().max()))
            gaps[(name, i)] = ((num / den) ** 0.5, worst)
    return gaps


def test_bf16_update_matches_jax():
    """bf16 (the flax trunk on both sides, the separated dispatch) against
    JAX's update with its bf16 roundings kept, each agent's actor and
    critic within ``BF16_REL`` and ``BF16_ABS``; the port's update in f32 on
    the same inputs lies outside both bounds, and JAX's own update built
    with XLA's excess precision allowed moves single parameters by more
    than 1e-4."""
    ts, m, jts2, jm, jts0 = run_update({}, "bfloat16")
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=2e-3, atol=1e-5)
    gaps = _update_gaps(_port_params(ts), jts0, jts2)
    f32 = _update_gaps(_port_params(run_update({})[0]), jts0, jts2)
    jalgo = JMAPPO(JMAPPOConfig(gae_backend="xla", compute_dtype="bfloat16", **SMALL),
                   JEnvConfig())
    jtraj = _jax_rollout(False)
    jadv, jret = jalgo.compute_returns(jts0, jtraj)
    loose = jax.jit(jalgo.update)(jts0, jax.random.PRNGKey(4), jtraj, jadv, jret)[0]
    builds = _update_gaps(_jax_params(loose), jts0, jts2)
    for key in gaps:
        print(f"{key}: port bf16 {gaps[key][0]:.4f} / {gaps[key][1]:.2e}, port f32 "
              f"{f32[key][0]:.4f} / {f32[key][1]:.2e}, JAX's other build "
              f"{builds[key][0]:.4f} / {builds[key][1]:.2e}")
    bad = {k: g for k, g in gaps.items() if g[0] >= BF16_REL or g[1] >= BF16_ABS}
    assert not bad, bad
    assert max(r for r, _ in f32.values()) > BF16_REL
    assert max(g for _, g in f32.values()) > BF16_ABS
    assert max(g for _, g in builds.values()) > 1e-4
