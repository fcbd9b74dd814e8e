"""The port's action heads against ``dcc_tpu``: the distribution functions,
the ``Actor`` head dispatch and the rollout for every head kind that is not
the Gaussian (categorical, multi_discrete, multi_binary, mixed); their
``MAPPO.update`` is in tests/test_torch_heads_update.py.

* ``sample_head(deterministic=True)`` and ``evaluate_head`` on the same
  logits and actions as JAX, with ties in the logits (both packages take the
  first index): log-probs and entropies within 1e-6 (f32 summation order of
  the log-softmax), modes exact.
* The ``Actor`` of each kind from converted flax parameters: f32 within
  1e-5; bf16 within 2e-2 (the bounds of tests/test_torch_models.py), and a
  bf16 tie in the logits gives the first index on both sides.
* A deterministic rollout per kind from converted parameters: the
  trajectory within 1e-4, as tests/test_torch_slice.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcc_tpu.algos import MAPPO as JMAPPO
from dcc_tpu.algos import MAPPOConfig as JMAPPOConfig
from dcc_tpu.envs import EnvConfig as JEnvConfig
from dcc_tpu.models import distributions as JD
from dcc_tpu.models.actor_critic import Actor as JActor
from dcc_tpu_torch.algos import MAPPO, MAPPOConfig, Trajectory
from dcc_tpu_torch.compat import flax_to_state_dict
from dcc_tpu_torch.envs import EnvConfig
from dcc_tpu_torch.models import Actor
from dcc_tpu_torch.models import distributions as D

KINDS = ["categorical", "multi_discrete", "multi_binary", "mixed"]
MODE = {"categorical": "discrete", "multi_discrete": "multi_discrete",
        "multi_binary": "multi_binary", "mixed": "mixed"}
SMALL = dict(n_rollout_threads=4, episode_length=8, ppo_epoch=2, n_iters=5, hidden_size=32)


def _head_out(kind, rng, rows):
    """Numpy head outputs of ``kind`` with exact ties: in the first rows the
    two largest logits are equal (Bernoulli: some logits exactly 0)."""

    def logits(n):
        x = rng.normal(size=(rows, n)).astype(np.float32)
        x[:3, 1] = x[:3].max(axis=1) + 0.5
        x[:3, 2] = x[:3, 1]  # a tie at the top: the first index wins
        return x

    if kind == "categorical":
        return logits(5)
    if kind == "multi_discrete":
        return (logits(3), logits(3))
    if kind == "multi_binary":
        x = rng.normal(size=(rows, 4)).astype(np.float32)
        x[:2, 1] = 0.0
        return x
    mean = rng.normal(size=(rows, 2)).astype(np.float32)
    return ((mean, np.asarray([0.3, -0.2], np.float32)), logits(3))


def _actions(kind, rng, rows):
    if kind == "categorical":
        return rng.integers(0, 5, (rows, 1)).astype(np.float32)
    if kind == "multi_discrete":
        return rng.integers(0, 3, (rows, 2)).astype(np.float32)
    if kind == "multi_binary":
        return rng.integers(0, 2, (rows, 4)).astype(np.float32)
    return np.concatenate([rng.normal(size=(rows, 2)),
                           rng.integers(0, 3, (rows, 1))], axis=1).astype(np.float32)


def _jax_tree(out):
    return jax.tree_util.tree_map(jnp.asarray, out)


def _torch_tree(out):
    return jax.tree_util.tree_map(torch.from_numpy, out)


@pytest.mark.parametrize("kind", KINDS)
def test_sample_and_evaluate_head_match_jax(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    out = _head_out(kind, rng, 40)
    act = _actions(kind, rng, 40)
    ja, jlp = JD.sample_head(jax.random.PRNGKey(0), kind, _jax_tree(out), deterministic=True)
    a, lp = D.sample_head(kind, _torch_tree(out), deterministic=True)
    assert a.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja, np.float32))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-6, atol=1e-6)
    if kind != "multi_binary":
        # the tied rows take the first of the two top indices
        first = a[:3, 0] if kind != "mixed" else a[:3, 2]
        assert first.tolist() == [1.0, 1.0, 1.0]
    jlp, jent = JD.evaluate_head(kind, _jax_tree(out), jnp.asarray(act))
    lp, ent = D.evaluate_head(kind, _torch_tree(out), torch.from_numpy(act))
    assert lp.shape == jlp.shape and ent.shape == jent.shape
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ent.numpy(), np.asarray(jent), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS + ["gaussian"])
def test_sampled_actions_are_valid(kind):
    """Sampled actions lie in the kind's action set, are reproducible from
    the generator, and their log-probs are evaluate_head's."""
    rng = np.random.default_rng(7)
    if kind == "gaussian":
        out = (torch.from_numpy(rng.normal(size=(500, 2)).astype(np.float32)),
               torch.tensor([0.3, -0.2]))
    else:
        out = _torch_tree(_head_out(kind, rng, 500))
    a, lp = D.sample_head(kind, out, generator=torch.Generator().manual_seed(1))
    a2, _ = D.sample_head(kind, out, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, a2)
    np.testing.assert_allclose(lp.numpy(), D.evaluate_head(kind, out, a)[0].numpy(),
                               rtol=1e-6, atol=1e-6)
    disc = {"categorical": (a, 5), "multi_discrete": (a, 3), "multi_binary": (a, 2),
            "mixed": (a[:, 2:], 3)}.get(kind)
    if disc is not None:
        vals, n = disc
        assert set(vals.unique().tolist()) == set(float(i) for i in range(n))


def _actor_pair(kind, bf16, tie=False):
    env = EnvConfig(action_mode=MODE[kind])
    jdt = jnp.bfloat16 if bf16 else None
    obs = np.random.default_rng(3).normal(size=(37, 110)).astype(np.float32)
    ja = JActor(hidden_size=64, layer_n=1, action_dim=env.action_dim, head_kind=kind,
                head_dims=env.action_head_dims, dtype=jdt)
    params = jax.device_get(ja.init(jax.random.PRNGKey(1), obs))
    rng = np.random.default_rng(4)
    # every 1-D leaf (biases, LN affines, log_std) off its init value
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rng.normal(size=np.shape(x))).astype(np.float32)
        if np.ndim(x) == 1 else np.array(x, np.float32), params)
    if tie:
        # identical weights and bias for categories 1 and 2, above the rest
        head = params["params"]["act_out"]
        head["kernel"][:, 2] = head["kernel"][:, 1]
        head["bias"][1:3] = 3.0
    actor = Actor(110, env.action_dim, head_kind=kind, head_dims=env.action_head_dims,
                  hidden_size=64, layer_n=1, bf16=bf16)
    actor.load_state_dict(flax_to_state_dict(params))
    return ja, params, actor, obs


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_actor_heads_match_jax(kind, bf16):
    ja, params, actor, obs = _actor_pair(kind, bf16)
    jout, _ = ja.apply(params, obs)
    with torch.no_grad():
        out = actor(torch.from_numpy(obs))
    tol = dict(rtol=2e-2, atol=2e-2) if bf16 else dict(rtol=1e-5, atol=1e-5)
    jl, tl = jax.tree_util.tree_leaves(jout), jax.tree_util.tree_leaves(out)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j, np.float32), **tol)
    assert set(actor.state_dict()) == set(flax_to_state_dict(params))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_tied_logits_take_the_first_index(bf16):
    ja, params, actor, obs = _actor_pair("categorical", bf16, tie=True)
    jout, _ = ja.apply(params, obs)
    ja_act, _ = JD.sample_head(jax.random.PRNGKey(0), "categorical", jout, deterministic=True)
    with torch.no_grad():
        logits = actor(torch.from_numpy(obs))
    a, _ = D.sample_head("categorical", logits, deterministic=True)
    assert bool((logits[:, 1] == logits[:, 2]).all())
    assert a[:, 0].tolist() == np.asarray(ja_act)[:, 0].tolist() == [1.0] * len(obs)


def _pair(kind, compute_dtype="float32"):
    bf16 = compute_dtype == "bfloat16"
    mode = MODE[kind]
    jalgo = JMAPPO(JMAPPOConfig(fused_loss="off", fused_trunk="interpret" if bf16 else "off",
                                gae_backend="xla", fused_block_rows=32,
                                compute_dtype=compute_dtype, **SMALL),
                   JEnvConfig(action_mode=mode))
    jts = jalgo.init_state(jax.random.PRNGKey(0))
    algo = MAPPO(MAPPOConfig(fused_trunk="on" if bf16 else "auto",
                             compute_dtype=compute_dtype, **SMALL),
                 EnvConfig(action_mode=mode), device="cpu")
    actor, critic = algo.make_networks()
    actor.load_state_dict(flax_to_state_dict(jax.device_get(jts.actor_params)))
    critic.load_state_dict(flax_to_state_dict(jax.device_get(jts.critic_params)))
    return jalgo, jts, algo, algo.init_state(actor=actor, critic=critic)


def _to_torch(jtraj):
    return Trajectory(*(None if getattr(jtraj, f) is None
                        else torch.from_numpy(np.array(getattr(jtraj, f), np.float32))
                        for f in Trajectory._fields))


@pytest.mark.parametrize("kind", KINDS)
def test_deterministic_rollout_matches_jax(kind):
    jalgo, jts, algo, ts = _pair(kind)
    jtraj = jalgo.rollout(jts, jax.random.PRNGKey(1), 4, deterministic=True)
    traj = algo.rollout(ts, 4, deterministic=True)
    assert traj.actions.shape[-1] == algo.env_cfg.action_width
    assert traj.log_probs.shape[-1] == (2 if kind == "multi_discrete" else 1)
    for f in Trajectory._fields[:8]:
        np.testing.assert_allclose(getattr(traj, f).float().numpy(),
                                   np.asarray(getattr(jtraj, f), np.float32),
                                   atol=1e-4, err_msg=f)
