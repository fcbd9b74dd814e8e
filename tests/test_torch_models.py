"""The port's networks, distributions and value normalizer against the JAX
package, from identical parameters converted by compat.flax_params.

f32 tolerance 1e-5 (summation order of the matmuls). In bf16 both sides
round at the same points but may flip single bf16 roundings of
intermediates, so the bound is one bf16 step of the outputs' magnitude
(rtol 2e-2, atol 2e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcc_tpu.models import distributions as JD
from dcc_tpu.models import valuenorm as JVN
from dcc_tpu.models.actor_critic import Actor as JActor
from dcc_tpu.models.actor_critic import Critic as JCritic
from dcc_tpu_torch.compat import flax_to_state_dict, state_dict_to_flax
from dcc_tpu_torch.models import Actor, Critic
from dcc_tpu_torch.models import distributions as D
from dcc_tpu_torch.models import valuenorm as VN

HIDDEN = 64


def _nets(bf16):
    jdt = jnp.bfloat16 if bf16 else None
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(37, 110)).astype(np.float32)
    cent = rng.normal(size=(37, 440)).astype(np.float32)
    ja = JActor(hidden_size=HIDDEN, layer_n=1, action_dim=2, dtype=jdt)
    jc = JCritic(hidden_size=HIDDEN, layer_n=1, dtype=jdt)
    pa = jax.device_get(ja.init(jax.random.PRNGKey(1), obs))
    pc = jax.device_get(jc.init(jax.random.PRNGKey(2), cent))
    # a non-zero log_std and head bias so every parameter matters
    pa["params"]["log_std"] = np.asarray([0.3, -0.2], np.float32)
    pa["params"]["act_out"]["bias"] = np.asarray([0.05, -0.1], np.float32)
    actor = Actor(110, 2, hidden_size=HIDDEN, layer_n=1, bf16=bf16)
    critic = Critic(440, hidden_size=HIDDEN, layer_n=1, bf16=bf16)
    actor.load_state_dict(flax_to_state_dict(pa))
    critic.load_state_dict(flax_to_state_dict(pc))
    return ja, jc, pa, pc, actor, critic, obs, cent


@pytest.mark.parametrize("bf16", [False, True])
def test_actor_critic_outputs_match_jax(bf16):
    ja, jc, pa, pc, actor, critic, obs, cent = _nets(bf16)
    act = np.random.default_rng(3).normal(size=(37, 2)).astype(np.float32)
    (jmean, jls), _ = ja.apply(pa, obs)
    jv, _ = jc.apply(pc, cent)
    jlp = JD.normal_log_prob(jmean, jls, act)
    jent = JD.normal_entropy(jls, jmean)
    with torch.no_grad():
        mean, ls = actor(torch.from_numpy(obs))
        v = critic(torch.from_numpy(cent))
        lp = D.normal_log_prob(mean, ls, torch.from_numpy(act))
        ent = D.normal_entropy(ls, mean)
    tol = dict(rtol=2e-2, atol=2e-2) if bf16 else dict(rtol=1e-5, atol=1e-5)
    assert mean.dtype == v.dtype == torch.float32
    np.testing.assert_allclose(D.normal_mode(mean).numpy(), np.asarray(jmean), **tol)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **tol)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), **tol)
    np.testing.assert_allclose(ent.numpy(), np.asarray(jent), rtol=1e-6)


def test_flax_state_dict_round_trip():
    _, _, pa, pc, actor, critic, _, _ = _nets(False)
    for tree, net in ((pa, actor), (pc, critic)):
        back = state_dict_to_flax(net.state_dict())
        got = jax.tree_util.tree_leaves_with_path(back)
        want = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert len(got) == len(want)
        for path, leaf in got:
            np.testing.assert_array_equal(leaf, np.asarray(want[path]))
    assert actor.base.fc0.weight.shape == (HIDDEN, 110)  # torch (out, in)
    assert pa["params"]["base"]["fc0"]["kernel"].shape == (110, HIDDEN)


def test_sampled_action_from_injected_noise():
    rng = np.random.default_rng(4)
    mean = rng.normal(size=(5, 2)).astype(np.float32)
    ls = np.asarray([0.1, -0.4], np.float32)
    gen = torch.Generator().manual_seed(0)
    a = D.normal_sample(torch.from_numpy(mean), torch.from_numpy(ls), gen)
    noise = torch.randn((5, 2), generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(
        a.numpy(), mean + np.exp(ls) * noise.numpy(), rtol=1e-6, atol=1e-7
    )


def test_valuenorm_matches_jax():
    rng = np.random.default_rng(5)
    js, ts = JVN.init(), VN.init("cpu")
    for scale in (1.0, 30.0, 300.0):
        batch = (scale * rng.normal(size=(8, 3, 1)) + scale).astype(np.float32)
        js = JVN.update(js, jnp.asarray(batch))
        ts = VN.update(ts, torch.from_numpy(batch))
        x = rng.normal(size=(6, 1)).astype(np.float32) * scale
        np.testing.assert_allclose(
            VN.normalize(ts, torch.from_numpy(x)).numpy(),
            np.asarray(JVN.normalize(js, jnp.asarray(x))), rtol=1e-5, atol=1e-6,
        )
        np.testing.assert_allclose(
            VN.denormalize(ts, torch.from_numpy(x)).numpy(),
            np.asarray(JVN.denormalize(js, jnp.asarray(x))), rtol=1e-5, atol=1e-5,
        )
    np.testing.assert_allclose(float(ts.debias), float(js.debias), rtol=1e-6)
