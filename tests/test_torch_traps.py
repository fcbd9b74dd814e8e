"""Places where a direct PyTorch translation would differ from the JAX
package, each pinned as an explicit case (ROADMAP Queue C)."""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dcc_tpu.algos import MAPPO as JMAPPO
from dcc_tpu.algos import MAPPOConfig as JMAPPOConfig
from dcc_tpu.envs import EnvConfig as JEnvConfig
from dcc_tpu.models.mlp import MLPBase as JMLPBase
from dcc_tpu_torch.algos import MAPPO, MAPPOConfig
from dcc_tpu_torch.algos.mappo import jnp_clip, normalize_advantages
from dcc_tpu_torch.compat import flax_to_state_dict
from dcc_tpu_torch.envs import EnvConfig
from dcc_tpu_torch.models import MLPBase
from dcc_tpu_torch.ops.fused_mlp import ln_stats
from dcc_tpu_torch.utils import clip_by_global_norm_


@pytest.mark.parametrize("x", [0.8, 1.2, 1.0])
def test_clip_gradient_at_bounds(x):
    """jnp.clip splits the gradient 50/50 at a bound; torch.clamp gives 1.
    The port's jnp_clip follows JAX."""
    want = float(jax.grad(lambda v: jnp.clip(v, 0.8, 1.2))(jnp.float32(x)))
    t = torch.tensor(x, requires_grad=True)
    jnp_clip(t, 0.8, 1.2).backward()
    assert float(t.grad) == want
    t2 = torch.tensor(x, requires_grad=True)
    torch.clamp(t2, 0.8, 1.2).backward()
    assert float(t2.grad) == 1.0
    assert want == (0.5 if x in (0.8, 1.2) else 1.0)


def test_advantage_normalization_uses_population_std():
    adv = np.random.default_rng(0).normal(size=(5, 3, 1)).astype(np.float32)
    j = jnp.asarray(adv)
    want = (j - j.mean()) / (j.std() + 1e-5)
    got = normalize_advantages(torch.from_numpy(adv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    unbiased = (adv - adv.mean()) / (adv.std(ddof=1) + 1e-5)
    assert np.abs(unbiased - np.asarray(want)).max() > 1e-3


def test_layernorm_eps_and_fast_variance():
    """flax's LayerNorm: eps 1e-6 (nn.LayerNorm's is 1e-5) and the fast
    variance max(E[x^2] - E[x]^2, 0) (torch's layer_norm is two-pass)."""
    assert flax.linen.LayerNorm().epsilon == 1e-6
    assert flax.linen.LayerNorm().use_fast_variance
    # eps: zero-mean rows of variance ~1e-6, where eps sets the scale
    rng = np.random.default_rng(1)
    x = (1e-3 * rng.normal(size=(4, 2, 110))).astype(np.float32)
    jm = JMLPBase(hidden_size=16, layer_n=0)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0), x))
    m = MLPBase(110, hidden_size=16, layer_n=0)
    m.load_state_dict(flax_to_state_dict(jp))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
        xt = torch.from_numpy(x)
        ln_default = torch.nn.functional.layer_norm(xt, (110,))  # eps 1e-5
        ln_flax = torch.nn.functional.layer_norm(xt, (110,), eps=1e-6)
    # f32 summation order of the 110-wide LN statistics
    np.testing.assert_allclose(got, np.asarray(jm.apply(jp, x)), atol=1e-5)
    assert float((ln_default - ln_flax).abs().max()) > 0.05
    # fast variance: a 2-wide row [c, c + ulp(c)] at c = 4096, where every
    # f32 sum is exact in any order: E[x^2] - E[x]^2 = 2, the true variance
    # is ulp^2 / 4 ~ 6e-8
    row = np.asarray([[4096.0, 4096.0 + 2.0**-11]], np.float32)
    jln = flax.linen.LayerNorm()
    want = np.asarray(jln.apply(jln.init(jax.random.PRNGKey(0), row), row))
    mu, inv = ln_stats(torch.from_numpy(row))
    got = ((torch.from_numpy(row) - mu) * inv).numpy()
    np.testing.assert_allclose(float(inv), 1.0 / np.sqrt(2.0 + 1e-6), rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    two_pass = torch.nn.functional.layer_norm(torch.from_numpy(row), (2,), eps=1e-6)
    assert float((two_pass - torch.tensor(want)).abs().max()) > 0.1


def test_global_norm_clip_matches_optax_not_clip_grad_norm():
    """optax: g / norm * max when norm >= max; torch.nn.utils.clip_grad_norm_
    divides by norm + 1e-6, visible at small norms."""
    g = np.asarray([1.2e-6, -1.6e-6], np.float32)  # norm 2e-6
    max_norm = 1e-6
    want, _ = optax.clip_by_global_norm(max_norm).update(jnp.asarray(g), None)
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = torch.from_numpy(g.copy())
    norm = clip_by_global_norm_([p], max_norm)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(float(norm), 2e-6, rtol=1e-6)
    q = torch.nn.Parameter(torch.zeros(2))
    q.grad = torch.from_numpy(g.copy())
    torch.nn.utils.clip_grad_norm_([q], max_norm)
    assert np.abs(q.grad.numpy() - np.asarray(want)).max() > 1e-7


def test_count_based_lr_decay_matches_optax_schedule():
    """The first update already runs at base * (1 - 1/n_iters): Adam's first
    step is lr * g / (|g| + eps), so a unit gradient measures the LR."""
    cfg = dict(n_iters=8, ppo_epoch=3)
    jalgo = JMAPPO(JMAPPOConfig(**cfg), JEnvConfig())
    algo = MAPPO(MAPPOConfig(**cfg), EnvConfig(), device="cpu")
    params = {"w": jnp.zeros(())}
    state = jalgo.actor_tx.init(params)
    for count in range(7):
        updates, state = jalgo.actor_tx.update({"w": jnp.ones(())}, state, params)
        if count == 0:  # only the first Adam step is lr-sized
            np.testing.assert_allclose(algo.lr_at(5e-4, count), -float(updates["w"]),
                                       rtol=1e-4)
        it = count // 3 + 1
        assert algo.lr_at(5e-4, count) == pytest.approx(5e-4 * (1 - it / 8))
    assert algo.lr_at(5e-4, 0) == pytest.approx(5e-4 * (1 - 1 / 8))


def test_max_min_split_ties_like_jax():
    for fn_t, fn_j in ((torch.maximum, jnp.maximum), (torch.minimum, jnp.minimum)):
        a = torch.tensor(2.0, requires_grad=True)
        fn_t(a, torch.tensor(2.0)).backward()
        assert float(a.grad) == float(jax.grad(lambda v: fn_j(v, 2.0))(2.0)) == 0.5
