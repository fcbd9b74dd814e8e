"""K3u / K4u plain versions (``fold=False``: the LN affines applied in the
chain, every LN scale and bias gradient out of the backward) against the
JAX fused PPO kernels ``actor_ppo_grads_packed`` /
``critic_value_grads_packed`` with ``fold=False, interpret=True``, in f32
and bf16, on pre-padded rows (``block_rows`` 32).

Hidden 32, two layers (``layer_N`` 1), biases, LN affines and log_std moved
off their init values so that every affine and bias add rounds in bf16.

f32: rtol 2e-4 and atol 5e-5 times the tensor's largest entry, the bound of
``tests/test_torch_fused_ppo.py`` (a reordered f32 row sum is off by a
fraction of its largest summands); loss sums rtol 1e-5.

bf16 (the mode in which the main path runs the kernels): ||port - jax|| /
||jax|| below 2e-3 for every gradient and loss sum, and the same plain
version computed in f32 lands outside that bound, so the bound tells the
unfolded chain's bf16 rounding points (each LN affine output rounded) from
none at all. The JAX reference is compiled with XLA's
``xla_allow_excess_precision`` off: by default XLA on the CPU drops
bf16 round trips (the head's value came out between two bf16 numbers), and
the unclipped MSE critic, whose bias gradient is a sum of cotangents near
+-30 that cancels to 2.5, then reads 2.0e-2 from the port's twin; with the
roundings kept, as on a TPU, both sides agree within the bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcc_tpu.models import distributions as JD
from dcc_tpu.models.actor_critic import Actor as JActor
from dcc_tpu.models.actor_critic import Critic as JCritic
from dcc_tpu.ops import fused_ppo as JFP
from dcc_tpu.ops.fused_mlp import _pad_rows
from dcc_tpu_torch.ops import fused_ppo as FP

CLIP, DELTA, HIDDEN, BLOCK, ROWS = 0.2, 10.0, 32, 32, 70
BF16_REL = 2e-3


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def _perturb(params, seed):
    """Move every 1-D leaf (biases, LN affines, log_std) off its init value."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=np.shape(a))).astype(np.float32)
        if np.ndim(a) == 1 else np.asarray(a, np.float32), params)


def _flat(base):
    flat = [base["feature_norm"]["scale"], base["feature_norm"]["bias"]]
    for i in range(2):
        flat += [base[f"fc{i}"][k] for k in ("kernel", "bias")]
        flat += [base[f"norm{i}"][k] for k in ("scale", "bias")]
    return [np.asarray(p, np.float32) for p in flat]


def _x(a, bf16):
    """Rows as the main path stores them (bf16 in bf16 mode): JAX's padded to
    the block, the port's unpadded."""
    dt = jnp.bfloat16 if bf16 else jnp.float32
    return (_pad_rows(jnp.asarray(a, dt), BLOCK),
            torch.from_numpy(a).to(torch.bfloat16 if bf16 else torch.float32))


def _jax_exact(fn, *args):
    """``fn(*args)`` compiled with every bf16 rounding kept (no excess
    precision), as the kernels round on a TPU."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _outputs(out):
    return [*out[0], *out[1:]]


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64).reshape(want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _check(port, port_f32, jout, bf16):
    got, want = _outputs(port), _outputs(jout)
    assert len(got) == len(want)
    if not bf16:
        for g, w in zip(got[:-1], want[:-1]):
            w = np.asarray(w)
            np.testing.assert_allclose(np.asarray(g).reshape(w.shape), w, rtol=2e-4,
                                       atol=5e-5 * max(1.0, float(np.abs(w).max())))
        np.testing.assert_allclose(np.asarray(got[-1]), np.asarray(want[-1]), rtol=1e-5)
        return
    errs = [_rel(g, w) for g, w in zip(got, want)]
    assert max(errs) < BF16_REL, errs
    assert max(_rel(g, w) for g, w in zip(_outputs(port_f32), want)) > BF16_REL


def _actor_case():
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(ROWS, 110)).astype(np.float32)
    ja = JActor(hidden_size=HIDDEN, layer_n=1, action_dim=2)
    params = _perturb(jax.device_get(ja.init(jax.random.PRNGKey(1), obs)), 5)
    act = rng.normal(size=(ROWS, 2)).astype(np.float32)
    adv = rng.normal(size=(ROWS, 1)).astype(np.float32)
    out, _ = ja.apply(params, obs)
    lp, _ = JD.evaluate_head("gaussian", out, act)
    old_lp = (np.asarray(lp) + 0.3 * rng.normal(size=(ROWS, 1))).astype(np.float32)
    return params["params"], obs, act, old_lp, adv


def _critic_case():
    rng = np.random.default_rng(3)
    cent = rng.normal(size=(ROWS, 440)).astype(np.float32)
    jc = JCritic(hidden_size=HIDDEN, layer_n=1)
    params = _perturb(jax.device_get(jc.init(jax.random.PRNGKey(4), cent)), 6)
    v0 = np.asarray(jc.apply(params, cent)[0])
    vpred = (v0 + 0.3 * rng.normal(size=(ROWS, 1))).astype(np.float32)
    ret = (v0 + 30.0 * rng.normal(size=(ROWS, 1))).astype(np.float32)
    return params["params"], cent, vpred, ret


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_actor_unfolded_plain_matches_jax_kernel(bf16):
    p, obs, act, old_lp, adv = _actor_case()
    jx, tx = _x(obs, bf16)
    jout = _jax_exact(
        lambda x, aux: JFP.actor_ppo_grads_packed(
            x, aux, [jnp.asarray(v) for v in _flat(p["base"])],
            jnp.asarray(p["act_out"]["kernel"]), jnp.asarray(p["act_out"]["bias"]),
            jnp.asarray(p["log_std"]), n_layers=2, clip_param=CLIP, bf16=bf16, act_dim=2,
            block_rows=BLOCK, interpret=True, fold=False),
        jx, JFP.pack_actor_aux(jnp.asarray(act), jnp.asarray(old_lp), jnp.asarray(adv), BLOCK),
    )

    def port(bf):
        return FP.actor_ppo_grads_packed(
            tx, FP.pack_actor_aux(T(act), T(old_lp), T(adv)),
            [T(v) for v in _flat(p["base"])], T(p["act_out"]["kernel"]),
            T(p["act_out"]["bias"]), T(p["log_std"]), n_layers=2, clip_param=CLIP,
            bf16=bf, fold=False,
        )

    out = port(bf16)
    assert [tuple(g.shape) for g in out[0]] == [v.shape for v in _flat(p["base"])]
    _check(out, port(False) if bf16 else None, jout, bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("use_huber,use_clipped",
                         [(True, True), (True, False), (False, True), (False, False)])
def test_critic_unfolded_plain_matches_jax_kernel(use_huber, use_clipped, bf16):
    p, cent, vpred, ret = _critic_case()
    jx, tx = _x(cent, bf16)
    kw = dict(n_layers=2, clip_param=CLIP, huber_delta=DELTA, use_huber=use_huber,
              use_clipped=use_clipped)
    jout = _jax_exact(
        lambda x, aux: JFP.critic_value_grads_packed(
            x, aux, jnp.asarray([[0.5, 2.0]], jnp.float32),
            [jnp.asarray(v) for v in _flat(p["base"])], jnp.asarray(p["v_out"]["kernel"]),
            jnp.asarray(p["v_out"]["bias"]), bf16=bf16, block_rows=BLOCK, interpret=True,
            fold=False, **kw),
        jx, JFP.pack_critic_aux(jnp.asarray(vpred), jnp.asarray(ret), BLOCK),
    )

    def port(bf):
        return FP.critic_value_grads_packed(
            tx, FP.pack_critic_aux(T(vpred), T(ret)), torch.tensor([0.5, 2.0]),
            [T(v) for v in _flat(p["base"])], T(p["v_out"]["kernel"]),
            T(p["v_out"]["bias"]), bf16=bf, fold=False, **kw,
        )

    _check(port(bf16), port(False) if bf16 else None, jout, bf16)


def test_unfolded_and_folded_agree_in_f32():
    """In f32 the two chains are the same function: K3u's twin and K3's (its
    gradients mapped back by ``unfold_trunk_grads``) agree to rounding."""
    p, obs, act, old_lp, adv = _actor_case()
    args = (T(obs), FP.pack_actor_aux(T(act), T(old_lp), T(adv)),
            [T(v) for v in _flat(p["base"])], T(p["act_out"]["kernel"]),
            T(p["act_out"]["bias"]), T(p["log_std"]))
    unf = FP.actor_ppo_grads_packed(*args, n_layers=2, fold=False)
    fold = FP.actor_ppo_grads_packed(*args, n_layers=2, fold=True)
    for g, w in zip(_outputs(unf), _outputs(fold)):
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4,
                                   atol=5e-5 * max(1.0, float(np.abs(w).max())))
