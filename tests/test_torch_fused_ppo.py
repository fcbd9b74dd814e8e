"""K3 / K4 plain versions against the JAX fused PPO kernels
(``actor_ppo_grads`` / ``critic_value_grads`` with ``interpret=True,
fold=True``) in f32 and bf16, and against torch autograd of the stock loss.

f32: the tolerance of tests/test_fused_ppo.py:88 (rtol 2e-4 / atol 5e-5;
loss sums rtol 1e-5). Across frameworks the row sums are taken in another
order, so the heads are held to the trunk's bound, not to that file's atol
2e-5, and the atol scales with the tensor's largest entry: a reordered f32
sum is off by a fraction of its largest summands, not of its result (the
unclipped MSE critic's gradients reach |400| and cancel to 0.07 in places).

bf16 (the mode in which the main path runs K3 / K4): ||port - jax|| / ||jax||
below 2e-3 for every gradient and loss sum. Both sides round at the same
points; what is left is a summation order that flips single bf16 roundings
(measured at most 1.2e-3 at these shapes). Dropping the rounding of the
backward matmul operands, or adding a bias in f32, measured 3.1e-3 to 6e-2,
and computing in f32 throughout at least 1.9e-2; each test also checks that
the f32 twin lies outside the bound. The biases, LN affines and log_std are
perturbed away from their init values (zero biases, unit scales) so that
every bias add and folded affine rounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcc_tpu.models import distributions as JD
from dcc_tpu.models.actor_critic import Actor as JActor
from dcc_tpu.models.actor_critic import Critic as JCritic
from dcc_tpu.ops import fused_ppo as JFP
from dcc_tpu_torch.algos.mappo import jnp_clip
from dcc_tpu_torch.compat import flax_to_state_dict
from dcc_tpu_torch.models import Actor, Critic
from dcc_tpu_torch.models import distributions as D
from dcc_tpu_torch.ops import fused_ppo as FP

CLIP, DELTA, HIDDEN = 0.2, 10.0, 64


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def _flat(base):
    flat = [base["feature_norm"]["scale"], base["feature_norm"]["bias"]]
    for i in range(2):
        flat += [base[f"fc{i}"][k] for k in ("kernel", "bias")]
        flat += [base[f"norm{i}"][k] for k in ("scale", "bias")]
    return [np.asarray(p, np.float32) for p in flat]


def _close(got, want, rtol, atol):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got).reshape(want.shape), want, rtol=rtol,
                               atol=atol * scale)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64).reshape(want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _perturb(params, seed):
    """Move every 1-D leaf (biases, LN affines, log_std) off its init value."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=np.shape(a))).astype(np.float32)
        if np.ndim(a) == 1 else np.asarray(a), params)


def _x(a, bf16):
    """Observation rows as the main path stores them: bf16 in bf16 mode."""
    return (jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32),
            torch.from_numpy(a).to(torch.bfloat16 if bf16 else torch.float32))


def _actor_setup(rows=70):
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(rows, 110)).astype(np.float32)
    ja = JActor(hidden_size=HIDDEN, layer_n=1, action_dim=2)
    params = jax.device_get(ja.init(jax.random.PRNGKey(1), obs))
    act = rng.normal(size=(rows, 2)).astype(np.float32)
    adv = rng.normal(size=(rows, 1)).astype(np.float32)
    out, _ = ja.apply(params, obs)
    lp, _ = JD.evaluate_head("gaussian", out, act)
    old_lp = (np.asarray(lp) + 0.3 * rng.normal(size=(rows, 1))).astype(np.float32)
    return ja, params, obs, act, old_lp, adv


def _critic_setup(rows=70, tie=False):
    rng = np.random.default_rng(3)
    cent = rng.normal(size=(rows, 440)).astype(np.float32)
    jc = JCritic(hidden_size=HIDDEN, layer_n=1)
    params = jax.device_get(jc.init(jax.random.PRNGKey(4), cent))
    v0 = np.asarray(jc.apply(params, cent)[0])
    vpred = v0 if tie else (v0 + 0.3 * rng.normal(size=(rows, 1))).astype(np.float32)
    ret = (v0 + 30.0 * rng.normal(size=(rows, 1))).astype(np.float32)
    return jc, params, cent, vpred, ret


def _port_actor_grads(params, x, act, old_lp, adv, bf16=False):
    p = params["params"]
    return FP.actor_ppo_grads_packed(
        x, FP.pack_actor_aux(T(act), T(old_lp), T(adv)), [T(v) for v in _flat(p["base"])],
        T(p["act_out"]["kernel"]), T(p["act_out"]["bias"]), T(p["log_std"]),
        n_layers=2, clip_param=CLIP, bf16=bf16,
    )


def _port_critic_grads(params, x, vpred, ret, bf16=False, **kw):
    p = params["params"]
    return FP.critic_value_grads_packed(
        x, FP.pack_critic_aux(T(vpred), T(ret)), torch.tensor([0.0, 1.0]),
        [T(v) for v in _flat(p["base"])], T(p["v_out"]["kernel"]), T(p["v_out"]["bias"]),
        n_layers=2, clip_param=CLIP, huber_delta=DELTA, bf16=bf16, **kw,
    )


def _outputs(out):
    """K3 / K4 results as one list: trunk grads, head grads, loss sums."""
    return [*out[0], *out[1:]]


def _check(port, port_f32, jax_out, bf16):
    got, want = _outputs(port), _outputs(jax_out)
    if not bf16:
        _close(got[-1], want[-1], 1e-5, 0)  # loss sums
        for g, w in zip(got[:-1], want[:-1]):
            _close(g, w, 2e-4, 5e-5)
        return
    errs = [_rel(g, w) for g, w in zip(got, want)]
    assert max(errs) < 2e-3, errs
    # the bound tells the bf16 rounding points from none at all
    assert max(_rel(g, w) for g, w in zip(_outputs(port_f32), want)) > 1e-2


@pytest.mark.parametrize("bf16", [False, True])
def test_actor_plain_matches_jax_kernel(bf16):
    _, params, obs, act, old_lp, adv = _actor_setup()
    if bf16:
        params = _perturb(params, 5)
    p = params["params"]
    jx, tx = _x(obs, bf16)
    jout = JFP.actor_ppo_grads(
        jx, jnp.asarray(act), jnp.asarray(old_lp), jnp.asarray(adv),
        [jnp.asarray(x) for x in _flat(p["base"])], jnp.asarray(p["act_out"]["kernel"]),
        jnp.asarray(p["act_out"]["bias"]), jnp.asarray(p["log_std"]), n_layers=2,
        clip_param=CLIP, bf16=bf16, block_rows=32, interpret=True, fold=True,
    )
    port = _port_actor_grads(params, tx, act, old_lp, adv, bf16)
    port_f32 = _port_actor_grads(params, tx, act, old_lp, adv) if bf16 else None
    _check(port, port_f32, jout, bf16)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("use_huber,use_clipped",
                         [(True, True), (True, False), (False, True), (False, False)])
def test_critic_plain_matches_jax_kernel(use_huber, use_clipped, bf16):
    _, params, cent, vpred, ret = _critic_setup()
    if bf16:
        params = _perturb(params, 6)
    p = params["params"]
    kw = dict(use_huber=use_huber, use_clipped=use_clipped)
    jx, tx = _x(cent, bf16)
    jout = JFP.critic_value_grads(
        jx, jnp.asarray(vpred), jnp.asarray(ret), [jnp.asarray(x) for x in _flat(p["base"])],
        jnp.asarray(p["v_out"]["kernel"]), jnp.asarray(p["v_out"]["bias"]), n_layers=2,
        clip_param=CLIP, huber_delta=DELTA, bf16=bf16, block_rows=32, interpret=True,
        fold=True, **kw,
    )
    port = _port_critic_grads(params, tx, vpred, ret, bf16, **kw)
    port_f32 = _port_critic_grads(params, tx, vpred, ret, **kw) if bf16 else None
    _check(port, port_f32, jout, bf16)


def _critic_autograd(params, cent, vpred, ret):
    critic = Critic(440, hidden_size=HIDDEN, layer_n=1)
    critic.load_state_dict(flax_to_state_dict(params))
    v = critic(T(cent))
    vp, rt = T(vpred), T(ret)
    v_clip = vp + jnp_clip(v - vp, -CLIP, CLIP)
    loss = torch.maximum(FP.huber(rt - v, DELTA), FP.huber(rt - v_clip, DELTA)).sum()
    loss.backward()
    return critic


def test_critic_tie_convention_first_epoch():
    """vpred == v exactly (the first epoch): every row ties in the clipped
    max, and the cotangent splits 50/50 as in JAX autodiff. Each side ties
    on its own forward (the two v differ in the last bits)."""
    jc, params, cent, vpred, ret = _critic_setup(tie=True)
    p = params["params"]
    kw = dict(n_layers=2, clip_param=CLIP, huber_delta=DELTA)
    jtg, jdwv, jdbv, jmet = JFP.critic_value_grads(
        jnp.asarray(cent), jnp.asarray(vpred), jnp.asarray(ret),
        [jnp.asarray(x) for x in _flat(p["base"])], p["v_out"]["kernel"],
        p["v_out"]["bias"], block_rows=32, interpret=True, fold=True, **kw,
    )
    critic = Critic(440, hidden_size=HIDDEN, layer_n=1)
    critic.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        own_v = critic(T(cent)).numpy()
    critic = _critic_autograd(params, cent, own_v, ret)
    tg, dwv, dbv, met = _port_critic_grads(params, T(cent), own_v, ret)
    _close(met, jmet, 1e-5, 0)
    for got, want in zip(tg, jtg):
        _close(got, want, 2e-4, 5e-5)
    _close(dwv, jdwv, 2e-4, 5e-5)
    _close(dwv, critic.v_out.weight.grad.numpy().T, 2e-4, 5e-5)
    _close(dbv, critic.v_out.bias.grad.numpy(), 2e-4, 5e-5)


def test_fold_and_unfold_match_jax():
    _, params, *_ = _actor_setup()
    p = params["params"]
    flat = _flat(p["base"])
    wh, bh = np.asarray(p["act_out"]["kernel"]), np.asarray(p["act_out"]["bias"])
    flat[0] = flat[0] * 1.3 + 0.1  # non-trivial LN affines
    flat[5] = flat[5] - 0.2
    j2 = [jnp.asarray(x).reshape(1, -1) if x.ndim == 1 else jnp.asarray(x) for x in flat]
    jkp, jwh, jbh = JFP.fold_trunk(j2, jnp.asarray(wh), jnp.asarray(bh).reshape(-1, 1),
                                   2, True)
    kp, whf, bhf = FP.fold_trunk([T(x) for x in flat], T(wh), T(bh), 2, True)
    for got, want in zip(kp, jkp):
        _close(got, want, 1e-6, 1e-6)
    _close(whf, jwh, 1e-6, 1e-6)
    _close(bhf, jbh, 1e-6, 1e-6)
    rng = np.random.default_rng(7)
    kg = [rng.normal(size=np.shape(k)).astype(np.float32) for k in kp]
    dwh = rng.normal(size=wh.shape).astype(np.float32)
    dbh = rng.normal(size=bh.shape).astype(np.float32)
    jtg, jdwh, jdbh = JFP.unfold_trunk_grads(
        [jnp.asarray(g).reshape(1, -1) if g.ndim == 1 else jnp.asarray(g) for g in kg],
        jnp.asarray(dwh), jnp.asarray(dbh).reshape(-1, 1), j2, jnp.asarray(wh), 2, True)
    tg, dwh_t, dbh_t = FP.unfold_trunk_grads([T(g) for g in kg], T(dwh), T(dbh),
                                             [T(x) for x in flat], T(wh), 2, True)
    for got, want in zip(tg, jtg):
        _close(got, want, 1e-5, 1e-5)
    _close(dwh_t, jdwh, 1e-5, 1e-5)
    _close(dbh_t, jdbh, 1e-6, 1e-6)


def test_actor_plain_matches_torch_autograd():
    _, params, obs, act, old_lp, adv = _actor_setup()
    actor = Actor(110, 2, hidden_size=HIDDEN, layer_n=1)
    actor.load_state_dict(flax_to_state_dict(params))
    mean, ls = actor(T(obs))
    ratio = torch.exp(D.normal_log_prob(mean, ls, T(act)) - T(old_lp))
    s1, s2 = ratio * T(adv), jnp_clip(ratio, 1 - CLIP, 1 + CLIP) * T(adv)
    (-torch.minimum(s1, s2).sum()).backward()
    tg, dwh, dbh, dls, met = _port_actor_grads(params, T(obs), act, old_lp, adv)
    base = actor.base
    want = [base.feature_norm.weight.grad, base.feature_norm.bias.grad]
    for i in range(2):
        fc, ln = getattr(base, f"fc{i}"), getattr(base, f"norm{i}")
        want += [fc.weight.grad.t(), fc.bias.grad, ln.weight.grad, ln.bias.grad]
    for got, w in zip(tg, want):
        _close(got, w.numpy(), 2e-4, 5e-5)
    _close(dwh, actor.act_out.weight.grad.t().numpy(), 2e-4, 2e-5)
    _close(dbh, actor.act_out.bias.grad.numpy(), 2e-4, 2e-5)
    _close(dls, actor.log_std.grad.numpy(), 2e-4, 2e-5)


def test_critic_plain_matches_torch_autograd():
    _, params, cent, vpred, ret = _critic_setup()
    critic = _critic_autograd(params, cent, vpred, ret)
    tg, dwv, dbv, _ = _port_critic_grads(params, T(cent), vpred, ret)
    base = critic.base
    _close(tg[0], base.feature_norm.weight.grad.numpy(), 2e-4, 5e-5)
    _close(tg[2], base.fc0.weight.grad.t().numpy(), 2e-4, 5e-5)
    _close(tg[6], base.fc1.weight.grad.t().numpy(), 2e-4, 5e-5)
    _close(dwv, critic.v_out.weight.grad.t().numpy(), 2e-4, 2e-5)
    _close(dbv, critic.v_out.bias.grad.numpy(), 2e-4, 2e-5)
