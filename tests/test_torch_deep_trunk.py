"""Trunks of any depth: the plain versions of K2, K2b, K3 / K4 and K3u / K4u
at 9 layers (``layer_N`` 8, the first depth the CUDA entries used to refuse)
against the JAX package's Pallas kernels, interpreted; one MAPPO update at
``layer_n`` 8 on each update path (folded, unfolded, fused loss off)
against JAX's; the flax parameter trees of 9- and 32-layer
trunks through ``compat.flax_params``; the plain versions at 32 layers
against torch autograd; and the row-tile plans by depth (a CUDA device
pretended, the layouts from ``test_torch_cuda.smem_layout``).

The inputs: 40 rows (ragged against JAX's 16-row block) drawn with numpy
from a seed, 24-wide rows (critic 48) and hidden 16, every bias and LN
affine off its
init value so that each bias add and affine rounds in bf16. Relu trunks:
rows next to a kink (``relu_kink_rows``, ``relu_kink_rows_folded``) get a
zero cotangent, advantage or valid flag, since the two sides' summation
orders may put them on opposite sides. The bf16 JAX reference is compiled
with ``xla_allow_excess_precision`` off (tests/test_torch_unfolded.py).

Tolerances, those of the 2-layer tests:
- f32 K3 / K4 / K3u / K4u rtol 2e-4 and atol 5e-5 times the tensor's
  largest entry, loss sums rtol 1e-5 (tests/test_torch_fused_ppo.py). K2 and
  K2b are held to the same bound: at 9 layers each side's own f32
  rounding moves K2's output 1.4e-5 (JAX) and 1.5e-5 (the port) from an f64
  evaluation of the chain, and the two sides 2.9e-5 apart (measured at
  hidden 24), past the 2-layer test's atol 1e-5
  (tests/test_torch_fused_mlp.py), which the f32 chain meets only while it
  is shallow.
- bf16, ||port - jax|| / ||jax|| per output: K2 2e-3, K2b 4e-3 (the bounds
  of tests/test_torch_wide_hidden.py), K3 / K4 / K3u / K4u 2e-3
  (tests/test_torch_fused_ppo.py, tests/test_torch_unfolded.py).
- The f32 update: parameters atol 3e-5, metrics rtol 1e-4 / atol 1e-6
  (tests/test_torch_slice.py).
- Against autograd in f32: the K3 / K4 bound above. The folded chain is
  held to autograd through ``fold_trunk`` and the folded forward: folding
  rounds otherwise than the unfolded chain, which at 32 layers moves the
  gradients up to 7.9e-4 in relative norm (measured).

Every kernel mode runs against JAX's at 9 layers in bf16, the mode of the
card's main path. Each JAX case compiles its 9-layer kernel, about 2.5 s
here, so to keep the file near 30 s the f32 plain versions run against
torch autograd at 9 and at 32 layers, and within the f32 updates against
one JAX update by autograd, which the three paths share.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcc_tpu.algos import MAPPO as JMAPPO
from dcc_tpu.algos import MAPPOConfig as JMAPPOConfig
from dcc_tpu.algos.mappo import TrainState as JTrainState
from dcc_tpu.algos.mappo import Trajectory as JTrajectory
from dcc_tpu.envs import EnvConfig as JEnvConfig
from dcc_tpu.models.actor_critic import Actor as JActor
from dcc_tpu.models import valuenorm as JVN
from dcc_tpu.models.actor_critic import Critic as JCritic
from dcc_tpu.ops import fused_mlp as JFM
from dcc_tpu.ops import fused_ppo as JFP
from dcc_tpu.ops.fused_mlp import _pad_rows
from dcc_tpu_torch.algos import MAPPO, MAPPOConfig
from dcc_tpu_torch.compat import flax_to_state_dict, state_dict_to_flax
from dcc_tpu_torch.configs import load
from dcc_tpu_torch.envs import EnvConfig
from dcc_tpu_torch.models import Actor, Critic
from dcc_tpu_torch.ops import fused_mlp as FM
from dcc_tpu_torch.ops import fused_ppo as FP
from dcc_tpu_torch.ops import tiles
from test_torch_cuda import pretend_cuda

ROWS, BLOCK, D_IN, HIDDEN, CLIP, DELTA = 40, 16, 24, 16, 0.2, 10.0
L9 = 9
K2_REL, K2B_REL, PPO_REL = 2e-3, 4e-3, 2e-3
T = torch.from_numpy


def _params(d_in, hidden, n_layers, seed):
    """The flat trunk list, biases and LN affines off their init values."""
    rng = np.random.default_rng(seed)
    flat = [1.0 + 0.1 * rng.normal(size=d_in), 0.1 * rng.normal(size=d_in)]
    d = d_in
    for _ in range(n_layers):
        flat += [rng.normal(size=(d, hidden)) / np.sqrt(d), 0.1 * rng.normal(size=hidden),
                 1.0 + 0.1 * rng.normal(size=hidden), 0.1 * rng.normal(size=hidden)]
        d = hidden
    return [p.astype(np.float32) for p in flat]


def _jax_exact(fn, *args):
    """``fn(*args)`` compiled with every bf16 rounding kept."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64).reshape(want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _close(got, want, rtol=2e-4, atol=5e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64).reshape(want.shape), want,
                               rtol=rtol, atol=atol * max(1.0, float(np.abs(want).max())))


def _rows(d_in, seed, bf16):
    x = np.random.default_rng(seed).normal(size=(ROWS, d_in)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32)
    return xt, jnp.asarray(xt.float().numpy(), jnp.bfloat16 if bf16 else jnp.float32)


def test_plain_trunk_matches_jax_at_9_layers():
    """K2's plain forward against ``fused_mlp`` and K2b's against its custom
    VJP (``op_bwd``, the interpreted ``_bwd_kernel``), 9 relu layers, bf16."""
    bf16 = True
    params = _params(D_IN, HIDDEN, L9, 1)
    xt, xj = _rows(D_IN, 2, bf16)
    tp = [T(p) for p in params]
    g = np.random.default_rng(3).normal(size=(ROWS, HIDDEN)).astype(np.float32)
    g[FM.relu_kink_rows(xt, tp, L9, True, bf16).numpy()] = 0.0
    gt = T(g).to(xt.dtype)

    def jax_fwd_bwd(x, g):
        y, vjp = jax.vjp(lambda x, *p: JFM.fused_mlp(
            x, list(p), n_layers=L9, bf16=bf16, block_rows=BLOCK, interpret=True),
            x, *[jnp.asarray(p) for p in params])
        return y, vjp(g)

    y, (jdx, *jgrads) = _jax_exact(jax_fwd_bwd, xj, jnp.asarray(gt.float().numpy(), xj.dtype))
    kw = dict(n_layers=L9, use_fn=True, use_relu=True, bf16=bf16)
    out = FM.trunk_forward_plain(xt, tp, **kw)
    dx, grads = FM.trunk_backward_plain(xt, tp, gt, **kw)
    assert [tuple(t.shape) for t in grads] == [p.shape for p in params]
    got = [t.float().numpy() for t in [dx, *grads]]
    want = [np.asarray(w, np.float32) for w in [jdx, *jgrads]]
    assert _rel(out.float().numpy(), np.asarray(y, np.float32)) < K2_REL
    errs = [_rel(a, b) for a, b in zip(got, want)]
    assert max(errs) < K2B_REL, errs


def _ppo_case(kind, fold, bf16, n_layers, seed):
    """Parameters, rows and aux of one K3 / K4 case (relu, 9 layers): the
    port's tensors, JAX's padded ones, and the head's width."""
    d_in = D_IN if kind == "actor" else 2 * D_IN
    rng = np.random.default_rng(seed)
    params = _params(d_in, HIDDEN, n_layers, seed)
    n_out = 2 if kind == "actor" else 1
    hw = (0.3 * rng.normal(size=(HIDDEN, n_out))).astype(np.float32)
    hb = (0.1 * rng.normal(size=n_out)).astype(np.float32)
    xt, xj = _rows(d_in, seed + 1, bf16)
    tp = [T(p) for p in params]
    if fold:
        kp = FP.fold_trunk(tp, T(hw), T(hb), n_layers, True)[0]
        kink = FP.relu_kink_rows_folded(xt, kp, n_layers, True, bf16).numpy()
    else:
        kink = FM.relu_kink_rows(xt, tp, n_layers, True, bf16).numpy()
    if kind == "actor":
        act = (0.5 * rng.normal(size=(ROWS, 2))).astype(np.float32)
        old_lp = (-2.0 + 0.3 * rng.normal(size=(ROWS, 1))).astype(np.float32)
        adv = rng.normal(size=(ROWS, 1)).astype(np.float32)
        adv[kink] = 0.0
        aux = (act, old_lp, adv)
    else:
        vpred = rng.normal(size=(ROWS, 1)).astype(np.float32)
        ret = (vpred + 3.0 * rng.normal(size=(ROWS, 1))).astype(np.float32)
        valid = np.ones((ROWS, 1), np.float32)
        valid[kink] = 0.0
        aux = (vpred, ret, valid)
    return params, hw, hb, xt, xj, aux


def _port_ppo(kind, fold, bf16, n_layers, params, hw, hb, xt, aux):
    tp = [T(p) for p in params]
    if kind == "actor":
        act, old_lp, adv = aux
        return FP.actor_ppo_grads_packed(
            xt, FP.pack_actor_aux(T(act), T(old_lp), T(adv)), tp, T(hw), T(hb),
            torch.tensor([-0.3, 0.2]), n_layers=n_layers, bf16=bf16, clip_param=CLIP,
            fold=fold)
    vpred, ret, valid = aux
    a = FP.pack_critic_aux(T(vpred), T(ret))
    a[:, 2] = T(valid[:, 0])
    return FP.critic_value_grads_packed(
        xt, a, torch.tensor([0.5, 2.0]), tp, T(hw), T(hb), n_layers=n_layers, bf16=bf16,
        clip_param=CLIP, huber_delta=DELTA, fold=fold)


def _jax_ppo(kind, fold, bf16, params, hw, hb, xj, aux):
    """The JAX package's K3 / K4 (``fold``) or K3u / K4u, rows padded to the
    block."""
    xp = _pad_rows(xj, BLOCK)
    trunk = [jnp.asarray(p) for p in params]
    if kind == "actor":
        act, old_lp, adv = aux
        auxp = JFP.pack_actor_aux(jnp.asarray(act), jnp.asarray(old_lp), jnp.asarray(adv),
                                  BLOCK)
        fn = lambda x, a: JFP.actor_ppo_grads_packed(
            x, a, trunk, jnp.asarray(hw), jnp.asarray(hb), jnp.asarray([-0.3, 0.2]),
            n_layers=L9, bf16=bf16, clip_param=CLIP, act_dim=2, block_rows=BLOCK,
            interpret=True, fold=fold)
    else:
        vpred, ret, valid = aux
        auxp = JFP.pack_critic_aux(jnp.asarray(vpred), jnp.asarray(ret), BLOCK)
        auxp = auxp.at[2, :ROWS].set(jnp.asarray(valid[:, 0]))  # rows along lanes
        fn = lambda x, a: JFP.critic_value_grads_packed(
            x, a, jnp.asarray([[0.5, 2.0]], jnp.float32), trunk, jnp.asarray(hw),
            jnp.asarray(hb), n_layers=L9, bf16=bf16, clip_param=CLIP, huber_delta=DELTA,
            block_rows=BLOCK, interpret=True, fold=fold)
    return _jax_exact(fn, xp, auxp)


PPO_CASES = [(k, f, True) for k in ("actor", "critic") for f in (True, False)]


@pytest.mark.parametrize("kind,fold,bf16", PPO_CASES,
                         ids=[f"{k}-{'folded' if f else 'unfolded'}-{'bf16' if b else 'f32'}"
                              for k, f, b in PPO_CASES])
def test_plain_ppo_matches_jax_at_9_layers(kind, fold, bf16):
    """K3 / K4 (folded) and K3u / K4u (unfolded) plain versions against
    ``actor_ppo_grads_packed`` / ``critic_value_grads_packed`` at 9 relu
    layers; in bf16 the same plain version computed in f32 lands outside
    the bound."""
    seed = 10 + 4 * (kind == "critic") + 2 * fold + bf16
    params, hw, hb, xt, xj, aux = _ppo_case(kind, fold, bf16, L9, seed)
    jout = _jax_ppo(kind, fold, bf16, params, hw, hb, xj, aux)
    out = _port_ppo(kind, fold, bf16, L9, params, hw, hb, xt, aux)
    got, want = [*out[0], *out[1:]], [*jout[0], *jout[1:]]
    assert len(got) == len(want)
    got = [g.float().numpy() for g in got]
    want = [np.asarray(w, np.float32) for w in want]
    if bf16:
        errs = [_rel(g, w) for g, w in zip(got, want)]
        assert max(errs) < PPO_REL, errs
        f32 = _port_ppo(kind, fold, False, L9, params, hw, hb, xt.float(), aux)
        assert max(_rel(g.numpy(), w) for g, w in zip([*f32[0], *f32[1:]], want)) > PPO_REL
    else:
        for g, w in zip(got[:-1], want[:-1]):
            _close(g, w)
        _close(got[-1], want[-1], 1e-5, 0.0)


def _round_trip(tree, net):
    """A flax tree onto the port's module (strictly: every key on both
    sides) and back to the same leaves."""
    net.load_state_dict(flax_to_state_dict(tree))
    back = state_dict_to_flax(net.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(leaves) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in leaves:
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(leaf))


# the port's update paths at 9 layers: folded (K3 / K4), unfolded (K3u /
# K4u), and the fused loss off (autograd through K2 + K2b)
UPDATE_PATHS = {"folded": dict(fused_loss="on"),
                "unfolded": dict(fused_loss="on", fused_fold=False),
                "loss-off": dict(fused_loss="off")}


SMALL = dict(n_rollout_threads=2, episode_length=4, ppo_epoch=1, n_iters=5,
             hidden_size=HIDDEN, layer_n=8)


def _port_start(path):
    """MAPPO on ``path`` with its initial networks (``make_networks``'
    default seed: the same parameters on every path), its train state, the
    trajectory it samples from torch seed 0 and its advantages."""
    algo = MAPPO(MAPPOConfig(fused_trunk="on", **UPDATE_PATHS[path], **SMALL), EnvConfig(),
                 device="cpu")
    assert algo.fused_trunk and algo.fused_loss == (path != "loss-off")
    actor, critic = algo.make_networks()
    ts = algo.init_state(actor=actor, critic=critic)
    torch.manual_seed(0)
    traj = algo.rollout(ts, 4)
    return algo, ts, traj, *algo.compute_returns(ts, traj)


@pytest.fixture(scope="module")
def jax_update_layer_n_8():
    """The JAX package's update by autograd at 9 layers (its interpreted
    9-layer kernels would add their compile time; they stand against the
    plain versions above) from the port's initial parameters (through
    ``compat.flax_params``: flax's own 9-layer init costs seconds here,
    and JAX's modules take the port's trees, and back), trajectory and
    advantages: the trees it gave and its metrics, once for every path."""
    _, ts, traj, adv, ret = _port_start("folded")
    trees = [state_dict_to_flax(net.state_dict()) for net in (ts.actor, ts.critic)]
    for tree, net in zip(trees, (ts.actor, ts.critic)):
        assert "fc8" in tree["params"]["base"] and "norm8" in tree["params"]["base"]
        _round_trip(tree, net)
    jalgo = JMAPPO(JMAPPOConfig(fused_loss="off", fused_trunk="off", gae_backend="xla",
                                **SMALL), JEnvConfig())
    jts = JTrainState(actor_params=trees[0], critic_params=trees[1],
                      actor_opt=jalgo.actor_tx.init(trees[0]),
                      critic_opt=jalgo.critic_tx.init(trees[1]), vnorm=JVN.init(), popart=None,
                      update_count=jnp.zeros((), jnp.int32), iteration=jnp.zeros((), jnp.int32))
    jtraj = JTrajectory(*(None if v is None else jnp.asarray(v.float().numpy()) for v in traj))
    # JAX on the CPU may read the trees' arrays (views of the port's
    # parameters) after update returns: wait for it before anything writes
    # those parameters
    jts2, jm = jax.block_until_ready(jalgo.update(
        jts, jax.random.PRNGKey(4), jtraj, jnp.asarray(adv.numpy()), jnp.asarray(ret.numpy())))
    want = [flax_to_state_dict(jax.device_get(p)) for p in (jts2.actor_params,
                                                             jts2.critic_params)]
    return traj, want, np.asarray(jm)


@pytest.mark.parametrize("path", list(UPDATE_PATHS))
def test_mappo_update_matches_jax_at_layer_n_8(jax_update_layer_n_8, path):
    """The slice as a whole at 9 layers: one f32 update with the fused
    trunk on and, per ``UPDATE_PATHS``, the fused loss folded (K2 and K3 /
    K4's plain versions on the CPU), unfolded (K3u / K4u's) or off (K2b's
    under autograd), against the JAX package's update by autograd
    (``jax_update_layer_n_8``) from the same parameters, trajectory (the
    port's sampled rollout) and advantages."""
    jtraj, want, jm = jax_update_layer_n_8
    algo, ts, traj, adv, ret = _port_start(path)
    for a, b in zip(traj, jtraj):
        assert (a is None and b is None) or torch.equal(a, b)
    m = algo.update(ts, traj, adv, ret)
    for net, want_sd in zip((ts.actor, ts.critic), want):
        got = net.state_dict()
        assert set(got) == set(want_sd)
        for k in want_sd:
            np.testing.assert_allclose(got[k].numpy(), want_sd[k].numpy(), atol=3e-5,
                                       err_msg=k)
    np.testing.assert_allclose(m.numpy(), jm, rtol=1e-4, atol=1e-6)


def test_flax_params_map_32_layer_trunks():
    """32-layer trunks (``layer_n`` 31): the port's Actor and Critic map to
    trees of the flax modules' own structure and shapes (every layer's
    Dense and LayerNorm; ``jax.eval_shape`` of their init, whose eager
    orthogonal init costs seconds here) and back, and the flax modules on
    those trees give the port's fused trunk's outputs (K2's plain version,
    f32) within the f32 bound (the 9-layer trees: the update test's)."""
    obs = np.random.default_rng(31).normal(size=(5, 12)).astype(np.float32)
    for jnet, net in ((JActor(hidden_size=8, layer_n=31, action_dim=2),
                       Actor(12, 2, hidden_size=8, layer_n=31, fused=True)),
                      (JCritic(hidden_size=8, layer_n=31),
                       Critic(12, hidden_size=8, layer_n=31, fused=True))):
        tree = state_dict_to_flax(net.state_dict())
        shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), obs))
        assert (jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(shapes))
        assert ([np.shape(a) for a in jax.tree_util.tree_leaves(tree)]
                == [a.shape for a in jax.tree_util.tree_leaves(shapes)])
        assert "fc31" in tree["params"]["base"] and "norm31" in tree["params"]["base"]
        _round_trip(tree, net)
        with torch.no_grad():
            got = net(T(obs))
        want = jax.jit(jnet.apply)(tree, obs)[0]
        if isinstance(net, Actor):  # (mean, log_std)
            got, want = got[0], want[0]
        _close(got.numpy(), want)


def _autograd_loss(kind, fold, params, hw, hb, x, aux, n_layers):
    """The stock f32 loss by torch autograd: the trunk (``trunk_forward_plain``,
    or with ``fold`` the folded chain on ``fold_trunk``'s parameters, which
    rounds otherwise) and the head, then the clipped surrogate (actor,
    log_std [-0.3, 0.2]) or the clipped one-sided Huber value loss (critic,
    norm [0.5, 2])."""
    leaves = [T(p).requires_grad_() for p in [*params, hw, hb]]
    if fold:
        kp, whf, bhf = FP.fold_trunk(leaves[:-2], leaves[-2], leaves[-1], n_layers, True)
        out = FP._fwd_folded(x, kp, n_layers, True, True, False)[0] @ whf + bhf
    else:
        out = FM.trunk_forward_plain(x, leaves[:-2], n_layers) @ leaves[-2] + leaves[-1]
    if kind == "actor":
        log_std = torch.tensor([-0.3, 0.2], requires_grad=True)
        leaves.append(log_std)
        act, old_lp, adv = (T(a) for a in aux)
        z = (act - out) * torch.exp(-log_std)
        lp = torch.sum(-0.5 * z * z - log_std - FP.LOG_SQRT_2PI, dim=1, keepdim=True)
        ratio = torch.exp(lp - old_lp)
        loss = torch.sum(-torch.minimum(ratio * adv, torch.clamp(ratio, 1 - CLIP, 1 + CLIP) * adv))
    else:
        vpred, ret, valid = (T(a) for a in aux)
        target = (ret - 0.5) / 2.0
        v_clip = vpred + torch.clamp(out - vpred, -CLIP, CLIP)
        loss = torch.sum(torch.maximum(FP.huber(target - out, DELTA),
                                       FP.huber(target - v_clip, DELTA)) * valid)
    loss.backward()
    return [t.grad.numpy() for t in leaves], float(loss.detach())


@pytest.mark.parametrize("n_layers", [9, 32])
@pytest.mark.parametrize("kind,fold", [(k, f) for k in ("actor", "critic")
                                       for f in (True, False)])
def test_plain_twins_match_autograd(kind, fold, n_layers):
    """The f32 plain K3 / K4 (folded) and K3u / K4u (unfolded) against torch
    autograd of the stock loss, and K2b's plain version against autograd
    of K2's (the trunk's gradients and dx), at 9 and at 32 layers, where
    JAX's interpreted kernels cost too much time on the CPU."""
    params, hw, hb, xt, _, aux = _ppo_case(kind, fold, False, n_layers, 40 + 2 * fold)
    out = _port_ppo(kind, fold, False, n_layers, params, hw, hb, xt, aux)
    want, loss = _autograd_loss(kind, fold, params, hw, hb, xt, aux, n_layers)
    got = [*out[0], *out[1:-1]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    _close(out[-1][0].numpy(), loss, 1e-5, 0.0)
    if kind == "actor" and fold:
        x = xt.clone().requires_grad_()
        leaves = [T(p).requires_grad_() for p in params]
        g = torch.from_numpy(np.random.default_rng(7).normal(size=(ROWS, HIDDEN))
                             .astype(np.float32))
        (FM.trunk_forward_plain(x, leaves, n_layers) * g).sum().backward()
        dx, grads = FM.trunk_backward_plain(xt, [T(p) for p in params], g, n_layers)
        for a, b in zip([dx, *grads], [x.grad, *[t.grad for t in leaves]]):
            _close(a.numpy(), b.numpy())


# (kernel, row width, head width) at the default env's widths and the first
# depth at which no staged, chunked or LAST tile holds the trunk at hidden
# 256 (PERF.md section 6: the deepest trunks the smallest tiles hold)
FIRST_DEEP = {("actor_ppo_grads", 110, 2): 16, ("actor_ppo_grads_unfolded", 110, 2): 15,
              ("critic_ppo_grads", 440, 1): 15, ("critic_ppo_grads_unfolded", 440, 1): 15,
              ("fused_mlp_bwd", 440, 1): 15, ("fused_mlp_bwd", 110, 1): 16,
              ("critic_ppo_grads", 4840, 1): 15}


def test_tile_plans_by_depth(monkeypatch):
    """With a CUDA device pretended: at every depth a staged, chunked or
    LAST tile holds (all of 1 to 8 layers), each bf16 gradient kernel keeps
    the tiles it takes without a depth layout; from the first depth none
    does, and at 32 layers, it takes its depth layout; K2's plan does not
    depend on the depth."""
    pretend_cuda(monkeypatch)
    for (kernel, width, n_head), first in FIRST_DEEP.items():
        for n_layers in [*range(1, first + 1), 32]:
            p = tiles.plan(kernel, True, width, 256, n_layers, n_head)
            assert p.tiles, (kernel, n_layers)
            assert p.deep == (n_layers >= first), (kernel, n_layers)
            if n_layers < first:
                with monkeypatch.context() as m:
                    m.setattr(tiles, "DEEP", {})
                    assert p == tiles.plan(kernel, True, width, 256, n_layers, n_head)
    for n_layers in (1, 9, 32):
        p = tiles.plan("fused_mlp", True, 440, 256, n_layers)
        assert p == (False, [64, 32, 16], False, False)
    # MAPPO builds with every fused kernel on at every depth from 1 to 32
    # layers, bf16 and f32
    _, env_cfg, algo_cfg = load()
    for layer_n in range(32):
        for dtype in ("bfloat16", "float32"):
            algo = MAPPO(algo_cfg._replace(compute_dtype=dtype, layer_n=layer_n,
                                           fused_loss="on", fused_trunk="on"),
                         env_cfg, device="cuda")
            assert algo.fused_trunk and algo.fused_loss
