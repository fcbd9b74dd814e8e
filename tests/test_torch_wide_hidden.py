"""ROADMAP B3's hidden widths: the plain versions of K2, K2b, K3 / K4 and K3u
/ K4u against the JAX package's Pallas kernels (interpreted, compiled with
XLA's ``xla_allow_excess_precision`` off as in tests/test_torch_unfolded.py,
so that every bf16 rounding point is kept) at hidden widths the CUDA
kernels run in column passes (264, 300, 512) or zero-pad off multiples of 8
(24, 65, 100), in bf16; one bf16 fused update at hidden 300 against JAX's;
and MAPPO's construction on CUDA at those widths.

The inputs: 70 rows drawn with numpy from a seed, two layers (``layer_N``
1), every bias and LN affine moved off its init value so that each bias add
and affine rounds in bf16. Each width runs one trunk, relu or tanh, so that
both run at one and at several column passes. Relu trunks: rows with a
pre-activation within one bf16 step of the kink (``relu_kink_rows``, and
the folded chain's ``relu_kink_rows_folded``) get a zero cotangent (K2b), a
zero advantage (K3, K3u) or valid = 0 (K4, K4u), since the two sides'
summation orders may put them on opposite sides.

Tolerances, ||port - jax|| / ||jax|| per output tensor, those of
``PERF.md`` section 6 for the kernels: K2 2e-3, K2b 4e-3, K3 / K4 / K3u /
K4u 4e-3. The update: each network's parameter change within 0.05 of
JAX's (relative L2 distance) and every parameter within 1e-3 (the bounds of
tests/test_torch_separated_update.py: at hidden 300 Adam turns bf16
rounding flips of near-zero gradients into steps of the learning rate,
measured up to 4.6e-4 on a parameter, 1.5e-2 relative), the port's update
in f32 outside them; metrics within rtol 2e-3 / atol 1e-5,
tests/test_torch_slice.py's bf16 bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcc_tpu.algos import MAPPO as JMAPPO
from dcc_tpu.algos import MAPPOConfig as JMAPPOConfig
from dcc_tpu.envs import EnvConfig as JEnvConfig
from dcc_tpu.ops import fused_mlp as JFM
from dcc_tpu.ops import fused_ppo as JFP
from dcc_tpu.ops.fused_mlp import _pad_rows
from dcc_tpu_torch.algos import MAPPO, MAPPOConfig
from dcc_tpu_torch.compat import flax_to_state_dict
from dcc_tpu_torch.configs import load
from dcc_tpu_torch.envs import EnvConfig
from dcc_tpu_torch.ops import fused_mlp as FM
from dcc_tpu_torch.ops import fused_ppo as FP
from dcc_tpu_torch.ops import tiles
from test_torch_cuda import _clip_kink_rows, pretend_cuda
from test_torch_slice import _to_torch

ROWS, BLOCK, CLIP = 70, 32, 0.2
K2_REL, K2B_REL, PPO_REL = 2e-3, 4e-3, 4e-3
# (hidden width, relu trunk): within one column pass (24, 65 odd, 100) and
# over two (264, 300, 512)
WIDTHS = [(24, True), (65, False), (100, True), (264, False), (300, True), (512, False)]


def _params(d_in, hidden, seed):
    """The flat trunk list, biases and LN affines off their init values."""
    rng = np.random.default_rng(seed)
    flat = [1.0 + 0.1 * rng.normal(size=d_in), 0.1 * rng.normal(size=d_in)]
    d = d_in
    for _ in range(2):
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


def _rows(d_in, seed):
    x = np.random.default_rng(seed).normal(size=(ROWS, d_in)).astype(np.float32)
    # the stored bf16 rows, the same numbers on both sides
    xt = torch.from_numpy(x).to(torch.bfloat16)
    return xt, jnp.asarray(xt.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("hidden,relu", WIDTHS)
def test_plain_trunk_matches_jax_at_wide_hidden(hidden, relu):
    """K2's plain forward against ``fused_mlp`` and K2b's against its custom
    VJP (``op_bwd``, the interpreted ``_bwd_kernel``)."""
    check_plain_trunk(hidden, relu)


def check_plain_trunk(hidden: int, relu: bool):
    """K2's and K2b's plain versions against the JAX package's at hidden
    width ``hidden``, a relu or a tanh trunk."""
    params = _params(110, hidden, hidden)
    xt, xj = _rows(110, hidden + 1)
    tp = [torch.from_numpy(p) for p in params]
    g = np.random.default_rng(hidden + 2).normal(size=(ROWS, hidden)).astype(np.float32)
    if relu:
        g[FM.relu_kink_rows(xt, tp, 2, True, True).numpy()] = 0.0
    g = torch.from_numpy(g).to(torch.bfloat16)

    def jax_fwd_bwd(x, g):
        y, vjp = jax.vjp(lambda x, *p: JFM.fused_mlp(
            x, list(p), n_layers=2, use_relu=relu, bf16=True, block_rows=BLOCK,
            interpret=True), x, *[jnp.asarray(p) for p in params])
        return y, vjp(g)

    y, (jdx, *jgrads) = _jax_exact(jax_fwd_bwd, xj, jnp.asarray(g.float().numpy(),
                                                                jnp.bfloat16))
    kw = dict(n_layers=2, use_fn=True, use_relu=relu, bf16=True)
    out = FM.trunk_forward_plain(xt, tp, **kw)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (ROWS, hidden)
    assert _rel(out.float().numpy(), np.asarray(y, np.float32)) < K2_REL
    dx, grads = FM.trunk_backward_plain(xt, tp, g, **kw)
    assert [tuple(t.shape) for t in grads] == [p.shape for p in params]
    errs = [_rel(t.float().numpy(), np.asarray(w, np.float32))
            for t, w in zip([dx, *grads], [jdx, *jgrads])]
    assert max(errs) < K2B_REL, errs


def _jax_ppo(kind, fold, relu, params, hw, hb, xj, aux_np):
    """The JAX package's K3 / K4 (``fold``) or K3u / K4u on ``xj``, rows
    padded to the block."""
    xp = _pad_rows(xj, BLOCK)
    trunk = [jnp.asarray(p) for p in params]
    if kind == "actor":
        act, old_lp, adv = aux_np
        auxp = JFP.pack_actor_aux(jnp.asarray(act), jnp.asarray(old_lp), jnp.asarray(adv),
                                  BLOCK)
        fn = lambda x, a: JFP.actor_ppo_grads_packed(
            x, a, trunk, jnp.asarray(hw), jnp.asarray(hb), jnp.asarray([-0.3, 0.2]),
            n_layers=2, use_relu=relu, bf16=True, clip_param=CLIP, act_dim=2,
            block_rows=BLOCK, interpret=True, fold=fold)
    else:
        vpred, ret, valid = aux_np
        auxp = JFP.pack_critic_aux(jnp.asarray(vpred), jnp.asarray(ret), BLOCK)
        auxp = auxp.at[2, :ROWS].set(jnp.asarray(valid[:, 0]))  # rows along lanes
        fn = lambda x, a: JFP.critic_value_grads_packed(
            x, a, jnp.asarray([[0.5, 2.0]], jnp.float32), trunk, jnp.asarray(hw),
            jnp.asarray(hb), n_layers=2, use_relu=relu, bf16=True, clip_param=CLIP,
            block_rows=BLOCK, interpret=True, fold=fold)
    return _jax_exact(fn, xp, auxp)


# each kernel at three widths: (kind, fold) -> widths
PPO_CASES = [("actor", True, w) for w in WIDTHS[0::2]] + \
            [("critic", False, w) for w in WIDTHS[0::2]] + \
            [("actor", False, w) for w in WIDTHS[1::2]] + \
            [("critic", True, w) for w in WIDTHS[1::2]]


@pytest.mark.parametrize("kind,fold,width", PPO_CASES,
                         ids=[f"{k}-{'folded' if f else 'unfolded'}-{w[0]}"
                              for k, f, w in PPO_CASES])
def test_plain_ppo_matches_jax_at_wide_hidden(kind, fold, width):
    """K3 / K4 (folded) and K3u / K4u (unfolded) plain versions against
    ``actor_ppo_grads_packed`` / ``critic_value_grads_packed``."""
    check_plain_ppo(kind, fold, width)


def check_plain_ppo(kind: str, fold: bool, width: tuple, policy_ratios: bool = False):
    """The ``kind`` ("actor" or "critic") PPO kernel's plain version, folded
    or not, against the JAX package's at ``width`` (hidden, relu). With
    ``policy_ratios`` the actor's rows are a rollout's: actions drawn from
    the policy (the plain chain's means and ``log_std``), old
    log-probabilities within 0.3 of the policy's own, as
    tests/test_torch_unfolded.py draws them, so that every row's ratio is
    near 1 and carries its share of the gradient (actions drawn around 0 and
    old log-probabilities around -2 leave most ratios near 0, and a row or
    two carry the whole gradient); its rows within one bf16 step of a head
    output from the clip's kink then get a zero advantage
    (tests/test_torch_cuda.py's ``_clip_kink_rows``, which its wide-hidden
    checks apply), where one summation order's mean can take the other
    branch of the clipped surrogate, and the row's whole cotangent with
    it."""
    hidden, relu = width
    d_in = 110 if kind == "actor" else 440
    rng = np.random.default_rng(hidden + d_in)
    params = _params(d_in, hidden, hidden + d_in)
    n_out = 2 if kind == "actor" else 1
    hw = (0.1 * rng.normal(size=(hidden, n_out))).astype(np.float32)
    hb = (0.1 * rng.normal(size=n_out)).astype(np.float32)
    xt, xj = _rows(d_in, hidden + d_in + 1)
    tp = [torch.from_numpy(p) for p in params]
    kink = np.zeros(ROWS, bool)
    if relu:
        if fold:
            kp = FP.fold_trunk(tp, torch.from_numpy(hw), torch.from_numpy(hb), 2, True)[0]
            kink = FP.relu_kink_rows_folded(xt, kp, 2, True).numpy()
        else:
            kink = FM.relu_kink_rows(xt, tp, 2, True, True).numpy()
    T = torch.from_numpy
    if kind == "actor":
        act = (0.5 * rng.normal(size=(ROWS, 2))).astype(np.float32)
        old_lp = (-2.0 + 0.3 * rng.normal(size=(ROWS, 1))).astype(np.float32)
        adv = rng.normal(size=(ROWS, 1)).astype(np.float32)
        adv[kink] = 0.0
        if policy_ratios:
            ls = torch.tensor([-0.3, 0.2])
            if fold:
                kp, whf, bhf = FP.fold_trunk(tp, T(hw), T(hb), 2, True)
                feat = FP._fwd_folded(xt, kp, 2, True, relu, True)[0]
            else:
                feat, whf, bhf = FM._forward_chain(xt, tp, 2, True, relu, True)[0], T(hw), T(hb)
            mean = FM.dense(feat, whf, bhf, True)
            act = (mean + torch.exp(ls) * T(rng.normal(size=(ROWS, 2)).astype(np.float32))).numpy()
            z = (T(act) - mean) * torch.exp(-ls)
            lp = torch.sum(-0.5 * z * z - ls - FP.LOG_SQRT_2PI, dim=1, keepdim=True)
            old_lp = (lp.numpy() + 0.3 * rng.normal(size=(ROWS, 1))).astype(np.float32)
            aux = FP.pack_actor_aux(T(act), T(old_lp), T(adv))
            adv[_clip_kink_rows(feat, aux, whf, bhf, ls).numpy()] = 0.0
        jout = _jax_ppo(kind, fold, relu, params, hw, hb, xj, (act, old_lp, adv))
        out = FP.actor_ppo_grads_packed(
            xt, FP.pack_actor_aux(T(act), T(old_lp), T(adv)), tp, T(hw), T(hb),
            torch.tensor([-0.3, 0.2]), n_layers=2, use_relu=relu, bf16=True,
            clip_param=CLIP, fold=fold)
    else:
        vpred = rng.normal(size=(ROWS, 1)).astype(np.float32)
        ret = (vpred + 3.0 * rng.normal(size=(ROWS, 1))).astype(np.float32)
        valid = np.ones((ROWS, 1), np.float32)
        valid[kink] = 0.0
        jout = _jax_ppo(kind, fold, relu, params, hw, hb, xj, (vpred, ret, valid))
        aux = FP.pack_critic_aux(T(vpred), T(ret))
        aux[:, 2] = T(valid[:, 0])
        out = FP.critic_value_grads_packed(
            xt, aux, torch.tensor([0.5, 2.0]), tp, T(hw), T(hb), n_layers=2, use_relu=relu,
            bf16=True, clip_param=CLIP, fold=fold)
    got, want = [*out[0], *out[1:]], [*jout[0], *jout[1:]]
    assert len(got) == len(want)
    errs = [_rel(g.float().numpy(), np.asarray(w, np.float32)) for g, w in zip(got, want)]
    assert max(errs) < PPO_REL, errs


# the bf16 update's bounds per network (tests/test_torch_separated_update.py's:
# no bound on single parameters as tight as 1e-4 holds, since Adam turns a
# bf16 rounding that flips a near-zero gradient into a step of the learning
# rate): the relative distance of its parameter change from JAX's, and its
# largest parameter gap
UPDATE_REL, UPDATE_ABS = 0.05, 1e-3


def _update(hidden: int = 300, exact: bool = False):
    """One update at hidden width ``hidden`` from the same parameters and
    trajectory: JAX's in bf16 (its kernels interpreted; with ``exact``,
    compiled with every bf16 rounding kept, ``_jax_exact``), then the
    port's in bf16 and in f32. Returns the port's {dtype: ((actor, critic)
    state dicts, metrics)}, JAX's (actor, critic) before and after, and its
    metrics."""
    small = dict(n_rollout_threads=4, episode_length=8, ppo_epoch=2, n_iters=5,
                 hidden_size=hidden)
    jalgo = JMAPPO(JMAPPOConfig(fused_loss="interpret", fused_trunk="interpret",
                                gae_backend="xla", fused_block_rows=BLOCK,
                                compute_dtype="bfloat16", **small), JEnvConfig())
    jts = jalgo.init_state(jax.random.PRNGKey(0))
    jtraj = jalgo.rollout(jts, jax.random.PRNGKey(3), 4)
    jadv, jret = jalgo.compute_returns(jts, jtraj)
    update = lambda *a: jalgo.update(jts, jax.random.PRNGKey(4), *a)
    jts2, jm = (_jax_exact(update, jtraj, jadv, jret) if exact
                else update(jtraj, jadv, jret))
    port = {}
    for dtype in ("bfloat16", "float32"):
        algo = MAPPO(MAPPOConfig(fused_loss="on", fused_trunk="on", compute_dtype=dtype,
                                 **small), EnvConfig(), device="cpu")
        actor, critic = algo.make_networks()
        actor.load_state_dict(flax_to_state_dict(jax.device_get(jts.actor_params)))
        critic.load_state_dict(flax_to_state_dict(jax.device_get(jts.critic_params)))
        ts = algo.init_state(actor=actor, critic=critic)
        m = algo.update(ts, _to_torch(jtraj), torch.from_numpy(np.array(jadv)),
                        torch.from_numpy(np.array(jret)))
        port[dtype] = ((ts.actor.state_dict(), ts.critic.state_dict()), m)
    jax_sd = lambda t: tuple(flax_to_state_dict(jax.device_get(p))
                             for p in (t.actor_params, t.critic_params))
    return port, jax_sd(jts), jax_sd(jts2), jm


def _gaps(port, start, end):
    """Per network: ||change - JAX's change|| / ||JAX's change|| and the
    largest |parameter - JAX's|."""
    out = []
    for got, s0, want in zip(port, start, end):
        assert set(got) == set(want)
        num = sum(float((got[k] - want[k]).square().sum()) for k in want)
        den = sum(float((want[k] - s0[k]).square().sum()) for k in want)
        out.append(((num / den) ** 0.5, max(float((got[k] - want[k]).abs().max())
                                            for k in want)))
    return out


def test_bf16_update_matches_jax_at_hidden_300():
    """The slice as a whole at hidden 300 (two column passes on the card):
    one bf16 update with the fused loss on (K3 / K4's plain versions on the
    CPU) against the JAX package's, from the same parameters and
    trajectory: each network within ``UPDATE_REL`` and ``UPDATE_ABS``, the
    metrics within rtol 2e-3 / atol 1e-5; the port's update in f32 lies
    outside the parameter bounds."""
    port, start, end, jm = _update()
    params, m = port["bfloat16"]
    for rel, gap in _gaps(params, start, end):
        assert rel < UPDATE_REL and gap < UPDATE_ABS, (rel, gap)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=2e-3, atol=1e-5)
    f32 = _gaps(port["float32"][0], start, end)
    assert any(rel > UPDATE_REL or gap > UPDATE_ABS for rel, gap in f32), f32


# the row tiles each bf16 kernel takes at the default env's widths (actor
# 110, critic 440), by hidden width, from the tests' mirror of the layouts:
# (kernel, row width, head width) -> (chunked, tiles)
BUILD_TILES = {
    100: {("actor_ppo_grads", 110, 2): (False, [64, 32]),
          ("critic_ppo_grads", 440, 1): (False, [32, 16])},
    300: {("actor_ppo_grads", 110, 2): (False, [32]),
          ("critic_ppo_grads", 440, 1): (False, [32, 16]),
          ("fused_mlp_bwd", 440, 1): (False, [32, 16])},
    512: {("actor_ppo_grads", 110, 2): (False, [32]),
          ("critic_ppo_grads", 440, 1): (False, [16]),
          ("fused_mlp_bwd", 440, 1): (False, [16])},
    1024: {("actor_ppo_grads", 110, 2): (False, [16]),
           ("actor_ppo_grads_unfolded", 110, 2): (False, [16]),
           ("critic_ppo_grads", 440, 1): (False, [16]),
           ("critic_ppo_grads_unfolded", 440, 1): (True, [16]),
           ("fused_mlp", 440, 1): (False, [32, 16]),
           ("fused_mlp_bwd", 440, 1): (False, [16])},
}


@pytest.mark.parametrize("hidden", list(BUILD_TILES))
def test_mappo_builds_with_fused_kernels_at_wide_hidden(monkeypatch, hidden):
    """MAPPO in bf16 builds on CUDA with the fused trunk and the fused loss on
    at hidden 100, 300, 512 and 1,024 (a CUDA device pretended, the
    kernels' layouts from ``smem_layout``); the tile each kernel takes: the
    actor's 16-row staged tile only where no larger one fits."""
    pretend_cuda(monkeypatch)
    _, env_cfg, algo_cfg = load()
    algo = MAPPO(algo_cfg._replace(compute_dtype="bfloat16", hidden_size=hidden), env_cfg,
                 device="cuda")
    assert algo.fused_trunk and algo.fused_loss
    for (kernel, width, n_head), want in BUILD_TILES[hidden].items():
        assert tiles.plan(kernel, True, width, hidden, 2, n_head) == (*want, False, False), kernel


# the row tiles each bf16 gradient kernel takes at the default widths at
# layer_n 8 and 31 (9 and 32 layers): (chunked, tiles, depth layout)
DEEP_TILES = {
    8: {("actor_ppo_grads", 110, 2): (False, [16], False),
        ("actor_ppo_grads_unfolded", 110, 2): (False, [16], False),
        ("critic_ppo_grads", 440, 1): (False, [16], False),
        ("critic_ppo_grads_unfolded", 440, 1): (False, [16], False),
        ("fused_mlp_bwd", 440, 1): (False, [16], False)},
    31: {("actor_ppo_grads", 110, 2): (False, [64, 32], True),
         ("actor_ppo_grads_unfolded", 110, 2): (False, [64, 32], True),
         ("critic_ppo_grads", 440, 1): (False, [32, 16], True),
         ("critic_ppo_grads_unfolded", 440, 1): (False, [32, 16], True),
         ("fused_mlp_bwd", 440, 1): (False, [32, 16], True)},
}


@pytest.mark.parametrize("layer_n", list(DEEP_TILES), ids=["layer-n-8", "layer-n-31"])
def test_mappo_builds_deep_trunks_with_fused_kernels(monkeypatch, layer_n):
    """More than 8 layers, which MAPPO used to refuse: in bf16 it builds on
    CUDA with the fused trunk and loss on, and each gradient kernel takes
    the tiles listed (at 32 layers its depth layout)."""
    pretend_cuda(monkeypatch)
    _, env_cfg, algo_cfg = load()
    algo = MAPPO(algo_cfg._replace(compute_dtype="bfloat16", layer_n=layer_n), env_cfg,
                 device="cuda")
    assert algo.fused_trunk and algo.fused_loss
    for (kernel, width, n_head), (chunked, sizes, deep) in DEEP_TILES[layer_n].items():
        p = tiles.plan(kernel, True, width, 256, layer_n + 1, n_head)
        assert p == (chunked, sizes, deep, False), kernel
