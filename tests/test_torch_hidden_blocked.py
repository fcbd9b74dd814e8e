"""Hidden widths past 1,024 (ROADMAP B3 rest), where the bf16 CUDA kernels
take their column-blocked layout: the plain versions of K2, K2b, K3 / K4
and K3u / K4u against the JAX package's Pallas kernels (interpreted, with
XLA's ``xla_allow_excess_precision`` off, as tests/test_torch_wide_hidden.py
runs them) at hidden 1,152 (a partial last column pass) and 2,048; one bf16
fused update at hidden 2,048 against JAX's (compiled with every bf16
rounding kept); and MAPPO's construction on a
pretended CUDA device at 1,152, 2,048 and 4,096 with every fused kernel on,
each launch planned in the column-blocked layout or, where a tile of its
earlier layouts still fits, in that one.

The inputs, the relu-kink rules and the tolerances are
tests/test_torch_wide_hidden.py's (70 rows, two layers, biases and LN
affines off their init values), but the actor's rows are a rollout's:
actions drawn from the policy and old log-probabilities within 0.3 of its
own, as tests/test_torch_unfolded.py draws them, so that every row's ratio
is near 1 (with that file's actions and old log-probabilities, at hidden
2,048 one row's ratio carries the whole gradient, and a one-bf16-step
feature gap in that row reads as the kernel's error), with the rows at
the clip's kink given a zero advantage, as tests/test_torch_cuda.py's
wide-hidden checks give them; ||port - jax|| / ||jax|| per output tensor
below K2 2e-3, K2b 4e-3, K3 / K4 / K3u / K4u 4e-3; the update's networks
within 0.05 (relative distance of the parameter change) and 1e-3 (largest
parameter gap) of JAX's, its metrics within rtol 2e-3 / atol 1e-5, the
port's update in f32 outside the parameter bounds.
"""

import numpy as np
import pytest
import torch

from dcc_tpu_torch.algos import MAPPO
from dcc_tpu_torch.configs import load
from dcc_tpu_torch.ops import tiles
from test_torch_cuda import pretend_cuda
from test_torch_wide_hidden import (UPDATE_ABS, UPDATE_REL, _gaps, _update, check_plain_ppo,
                                    check_plain_trunk)

# (hidden width, relu trunk): a relu trunk at 1,152 (four full column passes
# and a partial one of 128), a tanh trunk at 2,048 (eight full ones)
WIDTHS = [(1152, True), (2048, False)]
# each gradient kernel at both: (kind, fold, width). K3u's at 2,048 is a relu
# trunk: its tanh chain there puts the two bf16 versions past this file's
# bound on these inputs, each as far from the f32 chain as the other and
# several times farther than from each other
PPO_CASES = [(kind, fold, w) for kind in ("actor", "critic") for fold in (True, False)
             for w in (WIDTHS[0], (2048, kind == "actor" and not fold))]


@pytest.mark.parametrize("hidden,relu", WIDTHS)
def test_plain_trunk_matches_jax_past_1024(hidden, relu):
    """K2's plain forward against ``fused_mlp`` and K2b's against its custom
    VJP, at the column-blocked layout's widths."""
    check_plain_trunk(hidden, relu)


@pytest.mark.parametrize("kind,fold,width", PPO_CASES,
                         ids=[f"{k}-{'folded' if f else 'unfolded'}-{w[0]}"
                              for k, f, w in PPO_CASES])
def test_plain_ppo_matches_jax_past_1024(kind, fold, width):
    """K3 / K4 (folded) and K3u / K4u (unfolded) plain versions against
    ``actor_ppo_grads_packed`` / ``critic_value_grads_packed``."""
    check_plain_ppo(kind, fold, width, policy_ratios=True)


def test_bf16_update_matches_jax_at_hidden_2048():
    """The slice as a whole at hidden 2,048, where every bf16 gradient kernel
    takes the column-blocked layout on the card: one bf16 update with the
    fused loss on (K3 / K4's plain versions on the CPU) against the JAX
    package's, from the same parameters and trajectory, JAX's compiled with
    every bf16 rounding kept (at this width XLA's default excess precision
    on the CPU moves JAX's own value loss by more than the metrics' bound)."""
    port, start, end, jm = _update(2048, exact=True)
    params, m = port["bfloat16"]
    for rel, gap in _gaps(params, start, end):
        assert rel < UPDATE_REL and gap < UPDATE_ABS, (rel, gap)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=2e-3, atol=1e-5)
    f32 = _gaps(port["float32"][0], start, end)
    assert any(rel > UPDATE_REL or gap > UPDATE_ABS for rel, gap in f32), f32


# the plans of the default config's launches (actor rows 110, critic 440),
# from the tests' mirror of the layouts, by hidden width: (kernel, row width,
# head width) -> (chunked, tiles, column-blocked). K2 keeps its staged tiles
# up to 2,816, then takes the column-blocked layout
BLOCKED_PLANS = {
    1152: {("fused_mlp", 110, 1): (False, [32, 16], False),
           ("fused_mlp", 440, 1): (False, [32, 16], False),
           ("fused_mlp_bwd", 440, 1): (False, [64, 32, 16], True),
           ("actor_ppo_grads", 110, 2): (False, [64, 32, 16], True),
           ("critic_ppo_grads", 440, 1): (False, [32, 16], True),
           ("actor_ppo_grads_unfolded", 110, 2): (False, [64, 32, 16], True),
           ("critic_ppo_grads_unfolded", 440, 1): (False, [32, 16], True)},
    2048: {("fused_mlp", 110, 1): (False, [16], False),
           ("fused_mlp", 440, 1): (False, [16], False),
           ("fused_mlp_bwd", 110, 1): (False, [64, 32, 16], True),
           ("actor_ppo_grads", 110, 2): (False, [64, 32, 16], True),
           ("critic_ppo_grads", 440, 1): (False, [32, 16], True),
           ("actor_ppo_grads_unfolded", 110, 2): (False, [64, 32, 16], True),
           ("critic_ppo_grads_unfolded", 440, 1): (False, [32, 16], True)},
    4096: {("fused_mlp", 110, 1): (False, [64, 32, 16], True),
           ("fused_mlp", 440, 1): (False, [64, 32, 16], True),
           ("fused_mlp_bwd", 440, 1): (False, [64, 32, 16], True),
           ("actor_ppo_grads", 110, 2): (False, [64, 32, 16], True),
           ("critic_ppo_grads", 440, 1): (False, [32, 16], True),
           ("actor_ppo_grads_unfolded", 110, 2): (False, [64, 32, 16], True),
           ("critic_ppo_grads_unfolded", 440, 1): (False, [32, 16], True)},
}


@pytest.mark.parametrize("hidden", list(BLOCKED_PLANS))
def test_mappo_builds_with_fused_kernels_past_1024(monkeypatch, hidden):
    """MAPPO in bf16 builds on CUDA with the fused trunk and the fused loss
    on (a CUDA device pretended, the kernels' layouts from ``smem_layout``)
    at hidden widths every kernel used to refuse past 1,024, folded and
    unfolded and with the fused loss off; each launch takes the plan listed:
    the gradient kernels the column-blocked layout, K2 its staged tiles
    while one fits."""
    pretend_cuda(monkeypatch)
    _, env_cfg, algo_cfg = load()
    for over in ({}, {"fused_fold": False}, {"fused_loss": "off"}):
        algo = MAPPO(algo_cfg._replace(compute_dtype="bfloat16", hidden_size=hidden, **over),
                     env_cfg, device="cuda")
        assert algo.fused_trunk and algo.fused_loss == ("fused_loss" not in over)
    for (kernel, width, n_head), (chunked, sizes, blocked) in BLOCKED_PLANS[hidden].items():
        p = tiles.plan(kernel, True, width, hidden, 2, n_head)
        assert p == (chunked, sizes, False, blocked), kernel
        # forced, the column-blocked layout keeps the tiles and first layer
        assert tiles.plan(kernel, True, width, hidden, 2, n_head, blocked=True) == (
            chunked, sizes, False, True), kernel


def test_blocked_layout_takes_what_the_others_take(monkeypatch):
    """Every launch that fits a staged, chunked, ``LAST`` or depth tile keeps
    its layout and tile (hidden 24 to 6,144, 2, 9 and 32 layers, the
    default, 20-UAV and many-PoI row widths): the plan is the one without
    the column-blocked layout wherever that one has a tile, and
    column-blocked only where it has none; the column-blocked first layer is
    the chunked one exactly where the row is chunked at hidden 256."""
    pretend_cuda(monkeypatch)
    for (kernel, bf16), _ in tiles.BLOCKED.items():
        n_head = 2 if kernel.startswith("actor") else 1
        for width in (110, 242, 440, 1510, 4840, 6040):
            for hidden in (24, 256, 300, 1024, 1152, 2048, 4096, 6144):
                for n_layers in (2, 9, 32):
                    p = tiles.plan(kernel, True, width, hidden, n_layers, n_head)
                    with monkeypatch.context() as m:
                        m.setattr(tiles, "BLOCKED", {})
                        without = tiles.plan(kernel, True, width, hidden, n_layers, n_head)
                    assert p.tiles, (kernel, width, hidden, n_layers)
                    assert p == without if without.tiles else p.blocked, (
                        kernel, width, hidden, n_layers)
                    if p.blocked:
                        wide = tiles.plan(kernel, True, width, 256, n_layers, n_head).chunked
                        assert p.chunked == wide, (kernel, width, hidden, n_layers)
