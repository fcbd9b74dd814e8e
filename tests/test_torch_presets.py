"""The port's named env presets against ``dcc_tpu``'s: the same names, the
same merged config and the same ``EnvConfig`` / ``MAPPOConfig`` field by
field; one tiny training iteration of each one-card preset (as
tests/test_presets.py); the 20-UAV preset's build on CUDA, where its
4,840-wide critic rows take the chunked layout of bf16 K4, of K2b (the fused
loss off, the recurrent policy) and of K4u (unfolded), and where bf16 K3 and
K3u are given rows that wide; the builds of the many-PoI swarms, 4 UAVs x
300 PoIs (actor rows 1,510, critic rows 6,040: chunked K2, K3, K3u, K4,
K4u, K2b) and the 20-UAV preset with 50 PoIs (critic rows 5,840: chunked
K2); MAPPO's builds with the fused kernels at bf16 hidden widths past 256
and off multiples of 8, which the kernels run in column passes, and at 9
layers."""

import numpy as np
import pytest

from dcc_tpu.configs import PRESETS as J_PRESETS
from dcc_tpu.configs import load_preset as j_load_preset
from dcc_tpu_torch.algos import MAPPO
from dcc_tpu_torch.configs import PRESETS, load, load_preset
from dcc_tpu_torch.ops import tiles
from test_torch_cuda import pretend_cuda


def test_presets_match_jax_names():
    assert PRESETS == J_PRESETS
    with pytest.raises(KeyError):
        load_preset("nope")


@pytest.mark.parametrize("name", sorted(J_PRESETS))
def test_preset_maps_as_jax(name):
    cfg, env_cfg, algo_cfg = load_preset(name)
    jcfg, jenv, jalgo = j_load_preset(name)
    assert cfg == jcfg
    assert env_cfg._asdict() == jenv._asdict()
    assert algo_cfg._asdict() == jalgo._asdict()
    assert (env_cfg.obs_dim, env_cfg.share_obs_dim) == (jenv.obs_dim, jenv.share_obs_dim)


@pytest.mark.parametrize("name", ["3uav_small", "5uav_dense_conn", "10uav_moving_collision",
                                  "throughput_4096"])
def test_preset_trains_one_tiny_iter(name):
    # a shorter run, the env physics intact
    _, env_cfg, algo_cfg = load_preset(
        name, overrides={"n_rollout_threads": 4, "ppo_epoch": 2, "max_ep_len": 8,
                         "algo_hidden_size": 32})
    algo = MAPPO(algo_cfg, env_cfg, device="cpu")
    ts = algo.init_state(0)
    m = algo.train_iteration(ts)
    assert all(np.isfinite(v) for v in m)
    assert ts.iteration == 1


@pytest.mark.parametrize("name,dtype", [("5uav_dense_conn", "bfloat16"),
                                        ("10uav_moving_collision", "bfloat16"),
                                        ("3uav_small", "float32")])
def test_one_card_presets_build_on_cuda(monkeypatch, name, dtype):
    """The one-card presets' widths fit the kernels' row tiles: MAPPO builds
    on CUDA, with the fused kernels in bf16. Construction touches no device
    memory, so a CUDA device is pretended, and the kernels' shared memory
    comes from their layouts in Python (``test_torch_cuda.smem_layout``),
    which the card holds equal to the libraries'."""
    pretend_cuda(monkeypatch)
    _, env_cfg, algo_cfg = load_preset(name, overrides={"compute_dtype": dtype})
    algo = MAPPO(algo_cfg, env_cfg, device="cuda")
    assert algo.fused_loss == algo.fused_trunk == (dtype == "bfloat16")


def test_20uav_preset_builds_on_cuda(monkeypatch):
    """No staged tile of bf16 K4 fits the 4,840-wide critic rows; its
    chunked layout does, so MAPPO builds on CUDA with the fused kernels,
    and the actor's 242-wide rows take K3's staged tiles."""
    pretend_cuda(monkeypatch)
    _, env_cfg, algo_cfg = load_preset("20uav_16k_dist")
    assert (env_cfg.obs_dim, env_cfg.share_obs_dim) == (242, 4840)
    assert tiles.plan("critic_ppo_grads", True, 4840, 256, 2) == (True, [32, 16], False, False)
    assert tiles.plan("actor_ppo_grads", True, 242, 256, 2, 2) == (False, [32], False, False)
    assert tiles.plan("critic_ppo_grads", True, 440, 256, 2)[0] is False  # staged as before
    assert tiles.plan("fused_mlp", True, 4840, 256, 2) == (False, [16], False, False)
    algo = MAPPO(algo_cfg, env_cfg, device="cuda")
    assert algo.fused_loss and algo.fused_trunk and algo.cfg.fused_fold


# the runs whose bf16 update takes the 4,840-wide critic rows through the
# chunked K2b (the fused loss off; the recurrent policy, without update
# chunks, which it does not take) or the chunked K4u (unfolded)
CHUNKED_RUNS = [({"fused_loss": "off"}, "fused_mlp_bwd"),
                ({"fused_fold": False}, "critic_ppo_grads_unfolded"),
                ({"use_recurrent_policy": True, "update_chunks": 1}, "fused_mlp_bwd")]


@pytest.mark.parametrize("override,kernel", CHUNKED_RUNS)
def test_20uav_preset_overrides_build_on_cuda(monkeypatch, override, kernel):
    """No staged tile of bf16 K2b or K4u fits the 4,840-wide critic rows;
    their chunked layouts do, so MAPPO builds on CUDA the preset with the
    fused loss off or the recurrent policy (K2b) and unfolded (K4u)."""
    pretend_cuda(monkeypatch)
    _, env_cfg, algo_cfg = load_preset("20uav_16k_dist")
    assert env_cfg.share_obs_dim == 4840
    assert tiles.plan(kernel, True, 4840, 256, 2) == (True, [32, 16], False, False)
    assert tiles.plan(kernel, True, 242, 256, 2)[0] is False  # the actor's: staged
    algo = MAPPO(algo_cfg._replace(**override), env_cfg, device="cuda")
    assert algo.fused_trunk and algo.fused_loss == (kernel != "fused_mlp_bwd")
    assert algo.recurrent == ("use_recurrent_policy" in override)


@pytest.mark.parametrize("fold,kernel", [(True, "actor_ppo_grads"),
                                         (False, "actor_ppo_grads_unfolded")])
def test_20uav_wide_actor_rows_build_on_cuda(monkeypatch, fold, kernel):
    """bf16 K3 and K3u have a chunked layout at 4,840-wide actor rows, so the
    preset's MAPPO given 4,840-wide actor rows passes the check on CUDA, as
    does bf16 K2 at 6,040-wide rows."""
    pretend_cuda(monkeypatch)
    _, env_cfg, algo_cfg = load_preset("20uav_16k_dist")
    assert tiles.plan(kernel, True, 4840, 256, 2, 2) == (True, [32, 16], False, False)
    assert tiles.plan("fused_mlp", True, 6040, 256, 2) == (True, [32, 16], False, False)
    algo = MAPPO(algo_cfg._replace(fused_fold=fold), env_cfg, device="cuda")
    algo.obs_dim = env_cfg.share_obs_dim
    algo._check_row_tiles()


def _many_pois(num_pois, preset=None, **over):
    """(EnvConfig, MAPPOConfig) in bf16 of the default env, or of a preset,
    with ``num_pois`` PoIs and the config fields ``over`` set."""
    overrides = {"num_pois": num_pois, "compute_dtype": "bfloat16"}
    _, env_cfg, algo_cfg = (load(overrides=overrides) if preset is None
                            else load_preset(preset, overrides=overrides))
    return env_cfg, algo_cfg._replace(**over)


# 4 UAVs x 300 PoIs in bf16: folded, unfolded and with the fused loss off,
# and the kernels each path takes in the chunked layout at its widths
POIS_BUILDS = {
    "folded": ({}, ("actor_ppo_grads", "critic_ppo_grads")),
    "unfolded": ({"fused_fold": False},
                 ("actor_ppo_grads_unfolded", "critic_ppo_grads_unfolded")),
    "fused-loss-off": ({"fused_loss": "off"}, ("fused_mlp_bwd",)),
}


@pytest.mark.parametrize("case", list(POIS_BUILDS))
def test_many_pois_builds_on_cuda(monkeypatch, case):
    """The default env with 300 PoIs: actor rows 1,510 wide, wider than any
    staged bf16 K3 (1,472) or K3u (1,088) tile, and critic rows 6,040 wide,
    wider than any staged K2 (5,632), K4, K4u or K2b tile. Every kernel of
    the path has a chunked layout there, so MAPPO builds on CUDA with the
    fused kernels."""
    pretend_cuda(monkeypatch)
    over, kernels = POIS_BUILDS[case]
    env_cfg, algo_cfg = _many_pois(300, **over)
    assert (env_cfg.n_agents, env_cfg.obs_dim, env_cfg.share_obs_dim) == (4, 1510, 6040)
    assert tiles.plan("fused_mlp", True, 6040, 256, 2) == (True, [32, 16], False, False)
    assert tiles.plan("fused_mlp", True, 1510, 256, 2)[0] is False  # the actor's: staged
    for kernel in kernels:
        n_head = 2 if kernel.startswith("actor") else 1
        width = 1510 if kernel.startswith("actor") else 6040
        assert tiles.plan(kernel, True, width, 256, 2, n_head) == (True, [32, 16], False,
                                                                   False), kernel
    algo = MAPPO(algo_cfg, env_cfg, device="cuda")
    assert algo.fused_trunk and algo.fused_loss == (case != "fused-loss-off")
    assert algo.cfg.fused_fold == (case != "unfolded")


def test_20uav_fifty_pois_builds_on_cuda(monkeypatch):
    """The 20-UAV preset with 50 PoIs: critic rows 5,840 wide, past the
    staged bf16 K2's 5,632, take its chunked layout; the 292-wide actor rows
    stay staged. MAPPO builds on CUDA with the fused kernels."""
    pretend_cuda(monkeypatch)
    env_cfg, algo_cfg = _many_pois(50, "20uav_16k_dist")
    assert (env_cfg.n_agents, env_cfg.obs_dim, env_cfg.share_obs_dim) == (20, 292, 5840)
    assert tiles.plan("fused_mlp", True, 5840, 256, 2) == (True, [32, 16], False, False)
    assert tiles.plan("actor_ppo_grads", True, 292, 256, 2, 2)[0] is False
    algo = MAPPO(algo_cfg, env_cfg, device="cuda")
    assert algo.fused_loss and algo.fused_trunk


# trunks past 8 layers (layer_n 8: 9 layers), which the CUDA entries used to
# refuse, with the fused kernels on: (config fields, {(kernel, row width, head
# width): (chunked, tiles, depth layout)} of the launches' plans in that mode)
DEEP_BUILDS = {
    "bf16-layer-n-8": ({"compute_dtype": "bfloat16", "layer_n": 8}, True, {
        ("fused_mlp", 110, 1): (False, [64, 32, 16], False),
        ("fused_mlp", 440, 1): (False, [64, 32, 16], False),
        ("actor_ppo_grads", 110, 2): (False, [16], False),
        ("critic_ppo_grads", 440, 1): (False, [16], False)}),
    "f32-fused-layer-n-8": ({"layer_n": 8, "fused_loss": "on", "fused_trunk": "on"}, False, {
        ("fused_mlp", 110, 1): (False, [32, 8, 1], False),
        ("fused_mlp", 440, 1): (False, [32, 8, 1], False),
        ("actor_ppo_grads", 110, 2): (False, [8, 1], False),
        ("critic_ppo_grads", 440, 1): (False, [8, 1], False)}),
}


@pytest.mark.parametrize("case", list(DEEP_BUILDS))
def test_deep_trunk_builds_with_fused_kernels(monkeypatch, case):
    """More than 8 layers: MAPPO builds on CUDA (a device pretended, the
    kernels' layouts from ``smem_layout``) with the fused trunk and the
    fused loss on, in bf16 and in f32 with both forced on, and each kernel
    it launches has the tiles listed (at 9 layers every bf16 kernel still
    stages its layers in shared memory, ``ops.tiles.plan``)."""
    pretend_cuda(monkeypatch)
    _, env_cfg, algo_cfg = load()
    over, bf16, plans = DEEP_BUILDS[case]
    algo = MAPPO(algo_cfg._replace(**over), env_cfg, device="cuda")
    assert algo.fused_trunk and algo.fused_loss
    n_layers = over["layer_n"] + 1
    for (kernel, width, n_head), (chunked, sizes, deep) in plans.items():
        p = tiles.plan(kernel, bf16, width, 256, n_layers, n_head)
        assert p == (chunked, sizes, deep, False), kernel


# bf16 hidden widths the tensor-core kernels take in column passes (past 256)
# or zero-padded (off multiples of 8): (config fields)
WIDE_HIDDEN_BUILDS = {
    "bf16-hidden-320": {"compute_dtype": "bfloat16", "hidden_size": 320},
    "bf16-hidden-100": {"compute_dtype": "bfloat16", "hidden_size": 100},
    "bf16-hidden-512": {"compute_dtype": "bfloat16", "hidden_size": 512},
    "bf16-hidden-1024": {"compute_dtype": "bfloat16", "hidden_size": 1024},
}


@pytest.mark.parametrize("case", list(WIDE_HIDDEN_BUILDS))
def test_wide_hidden_builds_with_fused_kernels(monkeypatch, case):
    """ROADMAP B3's hidden widths: MAPPO builds on CUDA in bf16 with the
    fused trunk and the fused loss on, as the JAX package picks them, at
    widths the kernels used to refuse."""
    pretend_cuda(monkeypatch)
    _, env_cfg, algo_cfg = load()
    algo = MAPPO(algo_cfg._replace(**WIDE_HIDDEN_BUILDS[case]), env_cfg, device="cuda")
    assert algo.fused_trunk and algo.fused_loss


def test_cuda_trunk_without_fused_kernels_builds(monkeypatch):
    """The same trunks build on CUDA where no fused kernel runs (f32 with
    the defaults: autograd, K1 only)."""
    pretend_cuda(monkeypatch)
    _, env_cfg, algo_cfg = load()
    for over in ({"hidden_size": 320}, {"hidden_size": 100}, {"layer_n": 8}):
        algo = MAPPO(algo_cfg._replace(**over), env_cfg, device="cuda")
        assert not (algo.fused_trunk or algo.fused_loss)
