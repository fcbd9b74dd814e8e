"""The port's named env presets against ``dcc_tpu``'s: the same names, the
same merged config and the same ``EnvConfig`` / ``MAPPOConfig`` field by
field; one tiny training iteration of each one-card preset (as
tests/test_presets.py); the 20-UAV preset's build on CUDA, where its
4,840-wide critic rows take the chunked layout of bf16 K4, of K2b (the fused
loss off, the recurrent policy) and of K4u (unfolded); and MAPPO's refusal
where a kernel with no tile at 4,840 would run such rows (what is left of
ROADMAP B2: bf16 K3 and K3u, on no configuration's path)."""

import numpy as np
import pytest

from dcc_tpu.configs import PRESETS as J_PRESETS
from dcc_tpu.configs import load_preset as j_load_preset
from dcc_tpu_torch.algos import MAPPO
from dcc_tpu_torch.configs import PRESETS, load_preset
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
    assert tiles.plan("critic_ppo_grads", True, 4840, 256, 2) == (True, [32, 16])
    assert tiles.plan("actor_ppo_grads", True, 242, 256, 2, 2) == (False, [32])
    assert tiles.plan("critic_ppo_grads", True, 440, 256, 2)[0] is False  # staged as before
    assert tiles.plan("fused_mlp", True, 4840, 256, 2) == (False, [16])
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
    assert tiles.plan(kernel, True, 4840, 256, 2) == (True, [32, 16])
    assert tiles.plan(kernel, True, 242, 256, 2)[0] is False  # the actor's: staged
    algo = MAPPO(algo_cfg._replace(**override), env_cfg, device="cuda")
    assert algo.fused_trunk and algo.fused_loss == (kernel != "fused_mlp_bwd")
    assert algo.recurrent == ("use_recurrent_policy" in override)


@pytest.mark.parametrize("fold,kernel", [(True, "actor_ppo_grads"),
                                         (False, "actor_ppo_grads_unfolded")])
def test_20uav_preset_refused_on_cuda(monkeypatch, fold, kernel):
    """What is left of ROADMAP B2: bf16 K3 and K3u have no tile at 4,840-wide
    rows and no chunked layout. No configuration gives the actor rows that
    wide, so the check is driven with the preset's MAPPO given 4,840-wide
    actor rows: on CUDA it refuses, naming the kernel and B2."""
    pretend_cuda(monkeypatch)
    _, env_cfg, algo_cfg = load_preset("20uav_16k_dist")
    assert tiles.plan(kernel, True, 4840, 256, 2, 2) == (False, [])
    algo = MAPPO(algo_cfg._replace(fused_fold=fold), env_cfg, device="cuda")
    algo.obs_dim = env_cfg.share_obs_dim
    with pytest.raises(NotImplementedError, match=f"{kernel} .*B2"):
        algo._check_row_tiles()
