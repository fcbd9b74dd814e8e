"""The port's named env presets against ``dcc_tpu``'s: the same names, the
same merged config and the same ``EnvConfig`` / ``MAPPOConfig`` field by
field; one tiny training iteration of each one-card preset (as
tests/test_presets.py); the 20-UAV preset's build on CUDA, where its
4,840-wide critic rows take the chunked layout of bf16 K4; and its refusal
where a kernel that has no tile at 4,840 would run them (the rest of
ROADMAP B2: K2b with the fused loss off, K4u unfolded)."""

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


@pytest.mark.parametrize("override,kernel", [({"fused_loss": "off"}, "fused_mlp_bwd"),
                                             ({"fused_fold": False},
                                              "critic_ppo_grads_unfolded")])
def test_20uav_preset_refused_on_cuda(monkeypatch, override, kernel):
    """The kernels left in ROADMAP B2 have no tile at 4,840: with the fused
    loss off the update runs K2b on the critic rows, unfolded it runs K4u;
    MAPPO refuses to build either on CUDA, naming B2."""
    pretend_cuda(monkeypatch)
    _, env_cfg, algo_cfg = load_preset("20uav_16k_dist")
    assert env_cfg.share_obs_dim == 4840
    assert not tiles.plan(kernel, True, 4840, 256, 2)[1]
    with pytest.raises(NotImplementedError, match=f"{kernel}.*B2"):
        MAPPO(algo_cfg._replace(**override), env_cfg, device="cuda")
    # on the CPU the plain versions take any width
    MAPPO(algo_cfg._replace(**override), env_cfg, device="cpu")
