"""Config loading: YAML merge env -> algo -> expt (later wins), overrides
last, then the typed configs. Counterpart of :mod:`dcc_tpu.configs.loader`
over this package's own copies of the YAML files."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import yaml

from ..algos.mappo import MAPPOConfig
from ..envs import EnvConfig

_CFG_DIR = os.path.dirname(__file__)

# keys whose yaml representation may parse as str but must be float
_FLOAT_KEYS = ("actor_lr", "critic_lr", "opti_eps", "lr", "weight_decay", "gamma",
               "gae_lambda")


def load_yaml_merged(
    env_yaml: Optional[str] = None,
    algo_yaml: Optional[str] = None,
    expt_yaml: Optional[str] = None,
    overrides: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    paths = [
        env_yaml or os.path.join(_CFG_DIR, "env_config", "dcc.yaml"),
        algo_yaml or os.path.join(_CFG_DIR, "algo_config", "mappo.yaml"),
        expt_yaml or os.path.join(_CFG_DIR, "expt.yaml"),
    ]
    cfg: Dict[str, Any] = {}
    for p in paths:
        with open(p) as f:
            cfg.update(yaml.safe_load(f) or {})
    if overrides:
        cfg.update(overrides)
    if "n_envs" in cfg:
        # alias of the reference's n_rollout_threads
        cfg["n_rollout_threads"] = cfg.pop("n_envs")
    for k in _FLOAT_KEYS:
        if cfg.get(k) is not None:
            cfg[k] = float(cfg[k])
    return cfg


def to_env_config(cfg: Dict[str, Any]) -> EnvConfig:
    return EnvConfig(
        n_agents=int(cfg.get("num_agents", 4)),
        n_pois=int(cfg.get("num_pois", 20)),
        max_ep_len=int(cfg.get("max_ep_len", 150)),
        r_cover=float(cfg.get("r_cover", 0.2)),
        r_comm=float(cfg.get("r_comm", 0.4)),
        comm_r_scale=float(cfg.get("comm_r_scale", 0.95)),
        comm_force_scale=float(cfg.get("comm_force_scale", 0.0)),
        randomize_pois=bool(cfg.get("randomize_pois", False)),
        poi_speed=float(cfg.get("poi_speed", 0.0)),
        collision_penalty=float(cfg.get("collision_penalty", 0.0)),
        collision_radius=float(cfg.get("collision_radius", 0.08)),
        fix_scaled_connectivity=bool(cfg.get("fix_scaled_connectivity", False)),
        compensated_forces=bool(cfg.get("compensated_forces", False)),
        time_limit=bool(cfg.get("time_limit", False)),
        discrete_actions=bool(cfg.get("discrete_actions", False)),
        action_mode=str(cfg.get("action_mode", "")),
    )


def to_algo_config(cfg: Dict[str, Any]) -> MAPPOConfig:
    return MAPPOConfig(
        clip_param=float(cfg.get("clip_param", 0.2)),
        ppo_epoch=int(cfg.get("ppo_epoch", 15)),
        num_mini_batch=int(cfg.get("num_mini_batch", 1)),
        data_chunk_length=int(cfg.get("data_chunk_length", 10)),
        value_loss_coef=float(cfg.get("value_loss_coef", 1.0)),
        entropy_coef=float(cfg.get("entropy_coef", 0.01)),
        max_grad_norm=float(cfg.get("max_grad_norm", 10.0)),
        huber_delta=float(cfg.get("huber_delta", 10.0)),
        use_clipped_value_loss=bool(cfg.get("use_clipped_value_loss", True)),
        use_huber_loss=bool(cfg.get("use_huber_loss", True)),
        use_max_grad_norm=bool(cfg.get("use_max_grad_norm", True)),
        use_value_active_masks=bool(cfg.get("use_value_active_masks", True)),
        use_policy_active_masks=bool(cfg.get("use_policy_active_masks", True)),
        gamma=float(cfg.get("gamma", 0.99)),
        gae_lambda=float(cfg.get("gae_lambda", 0.95)),
        use_gae=bool(cfg.get("use_gae", True)),
        use_proper_time_limits=bool(cfg.get("use_proper_time_limits", False)),
        use_popart=bool(cfg.get("use_popart", False)),
        use_valuenorm=bool(cfg.get("use_valuenorm", True)),
        actor_lr=float(cfg.get("actor_lr", 5e-4)),
        critic_lr=float(cfg.get("critic_lr", 5e-4)),
        opti_eps=float(cfg.get("opti_eps", 1e-5)),
        weight_decay=float(cfg.get("weight_decay", 0.0)),
        use_linear_lr_decay=bool(cfg.get("use_linear_lr_decay", True)),
        hidden_size=int(cfg.get("algo_hidden_size", 256)),
        layer_n=int(cfg.get("layer_N", 1)),
        use_relu=bool(cfg.get("use_ReLU", True)),
        use_feature_normalization=bool(cfg.get("use_feature_normalization", True)),
        use_orthogonal=bool(cfg.get("use_orthogonal", True)),
        gain=float(cfg.get("gain", 0.01)),
        use_recurrent_policy=bool(cfg.get("use_recurrent_policy", False)),
        use_naive_recurrent=bool(cfg.get("use_naive_recurrent_policy", False)),
        recurrent_n=int(cfg.get("recurrent_N", 1)),
        use_centralized_v=bool(cfg.get("use_centralized_V", True)),
        n_rollout_threads=int(cfg.get("n_rollout_threads", 16)),
        episode_length=int(cfg.get("max_ep_len", 150)),
        n_iters=int(cfg.get("n_iters", 200)),
        # the reference's share_policy key is ignored by its learner; opt
        # into per-agent params with use_separated_policy
        share_policy=not bool(cfg.get("use_separated_policy", False)),
        use_remat=bool(cfg.get("use_remat", False)),
        update_chunks=int(cfg.get("update_chunks", 1)),
        gae_backend=str(cfg.get("gae_backend", "auto")),
        compute_dtype=str(cfg.get("compute_dtype", "float32")),
        fused_trunk=str(cfg.get("fused_trunk", "auto")),
        fused_block_rows=int(cfg.get("fused_block_rows", 4096)),
        fused_fold=bool(cfg.get("fused_fold", True)),
        store_obs_bf16=bool(cfg.get("store_obs_bf16", True)),
        fused_loss=str(cfg.get("fused_loss", "auto")),
        env_dtype=str(cfg.get("env_dtype", "float32")),
    )


def load(overrides: Optional[Dict[str, Any]] = None,
         **paths) -> Tuple[Dict[str, Any], EnvConfig, MAPPOConfig]:
    cfg = load_yaml_merged(overrides=overrides, **paths)
    scenario = str(cfg.get("scenario_name", "coverage"))
    if scenario != "coverage":
        raise NotImplementedError(
            f"scenario {scenario!r} is not ported yet (ROADMAP A11: scenarios)"
        )
    return cfg, to_env_config(cfg), to_algo_config(cfg)
