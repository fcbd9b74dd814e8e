from .coverage import (
    EnvConfig,
    EnvState,
    StepOut,
    check_supported,
    connectivity,
    decode_action,
    default_poi_bank,
    observation,
    reset,
    step,
)
from .vector import reset_batch, share_obs_from_obs, step_batch

__all__ = [
    "EnvConfig",
    "EnvState",
    "StepOut",
    "check_supported",
    "connectivity",
    "decode_action",
    "default_poi_bank",
    "observation",
    "reset",
    "reset_batch",
    "share_obs_from_obs",
    "step",
    "step_batch",
]
