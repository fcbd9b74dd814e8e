from .loader import (
    PRESETS,
    load,
    load_preset,
    load_yaml_merged,
    preset_path,
    to_algo_config,
    to_env_config,
    to_maddpg_config,
)

__all__ = ["PRESETS", "load", "load_preset", "load_yaml_merged", "preset_path",
           "to_algo_config", "to_env_config", "to_maddpg_config"]
