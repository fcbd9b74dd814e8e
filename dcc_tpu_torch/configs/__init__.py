from .loader import load, load_yaml_merged, to_algo_config, to_env_config

__all__ = ["load", "load_yaml_merged", "to_algo_config", "to_env_config"]
