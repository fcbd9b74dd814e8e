"""Algorithm factory: the merged config's ``algo_file`` selects the
trainer, its ``scenario_name`` the env (counterpart of
:func:`dcc_tpu.algos.factory.make_algo`)."""

from __future__ import annotations

from typing import Any, Dict

from .maddpg import MADDPG
from .mappo import MAPPO


def make_algo(cfg: Dict[str, Any], env_cfg, device=None, mesh=None):
    """Build the algorithm ``algo_file`` names (MADDPG or MAPPO) on
    ``device`` (CUDA unless the caller asks for the CPU), data-parallel
    over ``mesh`` when one is given."""
    from ..configs.loader import to_algo_config, to_maddpg_config

    algo_file = str(cfg.get("algo_file", "mappo"))
    scenario = str(cfg.get("scenario_name", "coverage"))
    if "maddpg" in algo_file:
        return MADDPG(to_maddpg_config(cfg), env_cfg, device=device, scenario=scenario,
                      mesh=mesh)
    if "mappo" in algo_file:
        return MAPPO(to_algo_config(cfg), env_cfg, device=device, scenario=scenario,
                     mesh=mesh)
    raise NotImplementedError(f"algo_file: {algo_file} not found")
