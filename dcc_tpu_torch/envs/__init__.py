from .coverage import (
    EnvConfig,
    EnvState,
    StepOut,
    connectivity,
    decode_action,
    default_poi_bank,
    observation,
    reset,
    step,
)
from .vector import reset_batch, share_obs_from_obs, step_batch

# ---------------------------------------------------------------------------
# Scenario registry (counterpart of dcc_tpu.envs'): a name maps to the
# batched env functions (config_cls, reset, step, observation) and an
# optional merged-YAML -> config builder. The YAML key ``scenario_name``
# selects one (``configs.loader.load``); the trainers step it through
# ``vector.make_vec_fns``. A scenario's reset takes (cfg, n_envs, dtype=,
# device=, generator=), its step (cfg, states, actions) for E envs at once.
# ---------------------------------------------------------------------------
_SCENARIOS = {}


def register_scenario(
    name, *, config_cls, reset_fn, step_fn, observation_fn, config_from_yaml=None
):
    """Register a scenario under ``name``. Overwriting an existing name is
    an error (delete first), so that nothing is shadowed silently."""
    if name in _SCENARIOS:
        raise ValueError(f"scenario {name!r} already registered")
    _SCENARIOS[name] = {
        "config_cls": config_cls,
        "reset": reset_fn,
        "step": step_fn,
        "observation": observation_fn,
        "config_from_yaml": config_from_yaml,
    }


def get_scenario(name):
    """Look up a registered scenario (the KeyError lists what exists)."""
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {sorted(_SCENARIOS)}"
        ) from None


register_scenario(
    "coverage",
    config_cls=EnvConfig,
    reset_fn=reset,
    step_fn=step,
    observation_fn=observation,
)

from . import spread as _spread  # noqa: E402  (registered below)

register_scenario(
    "spread",
    config_cls=_spread.SpreadConfig,
    reset_fn=_spread.reset,
    step_fn=_spread.step,
    observation_fn=_spread.observation,
    config_from_yaml=_spread.config_from_yaml,
)

from .facade import DCEnv, VecDCEnv  # noqa: E402
from .policy import HeuristicCoveragePolicy, InteractivePolicy  # noqa: E402
from .spaces import Box, Discrete, MultiBinary, MultiDiscrete, TupleSpace  # noqa: E402
from .vector import make_vec_fns  # noqa: E402

__all__ = [
    "Box",
    "DCEnv",
    "Discrete",
    "EnvConfig",
    "EnvState",
    "HeuristicCoveragePolicy",
    "InteractivePolicy",
    "MultiBinary",
    "MultiDiscrete",
    "StepOut",
    "TupleSpace",
    "VecDCEnv",
    "connectivity",
    "decode_action",
    "default_poi_bank",
    "get_scenario",
    "make_vec_fns",
    "observation",
    "register_scenario",
    "reset",
    "reset_batch",
    "share_obs_from_obs",
    "step",
    "step_batch",
]
