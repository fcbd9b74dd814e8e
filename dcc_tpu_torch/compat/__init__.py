from .flax_params import (
    flax_to_state_dict,
    rlkit_flax_to_state_dict,
    stack_states,
    stacked_flax_to_state_dicts,
    state_dict_to_flax,
    state_dict_to_rlkit_flax,
    state_dicts_to_stacked_flax,
    unstack_states,
)
from .golden import DEFAULT_GOLDEN_DIR, GoldenTrace, compare, load_golden, replay

__all__ = ["DEFAULT_GOLDEN_DIR", "GoldenTrace", "compare", "load_golden", "replay",
           "flax_to_state_dict", "rlkit_flax_to_state_dict", "stack_states",
           "stacked_flax_to_state_dicts", "state_dict_to_flax", "state_dict_to_rlkit_flax",
           "state_dicts_to_stacked_flax", "unstack_states"]
