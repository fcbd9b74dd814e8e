from .flax_params import flax_to_state_dict, state_dict_to_flax

__all__ = ["flax_to_state_dict", "state_dict_to_flax"]
