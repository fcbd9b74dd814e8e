from .actor_critic import Actor, Critic
from .mlp import MLPBase
from .rlkit_mlp import RlkitMlp
from .rnn import MaskedGRU

__all__ = ["Actor", "Critic", "MLPBase", "MaskedGRU", "RlkitMlp"]
