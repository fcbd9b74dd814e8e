from .actor_critic import Actor, Critic
from .mlp import MLPBase

__all__ = ["Actor", "Critic", "MLPBase"]
