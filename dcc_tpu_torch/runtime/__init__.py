from . import checkpoint
from .learner import Learner

__all__ = ["Learner", "checkpoint"]
