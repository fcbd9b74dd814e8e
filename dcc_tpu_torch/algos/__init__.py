from .factory import make_algo
from .maddpg import MADDPG, MADDPGConfig, MADDPGState, ReplayBuffer
from .mappo import MAPPO, MAPPOConfig, Metrics, Trajectory, TrainState

__all__ = ["MADDPG", "MADDPGConfig", "MADDPGState", "MAPPO", "MAPPOConfig", "Metrics",
           "ReplayBuffer", "Trajectory", "TrainState", "make_algo"]
