from .mappo import MAPPO, MAPPOConfig, Metrics, Trajectory, TrainState

__all__ = ["MAPPO", "MAPPOConfig", "Metrics", "Trajectory", "TrainState"]
