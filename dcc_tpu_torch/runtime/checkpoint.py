"""Checkpointing of the full train state with ``torch.save``.

Params, both Adam states, the value normalizer, the counters and the rollout
generator's state round-trip, so training resumes exactly where it stopped.
"""

from __future__ import annotations

import os

import torch

from ..algos.mappo import TrainState


def save(path: str, ts: TrainState) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(
        {
            "actor": ts.actor.state_dict(),
            "critic": ts.critic.state_dict(),
            "actor_opt": ts.actor_opt.state_dict(),
            "critic_opt": ts.critic_opt.state_dict(),
            "vnorm": None if ts.vnorm is None else tuple(ts.vnorm),
            "update_count": ts.update_count,
            "iteration": ts.iteration,
            "generator": ts.generator.get_state(),
        },
        path,
    )


def load(path: str, ts: TrainState) -> TrainState:
    """Restore a checkpoint into ``ts`` (built by ``MAPPO.init_state`` with
    the same config) in place; returns it."""
    device = next(ts.actor.parameters()).device
    blob = torch.load(path, map_location=device, weights_only=True)
    ts.actor.load_state_dict(blob["actor"])
    ts.critic.load_state_dict(blob["critic"])
    ts.actor_opt.load_state_dict(blob["actor_opt"])
    ts.critic_opt.load_state_dict(blob["critic_opt"])
    if blob["vnorm"] is not None:
        ts.vnorm = type(ts.vnorm)(*blob["vnorm"])
    ts.update_count = int(blob["update_count"])
    ts.iteration = int(blob["iteration"])
    ts.generator.set_state(blob["generator"].cpu())
    return ts
