"""Checkpointing of the full train state with ``torch.save``.

Params, both Adam states, the value normalizer (ValueNorm or PopArt), the
counters and the rollout generator's state round-trip, so training resumes exactly where it stopped.
Separated policies save each agent's networks, optimizers and normalizer
under ``agents``, in agent order.
"""

from __future__ import annotations

import os

import torch

from ..algos.mappo import TrainState


def _policy(ts: TrainState) -> dict:
    """One state's networks, optimizers and normalizer."""
    return {
        "actor": ts.actor.state_dict(),
        "critic": ts.critic.state_dict(),
        "actor_opt": ts.actor_opt.state_dict(),
        "critic_opt": ts.critic_opt.state_dict(),
        "vnorm": None if ts.vnorm is None else tuple(ts.vnorm),
        "popart": None if ts.popart is None else tuple(ts.popart),
    }


def save(path: str, ts: TrainState) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(
        {
            **({"agents": [_policy(a) for a in ts.agents]} if ts.agents else _policy(ts)),
            "update_count": ts.update_count,
            "iteration": ts.iteration,
            "generator": ts.generator.get_state(),
        },
        path,
    )


def load(path: str, ts: TrainState) -> TrainState:
    """Restore a checkpoint into ``ts`` (built by ``MAPPO.init_state`` with
    the same config) in place; returns it."""
    device = next(ts.policies()[0].actor.parameters()).device
    blob = torch.load(path, map_location=device, weights_only=True)
    for p, saved in zip(ts.policies(), blob.get("agents", [blob])):
        p.actor.load_state_dict(saved["actor"])
        p.critic.load_state_dict(saved["critic"])
        p.actor_opt.load_state_dict(saved["actor_opt"])
        p.critic_opt.load_state_dict(saved["critic_opt"])
        if saved["vnorm"] is not None:
            p.vnorm = type(p.vnorm)(*saved["vnorm"])
        if saved.get("popart") is not None:
            p.popart = type(p.popart)(*saved["popart"])
    ts.update_count = int(blob["update_count"])
    ts.iteration = int(blob["iteration"])
    ts.generator.set_state(blob["generator"].cpu())
    return ts
