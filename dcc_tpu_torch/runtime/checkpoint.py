"""Checkpointing of the full train state with ``torch.save``.

MAPPO: params, both Adam states, the value normalizer (ValueNorm or
PopArt), the counters and the rollout generator's state. Separated policies
save each agent's networks, optimizers and normalizer under ``agents``, in
agent order.

MADDPG: the stacked networks and their targets, both Adams, the replay
buffer with ``ptr`` and ``size``, the env states, observations and OU
state, the counters and the generator's state.

Either way training resumes exactly where it stopped. Under a mesh the
state is replicated but for MADDPG's env farm, which is saved gathered in
global env order and loaded as each rank's rows; the coordinator alone
writes the file (the caller holds the ranks at a barrier around it).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..algos.maddpg import MADDPGState, ReplayBuffer
from ..algos.mappo import TrainState
from ..parallel import distributed
from ..parallel.mesh import take_rows


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


def _maddpg(st: MADDPGState, mesh=None) -> dict:
    buf = st.buffer
    n = st.obs.shape[0] * (1 if mesh is None else mesh.size)  # the farm's envs
    gather = (lambda x: x) if mesh is None else (lambda x: mesh.all_gather(x, n))
    return {
        **{net: getattr(st, net).state_dict() for net in MADDPGState.NETS},
        "actor_opt": st.actor_opt.state_dict(),
        "critic_opt": st.critic_opt.state_dict(),
        "buffer": {k: getattr(buf, k) for k in ReplayBuffer.TENSORS},
        "buffer_ptr": buf.ptr,
        "buffer_size": buf.size,
        "env_states": {f.name: gather(getattr(st.env_states, f.name))
                       for f in dataclasses.fields(st.env_states)},
        "obs": gather(st.obs),
        "ou_state": gather(st.ou_state),
        "total_steps": st.total_steps,
    }


def save(path: str, ts, mesh=None) -> None:
    """Write ``ts`` to ``path`` (under ``mesh``: every rank gathers, the
    coordinator writes)."""
    if isinstance(ts, MADDPGState):
        body = _maddpg(ts, mesh)
    else:
        body = {"agents": [_policy(a) for a in ts.agents]} if ts.agents else _policy(ts)
        body["update_count"] = ts.update_count
    if distributed.is_coordinator():
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save({**body, "iteration": ts.iteration, "generator": ts.generator.get_state()},
                   path)


def _load_maddpg(blob: dict, st: MADDPGState, mesh=None) -> None:
    for net in MADDPGState.NETS:
        getattr(st, net).load_state_dict(blob[net])
    st.actor_opt.load_state_dict(blob["actor_opt"])
    st.critic_opt.load_state_dict(blob["critic_opt"])
    for k in ReplayBuffer.TENSORS:
        getattr(st.buffer, k).copy_(blob["buffer"][k])
    st.buffer.ptr, st.buffer.size = int(blob["buffer_ptr"]), int(blob["buffer_size"])
    rows = slice(None) if mesh is None else mesh.rows(blob["obs"].shape[0])
    st.env_states = take_rows(type(st.env_states)(**blob["env_states"]), rows)
    st.obs, st.ou_state = blob["obs"][rows], blob["ou_state"][rows]
    st.total_steps = int(blob["total_steps"])


def _load_mappo(blob: dict, ts: TrainState) -> None:
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


def load(path: str, ts, mesh=None):
    """Restore a checkpoint into ``ts`` (built by the algorithm's
    ``init_state`` with the same config, under the same ``mesh``) in place;
    returns it."""
    maddpg = isinstance(ts, MADDPGState)
    device = ts.obs.device if maddpg else next(ts.policies()[0].actor.parameters()).device
    blob = torch.load(path, map_location=device, weights_only=True)
    if maddpg:
        _load_maddpg(blob, ts, mesh)
    else:
        _load_mappo(blob, ts)
    ts.iteration = int(blob["iteration"])
    ts.generator.set_state(blob["generator"].cpu())
    return ts
