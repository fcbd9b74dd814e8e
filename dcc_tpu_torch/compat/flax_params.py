"""Convert between a flax parameter tree and the port's ``state_dict``s.

The tree is given as nested dicts of numpy arrays (``{"params": {...}}`` or
its inner dict), as ``jax.device_get`` returns it; the module never imports
JAX. Names map one to one (``base.fc0.kernel`` <-> ``base.fc0.weight``; the
actor heads keep flax's names: ``act_out``, ``act_out{i}`` per
multi_discrete branch, ``act_out_disc`` and ``log_std``):

* a flax Dense ``kernel`` is (in, out), a torch ``Linear.weight`` is
  (out, in), so it is transposed;
* a flax LayerNorm ``scale`` is the port's ``weight``;
* everything else (biases, ``log_std``) keeps its name and shape.

Separated policies keep one network per agent where the JAX package stacks
them (every leaf with a leading agent axis A): :func:`stacked_flax_to_state_dicts`
and :func:`state_dicts_to_stacked_flax` convert between such a tree and A
state dicts, and :func:`unstack_states` / :func:`stack_states` between a
stacked ValueNorm or PopArt state (a NamedTuple of arrays with the leading
axis A) and A of the port's states.

MADDPG's stacked rlkit networks (``MADDPGState.actor_params`` and its
critic and target trees) stay stacked in the port:
:func:`rlkit_flax_to_state_dict` and :func:`state_dict_to_rlkit_flax` convert
between such a tree and the state dict of
:class:`~dcc_tpu_torch.models.rlkit_mlp.RlkitMlp`, whose kernels (A, in,
out) keep flax's orientation, so names map one to one
(``fc0.kernel``, ``fc0.bias``, ..., ``last_fc.kernel``) and nothing is
transposed.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, List

import numpy as np
import torch


def flax_to_state_dict(tree: Dict[str, Any], device="cpu") -> Dict[str, torch.Tensor]:
    tree = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for name, val in node.items():
            if isinstance(val, Mapping):
                walk(val, prefix + name + ".")
                continue
            arr = np.asarray(val, dtype=np.float32)
            if name == "kernel":
                name, arr = "weight", arr.T
            elif name == "scale":
                name = "weight"
            out[prefix + name] = torch.tensor(np.ascontiguousarray(arr), device=device)

    walk(tree, "")
    return out


def state_dict_to_flax(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    params: Dict[str, Any] = {}
    for key, val in sd.items():
        *path, name = key.split(".")
        arr = val.detach().cpu().numpy()
        if name == "weight":
            name, arr = ("kernel", arr.T) if arr.ndim == 2 else ("scale", arr)
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(arr)
    return {"params": params}


def stacked_flax_to_state_dicts(tree: Dict[str, Any],
                                device="cpu") -> List[Dict[str, torch.Tensor]]:
    """A flax tree whose leaves carry a leading agent axis -> one state dict
    per agent."""
    n = _first_leaf(tree).shape[0]
    return [flax_to_state_dict(_map_tree(tree, lambda x: np.asarray(x)[i]), device)
            for i in range(n)]


def state_dicts_to_stacked_flax(sds: List[Dict[str, torch.Tensor]]) -> Dict[str, Any]:
    """One state dict per agent -> a flax tree with a leading agent axis."""
    trees = [state_dict_to_flax(sd) for sd in sds]
    return _map_trees(trees, lambda xs: np.stack(xs))


def unstack_states(stacked, cls, device="cpu") -> list:
    """A stacked normalizer state (``_fields`` or a mapping of arrays, each
    with a leading agent axis) -> one ``cls`` (the port's ValueNormState or
    PopArtState) per agent."""
    fields = stacked._asdict() if hasattr(stacked, "_asdict") else dict(stacked)
    arrays = {k: np.asarray(fields[k], dtype=np.float32) for k in cls._fields}
    n = arrays[cls._fields[0]].shape[0]
    return [cls(**{k: torch.tensor(a[i], device=device) for k, a in arrays.items()})
            for i in range(n)]


def stack_states(states: list) -> Dict[str, np.ndarray]:
    """One normalizer state per agent -> {field: array with a leading agent
    axis}, the fields of the JAX package's stacked state."""
    return {k: np.stack([getattr(st, k).detach().cpu().numpy() for st in states])
            for k in states[0]._fields}


def rlkit_flax_to_state_dict(tree: Dict[str, Any], device="cpu") -> Dict[str, torch.Tensor]:
    """A stacked flax ``RlkitMlp`` tree -> the port's ``RlkitMlp`` state
    dict."""
    tree = tree.get("params", tree)
    return {f"{layer}.{name}": torch.tensor(np.asarray(val, dtype=np.float32), device=device)
            for layer, leaves in tree.items() for name, val in leaves.items()}


def state_dict_to_rlkit_flax(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``RlkitMlp`` state dict -> a stacked flax tree."""
    params: Dict[str, Any] = {}
    for key, val in sd.items():
        layer, name = key.split(".")
        params.setdefault(layer, {})[name] = val.detach().cpu().numpy()
    return {"params": params}


def _first_leaf(tree):
    val = next(iter(tree.values()))
    return _first_leaf(val) if isinstance(val, Mapping) else np.asarray(val)


def _map_tree(tree, fn):
    return {k: _map_tree(v, fn) if isinstance(v, Mapping) else fn(v) for k, v in tree.items()}


def _map_trees(trees, fn):
    first = trees[0]
    return {k: _map_trees([t[k] for t in trees], fn) if isinstance(first[k], Mapping)
            else fn([t[k] for t in trees]) for k in first}
