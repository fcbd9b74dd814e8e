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
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict

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
