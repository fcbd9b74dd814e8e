"""Gaussian actor and centralized critic.

Counterparts of :class:`dcc_tpu.models.actor_critic.Actor` (gaussian head:
Linear mean with orthogonal gain 0.01 and a state-independent ``log_std``)
and :class:`~dcc_tpu.models.actor_critic.Critic` (``v_out`` with orthogonal
gain 1). ``trunk`` holds the :class:`MLPBase` arguments. In bf16 mode the
head runs with bf16 operands and a bf16 bias add, and its outputs are f32,
as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.fused_mlp import dense
from .mlp import MLPBase, init_linear


class Actor(nn.Module):
    def __init__(self, obs_dim: int, action_dim: int = 2, gain: float = 0.01, **trunk):
        super().__init__()
        self.base = MLPBase(obs_dim, **trunk)
        self.act_out = nn.Linear(self.base.fc0.out_features, action_dim)
        init_linear(self.act_out, gain, trunk.get("use_orthogonal", True),
                    trunk.get("generator"))
        self.log_std = nn.Parameter(torch.zeros(action_dim))

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (mean f32, log_std)."""
        feat = self.base(obs)
        mean = dense(feat, self.act_out.weight.t(), self.act_out.bias, self.base.bf16)
        return mean, self.log_std


class Critic(nn.Module):
    def __init__(self, cent_obs_dim: int, **trunk):
        super().__init__()
        self.base = MLPBase(cent_obs_dim, **trunk)
        self.v_out = nn.Linear(self.base.fc0.out_features, 1)
        init_linear(self.v_out, 1.0, trunk.get("use_orthogonal", True),
                    trunk.get("generator"))

    def forward(self, cent_obs: torch.Tensor) -> torch.Tensor:
        feat = self.base(cent_obs)
        return dense(feat, self.v_out.weight.t(), self.v_out.bias, self.base.bf16)
