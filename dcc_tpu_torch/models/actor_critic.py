"""Gaussian actor and centralized critic: MLP trunk -> optional GRU -> head.

Counterparts of :class:`dcc_tpu.models.actor_critic.Actor` (gaussian head:
Linear mean with orthogonal gain 0.01 and a state-independent ``log_std``)
and :class:`~dcc_tpu.models.actor_critic.Critic` (``v_out`` with orthogonal
gain 1). ``trunk`` holds the :class:`MLPBase` arguments; ``use_rnn`` adds a
:class:`MaskedGRU` (``rnn``) after the trunk. In bf16 mode the head runs with
bf16 operands and a bf16 bias add, and its outputs are f32, as in the JAX
package.

Feed-forward calls take only the observations. With a GRU, ``forward``
takes ``(obs, rnn_state (B, L, H), masks (B, 1))`` for one rollout step and
``sequence`` takes ``(obs (T, B, D), h0, masks (T, B, 1))`` for training;
both also return the new hidden state.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.fused_mlp import dense
from .mlp import MLPBase, init_linear
from .rnn import MaskedGRU


class _Trunk(nn.Module):
    def __init__(self, in_dim: int, use_rnn: bool = False, recurrent_n: int = 1, **trunk):
        super().__init__()
        self.base = MLPBase(in_dim, **trunk)
        hidden = self.base.fc0.out_features
        self.rnn = (MaskedGRU(hidden, recurrent_n, trunk.get("use_orthogonal", True),
                              trunk.get("generator")) if use_rnn else None)

    def features(self, obs, rnn_state=None, masks=None):
        x = self.base(obs)
        if self.rnn is not None:
            x, rnn_state = self.rnn(x, rnn_state, masks)
        return x, rnn_state

    def features_seq(self, obs_seq, h0, masks_seq):
        x = self.base(obs_seq)  # row-wise, works on (T, B, D)
        if self.rnn is not None:
            x, h0 = self.rnn.sequence(x, h0, masks_seq)
        return x, h0


class Actor(_Trunk):
    def __init__(self, obs_dim: int, action_dim: int = 2, gain: float = 0.01,
                 use_rnn: bool = False, recurrent_n: int = 1, **trunk):
        super().__init__(obs_dim, use_rnn, recurrent_n, **trunk)
        self.act_out = nn.Linear(self.base.fc0.out_features, action_dim)
        init_linear(self.act_out, gain, trunk.get("use_orthogonal", True),
                    trunk.get("generator"))
        self.log_std = nn.Parameter(torch.zeros(action_dim))

    def _head(self, x):
        return dense(x, self.act_out.weight.t(), self.act_out.bias, self.base.bf16)

    def forward(self, obs: torch.Tensor, rnn_state: Optional[torch.Tensor] = None,
                masks: Optional[torch.Tensor] = None):
        """Returns (mean f32, log_std), plus the new hidden state when
        ``rnn_state`` is given."""
        x, h = self.features(obs, rnn_state, masks)
        if rnn_state is None:
            return self._head(x), self.log_std
        return self._head(x), self.log_std, h

    def sequence(self, obs_seq, h0, masks_seq):
        """(mean (T, B, act) f32, log_std, final hidden)."""
        x, h = self.features_seq(obs_seq, h0, masks_seq)
        return self._head(x), self.log_std, h


class Critic(_Trunk):
    def __init__(self, cent_obs_dim: int, use_rnn: bool = False, recurrent_n: int = 1,
                 **trunk):
        super().__init__(cent_obs_dim, use_rnn, recurrent_n, **trunk)
        self.v_out = nn.Linear(self.base.fc0.out_features, 1)
        init_linear(self.v_out, 1.0, trunk.get("use_orthogonal", True),
                    trunk.get("generator"))

    def _head(self, x):
        return dense(x, self.v_out.weight.t(), self.v_out.bias, self.base.bf16)

    def forward(self, cent_obs: torch.Tensor, rnn_state: Optional[torch.Tensor] = None,
                masks: Optional[torch.Tensor] = None):
        """Returns the value (f32), plus the new hidden state when
        ``rnn_state`` is given."""
        x, h = self.features(cent_obs, rnn_state, masks)
        return self._head(x) if rnn_state is None else (self._head(x), h)

    def sequence(self, cent_obs_seq, h0, masks_seq):
        """(values (T, B, 1) f32, final hidden)."""
        x, h = self.features_seq(cent_obs_seq, h0, masks_seq)
        return self._head(x), h
