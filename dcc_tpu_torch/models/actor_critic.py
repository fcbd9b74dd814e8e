"""Actor and centralized critic: MLP trunk -> optional GRU -> head.

Counterparts of :class:`dcc_tpu.models.actor_critic.Actor` and
:class:`~dcc_tpu.models.actor_critic.Critic` (``v_out`` with orthogonal gain
1). The actor's head dispatches on ``head_kind``, as the reference's
ACTLayer, each Linear with orthogonal gain ``gain`` (0.01) and zero bias:

* ``gaussian`` (Box): ``act_out`` mean and a state-independent ``log_std``;
* ``categorical`` (Discrete) and ``multi_binary``: ``act_out`` logits;
* ``multi_discrete``: ``act_out{i}`` logits per branch, ``head_dims`` the
  per-branch category counts;
* ``mixed`` (Box + Discrete): ``act_out`` mean, ``log_std`` and
  ``act_out_disc`` logits, ``head_dims`` = (continuous dim, category count).

The head's output is what :func:`~dcc_tpu_torch.models.distributions.sample_head`
takes. ``trunk`` holds the :class:`MLPBase` arguments; ``use_rnn`` adds a
:class:`MaskedGRU` (``rnn``) after the trunk. In bf16 mode every head Linear
runs with bf16 operands and a bf16 bias add, and its outputs are f32, as in
the JAX package.

Feed-forward calls take only the observations and return the head output.
With a GRU, ``forward`` takes ``(obs, rnn_state (B, L, H), masks (B, 1))``
for one rollout step and ``sequence`` takes ``(obs (T, B, D), h0, masks (T,
B, 1))`` for training; both also return the new hidden state.
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
        self.defer_grad_round = False  # see defer_grad_rounding
        hidden = self.base.fc0.out_features
        self.rnn = (MaskedGRU(hidden, recurrent_n, trunk.get("use_orthogonal", True),
                              trunk.get("generator")) if use_rnn else None)

    def defer_grad_rounding(self) -> None:
        """Leave the bf16 Dense layers' parameter gradients (those of
        :meth:`dense_params`) unrounded f32 sums over the rows, for a caller
        that adds them over ranks and then rounds them as one process's
        autograd does (MAPPO under a mesh)."""
        self.defer_grad_round = self.base.defer_grad_round = True

    def dense_params(self) -> list:
        """The parameters of the bf16 Dense layers run by autograd: the
        heads' and, unfused, the trunk's W and b."""
        heads = [m for n, m in self.named_children() if n.startswith(("act_out", "v_out"))]
        return [p for m in heads for p in (m.weight, m.bias)] + self.base.dense_params()

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
                 use_rnn: bool = False, recurrent_n: int = 1, head_kind: str = "gaussian",
                 head_dims: tuple = (), **trunk):
        super().__init__(obs_dim, use_rnn, recurrent_n, **trunk)
        self.kind = head_kind
        self.head_dims = tuple(head_dims)
        hidden = self.base.fc0.out_features

        def linear(name, n):
            layer = nn.Linear(hidden, n)
            init_linear(layer, gain, trunk.get("use_orthogonal", True), trunk.get("generator"))
            setattr(self, name, layer)

        if head_kind == "multi_discrete":
            for i, n in enumerate(self.head_dims):
                linear(f"act_out{i}", n)
        elif head_kind == "mixed":
            cont_dim, disc_n = self.head_dims
            linear("act_out", cont_dim)
            linear("act_out_disc", disc_n)
            self.log_std = nn.Parameter(torch.zeros(cont_dim))
        elif head_kind in ("gaussian", "categorical", "multi_binary"):
            linear("act_out", action_dim)
            if head_kind == "gaussian":
                self.log_std = nn.Parameter(torch.zeros(action_dim))
        else:
            raise ValueError(f"unknown head kind {head_kind!r}")

    def _dense(self, layer, x):
        return dense(x, layer.weight.t(), layer.bias, self.base.bf16,
                     not self.defer_grad_round)

    def _head(self, x):
        kind = self.kind
        if kind == "multi_discrete":
            return tuple(self._dense(getattr(self, f"act_out{i}"), x)
                         for i in range(len(self.head_dims)))
        if kind == "mixed":
            return ((self._dense(self.act_out, x), self.log_std),
                    self._dense(self.act_out_disc, x))
        out = self._dense(self.act_out, x)
        return (out, self.log_std) if kind == "gaussian" else out

    def forward(self, obs: torch.Tensor, rnn_state: Optional[torch.Tensor] = None,
                masks: Optional[torch.Tensor] = None):
        """The head output (gaussian: (mean f32, log_std)), and with
        ``rnn_state`` (head output, new hidden state)."""
        x, h = self.features(obs, rnn_state, masks)
        return self._head(x) if rnn_state is None else (self._head(x), h)

    def sequence(self, obs_seq, h0, masks_seq):
        """(head output over (T, B, .), final hidden)."""
        x, h = self.features_seq(obs_seq, h0, masks_seq)
        return self._head(x), h


class Critic(_Trunk):
    def __init__(self, cent_obs_dim: int, use_rnn: bool = False, recurrent_n: int = 1,
                 **trunk):
        super().__init__(cent_obs_dim, use_rnn, recurrent_n, **trunk)
        self.v_out = nn.Linear(self.base.fc0.out_features, 1)
        init_linear(self.v_out, 1.0, trunk.get("use_orthogonal", True),
                    trunk.get("generator"))

    def _head(self, x):
        return dense(x, self.v_out.weight.t(), self.v_out.bias, self.base.bf16,
                     not self.defer_grad_round)

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
