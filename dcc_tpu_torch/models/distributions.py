"""Action distributions as functions over head outputs (the functions of
:mod:`dcc_tpu.models.distributions`).

* Diagonal Gaussian with a state-independent log-std: log-probs summed over
  action dims with keepdim, entropy per dim.
* Categorical over logits: (..., 1) actions, log-prob of the taken index,
  entropy (...,).
* Bernoulli (MultiBinary): log-prob summed over bits with keepdim, entropy
  per bit.

:func:`sample_head` and :func:`evaluate_head` dispatch on the actor head's
kind as the reference's ACTLayer does, with the JAX package's reductions.
Sampling takes an explicit ``torch.Generator``; a sampled action is always
f32 (category indices as floats). With ``rows = (n, r)`` a sampler draws
its noise for all ``n`` rows and keeps the rows ``r``: a rank of a mesh
draws as one process holding every env would.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _draw(fn, like: torch.Tensor, generator, rows) -> torch.Tensor:
    """``fn`` (``torch.randn`` / ``torch.rand``) at ``like``'s shape, or
    at ``n`` rows of it keeping the rows ``r`` when ``rows = (n, r)``."""
    shape = like.shape if rows is None else (rows[0], *like.shape[1:])
    x = fn(shape, generator=generator, dtype=like.dtype, device=like.device)
    return x if rows is None else x[rows[1]]


# Diagonal Gaussian

def normal_sample(
    mean: torch.Tensor, log_std: torch.Tensor, generator: Optional[torch.Generator] = None,
    rows=None,
) -> torch.Tensor:
    return mean + torch.exp(log_std) * _draw(torch.randn, mean, generator, rows)


def normal_log_prob(mean, log_std, action) -> torch.Tensor:
    """Sum over action dims, keepdim (the reference's FixedNormal.log_probs)."""
    var = torch.exp(2.0 * log_std)
    lp = -((action - mean) ** 2) / (2.0 * var) - log_std - LOG_SQRT_2PI
    return torch.sum(lp, dim=-1, keepdim=True)


def normal_entropy(log_std, mean) -> torch.Tensor:
    """Per-dim entropy broadcast to mean's shape, not summed."""
    return (0.5 + LOG_SQRT_2PI + log_std).expand_as(mean)


def normal_mode(mean: torch.Tensor) -> torch.Tensor:
    return mean


# Categorical

def categorical_sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                       rows=None) -> torch.Tensor:
    """(..., 1) indices drawn by the Gumbel-max trick (as
    ``jax.random.categorical``): no host synchronisation."""
    u = _draw(torch.rand, logits, generator, rows)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1, keepdim=True)


def categorical_log_prob(logits: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """(..., 1) log-prob of the (..., 1) index ``action`` (float or int)."""
    return torch.gather(F.log_softmax(logits, dim=-1), -1, action.long())


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def categorical_mode(logits: torch.Tensor) -> torch.Tensor:
    """(..., 1) argmax; a tie goes to the first index, as ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1, keepdim=True)


# Bernoulli (MultiBinary actions)

def bernoulli_sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                     rows=None) -> torch.Tensor:
    u = _draw(torch.rand, logits, generator, rows)
    return (u < torch.sigmoid(logits)).to(logits.dtype)


def bernoulli_log_prob(logits: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Sum over bits, keepdim."""
    lp = action * F.logsigmoid(logits) + (1.0 - action) * F.logsigmoid(-logits)
    return torch.sum(lp, dim=-1, keepdim=True)


def bernoulli_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Per-bit entropy (..., n), reduced by the caller."""
    p = torch.sigmoid(logits)
    return -(p * F.logsigmoid(logits) + (1.0 - p) * F.logsigmoid(-logits))


def bernoulli_mode(logits: torch.Tensor) -> torch.Tensor:
    return (logits > 0).to(logits.dtype)


# Head dispatch. ``out`` is the Actor head's output for its kind:
#   gaussian       -> (mean, log_std)
#   categorical    -> logits
#   multi_discrete -> tuple of per-branch logits
#   multi_binary   -> logits (..., n)
#   mixed          -> ((mean, log_std), discrete logits)
# sample_head returns (action, log_probs); evaluate_head (log_probs,
# per-sample entropy), which the caller reduces as ent.sum(-1).mean(): the
# entropies are pre-scaled so that reproduces the reference's weightings.

def sample_head(kind: str, out, deterministic: bool = False,
                generator: Optional[torch.Generator] = None, rows=None):
    if kind == "gaussian":
        mean, log_std = out
        action = normal_mode(mean) if deterministic else normal_sample(mean, log_std, generator,
                                                                       rows)
        return action, normal_log_prob(mean, log_std, action)
    if kind == "categorical":
        action = categorical_mode(out) if deterministic else categorical_sample(out, generator,
                                                                                rows)
        return action.float(), categorical_log_prob(out, action)
    if kind == "multi_discrete":
        # one generator feeds the branches in order; the per-branch
        # log-probs stay separate columns (the reference cats, not sums)
        actions, lps = [], []
        for logits in out:
            a = categorical_mode(logits) if deterministic else categorical_sample(
                logits, generator, rows)
            actions.append(a.float())
            lps.append(categorical_log_prob(logits, a))
        return torch.cat(actions, dim=-1), torch.cat(lps, dim=-1)
    if kind == "multi_binary":
        action = bernoulli_mode(out) if deterministic else bernoulli_sample(out, generator, rows)
        return action, bernoulli_log_prob(out, action)
    if kind == "mixed":
        (mean, log_std), logits = out
        a_c = normal_mode(mean) if deterministic else normal_sample(mean, log_std, generator,
                                                                    rows)
        a_d = categorical_mode(logits) if deterministic else categorical_sample(logits,
                                                                                generator, rows)
        lp = normal_log_prob(mean, log_std, a_c) + categorical_log_prob(logits, a_d)
        return torch.cat([a_c, a_d.to(a_c.dtype)], dim=-1), lp
    raise ValueError(f"unknown head kind {kind!r}")


def evaluate_head(kind: str, out, action: torch.Tensor):
    if kind == "gaussian":
        mean, log_std = out
        return normal_log_prob(mean, log_std, action), normal_entropy(log_std, mean)
    if kind == "categorical":
        return categorical_log_prob(out, action), categorical_entropy(out)[..., None]
    if kind == "multi_discrete":
        # the reference's entropy is the MEAN over branches: each branch's
        # is divided by the branch count so the caller's sum(-1) gives it
        nb = len(out)
        lps = [categorical_log_prob(lg, action[..., i : i + 1]) for i, lg in enumerate(out)]
        ents = [categorical_entropy(lg)[..., None] / nb for lg in out]
        return torch.cat(lps, dim=-1), torch.cat(ents, dim=-1)
    if kind == "multi_binary":
        return bernoulli_log_prob(out, action), bernoulli_entropy(out)
    if kind == "mixed":
        (mean, log_std), logits = out
        cont = mean.shape[-1]
        lp = (normal_log_prob(mean, log_std, action[..., :cont])
              + categorical_log_prob(logits, action[..., cont:]))
        # the reference's weighting e_gauss / 2.0 + e_cat / 0.98, its
        # gaussian term a mean over dims
        ent = (normal_entropy(log_std, mean).mean(dim=-1, keepdim=True) / 2.0
               + categorical_entropy(logits)[..., None] / 0.98)
        return lp, ent
    raise ValueError(f"unknown head kind {kind!r}")
