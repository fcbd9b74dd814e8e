"""One ``MAPPO.update`` per head kind that is not the Gaussian
(categorical, multi_discrete, multi_binary, mixed) against ``dcc_tpu``'s,
from JAX's sampled rollout and identical converted parameters.

One update per kind from JAX's sampled rollout: in f32 by autograd,
parameters within 3e-5 and metrics within rtol 1e-4 (test_torch_slice's
f32 bounds); in bf16 by autograd through the fused trunk's plain versions
(K2 / K2b), against JAX's bf16 update compiled with
``xla_allow_excess_precision`` off, which keeps its bf16 roundings as a
TPU does (tests/test_torch_unfolded.py): parameters within 2e-4 and
metrics within rtol 2e-3 / atol 1e-5, and the port's update computed in
f32 must land outside the parameter bound.

The bf16 parameter bound is twice test_torch_slice's 1e-4. JAX sums a bf16
head's bias cotangents in bf16 (the transpose of a bf16 broadcast add), the
port in f32 (tests/test_torch_recurrent.py): the head bias gradients differ
by 0.4-2 % relative, the trunk's by 1e-5 or less, and after one Adam step
the second epoch's near-zero gradients move their normalized steps. With
the two biased heads of multi_discrete that reads 1.04e-4 on one feature
norm bias (2.1e-5 from another rollout key); the other kinds read at most
4.2e-6. The port's update computed in f32 lands 6.5e-4 to 1.35e-3 away.
"""

import jax
import numpy as np
import pytest
import torch

from dcc_tpu.algos import MAPPO as JMAPPO
from dcc_tpu.algos import MAPPOConfig as JMAPPOConfig
from dcc_tpu.envs import EnvConfig as JEnvConfig
from dcc_tpu_torch.algos import MAPPO, MAPPOConfig, Trajectory
from dcc_tpu_torch.compat import flax_to_state_dict
from dcc_tpu_torch.envs import EnvConfig

MODE = {"categorical": "discrete", "multi_discrete": "multi_discrete",
        "multi_binary": "multi_binary", "mixed": "mixed"}
SMALL = dict(n_rollout_threads=4, episode_length=8, ppo_epoch=2, n_iters=5, hidden_size=32)


def _pair(kind, compute_dtype="float32"):
    """JAX's MAPPO and the port's for the head ``kind``, the port's networks
    holding JAX's initial parameters; JAX's bf16 trunk runs its kernel
    interpreted, the port's the fused trunk's plain versions."""
    bf16 = compute_dtype == "bfloat16"
    jalgo = JMAPPO(JMAPPOConfig(fused_loss="off", fused_trunk="interpret" if bf16 else "off",
                                gae_backend="xla", fused_block_rows=32,
                                compute_dtype=compute_dtype, **SMALL),
                   JEnvConfig(action_mode=MODE[kind]))
    jts = jalgo.init_state(jax.random.PRNGKey(0))
    algo = MAPPO(MAPPOConfig(fused_trunk="on" if bf16 else "auto",
                             compute_dtype=compute_dtype, **SMALL),
                 EnvConfig(action_mode=MODE[kind]), device="cpu")
    actor, critic = algo.make_networks()
    actor.load_state_dict(flax_to_state_dict(jax.device_get(jts.actor_params)))
    critic.load_state_dict(flax_to_state_dict(jax.device_get(jts.critic_params)))
    return jalgo, jts, algo, algo.init_state(actor=actor, critic=critic)


def _to_torch(jtraj):
    return Trajectory(*(None if getattr(jtraj, f) is None
                        else torch.from_numpy(np.array(getattr(jtraj, f), np.float32))
                        for f in Trajectory._fields))


def _jax_exact(fn, *args):
    """``fn(*args)`` compiled with every bf16 rounding kept."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", list(MODE))
def test_update_matches_jax(kind, compute_dtype):
    jalgo, jts, algo, ts = _pair(kind, compute_dtype)
    bf16 = compute_dtype == "bfloat16"
    assert not algo.fused_loss and algo.fused_trunk == bf16
    jtraj = jalgo.rollout(jts, jax.random.PRNGKey(3), 4)  # sampled actions
    jadv, jret = jalgo.compute_returns(jts, jtraj)
    key = jax.random.PRNGKey(4)
    if bf16:
        jts2, jm = _jax_exact(jalgo.update, jts, key, jtraj, jadv, jret)
    else:
        jts2, jm = jalgo.update(jts, key, jtraj, jadv, jret)
    traj, adv, ret = (_to_torch(jtraj), torch.from_numpy(np.array(jadv)),
                      torch.from_numpy(np.array(jret)))
    m = algo.update(ts, traj, adv, ret)
    tol = 2e-4 if bf16 else 3e-5
    for net, jparams in ((ts.actor, jts2.actor_params), (ts.critic, jts2.critic_params)):
        want = flax_to_state_dict(jax.device_get(jparams))
        got = net.state_dict()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=tol, err_msg=k)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=2e-3 if bf16 else 1e-4,
                               atol=1e-5 if bf16 else 1e-6)
    assert ts.update_count == int(jts2.update_count) == SMALL["ppo_epoch"]
    if bf16:
        _, _, algo32, ts32 = _pair(kind, "float32")
        algo32.update(ts32, traj, adv, ret)
        gap = max(float((p - torch.from_numpy(np.asarray(w))).abs().max())
                  for net, jparams in ((ts32.actor, jts2.actor_params),
                                       (ts32.critic, jts2.critic_params))
                  for p, w in ((net.state_dict()[k], v) for k, v in
                               flax_to_state_dict(jax.device_get(jparams)).items()))
        assert gap > tol, f"the update computed in f32 is within the bf16 bound ({gap:.3e})"
