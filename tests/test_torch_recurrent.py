"""Recurrent MAPPO (ROADMAP A7) against ``dcc_tpu``, from identical converted
parameters.

* ``MaskedGRU``: one step and a sequence across mask resets, with
  ``recurrent_n`` 1 and 2, against flax's module (atol 1e-5: f32 summation
  order of the gate matmuls), and the parameter tree converts both ways.
* A deterministic recurrent rollout, stored hidden states included, against
  JAX's (atol 1e-4, as the feed-forward rollout in tests/test_torch_slice.py).
* One recurrent ``update`` on the same trajectory, post-update parameters
  and the six metrics: f32 with the trunk kernel off on both sides (params
  atol 3e-5, as the feed-forward test), bf16 with JAX's interpreted trunk
  kernel against the port's ``fused_trunk="on"`` (K2 / K2b plain versions
  on the CPU; params atol 1e-4 and metrics rtol 2e-3, as the bf16
  feed-forward test, measured 4.6e-5 and 3.5e-4), ``use_naive_recurrent``
  and ``data_chunk_length=4``.

The bf16 metrics take atol 3e-5 where the feed-forward test takes 1e-5.
On the autograd path JAX sums the bf16 heads' bias cotangents in bf16
(the transpose of a bf16 broadcast add), the port in f32: the act_out bias
gradient differs by 8.5e-3 relative, the trunk and GRU gradients by 1e-7
(measured on the CPU). After one Adam step that moves the second epoch's
policy loss, a mean of +-advantage terms that cancels to -7.9e-4, by
1.5e-5. The port's update computed in f32 lands 1.4e-3 from JAX's bf16 one
in the parameters and 3 % in the critic's gradient norm, outside both
bounds.
"""

import jax
import numpy as np
import pytest
import torch

from dcc_tpu.algos import MAPPO as JMAPPO
from dcc_tpu.algos import MAPPOConfig as JMAPPOConfig
from dcc_tpu.envs import EnvConfig as JEnvConfig
from dcc_tpu.models.rnn import MaskedGRU as JMaskedGRU
from dcc_tpu_torch import train
from dcc_tpu_torch.algos import MAPPO, MAPPOConfig, Trajectory
from dcc_tpu_torch.compat import flax_to_state_dict, state_dict_to_flax
from dcc_tpu_torch.envs import EnvConfig
from dcc_tpu_torch.models import MaskedGRU

SMALL = dict(n_rollout_threads=2, episode_length=8, ppo_epoch=2, n_iters=5, hidden_size=16,
             use_recurrent_policy=True, data_chunk_length=2)


def _perturb(tree, seed):
    """Move every 1-D leaf (biases, LN affines, log_std) off its init value."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=np.shape(a))).astype(np.float32)
        if np.ndim(a) == 1 else np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("recurrent_n", [1, 2])
def test_masked_gru_matches_flax(recurrent_n):
    H, B, T = 16, 5, 6
    rng = np.random.default_rng(recurrent_n)
    xs = rng.normal(size=(T, B, H)).astype(np.float32)
    h0 = rng.normal(size=(B, recurrent_n, H)).astype(np.float32)
    masks = np.ones((T, B, 1), np.float32)
    masks[0, 4] = masks[3, 1] = masks[3, 2] = 0.0  # resets at the start and mid-sequence
    jm = JMaskedGRU(hidden_size=H, recurrent_n=recurrent_n)
    params = _perturb(jax.device_get(jm.init(jax.random.PRNGKey(0), xs[0], h0, masks[0])),
                      recurrent_n)
    m = MaskedGRU(H, recurrent_n)
    m.load_state_dict(flax_to_state_dict(params))
    assert m.gru0.hr.bias is None and m.gru0.hz.bias is None  # flax: no b_hr, b_hz
    with torch.no_grad():
        out, h = m(torch.from_numpy(xs[0]), torch.from_numpy(h0), torch.from_numpy(masks[0]))
        seq, h_seq = m.sequence(torch.from_numpy(xs), torch.from_numpy(h0),
                                torch.from_numpy(masks))
    jout, jh = jm.apply(params, xs[0], h0, masks[0])
    jseq, jh_seq = jm.apply(params, xs, h0, masks, method="sequence")
    for got, want in ((out, jout), (h, jh), (seq, jseq), (h_seq, jh_seq)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    back = state_dict_to_flax(m.state_dict())
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = jax.tree_util.tree_leaves_with_path(back)
    assert len(got) == len(want) == 10 * recurrent_n + 2
    for path, leaf in got:
        np.testing.assert_array_equal(leaf, want[path])


def _pair(compute_dtype="float32", **kw):
    cfg = dict(SMALL, **kw)
    bf16 = compute_dtype == "bfloat16"
    jalgo = JMAPPO(
        JMAPPOConfig(fused_trunk="interpret" if bf16 else "off", gae_backend="xla",
                     fused_block_rows=32, compute_dtype=compute_dtype, **cfg),
        JEnvConfig(),
    )
    jts = jalgo.init_state(jax.random.PRNGKey(0))
    jts = jts.replace(actor_params=_perturb(jax.device_get(jts.actor_params), 1),
                      critic_params=_perturb(jax.device_get(jts.critic_params), 2))
    algo = MAPPO(MAPPOConfig(fused_trunk="on" if bf16 else "off",
                             compute_dtype=compute_dtype, **cfg), EnvConfig(), device="cpu")
    actor, critic = algo.make_networks()
    actor.load_state_dict(flax_to_state_dict(jts.actor_params))
    critic.load_state_dict(flax_to_state_dict(jts.critic_params))
    return jalgo, jts, algo, algo.init_state(actor=actor, critic=critic)


def _to_torch(jtraj):
    return Trajectory(*(torch.from_numpy(np.array(getattr(jtraj, f), np.float32))
                        for f in Trajectory._fields))


def test_recurrent_rollout_matches_jax():
    jalgo, jts, algo, ts = _pair(recurrent_n=2)
    jtraj = jalgo.rollout(jts, jax.random.PRNGKey(1), 2, deterministic=True)
    traj = algo.rollout(ts, 2, deterministic=True)
    assert traj.actor_h.shape == (8, 2, 4, 2, 16) and traj.critic_h.shape == (8, 2, 2, 16)
    assert float(traj.actor_h[0].abs().max()) == 0.0  # zeros at the reset
    assert float(traj.actor_h[1:].abs().max()) > 0.0
    for f in Trajectory._fields:
        np.testing.assert_allclose(getattr(traj, f).float().numpy(),
                                   np.asarray(getattr(jtraj, f), np.float32),
                                   atol=1e-4, err_msg=f)


@pytest.mark.parametrize(
    "compute_dtype,kw",
    [("float32", {}), ("bfloat16", {}),
     ("float32", dict(use_recurrent_policy=False, use_naive_recurrent=True)),
     ("float32", dict(data_chunk_length=4))],
    ids=["f32", "bf16-fused-trunk", "naive", "chunk4"],
)
def test_recurrent_update_matches_jax(compute_dtype, kw):
    jalgo, jts, algo, ts = _pair(compute_dtype, **kw)
    bf16 = compute_dtype == "bfloat16"
    assert algo.recurrent and algo.fused_trunk == bf16 and not algo.fused_loss
    # sampled actions: with deterministic ones the first-epoch actor gradient
    # is exactly zero and Adam would turn rounding noise into full steps
    jtraj = jalgo.rollout(jts, jax.random.PRNGKey(3), 2)
    jadv, jret = jalgo.compute_returns(jts, jtraj)
    jts2, jm = jalgo.update(jts, jax.random.PRNGKey(4), jtraj, jadv, jret)
    m = algo.update(ts, _to_torch(jtraj), torch.from_numpy(np.array(jadv)),
                    torch.from_numpy(np.array(jret)))
    for net, jparams in ((ts.actor, jts2.actor_params), (ts.critic, jts2.critic_params)):
        want = flax_to_state_dict(jax.device_get(jparams))
        got = net.state_dict()
        assert set(got) == set(want) and any(k.startswith("rnn.gru0.") for k in want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=1e-4 if bf16 else 3e-5, err_msg=k)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=2e-3 if bf16 else 1e-4,
                               atol=3e-5 if bf16 else 1e-6)
    assert ts.update_count == int(jts2.update_count) == 2
    assert ts.iteration == int(jts2.iteration) == 1


def test_recurrent_dispatch():
    env = EnvConfig()
    with pytest.raises(ValueError, match="divisible"):
        MAPPO(MAPPOConfig(use_recurrent_policy=True, episode_length=12, data_chunk_length=10),
              env, device="cpu")
    with pytest.raises(ValueError, match="recurrent"):
        MAPPO(MAPPOConfig(use_recurrent_policy=True, fused_loss="on"), env, device="cpu")
    # naive recurrence uses whole episodes: no divisibility rule
    algo = MAPPO(MAPPOConfig(use_naive_recurrent=True, episode_length=12), env, device="cpu")
    assert algo.recurrent and not algo.fused_loss


def test_recurrent_cli_trains_on_cpu():
    learner = train.main(["--device", "cpu", "--use-recurrent-policy", "true", "--n-iters", "1",
                          "--n-rollout-threads", "2", "--save-gifs", "false", "--save-model",
                          "false", "--max-ep-len", "20", "--ppo-epoch", "2",
                          "--algo-hidden-size", "32", "--n-eval-rollout-threads", "0"])
    assert learner.algo.recurrent and learner.ts.iteration == 1
    assert all(np.isfinite(v) for v in learner.last_metrics)
