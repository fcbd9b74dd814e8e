"""ROADMAP C4, the reference side of the paired test: from the training
states that ``scripts/bf16_update_probe.py --save-states`` saved on the
card, the port's plain bf16 update against the JAX package's bf16 update
with its Pallas kernels interpreted, on the CPU.

    JAX_PLATFORMS=cpu python scripts/c4_jax_paired.py STATE.pt [STATE.pt ...]
        [--out FILE]
    python scripts/c4_jax_paired.py --summary FILE [FILE ...]

A comparison tool like the tests (it imports both packages; the port never
imports JAX). Each state holds the bf16 arm's networks, both Adams, the
value normalizer and the counters before the update of one iteration, and
that iteration's batch (its rollout, advantages and returns). From it the
update runs three ways on the CPU:

* c: the port's plain bf16 update (the fused loss's plain versions);
* j: the JAX package's bf16 update, its K3 / K4 interpreted, compiled with
  ``xla_allow_excess_precision`` off (tests/test_torch_bf16_path.py);
* f: the port's f32 autograd update, the direction of reference.

Per state and network it prints d_c = ||D_c - D_f|| / ||D_f|| and d_j, the
distance of c from j, and the f32-evaluated surrogate gain of each update's
actor; then the one-sided sign test of d_j > d_c over the states. A fault
of the port's shared bf16 path shows as d_c > d_j on most states, or as a
steady loss of surrogate gain against j. ``--summary`` prints the sign
tests over the JSON lines that ``--out`` appended (several runs' files).
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import bf16_update_probe as probe  # noqa: E402
from dcc_tpu.algos import MAPPO as JMAPPO  # noqa: E402
from dcc_tpu.algos.mappo import Trajectory as JTrajectory  # noqa: E402
from dcc_tpu.configs import load as j_load  # noqa: E402
from dcc_tpu_torch.algos import MAPPO, Trajectory  # noqa: E402
from dcc_tpu_torch.algos.mappo import normalize_advantages  # noqa: E402
from dcc_tpu_torch.compat import flax_to_state_dict, state_dict_to_flax  # noqa: E402
from dcc_tpu_torch.configs.loader import load as load_config  # noqa: E402
from dcc_tpu_torch.models import distributions as D  # noqa: E402


def _like(template, tree):
    """``tree``'s leaves (numpy) in ``template``'s tree structure and dtypes."""
    leaves = jax.tree_util.tree_leaves(tree)
    tleaves, treedef = jax.tree_util.tree_flatten(template)
    assert [np.shape(a) for a in leaves] == [np.shape(t) for t in tleaves]
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a, t.dtype) for a, t in zip(leaves, tleaves)])


def _opt_state(template, net, opt_sd):
    """JAX's optax state of one network from the torch Adam's: the moments
    under the parameters' flax names, every count the Adam's step."""
    named = list(net.named_parameters())
    st = opt_sd["state"]  # empty before the first step
    mu = state_dict_to_flax({n: st[i]["exp_avg"] if i in st else torch.zeros_like(p)
                             for i, (n, p) in enumerate(named)})
    nu = state_dict_to_flax({n: st[i]["exp_avg_sq"] if i in st else torch.zeros_like(p)
                             for i, (n, p) in enumerate(named)})
    count = int(st[0]["step"]) if st else 0

    def fix(x):
        if isinstance(x, optax.ScaleByAdamState):
            return x._replace(count=jnp.asarray(count, x.count.dtype),
                              mu=_like(x.mu, mu), nu=_like(x.nu, nu))
        if isinstance(x, optax.ScaleByScheduleState):
            return x._replace(count=jnp.asarray(count, x.count.dtype))
        if isinstance(x, tuple) and not hasattr(x, "_fields"):
            return tuple(fix(y) for y in x)
        return x

    return fix(template)


def jax_update(jalgo, jts0, snap, traj, adv, ret, port_ts):
    """JAX's update from the saved state; returns its new actor and critic
    parameters as torch state dicts."""
    jts = jts0.replace(
        actor_params=_like(jts0.actor_params, state_dict_to_flax(snap["actor"])),
        critic_params=_like(jts0.critic_params, state_dict_to_flax(snap["critic"])),
        actor_opt=_opt_state(jts0.actor_opt, port_ts.actor, snap["actor_opt"]),
        critic_opt=_opt_state(jts0.critic_opt, port_ts.critic, snap["critic_opt"]),
        vnorm=type(jts0.vnorm)(*(jnp.asarray(t.numpy()) for t in snap["vnorm"])),
        update_count=jnp.asarray(snap["update_count"], jts0.update_count.dtype),
        iteration=jnp.asarray(snap["iteration"], jts0.iteration.dtype),
    )
    fields = {f: (None if traj.get(f) is None else jnp.asarray(traj[f].float().numpy()))
              for f in JTrajectory._fields}
    fields["obs"] = fields["obs"].astype(traj["obs"].dtype == torch.bfloat16
                                         and jnp.bfloat16 or jnp.float32)
    jtraj = JTrajectory(**fields)
    args = (jts, jax.random.PRNGKey(0), jtraj, jnp.asarray(adv.numpy()),
            jnp.asarray(ret.numpy()))
    jts2, _ = jax.jit(jalgo.update).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)
    return (flax_to_state_dict(jax.device_get(jts2.actor_params)),
            flax_to_state_dict(jax.device_get(jts2.critic_params)))


@torch.no_grad()
def surrogate_gain(algo, snap, actor_sd, traj, adv, clip):
    """The f32-evaluated surrogate gain of the actor ``actor_sd`` over the
    saved one on the batch."""
    ts = algo.init_state(0)
    T, E, A, _ = traj.actions.shape
    obs = traj.obs[:-1].float()
    adv_n = normalize_advantages(adv)[:, :, None, :].expand(T, E, A, 1)
    lps = []
    for sd in (snap["actor"], actor_sd):
        ts.actor.load_state_dict(sd)
        lps.append(D.evaluate_head(algo.head_kind, ts.actor(obs), traj.actions)[0])
    r = torch.exp(lps[1] - lps[0])
    surr = torch.minimum(r * adv_n, torch.clamp(r, 1 - clip, 1 + clip) * adv_n).mean()
    return float(surr - adv_n.mean())


def one_state(path, out):
    blob = torch.load(path, map_location="cpu", weights_only=False)
    snap, tdict, adv, ret = blob["snapshot"], blob["traj"], blob["adv"], blob["ret"]
    traj = Trajectory(*(tdict.get(f) for f in Trajectory._fields))
    _, env_cfg, cfg = load_config({"compute_dtype": "bfloat16"})
    _, jenv, jcfg = j_load({"compute_dtype": "bfloat16"})
    jalgo = JMAPPO(jcfg._replace(fused_loss="interpret", fused_trunk="interpret",
                                 gae_backend="xla"), jenv)
    jts0 = jalgo.init_state(jax.random.PRNGKey(0))
    algo_c = MAPPO(cfg._replace(fused_loss="on", fused_trunk="on"), env_cfg, device="cpu")
    algo_f = MAPPO(cfg._replace(compute_dtype="float32"), env_cfg, device="cpu")
    start = {f"{n}.{k}": v.float() for n in probe.NETS for k, v in snap[n].items()}
    changes = {}
    for way, algo in (("c", algo_c), ("f", algo_f)):
        changes[way] = probe.run_way(algo, snap, traj, adv, ret, start)[0][-1]
    ja, jc = jax_update(jalgo, jts0, snap, tdict, adv, ret, algo_c.init_state(0))
    after = {**{f"actor.{k}": v for k, v in ja.items()},
             **{f"critic.{k}": v for k, v in jc.items()}}
    changes["j"] = {k: after[k].float() - start[k] for k in start}
    rec = {"state": os.path.basename(path), "nets": {}}
    for net in probe.NETS:
        keys = [k for k in start if k.startswith(net)]
        rec["nets"][net] = {
            "d_c": probe.dist(changes["c"], changes["f"], keys),
            "d_j": probe.dist(changes["j"], changes["f"], keys),
            "c_vs_j": probe.dist(changes["c"], changes["j"], keys),
        }
    actors = {w: {k[len("actor."):]: start[k] + changes[w][k] for k in start
                  if k.startswith("actor.")} for w in ("c", "j", "f")}
    rec["surrogate_gain"] = {w: surrogate_gain(algo_f, snap, sd, traj, adv, cfg.clip_param)
                             for w, sd in actors.items()}
    a, c = rec["nets"]["actor"], rec["nets"]["critic"]
    print(f"{rec['state']}: actor d_c {a['d_c']:.4f} d_j {a['d_j']:.4f} c-j {a['c_vs_j']:.4f}; "
          f"critic d_c {c['d_c']:.4f} d_j {c['d_j']:.4f} c-j {c['c_vs_j']:.4f}; gain "
          + ", ".join(f"{w} {v:.6f}" for w, v in rec["surrogate_gain"].items()), flush=True)
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


def summary(recs) -> None:
    n = len(recs)
    for net in probe.NETS:
        dc = [r["nets"][net]["d_c"] for r in recs]
        dj = [r["nets"][net]["d_j"] for r in recs]
        wins = sum(a > b for a, b in zip(dc, dj))
        print(f"{net}: mean d_c {sum(dc) / n:.4f}, d_j {sum(dj) / n:.4f}; d_c > d_j on "
              f"{wins}/{n} (one-sided sign test p {probe.binom_tail(wins, n):.4f})")
    gains = {w: [r["surrogate_gain"][w] for r in recs] for w in ("c", "j", "f")}
    less = sum(a < b for a, b in zip(gains["c"], gains["j"]))
    print("surrogate gain: " + ", ".join(f"{w} {sum(v) / n:.6f}" for w, v in gains.items())
          + f"; c < j on {less}/{n} (p {probe.binom_tail(less, n):.4f})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("states", nargs="+", help="states (.pt), or with --summary JSON-line files")
    ap.add_argument("--out", default=None, help="append one JSON line per state")
    ap.add_argument("--summary", action="store_true")
    args = ap.parse_args(argv)
    if args.summary:
        recs = [json.loads(line) for path in args.states for line in open(path) if line.strip()]
    else:
        recs = [one_state(p, args.out) for p in args.states]
    print(f"{len(recs)} states")
    summary(recs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
