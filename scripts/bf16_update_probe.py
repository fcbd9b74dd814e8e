"""The paired test of ROADMAP C4: does one bf16 update through the fused
loss's kernels (K3 / K4) depart from the same update through their plain
versions, over states of the bf16 arm's own training on the card?

    python scripts/bf16_update_probe.py [--seeds 0 ... 7] [--iters 1 50 100 150]
        [--pool 8] [--out DIR] [--save-states ITER | --save-only]
    python scripts/bf16_update_probe.py --summary DIR

Each seed trains the learning gate's bf16 arm (the default config in
bfloat16, 16 envs, T = 150, 15 epochs, K1-K4 on the card) as
``scripts/run_torch_curve.py`` does. At each of ``--iters`` the
iteration's own rollout and returns are taken, the state is saved
(networks, both Adams, the value normalizer, the counters), and the
update runs from it four ways on that batch:

* k: the card's bf16 path, K3 / K4 (the update training goes on with);
* p: the same with K3 / K4 replaced by their plain versions on the card;
* c: the plain bf16 update on the CPU;
* f: f32 autograd on the card, the direction of reference.

Per state and network it records d_w = ||D_w - D_f|| / ||D_f|| for w in
k, p, c (D_w the parameter change of way w), the cosines to D_f, the same
distances after every epoch and per parameter tensor, and, evaluated in
f32 on the batch, each update's surrogate gain, approx-KL and value-loss
reduction; then, on the first epoch's inputs, K3's and K4's gradients
against their plain versions on the card per output tensor. One JSON file
per state goes to ``DIR`` (default ``results/c4_probe``), seeds run as child
processes ``--pool`` at a time.

``--summary DIR`` prints the table of the states and the one-sided sign
tests: a fault of the kernels shows as d_k > d_p on most states (p < 0.01
over 32 states) or as a steady loss of surrogate gain; noise as neither.
``--save-states ITER`` also saves each seed's state and batch at that
iteration to ``DIR/states/s{SEED}_i{ITER}.pt`` (4.4 MB each), and
``--save-only`` saves them at every one of ``--iters`` and runs no
comparison: the inputs of ``scripts/c4_jax_paired.py``, JAX's side.
"""

import argparse
import copy
import glob
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from dcc_tpu_torch.algos import MAPPO, Trajectory  # noqa: E402
from dcc_tpu_torch.algos.mappo import normalize_advantages  # noqa: E402
from dcc_tpu_torch.configs.loader import load as load_config  # noqa: E402
from dcc_tpu_torch.models import distributions as D  # noqa: E402
from dcc_tpu_torch.models import valuenorm as VN  # noqa: E402
from dcc_tpu_torch.ops import fused_ppo as FP  # noqa: E402

WAYS = ("k", "p", "c", "f")
NETS = ("actor", "critic")


class plain_loss_on_card:
    """Within the context, K3 / K4's wrappers run their plain versions on
    the card's tensors (way p)."""

    def __enter__(self):
        self.saved = (FP.actor_grads_cuda, FP.critic_grads_cuda)
        FP.actor_grads_cuda, FP.critic_grads_cuda = FP.actor_grads_plain, FP.critic_grads_plain

    def __exit__(self, *exc):
        FP.actor_grads_cuda, FP.critic_grads_cuda = self.saved


def flat_params(ts) -> dict:
    return {f"{n}.{k}": v.detach().float().cpu().clone()
            for n, net in (("actor", ts.actor), ("critic", ts.critic))
            for k, v in net.state_dict().items()}


def dist(a: dict, b: dict, keys) -> float:
    """||a - b|| / ||b|| over ``keys``."""
    num = sum(float((a[k] - b[k]).double().square().sum()) for k in keys)
    den = sum(float(b[k].double().square().sum()) for k in keys)
    return math.sqrt(num / max(den, 1e-300))


def cosine(a: dict, b: dict, keys) -> float:
    dot = sum(float((a[k].double() * b[k].double()).sum()) for k in keys)
    na = math.sqrt(sum(float(a[k].double().square().sum()) for k in keys))
    nb = math.sqrt(sum(float(b[k].double().square().sum()) for k in keys))
    return dot / max(na * nb, 1e-300)


def snapshot(ts) -> dict:
    """A copy of the train state's networks, Adams, normalizer and
    counters (not its generator: the CPU's and the card's differ)."""
    return copy.deepcopy({
        "actor": ts.actor.state_dict(), "critic": ts.critic.state_dict(),
        "actor_opt": ts.actor_opt.state_dict(), "critic_opt": ts.critic_opt.state_dict(),
        "vnorm": tuple(ts.vnorm), "update_count": ts.update_count, "iteration": ts.iteration,
    })


def restore(snap: dict, ts):
    """Load ``snapshot``'s state into ``ts`` (any device); returns it. The
    optimizers get copies: ``load_state_dict`` keeps tensors already on
    their device, and Adam's steps would change the snapshot in place."""
    snap = copy.deepcopy(snap)
    dev = next(ts.actor.parameters()).device
    ts.actor.load_state_dict(snap["actor"])
    ts.critic.load_state_dict(snap["critic"])
    ts.actor_opt.load_state_dict(snap["actor_opt"])
    ts.critic_opt.load_state_dict(snap["critic_opt"])
    ts.vnorm = type(ts.vnorm)(*(t.to(dev) for t in snap["vnorm"]))
    ts.update_count, ts.iteration = snap["update_count"], snap["iteration"]
    return ts


def _to_cpu(x):
    """``x`` (nested dicts, lists and tuples of tensors) with every tensor on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def run_way(algo, snap, traj, adv, ret, start):
    """The update from the saved state on this batch; returns (the
    parameter change after every epoch, the final state)."""
    ts = restore(snap, algo.init_state(0))
    dev = algo.device
    tr = Trajectory(*(None if t is None else t.to(dev) for t in traj))
    after = []
    step = algo._step

    def recorded(ts_):
        out = step(ts_)
        after.append(flat_params(ts_))
        return out

    algo._step = recorded
    try:
        algo.update(ts, tr, adv.to(dev), ret.to(dev))
    finally:
        del algo._step
    return [{k: v - start[k] for k, v in p.items()} for p in after], ts


@torch.no_grad()
def f32_eval(ev, ts_start, ts_way, traj, adv, ret, clip, delta):
    """Surrogate gain, approx-KL (k3 estimator) and value-loss reduction of
    the update start -> way, evaluated in f32 on the batch (ev: an f32
    MAPPO on the card; ``ret`` normalized with the way's final
    normalizer)."""
    ts = ev.init_state(0)
    T, E, A, _ = traj.actions.shape
    obs = traj.obs[:-1].to(ev.device, torch.float32)
    act = traj.actions.to(ev.device)
    adv_n = normalize_advantages(adv.to(ev.device))[:, :, None, :].expand(T, E, A, 1)
    cent = obs.reshape(T, E, -1)
    out = {}
    for tag, src in (("start", ts_start), ("way", ts_way)):
        ts.actor.load_state_dict(src.actor.state_dict())
        ts.critic.load_state_dict(src.critic.state_dict())
        lp, _ = D.evaluate_head(ev.head_kind, ts.actor(obs), act)
        out[tag] = (lp, ts.critic(cent))
    r = torch.exp(out["way"][0] - out["start"][0])
    surr = torch.minimum(r * adv_n, torch.clamp(r, 1 - clip, 1 + clip) * adv_n).mean()
    kl = ((r - 1) - torch.log(r)).mean()
    vnorm = type(ts_way.vnorm)(*(t.to(ev.device) for t in ts_way.vnorm))
    target = VN.normalize(vnorm, ret.to(ev.device))
    vl = {tag: float(FP.huber(target - v, delta).mean()) for tag, (_, v) in out.items()}
    return {"surrogate_gain": float(surr - adv_n.mean()), "approx_kl": float(kl),
            "value_loss_drop": vl["start"] - vl["way"]}


def probe_state(seed, it, algos, ev, ts, out_dir, save=False, save_only=False) -> None:
    """Run the four updates from ``ts`` (the arm's state before the update
    of iteration ``it``) on the iteration's own batch, record, and leave
    ``ts`` updated by way k, as training goes on. ``save``: also save the
    state and its batch; ``save_only``: only that, and then way k's update."""
    lead = algos["k"]
    traj = lead.rollout(ts, lead.cfg.n_rollout_threads)
    adv, ret = lead.compute_returns(ts, traj)
    start = flat_params(ts)
    snap = snapshot(ts)
    if save or save_only:  # the state and its batch, for a reference run elsewhere
        os.makedirs(os.path.join(out_dir, "states"), exist_ok=True)
        torch.save({"snapshot": _to_cpu(snap), "traj": _to_cpu(traj._asdict()),
                    "adv": adv.cpu(), "ret": ret.cpu()},
                   os.path.join(out_dir, "states", f"s{seed}_i{it}.pt"))
    if save_only:
        lead.update(ts, traj, adv, ret)
        return
    ts_start = restore(snap, ev.init_state(0))
    grads = first_epoch_grads(lead, ts, traj, adv, ret)
    changes, final = {}, {}
    for way in ("f", "c", "p", "k"):
        if way == "p":
            with plain_loss_on_card():
                changes[way], final[way] = run_way(algos[way], snap, traj, adv, ret, start)
        else:
            changes[way], final[way] = run_way(algos[way], snap, traj, adv, ret, start)
    # go on training from way k's result, as the arm does
    restore(snapshot(final["k"]), ts)
    cfg = lead.cfg
    rec = {"seed": seed, "iteration": it, "nets": {}, "first_epoch_grads": grads}
    for net in NETS:
        keys = [k for k in start if k.startswith(net)]
        ref = changes["f"][-1]
        n = {}
        for way in ("k", "p", "c"):
            got = changes[way][-1]
            n[f"d_{way}"] = dist(got, ref, keys)
            n[f"cos_{way}"] = cosine(got, ref, keys)
            n[f"d_{way}_epochs"] = [dist(changes[way][e], changes["f"][e], keys)
                                    for e in range(len(changes["f"]))]
            n[f"d_{way}_tensors"] = {k: dist(got, ref, [k]) for k in keys}
        n["d_k_vs_p"] = dist(changes["k"][-1], changes["p"][-1], keys)
        n["d_p_vs_c"] = dist(changes["p"][-1], changes["c"][-1], keys)
        n["norm_f"] = math.sqrt(sum(float(ref[k].double().square().sum()) for k in keys))
        rec["nets"][net] = n
    rec["f32_eval"] = {way: f32_eval(ev, ts_start, final[way], traj, adv, ret,
                                     cfg.clip_param, cfg.huber_delta)
                       for way in WAYS}
    path = os.path.join(out_dir, f"state_s{seed}_i{it}.json")
    with open(path, "w") as f:
        json.dump(rec, f)
    a, c = rec["nets"]["actor"], rec["nets"]["critic"]
    print(f"[s{seed} i{it}] actor d_k {a['d_k']:.4f} d_p {a['d_p']:.4f} d_c {a['d_c']:.4f}; "
          f"critic d_k {c['d_k']:.4f} d_p {c['d_p']:.4f} d_c {c['d_c']:.4f}; gain k "
          f"{rec['f32_eval']['k']['surrogate_gain']:.5f} p "
          f"{rec['f32_eval']['p']['surrogate_gain']:.5f}", flush=True)


def first_epoch_grads(algo, ts, traj, adv, ret) -> dict:
    """K3 / K4 against their plain versions on the card on the first
    epoch's packed rows, per output tensor: relative L2 distance and
    cosine."""
    cfg = algo.cfg
    T, E, A, _ = traj.actions.shape
    adv_n = normalize_advantages(adv)
    obs = traj.obs[:-1].to(torch.bfloat16)
    aux_a = FP.pack_actor_aux(traj.actions.reshape(T * E * A, -1),
                              traj.log_probs.reshape(T * E * A, -1),
                              adv_n[:, :, None, :].expand(T, E, A, 1).reshape(-1, 1))
    aux_c = FP.pack_critic_aux(traj.values[:-1].reshape(T * E, 1), ret.reshape(T * E, 1))
    seq = algo._norm_seq(ts, ret)[0]
    common = dict(n_layers=cfg.layer_n + 1, use_feature_norm=cfg.use_feature_normalization,
                  use_relu=cfg.use_relu, bf16=True, clip_param=cfg.clip_param)
    a, c = ts.actor, ts.critic
    calls = {
        "K3": lambda: FP.actor_ppo_grads_packed(
            obs.reshape(T * E * A, -1), aux_a, [p.detach() for p in a.base.flat_params()],
            a.act_out.weight.detach().t(), a.act_out.bias.detach(), a.log_std.detach(),
            **common),
        "K4": lambda: FP.critic_value_grads_packed(
            obs.reshape(T * E, -1), aux_c, seq[0, 2:4].contiguous(),
            [p.detach() for p in c.base.flat_params()], c.v_out.weight.detach().t(),
            c.v_out.bias.detach(), huber_delta=cfg.huber_delta, use_huber=cfg.use_huber_loss,
            use_clipped=cfg.use_clipped_value_loss, **common),
    }
    res = {}
    for name, call in calls.items():
        kern = _flatten(call())
        with plain_loss_on_card():
            plain = _flatten(call())
        rows = []
        for k, p in zip(kern, plain):
            k, p = k.double().flatten(), p.double().flatten()
            rows.append({"shape": list(p.shape),
                         "rel": float((k - p).norm() / p.norm().clamp_min(1e-30)),
                         "cos": float(k @ p / (k.norm() * p.norm()).clamp_min(1e-30))})
        res[name] = rows
    return res


def _flatten(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _flatten(v)]


def run_seed(seed: int, iters, out_dir: str, save_iter=None, save_only=False) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, env_cfg, cfg = load_config({"seed": seed, "compute_dtype": "bfloat16"})
    f32 = cfg._replace(compute_dtype="float32")
    algos = {
        "k": MAPPO(cfg, env_cfg, device="cuda"),
        "p": MAPPO(cfg, env_cfg, device="cuda"),
        "c": MAPPO(cfg._replace(fused_loss="on", fused_trunk="on"), env_cfg, device="cpu"),
        "f": MAPPO(f32, env_cfg, device="cuda"),
    }
    ev = MAPPO(f32, env_cfg, device="cuda")
    lead = algos["k"]
    ts = lead.init_state(seed)
    t0 = time.time()
    for it in range(1, max(iters) + 1):
        if it in iters:
            probe_state(seed, it, algos, ev, ts, out_dir, save=it == save_iter,
                        save_only=save_only)
        else:
            lead.train_iteration(ts)
    print(f"[s{seed}] done in {time.time() - t0:.0f}s", flush=True)


def binom_tail(k: int, n: int) -> float:
    """P(X >= k), X ~ Binomial(n, 1/2)."""
    return sum(math.comb(n, i) for i in range(k, n + 1)) / 2.0 ** n


def summary(out_dir: str) -> None:
    recs = [json.load(open(p)) for p in sorted(glob.glob(os.path.join(out_dir, "state_*.json")))]
    recs.sort(key=lambda r: (r["seed"], r["iteration"]))
    n = len(recs)
    print(f"{n} states from {out_dir}")
    hdr = ("seed", "iter", "net", "d_k", "d_p", "d_c", "cos_k", "cos_p", "k-p", "p-c")
    print(" ".join(f"{h:>8}" for h in hdr))
    for r in recs:
        for net in NETS:
            x = r["nets"][net]
            print(" ".join(f"{v:>8}" for v in (
                r["seed"], r["iteration"], net, f"{x['d_k']:.4f}", f"{x['d_p']:.4f}",
                f"{x['d_c']:.4f}", f"{x['cos_k']:.4f}", f"{x['cos_p']:.4f}",
                f"{x['d_k_vs_p']:.4f}", f"{x['d_p_vs_c']:.4f}")))
    for net in NETS:
        dk = [r["nets"][net]["d_k"] for r in recs]
        dp = [r["nets"][net]["d_p"] for r in recs]
        dc = [r["nets"][net]["d_c"] for r in recs]
        wins = sum(a > b for a, b in zip(dk, dp))
        wins_c = sum(a > b for a, b in zip(dp, dc))
        print(f"{net}: mean d_k {sum(dk) / n:.4f}, d_p {sum(dp) / n:.4f}, d_c {sum(dc) / n:.4f}; "
              f"d_k > d_p on {wins}/{n} (one-sided sign test p {binom_tail(wins, n):.4f}); "
              f"d_p > d_c on {wins_c}/{n} (p {binom_tail(wins_c, n):.4f})")
        ep = len(recs[0]["nets"][net]["d_k_epochs"])
        for way in ("k", "p"):
            per = [sum(r["nets"][net][f"d_{way}_epochs"][e] for r in recs) / n for e in range(ep)]
            print(f"  {net} mean d_{way} by epoch: " + " ".join(f"{v:.4f}" for v in per))
        keys = recs[0]["nets"][net]["d_k_tensors"].keys()
        for k in keys:
            a = [r["nets"][net]["d_k_tensors"][k] for r in recs]
            b = [r["nets"][net]["d_p_tensors"][k] for r in recs]
            w = sum(x > y for x, y in zip(a, b))
            print(f"  {k}: mean d_k {sum(a) / n:.4f} d_p {sum(b) / n:.4f}, d_k > d_p on "
                  f"{w}/{n} (p {binom_tail(w, n):.4f})")
    for field in ("surrogate_gain", "approx_kl", "value_loss_drop"):
        vals = {w: [r["f32_eval"][w][field] for r in recs] for w in WAYS}
        less = sum(a < b for a, b in zip(vals["k"], vals["p"]))
        print(f"{field}: " + ", ".join(f"{w} {sum(v) / n:.6f}" for w, v in vals.items())
              + f"; k < p on {less}/{n} (p {binom_tail(less, n):.4f})")
    for name in ("K3", "K4"):
        worst = [max(t["rel"] for t in r["first_epoch_grads"][name]) for r in recs]
        print(f"first-epoch {name} vs plain, largest tensor rel: max {max(worst):.2e}, "
              f"median {sorted(worst)[n // 2]:.2e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--iters", type=int, nargs="+", default=[1, 50, 100, 150])
    ap.add_argument("--pool", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(REPO, "results", "c4_probe"))
    ap.add_argument("--summary", metavar="DIR")
    ap.add_argument("--save-states", type=int, metavar="ITER",
                    help="also save each seed's state and batch at this iteration "
                         "(DIR/states/s{SEED}_i{ITER}.pt)")
    ap.add_argument("--save-only", action="store_true",
                    help="save the state and batch at each of --iters, run no comparison")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.summary:
        summary(args.summary)
        return 0
    os.makedirs(args.out, exist_ok=True)
    if args.child:
        run_seed(args.seeds[0], set(args.iters), args.out, args.save_states, args.save_only)
        return 0
    from dcc_tpu_torch.ops import cuda_build

    print(f"kernels built in {cuda_build.build()['_seconds']:.1f}s", flush=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    extra = (["--save-states", str(args.save_states)] if args.save_states else []) + (
        ["--save-only"] if args.save_only else [])
    todo, running, failed = list(args.seeds), [], []
    while todo or running:
        while todo and len(running) < args.pool:
            s = todo.pop(0)
            cmd = [sys.executable, os.path.abspath(__file__), "--child", "--seeds", str(s),
                   "--iters", *map(str, args.iters), "--out", args.out, *extra]
            running.append((s, subprocess.Popen(cmd, env=env)))
        time.sleep(1.0)
        for job in list(running):
            if job[1].poll() is not None:
                running.remove(job)
                if job[1].returncode:
                    failed.append(job[0])
    if not args.save_only:
        summary(args.out)
    if failed:
        print(f"seeds that failed: {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
