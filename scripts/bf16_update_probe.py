"""How far one bf16 iteration's update on the card lies from the same update
through the kernels' plain versions, at the default config's full shape
(16 envs, T = 150, hidden 256, 15 epochs).

    python scripts/bf16_update_probe.py [--seeds 0 1 2] [--iters 1]

For each seed, the seed's networks (trained ``--iters - 1`` bf16 iterations
on the card first, so that later states of training are probed too) take
one sampled rollout on the card; then the update runs from identical
parameters on that trajectory five ways: the card's bf16 path (K1 and the
fused loss K3 / K4), the same bf16 path with K3 / K4 replaced by their plain
versions on the card, the bf16 plain path on the CPU, and f32 autograd on
the card and on the CPU. It prints the relative L2 distance of each
parameter change from the CPU's bf16 one and from the CPU's f32 one, per
network, and the epochs' mean metrics. Where the kernels' update lies no
farther from the plain bf16 one than bf16 rounding itself moves the update
(CPU bf16 against CPU f32), the kernels add no error of their own. Then,
on the first epoch's inputs, the gradients of K3 and K4 against their
plain versions on the card, on every row (relu kinks included): each
tensor's ||kernel - plain|| / ||plain|| and cosine.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from dcc_tpu_torch.algos import MAPPO, Trajectory  # noqa: E402
from dcc_tpu_torch.configs.loader import load as load_config  # noqa: E402
from dcc_tpu_torch.ops import fused_ppo as FP  # noqa: E402

WAYS = ("card-bf16", "card-bf16-plain-loss", "cpu-bf16", "card-f32", "cpu-f32")


def plain_on_card():
    """Swap the fused-loss wrappers for their plain versions (a context of
    the ``card-bf16-plain-loss`` update); returns the restore function."""
    saved = (FP.actor_ppo_grads_packed, FP.critic_value_grads_packed)

    def actor(obs, aux, params, w, b, log_std, **kw):
        return saved[0](obs.cpu(), aux.cpu(), [p.cpu() for p in params], w.cpu(), b.cpu(),
                        log_std.cpu(), **kw)

    def critic(cent, aux, norm, params, w, b, **kw):
        return saved[1](cent.cpu(), aux.cpu(), norm.cpu(), [p.cpu() for p in params],
                        w.cpu(), b.cpu(), **kw)

    def to_card(fn):
        return lambda *a, **k: _to(fn(*a, **k), "cuda")

    FP.actor_ppo_grads_packed, FP.critic_value_grads_packed = to_card(actor), to_card(critic)

    def restore():
        FP.actor_ppo_grads_packed, FP.critic_value_grads_packed = saved

    return restore


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return type(x)(_to(v, device) for v in x)


def flat_params(ts):
    return {f"{n}.{k}": v.detach().float().cpu()
            for n, net in (("actor", ts.actor), ("critic", ts.critic))
            for k, v in net.state_dict().items()}


def rel(change, ref):
    """||change - ref|| / ||ref|| over the keys of one network prefix."""
    num = sum(float((change[k] - ref[k]).square().sum()) for k in ref)
    den = sum(float(ref[k].square().sum()) for k in ref)
    return (num / den) ** 0.5


def probe(seed: int, iters: int) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    _, env_cfg, cfg = load_config({"seed": seed})
    bf16 = cfg._replace(compute_dtype="bfloat16")
    algos = {
        "card-bf16": MAPPO(bf16, env_cfg, device="cuda"),
        "card-bf16-plain-loss": MAPPO(bf16, env_cfg, device="cuda"),
        "cpu-bf16": MAPPO(bf16._replace(fused_loss="on", fused_trunk="on"), env_cfg,
                          device="cpu"),
        "card-f32": MAPPO(cfg, env_cfg, device="cuda"),
        "cpu-f32": MAPPO(cfg, env_cfg, device="cpu"),
    }
    lead = algos["card-bf16"]
    ts0 = lead.init_state(seed)
    for _ in range(iters - 1):
        lead.train_iteration(ts0)
    traj = lead.rollout(ts0, cfg.n_rollout_threads)
    start = flat_params(ts0)
    changes, metrics = {}, {}
    for way, algo in algos.items():
        ts = algo.init_state(seed)
        ts.actor.load_state_dict(ts0.actor.state_dict())
        ts.critic.load_state_dict(ts0.critic.state_dict())
        ts.vnorm = type(ts0.vnorm)(*(t.to(algo.device) for t in ts0.vnorm))
        ts.update_count = ts0.update_count
        tr = Trajectory(*(None if t is None else t.to(algo.device) for t in traj))
        restore = plain_on_card() if way == "card-bf16-plain-loss" else (lambda: None)
        try:
            adv, ret = algo.compute_returns(ts, tr)
            metrics[way] = algo.update(ts, tr, adv, ret).cpu()
        finally:
            restore()
        changes[way] = {k: v - start[k] for k, v in flat_params(ts).items()}
    print(f"seed {seed}, update of iteration {iters}:", flush=True)
    for net in ("actor", "critic"):
        for ref in ("cpu-bf16", "cpu-f32"):
            r = {k: v for k, v in changes[ref].items() if k.startswith(net)}
            row = ", ".join(f"{w} {rel({k: changes[w][k] for k in r}, r):.4f}"
                            for w in WAYS if w != ref)
            print(f"  {net} change vs {ref}: {row}", flush=True)
    for way in WAYS:
        print(f"  metrics {way}: {[round(x, 6) for x in metrics[way].tolist()]}", flush=True)
    first_epoch_grads(lead, ts0, traj)


def first_epoch_grads(algo, ts, traj) -> None:
    """K3 / K4 against their plain versions on the card on the first
    epoch's packed rows, per output tensor."""
    cfg = algo.cfg
    T, E, A, _ = traj.actions.shape
    adv, ret = algo.compute_returns(ts, traj)
    from dcc_tpu_torch.algos.mappo import normalize_advantages

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
    saved = (FP.actor_grads_cuda, FP.critic_grads_cuda)
    for name, call in calls.items():
        kern = _flatten(call())
        FP.actor_grads_cuda, FP.critic_grads_cuda = FP.actor_grads_plain, FP.critic_grads_plain
        try:
            plain = _flatten(call())
        finally:
            FP.actor_grads_cuda, FP.critic_grads_cuda = saved
        rows = []
        for i, (k, p) in enumerate(zip(kern, plain)):
            k, p = k.double().flatten(), p.double().flatten()
            rel_err = float((k - p).norm() / p.norm().clamp_min(1e-30))
            cos = float(k @ p / (k.norm() * p.norm()).clamp_min(1e-30))
            rows.append(f"{i}:{tuple(p.shape)} rel {rel_err:.2e} cos {cos:.6f}")
        print(f"  {name} vs plain, all rows: " + "; ".join(rows), flush=True)


def _flatten(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _flatten(v)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--iters", type=int, default=1,
                    help="probe the update of this iteration (the earlier ones train on the card)")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        probe(seed, args.iters)


if __name__ == "__main__":
    main()
