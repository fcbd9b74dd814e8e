"""The rank programs of tests/test_torch_mesh.py and
tests/test_torch_distributed.py, and their launcher.

    python tests/torch_mesh_ranks.py JOB OUT_DIR

runs JOB ("mesh" or "control") as one rank of a process group when
torchrun's variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) are set,
else as the one-process reference, and writes what it measured to
``OUT_DIR/JOB_<rank or "ref">.pt`` for the tests to hold. :func:`launch`
starts the ranks (and the reference) of one job. Nothing here asserts: a
rank exits non-zero only on an error, which :func:`launch` retries once (an
infrastructure failure, such as a CPU-starved peer), and the tests hold the
results.
"""

import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the MAPPO cases of the mesh job: 16 envs split over 2 ranks, 2 iterations
SMALL = dict(n_rollout_threads=16, episode_length=10, ppo_epoch=3, n_iters=4, hidden_size=32)
MAPPO_CASES = {
    "f32": {},
    "nmb2": dict(num_mini_batch=2),
    "chunks4": dict(update_chunks=4),
    "popart": dict(use_popart=True, use_valuenorm=False),
    "bf16-fused": dict(compute_dtype="bfloat16", fused_loss="on", fused_trunk="on"),
    "separated": dict(share_policy=False),
    "separated-nmb2": dict(share_policy=False, num_mini_batch=2),
    "recurrent": dict(use_recurrent_policy=True, data_chunk_length=5),
    "recurrent-nmb2": dict(use_recurrent_policy=True, data_chunk_length=5, num_mini_batch=2),
    # JAX accepts an env count that does not divide on its autograd paths
    "uneven-15": dict(n_rollout_threads=15),
    # what ``auto`` resolves to on the card, where forcing a kernel raises
    # as JAX's does: every kernel on (K1, K2, K3 / K4; K2b when recurrent),
    # here through their plain twins
    "kernels-nmb2": dict(compute_dtype="bfloat16", num_mini_batch=2, kernels=True),
    "kernels-uneven-15": dict(compute_dtype="bfloat16", n_rollout_threads=15, kernels=True),
    "kernels-recurrent": dict(compute_dtype="bfloat16", use_recurrent_policy=True,
                              data_chunk_length=5, kernels=True),
    # minibatches of 2 of the 640 rows: a rank often holds none of one, and
    # its K3 / K4 then add zero sums. In f32: over 640 steps of 2 rows the
    # bf16 weight copies part by a bf16 step from about step 150 on, and
    # the runs drift apart past any update bound
    "kernels-nmb320": dict(num_mini_batch=320, ppo_epoch=1, kernels=True),
}
MADDPG_CASE = dict(n_envs=16, steps_per_iter=20, updates_per_iter=3, batch_size=32,
                   warmup_steps=0, buffer_capacity=2048)
JAX_CASE = dict(SMALL, fused_loss="on")  # the port's side of the slice against JAX
# the dispatch rules under 2 ranks: (MAPPOConfig fields, where it raises)
RULES = {
    "fused-loss-nmb2": dict(fused_loss="on", num_mini_batch=2),
    "fused-loss-15": dict(fused_loss="on", n_rollout_threads=15),
    "fused-trunk-15": dict(fused_trunk="on", n_rollout_threads=15),
    "gae-kernel-15": dict(gae_backend="pallas", n_rollout_threads=15),
}


def launch(job: str, out_dir: str, world: int = 2, reference: bool = False,
           timeout: float = 300.0, attempts: int = 2) -> None:
    """Run ``job``'s ``world`` ranks (and, with ``reference``, its
    one-process reference beside them) to their end; one more attempt when
    a process fails or times out. Raises with every process's output when
    the last attempt fails."""
    from dcc_tpu_torch.parallel.distributed import free_port

    last = ""
    for _ in range(attempts):
        port = free_port()
        procs = []
        for rank in [*range(world), *(["ref"] if reference else [])]:
            env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
            for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
                env.pop(k, None)
            if rank != "ref":
                env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                           WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job, out_dir], env=env, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out = p.communicate()[0] + f"\n(timed out after {timeout} s)"
            outs.append(out)
        if all(p.returncode == 0 for p in procs):
            return
        last = "\n".join(f"--- process {i} (rc {p.returncode}) ---\n{out[-4000:]}"
                         for i, (p, out) in enumerate(zip(procs, outs)))
    raise RuntimeError(f"the {world}-rank {job} job failed after {attempts} attempts:\n{last}")


# ---------------------------------------------------------------------------
# the mesh job
# ---------------------------------------------------------------------------

def _state(ts) -> dict:
    """Parameters, normalizers and Adam moments of a MAPPO state, by name."""
    out = {}
    for i, p in enumerate(ts.policies()):
        for net in ("actor", "critic"):
            out.update({f"{i}.{net}.{k}": v.detach().clone()
                        for k, v in getattr(p, net).state_dict().items()})
        for name, opt in (("actor_opt", p.actor_opt), ("critic_opt", p.critic_opt)):
            for j, st in opt.state_dict()["state"].items():
                out.update({f"{i}.{name}.{j}.{k}": v.clone() for k, v in st.items()
                            if k != "step"})
        for name, st in (("vnorm", p.vnorm), ("popart", p.popart)):
            out.update({f"{i}.{name}.{j}": v.clone() for j, v in enumerate(st or ())})
    return out


def _mappo_case(mesh, kw) -> dict:
    from dcc_tpu_torch.algos import MAPPO, MAPPOConfig
    from dcc_tpu_torch.envs import EnvConfig

    kw = {**SMALL, **kw}
    kernels = kw.pop("kernels", False)
    algo = MAPPO(MAPPOConfig(**kw), EnvConfig(), device="cpu", mesh=mesh)
    if kernels:  # the flags ``auto`` sets on CUDA
        algo.gae_kernel = algo.fused_trunk = True
        algo.fused_loss = not algo.recurrent
    ts = algo.init_state(0)
    # a rollout from the fresh state, on a generator of its own
    traj = algo.rollout(ts, algo.cfg.n_rollout_threads,
                        generator=torch.Generator().manual_seed(5))
    grads1, step = {}, algo._step

    def first_grads(ts_):  # the gradients the first optimizer step takes
        for i, p in enumerate(ts_.policies()):
            for net in ("actor", "critic"):
                grads1.update({f"{i}.{net}.{k}": q.grad.clone() for k, q in
                               getattr(p, net).named_parameters() if f"{i}.{net}.{k}"
                               not in grads1})
        return step(ts_)

    algo._step = first_grads
    metrics = [list(algo.train_iteration(ts)) for _ in range(2)]
    return dict(metrics=metrics, state=_state(ts), update_count=ts.update_count, grads1=grads1,
                rollout={f: getattr(traj, f).float() for f in
                         ("obs", "actions", "log_probs", "values", "rewards", "masks")},
                fused=(algo.fused_trunk, algo.fused_loss))


def _maddpg_case(mesh) -> dict:
    from dcc_tpu_torch.algos.maddpg import MADDPG, MADDPGConfig
    from dcc_tpu_torch.envs import EnvConfig

    algo = MADDPG(MADDPGConfig(**MADDPG_CASE), EnvConfig(), device="cpu", mesh=mesh)
    st = algo.init_state(0)
    metrics = [algo.train_iteration(st) for _ in range(2)]
    n = 2 * MADDPG_CASE["n_envs"] * MADDPG_CASE["steps_per_iter"]
    return dict(metrics=metrics, buffer={k: getattr(st.buffer, k)[:n].clone()
                                         for k in ("obs", "actions", "rewards", "next_obs",
                                                   "dones")},
                state={k: v.clone() for net in ("actor", "critic", "target_actor",
                                                  "target_critic")
                       for k, v in ((f"{net}.{n}", t) for n, t in
                                    getattr(st, net).state_dict().items())},
                farm_rows=st.obs.shape[0])


def _jax_case(mesh, out_dir, timeout: float = 240.0) -> dict:
    """The port's fused update (the kernels' plain twins) from the JAX
    package's parameters and trajectory, each rank on its envs; the test
    writes them to ``jax_in.pt`` while the other cases run."""
    from dcc_tpu_torch.algos import MAPPO, MAPPOConfig, Trajectory
    from dcc_tpu_torch.envs import EnvConfig

    path = os.path.join(out_dir, "jax_in.pt")
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.2)
    blob = torch.load(path, weights_only=True)
    algo = MAPPO(MAPPOConfig(**JAX_CASE), EnvConfig(), device="cpu", mesh=mesh)
    actor, critic = algo.make_networks()
    actor.load_state_dict(blob["actor"])
    critic.load_state_dict(blob["critic"])
    ts = algo.init_state(actor=actor, critic=critic)
    rows = slice(None) if mesh is None else mesh.rows(SMALL["n_rollout_threads"])
    traj = Trajectory(*(None if blob["traj"].get(f) is None else blob["traj"][f][:, rows]
                        for f in Trajectory._fields))
    adv, ret = algo.compute_returns(ts, traj)
    m = algo.update(ts, traj, adv, ret)
    return dict(metrics=m, actor=actor.state_dict(), critic=critic.state_dict(),
                vnorm=list(ts.vnorm), local_envs=traj.actions.shape[1])


def _rules(mesh) -> dict:
    """Where each rule of ``RULES`` raises under ``mesh``: (type, message),
    or None where it does not."""
    from dcc_tpu_torch.algos import MAPPO, MAPPOConfig
    from dcc_tpu_torch.algos.maddpg import MADDPG, MADDPGConfig
    from dcc_tpu_torch.envs import EnvConfig

    out = {}
    for name, kw in RULES.items():
        try:
            algo = MAPPO(MAPPOConfig(**{**SMALL, "episode_length": 4, **kw}), EnvConfig(),
                         device="cpu", mesh=mesh)
            ts = algo.init_state(0)
            algo.compute_returns(ts, algo.rollout(ts, algo.cfg.n_rollout_threads))
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = (type(e).__name__, str(e))
    try:
        MADDPG(MADDPGConfig(**{**MADDPG_CASE, "n_envs": 15}), EnvConfig(), device="cpu",
               mesh=mesh)
        out["maddpg-15"] = None
    except ValueError as e:
        out["maddpg-15"] = (type(e).__name__, str(e))
    return out


def mesh_job(mesh, out_dir) -> dict:
    out = {f"mappo/{name}": _mappo_case(mesh, kw) for name, kw in MAPPO_CASES.items()}
    out["maddpg"] = _maddpg_case(mesh)
    if mesh is not None:
        out["rules"] = _rules(mesh)
    out["jax"] = _jax_case(mesh, out_dir)
    return out


# ---------------------------------------------------------------------------
# the control job
# ---------------------------------------------------------------------------

def _learner_resume(out_dir: str, overrides: dict, algo_yaml=None) -> dict:
    """Train 3 iterations through ``Learner(use_mesh=True)`` with a
    checkpoint each, then a fresh Learner loads ``models_2`` and trains one
    iteration: its state against the first's. The run dir is relative to
    this rank's own working directory, so that a rank that is not the
    coordinator shows whether it wrote anything."""
    from dcc_tpu_torch.parallel import distributed
    from dcc_tpu_torch.runtime import Learner

    base = dict(n_iters=3, max_ep_len=8, n_rollout_threads=16, n_eval_rollout_threads=16,
                eval_interval=2, save_interval=1, save_gifs=False, algo_hidden_size=32,
                main_save_path="results", save_name="mesh", **overrides)
    l1 = Learner(base, use_mesh=True, device="cpu", algo_yaml=algo_yaml)
    l1.train()
    path = distributed.broadcast_str(
        os.path.abspath(os.path.join(l1.output_path, "models_2.pt"))
        if distributed.is_coordinator() else None)
    l2 = Learner({**base, "load_model": True, "load_model_path": path}, use_mesh=True,
                 device="cpu", algo_yaml=algo_yaml)
    loaded = l2.ts.iteration
    m2 = l2.algo.train_iteration(l2.ts)
    st1, st2 = _any_state(l1.ts), _any_state(l2.ts)
    return dict(mesh_size=l1.mesh.size, loaded_iteration=loaded, output_path=l1.output_path,
                resumed_output_path=l2.output_path,
                resume_equal={k: bool(torch.equal(st1[k], st2[k])) for k in st1},
                metrics=dict(l1.last_metrics._asdict() if hasattr(l1.last_metrics, "_asdict")
                             else l1.last_metrics), resumed_metrics=dict(
                    m2._asdict() if hasattr(m2, "_asdict") else m2),
                state=st1)


def _any_state(ts) -> dict:
    if hasattr(ts, "buffer"):  # MADDPG
        return {**{f"{net}.{k}": v.clone() for net in ("actor", "critic", "target_actor",
                                                       "target_critic")
                   for k, v in getattr(ts, net).state_dict().items()},
                "obs": ts.obs.clone(), "ou_state": ts.ou_state.clone(),
                "buffer.obs": ts.buffer.obs.clone()}
    return _state(ts)


def control_job(out_dir: str) -> dict:
    from dcc_tpu_torch.parallel import distributed, make_mesh

    rank = distributed.process_index()
    out = dict(count=distributed.process_count(), index=rank,
               coordinator=distributed.is_coordinator())
    out["bcast1"] = distributed.broadcast_str("0614_1200_sd7" if rank == 0 else None)
    distributed.barrier("save_model")
    distributed.barrier("save_model")
    out["bcast2"] = distributed.broadcast_str("second" if rank == 0 else None)
    mesh = make_mesh("cpu")
    out["rows16"], out["rows15"] = ((r.start, r.stop) for r in (mesh.rows(16), mesh.rows(15)))
    out["all_sum"] = mesh.all_sum(torch.tensor([1.0 + rank, 10.0]))
    out["all_gather"] = mesh.all_gather(torch.arange(mesh.rows(15).start, mesh.rows(15).stop,
                                                     dtype=torch.int32), 15)
    b = torch.full((3,), float(rank))
    mesh.broadcast_([b])
    out["broadcast"] = b
    out["cwd"] = cwd = os.path.join(out_dir, f"cwd{rank}_{os.getpid()}")
    os.makedirs(cwd)
    os.chdir(cwd)
    out["learner"] = _learner_resume(out_dir, {})
    out["learner_maddpg"] = _learner_resume(
        out_dir, dict(updates_per_iter=3, batch_size=32, warmup_steps=0,
                      buffer_capacity=2048),
        algo_yaml=os.path.join(ROOT, "dcc_tpu_torch", "configs", "algo_config", "maddpg.yaml"))
    out["written"] = sorted(os.path.relpath(os.path.join(d, f), cwd)
                            for d, _, fs in os.walk(cwd) for f in fs)
    return out


def main(job: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    from dcc_tpu_torch.parallel import distributed, make_mesh

    if "WORLD_SIZE" not in os.environ:
        torch.save(mesh_job(None, out_dir), os.path.join(out_dir, f"{job}_ref.pt"))
        return
    distributed.initialize(backend="gloo")
    rank = distributed.process_index()
    out = mesh_job(make_mesh("cpu"), out_dir) if job == "mesh" else control_job(out_dir)
    torch.save(out, os.path.join(out_dir, f"{job}_{rank}.pt"))
    # neither rank leaves (taking down the store rank 0 hosts) while the
    # other may still use it
    distributed.barrier("exit")
    distributed.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:3])
