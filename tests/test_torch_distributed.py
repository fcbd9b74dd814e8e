"""The port's launch layer and control plane (``dcc_tpu_torch.parallel``)
and the Learner with ``use_mesh``, on 2 gloo ranks on the CPU, held as the
JAX package's tests/test_multiprocess.py and
tests/test_fused_mesh.py:154-201 hold its own:

* process identity, the coordinator, ``broadcast_str`` (twice) and
  ``barrier`` (one name, twice) on the group's store; the mesh's rows, sum,
  gather and broadcast;
* one process: identity and no-op defaults, and a mesh of one rank;
* ``Learner(use_mesh=True)`` over 2 ranks, MAPPO and MADDPG: 3 iterations
  with an eval and a checkpoint each, only the coordinator writing the run
  dir, both ranks on one broadcast run dir; a fresh Learner loads
  ``models_2`` on both ranks and its next iteration lands bit for bit on
  the first Learner's third, the ranks' replicated state bit for bit.

One job of 2 ranks runs every case (``tests/torch_mesh_ranks.py``, job
"control"), from a module fixture; each rank runs in a working directory of
its own, so that what a rank wrote there is what it wrote at all."""

import os

import pytest
import torch

import torch_mesh_ranks as R
from dcc_tpu_torch.parallel import distributed, make_mesh


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("control_job"))
    R.launch("control", out, 2)
    return [torch.load(os.path.join(out, f"control_{r}.pt"), weights_only=True)
            for r in (0, 1)]


@pytest.mark.parametrize("rank", [0, 1])
def test_process_identity(ranks, rank):
    r = ranks[rank]
    assert (r["count"], r["index"], r["coordinator"]) == (2, rank, rank == 0)


@pytest.mark.parametrize("rank", [0, 1])
def test_broadcast_str_and_barriers(ranks, rank):
    # the coordinator's strings on both ranks, across two barriers of one name
    assert (ranks[rank]["bcast1"], ranks[rank]["bcast2"]) == ("0614_1200_sd7", "second")


def test_mesh_collectives(ranks):
    r0, r1 = ranks
    assert (r0["rows16"], r1["rows16"]) == ((0, 8), (8, 16))
    assert (r0["rows15"], r1["rows15"]) == ((0, 8), (8, 15))  # the first rank one more
    for r in ranks:
        assert torch.equal(r["all_sum"], torch.tensor([3.0, 20.0]))
        assert torch.equal(r["all_gather"], torch.arange(15, dtype=torch.int32))
        assert torch.equal(r["broadcast"], torch.zeros(3))  # the coordinator's


def test_single_process_defaults():
    assert not torch.distributed.is_initialized()
    distributed.initialize()  # no address, no WORLD_SIZE: joins nothing
    assert not torch.distributed.is_initialized()
    assert (distributed.process_count(), distributed.process_index()) == (1, 0)
    assert distributed.is_coordinator() and distributed.local_rank() == 0
    assert distributed.broadcast_str("x") == "x" and distributed.broadcast_str(None) == ""
    distributed.barrier()
    assert distributed.local_first(lambda: 7) == 7
    mesh = make_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.rows(15)) == (1, 0, slice(0, 15))
    t = torch.arange(3.0)
    assert torch.equal(mesh.all_sum(t), t) and torch.equal(mesh.all_gather(t, 3), t)


@pytest.mark.parametrize("algo", ["learner", "learner_maddpg"])
def test_learner_mesh_trains_and_resumes_exactly(ranks, algo):
    r0, r1 = ranks[0][algo], ranks[1][algo]
    assert r0["mesh_size"] == r1["mesh_size"] == 2
    # both ranks on the coordinator's run dir, the resumed Learner's too
    assert r0["output_path"] == r1["output_path"]
    assert r0["resumed_output_path"] == r1["resumed_output_path"]
    assert r0["loaded_iteration"] == r1["loaded_iteration"] == 2
    # models_2 + one iteration == the third iteration, bit for bit
    for r in (r0, r1):
        assert all(r["resume_equal"].values()), [k for k, v in r["resume_equal"].items()
                                                 if not v]
        assert r["resumed_metrics"] == r["metrics"]
    # the replicated state (MADDPG's env farm is each rank's own rows)
    for k in r0["state"]:
        if k not in ("obs", "ou_state"):
            assert torch.equal(r0["state"][k], r1["state"][k]), k
    assert r0["metrics"] == r1["metrics"]


@pytest.mark.parametrize("algo", ["learner", "learner_maddpg"])
def test_only_the_coordinator_writes(ranks, algo):
    run = ranks[0][algo]["output_path"]  # relative to each rank's directory
    assert {os.path.join(run, f) for f in ("config.json", "models_1.pt", "models_2.pt",
                                           "models_3.pt")} <= set(ranks[0]["written"])
    assert all(f.startswith(os.path.join("results", "mesh")) for f in ranks[0]["written"])
    assert ranks[1]["written"] == []
