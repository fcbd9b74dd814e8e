"""The kernel build (``dcc_tpu_torch.ops.cuda_build.build``) from threads
at once, on the CPU: a stand-in for ``nvcc`` that writes its output after a
pause and logs each source it compiles."""

import os
import sys
import threading
import time

import pytest

from dcc_tpu_torch.ops import cuda_build as cb

FAKE_NVCC = """import os, sys, time
args = sys.argv[1:]
out, src = args[args.index("-o") + 1], args[-1]
name = os.path.basename(src)[:-3]
with open(os.path.join(os.path.dirname(src), "log"), "a") as f:
    f.write(name + "\\n")
time.sleep(float(os.environ.get("FAKE_NVCC_S", "0.3")))
if name.startswith("bad"):
    sys.exit(3)
open(out, "w").write(name)
"""


@pytest.fixture
def fake(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b", "c", "bad"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n{FAKE_NVCC}")
    nvcc.chmod(0o755)
    monkeypatch.setattr(cb, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cb, "CSRC", str(csrc))
    monkeypatch.setattr(cb, "BUILD_ROOT", str(tmp_path / "build"))
    # the log the stand-in appends to is not a source of the hash
    monkeypatch.setattr(cb, "_source_hash", lambda: "h")
    return csrc


def compiled(csrc) -> list:
    path = csrc / "log"
    return sorted(path.read_text().split()) if path.exists() else []


def test_threads_compile_each_source_once(fake):
    """A background build of every source and a call for one of them
    meanwhile: the second waits for the first's compile of its source and
    compiles nothing itself; a later call compiles nothing."""
    out = {}
    bg = threading.Thread(target=lambda: out.update(cb.build(names=("a", "b", "c"))))
    bg.start()
    time.sleep(0.1)
    one = cb.build(names=("b",))
    assert os.path.exists(one["b"]) and open(one["b"]).read() == "b"
    bg.join()
    assert set(out) >= {"a", "b", "c", "_seconds"}
    assert compiled(fake) == ["a", "b", "c"]
    again = cb.build(names=("a", "b", "c"))
    assert again["a"] == out["a"] and compiled(fake) == ["a", "b", "c"]


def test_a_failed_source_fails_every_caller(fake):
    """A source that fails to compile fails the call that compiled it and
    the call that waited for it; the others are built."""
    errs = []

    def run(names):
        try:
            cb.build(names=names)
        except RuntimeError as e:
            errs.append(str(e))

    threads = [threading.Thread(target=run, args=(("a", "bad"),)),
               threading.Thread(target=run, args=(("bad",),))]
    threads[0].start()
    time.sleep(0.1)
    threads[1].start()
    for t in threads:
        t.join()
    assert len(errs) == 2 and all("bad.cu" in e for e in errs)
    assert compiled(fake) == ["a", "bad"]
    assert cb._BUILDING == {} and cb._PROCS == set()


def test_stop_builds_kills_what_is_in_flight(fake, monkeypatch):
    """``stop_builds`` kills the nvcc processes of a build in flight, whose
    call then fails."""
    monkeypatch.setenv("FAKE_NVCC_S", "30")
    errs = []

    def run():
        try:
            cb.build(names=("c",))
        except RuntimeError as e:
            errs.append(str(e))

    t0 = time.perf_counter()
    bg = threading.Thread(target=run)
    bg.start()
    while not cb._PROCS and time.perf_counter() - t0 < 10:
        time.sleep(0.05)
    cb.stop_builds()
    bg.join()
    assert time.perf_counter() - t0 < 20
    assert errs and "c.cu" in errs[0]
    assert cb._BUILDING == {} and cb._PROCS == set()
