"""The port's learning gate: its committed learning curves on the card
against the reference's and the JAX package's coverage bands.

Reads files only. The port's curves are ``learning_curves_torch/``
(``scripts/run_torch_curve.py``: 200 iterations x 150 steps x 16 envs of the
default config on one NVIDIA card, f32 seeds 0-25 and bf16 seeds 0-23, the
JAX package's own seed counts); the bands are ``reference_seed*`` (the
original implementation, 10 seeds), ``dcc_tpu_seed*`` (26) and
``dcc_tpu_bf16_seed*`` (24) in ``benchmarks/learning_curves/``. Each gate is
``tests/test_curve_parity.py``'s, on the final-20-iteration coverage of runs
of at least 200 iterations: both arms learn (every seed above 0.5); the f32
arm is not stochastically below either band (one-sided Mann-Whitney p >
0.05) and its mean lies less than 0.05 below the band's; the bf16 arm is not
stochastically below either band (p > 0.05). A missing file fails: a gate
that skipped would guard nothing.

MADDPG's arms (``dcc_tpu_torch_maddpg[_tuned]_seed*``: 200 iterations x 150
steps x 16 envs with ``algo_config/maddpg.yaml``, 12 seeds, and
``maddpg_tuned.yaml``, 10 seeds) are held to the JAX package's own MADDPG
thresholds (``tests/test_curve_parity.py:143-173``: default median above
0.3 and all seeds but one above 0.25; tuned minimum above 0.6 and mean
above 0.75) and are not stochastically below the JAX package's bands
``dcc_tpu_maddpg[_tuned]_seed*`` (one-sided Mann-Whitney p > 0.05).

The connectivity-force arms (``dcc_tpu_torch_connect[_comp|_envf64]_seed*``:
200 iterations x 150 steps x 16 envs with ``comm_force_scale`` 5.0 and
``comm_r_scale`` 0.95, as ``scripts/run_dcc_curve.py``'s ``connect``
variant; 16 seeds, 16 with the compensated df64 pull force and 6 with the
float64 env, the JAX bands' counts) are held as
``tests/test_curve_parity.py::test_connect_distribution`` holds the JAX
package's connect arm: not stochastically below the band (one-sided
Mann-Whitney p > 0.05) with a mean gap above -0.05; the plain arm against
``reference_connect`` (16 seeds) and ``dcc_tpu_connect`` (32), the
compensated arm against ``dcc_tpu_connect_comp`` (16), and the f64 arm
against ``dcc_tpu_connect_envf64`` (6; p only).

Regenerate (on the card; ``--pool`` runs the seeds as concurrent processes):

    python scripts/run_torch_curve.py --pool 7 $(seq 0 25)
    DCC_CURVE_DTYPE=bfloat16 python scripts/run_torch_curve.py --pool 7 $(seq 0 23)
    DCC_CURVE_ALGO_YAML=dcc_tpu_torch/configs/algo_config/maddpg.yaml \
        python scripts/run_torch_curve.py --pool 7 $(seq 0 11)
    DCC_CURVE_ALGO_YAML=dcc_tpu_torch/configs/algo_config/maddpg_tuned.yaml \
        python scripts/run_torch_curve.py --pool 7 $(seq 0 9)
    DCC_CURVE_CONFIG=connect python scripts/run_torch_curve.py --pool 8 $(seq 0 15)
    DCC_CURVE_CONFIG=connect DCC_CURVE_COMPENSATED=1 \
        python scripts/run_torch_curve.py --pool 8 $(seq 0 15)
    DCC_CURVE_CONFIG=connect DCC_CURVE_ENV_DTYPE=float64 \
        python scripts/run_torch_curve.py --pool 6 $(seq 0 5)
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from scipy.stats import mannwhitneyu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "learning_curves_torch")
BAND_DIR = os.path.join(ROOT, "benchmarks", "learning_curves")
ARMS = {"f32": ("dcc_tpu_torch", 26), "bf16": ("dcc_tpu_torch_bf16", 24)}
# MADDPG's arms: (the port's stem, its seed count, the JAX package's band)
MADDPG_ARMS = {"maddpg": ("dcc_tpu_torch_maddpg", 12, "dcc_tpu_maddpg"),
               "maddpg_tuned": ("dcc_tpu_torch_maddpg_tuned", 10, "dcc_tpu_maddpg_tuned")}
# the connectivity-force arms: (the port's stem, its seed count, the
# env fields its files record)
CONNECT = dict(comm_force_scale=5.0, comm_r_scale=0.95)
CONNECT_ARMS = {
    "connect": ("dcc_tpu_torch_connect", 16,
                dict(CONNECT, compensated_forces=False, env_dtype="float32")),
    "connect_comp": ("dcc_tpu_torch_connect_comp", 16,
                     dict(CONNECT, compensated_forces=True, env_dtype="float32")),
    "connect_envf64": ("dcc_tpu_torch_connect_envf64", 6,
                       dict(CONNECT, compensated_forces=False, env_dtype="float64")),
}
ALL_ARMS = {**ARMS, **MADDPG_ARMS, **CONNECT_ARMS}
LAST, MIN_ITERS = 20, 200


def _runs(directory, system):
    return [json.load(open(p))
            for p in sorted(glob.glob(os.path.join(directory, f"{system}_seed*.json")))]


def _final_coverages(directory, system):
    out = {}
    for d in _runs(directory, system):
        cov = np.asarray(d["series"]["coverage_rate"], dtype=float)
        if len(cov) >= MIN_ITERS:  # partial runs are not counted
            out[d["seed"]] = float(cov[-LAST:].mean())
    return out


def _arm(arm):
    return np.array(list(_final_coverages(PORT_DIR, ALL_ARMS[arm][0]).values()))


@pytest.mark.parametrize("arm", sorted(ARMS) + sorted(MADDPG_ARMS) + sorted(CONNECT_ARMS))
def test_artifacts_are_full_runs_on_a_card(arm):
    system, n_seeds = ALL_ARMS[arm][:2]
    runs = _runs(PORT_DIR, system)
    assert sorted(d["seed"] for d in runs) == list(range(n_seeds))
    for d in runs:
        assert len(d["series"]["coverage_rate"]) >= MIN_ITERS, d["seed"]
        assert "NVIDIA" in d["system"], d["system"]
        if arm in CONNECT_ARMS:  # the files are the arm's runs
            assert {k: d[k] for k in CONNECT_ARMS[arm][2]} == CONNECT_ARMS[arm][2], d["seed"]


def test_both_arms_learn():
    """Both arms end far above the untrained ~0.2-0.3 coverage floor."""
    for arm in ARMS:
        assert _arm(arm).min() > 0.5, (arm, sorted(np.round(_arm(arm), 3)))


@pytest.mark.parametrize(
    "arm,band,max_gap",
    [("f32", "reference", -0.05), ("f32", "dcc_tpu", -0.05),
     ("bf16", "reference", None), ("bf16", "dcc_tpu_bf16", None)],
)
def test_final_coverage_not_below_band(arm, band, max_gap):
    """One-sided Mann-Whitney U: the port's final-coverage seeds must not be
    stochastically below the band's at alpha 0.05; in f32 the mean gap must
    also stay above -0.05 (tests/test_curve_parity.py:76-127)."""
    a = _arm(arm)
    b = np.array(list(_final_coverages(BAND_DIR, band).values()))
    assert len(b) >= 10, band
    p = float(mannwhitneyu(a, b, alternative="less").pvalue)
    assert p > 0.05, (f"{arm} arm stochastically below {band} (one-sided MWU p={p:.4f}; "
                      f"port={sorted(np.round(a, 3))}, band={sorted(np.round(b, 3))})")
    if max_gap is not None:
        assert a.mean() - b.mean() > max_gap, (a.mean(), b.mean())


@pytest.mark.parametrize(
    "arm,band,n_band,max_gap",
    [("connect", "reference_connect", 16, -0.05), ("connect", "dcc_tpu_connect", 32, -0.05),
     ("connect_comp", "dcc_tpu_connect_comp", 16, -0.05),
     ("connect_envf64", "dcc_tpu_connect_envf64", 6, None)],
)
def test_connect_arm_not_below_band(arm, band, n_band, max_gap):
    """One-sided Mann-Whitney U: the connectivity-force arm's seeds are not
    stochastically below the band's at alpha 0.05; where a mean gap is
    given, the arm's mean lies above the band's plus it
    (tests/test_curve_parity.py:211-225)."""
    a = _arm(arm)
    b = np.array(list(_final_coverages(BAND_DIR, band).values()))
    assert len(a) == CONNECT_ARMS[arm][1] and len(b) == n_band, (len(a), len(b))
    p = float(mannwhitneyu(a, b, alternative="less").pvalue)
    assert p > 0.05, (f"{arm} arm stochastically below {band} (one-sided MWU p={p:.4f}; "
                      f"port={sorted(np.round(a, 3))}, band={sorted(np.round(b, 3))})")
    if max_gap is not None:
        assert a.mean() - b.mean() > max_gap, (a.mean(), b.mean())


def test_maddpg_band():
    """The JAX package's MADDPG self-band thresholds at the reference-key
    config (``tests/test_curve_parity.py:143-159``): median above 0.3, all
    seeds but one above 0.25."""
    vals = _arm("maddpg")
    assert np.median(vals) > 0.3, sorted(np.round(vals, 3))
    assert (vals > 0.25).sum() >= len(vals) - 1, sorted(np.round(vals, 3))


def test_maddpg_tuned_band():
    """The tuned config's thresholds (``tests/test_curve_parity.py:162-173``):
    every seed above 0.6, the mean above 0.75."""
    vals = _arm("maddpg_tuned")
    assert vals.min() > 0.6, sorted(np.round(vals, 3))
    assert vals.mean() > 0.75, sorted(np.round(vals, 3))


@pytest.mark.parametrize("arm", sorted(MADDPG_ARMS))
def test_maddpg_not_below_jax_band(arm):
    """One-sided Mann-Whitney U: the port's MADDPG seeds are not
    stochastically below the JAX package's band of the same YAML at alpha
    0.05."""
    a = _arm(arm)
    b = np.array(list(_final_coverages(BAND_DIR, MADDPG_ARMS[arm][2]).values()))
    assert len(b) == MADDPG_ARMS[arm][1], arm
    p = float(mannwhitneyu(a, b, alternative="less").pvalue)
    assert p > 0.05, (f"{arm} stochastically below the JAX band (one-sided MWU p={p:.4f}; "
                      f"port={sorted(np.round(a, 3))}, band={sorted(np.round(b, 3))})")


def test_curve_runner_writes_the_schema(tmp_path):
    """The runner on the CPU for two iterations: the file's name, its
    schema (``run_dcc_curve.py``'s ``_dump``, plus ``concurrent``) and one
    entry per iteration in every series."""
    # one thread: the run is small, and the suite's other workers hold the cores
    env = dict(os.environ, DCC_CURVE_DEVICE="cpu", DCC_CURVE_ITERS="2", OMP_NUM_THREADS="1")
    env.pop("DCC_CURVE_DTYPE", None)
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "run_torch_curve.py"),
                    "5", str(tmp_path)], env=env, check=True, capture_output=True)
    assert os.listdir(tmp_path) == ["dcc_tpu_torch_seed5.json"]
    d = json.load(open(tmp_path / "dcc_tpu_torch_seed5.json"))
    assert {"system", "concurrent", "seed", "n_iters", "n_rollout_threads", "max_ep_len",
            "elapsed_s", "series"} <= set(d)
    assert (d["seed"], d["n_iters"], d["n_rollout_threads"], d["max_ep_len"],
            d["concurrent"]) == (5, 2, 16, 150, 1)
    assert d["system"].startswith("dcc_tpu_torch (torch ")
    assert set(d["series"]) == {"reward", "coverage_rate", "value_loss", "policy_loss",
                                "dist_entropy", "ratio", "iter_time_s"}
    for k, v in d["series"].items():
        assert len(v) == 2 and np.isfinite(v).all(), k


def test_curve_runner_writes_the_maddpg_schema(tmp_path):
    """The runner with ``DCC_CURVE_ALGO_YAML`` naming MADDPG's YAML, on the
    CPU for two iterations: the arm's file name and MADDPG's series."""
    env = dict(os.environ, DCC_CURVE_DEVICE="cpu", DCC_CURVE_ITERS="2", OMP_NUM_THREADS="1",
               DCC_CURVE_ALGO_YAML=os.path.join(ROOT, "dcc_tpu_torch", "configs",
                                                "algo_config", "maddpg.yaml"))
    env.pop("DCC_CURVE_DTYPE", None)
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "run_torch_curve.py"),
                    "4", str(tmp_path)], env=env, check=True, capture_output=True)
    assert os.listdir(tmp_path) == ["dcc_tpu_torch_maddpg_seed4.json"]
    d = json.load(open(tmp_path / "dcc_tpu_torch_maddpg_seed4.json"))
    assert (d["seed"], d["n_iters"], d["n_rollout_threads"], d["max_ep_len"],
            d["algo_yaml"]) == (4, 2, 16, 150, "maddpg.yaml")
    assert set(d["series"]) == {"reward", "coverage_rate", "qf_loss", "policy_loss",
                                "iter_time_s"}
    for k, v in d["series"].items():
        assert len(v) == 2 and np.isfinite(v).all(), k
    assert d["series"]["qf_loss"][1] > 0.0  # 2,400 rows an iteration, past the batch of 256


@pytest.mark.parametrize(
    "knobs,stem,fields",
    [(dict(DCC_CURVE_CONFIG="connect"), "dcc_tpu_torch_connect", CONNECT_ARMS["connect"][2]),
     (dict(DCC_CURVE_CONFIG="connect", DCC_CURVE_COMPENSATED="1"), "dcc_tpu_torch_connect_comp",
      CONNECT_ARMS["connect_comp"][2]),
     (dict(DCC_CURVE_CONFIG="connect", DCC_CURVE_ENV_DTYPE="float64"),
      "dcc_tpu_torch_connect_envf64", CONNECT_ARMS["connect_envf64"][2])],
    ids=["connect", "comp", "envf64"],
)
def test_curve_runner_env_knobs(tmp_path, monkeypatch, knobs, stem, fields):
    """The runner's env knobs (``run_dcc_curve.py:68-102``) on the CPU for two
    iterations, in this process: each arm's file name, the env fields it
    records, and finite series."""
    import importlib.util

    for k in ("DCC_CURVE_DTYPE", "DCC_CURVE_ALGO_YAML", "DCC_CURVE_COMPENSATED",
              "DCC_CURVE_ENV_DTYPE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in dict(knobs, DCC_CURVE_DEVICE="cpu", DCC_CURVE_ITERS="2").items():
        monkeypatch.setenv(k, v)
    spec = importlib.util.spec_from_file_location(
        "run_torch_curve", os.path.join(ROOT, "scripts", "run_torch_curve.py"))
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    runner.run_seed(3, str(tmp_path))
    assert os.listdir(tmp_path) == [f"{stem}_seed3.json"]
    d = json.load(open(tmp_path / f"{stem}_seed3.json"))
    assert {k: d[k] for k in fields} == fields
    assert (d["seed"], d["n_iters"], d["n_rollout_threads"]) == (3, 2, 16)
    for k, v in d["series"].items():
        assert len(v) == 2 and np.isfinite(v).all(), k
