"""chip_smoke.py: refuses to run without a GPU, and its comparison helpers
(byte equality with `--backend native`, the oracle sample, the entry()
check) hold on a tiny seeded workload on the CPU.

The GPU test at the end runs only where a card is present; the full proof
on the card is `python chip_smoke.py` itself."""

import os
import shutil
import subprocess
import sys

import pytest

from shark_tpu.io import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_exits_nonzero_without_gpu():
    proc = _run_smoke(ROOT, {"JAX_PLATFORMS": "cpu"})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_exits_nonzero_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path), {"JAX_PLATFORMS": "cpu"})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.fixture
def smoke(tmp_path, monkeypatch):
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path / "work"))
    monkeypatch.setattr(chip_smoke, "BATCH", 128)
    os.makedirs(chip_smoke.WORK)
    return chip_smoke


def _tiny_panel(smoke, tmp_path):
    import bench

    fasta, fastq, fastq_q, p1, p2 = bench.gen_workload(
        str(tmp_path / "data"), n_reads=400, n_pairs=200
    )
    idx = str(tmp_path / "data" / "index.d")
    return {
        "single": smoke.Workload("single", fasta, fastq, index_dir=idx),
        "paired": smoke.Workload("paired", fasta, p1, p2, index_dir=idx),
        "q10": smoke.Workload("q10", fasta, fastq_q, minq=10, index_dir=idx),
    }


def test_helpers_on_tiny_workload(smoke, tmp_path):
    """A device-path CLI run (here on the CPU) and the C++ host classifier
    agree byte for byte, the oracle sample agrees with both, and a changed
    byte is caught."""
    if not native.available():
        pytest.skip("native engine unavailable")
    wls = _tiny_panel(smoke, tmp_path)
    for name, w in wls.items():
        want = smoke.run_native(w)
        assert os.path.isdir(w.index_dir)  # built once, then loaded
        stats = smoke.run_cli(
            w.argv("dev", ["-t", "2"]), str(tmp_path / f"{name}.json")
        )
        assert stats["device"]["platform"] == "cpu"
        assert stats["n_reads"] == (200 if w.fq2 else 400)
        smoke.assert_same_bytes(w.outputs("dev"), want)
        assert set(want) == ({"ssv", "out1", "out2"} if w.fq2
                             else {"ssv", "out1"})
        assert smoke.oracle_sample(w, want["ssv"], 150, seed=7) == 150

    w = wls["single"]
    ssv = w.outputs("dev")["ssv"]
    with open(ssv, "r+b") as f:
        head = f.read(1)
        f.seek(0)
        f.write(b"x" if head != b"x" else b"y")
    with pytest.raises(AssertionError, match="at byte 0"):
        smoke.assert_same_bytes(w.outputs("dev"), w.outputs("native"))
    with pytest.raises(AssertionError, match="oracle says"):
        smoke.oracle_sample(w, ssv, 400, seed=7)


def test_entry_phase_matches_oracle(smoke, capsys):
    smoke.phase_entry()
    out = capsys.readouterr().out
    assert out.startswith("phase 2 entry: ok")
    assert "memory_analysis" in out


def test_dryrun_reports_skips():
    """dryrun_multichip says what it skipped instead of printing a note:
    the sharded part needs a power-of-two device count."""
    from __graft_entry__ import dryrun_multichip

    full = dryrun_multichip(4)
    assert full == {"platform": "cpu", "count": 4, "skipped": {}}
    part = dryrun_multichip(6)
    assert list(part["skipped"]) == ["sharded_bf"]
    assert "power-of-two" in part["skipped"]["sharded_bf"]


@pytest.fixture(scope="session")
def gpu_present():
    """Whether jax finds a GPU, asked of a child process: this test session
    itself is pinned to the CPU (conftest.py)."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    if probe.stdout.strip() != "gpu":
        pytest.skip("no GPU: run `python chip_smoke.py` on the card")


@pytest.mark.gpu
def test_graft_entry_on_gpu(gpu_present):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run(
        [sys.executable, "__graft_entry__.py"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "entry: ok on gpu" in proc.stdout
    assert "'platform': 'gpu'" in proc.stdout
