#!/usr/bin/env python
"""Smoke test: the classify path runs on the GPU, end to end, byte-exact.

    python chip_smoke.py           # one card, phases 0-4
    python chip_smoke.py --multi   # four cards: the multi-device path only

One line per phase; the first failure raises, so the script exits non-zero
and prints no result. Phases on one card:

  0 device   jax must report a GPU; prints its kind and count, the card's
             name and power limit (nvidia-smi), and the compile cache used.
  1 native   the C++ host engine, built from source on this host.
  2 entry    __graft_entry__.entry() compiled for the card, its memory
             analysis, and its verdicts checked against the host oracle.
  3 main     the CLI (shark_tpu.cli.main) at the reference's defaults (k=17,
             c=0.6, -b 1: a 2^33-bit Bloom filter) on bench.py's seeded
             500-gene panel: 500k single-end reads under --probe auto, xl
             and classic; 250k pairs; the -q 10 sample; and the tie-heavy
             homolog panel (bench/homolog_bench.py). Every run's ssv and
             FASTQs must equal `--backend native`'s byte for byte, and 2,000
             seeded reads per workload must equal classify/oracle.py.
  4 trace    a few steady batches of the single-end run under the profiler,
             reduced by bench/trace_report.py to the top device ops.

--multi runs only `--devices 4` and `--sharded-bf --devices 4` on the
single-end and paired samples (each compared with `--backend native`) and
dryrun_multichip(4) on the GPUs.

Times printed beside the runs are information, labelled with the card; they
are not benchmark results. The last line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "bench", ".cache", "smoke")
BATCH = 65536  # bench.py's batch geometry
ORACLE_READS = 2000
SEED = 2026


def say(msg: str) -> None:
    print(msg, flush=True)


def card_label() -> str:
    """`nvidia-smi --query-gpu=name,power.limit`, one line per card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


# ---------------------------------------------------------------- helpers


def run_cli(argv, stats_path: str) -> dict:
    """One in-process CLI run; returns its --stats-json object."""
    from shark_tpu.cli import main

    rc = main(list(argv) + ["--stats-json", stats_path])
    if rc != 0:
        raise RuntimeError(f"shark_tpu.cli.main exited {rc}: {argv}")
    with open(stats_path) as f:
        return json.load(f)


def assert_same_bytes(got: dict, want: dict) -> None:
    """Byte equality of each output file (ssv, out1, out2) of two runs."""
    for key, want_path in want.items():
        with open(got[key], "rb") as f:
            a = f.read()
        with open(want_path, "rb") as f:
            b = f.read()
        if a != b:
            at = next(
                (i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)),
            )
            raise AssertionError(
                f"{got[key]} differs from {want_path} at byte {at} "
                f"({len(a)} vs {len(b)} bytes)"
            )


class Workload:
    """One sample against one panel, with its output paths per run."""

    def __init__(self, name, fasta, fq1, fq2="", minq=0, index_dir=""):
        self.name = name
        self.fasta = fasta
        self.fq1 = fq1
        self.fq2 = fq2
        self.minq = minq
        self.index_dir = index_dir

    def outputs(self, tag: str) -> dict:
        base = os.path.join(WORK, f"{self.name}.{tag}")
        out = {"ssv": base + ".ssv", "out1": base + ".1.fq"}
        if self.fq2:
            out["out2"] = base + ".2.fq"
        return out

    def argv(self, tag: str, extra=()) -> list:
        out = self.outputs(tag)
        argv = ["-r", self.fasta, "-1", self.fq1, "-o", out["out1"],
                "--ssv", out["ssv"], "-q", str(self.minq),
                "--batch-size", str(BATCH)]
        if self.fq2:
            argv += ["-2", self.fq2, "-p", out["out2"]]
        if os.path.isdir(self.index_dir):
            argv += ["--load-index", self.index_dir]
        else:
            # the first run builds the index once and saves it for the rest
            argv += ["--save-index", self.index_dir]
        return argv + list(extra)


def run_native(w: Workload) -> dict:
    """The independent C++ host classifier's outputs for `w`."""
    stats = run_cli(
        w.argv("native", ["--backend", "native", "-t",
                          str(os.cpu_count() or 1)]),
        os.path.join(WORK, f"{w.name}.native.json"),
    )
    if stats["probe"] != "host":
        raise AssertionError(f"native run took the {stats['probe']} path")
    return w.outputs("native")


def run_device(w: Workload, tag: str, extra, want: dict, count: int) -> dict:
    """A device run of `w` whose outputs must equal `want` byte for byte;
    returns its stats."""
    stats = run_cli(
        w.argv(tag, ["-t", "8", *extra]),
        os.path.join(WORK, f"{w.name}.{tag}.json"),
    )
    dev = stats["device"]
    if dev["platform"] != "gpu" or dev["count"] != count:
        raise AssertionError(f"{w.name}/{tag} ran on {dev}")
    assert_same_bytes(w.outputs(tag), want)
    return stats


def oracle_sample(w: Workload, ssv_path: str, n: int, seed: int,
                  k: int = 17, c: float = 0.6, size_bits: int = 1 << 33) -> int:
    """Check the associations of n seeded reads of `w` in `ssv_path`
    against the pure-host oracle; returns the number of reads checked."""
    import numpy as np

    from shark_tpu.classify.oracle import (
        build_oracle_index,
        classify_read,
        fuse_pair,
    )
    from shark_tpu.io.fastx import read_fasta, read_fastq_pairs

    oracle = build_oracle_index(read_fasta(w.fasta), k, size_bits)
    got = {}
    with open(ssv_path) as f:
        for line in f:
            rid, gene = line.split()
            got.setdefault(rid, []).append(gene)
    pairs = list(read_fastq_pairs(w.fq1, w.fq2 or None))
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(pairs), size=min(n, len(pairs)), replace=False)
    for i in picks.tolist():
        r1, r2 = pairs[i]
        wins, _, _ = classify_read(oracle, fuse_pair(r1, r2, w.minq), c, False)
        want = [oracle.gene_names[g] for g in wins]
        if got.get(r1[0], []) != want:
            raise AssertionError(
                f"{w.name}: read {r1[0]} -> {got.get(r1[0], [])}, "
                f"oracle says {want}"
            )
    return len(picks)


def info(stats: dict, card: str) -> str:
    rate = stats["n_reads"] / max(stats["classify_s"], 1e-9)
    return (f"reads={stats['n_reads']} warmup_s={stats['warmup_s']:.3f} "
            f"classify_s={stats['classify_s']:.3f} reads/s={rate:.0f} "
            f"[information only; {card}]")


# ----------------------------------------------------------------- phases


def phase_device(n_cards: int):
    import jax

    from shark_tpu.config import DEFAULT_COMPILE_CACHE
    from shark_tpu.pipeline import use_compile_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU: jax runs on {devs[0].platform}"
        )
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: {n_cards} GPUs needed, "
                         f"jax sees {len(devs)}")
    card = card_label()
    cache = use_compile_cache(DEFAULT_COMPILE_CACHE)
    say(f"phase 0 device: ok kind={devs[0].device_kind} count={len(devs)}")
    say(card)
    say(f"compile cache: {cache}")
    return devs[0], card.splitlines()[0]


def phase_native() -> None:
    from shark_tpu.io import native

    t0 = time.perf_counter()
    so = native.library_path()
    if so is None or not native.available():
        raise RuntimeError("native engine did not build")
    key = native.build_key(native._SRC, native._CMD)
    if not (os.path.dirname(so) == native.BUILD_DIR and key in so):
        raise AssertionError(f"native library {so} is not keyed {key}")
    say(f"phase 1 native: ok {so} ({time.perf_counter() - t0:.1f} s)")


def phase_entry() -> None:
    import jax
    import numpy as np

    import __graft_entry__ as graft
    from shark_tpu.classify.oracle import build_oracle_index, classify_read
    from shark_tpu.config import SharkConfig
    from shark_tpu.pipeline import _winner_pairs

    fn, args = graft.entry()
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    result = compiled(*args)
    jax.block_until_ready(result)
    index, records = graft._tiny_index()
    codes = args[2]
    ri, gi = _winner_pairs(
        SharkConfig(), index, result, codes.shape[0], codes, max_winners=4
    )
    oracle = build_oracle_index(records, index.k, index.size_bits)
    want_r, want_g = [], []
    for i in range(codes.shape[0]):
        wins, _, _ = classify_read(oracle, codes[i], 0.6, False)
        want_r += [i] * len(wins)
        want_g += wins
    if not (np.array_equal(ri, want_r) and np.array_equal(gi, want_g)):
        raise AssertionError("entry() verdicts differ from the oracle")
    say(f"phase 2 entry: ok compile_s={compile_s:.2f} "
        f"associations={len(want_r)} memory_analysis: "
        f"{compiled.memory_analysis()}")


def panel_workloads():
    import bench

    homolog = bench.load_sub_bench("homolog_bench.py")
    fasta, fastq, fastq_q, fq_p1, fq_p2 = bench.gen_workload()
    idx = os.path.join(bench.CACHE, "index.d")
    h_fasta, h_fastq = homolog.gen_workload()
    h_idx = os.path.join(homolog.CACHE, "index.d")
    return {
        "single": Workload("single", fasta, fastq, index_dir=idx),
        "paired": Workload("paired", fasta, fq_p1, fq_p2, index_dir=idx),
        "q10": Workload("q10", fasta, fastq_q, minq=10, index_dir=idx),
        "homolog": Workload("homolog", h_fasta, h_fastq, index_dir=h_idx),
    }


def phase_main(wls: dict, card: str) -> None:
    runs = [
        ("single", "auto", "hashed"),
        ("single", "xl", "xl"),
        ("single", "classic", "classic"),
        ("paired", "auto", None),
        ("q10", "auto", None),
        ("homolog", "auto", None),
    ]
    native_out = {}
    for name, probe, expect in runs:
        w = wls[name]
        if name not in native_out:
            native_out[name] = run_native(w)
            n = oracle_sample(w, native_out[name]["ssv"], ORACLE_READS, SEED)
            say(f"  {name}: --backend native matches the oracle on {n} "
                "reads")
        stats = run_device(w, probe, ["--probe", probe], native_out[name], 1)
        if expect is not None and stats["probe"] != expect:
            raise AssertionError(
                f"{name} --probe {probe} ran {stats['probe']}, "
                f"expected {expect}"
            )
        say(f"  {name} --probe {probe} ({stats['probe']}): byte-equal to "
            f"--backend native; {info(stats, card)}")
    say("phase 3 main: ok")


def phase_trace(w: Workload, n_batches: int = 4) -> None:
    import bench

    trace_report = bench.load_sub_bench("trace_report.py")
    sub = os.path.join(WORK, "trace_reads.fq")
    with open(w.fq1, "rb") as src, open(sub, "wb") as dst:
        for _ in range(4 * BATCH * n_batches):
            dst.write(src.readline())
    tw = Workload("trace", w.fasta, sub, index_dir=w.index_dir)
    trace_dir = os.path.join(WORK, "trace")
    run_cli(tw.argv("hashed", ["--probe", "hashed", "--profile-dir",
                               trace_dir]),
            os.path.join(WORK, "trace.json"))
    path = trace_report.newest_xplane(trace_dir)
    totals = trace_report.op_totals(path, "/device:")
    if not totals:
        raise AssertionError(f"no device events in {path}")
    say(f"phase 4 trace: ok {path}")
    say(trace_report.report(totals, top=8))


def phase_multi(wls: dict, card: str) -> None:
    import __graft_entry__ as graft

    for name in ("single", "paired"):
        w = wls[name]
        want = run_native(w)
        for tag, extra in (
            ("dp4", ["--devices", "4"]),
            ("sharded4", ["--sharded-bf", "--devices", "4"]),
        ):
            stats = run_device(w, tag, extra, want, 4)
            say(f"  {name} {' '.join(extra)}: byte-equal to --backend "
                f"native; {info(stats, card)}")
    report = graft.dryrun_multichip(4)
    if report["platform"] != "gpu" or report["skipped"]:
        raise AssertionError(f"dryrun_multichip(4): {report}")
    say(f"  dryrun_multichip(4): {report}")
    say("phase multi: ok")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the four-card path and its comparison")
    args = p.parse_args(argv)
    n_cards = 4 if args.multi else 1
    dev, card = phase_device(n_cards)
    os.makedirs(WORK, exist_ok=True)
    phase_native()
    if args.multi:
        phase_multi(panel_workloads(), card)
    else:
        phase_entry()
        wls = panel_workloads()
        phase_main(wls, card)
        phase_trace(wls["single"])
    say(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": n_cards,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
