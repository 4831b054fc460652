"""Run configuration.

Mirrors the reference CLI surface and defaults (reference:
argument_parser.hpp:49-63, 84-174): -r/-1 required; -2 enables paired mode;
k in [1, 31]; c in [0, 1]; bf size given in "GB" units where 1 unit equals
2**33 bits of Bloom bit-vector (argument_parser.hpp:130-133).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

# One "-b" unit = 2**33 bits (1 GiB of bit-vector), reference
# argument_parser.hpp:133.
BF_UNIT_BITS = 1 << 33

# jax platform names --backend accepts, plus "native" (pure-CPU C++
# classify, no jax); "" keeps jax's own default platform choice.
BACKENDS = ("gpu", "cuda", "cpu", "native")
# "gpu" pins CUDA: jax's own "gpu" alias also demands ROCm and fails where
# only the CUDA plugin is installed.
JAX_PLATFORM = {"gpu": "cuda"}

# Persistent XLA compile cache default: a fixed path inside the checkout.
# The directory is part of the cache key, so it must not move between runs.
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compile_cache_dir(requested: str) -> Optional[str]:
    """The compile-cache directory the program should set, or None to set
    nothing: when JAX_COMPILATION_CACHE_DIR is set, jax already reads it and
    it wins over every other choice; otherwise `requested` ('' disables)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.expanduser(requested) or None


@dataclass
class SharkConfig:
    fasta_path: str = ""
    sample1_path: str = ""
    sample2_path: str = ""
    out1_path: str = ""
    out2_path: str = ""
    k: int = 17
    c: float = 0.6
    bf_gb: int = 1  # Bloom filter size in units of 2**33 bits
    min_quality: int = 0
    single: bool = False
    verbose: bool = False
    threads: int = 1  # accepted for CLI parity; host I/O worker count

    # Device-execution knobs (no reference analogue).
    # Reads per device batch; not yet measured on the GPU (ROADMAP Speed 6).
    batch_size: int = 8192
    # 0 = auto: the native path pre-scans the sample (parse-only pass) for
    # the exact max fused length; the Python path pads per batch.
    max_read_len: int = 0
    max_winners: int = 16  # per-read winner-compaction width on device
    backend: str = ""  # "" = default jax platform; else one of BACKENDS
    devices: int = 1  # data-parallel device count (1 = single device)
    sharded_bf: bool = False  # shard the Bloom filter across the mesh
    save_index: str = ""  # optional path to serialize the built index
    load_index: str = ""  # optional path to load a prebuilt index
    ssv_path: str = ""  # write ssv here instead of stdout (native path)
    use_native: bool = True  # use the C++ host I/O engine when available
    profile_dir: str = ""  # write a jax.profiler trace here
    # Probe-path selection for the replicated-index classifiers: "auto"
    # picks the hashed one-gather table when buildable (the GB-scale "xl"
    # variant past the 64 MB bucket-table budget), falling back to the
    # classic two-gather layout; "hashed"/"xl"/"classic" force one
    # (classic is unconditionally correct at any scale — the escape hatch
    # if a hashed table misbehaves on a real panel). The sharded-BF mode
    # has its own routed layout and ignores this.
    probe: str = "auto"
    # Batches per device->host verdict fetch. On the previous accelerator
    # grouping stalled dispatch more than it saved in fixed fetch cost, so
    # the default is 1; not yet measured on the GPU (ROADMAP Speed 6).
    fetch_group: int = 1
    # Checkpoint/resume (native path; no reference analogue): writes a
    # <ssv>.progress sidecar per drained batch and restarts an interrupted
    # run from the last checkpoint, byte-identically.
    resume: bool = False
    fail_after_batches: int = 0  # test hook: inject a crash mid-sample
    # Persistent XLA compilation cache directory ("" disables; ignored when
    # JAX_COMPILATION_CACHE_DIR is set, see compile_cache_dir). jax keys
    # the cache on the HLO and compile options, so a repeat run of the same
    # batch geometry skips its compile. Output bytes are unaffected.
    compile_cache: str = DEFAULT_COMPILE_CACHE

    @property
    def paired(self) -> bool:
        return bool(self.sample2_path)

    @property
    def bf_bits(self) -> int:
        return self.bf_gb * BF_UNIT_BITS

    def validate(self) -> None:
        if not (1 <= self.k <= 31):
            raise ValueError("k must be in the range [1, 31]")
        if not (0.0 <= self.c <= 1.0):
            raise ValueError("c must be in the range [0, 1]")
        if self.min_quality < 0:
            raise ValueError("q must be a positive value")
        if self.threads <= 0:
            raise ValueError("at least 1 thread is required")
        if self.bf_gb < 1:
            raise ValueError("bf size must be >= 1 GB unit")
        if self.backend and self.backend not in BACKENDS:
            raise ValueError(
                "backend must be one of: " + ", ".join(BACKENDS)
            )
        if self.probe not in ("auto", "hashed", "xl", "classic"):
            raise ValueError(
                "probe must be one of: auto, hashed, xl, classic"
            )
        if not (1 <= self.fetch_group <= 6):
            # the native prefetch ring (kRing = 20) must cover
            # group * (lookahead_depth + 2) pinned batches; shk_next also
            # guards against wrap at runtime, but fail fast here
            raise ValueError("fetch_group must be in [1, 6]")

    def finalize_outputs(self) -> None:
        """Apply the reference's output-path defaults
        (argument_parser.hpp:168-173)."""
        if self.out1_path == "":
            self.out1_path = "sharked_sample.1"
        if self.out2_path == "" and self.sample2_path != "":
            self.out2_path = "sharked_sample.2"
