"""Multi-host deployment helpers.

The reference is single-process shared-memory only (SURVEY.md §2); scaling
beyond one host is new design:

- **Runtime**: `jax.distributed` (one process per host, all hosts join one
  runtime). The replicated-index classifier then runs unchanged — the index
  is replicated into every local device's memory and each host feeds its
  own devices, with zero collectives on the probe path. The sharded-BF
  classifier's all_to_all rides NCCL (NVLink within a host).
- **Input sharding**: by FILE. RNA-Seq samples arrive as (pairs of) FASTQ
  files; each host streams its assigned files through its local chips and
  writes one output part PER FILE PAIR, named by the pair's GLOBAL index
  (`out.ssv.part3`, ...). Concatenating parts in global index order then
  reproduces exactly the output a single host would produce processing the
  files in order — regardless of how pairs were assigned to hosts.

Typical launch (per host), via `run_files`:

    initialize(coordinator, n_hosts, host_id)
    run_files(cfg, all_pairs, host_id, n_hosts)   # writes this host's parts
    # after all hosts finish (shared filesystem / artifact copy):
    merge_parts(cfg.ssv_path, len(all_pairs))     # on the merging host

For the single-file-pair-per-host case the CLI's `--host-id` suffixing
(shark_tpu/cli.py) is equivalent: part index == host index.
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Sequence, Tuple

FilePair = Tuple[str, str]


def host_suffixed(path: str, part: int | str) -> str:
    """Insert a per-host/per-part suffix BEFORE a trailing '.gz' so the
    gzip-by-extension detection in both output engines still fires
    ('x.fq.gz' -> 'x.fq.0.gz', 'x.fq' -> 'x.fq.0')."""
    if path.endswith(".gz"):
        return f"{path[:-3]}.{part}.gz"
    return f"{path}.{part}"


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Join the multi-host jax runtime (idempotent per process)."""
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def assign_files(
    pairs: Sequence[FilePair], num_hosts: int
) -> List[List[Tuple[int, FilePair]]]:
    """Deterministic round-robin assignment of (global index, file pair) to
    hosts.

    Round-robin (not contiguous blocks) so heterogeneous file sizes spread
    evenly; assignment depends only on (pairs order, num_hosts), so every
    host computes the same global view without communication. The global
    index travels with the pair because merge order is INDEX order, not
    host order (host order would interleave f0,f3,... before f1)."""
    out: List[List[Tuple[int, FilePair]]] = [[] for _ in range(num_hosts)]
    for i, p in enumerate(pairs):
        out[i % num_hosts].append((i, p))
    return out


def run_files(cfg, pairs: Sequence[FilePair], host_id: int, num_hosts: int):
    """Run the pipeline over this host's assigned file pairs, one output
    part per pair named by its global index. Returns the list of
    (global index, stats) produced."""
    from shark_tpu.pipeline import run_pipeline

    cfg.finalize_outputs()
    results = []
    for gi, (fq1, fq2) in assign_files(pairs, num_hosts)[host_id]:
        part_cfg = replace(
            cfg,
            sample1_path=fq1,
            sample2_path=fq2 or "",
            ssv_path=host_suffixed(cfg.ssv_path, f"part{gi}")
            if cfg.ssv_path
            else "",
            out1_path=host_suffixed(cfg.out1_path, f"part{gi}"),
            out2_path=host_suffixed(cfg.out2_path, f"part{gi}")
            if cfg.out2_path
            else "",
        )
        results.append((gi, run_pipeline(part_cfg)))
    return results


def merge_parts(dest: str, n_parts: int, remove: bool = False) -> None:
    """Concatenate per-file-pair output parts in GLOBAL INDEX order,
    reproducing the deterministic single-host output. Run on one host
    after every part exists (shared filesystem, or copy parts first)."""
    merge_outputs(
        [host_suffixed(dest, f"part{i}") for i in range(n_parts)],
        dest,
        remove=remove,
    )


def merge_outputs(
    part_paths: Sequence[str], dest: str, remove: bool = False
) -> None:
    """Concatenate output parts in the given order."""
    import os

    with open(dest, "wb") as out:
        for p in part_paths:
            with open(p, "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    out.write(chunk)
    if remove:
        for p in part_paths:
            os.remove(p)
