"""Command-line interface.

Flag surface and defaults match the reference (argument_parser.hpp:29-174):
-r/-1 required; -2 enables paired mode; -o/-p default to sharked_sample.1/.2;
-k default 17 (max 31); -c default 0.6; -b Bloom size in GB units of 2**33
bits; -q minimum base quality; -s single-association mode; -t threads; -v
verbose. Associations go to stdout as "read_id gene_id" lines.

Device-execution extras: --batch-size, --max-read-len, --backend,
--devices, --sharded-bf, --save-index/--load-index, --ssv, --resume,
--stats-json, --profile-dir, --compile-cache, and the multi-host launch
flags.
"""

from __future__ import annotations

import argparse
import sys

from shark_tpu.config import BACKENDS, DEFAULT_COMPILE_CACHE, SharkConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="shark-tpu",
        description=(
            "Mapping-free gene separation of RNA-Seq reads on a GPU: indexes "
            "reference gene sequences as a k-mer Bloom filter and reports, "
            "for each sample read, the gene(s) it most plausibly comes from."
        ),
    )
    p.add_argument("-r", "--reference", required=True,
                   help="reference sequences in FASTA format (can be gzipped)")
    p.add_argument("-1", "--sample1", required=True,
                   help="sample in FASTQ (can be gzipped)")
    p.add_argument("-2", "--sample2", default="",
                   help="second sample in FASTQ (optional, can be gzipped)")
    p.add_argument("-o", "--out1", default="",
                   help="first output sample in FASTQ (default: sharked_sample.1)")
    p.add_argument("-p", "--out2", default="",
                   help="second output sample in FASTQ (default: sharked_sample.2)")
    p.add_argument("-k", "--kmer-size", type=int, default=17,
                   help="size of the kmers to index (default:17, max:31)")
    p.add_argument("-c", "--confidence", type=float, default=0.6,
                   help="confidence for associating a read to a gene (default:0.6)")
    p.add_argument("-b", "--bf-size", type=int, default=1,
                   help="bloom filter size in GB (default:1)")
    p.add_argument("-q", "--min-base-quality", type=int, default=0,
                   help="minimum base quality (Phred+33; default:0 = no filtering)")
    p.add_argument("-s", "--single", action="store_true",
                   help="report an association only if a single gene is found")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="host worker threads (reference flag): N-1 extra "
                        "native encode threads; device parallelism is "
                        "--devices (default:1)")
    p.add_argument("-v", "--verbose", action="store_true", help="verbose mode")
    # device-execution extras (no reference analogue)
    p.add_argument("--batch-size", type=int, default=8192,
                   help="reads per device batch (default: 8192)")
    p.add_argument("--max-read-len", type=int, default=0,
                   help="fixed padded (fused) read length; 0 = auto (a "
                        "parse-only pre-scan picks the native engine's "
                        "geometry; set explicitly to skip the scan)")
    p.add_argument("--backend", default="", choices=("",) + BACKENDS,
                   help="jax platform override (gpu, cuda, cpu), or "
                        "'native' for the pure-CPU C++ classify path "
                        "(no accelerator, no jax); default: jax's own "
                        "choice")
    p.add_argument("--devices", type=int, default=1,
                   help="data-parallel device count (default: 1)")
    p.add_argument("--sharded-bf", action="store_true",
                   help="shard the Bloom filter across the device mesh "
                        "(for indexes larger than one device's memory)")
    p.add_argument("--save-index", default="",
                   help="serialize the built index to this .npz path")
    p.add_argument("--load-index", default="",
                   help="load a prebuilt index instead of building from FASTA")
    p.add_argument("--ssv", default="", dest="ssv_path",
                   help="write associations to this file instead of stdout")
    p.add_argument("--no-native", action="store_true",
                   help="disable the native C++ host I/O engine")
    p.add_argument("--probe", default="auto",
                   choices=("auto", "hashed", "xl", "classic"),
                   help="probe-path selection: auto (default) uses a "
                        "one-gather hashed table when buildable (the "
                        "GB-scale xl variant past the 64MB bucket-table "
                        "budget); classic forces the two-gather layout "
                        "(correct at any scale); hashed/xl fail fast if "
                        "not buildable")
    p.add_argument("--profile-dir", default="",
                   help="write a jax.profiler trace to this directory")
    p.add_argument("--compile-cache", default=DEFAULT_COMPILE_CACHE,
                   metavar="DIR",
                   help="persistent XLA compile cache (repeat runs of a "
                        "geometry skip its jit compile; default: "
                        ".jax_cache in the checkout); '' disables; "
                        "JAX_COMPILATION_CACHE_DIR, when set, wins")
    p.add_argument("--resume", action="store_true",
                   help="checkpoint per batch to <ssv>.progress and resume "
                        "an interrupted run from the last checkpoint "
                        "(requires --ssv, --max-read-len, plain outputs)")
    p.add_argument("--stats-json", default="",
                   help="write machine-readable run statistics (reads, "
                        "associations, phase seconds, reads/s, device) to "
                        "this path as one JSON object")
    # multi-host launch (one process per host; see parallel/distributed.py)
    p.add_argument("--coordinator", default="",
                   help="jax.distributed coordinator address host:port")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="total hosts in the multi-host run (default: 1)")
    p.add_argument("--host-id", type=int, default=0,
                   help="this host's index in [0, num-hosts)")
    return p


def config_from_args(args: argparse.Namespace) -> SharkConfig:
    return SharkConfig(
        fasta_path=args.reference,
        sample1_path=args.sample1,
        sample2_path=args.sample2,
        out1_path=args.out1,
        out2_path=args.out2,
        k=args.kmer_size,
        c=args.confidence,
        bf_gb=args.bf_size,
        min_quality=args.min_base_quality,
        single=args.single,
        verbose=args.verbose,
        threads=args.threads,
        batch_size=args.batch_size,
        max_read_len=args.max_read_len,
        backend=args.backend,
        devices=args.devices,
        sharded_bf=args.sharded_bf,
        save_index=args.save_index,
        load_index=args.load_index,
        ssv_path=args.ssv_path,
        use_native=not args.no_native,
        probe=args.probe,
        profile_dir=args.profile_dir,
        compile_cache=args.compile_cache,
        resume=args.resume,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    try:
        cfg.validate()
        if not (0 <= args.host_id < args.num_hosts):
            raise ValueError("--host-id must be in [0, num-hosts)")
    except ValueError as e:
        print(f"shark-tpu: {e}\naborting...", file=sys.stderr)
        return 1
    if args.num_hosts > 1:
        if not args.coordinator:
            print(
                "shark-tpu: --num-hosts > 1 requires --coordinator\naborting...",
                file=sys.stderr,
            )
            return 1
        if args.backend == "native":
            print(
                "shark-tpu: --backend native is single-host (use "
                "--num-hosts 1)\naborting...",
                file=sys.stderr,
            )
            return 1
        # The platform must be pinned BEFORE the distributed runtime
        # initializes.
        from shark_tpu.pipeline import use_backend

        use_backend(args.backend)
        from shark_tpu.parallel.distributed import initialize

        initialize(args.coordinator, args.num_hosts, args.host_id)
        # per-host outputs; concatenate in host order afterwards
        # (parallel/distributed.py merge_outputs)
        from shark_tpu.parallel.distributed import host_suffixed

        cfg.finalize_outputs()
        cfg.out1_path = host_suffixed(cfg.out1_path, args.host_id)
        if cfg.out2_path:
            cfg.out2_path = host_suffixed(cfg.out2_path, args.host_id)
        if cfg.ssv_path:
            cfg.ssv_path = host_suffixed(cfg.ssv_path, args.host_id)
    from shark_tpu.pipeline import run_pipeline

    stats = run_pipeline(cfg)
    if args.stats_json:
        import json

        path = args.stats_json
        if args.num_hosts > 1:
            # per-host stats, like the data outputs
            path = host_suffixed(path, args.host_id)
        stats = dict(stats)
        if stats.get("classify_s"):
            # classify_s covers only this invocation; a resumed run's
            # n_reads includes the prior invocations' prefix
            done_now = stats["n_reads"] - stats.get("resumed_reads", 0)
            stats["reads_per_sec"] = round(
                done_now / stats["classify_s"], 1
            )
        with open(path, "w") as f:
            json.dump(stats, f)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
