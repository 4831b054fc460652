"""Host ingest ceiling: NativeStream parse+encode throughput, no device.

The replicated-index data-parallel design scales reads/s with devices
until host ingest saturates, so the parser's rate decides how many devices
one host can feed.
Measures: pull rate through the full ring (parse -> encode/pack ->
shk_next copy), and the parse-only rate (release without encoding is not
separable through the ABI, so parse-only is approximated by a pack_mode=0
run which skips the pack planes).

Usage: python bench/parser_bench.py [fastq] [batch_size]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L = 65536, 104


def log(m):
    print(f"[parser] {m}", file=sys.stderr, flush=True)


def drain(fastq, packed, batch_size=B, threads=0):
    from shark_tpu.io.native import NativeStream

    kwargs = {}
    if threads:
        kwargs["encode_threads"] = threads
    ns = NativeStream(fastq, "", batch_size, L, 0, packed=packed, **kwargs)
    n_total = 0
    t0 = time.time()
    while True:
        nb = ns.next_batch()
        if nb is None:
            break
        n_total += nb[-1]
        ns.release(nb[-2])
    dt = time.time() - t0
    ns.close()
    return n_total, dt


def main():
    fastq = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "bench", ".cache", "reads.fq"
    )
    batch_size = int(sys.argv[2]) if len(sys.argv) > 2 else B
    if not os.path.exists(fastq):
        log("workload missing; run bench.py once first")
        return
    # warm page cache
    with open(fastq, "rb") as f:
        while f.read(1 << 24):
            pass
    for packed in (False, True):
        for threads in (0, 2, 3):
            try:
                best = 0.0
                for _ in range(3):
                    n, dt = drain(fastq, packed, batch_size, threads)
                    best = max(best, n / dt)
                mode = "packed" if packed else "bytes "
                t = threads or 1
                log(f"{mode} enc_threads={t}: {best:,.0f} reads/s")
            except TypeError:
                if threads:
                    continue  # encode_threads not supported yet
                raise


if __name__ == "__main__":
    main()
