"""Microbench for the transcriptome-scale classic path's two pain points.

1. The [B,Ls] gene-row gather on a multi-GB gene_mat ran an order of
   magnitude slower than the same row count on MB-scale tables on the
   previous accelerator; not yet measured on the GPU. Hypotheses: per-ELEMENT issue cost explodes past the 64MB cliff (17
   u16 elements/row), vs per-row cost. Sweep element count x table size.
2. Sort dtype: does sorting u16 keys beat u32 at the same width? (The
   finish sort dominates tie-heavy batches; panel-scale keys fit u16.)

Usage: python bench/txome_gather.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

B, Ls = 65536, 88
N = B * Ls


def log(m):
    print(f"[tx] {m}", file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    dev = jax.devices()[0]

    def timeit(f, *args, n=3):
        np.asarray(f(*args))
        best = 1e9
        for _ in range(n):
            t0 = time.time()
            np.asarray(f(*args))
            best = min(best, time.time() - t0)
        return best

    idx_np = None
    floor = timeit(
        jax.jit(lambda i: i.sum()),
        jax.device_put(np.zeros(N, np.int32), dev),
    )
    log(f"floor {floor * 1000:.1f} ms")

    gsum = jax.jit(lambda t, i: jnp.take(t, i.reshape(-1), axis=0).astype(jnp.uint32).sum())

    # 1: element-count x table-size sweep (flat idx everywhere)
    cases = [
        # (rows, spec) — spec: (elems, dtype)
        (1 << 20, (17, np.uint16)),   # 34MB control
        (1 << 26, (17, np.uint16)),   # 2.3GB   = txome gene_mat shape
        (1 << 26, (9, np.uint32)),    # 2.4GB, u32-packed rows
        (1 << 26, (1, np.uint32)),    # 268MB, payload-only rows
        (1 << 26, (2, np.uint32)),    # 537MB
        (1 << 28, (2, np.uint32)),    # 2.1GB  = bf_rank shape (classic probe)
        (1 << 28, (1, np.uint32)),    # 1.1GB flat word-only
    ]
    for rows, (w, dt) in cases:
        tab = jax.device_put(np.zeros((rows, w), dt), dev)
        idx_np = rng.integers(0, rows, size=N, dtype=np.int64).astype(np.int32)
        idx = jax.device_put(idx_np, dev)
        t = timeit(gsum, tab, idx)
        gb = rows * w * np.dtype(dt).itemsize / 1e9
        log(
            f"gather [{rows:>9},{w:>2}]{np.dtype(dt).name:<6} {gb:5.2f}GB "
            f"{t * 1000:7.1f} ms {N / max(t - floor, 1e-9) / 1e6:7.1f} M rows/s"
        )
        del tab, idx

    # 2: sort dtype at finish widths
    for W in (176, 512, 1584):
        a32 = jax.device_put(
            rng.integers(0, 1 << 16, size=(B, W), dtype=np.int64).astype(
                np.uint32
            ),
            dev,
        )
        a16 = jax.device_put(np.asarray(a32).astype(np.uint16), dev)
        s32 = timeit(jax.jit(lambda x: jnp.sort(x, axis=1).astype(jnp.uint32).sum()), a32)
        s16 = timeit(jax.jit(lambda x: jnp.sort(x, axis=1).astype(jnp.uint32).sum()), a16)
        log(
            f"sort [B,{W:>4}]: u32 {s32 * 1000:7.1f} ms   u16 {s16 * 1000:7.1f} ms"
            f"   ratio {s32 / s16:4.2f}"
        )
        del a32, a16


if __name__ == "__main__":
    main()
