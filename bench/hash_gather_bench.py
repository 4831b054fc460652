"""Microbenchmark for the hashed-probe-table design.

Decides whether ONE gather into an O(n_set)-sized bucket table can beat the
current TWO gathers (8B rows into the 2 GiB bf_rank table + gene rows).
Measures, in one process on the serving device (compare layouts only
within one run):

  A. bucket-row gather rate vs row width (16/32/64/128B) and table size
     (16MB..1GB) — the hashed kernel's single probe;
  B. the current layouts for an in-session baseline: 8B rows on 2GiB
     ([n,2] u32 and flat u64), and 4B gene-ish rows on a small table;
  C. the per-batch coverage sort at candidate widths;
  D. the elementwise cost of the 8-entry bucket match+select.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def timeit(f, *args, n=5):
    jax.device_get(f(*args))
    ts = []
    for _ in range(n):
        t0 = time.time()
        jax.device_get(f(*args))
        ts.append(time.time() - t0)
    return min(ts)


def main():
    N = 1 << 22  # probes per call
    rng = np.random.default_rng(0)
    gather_sum = jax.jit(lambda t, i: jnp.take(t, i, axis=0).sum())

    print("probes per call:", N, flush=True)
    floor = timeit(
        jax.jit(lambda i: i.sum()), jax.device_put(np.zeros(N, np.int32))
    )
    print(f"dispatch floor: {floor * 1000:.1f} ms", flush=True)

    def report(tag, dt):
        print(
            f"{tag:<44} {dt * 1000:7.1f} ms "
            f"{N / max(dt - floor, 1e-9) / 1e6:8.1f} M rows/s",
            flush=True,
        )

    # A: bucket tables — (log2 buckets, u32 lanes per row)
    for lg, w in [
        (20, 4),   # 16MB, 16B rows
        (20, 8),   # 32MB, 32B rows
        (20, 16),  # 64MB, 64B rows
        (20, 32),  # 128MB, 128B rows
        (21, 16),  # 128MB, 64B rows
        (23, 16),  # 512MB, 64B rows
        (24, 16),  # 1GB, 64B rows
    ]:
        rows = 1 << lg
        tab = jax.device_put(np.zeros((rows, w), np.uint32))
        idx = jax.device_put(
            rng.integers(0, rows, size=N, dtype=np.int64).astype(np.int32)
        )
        dt = timeit(gather_sum, tab, idx)
        report(f"A bucket [{1 << lg:>9},{w:>2}]u32 ({4 * w}B rows)", dt)
        del tab, idx

    # B: current layouts, in-session baseline
    rows = 1 << 28
    idx = jax.device_put(
        rng.integers(0, rows, size=N, dtype=np.int64).astype(np.int32)
    )
    tab = jax.device_put(np.zeros((rows, 2), np.uint32))
    report("B bf_rank [2^28,2]u32 (2GiB, 8B rows)", timeit(gather_sum, tab, idx))
    del tab
    tab = jax.device_put(np.zeros(rows, np.uint64))
    report("B bf_rank flat u64 (2GiB, 8B rows)", timeit(gather_sum, tab, idx))
    del tab, idx
    rows = 1 << 20
    tab = jax.device_put(np.zeros((rows, 2), np.uint16))
    idx = jax.device_put(
        rng.integers(0, rows, size=N, dtype=np.int64).astype(np.int32)
    )
    report("B gene-ish [2^20,2]u16 (4MB, 4B rows)", timeit(gather_sum, tab, idx))
    del tab, idx

    # C: the coverage sort at candidate key widths
    for B, K in [(65536, 112), (65536, 88), (65536, 176), (131072, 88)]:
        keys = jax.device_put(
            rng.integers(0, 1 << 31, size=(B, K), dtype=np.int64).astype(
                np.uint32
            )
        )
        dt = timeit(jax.jit(lambda x: jnp.sort(x, axis=1).sum()), keys)
        print(f"C sort [{B},{K}] u32: {dt * 1000:7.1f} ms", flush=True)
        del keys

    # D: 8-entry bucket match + ranked 2-slot select (VPU elementwise)
    B, Ls = 65536, 88
    row = jax.device_put(
        rng.integers(0, 1 << 31, size=(B, Ls, 16), dtype=np.int64).astype(
            np.uint32
        )
    )
    rest = jax.device_put(
        rng.integers(0, 1 << 31, size=(B, Ls), dtype=np.int64).astype(
            np.uint32
        )
    )

    @jax.jit
    def match_select(row, rest):
        w0 = row[..., 0::2]
        w1 = row[..., 1::2]
        tag = w1 >> 30
        m = (w0 == rest[..., None]) & (tag != 0)
        mg = m & (tag == 1)
        r0 = jnp.cumsum(mg.astype(jnp.int32), axis=-1) - mg.astype(jnp.int32)
        g0 = jnp.sum(
            jnp.where(mg & (r0 == 0), w1 & 0xFFFF, 0), axis=-1
        )
        g1 = jnp.sum(
            jnp.where(mg & (r0 == 1), w1 & 0xFFFF, 0), axis=-1
        )
        rowidx = jnp.sum(jnp.where(m & (tag == 2), w1 & 0x3FFFFFFF, 0), axis=-1)
        return g0.sum() + g1.sum() + rowidx.sum()

    dt = timeit(match_select, row, rest)
    print(f"D match+select [{B},{Ls}]x8 entries: {dt * 1000:7.1f} ms", flush=True)

    # D2: stash compare, 32 entries broadcast against all probes
    stash = jax.device_put(
        rng.integers(0, 1 << 31, size=(32, 2), dtype=np.int64).astype(np.uint32)
    )

    @jax.jit
    def stash_cmp(rest, stash):
        m = rest[..., None] == stash[None, None, :, 0]
        return jnp.sum(jnp.where(m, stash[None, None, :, 1], 0), axis=-1).sum()

    dt = timeit(stash_cmp, rest, stash)
    print(f"D stash compare 32 entries: {dt * 1000:7.1f} ms", flush=True)


if __name__ == "__main__":
    main()
