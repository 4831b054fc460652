"""Why can the production hashed kernel's bucket gather run slower than the
standalone microbench (bench/hash_gather_bench.py) gathering the same row
width on 16-34MB tables? (It did on the previous accelerator; not yet
measured on the GPU.)

Isolates one variable per case at the PRODUCTION shape (B=65536, Ls=88,
N=5.77M probes; the standalone bench used flat N=4.2M):

  dtype     u32 vs u16 lanes (entry8 vs entry16 tables)
  layout    planar [n,2,8] vs interleaved [n,16] vs wide-word u64[n,8]
  idx shape flat [N] vs [B,Ls]
  consumer  .sum() vs the real planar 8-lane match
  producer  device-resident idx vs idx computed from the kmer/hash chain

Usage: python bench/gather_gap.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

B, Ls = 65536, 88
N = B * Ls
LGB = 19


def log(m):
    print(f"[gap] {m}", file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    dev = jax.devices()[0]
    log(f"device {dev}, N={N} probes, lgB={LGB}")

    nb = 1 << LGB
    tab32 = rng.integers(0, 1 << 31, size=(nb, 2, 8), dtype=np.int64).astype(
        np.uint32
    )
    idx_np = rng.integers(0, nb, size=N, dtype=np.int64).astype(np.int32)

    t_p32 = jax.device_put(tab32, dev)                      # [n,2,8] u32 32MB
    t_i32 = jax.device_put(
        np.ascontiguousarray(tab32.reshape(nb, 16)), dev
    )                                                       # [n,16] u32
    t_w64 = jax.device_put(
        np.ascontiguousarray(tab32.reshape(nb, 16)).view(np.uint64), dev
    )                                                       # [n,8] u64
    t_p16 = jax.device_put(
        (tab32 & 0xFFFF).astype(np.uint16), dev
    )                                                       # [n,2,8] u16 16MB
    t_n4 = jax.device_put(
        np.ascontiguousarray(tab32[:, 0, :4]), dev
    )                                                       # [n,4] u32 8MB
    idx_flat = jax.device_put(idx_np, dev)
    idx_2d = jax.device_put(idx_np.reshape(B, Ls), dev)
    rest = jax.device_put(
        rng.integers(0, 1 << 31, size=(B, Ls), dtype=np.int64).astype(
            np.uint32
        ),
        dev,
    )

    def timeit(f, *args, n=4):
        np.asarray(f(*args))
        best = 1e9
        for _ in range(n):
            t0 = time.time()
            np.asarray(f(*args))
            best = min(best, time.time() - t0)
        return best

    floor = timeit(jax.jit(lambda i: i.sum()), idx_flat)
    log(f"dispatch+fetch floor: {floor * 1000:.1f} ms")

    def report(tag, dt):
        log(
            f"{tag:<42} {dt * 1000:7.1f} ms "
            f"{N / max(dt - floor, 1e-9) / 1e6:8.1f} M rows/s"
        )

    gsum = jax.jit(lambda t, i: jnp.take(t, i, axis=0).astype(jnp.uint32).sum())

    report("A flat idx, [n,16]u32", timeit(gsum, t_i32, idx_flat))
    report("B 2d idx,   [n,16]u32", timeit(gsum, t_i32, idx_2d))
    report("C 2d idx,   [n,2,8]u32 (planar)", timeit(gsum, t_p32, idx_2d))
    report("D flat idx, [n,2,8]u32 (planar)", timeit(gsum, t_p32, idx_flat))
    report("E 2d idx,   [n,8]u64 (wide words)", timeit(gsum, t_w64, idx_2d))
    report("F 2d idx,   [n,2,8]u16 (entry16)", timeit(gsum, t_p16, idx_2d))
    report("G 2d idx,   [n,4]u32 (16B rows)", timeit(gsum, t_n4, idx_2d))

    # real consumer: planar 8-lane match instead of .sum()
    @jax.jit
    def gmatch_p32(t, i, rest):
        row = jnp.take(t, i, axis=0)  # [B,Ls,2,8]
        w0 = row[..., 0, :]
        w1 = row[..., 1, :]
        tag = w0 >> 30
        m = ((w0 & jnp.uint32(0x3FFFFFFF)) == rest[..., None]) & (tag != 0)
        tagv = jnp.sum(jnp.where(m, tag, 0), axis=-1)
        payv = jnp.sum(jnp.where(m, w1, 0), axis=-1)
        return tagv.sum() + payv.sum()

    report("H 2d idx, planar match consumer", timeit(gmatch_p32, t_p32, idx_2d, rest))

    # index produced by a compute chain (simulates hash front-end dependency)
    @jax.jit
    def chain_gather(t, seed):
        x = seed.astype(jnp.uint32)
        for _ in range(8):
            x = x * jnp.uint32(2654435761) + jnp.uint32(0x9E3779B9)
            x ^= x >> 15
        i = (x & jnp.uint32(nb - 1)).astype(jnp.int32)
        return jnp.take(t, i, axis=0).astype(jnp.uint32).sum()

    seed = jax.device_put(
        rng.integers(0, 1 << 31, size=(B, Ls), dtype=np.int64).astype(
            np.uint32
        ),
        dev,
    )
    report("I chained idx, [n,2,8]u32", timeit(chain_gather, t_p32, seed))

    # chunked gather via scan (8 chunks of B/8): VMEM-resident consumer?
    @jax.jit
    def chunked(t, i):
        def body(c, ib):
            return c + jnp.take(t, ib, axis=0).astype(jnp.uint32).sum(), 0

        tot, _ = jax.lax.scan(body, jnp.uint32(0), i.reshape(8, B // 8, Ls))
        return tot

    report("J scan-chunked (8x), [n,2,8]u32", timeit(chunked, t_p32, idx_2d))


if __name__ == "__main__":
    main()
