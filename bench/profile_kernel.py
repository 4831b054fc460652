"""Device-side stage profiling for the classify kernel (fetch-timed).

Run on the GPU: python bench/profile_kernel.py [B] [L]
Requires bench/.cache/index.npz (created by bench.py).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from shark_tpu.classify.step import StaticMeta, _mod_size
from shark_tpu.index.structure import SharkIndex
from shark_tpu.ops.kmers import INVALID, canonical_kmers_jax
from shark_tpu.ops.xxh64 import xxh64_u64


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 32768
    L = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    idx = SharkIndex.load("bench/.cache/index.npz")
    meta = StaticMeta.for_index(idx, L)
    k, D, G = meta.k, meta.degree, meta.n_genes
    pos_bits = meta.pos_bits

    rng = np.random.default_rng(0)
    codes = jax.device_put(rng.integers(0, 4, size=(B, L), dtype=np.uint8))
    bf_words = jax.device_put(idx.bf_words)
    word_rank = jax.device_put(idx.word_rank)
    offsets = jax.device_put(idx.offsets)
    gene_ids = jax.device_put(
        idx.gene_ids if idx.gene_ids.size else np.zeros(1, np.uint16)
    )
    jax.block_until_ready([codes, bf_words, word_rank, offsets, gene_ids])

    def upto_hash(codes):
        canon, wv = canonical_kmers_jax(codes, k)
        h = xxh64_u64(canon)
        ihi, ilo = _mod_size(h, meta.size_bits)
        return (ihi ^ ilo).sum(), wv.sum()

    def upto_probe(bf_words, word_rank, codes):
        canon, wv = canonical_kmers_jax(codes, k)
        h = xxh64_u64(canon)
        idx_hi, idx_lo = _mod_size(h, meta.size_bits)
        word_idx = ((idx_hi << 27) | (idx_lo >> 5)).astype(jnp.int32)
        w = jnp.take(bf_words, word_idx, axis=0)
        bit_off = idx_lo & 31
        hit = (((w >> bit_off) & 1) == 1) & wv
        low_mask = (jnp.uint32(1) << bit_off) - 1
        rank = jnp.take(word_rank, word_idx, axis=0) + jax.lax.population_count(
            w & low_mask
        )
        return jnp.where(hit, rank, 0).sum()

    def upto_csr(bf_words, word_rank, offsets, gene_ids, codes):
        canon, wv = canonical_kmers_jax(codes, k)
        h = xxh64_u64(canon)
        idx_hi, idx_lo = _mod_size(h, meta.size_bits)
        word_idx = ((idx_hi << 27) | (idx_lo >> 5)).astype(jnp.int32)
        w = jnp.take(bf_words, word_idx, axis=0)
        bit_off = idx_lo & 31
        hit = (((w >> bit_off) & 1) == 1) & wv
        low_mask = (jnp.uint32(1) << bit_off) - 1
        rank = jnp.take(word_rank, word_idx, axis=0) + jax.lax.population_count(
            w & low_mask
        )
        r = jnp.where(hit, rank.astype(jnp.int32), 0)
        off0 = jnp.take(offsets, r, axis=0, mode="clip")
        off1 = jnp.take(offsets, r + 1, axis=0, mode="clip")
        deg = jnp.where(hit, off1 - off0, 0)
        pos_i32 = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None, :], (B, L))
        acc = jnp.zeros((), jnp.uint32)
        for d in range(D):
            g = jnp.take(gene_ids, off0 + d, mode="clip").astype(jnp.uint32)
            key = (g << pos_bits) | pos_i32.astype(jnp.uint32)
            acc += jnp.where(hit & (d < deg), key, 0).sum()
        return acc

    def sort_only(keys):
        return jnp.sort(keys, axis=1).sum()

    from shark_tpu.classify.step import (
        DeviceIndex,
        build_device_index,
        classify_kernel,
        emit_threshold_table,
    )
    import functools

    thresh = jax.device_put(emit_threshold_table(0.6, L))
    bf_rank_h, gene_mat_h, _ = build_device_index(idx)
    dix = DeviceIndex(
        bf_rank=jax.device_put(bf_rank_h),
        gene_mat=jax.device_put(gene_mat_h),
    )
    full = functools.partial(classify_kernel, meta=meta, max_winners=16)

    def merged_probe(dix, codes):
        canon, wv = canonical_kmers_jax(codes, k)
        h = xxh64_u64(canon)
        idx_hi, idx_lo = _mod_size(h, meta.size_bits)
        word_idx = ((idx_hi << 27) | (idx_lo >> 5)).astype(jnp.int32)
        wr = jnp.take(dix.bf_rank, word_idx, axis=0)
        w = wr[..., 0]
        bit_off = idx_lo & 31
        hit = (((w >> bit_off) & 1) == 1) & wv
        low_mask = (jnp.uint32(1) << bit_off) - 1
        rank = wr[..., 1] + jax.lax.population_count(w & low_mask)
        r = jnp.where(hit, rank.astype(jnp.int32), 0)
        gm = jnp.take(dix.gene_mat, r, axis=0)
        return gm.astype(jnp.uint32).sum()

    keys = jax.device_put(
        rng.integers(0, 1 << 24, size=(B, L * D), dtype=np.uint32)
    )

    def timeit(name, fn, *args, n=5):
        f = jax.jit(fn)
        t0 = time.time()
        jax.device_get(jax.tree.map(lambda x: x if x.ndim == 0 else x.sum(), f(*args)))
        warm = time.time() - t0
        ts = []
        for _ in range(n):
            t0 = time.time()
            jax.device_get(
                jax.tree.map(lambda x: x if x.ndim == 0 else x.sum(), f(*args))
            )
            ts.append(time.time() - t0)
        print(f"{name}: {min(ts)*1000:.1f} ms (warm {warm:.1f}s)", flush=True)
        return min(ts)

    print(f"B={B} L={L} D={D} G={G}", flush=True)
    timeit("noop", lambda c: c.sum(), codes)
    timeit("kmers+hash+mod", upto_hash, codes)
    timeit("+bf probe+rank", upto_probe, bf_words, word_rank, codes)
    timeit("+csr keys", upto_csr, bf_words, word_rank, offsets, gene_ids, codes)
    timeit("sort only", sort_only, keys)
    timeit("merged 2-gather probe", merged_probe, dix, codes)
    timeit("full kernel", full, dix, thresh, codes)


if __name__ == "__main__":
    main()
