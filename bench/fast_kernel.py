"""The single-gather "fast" classify kernel — a documented NEGATIVE result,
quarantined out of the production module.

On the previous accelerator the classic two-gather kernel beat this
single-gather layout in BOTH miss-heavy and hit-heavy regimes — the
expensive gather is the GiB-scale probe table (identical in both), the gene
table is small enough to cache, and this kernel's needy-probe compaction
sort + index shuffles cost more than the gather they avoid. Not yet
measured on the GPU. Kept here, runnable, for that A/B; semantics are still exact
(tests/test_classify_device.py exercises equality vs the classic kernel).

Target semantics: reference bloomfilter.h:78-102 + ReadAnalyzer.hpp:39-110.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from shark_tpu.classify.step import (
    INVALID,
    StaticMeta,
    build_gene_mat,
    emit_threshold_table,
    finish_from_keys,
    hash_positions,
    unpack_codes,
)
from shark_tpu.index.structure import SharkIndex


class FastDeviceIndex(NamedTuple):
    """8-byte-row layout for the single-gather kernel.

    rows[w] = (aux, rank): aux packs the word's state —
      state 0: word empty (every probe of it misses)
      state 1: single set bit, one gene  -> aux also has bitpos + gene id
      state 2: single set bit, >1 genes  -> aux has bitpos; rank addresses
               gene_mat directly
      state 3: >=2 set bits              -> rare; the compacted second pass
               fetches the word itself from `words` to resolve hit + rank
    Halves probe-table memory vs the 16-byte aux layout and keeps the
    hot path at one 8-byte random gather per window.
    """

    rows: jnp.ndarray  # uint32[n_words, 2]: aux, rank
    words: jnp.ndarray  # uint32[n_words] (state-3 fallback only)
    gene_mat: jnp.ndarray  # uint16[max(n_set,1), D+1]


FAST_GENE_MASK = 0xFFFF
FAST_BITPOS_SHIFT = 16
FAST_STATE_SHIFT = 21


def build_fast_index(
    index: SharkIndex,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Host-side FastDeviceIndex rows (+ the needy fraction for kernel
    selection). gene_mat comes from build_gene_mat."""
    from shark_tpu.index.build import popcount_u32

    words = index.bf_words
    n_words = words.size
    pc = popcount_u32(words)
    deg = np.diff(index.offsets).astype(np.int64)
    aux = np.zeros(n_words, dtype=np.uint32)
    one = np.flatnonzero(pc == 1)
    multi = np.flatnonzero(pc >= 2)
    if one.size:
        bitpos = popcount_u32(words[one] - np.uint32(1)).astype(np.uint32)
        r = index.word_rank[one].astype(np.int64)
        d1 = deg[r] == 1
        gene = np.zeros(one.size, dtype=np.uint32)
        gene[d1] = index.gene_ids[
            index.offsets[:-1].astype(np.int64)[r[d1]]
        ].astype(np.uint32)
        state = np.where(d1, np.uint32(1), np.uint32(2))
        aux[one] = (
            gene
            | (bitpos << FAST_BITPOS_SHIFT)
            | (state << FAST_STATE_SHIFT)
        )
    if multi.size:
        aux[multi] = np.uint32(3) << FAST_STATE_SHIFT
    rows = np.empty((n_words, 2), dtype=np.uint32)
    rows[:, 0] = aux
    rows[:, 1] = index.word_rank
    n_set = max(1, index.n_set_bits)
    n_fast = int(np.count_nonzero((aux >> FAST_STATE_SHIFT) == 1))
    needy_frac = 1.0 - n_fast / n_set
    return rows, words.copy(), needy_frac


def classify_kernel_fast(
    dix: FastDeviceIndex,
    thresh: jnp.ndarray,
    codes: jnp.ndarray,  # uint8[B, L]
    *,
    meta: StaticMeta,
    max_winners: int,
    cap2: int = 32,
):
    """Single-gather classify: unique-k-mer hits resolve from the 8-byte
    (aux, rank) row alone; only shared-gene or multi-bit-word probes
    (compacted to <= cap2 per read) pay further gathers. Reads with more
    than cap2 such probes get the PACK_OVF flag and are recomputed exactly
    on the host (rare by construction)."""
    B, L = codes.shape
    D = meta.degree
    G = meta.n_genes
    pos_bits = meta.pos_bits

    length = jnp.sum((codes < INVALID).astype(jnp.int32), axis=1)
    word_idx, bit_off, win_valid = hash_positions(codes, meta)
    Ls = word_idx.shape[1]
    off = L - Ls

    row = jnp.take(dix.rows, word_idx, axis=0)  # [B, Ls, 2], one 8B row
    aux = row[..., 0]
    rank0 = row[..., 1]
    state = (aux >> FAST_STATE_SHIFT) & 3
    bitpos = (aux >> FAST_BITPOS_SHIFT) & 31
    bitmatch = (bit_off == bitpos) & win_valid
    fast = (state == 1) & bitmatch
    needy = (((state == 2) & bitmatch) | ((state == 3) & win_valid))

    pos_i32 = jnp.broadcast_to(
        (jnp.arange(Ls, dtype=jnp.int32) + off)[None, :], (B, Ls)
    )
    sentinel = jnp.uint32(G << pos_bits)

    # compact needy probes to the first cap2 per read
    need_pos = jnp.where(needy, pos_i32, L)
    sneed = jnp.sort(need_pos, axis=1)[:, :cap2]  # [B, cap2]
    svalid = sneed < L
    row_ovf = jnp.sum(needy.astype(jnp.int32), axis=1) > cap2
    sneed_c = jnp.minimum(sneed, L - 1)
    scol = jnp.maximum(sneed_c - off, 0)  # column index into [B, Ls] arrays

    # per-slot resolution: state 2 -> rank row is the gene row; state 3 ->
    # fetch the word to compute hit + bit rank
    word2 = jnp.take_along_axis(word_idx, scol, axis=1)  # [B, cap2]
    state2 = jnp.take_along_axis(state, scol, axis=1)
    rank2 = jnp.take_along_axis(rank0, scol, axis=1)
    boff2 = jnp.take_along_axis(bit_off, scol, axis=1)
    w2 = jnp.take(dix.words, jnp.where(svalid, word2, 0), axis=0)
    multi = state2 == 3
    hit2 = svalid & jnp.where(multi, ((w2 >> boff2) & 1) == 1, True)
    low_mask2 = (jnp.uint32(1) << boff2) - 1
    r2 = jnp.where(
        multi,
        rank2 + jax.lax.population_count(w2 & low_mask2),
        rank2,
    ).astype(jnp.int32)
    gm2 = jnp.take(dix.gene_mat, jnp.where(hit2, r2, 0), axis=0)
    deg2 = jnp.where(hit2, gm2[..., 0].astype(jnp.int32), 0)

    fast_key = jnp.where(
        fast,
        ((aux & jnp.uint32(FAST_GENE_MASK)) << pos_bits)
        | pos_i32.astype(jnp.uint32),
        sentinel,
    )
    keys = [fast_key]
    for d in range(D):
        g = gm2[..., 1 + d].astype(jnp.uint32)
        key = (g << pos_bits) | sneed_c.astype(jnp.uint32)
        keys.append(jnp.where(hit2 & (d < deg2), key, sentinel))
    key_mat = jnp.concatenate(keys, axis=1)  # [B, L + cap2*D]

    return finish_from_keys(
        key_mat,
        length,
        thresh,
        row_ovf,
        meta=meta,
        max_winners=max_winners,
        L=L,
    )


def classify_kernel_fast_packed(
    dix: FastDeviceIndex,
    thresh: jnp.ndarray,
    packed: jnp.ndarray,
    vmask: jnp.ndarray,
    *,
    meta: StaticMeta,
    max_winners: int,
    cap2: int = 32,
):
    codes = unpack_codes(packed, vmask)
    return classify_kernel_fast(
        dix, thresh, codes, meta=meta, max_winners=max_winners, cap2=cap2
    )


class FastClassifier:
    """Classifier wrapper over the single-gather kernel (bench/A-B only)."""

    def __init__(
        self,
        index: SharkIndex,
        max_winners: int = 16,
        c: float = 0.6,
        device=None,
        cap2: int = 32,
    ):
        self.index = index
        self.max_winners = max_winners
        self.c = c
        self.cap2 = cap2
        dev = device or jax.local_devices()[0]
        self._dev = dev
        gene_mat, ext_mat = build_gene_mat(index)
        if ext_mat is not None:
            raise ValueError(
                "the quarantined fast kernel predates capped gene rows; "
                "use the production Classifier for max_degree > "
                "GENE_INLINE_CAP indexes"
            )
        rows, words, self.needy_frac = build_fast_index(index)
        self.dix = FastDeviceIndex(
            rows=jax.device_put(rows, dev),
            words=jax.device_put(words, dev),
            gene_mat=jax.device_put(gene_mat, dev),
        )
        self._fns = {}
        self._thresh = {}

    def _fn(self, L: int, packed: bool = False):
        key = (L, packed)
        fn = self._fns.get(key)
        if fn is None:
            meta = StaticMeta.for_index(self.index, L)
            kern = classify_kernel_fast_packed if packed else classify_kernel_fast
            fn = jax.jit(
                functools.partial(
                    kern,
                    meta=meta,
                    max_winners=self.max_winners,
                    cap2=self.cap2,
                )
            )
            self._fns[key] = fn
            if L not in self._thresh:
                self._thresh[L] = jax.device_put(
                    emit_threshold_table(self.c, L), self._dev
                )
        return fn

    def __call__(self, codes: np.ndarray):
        fn = self._fn(codes.shape[1])
        return fn(self.dix, self._thresh[codes.shape[1]], codes)

    def call_packed(self, packed: np.ndarray, vmask: np.ndarray):
        L = packed.shape[1] * 4
        fn = self._fn(L, packed=True)
        return fn(self.dix, self._thresh[L], packed, vmask)
