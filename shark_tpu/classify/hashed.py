"""Hashed-probe-table classify path: ONE gather per window.

The classic probe (classify/step.py) pays two dependent random gathers per
window: an 8-byte (word, rank) row from a table as large as the Bloom
bit-vector itself (2 GiB at the default -b 1), then a gene row. On the
previous accelerator XLA's gather was issue-rate-limited, so halving the
number of gathered rows — and shrinking the table below a throughput cliff
past 64 MB (bench/hash_gather_bench.py) — was the biggest lever on the
probe path; hence MAX_TABLE_BYTES. On the GPU the 16 MB panel table fits
the 50 MB L2; the constants are not yet re-derived there (ROADMAP Speed 4).

This layout keys a bucketed open-addressing table directly on the BLOOM
POSITION p = XXH64(kmer) % size (reference semantics: bloomfilter.h:88).
Exactness is preserved by construction: the table stores p itself (split
as bucket = low bits, rest = remaining bits), so membership answers are
identical to the bit-vector's — including reference hash-collision
behavior, since colliding k-mers share p and therefore share the entry.

  bucket b = p & (n_buckets - 1)     (adaptive count, see build_hashed_index)
  row      = table[b]
  entry    = (meta = tag<<tag_shift | p>>lgB,  payload)
             Two slot widths. When p>>lgB fits 14 bits: 4-byte entries
             packed ONE PER u32 WORD (meta16 << 16 | payload16; degree-2
             and row entries span two adjacent words), giving a
             [n_buckets, slots] u32 table with slots = 4 or 8 (gather
             cost grew with ELEMENTS per row on the previous accelerator,
             bench/gather_gap.py, so u32 words beat the same bytes as 16
             u16 lanes). Otherwise: 8-byte entries (tag<<30, 32-bit
             payload) stored PLANAR ([n, 2, 8]: all meta lanes then all
             payload lanes, so a lane slice is contiguous).
             tag 0 empty; 1 = one gene; 2 = TWO genes (payload g0|g1<<16);
             3 = payload = CSR rank, the gene row comes from the classic
             gene_mat/ext_mat tables (degree >= 3, rare — gathered under a
             batch-level cond so degree<=2 batches never pay it)

One entry per set position, so each probe has AT MOST ONE matching entry —
the match reduces to one masked sum over the 8 lanes, no ranked select.
Entries that overflow a bucket's 8 slots (load factor <= 2 keeps this to
~1e-4 of buckets) go to a small stash compared against every probe
elementwise; its size is the next power of two of the actual spill count, so
typical indexes pay ~32 lanes. Build declines (caller falls back to the
classic kernel) when the stash would exceed STASH_CAP — transcriptome-scale
indexes keep the classic two-gather path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from shark_tpu.classify.step import (
    TAG_D1,
    TAG_D2,
    TAG_ROW,
    StaticMeta,
    bloom_positions,
    finish_from_tags,
    take_rows,
    unpack_codes,
)
from shark_tpu.index.structure import SharkIndex
from shark_tpu.ops.kmers import INVALID

BUCKET_SLOTS = 8
STASH_CAP = 256
SMALL_STASH = 64  # cap when shrinking below the natural bucket count
STASH_MIN = 32
# Table-size budget from the previous accelerator's gather cliff past
# 64 MB (bench/hash_gather_bench.py). Kept so auto-selection and outputs
# are unchanged; not yet measured on the GPU (ROADMAP Speed 4).
MAX_TABLE_BYTES = 64 << 20
MAX_BUCKETS = MAX_TABLE_BYTES // (8 * BUCKET_SLOTS)

# --- GB-scale "xl" layout (one gather past the 64 MB cliff) -------------
# The cliff was a WIDE-row effect: narrow rows kept gathering fast at any
# table size (bench/txome_gather.py). So transcriptome-scale indexes get a
# 16-byte-row variant: [n_buckets, 4] u32 with the
# entry16 word format (4-byte slots, two-word degree-2/row entries), rest
# narrowed to 13 bits (GB-scale bucket counts make p >> lgB small), and
# bit 13 of slot 0's meta flagging "this bucket overflowed". Overflowing
# entries land in a SIDE table (a small bucketed entry8 hash of their
# own) probed only for flagged-and-unmatched windows, compacted to
# XL_SIDE_CAP columns per read under a batch-level cond — so the common
# case pays exactly ONE gather per window instead of the classic path's
# two dependent ones (bf_rank -> pay).
XL_SLOTS = 4
XL_REST_BITS = 13
XL_FLAG_BIT = 29  # u32 bit of slot-0's word: bucket-overflow flag
XL_SIDE_CAP = 8  # compacted side-lookup columns per read
XL_SIDE_STASH_CAP = 128
XL_MAX_LGB = 30


class HashedDeviceIndex(NamedTuple):
    # entry16: uint32[n_buckets, slots] (meta16<<16 | pay16 per word);
    # entry8:  uint32[n_buckets, 2, BUCKET_SLOTS] (w0 plane, w1 plane);
    # xl:      uint32[n_buckets, XL_SLOTS] (entry16 words, 13-bit rest,
    #          flag bit; spills resolve through `side`/`side_stash`)
    table: jnp.ndarray
    stash: jnp.ndarray  # uint32[S, 4]: pos_lo, pos_hi, tag, payload
    rows3: jnp.ndarray  # uint16[max(n_deg3,1), D3+1] compacted deg>=3 rows
    ext_mat: Optional[jnp.ndarray] = None
    side: Optional[jnp.ndarray] = None  # xl spill table (entry8 buckets)
    side_stash: Optional[jnp.ndarray] = None  # uint32[S2, 4]


@dataclass(frozen=True)
class HashedMeta:
    lgB: int  # log2(n_buckets)
    has_rows: bool  # any degree >= 3 entry exists (enables the cond path)
    entry16: bool = False  # 4-byte entries (one u32 word each) vs 8-byte
    slots: int = BUCKET_SLOTS  # entry slots per bucket (entry16: 4 or 8)
    xl: bool = False  # GB-scale 16-byte-row layout with a spill side table
    side_lgB: int = 0  # log2 bucket count of the xl side table
    has_side: bool = False  # any xl spill exists (enables the side cond)


def _set_bit_positions(
    index: SharkIndex, threads: Optional[int] = None
) -> np.ndarray:
    """Ascending positions of set Bloom bits (uint64), aligned with CSR
    rank order.

    The native parallel scan does this at memory bandwidth (~1-2 s at
    transcriptome scale); the numpy fallback is a chunked little-endian
    unpackbits (~20-25 s there — flatnonzero over the unpacked bools is
    the wall; the prior 32-masked-select + 72M-u64-sort version cost the
    same)."""
    from shark_tpu.io.native import set_positions_native

    got = set_positions_native(
        np.ascontiguousarray(index.bf_words),
        int(index.n_set_bits),
        threads=threads,
    )
    if got is not None:
        return got
    import sys as _sys

    if _sys.byteorder != "little":
        # the u8-view + bitorder="little" trick below maps byte order
        # into bit positions and is only correct on little-endian hosts
        # (x86-64 and aarch64 hosts); the native path is endian-safe
        raise NotImplementedError(
            "pure-Python set-bit extraction requires a little-endian host"
        )
    bw = index.bf_words
    n = int(index.n_set_bits)
    out = np.empty(n, np.uint64)
    u8 = bw.view(np.uint8)
    CH = 1 << 24  # bytes per chunk (128 MB of unpacked bools)
    o = 0
    for s in range(0, u8.size, CH):
        bits = np.unpackbits(u8[s : s + CH], bitorder="little")
        nz = np.flatnonzero(bits)
        out[o : o + nz.size] = nz.astype(np.uint64) + np.uint64(s * 8)
        o += nz.size
    assert o == n, (o, n)
    return out


def _entry_streams(index: SharkIndex, threads: Optional[int] = None):
    """(pos, tag, payload, has_rows, deg): one (tag, payload) entry per set
    Bloom position in CSR rank order — the shared input of every hashed
    table layout. Tag semantics per step.TAG_*; tag-3 payloads index the
    COMPACTED deg>=3 row table (build_rows3), not the global CSR rank."""
    pos = _set_bit_positions(index, threads=threads)
    deg = np.diff(index.offsets).astype(np.int64)
    off = index.offsets[:-1].astype(np.int64)
    gene_ids = np.asarray(index.gene_ids)
    first_gene = gene_ids[np.minimum(off, gene_ids.size - 1)].astype(np.uint32)

    tag = np.where(deg == 1, TAG_D1, np.where(deg == 2, TAG_D2, TAG_ROW))
    payload = first_gene.copy()
    d2 = deg == 2
    if d2.any():
        payload[d2] |= gene_ids[off[d2] + 1].astype(np.uint32) << 16
    d3 = deg >= 3
    if d3.any():
        from shark_tpu.classify.step import rows3_payload

        payload[d3] = rows3_payload(index)  # rows3 index (+ gid bits)
    return pos, tag, payload, bool(d3.any()), deg


def _demand_bincount(pos: np.ndarray, need, lgB: int) -> np.ndarray:
    """Per-bucket slot-word demand (int64[2^lgB]). Integer bincounts: the
    float-weights form costs 4 s at 72M entries; deg>=2 entries are rare,
    so counting them as a second tiny bincount is ~2.5x faster."""
    b = (pos & np.uint64((1 << lgB) - 1)).astype(np.int64)
    d = np.bincount(b, minlength=1 << lgB)
    if need is not None:
        extra = b[need == 2]
        if extra.size:
            d = d + np.bincount(extra, minlength=1 << lgB)
    return d


def build_hashed_index(
    index: SharkIndex,
    prefer_small: bool = True,
    allow16: bool = True,
    threads: Optional[int] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray, HashedMeta]]:
    """(table, stash, meta) or None if this index should use the classic
    path (stash overflow at the table-size cap, or rank capacity).

    Bucket layouts, tried fewest-gathered-elements-first (gather cost per
    row and per element, and the cliff past MAX_TABLE_BYTES, come from the
    previous accelerator; bench/gather_gap.py re-measures them):

    - entry16 (one u32 word per entry: tag<<14|rest in the high half,
      payload16 low): [n_buckets, slots] with slots = 4, then 8; a
      degree-2 or row entry takes TWO adjacent words (payload halves).
      Needs rest = p >> lgB to fit 14 bits.
    - entry8 (64-byte planar buckets): 8-byte entries (tag<<30|rest,
      payload32). Needs rest to fit 30 bits.

    The spill stash is a broadcast compare against every probe, so
    candidates are accepted only while it stays tiny.
    prefer_small=False pins the natural entry8 bucket count (A/B control).
    """
    n_set = index.n_set_bits
    if n_set == 0:
        meta = HashedMeta(lgB=6, has_rows=False)
        return (
            np.zeros((64, 2, BUCKET_SLOTS), np.uint32),
            _pad_stash(np.empty((0, 4), np.uint32)),
            meta,
        )
    if n_set >= 1 << 31:
        return None  # int32 gene_mat addressing for TAG_ROW ranks

    pos, tag, payload, has_rows, deg = _entry_streams(index, threads=threads)
    assert pos.size == n_set

    need16 = np.where(deg == 1, 1, 2).astype(np.int64)
    slots16 = int(need16.sum())

    candidates = []  # (entry16, slots, lgB, is_last_of_family)
    if allow16 and prefer_small:
        # 8 slots/bucket only: 4-slot buckets (fewer gathered elements)
        # measured slower in-kernel on the previous accelerator — table
        # size/bucket count dominated inside the fused kernel
        for slots in (8,):
            lg_cap = int(np.log2(MAX_TABLE_BYTES // (4 * slots)))
            lg_nat = min(max(6, int(np.ceil(np.log2(slots16)))), lg_cap)
            fam = [
                c
                for c in range(max(6, lg_nat - 3), lg_nat + 1)
                if index.size_bits <= (1 << c) << 14
            ]
            if fam:
                candidates += [(True, slots, c, c == fam[-1]) for c in fam]
    lg_nat8 = min(
        max(6, int(np.ceil(np.log2(n_set)))),
        int(np.log2(MAX_BUCKETS)),
    )
    lo8 = max(6, lg_nat8 - 3) if prefer_small else lg_nat8
    fam8 = [
        c
        for c in range(lo8, lg_nat8 + 1)
        if index.size_bits <= (1 << c) << 30
    ]
    candidates += [(False, BUCKET_SLOTS, c, c == fam8[-1]) for c in fam8]

    for entry16, slots, lgB, last in candidates:
        need = need16 if entry16 else None
        limit = STASH_CAP if (last and not entry16) else SMALL_STASH
        # cheap slot-demand bound before the exact pack
        demand = _demand_bincount(pos, need, lgB)
        if int((demand - slots).clip(min=0).sum()) > 2 * limit + 2:
            continue
        built = _pack_table(pos, tag, payload, need, lgB, entry16, slots)
        if built is None:
            continue
        table, stash_rows = built
        if stash_rows.shape[0] > limit:
            continue
        return (
            table,
            _pad_stash(stash_rows),
            HashedMeta(
                lgB=lgB, has_rows=has_rows, entry16=entry16, slots=slots
            ),
        )
    return None


def build_hashed_xl(
    index: SharkIndex,
    lgB: Optional[int] = None,
    side_lgB: Optional[int] = None,
    threads: Optional[int] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, HashedMeta]]:
    """(table, side, side_stash, meta) for the GB-scale one-gather layout,
    or None when the classic path should be used instead.

    Sizing: buckets hold XL_SLOTS u32 words; entry slot demand is 1 word
    per degree-1 entry and 2 for degree>=2 (payload halves, like entry16).
    The natural bucket count puts ~1-2 demand words per 4-slot bucket —
    Poisson spill mass <= ~1.5% of entries — and the spilled minority goes
    to a SIDE entry8 table probed only for flagged-and-unmatched windows
    (compacted, batch-level cond), so per-window cost stays one 16-byte
    gather. `lgB`/`side_lgB` pin the geometries for A/B tests and fuzzing.

    Replaces bloomfilter.h:78-102's rank->select walk at transcriptome
    scale with the same observable membership/association answers."""
    n_set = index.n_set_bits
    if n_set == 0 or n_set >= 1 << 31:
        return None
    lg_min = max(
        6, int(np.ceil(np.log2(index.size_bits))) - XL_REST_BITS
    )
    if lg_min > XL_MAX_LGB:
        return None  # bloom too large for 13-bit rest at any bucket count
    spill_cap = max(n_set // 64, 1024)
    decline_cap = max(n_set // 8, 4096)

    def _cands(demand: int):
        """Bucket-count candidates (shared by the native and numpy
        builds so their selection policy cannot desynchronize)."""
        if lgB is not None:
            cs = [lgB]
        else:
            lg_nat = int(np.ceil(np.log2(max(demand, 2))))
            cs = sorted(
                {
                    min(max(c, lg_min), XL_MAX_LGB)
                    for c in (lg_nat - 1, lg_nat)
                }
            )
        # bit 13 of meta16 is the overflow flag, so rest must fit 13 bits
        # strictly at EVERY candidate (lg_min guarantees it for the auto
        # ones; this guards pinned lgB and refactors — a too-small lgB
        # would silently bleed rest bits into the flag/tag fields)
        assert (int(index.size_bits) - 1) >> cs[0] < (
            1 << XL_REST_BITS
        ), cs[0]
        return cs

    from shark_tpu.io.native import pack_xl_native
    from shark_tpu.io import native as _native

    if _native.available():
        # Native fast path: entry streams + bucket fill in one C++ pass
        # (shk_pack_xl; the numpy pack below allocates ~15 fresh
        # 72M-element temporaries at txome scale, which a host with slow
        # page faults turns into minutes). Candidate choice is by ACTUAL spill count at each
        # geometry (try-pack) instead of the numpy path's word-demand
        # bound — both exact; the auto-picked lgB can differ by 1 in a
        # narrow band between the two environments.
        from shark_tpu.classify.step import rows3_payload

        deg = np.diff(index.offsets)
        has_rows = bool((deg >= 3).any())
        d3pay = (
            rows3_payload(index) if has_rows else np.zeros(0, np.uint32)
        )
        demand = 2 * n_set - int(np.count_nonzero(deg == 1))
        del deg
        cands = _cands(demand)
        table = spill = None
        for c in cands:
            cap = decline_cap if c == cands[-1] else 2 * spill_cap
            res = pack_xl_native(
                index, d3pay, c, XL_SLOTS, True, cap, threads=threads
            )
            if res is not None:
                table, spill, lgB = res[0], res[1], c
                break
        if table is None:
            return None  # every candidate spilled past the decline cap
    else:
        pos, tag, payload, has_rows, deg = _entry_streams(
            index, threads=threads
        )
        need = np.where(deg == 1, 1, 2).astype(np.int64)
        demand = int(need.sum())
        cands = _cands(demand)
        if len(cands) > 1:
            # choose the bucket count from a cheap slot-demand bound (one
            # bincount per candidate) so the expensive exact pack runs
            # ONCE: take the smallest whose overflow bound stays ~1.5%
            for c in cands:
                demand_c = _demand_bincount(pos, need, c)
                bound = int((demand_c - XL_SLOTS).clip(min=0).sum())
                if bound <= 2 * spill_cap or c == cands[-1]:
                    cands = [c]
                    break
        lgB = cands[0]
        # bit 13 of meta16 is the overflow flag, so rest must fit 13 bits
        # strictly (lg_min guarantees it; the assert guards refactors)
        assert int(pos.max(initial=0)) >> lgB < (1 << XL_REST_BITS), lgB
        table, spill = _pack_table(
            pos, tag, payload, need, lgB, True, XL_SLOTS
        )
        if spill.shape[0] > decline_cap:
            return None  # degenerate distribution; classic path is safer

    n_sp = spill.shape[0]
    if n_sp:
        # flag every overflowed bucket (bit 13 of slot-0's meta16): probes
        # that miss in a flagged bucket must consult the side table
        spos = _stash_positions(spill)
        sbuck = (spos & np.uint64((1 << lgB) - 1)).astype(np.int64)
        table[np.unique(sbuck), 0] |= np.uint32(1 << XL_FLAG_BIT)

        lg2_min = max(6, int(np.ceil(np.log2(index.size_bits))) - 30)
        lg2 = side_lgB if side_lgB is not None else max(
            lg2_min, int(np.ceil(np.log2(max(n_sp, 2)))) - 2
        )
        side = None
        for c2 in range(lg2, min(lg2 + 8, XL_MAX_LGB + 1)):
            s, st = _pack_table(
                spos, spill[:, 2].astype(np.int64), spill[:, 3], None, c2,
                False,
            )
            if st.shape[0] <= XL_SIDE_STASH_CAP:
                side, side_stash_rows, lg2 = s, st, c2
                break
            if side_lgB is not None:
                return None  # pinned geometry cannot absorb its spills
        if side is None:
            return None
    else:
        lg2 = 6
        side = np.zeros((1 << lg2, 2, BUCKET_SLOTS), np.uint32)
        side_stash_rows = np.empty((0, 4), np.uint32)

    meta = HashedMeta(
        lgB=lgB,
        has_rows=has_rows,
        entry16=True,
        slots=XL_SLOTS,
        xl=True,
        side_lgB=lg2,
        has_side=n_sp > 0,
    )
    return table, side, _pad_stash(side_stash_rows), meta


def _stash_positions(rows: np.ndarray) -> np.ndarray:
    """uint64 positions from stash-layout rows (pos_lo, pos_hi, ...)."""
    return rows[:, 0].astype(np.uint64) | (
        rows[:, 1].astype(np.uint64) << np.uint64(32)
    )


def _pack_table(
    pos: np.ndarray,
    tag: np.ndarray,
    payload: np.ndarray,
    need: Optional[np.ndarray],  # slots per entry (None = all 1, entry8)
    lgB: int,
    entry16: bool,
    slots: int = BUCKET_SLOTS,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(table, stash_rows) for one (layout, bucket-count) candidate.

    Host-cost discipline (profiled at the 72M-entry xl scale): sort ONE
    u32 key and gather only the
    three arrays the fill needs (bucket/need are re-derived elementwise —
    a 72M random gather costs ~2.6 s, the derivation ~0.3 s), and the
    per-bucket slot offsets come from one maximum.accumulate instead of
    a flatnonzero + two concatenates + a 72M np.repeat (15.9 -> ~2 s)."""
    n_set = pos.size
    n_buckets = 1 << lgB
    bucket = (pos & np.uint64(n_buckets - 1)).astype(np.uint32)
    order = np.argsort(bucket, kind="stable")
    pos_s = pos[order]
    tag_s = tag[order].astype(np.uint32)
    pay_s = payload[order]
    bucket_s = (pos_s & np.uint64(n_buckets - 1)).astype(np.int64)
    if need is not None:
        # need is always where(deg==1, 1, 2) and tag is TAG_D1 iff deg==1
        # (build_hashed_index/_xl), so re-derive instead of gathering.
        # Check the contract on the WHOLE array: a caller violating it
        # between sampled entries would silently build a wrong table, and
        # the full vectorized compare costs ~100 ms at 72M entries —
        # negligible next to the pack itself.
        assert (
            (need == 1) == (tag == TAG_D1)
        ).all(), "need/tag contract violated"
        need_s = np.where(tag_s == TAG_D1, 1, 2).astype(np.int64)
    else:
        need_s = np.ones(n_set, np.int64)
    csum = np.cumsum(need_s)
    start = csum - need_s  # nondecreasing
    is_first = np.empty(n_set, bool)
    if n_set:
        is_first[0] = True
        is_first[1:] = bucket_s[1:] != bucket_s[:-1]
    base = np.maximum.accumulate(np.where(is_first, start, 0))
    slot = start - base  # first slot offset within the bucket
    in_table = slot + need_s <= slots
    spill = np.flatnonzero(~in_table)

    rest = (pos_s >> np.uint64(lgB)).astype(np.uint32)
    tb = bucket_s[in_table]
    ts = slot[in_table]
    if entry16:
        assert int(rest.max(initial=0)) < (1 << 14)
        # one u32 word per entry: meta16 (tag<<14|rest) high, payload16 low
        table = np.zeros((n_buckets, slots), dtype=np.uint32)
        meta16 = ((tag_s << 14) | rest).astype(np.uint32) << 16
        table[tb, ts] = meta16[in_table] | (pay_s[in_table] & 0xFFFF)
        two = in_table & (need_s == 2)
        table[bucket_s[two], slot[two] + 1] = meta16[two] | (
            pay_s[two] >> 16
        )
    else:
        table = np.zeros((n_buckets, 2, BUCKET_SLOTS), dtype=np.uint32)
        table[tb, 0, ts] = (tag_s[in_table] << 30) | rest[in_table]
        table[tb, 1, ts] = pay_s[in_table]

    stash = np.empty((spill.size, 4), dtype=np.uint32)
    stash[:, 0] = (pos_s[spill] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    stash[:, 1] = (pos_s[spill] >> np.uint64(32)).astype(np.uint32)
    stash[:, 2] = tag_s[spill]
    stash[:, 3] = pay_s[spill]
    return table, stash


def _pad_stash(stash: np.ndarray) -> np.ndarray:
    """Pad to the next power of two >= STASH_MIN with rows that can never
    match a real probe (pos_hi of a real position is < 2^4)."""
    n = max(STASH_MIN, 1 << int(np.ceil(np.log2(max(1, stash.shape[0])))))
    pad = np.full((n - stash.shape[0], 4), 0xFFFFFFFF, np.uint32)
    return np.vstack([stash, pad]) if stash.size else pad


def classify_kernel_hashed(
    dix: HashedDeviceIndex,
    thresh: jnp.ndarray,
    codes: jnp.ndarray,  # uint8[B, L]
    *,
    meta: StaticMeta,
    hmeta: HashedMeta,
    max_winners: int,
):
    """One bucket gather per window -> at most one entry match -> direct
    (gene << pos_bits | pos) sort keys -> the shared coverage/winner
    reduction. Bit-exact with the classic kernel by construction. Layout
    choices: planar table slicing (contiguous lane slices of a row), and
    keys built directly, which skips a synthetic [B, Ls, D+1] gene-row
    materialization."""
    L = codes.shape[1]

    idx_hi, idx_lo, win_valid = bloom_positions(codes, meta)
    length = jnp.sum((codes < INVALID).astype(jnp.int32), axis=1)

    lgB = hmeta.lgB
    bucket = (idx_lo & jnp.uint32((1 << lgB) - 1)).astype(jnp.int32)
    rest = (idx_lo >> lgB) | (idx_hi << (32 - lgB))

    row = take_rows(dix.table, bucket)  # ONE flat-index gather
    if hmeta.xl:
        # 16-byte rows, entry16 word format with 13-bit rest; the bucket-
        # overflow flag rides bit 13 of slot 0's meta, excluded from the
        # rest compare by the narrower mask. rest always fits 13 bits for
        # probe positions too (p < size_bits <= 2^lgB << 13 by build).
        meta_l = row >> 16
        pay_l = row & jnp.uint32(0xFFFF)
        lane_tag = meta_l >> 14
        m = (
            ((meta_l & jnp.uint32((1 << XL_REST_BITS) - 1)) == rest[..., None])
            & (lane_tag != 0)
            & win_valid[..., None]
        )
        iota = jnp.arange(hmeta.slots, dtype=jnp.uint32)
        fs = jnp.min(
            jnp.where(m, iota, hmeta.slots), axis=-1, keepdims=True
        )
        p0 = jnp.sum(jnp.where(m & (iota == fs), pay_l, 0), axis=-1)
        p1 = jnp.sum(jnp.where(m & (iota > fs), pay_l, 0), axis=-1)
        tagv = jnp.max(jnp.where(m, lane_tag, 0), axis=-1)
        payv = p0 | (p1 << 16)
        if hmeta.has_side:
            flagged = ((row[..., 0] >> XL_FLAG_BIT) & 1) == 1
            need_side = win_valid & flagged & ~jnp.any(m, axis=-1)
            tagv, payv = _xl_side_resolve(
                dix, hmeta, idx_lo, idx_hi, need_side, tagv, payv
            )
    elif hmeta.entry16:
        # one u32 word per entry (meta16 high, payload16 low); a degree-2
        # or row entry spans TWO adjacent words with identical meta, so up
        # to two lanes match and their payloads reassemble into the same
        # 32-bit payv word the entry8 path produces.
        meta_l = row >> 16  # [B, Ls, slots]
        pay_l = row & jnp.uint32(0xFFFF)
        lane_tag = meta_l >> 14
        m = (
            ((meta_l & jnp.uint32(0x3FFF)) == rest[..., None])
            & (lane_tag != 0)
            & win_valid[..., None]
        )
        iota8 = jnp.arange(hmeta.slots, dtype=jnp.uint32)
        fs = jnp.min(
            jnp.where(m, iota8, hmeta.slots), axis=-1, keepdims=True
        )
        p0 = jnp.sum(jnp.where(m & (iota8 == fs), pay_l, 0), axis=-1)
        p1 = jnp.sum(jnp.where(m & (iota8 > fs), pay_l, 0), axis=-1)
        tagv = jnp.max(jnp.where(m, lane_tag, 0), axis=-1)
        payv = p0 | (p1 << 16)
    else:
        w0 = row[..., 0, :]
        w1 = row[..., 1, :]
        lane_tag = w0 >> 30
        m = (
            ((w0 & jnp.uint32(0x3FFFFFFF)) == rest[..., None])
            & (lane_tag != 0)
            & win_valid[..., None]
        )
        # one entry per position => at most one lane matches: masked sums
        tagv = jnp.sum(jnp.where(m, lane_tag, 0), axis=-1)
        payv = jnp.sum(jnp.where(m, w1, 0), axis=-1)

    if not hmeta.xl:
        # stash lanes: full-position compare (bucket spills — no
        # locality). The xl layout resolves spills through its side
        # table instead (above); its dix.stash is an empty pad.
        st = dix.stash  # [S, 4]
        sm = (
            (idx_lo[..., None] == st[:, 0][None, None, :])
            & (idx_hi[..., None] == st[:, 1][None, None, :])
            & win_valid[..., None]
        )
        tagv = tagv + jnp.sum(
            jnp.where(sm, st[:, 2][None, None, :], 0), axis=-1
        )
        payv = payv + jnp.sum(
            jnp.where(sm, st[:, 3][None, None, :], 0), axis=-1
        )

    # shared back-end: direct keys for degree<=2, compacted rows3 gather
    # under a batch-level cond for degree>=3, sort-based finish
    return finish_from_tags(
        tagv,
        payv,
        length,
        thresh,
        rows3=dix.rows3,
        ext_mat=dix.ext_mat,
        meta=meta,
        max_winners=max_winners,
        L=L,
        has_rows=hmeta.has_rows,
    )


def _xl_side_resolve(
    dix: HashedDeviceIndex,
    hmeta: HashedMeta,
    idx_lo: jnp.ndarray,  # u32[B, Ls]
    idx_hi: jnp.ndarray,  # u32[B, Ls]
    need_side: jnp.ndarray,  # bool[B, Ls]: flagged bucket, no row match
    tagv: jnp.ndarray,
    payv: jnp.ndarray,
):
    """Resolve spilled xl entries through the side table. Windows needing
    it are rare (spill mass ~1% x probe traffic), so they compact to
    XL_SIDE_CAP columns per read for one small bucket gather; a batch
    where some read exceeds the cap takes a full-width side gather
    instead (exact either way), and side-free batches skip everything
    under the outer cond. A window in need_side matched NOTHING in the
    main row (tag 0), so merging side results is a plain overwrite.

    Cost discipline: every [B, CAP]-row gather/scatter pays a per-row
    issue cost, so the resolve is budgeted in row-ops. The first version
    spent a large share of the xl kernel on 7 row-ops at CAP=16; this one
    does 5 at CAP=8 — invalid compaction lanes scatter into a DUMP column
    that is sliced off, which deletes the two original-value
    take_along_axis writebacks, and CAP=8 still bounds the Binomial(Ls,
    ~0.6%) per-read
    side demand far past the max over 64k reads (the full branch keeps
    heavier batches exact)."""
    import jax

    B, Ls = need_side.shape
    lg2 = hmeta.side_lgB
    mask2 = jnp.uint32((1 << lg2) - 1)
    st = dix.side_stash  # [S2, 4]

    def match_side(rows, lo, hi, valid):
        # entry8 lane semantics (planar w0/w1) + the side's own stash
        w0 = rows[..., 0, :]
        w1 = rows[..., 1, :]
        rest2 = (lo >> lg2) | (hi << (32 - lg2))
        lane_tag = w0 >> 30
        m = (
            ((w0 & jnp.uint32(0x3FFFFFFF)) == rest2[..., None])
            & (lane_tag != 0)
            & valid[..., None]
        )
        t = jnp.sum(jnp.where(m, lane_tag, 0), axis=-1)
        p = jnp.sum(jnp.where(m, w1, 0), axis=-1)
        sm = (
            (lo[..., None] == st[:, 0])
            & (hi[..., None] == st[:, 1])
            & valid[..., None]
        )
        t = t + jnp.sum(jnp.where(sm, st[:, 2], 0), axis=-1)
        p = p + jnp.sum(jnp.where(sm, st[:, 3], 0), axis=-1)
        return t, p

    col_iota = jnp.broadcast_to(
        jnp.arange(Ls, dtype=jnp.int32)[None, :], (B, Ls)
    )

    def compact_branch(_):
        # ascending-column compaction; invalid lanes keep the sentinel Ls
        # so they scatter into the dump column below (valid columns are
        # distinct, so scatter order never matters)
        need_col = jnp.where(need_side, col_iota, Ls)
        scol_s = jnp.sort(need_col, axis=1)[:, :XL_SIDE_CAP]
        svalid = scol_s < Ls
        scol = jnp.minimum(scol_s, Ls - 1)
        # (Fusing lo/hi into one 2-element-row gather and (tag,pay) into
        # one [B,Ls+1,2] scatter lost on the previous accelerator — the
        # interleaved stack/unstack relayouts cost more than the saved
        # per-row issue ops. Separate [B, CAP] ops stay.)
        lo = jnp.take_along_axis(idx_lo, scol, axis=1)
        hi = jnp.take_along_axis(idx_hi, scol, axis=1)
        rows = take_rows(dix.side, (lo & mask2).astype(jnp.int32))
        t, p = match_side(rows, lo, hi, svalid)
        # a need_side window's original (tagv, payv) is (0, 0) — matched
        # nothing in the main row — so the side result overwrites it even
        # when the side also misses (t == 0); invalid lanes land in the
        # dump column Ls, which the slice drops
        rix = jnp.arange(B, dtype=jnp.int32)[:, None]
        pad = jnp.zeros((B, 1), tagv.dtype)
        new_t = jnp.concatenate([tagv, pad], axis=1)
        new_p = jnp.concatenate([payv, pad], axis=1)
        return (
            new_t.at[rix, scol_s].set(t)[:, :Ls],
            new_p.at[rix, scol_s].set(p)[:, :Ls],
        )

    def full_branch(_):
        rows = take_rows(dix.side, (idx_lo & mask2).astype(jnp.int32))
        t, p = match_side(rows, idx_lo, idx_hi, need_side)
        return (
            jnp.where(need_side, t, tagv),
            jnp.where(need_side, p, payv),
        )

    n_side = jnp.sum(need_side.astype(jnp.int32), axis=1)
    return jax.lax.cond(
        jnp.any(need_side),
        lambda _: jax.lax.cond(
            jnp.max(n_side) <= XL_SIDE_CAP, compact_branch, full_branch, None
        ),
        lambda _: (tagv, payv),
        None,
    )


def classify_kernel_hashed_packed(
    dix: HashedDeviceIndex,
    thresh: jnp.ndarray,
    packed: jnp.ndarray,
    vmask: jnp.ndarray,
    *,
    meta: StaticMeta,
    hmeta: HashedMeta,
    max_winners: int,
):
    codes = unpack_codes(packed, vmask)
    return classify_kernel_hashed(
        dix, thresh, codes, meta=meta, hmeta=hmeta, max_winners=max_winners
    )
