"""Sharded-Bloom-filter classification: index larger than one device.

The reference has no analogue (its index is a single shared-memory
structure, bloomfilter.h:36-203); this is the scale-out design from
SURVEY.md §5/§7: partition the Bloom address space across the mesh, route
each probe to the owner device with `all_to_all` (NCCL over NVLink on a
GPU host), and return the owner's answer to the read's home device, where
the coverage/winner
reduction runs exactly as in the replicated path.

Inside one `shard_map` over mesh axis "dp", each device holds
  - a batch shard  codes[B/n, L]
  - an index shard: the bf_rank words and (tag, payload) rows of its
    contiguous 1/n-th of the Bloom address space (ranks are LOCAL to the
    shard, so each shard is a complete mini-probe-index of its range)
  - a REPLICATED copy of the small compacted deg>=3 row tables
    (rows3/ext_mat — ~1% of set bits, megabytes not gigabytes)
and one step performs:
  hash -> owner = word_idx // words_per_shard
  bucket-compact probes by owner (sort + positional pack, fixed capacity)
  all_to_all probe buckets -> owners probe locally (two 8-byte gathers:
    bf_rank, then the pay (tag, payload) row — identical to the classic
    single-chip probe, step.probe_tags)
  all_to_all the 8-byte (tag, payload) replies back -> scatter to window
  positions -> the SHARED finish_from_tags back-end (rows3 resolved on
  the home chip from the replicated tables; group fast path, extension
  rows, and host-recompute escapes all behave exactly as single-chip)

Both all_to_all rounds move 8 bytes per probe (request: local word + bit;
reply: tag/payload words) — the same 8-byte row shape as the classic
probe's gathers (see step.DeviceIndex). An earlier design
returned full-width `[cap, D+1]` uint16 gene rows (up to ~130 B/probe at
D=64) and finished through a separate full-width kernel; the (tag,
payload) wire cuts reply bytes 8-16x and removes the last back-end fork.

Address capacity: the shard router works in (hi, lo) uint32 limbs, so the
GLOBAL Bloom size may exceed the single-chip int32 ceiling of 2^36 bits
(reference -b accepts any size, argument_parser.hpp:130-133); each SHARD
must still fit int32 word addressing (8 GiB of bit-vector per shard —
add devices to grow further).

Bucket capacity defaults to an adaptive binomial-tail bound (mean + 8
sigma): XXH64 spreads DISTINCT k-mers uniformly, so for i.i.d. probes the
per-owner count is Binomial(P, 1/n) and 8 sigma of headroom makes overflow
astronomically unlikely while sending ~half the bytes of the old blanket
2x slack. Duplicate probes (PCR-duplicated reads, low-complexity k-mers)
are NOT independent — in the worst case every probe lands on one owner,
which no fixed slack covers — so overflow is recoverable, not fatal:
overflowed probes are dropped + counted per batch, and the pipeline calls
`reprobe()` to re-run that batch with a geometrically larger cap (the
grown cap sticks for subsequent batches).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from typing import NamedTuple, Optional

from shark_tpu.classify.step import (
    MAX_SIZE_BITS,
    StaticMeta,
    bloom_positions,
    build_pay,
    build_rows3,
    decode_pay_words,
    emit_threshold_table,
    finish_from_tags,
    group_info,
    probe_rank,
    take_rows,
    unpack_codes,
)
from shark_tpu.index.structure import SharkIndex
from shark_tpu.ops.kmers import INVALID
from shark_tpu.parallel.mesh import make_mesh

MISS_SENTINEL = jnp.uint32(0xFFFFFFFF)


class ShardIndexArrays(NamedTuple):
    """Per-shard device arrays (leading shard axis). `pay` rows are the
    classic probe's 8-byte (tag<<30 | g0, g1-or-rows3-index) rows
    (step.build_pay), indexed by shard-LOCAL CSR rank; tag-3 payloads
    carry GLOBAL compacted-rows3 indices, resolved on the read's home
    chip from the replicated rows3/ext tables."""

    bf_rank: jnp.ndarray  # uint32[n, wps, 2]: (bloom word, LOCAL rank)
    pay: jnp.ndarray  # uint32[n, rows_max, 2]


def shard_index(index: SharkIndex, n: int):
    """Split a host SharkIndex into n address-range shards, stacked on a
    leading shard axis for shard_map consumption. Returns
    (bf_ranks u32[n, wps, 2], pays u32[n, rows_max, 2], wps,
    counts int64[n] — real (unpadded) pay rows per shard)."""
    n_words = index.bf_words.size
    if n_words % n != 0:
        raise ValueError(f"{n_words} bloom words not divisible by {n} shards")
    wps = n_words // n
    if wps > 0x7FFFFFFF:
        # int32 local gather addressing; an 8 GiB bit-vector per shard is
        # past per-chip HBM anyway — add devices instead
        raise ValueError(
            f"{wps} bloom words per shard exceeds int32 addressing; "
            "use more devices"
        )
    pay = build_pay(index)
    bf_ranks = np.empty((n, wps, 2), dtype=np.uint32)
    bounds = np.empty(n + 1, dtype=np.int64)
    bounds[0] = 0
    for s in range(n):
        lo_word = s * wps
        hi_word = (s + 1) * wps
        base = int(index.word_rank[lo_word])
        end = (
            int(index.word_rank[hi_word])
            if hi_word < n_words
            else index.n_set_bits
        )
        bounds[s + 1] = end
        bf_ranks[s, :, 0] = index.bf_words[lo_word:hi_word]
        bf_ranks[s, :, 1] = index.word_rank[lo_word:hi_word] - base
    counts = np.diff(bounds)
    if counts.max(initial=0) > 0x7FFFFFFF:
        raise ValueError("per-shard set-bit count exceeds int32 rank range")
    rows_max = max(int(counts.max(initial=0)), 1)
    pays = np.zeros((n, rows_max, 2), dtype=np.uint32)
    for s in range(n):
        base, end = int(bounds[s]), int(bounds[s + 1])
        if end > base:
            pays[s, : end - base] = pay[base:end]
    return bf_ranks, pays, wps, counts


def shard_owner_local(
    idx_hi: jnp.ndarray,  # u32[...]: high limb of the Bloom bit address
    idx_lo: jnp.ndarray,  # u32[...]
    *,
    n: int,
    wps: int,
    wide: bool,
):
    """Global Bloom bit address (hi, lo limbs) -> (owner shard i32,
    shard-local word i32, bit offset u32).

    `wide=False` (size_bits <= 2^36): the 64-bit word index fits int32 and
    owner is one integer division — the original addressing.
    `wide=True`: the word index stays in (hi, lo) u32 limbs; the owner
    comes from n-1 unrolled 64-bit boundary compares against the constant
    shard bounds s*wps (pure elementwise work — a branchless binary search
    would need lg(n) per-probe gathers at full per-row cost), and the
    local word is the low limb of word - owner*wps, exact because the
    difference is < wps < 2^31. This lifts the 2^36-bit global ceiling of
    the int32 front end (reference -b is unbounded,
    argument_parser.hpp:130-133)."""
    bit_off = idx_lo & 31
    word_lo = (idx_hi << 27) | (idx_lo >> 5)
    if not wide:
        word = word_lo.astype(jnp.int32)
        owner = word // jnp.int32(wps)
        local = word - owner * jnp.int32(wps)
        return owner, local, bit_off
    word_hi = idx_hi >> 5
    owner = jnp.zeros(idx_lo.shape, jnp.int32)
    for s in range(1, n):
        b = s * wps
        bhi = jnp.uint32(b >> 32)
        blo = jnp.uint32(b & 0xFFFFFFFF)
        ge = (word_hi > bhi) | ((word_hi == bhi) & (word_lo >= blo))
        owner = owner + ge.astype(jnp.int32)
    # low 32 bits of owner*wps; the u32 subtraction's low limb equals the
    # true 64-bit difference because 0 <= word - owner*wps < wps < 2^31
    bnd_lo = owner.astype(jnp.uint32) * jnp.uint32(wps & 0xFFFFFFFF)
    local = (word_lo - bnd_lo).astype(jnp.int32)
    return owner, local, bit_off


def _route_probe_return(
    dix_shard: ShardIndexArrays,
    owner: jnp.ndarray,  # i32[b, Ls] owning shard per window
    local_word: jnp.ndarray,  # i32[b, Ls] shard-local word index
    bit_off: jnp.ndarray,  # u32[b, Ls]
    win_valid: jnp.ndarray,  # bool[b, Ls]
    *,
    n: int,
    cap: int,
    axis: str,
):
    """The all_to_all hash-routing round. Returns (tagv u32[b,Ls],
    payv u32[b,Ls], overflow count) — the same (tag, payload) stream the
    single-chip probe front-ends produce (step.TAG_* semantics)."""
    b, L = owner.shape
    Pn = b * L
    flat_owner = owner.reshape(Pn)
    flat_local = local_word.reshape(Pn).astype(jnp.uint32)
    flat_bit = bit_off.reshape(Pn).astype(jnp.uint32)
    flat_valid = win_valid.reshape(Pn)

    # sort probes by owner, keeping original position
    sort_key = flat_owner.astype(jnp.uint32) * jnp.uint32(Pn) + jax.lax.iota(
        jnp.uint32, Pn
    )
    sort_key = jnp.where(flat_valid, sort_key, jnp.uint32(n) * jnp.uint32(Pn))
    skey = jnp.sort(sort_key)
    s_owner = (skey // Pn).astype(jnp.int32)
    s_pos = (skey % Pn).astype(jnp.int32)
    s_valid = s_owner < n
    # within-owner slot: running index minus owner's first index
    idx = jax.lax.iota(jnp.int32, Pn)
    prev_owner = jnp.roll(s_owner, 1).at[0].set(-1)
    seg_start = s_valid & (s_owner != prev_owner)
    base = jax.lax.cummax(jnp.where(seg_start, idx, 0), axis=0)
    slot = idx - base
    ok = s_valid & (slot < cap)
    overflow = jnp.sum((s_valid & (slot >= cap)).astype(jnp.int32))

    # pack (local word, bit) per owner bucket in TWO uint32 lanes — a
    # single (word<<5)|bit lane would collide with the sentinel or wrap
    # once a shard covers >= 2^27 bloom words (wps*32 >= 2^32), silently
    # corrupting output in exactly the bigger-than-HBM regime this mode
    # targets. The word lane's sentinel is safe: local words are < wps,
    # and shard_index rejects wps > 2^31 - 1.
    g_local = jnp.take(flat_local, s_pos)
    g_bit = jnp.take(flat_bit, s_pos)
    g_valid = jnp.take(flat_valid, s_pos)
    send = jnp.full((n, cap, 2), MISS_SENTINEL, dtype=jnp.uint32)
    payload = jnp.stack(
        [
            jnp.where(ok & g_valid, g_local, MISS_SENTINEL),
            g_bit,
        ],
        axis=-1,
    )
    send = send.at[s_owner, slot].set(payload, mode="drop")

    # route to owners
    recv = jax.lax.all_to_all(send, axis, split_axis=0, concat_axis=0)
    recv = recv.reshape(n, cap, 2)

    # owner-side probe of the local shard: exactly the classic two-gather
    # probe (step.probe_tags semantics) against the shard's 8-byte rows
    r_valid = recv[..., 0] != MISS_SENTINEL
    r_word = jnp.where(r_valid, recv[..., 0], 0).astype(jnp.int32)
    r_bit = recv[..., 1] & 31  # keep shift amounts defined on empty slots
    rank, hit = probe_rank(dix_shard.bf_rank, r_word, r_bit, r_valid)
    pw = take_rows(dix_shard.pay, rank)  # [n, cap, 2]
    reply = jnp.where(hit[..., None], pw, jnp.uint32(0))

    # route the 8-byte (tag, payload) replies back
    back = jax.lax.all_to_all(reply, axis, split_axis=0, concat_axis=0)
    back = back.reshape(n, cap, 2)

    # scatter replies to original probe positions (zeros = miss, tag 0)
    flat_pw = jnp.zeros((Pn, 2), dtype=jnp.uint32)
    vals = back[s_owner, slot]  # [Pn, 2] (garbage where !ok)
    flat_pw = flat_pw.at[jnp.where(ok, s_pos, Pn)].set(
        jnp.where(ok[:, None], vals, 0), mode="drop"
    )
    pw2 = flat_pw.reshape(b, L, 2)
    tagv, payv = decode_pay_words(pw2[..., 0], pw2[..., 1])
    return tagv, payv, overflow


class ShardedBFClassifier:
    """Classify against an index sharded by Bloom address range across the
    mesh. The batch is data-parallel on the same axis."""

    def __init__(
        self,
        index: SharkIndex,
        max_winners: int = 16,
        c: float = 0.6,
        mesh: Mesh | None = None,
        n_devices: int = 0,
        slack: float | None = None,
        force_wide: bool = False,
    ):
        self.index = index
        self.max_winners = max_winners
        self.c = c
        self.mesh = mesh or make_mesh(n_devices)
        self.axis = self.mesh.axis_names[0]
        # sharding, all_to_all, and the shard count all live on axis 0; a
        # second non-trivial axis would split the shards 2-per-group and
        # silently answer probes from the wrong half — reject it
        for a in self.mesh.axis_names[1:]:
            if self.mesh.shape[a] != 1:
                raise ValueError(
                    "sharded-BF mode requires a single-axis mesh (axis "
                    f"{a!r} has size {self.mesh.shape[a]})"
                )
        self.n = int(self.mesh.shape[self.axis])
        # past the single-chip int32 front end the router switches to
        # (hi, lo) limb word addressing (shard_owner_local); force_wide
        # pins that path for equality testing at small sizes
        self.wide = force_wide or index.size_bits > MAX_SIZE_BITS
        self.slack = slack  # None = adaptive binomial-tail cap
        self.cap_mult = 1.0  # grown by reprobe() after an overflow
        bf_ranks, pays, self.wps, _ = shard_index(index, self.n)
        shard0 = NamedSharding(self.mesh, P(self.axis))
        repl = NamedSharding(self.mesh, P())
        self.dix = ShardIndexArrays(
            bf_rank=jax.device_put(bf_ranks, shard0),
            pay=jax.device_put(pays, shard0),
        )
        # replicated compacted deg>=3 row tables + deduped gene groups:
        # the home-chip finish is the SAME back-end as the single-chip
        # kernels (finish_from_tags), group fast path included
        self._has_rows = bool((np.diff(index.offsets) >= 3).any())
        rows3, ext_mat = (
            build_rows3(index)
            if self._has_rows
            else (np.zeros((1, 2), np.uint16), None)
        )
        self._rows3 = jax.device_put(rows3, repl)
        self._ext_mat = (
            jax.device_put(ext_mat, repl) if ext_mat is not None else None
        )
        gi = group_info(index)
        self.groups = gi[1] if gi is not None else None
        self._fns = {}
        self._thresh = {}

    def _probe_cap(self, b: int, L: int) -> int:
        """Per-owner routing bucket capacity for a per-device batch of b
        reads of padded length L. With `slack` set: the explicit
        `slack * P/n`. Default (adaptive): Binomial(P, 1/n) mean + 8 sigma
        + 64 — overflow odds ~1e-15/batch for i.i.d. XXH64 probes, and any
        duplicate-probe pathology is recovered by reprobe()'s geometric
        growth. Never exceeds b*L (all probes on one owner)."""
        total = b * L
        mean = total / self.n
        if self.slack is not None:
            cap = self.slack * mean
        else:
            cap = mean + 8.0 * mean**0.5 + 64.0
        cap = int(np.ceil(cap * self.cap_mult))
        return max(8, min(cap, total))

    def grow_cap(self) -> None:
        """Double every subsequent compile's routing cap (and drop the jit
        cache so the next call picks it up)."""
        self.cap_mult *= 2.0
        self._fns.clear()

    def reprobe(self, codes, attempts: int = 0):
        """Spill-and-retry after a routing overflow: re-run ONE batch with
        geometrically larger caps until its probes fit. `codes` is either
        a [B, L] uint8 code array or a (packed, vmask) planar pair. The
        grown cap sticks, so a workload that overflows once doesn't pay a
        recompile per batch. The default attempt count is enough doublings
        to saturate the cap at all-probes-on-one-owner, where overflow is
        impossible — so the returned result is overflow-free unless the
        caller passed a smaller `attempts`."""
        if isinstance(codes, tuple):
            B, L = codes[0].shape[0], codes[0].shape[1] * 4
        else:
            B, L = codes.shape
        if attempts <= 0:
            total = (B // self.n) * L
            cap0 = self._probe_cap(B // self.n, L)
            attempts = max(1, int(np.ceil(np.log2(total / cap0))) + 1)
        result = None
        for retry in range(attempts + 1):
            # first pass retries at the CURRENT cap: with ~8 batches in
            # flight, one overflow burst makes every queued batch call
            # reprobe(), and growing unconditionally would compound the
            # cap 2^8x (each doubling = a jit cache flush + a 10-15s
            # remote recompile) when the first growth already sufficed
            if retry > 0:
                self.grow_cap()
            result = (
                self.call_packed(*codes)
                if isinstance(codes, tuple)
                else self(codes)
            )
            if int(np.asarray(result[4]).sum()) == 0:
                break
        return result

    def _fn(self, B: int, L: int, packed: bool = False):
        key = (B, L, packed, self.cap_mult)
        fn = self._fns.get(key)
        if fn is not None:
            return fn
        meta = StaticMeta.for_index(self.index, L, allow_wide=True)
        n, wps, axis = self.n, self.wps, self.axis
        wide = self.wide
        has_rows = self._has_rows
        has_ext = self._ext_mat is not None
        b = B // n
        # routing sort keys are owner*Pn + slot in uint32 (sentinel n*Pn)
        pn = b * max(L - meta.k + 1, 1)
        if (n + 1) * pn >= (1 << 32):
            raise ValueError(
                f"per-device probe count {pn} x {n} shards exceeds 32-bit "
                "routing keys; reduce the per-device batch"
            )
        cap = self._probe_cap(b, L)
        max_winners = self.max_winners

        def step(dix_shard, thresh, rows3, *data):
            # shapes inside shard_map: codes [b, L]; dix_shard has the
            # leading shard axis reduced to 1 -> squeeze it; rows3/ext
            # arrive replicated (full arrays on every device)
            dix_local = ShardIndexArrays(
                bf_rank=dix_shard.bf_rank[0], pay=dix_shard.pay[0]
            )
            if has_ext:
                ext_mat, *data = data
            else:
                ext_mat = None
            if packed:
                codes = unpack_codes(*data)
            else:
                (codes,) = data
            idx_hi, idx_lo, win_valid = bloom_positions(codes, meta)
            owner, local_word, bit_off = shard_owner_local(
                idx_hi, idx_lo, n=n, wps=wps, wide=wide
            )
            tagv, payv, ovf = _route_probe_return(
                dix_local,
                owner,
                local_word,
                bit_off,
                win_valid,
                n=n,
                cap=cap,
                axis=axis,
            )
            length = jnp.sum((codes < INVALID).astype(jnp.int32), axis=1)
            out = finish_from_tags(
                tagv,
                payv,
                length,
                thresh,
                rows3=rows3,
                ext_mat=ext_mat,
                meta=meta,
                max_winners=max_winners,
                L=L,
                has_rows=has_rows,
            )
            return out + (ovf[None],)

        mesh = self.mesh
        data_specs = (P(self.axis), P(self.axis)) if packed else (P(self.axis),)
        ext_specs = (P(),) if has_ext else ()
        fn = jax.jit(
            jax.shard_map(
                step,
                mesh=mesh,
                in_specs=(
                    ShardIndexArrays(bf_rank=P(self.axis), pay=P(self.axis)),
                    P(),
                    P(),
                )
                + ext_specs
                + data_specs,
                out_specs=(
                    P(self.axis),
                    P(self.axis),
                    P(self.axis),
                    P(self.axis),
                    P(self.axis),
                ),
                check_vma=False,
            )
        )
        self._fns[key] = fn
        if L not in self._thresh:
            self._thresh[L] = jax.device_put(
                emit_threshold_table(self.c, L), NamedSharding(self.mesh, P())
            )
        return fn

    def _call(self, fn, L: int, *data):
        ext = (self._ext_mat,) if self._ext_mat is not None else ()
        return fn(self.dix, self._thresh[L], self._rows3, *ext, *data)

    def __call__(self, codes: np.ndarray):
        B, L = codes.shape
        if B % self.n != 0:
            raise ValueError(f"batch {B} not divisible by {self.n} devices")
        return self._call(self._fn(B, L), L, codes)

    def call_packed(self, packed: np.ndarray, vmask: np.ndarray):
        B = packed.shape[0]
        L = packed.shape[1] * 4
        if B % self.n != 0:
            raise ValueError(f"batch {B} not divisible by {self.n} devices")
        return self._call(self._fn(B, L, packed=True), L, packed, vmask)
