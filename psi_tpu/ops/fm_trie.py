"""Trie-batched FM backward search: level extension over the distinct-
prefix frontier.

The batched equivalent of the reference's dual-iterator
kmer_exact_matches (ref: include/psi/index_iter.hpp:808-852), which
enumerates k-mers lexicographically and reuses the longest common
prefix between consecutive k-mers. Here the whole frontier of distinct
fed-prefixes advances one level at a time:

  level j state: SA ranges of the distinct length-j fed-prefixes,
  ordered by PATTERN (reversed-prefix) value. Backward search PREPENDS
  the fed char, so a child's pattern value is

      r_child = r_parent + (c - 1) * 4**j

  and assembling children c-major keeps the frontier pattern-sorted BY
  CONSTRUCTION (the parent slots of each char segment increase
  strictly, which the delta wire format relies on).

Per level the device ranks every child's known char at its parent's
lo and hi and adds C[c] (`_level`): two 32-byte row gathers per child
from the block-major payload, then a masked popcount. The levels run
inside one `lax.scan`, one XLA program per chunk.

The child schedule (which (parent, c) pairs exist among the queried
k-mers) depends only on the key set, so it is precomputed on host with
vectorized NumPy (or native/psi_trie.cpp) and shipped as per-level
index arrays; absent-in-text children simply carry empty ranges
forward.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from psi_tpu.fmindex import FMIndex

SBLOCK = 32        # text positions per rank checkpoint block
#: smallest frontier pad width; widths double from here so chunks of
#: varying distinct-key counts share a few compiled shapes
QTILE = 8192
PAYLOAD_ROWS = 16  # 6 occ + 3 plane words + pad


class StreamArrays(NamedTuple):
    """Device-resident rank payload of the path FM index."""

    #: int32 [nblocks, 8] block-major: occ(ACGT) at the 32-position
    #: block start, then one match word per char (bit i set iff
    #: bwt[blk*32+i] == c); a known-char rank reads 2 words of one
    #: 32-byte row (one memory sector)
    payload: jax.Array
    C: jax.Array         # int32 [SIGMA+1]
    n: int               # text length
    nblocks: int         # real blocks incl. the position-n spare


def payload_host(fm: FMIndex) -> np.ndarray:
    """Host-side checkpointed bit-plane payload [16, nblocks] int32:
    rows 0..5 = occ checkpoints per symbol at each 32-position block
    start, rows 6..8 = BWT bit-plane words. The layout of the native
    single-core reference (native/psi_fm.cpp)."""
    payload, _, _ = _payload_parts(fm)
    return payload


def _payload_parts(fm: FMIndex):
    n = fm.size
    nblocks = n // SBLOCK + 1  # block of position n always addressable
    payload = np.zeros((PAYLOAD_ROWS, nblocks), dtype=np.int32)
    bwt_pad = np.full(nblocks * SBLOCK, 255, dtype=np.uint8)
    bwt_pad[:n] = fm.bwt
    sym = bwt_pad.reshape(nblocks, SBLOCK)
    for c in range(6):
        counts = np.count_nonzero(sym == c, axis=1)
        payload[c, 1:nblocks] = np.cumsum(counts, dtype=np.int64)[
            : nblocks - 1
        ].astype(np.int32)
    # bit-plane words (pad symbol 255 -> plane bits 1,1,1, distinct from
    # real codes 0..5)
    weights = np.uint32(1) << np.arange(SBLOCK, dtype=np.uint32)
    symu = sym.astype(np.uint32)
    for p in range(3):
        words = (((symu >> p) & 1) * weights[None, :]).sum(
            axis=1, dtype=np.uint32
        )
        payload[6 + p, :] = words.view(np.int32)
    return payload, symu, weights


def build_stream_arrays(fm: FMIndex) -> StreamArrays:
    payload, symu, weights = _payload_parts(fm)
    nblocks = payload.shape[1]
    rows = np.empty((nblocks, 8), dtype=np.int32)
    rows[:, 0:4] = payload[1:5].T
    # pad symbol 255 never matches, so padded tails rank as zero
    for c in range(1, 5):
        rows[:, 3 + c] = (
            (symu == c).astype(np.uint32) * weights[None, :]
        ).sum(axis=1, dtype=np.uint32).view(np.int32)
    return StreamArrays(
        payload=jnp.asarray(rows),
        C=jnp.asarray(fm.C.astype(np.int32)),
        n=fm.size,
        nblocks=nblocks,
    )


class TrieSchedule(NamedTuple):
    """Host-precomputed per-level child schedules.

    Level j (1-based) has F_j distinct fed-prefixes in pattern order.
    parent[j][i] = slot of child i's parent in level j-1's frontier;
    char[j][i] = the fed char (1..4). Level 0 is the root [0, n).
    leaf_perm[i] = leaf slot of sorted-key i (key order -> pattern
    order of the full k-mers).
    """

    parents: Tuple[np.ndarray, ...]
    chars: Tuple[np.ndarray, ...]
    sizes: Tuple[int, ...]
    leaf_perm: np.ndarray
    k: int
    #: pattern-order prefix values of the frontier at `frontier_level`
    #: (ftab row indices); None when no frontier was requested
    frontier_rows: np.ndarray | None = None
    frontier_level: int = 0


def build_schedule(
    keys: np.ndarray, k: int, frontier_level: int = 0
) -> TrieSchedule:
    """keys: sorted distinct uint64 packed k-mers (c0 most significant,
    2-bit codes). Native pattern-order counting builder when available
    (sequential passes, cache-resident byte planes), else vectorized
    O(N log N)-per-level NumPy. `frontier_level` > 0 additionally
    returns that level's frontier prefix values (for ftab seeding)."""
    keys = np.asarray(keys, dtype=np.uint64)
    from psi_tpu import native

    nat = (
        native.trie_schedule(keys, k, frontier_level) if len(keys) else None
    )
    if nat is not None:
        parents, chars, leaf_perm, rows = nat
        return TrieSchedule(
            parents=parents,
            chars=chars,
            sizes=tuple(len(p) for p in parents),
            leaf_perm=leaf_perm.astype(np.int64),
            k=k,
            frontier_rows=rows,
            frontier_level=frontier_level if rows is not None else 0,
        )
    sched = _build_schedule_np(keys, k)
    if 0 < frontier_level < k:
        kpref, order = _frontier_at(keys, k, frontier_level)
        sched = sched._replace(
            frontier_rows=kpref[order].astype(np.int64),
            frontier_level=frontier_level,
        )
    return sched


def _build_schedule_np(keys: np.ndarray, k: int) -> TrieSchedule:
    """Pure-NumPy fallback (argsort per level)."""
    N = len(keys)
    parents: List[np.ndarray] = []
    chars: List[np.ndarray] = []
    sizes: List[int] = []
    # per level: distinct j-prefix values (key order) and their pattern
    # values r; frontier is ordered by r
    prev_kpref = np.zeros(1, dtype=np.uint64)   # level 0: root
    prev_order = np.zeros(1, dtype=np.int64)    # slots in r-order
    prev_r = np.zeros(1, dtype=np.uint64)
    for j in range(1, k + 1):
        kpref = keys >> np.uint64(2 * (k - j))
        # uniq of sorted values
        mask = np.empty(N, dtype=bool)
        mask[0] = True
        np.not_equal(kpref[1:], kpref[:-1], out=mask[1:])
        kpref = kpref[mask]
        F = len(kpref)
        pk = kpref >> np.uint64(2)
        c = (kpref & np.uint64(3)).astype(np.int32) + 1
        # parent slot: position of pk in prev frontier's r-order
        pos_in_keyorder = np.searchsorted(prev_kpref, pk)
        parent_slot = prev_order[pos_in_keyorder].astype(np.int64)
        r = prev_r[pos_in_keyorder] + (
            (c.astype(np.uint64) - np.uint64(1)) << np.uint64(2 * (j - 1))
        )
        order = np.argsort(r, kind="stable")
        inv = np.empty(F, dtype=np.int64)
        inv[order] = np.arange(F)
        parents.append(parent_slot[order].astype(np.int32))
        chars.append(c[order])
        sizes.append(F)
        prev_kpref = kpref
        prev_order = inv
        prev_r = r
    # leaf_perm: sorted-key i -> its slot in the last frontier
    leaf_perm = prev_order
    return TrieSchedule(
        parents=tuple(parents),
        chars=tuple(chars),
        sizes=tuple(sizes),
        leaf_perm=leaf_perm,
        k=k,
    )


def _pad_level(arr: np.ndarray, npad: int, fill) -> np.ndarray:
    out = np.full(npad, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


#: fixed delta-wire exception width: one compiled shape per Npad (a
#: data-dependent width would trigger a fresh 1-10 min remote XLA
#: compile whenever a chunk's >255-gap count crossed a pow-2 boundary);
#: `prepare` falls back to the packed wire when a level exceeds it
DELTA_EXC_WIDTH = 64


def _delta_saturate(d: np.ndarray, sat: int = 255):
    """Split non-negative int64 deltas into a uint8 array plus (idx,
    val) corrections for entries > `sat` (val = true - sat). The
    non-negativity is the strictly-increasing-parents-per-segment
    invariant the whole delta wire depends on — a violation must fail
    loudly (a bare assert would vanish under python -O and turn a
    schedule-builder bug into silent wrong search results)."""
    if not (d >= 0).all():
        raise ValueError(
            "delta wire: parent deltas must be non-negative within "
            "each char segment (schedule invariant violated)"
        )
    big = np.nonzero(d > sat)[0].astype(np.int64)
    val = (d[big] - sat).astype(np.int64)
    return np.minimum(d, sat).astype(np.uint8), big, val


def _pad_exc(idx: np.ndarray, val: np.ndarray, npad: int,
             width: int = DELTA_EXC_WIDTH) -> np.ndarray:
    """Pack scatter corrections as int32 [2, E] at the FIXED width E
    (one compiled shape per Npad); padding rows use idx=npad, dropped
    by the device's mode="drop" scatter. Callers must pre-check
    len(idx) <= E (prepare falls back to the packed wire otherwise)."""
    E = width
    if len(idx) > E:
        raise ValueError(
            f"delta-wire exception count {len(idx)} exceeds fixed "
            f"width {E}"
        )
    out = np.full((2, E), npad, dtype=np.int32)
    out[0, : len(idx)] = idx
    out[1] = 0
    out[1, : len(val)] = val
    return out


def _expand_slots(csum: jax.Array, w: jax.Array, cap: int) -> jax.Array:
    """Run-expansion slot ids: out[j] = i such that j falls in slot i's
    width-w[i] run (== searchsorted(csum, arange(cap), "right") on the
    live region j < csum[-1]; values past the end may differ — callers
    mask by `live` and clip).

    Default = "scatter": scatter slot ids at run starts + one cummax —
    run starts are distinct for w>0 slots, so a max-scatter plus an
    associative max-scan replaces searchsorted's ~20 dependent gather
    passes. PSI_EXPAND=search selects the searchsorted form. Read at
    trace time (A/B via subprocess env)."""
    import os

    if os.environ.get("PSI_EXPAND", "scatter") == "search":
        occ = jnp.arange(cap, dtype=jnp.int32)
        return jnp.searchsorted(csum, occ, side="right").astype(jnp.int32)
    starts = csum - w
    slot_ids = jnp.arange(w.shape[0], dtype=jnp.int32)
    z = jnp.zeros(cap, jnp.int32).at[
        jnp.where(w > 0, starts, cap)
    ].max(slot_ids + 1, mode="drop")
    return jax.lax.associative_scan(jnp.maximum, z) - 1


@functools.partial(jax.jit, static_argnames=("k", "cap"))
def _expand_locate_device(
    sa: jax.Array,          # int32 [n] dense suffix array
    str_starts: jax.Array,  # int32 [m+1]
    lengths: jax.Array,     # int32 [m]
    seq_off: jax.Array,     # int32 [m+1]
    lo: jax.Array,          # int32 [Npad] pattern-order ranges (device-resident)
    hi: jax.Array,
    n_leaves: jax.Array,    # int32 scalar: real slots are [0, n_leaves)
    thr: jax.Array,         # int32 scalar gocc threshold
    k: int,
    cap: int,
):
    """Occurrence expansion + locate + global-position mapping, fully on
    device, chained onto the trie search's device-resident lo/hi (no
    lo/hi round-trip, no sa_idx upload — the transfer levers of the
    sustained pipeline). Emits one int32 global sequence position per
    occurrence, in (pattern slot, SA rank) order; the host joins
    occurrences back to seeds from the counts alone (the expansion
    order is deterministic), so gpos is the ONLY per-hit download
    (4 B/hit vs 2x4 B for (node, offset) columns; the node map is one
    host searchsorted)."""
    counts = hi - lo
    valid = jnp.arange(lo.shape[0], dtype=jnp.int32) < n_leaves
    w = jnp.where(valid & (counts > 0) & (counts <= thr), counts, 0)
    csum = jnp.cumsum(w)
    total = csum[-1]
    occ = jnp.arange(cap, dtype=jnp.int32)
    slot = _expand_slots(csum, w, cap)
    slot_c = jnp.clip(slot, 0, w.shape[0] - 1)
    within = occ - (csum[slot_c] - w[slot_c])
    live = occ < total
    sa_idx = jnp.clip(lo[slot_c] + within, 0, sa.shape[0] - 1)
    pos = sa[sa_idx]
    sid = jnp.searchsorted(str_starts, pos, side="right") - 1
    q = pos - str_starts[sid]
    gpos = seq_off[sid] + (lengths[sid] - q - k)
    return jnp.where(live, gpos, -1), total


@jax.jit
def _pack24(gpos: jax.Array) -> jax.Array:
    """Pack int32 global positions into three uint8 byte-planes (texts
    < 2^24 - 1 chars): the gpos download drops from 4 to 3 B/hit and
    the host slices the planes to the exact hit count."""
    return jnp.stack([
        (gpos & 255).astype(jnp.uint8),
        ((gpos >> 8) & 255).astype(jnp.uint8),
        ((gpos >> 16) & 255).astype(jnp.uint8),
    ])


def _unpack24(planes: np.ndarray) -> np.ndarray:
    b = planes.astype(np.int64)
    return b[0] | (b[1] << 8) | (b[2] << 16)


@jax.jit
def _chain_pack_small(counts, total, trav=None):
    """One-fetch head of the eager chain: counts saturated to uint16
    (two per int32 word; a saturation flag triggers the rare full
    refetch), the expansion total, and optionally the off-path
    traversal's packed result — so a chunk pays ONE fetch round trip
    for everything except the gpos stream (which the host then slices
    to the exact total)."""
    c16 = jnp.minimum(counts, 65535)
    w = c16[0::2] | (c16[1::2] << 16)
    over = (jnp.max(counts) > 65535).astype(jnp.int32)
    head = jnp.concatenate(
        [w, jnp.stack([over, total.astype(jnp.int32)])]
    )
    if trav is not None:
        head = jnp.concatenate([head, trav])
    return head


@functools.partial(jax.jit, static_argnames=("k", "cap", "use24"))
def _chain_tail(sa, str_starts, lengths, seq_off, lo, hi, counts,
                n_leaves, thr, k, cap, use24, trav=None):
    """Expansion + locate + 24-bit pack + small-head pack in ONE jit
    (one dispatch instead of three). Returns
    (packed_head, gpos_stream) — two device handles, fetched by the
    caller in its two round trips."""
    gpos, total = _expand_locate_device(
        sa, str_starts, lengths, seq_off, lo, hi, n_leaves, thr, k, cap
    )
    stream = _pack24(gpos) if use24 else gpos
    return _chain_pack_small(counts, total, trav), stream


def _decode_counts16(words: np.ndarray, npad: int) -> np.ndarray:
    w = words.view(np.uint32)
    out = np.empty(npad, dtype=np.int64)
    out[0::2] = w & 0xFFFF
    out[1::2] = w >> 16
    return out


@functools.partial(
    jax.jit,
    static_argnames=(
        "packed", "with_counts", "masked", "delta_wire", "mask_derive",
        "delta_bits",
    ),
)
def _trie_device(
    arrays: StreamArrays,
    parents: jax.Array,   # int32 [levels, Npad]; packed: uint16 poff;
                          # masked: uint8 [levels, Npad//2] 4-bit masks
                          # delta_wire: uint8 [levels, Npad] gap deltas
    chars: jax.Array,     # int32 [levels, Npad]; packed: int32 charpk;
                          # masked: unused (pass parents again)
                          # delta_wire: int32 [levels, 8] dmeta
    lo0: jax.Array | None = None,   # optional ftab-seeded frontier
    hi0: jax.Array | None = None,
    pbase: jax.Array | None = None,  # packed: int32 [levels, Npad//PSLAB]
    packed: bool = False,
    with_counts: bool = False,  # also return hi - lo (counts-only fetch)
    masked: bool = False,       # mask wire format (in-device derive)
    ftab_tab: jax.Array | None = None,   # int32 [R, 2] device-resident ftab
    ftab_rows: jax.Array | None = None,  # int32 [Npad] frontier row ids
    delta_wire: bool = False,   # delta wire format (cumsum derive)
    dexc: jax.Array | None = None,       # int32 [levels, 2, E]
    row_delta: jax.Array | None = None,  # uint8 [Npad]
    row_exc: jax.Array | None = None,    # int32 [2, E2]
    mask_derive: str = "sort",  # mask wire select: "sort" | "search"
    delta_bits: int = 8,        # 4 = nibble-packed delta wire
):
    n = arrays.n
    half = masked or (delta_wire and delta_bits == 4)
    Npad = parents.shape[1] * (2 if half else 1)
    if ftab_tab is not None and row_delta is not None:
        # delta wire: the ASCENDING frontier-row set is reconstructed
        # by one cumsum (row[0] arrives as the idx-0 correction), then
        # put in pattern order by sorting on the digit-reversed values
        rd = row_delta.astype(jnp.int32)
        rd = rd.at[row_exc[0]].add(row_exc[1], mode="drop")
        v = jnp.cumsum(rd)
        fp_lvl = (int(ftab_tab.shape[0]).bit_length() - 1) // 2
        r = jnp.zeros_like(v)
        x = v
        for _ in range(fp_lvl):
            r = (r << 2) | (x & 3)
            x = x >> 2
        _, rows = jax.lax.sort((r, v), num_keys=1, is_stable=True)
        lo0 = ftab_tab[rows, 0]
        hi0 = ftab_tab[rows, 1]
    elif ftab_tab is not None and ftab_rows is not None:
        # seed the frontier by an on-device ftab gather: uploads one
        # int32 row-id array instead of the two lo0/hi0 arrays
        lo0 = ftab_tab[ftab_rows, 0]
        hi0 = ftab_tab[ftab_rows, 1]
    if lo0 is None:
        lo0 = jnp.zeros(Npad, dtype=jnp.int32)
    if hi0 is None:
        hi0 = jnp.full(Npad, n, dtype=jnp.int32)

    def unpack(xs):
        if delta_wire:
            # delta wire format: parent[t] = first_parent[seg(t)] +
            # cumsum(d)[t] - cumsum(d)[seg_start(t)]; char = seg + 1.
            # No select/searchsorted — the whole derive is one cumsum,
            # one small scatter-add and three broadcast compares.
            dl, meta, ex = xs
            if delta_bits == 4:
                # two children per byte: low nibble = even slot
                d32 = dl.astype(jnp.int32)
                d = jnp.stack([d32 & 15, d32 >> 4], axis=-1).reshape(-1)
            else:
                d = dl.astype(jnp.int32)
            d = d.at[ex[0]].add(ex[1], mode="drop")
            cs = jnp.cumsum(d)
            t = jnp.arange(Npad, dtype=jnp.int32)
            seg = (
                (t >= meta[1]).astype(jnp.int32)
                + (t >= meta[2]).astype(jnp.int32)
                + (t >= meta[3]).astype(jnp.int32)
            )
            csat = cs[jnp.clip(meta[:4], 0, Npad - 1)]

            def pick(tab):
                x = jnp.where(seg == 0, tab[0], tab[1])
                x = jnp.where(seg == 2, tab[2], x)
                return jnp.where(seg == 3, tab[3], x)

            return pick(meta[4:8]) + cs - pick(csat), seg + 1
        if masked:
            # mask wire format: schedule derived in-device from 4-bit
            # parent masks (bit c-1 set = parent has a c-child). Child
            # layout is c-major over pattern-ordered parents — exactly
            # the host schedule's frontier order — and padding clamps
            # to the last real child, matching _pad_level.
            (mp,) = xs
            m32 = mp.astype(jnp.int32)
            nib = jnp.stack([m32 & 15, m32 >> 4], axis=1).reshape(-1)
            bits = (
                nib[None, :] >> jnp.arange(4, dtype=jnp.int32)[:, None]
            ) & 1
            bflat = bits.reshape(-1)
            t = jnp.arange(Npad, dtype=jnp.int32)
            if mask_derive == "sort":
                # select of set bits via ONE stable int32 sort: set-bit
                # positions keep their iota, clear bits are pushed past
                # 4*Npad, so the ascending sort's first `total` entries
                # ARE the set-bit positions in order (one sort instead
                # of searchsorted's ~21 dependent gather passes)
                M4 = 4 * Npad
                key = jnp.arange(M4, dtype=jnp.int32) + (1 - bflat) * M4
                f_all = jax.lax.sort(key)[:Npad]
                total = jnp.sum(bflat)
                last = f_all[jnp.clip(total - 1, 0, Npad - 1)]
                f = jnp.where(t < total, f_all, last)
            else:
                cs = jnp.cumsum(bflat, dtype=jnp.int32)
                total = cs[-1]
                tq = jnp.minimum(t + 1, jnp.maximum(total, 1))
                f = jnp.searchsorted(cs, tq, side="left").astype(
                    jnp.int32
                )
            return f % Npad, f // Npad + 1
        if not packed:
            parent, c = xs
            return parent, c
        poff_l, pbase_l, charpk_l = xs
        parent = jnp.repeat(pbase_l, PSLAB) + poff_l.astype(jnp.int32)
        c = (
            (
                charpk_l[:, None]
                >> (2 * jnp.arange(16, dtype=jnp.int32))[None, :]
            )
            & 3
        ).reshape(-1) + 1
        return parent, c

    if delta_wire:
        xs = (parents, chars, dexc)   # (delta, dmeta, dexc)
    elif masked:
        xs = (parents,)
    elif packed:
        xs = (parents, pbase, chars)
    else:
        xs = (parents, chars)

    def level(state, xs):
        lo, hi = state
        parent, c = unpack(xs)
        return _level(arrays, lo, hi, parent, c), None

    (lo, hi), _ = jax.lax.scan(level, (lo0, hi0), xs)
    return (lo, hi, hi - lo) if with_counts else (lo, hi)


def _rank_known(payload: jax.Array, pos: jax.Array, c: jax.Array):
    """rank(c, pos) for per-element chars c in 1..4 over the
    block-major payload: occ word + popcount of the masked match word,
    both from the row of pos's block."""
    row = payload[pos // SBLOCK]                      # [N, 8] row gather
    cm1 = (c - 1)[:, None]
    occ = jnp.take_along_axis(row, cm1, axis=1)[:, 0]
    match = jnp.take_along_axis(row, cm1 + 4, axis=1)[:, 0]
    maskw = (1 << (pos % SBLOCK)) - 1
    return occ + jax.lax.population_count(match & maskw)


def _level(arrays: StreamArrays, lo, hi, parent, c):
    """One trie level: child i <- C[c_i] + rank(c_i, lo/hi[parent_i])."""
    Cc = arrays.C[c]
    return (
        Cc + _rank_known(arrays.payload, lo[parent], c),
        Cc + _rank_known(arrays.payload, hi[parent], c),
    )


def _frontier_at(keys: np.ndarray, k: int, p: int):
    """Level-p frontier of the key set: distinct p-prefixes and their
    pattern-order permutation (r = 2-bit digit reversal, matching
    build_schedule's r values)."""
    kpref = np.unique(keys >> np.uint64(2 * (k - p)))
    r = np.zeros(len(kpref), dtype=np.uint64)
    v = kpref.copy()
    for _ in range(p):
        r = (r << np.uint64(2)) | (v & np.uint64(3))
        v >>= np.uint64(2)
    order = np.argsort(r, kind="stable")
    return kpref, order


PSLAB = 1024  # parent-rebase slab (children per uint16-offset window)


def default_wire() -> str:
    """Schedule wire format shared by the single-device and sharded
    plans: PSI_TRIE_WIRE, else "packed"."""
    import os

    return os.environ.get("PSI_TRIE_WIRE") or "packed"


def _mask_derive() -> str:
    """Mask-wire select strategy (static jit arg): one stable sort
    (default) or the searchsorted form (PSI_MASK_DERIVE=search)."""
    import os

    return os.environ.get("PSI_MASK_DERIVE", "sort")


class PreparedTrie(NamedTuple):
    """Device-ready trie plan: padded per-level schedules (+ optional
    ftab-seeded frontier). Building this is the host-side critical-path
    cost of the on-path route, so `prepare` is designed to run on the
    producer thread, overlapped with device compute of the previous
    chunk (the dual-iterator prefix-reuse economics of the reference,
    ref: include/psi/index_iter.hpp:808-852, amortized off-path).

    Wire formats (chosen by `prepare`; the schedule is the on-path
    route's per-chunk host->device upload):
      * packed: chars as 2-bit codes 16/word (charpk) + parents as
        per-1024-slab rebased uint16 offsets over int32 slab bases
        (~4.4x smaller than int32 pairs); decodable with three vector
        ops on device;
      * plain: int32 parents/chars (fallback when some slab's parent
        span exceeds uint16 — only possible for extremely sparse child
        densities).

    NOTE the wire/variant env knobs (PSI_TRIE_WIRE, PSI_EXPAND,
    PSI_MASK_DERIVE, PSI_TRIE_PACK) are read at PREPARE/TRACE time:
    flipping one after the first in-process trace of a shape has no
    effect on that shape (A/B via subprocess env)."""

    parents: jax.Array | None  # int32 [levels, Npad] (plain format)
    chars: jax.Array | None    # int32 [levels, Npad] (plain format)
    poff: jax.Array | None     # uint16 [levels, Npad] (packed format)
    pbase: jax.Array | None    # int32 [levels, Npad // PSLAB]
    charpk: jax.Array | None   # int32 [levels, Npad // 16]
    lo0: jax.Array | None      # ftab-seeded level-p frontier
    hi0: jax.Array | None
    leaf_perm: np.ndarray
    n: int
    #: mask wire format: uint8 [levels, Npad//2] 4-bit parent masks
    #: (~0.5 B/child vs 6 B packed / 8 B plain; the schedule is derived
    #: in-device by a select — the smallest per-chunk upload)
    mask: jax.Array | None = None
    #: on-device ftab seeding: int32 [Npad] frontier row ids (replaces
    #: the lo0/hi0 upload when the ftab table is device-resident)
    ftab_rows: jax.Array | None = None
    #: delta wire format: uint8 [levels, Npad] per-child parent-gap
    #: deltas. Children are c-major with STRICTLY INCREASING parents
    #: per char segment, so parent[t] = first_parent[seg] +
    #: cumsum(delta)[t] - cumsum(delta)[seg_start]; the in-device
    #: derive is ONE cumsum + three compares per level (no
    #: searchsorted/select). 1 B/child vs 0.5 B mask.
    delta: jax.Array | None = None
    #: int32 [levels, 8]: per level seg_starts[4] (child slot where
    #: char segment c begins; Npad when empty) + first_parent[4]
    dmeta: jax.Array | None = None
    #: int32 [levels, 2, E]: (idx, val) scatter-add corrections for
    #: deltas that saturated uint8 (val = true_delta - 255); idx=Npad
    #: padding is dropped by the device scatter
    dexc: jax.Array | None = None
    #: uint8 [Npad] ftab frontier-row gap deltas (rows are strictly
    #: increasing; row[0] arrives as the idx-0 exception)
    row_delta: jax.Array | None = None
    #: int32 [2, E2] row-delta corrections (incl. the absolute row[0])
    row_exc: jax.Array | None = None
    #: 4 = nibble-packed deltas (uint8 [levels, Npad//2], two children
    #: per byte, gaps saturate at 15 with dexc corrections; chosen
    #: adaptively when every level's >15-gap count fits the scaled
    #: exception width — halves the dominant schedule upload), 8 = the
    #: byte form above
    delta_bits: int = 8


def prepare(
    keys: np.ndarray,
    k: int,
    ftab: np.ndarray | None = None,
    npad: int | None = None,
    to_device: bool = True,
    pack: bool | None = None,
    wire: str | None = None,
) -> PreparedTrie:
    """Host precompute for `trie_search`: schedule build + padding +
    device transfer. Thread-safe; call from a producer thread.

    `npad` forces a minimum pad width (the sharded route needs one
    common width across shards); `to_device=False` keeps the arrays as
    NumPy for the caller to stack/place (sharded route); `pack`
    overrides the PSI_TRIE_PACK env choice; `wire` picks the wire
    format explicitly: "packed" (the default, also for the sharded
    plan; its derive costs no device time) and "plain" ship the
    materialized schedules, "delta" uint8 parent-gap deltas (~1 B/
    child; in-device derive is ONE cumsum per level), "mask" 4-bit
    parent masks (~0.5 B/child, but the derive needs a select).
    PSI_TRIE_WIRE overrides the default."""
    import os

    if wire is None:
        wire = default_wire()
    p = 0
    if ftab is not None:
        p = (int(ftab.shape[0]).bit_length() - 1) // 2
        if not (0 < p < k):
            p = 0
    sched = build_schedule(keys, k, frontier_level=p)
    N = len(keys)
    # power-of-two padding: bounds the number of compiled shapes across
    # chunks of varying distinct-key counts
    Npad = max(QTILE, npad or 0)
    while Npad < N:
        Npad *= 2
    start = 0
    lo0 = hi0 = None
    put = jnp.asarray if to_device else np.asarray
    ftab_rows = None
    row_delta = row_exc = None
    if sched.frontier_level:
        start = p
        if wire == "mask":
            rows = sched.frontier_rows.astype(np.int32)
            ftab_rows = put(_pad_level(rows, Npad, int(rows[-1])))
        elif wire == "delta":
            # frontier rows arrive in PATTERN (digit-reversed) order;
            # deltas only work ascending, so ship the sorted row set
            # and recover the pattern permutation on device (digit
            # reverse + one sort). Padding = 4**p - 1: its reversed
            # digits are the maximum, so pads sort last and real rows
            # keep slots [0, n_frontier) (stable sort breaks the tie
            # with a real trailing all-T row in favor of the real one).
            rows = np.sort(sched.frontier_rows.astype(np.int64))
            rows_pad = _pad_level(rows, Npad, 4 ** p - 1)
            rd = np.zeros(Npad, dtype=np.int64)
            np.subtract(rows_pad[1:], rows_pad[:-1], out=rd[1:])
            d8, idx, val = _delta_saturate(rd)
            # absolute row[0] rides as the idx-0 exception
            idx = np.concatenate([[0], idx])
            val = np.concatenate([[int(rows_pad[0])], val])
            if len(idx) > DELTA_EXC_WIDTH:
                # too many saturated gaps for the fixed exception
                # width: the packed wire keeps one compiled shape
                return prepare(keys, k, ftab, npad=npad,
                               to_device=to_device, pack=pack,
                               wire="packed")
            row_delta = put(d8)
            row_exc = put(_pad_exc(idx, val, Npad))
        else:
            ranges = ftab[sched.frontier_rows]       # pattern order
            lo0 = put(_pad_level(
                ranges[:, 0].astype(np.int32), Npad, int(ranges[-1, 0])
            ))
            hi0 = put(_pad_level(
                ranges[:, 1].astype(np.int32), Npad, int(ranges[-1, 1])
            ))
    if wire in ("delta", "delta8"):
        levels = k - start
        dmeta = np.zeros((levels, 8), dtype=np.int32)
        dvals = []
        for jj in range(levels):
            p_arr = sched.parents[start + jj].astype(np.int64)
            c_arr = sched.chars[start + jj]
            p_pad = _pad_level(p_arr, Npad, max(int(p_arr[-1]), 0))
            c_pad = _pad_level(c_arr, Npad, int(c_arr[-1]))
            ss = np.searchsorted(c_pad, np.arange(1, 5, dtype=c_pad.dtype))
            d = np.zeros(Npad, dtype=np.int64)
            np.subtract(p_pad[1:], p_pad[:-1], out=d[1:])
            # parents increase strictly WITHIN a char segment; the
            # segment-boundary (possibly negative) deltas are zeroed
            # and the device restarts each segment at first_parent
            d[ss[ss < Npad]] = 0
            dvals.append(d)
            dmeta[jj, :4] = np.minimum(ss, Npad)
            dmeta[jj, 4:] = p_pad[np.minimum(ss, Npad - 1)]
        # 4-bit form when every level's >15-gap count fits the scaled
        # exception width (dense fills: ~1.4% of slots at the 2^19
        # sustained shape — halves the dominant per-chunk upload);
        # byte form otherwise (sparse fills where 4-bit exceptions
        # would dwarf the nibble savings). Width scales with Npad so
        # shards of one mesh plan agree by construction.
        E4 = max(DELTA_EXC_WIDTH, Npad // 64)
        bits = 4
        if wire == "delta8" or os.environ.get("PSI_DELTA_BITS") == "8":
            bits = 8
        else:
            for d in dvals:
                if int((d > 15).sum()) > E4:
                    bits = 8
                    break
        if bits == 4:
            delta = np.zeros((levels, Npad // 2), dtype=np.uint8)
            excs = []
            for jj, d in enumerate(dvals):
                d4, idx, val = _delta_saturate(d, sat=15)
                delta[jj] = d4[0::2] | (d4[1::2] << np.uint8(4))
                excs.append((idx, val))
            dexc = np.stack([_pad_exc(i, v, Npad, width=E4)
                             for i, v in excs])
        else:
            delta = np.zeros((levels, Npad), dtype=np.uint8)
            excs = []
            for jj, d in enumerate(dvals):
                d8, idx, val = _delta_saturate(d)
                delta[jj] = d8
                excs.append((idx, val))
            if max(len(i) for i, _ in excs) > DELTA_EXC_WIDTH:
                # a level's >255-gap count exceeds the fixed exception
                # width (extremely sparse child density): the packed
                # wire keeps one compiled shape instead of resizing
                return prepare(keys, k, ftab, npad=npad,
                               to_device=to_device, pack=pack,
                               wire="packed")
            dexc = np.stack([_pad_exc(i, v, Npad) for i, v in excs])
        return PreparedTrie(
            parents=None, chars=None, poff=None, pbase=None, charpk=None,
            lo0=lo0, hi0=hi0,
            leaf_perm=sched.leaf_perm, n=N,
            delta=put(delta), dmeta=put(dmeta), dexc=put(dexc),
            row_delta=row_delta, row_exc=row_exc, delta_bits=bits,
        )
    if wire == "mask":
        levels = k - start
        mask = np.zeros((levels, Npad), dtype=np.uint8)
        for jj in range(levels):
            p_arr = sched.parents[start + jj]
            c_arr = sched.chars[start + jj]
            np.bitwise_or.at(
                mask[jj], p_arr,
                (np.uint8(1) << (c_arr - 1).astype(np.uint8)),
            )
        mask_packed = mask[:, 0::2] | (mask[:, 1::2] << np.uint8(4))
        return PreparedTrie(
            parents=None, chars=None, poff=None, pbase=None, charpk=None,
            lo0=lo0, hi0=hi0,
            leaf_perm=sched.leaf_perm, n=N,
            mask=put(mask_packed), ftab_rows=ftab_rows,
        )
    parents = np.stack(
        [_pad_level(q, Npad, max(int(q[-1]), 0))
         for q in sched.parents[start:]]
    )
    chars = np.stack(
        [_pad_level(c, Npad, int(c[-1])) for c in sched.chars[start:]]
    )

    # packed wire format (4.4x less upload): per-slab parent rebase +
    # 2-bit char codes, unless some slab spans > uint16 parents
    import os

    if pack is None:
        pack = os.environ.get("PSI_TRIE_PACK", "1") not in ("", "0")
    if pack:
        levels = parents.shape[0]
        pslab = parents.reshape(levels, Npad // PSLAB, PSLAB)
        pbase = pslab.min(axis=2)
        off = pslab - pbase[:, :, None]
        if off.max(initial=0) <= np.iinfo(np.uint16).max:
            cpk = (chars - 1).reshape(levels, Npad // 16, 16)
            shifts = (2 * np.arange(16, dtype=np.int64))[None, None, :]
            charpk = (
                (cpk.astype(np.int64) << shifts).sum(axis=2).astype(np.uint32)
            ).view(np.int32)
            return PreparedTrie(
                parents=None,
                chars=None,
                poff=put(off.reshape(levels, Npad).astype(np.uint16)),
                pbase=put(pbase.astype(np.int32)),
                charpk=put(charpk),
                lo0=lo0,
                hi0=hi0,
                leaf_perm=sched.leaf_perm,
                n=N,
            )
    return PreparedTrie(
        parents=put(parents),
        chars=put(chars),
        poff=None,
        pbase=None,
        charpk=None,
        lo0=lo0,
        hi0=hi0,
        leaf_perm=sched.leaf_perm,
        n=N,
    )


def needs_ftab_table(prepared: PreparedTrie) -> bool:
    """Whether the plan seeds its frontier from a device-resident ftab
    (mask/delta wires ship row ids instead of lo0/hi0)."""
    return (prepared.mask is not None and prepared.ftab_rows is not None) or (
        prepared.delta is not None and prepared.row_delta is not None
    )


def run_prepared(
    arrays: StreamArrays,
    prepared: PreparedTrie,
    ftab_tab: jax.Array | None = None,
    with_counts: bool = False,
):
    """Dispatch `_trie_device` on a single-device plan of any wire
    format. Results stay device-resident, in pattern (leaf slot) order.
    `ftab_tab` is the int32 device ftab when needs_ftab_table()."""
    masked = prepared.mask is not None
    delta_wire = prepared.delta is not None
    packed = prepared.poff is not None
    sched_arr = (
        prepared.delta if delta_wire
        else prepared.mask if masked
        else prepared.poff if packed else prepared.parents
    )
    chars_arr = (
        prepared.dmeta if delta_wire
        else prepared.mask if masked
        else prepared.charpk if packed else prepared.chars
    )
    return _trie_device(
        arrays,
        sched_arr,
        chars_arr,
        lo0=prepared.lo0,
        hi0=prepared.hi0,
        pbase=prepared.pbase,
        packed=packed,
        masked=masked,
        ftab_tab=ftab_tab if needs_ftab_table(prepared) else None,
        ftab_rows=prepared.ftab_rows,
        delta_wire=delta_wire,
        dexc=prepared.dexc,
        row_delta=prepared.row_delta,
        row_exc=prepared.row_exc,
        mask_derive=_mask_derive(),
        with_counts=with_counts,
        delta_bits=prepared.delta_bits,
    )


def trie_search(
    arrays: StreamArrays,
    keys: np.ndarray,
    k: int,
    ftab: np.ndarray | None = None,
    prepared: PreparedTrie | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """SA ranges for sorted distinct packed keys, via frontier level
    extension. Returns (lo, hi) int32 [N] in key order (empty ranges
    have lo == hi at an unspecified value).

    With `ftab` (int32 [4**p, 2] from fm.build_ftab), the level-p
    frontier is seeded by a host table lookup and the device runs only
    levels p+1..k. Pass `prepared` (from `prepare`) to skip the host
    schedule build entirely."""
    if prepared is None:
        prepared = prepare(keys, k, ftab)
    ftab_tab = None
    if needs_ftab_table(prepared):
        ftab_tab = jnp.asarray(np.asarray(ftab, dtype=np.int32))
    lo, hi = run_prepared(arrays, prepared, ftab_tab)
    lo = np.asarray(lo)[prepared.leaf_perm]
    hi = np.asarray(hi)[prepared.leaf_perm]
    return lo, hi
