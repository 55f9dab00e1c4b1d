"""Batched FM-index queries on device (plain JAX, compiled by XLA).

This is HOT LOOP #1 of the engine (the reference's per-char
sdsl::backward_search, ref: include/psi/fmindex.hpp:851-869) recast as a
data-parallel kernel: one backward-search step for a whole batch of
k-mers is two `rank` evaluations per query — a checkpoint gather plus an
intra-block count over the BWT — executed for 10^4..10^6 queries at once.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from psi_tpu.fmindex import BLOCK, FMIndex, SIGMA


class FMArrays(NamedTuple):
    """Device-resident FM index.

    Three rank layouts:
      * checkpointed (compact): occ rows every BLOCK positions + BWT
        byte blocks for the intra-block count (~1.3 bytes/bp);
      * bit-plane: occ rows + 3 bit-planes of the BWT packed 32/word —
        intra-block count is XOR/AND + popcount over 12 words (~0.4
        bytes/bp of gather traffic per rank);
      * dense (fast on CPU): full per-position occ table — one gather
        per rank, no intra-block pass (16 bytes/bp).
    """

    bwt_blocks: jax.Array   # uint8 [nblocks+1, BLOCK] (padded with 255)
    occ: jax.Array          # int32 [nblocks+1, SIGMA]
    C: jax.Array            # int32 [SIGMA+1]
    sa: jax.Array           # int32 [n]
    n: int                  # text length (static)
    occ_dense: Optional[jax.Array] = None  # int32 [n+1, 4] (ACGT only)
    planes: Optional[jax.Array] = None     # uint32 [nblocks+1, 3, WORDS]
    ftab: Optional[jax.Array] = None       # int32 [4**p, 2] prefix SA ranges

WORDS = BLOCK // 32


def to_device(
    fm: FMIndex,
    dense_occ: bool = False,
    bitplanes: bool = False,
    ftab_bits: int = 0,
) -> FMArrays:
    n = fm.size
    nblocks = (n + BLOCK - 1) // BLOCK
    # one spare block: position n (range end) may index block nblocks
    bwt_pad = np.full((nblocks + 1) * BLOCK, 255, dtype=np.uint8)
    bwt_pad[:n] = fm.bwt
    occ_dense = None
    if dense_occ:
        dense = np.zeros((n + 1, 4), dtype=np.int32)
        for c in range(1, 5):  # ACGT codes
            dense[1:, c - 1] = np.cumsum(fm.bwt == c, dtype=np.int32)
    planes = None
    if bitplanes:
        # bit p of the symbol at block position i -> word i//32 bit i%32
        sym = bwt_pad.reshape(-1, BLOCK).astype(np.uint32)
        planes_np = np.zeros((nblocks + 1, 3, WORDS), dtype=np.uint32)
        weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))
        for p in range(3):
            bits = ((sym >> p) & 1).reshape(nblocks + 1, WORDS, 32)
            planes_np[:, p, :] = (bits * weights[None, None, :]).sum(
                axis=2, dtype=np.uint32
            )
        planes = jnp.asarray(planes_np)
    arrays = FMArrays(
        bwt_blocks=jnp.asarray(bwt_pad.reshape(nblocks + 1, BLOCK)),
        occ=jnp.asarray(fm.occ.astype(np.int32)),
        C=jnp.asarray(fm.C.astype(np.int32)),
        sa=jnp.asarray(fm.sa.astype(np.int32)),
        n=n,
        occ_dense=jnp.asarray(dense) if dense_occ else None,
        planes=planes,
    )
    if ftab_bits and n and fm.sigma == SIGMA:
        arrays = arrays._replace(ftab=jnp.asarray(build_ftab(fm, ftab_bits)))
    return arrays


def build_ftab(fm: FMIndex, p: int) -> np.ndarray:
    """SA ranges for every length-p ACGT prefix ("ftab": replaces the
    first p LF steps of every query with one table gather — the batched
    analogue of seeding backward search from a precomputed range).

    Built on host by level extension: ranges of length-(j+1) prefixes
    are one LF step from the length-j ranges, so the whole table costs
    ~4**p/3 rank pairs (searchsorted over per-symbol BWT position
    lists) instead of p*4**p, and no device compiles. Key layout
    matches keys_to_codes: first char is most significant, so
    key(x·c) = 4*key(x) + (c-1). Returns int32 [4**p, 2].
    """
    if not 1 <= p <= 14:
        raise ValueError(f"ftab depth {p} out of range (4**p rows)")
    C = fm.C.astype(np.int64)
    pos = [np.flatnonzero(fm.bwt == c) for c in range(1, 5)]
    lo = C[1:5].copy()
    hi = C[2:6].copy()
    for _ in range(p - 1):
        nl = np.empty(4 * lo.shape[0], dtype=np.int64)
        nh = np.empty_like(nl)
        for ci in range(4):
            # new index 4*i + ci <=> slice(ci, None, 4); rank(c, i) =
            # C-offset + #positions of c before i (monotone, so empty
            # ranges stay empty with no alive mask)
            nl[ci::4] = C[ci + 1] + np.searchsorted(pos[ci], lo)
            nh[ci::4] = C[ci + 1] + np.searchsorted(pos[ci], hi)
        lo, hi = nl, nh
    return np.stack([lo, hi], axis=1).astype(np.int32)


def _rank_bitplane(arrays: FMArrays, c: jax.Array, i: jax.Array) -> jax.Array:
    """Batched rank via bit-plane popcount. c,i int32 [N]."""
    b = i // BLOCK
    base = arrays.occ[b, c]
    pl_rows = arrays.planes[b]                     # [N, 3, WORDS] uint32
    cb = c.astype(jnp.uint32)
    planes0 = pl_rows[:, 0, :]
    planes1 = pl_rows[:, 1, :]
    planes2 = pl_rows[:, 2, :]
    bit0 = (cb & 1).astype(jnp.uint32)[:, None]
    bit1 = ((cb >> 1) & 1).astype(jnp.uint32)[:, None]
    bit2 = ((cb >> 2) & 1).astype(jnp.uint32)[:, None]
    w0 = jnp.where(bit0 == 1, planes0, ~planes0)
    w1 = jnp.where(bit1 == 1, planes1, ~planes1)
    w2 = jnp.where(bit2 == 1, planes2, ~planes2)
    match = w0 & w1 & w2                           # [N, WORDS]
    # prefix mask for position r = i % BLOCK
    r = (i % BLOCK).astype(jnp.uint32)
    widx = jnp.arange(WORDS, dtype=jnp.uint32)[None, :]
    full = (widx < (r[:, None] // 32)).astype(jnp.uint32) * jnp.uint32(
        0xFFFFFFFF
    )
    partial_bits = jnp.where(
        widx == (r[:, None] // 32),
        (jnp.uint32(1) << (r[:, None] % 32)) - jnp.uint32(1),
        jnp.uint32(0),
    )
    mask = full | partial_bits
    counts = jax.lax.population_count(match & mask)
    return base + jnp.sum(counts, axis=1).astype(jnp.int32)


def _rank(arrays: FMArrays, c: jax.Array, i: jax.Array) -> jax.Array:
    """Batched rank: # of symbol c in bwt[0:i]. c,i: int32 [N]."""
    b = i // BLOCK
    base = arrays.occ[b, c]
    block = arrays.bwt_blocks[b]                       # [N, BLOCK]
    within = jnp.arange(BLOCK, dtype=jnp.int32)[None, :] < (i % BLOCK)[:, None]
    hits = (block == c[:, None].astype(jnp.uint8)) & within
    return base + jnp.sum(hits, axis=1, dtype=jnp.int32)


@jax.jit
def backward_search_codes(
    arrays: FMArrays, codes: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """SA ranges for a batch of k-mers given as a code matrix.

    codes: int32 [N, k] with FM symbol codes (ACGT = 1..4), consumed in
    FORWARD character order — the convention for the reversed-text path
    index (ref: reversed path sequences, seed_finder.hpp:779;
    forward-order go_down per char, index_iter.hpp:838-841).

    Uses the dense occ table when present (one gather per rank),
    otherwise the checkpointed layout.

    Returns (lo, hi) int32 [N]; empty ranges have lo == hi (the
    common value is unspecified — it differs between the stepping and
    ftab routes; consumers must only use hi - lo and, when non-empty,
    lo).
    """
    n = arrays.n
    N = codes.shape[0]
    k = codes.shape[1]
    lo0 = jnp.zeros(N, dtype=jnp.int32)
    hi0 = jnp.full(N, n, dtype=jnp.int32)

    # ftab fast path: one gather covers the first p LF steps. Patterns
    # with a non-ACGT code in the first p chars resolve to an EMPTY
    # range (the engine never queries such patterns: seeds containing
    # N are excluded from matching, ref: sequence.hpp seeding / 'N'
    # kills in index_iter.hpp:838-841).
    rest = codes
    if arrays.ftab is not None:
        p = (arrays.ftab.shape[0].bit_length() - 1) // 2
        if 0 < p <= k:
            pref = codes[:, :p]
            ok = jnp.all((pref >= 1) & (pref <= 4), axis=1)
            weights = (
                jnp.uint32(1) << jnp.uint32(2 * (p - 1 - np.arange(p)))
            ).astype(jnp.int32)
            pk = jnp.sum((pref - 1) * weights[None, :], axis=1)
            start = arrays.ftab[jnp.clip(pk, 0, arrays.ftab.shape[0] - 1)]
            lo0 = jnp.where(ok, start[:, 0], 0)
            hi0 = jnp.where(ok, start[:, 1], 0)
            rest = codes[:, p:]

    if arrays.occ_dense is not None:
        def rank(c, i):
            return arrays.occ_dense[i, c - 1]
    elif arrays.planes is not None:
        def rank(c, i):
            return _rank_bitplane(arrays, c, i)
    else:
        def rank(c, i):
            return _rank(arrays, c, i)

    def step(state, c):
        # no liveness mask: an empty range stays empty under LF
        # (lo == hi -> rank(c, lo) == rank(c, hi)), and stepping
        # everything keeps the batch's positions MONOTONE for sorted
        # query keys — lo(p)/hi(p) are monotone in the pattern's
        # lexicographic order whether or not p occurs — which is what
        # lets the streaming (merge-order) rank kernel work.
        lo, hi = state
        new_lo = arrays.C[c] + rank(c, lo)
        new_hi = arrays.C[c] + rank(c, hi)
        return (new_lo, new_hi), None

    (lo, hi), _ = jax.lax.scan(step, (lo0, hi0), rest.T)
    return lo, hi


def _rank_fn(arrays: FMArrays):
    """Best available batched rank for this layout (dense/bitplane/
    checkpointed)."""
    if arrays.occ_dense is not None:
        return lambda c, i: arrays.occ_dense[i, c - 1]
    if arrays.planes is not None:
        return lambda c, i: _rank_bitplane(arrays, c, i)
    return lambda c, i: _rank(arrays, c, i)


@functools.partial(jax.jit, static_argnames=("k", "max_out"))
def find_mems_device(
    arrays: FMArrays,
    codes: jax.Array,     # int32 [N, L]: FM codes 1..4; 0 = 'N' or pad
    rlens: jax.Array,     # int32 [N] read lengths
    k: int,               # minimum MEM length
    thr: jax.Array,       # int32 gocc threshold (big value = unlimited)
    max_mem: jax.Array,   # int32 occurrence cap per read (big = unlimited)
    max_out: int,         # MEM record slots per read
):
    """Batched find_mems: every read runs the reference's MEM automaton
    (sliding start; descend per char; emit the range once plen >= k and
    count <= threshold; restart after a hit / mismatch / 'N';
    ref: include/psi/index_iter.hpp:854-906) — one lockstep device step
    per cursor position, so L steps cover the whole batch.

    Returns (out_lo, out_hi, out_start, out_plen int32 [N, max_out],
    nout int32 [N], overflow bool []). A read can emit at most
    ceil(L / (k+1)) + 1 MEMs; overflow reports max_out exhaustion.
    """
    N, L = codes.shape
    n = arrays.n
    rank = _rank_fn(arrays)
    jslots = jnp.arange(max_out, dtype=jnp.int32)[None, :]

    def step(t, state):
        (start, plen, lo, hi, nout, occ_tot, finished,
         out_lo, out_hi, out_start, out_plen, overflow) = state
        cursor = start + plen
        alive = ~finished & (cursor < rlens)
        count = hi - lo
        emit = alive & (plen >= k) & (count <= thr)
        slot_hit = emit[:, None] & (jslots == nout[:, None])
        out_lo = jnp.where(slot_hit, lo[:, None], out_lo)
        out_hi = jnp.where(slot_hit, hi[:, None], out_hi)
        out_start = jnp.where(slot_hit, start[:, None], out_start)
        out_plen = jnp.where(slot_hit, plen[:, None], out_plen)
        overflow = overflow | jnp.any(emit & (nout >= max_out))
        nout = nout + emit
        occ_tot = occ_tot + jnp.where(emit, count, 0)
        finished = finished | (emit & (occ_tot >= max_mem))

        ch = codes[jnp.arange(N), jnp.minimum(cursor, L - 1)]
        restart = alive & (emit | (ch == 0))
        c = jnp.clip(ch, 1, 4)
        nlo = arrays.C[c] + rank(c, lo)
        nhi = arrays.C[c] + rank(c, hi)
        fail = alive & ~restart & (nlo >= nhi)
        reset = restart | fail
        start = jnp.where(reset, cursor + 1, start)
        plen = jnp.where(
            reset, 0, jnp.where(alive, plen + 1, plen)
        )
        lo = jnp.where(reset, 0, jnp.where(alive, nlo, lo))
        hi = jnp.where(reset, n, jnp.where(alive, nhi, hi))
        return (start, plen, lo, hi, nout, occ_tot, finished,
                out_lo, out_hi, out_start, out_plen, overflow)

    z = jnp.zeros(N, dtype=jnp.int32)
    buf = jnp.zeros((N, max_out), dtype=jnp.int32)
    state = (
        z, z, z, jnp.full(N, n, dtype=jnp.int32), z, z,
        jnp.zeros(N, dtype=jnp.bool_),
        buf, buf, buf, buf, jnp.zeros((), dtype=jnp.bool_),
    )
    state = jax.lax.fori_loop(0, L, step, state)
    (start, plen, lo, hi, nout, occ_tot, finished,
     out_lo, out_hi, out_start, out_plen, overflow) = state
    return out_lo, out_hi, out_start, out_plen, nout, overflow


def keys_to_codes(keys: np.ndarray, k: int) -> np.ndarray:
    """Host: unpack uint64 keys to an int32 [N, k] FM-code matrix (1..4)."""
    shifts = (2 * (k - 1 - np.arange(k, dtype=np.uint64))).astype(np.uint64)
    return (((keys[:, None] >> shifts[None, :]) & np.uint64(3)) + 1).astype(
        np.int32
    )


@functools.partial(jax.jit, static_argnames=("max_width",))
def locate_ranges(
    arrays: FMArrays, lo: jax.Array, hi: jax.Array, max_width: int
) -> tuple[jax.Array, jax.Array]:
    """Gather text positions for SA ranges, padded to max_width per query.

    Returns (positions int32 [N, max_width], mask bool [N, max_width]).
    Dense-SA design: locate is a single gather (no LF walk).
    """
    widths = hi - lo
    j = jnp.arange(max_width, dtype=jnp.int32)[None, :]
    mask = j < widths[:, None]
    idx = jnp.clip(lo[:, None] + j, 0, arrays.sa.shape[0] - 1)
    pos = arrays.sa[idx]
    return pos, mask


def count_kmers_device(fm: FMIndex, keys: np.ndarray, k: int) -> np.ndarray:
    """Convenience host wrapper: counts for packed k-mers."""
    arrays = to_device(fm)
    lo, hi = backward_search_codes(arrays, jnp.asarray(keys_to_codes(keys, k)))
    return np.asarray(hi - lo)


# --- device-side locate + SA-position -> graph-locus mapping -----------------
#
# The batched equivalent of PathIndex::position_to_id/position_to_offset
# (ref: pathindex.hpp:360-416 incl. the Reversed-text end-position fixup)
# executed on device: SA gather, string-id binary search, forward-offset
# flip, and node rank/select (ref: path_interface.hpp:172-197) — so the
# whole on-path query (search + locate + map) stays on device between
# chunk boundaries; only (node_id, node_offset) columns come back.


class MapArrays(NamedTuple):
    """Device-resident SA-position -> (node_id, node_offset) mapping."""

    str_starts: jax.Array  # int32 [m+1] flat-text start of each string
    lengths: jax.Array     # int32 [m]   string lengths (no sentinel)
    seq_off: jax.Array     # int32 [m+1] forward global seq offset per path
    starts: jax.Array      # int32 [E]   global seq start per path-node entry
    ids: jax.Array         # int32 [E]   node id per entry
    base: jax.Array        # int32 [E]   head-offset base per entry


def map_to_device(fm: FMIndex, path_map: dict) -> MapArrays:
    return MapArrays(
        str_starts=jnp.asarray(fm.str_starts.astype(np.int32)),
        lengths=jnp.asarray(fm.lengths.astype(np.int32)),
        seq_off=jnp.asarray(path_map["seq_off"].astype(np.int32)),
        starts=jnp.asarray(path_map["starts"].astype(np.int32)),
        ids=jnp.asarray(path_map["ids"].astype(np.int32)),
        base=jnp.asarray(path_map["base"].astype(np.int32)),
    )


@functools.partial(jax.jit, static_argnames=("k",))
def locate_map_device(
    arrays: FMArrays, maps: MapArrays, sa_idx: jax.Array, k: int
) -> tuple[jax.Array, jax.Array]:
    """Map absolute SA indices to (node_id, node_offset) on device.

    sa_idx: int32 [T] (pad entries may repeat a valid index; the caller
    masks them out). k = match length used in the reversed-text
    end-position flip (ref: pathindex.hpp:378-387).
    """
    pos = arrays.sa[sa_idx]
    sid = jnp.searchsorted(maps.str_starts, pos, side="right") - 1
    q = pos - maps.str_starts[sid]
    fwd = maps.lengths[sid] - q - k
    gpos = maps.seq_off[sid] + fwd
    entry = jnp.searchsorted(maps.starts, gpos, side="right") - 1
    node_id = maps.ids[entry]
    node_off = gpos - maps.starts[entry] + maps.base[entry]
    return node_id, node_off
