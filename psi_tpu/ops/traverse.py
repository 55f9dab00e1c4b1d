"""Crossing-seed graph traversal (seeds_off_paths engine).

HOT LOOP #2 of the reference (per-char trie descent x frontier,
ref: include/psi/traverser_bfs.hpp:72-164) inverted for a data-
parallel device (design delta per SURVEY.md §7.1.2): instead of walking one automaton
state at a time, a whole *frontier* of states advances in lockstep —
one graph character per step for every state — while the reads side is a
range (lo, hi) over the sorted packed seed array narrowed by per-depth
rank (see psi_tpu.records.SeedsIndex).

Semantics preserved exactly (one state per starting locus, forking per
out-edge at node ends, 'N' kills, death on failed descent, emission of
one hit per (state x matching seed) with gocc = match count).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from psi_tpu.graph import Graph, Position
from psi_tpu.records import SeedsIndex
from psi_tpu.seed import Seed

from psi_tpu.records import BLOCK


class GraphArrays(NamedTuple):
    """Device-resident graph: concatenated label codes + CSR adjacency."""

    labels: jax.Array       # int32 [total_loci] codes: 0..3 = ACGT, 4 = N
    label_offsets: jax.Array  # int32 [n+1]
    out_indptr: jax.Array   # int32 [n+1]
    out_indices: jax.Array  # int32 [m] (1-based node ids)
    max_out: int            # static max outdegree


def graph_to_device(graph: Graph) -> GraphArrays:
    from psi_tpu.ops.kmers import ACGT_CODE

    codes = ACGT_CODE[graph.labels].astype(np.int32)
    codes[codes < 0] = 4  # N and unknowns kill states
    outdeg = np.diff(graph.out_indptr)
    return GraphArrays(
        labels=jnp.asarray(codes),
        label_offsets=jnp.asarray(graph.label_offsets.astype(np.int32)),
        out_indptr=jnp.asarray(graph.out_indptr.astype(np.int32)),
        out_indices=jnp.asarray(graph.out_indices.astype(np.int32)),
        max_out=int(outdeg.max()) if len(outdeg) else 0,
    )


class WalkTree(NamedTuple):
    """Chunk-independent unpruned state tree from the starting loci.

    The device traversal's only read-dependent inputs are the per-depth
    (lo, hi) range refinements over the chunk's sorted seed keys; the
    graph walk itself (forks, labels, 'N' kills) is fixed per index. A
    WalkTree enumerates that walk ONCE (same frontier order as
    `traverse_device`: children consecutive per parent in out-edge
    order, structural compaction preserving order), so each chunk's
    off-path traversal reduces to vectorized `np.searchsorted` prefix
    probes — no seeds upload (the per-chunk planes payload), no device
    dispatch, and bit-identical survivors, order and TraverserStats
    (ref semantics: traverser_bfs.hpp:72-164 + traverser_base.hpp:103-268).
    """

    k: int
    n_init: int
    ccount0: np.ndarray        # int64 [n_init] child count of each locus state
    parent: tuple              # per depth: int32 [m_t] -> prev structural slot
    okn: tuple                 # per depth: bool [m_t] ('N'-free children)
    klo: tuple                 # per depth: uint64 [m_t] prefix range start
    ccount: tuple              # per depth: int64 [s_t] over structural survivors
    locus: np.ndarray          # int32 [s_{k-1}] locus of each complete walk
    n_nodes: int               # total tree nodes (diagnostics)


def enumerate_walks(
    graph: Graph,
    start_nodes: np.ndarray,
    start_offs: np.ndarray,
    k: int,
    node_cap: int = 1 << 23,
) -> WalkTree | None:
    """Host enumeration of the unpruned k-step state tree (see
    WalkTree). Returns None when the tree exceeds `node_cap` nodes
    (pathologically branchy regions: callers fall back to the pruned
    per-chunk device traversal)."""
    from psi_tpu.ops.kmers import ACGT_CODE

    codes = ACGT_CODE[graph.labels].astype(np.int64)
    codes[codes < 0] = 4
    loff = graph.label_offsets.astype(np.int64)
    iptr = graph.out_indptr.astype(np.int64)
    oidx = graph.out_indices.astype(np.int64)

    node = start_nodes.astype(np.int64)
    off = start_offs.astype(np.int64)
    n_init = len(node)
    locus = np.arange(n_init, dtype=np.int32)
    key = np.zeros(n_init, dtype=np.uint64)

    parents, okns, klos, ccounts = [], [], [], []
    ccount0 = None
    total = 0
    for t in range(k):
        nlen = loff[node] - loff[node - 1]
        at_end = off >= nlen
        outdeg = iptr[node] - iptr[node - 1]
        counts = np.where(at_end, outdeg, 1)
        if t == 0:
            ccount0 = counts.astype(np.int64)
        else:
            ccounts.append(counts.astype(np.int64))
        base = np.cumsum(counts) - counts
        m = int(counts.sum())
        total += m
        if total > node_cap:
            return None
        parent = np.repeat(
            np.arange(len(node), dtype=np.int64), counts
        )
        j = np.arange(m, dtype=np.int64) - base[parent]
        p_end = at_end[parent]
        nb = oidx[
            np.clip(iptr[node[parent] - 1] + j, 0, max(len(oidx) - 1, 0))
        ] if len(oidx) else np.zeros(m, dtype=np.int64)
        cnode = np.where(p_end, nb, node[parent])
        coff = np.where(p_end, 0, off[parent])
        c = codes[loff[np.maximum(cnode, 1) - 1] + coff]
        ok = c < 4
        ckey = (key[parent] << np.uint64(2)) | np.where(
            ok, c, 0
        ).astype(np.uint64)
        parents.append(parent.astype(np.int32))
        okns.append(ok)
        klos.append(ckey << np.uint64(2 * (k - t - 1)))
        # structural survivors advance
        node = cnode[ok]
        off = coff[ok] + 1
        locus = locus[parent[ok]]
        key = ckey[ok]
    return WalkTree(
        k=k, n_init=n_init, ccount0=ccount0,
        parent=tuple(parents), okn=tuple(okns), klo=tuple(klos),
        ccount=tuple(ccounts), locus=locus, n_nodes=total,
    )


def walks_match(tree: WalkTree, sorted_keys: np.ndarray):
    """Per-chunk evaluation of a WalkTree against the chunk's sorted
    seed keys: returns (locus_idx, lo, hi, gd, ended, ended_len) ==
    the surviving states and TraverserStats the pruned device
    traversal would produce for this chunk (uncapped)."""
    k = tree.k
    alive = np.ones(tree.n_init, dtype=bool)
    gd = ended = ended_len = 0
    lo_t = hi_t = None
    alive_child = np.zeros(0, dtype=bool)
    for t in range(k):
        ccount_prev = tree.ccount0 if t == 0 else tree.ccount[t - 1]
        attempted = int(ccount_prev[alive].sum())
        klo = tree.klo[t]
        width = np.uint64(1) << np.uint64(2 * (k - t - 1))
        lo_t = np.searchsorted(sorted_keys, klo, side="left")
        hi_t = np.searchsorted(sorted_keys, klo + width, side="left")
        alive_child = (
            tree.okn[t] & alive[tree.parent[t]] & (lo_t < hi_t)
        )
        survivors = int(alive_child.sum())
        gd += attempted
        ended += attempted - survivors
        ended_len += (attempted - survivors) * (t + 1)
        alive = alive_child[tree.okn[t]]
    emit = alive
    sel = tree.okn[k - 1]
    return (
        tree.locus[emit],
        lo_t[sel][emit].astype(np.int64),
        hi_t[sel][emit].astype(np.int64),
        gd, ended, ended_len,
    )


class SeedsArrays(NamedTuple):
    """Device-resident reads-side index (see SeedsIndex)."""

    occ: jax.Array     # int32 [k, nb+1, 4] rank checkpoints
    planes: jax.Array  # int32 [k, nb+1, 2] per-depth 2-bit plane words
    size: int          # V (static)


@jax.jit
def _occ_from_planes(planes: jax.Array) -> jax.Array:
    """Rank checkpoints derived ON DEVICE from the plane words (an
    exclusive cumsum of per-block popcounts): the occ table is 2x the
    plane payload, so deriving it saves 2/3 of the per-chunk seeds
    upload. Exact for every consulted row: occ[b] is only ever read
    for b <= V // BLOCK, and blocks before that are full (pad bits,
    which read as char 0, only affect rows past the last consulted one)."""
    p0 = planes[..., 0]
    p1 = planes[..., 1]
    outs = []
    for c in range(4):
        m = (p0 if c & 1 else ~p0) & (p1 if c >> 1 else ~p1)
        pc = jax.lax.population_count(m)
        csum = jnp.cumsum(pc, axis=1)
        outs.append(
            jnp.concatenate(
                [jnp.zeros_like(csum[:, :1]), csum[:, :-1]], axis=1
            )
        )
    return jnp.stack(outs, axis=-1).astype(jnp.int32)


def seeds_to_device(index: SeedsIndex) -> SeedsArrays:
    planes = jnp.asarray(index.planes)
    return SeedsArrays(
        occ=_occ_from_planes(planes),
        planes=planes,
        size=index.size,
    )


def _range_refine(seeds: SeedsArrays, depth, lo, hi, c):
    """Narrow [lo, hi) by char c at `depth` (vectorized over states).

    Rank = occ checkpoint + masked popcount over the block's two plane
    words (all int32; two's-complement masks are exact) — the same
    low-traffic layout as the on-path bit-plane rank, replacing the
    former [N, BLOCK, 4] one-hot materialization that dominated
    traversal time at scale.
    """
    occ_d = seeds.occ[depth]                      # [nb+1, 4]
    planes_d = seeds.planes[depth]                # [nb+1, 2]

    def counts_at(i):
        """#(chars_d[0:i) == c') for all 4 c' -> [N, 4]."""
        b = i // BLOCK
        base = occ_d[b]                           # [N, 4]
        pw = planes_d[b]                          # [N, 2]
        p0 = pw[:, 0]
        p1 = pw[:, 1]
        maskw = (1 << (i % BLOCK)) - 1
        outs = []
        for c4 in range(4):
            match = (p0 if c4 & 1 else ~p0) & (p1 if c4 >> 1 else ~p1)
            outs.append(jax.lax.population_count(match & maskw))
        return base + jnp.stack(outs, axis=1)

    c_lo = counts_at(lo)                          # [N, 4]
    c_hi = counts_at(hi)
    in_range = c_hi - c_lo                        # [N, 4] counts per char
    lt = jnp.cumsum(in_range, axis=1) - in_range  # counts of chars < c'
    pick = jnp.take_along_axis(lt, c[:, None], axis=1)[:, 0]
    cnt = jnp.take_along_axis(in_range, c[:, None], axis=1)[:, 0]
    new_lo = lo + pick
    return new_lo, new_lo + cnt


@functools.partial(jax.jit, static_argnames=("k", "cap"))
def traverse_device(
    g: GraphArrays,
    seeds: SeedsArrays,
    start_nodes: jax.Array,  # int32 [cap], zero-padded beyond n_init
    start_offs: jax.Array,   # int32 [cap]
    n_init: jax.Array,       # int32 scalar: number of seeded states
    k: int,
    cap: int,
):
    """Advance a frontier of states k characters over the graph.

    Gather-based frontier rebuild per step (no scatters): every state
    expands into `count` children (1 if mid-node, outdegree at a node
    end, 0 if dead), target slots come from an exclusive prefix sum, and
    the inverse slot->parent map is a searchsorted — compaction and
    forking in one pass. All live states then consume exactly one label
    character, so after k steps every survivor is a full k-length match.

    Returns (locus_idx, lo, hi, n_used, overflow, tstats); slots <
    n_used are the surviving matches. tstats = int32 [3]: go-down ops
    (attempted descents incl. failed, the reference's godown counter),
    ended-path count, summed ended-path lengths (ref TraverserStats,
    traverser_base.hpp:103-268; survivors count as length-k paths and
    are added by the caller).
    """
    slot = jnp.arange(cap, dtype=jnp.int32)
    locus_idx = slot
    node = start_nodes
    off = start_offs
    lo = jnp.zeros(cap, dtype=jnp.int32)
    hi = jnp.full(cap, seeds.size, dtype=jnp.int32)
    n_used = n_init.astype(jnp.int32)
    overflow = jnp.zeros((), dtype=jnp.bool_)
    tstats = jnp.zeros(3, dtype=jnp.int32)

    def step(t, state):
        locus_idx, node, off, lo, hi, n_used, overflow, tstats = state
        in_use = slot < n_used
        safe_node = jnp.maximum(node, 1)
        node_len = g.label_offsets[safe_node] - g.label_offsets[safe_node - 1]
        at_end = in_use & (off >= node_len)
        outdeg = g.out_indptr[safe_node] - g.out_indptr[safe_node - 1]

        counts = jnp.where(
            in_use, jnp.where(at_end, outdeg, 1), 0
        ).astype(jnp.int32)
        csum = jnp.cumsum(counts)
        base = csum - counts                     # exclusive prefix sum
        new_n = csum[-1]
        overflow_now = overflow | (new_n > cap)

        # inverse map: for each new slot, its parent state and child rank
        parent = (
            jnp.searchsorted(csum, slot, side="right").astype(jnp.int32)
        )
        parent_c = jnp.clip(parent, 0, cap - 1)
        j = slot - base[parent_c]
        valid = slot < new_n

        p_at_end = at_end[parent_c]
        p_node = jnp.maximum(node[parent_c], 1)
        nb = g.out_indices[
            jnp.clip(
                g.out_indptr[p_node - 1] + j, 0, g.out_indices.shape[0] - 1
            )
        ]
        new_node = jnp.where(p_at_end, nb, node[parent_c])
        new_off = jnp.where(p_at_end, 0, off[parent_c])
        new_locus = locus_idx[parent_c]
        new_lo0 = lo[parent_c]
        new_hi0 = hi[parent_c]

        # --- consume one character
        sn = jnp.maximum(new_node, 1)
        pos = jnp.clip(
            g.label_offsets[sn - 1] + new_off, 0, g.labels.shape[0] - 1
        )
        c = g.labels[pos]
        ok = valid & (c < 4)  # 'N' kills
        c4 = jnp.clip(c, 0, 3)
        r_lo, r_hi = _range_refine(seeds, t, new_lo0, new_hi0, c4)
        ok = ok & (r_lo < r_hi)

        # second compaction pass: drop killed states
        counts2 = ok.astype(jnp.int32)
        csum2 = jnp.cumsum(counts2)
        dst = csum2 - 1
        n2 = csum2[-1]
        # gather-from: for each slot s < n2, the s-th ok state
        src = jnp.searchsorted(csum2, slot + 1, side="left").astype(jnp.int32)
        src = jnp.clip(src, 0, cap - 1)

        locus_idx = new_locus[src]
        node = new_node[src]
        off = new_off[src] + 1
        lo = r_lo[src]
        hi = r_hi[src]
        attempted = jnp.minimum(new_n, cap)
        ended = attempted - n2
        tstats = tstats + jnp.stack(
            [attempted, ended, ended * (t + 1)]
        ).astype(jnp.int32)
        return locus_idx, node, off, lo, hi, n2, overflow_now, tstats

    locus_idx, node, off, lo, hi, n_used, overflow, tstats = (
        jax.lax.fori_loop(
            0, k, step,
            (locus_idx, node, off, lo, hi, n_used, overflow, tstats),
        )
    )
    return locus_idx, lo, hi, n_used, overflow, tstats


@functools.partial(jax.jit, static_argnames=("k", "cap", "max_mm"))
def traverse_device_packed(
    g: GraphArrays,
    seeds: SeedsArrays,
    start_nodes: jax.Array,
    start_offs: jax.Array,
    n_init: jax.Array,
    k: int,
    cap: int,
    max_mm: int = 0,
):
    """traverse_device with the outputs packed into ONE int32 vector
    [3*cap + 5] = (locus_idx | lo | hi | n_used, overflow, tstats[3]):
    a single dispatch + a single fetch instead of six round trips."""
    if max_mm:
        li, lo, hi, nu, ov = traverse_device_approx(
            g, seeds, start_nodes, start_offs, n_init, k, cap, max_mm
        )
        ts = jnp.zeros(3, dtype=jnp.int32)
    else:
        li, lo, hi, nu, ov, ts = traverse_device(
            g, seeds, start_nodes, start_offs, n_init, k, cap
        )
    tail = jnp.concatenate(
        [nu[None].astype(jnp.int32), ov[None].astype(jnp.int32), ts]
    )
    return jnp.concatenate([li, lo, hi, tail])


@functools.partial(jax.jit, static_argnames=("k", "cap", "max_mm"))
def traverse_device_approx(
    g: GraphArrays,
    seeds: SeedsArrays,
    start_nodes: jax.Array,
    start_offs: jax.Array,
    n_init: jax.Array,
    k: int,
    cap: int,
    max_mm: int,
):
    """Mismatch-tolerant frontier traversal.

    Same gather-compacted schedule as `traverse_device`, but the
    character-consumption phase forks each state into up to four
    children — one per substituted read character — decrementing a
    mismatch budget when the read character differs from the graph
    label. Each (walk, seed) pair is reached by exactly one leaf.

    Returns (locus_idx, lo, hi, n_used, overflow).
    """
    slot = jnp.arange(cap, dtype=jnp.int32)
    locus_idx = slot
    node = start_nodes
    off = start_offs
    lo = jnp.zeros(cap, dtype=jnp.int32)
    hi = jnp.full(cap, seeds.size, dtype=jnp.int32)
    budget = jnp.full(cap, max_mm, dtype=jnp.int32)
    n_used = n_init.astype(jnp.int32)
    overflow = jnp.zeros((), dtype=jnp.bool_)

    def step(t, state):
        locus_idx, node, off, lo, hi, budget, n_used, overflow = state
        in_use = slot < n_used
        safe_node = jnp.maximum(node, 1)
        node_len = g.label_offsets[safe_node] - g.label_offsets[safe_node - 1]
        at_end = in_use & (off >= node_len)
        outdeg = g.out_indptr[safe_node] - g.out_indptr[safe_node - 1]

        # phase 1: graph-edge fork/compaction (same as exact kernel)
        counts = jnp.where(in_use, jnp.where(at_end, outdeg, 1), 0).astype(
            jnp.int32
        )
        csum = jnp.cumsum(counts)
        base = csum - counts
        new_n = csum[-1]
        overflow = overflow | (new_n > cap)
        parent = jnp.searchsorted(csum, slot, side="right").astype(jnp.int32)
        parent_c = jnp.clip(parent, 0, cap - 1)
        j = slot - base[parent_c]
        valid = slot < new_n
        p_at_end = at_end[parent_c]
        p_node = jnp.maximum(node[parent_c], 1)
        nb = g.out_indices[
            jnp.clip(g.out_indptr[p_node - 1] + j, 0, g.out_indices.shape[0] - 1)
        ]
        node1 = jnp.where(p_at_end, nb, node[parent_c])
        off1 = jnp.where(p_at_end, 0, off[parent_c])
        locus1 = locus_idx[parent_c]
        lo1 = lo[parent_c]
        hi1 = hi[parent_c]
        bud1 = budget[parent_c]

        # phase 2: character fork — children per read character c'
        sn = jnp.maximum(node1, 1)
        pos = jnp.clip(g.label_offsets[sn - 1] + off1, 0, g.labels.shape[0] - 1)
        gc = g.labels[pos]
        alive1 = valid & (gc < 4)  # 'N' kills

        # refinement for all four characters
        los, his = [], []
        for cprime in range(4):
            cvec = jnp.full(cap, cprime, dtype=jnp.int32)
            rlo, rhi = _range_refine(seeds, t, lo1, hi1, cvec)
            los.append(rlo)
            his.append(rhi)
        los = jnp.stack(los, axis=1)   # [cap, 4]
        his = jnp.stack(his, axis=1)
        cost = (
            jnp.arange(4, dtype=jnp.int32)[None, :]
            != jnp.clip(gc, 0, 3)[:, None]
        ).astype(jnp.int32)
        child_ok = (
            alive1[:, None]
            & (los < his)
            & (bud1[:, None] - cost >= 0)
        )
        ccounts = jnp.sum(child_ok, axis=1).astype(jnp.int32)
        csum2 = jnp.cumsum(ccounts)
        base2 = csum2 - ccounts
        n2 = csum2[-1]
        overflow = overflow | (n2 > cap)

        parent2 = jnp.searchsorted(csum2, slot, side="right").astype(jnp.int32)
        parent2 = jnp.clip(parent2, 0, cap - 1)
        j2 = slot - base2[parent2]
        # j2-th valid char of parent2: rank-select over the 4-bit mask
        ok_row = child_ok[parent2]                      # [cap, 4]
        prefix = jnp.cumsum(ok_row, axis=1) - ok_row    # exclusive
        # char index where prefix == j2 and ok
        sel = jnp.argmax(
            (prefix == j2[:, None]) & ok_row, axis=1
        ).astype(jnp.int32)

        locus_idx = locus1[parent2]
        node = node1[parent2]
        off = off1[parent2] + 1
        lo = jnp.take_along_axis(los[parent2], sel[:, None], axis=1)[:, 0]
        hi = jnp.take_along_axis(his[parent2], sel[:, None], axis=1)[:, 0]
        budget = bud1[parent2] - jnp.take_along_axis(
            cost[parent2], sel[:, None], axis=1
        )[:, 0]
        return locus_idx, node, off, lo, hi, budget, n2, overflow

    locus_idx, node, off, lo, hi, budget, n_used, overflow = jax.lax.fori_loop(
        0, k, step, (locus_idx, node, off, lo, hi, budget, n_used, overflow)
    )
    return locus_idx, lo, hi, n_used, overflow


def traverse(
    graph: Graph,
    g: GraphArrays,
    seeds_arrays: SeedsArrays,
    index: SeedsIndex,
    loci: List[Position],
    k: int,
    cap: int = 1 << 15,
) -> List[Tuple[int, int, int, int, int]]:
    """Device traversal wrapper with overflow retry.

    Returns raw hits (node_id, node_offset, seed_id, gocc, match_len) as
    the host mirror does; ordering is by frontier slot (multiset-equal to
    the reference's emission order).
    """
    if not loci or index.size == 0 or g.max_out == 0:
        return []
    n = len(loci)
    while True:
        cap_eff = max(cap, 1 << (n - 1).bit_length())
        start_nodes = np.zeros(cap_eff, dtype=np.int32)
        start_offs = np.zeros(cap_eff, dtype=np.int32)
        for i, l in enumerate(loci):
            start_nodes[i] = l.node_id()
            start_offs[i] = l.offset()
        locus_idx, lo, hi, n_used, overflow, _tstats = traverse_device(
            g,
            seeds_arrays,
            jnp.asarray(start_nodes),
            jnp.asarray(start_offs),
            jnp.asarray(n, dtype=jnp.int32),
            k,
            cap_eff,
        )
        if bool(overflow):
            cap = cap_eff * 2
            continue
        locus_idx = np.asarray(locus_idx)
        lo = np.asarray(lo)
        hi = np.asarray(hi)
        n_used = int(n_used)
        break

    cols = traverse_columnar_from_states(
        index, loci, locus_idx[:n_used], lo[:n_used], hi[:n_used], k
    )
    return list(zip(*(c.tolist() for c in cols))) if len(cols[0]) else []


def traverse_columnar_from_states(index, loci, locus_idx, lo, hi, k):
    """Vectorized hit expansion: (node, off, seed_id, gocc, len) columns."""
    widths = (hi - lo).astype(np.int64)
    total = int(widths.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, z, z
    loci_nodes = np.array([l.node_id() for l in loci], dtype=np.int64)
    loci_offs = np.array([l.offset() for l in loci], dtype=np.int64)
    rep = np.repeat(np.arange(len(lo)), widths)
    within = np.arange(total) - np.repeat(np.cumsum(widths) - widths, widths)
    seed_sel = index.seed_ids[lo.astype(np.int64)[rep] + within]
    nodes = loci_nodes[locus_idx[rep]]
    offs = loci_offs[locus_idx[rep]]
    goccs = widths[rep]
    lens = np.full(total, k, dtype=np.int64)
    return nodes, offs, seed_sel, goccs, lens


def traverse_host(
    graph: Graph,
    index: SeedsIndex,
    loci: List[Position],
    k: int,
    max_mismatches: int = 0,
) -> List[Tuple[int, int, int, int, int]]:
    """Host mirror of the reference BFS traverser automaton
    (ref: traverser_bfs.hpp:72-164) over the SeedsIndex trie, extended
    with working mismatch-tolerant matching (the reference *declares*
    ApproxMatching, ref: traverser_base.hpp:98-101, but implements no
    approx traverser — here a state forks per substituted read character,
    consuming mismatch budget; each (walk, seed) pair is reached by
    exactly one leaf, so no duplicate hits arise).

    Returns raw hits (node_id, node_offset, seed_id, gocc, match_len);
    read mapping is applied by the caller. gocc of a hit is the match
    count of its leaf state (exact-matching: all equal seeds).
    """
    out = []
    # state: (start (nid, off), cur (nid, off), depth, lo, hi, budget)
    states = [
        (
            (l.node_id(), l.offset()),
            (l.node_id(), l.offset()),
            0,
            0,
            index.size,
            max_mismatches,
        )
        for l in loci
    ]
    labels = {}  # node -> codes

    def node_codes(nid):
        if nid not in labels:
            from psi_tpu.ops.kmers import ACGT_CODE

            c = ACGT_CODE[
                np.frombuffer(
                    graph.node_sequence(nid).encode("ascii"), dtype=np.uint8
                )
            ].astype(np.int32)
            c[c < 0] = 4
            labels[nid] = c
        return labels[nid]

    while states:
        next_states = []
        for (spos, (nid, off), depth, lo, hi, budget) in states:
            codes = node_codes(nid)
            # consume chars until node end / depth k / death / fork
            dead = False
            forked = False
            while depth < k and off < len(codes):
                c = int(codes[off])
                if c == 4:
                    dead = True
                    break
                if budget > 0:
                    # fork per read character; mismatches consume budget
                    for cprime in range(4):
                        nlo, nhi = index.go_down(lo, hi, depth, cprime)
                        if nlo >= nhi:
                            continue
                        nbudget = budget - (cprime != c)
                        if nbudget < 0:
                            continue
                        next_states.append(
                            (spos, (nid, off + 1), depth + 1, nlo, nhi, nbudget)
                        )
                    forked = True
                    break
                lo, hi = index.go_down(lo, hi, depth, c)
                if lo >= hi:
                    dead = True
                    break
                depth += 1
                off += 1
            if dead or forked:
                continue
            if depth == k:
                gocc = hi - lo
                for sid in index.occurrences(lo, hi):
                    out.append((spos[0], spos[1], int(sid), gocc, k))
                continue
            # node end with depth < k: fork per out-edge
            for nb in graph.out_neighbors(nid):
                next_states.append((spos, (int(nb), 0), depth, lo, hi, budget))
        states = next_states
    return out
