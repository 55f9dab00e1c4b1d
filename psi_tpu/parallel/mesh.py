"""Multi-chip scale-out: device mesh + sharded query pipeline.

The reference is single-process (SURVEY.md §2.3); this layer is the
framework's distribution backend built on jax.sharding:

  * axis "data"  — read/k-mer batches are data-parallel (the reference's
    thread-per-chunk design, ref: seed_finder.hpp:386-399, scaled out);
  * axis "shard" — index sharding for chr-scale occ tables (components
    partitioned across devices; queries routed, hits allgathered).

Index arrays are replicated for DP (pan-genome occ tables are small
relative to HBM); stats counters merge with psum-style reductions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from psi_tpu.ops.fm import FMArrays, backward_search_codes


def device_mesh(n_devices: Optional[int] = None, axes=("data",)) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    shape = (len(devs),) if len(axes) == 1 else None
    if shape is None:
        raise ValueError("only 1-D meshes supported for now")
    return Mesh(np.asarray(devs).reshape(shape), axes)


def replicate(mesh: Mesh, tree):
    """Place a pytree fully replicated on the mesh (multi-process
    safe: every process contributes its addressable replicas)."""
    from psi_tpu.parallel.distributed import put_global

    sharding = NamedSharding(mesh, P())
    return jax.tree.map(
        lambda x: put_global(np.asarray(x), sharding)
        if hasattr(x, "shape") else x,
        tree,
    )


def shard_batch(mesh: Mesh, arr: jax.Array, axis: str = "data") -> jax.Array:
    """Shard the leading dimension over the given mesh axis (padding to a
    multiple of the axis size)."""
    n = mesh.shape[axis]
    pad = (-arr.shape[0]) % n
    if pad:
        arr = jnp.concatenate([arr, jnp.zeros((pad,) + arr.shape[1:], arr.dtype)])
    return jax.device_put(arr, NamedSharding(mesh, P(axis)))


def sharded_backward_search(
    mesh: Mesh, arrays: FMArrays, codes: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Data-parallel batched FM search: queries sharded over "data",
    index replicated; XLA inserts no collectives on the forward path —
    hit ranges come back fully addressable (allgather on host fetch)."""
    n_queries = codes.shape[0]
    arrays_r = replicate(mesh, arrays)
    codes_d = shard_batch(mesh, jnp.asarray(codes))
    lo, hi = backward_search_codes(arrays_r, codes_d)
    return np.asarray(lo)[:n_queries], np.asarray(hi)[:n_queries]


def make_train_step(mesh: Mesh):
    """The framework's "training step" analogue: one fused sharded
    iteration of the query pipeline — batched backward search over the
    data axis plus a psum'd gocc-statistics reduction (the reference's
    atomic counters, ref: traverser_base.hpp:103-268, as collectives)."""

    @jax.jit
    def step(arrays: FMArrays, codes: jax.Array):
        lo, hi = backward_search_codes(arrays, codes)
        counts = hi - lo
        # global stats reduce (psum over the sharded batch axis happens
        # inside XLA's partitioner via the full-reduce below)
        total_occ = jnp.sum(counts)
        nonzero = jnp.sum((counts > 0).astype(jnp.int32))
        return counts, total_occ, nonzero

    return step


class ShardedPreparedTrie(NamedTuple):
    """Per-device trie plans, stacked on a leading shard axis and placed
    sharded over the mesh "data" axis (the multi-device analogue of
    fm_trie.PreparedTrie; built on the producer thread by
    SeedFinder.prepare_onpath when a mesh is active). Supports the same
    wire formats as the single-device plan, with the same default."""

    parents: jax.Array | None  # int32 [D, L, Npad] (plain format)
    chars: jax.Array | None
    poff: jax.Array | None     # uint16 [D, L, Npad] (packed format)
    pbase: jax.Array | None
    charpk: jax.Array | None
    lo0: jax.Array | None      # int32 [D, Npad]
    hi0: jax.Array | None
    leaf_perms: Tuple[np.ndarray, ...]
    sizes: Tuple[int, ...]
    per: int
    n: int
    # delta wire format (see fm_trie.PreparedTrie)
    delta: jax.Array | None = None      # uint8 [D, L, Npad]
    dmeta: jax.Array | None = None      # int32 [D, L, 8]
    dexc: jax.Array | None = None       # int32 [D, L, 2, E]
    row_delta: jax.Array | None = None  # uint8 [D, Npad]
    row_exc: jax.Array | None = None    # int32 [D, 2, E2]
    delta_bits: int = 8                 # 4 = nibble-packed delta wire


def prepare_trie_sharded(
    mesh: Mesh,
    keys: np.ndarray,
    k: int,
    n_text: int,
    ftab: Optional[np.ndarray] = None,
    wire: Optional[str] = None,
) -> ShardedPreparedTrie:
    """Split sorted distinct keys into contiguous per-device chunks
    (each stays sorted/pattern-orderable), build one trie plan per
    shard with a COMMON pad width and wire format, stack, and place
    sharded over the mesh. Thread-safe (producer thread).

    `wire` follows fm_trie.default_wire() (the single-device plan's
    default); shards that overflow the delta wire's fixed exception
    width force the whole plan back to packed so formats stay uniform
    across the stack."""
    from psi_tpu.ops import fm_trie
    from psi_tpu.ops.fm_trie import QTILE

    from psi_tpu.parallel.distributed import put_global

    if wire is None:
        wire = fm_trie.default_wire()
    if wire == "mask":
        # the mask wire's in-device select derive stays single-plan only
        wire = "packed"

    D = mesh.shape["data"]
    N = len(keys)
    per = -(-N // D)
    Npad = QTILE
    while Npad < per:
        Npad *= 2

    def chunks():
        for d in range(D):
            c = keys[d * per: (d + 1) * per]
            # empty shards (N < D) run a 1-key dummy plan; its results
            # are discarded by sizes[d] == 0
            yield (c if len(c) else keys[-1:]), len(c)

    def build_all(w):
        return [
            fm_trie.prepare(c, k, ftab, npad=Npad, to_device=False,
                            wire=w, pack=(None if w != "plain" else False))
            for c, _ in chunks()
        ]

    sizes = [sz for _, sz in chunks()]
    plans = build_all(wire)
    if wire == "delta" and any(p.delta is None for p in plans):
        # a shard overflowed the fixed delta-exception width and fell
        # back to packed: rebuild everything packed for a uniform stack
        wire = "packed"
        plans = build_all(wire)
    if wire == "delta" and len({p.delta_bits for p in plans}) > 1:
        # shards disagree on the 4-bit/8-bit adaptive choice: force the
        # byte form everywhere for a uniform stack
        wire = "delta8"
        plans = build_all(wire)
    if any(p.poff is None for p in plans) and any(
        p.poff is not None for p in plans
    ):
        # mixed packed/plain across shards: rebuild all plain
        wire = "plain"
        plans = build_all(wire)
    packed = plans[0].poff is not None
    delta = plans[0].delta is not None
    sharding = NamedSharding(mesh, P("data"))

    def stack(field):
        return put_global(
            np.stack([getattr(p, field) for p in plans]), sharding
        )

    lo0 = hi0 = None
    if plans[0].lo0 is not None:
        lo0 = stack("lo0")
        hi0 = stack("hi0")
    elif not (delta and plans[0].row_delta is not None):
        lo0 = put_global(
            np.zeros((D, Npad), dtype=np.int32), sharding
        )
        hi0 = put_global(
            np.full((D, Npad), n_text, dtype=np.int32), sharding
        )
    return ShardedPreparedTrie(
        parents=stack("parents") if plans[0].parents is not None else None,
        chars=stack("chars") if plans[0].chars is not None else None,
        poff=stack("poff") if packed else None,
        pbase=stack("pbase") if packed else None,
        charpk=stack("charpk") if packed else None,
        lo0=lo0,
        hi0=hi0,
        leaf_perms=tuple(p.leaf_perm for p in plans),
        sizes=tuple(sizes),
        per=per,
        n=N,
        delta=stack("delta") if delta else None,
        dmeta=stack("dmeta") if delta else None,
        dexc=stack("dexc") if delta else None,
        row_delta=(
            stack("row_delta")
            if delta and plans[0].row_delta is not None else None
        ),
        row_exc=(
            stack("row_exc")
            if delta and plans[0].row_exc is not None else None
        ),
        delta_bits=plans[0].delta_bits if delta else 8,
    )


def _sharded_trie_device(
    mesh: Mesh,
    arrays_r,
    prepared: ShardedPreparedTrie,
    ftab_tab: Optional[jax.Array] = None,
    with_counts: bool = False,
):
    """One shard_map dispatch of the trie level kernels over the
    per-device plans (any wire format). Returns sharded (lo, hi[,
    counts]) with leading shard axis; results stay DEVICE-RESIDENT for
    chaining."""
    from psi_tpu.ops import fm_trie

    packed = prepared.poff is not None
    delta = prepared.delta is not None

    if delta:
        args = [prepared.delta, prepared.dmeta, prepared.dexc]
        if prepared.row_delta is not None:
            args += [prepared.row_delta, prepared.row_exc]
        else:
            args += [prepared.lo0, prepared.hi0]

        def local(delta_d, dmeta_d, dexc_d, a4, a5):
            has_rows = prepared.row_delta is not None
            return fm_trie._trie_device(
                arrays_r, delta_d[0], dmeta_d[0],
                lo0=None if has_rows else a4[0],
                hi0=None if has_rows else a5[0],
                delta_wire=True, dexc=dexc_d[0],
                ftab_tab=ftab_tab if has_rows else None,
                row_delta=a4[0] if has_rows else None,
                row_exc=a5[0] if has_rows else None,
                with_counts=with_counts,
                delta_bits=prepared.delta_bits,
            )
    elif packed:
        args = [prepared.poff, prepared.pbase, prepared.charpk,
                prepared.lo0, prepared.hi0]

        def local(poff_d, pbase_d, charpk_d, lo0_d, hi0_d):
            return fm_trie._trie_device(
                arrays_r, poff_d[0], charpk_d[0],
                lo0=lo0_d[0], hi0=hi0_d[0], pbase=pbase_d[0], packed=True,
                with_counts=with_counts,
            )
    else:
        args = [prepared.parents, prepared.chars,
                prepared.lo0, prepared.hi0]

        def local(parents_d, chars_d, lo0_d, hi0_d):
            return fm_trie._trie_device(
                arrays_r, parents_d[0], chars_d[0],
                lo0=lo0_d[0], hi0=hi0_d[0],
                with_counts=with_counts,
            )

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data"),) * len(args),
        out_specs=P("data"),
        check_vma=False,
    )
    return fn(*args)


def sharded_trie_search(
    mesh: Mesh,
    stream_arrays,
    keys: np.ndarray,
    k: int,
    ftab: Optional[np.ndarray] = None,
    prepared: Optional[ShardedPreparedTrie] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Data-parallel trie-batched search (ops/fm_trie.py): sorted
    distinct keys split into contiguous per-device chunks (each stays
    sorted), per-shard host schedules (delta/packed/plain wire,
    optionally ftab-seeded) stacked and sharded over "data", index
    replicated; shard_map runs the frontier kernels per device.

    Returns (lo, hi) int32 [N] in key order. This IS the production
    on-path route when SeedFinder runs with a multi-device mesh
    (ref: src/psikt.cpp:183-209 chunk loop, scaled out per SURVEY §2.3).
    """
    if prepared is None:
        prepared = prepare_trie_sharded(
            mesh, keys, k, stream_arrays.n, ftab
        )
    D = mesh.shape["data"]
    N = prepared.n
    per = prepared.per
    arrays_r = replicate(mesh, stream_arrays)
    ftab_tab = None
    if prepared.row_delta is not None:
        ftab_tab = replicate(
            mesh, jnp.asarray(np.asarray(ftab, dtype=np.int32))
        )
    lo, hi = _sharded_trie_device(mesh, arrays_r, prepared, ftab_tab)
    if jax.process_count() > 1:
        # DCN-spanning mesh: gather every process's data-shard results
        from jax.experimental import multihost_utils

        lo = multihost_utils.process_allgather(lo, tiled=True)
        hi = multihost_utils.process_allgather(hi, tiled=True)
    Npad = np.asarray(lo).size // D
    lo = np.asarray(lo).reshape(D, Npad)
    hi = np.asarray(hi).reshape(D, Npad)
    out_lo = np.empty(N, dtype=np.int32)
    out_hi = np.empty(N, dtype=np.int32)
    for d in range(D):
        if prepared.sizes[d]:
            sl = slice(d * per, d * per + prepared.sizes[d])
            out_lo[sl] = lo[d][prepared.leaf_perms[d]]
            out_hi[sl] = hi[d][prepared.leaf_perms[d]]
    return out_lo, out_hi


def sharded_expand_locate(
    mesh: Mesh,
    sa_r: jax.Array,
    str_starts_r: jax.Array,
    lengths_r: jax.Array,
    seq_off_r: jax.Array,
    lo_d: jax.Array,
    hi_d: jax.Array,
    n_leaves: np.ndarray,
    thr: int,
    k: int,
    cap: int,
    local_only: bool = False,
):
    """The device-chained occurrence expansion + locate, per shard: each
    device expands its own DEVICE-RESIDENT (lo, hi) ranges against the
    replicated SA and downloads one int32 global position per hit
    (gpos-only download, the single-device chain's transfer profile).
    Returns np int32 [D, cap]; with `local_only` returns (gpos [D, cap]
    filled for addressable shards, local_ds bool [D]) and skips the
    cross-process allgather."""
    from psi_tpu.ops import fm_trie

    from psi_tpu.parallel.distributed import put_global

    D = mesh.shape["data"]
    nl = put_global(
        np.asarray(n_leaves, dtype=np.int32).reshape(D),
        NamedSharding(mesh, P("data")),
    )
    thr_a = jnp.asarray(thr, dtype=jnp.int32)

    def local(lo_l, hi_l, nl_l):
        # lo/hi arrive as the flat [D*Npad] stack's local [Npad] slice
        gpos, total = fm_trie._expand_locate_device(
            sa_r, str_starts_r, lengths_r, seq_off_r,
            lo_l, hi_l, nl_l[0], thr_a, k, cap,
        )
        return gpos[None]

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data"), P("data"), P("data")),
        out_specs=P("data"),
        check_vma=False,
    )
    gpos = fn(lo_d, hi_d, nl)
    if jax.process_count() > 1:
        if local_only:
            # process-sharded emission: fetch ONLY this process's
            # addressable shards; the caller joins/emits its key
            # slice and the merged hit stream is the concatenation of
            # the processes' disjoint streams
            out = np.zeros((D, cap), dtype=np.int32)
            local_ds = np.zeros(D, dtype=bool)
            for s in gpos.addressable_shards:
                d = s.index[0].start or 0
                out[d] = np.asarray(s.data)[0]
                local_ds[d] = True
            return out, local_ds
        from jax.experimental import multihost_utils

        gpos = multihost_utils.process_allgather(gpos, tiled=True)
    arr = np.asarray(gpos)
    if local_only:
        return arr, np.ones(D, dtype=bool)
    return arr


def sharded_traverse_dispatch(
    mesh: Mesh,
    graph_arrays,
    seeds_arrays,
    start_nodes: np.ndarray,
    start_offs: np.ndarray,
    k: int,
    cap_local: int,
    max_mm: int = 0,
):
    """Asynchronously dispatch the data-parallel off-path traversal:
    starting loci split into contiguous per-device chunks; every device
    runs the frontier traverser (ops/traverse.py) over its loci against
    the replicated graph + seed index. The per-locus fork trees are
    independent, so results concatenate exactly (HOT LOOP #2 scaled
    out, ref: traverser_bfs.hpp:72-164). Returns an opaque handle for
    sharded_traverse_collect — JAX dispatch is async, so the device
    work overlaps whatever the host does before collecting (the same
    overlap the single-device route gets from _traverse_dispatch)."""
    from psi_tpu.ops import traverse as trav

    from psi_tpu.parallel.distributed import put_global

    D = mesh.shape["data"]
    n = len(start_nodes)
    per = -(-n // D)
    per = max(per, 1)
    sn = np.zeros((D, cap_local), dtype=np.int32)
    so = np.zeros((D, cap_local), dtype=np.int32)
    ni = np.zeros(D, dtype=np.int32)
    for d in range(D):
        c = slice(d * per, min((d + 1) * per, n))
        m = max(c.stop - c.start, 0)
        ni[d] = m
        sn[d, :m] = start_nodes[c]
        so[d, :m] = start_offs[c]
    g_r = replicate(mesh, graph_arrays)
    sa_r = replicate(mesh, seeds_arrays)
    sharding = NamedSharding(mesh, P("data"))

    def local(sn_d, so_d, ni_d):
        if max_mm:
            li, lo, hi, nu, ov = trav.traverse_device_approx(
                g_r, sa_r, sn_d[0], so_d[0], ni_d[0], k, cap_local, max_mm
            )
            ts = jnp.zeros(3, dtype=jnp.int32)
        else:
            li, lo, hi, nu, ov, ts = trav.traverse_device(
                g_r, sa_r, sn_d[0], so_d[0], ni_d[0], k, cap_local
            )
        return (li[None], lo[None], hi[None], nu[None], ov[None],
                ts[None])

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data"), P("data"), P("data")),
        out_specs=(P("data"),) * 6,
        check_vma=False,
    )
    out = fn(
        put_global(sn, sharding), put_global(so, sharding),
        put_global(ni, sharding),
    )
    return (out, D, per)


def sharded_traverse_collect(pending, local_only: bool = False):
    """Fetch a sharded_traverse_dispatch result. Returns (locus_idx
    [global ids], lo, hi, n_used[D], overflow[D], tstats[D, 3],
    local_ds bool [D]) with per-shard arrays of width cap_local.

    With `local_only` on a multi-process mesh, the BULK survivor
    payloads (li/lo/hi) are fetched only for this process's addressable
    shards (local_ds marks them) — each process then emits only its
    loci shard's hits and the merged stream is the concatenation of
    disjoint per-process streams. The tiny control arrays (n_used,
    overflow, tstats) are still allgathered: the overflow retry must be
    a GLOBAL decision (the re-dispatch is collective) and the traversal
    stats stay globally consistent."""
    (li, lo, hi, nu, ov, ts), D, per = pending
    local_ds = np.ones(D, dtype=bool)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        if local_only:
            nu, ov, ts = (
                multihost_utils.process_allgather(a, tiled=True)
                for a in (nu, ov, ts)
            )

            def fetch_local(a):
                cap_l = a.shape[-1] if a.ndim > 1 else 1
                out = np.zeros((D,) + a.shape[1:], dtype=a.dtype)
                for s in a.addressable_shards:
                    d = s.index[0].start or 0
                    out[d] = np.asarray(s.data)[0]
                return out

            local_ds = np.zeros(D, dtype=bool)
            for s in li.addressable_shards:
                local_ds[s.index[0].start or 0] = True
            li, lo, hi = fetch_local(li), fetch_local(lo), fetch_local(hi)
        else:
            li, lo, hi, nu, ov, ts = (
                multihost_utils.process_allgather(a, tiled=True)
                for a in (li, lo, hi, nu, ov, ts)
            )
    li = np.asarray(li)
    # locus indices are shard-local: rebase to global locus ids
    li = li + (np.arange(D, dtype=np.int32) * per)[:, None]
    return (
        li, np.asarray(lo), np.asarray(hi),
        np.asarray(nu), np.asarray(ov), np.asarray(ts), local_ds,
    )


def sharded_traverse(
    mesh: Mesh,
    graph_arrays,
    seeds_arrays,
    start_nodes: np.ndarray,
    start_offs: np.ndarray,
    k: int,
    cap_local: int,
    max_mm: int = 0,
):
    """Synchronous dispatch + collect (see sharded_traverse_dispatch)."""
    return sharded_traverse_collect(sharded_traverse_dispatch(
        mesh, graph_arrays, seeds_arrays, start_nodes, start_offs,
        k, cap_local, max_mm,
    ))
