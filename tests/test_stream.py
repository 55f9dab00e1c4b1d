"""Trie-batched on-path route (ops/fm_trie.py): parity tests."""

import numpy as np
import pytest

import jax.numpy as jnp

from psi_tpu.fmindex import FMIndex
from psi_tpu.ops import fm as fm_ops
from psi_tpu.ops import fm_trie


def test_seed_finder_stream_route_matches_default(monkeypatch, tmp_path):
    """PSI_STREAM=1 on-path route (ftab seed + trie levels) emits the
    identical hit multiset."""
    from psi_tpu.graph import Graph
    from psi_tpu.records import Records
    from psi_tpu.seed_finder import SeedFinder

    rng = np.random.RandomState(5)
    seq = "".join(rng.choice(list("ACGT"), size=400))
    g = Graph.from_parts(
        nodes={1: seq}, edges=[], paths=[("ref", [1])]
    )

    def run(stream):
        if stream:
            monkeypatch.setenv("PSI_STREAM", "1")
        else:
            monkeypatch.delenv("PSI_STREAM", raising=False)
        finder = SeedFinder(g, seed_len=12)
        finder.create_path_index(n=1, patched=False)
        reads = Records(
            ["r0", "r1"], [seq[37: 37 + 48], seq[200: 200 + 48]]
        )
        seeds = finder.get_seeds(reads)
        index = finder.index_reads(seeds)
        hits = []
        finder.seeds_on_paths(seeds, index, hits.append)
        return sorted(
            (s.node_id, s.node_offset, s.read_id, s.read_offset, s.gocc)
            for s in hits
        )

    default = run(False)
    stream = run(True)
    assert len(default) > 0
    assert default == stream


def test_seed_finder_prepare_onpath_matches(monkeypatch):
    """prepare_onpath (producer-thread precompute) yields the identical
    hit multiset to the unprepared stream route."""
    from psi_tpu.graph import Graph
    from psi_tpu.records import Records
    from psi_tpu.seed_finder import SeedFinder

    rng = np.random.RandomState(11)
    seq = "".join(rng.choice(list("ACGT"), size=600))
    g = Graph.from_parts(nodes={1: seq}, edges=[], paths=[("ref", [1])])
    monkeypatch.setenv("PSI_STREAM", "1")

    def run(prep):
        finder = SeedFinder(g, seed_len=12)
        finder.create_path_index(n=1, patched=False)
        reads = Records(
            ["r0", "r1", "r2"],
            [seq[3: 3 + 60], seq[250: 250 + 60], seq[500: 500 + 60]],
        )
        seeds = finder.get_seeds(reads)
        index = finder.index_reads(seeds)
        if prep:
            finder.prepare_onpath(index)
            assert getattr(index, "_onpath_prep", None) is not None
        hits = []
        finder.seeds_on_paths(seeds, index, hits.append)
        return sorted(
            (s.node_id, s.node_offset, s.read_id, s.read_offset, s.gocc)
            for s in hits
        )

    plain = run(False)
    prepared = run(True)
    assert len(plain) > 0
    assert plain == prepared


@pytest.mark.parametrize("wire", ["packed", "mask", "delta"])
def test_trie_search_matches_generic(wire):
    """Frontier level extension vs the per-query scan, on a text large
    enough that frontier positions span many payload blocks, for each
    wire format with and without the ftab-seeded frontier."""

    rng = np.random.RandomState(17)
    s = "".join(rng.choice(list("ACGT"), size=120_000))
    fm = FMIndex.build_from_strings([s[::-1]])
    arr = fm_trie.build_stream_arrays(fm)
    dense = fm_ops.to_device(fm, dense_occ=True)

    k = 13
    lut = {c: i for i, c in enumerate("ACGT")}
    pres = []
    for start in range(0, len(s) - k, 53):
        v = 0
        for ch in s[start: start + k]:
            v = v * 4 + lut[ch]
        pres.append(v)
    keys = np.unique(np.concatenate([
        rng.randint(0, 4 ** k, size=2000).astype(np.uint64),
        np.asarray(pres, dtype=np.uint64),
    ]))

    codes = fm_ops.keys_to_codes(keys, k)
    l1, h1 = fm_ops.backward_search_codes(dense, jnp.asarray(codes))
    w1 = np.asarray(h1) - np.asarray(l1)

    ftab = fm_ops.build_ftab(fm, 5)
    for ft in (None, ftab):
        prep = fm_trie.prepare(keys, k, ft, wire=wire)
        lo2, hi2 = fm_trie.trie_search(arr, keys, k, ftab=ft, prepared=prep)
        np.testing.assert_array_equal(w1, hi2 - lo2)
        nz = w1 > 0
        assert nz.any()
        np.testing.assert_array_equal(np.asarray(l1)[nz], lo2[nz])


def test_trie_search_mask_search_derive(monkeypatch):
    """PSI_MASK_DERIVE=search (the searchsorted select, no longer the
    default) stays exact; mask_derive is a static jit arg so flipping
    the env between calls retraces."""
    rng = np.random.RandomState(29)
    s = "".join(rng.choice(list("ACGT"), size=50_000))
    fm = FMIndex.build_from_strings([s[::-1]])
    arr = fm_trie.build_stream_arrays(fm)
    dense = fm_ops.to_device(fm, dense_occ=True)
    k = 12
    keys = np.unique(rng.randint(0, 4 ** k, size=3000).astype(np.uint64))
    codes = fm_ops.keys_to_codes(keys, k)
    l1, h1 = fm_ops.backward_search_codes(dense, jnp.asarray(codes))
    w1 = np.asarray(h1) - np.asarray(l1)
    ftab = fm_ops.build_ftab(fm, 5)
    monkeypatch.setenv("PSI_MASK_DERIVE", "search")
    prep = fm_trie.prepare(keys, k, ftab, wire="mask")
    lo2, hi2 = fm_trie.trie_search(
        arr, keys, k, ftab=ftab, prepared=prep
    )
    np.testing.assert_array_equal(w1, hi2 - lo2)
    nz = w1 > 0
    assert nz.any()
    np.testing.assert_array_equal(np.asarray(l1)[nz], lo2[nz])


def test_expand_slots_scatter_matches_search(monkeypatch):
    """PSI_EXPAND=scatter (max-scatter + associative max-scan) agrees
    with the searchsorted form on the live region, incl. zero-width
    slots and an empty tail."""
    rng = np.random.RandomState(31)
    w = rng.randint(0, 5, size=257).astype(np.int32)
    w[rng.choice(257, 80, replace=False)] = 0
    csum = np.cumsum(w).astype(np.int32)
    total = int(csum[-1])
    cap = 1 << (total - 1).bit_length()

    monkeypatch.setenv("PSI_EXPAND", "search")
    a = np.asarray(
        fm_trie._expand_slots(jnp.asarray(csum), jnp.asarray(w), cap)
    )
    monkeypatch.setenv("PSI_EXPAND", "scatter")
    b = np.asarray(
        fm_trie._expand_slots(jnp.asarray(csum), jnp.asarray(w), cap)
    )
    live = np.arange(cap) < total
    np.testing.assert_array_equal(a[live], b[live])
    # live entries must point at their covering slot
    occ = np.arange(cap)[live]
    slots = a[live]
    assert (occ < csum[slots]).all()
    assert (occ >= csum[slots] - w[slots]).all()


def test_seed_finder_chain_route_matches_default(monkeypatch):
    """The fully device-chained on-path route (trie -> counts-only
    download -> device expand+locate via device-resident lo/hi) emits
    the identical hit multiset to the plain route, with and without a
    gocc threshold and under mismatch expansion."""
    from psi_tpu.graph import Graph
    from psi_tpu.records import Records
    from psi_tpu.seed_finder import SeedFinder

    rng = np.random.RandomState(21)
    seq = "".join(rng.choice(list("ACGT"), size=900))
    # repeat a block so some k-mers have gocc > 1
    seq = seq + seq[100:220] + seq[300:360]
    g = Graph.from_parts(nodes={1: seq}, edges=[], paths=[("ref", [1])])

    def run(chain, thr=0, mm=0):
        if chain:
            monkeypatch.setenv("PSI_STREAM", "1")
            monkeypatch.setenv("PSI_DEVICE_LOCATE", "1")
        else:
            monkeypatch.delenv("PSI_STREAM", raising=False)
            monkeypatch.delenv("PSI_DEVICE_LOCATE", raising=False)
        finder = SeedFinder(
            g, seed_len=12, gocc_threshold=thr, seed_mismatches=mm
        )
        finder.create_path_index(n=1, patched=False)
        reads = Records(
            [f"r{i}" for i in range(10)],
            [seq[i * 97: i * 97 + 50] for i in range(10)],
        )
        seeds = finder.get_seeds(reads)
        index = finder.index_reads(seeds)
        if chain:
            finder.prepare_onpath(index)
        hits = []
        finder.seeds_on_paths(seeds, index, hits.append)
        return sorted(
            (s.node_id, s.node_offset, s.read_id, s.read_offset, s.gocc)
            for s in hits
        )

    for thr, mm in ((0, 0), (1, 0), (0, 1)):
        a = run(False, thr, mm)
        b = run(True, thr, mm)
        assert len(a) > 0
        assert a == b, (thr, mm)
    # mask + delta wire formats through the same chained route
    for wire in ("mask", "delta"):
        monkeypatch.setenv("PSI_TRIE_WIRE", wire)
        c = run(True)
        assert c == run(False), wire
    monkeypatch.delenv("PSI_TRIE_WIRE", raising=False)
    # scatter occurrence expansion through the chained route. PSI_EXPAND
    # is read at TRACE time and (k, cap) were already traced above with
    # the search form — drop the cached traces so the env flip takes.
    monkeypatch.setenv("PSI_EXPAND", "scatter")
    fm_trie._expand_locate_device.clear_cache()
    for thr in (0, 1):
        assert run(True, thr) == run(False, thr), thr
    monkeypatch.delenv("PSI_EXPAND", raising=False)
    fm_trie._expand_locate_device.clear_cache()
    # eager single-fetch chain (uint16 counts + 24-bit gpos planes +
    # sticky expansion cap), off-CPU default, forced here
    monkeypatch.setenv("PSI_CHAIN_EAGER", "1")
    for thr, mm in ((0, 0), (1, 0), (0, 1)):
        assert run(True, thr, mm) == run(False, thr, mm), (thr, mm)


def test_seeds_all_arrays_eager_fused_traverse(monkeypatch):
    """seeds_all_arrays with the eager chain: the off-path traversal's
    packed result rides the on-path fetch; the combined hit multiset
    matches the non-eager run, including the split form."""
    from psi_tpu.graph import Graph
    from psi_tpu.records import Records
    from psi_tpu.seed_finder import SeedFinder

    rng = np.random.RandomState(33)
    seq = "".join(rng.choice(list("ACGT"), size=1200))
    g = Graph.from_parts(
        nodes={1: seq[:600], 2: seq[600:], 3: "ACGTAGGTACGTTCGTACGA"},
        edges=[(1, 2), (1, 3), (3, 2)],
        paths=[("ref", [1, 2])],
    )
    branch = g.node_sequence(1)[-6:] + g.node_sequence(3) + \
        g.node_sequence(2)[:10]

    def run(eager):
        monkeypatch.setenv("PSI_STREAM", "1")
        monkeypatch.setenv("PSI_DEVICE_LOCATE", "1")
        monkeypatch.setenv("PSI_CHAIN_EAGER", "1" if eager else "0")
        finder = SeedFinder(g, seed_len=12)
        finder.create_path_index(n=1, patched=False)
        finder.add_uncovered_loci()
        reads = Records(
            [f"r{i}" for i in range(12)],
            [seq[i * 61: i * 61 + 48] for i in range(10)]
            + [branch, branch[3:]],
        )
        seeds = finder.get_seeds(reads)
        index = finder.index_reads(seeds)
        finder.prepare_onpath(index)
        on, off = finder.seeds_all_arrays(seeds, index, split=True)
        return (
            sorted(map(tuple, on.tolist())),
            sorted(map(tuple, off.tolist())),
        )

    on_a, off_a = run(False)
    on_b, off_b = run(True)
    assert len(on_a) > 0 and len(off_a) > 0
    assert on_a == on_b
    assert off_a == off_b


def test_delta_wire_nibble_form():
    """4-bit delta wire: dense key fills pick the nibble form (half the
    schedule upload), sparse fills keep the byte form; both match the
    per-query scan exactly."""
    rng = np.random.RandomState(23)
    s = "".join(rng.choice(list("ACGT"), size=60_000))
    fm = FMIndex.build_from_strings([s[::-1]])
    arr = fm_trie.build_stream_arrays(fm)
    dense = fm_ops.to_device(fm, dense_occ=True)
    k = 12

    # dense fill: ~6K distinct keys in the 8192 pad -> small gaps
    keys_dense = np.unique(
        rng.randint(0, 4 ** k, size=8000).astype(np.uint64)
    )
    prep = fm_trie.prepare(keys_dense, k, wire="delta")
    assert prep.delta_bits == 4
    assert prep.delta.shape[-1] * 2 == prep.dexc.shape[-1] * 64 or \
        prep.delta.shape[-1] * 2 >= len(keys_dense)  # nibble-packed
    codes = fm_ops.keys_to_codes(keys_dense, k)
    l1, h1 = fm_ops.backward_search_codes(dense, jnp.asarray(codes))
    lo2, hi2 = fm_trie.trie_search(
        arr, keys_dense, k, prepared=prep
    )
    np.testing.assert_array_equal(np.asarray(h1) - np.asarray(l1),
                                  hi2 - lo2)
    nz = hi2 > lo2
    assert nz.any()
    np.testing.assert_array_equal(np.asarray(l1)[nz], lo2[nz])

    # sparse fill: gaps are frontier-SLOT gaps (the frontier is
    # compacted), so even a 300-key / 8192-pad plan stays nibble and
    # must stay exact
    keys_sparse = np.unique(
        rng.randint(0, 4 ** k, size=300).astype(np.uint64)
    )
    prep_s = fm_trie.prepare(keys_sparse, k, npad=8192, wire="delta")
    codes_s = fm_ops.keys_to_codes(keys_sparse, k)
    l1s, h1s = fm_ops.backward_search_codes(dense, jnp.asarray(codes_s))
    lo_s, hi_s = fm_trie.trie_search(
        arr, keys_sparse, k, prepared=prep_s
    )
    np.testing.assert_array_equal(
        np.asarray(h1s) - np.asarray(l1s), hi_s - lo_s
    )
    # forced byte form stays available for mesh-uniform stacks
    prep_8 = fm_trie.prepare(keys_dense, k, wire="delta8")
    assert prep_8.delta_bits == 8
    lo8, hi8 = fm_trie.trie_search(
        arr, keys_dense, k, prepared=prep_8
    )
    np.testing.assert_array_equal(hi2 - lo2, hi8 - lo8)
    codes = fm_ops.keys_to_codes(keys_sparse, k)
    l1, h1 = fm_ops.backward_search_codes(dense, jnp.asarray(codes))
    lo3, hi3 = fm_trie.trie_search(
        arr, keys_sparse, k, prepared=prep_s
    )
    np.testing.assert_array_equal(np.asarray(h1) - np.asarray(l1),
                                  hi3 - lo3)
