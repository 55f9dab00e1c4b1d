"""Tests that need the GPU: each device route compiled for the card and
compared with its plain reference.

They skip elsewhere (the `gpu` fixture decides, never at import), and
chip_smoke.py runs them on the card, in its own process:

    PSI_CHIP_TESTS=1 python -m pytest -m chip tests/test_chip.py
"""

import numpy as np
import pytest

pytestmark = pytest.mark.chip


@pytest.fixture(scope="module")
def gpu():
    from psi_tpu import platform

    dev = platform.active()
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX platform: {dev.platform})")
    return dev


@pytest.fixture(scope="module")
def text(gpu):
    from psi_tpu.fmindex import FMIndex
    from psi_tpu.ops import fm_trie

    rng = np.random.RandomState(12)
    strings = ["".join(rng.choice(list("ACGT"), size=500_000))
               for _ in range(4)]
    fm = FMIndex.build_from_strings([s[::-1] for s in strings])
    k = 20
    lut = np.zeros(256, dtype=np.uint64)
    for i, ch in enumerate(b"ACGT"):
        lut[ch] = i
    keys = []
    for s in strings:
        b = lut[np.frombuffer(s.encode(), dtype=np.uint8)]
        starts = rng.randint(0, len(s) - k, size=30_000)
        v = np.zeros(len(starts), dtype=np.uint64)
        for j in range(k):
            v = (v << np.uint64(2)) | b[starts + j]
        keys.append(v)
    keys.append(rng.randint(0, 2**62, size=100_000).astype(np.uint64)
                >> np.uint64(64 - 2 * k))
    keys = np.unique(np.concatenate(keys))
    return fm, fm_trie.build_stream_arrays(fm), keys, k


@pytest.mark.parametrize("wire", ["packed", "delta"])
def test_trie_route_matches_native(text, wire):
    from psi_tpu import native
    from psi_tpu.ops import fm as fm_ops
    from psi_tpu.ops import fm_trie

    fm, arr, keys, k = text
    ftab = fm_ops.build_ftab(fm, 10)
    prep = fm_trie.prepare(keys, k, ftab, wire=wire)
    lo, hi = fm_trie.trie_search(arr, keys, k, ftab=ftab, prepared=prep)
    ref = native.fm_backward_batch(
        fm_trie.payload_host(fm), fm.C.astype(np.int32), fm.size,
        fm_ops.keys_to_codes(keys, k),
    )
    assert ref is not None, native.load_error
    lo_n, hi_n, _ = ref
    cnt = np.maximum(hi_n - lo_n, 0)
    np.testing.assert_array_equal(hi - lo, cnt)
    nz = cnt > 0
    assert nz.sum() > 100_000
    np.testing.assert_array_equal(lo[nz], lo_n[nz])


def _graph_and_reads(seed: int):
    from psi_tpu.records import Records
    from psi_tpu.simulate import make_pangenome_graph

    g = make_pangenome_graph(400_000, variant_rate=0.01, indel_frac=0.2,
                             seed=seed, n_components=2)
    labels = g.labels.tobytes().decode()
    rng = np.random.RandomState(seed)
    starts = rng.randint(0, len(labels) - 150, size=4000)
    reads = Records([f"r{i}" for i in range(len(starts))],
                    [labels[p: p + 150] for p in starts])
    return g, reads


def test_device_traversal_matches_host(gpu, monkeypatch):
    """Off-path frontier traversal on the card (PSI_TRAV_CACHE=0) vs the
    host WalkTree route: same hit multiset."""
    from psi_tpu.seed_finder import SeedFinder

    g, reads = _graph_and_reads(5)
    finder = SeedFinder(g, seed_len=30)
    finder.create_path_index(n=1, patched=True, step_size=10)
    seeds = finder.get_seeds(reads)
    index = finder.index_reads(seeds)

    def off_hits(cache):
        monkeypatch.setenv("PSI_TRAV_CACHE", cache)
        arr = finder.seeds_off_paths_arrays(seeds, index)
        return np.sort(arr, order=list(arr.dtype.names))

    dev, tree = off_hits("0"), off_hits("1")
    assert len(dev) > 100
    np.testing.assert_array_equal(dev, tree)


def test_dindex_device_probe_and_build(gpu, monkeypatch):
    """The distance index's device probe equals the host probe, and the
    device path-doubling build equals the native DP row for row."""
    from psi_tpu.dindex import DistanceIndex

    g, _ = _graph_and_reads(6)
    monkeypatch.delenv("PSI_DINDEX_BUILD", raising=False)
    host = DistanceIndex.build(g, 100, 400, True)
    monkeypatch.setenv("PSI_DINDEX_BUILD", "device")
    dev = DistanceIndex.build(g, 100, 400, True)
    for name in ("src_indptr", "dst", "iv_lo", "iv_hi"):
        np.testing.assert_array_equal(
            np.asarray(getattr(dev, name)), np.asarray(getattr(host, name)))

    rng = np.random.RandomState(7)
    n = 200_000
    lens = np.diff(g.label_offsets)
    v = rng.randint(1, g.node_count + 1, size=n)
    u = np.minimum(v + rng.randint(0, 40, size=n), g.node_count)
    o = rng.randint(0, 1 << 20, size=n) % lens[v - 1]
    p = rng.randint(0, 1 << 20, size=n) % lens[u - 1]
    want = host.verify_batch(g, v, o, u, p)
    got = host.verify_batch_device(g, v, o, u, p)
    assert want.sum() > 1000
    np.testing.assert_array_equal(got, want)
