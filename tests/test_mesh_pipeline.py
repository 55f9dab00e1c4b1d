"""Production pipeline on the device mesh: the CLI/SeedFinder sharded
query routes (on-path trie over "data", off-path traversal over loci)
must emit a bit-identical hit stream to the single-device run.

Exercises SURVEY §2.3's distributed-backend layer THROUGH SeedFinder
(ref: src/psikt.cpp:183-209 chunk loop scaled out), on the 8-virtual-
device CPU mesh from conftest.
"""

import os

import numpy as np
import pytest

import jax

from psi_tpu.graph import Graph
from psi_tpu.records import Records
from psi_tpu.seed_finder import SeedFinder

SORT_ORDER = ["node_id", "node_offset", "read_id", "read_offset",
              "match_len", "gocc"]


@pytest.fixture(autouse=True)
def _need_devices():
    if jax.device_count() < 2:
        pytest.skip("needs the virtual multi-device CPU mesh")


def _branchy_graph(rng, n=2500):
    seq = "".join(rng.choice(list("ACGT"), size=n))
    g = Graph.from_parts(
        nodes={
            1: seq[: n // 2],
            2: seq[n // 2:],
            3: "ACGTAGGTACGTTCGTACGATTACCGGA",
        },
        edges=[(1, 2), (1, 3), (3, 2)],
        paths=[("ref", [1, 2])],
    )
    return g, seq


def _run_finder(g, seq, devices, uncovered=True, mismatches=0):
    finder = SeedFinder(
        g, seed_len=12, devices=devices, seed_mismatches=mismatches
    )
    finder.create_path_index(n=1, patched=False)
    if uncovered:
        finder.add_uncovered_loci()
    reads = Records(
        [f"r{i}" for i in range(48)],
        [seq[i * 43: i * 43 + 60] for i in range(48)],
    )
    seeds = finder.get_seeds(reads)
    index = finder.index_reads(seeds)
    finder.prepare_onpath(index)
    hits = finder.seeds_all_arrays(seeds, index)
    return np.sort(hits, order=SORT_ORDER)


def test_seedfinder_mesh_bitidentical(monkeypatch):
    monkeypatch.setenv("PSI_STREAM", "1")
    rng = np.random.RandomState(3)
    g, seq = _branchy_graph(rng)
    single = _run_finder(g, seq, devices=1)
    multi = _run_finder(g, seq, devices="auto")
    assert len(single) > 0
    np.testing.assert_array_equal(single, multi)


def test_seedfinder_mesh_offpath_loci(monkeypatch):
    """Off-path route through sharded_traverse: force hits on the
    uncovered branch node so the loci-sharded traversal is load-bearing."""
    monkeypatch.setenv("PSI_STREAM", "1")
    rng = np.random.RandomState(4)
    g, seq = _branchy_graph(rng)
    # a read that crosses the off-path branch node 3
    branch = g.node_sequence(1)[-6:] + g.node_sequence(3) + \
        g.node_sequence(2)[:10]

    def run(devices):
        finder = SeedFinder(g, seed_len=12, devices=devices)
        finder.create_path_index(n=1, patched=False)
        finder.add_uncovered_loci()
        assert len(finder.get_starting_loci()) > 0
        reads = Records(["b0", "b1"], [branch, branch[3:]])
        seeds = finder.get_seeds(reads)
        index = finder.index_reads(seeds)
        hits = finder.seeds_off_paths_arrays(seeds, index)
        assert hits is not None and len(hits) > 0
        return np.sort(hits, order=SORT_ORDER)

    np.testing.assert_array_equal(run(1), run("auto"))


def test_seedfinder_mesh_mismatches(monkeypatch):
    monkeypatch.setenv("PSI_STREAM", "1")
    rng = np.random.RandomState(6)
    g, seq = _branchy_graph(rng)
    single = _run_finder(g, seq, devices=1, mismatches=1)
    multi = _run_finder(g, seq, devices="auto", mismatches=1)
    assert len(single) > 0
    np.testing.assert_array_equal(single, multi)


def test_cli_mesh_bitidentical(data_dir, tmp_path, monkeypatch):
    """The VERDICT done-criterion: a CLI run on the virtual 8-device
    mesh produces a bit-identical hit stream to single-device."""
    from psi_tpu.cli import main

    monkeypatch.setenv("PSI_STREAM", "1")
    graph = str(data_dir / "small" / "x.vg")
    fastq = str(data_dir / "small" / "reads_n10l10e0i0.fastq")
    out1 = str(tmp_path / "one.bin")
    out8 = str(tmp_path / "mesh.bin")
    assert main(
        [graph, "-f", fastq, "-l", "10", "-n", "1", "-o", out1,
         "--device", "cpu", "--devices", "1", "-q", "-Q"]
    ) == 0
    assert main(
        [graph, "-f", fastq, "-l", "10", "-n", "1", "-o", out8,
         "--device", "cpu", "--devices", "auto", "-q", "-Q"]
    ) == 0
    a = np.fromfile(out1, dtype=np.int64).reshape(-1, 4)
    b = np.fromfile(out8, dtype=np.int64).reshape(-1, 4)
    assert len(a) > 0
    assert sorted(map(tuple, a)) == sorted(map(tuple, b))


def test_env_devices_selection(monkeypatch):
    monkeypatch.setenv("PSI_DEVICES", "auto")
    rng = np.random.RandomState(7)
    g, seq = _branchy_graph(rng, n=1200)
    finder = SeedFinder(g, seed_len=12)
    assert finder._get_mesh() is not None
    monkeypatch.setenv("PSI_DEVICES", "1")
    finder2 = SeedFinder(g, seed_len=12)
    assert finder2._get_mesh() is None


def test_sharded_trie_delta_wire(monkeypatch):
    """The delta wire on the sharded route (round-4 unification): per-
    shard uint8 parent-gap schedules + in-device derive must match the
    packed wire bit-exactly, with and without the ftab row seed."""
    from psi_tpu.fmindex import FMIndex
    from psi_tpu.ops import fm as fm_ops
    from psi_tpu.ops import fm_trie
    from psi_tpu.parallel.mesh import (
        device_mesh, prepare_trie_sharded, sharded_trie_search,
    )

    rng = np.random.RandomState(27)
    s = "".join(rng.choice(list("ACGT"), size=60_000))
    fm = FMIndex.build_from_strings([s[::-1]])
    sarr = fm_trie.build_stream_arrays(fm)
    k = 12
    keys = np.unique(rng.randint(0, 4 ** k, size=4000).astype(np.uint64))
    mesh = device_mesh(jax.device_count())
    for ftab in (None, fm_ops.build_ftab(fm, 5)):
        p_packed = prepare_trie_sharded(
            mesh, keys, k, fm.size, ftab, wire="packed"
        )
        p_delta = prepare_trie_sharded(
            mesh, keys, k, fm.size, ftab, wire="delta"
        )
        assert p_delta.delta is not None
        lo1, hi1 = sharded_trie_search(
            mesh, sarr, keys, k, ftab=ftab, prepared=p_packed
        )
        lo2, hi2 = sharded_trie_search(
            mesh, sarr, keys, k, ftab=ftab, prepared=p_delta
        )
        np.testing.assert_array_equal(hi1 - lo1, hi2 - lo2)
        nz = hi1 > lo1
        assert nz.any()
        np.testing.assert_array_equal(lo1[nz], lo2[nz])


def test_seedfinder_mesh_chain_bitidentical(monkeypatch):
    """The device-chained on-path route ON THE MESH (counts-only
    download + per-shard expand/locate) is bit-identical to the
    single-device chain, across wire formats and gocc thresholds."""
    monkeypatch.setenv("PSI_STREAM", "1")
    monkeypatch.setenv("PSI_DEVICE_LOCATE", "1")
    rng = np.random.RandomState(9)
    g, seq = _branchy_graph(rng)

    def run(devices, thr=0):
        finder = SeedFinder(g, seed_len=12, devices=devices,
                            gocc_threshold=thr)
        finder.create_path_index(n=1, patched=False)
        finder.add_uncovered_loci()
        reads = Records(
            [f"r{i}" for i in range(48)],
            [seq[i * 43: i * 43 + 60] for i in range(48)],
        )
        seeds = finder.get_seeds(reads)
        index = finder.index_reads(seeds)
        finder.prepare_onpath(index)
        hits = finder.seeds_all_arrays(seeds, index)
        return np.sort(hits, order=SORT_ORDER)

    for wire in ("delta", "packed"):
        monkeypatch.setenv("PSI_TRIE_WIRE", wire)
        for thr in (0, 2):
            single = run(1, thr)
            multi = run("auto", thr)
            assert len(single) > 0
            np.testing.assert_array_equal(single, multi), (wire, thr)


def test_sharded_trie_plain_wire(monkeypatch):
    """uint16-overflow fallback: the sharded route's plain-format
    branch must match the packed default bit-exactly."""
    import numpy as np

    from psi_tpu.fmindex import FMIndex
    from psi_tpu.ops import fm_trie
    from psi_tpu.parallel.mesh import device_mesh, sharded_trie_search

    rng = np.random.RandomState(23)
    s = "".join(rng.choice(list("ACGT"), size=60_000))
    fm = FMIndex.build_from_strings([s[::-1]])
    sarr = fm_trie.build_stream_arrays(fm)
    k = 12
    keys = np.unique(rng.randint(0, 4 ** k, size=3000).astype(np.uint64))
    mesh = device_mesh(jax.device_count())
    lo1, hi1 = sharded_trie_search(mesh, sarr, keys, k)
    monkeypatch.setenv("PSI_TRIE_PACK", "0")
    lo2, hi2 = sharded_trie_search(mesh, sarr, keys, k)
    np.testing.assert_array_equal(hi1 - lo1, hi2 - lo2)
    np.testing.assert_array_equal(lo1[hi1 > lo1], lo2[hi1 > lo1])
