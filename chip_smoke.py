#!/usr/bin/env python3
"""Smoke run of the seed-finding pipeline on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--four-cards]

Phases (any failure exits non-zero; the last line of stdout is the
JSON result only when every phase passed):

1. device and card: JAX must compute on a GPU and the native host
   library must be loaded (no NumPy fallback);
2. main path: a ~50 Mbp 4-component pan-genome graph
   (simulate.make_pangenome_graph), 200,000 x 150 bp reads from ggsim
   (-e 0.005), and `psikt --device gpu -l 30 -n 6 -e 10 -c 50000
   -m 300 -M 500 -I <prefix> --report`, run in this process;
3. parity, all exact: the trie route's lo/hi for every distinct key of
   the first chunk vs the C++ reference (native/psi_fm.cpp); the device
   off-path traversal vs the host WalkTree; the first 5,000 reads
   re-run by a `--device cpu` child process (JAX_PLATFORMS=cpu, never
   opens the card) on the saved path index; the device distance probe
   vs the host probe; the chip-marked tests (tests/test_chip.py).

`--four-cards` runs only the phase-2 workload, with `--devices 4`, and
compares its hit stream with a `--devices 1` run in the same process.

One process holds the card. Data is generated from `--seed` under
`.smoke_work/` in the checkout and removed at the end (`--keep` keeps
it). `--cpu-rehearsal` runs every phase on the CPU at whatever size is
given, for finding faults without a card; it then exits 3 and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
K = 30
DMIN, DMAX = 300, 500


class SmokeFailure(Exception):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


class _ChunkLog(logging.Handler):
    """Collects psikt's per-chunk and phase log records with times."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append((time.monotonic(), record.msg, record.args))

    def chunk_times(self, since: float):
        return [float(a[2]) for t, m, a in self.records
                if t >= since and m.startswith("Chunk ")]

    def time_of(self, prefix: str, since: float):
        for t, m, _ in self.records:
            if t >= since and m.startswith(prefix):
                return t
        return None


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mbp", type=float, default=50.0,
                   help="graph length in Mbp (default: chr22-like 50)")
    p.add_argument("--reads", type=int, default=200_000)
    p.add_argument("--chunk", type=int, default=50_000)
    p.add_argument("--child-reads", type=int, default=5_000)
    p.add_argument("--four-cards", action="store_true")
    p.add_argument("--workdir", default=os.path.join(REPO, ".smoke_work"))
    p.add_argument("--keep", action="store_true")
    p.add_argument("--cpu-rehearsal", action="store_true")
    return p.parse_args(argv)


def make_data(args, work):
    """Graph (.npz) and reads (FASTQ) from --seed; returns paths and
    set-up times."""
    from psi_tpu.simulate import make_pangenome_graph
    from psi_tpu.tools import ggsim

    t0 = time.monotonic()
    graph = make_pangenome_graph(
        int(args.mbp * 1e6), variant_rate=0.01, indel_frac=0.2,
        seed=args.seed, n_components=4,
    )
    gpath = os.path.join(work, "graph.npz")
    graph.save(gpath)
    t_graph = time.monotonic() - t0
    say(f"setup: graph {args.mbp:g} Mbp, {graph.node_count} nodes, "
        f"{graph.edge_count} edges in {t_graph:.3f} s")
    fq = os.path.join(work, "reads.fq")
    t0 = time.monotonic()
    rc = ggsim.main([gpath, "-o", fq, "-n", str(args.reads), "-l", "150",
                     "-e", "0.005", "-S", str(args.seed + 1)])
    check(rc == 0, f"ggsim exited {rc}")
    t_reads = time.monotonic() - t0
    say(f"setup: {args.reads} reads x 150 bp (ggsim -e 0.005) in "
        f"{t_reads:.3f} s")
    return gpath, fq


def run_psikt(args, gpath, fq, work, tag, chunk_log, devices, card):
    """One in-process psikt run; returns the sorted hit rows."""
    import numpy as np

    from psi_tpu import cli

    prefix = os.path.join(work, "pindex")
    out = os.path.join(work, f"hits_{tag}.bin")
    rep = os.path.join(work, f"report_{tag}.json")
    argv = [gpath, "-f", fq, "-o", out, "-I", prefix,
            "-l", str(K), "-n", "6", "-e", "10", "-c", str(args.chunk),
            "-m", str(DMIN), "-M", str(DMAX),
            "--device", "cpu" if args.cpu_rehearsal else "gpu",
            "--devices", str(devices), "--report", rep, "-Q"]
    t0 = time.monotonic()
    rc = cli.main(argv)
    t_total = time.monotonic() - t0
    check(rc == 0, f"psikt ({tag}) exited {rc}")
    t_find = chunk_log.time_of("Finding seeds", t0)
    chunks = chunk_log.chunk_times(t0)
    with open(rep) as fh:
        report = json.load(fh)
    hits = np.fromfile(out, dtype="<i8").reshape(-1, 4)
    check(len(chunks) == -(-args.reads // args.chunk),
          f"psikt ({tag}) ran {len(chunks)} chunks")
    check(len(hits) == report["seedhits"] and len(hits) > 0,
          f"psikt ({tag}) wrote {len(hits)} hits, "
          f"report says {report['seedhits']}")
    say(f"psikt[{tag}] ({card}): index set-up "
        f"{(t_find or t0) - t0:.3f} s, pindex {report['pindexsize']} "
        f"chars, {report['locino']} loci; chunk times (s, first incl. "
        f"compile) {[round(c, 3) for c in chunks]}; total "
        f"{t_total:.3f} s; {len(hits)} hits, "
        f"{report['coveredreads']} reads covered; report means per chunk "
        f"(incl. chunk 1): on-path {report['pathquerytimeperchunk']} s, "
        f"off-path {report['traversetimeperchunk']} s")
    return hits[np.lexsort(hits.T[::-1])], prefix, report


def peak_bytes() -> str:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    v = stats.get("peak_bytes_in_use")
    return "not measured" if v is None else str(v)


def phase_parity(args, gpath, fq, prefix, hits, work, card):
    import numpy as np

    from psi_tpu import native
    from psi_tpu.dindex import DistanceIndex
    from psi_tpu.io import load_graph
    from psi_tpu.io.fastq import FastxStream
    from psi_tpu.ops import fm as fm_ops
    from psi_tpu.ops import fm_trie
    from psi_tpu.records import Records
    from psi_tpu.seed_finder import SeedFinder

    graph = load_graph(gpath)
    finder = SeedFinder(graph, K, devices=1)
    check(finder.load_path_index(prefix, 0, 10, DMIN, DMAX),
          "saved path index did not load")
    stream = FastxStream(fq)
    names, packed = stream.read_chunk_packed(args.chunk)
    chunk = Records(names, rec_offset=0, packed=packed)
    seeds = finder.get_seeds(chunk)
    index = finder.index_reads(seeds)

    # (a) trie route vs the C++ reference, every distinct key
    keys = np.unique(index.sorted_keys)
    t0 = time.monotonic()
    lo, hi, _ = finder._search_stream(keys, K)
    t_trie = time.monotonic() - t0
    fm = finder.pindex.fm
    ref = native.fm_backward_batch(
        fm_trie.payload_host(fm), fm.C.astype(np.int32), fm.size,
        fm_ops.keys_to_codes(keys, K),
    )
    check(ref is not None, "native fm_backward_batch unavailable")
    lo_n, hi_n, nonempty = ref
    cnt = np.maximum(hi_n - lo_n, 0)
    nz = cnt > 0
    check(np.array_equal(hi - lo, cnt) and np.array_equal(lo[nz], lo_n[nz]),
          "trie lo/hi differ from the C++ reference")
    say(f"parity: trie lo/hi == C++ reference for {len(keys)} distinct "
        f"keys ({nonempty} present; trie call {t_trie:.3f} s incl. "
        f"prepare, {card})")

    # (b) device off-path traversal vs the host WalkTree
    def off_hits(cache):
        os.environ["PSI_TRAV_CACHE"] = cache
        try:
            arr = finder.seeds_off_paths_arrays(seeds, index)
        finally:
            os.environ.pop("PSI_TRAV_CACHE", None)
        return np.sort(arr, order=list(arr.dtype.names))

    dev_off, tree_off = off_hits("0"), off_hits("1")
    check(len(tree_off) > 0, "no off-path hits in the first chunk")
    check(np.array_equal(dev_off, tree_off),
          f"device traversal {len(dev_off)} hits != WalkTree "
          f"{len(tree_off)} hits")
    say(f"parity: device traversal == WalkTree ({len(tree_off)} off-path "
        f"hits over {len(finder.starting_loci)} loci)")

    # (c) --device cpu child on the first reads, saved path index
    n_child = args.child_reads
    fq_child = os.path.join(work, "reads_child.fq")
    with open(fq) as src, open(fq_child, "w") as dst:
        for _ in range(4 * n_child):
            dst.write(src.readline())
    out_child = os.path.join(work, "hits_cpu_child.bin")
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    t0 = time.monotonic()
    res = subprocess.run(
        [sys.executable, "-m", "psi_tpu.cli", gpath, "-f", fq_child,
         "-o", out_child, "-I", prefix, "-l", str(K), "-n", "6",
         "-e", "10", "-m", str(DMIN), "-M", str(DMAX), "--device", "cpu",
         "-Q", "-q"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900,
    )
    check(res.returncode == 0,
          f"cpu child exited {res.returncode}: {res.stderr[-2000:]}")
    child = np.fromfile(out_child, dtype="<i8").reshape(-1, 4)
    child = child[np.lexsort(child.T[::-1])]
    mine = hits[hits[:, 2] < n_child]
    check(len(child) > 0 and np.array_equal(mine, child),
          f"GPU stream ({len(mine)} hits) != cpu child ({len(child)})")
    say(f"parity: GPU hit stream == --device cpu child for the first "
        f"{n_child} reads ({len(child)} hits; child "
        f"{time.monotonic() - t0:.3f} s)")

    # (d) distance probe on the device vs the host
    di = DistanceIndex.load(SeedFinder.get_dindex_path(prefix, DMIN, DMAX))
    rng = np.random.RandomState(args.seed + 2)
    n = 1 << 20
    lens = np.diff(graph.label_offsets)
    v = rng.randint(1, graph.node_count + 1, size=n)
    u = np.minimum(v + rng.randint(0, 64, size=n), graph.node_count)
    o = rng.randint(0, 1 << 30, size=n) % lens[v - 1]
    p = rng.randint(0, 1 << 30, size=n) % lens[u - 1]
    want = di.verify_batch(graph, v, o, u, p)
    t0 = time.monotonic()
    got = di.verify_batch_device(graph, v, o, u, p)
    t_probe = time.monotonic() - t0
    check(want.sum() > 0 and np.array_equal(got, want),
          "device distance probe differs from the host probe")
    say(f"parity: device distance probe == host probe on {n} pairs "
        f"({int(want.sum())} within [{DMIN}, {DMAX}]; device "
        f"{t_probe:.3f} s incl. compile, {card})")


def phase_chip_tests():
    """Run tests/test_chip.py in this process; every test must pass."""
    import pytest

    class Count:
        def __init__(self):
            self.passed = self.other = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed or report.skipped:
                self.other += 1

    os.environ["PSI_CHIP_TESTS"] = "1"
    count = Count()
    t0 = time.monotonic()
    rc = pytest.main(
        ["-q", "-m", "chip", "-p", "no:cacheprovider",
         os.path.join(REPO, "tests", "test_chip.py")],
        plugins=[count],
    )
    check(rc == 0 and count.passed > 0 and count.other == 0,
          f"chip tests: rc {rc}, {count.passed} passed, "
          f"{count.other} failed or skipped")
    say(f"parity: {count.passed} chip tests passed in "
        f"{time.monotonic() - t0:.3f} s")


def main(argv=None) -> int:
    args = parse_args(argv)
    import jax

    dev0 = jax.devices()[0]
    if dev0.platform != "gpu" and not args.cpu_rehearsal:
        print(f"chip_smoke: JAX found no GPU (platform {dev0.platform!r})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from psi_tpu import native, platform
    from psi_tpu.cache import enable_compile_cache

    dev = platform.active()
    say(f"device: platform={dev.platform} kind={dev.kind} count={dev.count}")
    card = ("not measured (cpu rehearsal)" if args.cpu_rehearsal
            else platform.card_info().splitlines()[0])
    check(native.available(), f"native library not loaded: "
          f"{native.load_error}")
    say(f"native: {native.library_path()}")
    say(f"compile cache: {enable_compile_cache()}")
    if args.mbp != 50 or args.reads != 200_000:
        say(f"cut: graph {args.mbp:g} Mbp (of 50), {args.reads} reads "
            f"(of 200000)")

    work = args.workdir
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    chunk_log = _ChunkLog()
    logging.getLogger("psikt").addHandler(chunk_log)
    try:
        gpath, fq = make_data(args, work)
        if args.four_cards:
            check(dev.count >= 4, f"--four-cards needs 4 devices, have "
                  f"{dev.count}")
            hits4, _, _ = run_psikt(args, gpath, fq, work, "devices4",
                                    chunk_log, 4, card)
            hits1, _, _ = run_psikt(args, gpath, fq, work, "devices1",
                                    chunk_log, 1, card)
            check(hits4.shape == hits1.shape
                  and bool((hits4 == hits1).all()),
                  f"--devices 4 ({len(hits4)} hits) != --devices 1 "
                  f"({len(hits1)} hits)")
            say(f"parity: --devices 4 == --devices 1, {len(hits4)} hits "
                f"bit-identical (sorted multiset)")
        else:
            hits, prefix, _ = run_psikt(args, gpath, fq, work, "gpu",
                                        chunk_log, 1, card)
            say(f"peak_bytes_in_use: {peak_bytes()} ({card})")
            phase_parity(args, gpath, fq, prefix, hits, work, card)
            if args.cpu_rehearsal:
                say("chip tests: skipped in a cpu rehearsal")
            else:
                phase_chip_tests()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        if not args.keep:
            shutil.rmtree(work, ignore_errors=True)
    say(f"card: {card}")
    result = {"ok": True, "device": {"platform": dev0.platform,
                                     "kind": dev0.device_kind,
                                     "count": len(jax.devices())}}
    if args.cpu_rehearsal:
        print(f"chip_smoke: cpu rehearsal passed (not a chip result): "
              f"{json.dumps(result)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
