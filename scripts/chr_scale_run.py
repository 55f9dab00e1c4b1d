"""Chromosome-scale end-to-end run (synthetic pan-genome).

Build a ~100 Mbp 4-component pan-genome, index it, simulate reads, and
run the on-path + off-path query pipeline; reports per-stage timings.
Device: JAX's default (JAX_PLATFORMS=cpu selects the host); PSI_STREAM
picks the on-path route.

Usage: python scripts/chr_scale_run.py [ref_mbp] [n_reads]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ref_mbp = float(sys.argv[1]) if len(sys.argv) > 1 else 100.0
    n_reads = int(sys.argv[2]) if len(sys.argv) > 2 else 20000
    read_len = 150
    k = 30

    from psi_tpu.cache import enable_compile_cache

    enable_compile_cache()

    from psi_tpu.simulate import make_pangenome_graph
    from psi_tpu.seed_finder import SeedFinder
    from psi_tpu.records import Records

    t = {}
    t0 = time.time()
    graph = make_pangenome_graph(
        int(ref_mbp * 1e6), variant_rate=0.01, indel_frac=0.2,
        seed=7, n_components=4,
    )
    t["graph_build"] = time.time() - t0
    print(f"graph: {graph.node_count} nodes, {t['graph_build']:.0f}s",
          flush=True)

    finder = SeedFinder(graph, seed_len=k)
    t0 = time.time()
    finder.create_path_index(n=6, patched=True, context=k, step_size=10,
                             dmin=300, dmax=500)
    t["index_build"] = time.time() - t0
    print(f"index: {t['index_build']:.0f}s "
          f"({finder.pindex.fm.size} chars, "
          f"{len(finder.starting_loci)} uncovered loci)", flush=True)

    # simulate error-free reads off the reference paths
    rng = np.random.RandomState(11)
    names, seqs = [], []
    starts_all = graph.label_offsets
    # sample from concatenated labels of reference path nodes: use the
    # whole concatenated label text as read source
    labels = graph.labels.tobytes().decode("ascii")
    for i in range(n_reads):
        p = rng.randint(0, len(labels) - read_len)
        names.append(f"r{i}")
        seqs.append(labels[p: p + read_len])
    reads = Records(names, seqs)

    t0 = time.time()
    seeds = finder.get_seeds(reads)
    index = finder.index_reads(seeds)
    t["seeding"] = time.time() - t0

    n_hits = [0]
    t0 = time.time()
    arr = finder.seeds_on_paths_arrays(seeds, index)
    t["on_path_cold"] = time.time() - t0
    n_hits[0] = 0 if arr is None else len(arr)
    print(f"on-path (cold incl compile): {t['on_path_cold']:.1f}s, "
          f"{n_hits[0]} hits", flush=True)

    # warm re-run on a fresh equal-size chunk
    seqs2 = []
    for i in range(n_reads):
        p = rng.randint(0, len(labels) - read_len)
        seqs2.append(labels[p: p + read_len])
    reads2 = Records(names, seqs2)
    seeds2 = finder.get_seeds(reads2)
    index2 = finder.index_reads(seeds2)
    t0 = time.time()
    arr2 = finder.seeds_on_paths_arrays(seeds2, index2)
    t["on_path_warm"] = time.time() - t0
    n2 = 0 if arr2 is None else len(arr2)
    n_seeds = int(seeds2.valid.sum())
    print(f"on-path (warm): {t['on_path_warm']:.2f}s for {n_seeds} seeds "
          f"-> {n_seeds / t['on_path_warm']:.0f} seeds/s, {n2} hits",
          flush=True)

    t0 = time.time()
    hits_off = []
    finder.seeds_off_paths(seeds2, index2, hits_off.append)
    t["off_path_cold"] = time.time() - t0
    print(f"off-path traversal (cold incl compile): "
          f"{t['off_path_cold']:.1f}s, {len(hits_off)} hits", flush=True)
    t0 = time.time()
    hits_off2 = []
    finder.seeds_off_paths(seeds, index, hits_off2.append)
    t["off_path_warm"] = time.time() - t0
    print(f"off-path traversal (warm, {len(finder.starting_loci)} loci): "
          f"{t['off_path_warm']:.2f}s", flush=True)

    total = sum(t.values())
    print("stages:", {kk: round(vv, 1) for kk, vv in t.items()}, flush=True)
    print(f"TOTAL: {total/60:.1f} min", flush=True)


if __name__ == "__main__":
    main()
