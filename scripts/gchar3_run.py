"""Human-pan-genome-scale (3 Gchar) end-to-end MEASURED run.

VERDICT r4 item 5: the 2 Gchar disk-spilled FM build was measured in
round 3 and 3 Gchar extrapolated; this script measures the real thing:

  graph gen (bubbled pan-genome) -> picked+patched path index over a
  ~3 Gchar text (disk-spilled sharded SA-IS; the reference's
  external-memory intent, ref: include/psi/fmindex.hpp:214-228) ->
  uncovered loci -> per-component distance index at real paired-end
  insert sizes -> big-column artifact save + memmap reload + probe
  spot-check -> one query chunk (on-path + off-path).

Writes per-stage wall times + peak RSS to the JSON in argv (default
/tmp/gchar3_result.json) and a row for docs/BENCH_NOTES.md.

Usage: JAX_PLATFORMS=cpu python scripts/gchar3_run.py [gchar] [out.json]
(expect hours; run detached)
"""

import json
import os
import resource
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def main():
    gchar = float(sys.argv[1]) if len(sys.argv) > 1 else 3.0
    out_json = sys.argv[2] if len(sys.argv) > 2 else "/tmp/gchar3_result.json"
    total_bp = int(gchar * 1e9)
    k = 30
    dmin, dmax = 250, 450           # real paired-end insert range
    var_bp = 1000                   # one biallelic bubble per ~1 kbp
    n_reads, read_len = 100_000, 150

    from psi_tpu.simulate import make_pangenome_graph
    from psi_tpu.seed_finder import SeedFinder
    from psi_tpu.records import Records
    from psi_tpu.dindex import DistanceIndex

    res = {"gchar": gchar, "dmin": dmin, "dmax": dmax, "k": k,
           "var_bp": var_bp}

    def stage(name, fn):
        t0 = time.time()
        out = fn()
        res[name + "_s"] = round(time.time() - t0, 1)
        res[name + "_peak_gb"] = round(rss_gb(), 2)
        print(f"[{time.strftime('%H:%M:%S')}] {name}: "
              f"{res[name + '_s']}s (peak {res[name + '_peak_gb']} GB)",
              flush=True)
        with open(out_json, "w") as fh:
            json.dump(res, fh, indent=1)
        return out

    graph = stage("graph_gen", lambda: make_pangenome_graph(
        total_bp, variant_rate=1.0 / var_bp, indel_frac=0.2, seed=7,
        n_components=16,
    ))
    res["nodes"] = int(graph.node_count)

    finder = SeedFinder(graph, seed_len=k)
    # default n=1 unpatched: the indexed text is exactly the ~gchar
    # reference set; every bubble's alt allele is an uncovered starting
    # locus (the off-path stress config). PSI_G3_PATCHED=1 switches to
    # the production config (n=1 patched: alt alleles covered by patch
    # paths, few loci) — required for query-inclusive runs near the
    # 2^31-char single-index bound.
    patched = os.environ.get("PSI_G3_PATCHED", "") not in ("", "0")
    stage("path_index", lambda: finder.create_path_index(
        n=1, patched=patched, context=k, step_size=10,
        dmin=dmin, dmax=dmax,
    ))
    res["patched"] = patched
    res["fm_chars"] = int(finder.pindex.fm.size)
    stage("uncovered_loci", finder.add_uncovered_loci)
    res["loci"] = int(len(finder.get_starting_loci()))

    di = finder.dindex
    if di is not None and not di.empty:
        res["dindex_intervals"] = int(len(di.dst))
        path = "/tmp/gchar3_dindex.npz"

        def save_reload():
            di.save(path)
            di2 = DistanceIndex.load(path)
            # spot probes through the memmapped artifact
            rng = np.random.RandomState(5)
            n = graph.node_count
            ok = 0
            for _ in range(200):
                v = int(rng.randint(1, n + 1))
                u = int(rng.randint(1, n + 1))
                if di.verify(graph, v, 0, u, 0) != di2.verify(
                    graph, v, 0, u, 0
                ):
                    raise AssertionError("artifact probe mismatch")
                ok += 1
            side = [f for f in os.listdir("/tmp")
                    if f.startswith("gchar3_dindex.") and f.endswith(".npy")]
            res["dindex_artifact_mb"] = round(sum(
                os.path.getsize(os.path.join("/tmp", f))
                for f in ["gchar3_dindex.npz"] + side
            ) / 1e6, 1)
            res["dindex_side_files"] = side

        stage("dindex_artifact", save_reload)

    # one query chunk off the indexed labels
    labels = graph.labels
    rng = np.random.RandomState(11)
    pos = rng.randint(0, len(labels) - read_len, size=n_reads)
    data = np.lib.stride_tricks.sliding_window_view(
        labels, read_len
    )[pos].reshape(-1)
    offsets = np.arange(n_reads + 1, dtype=np.int64) * read_len
    reads = Records(
        [f"r{i}" for i in range(n_reads)], packed=(data, offsets)
    )
    seeds = stage("seeding", lambda: finder.get_seeds(reads))
    index = stage("read_index", lambda: finder.index_reads(seeds))
    res["distinct_keys"] = int(len(np.unique(index.sorted_keys)))
    if finder.pindex.fm.size < 2**31:
        arr = stage("on_path", lambda: finder.seeds_on_paths_arrays(
            seeds, index))
        res["on_hits"] = 0 if arr is None else int(len(arr))
        off = stage("off_path", lambda: finder.seeds_off_paths_arrays(
            seeds, index))
        res["off_hits"] = 0 if off is None else int(len(off))
    else:
        # measured bound (round 5): device query arrays are int32 (JAX
        # x64 is disabled), so a SINGLE index queries up to 2^31 chars
        # (~2.1 Gchar). Above that, the production route is the
        # component-sharded mesh index (parallel/distributed.py:
        # per-component FMs each < 2^31, psum'd gocc — parity in
        # tests/test_multihost.py); per-FM query numbers at this scale
        # are the 2 Gchar rows in docs/BENCH_NOTES.md.
        res["query_note"] = (
            "fm_chars >= 2^31: single-index int32 device query bound; "
            "use the component-sharded mesh route"
        )

    res["total_s"] = round(sum(
        v for kk, v in res.items() if kk.endswith("_s")), 1)
    res["peak_gb"] = round(rss_gb(), 2)
    with open(out_json, "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res, indent=1), flush=True)


if __name__ == "__main__":
    main()
