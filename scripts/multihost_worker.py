"""One process of an N-process jax.distributed run (CPU backend,
4 virtual devices per process).

Drives the REAL distributed query path end-to-end over a DCN-spanning
global mesh: component-sharded counting (psum'd gocc) and data-parallel
trie search, verifying both against a host-side global FM oracle.
Process 0 writes a JSON result (parity flags + wall times) to argv[4].

Usage: multihost_worker.py PORT PROC_ID NPROC OUT_JSON

The same script with NPROC=1 is the single-process baseline for the
scaling-efficiency measurement: the GLOBAL device count is fixed at 8
(8/nproc virtual devices per process), so equal total devices and
physical cores make the 1-proc/2-proc wall-time ratio isolate the
multi-process/DCN overhead; true weak scaling needs real extra hosts.
"""

import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

TOTAL_DEVS = 8


def main():
    port, pid, nproc, out = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    devs_per_proc = TOTAL_DEVS // nproc
    inherited = [
        f for f in os.environ.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    ]
    os.environ["XLA_FLAGS"] = " ".join(
        [f"--xla_force_host_platform_device_count={devs_per_proc}"]
        + inherited
    )
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from psi_tpu.parallel.distributed import initialize_multihost

    if nproc > 1:
        initialize_multihost(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()
    n_devices = TOTAL_DEVS
    assert jax.device_count() == n_devices, jax.device_count()

    from jax.sharding import Mesh

    from psi_tpu.fmindex import FMIndex
    from psi_tpu.ops.fm import keys_to_codes
    from psi_tpu.ops.fm_trie import build_stream_arrays
    from psi_tpu.parallel.distributed import (
        build_sharded_index, sharded_count,
    )
    from psi_tpu.parallel.mesh import sharded_trie_search

    # deterministic inputs (identical on every process)
    rng = np.random.RandomState(42)
    shard_strings = [
        ["".join(rng.choice(list("ACGT"), size=2000)) for _ in range(2)]
        for _ in range(n_devices)
    ]
    fms = [
        FMIndex.build_from_strings([s[::-1] for s in g])
        for g in shard_strings
    ]
    all_strings = [s for g in shard_strings for s in g]
    fm_all = FMIndex.build_from_strings([s[::-1] for s in all_strings])

    k = 12
    n_queries = 4096
    kmers = []
    for _ in range(n_queries):
        s = all_strings[rng.randint(len(all_strings))]
        st = rng.randint(0, len(s) - k + 1)
        kmers.append(s[st: st + k])
    lut = {c: i for i, c in enumerate("ACGT")}
    keys = np.array(
        [sum(lut[c] << (2 * (k - 1 - j)) for j, c in enumerate(km))
         for km in kmers],
        dtype=np.uint64,
    )
    ukeys = np.unique(keys)
    codes = keys_to_codes(ukeys, k)

    def decode(key):
        return "".join(
            "ACGT"[(int(key) >> (2 * (k - 1 - j))) & 3] for j in range(k)
        )

    expect = np.array([fm_all.count(decode(key)[::-1]) for key in ukeys])

    devs = np.asarray(jax.devices())

    # --- component-sharded counting over the global shard axis ---
    mesh_s = Mesh(devs, ("shard",))
    arrays = build_sharded_index(fms, mesh_s)
    t0 = time.monotonic()
    total, lo_loc, hi_loc = sharded_count(mesh_s, arrays, codes)
    t_count = time.monotonic() - t0
    count_ok = bool(np.array_equal(total, expect))

    # --- data-parallel trie search over the global data axis ---
    mesh_d = Mesh(devs, ("data",))
    sarr = build_stream_arrays(fm_all)
    t0 = time.monotonic()
    lo, hi = sharded_trie_search(mesh_d, sarr, ukeys, k)
    t_trie = time.monotonic() - t0
    trie_ok = bool(np.array_equal((hi - lo).astype(np.int64), expect))

    # steady-state timing (arrays resident, kernels compiled)
    t0 = time.monotonic()
    for _ in range(3):
        sharded_count(mesh_s, arrays, codes)
    t_count_warm = (time.monotonic() - t0) / 3
    t0 = time.monotonic()
    for _ in range(3):
        sharded_trie_search(mesh_d, sarr, ukeys, k)
    t_trie_warm = (time.monotonic() - t0) / 3

    # --- the PRODUCTION SeedFinder pipeline on the DCN-spanning mesh ---
    # (seeding -> prepare_onpath -> sharded on-path trie + loci-sharded
    # off-path traversal -> hit emission), bit-identical to the
    # single-device finder on every process
    from psi_tpu.graph import Graph
    from psi_tpu.records import Records
    from psi_tpu.seed_finder import SeedFinder

    # PSI_MH_SCALE=big runs the phase at a DCN-VISIBLE shape
    # (>=1e5 distinct keys, >=1e3 starting loci; the VERDICT r3 #10
    # done-criterion) with per-phase timings; default stays CI-sized
    big = os.environ.get("PSI_MH_SCALE") == "big"
    rng2 = np.random.RandomState(5)
    if big:
        seed_len = 20
        n_reads, read_len = 200_000, 100
        refs = ["".join(rng2.choice(list("ACGT"), size=1_000_000))
                for _ in range(2)]
        nodes, edges, paths = {}, [], []
        nid = 0
        for i, s in enumerate(refs):
            segs = len(s) // 50_000
            seg_len = len(s) // segs
            pn = []
            prev = None
            for j in range(segs):
                nid += 1
                end = (j + 1) * seg_len if j + 1 < segs else len(s)
                nodes[nid] = s[j * seg_len: end]
                pn.append(nid)
                if prev is not None:
                    edges.append((prev, nid))
                    nid += 1
                    nodes[nid] = "".join(
                        rng2.choice(list("ACGT"), size=30)
                    )
                    edges.append((prev, nid))
                    edges.append((nid, pn[-1]))
                prev = pn[-1]
            paths.append((f"ref{i}", pn))
        g = Graph.from_parts(nodes=nodes, edges=edges, paths=paths)
        src = rng2.randint(0, len(refs), size=n_reads)
        starts = rng2.randint(0, 1_000_000 - read_len, size=n_reads)
        reads = Records(
            [f"r{i}" for i in range(n_reads)],
            [refs[s][p: p + read_len] for s, p in zip(src, starts)],
        )
    else:
        seed_len = 12
        seq = "".join(rng2.choice(list("ACGT"), size=3000))
        g = Graph.from_parts(
            nodes={1: seq[:1500], 2: seq[1500:],
                   3: "ACGTAGGTACGTTCGTACGATTAG"},
            edges=[(1, 2), (1, 3), (3, 2)],
            paths=[("ref", [1, 2])],
        )
        branch = (g.node_sequence(1)[-6:] + g.node_sequence(3)
                  + g.node_sequence(2)[:10])
        reads = Records(
            [f"r{i}" for i in range(32)] + ["b0"],
            [seq[i * 61: i * 61 + 48] for i in range(32)] + [branch],
        )
    os.environ["PSI_STREAM"] = "1"

    def run_finder(devices):
        f = SeedFinder(g, seed_len=seed_len, devices=devices)
        f.create_path_index(n=1, patched=False)
        f.add_uncovered_loci()
        seeds = f.get_seeds(reads)
        index = f.index_reads(seeds)
        f.prepare_onpath(index)
        return f, seeds, index

    t0 = time.monotonic()
    f_m, seeds_m, index_m = run_finder("auto")
    t_build = time.monotonic() - t0
    assert f_m._get_mesh() is not None
    n_loci = len(f_m.get_starting_loci())
    n_keys_pipe = int(len(np.unique(index_m.sorted_keys)))
    t0 = time.monotonic()
    hits_m = f_m.seeds_all_arrays(seeds_m, index_m)
    t_pipeline = time.monotonic() - t0
    f_1, seeds_1, index_1 = run_finder(1)
    hits_1 = f_1.seeds_all_arrays(seeds_1, index_1)
    key = ["node_id", "node_offset", "read_id", "read_offset",
           "match_len", "gocc"]
    mh_emit = os.environ.get("PSI_MH_EMIT", "shard")
    if nproc > 1 and mh_emit != "full":
        # process-sharded emission: every process holds a disjoint
        # slice of the hit stream; merge = concatenation. Verify the
        # merged multiset on process 0.
        np.save(f"{out}.hits{pid}.npy", hits_m)
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("emit_done")
        if pid == 0:
            hits_merged = np.concatenate([
                np.load(f"{out}.hits{q}.npy") for q in range(nproc)
            ])
            pipeline_ok = bool(
                np.array_equal(np.sort(hits_merged, order=key),
                               np.sort(hits_1, order=key))
            ) and len(hits_merged) > 0
            hits_m = hits_merged
        else:
            pipeline_ok = True
    else:
        pipeline_ok = bool(
            np.array_equal(np.sort(hits_m, order=key),
                           np.sort(hits_1, order=key))
        ) and len(hits_m) > 0
    # warm per-phase split: prepare (host schedule + upload), on-path,
    # off-path — each timed separately on the mesh finder
    reps = 1 if big else 3
    t0 = time.monotonic()
    for _ in range(reps):
        f_m.prepare_onpath(index_m)
    t_prepare_warm = (time.monotonic() - t0) / reps
    t0 = time.monotonic()
    for _ in range(reps):
        f_m.seeds_on_paths_arrays(seeds_m, index_m)
    t_onpath_warm = (time.monotonic() - t0) / reps
    t0 = time.monotonic()
    for _ in range(reps):
        f_m.seeds_off_paths_arrays(seeds_m, index_m)
    t_offpath_warm = (time.monotonic() - t0) / reps
    t_pipeline_warm = t_prepare_warm + t_onpath_warm + t_offpath_warm

    if pid == 0:
        with open(out, "w") as fh:
            json.dump(
                {
                    "nproc": nproc,
                    "devices": n_devices,
                    "count_ok": count_ok,
                    "trie_ok": trie_ok,
                    "n_keys": int(len(ukeys)),
                    "t_count": t_count,
                    "t_trie": t_trie,
                    "t_count_warm": t_count_warm,
                    "t_trie_warm": t_trie_warm,
                    "pipeline_ok": pipeline_ok,
                    "pipeline_hits": int(len(hits_m)),
                    "pipeline_keys": n_keys_pipe,
                    "pipeline_loci": n_loci,
                    "t_build": t_build,
                    "t_pipeline": t_pipeline,
                    "t_pipeline_warm": t_pipeline_warm,
                    "t_prepare_warm": t_prepare_warm,
                    "t_onpath_warm": t_onpath_warm,
                    "t_offpath_warm": t_offpath_warm,
                    "scale": "big" if big else "ci",
                    "mh_emit": mh_emit if nproc > 1 else "n/a",
                },
                fh,
            )
    return 0 if (count_ok and trie_ok and pipeline_ok) else 1


if __name__ == "__main__":
    sys.exit(main())
