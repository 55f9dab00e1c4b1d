"""Run ONLY the sustained pipeline leg of bench.py (same workload,
same chunk/threading structure) for fast iteration. Prints the
per-chunk leg table.

Usage: python scripts/bench_sustained_only.py
Knobs: PSI_BENCH_MB / PSI_BENCH_K / PSI_BENCH_CHUNKS / PSI_BENCH_READS
"""

import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np


def main():
    size_mb = float(os.environ.get("PSI_BENCH_MB", "4"))
    k = int(os.environ.get("PSI_BENCH_K", "20"))
    n_chunks = int(os.environ.get("PSI_BENCH_CHUNKS", "6"))
    reads_per_chunk = int(os.environ.get("PSI_BENCH_READS", "100000"))

    from psi_tpu.cache import enable_compile_cache

    enable_compile_cache()

    import bench

    if os.environ.get("PSI_BENCH_NO_OFFPATH"):
        # attribution runs: clear the uncovered loci after the build so
        # the off-path traversal leg drops out of the chunk pipeline
        import psi_tpu.seed_finder as _sf

        _orig = _sf.SeedFinder.add_uncovered_loci

        def _nop(self, *a, **kw):
            _orig(self, *a, **kw)
            self.starting_loci = []

        _sf.SeedFinder.add_uncovered_loci = _nop

    rng = np.random.RandomState(42)
    n_paths = 4
    path_len = int(size_mb * 1e6 / n_paths)
    strings = [
        "".join(rng.choice(list("ACGT"), size=path_len))
        for _ in range(n_paths)
    ]
    t0 = time.monotonic()
    out = bench.bench_sustained(strings, k, n_chunks, reads_per_chunk)
    keys_s, seeds_s, hits, n_loci, off_hits = out
    print(
        f"sustained {keys_s:.0f} keys/s ({seeds_s:.0f} seeds/s), "
        f"total {time.monotonic()-t0:.1f}s"
    )


if __name__ == "__main__":
    main()
