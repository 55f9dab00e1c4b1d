"""psi_tpu — a pan-genome seed-finding engine in JAX (runs on NVIDIA
GPUs and on the CPU).

A from-scratch reimplementation of the capabilities of cartoonist/psi
(Ghaffaari & Marschall, "Fully-sensitive seed finding in sequence graphs
using a hybrid index", Bioinformatics 2019) built for batched device
execution:

  * graph / sequence substrate as dense NumPy/JAX arrays (CSR adjacency,
    concatenated node labels, char-order prefix sums),
  * an FM-index over picked haplotype paths realised as dense occ tables
    queried by *batched* backward search on device,
  * the crossing-seed graph traversal realised as a frontier-parallel
    walk joined against a sorted packed k-mer array,
  * a DiVerG-style distance index realised as interval-compressed
    node-pair distance sets with batched verification.

Layer map (mirrors reference layers L0-L7, SURVEY.md §1):
  graph.py       -- L1 graph substrate        (ref: include/psi/graph.hpp + GUM)
  records.py     -- L2 sequence layer         (ref: include/psi/sequence.hpp)
  fmindex.py     -- L3 string indexes         (ref: include/psi/fmindex.hpp)
  pathutil.py    -- L4 path layer             (ref: include/psi/path_base.hpp,
                                               path_interface.hpp)
  pathset.py     -- L4 path sets / path index (ref: include/psi/pathset.hpp,
                                               pathindex.hpp)
  graphiter.py   -- L4 graph iterators        (ref: include/psi/graph_iter.hpp)
  ops/           -- L5 matching engines       (ref: include/psi/traverser_*.hpp,
                                               index_iter.hpp)
  dindex.py      -- distance index            (ref: DiVerG usage in seed_finder.hpp)
  seed_finder.py -- L6 orchestration          (ref: include/psi/seed_finder.hpp)
  cli.py         -- L7 CLI (psikt)            (ref: src/psikt.cpp)
"""

__version__ = "0.1.0"

from psi_tpu.graph import Graph  # noqa: F401
from psi_tpu.seed import Seed  # noqa: F401
