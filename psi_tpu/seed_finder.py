"""SeedFinder — the orchestration layer (ref: include/psi/seed_finder.hpp).

Pipeline: pick paths -> index paths (FM over reversed path sequences) ->
detect uncovered starting loci -> build distance index; then per read
chunk: seeding -> index seeds -> seeds_on_paths (batched FM route) +
seeds_off_paths (frontier traversal route).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np

from psi_tpu.dindex import DistanceIndex
from psi_tpu.graph import Graph, Position
from psi_tpu.graphiter import BacktrackerIter, BFSIter, HaplotyperIter
from psi_tpu.pathset import PathIndex, get_uniq_haplotype
from psi_tpu.pathutil import Path, trim_back
from psi_tpu.records import Records, SeedSet, SeedsIndex, seeding
from psi_tpu.seed import SEED_DTYPE, Seed
from psi_tpu.stats import NoStats, ProgressEnum, SeedFinderStats
from psi_tpu.graphiter import extend_to_k


class SeedFinder:
    """(ref: seed_finder.hpp:930-942 ctor; query methods are const /
    side-effect-free so chunks can be processed concurrently)."""

    def __init__(
        self,
        graph: Graph,
        seed_len: int,
        gocc_threshold: int = 0,
        max_mem: int = 0,
        seed_mismatches: int = 0,
        stats: Optional[SeedFinderStats] = None,
        rng_seed: int = 0,
        devices: Optional[object] = None,
    ):
        self.graph = graph
        self.seed_len = seed_len
        self.gocc_threshold = gocc_threshold
        self.max_mem = max_mem
        # working mismatch-tolerant traversal (the reference declares but
        # never implements ApproxMatching; ref: traverser_base.hpp:98-101)
        self.seed_mismatches = seed_mismatches
        self.stats = stats if stats is not None else NoStats()
        self.pindex = PathIndex(graph)
        self.starting_loci: List[Position] = []
        self.dindex = DistanceIndex(0, 0)
        self.d = (0, 0)
        self._rng_seed = rng_seed
        #: device-mesh request: None = env PSI_DEVICES (default: all
        #: devices on accelerator backends, single-device on CPU);
        #: "auto" = all local devices; int N = first N devices
        self._devices_req = devices
        self._mesh = None
        # device-side caches (built lazily)
        self._fm_arrays = None
        self._graph_arrays = None
        self._path_map = None
        self._map_arrays = None
        self._stream_arrays = None
        self._ftab_np = None
        self._ftab_d = None  # device-resident ftab (mask wire format)
        self._trav_tree = None  # (fingerprint, WalkTree | False)
        import threading

        self._prep_lock = threading.Lock()

    # === device mesh (multi-chip scale-out, SURVEY §2.3) ====================
    def _get_mesh(self):
        """Lazy 1-D "data" mesh over the local devices. The production
        query pipeline (on-path trie search AND off-path traversal)
        shards over it whenever it spans > 1 device — the reference's
        single-process chunk loop (ref: src/psikt.cpp:183-209) scaled
        out. Selection: the `devices` ctor arg, else PSI_DEVICES
        ("auto" or a count), else all GPUs / one CPU device (virtual
        CPU meshes are opt-in)."""
        if self._mesh is False:
            return None
        if self._mesh is None:
            from psi_tpu import platform

            dev = platform.active()
            req = self._devices_req
            if req is None:
                req = os.environ.get("PSI_DEVICES")
            if req is None:
                n = dev.count if dev.platform == "gpu" else 1
            elif str(req) == "auto":
                n = dev.count
            else:
                n = int(req)
            n = max(min(n, dev.count), 1)
            if n <= 1:
                self._mesh = False
                return None
            from psi_tpu.parallel.mesh import device_mesh

            self._mesh = device_mesh(n)
        return self._mesh

    # === path picking =======================================================
    def _set_context(self, context: int, patched: bool) -> int:
        """(ref: seed_finder.hpp:1772-1787)"""
        if not patched:
            context = 0
        if patched and context == 0:
            context = self.seed_len
        self.pindex.set_context(context)
        return context

    def pick_paths(
        self,
        n: int,
        patched: bool = True,
        context: int = 0,
        progress: Optional[Callable[[str, int], None]] = None,
    ):
        """Pick n paths per region / reference path
        (ref: seed_finder.hpp:1138-1167)."""
        if n == 0:
            return
        if self.graph.get_path_count() == 0:
            raise RuntimeError("no reference path found in the input graph")
        self.stats.set_progress(ProgressEnum.SELECT_PATHS)
        with self.stats.timeit_ts("pick-paths"):
            context = self._set_context(context, patched)
            from psi_tpu import native

            if native.available() and not os.environ.get("PSI_PY_PICK"):
                region_starts = np.array(
                    [int(nodes[0]) for _, (name, nodes) in
                     self.graph.for_each_path()],
                    dtype=np.int64,
                )
                res = native.pick_paths(
                    np.diff(self.graph.label_offsets),
                    self.graph.out_indptr,
                    self.graph.out_indices,
                    region_starts,
                    n, context, patched,
                    np.random.RandomState(self._rng_seed),
                )
                if res is not None:
                    indptr, nodes_flat, lefts, rights = res
                    for i in range(len(lefts)):
                        self.pindex.push_back(
                            Path(
                                self.graph,
                                nodes_flat[indptr[i]: indptr[i + 1]].tolist(),
                                int(lefts[i]),
                                int(rights[i]),
                            )
                        )
                    return
            hp = HaplotyperIter(
                self.graph, rng=np.random.RandomState(self._rng_seed)
            )
            for path_rank, (name, nodes) in self.graph.for_each_path():
                start = int(nodes[0])
                hp.reset(start)
                for i in range(n):
                    if progress:
                        progress(name, i + 1)
                    get_uniq_haplotype(self.pindex, hp, context, patched)

    def index_paths(self):
        """(ref: seed_finder.hpp:1169-1176)"""
        self.stats.set_progress(ProgressEnum.CREATE_PINDEX)
        with self.stats.timeit_ts("index-paths"):
            self.pindex.create_index()
            self._build_path_map()
            self._fm_arrays = None
            self._map_arrays = None
            self._stream_arrays = None
            self._ftab_np = None

    def _build_path_map(self):
        """Flat arrays mapping a global forward path position to
        (node_id, node_offset) — the batched equivalent of
        Path::rank/select (ref: pathindex.hpp:360-416)."""
        pset = self.pindex.get_paths_set()
        lengths = np.array([p.get_sequence_len() for p in pset], dtype=np.int64)
        seq_off = np.zeros(len(pset) + 1, dtype=np.int64)
        np.cumsum(lengths, out=seq_off[1:])
        starts_l, ids_l, base_l = [], [], []
        for pidx, path in enumerate(pset):
            node_starts = path._node_starts()[:-1] + seq_off[pidx]
            starts_l.append(node_starts)
            ids_l.append(np.asarray(path.get_nodes(), dtype=np.int64))
            base = np.zeros(len(path.get_nodes()), dtype=np.int64)
            if len(base):
                base[0] = path.get_head_offset()
            base_l.append(base)
        self._path_map = {
            "lengths": lengths,
            "seq_off": seq_off,
            "starts": np.concatenate(starts_l) if starts_l else np.zeros(0, np.int64),
            "ids": np.concatenate(ids_l) if ids_l else np.zeros(0, np.int64),
            "base": np.concatenate(base_l) if base_l else np.zeros(0, np.int64),
        }

    # === uncovered loci =====================================================
    def add_start(self, node_id: int, offset: int = None):
        if offset is None:
            self.starting_loci.append(node_id)  # Position instance
        else:
            self.starting_loci.append(Position(node_id, offset))
        self.stats.total_loci = len(self.starting_loci)

    def get_starting_loci(self) -> List[Position]:
        return self.starting_loci

    def set_starting_loci(self, loci):
        self.starting_loci = list(loci)

    def add_uncovered_loci(self, step: int = 1):
        """Detect loci whose k-context is not fully covered by the path set
        (exact mirror of ref: seed_finder.hpp:1481-1541). Uses the native
        OpenMP scanner (native/psi_uncovered.cpp) when available."""
        pathset = self.pindex.get_paths_set()
        if len(pathset) == 0:
            self.add_all_loci(step)
            return
        self.stats.set_progress(ProgressEnum.FIND_UNCOVERED)

        from psi_tpu import native

        if native.available():
            with self.stats.timeit_ts("find-uncovered"):
                paths_nodes = []
                paths_indptr = [0]
                for p in pathset:
                    paths_nodes.extend(p.get_nodes())
                    paths_indptr.append(len(paths_nodes))
                res = native.uncovered_loci(
                    np.diff(self.graph.label_offsets),
                    self.graph.out_indptr,
                    self.graph.out_indices,
                    np.asarray(paths_nodes, dtype=np.int64),
                    np.asarray(paths_indptr, dtype=np.int64),
                    self.seed_len,
                    step,
                )
                if res is not None:
                    node_ids, offsets = res
                    for nid, off in zip(node_ids, offsets):
                        self.add_start(int(nid), int(off))
                    return
        self._add_uncovered_loci_py(step)

    def _add_uncovered_loci_py(self, step: int = 1):
        pathset = self.pindex.get_paths_set()
        with self.stats.timeit_ts("find-uncovered"):
            g = self.graph
            k = self.seed_len
            bt = BacktrackerIter(g)
            trav_path = Path(g)
            bv_starts = np.zeros(g.max_node_len(), dtype=bool)

            for rank in range(1, g.node_count + 1):
                nid = g.rank_to_id(rank)
                label_len = g.node_length(nid)
                offset = label_len

                bt.reset(nid)
                while not bt.at_end() and offset != 0:
                    extend_to_k(trav_path, bt, offset - 1 + k)
                    current_path = None
                    if trav_path.get_sequence_len() >= k:
                        current_path = Path(
                            g, list(trav_path.get_nodes()),
                            trav_path.left, trav_path.right,
                        )
                    while (
                        current_path is not None
                        and current_path.get_sequence_len() != 0
                        and not pathset.covered_by(current_path.get_nodes())
                    ):
                        trimmed_len = current_path.get_sequence_len() - g.node_length(
                            current_path.get_nodes()[-1]
                        )
                        if trimmed_len <= k - 1:
                            offset = 0
                            break
                        offset = trimmed_len - k + 1
                        trim_back(current_path)
                    f = offset
                    while (
                        f < label_len
                        and f + k < trav_path.get_sequence_len() + 1
                    ):
                        bv_starts[f] = True
                        f += step

                    bt.backtrack()
                    trim_back(trav_path, bt.value if bt.value is not None else 0)

                for f in range(label_len):
                    if bv_starts[f]:
                        bv_starts[f] = False
                        self.add_start(nid, f)

                trav_path.clear()

    def add_all_loci(self, step: int = 1):
        """Step-preserving all-loci fallback via BFS levels
        (ref: seed_finder.hpp:1543-1585)."""
        self.stats.set_progress(ProgressEnum.FIND_UNCOVERED)
        with self.stats.timeit_ts("find-uncovered"):
            bfs = BFSIter(self.graph)
            prenode_remain = 0
            remain_estimate = 0
            prenode_level = 0
            while not bfs.at_end():
                if prenode_level != bfs.level():
                    prenode_remain = remain_estimate
                    remain_estimate = 0
                    prenode_level = bfs.level()
                seq_len = self.graph.node_length(bfs.value)
                cursor = (step - prenode_remain) % step
                while cursor < seq_len:
                    self.add_start(bfs.value, cursor)
                    cursor += step
                if step - prenode_remain > seq_len:
                    new_remain = prenode_remain + seq_len
                else:
                    new_remain = (seq_len - step + prenode_remain) % step
                if remain_estimate < new_remain:
                    remain_estimate = new_remain
                bfs.next()

    def get_nof_uniq_nodes(self) -> int:
        return len({l.node_id() for l in self.starting_loci})

    # === distance index =====================================================
    def create_distance_index(
        self, dmin: int, dmax: int, per_component: bool = True
    ):
        """(ref: seed_finder.hpp:1193-1265)"""
        if dmin == 0 or (dmax != 0 and dmax < dmin):
            return
        if dmax == 0:
            dmax = dmin
        self.stats.set_progress(ProgressEnum.CREATE_DINDEX)
        with self.stats.timeit_ts("index-distances"):
            self.dindex = DistanceIndex.build(
                self.graph, dmin, dmax, per_component
            )
            self.d = (dmin, dmax)

    def verify_distance(self, v: int, o: int, u: int, p: int) -> bool:
        with self.stats.timeit_ts("query-dindex"):
            return self.dindex.verify(self.graph, v, o, u, p)

    def save_distance_index(self, prefix: str) -> bool:
        if self.dindex.empty and self.d == (0, 0):
            return True
        with self.stats.timeit_ts("save-dindex"):
            self.dindex.save(self.get_dindex_path(prefix, *self.d))
        return True

    def open_distance_index(self, prefix: str, dmin: int = 0, dmax: int = 0) -> bool:
        if dmax == 0:
            dmax = dmin
        self.d = (dmin, dmax)
        path = self.get_dindex_path(prefix, dmin, dmax)
        if not os.path.exists(path):
            return False
        with self.stats.timeit_ts("load-dindex"):
            self.dindex = DistanceIndex.load(path)
        return True

    # === artifact paths (naming parity, ref: seed_finder.hpp:877-892) ======
    @staticmethod
    def get_dindex_path(prefix: str, dmin: int, dmax: int) -> str:
        return f"{prefix}_dist_mat_m{dmin}M{dmax}.npz"

    @staticmethod
    def get_sloci_filepath(prefix: str, seed_len: int, step: int) -> str:
        return f"{prefix}_loci_e{step}l{seed_len}"

    # === starting loci persistence ==========================================
    def save_starts(self, prefix: str, seed_len: int, step: int) -> bool:
        """Store in *external* (coordinate) ids
        (ref: seed_finder.hpp:1659-1679)."""
        path = self.get_sloci_filepath(prefix, seed_len, step)
        self.stats.set_progress(ProgressEnum.WRITE_STARTS)

        def coord(nid):  # identity for ids outside the graph (mirrors gum)
            return self.graph.coordinate_id(nid) if self.graph.has_node(nid) else nid

        with self.stats.timeit_ts("save-starts"):
            arr = np.array(
                [(coord(l.node_id()), l.offset()) for l in self.starting_loci],
                dtype=np.int64,
            ).reshape(-1, 2)
            np.save(path + ".npy", arr)
        return True

    def open_starts(self, prefix: str, seed_len: int, step: int) -> bool:
        path = self.get_sloci_filepath(prefix, seed_len, step) + ".npy"
        if not os.path.exists(path):
            return False
        self.stats.set_progress(ProgressEnum.LOAD_STARTS)
        def internal(cid):
            try:
                return self.graph.id_by_coordinate(cid)
            except KeyError:
                return cid

        with self.stats.timeit_ts("load-starts"):
            arr = np.load(path)
            self.starting_loci = [
                Position(internal(int(c)), int(o)) for c, o in arr
            ]
        return True

    # === full index lifecycle ==============================================
    def create_path_index(
        self,
        n: int,
        patched: bool = True,
        context: int = 0,
        step_size: int = 1,
        dmin: int = 0,
        dmax: int = 0,
        per_component: bool = True,
    ):
        """(ref: seed_finder.hpp:1330-1355)"""
        self.pick_paths(n, patched, context)
        self.index_paths()
        self.add_uncovered_loci(step_size)
        self.create_distance_index(dmin, dmax, per_component)

    def serialize_path_index(self, prefix: str, step_size: int = 1) -> bool:
        if not prefix:
            return False
        self.stats.set_progress(ProgressEnum.WRITE_PINDEX)
        with self.stats.timeit_ts("save-pindex"):
            self.pindex.save(prefix)
        return (
            self.save_starts(prefix, self.seed_len, step_size)
            and self.save_distance_index(prefix)
        )

    def load_path_index(
        self,
        prefix: str,
        context: int = 0,
        step_size: int = 1,
        dmin: int = 0,
        dmax: int = 0,
    ) -> bool:
        """Transparently rebuilds missing starts/dindex artifacts
        (ref: seed_finder.hpp:1396-1413)."""
        if not prefix:
            return False
        self.stats.set_progress(ProgressEnum.LOAD_PINDEX)
        with self.stats.timeit_ts("load-pindex"):
            self.pindex.set_context(context)
            if not self.pindex.load(prefix):
                return False
            self._build_path_map()
            self._fm_arrays = None
            self._map_arrays = None
            self._stream_arrays = None
            self._ftab_np = None
        if not self.open_starts(prefix, self.seed_len, step_size):
            self.add_uncovered_loci(step_size)
            self.save_starts(prefix, self.seed_len, step_size)
        if not self.open_distance_index(prefix, dmin, dmax):
            self.create_distance_index(dmin, dmax, True)
            self.save_distance_index(prefix)
        return True

    # === per-chunk query machinery ==========================================
    def get_seeds(self, reads: Records, distance: int = 0) -> SeedSet:
        """(ref: seed_finder.hpp:1099-1109; distance==0 -> non-overlapping)"""
        self.stats.get_this_thread_stats().set_progress(ProgressEnum.SEED_CHUNK)
        with self.stats.timeit_ts("seeding"):
            if distance == 0:
                distance = self.seed_len
            return seeding(reads, self.seed_len, distance)

    def index_reads(self, seeds: SeedSet) -> SeedsIndex:
        """(ref: seed_finder.hpp:1089-1097)"""
        self.stats.get_this_thread_stats().set_progress(ProgressEnum.INDEX_CHUNK)
        with self.stats.timeit_ts("index-reads"):
            return SeedsIndex(seeds)

    # --- device array caches ------------------------------------------------
    #: dense per-position occ table budget (bytes); texts whose dense
    #: table fits use the gather-only rank fast path
    DENSE_OCC_BUDGET = int(os.environ.get("PSI_DENSE_OCC_BUDGET", 2 << 30))
    #: largest prefix-table depth (4**p SA-range rows; 11 -> 32 MB)
    FTAB_MAX_BITS = int(os.environ.get("PSI_FTAB_MAX_BITS", 11))

    def _ftab_bits(self) -> int:
        """Prefix-table depth: one ftab gather replaces the first p LF
        steps of every k-mer query. Sized so the table never dwarfs the
        text (p <= log4 n) and never exceeds the seed length."""
        env = os.environ.get("PSI_FTAB_BITS")
        if env is not None:
            # clamp: depths beyond the seed length are never consulted,
            # and 4**p rows past ~13 would swamp host memory
            return max(min(int(env), self.seed_len, 13), 0)
        n = self.pindex.fm.size
        log4 = max((int(n).bit_length() - 1) // 2, 0)
        return max(min(self.FTAB_MAX_BITS, self.seed_len, log4), 0)

    def _get_fm_arrays(self):
        if self._fm_arrays is None and self.pindex.fm is not None:
            from psi_tpu import platform
            from psi_tpu.ops import fm as fm_ops

            # layout by platform: the dense per-position occ (16 B per
            # text position) wins on CPU (hardware-prefetched gathers);
            # on the GPU the 8x smaller bit-plane layout keeps device
            # memory for the SA (dense vs bit-plane on the GPU: not
            # measured)
            on_cpu = platform.active().platform == "cpu"
            dense = on_cpu and (
                self.pindex.fm.size * 16 <= self.DENSE_OCC_BUDGET
            )
            self._fm_arrays = fm_ops.to_device(
                self.pindex.fm,
                dense_occ=dense,
                bitplanes=not dense,
                ftab_bits=self._ftab_bits(),
            )
        return self._fm_arrays

    def _stream_enabled(self) -> bool:
        """Trie-batched on-path search (ops/fm_trie.py): default ON on
        the GPU and whenever a multi-device mesh is active (the sharded
        on-path route runs through it); PSI_STREAM=1/0 overrides. On
        one CPU device the dense-occ gather route is the default."""
        env = os.environ.get("PSI_STREAM")
        if env is not None:
            return env not in ("", "0")
        from psi_tpu import platform

        if platform.on_gpu():
            return True
        return self._get_mesh() is not None

    def _get_stream_arrays(self):
        if self._stream_arrays is None:
            from psi_tpu.ops import fm_trie

            self._stream_arrays = fm_trie.build_stream_arrays(
                self.pindex.fm
            )
        return self._stream_arrays

    def _get_ftab(self):
        """Lazy prefix table; thread-safe (producer thread calls this)."""
        if self._ftab_np is None:
            with self._prep_lock:
                if self._ftab_np is None:
                    from psi_tpu.ops import fm as fm_ops

                    bits = self._ftab_bits()
                    self._ftab_np = (
                        fm_ops.build_ftab(self.pindex.fm, bits)
                        if bits
                        else False
                    )
        return self._ftab_np if self._ftab_np is not False else None

    def _onpath_search_keys(self, index: SeedsIndex):
        """The deterministic key pipeline of the on-path route: distinct
        seed k-mers (+ Hamming-ball expansion under --mismatches) and
        the maps back to seed groups."""
        uniq_keys, uniq_start = np.unique(index.sorted_keys, return_index=True)
        if self.seed_mismatches:
            from psi_tpu.ops.kmers import expand_hamming

            search_keys, origin = expand_hamming(
                uniq_keys, self.seed_len, self.seed_mismatches
            )
        else:
            search_keys = uniq_keys
            origin = np.arange(len(uniq_keys), dtype=np.int64)
        return uniq_keys, uniq_start, search_keys, origin

    def prepare_onpath(self, index: SeedsIndex) -> None:
        """Precompute the on-path trie plan (schedule + padding + device
        transfer) for a chunk. Query methods are side-effect-free, so
        this can run on the producer thread, overlapped with device
        compute of the previous chunk — it removes the host schedule
        build from the critical path entirely."""
        if index.size == 0 or not self._stream_enabled():
            return
        if self.pindex.fm is None or self.pindex.fm.size == 0:
            return
        from psi_tpu.ops import fm_trie

        _, _, search_keys, _ = self._onpath_search_keys(index)
        uniq, inv = np.unique(search_keys, return_inverse=True)
        mesh = self._get_mesh()
        if mesh is not None:
            from psi_tpu.parallel.mesh import prepare_trie_sharded

            prepared = prepare_trie_sharded(
                mesh, uniq, self.seed_len, self.pindex.fm.size,
                self._get_ftab(),
            )
        else:
            prepared = fm_trie.prepare(uniq, self.seed_len, self._get_ftab())
        index._onpath_prep = (uniq, inv, prepared)

    def _search_stream(self, search_keys: np.ndarray, k: int, prep=None):
        """Trie-batched backward search (frontier level extension over
        distinct sorted keys; ops/fm_trie.py).

        search_keys may be unsorted or contain duplicates (Hamming-ball
        expansion); results are returned in input order. `prep` is a
        (uniq, inv, PreparedTrie) tuple from `prepare_onpath`.

        Returns (lo, hi, local_mask): local_mask is None except under
        process-sharded multihost emission, where it marks the search
        rows whose distinct key lives on THIS process's device shards
        (the caller restricts emission to them; the merged stream is
        the concatenation of the processes' disjoint streams).
        """
        import jax

        from psi_tpu.ops import fm_trie

        if prep is not None:
            uniq, inv, prepared = prep
        else:
            uniq, inv = np.unique(search_keys, return_inverse=True)
            prepared = None
        sarr = self._get_stream_arrays()
        mesh = self._get_mesh()
        lmask = None
        if mesh is not None:
            from psi_tpu.parallel import mesh as mesh_mod

            if prepared is not None and not isinstance(
                prepared, mesh_mod.ShardedPreparedTrie
            ):
                prepared = None  # plan was built single-device; rebuild
            if prepared is None:
                prepared = mesh_mod.prepare_trie_sharded(
                    mesh, uniq, k, self.pindex.fm.size, self._get_ftab()
                )
            lo, hi = mesh_mod.sharded_trie_search(
                mesh, sarr, uniq, k, ftab=self._get_ftab(),
                prepared=prepared,
            )
            if self._mh_emit_sharded():
                pid = jax.process_index()
                m_u = np.zeros(len(uniq), dtype=bool)
                per = prepared.per
                for d, dev in enumerate(mesh.devices.flat):
                    if dev.process_index == pid and prepared.sizes[d]:
                        m_u[d * per: d * per + prepared.sizes[d]] = True
                lmask = m_u[inv]
        else:
            lo, hi = fm_trie.trie_search(
                sarr, uniq, k, ftab=self._get_ftab(), prepared=prepared,
            )
        return lo[inv], hi[inv], lmask

    def _chain_join(self, counts, emit, inv, occ_start_u, gpos_stream):
        """The deterministic seed join shared by the single-device and
        sharded chains: the device's gpos stream is ordered by (pattern
        slot, SA rank) — per-uniq segments are located from counts
        alone, then mapped to (node, offset) by one host searchsorted.

        When the native library is loaded the join is deferred: the raw
        (occ_start_u, gpos_stream, inv) triple is returned for
        psi_emit_join to fuse with the seed cross-product in one
        OpenMP pass (the consumer in _seeds_on_paths_impl dispatches
        on the "raw" tag)."""
        from psi_tpu import native

        if native.available() and hasattr(native._load(), "psi_emit_join"):
            # the emit mask rides along: in process-sharded emission it
            # is restricted to this process's key shards and MUST be the
            # one the native join uses (the outer emit is global)
            return ("raw", occ_start_u, gpos_stream, inv, emit)
        pm = self._path_map
        emit_idx = np.nonzero(emit)[0]
        widths = counts[emit]
        total = int(widths.sum())
        occ_rows = np.repeat(np.arange(len(widths)), widths)
        within = np.arange(total) - np.repeat(
            np.cumsum(widths) - widths, widths
        )
        u_per = inv[emit_idx][occ_rows]
        gpos = gpos_stream[occ_start_u[u_per] + within]
        entry = np.searchsorted(pm["starts"], gpos, side="right") - 1
        node_ids = pm["ids"][entry]
        node_offs = gpos - pm["starts"][entry] + pm["base"][entry]
        return emit_idx, occ_rows, node_ids, node_offs

    def _emit_join_native(self, counts, emit, inv, origin, occ_start_u,
                          gpos_stream, index, seeds, uniq_start,
                          uniq_end, k):
        """Fused emission for the chain route: one native pass walks
        each emitted row's gpos segment, binary-searches the path map,
        and writes the seed cross-product directly as SEED_DTYPE rows.
        Row order is identical to the NumPy join + cross-product."""
        from psi_tpu import native

        pm = self._path_map
        emit_idx = np.nonzero(emit)[0]
        widths = counts[emit_idx].astype(np.int64)
        ns = (uniq_end - uniq_start)[origin[emit_idx]].astype(np.int64)
        rows_per = widths * ns
        out_off = np.zeros(len(emit_idx) + 1, dtype=np.int64)
        np.cumsum(rows_per, out=out_off[1:])
        total = int(out_off[-1])
        out = np.empty(total, dtype=SEED_DTYPE)
        if total:
            ok = native.emit_join(
                counts, emit_idx, inv, origin, occ_start_u,
                gpos_stream, pm["starts"], pm["ids"], pm["base"],
                uniq_start, uniq_end, index.seed_ids, seeds.seedmap,
                int(seeds.rec_offset), int(k),
                out_off, out.view(np.int64).reshape(total, 6),
            )
            if not ok:
                # not an assert: under python -O a stripped assert would
                # silently emit the uninitialized np.empty rows as hits
                raise RuntimeError("native emit_join vanished mid-run")
        return out

    def _get_mesh_repl(self, mesh, name: str, build):
        """Per-mesh cache of replicated device arrays (index arrays are
        uploaded once, not per chunk)."""
        cache = getattr(self, "_mesh_repl", None)
        if cache is None:
            cache = {}
            self._mesh_repl = cache
        key = (id(mesh), name)
        if key not in cache:
            from psi_tpu.parallel.mesh import replicate

            cache[key] = replicate(mesh, build())
        return cache[key]

    def _onpath_chain_sharded(self, index, search_keys, thr: int, mesh):
        """The device-chained on-path route on a multi-device mesh: one
        shard_map runs the trie levels per device over the per-shard
        plans (same wire as the single-device plan), ONLY counts come
        down, and a
        second shard_map expands + locates each shard's device-resident
        ranges against the replicated SA (gpos-only download per
        device). Same transfer profile per chip as the single-chip
        chain — the fast path and the scaled path are the same path."""
        import jax
        import jax.numpy as jnp

        from psi_tpu.parallel import mesh as mesh_mod

        k = self.seed_len
        prep = getattr(index, "_onpath_prep", None)
        if prep is not None and not isinstance(
            prep[2], mesh_mod.ShardedPreparedTrie
        ):
            prep = None
        if prep is not None:
            uniq, inv, prepared = prep
        else:
            uniq, inv = np.unique(search_keys, return_inverse=True)
            prepared = mesh_mod.prepare_trie_sharded(
                mesh, uniq, k, self.pindex.fm.size, self._get_ftab()
            )
        sarr_r = self._get_mesh_repl(
            mesh, "sarr", self._get_stream_arrays
        )
        ftab_tab_r = None
        if prepared.row_delta is not None:
            ftab_tab_r = self._get_mesh_repl(
                mesh, "ftab",
                lambda: jnp.asarray(self._get_ftab().astype(np.int32)),
            )
        lo_d, hi_d, counts_d = mesh_mod._sharded_trie_device(
            mesh, sarr_r, prepared, ftab_tab_r, with_counts=True,
        )
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            counts_d = multihost_utils.process_allgather(
                counts_d, tiled=True
            )
        D = mesh.shape["data"]
        counts2 = np.asarray(counts_d).reshape(D, -1)
        Npad = counts2.shape[1]
        per = prepared.per
        N = prepared.n
        counts_u = np.zeros(N, dtype=np.int64)
        for d in range(D):
            if prepared.sizes[d]:
                sl = slice(d * per, d * per + prepared.sizes[d])
                counts_u[sl] = counts2[d][prepared.leaf_perms[d]]
        counts = counts_u[inv].astype(np.int64)
        thr32 = int(min(thr, np.iinfo(np.int32).max))
        emit = (counts > 0) & (counts <= thr32)

        def occurrences():
            w2 = np.zeros((D, Npad), dtype=np.int64)
            for d in range(D):
                valid_d = np.arange(Npad) < prepared.sizes[d]
                w2[d] = np.where(
                    valid_d & (counts2[d] > 0) & (counts2[d] <= thr32),
                    counts2[d], 0,
                )
            tot_d = w2.sum(axis=1)
            emit_idx = np.nonzero(emit)[0]
            if not int(tot_d.sum()):
                z = np.zeros(0, dtype=np.int64)
                return emit_idx, z, z, z
            cap = max(16, 1 << (int(tot_d.max()) - 1).bit_length())
            maps = self._get_map_arrays()
            sa_r = self._get_mesh_repl(
                mesh, "sa", lambda: self._get_fm_arrays().sa
            )
            maps_r = self._get_mesh_repl(
                mesh, "maps",
                lambda: (maps.str_starts, maps.lengths, maps.seq_off),
            )
            local_only = self._mh_emit_sharded()
            gpos2 = mesh_mod.sharded_expand_locate(
                mesh, sa_r, maps_r[0], maps_r[1], maps_r[2],
                lo_d, hi_d, np.asarray(prepared.sizes), thr32, k, cap,
                local_only=local_only,
            )
            if local_only:
                gpos2, local_ds = gpos2
            else:
                local_ds = np.ones(D, dtype=bool)
            # local-only: the gpos stream holds only this process's
            # shards; keys of non-local shards are masked out of the
            # emit set, so the join never reads a missing shard's
            # positions and the emitted hit stream is this process's
            # disjoint slice of the global one
            tot_emit = np.where(local_ds, tot_d, 0)
            base_d = np.cumsum(tot_emit) - tot_emit
            gpos_stream = np.concatenate(
                [gpos2[d, : tot_emit[d]] for d in range(D)]
            ).astype(np.int64)
            occ_start_u = np.zeros(N, dtype=np.int64)
            local_key = np.zeros(N, dtype=bool)
            for d in range(D):
                if prepared.sizes[d]:
                    sl = slice(d * per, d * per + prepared.sizes[d])
                    occ_start_u[sl] = (
                        (np.cumsum(w2[d]) - w2[d])[prepared.leaf_perms[d]]
                        + base_d[d]
                    )
                    local_key[sl] = local_ds[d]
            emit_loc = emit if local_ds.all() else (
                emit & local_key[inv]
            )
            return self._chain_join(
                counts, emit_loc, inv, occ_start_u, gpos_stream
            )

        return counts, emit, occurrences

    @staticmethod
    def _chain_eager_enabled() -> bool:
        """Eager single-fetch chain: on by default on the GPU (each
        device->host fetch is a PCIe round trip; the eager flow folds
        counts, expansion total and the off-path traversal into ONE
        fetch and then slices the gpos stream to its exact size).
        PSI_CHAIN_EAGER overrides (tests force it on the CPU backend)."""
        env = os.environ.get("PSI_CHAIN_EAGER")
        if env is not None:
            return env not in ("", "0")
        from psi_tpu import platform

        return platform.on_gpu()

    def _onpath_chain_eager(self, index, uniq, inv, leaf_perm,
                            lo_d, hi_d, counts_d, thr32: int, k: int):
        """Two-fetch transfer profile: the occurrence expansion is
        dispatched BEFORE any fetch with a sticky capacity hint, then
        one packed fetch returns (uint16-saturated counts | saturation
        flag | expansion total | off-path traversal) and a second,
        exact-size fetch brings the gpos stream as 24-bit byte planes.
        Two round trips per chunk total (vs counts + gpos + traversal);
        the saturation/overflow fallbacks re-fetch at full width
        (rare)."""
        import time as _time

        import jax.numpy as jnp

        from psi_tpu.ops import fm_trie

        _dbg = os.environ.get("PSI_CHAIN_DEBUG") not in (None, "", "0")
        _t0 = _time.monotonic()
        Npad = int(counts_d.shape[0])
        n_leaves = len(uniq)
        maps = self._get_map_arrays()
        fmsa = self._get_fm_arrays().sa
        use24 = self.pindex.fm.size < (1 << 24) - 1
        trav_d = getattr(index, "_trav_pack_d", None)
        cap = getattr(self, "_chain_cap", 0)
        if cap < 16:
            cap = max(1 << 14, 2 * Npad)
        while True:
            packed_d, stream_d = fm_trie._chain_tail(
                fmsa, maps.str_starts, maps.lengths, maps.seq_off,
                lo_d, hi_d, counts_d,
                jnp.asarray(n_leaves, dtype=jnp.int32),
                jnp.asarray(thr32, dtype=jnp.int32), k, cap, use24,
                trav_d,
            )
            _t1 = _time.monotonic()
            packed = np.asarray(packed_d)
            _t2 = _time.monotonic()
            nw = Npad // 2
            over = int(packed[nw])
            total = int(packed[nw + 1])
            if trav_d is not None:
                index._trav_pack_np = packed[nw + 2:]
                index._trav_pack_d = None
            if total <= cap:
                break
            cap = max(16, 1 << (total - 1).bit_length())
        self._chain_cap = cap
        if over:
            counts_pat = np.asarray(counts_d).astype(np.int64)
        else:
            counts_pat = fm_trie._decode_counts16(packed[:nw], Npad)
        counts_u = counts_pat[leaf_perm]
        counts = counts_u[inv]
        emit = (counts > 0) & (counts <= thr32)

        def occurrences():
            valid = np.arange(Npad) < n_leaves
            w_pat = np.where(
                valid & (counts_pat > 0) & (counts_pat <= thr32),
                counts_pat, 0,
            ).astype(np.int64)
            total_u = int(w_pat.sum())
            if total_u == 0:
                z = np.zeros(0, dtype=np.int64)
                return np.nonzero(emit)[0], z, z, z
            _t3 = _time.monotonic()
            # fetch at a 64K-bucketed width: a `[:total_u]` slice has a
            # new shape every chunk, and each new shape is a fresh
            # compile; buckets repeat across chunks so the slice program
            # compiles once (the extra <=64K columns are ~0.2 MB)
            bs = min(int(stream_d.shape[-1]),
                     ((total_u + 65535) // 65536) * 65536)
            if use24:
                gpos_stream = fm_trie._unpack24(
                    np.asarray(stream_d[:, :bs])[:, :total_u]
                )
            else:
                gpos_stream = np.asarray(
                    stream_d[:bs]
                )[:total_u].astype(np.int64)
            _t4 = _time.monotonic()
            occ_start_u = (np.cumsum(w_pat) - w_pat)[leaf_perm]
            if _dbg:
                print(
                    f"# chain: pre {_t1-_t0:.3f} fetch1 {_t2-_t1:.3f} "
                    f"mid {_t3-_t2:.3f} fetch2(gpos {total_u}) "
                    f"{_t4-_t3:.3f}",
                    flush=True,
                )
            return self._chain_join(
                counts, emit, inv, occ_start_u, gpos_stream
            )

        return counts, emit, occurrences

    def _onpath_chain(self, index, search_keys: np.ndarray, thr: int):
        """Fully device-chained on-path route: trie search -> counts-only
        download -> device occurrence expansion + locate over the
        DEVICE-RESIDENT lo/hi -> one int32 global position per hit. No
        lo/hi round-trip and no sa_idx upload (the sustained-pipeline
        transfer levers; the reference's comparable cost is the locate
        loop of seed_finder.hpp:1426-1457). Returns (counts[search
        order], emit mask, fn -> (emit_idx, occ_rows, node_ids,
        node_offs)), or None when the chain does not apply. Runs the
        sharded variant whenever a mesh is active."""
        import jax.numpy as jnp

        from psi_tpu.ops import fm_trie

        if self.pindex.fm is None or self.pindex.fm.size == 0:
            return None
        mesh = self._get_mesh()
        if mesh is not None:
            return self._onpath_chain_sharded(index, search_keys, thr, mesh)
        k = self.seed_len
        prep = getattr(index, "_onpath_prep", None)
        if prep is not None and not isinstance(
            prep[2], fm_trie.PreparedTrie
        ):
            prep = None
        if prep is not None:
            uniq, inv, prepared = prep
        else:
            uniq, inv = np.unique(search_keys, return_inverse=True)
            prepared = fm_trie.prepare(uniq, k, self._get_ftab())
        ftab_tab = None
        if fm_trie.needs_ftab_table(prepared):
            if self._ftab_d is None:
                self._ftab_d = jnp.asarray(
                    self._get_ftab().astype(np.int32)
                )
            ftab_tab = self._ftab_d
        lo_d, hi_d, counts_d = fm_trie.run_prepared(
            self._get_stream_arrays(), prepared, ftab_tab, with_counts=True,
        )
        leaf_perm = prepared.leaf_perm
        thr32 = int(min(thr, np.iinfo(np.int32).max))
        eager = self._chain_eager_enabled()
        if eager:
            res = self._onpath_chain_eager(
                index, uniq, inv, leaf_perm, lo_d, hi_d, counts_d,
                thr32, k,
            )
            if res is not None:
                return res
        # two-fetch flow: counts-only download (pattern order); lo/hi
        # stay device-resident until occurrences() expands them
        counts_pat = np.asarray(counts_d)
        counts_u = counts_pat[leaf_perm]
        counts = counts_u[inv].astype(np.int64)
        emit = (counts > 0) & (counts <= thr32)

        def occurrences():
            Npad = counts_pat.shape[0]
            # real (non-padding) leaf slots are exactly [0, n_leaves):
            # _pad_level appends padding after the last real child
            n_leaves = len(uniq)
            valid = np.arange(Npad) < n_leaves
            w_pat = np.where(
                valid & (counts_pat > 0) & (counts_pat <= thr32),
                counts_pat, 0,
            ).astype(np.int64)
            total_u = int(w_pat.sum())
            if total_u == 0:
                z = np.zeros(0, dtype=np.int64)
                return np.nonzero(emit)[0], z, z, z
            cap = max(16, 1 << (total_u - 1).bit_length())
            maps = self._get_map_arrays()
            gpos_pad, _ = fm_trie._expand_locate_device(
                self._get_fm_arrays().sa,
                maps.str_starts, maps.lengths, maps.seq_off,
                lo_d, hi_d, jnp.asarray(n_leaves, dtype=jnp.int32),
                jnp.asarray(thr32, dtype=jnp.int32),
                k, cap,
            )
            gpos_stream = np.asarray(gpos_pad)[:total_u].astype(np.int64)
            occ_start_u = (np.cumsum(w_pat) - w_pat)[leaf_perm]
            return self._chain_join(
                counts, emit, inv, occ_start_u, gpos_stream
            )

        return counts, emit, occurrences

    def _get_map_arrays(self):
        if self._map_arrays is None and self._path_map is not None:
            from psi_tpu.ops import fm as fm_ops

            self._map_arrays = fm_ops.map_to_device(
                self.pindex.fm, self._path_map
            )
        return self._map_arrays

    @staticmethod
    def _device_locate_enabled() -> bool:
        """Device-side locate+map: on by default on the GPU (keeps the
        whole on-path query on device); NumPy wins on the CPU backend."""
        env = os.environ.get("PSI_DEVICE_LOCATE")
        if env is not None:
            return env not in ("0", "")
        from psi_tpu import platform

        return platform.on_gpu()

    def _get_graph_arrays(self):
        if self._graph_arrays is None:
            from psi_tpu.ops import traverse as trav

            self._graph_arrays = trav.graph_to_device(self.graph)
        return self._graph_arrays

    # === seeds on paths (FM route) ==========================================
    def seeds_on_paths(
        self,
        seeds: SeedSet,
        index: SeedsIndex,
        callback: Callable[[Seed], None],
    ):
        """Batched equivalent of the dual-iterator kmer_exact_matches
        (ref: seed_finder.hpp:1426-1457 driving index_iter.hpp:808-852):
        every distinct seed k-mer is counted/located in the path FM index
        in one device batch; hits are the cross product of path
        occurrences x matching seeds, gocc = path-side occurrence count,
        filtered by gocc_threshold.
        """
        context = self.pindex.get_context()
        if context != 0 and context < self.seed_len:
            raise RuntimeError("seed length should not be larger than context size")
        if self.pindex.fm is None or self.pindex.fm.size == 0:
            return
        self.stats.set_progress(ProgressEnum.READY)
        tstats = self.stats.get_this_thread_stats()
        tstats.set_progress(ProgressEnum.FIND_ON_PATHS)
        with self.stats.timeit_ts("seeds-on-paths"):
            arr = self._seeds_on_paths_impl(seeds, index)
            if arr is not None:
                _emit_rows(arr, callback)

    def seeds_on_paths_arrays(self, seeds, index):
        """Columnar variant: structured SEED_DTYPE array (bulk path)."""
        with self.stats.timeit_ts("seeds-on-paths"):
            return self._seeds_on_paths_impl(seeds, index)

    def _seeds_on_paths_impl(self, seeds, index):
        import jax.numpy as jnp

        from psi_tpu.ops import fm as fm_ops

        tstats = self.stats.get_this_thread_stats()
        k = self.seed_len
        if index.size == 0:
            return None
        # distinct k-mers and their seed-range boundaries in sorted order
        # (mismatch expansion handled inside _onpath_search_keys)
        uniq_keys, uniq_start, search_keys, origin = (
            self._onpath_search_keys(index)
        )
        uniq_end = np.append(uniq_start[1:], index.size)

        arrays = self._get_fm_arrays()
        thr = self.gocc_threshold if self.gocc_threshold else np.iinfo(np.int64).max
        fm = self.pindex.fm
        pm = self._path_map

        chain = None
        if self._stream_enabled() and self._device_locate_enabled():
            chain = self._onpath_chain(index, search_keys, thr)
        if chain is not None:
            counts, emit, row_per_occ_fn = chain
            skipped = (counts > 0) & ~emit
            tstats.add_seed_gocc_bulk(
                int(counts[emit].sum()), int(emit.sum())
            )
            tstats.inc_gocc_skips(int(skipped.sum()))
            if not emit.any():
                return None
            join = row_per_occ_fn()
            if isinstance(join, tuple) and len(join) == 5 \
                    and isinstance(join[0], str) and join[0] == "raw":
                # native fused join: cross-product + SEED_DTYPE fill
                # in one OpenMP pass (psi_chunk.cpp psi_emit_join);
                # the tuple's own emit mask is authoritative (it may be
                # process-shard-restricted)
                _, occ_start_u, gpos_stream, inv_c, emit_r = join
                return self._emit_join_native(
                    counts, emit_r, inv_c, origin, occ_start_u,
                    gpos_stream, index, seeds, uniq_start, uniq_end, k,
                )
            emit_idx, occ_rows, node_ids, node_offs = join
            row_per_occ = emit_idx[occ_rows]
            ui_per_occ = origin[row_per_occ]
        else:
            lmask = None
            if self._stream_enabled():
                lo, hi, lmask = self._search_stream(
                    search_keys, k, prep=getattr(index, "_onpath_prep", None)
                )
            else:
                codes = fm_ops.keys_to_codes(search_keys, k)
                lo, hi = fm_ops.backward_search_codes(
                    arrays, jnp.asarray(codes)
                )
            lo = np.asarray(lo)
            hi = np.asarray(hi)
            counts = hi - lo

            present = counts > 0
            emit = present & (counts <= thr)
            skipped = present & ~emit
            tstats.add_seed_gocc_bulk(
                int(counts[emit].sum()), int(emit.sum())
            )
            tstats.inc_gocc_skips(int(skipped.sum()))
            if lmask is not None:
                # process-sharded emission: expand/locate/join only the
                # local key shards (stats above stay global)
                emit = emit & lmask

            if not emit.any():
                return None
            emit_idx = np.nonzero(emit)[0]

            # locate via direct dense-SA range expansion (no padded
            # matrix: a single repetitive k-mer must not blow up the
            # batch)
            widths = counts[emit].astype(np.int64)
            total = int(widths.sum())
            occ_rows = np.repeat(np.arange(len(widths)), widths)
            within = np.arange(total) - np.repeat(
                np.cumsum(widths) - widths, widths
            )
            sa_idx = lo[emit][occ_rows] + within
            row_per_occ = emit_idx[occ_rows]       # search row (variant)
            ui_per_occ = origin[row_per_occ]       # seed group of the hit
            if total and self._device_locate_enabled():
                # device route: SA gather + string-id search + node map
                # on device; pad to a power-of-two bucket
                pad = max(16, 1 << (total - 1).bit_length())
                sa_idx_p = np.zeros(pad, dtype=np.int32)
                sa_idx_p[:total] = sa_idx
                d_ids, d_offs = fm_ops.locate_map_device(
                    arrays, self._get_map_arrays(), jnp.asarray(sa_idx_p), k
                )
                node_ids = np.asarray(d_ids)[:total].astype(np.int64)
                node_offs = np.asarray(d_offs)[:total].astype(np.int64)
            else:
                occ_pos = fm.sa[sa_idx]  # memmap-friendly
                sid, q = fm.text_pos_to_string(occ_pos)
                fwd = pm["lengths"][sid] - q - k
                gpos = pm["seq_off"][sid] + fwd
                entry = np.searchsorted(pm["starts"], gpos, side="right") - 1
                node_ids = pm["ids"][entry]
                node_offs = gpos - pm["starts"][entry] + pm["base"][entry]

        # cross product: repeat each occurrence by its k-mer's seed count
        n_seeds_per_ui = (uniq_end - uniq_start)[ui_per_occ]
        rep_nodes = np.repeat(node_ids, n_seeds_per_ui)
        rep_offs = np.repeat(node_offs, n_seeds_per_ui)
        rep_gocc = np.repeat(counts[row_per_occ], n_seeds_per_ui)
        # seed ids: for each occurrence, the contiguous run of its k-mer
        starts_rep = np.repeat(uniq_start[ui_per_occ], n_seeds_per_ui)
        within = (
            np.arange(len(rep_nodes))
            - np.repeat(
                np.cumsum(n_seeds_per_ui) - n_seeds_per_ui, n_seeds_per_ui
            )
        )
        seed_sel = index.seed_ids[starts_rep + within]
        read_ids = seeds.rec_offset + seeds.seedmap[seed_sel, 0]
        read_offs = seeds.seedmap[seed_sel, 1]

        out = np.empty(len(rep_nodes), dtype=SEED_DTYPE)
        out["node_id"] = rep_nodes
        out["node_offset"] = rep_offs
        out["read_id"] = read_ids
        out["read_offset"] = read_offs
        out["match_len"] = k
        out["gocc"] = rep_gocc
        return out

    # === MEM query path (library API, ref: seed_finder.hpp:1459-1479) ======
    def seeds_on_paths_seq(
        self, sequence: str, callback: Callable[[Seed], None]
    ):
        """find_mems over the path index (ref: index_iter.hpp:854-906)."""
        if self.pindex.fm is None or self.pindex.fm.size == 0:
            return
        self.stats.set_progress(ProgressEnum.READY)
        self.stats.get_this_thread_stats().set_progress(ProgressEnum.FIND_MEMS)
        with self.stats.timeit_ts("query-paths"):
            self._find_mems_impl(sequence, callback)

    def _find_mems_impl(self, sequence: str, callback):
        fm = self.pindex.fm
        pm = self._path_map
        k = self.seed_len
        thr = self.gocc_threshold if self.gocc_threshold else float("inf")
        max_mem = self.max_mem if self.max_mem else float("inf")

        start = 0
        plen = 0
        lo, hi = 0, fm.size
        has_hit = False
        nof_hits = 0
        n = len(sequence)
        while start + plen < n:
            if plen >= k and (hi - lo) <= thr:
                has_hit = True
                occ = fm.locate(lo, hi)
                sid, q = fm.text_pos_to_string(np.asarray(occ))
                fwd = pm["lengths"][sid] - q - plen
                gpos = pm["seq_off"][sid] + fwd
                entry = np.searchsorted(pm["starts"], gpos, side="right") - 1
                for nid, noff in zip(
                    pm["ids"][entry],
                    gpos - pm["starts"][entry] + pm["base"][entry],
                ):
                    callback(
                        Seed(int(nid), int(noff), 0, start, plen, int(hi - lo))
                    )
                    nof_hits += 1
                if nof_hits >= max_mem:
                    break
            ch = sequence[start + plen]
            c = int(fm.codemap[ord(ch)])
            # any non-ACGT byte (N, IUPAC codes, unknown) restarts, the
            # same normalization the batched find_mems_arrays applies —
            # feeding code 0 (sentinel) or 5 (N) would LF into ranges
            # the batched route never visits and break hit-multiset
            # parity between the two MEM APIs
            if has_hit or not (1 <= c <= 4):
                lo, hi = 0, fm.size
                start = start + plen + 1
                plen = 0
                has_hit = False
                continue
            nlo, nhi = fm.lf_step(c, lo, hi)
            if nlo >= nhi:
                lo, hi = 0, fm.size
                start = start + plen + 1
                plen = 0
                has_hit = False
                continue
            lo, hi = nlo, nhi
            plen += 1

    def seeds_on_paths_seqs(
        self, reads: Records, callback: Callable[[Seed], None]
    ):
        """Batched MEM query (library API used by aligners): every read
        runs the find_mems automaton in one lockstep device scan
        (ref: seed_finder.hpp:1459-1479 over index_iter.hpp:854-906),
        replacing a per-character host loop per read. Hit multiset per
        read matches seeds_on_paths_seq (read_offset = MEM start,
        match_len = MEM length, gocc = occurrence count)."""
        arr = self.find_mems_arrays(reads)
        if arr is not None:
            _emit_rows(arr, callback)

    def find_mems_arrays(self, reads: Records):
        """Columnar batched find_mems: structured SEED_DTYPE array."""
        import jax.numpy as jnp

        from psi_tpu.ops import fm as fm_ops

        fm = self.pindex.fm
        if fm is None or fm.size == 0 or len(reads) == 0:
            return None
        self.stats.get_this_thread_stats().set_progress(ProgressEnum.FIND_MEMS)
        with self.stats.timeit_ts("query-paths"):
            k = self.seed_len
            N = len(reads)
            lut = np.zeros(256, dtype=np.int32)
            for i, ch in enumerate("ACGT"):
                lut[ord(ch)] = i + 1
                lut[ord(ch.lower())] = i + 1
            # one pass over the concatenated chunk (no per-read Python
            # on the batched MEM API): scatter each read's coded bytes
            # into its padded row via a flat ragged->dense index.
            # Packed chunks feed their byte array directly.
            pk = reads.packed_view() if hasattr(
                reads, "packed_view"
            ) else None
            if pk is not None:
                flat, off = pk
                rlens = (off[1:] - off[:-1]).astype(np.int32)
            else:
                rlens = np.fromiter(
                    (len(s) for s in reads.seqs), dtype=np.int32, count=N
                )
                flat = np.frombuffer(
                    "".join(reads.seqs).encode("ascii"), dtype=np.uint8
                )
            L = int(rlens.max()) if N else 0
            if L == 0:
                return None
            starts = np.zeros(N, dtype=np.int64)
            np.cumsum(rlens[:-1], out=starts[1:])
            total = int(rlens.sum())
            within = np.arange(total, dtype=np.int64) - np.repeat(
                starts, rlens
            )
            codes = np.zeros((N, L), dtype=np.int32)
            codes[np.repeat(np.arange(N), rlens), within] = lut[flat]
            thr = self.gocc_threshold or (2**31 - 1)
            mm = self.max_mem or (2**31 - 1)
            # a read emits at most one MEM per k+1 consumed positions
            max_out = L // (k + 1) + 2
            out_lo, out_hi, out_start, out_plen, nout, _overflow = (
                fm_ops.find_mems_device(
                    self._get_fm_arrays(),
                    jnp.asarray(codes),
                    jnp.asarray(rlens),
                    k,
                    jnp.asarray(thr, dtype=jnp.int32),
                    jnp.asarray(mm, dtype=jnp.int32),
                    max_out,
                )
            )
            nout = np.asarray(nout)
            valid = (
                np.arange(max_out, dtype=np.int32)[None, :] < nout[:, None]
            )
            if not valid.any():
                return None
            rr, _ = np.nonzero(valid)
            lo_f = np.asarray(out_lo)[valid].astype(np.int64)
            hi_f = np.asarray(out_hi)[valid].astype(np.int64)
            start_f = np.asarray(out_start)[valid].astype(np.int64)
            plen_f = np.asarray(out_plen)[valid].astype(np.int64)

            # vectorized locate + graph mapping (same shape as the
            # on-path emission; fwd flip uses each MEM's own length)
            pm = self._path_map
            widths = hi_f - lo_f
            total = int(widths.sum())
            occ_rows = np.repeat(np.arange(len(widths)), widths)
            within = np.arange(total) - np.repeat(
                np.cumsum(widths) - widths, widths
            )
            occ_pos = fm.sa[lo_f[occ_rows] + within]
            sid, q = fm.text_pos_to_string(occ_pos)
            fwd = pm["lengths"][sid] - q - plen_f[occ_rows]
            gpos = pm["seq_off"][sid] + fwd
            entry = np.searchsorted(pm["starts"], gpos, side="right") - 1
            out = np.empty(total, dtype=SEED_DTYPE)
            out["node_id"] = pm["ids"][entry]
            out["node_offset"] = gpos - pm["starts"][entry] + pm["base"][entry]
            out["read_id"] = reads.rec_offset + rr[occ_rows]
            out["read_offset"] = start_f[occ_rows]
            out["match_len"] = plen_f[occ_rows]
            out["gocc"] = widths[occ_rows]
            return out

    def all_exact_matches(
        self, reads: Records, callback: Callable[[Seed], None]
    ):
        """Whole-read exact matching over the path index
        (ref: all_exact_matches, index_iter.hpp:928-948; per-read
        backward search, occurrences mapped to graph loci,
        match_len = read length, gocc left 0 as in the reference).
        N is a real Dna5 symbol (code 5) on both the read and text
        sides, matching the reference's Dna5-vs-Dna5 semantics."""
        fm = self.pindex.fm
        if fm is None or fm.size == 0:
            return
        pm = self._path_map
        for rid in range(len(reads)):
            seq = reads.seqs[rid]
            if not seq:
                continue
            lo, hi = fm.backward_search(seq[::-1])
            if lo >= hi:
                continue
            L = len(seq)
            occ = fm.locate(lo, hi)
            sid, q = fm.text_pos_to_string(np.asarray(occ))
            fwd = pm["lengths"][sid] - q - L
            gpos = pm["seq_off"][sid] + fwd
            entry = np.searchsorted(pm["starts"], gpos, side="right") - 1
            for nid, noff in zip(
                pm["ids"][entry], gpos - pm["starts"][entry] + pm["base"][entry]
            ):
                callback(
                    Seed(int(nid), int(noff), reads.position_to_id(rid), 0, L, 0)
                )

    def nof_uncovered_kmers(self) -> int:
        """Audit: count k-mer loci not covered by the path set, over the
        nodes that carry starting loci (exact mirror of
        ref: seed_finder.hpp:1587-1635)."""
        if not self.starting_loci:
            return 0
        with self.stats.timeit_ts("count-uncovered-kmer"):
            g = self.graph
            k = self.seed_len
            pathset = self.pindex.get_paths_set()
            bt = BacktrackerIter(g)
            trav_path = Path(g)
            uncovered = 0
            prev_id = 0
            for locus in self.starting_loci:
                if prev_id == locus.node_id():
                    continue
                prev_id = locus.node_id()
                label_len = g.node_length(locus.node_id())
                bt.reset(locus.node_id())
                while not bt.at_end():
                    offset = label_len
                    extend_to_k(trav_path, bt, offset - 1 + k)
                    current_path = None
                    if trav_path.get_sequence_len() >= k:
                        current_path = Path(
                            g, list(trav_path.get_nodes()),
                            trav_path.left, trav_path.right,
                        )
                    while (
                        current_path is not None
                        and current_path.get_sequence_len() != 0
                        and not pathset.covered_by(current_path.get_nodes())
                    ):
                        trimmed_len = (
                            current_path.get_sequence_len()
                            - g.node_length(current_path.get_nodes()[-1])
                        )
                        if trimmed_len <= k - 1:
                            offset = 0
                            break
                        offset = trimmed_len - k + 1
                        trim_back(current_path)
                    uncovered += label_len - offset
                    ub = trav_path.get_sequence_len() + 1 - k
                    if offset < ub < label_len:
                        uncovered -= ub - offset
                    bt.backtrack()
                    trim_back(
                        trav_path, bt.value if bt.value is not None else 0
                    )
                trav_path.clear()
            return uncovered

    # === seeds off paths (traversal route) ==================================
    def seeds_off_paths(
        self,
        seeds: SeedSet,
        index: SeedsIndex,
        callback: Callable[[Seed], None],
        device: bool = True,
    ):
        """(ref: seed_finder.hpp:1703-1722 over traverser_bfs.hpp:72-164)"""
        self.stats.set_progress(ProgressEnum.READY)
        tstats = self.stats.get_this_thread_stats()
        tstats.set_progress(ProgressEnum.FIND_OFF_PATHS)
        with self.stats.timeit_ts("seeds-off-path"):
            if not self.starting_loci:
                return
            from psi_tpu.ops import traverse as trav

            if device:
                raw = self._traverse_device_raw(index)
            else:
                raw = trav.traverse_host(
                    self.graph, index, self.starting_loci, self.seed_len,
                    max_mismatches=self.seed_mismatches,
                )
            for nid, noff, sid, gocc, L in raw:
                callback(
                    Seed(
                        nid,
                        noff,
                        seeds.read_id(sid),
                        seeds.read_offset(sid),
                        L,
                        gocc,
                    )
                )
            tstats.set_locus_idx(len(self.starting_loci))

    def _traverse_device_raw(self, index: SeedsIndex):
        """Device traversal (exact or mismatch-tolerant) returning raw
        (node, off, seed_id, gocc, len) tuples."""
        cols = self._traverse_device_columns(index)
        if cols is None:
            return []
        return list(zip(*(c.tolist() for c in cols))) if len(cols[0]) else []

    def _traverse_device_columns(self, index: SeedsIndex):
        import jax.numpy as jnp

        from psi_tpu.ops import traverse as trav

        if not self.starting_loci or index.size == 0:
            return None
        pending = self._traverse_dispatch(index)
        return self._traverse_collect(index, pending)

    def _traverse_dispatch(self, index: SeedsIndex, g=None, sa=None,
                           cap: int | None = None):
        """Issue the off-path traversal asynchronously (one dispatch,
        ONE packed fetch later instead of six per-array round trips).
        Under a
        mesh, dispatches the loci-sharded traversal instead (same async
        overlap). Returns an opaque tagged handle for _traverse_collect,
        or None when off-path does not apply."""
        import jax.numpy as jnp

        from psi_tpu.ops import traverse as trav

        if not self.starting_loci or index.size == 0:
            return None
        mesh = self._get_mesh()
        if (
            mesh is None
            and not self.seed_mismatches
            and cap is None
        ):
            tree = self._get_trav_tree()
            if tree is not None:
                # chunk-independent walk tree: the whole traversal is
                # host searchsorted prefix probes — no per-chunk seeds
                # upload (the planes payload), no device round trip
                return ("tree", tree)
        if g is None:
            g = self._get_graph_arrays()
        if sa is None:
            sa = trav.seeds_to_device(index)
        if mesh is not None:
            from psi_tpu.parallel.mesh import sharded_traverse_dispatch

            n = len(self.starting_loci)
            D = mesh.shape["data"]
            per = max(-(-n // D), 1)
            if cap is None:
                cap = max(1 << 12, 1 << (per - 1).bit_length())
            sn, so = self._get_loci_np()
            handle = sharded_traverse_dispatch(
                mesh, g, sa, sn, so, self.seed_len, cap,
                max_mm=self.seed_mismatches,
            )
            return ("mesh", handle, cap, g, sa, mesh)
        if cap is None:
            cap = max(
                1 << 15, 1 << (len(self.starting_loci) - 1).bit_length()
            )
        n = len(self.starting_loci)
        sn_d, so_d = self._get_loci_device(cap)
        packed_d = trav.traverse_device_packed(
            g, sa, sn_d, so_d,
            jnp.asarray(n, dtype=jnp.int32),
            self.seed_len, cap, self.seed_mismatches,
        )
        return ("single", packed_d, cap, g, sa)

    def _traverse_collect(self, index: SeedsIndex, pending):
        """Fetch a _traverse_dispatch result (retrying with a doubled
        state cap on overflow) and assemble the columnar survivors."""
        from psi_tpu.ops import traverse as trav

        if pending is None:
            return None
        if pending[0] == "tree":
            tree = pending[1]
            locus_idx, lo, hi, gd, ended, ended_len = trav.walks_match(
                tree, index.sorted_keys
            )
            n_used = len(locus_idx)
            self.stats.get_this_thread_stats().add_traversal(
                gd, ended + n_used,
                ended_len + n_used * self.seed_len,
            )
            return trav.traverse_columnar_from_states(
                index, self.starting_loci, locus_idx, lo, hi,
                self.seed_len,
            )
        if pending[0] == "mesh":
            return self._traverse_collect_sharded(index, pending)
        _, packed_d, cap, g, sa = pending
        # the eager on-path chain may have already fetched the packed
        # result as part of its fused round trip
        pre = getattr(index, "_trav_pack_np", None)
        while True:
            if pre is not None:
                packed = pre
                pre = None
                index._trav_pack_np = None
            else:
                packed = np.asarray(packed_d)
            locus_idx = packed[:cap]
            lo = packed[cap: 2 * cap]
            hi = packed[2 * cap: 3 * cap]
            n_used, overflow = int(packed[3 * cap]), int(packed[3 * cap + 1])
            tstats_dev = packed[3 * cap + 2:]
            if overflow:
                cap *= 2
                _, packed_d, cap, g, sa = self._traverse_dispatch(
                    index, g, sa, cap
                )
                continue
            if not self.seed_mismatches:
                # only account the final (non-overflowing) run's counters
                gd, ended, ended_len = (int(v) for v in tstats_dev)
                ts = self.stats.get_this_thread_stats()
                ts.add_traversal(
                    gd, ended + n_used,
                    ended_len + n_used * self.seed_len,
                )
            break
        return trav.traverse_columnar_from_states(
            index, self.starting_loci,
            locus_idx[:n_used],
            lo[:n_used],
            hi[:n_used],
            self.seed_len,
        )

    def _traverse_collect_sharded(self, index: SeedsIndex, pending):
        """Fetch a mesh-mode _traverse_dispatch result (cap-doubling
        retry per overflow) and assemble the columnar survivors."""
        from psi_tpu.ops import traverse as trav
        from psi_tpu.parallel.mesh import (
            sharded_traverse_collect, sharded_traverse_dispatch,
        )

        _, handle, cap_local, g, sa, mesh = pending
        sn, so = self._get_loci_np()
        local_only = self._mh_emit_sharded()
        while True:
            li, lo, hi, nu, ov, ts, local_ds = sharded_traverse_collect(
                handle, local_only=local_only
            )
            # overflow is allgathered even in local-only mode: the
            # cap-doubling re-dispatch is a collective decision
            if ov.any():
                cap_local *= 2
                handle = sharded_traverse_dispatch(
                    mesh, g, sa, sn, so, self.seed_len, cap_local,
                    max_mm=self.seed_mismatches,
                )
                continue
            break
        if not self.seed_mismatches:
            gd = int(ts[:, 0].sum())
            ended = int(ts[:, 1].sum())
            ended_len = int(ts[:, 2].sum())
            n_surv = int(nu.sum())
            self.stats.get_this_thread_stats().add_traversal(
                gd, ended + n_surv, ended_len + n_surv * self.seed_len
            )
        # local-only: join/emit only this process's loci shards (the
        # global stream is the concatenation of the disjoint
        # per-process streams; SURVEY §5 order-insensitive emission)
        nu_emit = np.where(local_ds, nu, 0)
        keep_li = np.concatenate(
            [li[d, : nu_emit[d]] for d in range(li.shape[0])]
        )
        keep_lo = np.concatenate(
            [lo[d, : nu_emit[d]] for d in range(lo.shape[0])]
        )
        keep_hi = np.concatenate(
            [hi[d, : nu_emit[d]] for d in range(hi.shape[0])]
        )
        return trav.traverse_columnar_from_states(
            index, self.starting_loci, keep_li, keep_lo, keep_hi,
            self.seed_len,
        )

    @staticmethod
    def _mh_emit_sharded() -> bool:
        """Process-sharded emission (multi-process mesh only): each
        process fetches/joins/emits only its addressable shards' hits;
        merging is concatenation of disjoint streams. On by default;
        PSI_MH_EMIT=full selects replicated emission (every process
        computes the full stream)."""
        import jax

        if jax.process_count() <= 1:
            return False
        return os.environ.get("PSI_MH_EMIT", "shard") != "full"

    @staticmethod
    def _trav_tree_enabled() -> bool:
        """Walk-tree traversal cache (see ops/traverse.WalkTree): on by
        default for the exact-matching single-device bulk route — the
        per-chunk traversal becomes host searchsorted probes instead of
        a seeds upload + device dispatch. PSI_TRAV_CACHE=0 selects the
        per-chunk device traversal (also the route once the tree would
        exceed PSI_TRAV_CACHE_CAP nodes)."""
        return os.environ.get("PSI_TRAV_CACHE", "1") not in ("", "0")

    def _get_trav_tree(self):
        """Lazy chunk-independent walk tree, fingerprinted on the loci
        set (node/offset bytes) so staged add_uncovered_loci calls or
        loci reloads invalidate it."""
        if not self._trav_tree_enabled():
            return None
        from psi_tpu.ops import traverse as trav

        sn, so = self._get_loci_np()
        fp = (len(sn), hash((sn.tobytes(), so.tobytes())))
        cached = self._trav_tree
        if cached is not None and cached[0] == fp:
            return cached[1] if cached[1] is not False else None
        with self._prep_lock:
            cached = self._trav_tree
            if cached is not None and cached[0] == fp:
                return cached[1] if cached[1] is not False else None
            with self.stats.timeit_ts("seeds-off-path"):
                tree = trav.enumerate_walks(
                    self.graph, sn, so, self.seed_len,
                    node_cap=int(
                        os.environ.get("PSI_TRAV_CACHE_CAP", str(1 << 23))
                    ),
                )
            self._trav_tree = (fp, tree if tree is not None else False)
        return tree

    def _get_loci_np(self):
        """Host-side starting-loci arrays (cached per loci set)."""
        n = len(self.starting_loci)
        cache = getattr(self, "_loci_dev", None)
        if cache is None or cache.get("n") != n:
            sn = np.zeros(n, dtype=np.int32)
            so = np.zeros(n, dtype=np.int32)
            for i, l in enumerate(self.starting_loci):
                sn[i] = l.node_id()
                so[i] = l.offset()
            cache = {"n": n, "np": (sn, so), "dev": {}}
            self._loci_dev = cache
        return cache["np"]

    def _get_loci_device(self, cap: int):
        """Device-resident starting loci, padded to `cap` (the loci are
        fixed per finder — upload once per cap bucket, not per chunk)."""
        import jax.numpy as jnp

        sn, so = self._get_loci_np()
        n = len(self.starting_loci)
        cache = self._loci_dev
        dev = cache["dev"].get(cap)
        if dev is None:
            snp = np.zeros(cap, dtype=np.int32)
            sop = np.zeros(cap, dtype=np.int32)
            snp[:n] = sn
            sop[:n] = so
            dev = (jnp.asarray(snp), jnp.asarray(sop))
            cache["dev"][cap] = dev
        return dev

    @staticmethod
    def _off_cols_to_arrays(seeds: SeedSet, cols):
        if cols is None:
            return None
        nodes, offs, seed_sel, goccs, lens = cols
        out = np.empty(len(nodes), dtype=SEED_DTYPE)
        out["node_id"] = nodes
        out["node_offset"] = offs
        out["read_id"] = seeds.rec_offset + seeds.seedmap[seed_sel, 0]
        out["read_offset"] = seeds.seedmap[seed_sel, 1]
        out["match_len"] = lens
        out["gocc"] = goccs
        return out

    def seeds_off_paths_arrays(self, seeds: SeedSet, index: SeedsIndex):
        """Columnar off-path hits (structured SEED_DTYPE array)."""
        with self.stats.timeit_ts("seeds-off-path"):
            return self._off_cols_to_arrays(
                seeds, self._traverse_device_columns(index)
            )

    def seeds_all_arrays(self, seeds: SeedSet, index: SeedsIndex,
                         split: bool = False):
        """Both routes, columnar; the bulk path used by the CLI.

        The off-path traversal is DISPATCHED first (async) and fetched
        after the on-path route completes, so its device time overlaps
        the on-path transfers and host joins — one chunk pays
        max(on-path, off-path) device time, not the sum (single-device
        and mesh alike). On the single-device chain route, the
        traversal's packed result additionally rides the on-path
        chain's ONE packed fetch (eager flow). `split=True` returns
        (on_path, off_path) arrays instead of the concatenation."""
        import time as _time

        _dbg = os.environ.get("PSI_CHAIN_DEBUG") not in (None, "", "0")
        _ts = _time.monotonic()
        pending = None
        if self.starting_loci and index.size:
            with self.stats.timeit_ts("seeds-off-path"):
                pending = self._traverse_dispatch(index)
            if pending is not None and pending[0] == "single":
                # hand the packed device handle to the on-path chain's
                # eager fetch (fused round trip)
                index._trav_pack_d = pending[1]
        _t_disp = _time.monotonic()
        parts = [self.seeds_on_paths_arrays(seeds, index)]
        _t_on = _time.monotonic()
        if pending is not None:
            with self.stats.timeit_ts("seeds-off-path"):
                tstats = self.stats.get_this_thread_stats()
                tstats.set_progress(ProgressEnum.FIND_OFF_PATHS)
                parts.append(self._off_cols_to_arrays(
                    seeds, self._traverse_collect(index, pending)
                ))
                tstats.set_locus_idx(len(self.starting_loci))
        else:
            parts.append(self.seeds_off_paths_arrays(seeds, index))
        if _dbg:
            print(
                f"# all_arrays: trav-dispatch {_t_disp-_ts:.3f} "
                f"onpath {_t_on-_t_disp:.3f} "
                f"offpath-collect {_time.monotonic()-_t_on:.3f}",
                flush=True,
            )
        index._trav_pack_d = None
        index._trav_pack_np = None
        self.stats.get_this_thread_stats().inc_chunks_done()
        if split:
            empty = np.zeros(0, dtype=SEED_DTYPE)
            return (
                parts[0] if parts[0] is not None else empty,
                parts[1] if parts[1] is not None else empty,
            )
        parts = [p for p in parts if p is not None and len(p)]
        if not parts:
            return np.zeros(0, dtype=SEED_DTYPE)
        return np.concatenate(parts)

    # === combined ===========================================================
    def seeds_all(
        self,
        seeds: SeedSet,
        index: SeedsIndex,
        callback: Callable[[Seed], None],
        device: bool = True,
    ):
        """(ref: seed_finder.hpp:1724-1743)"""
        self.seeds_on_paths(seeds, index, callback)
        self.seeds_off_paths(seeds, index, callback, device=device)
        self.stats.get_this_thread_stats().inc_chunks_done()


def _emit_rows(arr: np.ndarray, callback: Callable[[Seed], None]) -> None:
    """Feed a structured SEED_DTYPE array through a per-hit callback."""
    for row in arr:
        callback(
            Seed(
                int(row["node_id"]),
                int(row["node_offset"]),
                int(row["read_id"]),
                int(row["read_offset"]),
                int(row["match_len"]),
                int(row["gocc"]),
            )
        )
