"""Native host-kernel tests (SA-IS, BWT, FASTQ scanner)."""

import numpy as np
import pytest

from psi_tpu import native
from psi_tpu.fmindex import _suffix_array_doubling

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)


@pytest.mark.parametrize("seed", range(6))
def test_sais_matches_doubling(seed):
    rng = np.random.RandomState(seed)
    n = rng.randint(1, 3000)
    sigma = rng.choice([2, 4, 6, 256])
    codes = rng.randint(0, sigma, size=n).astype(np.uint8)
    np.testing.assert_array_equal(
        native.sais(codes), _suffix_array_doubling(codes)
    )


@pytest.mark.parametrize(
    "codes", [[0], [0, 0, 0], [5] * 100, [0, 1] * 50, [255, 0, 255]]
)
def test_sais_degenerate(codes):
    codes = np.array(codes, dtype=np.uint8)
    np.testing.assert_array_equal(
        native.sais(codes), _suffix_array_doubling(codes)
    )


def test_bwt():
    codes = np.random.RandomState(1).randint(0, 6, size=999).astype(np.uint8)
    sa = native.sais(codes)
    bwt = native.bwt_from_sa(codes, sa)
    np.testing.assert_array_equal(bwt, codes[(sa - 1) % len(codes)])


def test_fastq_scan(data_dir):
    buf = (data_dir / "small" / "reads_n10l10e0i0.fastq").read_bytes()
    names, seqs, consumed = native.fastq_scan(buf, 100)
    assert len(names) == 10
    assert consumed == len(buf)
    assert all(len(s) == 10 for s in seqs)
    assert names[0] == "read0"

    # chunked: 3 at a time
    names3, seqs3, c3 = native.fastq_scan(buf, 3)
    assert names3 == names[:3]
    names_rest, _, _ = native.fastq_scan(buf[c3:], 100)
    assert names_rest == names[3:]


def test_fastx_stream_native_path(data_dir):
    from psi_tpu.io.fastq import FastxStream

    s = FastxStream(str(data_dir / "small" / "reads_n10l10e0i0.fastq"))
    n1, q1 = s.read_chunk(4)
    assert len(n1) == 4 and s.counts() == 4
    n2, q2 = s.read_chunk(0)
    assert len(n2) == 6 and s.counts() == 10
    n3, _ = s.read_chunk(0)
    assert n3 == []


def test_sais_sharded_fm_parity():
    """Parallel sharded SA: sentinel-tie order may differ from the
    whole-text SA-IS, but the FM index built on it must answer every
    query identically (the tie order is semantically irrelevant —
    patterns never contain the sentinel)."""
    from psi_tpu.fmindex import BLOCK, CODE, FMIndex

    rng = np.random.RandomState(4)
    strings = [
        "".join(rng.choice(list("ACGT"), size=rng.randint(200, 1500)))
        for _ in range(12)
    ]
    parts, starts, lengths = [], [0], []
    for s in strings:
        c = CODE[np.frombuffer(s.encode(), np.uint8)]
        parts += [c, np.zeros(1, np.uint8)]
        lengths.append(len(c))
        starts.append(starts[-1] + len(c) + 1)
    codes = np.concatenate(parts)
    off = np.asarray([0, starts[4], starts[9], len(codes)], dtype=np.int64)
    sa = native.sais_sharded(codes, off)
    # valid permutation of all suffix positions
    np.testing.assert_array_equal(np.sort(sa), np.arange(len(codes)))
    bwt = native.bwt_from_sa(codes, sa)
    occ = native.occ_checkpoints(bwt, BLOCK, 6)
    counts = np.bincount(codes, minlength=6).astype(np.int64)
    C = np.zeros(7, dtype=np.int64)
    np.cumsum(counts, out=C[1:])
    fm2 = FMIndex(codes, sa, bwt, C, occ, np.asarray(starts),
                  np.asarray(lengths))
    fm1 = FMIndex.build_from_codes(
        codes, np.asarray(starts), np.asarray(lengths)
    )
    for _ in range(200):
        s = strings[rng.randint(len(strings))]
        i = rng.randint(0, len(s) - 12)
        pat = s[i: i + 12]
        assert fm1.count(pat) == fm2.count(pat)
        occ1 = sorted(zip(*map(list, fm1.text_pos_to_string(
            fm1.locate(*fm1.backward_search(pat))))))
        occ2 = sorted(zip(*map(list, fm2.text_pos_to_string(
            fm2.locate(*fm2.backward_search(pat))))))
        assert occ1 == occ2


def test_sais_disk_matches_sharded(tmp_path):
    """Bounded-RAM disk build (shard spill + streaming heap merge +
    in-merge BWT) must reproduce the in-RAM sharded SA and BWT exactly
    (identical comparator, identical tie order)."""
    from psi_tpu.fmindex import CODE

    rng = np.random.RandomState(9)
    # include near-identical haplotype strings (long shared prefixes —
    # the merge's worst case)
    base = "".join(rng.choice(list("ACGT"), size=3000))
    strings = [base]
    for _ in range(7):
        b = list(base)
        for _ in range(5):
            b[rng.randint(len(b))] = "ACGT"[rng.randint(4)]
        strings.append("".join(b))
    parts, starts, lengths = [], [0], []
    for s in strings:
        c = CODE[np.frombuffer(s.encode(), np.uint8)]
        parts += [c, np.zeros(1, np.uint8)]
        lengths.append(len(c))
        starts.append(starts[-1] + len(c) + 1)
    codes = np.concatenate(parts)
    off = np.asarray(
        [0, starts[2], starts[3], starts[6], len(codes)], dtype=np.int64
    )
    sa_ram = native.sais_sharded(codes, off)
    res = native.sais_disk(codes, off, tmpdir=str(tmp_path), bufelems=512)
    assert res is not None
    sa_disk, bwt_disk = res
    np.testing.assert_array_equal(np.asarray(sa_disk), sa_ram)
    np.testing.assert_array_equal(bwt_disk, native.bwt_from_sa(codes, sa_ram))


def test_build_from_codes_disk_mode(monkeypatch):
    """PSI_SA_DISK=1 end-to-end through FMIndex.build_from_strings."""
    from psi_tpu.fmindex import FMIndex

    rng = np.random.RandomState(10)
    strings = [
        "".join(rng.choice(list("ACGT"), size=rng.randint(500, 2000)))
        for _ in range(10)
    ]
    fm1 = FMIndex.build_from_strings(strings)
    monkeypatch.setenv("PSI_SA_DISK", "1")
    fm2 = FMIndex.build_from_strings(strings)
    for _ in range(100):
        s = strings[rng.randint(len(strings))]
        i = rng.randint(0, len(s) - 12)
        pat = s[i: i + 12]
        assert fm1.count(pat) == fm2.count(pat)
        occ1 = sorted(zip(*map(list, fm1.text_pos_to_string(
            fm1.locate(*fm1.backward_search(pat))))))
        occ2 = sorted(zip(*map(list, fm2.text_pos_to_string(
            fm2.locate(*fm2.backward_search(pat))))))
        assert occ1 == occ2


@pytest.mark.parametrize("seed,k", [(0, 4), (1, 9), (2, 20), (3, 31)])
def test_trie_schedule_matches_numpy(seed, k):
    """Native pattern-order counting builder vs the NumPy argsort
    reference, including leaf permutation and ftab frontier rows."""
    from psi_tpu.ops import fm_trie

    rng = np.random.RandomState(seed)
    mask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
    keys = np.unique(
        rng.randint(0, 1 << 62, size=2000, dtype=np.uint64) & mask
    )
    keys.sort()
    p = max(1, k // 2)
    nat = native.trie_schedule(keys, k, p)
    assert nat is not None
    parents, chars, leaf_perm, rows = nat
    ref = fm_trie._build_schedule_np(keys, k)
    for j in range(k):
        np.testing.assert_array_equal(ref.parents[j], parents[j])
        np.testing.assert_array_equal(ref.chars[j], chars[j])
    np.testing.assert_array_equal(ref.leaf_perm, leaf_perm)
    kpref, order = fm_trie._frontier_at(keys, k, p)
    np.testing.assert_array_equal(rows, kpref[order].astype(np.int64))


def test_fm_build_uses_native():
    from psi_tpu.fmindex import FMIndex

    rng = np.random.RandomState(3)
    strings = ["".join(rng.choice(list("ACGT"), size=200)) for _ in range(3)]
    fm = FMIndex.build_from_strings(strings)
    for pat in ["AC", "GT", strings[0][:10]]:
        brute = sum(
            1
            for s in strings
            for i in range(len(s) - len(pat) + 1)
            if s[i: i + len(pat)] == pat
        )
        assert fm.count(pat) == brute


@pytest.mark.parametrize("k,step,greedy", [(20, 1, False), (20, 7, True),
                                           (12, 12, True), (31, 1, False)])
def test_extract_kmers_native_parity(k, step, greedy):
    from psi_tpu.ops.kmers import extract_kmers as np_extract

    rng = np.random.RandomState(5)
    seqs = []
    for _ in range(300):
        L = int(rng.randint(max(k - 4, 5), 140))
        seqs.append("".join(rng.choice(
            list("ACGTacgtN"), size=L,
            p=[.2, .2, .2, .2, .04, .04, .04, .04, .04])))
    out = native.extract_kmers(seqs, k, step, greedy_tail=greedy)
    if out is None:
        pytest.skip("native library unavailable")
    ref = np_extract(seqs, k, step, greedy_tail=greedy)
    for got, want in zip(out, ref):
        assert got.shape == want.shape
        assert (np.asarray(got) == np.asarray(want)).all()


def test_seed_index_native_parity(monkeypatch):
    from psi_tpu.records import SeedSet, SeedsIndex
    from psi_tpu.ops.kmers import extract_kmers as np_extract

    rng = np.random.RandomState(6)
    seqs = ["".join(rng.choice(list("ACGTN"), size=90,
                               p=[.24, .24, .24, .24, .04]))
            for _ in range(800)]
    keys, valid, m = np_extract(seqs, 13, 1)
    ss = SeedSet(keys, valid, m, 13, 0)
    idx_nat = SeedsIndex(ss)
    if native._load() is None:
        pytest.skip("native library unavailable")
    monkeypatch.setenv("PSI_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    idx_np = SeedsIndex(ss)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert (idx_nat.sorted_keys == idx_np.sorted_keys).all()
    assert (idx_nat.seed_ids == idx_np.seed_ids).all()
    assert (idx_nat.chars == idx_np.chars).all()
    assert (idx_nat.occ == idx_np.occ).all()
    assert (idx_nat.planes == idx_np.planes).all()


def test_radix_sort_kv_stable():
    rng = np.random.RandomState(7)
    keys = rng.randint(0, 1 << 26, size=50_000).astype(np.uint64)
    ids = np.arange(len(keys), dtype=np.int64)
    k2, i2 = keys.copy(), ids.copy()
    if native.radix_sort_kv(k2, i2, 26) is None:
        pytest.skip("native library unavailable")
    order = np.argsort(keys, kind="stable")
    assert (k2 == keys[order]).all()
    assert (i2 == ids[order]).all()


def test_fm_backward_batch_matches_host():
    """native/psi_fm.cpp single-core backward search (the measured
    bench baseline) is exact vs FMIndex.backward_search."""
    from psi_tpu.fmindex import FMIndex
    from psi_tpu.ops import fm_trie
    from psi_tpu import native

    rng = np.random.RandomState(11)
    strings = ["".join(rng.choice(list("ACGT"), size=30_000))
               for _ in range(2)]
    fm = FMIndex.build_from_strings([s[::-1] for s in strings])
    k = 14
    N = 400
    lut = {c: i for i, c in enumerate("ACGT")}
    kmers = np.empty((N, k), dtype=np.int64)
    half = N // 2
    starts = rng.randint(0, 30_000 - k, size=half)
    for r in range(half):
        s = strings[r % 2]
        kmers[r] = [lut[ch] for ch in s[starts[r]: starts[r] + k]]
    kmers[half:] = rng.randint(0, 4, size=(N - half, k))
    codes = (kmers + 1).astype(np.int32)
    res = native.fm_backward_batch(
        fm_trie.payload_host(fm), fm.C.astype(np.int32), fm.size, codes
    )
    if res is None:
        pytest.skip("native library unavailable")
    lo, hi, nonempty = res
    n_ok = 0
    for i in range(N):
        pat = "".join("ACGT"[c] for c in kmers[i])
        r = fm.backward_search(pat[::-1])
        elo, ehi = r if isinstance(r, tuple) else (r.lo, r.hi)
        assert ehi - elo == max(hi[i] - lo[i], 0)
        if ehi > elo:
            assert elo == lo[i]
            n_ok += 1
    assert n_ok >= half  # every true substring found
    assert nonempty == n_ok
