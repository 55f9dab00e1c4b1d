"""Platform selection, compile cache, native build key, and the XLA trie
route against the native C++ reference (native/psi_fm.cpp)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from psi_tpu import native, platform
from psi_tpu.fmindex import FMIndex
from psi_tpu.ops import fm as fm_ops
from psi_tpu.ops import fm_trie

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_py(code: str, env_extra=None, env_drop=()):
    env = dict(os.environ)
    for key in env_drop:
        env.pop(key, None)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.fixture(scope="module")
def text_index():
    rng = np.random.RandomState(3)
    strings = ["".join(rng.choice(list("ACGT"), size=25_000))
               for _ in range(3)]
    fm = FMIndex.build_from_strings([s[::-1] for s in strings])
    k = 12
    lut = {c: i for i, c in enumerate("ACGT")}
    present = [
        sum(lut[ch] << (2 * (k - 1 - j)) for j, ch in enumerate(
            strings[i % 3][p: p + k]))
        for i, p in enumerate(rng.randint(0, 25_000 - k, size=3000))
    ]
    # dense key fill (the delta wire picks its 4-bit form)
    keys = np.unique(np.concatenate([
        np.asarray(present, dtype=np.uint64),
        rng.randint(0, 4 ** k, size=4000).astype(np.uint64),
    ]))
    return fm, fm_trie.build_stream_arrays(fm), keys, k


@pytest.mark.parametrize("ftab_bits", [0, 5])
@pytest.mark.parametrize(
    "wire", ["plain", "packed", "delta8", "delta4", "mask"]
)
def test_trie_route_matches_native(text_index, wire, ftab_bits):
    """Every wire format, with and without the ftab-seeded frontier, is
    exact vs the C++ single-core backward search."""
    fm, arr, keys, k = text_index
    codes = fm_ops.keys_to_codes(keys, k)
    ref = native.fm_backward_batch(
        fm_trie.payload_host(fm), fm.C.astype(np.int32), fm.size, codes
    )
    assert ref is not None, native.load_error
    lo_n, hi_n, _ = ref
    ftab = fm_ops.build_ftab(fm, ftab_bits) if ftab_bits else None
    prep = fm_trie.prepare(
        keys, k, ftab,
        wire={"delta4": "delta"}.get(wire, wire),
        pack=False if wire == "plain" else None,
    )
    if wire == "delta4":
        assert prep.delta_bits == 4
    elif wire == "plain":
        assert prep.parents is not None
    lo, hi = fm_trie.trie_search(arr, keys, k, ftab=ftab, prepared=prep)
    cnt_n = np.maximum(hi_n - lo_n, 0)
    np.testing.assert_array_equal(hi - lo, cnt_n)
    nz = cnt_n > 0
    assert nz.sum() >= 3000 - 50
    np.testing.assert_array_equal(lo[nz], lo_n[nz])


def test_block_major_rank_matches_host_payload(text_index):
    """The device's block-major known-char rank equals the rank read
    from the host [16, nblocks] payload (occ checkpoint + bit-plane
    popcount, the C++ reference's layout) and a count over the BWT."""
    fm, arr, _, _ = text_index
    rng = np.random.RandomState(5)
    pos = rng.randint(0, fm.size + 1, size=4096).astype(np.int32)
    pos[:4] = [0, fm.size, 31, 32]
    c = rng.randint(1, 5, size=pos.shape).astype(np.int32)
    got = np.asarray(fm_trie._rank_known(
        arr.payload, jnp.asarray(pos), jnp.asarray(c)))
    host = fm_trie.payload_host(fm).view(np.uint32)
    blk = pos // fm_trie.SBLOCK
    match = np.full(len(pos), 0xFFFFFFFF, dtype=np.uint32)
    for p in range(3):
        w = host[6 + p, blk]
        match &= np.where((c >> p) & 1, w, ~w)
    mask = ((np.uint64(1) << (pos % 32).astype(np.uint64)) - 1).astype(
        np.uint32)
    popc = np.array([bin(int(x)).count("1") for x in match & mask])
    want = host[c, blk].astype(np.int64) + popc
    np.testing.assert_array_equal(got, want)
    for i in range(0, len(pos), 97):
        assert got[i] == np.count_nonzero(fm.bwt[: pos[i]] == c[i])


def test_wire_default_shared_by_single_and_sharded(monkeypatch):
    """The single-device and sharded plans ship one wire by default,
    whatever the platform, and PSI_TRIE_WIRE moves both."""
    from psi_tpu.parallel.mesh import device_mesh, prepare_trie_sharded

    rng = np.random.RandomState(1)
    k = 10
    keys = np.unique(rng.randint(0, 4 ** k, size=3000).astype(np.uint64))
    mesh = device_mesh(2)
    monkeypatch.delenv("PSI_TRIE_WIRE", raising=False)
    assert fm_trie.default_wire() == "packed"
    single = fm_trie.prepare(keys, k, to_device=False)
    sharded = prepare_trie_sharded(mesh, keys, k, 10_000)
    assert single.poff is not None and sharded.poff is not None
    monkeypatch.setenv("PSI_TRIE_WIRE", "delta")
    single = fm_trie.prepare(keys, k, to_device=False)
    sharded = prepare_trie_sharded(mesh, keys, k, 10_000)
    assert single.delta is not None and sharded.delta is not None


def test_platform_active_names_cpu():
    dev = platform.active()
    assert dev.platform == "cpu"
    assert dev.count == len(jax.devices())
    assert platform.describe(dev) == {
        "platform": "cpu", "kind": dev.kind, "count": dev.count}


def test_platform_rejects_unknown(monkeypatch):
    class Fake:
        platform = "rocm"
        device_kind = "other"

    monkeypatch.setattr(jax, "devices", lambda *a: [Fake()])
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        platform.active()


def test_cli_device_gpu_without_gpu_exits_nonzero(tmp_path):
    """--device gpu never falls back to the CPU: with no GPU it exits
    non-zero with a message, before reading any input."""
    res = _run_py(
        "import sys; from psi_tpu.cli import main; "
        f"sys.exit(main(['{tmp_path}/none.gfa', '-f', '{tmp_path}/r.fq', "
        "'-l', '12', '--device', 'gpu', '-Q']))",
        env_drop=("JAX_PLATFORMS",),
    )
    assert res.returncode != 0
    assert "--device gpu" in res.stderr
    assert "Loading input graph" not in res.stderr


def test_cli_device_cpu_runs(tmp_path):
    """--device cpu runs the pipeline end to end and logs the device."""
    from psi_tpu.cli import main
    from psi_tpu.simulate import make_pangenome_graph

    g = make_pangenome_graph(3000, seed=2)
    g.save(str(tmp_path / "g.npz"))
    seq = g.labels.tobytes().decode()
    with open(tmp_path / "r.fq", "w") as fh:
        for i in range(20):
            s = seq[i * 97: i * 97 + 60]
            fh.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    out = tmp_path / "hits.bin"
    rc = main([str(tmp_path / "g.npz"), "-f", str(tmp_path / "r.fq"),
               "-l", "12", "-n", "1", "-o", str(out), "--device", "cpu",
               "-q", "-Q"])
    assert rc == 0
    hits = np.fromfile(out, dtype=np.int64).reshape(-1, 4)
    assert len(hits) >= 20


def test_compile_cache_dir_env_and_default(tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR is used as given; without it the cache
    is one fixed in-checkout path, the same in every process."""
    from psi_tpu import cache

    monkeypatch.setenv(cache.ENV, str(tmp_path / "cc"))
    assert cache.compile_cache_dir("gpu") == str(tmp_path / "cc")
    assert cache.compile_cache_dir("cpu") == str(tmp_path / "cc")
    monkeypatch.delenv(cache.ENV)
    assert cache.compile_cache_dir("gpu", create=False) == os.path.join(
        REPO, ".jax_cache")
    code = ("from psi_tpu.cache import compile_cache_dir; "
            "print(compile_cache_dir('cpu', create=False))")
    outs = {_run_py(code, env_drop=(cache.ENV,)).stdout.strip()
            for _ in range(2)}
    assert outs == {cache.compile_cache_dir("cpu", create=False)}
    assert outs.pop().startswith(os.path.join(REPO, ".jax_cache", "cpu-"))


def test_enable_compile_cache_keeps_env_dir(tmp_path, monkeypatch):
    """With the env var set, enable_compile_cache sets no other dir."""
    from psi_tpu import cache

    monkeypatch.setenv(cache.ENV, str(tmp_path / "cc"))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() == str(tmp_path / "cc")
    assert jax.config.jax_compilation_cache_dir == before


def test_native_build_key_tracks_sources(tmp_path, monkeypatch):
    """The library path is keyed on the tracked sources: any source
    change moves it, so a stale build is never loaded."""
    assert native.available(), native.load_error
    path = native.library_path()
    assert os.path.dirname(os.path.dirname(path)).endswith(
        os.path.join("native", "build"))
    src = tmp_path / "native"
    src.mkdir()
    for name in os.listdir(native._NATIVE_DIR):
        if name.endswith(".cpp") or name == "Makefile":
            (src / name).write_bytes(
                open(os.path.join(native._NATIVE_DIR, name), "rb").read())
    monkeypatch.setattr(native, "_NATIVE_DIR", str(src))
    assert native.build_key() == os.path.basename(os.path.dirname(path))
    with open(src / "psi_fm.cpp", "a") as fh:
        fh.write("\n// changed\n")
    assert native.build_key() != os.path.basename(os.path.dirname(path))


def test_dindex_device_build_request_never_falls_back(monkeypatch):
    """PSI_DINDEX_BUILD=device raises when the device build cannot
    run, instead of silently taking the host DP."""
    from psi_tpu.dindex import DistanceIndex
    from psi_tpu.ops import dindex_build
    from psi_tpu.simulate import make_pangenome_graph

    g = make_pangenome_graph(4000, seed=4)
    monkeypatch.setenv("PSI_DINDEX_BUILD", "device")
    monkeypatch.setattr(
        dindex_build, "build_super_device_per_component",
        lambda *a, **kw: None,
    )
    with pytest.raises(RuntimeError, match="PSI_DINDEX_BUILD=device"):
        DistanceIndex.build(g, 50, 200, True)
