"""Multi-device sharding tests (8 virtual CPU devices via conftest)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from psi_tpu.fmindex import FMIndex
from psi_tpu.ops import fm as fm_ops
from psi_tpu.parallel.mesh import (
    device_mesh,
    make_train_step,
    replicate,
    shard_batch,
    sharded_backward_search,
)


@pytest.fixture(scope="module")
def fm():
    rng = np.random.RandomState(0)
    strings = ["".join(rng.choice(list("ACGT"), size=500)) for _ in range(3)]
    return FMIndex.build_from_strings([s[::-1] for s in strings])


def test_eight_devices_present():
    assert len(jax.devices()) >= 8


def test_sharded_search_matches_single(fm):
    arrays = fm_ops.to_device(fm)
    mesh = device_mesh(8)
    rng = np.random.RandomState(1)
    codes = rng.randint(1, 5, size=(100, 12)).astype(np.int32)  # non-multiple
    lo, hi = sharded_backward_search(mesh, arrays, codes)
    elo, ehi = (
        np.asarray(a)
        for a in fm_ops.backward_search_codes(arrays, jnp.asarray(codes))
    )
    np.testing.assert_array_equal(lo, elo)
    np.testing.assert_array_equal(hi, ehi)


def test_train_step_stats_reduction(fm):
    arrays = fm_ops.to_device(fm)
    mesh = device_mesh(8)
    rng = np.random.RandomState(2)
    codes = rng.randint(1, 5, size=(64, 8)).astype(np.int32)
    arrays_r = replicate(mesh, arrays)
    codes_d = shard_batch(mesh, jnp.asarray(codes))
    step = make_train_step(mesh)
    counts, total, nonzero = step(arrays_r, codes_d)
    ecounts = np.asarray(
        fm_ops.backward_search_codes(arrays, jnp.asarray(codes))[1]
    ) - np.asarray(
        fm_ops.backward_search_codes(arrays, jnp.asarray(codes))[0]
    )
    assert int(total) == int(ecounts.sum())
    assert int(nonzero) == int((ecounts > 0).sum())


def test_graft_entry():
    import sys, pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (1024,)
    ge.dryrun_multichip(8)


def test_sharded_trie_search_matches_single():
    import jax.numpy as jnp

    from psi_tpu.fmindex import FMIndex
    from psi_tpu.ops import fm as fm_ops, fm_trie
    from psi_tpu.parallel.mesh import device_mesh, sharded_trie_search

    rng = np.random.RandomState(23)
    s = "".join(rng.choice(list("ACGT"), size=60_000))
    fm = FMIndex.build_from_strings([s[::-1]])
    sarr = fm_trie.build_stream_arrays(fm)
    dense = fm_ops.to_device(fm, dense_occ=True)

    k = 12
    keys = np.unique(rng.randint(0, 4 ** k, size=4000).astype(np.uint64))
    mesh = device_mesh(8)
    lo, hi = sharded_trie_search(mesh, sarr, keys, k)
    l1, h1 = fm_ops.backward_search_codes(
        dense, jnp.asarray(fm_ops.keys_to_codes(keys, k))
    )
    np.testing.assert_array_equal(np.asarray(h1) - np.asarray(l1), hi - lo)
    nz = (h1 > l1)
    np.testing.assert_array_equal(np.asarray(l1)[nz], lo[np.asarray(nz)])
