"""Device-side distance-index probes (the query half of DiVerG's
accelerator offload, ref: include/psi/seed_finder.hpp:783-790 Kokkos
exec space selection; SURVEY §2.2 DiVerG row).

The host index stores one composite int64 sorted key per interval row
(dindex._pair_keys). JAX x64 is disabled on device (CLAUDE.md), so the
keys travel as two int32 halves (hi = key >> 31, lo = key & 0x7fffffff
— both non-negative, comparing (hi, lo) lexicographically == comparing
the int64 keys). A probe for query q answers: does the LAST row with
key <= q belong to q's (src, dst) pair and intersect [s_lo, s_hi]?

Two exact formulations (PSI_DINDEX_PROBE picks):

  * probe_sort — ONE multi-key lax.sort of rows ++ queries with a tag
    as the tie-breaking key; each query's searchsorted-right position
    falls out of a cumsum over the merged order. No dependent
    gathers: sort + cumsum + one scatter.
  * probe_bisect — fixed-trip lexicographic binary search, 2 gathers
    per step. Fewer total ops, but each step's gathers depend on the
    previous step's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def probe_bisect(pk_hi, pk_lo, src, dst, iv_lo, iv_hi,
                 q_hi, q_lo, q_src, q_dst, s_lo, s_hi):
    """Lexicographic searchsorted-right by fixed-trip bisection, then
    the pair/intersect checks at the found row. Returns bool [B]."""
    n = pk_hi.shape[0]
    B = q_hi.shape[0]
    lo = jnp.zeros(B, dtype=jnp.int32)
    hi = jnp.full(B, n, dtype=jnp.int32)
    steps = max(int(n).bit_length(), 1)

    def body(_, lh):
        lo, hi = lh
        live = lo < hi
        mid = jnp.clip((lo + hi) // 2, 0, n - 1)
        mh = pk_hi[mid]
        ml = pk_lo[mid]
        le = (mh < q_hi) | ((mh == q_hi) & (ml <= q_lo))  # pk[mid] <= q
        new_lo = jnp.where(le, mid + 1, lo)
        new_hi = jnp.where(le, hi, mid)
        return (jnp.where(live, new_lo, lo), jnp.where(live, new_hi, hi))

    r, _ = jax.lax.fori_loop(0, steps, body, (lo, hi))
    rc = jnp.clip(r - 1, 0, n - 1)
    return (
        (r >= 1)
        & (src[rc] == q_src) & (dst[rc] == q_dst)
        & (iv_hi[rc] >= s_lo) & (iv_lo[rc] <= s_hi)
    )


@jax.jit
def probe_sort(pk_hi, pk_lo, src, dst, iv_lo, iv_hi,
               q_hi, q_lo, q_src, q_dst, s_lo, s_hi):
    """Merge-by-sort searchsorted: sort (key_hi, key_lo, tag) over the
    concatenated rows (tag 0) and queries (tag 1). Equal keys place
    rows first, so a query at merged slot i has r = searchsorted_right
    = i - (#queries at or before i) + 1. One sort + cumsum + scatter."""
    n = pk_hi.shape[0]
    B = q_hi.shape[0]
    hi_cat = jnp.concatenate([pk_hi, q_hi])
    lo_cat = jnp.concatenate([pk_lo, q_lo])
    tag = jnp.concatenate([
        jnp.zeros(n, dtype=jnp.int32), jnp.ones(B, dtype=jnp.int32)
    ])
    idx = jnp.arange(n + B, dtype=jnp.int32)
    _, _, tag_s, idx_s = jax.lax.sort(
        (hi_cat, lo_cat, tag, idx), num_keys=3, is_stable=True
    )
    csum = jnp.cumsum(tag_s)
    # for merged slot i holding a query: rows before it = i - (csum[i]-1)
    pos = jnp.arange(n + B, dtype=jnp.int32)
    r_at_slot = pos - csum + 1
    qslot = jnp.where(tag_s == 1, idx_s - n, B)  # original query id
    r = jnp.zeros(B, dtype=jnp.int32).at[qslot].max(
        r_at_slot, mode="drop"
    )
    rc = jnp.clip(r - 1, 0, jnp.maximum(n - 1, 0))
    return (
        (r >= 1)
        & (src[rc] == q_src) & (dst[rc] == q_dst)
        & (iv_hi[rc] >= s_lo) & (iv_lo[rc] <= s_hi)
    )
