"""KMC3 / kmc_tools-equivalent operations on KmerTables.

Semantics contract (mirrors what the reference pipeline relies on):

- ``count_codes``: canonical counting with saturating counters, default cap
  255 (KMC's default -cs; the reference passes -ci1 so singletons are kept,
  workflow/rules/exp_type_1.smk:163).
- ``set_counts``: `kmc_tools transform ... set_counts c`
  (exp_type_1.smk:173).
- ``union_many``: n-way `kmc_tools complex` union with counter *sum*,
  saturating at cs (the reference always passes -cs5000,
  exp_type_1.smk:61,84).
- ``intersect_sum``: `kmc_tools simple A B intersect -ocsum`
  (exp_type_2.smk:362-366): keys in both, count = cA+cB.
- ``subtract``: `kmc_tools simple A B kmers_subtract` (exp_type_2.smk:368-380):
  keys of A absent from B, counts from A.
- ``histogram``: `kmc_tools transform ... histogram` (exp_type_1.smk:191):
  hist[i] = number of distinct present keys with count == i, i in 1..cx.

Everything is static-shape: absent keys are encoded as count==0 and unused
capacity as SENTINEL keys, so tables compose under jit/vmap/shard_map.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .bits import (
    SENTINEL,
    key_words,
    words_eq,
    words_is_sentinel,
)
from .extract import extract_canonical
from .table import KmerTable

__all__ = [
    "count_codes",
    "dedupe_sorted",
    "union_many",
    "intersect_sum",
    "subtract",
    "set_counts",
    "histogram",
    "n_present",
    "total_count",
    "count_keys",
]


def _sort_keys_counts(keys: tuple, *payloads):
    w = len(keys)
    sorted_ops = jax.lax.sort(
        list(keys) + list(payloads), num_keys=w, is_stable=False
    )
    return tuple(sorted_ops[:w]), sorted_ops[w:]


def _run_starts(keys: tuple):
    """is_new[i] = keys[i] != keys[i-1] (run boundaries of a sorted array)."""
    prev = tuple(jnp.roll(kw, 1) for kw in keys)
    is_new = ~words_eq(keys, prev)
    return is_new.at[0].set(True)


def _run_sums(counts: jnp.ndarray, is_new: jnp.ndarray) -> jnp.ndarray:
    """Segment sums of a sorted run structure, written at each run's FIRST
    slot (0 elsewhere). Gather/scatter-free: it uses the monotonicity of
    inclusive prefix sums:
    the s-value at MY run's end is the reverse-cummin of s masked to
    run-last slots. Exact in modular uint32 as long as each run's true sum
    < 2^32 (always holds: per-key counts are capped at <=10000 per input).
    """
    s = jnp.cumsum(counts, dtype=jnp.uint32)
    e = s - counts  # exclusive prefix
    is_last = jnp.roll(is_new, -1)  # last slot of each run; [-1] -> True
    mask_s = jnp.where(is_last, s, jnp.uint32(0xFFFFFFFF))
    s_end = jax.lax.cummin(mask_s, axis=0, reverse=True)
    return jnp.where(is_new, s_end - e, 0).astype(jnp.uint32)


def dedupe_sorted(keys: tuple, counts: jnp.ndarray, cs: int) -> tuple:
    """Collapse runs of equal keys in a sorted array, summing counts (sat. cs).

    Output is in *run form* (the KmerTable invariant): keys unchanged
    (ascending, duplicates allowed), with the run's total count stored at
    the run's FIRST slot and 0 elsewhere.
    """
    is_new = _run_starts(keys)
    run = _run_sums(counts, is_new)
    ucounts = jnp.minimum(run, jnp.uint32(cs))
    ucounts = jnp.where(words_is_sentinel(keys), 0, ucounts).astype(jnp.uint32)
    return keys, ucounts


def count_keys(keys: tuple, valid: jnp.ndarray, k: int, cs: int = 255) -> KmerTable:
    """Build a count table from pre-extracted canonical keys."""
    ones = valid.astype(jnp.uint32)
    skeys, (scounts,) = _sort_keys_counts(keys, ones)
    ukeys, ucounts = dedupe_sorted(skeys, scounts, cs)
    return KmerTable(keys=ukeys, counts=ucounts, k=k)


def count_codes(codes: jnp.ndarray, k: int, cs: int = 255) -> KmerTable:
    """Canonical k-mer counting over encoded codes (KMC `kmc -ci1` role)."""
    keys, valid = extract_canonical(codes, k)
    return count_keys(keys, valid, k, cs)


def set_counts(t: KmerTable, c: int) -> KmerTable:
    counts = jnp.where(t.counts > 0, jnp.uint32(c), jnp.uint32(0))
    return KmerTable(keys=t.keys, counts=counts, k=t.k)


def union_many(tables: list, cs: int = 5000, capacity: int | None = None) -> KmerTable:
    """n-way union with counter sum (kmc_tools complex '+', -cs{cs})."""
    k = tables[0].k
    w = tables[0].n_words
    for t in tables:
        assert t.k == k and t.n_words == w
    keys = tuple(
        jnp.concatenate([t.keys[i] for t in tables]) for i in range(w)
    )
    counts = jnp.concatenate([t.counts for t in tables])
    skeys, (scounts,) = _sort_keys_counts(keys, counts)
    ukeys, ucounts = dedupe_sorted(skeys, scounts, cs)
    return KmerTable(keys=ukeys, counts=ucounts, k=k)


def _merge_two(a: KmerTable, b: KmerTable):
    """Merge a and b into one sorted run structure with per-side run sums.

    Returns (keys, a_sum, b_sum) where *_sum carry each side's count at the
    run's first slot. Merge-by-sort: one unstable variadic sort instead of
    log(C) dependent gathers per key.
    """
    w = a.n_words
    keys = tuple(jnp.concatenate([a.keys[i], b.keys[i]]) for i in range(w))
    zeros_a = jnp.zeros_like(b.counts)
    zeros_b = jnp.zeros_like(a.counts)
    ca = jnp.concatenate([a.counts, zeros_a])
    cb = jnp.concatenate([zeros_b, b.counts])
    skeys, (sca, scb) = _sort_keys_counts(keys, ca, cb)
    is_new = _run_starts(skeys)
    a_sum = _run_sums(sca, is_new)
    b_sum = _run_sums(scb, is_new)
    sent = words_is_sentinel(skeys)
    return skeys, jnp.where(sent, 0, a_sum), jnp.where(sent, 0, b_sum)


def intersect_sum(a: KmerTable, b: KmerTable, cs: int = 255) -> KmerTable:
    """`kmc_tools simple a b intersect -ocsum` (keys in both, counts summed)."""
    keys, a_sum, b_sum = _merge_two(a, b)
    both = (a_sum > 0) & (b_sum > 0)
    counts = jnp.where(both, jnp.minimum(a_sum + b_sum, jnp.uint32(cs)), 0)
    return KmerTable(keys=keys, counts=counts.astype(jnp.uint32), k=a.k)


def subtract(a: KmerTable, b: KmerTable) -> KmerTable:
    """`kmc_tools simple a b kmers_subtract` (keys of a not in b)."""
    keys, a_sum, b_sum = _merge_two(a, b)
    counts = jnp.where((a_sum > 0) & (b_sum == 0), a_sum, jnp.uint32(0))
    return KmerTable(keys=keys, counts=counts.astype(jnp.uint32), k=a.k)


def histogram(t: KmerTable, cx: int = 10000) -> jnp.ndarray:
    """Occurrence histogram: out[i-1] = #present keys with count i, i=1..cx.

    Computed by sorting the (small-dtype, single-word) counts and binary
    searching the cx bin edges — no scatter.
    """
    counts = jnp.minimum(t.counts, jnp.uint32(cx + 1))
    sorted_counts = jax.lax.sort(counts)
    edges = jnp.arange(1, cx + 2, dtype=jnp.uint32)
    pos = jnp.searchsorted(sorted_counts, edges, side="left")
    return (pos[1:] - pos[:-1]).astype(jnp.int64 if jax.config.jax_enable_x64 else jnp.int32)


def n_present(t: KmerTable) -> jnp.ndarray:
    return jnp.sum((t.counts > 0).astype(jnp.int32))


def total_count(t: KmerTable) -> jnp.ndarray:
    return jnp.sum(t.counts.astype(jnp.int32))
