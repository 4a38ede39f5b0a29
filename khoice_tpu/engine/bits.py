"""Multi-word uint32 key arithmetic for k-mer keys.

JAX runs with 32-bit integers unless x64 is enabled, so a k-mer is encoded as
a tuple of uint32 "words", most-significant first, holding the 2k-bit base-4 number with
A=0, C=1, G=2, T=3.  Numeric order of this encoding equals lexicographic
order of the k-mer string under A<C<G<T — the order KMC3's sorted dumps use
and the order the reference's Python canonicalization relies on
(reference: src/merge_lists.py:60-73).

Word-count rule leaves >=1 spare bit so the all-ones SENTINEL can never
collide with a valid key:
    k <= 15  -> 1 word  (30 bits used)
    k <= 31  -> 2 words (62 bits used)
    k <= 63  -> 4 words (126 bits used)
"""

from __future__ import annotations

import jax.numpy as jnp

SENTINEL = jnp.uint32(0xFFFFFFFF)


def key_words(k: int) -> int:
    """Number of uint32 words used for a k-mer key."""
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    if k <= 15:
        return 1
    if k <= 31:
        return 2
    if k <= 63:
        return 4
    raise ValueError(f"k={k} not supported (max 63)")


def zeros_key(n_words: int, shape) -> tuple:
    return tuple(jnp.zeros(shape, jnp.uint32) for _ in range(n_words))


def sentinel_key(n_words: int, shape) -> tuple:
    return tuple(jnp.full(shape, SENTINEL, jnp.uint32) for _ in range(n_words))


def shl2_or(words: tuple, digit) -> tuple:
    """(key << 2) | digit across the word tuple. digit: uint32 in [0,3]."""
    out = []
    n = len(words)
    for i in range(n - 1):
        out.append((words[i] << 2) | (words[i + 1] >> 30))
    out.append((words[n - 1] << 2) | digit)
    return tuple(out)


def shr2(words: tuple) -> tuple:
    """key >> 2 across the word tuple."""
    out = []
    n = len(words)
    for i in range(n):
        hi = jnp.zeros_like(words[i]) if i == 0 else (words[i - 1] << 30)
        out.append(hi | (words[i] >> 2))
    return tuple(out)


def words_lt(a: tuple, b: tuple):
    """Lexicographic a < b over word tuples (elementwise arrays)."""
    lt = jnp.zeros(jnp.broadcast_shapes(a[0].shape, b[0].shape), bool)
    eq = jnp.ones_like(lt)
    for aw, bw in zip(a, b):
        lt = lt | (eq & (aw < bw))
        eq = eq & (aw == bw)
    return lt


def words_eq(a: tuple, b: tuple):
    eq = None
    for aw, bw in zip(a, b):
        e = aw == bw
        eq = e if eq is None else (eq & e)
    return eq


def words_select(pred, a: tuple, b: tuple) -> tuple:
    """where(pred, a, b) across word tuples."""
    return tuple(jnp.where(pred, aw, bw) for aw, bw in zip(a, b))


def words_is_sentinel(a: tuple):
    m = None
    for aw in a:
        e = aw == SENTINEL
        m = e if m is None else (m & e)
    return m


def take_words(words: tuple, idx) -> tuple:
    """Gather words[idx] for each word array."""
    return tuple(jnp.take(w, idx, axis=0, mode="clip") for w in words)


def searchsorted_words(sorted_words: tuple, query_words: tuple):
    """Vectorized lower-bound binary search over a sorted multi-word array.

    Returns, for each query key, the first index i such that
    sorted[i] >= query.  sorted_words must be ascending (sentinel padding at
    the end is fine since SENTINEL is the maximum key).
    """
    c = sorted_words[0].shape[0]
    nq = query_words[0].shape
    lo = jnp.zeros(nq, jnp.int32)
    hi = jnp.full(nq, c, jnp.int32)
    # interval [lo, hi] starts with length c+1; need ceil(log2(c+1)) halvings
    n_iter = int(c).bit_length() if c > 0 else 0
    for _ in range(n_iter):
        mid = (lo + hi) >> 1
        mid_words = take_words(sorted_words, mid)
        pred = words_lt(mid_words, query_words)  # sorted[mid] < q -> go right
        lo = jnp.where(pred, mid + 1, lo)
        hi = jnp.where(pred, hi, mid)
    return lo
