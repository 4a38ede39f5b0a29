"""Sharded fused genome-occurrence histogram — the multi-chip north star.

Distributes engine/occurrence.py over the "kv" mesh axis: genome slabs
stream data-parallel (k-1 halo), each device extracts canonical keys with
genome-id labels, ONE all_to_all exchanges (key, gid) pairs by the fixed
key-range split points, each shard sorts its range and runs the
distinct-gid occurrence scan, and the histogram finishes with a psum —
the whole exp1 inner loop (count per genome + union + histogram,
reference workflow/rules/exp_type_1.smk:156-191) as one SPMD program.

Determinism: integer counters and per-shard sorted reduction order make
the result identical for any device count (tested against the
single-device fused path and the oracle).
"""

from __future__ import annotations

import math
from functools import lru_cache, partial
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..engine.bits import (
    SENTINEL,
    key_words,
    searchsorted_words,
    take_words,
    words_eq,
    words_is_sentinel,
)
from ..engine.extract import extract_canonical
from ..engine.occurrence import (
    GID_BITS,
    _extract_canonical_dyn,
    _pack_gid_words,
    _packed_occ,
    kmax_class_packed,
    occ_words_packed,
    occ_words_static,
    pack_gid_static,
    pack_members,
)
from ..engine.ops import _run_sums
from .mesh import AXIS, split_keys_for

SPLIT_SAMPLE = 128  # per-shard quantile-sample size for data-driven splits


def _local_occurrence(
    slab_codes, slab_gids, k, cs, cx, n_words, n_members, n_shards, splits, bucket_cap
):
    codes = slab_codes[0]
    gids = slab_gids[0]
    keys, valid = extract_canonical(codes, k)
    gid_k = jnp.where(valid, gids, jnp.uint32(0xFFFFFFFF))
    sorted_ops = jax.lax.sort(
        list(keys) + [gid_k], num_keys=n_words + 1, is_stable=False
    )
    skeys = tuple(sorted_ops[:n_words])
    sgids = sorted_ops[n_words]

    # local (key, gid) dedupe: mark duplicate pairs absent to cut exchange
    prev_keys = tuple(jnp.roll(w, 1) for w in skeys)
    key_new = ~words_eq(skeys, prev_keys)
    key_new = key_new.at[0].set(True)
    pair_new = key_new | (sgids != jnp.roll(sgids, 1))

    # range-partition boundaries over the sorted keys
    bnds = [jnp.zeros((), jnp.int32)]
    for i in range(n_shards - 1):
        q = tuple(jnp.full((1,), splits[i, wi], jnp.uint32) for wi in range(n_words))
        bnds.append(searchsorted_words(skeys, q)[0])
    sent_q = tuple(jnp.full((1,), SENTINEL, jnp.uint32) for _ in range(n_words))
    bnds.append(searchsorted_words(skeys, sent_q)[0])
    bounds = jnp.stack(bnds)

    sizes = bounds[1:] - bounds[:-1]
    overflow = jnp.max(sizes) > bucket_cap

    j = jnp.arange(bucket_cap, dtype=jnp.int32)[None, :]
    idx = bounds[:-1, None] + j
    in_range = idx < bounds[1:, None]
    gidx = jnp.minimum(idx, skeys[0].shape[0] - 1)
    keep = in_range & jnp.take(pair_new, gidx, mode="clip")
    send_keys = tuple(
        jnp.where(keep, jnp.take(w, gidx, mode="clip"), SENTINEL) for w in skeys
    )
    send_gids = jnp.where(keep, jnp.take(sgids, gidx, mode="clip"), jnp.uint32(0xFFFFFFFF))

    recv_keys = tuple(
        jax.lax.all_to_all(w, AXIS, split_axis=0, concat_axis=0, tiled=True)
        for w in send_keys
    )
    recv_gids = jax.lax.all_to_all(send_gids, AXIS, split_axis=0, concat_axis=0, tiled=True)

    flat_keys = tuple(w.reshape(-1) for w in recv_keys)
    flat_gids = recv_gids.reshape(-1)
    merged = jax.lax.sort(
        list(flat_keys) + [flat_gids], num_keys=n_words + 1, is_stable=False
    )
    mkeys = tuple(merged[:n_words])
    mgids = merged[n_words]

    mprev = tuple(jnp.roll(w, 1) for w in mkeys)
    mkey_new = ~words_eq(mkeys, mprev)
    mkey_new = mkey_new.at[0].set(True)
    sub_start = (mkey_new | (mgids != jnp.roll(mgids, 1))).astype(jnp.uint32)
    occ = _run_sums(sub_start, mkey_new)
    occ = jnp.minimum(occ, jnp.uint32(cs))
    occ = jnp.where(words_is_sentinel(mkeys), 0, occ)

    max_occ = min(n_members, cx)
    bins = [jnp.sum((occ == b).astype(jnp.int32)) for b in range(1, max_occ + 1)]
    hist = jnp.zeros((cx,), jnp.int32).at[:max_occ].set(jnp.stack(bins))
    hist = jax.lax.psum(hist, AXIS)
    overflow_any = jax.lax.pmax(overflow.astype(jnp.int32), AXIS)
    return hist, overflow_any


def split_keys_packed(k: int, n_shards: int) -> np.ndarray:
    """Packed-form split points: (split_key << GID_BITS) over the packed
    word count, so range partitioning by packed value equals partitioning
    by key (gid bits below the shift never affect the range)."""
    from .mesh import _fraction_to_key  # reuse the canonical-CDF quantiles

    ow = occ_words_static(k)
    out = np.zeros((max(n_shards - 1, 0), ow), np.uint32)
    for i in range(1, n_shards):
        frac = 1.0 - math.sqrt(1.0 - i / n_shards)
        kw = _fraction_to_key(frac, k)
        v = 0
        for word in kw:
            v = (v << 32) | int(word)
        v <<= GID_BITS
        for wi in range(ow):
            out[i - 1, wi] = (v >> (32 * (ow - 1 - wi))) & 0xFFFFFFFF
    return out


def _local_occurrence_packed(
    slab_codes, slab_gids, k, cs, cx, n_members, n_shards, splits, bucket_cap
):
    """Gid-packed variant of _local_occurrence: the (key, gid) pair rides in
    occ_words_static(k) words through both sorts AND the all_to_all, cutting
    sort operands and ICI exchange volume by 1-2 words/element for the whole
    reference k grid (engine/occurrence.py GID_BITS rationale)."""
    ow = occ_words_static(k)
    codes = slab_codes[0]
    gids = slab_gids[0]
    keys, valid = extract_canonical(codes, k)
    packed = pack_gid_static(keys, valid, gids, k)
    sp = tuple(jax.lax.sort(list(packed), num_keys=ow, is_stable=False))

    # local (key, gid) dedupe: mark duplicate pairs absent to cut exchange
    prev = tuple(jnp.roll(w, 1) for w in sp)
    pair_new = (~words_eq(sp, prev)).at[0].set(True)

    bnds = [jnp.zeros((), jnp.int32)]
    for i in range(n_shards - 1):
        q = tuple(jnp.full((1,), splits[i, wi], jnp.uint32) for wi in range(ow))
        bnds.append(searchsorted_words(sp, q)[0])
    sent_q = tuple(jnp.full((1,), SENTINEL, jnp.uint32) for _ in range(ow))
    bnds.append(searchsorted_words(sp, sent_q)[0])
    bounds = jnp.stack(bnds)

    sizes = bounds[1:] - bounds[:-1]
    overflow = jnp.max(sizes) > bucket_cap

    j = jnp.arange(bucket_cap, dtype=jnp.int32)[None, :]
    idx = bounds[:-1, None] + j
    in_range = idx < bounds[1:, None]
    gidx = jnp.minimum(idx, sp[0].shape[0] - 1)
    keep = in_range & jnp.take(pair_new, gidx, mode="clip")
    send = tuple(
        jnp.where(keep, jnp.take(w, gidx, mode="clip"), SENTINEL) for w in sp
    )
    recv = tuple(
        jax.lax.all_to_all(w, AXIS, split_axis=0, concat_axis=0, tiled=True)
        for w in send
    )
    flat = tuple(w.reshape(-1) for w in recv)
    sm = tuple(jax.lax.sort(list(flat), num_keys=ow, is_stable=False))
    occ = _packed_occ(sm, cs, ow)

    max_occ = min(n_members, cx)
    bins = [jnp.sum((occ == b).astype(jnp.int32)) for b in range(1, max_occ + 1)]
    hist = jnp.zeros((cx,), jnp.int32).at[:max_occ].set(jnp.stack(bins))
    hist = jax.lax.psum(hist, AXIS)
    overflow_any = jax.lax.pmax(overflow.astype(jnp.int32), AXIS)
    return hist, overflow_any


def _sampled_splits(sp: tuple, n_valid, n_shards: int, pos=None, gid_bits: int = GID_BITS):
    """Data-driven split keys from a global WEIGHTED quantile sample
    (skew-robust).

    Each shard contributes SPLIT_SAMPLE elements strided over its valid
    (non-sentinel) sorted prefix, each carrying weight n_valid/SAMPLE so
    shards with unequal loads (tail padding, short slabs) are represented
    proportionally.  The all_gathered sample is sorted with its weights and
    the (i/n_shards)-quantiles of the cumulative weight become the split
    keys.  Deterministic and identical on every shard (same program, same
    gathered sample), so the induced key ranges are consistent.  Replaces
    the uniform-CDF split table (mesh.split_keys_for), whose
    min-of-two-uniforms assumption breaks on GC-skewed or repeat-heavy
    genomes and triggers the overflow-retry-recompile loop.
    """
    w = len(sp)
    S = SPLIT_SAMPLE
    j = jnp.arange(S, dtype=jnp.int32)
    # j * n_valid // S without int32 overflow for large slabs
    idx = j * (n_valid // S) + (j * (n_valid % S)) // S
    idx = jnp.minimum(idx, jnp.maximum(n_valid - 1, 0))
    if pos is not None:  # sample in dedup-rank space
        idx = jnp.take(pos, idx, mode="clip")
    local = take_words(sp, idx)
    empty = n_valid == 0
    local = tuple(jnp.where(empty, SENTINEL, x) for x in local)
    weight = jnp.where(
        empty, 0.0, jnp.full((S,), 1.0) * (n_valid.astype(jnp.float32) / S)
    )
    gk = tuple(jax.lax.all_gather(x, AXIS, tiled=True) for x in local)
    gw = jax.lax.all_gather(weight, AXIS, tiled=True)
    srt = jax.lax.sort(list(gk) + [gw], num_keys=w, is_stable=False)
    skeys, sw = tuple(srt[:w]), srt[w]
    cum = jnp.cumsum(sw)
    total = cum[-1]
    targets = (jnp.arange(1, n_shards, dtype=jnp.float32) * total) / n_shards
    pos = jnp.searchsorted(cum, targets).astype(jnp.int32)
    pos = jnp.minimum(pos, cum.shape[0] - 1)
    picked = take_words(skeys, pos)
    if gid_bits == 0:  # plain keys (no packed payload to strip)
        return picked
    # align splits to KEY boundaries: a sampled packed value carries gid
    # bits, and a split inside a key's (key, gid) run would tear that key's
    # occurrence count across two shards
    mask = jnp.uint32((0xFFFFFFFF << gid_bits) & 0xFFFFFFFF)
    return picked[:-1] + (picked[-1] & mask,)


def _local_occurrence_dyn_packed(
    slab_codes, slab_gids, k, *, kmax, ow, cs, cx, n_members, n_shards,
    bucket_cap, chunk
):
    """Dynamic-k gid-packed SPMD occurrence: k is a TRACED scalar, so one
    compile serves every k of a packed word class (mirrors
    engine/occurrence.py's dynamic-k path; the reference recompiles — i.e.
    re-runs kmc — for each of its 30 grid points, workflow/Snakefile:36).
    Split points are sampled from the data (see _sampled_splits), which
    also removes the static per-k split-table dependence."""
    codes = slab_codes[0]
    gids = slab_gids[0]
    keys, valid = _extract_canonical_dyn(codes, k, kmax, ow)
    # slabs carry a fixed kmax-1 halo; windows starting past `chunk` belong
    # to the next shard (they are only halo context here)
    own = jnp.arange(codes.shape[0], dtype=jnp.int32) < chunk
    packed = _pack_gid_words(keys, valid & own, gids, ow)
    sp = tuple(jax.lax.sort(list(packed), num_keys=ow, is_stable=False))
    n = sp[0].shape[0]

    # dedup-rank space: rank[i] = #distinct (key, gid) pairs at or before i.
    # Bucketing in rank space (not raw positions) bounds each bucket by the
    # DEDUPED pair count, so a massively repeated key (poly-A runs, repeat
    # families) cannot overflow a bucket no matter its raw multiplicity.
    from .sharded import rank_positions

    prev = tuple(jnp.roll(w, 1) for w in sp)
    pair_new = (~words_eq(sp, prev)).at[0].set(True) & ~words_is_sentinel(sp)
    rank, pos, total_pairs = rank_positions(pair_new)

    splits = _sampled_splits(sp, total_pairs, n_shards, pos=pos)
    split_pos = searchsorted_words(sp, splits)
    split_rank = jnp.where(
        split_pos > 0, jnp.take(rank, jnp.maximum(split_pos - 1, 0), mode="clip"), 0
    )
    bounds = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), split_rank, total_pairs[None]]
    )

    sizes = bounds[1:] - bounds[:-1]
    overflow = jnp.max(sizes) > bucket_cap

    j = jnp.arange(bucket_cap, dtype=jnp.int32)[None, :]
    tr = bounds[:-1, None] + j  # 0-based target ranks per bucket slot
    in_range = tr < bounds[1:, None]
    gpos = jnp.take(pos, jnp.minimum(tr, n - 1), mode="clip")
    send = tuple(
        jnp.where(in_range, jnp.take(w, gpos, mode="clip"), SENTINEL) for w in sp
    )
    recv = tuple(
        jax.lax.all_to_all(w, AXIS, split_axis=0, concat_axis=0, tiled=True)
        for w in send
    )
    flat = tuple(w.reshape(-1) for w in recv)
    sm = tuple(jax.lax.sort(list(flat), num_keys=ow, is_stable=False))
    occ = _packed_occ(sm, cs, ow)

    max_occ = min(n_members, cx)
    bins = [jnp.sum((occ == b).astype(jnp.int32)) for b in range(1, max_occ + 1)]
    hist = jnp.zeros((cx,), jnp.int32).at[:max_occ].set(jnp.stack(bins))
    hist = jax.lax.psum(hist, AXIS)
    overflow_any = jax.lax.pmax(overflow.astype(jnp.int32), AXIS)
    return hist, overflow_any


@lru_cache(maxsize=64)
def _dyn_occ_fn(mesh, kmax, ow, n_members, n_shards, cs, cx, bucket_cap, chunk):
    """Jitted shard_map for the dynamic-k path, cached so repeated calls
    (the k sweep) reuse one traced/compiled program per word class
    instead of constructing one per call."""
    local = partial(
        _local_occurrence_dyn_packed,
        kmax=kmax,
        ow=ow,
        cs=cs,
        cx=cx,
        n_members=n_members,
        n_shards=n_shards,
        bucket_cap=bucket_cap,
        chunk=chunk,
    )
    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS, None), P()),
            out_specs=(P(), P()),
        )
    )


@lru_cache(maxsize=64)
def _static_occ_fn(mesh, k, packed_gid, n_members, n_shards, cs, cx, bucket_cap):
    if packed_gid:
        local = partial(
            _local_occurrence_packed,
            k=k,
            cs=cs,
            cx=cx,
            n_members=n_members,
            n_shards=n_shards,
            splits=split_keys_packed(k, n_shards),
            bucket_cap=bucket_cap,
        )
    else:
        local = partial(
            _local_occurrence,
            k=k,
            cs=cs,
            cx=cx,
            n_words=key_words(k),
            n_members=n_members,
            n_shards=n_shards,
            splits=split_keys_for(k, n_shards),
            bucket_cap=bucket_cap,
        )
    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS, None)),
            out_specs=(P(), P()),
        )
    )


def _make_slab_pair(codes: np.ndarray, gids: np.ndarray, n_shards: int, k: int):
    n = codes.shape[0]
    chunk = max(1, math.ceil(n / n_shards))
    slab_len = chunk + k - 1
    cs_out = np.full((n_shards, slab_len), 4, np.uint8)
    gs_out = np.zeros((n_shards, slab_len), np.uint32)
    for d in range(n_shards):
        lo = d * chunk
        hi = min(n, lo + slab_len)
        if lo < n:
            cs_out[d, : hi - lo] = codes[lo:hi]
            gs_out[d, : hi - lo] = gids[lo:hi]
    return cs_out, gs_out


def sharded_occurrence_histogram(
    mesh: Mesh,
    member_codes: Sequence[np.ndarray],
    k: int,
    cs: int = 5000,
    cx: int = 10000,
    bucket_cap: int | None = None,
    slack: float = 1.5,
    dynamic_k: bool = True,
) -> List[int]:
    """Multi-device equivalent of engine.occurrence.occurrence_histogram.

    dynamic_k=True (default, n_members <= 256 and k <= 60) traces k as a
    runtime scalar with data-sampled split points: ONE compile serves every
    k of a packed word class, so a k sweep costs 2-4 compiles instead of
    30.  Jitted programs are cached module-level; only a shard-capacity
    overflow (rare, data-sampled splits balance shards) recompiles.
    """
    d = mesh.devices.size
    codes, gids = pack_members(member_codes)
    n = codes.shape[0]
    if bucket_cap is None:
        bucket_cap = max(64, int(slack * math.ceil(n / d / max(d, 1))))

    packed_gid = len(member_codes) <= (1 << GID_BITS)
    if dynamic_k and packed_gid and k <= 60:
        kmax = kmax_class_packed(k)
        ow = occ_words_packed(kmax)
        chunk = max(1, math.ceil(n / d))
        slab_codes, slab_gids = _make_slab_pair(codes, gids, d, kmax)
        while True:
            fn = _dyn_occ_fn(
                mesh, kmax, ow, len(member_codes), d, cs, cx, bucket_cap, chunk
            )
            hist, overflow = fn(
                jnp.asarray(slab_codes), jnp.asarray(slab_gids), jnp.uint32(k)
            )
            if int(np.asarray(overflow)) == 0:
                break
            bucket_cap *= 2
        return np.asarray(hist).tolist()

    slab_codes, slab_gids = _make_slab_pair(codes, gids, d, k)
    while True:
        fn = _static_occ_fn(
            mesh, k, packed_gid, len(member_codes), d, cs, cx, bucket_cap
        )
        hist, overflow = fn(jnp.asarray(slab_codes), jnp.asarray(slab_gids))
        if int(np.asarray(overflow)) == 0:
            break
        bucket_cap *= 2
    return np.asarray(hist).tolist()
