"""Sharded exp6 read voting: the merge-join classifier SPMD over the mesh.

The reference fans exp6 across cores exactly like the other experiments
(one Snakemake rule instance per (k, pivot), workflow/rules/
exp_type_6.smk:264-319, then merge_lists.py -r votes each pivot's reads);
exp6 used to vote on a single device.  This module gives classify/annotate's
multi-pivot merge voting the same key-range SPMD treatment as the exp1
sweep (dist/ksweep.py):

- the combined [group texts ++ all pivots' reads] byte stream slabs
  data-parallel with a kmax-1 halo; each shard extracts canonical
  k-mer keys (dynamic k: one compile per key-word class) for its own
  windows, with a single uint32 payload — gid for text windows,
  D + global read id for query windows;
- ONE all_to_all exchanges (key, payload) elements keyed by
  data-sampled split boundaries (lower-bound searchsorted, so no key's
  run ever tears across shards);
- each shard sorts its range by (key, payload): text payloads (< D)
  sort before query payloads within every run, so a FORWARD segmented
  OR of text one-hot gids gives each query element its full dataset
  mask with no backward pass;
- per-read partial (votes, unmatched, n_kmers) come from a read-id
  sort + cumulative sums + two searchsorteds (scatter-free densify),
  and psum to the exact single-device totals — integer votes make the
  reduction order-independent (classify/annotate.py's LCM weighting).

Bit-identical to read_votes_bulk_multi (tested on the 8-virtual-device
CPU mesh across key-word classes, and via exp6 trial-CSV byte equality
at --mesh-shards 8).
"""

from __future__ import annotations

import math
from functools import lru_cache, partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..engine.bits import SENTINEL, key_words, searchsorted_words, words_eq, words_is_sentinel
from ..engine.occurrence import _extract_canonical_dyn
from .mesh import AXIS
from .occurrence import _make_slab_pair, _sampled_splits
from .sharded import rank_positions

_PAD_PAY = np.uint32(0xFFFFFFFF)


def _local_vote(slab_codes, slab_pays, k, *, kmax, nw, D, lcm, n_reads,
                n_shards, bucket_cap, chunk):
    codes = slab_codes[0]  # [chunk + kmax - 1]
    pays = slab_pays[0]
    keys, valid = _extract_canonical_dyn(codes, k, kmax, nw)
    own = jnp.arange(codes.shape[0], dtype=jnp.int32) < chunk
    keep = valid & own
    sent = tuple(jnp.full_like(keys[0], SENTINEL) for _ in range(nw))
    keys = tuple(jnp.where(keep, w, s) for w, s in zip(keys, sent))
    pay = jnp.where(keep, pays, _PAD_PAY)

    ops = jax.lax.sort(list(keys) + [pay], num_keys=nw + 1, is_stable=False)
    sp, spay = tuple(ops[:nw]), ops[nw]
    n = sp[0].shape[0]

    # every element ships (query elements each vote; text duplicates are
    # harmless to the OR masks), so liveness is just non-pad — like the
    # exp4 buckets mode, a single massively repeated key can only be
    # handled by the overflow-retry cap growth
    live = ~words_is_sentinel(sp)
    rank, rpos, total = rank_positions(live)
    splits = _sampled_splits(sp, total, n_shards, pos=rpos, gid_bits=0)
    split_pos = searchsorted_words(sp, splits)  # lower bound: run-safe
    split_rank = jnp.where(
        split_pos > 0, jnp.take(rank, jnp.maximum(split_pos - 1, 0), mode="clip"), 0
    )
    bounds = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), split_rank, total[None]]
    )
    sizes = bounds[1:] - bounds[:-1]
    overflow = jnp.max(sizes) > bucket_cap

    j = jnp.arange(bucket_cap, dtype=jnp.int32)[None, :]
    tr = bounds[:-1, None] + j
    in_range = tr < bounds[1:, None]
    gpos = jnp.take(rpos, jnp.minimum(tr, n - 1), mode="clip")
    send = [
        jnp.where(in_range, jnp.take(w, gpos, mode="clip"), SENTINEL)
        for w in sp
    ] + [jnp.where(in_range, jnp.take(spay, gpos, mode="clip"), _PAD_PAY)]
    recv = [
        jax.lax.all_to_all(w, AXIS, split_axis=0, concat_axis=0, tiled=True)
        for w in send
    ]
    flat = [w.reshape(-1) for w in recv]
    ops2 = jax.lax.sort(flat, num_keys=nw + 1, is_stable=False)
    sm, mpay = tuple(ops2[:nw]), ops2[nw]

    from ..engine.ksweep import _seg_or_scan

    prev = tuple(jnp.roll(w, 1) for w in sm)
    key_new = (~words_eq(sm, prev)).at[0].set(True)
    is_pad = words_is_sentinel(sm)
    is_text = (~is_pad) & (mpay < jnp.uint32(D))
    onehot = jnp.where(is_text, jnp.uint32(1) << mpay, jnp.uint32(0))
    # text sorts before queries within each run, so the forward OR at a
    # query element already includes every text one-hot of its run
    fwd = _seg_or_scan(onehot, key_new)
    is_q = (~is_pad) & (mpay >= jnp.uint32(D))
    qmask = jnp.where(is_q, fwd, 0)
    nmatch = jax.lax.population_count(qmask)
    weight = jnp.where(is_q & (nmatch > 0), jnp.uint32(lcm) // jnp.maximum(nmatch, 1), 0)

    # scatter-free densify: sort by read id, per-dataset cumulative vote
    # sums, then [R] interval sums via two searchsorteds
    ridk = jnp.where(is_q, mpay - jnp.uint32(D), _PAD_PAY)
    rs, rmask, rw, rq = jax.lax.sort(
        [ridk, qmask, weight, is_q.astype(jnp.uint32)], num_keys=1, is_stable=False
    )
    r_ids = jnp.arange(n_reads, dtype=jnp.uint32)
    lo = jnp.searchsorted(rs, r_ids, side="left").astype(jnp.int32)
    hi = jnp.searchsorted(rs, r_ids, side="right").astype(jnp.int32)

    def interval_sum(vals):
        c = jnp.cumsum(vals)
        top = jnp.take(c, jnp.maximum(hi - 1, 0), mode="clip")
        bot = jnp.where(lo > 0, jnp.take(c, jnp.maximum(lo - 1, 0), mode="clip"), 0)
        return jnp.where(hi > lo, top - bot, 0)

    votes = jnp.stack(
        [
            interval_sum(jnp.where(((rmask >> d) & 1) == 1, rw, jnp.uint32(0)))
            for d in range(D)
        ],
        axis=1,
    )  # [R, D] uint32 (modular, matching the single-device uint32 sums)
    rnm = jax.lax.population_count(rmask)
    unmatched = interval_sum(((rq == 1) & (rnm == 0)).astype(jnp.int32))
    n_kmers = interval_sum(rq.astype(jnp.int32))

    votes = jax.lax.psum(votes, AXIS)
    unmatched = jax.lax.psum(unmatched, AXIS)
    n_kmers = jax.lax.psum(n_kmers, AXIS)
    overflow_any = jax.lax.pmax(overflow.astype(jnp.int32), AXIS)
    return votes, unmatched, n_kmers, overflow_any


@lru_cache(maxsize=64)
def _vote_fn(mesh, kmax, nw, D, lcm, n_reads, n_shards, bucket_cap, chunk):
    local = partial(
        _local_vote,
        kmax=kmax,
        nw=nw,
        D=D,
        lcm=lcm,
        n_reads=n_reads,
        n_shards=n_shards,
        bucket_cap=bucket_cap,
        chunk=chunk,
    )
    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS, None), P()),
            out_specs=(P(), P(), P(), P()),
        )
    )


def build_vote_world(group_codes: Sequence[np.ndarray], read_mats: Sequence[np.ndarray]):
    """Host-side packing of [group texts ++ every pivot's reads] with a
    single uint32 payload stream (gid / D + global read id) and separator
    isolation at every boundary.  Returns (codes, pays, read_spans) where
    read_spans[i] = (first_rid, n_reads_i) recovers pivot i's rows."""
    from ..engine.occurrence import pack_members

    tcodes, tgids = pack_members(group_codes)
    parts = [tcodes]
    pparts = [tgids.astype(np.uint32)]
    D = len(group_codes)
    spans = []
    rid0 = 0
    for mat in read_mats:
        r, l = mat.shape
        flat = np.concatenate(
            [mat, np.full((r, 1), 4, mat.dtype)], axis=1
        ).reshape(-1)
        rids = np.repeat(
            np.arange(rid0, rid0 + r, dtype=np.uint32), l + 1
        ) + np.uint32(D)
        parts.append(flat)
        pparts.append(rids)
        spans.append((rid0, r))
        rid0 += r
    codes = np.concatenate(parts)
    pays = np.concatenate(pparts)
    return codes, pays, spans


def sharded_read_votes_multi(
    mesh: Mesh,
    group_codes: Sequence[np.ndarray],
    read_mats: Sequence[np.ndarray],
    ks: Sequence[int],
    bucket_cap: int | None = None,
    slack: float = 1.7,
    upload=None,
    to_host=None,
) -> dict:
    """{k: [per-pivot (votes [R_i, D] int64, unmatched, n_kmers)]} — the
    sharded twin of classify/annotate.read_votes_bulk_multi over the whole
    k grid, one compile per key-word class.  upload/to_host hook the slab
    upload and the replicated-output readback so a process-spanning mesh
    (dist/multihost.py) reuses this driver verbatim."""
    import math as _math

    from ..classify.annotate import vote_lcm

    if upload is None:
        upload = jnp.asarray
    if to_host is None:
        to_host = jax.device_get
    D = len(group_codes)
    assert 1 <= D <= 32
    lcm = vote_lcm(D)
    n_shards = mesh.devices.size
    codes, pays, spans = build_vote_world(group_codes, read_mats)
    n = codes.shape[0]
    n_reads = sum(r for _, r in spans)

    by_width: dict = {}
    for k in ks:
        by_width.setdefault(key_words(k), []).append(k)

    out = {}
    for nw, cks in sorted(by_width.items()):
        kmax = max(cks)
        cap = bucket_cap or max(
            64, int(slack * _math.ceil(n / n_shards / max(n_shards, 1)))
        )
        while True:
            chunk = max(1, _math.ceil(n / n_shards))
            cs_slab, ps_slab = _make_slab_pair(codes, pays, n_shards, kmax)
            gc, gp = upload(cs_slab), upload(ps_slab)
            fn = _vote_fn(
                mesh, kmax, nw, D, lcm, n_reads, n_shards, cap, chunk
            )
            redo = []
            for k in cks:
                v, u, nk, ov = fn(gc, gp, jnp.uint32(k))
                if int(np.asarray(to_host(ov))) != 0:
                    redo = cks[cks.index(k):]
                    break
                vh = np.asarray(to_host(v)).astype(np.int64)
                uh = np.asarray(to_host(u)).astype(np.int64)
                nh = np.asarray(to_host(nk)).astype(np.int64)
                out[k] = [
                    (vh[r0 : r0 + r], uh[r0 : r0 + r], nh[r0 : r0 + r])
                    for r0, r in spans
                ]
            if not redo:
                break
            cks = redo
            cap = cap * 2  # contained retry: only the overflowed ks re-run
    return out
