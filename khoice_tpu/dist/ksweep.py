"""Sharded shared-sort k-sweep: the headline exp1 path SPMD over the mesh.

Distributes engine/ksweep.py (every k's occurrence histogram from one
doubled-text sort) across the "kv" mesh axis:

- genome slabs stream data-parallel with a kmax-1 halo; each shard builds
  its LOCAL doubled text (slab ++ revcomp(slab)) and extracts forward
  kmax-mer elements for its own windows on both strands (the rc window of
  an owned forward window is computable from the same slab, so no shard
  needs another's data);
- elements are (key, gid, nio)-deduped locally, then ONE all_to_all
  exchanges them keyed by data-sampled split points that are ALIGNED DOWN
  to 2*kmin-bit prefix boundaries — a k-run (k >= kmin) is a set of keys
  sharing their top 2k bits, so prefix-aligned ranges guarantee every
  k-run of every k in the class lands wholly in one shard;
- each shard sorts its range and runs the multi-k occurrence scan,
  returning the RAW (doubled, palindromic) histogram pair; the psum runs
  BEFORE the canonical (d+p)//2 combine, because a class's two strand
  runs (x and revcomp(x)) generally land in different shards.

Replaces the reference's k-grid x group Snakemake fan-out
(workflow/Snakefile:36, workflow/rules/exp_type_1.smk:156-191) with one
SPMD program per key-word class. Bit-identical to the single-device sweep
(tested on the 8-virtual-device CPU mesh across word classes).
"""

from __future__ import annotations

import math
from functools import lru_cache, partial
from typing import Dict, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..engine.bits import SENTINEL, searchsorted_words, words_eq
from .sharded import rank_positions
from ..engine.ksweep import (
    MASK_MEMBERS_OCC,
    PACK_GID_BITS,
    PACK_NIO_BITS,
    _extract_fwd_sweep,
    _scan_multi_k,
    plan_sweep,
)
from .mesh import AXIS
from .occurrence import _make_slab_pair, _sampled_splits

# pad/dropped-element encoding: all-ones key words, but in packed mode the
# last word's payload bits are ZERO (nio=0) so pads can never pass any
# nio >= k validity test; in unpacked mode the payload operand is 0.
_PACK_PAY_MASK = (1 << (PACK_GID_BITS + PACK_NIO_BITS)) - 1
_PACK_PAD_LAST = np.uint32(0xFFFFFFFF & ~_PACK_PAY_MASK)


def _align_splits_to_prefix(splits, kmin: int, KW: int):
    """Zero every bit below the top 2*kmin — splits then sit on kmin-prefix
    boundaries, so no k-run (k >= kmin) is ever torn across shards."""
    cut = KW * 32 - 2 * kmin  # number of low bits to clear
    out = []
    for i in range(KW):
        lo_bit = (KW - 1 - i) * 32
        if lo_bit >= cut:
            out.append(splits[i])
        elif lo_bit + 32 <= cut:
            out.append(jnp.zeros_like(splits[i]))
        else:
            s = cut - lo_bit
            out.append((splits[i] >> s) << s)
    return tuple(out)


def _local_sweep(
    slab_codes,
    slab_gids,
    *,
    ks,
    kmax,
    KW,
    n_members,
    cs,
    n_shards,
    bucket_cap,
    chunk,
    packed,
    mode="occ",
    mode_params=None,
):
    codes = slab_codes[0]  # [L] = chunk + kmax - 1
    gids = slab_gids[0]
    L = codes.shape[0]
    kmin = min(ks)

    # local doubled text: forward slab ++ revcomp(slab). Owned windows are
    # starts [0, chunk) in each half (the rc window of owned forward window
    # p sits at rc-start chunk-1-p, also in [0, chunk)).
    rc = jnp.where(codes < 4, codes ^ 3, codes)[::-1]
    codes2 = jnp.concatenate([codes, rc])
    gids2 = jnp.concatenate([gids, gids[::-1]])
    fwd, payload = _extract_fwd_sweep(codes2, gids2, kmax, KW, packed=packed)

    pos = jnp.arange(2 * L, dtype=jnp.int32)
    # rc windows whose kmax-window would start BEFORE the global text (the
    # first kmax-k rc k-mers for each k) belong to no shard's [0, chunk)
    # range — shard 0 owns its entire rc half to cover them (the overhang
    # A-pads via the extraction's cp padding, like the single-device path)
    didx = jax.lax.axis_index(AXIS)
    own = (pos < chunk) | ((pos >= L) & ((pos < L + chunk) | (didx == 0)))
    if packed:
        nio = fwd[-1] & jnp.uint32((1 << PACK_NIO_BITS) - 1)
        elems = fwd
    else:
        nio = payload & jnp.uint32(0xFF)
        elems = fwd + (payload,)
    n_ops = len(elems)
    keep = own & (nio >= kmin)  # useless for every k in the class otherwise

    pad_last = jnp.uint32(_PACK_PAD_LAST) if packed else SENTINEL
    pad_vals = [SENTINEL] * (KW - 1) + [pad_last] + ([jnp.uint32(0)] if not packed else [])
    elems = tuple(
        jnp.where(keep, w, pv) for w, pv in zip(elems, pad_vals)
    )

    sp = tuple(jax.lax.sort(list(elems), num_keys=n_ops, is_stable=False))

    # (key, gid, nio)-dedupe + rank space: bucket boundaries live in
    # deduped-element rank, so repeated keys can't overflow a bucket.
    # The presence-mask scans (occ / pivot_rest / multi_pivot /
    # containment) are duplicate-insensitive (OR of one-hot gids); exp4's
    # "buckets" mode SUMS pivot multiplicities per run, so it must keep
    # every duplicate and forgo the exchange-volume reduction.
    prev = tuple(jnp.roll(w, 1) for w in sp)
    is_pad = words_eq(sp[:KW], tuple(jnp.full_like(sp[0], v) for v in pad_vals[:KW]))
    if not packed:
        is_pad = is_pad & (sp[KW] == 0)
    if mode == "buckets":
        live = ~is_pad
    else:
        live = (~words_eq(sp, prev)).at[0].set(True) & ~is_pad
    n2 = sp[0].shape[0]
    rank, rpos, total = rank_positions(live)

    # data-sampled splits on the KEY words, aligned to kmin prefixes
    splits = _sampled_splits(sp[:KW], total, n_shards, pos=rpos, gid_bits=0)
    splits = _align_splits_to_prefix(splits, kmin, KW)

    split_pos = searchsorted_words(sp[:KW], splits)
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
    gpos = jnp.take(rpos, jnp.minimum(tr, n2 - 1), mode="clip")
    send = tuple(
        jnp.where(in_range, jnp.take(w, gpos, mode="clip"), pv)
        for w, pv in zip(sp, pad_vals)
    )
    recv = tuple(
        jax.lax.all_to_all(w, AXIS, split_axis=0, concat_axis=0, tiled=True)
        for w in send
    )
    flat = tuple(w.reshape(-1) for w in recv)
    sm = tuple(jax.lax.sort(list(flat), num_keys=n_ops, is_stable=False))

    if mode == "occ":
        dp = _scan_multi_k(
            sm[:KW],
            None if packed else sm[KW],
            ks,
            kmax,
            KW,
            n_members,
            cs,
            packed=packed,
            raw=True,
        )  # (2, n_ks, n_members) — halving happens after the psum
    else:
        # classification scans (exp2/3/4) over the same sharded sort:
        # splits are kmin-prefix aligned, so every per-run quantity
        # (presence masks, saturated pivot sums, pal halving) is exact
        # per shard and the (2, n_ks, bins) raw stats just psum
        from ..engine.ksweep_classify import classify_scan_raw

        dp = classify_scan_raw(
            sm[:KW], None if packed else sm[KW], ks, kmax, KW, cs,
            packed, mode, mode_params,
        )
    dp = jax.lax.psum(dp, AXIS)
    overflow_any = jax.lax.pmax(overflow.astype(jnp.int32), AXIS)
    return dp, overflow_any


@lru_cache(maxsize=64)
def _sweep_fn(mesh, ks, kmax, KW, n_members, n_shards, cs, bucket_cap, chunk,
              packed, mode="occ", mode_params=None):
    local = partial(
        _local_sweep,
        ks=ks,
        kmax=kmax,
        KW=KW,
        n_members=n_members,
        cs=cs,
        n_shards=n_shards,
        bucket_cap=bucket_cap,
        chunk=chunk,
        packed=packed,
        mode=mode,
        mode_params=mode_params,
    )
    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS, None)),
            out_specs=(P(), P()),
        )
    )


def run_sweep_plan_raw(
    mesh: Mesh,
    member_codes: Sequence[np.ndarray],
    ks: Sequence[int],
    cs: int,
    bucket_cap: int | None,
    slack: float,
    upload,
    to_host,
    mode: str = "occ",
    mode_params=None,
    mask_limit: int | None = None,
):
    """Core SPMD sweep driver: plan classes, slab, retry on overflow,
    psum raw (doubled, palindromic) stats and combine (d+p)//2 per k.

    mode selects the per-shard scan: "occ" (exp1 occurrence histograms)
    or a classification mode ("pivot_rest"/"multi_pivot"/"containment"/
    "buckets", engine/ksweep_classify.classify_scan_raw).  `upload` turns
    a host slab matrix into a mesh-sharded array (single-host:
    jnp.asarray; multihost: per-process assembly); `to_host` reads a
    replicated output.  Returns ({k: canonical stats np.ndarray},
    leftover ks for the caller's per-k fallback)."""
    from ..engine.occurrence import pack_members
    from ..engine.ksweep import MASK_MEMBERS_CLASSIFY

    d = mesh.devices.size
    codes, gids = pack_members(member_codes)
    n = codes.shape[0]
    n_members = len(member_codes)
    if mask_limit is None:
        mask_limit = MASK_MEMBERS_OCC if mode == "occ" else MASK_MEMBERS_CLASSIFY
    classes, remaining = plan_sweep(ks, n_members, mask_limit)
    out: Dict[int, np.ndarray] = {}
    for kmax, KW, cks, packed in classes:
        chunk = max(1, math.ceil(n / d))
        slab_codes, slab_gids = _make_slab_pair(codes, gids, d, kmax)
        gc, gg = upload(slab_codes), upload(slab_gids)
        cap = bucket_cap
        if cap is None:
            # each shard contributes ~2*chunk owned elements over d buckets
            cap = max(64, int(slack * math.ceil(2 * chunk / max(d, 1))))
        balanced_cap = cap
        while True:
            fn = _sweep_fn(
                mesh, cks, kmax, KW, n_members, d, cs, cap, chunk, packed,
                mode, mode_params,
            )
            dp, overflow = fn(gc, gg)
            if int(np.asarray(to_host(overflow))) == 0:
                break
            cap *= 2
        if cap > balanced_cap:
            # splits are aligned down to 2*kmin-bit prefixes, so heavily
            # skewed data at small kmin can degrade toward one shard
            # holding most elements — surface it instead of silently
            # paying the memory/work (ADVICE r3)
            from ..utils.logging import get_logger

            get_logger("khoice.dist.ksweep").warning(
                "sweep class kmax=%d: bucket_cap doubled %d -> %d past the "
                "balanced estimate (skewed key distribution at kmin=%d "
                "prefix granularity); shard balance is degraded",
                kmax, balanced_cap, cap, min(cks),
            )
        dp = np.asarray(to_host(dp))
        for i, k in enumerate(cks):
            out[k] = (dp[0, i] + dp[1, i]) // 2
    return out, remaining


def run_sweep_plan(
    mesh: Mesh,
    member_codes: Sequence[np.ndarray],
    ks: Sequence[int],
    cs: int,
    cx: int,
    bucket_cap: int | None,
    slack: float,
    upload,
    to_host,
    per_k_fallback,
) -> Dict[int, List[int]]:
    """exp1 wrapper over run_sweep_plan_raw: canonical stats become
    occurrence histogram lists padded to cx; leftover ks go to
    `per_k_fallback`."""
    n_members = len(member_codes)
    stats, remaining = run_sweep_plan_raw(
        mesh, member_codes, ks, cs, bucket_cap, slack, upload, to_host,
        mode="occ", mask_limit=MASK_MEMBERS_OCC,
    )
    out: Dict[int, List[int]] = {}
    m = min(n_members, cx)
    for k, cnt in stats.items():
        h = [0] * cx
        h[:m] = cnt[:m].tolist()
        out[k] = h
    for k in remaining:
        out[k] = per_k_fallback(k)
    return out


def sharded_occurrence_histograms_sweep(
    mesh: Mesh,
    member_codes: Sequence[np.ndarray],
    ks: Sequence[int],
    cs: int = 5000,
    cx: int = 10000,
    bucket_cap: int | None = None,
    slack: float = 1.7,
) -> Dict[int, List[int]]:
    """Multi-device {k: occurrence histogram} over the whole k grid —
    bit-identical to engine.ksweep.occurrence_histograms_sweep.

    Runs plan_sweep's classes as SPMD programs; leftover ks (tiny grids,
    >32 members) fall back to the per-k sharded fused path."""
    from .occurrence import sharded_occurrence_histogram

    return run_sweep_plan(
        mesh, member_codes, ks, cs, cx, bucket_cap, slack,
        upload=jnp.asarray,
        to_host=lambda x: x,
        per_k_fallback=lambda k: sharded_occurrence_histogram(
            mesh, member_codes, k, cs=cs, cx=cx
        ),
    )
