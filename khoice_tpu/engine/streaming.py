"""Bounded-memory (streaming) k-sweep — the KMC `-m64` role on a device.

KMC's defining property is counting arbitrarily large inputs on a fixed
memory budget: the reference hands it 64 GB and streams whole genome
groups (`kmc -fm -m64`, workflow/rules/exp_type_1.smk:163), spilling
prefix-partitioned bins to disk.  The master sweep (engine/ksweep.py)
materializes the whole doubled text's sort on one device (~16-20 B per
text position at KW=4 plus sort workspace), which dies past ~1/40 of
device memory in positions.  This module runs the SAME sweep under a
device byte budget:

- the 2-bit-packed doubled text is tiny (1 B/position as uint8 codes)
  and stays RESIDENT on the device; only the 16 B/position sort
  structures are big, and those are built chunk by chunk;
- k-mer space is split into G top-word key ranges ALIGNED to
  2*kmin-bit prefixes (no k-run of any swept k tears across groups —
  the same invariant as dist/ksweep.py's shard splits; KMC's own 4^p
  disk bins are the CPU ancestor of this partition);
- per pass, for each text chunk: extract + sentinel-encode + sort the
  chunk, then searchsorted-slice each in-range group's elements into
  that group's fixed-cap device buffer (slices of a sorted chunk are
  contiguous, so the copy is a gather of one range per group);
- per group: one sort of the buffer + the multi-k occurrence scan
  in RAW (doubled, palindromic) form, accumulated across groups and
  halved at the end — a canonical class's two strand runs can land in
  different key ranges, exactly as in the sharded sweep;
- a group overflowing its cap (key-space skew beyond `slack`) restarts
  the class with doubled caps, logged — correct always, fast when the
  2-bit key space is near-uniform (it is for genomic text).

Peak device memory ~= resident codes + one chunk's sort + R group
buffers (+ the largest single group's sort), independent of input size;
host memory holds only the input codes.  Bit-identical to
occurrence_histograms_sweep (tested vs the oracle and the in-core path).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.logging import get_logger
from .ksweep import (
    MASK_MEMBERS_OCC,
    PACK_GID_BITS,
    PACK_NIO_BITS,
    _extract_fwd_sweep,
    _scan_multi_k,
    plan_sweep,
)

log = get_logger("khoice.streaming")

_SENT_LAST_PACKED = np.uint32(
    0xFFFFFFFF & ~((1 << (PACK_GID_BITS + PACK_NIO_BITS)) - 1)
)


def sentinel_encode_packed(fwd: tuple, KW: int, nio_bits: int, gid_bits: int):
    """Re-encode invalid packed elements (nio == 0: N positions, record
    separators, tail padding) to the dominant sentinel: all-ones key
    words, ZERO payload bits in the last word.

    The sentinel sorts strictly after EVERY real element: the last word's
    spare-above-payload bits (>= 2 of them, since packing requires
    spare >= PACK_MIN_SPARE = 14 > the 12 payload bits) are ones in the
    sentinel but zero in every real element.  The occurrence scans are
    unaffected (the sentinel's nio bits stay 0).  Returns
    (encoded, invalid_mask)."""
    pay_mask = jnp.uint32((1 << (nio_bits + gid_bits)) - 1)
    invalid = (fwd[-1] & jnp.uint32((1 << nio_bits) - 1)) == 0
    out = []
    for i, w in enumerate(fwd):
        sent = (jnp.uint32(0xFFFFFFFF) & ~pay_mask) if i == KW - 1 else jnp.uint32(0xFFFFFFFF)
        out.append(jnp.where(invalid, sent, w))
    return tuple(out), invalid


def default_device_budget_bytes() -> int:
    """The automatic device memory budget for sweep dispatch.

    KMC is handed a fixed budget and bounds itself (`kmc -m64`,
    reference workflow/rules/exp_type_1.smk:163); the chip equivalent is
    ~85% of the accelerator's reported bytes_limit (the rest covers the
    resident codes, XLA's allocator slack and the output buffers).
    Backends that report no limit (CPU tests) get KMC's own 64 GB."""
    try:
        stats = jax.devices()[0].memory_stats() or {}
        limit = int(stats.get("bytes_limit", 0))
        if limit > 0:
            return int(limit * 0.85)
    except Exception:
        pass
    return 64 << 30


def incore_sweep_bytes(
    total_positions: int, ks: Sequence[int], n_members: int
) -> int:
    """Estimated peak device bytes of the IN-CORE shared-sort sweep over a
    group whose packed text (members + separators) spans `total_positions`.

    The peak is the master-class sort: doubled text of n2 = 2*total
    elements x 4 bytes x `words` sorted operands, live twice (lax.sort
    input + output).  Used by run_exp1 to dispatch groups beyond the
    device budget to the streaming path automatically — the user never
    chooses, exactly as with KMC's -m64."""
    classes, _rem = plan_sweep(ks, n_members, MASK_MEMBERS_OCC)
    n2 = 2 * total_positions
    worst = 0
    for kmax, KW, _cks, packed in classes:
        words = KW if packed else KW + 1
        worst = max(worst, n2 * 4 * words * 2)
    return worst


def _group_splits(G: int, kmin: int) -> np.ndarray:
    """G+1 ascending top-word split values aligned to 2*kmin-bit prefixes
    (alignment caps the usable granularity at 4^kmin prefixes)."""
    bits = min(2 * kmin, 32)
    keep = np.uint64(0xFFFFFFFF) << np.uint64(32 - bits)
    raw = (np.arange(G + 1, dtype=np.uint64) << np.uint64(32)) // np.uint64(G)
    lo = np.minimum(raw, 0xFFFFFFFF).astype(np.uint64) & keep
    lo[-1] = 0xFFFFFFFF  # last group closes at the top (inclusive w0)
    return lo.astype(np.uint32)


# NOTE: bufs are deliberately NOT donated: donate_argnums on this call
# produced use-after-free segfaults on the CPU backend when the suite had
# accumulated many live executables (observed twice at different tests);
# the extra buffer copy per chunk is bandwidth-cheap next to the sort.
@partial(jax.jit, static_argnums=(5, 6, 7, 8, 9, 10))
def _chunk_step(d_codes, member_starts, bufs, n, c, C, H, kmax, KW, cap, R, lo, hi):
    """Extract + sort one owned chunk of the doubled text and append each
    of R groups' in-range elements to its buffer at the chunk's slot.

    d_codes: resident uint8 doubled codes [n2 + Cpad + H];
    member_starts: int32 member start offsets (for gid rebuild);
    bufs: (R, n_chunks*cap) per key word (NOT donated — see NOTE above);
    lo/hi: (R,) inclusive w0 ranges.  Returns (bufs, per-group in-range
    counts (R,))."""
    start = c * C
    slab = jax.lax.dynamic_slice(d_codes, (start,), (C + H,))
    pos = start + jnp.arange(C + H, dtype=jnp.int32)
    # n = true text length (the doubled region is [0, 2n); anything past
    # it is chunk-alignment padding, code 4 -> invalid -> dropped)
    orig = jnp.where(pos < n, pos, 2 * n - 1 - pos)
    orig = jnp.clip(orig, 0, n - 1)
    gids = (
        jnp.searchsorted(member_starts, orig, side="right").astype(jnp.uint32) - 1
    )
    fwd, _ = _extract_fwd_sweep(slab, gids, kmax, KW, packed=True)
    elems, invalid = sentinel_encode_packed(fwd, KW, PACK_NIO_BITS, PACK_GID_BITS)
    owned = jnp.arange(C + H, dtype=jnp.int32) < C
    drop = invalid | ~owned
    elems = tuple(
        jnp.where(
            drop,
            jnp.uint32(_SENT_LAST_PACKED) if i == KW - 1 else jnp.uint32(0xFFFFFFFF),
            w,
        )
        for i, w in enumerate(elems)
    )
    s = jax.lax.sort(list(elems), num_keys=KW, is_stable=False)

    counts = []
    new_bufs = []
    j = jnp.arange(cap, dtype=jnp.int32)
    for r in range(R):
        i0 = jnp.searchsorted(s[0], lo[r], side="left").astype(jnp.int32)
        i1 = jnp.searchsorted(s[0], hi[r], side="right").astype(jnp.int32)
        # sentinels share w0=0xFFFFFFFF with the last group's hi: exclude
        # them by their last word (payload bits zero, > any real element)
        nio = s[KW - 1] & jnp.uint32((1 << PACK_NIO_BITS) - 1)
        n_sent_like = jnp.sum(
            ((s[0] >= lo[r]) & (s[0] <= hi[r]) & (nio == 0)).astype(jnp.int32)
        )
        cnt = i1 - i0 - n_sent_like
        counts.append(cnt)
        take = jnp.minimum(j, jnp.maximum(cnt - 1, 0)) + i0
        in_r = j < cnt
        rows = []
        for i in range(KW):
            v = jnp.take(s[i], take, mode="clip")
            pad = (
                jnp.uint32(_SENT_LAST_PACKED)
                if i == KW - 1
                else jnp.uint32(0xFFFFFFFF)
            )
            rows.append(jnp.where(in_r, v, pad))
        nb = []
        for i in range(KW):
            nb.append(jax.lax.dynamic_update_slice(bufs[r * KW + i], rows[i], (c * cap,)))
        new_bufs.extend(nb)
    return tuple(new_bufs), jnp.stack(counts)


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _group_scan(bufs_kw, ks, kmax, KW, n_members, cs):
    """Sort one group buffer and return its RAW (2, n_ks, n_members)."""
    s = tuple(jax.lax.sort(list(bufs_kw), num_keys=KW, is_stable=False))
    return _scan_multi_k(
        s, None, ks, kmax, KW, n_members, cs, packed=True, raw=True
    )


def _doubled_codes(member_codes: Sequence[np.ndarray], C: int, H: int):
    """Host-side doubled text (codes ++ revcomp) padded to a multiple of
    the chunk size, plus member start offsets for gid rebuild."""
    parts, starts = [], [0]
    for codes in member_codes:
        parts.append(np.asarray(codes, np.uint8))
        parts.append(np.full(1, 4, np.uint8))
        starts.append(starts[-1] + parts[-2].shape[0] + 1)
    codes = np.concatenate(parts)
    n = codes.shape[0]
    rc = np.where(codes < 4, codes ^ 3, codes)[::-1]
    n2 = 2 * n
    n_chunks = math.ceil(n2 / C)
    pad = n_chunks * C - n2 + H
    d = np.concatenate([codes, rc, np.full(pad, 4, np.uint8)])
    return d, np.asarray(starts[:-1], np.int32), n, n_chunks


def occurrence_histograms_sweep_streaming(
    member_codes: Sequence[np.ndarray],
    ks: Sequence[int],
    cs: int = 5000,
    cx: int = 10000,
    device_budget_bytes: int = 8 << 30,
    chunk_elems: int | None = None,
    n_groups: int | None = None,
    pass_groups: int | None = None,
    slack: float = 1.7,
) -> Dict[int, List[int]]:
    """{k: exp1 occurrence histogram} under a device memory budget.

    Bit-identical to occurrence_histograms_sweep; use when the group is
    too large for the in-core doubled-text sort.  Only packed master
    classes stream (the practical case: any grid with >= 3 ks packs);
    leftover ks fall back to the per-k fused path, which is small per k.
    """
    from .occurrence import occurrence_histogram_packed, pack_members

    n_members = len(member_codes)
    assert n_members <= (1 << PACK_GID_BITS), (
        f"packed gid field is {PACK_GID_BITS} bits"
    )
    classes, remaining = plan_sweep(ks, n_members, MASK_MEMBERS_OCC)
    out: Dict[int, List[int]] = {}

    for kmax, KW, cks, packed in classes:
        if not packed:
            remaining = sorted(set(remaining) | set(cks))
            continue
        H = kmax - 1
        E = KW * 4
        total = 2 * sum(int(np.asarray(m).shape[0]) + 1 for m in member_codes)
        C = max(1, chunk_elems or min(total, (device_budget_bytes // 8) // E))
        G = n_groups or max(1, math.ceil((total * E * 4) / device_budget_bytes))
        R = pass_groups or max(1, min(G, max(1, device_budget_bytes // (4 * E * max(1, int(slack * total / G))))))
        kmin = min(cks)
        if G > 1 << min(2 * kmin, 32):
            G = 1 << min(2 * kmin, 32)
        splits = _group_splits(G, kmin)

        d, starts, n, n_chunks = _doubled_codes(member_codes, C, H)
        cap = max(1, int(slack * C / G))

        log.info(
            "streaming class kmax=%d: %d chunks x %dM elems, %d groups "
            "(cap %d, %d per pass), resident codes %.1f MB",
            kmax, n_chunks, C // 1_000_000 or 1, G, cap, R, d.nbytes / 1e6,
        )

        dj = jax.device_put(d)
        sj = jax.device_put(jnp.asarray(starts))

        # Overflow recovery is CONTAINED: a key-range group whose buffer
        # cap overflows (key-space skew, e.g. long poly-A) is re-queued
        # alone with a doubled cap; groups that finished keep their
        # accumulated raw scans and are never re-extracted or re-sorted.
        dp = np.zeros((2, len(cks), n_members), np.int64)
        todo = list(range(G))
        round_cap = cap
        while todo:
            overflowed: List[int] = []
            for i0 in range(0, len(todo), R):
                batch = todo[i0 : i0 + R]
                r_here = len(batch)
                lo = jnp.asarray(splits[np.asarray(batch)])
                hi_np = np.array(
                    [
                        0xFFFFFFFF if g == G - 1 else int(splits[g + 1]) - 1
                        for g in batch
                    ],
                    np.int64,
                )
                hi = jnp.asarray(hi_np.astype(np.uint32))
                bufs = tuple(
                    jnp.full(
                        (n_chunks * round_cap,),
                        _SENT_LAST_PACKED if (i % KW) == KW - 1 else np.uint32(0xFFFFFFFF),
                        jnp.uint32,
                    )
                    for i in range(r_here * KW)
                )
                over = np.zeros(r_here, bool)
                for c in range(n_chunks):
                    bufs, counts = _chunk_step(
                        dj, sj, bufs, jnp.int32(n), jnp.int32(c), C, H, kmax,
                        KW, round_cap, r_here, lo, hi,
                    )
                    over |= np.asarray(counts) > round_cap
                    if over.all():
                        break  # every group in the batch must retry anyway
                for r in range(r_here):
                    if over[r]:
                        continue
                    raw = _group_scan(
                        tuple(bufs[r * KW : (r + 1) * KW]),
                        cks, kmax, KW, n_members, cs,
                    )
                    dp += np.asarray(raw)
                overflowed.extend(batch[r] for r in range(r_here) if over[r])
            todo = overflowed
            if todo:
                round_cap *= 2
                log.warning(
                    "streaming class kmax=%d: %d/%d key-range groups "
                    "overflowed their cap (skewed key space at kmin=%d "
                    "granularity); retrying ONLY those with cap %d",
                    kmax, len(todo), G, kmin, round_cap,
                )

        m = min(n_members, cx)
        for i, k in enumerate(cks):
            h = [0] * cx
            h[:m] = ((dp[0, i, :m] + dp[1, i, :m]) // 2).tolist()
            out[k] = h

    if remaining:
        # Leftover ks (classes with <3 ks never pack; empty for any real
        # grid) ride the per-k fused path.  That path materializes the
        # full undoubled element array on device (~4*KW B/position), so
        # it is NOT bounded by device_budget_bytes — acceptable because
        # the undoubled single-k footprint is ~half the in-core sweep's
        # and leftovers are rare; pack/upload once for all leftover ks.
        codes, gids = pack_members(member_codes)
        packed_arrs = (jax.device_put(codes), jax.device_put(gids))
        for k in remaining:
            out[k] = occurrence_histogram_packed(
                packed_arrs, n_members, k, cs=cs, cx=cx
            )
    return out
