"""Device-side k-mer match annotation — the merge_lists.py core on the device.

The reference tags every pivot k-mer with the list of datasets whose group
union contains it, by streaming KMC text dumps through Python dicts
(reference: src/merge_lists.py:14-33). Here the same structure is built in
one variadic device sort: pivot table + all D group sets are concatenated
and sorted once; per-run segment sums give the pivot's count and a packed
presence bitmask over datasets, aligned on the same key array.

All classification weights are exact integers: a k-mer matched by |M|
datasets contributes count * LCM/|M| (LCM over 1..D), so vote argmaxes and
confusion-matrix cells are bit-reproducible on any backend — no float
accumulation-order sensitivity (the reference sums 1/|M| floats in dict
order, which is not reproducible across dict implementations).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..engine.bits import (
    searchsorted_words,
    take_words,
    words_eq,
    words_is_sentinel,
)
from ..engine.extract import extract_canonical
from ..engine.ops import _run_starts, _run_sums, _sort_keys_counts
from ..engine.table import KmerTable


@dataclasses.dataclass
class Annotation:
    """Merged, sorted run structure over pivot + group keys.

    keys: tuple of uint32 word arrays [C] (sorted, duplicates in runs)
    pivot_count: uint32 [C] — pivot's count at each run's first slot
    mask: uint32 [C] — bit d set iff dataset d's group contains the key
    num_datasets: int
    k: int
    """

    keys: tuple
    pivot_count: jnp.ndarray
    mask: jnp.ndarray
    num_datasets: int
    k: int


def vote_lcm(num_datasets: int) -> int:
    return math.lcm(*range(1, num_datasets + 1))


@partial(jax.jit, static_argnums=(2,))
def _annotate(pivot_parts, group_parts, num_datasets):
    (pkeys, pcounts) = pivot_parts
    w = len(pkeys)
    all_keys = tuple(
        jnp.concatenate([pkeys[i]] + [g[0][i] for g in group_parts])
        for i in range(w)
    )
    caps = [pcounts.shape[0]] + [g[1].shape[0] for g in group_parts]
    total = sum(caps)

    def placed(vec, slot):
        pre = sum(caps[:slot])
        post = total - pre - caps[slot]
        return jnp.concatenate(
            [jnp.zeros(pre, jnp.uint32), vec, jnp.zeros(post, jnp.uint32)]
        )

    payloads = [placed(pcounts, 0)] + [
        placed(g[1], d + 1) for d, g in enumerate(group_parts)
    ]
    skeys, spayloads = _sort_keys_counts(all_keys, *payloads)
    is_new = _run_starts(skeys)
    sent = words_is_sentinel(skeys)
    pivot_count = jnp.where(sent, 0, _run_sums(spayloads[0], is_new))
    mask = jnp.zeros(total, jnp.uint32)
    for d in range(num_datasets):
        gd = _run_sums(spayloads[d + 1], is_new)
        mask = mask | jnp.where(gd > 0, jnp.uint32(1 << d), 0)
    mask = jnp.where(sent, 0, mask)
    return skeys, pivot_count, mask


def build_annotation(pivot: KmerTable, groups: List[KmerTable]) -> Annotation:
    """pivot: raw-count table; groups: per-dataset set tables (counts=1)."""
    d = len(groups)
    assert d >= 1
    keys, pivot_count, mask = _annotate(
        (pivot.keys, pivot.counts),
        tuple((g.keys, g.counts) for g in groups),
        d,
    )
    return Annotation(keys, pivot_count, mask, d, pivot.k)


@partial(jax.jit, static_argnums=(1,))
def _group_mask_annotate(codes_gids, k):
    """ONE canonical sort of all group texts -> (keys, dataset mask).

    codes/gids are pack_members output with one member per dataset; the
    mask (bit d = dataset d contains the key) is a reverse segmented OR
    of one-hot gids, valid at each run's FIRST slot — where
    searchsorted-based lookups land (read_votes)."""
    from ..engine.occurrence import (
        GID_BITS,
        occ_words_static,
        pack_gid_static,
        unpack_keys_static,
    )
    from ..engine.extract import extract_canonical

    codes, gids = codes_gids
    keys, valid = extract_canonical(codes, k)
    packed = pack_gid_static(keys, valid, gids, k)
    ow = occ_words_static(k)
    sp = tuple(jax.lax.sort(list(packed), num_keys=ow, is_stable=False))
    prev = tuple(jnp.roll(w, 1) for w in sp)
    key_eq = (sp[-1] >> GID_BITS) == (prev[-1] >> GID_BITS)
    for i in range(ow - 1):
        key_eq = key_eq & (sp[i] == prev[i])
    key_new = (~key_eq).at[0].set(True)
    gid = sp[-1] & jnp.uint32((1 << GID_BITS) - 1)
    onehot = jnp.uint32(1) << gid
    run_end = jnp.roll(key_new, -1).at[-1].set(True)

    from ..engine.ksweep import _seg_or_scan

    mask = _seg_or_scan(onehot[::-1], run_end[::-1])[::-1]
    mask = jnp.where(words_is_sentinel(sp), 0, mask)
    return unpack_keys_static(sp, k), mask


def build_group_mask_annotation(group_codes: List[np.ndarray], k: int) -> Annotation:
    """Annotation over ALL datasets' texts in ONE sort — the exp6 fast path.

    Replaces per-dataset group tables + the merge sort of build_annotation
    for read-level voting, which ignores pivot_count: lookups of read
    k-mers against this global table yield exactly the same dataset masks
    (a k-mer in no group has mask 0 = unmatched, whether or not the key
    exists in the table — src/merge_lists.py:151-183 semantics)."""
    d = len(group_codes)
    assert 1 <= d <= 32, "dataset mask is a uint32 bitmask"
    from ..engine.occurrence import pack_members

    codes, gids = pack_members(group_codes)
    keys, mask = _group_mask_annotate((jnp.asarray(codes), jnp.asarray(gids)), k)
    return Annotation(keys, jnp.zeros_like(mask), mask, d, k)


@partial(jax.jit, static_argnums=(3,))
def _feature_buckets(pivot_count, mask, _sentinel, num_datasets):
    """bucket[d, m-1] = total pivot count of keys in dataset d with |M| = m;
    unique = total pivot count of keys matching no dataset."""
    nmatch = jax.lax.population_count(mask)
    present = pivot_count > 0
    unique = jnp.sum(jnp.where(present & (nmatch == 0), pivot_count, 0))
    buckets = []
    for d in range(num_datasets):
        in_d = (mask >> d) & 1
        row = []
        for m in range(1, num_datasets + 1):
            sel = present & (in_d == 1) & (nmatch == m)
            row.append(jnp.sum(jnp.where(sel, pivot_count, 0)))
        buckets.append(jnp.stack(row))
    return jnp.stack(buckets), unique


def feature_buckets(ann: Annotation):
    """Returns (buckets [D, D] int, unique_count int) on host."""
    b, u = _feature_buckets(ann.pivot_count, ann.mask, 0, ann.num_datasets)
    return np.asarray(b).astype(np.int64), int(np.asarray(u))


@partial(jax.jit, static_argnums=(3, 4, 5))
def _read_votes(ann_parts, reads, _s, k, num_datasets, lcm):
    keys, pivot_count, mask = ann_parts
    r, l = reads.shape
    flat = jnp.concatenate(
        [reads, jnp.full((r, 1), 4, reads.dtype)], axis=1
    ).reshape(-1)
    qkeys, valid = extract_canonical(flat, k)
    idx = searchsorted_words(keys, qkeys)
    found_keys = take_words(keys, idx)
    from ..engine.bits import words_eq

    found = words_eq(found_keys, qkeys) & valid
    qmask = jnp.where(found, jnp.take(mask, idx, mode="clip"), 0)
    nmatch = jax.lax.population_count(qmask)
    weight = jnp.where(nmatch > 0, lcm // jnp.maximum(nmatch, 1), 0)
    votes = []
    for d in range(num_datasets):
        in_d = ((qmask >> d) & 1) == 1
        wd = jnp.where(in_d, weight, 0).reshape(r, l + 1)
        votes.append(jnp.sum(wd, axis=1))
    unmatched = jnp.sum(
        jnp.where(valid & (nmatch == 0), 1, 0).reshape(r, l + 1), axis=1
    )
    n_kmers = jnp.sum(valid.reshape(r, l + 1), axis=1)
    return jnp.stack(votes, axis=1), unmatched, n_kmers


@partial(jax.jit, static_argnums=(2, 3, 4))
def _read_votes_merge(group_cg, reads_flat, k, num_datasets, lcm):
    """Merge-join read voting: ONE sort per k instead of per-query
    binary search.

    A searchsorted lookup costs ~27 dependent gather rounds per query
    word at the reference scale (100M read k-mers vs a 136M-element
    group table).  Here the group text's (canonical key, one-hot gid) elements and ALL
    reads' canonical k-mer keys ride ONE unstable sort; per-run dataset
    masks come from forward+backward segmented OR scans (run total =
    fwd | bwd, so element order within ties is irrelevant); each query
    element carries its flat read position as payload and a second small
    sort by that payload returns the masks in read order — no gathers
    anywhere.  Bit-identical votes to _read_votes (tested).

    group_cg: pack_members output over per-dataset group texts;
    reads_flat: uint8 codes of all reads flattened with separators.
    Returns (qmask uint32 [len(reads_flat)], valid bool)."""
    from ..engine.ksweep import _seg_or_scan

    gcodes, ggids = group_cg
    tkeys, tvalid = extract_canonical(gcodes, k)
    qkeys, qvalid = extract_canonical(reads_flat, k)
    # payloads: text -> gid (< D); query -> D + flat position
    nq = reads_flat.shape[0]
    # invalid text windows carry sentinel keys (their payload-0 bit can
    # only reach the sentinel run, which valid queries never occupy)
    tpay = jnp.where(tvalid, ggids, jnp.uint32(0))
    qpay = jnp.uint32(num_datasets) + jnp.arange(nq, dtype=jnp.uint32)
    w = len(tkeys)
    keys = tuple(
        jnp.concatenate([tw, qw]) for tw, qw in zip(tkeys, qkeys)
    )
    # invalid TEXT windows must not pollute runs: force their keys to the
    # sentinel (invalid queries keep sentinel keys from extract already?
    # extract_canonical sentinels invalid windows for both)
    pay = jnp.concatenate([tpay, qpay])
    ops = jax.lax.sort(list(keys) + [pay], num_keys=w, is_stable=False)
    skeys, spay = tuple(ops[:w]), ops[w]
    prev = tuple(jnp.roll(x, 1) for x in skeys)
    key_new = (~words_eq(skeys, prev)).at[0].set(True)
    is_text = spay < jnp.uint32(num_datasets)
    m = jnp.where(is_text, jnp.uint32(1) << spay, jnp.uint32(0))
    fwd = _seg_or_scan(m, key_new)
    run_end = jnp.roll(key_new, -1).at[-1].set(True)
    bwd = _seg_or_scan(m[::-1], run_end[::-1])[::-1]
    total = fwd | bwd
    total = jnp.where(words_is_sentinel(skeys), 0, total)
    # return query masks in flat read order: sort (payload, mask); text
    # entries (payload < D) land in the first n_text slots, queries
    # follow in flat order
    fq, fmask = jax.lax.sort(
        [spay, total], num_keys=1, is_stable=False
    )
    qmask = fmask[tkeys[0].shape[0] :]
    return qmask, qvalid


@partial(jax.jit, static_argnums=(3, 4, 5))
def _read_votes_merge_dyn(group_cg, reads_flat, k, kmax, n_words, num_datasets):
    """_read_votes_merge with k as a TRACED scalar (kmax/n_words static).

    One XLA compile serves every k of the same key-word width — the
    reference's 30-point grid (workflow/Snakefile:36) otherwise costs one
    multi-hundred-M-element sort compile per k. Extraction uses the
    incremental predicated pushes of _extract_canonical_dyn; everything
    downstream (the merge sort, the segmented OR scans, the payload sort)
    is already shape-static. Bit-identical masks to the static path for
    any k <= kmax of the same width (tested)."""
    from ..engine.ksweep import _seg_or_scan
    from ..engine.occurrence import _extract_canonical_dyn

    gcodes, ggids = group_cg
    tkeys, tvalid = _extract_canonical_dyn(gcodes, k, kmax, n_words)
    qkeys, qvalid = _extract_canonical_dyn(reads_flat, k, kmax, n_words)
    nq = reads_flat.shape[0]
    tpay = jnp.where(tvalid, ggids, jnp.uint32(0))
    qpay = jnp.uint32(num_datasets) + jnp.arange(nq, dtype=jnp.uint32)
    w = n_words
    keys = tuple(jnp.concatenate([tw, qw]) for tw, qw in zip(tkeys, qkeys))
    pay = jnp.concatenate([tpay, qpay])
    ops = jax.lax.sort(list(keys) + [pay], num_keys=w, is_stable=False)
    skeys, spay = tuple(ops[:w]), ops[w]
    prev = tuple(jnp.roll(x, 1) for x in skeys)
    key_new = (~words_eq(skeys, prev)).at[0].set(True)
    is_text = spay < jnp.uint32(num_datasets)
    m = jnp.where(is_text, jnp.uint32(1) << spay, jnp.uint32(0))
    fwd = _seg_or_scan(m, key_new)
    run_end = jnp.roll(key_new, -1).at[-1].set(True)
    bwd = _seg_or_scan(m[::-1], run_end[::-1])[::-1]
    total = fwd | bwd
    total = jnp.where(words_is_sentinel(skeys), 0, total)
    fq, fmask = jax.lax.sort([spay, total], num_keys=1, is_stable=False)
    qmask = fmask[tkeys[0].shape[0] :]
    return qmask, qvalid


@partial(jax.jit, static_argnums=(3, 4, 5, 6, 7))
def _merge_votes_dyn(group_cg, reads_flat, k, kmax, n_words, num_datasets,
                     spans, lcm):
    """ONE dispatch per k: merge-join masks + every pivot's per-read
    (votes, unmatched, n_kmers) in a single jitted program.

    The unfused path pays ~9 dispatches and host round trips per k
    (merge + per-pivot slices + per-pivot vote kernels); this fuses them
    into one call returning stacked [R_total] rows.  spans: static
    ((offset, r, l), ...) per pivot over the flat query stream."""
    qmask, qvalid = _read_votes_merge_dyn(
        group_cg, reads_flat, k, kmax, n_words, num_datasets
    )
    qmask = jnp.where(qvalid, qmask, 0)
    nmatch = jax.lax.population_count(qmask)
    weight = jnp.where(nmatch > 0, jnp.uint32(lcm) // jnp.maximum(nmatch, 1), 0)
    votes, unmatched, n_kmers = [], [], []
    for off, r, l in spans:
        n = r * (l + 1)
        wm = qmask[off : off + n]
        ww = weight[off : off + n].reshape(r, l + 1)
        votes.append(
            jnp.stack(
                [
                    jnp.sum(jnp.where(((wm >> d) & 1).reshape(r, l + 1) == 1, ww, 0), axis=1)
                    for d in range(num_datasets)
                ],
                axis=1,
            )
        )
        vv = qvalid[off : off + n].reshape(r, l + 1)
        nm = nmatch[off : off + n].reshape(r, l + 1)
        unmatched.append(jnp.sum(jnp.where(vv & (nm == 0), 1, 0), axis=1))
        n_kmers.append(jnp.sum(vv, axis=1))
    return (
        jnp.concatenate(votes),
        jnp.concatenate(unmatched),
        jnp.concatenate(n_kmers),
    )


def concat_flat_reads(flats: Sequence[tuple]):
    """Concatenate per-pivot flat_reads_device outputs into ONE device
    query array (each read row already ends with a separator 4, so no
    k-mer window can span two pivots — spanning windows contain the
    separator and are invalid).  Returns (big_flat, spans) where
    spans[i] = (offset, r, l) recovers pivot i's slice."""
    big = jnp.concatenate([f for f, _, _ in flats])
    spans, off = [], 0
    for f, r, l in flats:
        spans.append((off, r, l))
        off += int(f.shape[0])
    return big, spans


def read_votes_bulk_multi(
    group, big_flat, spans, k: int, num_datasets: int, kmax: int | None = None
):
    """ALL pivots' reads voted from ONE merge-join sort per k (exp6).

    The group texts dominate the sort volume and are identical for every
    pivot, so per-(k, pivot) sorts re-sort the same ~85% of elements D
    times (one 162M-element sort per (k, pivot) at reference scale).  Here every pivot's reads ride the same sort —
    query payloads carry GLOBAL flat positions, and per-pivot
    (votes, unmatched, n_kmers) come from slicing the position-ordered
    masks at the recorded spans.  With kmax set, the dynamic-k kernel is
    used so one compile serves the whole key-word class.

    group: pack_group_texts output; big_flat/spans: concat_flat_reads
    output.  Returns a list of host (votes [R,D] int64, unmatched [R],
    n_kmers [R]) triples aligned with spans — identical values to
    read_votes_bulk per pivot (tested)."""
    lcm = vote_lcm(num_datasets)
    if kmax is not None:
        # fused single-dispatch path: merge + every pivot's votes in ONE
        # device call (remote-link dispatch latency otherwise dominates)
        from ..engine.bits import key_words

        nw = key_words(kmax)
        assert key_words(k) == nw, (k, kmax)
        v, u, nk = _merge_votes_dyn(
            group, big_flat, jnp.uint32(k), kmax, nw, num_datasets,
            tuple(spans), lcm,
        )
        vh = np.asarray(v).astype(np.int64)
        uh = np.asarray(u).astype(np.int64)
        nh = np.asarray(nk).astype(np.int64)
        out, r0 = [], 0
        for _off, r, _l in spans:
            out.append((vh[r0 : r0 + r], uh[r0 : r0 + r], nh[r0 : r0 + r]))
            r0 += r
        return out
    qmask, qvalid = _read_votes_merge(group, big_flat, k, num_datasets, 0)
    out = []
    for off, r, l in spans:
        n = r * (l + 1)
        v, u, nk = _votes_from_masks(
            qmask[off : off + n], qvalid[off : off + n], r, l, num_datasets, lcm
        )
        out.append(
            (
                np.asarray(v).astype(np.int64),
                np.asarray(u).astype(np.int64),
                np.asarray(nk).astype(np.int64),
            )
        )
    return out


def pack_group_texts(group_codes: List[np.ndarray]):
    """Pack + upload the per-dataset group texts ONCE for the merge
    voting — as 2-bit packed codes + a 1-bit invalid mask, rebuilt on
    device (pack_members_device): the raw uint8 codes + uint32 gids are
    5 B/position, ~800 MB at reference scale, against ~0.375 B/position
    packed over the host-to-device link."""
    from ..engine.occurrence import pack_members_device

    return pack_members_device(group_codes)


@jax.jit
def _unpack_flat(packed_bytes, invalid_bits):
    """Device-side expansion of a 2-bit packed flat read stream."""
    shifts = jnp.arange(4, dtype=jnp.uint32) * 2
    c = (
        (packed_bytes[:, None].astype(jnp.uint32) >> shifts[None, :]) & 3
    ).astype(jnp.uint8).reshape(-1)
    bshifts = jnp.arange(8, dtype=jnp.uint32)
    inv = (
        (invalid_bits[:, None].astype(jnp.uint32) >> bshifts[None, :]) & 1
    ).astype(jnp.bool_).reshape(-1)
    return jnp.where(inv, jnp.uint8(4), c)


def flat_reads_device(reads_codes: np.ndarray):
    """Flatten a [R, L] read matrix with separators and upload once —
    2-bit packed + 1-bit invalid mask (0.375 B/position instead of 1),
    padded to a multiple of 8 with separators (pad windows are invalid,
    and span offsets downstream use the padded device shapes)."""
    r, l = reads_codes.shape
    flat = np.concatenate(
        [reads_codes, np.full((r, 1), 4, reads_codes.dtype)], axis=1
    ).reshape(-1)
    p = -(-flat.shape[0] // 8) * 8
    fp = np.concatenate([flat, np.full(p - flat.shape[0], 4, np.uint8)])
    vals = np.where(fp < 4, fp, 0).astype(np.uint8)
    packed = vals[0::4] | (vals[1::4] << 2) | (vals[2::4] << 4) | (vals[3::4] << 6)
    invalid = np.packbits(fp >= 4, bitorder="little")
    return (
        _unpack_flat(jax.device_put(packed), jax.device_put(invalid)),
        r,
        l,
    )


def read_votes_bulk(group, reads_codes, k: int, num_datasets: int):
    """read_votes against the group texts directly (exp6 fast path).

    group: list of per-dataset code arrays OR a pre-packed device pair
    from pack_group_texts; reads_codes: [R, L] uint8 matrix or a
    (flat_device, r, l) triple from flat_reads_device.  Returns
    (votes [R, D] int64, unmatched [R], n_kmers [R]) — identical to
    read_votes over build_group_mask_annotation, without any lookups."""
    if isinstance(group, tuple):
        cg = group
    else:
        cg = pack_group_texts(group)
    if isinstance(reads_codes, tuple):
        flat, r, l = reads_codes
    else:
        flat, r, l = flat_reads_device(reads_codes)
    qmask, qvalid = _read_votes_merge(cg, flat, k, num_datasets, 0)
    n = r * (l + 1)  # flat_reads_device pads to a multiple of 8
    v, u, nk = _votes_from_masks(
        qmask[:n], qvalid[:n], r, l, num_datasets, vote_lcm(num_datasets)
    )
    return (
        np.asarray(v).astype(np.int64),
        np.asarray(u).astype(np.int64),
        np.asarray(nk).astype(np.int64),
    )


@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _votes_from_masks(qmask, valid, r, l, num_datasets, lcm):
    qmask = jnp.where(valid, qmask, 0)
    nmatch = jax.lax.population_count(qmask)
    weight = jnp.where(nmatch > 0, lcm // jnp.maximum(nmatch, 1), 0)
    votes = []
    for d in range(num_datasets):
        in_d = ((qmask >> d) & 1) == 1
        wd = jnp.where(in_d, weight, 0).reshape(r, l + 1)
        votes.append(jnp.sum(wd, axis=1))
    unmatched = jnp.sum(
        jnp.where(valid & (nmatch == 0), 1, 0).reshape(r, l + 1), axis=1
    )
    n_kmers = jnp.sum(valid.reshape(r, l + 1), axis=1)
    return jnp.stack(votes, axis=1), unmatched, n_kmers


def read_votes(ann: Annotation, reads_codes: np.ndarray):
    """Integer votes per read: votes[r, d] = LCM-scaled match weight.

    reads_codes: [R, L] uint8 code matrix (pad short reads with 4s).
    Returns (votes [R, D] int, unmatched [R], n_kmers [R]) on host.
    The reference's per-read voting loop is src/merge_lists.py:151-183.
    """
    v, u, nk = _read_votes(
        (ann.keys, ann.pivot_count, ann.mask),
        jnp.asarray(reads_codes),
        0,
        ann.k,
        ann.num_datasets,
        vote_lcm(ann.num_datasets),
    )
    return (
        np.asarray(v).astype(np.int64),
        np.asarray(u).astype(np.int64),
        np.asarray(nk).astype(np.int64),
    )
