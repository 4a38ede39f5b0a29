"""Fused genome-occurrence counting — the north-star fast path.

The reference's exp1 inner loop per (k, group) is: count each genome
(KMC), set_counts 1, n-way union with count-sum, histogram — four process
boundaries and G+1 sorts' worth of work (exp_type_1.smk:156-191). But the
quantity it computes per k-mer is just "how many distinct genomes contain
it". That is ONE variadic device sort of (canonical key, genome_id) pairs:

  sort by (key, gid) -> a key's run contains its (key, gid) sub-runs ->
  occurrences = number of sub-run starts inside the key run ->
  histogram of occurrences (saturated at the union counter cap).

Everything after the sort is gather/scatter-free prefix-scan work (see
ops._run_sums). The same program computes the across-group histogram with
group ids in place of genome ids. Bit-identical to the composed table ops
(tested against them and the oracle), ~G x less sort volume.
"""

from __future__ import annotations

from functools import partial
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .bits import (
    key_words,
    sentinel_key,
    words_eq,
    words_is_sentinel,
    words_select,
)
from .extract import extract_canonical
from .ops import _run_sums


@partial(jax.jit, static_argnums=(1, 2, 3))
def _occurrence_counts(codes_gids, k, cs, n_words):
    """codes_gids: (codes uint8 [N], gids uint32 [N]).

    Returns (keys, occ_counts) in run form: occ at each distinct key's
    first slot = number of distinct gids containing it (capped at cs).
    """
    codes, gids = codes_gids
    keys, valid = extract_canonical(codes, k)
    gid_key = jnp.where(valid, gids, jnp.uint32(0xFFFFFFFF))
    sorted_ops = jax.lax.sort(
        list(keys) + [gid_key], num_keys=n_words + 1, is_stable=False
    )
    skeys = tuple(sorted_ops[:n_words])
    sgids = sorted_ops[n_words]

    prev_keys = tuple(jnp.roll(w, 1) for w in skeys)
    key_new = ~words_eq(skeys, prev_keys)
    key_new = key_new.at[0].set(True)
    gid_new = sgids != jnp.roll(sgids, 1)
    sub_start = (key_new | gid_new).astype(jnp.uint32)

    occ = _run_sums(sub_start, key_new)
    occ = jnp.minimum(occ, jnp.uint32(cs))
    occ = jnp.where(words_is_sentinel(skeys), 0, occ)
    return skeys, occ


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _occurrence_histogram(codes_gids, k, cs, cx, n_words, n_members):
    _, occ = _occurrence_counts(codes_gids, k, cs, n_words)
    # occ <= n_members, so the histogram is n_members comparison-reductions
    # — far cheaper than sorting the counts array.
    max_occ = min(n_members, cx)
    bins = [jnp.sum((occ == b).astype(jnp.int32)) for b in range(1, max_occ + 1)]
    hist = jnp.zeros((cx,), jnp.int32)
    return hist.at[: max_occ].set(jnp.stack(bins))


def _extract_canonical_dyn(codes, k, kmax, n_words):
    """Canonical extraction with k as a TRACED scalar (kmax static).

    Incremental predicated pushes inside a lax.scan: after kmax steps
    exactly k shift steps have fired, so fwd holds the k-mer, rc its
    reverse complement (low 2k bits), with no dynamic shifts — one XLA
    compile serves every k <= kmax of the same word width. This matters
    because each distinct static k is a separate XLA compile (the
    reference's 30-point k grid, workflow/Snakefile:36). The scan (vs a
    Python-unrolled loop) keeps the HLO ~kmax-times smaller than an
    unroll's ~kmax x 10 full-array ops, and with it the compile time.
    """
    n = codes.shape[0]
    cp = jnp.concatenate([codes, jnp.full((kmax,), 4, codes.dtype)])
    k32 = k.astype(jnp.int32)

    def step(carry, j):
        fwd, rc, valid = carry
        on = j < k32
        d = jax.lax.dynamic_slice(cp, (j,), (n,)).astype(jnp.uint32)
        valid = jnp.where(on, valid & (d < 4), valid)
        db = d & 3
        nf = []
        for wi in range(n_words - 1):
            nf.append((fwd[wi] << 2) | (fwd[wi + 1] >> 30))
        nf.append((fwd[n_words - 1] << 2) | db)
        fwd = tuple(jnp.where(on, a, b) for a, b in zip(nf, fwd))
        # rc |= comp(base_j) << 2j ; word index / shift are j-dependent
        # scalars here (traced), selected per word
        dc = db ^ 3
        word_idx = (n_words - 1) - (2 * j) // 32
        shift = jnp.uint32((2 * j) % 32)
        rc = tuple(
            jnp.where(
                on & (word_idx == wi), rc[wi] | (dc << shift), rc[wi]
            )
            for wi in range(n_words)
        )
        return (fwd, rc, valid), None

    # derive the init carry from the input so it picks up any shard_map
    # varying-axis tags (a plain zeros() constant makes lax.scan reject
    # the carry as unvarying-vs-varying under shard_map)
    z32 = cp[:n].astype(jnp.uint32) * 0
    init = (
        tuple(z32 for _ in range(n_words)),
        tuple(z32 for _ in range(n_words)),
        z32 == 0,
    )
    (fwd, rc, valid), _ = jax.lax.scan(
        step, init, jnp.arange(kmax, dtype=jnp.int32)
    )

    from .bits import sentinel_key, words_lt, words_select

    canon = words_select(words_lt(tuple(fwd), tuple(rc)), tuple(fwd), tuple(rc))
    sent = sentinel_key(n_words, valid.shape)
    return words_select(valid, canon, sent), valid


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _occurrence_histogram_dyn(codes_gids, k, kmax, cs, cx, n_words, n_members):
    """Dynamic-k variant of _occurrence_histogram (same outputs)."""
    codes, gids = codes_gids
    keys, valid = _extract_canonical_dyn(codes, k, kmax, n_words)
    gid_key = jnp.where(valid, gids, jnp.uint32(0xFFFFFFFF))
    sorted_ops = jax.lax.sort(
        list(keys) + [gid_key], num_keys=n_words + 1, is_stable=False
    )
    skeys = tuple(sorted_ops[:n_words])
    sgids = sorted_ops[n_words]
    prev_keys = tuple(jnp.roll(w, 1) for w in skeys)
    key_new = ~words_eq(skeys, prev_keys)
    key_new = key_new.at[0].set(True)
    gid_new = sgids != jnp.roll(sgids, 1)
    occ = _run_sums((key_new | gid_new).astype(jnp.uint32), key_new)
    occ = jnp.minimum(occ, jnp.uint32(cs))
    occ = jnp.where(words_is_sentinel(skeys), 0, occ)
    max_occ = min(n_members, cx)
    bins = [jnp.sum((occ == b).astype(jnp.int32)) for b in range(1, max_occ + 1)]
    hist = jnp.zeros((cx,), jnp.int32)
    return hist.at[: max_occ].set(jnp.stack(bins))


def kmax_class(k: int) -> int:
    """Word-width class ceiling: one compile per class serves all its ks."""
    return 15 if k <= 15 else 31 if k <= 31 else 63


# --- gid-packed sort: fold the genome id into the key's low bits ------------
#
# The fused occurrence sort orders (canonical key, gid) pairs. Storing the
# gid as a separate sort word costs a full extra 32-bit operand per element.
# Since groups are small (reference datasets are ~10 genomes; we support up
# to 2^GID_BITS members), the pair fits in fewer words when the gid rides in
# the low GID_BITS of the shifted key: sort volume drops 3->2 words for
# 13<=k<=28, 2->1 for k<=12, and 5->3 for 29<=k<=44 (covering the whole
# reference grid k=7..30,34..49 except 46/49 at 4 words,
# workflow/Snakefile:36). Ordering by packed value == ordering by (key, gid),
# so the occurrence scan is unchanged; the packed value of a valid window
# can never equal the all-ones SENTINEL because a canonical key is
# min(fwd, rc) and the all-T k-mer's rc is all-A (= 0), so a canonical key
# is never all-ones.

GID_BITS = 8


def kmax_class_packed(k: int) -> int:
    """Word-width class ceiling for the gid-packed sort."""
    if k <= 12:
        return 12
    if k <= 28:
        return 28
    if k <= 44:
        return 44
    if k <= 60:
        return 60
    raise ValueError(f"k={k} not supported by the packed path (max 60)")


def occ_words_packed(kmax: int) -> int:
    """uint32 words holding (2*kmax key bits + GID_BITS gid bits)."""
    return (2 * kmax + GID_BITS + 31) // 32


def _pack_gid_words(keys: tuple, valid, gids, n_words: int) -> tuple:
    """(key << GID_BITS) | gid across the word tuple; SENTINEL if invalid."""
    gb = GID_BITS
    packed = []
    for i in range(n_words - 1):
        packed.append((keys[i] << gb) | (keys[i + 1] >> (32 - gb)))
    packed.append((keys[n_words - 1] << gb) | gids)
    sent = sentinel_key(n_words, valid.shape)
    return words_select(valid, tuple(packed), sent)


def occ_words_static(k: int) -> int:
    """uint32 words for (key << GID_BITS | gid) at a STATIC k (exact, not
    class-padded like occ_words_packed)."""
    return (2 * k + GID_BITS + 31) // 32


def pack_gid_static(keys: tuple, valid, gids, k: int) -> tuple:
    """(key << GID_BITS) | gid re-laid over occ_words_static(k) words.

    keys arrive right-aligned in key_words(k) words (which jumps 2 -> 4 at
    k=32); the packed width can be smaller (e.g. k=35: 4 key words but 3
    packed words) or larger (k=31: 2 -> 3), so align first, then shift.
    """
    w = len(keys)
    ow = occ_words_static(k)
    if ow > w:
        keys = tuple(jnp.zeros_like(keys[0]) for _ in range(ow - w)) + keys
        w = ow
    gb = GID_BITS
    shifted = []
    for i in range(w - 1):
        shifted.append((keys[i] << gb) | (keys[i + 1] >> (32 - gb)))
    shifted.append((keys[w - 1] << gb) | gids)
    packed = tuple(shifted[w - ow:])  # leading words are provably zero
    sent = sentinel_key(ow, valid.shape)
    return words_select(valid, packed, sent)


def unpack_keys_static(sp: tuple, k: int) -> tuple:
    """Recover key_words(k)-layout keys from sorted packed words.

    key = packed >> GID_BITS; positions whose packed value is the SENTINEL
    (invalid windows / padding) are restored to the all-ones sentinel so
    the KmerTable invariant (ascending keys, sentinels last) holds.
    """
    ow = len(sp)
    wk = key_words(k)
    gb = GID_BITS
    shifted = []
    for i in range(ow):
        hi = (sp[i - 1] << (32 - gb)) if i > 0 else jnp.zeros_like(sp[0])
        shifted.append(hi | (sp[i] >> gb))
    if wk >= ow:
        keys = tuple(jnp.zeros_like(sp[0]) for _ in range(wk - ow)) + tuple(shifted)
    else:
        keys = tuple(shifted[ow - wk:])  # leading words are provably zero
    sent_mask = words_is_sentinel(sp)
    return words_select(sent_mask, sentinel_key(wk, sent_mask.shape), keys)


def _packed_occ(sp: tuple, cs, n_words: int):
    """Occurrence counts (distinct gids per key) from sorted packed words."""
    prev = tuple(jnp.roll(w, 1) for w in sp)
    pair_eq = words_eq(sp, prev)
    key_eq = (sp[-1] >> GID_BITS) == (prev[-1] >> GID_BITS)
    for i in range(n_words - 1):
        key_eq = key_eq & (sp[i] == prev[i])
    key_new = (~key_eq).at[0].set(True)
    pair_new = (~pair_eq).at[0].set(True)
    occ = _run_sums(pair_new.astype(jnp.uint32), key_new)
    occ = jnp.minimum(occ, jnp.uint32(cs))
    return jnp.where(words_is_sentinel(sp), 0, occ)


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _occurrence_histogram_dyn_packed(
    codes_gids, k, kmax, cs, cx, n_words, n_members
):
    """Dynamic-k occurrence histogram over the gid-packed sort."""
    codes, gids = codes_gids
    keys, valid = _extract_canonical_dyn(codes, k, kmax, n_words)
    packed = _pack_gid_words(keys, valid, gids, n_words)
    sp = tuple(jax.lax.sort(list(packed), num_keys=n_words, is_stable=False))
    occ = _packed_occ(sp, cs, n_words)
    max_occ = min(n_members, cx)
    bins = [jnp.sum((occ == b).astype(jnp.int32)) for b in range(1, max_occ + 1)]
    hist = jnp.zeros((cx,), jnp.int32)
    return hist.at[:max_occ].set(jnp.stack(bins))


def _padded_len(n: int) -> int:
    """Geometric shape bucketing for packed inputs.

    Above 32 MiB: pad to a multiple of 2^(floor(log2 n) - 4) — at most 16
    distinct shapes per size octave, <= 6.25% padding waste. Below 32 MiB
    the 1 MiB-granule clamp keeps the previous scheme (waste up to ~2x
    only for inputs just past a small power of two, <= ~6% above 16 MiB).
    Bounds compile variety: every distinct shape costs a fresh XLA
    compile of the sweep program, which dominates end-to-end wall time
    when every dataset gets its own shape."""
    n = max(int(n), 1024)
    if n <= (1 << 20):
        return 1 << (n - 1).bit_length()
    granule = max(1 << 20, 1 << (max(n.bit_length() - 1, 0) - 4))
    return ((n + granule - 1) // granule) * granule


def _member_layout(member_codes: Sequence[np.ndarray]):
    """(concatenated codes incl. separators, member start offsets, padded
    length): the shared layout of pack_members / pack_members_device."""
    parts = []
    starts = [0]
    for codes in member_codes:
        parts.append(np.asarray(codes, np.uint8))
        parts.append(np.full(1, 4, np.uint8))
        starts.append(starts[-1] + codes.shape[0] + 1)
    codes = np.concatenate(parts)
    return codes, np.asarray(starts[:-1], np.int64), _padded_len(codes.shape[0])


@partial(jax.jit, static_argnums=(3,))
def _unpack_members(packed_bytes, invalid_bits, seps, n):
    """Device-side expansion of 2-bit packed member codes.

    packed_bytes: uint8 [n/4] (4 codes per byte, LSB first);
    invalid_bits: uint8 [n/8] bitmask of positions whose code is >= 4
    (N bases, separators, tail padding); seps: int32 separator positions
    (for gid reconstruction). Returns (codes uint8 [n], gids uint32 [n])
    equal to pack_members' output everywhere (gids may differ only on
    tail padding, which every consumer masks)."""
    shifts = jnp.arange(4, dtype=jnp.uint32) * 2
    c = ((packed_bytes[:, None].astype(jnp.uint32) >> shifts[None, :]) & 3).astype(
        jnp.uint8
    ).reshape(-1)
    bshifts = jnp.arange(8, dtype=jnp.uint32)
    inv = ((invalid_bits[:, None].astype(jnp.uint32) >> bshifts[None, :]) & 1).astype(
        jnp.bool_
    ).reshape(-1)
    c = jnp.where(inv, jnp.uint8(4), c)
    # gid[i] = index of the member containing i (tail keeps the last gid;
    # such positions are invalid everywhere)
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32), seps + 1])
    marks = jnp.zeros((n,), jnp.uint32).at[starts].add(
        1, mode="drop"
    )  # final "start" may be == n (pure-tail), drop it
    gids = jnp.cumsum(marks) - 1
    return c, gids.astype(jnp.uint32)


def pack_members_device(member_codes: Sequence[np.ndarray]):
    """pack_members, but host->device transfer is 2-bit packed codes plus
    a 1-bit invalid mask (~0.375 B/position instead of 5: the uint8 code
    array AND the uint32 gid array are rebuilt on device), which cuts
    the PCIe transfer per group ~13x. Bit-identical to pack_members on
    codes and on every valid position's gid (tested)."""
    codes, starts, p = _member_layout(member_codes)
    data_end = int(codes.shape[0])
    invalid = np.ones(p, np.uint8)
    invalid[:data_end] = codes >= 4
    vals = np.where(codes < 4, codes, 0).astype(np.uint8)
    vals = np.concatenate([vals, np.zeros(p - data_end, np.uint8)])
    packed_bytes = (
        vals[0::4] | (vals[1::4] << 2) | (vals[2::4] << 4) | (vals[3::4] << 6)
    )
    invalid_bits = np.packbits(invalid, bitorder="little")
    # separator positions: one before each later member start + final
    seps = np.concatenate([starts[1:] - 1, [data_end - 1]]).astype(np.int32)
    return _unpack_members(
        jax.device_put(packed_bytes),
        jax.device_put(invalid_bits),
        jnp.asarray(seps),
        p,
    )


def pack_members(member_codes: Sequence[np.ndarray]):
    """Concatenate member code arrays with separators and emit gid labels."""
    parts, gparts = [], []
    for gid, codes in enumerate(member_codes):
        parts.append(np.asarray(codes, np.uint8))
        parts.append(np.full(1, 4, np.uint8))
        gparts.append(np.full(codes.shape[0] + 1, gid, np.uint32))
    codes = np.concatenate(parts)
    gids = np.concatenate(gparts)
    pad = _padded_len(codes.shape[0]) - codes.shape[0]
    codes = np.concatenate([codes, np.full(pad, 4, np.uint8)])
    gids = np.concatenate([gids, np.zeros(pad, np.uint32)])
    return codes, gids


def occurrence_histogram_packed(
    packed,
    n_members: int,
    k: int,
    cs: int = 5000,
    cx: int = 10000,
    dynamic_k: bool = True,
) -> List[int]:
    """Like occurrence_histogram but over pre-packed (codes, gids) arrays —
    pack/upload once per group, sweep every k over the resident arrays
    (30 re-uploads per group would cost host-to-device bandwidth for
    nothing)."""
    codes, gids = packed
    if dynamic_k and n_members <= (1 << GID_BITS) and k <= 60:
        # gid-packed sort: fewest sort words for the (key, gid) pair
        km = kmax_class_packed(k)
        hist = _occurrence_histogram_dyn_packed(
            (jnp.asarray(codes), jnp.asarray(gids)),
            jnp.uint32(k),
            km,
            cs,
            cx,
            occ_words_packed(km),
            n_members,
        )
    elif dynamic_k:
        km = kmax_class(k)
        hist = _occurrence_histogram_dyn(
            (jnp.asarray(codes), jnp.asarray(gids)),
            jnp.uint32(k),
            km,
            cs,
            cx,
            key_words(km),
            n_members,
        )
    else:
        hist = _occurrence_histogram(
            (jnp.asarray(codes), jnp.asarray(gids)),
            k,
            cs,
            cx,
            key_words(k),
            n_members,
        )
    return np.asarray(hist).tolist()


@partial(jax.jit, static_argnums=(1, 2))
def _occurrence_counts_packed(codes_gids, k, cs):
    """(keys in key_words(k) layout, occ counts in run form) via the
    gid-packed sort — fewer sort operands than _occurrence_counts for
    every k (see GID_BITS rationale above), keys recovered by unshifting."""
    codes, gids = codes_gids
    keys, valid = extract_canonical(codes, k)
    packed = pack_gid_static(keys, valid, gids, k)
    ow = occ_words_static(k)
    sp = tuple(jax.lax.sort(list(packed), num_keys=ow, is_stable=False))
    occ = _packed_occ(sp, cs, ow)
    return unpack_keys_static(sp, k), occ


def occurrence_table(
    member_codes: Sequence[np.ndarray], k: int, cs: int = 5000
):
    """KmerTable whose counts = number of members containing each key —
    the `set_counts 1` + n-way `kmc_tools complex` union in ONE sort
    (reference exp_type_1.smk:165-182, exp_type_2.smk:440-454 role)."""
    from .table import KmerTable

    codes, gids = pack_members(member_codes)
    cg = (jnp.asarray(codes), jnp.asarray(gids))
    if len(member_codes) <= (1 << GID_BITS) and k <= 60:
        keys, occ = _occurrence_counts_packed(cg, k, cs)
    else:
        keys, occ = _occurrence_counts(cg, k, cs, key_words(k))
    return KmerTable(keys=keys, counts=occ, k=k)


def occurrence_histogram(
    member_codes: Sequence[np.ndarray],
    k: int,
    cs: int = 5000,
    cx: int = 10000,
    dynamic_k: bool = True,
) -> List[int]:
    """hist[i-1] = number of distinct canonical k-mers present in exactly i
    members (the exp1 within/across-group histogram), in one fused pass.

    dynamic_k=True traces k as a runtime scalar so one compile serves every
    k in a word-width class (k<=15 / <=31 / <=63) — a 10-24x compile-count
    saving over the reference's 30-point grid.
    """
    import jax as _jax

    codes, gids = pack_members(member_codes)
    packed = (_jax.device_put(codes), _jax.device_put(gids))
    return occurrence_histogram_packed(
        packed, len(member_codes), k, cs=cs, cx=cx, dynamic_k=dynamic_k
    )
