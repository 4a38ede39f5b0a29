"""Shared-sort k-sweep: every k's occurrence histogram from ONE device sort.

The reference runs its whole pipeline once per k over a 30-point grid
(workflow/Snakefile:36), so the fused occurrence step (engine/occurrence.py)
pays one (key, gid) sort per k, and that sort dominates the fused step's
device time.  This module removes the per-k sort entirely:

THE TRICK — canonical histograms from one forward-prefix sort of the
DOUBLED text (each genome followed by its reverse complement):

  * forward k-mer keys nest: the forward key of the k-mer at position i is
    the top 2k bits of the kmax-mer at i, so ONE sort by (A-padded) forward
    kmax-mer groups every k <= kmax's k-mers into contiguous runs
    simultaneously (a k-run = maximal stretch of equal top-2k bits).
  * canonical counting needs min(fwd, revcomp) per k, which does NOT nest —
    so instead of canonicalizing we COUNT BOTH STRANDS: in seq+revcomp(seq),
    genome g contains forward k-mer x iff g contains the canonical class
    {x, revcomp(x)}.  Hence every run's distinct-genome set equals its
    canonical class's genome set, each non-palindromic class appears as
    exactly TWO runs (x and revcomp(x)) with identical sets, and a
    palindromic class (x == revcomp(x), even k only) as ONE:

        hist_canonical = (hist_doubled + hist_palindromic) / 2     (exact)

  * per-position validity is carried as nio = #consecutive valid bases from
    the position (capped at kmax): the element participates for k iff
    nio >= k, which handles N bases, record separators and short contigs
    exactly (invalid positions pack as 0, and real base values after them
    stay in the key — harmless garbage, because an element is only ever
    read at k <= nio, whose top-2k bits cover valid bases only; see
    _extract_fwd_sweep).
  * distinct genomes per run need no gid adjacency: a segmented OR-scan of
    one-hot gid bitmasks over each k-run, popcount at run ends.

Replaces, per (k, group), the reference's `kmc` count + `kmc_tools complex`
union + `histogram` chain (workflow/rules/exp_type_1.smk:156-191) — for the
WHOLE k grid at the cost of ~one sort per key-word class instead of one per
k.  Histograms are bit-identical to engine/occurrence.py (tested).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

GID_BITS = 8  # gids in the payload word; n_members <= 32 for the mask scan
NIO_BITS = 8

# Packed-payload mode: when the key words' spare low bits can hold the
# payload, the sort drops the separate payload operand entirely — for the
# reference's full k grid (kmax=49, KW=4, 30 spare bits) ONE 4-operand
# doubled-text sort serves all 30 ks, vs 3-operand (k<=30) + 4-operand
# (33<k<=46) + per-k (k=49) sorts before.  gid rides in 6 bits (the
# two-channel uint32 mask scan covers n_members <= MASK_MEMBERS_OCC = 64)
# and nio in 6 (kmax <= 63).  The payload must stay clear of every per-k
# comparison: _prefix_differs reads bits >= spare, and in _rev2comp_words
# the payload's low 2-bit groups land in the top bits of rev, above the
# 2k bits _pal_mask inspects; the sentinel encoding additionally needs
# >= 1 spare bit ABOVE the 12 payload bits that is one in the sentinel
# and zero in every real element (streaming.sentinel_encode_packed) —
# hence spare >= PACK_MIN_SPARE = 14 (group-aligned payload + 2 guard
# bits).
PACK_GID_BITS = 6
PACK_NIO_BITS = 6
PACK_MIN_SPARE = 14

# The multi-k scan's member-presence masks: the occurrence scan runs one
# uint32 one-hot OR-scan channel per 32 members (two channels at <= 64 —
# beyond that the extra scan volume and the 6-bit packed gid field stop
# paying); the classification scans read bit-sliced single-channel masks,
# so their groups stop at 32 members.
MASK_MEMBERS_OCC = 64
MASK_MEMBERS_CLASSIFY = 32


def _pack_spare(kmax: int, KW: int) -> int:
    return KW * 32 - 2 * kmax


def can_pack_payload(kmax: int, KW: int) -> bool:
    return _pack_spare(kmax, KW) >= PACK_MIN_SPARE


def sweep_classes(ks: Sequence[int]) -> List[tuple]:
    """Partition a k grid into shared-sort classes [(kmax, KW, ks), ...].

    One class per key-word count KW = ceil(2*kmax/32); ks needing one word
    are merged into the two-word class when one exists (a second full sort
    costs more than widening the scan of an existing one).
    """
    ks = sorted(set(int(k) for k in ks))
    if not ks:
        return []
    buckets: Dict[int, List[int]] = {}
    for k in ks:
        if k < 2 or k > 63:
            raise ValueError(f"k={k} outside supported sweep range [2, 63]")
        buckets.setdefault((2 * k + 31) // 32, []).append(k)
    if 1 in buckets and 2 in buckets:
        buckets[2] = buckets.pop(1) + buckets[2]
    return [
        (max(bks), (2 * max(bks) + 31) // 32, tuple(sorted(bks)))
        for _, bks in sorted(buckets.items())
    ]


def _shl_words(words: tuple, t) -> tuple:
    """Left-shift a KW-word (MSB-first) tuple by t bits, 0 <= t < 32*KW;
    t may be a traced scalar (the word and bit offsets are selected, not
    indexed)."""
    KW = len(words)
    z = jnp.zeros_like(words[0])
    ext = tuple(words) + (z,) * KW
    ws = t // 32
    bs = jnp.asarray(t % 32, jnp.uint32)
    out = []
    for i in range(KW):
        acc = z
        for w in range(KW):
            lo = jnp.where(bs == 0, z, ext[i + w + 1] >> (jnp.uint32(32) - bs))
            acc = jnp.where(ws == w, (ext[i + w] << bs) | lo, acc)
        out.append(acc)
    return tuple(out)


def _rev2comp_words(words: tuple) -> tuple:
    """Reverse 2-bit groups of the complemented full KW*32-bit value.

    With the key left-aligned in the top 2*kmax bits, the result holds the
    reverse complement of the kmax window in its LOW 2*kmax bits: original
    digit j (0 = window start) lands at 2-bit group j from the bottom, so
    the low 2k bits read MSB-first are comp(b_{k-1})..comp(b_0) — the
    reverse complement of the k-prefix, for every k <= kmax at once.
    """
    out = []
    for w in reversed(words):
        x = ~w
        x = ((x & jnp.uint32(0x33333333)) << 2) | ((x >> 2) & jnp.uint32(0x33333333))
        x = ((x & jnp.uint32(0x0F0F0F0F)) << 4) | ((x >> 4) & jnp.uint32(0x0F0F0F0F))
        x = ((x & jnp.uint32(0x00FF00FF)) << 8) | ((x >> 8) & jnp.uint32(0x00FF00FF))
        x = (x << 16) | (x >> 16)
        out.append(x)
    return tuple(out)


def _extract_fwd_sweep(codes2, gids2, kmax: int, KW: int, packed: bool = False):
    """Forward kmax-mer keys (left-aligned in KW uint32 words) + payload
    (gid, nio).

    Word w of position i's key packs bases [i+16w, i+16w+16), so ONE
    16-step shift-or over an extended position range yields every word as
    a slice — kmax-independent, vs the kmax-step rolling build. nio
    (#consecutive valid bases from i, capped at kmax) comes from a single
    reverse cummin of invalid positions. Bases at invalid positions pack
    as 0; bases AFTER an invalid one inside the window keep their real
    values — harmless garbage: an element is only ever read at k <= nio,
    and its top 2k bits then cover valid bases only (run grouping,
    key_new, and palindrome checks all read top-2k bits exclusively).

    packed=False: payload is a separate word (gid << 8 | nio).
    packed=True: payload rides in the spare low bits of the last key word
    ((gid << 6) | nio, requires can_pack_payload(kmax, KW)); returns
    (fwd, None)."""
    n = codes2.shape[0]
    m = n + 16 * (KW - 1)  # word w of position i = word 0 of position i+16w
    cp = jnp.concatenate([codes2, jnp.full((16 * KW,), 4, codes2.dtype)])
    valid = cp < 4
    d2 = jnp.where(valid, cp.astype(jnp.uint32) & 3, jnp.uint32(0))
    # logarithmic doubling: pairs -> quads -> bytes -> 16-base words
    # (4 shift-or steps instead of 16; pk[i] packs 2^s bases from i)
    w = d2
    for s in range(4):
        span = 1 << s  # bases per element before this step
        w = (w[: w.shape[0] - span] << (2 * span)) | w[span:]
    w = w[:m]
    fwd = tuple(w[16 * wi : 16 * wi + n] for wi in range(KW))
    # zero the spare low bits (bases beyond kmax in the last word)
    spare = KW * 32 - 2 * kmax
    if spare:
        mask = jnp.uint32((0xFFFFFFFF >> spare) << spare)
        fwd = fwd[:-1] + (fwd[-1] & mask,)
    # nio via next-invalid position: one reverse cummin instead of a
    # kmax-step alive scan
    idx = jnp.arange(cp.shape[0], dtype=jnp.int32)
    inv_pos = jnp.where(valid, jnp.int32(0x7FFFFFFF), idx)
    next_inv = jax.lax.cummin(inv_pos, axis=0, reverse=True)
    nio = jnp.minimum(next_inv[:n] - idx[:n], kmax).astype(jnp.uint32)
    if packed:
        assert can_pack_payload(kmax, KW)
        pay = (gids2 << PACK_NIO_BITS) | nio
        fwd = fwd[:-1] + (fwd[-1] | pay,)
        return fwd, None
    payload = (gids2 << NIO_BITS) | nio
    return fwd, payload


def _prefix_differs(a: tuple, b: tuple, k, KW: int):
    """True where the top 2k bits of the KW-word values a and b differ.
    k may be a Python int or a traced scalar."""
    shift = KW * 32 - 2 * k  # key bits for k live at positions >= shift
    neq = jnp.zeros(a[0].shape, jnp.bool_)
    for i in range(KW):
        s = shift - (KW - 1 - i) * 32  # low bits of word i outside the prefix
        sc = jnp.asarray(jnp.clip(s, 0, 31), jnp.uint32)
        neq = neq | ((s < 32) & (((a[i] ^ b[i]) >> sc) != 0))
    return neq


def _pal_mask(skeys: tuple, rev: tuple, k, KW: int):
    """True where the k-prefix equals its own reverse complement (pal run).

    rev's low 2k bits hold the reverse complement of the k-prefix
    (_rev2comp_words), so shifting them up to the top 2k bits lines them
    up with the prefix.  Always False at odd k: an odd-length k-mer never
    equals its reverse complement (its middle base would have to equal
    its own complement)."""
    return ~_prefix_differs(skeys, _shl_words(rev, KW * 32 - 2 * k), k, KW)


# Segmented scans, as blocked two-level Hillis-Steele scans: log2(C)
# unrolled in-row steps on a [n/C, C] view, a recursive scan of the row
# summaries, and one broadcast combine — a small static graph at any
# size.  Inside the exp1 sweep on an H100 (400 W limit) this form ran
# 250 ms vs 353 ms for jax.lax.associative_scan at 84M elements and
# within 2% at 336M, and compiled in 11-14 s vs 16-29 s (PERF.md).

_SEG_C = 1024


def _seg_scan_blocked(v, K, op, neutral):
    """Inclusive segmented scan of `op` with reset flags K (True = value
    restarts AT this element, its own v included).  Returns (values,
    flags-prefix)."""
    n = v.shape[0]
    if n <= 2 * _SEG_C:
        return _seg_scan_hs(v, K, op, neutral)
    pad = (-n) % _SEG_C
    if pad:
        v = jnp.concatenate([v, jnp.full((pad,), neutral, v.dtype)])
        K = jnp.concatenate([K, jnp.ones((pad,), jnp.bool_)])
    R = v.shape[0] // _SEG_C
    v2 = v.reshape(R, _SEG_C)
    K2 = K.reshape(R, _SEG_C)
    s = 1
    while s < _SEG_C:
        vs = jnp.concatenate(
            [jnp.full((R, s), neutral, v2.dtype), v2[:, :-s]], axis=1
        )
        Ks = jnp.concatenate([jnp.zeros((R, s), jnp.bool_), K2[:, :-s]], axis=1)
        v2 = jnp.where(K2, v2, op(vs, v2))
        K2 = K2 | Ks
        s *= 2
    pv, pk = _seg_scan_blocked(v2[:, -1], K2[:, -1], op, neutral)
    ev = jnp.concatenate([jnp.full((1,), neutral, pv.dtype), pv[:-1]])
    ek = jnp.concatenate([jnp.zeros((1,), jnp.bool_), pk[:-1]])
    out_v = jnp.where(K2, v2, op(ev[:, None], v2))
    out_k = K2 | ek[:, None]
    return out_v.reshape(-1)[:n], out_k.reshape(-1)[:n]


def _seg_scan_hs(v, K, op, neutral):
    """Flat unrolled Hillis-Steele segmented scan (small arrays)."""
    n = int(v.shape[0])
    s = 1
    while s < n:
        vs = jnp.concatenate([jnp.full((s,), neutral, v.dtype), v[:-s]])
        Ks = jnp.concatenate([jnp.zeros((s,), jnp.bool_), K[:-s]])
        v = jnp.where(K, v, op(vs, v))
        K = K | Ks
        s *= 2
    return v, K


def _seg_or_scan(m, boundary):
    """Inclusive segmented OR scan (reset at boundary; boundary[0] True)."""
    out, _ = _seg_scan_blocked(m, boundary, jnp.bitwise_or, 0)
    return out


def _seg_sum_scan(v, boundary):
    """Inclusive segmented SUM scan (reset at boundary; boundary[0] True)."""
    out, _ = _seg_scan_blocked(v, boundary, jnp.add, 0)
    return out


def _scan_multi_k(
    skeys, spayload, ks, kmax, KW, n_members, cs, packed=False, raw=False
):
    """Multi-k occurrence scan over one sorted doubled-text array (exact).

    Returns (n_ks, n_members) int32: canonical histograms, bin b-1 =
    #classes present in exactly b members. raw=True instead returns the
    (2, n_ks, n_members) stacked (doubled, palindromic) histograms WITHOUT
    the (d+p)//2 canonical combine — required by the sharded sweep, where
    a class's two strand runs can land in different shards and the
    halving is only exact after the cross-shard psum.
    """
    # one uint32 one-hot channel per 32 members: each channel carries its
    # own segmented OR scan and the popcounts add (a member lives in
    # exactly one channel) — removes the former 32-member sweep cliff
    n_ch = max(1, (n_members + 31) // 32)

    def one_k(k):
        # everything derived from skeys is rebuilt per k inside the loop
        # body, so only the sorted arrays stay live across iterations
        gid, nio = _payload_fields(skeys, spayload, packed)
        prev = tuple(jnp.roll(w, 1) for w in skeys)
        key_new = _prefix_differs(skeys, prev, k, KW).at[0].set(True)
        bsum = None
        for c in range(n_ch):
            if n_ch == 1:
                m = jnp.where(nio >= k, jnp.uint32(1) << gid, jnp.uint32(0))
            else:
                m = jnp.where(
                    (nio >= k) & ((gid >> 5) == c),
                    jnp.uint32(1) << (gid & jnp.uint32(31)),
                    jnp.uint32(0),
                )
            pc = jax.lax.population_count(_seg_or_scan(m, key_new))
            bsum = pc if bsum is None else bsum + pc
        run_end = jnp.roll(key_new, -1).at[-1].set(True)
        b = jnp.minimum(bsum.astype(jnp.uint32), jnp.uint32(cs))
        pal = _pal_mask(skeys, _rev2comp_words(skeys), k, KW)
        return jnp.stack([
            jnp.stack([
                jnp.sum((sel & (b == i)).astype(jnp.int32))
                for i in range(1, n_members + 1)
            ])
            for sel in (run_end, run_end & pal)
        ])

    # one loop iteration per k: one compile serves the whole grid, and
    # only one k's per-element temporaries are live at a time
    dp = jax.lax.map(one_k, jnp.asarray(ks, jnp.int32))  # (n_ks, 2, n_members)
    if raw:
        return jnp.transpose(dp, (1, 0, 2))
    return (dp[:, 0] + dp[:, 1]) // 2


def _payload_fields(skeys, spayload, packed):
    """(gid, nio) of every sorted element, from the packed last key word
    or the separate payload word."""
    if packed:
        gid = (skeys[-1] >> PACK_NIO_BITS) & jnp.uint32((1 << PACK_GID_BITS) - 1)
        nio = skeys[-1] & jnp.uint32((1 << PACK_NIO_BITS) - 1)
    else:
        gid = (spayload >> NIO_BITS) & jnp.uint32(0xFF)
        nio = spayload & jnp.uint32((1 << NIO_BITS) - 1)
    return gid, nio


def _sweep_doubled(codes, gids, kmax, KW, packed):
    """Doubled text (codes ++ revcomp) -> extracted forward kmax-mer
    elements -> ONE sorted array: (skeys tuple, payload or None).  The
    shared front half of every sweep consumer (exp1 histograms and the
    classification scans in ksweep_classify.py).

    The sort is one flat variadic lax.sort over KW key words (plus the
    payload word when it does not pack)."""
    rc = jnp.where(codes < 4, codes ^ 3, codes)[::-1]
    codes2 = jnp.concatenate([codes, rc])
    gids2 = jnp.concatenate([gids, gids[::-1]])
    fwd, payload = _extract_fwd_sweep(codes2, gids2, kmax, KW, packed=packed)
    if packed:
        skeys = tuple(jax.lax.sort(list(fwd), num_keys=KW, is_stable=False))
        return skeys, None
    ops = jax.lax.sort(list(fwd) + [payload], num_keys=KW, is_stable=False)
    return tuple(ops[:KW]), ops[KW]


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7))
def _sweep_class_fn(codes, gids, ks, kmax, KW, n_members, cs, packed=False):
    """All of `ks`'s canonical occurrence histograms from one doubled-text
    sort. codes: uint8 [n] (packed members, code 4 separators), gids:
    uint32 [n]. packed=True drops the payload operand from the sort (gid +
    nio ride the last key word's spare bits). Returns
    (len(ks), n_members) int32."""
    skeys, spay = _sweep_doubled(codes, gids, kmax, KW, packed)
    return _scan_multi_k(skeys, spay, ks, kmax, KW, n_members, cs, packed=packed)


def plan_sweep(ks: Sequence[int], n_members: int,
               mask_limit: int = MASK_MEMBERS_CLASSIFY):
    """Choose the sort plan: ([(kmax, KW, cks, packed)], per_k_fallback_ks).

    Candidate plans, costed in sorted-words-per-text-position (doubled
    text counts x2):

    - SPLIT: one sort per key-word class with >= 3 ks (sweep_classes),
      each packing its payload into spare key bits when they fit; classes
      with < 3 ks fall back to the per-k fused path (its sort moves
      occ_words_static(k) words over the UNdoubled text).
    - MASTER: one sort at kmax = max(ks) serving EVERY k — the k-run
      nesting holds for any k <= kmax, so the scan just reads shallower
      prefixes.  For the reference's full 30-point grid this is one
      4-operand packed sort vs 3+4-operand class sorts plus a per-k k=49
      fallback (8 vs 18 sorted words per position).

    The cheaper plan wins; n_members > mask_limit disables the sweep
    (exp1's occurrence consumers scan multi-channel masks and pass
    MASK_MEMBERS_OCC = 64; the classification scans' bit-sliced masks
    are single-channel, so they keep the 32-member default).
    """
    from .occurrence import occ_words_static

    ks = sorted(set(int(k) for k in ks))
    if n_members > mask_limit or n_members > (1 << PACK_GID_BITS):
        # groups beyond the scan's mask width (download_genomes.py -n is
        # unbounded) fall back to one fused sort PER k — correct, but the
        # grid pays ~len(ks) sorts instead of ~1.  Surface the cost cliff.
        if len(ks) >= 3:
            import logging

            logging.getLogger("khoice.ksweep").warning(
                "shared-sort sweep disabled: %d members > %d (scan mask "
                "width); falling back to %d per-k fused sorts — expect "
                "~%dx the sweep's sort volume for this group",
                n_members, min(mask_limit, 1 << PACK_GID_BITS),
                len(ks), len(ks),
            )
        return [], ks
    if len(ks) < 3:
        return [], ks

    split_classes = []
    split_rest: List[int] = []
    split_cost = 0.0
    for kmax, KW, cks in sweep_classes(ks):
        if len(cks) < 3:
            split_rest.extend(cks)
            split_cost += sum(occ_words_static(k) for k in cks)
        else:
            packed = can_pack_payload(kmax, KW)
            split_classes.append((kmax, KW, cks, packed))
            split_cost += 2 * (KW if packed else KW + 1)

    kmax_m = max(ks)
    KW_m = (2 * kmax_m + 31) // 32
    packed_m = can_pack_payload(kmax_m, KW_m)
    master_cost = 2 * (KW_m if packed_m else KW_m + 1)

    if master_cost < split_cost:
        return [(kmax_m, KW_m, tuple(ks), packed_m)], []
    return split_classes, split_rest


def occurrence_histograms_sweep_packed(
    packed,
    n_members: int,
    ks: Sequence[int],
    cs: int = 5000,
    cx: int = 10000,
) -> Dict[int, List[int]]:
    """{k: exp1 occurrence histogram (list of cx ints)} for every k in `ks`
    over pre-packed (codes, gids) device arrays (see occurrence.pack_members).

    Runs the plan from plan_sweep (master or per-class shared sorts,
    payload packed into spare key bits when possible); leftover ks fall
    back to the per-k fused path. Bit-identical to occurrence_histogram.
    """
    from .occurrence import occurrence_histogram_packed

    codes, gids = packed
    out: Dict[int, List[int]] = {}
    classes, remaining = plan_sweep(ks, n_members, MASK_MEMBERS_OCC)
    for kmax, KW, cks, pay_packed in classes:
        hists = np.asarray(
            _sweep_class_fn(
                jnp.asarray(codes),
                jnp.asarray(gids),
                cks,
                kmax,
                KW,
                n_members,
                cs,
                pay_packed,
            )
        )
        for i, k in enumerate(cks):
            h = [0] * cx
            h[: min(n_members, cx)] = hists[i][: min(n_members, cx)].tolist()
            out[k] = h
    for k in remaining:
        out[k] = occurrence_histogram_packed(packed, n_members, k, cs=cs, cx=cx)
    return out


def occurrence_histograms_sweep(
    member_codes: Sequence[np.ndarray],
    ks: Sequence[int],
    cs: int = 5000,
    cx: int = 10000,
) -> Dict[int, List[int]]:
    """Sweep API over raw member code arrays (packs + uploads once)."""
    from .occurrence import pack_members

    codes, gids = pack_members(member_codes)
    packed = (jax.device_put(codes), jax.device_put(gids))
    return occurrence_histograms_sweep_packed(
        packed, len(member_codes), ks, cs=cs, cx=cx
    )
