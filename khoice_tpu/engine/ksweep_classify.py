"""Shared-sort k-sweep for the classification experiments (exp2/3/4).

engine/ksweep.py removes the per-k sort from exp1 by computing every k's
occurrence histogram from ONE doubled-text forward-prefix sort.  The
classification pipelines were still paying one sort per (k, dataset):
exp2 intersect/subtract histograms
(workflow/rules/exp_type_2.smk:354-380), exp3 containment percentages
(exp_type_3.smk:281-320) and exp4 feature buckets
(exp_type_4.smk:247-294 + src/merge_lists.py:134-149) each re-sorted the
group text per grid point.  All of those quantities are functions of the
SAME sorted run structure the sweep already builds:

- pack the pivot (genome, reads or read-sets) as member 0 and the
  comparison sets as further members — the segmented one-hot-gid OR scan
  then gives every run (= k-mer class on one strand) its full
  member-presence bitmask for every k at once;
- "subtract" classes are runs whose mask is exactly the pivot bit,
  "intersect -ocsum" histograms bin runs by popcount of the rest bits,
  containment numerators count runs carrying (query bit & group bit),
  and exp4's count-weighted buckets ride a segmented SUM of pivot
  elements next to the OR scan;
- the doubled-text strand duplication is handled exactly as in exp1:
  every stat is computed for all runs (d) and for palindromic runs (p),
  and the canonical value is (d + p) // 2.  Count-weighted stats halve a
  palindromic run's pivot multiplicity BEFORE saturation (a palindromic
  class's single run holds both strands' occurrences).

Each scan loops over the class's ks inside one program (_scan_ks), so
only one k's ~6 32-bit per-element temporaries are live at a time.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .ksweep import (
    _prefix_differs,
    _pal_mask,
    _payload_fields,
    _rev2comp_words,
    _seg_or_scan,
    _seg_sum_scan,
    plan_sweep,
)


def _per_k_runs(skeys, spayload, k, KW, packed, with_pivot_sum=False):
    """Per-element run quantities for one k over the shared sort.

    Returns (run_end, mask, pal, psum): run_end marks each run's last
    element, mask/psum are the run totals (valid AT run_end; psum counts
    the pivot's (member 0) elements), pal is the palindrome flag of the
    run's key prefix (always False at odd k)."""
    gid, nio = _payload_fields(skeys, spayload, packed)
    prev = tuple(jnp.roll(w, 1) for w in skeys)
    key_new = _prefix_differs(skeys, prev, k, KW).at[0].set(True)
    m = jnp.where(nio >= k, jnp.uint32(1) << gid, jnp.uint32(0))
    or_scan = _seg_or_scan(m, key_new)
    run_end = jnp.roll(key_new, -1).at[-1].set(True)
    pal = _pal_mask(skeys, _rev2comp_words(skeys), k, KW)
    psum = None
    if with_pivot_sum:
        pm = jnp.where((nio >= k) & (gid == 0), jnp.uint32(1), jnp.uint32(0))
        psum = _seg_sum_scan(pm, key_new)
    return run_end, or_scan, pal, psum


def _scan_ks(skeys, spay, ks, KW, packed, stats, raw, with_pivot_sum=False):
    """Run a classification stat over every k of `ks` (one loop iteration
    per k, so one compile serves the grid and one k's per-element
    temporaries are live at a time).

    stats(sel, mask, pal, psum) -> int32 array of one k's stat over the
    runs whose last element is in `sel`; it is taken for all runs (d) and
    for palindromic runs (p).  Returns the (2, len(ks), bins) stacked
    (d, p) stats flattened per k when raw, else the canonical
    (d + p) // 2 in stats' own shape, (len(ks), ...)."""

    def one_k(k):
        run_end, orv, pal, psum = _per_k_runs(
            skeys, spay, k, KW, packed, with_pivot_sum
        )
        return jnp.stack([stats(run_end, orv, pal, psum),
                          stats(run_end & pal, orv, pal, psum)])

    dp = jax.lax.map(one_k, jnp.asarray(ks, jnp.int32))  # (n_ks, 2, ...)
    if raw:
        return jnp.moveaxis(dp, 1, 0).reshape(2, len(ks), -1)
    return (dp[:, 0] + dp[:, 1]) // 2


@partial(jax.jit, static_argnums=(2, 3, 4))
def _sorted_doubled_fn(codes, gids, kmax, KW, packed):
    from .ksweep import _sweep_doubled

    return _sweep_doubled(codes, gids, kmax, KW, packed)


def _bin_counts(sel, occ, n_bins):
    """[#elements of sel with occ == j for j in 0..n_bins-1] (int32)."""
    return jnp.stack(
        [jnp.sum((sel & (occ == j)).astype(jnp.int32)) for j in range(n_bins)]
    )


# --------------------------------------------------------------------------
# exp2 within: pivot (bit 0) vs rest members (bits 1..n_rest)
# --------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7, 8))
def _sweep_class_pivot_rest(skeys, spay, ks, kmax, KW, n_rest, cs, packed,
                            raw=False):
    """(len(ks), n_rest+1) int32: [ki, j] = #canonical classes present in
    the pivot (member 0) and in exactly j of the rest members (1..n_rest).

    j = 0 -> `kmers_subtract` classes (all count 1); j >= 1 -> the
    `intersect -ocsum` class count at intersection count 1 + j
    (reference exp_type_2.smk:354-380 semantics).

    raw=True returns the (2, len(ks), n_rest+1) stacked (doubled,
    palindromic) counts WITHOUT the (d+p)//2 combine — the sharded sweep
    psums across shards first (a class's two strand runs can land in
    different shards; dist/ksweep_classify.py)."""
    rest_mask = jnp.uint32(((1 << (n_rest + 1)) - 1) & ~1)

    def stats(sel, orv, pal, psum):
        occ = jax.lax.population_count(orv & rest_mask)
        return _bin_counts(sel & ((orv & 1) == 1), occ, n_rest + 1)

    return _scan_ks(skeys, spay, ks, KW, packed, stats, raw)


# --------------------------------------------------------------------------
# exp2 across: pivots (bits 0..D-1) vs group sets (bits D..2D-1)
# --------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7, 8))
def _sweep_class_multi_pivot(skeys, spay, ks, kmax, KW, D, cs, packed,
                             raw=False):
    """(len(ks), D, D) int32: [ki, num, j] = #canonical classes present in
    pivot `num` and in exactly j of the OTHER datasets' group sets
    (pivot num's own group excluded, exp_type_2.smk:263-283).

    raw=True returns (2, len(ks), D*D) stacked (doubled, palindromic)
    counts, flattened, without the (d+p)//2 combine (sharded sweep)."""

    def stats(sel, orv, pal, psum):
        rows = []
        for num in range(D):
            others = jnp.uint32(((1 << D) - 1) & ~(1 << num)) << D
            occ = jax.lax.population_count(orv & others)
            rows.append(_bin_counts(sel & (((orv >> num) & 1) == 1), occ, D))
        return jnp.stack(rows)

    return _scan_ks(skeys, spay, ks, KW, packed, stats, raw)


# --------------------------------------------------------------------------
# exp3: query read-sets (bits 0..nq-1) vs group unions (bits nq..nq+ng-1)
# --------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7, 8, 9))
def _sweep_class_containment(skeys, spay, ks, kmax, KW, nq, ng, cs, packed,
                             raw=False):
    """(len(ks), nq, ng+1) int32: [ki, q, 0] = #canonical classes in query
    set q (the |distinct(reads)| denominator); [ki, q, 1+g] = #classes in
    query q AND group g (the intersection numerator)
    (reference exp_type_3.smk:281-320).

    raw=True returns (2, len(ks), nq*(ng+1)) stacked (doubled,
    palindromic) counts, flattened, without the combine (sharded sweep)."""

    def stats(sel, orv, pal, psum):
        rows = []
        for q in range(nq):
            inq = sel & (((orv >> q) & 1) == 1)
            cells = [jnp.sum(inq.astype(jnp.int32))]
            for g in range(ng):
                both = inq & (((orv >> (nq + g)) & 1) == 1)
                cells.append(jnp.sum(both.astype(jnp.int32)))
            rows.append(jnp.stack(cells))
        return jnp.stack(rows)

    return _scan_ks(skeys, spay, ks, KW, packed, stats, raw)


# --------------------------------------------------------------------------
# exp4: pivot (bit 0, count-weighted) vs group sets (bits 1..D)
# --------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7, 8, 9))
def _sweep_class_feature_buckets(skeys, spay, ks, kmax, KW, D, cs, cap, packed,
                                 raw=False):
    """exp4 feature buckets for every k of a class in one sort.

    Returns (buckets (len(ks), D, D) int32, unique (len(ks),) int32):
    buckets[ki, d, m-1] = total saturated pivot count of canonical classes
    contained in dataset d's group with |matches| = m; unique[ki] = total
    saturated pivot count of classes matching no dataset — exactly
    classify/annotate.feature_buckets over the per-k annotation
    (src/merge_lists.py:134-149 semantics, counter saturation at `cap` =
    KMC's 255 default).  A palindromic run carries both strands'
    occurrences, so its multiplicity is halved BEFORE saturation.

    raw=True returns ONE (2, len(ks), D*D+1) array — buckets flattened,
    unique appended — of (doubled, palindromic) sums without the combine
    (per-run saturation/pal-halving stay exact under sharding because a
    run never tears across shards; dist/ksweep_classify.py)."""

    def stats(sel, orv, pal, psum):
        present = sel & ((orv & 1) == 1)
        c = jnp.where(pal, psum >> 1, psum)
        c = jnp.minimum(c, jnp.uint32(cap)).astype(jnp.int32)
        gmask = orv >> 1  # dataset bits
        nmatch = jax.lax.population_count(gmask & jnp.uint32((1 << D) - 1))
        cells = []
        for dd in range(D):
            in_d = ((gmask >> dd) & 1) == 1
            for m in range(1, D + 1):
                s = present & in_d & (nmatch == m)
                cells.append(jnp.sum(jnp.where(s, c, 0)))
        cells.append(jnp.sum(jnp.where(present & (nmatch == 0), c, 0)))
        return jnp.stack(cells)

    flat = _scan_ks(skeys, spay, ks, KW, packed, stats, raw,
                    with_pivot_sum=True)
    if raw:
        return flat
    return flat[:, : D * D].reshape(len(ks), D, D), flat[:, D * D]


def classify_scan_raw(skeys, spay, ks, kmax, KW, cs, packed, mode, mode_params):
    """RAW (2, len(ks), bins) classify-scan dispatch for the sharded sweep
    (dist/ksweep_classify.py): doubled + palindromic stats stacked, so the
    cross-shard psum can run BEFORE the (d+p)//2 canonical combine."""
    ks = tuple(int(k) for k in ks)
    if mode == "pivot_rest":
        return _sweep_class_pivot_rest(
            skeys, spay, ks, kmax, KW, mode_params, cs, packed, True
        )
    if mode == "multi_pivot":
        return _sweep_class_multi_pivot(
            skeys, spay, ks, kmax, KW, mode_params, cs, packed, True
        )
    if mode == "containment":
        nq, ng = mode_params
        return _sweep_class_containment(
            skeys, spay, ks, kmax, KW, nq, ng, cs, packed, True
        )
    if mode == "buckets":
        D, cap = mode_params
        return _sweep_class_feature_buckets(
            skeys, spay, ks, kmax, KW, D, cs, cap, packed, True
        )
    raise ValueError(f"unknown classify mode {mode!r}")


def classify_mode_bins(mode: str, mode_params) -> int:
    """Flattened per-k bin count of classify_scan_raw's output."""
    if mode == "pivot_rest":
        return mode_params + 1
    if mode == "multi_pivot":
        return mode_params * mode_params
    if mode == "containment":
        nq, ng = mode_params
        return nq * (ng + 1)
    if mode == "buckets":
        D, _cap = mode_params
        return D * D + 1
    raise ValueError(f"unknown classify mode {mode!r}")


# --------------------------------------------------------------------------
# host-side drivers: plan classes, run, fall back per k
# --------------------------------------------------------------------------


def _scan_too_big(n2: int, device, budget_fraction: float = 0.35) -> bool:
    """True when the classify scan's ~6 u32 temporaries per element would
    overrun `device`'s memory next to the live sorted arrays.  A device
    that reports no memory limit (the CPU) never refuses."""
    limit = (device.memory_stats() or {}).get("bytes_limit", 0)
    return bool(limit) and n2 * 6 * 4 > limit * budget_fraction


def _run_classes(member_codes: Sequence[np.ndarray], ks: Sequence[int],
                 class_fn) -> Tuple[Dict[int, object], List[int]]:
    """Shared driver: pack members once, sort ONCE per planned class
    (the sorted arrays stay on device), then run
    `class_fn(skeys, spay, cks, kmax, KW, packed)` -> [per-k host stats]
    over the class's ks.  Returns ({k: host stats}, leftover ks for the
    per-k fallback)."""
    from .occurrence import pack_members

    classes, remaining = plan_sweep(ks, len(member_codes))
    out: Dict[int, object] = {}
    if not classes:
        return out, remaining
    codes, gids = pack_members(member_codes)
    cj, gj = jnp.asarray(codes), jnp.asarray(gids)
    n2 = 2 * int(codes.shape[0])
    if _scan_too_big(n2, next(iter(cj.devices()))):
        from ..utils.logging import get_logger

        get_logger("khoice.ksweep_classify").warning(
            "classify sweep: %dM doubled elements exceed the scan's "
            "device-memory envelope; using the per-k path", n2 // 1_000_000,
        )
        return {}, sorted(set(int(k) for k in ks))
    for kmax, KW, cks, packed in classes:
        skeys, spay = _sorted_doubled_fn(cj, gj, kmax, KW, packed)
        out.update(zip(cks, class_fn(skeys, spay, cks, kmax, KW, packed)))
    return out, remaining


def pivot_rest_counts_sweep(
    member_codes: Sequence[np.ndarray], ks: Sequence[int], cs: int = 5000
) -> Tuple[Dict[int, np.ndarray], List[int]]:
    """{k: (n_rest+1,) counts} for member 0 = pivot vs the rest members."""
    n_rest = len(member_codes) - 1
    # The sweep's intersection counts are exact (uncapped): with <= 32
    # members every count is <= n_members, so KMC's `-cs` union cap is
    # unreachable as long as cs >= n_members.  Assert rather than
    # silently diverging from the per-k fallback's capped semantics.
    assert cs >= len(member_codes), "sweep ignores cs below the member count"
    return _run_classes(
        member_codes,
        ks,
        lambda sk, sp, cks, kmax, KW, packed: list(np.asarray(
            _sweep_class_pivot_rest(sk, sp, cks, kmax, KW, n_rest, cs, packed)
        )),
    )


def multi_pivot_counts_sweep(
    member_codes: Sequence[np.ndarray], D: int, ks: Sequence[int], cs: int = 5000
) -> Tuple[Dict[int, np.ndarray], List[int]]:
    """{k: (D, D) counts}: members 0..D-1 pivots, D..2D-1 group sets."""
    assert cs >= len(member_codes), "sweep ignores cs below the member count"
    return _run_classes(
        member_codes,
        ks,
        lambda sk, sp, cks, kmax, KW, packed: list(np.asarray(
            _sweep_class_multi_pivot(sk, sp, cks, kmax, KW, D, cs, packed)
        )),
    )


def containment_counts_sweep(
    member_codes: Sequence[np.ndarray], nq: int, ng: int, ks: Sequence[int],
    cs: int = 5000
) -> Tuple[Dict[int, np.ndarray], List[int]]:
    """{k: (nq, ng+1) counts}: members 0..nq-1 query sets, then ng groups."""
    assert cs >= len(member_codes), "sweep ignores cs below the member count"
    return _run_classes(
        member_codes,
        ks,
        lambda sk, sp, cks, kmax, KW, packed: list(np.asarray(
            _sweep_class_containment(sk, sp, cks, kmax, KW, nq, ng, cs, packed)
        )),
    )


def feature_buckets_sweep(
    member_codes: Sequence[np.ndarray], D: int, ks: Sequence[int],
    cap: int = 255, cs: int = 5000
) -> Tuple[Dict[int, tuple], List[int]]:
    """{k: (buckets (D, D) int64, unique int)}: member 0 pivot, 1..D groups."""
    assert cs >= len(member_codes), "sweep ignores cs below the member count"

    def class_fn(sk, sp, cks, kmax, KW, packed):
        b, u = _sweep_class_feature_buckets(sk, sp, cks, kmax, KW, D, cs, cap, packed)
        b, u = np.asarray(b), np.asarray(u)
        return [(b[i].astype(np.int64), int(u[i])) for i in range(len(cks))]

    return _run_classes(member_codes, ks, class_fn)
