"""Shared-sort k-sweep (engine/ksweep.py) vs the per-k fused path + oracle."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from conftest import random_dna
from khoice_tpu import oracle
from khoice_tpu.engine.ksweep import (
    occurrence_histograms_sweep,
    sweep_classes,
)
from khoice_tpu.engine.occurrence import occurrence_histogram, pack_members
from khoice_tpu.io import encode_records


def _member_codes(members):
    return [encode_records([m] if isinstance(m, str) else m) for m in members]


def _check_vs_fused(members, ks, cx=64):
    codes = _member_codes(members)
    got = occurrence_histograms_sweep(codes, ks, cx=cx)
    for k in ks:
        want = occurrence_histogram(codes, k, cx=cx)
        assert got[k] == want, f"k={k}: {got[k][:12]} != {want[:12]}"


def test_sweep_classes_partition():
    grid = list(range(7, 31)) + [34, 37, 40, 43, 46, 49]
    cls = sweep_classes(grid)
    assert [c[:2] for c in cls] == [(30, 2), (46, 3), (49, 4)]
    assert sorted(k for c in cls for k in c[2]) == sorted(grid)
    # one-word ks merge into the two-word class
    assert sweep_classes([7, 9, 20])[0][:2] == (20, 2)
    assert sweep_classes([7, 9])[0][:2] == (9, 1)


def test_plan_sweep_master_for_reference_grid():
    from khoice_tpu.engine.ksweep import plan_sweep

    grid = list(range(7, 31)) + [34, 37, 40, 43, 46, 49]
    classes, remaining = plan_sweep(grid, 8)
    # one 4-operand packed master sort serves the whole grid (8 sorted
    # words/position vs 18 for split classes + per-k k=49 fallback)
    assert remaining == []
    assert len(classes) == 1
    kmax, KW, cks, packed = classes[0]
    assert (kmax, KW, packed) is not None
    assert kmax == 49 and KW == 4 and packed is True
    assert sorted(cks) == sorted(grid)
    # small grids keep the cheaper narrow class
    classes, remaining = plan_sweep([7, 9, 12, 20, 30], 8)
    assert len(classes) == 1 and classes[0][1] == 2
    # classify callers (default mask_limit=32) fall back above 32 members;
    # exp1's occurrence consumers scan two mask channels and sweep to 64
    from khoice_tpu.engine.ksweep import MASK_MEMBERS_OCC

    assert plan_sweep(grid, 33) == ([], sorted(set(grid)))
    classes, remaining = plan_sweep(grid, 48, MASK_MEMBERS_OCC)
    assert remaining == [] and len(classes) == 1
    classes, remaining = plan_sweep(grid, 64, MASK_MEMBERS_OCC)
    assert remaining == [] and len(classes) == 1
    assert plan_sweep(grid, 65, MASK_MEMBERS_OCC) == ([], sorted(set(grid)))


@pytest.mark.heavy
def test_sweep_master_class_matches_fused(rng):
    """ks spanning every key-word class through ONE packed master sort."""
    base = random_dna(rng, 1200)
    members = []
    for i in range(6):
        seq = list(base)
        for _ in range(60 * (i + 1)):
            seq[rng.randrange(len(base))] = "ACGT"[rng.randrange(4)]
        members.append("".join(seq) + ("N" + random_dna(rng, 50) if i % 2 else ""))
    ks = [7, 12, 21, 31, 33, 45, 49]
    from khoice_tpu.engine.ksweep import plan_sweep

    classes, remaining = plan_sweep(ks, len(members))
    assert remaining == [] and len(classes) == 1 and classes[0][3] is True
    _check_vs_fused(members, ks)


@pytest.mark.heavy
def test_sweep_packed_payload_even_k_palindromes(rng):
    """Packed payload must not leak into palindrome detection (the payload
    lands in rev's top bits, above the 2k window) — even ks stress it."""
    pal = "ACGCGT" * 60
    members = [pal + random_dna(rng, 400), "A" * 300 + pal, random_dna(rng, 500)]
    ks = [8, 10, 14, 22, 34, 40, 46, 48]  # kmax=48 -> KW=3, spare=0: unpacked master
    from khoice_tpu.engine.ksweep import plan_sweep

    classes, _ = plan_sweep(ks, len(members))
    assert classes and not any(c[3] for c in classes)
    _check_vs_fused(members, ks)

    ks = [8, 10, 14, 22, 34, 40, 46, 49]  # kmax=49 -> KW=4, spare=30: packed
    from khoice_tpu.engine.ksweep import plan_sweep

    classes, _ = plan_sweep(ks, len(members))
    assert any(c[3] for c in classes), "expected a packed class"
    _check_vs_fused(members, ks)


@pytest.mark.heavy
def test_sweep_wide_members_matches_fused(rng):
    """48- and 64-member groups ride the shared sort bit-exactly (the
    former 32-member cliff): the scan runs two
    uint32 mask channels and the packed gid field is 6 bits wide."""
    base = random_dna(rng, 220)
    for n in (33, 48, 64):
        members = []
        for i in range(n):
            seq = list(base)
            for _ in range(5 + i % 11):
                seq[rng.randrange(len(base))] = "ACGT"[rng.randrange(4)]
            members.append("".join(seq) + random_dna(rng, 30 + i % 17))
        ks = [7, 12, 16, 21, 33]
        codes = _member_codes(members)
        from khoice_tpu.engine.ksweep import MASK_MEMBERS_OCC, plan_sweep

        classes, remaining = plan_sweep(ks, n, MASK_MEMBERS_OCC)
        assert remaining == [] and classes, f"n={n} must sweep"
        got = occurrence_histograms_sweep(codes, ks, cx=80)
        for k in ks:
            want = occurrence_histogram(codes, k, cx=80)
            assert got[k] == want, f"n={n} k={k}"


@pytest.mark.heavy
def test_sweep_matches_fused_random(rng):
    base = random_dna(rng, 3000)
    members = []
    for i in range(5):
        seq = list(base)
        for _ in range(100 * (i + 1)):
            seq[rng.randrange(len(base))] = "ACGT"[rng.randrange(4)]
        members.append("".join(seq))
    _check_vs_fused(members, [7, 8, 11, 15, 16, 17, 24, 25, 30])


def test_sweep_matches_fused_three_words(rng):
    members = [random_dna(rng, 800) for _ in range(4)]
    _check_vs_fused(members, [33, 40, 46])


def test_sweep_with_ns_and_short_contigs(rng):
    # records shorter than 2*kmax, N runs, and contigs shorter than k
    m1 = [random_dna(rng, 37), "ACGTN" + random_dna(rng, 60), random_dna(rng, 9)]
    m2 = [random_dna(rng, 200).replace("A", "N"), random_dna(rng, 33)]
    m3 = [random_dna(rng, 18)]
    _check_vs_fused([m1, m2, m3], [7, 10, 13, 19, 25])


def test_sweep_palindromes_and_polyA(rng):
    # palindromic k-mers at even k; poly-A runs collide with zero padding
    pal = "ACGCGT" * 40  # contains 6-palindromes
    members = ["A" * 500 + random_dna(rng, 300), pal + "A" * 64, random_dna(rng, 400)]
    _check_vs_fused(members, [6, 7, 8, 10, 12, 14, 20])


@pytest.mark.heavy
def test_sweep_mask_widths(rng):
    # 9 and 17 members exercise the 16- and 32-bit mask subfields
    base = random_dna(rng, 600)
    for g in (9, 17):
        members = []
        for i in range(g):
            seq = list(base)
            for _ in range(40):
                seq[rng.randrange(len(base))] = "ACGT"[rng.randrange(4)]
            members.append("".join(seq))
        _check_vs_fused(members, [9, 13, 17, 21])


def test_sweep_single_member_and_duplicates(rng):
    seq = random_dna(rng, 900)
    _check_vs_fused([seq], [7, 11, 15])
    _check_vs_fused([seq, seq, seq], [7, 11, 15])


def test_sweep_vs_oracle_direct(rng):
    members = [random_dna(rng, 500) for _ in range(3)]
    codes = _member_codes(members)
    got = occurrence_histograms_sweep(codes, [11, 12, 20], cx=8)
    for k in [11, 12, 20]:
        od = oracle.union_sum(
            [oracle.set_counts(oracle.count_kmers([m], k), 1) for m in members],
            cs=5000,
        )
        assert got[k] == oracle.histogram(od, cx=8)


@pytest.mark.heavy
def test_sweep_fallback_large_groups(rng):
    # >32 members falls back to the per-k path but must stay correct
    members = [random_dna(rng, 120) for _ in range(34)]
    _check_vs_fused(members, [9, 11, 13])


def _sorted_doubled(codes, gids, kmax, KW, packed):
    """The sweep's sorted doubled-text elements, built step by step (not
    through _sweep_doubled) so the scan is checked on its own."""
    from khoice_tpu.engine.ksweep import _extract_fwd_sweep

    cj = jnp.asarray(codes)
    rc = jnp.where(cj < 4, cj ^ 3, cj)[::-1]
    gj = jnp.asarray(gids)
    fwd, pay = _extract_fwd_sweep(
        jnp.concatenate([cj, rc]), jnp.concatenate([gj, gj[::-1]]),
        kmax, KW, packed=packed,
    )
    if packed:
        assert pay is None
        return tuple(jax.lax.sort(list(fwd), num_keys=KW, is_stable=False)), None
    ops = jax.lax.sort(list(fwd) + [pay], num_keys=KW, is_stable=False)
    return tuple(ops[:KW]), ops[KW]


@pytest.mark.heavy
def test_sweep_scan_packed_matches_fused(rng):
    """Packed-payload master class: the multi-k scan over the sorted
    doubled text equals the per-k fused path at every k."""
    from khoice_tpu.engine.ksweep import _scan_multi_k, can_pack_payload

    g = 5
    ks = (8, 21, 34, 40, 49)
    kmax, KW = 49, 4
    assert can_pack_payload(kmax, KW)
    base = random_dna(rng, 1500)
    members = []
    for i in range(g):
        seq = list(base)
        for _ in range(80):
            seq[rng.randrange(len(base))] = "ACGT"[rng.randrange(4)]
        members.append("".join(seq) + ("N" + random_dna(rng, 30) if i % 2 else ""))
    codes, gids = pack_members(_member_codes(members))
    skeys, _ = _sorted_doubled(codes, gids, kmax, KW, True)
    got = np.asarray(_scan_multi_k(skeys, None, ks, kmax, KW, g, 5000, packed=True))
    for i, k in enumerate(ks):
        fused = occurrence_histogram(_member_codes(members), k, cx=g)
        assert got[i].tolist() == fused, f"k={k}"


@pytest.mark.parametrize(
    "g,kset,member_len",
    [
        (5, (7, 9, 12, 16), 2000),
        (12, (13, 14, 25), 2000),
        # long members with poly-A blocks: single-key runs tens of
        # thousands of elements long
        (4, (7, 8, 15), 15000),
    ],
)
@pytest.mark.heavy
def test_sweep_scan_matches_fused(rng, g, kset, member_len):
    """The multi-k scan (separate payload word) equals the per-k fused
    path, raw (doubled, palindromic) halves included."""
    from khoice_tpu.engine.ksweep import _scan_multi_k, sweep_classes

    base = random_dna(rng, member_len)
    members = []
    for i in range(g):
        seq = list(base)
        for _ in range(60):
            seq[rng.randrange(len(base))] = "ACGT"[rng.randrange(4)]
        extra = "A" * 4000 if member_len > 4000 else ""
        members.append("".join(seq) + extra + ("" if i % 2 else "N" + random_dna(rng, 40)))
    codes, gids = pack_members(_member_codes(members))
    (kmax, KW, ks) = sweep_classes(kset)[0]
    assert set(ks) == set(kset)
    skeys, spay = _sorted_doubled(codes, gids, kmax, KW, False)

    got = np.asarray(_scan_multi_k(skeys, spay, ks, kmax, KW, g, 5000))
    raw = np.asarray(_scan_multi_k(skeys, spay, ks, kmax, KW, g, 5000, raw=True))
    assert raw.shape == (2, len(ks), g)
    assert ((raw[0] + raw[1]) // 2).tolist() == got.tolist()
    for i, k in enumerate(ks):
        if k % 2:
            assert not raw[1, i].any(), f"odd k={k} has palindromic runs"
        fused = occurrence_histogram(_member_codes(members), k, cx=g)
        assert got[i].tolist() == fused, f"k={k}"
