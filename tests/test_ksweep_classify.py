"""Shared-sort classification sweep (engine/ksweep_classify.py) vs oracle.

The exp2/3/4 pipelines ride these scans through the master doubled-text
sort; existing pipeline tests exercise odd ks only, so this file pins the
palindromic (even-k) strand-halving and the count-weighted exp4 buckets
on adversarial data: shared cores (runs spanning members), palindromes,
N runs, short records, and a pivot with repeated k-mers (saturation).
"""

import numpy as np
import pytest

from conftest import random_dna
from khoice_tpu import oracle
from khoice_tpu.engine.ksweep_classify import (
    containment_counts_sweep,
    feature_buckets_sweep,
    multi_pivot_counts_sweep,
    pivot_rest_counts_sweep,
)
from khoice_tpu.io.packing import encode_records

KS = (4, 6, 8, 11, 16, 21)  # even-heavy: palindromic classes exist


def _world(rng):
    core = random_dna(rng, 300)
    pal = "ACGT" * 12  # reverse-complement palindromic block
    pivot = [core[:150] + pal + random_dna(rng, 80), "ACGTNNACGTACGT" + core[40:120]]
    rest = []
    for i in range(4):
        seq = list(core)
        for _ in range(10 * (i + 1)):
            seq[rng.randrange(len(core))] = "ACGT"[rng.randrange(4)]
        rest.append(["".join(seq), pal + random_dna(rng, 30)])
    return pivot, rest


def test_pivot_rest_counts_vs_oracle(rng):
    pivot, rest = _world(rng)
    members = [encode_records(pivot)] + [encode_records(g) for g in rest]
    counts, rem = pivot_rest_counts_sweep(members, KS)
    assert not rem
    for k in KS:
        pset = oracle.set_counts(oracle.count_kmers(pivot, k), 1)
        rsets = [oracle.set_counts(oracle.count_kmers(g, k), 1) for g in rest]
        expect = np.zeros(len(rest) + 1, np.int64)
        for km in pset:
            occ = sum(1 for s in rsets if km in s)
            expect[occ] += 1
        np.testing.assert_array_equal(counts[k], expect, err_msg=f"k={k}")


def test_multi_pivot_counts_vs_oracle(rng):
    _, rest = _world(rng)
    D = 3
    pivots = [[random_dna(rng, 150) + rest[i][0][:100]] for i in range(D)]
    groups = [rest[i] for i in range(D)]
    members = [encode_records(p) for p in pivots] + [
        encode_records(g) for g in groups
    ]
    counts, rem = multi_pivot_counts_sweep(members, D, KS)
    assert not rem
    for k in KS:
        gsets = [oracle.set_counts(oracle.count_kmers(g, k), 1) for g in groups]
        for num in range(D):
            pset = oracle.set_counts(oracle.count_kmers(pivots[num], k), 1)
            expect = np.zeros(D, np.int64)
            for km in pset:
                occ = sum(1 for j in range(D) if j != num and km in gsets[j])
                expect[occ] += 1
            np.testing.assert_array_equal(
                counts[k][num], expect, err_msg=f"k={k} num={num}"
            )


def test_containment_counts_vs_oracle(rng):
    pivot, rest = _world(rng)
    queries = [pivot, [rest[0][0][:200], "NNNN" + random_dna(rng, 60)]]
    groups = [rest[0], rest[1]]
    members = [encode_records(q) for q in queries] + [
        encode_records(g) for g in groups
    ]
    counts, rem = containment_counts_sweep(members, len(queries), len(groups), KS)
    assert not rem
    for k in KS:
        gsets = [oracle.set_counts(oracle.count_kmers(g, k), 1) for g in groups]
        for qi, q in enumerate(queries):
            qset = oracle.set_counts(oracle.count_kmers(q, k), 1)
            assert counts[k][qi, 0] == len(qset), f"k={k} q={qi}"
            for gi in range(len(groups)):
                inter = sum(1 for km in qset if km in gsets[gi])
                assert counts[k][qi, 1 + gi] == inter, f"k={k} q={qi} g={gi}"


@pytest.mark.heavy
def test_feature_buckets_vs_oracle(rng):
    pivot, rest = _world(rng)
    # repeat a block so pivot multiplicities exceed 1 (and a tiny cap
    # exercises saturation exactly like KMC's 255 default would)
    pivot = [pivot[0], pivot[0][:60] * 3]
    D = 4
    members = [encode_records(pivot)] + [encode_records(g) for g in rest]
    cap = 5
    buckets, rem = feature_buckets_sweep(members, D, KS, cap=cap)
    assert not rem
    for k in KS:
        pcounts = oracle.count_kmers(pivot, k, cs=cap)
        gsets = [oracle.set_counts(oracle.count_kmers(g, k), 1) for g in rest]
        eb = np.zeros((D, D), np.int64)
        eu = 0
        for km, c in pcounts.items():
            m = [i for i in range(D) if km in gsets[i]]
            if not m:
                eu += c
            else:
                for d in m:
                    eb[d, len(m) - 1] += c
        got_b, got_u = buckets[k]
        np.testing.assert_array_equal(got_b, eb, err_msg=f"k={k}")
        assert got_u == eu, f"k={k}"


@pytest.mark.heavy
def test_group_mask_annotation_matches_merge(rng):
    """Global mask table == per-dataset tables + merge (exp6 fast path)."""
    from khoice_tpu.classify.annotate import (
        build_annotation,
        build_group_mask_annotation,
        read_votes,
    )
    from khoice_tpu.engine.session import KmerEngine
    from khoice_tpu.pipelines.exp6 import reads_matrix

    _, rest = _world(rng)
    eng = KmerEngine()
    reads = [random_dna(rng, 60) for _ in range(8)] + [rest[0][0][:60]]
    mat = reads_matrix(reads)
    for k in (6, 11, 16):
        group_codes = [encode_records(g) for g in rest]
        ann_new = build_group_mask_annotation(group_codes, k)
        pivot_table = eng.count_codes(encode_records(reads), k)
        group_sets = [
            eng.set_counts(eng.count_codes(encode_records(g), k), 1) for g in rest
        ]
        ann_old = build_annotation(pivot_table, group_sets)
        v_new, u_new, n_new = read_votes(ann_new, mat)
        v_old, u_old, n_old = read_votes(ann_old, mat)
        np.testing.assert_array_equal(v_new, v_old, err_msg=f"k={k}")
        np.testing.assert_array_equal(u_new, u_old)
        np.testing.assert_array_equal(n_new, n_old)


def _sets(groups, k):
    return [oracle.set_counts(oracle.count_kmers(g, k), 1) for g in groups]


def _bulk_world(rng):
    """_world bulked up to ~7 kb members: long sorted runs, the pivot's
    repeats exceeding a small cap."""
    pivot, rest = _world(rng)
    return pivot + [random_dna(rng, 5500), pivot[0][:60] * 5], rest


@pytest.mark.parametrize(
    "mode", ["pivot_rest", "multi_pivot", "containment", "buckets"]
)
@pytest.mark.heavy
def test_classify_scan_modes_vs_oracle(rng, mode):
    """Every classification mode of the multi-k scan, through its driver,
    equals the oracle at even and odd ks (palindromes, N runs, shared
    cores, saturation at a small cap)."""
    pivot, rest = _bulk_world(rng)
    ks = (6, 8, 11, 16, 21)
    if mode == "pivot_rest":
        members = [encode_records(pivot)] + [encode_records(g) for g in rest]
        got, rem = pivot_rest_counts_sweep(members, ks)
        for k in ks:
            rsets = _sets(rest, k)
            want = np.zeros(len(rest) + 1, np.int64)
            for km in _sets([pivot], k)[0]:
                want[sum(1 for r in rsets if km in r)] += 1
            np.testing.assert_array_equal(got[k], want, err_msg=f"k={k}")
    elif mode == "multi_pivot":
        D = 2
        pivots, groups = [pivot, rest[3]], rest[:D]
        members = [encode_records(p) for p in pivots] + [
            encode_records(g) for g in groups
        ]
        got, rem = multi_pivot_counts_sweep(members, D, ks)
        for k in ks:
            gsets = _sets(groups, k)
            for num, pset in enumerate(_sets(pivots, k)):
                want = np.zeros(D, np.int64)
                for km in pset:
                    want[sum(1 for j in range(D) if j != num and km in gsets[j])] += 1
                np.testing.assert_array_equal(got[k][num], want, err_msg=f"k={k}")
    elif mode == "containment":
        queries, groups = [pivot, rest[2]], rest[:2]
        members = [encode_records(q) for q in queries] + [
            encode_records(g) for g in groups
        ]
        got, rem = containment_counts_sweep(members, 2, 2, ks)
        for k in ks:
            gsets = _sets(groups, k)
            for qi, qset in enumerate(_sets(queries, k)):
                want = [len(qset)] + [sum(1 for km in qset if km in g) for g in gsets]
                assert got[k][qi].tolist() == want, f"k={k} q={qi}"
    else:
        D, cap = 4, 5
        members = [encode_records(pivot)] + [encode_records(g) for g in rest]
        got, rem = feature_buckets_sweep(members, D, ks, cap=cap)
        for k in ks:
            gsets = _sets(rest, k)
            want_b = np.zeros((D, D), np.int64)
            want_u = 0
            for km, c in oracle.count_kmers(pivot, k, cs=cap).items():
                m = [i for i in range(D) if km in gsets[i]]
                if not m:
                    want_u += c
                for d in m:
                    want_b[d, len(m) - 1] += c
            np.testing.assert_array_equal(got[k][0], want_b, err_msg=f"k={k}")
            assert got[k][1] == want_u, f"k={k}"
    assert rem == []


@pytest.mark.heavy
def test_read_votes_bulk_matches_lookup(rng):
    """Merge-join voting (read_votes_bulk) == binary-search voting over
    the global mask table, bit for bit — incl. reads with Ns, unmatched
    reads, and k spanning word widths."""
    from khoice_tpu.classify.annotate import (
        build_group_mask_annotation,
        read_votes,
        read_votes_bulk,
    )
    from khoice_tpu.pipelines.exp6 import reads_matrix

    _, rest = _world(rng)
    groups = [encode_records(g) for g in rest]
    reads = (
        [random_dna(rng, 60) for _ in range(6)]
        + [rest[0][0][:60], "ACGTNN" + random_dna(rng, 50)]
    )
    mat = reads_matrix(reads)
    for k in (7, 11, 16, 21, 33):
        ann = build_group_mask_annotation(groups, k)
        v1, u1, n1 = read_votes(ann, mat)
        v2, u2, n2 = read_votes_bulk(groups, mat, k, len(groups))
        np.testing.assert_array_equal(v2, v1, err_msg=f"k={k}")
        np.testing.assert_array_equal(u2, u1, err_msg=f"k={k}")
        np.testing.assert_array_equal(n2, n1, err_msg=f"k={k}")


@pytest.mark.heavy
def test_read_votes_bulk_multi_matches_per_pivot(rng):
    """ONE sort for ALL pivots' reads (read_votes_bulk_multi), both the
    static-k and dynamic-k (class-shared compile) kernels, == per-pivot
    read_votes_bulk bit for bit — with different read counts/lengths per
    pivot, Ns, and ks spanning 1/2/4-word key widths."""
    from khoice_tpu.classify.annotate import (
        concat_flat_reads,
        flat_reads_device,
        pack_group_texts,
        read_votes_bulk,
        read_votes_bulk_multi,
    )
    from khoice_tpu.pipelines.exp6 import reads_matrix

    _, rest = _world(rng)
    groups = [encode_records(g) for g in rest]
    d = len(groups)
    mats = [
        reads_matrix(
            [random_dna(rng, 40 + 10 * p) for _ in range(4 + p)]
            + [rest[p][0][:50], "NN" + random_dna(rng, 30)]
        )
        for p in range(d)
    ]
    cg = pack_group_texts(groups)
    big, spans = concat_flat_reads([flat_reads_device(m) for m in mats])
    for kmax, cks in ((15, (7, 11)), (31, (16, 21)), (63, (33,))):
        for i, k in enumerate(cks):
            want = [read_votes_bulk(cg, m, k, d) for m in mats]
            got_paths = [read_votes_bulk_multi(cg, big, spans, k, d, kmax=kmax)]
            if i == 0:  # static-k path once per width class
                got_paths.append(read_votes_bulk_multi(cg, big, spans, k, d))
            for got in got_paths:
                for (gv, gu, gn), (wv, wu, wn) in zip(got, want):
                    np.testing.assert_array_equal(gv, wv, err_msg=f"k={k}")
                    np.testing.assert_array_equal(gu, wu, err_msg=f"k={k}")
                    np.testing.assert_array_equal(gn, wn, err_msg=f"k={k}")
