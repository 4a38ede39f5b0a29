"""Gid-packed fused occurrence path vs unpacked path and oracle.

The packed path folds the genome id into the key's low GID_BITS before the
single fused sort (engine/occurrence.py), cutting sort operands by one word
for most of the reference k grid (workflow/Snakefile:36). These tests pin
bit-exactness against the composed-table path and the oracle across every
packed word-width class, including class-boundary ks.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from conftest import random_dna
from khoice_tpu import oracle
from khoice_tpu.engine.occurrence import (
    GID_BITS,
    _occurrence_histogram_dyn_packed,
    occurrence_histogram,
)
from khoice_tpu.io import encode_records


def make_members(rng, n_members=4, length=400, muts=40):
    base = random_dna(rng, length)
    members = []
    for i in range(n_members):
        seq = list(base)
        for _ in range(muts * (i + 1)):
            seq[rng.randrange(length)] = "ACGT"[rng.randrange(4)]
        members.append("".join(seq))
    return members


# class boundaries: 12|13, 28|29, 44|45, plus mid-class and the grid edges
@pytest.mark.parametrize("k", [7, 12, 13, 21, 28, 29, 31, 35, 44, 45, 49])
def test_packed_matches_static_and_oracle(rng, k):
    members = make_members(rng, n_members=4, length=500)
    codes = [encode_records([m], pad_to=512) for m in members]

    packed = occurrence_histogram(codes, k, cs=5000, cx=32, dynamic_k=True)
    static = occurrence_histogram(codes, k, cs=5000, cx=32, dynamic_k=False)
    assert packed == static

    od = oracle.union_sum(
        [oracle.set_counts(oracle.count_kmers([m], k), 1) for m in members],
        cs=5000,
    )
    assert packed == oracle.histogram(od, cx=32)


def test_packed_with_n_bases(rng):
    members = [random_dna(rng, 600, n_prob=0.05) for _ in range(3)]
    codes = [encode_records([m], pad_to=1024) for m in members]
    k = 17
    packed = occurrence_histogram(codes, k, cs=5000, cx=16, dynamic_k=True)
    od = oracle.union_sum(
        [oracle.set_counts(oracle.count_kmers([m], k), 1) for m in members],
        cs=5000,
    )
    assert packed == oracle.histogram(od, cx=16)


def test_packed_one_compile_per_class(rng):
    members = [random_dna(rng, 400) for _ in range(2)]
    codes = [encode_records([m], pad_to=512) for m in members]
    base = _occurrence_histogram_dyn_packed._cache_size()
    for k in (13, 15, 20, 27, 28):  # all in packed class 28
        occurrence_histogram(codes, k, cs=5000, cx=16, dynamic_k=True)
    assert _occurrence_histogram_dyn_packed._cache_size() == base + 1
    for k in (7, 9, 12):  # packed class 12
        occurrence_histogram(codes, k, cs=5000, cx=16, dynamic_k=True)
    assert _occurrence_histogram_dyn_packed._cache_size() == base + 2


def test_many_members_fall_back_unpacked(rng):
    """> 2^GID_BITS members must still be exact (fallback path)."""
    assert GID_BITS == 8  # contract with the packed-word layout
    k = 11
    members = [random_dna(rng, 60) for _ in range(300)]
    codes = [encode_records([m], pad_to=64) for m in members]
    got = occurrence_histogram(codes, k, cs=5000, cx=320, dynamic_k=True)
    od = oracle.union_sum(
        [oracle.set_counts(oracle.count_kmers([m], k), 1) for m in members],
        cs=5000,
    )
    assert got == oracle.histogram(od, cx=320)


@pytest.mark.parametrize("k", [9, 13, 27, 30, 31, 35, 47])
def test_occurrence_table_packed_matches_composed_ops(rng, k):
    """Packed-sort occurrence_table == set_counts(1) + union_many, including
    key recovery (unpack_keys_static) preserving the KmerTable invariant."""
    from khoice_tpu.engine import ops
    from khoice_tpu.engine.occurrence import occurrence_table

    members = make_members(rng, n_members=3, length=300)
    codes = [np.asarray(encode_records([m], pad_to=512)) for m in members]

    t = occurrence_table(codes, k, cs=5000)
    composed = ops.union_many(
        [ops.set_counts(ops.count_codes(jnp.asarray(c), k), 1) for c in codes],
        cs=5000,
    )
    # same (key, count) multiset of present entries and same histogram
    got = t.dump()
    want = composed.dump()
    assert got == want
    assert np.asarray(ops.histogram(t, cx=8)).tolist() == \
        np.asarray(ops.histogram(composed, cx=8)).tolist()
    # invariant: sorted ascending with sentinels last
    kw = np.stack([np.asarray(w, dtype=np.uint64) for w in t.keys])
    flat = kw[0].astype(object)
    for wi in range(1, kw.shape[0]):
        flat = flat * (1 << 32) + kw[wi].astype(object)
    assert all(flat[i] <= flat[i + 1] for i in range(len(flat) - 1))


def test_pack_members_device_matches_host(rng):
    """pack_members_device (2-bit transfer + on-device gid/separator
    reconstruction) must equal pack_members on every valid position and
    yield bit-identical occurrence histograms."""
    import numpy as np
    from khoice_tpu.engine.occurrence import (
        occurrence_histogram_packed,
        pack_members,
        pack_members_device,
    )
    from khoice_tpu.io import encode_records
    from conftest import random_dna

    members = [
        encode_records([random_dna(rng, ln) + "N" + random_dna(rng, 40)])
        for ln in (300, 150, 977)
    ]
    hc, hg = pack_members(members)
    dc, dg = (np.asarray(x) for x in pack_members_device(members))
    assert dc.shape == hc.shape
    valid = hc < 4
    assert np.array_equal(dc[valid], hc[valid])
    assert np.array_equal(dc >= 4, hc >= 4)  # separators/tail line up
    assert np.array_equal(dg[valid], hg[valid])

    import jax
    h1 = occurrence_histogram_packed(
        (jax.device_put(hc), jax.device_put(hg)), len(members), 13
    )
    h2 = occurrence_histogram_packed(pack_members_device(members), len(members), 13)
    assert h1 == h2
