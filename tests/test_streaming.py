"""Bounded-memory streaming sweep (engine/streaming.py) vs in-core path.

Forces multiple chunks AND multiple key-range groups at CPU-testable
sizes; the streamed histograms must be bit-identical to
occurrence_histograms_sweep on adversarial content (shared cores across
members, N runs, poly-A skew, palindromic blocks, short records).
"""

import numpy as np
import pytest

from conftest import random_dna
from khoice_tpu.engine.ksweep import occurrence_histograms_sweep
from khoice_tpu.engine.streaming import occurrence_histograms_sweep_streaming
from khoice_tpu.io.packing import encode_records

KS = [7, 11, 16, 21, 27, 31, 34]


def _members(rng):
    core = random_dna(rng, 2500)
    pal = "ACGT" * 40
    out = []
    for i in range(5):
        seq = list(core)
        for _ in range(60 * (i + 1)):
            seq[rng.randrange(len(core))] = "ACGT"[rng.randrange(4)]
        recs = [
            "".join(seq),
            pal + random_dna(rng, 200),
            "A" * 300 + random_dna(rng, 150) + "N" * 40 + random_dna(rng, 100),
        ]
        out.append(encode_records(recs))
    return out


def test_streaming_matches_incore(rng):
    members = _members(rng)
    want = occurrence_histograms_sweep(members, KS, cx=8)
    got = occurrence_histograms_sweep_streaming(
        members, KS, cx=8,
        chunk_elems=16384, n_groups=5, pass_groups=2,
    )
    for k in KS:
        assert got[k] == want[k], f"k={k}"


@pytest.mark.heavy
def test_streaming_single_group_degenerate(rng):
    members = _members(rng)[:2]
    want = occurrence_histograms_sweep(members, KS, cx=8)
    got = occurrence_histograms_sweep_streaming(
        members, KS, cx=8, chunk_elems=16384, n_groups=1,
    )
    for k in KS:
        assert got[k] == want[k], f"k={k}"


def test_streaming_overflow_retry(rng):
    """Poly-A skew concentrates keys in group 0 — the cap-doubling retry
    must converge and stay exact."""
    members = [
        encode_records(["A" * 4000 + random_dna(rng, 800)]),
        encode_records(["A" * 3500 + random_dna(rng, 900)]),
        encode_records([random_dna(rng, 4000)]),
    ]
    ks = [9, 13, 21]
    want = occurrence_histograms_sweep(members, ks, cx=8)
    got = occurrence_histograms_sweep_streaming(
        members, ks, cx=8, chunk_elems=16384, n_groups=4, pass_groups=4,
    )
    for k in ks:
        assert got[k] == want[k], f"k={k}"


def test_streaming_overflow_retry_is_contained(rng, monkeypatch):
    """Only overflowed key-range groups are retried: finished groups keep
    their scans (scanned exactly once) and every retry batch carries
    fewer groups than the full partition."""
    from khoice_tpu.engine import streaming as st

    members = [
        encode_records(["A" * 4000 + random_dna(rng, 800)]),
        encode_records(["A" * 3500 + random_dna(rng, 900)]),
        encode_records([random_dna(rng, 4000)]),
    ]
    ks = [9, 13, 21]
    G = 4

    batch_sizes = []  # r_here of every _chunk_step call
    scans = 0
    real_chunk, real_scan = st._chunk_step, st._group_scan

    def chunk_spy(*args):
        batch_sizes.append(args[10])  # R (static batch width)
        return real_chunk(*args)

    def scan_spy(*args):
        nonlocal scans
        scans += 1
        return real_scan(*args)

    monkeypatch.setattr(st, "_chunk_step", chunk_spy)
    monkeypatch.setattr(st, "_group_scan", scan_spy)

    want = occurrence_histograms_sweep(members, ks, cx=8)
    got = st.occurrence_histograms_sweep_streaming(
        members, ks, cx=8, chunk_elems=16384, n_groups=G, pass_groups=G,
    )
    for k in ks:
        assert got[k] == want[k], f"k={k}"
    # the poly-A skew must actually trigger a retry round...
    assert len(set(batch_sizes)) > 1, "expected an overflow retry round"
    # ...and retry rounds carry strictly fewer groups than the partition
    assert all(b < G for b in batch_sizes if b != G)
    # each key-range group is scanned exactly once across all rounds
    assert scans == G


@pytest.mark.heavy
def test_streaming_auto_knobs(rng):
    """Default knob derivation from a small budget must still be exact."""
    members = _members(rng)[:3]
    want = occurrence_histograms_sweep(members, KS, cx=8)
    got = occurrence_histograms_sweep_streaming(
        members, KS, cx=8, device_budget_bytes=4 << 20,
    )
    for k in KS:
        assert got[k] == want[k], f"k={k}"


@pytest.mark.parametrize(
    "chunk_elems,n_groups,pass_groups",
    [
        (10000, 3, 1),     # chunk and group buffers of no particular size
        (16391, 4, 2),     # odd chunk length
        (4099, 7, 7),      # many small chunks, one pass over every group
        (65536, 2, None),  # one chunk, derived pass width
    ],
)
def test_streaming_knobs_bit_exact(rng, chunk_elems, n_groups, pass_groups):
    """The chunk and group sorts are plain lax.sort calls: any chunk
    length and group split gives the in-core histograms exactly."""
    members = _members(rng)[:3]
    want = occurrence_histograms_sweep(members, KS, cx=8)
    got = occurrence_histograms_sweep_streaming(
        members, KS, cx=8, chunk_elems=chunk_elems, n_groups=n_groups,
        pass_groups=pass_groups,
    )
    for k in KS:
        assert got[k] == want[k], f"k={k}"


@pytest.mark.heavy
def test_sweep_histograms_unchanged_polyA(rng):
    """End-to-end: the sweep stays bit-identical to the per-k fused path
    on poly-A/poly-T-heavy text (giant tie runs in the sorts), in core
    and streamed."""
    from khoice_tpu.engine.occurrence import occurrence_histogram
    from khoice_tpu.io.packing import encode_seq

    seqs = [
        "A" * 3000 + random_dna(rng, 2000) + "T" * 3000,
        "T" * 2500 + random_dna(rng, 3000) + "A" * 1000 + "N" * 50,
        random_dna(rng, 6000),
    ]
    members = [encode_seq(s) for s in seqs]
    ks = [7, 11, 16, 22, 31, 34]
    swept = occurrence_histograms_sweep(members, ks, cx=8)
    for k in ks:
        assert swept[k] == occurrence_histogram(members, k, cx=8), f"k={k}"
    streamed = occurrence_histograms_sweep_streaming(
        members, ks, cx=8, chunk_elems=8192, n_groups=3,
    )
    assert streamed == swept
