"""Mid-scale sharded stress test.

Earlier sharded tests ran at ~4.5k distinct k-mers with forced tiny
bucket caps; here ~2.6 Mbp of structured text (shared mutated cores,
a high-copy repeat family, GC-skew segments, N runs and a poly-A block)
pushes >=1M distinct canonical k-mers through

- the SPMD shared-sort sweep with NATURAL cap sizing (bucket_cap=None,
  default slack — the split-sampling and rank-space bucketing actually
  earn their keep at this scale), and
- the composed sharded set algebra (count -> set -> union ->
  intersect/subtract -> histogram),

on the 8-virtual-device CPU mesh, comparing bit-exactly against the
single-device engine paths (themselves oracle-pinned at small scale by
tests/test_sharded.py and tests/test_ksweep.py; a Python dict oracle at
this size would dominate CI time).
"""

import numpy as np
import pytest

from conftest import cpu_devices, random_dna
from khoice_tpu.dist import make_mesh
from khoice_tpu.dist.ksweep import sharded_occurrence_histograms_sweep
from khoice_tpu.dist.sharded import (
    _host_flatten,
    sharded_count_codes,
    sharded_histogram,
    sharded_intersect_sum,
    sharded_set_counts,
    sharded_subtract,
    sharded_union_many,
)
from khoice_tpu.engine.ksweep import occurrence_histograms_sweep
from khoice_tpu.engine.session import KmerEngine
from khoice_tpu.io import encode_records

pytestmark = pytest.mark.slow


def _structured_members(rng, n=4, core_len=400_000):
    core = random_dna(rng, core_len)
    repeat = random_dna(rng, 3000)
    out = []
    for i in range(n):
        seq = list(core)
        for _ in range(4000 * (i + 1)):  # ~1-4% divergence
            seq[rng.randrange(core_len)] = "ACGT"[rng.randrange(4)]
        parts = ["".join(seq)]
        for _ in range(12):  # repeat family, high copy number
            parts.append(repeat)
        parts.append(random_dna(rng, 60_000))          # unique flank
        gc = random_dna(rng, 40_000).replace("A", "G")  # GC-skew block
        parts.append(gc)
        if i == 0:
            parts.append("A" * 15_000)                  # skew block
        if i == 1:
            parts.append("N" * 500 + random_dna(rng, 10_000))
        out.append(encode_records(["".join(parts)]))
    return out


def test_midscale_sweep_natural_caps(rng):
    members = _structured_members(rng)
    total = sum(m.shape[0] for m in members)
    assert total > 2_000_000
    ks = [13, 21, 31, 49]
    mesh = make_mesh(devices=cpu_devices(8))
    got = sharded_occurrence_histograms_sweep(mesh, members, ks)  # natural caps
    want = occurrence_histograms_sweep(members, ks)
    for k in ks:
        assert got[k] == want[k], f"k={k}"
        # the scale claim: >= 1M distinct canonical classes at this k
        assert sum(want[k]) >= 1_000_000, f"k={k} distinct={sum(want[k])}"


def test_midscale_sharded_algebra(rng):
    members = _structured_members(rng, n=3, core_len=300_000)
    k = 27
    mesh = make_mesh(devices=cpu_devices(8))
    eng = KmerEngine()

    sh_sets = [
        sharded_set_counts(sharded_count_codes(mesh, m, k), 1) for m in members
    ]
    sh_union = sharded_union_many(sh_sets, cs=5000)
    sh_rest = sharded_union_many(sh_sets[1:], cs=5000)
    sh_inter = sharded_intersect_sum(sh_sets[0], sh_rest)
    sh_sub = sharded_subtract(sh_sets[0], sh_rest)

    sd_sets = [eng.set_counts(eng.count_codes(m, k), 1) for m in members]
    sd_union = eng.union(sd_sets, cs=5000)
    sd_rest = eng.union(sd_sets[1:], cs=5000)
    sd_inter = eng.intersect_sum(sd_sets[0], sd_rest)
    sd_sub = eng.subtract(sd_sets[0], sd_rest)

    # arrays, not dicts: 1M+ keys compare as numpy word rows
    for sh, sd, name in (
        (sh_union, sd_union, "union"),
        (sh_inter, sd_inter, "intersect"),
        (sh_sub, sd_sub, "subtract"),
    ):
        keys, counts = _host_flatten(sh)
        sd_counts = np.asarray(sd.counts)
        present = sd_counts > 0
        sd_keys = np.stack(
            [np.asarray(w)[present] for w in sd.keys], axis=-1
        )
        np.testing.assert_array_equal(counts, sd_counts[present], err_msg=name)
        np.testing.assert_array_equal(keys, sd_keys, err_msg=name)
        assert counts.shape[0] >= (900_000 if name == "union" else 1)

    np.testing.assert_array_equal(
        sharded_histogram(sh_union, cx=16),
        np.asarray(eng.histogram(sd_union, cx=16)),
    )
