"""Sharded classification sweeps (dist/ksweep_classify.py): exp2/3/4
pipeline CSVs must be byte-identical with a mesh to the single-device
run, and the raw sweep stats must match across device counts (the
reference fans exp2-4 over cores exactly like exp1,
workflow/rules/exp_type_2.smk:354-380)."""

import numpy as np
import pytest

from conftest import cpu_devices, random_dna
from khoice_tpu.dist import make_mesh
from test_exp023 import make_world


def _world(rng):
    db = make_world(rng)
    pivots = {num: db[num]["genome_%d_0" % num] for num in db}
    rest = {num: [db[num][f"genome_{num}_{g}"] for g in (1, 2)] for num in db}
    return pivots, rest


@pytest.mark.heavy
def test_exp2_csvs_byte_exact_on_mesh(rng, tmp_path):
    from khoice_tpu.pipelines.exp2 import run_exp2

    pivots, rest = _world(rng)
    ks = [7, 11, 21, 33]
    single = run_exp2(pivots, rest, ks, str(tmp_path / "single"))
    mesh = make_mesh(devices=cpu_devices(8))
    sharded = run_exp2(pivots, rest, ks, str(tmp_path / "mesh"), mesh=mesh)
    for key in ("within", "across"):
        assert open(sharded[key], "rb").read() == open(single[key], "rb").read()


@pytest.mark.heavy
def test_exp3_csv_byte_exact_on_mesh(rng, tmp_path):
    from khoice_tpu.pipelines.exp3 import run_exp3

    pivots, rest = _world(rng)
    reads = {}
    for num in pivots:
        for rt in ("illumina", "ont"):
            reads[(rt, num)] = [pivots[num][0][i : i + 80] for i in range(0, 400, 40)]
    ks = [9, 13, 21]
    single = run_exp3(reads, rest, ks, str(tmp_path / "single"))
    mesh = make_mesh(devices=cpu_devices(8))
    sharded = run_exp3(reads, rest, ks, str(tmp_path / "mesh"), mesh=mesh)
    assert open(sharded, "rb").read() == open(single, "rb").read()


@pytest.mark.heavy
def test_exp4_csv_byte_exact_on_mesh(rng, tmp_path):
    """exp4's buckets mode sums pivot multiplicities (exchange dedupe
    disabled) — repeated pivot k-mers across shard boundaries stress it."""
    from khoice_tpu.pipelines.exp4 import run_exp4

    pivots, rest = _world(rng)
    # amplify pivot multiplicity: duplicate records inside each pivot
    pivots = {num: pivots[num] + pivots[num] for num in pivots}
    ks = [7, 11, 21]
    single = run_exp4(pivots, rest, ks, str(tmp_path / "single"))
    mesh = make_mesh(devices=cpu_devices(8))
    sharded = run_exp4(pivots, rest, ks, str(tmp_path / "mesh"), mesh=mesh)
    assert open(sharded, "rb").read() == open(single, "rb").read()


def test_sharded_classify_device_count_invariance(rng):
    """pivot_rest raw counts identical at 1/2/8 devices (the psum-then-
    halve order must make the result device-count invariant)."""
    from khoice_tpu.dist.ksweep_classify import sharded_pivot_rest_counts_sweep
    from khoice_tpu.engine.ksweep_classify import pivot_rest_counts_sweep
    from khoice_tpu.io import encode_records

    base = random_dna(rng, 900)
    members = []
    for i in range(4):
        seq = list(base)
        for _ in range(40 * (i + 1)):
            seq[rng.randrange(len(base))] = "ACGT"[rng.randrange(4)]
        members.append(encode_records(["".join(seq) + ("A" * 150 if i == 0 else "")]))
    ks = [7, 10, 13, 21]
    want, rem = pivot_rest_counts_sweep(members, ks)
    assert rem == []
    for nd in (1, 2, 8):
        mesh = make_mesh(devices=cpu_devices(nd))
        got, rem2 = sharded_pivot_rest_counts_sweep(mesh, members, ks)
        assert rem2 == []
        for k in ks:
            assert np.array_equal(got[k], want[k]), f"nd={nd} k={k}"


def test_sharded_votes_match_single_device(rng):
    """dist/vote.sharded_read_votes_multi == read_votes_bulk_multi bit for
    bit on the 8-virtual-device mesh, ks spanning 1/2/4-word widths, with
    Ns, unmatched reads, and uneven per-pivot read counts."""
    from khoice_tpu.classify.annotate import (
        concat_flat_reads,
        flat_reads_device,
        pack_group_texts,
        read_votes_bulk_multi,
    )
    from khoice_tpu.dist.vote import sharded_read_votes_multi
    from khoice_tpu.io.packing import encode_records
    from khoice_tpu.pipelines.exp6 import reads_matrix

    core = random_dna(rng, 700)
    groups = []
    for i in range(4):
        s = list(core)
        for _ in range(25 * (i + 1)):
            s[rng.randrange(len(s))] = "ACGT"[rng.randrange(4)]
        groups.append(encode_records(["".join(s), "ACGT" * 12 + random_dna(rng, 40)]))
    mats = [
        reads_matrix(
            [random_dna(rng, 40 + 6 * p) for _ in range(4 + p)]
            + [core[:60], "NN" + random_dna(rng, 30)]
        )
        for p in range(4)
    ]
    mesh = make_mesh(devices=cpu_devices(8))
    ks = [7, 16, 33]
    got = sharded_read_votes_multi(mesh, groups, mats, ks)
    cg = pack_group_texts(groups)
    big, spans = concat_flat_reads([flat_reads_device(m) for m in mats])
    for k in ks:
        want = read_votes_bulk_multi(cg, big, spans, k, 4)
        for (gv, gu, gn), (wv, wu, wn) in zip(got[k], want):
            np.testing.assert_array_equal(gv, wv, err_msg=f"k={k}")
            np.testing.assert_array_equal(gu, wu, err_msg=f"k={k}")
            np.testing.assert_array_equal(gn, wn, err_msg=f"k={k}")


def test_sharded_votes_overflow_retry(rng):
    """A bucket cap too small for the data must retry with doubled caps
    and still match the single-device votes (poly-A skew concentrates one
    key's run in one shard)."""
    from khoice_tpu.classify.annotate import (
        concat_flat_reads,
        flat_reads_device,
        pack_group_texts,
        read_votes_bulk_multi,
    )
    from khoice_tpu.dist.vote import sharded_read_votes_multi
    from khoice_tpu.io.packing import encode_records
    from khoice_tpu.pipelines.exp6 import reads_matrix

    groups = [
        encode_records(["A" * 300 + random_dna(rng, 100)]),
        encode_records([random_dna(rng, 300)]),
    ]
    mats = [
        reads_matrix(["A" * 50, random_dna(rng, 50)]),
        reads_matrix([random_dna(rng, 50) for _ in range(3)]),
    ]
    mesh = make_mesh(devices=cpu_devices(8))
    got = sharded_read_votes_multi(mesh, groups, mats, [11], bucket_cap=8)
    cg = pack_group_texts(groups)
    big, spans = concat_flat_reads([flat_reads_device(m) for m in mats])
    want = read_votes_bulk_multi(cg, big, spans, 11, 2)
    for (gv, gu, gn), (wv, wu, wn) in zip(got[11], want):
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gu, wu)
        np.testing.assert_array_equal(gn, wn)


@pytest.mark.heavy
def test_exp6_trial_csv_byte_exact_on_mesh(rng, tmp_path):
    from khoice_tpu.pipelines.exp6 import run_exp6

    pivots, rest = _world(rng)
    reads = {
        num: [pivots[num][0][i : i + 60] for i in range(0, 240, 30)]
        + [random_dna(rng, 60) for _ in range(3)]
        for num in rest
    }
    ks = [7, 11, 21, 33]
    single = run_exp6(reads, rest, ks, str(tmp_path / "single"))
    mesh = make_mesh(devices=cpu_devices(8))
    sharded = run_exp6(reads, rest, ks, str(tmp_path / "mesh"), mesh=mesh)
    assert open(sharded, "rb").read() == open(single, "rb").read()
