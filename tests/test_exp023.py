"""exp0 data prep, exp2 pivot-vs-group CSVs (vs oracle), exp3 containment."""

import os

import numpy as np
import pytest

from conftest import random_dna
from khoice_tpu import oracle
from khoice_tpu.config import KhoiceConfig
from khoice_tpu.oracle.pipelines import oracle_exp2_csvs
from khoice_tpu.pipelines.exp0 import run_exp0, load_database_dir
from khoice_tpu.pipelines.exp2 import run_exp2
from khoice_tpu.pipelines.exp3 import run_exp3
from khoice_tpu.reports.metrics import summarize_histogram_type2


def make_world(rng, d=3, genomes_per=3, glen=400):
    base = random_dna(rng, glen)
    db = {}
    for num in range(1, d + 1):
        genomes = {}
        for g in range(genomes_per):
            seq = list(base)
            for _ in range(25 * num + 7 * g):
                seq[rng.randrange(glen)] = "ACGT"[rng.randrange(4)]
            genomes[f"genome_{num}_{g}"] = ["".join(seq)]
        db[num] = genomes
    return db


def test_exp0_layout_and_determinism(rng, tmp_path):
    db = make_world(rng, glen=3000)
    cfg = KhoiceConfig(num_datasets=3, kmers_per_dataset=2000)
    out1 = run_exp0(db, cfg, trial=1, out_dir=str(tmp_path / "a"))
    out2 = run_exp0(db, cfg, trial=1, out_dir=str(tmp_path / "b"))
    assert out1["pivots"] == out2["pivots"]
    assert out1["reads"].keys() == out2["reads"].keys()
    for key in out1["reads"]:
        assert out1["reads"][key] == out2["reads"][key]
    t = tmp_path / "a" / "trial_1"
    assert (t / "exp0_pivot_genomes/dataset_1/pivot_1.fna.gz").exists()
    assert (t / "exp0_pivot_reads/dataset_2/ont/pivot_2_subset.fa").exists()
    assert (tmp_path / "a" / "trial_summaries/trial_1_summary.txt").exists()
    # round-trip via the reference database layout reader
    loaded = load_database_dir(str(t / "exp0_nonpivot_genomes"))
    assert sorted(loaded) == [1, 2, 3]


def test_exp2_matches_oracle_byte_exact(rng, tmp_path):
    """Whole-file byte equality of BOTH exp2 CSVs vs oracle-built files,
    ks spanning 1/2/3-word key widths (row order included)."""
    db = make_world(rng)
    pivots = {num: db[num]["genome_%d_0" % num] for num in db}
    rest = {num: [db[num][f"genome_{num}_{g}"] for g in (1, 2)] for num in db}
    ks = [7, 11, 21, 33]
    out = run_exp2(pivots, rest, ks, str(tmp_path / "engine"))
    (tmp_path / "oracle").mkdir()
    g_within, g_across = oracle_exp2_csvs(pivots, rest, ks, str(tmp_path / "oracle"))

    assert open(out["within"], "rb").read() == open(g_within, "rb").read()
    assert open(out["across"], "rb").read() == open(g_across, "rb").read()
    lines = open(out["across"]).read().strip().split("\n")
    assert lines[0].startswith("group_num,k,percent_1_occ,percent_2_to_3")
    assert len(lines) == 1 + len(ks) * len(rest)


def test_exp3_csv_byte_exact(rng, tmp_path):
    """Whole-file byte equality of the exp3 containment CSV vs an oracle
    build (row order: read_type outer, pivot, k, dataset), ks spanning
    1/2-word key widths."""
    from khoice_tpu.pipelines.exp3 import HEADER
    from khoice_tpu.reports.csvio import write_csv_rows

    db = make_world(rng, glen=500)
    pivots = {num: db[num]["genome_%d_0" % num] for num in db}
    rest = {num: [db[num][f"genome_{num}_{g}"] for g in (1, 2)] for num in db}
    reads = {}
    for num in pivots:
        for rt in ("illumina", "ont"):
            reads[(rt, num)] = [pivots[num][0][i : i + 80] for i in range(0, 400, 40)]
    ks = [9, 13, 21]
    got = run_exp3(reads, rest, ks, str(tmp_path / "engine"))

    nums = sorted(rest)
    rows = []
    for rt in ("illumina", "ont"):
        for pnum in nums:
            for k in ks:
                pivot_set = oracle.set_counts(
                    oracle.count_kmers(reads[(rt, pnum)], k), 1
                )
                for num in nums:
                    union = oracle.union_sum(
                        [
                            oracle.set_counts(oracle.count_kmers(g, k), 1)
                            for g in rest[num]
                        ],
                        cs=5000,
                    )
                    inter = oracle.intersect_sum(pivot_set, union)
                    rows.append(
                        [rt, str(pnum), str(k), str(num),
                         round(len(inter) / len(pivot_set), 4)]
                    )
    want = str(tmp_path / "oracle.csv")
    write_csv_rows(want, HEADER, rows)
    assert open(got, "rb").read() == open(want, "rb").read()


def test_exp4_csv_byte_exact(rng, tmp_path):
    """Whole-file byte equality of exp4's concatenated accuracy CSV vs an
    oracle build, including the shell-glob (lexicographic) k concat order
    and the exact float accumulation order of the feature rows."""
    from khoice_tpu.pipelines.exp4 import run_exp4

    db = make_world(rng)
    pivots = {num: db[num]["genome_%d_0" % num] for num in db}
    rest = {num: [db[num][f"genome_{num}_{g}"] for g in (1, 2)] for num in db}
    ks = [7, 11, 21]  # lexicographic order: 11, 21, 7
    got = run_exp4(pivots, rest, ks, str(tmp_path / "engine"))

    nums = sorted(rest)
    d = len(nums)
    lines_by_k = {}
    for k in ks:
        gs = {
            num: oracle.set_counts(
                oracle.union_sum(
                    [oracle.set_counts(oracle.count_kmers(g, k), 1) for g in rest[num]],
                    cs=5000,
                ),
                1,
            )
            for num in nums
        }
        cm, cm_u = [], []
        for num in nums:
            pc = oracle.count_kmers(pivots[num], k)
            buckets = np.zeros((d, d), np.int64)
            unique = 0
            for km, cnt in pc.items():
                matches = [i for i, nn in enumerate(nums) if km in gs[nn]]
                if not matches:
                    unique += cnt
                else:
                    for m in matches:
                        buckets[m, len(matches) - 1] += cnt
            matched = [
                float(sum(int(buckets[col, m - 1]) / m for m in range(1, d + 1)))
                for col in range(d)
            ]
            cm.append([matched[col] + unique / d for col in range(d)] + [0])
            cm_u.append(matched + [0])
        lines = []
        for pivot in range(d):
            vals = []
            for mat in (cm, cm_u):
                tp = mat[pivot][pivot]
                fp = fn = tn = 0
                for r in range(d):
                    for c in range(d + 1):
                        cur = mat[r][c]
                        if c == pivot and r != pivot:
                            fp += cur
                        elif r == pivot and c != pivot:
                            fn += cur
                        elif r != pivot:
                            tn += cur
                vals.append([tp, tn, fp, fn])
            lines.append(
                ",".join([str(k), str(pivot)] + [str(x) for x in vals[0]]
                         + [str(x) for x in vals[1]])
            )
        lines_by_k[str(k)] = lines
    want = "".join(
        "\n".join(lines_by_k[kk]) + "\n" for kk in sorted(lines_by_k)
    )
    assert open(got).read() == want


def test_exp3_containment(rng, tmp_path):
    db = make_world(rng, glen=500)
    pivots = {num: db[num]["genome_%d_0" % num] for num in db}
    rest = {num: [db[num][f"genome_{num}_{g}"] for g in (1, 2)] for num in db}
    reads = {}
    for num in pivots:
        for rt in ("illumina", "ont"):
            reads[(rt, num)] = [pivots[num][0][i : i + 80] for i in range(0, 400, 40)]
    ks = [9]
    csv = run_exp3(reads, rest, ks, str(tmp_path))
    lines = open(csv).read().strip().split("\n")
    assert lines[0] == "read_type,pivot_num,k,dataset_num,intersection_percent"
    assert len(lines) == 1 + 2 * len(pivots) * len(ks) * len(rest)
    # containment of a pivot's own reads vs oracle
    rt, pnum, num = "illumina", 1, 1
    pivot_set = oracle.set_counts(oracle.count_kmers(reads[(rt, pnum)], 9), 1)
    union = oracle.union_sum(
        [oracle.set_counts(oracle.count_kmers(g, 9), 1) for g in rest[num]], cs=5000
    )
    inter = oracle.intersect_sum(pivot_set, union)
    want = round(len(inter) / len(pivot_set), 4)
    row0 = lines[1].split(",")
    assert row0[:4] == ["illumina", "1", "9", "1"]
    assert float(row0[4]) == want
