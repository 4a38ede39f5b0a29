"""Oracle builds of whole experiment CSVs.

Independent dict-based implementations (pykmc) of the exp1 and exp2
pipelines, written with the pipelines' own CSV writers, so an engine run
can be checked byte for byte against them (the tests and chip_smoke.py
use them).
"""

from __future__ import annotations

import os

from . import pykmc as oracle
from ..reports.csvio import write_csv_rows
from ..reports.metrics import (
    append_group_normalization,
    summarize_histogram_type1,
    summarize_histogram_type2,
)


def oracle_exp1_csvs(groups, k_values, out_dir):
    """Independent dict-based implementation of the exp1 pipeline:
    groups {num: [genome as list of record seqs]} -> (step5, step9) CSV
    paths under out_dir."""
    from ..pipelines.exp1 import STEP5_HEADER, STEP9_HEADER

    group_nums = sorted(groups)
    within, across = {}, {}
    for k in k_values:
        group_sets = []
        for num in group_nums:
            sets = [
                oracle.set_counts(oracle.count_kmers(seqs, k), 1)
                for seqs in groups[num]
            ]
            u = oracle.union_sum(sets, cs=5000)
            within[(k, num)] = oracle.histogram(u, cx=10000)
            group_sets.append(oracle.set_counts(u, 1))
        au = oracle.union_sum(group_sets, cs=5000)
        across[k] = oracle.histogram(au, cx=10000)

    rows = []
    for k in k_values:
        for num in group_nums:
            rows.append(
                [f"group_{num}", str(k)]
                + summarize_histogram_type1(within[(k, num)], len(groups[num]), False, int(k))
            )
    append_group_normalization(rows, [f"group_{n}" for n in group_nums])
    step5 = os.path.join(out_dir, "step_5.csv")
    write_csv_rows(step5, STEP5_HEADER, rows)

    rows = []
    for k in k_values:
        rows.append(
            ["full_group", str(k)]
            + summarize_histogram_type1(across[k], len(group_nums), True, int(k))
        )
    mx = max(r[8] for r in rows)
    for r in rows:
        r.append(round(r[8] / mx, 4))
    step9 = os.path.join(out_dir, "step_9.csv")
    write_csv_rows(step9, STEP9_HEADER, rows)
    return step5, step9


def oracle_exp2_metrics(pivots, rest, k, num, nums):
    pivot_set = oracle.set_counts(oracle.count_kmers(pivots[num], k), 1)
    members = [oracle.set_counts(oracle.count_kmers(g, k), 1) for g in rest[num]]
    rest_union = oracle.union_sum(members, cs=5000)
    inter = oracle.intersect_sum(pivot_set, rest_union)
    sub = oracle.subtract(pivot_set, rest_union)
    return (
        oracle.histogram(sub, cx=10000),
        oracle.histogram(inter, cx=10000),
    )


def oracle_exp2_csvs(pivots, rest, ks, out_dir):
    """Full oracle build of both exp2 CSVs (dataset-major rows, k inner,
    per-group max normalization) for whole-file byte comparison."""
    from ..pipelines.exp2 import ACROSS_HEADER, WITHIN_HEADER

    nums = sorted(rest)
    within_rows, across_rows = [], []
    for num in nums:
        for k in ks:
            sub_h, int_h = oracle_exp2_metrics(pivots, rest, k, num, nums)
            within_rows.append(
                [f"group_{num}", str(k)]
                + summarize_histogram_type2(sub_h, int_h, len(rest[num]), False, k)
            )
            pivot_set = oracle.set_counts(oracle.count_kmers(pivots[num], k), 1)
            others = [
                oracle.set_counts(
                    oracle.union_sum(
                        [oracle.set_counts(oracle.count_kmers(g, k), 1) for g in rest[j]],
                        cs=5000,
                    ),
                    1,
                )
                for j in nums
                if j != num
            ]
            au = oracle.union_sum(others, cs=5000)
            asub = oracle.histogram(oracle.subtract(pivot_set, au), cx=10000)
            ainter = oracle.histogram(oracle.intersect_sum(pivot_set, au), cx=10000)
            across_rows.append(
                [f"group_{num}", str(k)]
                + summarize_histogram_type2(asub, ainter, len(nums), True, k)
            )
    for rows in (within_rows, across_rows):
        for gid in [f"group_{n}" for n in nums]:
            mx = max(r[8] for r in rows if r[0] == gid)
            for r in rows:
                if r[0] == gid:
                    r.append(round(r[8] / mx, 4))
    wpath = os.path.join(out_dir, "within.csv")
    apath = os.path.join(out_dir, "across.csv")
    write_csv_rows(wpath, WITHIN_HEADER, within_rows)
    write_csv_rows(apath, ACROSS_HEADER, across_rows)
    return wpath, apath
