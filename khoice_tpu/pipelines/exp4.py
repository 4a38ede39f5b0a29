"""Experiment 4: genome-level k-mer confusion matrix.

Replaces workflow/rules/exp_type_4.smk: for each k, each pivot genome's
raw-count k-mer table is annotated against every dataset's rest-of-set
union (set_counts 1), and merge_lists.py's feature-level weighting
(src/merge_lists.py:134-149) produces a D x (D+1) confusion matrix and
one-vs-rest accuracy values. In-pivot vs out-pivot follows the OUT_PIVOT
switch (exp_type_4.smk:50-52: in-pivot adds the pivot to its own
rest_of_set).

The reference materializes KMC text dumps per (k, pivot, dataset) and
re-parses them in Python; here the annotation is one device sort per
(k, pivot) and the buckets are exact integers (see classify/annotate.py).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

from ..classify import (
    accuracy_values,
    build_annotation,
    feature_buckets,
    feature_confusion_rows,
    write_accuracy_csv,
    write_confusion_matrix,
)
from ..engine.session import KmerEngine
from ..io.packing import encode_records
from .exp1 import STEP5_HEADER  # noqa: F401  (shared layout conventions)


def glob_lexicographic(k_values: Sequence[int]) -> List[int]:
    """Order of `cat values/*.csv` (exp_type_4.smk:299-305): shell glob is
    lexicographic on 'k_{k}_accuracy_values.csv'."""
    return [k for _, k in sorted((f"k_{k}_accuracy_values.csv", k) for k in k_values)]


def build_group_sets(
    eng: KmerEngine,
    rest_of_set: Dict[int, List[List[str]]],
    k: int,
    union_cs: int = 5000,
    count_cs: int = 255,
):
    """Per-dataset rest-of-set union -> set (exp_type_4.smk:180-213 role).

    A group *set* (set_counts 1 of the member union) equals the k-mer set
    of the concatenated members, so one count per dataset replaces the
    reference's per-genome count + n-way union chain.
    """
    sets = {}
    for num in sorted(rest_of_set):
        all_seqs = [s for seqs in rest_of_set[num] for s in seqs]
        sets[num] = eng.set_counts(
            eng.count_codes(encode_records(all_seqs), k, cs=count_cs), 1
        )
    return sets


def run_exp4(
    pivots: Dict[int, List[str]],
    rest_of_set: Dict[int, List[List[str]]],
    k_values: Sequence[int],
    out_dir: str,
    engine: KmerEngine | None = None,
    count_cs: int = 255,
    union_cs: int = 5000,
    mesh=None,
) -> str:
    """pivots: {num: pivot record seqs}; rest_of_set: {num: [genome,...]}
    (with the pivot already included per dataset when doing in-pivot).

    Writes accuracies_type_4/{confusion_matrix,values}/ and the
    concatenated accuracy_values.csv; returns the concatenated path.
    A jax.sharding.Mesh runs each pivot's buckets sweep SPMD
    (dist/ksweep_classify.py), bit-identical outputs.
    """
    from ..engine.ksweep_classify import feature_buckets_sweep

    if mesh is not None:
        from ..dist.ksweep_classify import sharded_feature_buckets_sweep

        def feature_buckets_sweep(members, D, ks, cap, cs):  # noqa: F811
            return sharded_feature_buckets_sweep(
                mesh, members, D, ks, cap=cap, cs=cs
            )

    eng = engine or KmerEngine()
    nums = sorted(rest_of_set)
    d = len(nums)
    acc_dir = os.path.join(out_dir, "accuracies_type_4")

    # fast path: per pivot, ONE doubled-text sort serves every k's
    # feature buckets (pivot multiplicities via a segmented sum riding
    # the presence-mask scan, engine/ksweep_classify.py); leftover ks
    # fall back to the per-k annotation sort below
    pivot_codes = {num: encode_records(pivots[num]) for num in nums}
    group_codes = [
        encode_records([s for g in rest_of_set[num] for s in g]) for num in nums
    ]
    # The sweep's device-memory fallback (_scan_too_big) is data-dependent
    # on each pivot's size (n2 includes the pivot text), so one pivot can fall
    # back for a k that another pivot swept fine: the fallback decision must be
    # per (num, k), not a global k set.
    swept: Dict[int, dict] = {}
    for num in nums:
        bk, _rem = feature_buckets_sweep(
            [pivot_codes[num]] + group_codes, d, k_values, cap=count_cs,
            cs=union_cs,
        )
        swept[num] = bk

    for k in k_values:
        if all(k in swept[num] for num in nums):
            group_sets = None
        else:
            group_sets = build_group_sets(eng, rest_of_set, k, union_cs, count_cs)
        cm, cm_ucol = [], []
        for num in nums:
            if k in swept[num]:
                buckets, unique = swept[num][k]
            else:
                pivot_table = eng.count_codes(pivot_codes[num], k, cs=count_cs)
                ann = build_annotation(pivot_table, [group_sets[j] for j in nums])
                buckets, unique = feature_buckets(ann)
            regular, ucol = feature_confusion_rows(buckets, unique)
            cm.append(regular)
            cm_ucol.append(ucol)

        write_confusion_matrix(
            os.path.join(acc_dir, f"confusion_matrix/k_{k}_confusion_matrix.txt"), cm
        )
        write_confusion_matrix(
            os.path.join(
                acc_dir, f"confusion_matrix/k_{k}_confusion_matrix_with_unidentified.txt"
            ),
            cm_ucol,
        )
        write_accuracy_csv(
            os.path.join(acc_dir, f"values/k_{k}_accuracy_values.csv"),
            accuracy_values(cm, d, str(k)),
            accuracy_values(cm_ucol, d, str(k)),
        )

    final = os.path.join(acc_dir, "accuracy_values.csv")
    with open(final, "w") as out_fd:
        for k in glob_lexicographic(k_values):
            with open(os.path.join(acc_dir, f"values/k_{k}_accuracy_values.csv")) as fd:
                out_fd.write(fd.read())
    return final
