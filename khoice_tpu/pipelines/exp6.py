"""Experiment 6: read-level k-mer confusion matrix (classification path).

Replaces workflow/rules/exp_type_6.smk + merge_lists.py -r: per
(k, read_type), a raw-count table over each pivot's simulated reads is
annotated against the per-dataset group sets; each read votes with weight
1/|matches| per k-mer (exact LCM-scaled integers here), argmax with seeded
random tie-break classifies it (src/merge_lists.py:151-183), and one-vs-
rest accuracy rows concatenate into trial_{t}_{short,long}_acc.csv with
U-columns (exp_type_6.smk:349-362).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from ..classify import (
    accuracy_values,
    read_level_confusion_row,
    write_accuracy_csv,
    write_confusion_matrix,
)
from ..engine.session import KmerEngine
from ..io.packing import encode_records, encode_seq
from .exp4 import glob_lexicographic

READ_TYPE_LABEL = {"illumina": "short", "ont": "long"}


def reads_matrix(reads: Sequence[str]) -> np.ndarray:
    """[R, Lmax] uint8 code matrix, short reads padded with separator 4s.

    One encode pass + one boolean fill (the per-read row-assignment loop
    was ~10 s at the reference's 830k-read scale): boolean assignment
    fills row-major, which is exactly the reads' concatenation order."""
    n = len(reads)
    lens = np.fromiter((len(r) for r in reads), np.int64, n)
    lmax = int(lens.max())
    out = np.full((n, lmax), 4, np.uint8)
    out[np.arange(lmax)[None, :] < lens[:, None]] = encode_seq("".join(reads))
    return out


def run_exp6(
    pivot_reads: Dict[int, List[str]],
    rest_of_set: Dict[int, List[List[str]]],
    k_values: Sequence[int],
    out_dir: str,
    read_type: str = "illumina",
    trial: int = 1,
    seed: int = 0,
    engine: KmerEngine | None = None,
    count_cs: int = 255,
    union_cs: int = 5000,
    mesh=None,
) -> str:
    """pivot_reads: {num: [read strings]} (exp0 subset output);
    rest_of_set: {num: [genome,...]}. Returns the trial accuracy CSV path.
    mesh: optional jax.sharding.Mesh — votes ride the key-range SPMD
    merge-join (dist/vote.py), bit-identical to the single-device path.
    """
    del engine  # kept for signature compatibility; voting needs no engine
    nums = sorted(rest_of_set)
    d = len(nums)
    label = READ_TYPE_LABEL.get(read_type, read_type)
    acc_dir = os.path.join(out_dir, f"accuracies_type_6/{read_type}")

    from ..classify.annotate import (
        concat_flat_reads,
        flat_reads_device,
        pack_group_texts,
        read_votes_bulk_multi,
    )
    from ..engine.bits import key_words

    group_codes = [
        encode_records([s for g in rest_of_set[num] for s in g]) for num in nums
    ]
    read_mats = [reads_matrix(pivot_reads[num]) for num in nums]

    def write_k(k, per_pivot):
        cm, cm_ucol = [], []
        for num, (votes, _unmatched, _nk) in zip(nums, per_pivot):
            rng = np.random.default_rng([seed, trial, k, num])
            row = read_level_confusion_row(votes, d, rng)
            # regular and with-unidentified matrices take the SAME
            # class increments (reference merge_lists.py:182-183)
            cm.append(list(row))
            cm_ucol.append(list(row))
        _write_k_outputs(acc_dir, k, cm, cm_ucol, d)

    # ALL pivots vote from ONE merge-join sort per k (the group texts —
    # ~85% of the sort volume at reference scale — are shared), and one
    # dynamic-k compile serves each key-word class of the grid instead of
    # one compile per k; this is exp6's counterpart of the shared-sort
    # k-sweeps exp1-4 ride (instead of one 162M-element sort + one
    # compile per (k, pivot) at reference scale).
    if mesh is not None:
        from ..dist.vote import sharded_read_votes_multi

        by_k = sharded_read_votes_multi(mesh, group_codes, read_mats, k_values)
        for k in k_values:
            write_k(k, by_k[k])
    else:
        packed_groups = pack_group_texts(group_codes)
        big_flat, spans = concat_flat_reads(
            [flat_reads_device(m) for m in read_mats]
        )
        by_width: Dict[int, List[int]] = {}
        for k in k_values:
            by_width.setdefault(key_words(k), []).append(k)

        for _w, cks in sorted(by_width.items()):
            kmax = max(cks) if len(cks) > 1 else None
            for k in cks:
                write_k(
                    k,
                    read_votes_bulk_multi(
                        packed_groups, big_flat, spans, k, d, kmax=kmax
                    ),
                )

    final = os.path.join(out_dir, f"trial_{trial}_{label}_acc.csv")
    with open(final, "w") as out_fd:
        # header printf'd before the cat in the reference (exp_type_6.smk:357)
        out_fd.write("k,pivotnum,TP,TN,FP,FN,TP-U,TN-U,FP-U,FN-U\n")
        for k in glob_lexicographic(k_values):
            with open(os.path.join(acc_dir, f"values/k_{k}_accuracy_values.csv")) as fd:
                out_fd.write(fd.read())
    return final


def _write_k_outputs(acc_dir: str, k: int, cm, cm_ucol, d: int) -> None:
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
