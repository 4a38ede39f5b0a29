"""Experiment 1: whole-group k-mer uniqueness (the north-star path).

Device replacement for the reference's exp_type_1 Snakemake DAG
(workflow/rules/exp_type_1.smk:156-308):

  per (k, group): per-genome canonical count -> set_counts 1 ->
  within-group union (count = #genomes containing the k-mer) ->
  histogram -> step_4 text file; all (k, group) histograms ->
  step_5/within_datasets_analysis.csv.

  per k: group set (set_counts 1 of the union) -> across-group union
  (count = #groups) -> histogram -> step_8 text file; -> step_9 CSV.

The reference runs kmc/kmc_tools once per (k, genome) across process
boundaries; here a genome's codes are encoded once and every stage is a
device op inside one process. Output files keep the reference's step_4/
step_5/step_8/step_9 layout so resume and the CSV contract carry over.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

from ..engine.session import KmerEngine
from ..io.fasta import read_fasta
from ..io.packing import encode_records
from ..reports.csvio import read_hist_txt, write_csv_rows, write_hist_txt
from ..reports.metrics import append_group_normalization, summarize_histogram_type1

STEP5_HEADER = (
    "group_num,k,percent_1_occ,percent_25_or_less,percent_25_to_75,"
    "percent_75_or_more,unique_stat,unique_stat_norm,delta_frac,delta_frac_norm\n"
)
STEP9_HEADER = (
    "group_num,k,percent_1_occ,percent_2_to_5,percent_5_to_20,percent_20_more,"
    "unique_stat,unique_stat_norm,delta_frac,delta_frac_norm\n"
)


def load_groups(groups_fastas: Dict[int, List[str]]) -> Dict[int, List[List[str]]]:
    """{group_num: [fasta_path,...]} -> {group_num: [genome record seqs,...]}."""
    out = {}
    for num, paths in groups_fastas.items():
        out[num] = [[r.seq for r in read_fasta(p)] for p in paths]
    return out


def run_exp1(
    groups: Dict[int, List[List[str]]],
    k_values: Sequence[int],
    out_dir: str,
    engine: KmerEngine | None = None,
    union_cs: int = 5000,
    count_cs: int = 255,
    hist_cx: int = 10000,
    write_hists: bool = True,
    fused: bool = True,
    mesh=None,
    device_budget_bytes: int | None = None,
) -> Dict[str, str]:
    """groups: {group_num: [genome as list-of-record-seqs, ...]}.

    fused=True uses the single-sort genome-occurrence path
    (engine/occurrence.py) — bit-identical histograms, ~G x less sort
    volume than the composed count/union path (fused=False keeps the
    kmc_tools-shaped table ops for cross-validation). Passing a
    jax.sharding.Mesh runs the fused path SPMD over its "kv" axis
    (dist/occurrence.py).

    A group whose in-core sweep footprint exceeds `device_budget_bytes`
    (default: engine/streaming.default_device_budget_bytes — ~85% of the
    accelerator's memory) is dispatched to the bounded-memory streaming
    sweep automatically, the way `kmc -m64` bounds itself without the
    user choosing (reference exp_type_1.smk:163).

    Returns {"step_5": csv_path, "step_9": csv_path}.
    """
    eng = engine or KmerEngine()
    group_nums = sorted(groups)

    # Encode each genome once; every k reuses the codes.
    codes = {
        num: [encode_records(seqs) for seqs in groups[num]] for num in group_nums
    }

    within_hists: Dict[tuple, List[int]] = {}
    across_hists: Dict[int, List[int]] = {}

    if fused:
        import numpy as np

        if mesh is not None:
            # SPMD shared-sort sweep: the whole k grid per group in one
            # sharded program per key-word class (dist/ksweep.py)
            from ..dist.ksweep import sharded_occurrence_histograms_sweep

            ks_list = [int(k) for k in k_values]
            within_all = {
                num: sharded_occurrence_histograms_sweep(
                    mesh, codes[num], ks_list, cs=union_cs, cx=hist_cx
                )
                for num in group_nums
            }
            group_concat = [
                np.concatenate(
                    [np.concatenate([c, np.full(1, 4, np.uint8)]) for c in codes[num]]
                )
                for num in group_nums
            ]
            across_all = sharded_occurrence_histograms_sweep(
                mesh, group_concat, ks_list, cs=union_cs, cx=hist_cx
            )
            within_hist = {
                num: lambda k, num=num: within_all[num][int(k)]
                for num in group_nums
            }
            across_hist = lambda k: across_all[int(k)]
        else:
            from ..engine.ksweep import occurrence_histograms_sweep_packed
            from ..engine.occurrence import pack_members_device
            from ..engine import streaming
            from ..utils.logging import get_logger

            log = get_logger("khoice.exp1")
            budget = device_budget_bytes or streaming.default_device_budget_bytes()
            ks_list = [int(k) for k in k_values]

            def sweep_members(member_codes, label):
                """In-core shared-sort sweep, or the bounded-memory
                streaming sweep when the group exceeds the device budget
                (bit-identical results; engine/streaming.py)."""
                total = sum(int(c.shape[0]) + 1 for c in member_codes)
                need = streaming.incore_sweep_bytes(
                    total, ks_list, len(member_codes)
                )
                if need > budget:
                    log.info(
                        "%s: in-core sweep ~%.1f GiB exceeds device budget "
                        "%.1f GiB — streaming (bounded memory)",
                        label, need / 2**30, budget / 2**30,
                    )
                    return streaming.occurrence_histograms_sweep_streaming(
                        member_codes, ks_list, cs=union_cs, cx=hist_cx,
                        device_budget_bytes=budget,
                    )
                packed = pack_members_device(member_codes)
                return occurrence_histograms_sweep_packed(
                    packed, len(member_codes), ks_list, cs=union_cs, cx=hist_cx
                )

            # pack + upload each group once (2-bit packed transfer, gids
            # rebuilt on device), then compute the WHOLE k sweep per group
            # with the shared-sort engine (one sort per key-word class
            # instead of per k; engine/ksweep.py)
            within_all = {}
            for num in group_nums:
                within_all[num] = sweep_members(codes[num], f"group {num}")
            group_concat = [
                np.concatenate(
                    [np.concatenate([c, np.full(1, 4, np.uint8)]) for c in codes[num]]
                )
                for num in group_nums
            ]
            across_all = sweep_members(group_concat, "across-groups")

            within_hist = {
                num: lambda k, num=num: within_all[num][int(k)]
                for num in group_nums
            }
            across_hist = lambda k: across_all[int(k)]

    for k in k_values:
        group_sets = []
        for num in group_nums:
            if fused:
                hist = within_hist[num](k)
            else:
                members = [
                    eng.set_counts(eng.count_codes(c, k, cs=count_cs), 1)
                    for c in codes[num]
                ]
                union = eng.union(members, cs=union_cs)
                hist = eng.histogram(union, cx=hist_cx)
                group_sets.append(eng.set_counts(union, 1))
            within_hists[(k, num)] = hist
            if write_hists:
                write_hist_txt(
                    os.path.join(out_dir, f"step_4/k_{k}/dataset_{num}/dataset_{num}_k{k}_hist.txt"),
                    hist,
                    cx=hist_cx,
                )

        if fused:
            hist = across_hist(k)
        else:
            across = eng.union(group_sets, cs=union_cs)
            hist = eng.histogram(across, cx=hist_cx)
        across_hists[k] = hist
        if write_hists:
            write_hist_txt(
                os.path.join(out_dir, f"step_8/k_{k}/all_datasets_k{k}_hist.txt"),
                hist,
                cx=hist_cx,
            )

    # --- step_5 CSV (row order: k outer, group inner, like the reference's
    # expand(k_len=..., num=...) input ordering, exp_type_1.smk:195) ---
    num_members = {num: len(groups[num]) for num in group_nums}
    all_metrics = []
    for k in k_values:
        for num in group_nums:
            hist = (
                read_hist_txt(os.path.join(out_dir, f"step_4/k_{k}/dataset_{num}/dataset_{num}_k{k}_hist.txt"))
                if write_hists
                else within_hists[(k, num)]
            )
            row = [f"group_{num}", str(k)] + summarize_histogram_type1(
                hist, num_members[num], False, int(k)
            )
            all_metrics.append(row)
    append_group_normalization(all_metrics, [f"group_{num}" for num in group_nums])
    step5 = os.path.join(out_dir, "step_5/within_datasets_analysis.csv")
    write_csv_rows(step5, STEP5_HEADER, all_metrics)

    # --- step_9 CSV ---
    all_metrics = []
    for k in k_values:
        hist = (
            read_hist_txt(os.path.join(out_dir, f"step_8/k_{k}/all_datasets_k{k}_hist.txt"))
            if write_hists
            else across_hists[k]
        )
        row = ["full_group", str(k)] + summarize_histogram_type1(
            hist, len(group_nums), True, int(k)
        )
        all_metrics.append(row)
    values = [row[8] for row in all_metrics]
    max_ratio = max(values)
    for row in all_metrics:
        row.append(round(row[8] / max_ratio, 4))
    step9 = os.path.join(out_dir, "step_9/across_datasets_analysis.csv")
    write_csv_rows(step9, STEP9_HEADER, all_metrics)

    return {"step_5": step5, "step_9": step9}
