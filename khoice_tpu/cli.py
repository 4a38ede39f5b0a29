"""Command-line interface: `python -m khoice_tpu run --exp-type N ...`.

Replaces the reference's `snakemake --cores N --config WORK_ROOT=...
EXP_TYPE=...` entry point (reference README.md:36-42). Inputs follow the
reference's database layout (`database_root/dataset_{i}/*.fna.gz`,
src/download_genomes.py:252-261) and exp0's trial_{t}/ layout; outputs are
written under --work-root with the reference's directory names so resumed
runs skip satisfied stages (runtime/driver.py).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

from .config import KhoiceConfig
from .io.fasta import read_fasta
from .runtime.driver import Driver, Stage
from .utils.compile_cache import enable_compile_cache
from .utils.logging import get_logger

log = get_logger("khoice.cli")


def _load_datasets(database_root: str) -> Dict[int, Dict[str, List[str]]]:
    from .pipelines.exp0 import load_database_dir

    db = load_database_dir(database_root)
    if not db:
        raise SystemExit(f"no dataset_N directories under {database_root}")
    return db


def _trial_root(cfg: KhoiceConfig, root: str) -> str:
    return os.path.join(root, f"trial_{cfg.curr_trial}")


def _ensure_exp0(cfg: KhoiceConfig, db, root: str) -> dict:
    """Run exp0 for the current trial unless its outputs already exist."""
    from .pipelines.exp0 import run_exp0, READ_TYPES

    # key resume on exp0's LAST output (the trial summary): a run that died
    # mid-exp0 leaves earlier directories behind, and loading from those
    # partial outputs fails on missing read files
    marker = os.path.join(
        root, "trial_summaries", f"trial_{cfg.curr_trial}_summary.txt"
    )
    if os.path.isfile(marker):
        return _load_exp0(cfg, db, root)
    return run_exp0(db, cfg, cfg.curr_trial, root)


def _load_exp0(cfg: KhoiceConfig, db, root: str) -> dict:
    """Re-load a previously produced exp0 trial layout."""
    troot = _trial_root(cfg, root)
    pivots, nonpivots, reads = {}, {}, {}
    for num in sorted(db):
        with open(os.path.join(troot, f"exp0_pivot_genomes/dataset_{num}/pivot_name.txt")) as fd:
            pivots[num] = fd.read().strip()
        with open(os.path.join(troot, f"exp0_nonpivot_genomes/dataset_{num}/nonpivot_names.txt")) as fd:
            nonpivots[num] = [x.strip() for x in fd if x.strip()]
        for rt in ("illumina", "ont"):
            path = os.path.join(troot, f"exp0_pivot_reads/dataset_{num}/{rt}/pivot_{num}_subset.fa")
            reads[(num, rt)] = [r.seq for r in read_fasta(path)]
    return {"pivots": pivots, "nonpivots": nonpivots, "reads": reads}


def cmd_run(args) -> int:
    cfg = (
        KhoiceConfig.from_yaml(args.config)
        if args.config
        else KhoiceConfig()
    )
    if args.work_root:
        cfg.work_root = args.work_root
    if args.database_root:
        cfg.database_root = args.database_root
    if args.exp_type is not None:
        cfg.exp_type = args.exp_type
    if args.k_values:
        cfg.k_values = [int(x) for x in args.k_values.split(",")]
    if args.num_datasets:
        cfg.num_datasets = args.num_datasets
    if args.kmers_per_dataset:
        cfg.kmers_per_dataset = args.kmers_per_dataset
    if getattr(args, "mesh_shards", None):
        cfg.mesh_shards = args.mesh_shards
    if getattr(args, "trials", None):
        cfg.num_trials = args.trials
    if getattr(args, "device_budget_gb", None):
        cfg.device_budget_gb = args.device_budget_gb

    db = _load_datasets(cfg.database_root)

    # Multi-trial fan-out: the reference fans exp0 over NUM_TRIALS via the
    # trial wildcard (prepare_data.smk:42-117) and runs each downstream
    # experiment per CURR_TRIAL. `--trials N` loops trials here. exp0/exp6
    # outputs are trial-keyed already; the other exp0-dependent experiments
    # write per-trial subroots so trials don't clobber each other (the
    # reference's per-trial WORK_ROOT convention).
    if getattr(args, "trials", None) and args.trials > 1:
        if cfg.exp_type == 1:
            # exp1 has no trial axis (no pivot/read randomness); running it
            # N times would just repeat identical work
            log.warning(
                "--trials=%d ignored for exp_type=1 (exp1 is deterministic "
                "over genomes; the reference's trial axis only exists for "
                "pivot/read experiments)", args.trials,
            )
        else:
            base_root = cfg.work_root
            rc = 0
            for t in range(1, args.trials + 1):
                cfg.curr_trial = t
                cfg.work_root = (
                    base_root
                    if cfg.exp_type in (0, 6)
                    else os.path.join(base_root, f"trial_{t}_results")
                )
                log.info("=== trial %d/%d ===", t, args.trials)
                rc = max(rc, _run_one(cfg, args, db, exp0_root=base_root))
            cfg.work_root = base_root
            return rc
    return _run_one(cfg, args, db, exp0_root=cfg.work_root)


def _run_one(cfg: KhoiceConfig, args, db, exp0_root: str) -> int:
    driver = Driver(cfg.work_root, force=args.force)
    et = cfg.exp_type
    log.info("exp_type=%d datasets=%d k-grid=%d points", et, len(db), len(cfg.k_values))

    # SPMD over the key-range mesh axis: exp1's sweep, the exp2/3/4
    # classification sweeps, and exp6's read voting all shard (the
    # reference fans every experiment over cores the same way,
    # exp_type_2.smk:354-380, exp_type_6.smk:264-319)
    mesh = None
    if cfg.mesh_shards > 1 and et in (1, 2, 3, 4, 6):
        from .dist.mesh import make_mesh

        mesh = make_mesh(cfg.mesh_shards)
        log.info("SPMD over %d devices (kv key-range axis)", cfg.mesh_shards)

    def genomes_of(num):
        return [db[num][name] for name in sorted(db[num])]

    if et == 0:
        driver.run([Stage(
            name="exp0",
            outputs=[os.path.join(exp0_root, f"trial_summaries/trial_{cfg.curr_trial}_summary.txt")],
            fn=lambda: _ensure_exp0(cfg, db, exp0_root),
        )])
    elif et == 1:
        from .pipelines.exp1 import run_exp1

        groups = {num: genomes_of(num) for num in db}
        driver.run([Stage(
            name="exp1",
            outputs=[
                os.path.join(cfg.work_root, "step_5/within_datasets_analysis.csv"),
                os.path.join(cfg.work_root, "step_9/across_datasets_analysis.csv"),
            ],
            fn=lambda: run_exp1(groups, cfg.k_values, cfg.work_root,
                                union_cs=cfg.union_cs, count_cs=cfg.count_cs,
                                hist_cx=cfg.hist_cx, mesh=mesh,
                                device_budget_bytes=(
                                    int(cfg.device_budget_gb * 2**30)
                                    if cfg.device_budget_gb else None
                                )),
        )])
    elif et in (2, 3, 4, 5, 6, 7, 8):
        exp0 = _ensure_exp0(cfg, db, exp0_root)
        pivots = {num: db[num][exp0["pivots"][num]] for num in db}
        nonpivot_genomes = {
            num: [db[num][n] for n in exp0["nonpivots"][num]] for num in db
        }
        if et == 2:
            from .pipelines.exp2 import run_exp2

            driver.run([Stage(
                name="exp2",
                outputs=[os.path.join(cfg.work_root, "within_dataset_analysis_type_2/within_dataset_analysis.csv")],
                fn=lambda: run_exp2(pivots, nonpivot_genomes, cfg.k_values, cfg.work_root,
                                    union_cs=cfg.union_cs, count_cs=cfg.count_cs,
                                    hist_cx=cfg.hist_cx, mesh=mesh),
            )])
        elif et == 3:
            from .pipelines.exp3 import run_exp3, simulate_exp3_reads

            reads = simulate_exp3_reads(pivots, cfg.kmers_per_dataset, seed=cfg.read_sim_seed)
            driver.run([Stage(
                name="exp3",
                outputs=[os.path.join(cfg.work_root, "final_analysis_type3/final_analysis_type3.csv")],
                fn=lambda: run_exp3(reads, nonpivot_genomes, cfg.k_values, cfg.work_root,
                                    union_cs=cfg.union_cs, count_cs=cfg.count_cs,
                                    mesh=mesh),
            )])
        elif et == 4:
            from .pipelines.exp4 import run_exp4

            rest = dict(nonpivot_genomes)
            if not cfg.out_pivot:  # in-pivot adds the pivot to its own group
                rest = {num: rest[num] + [pivots[num]] for num in rest}
            driver.run([Stage(
                name="exp4",
                outputs=[os.path.join(cfg.work_root, "accuracies_type_4/accuracy_values.csv")],
                fn=lambda: run_exp4(pivots, rest, cfg.k_values, cfg.work_root,
                                    count_cs=cfg.count_cs, union_cs=cfg.union_cs,
                                    mesh=mesh),
            )])
        elif et == 6:
            from .pipelines.exp6 import run_exp6, READ_TYPE_LABEL

            rest = dict(nonpivot_genomes)
            if not cfg.out_pivot:
                rest = {num: rest[num] + [pivots[num]] for num in rest}
            stages = []
            for rt in ("illumina", "ont"):
                label = READ_TYPE_LABEL[rt]
                reads_rt = {num: exp0["reads"][(num, rt)] for num in db}
                stages.append(Stage(
                    name=f"exp6_{rt}",
                    outputs=[os.path.join(cfg.work_root, f"trial_{cfg.curr_trial}_{label}_acc.csv")],
                    fn=(lambda reads_rt=reads_rt, rt=rt: run_exp6(
                        reads_rt, rest, cfg.k_values, cfg.work_root,
                        read_type=rt, trial=cfg.curr_trial, seed=cfg.seed,
                        count_cs=cfg.count_cs, union_cs=cfg.union_cs,
                        mesh=mesh)),
                ))
            driver.run(stages)
        elif et == 5:
            from .pipelines.exp5 import run_exp5

            driver.run([Stage(
                name="exp5",
                outputs=[os.path.join(cfg.work_root, "output_type_5/mems/confusion_matrix.csv")],
                fn=lambda: run_exp5(pivots, nonpivot_genomes, cfg.work_root,
                                    threshold=cfg.threshold, seed=cfg.seed),
            )])
        elif et == 7:
            from .pipelines.exp7 import run_exp7

            # the reference fans exp7 over BOTH read types and gathers
            # four trial CSVs (exp_type_7.smk:36-47,284-292)
            reads7 = {
                rt: {num: exp0["reads"][(num, rt)] for num in db}
                for rt in ("illumina", "ont")
            }
            outputs7 = [
                os.path.join(
                    cfg.work_root,
                    f"final_output_type_7/trial_{cfg.curr_trial}_{mt}_{rt}.csv",
                )
                for mt in ("mems", "half_mems")
                for rt in ("illumina", "ont")
            ] + [
                os.path.join(
                    cfg.work_root, f"output_type_7/{mt}/{rt}/confusion_matrix.csv"
                )
                for mt in ("mems", "half_mems")
                for rt in ("illumina", "ont")
            ]
            driver.run([Stage(
                name="exp7",
                outputs=outputs7,
                fn=lambda: run_exp7(reads7, nonpivot_genomes, cfg.work_root,
                                    threshold=cfg.threshold, seed=cfg.seed,
                                    trial=cfg.curr_trial),
            )])
        elif et == 8:
            from .pipelines.exp8 import run_exp8, simulate_exp8_reads

            # exp8 simulates its OWN reads from each pivot (2x Illumina +
            # depth-30 ONT, first-N subset; exp_type_8.smk:85-135) — it
            # does not reuse exp0's read sets
            reads8 = simulate_exp8_reads(
                pivots, cfg.num_reads_per_dataset, seed=cfg.read_sim_seed
            )
            # every (mem_type, t, read_type) CSV is a stage output, so a
            # run killed between thresholds is not wrongly "satisfied"
            outputs8 = [
                os.path.join(
                    cfg.work_root,
                    f"output_type_8/{mt}/t_{t}/{rt}/confusion_matrix.csv",
                )
                for mt in ("mems", "half_mems")
                for t in cfg.t_values
                for rt in ("illumina", "ont")
            ]
            driver.run([Stage(
                name="exp8",
                outputs=outputs8,
                fn=lambda: run_exp8(reads8, nonpivot_genomes, cfg.work_root,
                                    t_values=cfg.t_values, seed=cfg.seed),
            )])
    else:
        raise SystemExit(f"unknown exp type {et}")
    return 0


def main(argv=None) -> int:
    enable_compile_cache()
    parser = argparse.ArgumentParser(
        prog="khoice-tpu",
        description="k-mer discriminatory-power analysis engine (JAX)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    run_p = sub.add_parser("run", help="run an experiment pipeline")
    run_p.add_argument("--exp-type", type=int, default=None)
    run_p.add_argument("--config", default=None, help="YAML config (reference schema)")
    run_p.add_argument("--work-root", default=None)
    run_p.add_argument("--database-root", default=None)
    run_p.add_argument("--k-values", default=None, help="comma-separated k grid override")
    run_p.add_argument("--num-datasets", type=int, default=None)
    run_p.add_argument("--kmers-per-dataset", type=int, default=None)
    run_p.add_argument("--mesh-shards", type=int, default=None,
                       help="devices along the k-mer key-range mesh axis")
    run_p.add_argument("--device-budget-gb", type=float, default=None,
                       help="device memory budget for the exp1 sweep "
                            "(default: auto from the accelerator; groups "
                            "beyond it stream with bounded memory)")
    run_p.add_argument("--trials", type=int, default=None,
                       help="fan the experiment over trials 1..N (reference NUM_TRIALS)")
    run_p.add_argument("--force", action="store_true", help="ignore satisfied outputs")
    run_p.set_defaults(fn=cmd_run)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
