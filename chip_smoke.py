#!/usr/bin/env python3
"""Proof that khoice runs on an NVIDIA GPU: the exp1 main path end to end.

Runs in ONE process (a second JAX process on the card would fail for want
of memory) and refuses to run without a GPU: there is no CPU fallback.

Phases (any failure exits non-zero and prints no result line):

1. small world: exp1 and exp2 through the CLI on a seeded 2 x 3 x ~50 kb
   world (N runs, a poly-A block, plasmid records) over a k grid spanning
   all four key-word classes; the CSVs must be byte-equal to the oracle
   builds (khoice_tpu/oracle/pipelines.py).
2. realistic exp1: the tools/gen_realistic_db.py world (4 datasets x 8
   genomes x 5 Mbp, seed 7) over the reference's full 30-point k grid
   through the CLI, cold and then warm; one group's shared-sort sweep
   must equal the per-k fused path at k = 15, 31, 49; the sweep's
   extract / sort / scan shares of device time on the across-groups
   master class.
3. classification sweep at size: exp2's pivot-vs-rest sweep on one
   realistic group equals the per-k table path at 3 ks.
4. streaming: phase 2 again under a device budget that forces the
   bounded-memory sweep for every group; CSVs byte-equal to phase 2's.

--four-cards runs only the mesh path instead: exp1 through the CLI with
--mesh-shards 4 on the realistic world, byte-equal to a one-card run of
the same world in the same process, then __graft_entry__.dryrun_multichip(4).

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

FULL_GRID = list(range(7, 31)) + [34, 37, 40, 43, 46, 49]
# 1-word (5, 12), 2-word (21, 31), 3-word (33, 45) and 4-word (49) keys;
# enough ks that one packed master sort serves the grid
SMALL_KS = [5, 12, 21, 31, 33, 45, 49]
CROSS_KS = (15, 31, 49)
STREAM_BUDGET_GB = 2.0


def log(msg: str) -> None:
    print(msg, flush=True)


def _peak_bytes() -> int:
    import jax

    return int((jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use", 0))


def _cli(args) -> None:
    from khoice_tpu.cli import main

    rc = main(["run"] + [str(a) for a in args])
    if rc != 0:
        raise RuntimeError(f"CLI returned {rc} for {args}")


def _same_bytes(a: str, b: str) -> None:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError(f"{a} differs from {b}")


def _groups(db):
    """{num: [genome as list of record seqs]} in the CLI's genome order."""
    return {num: [db[num][name] for name in sorted(db[num])] for num in db}


# ---------------------------------------------------------------------------
# worlds
# ---------------------------------------------------------------------------


def small_world(seed: int = 11, datasets: int = 2, genomes: int = 3,
                length: int = 50_000):
    """Seeded {num: {name: [record seqs]}}: per dataset a mutated copy of a
    shared core per genome, with an N run, a poly-A block and a short
    plasmid record."""
    import numpy as np

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = acgt[rng.integers(0, 4, length)]
    db = {}
    for num in range(1, datasets + 1):
        db[num] = {}
        for g in range(genomes):
            seq = base.copy()
            pos = rng.integers(0, length, length // 50 + 300 * num + 97 * g)
            seq[pos] = acgt[rng.integers(0, 4, pos.shape[0])]
            n0 = int(rng.integers(0, length - 200))
            seq[n0 : n0 + int(rng.integers(20, 200))] = ord("N")
            a0 = int(rng.integers(0, length - 2000))
            seq[a0 : a0 + 2000] = ord("A")
            plasmid = acgt[rng.integers(0, 4, int(rng.integers(1000, 3000)))]
            db[num][f"genome_{num}_{g}"] = [seq.tobytes().decode(),
                                            plasmid.tobytes().decode()]
    return db


def write_database(db, root: str) -> str:
    """Write {num: {name: [records]}} as root/dataset_{num}/{name}.fna.gz."""
    from khoice_tpu.io.fasta import FastaRecord, write_fasta

    for num, genomes in db.items():
        ddir = os.path.join(root, f"dataset_{num}")
        os.makedirs(ddir, exist_ok=True)
        for name, recs in genomes.items():
            write_fasta(
                os.path.join(ddir, f"{name}.fna.gz"),
                [FastaRecord(f"{name}_{i}", s) for i, s in enumerate(recs)],
            )
    return root


def realistic_world(root: str, mbp: float = 5.0) -> str:
    """The tools/gen_realistic_db.py world (4 x 8 genomes, seed 7)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import gen_realistic_db

    gen_realistic_db.generate(root, datasets=4, genomes=8, mbp=mbp, seed=7,
                              verbose=False)
    return root


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_small_world(work: str) -> dict:
    """exp1 + exp2 through the CLI on the small world, byte-equal to the
    oracle builds."""
    from khoice_tpu.engine.ksweep import plan_sweep
    from khoice_tpu.oracle.pipelines import oracle_exp1_csvs, oracle_exp2_csvs
    from khoice_tpu.pipelines.exp0 import load_database_dir

    db = small_world()
    classes, rest = plan_sweep(SMALL_KS, 3)
    if rest or len(classes) != 1:
        raise AssertionError(f"small grid must take the master sweep: {classes} {rest}")
    dbroot = write_database(db, os.path.join(work, "db"))
    kv = ",".join(map(str, SMALL_KS))
    t0 = time.perf_counter()
    _cli(["--exp-type", 1, "--database-root", dbroot,
          "--work-root", os.path.join(work, "exp1"), "--k-values", kv])
    t_exp1 = time.perf_counter() - t0
    groups = _groups(load_database_dir(dbroot))
    g5, g9 = oracle_exp1_csvs(groups, SMALL_KS, os.path.join(work, "oracle1"))
    _same_bytes(os.path.join(work, "exp1/step_5/within_datasets_analysis.csv"), g5)
    _same_bytes(os.path.join(work, "exp1/step_9/across_datasets_analysis.csv"), g9)

    w2 = os.path.join(work, "exp2")
    t0 = time.perf_counter()
    _cli(["--exp-type", 2, "--database-root", dbroot, "--work-root", w2,
          "--k-values", kv, "--kmers-per-dataset", 2000])
    t_exp2 = time.perf_counter() - t0
    db2 = load_database_dir(dbroot)
    pivots, rest_of = {}, {}
    for num in db2:
        troot = os.path.join(w2, "trial_1")
        with open(os.path.join(troot, f"exp0_pivot_genomes/dataset_{num}/pivot_name.txt")) as fd:
            pivots[num] = db2[num][fd.read().strip()]
        with open(os.path.join(troot, f"exp0_nonpivot_genomes/dataset_{num}/nonpivot_names.txt")) as fd:
            rest_of[num] = [db2[num][x.strip()] for x in fd if x.strip()]
    os.makedirs(os.path.join(work, "oracle2"))
    gw, ga = oracle_exp2_csvs(pivots, rest_of, SMALL_KS, os.path.join(work, "oracle2"))
    _same_bytes(os.path.join(w2, "within_dataset_analysis_type_2/within_dataset_analysis.csv"), gw)
    _same_bytes(os.path.join(w2, "across_dataset_analysis_type_2/across_dataset_analysis.csv"), ga)
    return {"exp1_s": t_exp1, "exp2_s": t_exp2, "ks": SMALL_KS}


def _stage_shares(member_codes) -> dict:
    """Device time of the sweep's extract, sort and scan on the master
    class of `member_codes`, from separately jitted stage programs (warm,
    best of 3, each ended by block_until_ready)."""
    import jax
    import jax.numpy as jnp

    from khoice_tpu.engine.ksweep import (
        MASK_MEMBERS_OCC,
        _extract_fwd_sweep,
        _sweep_class_fn,
        _sweep_doubled,
        plan_sweep,
    )
    from khoice_tpu.engine.occurrence import pack_members_device

    n = len(member_codes)
    (kmax, KW, cks, packed), = plan_sweep(FULL_GRID, n, MASK_MEMBERS_OCC)[0]
    codes, gids = pack_members_device(member_codes)

    @jax.jit
    def extract(c, g):
        rc = jnp.where(c < 4, c ^ 3, c)[::-1]
        fwd, pay = _extract_fwd_sweep(jnp.concatenate([c, rc]),
                                      jnp.concatenate([g, g[::-1]]),
                                      kmax, KW, packed=packed)
        return fwd, pay

    @jax.jit
    def extract_sort(c, g):
        return _sweep_doubled(c, g, kmax, KW, packed)

    def best(f):
        jax.block_until_ready(f())
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(f())
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t_e = best(lambda: extract(codes, gids))
    t_es = best(lambda: extract_sort(codes, gids))
    t_all = best(lambda: _sweep_class_fn(codes, gids, cks, kmax, KW, n, 5000, packed))
    return {
        "elements": 2 * int(codes.shape[0]), "kmax": kmax, "key_words": KW,
        "ks": len(cks), "extract_s": t_e, "sort_s": t_es - t_e,
        "scan_s": t_all - t_es, "sweep_s": t_all,
        "sort_share": (t_es - t_e) / t_all, "scan_share": (t_all - t_es) / t_all,
    }


def phase_realistic_exp1(work: str, dbroot: str) -> dict:
    """exp1 over the full grid through the CLI, cold then warm; sweep vs
    per-k at CROSS_KS on group 1; stage shares on the across-groups
    class."""
    import numpy as np

    from khoice_tpu.engine.ksweep import occurrence_histograms_sweep_packed
    from khoice_tpu.engine.occurrence import (
        occurrence_histogram_packed,
        pack_members_device,
    )
    from khoice_tpu.io.packing import encode_records
    from khoice_tpu.pipelines.exp0 import load_database_dir

    out = {}
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        _cli(["--exp-type", 1, "--database-root", dbroot,
              "--work-root", os.path.join(work, f"exp1_{run}")])
        out[f"{run}_s"] = time.perf_counter() - t0
        out[f"{run}_peak_bytes"] = _peak_bytes()
    for f in ("step_5/within_datasets_analysis.csv",
              "step_9/across_datasets_analysis.csv"):
        _same_bytes(os.path.join(work, "exp1_cold", f),
                    os.path.join(work, "exp1_warm", f))

    groups = _groups(load_database_dir(dbroot))
    codes = [encode_records(g) for g in groups[1]]
    packed = pack_members_device(codes)
    grid = sorted(set(FULL_GRID) | set(CROSS_KS))
    sweep = occurrence_histograms_sweep_packed(packed, len(codes), grid, cx=64)
    for k in CROSS_KS:
        want = occurrence_histogram_packed(packed, len(codes), k, cx=64)
        if sweep[k] != want:
            raise AssertionError(f"sweep != per-k at k={k}: {sweep[k][:8]} vs {want[:8]}")
    out["cross_checked_ks"] = list(CROSS_KS)

    across = [
        np.concatenate([np.concatenate([encode_records(g), np.full(1, 4, np.uint8)])
                        for g in groups[num]])
        for num in sorted(groups)
    ]
    out["stages"] = _stage_shares(across)
    return out


def phase_classify(dbroot: str) -> dict:
    """exp2's pivot-vs-rest sweep on realistic group 1 (genome 1 as the
    pivot) vs the per-k table path at CROSS_KS."""
    import numpy as np

    from khoice_tpu.engine.ksweep_classify import pivot_rest_counts_sweep
    from khoice_tpu.engine.session import KmerEngine
    from khoice_tpu.io.packing import encode_records
    from khoice_tpu.pipelines.exp0 import load_database_dir
    from khoice_tpu.pipelines.exp2 import _hists_from_counts, _per_k_pair

    groups = _groups(load_database_dir(dbroot))
    members = [encode_records(g) for g in groups[1]]
    t0 = time.perf_counter()
    counts, rem = pivot_rest_counts_sweep(members, CROSS_KS)
    t = time.perf_counter() - t0
    if rem or sorted(counts) != list(CROSS_KS):
        raise AssertionError(f"classify sweep fell back to the per-k path for {rem}")
    eng = KmerEngine()
    for k in CROSS_KS:
        got = _hists_from_counts(counts[k], 64)
        want = _per_k_pair(eng, members[0], members[1:], k, 5000, 255, 64)
        want = tuple(np.asarray(h).tolist() for h in want)
        if got != want:
            raise AssertionError(f"classify sweep != per-k at k={k}")
    return {"members": len(members), "sweep_s": t, "ks": list(CROSS_KS)}


def phase_streaming(work: str, dbroot: str, incore_root: str,
                    budget_gb: float = STREAM_BUDGET_GB) -> dict:
    """exp1 under a device budget that streams every group; CSVs equal the
    in-core run's."""
    from khoice_tpu.engine.streaming import incore_sweep_bytes
    from khoice_tpu.pipelines.exp0 import load_database_dir

    groups = _groups(load_database_dir(dbroot))
    budget = int(budget_gb * 2**30)
    for num, genomes in groups.items():
        total = sum(sum(len(r) + 1 for r in g) + 1 for g in genomes)
        if incore_sweep_bytes(total, FULL_GRID, len(genomes)) <= budget:
            raise AssertionError(f"group {num} would not stream at {budget_gb} GB")
    t0 = time.perf_counter()
    _cli(["--exp-type", 1, "--database-root", dbroot,
          "--work-root", os.path.join(work, "exp1_stream"),
          "--device-budget-gb", budget_gb])
    t = time.perf_counter() - t0
    for f in ("step_5/within_datasets_analysis.csv",
              "step_9/across_datasets_analysis.csv"):
        _same_bytes(os.path.join(work, "exp1_stream", f),
                    os.path.join(incore_root, f))
    return {"budget_gb": budget_gb, "wall_s": t}


def phase_four_cards(work: str, dbroot: str) -> dict:
    """exp1 with --mesh-shards 4 vs a one-card run of the same world, then
    the sharded algebra / classify / vote dry run on the 4 cards."""
    sys.path.insert(0, REPO)
    import __graft_entry__

    out = {}
    for label, extra in (("one_card", []), ("mesh4", ["--mesh-shards", 4])):
        t0 = time.perf_counter()
        _cli(["--exp-type", 1, "--database-root", dbroot,
              "--work-root", os.path.join(work, label)] + extra)
        out[f"{label}_s"] = time.perf_counter() - t0
    for f in ("step_5/within_datasets_analysis.csv",
              "step_9/across_datasets_analysis.csv"):
        _same_bytes(os.path.join(work, "mesh4", f), os.path.join(work, "one_card", f))
    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    out["dryrun_multichip_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------


def _card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return r.stdout.strip()


def _run_phase(name: str, fn, *args) -> dict:
    t0 = time.perf_counter()
    res = fn(*args)
    log(f"[{name}] ok in {time.perf_counter() - t0:.2f} s: {json.dumps(res)}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh path and its 1-card comparison")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX sees {devices[0].platform}); refusing "
              "to run", file=sys.stderr)
        return 2
    want = 4 if args.four_cards else 1
    if len(devices) < want:
        print(f"chip_smoke: {want} GPUs needed, {len(devices)} found",
              file=sys.stderr)
        return 2

    from khoice_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    log(_card_line())
    log(f"jax {jax.__version__}; devices {[d.device_kind for d in devices]}")
    n_cached = sum(len(f) for _, _, f in os.walk(cache)) if os.path.isdir(cache) else 0
    log(f"compile cache {cache} ({n_cached} entries at start)")

    work = tempfile.mkdtemp(prefix="khoice-smoke-")
    try:
        t0 = time.perf_counter()
        dbroot = realistic_world(os.path.join(work, "world"))
        log(f"[world] realistic 4 x 8 x 5 Mbp generated in {time.perf_counter() - t0:.2f} s")
        if args.four_cards:
            _run_phase("four_cards", phase_four_cards, os.path.join(work, "p4c"), dbroot)
        else:
            _run_phase("1 small_world", phase_small_world, os.path.join(work, "p1"))
            p2 = os.path.join(work, "p2")
            _run_phase("2 realistic_exp1", phase_realistic_exp1, p2, dbroot)
            _run_phase("3 classify", phase_classify, dbroot)
            _run_phase("4 streaming", phase_streaming, os.path.join(work, "p4"),
                       dbroot, os.path.join(p2, "exp1_cold"))
        log(f"peak_bytes_in_use {_peak_bytes()}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
