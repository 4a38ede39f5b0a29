"""Sharded fused occurrence histogram vs single-device path and oracle."""

import numpy as np
import pytest

from conftest import cpu_devices, random_dna
from khoice_tpu import oracle
from khoice_tpu.dist import make_mesh, sharded_occurrence_histogram
from khoice_tpu.engine.occurrence import occurrence_histogram
from khoice_tpu.io import encode_records
from khoice_tpu.pipelines.exp1 import run_exp1


def make_members(rng, g=4, glen=600):
    base = random_dna(rng, glen)
    out = []
    for i in range(g):
        seq = list(base)
        for _ in range(40 * (i + 1)):
            seq[rng.randrange(glen)] = "ACGT"[rng.randrange(4)]
        out.append("".join(seq))
    return out


@pytest.mark.parametrize("k", [11, 31])
def test_sharded_occurrence_matches_single(rng, k):
    members = make_members(rng)
    codes = [encode_records([m]) for m in members]
    single = occurrence_histogram(codes, k, cs=5000, cx=64)
    for nd in (2, 8):
        mesh = make_mesh(devices=cpu_devices(nd))
        sh = sharded_occurrence_histogram(mesh, codes, k, cs=5000, cx=64)
        assert sh == single, f"nd={nd}"
    # and against the oracle
    od = oracle.union_sum(
        [oracle.set_counts(oracle.count_kmers([m], k), 1) for m in members], cs=5000
    )
    assert single == oracle.histogram(od, cx=64)


@pytest.mark.parametrize("k", [11, 31])
def test_sharded_occurrence_static_path(rng, k):
    members = make_members(rng)
    codes = [encode_records([m]) for m in members]
    single = occurrence_histogram(codes, k, cs=5000, cx=64)
    mesh = make_mesh(devices=cpu_devices(4))
    sh = sharded_occurrence_histogram(mesh, codes, k, cs=5000, cx=64, dynamic_k=False)
    assert sh == single


def test_sharded_dynamic_k_one_compile_per_class(rng):
    """A k sweep within one packed word class reuses ONE cached program
    (the SPMD path used to re-trace per call)."""
    from khoice_tpu.dist.occurrence import _dyn_occ_fn

    members = make_members(rng)
    codes = [encode_records([m]) for m in members]
    mesh = make_mesh(devices=cpu_devices(4))
    _dyn_occ_fn.cache_clear()
    for k in (13, 17, 21, 25, 28):  # all in the kmax=28 packed class
        sh = sharded_occurrence_histogram(mesh, codes, k, cs=5000, cx=64)
        assert sh == occurrence_histogram(codes, k, cs=5000, cx=64)
    assert _dyn_occ_fn.cache_info().misses == 1
    assert _dyn_occ_fn.cache_info().hits == 4


def test_sharded_skewed_data_no_retry(rng):
    """Adversarially skewed keys (~90% poly-A prefix) must not overflow:
    data-sampled split points adapt where the uniform CDF would not."""
    from khoice_tpu.dist.occurrence import _dyn_occ_fn

    skew = ["A" * 2500 + random_dna(rng, 260) for _ in range(3)]
    codes = [encode_records([m]) for m in skew]
    mesh = make_mesh(devices=cpu_devices(8))
    _dyn_occ_fn.cache_clear()
    sh = sharded_occurrence_histogram(mesh, codes, 13, cs=5000, cx=16)
    assert sh == occurrence_histogram(codes, 13, cs=5000, cx=16)
    # one miss == no bucket-capacity retry (a retry doubles bucket_cap and
    # would add a second cache entry)
    assert _dyn_occ_fn.cache_info().misses == 1


@pytest.mark.heavy
def test_cli_exp1_mesh_shards(rng, tmp_path, monkeypatch):
    """--mesh-shards N drives the SPMD path end-to-end through the CLI."""
    import gzip

    from khoice_tpu.cli import main as cli_main

    db = tmp_path / "db"
    for d in (1, 2):
        dd = db / f"dataset_{d}"
        dd.mkdir(parents=True)
        for g in range(2):
            seq = random_dna(rng, 400)
            with gzip.open(dd / f"g{g}.fna.gz", "wt") as fd:
                fd.write(f">g{d}_{g}\n{seq}\n")
    single = tmp_path / "single"
    sharded = tmp_path / "sharded"
    args = ["run", "--exp-type", "1", "--database-root", str(db),
            "--k-values", "11,21"]
    assert cli_main(args + ["--work-root", str(single)]) == 0
    assert cli_main(args + ["--work-root", str(sharded), "--mesh-shards", "8"]) == 0
    for rel in ("step_5/within_datasets_analysis.csv",
                "step_9/across_datasets_analysis.csv"):
        assert (single / rel).read_bytes() == (sharded / rel).read_bytes()


@pytest.mark.heavy
def test_exp1_sharded_csvs_match(rng, tmp_path):
    groups = {
        1: [[m] for m in make_members(rng, g=2)],
        2: [[m] for m in make_members(rng, g=3)],
    }
    # 4 ks -> the SPMD shared-sort sweep path (dist/ksweep.py); a 2-k grid
    # would fall back to the per-k sharded program
    ks = [7, 11, 15, 21]
    from khoice_tpu.engine.ksweep import plan_sweep

    assert plan_sweep(ks, 3)[0], "k grid should take the sweep path"
    out_single = run_exp1(groups, ks, str(tmp_path / "single"))
    mesh = make_mesh(devices=cpu_devices(8))
    out_sharded = run_exp1(groups, ks, str(tmp_path / "sharded"), mesh=mesh)
    for key in ("step_5", "step_9"):
        assert open(out_single[key], "rb").read() == open(out_sharded[key], "rb").read()
