"""Golden end-to-end test: exp1 CSVs vs an oracle-computed pipeline."""

import os

import pytest

from conftest import random_dna
from khoice_tpu.oracle.pipelines import oracle_exp1_csvs
from khoice_tpu.pipelines.exp1 import STEP5_HEADER, run_exp1


def make_groups(rng, n_groups=3, genomes_per_group=3, glen=400):
    groups = {}
    base = random_dna(rng, glen)
    for num in range(1, n_groups + 1):
        genomes = []
        for _ in range(genomes_per_group):
            # group members share a core with mutations; groups share `base`
            seq = list(base)
            for _ in range(glen // 10 + num * 7):
                seq[rng.randrange(glen)] = "ACGT"[rng.randrange(4)]
            genomes.append(["".join(seq), random_dna(rng, glen // 2)])
        groups[num] = genomes
    return groups


@pytest.mark.parametrize("fused", [True, False])
def test_exp1_golden(rng, tmp_path, fused):
    groups = make_groups(rng)
    ks = [5, 9, 12]
    out = run_exp1(groups, ks, str(tmp_path / "engine"), fused=fused)
    g5, g9 = oracle_exp1_csvs(groups, ks, str(tmp_path / "oracle"))

    engine5 = open(out["step_5"], "rb").read()
    engine9 = open(out["step_9"], "rb").read()
    assert engine5 == open(g5, "rb").read()
    assert engine9 == open(g9, "rb").read()
    # sanity: CSV actually has the expected shape
    lines = engine5.decode().strip().split("\n")
    assert len(lines) == 1 + len(ks) * len(groups)
    assert lines[0].strip() == STEP5_HEADER.strip()


def test_exp1_streaming_dispatch_on_budget(rng, tmp_path, monkeypatch):
    """run_exp1 dispatches groups beyond the device budget to the
    bounded-memory streaming sweep automatically (the `kmc -m64` role,
    reference exp_type_1.smk:163) — same CSV bytes, streaming path
    actually taken."""
    from khoice_tpu.engine import streaming as st

    calls = []
    real = st.occurrence_histograms_sweep_streaming

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(st, "occurrence_histograms_sweep_streaming", spy)

    groups = make_groups(rng, n_groups=2, genomes_per_group=2, glen=300)
    ks = [5, 9, 12]
    big = run_exp1(groups, ks, str(tmp_path / "incore"), fused=True,
                   device_budget_bytes=1 << 40)
    assert not calls, "in-core budget must not stream"
    small = run_exp1(groups, ks, str(tmp_path / "stream"), fused=True,
                     device_budget_bytes=1 << 14)
    assert calls, "tiny budget must dispatch to the streaming sweep"
    for key in ("step_5", "step_9"):
        assert open(small[key], "rb").read() == open(big[key], "rb").read()


def test_exp1_golden_all_key_widths(rng, tmp_path):
    """Byte-exact step_5/step_9 across EVERY key-width class: 1-word
    (k<=15), 2-word packed (k<=31), 3-word (k<=47) and 4-word (k=49)
    keys, through the fused master-sweep path — a word-relayout bug in
    any class breaks the file bytes."""
    groups = make_groups(rng, n_groups=2, genomes_per_group=2, glen=300)
    ks = [5, 12, 21, 31, 33, 45, 49]
    out = run_exp1(groups, ks, str(tmp_path / "engine"), fused=True)
    g5, g9 = oracle_exp1_csvs(groups, ks, str(tmp_path / "oracle"))

    engine5 = open(out["step_5"], "rb").read()
    engine9 = open(out["step_9"], "rb").read()
    assert engine5 == open(g5, "rb").read()
    assert engine9 == open(g9, "rb").read()
    # sanity: CSV actually has the expected shape
    lines = engine5.decode().strip().split("\n")
    assert len(lines) == 1 + len(ks) * len(groups)
    assert lines[0].strip() == STEP5_HEADER.strip()
