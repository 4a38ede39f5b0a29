"""Mechanical reference-wiring audit.

Parses the MOUNTED reference files at /root/reference and asserts this
repo's constants against the reference *text*, not a memory of it: CSV
header strings, histogram band overrides, k/t grids, simulator knobs,
union counter caps, and the exp6 trial-CSV schema. If the reference is
not mounted (e.g. CI elsewhere) the whole module skips.
"""

import os
import re

import pytest

REF = "/root/reference"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(REF, "workflow")),
    reason="reference repo not mounted",
)


def _read(rel: str) -> str:
    with open(os.path.join(REF, rel)) as fd:
        return fd.read()


def _fstring_header(text: str, anchor: str) -> str:
    """Reassemble an f-string header split across two source lines:
    out_fd.write(f"A," \n "B\\n") -> 'A,B\\n'."""
    m = re.search(
        r'write\(f"([^"]*' + re.escape(anchor) + r'[^"]*)"\s*\n\s*"([^"]*)"\)',
        text,
    )
    assert m, f"header anchored on {anchor!r} not found in reference"
    return (m.group(1) + m.group(2)).replace("\\n", "\n")


def test_step5_step9_headers_match_reference():
    from khoice_tpu.pipelines import exp1

    smk = _read("workflow/rules/exp_type_1.smk")
    step5 = _fstring_header(smk, "percent_25_or_less")
    step9 = _fstring_header(smk, "percent_2_to_5")
    assert exp1.STEP5_HEADER == step5  # exp_type_1.smk:200-201
    assert exp1.STEP9_HEADER == step9  # exp_type_1.smk:269-270


def test_exp2_headers_match_reference():
    from khoice_tpu.pipelines import exp2

    smk = _read("workflow/rules/exp_type_2.smk")
    within = _fstring_header(smk, "percent_75_or_more,")
    across = _fstring_header(smk, "percent_2_to_3")
    assert exp2.WITHIN_HEADER == within  # exp_type_2.smk:405-407
    assert exp2.ACROSS_HEADER == across  # exp_type_2.smk:522-524


def test_band_overrides_match_reference():
    """Across-group band overrides: [5,20] (exp1), [3,8] (exp2)."""
    import inspect

    from khoice_tpu.reports import metrics

    smk1 = _read("workflow/rules/exp_type_1.smk")
    smk2 = _read("workflow/rules/exp_type_2.smk")
    assert re.search(r"boundary_indices\s*=\s*\[5,\s*20\]", smk1)
    assert re.search(r"boundary_indices\s*=\s*\[3,\s*8\]", smk2)
    src = inspect.getsource(metrics)
    assert "b = [5, 20]" in src and "b = [3, 8]" in src
    # and the default fractional boundaries with the max(int(p*n),1) rule
    assert re.search(r"max\(int\(percent \* num_dataset_members", smk1)


def test_k_and_t_grids_match_snakefile():
    from khoice_tpu.config import default_k_values, default_t_values

    sf = _read("workflow/Snakefile")
    m = re.search(
        r"k_values = \[str\(x\) for x in range\((\d+), (\d+), (\d+)\)\]"
        r" \+ \[str\(x\) for x in range\((\d+), (\d+), (\d+)\)\]",
        sf,
    )
    assert m, "k grid definition not found in Snakefile"
    a = [int(x) for x in m.groups()]
    ref_k = list(range(a[0], a[1], a[2])) + list(range(a[3], a[4], a[5]))
    assert default_k_values() == ref_k  # Snakefile:36

    m = re.search(r"t_values = \[1\] \+ \[str\(x\) for x in range\((\d+), (\d+), (\d+)\)\]", sf)
    assert m, "t grid definition not found in Snakefile"
    b = [int(x) for x in m.groups()]
    assert default_t_values() == [1] + list(range(b[0], b[1], b[2]))  # Snakefile:39


def test_exp3_illumina_coverage_is_2x():
    smk = _read("workflow/rules/exp_type_3.smk")
    assert re.search(r"art_illumina[^\n]*-l 150 -f 2\.0", smk)  # exp_type_3.smk:129
    import inspect

    from khoice_tpu.pipelines import exp3

    assert "coverage=2.0" in inspect.getsource(exp3)


def test_exp0_simulator_knobs_match_prepare_data():
    import inspect

    from khoice_tpu.sim import reads as sim

    smk = _read("workflow/rules/prepare_data.smk")
    assert re.search(r"art_illumina[^\n]*-l 150 -f 10\.0", smk)  # prepare_data.smk:81
    assert re.search(
        r"pbsim --depth 10\.0[^\n]*\n[^\n]*--accuracy-mean 0\.95 "
        r"--length-min 900 --length-max 1100",
        smk,
    )  # prepare_data.smk:97-98
    sig = inspect.signature(sim.sim_illumina)
    assert sig.parameters["read_len"].default == 150
    assert sig.parameters["coverage"].default == 10.0
    sig = inspect.signature(sim.sim_ont)
    assert sig.parameters["depth"].default == 10.0
    assert sig.parameters["accuracy_mean"].default == 0.95
    assert sig.parameters["length_min"].default == 900
    assert sig.parameters["length_max"].default == 1100


def test_union_counter_cap_matches_complex_ops():
    """Every complex-ops writer in the reference passes -cs5000; the
    engine default must match (config.union_cs)."""
    from khoice_tpu.config import KhoiceConfig

    for rel in (
        "workflow/rules/exp_type_1.smk",
        "workflow/rules/exp_type_2.smk",
        "workflow/rules/exp_type_4.smk",
        "workflow/rules/exp_type_6.smk",
    ):
        assert "-cs5000" in _read(rel), rel
    assert KhoiceConfig().union_cs == 5000
    assert KhoiceConfig().count_cs == 255  # kmc default, -ci1 keeps singletons


def test_exp6_trial_csv_schema():
    smk = _read("workflow/rules/exp_type_6.smk")
    m = re.search(r'printf "([^"]+)" > \{output\[0\]\}', smk)
    assert m
    ref_header = m.group(1).replace("\\n", "")
    assert ref_header == "k,pivotnum,TP,TN,FP,FN,TP-U,TN-U,FP-U,FN-U"  # exp_type_6.smk:357
    import inspect

    from khoice_tpu.pipelines import exp6

    assert ref_header in inspect.getsource(exp6)


def test_accuracy_csv_column_order():
    """merge_lists accuracy rows are [k,pivot,TP,TN,FP,FN,(U variants)]
    (src/merge_lists.py:35-51 calculate_accuracy_values)."""
    py = _read("src/merge_lists.py")
    assert re.search(r"def calculate_accuracy_values", py)
    # reference appends [k, pivot, tp, tn, fp, fn] in that order
    assert "accuracies.append([args.k,pivot,tp,tn,fp,fn])" in py
    from khoice_tpu.classify.confusion import accuracy_values

    row = accuracy_values([[2, 0, 0], [0, 3, 0]], 2, 9)[0]
    k, pivot, tp, tn, fp, fn = row[:6]
    assert (k, pivot) == (9, 0) and tp == 2.0 and tn == 3.0 and fp == 0.0 and fn == 0.0
