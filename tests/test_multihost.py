"""2-process jax.distributed proof.

Launches two REAL processes with a localhost coordinator + gloo CPU
collectives (the CPU stand-in for a 2-host network), runs the
fused SPMD occurrence histogram across the process-spanning 8-device
mesh, and asserts (a) both processes compute identical histograms and
(b) they equal the single-host engine's result — i.e. the multi-host
path is deterministic and host-count-invariant.
"""

import json
import os
import random
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _clean_env() -> dict:
    """CPU-only environment for the workers, with no virtual-device flags
    and no persistent compile cache (distributed-specific executables stay
    out of the suite's cache)."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    return env


@pytest.mark.slow
def test_two_process_distributed_occurrence():
    port = _free_port()
    nprocs, ndev = 2, 4
    worker = os.path.join(REPO, "tests", "multihost_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(port), str(pid), str(nprocs), str(ndev)],
            env=_clean_env(),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(nprocs)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        assert p.returncode == 0, out[-3000:]

    results = {}
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, out[-3000:]
        rec = json.loads(lines[-1][len("RESULT "):])
        results[rec["pid"]] = rec["hists"]

    assert set(results) == {0, 1}
    # (a) both processes agree bit-for-bit
    assert results[0] == results[1]

    # (b) equals the single-host engine on the same seeded dataset
    from khoice_tpu.engine.occurrence import occurrence_histogram
    from khoice_tpu.io import encode_records

    rng = random.Random(4242)
    genomes = ["".join(rng.choice("ACGT") for _ in range(1500)) for _ in range(5)]
    core = genomes[0][200:900]
    genomes = [g[:200] + core + g[900:] for g in genomes]
    member_codes = [encode_records([g]) for g in genomes]
    for k in (11, 31):
        expect = occurrence_histogram(member_codes, k)[:8]
        assert results[0][str(k)] == list(expect), f"k={k}"

    # (c) the shared-sort k-sweep across processes equals the single-host
    # sweep (2- and 3-word key classes)
    from khoice_tpu.engine.ksweep import occurrence_histograms_sweep

    want_sweep = occurrence_histograms_sweep(member_codes, [9, 15, 21, 33], cx=8)
    for k in (9, 15, 21, 33):
        assert results[0]["sweep"][str(k)] == want_sweep[k], f"sweep k={k}"

    # (d) exp6's sharded read voting across processes equals the
    # single-device merge voting
    from khoice_tpu.classify.annotate import (
        concat_flat_reads,
        flat_reads_device,
        pack_group_texts,
        read_votes_bulk_multi,
    )
    from khoice_tpu.pipelines.exp6 import reads_matrix

    vote_groups = member_codes[:3]
    mats = [
        reads_matrix([genomes[m][i : i + 60] for i in range(0, 180, 60)])
        for m in range(3)
    ]
    cg = pack_group_texts(vote_groups)
    big, spans = concat_flat_reads([flat_reads_device(m) for m in mats])
    for k in (11, 21):
        want = read_votes_bulk_multi(cg, big, spans, k, 3)
        got = results[0]["votes"][str(k)]
        for (wv, wu, wn), (gv, gu, gn) in zip(want, got):
            assert gv == wv.tolist() and gu == wu.tolist() and gn == wn.tolist(), (
                f"votes k={k}"
            )
