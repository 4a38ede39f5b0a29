"""Subprocess worker for the 2-process jax.distributed test.

Launched by tests/test_multihost.py with a clean CPU-only environment
(JAX_PLATFORMS=cpu): initializes the distributed runtime
over a localhost coordinator, builds the global mesh, runs the fused
occurrence histogram on a fixed seeded dataset, and prints the result as
one JSON line for the parent to compare across processes and against the
single-host engine.
"""

import json
import random
import sys


def main() -> None:
    port, pid, nprocs, ndev = sys.argv[1:5]
    import jax

    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.config.update("jax_num_cpu_devices", int(ndev))
    jax.distributed.initialize(
        f"127.0.0.1:{port}", num_processes=int(nprocs), process_id=int(pid)
    )
    assert jax.process_count() == int(nprocs), jax.process_count()

    from khoice_tpu.dist.mesh import make_mesh
    from khoice_tpu.dist.multihost import (
        multihost_occurrence_histogram,
        multihost_occurrence_histograms_sweep,
    )
    from khoice_tpu.io import encode_records

    # deterministic dataset, identical in every process
    rng = random.Random(4242)
    genomes = [
        "".join(rng.choice("ACGT") for _ in range(1500)) for _ in range(5)
    ]
    # shared core so occurrence counts exceed 1
    core = genomes[0][200:900]
    genomes = [g[:200] + core + g[900:] for g in genomes]
    member_codes = [encode_records([g]) for g in genomes]

    mesh = make_mesh()
    out = {}
    for k in (11, 31):
        hist = multihost_occurrence_histogram(mesh, member_codes, k)
        out[str(k)] = hist[:8]
    # the shared-sort k-sweep over the same process-spanning mesh
    sweep = multihost_occurrence_histograms_sweep(
        mesh, member_codes, [9, 15, 21, 33], cx=8
    )
    out["sweep"] = {str(k): h for k, h in sweep.items()}

    # exp6's sharded read voting across processes (dist/multihost.py)
    from khoice_tpu.dist.multihost import multihost_read_votes_multi
    from khoice_tpu.pipelines.exp6 import reads_matrix

    vote_groups = member_codes[:3]
    mats = [
        reads_matrix([genomes[m][i : i + 60] for i in range(0, 180, 60)])
        for m in range(3)
    ]
    votes = multihost_read_votes_multi(mesh, vote_groups, mats, [11, 21])
    out["votes"] = {
        str(k): [[t[0].tolist(), t[1].tolist(), t[2].tolist()] for t in votes[k]]
        for k in (11, 21)
    }
    print("RESULT " + json.dumps({"pid": int(pid), "hists": out}), flush=True)


if __name__ == "__main__":
    main()
