#!/usr/bin/env python3
"""Headline benchmark: canonical k-mers/s on one GPU over the reference k grid.

Sweeps the reference's full 30-point k grid (k=7..30 step 1 and 34..49
step 3, workflow/Snakefile:36) running the fused exp1 inner operation per
k — canonical counting, genome-occurrence reduction and occurrence
histogram over an 8-genome group of 16.8 Mbp — i.e. the work of the
reference's `kmc` count per genome + `kmc_tools complex` union +
`histogram` chain per (k, group)
(workflow/rules/exp_type_1.smk:156-191), on one GPU, steady-state.

Methodology: the shared-sort k-sweep (engine/ksweep.py) computes every k
of the grid from ONE doubled-text device sort plus a multi-k scan, one
device call returning only small histograms.  Rate = total k-mers across
the whole grid / best of REPS sweep times (compile excluded).

Refuses to run without a GPU.  Prints the card's name and power limit,
then ONE JSON line: {"metric", "value", "unit", "device"}.
"""

import json
import subprocess
import sys
import time

import numpy as np

N_GENOMES = 8
GENOME_LEN = 1 << 21  # 8 x 2 Mbp = 16.8M k-mers per grid point
K_GRID = list(range(7, 31)) + [34, 37, 40, 43, 46, 49]  # Snakefile:36
REPS = 3


def main():
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX sees {dev.platform}); refusing to run",
              file=sys.stderr)
        return 2

    from khoice_tpu.engine.ksweep import occurrence_histograms_sweep_packed
    from khoice_tpu.engine.occurrence import pack_members
    from khoice_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())

    rng = np.random.default_rng(0)
    members = [
        rng.integers(0, 4, size=GENOME_LEN, dtype=np.uint8)
        for _ in range(N_GENOMES)
    ]
    codes, gids = pack_members(members)
    cj, gj = jnp.asarray(codes), jnp.asarray(gids)

    def run_grid():
        return occurrence_histograms_sweep_packed(
            (cj, gj), N_GENOMES, K_GRID, cs=5000, cx=16
        )

    hists = run_grid()  # compile
    chk = sum(hists[k][0] for k in K_GRID)

    n_kmers_total = len(K_GRID) * N_GENOMES * GENOME_LEN
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        run_grid()  # returns host lists: the device work has finished
        times.append(time.perf_counter() - t0)
    kmers_per_s = n_kmers_total / min(times)

    print(json.dumps({
        "metric": "canonical_kmers_per_s_kgrid_count_union_hist",
        "value": kmers_per_s / 1e6,
        "unit": "Mkmer/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0 if chk != 0 else 1


if __name__ == "__main__":
    sys.exit(main())
