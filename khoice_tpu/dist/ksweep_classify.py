"""Sharded classification sweeps: exp2/3/4's scans SPMD over the mesh.

The reference fans exp2-6 across cores exactly like exp1 (one Snakemake
rule instance per (k, dataset), workflow/rules/exp_type_2.smk:354-380,
exp_type_6.smk:264-319), where the classification sweeps used to run
on a single device.  These drivers give the four
classify modes of engine/ksweep_classify.py the same key-range SPMD
treatment as the exp1 sweep (dist/ksweep.py):

- the same slab -> local doubled extract -> all_to_all exchange keyed by
  data-sampled, 2*kmin-prefix-ALIGNED splits — so no k-run of any swept
  k tears across shards and every per-run quantity (presence masks,
  saturated pivot multiplicity sums, palindrome halving) is computed
  exactly on one shard;
- per-shard scans return the RAW (doubled, palindromic) stats and the
  psum runs BEFORE the (d+p)//2 canonical combine, because a class's two
  strand runs generally land in different shards (identical to the exp1
  histograms' treatment);
- exp4's "buckets" mode skips the (key, gid, nio) exchange dedupe — it
  sums pivot multiplicities, which dedupe would undercount (the three
  presence-mask modes keep the dedupe's volume reduction).

Each driver returns the SAME ({k: stats}, leftover-ks) contract as its
single-device counterpart; results are bit-identical (tested on the
8-virtual-device CPU mesh via exp2/3/4 CSV byte-equality).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
from jax.sharding import Mesh

from .ksweep import run_sweep_plan_raw


def _run(mesh, member_codes, ks, cs, mode, mode_params,
         bucket_cap=None, slack=1.7):
    import jax.numpy as jnp

    return run_sweep_plan_raw(
        mesh, member_codes, ks, cs, bucket_cap, slack,
        upload=jnp.asarray, to_host=lambda x: x,
        mode=mode, mode_params=mode_params,
    )


def sharded_pivot_rest_counts_sweep(
    mesh: Mesh, member_codes: Sequence[np.ndarray], ks: Sequence[int],
    cs: int = 5000,
) -> Tuple[Dict[int, np.ndarray], List[int]]:
    """Sharded twin of engine.ksweep_classify.pivot_rest_counts_sweep:
    {k: (n_rest+1,) counts} for member 0 = pivot vs the rest members."""
    n_rest = len(member_codes) - 1
    assert cs >= len(member_codes), "sweep ignores cs below the member count"
    return _run(mesh, member_codes, ks, cs, "pivot_rest", n_rest)


def sharded_multi_pivot_counts_sweep(
    mesh: Mesh, member_codes: Sequence[np.ndarray], D: int,
    ks: Sequence[int], cs: int = 5000,
) -> Tuple[Dict[int, np.ndarray], List[int]]:
    """Sharded twin of multi_pivot_counts_sweep: {k: (D, D) counts},
    members 0..D-1 pivots, D..2D-1 group sets."""
    assert cs >= len(member_codes), "sweep ignores cs below the member count"
    stats, remaining = _run(mesh, member_codes, ks, cs, "multi_pivot", D)
    return {k: v.reshape(D, D) for k, v in stats.items()}, remaining


def sharded_containment_counts_sweep(
    mesh: Mesh, member_codes: Sequence[np.ndarray], nq: int, ng: int,
    ks: Sequence[int], cs: int = 5000,
) -> Tuple[Dict[int, np.ndarray], List[int]]:
    """Sharded twin of containment_counts_sweep: {k: (nq, ng+1) counts},
    members 0..nq-1 query sets, then ng groups."""
    assert cs >= len(member_codes), "sweep ignores cs below the member count"
    stats, remaining = _run(mesh, member_codes, ks, cs, "containment", (nq, ng))
    return {k: v.reshape(nq, ng + 1) for k, v in stats.items()}, remaining


def sharded_feature_buckets_sweep(
    mesh: Mesh, member_codes: Sequence[np.ndarray], D: int,
    ks: Sequence[int], cap: int = 255, cs: int = 5000,
) -> Tuple[Dict[int, tuple], List[int]]:
    """Sharded twin of feature_buckets_sweep: {k: (buckets (D, D) int64,
    unique int)}, member 0 pivot (count-weighted), 1..D group sets."""
    assert cs >= len(member_codes), "sweep ignores cs below the member count"
    stats, remaining = _run(
        mesh, member_codes, ks, cs, "buckets", (D, cap)
    )
    out: Dict[int, tuple] = {}
    for k, v in stats.items():
        out[k] = (v[: D * D].reshape(D, D).astype(np.int64), int(v[D * D]))
    return out, remaining
