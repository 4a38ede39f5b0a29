"""Multi-host (multi-process) entry points for the sharded engine.

The reference has no distributed backend — its only scaling is Snakemake
fan-out on one machine (SURVEY.md section 2.3). Here the same SPMD
programs that run on one host's mesh run across `jax.distributed`
processes: each host materializes only its own slab rows and
`jax.make_array_from_process_local_data` assembles the global sharded
array; collectives ride NVLink within a host and the network across
hosts.

Cross-host volume control: each device locally sorts and dedupes its
(key, gid) pairs BEFORE the all_to_all (dist/occurrence.py), so the
exchange carries deduped runs, not raw k-mer streams; bucketing happens
in dedup-rank space so repeat-heavy shards cannot overflow.

Tested with 2 CPU processes + gloo collectives over a localhost
coordinator (tests/test_multihost.py) — the same code path a real
multi-host run takes, minus hardware.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine.occurrence import (
    GID_BITS,
    kmax_class_packed,
    occ_words_packed,
    pack_members,
)
from .mesh import AXIS
from .occurrence import _dyn_occ_fn, _make_slab_pair


def local_shard_rows(mesh: Mesh) -> List[int]:
    """Indices along the kv axis owned by THIS process, in mesh order."""
    pid = jax.process_index()
    devs = list(mesh.devices.reshape(-1))
    return [i for i, d in enumerate(devs) if d.process_index == pid]


def _to_global(mesh: Mesh, full_rows: np.ndarray):
    """Assemble a [D, L] row-sharded global array from the full host copy.

    Every process computes the full slab matrix (genome bytes are host
    RAM, cheap); only this process's rows are uploaded to its devices.
    """
    sharding = NamedSharding(mesh, P(AXIS, None))
    rows = local_shard_rows(mesh)
    local = np.ascontiguousarray(full_rows[rows])
    return jax.make_array_from_process_local_data(sharding, local, full_rows.shape)


def multihost_occurrence_histogram(
    mesh: Mesh,
    member_codes: Sequence[np.ndarray],
    k: int,
    cs: int = 5000,
    cx: int = 10000,
    bucket_cap: int | None = None,
    slack: float = 1.5,
) -> List[int]:
    """occurrence_histogram over a process-spanning mesh.

    Same fused SPMD program as sharded_occurrence_histogram's dynamic-k
    path (one compile per packed word class, data-sampled split points),
    but inputs are assembled per process, so it runs under
    `jax.distributed` with any process count. Deterministic: integer
    counters and per-shard sorted reduction order make the histogram
    identical for every (process count, device count) that yields the
    same global mesh, and byte-identical to the single-host path.
    """
    d = mesh.devices.size
    if len(member_codes) > (1 << GID_BITS) or k > 60:
        raise ValueError("multihost path supports <=256 members and k<=60")
    codes, gids = pack_members(member_codes)
    n = codes.shape[0]
    if bucket_cap is None:
        bucket_cap = max(64, int(slack * math.ceil(n / d / max(d, 1))))

    kmax = kmax_class_packed(k)
    ow = occ_words_packed(kmax)
    chunk = max(1, math.ceil(n / d))
    slab_codes, slab_gids = _make_slab_pair(codes, gids, d, kmax)
    gc = _to_global(mesh, slab_codes)
    gg = _to_global(mesh, slab_gids)
    while True:
        fn = _dyn_occ_fn(mesh, kmax, ow, len(member_codes), d, cs, cx, bucket_cap, chunk)
        hist, overflow = fn(gc, gg, jnp.uint32(k))
        # outputs are fully replicated (out_specs P()): read shard 0
        if int(np.asarray(overflow.addressable_data(0))) == 0:
            break
        bucket_cap *= 2
    return np.asarray(hist.addressable_data(0)).tolist()


def multihost_occurrence_histograms_sweep(
    mesh: Mesh,
    member_codes: Sequence[np.ndarray],
    ks: Sequence[int],
    cs: int = 5000,
    cx: int = 10000,
    bucket_cap: int | None = None,
    slack: float = 1.7,
):
    """The shared-sort k-sweep (dist/ksweep.py) over a process-spanning
    mesh: the SAME driver (run_sweep_plan), with per-process input
    assembly and replicated-output readback. Returns {k: histogram},
    bit-identical to the single-host sweep for any (process count,
    device count) yielding the same global mesh."""
    from functools import partial

    from .ksweep import run_sweep_plan

    return run_sweep_plan(
        mesh, member_codes, ks, cs, cx, bucket_cap, slack,
        upload=partial(_to_global, mesh),
        to_host=lambda x: x.addressable_data(0),
        per_k_fallback=lambda k: multihost_occurrence_histogram(
            mesh, member_codes, k, cs=cs, cx=cx, bucket_cap=bucket_cap
        ),
    )


def multihost_read_votes_multi(
    mesh: Mesh,
    group_codes: Sequence[np.ndarray],
    read_mats: Sequence[np.ndarray],
    ks: Sequence[int],
    bucket_cap: int | None = None,
) -> dict:
    """exp6's sharded read voting (dist/vote.py) over a process-spanning
    mesh: the SAME driver, with per-process slab assembly and
    replicated-output readback. Bit-identical votes to the single-host
    path for any (process count, device count) yielding the same global
    mesh — integer LCM weights make the psum order-free."""
    from functools import partial

    from .vote import sharded_read_votes_multi

    return sharded_read_votes_multi(
        mesh, group_codes, read_mats, ks, bucket_cap=bucket_cap,
        upload=partial(_to_global, mesh),
        to_host=lambda x: x.addressable_data(0),
    )
