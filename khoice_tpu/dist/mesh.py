"""Device mesh + key-range partitioning for the sharded k-mer engine.

The reference has no distributed backend at all — its parallelism is
Snakemake task fan-out plus the filesystem (SURVEY.md section 2.3). The
equivalent here: one mesh axis "kv" partitions canonical k-mer
key space into contiguous ranges with *fixed split points*. Aligned
partitioning makes every set operation (union/intersect/subtract, the
kmc_tools surface) embarrassingly parallel: only counting does one
all_to_all exchange; algebra and histograms are shard-local (+psum).

Split points: canonical keys are min(fwd, rc) of two ~uniform 2k-bit
values, so P(key <= x*4^k) ~ 1-(1-x)^2. Quantile splits
x_i = 1 - sqrt(1 - i/D) equalize shard load (~exactly, since the k-mer
space is uniform under 2-bit packing) while keeping ranges ordered by
device index — device-order concatenation of shard dumps is globally
sorted, which is what KMC's sorted text dumps require.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from ..engine.bits import key_words

AXIS = "kv"


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1-D "kv" mesh over `devices`, or over the first `n_devices` of
    jax.devices() (all of them when None).  Asking for more devices than
    exist raises: a smaller mesh would silently run the sharded path on
    fewer devices than the user asked for."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(
                    f"mesh of {n_devices} devices requested, but only "
                    f"{len(devices)} {devices[0].platform} device(s) exist"
                )
            devices = devices[:n_devices]
    return Mesh(np.array(devices), (AXIS,))


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Mesh:
    """Initialize the jax.distributed runtime and return the global mesh.

    The multi-host analogue of the reference's (non-existent) distributed
    backend — counting's all_to_all rides the devices' interconnect
    (NVLink within a host) and the network across hosts. Exchange volume is bounded before any data leaves a
    device: each device sorts and dedupes its (key, gid) pairs locally
    and buckets in dedup-rank space (dist/occurrence.py), so the
    collective carries deduped runs, not raw k-mer streams (SURVEY.md
    section 7.4 item 5). Call once per process before building meshes;
    see dist/multihost.py for assembling per-process inputs.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return make_mesh()


def _fraction_to_key(frac: float, k: int) -> np.ndarray:
    """Map a fraction of the 2k-bit key space to a multi-word uint32 key."""
    w = key_words(k)
    total_bits = 2 * k
    v = int(frac * (1 << total_bits))
    v = max(0, min(v, (1 << total_bits) - 1))
    words = []
    for i in range(w):
        shift = 32 * (w - 1 - i)
        words.append((v >> shift) & 0xFFFFFFFF)
    return np.array(words, np.uint32)


def split_keys_for(k: int, n_shards: int) -> np.ndarray:
    """(n_shards-1, n_words) ascending split keys for the canonical-key CDF."""
    w = key_words(k)
    out = np.zeros((max(n_shards - 1, 0), w), np.uint32)
    for i in range(1, n_shards):
        frac = 1.0 - math.sqrt(1.0 - i / n_shards)
        out[i - 1] = _fraction_to_key(frac, k)
    return out
