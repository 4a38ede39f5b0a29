"""Sharded k-mer tables: shard_map + all_to_all over the "kv" mesh axis.

Replaces the reference's only scaling mechanisms — Snakemake task fan-out
and KMC's intra-process threads (SURVEY.md section 2.3) — with SPMD over a
device mesh:

- genomes stream in data-parallel slabs (one per device, k-1 halo so
  boundary-spanning k-mers are counted exactly once);
- each device extracts + locally reduces its slab, then ONE all_to_all
  exchanges (key, count) runs keyed by the key-range split points;
- after the exchange each device owns a disjoint, globally-ordered key
  range, so every kmc_tools-equivalent set operation and all downstream
  algebra is shard-local; histograms finish with a psum.

Split-point discipline (the round-2 regression fix): all tables that will
be combined MUST share one key-range partition, otherwise the comms-free
shard-local algebra pairs different key ranges and silently miscounts.
Split points are therefore sampled from the FIRST table built for a given
(mesh, k, n_shards) — skew-robust, since they adapt to real data — and
pinned in a session-level cache that every later table reuses. Tables
carry their split table; the algebra ops verify the operands agree and
fall back to a host-side re-partition if ever handed foreign tables
(e.g. loaded from disk from another session).

Determinism: counters are integers and each shard's reduction order is
fixed by the sort, so results are identical for any device count.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from functools import lru_cache, partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..engine import ops
from ..engine.bits import (
    SENTINEL,
    key_words,
    searchsorted_words,
)
from ..engine.extract import extract_canonical
from ..engine.table import KmerTable
from .mesh import AXIS

NO_SAT = (1 << 31) - 1  # "no saturation yet": global cap applies post-merge


@dataclasses.dataclass
class ShardedKmerTable:
    """A KmerTable whose arrays carry a leading [n_shards] axis.

    Shard d holds keys in [split_{d-1}, split_d) sorted ascending; shard
    ranges ascend with d, so device-order concatenation is globally sorted.
    ``splits`` is the host-side [n_shards-1, n_words] split-key table this
    partition was built with; algebra requires operands to share it.
    """

    table: KmerTable  # arrays shaped [D, C_local]
    mesh: Mesh
    splits: Optional[np.ndarray] = None  # [D-1, w] uint32, host

    @property
    def k(self) -> int:
        return self.table.k

    @property
    def n_shards(self) -> int:
        return self.table.counts.shape[0]

    def dump(self):
        """Globally sorted (kmer, count) records — multi-shard `dump -s`."""
        out = []
        counts = np.asarray(self.table.counts)
        words = [np.asarray(w) for w in self.table.keys]
        from ..engine.table import decode_key

        for d in range(self.n_shards):
            mask = counts[d] > 0
            kd = np.stack([w[d][mask] for w in words], axis=-1)
            cd = counts[d][mask]
            out.extend(
                (decode_key(kd[i], self.k), int(cd[i])) for i in range(kd.shape[0])
            )
        return out


# ---------------------------------------------------------------------------
# Session split-point registry: one partition per (mesh, k, n_shards)
# ---------------------------------------------------------------------------

_SESSION_SPLITS: Dict[tuple, np.ndarray] = {}


def session_splits(mesh: Mesh, k: int, n_shards: int) -> Optional[np.ndarray]:
    return _SESSION_SPLITS.get((mesh, k, n_shards))


def reset_session_splits() -> None:
    """Drop pinned split points (tests / fresh datasets with new skew)."""
    _SESSION_SPLITS.clear()


def make_slabs(codes: np.ndarray, n_shards: int, k: int) -> np.ndarray:
    """Split codes into [D, chunk + k - 1] slabs with halo overlap.

    Slab d covers window starts [d*chunk, (d+1)*chunk); the k-1 halo means
    k-mers spanning slab boundaries are counted exactly once (the
    "sequence scaling" axis of SURVEY.md section 5).
    """
    n = codes.shape[0]
    chunk = max(1, math.ceil(n / n_shards))
    slab_len = chunk + k - 1
    out = np.full((n_shards, slab_len), 4, np.uint8)
    for d in range(n_shards):
        lo = d * chunk
        hi = min(n, lo + slab_len)
        if lo < n:
            out[d, : hi - lo] = codes[lo:hi]
    return out


def _dedupe_local(keys, counts, cs):
    w = len(keys)
    sorted_ops = jax.lax.sort(list(keys) + [counts], num_keys=w, is_stable=False)
    return ops.dedupe_sorted(tuple(sorted_ops[:w]), sorted_ops[w], cs)


def rank_positions(live):
    """Rank-space structure of a boolean liveness mask over a sorted array.

    Returns (rank, pos, total): rank[i] = #live elements at or before
    position i; pos[t] = raw position of the (t+1)-th live element (one
    cheap 1-word sort); total = #live. Bucketing exchanges in rank space
    bounds each bucket by the LIVE element count, so a massively repeated
    key (poly-A runs, repeat families) cannot overflow a bucket no matter
    its raw multiplicity. Shared by the sharded table count
    (live = run starts), the k-sweep (live = deduped own elements,
    dist/ksweep.py) and the dynamic-k occurrence path."""
    n = live.shape[0]
    rank = jnp.cumsum(live.astype(jnp.int32))
    total = rank[-1]
    iota = jnp.arange(n, dtype=jnp.int32)
    keyr = jnp.where(live, rank, jnp.int32(0x7FFFFFFF))
    _, pos = jax.lax.sort([keyr, iota], num_keys=1, is_stable=False)
    return rank, pos, total


def _rank_space(ukeys):
    """rank_positions of a run-form table's distinct non-sentinel runs."""
    from ..engine.bits import words_is_sentinel
    from ..engine.ops import _run_starts

    return rank_positions(_run_starts(ukeys) & ~words_is_sentinel(ukeys))


def _partition_exchange(ukeys, ucounts, rank, pos, total, splits, bucket_cap, n_shards, cs):
    """Range-partition local unique runs by `splits` (tuple of w [D-1]
    arrays, identical on every shard), all_to_all, merge. Buckets live in
    dedup-rank space (see _rank_space). Returns (keys, counts, overflowed)
    with capacity n_shards * bucket_cap."""
    w = len(ukeys)
    n = ukeys[0].shape[0]
    # bucket boundaries in rank space: rank of last position below each split
    bnds = [jnp.zeros((), jnp.int32)]
    for i in range(n_shards - 1):
        q = tuple(splits[wi][i][None] for wi in range(w))
        sp = searchsorted_words(ukeys, q)[0]
        bnds.append(
            jnp.where(sp > 0, jnp.take(rank, jnp.maximum(sp - 1, 0), mode="clip"), 0)
        )
    bnds.append(total)
    bounds = jnp.stack(bnds)  # [D+1]

    sizes = bounds[1:] - bounds[:-1]
    overflow = jnp.max(sizes) > bucket_cap

    j = jnp.arange(bucket_cap, dtype=jnp.int32)[None, :]  # [1, cap]
    tr = bounds[:-1, None] + j  # [D, cap] 0-based target ranks
    valid = tr < bounds[1:, None]
    gidx = jnp.take(pos, jnp.minimum(tr, n - 1), mode="clip")
    send_keys = tuple(
        jnp.where(valid, jnp.take(kw, gidx, mode="clip"), SENTINEL) for kw in ukeys
    )
    send_counts = jnp.where(valid, jnp.take(ucounts, gidx, mode="clip"), 0).astype(jnp.uint32)

    recv_keys = tuple(
        jax.lax.all_to_all(kw, AXIS, split_axis=0, concat_axis=0, tiled=True)
        for kw in send_keys
    )
    recv_counts = jax.lax.all_to_all(send_counts, AXIS, split_axis=0, concat_axis=0, tiled=True)

    flat_keys = tuple(kw.reshape(-1) for kw in recv_keys)
    flat_counts = recv_counts.reshape(-1)
    mkeys, mcounts = _dedupe_local(flat_keys, flat_counts, cs)
    overflow_any = jax.lax.pmax(overflow.astype(jnp.int32), AXIS)
    return mkeys, mcounts, overflow_any


def _count_local(slab, splits_in, k, cs, bucket_cap, n_shards, sample):
    """Shard-local extract + dedupe + exchange.

    sample=True: derive split points from this table's own deduped keys
    (dist/occurrence._sampled_splits — weighted global quantile sample,
    identical on every shard) and return them so the caller can pin them
    for the whole session. sample=False: use the pinned `splits_in`
    ([D-1, w], replicated) so this table shares the session partition.
    """
    from .occurrence import _sampled_splits

    codes = slab[0]
    keys, valid = extract_canonical(codes, k)
    ukeys, ucounts = _dedupe_local(keys, valid.astype(jnp.uint32), NO_SAT)
    w = len(ukeys)
    rank, pos, total = _rank_space(ukeys)
    if sample:
        # sample split points in dedup-rank space: repeated keys carry no
        # extra weight, so skewed data still yields balanced shards
        splits = _sampled_splits(ukeys, total, n_shards, pos=pos, gid_bits=0)
    else:
        splits = tuple(splits_in[:, wi] for wi in range(w))
    mkeys, mcounts, overflow = _partition_exchange(
        ukeys, ucounts, rank, pos, total, splits, bucket_cap, n_shards, cs
    )
    if n_shards > 1:
        splits_out = jnp.stack(splits, axis=-1)  # [D-1, w]
        if sample:
            # value is identical on every shard (all_gathered sample), but
            # the static replication check can't see that — a pmax both
            # proves and enforces it
            splits_out = jax.lax.pmax(splits_out, AXIS)
    else:
        splits_out = jnp.zeros((0, w), jnp.uint32)
    return (
        tuple(kw[None] for kw in mkeys),
        mcounts[None],
        overflow,
        splits_out,
    )


@lru_cache(maxsize=64)
def _count_fn(mesh, k, cs, bucket_cap, n_shards, sample):
    """Jitted shard_map for sharded counting, cached module-level so
    repeated counts reuse one traced program."""
    return jax.jit(
        jax.shard_map(
            partial(
                _count_local,
                k=k,
                cs=cs,
                bucket_cap=bucket_cap,
                n_shards=n_shards,
                sample=sample,
            ),
            mesh=mesh,
            in_specs=(P(AXIS, None), P()),
            out_specs=(
                tuple(P(AXIS, None) for _ in range(key_words(k))),
                P(AXIS, None),
                P(),
                P(),
            ),
        )
    )


def sharded_count_codes(
    mesh: Mesh,
    codes: np.ndarray,
    k: int,
    cs: int = 255,
    bucket_cap: int | None = None,
    slack: float = 1.5,
) -> ShardedKmerTable:
    """Count canonical k-mers of one code array across the mesh.

    The result is exact and device-count-invariant; if a shard bucket
    overflows its capacity the call retries with doubled capacity. The
    first call for a (mesh, k, n_shards) samples skew-robust split points
    from its own data and pins them for the session so every table of that
    configuration shares one key-range partition (required by the
    comms-free shard-local algebra; `kmc_tools complex` union contract,
    reference workflow/rules/exp_type_1.smk:175-182).
    """
    d = mesh.devices.size
    slabs = make_slabs(np.asarray(codes, np.uint8), d, k)
    n = codes.shape[0]
    if bucket_cap is None:
        bucket_cap = max(64, int(slack * math.ceil(n / d / max(d, 1))))

    skey = (mesh, k, d)
    pinned = _SESSION_SPLITS.get(skey)
    w = key_words(k)
    while True:
        if pinned is None:
            fn = _count_fn(mesh, k, cs, bucket_cap, d, True)
            dummy = jnp.zeros((max(d - 1, 0), w), jnp.uint32)
            keys, counts, overflow, splits_out = fn(jnp.asarray(slabs), dummy)
        else:
            fn = _count_fn(mesh, k, cs, bucket_cap, d, False)
            keys, counts, overflow, splits_out = fn(
                jnp.asarray(slabs), jnp.asarray(pinned)
            )
        if int(np.asarray(overflow)) == 0:
            break
        bucket_cap *= 2
    splits_np = np.asarray(splits_out) if pinned is None else pinned
    if pinned is None:
        _SESSION_SPLITS[skey] = splits_np
    return ShardedKmerTable(
        table=KmerTable(keys=keys, counts=counts, k=k), mesh=mesh, splits=splits_np
    )


# ---------------------------------------------------------------------------
# Foreign-partition fallback: host-side re-shard onto given split points
# ---------------------------------------------------------------------------


def _host_flatten(t: ShardedKmerTable) -> Tuple[np.ndarray, np.ndarray]:
    """Present (key, count) rows in global sorted order as host arrays."""
    counts = np.asarray(t.table.counts)
    words = [np.asarray(wd) for wd in t.table.keys]
    rows, cts = [], []
    for d in range(counts.shape[0]):
        m = counts[d] > 0
        rows.append(np.stack([wd[d][m] for wd in words], axis=-1))
        cts.append(counts[d][m])
    return np.concatenate(rows, axis=0), np.concatenate(cts, axis=0)


def _row_int(row: np.ndarray) -> int:
    v = 0
    for word in row:
        v = (v << 32) | int(word)
    return v


def resplit(t: ShardedKmerTable, splits: np.ndarray) -> ShardedKmerTable:
    """Re-partition a table onto a different split-key table (host path).

    Only needed when combining tables built under different sessions (e.g.
    persisted + reloaded); tables built in-session always share pinned
    splits and never take this path.
    """
    allk, allc = _host_flatten(t)
    w = allk.shape[1] if allk.size else len(t.table.keys)
    key_ints = [_row_int(allk[i]) for i in range(allk.shape[0])]
    split_ints = [_row_int(splits[i]) for i in range(splits.shape[0])]
    D = splits.shape[0] + 1
    bnds = [0] + [bisect.bisect_left(key_ints, s) for s in split_ints] + [len(key_ints)]
    cap = max(1, max(bnds[i + 1] - bnds[i] for i in range(D)))
    keys_out = np.full((D, cap, w), 0xFFFFFFFF, np.uint32)
    counts_out = np.zeros((D, cap), np.uint32)
    for d in range(D):
        lo, hi = bnds[d], bnds[d + 1]
        if hi > lo:
            keys_out[d, : hi - lo] = allk[lo:hi]
            counts_out[d, : hi - lo] = allc[lo:hi]
    table = KmerTable(
        keys=tuple(jnp.asarray(np.ascontiguousarray(keys_out[:, :, wi])) for wi in range(w)),
        counts=jnp.asarray(counts_out),
        k=t.k,
    )
    return ShardedKmerTable(table=table, mesh=t.mesh, splits=np.asarray(splits))


def _common_partition(tables: Sequence[ShardedKmerTable]) -> List[ShardedKmerTable]:
    """Ensure all operands share one split table (shard-local algebra
    precondition); re-shard foreigners onto the first table's partition."""
    ref = tables[0].splits
    out = [tables[0]]
    for t in tables[1:]:
        same = (
            (ref is None and t.splits is None)
            or (
                ref is not None
                and t.splits is not None
                and np.array_equal(ref, t.splits)
            )
        )
        if same:
            out.append(t)
        elif ref is not None and t.splits is not None:
            out.append(resplit(t, ref))
        else:
            raise ValueError(
                "cannot combine ShardedKmerTables with unknown split points; "
                "rebuild them via sharded_count_codes in this session"
            )
    return out


# registry of shard-local table ops for the cached shard_map builder; each
# entry maps (param,) -> a function of local KmerTables
_SHARDWISE_OPS = {
    "union_many": lambda param: (lambda *ts: ops.union_many(list(ts), cs=param)),
    "intersect_sum": lambda param: (lambda x, y: ops.intersect_sum(x, y, cs=param)),
    "subtract": lambda param: ops.subtract,
}


@lru_cache(maxsize=256)
def _shardwise_fn(mesh, opname, param, k, n_tables):
    """Cached jitted shard_map running a registry op on every shard."""
    w = key_words(k)
    spec = (tuple(P(AXIS, None) for _ in range(w)), P(AXIS, None))
    fn = _SHARDWISE_OPS[opname](param)

    def local(*args):
        local_tables = [
            KmerTable(keys=tuple(x[0] for x in tk), counts=tc[0], k=k)
            for tk, tc in zip(args[0::2], args[1::2])
        ]
        out = fn(*local_tables)
        return tuple(x[None] for x in out.keys), out.counts[None]

    mapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=tuple(s for _ in range(n_tables) for s in spec),
        out_specs=spec,
    )
    return jax.jit(mapped)


def _shardwise(mesh, opname, param, tables: Sequence[ShardedKmerTable]) -> ShardedKmerTable:
    """Run a registry op independently on every shard (cached program)."""
    tables = _common_partition(tables)
    k = tables[0].k
    flat_args = []
    for t in tables:
        flat_args += [t.table.keys, t.table.counts]
    res = _shardwise_fn(mesh, opname, param, k, len(tables))(*flat_args)
    return ShardedKmerTable(
        table=KmerTable(keys=res[0], counts=res[1], k=k),
        mesh=mesh,
        splits=tables[0].splits,
    )


def sharded_union_many(tables: List[ShardedKmerTable], cs: int = 5000) -> ShardedKmerTable:
    """n-way union with counter sum — shard-local (no collectives)."""
    return _shardwise(tables[0].mesh, "union_many", cs, tables)


def sharded_intersect_sum(a: ShardedKmerTable, b: ShardedKmerTable, cs: int = 255) -> ShardedKmerTable:
    return _shardwise(a.mesh, "intersect_sum", cs, [a, b])


def sharded_subtract(a: ShardedKmerTable, b: ShardedKmerTable) -> ShardedKmerTable:
    return _shardwise(a.mesh, "subtract", None, [a, b])


def sharded_set_counts(t: ShardedKmerTable, c: int) -> ShardedKmerTable:
    out = KmerTable(
        keys=t.table.keys,
        counts=jnp.where(t.table.counts > 0, jnp.uint32(c), jnp.uint32(0)),
        k=t.k,
    )
    return ShardedKmerTable(table=out, mesh=t.mesh, splits=t.splits)


@lru_cache(maxsize=256)
def _hist_fn(mesh, k, cx):
    w = key_words(k)

    def local(keys, counts):
        lt = KmerTable(keys=tuple(x[0] for x in keys), counts=counts[0], k=k)
        h = ops.histogram(lt, cx=cx)
        return jax.lax.psum(h, AXIS)

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(tuple(P(AXIS, None) for _ in range(w)), P(AXIS, None)),
            out_specs=P(),
        )
    )


def sharded_histogram(t: ShardedKmerTable, cx: int = 10000) -> np.ndarray:
    """Occurrence histogram: shard-local histogram + psum over the axis."""
    return np.asarray(_hist_fn(t.mesh, t.k, cx)(t.table.keys, t.table.counts))
