"""KmerEngine: jit-cached, capacity-bucketed front door to the engine.

Keeps XLA recompilation bounded by padding inputs/capacities to powers of
two and caching jitted callables per (shape, k). This object is the
in-process replacement for the reference's per-rule `kmc`/`kmc_tools`
process invocations (reference: workflow/rules/exp_type_1.smk:156-259):
one long-lived runtime instead of a process boundary per step.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..io.packing import encode_records, pad_pow2
from . import ops
from .table import KmerTable


def _pow2(n: int, floor: int = 16) -> int:
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


class KmerEngine:
    def __init__(self):
        self._count = {}
        self._union = {}
        self._memo: Dict = {}

    # ---------- counting ----------

    def count_codes(self, codes: np.ndarray, k: int, cs: int = 255) -> KmerTable:
        codes = pad_pow2(np.asarray(codes, np.uint8))
        key = ("count", codes.shape[0], k, cs)
        fn = self._memo.get(key)
        if fn is None:
            fn = jax.jit(partial(ops.count_codes, k=k, cs=cs))
            self._memo[key] = fn
        return fn(jnp.asarray(codes))

    def count_seqs(self, seqs: Sequence[str], k: int, cs: int = 255, compact: bool = True) -> KmerTable:
        t = self.count_codes(encode_records(seqs), k, cs)
        return self.compact(t) if compact else t

    # ---------- table transforms ----------

    def set_counts(self, t: KmerTable, c: int) -> KmerTable:
        return ops.set_counts(t, c)

    def union(self, tables: List[KmerTable], cs: int = 5000, compact: bool = True) -> KmerTable:
        key = ("union", tuple(t.capacity for t in tables), tables[0].k, cs)
        fn = self._memo.get(key)
        if fn is None:
            fn = jax.jit(partial(ops.union_many, cs=cs))
            self._memo[key] = fn
        out = fn(tables)
        return self.compact(out) if compact else out

    def intersect_sum(self, a: KmerTable, b: KmerTable, cs: int = 255) -> KmerTable:
        key = ("isect", a.capacity, b.capacity, a.k, cs)
        fn = self._memo.get(key)
        if fn is None:
            fn = jax.jit(partial(ops.intersect_sum, cs=cs))
            self._memo[key] = fn
        return fn(a, b)

    def subtract(self, a: KmerTable, b: KmerTable) -> KmerTable:
        key = ("sub", a.capacity, b.capacity, a.k)
        fn = self._memo.get(key)
        if fn is None:
            fn = jax.jit(ops.subtract)
            self._memo[key] = fn
        return fn(a, b)

    def histogram(self, t: KmerTable, cx: int = 10000) -> List[int]:
        key = ("hist", t.capacity, t.k, cx)
        fn = self._memo.get(key)
        if fn is None:
            fn = jax.jit(partial(ops.histogram, cx=cx))
            self._memo[key] = fn
        return np.asarray(fn(t)).tolist()

    def n_present(self, t: KmerTable) -> int:
        return int(np.asarray(ops.n_present(t)))

    # ---------- capacity management ----------

    def compact(self, t: KmerTable) -> KmerTable:
        """Shrink capacity to pow2(last present slot + 1) via device slices.

        Valid for any run-form table: dropping slots past the last present
        index only removes zero-count duplicates and sentinels. Only a
        SCALAR crosses the device boundary, not the counts array.
        """
        key = ("lastp", t.capacity)
        fn = self._memo.get(key)
        if fn is None:
            def last_present(counts):
                idx = jnp.arange(counts.shape[0], dtype=jnp.int32)
                return jnp.max(jnp.where(counts > 0, idx, -1))
            fn = jax.jit(last_present)
            self._memo[key] = fn
        last = int(np.asarray(fn(t.counts))) + 1
        cap = _pow2(max(last, 1))
        if cap >= t.capacity:
            return t
        return KmerTable(
            keys=tuple(w[:cap] for w in t.keys),
            counts=t.counts[:cap],
            k=t.k,
        )
