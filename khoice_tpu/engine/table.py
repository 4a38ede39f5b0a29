"""KmerTable: the device-resident k-mer database.

Plays the role of a KMC3 database (`.kmc_pre`/`.kmc_suf` file pair in the
reference, produced at workflow/rules/exp_type_1.smk:156-163) as a
static-shape JAX pytree:

- ``keys``: tuple of uint32 word arrays [capacity], ascending (duplicates
  allowed — "run form"); unused slots hold the all-ones SENTINEL at the end.
- ``counts``: uint32 [capacity]. A key is *present* iff count > 0, and a
  present key's count lives at its FIRST slot (lower_bound finds it).
  count==0 elsewhere (duplicate slots, deletions, sentinels). Run form is
  scatter-free: dedupe never compacts on device.
- ``k``: static aux data.

All engine ops preserve this invariant, which makes binary search, merges
and range-partitioned sharding valid at all times.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .bits import (
    SENTINEL,
    key_words,
    sentinel_key,
    words_is_sentinel,
)

__all__ = ["KmerTable", "key_words", "SENTINEL"]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["keys", "counts"],
    meta_fields=["k"],
)
@dataclasses.dataclass
class KmerTable:
    keys: tuple  # tuple[n_words] of uint32 [capacity]
    counts: jnp.ndarray  # uint32 [capacity]
    k: int

    @property
    def capacity(self) -> int:
        return self.counts.shape[-1]

    @property
    def n_words(self) -> int:
        return len(self.keys)

    # ---- host-side helpers (pull data off device) ----

    def to_host(self):
        """Return (keys_2d [n, n_words] uint32, counts [n]) for present keys."""
        counts = np.asarray(self.counts)
        keys = np.stack([np.asarray(w) for w in self.keys], axis=-1)
        mask = counts > 0
        return keys[mask], counts[mask]

    def n_present_host(self) -> int:
        return int(np.sum(np.asarray(self.counts) > 0))

    def dump(self):
        """Sorted text-dump records [(kmer_str, count)], ascending by k-mer.

        Matches `kmc_tools transform ... dump -s` output ordering
        (reference: workflow/rules/exp_type_4.smk:255-258): numeric key order
        equals A<C<G<T lexicographic order.
        """
        keys, counts = self.to_host()
        return [
            (decode_key(keys[i], self.k), int(counts[i]))
            for i in range(keys.shape[0])
        ]


def empty_table(k: int, capacity: int) -> KmerTable:
    w = key_words(k)
    return KmerTable(
        keys=sentinel_key(w, (capacity,)),
        counts=jnp.zeros((capacity,), jnp.uint32),
        k=k,
    )


def table_from_host(k: int, keys_2d: np.ndarray, counts: np.ndarray, capacity: int | None = None) -> KmerTable:
    """Build a device table from host (n, n_words) keys + counts.

    Keys must be unique; they will be sorted here. Mostly a test/IO helper.
    """
    w = key_words(k)
    n = keys_2d.shape[0]
    if capacity is None:
        capacity = max(n, 1)
    if n > capacity:
        raise ValueError(f"{n} keys exceed capacity {capacity}")
    order = np.lexsort(tuple(keys_2d[:, i] for i in reversed(range(w))))
    keys_2d = keys_2d[order]
    counts = np.asarray(counts)[order]
    full_k = np.full((capacity, w), 0xFFFFFFFF, np.uint32)
    full_c = np.zeros((capacity,), np.uint32)
    full_k[:n] = keys_2d
    full_c[:n] = counts
    return KmerTable(
        keys=tuple(jnp.asarray(full_k[:, i]) for i in range(w)),
        counts=jnp.asarray(full_c),
        k=k,
    )


_BASES = np.array(["A", "C", "G", "T"])


def decode_key(words: np.ndarray, k: int) -> str:
    """Decode an (n_words,) uint32 big-endian key into its k-mer string."""
    total_words = words.shape[0]
    digits = []
    # Walk 2-bit digits from least significant; produces the k-mer reversed.
    vals = [int(x) for x in words]
    for _ in range(k):
        d = vals[-1] & 3
        digits.append(d)
        # shift the whole multiword right by 2
        carry = 0
        for i in range(total_words):
            v = vals[i]
            vals[i] = (v >> 2) | (carry << 30)
            carry = v & 3
    return "".join(_BASES[d] for d in reversed(digits))


def encode_kmer(kmer: str) -> np.ndarray:
    """Encode a k-mer string into its (n_words,) uint32 big-endian key."""
    w = key_words(len(kmer))
    vals = [0] * w
    lut = {"A": 0, "C": 1, "G": 2, "T": 3}
    for ch in kmer:
        d = lut[ch]
        out = []
        for i in range(w - 1):
            out.append(((vals[i] << 2) | (vals[i + 1] >> 30)) & 0xFFFFFFFF)
        out.append(((vals[w - 1] << 2) | d) & 0xFFFFFFFF)
        vals = out
    return np.array(vals, np.uint32)
