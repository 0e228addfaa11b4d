"""Byte-bounded LRU cache of the serving layer.

Counterpart of ``repro.serving.cache`` (the port keeps its own copy):
the per-row ``QueryPrep`` LRU of :mod:`repro_torch.serving.engine`
runs on it, and so does the tiered backend's hot set.
Values are sized by their ``.nbytes`` (numpy arrays and torch tensors
alike).

Not internally locked: callers serialize access themselves (the engine
holds its global lock around cache operations).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Iterator, Optional


def _default_nbytes(value: Any) -> int:
    """Byte size of a cached value: a single array-like, or any
    tuple/list/dict of array-likes (anything exposing ``.nbytes``)."""
    if hasattr(value, "nbytes"):
        return int(value.nbytes)
    if isinstance(value, dict):
        value = value.values()
    return sum(_default_nbytes(v) for v in value)


class ByteLRU:
    """LRU mapping hashable keys to values under a byte budget.

    ``max_bytes`` bounds the summed size of cached values (sized by
    ``nbytes_of``, default: summed ``.nbytes`` over the value's
    arrays); ``max_entries`` optionally bounds the entry count.  A
    value larger than the whole budget is admitted and immediately
    evicted — ``put`` never raises, a zero-byte budget simply caches
    nothing (every lookup misses, which is exactly the cold-cache
    semantics the tiered backend's paging tests rely on).

    ``hits`` / ``misses`` / ``evictions`` count ``get`` outcomes and
    evicted entries for the owner's gauges.
    """

    def __init__(
        self,
        max_bytes: int,
        *,
        max_entries: Optional[int] = None,
        nbytes_of: Callable[[Any], int] = _default_nbytes,
    ):
        self.max_bytes = int(max_bytes)
        self.max_entries = max_entries
        self._nbytes_of = nbytes_of
        self._data: "OrderedDict[Any, Any]" = OrderedDict()
        self._sizes: Dict[Any, int] = {}
        self.nbytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def keys(self) -> Iterator:
        return iter(self._data.keys())

    def get(self, key, default=None):
        """Look up ``key``; a hit refreshes its recency."""
        entry = self._data.get(key)
        if entry is None:
            self.misses += 1
            return default
        self._data.move_to_end(key)
        self.hits += 1
        return entry

    def peek(self, key, default=None):
        """Look up without touching recency or hit/miss counters
        (residency probes, e.g. the paging cost bill)."""
        return self._data.get(key, default)

    def put(self, key, value) -> None:
        """Insert or replace ``key``, then evict LRU-first until the
        budget holds."""
        old = self._data.pop(key, None)
        if old is not None:
            self.nbytes -= self._sizes.pop(key)
        size = int(self._nbytes_of(value))
        self._data[key] = value
        self._sizes[key] = size
        self.nbytes += size
        self.evict()

    def pop(self, key, default=None):
        """Remove ``key`` (no eviction counted: the caller invalidated
        it, it did not age out)."""
        entry = self._data.pop(key, None)
        if entry is None:
            return default
        self.nbytes -= self._sizes.pop(key)
        return entry

    def evict(self) -> int:
        """Evict LRU-first until within budget; returns entries evicted."""
        n = 0
        while self._data and (
            self.nbytes > self.max_bytes
            or (self.max_entries is not None
                and len(self._data) > self.max_entries)
        ):
            key, _ = self._data.popitem(last=False)
            self.nbytes -= self._sizes.pop(key)
            self.evictions += 1
            n += 1
        return n

    def clear(self) -> None:
        self._data.clear()
        self._sizes.clear()
        self.nbytes = 0

    def stats(self) -> Dict[str, int]:
        """Gauge snapshot (counters are lifetime, not interval)."""
        total = self.hits + self.misses
        return {
            "entries": len(self._data),
            "nbytes": self.nbytes,
            "max_bytes": self.max_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "evictions": self.evictions,
        }
