"""Identity-keyed, byte-budgeted LRU caches for device-resident state (port
of ``repro.core.scene_cache``).

Two users:

* ``NerfModel.prepare_streaming`` — the per-table MVoxel halo re-layout
  cache: an LRU over table identity, so a model serving alternating
  scenes rebuilds no table once both are resident.
* ``RenderServeEngine`` — the scene pager: scene name -> page index into
  the stacked ``[K, ...]`` table tensors, LRU-evicted under the
  ``RenderConfig.scene_cache_bytes`` budget; live slots pin their
  scene's page.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import (Any, Callable, Dict, Hashable, Iterable, List, Optional,
                    Tuple)


class ParamsToken:
    """Hashable identity token for an unhashable object (a tensor, a
    params dict). Two tokens are equal iff they wrap the same object; the
    token keeps it alive, so an entry can never alias a recycled id."""

    __slots__ = ("obj",)

    def __init__(self, obj: Any):
        self.obj = obj

    def __hash__(self) -> int:
        return id(self.obj)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ParamsToken) and other.obj is self.obj

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ParamsToken(0x{id(self.obj):x})"


class SceneCache:
    """LRU over hashable keys with optional entry-count and byte budgets.

    ``budget_bytes=0`` disables the byte budget, ``max_entries=None`` the
    count budget. Eviction happens in ``put``/``get_or_build`` only, never
    takes a pinned key, and returns the evicted pairs so the caller can
    recycle device pages. Counters are lifetime totals; per-run numbers
    are deltas of snapshots.
    """

    def __init__(self, *, budget_bytes: int = 0,
                 max_entries: Optional[int] = None):
        self._entries: "OrderedDict[Hashable, Tuple[Any, int]]" = \
            OrderedDict()
        self.budget_bytes = int(budget_bytes)
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.evicted_bytes = 0
        self.resident_bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def get(self, key: Hashable) -> Optional[Any]:
        """The cached value (now most recent), or None; counts a hit or a
        miss."""
        hit = self._entries.get(key)
        if hit is None:
            self.misses += 1
            return None
        self.hits += 1
        self._entries.move_to_end(key)
        return hit[0]

    def peek(self, key: Hashable) -> Optional[Any]:
        """Like :meth:`get`, but touches neither counters nor LRU order."""
        hit = self._entries.get(key)
        return None if hit is None else hit[0]

    def _evict_lru(self, pinned: Iterable[Hashable]
                   ) -> List[Tuple[Hashable, Any]]:
        pin = set(pinned)
        evicted: List[Tuple[Hashable, Any]] = []

        def over() -> bool:
            if self.max_entries is not None \
                    and len(self._entries) > self.max_entries:
                return True
            return self.budget_bytes > 0 \
                and self.resident_bytes > self.budget_bytes

        while over():
            victim = next((k for k in self._entries if k not in pin), None)
            if victim is None:  # everything is pinned: the budget yields
                break
            value, nbytes = self._entries.pop(victim)
            self.evictions += 1
            self.evicted_bytes += nbytes
            self.resident_bytes -= nbytes
            evicted.append((victim, value))
        return evicted

    def put(self, key: Hashable, value: Any, nbytes: int = 0,
            pinned: Iterable[Hashable] = ()) -> List[Tuple[Hashable, Any]]:
        """Insert (or refresh) ``key``; returns the evicted pairs."""
        old = self._entries.pop(key, None)
        if old is not None:
            self.resident_bytes -= old[1]
        self._entries[key] = (value, int(nbytes))
        self.resident_bytes += int(nbytes)
        return self._evict_lru(set(pinned) | {key})

    def get_or_build(self, key: Hashable,
                     build: Callable[[], Tuple[Any, int]],
                     pinned: Iterable[Hashable] = ()) -> Any:
        """The cached value, or ``build()``'s ``(value, nbytes)`` inserted
        and returned; ``build`` runs only on a miss."""
        hit = self.get(key)
        if hit is not None:
            return hit
        value, nbytes = build()
        self.put(key, value, nbytes, pinned=pinned)
        return value

    def counters(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / max(total, 1),
            "evictions": self.evictions,
            "evicted_bytes": self.evicted_bytes,
            "resident_bytes": self.resident_bytes,
            "entries": len(self._entries),
        }
