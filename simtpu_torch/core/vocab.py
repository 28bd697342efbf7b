"""String interning for ragged k8s metadata.

Device kernels can't chew on label strings; every string-valued feature (label
key/value pairs, taint triples, topology domains, resource names) is interned
to a dense integer id at tensorization time. This replaces the reference's
map[string]string lookups inside the scheduler hot loop
(`vendor/.../core/generic_scheduler.go:271-341`).
"""

from __future__ import annotations

from typing import Dict, Hashable, List


class Interner:
    """Monotonic string→id mapping."""

    def __init__(self) -> None:
        self._ids: Dict[Hashable, int] = {}
        self._items: List[Hashable] = []

    def intern(self, item: Hashable) -> int:
        idx = self._ids.get(item)
        if idx is None:
            idx = len(self._items)
            self._ids[item] = idx
            self._items.append(item)
        return idx

    def get(self, item: Hashable) -> int:
        """-1 for unknown items (never allocates)."""
        return self._ids.get(item, -1)

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, item: Hashable) -> bool:
        return item in self._ids

    def items(self) -> List[Hashable]:
        return list(self._items)

    def lookup(self, idx: int) -> Hashable:
        return self._items[idx]
