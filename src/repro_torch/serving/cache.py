"""Result cache for repeated stencil/grid queries.

Real PDE-solver traffic repeats itself: render grids every frame, stencil
neighbourhoods around the same centers, fixed sensor probes.  ``u(x, t)``
of a frozen solver is a pure function, so repeats never need the program.

``StencilCache`` is a plain LRU keyed on the solver name, the compute
dtype, the quant config's tag and the point's coordinates snapped to a
``quantum``-spaced grid (``round(x / quantum)`` per axis, int64).  At the default ``1e-9`` it is an
exact repeat-query cache for f32 coordinates; a coarser quantum makes it a
deliberate down-resolution cache.

The port's own copy of ``repro.serving.cache`` (which is pure numpy).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

__all__ = ["StencilCache"]


class StencilCache:
    """LRU ``(solver, dtype, quantized point) → u`` cache.

    ``capacity`` counts cached POINTS (not requests).  Not thread-safe by
    itself — the engine serializes access from its step loop.
    """

    def __init__(self, capacity: int = 65536, quantum: float = 1e-9):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if quantum <= 0:
            raise ValueError(f"quantum must be positive, got {quantum}")
        self.capacity = int(capacity)
        self.quantum = float(quantum)
        self._store: OrderedDict[bytes, float] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def keys_for(self, solver: str, dtype, points: np.ndarray,
                 quant_tag: str = "") -> list:
        """Quantized cache keys for a (n, in_dim) point batch (quantized in
        f64, so the key grid does not depend on the query's dtype).
        ``quant_tag`` (``QuantConfig.tag()``, empty for f32 serving) keeps
        the values of a quantized program from answering another config's
        query; an empty tag leaves the key format as it was."""
        pts = np.asarray(points, np.float64)
        cells = np.round(pts / self.quantum).astype(np.int64)
        prefix = f"{solver}|{np.dtype(dtype).name}|".encode()
        if quant_tag:
            prefix += f"{quant_tag}|".encode()
        return [prefix + row.tobytes() for row in cells]

    def lookup(self, keys: list) -> tuple:
        """Split a key batch into ``(hit_idx, hit_vals, miss_idx)``; hits
        are refreshed to most-recently-used."""
        hit_idx, hit_vals, miss_idx = [], [], []
        store = self._store
        for i, k in enumerate(keys):
            v = store.get(k)
            if v is None:
                miss_idx.append(i)
            else:
                store.move_to_end(k)
                hit_idx.append(i)
                hit_vals.append(v)
        self.hits += len(hit_idx)
        self.misses += len(miss_idx)
        return (np.asarray(hit_idx, np.int64),
                np.asarray(hit_vals, np.float64),
                np.asarray(miss_idx, np.int64))

    def insert(self, keys: list, values: np.ndarray) -> None:
        """Insert computed values, evicting least-recently-used past
        capacity."""
        store = self._store
        for k, v in zip(keys, np.asarray(values, np.float64)):
            if k in store:
                store.move_to_end(k)
            store[k] = float(v)
        while len(store) > self.capacity:
            store.popitem(last=False)
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._store)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"size": len(self._store), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": self.hits / total if total else 0.0}
