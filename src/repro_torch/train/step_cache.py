"""Palette-keyed compiled-step cache.

XLA compiles one executable per input shape; the `ShapePalette` bounds the
shape domain, and this cache makes the bound *observable*: every jitted
training-step function is keyed by its bucketed ``(kind, stage, mbs, seq)``
shape, so ``misses`` counts actual compilations and ``hits/misses`` measures
how well palette bucketing amortizes them across iterations. The plan-ahead
runner keeps one cache for the whole run (shared by the sequential grad step
and every pipeline stage's fwd/bwd), so steady-state iterations execute with
zero recompiles.
"""

from __future__ import annotations

from typing import Any, Callable, Hashable


class CompiledStepCache:
    """Build-once map from shape key -> jitted callable, with hit/miss stats."""

    def __init__(self) -> None:
        self._fns: dict[Hashable, Any] = {}
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable, build: Callable[[], Any]) -> Any:
        fn = self._fns.get(key)
        if fn is None:
            self.misses += 1
            fn = self._fns[key] = build()
        else:
            self.hits += 1
        return fn

    def __len__(self) -> int:
        return len(self._fns)

    def keys(self):
        return self._fns.keys()

    def keys_for(self, kind: str):
        """Keys whose leading element is ``kind`` (``"grad"``, ``"fwd"``,
        ``"mesh"``, ...). Tests and benches use this to assert recompile
        bounds per execution plane — e.g. the mesh backend's compiled-step
        count must stay ≤ palette shapes × log2 micro-batch buckets."""
        return [k for k in self._fns
                if isinstance(k, tuple) and k and k[0] == kind]

    def count(self, kind: str) -> int:
        """Number of compiled entries for one key kind (see keys_for)."""
        return len(self.keys_for(kind))

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {
            "entries": len(self._fns),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hit_rate(), 4),
        }
