"""MultiDimension — labeled metrics (reference bvar/multi_dimension.h:35).

A family of variables keyed by label values (Prometheus-style), e.g.
``MultiDimension(Adder, ["method", "status"])`` then
``m.get_stats(["Echo", "ok"]) << 1``. The Prometheus exporter walks
families to emit `name{label="v"} value` lines.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Sequence, Tuple

from incubator_brpc_tpu_torch.metrics.variable import Variable, _registry, _registry_lock, _sanitize


class MultiDimension(Variable):
    def __init__(self, factory: Callable[[], Variable], labels: Sequence[str]):
        super().__init__()
        self._factory = factory
        self._labels = list(labels)
        self._stats: Dict[Tuple, Variable] = {}
        self._lock = threading.Lock()

    @property
    def labels(self) -> List[str]:
        return self._labels

    def get_stats(self, label_values: Sequence) -> Variable:
        key = tuple(label_values)
        if len(key) != len(self._labels):
            raise ValueError(f"expected {len(self._labels)} labels, got {len(key)}")
        with self._lock:
            var = self._stats.get(key)
            if var is None:
                var = self._factory()
                self._stats[key] = var
            return var

    def has_stats(self, label_values: Sequence) -> bool:
        return tuple(label_values) in self._stats

    def delete_stats(self, label_values: Sequence):
        with self._lock:
            self._stats.pop(tuple(label_values), None)

    def count_stats(self) -> int:
        return len(self._stats)

    def items(self):
        with self._lock:
            return list(self._stats.items())

    def get_value(self):
        return self.count_stats()

    # separator for label tuples flattened into JSON object keys; \t
    # cannot appear in metric label values that survive the /metrics
    # exposition, so the join is reversible
    _KEY_SEP = "\t"

    def mergeable_snapshot(self) -> dict:
        """{"labels": [...], "stats": {joined-key: state}} where state
        is the sub-variable's own mergeable_snapshot when it has one,
        or its numeric value for plain sum-mergeable counters (Adder);
        non-numeric subs without mergeable state are skipped — there is
        no exact merge for them."""
        stats = {}
        for key, var in self.items():
            snap_fn = getattr(var, "mergeable_snapshot", None)
            if snap_fn is not None:
                state = snap_fn()
            else:
                state = var.get_value()
                if isinstance(state, bool) or not isinstance(
                    state, (int, float)
                ):
                    continue
            stats[self._KEY_SEP.join(str(k) for k in key)] = state
        return {"labels": list(self._labels), "stats": stats}

    def describe(self) -> str:
        parts = []
        for key, var in self.items():
            lbl = ",".join(f'{k}="{v}"' for k, v in zip(self._labels, key))
            parts.append(f"{{{lbl}}} {var.describe()}")
        return "\n".join(parts)
