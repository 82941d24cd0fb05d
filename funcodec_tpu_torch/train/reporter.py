"""Training metric aggregation and best-epoch bookkeeping (port of
funcodec_tpu/train/reporter.py; ``Reporter.state_dict`` is the same JSON, so
a reporter.json written by either package loads in the other).

Behavioral reference: funcodec/train/reporter.py (Average/WeightedAverage
:103-116, SubReporter :118-280, Reporter :282-540: epoch logs, best-epoch
queries, early stopping, state_dict round trip).

Under data parallelism each rank registers the global batch's stats (the
train step's, and validation's reduced over the ranks) into a reporter of
its own; rank 0 writes reporter.json and decides early stopping.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Any, Dict, List, Optional


class SubReporter:
    """Accumulates (weighted) means of scalar stats within one epoch phase."""

    def __init__(self, key: str, epoch: int):
        self.key = key
        self.epoch = epoch
        self._sums: Dict[str, float] = defaultdict(float)
        self._weights: Dict[str, float] = defaultdict(float)
        self.count = 0
        self._start = time.time()

    def register(self, stats: Dict[str, Any], weight: float = 1.0) -> None:
        self.count += 1
        for k, v in stats.items():
            if v is None:
                continue
            v = float(v)
            self._sums[k] += v * weight
            self._weights[k] += weight

    def mean(self, key: str) -> float:
        w = self._weights.get(key, 0.0)
        return self._sums[key] / w if w > 0 else float("nan")

    def keys(self):
        return self._sums.keys()

    def to_dict(self) -> Dict[str, float]:
        return {k: self.mean(k) for k in self._sums}

    def log_message(self, start: int = 0) -> str:
        parts = [f"{self.epoch}epoch:{self.key}:{self.count}batch"]
        parts += [f"{k}={self.mean(k):.4g}" for k in sorted(self._sums)]
        parts += [f"time={time.time() - self._start:.1f}s"]
        return " ".join(parts)


class Reporter:
    """Per-epoch history of {phase: {stat: mean}} with best-epoch queries."""

    def __init__(self):
        self.epoch = 0
        self.stats: Dict[int, Dict[str, Dict[str, float]]] = {}

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def start_epoch(self, key: str) -> SubReporter:
        return SubReporter(key, self.epoch)

    def finish_epoch(self, sub: SubReporter) -> None:
        self.stats.setdefault(sub.epoch, {})[sub.key] = sub.to_dict()

    def get_value(self, phase: str, key: str, epoch: Optional[int] = None) -> float:
        epoch = epoch if epoch is not None else self.epoch
        return self.stats[epoch][phase][key]

    def has(self, phase: str, key: str, epoch: Optional[int] = None) -> bool:
        epoch = epoch if epoch is not None else self.epoch
        return key in self.stats.get(epoch, {}).get(phase, {})

    def sort_epochs(self, phase: str, key: str, mode: str = "min") -> List[int]:
        """Epochs sorted best-first by a criterion (reporter.py:401-427)."""
        assert mode in ("min", "max")
        pairs = [
            (e, ph[phase][key])
            for e, ph in self.stats.items()
            if phase in ph and key in ph[phase]
        ]
        pairs.sort(key=lambda kv: kv[1], reverse=(mode == "max"))
        return [e for e, _ in pairs]

    def best_epoch(self, phase: str, key: str, mode: str = "min") -> Optional[int]:
        order = self.sort_epochs(phase, key, mode)
        return order[0] if order else None

    def check_early_stopping(
        self, patience: int, phase: str, key: str, mode: str = "min"
    ) -> bool:
        best = self.best_epoch(phase, key, mode)
        if best is None:
            return False
        return (self.epoch - best) > patience

    def state_dict(self) -> Dict[str, Any]:
        return {"epoch": self.epoch, "stats": self.stats}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.epoch = d["epoch"]
        # json round trips turn int keys into str
        self.stats = {int(k): v for k, v in d["stats"].items()}
