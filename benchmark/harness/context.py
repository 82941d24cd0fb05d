"""One run of one cell: what the drivers fill in and the metric readers read."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from benchmark.harness.cell import Cell
from benchmark.harness.trace import Spans, Tracer


@dataclasses.dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    spans: Spans = dataclasses.field(default_factory=Spans)
    tracer: Optional[Tracer] = None
    # end-to-end values the serving loop measured, by metric name
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    # what the serving loop counted inside the traced slice: requests, batch
    # shapes, audio seconds, the program's counters
    work: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # number compared -> (value, limit)
    checks: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.tracer is None:
            self.tracer = Tracer(self.trace, self.spans)
