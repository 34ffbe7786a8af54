"""Straggler mitigation (a copy of the JAX package's
``distributed/straggler.py``; pure Python).

On a synchronous SPMD mesh a slow host stalls every step, so detection +
policy lives on the host side:

  * `StepMonitor` — per-step wall-time tracker flagging outliers against
    a rolling median (the signal real fleets page on);
  * policy hooks — on sustained straggle the trainer (a) snapshots via the
    async checkpointer and (b) requests an elastic re-shard excluding the
    slow host (`elastic.remesh`), the standard large-fleet mitigation.
    Data-shard handoff is covered because the pipeline state is part of
    the checkpoint.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


@dataclass
class StragglerEvent:
    step: int
    duration: float
    median: float
    ratio: float


@dataclass
class StepMonitor:
    threshold: float = 2.0          # x median => straggler
    window: int = 32
    patience: int = 3               # consecutive flags before escalation
    on_escalate: Optional[Callable[[StragglerEvent], None]] = None
    _durations: List[float] = field(default_factory=list)
    _consecutive: int = 0
    events: List[StragglerEvent] = field(default_factory=list)
    escalations: int = 0
    _t0: float = 0.0
    _step: int = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> Optional[StragglerEvent]:
        dt = time.perf_counter() - self._t0
        self._step += 1
        hist = self._durations[-self.window:]
        self._durations.append(dt)
        if len(hist) < 5:
            return None
        med = statistics.median(hist)
        if dt > self.threshold * med:
            ev = StragglerEvent(self._step, dt, med, dt / med)
            self.events.append(ev)
            self._consecutive += 1
            if self._consecutive >= self.patience:
                self.escalations += 1
                self._consecutive = 0
                if self.on_escalate is not None:
                    self.on_escalate(ev)
            return ev
        self._consecutive = 0
        return None

    def summary(self) -> dict:
        d = self._durations
        return {
            "steps": len(d),
            "mean_s": statistics.mean(d) if d else 0.0,
            "median_s": statistics.median(d) if d else 0.0,
            "stragglers": len(self.events),
            "escalations": self.escalations,
        }
