"""Sweep schedulers.

Parity: reference ``metta/sweep/schedulers/`` — ``GridSearchScheduler``
(exhaustive cartesian grids) and ``AsyncCappedScheduler`` (Protein-driven
suggestions with a cap on concurrently running trials).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Optional

from metta_tpu.sweep.core import ParameterConfig
from metta_tpu.sweep.protein import Protein, _assign


@dataclass
class JobDefinition:
    job_id: int
    params: dict[str, Any]
    info: dict = field(default_factory=dict)


class GridSearchScheduler:
    """Exhaustive grid over explicit value lists {path: [v1, v2, ...]}."""

    def __init__(self, grid: dict[str, list]):
        self.keys = sorted(grid)
        self.combos = list(itertools.product(*(grid[k] for k in self.keys)))
        self.next_idx = 0
        self.results: dict[int, float] = {}

    def next_job(self) -> Optional[JobDefinition]:
        if self.next_idx >= len(self.combos):
            return None
        combo = self.combos[self.next_idx]
        params: dict[str, Any] = {}
        for k, v in zip(self.keys, combo):
            _assign(params, k, v)
        job = JobDefinition(self.next_idx, params, {"kind": "grid"})
        self.next_idx += 1
        return job

    def record(self, job_id: int, objective: float, cost: float = 0.0,
               is_failure: bool = False) -> None:
        self.results[job_id] = objective

    @property
    def done(self) -> bool:
        return self.next_idx >= len(self.combos) and len(self.results) == len(self.combos)


class AsyncCappedScheduler:
    """Protein suggestions with a cap on in-flight trials and a trial budget.

    ``max_parallel`` counts cards, not trials per card: trials that share one
    GPU run one at a time, because each JAX process reserves 75% of the
    card's memory when it starts and a second one fails for want of memory.
    """

    def __init__(self, space: dict[str, ParameterConfig], max_trials: int,
                 max_parallel: int = 1, maximize: bool = True, seed: int = 0):
        self.protein = Protein(space, maximize=maximize, seed=seed)
        self.max_trials = max_trials
        self.max_parallel = max_parallel
        self.launched = 0
        self.in_flight: dict[int, dict] = {}
        self.finished = 0

    def next_job(self) -> Optional[JobDefinition]:
        if self.launched >= self.max_trials or len(self.in_flight) >= self.max_parallel:
            return None
        params, info = self.protein.suggest()
        job = JobDefinition(self.launched, params, info)
        self.in_flight[job.job_id] = params
        self.launched += 1
        return job

    def record(self, job_id: int, objective: float, cost: float = 0.0,
               is_failure: bool = False) -> None:
        params = self.in_flight.pop(job_id)
        self.protein.observe(params, objective, cost, is_failure)
        self.finished += 1

    @property
    def done(self) -> bool:
        return self.finished >= self.max_trials

    @property
    def best(self):
        return self.protein.best
