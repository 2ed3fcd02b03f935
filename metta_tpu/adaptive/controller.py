"""Adaptive experiment orchestration.

Parity: reference ``metta/adaptive/`` — ``AdaptiveController`` polls a
scheduler for jobs, dispatches them (locally in-process/subprocess; the
reference also has a SkyPilot dispatcher for cloud fleets), collects
objectives, and feeds them back to the scheduler until done.
"""

from __future__ import annotations

import logging
import subprocess
import sys
from typing import Any, Callable, Optional, Protocol

logger = logging.getLogger(__name__)


class Dispatcher(Protocol):
    def dispatch(self, job) -> Any: ...
    def collect(self, handle) -> tuple[float, float, bool]:
        """Returns (objective, cost, is_failure)."""


class LocalDispatcher:
    """Runs each job by calling a user function in-process (or a subprocess
    command when ``command`` is given).

    A subprocess job has the card to itself: jobs run one at a time, and the
    parent process stays off the device — it must not use JAX on the GPU,
    because a JAX process reserves 75% of the card's memory when it first
    touches it and the child would then fail for want of memory."""

    def __init__(self, run_fn: Optional[Callable[[dict], float]] = None,
                 command: Optional[list[str]] = None):
        self.run_fn = run_fn
        self.command = command

    def dispatch(self, job):
        if self.run_fn is not None:
            try:
                objective = self.run_fn(job.params)
                return (float(objective), 0.0, False)
            except Exception as e:  # noqa: BLE001
                logger.warning("job %s failed: %s", job.job_id, e)
                return (0.0, 0.0, True)
        proc = subprocess.run(
            [sys.executable, *self.command, *(f"{k}={v}" for k, v in job.params.items())],
            capture_output=True, text=True,
        )
        ok = proc.returncode == 0
        try:
            objective = float(proc.stdout.strip().splitlines()[-1])
        except (ValueError, IndexError):
            objective, ok = 0.0, False
        return (objective, 0.0, not ok)

    def collect(self, handle):
        return handle


class AdaptiveController:
    """Dispatch/monitor loop (adaptive_controller.py:22-50).

    ``store`` (optional): a run store (``adaptive/store.py`` JsonFileStore /
    WandbStore) that receives init_run + lifecycle summary updates per job,
    so the live monitor (``adaptive/monitor.py``) can watch the experiment.
    """

    def __init__(self, scheduler, dispatcher: Dispatcher,
                 on_result: Optional[Callable] = None, store=None,
                 experiment_id: str = "adaptive"):
        self.scheduler = scheduler
        self.dispatcher = dispatcher
        self.on_result = on_result
        self.store = store
        self.experiment_id = experiment_id

    def run(self) -> None:
        import time as _time

        while not self.scheduler.done:
            job = self.scheduler.next_job()
            if job is None:
                break
            run_id = f"{self.experiment_id}_{job.job_id}"
            if self.store is not None:
                self.store.init_run(run_id, group=self.experiment_id,
                                    config=dict(job.params))
                self.store.update_run_summary(run_id, {"has_started_training": True})
            t0 = _time.time()
            handle = self.dispatcher.dispatch(job)
            objective, cost, failed = self.dispatcher.collect(handle)
            self.scheduler.record(job.job_id, objective, cost, failed)
            if self.store is not None:
                self.store.update_run_summary(run_id, {
                    "has_completed_training": True,
                    "has_started_eval": True,
                    "has_been_evaluated": not failed,
                    "has_failed": failed,
                    "objective": objective,
                    "cost": cost,
                    "runtime": _time.time() - t0,
                })
            if self.on_result:
                self.on_result(job, objective)
            logger.info("job %d: objective %.4f%s", job.job_id, objective,
                        " (failed)" if failed else "")
