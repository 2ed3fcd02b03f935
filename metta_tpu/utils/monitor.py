"""System monitoring + heartbeat.

Parity: reference ``mettagrid/profiling/system_monitor.py`` /
``memory_monitor.py`` (background sampling threads) and
``common/util/heartbeat.py`` (watchdog file touch).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Optional

import psutil


def record_heartbeat(path: Optional[str] = None) -> None:
    """Touch the heartbeat file (env HEARTBEAT_FILE when path not given)."""
    path = path or os.environ.get("HEARTBEAT_FILE")
    if not path:
        return
    try:
        with open(path, "w") as f:
            f.write(str(time.time()))
    except OSError:
        pass


class SystemMonitor:
    """Background sampler: cpu%, rss, and (when available) device memory."""

    def __init__(self, interval_s: float = 5.0, history: int = 120):
        self.interval = interval_s
        self.samples: deque = deque(maxlen=history)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _sample(self) -> dict:
        proc = psutil.Process()
        s = {
            "time": time.time(),
            "cpu_percent": psutil.cpu_percent(),
            "mem_rss_gb": proc.memory_info().rss / 2**30,
            "mem_available_gb": psutil.virtual_memory().available / 2**30,
        }
        try:
            import jax

            stats = jax.local_devices()[0].memory_stats()
            if stats:
                s["device_mem_gb"] = stats.get("bytes_in_use", 0) / 2**30
                s["device_mem_limit_gb"] = stats.get("bytes_limit", 0) / 2**30
        except Exception:  # noqa: BLE001
            pass
        return s

    def _loop(self):
        while not self._stop.wait(self.interval):
            self.samples.append(self._sample())

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1)
            self._thread = None

    def latest(self) -> dict:
        return self.samples[-1] if self.samples else self._sample()

    def stats(self) -> dict:
        latest = self.latest()
        return {f"monitor/{k}": v for k, v in latest.items() if k != "time"}
