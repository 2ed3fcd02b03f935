"""Where the program runs: the GPU guard, the card's name and power limit,
and the persistent compilation cache.

JAX falls back to the CPU without a word when its CUDA plugin fails to load,
so every entry point that measures or trains on the card calls
:func:`require_gpu` first.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Optional

import jax

CHECKOUT = Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Keep JAX's persistent compilation cache in ``JAX_COMPILATION_CACHE_DIR``
    when that is set (JAX reads it itself; nothing else is set), otherwise in
    ``<checkout>/.jax_cache``. Returns the directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> list:
    """JAX's devices, or RuntimeError when the first one is not a GPU."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {devices[0].platform} "
            f"({devices[0].device_kind})")
    return devices


def device_summary() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    devices = jax.devices()
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def gpu_name_and_power_limit() -> list[str]:
    """``nvidia-smi``'s ``name, power.limit`` line for each card. Runs in a
    child process, which does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def device_busy_seconds(call, trace_dir: str) -> tuple[Optional[float], list[str]]:
    """Run ``call()`` once under the JAX profiler and return the device's busy
    time in it: the union of the kernel intervals on the GPU planes'
    ``Stream`` lines. Also returns the device lines seen, so a trace that
    names its lines otherwise can be read by hand; the time is None then."""
    from jax.profiler import ProfileData

    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(call())
    path = sorted(Path(trace_dir).glob("plugins/profile/*/*.xplane.pb"))[-1]
    intervals, seen = [], []
    for plane in ProfileData.from_file(str(path)).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            seen.append(f"{plane.name}|{line.name}")
            if line.name.startswith("Stream"):
                intervals += [(e.start_ns, e.end_ns) for e in line.events]
    if not intervals:
        return None, seen
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy * 1e-9, seen
