"""Trace-time matmul-precision guard for the sim engine.

The engine encodes integer game logic (grid ids, inventories, coordinates,
one-hot LUTs) as float32 matmuls. At default precision a backend may round
float32 matmul operands: on an NVIDIA GPU the default lets float32 products
run in TF32, whose 10 stored mantissa bits hold integers exactly only up to
2,048, and bfloat16 (8 significant bits) rounds any id or count above 256.
Either silently corrupts grid reads and target resolution; an accelerator
that did this once showed assemblers with input resources never activating
while the CPU (always float32) was correct. ``float32`` precision keeps the
products exact, and float32 accumulation is exact for integers < 2^24.

Every engine/render entry point is wrapped so ALL dots traced inside —
including ones in helper modules that forgot an explicit ``precision=`` —
default to float32. Model/loss code stays outside the wrapper and keeps its
bf16 tensor-core speed.
"""

from __future__ import annotations

import functools

import jax


def exact_matmuls(fn):
    """Decorator: trace ``fn`` under ``jax.default_matmul_precision("float32")``."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapped
