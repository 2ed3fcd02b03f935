"""Tool framework: pydantic configs as CLI entry points.

Parity: reference ``common/src/metta/common/tool/`` + ``tools/run.py`` — a
recipe module exposes functions returning configured Tool instances; the CLI
loads ``recipes.module.function``, applies ``key=value`` overrides onto the
pydantic tree, and invokes the tool.
"""

from __future__ import annotations

import importlib
import sys
from typing import Any, Literal, Optional

from metta_tpu.config.base import Config


class Tool(Config):
    """Base class: a pydantic config with an ``invoke`` method.

    ``device``: "cpu" or "gpu", set before the tool body runs. "gpu" keeps
    the CPU backend beside the card (task templates are built on it) and
    fails when JAX's first device is not a GPU. None leaves JAX's choice.
    """

    device: Optional[Literal["cpu", "gpu"]] = None

    def invoke(self) -> Optional[int]:
        raise NotImplementedError

    def _apply_device(self) -> None:
        import jax

        if self.device == "cpu":
            jax.config.update("jax_platforms", "cpu")
        elif self.device == "gpu":
            from metta_tpu.utils.device import require_gpu

            jax.config.update("jax_platforms", "cuda,cpu")
            require_gpu()
        elif self.device is not None:
            raise SystemExit(f"device must be cpu or gpu, got {self.device!r}")


def _coerce(value: str) -> Any:
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    if value.lower() in ("none", "null"):
        return None
    return value


def apply_overrides(tool: Tool, overrides: list[str]) -> Tool:
    for ov in overrides:
        if "=" not in ov:
            raise SystemExit(f"Override must be key=value, got {ov!r}")
        key, value = ov.split("=", 1)
        tool.override(key, _coerce(value))
    return tool


def load_tool(path: str) -> Tool:
    """Load ``recipes.module.function`` (or module with a ``train``/default fn)."""
    mod_path, _, fn_name = path.rpartition(".")
    try:
        mod = importlib.import_module(path)
        fn = getattr(mod, "train", None) or getattr(mod, "tool", None)
        if fn is None:
            raise AttributeError
    except (ImportError, AttributeError):
        mod = importlib.import_module(mod_path)
        fn = getattr(mod, fn_name)
    tool = fn()
    if not isinstance(tool, Tool):
        raise SystemExit(f"{path} did not return a Tool (got {type(tool)})")
    return tool


def cli_entry(argv: Optional[list[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: run.py <recipes.module.function> [key=value ...]")
        return 2
    tool = load_tool(argv[0])
    apply_overrides(tool, argv[1:])
    tool._apply_device()
    from metta_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    return tool.invoke() or 0
