"""Native (C++) host-side components, built on demand with the system g++.

The device compute path is JAX/XLA; these are the host-runtime pieces the
reference implements natively (mapgen inner loops). Loaded via ctypes; every
consumer has a pure-Python fallback so the framework works without a
toolchain.
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

_DIR = Path(__file__).parent
_LIBS: dict[str, Optional[ctypes.CDLL]] = {}


def load_native(name: str) -> Optional[ctypes.CDLL]:
    """Compile (once) and load lib<name>.so from <name>.cpp; None on failure."""
    if name in _LIBS:
        return _LIBS[name]
    src = _DIR / f"{name}.cpp"
    lib_path = _DIR / f"lib{name}.so"
    try:
        if not lib_path.exists() or lib_path.stat().st_mtime < src.stat().st_mtime:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", str(src), "-o", str(lib_path)],
                check=True, capture_output=True, text=True,
            )
        _LIBS[name] = ctypes.CDLL(str(lib_path))
    except (subprocess.CalledProcessError, OSError) as e:
        logger.warning("native %s unavailable (%s); using Python fallback", name, e)
        _LIBS[name] = None
    return _LIBS[name]
