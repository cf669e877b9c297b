"""ctypes binding for the native HARM dump parser (native/harmio.cpp).

The shared library is built on demand with g++ the first time it is needed;
if the toolchain is unavailable the caller falls back to numpy parsing.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger("grmonty")

_lock = threading.Lock()
_lib = None
_tried = False

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "harmio.cpp")


def _so_path():
    """Build-cache path keyed on the source hash — a stale or foreign-built
    binary can never be picked up silently (mtime comparisons are unreliable
    after a fresh clone, where every file shares the checkout time)."""
    import hashlib

    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    cache = os.environ.get(
        "GRMONTY_NATIVE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "grmonty_native"),
    )
    os.makedirs(cache, exist_ok=True)
    return os.path.join(cache, f"libharmio_{h}.so")


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            so = _so_path()
            if not os.path.exists(so):
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", so, _SRC, "-lpthread"],
                    check=True,
                    capture_output=True,
                )
            lib = ctypes.CDLL(so)
            lib.harmio_parse_doubles.restype = ctypes.c_int64
            lib.harmio_parse_doubles.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
                ctypes.c_int32,
            ]
            _lib = lib
        except Exception as exc:  # pragma: no cover - depends on toolchain
            log.debug("native harmio unavailable (%s); using numpy fallback", exc)
            _lib = None
        return _lib


def parse_doubles(text: str) -> np.ndarray | None:
    """Parse whitespace-separated doubles; None if the native lib is unusable."""
    lib = _load()
    if lib is None:
        return None
    raw = text.encode()
    cap = len(raw) // 2 + 16  # every token needs >=1 digit + 1 separator
    out = np.empty(cap, dtype=np.float64)
    n = lib.harmio_parse_doubles(
        raw, len(raw), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap, 0
    )
    if n < 0:
        return None
    return out[:n].copy()
