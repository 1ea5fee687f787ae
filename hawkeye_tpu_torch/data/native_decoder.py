"""ctypes bridge to the native JPEG decoder (``native/decoder.cpp``).

Counterpart of ``hawkeye_tpu/data/native_decoder.py``, with the port's own
copy of the C++ source. The library is built at first use with the JAX
package's command (``g++ -O3 -shared -fPIC decoder.cpp -ljpeg``) into
``hawkeye_tpu_torch/_build/`` (listed in ``.gitignore``), keyed on a hash of
the source, so a fresh checkout builds on its first call and a stale binary
is never loaded. A call releases the GIL (``ctypes.CDLL``), so the loader's
threads decode in parallel.

Where the library does not build or load (no g++ or no libjpeg), the JAX
package falls back to PIL without a word; the port falls back too, since
PIL is the reference's decoder, but logs once which decoder it uses and
why (``describe``), and the Trainer's log names it. A file the native path
cannot take (not a JPEG, or corrupt) returns None and its caller decodes it
with PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "data", "native", "decoder.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")

_lock = threading.Lock()
_lib = None
_error = None  # why the library is unavailable, once a build failed
_logged = False


def lib_path():
    """The library's path, keyed on the source's hash."""
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libhawkeye_decoder-{digest}.so")


def _build(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", SRC, "-ljpeg", "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{' '.join(cmd)} failed: {proc.stderr.strip()[-400:]}")
    os.replace(tmp, path)  # atomic against concurrent builders


def get_lib():
    """The loaded library (built if needed), or None if it cannot be had."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is None and _error is None:
            try:
                path = lib_path()
                if not os.path.exists(path):
                    _build(path)
                lib = ctypes.CDLL(path)
                lib.decode_resize_center.restype = ctypes.c_int
                lib.decode_resize_center.argtypes = [
                    ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8)]
                _lib = lib
            except Exception as e:  # noqa: BLE001
                _error = f"{type(e).__name__}: {e}"
    _log_once()
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def describe() -> str:
    """Which decoder ``FGDataset(decode_size=...)`` uses, in one line."""
    if get_lib() is not None:
        return f"native libjpeg decoder ({os.path.relpath(lib_path(), _PKG)})"
    return f"PIL (the native decoder is unavailable: {_error})"


def _log_once():
    global _logged
    if not _logged:
        _logged = True
        logging.getLogger("hawkeye").info(f"JPEG decode: {describe()}")


def decode_resize_center(path: str, target: int) -> np.ndarray | None:
    """A JPEG file -> uint8 [target, target, 3] (shorter side resized to
    ``target``, then center-cropped), or None where the native path cannot
    take the file (the caller falls back to PIL)."""
    lib = get_lib()
    if lib is None:
        return None
    with open(path, "rb") as f:
        data = f.read()
    out = np.empty((target, target, 3), np.uint8)
    rc = lib.decode_resize_center(
        data, len(data), target, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if rc == 0 else None
