"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, from the package's own sources, into ``hawkeye_tpu_torch/_build/``
(listed in ``.gitignore``), keyed on a hash of the source and the flags, so a
fresh checkout builds on its first call. All missing libraries are compiled
together, one ``nvcc`` process per source.

There is no fallback: a missing ``nvcc``, a failed build or a failed launch
raises. ``LAUNCHES`` counts each kernel launch (the wrappers add one right
after a launch that returned no error), so a run can show that its path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("pool.cu", "gram.cu", "batch_norm.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# C signatures of the exported functions: name -> (source, argtypes)
_SIGNATURES = {
    "hk_pool_fwd": ("pool.cu", [_I, _P, _P, _P, _I, _I, _I, _I, _P]),
    "hk_pool_bwd": ("pool.cu", [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "hk_gram_signed_sqrt": ("gram.cu",
                            [_I, _P, _P, _I, _I, _I, ctypes.c_float, _P]),
    "hk_batch_norm_stats": ("batch_norm.cu", [_I, _P, _L, _I, _P, _P, _L, _P, _I, _P]),
    "hk_batch_norm_apply": ("batch_norm.cu",
                            [_I, _P, _P, _P, _P, _F, _P, _P, _P, _P, _L, _I, _P]),
    "hk_batch_norm_backward_reduce": (
        "batch_norm.cu", [_I, _P, _P, _P, _P, _L, _I, _P, _P, _P, _P, _L, _P, _I, _P]),
    "hk_batch_norm_backward_apply": (
        "batch_norm.cu", [_I, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _P]),
}

LAUNCHES = {"pool_fwd": 0, "pool_bwd": 0, "gram_signed_sqrt": 0,
            "batch_norm_stats": 0, "batch_norm_apply": 0,
            "batch_norm_backward_reduce": 0, "batch_norm_backward_apply": 0}
BUILD_LOG: dict[str, str] = {}  # source -> nvcc's stderr (-Xptxas -v report)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _lib_path(source: str, nvcc: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources=SOURCES) -> dict[str, Path]:
    """Compile every source whose library is missing, all at once; return
    {source: library path}. Raises with nvcc's output on any failure."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {s: _lib_path(s, nvcc) for s in sources}
    procs = {}
    for s, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
        procs[s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True), tmp)
    failures = []
    for s, (proc, tmp) in procs.items():
        out, err = proc.communicate()
        BUILD_LOG[s] = (out or "") + (err or "")
        if proc.returncode != 0:
            failures.append(f"nvcc {s} exited {proc.returncode}:\n{BUILD_LOG[s]}")
            continue
        os.replace(tmp, paths[s])
    if failures:
        raise RuntimeError("kernel build failed\n" + "\n".join(failures))
    return paths


def _load(source: str) -> ctypes.CDLL:
    with _lock:
        if source not in _libs:
            paths = build(tuple(s for s in SOURCES if s not in _libs))
            for s, path in paths.items():
                lib = ctypes.CDLL(str(path))
                for name, (src, argtypes) in _SIGNATURES.items():
                    if src == s:
                        fn = getattr(lib, name)
                        fn.argtypes = argtypes
                        fn.restype = ctypes.c_int
                _libs[s] = lib
        return _libs[source]


def kernel(name: str):
    """The ctypes function ``name`` (built and loaded on first use)."""
    return getattr(_load(_SIGNATURES[name][0]), name)


def check(rc: int, name: str):
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def dtype_code(dtype) -> int:
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]


def require_cuda(name: str, *tensors):
    """Device and contiguity checks shared by the wrappers."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def stream_of(tensor) -> int:
    return torch.cuda.current_stream(tensor.device).cuda_stream
