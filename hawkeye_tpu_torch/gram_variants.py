"""Time edited versions of the bf16 Gram kernel against each other on one card.

    python -m hawkeye_tpu_torch.gram_variants [VARIANT ...]

A VARIANT is ``base`` (``csrc/gram.cu`` as it is) or edits from ``EDITS``
joined by ``+``, for example ``stages4`` or ``nostore``. All variants are
compiled together by ``nvcc`` (the flags of ``ops/_build.py``) into
``_build/variants/``. Each then runs in its own process, so that a fault in
one does not stop the others: it is checked against the plain version
(rtol 1e-4 / atol 1e-5), unless its edit breaks the output on purpose, and
timed at x ``[8,196,512]`` and ``[128,196,512]`` (``chip_smoke.cuda_ms``:
CUDA-graph replays between CUDA events). Prints one JSON line per variant
and shape, with the card's name and power limit. Run from the repository
root (it imports ``chip_smoke``'s timing helpers). Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from .ops import _build, fused_bilinear

SHAPES = [(8, 196, 512), (128, 196, 512)]
# name -> (source edits, whether the output stays right)
EDITS = {
    "stages4": ([("kStages = 8;", "kStages = 4;")], True),
    "stages6": ([("kStages = 8;", "kStages = 6;")], True),
    "stages10": ([("kStages = 8;", "kStages = 10;")], True),
    # the epilogue with the IEEE division and square root
    "ieee": ([("signed_sqrt_fast(acc[4 * q + 2 * h], inv_hw, eps)",
               "signed_sqrt(acc[4 * q + 2 * h], 1.0f / inv_hw, eps)"),
              ("signed_sqrt_fast(acc[4 * q + 2 * h + 1], inv_hw, eps)",
               "signed_sqrt(acc[4 * q + 2 * h + 1], 1.0f / inv_hw, eps)")], True),
    # diagnostics: drop the output stores, or the operand loads (the ring's
    # barriers still complete, the products read stale shared memory)
    "nostore": ([("          tma_store(", "          if (0) tma_store(")], False),
    "noload": ([("        tma_load(st", "        if (0) tma_load(st"),
                ("mbar_expect_tx(bar, kStageBytes);", "mbar_arrive(bar);")], False),
}
VARIANT_DIR = _build.BUILD_DIR / "variants"


def _source(name: str) -> str:
    src = (_build.CSRC / "gram.cu").read_text()
    for key in name.split("+"):
        if key == "base":
            continue
        for old, new in EDITS[key][0]:
            if old not in src:
                raise ValueError(f"edit {key}: {old!r} is not in gram.cu")
            src = src.replace(old, new)
    return src


def build(names):
    """Compile every variant at once; return {name: nvcc's register lines}."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = VARIANT_DIR / f"{name}.cu"
        cu.write_text(_source(name))
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(VARIANT_DIR / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    report = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} exited {proc.returncode}:\n{err}")
        report[name] = [ln.split(":")[-1].strip() for ln in err.splitlines()
                        if "registers" in ln]
    return report


def run(name):
    """Check and time one built variant; print its JSON lines."""
    from chip_smoke import PEAK_BYTES_S, cuda_ms, nvidia_smi_line

    fn = ctypes.CDLL(str(VARIANT_DIR / f"{name}.so")).hk_gram_signed_sqrt
    fn.argtypes = _build._SIGNATURES["hk_gram_signed_sqrt"][1]
    fn.restype = ctypes.c_int

    def gram(x):
        b, hw, c = x.shape
        out = torch.empty((b, c, c), dtype=torch.float32, device=x.device)
        _build.check(fn(1, x.data_ptr(), out.data_ptr(), b, hw, c, 1e-5,
                        _build.stream_of(x)), name)
        return out

    right = all(EDITS[k][1] for k in name.split("+") if k != "base")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    smi = nvidia_smi_line()
    for shape in SHAPES:
        x = torch.relu(torch.randn(shape, device="cuda", generator=gen)).to(torch.bfloat16)
        y, ref = gram(x), fused_bilinear.gram_signed_sqrt_plain(x)
        torch.cuda.synchronize()
        close = bool(((y - ref).abs() <= 1e-5 + 1e-4 * ref.abs()).all())
        if right and not close:
            raise AssertionError(f"variant {name} differs from plain at {shape}")
        del y, ref
        b, hw, c = shape
        ms = cuda_ms(torch, lambda: gram(x))
        bound_ms = (b * hw * c * 2 + b * c * c * 4) / PEAK_BYTES_S * 1e3
        print(json.dumps({"variant": name, "shape": list(shape), "ms": ms,
                          "bound_ms": bound_ms, "share_of_bound": bound_ms / ms,
                          "output_right": close, "nvidia_smi": smi}), flush=True)
        del x
        torch.cuda.empty_cache()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--run"]:
        return run(argv[1])
    if not torch.cuda.is_available():
        raise RuntimeError("gram_variants needs a CUDA device")
    names = argv or ["base"]
    print(json.dumps({"registers": build(names)}), flush=True)
    root = Path(__file__).resolve().parent.parent
    failed = []
    for name in names:
        rc = subprocess.run([sys.executable, "-m", "hawkeye_tpu_torch.gram_variants",
                             "--run", name], cwd=root, timeout=300).returncode
        if rc:
            failed.append(name)
    if failed:
        raise SystemExit(f"variants failed: {failed}")


if __name__ == "__main__":
    main()
