"""Build and load the hand-written CUDA kernels (``dgmesh_torch/csrc/*.cu``).

Each source has a plain C interface and is compiled by ``nvcc`` into its own
shared library, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The build happens at first use, into ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``), keyed by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags.  ``build()``
starts one ``nvcc`` per source, all at once.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false``: no multiply-add
contraction, so every float operation rounds as the plain PyTorch twin's
separate elementwise ops do, and z-buffer winners agree with it exactly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
SOURCES = ("composite", "composite_bwd", "shade", "shade_bwd", "mlp_fwd", "mlp_bwd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_log: Dict[str, str] = {}        # name → nvcc/ptxas output of the last build
build_seconds: Dict[str, float] = {}  # name → wall seconds of the last build


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the GPU machine")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names: Optional[List[str]] = None) -> Dict[str, ctypes.CDLL]:
    """Compile (if not already built) and load the named kernel libraries."""
    names = list(names or SOURCES)
    with _lock:
        todo = [n for n in names if n not in _libs and not _target(n).exists()]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for n in todo:                        # one nvcc per source, all at once
                tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
                procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True),
                            tmp, time.perf_counter())
            for n, (p, tmp, t0) in procs.items():
                out, _ = p.communicate()
                build_seconds[n] = time.perf_counter() - t0
                build_log[n] = out
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {n}.cu:\n{out}")
                os.replace(tmp, _target(n))
        for n in names:
            if n not in _libs:
                _libs[n] = ctypes.CDLL(str(_target(n)))
        return {n: _libs[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    return _libs[name] if name in _libs else build([name])[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def check_rows(attrs, lanes: int, what: str) -> None:
    """Raise unless ``attrs`` is (T,K,lanes) float32 on the CPU or a GPU."""
    import torch
    if attrs.dim() != 3 or attrs.shape[-1] != lanes:
        raise ValueError(f"{what}: attrs must be (T,K,{lanes}), got {tuple(attrs.shape)}")
    if attrs.dtype != torch.float32:
        raise TypeError(f"{what}: attrs must be float32, got {attrs.dtype}")
    if attrs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {attrs.device}")


def check_launch(K: int, P: int, what: str, *tensors, whole_warps: bool = False) -> None:
    """Raise unless a tile kernel can take K rows and P pixel threads (whole
    warps where ``whole_warps``) on these contiguous tensors."""
    if K == 0 or not 0 < P <= 1024 or (whole_warps and P % 32):
        raise ValueError(f"{what} needs K > 0 and 0 < P <= 1024"
                         f"{', P a multiple of 32' if whole_warps else ''} (K={K}, P={P})")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")
