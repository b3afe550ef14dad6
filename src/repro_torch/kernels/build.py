"""Build the hand-written Hopper kernels and bind them with ``ctypes``.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), one ``nvcc`` process per source, all started together.  Libraries
land in ``<repo>/build/kernels/`` (git-ignored) under a name that carries a
hash of the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source is never served a stale build.  Nothing is compiled at import:
the first launch of any kernel builds them all.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code, because a refused launch never runs
and a later ``synchronize`` would not report it.

The launch counters (:data:`LAUNCHES`) live here too: each wrapper adds one
where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# -fmad=false: no multiply-add contraction, so the elementwise arithmetic
# (K1, the K3/K5 quantizer grid, K4's and K5's products) rounds exactly as
# the plain PyTorch versions do; the contractions of K3, K6 and K7 ask for
# FMA explicitly (fmaf).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]

SOURCES = ("gt_update", "quantize", "sparse_mix", "flash_attention", "ssd_scan")

# name -> launches since the last reset; one entry per ported kernel
LAUNCHES: Dict[str, int] = {
    "fused_local_step": 0,
    "row_absmax": 0,
    "compressed_mix": 0,
    "sparse_mix": 0,
    "sparse_compressed_mix": 0,
    "flash_attention": 0,
    "ssd_scan": 0,
}

_LIBS: Dict[str, ctypes.CDLL] = {}

P = ctypes.c_void_p
I64 = ctypes.c_longlong
I32 = ctypes.c_int
F32 = ctypes.c_float

# C signatures of every entry point, by source
SIGNATURES: Dict[str, Dict[str, List]] = {
    "gt_update": {
        "launch_local_step": [P, P, P, P, P, P, I64, F32, I32, I32, P],
    },
    "quantize": {
        "launch_row_absmax": [P, P, P, I64, I64, P],
        "launch_compressed_mix": [P, P, P, P, P, P, P, I32, I64, F32, F32, I32, P],
    },
    "sparse_mix": {
        "launch_sparse_mix_csr": [P, P, P, P, P, P, I64, I64, P],
        "launch_sparse_compressed_mix_csr": [P, P, P, P, P, P, P, P, P, P, I64, I64, F32, F32,
                                             I32, P],
    },
    "flash_attention": {
        "launch_flash_attention": [P, P, P, P, I64, I32, I32, I32, I32, I32, *[I64] * 9, F32,
                                   I32, I32, I32, P],
    },
    "ssd_scan": {
        "launch_ssd_scan": [P, P, P, P, P, P, P, *[I32] * 6, *[I64] * 12, I32, I32, P],
        "ssd_scan_smem_bytes": [I32, I32],
    },
}

# entry points returning something other than a cudaError_t
RESTYPES = {"ssd_scan_smem_bytes": I64}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # the shared headers, too
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> Dict[str, Path]:
    """Compile every source not yet built, all ``nvcc`` runs in parallel.
    Returns name -> library path; raises with the compiler log on failure.
    The ``-Xptxas -v`` report of each build is kept in ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp)
    errors = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        paths[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, paths[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def build_log(name: str) -> str:
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building all sources on
    first use, with every entry point's ``argtypes``/``restype`` declared."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all()[name]
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = RESTYPES.get(fn_name, ctypes.c_int)
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def last_dim_contiguous(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its last dimension is contiguous (the kernels read
    the other dimensions through their strides), else a contiguous copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def on_cuda(*tensors: Optional[torch.Tensor]) -> bool:
    """True when the tensors lie on a CUDA device (launch the kernel), False
    when on the CPU (use the plain version).  All must share one device."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"
