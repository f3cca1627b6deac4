"""Build and load the port's hand-written CUDA kernels.

Each source in ``deeplearning4j_tpu_torch/csrc/`` is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library with a plain C
interface, loaded with ``ctypes``. Libraries land in ``build/kernels/`` at
the root of the checkout (listed in ``.gitignore``), named by a hash of
the source, the shared headers and the flags, and are built at first use: a fresh checkout
builds on its first kernel call. All missing libraries are compiled
together, one ``nvcc`` process per source.

Nothing here runs at import: a host without ``nvcc`` imports this module
and the CPU paths never call it. A missing compiler or a failed build
raises with the compiler's output; there is no fallback.
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
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# one shared library per source; the name is the source's stem
SOURCES = ("flash_attn_fwd", "flash_attn_bwd", "flash_attn_fwd_sm90",
           "flash_attn_dkv_sm90", "flash_attn_dq_sm90", "paged_decode",
           "fused_updater", "bn_matmul_stats", "bn_matmul_stats_sm90",
           "fused_matmul", "fused_matmul_sm90", "fused_matmul_f32_sm90",
           "fused_layer_norm", "matmul_int8", "matmul_int8_sm90",
           "flash_attn_fwd_f32_sm90", "flash_attn_dq_f32_sm90",
           "flash_attn_dkv_f32_sm90")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_fns: Dict[tuple, "ctypes._CFuncPtr"] = {}  # (library, function) -> typed
# ptxas register/shared-memory report of each library built by this process
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the port's CUDA kernels "
        "are built from source at first use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    # the shared headers (``*.cuh``) are part of every source's key
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build(names: Optional[Sequence[str]] = None) -> float:
    """Compile every library of ``names`` (all of :data:`SOURCES` when
    None) that is not built yet, one ``nvcc`` per source, all started
    together. Returns the seconds spent (0 when all were built already);
    raises with the compiler output of each failed build."""
    names = SOURCES if names is None else names
    missing = [n for n in names if not _lib_path(n).exists()]
    if not missing:
        return 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for n in missing:
        # write to a private name, rename when done: a concurrent builder
        # never sees a half-written library
        tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors: List[str] = []
    for n, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"--- nvcc {n}.cu (exit {p.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        build_logs[n] = out
        os.replace(tmp, _lib_path(n))
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def kernel_fn(name: str, fn: str, argtypes: Sequence) -> "ctypes._CFuncPtr":
    """The C function ``fn`` of library ``name``, typed with ``argtypes``
    and returning ``int`` (the launch's ``cudaError_t``); builds every
    missing library first."""
    with _lock:
        f = _fns.get((name, fn))
        if f is None:
            build()
            f = getattr(ctypes.CDLL(str(_lib_path(name))), fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
            _fns[(name, fn)] = f
    return f
