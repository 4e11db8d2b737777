"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``paddle_tpu_torch/csrc/<name>.cu`` is compiled on its own by
``nvcc`` into ``build/paddle_tpu_torch/lib<name>.so`` (a plain C
interface, no PyTorch headers, so a build takes seconds) and loaded with
``ctypes``. :func:`build_all` starts one ``nvcc`` per source at once and
waits for all of them; :func:`load` builds a single library on demand.
A library newer than its sources is reused. Nothing here runs when a
module is imported.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "SOURCES", "nvcc_path", "build_all",
           "load"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "paddle_tpu_torch"
SOURCES = ("ragged_paged_attention", "paged_decode_attention",
           "norm_matmul", "matmul_residual", "flash_attention_fwd",
           "flash_attention_bwd", "moe_gmm", "flashmask_fwd",
           "flashmask_bwd")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
_LOCK = threading.Lock()
_LIBS = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and "
            "PATH): the CUDA kernels of paddle_tpu_torch are built from "
            "source at first use")
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    srcs = [CSRC / f"{name}.cu"] + list(CSRC.glob("*.cuh"))
    return max(p.stat().st_mtime for p in srcs) > lib.stat().st_mtime


def _command(name: str, verbose: bool):
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-I", str(CSRC),
           "-o", str(_lib_path(name)), str(CSRC / f"{name}.cu")]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd


def build_all(verbose: bool = False) -> dict:
    """Compile every stale source in parallel; returns
    ``{name: seconds}`` for the builds it ran (empty when all are fresh).
    Raises ``RuntimeError`` with the compiler output on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for name in SOURCES:
        if _stale(name):
            procs[name] = subprocess.Popen(
                _command(name, verbose), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
    times, errors = {}, []
    for name, p in procs.items():
        out, _ = p.communicate()
        times[name] = time.monotonic() - t0
        if verbose and out:
            print(out)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if stale."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        if _stale(name):
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            res = subprocess.run(_command(name, False),
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name}.cu:\n{res.stdout}{res.stderr}")
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
        return lib
