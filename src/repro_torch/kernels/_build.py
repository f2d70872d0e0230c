"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/repro_torch_kernels/<digest>/lib<name>.so`` at the root of
the checkout (git-ignored). The digest covers every source and the flags,
so an edited kernel rebuilds and an unchanged one loads from disk. All
missing libraries compile in parallel, one ``nvcc`` process per source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("sign_corr", "sign_corr_packed", "code_corr", "quantize",
           "flash_prefill", "decode_attention", "row_normals")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
#: seconds the last :func:`build_all` spent compiling (0.0 when cached)
last_build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every kernel library that is not built yet, in parallel;
    returns the build directory. Raises with nvcc's output on failure."""
    global last_build_seconds
    out = build_dir()
    todo = [k for k in KERNELS if not (out / f"lib{k}.so").exists()]
    if not todo:
        last_build_seconds = 0.0
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for k in todo:
        tmp = out / f"lib{k}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{k}.cu")]
        procs.append((k, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for k, tmp, p in procs:
        log, _ = p.communicate()
        (out / f"lib{k}.log").write_text(log)
        if p.returncode != 0:
            failed.append(f"--- {k} (exit {p.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out / f"lib{k}.so")
    last_build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (building it if needed), with
    ``signatures`` — {C function: argtypes} — declared; every C entry
    point returns its ``cudaError_t`` as an int."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
