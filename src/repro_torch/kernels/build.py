"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with
``ctypes``; nothing here includes PyTorch's headers, so a build takes
seconds. Libraries land in ``build/kernels/`` at the repository root
(ignored by git), named by a digest of the sources and flags, so a
changed source is rebuilt and an unchanged one is reused. ``build()``
starts one ``nvcc`` per source, all at once, and waits for them.
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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("fused_gpv", "sparse_addto", "inc_agg", "quantize",
           "dequantize", "flash_attn", "flash_attn_bwd", "pack_int8")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# guards every wrapper's counts (``launches``, ``plain_calls``, the
# scatters' ``lanes``): the switch daemon launches kernels from one
# handler thread per connection, and ``+= 1`` on an attribute is a
# read-modify-write that two threads can interleave
COUNT_LOCK = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all started together. Returns seconds per source built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    took = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return took


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed. ``signatures``
    maps each C function to its ``argtypes``; every function returns the
    ``cudaError_t`` of its launches as an int."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def launch(name: str, signatures: dict, fn: str, *args) -> None:
    """Call the C function ``fn`` of library ``name`` with ``args`` and
    PyTorch's current stream; raises on the ``cudaError_t`` it returns
    (a refused launch never runs, and no synchronize would report it)."""
    lib = load(name, signatures)
    # a pointer even where ``signatures`` leaves the stream out: ctypes
    # would pass a bare int as a 32-bit C int
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = getattr(lib, fn)(*args, stream)
    if err:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")


def count(wrapper, name: str = "launches") -> None:
    """Add one to the count ``name`` (``launches`` or ``plain_calls``) of
    a kernel wrapper, under ``COUNT_LOCK``."""
    with COUNT_LOCK:
        setattr(wrapper, name, getattr(wrapper, name) + 1)
