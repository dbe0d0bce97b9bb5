"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/repro_torch/`` at the repository root, then loaded with ``ctypes``.
A library is built at first use and rebuilt when its source or flags
change: the file name carries a hash of both. :func:`build` compiles
several sources at once, one ``nvcc`` process each, all started together.

Nothing here runs at import: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = {name: CSRC / f"{name}.cu" for name in
           ("mixed_attention", "decode_attention", "prefill_attention",
            "contiguous_decode", "contiguous_prefill")}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[str, object] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built on the machine with the card")
    return found


def library_path(name: str) -> Path:
    """The library's path; its name hashes the source, the shared headers
    of ``csrc/`` and the flags."""
    src = SOURCES[name].read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None,
          verbose: bool = False) -> Dict[str, str]:
    """Compile the named kernels (default: all) whose library is missing,
    concurrently. ``verbose`` adds ``-Xptxas -v`` and forces a rebuild into
    the same path, so the compiler's register and spill report is
    returned. Returns ``{name: compiler output}``; raises on a failed
    build."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists() and not verbose:
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)     # atomic: concurrent builders race safely
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def entry(name: str, symbol: str, pointers: int, ints: int):
    """The C entry ``symbol`` of kernel library ``name``, typed: ``pointers``
    pointer arguments, then ``ints`` int arguments, then the stream; it
    returns a ``cudaError_t`` as an int."""
    fn = _ENTRIES.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _ENTRIES[symbol] = fn
    return fn
