"""Build the port's CUDA kernels with nvcc at first use and bind them with
ctypes.

Each kernel is one ``csrc/*.cu`` translation unit with a plain C interface,
compiled for Hopper (``sm_90a``) into a shared library under the checkout's
``build/kernels/`` directory (git-ignored).  The library name carries a hash
of the flags, the kernel's own source and the headers it includes, so an
edited source rebuilds only the kernels that include it and an unchanged one
loads as is.  :func:`build` starts one nvcc per missing library, all at
once, and waits for them together.  A missing nvcc or a failed build raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import re
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# IEEE f32 throughout: no --use_fast_math, and FTZ off explicitly.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-ftz=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


class Kernel:
    """One CUDA kernel: its source, its ctypes entry points and the count of
    its launches (raised by the wrapper at each launch, nowhere else)."""

    def __init__(self, name: str, source: str, functions: dict):
        self.name = name
        self.source = CSRC / source
        self.functions = functions   # C symbol -> (argtypes, restype)
        self.launches = 0
        self.build_log = ""
        self._lib = None

    def library_path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sources_of(self.source):
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def lib(self):
        """The loaded library (built first if missing), entry points typed."""
        if self._lib is None:
            path = self.library_path()
            if not path.exists():
                build([self])
            lib = ctypes.CDLL(str(path))
            for sym, (argtypes, restype) in self.functions.items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = restype
            self._lib = lib
        return self._lib


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources_of(source: Path) -> list[Path]:
    """``source`` and every header it includes with ``#include "..."``,
    transitively, sorted by path (what its library's hash covers)."""
    seen, todo = set(), [source.resolve()]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in _INCLUDE.findall(path.read_bytes()):
            todo.append((path.parent / name.decode()).resolve())
    return sorted(seen)


def nvcc() -> str:
    """The nvcc on PATH, else the one under PyTorch's resolved CUDA home."""
    path = shutil.which("nvcc")
    if path:
        return path
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(kernels) -> None:
    """Compile every kernel whose library is missing, one nvcc each, all
    started together.  Raises with nvcc's output if any build fails."""
    todo = [k for k in kernels if not k.library_path().exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    jobs = []
    for k in todo:
        out = k.library_path()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(k.source)]
        jobs.append((k, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for k, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        k.build_log = log
        if proc.returncode != 0:
            failed.append(f"{k.source.name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)     # atomic: a concurrent loader sees all or none
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def check_status(kernel: Kernel, status: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if status != 0:
        raise RuntimeError(
            f"{kernel.name} launch failed with cudaError {status}")
