"""Build the port's CUDA sources on first use and bind them with ctypes.

Every `csrc/*.cu` is compiled by `nvcc` for `sm_90a` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes). Libraries land in
`<repo>/build/repro_torch_kernels/<hash of the sources and headers>/`, so
an edited source or header never loads a stale build. All sources compile
in parallel, one `nvcc` each.

`CudaKernel` is one C entry point: the wrapper passes tensors' data
pointers and PyTorch's current stream, the C function returns
`cudaGetLastError()`, and a non-zero code raises. `launches` counts the
launches that went through, so a run can show its path used the kernel;
`route_launches` counts them by the route label a wrapper gives: the
accumulator of reduction and scan ("f32", "int32"), va's and flash's
route, gemv's accumulator and route ("int32/ring"). `reset` zeroes both.
`check_cuda` holds the preconditions every wrapper checks before a launch.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}     # source name -> nvcc's output (ptxas -v)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    """The build's directory, named by a hash of every source and header
    in CSRC and the flags, so that no edit loads a stale library."""
    h = hashlib.sha256()
    for src in sorted([*sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def find_nvcc() -> str:
    """`$CUDA_HOME/bin/nvcc`, else `nvcc` on PATH."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def build_all() -> float:
    """Compile every source not yet built (all at once, one nvcc each) and
    load the libraries. Returns the seconds it took."""
    t0 = time.perf_counter()
    out_dir = build_dir()
    todo = [s for s in sources() if s.stem not in _LIBS]
    missing = [s for s in todo if not (out_dir / f"lib{s.stem}.so").is_file()]
    if missing:
        nvcc = find_nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in missing:
            tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, tmp, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOG[src.name] = log
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
            else:
                os.replace(tmp, out_dir / f"lib{src.stem}.so")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for src in todo:
        _LIBS[src.stem] = ctypes.CDLL(str(out_dir / f"lib{src.stem}.so"))
    return time.perf_counter() - t0


def library(stem: str) -> ctypes.CDLL:
    if stem not in _LIBS:
        build_all()
    return _LIBS[stem]


def check_cuda(name: str, *tensors, contiguous: bool = True) -> None:
    """Raise unless `tensors` are CUDA tensors on one device, and
    contiguous unless `contiguous` is false."""
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name} kernel needs CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    if contiguous and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")


class CudaKernel:
    """One C entry point `symbol` of `csrc/<stem>.cu` with its ctypes
    argument types; built on the first launch."""

    def __init__(self, stem: str, symbol: str, argtypes: list):
        self.stem, self.symbol, self.argtypes = stem, symbol, argtypes
        self.launches = 0
        self.route_launches: collections.Counter = collections.Counter()
        self._fn = None

    def reset(self) -> None:
        """Zero the launch counts."""
        self.launches = 0
        self.route_launches.clear()

    def launch(self, *args, route: str | None = None) -> None:
        if self._fn is None:
            lib = library(self.stem)
            fn = getattr(lib, self.symbol)
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            msg = library(self.stem).error_string(rc).decode()
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error "
                               f"{rc} ({msg})")
        self.launches += 1
        if route is not None:
            self.route_launches[route] += 1

    def route_count(self, part: str) -> int:
        """Launches whose route label has `part` as one of its
        "/"-separated parts ("ring" counts "f32/ring" and "int32/ring")."""
        return sum(n for r, n in self.route_launches.items()
                   if part in r.split("/"))
