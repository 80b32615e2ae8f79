"""Build and bind the CUDA kernels: plain ``nvcc`` + ``ctypes``.

Each ``csrc/<name>.cu`` has an ``extern "C"`` interface and includes no
PyTorch header, so it compiles in seconds into its own shared library.
Libraries are built at first use into ``_build/`` beside the package
(listed in ``.gitignore``), named by a hash of the source and flags, and
written under a temporary name and renamed so that parallel processes
never load a half-written file. ``-Xptxas -v`` output (registers, spills)
is kept beside each library.

Host code (``csrc/<name>.cpp``, the checkpoint record log) builds the same
way with the host C++ compiler (``load_host``). A failed build raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# --fmad=false keeps every multiply and add separately rounded, as the
# plain PyTorch versions compute them, so the kernels can agree with
# them to the last bit where the op order is the same.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v"]


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``PATH``, then ``/usr/local/cuda``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put the CUDA toolkit's nvcc on "
        "PATH (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin)")


# Host libraries: plain C++ with a C interface.
HOST_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]


def find_cxx() -> str:
    """``$CXX``, else ``c++`` or ``g++`` on ``PATH``."""
    for c in (os.environ.get("CXX"), "c++", "g++"):
        path = shutil.which(c) if c else None
        if path:
            return path
    raise RuntimeError("no host C++ compiler: set CXX or put c++ or g++ on "
                       "PATH")


def _paths(name: str, host: bool = False):
    src = CSRC / (f"{name}.cpp" if host else f"{name}.cu")
    h = hashlib.sha1(src.read_bytes())
    if not host:
        for hdr in sorted(CSRC.glob("*.cuh")):
            h.update(hdr.read_bytes())
    h.update(" ".join(HOST_FLAGS if host else NVCC_FLAGS).encode())
    stem = f"{name}-{h.hexdigest()[:12]}"
    return src, BUILD_DIR / f"{stem}.so", BUILD_DIR / f"{stem}.log"


def _start(name: str, host: bool = False):
    """Start the compiler for ``name`` unless its library exists; (proc,
    ...)."""
    src, so, log = _paths(name, host)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    if host:
        cmd = [find_cxx(), *HOST_FLAGS, "-o", str(tmp), str(src)]
    else:
        cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so, log, cmd


def _finish(job) -> None:
    proc, tmp, so, log, cmd = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed ({proc.returncode}): "
            f"{' '.join(cmd)}\n{out}")
    log.write_text(out)
    os.replace(tmp, so)


def build(names: Iterable[str], host: Iterable[str] = ()) -> None:
    """Compile the named CUDA sources and ``host`` C++ sources in
    parallel (one compiler process each)."""
    jobs = [j for j in [*(_start(n) for n in names),
                        *(_start(n, True) for n in host)] if j is not None]
    errors: List[Exception] = []
    for job in jobs:
        try:
            _finish(job)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise RuntimeError("\n\n".join(str(e) for e in errors))


def ptxas_summary(name: str) -> str:
    """The ``-Xptxas -v`` lines (registers, spills) of a built kernel."""
    _, _, log = _paths(name)
    if not log.exists():
        return ""
    keep = [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    return "\n".join(keep)


_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def load(name: str, host: bool = False) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (``csrc/<name>.cpp`` with
    ``host``), built on first use."""
    tag = f"host:{name}" if host else name
    with _LOCK:
        lib = _LIBS.get(tag)
        if lib is None:
            build([] if host else [name], [name] if host else [])
            _, so, _ = _paths(name, host)
            lib = ctypes.CDLL(str(so))
            _LIBS[tag] = lib
        return lib


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library for ``csrc/<name>.cpp``, built with the host
    C++ compiler on first use."""
    return load(name, host=True)


class CudaKernel:
    """One C entry point of a kernel library, with its launch count.

    ``launches`` goes up by one each time the wrapper launches the kernel
    (and nowhere else), so a run can show that it went through it.
    """

    def __init__(self, lib_name: str, fn_name: str, argtypes):
        self.lib_name = lib_name
        self.fn_name = fn_name
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(self.lib_name), self.fn_name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        self.launches += 1
        if err != 0:
            raise RuntimeError(
                f"{self.fn_name} launch failed: cudaError {err}")
