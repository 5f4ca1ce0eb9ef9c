"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
compiler process per source, all started together), and the objects are
linked into ONE shared library with a plain C interface, loaded with
``ctypes``.  No source includes PyTorch's headers, so a cold build takes
seconds.  The build happens at first use and again whenever a hash of the
sources and flags changes; its output lives in ``build/repro_torch/`` at
the root of the checkout (listed in ``.gitignore``), next to the
compiler's log with each kernel's register and shared-memory use.

Nothing here runs at import: the CPU tests import every module, and this
machine's compiler is only needed by a caller that launches a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_functions: dict[str, object] = {}
build_seconds: float | None = None   # wall time of this process's build


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(ARCH + FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build repro_torch's CUDA kernels")


def library_path() -> Path:
    return BUILD_DIR / f"libreprotorch_{source_hash()}.so"


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands concurrently; raise with the log of the first that
    fails.  Every process started here has ended when this returns."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        logs = [p.communicate()[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{log}")
    return logs


def build() -> Path:
    """Compile the sources if the library for their hash is missing.
    Concurrent builders are safe: each works in its own temporary
    directory and the finished library is renamed into place."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        units = [src for src in sources() if src.suffix == ".cu"]
        objs = [Path(tmp) / (src.stem + ".o") for src in units]
        logs = _run_all([[compiler, *ARCH, *FLAGS, "-c", str(src), "-o",
                          str(obj)]
                         for src, obj in zip(units, objs)])
        lib = Path(tmp) / out.name
        logs += _run_all([[compiler, *ARCH, "-shared", *map(str, objs),
                           "-o", str(lib)]])
        out.with_suffix(".log").write_text("\n".join(logs))
        os.replace(lib, out)
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
        _lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        _lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return _lib


def function(name: str, argtypes):
    """C entry ``name`` with its argument types declared (``c_void_p`` for
    every pointer and the stream, or ctypes would cut them to 32 bits)."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(load(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check(err: int, name: str) -> None:
    if err != 0:
        msg = load().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"error {err} ({msg})")
