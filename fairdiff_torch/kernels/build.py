"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes)
and its host libraries (the C++ compiler -> shared library -> ctypes).

Each `csrc/<name>.cu` is compiled on first use with
`nvcc -gencode arch=compute_90a,code=sm_90a -shared` into
`build/fairdiff_torch/` at the root of the checkout (listed in .gitignore),
under a file name keyed on a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. The libraries
have a plain C interface: every pointer and the stream are passed as
`ctypes.c_void_p`, and every launch returns `cudaGetLastError()`.

Each `csrc/<name>.cpp` in HOST_LIBRARIES (the image codec, the EMD solver)
is compiled the same way with `$CXX` or `c++` (`-O3 -std=c++17 -shared -fPIC
-pthread -ffp-contract=off`), on the CPU as on the card's host. No FMA
contraction: the EMD solver must break ties in the same double arithmetic
as the JAX package's copy, which is built without it.

There is no fallback: a missing compiler or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fairdiff_torch"
KERNELS = ("flash_attention", "geglu", "group_norm")
HOST_LIBRARIES = ("imageio", "emd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-ffp-contract=off")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _cxx() -> str:
    cxx = os.environ.get("CXX") or "c++"
    found = shutil.which(cxx)
    if not found:
        raise RuntimeError(f"C++ compiler {cxx!r} not found ($CXX, else c++ on PATH)")
    return found


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` (or a host library's `.cpp`) is built, keyed on
    sources and flags."""
    if name in HOST_LIBRARIES:
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
        h.update((CSRC / f"{name}.cpp").read_bytes())
        return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] = KERNELS) -> dict[str, float]:
    """Compile every missing library in `names`, one compiler each, all
    started together. Returns the seconds from that start to each library's
    end (nothing for a library already built); raises with the compiler's
    output on a failed compile. The compiler's report (registers, spills) is
    kept beside each library as `<lib>.log`."""
    t0 = time.perf_counter()
    todo = [(n, library_path(n)) for n in names if not library_path(n).exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        if name in HOST_LIBRARIES:
            cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")]
        else:
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        log = out.with_name(out.name + ".log")
        with open(log, "w") as f:
            procs.append((name, cmd, out, tmp, log, subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)))
    failed, seconds = [], {}
    while len(seconds) < len(procs):
        for name, cmd, out, tmp, log, proc in procs:
            if name in seconds or proc.poll() is None:
                continue
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{cmd[0]} failed for {Path(cmd[-1]).name}:\n{log.read_text()}")
            else:
                os.replace(tmp, out)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu` (or `.cpp`), built first if missing."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))
