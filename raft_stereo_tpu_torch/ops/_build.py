"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` file is compiled by `nvcc` into its own shared library
with a plain C interface and loaded with `ctypes` — no PyTorch headers, so a
build takes seconds. Libraries land in `raft_stereo_tpu_torch/_build/`
(git-ignored), named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused. The build happens at first
use, never at import; `build(names)` compiles several sources in parallel,
one `nvcc` process each.

No fallback: a missing `nvcc` or a failed compile raises.
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
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# -fmad=false: no multiply-add contraction, so each kernel rounds exactly
# where its plain PyTorch version does (see the notes in the .cu files).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME and /usr/local/cuda)")


def _target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source whose library is missing, all `nvcc`
    processes started together. Returns {name: seconds} for the sources
    compiled now (an up-to-date library is not rebuilt). The ptxas report
    (registers, spills) of each build is kept beside it as `<lib>.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        so = _target(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    times = {}
    errors = []
    for name, (so, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        so.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def build_log(name: str) -> str:
    """The compiler output of the current build of `csrc/<name>.cu`."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(status: int, what: str, error_string) -> None:
    """Raise if a C entry point returned a CUDA error; `error_string` is the
    library's `const char* (int)` wrapper of cudaGetErrorString."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} ({error_string(status).decode()})")
