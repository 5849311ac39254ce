"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` file is compiled by `nvcc` into its own shared library
with a plain C interface and loaded with `ctypes` — no PyTorch headers, so a
build takes seconds. Libraries land in `raft_stereo_tpu_torch/_build/`
(git-ignored), named by a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source or header is rebuilt and
an unchanged one is reused. The build happens at first
use, never at import; `build(names)` compiles several sources in parallel,
one `nvcc` process each. Each source has its own flags (`SOURCE_FLAGS`).

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

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# Flags of each source beyond NVCC_FLAGS. -fmad=false (no multiply-add
# contraction) keeps an elementwise kernel rounding exactly where its plain
# PyTorch version rounds, so the card shows no difference at all. The two
# GEMM-shaped kernels build with contraction on: under -fmad=false every
# FFMA of their inner loops would become an FMUL plus an FADD, twice the
# issue count, and cuBLAS and cuDNN, their plain versions' libraries, sum
# with FFMAs too; where their rounding must match elementwise ops (the
# operand affine, the division by sqrt(D), the pooling) they use explicit
# __f*_rn intrinsics.
# No source uses --use_fast_math: divisions and square roots stay IEEE.
SOURCE_FLAGS = {
    "corr_lookup": ("-fmad=false",),
    "corr_prefetch": ("-fmad=false",),
    "corr_scatter": ("-fmad=false",),
    "gru_tail": ("-fmad=false",),
    "gates": ("-fmad=false",),
    "encoder_join": ("-fmad=false",),
    "corr_pyramid": ("-fmad=true",),
    "encoder_conv": ("-fmad=true",),
}

# The dtype flag of the C entry points that take fp32 or bf16 tensors
# (corr_lookup, corr_pyramid, encoder_conv, encoder_join, corr_scatter):
# 0 fp32, 1 bf16.
DTYPE_FLAGS = {torch.float32: 0, torch.bfloat16: 1}

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


def nvcc_flags(name: str) -> tuple:
    """Every nvcc flag of `csrc/<name>.cu`: the common ones, then its own."""
    return NVCC_FLAGS + SOURCE_FLAGS[name]


def nvcc_command(nvcc: str, name: str, out: Path) -> list:
    """The command line that compiles `csrc/<name>.cu` into `out`."""
    return [nvcc, *nvcc_flags(name), "-o", str(out), str(CSRC_DIR / f"{name}.cu")]


def _target(name: str) -> Path:
    """The library of `csrc/<name>.cu`, named by a hash of its source, the
    shared headers and its flags."""
    parts = [(CSRC_DIR / f"{name}.cu").read_bytes()]
    parts += [header.read_bytes() for header in sorted(CSRC_DIR.glob("*.cuh"))]
    parts.append(" ".join(nvcc_flags(name)).encode())
    digest = hashlib.sha256(b"\0".join(parts)).hexdigest()[:16]
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
        procs[name] = (so, tmp, subprocess.Popen(
            nvcc_command(nvcc, name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
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
