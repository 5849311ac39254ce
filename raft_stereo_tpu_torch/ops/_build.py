"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` file is compiled by `nvcc` into its own shared library
with a plain C interface and loaded with `ctypes` — no PyTorch headers, so a
build takes seconds. Libraries land in the build directory, by default
`raft_stereo_tpu_torch/_build/` (git-ignored), named by a hash of the
source, the shared headers (`csrc/*.cuh`) and the flags, so an edited
source or header is rebuilt and an unchanged one is reused. The build
happens at first use, never at import; `build(names)` compiles several
sources in parallel, one `nvcc` process each. Each source has its own
flags (`SOURCE_FLAGS`). Every write goes to a temporary file first and
lands with `os.replace`, so several processes (the ranks of one machine)
may share a directory.

The build directory is set once per process, before the first library
loads (`set_build_dir`; serving/aot.py points it at a kernel cache).
Beside each library lies `<lib>.sha256`, the digest of its bytes: a
library whose bytes or digest do not match, or that does not load, is
removed with a warning and built again (`evictions`), so a damaged
directory costs a build and never a run.

Two kinds of listener observe the directory (utils/jit_hygiene.py,
serving/aot.py): compile listeners get `(name, seconds)` for each `nvcc`
run, the port's counterpart of JAX's backend-compile event; load
listeners get `(name, hit)` for each library a process makes ready, `hit`
when it was found built. Loading a library already built is not a
compile.

No fallback: a missing `nvcc` or a failed compile raises.

The launch plumbing that the streaming elementwise kernels share (the GRU
tail, the motion tail and the gate pair: ops/gru_tail.py, ops/gates.py)
lives here too: their operand check, the 16-byte vector test and width,
and `stream_blocks`, their grid: one thread per 16-byte unit of work, at
most 32 blocks of 256 threads per multiprocessor of the card, read from
the device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List

import torch

logger = logging.getLogger(__name__)

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

# The H100's dynamic shared memory of a block (227 KB), the bound every
# kernel plan checks its shared bytes against.
MAX_SHARED_BYTES = 232448

# RLock: `load` builds while holding it, and `set_build_dir` takes it too.
_lock = threading.RLock()
_libs: Dict[str, ctypes.CDLL] = {}
_compile_listeners: List[Callable[[str, float], None]] = []
_load_listeners: List[Callable[[str, bool], None]] = []
# Libraries removed because their bytes, digest or load failed.
evictions = 0


# Launch counters are shared by every thread that launches: a fleet's
# replicas run their batches on threads of their own, and `+=` on a dict
# entry is not atomic across threads.
_LAUNCH_LOCK = threading.Lock()


def count_launch(counts: Dict[str, int], name: str) -> None:
    """Add one launch of `name` to a wrapper's LAUNCHES."""
    with _LAUNCH_LOCK:
        counts[name] += 1


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


def set_build_dir(path) -> Path:
    """Point every later build and load of this process at `path`. Before
    the first library loads it may move freely; after that, only to the
    directory it already names (a loaded library cannot move), else
    RuntimeError."""
    global BUILD_DIR
    path = Path(path).resolve()
    with _lock:
        if _libs and path != Path(BUILD_DIR).resolve():
            raise RuntimeError(f"the kernel build directory is {BUILD_DIR} and {sorted(_libs)} loaded from it; "
                               f"it cannot move to {path} in this process")
        BUILD_DIR = path
    return path


def add_compile_listener(fn: Callable[[str, float], None]) -> None:
    with _lock:
        _compile_listeners.append(fn)


def remove_compile_listener(fn: Callable[[str, float], None]) -> None:
    with _lock:
        if fn in _compile_listeners:
            _compile_listeners.remove(fn)


def add_load_listener(fn: Callable[[str, bool], None]) -> None:
    with _lock:
        _load_listeners.append(fn)


def remove_load_listener(fn: Callable[[str, bool], None]) -> None:
    with _lock:
        if fn in _load_listeners:
            _load_listeners.remove(fn)


def _notify(listeners, *args) -> None:
    with _lock:
        targets = list(listeners)
    for fn in targets:
        fn(*args)


def _digest_file(so: Path) -> Path:
    return so.with_suffix(".sha256")


def _sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


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
        _replace_text(so.with_suffix(".log"), out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
            continue
        # The digest lands first: a reader that finds the library finds
        # its digest.
        _replace_text(_digest_file(so), _sha256(tmp))
        os.replace(tmp, so)
        _notify(_compile_listeners, name, times[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def _replace_text(path: Path, text: str) -> None:
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    tmp.write_text(text)
    os.replace(tmp, path)


def _evict(name: str, so: Path, why: str) -> None:
    """Remove a library that cannot be trusted, loudly; the caller builds
    it again."""
    global evictions
    for path in (so, _digest_file(so)):
        try:
            path.unlink()
        except FileNotFoundError:
            pass
    with _lock:
        evictions += 1
    logger.warning("kernel library %s evicted from %s (%s): building it again", name, so.parent, why)


def _open_built(name: str, so: Path):
    """The loaded library at `so` if it is there, its digest matches and
    it loads; else None, after evicting whatever was there."""
    if not so.exists():
        return None
    digest = _digest_file(so)
    try:
        want = digest.read_text().strip()
        got = _sha256(so)
    except OSError as exc:
        _evict(name, so, f"unreadable: {exc!r}")
        return None
    if got != want:
        _evict(name, so, f"sha256 {got[:16]} does not match its digest {want[:16]}")
        return None
    try:
        return ctypes.CDLL(str(so))
    except OSError as exc:
        _evict(name, so, f"does not load: {exc}")
        return None


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed (or
    if what was built cannot be trusted)."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        so = _target(name)
        lib = _open_built(name, so)
        hit = lib is not None
        if not hit:
            build([name])
            lib = ctypes.CDLL(str(so))
        _libs[name] = lib
    _notify(_load_listeners, name, hit)
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


# -- the streaming elementwise kernels' launch plumbing -------------------------

STREAM_THREADS = 256  # threads per block of csrc/gru_tail.cu and csrc/gates.cu
STREAM_BLOCKS_PER_SM = 32


def stream_blocks(units: int, sms: int) -> int:
    """Blocks of STREAM_THREADS threads for a grid-stride pass over `units`
    units of work (elements, or 16-byte groups of them) on a card of `sms`
    multiprocessors: one unit per thread, at most STREAM_BLOCKS_PER_SM
    blocks per multiprocessor (the loop strides over the rest), at least
    one."""
    return max(1, min(-(-units // STREAM_THREADS), sms * STREAM_BLOCKS_PER_SM))


@functools.lru_cache(maxsize=None)
def multiprocessors(device_index: int) -> int:
    """The multiprocessor count of CUDA device `device_index`, read once."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def device_blocks(units: int, device: torch.device) -> int:
    """`stream_blocks` on `device`'s card."""
    return stream_blocks(units, multiprocessors(device.index))


def vector_width(dtype: torch.dtype) -> int:
    """Elements of `dtype` in one 16-byte access: 4 fp32, 8 bf16."""
    return 128 // torch.finfo(dtype).bits


def aligned(tensors) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def check_operands(name, tensors, device):
    """Raise unless every tensor is contiguous, on `device`, and of one
    dtype, fp32 or bf16 (a mix raises: the kernels have one element type),
    and none requires grad (no backward)."""
    dtype = tensors[0].dtype
    for t in tensors:
        if t.device != device or t.dtype != dtype or dtype not in DTYPE_FLAGS or not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous tensors of one dtype, fp32 or bf16, on one "
                             f"CUDA device; got {[(str(u.dtype), u.is_contiguous()) for u in tensors]}")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"{name} kernel has no backward; call it without grad")
