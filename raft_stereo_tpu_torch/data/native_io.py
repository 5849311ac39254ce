"""ctypes binding of the native IO core (`native/io_core.cc`): the same C
ABI and entry points as the JAX package's `raft_stereo_tpu/data/native_io.py`
(PFM and PNG decode in C++ threads outside the GIL, a bounded prefetch
pool, and the fused in-place colour-jitter ops).

This is host I/O, not a device kernel. The library is built at first use,
never at import: `g++ -O3 -std=c++17 -fPIC -shared native/io_core.cc -lpng
-lz -pthread` into `raft_stereo_tpu_torch/_build/` (git-ignored; nothing is
written under `native/`), named by a hash of the source and the command, to
a unique temporary name that is renamed into place atomically, so
concurrent first uses never load a half-written library. When the
toolchain or libpng is missing, `available()` is False and every caller
takes the pure-Python path (frame_io.py's PNG codec and PFM reader,
augment.py's numpy ops), as the JAX package does. Set
RAFT_STEREO_TPU_NATIVE_IO=0 to disable it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import subprocess
import threading
from typing import Iterator, Optional, Sequence, Tuple
import uuid

import numpy as np

KIND_PFM = 0
KIND_PNG = 1

_DTYPES = {0: np.uint8, 1: np.uint16, 2: np.float32}

_PACKAGE_DIR = osp.dirname(osp.dirname(osp.abspath(__file__)))
SOURCE = osp.join(osp.dirname(_PACKAGE_DIR), "native", "io_core.cc")
BUILD_DIR = osp.join(_PACKAGE_DIR, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-Wall", "-fPIC", "-shared")
LIBS = ("-lpng", "-lz", "-pthread")


class _RsioImage(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.c_void_p),
        ("h", ctypes.c_int64),
        ("w", ctypes.c_int64),
        ("c", ctypes.c_int64),
        ("dtype", ctypes.c_int32),
        ("scale", ctypes.c_float),
    ]


_lock = threading.Lock()
_lib_cache: Optional[ctypes.CDLL] = None
_lib_failed = False
_has_jitter = False
# Why the library is unavailable (None while it loads or before first use).
unavailable_reason: Optional[str] = None


def build_command(out_path: str) -> list:
    """The compiler command that builds the library at `out_path`."""
    return [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", out_path, SOURCE, *LIBS]


def library_path() -> str:
    """Where the library for this source and command lives in _build/."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(build_command("")).encode()).hexdigest()[:16]
    return osp.join(BUILD_DIR, f"libraft_io-{digest}.so")


def _build(so: str) -> None:
    """Compile to a unique temporary name beside `so`, then rename it into
    place; a failed build leaves nothing behind."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.build-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    try:
        subprocess.run(build_command(tmp), check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
    finally:
        if osp.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


def _load() -> Optional[ctypes.CDLL]:
    global _lib_cache, _lib_failed, _has_jitter, unavailable_reason
    if _lib_cache is not None or _lib_failed:
        return _lib_cache
    with _lock:
        if _lib_cache is not None or _lib_failed:
            return _lib_cache
        if os.environ.get("RAFT_STEREO_TPU_NATIVE_IO") == "0":
            _lib_failed = True
            unavailable_reason = "disabled by RAFT_STEREO_TPU_NATIVE_IO=0"
            return None
        try:
            so = library_path()
            if not osp.exists(so):
                # Built under the once-init lock: one thread compiles, the
                # others wait for the handle.
                _build(so)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            if isinstance(detail, bytes):
                detail = detail.decode(errors="replace")
            unavailable_reason = f"{type(e).__name__}: {e} {detail[-500:]}".strip()
            _lib_failed = True
            return None
        for name in ("rsio_read_pfm", "rsio_read_png"):
            getattr(lib, name).argtypes = [ctypes.c_char_p, ctypes.POINTER(_RsioImage)]
            getattr(lib, name).restype = ctypes.c_int
        lib.rsio_free.argtypes = [ctypes.POINTER(_RsioImage)]
        lib.rsio_pool_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.rsio_pool_create.restype = ctypes.c_void_p
        lib.rsio_pool_submit.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int]
        lib.rsio_pool_submit.restype = ctypes.c_int
        lib.rsio_pool_pop.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(_RsioImage),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.rsio_pool_pop.restype = ctypes.c_int
        lib.rsio_pool_destroy.argtypes = [ctypes.c_void_p]
        fp = ctypes.POINTER(ctypes.c_float)
        lib.rsio_blend_scalar.argtypes = [fp, ctypes.c_int64, ctypes.c_float, ctypes.c_float]
        lib.rsio_blend_gray.argtypes = [fp, ctypes.c_int64, ctypes.c_float]
        lib.rsio_gray_mean.argtypes = [fp, ctypes.c_int64]
        lib.rsio_gray_mean.restype = ctypes.c_double
        lib.rsio_gamma.argtypes = [fp, ctypes.c_int64, ctypes.c_float, ctypes.c_float]
        _has_jitter = True
        _lib_cache = lib
        return lib


def available() -> bool:
    """True when the native library is (or can be) built and loaded."""
    return _load() is not None


def _to_numpy(lib, img: _RsioImage) -> np.ndarray:
    try:
        dtype = _DTYPES[img.dtype]
        count = img.h * img.w * img.c
        buf = ctypes.cast(
            img.data, ctypes.POINTER(ctypes.c_uint8 * (count * np.dtype(dtype).itemsize))
        ).contents
        arr = np.frombuffer(buf, dtype=dtype, count=count).copy()
        shape = (img.h, img.w) if img.c == 1 else (img.h, img.w, img.c)
        return arr.reshape(shape)
    finally:
        lib.rsio_free(ctypes.byref(img))


def read_pfm(path: str) -> np.ndarray:
    """Native PFM decode, bit-exact with frame_io.read_pfm. Raises on error."""
    lib = _load()
    if lib is None:
        raise ImportError("native IO library unavailable")
    img = _RsioImage()
    rc = lib.rsio_read_pfm(path.encode(), ctypes.byref(img))
    if rc != 0:
        raise IOError(f"rsio_read_pfm({path!r}) failed with code {rc}")
    return _to_numpy(lib, img)


def read_png(path: str) -> np.ndarray:
    """Native PNG decode (8-bit gray/GA/RGB/RGBA, 16-bit gray), matching
    the stdlib codec of frame_io.py (PIL's array layout). Raises on error."""
    lib = _load()
    if lib is None:
        raise ImportError("native IO library unavailable")
    img = _RsioImage()
    rc = lib.rsio_read_png(path.encode(), ctypes.byref(img))
    if rc != 0:
        raise IOError(f"rsio_read_png({path!r}) failed with code {rc}")
    return _to_numpy(lib, img)


_tls = threading.local()


def _thread_pool(n_threads: int) -> "Prefetcher":
    """Per-thread persistent pool: loader worker threads are long-lived, so
    this amortizes C++ thread creation across all of a worker's samples, and
    thread-locality keeps tag spaces of concurrent read_images calls
    disjoint without cross-thread routing."""
    pool = getattr(_tls, "pool", None)
    if pool is None:
        pool = Prefetcher(n_threads=n_threads)
        _tls.pool = pool
    return pool


def read_images(paths: Sequence[str], n_threads: int = 4) -> list:
    """Decode a batch of image files concurrently in native threads.

    The bulk-read entry point the dataset layer uses for multi-file items
    (e.g. the 10 gated-slice PNGs per all-gated frame, datasets.py Gated).
    Files the native decoder rejects (palette/interlaced/16-bit
    multichannel/non-PNG) fall back to `frame_io.read_image` individually;
    with no native library at all, the whole batch falls back. Returns
    arrays in input order."""
    out: list = [None] * len(paths)
    pending = list(range(len(paths)))
    if available() and len(paths) > 1:
        pf = _thread_pool(n_threads)
        try:
            for i in pending:
                pf.submit(i, paths[i])
            done = []
            for _ in pending:
                tag, arr = pf.pop(strict=False)
                if arr is not None:
                    out[tag] = arr
                    done.append(tag)
            pending = [i for i in pending if i not in done]
        except BaseException:
            # A partial drain would leave stale tagged results that corrupt
            # the NEXT call on this thread — destroy the per-thread pool so
            # a fresh one is built on next use.
            _tls.pool = None
            pf.close()
            raise
    if pending:
        from raft_stereo_tpu_torch.data import frame_io

        for i in pending:
            out[i] = frame_io.read_image(paths[i])
    return out


class Prefetcher:
    """Threaded native decode pool: submit paths, pop decoded arrays.

    Decode runs in C++ threads (no GIL); the results queue is bounded, so
    producers backpressure instead of ballooning host RAM. Use as a context
    manager; `pop()` returns (tag, array) and raises on decode failure."""

    def __init__(self, n_threads: int = 4, queue_cap: int = 8):
        lib = _load()
        if lib is None:
            raise ImportError("native IO library unavailable")
        self._lib = lib
        self._pool = lib.rsio_pool_create(n_threads, queue_cap)
        if not self._pool:
            raise RuntimeError("rsio_pool_create failed")

    def submit(self, tag: int, path: str, kind: Optional[int] = None) -> None:
        if kind is None:
            kind = KIND_PFM if path.lower().endswith(".pfm") else KIND_PNG
        rc = self._lib.rsio_pool_submit(self._pool, tag, path.encode(), kind)
        if rc != 0:
            raise RuntimeError(f"rsio_pool_submit failed with code {rc}")

    def pop(self, strict: bool = True) -> Tuple[int, Optional[np.ndarray]]:
        tag = ctypes.c_uint64()
        img = _RsioImage()
        status = ctypes.c_int()
        rc = self._lib.rsio_pool_pop(
            self._pool, ctypes.byref(tag), ctypes.byref(img), ctypes.byref(status)
        )
        if rc != 0:
            raise RuntimeError("rsio_pool_pop: no work pending")
        if status.value != 0:
            if strict:
                raise IOError(f"native decode failed with code {status.value}")
            return tag.value, None
        return tag.value, _to_numpy(self._lib, img)

    def read_all(self, paths: Sequence[str]) -> Iterator[Tuple[int, np.ndarray]]:
        for i, p in enumerate(paths):
            self.submit(i, p)
        for _ in paths:
            yield self.pop()

    def close(self) -> None:
        if self._pool:
            self._lib.rsio_pool_destroy(self._pool)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# --------------------------------------------------- fused color jitter ----
# In-place photometric ops on C-contiguous float32 arrays (data/augment.py's
# loader-hot path): one fused C pass each instead of numpy's 2-3 full-frame
# temporaries, and ctypes releases the GIL so thread workers overlap. Every
# entry returns False (or None) when the native path cannot apply — caller
# falls back to the numpy formulation, which is term-for-term identical.


def _jitter_ready(img: np.ndarray) -> bool:
    lib = _load()
    return (
        lib is not None
        and _has_jitter
        and img.dtype == np.float32
        and img.flags["C_CONTIGUOUS"]
        and img.flags["WRITEABLE"]
    )


def _fptr(img: np.ndarray):
    return img.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def blend_scalar_(img: np.ndarray, factor: float, addend: float) -> bool:
    """img = clip(img * factor + addend, 0, 255), in place."""
    if not _jitter_ready(img):
        return False
    _lib_cache.rsio_blend_scalar(_fptr(img), img.size, factor, addend)
    return True


def blend_gray_(img: np.ndarray, factor: float) -> bool:
    """Saturation: blend each RGB pixel toward its gray value, in place."""
    if not (_jitter_ready(img) and img.ndim >= 2 and img.shape[-1] == 3):
        return False
    _lib_cache.rsio_blend_gray(_fptr(img), img.size // 3, factor)
    return True


def gray_mean(img: np.ndarray) -> Optional[float]:
    """Mean grayscale projection (adjust_contrast's scalar)."""
    if not (_jitter_ready(img) and img.ndim >= 2 and img.shape[-1] == 3):
        return None
    return float(_lib_cache.rsio_gray_mean(_fptr(img), img.size // 3))


def gamma_(img: np.ndarray, gamma: float, gain: float) -> bool:
    """img = clip(255 * gain * (img/255)**gamma), in place."""
    if not _jitter_ready(img):
        return False
    _lib_cache.rsio_gamma(_fptr(img), img.size, gamma, gain)
    return True
