"""The kernel-library cache: the port's counterpart of
`raft_stereo_tpu/serving/aot.py` (`ExecutableCache`, `maybe_cache`).

JAX persists compiled XLA executables so that a boot deserializes instead
of compiling. The port compiles no programs at run time; its only compiled
artifacts that outlive a process are the kernel libraries that
`ops/_build.py` builds with `nvcc` at first use (seconds each, tens of
seconds for a boot that builds them all). This cache keeps them in a
directory of the caller's choosing, so a second boot (or a respawned
process, or every rank of a training job) loads them and builds nothing.

Layout
------
Libraries live under `cache_dir/<fingerprint>/lib<name>-<digest>.so`. The
**fingerprint** names everything that invalidates every library at once:
`nvcc --version`, the arch flags, the card's name and compute capability,
and a format version; JAX's fingerprint of the jaxlib version and the
device kind plays that role. A toolchain or card change therefore misses
into a fresh directory and never loads a library built for another. The
**digest** (`_build._target`) names one library: its source, the shared
headers and its flags.

The directory is the process's build directory (`_build.set_build_dir`),
set once before the first library loads; a process serves from one cache.

Failure policy
--------------
JAX's: a cache never makes a boot less reliable than building. A library
whose bytes do not match the digest written beside it, or that does not
load, is unlinked with a loud warning, counted as an eviction and a miss,
and built again; the next boot finds it whole.

`stats()` feeds /healthz, the Prometheus gauges and the `serve` boot line:
`entries` is the libraries that this cache's boot made ready, and every
one was a hit or a miss (`entries == cache_hits + cache_misses`).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import subprocess
import threading
from typing import Dict, Optional

from raft_stereo_tpu_torch.ops import _build

logger = logging.getLogger(__name__)

# Bump when the on-disk layout changes: the fingerprint then names a fresh
# directory and stale libraries are never read.
FORMAT_VERSION = 1


def _nvcc_version() -> str:
    try:
        nvcc = _build.nvcc_path()
    except RuntimeError:
        return "no nvcc"
    return subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=False).stdout.strip()


def _card() -> Dict[str, object]:
    import torch

    if not torch.cuda.is_available():
        return {"name": "none", "capability": None}
    return {"name": torch.cuda.get_device_name(0), "capability": list(torch.cuda.get_device_capability(0))}


def fingerprint() -> str:
    """Hex digest naming the (toolchain, card) world a library was built
    in: `nvcc --version`, the arch flags, the card's name and compute
    capability, and the format version."""
    material = {
        "format": FORMAT_VERSION,
        "nvcc": _nvcc_version(),
        "arch": [f for f in _build.NVCC_FLAGS if f.startswith("arch=") or f.startswith("-arch")],
        "card": _card(),
    }
    blob = json.dumps(material, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


class KernelCache:
    """The kernel libraries of this process, kept under
    `cache_dir/<fingerprint>/`.

    Creating one points the process's build directory there
    (`_build.set_build_dir`) and starts counting: every library the process
    makes ready from then on is a hit (found built and whole) or a miss
    (built now, after an eviction when what was there was damaged).
    `close()` stops counting; the directory stays the build directory."""

    def __init__(self, cache_dir: str) -> None:
        self.fingerprint = fingerprint()
        self.root = os.path.join(os.path.abspath(os.path.expanduser(str(cache_dir))), self.fingerprint)
        os.makedirs(self.root, exist_ok=True)
        _build.set_build_dir(self.root)
        self._lock = threading.Lock()
        self.cache_hits = 0
        self.cache_misses = 0
        self._evictions_at_start = _build.evictions
        _build.add_load_listener(self._on_load)

    def _on_load(self, name: str, hit: bool) -> None:
        with self._lock:
            if hit:
                self.cache_hits += 1
            else:
                self.cache_misses += 1

    def close(self) -> None:
        _build.remove_load_listener(self._on_load)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "enabled": True,
                "dir": self.root,
                "fingerprint": self.fingerprint,
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "entries": self.cache_hits + self.cache_misses,
                "evictions": _build.evictions - self._evictions_at_start,
            }

    def files(self) -> int:
        """Libraries on disk under this fingerprint."""
        try:
            return sum(1 for n in os.listdir(self.root) if n.endswith(".so"))
        except OSError:
            return 0


def maybe_cache(cache_dir: Optional[str]) -> Optional[KernelCache]:
    """A KernelCache when a directory is given, else None (the libraries
    stay in the package's `_build/`). A directory that cannot be made is
    reported and the boot goes on without the cache, as in JAX; asking for
    a second directory after libraries have loaded from another raises."""
    if not cache_dir:
        return None
    try:
        return KernelCache(cache_dir)
    except OSError as exc:
        logger.warning("kernel cache: cannot use %s (%r) — disabled", cache_dir, exc)
        return None


__all__ = ["FORMAT_VERSION", "KernelCache", "fingerprint", "maybe_cache"]
