"""Retry with backoff for transient I/O: a copy of the JAX package's
`raft_stereo_tpu/utils/retry.py` (the port imports nothing from it).

A long training run crossing flaky storage must not lose hours of progress
to one transient, while deterministic failures (missing files, permission
walls) surface at once. `is_transient_io` classifies filesystem and network
errors by errno (FileNotFoundError, PermissionError and
Is(Not)ADirectoryError are never retried); `is_transient_marker` matches
substrings of the exception text. `retry_call` and the decorator
`retry_transient` retry with jittered exponential backoff: attempt i sleeps
`min(max_delay, base_delay * 2**i) * uniform(1 - jitter, 1 + jitter)`; the
jitter RNG and `sleep` are injectable for tests. `StereoDataset.load_raw`
and the trainer's checkpoint I/O use them.
"""

from __future__ import annotations

import errno
import functools
import logging
import random
import time
from typing import Callable, Optional, Sequence, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")

# Exception-text markers of transient connection drops.
TRANSIENT_MARKERS: Sequence[str] = (
    "remote_compile",
    "response body",
    "Connection",
    "connection",
    "DEADLINE",
)

# errnos worth a second attempt: interrupted/slow I/O and flaky network
# mounts (EIO shows up for NFS/gcsfuse blips; EBUSY/EAGAIN for contended
# checkpoint dirs on shared filesystems).
_TRANSIENT_ERRNOS = frozenset(
    e
    for e in (
        errno.EAGAIN,
        errno.EBUSY,
        errno.EINTR,
        errno.EIO,
        errno.ENOBUFS,
        errno.ENOSPC,  # space can free up (checkpoint GC runs concurrently)
        errno.ESTALE,
        errno.ETIMEDOUT,
        getattr(errno, "ECONNRESET", None),
        getattr(errno, "ECONNABORTED", None),
        getattr(errno, "ENETDOWN", None),
        getattr(errno, "ENETUNREACH", None),
    )
    if e is not None
)


def is_transient_marker(exc: BaseException, markers: Sequence[str] = TRANSIENT_MARKERS) -> bool:
    """Marker substring in the exception text."""
    return any(m in str(exc) for m in markers)


def is_transient_io(exc: BaseException) -> bool:
    """Transient-vs-deterministic classification for file/checkpoint I/O."""
    if isinstance(
        exc, (FileNotFoundError, PermissionError, IsADirectoryError, NotADirectoryError)
    ):
        return False
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return True
    if isinstance(exc, OSError):
        # errno-less OSErrors (third-party wrappers, raw IOError("msg"))
        # default to transient: the cost of one wasted retry is far below
        # the cost of aborting a 100k-step run on a storage blip.
        return exc.errno is None or exc.errno in _TRANSIENT_ERRNOS
    return is_transient_marker(exc)


def retry_call(
    fn: Callable[[], T],
    *,
    attempts: int = 3,
    base_delay: float = 0.5,
    max_delay: float = 30.0,
    jitter: float = 0.5,
    classify: Callable[[BaseException], bool] = is_transient_io,
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
    label: str = "",
) -> T:
    """Call `fn` with up to `attempts` tries, jittered-exponential backoff
    between transient failures. Deterministic failures (classify→False) and
    the final attempt's failure propagate unchanged."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    rng = rng or random
    for i in range(attempts):
        try:
            return fn()
        except Exception as e:
            if i == attempts - 1 or not classify(e):
                raise
            delay = min(max_delay, base_delay * (2.0**i))
            delay *= 1.0 + jitter * rng.uniform(-1.0, 1.0)
            logger.warning(
                "transient failure%s (attempt %d/%d), retrying in %.2fs: %s",
                f" in {label}" if label else "",
                i + 1,
                attempts,
                delay,
                e,
            )
            sleep(max(0.0, delay))
    raise AssertionError("unreachable")  # pragma: no cover


def retry_transient(
    *,
    attempts: int = 3,
    base_delay: float = 0.5,
    max_delay: float = 30.0,
    jitter: float = 0.5,
    classify: Callable[[BaseException], bool] = is_transient_io,
):
    """Decorator form of `retry_call` for module-level I/O helpers."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return retry_call(
                lambda: fn(*args, **kwargs),
                attempts=attempts,
                base_delay=base_delay,
                max_delay=max_delay,
                jitter=jitter,
                classify=classify,
                label=getattr(fn, "__qualname__", repr(fn)),
            )

        return wrapped

    return deco
