"""Device prefetch: the counterpart of the JAX package's
`raft_stereo_tpu/data/prefetch.py` `DevicePrefetcher`.

The loader (data/loader.py) overlaps decode and augmentation with the
device's work through its bounded queue; the last hop, host numpy to the
card, would otherwise run on the trainer's thread between two steps.
`DevicePrefetcher` wraps the loader and copies batch N+1 to the card while
step N runs: a producer thread pulls host batches, copies each into pinned
host memory and from there to the card with `non_blocking=True` on a side
`torch.cuda.Stream`, records an event on that stream, and hands (batch,
event) over through a maxsize-1 queue. The consumer makes the current
stream wait on the event before the step reads the batch, and calls
`Tensor.record_stream` on each batch tensor, so the caching allocator does
not hand their memory out again while the step may still read it.

Crash-consistent resume: the loader advances its stream cursor when a
batch is handed off, one staged batch ahead of what the trainer has stepped
on. The producer snapshots `loader.state_dict()` right after each pull and
the snapshot travels with its batch; `state_dict()` serves the snapshot of
the batch the consumer holds, so a checkpoint records what an unwrapped
loader would have. Every other loader attribute (quarantine,
load_state_dict, resilience_stats, close, ...) proxies through.

On a CPU device the copies are plain and synchronous (no stream, no
pinning): the tests drive the same producer and cursor logic.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

# The device-bound batch keys (the trainer's step consumes exactly these;
# host-only fields like "paths" stay on the host side of the hop).
BATCH_KEYS = ("image1", "image2", "flow", "valid")


class DevicePrefetcher:
    """Double-buffered device staging around a loader. Iterating yields
    dicts of float32 tensors on `device` keyed by BATCH_KEYS. `stats()`
    reports the run report's io_spine counters: the queue depth watermark
    and the fraction of consumer fetches that found the next batch already
    staged."""

    def __init__(self, loader: Any, device: Any = "cuda"):
        self._loader = loader
        self._device = torch.device(device)
        self._state_snapshot: Optional[Dict] = None
        self._depth_watermark = 0
        self._overlap_hits = 0
        self._fetches = 0
        self._lock = threading.Lock()

    # --- loader proxy -----------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        return getattr(self._loader, name)

    def __len__(self) -> int:
        return len(self._loader)

    @property
    def state_dict(self):
        """The stream position matching the batch the consumer holds. A
        property returning a callable, so that wrapping a plain iterable
        keeps `hasattr(wrapper, "state_dict")` False."""
        loader_fn = self._loader.state_dict  # AttributeError when unsupported

        def _state_dict() -> Dict:
            if self._state_snapshot is not None:
                return self._state_snapshot
            return loader_fn()

        return _state_dict

    def load_state_dict(self, state: Dict) -> None:
        self._state_snapshot = None
        self._loader.load_state_dict(state)

    # --- health counters --------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            fetches = self._fetches
            return {
                "prefetch_depth_watermark": int(self._depth_watermark),
                "device_put_overlap_fraction": float(self._overlap_hits) / fetches if fetches else 0.0,
            }

    # --- the copy ---------------------------------------------------------
    def _copy(self, batch, stream):
        """Host batch -> (dict of device tensors, event or None)."""
        if stream is None:
            return {k: torch.as_tensor(np.asarray(batch[k], np.float32)).to(self._device) for k in BATCH_KEYS}, None
        with torch.cuda.stream(stream):
            out = {}
            for k in BATCH_KEYS:
                host = torch.from_numpy(np.ascontiguousarray(batch[k], np.float32)).pin_memory()
                out[k] = host.to(self._device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    # --- iteration --------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        q: "queue.Queue" = queue.Queue(maxsize=1)
        stop = threading.Event()
        cuda = self._device.type == "cuda"
        if cuda and self._device.index is None:
            # The producer thread selects the card by index.
            self._device = torch.device("cuda", torch.cuda.current_device())
        stream = torch.cuda.Stream(device=self._device) if cuda else None

        def producer() -> None:
            try:
                if cuda:
                    torch.cuda.set_device(self._device)
                for batch in self._loader:
                    if stop.is_set():
                        break
                    placed, event = self._copy(batch, stream)
                    # Snapshot after the pull: the loader's cursor sits just
                    # past this batch, what a checkpoint taken while the
                    # consumer steps on it must record.
                    snapshot = self._loader.state_dict() if hasattr(self._loader, "state_dict") else None
                    q.put((placed, event, snapshot))
                    if stop.is_set():
                        break
            except BaseException as e:
                if not isinstance(e, Exception):
                    e = RuntimeError(f"device prefetch aborted: {e!r}")
                q.put(e)
                return
            q.put(None)

        thread = threading.Thread(target=producer, name="device-prefetch", daemon=True)
        thread.start()
        try:
            while True:
                depth = q.qsize()
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                with self._lock:
                    self._fetches += 1
                    if depth > 0:
                        self._overlap_hits += 1
                    self._depth_watermark = max(self._depth_watermark, depth)
                placed, event, snapshot = item
                if event is not None:
                    current = torch.cuda.current_stream(self._device)
                    current.wait_event(event)
                    for t in placed.values():
                        t.record_stream(current)
                self._state_snapshot = snapshot
                yield placed
        finally:
            stop.set()
            # Drain so a producer blocked on q.put can observe stop and exit.
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    if not thread.is_alive():
                        break
                    thread.join(timeout=0.1)
