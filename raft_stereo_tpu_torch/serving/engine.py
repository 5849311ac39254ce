"""Warmed, chunked, deadline-aware refinement: counterpart of
`raft_stereo_tpu/serving/engine.py` (`BatchResult`, `AnytimeEngine`).

`warm()` runs every (bucket, batch size) once — with a `video` config also
the `flow_init` prelude — and measures the wall time of one chunk;
`run_batch` runs the prelude, then chunks of `chunk_iters` GRU iterations
with a host-side deadline check after each, and finalizes a request when
its iteration target is reached or when one more chunk would pass its
deadline (`t + est > deadline`). Every request gets at least one chunk. A
device synchronize after each chunk plays the role of JAX's
`block_until_ready`; the hang watchdog (one monitor thread for the
engine's lifetime, with `hang_timeout_s` > 0) watches the heartbeat it
gives while a batch runs, and `close()` stops it.

The request path the batcher calls (serving/batcher.py):

- `stage(batch)` runs in the batcher's stager thread and lands a
  host-assembled batch on the card: a copy from pinned host memory with
  `non_blocking=True` on a side CUDA stream, and an event recorded after
  it, so batch N+1's copy overlaps batch N's refinement;
- `run_staged(batch)` runs in the runner thread: the runner's current
  stream (the default stream; the current stream is per thread, and every
  kernel wrapper launches on it) waits on that event, each staged tensor
  is marked used on it (`record_stream`, so the caching allocator does not
  hand its memory out while the runner still reads it), and `run_batch`
  refines. `torch.inference_mode` is per thread too; `run_batch` carries it.

`sharding` says how the engine serves (/healthz's `sharding` field): a
spatial preset would split rows over the visible devices, as JAX's engine
does; with one visible device JAX serves unsharded, and so does this
engine, which is always one device (`serve` refuses a spatial preset with
more than one visible card).

`swap_variables` hot-swaps the weights: the candidate state dict is checked
key by key against the served model (shape and dtype) before anything is
touched, then copied into the served tensors in place under the run lock,
so no kernel argument changes its address and every batch sees one
coherent set of weights. Nothing in `ops/` or `models/` keeps a converted
copy of a weight (the fused encoder re-lays its conv weights out on every
call), so the next batch computes with the new values.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.config import ServeConfig
from raft_stereo_tpu_torch.models import anytime
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.serving.lifecycle import CheckpointMismatchError, ServingLifecycle
from raft_stereo_tpu_torch.utils.resilience import HangWatchdog


@dataclasses.dataclass
class BatchResult:
    """Per-request outcome of one engine batch."""

    flow_up: np.ndarray  # (H, W, 1) at the padded bucket resolution, float32
    iters_completed: int
    early_exit: bool
    # (H/f, W/f) low-res flow at delivery: a stream's carry.
    flow_lowres: Optional[np.ndarray] = None
    # Wall time of the completed device work up to this request's delivery:
    # the chunk walls plus the finalize fetch.
    device_time_s: float = 0.0


class AnytimeEngine:
    """One model on one device, warmed for every configured bucket.

    `model` is a `RAFTStereo` already on `device`; None builds one with
    seeded random weights. `run_batch` holds a lock: the device serves one
    batch at a time. Staging runs outside it."""

    # One engine, one fault domain: /healthz reports it as `replicas` (the
    # JAX package's fleet serves several).
    n_replicas = 1
    # Flight-recorder tracer (obs/trace.Tracer), set by the service. None =
    # no spans, no dumps.
    tracer = None

    def __init__(self, config: ServeConfig, model: Optional[RAFTStereo] = None,
                 device="cuda", seed: int = 0, lifecycle: Optional[ServingLifecycle] = None):
        self.config = config
        self.device = torch.device(device)
        self.lifecycle = lifecycle if lifecycle is not None else ServingLifecycle()
        if model is None:
            model = build_model(config.model, seed=seed, device=self.device)
        self.model = model.eval()
        self.sharding = ("dp (single-program)" if config.sharding_rules == "dp" else
                         f"{config.sharding_rules} requested; one visible device: dp (single-program)")
        self._chunk_est_s: Dict[Tuple[Tuple[int, int], int], float] = {}
        self.prelude_s: Dict[Tuple[Tuple[int, int], int], float] = {}
        self._lock = threading.Lock()
        self._stage_stream = None
        self._warmed = False
        self.batches_total = 0
        # Bumped by each successful swap_variables; /healthz and every
        # response carry it.
        self.swap_generation = 0
        self._watchdog = HangWatchdog(config.hang_timeout_s, self._record_hang) if config.hang_timeout_s > 0 else None

    def close(self) -> None:
        if self._watchdog is not None:
            self._watchdog.close()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def on_device(self):
        """The engine's card as the calling thread's current device (the
        kernels launch on the current device; a fleet replica's run or
        respawn thread is not the one that built the engine)."""
        return torch.cuda.device(self.device) if self.device.type == "cuda" else contextlib.nullcontext()

    # -- boot --------------------------------------------------------------
    @torch.inference_mode()
    def warm(self) -> Dict[str, object]:
        """Run prelude (and the flow_init prelude with streams), two chunks
        and finalize for every (bucket, batch); the faster chunk's wall
        time is that combo's estimate (the deadline check's, and the
        batcher's choice of batch size)."""
        with self.on_device():
            return self._warm()

    def _warm(self) -> Dict[str, object]:
        cfg = self.config
        f = cfg.model.downsample_factor
        t_start = time.monotonic()
        for hw in cfg.buckets:
            for batch in cfg.batch_sizes:
                img = self.place(np.zeros((batch, *hw, cfg.model.in_channels), np.float32))
                t = time.monotonic()
                state = anytime.prelude(self.model, img, img)
                self._sync()
                self.prelude_s[(hw, batch)] = time.monotonic() - t
                if cfg.video is not None:
                    flow0 = self.place(np.zeros((batch, hw[0] // f, hw[1] // f), np.float32))
                    anytime.prelude(self.model, img, img, flow0)
                    self._sync()
                walls = []
                for _ in range(2):
                    t = time.monotonic()
                    state = anytime.chunk(self.model, state, cfg.chunk_iters)
                    self._sync()
                    walls.append(time.monotonic() - t)
                self._chunk_est_s[(hw, batch)] = min(walls)
                anytime.finalize(self.model, state)
                self._sync()
        self._warmed = True
        return {
            "combos": len(cfg.buckets) * len(cfg.batch_sizes),
            "warmup_seconds": time.monotonic() - t_start,
            "sharding": self.sharding,
            "chunk_est_ms": {f"{hw[0]}x{hw[1]}/b{b}": s * 1e3 for (hw, b), s in self._chunk_est_s.items()},
            "prelude_ms": {f"{hw[0]}x{hw[1]}/b{b}": s * 1e3 for (hw, b), s in self.prelude_s.items()},
        }

    @property
    def warmed(self) -> bool:
        return self._warmed

    def chunk_estimate_s(self, bucket: Tuple[int, int], batch: int) -> float:
        return self._chunk_est_s.get((bucket, batch), 0.0)

    # -- staging -----------------------------------------------------------
    def place(self, x: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device: from pinned memory with a
        non-blocking copy on a card (on the caller's current stream)."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def stage(self, staged) -> None:
        """Land a host-assembled `_StagedBatch` (serving/batcher.py) on the
        device: the copy the batcher's stager thread overlaps with the
        running batch. On a card it runs on a side stream and records the
        event `run_staged` waits on."""
        on_card = self.device.type == "cuda"
        if on_card and self._stage_stream is None:
            self._stage_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stage_stream) if on_card else contextlib.nullcontext():
            staged.image1 = self.place(staged.i1_host)
            staged.image2 = self.place(staged.i2_host)
            if staged.flow_host is not None:
                staged.flow_init = self.place(staged.flow_host)
        if on_card:
            staged.ready = torch.cuda.Event()
            staged.ready.record(self._stage_stream)

    def run_staged(self, staged) -> List[BatchResult]:
        """Run one staged batch: the runner thread's entry point. Fault
        hooks patched over `run_batch` keep working."""
        with self.on_device():
            return self._run_staged(staged)

    def _run_staged(self, staged) -> List[BatchResult]:
        ready = getattr(staged, "ready", None)
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in (staged.image1, staged.image2, staged.flow_init):
                if t is not None:
                    t.record_stream(stream)
        return self.run_batch(
            staged.bucket,
            staged.image1,
            staged.image2,
            deadlines_s=[r.deadline_s for r in staged.reqs],
            max_iters=[r.max_iters for r in staged.reqs],
            flow_init=staged.flow_init,
            trace_ids=getattr(staged, "trace_ids", None),
        )

    # -- request path ------------------------------------------------------
    @torch.inference_mode()
    def run_batch(
        self,
        bucket: Tuple[int, int],
        image1: torch.Tensor,
        image2: torch.Tensor,
        deadlines_s: Sequence[Optional[float]],
        max_iters: Sequence[int],
        now=time.monotonic,
        flow_init: Optional[torch.Tensor] = None,
        trace_ids: Optional[Sequence[int]] = None,
    ) -> List[BatchResult]:
        """Refine one padded batch (B, H, W, C) on the engine's device.

        Rows beyond `len(deadlines_s)` are fill and get no result.
        `deadlines_s[i]` is an absolute `now()` deadline or None;
        `max_iters[i]` is rounded up to whole chunks. `flow_init` is an
        optional (B, H/f, W/f) warm start (zero rows are exact cold
        starts); `trace_ids` rides the batch's spans."""
        cfg = self.config
        n = len(deadlines_s)
        batch = int(image1.shape[0])
        targets = [max(1, -(-min(int(m), cfg.max_iters) // cfg.chunk_iters)) for m in max_iters]
        est = self.chunk_estimate_s(bucket, batch)
        results: List[Optional[BatchResult]] = [None] * n
        watchdog = self._watchdog
        tracer = self.tracer
        tids = list(trace_ids) if trace_ids is not None else None
        # Watched inside the lock: waiting for another batch is queueing.
        with self._lock, watchdog.watch() if watchdog is not None else contextlib.nullcontext():
            device_s = 0.0
            t0 = time.perf_counter()
            state = anytime.prelude(self.model, image1, image2, flow_init)
            if tracer is not None:
                tracer.span("prelude", t0=t0, t1=time.perf_counter(), bucket=list(bucket), batch=batch,
                            warm=flow_init is not None, traces=tids)
            pending = set(range(n))
            for k in range(1, max(targets) + 1):
                t0 = time.perf_counter()
                state = anytime.chunk(self.model, state, cfg.chunk_iters)
                self._sync()
                t1 = time.perf_counter()
                device_s += t1 - t0
                if tracer is not None:
                    tracer.span("chunk", t0=t0, t1=t1, k=k, bucket=list(bucket), batch=batch, traces=tids)
                if watchdog is not None:
                    watchdog.beat()
                iters_done = k * cfg.chunk_iters
                t = now()
                deliver = [
                    i for i in sorted(pending)
                    if targets[i] <= k or (deadlines_s[i] is not None and t + est > deadlines_s[i])
                ]
                if not deliver:
                    continue
                t0 = time.perf_counter()
                flow_lo, flow_up = anytime.finalize(self.model, state)
                flow_np = flow_up.float().cpu().numpy()
                lo_np = flow_lo.float().cpu().numpy()
                t1 = time.perf_counter()
                device_s += t1 - t0
                if tracer is not None:
                    tracer.span("finalize", t0=t0, t1=t1, k=k, delivered=len(deliver), traces=tids)
                if watchdog is not None:
                    watchdog.beat()
                for i in deliver:
                    results[i] = BatchResult(
                        flow_up=flow_np[i],
                        iters_completed=iters_done,
                        early_exit=iters_done < min(int(max_iters[i]), cfg.max_iters),
                        flow_lowres=lo_np[i],
                        device_time_s=device_s,
                    )
                    pending.discard(i)
                if not pending:
                    break
            self.batches_total += 1
        assert not pending, "engine loop ended with undelivered requests"
        return results  # type: ignore[return-value]

    def _record_hang(self, info: Dict[str, object]) -> None:
        tracer = self.tracer
        if tracer is not None:
            tracer.event("watchdog_fire", elapsed_s=float(info["elapsed_s"]),
                         engine_batches_total=self.batches_total)
        self.lifecycle.record_hang(float(info["elapsed_s"]), str(info["traces"]))
        if tracer is not None:
            # After record_hang, so the transition it causes is in the dump.
            tracer.dump("watchdog")

    # -- checkpoint hot-swap -----------------------------------------------
    def swap_variables(self, new_state: Mapping[str, object]) -> int:
        """Swap the served weights between batches. `new_state` is a state
        dict of the served model's architecture (tensors or numpy arrays):
        the same keys, and per key the same shape and dtype, else
        `CheckpointMismatchError` before anything is touched. The values are
        copied in place under the run lock. Returns the new generation."""
        served = self.model.state_dict()
        missing = sorted(set(served) - set(new_state))
        unexpected = sorted(set(new_state) - set(served))
        if missing or unexpected:
            raise CheckpointMismatchError(
                f"checkpoint keys differ from the served model: missing {missing[:5]}"
                f"{' ...' if len(missing) > 5 else ''}, unexpected {unexpected[:5]}"
                f"{' ...' if len(unexpected) > 5 else ''}"
            )
        candidate = {}
        for name, tensor in served.items():
            value = torch.as_tensor(new_state[name])
            if tuple(value.shape) != tuple(tensor.shape) or value.dtype != tensor.dtype:
                raise CheckpointMismatchError(
                    f"{name}: checkpoint has shape {tuple(value.shape)} dtype {value.dtype}, the served "
                    f"model expects {tuple(tensor.shape)} {tensor.dtype}"
                )
            candidate[name] = value
        with self._lock:
            with torch.no_grad():
                for name, tensor in served.items():
                    tensor.copy_(candidate[name])
            self._sync()
            self.swap_generation += 1
            gen = self.swap_generation
        self.lifecycle.note_swap(gen)
        return gen
