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

`sharding` says how the engine serves (/healthz's `sharding` field). A
spatial preset (`sharding_rules` other than "dp") with more than one
device is the banded engine, the counterpart of JAX's (1, n) mesh over
the local devices: `devices` (default: every visible card; a device may
repeat, so that one card, or the CPU, holds several bands) each hold a
band of image rows (parallel/spatial.py). The engine keeps one copy of the
model per distinct device, a `BandScope` per band over one in-process
`ThreadComm` (halos and norm sums go card to card, never through the
host), and a worker thread per band with its device current. `run_batch`
splits each padded batch (and a stream's `flow_init`) into the bands on
the first card, runs the prelude, every chunk and the finalize on every
band at once, and gathers the flows onto the first card; warm-up, the
chunk estimates, the watchdog, the run lock and `swap_variables` (into
every copy under the one lock) are the single engine's. A failure in one
band fails the batch (the other bands' exchanges are broken off), and the
batcher counts it on the breaker. A bucket off the band rule
(`config.band_shape_problem`) is refused at boot. With one device JAX
serves unsharded, and so does this engine, and `sharding` says so.

Hygiene and the kernel cache, as JAX's engine has them: the engine runs
one `JitHygiene(strict=False, recompile_grace=0)` (utils/jit_hygiene.py;
a fleet passes the one its replicas share) and warms inside its
`whitelist("warmup")`, so the kernel builds of the boot are counted and
excused, and a build after the warm-up (a path the warm-up missed) is a
counted violation, never a crash. `aot_cache` is the boot's kernel cache
(serving/aot.py) or None; the warm-up summary carries its stats and the
boot's build count (`compiles_total`).

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
import copy
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.config import ServeConfig, band_shape_problem
from raft_stereo_tpu_torch.models import anytime
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.parallel import spatial
from raft_stereo_tpu_torch.serving.lifecycle import CheckpointMismatchError, ServingLifecycle
from raft_stereo_tpu_torch.utils.jit_hygiene import JitHygiene
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


def band_devices(config: ServeConfig, device, devices: Optional[Sequence] = None) -> Optional[List[torch.device]]:
    """The devices of the banded engine, or None for one device: a preset
    other than dp (JAX's engine maps spatial, dp+spatial and fsdp alike to
    a (1, n) mesh) with `devices` of more than one entry, or with `devices`
    None, `device` "cuda" (no index) and more than one visible card (then
    every one of them)."""
    if config.sharding_rules == "dp":
        return None
    if devices is None:
        one = torch.device(device)
        if one.type != "cuda" or one.index is not None or not torch.cuda.is_available() \
                or torch.cuda.device_count() < 2:
            return None
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    return devices if len(devices) > 1 else None


def _bind_device(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)


class _Bands:
    """The banded engine's bands: band k on `devices[k]`, its model copy,
    its `BandScope` over one `ThreadComm`, and its worker thread."""

    def __init__(self, config: ServeConfig, model: RAFTStereo, devices: List[torch.device]):
        n = len(devices)
        for hw in config.buckets:
            problem = band_shape_problem(hw[0], n, config.model.n_downsample)
            if problem is not None:
                raise ValueError(f"bucket {hw[0]}x{hw[1]} over {n} bands: {problem}")
        self.devices = devices
        self.f = config.model.downsample_factor
        self.n_downsample = config.model.n_downsample
        home = next(model.parameters()).device
        copies = {}
        for d in devices:
            if d not in copies:
                copies[d] = model if d == home else copy.deepcopy(model).to(d).eval()
        self.models = [copies[d] for d in devices]
        self.comm = spatial.ThreadComm(n)
        self.scopes = [spatial.BandScope(self.comm.bound(k), k, n) for k in range(n)]
        self.pools = [ThreadPoolExecutor(1, thread_name_prefix=f"band{k}", initializer=_bind_device, initargs=(d,))
                      for k, d in enumerate(devices)]

    def close(self) -> None:
        for pool in self.pools:
            pool.shutdown(wait=True)

    @property
    def exchanges(self) -> int:
        """Collectives made so far, summed over the bands."""
        return sum(s.exchanges for s in self.scopes)

    def _call(self, k: int, work):
        try:
            with torch.inference_mode():
                return work(k)
        except BaseException:
            self.comm.abort()  # the other bands' exchanges raise instead of waiting
            raise

    def run(self, work) -> list:
        """`work(k)` on every band at once, each in its worker thread; the
        results in band order. A band that raised fails the call with its
        error, once every band has returned."""
        futures = [pool.submit(self._call, k, work) for k, pool in enumerate(self.pools)]
        results, errors = [], []
        for fut in futures:
            try:
                results.append(fut.result())
            except BaseException as exc:  # noqa: BLE001 (re-raised below)
                errors.append(exc)
        if errors:
            self.comm.reset()
            raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)), errors[0])
        return results

    def _in_band(self, k: int, rows: int, fn):
        with self.scopes[k].bands(rows, self.n_downsample):
            return fn(self.models[k])

    def prelude(self, image1, image2, flow_init) -> list:
        n = len(self.devices)
        rows = image1.shape[1] // n
        low = rows // self.f

        def work(k):
            dev = self.devices[k]
            i1, i2 = (t[:, k * rows:(k + 1) * rows].to(dev, non_blocking=True) for t in (image1, image2))
            flow = None if flow_init is None else flow_init[:, k * low:(k + 1) * low].to(dev, non_blocking=True)
            return self._in_band(k, rows, lambda m: anytime.prelude(m, i1, i2, flow))

        return self.run(work)

    def chunk(self, states: list, chunk_iters: int) -> list:
        rows = states[0]["coords0"].shape[1] * self.f
        return self.run(lambda k: self._in_band(k, rows, lambda m: anytime.chunk(m, states[k], chunk_iters)))

    def finalize(self, states: list):
        rows = states[0]["coords0"].shape[1] * self.f
        outs = self.run(lambda k: self._in_band(k, rows, lambda m: anytime.finalize(m, states[k])))
        home = self.devices[0]
        return tuple(torch.cat([o[i].to(home) for o in outs], dim=1) for i in range(2))


class AnytimeEngine:
    """One model on one device, warmed for every configured bucket; with a
    spatial preset and more than one device, row bands over `devices`.

    `model` is a `RAFTStereo` already on `device` (the first of `devices`
    when banded); None builds one with seeded random weights. `run_batch`
    holds a lock: the device serves one batch at a time. Staging runs
    outside it."""

    # One engine, one fault domain: /healthz reports it as `replicas` (the
    # JAX package's fleet serves several).
    n_replicas = 1
    # Flight-recorder tracer (obs/trace.Tracer), set by the service. None =
    # no spans, no dumps.
    tracer = None

    def __init__(self, config: ServeConfig, model: Optional[RAFTStereo] = None,
                 device="cuda", seed: int = 0, lifecycle: Optional[ServingLifecycle] = None,
                 devices: Optional[Sequence] = None, hygiene: Optional[JitHygiene] = None, aot_cache=None):
        self.config = config
        # An engine's own hygiene is stopped by close(); a shared one by
        # its owner (the fleet).
        self._owns_hygiene = hygiene is None
        if hygiene is None:
            hygiene = JitHygiene(strict=False, recompile_grace=0)
            hygiene.monitor.label = "serving"
        self.hygiene = hygiene
        self.aot_cache = aot_cache
        banded = band_devices(config, device, devices)
        self.device = banded[0] if banded else torch.device(devices[0] if devices else device)
        self.lifecycle = lifecycle if lifecycle is not None else ServingLifecycle()
        if model is None:
            model = build_model(config.model, seed=seed, device=self.device)
        self.model = model.eval()
        self._bands = _Bands(config, self.model, banded) if banded else None
        if banded:
            self.model = self._bands.models[0]
            self.sharding = f"spatial over {len(banded)} device(s)"
        else:
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
        if self._bands is not None:
            self._bands.close()
        if self._owns_hygiene:
            self.hygiene.monitor.stop()

    def _sync(self) -> None:
        for d in (self._bands.devices if self._bands is not None else [self.device]):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    @property
    def band_exchanges(self) -> int:
        """The banded engine's collectives so far (halos, norm sums and
        gathers, over every band); 0 on one device."""
        return self._bands.exchanges if self._bands is not None else 0

    # The three stages, on one device or on every band.
    def _prelude(self, image1, image2, flow_init=None):
        if self._bands is not None:
            return self._bands.prelude(image1, image2, flow_init)
        return anytime.prelude(self.model, image1, image2, flow_init)

    def _chunk(self, state):
        if self._bands is not None:
            return self._bands.chunk(state, self.config.chunk_iters)
        return anytime.chunk(self.model, state, self.config.chunk_iters)

    def _finalize(self, state):
        if self._bands is not None:
            return self._bands.finalize(state)
        return anytime.finalize(self.model, state)

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
        batcher's choice of batch size). Inside the hygiene's warm-up
        window: the kernel builds of the boot are counted there."""
        self.hygiene.monitor.start()
        with self.on_device(), self.hygiene.whitelist("warmup"):
            return self._warm()

    def _warm(self) -> Dict[str, object]:
        cfg = self.config
        f = cfg.model.downsample_factor
        t_start = time.monotonic()
        for hw in cfg.buckets:
            for batch in cfg.batch_sizes:
                img = self.place(np.zeros((batch, *hw, cfg.model.in_channels), np.float32))
                t = time.monotonic()
                state = self._prelude(img, img)
                self._sync()
                self.prelude_s[(hw, batch)] = time.monotonic() - t
                if cfg.video is not None:
                    flow0 = self.place(np.zeros((batch, hw[0] // f, hw[1] // f), np.float32))
                    self._prelude(img, img, flow0)
                    self._sync()
                walls = []
                for _ in range(2):
                    t = time.monotonic()
                    state = self._chunk(state)
                    self._sync()
                    walls.append(time.monotonic() - t)
                self._chunk_est_s[(hw, batch)] = min(walls)
                self._finalize(state)
                self._sync()
        self._warmed = True
        return {
            "combos": len(cfg.buckets) * len(cfg.batch_sizes),
            "compiles_total": self.hygiene.monitor.stats()["compiles_total"],
            "warmup_seconds": time.monotonic() - t_start,
            "aot_cache": self.aot_cache.stats() if self.aot_cache is not None else {"enabled": False},
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
            state = self._prelude(image1, image2, flow_init)
            if tracer is not None:
                tracer.span("prelude", t0=t0, t1=time.perf_counter(), bucket=list(bucket), batch=batch,
                            warm=flow_init is not None, traces=tids)
            pending = set(range(n))
            for k in range(1, max(targets) + 1):
                t0 = time.perf_counter()
                state = self._chunk(state)
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
                flow_lo, flow_up = self._finalize(state)
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
        copied in place under the run lock (into every band's copy on the
        banded engine). Returns the new generation."""
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
        models = self._bands.models if self._bands is not None else [self.model]
        with self._lock:
            with torch.no_grad():
                for model in {id(m): m for m in models}.values():
                    for name, tensor in model.state_dict().items():
                        tensor.copy_(candidate[name])
            self._sync()
            self.swap_generation += 1
            gen = self.swap_generation
        self.lifecycle.note_swap(gen)
        return gen
