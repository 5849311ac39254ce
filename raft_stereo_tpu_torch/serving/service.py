"""The serving front: in-process submit API and stdlib HTTP endpoints,
counterpart of `raft_stereo_tpu/serving/service.py`.

`StereoService` composes the engine and the micro-batcher behind one
object: boot (`start()`) warms every (bucket, batch), `submit()` admits a
stereo pair into a shape bucket and returns a live Future that the
batcher's runner thread resolves, and `healthz()`/`metrics()` are the
payloads the HTTP front serializes. The HTTP layer is stdlib-only
(`http.server.ThreadingHTTPServer`), with the JAX package's routes,
payloads and status codes:

    POST /v1/predict   {"image1": [[[...]]], "image2": ..., "deadline_ms"?,
                        "max_iters"?, "stream_id"?} -> {"disparity": [[...]],
                        "iters_completed", "early_exit", "latency_ms",
                        "bucket", "swap_generation"} (+ stream fields)
    POST /reload       {"checkpoint": PATH} -> hot swap (409 on mismatch)
    GET  /healthz      run_report-schema payload + a "serving" block
    GET  /metrics      ServingMetrics snapshot (?format=prom: Prometheus text)

Admission maps a request onto the SMALLEST configured bucket that fits
both dimensions (edge padding on the host to the exact bucket shape); an
image larger than every bucket is rejected (HTTP 413). A draining or
failed service sheds with 503, as does a request whose deadline the queued
work alone already blows. The "disparity" field is the unpadded horizontal
flow (negative disparity), shape (H, W) of the input.

Stream sessions (`ServeConfig.video` set): `submit_stream(stream_id, ...)`
admits consecutive frames of one stream. The service keeps a per-stream
carry — the previous frame's low-res flow and the warp error it reached on
its own pair — and warm-starts the next frame through the prelude's
`flow_init`. The reset gate (video/session.py `should_reset`) runs at
admission on the padded host images: a scene cut cold-starts instead of
refining from a wrong prior. Frames of one stream are submitted in order,
each after the previous frame's future resolves; distinct streams are
independent, and the batcher may mix warm and cold rows in one batch.

With a spatial preset (`ServeConfig.sharding_rules` other than "dp") and
more than one device (every visible card, or the `devices` given) the one
engine serves row bands across them (serving/engine.py), staged onto the
first card, and /healthz's `sharding` reads "spatial over n device(s)".

With `ServeConfig.replicas` > 1 the engine is an `EngineFleet`
(serving/fleet.py) behind the same batcher: one engine per device (one per
card by default, or the `devices` given, which may repeat a device), a
breaker per replica aggregated into the service's state, failover requeue,
and a rolling POST /reload. /healthz then carries every replica's state.
`replicas=1` is the single engine, unchanged.

Boot from the kernel cache (`ServeConfig.aot_cache_dir`, serving/aot.py):
the service makes the process's cache before anything loads, hands it to
its engine (or fleet), and `boot_block()` reports its real numbers: hits,
misses, entries, evictions and the boot's `nvcc` builds
(`compiles_total`; 0 on a boot whose libraries were all cached). /healthz
carries the engine's `jit_hygiene` block, as JAX's does.

The service never moves work to the CPU: on "cuda" every batch runs the
model's kernels on the card, and a batch whose kernel fails to build or
launch fails with the error and counts against the breaker.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import signal
import socket
import threading
import time
import urllib.parse
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.config import ServeConfig
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.obs.memory import memory_block, set_memory_gauges
from raft_stereo_tpu_torch.obs.prom import PROM_CONTENT_TYPE, Registry
from raft_stereo_tpu_torch.obs.trace import Tracer, observability_block
from raft_stereo_tpu_torch.serving.batcher import MicroBatcher, _Request
from raft_stereo_tpu_torch.serving.engine import AnytimeEngine
from raft_stereo_tpu_torch.serving.lifecycle import (
    HEALTH_STATES,
    CheckpointMismatchError,
    DeadlineInfeasibleError,
    ServiceUnavailableError,
    ServingLifecycle,
)
from raft_stereo_tpu_torch.utils.http import json_response, text_response
from raft_stereo_tpu_torch.utils.padding import InputPadder
from raft_stereo_tpu_torch.utils.run_report import build_run_report
from raft_stereo_tpu_torch.video.session import flow_warp_error, should_reset

logger = logging.getLogger(__name__)


class BucketOverflowError(ValueError):
    """Input larger than every configured shape bucket (HTTP 413)."""


@dataclasses.dataclass
class _StreamEntry:
    """Per-stream carry: the previous frame's low-res flow and the warp
    error it reached on its OWN frame pair (the reset-gate baseline)."""

    flow: np.ndarray  # (H/f, W/f) low-res flow at the padded bucket shape
    err: float
    bucket: Tuple[int, int]
    frames: int


class StereoService:
    """`model` is a `RAFTStereo` on `device`; None builds one from
    `config.restore_ckpt` (the reference's .pth) or, without one, with
    seeded random weights. A fleet (`config.replicas` > 1) copies the
    model onto `devices`, one per replica; None is one card each, and on a
    device other than a card the list must be given. With a spatial preset
    and one engine, `devices` are its bands' (None: every visible card)."""

    def __init__(self, config: ServeConfig, model: Optional[RAFTStereo] = None,
                 device="cuda", seed: int = 0, devices: Optional[Sequence] = None):
        from raft_stereo_tpu_torch.serving.aot import maybe_cache

        self.config = config
        fleet = config.replicas > 1
        # Before any kernel loads: the cache sets the process's build
        # directory (None: the package's _build/).
        self.aot_cache = maybe_cache(config.aot_cache_dir)
        if model is None and config.restore_ckpt:
            from raft_stereo_tpu_torch.models.init import build_model
            from raft_stereo_tpu_torch.utils.checkpoints import load_reference_checkpoint

            model = load_reference_checkpoint(build_model(config.model, seed=seed, device="cpu"),
                                              config.restore_ckpt)
            if not fleet:
                model = model.to(device)
        if fleet:
            from raft_stereo_tpu_torch.serving.fleet import EngineFleet

            if devices is None and torch.device(device).type != "cuda":
                raise ValueError(f"replicas={config.replicas} on {device!r}: pass the devices list")
            self.engine = EngineFleet(config, model, devices=devices, seed=seed, aot_cache=self.aot_cache)
            self.lifecycle = self.engine.lifecycle
        else:
            self.lifecycle = ServingLifecycle(
                degrade_after=config.breaker_degrade_after,
                fail_after=config.breaker_fail_after,
                probation=config.breaker_probation,
            )
            self.engine = AnytimeEngine(config, model, device=device, seed=seed, lifecycle=self.lifecycle,
                                        devices=devices, aot_cache=self.aot_cache)
        self.batcher = MicroBatcher(config, self.engine, lifecycle=self.lifecycle)
        self.warm_summary: Optional[Dict[str, object]] = None
        self._started = False
        # The checkpoint the served weights came from (None: in-memory
        # boot); reload_checkpoint updates it.
        self.current_checkpoint: Optional[str] = str(config.restore_ckpt) if config.restore_ckpt else None
        self._streams: "collections.OrderedDict[str, _StreamEntry]" = collections.OrderedDict()
        self._streams_lock = threading.Lock()
        # -- observability: one tracer and one prom registry, wired into the
        # engine, batcher and lifecycle after construction (host-side only).
        dump_path = None
        if config.log_dir:
            os.makedirs(config.log_dir, exist_ok=True)
            dump_path = os.path.join(config.log_dir, "flight_recorder.json")
        self.tracer = Tracer(capacity=config.flight_recorder_events, dump_path=dump_path)
        self.registry = Registry()
        self._last_memory: Optional[Dict[str, object]] = None
        self.engine.tracer = self.tracer
        self.batcher.tracer = self.tracer
        self.batcher.registry = self.registry
        self.batcher.memory_sampler = self._sample_memory
        self.lifecycle.on_transition = self._on_breaker_transition
        # A fleet's replica breakers dump the same recorder.
        for replica_lc in getattr(self.engine, "replica_lifecycles", lambda: [])():
            replica_lc.on_transition = self._on_breaker_transition

    # -- observability plumbing -------------------------------------------
    def _on_breaker_transition(self, frm: str, to: str, reason: str) -> None:
        """Every breaker transition is recorded AND dumps the flight
        recorder: the moment the last-N window is worth keeping."""
        self.tracer.event("breaker_transition", frm=frm, to=to, reason=reason)
        self.tracer.dump(f"breaker:{frm}->{to}")

    def _sample_memory(self) -> None:
        """Per-batch device-memory sample (batcher hook): prom gauges and
        the block /healthz serves."""
        self._last_memory = set_memory_gauges(self.registry)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "StereoService":
        """Warm every (bucket, batch) on the batcher's runner thread, the
        one that serves them, then open the batcher."""
        self.warm_summary = self.batcher.start(warm=self.engine.warm)
        logger.info("serving warmup: %d combos, %.1fs", self.warm_summary["combos"],
                    self.warm_summary["warmup_seconds"])
        self._started = True
        return self

    def close(self) -> None:
        if self._started:
            self.batcher.close()
            self._started = False
            self.tracer.dump("service_close")
        self.engine.close()
        if self.aot_cache is not None:
            self.aot_cache.close()

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admission (new submits get 503), finish
        every queued, staged and running request, then close. Returns True
        if the backlog drained within the timeout; either way the service
        is closed afterwards (close() answers stragglers with
        ServiceUnavailableError — no future is stranded)."""
        if timeout_s is None:
            timeout_s = self.config.drain_timeout_s
        self.lifecycle.start_drain()
        drained = True
        if self._started:
            drained = self.batcher.drain(timeout_s)
        self.close()
        return drained

    def reload_checkpoint(self, path: str) -> Dict[str, object]:
        """Hot-swap the served weights from the reference's .pth on disk
        (the POST /reload handler); a fleet rolls it one replica at a time,
        and a refusal anywhere rolls the swapped replicas back. A candidate whose keys or shapes do not
        fit the served model, and an orbax directory of the JAX package,
        raise CheckpointMismatchError (409) before anything is touched."""
        from raft_stereo_tpu_torch.utils.checkpoints import (
            load_reference_state_dict,
            port_state_dict_from_reference,
        )

        if os.path.isdir(path):
            raise CheckpointMismatchError(
                f"{path!r} is a directory: orbax checkpoints are not readable by the port "
                "(reload takes the reference's .pth)"
            )
        sd = load_reference_state_dict(path)
        try:
            candidate = port_state_dict_from_reference(sd, self.config.model)
        except (KeyError, ValueError) as exc:
            raise CheckpointMismatchError(f"{path}: {exc}") from exc
        prev_gen = self.engine.swap_generation
        prev_ckpt = self.current_checkpoint
        gen = self.engine.swap_variables(candidate)
        self.current_checkpoint = str(path)
        logger.info("hot-swapped checkpoint %s -> generation %d", path, gen)
        return {
            "swap_generation": gen,
            "previous_generation": prev_gen,
            "checkpoint": str(path),
            "previous_checkpoint": prev_ckpt,
            "state": self.lifecycle.state,
            "replicas": self.engine.n_replicas,
            "validation": {"structure": "identical", "leaves": len(candidate)},
        }

    def __enter__(self) -> "StereoService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- admission ---------------------------------------------------------
    def pick_bucket(self, h: int, w: int) -> Tuple[int, int]:
        """Smallest configured bucket fitting (h, w), by padded area."""
        fits = [b for b in self.config.buckets if b[0] >= h and b[1] >= w]
        if not fits:
            raise BucketOverflowError(f"input {h}x{w} exceeds every bucket {list(self.config.buckets)}")
        return min(fits, key=lambda b: b[0] * b[1])

    def _check_state(self) -> None:
        """Lifecycle gate, FIRST check on every submit: a draining or
        failed service sheds at admission (503)."""
        if not self.lifecycle.admissible():
            self.batcher.metrics.record_shed()
            raise ServiceUnavailableError(f"service not admitting requests (state={self.lifecycle.state})")

    def _check_deadline(self, bucket: Tuple[int, int], deadline_s: Optional[float], now: float) -> None:
        """Deadline-aware shedding: if the queued work ahead of this
        request already uses up its whole budget (queue depth x the warmed
        chunk estimate for its bucket), shed it at admission. Only fires
        when there IS a queue."""
        if deadline_s is None:
            return
        depth = self.batcher.queue_depth()
        if depth <= 0:
            return
        est = self.engine.chunk_estimate_s(bucket, 1)
        if est <= 0:
            return
        if now + depth * est > deadline_s:
            self.batcher.metrics.record_shed(deadline_infeasible=True)
            raise DeadlineInfeasibleError(
                f"deadline infeasible: {depth} queued request(s) x {est * 1e3:.1f} ms/chunk exceeds the "
                f"{(deadline_s - now) * 1e3:.1f} ms budget"
            )

    def _admit(self, image1, image2):
        """Validate, pick a bucket, edge-pad on the host.
        Returns (bucket, padder, p1, p2)."""
        i1 = np.asarray(image1, np.float32)
        i2 = np.asarray(image2, np.float32)
        if i1.shape != i2.shape or i1.ndim != 3:
            raise ValueError(f"expected two equal (H, W, C) images, got {i1.shape} and {i2.shape}")
        h, w = i1.shape[0], i1.shape[1]
        try:
            bucket = self.pick_bucket(h, w)
        except BucketOverflowError:
            self.batcher.metrics.record_reject()
            raise
        padder = InputPadder((1, h, w, i1.shape[2]), divis_by=self.config.divis_by, target=bucket)
        left, right, top, bottom = padder.pad_amounts
        p1 = np.pad(i1, ((top, bottom), (left, right), (0, 0)), mode="edge")
        p2 = np.pad(i2, ((top, bottom), (left, right), (0, 0)), mode="edge")
        return bucket, padder, p1, p2

    def _deadline(self, deadline_ms: Optional[float], now: float) -> Optional[float]:
        if deadline_ms is None:
            deadline_ms = self.config.deadline_ms
        return now + deadline_ms / 1e3 if deadline_ms else None

    def submit(self, image1: np.ndarray, image2: np.ndarray, deadline_ms: Optional[float] = None,
               max_iters: Optional[int] = None) -> Future:
        """Admit one stereo pair; the Future resolves to {"disparity": (H, W)
        float32, "iters_completed", "early_exit", "latency_ms", "bucket"}.
        `deadline_ms` is relative to now (None takes the config default;
        0 disables)."""
        t_admit = time.monotonic()
        self._check_state()
        bucket, padder, p1, p2 = self._admit(image1, image2)
        now = time.monotonic()
        deadline_s = self._deadline(deadline_ms, now)
        self._check_deadline(bucket, deadline_s, now)
        tid = None
        if self.tracer.enabled:
            tid = self.tracer.start_trace()
            self.tracer.span("admission", trace=tid, t0=t_admit, t1=now, bucket=list(bucket))
        req = _Request(
            image1=p1, image2=p2, bucket=bucket, deadline_s=deadline_s,
            max_iters=self.config.max_iters if max_iters is None else int(max_iters),
            future=Future(), enqueue_t=now, trace_id=tid,
        )
        outer: Future = Future()

        def _deliver(inner: Future) -> None:
            exc = inner.exception()
            if exc is not None:
                outer.set_exception(exc)
                return
            res, latency_ms = inner.result()
            outer.set_result({
                "disparity": np.asarray(padder.unpad(res.flow_up[None])[0, :, :, 0], np.float32),
                "iters_completed": res.iters_completed,
                "early_exit": res.early_exit,
                "latency_ms": latency_ms,
                "bucket": list(bucket),
            })

        req.future.add_done_callback(_deliver)
        self.batcher.submit(req)
        return outer

    # -- stream sessions ---------------------------------------------------
    def submit_stream(self, stream_id: str, image1: np.ndarray, image2: np.ndarray,
                      deadline_ms: Optional[float] = None, max_iters: Optional[int] = None) -> Future:
        """Admit one frame of a video stream (module docstring: ordering,
        warm start and reset gate). The Future's value is the `submit`
        response plus {"stream_id", "stream_frame", "warm_started",
        "reset"}. Warm frames default to `video.warm_iters`, cold frames to
        `max_iters`; an explicit `max_iters` overrides either."""
        video = self.config.video
        if video is None:
            raise RuntimeError("stream serving disabled: ServeConfig.video is None (serve with --stream)")
        stream_id = str(stream_id)
        t_admit = time.monotonic()
        self._check_state()
        bucket, padder, p1, p2 = self._admit(image1, image2)
        factor = self.config.model.downsample_factor

        with self._streams_lock:
            entry = self._streams.get(stream_id)
            if entry is not None and entry.bucket != bucket:
                # Resolution change: the carried flow is for another shape.
                self._streams.pop(stream_id, None)
                entry = None
        warm = False
        reset = False
        flow_init = None
        if entry is not None and video.warm_start:
            err_candidate = flow_warp_error(p1, p2, entry.flow, factor)
            if should_reset(err_candidate, entry.err, video):
                reset = True
                with self._streams_lock:
                    self._streams.pop(stream_id, None)
            else:
                warm = True
                flow_init = entry.flow
        frame_idx = entry.frames if (entry is not None and not reset) else 0

        now = time.monotonic()
        deadline_s = self._deadline(deadline_ms, now)
        self._check_deadline(bucket, deadline_s, now)
        if max_iters is None:
            max_iters = video.warm_iters if warm else self.config.max_iters
        tid = None
        if self.tracer.enabled:
            tid = self.tracer.start_trace()
            self.tracer.span("admission", trace=tid, t0=t_admit, t1=now, bucket=list(bucket),
                             stream_id=stream_id, warm=warm, reset=reset)
        req = _Request(
            image1=p1, image2=p2, bucket=bucket, deadline_s=deadline_s, max_iters=int(max_iters),
            future=Future(), enqueue_t=now, flow_init=flow_init, trace_id=tid,
        )
        outer: Future = Future()

        def _deliver(inner: Future) -> None:
            exc = inner.exception()
            if exc is not None:
                # A failed frame leaves no trustworthy carry.
                with self._streams_lock:
                    self._streams.pop(stream_id, None)
                outer.set_exception(exc)
                return
            res, latency_ms = inner.result()
            err_out = flow_warp_error(p1, p2, res.flow_lowres, factor)
            with self._streams_lock:
                if np.isfinite(err_out):
                    self._streams[stream_id] = _StreamEntry(flow=res.flow_lowres, err=err_out, bucket=bucket,
                                                            frames=frame_idx + 1)
                    self._streams.move_to_end(stream_id)
                    while len(self._streams) > self.config.max_streams:
                        # LRU eviction; the evicted stream's next frame cold-starts.
                        self._streams.popitem(last=False)
                else:
                    # A non-finite warp error means this frame's flow is no
                    # trustworthy carry: drop it so the NEXT frame
                    # cold-starts. This frame's own result still delivers.
                    self._streams.pop(stream_id, None)
            self.batcher.metrics.record_stream(warm, reset)
            outer.set_result({
                "disparity": np.asarray(padder.unpad(res.flow_up[None])[0, :, :, 0], np.float32),
                "iters_completed": res.iters_completed,
                "early_exit": res.early_exit,
                "latency_ms": latency_ms,
                "bucket": list(bucket),
                "stream_id": stream_id,
                "stream_frame": frame_idx,
                "warm_started": warm,
                "reset": reset,
            })

        req.future.add_done_callback(_deliver)
        self.batcher.submit(req)
        return outer

    def streams_active(self) -> int:
        with self._streams_lock:
            return len(self._streams)

    # -- observability -----------------------------------------------------
    def metrics(self) -> Dict[str, object]:
        return self.batcher.metrics.snapshot(queue_depth=self.batcher.queue_depth(),
                                             streams_active=self.streams_active())

    def boot_block(self) -> Dict[str, object]:
        """The boot numbers, with the JAX package's keys: warmup wall time,
        the kernel cache's accounting (entries == hits + misses, the
        libraries the boot made ready), the boot's kernel builds and the
        replica respawns."""
        ws = self.warm_summary or {}
        cache = ws.get("aot_cache") or {"enabled": False}
        return {
            "warmup_seconds": float(ws.get("warmup_seconds", 0.0) or 0.0),
            "cache_enabled": bool(cache.get("enabled", False)),
            "cache_hits": int(cache.get("cache_hits", 0)),
            "cache_misses": int(cache.get("cache_misses", 0)),
            "entries": int(cache.get("entries", 0)),
            "evictions": int(cache.get("evictions", 0)),
            "compiles_total": int(ws.get("compiles_total", 0)),
            "respawns_total": int(getattr(self.engine, "respawns_total", 0)),
        }

    # ServingMetrics counters mirrored into prom at render time (the
    # authority stays with ServingMetrics).
    _PROM_COUNTER_KEYS = (
        "requests_total",
        "responses_total",
        "rejected_total",
        "shed_total",
        "deadline_infeasible_total",
        "failed_requests_total",
        "deadline_miss_total",
        "early_exit_total",
        "batches_total",
        "stream_requests_total",
        "warm_start_total",
        "stream_resets_total",
        "requeues_total",
        "respawns_total",
    )

    def render_prom(self) -> str:
        """Render the prom registry after syncing the snapshot-style series
        (counters, queue-depth and state gauges) into it. The request-path
        histograms were observed live by the batcher."""
        reg = self.registry
        snap = self.metrics()
        for key in self._PROM_COUNTER_KEYS:
            reg.counter(f"raft_serving_{key}", f"ServingMetrics {key}").set_total(float(snap[key]))
        for bkey, v in snap["requests_by_bucket"].items():
            reg.counter("raft_serving_requests_by_bucket", "Admitted requests per shape bucket").set_total(
                float(v), bucket=bkey)
        reg.gauge("raft_serving_queue_depth", "Total queued requests across buckets").set(float(snap["queue_depth"]))
        for bucket, depth in self.batcher.queue_depths().items():
            reg.gauge("raft_serving_queue_depth_bucket", "Queued requests per bucket").set(
                float(depth), bucket=f"{bucket[0]}x{bucket[1]}")
        reg.gauge("raft_serving_streams_active", "Live stream sessions").set(float(snap["streams_active"]))
        reg.gauge("raft_serving_batch_fill_mean", "Mean real/padded batch fill").set(float(snap["batch_fill_mean"]))
        state_gauge = reg.gauge(
            "raft_serving_state_code",
            "Health state index: " + " ".join(f"{i}={s}" for i, s in enumerate(HEALTH_STATES)),
        )
        state_gauge.set(float(HEALTH_STATES.index(self.lifecycle.state)), replica="aggregate")
        boot = self.boot_block()
        reg.gauge("raft_serving_warmup_seconds", "Wall time of the boot warmup").set(boot["warmup_seconds"])
        reg.gauge("raft_serving_aot_cache_hits", "Warmup executables loaded from the AOT cache").set(
            float(boot["cache_hits"]))
        reg.gauge("raft_serving_aot_cache_misses", "Warmup executables traced and compiled (cache miss)").set(
            float(boot["cache_misses"]))
        return reg.render()

    def healthz(self) -> Dict[str, object]:
        """A run_report-schema payload plus an additive `serving` block:
        validate_run_report ignores unknown keys, so one validator covers
        trainer and server."""
        report = build_run_report(
            stop_cause="completed",
            final_step=self.engine.batches_total,
            jit_hygiene=self.engine.hygiene.report(),
            observability=observability_block(self.tracer),
        )
        report["serving"] = {
            "warmed": self.engine.warmed,
            "state": self.lifecycle.state,
            "lifecycle": self.lifecycle.snapshot(),
            "swap_generation": self.engine.swap_generation,
            "checkpoint": self.current_checkpoint,
            "replicas": self.engine.n_replicas,
            "device": str(self.engine.device),
            "sharding": self.engine.sharding,
            "buckets": [list(b) for b in self.config.buckets],
            "batch_sizes": list(self.config.batch_sizes),
            "chunk_iters": self.config.chunk_iters,
            "max_iters": self.config.max_iters,
            "stream_support": self.config.video is not None,
            "boot": self.boot_block(),
            "attribution": self.batcher.metrics.attribution_summary(),
            "memory": self._last_memory if self._last_memory is not None else memory_block(),
            **self.metrics(),
        }
        return report


def make_http_server(service: StereoService, host: str = "127.0.0.1", port: int = 0,
                     handler_timeout_s: float = 30.0) -> ThreadingHTTPServer:
    """Bind (but don't run) the HTTP front; port 0 picks an ephemeral port
    (read it back from `server.server_address`).

    `handler_timeout_s` is the per-connection socket timeout: a client
    that connects and stalls times out instead of wedging a handler thread;
    a stall inside a POST body gets a 408 before the close."""

    class Handler(BaseHTTPRequestHandler):
        timeout = handler_timeout_s

        def log_message(self, fmt, *args):  # quiet by default
            logger.debug("http: " + fmt, *args)

        def _read_body_or_408(self) -> Optional[bytes]:
            try:
                length = int(self.headers.get("Content-Length", "0"))
                return self.rfile.read(length) if length else b""
            except (socket.timeout, TimeoutError):
                json_response(self, 408, {"error": "request body read timed out"})
                self.close_connection = True
                return None

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path == "/healthz":
                json_response(self, 200, service.healthz())
            elif parsed.path == "/metrics":
                fmt = urllib.parse.parse_qs(parsed.query).get("format", ["json"])[0]
                if fmt == "prom":
                    text_response(self, 200, service.render_prom(), PROM_CONTENT_TYPE)
                elif fmt == "json":
                    json_response(self, 200, service.metrics())
                else:
                    json_response(self, 400, {"error": f"unknown metrics format {fmt!r}"})
            else:
                json_response(self, 404, {"error": f"no route {self.path}"})

        def do_POST(self):
            raw = self._read_body_or_408()
            if raw is None:
                return
            if self.path == "/reload":
                try:
                    body = json.loads(raw) if raw else {}
                    ckpt = body["checkpoint"]
                except (KeyError, ValueError, TypeError) as exc:
                    json_response(self, 400, {"error": f"bad request: {exc!r}"})
                    return
                try:
                    out = service.reload_checkpoint(ckpt)
                except CheckpointMismatchError as exc:
                    # Refused; the old weights keep serving. 409: the
                    # conflict is with server state, not request syntax.
                    json_response(self, 409, {"error": str(exc)})
                    return
                except (OSError, ValueError) as exc:
                    json_response(self, 400, {"error": repr(exc)})
                    return
                except Exception as exc:
                    logger.exception("reload failed")
                    json_response(self, 500, {"error": repr(exc)})
                    return
                json_response(self, 200, out)
                return
            if self.path != "/v1/predict":
                json_response(self, 404, {"error": f"no route {self.path}"})
                return
            try:
                body = json.loads(raw)
                i1 = np.asarray(body["image1"], np.float32)
                i2 = np.asarray(body["image2"], np.float32)
            except (KeyError, ValueError, TypeError) as exc:
                json_response(self, 400, {"error": f"bad request: {exc!r}"})
                return
            try:
                if body.get("stream_id") is not None:
                    fut = service.submit_stream(body["stream_id"], i1, i2, deadline_ms=body.get("deadline_ms"),
                                                max_iters=body.get("max_iters"))
                else:
                    fut = service.submit(i1, i2, deadline_ms=body.get("deadline_ms"),
                                         max_iters=body.get("max_iters"))
                out = fut.result()
            except BucketOverflowError as exc:
                json_response(self, 413, {"error": str(exc)})
                return
            except ServiceUnavailableError as exc:
                # Shed (draining/failed/deadline-infeasible): the service
                # state, not the request, is at fault — 503, never 413.
                json_response(self, 503, {"error": str(exc), "state": service.lifecycle.state})
                return
            except RuntimeError as exc:
                # stream_id against a service without ServeConfig.video
                json_response(self, 400, {"error": str(exc)})
                return
            except Exception as exc:
                logger.exception("predict failed")
                json_response(self, 500, {"error": repr(exc)})
                return
            out = dict(out, disparity=out["disparity"].tolist())
            # Which weight generation answered.
            out["swap_generation"] = service.engine.swap_generation
            json_response(self, 200, out)

    return ThreadingHTTPServer((host, port), Handler)


def serve_http(service: StereoService, host: str, port: int) -> None:
    """Blocking server loop (the `serve` command line): Ctrl-C, and SIGTERM
    when called from the main thread, stop it; requests already admitted
    are answered before the service closes (drain)."""
    server = make_http_server(service, host, port)
    logger.info("serving on http://%s:%d", *server.server_address)
    previous = None
    if threading.current_thread() is threading.main_thread():
        # shutdown() waits for serve_forever to return, so it runs on a
        # thread of its own, not in the handler that interrupts the loop.
        previous = signal.signal(
            signal.SIGTERM, lambda signum, frame: threading.Thread(target=server.shutdown, daemon=True).start())
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
        server.server_close()
        drained = service.drain()
        logger.info("serving stopped: backlog %s", "drained" if drained else "cut at the drain timeout")


__all__ = ["BucketOverflowError", "StereoService", "make_http_server", "serve_http"]
