"""Per-bucket micro-batching with double-buffered host-to-device staging:
counterpart of `raft_stereo_tpu/serving/batcher.py` (`_Request`,
`_StagedBatch`, `ServingMetrics`, `MicroBatcher`).

Threads cooperate around two queues:

    client threads  --submit()--> per-bucket deques
    stager thread   ------------> staging queue (maxsize = n_replicas, on
                                  the device)
    runner thread(s) -----------> engine.run_staged -> futures

The stager picks the bucket whose HEAD request has waited longest (oldest
first — no bucket starves), waits up to `batch_window_ms` for that bucket to
fill toward `max_batch`, pads the batch up to the nearest warmed batch size
by repeating the last row (`_split` may take fewer rows, see there), and
hands it to `engine.stage()`, which starts its copy to the card
(serving/engine.py; a fleet, serving/fleet.py, first picks the
least-loaded healthy replica) BEFORE enqueueing. Because the staging queue
holds at most one ready batch per runner, batch N+1's copy overlaps batch
N's refinement. One runner thread exists per engine replica (one for the
single engine), so a fleet refines n_replicas batches at once. A batch is
drawn from exactly one deque, so buckets never mix
(`ServingMetrics.batch_log` records each batch's bucket).

A batch that raises fails exactly that batch's futures with the exception
and the breaker records it; a fleet has already requeued it once onto
another replica before that.

`ServingMetrics` is the counter authority /metrics reads: queue depth,
batch fill, latency percentiles, deadline-miss / early-exit totals,
per-bucket request counts.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from raft_stereo_tpu_torch.config import ServeConfig
from raft_stereo_tpu_torch.serving.engine import AnytimeEngine
from raft_stereo_tpu_torch.serving.lifecycle import (
    ServiceUnavailableError,
    ServingLifecycle,
)

Bucket = Tuple[int, int]


@dataclasses.dataclass
class _Request:
    image1: np.ndarray  # (H, W, C) already padded to the bucket
    image2: np.ndarray
    bucket: Bucket
    deadline_s: Optional[float]  # absolute monotonic, or None
    max_iters: int
    future: Future
    enqueue_t: float
    # Stream warm start: (H/f, W/f) low-res flow from the session's previous
    # frame, or None for a cold start. Mixed batches are fine — cold rows
    # get zero flow (exact cold-start semantics).
    flow_init: Optional[np.ndarray] = None
    # Flight-recorder trace ID minted at admission (obs/trace.Tracer);
    # rides every span of this request's lifecycle. None when tracing is off.
    trace_id: Optional[int] = None


@dataclasses.dataclass
class _StagedBatch:
    """One assembled batch travelling stager -> staging queue -> runner.

    The stager fills the `*_host` arrays, then hands the batch to
    `engine.stage()`, which sets the device-resident fields and, on a
    card, `ready`: the event recorded after their copy."""

    reqs: List[_Request]
    bucket: Bucket
    i1_host: np.ndarray  # (padded_B, H, W, C) float32
    i2_host: np.ndarray
    flow_host: Optional[np.ndarray]  # (padded_B, H/f, W/f) or None
    padded: int
    # Device-resident, set by engine.stage():
    image1: object = None
    image2: object = None
    flow_init: object = None
    ready: object = None
    # Fleet routing: the replica the batch is staged on, and the replicas
    # that already failed it (the exactly-once requeue's exclusion set).
    # The host arrays are kept for that requeue.
    replica: Optional[int] = None
    excluded: set = dataclasses.field(default_factory=set)
    # Observability: the requests' trace IDs (aligned with `reqs`) and the
    # stager-pop timestamp that closes their queue spans (queue wait =
    # popped_t - enqueue_t; what remains of latency after queue + device
    # time is the host gap).
    trace_ids: Optional[List[int]] = None
    popped_t: float = 0.0


class ServingMetrics:
    """Thread-safe serving counters + a bounded latency reservoir."""

    def __init__(self, latency_window: int = 4096, batch_log: int = 1024):
        self._lock = threading.Lock()
        self.requests_total = 0
        self.responses_total = 0
        self.rejected_total = 0
        self.shed_total = 0
        self.deadline_infeasible_total = 0
        self.failed_requests_total = 0
        self.deadline_miss_total = 0
        self.early_exit_total = 0
        self.batches_total = 0
        self.stream_requests_total = 0
        self.warm_start_total = 0
        self.stream_resets_total = 0
        # Fleet accounting (serving/fleet.py): batches requeued onto another
        # replica, replicas respawned, and per-replica dispatch and
        # in-flight counts.
        self.requeues_total = 0
        self.respawns_total = 0
        self.batches_by_replica: Dict[str, int] = {}
        self.in_flight_by_replica: Dict[str, int] = {}
        self.requests_by_bucket: Dict[str, int] = {}
        self._latencies_ms: collections.deque = collections.deque(
            maxlen=latency_window
        )
        # Latency attribution reservoirs (same bounded-window discipline as
        # the latency reservoir): where each answered request's time went —
        # waiting in the bucket deque, in completed device work, or in the
        # host gap between the two. Read via attribution_summary(), NOT
        # snapshot(): the legacy /metrics JSON key set is frozen.
        self._queue_wait_ms: collections.deque = collections.deque(
            maxlen=latency_window
        )
        self._device_ms: collections.deque = collections.deque(
            maxlen=latency_window
        )
        self._host_gap_ms: collections.deque = collections.deque(
            maxlen=latency_window
        )
        self._fill_sum = 0.0
        # (bucket, real, padded) per dispatched batch — the audit trail the
        # never-mixes-buckets test reads.
        self.batch_log: collections.deque = collections.deque(maxlen=batch_log)

    def record_admit(self, bucket: Bucket) -> None:
        with self._lock:
            self.requests_total += 1
            key = f"{bucket[0]}x{bucket[1]}"
            self.requests_by_bucket[key] = self.requests_by_bucket.get(key, 0) + 1

    def record_reject(self) -> None:
        with self._lock:
            self.rejected_total += 1

    def record_shed(self, deadline_infeasible: bool = False) -> None:
        """Admission-time 503 (lifecycle not admissible, or the deadline is
        already infeasible given queued work) — distinct from record_reject,
        which counts client-side 4xx (bucket overflow)."""
        with self._lock:
            self.shed_total += 1
            if deadline_infeasible:
                self.deadline_infeasible_total += 1

    def record_batch_failure(self, n_requests: int) -> None:
        """One dispatched batch raised: every request in it was answered
        with the exception (they are neither responses nor rejections)."""
        with self._lock:
            self.failed_requests_total += n_requests

    def record_requeue(self) -> None:
        with self._lock:
            self.requeues_total += 1

    def record_respawn(self) -> None:
        with self._lock:
            self.respawns_total += 1

    def record_replica_dispatch(self, idx: int) -> None:
        with self._lock:
            key = str(idx)
            self.in_flight_by_replica[key] = self.in_flight_by_replica.get(key, 0) + 1

    def record_replica_done(self, idx: int) -> None:
        with self._lock:
            key = str(idx)
            self.in_flight_by_replica[key] = self.in_flight_by_replica.get(key, 0) - 1
            self.batches_by_replica[key] = self.batches_by_replica.get(key, 0) + 1

    def record_stream(self, warm_started: bool, reset: bool) -> None:
        with self._lock:
            self.stream_requests_total += 1
            if warm_started:
                self.warm_start_total += 1
            if reset:
                self.stream_resets_total += 1

    def record_batch(self, bucket: Bucket, real: int, padded: int) -> None:
        with self._lock:
            self.batches_total += 1
            self._fill_sum += real / padded
            self.batch_log.append((bucket, real, padded))

    def record_response(
        self, latency_ms: float, early_exit: bool, deadline_missed: bool
    ) -> None:
        with self._lock:
            self.responses_total += 1
            self._latencies_ms.append(latency_ms)
            if early_exit:
                self.early_exit_total += 1
            if deadline_missed:
                self.deadline_miss_total += 1

    def record_attribution(
        self, queue_wait_ms: float, device_ms: float, host_gap_ms: float
    ) -> None:
        with self._lock:
            self._queue_wait_ms.append(float(queue_wait_ms))
            self._device_ms.append(float(device_ms))
            self._host_gap_ms.append(float(host_gap_ms))

    @staticmethod
    def _percentile(sorted_vals: List[float], q: float) -> Optional[float]:
        """Linear-interpolation percentile over an already-sorted window.

        Returns None below two samples: a percentile of nothing is not 0.0
        (the old nearest-rank code crashed on empty and reported a single
        sample as every percentile — both lies to a dashboard)."""
        n = len(sorted_vals)
        if n < 2:
            return None
        pos = q * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        frac = pos - lo
        return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac

    @classmethod
    def _series_summary(cls, window) -> Dict[str, object]:
        """Typed {count, mean, p50, p95} for one attribution reservoir.
        count is always an int; the stats are 0.0 below two samples (bench
        JSON wants numbers — the count disambiguates 'no data')."""
        vals = sorted(window)
        n = len(vals)
        return {
            "count": n,
            "mean": (sum(vals) / n) if n else 0.0,
            "p50": cls._percentile(vals, 0.50) or 0.0,
            "p95": cls._percentile(vals, 0.95) or 0.0,
        }

    def attribution_summary(self) -> Dict[str, object]:
        """Per-request latency attribution over the bounded window:
        queue-wait, device-time, host-gap histogram summaries for
        bench_serving, /healthz, and the prom endpoint. Separate from
        snapshot() on purpose — the legacy /metrics JSON key set is frozen
        byte-compatible."""
        with self._lock:
            return {
                "window": self._latencies_ms.maxlen,
                "queue_wait_ms": self._series_summary(self._queue_wait_ms),
                "device_ms": self._series_summary(self._device_ms),
                "host_gap_ms": self._series_summary(self._host_gap_ms),
            }

    def snapshot(self, queue_depth: int = 0, streams_active: int = 0) -> Dict[str, object]:
        with self._lock:
            lats = sorted(self._latencies_ms)
            fill = self._fill_sum / self.batches_total if self.batches_total else 0.0
            return {
                "requests_total": self.requests_total,
                "responses_total": self.responses_total,
                "rejected_total": self.rejected_total,
                "shed_total": self.shed_total,
                "deadline_infeasible_total": self.deadline_infeasible_total,
                "failed_requests_total": self.failed_requests_total,
                "deadline_miss_total": self.deadline_miss_total,
                "early_exit_total": self.early_exit_total,
                "batches_total": self.batches_total,
                "stream_requests_total": self.stream_requests_total,
                "warm_start_total": self.warm_start_total,
                "stream_resets_total": self.stream_resets_total,
                "requeues_total": self.requeues_total,
                "respawns_total": self.respawns_total,
                "batches_by_replica": dict(self.batches_by_replica),
                "in_flight_by_replica": dict(self.in_flight_by_replica),
                "streams_active": streams_active,
                "queue_depth": queue_depth,
                "batch_fill_mean": fill,
                "latency_p50_ms": self._percentile(lats, 0.50),
                "latency_p99_ms": self._percentile(lats, 0.99),
                "requests_by_bucket": dict(self.requests_by_bucket),
            }


class MicroBatcher:
    """Owns the request deques and the stager/runner thread pair."""

    # Observability hooks, set post-construction by the service (None = off,
    # and every use below is guarded — direct MicroBatcher construction in
    # tests/bench keeps working untouched):
    #   tracer          obs/trace.Tracer for queue/stage/respond spans
    #   registry        obs/prom.Registry for attribution histograms
    #   memory_sampler  zero-arg callable sampling device memory per batch
    tracer = None
    registry = None
    memory_sampler = None

    def __init__(
        self,
        config: ServeConfig,
        engine: AnytimeEngine,
        lifecycle: Optional[ServingLifecycle] = None,
    ):
        self.config = config
        self.engine = engine
        self.lifecycle = lifecycle if lifecycle is not None else engine.lifecycle
        self.metrics = ServingMetrics()
        # A fleet mirrors its routing into these metrics.
        if hasattr(engine, "bind_metrics"):
            engine.bind_metrics(self.metrics)
        self._deques: Dict[Bucket, collections.deque] = {
            tuple(b): collections.deque() for b in config.buckets
        }
        self._cond = threading.Condition()
        # One staged batch on the device per runner while each runs: the
        # double buffer. One runner per engine replica.
        self._n_runners = max(1, int(getattr(engine, "n_replicas", 1)))
        self._staged: "queue.Queue" = queue.Queue(maxsize=self._n_runners)
        self._stop = False
        self._draining = False
        # Requests admitted but not yet answered (result OR exception) —
        # drain() waits on this hitting zero.
        self._pending = 0
        self._stager = threading.Thread(
            target=self._stage_loop, name="serving-stager", daemon=True
        )
        self._runners = [threading.Thread(target=self._runner_main, name="serving-runner", daemon=True)]
        self._runners += [threading.Thread(target=self._run_loop, name=f"serving-runner-{i}", daemon=True)
                          for i in range(1, self._n_runners)]
        self._runner = self._runners[0]
        self._warm: Optional[Callable[[], object]] = None
        self._warmed = threading.Event()
        self._warm_outcome: Dict[str, object] = {}

    def start(self, warm: Optional[Callable[[], object]] = None) -> object:
        """Start the runner and stager threads. `warm`, if given, runs
        first on the runner thread, which launches every batch's kernels:
        CUDA libraries keep per-thread state (cuDNN and cuBLAS handles and
        their workspaces), so warming there creates it at boot and not on
        the first request. Returns what `warm` returns; raises what it
        raises, with no thread left running."""
        self._warm = warm
        self._runner.start()
        self._warmed.wait()
        if "error" in self._warm_outcome:
            self._runner.join()
            raise self._warm_outcome["error"]
        for runner in self._runners[1:]:
            runner.start()
        self._stager.start()
        return self._warm_outcome.get("result")

    def _runner_main(self) -> None:
        try:
            if self._warm is not None:
                self._warm_outcome["result"] = self._warm()
        except BaseException as exc:  # noqa: BLE001 - start() re-raises it
            self._warm_outcome["error"] = exc
            return
        finally:
            self._warmed.set()
        self._run_loop()

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._stager.join(timeout=10)
        # Deliver the runner's shutdown sentinel reliably: a staged batch may
        # still hold the queue's one slot, so keep offering it until the
        # runner ends, bounded so a wedged runner can't hang close() either.
        sentinel_deadline = time.monotonic() + 10.0
        while any(r.is_alive() for r in self._runners) and time.monotonic() < sentinel_deadline:
            try:
                self._staged.put(None, timeout=0.1)
            except queue.Full:
                continue
        join_deadline = time.monotonic() + 30.0
        for r in self._runners:
            if r.ident is not None:
                r.join(timeout=max(0.0, join_deadline - time.monotonic()))
        self._fail_leftovers()

    def _fail_leftovers(self) -> None:
        """After shutdown, answer every request that never reached the
        engine — close() must strand no future."""
        exc = ServiceUnavailableError("batcher shut down before request ran")
        leftovers: List[_Request] = []
        with self._cond:
            for dq in self._deques.values():
                leftovers.extend(dq)
                dq.clear()
        while True:
            try:
                batch = self._staged.get_nowait()
            except queue.Empty:
                break
            if batch is not None:
                leftovers.extend(batch.reqs)
        n = 0
        for r in leftovers:
            if not r.future.done():
                r.future.set_exception(exc)
                n += 1
        if n:
            self._done(n)

    def drain(self, timeout_s: float) -> bool:
        """Stop admission, then wait until every already-admitted request
        has been answered (queued, staged, and running batches all finish).
        Returns True if the backlog fully drained within `timeout_s`."""
        deadline = time.monotonic() + float(timeout_s)
        with self._cond:
            self._draining = True
            while self._pending > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=min(remaining, 0.1))
        return True

    def _done(self, n: int) -> None:
        with self._cond:
            self._pending -= n
            self._cond.notify_all()

    def queue_depth(self) -> int:
        with self._cond:
            return sum(len(d) for d in self._deques.values())

    def queue_depths(self) -> Dict[Bucket, int]:
        """Per-bucket queue depth (the prom endpoint's per-bucket gauges)."""
        with self._cond:
            return {b: len(d) for b, d in self._deques.items()}

    def submit(self, req: _Request) -> Future:
        self.metrics.record_admit(req.bucket)
        with self._cond:
            if self._stop or self._draining:
                raise RuntimeError("batcher is shut down")
            self._pending += 1
            self._deques[req.bucket].append(req)
            self._cond.notify_all()
        return req.future

    # -- stager ------------------------------------------------------------
    def _pick_bucket(self) -> Optional[Bucket]:
        oldest_t, pick = None, None
        for bucket, dq in self._deques.items():
            if dq and (oldest_t is None or dq[0].enqueue_t < oldest_t):
                oldest_t, pick = dq[0].enqueue_t, bucket
        return pick

    def _split(self, bucket: Bucket, n: int) -> Tuple[int, int]:
        """(rows to take, padded batch size) for `n` queued requests of
        `bucket`, n <= max_batch. The JAX batcher pads up to the nearest
        warmed size. Here a warmed size whose chunk the warm-up measured at
        less than half the padded size's time per real row is taken
        instead, its rows oldest first, the rest left queued: on an H100
        at fp32 a 512x768 batch of 4 takes over 100x a batch of 2's chunk,
        where padding 3 rows up to it would cost every row its latency.
        The factor of 2 keeps one chunk's timing noise from flipping the
        choice between sizes whose times per row are close."""
        sizes = self.config.batch_sizes
        padded = next(b for b in sizes if b >= n)
        per_row = {b: self.engine.chunk_estimate_s(bucket, b) / min(b, n) for b in sizes}
        known = [b for b in sizes if per_row[b] > 0]
        if per_row[padded] <= 0 or not known:
            return n, padded
        best = min(known, key=lambda b: (per_row[b], -b))
        if per_row[best] < 0.5 * per_row[padded]:
            return min(best, n), best
        return n, padded

    def _stage_loop(self) -> None:
        try:
            self._stage_loop_inner()
        finally:
            # The runner's shutdown sentinel must survive a stager crash,
            # else the runner blocks on .get() forever. close() retries the
            # put if a staged batch still holds the slot here.
            try:
                self._staged.put_nowait(None)
            except queue.Full:
                pass

    def _stage_loop_inner(self) -> None:
        window_s = self.config.batch_window_ms / 1e3
        while True:
            with self._cond:
                while not self._stop and self._pick_bucket() is None:
                    self._cond.wait(timeout=0.1)
                if self._stop and self._pick_bucket() is None:
                    break
                bucket = self._pick_bucket()
                # Hold the head request up to the batch window for company
                # (skipped when the batch is already full or shutting down).
                deadline = time.monotonic() + window_s
                while (
                    not self._stop
                    and len(self._deques[bucket]) < self.config.max_batch
                ):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                dq = self._deques[bucket]
                take, padded = self._split(bucket, min(len(dq), self.config.max_batch))
                reqs = [dq.popleft() for _ in range(take)]
            pop_t = time.monotonic()
            tracer = self.tracer
            if tracer is not None:
                # The pop closes each request's queue span (enqueue -> pop).
                for r in reqs:
                    tracer.span(
                        "queue",
                        trace=r.trace_id,
                        t0=r.enqueue_t,
                        t1=pop_t,
                        bucket=list(bucket),
                    )
            # Assemble + land on device OUTSIDE the condition lock: this is
            # the transfer that overlaps the running batch's compute.
            i1 = np.stack([r.image1 for r in reqs], axis=0)
            i2 = np.stack([r.image2 for r in reqs], axis=0)
            if padded > len(reqs):
                fill = padded - len(reqs)
                i1 = np.concatenate([i1, np.repeat(i1[-1:], fill, axis=0)])
                i2 = np.concatenate([i2, np.repeat(i2[-1:], fill, axis=0)])
            flow_host = None
            if any(r.flow_init is not None for r in reqs):
                # Warm-started stream batch: rows without a carried flow
                # (cold frames, non-stream requests, padding) get zeros —
                # coords1 + 0 is the exact cold-start state, so mixing is
                # semantically free.
                f = self.config.model.downsample_factor
                lo_shape = (bucket[0] // f, bucket[1] // f)
                rows = [
                    np.asarray(r.flow_init, np.float32)
                    if r.flow_init is not None
                    else np.zeros(lo_shape, np.float32)
                    for r in reqs
                ]
                rows += [np.zeros(lo_shape, np.float32)] * (padded - len(reqs))
                flow_host = np.stack(rows, axis=0)
            batch = _StagedBatch(
                reqs=reqs,
                bucket=bucket,
                i1_host=i1.astype(np.float32),
                i2_host=i2.astype(np.float32),
                flow_host=flow_host,
                padded=padded,
                trace_ids=[r.trace_id for r in reqs] if tracer is not None else None,
                popped_t=pop_t,
            )
            # engine.stage() starts the copy to the device; a batch whose
            # copy fails is failed like one whose run fails.
            try:
                self.engine.stage(batch)
            except Exception as exc:  # noqa: BLE001 - deliver it, keep serving
                self._fail_batch(batch, exc)
                continue
            if tracer is not None:
                tracer.span(
                    "stage",
                    t0=pop_t,
                    t1=time.monotonic(),
                    bucket=list(bucket),
                    real=len(reqs),
                    padded=padded,
                    traces=batch.trace_ids,
                )
            self.metrics.record_batch(bucket, len(reqs), padded)
            self._staged.put(batch)

    # -- runner ------------------------------------------------------------
    def _fail_batch(self, batch: _StagedBatch, exc: BaseException) -> None:
        """Fail exactly this batch's futures with `exc`; the breaker
        records it. Recorded BEFORE the futures resolve: a client that just
        observed its request fail must see the breaker already advanced."""
        reqs = batch.reqs
        self.metrics.record_batch_failure(len(reqs))
        if self.tracer is not None:
            # Before the lifecycle call: a breaker trip dumps the flight
            # recorder, and this event (with the victims' trace IDs) must
            # already be in the window it dumps.
            self.tracer.event(
                "batch_failure",
                traces=[r.trace_id for r in reqs],
                bucket=list(batch.bucket),
                error=repr(exc),
            )
        self.lifecycle.record_batch_failure(exc)
        for r in reqs:
            if not r.future.done():
                r.future.set_exception(exc)
        self._done(len(reqs))

    def _run_loop(self) -> None:
        while True:
            batch = self._staged.get()
            if batch is None:
                break
            reqs = batch.reqs
            try:
                results = self.engine.run_staged(batch)
            except Exception as exc:  # deliver the failure, keep serving
                self._fail_batch(batch, exc)
                continue
            done_t = time.monotonic()
            self.lifecycle.record_batch_success()  # same ordering as above
            registry = self.registry
            for r, res in zip(reqs, results):
                latency_ms = (done_t - r.enqueue_t) * 1e3
                missed = (
                    r.deadline_s is not None and done_t > r.deadline_s
                )
                self.metrics.record_response(latency_ms, res.early_exit, missed)
                # Latency attribution: queue wait ends at the stager pop,
                # device time is the engine's accumulated sync-boundary
                # wall, and whatever is left (staging transfer, assembly,
                # future plumbing) is the host gap — clamped at zero since
                # a shared batch's device wall can exceed a late joiner's
                # own queue-adjusted latency.
                queue_wait_ms = max(0.0, (batch.popped_t - r.enqueue_t) * 1e3)
                device_ms = float(getattr(res, "device_time_s", 0.0)) * 1e3
                host_gap_ms = max(0.0, latency_ms - queue_wait_ms - device_ms)
                self.metrics.record_attribution(
                    queue_wait_ms, device_ms, host_gap_ms
                )
                if registry is not None:
                    registry.histogram(
                        "raft_serving_queue_wait_ms",
                        "Request wait in the bucket deque before staging",
                    ).observe(queue_wait_ms)
                    registry.histogram(
                        "raft_serving_device_ms",
                        "Completed device work wall time at delivery",
                    ).observe(device_ms)
                    registry.histogram(
                        "raft_serving_host_gap_ms",
                        "Latency unexplained by queue wait or device time",
                    ).observe(host_gap_ms)
                if self.tracer is not None:
                    self.tracer.span(
                        "respond",
                        trace=r.trace_id,
                        t0=r.enqueue_t,
                        t1=done_t,
                        latency_ms=latency_ms,
                        queue_wait_ms=queue_wait_ms,
                        device_ms=device_ms,
                        host_gap_ms=host_gap_ms,
                        iters=res.iters_completed,
                        early_exit=res.early_exit,
                        missed=missed,
                    )
                r.future.set_result((res, latency_ms))
            if self.memory_sampler is not None:
                try:
                    self.memory_sampler()
                except Exception:  # noqa: BLE001 - telemetry is best-effort
                    pass
            self._done(len(reqs))
