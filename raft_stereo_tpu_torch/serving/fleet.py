"""Engine fleet: replicas, per-replica fault domains, failover. Counterpart
of `raft_stereo_tpu/serving/fleet.py` (`ReplicaHungError`, `_Replica`,
`FleetLifecycle`, `EngineFleet`).

One `AnytimeEngine` is one fault domain: a hung chunk or a failing device
turns the whole single-engine service `failed`. The fleet makes that domain
one replica: N engines behind the one `MicroBatcher`, each with its own
copy of the weights on its own torch device, its own staging stream, its
own `ServingLifecycle` breaker and its own hang watchdog. The default
devices are `cuda:0 ... cuda:{N-1}`, one per card; more replicas than cards
are refused. An explicit `devices` list may name one device twice (two
replicas sharing a card, or the CPU in tests): each replica still holds its
own weights and breaker.

Routing and failover (`stage` / `run_staged`):

- **least-loaded staging**: the stager's `stage()` picks the admissible
  replica with the fewest in-flight batches (ties to the lowest index) and
  copies the host batch onto its device;
- **failover requeue, exactly once**: a batch whose replica raises or hangs
  is staged again, from the kept host arrays, onto a DIFFERENT replica (the
  batch carries the replicas that failed it). Replicas hold the same
  weights and run the same kernels, so the retry answers bit for bit as the
  first replica would have; only a second failure reaches the futures. The
  first failure moves the failing replica's breaker alone;
- **hang abandonment**: each replica call runs on a disposable thread,
  which makes the replica's device current for itself (the CUDA current
  device is per thread; the current stream is the device's default stream
  on a fresh thread). When the replica's watchdog records a hang the fleet
  stops waiting, requeues the batch, and discards whatever the wedged call
  returns later.

Rolling hot-swap (`swap_variables`): one replica at a time, each under its
own run lock, so the others keep serving. A refusal on any replica rolls
every already-swapped replica back to its copy of the previous weights, so
the fleet never serves two sets of weights; only a complete roll bumps the
fleet's `swap_generation`.

Respawn (`replace_replica`, and with `auto_respawn` `_maybe_respawn` when a
breaker sticks `failed`): a fresh engine on the same device, with a copy of
the serving weights, warmed (the kernels are built already, so a warm is a
few forwards), validated through the swap path and entered in probation.
Every reference the fleet holds to the old engine is dropped; its summary
reports the card's allocated memory before the boot and after the old
engine is released (a wedged call still running on the old engine keeps
its memory until it returns).

As in JAX, the fleet shares one `JitHygiene` (utils/jit_hygiene.py) and
one kernel cache (serving/aot.py) among its replicas, and a respawned
replica boots under both: the build monitor's listener is process-wide,
so one monitor counts every replica's builds, and a respawn's warm-up
builds nothing (its libraries are loaded already).

`FleetLifecycle` derives the service verdict from the replica breakers:
`healthy` when every replica is, `failed` when every replica is, `degraded`
in between; draining is fleet-wide. `replicas=1` never builds a fleet: the
service keeps the single-engine path.
"""

from __future__ import annotations

import collections
import gc
import logging
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from raft_stereo_tpu_torch.config import ServeConfig
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.serving.engine import AnytimeEngine, BatchResult
from raft_stereo_tpu_torch.serving.lifecycle import ServingLifecycle
from raft_stereo_tpu_torch.utils.jit_hygiene import JitHygiene

logger = logging.getLogger(__name__)


class ReplicaHungError(RuntimeError):
    """A replica's watchdog fired while its batch ran: the fleet abandoned
    the wedged call (the replica stays `failed`, still holding its run
    lock) and requeued the batch. Reaches a request future only if the
    requeue finds no other replica."""


class _Replica:
    """One fault domain: a device, its engine, its breaker, and the router's
    in-flight count (batches staged or running on it). `respawning` keeps
    one replacement boot per slot at a time."""

    __slots__ = ("idx", "device", "engine", "in_flight", "respawning")

    def __init__(self, idx: int, device: torch.device, engine: AnytimeEngine):
        self.idx = idx
        self.device = device
        self.engine = engine
        self.in_flight = 0
        self.respawning = False

    @property
    def lifecycle(self) -> ServingLifecycle:
        return self.engine.lifecycle


class FleetLifecycle:
    """Aggregate health over the replica breakers, with the surface
    `ServingLifecycle` gives the service, batcher and HTTP front. The state
    is derived on every read: `failed` iff every replica is failed, else
    `draining` while draining, `healthy` iff every replica is, `degraded`
    otherwise. Batch outcomes recorded here are fleet totals only; the
    breakers that move live on the replicas."""

    def __init__(self, replicas: Sequence[ServingLifecycle]):
        self._replicas = list(replicas)
        self._lock = threading.Lock()
        self._draining = False
        self._last_state: Optional[str] = None
        self.batch_failures_total = 0
        self.batch_successes_total = 0
        self.swaps_total = 0
        self.last_failure: Optional[str] = None
        self.transitions: collections.deque = collections.deque(maxlen=32)
        # Fired as (frm, to, reason) outside the lock, on whichever public
        # call first notices a change of the derived state.
        self.on_transition = None
        self._pending_notify: List[Tuple[str, str, str]] = []

    def _notify(self) -> None:
        hook = self.on_transition
        with self._lock:
            if not self._pending_notify:
                return
            pending, self._pending_notify = self._pending_notify, []
        if hook is None:
            return
        for frm, to, reason in pending:
            try:
                hook(frm, to, reason)
            except Exception:  # noqa: BLE001 - observability is best-effort
                pass

    def _derived_locked(self) -> str:
        states = [rl.state for rl in self._replicas]
        if all(s == "failed" for s in states):
            state = "failed"
        elif self._draining:
            state = "draining"
        elif all(s == "healthy" for s in states):
            state = "healthy"
        else:
            state = "degraded"
        if state != self._last_state:
            if self._last_state is not None:
                record = (self._last_state, state, "replica aggregate")
                self.transitions.append(record)
                self._pending_notify.append(record)
            self._last_state = state
        return state

    @property
    def state(self) -> str:
        with self._lock:
            state = self._derived_locked()
        self._notify()
        return state

    def admissible(self) -> bool:
        """The fleet admits while any replica does."""
        with self._lock:
            if self._draining:
                return False
        return any(rl.admissible() for rl in self._replicas)

    def record_batch_success(self) -> None:
        with self._lock:
            self.batch_successes_total += 1

    def record_batch_failure(self, exc: Optional[BaseException] = None) -> str:
        """A batch failed on two replicas (or found no second one) and the
        exception reached its futures."""
        with self._lock:
            self.batch_failures_total += 1
            if exc is not None:
                self.last_failure = repr(exc)
            state = self._derived_locked()
        self._notify()
        return state

    def note_swap(self, generation: int) -> None:
        with self._lock:
            self.swaps_total += 1

    def replace_replica_lifecycle(self, idx: int, lifecycle: ServingLifecycle) -> None:
        """Point the aggregate at a respawned replica's fresh breaker (the
        retired one stays `failed` for good)."""
        with self._lock:
            self._replicas[int(idx)] = lifecycle

    def start_drain(self) -> None:
        with self._lock:
            if not self._draining:
                frm = self._derived_locked()
                self._draining = True
                record = (frm, self._derived_locked(), "drain")
                self.transitions.append(record)
                self._pending_notify.append(record)
        self._notify()

    def snapshot(self) -> Dict[str, object]:
        reps = [rl.snapshot() for rl in self._replicas]
        with self._lock:
            snap = {
                "state": self._derived_locked(),
                "draining": self._draining,
                "replica_states": [r["state"] for r in reps],
                "replicas": reps,
                "batch_failures_total": self.batch_failures_total,
                "batch_successes_total": self.batch_successes_total,
                "hangs_total": sum(r["hangs_total"] for r in reps),
                "swaps_total": self.swaps_total,
                "last_failure": self.last_failure,
                "transitions": [list(t) for t in self.transitions],
            }
        self._notify()
        return snap


def _default_devices(n: int) -> List[torch.device]:
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > count:
        raise ValueError(f"replicas={n} exceeds the {count} visible card(s): a replica is one card by default "
                         "(pass devices= to place several on one)")
    return [torch.device("cuda", i) for i in range(n)]


def _allocated(device: torch.device) -> int:
    return int(torch.cuda.memory_allocated(device)) if device.type == "cuda" else 0


class EngineFleet:
    """N `AnytimeEngine` replicas behind one batcher-compatible surface
    (stage / run_staged / warm / swap_variables / chunk_estimate_s).

    `model` is the `RAFTStereo` whose weights every replica copies (None:
    seeded random weights from `seed`); `devices` one torch device per
    replica (None: one card each); `aot_cache` the boot's kernel cache
    (serving/aot.py) or None."""

    def __init__(self, config: ServeConfig, model: Optional[RAFTStereo] = None,
                 devices: Optional[Sequence] = None, seed: int = 0, aot_cache=None):
        if config.replicas < 2:
            raise ValueError("EngineFleet needs replicas >= 2; the single-engine service is the replicas=1 path")
        if devices is None:
            devices = _default_devices(config.replicas)
        devices = [torch.device(d) for d in devices]
        if config.replicas > len(devices):
            raise ValueError(f"replicas={config.replicas} exceeds the {len(devices)} device(s) given")
        self.config = config
        if model is None:
            model = build_model(config.model, seed=seed, device="cpu")
        source = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
        self.hygiene = JitHygiene(strict=False, recompile_grace=0)
        self.hygiene.monitor.label = "serving-fleet"
        self.aot_cache = aot_cache
        self.replicas: List[_Replica] = []
        for i in range(config.replicas):
            engine = AnytimeEngine(config, self._model_on(devices[i], source), device=devices[i],
                                   lifecycle=self._new_lifecycle(i), hygiene=self.hygiene, aot_cache=aot_cache)
            self.replicas.append(_Replica(i, devices[i], engine))
        del source
        self.lifecycle = FleetLifecycle([r.lifecycle for r in self.replicas])
        self.metrics = None  # bound by the MicroBatcher
        self._route_lock = threading.Lock()
        self._swap_lock = threading.Lock()
        # Bumped only by a complete roll (replicas keep their own).
        self.swap_generation = 0
        self.respawns_total = 0
        self.last_respawn: Optional[Dict[str, object]] = None
        # Live disposable threads (batch calls, respawn boots) that close()
        # joins, bounded.
        self._threads_lock = threading.Lock()
        self._live_threads: set = set()

    def _new_lifecycle(self, idx: int) -> ServingLifecycle:
        return ServingLifecycle(
            degrade_after=self.config.breaker_degrade_after,
            fail_after=self.config.breaker_fail_after,
            probation=self.config.breaker_probation,
            name=f"replica{idx}",
        )

    def _model_on(self, device: torch.device, state: Dict[str, torch.Tensor]) -> RAFTStereo:
        """A replica's own model: the architecture on the CPU with the
        given weights copied in, then moved to its device."""
        with torch.device("meta"):
            model = RAFTStereo(self.config.model)
        model = model.to_empty(device="cpu")
        model.load_state_dict(state)
        return model.to(device).eval()

    # -- batcher surface ---------------------------------------------------
    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def device(self) -> str:
        return ",".join(str(r.device) for r in self.replicas)

    @property
    def sharding(self) -> str:
        return self.replicas[0].engine.sharding

    @property
    def tracer(self):
        """The replicas' flight-recorder tracer: setting it sets every
        replica's, so spans and watchdog dumps land in one recorder."""
        return self.replicas[0].engine.tracer

    @tracer.setter
    def tracer(self, tracer) -> None:
        for r in self.replicas:
            r.engine.tracer = tracer

    def replica_lifecycles(self) -> List[ServingLifecycle]:
        return [r.lifecycle for r in self.replicas]

    @property
    def variables(self) -> Dict[str, torch.Tensor]:
        """Replica 0's state dict, the reference copy (every replica holds
        the same values)."""
        return self.replicas[0].engine.model.state_dict()

    @property
    def warmed(self) -> bool:
        return all(r.engine.warmed for r in self.replicas)

    @property
    def batches_total(self) -> int:
        return sum(r.engine.batches_total for r in self.replicas)

    def bind_metrics(self, metrics) -> None:
        self.metrics = metrics

    def warm(self) -> Dict[str, object]:
        """Warm every replica in turn; the summary keeps the single
        engine's keys."""
        t0 = time.monotonic()
        per = [r.engine.warm() for r in self.replicas]
        return {
            "combos": per[0]["combos"],
            "compiles_total": self.hygiene.monitor.stats()["compiles_total"],
            "warmup_seconds": time.monotonic() - t0,
            # The shared cache's counters span every replica's warm-up.
            "aot_cache": self.aot_cache.stats() if self.aot_cache is not None else {"enabled": False},
            "replicas": len(self.replicas),
            "devices": [str(r.device) for r in self.replicas],
            "chunk_est_ms": per[0]["chunk_est_ms"],
            "prelude_ms": per[0]["prelude_ms"],
        }

    def join_run_threads(self, timeout_s: float = 5.0) -> int:
        """Join the disposable threads within `timeout_s` in all; a wedged
        call stays a daemon thread. Returns how many are still alive."""
        deadline = time.monotonic() + float(timeout_s)
        with self._threads_lock:
            threads = list(self._live_threads)
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        with self._threads_lock:
            self._live_threads = {t for t in self._live_threads if t.is_alive()}
            leaked = len(self._live_threads)
        if leaked:
            logger.warning("fleet: %d run thread(s) still alive after %.1fs (wedged calls stay daemon)",
                           leaked, timeout_s)
        return leaked

    def close(self, thread_join_timeout_s: float = 5.0) -> None:
        self.join_run_threads(thread_join_timeout_s)
        for r in self.replicas:
            r.engine.close()
        self.hygiene.monitor.stop()

    def chunk_estimate_s(self, bucket: Tuple[int, int], batch: int) -> float:
        """The slowest replica's warmed chunk time over the number of
        admissible replicas (admission's queue-drain estimate)."""
        est = max((r.engine.chunk_estimate_s(bucket, batch) for r in self.replicas), default=0.0)
        n = sum(1 for r in self.replicas if r.lifecycle.admissible())
        return est / max(1, n)

    # -- threads -----------------------------------------------------------
    def _spawn(self, target, name: str) -> threading.Thread:
        def _run() -> None:
            try:
                target()
            finally:
                with self._threads_lock:
                    self._live_threads.discard(t)

        t = threading.Thread(target=_run, name=name, daemon=True)
        with self._threads_lock:
            self._live_threads.add(t)
        t.start()
        return t

    # -- routing -----------------------------------------------------------
    def _acquire_replica(self, excluded=()) -> Optional[_Replica]:
        """The least-loaded admissible replica outside `excluded`, with one
        in-flight slot claimed; any replica outside `excluded` when none is
        admissible (an admitted batch must run, and fail loudly)."""
        with self._route_lock:
            pool = [r for r in self.replicas if r.idx not in excluded]
            admissible = [r for r in pool if r.lifecycle.admissible()]
            pool = admissible or pool
            if not pool:
                return None
            rep = min(pool, key=lambda r: (r.in_flight, r.idx))
            rep.in_flight += 1
        if self.metrics is not None:
            self.metrics.record_replica_dispatch(rep.idx)
        return rep

    def _release_replica(self, rep: _Replica) -> None:
        with self._route_lock:
            rep.in_flight -= 1
        if self.metrics is not None:
            self.metrics.record_replica_done(rep.idx)

    def _place(self, rep: _Replica, staged) -> None:
        rep.engine.stage(staged)
        staged.replica = rep.idx

    def stage(self, staged) -> None:
        """Route and land one host batch (the stager thread)."""
        rep = self._acquire_replica()
        assert rep is not None, "fleet has no replicas"
        try:
            self._place(rep, staged)
        except BaseException:
            self._release_replica(rep)
            raise

    # -- run + failover ----------------------------------------------------
    def run_staged(self, staged) -> List[BatchResult]:
        rep = self.replicas[staged.replica]
        attempts = 0
        while True:
            attempts += 1
            try:
                return self._run_on(rep, staged)
            except Exception as exc:
                # The replica breaker already moved (_run_on records first).
                # Requeue exactly once: a batch that failed two replicas is
                # most likely the batch's own fault.
                staged.excluded.add(rep.idx)
                self._maybe_respawn(rep)
                if attempts >= 2:
                    raise
                nxt = self._acquire_replica(excluded=staged.excluded)
                if nxt is None:
                    raise
                logger.warning("fleet: requeueing batch (bucket=%s, n=%d) from replica %d to %d after %r",
                               staged.bucket, len(staged.reqs), rep.idx, nxt.idx, exc)
                if self.metrics is not None:
                    self.metrics.record_requeue()
                tracer = self.tracer
                if tracer is not None:
                    tracer.event("requeue", traces=getattr(staged, "trace_ids", None), bucket=list(staged.bucket),
                                 frm=rep.idx, to=nxt.idx, error=repr(exc))
                # Staged again from the kept host arrays, onto the new
                # replica's device.
                try:
                    self._place(nxt, staged)
                except BaseException:
                    self._release_replica(nxt)
                    raise
                rep = nxt

    def _run_on(self, rep: _Replica, staged) -> List[BatchResult]:
        """One batch on one replica, on a disposable thread, watching the
        replica's breaker for a hang verdict."""
        eng = rep.engine
        hangs_before = eng.lifecycle.hangs_total
        done: Future = Future()

        def _call() -> None:
            try:
                done.set_result(eng.run_staged(staged))
            except BaseException as exc:  # noqa: BLE001 - forwarded below
                done.set_exception(exc)
            finally:
                self._release_replica(rep)

        self._spawn(_call, f"fleet-run-r{rep.idx}")
        poll_s = None if self.config.hang_timeout_s <= 0 else 0.05
        while True:
            try:
                results = done.result(timeout=poll_s)
            except FutureTimeoutError:
                if eng.lifecycle.hangs_total > hangs_before:
                    raise ReplicaHungError(
                        f"replica {rep.idx} hung mid-chunk (watchdog verdict); batch abandoned for requeue"
                    ) from None
                continue
            except Exception as exc:
                # Recorded before the raise: the caller, and in the end the
                # client, sees the replica breaker already moved.
                eng.lifecycle.record_batch_failure(exc)
                raise
            eng.lifecycle.record_batch_success()
            return results

    # -- replica replacement -----------------------------------------------
    def replace_replica(self, idx: int, reason: str = "manual") -> Dict[str, object]:
        """Boot a fresh engine into slot `idx` and retire the old one (the
        heal of a sticky-`failed` breaker): same device, a copy of the
        serving weights, warmed, validated through `swap_variables`, then in
        breaker probation, which real traffic ends. Returns {replica,
        reason, warm_seconds, memory_allocated_before,
        memory_allocated_after}: the device's allocated bytes before the
        boot and after the old engine is dropped."""
        rep = self.replicas[int(idx)]
        old_engine = rep.engine
        before = _allocated(rep.device)
        t0 = time.monotonic()
        lifecycle = self._new_lifecycle(rep.idx)
        # Observability follows the slot.
        lifecycle.on_transition = old_engine.lifecycle.on_transition
        state = {k: v.detach().to("cpu", copy=True) for k, v in self.variables.items()}
        engine = AnytimeEngine(self.config, self._model_on(rep.device, state), device=rep.device,
                               lifecycle=lifecycle, hygiene=self.hygiene, aot_cache=self.aot_cache)
        engine.tracer = old_engine.tracer
        engine.warm()
        engine.swap_variables(self.variables)
        lifecycle.enter_probation(f"respawn ({reason})")
        warm_seconds = time.monotonic() - t0
        with self._route_lock:
            rep.engine = engine
        self.lifecycle.replace_replica_lifecycle(rep.idx, lifecycle)
        old_engine.close()
        del old_engine, state
        gc.collect()
        summary = {
            "replica": rep.idx,
            "reason": reason,
            "warm_seconds": warm_seconds,
            "memory_allocated_before": before,
            "memory_allocated_after": _allocated(rep.device),
        }
        if self.metrics is not None:
            self.metrics.record_respawn()
        with self._route_lock:
            self.last_respawn = summary
            self.respawns_total += 1
            n_respawns = self.respawns_total
        logger.warning("fleet: respawned replica %d (%s) in %.2fs (respawn #%d), allocated %d -> %d bytes",
                       rep.idx, reason, warm_seconds, n_respawns, before, summary["memory_allocated_after"])
        tracer = self.tracer
        if tracer is not None:
            tracer.event("replica_respawn", **summary)
            tracer.dump("respawn")
        return summary

    def _maybe_respawn(self, rep: _Replica) -> None:
        """A background replacement boot for a sticky-`failed` replica
        (auto_respawn only; one per slot at a time)."""
        if not self.config.auto_respawn or rep.lifecycle.state != "failed":
            return
        with self._route_lock:
            if rep.respawning:
                return
            rep.respawning = True

        def _respawn() -> None:
            try:
                self.replace_replica(rep.idx, reason="auto: sticky-failed breaker")
            except Exception:  # noqa: BLE001 - a failed heal must not kill the runner
                logger.exception("fleet: auto-respawn of replica %d failed; the slot stays failed", rep.idx)
            finally:
                with self._route_lock:
                    rep.respawning = False

        self._spawn(_respawn, f"fleet-respawn-r{rep.idx}")

    # -- rolling hot-swap --------------------------------------------------
    def swap_variables(self, new_state) -> int:
        """Roll `new_state` (a state dict of the served architecture)
        across the fleet one replica at a time; a refusal anywhere rolls
        the already-swapped replicas back and re-raises. Returns the fleet
        generation, bumped only by a complete roll."""
        with self._swap_lock:
            swapped: List[Tuple[_Replica, Dict[str, torch.Tensor]]] = []
            for rep in self.replicas:
                old = {k: v.detach().clone() for k, v in rep.engine.model.state_dict().items()}
                try:
                    rep.engine.swap_variables(new_state)
                except Exception:
                    for done_rep, prev in reversed(swapped):
                        try:
                            done_rep.engine.swap_variables(prev)
                        except Exception:  # pragma: no cover - best effort
                            logger.exception("fleet: rollback failed on replica %d", done_rep.idx)
                    logger.warning("fleet: rolling swap aborted at replica %d; %d replica(s) rolled back",
                                   rep.idx, len(swapped))
                    raise
                swapped.append((rep, old))
            self.swap_generation += 1
            gen = self.swap_generation
        self.lifecycle.note_swap(gen)
        logger.info("fleet: rolling swap complete across %d replicas -> generation %d", len(self.replicas), gen)
        return gen


__all__ = ["EngineFleet", "FleetLifecycle", "ReplicaHungError"]
