"""Front-tier router: fleet-of-fleets HTTP routing across StereoService hosts.

The port's own copy of `raft_stereo_tpu/serving/frontier.py` (`Frontier`,
`_Backend`, `_Session`, `make_frontier_http_server`,
`serve_frontier_http`): the JAX module is torch- and jax-free, and the port
imports nothing of the JAX package. Its imports point at the port's
`config`, `obs.prom`, `obs.trace`, `serving.lifecycle` and `utils.http`,
none of which imports torch, so a `frontier` process boots in
milliseconds. A backend is a port `serve` process; its /healthz boot block
has no AOT cache (the port has none), which the frontier only records.

The fleet (serving/fleet.py) makes a *device* failure survivable inside
one process (replica failover, auto-respawn); this module makes a *host*
failure survivable across processes. The frontier is
a stdlib-only HTTP tier (`frontier` CLI subcommand, `FrontierConfig`) that
routes POST /predict across N backend `StereoService` hosts so losing a
host is a capacity event, not an outage. It holds no model and no device:
restarting the frontier loses only stream pinnings (those cold-start).

Four robustness pillars:

1. **Health-checked routing** — every backend gets its own
   `ServingLifecycle` breaker (the exact machine the backends themselves
   run): forwarding failures and failed /healthz probes count against it,
   routing only considers `admissible()` backends and prefers the fewest
   in-flight forwards (round-robin tiebreak). A sticky-`failed` backend is
   only re-admitted when an active probe succeeds — and then under
   *probation*, so real traffic has to earn it back to healthy.
2. **Retry + optional hedging** — plain /predict is idempotent, so a
   transport failure or backend 5xx retries on a *different* backend with
   `utils/retry.py`'s jittered exponential backoff, capped by a retry
   budget (`retry_budget_min + retry_budget_percent% × requests`) so a
   sick fleet can't melt itself with amplification. Deterministic 4xx
   (413 bucket overflow, 400 bad request) forward unchanged and never
   retry. Opt-in hedging duplicates a request onto a second backend after
   max(live queue-wait p95, hedge_floor_ms) and takes the first answer.
3. **Stream affinity with explicit migration** — stream requests pin to
   the backend holding their carry (session table keyed by stream_id).
   When that backend fails, the session migrates: the frontier bumps the
   session generation and forwards under an aliased stream id, which
   *guarantees* a cold restart on the new backend even if the old one
   comes back holding stale carry. The response records
   `migrated=True` / `warm_started=False` — carry state is per-host and is
   never pretended to survive (the service's poisoned-stream contract).
4. **Overload brownout** — when the worst backend queue-wait p95 crosses
   the configured threshold, forwarded requests get tightened deadlines /
   iteration caps so the anytime engines early-exit: quality degrades
   before anything is shed. Brownout engagements and sheds are distinct
   counters (the shed-vs-reject split, one tier up), with hysteresis on
   disengage.
5. **Checkpoint rollout orchestration** (`POST /rollout`, `frontier
   --rollout CKPT`) — the cross-host mirror of `EngineFleet`'s rolling
   replica swap. For each backend in turn: quiesce routing to it (its
   breaker drains; pinned streams migrate or hold per
   `rollout_stream_policy`), wait its in-flight forwards out, issue
   `/reload`, verify the swap via the /healthz `swap_generation` advance
   PLUS a canary predict compared bit-wise against the new-generation
   reference (the first swapped backend defines it), then hold it in
   breaker probation for `rollout_probation` successful probes. Swapped
   backends stay OUT of rotation until the last old-generation backend
   drains — the flip — so the response ledger never interleaves
   generations: every 2xx answer carries the backend's generation stamp
   and `mixed_generation_seconds` measures any overlap between old- and
   new-generation answers (zero on a clean roll, machine-checked).
   Any failure — reload 409/transport, canary divergence, probe timeout,
   probation trip — aborts the roll and rolls already-swapped backends
   BACK to their prior checkpoint (rollback canaries re-verify
   bit-identity with the pre-roll baseline), then `resume()` restores
   admission. An out-of-band reload that desyncs the fleet is flagged as
   `generation_divergence`, and /rollout refuses to start from a mixed
   fleet without `force`.

Observability matches the backends: flight-recorder spans/events
(route/forward/retry/hedge/migrate/brownout), `/metrics?format=prom` with
per-backend state codes, `/healthz` aggregating backend lifecycle + boot
blocks.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import random
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, FrozenSet, List, Optional, Tuple

from raft_stereo_tpu_torch.config import FrontierConfig
from raft_stereo_tpu_torch.obs.prom import PROM_CONTENT_TYPE, Registry
from raft_stereo_tpu_torch.obs.trace import Tracer
from raft_stereo_tpu_torch.serving.lifecycle import HEALTH_STATES, ServingLifecycle
from raft_stereo_tpu_torch.utils import http as _http

logger = logging.getLogger(__name__)

# Outcome tags of one forwarded attempt (see _single_attempt):
#   ok        2xx — answer the client, credit the backend breaker
#   client    deterministic 4xx — answer the client verbatim, never retry
#   retryable transport failure or backend 5xx — debit the breaker, retry
_OK, _CLIENT, _RETRYABLE = "ok", "client", "retryable"


def _percentile(sorted_vals: List[float], q: float) -> Optional[float]:
    """Linear-interpolation percentile (ServingMetrics semantics: None
    below two samples — a percentile of nothing is not 0.0)."""
    n = len(sorted_vals)
    if n < 2:
        return None
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class _Backend:
    """One routed host: address, breaker, in-flight gauge and the facts
    the health prober last observed (queue-wait p95 for brownout/hedging,
    the boot block for /healthz aggregation)."""

    def __init__(self, addr: str, config: FrontierConfig):
        self.name = addr
        self.base_url = f"http://{addr}"
        self.lifecycle = ServingLifecycle(
            degrade_after=config.breaker_degrade_after,
            fail_after=config.breaker_fail_after,
            probation=config.breaker_probation,
            name=addr,
        )
        self.lock = threading.Lock()
        self.in_flight = 0
        self.forwarded_total = 0
        self.failures_total = 0
        self.queue_wait_p95_ms = 0.0
        self.last_boot: Optional[Dict[str, object]] = None
        self.probes_ok = 0
        self.probes_failed = 0
        # Last observed weight facts (probes and forwarded responses both
        # refresh these): swap generation, served checkpoint path, shape
        # buckets. None until the first successful observation.
        self.swap_generation: Optional[int] = None
        self.checkpoint: Optional[str] = None
        self.buckets: Optional[List[List[int]]] = None


@dataclasses.dataclass
class _Session:
    """Stream pinning: which backend holds this stream's carry, plus the
    migration generation (bumped on every migration — the alias suffix
    that forces a cold restart on the new backend)."""

    backend: str
    generation: int
    frames: int


class Frontier:
    """The router. `start()` launches the health prober; `handle_predict`
    is the one request path (shared by the HTTP handler and in-process
    tests); `drain()` stops admission and waits out in-flight forwards.

    `sleep`/`rng` are injectable exactly like `utils/retry.retry_call`'s,
    so tests drive the backoff schedule deterministically without real
    waiting."""

    def __init__(
        self,
        config: FrontierConfig,
        *,
        sleep=time.sleep,
        rng: Optional[random.Random] = None,
    ):
        self.config = config
        self._sleep = sleep
        self._rng = rng or random
        self._backends: Dict[str, _Backend] = {}
        self._order: List[str] = []
        for addr in config.backends:
            b = _Backend(addr, config)
            b.lifecycle.on_transition = self._make_transition_hook(addr)
            self._backends[addr] = b
            self._order.append(addr)
        self._lock = threading.Lock()
        self._rr = 0  # round-robin tiebreak cursor
        self._draining = False
        self._in_flight = 0
        self._in_flight_cv = threading.Condition(self._lock)
        # Counters (guarded by _lock). requests/responses are the
        # exactly-once ledger: one client request, one client answer.
        self.requests_total = 0
        self.responses_total = 0
        self.errors_total = 0
        self.retries_total = 0
        self.hedges_total = 0
        self.hedge_wins_total = 0
        self.migrations_total = 0
        self.stream_requests_total = 0
        self.shed_total = 0
        self.brownout_engagements_total = 0
        self.brownout_requests_total = 0
        self._latencies_ms: collections.deque = collections.deque(maxlen=2048)
        # Brownout state (poller-evaluated, request-path-read).
        self._brownout_active = False
        self._agg_queue_p95_ms = 0.0
        # Stream-session table (LRU beyond max_sessions).
        self._sessions: "collections.OrderedDict[str, _Session]" = (
            collections.OrderedDict()
        )
        self._sessions_lock = threading.Lock()
        # Observability.
        dump_path = None
        if config.log_dir:
            import os

            os.makedirs(config.log_dir, exist_ok=True)
            dump_path = os.path.join(
                config.log_dir, "frontier_flight_recorder.json"
            )
        self.tracer = Tracer(
            capacity=config.flight_recorder_events, dump_path=dump_path
        )
        self.registry = Registry()
        self._stop = threading.Event()
        self._poller: Optional[threading.Thread] = None
        # Attempt/hedge worker handles (guarded by _lock): tracked so
        # close() can wait for stragglers instead of abandoning them —
        # the fleet `_spawn` shape. Pruned of dead threads on each spawn.
        self._attempt_threads: List[threading.Thread] = []
        # Per-backend probe schedule (addr -> next-due monotonic time),
        # phase-jittered at poller start so N frontiers (or one after a
        # restart) never align their probes on the same tick against a
        # recovering backend.
        self._probe_due: Dict[str, float] = {}
        # -- checkpoint rollout state ---------------------------------------
        # _rollout_mutex serializes whole rollouts (one roll at a time);
        # the record + counters below are guarded by _lock like every
        # other counter. _quiesced is the set of backends the orchestrator
        # took out of rotation (their breakers are draining) — distinct
        # from breaker verdicts so the stream "hold" policy can tell a
        # quiesced host (coming back) from a dead one (not).
        self._rollout_mutex = threading.Lock()
        self._quiesced: set = set()
        self.rollouts_total = 0
        self.rollout_aborts_total = 0
        self.rollout_rollbacks_total = 0
        self._rollout: Dict[str, object] = {
            "phase": "idle",
            "checkpoint": None,
            "abort_reason": None,
            "canary_changed": None,
            "backends": {},
        }
        # -- generation ledger ----------------------------------------------
        # Every 2xx answer carrying a backend generation stamp updates
        # this (under _lock): the span between the first newer-generation
        # answer and the last older-generation answer is the mixed-weight
        # window the rollout orchestration must keep at zero.
        self.generation_stamps_total = 0
        self.mixed_generation_seconds = 0.0
        self._ledger_max_gen: Optional[int] = None
        self._ledger_max_gen_ts = 0.0

    def _make_transition_hook(self, addr: str):
        def hook(frm: str, to: str, reason: str) -> None:
            # A backend breaker move is exactly the moment the last-N
            # routing window is worth keeping (service.py's discipline).
            self.tracer.event(
                "backend_transition", backend=addr, frm=frm, to=to, reason=reason
            )
            self.tracer.dump(f"frontier_breaker:{addr}:{frm}->{to}")

        return hook

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Frontier":
        self._poller = threading.Thread(
            target=self._poll_loop, name="frontier-health", daemon=True
        )
        self._poller.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._poller is not None:
            self._poller.join(timeout=5.0)
            self._poller = None
        with self._lock:
            stragglers = list(self._attempt_threads)
            self._attempt_threads = []
        for t in stragglers:
            t.join(timeout=1.0)
        self.tracer.dump("frontier_close")

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admitting (new requests shed 503), wait
        for in-flight forwards to finish, then stop the prober. Returns
        True when the backlog fully drained inside the budget."""
        if timeout_s is None:
            timeout_s = self.config.drain_timeout_s
        deadline = time.monotonic() + timeout_s
        with self._lock:
            self._draining = True
        self.tracer.event("frontier_drain_start")
        drained = True
        with self._in_flight_cv:
            while self._in_flight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    drained = False
                    break
                self._in_flight_cv.wait(timeout=min(remaining, 0.25))
        self.close()
        return drained

    def resume(self) -> None:
        """Reopen admission after `drain()` (or a rollout quiesce): clear
        the `_draining` latch — previously one-way, which stranded an
        aborted-rollout frontier answering 503 forever — lift every
        backend quiesce, and restart the health prober that `drain()`'s
        `close()` stopped. Backend breaker verdicts are untouched: a
        backend that earned `failed` is still failed."""
        with self._lock:
            self._draining = False
            self._quiesced.clear()
        for b in self._backend_list():
            b.lifecycle.stop_drain("frontier resume")
        if self._poller is None or not self._poller.is_alive():
            self._stop.clear()
            self.start()
        self.tracer.event("frontier_resume")

    def __enter__(self) -> "Frontier":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def state(self) -> str:
        return "draining" if self._draining else "healthy"

    # -- health probing + brownout ----------------------------------------
    def _fetch_serving(self, backend: _Backend) -> Dict[str, object]:
        """GET one backend's /healthz and fold the observed facts into its
        record (queue-wait p95, boot block, swap generation, checkpoint,
        buckets). Raises on any transport/decode failure — the caller
        decides whether that debits the breaker (the poller) or aborts an
        orchestration step (the rollout)."""
        resp = _http.request(
            backend.base_url + "/healthz",
            timeout_s=self.config.health_timeout_s,
        )
        if not resp.ok:
            raise ConnectionError(f"healthz status {resp.status}")
        payload = resp.json()
        serving = payload.get("serving", {}) if isinstance(payload, dict) else {}
        attribution = serving.get("attribution", {})
        qw = attribution.get("queue_wait_ms", {})
        gen = serving.get("swap_generation")
        with backend.lock:
            backend.queue_wait_p95_ms = float(qw.get("p95", 0.0) or 0.0)
            boot = serving.get("boot")
            if boot is not None:
                backend.last_boot = boot
            if isinstance(gen, int) and not isinstance(gen, bool):
                backend.swap_generation = gen
            if serving.get("checkpoint") is not None:
                backend.checkpoint = str(serving["checkpoint"])
            if serving.get("buckets"):
                backend.buckets = serving["buckets"]
        return serving

    def _probe_one(self, backend: _Backend) -> None:
        try:
            self._fetch_serving(backend)
        except Exception as exc:  # noqa: BLE001 - every probe failure counts
            with backend.lock:
                backend.probes_failed += 1
            backend.lifecycle.record_batch_failure(exc)
            return
        with backend.lock:
            backend.probes_ok += 1
        # A live probe is the ONLY signal that re-admits a sticky-failed
        # backend — and only into probation: real traffic earns
        # the walk back to healthy. Probe successes deliberately do NOT
        # credit the breaker of a healthy/degraded backend (a backend
        # whose /healthz works but whose /predict 500s must still trip).
        if backend.lifecycle.state == "failed":
            backend.lifecycle.enter_probation("health probe recovered")

    def _poll_loop(self) -> None:
        """Probe scheduler with per-backend phase jitter: each backend's
        probe clock starts at a random offset inside one interval, so N
        frontiers (or one frontier after a restart) spread their probes
        across the interval instead of aligning on the same tick — a
        recovering backend sees a trickle, not a thundering herd."""
        interval = self.config.health_interval_s
        now = time.monotonic()
        self._probe_due = {
            addr: now + self._rng.uniform(0.0, interval)
            for addr in self._order
        }
        while not self._stop.is_set():
            now = time.monotonic()
            for addr in self._order:
                if self._stop.is_set():
                    return
                if now >= self._probe_due.get(addr, now):
                    self._probe_one(self._backends[addr])
                    self._probe_due[addr] = time.monotonic() + interval
            agg = 0.0
            for backend in self._backend_list():
                if backend.lifecycle.admissible():
                    agg = max(agg, backend.queue_wait_p95_ms)
            self._evaluate_brownout(agg)
            next_due = min(self._probe_due.values(), default=now + interval)
            self._stop.wait(
                min(max(next_due - time.monotonic(), 0.005), interval)
            )

    def _evaluate_brownout(self, agg_queue_p95_ms: float) -> None:
        """Engage above the threshold, disengage below threshold ×
        recover_ratio (hysteresis — flapping at the boundary would make
        response quality oscillate per scrape)."""
        self._agg_queue_p95_ms = float(agg_queue_p95_ms)
        threshold = self.config.brownout_queue_p95_ms
        if threshold <= 0:
            return
        if not self._brownout_active and agg_queue_p95_ms > threshold:
            with self._lock:
                self._brownout_active = True
                self.brownout_engagements_total += 1
            self.tracer.event(
                "brownout_engage", queue_p95_ms=agg_queue_p95_ms
            )
            logger.warning(
                "brownout ENGAGED: queue-wait p95 %.1f ms > %.1f ms",
                agg_queue_p95_ms,
                threshold,
            )
        elif (
            self._brownout_active
            and agg_queue_p95_ms < threshold * self.config.brownout_recover_ratio
        ):
            with self._lock:
                self._brownout_active = False
            self.tracer.event(
                "brownout_disengage", queue_p95_ms=agg_queue_p95_ms
            )
            logger.info(
                "brownout disengaged: queue-wait p95 %.1f ms", agg_queue_p95_ms
            )

    # -- routing -----------------------------------------------------------
    def _backend_list(self) -> List[_Backend]:
        return [self._backends[a] for a in self._order]

    def _pick_backend(
        self, exclude: FrozenSet[str] = frozenset()
    ) -> Optional[_Backend]:
        """Least-in-flight admissible backend not in `exclude`; ties break
        round-robin so equal-load backends share work instead of the
        config-order head taking everything."""
        with self._lock:
            rr = self._rr
            self._rr += 1
        candidates = [
            b
            for b in self._backend_list()
            if b.name not in exclude and b.lifecycle.admissible()
        ]
        if not candidates:
            return None
        n = len(candidates)
        return min(
            (candidates[(rr + i) % n] for i in range(n)),
            key=lambda b: b.in_flight,
        )

    def _retry_budget_ok(self) -> bool:
        with self._lock:
            cap = self.config.retry_budget_min + (
                self.config.retry_budget_percent / 100.0
            ) * self.requests_total
            return self.retries_total < cap

    def _backoff(self, attempt_idx: int) -> None:
        cfg = self.config
        delay = min(
            cfg.retry_max_delay_s, cfg.retry_base_delay_s * (2.0**attempt_idx)
        )
        delay *= 1.0 + cfg.retry_jitter * self._rng.uniform(-1.0, 1.0)
        self._sleep(max(0.0, delay))

    # -- generation ledger -------------------------------------------------
    def _stamp_generation_locked(self, gen) -> None:
        """Fold one answered response's generation stamp into the mixed-
        window proof (caller holds _lock). The mixed window is the span
        between the FIRST answer from the newest generation and the LAST
        answer from any older one: zero exactly when no old-generation
        answer completed after a new-generation answer did — the property
        the rollout flip is built to preserve. Backends count their own
        swaps, so stamps compare across hosts only while the orchestrator
        keeps the counters in lockstep; an out-of-band reload desyncs
        them, which is precisely what this ledger must expose."""
        if not isinstance(gen, int) or isinstance(gen, bool):
            return
        now = time.monotonic()
        self.generation_stamps_total += 1
        if self._ledger_max_gen is None or gen > self._ledger_max_gen:
            self._ledger_max_gen = gen
            self._ledger_max_gen_ts = now
        elif gen < self._ledger_max_gen:
            self.mixed_generation_seconds = max(
                self.mixed_generation_seconds,
                now - self._ledger_max_gen_ts,
            )

    def _known_generations(self) -> List[int]:
        out = []
        for b in self._backend_list():
            with b.lock:
                if b.swap_generation is not None:
                    out.append(b.swap_generation)
        return out

    def generation_divergence(self) -> bool:
        """True while the backends' last-observed swap generations
        disagree — either mid-rollout (transient, intentional, and the
        divergent backends are quiesced) or after an out-of-band reload
        (the mixed fleet /rollout refuses to extend without force)."""
        return len(set(self._known_generations())) > 1

    # -- forwarding --------------------------------------------------------
    def _single_attempt(
        self, backend: _Backend, body: Dict[str, object], trace_id
    ) -> Tuple[str, int, Dict[str, object]]:
        t0 = time.monotonic()
        with backend.lock:
            backend.in_flight += 1
        try:
            resp = _http.request_json(
                backend.base_url + "/v1/predict",
                method="POST",
                payload=body,
                timeout_s=self.config.request_timeout_s,
            )
        except (ConnectionError, TimeoutError, OSError) as exc:
            backend.lifecycle.record_batch_failure(exc)
            with backend.lock:
                backend.in_flight -= 1
                backend.failures_total += 1
            return (
                _RETRYABLE,
                502,
                {"error": repr(exc), "backend": backend.name},
            )
        try:
            payload = resp.json()
            if not isinstance(payload, dict):
                raise ValueError("non-object response body")
        except Exception as exc:  # noqa: BLE001 - half-written reply
            backend.lifecycle.record_batch_failure(exc)
            with backend.lock:
                backend.in_flight -= 1
                backend.failures_total += 1
            return (
                _RETRYABLE,
                502,
                {"error": f"undecodable backend reply: {exc!r}",
                 "backend": backend.name},
            )
        if resp.status >= 500:
            backend.lifecycle.record_batch_failure(
                RuntimeError(f"backend {backend.name} status {resp.status}")
            )
            with backend.lock:
                backend.in_flight -= 1
                backend.failures_total += 1
            return (_RETRYABLE, resp.status, payload)
        if resp.ok:
            backend.lifecycle.record_batch_success()
            gen = payload.get("swap_generation")
            # Ledger stamp BEFORE the in-flight decrement: the rollout
            # flip waits for a quiesced backend's in_flight to reach zero,
            # and that wait must imply "every answer it produced is
            # already in the ledger" — stamping after the decrement would
            # let an old-generation stamp land post-flip and smear the
            # provably-zero mixed window.
            with self._lock:
                self._stamp_generation_locked(gen)
            with backend.lock:
                backend.in_flight -= 1
                backend.forwarded_total += 1
                # Responses carry the backend's generation stamp — fresher
                # than the probe cadence, so fold it in here too.
                if isinstance(gen, int) and not isinstance(gen, bool):
                    backend.swap_generation = gen
            payload["backend"] = backend.name
            if self.tracer.enabled:
                self.tracer.span(
                    "forward",
                    trace=trace_id,
                    t0=t0,
                    t1=time.monotonic(),
                    backend=backend.name,
                    status=resp.status,
                )
            return (_OK, resp.status, payload)
        # Deterministic 4xx (413 overflow, 400 bad request, 409 mismatch):
        # the request, not the backend, is at fault — forward verbatim,
        # never retry, never debit the breaker.
        with backend.lock:
            backend.in_flight -= 1
        return (_CLIENT, resp.status, payload)

    def _spawn_attempt(self, run, backend: _Backend) -> threading.Thread:
        """Start an attempt/hedge worker with its handle TRACKED (the
        fleet's `_spawn` shape): close() joins stragglers instead of
        abandoning them, so a loser hedge's failure is observable in
        teardown rather than silently dying mid-request. Daemon, because a
        worker stuck in a dead backend's socket timeout must not pin
        process exit past close()'s bounded join."""
        t = threading.Thread(
            target=run, args=(backend,), name="frontier-attempt", daemon=True
        )
        with self._lock:
            self._attempt_threads = [
                x for x in self._attempt_threads if x.is_alive()
            ]
            self._attempt_threads.append(t)
        t.start()
        return t

    def _hedged_attempt(
        self, primary: _Backend, body: Dict[str, object], trace_id
    ) -> Tuple[str, int, Dict[str, object]]:
        """Dispatch to `primary`; after max(live queue-wait p95,
        hedge_floor_ms) with no answer, duplicate onto a different backend
        and take the first success. The loser's reply is discarded — the
        client still sees exactly one answer."""
        import queue as _q

        results: "_q.Queue" = _q.Queue()

        def run(b: _Backend) -> None:
            results.put(self._single_attempt(b, body, trace_id))

        self._spawn_attempt(run, primary)
        delay_ms = max(self._agg_queue_p95_ms, self.config.hedge_floor_ms)
        try:
            first = results.get(timeout=delay_ms / 1e3)
        except _q.Empty:
            first = None
        if first is not None:
            return first
        hedge = self._pick_backend(exclude=frozenset({primary.name}))
        if hedge is None:
            return results.get()
        with self._lock:
            self.hedges_total += 1
        self.tracer.event("hedge", primary=primary.name, hedge=hedge.name)
        self._spawn_attempt(run, hedge)
        outcomes = [results.get()]
        if outcomes[0][0] != _OK:
            outcomes.append(results.get())
        best = next((o for o in outcomes if o[0] == _OK), outcomes[0])
        if best[0] == _OK and best[2].get("backend") == hedge.name:
            with self._lock:
                self.hedge_wins_total += 1
        return best

    # -- request path ------------------------------------------------------
    def handle_predict(
        self, body: Dict[str, object]
    ) -> Tuple[int, Dict[str, object]]:
        """The one routing entry point (HTTP handler and tests both call
        it): returns (status_code, payload). Exactly one response per
        request, whatever happens underneath."""
        t0 = time.monotonic()
        with self._lock:
            if self._draining:
                self.shed_total += 1
                return (
                    503,
                    {"error": "frontier draining", "state": "draining"},
                )
            self.requests_total += 1
            self._in_flight += 1
        tid = self.tracer.start_trace() if self.tracer.enabled else None
        try:
            body = dict(body)
            browned = False
            if self._brownout_active:
                browned = True
                with self._lock:
                    self.brownout_requests_total += 1
                cfg = self.config
                if cfg.brownout_deadline_ms > 0:
                    cur = body.get("deadline_ms")
                    body["deadline_ms"] = (
                        cfg.brownout_deadline_ms
                        if cur is None
                        else min(float(cur), cfg.brownout_deadline_ms)
                    )
                if cfg.brownout_max_iters > 0:
                    cur = body.get("max_iters")
                    body["max_iters"] = (
                        cfg.brownout_max_iters
                        if cur is None
                        else min(int(cur), cfg.brownout_max_iters)
                    )
            if body.get("stream_id") is not None:
                status, payload = self._handle_stream(body, tid)
            else:
                status, payload = self._handle_plain(body, tid)
            if browned and isinstance(payload, dict):
                payload["brownout"] = True
            if 200 <= status < 300:
                with self._lock:
                    self.responses_total += 1
                    self._latencies_ms.append((time.monotonic() - t0) * 1e3)
            elif 400 <= status < 500:
                # Deterministic client error answered by a live backend —
                # part of the answered ledger, not a frontier error.
                with self._lock:
                    self.responses_total += 1
            if self.tracer.enabled:
                self.tracer.span(
                    "frontier_request",
                    trace=tid,
                    t0=t0,
                    t1=time.monotonic(),
                    status=status,
                    stream=body.get("stream_id") is not None,
                    brownout=browned,
                )
            return status, payload
        except Exception as exc:  # noqa: BLE001 - router must always answer
            logger.exception("frontier routing failed")
            with self._lock:
                self.errors_total += 1
            return 500, {"error": repr(exc)}
        finally:
            with self._in_flight_cv:
                self._in_flight -= 1
                self._in_flight_cv.notify_all()

    def _handle_plain(
        self, body: Dict[str, object], trace_id
    ) -> Tuple[int, Dict[str, object]]:
        exclude: set = set()
        last: Tuple[int, Dict[str, object]] = (
            502,
            {"error": "no attempt made"},
        )
        for attempt in range(self.config.retry_attempts):
            if attempt > 0:
                if not self._retry_budget_ok():
                    self.tracer.event("retry_budget_exhausted")
                    break
                with self._lock:
                    self.retries_total += 1
                self.tracer.event(
                    "retry", attempt=attempt, excluded=sorted(exclude)
                )
                self._backoff(attempt - 1)
            backend = self._pick_backend(frozenset(exclude))
            if backend is None and exclude:
                # Every OTHER backend is inadmissible: retrying the one
                # that just failed (it may be degraded, not failed) beats
                # shedding a request we could still answer.
                backend = self._pick_backend()
            if backend is None:
                # Rollout flip window: capacity is coming right back —
                # park instead of shedding (zero lost requests is a roll
                # invariant, not a best effort).
                backend = self._hold_for_rollout(frozenset(exclude))
            if backend is None:
                with self._lock:
                    self.shed_total += 1
                return (
                    503,
                    {"error": "no admissible backend", "state": self.state},
                )
            hedge_ok = (
                attempt == 0
                and self.config.hedge
                and body.get("stream_id") is None
            )
            if hedge_ok:
                outcome, status, payload = self._hedged_attempt(
                    backend, body, trace_id
                )
            else:
                outcome, status, payload = self._single_attempt(
                    backend, body, trace_id
                )
            if outcome in (_OK, _CLIENT):
                return status, payload
            exclude.add(backend.name)
            last = (status, payload)
        with self._lock:
            self.errors_total += 1
        return (
            502,
            {
                "error": "retries exhausted",
                "last_status": last[0],
                "last_error": last[1].get("error"),
            },
        )

    def _stream_alias(self, stream_id: str, generation: int) -> str:
        # Generation 0 keeps the raw id (bit-compatible with talking to the
        # backend directly); every migration bumps the alias, which the
        # new backend has never seen — a guaranteed cold restart even if
        # the old backend resurfaces still holding stale carry.
        return stream_id if generation == 0 else f"{stream_id}@g{generation}"

    def _handle_stream(
        self, body: Dict[str, object], trace_id
    ) -> Tuple[int, Dict[str, object]]:
        sid = str(body["stream_id"])
        with self._lock:
            self.stream_requests_total += 1
        with self._sessions_lock:
            sess = self._sessions.get(sid)
            if sess is not None:
                self._sessions.move_to_end(sid)
        pinned = sess.backend if sess is not None else None
        # The session's original host: migration is "this frame left home",
        # whether routing noticed via the breaker (pinned inadmissible) or
        # via a failed forward (un-pinned mid-request).
        home = pinned
        generation = sess.generation if sess is not None else 0
        frames = sess.frames if sess is not None else 0
        migrated = False
        exclude: set = set()
        last: Tuple[int, Dict[str, object]] = (
            502,
            {"error": "no attempt made"},
        )
        for attempt in range(self.config.retry_attempts):
            if attempt > 0:
                if not self._retry_budget_ok():
                    break
                if not migrated:
                    with self._lock:
                        self.retries_total += 1
                self._backoff(attempt - 1)
            backend = None
            if pinned is not None and pinned not in exclude:
                candidate = self._backends.get(pinned)
                if (
                    candidate is not None
                    and not candidate.lifecycle.admissible()
                    and self.config.rollout_stream_policy == "hold"
                    and self._is_quiesced(pinned)
                ):
                    # "hold" stream policy: the pinned host is only out
                    # for its reload, and the carry lives there — park
                    # until it swaps back into rotation instead of
                    # migrating to a cold restart. A timeout falls
                    # through to the migration path (availability beats
                    # affinity once the wait stops being brief).
                    self._wait_unquiesced(
                        pinned, self.config.rollout_hold_timeout_s
                    )
                if candidate is not None and candidate.lifecycle.admissible():
                    backend = candidate
            if backend is None:
                backend = self._pick_backend(frozenset(exclude))
                if backend is None and exclude:
                    backend = self._pick_backend()
                if backend is None:
                    backend = self._hold_for_rollout(frozenset(exclude))
                if backend is None:
                    with self._lock:
                        self.shed_total += 1
                    return (
                        503,
                        {
                            "error": "no admissible backend",
                            "state": self.state,
                        },
                    )
                if home is not None and backend.name != home and not migrated:
                    # Migration: the pinned backend is gone (breaker) or
                    # just failed this forward. The carry lives (lived) on
                    # that host — bump the generation so the new backend
                    # cold-starts instead of warm-starting from nothing.
                    migrated = True
                    generation += 1
                    with self._lock:
                        self.migrations_total += 1
                    self.tracer.event(
                        "stream_migrate",
                        stream_id=sid,
                        frm=home,
                        to=backend.name,
                        generation=generation,
                    )
                    pinned = backend.name
            fwd = dict(body)
            fwd["stream_id"] = self._stream_alias(sid, generation)
            outcome, status, payload = self._single_attempt(
                backend, fwd, trace_id
            )
            if outcome == _OK:
                payload["stream_id"] = sid
                payload["migrated"] = migrated
                with self._sessions_lock:
                    self._sessions[sid] = _Session(
                        backend=backend.name,
                        generation=generation,
                        frames=int(payload.get("stream_frame", frames)) + 1,
                    )
                    self._sessions.move_to_end(sid)
                    while len(self._sessions) > self.config.max_sessions:
                        # LRU eviction: the evicted stream's next frame
                        # routes fresh and cold-starts wherever it lands.
                        self._sessions.popitem(last=False)
                return status, payload
            if outcome == _CLIENT:
                return status, payload
            exclude.add(backend.name)
            if backend.name == pinned:
                # The pinned host failed the forward: un-pin so the next
                # loop iteration migrates to a different backend.
                pinned = None
            last = (status, payload)
        with self._lock:
            self.errors_total += 1
        return (
            502,
            {
                "error": "stream retries exhausted",
                "stream_id": sid,
                "last_status": last[0],
                "last_error": last[1].get("error"),
            },
        )

    # -- checkpoint rollout orchestration ----------------------------------
    #
    # The cross-host mirror of EngineFleet.swap_variables' rolling swap.
    # Sequencing invariant: a swapped backend stays quiesced (out of
    # rotation) until the LAST old-generation backend has drained — the
    # flip — so client answers never interleave generations. The window
    # between "last old backend drained" and "new-generation backends
    # readmitted" is bridged by _hold_for_rollout (requests park instead
    # of shedding), which is also what keeps the zero-lost-requests
    # invariant through the flip.

    ROLLOUT_PHASES = (
        "idle",
        "quiesce",
        "reload",
        "verify",
        "probation",
        "flip",
        "completed",
        "aborting",
        "aborted",
        "rolled_back",
    )

    def rollout_active(self) -> bool:
        with self._lock:
            return self._rollout["phase"] in (
                "quiesce", "reload", "verify", "probation", "flip", "aborting"
            )

    def _rollout_set(self, **kw) -> None:
        with self._lock:
            self._rollout.update(kw)

    def _rollout_backend(self, addr: str, **kw) -> None:
        with self._lock:
            self._rollout["backends"].setdefault(addr, {}).update(kw)

    def _is_quiesced(self, addr: str) -> bool:
        with self._lock:
            return addr in self._quiesced

    def _quiesce(self, backend: _Backend) -> None:
        """Take one backend out of rotation for its reload: its frontier-
        side breaker drains (the exact admission gate routing already
        checks), and the address joins _quiesced so the stream "hold"
        policy can tell an absent-but-returning host from a dead one."""
        with self._lock:
            self._quiesced.add(backend.name)
        backend.lifecycle.start_drain()
        self.tracer.event("rollout_quiesce", backend=backend.name)

    def _unquiesce(self, backend: _Backend) -> None:
        with self._lock:
            self._quiesced.discard(backend.name)
        backend.lifecycle.stop_drain("rollout readmit")

    def _wait_unquiesced(self, addr: str, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        while self._is_quiesced(addr):
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.005)
        return True

    def _hold_for_rollout(
        self, exclude: FrozenSet[str] = frozenset()
    ) -> Optional[_Backend]:
        """Park a request through the rollout flip window instead of
        shedding it: between quiescing the last old-generation backend
        and readmitting the swapped ones there is (deliberately) no
        admissible backend, but capacity is seconds away. Returns the
        first backend that becomes admissible, or None once the rollout
        ends or the hold budget expires (the caller sheds then)."""
        if not self.rollout_active():
            return None
        deadline = time.monotonic() + self.config.rollout_hold_timeout_s
        while time.monotonic() < deadline:
            backend = self._pick_backend(exclude) or self._pick_backend()
            if backend is not None:
                return backend
            if not self.rollout_active():
                return self._pick_backend(exclude) or self._pick_backend()
            time.sleep(0.005)
        return None

    def _wait_backend_drain(
        self, backend: _Backend, timeout_s: float, settle_s: float = 0.05
    ) -> bool:
        """Wait for a quiesced backend's in-flight forwards to reach zero
        and STAY zero for `settle_s`: a racing request that picked this
        backend just before the quiesce may not have incremented the
        gauge yet, and the flip's ledger proof needs every old-generation
        answer stamped before new-generation traffic starts."""
        deadline = time.monotonic() + timeout_s
        zero_since = None
        while time.monotonic() < deadline:
            with backend.lock:
                busy = backend.in_flight > 0
            now = time.monotonic()
            if busy:
                zero_since = None
            elif zero_since is None:
                zero_since = now
            elif now - zero_since >= settle_s:
                return True
            time.sleep(0.005)
        return False

    def _canary_body(self) -> Dict[str, object]:
        """A deterministic stereo pair every backend must answer BIT-
        identically within one weight generation (same input, same
        weights, same warmed executables). Sized to the smallest probed
        bucket, capped at 64x96 — the service pads up, and a small pair
        keeps the canary cheap on production bucket sizes. Seeded
        stdlib RNG: the frontier holds no numpy and no model."""
        bucket = None
        for b in self._backend_list():
            with b.lock:
                if b.buckets:
                    bucket = min(
                        b.buckets, key=lambda s: int(s[0]) * int(s[1])
                    )
                    break
        h = min(int(bucket[0]), 64) if bucket else 64
        w = min(int(bucket[1]), 96) if bucket else 96
        rng = random.Random(0xC0FFEE)

        def img():
            return [
                [[float(rng.randrange(256)) for _ in range(3)] for _ in range(w)]
                for _ in range(h)
            ]

        return {"image1": img(), "image2": img()}

    def _canary(self, backend: _Backend, body: Dict[str, object]) -> object:
        """One direct canary predict (NOT via routing, NOT in the client
        ledger) returning the disparity for bit-wise comparison — JSON
        float round-trip is exact, so list equality is bit-identity."""
        resp = _http.request_json(
            backend.base_url + "/v1/predict",
            method="POST",
            payload=body,
            timeout_s=self.config.request_timeout_s,
        )
        if not resp.ok:
            raise ConnectionError(
                f"canary predict on {backend.name} answered {resp.status}"
            )
        payload = resp.json()
        if not isinstance(payload, dict) or payload.get("disparity") is None:
            raise ValueError(f"canary reply from {backend.name} has no disparity")
        return payload["disparity"]

    def _await_generation(
        self, backend: _Backend, want: int, timeout_s: float
    ) -> bool:
        """Poll the backend's /healthz until it reports swap_generation >=
        want (the reload response already claimed it; this verifies the
        advance is visible on the health surface every operator tool
        reads)."""
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                serving = self._fetch_serving(backend)
                gen = serving.get("swap_generation")
                if (
                    isinstance(gen, int)
                    and not isinstance(gen, bool)
                    and gen >= want
                ):
                    return True
            except Exception:  # noqa: BLE001 - keep polling until deadline
                pass
            if time.monotonic() >= deadline:
                return False
            time.sleep(self.config.rollout_probe_interval_s)

    def _probation_probes(self, backend: _Backend, want: int) -> bool:
        """`rollout_probation` consecutive successful probes on the NEW
        generation before the roll proceeds; any failed probe or a
        generation/state regression is a probation trip (abort)."""
        for _ in range(self.config.rollout_probation):
            try:
                serving = self._fetch_serving(backend)
            except Exception:  # noqa: BLE001 - a failed probe IS the trip
                return False
            if serving.get("swap_generation") != want:
                return False
            if serving.get("state") == "failed":
                return False
            time.sleep(self.config.rollout_probe_interval_s)
        return True

    def run_rollout(
        self,
        checkpoint: str,
        *,
        rollback_checkpoint: Optional[str] = None,
        force: bool = False,
    ) -> Tuple[int, Dict[str, object]]:
        """Roll every backend onto `checkpoint`, one at a time, with the
        full verify/probation walk; abort + roll back on any failure.
        Returns (status, record): 200 completed, 409 refused to start
        (already rolling, or mixed generations without force), 502
        aborted (record says whether the fleet was rolled back).
        `rollback_checkpoint` is the abort target for backends that never
        reported a prior checkpoint path (e.g. booted from in-memory
        weights)."""
        if not self._rollout_mutex.acquire(blocking=False):
            with self._lock:
                phase = self._rollout["phase"]
            return 409, {"error": "rollout already in progress", "phase": phase}
        try:
            return self._run_rollout(
                str(checkpoint), rollback_checkpoint, bool(force)
            )
        finally:
            self._rollout_mutex.release()

    def _run_rollout(
        self,
        checkpoint: str,
        rollback_checkpoint: Optional[str],
        force: bool,
    ) -> Tuple[int, Dict[str, object]]:
        if self.generation_divergence() and not force:
            gens = {
                b.name: b.swap_generation for b in self._backend_list()
            }
            self.tracer.event("rollout_refused", reason="mixed generations")
            return 409, {
                "error": "backend swap generations diverge (out-of-band "
                "reload?) — refusing to extend a mixed fleet; pass "
                "force=true to roll anyway",
                "generations": gens,
            }
        with self._lock:
            self.rollouts_total += 1
            self._rollout = {
                "phase": "quiesce",
                "checkpoint": checkpoint,
                "rollback_checkpoint": rollback_checkpoint,
                "abort_reason": None,
                "canary_changed": None,
                "backends": {
                    addr: {
                        "status": "pending",
                        "generation": self._backends[addr].swap_generation,
                    }
                    for addr in self._order
                },
            }
        self.tracer.event(
            "rollout_start", checkpoint=checkpoint, backends=len(self._order)
        )
        reference = self._pick_backend()
        if reference is None:
            return self._abort_rollout(
                "no admissible backend for the baseline canary", [], None, None
            )
        canary_body = self._canary_body()
        try:
            baseline = self._canary(reference, canary_body)
        except Exception as exc:  # noqa: BLE001 - abort carries the reason
            return self._abort_rollout(
                f"baseline canary failed on {reference.name}: {exc!r}",
                [], canary_body, None,
            )
        new_reference = None
        swapped: List[Tuple[_Backend, Optional[str]]] = []
        for i, addr in enumerate(self._order):
            backend = self._backends[addr]
            last = i == len(self._order) - 1
            self._rollout_set(phase="quiesce")
            self._rollout_backend(addr, status="quiesced")
            self._quiesce(backend)
            drained = self._wait_backend_drain(
                backend, self.config.rollout_drain_timeout_s
            )
            if last:
                # The flip: every old-generation answer is in the ledger
                # (all other backends quiesced earlier and this one just
                # drained) — readmit the swapped, verified backends so
                # parked requests proceed on the new generation.
                self._rollout_set(phase="flip")
                for b, _ in swapped:
                    self._unquiesce(b)
                self.tracer.event(
                    "rollout_flip",
                    readmitted=[b.name for b, _ in swapped],
                )
            if not drained:
                return self._abort_rollout(
                    f"backend {addr} did not drain its in-flight forwards "
                    f"inside {self.config.rollout_drain_timeout_s}s",
                    swapped, canary_body, baseline,
                )
            self._rollout_set(phase="reload")
            self._rollout_backend(addr, status="reloading")
            try:
                resp = _http.request_json(
                    backend.base_url + "/reload",
                    method="POST",
                    payload={"checkpoint": checkpoint},
                    timeout_s=self.config.request_timeout_s,
                )
            except (ConnectionError, TimeoutError, OSError) as exc:
                return self._abort_rollout(
                    f"reload transport failure on {addr}: {exc!r}",
                    swapped, canary_body, baseline,
                )
            try:
                reload_payload = resp.json()
                if not isinstance(reload_payload, dict):
                    raise ValueError("non-object reload reply")
            except Exception as exc:  # noqa: BLE001 - half-written reply
                return self._abort_rollout(
                    f"undecodable reload reply from {addr}: {exc!r}",
                    swapped, canary_body, baseline,
                )
            if resp.status == 409:
                return self._abort_rollout(
                    f"checkpoint mismatch on {addr}: "
                    f"{reload_payload.get('error')}",
                    swapped, canary_body, baseline,
                )
            if not resp.ok:
                return self._abort_rollout(
                    f"reload on {addr} answered {resp.status}: "
                    f"{reload_payload.get('error')}",
                    swapped, canary_body, baseline,
                )
            new_gen = reload_payload.get("swap_generation")
            prev_ckpt = (
                reload_payload.get("previous_checkpoint")
                or rollback_checkpoint
            )
            self.tracer.event(
                "rollout_reload", backend=addr, generation=new_gen
            )
            # From here the backend HAS swapped: any abort must include
            # it in the rollback set.
            swapped_now = swapped + [(backend, prev_ckpt)]
            self._rollout_set(phase="verify")
            self._rollout_backend(
                addr,
                status="verifying",
                generation=new_gen if isinstance(new_gen, int) else None,
                previous_checkpoint=prev_ckpt,
            )
            if not isinstance(new_gen, int) or isinstance(new_gen, bool):
                return self._abort_rollout(
                    f"reload reply from {addr} carries no usable "
                    f"swap_generation: {new_gen!r}",
                    swapped_now, canary_body, baseline,
                )
            if not self._await_generation(
                backend, new_gen, self.config.rollout_verify_timeout_s
            ):
                return self._abort_rollout(
                    f"backend {addr} never reported generation {new_gen} "
                    f"on /healthz inside "
                    f"{self.config.rollout_verify_timeout_s}s",
                    swapped_now, canary_body, baseline,
                )
            try:
                disp = self._canary(backend, canary_body)
            except Exception as exc:  # noqa: BLE001 - abort carries it
                return self._abort_rollout(
                    f"post-swap canary failed on {addr}: {exc!r}",
                    swapped_now, canary_body, baseline,
                )
            if new_reference is None:
                # The first swapped backend DEFINES the new-generation
                # reference; every later backend must match it bit-wise.
                new_reference = disp
                changed = disp != baseline
                self._rollout_set(canary_changed=changed)
                self.tracer.event(
                    "rollout_canary", backend=addr, reference=True,
                    changed=changed,
                )
            elif disp != new_reference:
                return self._abort_rollout(
                    f"canary divergence on {addr}: disparity differs "
                    "bit-wise from the new-generation reference",
                    swapped_now, canary_body, baseline,
                )
            else:
                self.tracer.event(
                    "rollout_canary", backend=addr, reference=False,
                    matched=True,
                )
            self._rollout_set(phase="probation")
            self._rollout_backend(addr, status="probation")
            backend.lifecycle.enter_probation(
                f"rollout swap to generation {new_gen}"
            )
            if not self._probation_probes(backend, new_gen):
                return self._abort_rollout(
                    f"probation tripped on {addr} (failed probe or "
                    "generation regression)",
                    swapped_now, canary_body, baseline,
                )
            swapped = swapped_now
            self._rollout_backend(addr, status="done", generation=new_gen)
            self.tracer.event(
                "rollout_backend_done", backend=addr, generation=new_gen
            )
            if last:
                self._unquiesce(backend)
        self._rollout_set(phase="completed")
        self.tracer.event(
            "rollout_complete", checkpoint=checkpoint,
            backends=len(self._order),
        )
        self.tracer.dump("rollout_complete")
        with self._lock:
            record = dict(self._rollout)
        record["rollout"] = self.rollout_block()
        return 200, record

    def _abort_rollout(
        self,
        reason: str,
        swapped: List[Tuple[_Backend, Optional[str]]],
        canary_body: Optional[Dict[str, object]],
        baseline,
    ) -> Tuple[int, Dict[str, object]]:
        """Abort the roll: reload every already-swapped backend BACK to
        its prior checkpoint (reverse order, EngineFleet's discipline one
        tier up), re-verify each rollback canary bit-identical to the
        pre-roll baseline, then `resume()` — quiesces lifted, drain latch
        cleared — so the surviving fleet keeps serving on one
        generation."""
        logger.error("rollout ABORT: %s", reason)
        with self._lock:
            self.rollout_aborts_total += 1
        self._rollout_set(phase="aborting", abort_reason=reason)
        self.tracer.event(
            "rollout_abort",
            reason=reason,
            swapped=[b.name for b, _ in swapped],
        )
        rolled_all = True
        for backend, prev_ckpt in reversed(swapped):
            if prev_ckpt is None:
                rolled_all = False
                self._rollout_backend(backend.name, status="rollback_failed")
                self.tracer.event(
                    "rollout_rollback", backend=backend.name, ok=False,
                    error="no prior checkpoint known",
                )
                continue
            try:
                resp = _http.request_json(
                    backend.base_url + "/reload",
                    method="POST",
                    payload={"checkpoint": prev_ckpt},
                    timeout_s=self.config.request_timeout_s,
                )
                if not resp.ok:
                    raise ConnectionError(
                        f"rollback reload answered {resp.status}"
                    )
                payload = resp.json()
                verified = None
                if canary_body is not None and baseline is not None:
                    verified = (
                        self._canary(backend, canary_body) == baseline
                    )
                    if not verified:
                        rolled_all = False
                self._rollout_backend(
                    backend.name,
                    status="rolled_back",
                    generation=payload.get("swap_generation"),
                    rollback_verified=verified,
                )
                self.tracer.event(
                    "rollout_rollback", backend=backend.name, ok=True,
                    verified=verified,
                )
            except Exception as exc:  # noqa: BLE001 - keep rolling back
                rolled_all = False
                self._rollout_backend(backend.name, status="rollback_failed")
                self.tracer.event(
                    "rollout_rollback", backend=backend.name, ok=False,
                    error=repr(exc),
                )
        if swapped and rolled_all:
            with self._lock:
                self.rollout_rollbacks_total += 1
        # Whatever happened, the frontier must come back admitting:
        # quiesces lifted, the drain latch cleared, the prober alive.
        self.resume()
        final = "rolled_back" if (swapped and rolled_all) else "aborted"
        self._rollout_set(phase=final)
        self.tracer.dump("rollout_abort")
        with self._lock:
            record = dict(self._rollout)
        record["rollout"] = self.rollout_block()
        return 502, record

    def rollout_block(self) -> Dict[str, object]:
        """The machine-checked rollout summary: bench_serving emits it,
        check_bench_json.validate_rollout gates it. Generations below are
        each backend's last OBSERVED swap generation (0 until first
        observed); fleet_generation is their minimum — the generation the
        whole fleet provably reached."""
        div = self.generation_divergence()
        gens = []
        for b in self._backend_list():
            with b.lock:
                gens.append(int(b.swap_generation or 0))
        with self._lock:
            mixed = float(self.mixed_generation_seconds)
            return {
                "phase": str(self._rollout["phase"]),
                "rollouts_total": int(self.rollouts_total),
                "aborts_total": int(self.rollout_aborts_total),
                "rollbacks_total": int(self.rollout_rollbacks_total),
                "fleet_generation": min(gens) if gens else 0,
                "backend_generations": gens,
                "mixed_generation_seconds": mixed,
                "generation_stamps_total": int(self.generation_stamps_total),
                "generation_divergence": bool(div),
                "zero_mixed_window": mixed == 0.0,
            }

    # -- observability -----------------------------------------------------
    def sessions_active(self) -> int:
        with self._sessions_lock:
            return len(self._sessions)

    def metrics(self) -> Dict[str, object]:
        # rollout_block() takes backend locks then self._lock; compute it
        # fully before re-entering self._lock below (lock is not reentrant).
        rollout = self.rollout_block()
        per_backend = {}
        states = []
        for b in self._backend_list():
            states.append(b.lifecycle.state)
            with b.lock:
                per_backend[b.name] = {
                    "state": b.lifecycle.state,
                    "in_flight": b.in_flight,
                    "forwarded_total": b.forwarded_total,
                    "failures_total": b.failures_total,
                    "queue_wait_p95_ms": b.queue_wait_p95_ms,
                    "probes_ok": b.probes_ok,
                    "probes_failed": b.probes_failed,
                    "swap_generation": b.swap_generation,
                }
        with self._lock:
            lats = sorted(self._latencies_ms)
            return {
                "backends": len(self._order),
                "backend_states": states,
                "per_backend": per_backend,
                "requests_total": self.requests_total,
                "responses_total": self.responses_total,
                "errors_total": self.errors_total,
                "retries_total": self.retries_total,
                "hedges_total": self.hedges_total,
                "hedge_wins_total": self.hedge_wins_total,
                "migrations_total": self.migrations_total,
                "stream_requests_total": self.stream_requests_total,
                "sessions_active": self.sessions_active(),
                "shed_total": self.shed_total,
                "brownout_active": self._brownout_active,
                "brownout_engagements_total": self.brownout_engagements_total,
                "brownout_requests_total": self.brownout_requests_total,
                "queue_wait_p95_ms": self._agg_queue_p95_ms,
                "latency_p50_ms": _percentile(lats, 0.50),
                "latency_p99_ms": _percentile(lats, 0.99),
                "rollout_phase": rollout["phase"],
                "rollouts_total": rollout["rollouts_total"],
                "rollout_aborts_total": rollout["aborts_total"],
                "rollout_rollbacks_total": rollout["rollbacks_total"],
                "fleet_generation": rollout["fleet_generation"],
                "generation_divergence": rollout["generation_divergence"],
                "generation_stamps_total": rollout["generation_stamps_total"],
                "mixed_generation_seconds": rollout[
                    "mixed_generation_seconds"
                ],
            }

    _PROM_COUNTER_KEYS = (
        "requests_total",
        "responses_total",
        "errors_total",
        "retries_total",
        "hedges_total",
        "hedge_wins_total",
        "migrations_total",
        "stream_requests_total",
        "shed_total",
        "brownout_engagements_total",
        "brownout_requests_total",
        "rollouts_total",
        "rollout_aborts_total",
        "rollout_rollbacks_total",
        "generation_stamps_total",
    )

    def render_prom(self) -> str:
        """Prometheus text exposition: frontier counters + per-backend
        state codes/gauges, mirroring the backend's render-time-sync
        pattern (ServingMetrics stays the authority, set_total asserts
        monotonicity)."""
        reg = self.registry
        snap = self.metrics()
        for key in self._PROM_COUNTER_KEYS:
            reg.counter(
                f"raft_frontier_{key}", f"Frontier {key}"
            ).set_total(float(snap[key]))
        state_gauge = reg.gauge(
            "raft_frontier_backend_state_code",
            "Backend health state index: "
            + " ".join(f"{i}={s}" for i, s in enumerate(HEALTH_STATES)),
        )
        inflight_gauge = reg.gauge(
            "raft_frontier_backend_in_flight",
            "In-flight forwards per backend",
        )
        for name, info in snap["per_backend"].items():
            state_gauge.set(
                float(HEALTH_STATES.index(info["state"])), backend=name
            )
            inflight_gauge.set(float(info["in_flight"]), backend=name)
        reg.gauge(
            "raft_frontier_brownout_active",
            "1 while the brownout deadline-tightening is engaged",
        ).set(1.0 if snap["brownout_active"] else 0.0)
        reg.gauge(
            "raft_frontier_sessions_active", "Pinned stream sessions"
        ).set(float(snap["sessions_active"]))
        reg.gauge(
            "raft_frontier_queue_wait_p95_ms",
            "Worst admissible-backend queue-wait p95 (brownout signal)",
        ).set(float(snap["queue_wait_p95_ms"]))
        reg.counter(
            "raft_frontier_mixed_generation_seconds",
            "Widest observed window of old-generation answers landing "
            "after a newer generation (0 on a clean rollout)",
        ).set_total(float(snap["mixed_generation_seconds"]))
        reg.gauge(
            "raft_frontier_fleet_generation",
            "Minimum observed backend swap generation — the generation "
            "the whole fleet provably reached",
        ).set(float(snap["fleet_generation"]))
        reg.gauge(
            "raft_frontier_generation_divergence",
            "1 while known backend swap generations disagree "
            "(out-of-band reload)",
        ).set(1.0 if snap["generation_divergence"] else 0.0)
        gen_gauge = reg.gauge(
            "raft_frontier_backend_generation",
            "Last observed swap generation per backend",
        )
        for name, info in snap["per_backend"].items():
            gen_gauge.set(
                float(info["swap_generation"] or 0), backend=name
            )
        return reg.render()

    def healthz(self) -> Dict[str, object]:
        """Frontier state + the per-backend aggregation: breaker
        snapshots and each backend's last-probed boot block (warm-cache
        hits, warmup seconds) — one scrape answers 'which hosts are in
        rotation and how fast would a replacement boot'."""
        backends = {}
        for b in self._backend_list():
            with b.lock:
                backends[b.name] = {
                    "state": b.lifecycle.state,
                    "lifecycle": b.lifecycle.snapshot(),
                    "boot": b.last_boot,
                    "queue_wait_p95_ms": b.queue_wait_p95_ms,
                    "in_flight": b.in_flight,
                    "swap_generation": b.swap_generation,
                    "checkpoint": b.checkpoint,
                }
        return {
            "frontier": {"state": self.state, **self.metrics()},
            "backends": backends,
            "rollout": self.rollout_block(),
        }


def make_frontier_http_server(
    frontier: Frontier,
    host: str = "127.0.0.1",
    port: int = 0,
    handler_timeout_s: float = 30.0,
) -> ThreadingHTTPServer:
    """Bind (but don't run) the frontier's HTTP front; port 0 picks an
    ephemeral port. Same slow-client discipline as the backend server:
    per-connection socket timeout, stalled body reads answered 408."""
    from raft_stereo_tpu_torch.utils.http import json_response as _json_response
    from raft_stereo_tpu_torch.utils.http import text_response as _text_response

    class Handler(BaseHTTPRequestHandler):
        timeout = handler_timeout_s

        def log_message(self, fmt, *args):  # quiet by default
            logger.debug("frontier http: " + fmt, *args)

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path == "/healthz":
                _json_response(self, 200, frontier.healthz())
            elif parsed.path == "/metrics":
                query = urllib.parse.parse_qs(parsed.query)
                fmt = query.get("format", ["json"])[0]
                if fmt == "prom":
                    _text_response(
                        self, 200, frontier.render_prom(), PROM_CONTENT_TYPE
                    )
                elif fmt == "json":
                    _json_response(self, 200, frontier.metrics())
                else:
                    _json_response(
                        self,
                        400,
                        {"error": f"unknown metrics format {fmt!r}"},
                    )
            else:
                _json_response(self, 404, {"error": f"no route {self.path}"})

        def do_POST(self):
            import json as _json_mod
            import socket as _socket

            if self.path not in ("/predict", "/v1/predict", "/rollout"):
                _json_response(self, 404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(length) if length else b""
            except (_socket.timeout, TimeoutError):
                _json_response(
                    self, 408, {"error": "request body read timed out"}
                )
                self.close_connection = True
                return
            try:
                body = _json_mod.loads(raw)
                if not isinstance(body, dict):
                    raise ValueError("request body must be a JSON object")
            except (ValueError, _json_mod.JSONDecodeError) as exc:
                _json_response(self, 400, {"error": f"bad request: {exc!r}"})
                return
            if self.path == "/rollout":
                ckpt = body.get("checkpoint")
                if not isinstance(ckpt, str) or not ckpt:
                    _json_response(
                        self,
                        400,
                        {"error": "rollout needs a 'checkpoint' path"},
                    )
                    return
                status, payload = frontier.run_rollout(
                    ckpt,
                    rollback_checkpoint=body.get("rollback_checkpoint"),
                    force=bool(body.get("force", False)),
                )
                _json_response(self, status, payload)
                return
            status, payload = frontier.handle_predict(body)
            _json_response(self, status, payload)

    return ThreadingHTTPServer((host, port), Handler)


def serve_frontier_http(frontier: Frontier, host: str, port: int) -> None:
    """Blocking server loop (the `frontier` CLI path): Ctrl-C, and SIGTERM
    when called from the main thread (the port's addition, as its `serve`
    loop has), stop it; in-flight forwards drain before it returns."""
    import signal

    server = make_frontier_http_server(frontier, host, port)
    logger.info(
        "frontier routing %d backend(s) on http://%s:%d",
        len(frontier.config.backends),
        *server.server_address,
    )
    previous = None
    if threading.current_thread() is threading.main_thread():
        # shutdown() waits for serve_forever to return, so it runs on a
        # thread of its own, not in the handler that interrupts the loop.
        previous = signal.signal(
            signal.SIGTERM,
            lambda signum, frame: threading.Thread(target=server.shutdown, daemon=True).start(),
        )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
        server.server_close()
        drained = frontier.drain()
        logger.info("frontier stopped: in-flight forwards %s", "drained" if drained else "cut at the drain timeout")


__all__ = [
    "Frontier",
    "make_frontier_http_server",
    "serve_frontier_http",
]
