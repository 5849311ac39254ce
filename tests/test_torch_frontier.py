"""The port's front tier (serving/frontier.py) on stub backends, the
fake-backend half of tests/test_frontier.py run against the port's copy:
retry lands on a different backend exactly once, a dropped connection
retries like a dead host, deterministic 4xx forward verbatim and never
retry, the retry budget caps amplification, hedging fires after its delay
and the duplicate's answer wins, the breaker walks a dead backend failed ->
(restart) -> probation -> healthy, stream affinity pins and migrates with a
cold restart, brownout engages, tightens and recovers with hysteresis, and
the backend HTTP server
cuts a connect-and-stall client and answers 408 to a stalled body.
`_FakeBackend` speaks the serve wire format without a model, so these run
in seconds. tests/test_torch_frontier_e2e.py routes to real port backends.

The JAX suite's brownout A/B (80 requests at 4 ms arrivals, >= 99% served)
is left out: it measures the host's thread scheduling as much as the
router, and failed in most runs on a shared test host for the JAX suite
and its copy alike (the load generator lagged 30-200 ms behind its
schedule); the engage / tighten / recover test covers the brownout logic.
"""

import json
import os
import socket
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from fault_injection import http_response_fault

BUCKET = (64, 96)
CHUNK_ITERS = 2
MAX_ITERS = 4

_rng = np.random.default_rng(20260807)
PAIR = (
    _rng.uniform(0, 255, (BUCKET[0], BUCKET[1], 3)).astype(np.float32),
    _rng.uniform(0, 255, (BUCKET[0], BUCKET[1], 3)).astype(np.float32),
)


# -- fake backends: the wire format without the model ------------------------


class _FakeBackend:
    """Stdlib stand-in for one StereoService host: POST /v1/predict and
    GET /healthz in the real wire format, per-stream frame counters (so
    warm_started/stream_frame behave), a settable healthz queue-wait p95
    (the brownout signal), and an optional single-worker timing model
    (`ms_per_iter` > 0): requests serialize through one work lock and a
    request sheds 503 when the queued estimate already blows its
    deadline — the backend-side admission control the brownout A/B needs."""

    def __init__(self, default_iters: int = MAX_ITERS, ms_per_iter: float = 0.0):
        self.default_iters = default_iters
        self.ms_per_iter = ms_per_iter
        self.queue_p95_ms = 0.0
        self.predict_calls = 0
        self.shed_calls = 0
        self.streams = {}
        self._lock = threading.Lock()
        self._work_lock = threading.Lock()
        self._waiting = 0
        self.server = self._make_server(0)
        self.port = self.server.server_address[1]
        self.addr = f"127.0.0.1:{self.port}"
        self._serve()

    def _make_server(self, port: int) -> ThreadingHTTPServer:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            timeout = 10.0

            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                if self.path.startswith("/healthz"):
                    body = json.dumps(outer.healthz()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length))
                status, out = outer.predict(payload)
                body = json.dumps(out).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        return ThreadingHTTPServer(("127.0.0.1", port), Handler)

    def _serve(self):
        self.thread = threading.Thread(
            target=self.server.serve_forever, daemon=True
        )
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()

    def restart(self):
        """Same-port reboot (HTTPServer sets allow_reuse_address): the
        'operator restarted the host' leg of the breaker walk."""
        self.server = self._make_server(self.port)
        self._serve()

    def healthz(self):
        return {
            "serving": {
                "state": "healthy",
                "attribution": {
                    "queue_wait_ms": {
                        "count": 8,
                        "mean": self.queue_p95_ms,
                        "p50": self.queue_p95_ms,
                        "p95": self.queue_p95_ms,
                    }
                },
                "boot": {"warmup_seconds": 0.01, "cache_enabled": False},
            }
        }

    def predict(self, body):
        with self._lock:
            self.predict_calls += 1
        if body.get("oversize"):
            # Deterministic 4xx: the request, not the host, is at fault.
            return 413, {"error": "input exceeds every bucket"}
        iters = int(body.get("max_iters") or self.default_iters)
        deadline_ms = body.get("deadline_ms")
        if self.ms_per_iter > 0:
            est_ms = self.default_iters * self.ms_per_iter
            with self._lock:
                if (
                    deadline_ms is not None
                    and self._waiting * est_ms > float(deadline_ms)
                ):
                    self.shed_calls += 1
                    return 503, {
                        "error": "deadline infeasible",
                        "state": "healthy",
                    }
                self._waiting += 1
            try:
                with self._work_lock:
                    time.sleep(iters * self.ms_per_iter / 1e3)
            finally:
                with self._lock:
                    self._waiting -= 1
        out = {
            "disparity": [[1.0, 2.0]],
            "iters_completed": iters,
            "early_exit": iters < self.default_iters,
            "latency_ms": 1.0,
            "bucket": list(BUCKET),
            # What the frontier actually forwarded — the brownout
            # tightening proof reads these.
            "echo_max_iters": body.get("max_iters"),
            "echo_deadline_ms": deadline_ms,
        }
        sid = body.get("stream_id")
        if sid is not None:
            with self._lock:
                frames = self.streams.get(sid, 0)
                self.streams[sid] = frames + 1
            out.update(
                stream_id=sid,
                stream_frame=frames,
                warm_started=frames > 0,
                reset=False,
            )
        return 200, out


def _frontier_config(addrs, **kw):
    from raft_stereo_tpu_torch.config import FrontierConfig

    kw.setdefault("backends", tuple(addrs))
    kw.setdefault("health_interval_s", 0.05)
    kw.setdefault("health_timeout_s", 2.0)
    kw.setdefault("request_timeout_s", 60.0)
    kw.setdefault("retry_attempts", 3)
    kw.setdefault("retry_base_delay_s", 0.001)
    kw.setdefault("retry_max_delay_s", 0.002)
    kw.setdefault("breaker_degrade_after", 1)
    kw.setdefault("breaker_fail_after", 2)
    kw.setdefault("breaker_probation", 2)
    kw.setdefault("drain_timeout_s", 30.0)
    return FrontierConfig(**kw)


def _make_frontier(addrs, **kw):
    from raft_stereo_tpu_torch.serving.frontier import Frontier

    return Frontier(_frontier_config(addrs, **kw), sleep=lambda s: None)


def _poll(predicate, timeout_s=10.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


# -- fake-backend units ------------------------------------------------------


def test_retry_lands_on_a_different_backend_exactly_once():
    """A 5xx from the first-routed backend retries on the OTHER backend
    and the client sees exactly one (successful) answer: the exactly-once
    ledger (requests == responses), one counted retry, a breaker debit on
    the faulty host only."""
    b0, b1 = _FakeBackend(), _FakeBackend()
    frontier = _make_frontier([b0.addr, b1.addr])
    try:
        with http_response_fault(b0.server, "5xx", failures=1) as calls:
            status, payload = frontier.handle_predict({"image1": [], "image2": []})
        assert status == 200
        assert calls["calls"] == 1
        assert payload["backend"] == b1.addr  # retried AWAY from the failer
        snap = frontier.metrics()
        assert snap["requests_total"] == snap["responses_total"] == 1
        assert snap["retries_total"] == 1
        assert snap["errors_total"] == 0
        assert snap["per_backend"][b0.addr]["failures_total"] == 1
        assert snap["per_backend"][b1.addr]["failures_total"] == 0
        # degrade_after=1: one failure marks it degraded, not failed.
        assert snap["per_backend"][b0.addr]["state"] == "degraded"
    finally:
        frontier.close()
        b0.close()
        b1.close()


def test_dropped_connection_retries_like_a_dead_host():
    """mode='drop' answers with a bare connection reset — the wire
    signature of a host dying mid-request — and the frontier still
    answers via the surviving backend."""
    b0, b1 = _FakeBackend(), _FakeBackend()
    frontier = _make_frontier([b0.addr, b1.addr])
    try:
        with http_response_fault(b0.server, "drop", failures=1):
            status, payload = frontier.handle_predict({"image1": [], "image2": []})
        assert status == 200
        assert payload["backend"] == b1.addr
        assert frontier.metrics()["retries_total"] == 1
    finally:
        frontier.close()
        b0.close()
        b1.close()


def test_deterministic_4xx_forwards_verbatim_and_never_retries():
    """A 413 is the request's fault: forwarded unchanged, zero retries,
    zero breaker debit — retrying it on another backend could only burn
    capacity to fail again."""
    b0, b1 = _FakeBackend(), _FakeBackend()
    frontier = _make_frontier([b0.addr, b1.addr])
    try:
        status, payload = frontier.handle_predict(
            {"image1": [], "image2": [], "oversize": True}
        )
        assert status == 413
        assert "error" in payload
        snap = frontier.metrics()
        assert snap["retries_total"] == 0
        assert b0.predict_calls + b1.predict_calls == 1
        assert set(snap["backend_states"]) == {"healthy"}
        # Answered by a live backend -> part of the answered ledger.
        assert snap["responses_total"] == 1
    finally:
        frontier.close()
        b0.close()
        b1.close()


def test_retry_budget_caps_amplification():
    """With the budget at its floor (min=1, percent=0), a persistently
    failing fleet gets exactly one retry ever — then requests fail fast
    with 502 instead of melting the backends with retry storms."""
    b0, b1 = _FakeBackend(), _FakeBackend()
    frontier = _make_frontier(
        [b0.addr, b1.addr],
        retry_budget_min=1,
        retry_budget_percent=0.0,
        breaker_fail_after=50,  # keep both admissible: isolate the budget
    )
    try:
        with http_response_fault(b0.server, "5xx"), http_response_fault(
            b1.server, "5xx"
        ):
            s1, _ = frontier.handle_predict({"image1": [], "image2": []})
            s2, _ = frontier.handle_predict({"image1": [], "image2": []})
        assert s1 == 502 and s2 == 502
        snap = frontier.metrics()
        assert snap["retries_total"] == 1  # budget floor, not attempts*2
        assert snap["errors_total"] == 2
    finally:
        frontier.close()
        b0.close()
        b1.close()


def test_hedge_fires_after_floor_delay_and_the_duplicate_wins():
    """Opt-in hedging: the first pick stalls (injected delay), the hedge
    dispatches to the other backend after hedge_floor_ms and its answer
    is returned first — tail cut, exactly one client answer, hedges and
    hedge wins counted (and NOT counted as retries)."""
    b0, b1 = _FakeBackend(), _FakeBackend()
    frontier = _make_frontier(
        [b0.addr, b1.addr], hedge=True, hedge_floor_ms=40.0
    )
    try:
        with http_response_fault(b0.server, "delay", delay_s=1.0, failures=1):
            t0 = time.monotonic()
            status, payload = frontier.handle_predict({"image1": [], "image2": []})
            elapsed = time.monotonic() - t0
        assert status == 200
        assert payload["backend"] == b1.addr  # the hedge answered
        assert elapsed < 0.9  # did not wait out the stalled primary
        snap = frontier.metrics()
        assert snap["hedges_total"] == 1
        assert snap["hedge_wins_total"] == 1
        assert snap["retries_total"] == 0
    finally:
        frontier.close()
        b0.close()
        b1.close()


def test_breaker_walks_failed_probation_healthy_and_sheds_when_all_dead():
    """Kill a fake host: consecutive transport failures trip its breaker
    failed (routing stops considering it); kill BOTH and the frontier
    sheds 503 (distinct shed counter). Restart the host: the health probe
    re-admits it into probation and real forwarded traffic earns healthy
    — the same walk the real-fleet chaos test proves end-to-end."""
    b0, b1 = _FakeBackend(), _FakeBackend()
    frontier = _make_frontier([b0.addr, b1.addr]).start()
    try:
        b0.close()
        # Each request that routes to the dead b0 fails + retries to b1;
        # fail_after=2 transport failures (requests and/or probes) trip it.
        for _ in range(4):
            status, _ = frontier.handle_predict({"image1": [], "image2": []})
            assert status == 200  # zero lost requests while b0 dies
        _poll(
            lambda: frontier.metrics()["per_backend"][b0.addr]["state"]
            == "failed",
            what="b0 breaker to trip failed",
        )

        b1.close()
        _poll(
            lambda: frontier.metrics()["per_backend"][b1.addr]["state"]
            == "failed",
            what="b1 breaker to trip failed",
        )
        status, payload = frontier.handle_predict({"image1": [], "image2": []})
        assert status == 503
        assert frontier.metrics()["shed_total"] >= 1

        b0.restart()
        # Probe success is the ONLY re-admission path, and it lands in
        # probation ('degraded'), never straight back to healthy.
        _poll(
            lambda: frontier.metrics()["per_backend"][b0.addr]["state"]
            == "degraded",
            what="probe to re-admit b0 into probation",
        )
        # Real traffic completes probation.
        for _ in range(3):
            status, payload = frontier.handle_predict({"image1": [], "image2": []})
            assert status == 200 and payload["backend"] == b0.addr
        assert frontier.metrics()["per_backend"][b0.addr]["state"] == "healthy"
    finally:
        frontier.close()
        b1.restart()  # so close() below has a socket to tear down
        b0.close()
        b1.close()


def test_stream_affinity_pins_and_migrates_with_cold_restart():
    """Stream frames pin to one backend (carry state is per-host). When
    that host dies, the session migrates: the forwarded stream id is
    generation-aliased so the new backend COLD-starts (warm_started
    False, frame 0), the response records migrated=True, and the
    migration is counted separately from retries."""
    b0, b1 = _FakeBackend(), _FakeBackend()
    frontier = _make_frontier([b0.addr, b1.addr]).start()
    try:
        frames = [
            frontier.handle_predict(
                {"image1": [], "image2": [], "stream_id": "cam0"}
            )
            for _ in range(3)
        ]
        assert all(s == 200 for s, _ in frames)
        pinned = frames[0][1]["backend"]
        assert [p["backend"] for _, p in frames] == [pinned] * 3
        assert [p["warm_started"] for _, p in frames] == [False, True, True]
        assert [p["stream_frame"] for _, p in frames] == [0, 1, 2]
        assert all(p["migrated"] is False for _, p in frames)

        victim, survivor = (
            (b0, b1) if pinned == b0.addr else (b1, b0)
        )
        victim.close()
        status, payload = frontier.handle_predict(
            {"image1": [], "image2": [], "stream_id": "cam0"}
        )
        assert status == 200
        assert payload["backend"] == survivor.addr
        assert payload["migrated"] is True
        assert payload["warm_started"] is False  # cold restart, recorded
        assert payload["stream_frame"] == 0
        assert payload["stream_id"] == "cam0"  # alias never leaks out
        # The carry is NOT pretended to survive: the survivor saw a brand
        # new (aliased) stream, not a continuation.
        assert "cam0" not in survivor.streams
        snap = frontier.metrics()
        assert snap["migrations_total"] == 1
        assert snap["sessions_active"] == 1

        # Next frame warm-starts on the new pin, no further migration.
        status, payload = frontier.handle_predict(
            {"image1": [], "image2": [], "stream_id": "cam0"}
        )
        assert status == 200
        assert payload["backend"] == survivor.addr
        assert payload["warm_started"] is True
        assert payload["migrated"] is False
        assert frontier.metrics()["migrations_total"] == 1
    finally:
        frontier.close()
        b0.close()
        b1.close()


def test_brownout_engages_tightens_and_recovers_with_hysteresis():
    """Above the queue-wait p95 threshold the frontier tightens forwarded
    deadlines AND iteration caps (the anytime engines early-exit:
    quality, not availability, degrades), annotates responses, counts
    engagements separately from sheds, and only disengages below
    threshold x recover_ratio."""
    b0 = _FakeBackend()
    frontier = _make_frontier(
        [b0.addr],
        brownout_queue_p95_ms=50.0,
        brownout_deadline_ms=25.0,
        brownout_max_iters=1,
        brownout_recover_ratio=0.5,
    ).start()
    try:
        status, payload = frontier.handle_predict({"image1": [], "image2": []})
        assert status == 200 and "brownout" not in payload
        assert payload["echo_max_iters"] is None  # untouched when calm

        b0.queue_p95_ms = 200.0
        _poll(
            lambda: frontier.metrics()["brownout_active"],
            what="brownout to engage",
        )
        status, payload = frontier.handle_predict({"image1": [], "image2": []})
        assert status == 200
        assert payload["brownout"] is True
        assert payload["echo_max_iters"] == 1  # iters capped
        assert payload["echo_deadline_ms"] == 25.0  # deadline tightened
        assert payload["iters_completed"] == 1  # reduced iters recorded
        # A client's own TIGHTER deadline is respected, never loosened.
        status, payload = frontier.handle_predict(
            {"image1": [], "image2": [], "deadline_ms": 10.0}
        )
        assert payload["echo_deadline_ms"] == 10.0

        snap = frontier.metrics()
        assert snap["brownout_engagements_total"] == 1
        assert snap["brownout_requests_total"] == 2
        assert snap["shed_total"] == 0  # brownout is NOT shedding

        # Hysteresis: dropping to just-below-threshold is NOT enough...
        b0.queue_p95_ms = 40.0
        time.sleep(0.2)
        assert frontier.metrics()["brownout_active"] is True
        # ...but falling under threshold x ratio (25) disengages.
        b0.queue_p95_ms = 10.0
        _poll(
            lambda: not frontier.metrics()["brownout_active"],
            what="brownout to disengage",
        )
        assert frontier.metrics()["brownout_engagements_total"] == 1
    finally:
        frontier.close()
        b0.close()


# -- slowloris hardening (backend HTTP server satellite) ---------------------


def _stalled_recv(sock, timeout_s=5.0):
    sock.settimeout(timeout_s)
    try:
        return sock.recv(65536)
    except (TimeoutError, socket.timeout):
        pytest.fail("server never closed the stalled connection")


def test_backend_server_times_out_connect_and_stall_client():
    """Slowloris leg 1: a client that connects and never speaks is cut
    off by the per-connection socket timeout instead of wedging a handler
    thread forever. The handler never touches the service, so a bare
    object() stands in."""
    from raft_stereo_tpu_torch.serving.service import make_http_server

    server = make_http_server(object(), port=0, handler_timeout_s=0.3)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        t0 = time.monotonic()
        with socket.create_connection(server.server_address, timeout=5) as s:
            assert _stalled_recv(s) == b""  # closed, no bytes
        assert time.monotonic() - t0 < 3.0
    finally:
        server.shutdown()
        server.server_close()


def test_backend_server_answers_408_on_stalled_body():
    """Slowloris leg 2: a client that sends headers promising a body and
    then stalls mid-body gets a clean 408 and a close — it spoke enough
    protocol to deserve an answer, and the thread is freed either way."""
    from raft_stereo_tpu_torch.serving.service import make_http_server

    server = make_http_server(object(), port=0, handler_timeout_s=0.3)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with socket.create_connection(server.server_address, timeout=5) as s:
            s.sendall(
                b"POST /reload HTTP/1.1\r\nHost: t\r\n"
                b"Content-Length: 64\r\nContent-Type: application/json\r\n"
                b"\r\n{\"partial"  # 9 bytes of a promised 64
            )
            data = _stalled_recv(s)
        assert b"408" in data.split(b"\r\n", 1)[0]
        assert b"timed out" in data
    finally:
        server.shutdown()
        server.server_close()


def test_frontier_cli_serves_and_sigterm_drains_to_exit_0():
    """`python -m raft_stereo_tpu_torch frontier` as a process: /healthz
    answers within seconds (no model, no torch), a request whose only
    backend is dead answers 502 after its retries, and SIGTERM drains to
    exit 0."""
    import signal
    import subprocess

    from raft_stereo_tpu_torch.utils.http import request, request_json

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dead = _FakeBackend()
    dead.close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-m", "raft_stereo_tpu_torch", "frontier", "--backends", dead.addr,
                             "--port", str(port), "--retry_attempts", "2", "--health_interval_s", "0.2"],
                            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                health = request_json(f"http://127.0.0.1:{port}/healthz", timeout_s=5).json()
                break
            except OSError:
                assert time.monotonic() < deadline and proc.poll() is None, "the frontier never answered"
                time.sleep(0.05)
        assert health["frontier"]["state"] == "healthy"
        resp = request_json(f"http://127.0.0.1:{port}/predict", method="POST", payload={"image1": [], "image2": []},
                            timeout_s=30)
        assert resp.status == 502 and "retries exhausted" in resp.json()["error"]
        assert request(f"http://127.0.0.1:{port}/metrics?format=prom").status == 200
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, err[-2000:]
    assert "in-flight forwards drained" in err
