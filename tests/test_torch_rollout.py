"""The port's checkpoint rollout orchestration (the front tier's POST
/rollout, `frontier --rollout`) on stub backends, the fake-backend half of
tests/test_rollout.py run against the port's copy: drain then resume
restores admission, the probe scheduler jitters each backend's phase, the
`serve --reload_ckpt` and `frontier --rollout` clients map every failure
to its exit code, the happy path walks the fleet onto one generation with
bit-identical canaries, a second rollout is refused while one runs, an
abort rolls swapped backends back, and an out-of-band reload is detected
and blocks a rollout without `force`.
"""

import json
import os
import random
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from check_bench_json import validate_rollout  # noqa: E402

BUCKET = (64, 96)
CHUNK_ITERS = 2
MAX_ITERS = 4

_rng = np.random.default_rng(20260818)
PAIR = (
    _rng.uniform(0, 255, (BUCKET[0], BUCKET[1], 3)).astype(np.float32),
    _rng.uniform(0, 255, (BUCKET[0], BUCKET[1], 3)).astype(np.float32),
)


# -- fake backends: the rollout wire format without the model ----------------


class _FakeBackend:
    """Stdlib stand-in for one StereoService host speaking the rollout
    wire format: /healthz reports `swap_generation`/`checkpoint`/
    `buckets`, POST /reload bumps the generation and records the served
    checkpoint, and predict responses carry the generation stamp plus a
    disparity that depends on WHICH checkpoint is loaded (`ckpt_values`)
    — same checkpoint, same bits, exactly like real weights — so canary
    bit-identity and rollback re-verification are provable on fakes."""

    def __init__(self):
        self.generation = 0
        self.checkpoint = None
        # checkpoint -> disparity value. The in-memory boot weights (None)
        # and their saved copy ("ckpt_base") are the SAME weights.
        self.ckpt_values = {None: 1.0, "ckpt_base": 1.0, "ckpt_new": 2.0}
        self.reload_fail_status = None
        self.reload_calls = []
        self.predict_calls = 0
        self._lock = threading.Lock()
        self.server = self._make_server(0)
        self.port = self.server.server_address[1]
        self.addr = f"127.0.0.1:{self.port}"
        self.thread = threading.Thread(
            target=self.server.serve_forever, daemon=True
        )
        self.thread.start()

    def _make_server(self, port: int) -> ThreadingHTTPServer:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            timeout = 10.0

            def log_message(self, fmt, *args):
                pass

            def _reply(self, status, out):
                body = json.dumps(out).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/healthz"):
                    self._reply(200, outer.healthz())
                else:
                    self.send_error(404)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length))
                if self.path == "/reload":
                    status, out = outer.reload(payload)
                else:
                    status, out = outer.predict(payload)
                self._reply(status, out)

        return ThreadingHTTPServer(("127.0.0.1", port), Handler)

    def close(self):
        self.server.shutdown()
        self.server.server_close()

    def healthz(self):
        with self._lock:
            gen, ckpt = self.generation, self.checkpoint
        return {
            "serving": {
                "state": "healthy",
                "swap_generation": gen,
                "checkpoint": ckpt,
                "buckets": [list(BUCKET)],
                "attribution": {
                    "queue_wait_ms": {"count": 8, "p50": 0.0, "p95": 0.0}
                },
                "boot": {"warmup_seconds": 0.01, "cache_enabled": False},
            }
        }

    def reload(self, body):
        ckpt = body.get("checkpoint")
        with self._lock:
            self.reload_calls.append(ckpt)
            if self.reload_fail_status is not None:
                return self.reload_fail_status, {
                    "error": "injected reload failure"
                }
            prev = self.checkpoint
            self.generation += 1
            self.checkpoint = ckpt
            gen = self.generation
        return 200, {
            "swap_generation": gen,
            "previous_generation": gen - 1,
            "checkpoint": ckpt,
            "previous_checkpoint": prev,
            "state": "healthy",
            "replicas": 1,
            "validation": {"structure": "identical", "leaves": 2},
        }

    def predict(self, body):
        with self._lock:
            self.predict_calls += 1
            value = self.ckpt_values.get(self.checkpoint, 99.0)
            gen = self.generation
        return 200, {
            "disparity": [[value, 0.5]],
            "iters_completed": MAX_ITERS,
            "early_exit": False,
            "latency_ms": 1.0,
            "bucket": list(BUCKET),
            "swap_generation": gen,
        }


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
    kw.setdefault("rollout_probation", 2)
    kw.setdefault("rollout_probe_interval_s", 0.01)
    kw.setdefault("rollout_drain_timeout_s", 10.0)
    kw.setdefault("rollout_verify_timeout_s", 10.0)
    kw.setdefault("rollout_hold_timeout_s", 10.0)
    return FrontierConfig(**kw)


def _make_frontier(addrs, **kw):
    from raft_stereo_tpu_torch.serving.frontier import Frontier

    rng = kw.pop("rng", None)
    return Frontier(
        _frontier_config(addrs, **kw), sleep=lambda s: None, rng=rng
    )


def _poll(predicate, timeout_s=10.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


# -- drain latch + probe jitter satellites -----------------------------------


def test_drain_then_resume_restores_admission():
    """Regression for the one-way `_draining` latch: drain() used to be
    permanent, so an aborted rollout that drained would strand the
    frontier shedding 503 forever. resume() reopens admission, restarts
    the prober, and requests flow again."""
    b0 = _FakeBackend()
    frontier = _make_frontier([b0.addr]).start()
    try:
        status, _ = frontier.handle_predict({"image1": [], "image2": []})
        assert status == 200
        assert frontier.drain(timeout_s=10.0) is True
        status, payload = frontier.handle_predict({"image1": [], "image2": []})
        assert status == 503
        assert payload["state"] == "draining"

        frontier.resume()
        assert frontier.state == "healthy"
        status, _ = frontier.handle_predict({"image1": [], "image2": []})
        assert status == 200
        # The prober came back too (drain's close() had stopped it).
        assert frontier._poller is not None and frontier._poller.is_alive()
    finally:
        frontier.close()
        b0.close()


def test_probe_scheduler_per_backend_phase_jitter():
    """Thundering-herd fix: each backend's probe clock starts at a
    seeded-random offset inside one interval, so probes spread across the
    interval instead of aligning on the same tick. Deterministic under an
    injected rng: two frontiers with the same seed produce the same
    relative phase, and the phases are distinct within the interval."""
    interval = 5.0  # long enough that no probe fires during the test
    b0, b1 = _FakeBackend(), _FakeBackend()

    def offsets(seed):
        frontier = _make_frontier(
            [b0.addr, b1.addr],
            health_interval_s=interval,
            rng=random.Random(seed),
        ).start()
        try:
            _poll(
                lambda: len(frontier._probe_due) == 2,
                what="probe schedule to initialize",
            )
            due = dict(frontier._probe_due)
        finally:
            frontier.close()
        return due

    d1, d2 = offsets(7), offsets(7)
    phase1 = d1[b0.addr] - d1[b1.addr]
    phase2 = d2[b0.addr] - d2[b1.addr]
    try:
        # Distinct phases (the herd is split)...
        assert phase1 != 0.0
        # ...inside one interval...
        assert abs(phase1) < interval
        # ...and reproducible given the seed (t0 cancels in the diff).
        assert abs(phase1 - phase2) < 1e-9
        # A different seed lands a different phase.
        d3 = offsets(1234)
        assert (d3[b0.addr] - d3[b1.addr]) != phase1
    finally:
        b0.close()
        b1.close()


# -- hardened reload client (cli satellite) ----------------------------------


class _AdminFake:
    """Configurable /reload admin endpoint for the exit-code matrix."""

    def __init__(self, mode):
        outer = self
        self.mode = mode

        class Handler(BaseHTTPRequestHandler):
            timeout = 10.0

            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length", "0"))
                self.rfile.read(length)
                if outer.mode == "stall":
                    time.sleep(2.0)  # past the client's read timeout
                    return
                if outer.mode == "mismatch":
                    body = json.dumps(
                        {"error": "checkpoint tree differs in structure"}
                    ).encode()
                    status = 409
                elif outer.mode == "nonjson":
                    body = b"<html>weights page</html>"
                    status = 200
                else:
                    body = json.dumps(
                        {"swap_generation": 1, "checkpoint": "x"}
                    ).encode()
                    status = 200
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        threading.Thread(
            target=self.server.serve_forever, daemon=True
        ).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def test_reload_client_exit_code_matrix():
    """`serve --reload_ckpt` client hardening: each failure mode maps to
    a DISTINCT stable exit code (operator scripts branch on it) instead
    of a raw traceback — happy 0, 409 mismatch 3, connection refused 4,
    stalled response 5, non-JSON body 6."""
    from raft_stereo_tpu_torch import cli

    admin = _AdminFake("ok")
    try:
        assert cli._reload_checkpoint_client("127.0.0.1", admin.port, "c") == 0
        admin.mode = "mismatch"
        assert (
            cli._reload_checkpoint_client("127.0.0.1", admin.port, "c")
            == cli.EXIT_ADMIN_REFUSED
        )
        admin.mode = "nonjson"
        assert (
            cli._reload_checkpoint_client("127.0.0.1", admin.port, "c")
            == cli.EXIT_ADMIN_BAD_BODY
        )
        admin.mode = "stall"
        assert (
            cli._reload_checkpoint_client(
                "127.0.0.1", admin.port, "c", timeout_s=0.3
            )
            == cli.EXIT_ADMIN_TIMEOUT
        )
    finally:
        admin.close()
    # Server gone: connection refused is its own code, not a traceback.
    assert (
        cli._reload_checkpoint_client("127.0.0.1", admin.port, "c")
        == cli.EXIT_ADMIN_UNREACHABLE
    )
    # The frontier rollout client shares the hardened transport path.
    assert (
        cli._rollout_client("127.0.0.1", admin.port, "c", None, False)
        == cli.EXIT_ADMIN_UNREACHABLE
    )


# -- orchestrator units on fakes ---------------------------------------------


def test_rollout_happy_path_walks_the_fleet_onto_one_generation():
    """The tentpole walk on fakes: per backend quiesce → reload → verify
    (healthz generation advance + canary) → probation; swapped backends
    held out of rotation until the last old-generation backend drains
    (the flip); every backend ends on generation 1 serving the new
    checkpoint, the canary recorded a changed output, admission is open
    afterwards, and the rollout block passes the bench validator."""
    b0, b1 = _FakeBackend(), _FakeBackend()
    frontier = _make_frontier([b0.addr, b1.addr])
    try:
        status, record = frontier.run_rollout(
            "ckpt_new", rollback_checkpoint="ckpt_base"
        )
        assert status == 200, record
        assert record["phase"] == "completed"
        assert record["canary_changed"] is True
        assert record["abort_reason"] is None
        for addr in (b0.addr, b1.addr):
            assert record["backends"][addr]["status"] == "done"
            assert record["backends"][addr]["generation"] == 1
        assert b0.checkpoint == b1.checkpoint == "ckpt_new"
        assert b0.reload_calls == ["ckpt_new"]
        assert b1.reload_calls == ["ckpt_new"]

        block = record["rollout"]
        assert validate_rollout(block) == []
        assert block["rollouts_total"] == 1
        assert block["aborts_total"] == block["rollbacks_total"] == 0
        assert block["fleet_generation"] == 1
        assert block["backend_generations"] == [1, 1]
        assert block["generation_divergence"] is False
        assert block["zero_mixed_window"] is True

        # Quiesces lifted: both backends admit and answer the new bits.
        status, payload = frontier.handle_predict({"image1": [], "image2": []})
        assert status == 200
        assert payload["disparity"] == [[2.0, 0.5]]
        assert frontier._quiesced == set()
    finally:
        frontier.close()
        b0.close()
        b1.close()


def test_rollout_is_mutually_exclusive_per_frontier():
    """A second /rollout while one is running answers 409 immediately —
    two interleaved walks could quiesce everything at once."""
    b0 = _FakeBackend()
    frontier = _make_frontier([b0.addr])
    try:
        assert frontier._rollout_mutex.acquire(blocking=False)
        try:
            status, record = frontier.run_rollout("ckpt_new")
        finally:
            frontier._rollout_mutex.release()
        assert status == 409
        assert "in progress" in record["error"]
    finally:
        frontier.close()
        b0.close()


def test_rollout_abort_rolls_swapped_backends_back():
    """Abort acceptance on fakes: backend 0 swaps cleanly; backend 1's
    reload 500s → the roll aborts and backend 0 is rolled BACK (its
    previous checkpoint was in-memory weights, so the request-level
    rollback_checkpoint — the saved copy of the same weights — is the
    target), its rollback canary re-verifies bit-identical to the
    pre-roll baseline, the fleet is provably on one (the old) weight
    set, and resume() reopened admission."""
    b0, b1 = _FakeBackend(), _FakeBackend()
    b1.reload_fail_status = 500
    frontier = _make_frontier([b0.addr, b1.addr])
    try:
        status, record = frontier.run_rollout(
            "ckpt_new", rollback_checkpoint="ckpt_base"
        )
        assert status == 502
        assert record["phase"] == "rolled_back"
        assert "500" in record["abort_reason"]
        assert record["backends"][b0.addr]["status"] == "rolled_back"
        assert record["backends"][b0.addr]["rollback_verified"] is True
        # b0: reload to the new checkpoint, then back to the baseline.
        assert b0.reload_calls == ["ckpt_new", "ckpt_base"]
        assert b0.checkpoint == "ckpt_base"
        assert b1.checkpoint is None  # never swapped
        block = record["rollout"]
        assert validate_rollout(block) == []
        assert block["rollouts_total"] == block["aborts_total"] == 1
        assert block["rollbacks_total"] == 1

        # The frontier serves again, and both backends answer the OLD
        # bits (ckpt_base and the in-memory boot weights are the same).
        assert frontier.state == "healthy"
        for _ in range(4):
            status, payload = frontier.handle_predict(
                {"image1": [], "image2": []}
            )
            assert status == 200
            assert payload["disparity"] == [[1.0, 0.5]]
        assert frontier._quiesced == set()
    finally:
        frontier.close()
        b0.close()
        b1.close()


def test_out_of_band_reload_is_detected_and_blocks_rollout():
    """Mixed-generation detection: reloading one backend BEHIND the
    orchestrator's back desyncs the swap counters — the ledger measures a
    nonzero mixed-generation window from live traffic stamps, /healthz
    flags the divergence, and /rollout refuses to extend the mixed fleet
    without force."""
    from raft_stereo_tpu_torch.utils.http import request_json

    b0, b1 = _FakeBackend(), _FakeBackend()
    frontier = _make_frontier([b0.addr, b1.addr]).start()
    try:
        resp = request_json(
            f"http://{b1.addr}/reload",
            method="POST",
            payload={"checkpoint": "ckpt_new"},
            timeout_s=10.0,
        )
        assert resp.status == 200  # the out-of-band operator action
        _poll(
            lambda: frontier.generation_divergence(),
            what="probes to observe the divergent generation",
        )

        # Live traffic now interleaves generation stamps: an old-gen
        # answer landing after a new-gen one is EXACTLY the mixed-weight
        # window the rollout flip exists to prevent.
        for _ in range(8):
            status, _ = frontier.handle_predict({"image1": [], "image2": []})
            assert status == 200
        snap = frontier.metrics()
        assert snap["generation_divergence"] is True
        assert snap["mixed_generation_seconds"] > 0.0
        assert snap["generation_stamps_total"] >= 8

        block = frontier.rollout_block()
        assert validate_rollout(block) == []
        assert block["zero_mixed_window"] is False
        assert frontier.healthz()["rollout"]["generation_divergence"] is True

        status, record = frontier.run_rollout("ckpt_other")
        assert status == 409
        assert "force" in record["error"]
        assert frontier.rollout_block()["rollouts_total"] == 0
    finally:
        frontier.close()
        b0.close()
        b1.close()


# -- real-fleet chaos drills -------------------------------------------------
