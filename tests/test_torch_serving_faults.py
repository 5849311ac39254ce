"""The port's serving fault lifecycle, on the CPU (mirrors
tests/test_serving_faults.py).

- `ServingLifecycle` against the JAX one: the same scripted successes,
  failures, hangs, swaps, probations and drains give the same states and
  snapshots after every step.
- Engine-free batcher units (a fake engine): a failed batch fails exactly
  its own futures and the counters reconcile; close() delivers the
  runner's sentinel past a full staging queue and strands no future; a
  bucket overflow is recorded before it raises.
- One warmed service, ORDER-DEPENDENT by design (break, observe, repair,
  drain): the breaker trips healthy -> degraded -> failed and then sheds
  without reaching the engine; HTTP answers 503 (not 413) while failed; a
  hot swap through POST /reload re-opens the breaker into probation,
  changes the outputs, and equals a model built fresh from the new
  weights; a mismatched candidate answers 409 and changes nothing; the
  hang watchdog dumps every thread's stack and fails the service while the
  hung batch is still running; a deadline-infeasible request sheds at
  admission; a poisoned stream frame drops only its own carry; drain()
  completes the backlog and closes.
"""

import os
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from raft_stereo_tpu.serving.lifecycle import ServingLifecycle as JaxServingLifecycle
from raft_stereo_tpu_torch.config import RAFTStereoConfig, ServeConfig, VideoConfig
from raft_stereo_tpu_torch.models import anytime
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.obs.trace import load_flight_recorder
from raft_stereo_tpu_torch.serving.batcher import MicroBatcher, _Request, _StagedBatch
from raft_stereo_tpu_torch.serving.engine import BatchResult
from raft_stereo_tpu_torch.serving.lifecycle import (
    CheckpointMismatchError,
    DeadlineInfeasibleError,
    ServiceUnavailableError,
    ServingLifecycle,
)
from raft_stereo_tpu_torch.serving.service import BucketOverflowError, StereoService, make_http_server
from raft_stereo_tpu_torch.utils.checkpoints import export_reference_state_dict, load_reference_checkpoint
from raft_stereo_tpu_torch.utils.http import request_json
from torch_parity import torch_single_thread  # noqa: F401 (autouse fixture)

HID = (32, 32, 32)
MODEL = RAFTStereoConfig(hidden_dims=HID, corr_implementation="pallas", fused_gru_tail=True)
BUCKET = (64, 96)
MAX_ITERS = 3
WAIT_S = 120


# -- the lifecycle against the JAX one ---------------------------------------

SCRIPTS = {
    "trip_and_swap": ["fail", "fail", "success", "fail", "fail", "fail", "fail", "fail", "success",
                      "swap", "success", "success", "success"],
    "probation_interrupted": ["fail", "fail", "success", "fail", "success", "success", "probation",
                              "success", "success"],
    "hang_then_swap": ["success", "hang", "success", "fail", "swap", "fail", "success", "success"],
    "drain_masks_all_but_failed": ["fail", "fail", "drain", "success", "resume", "fail", "fail", "fail",
                                   "drain", "swap"],
}


def _step(lc, event, i):
    if event == "success":
        lc.record_batch_success()
    elif event == "fail":
        lc.record_batch_failure(RuntimeError(f"failure {i}"))
    elif event == "hang":
        lc.record_hang(3.5, f"traces {i}")
    elif event == "swap":
        lc.note_swap(i)
    elif event == "probation":
        lc.enter_probation(f"respawn {i}")
    elif event == "drain":
        lc.start_drain()
    elif event == "resume":
        lc.stop_drain()


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_lifecycle_matches_jax(script):
    ours = ServingLifecycle(degrade_after=2, fail_after=5, probation=2, name="r0")
    theirs = JaxServingLifecycle(degrade_after=2, fail_after=5, probation=2, name="r0")
    seen_ours, seen_theirs = [], []
    ours.on_transition = lambda *t: seen_ours.append(t)
    theirs.on_transition = lambda *t: seen_theirs.append(t)
    for i, event in enumerate(SCRIPTS[script]):
        _step(ours, event, i)
        _step(theirs, event, i)
        assert ours.snapshot() == theirs.snapshot(), (i, event)
        assert (ours.state, ours.admissible()) == (theirs.state, theirs.admissible())
    assert seen_ours == seen_theirs and seen_ours
    assert (ours.last_hang_traces, ours.last_hang_elapsed_s) == (theirs.last_hang_traces, theirs.last_hang_elapsed_s)


def test_lifecycle_validates_thresholds_like_jax():
    for kw in ({"degrade_after": 0}, {"degrade_after": 6, "fail_after": 5}, {"probation": 0}):
        with pytest.raises(ValueError):
            JaxServingLifecycle(**kw)
        with pytest.raises(ValueError):
            ServingLifecycle(**kw)


# -- engine-free batcher units (a fake engine) -------------------------------

def _unit_config(**kw):
    kw.setdefault("buckets", ((32, 32),))
    kw.setdefault("max_batch", 2)
    kw.setdefault("chunk_iters", 1)
    kw.setdefault("max_iters", 1)
    return ServeConfig(model=RAFTStereoConfig(hidden_dims=HID), **kw)


class _FakeEngine:
    """Engine stand-in: an optional failure flag and an optional gate that
    holds run_staged until released."""

    def __init__(self, gate: threading.Event = None, chunk_s=None):
        self.lifecycle = ServingLifecycle()
        self.fail = False
        self.calls = 0
        self.gate = gate
        self.chunk_s = chunk_s or {}  # batch size -> warmed chunk seconds

    def chunk_estimate_s(self, bucket, batch):
        return self.chunk_s.get(batch, 0.0)

    def stage(self, staged):
        staged.image1, staged.image2, staged.flow_init = staged.i1_host, staged.i2_host, staged.flow_host

    def run_staged(self, staged):
        self.calls += 1
        if self.gate is not None:
            assert self.gate.wait(timeout=30), "test gate never released"
        if self.fail:
            raise RuntimeError("injected batch failure")
        b = staged.bucket
        return [BatchResult(flow_up=np.zeros((*b, 1), np.float32), iters_completed=1, early_exit=False,
                            flow_lowres=np.zeros((b[0] // 4, b[1] // 4), np.float32)) for _ in staged.reqs]


def _unit_request(bucket=(32, 32)):
    img = np.zeros((*bucket, 3), np.float32)
    return _Request(image1=img, image2=img, bucket=bucket, deadline_s=None, max_iters=1, future=Future(),
                    enqueue_t=time.monotonic())


# The H100's fp32 512x768 chunk times (ms) by batch size, a cliff at 4, and
# its 384x512 ones, none; then unwarmed sizes.
CLIFF = {1: 19.0, 2: 32.0, 4: 4168.0}
SMOOTH = {1: 11.1, 2: 18.3, 4: 31.3}


@pytest.mark.parametrize("chunk_ms, queued, want", [
    (CLIFF, 4, (2, 2)), (CLIFF, 3, (2, 2)), (CLIFF, 2, (2, 2)), (CLIFF, 1, (1, 1)),
    (SMOOTH, 4, (4, 4)), (SMOOTH, 3, (3, 4)), (SMOOTH, 2, (2, 2)),
    ({}, 3, (3, 4)), ({1: 10.0}, 3, (3, 4)),
], ids=["cliff-4", "cliff-3", "cliff-2", "cliff-1", "smooth-4", "smooth-3", "smooth-2", "unwarmed",
        "padded-unwarmed"])
def test_split_takes_a_smaller_warmed_size_only_past_a_cliff(chunk_ms, queued, want):
    """(rows taken, padded size): JAX's pad-up to the nearest warmed size,
    unless a warmed size costs less than half its time per real row."""
    engine = _FakeEngine(chunk_s={b: ms / 1e3 for b, ms in chunk_ms.items()})
    batcher = MicroBatcher(_unit_config(max_batch=4), engine)
    assert batcher._split((32, 32), queued) == want


def test_stager_splits_a_queue_past_a_cliff_oldest_first():
    """Four queued requests of a bucket whose batch of 4 is a cliff run as
    two batches of 2, in arrival order."""
    gate = threading.Event()
    engine = _FakeEngine(gate=gate, chunk_s={b: ms / 1e3 for b, ms in CLIFF.items()})
    batcher = MicroBatcher(_unit_config(max_batch=4, batch_window_ms=200.0), engine)
    order = []
    real_stage = engine.stage
    engine.stage = lambda staged: (order.append([r.enqueue_t for r in staged.reqs]), real_stage(staged))
    batcher.start()
    try:
        reqs = [_unit_request() for _ in range(4)]
        futs = [batcher.submit(r) for r in reqs]
        gate.set()
        for f in futs:
            f.result(timeout=30)
    finally:
        batcher.close()
    assert list(batcher.metrics.batch_log) == [((32, 32), 2, 2), ((32, 32), 2, 2)]
    assert order == [[r.enqueue_t for r in reqs[:2]], [r.enqueue_t for r in reqs[2:]]]


def test_run_loop_batch_failure_isolated_and_counters_reconcile():
    engine = _FakeEngine()
    batcher = MicroBatcher(_unit_config(), engine)
    batcher.start()
    try:
        engine.fail = True
        bad = [batcher.submit(_unit_request()) for _ in range(2)]
        for f in bad:
            with pytest.raises(RuntimeError, match="injected batch failure"):
                f.result(timeout=30)
        engine.fail = False
        good = [batcher.submit(_unit_request()) for _ in range(2)]
        for f in good:
            res, latency_ms = f.result(timeout=30)
            assert res.iters_completed == 1 and latency_ms >= 0.0
        snap = batcher.metrics.snapshot()
        assert (snap["requests_total"], snap["responses_total"], snap["failed_requests_total"]) == (4, 2, 2)
        assert engine.lifecycle.batch_failures_total >= 1 and engine.lifecycle.batch_successes_total >= 1
    finally:
        batcher.close()
    assert not batcher._runner.is_alive() and not batcher._stager.is_alive()


def test_close_delivers_runner_sentinel_when_staging_queue_full():
    gate = threading.Event()
    engine = _FakeEngine(gate=gate)
    batcher = MicroBatcher(_unit_config(), engine)
    # The leak window: runner alive, stager gone without its sentinel,
    # staging queue occupied.
    dead_stager = threading.Thread(target=lambda: None)
    dead_stager.start()
    dead_stager.join()
    batcher._stager = dead_stager
    batcher._runner.start()

    def _batch():
        r = _unit_request()
        b = _StagedBatch(reqs=[r], bucket=r.bucket, i1_host=r.image1[None], i2_host=r.image1[None],
                         flow_host=None, padded=1)
        engine.stage(b)
        return b

    first, second = _batch(), _batch()
    batcher._staged.put(first)  # the runner takes it and waits on the gate
    batcher._staged.put(second)  # holds the queue's one slot
    release = threading.Timer(0.3, gate.set)
    release.start()
    t0 = time.monotonic()
    batcher.close()
    release.cancel()
    assert not batcher._runner.is_alive(), "runner thread leaked past close()"
    assert time.monotonic() - t0 < 15.0
    assert all(b.reqs[0].future.done() for b in (first, second)), "close() stranded a future"


def test_start_warms_on_the_runner_thread_and_reraises_its_failure():
    """The warm-up runs on the thread that will launch every batch (CUDA
    libraries keep per-thread handles); a failing warm-up raises from
    start() and leaves no thread running."""
    batcher = MicroBatcher(_unit_config(), _FakeEngine())
    names = []
    assert batcher.start(warm=lambda: names.append(threading.current_thread().name) or "summary") == "summary"
    try:
        assert names == ["serving-runner"]
        assert batcher.submit(_unit_request()).result(timeout=30)[0].iters_completed == 1
    finally:
        batcher.close()
    failing = MicroBatcher(_unit_config(), _FakeEngine())

    def boom():
        raise RuntimeError("warm-up failed")

    with pytest.raises(RuntimeError, match="warm-up failed"):
        failing.start(warm=boom)
    assert not failing._runner.is_alive() and not failing._stager.is_alive()


def test_stage_failure_fails_only_that_batch():
    """A batch whose copy to the device raises is failed like one whose run
    raises: its futures get the exception, the breaker counts it, and the
    batcher goes on serving."""
    engine = _FakeEngine()
    real_stage = engine.stage
    calls = {"n": 0}

    def stage(staged):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected staging failure")
        real_stage(staged)

    engine.stage = stage
    batcher = MicroBatcher(_unit_config(max_batch=1), engine)
    batcher.start()
    try:
        with pytest.raises(RuntimeError, match="injected staging failure"):
            batcher.submit(_unit_request()).result(timeout=30)
        assert batcher.submit(_unit_request()).result(timeout=30)[0].iters_completed == 1
        assert engine.lifecycle.batch_failures_total == 1
        assert batcher.metrics.snapshot()["failed_requests_total"] == 1
    finally:
        batcher.close()


def test_submit_records_reject_before_bucket_overflow_raises():
    service = StereoService(ServeConfig(model=MODEL, buckets=(BUCKET,), max_batch=1, chunk_iters=1,
                                        max_iters=MAX_ITERS), device="cpu")
    recorded = []
    real = service.batcher.metrics.record_reject
    service.batcher.metrics.record_reject = lambda: (recorded.append(True), real())[-1]
    huge = np.zeros((BUCKET[0] * 2, BUCKET[1], 3), np.float32)
    with pytest.raises(BucketOverflowError):
        service.submit(huge, huge)
    assert recorded and service.batcher.metrics.snapshot()["rejected_total"] == 1


# -- the shared warmed service ------------------------------------------------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One warmed service with the fault knobs tightened for test speed:
    degrade after 1 failed batch, fail after 3, 2-success probation, a 2 s
    hang watchdog; streams on with the reset gate open (random weights give
    junk flows, whose warp errors mean nothing); log_dir set so breaker
    moves and the watchdog dump the flight recorder."""
    cfg = ServeConfig(
        model=MODEL, log_dir=str(tmp_path_factory.mktemp("faults_obs")), buckets=(BUCKET,), max_batch=2,
        chunk_iters=1, max_iters=MAX_ITERS,
        video=VideoConfig(chunk_iters=1, cold_iters=MAX_ITERS, warm_iters=1, reset_error_floor=1e9),
        breaker_degrade_after=1, breaker_fail_after=3, breaker_probation=2, hang_timeout_s=2.0,
        drain_timeout_s=60.0,
    )
    service = StereoService(cfg, device="cpu", seed=3).start()
    server = make_http_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    service.url = f"http://127.0.0.1:{server.server_address[1]}"
    yield service
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    service.close()


_rng = np.random.default_rng(20261018)
PAIR = tuple(_rng.uniform(0, 255, (*BUCKET, 3)).astype(np.float32) for _ in range(2))
BASELINE = {}


def _fail_run_batch(monkeypatch, engine, failures=None):
    """run_batch raises for its first `failures` calls (None: every call)."""
    real = engine.run_batch
    counter = {"calls": 0}

    def injected(*args, **kwargs):
        counter["calls"] += 1
        if failures is None or counter["calls"] <= failures:
            raise RuntimeError("injected device failure in run_batch")
        return real(*args, **kwargs)

    monkeypatch.setattr(engine, "run_batch", injected)
    return counter


def test_baseline_traffic_healthy(served):
    res = served.submit(*PAIR).result(timeout=WAIT_S)
    assert res["iters_completed"] == MAX_ITERS
    BASELINE["disparity"] = res["disparity"]
    health = served.healthz()["serving"]
    assert health["state"] == "healthy" and health["swap_generation"] == 0
    assert health["lifecycle"]["breaker"]["fail_after"] == 3


def test_breaker_trips_to_failed_and_sheds(served, monkeypatch):
    counter = _fail_run_batch(monkeypatch, served.engine)
    for expect in ("degraded", "degraded", "failed"):
        with pytest.raises(RuntimeError, match="injected device failure"):
            served.submit(*PAIR).result(timeout=WAIT_S)
        # The runner records the failure before it resolves the future.
        assert served.lifecycle.state == expect
    assert counter["calls"] == 3
    with pytest.raises(ServiceUnavailableError, match="state=failed"):
        served.submit(*PAIR)
    assert counter["calls"] == 3, "a shed request still reached the failing engine"
    snap = served.metrics()
    assert snap["shed_total"] >= 1 and snap["failed_requests_total"] == 3
    payload = load_flight_recorder(os.path.join(served.config.log_dir, "flight_recorder.json"))
    assert payload["reason"] == "breaker:degraded->failed"
    records = payload["records"]
    moves = {(r["attrs"]["frm"], r["attrs"]["to"]) for r in records if r.get("name") == "breaker_transition"}
    assert moves >= {("healthy", "degraded"), ("degraded", "failed")}
    admitted = {r["trace"] for r in records if r.get("name") == "admission"}
    failed = {t for r in records if r.get("name") == "batch_failure" for t in r["attrs"]["traces"]}
    assert failed and failed <= admitted


def test_http_maps_failed_state_to_503_not_413(served):
    assert served.lifecycle.state == "failed"
    resp = request_json(f"{served.url}/v1/predict", method="POST", timeout_s=WAIT_S,
                        payload={"image1": PAIR[0].tolist(), "image2": PAIR[1].tolist()})
    assert resp.status == 503 and resp.json()["state"] == "failed"
    # Even an input no bucket fits sheds with 503 first: the state gate
    # runs before admission.
    big = np.zeros((BUCKET[0] * 2, BUCKET[1], 3)).tolist()
    resp = request_json(f"{served.url}/v1/predict", method="POST", timeout_s=WAIT_S,
                        payload={"image1": big, "image2": big})
    assert resp.status == 503
    health = request_json(f"{served.url}/healthz").json()["serving"]
    assert health["state"] == "failed" and health["lifecycle"]["batch_failures_total"] == 3
    assert health["lifecycle"]["last_failure"]
    resp = request_json(f"{served.url}/reload", method="POST", payload={"checkpoint": "/nonexistent/ckpt.pth"})
    assert resp.status == 400 and served.lifecycle.state == "failed"


def _perturbed_pth(served, path, scale=1.05, hidden=HID):
    model = build_model(RAFTStereoConfig(hidden_dims=hidden), seed=3, device="cpu")
    with torch.no_grad():
        for t in model.state_dict().values():
            t.mul_(scale)
    torch.save(export_reference_state_dict(model), path)
    return path


def test_hot_swap_recovers_breaker_and_changes_outputs(served, tmp_path):
    assert served.lifecycle.state == "failed"
    path = _perturbed_pth(served, str(tmp_path / "swap.pth"))
    resp = request_json(f"{served.url}/reload", method="POST", payload={"checkpoint": path}, timeout_s=WAIT_S)
    assert resp.status == 200, resp.body
    body = resp.json()
    assert body["swap_generation"] == 1 and body["previous_generation"] == 0 and body["checkpoint"] == path
    assert served.lifecycle.state == "degraded", "a swap re-opens the breaker into probation"
    res1 = served.submit(*PAIR).result(timeout=WAIT_S)
    assert served.lifecycle.state == "degraded"
    res2 = served.submit(*PAIR).result(timeout=WAIT_S)
    assert served.lifecycle.state == "healthy"
    assert not np.array_equal(res1["disparity"], BASELINE["disparity"]), "the new weights are not live"
    np.testing.assert_array_equal(res1["disparity"], res2["disparity"])
    # The swapped service computes what a model built fresh from the new
    # weights computes.
    fresh = load_reference_checkpoint(build_model(MODEL, seed=9, device="cpu"), path)
    with torch.inference_mode():
        _, up = fresh(*(torch.from_numpy(p[None]) for p in PAIR), iters=MAX_ITERS, test_mode=True)
    np.testing.assert_array_equal(res1["disparity"], up[0, :, :, 0].numpy())
    assert served.lifecycle.snapshot()["swaps_total"] == 1
    assert served.healthz()["serving"]["checkpoint"] == path


def test_swap_rejects_mismatched_candidates_atomically(served, tmp_path):
    gen = served.engine.swap_generation
    before = {k: v.clone() for k, v in served.engine.model.state_dict().items()}
    # A reference .pth of another width: 409 over HTTP.
    wrong = _perturbed_pth(served, str(tmp_path / "wrong.pth"), hidden=(48, 48, 48))
    resp = request_json(f"{served.url}/reload", method="POST", payload={"checkpoint": wrong})
    assert resp.status == 409 and "shape" in resp.json()["error"]
    # The JAX package's orbax directory: 409, not readable by the port.
    resp = request_json(f"{served.url}/reload", method="POST", payload={"checkpoint": str(tmp_path)})
    assert resp.status == 409 and "orbax checkpoints are not readable by the port" in resp.json()["error"]
    # In process: a shape, a dtype and a key off; nothing is copied even
    # where the earlier keys would fit.
    good = {k: v.clone() for k, v in before.items()}
    name = next(reversed(good))
    for bad, match in (({**good, name: good[name][..., :-1] if good[name].dim() else good[name][None]}, "shape"),
                       ({k: v.double() for k, v in good.items()}, "dtype|float64"),
                       ({**good, "extra.weight": torch.zeros(1)}, "unexpected")):
        with pytest.raises(CheckpointMismatchError, match=match):
            served.engine.swap_variables(bad)
    assert served.engine.swap_generation == gen and served.lifecycle.state == "healthy"
    for k, v in served.engine.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert served.submit(*PAIR).result(timeout=WAIT_S)["iters_completed"] == MAX_ITERS


def test_hung_chunk_watchdog_dumps_stacks_and_fails(served, monkeypatch):
    """A chunk that stops heartbeating past hang_timeout_s (2 s; the
    injected sleep is 5 s) gives all-thread stacks and a `failed` verdict
    while the batch is still running; the hung request still completes."""
    assert served.lifecycle.state == "healthy"
    real = anytime.chunk
    calls = {"n": 0}

    def sleepy(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(5.0)
        return real(*args, **kwargs)

    monkeypatch.setattr(anytime, "chunk", sleepy)
    fut = served.submit(*PAIR)
    deadline = time.monotonic() + 4.5
    while time.monotonic() < deadline and served.lifecycle.state != "failed":
        time.sleep(0.05)
    assert served.lifecycle.state == "failed", "the watchdog did not flag the hung chunk in time"
    assert not fut.done(), "the verdict must not wait for the hang to end"
    snap = served.lifecycle.snapshot()
    assert snap["hangs_total"] == 1 and "hung chunk" in snap["last_failure"]
    assert "serving-runner" in served.lifecycle.last_hang_traces
    assert fut.result(timeout=WAIT_S)["iters_completed"] == MAX_ITERS
    monkeypatch.setattr(anytime, "chunk", real)
    payload = load_flight_recorder(os.path.join(served.config.log_dir, "flight_recorder.json"))
    assert payload["reason"] == "watchdog"
    names = {r.get("name") for r in payload["records"]}
    assert {"watchdog_fire", "admission", "queue", "stage", "chunk"} <= names, names
    assert any(r["attrs"]["to"] == "failed" for r in payload["records"] if r.get("name") == "breaker_transition")
    # Operator repair: a swap of the same values, then probation.
    served.engine.swap_variables({k: v.clone() for k, v in served.engine.model.state_dict().items()})
    assert served.lifecycle.state == "degraded"
    for _ in range(2):
        served.submit(*PAIR).result(timeout=WAIT_S)
    assert served.lifecycle.state == "healthy"


def test_deadline_infeasible_request_sheds_at_admission(served):
    assert served.engine.chunk_estimate_s(BUCKET, 1) > 0
    served.engine._lock.acquire()
    try:
        backlog = [served.submit(*PAIR) for _ in range(5)]
        deadline = time.monotonic() + 30.0
        while served.batcher.queue_depth() < 1:
            assert time.monotonic() < deadline, "the backlog never queued"
            time.sleep(0.01)
        before = served.metrics()["deadline_infeasible_total"]
        with pytest.raises(DeadlineInfeasibleError, match="infeasible"):
            served.submit(*PAIR, deadline_ms=0.01)
        assert served.metrics()["deadline_infeasible_total"] == before + 1
    finally:
        served.engine._lock.release()
    for fut in backlog:
        assert fut.result(timeout=WAIT_S)["disparity"].shape == BUCKET
    assert served.lifecycle.state == "healthy"


def test_poisoned_stream_frame_drops_only_its_carry(served, monkeypatch):
    for sid in ("stream-a", "stream-b"):
        r0 = served.submit_stream(sid, *PAIR).result(timeout=WAIT_S)
        assert r0["warm_started"] is False and r0["stream_frame"] == 0
        r1 = served.submit_stream(sid, *PAIR).result(timeout=WAIT_S)
        assert r1["warm_started"] is True and r1["stream_frame"] == 1
    with monkeypatch.context() as m:
        _fail_run_batch(m, served.engine, failures=1)
        with pytest.raises(RuntimeError, match="injected device failure"):
            served.submit_stream("stream-a", *PAIR).result(timeout=WAIT_S)
    assert "stream-a" not in served._streams, "the poisoned carry stayed"
    ra = served.submit_stream("stream-a", *PAIR).result(timeout=WAIT_S)
    assert ra["warm_started"] is False and ra["stream_frame"] == 0
    rb = served.submit_stream("stream-b", *PAIR).result(timeout=WAIT_S)
    assert rb["warm_started"] is True, "the sibling stream lost its carry"
    nan_img = np.full_like(PAIR[0], np.nan)
    rn = served.submit_stream("stream-b", nan_img, nan_img).result(timeout=WAIT_S)
    assert rn["disparity"].shape == BUCKET
    assert "stream-b" not in served._streams, "a non-finite carry was stored"
    assert served.lifecycle.state == "healthy"


def test_drain_completes_backlog_then_closes(served):
    """LAST (closes the module's service): drain() stops admission (503
    while `draining`) yet every admitted request completes."""
    served.engine._lock.acquire()
    backlog = [served.submit(*PAIR) for _ in range(4)]
    out = {}
    drainer = threading.Thread(target=lambda: out.setdefault("drained", served.drain(timeout_s=WAIT_S)))
    try:
        drainer.start()
        deadline = time.monotonic() + 30.0
        while served.lifecycle.state != "draining":
            assert time.monotonic() < deadline, "drain never closed admission"
            time.sleep(0.01)
        with pytest.raises(ServiceUnavailableError, match="state=draining"):
            served.submit(*PAIR)
        resp = request_json(f"{served.url}/v1/predict", method="POST", timeout_s=WAIT_S,
                            payload={"image1": PAIR[0].tolist(), "image2": PAIR[1].tolist()})
        assert resp.status == 503 and resp.json()["state"] == "draining"
    finally:
        served.engine._lock.release()
    drainer.join(timeout=WAIT_S)
    assert not drainer.is_alive() and out["drained"] is True
    for fut in backlog:
        assert fut.result(timeout=1)["disparity"].shape == BUCKET
    assert not served.batcher._runner.is_alive() and not served.batcher._stager.is_alive()
