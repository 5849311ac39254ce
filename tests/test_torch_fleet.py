"""The port's engine fleet on the CPU (mirrors tests/test_serving_fleet.py),
with two replicas on one device: `devices=["cpu", "cpu"]`.

ORDER-DEPENDENT by design, like the JAX suite (one warmed fleet service:
baseline, break, repair, hang, roll, roll back, respawn, drain):

- `replicas=1` is the single engine, not a one-replica fleet; its answer
  matches the JAX package's plain `RAFTStereo` forward on the same weights
  to 1e-4, and the fleet serves the same bits;
- a healthy boot: every replica healthy, least-loaded routing claims
  distinct replicas, and answers are bit for bit the same;
- a bucket overflow is recorded before it raises;
- a persistently failing replica: every request is requeued once onto the
  other, answered bit for bit, nothing shed or failed, and only that
  replica's breaker walks to `failed` (the service reads `degraded`);
- a rolling swap re-enters the failed replica in probation and traffic
  walks it healthy, with new outputs;
- a hung chunk past the watchdog: the call is abandoned and its batch
  requeued, the answer bit for bit;
- a rolling swap under traffic drops nothing; a mid-roll refusal rolls the
  swapped replica back;
- `auto_respawn` replaces a sticky-failed replica with a fresh engine that
  probation traffic walks back to `healthy`;
- drain completes the backlog across both replicas and closes.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu_torch.config import RAFTStereoConfig, ServeConfig
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.serving.engine import AnytimeEngine
from raft_stereo_tpu_torch.serving.fleet import EngineFleet
from raft_stereo_tpu_torch.serving.lifecycle import CheckpointMismatchError, ServiceUnavailableError
from raft_stereo_tpu_torch.serving.service import BucketOverflowError, StereoService
from raft_stereo_tpu_torch.utils.checkpoints import load_jax_variables
from torch_parity import halve_kernels, jax_apply, jax_init, torch_single_thread  # noqa: F401 (autouse fixture)

HID = (16, 16, 16)
KERNEL = {"corr_implementation": "pallas", "fused_gru_tail": True}
BUCKET = (32, 64)
CHUNK_ITERS = 1
MAX_ITERS = 2
REPLICAS = 2
DEVICES = ["cpu", "cpu"]
WAIT_S = 120


def _fleet_config(**kw):
    kw.setdefault("buckets", (BUCKET,))
    kw.setdefault("max_batch", 2)
    kw.setdefault("chunk_iters", CHUNK_ITERS)
    kw.setdefault("max_iters", MAX_ITERS)
    kw.setdefault("batch_window_ms", 2.0)
    kw.setdefault("replicas", REPLICAS)
    kw.setdefault("breaker_degrade_after", 1)
    kw.setdefault("breaker_fail_after", 2)
    kw.setdefault("breaker_probation", 2)
    kw.setdefault("hang_timeout_s", 2.0)
    kw.setdefault("drain_timeout_s", 60.0)
    return ServeConfig(model=RAFTStereoConfig(hidden_dims=HID, **KERNEL), **kw)


@pytest.fixture(scope="module")
def weights():
    img = jnp.zeros((1, *BUCKET, 3))
    v = jax_init(JaxRAFTStereo(JaxConfig(hidden_dims=HID)), img, img, iters=1)
    return {"params": halve_kernels(v["params"]), "batch_stats": v["batch_stats"]}


def _model(weights):
    return load_jax_variables(RAFTStereo(RAFTStereoConfig(hidden_dims=HID, **KERNEL)), weights).eval()


@pytest.fixture(scope="module")
def served(weights):
    """One warmed 2-replica fleet: degrade after 1 failed batch, fail after
    2, 2-success probation, a 2 s hang watchdog."""
    service = StereoService(_fleet_config(), _model(weights), devices=DEVICES).start()
    yield service
    service.close()


_rng = np.random.default_rng(20261018)
PAIR = tuple(_rng.uniform(0, 255, (*BUCKET, 3)).astype(np.float32) for _ in range(2))
BASELINE = {}


def _quiesce(fleet, timeout_s: float = 30.0) -> None:
    """Wait for every in-flight batch to release its replica, so the next
    submit's routing is deterministic (ties go to the lowest index)."""
    deadline = time.monotonic() + timeout_s
    while any(r.in_flight for r in fleet.replicas):
        assert time.monotonic() < deadline, "fleet never quiesced"
        time.sleep(0.005)


def _replica_states(fleet):
    return [r.lifecycle.state for r in fleet.replicas]


def _submit_one(service):
    _quiesce(service.engine)
    return service.submit(*PAIR, max_iters=MAX_ITERS).result(timeout=WAIT_S)


def _scaled(state, scale):
    return {k: v * scale if v.is_floating_point() else v.clone() for k, v in state.items()}


def test_replicas_one_is_single_engine_not_a_fleet(weights):
    with StereoService(_fleet_config(replicas=1), _model(weights), device="cpu") as single:
        assert isinstance(single.engine, AnytimeEngine) and not isinstance(single.engine, EngineFleet)
        assert single.healthz()["serving"]["replicas"] == 1
        res = single.submit(*PAIR, max_iters=MAX_ITERS).result(timeout=WAIT_S)
    assert res["iters_completed"] == MAX_ITERS
    _, want = jax_apply(JaxRAFTStereo(JaxConfig(hidden_dims=HID)), weights, PAIR[0][None], PAIR[1][None],
                        iters=MAX_ITERS, test_mode=True)
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(res["disparity"], want[0, :, :, 0], rtol=1e-4, atol=1e-4)
    BASELINE["single_engine"] = res["disparity"]


def test_fleet_boots_healthy_and_serves_bit_identical(served):
    fleet = served.engine
    assert isinstance(fleet, EngineFleet) and fleet.n_replicas == REPLICAS and fleet.warmed
    assert [str(r.device) for r in fleet.replicas] == DEVICES
    # Each replica holds its own weights.
    w0, w1 = (r.engine.model.fnet.conv2.weight for r in fleet.replicas)
    assert torch.equal(w0, w1) and w0.data_ptr() != w1.data_ptr()
    health = served.healthz()["serving"]
    assert health["state"] == "healthy" and health["replicas"] == REPLICAS
    assert health["lifecycle"]["replica_states"] == ["healthy"] * REPLICAS
    assert [s["name"] for s in health["lifecycle"]["replicas"]] == ["replica0", "replica1"]
    assert health["swap_generation"] == 0 and health["device"] == "cpu,cpu"

    fleet.metrics, saved = None, fleet.metrics
    try:
        a, b = fleet._acquire_replica(), fleet._acquire_replica()
        assert {a.idx, b.idx} == {0, 1}
        fleet._release_replica(a)
        fleet._release_replica(b)
    finally:
        fleet.metrics = saved

    outs = [_submit_one(served) for _ in range(3)]
    assert all(o["iters_completed"] == MAX_ITERS for o in outs)
    for o in outs:
        np.testing.assert_array_equal(o["disparity"], BASELINE["single_engine"])
    BASELINE["healthy"] = outs[0]["disparity"]
    assert served.lifecycle.state == "healthy"


def test_fleet_submit_records_reject_before_overflow_raises(weights):
    service = StereoService(_fleet_config(buckets=((32, 32),)), _model(weights), devices=DEVICES)
    recorded = []
    real = service.batcher.metrics.record_reject
    service.batcher.metrics.record_reject = lambda: (recorded.append(True), real())
    huge = np.zeros((64, 64, 3), np.float32)
    with pytest.raises(BucketOverflowError):
        service.submit(huge, huge)
    assert recorded and service.batcher.metrics.snapshot()["rejected_total"] == 1
    service.engine.close()


def test_poisoned_replica_fails_over_with_zero_shed(served, monkeypatch):
    fleet = served.engine
    before = served.metrics()
    calls = {"n": 0}

    def poisoned(*args, **kwargs):
        calls["n"] += 1
        raise RuntimeError("injected device failure on replica 0")

    monkeypatch.setattr(fleet.replicas[0].engine, "run_batch", poisoned)
    outs = [_submit_one(served) for _ in range(3)]
    for o in outs:
        np.testing.assert_array_equal(o["disparity"], BASELINE["healthy"])
    # Submits 1 and 2 route to replica 0 (degraded, then failed) and are
    # requeued; submit 3 routes straight to replica 1.
    assert calls["n"] == 2
    snap = served.metrics()
    assert snap["requeues_total"] - before["requeues_total"] == 2
    assert snap["shed_total"] == before["shed_total"]
    assert snap["failed_requests_total"] == before["failed_requests_total"]
    assert _replica_states(fleet) == ["failed", "healthy"]
    assert served.lifecycle.state == "degraded"
    assert served.healthz()["serving"]["lifecycle"]["replica_states"] == ["failed", "healthy"]


def test_rolling_swap_repairs_failed_replica(served):
    fleet = served.engine
    gen0 = fleet.swap_generation
    assert fleet.swap_variables(_scaled(fleet.variables, 1.05)) == gen0 + 1
    assert _replica_states(fleet) == ["degraded", "healthy"]
    outs = [_submit_one(served) for _ in range(fleet.config.breaker_probation)]
    _quiesce(fleet)
    assert _replica_states(fleet) == ["healthy", "healthy"] and served.lifecycle.state == "healthy"
    assert not np.array_equal(outs[0]["disparity"], BASELINE["healthy"])
    for o in outs[1:]:
        np.testing.assert_array_equal(o["disparity"], outs[0]["disparity"])
    BASELINE["swapped"] = outs[0]["disparity"]
    assert served.healthz()["serving"]["swap_generation"] == gen0 + 1


def test_hung_replica_abandoned_and_requeued(served):
    """A chunk on replica 0 that sleeps past the 2 s watchdog: replica 0
    goes `failed`, the fleet abandons the call and requeues the batch onto
    replica 1, and the client gets a normal answer, bit for bit."""
    fleet = served.engine
    before = served.metrics()
    hangs0 = fleet.lifecycle.snapshot()["hangs_total"]
    model0 = fleet.replicas[0].engine.model
    real = model0.iteration_step
    calls = {"n": 0}

    def sleepy(state):
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(6.0)
        return real(state)

    model0.iteration_step = sleepy
    try:
        res = _submit_one(served)
    finally:
        del model0.iteration_step
    np.testing.assert_array_equal(res["disparity"], BASELINE["swapped"])
    snap = served.metrics()
    assert snap["requeues_total"] - before["requeues_total"] == 1
    assert snap["shed_total"] == before["shed_total"]
    assert fleet.lifecycle.snapshot()["hangs_total"] == hangs0 + 1
    assert _replica_states(fleet) == ["failed", "healthy"] and served.lifecycle.state == "degraded"

    # Wait out the wedged call, then repair with a same-value swap.
    r0 = fleet.replicas[0].engine
    assert r0._lock.acquire(timeout=60), "the wedged call never released its lock"
    r0._lock.release()
    fleet.swap_variables(_scaled(fleet.variables, 1.0))
    outs = [_submit_one(served) for _ in range(fleet.config.breaker_probation)]
    _quiesce(fleet)
    assert _replica_states(fleet) == ["healthy", "healthy"]
    for o in outs:
        np.testing.assert_array_equal(o["disparity"], BASELINE["swapped"])


def test_rolling_swap_under_traffic_drops_nothing(served):
    fleet = served.engine
    before = served.metrics()
    gen0 = fleet.swap_generation
    new = _scaled(fleet.variables, 1.1)
    results, errors = [], []

    def _client():
        for _ in range(4):
            try:
                results.append(served.submit(*PAIR, max_iters=MAX_ITERS).result(timeout=WAIT_S))
            except Exception as exc:  # noqa: BLE001 - collected and failed below
                errors.append(exc)

    clients = [threading.Thread(target=_client) for _ in range(3)]
    for t in clients:
        t.start()
    time.sleep(0.05)
    assert fleet.swap_variables(new) == gen0 + 1
    for t in clients:
        t.join(timeout=WAIT_S)
        assert not t.is_alive()
    assert not errors, f"the rolling swap dropped requests: {errors!r}"
    assert len(results) == 12 and all(r["disparity"].shape == BUCKET for r in results)
    snap = served.metrics()
    assert snap["shed_total"] == before["shed_total"]
    assert snap["failed_requests_total"] == before["failed_requests_total"]
    outs = [_submit_one(served) for _ in range(3)]
    assert not np.array_equal(outs[0]["disparity"], BASELINE["swapped"])
    for o in outs[1:]:
        np.testing.assert_array_equal(o["disparity"], outs[0]["disparity"])
    BASELINE["rolled"] = outs[0]["disparity"]
    assert served.lifecycle.state == "healthy"


def test_midroll_mismatch_aborts_and_rolls_back(served, monkeypatch):
    fleet = served.engine
    gen0 = fleet.swap_generation
    with pytest.raises(CheckpointMismatchError):
        fleet.swap_variables({"bogus": torch.zeros(1)})
    assert fleet.swap_generation == gen0

    def _refuse(state):
        raise CheckpointMismatchError("injected mid-roll refusal")

    monkeypatch.setattr(fleet.replicas[1].engine, "swap_variables", _refuse)
    with pytest.raises(CheckpointMismatchError, match="mid-roll refusal"):
        fleet.swap_variables(_scaled(fleet.variables, 1.3))
    monkeypatch.undo()
    assert fleet.swap_generation == gen0
    for r in fleet.replicas:  # replica 0 was swapped, then rolled back
        assert torch.equal(r.engine.model.fnet.conv2.weight, fleet.replicas[1].engine.model.fnet.conv2.weight)
    outs = [_submit_one(served) for _ in range(3)]
    for o in outs:
        np.testing.assert_array_equal(o["disparity"], BASELINE["rolled"])
    assert served.lifecycle.state == "healthy"


def test_auto_respawn_heals_sticky_failed_replica(weights, monkeypatch):
    """With `auto_respawn`, the failure that trips replica 0 sticky-`failed`
    starts a replacement boot; the fresh engine (same device, the serving
    weights) enters probation and traffic walks it healthy. Every answer
    along the way is the baseline's, bit for bit."""
    service = StereoService(_fleet_config(auto_respawn=True), _model(weights), devices=DEVICES).start()
    try:
        fleet = service.engine
        old = fleet.replicas[0].engine
        monkeypatch.setattr(old, "run_batch", lambda *a, **k: (_ for _ in ()).throw(RuntimeError("poisoned")))
        for _ in range(2):
            np.testing.assert_array_equal(_submit_one(service)["disparity"], BASELINE["healthy"])
        deadline = time.monotonic() + 60
        while fleet.respawns_total < 1:
            assert time.monotonic() < deadline, "no respawn"
            time.sleep(0.02)
        assert fleet.replicas[0].engine is not old and fleet.replicas[0].engine.warmed
        assert _replica_states(fleet) == ["degraded", "healthy"]
        summary = fleet.last_respawn
        assert summary["replica"] == 0 and summary["reason"].startswith("auto")
        assert summary["warm_seconds"] > 0 and summary["memory_allocated_after"] >= 0
        assert service.metrics()["respawns_total"] == 1 and service.boot_block()["respawns_total"] == 1
        outs = [_submit_one(service) for _ in range(4)]
        _quiesce(fleet)
        assert _replica_states(fleet) == ["healthy", "healthy"] and service.lifecycle.state == "healthy"
        assert fleet.metrics.batches_by_replica["0"] >= 1  # the new replica 0 served
        for o in outs:
            np.testing.assert_array_equal(o["disparity"], BASELINE["healthy"])
    finally:
        service.close()


def test_fleet_drain_completes_backlog_then_closes(served):
    """LAST (closes the module service): both replicas' run locks held and a
    backlog queued; drain() closes admission fleet-wide and completes every
    admitted request before the batcher's threads end."""
    fleet = served.engine
    locks = [r.engine._lock for r in fleet.replicas]
    for lk in locks:
        assert lk.acquire(timeout=60)
    backlog = [served.submit(*PAIR) for _ in range(5)]
    out = {}
    drainer = threading.Thread(target=lambda: out.setdefault("drained", served.drain(timeout_s=120)))
    try:
        drainer.start()
        deadline = time.monotonic() + 30.0
        while served.lifecycle.state != "draining":
            assert time.monotonic() < deadline, "drain never closed admission"
            time.sleep(0.01)
        with pytest.raises(ServiceUnavailableError, match="state=draining"):
            served.submit(*PAIR)
    finally:
        for lk in locks:
            lk.release()
    drainer.join(timeout=WAIT_S)
    assert not drainer.is_alive() and out["drained"] is True
    for fut in backlog:
        assert fut.result(timeout=1)["disparity"].shape == BUCKET
    assert not any(r.is_alive() for r in served.batcher._runners)
    assert not served.batcher._stager.is_alive()
