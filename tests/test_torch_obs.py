"""The port's observability and run-report copies against the JAX
package's, on the CPU (mirrors tests/test_obs.py):

- `Registry`: the same operations give the same Prometheus exposition text;
- `FlightRecorder` / `Tracer`: the same spans and events give the same
  records (timing fields aside), counters and dumps;
- `observability_block`, `ServingMetrics` (the same `record_*` calls give
  equal snapshots and attribution summaries), the percentile edges;
- `memory_block` on the CPU: the JAX keys plus `platform`, "cpu", no
  device numbers;
- `build_run_report` / `validate_run_report`: equal reports, and equal
  verdicts on broken ones;
- the hang watchdog: it fires once per stall past its budget with every
  thread's stack while a batch is watched, stays quiet while beaten and
  while no batch runs, and an engine at timeout 0 has none;
- the HTTP client: answered statuses come back as responses.
"""

import copy
import io
import json
import threading
import time

import numpy as np
import pytest

from raft_stereo_tpu.obs import prom as jax_prom
from raft_stereo_tpu.obs import trace as jax_trace
from raft_stereo_tpu.obs.memory import memory_block as jax_memory_block
from raft_stereo_tpu.serving.batcher import ServingMetrics as JaxServingMetrics
from raft_stereo_tpu.utils import run_report as jax_run_report
from raft_stereo_tpu_torch.obs import prom, trace
from raft_stereo_tpu_torch.obs.memory import memory_block, set_memory_gauges
from raft_stereo_tpu_torch.serving.batcher import ServingMetrics
from raft_stereo_tpu_torch.config import RAFTStereoConfig, ServeConfig
from raft_stereo_tpu_torch.serving.engine import AnytimeEngine
from raft_stereo_tpu_torch.utils import http, run_report
from raft_stereo_tpu_torch.utils.resilience import HangWatchdog
from torch_parity import torch_single_thread  # noqa: F401 (autouse fixture)


# -- Prometheus exposition ------------------------------------------------------

def _registry_ops(mod):
    reg = mod.Registry()
    c = reg.counter("raft_serving_requests_total", "requests")
    c.inc()
    c.inc(2.0)
    c.inc(5.0, bucket="64x96")
    c.set_total(10.0)
    reg.counter("raft_serving_requests_by_bucket", "per bucket").set_total(3.0, bucket='a"b\\c\nd')
    g = reg.gauge("raft_serving_queue_depth", "queue depth")
    g.set(7.0)
    g.set(3.5)
    g.set(1e20, replica="r0")
    h = reg.histogram("raft_serving_queue_wait_ms", "queue wait")
    for v in (0.1, 0.5, 3.0, 7.0, 50.0, 2e4, float("inf")):
        h.observe(v)
    reg.histogram("lat_ms", "latency", buckets=(1.0, 5.0, 10.0)).observe(4.0, bucket="x")
    assert reg.counter("raft_serving_requests_total", "ignored") is c
    with pytest.raises(ValueError):
        reg.gauge("raft_serving_requests_total", "same name, another kind")
    with pytest.raises(ValueError):
        c.set_total(9.0)
    with pytest.raises(ValueError):
        c.inc(-1.0)
    return reg


def test_registry_exposition_matches_jax():
    ours, theirs = _registry_ops(prom), _registry_ops(jax_prom)
    assert ours.render() == theirs.render()
    assert prom.PROM_CONTENT_TYPE == jax_prom.PROM_CONTENT_TYPE == "text/plain; version=0.0.4"
    assert prom.DEFAULT_MS_BUCKETS == jax_prom.DEFAULT_MS_BUCKETS


def test_histogram_buckets_cumulative_and_sum_to_count():
    reg = prom.Registry()
    h = reg.histogram("lat_ms", "latency", buckets=(1.0, 5.0, 10.0))
    for v in (0.5, 3.0, 7.0, 50.0):
        h.observe(v)
    lines = [ln for ln in reg.render().splitlines() if ln.startswith("lat_ms_bucket")]
    assert [int(ln.rsplit(" ", 1)[1]) for ln in lines] == [1, 2, 3, 4]
    assert h.count() == 4 and "lat_ms_sum 60.5" in reg.render()


# -- flight recorder and tracer ---------------------------------------------------

def _strip_times(record):
    return {k: v for k, v in record.items() if k not in ("t0", "t1", "ms", "t")}


def _trace_ops(mod, path):
    tracer = mod.Tracer(capacity=4, dump_path=path)
    tid = tracer.start_trace()
    tracer.span("admission", trace=tid, t0=1.0, t1=2.0, bucket=[64, 96])
    with tracer.timed("queue", trace=tid, bucket=[64, 96]):
        pass
    tracer.event("breaker_transition", frm="healthy", to="degraded", reason="2 consecutive batch failures")
    tracer.span("chunk", k=1, traces=[tid])
    tracer.span("finalize", k=1, delivered=1, traces=[tid])
    tracer.event("watchdog_fire", elapsed_s=2.5)
    return tracer


def test_tracer_records_counters_and_dump_match_jax(tmp_path):
    ours = _trace_ops(trace, str(tmp_path / "ours.json"))
    theirs = _trace_ops(jax_trace, str(tmp_path / "theirs.json"))
    assert [_strip_times(r) for r in ours.recorder.records()] == [_strip_times(r) for r in theirs.recorder.records()]
    assert ours.recorder.counters() == theirs.recorder.counters()
    assert ours.recorder.counters()["dropped_total"] == 2  # ring of 4, six appended
    assert trace.observability_block(ours) == jax_trace.observability_block(theirs)
    assert trace.observability_block(None) == jax_trace.observability_block(None)
    a = trace.load_flight_recorder(ours.dump("reason"))
    b = jax_trace.load_flight_recorder(theirs.dump("reason"))
    assert set(a) == set(b) and a["reason"] == b["reason"] == "reason"
    assert a["counters"] == b["counters"] and a["counters"]["dumps_total"] == 0
    assert ours.recorder.counters()["dumps_total"] == 1
    # The port reads the JAX package's dump and the other way round.
    assert trace.load_flight_recorder(str(tmp_path / "theirs.json"))["traces_total"] == 1
    bad = dict(a, flight_recorder_version=99)
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError):
        trace.load_flight_recorder(str(tmp_path / "bad.json"))


def test_tracer_disabled_at_capacity_zero_still_counts():
    ours, theirs = trace.Tracer(capacity=0, dump_path="/nonexistent/x.json"), jax_trace.Tracer(capacity=0)
    for t in (ours, theirs):
        t.span("s")
        t.event("e")
    assert not ours.enabled and ours.recorder.records() == []
    assert ours.recorder.counters() == theirs.recorder.counters()
    assert ours.dump("whatever") is None and trace.Tracer(capacity=4).dump("no path") is None


# -- serving metrics ------------------------------------------------------------------

def _metrics_ops(cls):
    m = cls(latency_window=8, batch_log=4)
    for b in ((64, 96), (96, 128), (64, 96)):
        m.record_admit(b)
    m.record_reject()
    m.record_shed()
    m.record_shed(deadline_infeasible=True)
    m.record_batch_failure(2)
    m.record_stream(warm_started=True, reset=False)
    m.record_stream(warm_started=False, reset=True)
    for i, (real, padded) in enumerate(((1, 1), (2, 2), (3, 4), (1, 2), (2, 2))):
        m.record_batch((64, 96) if i % 2 else (96, 128), real, padded)
    for i, lat in enumerate((12.5, 3.0, 40.0, 7.25, 9.0, 1.0, 22.0, 5.5, 100.0, 0.5)):
        m.record_response(lat, early_exit=i % 3 == 0, deadline_missed=i % 4 == 0)
        m.record_attribution(lat / 4, lat / 2, lat / 4)
    return m


def test_serving_metrics_match_jax():
    ours, theirs = _metrics_ops(ServingMetrics), _metrics_ops(JaxServingMetrics)
    assert ours.snapshot(queue_depth=3, streams_active=2) == theirs.snapshot(queue_depth=3, streams_active=2)
    assert ours.attribution_summary() == theirs.attribution_summary()
    assert list(ours.batch_log) == list(theirs.batch_log)
    assert ServingMetrics().snapshot() == JaxServingMetrics().snapshot()


def test_percentile_linear_interpolation_and_small_sample_edges():
    p = ServingMetrics._percentile
    for vals, q in (([], 0.5), ([42.0], 0.5), ([0.0, 10.0], 0.5), ([1.0, 2.0, 3.0, 4.0], 0.5),
                    ([float(i) for i in range(20)], 0.95), ([5.0, 7.0], 0.0), ([5.0, 7.0], 1.0)):
        assert p(vals, q) == JaxServingMetrics._percentile(vals, q)
    assert p([], 0.5) is None and p([42.0], 0.5) is None
    assert p([float(i) for i in range(20)], 0.95) == pytest.approx(18.05)


# -- device memory ---------------------------------------------------------------------

def test_memory_block_on_the_cpu_keeps_the_jax_keys():
    block = memory_block()
    assert set(block) == set(jax_memory_block([])) | {"platform"}
    assert block["platform"] == "cpu" and block["available"] is False
    assert all(block[k] == 0 for k in block if k not in ("platform", "available"))
    devices = [{"device": "0", "bytes_in_use": 5, "peak_bytes_in_use": 9, "bytes_limit": 80,
                "live_buffer_count": 2, "live_buffer_bytes": 5}]
    card = memory_block(devices)
    assert card["platform"] == "cuda" and card["available"] and card["device_count"] == 1
    assert {k: card[k] for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")} == {
        k: v for k, v in jax_memory_block(devices).items() if k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")}


def test_set_memory_gauges_populates_registry():
    reg = prom.Registry()
    block = set_memory_gauges(reg)
    text = reg.render()
    for name in ("raft_device_memory_bytes_in_use", "raft_device_memory_peak_bytes_in_use",
                 "raft_device_memory_bytes_limit", "raft_live_buffer_count", "raft_live_buffer_bytes",
                 "raft_device_memory_available"):
        assert f"\n{name} " in "\n" + text, name
    assert block["available"] is False and "raft_device_memory_available 0" in text


# -- the run report -------------------------------------------------------------------

REPORT_ARGS = [
    {"stop_cause": "completed", "final_step": 12},
    {"stop_cause": "watchdog", "final_step": 3, "watchdog": {"enabled": True, "fired": True, "timeout_s": 2.0,
                                                             "last_beat_step": 2, "phase": None}},
    {"stop_cause": "completed", "final_step": 0,
     "observability": {"enabled": True, "capacity": 8, "traces_total": 1, "spans_total": 2, "events_total": 0,
                       "dropped_total": 0, "dumps_total": 0}},
]


@pytest.mark.parametrize("kw", REPORT_ARGS, ids=["plain", "watchdog", "observability"])
def test_run_report_matches_jax(kw):
    ours = run_report.build_run_report(**copy.deepcopy(kw))
    theirs = jax_run_report.build_run_report(**copy.deepcopy(kw))
    assert ours == theirs
    assert run_report.validate_run_report(ours) == [] == jax_run_report.validate_run_report(ours)
    broken = [dict(ours, schema_version=1), dict(ours, exit_code=7), {k: v for k, v in ours.items() if k != "watchdog"},
              dict(ours, final_step=True), dict(ours, process_index=3), dict(ours, resume_count=2),
              dict(ours, observability={"enabled": False, "capacity": 4}), "not a dict"]
    for report in broken:
        assert run_report.validate_run_report(report) == jax_run_report.validate_run_report(report)
        assert run_report.validate_run_report(report)
    with pytest.raises(ValueError):
        run_report.build_run_report(stop_cause="bogus", final_step=0)


def test_atomic_write_json(tmp_path):
    path = str(tmp_path / "r.json")
    run_report.atomic_write_json(path, {"b": 1, "a": [1, 2]})
    assert json.load(open(path)) == {"a": [1, 2], "b": 1}
    assert not [p for p in tmp_path.iterdir() if ".tmp." in p.name]


# -- the hang watchdog ----------------------------------------------------------------

def test_watchdog_fires_with_every_threads_stack():
    fired = []
    parked = threading.Event()
    sleeper = threading.Thread(target=parked.wait, name="parked-thread", daemon=True)
    sleeper.start()
    dog = HangWatchdog(timeout_s=0.2, on_hang=fired.append)
    try:
        with dog.watch():
            deadline = time.monotonic() + 10
            while not fired and time.monotonic() < deadline:
                time.sleep(0.02)
            time.sleep(0.5)  # a stall fires once, not at every poll
    finally:
        parked.set()
        dog.close()
    assert dog.fired == 1 and len(fired) == 1 and fired[0]["elapsed_s"] > 0.2
    assert "parked-thread" in fired[0]["traces"] and "MainThread" in fired[0]["traces"]
    assert not dog._thread.is_alive()


def test_watchdog_quiet_while_beaten_and_inert_at_zero():
    fired = []
    dog = HangWatchdog(timeout_s=0.3, on_hang=fired.append)
    try:
        for _ in range(2):
            with dog.watch():
                for _ in range(10):
                    time.sleep(0.05)
                    dog.beat()
        time.sleep(0.6)  # no batch running: waiting for work is not a hang
    finally:
        dog.close()
    assert not fired and dog.fired == 0
    model = RAFTStereoConfig(hidden_dims=(32, 32, 32))
    off = AnytimeEngine(ServeConfig(model=model), device="cpu")
    assert off._watchdog is None
    off.close()
    on = AnytimeEngine(ServeConfig(model=model, hang_timeout_s=1.0), device="cpu")
    assert on._watchdog._thread.is_alive()
    on.close()
    assert not on._watchdog._thread.is_alive()


# -- the HTTP client ------------------------------------------------------------------

def test_http_response_carries_answered_statuses(monkeypatch):
    """An answered 4xx/5xx comes back as a response; only a transport
    failure raises."""
    import urllib.error
    import urllib.request

    def urlopen(req, timeout):
        if req.full_url.endswith("/down"):
            raise urllib.error.URLError(ConnectionRefusedError("refused"))
        raise urllib.error.HTTPError(req.full_url, 503, "shed", {}, io.BytesIO(b'{"error": "shed"}'))

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    resp = http.request_json("http://127.0.0.1:1/x", method="POST", payload={"a": 1})
    assert resp.status == 503 and not resp.ok and resp.json() == {"error": "shed"}
    with pytest.raises(ConnectionRefusedError):
        http.request("http://127.0.0.1:1/down")
    np.testing.assert_equal(http.HttpResponse(200, {}, b"[1, 2]").json(), [1, 2])
