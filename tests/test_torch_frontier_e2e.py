"""The port's front tier over two real port backends on the CPU (mirrors the
real-fleet half of tests/test_frontier.py): two in-process `StereoService`
backends on the same weights, each behind its HTTP front, and the
frontier's HTTP server over both. ORDER-DEPENDENT (baseline, then the
kill):

- plain requests through the frontier equal the same request posted to a
  backend directly, bit for bit (JSON floats round-trip exactly), from
  either backend;
- an oversized input's 413 forwards verbatim, recorded once, not retried;
- killing the stream-pinned backend (HTTP front and service) loses no
  plain request: each is answered through a retry onto the survivor, bit
  for bit; the stream migrates with `migrated=true` and
  `warm_started=false`; the backend restarted on its port walks from
  `failed` through probation to `healthy`;
- drain then close is graceful.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu_torch.config import FrontierConfig, RAFTStereoConfig, ServeConfig, VideoConfig
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.serving.frontier import Frontier, make_frontier_http_server
from raft_stereo_tpu_torch.serving.service import StereoService, make_http_server
from raft_stereo_tpu_torch.utils.checkpoints import load_jax_variables
from raft_stereo_tpu_torch.utils.http import request_json
from torch_parity import halve_kernels, jax_init, torch_single_thread  # noqa: F401 (autouse fixture)

HID = (16, 16, 16)
BUCKET = (32, 64)
MAX_ITERS = 2
WAIT_S = 120.0

_rng = np.random.default_rng(20261019)
PAIR = tuple(_rng.uniform(0, 255, (*BUCKET, 3)).astype(np.float32) for _ in range(2))


def _poll(predicate, timeout_s=20.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


@pytest.fixture(scope="module")
def fleet():
    img = jnp.zeros((1, *BUCKET, 3))
    v = jax_init(JaxRAFTStereo(JaxConfig(hidden_dims=HID)), img, img, iters=1)
    weights = {"params": halve_kernels(v["params"]), "batch_stats": v["batch_stats"]}
    model_cfg = RAFTStereoConfig(hidden_dims=HID, corr_implementation="pallas", fused_gru_tail=True)
    cfg = ServeConfig(
        model=model_cfg, buckets=(BUCKET,), max_batch=1, chunk_iters=1, max_iters=MAX_ITERS,
        video=VideoConfig(chunk_iters=1, cold_iters=MAX_ITERS, warm_iters=1, reset_error_floor=1e9),
        breaker_degrade_after=1, breaker_fail_after=3, drain_timeout_s=60.0,
    )
    state = {"backends": {}}

    def boot_backend(port=0):
        model = load_jax_variables(RAFTStereo(model_cfg), weights).eval()
        service = StereoService(cfg, model, device="cpu").start()
        server = make_http_server(service, port=port, handler_timeout_s=30.0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        addr = f"127.0.0.1:{server.server_address[1]}"
        entry = {"service": service, "server": server, "port": server.server_address[1], "addr": addr}
        state["backends"][addr] = entry
        return entry

    state["boot_backend"] = boot_backend
    e1, e2 = boot_backend(), boot_backend()
    frontier = Frontier(FrontierConfig(
        backends=(e1["addr"], e2["addr"]), health_interval_s=0.05, health_timeout_s=2.0, request_timeout_s=300.0,
        retry_attempts=3, retry_base_delay_s=0.01, retry_max_delay_s=0.05, breaker_degrade_after=1,
        breaker_fail_after=2, breaker_probation=2, drain_timeout_s=30.0,
    ), sleep=lambda s: None).start()
    fserver = make_frontier_http_server(frontier, port=0, handler_timeout_s=30.0)
    threading.Thread(target=fserver.serve_forever, daemon=True).start()
    state.update(frontier=frontier, fserver=fserver, furl="http://127.0.0.1:%d" % fserver.server_address[1])
    try:
        yield state
    finally:
        fserver.shutdown()
        fserver.server_close()
        frontier.close()
        for entry in state["backends"].values():
            for closer in (entry["server"].shutdown, entry["server"].server_close, entry["service"].close):
                try:
                    closer()
                except Exception:  # noqa: BLE001 - the chaos test kills one first
                    pass


def _post(url, **extra):
    payload = {"image1": PAIR[0].tolist(), "image2": PAIR[1].tolist(), "max_iters": MAX_ITERS, **extra}
    return request_json(url, method="POST", payload=payload, timeout_s=WAIT_S)


def test_answers_equal_a_direct_backend_bit_for_bit(fleet):
    seen = {}
    for _ in range(4):
        resp = _post(fleet["furl"] + "/predict")
        assert resp.status == 200, resp.body
        out = resp.json()
        seen.setdefault(out["backend"], out["disparity"])
    assert set(seen) == set(fleet["backends"])  # both backends answered
    for addr in fleet["backends"]:
        direct = _post(f"http://{addr}/v1/predict")
        assert direct.status == 200
        assert direct.json()["disparity"] == seen[addr]  # JSON floats: list equality is bit identity
    first = next(iter(seen.values()))
    assert all(d == first for d in seen.values())
    assert np.abs(np.asarray(first)).max() > 0.1
    fleet["baseline"] = first
    snap = fleet["frontier"].metrics()
    assert snap["requests_total"] == snap["responses_total"] == 4 and snap["retries_total"] == 0


def test_oversized_input_forwards_413_once(fleet):
    big = np.zeros((BUCKET[0] + 32, BUCKET[1] + 32, 3), np.float32).tolist()
    before = sum(e["service"].metrics()["rejected_total"] for e in fleet["backends"].values())
    retries = fleet["frontier"].metrics()["retries_total"]
    resp = _post(fleet["furl"] + "/predict", image1=big, image2=big)
    assert resp.status == 413 and "exceeds every bucket" in resp.json()["error"]
    assert sum(e["service"].metrics()["rejected_total"] for e in fleet["backends"].values()) - before == 1
    assert fleet["frontier"].metrics()["retries_total"] == retries


def test_killed_backend_answered_through_retry(fleet):
    frontier = fleet["frontier"]
    baseline = fleet["baseline"]
    frames = [_post(fleet["furl"] + "/predict", stream_id="cam0").json() for _ in range(2)]
    pinned = frames[0]["backend"]
    assert frames[1]["backend"] == pinned and frames[1]["warm_started"] is True
    victim = fleet["backends"][pinned]
    survivor = next(a for a in fleet["backends"] if a != pinned)

    # Passive discovery: freeze the prober while the host dies, so request
    # traffic finds the death and retries.
    real_probe = frontier._probe_one
    frontier._probe_one = lambda backend: None
    victim["server"].shutdown()
    victim["server"].server_close()
    victim["service"].close()

    retries = frontier.metrics()["retries_total"]
    for _ in range(4):
        resp = _post(fleet["furl"] + "/predict")
        assert resp.status == 200, resp.body
        out = resp.json()
        assert out["backend"] == survivor and out["disparity"] == baseline
    assert frontier.metrics()["retries_total"] > retries
    assert frontier.metrics()["per_backend"][pinned]["state"] == "failed"

    out = _post(fleet["furl"] + "/predict", stream_id="cam0").json()
    assert out["backend"] == survivor and out["migrated"] is True and out["warm_started"] is False
    assert out["stream_frame"] == 0
    snap = frontier.metrics()
    assert snap["responses_total"] == snap["requests_total"] and snap["errors_total"] == 0
    assert snap["migrations_total"] == 1

    # A restart on the same port: probe -> probation -> healthy on traffic.
    frontier._probe_one = real_probe
    del fleet["backends"][pinned]
    assert fleet["boot_backend"](port=victim["port"])["addr"] == pinned
    _poll(lambda: frontier.metrics()["per_backend"][pinned]["state"] == "degraded",
          what="the restarted backend to enter probation")
    deadline = time.monotonic() + 60.0
    while frontier.metrics()["per_backend"][pinned]["state"] != "healthy":
        assert time.monotonic() < deadline, "probation never completed"
        resp = _post(fleet["furl"] + "/predict")
        assert resp.status == 200 and resp.json()["disparity"] == baseline
    assert frontier.metrics()["backend_states"].count("healthy") == 2


def test_drain_then_close_is_graceful(fleet):
    frontier = fleet["frontier"]
    assert frontier.drain(timeout_s=30.0) is True
    assert frontier.state == "draining"
    resp = _post(fleet["furl"] + "/predict")
    assert resp.status == 503
