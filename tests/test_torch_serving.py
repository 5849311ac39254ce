"""The port's serving front: `StereoService` through the micro-batcher, the
HTTP front and the `serve` command line, on the CPU.

- The slice as a whole: a request through the service (admission, the
  batcher's stager and runner threads, the engine's chunks, unpadding)
  against the JAX `RAFTStereo` test-mode forward on the same (perturbed,
  kernel-halved) weights and padded pair, 3 iterations, rtol = atol = 1e-4
  (precedent tests/test_model.py), in the kernel configuration (the JAX
  Pallas kernels in interpret mode, the port's plain versions).
- Behaviour mirroring tests/test_serving.py: concurrent submits to one
  bucket coalesce and equal the engine's own batch bit for bit, buckets
  never mix, a tight deadline exits early, `max_iters` rounds up to whole
  chunks, an oversize input is refused (413 over HTTP), /healthz passes
  both packages' `validate_run_report`, the /metrics routes and content
  types, and the `serve` command line (`--warmup_only`, the flags not
  ported, SIGTERM draining a live server to exit 0).

Every wait has its own limit; the fixtures close what they start.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.serving.batcher import ServingMetrics as JaxServingMetrics
from raft_stereo_tpu.utils.run_report import validate_run_report as jax_validate_run_report
from raft_stereo_tpu_torch import cli
from raft_stereo_tpu_torch.config import RAFTStereoConfig, ServeConfig
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.serving.service import BucketOverflowError, StereoService, make_http_server
from raft_stereo_tpu_torch.utils.checkpoints import load_jax_variables
from raft_stereo_tpu_torch.utils.http import request, request_json
from raft_stereo_tpu_torch.utils.run_report import validate_run_report
from torch_parity import (  # noqa: F401 (autouse fixtures)
    halve_kernels,
    jax_apply,
    jax_init,
    pallas_tpu_compiler_params,
    torch_single_thread,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HID = (32, 32, 32)
KERNEL = {"corr_implementation": "pallas", "fused_gru_tail": True}
BUCKETS = ((64, 96), (96, 128))
MAX_ITERS = 3
WAIT_S = 120


def serve_config(**kw):
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("max_batch", 2)
    kw.setdefault("chunk_iters", 1)
    kw.setdefault("max_iters", MAX_ITERS)
    return ServeConfig(model=RAFTStereoConfig(hidden_dims=HID, **KERNEL), **kw)


@pytest.fixture(scope="module")
def weights():
    """One perturbed JAX init, conv kernels halved (tests/test_torch_model.py
    `weights` says why: at full scale the untrained GRU's fp32 drift alone
    exceeds 1e-4 within 3 iterations)."""
    img = jnp.zeros((1, *BUCKETS[0], 3))
    v = jax_init(JaxRAFTStereo(JaxConfig(hidden_dims=HID)), img, img, iters=1)
    return {"params": halve_kernels(v["params"]), "batch_stats": v["batch_stats"]}


def port_model(weights):
    return load_jax_variables(RAFTStereo(RAFTStereoConfig(hidden_dims=HID, **KERNEL)), weights).eval()


@pytest.fixture(scope="module")
def served(weights):
    """The one warmed service. A long batch window makes two submits from
    one thread ride one batch deterministically."""
    service = StereoService(serve_config(batch_window_ms=300.0), port_model(weights), device="cpu").start()
    yield service
    service.close()


@pytest.fixture(scope="module")
def http(served):
    server = make_http_server(served, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def pair(rng, h, w):
    return tuple(rng.uniform(0, 255, (h, w, 3)).astype(np.float32) for _ in range(2))


def test_served_disparity_matches_jax_forward(served, weights):
    """The slice end to end: a padded 60x90 request through the batcher
    against the JAX forward of the same padded pair, unpadded alike."""
    i1, i2 = pair(np.random.default_rng(11), 60, 90)
    out = served.submit(i1, i2).result(timeout=WAIT_S)
    assert out["iters_completed"] == MAX_ITERS and out["bucket"] == [64, 96]
    _, padder, p1, p2 = served._admit(i1, i2)
    jm = JaxRAFTStereo(JaxConfig(hidden_dims=HID, **KERNEL))
    _, want_up = jax_apply(jm, weights, p1[None], p2[None], iters=MAX_ITERS, test_mode=True)
    want = padder.unpad(np.asarray(want_up))[0, :, :, 0]
    assert np.abs(want).max() > 1.0  # the flow moved: the comparison has teeth
    assert out["disparity"].shape == (60, 90)
    np.testing.assert_allclose(out["disparity"], want, rtol=1e-4, atol=1e-4)


def test_concurrent_submits_coalesce_bit_identical_to_engine_batch(served):
    rng = np.random.default_rng(12)
    pairs = [pair(rng, 64, 96) for _ in range(2)]
    before = len(served.batcher.metrics.batch_log)
    futs = [served.submit(a, b) for a, b in pairs]
    outs = [f.result(timeout=WAIT_S) for f in futs]
    log = list(served.batcher.metrics.batch_log)[before:]
    assert log == [((64, 96), 2, 2)], log
    i1 = torch.from_numpy(np.stack([a for a, _ in pairs]))
    i2 = torch.from_numpy(np.stack([b for _, b in pairs]))
    direct = served.engine.run_batch((64, 96), i1, i2, deadlines_s=[None, None], max_iters=[MAX_ITERS] * 2)
    for out, res in zip(outs, direct):
        np.testing.assert_array_equal(out["disparity"], res.flow_up[:, :, 0])


def test_batcher_never_mixes_buckets(served):
    rng = np.random.default_rng(13)
    shapes = [(64, 96), (90, 120), (50, 80), (96, 128)]
    before = len(served.batcher.metrics.batch_log)
    futs = [served.submit(*pair(rng, h, w)) for h, w in shapes]
    outs = [f.result(timeout=WAIT_S) for f in futs]
    assert [o["bucket"] for o in outs] == [[64, 96], [96, 128], [64, 96], [96, 128]]
    assert [o["disparity"].shape for o in outs] == shapes
    log = list(served.batcher.metrics.batch_log)[before:]
    assert sum(real for _, real, _ in log) == 4
    assert all(bucket in BUCKETS and real <= padded for bucket, real, padded in log)
    assert {bucket for bucket, _, _ in log} == set(BUCKETS)


def test_partial_batch_pads_to_a_warmed_size(weights):
    """Three requests at max_batch 4 (warmed sizes 1, 2, 4) ride one batch
    padded to 4 by repeating the last row, and each row equals its own
    batch-1 forward to fp32 rounding."""
    rng = np.random.default_rng(14)
    cfg = serve_config(buckets=((64, 96),), max_batch=4, batch_window_ms=300.0)
    service = StereoService(cfg, port_model(weights), device="cpu").start()
    try:
        pairs = [pair(rng, 64, 96) for _ in range(3)]
        outs = [f.result(timeout=WAIT_S) for f in [service.submit(a, b) for a, b in pairs]]
        assert list(service.batcher.metrics.batch_log) == [((64, 96), 3, 4)]
        with torch.inference_mode():
            for (a, b), out in zip(pairs, outs):
                _, up = service.engine.model(torch.from_numpy(a[None]), torch.from_numpy(b[None]),
                                             iters=MAX_ITERS, test_mode=True)
                np.testing.assert_allclose(out["disparity"], up[0, :, :, 0].numpy(), rtol=1e-5, atol=1e-5)
    finally:
        service.close()


def test_tight_deadline_exits_early(served):
    i1, i2 = pair(np.random.default_rng(15), 64, 96)
    out = served.submit(i1, i2, deadline_ms=0.001).result(timeout=WAIT_S)
    assert out["iters_completed"] == 1 and out["early_exit"]
    assert np.isfinite(out["disparity"]).all()


def test_max_iters_rounds_up_to_whole_chunks(weights):
    service = StereoService(serve_config(buckets=((64, 96),), max_batch=1, chunk_iters=2, max_iters=4),
                            port_model(weights), device="cpu").start()
    try:
        i1, i2 = pair(np.random.default_rng(16), 64, 96)
        got = [service.submit(i1, i2, max_iters=m).result(timeout=WAIT_S)["iters_completed"] for m in (1, 3, 9)]
        assert got == [2, 4, 4]
    finally:
        service.close()


def test_oversize_input_rejected_in_process(served):
    rejected = served.metrics()["rejected_total"]
    with pytest.raises(BucketOverflowError):
        served.submit(np.zeros((97, 64, 3)), np.zeros((97, 64, 3)))
    with pytest.raises(ValueError, match="equal"):
        served.submit(np.zeros((50, 70, 3)), np.zeros((50, 71, 3)))
    assert served.metrics()["rejected_total"] == rejected + 1


def test_healthz_validates_under_both_run_report_schemas(served):
    report = served.healthz()
    assert validate_run_report(report) == [] and jax_validate_run_report(report) == []
    s = report["serving"]
    assert s["state"] == "healthy" and s["warmed"] and s["device"] == "cpu"
    assert s["buckets"] == [list(b) for b in BUCKETS] and s["batch_sizes"] == [1, 2]
    assert s["memory"]["platform"] == "cpu" and not s["memory"]["available"]
    assert report["observability"]["enabled"] and report["observability"]["spans_total"] > 0


def test_metrics_snapshot_has_the_jax_key_set(served):
    served.submit(*pair(np.random.default_rng(15), 64, 96)).result(timeout=WAIT_S)
    snap = served.metrics()
    assert set(snap) == set(JaxServingMetrics().snapshot())
    assert snap["requests_total"] == snap["responses_total"]  # every admitted request answered
    assert snap["batches_total"] == len(served.batcher.metrics.batch_log)
    assert 0.0 < snap["batch_fill_mean"] <= 1.0


def test_http_front_end_to_end(served, http):
    rng = np.random.default_rng(17)
    i1, i2 = pair(rng, 60, 90)
    resp = request_json(f"{http}/v1/predict", method="POST", timeout_s=WAIT_S,
                        payload={"image1": i1.tolist(), "image2": i2.tolist()})
    assert resp.status == 200
    body = resp.json()
    want = served.submit(i1, i2).result(timeout=WAIT_S)["disparity"]
    np.testing.assert_array_equal(np.asarray(body["disparity"], np.float32), want)
    assert body["bucket"] == [64, 96] and body["swap_generation"] == 0
    assert body["iters_completed"] == MAX_ITERS and not body["early_exit"]
    big = np.zeros((100, 100, 3)).tolist()
    resp = request_json(f"{http}/v1/predict", method="POST", timeout_s=WAIT_S, payload={"image1": big, "image2": big})
    assert resp.status == 413 and "exceeds every bucket" in resp.json()["error"]
    assert request_json(f"{http}/v1/predict", method="POST", payload={"image1": [1]}).status == 400
    assert request_json(f"{http}/v1/nowhere", method="POST", payload={}).status == 404
    health = request(f"{http}/healthz")
    assert health.status == 200 and validate_run_report(health.json()) == []
    metrics = request(f"{http}/metrics")
    assert metrics.headers["Content-Type"] == "application/json" and metrics.json()["responses_total"] >= 2
    prom = request(f"{http}/metrics?format=prom")
    assert prom.headers["Content-Type"] == "text/plain; version=0.0.4"
    text = prom.body.decode()
    for series in ("raft_serving_responses_total", "raft_serving_queue_wait_ms_bucket",
                   "raft_device_memory_bytes_in_use", 'raft_serving_state_code{replica="aggregate"} 0'):
        assert series in text, series
    assert request(f"{http}/metrics?format=xml").status == 400


def test_serve_cli_warmup_only_exits_0(capsys):
    argv = ["serve", "--device", "cpu", "--warmup_only", "--buckets", "64x96", "--max_batch", "2",
            "--chunk_iters", "1", "--max_iters", "2", "--hidden_dims", "32", "32", "32",
            "--corr_implementation", "pallas", "--fused_gru_tail", "--stream"]
    assert cli.main(argv) == 0
    assert '"combos": 2' in capsys.readouterr().out


SERVE_EXIT_2 = [
    (["--replicas", "2"], "--replicas 2 counts cards; a fleet does not run on --device cpu"),
    (["--replicas", "0"], "--replicas 0 counts cards"),
    (["--sharding_rules", "spatial", "--replicas", "2"], "replicas require --sharding_rules dp"),
    (["--require_cache_hit"], "--require_cache_hit only makes sense with --warmup_only"),
    (["--audit"], "not ported yet"),
    (["--auto_respawn"], "--auto_respawn requires replicas >= 2"),
]


@pytest.mark.parametrize("flags,message", SERVE_EXIT_2, ids=[f[0][2:] for f, _ in SERVE_EXIT_2])
def test_serve_cli_unported_flags_exit_2(flags, message, capsys):
    """The flag the port does not have (`--audit`) exits 2 with "not
    ported yet"; the fleet's flags exit 2 where the fleet cannot run (off
    the card, or auto-respawn without a second replica), and
    `--require_cache_hit` without `--warmup_only` with JAX's message."""
    assert cli.main(["serve", "--device", "cpu", *flags]) == 2
    assert message in capsys.readouterr().err


def test_serve_cli_aot_cache_dir_boots(capsys, tmp_path, monkeypatch):
    """`--aot_cache_dir` boots from the kernel cache: on the CPU no kernel
    library loads, so the boot is an enabled cache with no entries, and
    `--require_cache_hit` passes (exit 0). The build directory moves under
    the cache; monkeypatch puts it back."""
    from raft_stereo_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    argv = ["serve", "--device", "cpu", "--warmup_only", "--buckets", "64x96", "--max_batch", "1",
            "--chunk_iters", "1", "--max_iters", "1", "--hidden_dims", "32", "32", "32",
            "--aot_cache_dir", str(tmp_path / "cache"), "--require_cache_hit"]
    assert cli.main(argv) == 0
    boot = json.loads(next(ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")))["boot"]
    assert boot["cache_enabled"] and boot["entries"] == boot["cache_hits"] + boot["cache_misses"] == 0
    assert boot["compiles_total"] == 0 and os.path.isdir(tmp_path / "cache")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_cli_answers_and_sigterm_drains_to_exit_0():
    """`python -m raft_stereo_tpu_torch serve` as a process: /healthz turns
    healthy, a request is answered, and SIGTERM drains and exits 0."""
    port = _free_port()
    cmd = [sys.executable, "-m", "raft_stereo_tpu_torch", "serve", "--device", "cpu", "--port", str(port),
           "--buckets", "64x96", "--max_batch", "1", "--chunk_iters", "1", "--max_iters", "2",
           "--hidden_dims", "32", "32", "32"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + WAIT_S
        state = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                state = request_json(f"http://127.0.0.1:{port}/healthz", timeout_s=5).json()["serving"]["state"]
                break
            except OSError:
                time.sleep(0.2)
        assert state == "healthy", proc.poll()
        img = np.random.default_rng(18).uniform(0, 255, (64, 96, 3)).tolist()
        resp = request_json(f"http://127.0.0.1:{port}/v1/predict", method="POST", timeout_s=WAIT_S,
                            payload={"image1": img, "image2": img})
        assert resp.status == 200 and resp.json()["iters_completed"] == 2
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=WAIT_S)
        assert proc.returncode == 0, err[-2000:]
        assert "backlog drained" in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)


@pytest.mark.gpu
def test_batched_service_matches_direct_forward_on_cuda():
    """On the card: two coalesced requests through the service against
    each pair's batch-1 direct forward, within the serving bound of 1e-3 px
    (batch rows may take other kernel paths than batch 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the serving path runs the CUDA kernels")
    cfg = serve_config(buckets=((64, 96),), batch_window_ms=300.0)
    service = StereoService(cfg, device="cuda", seed=0).start()
    try:
        rng = np.random.default_rng(19)
        pairs = [pair(rng, 64, 96) for _ in range(2)]
        outs = [f.result(timeout=WAIT_S) for f in [service.submit(a, b) for a, b in pairs]]
        assert list(service.batcher.metrics.batch_log) == [((64, 96), 2, 2)]
        with torch.inference_mode():
            for (a, b), out in zip(pairs, outs):
                _, up = service.engine.model(torch.from_numpy(a[None]).cuda(), torch.from_numpy(b[None]).cuda(),
                                             iters=MAX_ITERS, test_mode=True)
                np.testing.assert_allclose(out["disparity"], up[0, :, :, 0].cpu().numpy(), rtol=0, atol=1e-3)
    finally:
        service.close()
