"""The port's video module and stream sessions, on the CPU (mirrors
tests/test_video.py).

- Against the JAX package: `VideoConfig` validation; `downsample_gray`,
  `flow_warp_error`, `should_reset`, `gt_flow_lowres` and `sequence_epe`
  exactly on numpy inputs (non-finite flows included); `StreamSession`'s
  cold and warm frames at rtol = atol = 1e-4 on the same (perturbed,
  kernel-halved) weights and on JAX `SequenceDataset`'s synthetic frames.
- The port's own: the reset gate through drift and at a cut, replay and
  the warm/cold parity ladder, and streams through the service: warm
  starts after frame 0, a scene cut resets, LRU eviction, the refusal
  without a video config, and the HTTP stream fields.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.config import ServeConfig as JaxServeConfig
from raft_stereo_tpu.config import VideoConfig as JaxVideoConfig
from raft_stereo_tpu.data.datasets import SequenceDataset, make_synthetic_sequence
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.video import session as jax_session
from raft_stereo_tpu_torch.config import RAFTStereoConfig, ServeConfig, VideoConfig
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.serving.service import StereoService, make_http_server
from raft_stereo_tpu_torch.utils.checkpoints import load_jax_variables
from raft_stereo_tpu_torch.utils.http import request_json
from raft_stereo_tpu_torch.video import session
from torch_parity import halve_kernels, jax_init, torch_single_thread  # noqa: F401 (autouse fixture)

H, W = 48, 64
HID = (32, 32, 32)
KERNEL = {"corr_implementation": "pallas", "fused_gru_tail": True}
WAIT_S = 120


def _sequence(seed, n_frames=3, h=H, w=W, **kwargs):
    return make_synthetic_sequence(np.random.default_rng(seed), n_frames, h, w, **kwargs)


# -- config and the numpy gate, against JAX -----------------------------------

INVALID_VIDEO = [{"chunk_iters": 0}, {"cold_iters": 0}, {"warm_iters": 0}, {"warm_iters": 16, "cold_iters": 8},
                 {"reset_error_ratio": 0.0}, {"reset_error_floor": -1.0}]


@pytest.mark.parametrize("kw", INVALID_VIDEO, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_video_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        JaxVideoConfig(**kw)
    with pytest.raises(ValueError):
        VideoConfig(**kw)


def test_video_defaults_and_serve_agreement_match_jax():
    assert dataclass_fields(VideoConfig()) == dataclass_fields(JaxVideoConfig())
    for serve_kw, video_kw in (({"chunk_iters": 2}, {"chunk_iters": 4}),
                               ({"chunk_iters": 4, "max_iters": 8}, {"chunk_iters": 4, "warm_iters": 16,
                                                                     "cold_iters": 32})):
        with pytest.raises(ValueError):
            JaxServeConfig(video=JaxVideoConfig(**video_kw), **serve_kw)
        with pytest.raises(ValueError):
            ServeConfig(video=VideoConfig(**video_kw), **serve_kw)
    for bad in ({"max_streams": 0}, {"batch_window_ms": -1.0}, {"hang_timeout_s": -1.0},
                {"breaker_degrade_after": 3, "breaker_fail_after": 2}, {"breaker_probation": 0},
                {"drain_timeout_s": -1.0}, {"flight_recorder_events": -1}):
        with pytest.raises(ValueError):
            JaxServeConfig(**bad)
        with pytest.raises(ValueError):
            ServeConfig(**bad)
    ours, theirs = ServeConfig(), JaxServeConfig()
    for name in ("batch_window_ms", "host", "port", "restore_ckpt", "video", "max_streams", "breaker_degrade_after",
                 "breaker_fail_after", "breaker_probation", "hang_timeout_s", "drain_timeout_s", "log_dir",
                 "flight_recorder_events", "batch_sizes"):
        assert getattr(ours, name) == getattr(theirs, name), name


def dataclass_fields(cfg):
    import dataclasses

    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_gate_functions_match_jax_exactly(seed):
    frames = _sequence(seed, n_frames=4, h=64, w=96, cut_at=2)
    rng = np.random.default_rng(seed)
    for factor in (4, 8):
        for frame in frames:
            assert np.array_equal(session.downsample_gray(frame["image1"], factor),
                                  jax_session.downsample_gray(frame["image1"], factor))
            gt = session.gt_flow_lowres(frame, factor)
            assert np.array_equal(gt, jax_session.gt_flow_lowres(frame, factor))
            for flow in (gt, gt + rng.normal(0, 2, gt.shape).astype(np.float32), np.zeros_like(gt),
                         np.where(rng.uniform(size=gt.shape) < 0.1, np.nan, gt)):
                ours = session.flow_warp_error(frame["image1"], frame["image2"], flow, factor)
                theirs = jax_session.flow_warp_error(frame["image1"], frame["image2"], flow, factor)
                assert ours == theirs or (np.isinf(ours) and np.isinf(theirs))
            up = rng.normal(0, 3, frame["flow"].shape).astype(np.float32)
            assert session.sequence_epe(up, frame) == jax_session.sequence_epe(up, frame)


def test_should_reset_matches_jax():
    rng = np.random.default_rng(9)
    cases = [(100.0, None), (10.0, 1.0), (10.0, 8.0), (3.0, 0.1), (4.0, 1.0), (float("inf"), 2.0)]
    cases += [tuple(rng.uniform(0, 20, 2)) for _ in range(50)]
    for kw in ({}, {"reset_error_ratio": 1.5, "reset_error_floor": 0.0}, {"reset_error_floor": 12.0}):
        ours, theirs = VideoConfig(**kw), JaxVideoConfig(**kw)
        for cand, prev in cases:
            assert session.should_reset(cand, prev, ours) is jax_session.should_reset(cand, prev, theirs)


def test_reset_gate_fires_on_scene_cut_not_on_drift():
    v = VideoConfig()
    frames = _sequence(7, n_frames=4, h=64, w=96, cut_at=2)
    for t, expect_reset in ((1, False), (2, True)):
        prior = session.gt_flow_lowres(frames[t - 1], 4)
        prev, cand = frames[t - 1], frames[t]
        err_prev = session.flow_warp_error(prev["image1"], prev["image2"], prior, 4)
        err_cand = session.flow_warp_error(cand["image1"], cand["image2"], prior, 4)
        assert session.should_reset(err_cand, err_prev, v) is expect_reset


# -- StreamSession against JAX's -----------------------------------------------

@pytest.fixture(scope="module")
def weights():
    img = jnp.zeros((1, H, W, 3))
    v = jax_init(JaxRAFTStereo(JaxConfig(hidden_dims=HID)), img, img, iters=1)
    return {"params": halve_kernels(v["params"]), "batch_stats": v["batch_stats"]}


def port_model(weights):
    return load_jax_variables(RAFTStereo(RAFTStereoConfig(hidden_dims=HID, **KERNEL)), weights).eval()


def test_stream_session_matches_jax_cold_and_warm(weights):
    frames = SequenceDataset.synthetic(np.random.default_rng(21), n_frames=3, h=H, w=W).get_sequence(0)
    kw = {"chunk_iters": 1, "cold_iters": 3, "warm_iters": 2}
    ours = session.StreamSession(port_model(weights), VideoConfig(**kw))
    theirs = jax_session.StreamSession(JaxConfig(hidden_dims=HID, **KERNEL), weights, JaxVideoConfig(**kw))
    for t, frame in enumerate(frames):
        a = ours.process(frame["image1"], frame["image2"])
        b = theirs.process(frame["image1"], frame["image2"])
        assert (a["warm_started"], a["reset"], a["iters"]) == (b["warm_started"], b["reset"], b["iters"])
        assert a["warm_started"] is (t > 0)
        assert np.abs(b["disparity"]).max() > 1.0
        np.testing.assert_allclose(a["disparity"], b["disparity"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a["flow_lowres"], b["flow_lowres"], rtol=1e-4, atol=1e-4)
        assert a["warp_error"] == pytest.approx(b["warp_error"], rel=1e-4, abs=1e-4)


def test_stream_session_carry_hidden_matches_jax(weights):
    """carry_hidden=True: the warm frame starts from the previous frame's
    GRU hidden state as well as its flow, as JAX's session does, and
    differs from the flow-only warm start."""
    frames = SequenceDataset.synthetic(np.random.default_rng(37), n_frames=3, h=H, w=W).get_sequence(0)
    kw = {"chunk_iters": 1, "cold_iters": 3, "warm_iters": 2}
    ours = session.StreamSession(port_model(weights), VideoConfig(carry_hidden=True, **kw))
    theirs = jax_session.StreamSession(JaxConfig(hidden_dims=HID, **KERNEL), weights,
                                       JaxVideoConfig(carry_hidden=True, **kw))
    flow_only = session.StreamSession(port_model(weights), VideoConfig(**kw))
    for t, frame in enumerate(frames):
        a = ours.process(frame["image1"], frame["image2"])
        b = theirs.process(frame["image1"], frame["image2"])
        c = flow_only.process(frame["image1"], frame["image2"])
        assert ours._net is not None and (a["warm_started"], a["iters"]) == (b["warm_started"], b["iters"])
        assert a["warm_started"] is (t > 0)
        np.testing.assert_allclose(a["disparity"], b["disparity"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a["flow_lowres"], b["flow_lowres"], rtol=1e-4, atol=1e-4)
        if t == 0:
            np.testing.assert_array_equal(a["disparity"], c["disparity"])
        else:
            assert np.abs(a["disparity"] - c["disparity"]).max() > 1e-3


def test_stream_session_reset_gate_on_cut(weights):
    """Seeded with the previous frame's GT flow (a converged model's carry),
    the session warm-starts through drift and resets at a cut."""
    s = session.StreamSession(port_model(weights), VideoConfig(chunk_iters=1, cold_iters=2, warm_iters=1))
    frames = _sequence(31, n_frames=4, cut_at=2)
    s.seed(frames[0]["image1"], frames[0]["image2"], session.gt_flow_lowres(frames[0], 4))
    r1 = s.process(frames[1]["image1"], frames[1]["image2"])
    assert r1["warm_started"] and not r1["reset"] and r1["iters"] == 1
    s.seed(frames[1]["image1"], frames[1]["image2"], session.gt_flow_lowres(frames[1], 4))
    r2 = s.process(frames[2]["image1"], frames[2]["image2"])
    assert r2["reset"] and not r2["warm_started"] and r2["iters"] == 2 and s.resets == 1
    with pytest.raises(ValueError, match="one"):
        s.process(np.zeros((2, H, W, 3)), np.zeros((2, H, W, 3)))


def test_replay_and_warm_cold_parity(weights):
    model = port_model(weights)
    frames = _sequence(33, n_frames=3)
    video = VideoConfig(chunk_iters=1, cold_iters=3, warm_iters=1)
    out = session.replay_sequence(session.StreamSession(model, video), frames)
    assert out["frames"] == 3 and out["warm_frames"] >= 1 and out["video_maps_per_sec"] > 0
    parity = session.warm_cold_parity(model, frames, video)
    assert parity["cold_iters"] == 3 and 1 <= parity["warm_iters_to_parity"] <= 3
    assert set(parity["warm_epe_by_iters"]) == {"1", "2", "3"}
    with pytest.raises(ValueError, match="prior"):
        session.warm_cold_parity(model, frames, video, prior="oracle")


# -- streams through the service -------------------------------------------------

BUCKET = (64, 96)


def low_contrast(img):
    """A scene the untrained model's junk flow still explains about as well
    from frame to frame (a warp error of a few intensity units)."""
    return (120.0 + 0.1 * (np.asarray(img, np.float32) - 127.5)).astype(np.float32)


def low_contrast_pair(seed):
    frame = _sequence(seed, n_frames=1, h=BUCKET[0], w=BUCKET[1])[0]
    return low_contrast(frame["image1"]), low_contrast(frame["image2"])


@pytest.fixture(scope="module")
def stream_served(weights):
    cfg = ServeConfig(model=RAFTStereoConfig(hidden_dims=HID, **KERNEL), buckets=(BUCKET,), max_batch=2,
                      chunk_iters=1, max_iters=3, max_streams=2,
                      video=VideoConfig(chunk_iters=1, cold_iters=3, warm_iters=1))
    service = StereoService(cfg, port_model(weights), device="cpu").start()
    yield service
    service.close()


def test_stream_warm_starts_after_frame_0_and_a_cut_resets(stream_served):
    frames = _sequence(41, n_frames=5, h=60, w=90)
    rng = np.random.default_rng(42)
    cut = {"image1": rng.uniform(0, 255, (60, 90, 3)).astype(np.float32),
           "image2": rng.uniform(0, 255, (60, 90, 3)).astype(np.float32)}
    seq = [(low_contrast(f["image1"]), low_contrast(f["image2"])) for f in frames[:4]]
    seq.append((cut["image1"], cut["image2"]))
    out = [stream_served.submit_stream("cam", a, b).result(timeout=WAIT_S) for a, b in seq]
    assert [o["warm_started"] for o in out] == [False, True, True, True, False]
    assert [o["reset"] for o in out] == [False, False, False, False, True]
    assert [o["stream_frame"] for o in out] == [0, 1, 2, 3, 0]
    assert [o["iters_completed"] for o in out] == [3, 1, 1, 1, 3]
    assert all(o["disparity"].shape == (60, 90) and np.isfinite(o["disparity"]).all() for o in out)
    snap = stream_served.metrics()
    assert snap["warm_start_total"] >= 3 and snap["stream_resets_total"] >= 1


def test_warm_frame_equals_the_direct_flow_init_forward(stream_served):
    """A warm frame is the model's forward from the carried low-res flow."""
    import torch

    a, b = low_contrast_pair(43)
    first = stream_served.submit_stream("direct", a, b).result(timeout=WAIT_S)
    carry = stream_served._streams["direct"].flow
    second = stream_served.submit_stream("direct", a, b).result(timeout=WAIT_S)
    assert second["warm_started"] and not first["warm_started"]
    with torch.inference_mode():
        _, up = stream_served.engine.model(torch.from_numpy(a[None]), torch.from_numpy(b[None]), iters=1,
                                           flow_init=torch.from_numpy(carry[None]), test_mode=True)
    np.testing.assert_allclose(second["disparity"], up[0, :, :, 0].numpy(), rtol=1e-5, atol=1e-5)


def test_stream_lru_eviction(stream_served):
    a, b = low_contrast_pair(45)
    for sid in ("s1", "s2", "s3"):
        stream_served.submit_stream(sid, a, b).result(timeout=WAIT_S)
    assert stream_served.streams_active() == 2 and "s1" not in stream_served._streams
    again = stream_served.submit_stream("s1", a, b).result(timeout=WAIT_S)
    assert not again["warm_started"] and again["stream_frame"] == 0


def test_stream_rejected_when_video_disabled(weights):
    cfg = ServeConfig(model=RAFTStereoConfig(hidden_dims=HID, **KERNEL), buckets=(BUCKET,), max_batch=1,
                      chunk_iters=1, max_iters=1)
    service = StereoService(cfg, port_model(weights), device="cpu")
    with pytest.raises(RuntimeError, match="stream serving disabled"):
        service.submit_stream("x", np.zeros((*BUCKET, 3)), np.zeros((*BUCKET, 3)))


def test_http_stream_requests(stream_served):
    server = make_http_server(stream_served, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/v1/predict"
        a, b = (x.tolist() for x in low_contrast_pair(47))
        bodies = [request_json(url, method="POST", timeout_s=WAIT_S,
                               payload={"image1": a, "image2": b, "stream_id": "web"}).json() for _ in range(2)]
        assert [(x["stream_id"], x["stream_frame"], x["warm_started"]) for x in bodies] == [
            ("web", 0, False), ("web", 1, True)]
        assert np.asarray(bodies[1]["disparity"]).shape == BUCKET
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
