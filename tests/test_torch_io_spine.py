"""The training I/O spine's write half and the trainer's metrics sidecar,
against the JAX package.

- `AsyncCheckpointCommitter`: the cases of JAX's tests/test_io_spine.py
  (the commit runs and its latency is tracked; one commit in flight; a
  background error re-raised once at the barrier, the committer reusable),
  each run on the port's class and on JAX's with the same outcome; the
  `io_spine` block equal to JAX's.
- A CPU fit with `async_checkpoint` writes the same model.pth and
  optimizer.pt (their manifests' CRCs) at every step as the synchronous
  fit, and reports its commits.
- `metrics_port`: `/metrics` answers during a short CPU fit with the step
  counter, and the sidecar is gone after it.
"""

import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from raft_stereo_tpu.train import io_spine as jax_io_spine
from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig
from raft_stereo_tpu_torch.obs.prom import Registry, serve_registry
from raft_stereo_tpu_torch.train import io_spine
from raft_stereo_tpu_torch.train.trainer import Trainer
from raft_stereo_tpu_torch.utils import checkpoints as ck
from raft_stereo_tpu_torch.utils.run_report import validate_run_report
from torch_parity import torch_single_thread  # noqa: F401 (autouse fixture)

IMPLS = {"port": io_spine, "jax": jax_io_spine}
H, W = 48, 64


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_committer_runs_commit_and_tracks_latency(impl):
    committer = IMPLS[impl].AsyncCheckpointCommitter()
    assert not committer.in_flight
    done = threading.Event()
    committer.submit(lambda: (time.sleep(0.05), done.set()), step=2)
    committer.barrier()
    assert done.is_set() and not committer.in_flight
    stats = committer.stats()
    assert stats["async_commits"] == 1 and stats["max_commit_latency_s"] >= 0.05


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_committer_is_single_flight(impl):
    committer = IMPLS[impl].AsyncCheckpointCommitter()
    release = threading.Event()
    committer.submit(release.wait, step=1)
    assert committer.in_flight
    with pytest.raises(RuntimeError, match="in flight"):
        committer.submit(lambda: None, step=2)
    release.set()
    committer.barrier()
    assert committer.stats()["async_commits"] == 1


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_committer_barrier_reraises_background_error(impl):
    committer = IMPLS[impl].AsyncCheckpointCommitter()

    def boom():
        raise OSError("disk full")

    committer.submit(boom, step=3)
    with pytest.raises(OSError, match="disk full"):
        committer.barrier()
    committer.barrier()  # delivered once; reusable afterwards
    committer.submit(lambda: None, step=4)
    committer.barrier()
    assert committer.stats()["async_commits"] == 2


def test_io_spine_block_matches_jax():
    assert io_spine.build_io_spine_block(False, False) == jax_io_spine.build_io_spine_block(False, False)
    blocks = []
    for impl in (io_spine, jax_io_spine):
        committer = impl.AsyncCheckpointCommitter()
        committer.submit(lambda: None, step=1)
        committer.barrier()
        block = impl.build_io_spine_block(True, False, committer=committer)
        block["max_commit_latency_s"] = 0.0
        blocks.append(block)
    assert blocks[0] == blocks[1] and blocks[0]["async_commits"] == 1


def batches(n=4):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        left = rng.uniform(0, 255, (2, H, W + 4, 3)).astype(np.float32)
        out.append({"image1": left[:, :, 4:], "image2": left[:, :, :W],
                    "flow": -rng.uniform(0, 6, (2, H, W, 1)).astype(np.float32),
                    "valid": np.ones((2, H, W), np.float32)})
    return out


def small_config(tmp_path, name, **kw):
    return TrainConfig(model=RAFTStereoConfig(hidden_dims=(16, 16, 16), corr_levels=2, corr_radius=2),
                       batch_size=2, train_iters=2, num_steps=4, name=name, checkpoint_dir=str(tmp_path / "ck"),
                       log_dir=str(tmp_path / name), **{"checkpoint_every": 2, **kw})


def test_async_fit_writes_the_synchronous_checkpoints(tmp_path):
    """Two fits from one seed over the same batches, checkpoints every 2
    steps: the async commits write byte-for-byte the synchronous payloads
    (CRC32 from each step's manifest), every step committed."""
    data = batches()
    crcs = {}
    for name, spine in (("sync", False), ("async", True)):
        trainer = Trainer(small_config(tmp_path, name, async_checkpoint=spine), (H, W, 3), device="cpu")
        trainer.fit(data)
        report = trainer.last_run_report
        assert validate_run_report(report) == [] and report["final_step"] == 4
        assert report["io_spine"]["async_checkpoint"] is spine
        assert report["io_spine"]["async_commits"] == (2 if spine else 0)
        root = tmp_path / "ck" / name
        assert ck.list_checkpoint_steps(str(root)) == [2, 4]
        crcs[name] = {}
        for step in (2, 4):
            assert ck.validate_checkpoint(str(root / str(step))) == []
            files = ck.read_manifest(str(root / str(step)))["files"]
            crcs[name][step] = {f: files[f]["crc32"] for f in (ck.MODEL_NAME, ck.OPTIMIZER_NAME)}
    assert crcs["async"] == crcs["sync"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_metrics_port_serves_during_fit(tmp_path):
    """The fit's sidecar answers GET /metrics while the loop runs (scraped
    between steps 2 and 3: two steps counted, one step-to-step time, two
    data waits), 404s elsewhere, and is shut down when fit returns."""
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    scraped = {}

    class Scraping:
        def __iter__(self):
            for i, b in enumerate(batches(3)):
                if i == 2:
                    scraped["body"] = urllib.request.urlopen(f"{url}/metrics", timeout=10).read().decode()
                    with pytest.raises(urllib.error.HTTPError):
                        urllib.request.urlopen(f"{url}/other", timeout=10)
                yield b

    trainer = Trainer(small_config(tmp_path, "prom", metrics_port=port, checkpoint_every=10), (H, W, 3),
                      device="cpu")
    trainer.fit(Scraping())
    body = scraped["body"]
    assert "# TYPE raft_train_steps_total counter" in body
    assert "\nraft_train_steps_total 2\n" in body and "raft_train_step_ms_count 1" in body
    assert "raft_train_data_wait_ms_count 2" in body
    with pytest.raises(OSError):
        urllib.request.urlopen(f"{url}/metrics", timeout=2)


def test_serve_registry_matches_jax_exposition():
    """The sidecar serves the registry's exposition, as JAX's does."""
    from raft_stereo_tpu.obs.prom import Registry as JaxRegistry
    from raft_stereo_tpu.obs.prom import serve_registry as jax_serve_registry

    bodies = []
    for make, serve in ((Registry, serve_registry), (JaxRegistry, jax_serve_registry)):
        registry = make()
        registry.counter("raft_train_steps_total", "Optimizer steps").inc(3)
        server = serve(registry, 0)
        try:
            resp = urllib.request.urlopen(f"http://127.0.0.1:{server.server_address[1]}/metrics", timeout=10)
            bodies.append((resp.headers["Content-Type"], resp.read().decode()))
        finally:
            server.shutdown()
            server.server_close()
            server._serve_thread.join(timeout=5)
        assert not server._serve_thread.is_alive()
    assert bodies[0] == bodies[1]
