"""The kernel-library cache (serving/aot.py, ops/_build.py), the port's
counterpart of the JAX package's AOT executable cache
(raft_stereo_tpu/serving/aot.py, tests/test_boot.py).

- The fingerprint is stable for one toolchain and card and moves with the
  nvcc version, the arch flags, the card and the format version, as JAX's
  moves with jaxlib and the device kind.
- Hit, miss and eviction accounting through a stand-in compiler and loader
  (`torch_parity.fake_toolchain`; the CPU tests have no nvcc): a first boot
  misses and builds, a second (a fresh process's load table) hits and
  builds nothing, and every damage (changed bytes, a library that does not
  load, a missing digest) is evicted loudly, counted as an eviction and a
  miss, and built again; `entries == cache_hits + cache_misses` always.
- The build directory is set once per process; the serving boot reports
  the cache's numbers.
- On the card (gpu-marked): a real nvcc build into the cache, then a hit.
"""

import logging

import pytest

from raft_stereo_tpu_torch.config import RAFTStereoConfig, ServeConfig
from raft_stereo_tpu_torch.ops import _build
from raft_stereo_tpu_torch.serving import aot
from raft_stereo_tpu_torch.serving.service import StereoService
from torch_parity import FAKE_LIBRARY, fake_toolchain, torch_single_thread  # noqa: F401 (fixtures)


def test_fingerprint_stable_and_sensitive(monkeypatch):
    base = aot.fingerprint()
    assert base == aot.fingerprint() and len(base) == 16
    changes = [
        (aot, "_nvcc_version", lambda: "Cuda compilation tools, release 99.9"),
        (aot, "_card", lambda: {"name": "NVIDIA H200", "capability": [9, 0]}),
        (aot, "FORMAT_VERSION", aot.FORMAT_VERSION + 1),
        (_build, "NVCC_FLAGS", tuple(f.replace("sm_90a", "sm_100a") for f in _build.NVCC_FLAGS)),
    ]
    for target, name, value in changes:
        with monkeypatch.context() as m:
            m.setattr(target, name, value)
            assert aot.fingerprint() != base, name
    assert aot.fingerprint() == base


def fresh_process(monkeypatch):
    """What a new process sees: no library loaded yet."""
    monkeypatch.setattr(_build, "_libs", {})


def test_hits_misses_and_evictions(tmp_path, monkeypatch, fake_toolchain, caplog):
    cache = aot.KernelCache(str(tmp_path / "cache"))
    assert _build.BUILD_DIR == (tmp_path / "cache" / cache.fingerprint).resolve()
    for name in ("gates", "gru_tail"):
        _build.load(name)
    _build.load("gates")  # loaded already: no lookup
    stats = cache.stats()
    assert (stats["cache_hits"], stats["cache_misses"], stats["entries"], stats["evictions"]) == (0, 2, 2, 0)
    assert fake_toolchain.compiles == ["gates", "gru_tail"] and cache.files() == 2
    cache.close()

    # A second boot: everything from the cache, nothing built.
    fresh_process(monkeypatch)
    cache = aot.KernelCache(str(tmp_path / "cache"))
    for name in ("gates", "gru_tail"):
        _build.load(name)
    assert cache.stats()["cache_hits"] == cache.stats()["entries"] == 2 and cache.stats()["cache_misses"] == 0
    assert fake_toolchain.compiles == ["gates", "gru_tail"]
    cache.close()

    # Damage: changed bytes (the digest no longer matches), a library that
    # does not load under a matching digest, a missing digest.
    gates, tail = _build._target("gates"), _build._target("gru_tail")
    data = bytearray(gates.read_bytes())
    data[len(data) // 2] ^= 0xFF
    gates.write_bytes(bytes(data))
    tail.write_bytes(b"\x7fELF truncated")
    _build._digest_file(tail).write_text(_build._sha256(tail))
    fresh_process(monkeypatch)
    cache = aot.KernelCache(str(tmp_path / "cache"))
    with caplog.at_level(logging.WARNING, logger=_build.__name__):
        for name in ("gates", "gru_tail"):
            _build.load(name)
    stats = cache.stats()
    assert (stats["cache_hits"], stats["cache_misses"], stats["evictions"]) == (0, 2, 2)
    assert stats["entries"] == stats["cache_hits"] + stats["cache_misses"]
    assert sum("evicted" in r.message for r in caplog.records) == 2
    assert gates.read_bytes().startswith(FAKE_LIBRARY) and tail.read_bytes().startswith(FAKE_LIBRARY)
    assert fake_toolchain.compiles == ["gates", "gru_tail", "gates", "gru_tail"]
    cache.close()

    _build._digest_file(gates).unlink()
    fresh_process(monkeypatch)
    cache = aot.KernelCache(str(tmp_path / "cache"))
    _build.load("gates")
    assert (cache.stats()["cache_misses"], cache.stats()["evictions"]) == (1, 1)
    cache.close()


def test_build_dir_is_set_once_per_process(tmp_path, fake_toolchain):
    _build.set_build_dir(tmp_path / "a")
    _build.set_build_dir(tmp_path / "b")  # nothing loaded yet: free to move
    _build.load("gates")
    assert _build.set_build_dir(tmp_path / "b") == (tmp_path / "b").resolve()
    with pytest.raises(RuntimeError, match="cannot move"):
        _build.set_build_dir(tmp_path / "a")
    with pytest.raises(RuntimeError, match="cannot move"):
        aot.maybe_cache(str(tmp_path / "cache"))


def test_maybe_cache_gating(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    assert aot.maybe_cache(None) is None and aot.maybe_cache("") is None
    (tmp_path / "file").write_text("not a directory")
    with caplog.at_level(logging.WARNING, logger=aot.__name__):
        assert aot.maybe_cache(str(tmp_path / "file" / "cache")) is None
    assert "disabled" in caplog.text
    cache = aot.maybe_cache(str(tmp_path / "cache"))
    assert cache is not None and cache.stats()["enabled"] is True
    cache.close()


def test_service_boot_block_reports_the_cache(tmp_path, fake_toolchain):
    """A CPU boot loads no kernel library; the boot block carries the
    cache's numbers (enabled, no entries) and the engine's hygiene block
    reaches /healthz."""
    cfg = ServeConfig(model=RAFTStereoConfig(hidden_dims=(32, 32, 32)), buckets=((64, 96),), max_batch=1,
                      chunk_iters=1, max_iters=1, aot_cache_dir=str(tmp_path / "cache"))
    service = StereoService(cfg, device="cpu").start()
    try:
        boot = service.boot_block()
        assert boot["cache_enabled"] and boot["entries"] == boot["cache_hits"] == boot["cache_misses"] == 0
        assert boot["compiles_total"] == 0 and service.warm_summary["aot_cache"]["dir"].startswith(str(tmp_path))
        jh = service.healthz()["jit_hygiene"]
        assert jh["compiles_post_grace"] == 0 and jh["whitelisted_windows"] == {"warmup": 1}
    finally:
        service.close()
    plain = StereoService(ServeConfig(model=cfg.model, buckets=cfg.buckets, max_batch=1, chunk_iters=1, max_iters=1),
                          device="cpu")
    assert plain.aot_cache is None
    plain.close()


@pytest.mark.gpu
def test_real_build_then_hit_on_the_card(tmp_path, monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs nvcc and a CUDA device: the kernel libraries are built for the card")
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    fresh_process(monkeypatch)
    cache = aot.KernelCache(str(tmp_path))
    _build.load("gates")
    assert cache.stats()["cache_misses"] == 1 and _build._digest_file(_build._target("gates")).exists()
    cache.close()
    fresh_process(monkeypatch)
    cache = aot.KernelCache(str(tmp_path))
    _build.load("gates")
    assert cache.stats()["cache_hits"] == 1 and cache.stats()["cache_misses"] == 0
    cache.close()
