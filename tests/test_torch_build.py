"""The port's kernel build (ops/_build.py), without nvcc: each source's own
flags reach its command line and the hash that names its library."""

from pathlib import Path

from raft_stereo_tpu_torch.ops import _build

EXACT = ("corr_lookup", "corr_scatter", "gru_tail", "encoder_join")
CONTRACTED = ("corr_pyramid", "encoder_conv")


def test_every_source_has_flags():
    sources = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    assert sources == sorted(EXACT + CONTRACTED) == sorted(_build.SOURCE_FLAGS)


def test_per_source_flags_reach_the_command_line():
    for name in EXACT + CONTRACTED:
        cmd = _build.nvcc_command("nvcc", name, Path("/out/lib.so"))
        assert cmd[0] == "nvcc" and cmd[-1] == str(_build.CSRC_DIR / f"{name}.cu")
        assert cmd[-3:-1] == ["-o", "/out/lib.so"]
        assert "arch=compute_90a,code=sm_90a" in cmd and "-O3" in cmd
        assert ("-fmad=false" in cmd) == (name in EXACT)
        assert ("-fmad=true" in cmd) == (name in CONTRACTED)
        assert not any("fast_math" in flag for flag in cmd)


def test_library_hash_covers_the_flags(monkeypatch):
    before = {name: _build._target(name) for name in EXACT + CONTRACTED}
    assert len(set(before.values())) == len(before)
    monkeypatch.setitem(_build.SOURCE_FLAGS, "encoder_conv", ("-fmad=false",))
    assert _build._target("encoder_conv") != before["encoder_conv"]
    assert _build._target("corr_lookup") == before["corr_lookup"]
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert all(_build._target(name) != before[name] for name in EXACT)
