"""The port's jit hygiene (utils/jit_hygiene.py) and the sync-free step,
against the JAX package's (raft_stereo_tpu/utils/jit_hygiene.py,
tests/test_jit_hygiene.py).

- Monitor parity: one script of step boundaries, whitelisted windows and
  compile events gives the same report in both packages. JAX's events are
  XLA compiles of a tiny jitted function at new shapes; the port's are
  kernel builds by ops/_build.py, run through a stand-in `nvcc`
  (`torch_parity.fake_toolchain`: the CPU tests have none).
- A strict fit on the CPU carries a complete `jit_hygiene` block (the
  guard is off on the CPU: no device-host boundary), and a kernel built
  after the grace window fails it with RecompileError, as JAX's strict
  mode fails a steady-state recompile.
- The guarded apply: a `skip` run over (good, good, bad, good) ends with
  parameters and moments bit for bit those of a run over (good, good,
  good), its step count and logged learning rate advanced, at
  nan_check_every 1 and 3.
- The sync guard's windows (set_sync_debug_mode recorded on the CPU; the
  real mode on the card, gpu-marked) and the gloo refusal.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from raft_stereo_tpu.utils.jit_hygiene import JitHygiene as JaxJitHygiene
from raft_stereo_tpu_torch import cli
from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig
from raft_stereo_tpu_torch.data import trees
from raft_stereo_tpu_torch.ops import _build
from raft_stereo_tpu_torch.train.trainer import Trainer
from raft_stereo_tpu_torch.utils.jit_hygiene import JitHygiene, RecompileError, RecompileMonitor
from raft_stereo_tpu_torch.utils.metrics import MetricsLogger
from raft_stereo_tpu_torch.utils.run_report import RUN_REPORT_NAME, validate_run_report
from torch_parity import fake_toolchain, torch_single_thread  # noqa: F401 (fixtures)

H, W = 48, 64
MODEL = RAFTStereoConfig(hidden_dims=(16, 16, 16), corr_levels=2, corr_radius=2, n_gru_layers=1)


def batch(rng, bad=False):
    b = {"image1": rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32),
         "image2": rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32),
         "flow": rng.uniform(-8, 0, (1, H, W, 1)).astype(np.float32),
         "valid": np.ones((1, H, W), np.float32)}
    if bad:
        b["image1"][:] = np.nan
    return b


def train_config(tmp_path, **kw):
    kw.setdefault("num_steps", 3)
    return TrainConfig(model=MODEL, batch_size=1, train_iters=2, checkpoint_dir=str(tmp_path / "ck"),
                       log_dir=str(tmp_path / "runs"), **kw)


# --- the monitor, against JAX's ------------------------------------------------

def run_script(hygiene, compile_event):
    """Grace 2: a compile in step 1, one in step 2, then past the grace
    window one inside a validation window and one outside it."""
    with hygiene.guard():
        compile_event()
        hygiene.step(1)
        compile_event()
        hygiene.step(2)
        with hygiene.whitelist("validation"):
            compile_event()
        compile_event()
        hygiene.step(3)
    return hygiene.report()


def test_monitor_report_matches_jax(fake_toolchain):
    shapes = iter(range(3, 13))

    def jax_compile():
        # A new shape: one XLA compile of the jitted function.
        jax.jit(lambda x: x * 2.0)(np.ones(next(shapes), np.float32)).block_until_ready()

    want = run_script(JaxJitHygiene(strict=False, recompile_grace=2), jax_compile)
    sources = iter(("gates", "gru_tail", "corr_lookup", "encoder_join"))
    got = run_script(JitHygiene(strict=False, recompile_grace=2, device="cpu"),
                     lambda: _build.build([next(sources)]))
    assert len(got.pop("violations")) == len(want.pop("violations")) == 1
    assert got == want
    assert got["compiles_total"] == 4 and got["compiles_whitelisted"] == 1 and got["compiles_post_grace"] == 1
    assert got["whitelisted_windows"] == {"validation": 1}
    assert fake_toolchain.compiles == ["gates", "gru_tail", "corr_lookup", "encoder_join"]


def test_monitor_hard_fails_and_unregisters(fake_toolchain):
    mon = RecompileMonitor(grace_steps=1, hard_fail=True)
    with mon:
        _build.build(["gates"])
        mon.advance(1)  # inside grace
        _build.build(["gru_tail"])
        with pytest.raises(RecompileError, match="steady-state recompile.*gru_tail"):
            mon.advance(2)
    seen = mon.compiles_total
    _build.build(["corr_lookup"])  # after the monitor closed
    assert mon.compiles_total == seen == 2 and mon.stats()["compiles_post_grace"] == 1
    # Loading a library already built is not a compile.
    with RecompileMonitor(grace_steps=0) as quiet:
        _build.load("gates")
    assert quiet.compiles_total == 0 and fake_toolchain.loaded


# --- strict fit ------------------------------------------------------------------

def test_strict_fit_reports_a_complete_block(tmp_path):
    cfg = train_config(tmp_path, strict_mode=True, validate_every=3, checkpoint_every=2)
    trainer = Trainer(cfg, (H, W, 3), device="cpu")
    rng = np.random.default_rng(0)
    calls = []
    trainer.fit([batch(rng) for _ in range(3)], validate_fn=lambda model: calls.append(1) or {"fake": 1.0})
    report = trainer.last_run_report
    assert report["stop_cause"] == "completed" and validate_run_report(report) == []
    jh = report["jit_hygiene"]
    assert jh["strict_mode"] is True and jh["recompile_grace"] == 2 and jh["transfer_guard"] == "off"
    assert jh["compiles_post_grace"] == 0 and jh["violations"] == [] and jh["steps_seen"] == 3
    assert jh["whitelisted_windows"]["nonfinite_drain"] == 3 and jh["whitelisted_windows"]["validation"] == 1
    assert jh["whitelisted_windows"]["checkpoint_save"] == 2 and len(calls) == 1
    on_disk = json.load(open(os.path.join(cfg.log_dir, RUN_REPORT_NAME)))
    assert on_disk["jit_hygiene"] == jh


def test_strict_fit_fails_on_a_late_build(tmp_path, fake_toolchain):
    """A kernel first built at step 3, past the grace window of 2 and
    outside any whitelist: RecompileError at that step's boundary, recorded
    in the report."""
    cfg = train_config(tmp_path, strict_mode=True, num_steps=4, checkpoint_every=10**6)
    trainer = Trainer(cfg, (H, W, 3), device="cpu")
    dispatch = trainer.dispatch_step

    def late_build(b, t0=None):
        if trainer.step == 2:
            _build.build(["gates"])
        return dispatch(b, t0=t0)

    trainer.dispatch_step = late_build
    rng = np.random.default_rng(1)
    with pytest.raises(RecompileError, match="steady-state recompile"):
        trainer.fit([batch(rng) for _ in range(4)])
    report = trainer.last_run_report
    assert report["stop_cause"] == "error" and validate_run_report(report) == []
    assert report["jit_hygiene"]["compiles_post_grace"] == 1 and report["jit_hygiene"]["steps_seen"] == 3


@pytest.mark.parametrize("nan_check_every", [1, 3])
def test_skipped_step_leaves_the_state_bit_for_bit(tmp_path, nan_check_every):
    rng = np.random.default_rng(2)
    good = [batch(rng) for _ in range(3)]
    runs = {}
    # One schedule (num_steps 4) for both; the clean run's one-shot stream
    # ends after its three batches.
    for name, data in (("skip", [good[0], good[1], batch(rng, bad=True), good[2]]), ("clean", iter(good))):
        cfg = train_config(tmp_path / name, num_steps=4, nan_policy="skip",
                           nan_check_every=nan_check_every, checkpoint_every=10**6)
        trainer = Trainer(cfg, (H, W, 3), device="cpu")
        trainer.fit(data, metrics_logger=MetricsLogger(log_every=1, log_dir=cfg.log_dir))
        logged = [json.loads(line) for line in open(os.path.join(cfg.log_dir, "metrics.jsonl"))]
        runs[name] = trainer, {m["step"]: m for m in logged}
    (skip, skip_log), (clean, clean_log) = runs["skip"], runs["clean"]
    assert skip.step == 4 and clean.step == 3 and skip.optimizer.count == clean.optimizer.count == 3
    assert all(torch.equal(a, b) for a, b in zip(skip.model.parameters(), clean.model.parameters()))
    for p, q in zip(skip.model.parameters(), clean.model.parameters()):
        for k in ("mu", "nu"):
            assert torch.equal(skip.optimizer.state[p][k], clean.optimizer.state[q][k])
    assert skip_log[3]["nonfinite"] == 1.0 and skip_log[4]["nonfinite"] == 0.0
    assert [skip_log[s]["learning_rate"] for s in (1, 2, 3, 4)] == [skip.schedule(n) for n in range(4)]
    assert skip_log[2]["live_loss"] == clean_log[2]["live_loss"]
    assert skip.last_run_report["skipped_steps"] == 1


def test_strict_train_cli_with_a_kernel_cache(tmp_path, monkeypatch):
    """`train --strict_mode --recompile_grace 3 --compilation_cache_dir`
    runs (exit 0) and reports the block; the cache directory is the
    process's build directory (monkeypatch puts it back)."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    trees.write_sceneflow(str(tmp_path / "datasets"), np.random.default_rng(3), 2, 0, h=60, w=88, max_disp=8.0)
    monkeypatch.chdir(tmp_path)
    argv = ["train", "--device", "cpu", "--hidden_dims", "16", "16", "16", "--corr_levels", "2", "--corr_radius", "2",
            "--n_gru_layers", "1", "--batch_size", "1", "--image_size", "48", "64", "--train_iters", "1",
            "--num_steps", "2", "--root_dataset", "datasets", "--num_workers", "1", "--strict_mode",
            "--recompile_grace", "3", "--compilation_cache_dir", "kcache"]
    assert cli.main(argv) == 0
    jh = json.load(open(tmp_path / "runs" / RUN_REPORT_NAME))["jit_hygiene"]
    assert (jh["strict_mode"], jh["recompile_grace"], jh["transfer_guard"], jh["steps_seen"]) == (True, 3, "off", 2)
    assert _build.BUILD_DIR.parent == tmp_path / "kcache"


# --- the sync guard ---------------------------------------------------------------

def test_guard_windows_switch_the_sync_mode(monkeypatch):
    """The mode sequence, recorded (no card in the CPU tests): the guard
    sets "error", a window reopens "default" and the guard closes again
    when the last window ends, also on an exception; the previous mode
    comes back after the guard."""
    modes = []
    monkeypatch.setattr(JitHygiene, "_set_mode", lambda self, mode: modes.append(mode))
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    hygiene = JitHygiene(strict=True, device="cpu")
    hygiene.guards_syncs = True  # as on a card
    with hygiene.guard():
        with hygiene.transfer_window("drain"):
            with hygiene.whitelist("validation"):
                pass
        with pytest.raises(ValueError):
            with hygiene.whitelist("checkpoint_save"):
                raise ValueError("in the window")
    assert modes == ["error", "default", "default", "error", "default", "error", 0]
    assert hygiene.whitelisted_windows == {"drain": 1, "validation": 1, "checkpoint_save": 1}
    assert hygiene.report()["transfer_guard"] == "disallow"


def test_guard_is_off_on_the_cpu():
    hygiene = JitHygiene(strict=True, device="cpu")
    with hygiene.guard():
        assert torch.ones(3).sum().item() == 3.0  # no boundary to guard
    assert hygiene.report()["transfer_guard"] == "off" and not hygiene.guards_syncs


def test_strict_mode_refuses_gloo_on_the_card(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    assert "gloo" in cli.strict_mode_problem(True, "cuda")
    assert cli.strict_mode_problem(False, "cuda") is None and cli.strict_mode_problem(True, "cpu") is None
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    assert cli.strict_mode_problem(True, "cuda") is None


@pytest.mark.gpu
def test_guard_raises_on_a_sync_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sync guard acts on a card only")
    x = torch.ones(4, device="cuda")
    hygiene = JitHygiene(strict=True, device="cuda")
    with hygiene.guard():
        with pytest.raises(RuntimeError, match="synchroniz"):
            x.sum().item()
        with hygiene.transfer_window("fetch"):
            assert x.sum().item() == 4.0
        y = x * 2  # launches, no sync
    assert torch.cuda.get_sync_debug_mode() == 0 and y.sum().item() == 8.0
    assert hygiene.report()["transfer_guard"] == "disallow"
