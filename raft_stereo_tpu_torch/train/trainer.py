"""Training: the step, checkpoints and resume, and the resilient loop. The
port's counterpart of `raft_stereo_tpu/train/trainer.py` (`Trainer`,
`make_train_step`, `fit`), one process on one device.

`Trainer.train_step` takes one optimizer step on a batch and returns the
JAX step's metrics dict. Frozen batch norm is structural as in the JAX
package: `FrozenBatchNorm` never consumes batch statistics, so only its
scale and bias train. Under `nan_policy` "skip" or "rollback" a non-finite
loss or gradient norm leaves the parameters and the optimizer's state
(moments and count) untouched while the trainer's step count advances, as
the JAX step keeps its old params and opt_state; `learning_rate` in the
metrics is the schedule at the trainer's step, as in JAX. Under "raise"
the step raises `NonFiniteLossError` before any update lands.

Mixed precision trains as in JAX (`RAFTStereoConfig(corr_implementation=
"pallas", mixed_precision=True, corr_dtype="bfloat16")`): bf16 compute and
pyramid, with parameters, gradients, clipping, the AdamW state and the
loss in fp32, and no loss scaling.

Checkpoints (utils/checkpoints.py): `save` writes a step directory
`<checkpoint_dir>/<name>/<step>/` (`model.pth` in the reference's layout,
`optimizer.pt`, `run_state.json`) and commits it with the JAX package's
integrity manifest, written last by an atomic rename; `max_to_keep` and
`keep_period` prune as orbax's manager does. `restore`, `auto_resume`
(walking past torn steps), `rollback` and `restore_torch` (weights from a
reference `.pth`) bring a run back; the run state (loader cursor and
quarantine set, non-finite counters, the numpy and torch RNG states) is
applied by the next `fit`.

`fit` keeps the JAX loop's contract on one process: the validation hook,
`NonFiniteGuard` under all three policies, `PreemptionGuard` (SIGTERM:
final checkpoint, exit 13), `StepWatchdog` (exit 16), the device
prefetcher, the loader's failure budget, the flight recorder, and
run_report.json on every exit path. Not ported: the multi-host
coordinator, the jit-hygiene monitor, the async checkpoint committer and
the metrics sidecar (the `train` command line refuses their flags).
"""

from __future__ import annotations

import base64
import contextlib
import logging
import os
import shutil
import time
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.config import TrainConfig, finalize_train_config
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.train.loss import sequence_loss
from raft_stereo_tpu_torch.train.optimizer import make_optimizer
from raft_stereo_tpu_torch.utils.resilience import NonFiniteLossError  # noqa: F401 (re-export)

logger = logging.getLogger(__name__)


def _capture_host_rng(device: torch.device) -> Dict[str, Any]:
    """JSON-able snapshot of the host's global RNGs for the run state: the
    legacy numpy generator, torch's CPU generator and, on a card, its
    generators. The loader's streams are stateless (keyed on (seed, epoch,
    index)); anything else that samples resumes exactly with these."""
    name, keys, pos, has_gauss, cached = np.random.get_state()
    snap: Dict[str, Any] = {
        "np_legacy": [name, np.asarray(keys).tolist(), int(pos), int(has_gauss), float(cached)],
        "torch_cpu": base64.b64encode(torch.get_rng_state().numpy().tobytes()).decode(),
    }
    if device.type == "cuda" and torch.cuda.is_initialized():
        snap["torch_cuda"] = [base64.b64encode(s.numpy().tobytes()).decode() for s in torch.cuda.get_rng_state_all()]
    return snap


def _restore_host_rng(snapshot: Dict[str, Any]) -> None:
    """Best-effort by contract: a malformed snapshot degrades to a warning,
    never aborts the resume it rides in on."""
    snapshot = snapshot or {}
    try:
        legacy = snapshot.get("np_legacy")
        if legacy:
            name, keys, pos, has_gauss, cached = legacy
            np.random.set_state((name, np.asarray(keys, np.uint32), int(pos), int(has_gauss), float(cached)))
        if snapshot.get("torch_cpu"):
            torch.set_rng_state(torch.frombuffer(bytearray(base64.b64decode(snapshot["torch_cpu"])), dtype=torch.uint8))
        if snapshot.get("torch_cuda") and torch.cuda.is_available():
            states = [torch.frombuffer(bytearray(base64.b64decode(s)), dtype=torch.uint8)
                      for s in snapshot["torch_cuda"]]
            torch.cuda.set_rng_state_all(states[:torch.cuda.device_count()])
    except (ValueError, TypeError, RuntimeError):
        logger.warning("could not restore host RNG state from checkpoint", exc_info=True)


def _until_stopped(data: Iterable, pguard) -> Iterable:
    """Iterate `data`; once a stop signal has arrived, a failure of the data
    stream ends the epoch instead of the run: a signal sent to the process
    group stops the loader's worker processes too, and the preempted run
    still owes its final checkpoint."""
    it = iter(data)
    while True:
        try:
            batch = next(it)
        except StopIteration:
            return
        except Exception:
            if not pguard.stop_requested:
                raise
            logger.warning("data stream ended after the stop signal", exc_info=True)
            return
        yield batch


class Trainer:
    """Owns the model, the optimizer and schedule, the step count and the
    checkpoints.

    `sample_shape` is (H, W, C) of one training image; every batch must
    have it. The model's weights are drawn from `config.seed`
    (`models/init.build_model`)."""

    def __init__(self, config: TrainConfig, sample_shape: Tuple[int, int, int], device="cuda"):
        config = finalize_train_config(config)
        if sample_shape[2] != config.model.in_channels:
            raise ValueError(f"sample_shape {tuple(sample_shape)} has {sample_shape[2]} channels; "
                             f"the model takes {config.model.in_channels}")
        self.config = config
        self.sample_shape = tuple(sample_shape)
        self.device = torch.device(device)
        self.model = build_model(config.model, seed=config.seed, device=self.device)
        self.optimizer, self.schedule = make_optimizer(
            list(self.model.parameters()), config.lr, config.num_steps, config.wdecay, config.grad_clip_norm
        )
        self.step = 0
        # Step of the newest save issued through this trainer: the final
        # fit() save skips a step the periodic cadence already wrote.
        self._last_saved_step: Optional[int] = None
        # What the last fit() absorbed (run_report.json's payload).
        self.last_run_report: Dict[str, Any] = {}
        # Resume provenance (run_report.json schema v2).
        self.resumed_from_step: Optional[int] = None
        self.resume_count = 0
        self.fallback_steps_skipped = 0
        # Run state read from a restored checkpoint, applied by the next fit().
        self._pending_run_state: Optional[Dict[str, Any]] = None

    # --- the step ---------------------------------------------------------
    def _device_batch(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch's four arrays as float32 tensors on the device, after a
        shape check. A batch already on the device (the prefetcher's)
        passes through without a copy."""
        b = self.config.batch_size
        h, w, c = self.sample_shape
        want = {"image1": (b, h, w, c), "image2": (b, h, w, c), "flow": (b, h, w, 1), "valid": (b, h, w)}
        out = {}
        for key, shape in want.items():
            t = torch.as_tensor(batch[key])
            if tuple(t.shape) != shape:
                raise ValueError(f"batch[{key!r}] has shape {tuple(t.shape)}, expected {shape}")
            out[key] = t.to(device=self.device, dtype=torch.float32)
        return out

    def train_step(self, batch: Mapping[str, Any]) -> Dict[str, float]:
        """One optimizer step: image1/image2 (B, H, W, C) in [0, 255], flow
        (B, H, W, 1), valid (B, H, W), as numpy arrays or tensors. Returns
        epe, 1px, 3px, 5px, live_loss, grad_norm (before clipping),
        nonfinite (1.0 when the loss or the norm was NaN/Inf) and
        learning_rate (the schedule at this step)."""
        cfg = self.config
        b = self._device_batch(batch)
        self.optimizer.zero_grad(set_to_none=True)
        flows = self.model(b["image1"], b["image2"], iters=cfg.train_iters)
        loss, metrics = sequence_loss(flows, b["flow"], b["valid"], cfg.loss_gamma, cfg.max_flow)
        loss.backward()
        grad_norm = self.optimizer.clip_grads_()
        values = torch.stack([*metrics.values(), loss.detach(), grad_norm]).tolist()
        finite = bool(np.isfinite(values[-2]) and np.isfinite(values[-1]))
        if finite:
            self.optimizer.step()
        elif cfg.nan_policy == "raise":
            raise NonFiniteLossError(f"non-finite loss/grad_norm at step {self.step} (nan_policy=raise)")
        out = dict(zip(metrics, values))
        out.update(live_loss=values[-2], grad_norm=values[-1], nonfinite=0.0 if finite else 1.0,
                   learning_rate=self.schedule(self.step))
        self.step += 1
        return out

    # --- checkpoints --------------------------------------------------------
    def checkpoint_path(self) -> str:
        """This run's checkpoint root (the --restore_ckpt value that resumes it)."""
        return os.path.abspath(os.path.join(self.config.checkpoint_dir, self.config.name))

    def _retry_io(self, fn, label: str):
        """Transient-I/O retry for checkpoint operations (utils/retry.py)."""
        from raft_stereo_tpu_torch.utils.retry import is_transient_io, retry_call

        return retry_call(fn, attempts=self.config.io_retries, base_delay=self.config.io_backoff,
                          classify=is_transient_io, label=label)

    def _optimizer_state(self) -> Dict[str, Any]:
        return {"optimizer": self.optimizer.state_dict(), "count": int(self.optimizer.count), "step": int(self.step)}

    def save(self, run_state: Optional[Dict[str, Any]] = None) -> str:
        """Write this step's directory and commit it: `model.pth` and
        `optimizer.pt`, then `run_state.json` and the integrity manifest,
        whose atomic rename is the commit point (a kill at any byte before
        it leaves a step that `validate_checkpoint` rejects and auto-resume
        walks past). Then prune to `max_to_keep` / `keep_period`. Returns
        the step directory."""
        from raft_stereo_tpu_torch.utils import checkpoints as ck

        step = int(self.step)
        root = self.checkpoint_path()
        step_dir = os.path.join(root, str(step))
        if os.path.exists(step_dir):
            raise FileExistsError(f"checkpoint step {step} already exists at {step_dir!r}")
        rs = run_state if run_state is not None else self._minimal_run_state(step)
        opt_state = self._optimizer_state()

        def write() -> None:
            # `ck` resolved at call time, so a test can intercept the
            # sequence between the payload and the manifest.
            ck.write_step_files(step_dir, self.model, opt_state)
            ck.commit_step_sidecars(step_dir, step, rs)

        self._retry_io(write, label=f"checkpoint save (step {step})")
        self._last_saved_step = step
        for old in ck.steps_to_prune(ck.list_checkpoint_steps(root), self.config.max_to_keep,
                                     self.config.keep_period):
            shutil.rmtree(os.path.join(root, str(old)), ignore_errors=True)
        return step_dir

    def _minimal_run_state(self, step: int) -> Dict[str, Any]:
        """run_state for saves issued outside fit(): enough for resume
        provenance to stay consistent."""
        return {"run_state_version": 1, "step": int(step), "resume_count": int(self.resume_count)}

    def _load_step(self, step_dir: str) -> None:
        from raft_stereo_tpu_torch.utils import checkpoints as ck

        with torch.no_grad():
            ck.load_reference_checkpoint(self.model, os.path.join(step_dir, ck.MODEL_NAME))
        state = ck.read_optimizer_state(step_dir)
        self.optimizer.load_state_dict(state["optimizer"])
        self.optimizer.count = int(state["count"])
        self.step = int(state["step"])

    def restore(self, step: Optional[int] = None, path: Optional[str] = None,
                load_run_state: Optional[bool] = None) -> int:
        """Restore the full train state (weights, AdamW moments and count,
        step). With `path`, from any checkpoint root or step directory;
        else from this run's own root (the newest step, or `step`).

        `load_run_state` decides whether the step's run state is staged for
        the next fit() with resume provenance recorded. None resolves it by
        intent, as in JAX: True for this run's own checkpoints (a resume),
        False for another run's (a warm start must not adopt a donor's
        loader cursor, quarantine set or spent budget). Rollback passes
        False: it rewinds the weights, not the failure accounting."""
        from raft_stereo_tpu_torch.utils import checkpoints as ck

        root = self.checkpoint_path()
        if path is not None:
            if load_run_state is None:
                try:
                    load_run_state = os.path.commonpath([os.path.abspath(path), root]) == root
                except ValueError:
                    load_run_state = False
            step_dir = ck.resolve_step_dir(path, step)
        else:
            if load_run_state is None:
                load_run_state = True
            steps = ck.list_checkpoint_steps(root)
            step = (steps[-1] if steps else None) if step is None else step
            if step is None:
                raise FileNotFoundError("no checkpoint to restore")
            step_dir = os.path.join(root, str(step))
        self._retry_io(lambda: self._load_step(step_dir), label=f"checkpoint restore ({step_dir})")
        if path is None:
            self._last_saved_step = int(self.step)
        restored_step = int(self.step)
        if load_run_state:
            run_state = ck.read_run_state(step_dir)
            self._pending_run_state = run_state
            self.resumed_from_step = restored_step
            prior = int(run_state.get("resume_count", 0)) if run_state else self.resume_count
            self.resume_count = prior + 1
            if run_state is None:
                logger.info("checkpoint at step %d carries no run_state bundle: weights and optimizer "
                            "restored; data-stream position and failure counters start fresh", restored_step)
        return restored_step

    def auto_resume(self) -> Optional[int]:
        """Crash-consistent resume: restore the newest step of this run
        whose manifest verifies, quarantining every newer torn step
        (renamed `<step>.corrupt-*`). None starts fresh (no root or no
        steps). When invalid steps exist but none validates, raises: nothing
        proves those dirs dead, and a fresh run would collide with them at
        its first save."""
        from raft_stereo_tpu_torch.utils import checkpoints as ck

        root = self.checkpoint_path()
        if not os.path.isdir(root):
            logger.info("auto-resume: no checkpoint root at %s; starting fresh", root)
            return None
        step, skipped = ck.find_latest_valid_step(root, quarantine=True)
        self.fallback_steps_skipped = len(skipped)
        if step is None:
            if skipped:
                raise FileNotFoundError(
                    f"auto-resume: no valid checkpoint under {root!r} but {len(skipped)} invalid step dir(s) "
                    f"{[s for s, _ in skipped]} are present (torn saves). Inspect them, then either "
                    "quarantine them to start this run fresh, or point --restore_ckpt at a step you trust.")
            logger.info("auto-resume: no checkpoints under %s; starting fresh", root)
            return None
        if skipped:
            logger.warning("auto-resume: fell back past %d invalid step(s) %s to step %d",
                           len(skipped), [s for s, _ in skipped], step)
        restored = self.restore(step=step)
        logger.info("auto-resume: restored step %d from %s (resume #%d%s)", restored, root, self.resume_count,
                    f", {len(skipped)} corrupt step(s) quarantined" if skipped else "")
        return restored

    def rollback(self) -> int:
        """Restore the newest checkpoint of this run, the last good state
        under nan_policy="rollback" (non-finite updates never land, so every
        saved state is finite)."""
        from raft_stereo_tpu_torch.utils import checkpoints as ck

        steps = ck.list_checkpoint_steps(self.checkpoint_path())
        if not steps:
            raise FileNotFoundError(f"rollback requested but no checkpoint exists in {self.checkpoint_path()!r}")
        return self.restore(step=steps[-1], load_run_state=False)

    def restore_torch(self, path: str) -> None:
        """Load a reference `.pth` (weights only; the optimizer restarts, as
        the reference's does)."""
        from raft_stereo_tpu_torch.utils.checkpoints import load_reference_checkpoint

        with torch.no_grad():
            load_reference_checkpoint(self.model, path)

    # --- the loop -----------------------------------------------------------
    def fit(self, data: Iterable[Mapping[str, Any]], metrics_logger=None, validate_fn=None):
        """Run up to config.num_steps steps over `data`, an iterable of host
        batches re-iterated when exhausted (the reference's epoch-wrapping
        loop). `validate_fn(model) -> {metric: value}` runs every
        `validate_every` steps and logs through `metrics_logger`.

        SIGTERM/SIGINT stop the run at the next step boundary with a final
        checkpoint; non-finite steps follow `nan_policy` (rollback restores
        the last good checkpoint after `nan_patience` bad steps and
        re-iterates `data`, a fresh shuffle); checkpoints retry transient
        I/O; a stalled step boundary trips the watchdog. A staged run state
        (restore/auto_resume) is applied first, so a resumed run continues
        the data stream and failure accounting where the checkpoint
        stopped. On every exit path `self.last_run_report` holds the
        run-health report, also written to <log_dir>/run_report.json; the
        command line maps it onto exit codes. Returns the last step's
        metrics (the JAX `fit` returns its state; the port's model is
        `self.model`)."""
        from raft_stereo_tpu_torch.obs.trace import Tracer, observability_block
        from raft_stereo_tpu_torch.utils import run_report as rr
        from raft_stereo_tpu_torch.utils.checkpoints import list_checkpoint_steps
        from raft_stereo_tpu_torch.utils.profiling import StepTimer, trace
        from raft_stereo_tpu_torch.utils.resilience import (
            FailureBudgetExceeded,
            NonFiniteGuard,
            PreemptionGuard,
            StepWatchdog,
        )

        self.config = cfg = finalize_train_config(self.config)
        step = self.step
        start_step = step
        timer = StepTimer()
        profile_window = range(start_step + 2, start_step + 2 + cfg.profile_steps) if cfg.profile_steps else range(0)
        profile_ctx = None
        guard = NonFiniteGuard(cfg.nan_policy, patience=cfg.nan_patience)
        pguard = PreemptionGuard()
        if cfg.log_dir:
            os.makedirs(cfg.log_dir, exist_ok=True)
        tracer = Tracer(capacity=cfg.flight_recorder_events,
                        dump_path=os.path.join(cfg.log_dir, "flight_recorder.json") if cfg.log_dir else None)
        prefetcher = None
        if cfg.device_prefetch:
            from raft_stereo_tpu_torch.data.prefetch import DevicePrefetcher

            data = prefetcher = DevicePrefetcher(data, self.device)
        quarantine = getattr(data, "quarantine", None)

        pending = self._pending_run_state
        self._pending_run_state = None
        if pending:
            if pending.get("guard"):
                guard.load_state_dict(pending["guard"])
            if pending.get("loader") and hasattr(data, "load_state_dict"):
                data.load_state_dict(pending["loader"])
            if pending.get("host_rng"):
                _restore_host_rng(pending["host_rng"])
            logger.info(
                "resumed run state at step %d: loader %s, %d skipped steps, %d rollbacks, "
                "%d quarantined samples (resume #%d)", step,
                {k: pending["loader"][k] for k in ("epoch", "batch_cursor")} if pending.get("loader") else "n/a",
                guard.skipped_total, guard.rollbacks, len(quarantine.indices) if quarantine else 0,
                self.resume_count)

        def make_run_state() -> Dict[str, Any]:
            rs: Dict[str, Any] = {
                "run_state_version": 1,
                "step": self.step,
                "resume_count": int(self.resume_count),
                "guard": guard.state_dict(),
                "host_rng": _capture_host_rng(self.device),
            }
            if hasattr(data, "state_dict"):
                rs["loader"] = data.state_dict()
            return rs

        def make_report(stop_cause, error=None, traces=None, final_step=None):
            return rr.build_run_report(
                stop_cause=stop_cause,
                final_step=self.step if final_step is None else final_step,
                last_good_step=self._last_saved_step if self._last_saved_step is not None else -1,
                checkpoint_path=self.checkpoint_path() if self._last_saved_step is not None else None,
                preempted=pguard.stop_requested,
                preempt_signal=pguard.signame,
                skipped_steps=guard.skipped_total,
                rollbacks=guard.rollbacks,
                dropped_samples=int(quarantine.dropped) if quarantine else 0,
                quarantined=len(quarantine.indices) if quarantine else 0,
                resumed_from_step=self.resumed_from_step if self.resumed_from_step is not None else -1,
                resume_count=self.resume_count,
                fallback_steps_skipped=self.fallback_steps_skipped,
                watchdog=watchdog.state(),
                io_spine={
                    "async_checkpoint": False,
                    "device_prefetch": bool(cfg.device_prefetch),
                    "async_commits": 0,
                    "max_commit_latency_s": 0.0,
                    **(prefetcher.stats() if prefetcher is not None
                       else {"prefetch_depth_watermark": 0, "device_put_overlap_fraction": 0.0}),
                },
                observability=observability_block(tracer),
                error=error,
                traces=traces,
            )

        def on_watchdog_timeout(diag):
            # Runs on the monitor thread while the main thread is wedged:
            # persist the verdict before the hard exit, from host state only.
            beat_step = watchdog.last_beat_step
            self.last_run_report = make_report("watchdog", traces=diag["traces"],
                                               final_step=beat_step if beat_step is not None else -1)
            rr.write_run_report(self.last_run_report, cfg.log_dir)
            tracer.dump("watchdog")

        watchdog = StepWatchdog(cfg.step_timeout_s, on_timeout=on_watchdog_timeout, exit_code=rr.EXIT_WATCHDOG,
                                first_grace_s=cfg.watchdog_grace_s)
        watchdog.on_fire = lambda diag: tracer.event("watchdog_fire", elapsed_s=float(diag["elapsed_s"]),
                                                     step=diag.get("step"), phase=diag.get("phase"))
        if validate_fn is not None and getattr(validate_fn, "set_heartbeat", None) is not None:
            def _validation_heartbeat():
                watchdog.beat()
                watchdog.grant(cfg.watchdog_grace_s)

            validate_fn.set_heartbeat(_validation_heartbeat)

        # Non-finite flags awaiting the host check: (step, flag).
        pending_flags: list = []

        def drain_flags() -> str:
            flags = list(pending_flags)
            pending_flags.clear()
            for s, bad in flags:
                if bad:
                    tracer.event("nonfinite", step=s)
                if guard.observe(bad, s) == "rollback":
                    tracer.dump("nonfinite-rollback")
                    return "rollback"
            return "ok"

        def save_now(final: bool = False) -> None:
            watchdog.grant(cfg.watchdog_grace_s)
            watchdog.mark_phase("final-save" if final else "checkpoint-save")
            t_save0 = time.perf_counter()
            self.save(run_state=make_run_state())
            tracer.span("checkpoint-save", t0=t_save0, t1=time.perf_counter(), step=self.step, final=final)
            watchdog.mark_phase(None)

        stop_cause = "completed"
        error_repr = None
        metrics: Dict[str, float] = {}
        try:
            stopping = False
            want_rollback = False
            pending_reseed = False  # a rollback is waiting on a fresh data epoch
            with pguard if cfg.handle_signals else contextlib.nullcontext(), watchdog:
                if cfg.nan_policy == "rollback" and not list_checkpoint_steps(self.checkpoint_path()):
                    # Rollback needs a last good anchor before the first
                    # periodic save: the initial (or restored) state.
                    self.save(run_state=make_run_state())
                    watchdog.beat(step)
                    watchdog.grant(cfg.watchdog_grace_s)
                while step < cfg.num_steps and not stopping:
                    epoch_batches = 0
                    boundary_t = time.perf_counter()
                    for batch in _until_stopped(data, pguard):
                        epoch_batches += 1
                        t_batch = time.perf_counter()
                        tracer.span("data-wait", t0=boundary_t, t1=t_batch, step=step + 1)
                        pending_reseed = False
                        if profile_window and step == profile_window.start:
                            profile_ctx = trace(os.path.join(cfg.log_dir, "profile"))
                            profile_ctx.__enter__()
                        metrics = self.train_step(batch)
                        timer.tick()
                        tracer.span("step", t0=t_batch, t1=time.perf_counter(), step=step + 1)
                        step = self.step
                        logger.info("step %d: live_loss %.9g, grad_norm %.9g, epe %.6g, %.3f s", step,
                                    metrics["live_loss"], metrics["grad_norm"], metrics["epe"],
                                    time.perf_counter() - t_batch)
                        if profile_ctx is not None and step >= profile_window.stop:
                            profile_ctx.__exit__(None, None, None)
                            profile_ctx = None
                        pending_flags.append((step, metrics["nonfinite"] > 0.0))
                        if len(pending_flags) >= cfg.nan_check_every and drain_flags() == "rollback":
                            want_rollback = True
                        if metrics_logger is not None:
                            extra = guard.stats()
                            loader_stats = getattr(data, "resilience_stats", None)
                            if loader_stats is not None:
                                extra.update(loader_stats())
                            metrics_logger.push(dict(metrics, **extra), step)
                        if step % cfg.checkpoint_every == 0:
                            # Never checkpoint an unchecked non-finite window.
                            if not want_rollback and drain_flags() == "rollback":
                                want_rollback = True
                            if not want_rollback:
                                save_now()
                                watchdog.beat(step)
                        if validate_fn is not None and step % cfg.validate_every == 0:
                            watchdog.grant(cfg.watchdog_grace_s)
                            watchdog.mark_phase("validation")
                            try:
                                results = validate_fn(self.model)
                            finally:
                                watchdog.mark_phase(None)
                            watchdog.beat(step)
                            logger.info("validation (%d): %s", step, results)
                            if metrics_logger is not None:
                                metrics_logger.write(results, step)
                        if pguard.stop_requested:
                            stopping = True
                        if want_rollback:
                            want_rollback = False
                            if profile_ctx is not None:
                                profile_ctx.__exit__(None, None, None)
                                profile_ctx = None
                            profile_window = range(0)
                            step = self.rollback()
                            watchdog.beat(step)
                            pending_reseed = True
                            logger.warning("rolled back to step %d after %d consecutive non-finite steps; "
                                           "re-seeding the data stream", step, cfg.nan_patience)
                            # A fresh iter(data): a loader derives its shuffle
                            # from the epoch counter.
                            break
                        watchdog.beat(step)
                        boundary_t = time.perf_counter()
                        if stopping or step >= cfg.num_steps:
                            break
                    if pguard.stop_requested:
                        break
                    if epoch_batches == 0:
                        if pending_reseed:
                            raise NonFiniteLossError(
                                "rollback could not re-seed the data stream (one-shot iterable exhausted); use a "
                                "re-iterable loader with nan_policy=rollback")
                        if step > start_step:
                            break  # a one-shot iterator ran out after progress
                        raise ValueError("data iterable yielded no batches (dataset smaller than one batch, or an "
                                         "exhausted generator was passed)")
                if profile_ctx is not None:
                    profile_ctx.__exit__(None, None, None)
                drain_flags()
                stats = timer.report(self.device)
                if stats:
                    logger.info("step timing: %s", stats)
                if self.device.type == "cuda":
                    logger.info("peak device memory: %d bytes allocated, %d bytes reserved",
                                torch.cuda.max_memory_allocated(self.device),
                                torch.cuda.max_memory_reserved(self.device))
                if self._last_saved_step != self.step:
                    save_now(final=True)
                watchdog.beat(self.step)
            if pguard.stop_requested:
                stop_cause = "preempted"
                logger.warning("training stopped by %s at step %d with a committed checkpoint; resume by rerunning "
                               "with --auto_resume (or --restore_ckpt %s)", pguard.signame, self.step,
                               self.checkpoint_path())
        except BaseException as e:
            if isinstance(e, NonFiniteLossError):
                stop_cause = "nonfinite"
            elif isinstance(e, FailureBudgetExceeded):
                stop_cause = "failure_budget"
            elif isinstance(e, KeyboardInterrupt):
                stop_cause = "preempted"
            else:
                stop_cause = "error"
            error_repr = repr(e)
            raise
        finally:
            if not watchdog.fired:
                self.last_run_report = make_report(stop_cause, error=error_repr)
                rr.write_run_report(self.last_run_report, cfg.log_dir)
                tracer.dump(f"fit-exit:{stop_cause}")
        return metrics
