"""Machine-readable run health: the `run_report.json` schema, a copy of
`raft_stereo_tpu/utils/run_report.py` (`build_run_report`,
`validate_run_report`, `atomic_write_json`, `write_run_report`). The
trainer writes it to <log_dir>/run_report.json on every exit path of
`fit`, and the train command line for failures before the trainer exists;
the serving front's /healthz payload is a run report plus an additive
`serving` block, so one validator covers both. `validate_run_report` is the
schema authority.

Schema (version 2) — keys marked * are required:

    schema_version*   int   — 2
    stop_cause*       str   — one of STOP_CAUSES
    exit_code*        int   — EXIT_CODES[stop_cause]
    final_step*       int   — step counter when the run ended
    last_good_step*   int   — newest step with a durable checkpoint (-1: none)
    checkpoint_path*  str|null — --restore_ckpt value that resumes the run
    preempted*        bool  — a stop signal (local or a peer's) ended the run
    preempt_signal    str|null — e.g. "SIGTERM", or "peer" when another host
                              received the signal and coordination stopped us
    skipped_steps*    int   — non-finite updates dropped (device-side skip)
    rollbacks*        int   — checkpoint restores under nan_policy=rollback
    dropped_samples*  int   — loader samples dropped on THIS host
    quarantined*      int   — distinct sample indices quarantined on this host
    resumed_from_step* int  — step this run restored at startup (-1: fresh)
    resume_count*     int   — how many times this run chain has resumed
                              (carried through the checkpoint run_state)
    fallback_steps_skipped* int — torn/corrupt checkpoint steps auto-resume
                              had to walk past to find a valid anchor
    process_index*    int   — writer's process index
    process_count*    int   — pod size at the time of writing
    coord_syncs*      int   — pod-agreement collectives dispatched by fit()
    watchdog*         dict  — {enabled, fired, timeout_s, last_beat_step, phase}
    jit_hygiene       dict  — OPTIONAL (additive): jit-hygiene verdict
                              from utils/jit_hygiene.py. When present:
                                strict_mode            bool — sync guard +
                                                       build hard-fail on
                                recompile_grace        int  — build grace steps
                                transfer_guard         str  — "disallow" (the
                                                       sync guard on a card) |
                                                       "off"
                                compiles_total         int  — kernel builds (nvcc)
                                compiles_post_grace    int  — compiles after grace
                                                       outside whitelists (0 on a
                                                       hygienic steady-state run)
                                compiles_whitelisted   int  — compiles inside
                                                       labelled windows
                                steps_seen             int  — monitor boundaries
                                whitelisted_windows    dict — {label: open count}
                                violations             list — human-readable
                                                       post-grace compile records
                              Absent in reports from v2 writers and from the
                              pre-trainer error paths — validators must treat
                              absence as "not measured", not as a failure.
    io_spine          dict  — OPTIONAL (additive): training I/O spine
                              health from train/io_spine.py. When present:
                                async_checkpoint       bool — background commit on
                                device_prefetch        bool — device double-buffer on
                                async_commits          int  — background commits run
                                max_commit_latency_s   num  — slowest commit (flush
                                                       + sidecars), seconds
                                prefetch_depth_watermark int — max staged batches
                                                       observed (0..1: maxsize-1)
                                device_put_overlap_fraction num — fraction of step
                                                       fetches that found batch N+1
                                                       already staged, in [0, 1]
                              Same additive contract as jit_hygiene: absence is
                              "not measured", presence means complete + typed.
    observability     dict  — OPTIONAL (additive): flight-recorder
                              lifetime counters from obs/trace.py. When present:
                                enabled                bool — ring capacity > 0
                                capacity               int  — ring size (0 when off)
                                traces_total           int  — trace IDs minted
                                spans_total            int  — spans recorded
                                events_total           int  — point events recorded
                                dropped_total          int  — records evicted/refused
                                dumps_total            int  — flight_recorder.json
                                                       dumps written
                              Same additive contract as jit_hygiene.
    error             str|null — exception repr for stop_cause error/nonfinite/
                              failure_budget
    traces            str|null — all-thread stack dump (watchdog timeouts)

Version history: v2 added the resume-provenance fields
(resumed_from_step / resume_count / fallback_steps_skipped) and the
watchdog phase label as required keys; the jit_hygiene, io_spine and
observability blocks are ADDITIVE within v2: optional keys, no bump. The
port's run reports and /healthz carry `jit_hygiene` as JAX's do; its
compiles are the kernel libraries' `nvcc` builds.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 2
RUN_REPORT_NAME = "run_report.json"

# Terminal failure classes, each mapped to a distinct documented process
# exit code (README "Operations" exit-code table). 0/1/2 keep their POSIX
# meanings (clean / unclassified error / usage); the resilience classes
# start at 13 to stay clear of shell and signal-128+n conventions.
STOP_CAUSES = (
    "completed",       # ran to num_steps (or data exhausted after progress)
    "preempted",       # stop signal on this host or a peer; resume-able
    "nonfinite",       # NaN/Inf divergence exhausted the nan_policy
    "failure_budget",  # loader dropped-sample budget exceeded (pod-global)
    "watchdog",        # a step/collective hung past step_timeout_s
    "error",           # anything else
)

EXIT_OK = 0
EXIT_ERROR = 1
EXIT_USAGE = 2
EXIT_PREEMPTED = 13
EXIT_NONFINITE = 14
EXIT_FAILURE_BUDGET = 15
EXIT_WATCHDOG = 16

EXIT_CODES: Dict[str, int] = {
    "completed": EXIT_OK,
    "preempted": EXIT_PREEMPTED,
    "nonfinite": EXIT_NONFINITE,
    "failure_budget": EXIT_FAILURE_BUDGET,
    "watchdog": EXIT_WATCHDOG,
    "error": EXIT_ERROR,
}

_REQUIRED: Dict[str, type] = {
    "schema_version": int,
    "stop_cause": str,
    "exit_code": int,
    "final_step": int,
    "last_good_step": int,
    "preempted": bool,
    "skipped_steps": int,
    "rollbacks": int,
    "dropped_samples": int,
    "quarantined": int,
    "resumed_from_step": int,
    "resume_count": int,
    "fallback_steps_skipped": int,
    "process_index": int,
    "process_count": int,
    "coord_syncs": int,
    "watchdog": dict,
}
_WATCHDOG_REQUIRED: Dict[str, type] = {
    "enabled": bool,
    "fired": bool,
    "timeout_s": (int, float),  # type: ignore[dict-item]
}
# Required keys INSIDE the optional jit_hygiene block (additive: the block
# itself may be absent; when present it must be complete).
_JIT_HYGIENE_REQUIRED: Dict[str, type] = {
    "strict_mode": bool,
    "recompile_grace": int,
    "transfer_guard": str,
    "compiles_total": int,
    "compiles_post_grace": int,
    "compiles_whitelisted": int,
    "steps_seen": int,
    "whitelisted_windows": dict,
    "violations": list,
}
# Required keys INSIDE the optional io_spine block (additive —
# same contract: the block may be absent; present means complete).
_IO_SPINE_REQUIRED: Dict[str, type] = {
    "async_checkpoint": bool,
    "device_prefetch": bool,
    "async_commits": int,
    "max_commit_latency_s": (int, float),  # type: ignore[dict-item]
    "prefetch_depth_watermark": int,
    "device_put_overlap_fraction": (int, float),  # type: ignore[dict-item]
}
# Required keys INSIDE the optional observability block (additive —
# obs/trace.observability_block(): flight-recorder lifetime counters).
_OBSERVABILITY_REQUIRED: Dict[str, type] = {
    "enabled": bool,
    "capacity": int,
    "traces_total": int,
    "spans_total": int,
    "events_total": int,
    "dropped_total": int,
    "dumps_total": int,
}


def build_run_report(
    stop_cause: str,
    final_step: int,
    last_good_step: int = -1,
    checkpoint_path: Optional[str] = None,
    preempted: bool = False,
    preempt_signal: Optional[str] = None,
    skipped_steps: int = 0,
    rollbacks: int = 0,
    dropped_samples: int = 0,
    quarantined: int = 0,
    resumed_from_step: int = -1,
    resume_count: int = 0,
    fallback_steps_skipped: int = 0,
    process_index: int = 0,
    process_count: int = 1,
    coord_syncs: int = 0,
    watchdog: Optional[Dict[str, Any]] = None,
    jit_hygiene: Optional[Dict[str, Any]] = None,
    io_spine: Optional[Dict[str, Any]] = None,
    observability: Optional[Dict[str, Any]] = None,
    error: Optional[str] = None,
    traces: Optional[str] = None,
) -> Dict[str, Any]:
    """Assemble a schema-valid report dict. `stop_cause` picks the exit code.
    `jit_hygiene`, `io_spine` and `observability` (optional, additive) are
    the JitHygiene.report() / build_io_spine_block() /
    observability_block() blocks — each omitted entirely when not provided
    so v2 consumers see no new key."""
    if stop_cause not in STOP_CAUSES:
        raise ValueError(f"stop_cause {stop_cause!r} not in {STOP_CAUSES}")
    report = {
        "schema_version": SCHEMA_VERSION,
        "stop_cause": stop_cause,
        "exit_code": EXIT_CODES[stop_cause],
        "final_step": int(final_step),
        "last_good_step": int(last_good_step),
        "checkpoint_path": checkpoint_path,
        "preempted": bool(preempted),
        "preempt_signal": preempt_signal,
        "skipped_steps": int(skipped_steps),
        "rollbacks": int(rollbacks),
        "dropped_samples": int(dropped_samples),
        "quarantined": int(quarantined),
        "resumed_from_step": int(resumed_from_step),
        "resume_count": int(resume_count),
        "fallback_steps_skipped": int(fallback_steps_skipped),
        "process_index": int(process_index),
        "process_count": int(process_count),
        "coord_syncs": int(coord_syncs),
        "watchdog": dict(
            watchdog
            if watchdog is not None
            else {
                "enabled": False,
                "fired": False,
                "timeout_s": 0.0,
                "last_beat_step": None,
                "phase": None,
            }
        ),
        "error": error,
        "traces": traces,
    }
    if jit_hygiene is not None:
        report["jit_hygiene"] = dict(jit_hygiene)
    if io_spine is not None:
        report["io_spine"] = dict(io_spine)
    if observability is not None:
        report["observability"] = dict(observability)
    return report


def atomic_write_json(path: str, payload: Dict[str, Any], durable: bool = False) -> None:
    """Crash-atomic JSON write (tmp + rename): a crash at any byte, or a
    concurrent reader, sees either the old file or the new one, never a
    torn mix. With `durable=True` the file and its directory are fsync'd
    around the rename, surviving power loss as well as process death (the
    checkpoint manifest's commit marker); run reports and flight-recorder
    dumps are advisory and skip the sync cost."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
        if durable:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if durable:
        # Persist the rename itself (a failure here degrades to
        # rename-without-dir-sync, still atomic).
        try:
            dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass


def write_run_report(report: Dict[str, Any], log_dir: str, name: str = RUN_REPORT_NAME) -> str:
    """Atomically write `report` as <log_dir>/<name> (run_report.json;
    rank k > 0 of a multi-rank run writes run_report.p<k>.json); returns the
    path. Never raises into an exiting trainer (callers sit in finally
    blocks): filesystem failures are swallowed after a best-effort attempt,
    and the exit code still carries the verdict."""
    path = os.path.join(log_dir, name)
    try:
        os.makedirs(log_dir, exist_ok=True)
        atomic_write_json(path, report)
    except OSError:
        pass
    return path


def validate_run_report(report: Any) -> List[str]:
    """Schema check shared by the tests, the trainer, `/healthz` and the
    `check-report` command (utils/check_report.py; the JAX package's
    `scripts/check_run_report.py` runs that package's copy of this check).
    Returns a list of human-readable problems; empty list == valid."""
    problems: List[str] = []
    if not isinstance(report, dict):
        return [f"report must be a JSON object, got {type(report).__name__}"]
    for key, typ in _REQUIRED.items():
        if key not in report:
            problems.append(f"missing required key {key!r}")
        elif not isinstance(report[key], typ) or (
            typ is int and isinstance(report[key], bool)
        ):
            problems.append(
                f"{key!r} must be {getattr(typ, '__name__', typ)}, "
                f"got {type(report[key]).__name__}"
            )
    if problems:
        return problems
    if report["schema_version"] != SCHEMA_VERSION:
        problems.append(
            f"schema_version {report['schema_version']} != {SCHEMA_VERSION}"
        )
    cause = report["stop_cause"]
    if cause not in STOP_CAUSES:
        problems.append(f"stop_cause {cause!r} not in {STOP_CAUSES}")
    elif report["exit_code"] != EXIT_CODES[cause]:
        problems.append(
            f"exit_code {report['exit_code']} does not match stop_cause "
            f"{cause!r} (expected {EXIT_CODES[cause]})"
        )
    ckpt = report.get("checkpoint_path")
    if ckpt is not None and not isinstance(ckpt, str):
        problems.append("checkpoint_path must be a string or null")
    wd = report["watchdog"]
    for key, typ in _WATCHDOG_REQUIRED.items():
        if key not in wd:
            problems.append(f"watchdog missing key {key!r}")
        elif not isinstance(wd[key], typ) or (
            typ is not bool and isinstance(wd[key], bool)
        ):
            # bool is an int subclass: exclude it from numeric fields, the
            # same way the top-level int fields are checked.
            problems.append(f"watchdog[{key!r}] has wrong type {type(wd[key]).__name__}")
    if cause == "watchdog" and not wd.get("fired", False):
        problems.append("stop_cause is watchdog but watchdog.fired is false")
    # jit_hygiene is additive: absent (or null) is "not measured" and valid;
    # present means the block must be complete and well-typed.
    jh = report.get("jit_hygiene")
    if jh is not None:
        if not isinstance(jh, dict):
            problems.append(
                f"jit_hygiene must be an object, got {type(jh).__name__}"
            )
        else:
            for key, typ in _JIT_HYGIENE_REQUIRED.items():
                if key not in jh:
                    problems.append(f"jit_hygiene missing key {key!r}")
                elif not isinstance(jh[key], typ) or (
                    typ is not bool and isinstance(jh[key], bool)
                ):
                    problems.append(
                        f"jit_hygiene[{key!r}] has wrong type "
                        f"{type(jh[key]).__name__}"
                    )
            for key in ("compiles_total", "compiles_post_grace",
                        "compiles_whitelisted", "steps_seen"):
                if isinstance(jh.get(key), int) and jh[key] < 0:
                    problems.append(f"jit_hygiene[{key!r}] must be >= 0")
            if (
                isinstance(jh.get("compiles_post_grace"), int)
                and isinstance(jh.get("violations"), list)
                and jh["compiles_post_grace"] != len(jh["violations"])
            ):
                problems.append(
                    "jit_hygiene.compiles_post_grace does not match its "
                    "violations list length"
                )
    # io_spine is additive like jit_hygiene: absent/null is "not measured".
    ios = report.get("io_spine")
    if ios is not None:
        if not isinstance(ios, dict):
            problems.append(f"io_spine must be an object, got {type(ios).__name__}")
        else:
            for key, typ in _IO_SPINE_REQUIRED.items():
                if key not in ios:
                    problems.append(f"io_spine missing key {key!r}")
                elif not isinstance(ios[key], typ) or (
                    typ is not bool and isinstance(ios[key], bool)
                ):
                    problems.append(
                        f"io_spine[{key!r}] has wrong type {type(ios[key]).__name__}"
                    )
            for key in ("async_commits", "prefetch_depth_watermark"):
                if isinstance(ios.get(key), int) and ios[key] < 0:
                    problems.append(f"io_spine[{key!r}] must be >= 0")
            lat = ios.get("max_commit_latency_s")
            if isinstance(lat, (int, float)) and not isinstance(lat, bool) and lat < 0:
                problems.append("io_spine['max_commit_latency_s'] must be >= 0")
            frac = ios.get("device_put_overlap_fraction")
            if (
                isinstance(frac, (int, float))
                and not isinstance(frac, bool)
                and not 0.0 <= frac <= 1.0
            ):
                problems.append(
                    "io_spine['device_put_overlap_fraction'] must be in [0, 1], "
                    f"got {frac}"
                )
    # observability is additive like jit_hygiene/io_spine: absent/null is
    # "not measured"; present means complete, typed, and non-negative.
    obs = report.get("observability")
    if obs is not None:
        if not isinstance(obs, dict):
            problems.append(
                f"observability must be an object, got {type(obs).__name__}"
            )
        else:
            for key, typ in _OBSERVABILITY_REQUIRED.items():
                if key not in obs:
                    problems.append(f"observability missing key {key!r}")
                elif not isinstance(obs[key], typ) or (
                    typ is not bool and isinstance(obs[key], bool)
                ):
                    problems.append(
                        f"observability[{key!r}] has wrong type "
                        f"{type(obs[key]).__name__}"
                    )
            for key in (
                "capacity",
                "traces_total",
                "spans_total",
                "events_total",
                "dropped_total",
                "dumps_total",
            ):
                if isinstance(obs.get(key), int) and obs[key] < 0:
                    problems.append(f"observability[{key!r}] must be >= 0")
            if (
                obs.get("enabled") is False
                and isinstance(obs.get("capacity"), int)
                and obs["capacity"] > 0
            ):
                problems.append(
                    "observability.enabled is false but capacity > 0 — "
                    "recorder state is inconsistent"
                )
    if not (0 <= report["process_index"] < max(1, report["process_count"])):
        problems.append(
            f"process_index {report['process_index']} out of range for "
            f"process_count {report['process_count']}"
        )
    if report["resumed_from_step"] < -1:
        problems.append(
            f"resumed_from_step must be >= -1, got {report['resumed_from_step']}"
        )
    for key in ("resume_count", "fallback_steps_skipped"):
        if report[key] < 0:
            problems.append(f"{key} must be >= 0, got {report[key]}")
    if report["resumed_from_step"] == -1 and report["resume_count"] > 0:
        problems.append(
            "resume_count > 0 but resumed_from_step is -1 (fresh start) — "
            "resume provenance is inconsistent"
        )
    return problems
