"""`python -m raft_stereo_tpu_torch check-report PATH [--quiet]` and
`check-report --selftest`: validate a run_report.json against the schema
(utils/run_report.py `validate_run_report`), the port's counterpart of the
JAX package's `scripts/check_run_report.py`, with its output and exit
codes, on a machine without JAX.

Exit codes: 0 valid (a summary line on stdout), 1 invalid (the problems
on stderr), 2 usage or I/O error. `--selftest` checks the validator
against what `build_run_report` writes, with and without the additive
`jit_hygiene`, `io_spine` and `observability` blocks, and against torn
and mistyped variants of each (the JAX script's cases): 0 when every
case gets its verdict, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from raft_stereo_tpu_torch.utils.run_report import EXIT_CODES, build_run_report, validate_run_report


def _report(**blocks):
    return build_run_report(stop_cause="completed", final_step=10, **blocks)


def selftest_cases() -> list:
    """(name, report, should be valid) for every case of the self-check."""
    hygiene = {"strict_mode": True, "recompile_grace": 2, "transfer_guard": "disallow", "compiles_total": 1,
               "compiles_post_grace": 0, "compiles_whitelisted": 3, "steps_seen": 10,
               "whitelisted_windows": {"checkpoint_save": 2, "validation": 1}, "violations": []}
    spine = {"async_checkpoint": True, "device_prefetch": True, "async_commits": 3, "max_commit_latency_s": 0.41,
             "prefetch_depth_watermark": 1, "device_put_overlap_fraction": 0.92}
    obs = {"enabled": True, "capacity": 256, "traces_total": 12, "spans_total": 48, "events_total": 3,
           "dropped_total": 0, "dumps_total": 1}

    def without(block: dict, key: str) -> dict:
        return {k: v for k, v in block.items() if k != key}

    wrong_exit = build_run_report(stop_cause="preempted", final_step=5)
    wrong_exit["exit_code"] = 0
    return [
        ("minimal v2 (no jit_hygiene)", _report(), True),
        ("with jit_hygiene block", _report(jit_hygiene=hygiene), True),
        ("jit_hygiene missing a key", _report(jit_hygiene=without(hygiene, "compiles_post_grace")), False),
        ("jit_hygiene mistyped strict_mode", _report(jit_hygiene=dict(hygiene, strict_mode="yes")), False),
        ("post_grace count != violations length", _report(jit_hygiene=dict(hygiene, compiles_post_grace=2)),
         False),
        ("exit_code/stop_cause mismatch", wrong_exit, False),
        ("non-object report", ["not", "a", "dict"], False),
        ("with io_spine block", _report(io_spine=spine), True),
        ("io_spine missing a key", _report(io_spine=without(spine, "async_commits")), False),
        ("io_spine mistyped async_checkpoint", _report(io_spine=dict(spine, async_checkpoint="yes")), False),
        ("io_spine overlap fraction out of range", _report(io_spine=dict(spine, device_put_overlap_fraction=1.5)),
         False),
        ("io_spine negative commit latency", _report(io_spine=dict(spine, max_commit_latency_s=-0.1)), False),
        ("with observability block", _report(observability=obs), True),
        ("observability missing a key", _report(observability=without(obs, "spans_total")), False),
        ("observability mistyped enabled", _report(observability=dict(obs, enabled="yes")), False),
        ("observability negative counter", _report(observability=dict(obs, spans_total=-1)), False),
        ("observability disabled but capacity > 0", _report(observability=dict(obs, enabled=False)), False),
    ]


def selftest(quiet: bool = False) -> int:
    failures = 0
    cases = selftest_cases()
    for name, report, should_be_valid in cases:
        problems = validate_run_report(report)
        ok = (not problems) == should_be_valid
        failures += not ok
        if not quiet:
            print(f"  [{'ok' if ok else 'FAIL'}] {name}: {problems or 'valid'}")
    if not quiet:
        print(f"selftest: {len(cases) - failures}/{len(cases)} cases passed")
    return 1 if failures else 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m raft_stereo_tpu_torch check-report",
                                description=__doc__.splitlines()[0])
    p.add_argument("report", nargs="?", help="path to a run_report.json")
    p.add_argument("--quiet", action="store_true", help="no output, just the exit code")
    p.add_argument("--selftest", action="store_true",
                   help="check the validator against build_run_report's output and known-broken variants")
    args = p.parse_args(argv)
    if args.selftest:
        return selftest(quiet=args.quiet)
    if args.report is None:
        p.error("a report path is required unless --selftest is given")
    try:
        with open(args.report) as f:
            report = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"cannot read {args.report}: {e}", file=sys.stderr)
        return 2
    problems = validate_run_report(report)
    if problems:
        if not args.quiet:
            print(f"{args.report}: INVALID", file=sys.stderr)
            for msg in problems:
                print(f"  - {msg}", file=sys.stderr)
        return 1
    if not args.quiet:
        resume = (f", resumed_from_step={report['resumed_from_step']}, resume_count={report['resume_count']}, "
                  f"fallback_steps_skipped={report['fallback_steps_skipped']}"
                  if report.get("resume_count", 0) or report.get("fallback_steps_skipped", 0) else "")
        jh = report.get("jit_hygiene")
        hygiene = (f", strict_mode={jh['strict_mode']}, compiles_post_grace={jh['compiles_post_grace']}"
                   if isinstance(jh, dict) else "")
        print(f"{args.report}: valid (stop_cause={report['stop_cause']}, exit_code={EXIT_CODES[report['stop_cause']]}, "
              f"final_step={report['final_step']}, last_good_step={report['last_good_step']}{resume}{hygiene})")
    return 0
