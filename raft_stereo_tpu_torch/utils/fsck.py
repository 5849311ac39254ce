"""`python -m raft_stereo_tpu_torch fsck ROOT [--quarantine] [--quiet]`:
check a checkpoint root against its integrity manifests, the port's
counterpart of the JAX package's `scripts/fsck_checkpoints.py`, with its
JSON verdict and exit codes, on a machine without JAX.

Every step directory under ROOT (`checkpoints/<name>`, what `Trainer.save`
writes) is validated against its `MANIFEST.json` (each file's existence,
size and CRC32, utils/checkpoints.py `validate_checkpoint`, the authority
auto-resume acts on), and one JSON verdict goes to stdout:

    {"root": "...",
     "steps": [{"step": N, "dir": "...", "valid": true|false,
                "problems": [...], "quarantined_to": "..."|null}, ...],
     "valid_steps": [...], "invalid_steps": [...],
     "latest_valid": N|null,
     "quarantined_dirs": [...]}      # the .corrupt-* dirs under ROOT

Exit codes: 0 every step valid (or none), 1 an invalid step, 2 usage or
I/O error. `--quarantine` renames every invalid step to
`<step>.corrupt-fsck[-N]` (`quarantine_step_dir`), which auto-resume then
never reads: the manual step `Trainer.auto_resume` asks for when no step
validates. A step saved before manifests existed reads as invalid (no
manifest, no evidence of a whole write), so quarantining a legacy root is
the operator's explicit act, never automatic.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from raft_stereo_tpu_torch.utils.checkpoints import (
    CORRUPT_DIR_MARKER,
    find_latest_valid_step,
    list_checkpoint_steps,
    quarantine_step_dir,
    validate_checkpoint,
)


def fsck_root(root: str, quarantine: bool = False) -> dict:
    """Validate every step under `root`, optionally quarantining the
    invalid ones; the JSON-able verdict of the module docstring."""
    root = os.path.abspath(root)
    latest, _ = find_latest_valid_step(root)
    steps, valid_steps, invalid_steps = [], [], []
    for step in list_checkpoint_steps(root):
        step_dir = os.path.join(root, str(step))
        problems = validate_checkpoint(step_dir)
        entry = {"step": step, "dir": step_dir, "valid": not problems, "problems": problems,
                 "quarantined_to": None}
        if problems:
            invalid_steps.append(step)
            if quarantine:
                entry["quarantined_to"] = quarantine_step_dir(step_dir, reason="fsck")
        else:
            valid_steps.append(step)
        steps.append(entry)
    return {
        "root": root,
        "steps": steps,
        "valid_steps": valid_steps,
        "invalid_steps": invalid_steps,
        "latest_valid": latest,
        "quarantined_dirs": sorted(d for d in os.listdir(root) if CORRUPT_DIR_MARKER in d),
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m raft_stereo_tpu_torch fsck",
                                description=__doc__.splitlines()[0])
    p.add_argument("root", help="checkpoint root (checkpoints/<name>)")
    p.add_argument("--quarantine", action="store_true",
                   help="rename invalid step dirs to <step>.corrupt-fsck so --auto_resume never reads them")
    p.add_argument("--quiet", action="store_true", help="no output, just the exit code")
    args = p.parse_args(argv)
    if not os.path.isdir(args.root):
        print(f"not a directory: {args.root}", file=sys.stderr)
        return 2
    try:
        verdict = fsck_root(args.root, quarantine=args.quarantine)
    except OSError as e:
        print(f"cannot fsck {args.root}: {e}", file=sys.stderr)
        return 2
    if not args.quiet:
        json.dump(verdict, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    return 1 if verdict["invalid_steps"] else 0
