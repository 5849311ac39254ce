"""Times the training command line of this checkout and another in turns on
one card: the bf16 step at the JAX bench's setup (`chip_smoke.py`'s
[train-cli] flags: batch 4, 320x720, 22 iterations, worker processes, the
device prefetcher) on a FlyingThings3D tree written from a seed.

    python3 train_compare.py --other runs/parent

`--other` is another checkout's root (e.g. the parent, unpacked with `git
archive` into a git-ignored directory). The runs alternate: other, this,
this with `--strict_mode`, other, and again for each further turn. Each run
is `python -m raft_stereo_tpu_torch train ... --num_steps 10
--profile_steps 1` with that checkout on the import path; the script reads
from its log the wall time from step 4's line to step 10's over 6 (s a
step, past the kernel builds, the warm-up and the profiled step 3) and the
profiled step's device busy share (`utils/profiling.trace_summary`), and
prints one line per run, the card's name and power limit, and a JSON
summary last. Needs a CUDA card: exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGS = ("train", "--corr_implementation", "reg_cuda", "--mixed_precision", "--batch_size", "4",
         "--image_size", "320", "720", "--train_iters", "22", "--spatial_scale", "-0.2", "0.4",
         "--saturation_range", "0", "1.4", "--train_datasets", "sceneflow", "--root_dataset", "datasets",
         "--worker_type", "process", "--num_workers", "4", "--device_prefetch", "--num_steps", "10",
         "--checkpoint_every", "100", "--profile_steps", "1")
TREE = (8, 2, 540, 960)  # TRAIN pairs, TEST pairs, height, width
FIRST, LAST = 4, 10
# Not anchored at the line's start: a child process's stderr (the loader's
# resource tracker at exit) may run into a line without a newline.
STEP_LINE = re.compile(r"(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) INFO .* step (\d+): live_loss (\S+),")


def stamp(text: str) -> float:
    day, ms = text.split(",")
    return time.mktime(time.strptime(day, "%Y-%m-%d %H:%M:%S")) + int(ms) / 1e3


def run(checkout: str, workdir: str, name: str, extra=()) -> dict:
    env = dict(os.environ, PYTHONPATH=checkout)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "raft_stereo_tpu_torch", *FLAGS, *extra, "--name", name],
                          cwd=workdir, env=env, capture_output=True, text=True)
    steps = {int(n): (stamp(t), float(v)) for t, n, v in STEP_LINE.findall(proc.stderr)}
    found = re.search(r"profiler trace summary: (\{.*\})", proc.stderr)
    summary = json.loads(found.group(1)) if found else {}
    if proc.returncode != 0 or FIRST not in steps or LAST not in steps:
        raise RuntimeError(f"{name}: exit {proc.returncode}, steps {sorted(steps)}\n{proc.stderr[-3000:]}")
    return {"s_per_step": (steps[LAST][0] - steps[FIRST][0]) / (LAST - FIRST), "busy": summary.get("busy"),
            "window_ms": summary.get("window_ms"), "kernel_ms": summary.get("kernel_ms"),
            "losses": [steps[n][1] for n in sorted(steps)], "wall_s": time.perf_counter() - t0}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", required=True, help="another checkout's root")
    p.add_argument("--turns", type=int, default=2)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("train_compare: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from raft_stereo_tpu_torch.data import trees

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    workdir = tempfile.mkdtemp(prefix="train-compare-")
    try:
        trees.write_sceneflow(os.path.join(workdir, "datasets"), np.random.default_rng(0), *TREE)
        other = os.path.abspath(args.other)
        results = {"other": [], "this": [], "this-strict": []}
        for turn in range(args.turns):
            for tag, checkout, extra in (("other", other, ()), ("this", ROOT, ()),
                                         ("this-strict", ROOT, ("--strict_mode",)), ("other", other, ())):
                r = run(checkout, workdir, f"{tag}-{turn}-{len(results[tag])}", extra)
                results[tag].append(r)
                print(f"{tag}: {r['s_per_step']:.4f} s a step over steps {FIRST + 1}-{LAST}, profiled step 3 busy "
                      f"{r['busy']} ({r['kernel_ms']} of {r['window_ms']} ms), losses {r['losses']}, "
                      f"{r['wall_s']:.1f} s", flush=True)
        print(card, flush=True)
        print(json.dumps({"card": card, **{k: [{"s_per_step": r["s_per_step"], "busy": r["busy"]} for r in v]
                                           for k, v in results.items()}}), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
