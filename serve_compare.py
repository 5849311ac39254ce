"""Send one burst of stereo requests to this checkout's `StereoService` and
to another checkout's (e.g. the parent commit, unpacked with `git
archive`), in turns, on one card:

    python3 serve_compare.py --other runs/parent

Each turn is a fresh process in one checkout's root (default turns:
other, this, this, other). It builds that checkout's kernels, boots
`StereoService` in the kernel configuration (fp32, the dense lookup and
the fused GRU tail kernels; buckets 384x512 and 512x768, max batch 4,
chunk 4, 32 iterations, seed-0 weights with every conv kernel halved, as
`chip_smoke.py`'s `[serving-front]`) and sends the burst that phase
sends over HTTP, here in process: `FRONT_CLIENTS` client threads, each
submitting its share of `FRONT_BURST` one request after another and
waiting on each answer. The requests are integer images made from
`--seed`, the same in every turn.
It uses only what every checkout's service has: `StereoService(config,
model, device)`, `start()`, `submit(...).result()` and `close()`.

Each turn prints one JSON line: requests/s over the burst's wall time,
the latency of each answered request from submit to result (p50, p99,
max, client side), the rejected count, the boot seconds, and the batches
the service ran where it keeps a batch log. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

CHILD = r'''
import importlib.util, json, os, statistics, sys, threading, time
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
spec = importlib.util.spec_from_file_location("compare", sys.argv[2])
compare = importlib.util.module_from_spec(spec)
spec.loader.exec_module(compare)
from raft_stereo_tpu_torch.config import RAFTStereoConfig, ServeConfig
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.ops import _build
from raft_stereo_tpu_torch.serving.service import StereoService

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
_build.build(sorted(_build.SOURCE_FLAGS))
config = RAFTStereoConfig(corr_implementation="pallas", fused_gru_tail=True)
model = build_model(config, seed=0, device="cpu")
with torch.no_grad():
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.weight.mul_(0.5)
t0 = time.perf_counter()
service = StereoService(ServeConfig(model=config, buckets=((384, 512), (512, 768)), max_batch=4, chunk_iters=4,
                                    max_iters=32), model.to("cuda"), device="cuda").start()
boot_s = time.perf_counter() - t0
try:
    row = compare.run_burst(service, compare.burst_jobs(int(sys.argv[3])))
finally:
    close = getattr(service, "close", None)
    if close is not None:
        close()
log = getattr(getattr(service, "batcher", None), "metrics", None)
row.update(tag=sys.argv[1], boot_s=boot_s, card=compare.gpu_line(),
           batches=[[f"{b[0]}x{b[1]}", r, p] for b, r, p in log.batch_log] if log is not None else None)
print("COMPARE " + json.dumps(row), flush=True)
'''

# The serving burst, here and in chip_smoke.py's [serving-front]:
# (label, (H, W), count).
FRONT_CLIENTS = 8
FRONT_BURST = (
    ("384x512 bucket", (384, 512), 13),
    ("512x768 bucket", (512, 768), 5),
    ("padded 300x500", (300, 500), 7),
    ("padded 400x600", (400, 600), 5),
    ("oversize 520x64", (520, 64), 1),
)


def burst_jobs(seed: int):
    """The burst's stereo pairs in a seeded order: integer intensities,
    the right image the left shifted by 12 columns plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    jobs = []
    for label, (h, w), n in FRONT_BURST:
        for _ in range(n):
            left = np.floor(rng.uniform(0, 255, (h, w + 12, 3))).astype(np.float32)
            right = np.clip(left[:, 12:] + np.floor(rng.normal(0, 2, (h, w, 3))), 0, 255).astype(np.float32)
            jobs.append((label, left[:, :w].copy(), right))
    return [jobs[i] for i in rng.permutation(len(jobs))]


def run_burst(service, jobs, clients: int = FRONT_CLIENTS) -> dict:
    """`clients` threads, each submitting its share of `jobs` in turn and
    waiting on each answer. An input larger than every bucket counts as
    rejected; any other error is raised."""
    import statistics
    import threading
    import time

    lat_ms, rejected, errors = [], [], []

    def client(k):
        for i in range(k, len(jobs), clients):
            label, a, b = jobs[i]
            t = time.perf_counter()
            try:
                service.submit(a, b).result(timeout=600)
            except ValueError as exc:  # BucketOverflowError
                if not label.startswith("oversize"):
                    errors.append(repr(exc))
                rejected.append(label)
                continue
            except Exception as exc:  # noqa: BLE001 - raised below
                errors.append(repr(exc))
                continue
            lat_ms.append((time.perf_counter() - t) * 1e3)

    threads = [threading.Thread(target=client, args=(k,), name=f"client-{k}") for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"burst failed: {errors}")
    lat = sorted(lat_ms)
    return {
        "requests": len(jobs),
        "answered": len(lat),
        "rejected": len(rejected),
        "burst_s": wall,
        "requests_per_s": len(jobs) / wall,
        "latency_p50_ms": statistics.median(lat),
        "latency_p99_ms": lat[min(len(lat) - 1, round(0.99 * (len(lat) - 1)))],
        "latency_max_ms": lat[-1],
    }


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip()


def run_turn(root: str, tag: str, seed: int, timeout: int = 900) -> int:
    here = os.path.abspath(__file__)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", CHILD, tag, here, str(seed)], cwd=root, env=env,
                          timeout=timeout, text=True, capture_output=True)
    for line in proc.stdout.splitlines():
        if line.startswith("COMPARE "):
            print(line[len("COMPARE "):], flush=True)
    if proc.returncode != 0:
        print(f"[{tag}] exit {proc.returncode}: {proc.stderr[-3000:]}", file=sys.stderr, flush=True)
    return proc.returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--turns", default="other,this,this,other")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    roots = {"this": os.path.dirname(os.path.abspath(__file__)), "other": os.path.abspath(args.other)}
    rc = 0
    for tag in args.turns.split(","):
        rc |= run_turn(roots[tag], tag, args.seed)
    return rc


if __name__ == "__main__":
    sys.exit(main())
