"""Time this checkout's bf16 pyramid build and layer1 conv against another
checkout's (e.g. the parent commit, unpacked with `git archive`), in turns,
on one card:

    python3 kernel_compare.py --other runs/parent

Each turn is a fresh process in one checkout's root (default turns: other,
this, this, other). It builds that checkout's kernels and times them with
this checkout's `chip_smoke.py` helpers (`time_ms`, `kernel_ms`, the input
makers, `MIXED_CONFIG`), so both checkouts are measured by one harness on
the same inputs. It prints JSON lines:

- the bf16 pyramid at the 512x768 bucket's and Middlebury-F's 1/4 (128 x
  192 and 496 x 720 rows x W, D 256, 4 levels) and the bf16 conv at the
  512x768 bucket's full resolution (1 and 2 images, instance form with
  statistics), Middlebury-F's (1 image frozen BN, 2 images instance, with
  statistics) and the realtime model's 192x624 (2 images, frozen BN, no
  statistics): the median of 30 calls by CUDA events and the wrapper's
  kernels alone by torch.profiler (the conv with its statistics pass), the
  L2 flushed before each call, and the library call (bf16 torch.matmul of
  the volume alone, cuDNN's bf16 F.conv2d of the normalized operand);
- the mixed configuration through `Evaluator` on one synthetic
  Middlebury-F-sized pair at 32 iterations: seconds per image, six runs;
- `profile_stages --config mixed --cases 512x768/1`: the prelude's and a
  chunk's wall and device ms.

Needs a CUDA card; uses only entry points both checkouts have.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r'''
import importlib.util, json, os, statistics, sys
sys.path.insert(0, os.getcwd())
spec = importlib.util.spec_from_file_location("smoke", sys.argv[2])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
torch, F, BF16 = smoke.torch, smoke.F, smoke.BF16
corr_cuda, encoder_cuda = smoke.corr_cuda, smoke.encoder_cuda

TAG = sys.argv[1]
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
smoke._build.build(sorted(smoke._build.SOURCE_FLAGS))
gen = torch.Generator(device=smoke.DEVICE).manual_seed(0)
flush = torch.empty(64 * 2**20, dtype=torch.float32, device=smoke.DEVICE)


def emit(**row):
    print(json.dumps({"tag": TAG, **row}), flush=True)


def times(fn, keys):
    return {"ms": smoke.time_ms(fn, flush=flush), "device_ms": smoke.kernel_ms(fn, keys, flush)}


for label, (h, w) in (("512x768 1/4", (128, 192)), ("1984x2880 1/4", (496, 720))):
    f1, f2 = (f.to(BF16) for f in smoke.fmap_inputs(gen, 1, h, w))
    emit(kernel="corr_pyramid_bf16", shape=label,
         **times(lambda: corr_cuda.fused_pyramid_state(f1, f2, 4, BF16), ("corr_pyramid",)),
         library_ms=smoke.time_ms(lambda: torch.matmul(f1, f2.transpose(-1, -2)), flush=flush))
    del f1, f2
for label, (b, h, w, form, stats) in (("512x768 b1 in+stats", (1, 512, 768, "in", True)),
                                      ("512x768 b2 in+stats", (2, 512, 768, "in", True)),
                                      ("1984x2880 b1 bn+stats", (1, 1984, 2880, "bn", True)),
                                      ("1984x2880 b2 in+stats", (2, 1984, 2880, "in", True)),
                                      ("192x624 b2 bn", (2, 192, 624, "bn", False))):
    x, wt, bias, aff = smoke.conv_inputs(gen, b, h, w, form)
    x = x.to(BF16)
    z = encoder_cuda.apply_affine(x, aff, form)
    wb, bb = wt.to(BF16), bias.to(BF16)
    emit(kernel="encoder_conv_bf16", shape=label,
         **times(lambda: encoder_cuda.fused_conv(x, wt, bias, aff, form, stats), ("encoder_conv", "encoder_stats")),
         library_ms=smoke.time_ms(lambda: F.conv2d(z, wb, bb, padding=1), flush=flush))
    del x, z
torch.cuda.empty_cache()
evaluator = smoke.Evaluator(smoke.build_model(smoke.MIXED_CONFIG, seed=0, device=smoke.DEVICE), iters=smoke.EVAL_ITERS)
item = smoke.SyntheticEvalDataset(n=1, shape=smoke.EVAL_SHAPE).get_item(0, None)
secs = [evaluator(item["image1"], item["image2"])[1] for _ in range(6)]
emit(kernel="mixed evaluate 1980x2870, 32 iters", seconds=secs, median_after_first=statistics.median(secs[1:]))
'''

HERE = os.path.dirname(os.path.abspath(__file__))


def run_turn(root: str, tag: str, timeout: int = 900) -> None:
    r = subprocess.run([sys.executable, "-c", CHILD, tag, os.path.join(HERE, "chip_smoke.py")], cwd=root,
                       capture_output=True, text=True, timeout=timeout)
    print(r.stdout.strip(), flush=True)
    if r.returncode:
        raise RuntimeError(f"{tag} turn failed in {root}:\n{r.stderr[-4000:]}")
    r = subprocess.run([sys.executable, "-m", "raft_stereo_tpu_torch.profile_stages", "--config", "mixed", "--cases",
                        "512x768/1", "--top", "0"], cwd=root, capture_output=True, text=True, timeout=timeout)
    if r.returncode:
        raise RuntimeError(f"{tag} profile_stages failed in {root}:\n{r.stderr[-4000:]}")
    lines = [line.strip() for line in r.stdout.splitlines() if "wall" in line]
    print(json.dumps({"tag": tag, "kernel": "profile_stages mixed 512x768/1", "lines": lines}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--turns", default="other,this,this,other")
    args = ap.parse_args(argv)
    roots = {"this": HERE, "other": os.path.abspath(args.other)}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for turn in args.turns.split(","):
        run_turn(roots[turn], turn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
