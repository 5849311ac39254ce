"""Time this checkout's redesigned kernels against another checkout's (e.g.
the parent commit, unpacked with `git archive`), in turns, on one card:

    python3 kernel_compare.py --other runs/parent

Each turn is a fresh process in one checkout's root (default turns: other,
this, this, other). It builds that checkout's kernels and times them with
this checkout's `chip_smoke.py` helpers (`time_ms`, `kernel_ms`, the input
makers, `MIXED_CONFIG`), so both checkouts are measured by one harness on
the same inputs. What it times is two tables, so that a later redesign
adds rows, not a harness:

- `ROWS` (in the child): one kernel call per row, the median of 30 calls by
  CUDA events and the call's kernels alone by torch.profiler, the L2
  flushed before each call, beside the library call that computes the same
  function (where one does) and the row's other yardsticks. Rows: the
  windowed lookup with fp32 and with bf16 levels and taps at the 512x768
  bucket's and Middlebury-F's 1/4, beside the dense kernel and
  F.grid_sample (cuDNN's grid sampler refuses Middlebury-F's batch of one
  row per query); the fp32 layer1 conv at 512x768 (1 and 2 images) and
  384x512 (1 image), instance form with statistics, beside cuDNN's fp32
  F.conv2d of the normalized operand; the bf16 pyramid at both 1/4 shapes
  beside bf16 torch.matmul of the volume; the bf16 conv at 512x768,
  Middlebury-F and the realtime 192x624, its statistics pass included,
  beside cuDNN's bf16 F.conv2d, and its statistics pass alone (the
  device time of the `encoder_stats` kernels); and the mixed configuration through
  `Evaluator` on one synthetic Middlebury-F-sized pair at 32 iterations
  (seconds per image, six runs);
- `WALLS` (in the child): the mixed and the fp32 fused preludes and chunks
  by wall clock, the median and range of 20 synchronized calls (the
  host-bound stages, which one traced call cannot resolve);
- `PROFILES` (in the child): `profile_stages`' own traced stages, their
  wall and device-time lines kept: the mixed 512x768 prelude and chunk,
  the fp32 fused preludes and chunks at 384x512 and 512x768, and
  `profile_levers` (the mixed configuration's per-iteration lookup and
  update block with each test-mode lever at Middlebury-F).

It prints JSON lines, one per row and turn. Needs a CUDA card; uses only
entry points both checkouts have.
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
torch, F, BF16, F32 = smoke.torch, smoke.F, smoke.BF16, smoke.torch.float32
corr_cuda, encoder_cuda = smoke.corr_cuda, smoke.encoder_cuda

TAG = sys.argv[1]
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
smoke._build.build(sorted(smoke._build.SOURCE_FLAGS))
gen = torch.Generator(device=smoke.DEVICE).manual_seed(0)
flush = torch.empty(64 * 2**20, dtype=torch.float32, device=smoke.DEVICE)


def lookup(h, w, dtype):
    """The windowed lookup at (h, w) queries with W2 = w, levels and taps in
    `dtype`; beside it the dense kernel and, at the bucket's shape,
    F.grid_sample on the same levels (its grid in the same dtype)."""
    pyramid, coords = smoke.lookup_inputs(gen, 1, h, w, w)
    levels = tuple(lvl.to(dtype) for lvl in pyramid)
    others = {"dense": ((lambda: corr_cuda.corr_lookup(levels, coords, 4, dtype)), ("corr_lookup_kernel",))}
    lib = None
    if h == 128:
        rows, grid = smoke.grid_sample_lookup_inputs(pyramid, coords, 4)
        rows, grid = rows.to(dtype), grid.to(dtype)
        lib = lambda: F.grid_sample(rows, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    return (lambda: corr_cuda.prefetch_corr_lookup(levels, coords, 4, dtype)), ("corr_prefetch",), lib, others


def conv(b, h, w, form, stats, dtype, names=None):
    """The layer1 conv in `dtype` (statistics pass included), beside cuDNN's
    F.conv2d of the normalized operand in the same dtype; `names`: the
    kernels whose device time counts (default: the conv and its statistics
    pass)."""
    x, wt, bias, aff = smoke.conv_inputs(gen, b, h, w, form)
    x = x.to(dtype)
    z = encoder_cuda.apply_affine(x, aff, form)
    wl, bl = wt.to(dtype), bias.to(dtype)
    if names is None:
        names = ("encoder_conv_wgmma", "encoder_stats") if dtype == BF16 else ("encoder_conv_kernel", "encoder_stats")
    return ((lambda: encoder_cuda.fused_conv(x, wt, bias, aff, form, stats)), names,
            (lambda: F.conv2d(z, wl, bl, padding=1)), {})


def pyramid(h, w):
    f1, f2 = (f.to(BF16) for f in smoke.fmap_inputs(gen, 1, h, w))
    return ((lambda: corr_cuda.fused_pyramid_state(f1, f2, 4, BF16)), ("corr_pyramid",),
            (lambda: torch.matmul(f1, f2.transpose(-1, -2))), {})


# (kernel, shape, setup): setup() -> (call, its kernels' names, library call or None, {name: (call, names)}).
ROWS = [
    ("corr_prefetch_lookup", "512x768 1/4 (128 x 192, W2 192)", lambda: lookup(128, 192, F32)),
    ("corr_prefetch_lookup", "1984x2880 1/4 (496 x 720, W2 720)", lambda: lookup(496, 720, F32)),
    ("corr_prefetch_lookup_bf16", "512x768 1/4 (128 x 192, W2 192)", lambda: lookup(128, 192, BF16)),
    ("corr_prefetch_lookup_bf16", "1984x2880 1/4 (496 x 720, W2 720)", lambda: lookup(496, 720, BF16)),
    ("encoder_conv", "512x768 b1 in+stats", lambda: conv(1, 512, 768, "in", True, F32)),
    ("encoder_conv", "512x768 b2 in+stats", lambda: conv(2, 512, 768, "in", True, F32)),
    ("encoder_conv", "384x512 b1 in+stats", lambda: conv(1, 384, 512, "in", True, F32)),
    ("corr_pyramid_bf16", "512x768 1/4", lambda: pyramid(128, 192)),
    ("corr_pyramid_bf16", "1984x2880 1/4", lambda: pyramid(496, 720)),
    ("encoder_conv_bf16", "512x768 b1 in+stats", lambda: conv(1, 512, 768, "in", True, BF16)),
    ("encoder_conv_bf16", "512x768 b2 in+stats", lambda: conv(2, 512, 768, "in", True, BF16)),
    ("encoder_conv_bf16", "1984x2880 b1 bn+stats", lambda: conv(1, 1984, 2880, "bn", True, BF16)),
    ("encoder_conv_bf16", "1984x2880 b2 in+stats", lambda: conv(2, 1984, 2880, "in", True, BF16)),
    ("encoder_conv_bf16", "192x624 b2 bn", lambda: conv(2, 192, 624, "bn", False, BF16)),
    ("encoder_stats (the bf16 conv's statistics pass alone)", "512x768 b1 in+stats",
     lambda: conv(1, 512, 768, "in", True, BF16, ("encoder_stats",))),
    ("encoder_stats (the bf16 conv's statistics pass alone)", "1984x2880 b2 in+stats",
     lambda: conv(2, 1984, 2880, "in", True, BF16, ("encoder_stats",))),
]


def emit(**row):
    print(json.dumps({"tag": TAG, **row}), flush=True)


def times(fn, names):
    return {"ms": smoke.time_ms(fn, flush=flush), "device_ms": smoke.kernel_ms(fn, names, flush)}


for kernel, shape, setup in ROWS:
    call, names, lib, others = setup()
    row = times(call, names)
    row["library_ms"] = None if lib is None else smoke.time_ms(lib, flush=flush)
    for name, (fn, fn_names) in others.items():
        row.update({f"{name}_{k}": v for k, v in times(fn, fn_names).items()})
    emit(kernel=kernel, shape=shape, **row)
    del call, lib, others
    torch.cuda.empty_cache()
evaluator = smoke.Evaluator(smoke.build_model(smoke.MIXED_CONFIG, seed=0, device=smoke.DEVICE), iters=smoke.EVAL_ITERS)
item = smoke.SyntheticEvalDataset(n=1, shape=smoke.EVAL_SHAPE).get_item(0, None)
secs = [evaluator(item["image1"], item["image2"])[1] for _ in range(6)]
emit(kernel="mixed evaluate 1980x2870, 32 iters", seconds=secs, median_after_first=statistics.median(secs[1:]))
del evaluator
torch.cuda.empty_cache()

import contextlib, io, time
from raft_stereo_tpu_torch import profile_stages


def stages(config, cases):
    """`profile_stages --config <config> --cases <cases>` without its conv
    sweep: each case's prelude and chunk, traced, on zero images."""
    model = smoke.build_model(profile_stages.CONFIGS[config], seed=0, device=smoke.DEVICE)
    for case in cases:
        (h, w), b = map(int, case.split("/")[0].split("x")), int(case.split("/")[1])
        img = torch.zeros((b, h, w, 3), device=smoke.DEVICE)
        with torch.inference_mode():
            state = smoke.anytime.prelude(model, img, img)
            print(f"[{config} config, {h}x{w} b{b}]")
            profile_stages.run_stage("prelude", lambda: smoke.anytime.prelude(model, img, img), 0)
            profile_stages.run_stage(f"chunk of {profile_stages.CHUNK_ITERS}",
                                     lambda: smoke.anytime.chunk(model, state, profile_stages.CHUNK_ITERS), 0)
        del img, state
    del model
    torch.cuda.empty_cache()


# Host-bound stages by wall clock, the median (and range) of 20 synchronized
# calls after a warm one: (label, profile_stages config, case, stage).
WALLS = [
    ("mixed prelude 512x768/1", "mixed", "512x768/1", "prelude"),
    ("mixed chunk of 4, 512x768/1", "mixed", "512x768/1", "chunk"),
    ("fused fp32 prelude 384x512/1", "fused", "384x512/1", "prelude"),
    ("fused fp32 prelude 512x768/1", "fused", "512x768/1", "prelude"),
    ("fused fp32 chunk of 4, 512x768/1", "fused", "512x768/1", "chunk"),
]
models = {}
for label, config, case, stage in WALLS:
    if config not in models:
        models[config] = smoke.build_model(profile_stages.CONFIGS[config], seed=0, device=smoke.DEVICE)
    model = models[config]
    (h, w), b = map(int, case.split("/")[0].split("x")), int(case.split("/")[1])
    img = torch.zeros((b, h, w, 3), device=smoke.DEVICE)
    with torch.inference_mode():
        state = smoke.anytime.prelude(model, img, img)
        fn = ((lambda: smoke.anytime.prelude(model, img, img)) if stage == "prelude" else
              (lambda: smoke.anytime.chunk(model, state, profile_stages.CHUNK_ITERS)))
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    emit(kernel=label, wall_ms_median=statistics.median(walls), wall_ms_min=min(walls), wall_ms_max=max(walls))
    del img, state
del models
torch.cuda.empty_cache()

# (label, call, substrings of the printed lines kept besides the headers).
PROFILES = [
    ("profile_stages mixed 512x768/1", lambda: stages("mixed", ["512x768/1"]), ("wall", "by family")),
    ("profile_stages fused 384x512/1,512x768/1", lambda: stages("fused", ["384x512/1", "512x768/1"]),
     ("wall", "by family")),
    ("profile_stages mixed-levers 1984x2880/1", lambda: profile_stages.profile_levers("1984x2880/1", 0),
     ("per iteration",)),
]
for label, call, keep in PROFILES:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        call()
    emit(kernel=label, lines=[line.strip() for line in out.getvalue().splitlines()
                              if line.startswith("[") or any(k in line for k in keep)])
'''

HERE = os.path.dirname(os.path.abspath(__file__))


def run_turn(root: str, tag: str, timeout: int = 1200) -> None:
    r = subprocess.run([sys.executable, "-c", CHILD, tag, os.path.join(HERE, "chip_smoke.py")], cwd=root,
                       capture_output=True, text=True, timeout=timeout)
    print(r.stdout.strip(), flush=True)
    if r.returncode:
        raise RuntimeError(f"{tag} turn failed in {root}:\n{r.stderr[-4000:]}")


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
