"""Device-time breakdown of the anytime serving stages, or of one training
step, on a CUDA card.

    python -m raft_stereo_tpu_torch.profile_stages
        [--config kernel|fused|evaluate|mixed|realtime|mixed-levers|train|mixed-train]
        [--cases 384x512/1,512x768/1] [--cudnn-benchmark off,on] [--top 8]

Builds the default model with the CUDA lookup and fused GRU tails
(`--config kernel`), or with the fused encoder prelude on top of them
(`--config fused`: pyramid build, layer1 convs and joins as kernels), or
with the windowed lookup in place of the dense one (`--config evaluate`,
the evaluate entry point's configuration), or in the JAX bench's
mixed-precision configuration (`--config mixed`: "pallas", bf16 compute, a
bf16 pyramid, the fused encoder; its convolutions are timed in bf16), or
the reference's realtime model in mixed precision (`--config realtime`:
`shared_backbone`, `n_downsample=3`, `n_gru_layers=2`, `slow_fast_gru`,
"pallas", bf16 compute and pyramid, the fused encoder and the fused GRU
tail; its chunk is the model's 7 iterations; default case the KITTI bucket
384x1248/1), with seeded random weights, fp32 parameters, TF32 off, and
for each (bucket, batch) case and cuDNN benchmark mode warms it, then times
one prelude and one chunk of 4 iterations (synchronized wall clock) and
traces each with `torch.profiler`.
Prints per stage the wall time, the summed device-kernel time, the device's
busy share (kernel time over wall time), the time by kernel family, and the
kernels that take most device time, then times every distinct
convolution of the forward alone, as below. Needs a CUDA device.

`--config train` runs the training step instead, at the train CLI's recipe
unless `--cases` names another (default 320x720/6, 16 iterations, remat on
with the taps saved, the default model with the "pallas" lookup, fp32,
seeded weights, a random batch); `--config mixed-train` runs it in the JAX
package's shipping numerics at the JAX bench's training setup (bf16
compute, a bf16 pyramid, default 320x720/4, 22 iterations). After one warm
step it traces one step in three windows — forward with the loss,
backward, clip and optimizer update — and prints the same breakdown for
each. Then it times every distinct convolution of the step alone at its
own shape and dtype (the mask head's at its batch of iterations x batch)
with cuDNN's default algorithm choice and with cuDNN off (PyTorch's own
im2col + GEMM), so that a convolution for which cuDNN picks a far slower
algorithm stands out.

`--config mixed-levers` is the card's form of the JAX bench's
`per_iter.levers` block: the mixed configuration at Middlebury-F
(1984x2880/1 unless `--cases` names another) with each test-mode lever on
in turn (`prefetch_lookup`, `fused_gru_tail`, the gate pair through
`RAFT_STEREO_TPU_PALLAS_GATES=1`) and with none, on the same seeded
weights. For each it prints the per-iteration device ms of the lookup alone
(`corr_sample` at the prelude's coordinates) and of the update block alone
(motion encoder, GRUs and flow head from the same taps; the JAX bench's
`iter_gru_ms`), medians of CUDA-event timed calls, then the traced chunk's
breakdown as above.

Every conv is timed three ways: forward, the backward to its input
(dgrad) and the backward to its weight (wgrad), each alone
(`torch.nn.grad`, which calls the same convolution backward as autograd),
and for each the kernel that takes most of cuDNN's device time is named.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig
from raft_stereo_tpu_torch.models import anytime
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.models.raft_stereo import corr_sample
from raft_stereo_tpu_torch.ops import gates
from raft_stereo_tpu_torch.train.loss import sequence_loss
from raft_stereo_tpu_torch.train.trainer import Trainer

CHUNK_ITERS = 4
CONFIGS = {
    "kernel": RAFTStereoConfig(corr_implementation="pallas", fused_gru_tail=True),
    "fused": RAFTStereoConfig(corr_implementation="pallas", fused_gru_tail=True, fused_encoder=True),
    "evaluate": RAFTStereoConfig(corr_implementation="pallas", fused_gru_tail=True, prefetch_lookup=True),
    "mixed": RAFTStereoConfig(corr_implementation="pallas", mixed_precision=True, corr_dtype="bfloat16",
                              fused_encoder=True),
    "realtime": RAFTStereoConfig(shared_backbone=True, n_downsample=3, n_gru_layers=2, slow_fast_gru=True,
                                 corr_implementation="pallas", mixed_precision=True, corr_dtype="bfloat16",
                                 fused_encoder=True, fused_gru_tail=True),
    "train": RAFTStereoConfig(corr_implementation="pallas"),
    "mixed-train": RAFTStereoConfig(corr_implementation="pallas", mixed_precision=True, corr_dtype="bfloat16"),
}
# The training configurations' default case and iterations: the train CLI's
# recipe, and the JAX bench's training setup (bench.py `_train_step_seconds`).
TRAIN_SETUPS = {"train": ("320x720/6", 16), "mixed-train": ("320x720/4", 22)}
# Iterations of a traced chunk, and the default cases, per forward config.
CONFIG_CHUNK_ITERS = {"realtime": 7}
DEFAULT_CASES = {"realtime": "384x1248/1", "mixed-levers": "1984x2880/1"}
# The JAX bench's test-mode levers (bench.py `per_iter.levers`): per lever,
# the mixed config's flags and whether the gate pair's variable is on.
# `--config mixed-levers`, chip_smoke.py's `[mixed-levers]` and the CPU
# tests of the bf16 levers all read this table.
LEVERS = {"off": ({}, False), "prefetch_lookup": ({"prefetch_lookup": True}, False),
          "fused_gru_tail": ({"fused_gru_tail": True}, False), "gates": ({}, True)}
FAMILIES = (
    ("port kernels", ("corr_window_kernel", "corr_scatter_kernel", "gru_tail_", "motion_tail_kernel",
                      "corr_pyramid_", "encoder_conv_", "encoder_stats_", "join_kernel", "gates_rh_kernel",
                      "gates_combine_kernel")),
    ("convolution", ("conv", "xmma", "cutlass", "implicit", "winograd", "gemm", "sm90", "fft")),
    ("copy / layout", ("copy", "transpose", "nchw", "nhwc", "cat", "memcpy", "memset", "fill")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other elementwise / reduction"


def kernel_times(prof):
    """{kernel name: (total device us, calls)} over the trace's device
    events. User annotations on the device timeline (the optimizer's
    `Optimizer.step#AdamW.step` range) span kernels and are left out."""
    out = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue
        out[evt.name][0] += evt.time_range.elapsed_us()
        out[evt.name][1] += 1
    return out


def report(label, wall_ms, prof, top):
    """Print one traced window: wall, device time, busy share, families,
    top kernels."""
    kt = kernel_times(prof)
    dev_ms = sum(v[0] for v in kt.values()) / 1e3
    print(f"  {label}: wall {wall_ms:.3f} ms, device kernels {dev_ms:.3f} ms "
          f"(busy share {dev_ms / wall_ms:.3f}), {sum(v[1] for v in kt.values())} kernel launches")
    if not kt:
        print("    the profiler recorded no device time")
        return
    fams = defaultdict(float)
    for name, (us, _) in kt.items():
        fams[family(name)] += us
    ranked = sorted(fams.items(), key=lambda x: -x[1])
    print("    by family: " + ", ".join(f"{f} {us / 1e3:.3f} ms" for f, us in ranked))
    for name, (us, calls) in sorted(kt.items(), key=lambda x: -x[1][0])[:top]:
        print(f"    {us / 1e3:9.3f} ms {calls:5d}x  {name[:110]}")


def run_stage(label, fn, top):
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    report(label, wall_ms, prof, top)


def profile_train(config: str, case: str, top: int) -> None:
    """One warm training step, then one step traced in three windows."""
    hw, batch = case.split("/")
    h, w = map(int, hw.split("x"))
    b = int(batch)
    iters = TRAIN_SETUPS[config][1]
    cfg = TrainConfig(model=CONFIGS[config], batch_size=b, train_iters=iters, seed=0)
    trainer = Trainer(cfg, (h, w, 3), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {"image1": torch.rand((b, h, w, 3), generator=gen, device="cuda") * 255,
            "image2": torch.rand((b, h, w, 3), generator=gen, device="cuda") * 255,
            "flow": -torch.rand((b, h, w, 1), generator=gen, device="cuda") * 48,
            "valid": torch.ones((b, h, w), device="cuda")}
    print(f"[{config} config, {h}x{w} b{b}, {iters} iters, mixed_precision {cfg.model.mixed_precision}, "
          f"corr_dtype {cfg.model.corr_dtype}, remat_iterations {cfg.model.remat_iterations}, "
          f"remat_save_corr {cfg.model.remat_save_corr}]")
    trainer.train_step(data)
    torch.cuda.synchronize()
    model, opt = trainer.model, trainer.optimizer
    opt.zero_grad(set_to_none=True)
    torch.cuda.reset_peak_memory_stats()
    windows = {}

    def forward():
        flows = model(data["image1"], data["image2"], iters=iters)
        windows["loss"] = sequence_loss(flows, data["flow"], data["valid"], cfg.loss_gamma, cfg.max_flow)[0]

    def backward():
        windows.pop("loss").backward()

    def update():
        opt.clip_grads_()
        opt.step()

    total = 0.0
    for label, fn in (("forward + loss", forward), ("backward", backward), ("clip + AdamW", update)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        total += wall_ms
        report(label, wall_ms, prof, top)
    print(f"  traced step: wall {total:.3f} ms (under the profiler); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    time_convs(model, data, b * iters, test_mode=False)


def conv_ms(x, weight, stride, padding, reps=3):
    """{pass: (ms, kernel)} of one conv for its forward, dgrad and wgrad:
    the mean of `reps` synchronized calls after one warm call, and the
    device kernel that takes most of one traced call's time."""
    gy = torch.randn_like(F.conv2d(x, weight, None, stride, padding))
    passes = {
        "forward": lambda: F.conv2d(x, weight, None, stride, padding),
        "dgrad": lambda: torch.nn.grad.conv2d_input(x.shape, weight, gy, stride, padding),
        "wgrad": lambda: torch.nn.grad.conv2d_weight(x, weight.shape, gy, stride, padding),
    }
    out = {}
    for name, fn in passes.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) / reps * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kt = kernel_times(prof)
        out[name] = (ms, max(kt, key=lambda k: kt[k][0]) if kt else "none")
    return out


def time_convs(model, data, mask_batch, test_mode=True) -> None:
    """Every distinct conv (input shape, weight shape, stride, dtype) of one
    one-iteration forward (a test-mode one unless `test_mode` is False), and
    the mask head's first conv at `mask_batch` (a training step's
    iterations x batch), timed alone in its own dtype with cuDNN's default
    choice and with cuDNN off."""
    shapes, keys = {}, {}
    hooks = []
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Conv2d):
            def hook(m, inp, out, name=name):
                keys[name] = (tuple(inp[0].shape), tuple(m.weight.shape), m.stride, m.padding, inp[0].dtype)
                shapes.setdefault(keys[name], name)
            hooks.append(mod.register_forward_hook(hook))
    with torch.no_grad():
        model(data["image1"], data["image2"], iters=1, test_mode=test_mode)
    for h in hooks:
        h.remove()
    xs, ws, stride, padding, dtype = keys["mask_head.mask_conv1"]
    shapes[((mask_batch, *xs[1:]), ws, stride, padding, dtype)] = f"mask_head.mask_conv1 (batch {mask_batch})"
    print("  distinct convolutions, timed alone (forward / dgrad / wgrad ms): cuDNN's choice | cuDNN off; "
          "then the kernel that takes most of cuDNN's time in each")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (xs, ws, stride, padding, dtype), name in shapes.items():
        x = torch.randn(xs, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(ws, generator=gen, device="cuda") * 0.05).to(dtype)
        on = conv_ms(x, w, stride, padding)
        with torch.backends.cudnn.flags(enabled=False):
            off = conv_ms(x, w, stride, padding)
        print(f"    {name:44s} x{xs} w{ws} {str(dtype)[6:]}: "
              + " / ".join(f"{on[k][0]:9.3f}" for k in on) + " | " + " / ".join(f"{off[k][0]:9.3f}" for k in off))
        print("      " + "; ".join(f"{k} {v[1][:90]}" for k, v in on.items()))
        del x, w


def event_ms(fn, reps=20) -> float:
    """Median device time of one call by CUDA events, after two warm calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


@torch.inference_mode()
def profile_levers(case: str, top: int) -> None:
    """The mixed configuration with each test-mode lever on and off: the
    lookup's and the update block's per-iteration device ms, and a traced
    chunk."""
    hw, batch = case.split("/")
    h, w = map(int, hw.split("x"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    img1 = torch.rand((int(batch), h, w, 3), generator=gen, device="cuda") * 255
    img2 = torch.roll(img1, 8, dims=2)
    for lever, (flags, gates_on) in LEVERS.items():
        cfg = dataclasses.replace(CONFIGS["mixed"], **flags)
        model = build_model(cfg, seed=0, device="cuda")
        if gates_on:
            os.environ[gates.ENV_VAR] = "1"
        try:
            state = anytime.prelude(model, img1, img2)
            coords = state["coords1"]
            taps = corr_sample(cfg, state["corr"], coords, prefetch=cfg.prefetch_lookup)
            lookup_ms = event_ms(lambda: corr_sample(cfg, state["corr"], coords, prefetch=cfg.prefetch_lookup))
            gru_ms = event_ms(lambda: model._update(state, state["net"], coords, taps, test_mode=True))
            print(f"[mixed-levers {lever}, {h}x{w} b{batch}] per iteration: lookup {lookup_ms:.4f} ms, "
                  f"update block {gru_ms:.4f} ms (device, medians of 20 calls)")
            run_stage(f"chunk of {CHUNK_ITERS}", lambda: anytime.chunk(model, state, CHUNK_ITERS), top)
        finally:
            os.environ.pop(gates.ENV_VAR, None)
        del model, state, taps
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted([*CONFIGS, "mixed-levers"]), default="kernel")
    ap.add_argument("--cases", default=None,
                    help="comma list of HxW/batch (default 384x512/1,512x768/1,512x768/4; train: 320x720/6; "
                         "mixed-train: 320x720/4; realtime: 384x1248/1; mixed-levers: 1984x2880/1)")
    ap.add_argument("--cudnn-benchmark", default="off", help="comma list of off/on")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_stages: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip())
    if args.config in TRAIN_SETUPS:
        for mode in args.cudnn_benchmark.split(","):
            torch.backends.cudnn.benchmark = mode == "on"
            for case in (args.cases or TRAIN_SETUPS[args.config][0]).split(","):
                print(f"[cudnn.benchmark {mode}]")
                profile_train(args.config, case, args.top)
                torch.cuda.empty_cache()
        return 0
    if args.config == "mixed-levers":
        for case in (args.cases or DEFAULT_CASES[args.config]).split(","):
            profile_levers(case, args.top)
        return 0
    model = build_model(CONFIGS[args.config], seed=0, device="cuda")
    chunk_iters = CONFIG_CHUNK_ITERS.get(args.config, CHUNK_ITERS)
    for mode in args.cudnn_benchmark.split(","):
        torch.backends.cudnn.benchmark = mode == "on"
        for case in (args.cases or DEFAULT_CASES.get(args.config, "384x512/1,512x768/1,512x768/4")).split(","):
            hw, batch = case.split("/")
            h, w = map(int, hw.split("x"))
            img = torch.zeros((int(batch), h, w, 3), device="cuda")
            print(f"[{args.config} config, {h}x{w} b{batch}, cudnn.benchmark {mode}]")
            with torch.inference_mode():
                state = anytime.prelude(model, img, img)
                run_stage("prelude", lambda: anytime.prelude(model, img, img), args.top)
                run_stage(f"chunk of {chunk_iters}",
                          lambda: anytime.chunk(model, state, chunk_iters), args.top)
            time_convs(model, {"image1": img, "image2": img}, int(batch))
            del img, state
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
