"""Device-time breakdown of the anytime serving stages, or of one training
step, on a CUDA card.

    python -m raft_stereo_tpu_torch.profile_stages [--config kernel|fused|evaluate|train]
        [--cases 384x512/1,512x768/1] [--cudnn-benchmark off,on] [--top 8]

Builds the default model with the CUDA lookup and fused GRU tails
(`--config kernel`), or with the fused encoder prelude on top of them
(`--config fused`: pyramid build, layer1 convs and joins as kernels), or
with the windowed lookup in place of the dense one (`--config evaluate`,
the evaluate entry point's configuration), with
seeded random weights, fp32, TF32 off, and for each (bucket, batch) case and
cuDNN benchmark mode warms it, then times one prelude and one chunk of 4
iterations (synchronized wall clock) and traces each with `torch.profiler`.
Prints per stage the wall time, the summed device-kernel time, the device's
busy share (kernel time over wall time), the time by kernel family, and the
kernels that take most device time, then times every distinct
convolution of the forward alone, as below. Needs a CUDA device.

`--config train` runs the training step instead, at the train CLI's recipe
unless `--cases` names another (default 320x720/6, 16 iterations, remat on
with the taps saved, the default model with the "pallas" lookup, seeded
weights, a random batch): after one warm step it traces one step in three
windows — forward with the loss, backward, clip and optimizer update — and
prints the same breakdown for each. Then it times every distinct
convolution of the step alone at its own shape (forward, and forward plus
backward to data and weight; the mask head's at its batch of iterations x
batch), with cuDNN's default algorithm choice and with cuDNN off (PyTorch's
own im2col + GEMM), so that a convolution for which cuDNN picks a far
slower algorithm stands out.
"""

from __future__ import annotations

import argparse
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
from raft_stereo_tpu_torch.train.loss import sequence_loss
from raft_stereo_tpu_torch.train.trainer import Trainer

CHUNK_ITERS = 4
CONFIGS = {
    "kernel": RAFTStereoConfig(corr_implementation="pallas", fused_gru_tail=True),
    "fused": RAFTStereoConfig(corr_implementation="pallas", fused_gru_tail=True, fused_encoder=True),
    "evaluate": RAFTStereoConfig(corr_implementation="pallas", fused_gru_tail=True, prefetch_lookup=True),
    "train": RAFTStereoConfig(corr_implementation="pallas"),
}
TRAIN_CASE = "320x720/6"
TRAIN_ITERS = 16
FAMILIES = (
    ("port kernels", ("corr_lookup_kernel", "corr_scatter_kernel", "gru_tail_", "motion_tail_kernel",
                      "corr_pyramid_kernel", "encoder_conv_kernel", "encoder_stats_kernel", "join_kernel",
                      "corr_prefetch_kernel", "gates_rh_kernel", "gates_combine_kernel")),
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
    """{kernel name: (total device us, calls)} over the trace's device events."""
    out = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
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


def profile_train(case: str, top: int) -> None:
    """One warm training step, then one step traced in three windows."""
    hw, batch = case.split("/")
    h, w = map(int, hw.split("x"))
    b = int(batch)
    cfg = TrainConfig(model=CONFIGS["train"], batch_size=b, train_iters=TRAIN_ITERS, seed=0)
    trainer = Trainer(cfg, (h, w, 3), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {"image1": torch.rand((b, h, w, 3), generator=gen, device="cuda") * 255,
            "image2": torch.rand((b, h, w, 3), generator=gen, device="cuda") * 255,
            "flow": -torch.rand((b, h, w, 1), generator=gen, device="cuda") * 48,
            "valid": torch.ones((b, h, w), device="cuda")}
    print(f"[train config, {h}x{w} b{b}, {TRAIN_ITERS} iters, remat_iterations "
          f"{cfg.model.remat_iterations}, remat_save_corr {cfg.model.remat_save_corr}]")
    trainer.train_step(data)
    torch.cuda.synchronize()
    model, opt = trainer.model, trainer.optimizer
    opt.zero_grad(set_to_none=True)
    torch.cuda.reset_peak_memory_stats()
    windows = {}

    def forward():
        flows = model(data["image1"], data["image2"], iters=TRAIN_ITERS)
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
    time_convs(model, data, b * TRAIN_ITERS)


def conv_ms(x, weight, stride, padding, reps=3):
    """(forward ms, forward + backward ms) of one conv: the mean of `reps`
    synchronized calls after one warm call."""
    x = x.detach().requires_grad_()
    weight = weight.detach().requires_grad_()

    def fwd():
        return F.conv2d(x, weight, None, stride, padding)

    gy = torch.randn_like(fwd())

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (x, weight), gy)

    out = []
    for fn in (fwd, fwd_bwd):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) / reps * 1e3)
    return out


def time_convs(model, data, mask_batch) -> None:
    """Every distinct conv (input shape, weight shape, stride) of one
    one-iteration forward, and the mask head's first conv at
    `mask_batch` (a training step's iterations x batch), timed alone with
    cuDNN's default choice and with cuDNN off."""
    shapes, keys = {}, {}
    hooks = []
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Conv2d):
            def hook(m, inp, out, name=name):
                keys[name] = (tuple(inp[0].shape), tuple(m.weight.shape), m.stride, m.padding)
                shapes.setdefault(keys[name], name)
            hooks.append(mod.register_forward_hook(hook))
    with torch.no_grad():
        model(data["image1"], data["image2"], iters=1)
    for h in hooks:
        h.remove()
    xs, ws, stride, padding = keys["mask_head.mask_conv1"]
    shapes[((mask_batch, *xs[1:]), ws, stride, padding)] = f"mask_head.mask_conv1 (batch {mask_batch})"
    print(f"  distinct convolutions, timed alone (forward ms / forward + backward ms): "
          f"cuDNN's choice | cuDNN off")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (xs, ws, stride, padding), name in shapes.items():
        x = torch.randn(xs, generator=gen, device="cuda")
        w = torch.randn(ws, generator=gen, device="cuda") * 0.05
        f, fb = conv_ms(x, w, stride, padding)
        with torch.backends.cudnn.flags(enabled=False):
            f_off, fb_off = conv_ms(x, w, stride, padding)
        print(f"    {name:44s} x{xs} w{ws}: {f:9.3f} / {fb:9.3f} | {f_off:9.3f} / {fb_off:9.3f}")
        del x, w


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="kernel")
    ap.add_argument("--cases", default=None,
                    help="comma list of HxW/batch (default 384x512/1,512x768/1,512x768/4; train: 320x720/6)")
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
    if args.config == "train":
        for mode in args.cudnn_benchmark.split(","):
            torch.backends.cudnn.benchmark = mode == "on"
            for case in (args.cases or TRAIN_CASE).split(","):
                print(f"[cudnn.benchmark {mode}]")
                profile_train(case, args.top)
                torch.cuda.empty_cache()
        return 0
    model = build_model(CONFIGS[args.config], seed=0, device="cuda")
    for mode in args.cudnn_benchmark.split(","):
        torch.backends.cudnn.benchmark = mode == "on"
        for case in (args.cases or "384x512/1,512x768/1,512x768/4").split(","):
            hw, batch = case.split("/")
            h, w = map(int, hw.split("x"))
            img = torch.zeros((int(batch), h, w, 3), device="cuda")
            print(f"[{args.config} config, {h}x{w} b{batch}, cudnn.benchmark {mode}]")
            with torch.inference_mode():
                state = anytime.prelude(model, img, img)
                run_stage("prelude", lambda: anytime.prelude(model, img, img), args.top)
                run_stage(f"chunk of {CHUNK_ITERS}",
                          lambda: anytime.chunk(model, state, CHUNK_ITERS), args.top)
            time_convs(model, {"image1": img, "image2": img}, int(batch))
            del img, state
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
