"""Device-time breakdown of the anytime serving stages on a CUDA card.

    python -m raft_stereo_tpu_torch.profile_stages [--config kernel|fused]
        [--cases 384x512/1,512x768/1] [--cudnn-benchmark off,on] [--top 8]

Builds the default model with the CUDA lookup and fused GRU tails
(`--config kernel`), or with the fused encoder prelude on top of them
(`--config fused`: pyramid build, layer1 convs and joins as kernels), with
seeded random weights, fp32, TF32 off, and for each (bucket, batch) case and
cuDNN benchmark mode warms it, then times one prelude and one chunk of 4
iterations (synchronized wall clock) and traces each with `torch.profiler`.
Prints per stage the wall time, the summed device-kernel time, the device's
busy share (kernel time over wall time), the time by kernel family, and the
kernels that take most device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models import anytime
from raft_stereo_tpu_torch.models.init import build_model

CHUNK_ITERS = 4
CONFIGS = {
    "kernel": RAFTStereoConfig(corr_implementation="pallas", fused_gru_tail=True),
    "fused": RAFTStereoConfig(corr_implementation="pallas", fused_gru_tail=True, fused_encoder=True),
}
FAMILIES = (
    ("port kernels", ("corr_lookup_kernel", "gru_tail_", "motion_tail_kernel", "corr_pyramid_kernel",
                      "encoder_conv_kernel", "encoder_stats_kernel", "join_kernel")),
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="kernel")
    ap.add_argument("--cases", default="384x512/1,512x768/1,512x768/4")
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
    model = build_model(CONFIGS[args.config], seed=0, device="cuda")
    for mode in args.cudnn_benchmark.split(","):
        torch.backends.cudnn.benchmark = mode == "on"
        for case in args.cases.split(","):
            hw, batch = case.split("/")
            h, w = map(int, hw.split("x"))
            img = torch.zeros((int(batch), h, w, 3), device="cuda")
            print(f"[{args.config} config, {h}x{w} b{batch}, cudnn.benchmark {mode}]")
            with torch.inference_mode():
                state = anytime.prelude(model, img, img)
                run_stage("prelude", lambda: anytime.prelude(model, img, img), args.top)
                run_stage(f"chunk of {CHUNK_ITERS}",
                          lambda: anytime.chunk(model, state, CHUNK_ITERS), args.top)
            del img, state
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
