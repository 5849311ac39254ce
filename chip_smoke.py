"""GPU smoke test of the PyTorch port: builds the CUDA kernels, holds each
against its plain PyTorch version, serves requests through the anytime
serving path at the default model's full width, checks the kernel
configuration end to end against the plain one, and times every kernel.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Needs no JAX. Exits non-zero on any failure, and before printing anything
when no CUDA device is available. Prints the card's name and power limit,
then one JSON line describing the kernels, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from raft_stereo_tpu_torch.config import RAFTStereoConfig, ServeConfig
from raft_stereo_tpu_torch.models import anytime
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.ops import _build, corr, corr_cuda, gru_tail
from raft_stereo_tpu_torch.serving.service import StereoService

# The slice's model: the default architecture with the CUDA lookup and the
# fused GRU tails, fp32 throughout.
KERNEL_CONFIG = RAFTStereoConfig(corr_implementation="pallas", fused_gru_tail=True)
PLAIN_CONFIG = RAFTStereoConfig(corr_implementation="reg", fused_gru_tail=False)
SEED = 0
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# Tolerances. The kernels are compiled with -fmad=false and round where the
# plain versions round, so the lookup and motion tail are expected to agree
# exactly; the GRU tail may differ in the last ulp of expf/tanhf.
TOL = {"corr_lookup": 1e-5, "gru_tail": 1e-6, "motion_tail": 0.0}
E2E_TOL_PX = 1e-3

KERNELS = {
    "corr_lookup": ("raft_stereo_tpu_torch/csrc/corr_lookup.cu", "raft_stereo_tpu/ops/corr_pallas.py:90"),
    "gru_tail": ("raft_stereo_tpu_torch/csrc/gru_tail.cu", "raft_stereo_tpu/ops/gru_tail_pallas.py:48"),
    "motion_tail": ("raft_stereo_tpu_torch/csrc/gru_tail.cu", "raft_stereo_tpu/ops/gru_tail_pallas.py:55"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_launches() -> None:
    for counts in (corr_cuda.LAUNCHES, gru_tail.LAUNCHES):
        for k in counts:
            counts[k] = 0


def launches() -> dict:
    return {**corr_cuda.LAUNCHES, **gru_tail.LAUNCHES}


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


# -- inputs at main-path shapes ------------------------------------------------

def lookup_inputs(gen, b, h, w1, w2, levels=4, radius=4):
    """Random pyramid levels and coordinates: mostly in range, with a share
    far below 0 and past W2 (those must give zero taps)."""
    pyramid = []
    w = w2
    for _ in range(levels):
        pyramid.append(torch.randn((b, h, w1, w), generator=gen, device=DEVICE))
        w //= 2
    base = torch.arange(w1, dtype=torch.float32, device=DEVICE).expand(b, h, w1)
    disp = torch.rand((b, h, w1), generator=gen, device=DEVICE) * (w2 / 4)
    coords = base - disp
    wild = torch.rand((b, h, w1), generator=gen, device=DEVICE)
    far = (torch.rand((b, h, w1), generator=gen, device=DEVICE) - 0.5) * 4 * (w2 + 2 * radius + 8)
    coords = torch.where(wild < 0.1, far, coords).contiguous()
    return tuple(pyramid), coords


def lookup_bytes(pyramid, coords, radius) -> int:
    """Bytes the lookup must move on these inputs: coordinates and outputs
    once, plus each in-range pyramid sample a query's window touches."""
    n_q = coords.numel()
    k = 2 * radius + 1
    total = 4 * n_q + 4 * n_q * len(pyramid) * k
    for lvl, vol in enumerate(pyramid):
        w2 = vol.shape[-1]
        lo = torch.floor(coords / (2**lvl) - radius)
        hi = lo + 2 * radius + 1
        touched = (torch.minimum(hi, torch.tensor(w2 - 1.0, device=coords.device))
                   - torch.maximum(lo, torch.zeros((), device=coords.device)) + 1).clamp(min=0)
        total += 4 * int(touched.sum().item())
    return total


def grid_sample_lookup_inputs(pyramid, coords, radius):
    """The same lookup as one F.grid_sample call: levels zero-padded to W2
    and stacked on the batch axis, one height-1 row per query."""
    n_q = coords.numel()
    w2 = pyramid[0].shape[-1]
    rows = torch.zeros((len(pyramid), n_q, w2), device=coords.device)
    for lvl, vol in enumerate(pyramid):
        rows[lvl, :, : vol.shape[-1]] = vol.reshape(n_q, -1)
    offsets = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    t = torch.stack([coords.reshape(n_q, 1) / (2**lvl) + offsets for lvl in range(len(pyramid))])
    grid = torch.stack([2.0 * t / (w2 - 1) - 1.0, torch.zeros_like(t)], dim=-1)
    return rows.reshape(-1, 1, 1, w2), grid.reshape(-1, 1, 2 * radius + 1, 2)


def tail_inputs(gen, c, h, w):
    return tuple(torch.randn((1, c, h, w), generator=gen, device=DEVICE) * 2 for _ in range(5))


def motion_inputs(gen, h, w):
    return (torch.randn((1, 126, h, w), generator=gen, device=DEVICE),
            torch.randn((1, 1, h, w), generator=gen, device=DEVICE))


def max_err(a, b) -> float:
    return float((a - b).abs().max().item())


# -- timing --------------------------------------------------------------------

def time_ms(fn, reps=30, flush=None) -> float:
    """Median device time of one call, by CUDA events around each call.
    `flush` (a large buffer) is rewritten before every call so the call
    finds the L2 cache cold, as it does between the model's other layers."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


# -- phases --------------------------------------------------------------------

def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build(["corr_lookup", "gru_tail"])
    log(f"[build] nvcc sm_90a, parallel: {built} ({time.perf_counter() - t0:.2f} s wall)")
    for name in ("corr_lookup", "gru_tail"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_kernels(gen) -> dict:
    """Every kernel against its plain version at the main path's shapes."""
    errs = {}
    cases = [(384, 512), (512, 768), (1984, 2880)]
    for hh, ww in cases:
        pyramid, coords = lookup_inputs(gen, 1, hh // 4, ww // 4, ww // 4)
        got = corr_cuda.corr_lookup(pyramid, coords, 4)
        torch.cuda.synchronize()
        err = max_err(got, corr.corr_lookup(pyramid, coords, 4))
        log(f"[kernels] corr_lookup {hh}x{ww} (queries {hh // 4}x{ww // 4}, W2 {ww // 4}): "
            f"max abs diff {err:.3e} (tol {TOL['corr_lookup']:g})")
        if not err <= TOL["corr_lookup"]:
            raise AssertionError(f"corr_lookup disagrees with its plain version at {hh}x{ww}: {err}")
        errs["corr_lookup"] = max(errs.get("corr_lookup", 0.0), err)
    for div in (4, 8, 16):
        h, w = 512 // div, 768 // div
        ops = tail_inputs(gen, 128, h, w)
        got = gru_tail.fused_gru_tail(*ops)
        torch.cuda.synchronize()
        err = max_err(got, gru_tail.plain_gru_tail(*ops))
        log(f"[kernels] gru_tail 128x{h}x{w}: max abs diff {err:.3e} (tol {TOL['gru_tail']:g})")
        if not err <= TOL["gru_tail"]:
            raise AssertionError(f"gru_tail disagrees with its plain version at 1/{div}: {err}")
        errs["gru_tail"] = max(errs.get("gru_tail", 0.0), err)
    for hh, ww in cases[:2]:
        pre, flow = motion_inputs(gen, hh // 4, ww // 4)
        got = gru_tail.fused_motion_tail(pre, flow)
        torch.cuda.synchronize()
        err = max_err(got, gru_tail.plain_motion_tail(pre, flow))
        log(f"[kernels] motion_tail 126x{hh // 4}x{ww // 4}: max abs diff {err:.3e} "
            f"(tol {TOL['motion_tail']:g})")
        if not err <= TOL["motion_tail"]:
            raise AssertionError(f"motion_tail disagrees with its plain version at {hh}x{ww}: {err}")
        errs["motion_tail"] = max(errs.get("motion_tail", 0.0), err)
    return errs


def stereo_pair(rng, h, w, shift=12):
    """A textured pair whose right image is the left shifted by `shift` px."""
    left = rng.uniform(0, 255, (h, w + shift, 3)).astype(np.float32)
    return left[:, shift:], left[:, :w]


def phase_serving(rng) -> tuple:
    cfg = ServeConfig(model=KERNEL_CONFIG)
    t0 = time.perf_counter()
    service = StereoService(cfg, device="cuda", seed=SEED).start()
    warm = service.warm_summary
    log(f"[serving] boot + warm of {warm['combos']} (bucket, batch) combos: {time.perf_counter() - t0:.2f} s")
    for key in warm["prelude_ms"]:
        log(f"[serving] {key}: prelude {warm['prelude_ms'][key]:.3f} ms, "
            f"chunk of {cfg.chunk_iters} iters {warm['chunk_est_ms'][key]:.3f} ms")
    requests = [
        ("384x512 bucket", (384, 512), None),
        ("512x768 bucket", (512, 768), None),
        ("padded 300x500", (300, 500), None),
        ("tight deadline", (512, 768), 1.0),
    ]
    reset_launches()
    iters_total = 0
    responses = []
    for label, (h, w), deadline_ms in requests:
        i1, i2 = stereo_pair(rng, h, w)
        res = service.submit(i1, i2, deadline_ms=deadline_ms).result()
        log(f"[serving] {label}: bucket {res['bucket']}, iters_completed {res['iters_completed']}, "
            f"early_exit {res['early_exit']}, latency {res['latency_ms']:.3f} ms")
        disp = res["disparity"]
        if disp.shape != (h, w) or not np.isfinite(disp).all():
            raise AssertionError(f"{label}: disparity shape {disp.shape} or non-finite values")
        iters_total += res["iters_completed"]
        responses.append((label, res))
    counts = launches()
    log(f"[serving] launches over {len(requests)} requests ({iters_total} iterations): {counts}")
    if responses[-1][1]["iters_completed"] != cfg.chunk_iters or not responses[-1][1]["early_exit"]:
        raise AssertionError("the tight-deadline request did not exit after one chunk")
    if any(r["iters_completed"] != cfg.max_iters for _, r in responses[:-1]):
        raise AssertionError("a request without a deadline stopped short of max_iters")
    want = {"corr_lookup": iters_total, "gru_tail": 3 * iters_total, "motion_tail": iters_total}
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != expected {want}")
    return service, counts


def phase_stage_times(service) -> None:
    """Steady-state prelude and chunk wall times per (bucket, batch), after
    warm-up: median of three synchronized calls each."""
    engine, cfg = service.engine, service.config
    with torch.inference_mode():
        for hw in cfg.buckets:
            for batch in cfg.batch_sizes:
                img = torch.zeros((batch, *hw, 3), device=DEVICE)
                pre, chk = [], []
                for _ in range(3):
                    t = time.perf_counter()
                    state = anytime.prelude(engine.model, img, img)
                    torch.cuda.synchronize()
                    pre.append(time.perf_counter() - t)
                for _ in range(3):
                    t = time.perf_counter()
                    state = anytime.chunk(engine.model, state, cfg.chunk_iters)
                    torch.cuda.synchronize()
                    chk.append(time.perf_counter() - t)
                log(f"[stages] {hw[0]}x{hw[1]}/b{batch}: prelude {statistics.median(pre) * 1e3:.3f} ms, "
                    f"chunk of {cfg.chunk_iters} iters {statistics.median(chk) * 1e3:.3f} ms "
                    f"(all chunks: {', '.join(f'{c * 1e3:.3f}' for c in chk)} ms)")


def phase_end_to_end(service, rng) -> None:
    """The kernel configuration against the plain one on the same weights."""
    kernel_model = service.engine.model
    with torch.device("meta"):
        plain_model = RAFTStereo(PLAIN_CONFIG)
    plain_model = plain_model.to_empty(device=DEVICE).eval()
    plain_model.load_state_dict(kernel_model.state_dict())
    i1, i2 = stereo_pair(rng, 384, 512)
    i1 = torch.from_numpy(i1[None]).cuda()
    i2 = torch.from_numpy(i2[None]).cuda()
    with torch.inference_mode():
        lo_k, up_k = kernel_model(i1, i2, iters=4)
        lo_p, up_p = plain_model(i1, i2, iters=4)
    torch.cuda.synchronize()
    err_up, err_lo = max_err(up_k, up_p), max_err(lo_k, lo_p)
    log(f"[e2e] 384x512, 4 iters, kernels vs plain: flow_up max abs diff {err_up:.3e} px, "
        f"flow_lowres {err_lo:.3e} px (tol {E2E_TOL_PX:g} px); |flow_up| max {up_k.abs().max().item():.3f}")
    if not (torch.isfinite(up_k).all() and err_up <= E2E_TOL_PX and err_lo <= E2E_TOL_PX):
        raise AssertionError("kernel configuration disagrees with the plain configuration")


def phase_timing(gen, errs, counts) -> list:
    """Kernel, plain and library times at the 512x768 bucket's shapes."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=DEVICE)  # 256 MB > L2
    out = []

    def entry(name, ms, plain_ms, nbytes, flops, library_ms):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        src, replaces = KERNELS[name]
        e = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        }
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"[timing] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}, {nbytes} B), library {lib}")
        out.append(e)

    for label, (hh, ww) in (("512x768", (512, 768)), ("1984x2880", (1984, 2880))):
        pyramid, coords = lookup_inputs(gen, 1, hh // 4, ww // 4, ww // 4)
        ms = time_ms(lambda: corr_cuda.corr_lookup(pyramid, coords, 4), flush=flush)
        plain_ms = time_ms(lambda: corr.corr_lookup(pyramid, coords, 4), flush=flush)
        nbytes = lookup_bytes(pyramid, coords, 4)
        if label == "512x768":
            rows, grid = grid_sample_lookup_inputs(pyramid, coords, 4)

            def sample():
                return F.grid_sample(rows, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

            lib_ms = time_ms(sample, flush=flush)
            lib = sample().reshape(4, -1, 9).permute(1, 0, 2).reshape(coords.shape + (36,))
            log(f"[timing] corr_lookup {label}: grid_sample vs kernel max abs diff "
                f"{max_err(lib, corr_cuda.corr_lookup(pyramid, coords, 4)):.3e}")
            entry("corr_lookup", ms, plain_ms, nbytes, 3 * coords.numel() * 36, lib_ms)
            del rows, grid, lib
        else:
            # cuDNN's grid sampler refuses a batch of one row per query at
            # this size, so no library time here.
            log(f"[timing] corr_lookup {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes), library not measured")
        del pyramid, coords

    for div in (4, 8, 16):
        ops = tail_inputs(gen, 128, 512 // div, 768 // div)
        ms = time_ms(lambda: gru_tail.fused_gru_tail(*ops), flush=flush)
        plain_ms = time_ms(lambda: gru_tail.plain_gru_tail(*ops), flush=flush)
        n = ops[0].numel()
        if div == 4:
            entry("gru_tail", ms, plain_ms, 6 * 4 * n, 12 * n, None)
        else:
            log(f"[timing] gru_tail 128x{512 // div}x{768 // div}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, "
                f"bound {6 * 4 * n / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)")

    pre, flow = motion_inputs(gen, 128, 192)
    ms = time_ms(lambda: gru_tail.fused_motion_tail(pre, flow), flush=flush)
    plain_ms = time_ms(lambda: gru_tail.plain_motion_tail(pre, flow), flush=flush)
    hw = 128 * 192
    entry("motion_tail", ms, plain_ms, 4 * hw * (126 + 1 + 128), 126 * hw, None)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = gpu_line()
    log(card)
    log(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    phase_build()
    errs = phase_kernels(gen)
    service, counts = phase_serving(rng)
    phase_stage_times(service)
    phase_end_to_end(service, rng)
    del service
    torch.cuda.empty_cache()
    kernels = phase_timing(gen, errs, counts)

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
