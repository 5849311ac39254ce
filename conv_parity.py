"""Hold this checkout's layer1 conv kernel (`csrc/encoder_conv.cu`), with no
halo, bit for bit against another checkout's on the same inputs, on one
card (e.g. the parent commit, unpacked with `git archive`):

    python3 conv_parity.py --other runs/parent

Each checkout runs in a fresh process in its own root, builds its own
kernel and writes the fp32 and bf16 convs' outputs and statistics, every
form, at shapes that take both input paths (the TMA raw tile and element
by element), ragged tiles and one and two images, from inputs seeded on
the host. This process compares the two files bit for bit and exits 1 on
any difference. It uses only `fused_conv`'s no-halo signature, which both
checkouts have. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

# (batch, rows, W): W 70 and 17 rows take the element-by-element path and
# ragged tiles; W 96 and 128 the TMA raw tile; 512x768 the serving bucket.
SHAPES = ((1, 13, 70), (2, 64, 96), (1, 40, 128), (2, 17, 64), (1, 512, 768))

CHILD = r'''
import sys, torch
sys.path.insert(0, ".")
from raft_stereo_tpu_torch.ops import encoder_cuda
shapes, out = eval(sys.argv[1]), sys.argv[2]
result, seed = {}, 0
for dtype in (torch.float32, torch.bfloat16):
    for b, h, w in shapes:
        for form in ("none", "in", "bn"):
            seed += 1
            g = torch.Generator().manual_seed(seed)
            x = torch.randn((b, 64, h, w), generator=g)
            weight = torch.randn((64, 64, 3, 3), generator=g) / 24.0
            bias = torch.randn((64,), generator=g) * 0.1
            aff = None
            if form != "none":
                u = torch.rand((b, 64), generator=g) * 1.5 + 0.5
                n = torch.randn((b, 64), generator=g) * 0.3
                aff = torch.stack([n, u] if form == "in" else [u, n], dim=1).contiguous().cuda()
            y, stats = encoder_cuda.fused_conv(x.cuda().to(dtype), weight.cuda(), bias.cuda(), aff, form, True)
            torch.cuda.synchronize()
            result[f"{str(dtype)[6:]} b{b} {h}x{w} {form}"] = (y.cpu(), stats.cpu())
torch.save(result, out)
'''


def run(root: str, out: str) -> None:
    subprocess.run([sys.executable, "-c", CHILD, repr(SHAPES), out], cwd=root, check=True)


def bits(t):
    import torch

    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--other", required=True, help="root of the other checkout")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("conv_parity: no CUDA device available", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        paths = {name: os.path.join(tmp, f"{name}.pt") for name in ("other", "this")}
        run(os.path.abspath(args.other), paths["other"])
        run(os.path.dirname(os.path.abspath(__file__)), paths["this"])
        other, this = (torch.load(paths[n]) for n in ("other", "this"))
    bad = 0
    for key, (y, stats) in other.items():
        same = torch.equal(bits(y), bits(this[key][0])) and torch.equal(bits(stats), bits(this[key][1]))
        bad += not same
        print(f"encoder_conv {key}: y and statistics bit for bit the other checkout's: {same}", flush=True)
    print(f"{len(other) - bad} of {len(other)} cases bit for bit equal", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
