"""Pad images to a divisibility constraint or an exact bucket shape, NHWC.

PyTorch counterpart of `raft_stereo_tpu/utils/padding.py`: replicate-edge
padding, 'sintel' mode centres the pad, any other mode pads the bottom rows
only. `target=(H, W)` pads to an exact serving bucket. The serving front
edge-pads on the host with `np.pad` and these `pad_amounts`; evaluation pads
on the device with `pad`.
"""

from __future__ import annotations

import torch


class InputPadder:
    def __init__(self, dims, mode: str = "sintel", divis_by: int = 8, bucket: int = 0, target=None):
        # dims is an NHWC shape; only H and W matter.
        self.ht, self.wd = int(dims[1]), int(dims[2])
        if target is not None:
            tgt_ht, tgt_wd = int(target[0]), int(target[1])
            if tgt_ht < self.ht or tgt_wd < self.wd:
                raise ValueError(f"target {(tgt_ht, tgt_wd)} smaller than input {(self.ht, self.wd)}")
            if tgt_ht % divis_by or tgt_wd % divis_by:
                raise ValueError(
                    f"target {(tgt_ht, tgt_wd)} must be a multiple of divis_by ({divis_by})"
                )
            pad_ht = tgt_ht - self.ht
            pad_wd = tgt_wd - self.wd
        else:
            pad_ht = (((self.ht // divis_by) + 1) * divis_by - self.ht) % divis_by
            pad_wd = (((self.wd // divis_by) + 1) * divis_by - self.wd) % divis_by
            if bucket:
                if bucket % divis_by != 0:
                    raise ValueError(f"bucket ({bucket}) must be a multiple of divis_by ({divis_by})")
                pad_ht += -(self.ht + pad_ht) % bucket
                pad_wd += -(self.wd + pad_wd) % bucket
        if mode == "sintel":
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2)
        else:
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht)

    @property
    def pad_amounts(self):
        """(left, right, top, bottom)."""
        return self._pad

    def pad(self, *inputs: torch.Tensor):
        """Replicate-edge pad (B, H, W, C) tensors on their own device; one
        tensor for one input, else a list."""
        left, right, top, bottom = self._pad
        out = []
        for x in inputs:
            h, w = x.shape[1], x.shape[2]
            rows = torch.arange(-top, h + bottom, device=x.device).clamp(0, h - 1)
            cols = torch.arange(-left, w + right, device=x.device).clamp(0, w - 1)
            out.append(x[:, rows][:, :, cols])
        return out if len(out) > 1 else out[0]

    def unpad(self, x):
        """Crop a padded (B, H, W, C) array or tensor back to the input size."""
        left, right, top, bottom = self._pad
        h, w = x.shape[1], x.shape[2]
        return x[:, top : h - bottom, left : w - right, :]
