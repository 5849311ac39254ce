"""Stereo dataset catalog and per-item pipeline: the port's copy of the
JAX package's `raft_stereo_tpu/data/datasets.py` (the reference's
core/stereo_datasets.py), numpy only.

- Items are pure functions of (paths, rng) -> dict of NHWC float32 arrays;
  the loader (data/loader.py) drives them with per-index RNG seeds, so any
  item is reproducible on any host and equals the JAX package's item.
- Repaired reference bugs, as in the JAX package: dataset dispatch honours
  the requested names (the reference forced the Gated dataset with an
  `if True:`), and KITTI takes `image_set=` throughout (the reference
  passed a dead `split=`).

Item dict: {"image1", "image2", "flow" (H,W,1 = -disp), "valid" (H,W)} plus
"paths" metadata. Disparity -> flow convention: flow = -disp; only the x
channel is carried.
"""

from __future__ import annotations

import copy
import functools
import glob as globlib
import logging
import os.path as osp
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from raft_stereo_tpu_torch.config import (
    CameraConfig,
    MODALITY_ALL_GATED,
    MODALITY_PASSIVE_GATED,
    TrainConfig,
)
from raft_stereo_tpu_torch.data import frame_io, native_io
from raft_stereo_tpu_torch.data.augment import StereoAugmentor, vary_ambient_light

logger = logging.getLogger(__name__)

GATED_SLICE_TYPES = ("type6", "type7", "type8", "type9", "type10")


class StereoDataset:
    """Index of (image paths, disparity path) pairs + the read→augment→pack
    pipeline (reference StereoDataset, stereo_datasets.py:122-262)."""

    def __init__(
        self,
        augmentor: Optional[StereoAugmentor] = None,
        sparse: bool = False,
        disparity_reader: Optional[Callable] = None,
        img_pad: Optional[Tuple[int, int]] = None,
    ):
        self.augmentor = augmentor
        self.sparse = sparse
        self.disparity_reader = disparity_reader or frame_io.read_gen
        self.img_pad = img_pad
        # Transient-I/O attempts per frame read; build_training_dataset
        # overrides this with config.io_retries so the --io_retries knob
        # governs dataset reads like it governs checkpoint I/O (README
        # "Operations"). Kept as an attribute (not a ctor param) so the
        # many dataset subclasses and __mul__/__add__ compositions inherit
        # it without signature churn.
        self.io_retries = 2
        self.image_list: List[List] = []
        self.disparity_list: List[str] = []
        self.extra_info: List = []

    def __len__(self) -> int:
        return len(self.image_list)

    def __mul__(self, v: int) -> "StereoDataset":
        """Oversampling by index replication (reference __mul__,
        stereo_datasets.py:252-258)."""
        out = copy.copy(self)
        out.image_list = v * self.image_list
        out.disparity_list = v * self.disparity_list
        out.extra_info = v * self.extra_info
        return out

    def __add__(self, other: "StereoDataset") -> "StereoDataset":
        out = copy.copy(self)
        out.image_list = self.image_list + other.image_list
        out.disparity_list = self.disparity_list + other.disparity_list
        out.extra_info = self.extra_info + other.extra_info
        return out

    # --- per-item pipeline (reference __getitem__, stereo_datasets.py:145-249) ---
    def load_raw(self, index: int):
        """Read images + disparity from disk, before augmentation.

        Each read gets one transient-I/O retry (utils/retry.py): on network
        mounts a single EIO/ESTALE blip is routine and must not cost the
        loader a whole sample (let alone the epoch — the loader's quarantine
        policy only kicks in after these retries are exhausted)."""
        from raft_stereo_tpu_torch.utils.retry import is_transient_io, retry_call

        def read(reader, path):
            return retry_call(
                lambda: reader(path),
                attempts=self.io_retries,
                base_delay=0.1,
                classify=is_transient_io,
                label=path,
            )

        index = index % len(self.image_list)
        disp = read(self.disparity_reader, self.disparity_list[index])
        if isinstance(disp, tuple):
            disp, valid = disp
        else:
            valid = disp < 512
        img1 = read(frame_io.read_gen, self.image_list[index][0])
        img2 = read(frame_io.read_gen, self.image_list[index][1])
        img1 = np.asarray(img1)
        img2 = np.asarray(img2)
        disp = np.asarray(disp, np.float32)
        return img1, img2, disp, np.asarray(valid)

    def get_item(self, index: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        img1, img2, disp, valid = self.load_raw(index)

        # grayscale → 3-channel
        if img1.ndim == 2:
            img1 = np.tile(img1[..., None], (1, 1, 3))
            img2 = np.tile(img2[..., None], (1, 1, 3))
        img1 = img1[..., :3] if img1.shape[-1] > 3 else img1
        img2 = img2[..., :3] if img2.shape[-1] > 3 else img2

        flow = np.stack([-disp, np.zeros_like(disp)], axis=-1)

        if self.augmentor is not None:
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(rng, img1, img2, flow, valid)
            else:
                img1, img2, flow = self.augmentor(rng, img1, img2, flow)

        img1 = np.ascontiguousarray(img1, np.float32)
        img2 = np.ascontiguousarray(img2, np.float32)
        flow = np.ascontiguousarray(flow, np.float32)
        if self.sparse:
            valid_out = np.ascontiguousarray(valid, np.float32)
        else:
            valid_out = ((np.abs(flow[..., 0]) < 512) & (np.abs(flow[..., 1]) < 512)).astype(
                np.float32
            )

        if self.img_pad is not None:
            pad_h, pad_w = self.img_pad
            img1 = np.pad(img1, ((pad_h,) * 2, (pad_w,) * 2, (0, 0)))
            img2 = np.pad(img2, ((pad_h,) * 2, (pad_w,) * 2, (0, 0)))

        return {
            "image1": img1,
            "image2": img2,
            "flow": flow[..., :1],
            "valid": valid_out,
            "paths": tuple(map(str, np.ravel(self.image_list[index % len(self.image_list)])))
            + (self.disparity_list[index % len(self.image_list)],),
        }


def _glob(pattern: str) -> List[str]:
    return sorted(globlib.glob(pattern))


class SceneFlowDatasets(StereoDataset):
    """FlyingThings3D + Monkaa + Driving (reference stereo_datasets.py:264-325).
    `things_test=True` selects the 400-image FlyingThings validation subset
    drawn with the reference's fixed seed-1000 permutation."""

    def __init__(self, augmentor=None, root="datasets", dstype="frames_cleanpass", things_test=False):
        super().__init__(augmentor)
        self.root = root
        self.dstype = dstype
        if things_test:
            self._add_things("TEST")
        else:
            self._add_things("TRAIN")
            self._add_monkaa()
            self._add_driving()

    def _add_things(self, split: str):
        root = osp.join(self.root, "FlyingThings3D")
        left = _glob(osp.join(root, self.dstype, split, "*/*/left/*.png"))
        right = [p.replace("left", "right") for p in left]
        disp = [p.replace(self.dstype, "disparity").replace(".png", ".pfm") for p in left]
        # reproduce the reference's fixed validation draw (seed 1000, first 400)
        val_idxs = set(np.random.RandomState(1000).permutation(len(left))[:400])
        n0 = len(self.disparity_list)
        for idx, triple in enumerate(zip(left, right, disp)):
            if split == "TRAIN" or idx in val_idxs:
                self.image_list.append([triple[0], triple[1]])
                self.disparity_list.append(triple[2])
        logger.info("Added %d from FlyingThings %s", len(self.disparity_list) - n0, self.dstype)

    def _add_monkaa(self):
        root = osp.join(self.root, "Monkaa")
        left = _glob(osp.join(root, self.dstype, "*/left/*.png"))
        for p in left:
            self.image_list.append([p, p.replace("left", "right")])
            self.disparity_list.append(p.replace(self.dstype, "disparity").replace(".png", ".pfm"))

    def _add_driving(self):
        root = osp.join(self.root, "Driving")
        left = _glob(osp.join(root, self.dstype, "*/*/*/left/*.png"))
        for p in left:
            self.image_list.append([p, p.replace("left", "right")])
            self.disparity_list.append(p.replace(self.dstype, "disparity").replace(".png", ".pfm"))


class ETH3D(StereoDataset):
    """(reference stereo_datasets.py:328-338)"""

    def __init__(self, augmentor=None, root="datasets/ETH3D", split="training"):
        super().__init__(augmentor, sparse=True)
        im0 = _glob(osp.join(root, f"two_view_{split}/*/im0.png"))
        im1 = _glob(osp.join(root, f"two_view_{split}/*/im1.png"))
        if split == "training":
            disp = _glob(osp.join(root, "two_view_training_gt/*/disp0GT.pfm"))
        else:
            disp = [osp.join(root, "two_view_training_gt/playground_1l/disp0GT.pfm")] * len(im0)
        for a, b, d in zip(im0, im1, disp):
            self.image_list.append([a, b])
            self.disparity_list.append(d)


class SintelStereo(StereoDataset):
    """(reference stereo_datasets.py:340-351)"""

    def __init__(self, augmentor=None, root="datasets/SintelStereo"):
        super().__init__(augmentor, sparse=True, disparity_reader=frame_io.read_disp_sintel)
        im0 = _glob(osp.join(root, "training/*_left/*/frame_*.png"))
        im1 = _glob(osp.join(root, "training/*_right/*/frame_*.png"))
        disp = _glob(osp.join(root, "training/disparities/*/frame_*.png")) * 2
        for a, b, d in zip(im0, im1, disp):
            assert a.split("/")[-2:] == d.split("/")[-2:]
            self.image_list.append([a, b])
            self.disparity_list.append(d)


class FallingThings(StereoDataset):
    """(reference stereo_datasets.py:353-367)"""

    def __init__(self, augmentor=None, root="datasets/FallingThings"):
        super().__init__(augmentor, disparity_reader=frame_io.read_disp_falling_things)
        with open(osp.join(root, "filenames.txt")) as f:
            names = sorted(f.read().splitlines())
        for e in names:
            self.image_list.append([osp.join(root, e), osp.join(root, e.replace("left.jpg", "right.jpg"))])
            self.disparity_list.append(osp.join(root, e.replace("left.jpg", "left.depth.png")))


class TartanAir(StereoDataset):
    """(reference stereo_datasets.py:369-385)"""

    def __init__(self, augmentor=None, root="datasets", keywords=()):
        super().__init__(augmentor, disparity_reader=frame_io.read_disp_tartanair)
        with open(osp.join(root, "tartanair_filenames.txt")) as f:
            names = sorted(s for s in f.read().splitlines() if "seasonsforest_winter/Easy" not in s)
        for kw in keywords:
            names = sorted(s for s in names if kw in s.lower())
        for e in names:
            self.image_list.append([osp.join(root, e), osp.join(root, e.replace("_left", "_right"))])
            self.disparity_list.append(
                osp.join(root, e.replace("image_left", "depth_left").replace("left.png", "left_depth.npy"))
            )


class KITTI(StereoDataset):
    """(reference stereo_datasets.py:387-398)"""

    def __init__(self, augmentor=None, root="datasets/KITTI", image_set="training"):
        super().__init__(augmentor, sparse=True, disparity_reader=frame_io.read_disp_kitti)
        im0 = _glob(osp.join(root, image_set, "image_2/*_10.png"))
        im1 = _glob(osp.join(root, image_set, "image_3/*_10.png"))
        if image_set == "training":
            disp = _glob(osp.join(root, "training", "disp_occ_0/*_10.png"))
        else:
            disp = [osp.join(root, "training/disp_occ_0/000085_10.png")] * len(im0)
        for a, b, d in zip(im0, im1, disp):
            self.image_list.append([a, b])
            self.disparity_list.append(d)


class Middlebury(StereoDataset):
    """Splits F/H/Q (MiddEval3, filtered by official_train.txt) and 2014
    (E/L/"" exposures) (reference stereo_datasets.py:401-421)."""

    def __init__(self, augmentor=None, root="datasets/Middlebury", split="F"):
        super().__init__(augmentor, sparse=True, disparity_reader=frame_io.read_disp_middlebury)
        assert split in ("F", "H", "Q", "2014")
        if split == "2014":
            for scene in sorted((Path(root) / "2014").glob("*")):
                for s in ("E", "L", ""):
                    self.image_list.append([str(scene / "im0.png"), str(scene / f"im1{s}.png")])
                    self.disparity_list.append(str(scene / "disp0.pfm"))
        else:
            official = Path(osp.join(root, "MiddEval3/official_train.txt")).read_text().splitlines()
            names = [
                osp.basename(p)
                for p in _glob(osp.join(root, "MiddEval3/trainingF/*"))
                if any(s in p.split("/") for s in official)
            ]
            for name in sorted(names):
                base = osp.join(root, "MiddEval3", f"training{split}", name)
                self.image_list.append([osp.join(base, "im0.png"), osp.join(base, "im1.png")])
                self.disparity_list.append(osp.join(base, "disp0GT.pfm"))
            assert len(self.image_list) > 0, (root, split)


class Gated(StereoDataset):
    """Gated-camera stereo with projected-lidar GT (fork dataset, reference
    stereo_datasets.py:423-497).

    Modalities: RGB (cam_stereo tree), passive gated (type7 slice), all-gated
    (5 slices stacked as channels). Frames are filtered by the
    (date, frame-index) pairs in `indexes_file` (the reference hardcodes an
    absolute path, :425; here it is an argument). 720x1280 frames are cropped
    to 704 rows (rows 8:-8, :204-207) to satisfy the /32 constraint; the
    gated modalities use the rig's ambient-light augmentation instead of the
    generic augmentor (:228 vs :190-191).
    """

    def __init__(
        self,
        root: str,
        augmentor=None,
        use_passive_gated: bool = False,
        use_all_gated: bool = False,
        indexes_file: Optional[str] = None,
        camera: CameraConfig = CameraConfig(),
    ):
        # functools.partial (not a lambda) so the dataset pickles into
        # process-pool loader workers (data/loader.py worker_type="process").
        reader = functools.partial(
            frame_io.read_disp_gated_lidar,
            focal_px=camera.focal_px,
            baseline_m=camera.baseline_m,
        )
        super().__init__(augmentor, sparse=True, disparity_reader=reader)
        self.use_passive_gated = use_passive_gated
        self.use_all_gated = use_all_gated
        self.last_folder_name = osp.basename(osp.normpath(root))

        allowed = None
        if indexes_file:
            allowed = set()
            with open(indexes_file) as f:
                for line in f:
                    day, ind = line.rstrip().split(",")
                    allowed.add((day, ind))

        def keep(path: str) -> bool:
            if allowed is None:
                return True
            day = path.split("/" + self.last_folder_name + "/")[1].split("/")[0]
            ind = path.split("/")[-1].split("_")[0]
            return (day, ind) in allowed

        for folder in _glob(root + "/*/"):
            if use_all_gated:
                lefts = [
                    _glob(folder + f"/framegrabber/left/bwv/{t}/image_rect8/*.png")
                    for t in GATED_SLICE_TYPES
                ]
                rights = [
                    _glob(folder + f"/framegrabber/right/bwv/{t}/image_rect8/*.png")
                    for t in GATED_SLICE_TYPES
                ]
                disps = _glob(folder + "/framegrabber/left/lidar_vls128_projected/*.npz")
                lengths = {len(l) for l in lefts + rights} | {len(disps)}
                if len(lengths) != 1:
                    logger.warning("gated folder %s: mismatched counts %s", folder, lengths)
                    continue
                for i in range(len(disps)):
                    frame_left = [l[i] for l in lefts]
                    frame_right = [r[i] for r in rights]
                    if keep(frame_left[0]):
                        self.image_list.append([frame_left, frame_right])
                        self.disparity_list.append(disps[i])
            else:
                if use_passive_gated:
                    disps_p = folder + "/framegrabber/left/lidar_vls128_projected/*.npz"
                    left_p = folder + "/framegrabber/left/bwv/type7/image_rect8/*.png"
                    right_p = folder + "/framegrabber/right/bwv/type7/image_rect8/*.png"
                else:
                    disps_p = folder + "/cam_stereo/left/lidar_vls128_projected/*.npz"
                    left_p = disps_p.replace("/lidar_vls128_projected/", "/image_rect/").replace(
                        ".npz", ".png"
                    )
                    right_p = left_p.replace("/left/", "/right/")
                im0, im1, disps = _glob(left_p), _glob(right_p), _glob(disps_p)
                if not (len(im0) == len(im1) == len(disps)):
                    logger.warning(
                        "gated folder %s: mismatched counts %d/%d/%d",
                        folder, len(im0), len(im1), len(disps),
                    )
                    continue
                for a, b, d in zip(im0, im1, disps):
                    if keep(a):
                        self.image_list.append([a, b])
                        self.disparity_list.append(d)

    def load_raw(self, index: int):
        index = index % len(self.image_list)
        disp, valid = self.disparity_reader(self.disparity_list[index])
        if self.use_all_gated:
            # All 10 slice PNGs of the frame decode concurrently in native
            # threads (native_io.read_images; frame_io fallback inside).
            paths = list(self.image_list[index][0]) + list(self.image_list[index][1])
            slices = native_io.read_images(paths)
            n = len(self.image_list[index][0])
            img1 = np.stack(slices[:n], axis=-1).astype(np.float32)
            img2 = np.stack(slices[n:], axis=-1).astype(np.float32)
        else:
            img1 = np.asarray(frame_io.read_gen(self.image_list[index][0]))
            img2 = np.asarray(frame_io.read_gen(self.image_list[index][1]))
        return img1, img2, np.asarray(disp, np.float32), np.asarray(valid)

    def get_item(self, index: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        if not (self.use_all_gated or self.use_passive_gated):
            return super().get_item(index, rng)

        img1, img2, disp, valid = self.load_raw(index)

        if self.use_all_gated:
            # ambient-light augmentation replaces the generic augmentor
            # (reference stereo_datasets.py:183-191, 228)
            first = self.image_list[index % len(self.image_list)][0][0]
            date = first.split(self.last_folder_name + "/")[-1].split("/framegrabber/left/")[0]
            weight_darker = (rng.random() - 0.5) * 1.0
            img1 = vary_ambient_light(rng, img1, weight_darker, is_left=True, date=date)
            img2 = vary_ambient_light(rng, img2, weight_darker, is_left=False, date=date)

        # 720x1280 → 704 rows (reference crop rule, stereo_datasets.py:196-207)
        if img1.shape[0] == 720 and img1.shape[1] == 1280:
            img1, img2 = img1[8:-8], img2[8:-8]
            disp, valid = disp[8:-8], valid[8:-8]
        elif img1.shape[0] % 32 != 0 or img1.shape[1] % 32 != 0:
            raise ValueError(f"gated frame not /32: {img1.shape}")

        if self.use_passive_gated:
            assert img1.ndim == 2
            img1 = np.stack([img1] * 3, axis=-1)
            img2 = np.stack([img2] * 3, axis=-1)

        flow = -disp[..., None].astype(np.float32)
        return {
            "image1": np.ascontiguousarray(img1, np.float32),
            "image2": np.ascontiguousarray(img2, np.float32),
            "flow": np.ascontiguousarray(flow),
            "valid": np.ascontiguousarray(valid, np.float32),
            "paths": (str(self.image_list[index % len(self.image_list)][0]),),
        }


def _sequence_texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Random smooth RGB texture in [0, 255]: noise octaves bilinearly
    upsampled, numpy only."""
    img = np.zeros((h, w, 3), np.float32)
    for scale in (4, 8, 16):
        gh, gw = max(2, h // scale), max(2, w // scale)
        grid = rng.uniform(-1, 1, (gh, gw, 3)).astype(np.float32)
        yy = np.linspace(0, gh - 1, h, dtype=np.float32)
        xx = np.linspace(0, gw - 1, w, dtype=np.float32)
        y0 = np.floor(yy).astype(int).clip(0, gh - 2)
        x0 = np.floor(xx).astype(int).clip(0, gw - 2)
        fy = (yy - y0)[:, None, None]
        fx = (xx - x0)[None, :, None]
        g = (
            grid[y0][:, x0] * (1 - fy) * (1 - fx)
            + grid[y0][:, x0 + 1] * (1 - fy) * fx
            + grid[y0 + 1][:, x0] * fy * (1 - fx)
            + grid[y0 + 1][:, x0 + 1] * fy * fx
        )
        img += g * scale
    img -= img.min()
    img *= 255.0 / max(img.max(), 1e-6)
    return img


def make_synthetic_sequence(
    rng: np.random.Generator,
    n_frames: int,
    h: int,
    w: int,
    max_disp: float = 8.0,
    drift_px: float = 0.25,
    cut_at: Optional[int] = None,
) -> List[Dict[str, np.ndarray]]:
    """Synthetic stereo VIDEO: one static textured scene whose disparity
    plane drifts by at most `drift_px` (full-res px) per frame — so the
    previous frame's flow is a near-perfect warm start for the next
    (video/session.py). `cut_at` injects a scene cut at that frame index:
    fresh texture AND the plane offset jumped to the far end of the disparity
    range, so both the photometric reset gate and the geometric prior break
    at once. Frames are item dicts ({"image1", "image2", "flow", "valid"},
    flow = -disp x-only) matching StereoDataset.get_item."""
    margin = int(np.ceil(max_disp)) + 1
    frames: List[Dict[str, np.ndarray]] = []
    xs = np.arange(w, dtype=np.float32)[None, :]
    ys = np.arange(h, dtype=np.float32)[:, None]
    rows = np.arange(h)[:, None]

    def new_scene(a_override: Optional[float] = None):
        base = _sequence_texture(rng, h, w + margin)
        a = a_override if a_override is not None else rng.uniform(1.0, max_disp - 1.0)
        bx = rng.uniform(-2.0, 2.0) / max(w, 1)
        cy = rng.uniform(-2.0, 2.0) / max(h, 1)
        return base, a, bx, cy

    base, a, bx, cy = new_scene()
    for t in range(n_frames):
        if cut_at is not None and t == cut_at and t > 0:
            # jump to the opposite disparity regime — unambiguous cut
            base, a, bx, cy = new_scene(
                a_override=(max_disp - 1.0) if a < max_disp / 2 else 1.0
            )
        elif t > 0:
            a = float(np.clip(a + rng.uniform(-drift_px, drift_px), 1.0, max_disp - 1.0))
        disp = np.clip(a + bx * xs + cy * ys, 0.5, max_disp).astype(np.float32)
        image1 = base[:, :w]
        coords = xs + disp
        x0 = np.floor(coords).astype(int)
        fx = (coords - x0)[..., None]
        x0 = np.clip(x0, 0, base.shape[1] - 2)
        image2 = base[rows, x0] * (1 - fx) + base[rows, x0 + 1] * fx
        frames.append(
            {
                "image1": np.ascontiguousarray(image1, np.float32),
                "image2": np.ascontiguousarray(image2, np.float32),
                "flow": np.ascontiguousarray(-disp[..., None], np.float32),
                "valid": np.ones((h, w), np.float32),
            }
        )
    return frames


def _first_image_path(entry) -> str:
    """First left-image path of an image_list entry — Gated's all-gated
    layout nests a per-slice list in the left slot."""
    first = entry[0]
    if isinstance(first, (list, tuple)):
        first = first[0]
    return str(first)


def _frame_order_key(path: str):
    """Sort key for frames within a sequence: the gated rig names frames
    `<index>_*.png`, so order by the leading integer when there is one,
    else lexically by basename."""
    stem = osp.basename(path)
    lead = stem.split("_")[0].split(".")[0]
    if lead.isdigit():
        return (0, int(lead), stem)
    return (1, 0, stem)


class SequenceDataset:
    """Ordered frame sequences for streaming/video stereo (video/ package).

    Two constructions:

    - `SequenceDataset.synthetic(...)`: precomputed drifting-disparity-plane
      sequences (make_synthetic_sequence) — the test/bench workload, with an
      optional scene cut for reset-gate coverage.
    - `SequenceDataset.group_frames(base)`: group an existing StereoDataset's
      frames into per-recording sequences by directory key (the Gated
      layouts — including all-gated nested frame lists — group by recording
      date), ordered by the leading numeric frame index. Frames then fetch
      through the base dataset's own pipeline, so the fork's modality axis
      rides along unchanged.

    Frames come back as StereoDataset item dicts; feed them to
    video.StreamSession in order.
    """

    def __init__(self, base: Optional[StereoDataset], groups: List[List]):
        self._base = base
        self._groups = groups

    @classmethod
    def synthetic(
        cls,
        rng: np.random.Generator,
        n_sequences: int = 1,
        n_frames: int = 8,
        h: int = 64,
        w: int = 96,
        **kwargs,
    ) -> "SequenceDataset":
        groups = [
            make_synthetic_sequence(rng, n_frames, h, w, **kwargs)
            for _ in range(n_sequences)
        ]
        return cls(None, groups)

    @classmethod
    def group_frames(
        cls,
        base: StereoDataset,
        key_fn: Optional[Callable[[str], str]] = None,
        min_frames: int = 2,
    ) -> "SequenceDataset":
        if key_fn is None:
            key_fn = osp.dirname
        by_key: Dict[str, List] = {}
        for i in range(len(base.image_list)):
            path = _first_image_path(base.image_list[i])
            by_key.setdefault(key_fn(path), []).append((_frame_order_key(path), i))
        groups = []
        for key in sorted(by_key):
            entries = sorted(by_key[key])
            if len(entries) >= min_frames:
                groups.append([i for _, i in entries])
        return cls(base, groups)

    def __len__(self) -> int:
        return len(self._groups)

    def num_frames(self, seq: int) -> int:
        return len(self._groups[seq])

    def get_frame(
        self, seq: int, t: int, rng: Optional[np.random.Generator] = None
    ) -> Dict[str, np.ndarray]:
        entry = self._groups[seq][t]
        if self._base is None:
            return entry
        if rng is None:
            rng = np.random.default_rng(0)
        return self._base.get_item(entry, rng)

    def get_sequence(
        self, seq: int, rng: Optional[np.random.Generator] = None
    ) -> List[Dict[str, np.ndarray]]:
        return [self.get_frame(seq, t, rng) for t in range(self.num_frames(seq))]


def build_training_dataset(config: TrainConfig, data_modality: str = "RGB") -> StereoDataset:
    """Assemble the mixed training dataset from config.train_datasets
    (reference fetch_dataloader, stereo_datasets.py:500-545, with the
    hardcoded-Gated and KITTI-kwarg bugs repaired)."""
    aug = config.augment
    gamma = tuple(aug.img_gamma) + (1.0, 1.0) if aug.img_gamma else (1, 1, 1, 1)

    def make_augmentor(sparse: bool) -> StereoAugmentor:
        kwargs = dict(
            crop_size=tuple(aug.crop_size),
            min_scale=aug.min_scale,
            max_scale=aug.max_scale,
            do_flip=aug.do_flip,
            sparse=sparse,
        )
        if not sparse:
            kwargs["yjitter"] = aug.yjitter
        if aug.saturation_range is not None:
            kwargs["saturation_range"] = tuple(aug.saturation_range)
        elif sparse:
            kwargs["saturation_range"] = (0.7, 1.3)
        kwargs["gamma"] = gamma
        return StereoAugmentor(**kwargs)

    dense_aug = make_augmentor(sparse=False)
    sparse_aug = make_augmentor(sparse=True)
    root = config.root_dataset or "datasets"

    total: Optional[StereoDataset] = None
    for name in config.train_datasets:
        if name == "gated":
            # Sparse augmentor: lidar GT is sparse. The gated modalities
            # bypass it inside Gated.get_item (ambient-light aug instead,
            # reference stereo_datasets.py:228); the RGB modality augments
            # and crops like any sparse dataset (reference :518 passes
            # aug_params unconditionally).
            ds = Gated(
                root,
                augmentor=sparse_aug,
                use_passive_gated=data_modality == MODALITY_PASSIVE_GATED,
                use_all_gated=data_modality == MODALITY_ALL_GATED,
                indexes_file=osp.join(root, "train_gatedstereo.txt")
                if osp.exists(osp.join(root, "train_gatedstereo.txt"))
                else None,
                camera=config.camera,
            )
        elif name.startswith("middlebury_"):
            ds = Middlebury(sparse_aug, split=name.replace("middlebury_", ""))
        elif name == "sceneflow":
            clean = SceneFlowDatasets(dense_aug, root=root, dstype="frames_cleanpass")
            final = SceneFlowDatasets(dense_aug, root=root, dstype="frames_finalpass")
            ds = (clean * 4) + (final * 4)
        elif "kitti" in name:
            ds = KITTI(sparse_aug, image_set="training")
        elif name == "sintel_stereo":
            ds = SintelStereo(sparse_aug) * 140
        elif name == "falling_things":
            ds = FallingThings(dense_aug) * 5
        elif name.startswith("tartan_air"):
            ds = TartanAir(dense_aug, keywords=tuple(name.split("_")[2:]))
        elif name == "eth3d":
            ds = ETH3D(sparse_aug)
        else:
            raise ValueError(f"unknown training dataset {name!r}")
        logger.info("Adding %d samples from %s", len(ds), name)
        total = ds if total is None else total + ds
    assert total is not None and len(total) > 0, "empty training dataset"
    logger.info("Training with %d image pairs", len(total))
    # --io_retries governs frame reads like checkpoint I/O (README
    # "Operations"); set on the composed dataset, whose load_raw serves
    # every sample.
    total.io_retries = config.io_retries
    return total
