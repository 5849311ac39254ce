"""The port's data pipeline against the JAX package's, on trees the tests
write (numpy only on the port's side; PIL and cv2 write the JAX side's
files where the JAX readers want them).

- `frame_io`: every reader on the same files is exact; the stdlib PNG
  codec equals PIL on 8- and 16-bit gray, gray+alpha, RGB and RGBA, and
  the native decoder.
- The augmentor: cv2's uint8 HSV round trip (the hue op) is matched on
  every uint8 triple in rows of any width, so `adjust_hue` is exact;
  `resize_linear` equals
  OpenCV's INTER_LINEAR to one float32 rounding (1.5e-5 on [0, 255]) with
  IPP off, and within 9.7e-4 (255 * 2**-18) of cv2's default IPP path on
  3-channel images; the tests hold images to 1e-3 and flow to 1e-4 px.
  Everything else the augmentor draws is exact, and `vary_ambient_light`
  is exact.
- Datasets: `build_training_dataset` on a SceneFlow tree and a KITTI tree,
  and `Gated` in its three modalities: the same lengths, relative paths
  and items (to the tolerances above).
- The loader: thread workers give JAX's batches over two epochs; a
  mid-epoch `state_dict` continues identically; a corrupt file is
  quarantined and resampled as in JAX; process workers give the threads'
  batches.
- `native_io` builds into a build directory (here a temporary one), never
  under `native/`.
- The device prefetcher hands over the loader's batches with the cursor of
  the batch the consumer holds (on the CPU here; on the card in the
  gpu-marked case).
"""

import os
import subprocess

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from raft_stereo_tpu.config import AugmentConfig as JaxAugmentConfig
from raft_stereo_tpu.config import TrainConfig as JaxTrainConfig
from raft_stereo_tpu.data import augment as jax_augment
from raft_stereo_tpu.data import datasets as jax_datasets
from raft_stereo_tpu.data import frame_io as jax_frame_io
from raft_stereo_tpu.data.loader import DataLoader as JaxDataLoader
from raft_stereo_tpu_torch.config import AugmentConfig, TrainConfig
from raft_stereo_tpu_torch.data import augment, datasets, frame_io, native_io, png, trees
from raft_stereo_tpu_torch.data.loader import DataLoader

IMG_TOL = 1e-3
FLOW_TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(paths, root):
    return [os.path.relpath(p, root) if isinstance(p, str) else _rel(p, root) for p in paths]


# --- readers and writers -----------------------------------------------------------

@pytest.mark.parametrize("shape,dtype,mode", [
    ((23, 31), np.uint8, None), ((23, 31, 3), np.uint8, None), ((23, 31, 4), np.uint8, None),
    ((23, 31, 2), np.uint8, "LA"), ((23, 31), np.uint16, None), ((23, 31, 3), np.uint16, "cv2"),
    ((23, 31, 4), np.uint16, "cv2"),
], ids=["gray8", "rgb8", "rgba8", "gray_alpha8", "gray16", "rgb16", "rgba16"])
def test_png_codec_equals_pil(tmp_path, shape, dtype, mode):
    """PIL-written files (adaptive filters: Sub, Up, Average, Paeth) decode
    to PIL's arrays; 16-bit multichannel files (written by cv2) to PIL's
    high bytes, and with full_depth to cv2's samples; the codec's own files
    read back exactly through PIL and the native decoder."""
    rng = np.random.default_rng(sum(shape))
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    smooth = (np.sin(xx / 5.0) + np.cos(yy / 3.0) + 2) / 4  # gives Paeth and Average rows
    hi = 65535 if dtype == np.uint16 else 255
    a = (smooth.reshape(smooth.shape + (1,) * (len(shape) - 2)) * hi * 0.9
         + rng.integers(0, hi // 10, shape)).astype(dtype)
    path = str(tmp_path / "x.png")
    if mode == "cv2":
        cv2.imwrite(path, a[..., [2, 1, 0, 3][:shape[2]]])
        np.testing.assert_array_equal(png.read_png(path, full_depth=True), a)
    else:
        (Image.fromarray(a, mode) if mode else Image.fromarray(a)).save(path)
    want = np.asarray(Image.open(path))
    got = png.read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(frame_io.read_image(path), want)
    if mode != "cv2":
        out = str(tmp_path / "y.png")
        png.write_png(out, a)
        np.testing.assert_array_equal(np.asarray(Image.open(out)), want)
        if native_io.available():
            np.testing.assert_array_equal(native_io.read_png(out), a)


def test_png_codec_refuses_other_formats(tmp_path):
    path = str(tmp_path / "p.png")
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(path)
    with pytest.raises(png.PNGFormatError, match="color type 3"):
        png.read_png(path)
    (tmp_path / "q.png").write_bytes(b"garbage")
    with pytest.raises(png.PNGFormatError, match="not a PNG"):
        png.read_png(str(tmp_path / "q.png"))


def test_readers_match_jax(tmp_path):
    """Every reader of the port on files written by the JAX side's writers
    (PIL, cv2, numpy) returns exactly the JAX reader's arrays."""
    rng = np.random.default_rng(3)
    d = tmp_path
    disp = rng.uniform(0.5, 60, (20, 28)).astype(np.float32)
    jax_frame_io.write_pfm(str(d / "a.pfm"), disp)
    flo = rng.normal(size=(20, 28, 2)).astype(np.float32)
    with open(d / "a.flo", "wb") as f:
        np.float32(202021.25).tofile(f)
        np.array([28, 20], np.int32).tofile(f)
        flo.tofile(f)
    Image.fromarray((disp * 256).astype(np.uint16)).save(d / "kitti.png")
    jax_frame_io.write_flow_kitti(str(d / "flow_kitti.png"), rng.uniform(-50, 50, (20, 28, 2)).astype(np.float32))
    os.makedirs(d / "disparities")
    os.makedirs(d / "occlusions")
    Image.fromarray(rng.integers(0, 256, (20, 28, 3)).astype(np.uint8)).save(d / "disparities" / "f.png")
    Image.fromarray((rng.uniform(0, 1, (20, 28)) > 0.8).astype(np.uint8) * 255).save(d / "occlusions" / "f.png")
    Image.fromarray(rng.integers(100, 4000, (20, 28)).astype(np.uint16)).save(d / "ft.depth.png")
    with open(d / "_camera_settings.json", "w") as f:
        f.write('{"camera_settings": [{"intrinsic_settings": {"fx": 768.2}}]}')
    np.save(d / "ta_depth.npy", rng.uniform(1, 50, (20, 28)).astype(np.float32))
    jax_frame_io.write_pfm(str(d / "disp0GT.pfm"), disp)
    Image.fromarray(((rng.uniform(0, 1, (20, 28)) > 0.3) * 255).astype(np.uint8)).save(d / "mask0nocc.png")
    jax_frame_io.write_pfm(str(d / "disp0.pfm"), disp * 30)
    depth = rng.uniform(0, 80, (20, 28)).astype(np.float32)
    depth[::3] = 0
    np.savez(d / "lidar.npz", depth)
    cases = [
        ("read_pfm", "a.pfm"), ("read_flo", "a.flo"), ("read_disp_kitti", "kitti.png"),
        ("read_flow_kitti", "flow_kitti.png"), ("read_disp_sintel", "disparities/f.png"),
        ("read_disp_falling_things", "ft.depth.png"), ("read_disp_tartanair", "ta_depth.npy"),
        ("read_disp_middlebury", "disp0GT.pfm"), ("read_disp_middlebury", "disp0.pfm"),
        ("read_disp_gated_lidar", "lidar.npz"), ("read_gen", "a.pfm"), ("read_gen", "kitti.png"),
        ("read_gen", "a.flo"), ("read_gen", "ta_depth.npy"),
    ]
    for name, rel in cases:
        want = getattr(jax_frame_io, name)(str(d / rel))
        got = getattr(frame_io, name)(str(d / rel))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert np.asarray(g).dtype == np.asarray(w).dtype, (name, rel)
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {rel}")
    # The port's writers, read by the JAX readers.
    frame_io.write_pfm(str(d / "b.pfm"), disp)
    np.testing.assert_array_equal(jax_frame_io.read_pfm(str(d / "b.pfm")), disp)
    uv = rng.uniform(-50, 50, (20, 28, 2)).astype(np.float32)
    frame_io.write_flow_kitti(str(d / "b_flow.png"), uv)
    for g, w in zip(frame_io.read_flow_kitti(str(d / "b_flow.png")), jax_frame_io.read_flow_kitti(str(d / "b_flow.png"))):
        np.testing.assert_array_equal(g, w)


# --- augmentation -----------------------------------------------------------------

def test_hue_and_resize_match_cv2():
    """adjust_hue equals the JAX op (cv2's HSV round trip) exactly; the
    resize is within the stated tolerances of cv2.resize (IPP on, the
    default)."""
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (37, 53, 3)).astype(np.float32)
    for off in (-0.159, -0.05, 0.0, 0.07, 0.159):
        np.testing.assert_array_equal(augment.adjust_hue(img, off), jax_augment.adjust_hue(img, off))
    flow = rng.normal(0, 20, (37, 53, 2)).astype(np.float32)
    gaps = []
    for fx, fy in ((1.31, 1.07), (0.74, 0.93), (1.0, 1.0), (1.9, 1.22), (0.51, 0.5)):
        for x, tol in ((img, IMG_TOL), (flow, FLOW_TOL)):
            want = cv2.resize(x, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
            got = augment.resize_linear(x, fx, fy)
            assert got.shape == want.shape and got.dtype == want.dtype
            gaps.append(float(np.abs(got - want).max()))
            assert gaps[-1] <= tol, (fx, fy, gaps[-1])
    print(f"resize gap vs cv2: images {max(gaps[0::2]):.3e}, flow {max(gaps[1::2]):.3e}")


def _pair(rng, h=60, w=88, sparse=False):
    img1 = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    img2 = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    flow = np.stack([-rng.uniform(0, 20, (h, w)), np.zeros((h, w))], -1).astype(np.float32)
    valid = (rng.uniform(0, 1, (h, w)) > 0.3).astype(np.float32)
    return img1, img2, flow, valid


@pytest.mark.parametrize("kw", [
    dict(min_scale=-0.2, max_scale=0.4, saturation_range=(0.0, 1.4), yjitter=True),
    dict(min_scale=-0.2, max_scale=0.4, do_flip="hf", gamma=(0.8, 1.2, 0.9, 1.1)),
    dict(min_scale=0.0, max_scale=0.0, do_flip="v", sparse=True, saturation_range=(0.7, 1.3)),
    dict(min_scale=-0.2, max_scale=0.4, sparse=True),
], ids=["dense", "dense-flip-gamma", "sparse-unit-scale", "sparse-scaled"])
def test_augmentor_matches_jax(kw):
    """For one seed per case, ten items through both augmentors: the same
    shapes, images within IMG_TOL and flow within FLOW_TOL (exact where no
    resize ran), the sparse valid masks exact, and both generators left in
    the same state (the same draws in the same order)."""
    sparse = kw.get("sparse", False)
    gaps = [0.0, 0.0]
    for k in range(10):
        rng_j, rng_p = np.random.default_rng((7, k)), np.random.default_rng((7, k))
        img1, img2, flow, valid = _pair(np.random.default_rng((8, k)))
        args = (img1, img2, flow, valid) if sparse else (img1, img2, flow)
        want = jax_augment.StereoAugmentor(crop_size=(40, 56), **kw)(rng_j, *args)
        got = augment.StereoAugmentor(crop_size=(40, 56), **kw)(rng_p, *args)
        assert rng_j.random() == rng_p.random()
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape and g.dtype == w.dtype
            tol = FLOW_TOL if i == 2 else (0.0 if i == 3 else IMG_TOL)
            gap = float(np.abs(g.astype(np.float64) - w).max())
            assert gap <= tol, (k, i, gap)
            if i < 3:
                gaps[i == 2] = max(gaps[i == 2], gap)
    if kw.get("min_scale") == kw.get("max_scale") == 0.0:
        assert gaps == [0.0, 0.0]  # no resize ran: exact
    print(f"{kw}: image gap {gaps[0]:.3e}, flow gap {gaps[1]:.3e}")


def test_vary_ambient_light_exact():
    img = np.random.default_rng(2).uniform(0, 255, (24, 32, 5)).astype(np.float32)
    for k, date in enumerate(("2024-01-01_10-00-00", "2024-01-01_22-30-00", "2023-05-05_08-00-00")):
        for is_left in (True, False):
            for w in (-0.4, 0.3):
                want = jax_augment.vary_ambient_light(np.random.default_rng(k), img, w, is_left, date)
                got = augment.vary_ambient_light(np.random.default_rng(k), img, w, is_left, date)
                np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        augment.vary_ambient_light(np.random.default_rng(0), img, 0.1, True, "2024-01-01_33-00-00")


# --- datasets -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    rng = np.random.default_rng(11)
    trees.write_sceneflow(str(root / "datasets"), rng, 4, 2, h=60, w=88, max_disp=8.0)
    trees.write_kitti(str(root / "datasets" / "KITTI"), rng, 8, h=44, w=72, max_disp=8.0)
    trees.write_gated(str(root / "gated"), rng, ["2024-01-02_21-00-00"], 2, modalities=("RGB", "gated"),
                      max_disp=8.0, min_disp=4.0, index_name="train_gatedstereo.txt")
    return root


def _items_match(got, want, k):
    for key in ("image1", "image2", "flow", "valid"):
        g, w = got[key], want[key]
        assert g.shape == w.shape and g.dtype == w.dtype, (k, key)
        tol = {"image1": IMG_TOL, "image2": IMG_TOL, "flow": FLOW_TOL, "valid": 0.0}[key]
        assert float(np.abs(g - w).max()) <= tol, (k, key)


@pytest.mark.parametrize("names", [("sceneflow",), ("kitti",)])
def test_build_training_dataset_matches_jax(tree, monkeypatch, names):
    monkeypatch.chdir(tree)  # KITTI reads datasets/KITTI, as in the reference
    aug = dict(crop_size=(40, 56), min_scale=-0.2, max_scale=0.4, saturation_range=(0.0, 1.4))
    want = jax_datasets.build_training_dataset(
        JaxTrainConfig(augment=JaxAugmentConfig(**aug), train_datasets=names, root_dataset="datasets"))
    got = datasets.build_training_dataset(
        TrainConfig(augment=AugmentConfig(**aug), train_datasets=names, root_dataset="datasets"))
    assert len(got) == len(want) > 0
    assert got.image_list == want.image_list and got.disparity_list == want.disparity_list
    assert got.io_retries == want.io_retries
    for k in range(0, len(got), max(1, len(got) // 6)):
        _items_match(got.get_item(k, np.random.default_rng((1, k))), want.get_item(k, np.random.default_rng((1, k))), k)


@pytest.mark.parametrize("modality", ["RGB", "1 Passive Gated", "All Gated"])
def test_gated_matches_jax(tree, modality):
    root = str(tree / "gated")
    kw = dict(use_passive_gated=modality == "1 Passive Gated", use_all_gated=modality == "All Gated",
              indexes_file=os.path.join(root, "train_gatedstereo.txt"))
    jaug = jax_augment.StereoAugmentor(crop_size=(352, 64), min_scale=0.0, max_scale=0.0, sparse=True)
    paug = augment.StereoAugmentor(crop_size=(352, 64), min_scale=0.0, max_scale=0.0, sparse=True)
    want = jax_datasets.Gated(root, augmentor=jaug, **kw)
    got = datasets.Gated(root, augmentor=paug, **kw)
    assert len(got) == len(want) == 2
    assert _rel(got.image_list, root) == _rel(want.image_list, root)
    for k in range(len(got)):
        g = got.get_item(k, np.random.default_rng(k))
        w = want.get_item(k, np.random.default_rng(k))
        _items_match(g, w, k)
        if modality != "RGB":
            assert g["image1"].shape[0] == 704  # 720 rows cropped to 704


# --- the loader ----------------------------------------------------------------------

def _kitti_pair(tree, monkeypatch):
    monkeypatch.chdir(tree)
    aug = dict(crop_size=(40, 56), min_scale=0.0, max_scale=0.0)
    want = jax_datasets.build_training_dataset(
        JaxTrainConfig(augment=JaxAugmentConfig(**aug), train_datasets=("kitti",)))
    got = datasets.build_training_dataset(TrainConfig(augment=AugmentConfig(**aug), train_datasets=("kitti",)))
    return got, want


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for key in ("image1", "image2", "flow", "valid"):
            np.testing.assert_array_equal(x[key], y[key])


def test_loader_matches_jax_and_resumes(tree, monkeypatch):
    """Two epochs at batch 3 (drop_last: 2 batches each) equal JAX's,
    exactly (KITTI's sparse path at unit scale runs no resize); a state
    taken after the first batch of epoch 1 continues identically in a
    fresh loader."""
    got_ds, want_ds = _kitti_pair(tree, monkeypatch)
    port = DataLoader(got_ds, 3, seed=5, num_workers=2)
    jax = JaxDataLoader(want_ds, 3, seed=5, num_workers=2)
    try:
        epochs = [(list(port), list(jax)) for _ in range(2)]
        for p, j in epochs:
            _same_batches(p, j)
        it = iter(port)
        next(it)
        state = port.state_dict()
        rest = list(it)
        assert state["epoch"] == 2 and state["batch_cursor"] == 1
        fresh = DataLoader(got_ds, 3, seed=5, num_workers=1)
        fresh.load_state_dict(state)
        _same_batches(list(fresh), rest)
        fresh.close()
    finally:
        port.close()
        jax.close()


def test_corrupt_sample_quarantined_as_in_jax(tree, monkeypatch, tmp_path):
    """A truncated image is retried, quarantined and substituted by the
    same resample in both loaders; the quarantine state matches."""
    got_ds, want_ds = _kitti_pair(tree, monkeypatch)
    bad = got_ds.image_list[3][0]
    broken = str(tmp_path / "broken.png")
    with open(bad, "rb") as f:
        data = f.read()
    with open(broken, "wb") as f:
        f.write(data[: len(data) // 2])
    for ds in (got_ds, want_ds):
        ds.image_list = [list(p) for p in ds.image_list]
        ds.image_list[3][0] = broken
    port = DataLoader(got_ds, 2, seed=3, num_workers=1, sample_policy="quarantine", failure_budget=0.5)
    jax = JaxDataLoader(want_ds, 2, seed=3, num_workers=1, sample_policy="quarantine", failure_budget=0.5)
    try:
        _same_batches(list(port), list(jax))
        assert port.quarantine.state_dict() == jax.quarantine.state_dict()
        assert port.quarantine.indices == {3}
    finally:
        port.close()
        jax.close()


def test_process_workers_match_threads(tree, monkeypatch):
    got_ds, _ = _kitti_pair(tree, monkeypatch)
    threads = DataLoader(got_ds, 2, seed=4, num_workers=2, worker_type="thread")
    procs = DataLoader(got_ds, 2, seed=4, num_workers=2, worker_type="process")
    try:
        _same_batches(list(procs), list(threads))
    finally:
        threads.close()
        procs.close()


def test_native_io_builds_outside_native(tmp_path, monkeypatch):
    """The build writes its library (compiled to a unique temporary name,
    renamed into place) into the build directory and nothing under
    native/; without the toolchain the module reports itself unavailable."""
    native_dir = os.path.join(REPO, "native")
    before = sorted(os.listdir(native_dir))
    assert os.path.dirname(native_io.library_path()) == os.path.join(REPO, "raft_stereo_tpu_torch", "_build")
    monkeypatch.setattr(native_io, "BUILD_DIR", str(tmp_path / "build"))
    so = str(tmp_path / "build" / "libraft_io-test.so")
    try:
        native_io._build(so)
        built = True
    except (OSError, subprocess.SubprocessError):
        built = False
    assert sorted(os.listdir(native_dir)) == before
    if built:
        assert os.listdir(tmp_path / "build") == ["libraft_io-test.so"]
    monkeypatch.setattr(native_io, "_lib_cache", None)
    monkeypatch.setattr(native_io, "_lib_failed", False)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native_io, "library_path", lambda: str(tmp_path / "missing" / "lib.so"))
    assert native_io.available() is False and native_io.unavailable_reason
    assert sorted(os.listdir(native_dir)) == before


# --- the device prefetcher ------------------------------------------------------------

def _prefetch_check(tree, monkeypatch, device):
    """The prefetcher hands `device` the loader's batches, value for value,
    and its state_dict is the cursor of the batch the consumer holds."""
    from raft_stereo_tpu_torch.data.prefetch import DevicePrefetcher

    got_ds, _ = _kitti_pair(tree, monkeypatch)
    plain = DataLoader(got_ds, 2, seed=6, num_workers=1)
    wrapped = DataLoader(got_ds, 2, seed=6, num_workers=1)
    pf = DevicePrefetcher(wrapped, device)
    try:
        want, want_states = [], []
        for b in plain:  # the unwrapped loader's cursor while its consumer holds each batch
            want.append(b)
            want_states.append(plain.state_dict())
        states = []
        for i, b in enumerate(pf):
            assert set(b) == {"image1", "image2", "flow", "valid"}
            for key, t in b.items():
                assert t.device.type == torch.device(device).type and t.dtype == torch.float32
                np.testing.assert_array_equal(t.cpu().numpy(), want[i][key])
            states.append(pf.state_dict())
        assert len(states) == len(want) > 1 and states == want_states
        assert pf.quarantine is wrapped.quarantine and len(pf) == len(plain)
        assert pf.stats()["prefetch_depth_watermark"] <= 1
    finally:
        plain.close()
        wrapped.close()


def test_prefetcher_matches_loader_on_cpu(tree, monkeypatch):
    _prefetch_check(tree, monkeypatch, "cpu")


@pytest.mark.gpu
def test_prefetcher_matches_loader_on_cuda(tree, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the side-stream copy runs on the card")
    _prefetch_check(tree, monkeypatch, "cuda")
