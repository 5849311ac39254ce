"""Weight bridge from the JAX package's variables into the port.

`load_jax_variables(module, variables)` takes a flax `{"params",
"batch_stats"}` tree as nested dicts of numpy arrays and copies every leaf
into the matching tensor of a port module (the whole `RAFTStereo` or any
submodule the JAX package also has, such as a `ResidualBlock`). Names map
one to one, with three rules:

- a conv `<path>.weight` / `.bias` is flax `<path>/Conv_0/kernel` / `bias`,
  and the kernel goes from HWIO to OIHW;
- a norm `<path>.norm{k}` is flax `<path>/<Norm>_{k-1}` (flax numbers the
  norms of a scope in call order): `weight`/`bias` are the params
  `scale`/`bias`, `running_mean`/`running_var` the batch_stats `mean`/`var`;
- a module may remap a child's scope through its `flax_scopes` attribute
  (RAFTStereo's update block lives under flax "iteration/update_block").

The bridge raises on any JAX leaf left unused, any port tensor left unset,
and any shape that disagrees.

`load_reference_checkpoint(model, path)` restores the reference's `.pth`
(`--restore_ckpt`): `convert_state_dict` and its helpers, a copy of the JAX
package's (`raft_stereo_tpu/utils/checkpoints.py`; numpy only), map the
torch state dict onto the flax variables tree, which the bridge then loads.
The JAX package's own checkpoints are orbax directories; reading them needs
the JAX stack, so the port refuses them.

The training checkpoints of the port (train/trainer.py) keep the JAX
package's integrity protocol, whose functions are copied here unchanged
(`write_manifest` ... `find_latest_valid_step`), around the port's own step
format: a step directory `<checkpoint_dir>/<name>/<step>/` holds

- `model.pth`: the weights in the reference's layout
  (`export_reference_state_dict`), so `evaluate --restore_ckpt`, `serve
  --restore_ckpt` and POST /reload read it as they read any reference
  `.pth`;
- `optimizer.pt`: the AdamW moments and count and the trainer's step;
- `run_state.json`: the host-side run state (loader cursor, quarantine set,
  non-finite counters, the numpy and torch RNG states);
- `MANIFEST.json`: every other file's size and CRC32, written last by an
  atomic rename. The rename is the commit point: a step without a
  manifest that verifies is torn, and auto-resume walks past it.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple
import zlib

import numpy as np
import torch
from torch import nn

from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models.layers import FrozenBatchNorm, GroupNorm
from raft_stereo_tpu_torch.parallel.sharding import is_sharded, shard_as

_NORM_CLASS = {FrozenBatchNorm: "FrozenBatchNorm", GroupNorm: "GroupNorm"}
_NORM_LEAF = {
    "weight": ("params", "scale"),
    "bias": ("params", "bias"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, (*prefix, str(k))))
        else:
            out[(*prefix, str(k))] = np.asarray(v)
    return out


def _flax_key(root: nn.Module, name: str) -> Tuple[Tuple[str, ...], bool]:
    """(("params"|"batch_stats", *flax path), is_conv_kernel) for a port
    parameter or buffer name."""
    *mods, leaf = name.split(".")
    module = root.get_submodule(".".join(mods))
    scopes = getattr(root, "flax_scopes", {})
    path = list(scopes.get(mods[0], (mods[0],))) + mods[1:] if mods else []
    if isinstance(module, nn.Conv2d):
        return ("params", *path, "Conv_0", "kernel" if leaf == "weight" else leaf), leaf == "weight"
    for cls, flax_name in _NORM_CLASS.items():
        if isinstance(module, cls):
            index = int(path[-1][len("norm"):]) - 1
            collection, flax_leaf = _NORM_LEAF[leaf]
            return (collection, *path[:-1], f"{flax_name}_{index}", flax_leaf), False
    raise KeyError(f"no JAX counterpart for port tensor {name!r} ({type(module).__name__})")


@torch.no_grad()
def load_jax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Copy a flax variables tree (nested dicts of numpy arrays) into
    `module` in place; see the module docstring for the name rules."""
    leaves = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})).items():
            leaves[(collection, *path)] = value
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections {sorted(unknown)}")
    for name, tensor in module.state_dict(keep_vars=True).items():
        key, is_kernel = _flax_key(module, name)
        if key not in leaves:
            raise KeyError(f"port tensor {name!r} has no JAX leaf {'/'.join(key)}")
        value = leaves.pop(key)
        if is_kernel:
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(
                f"shape mismatch for {name!r}: JAX {tuple(value.shape)} vs port {tuple(tensor.shape)}"
            )
        value = torch.from_numpy(np.array(value, dtype=np.float32))
        if is_sharded(tensor):  # fsdp: this rank's piece
            value, tensor = shard_as(value, tensor).to_local(), tensor.to_local()
        tensor.copy_(value)
    if leaves:
        raise KeyError(f"JAX leaves left unused: {sorted('/'.join(k) for k in leaves)}")
    return module


# --- the reference's `.pth` -> flax variables (a copy of the JAX package's) ---
#
# Layout conversions: conv weights OIHW -> HWIO; BatchNorm running stats ->
# the `batch_stats` collection; the disparity-native slices: the motion
# encoder's flow conv keeps only its x-input channel, the flow head only its
# x-output row (both exact: flow-y is identically zero in the reference).


def _conv(sd: Mapping[str, np.ndarray], key: str) -> Dict[str, np.ndarray]:
    out = {"kernel": sd[f"{key}.weight"].transpose(2, 3, 1, 0)}
    if f"{key}.bias" in sd:
        out["bias"] = sd[f"{key}.bias"]
    return out


def _norm_params(sd, key):
    return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}


def _norm_stats(sd, key):
    return {"mean": sd[f"{key}.running_mean"], "var": sd[f"{key}.running_var"]}


class _TreeBuilder:
    """Accumulates params and batch_stats trees addressed by path tuples."""
    def __init__(self):
        self.params: Dict[str, Any] = {}
        self.stats: Dict[str, Any] = {}

    def _set(self, tree, path, value):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value

    def conv(self, sd, tkey, *path):
        # Conv wrapper nests one flax nn.Conv named Conv_0.
        self._set(self.params, (*path, "Conv_0"), _conv(sd, tkey))

    def norm(self, sd, tkey, *path, kind="batch"):
        if kind == "batch":
            self._set(self.params, path, _norm_params(sd, tkey))
            self._set(self.stats, path, _norm_stats(sd, tkey))
        elif kind == "group":
            self._set(self.params, path, _norm_params(sd, tkey))
        # instance norm: parameter-free


def _residual_block(b: _TreeBuilder, sd, tkey: str, path: Tuple[str, ...], norm: str, has_down: bool):
    """ResidualBlock param mapping (models/layers.py ↔ reference
    core/extractor.py:6-60). Flax auto-names the norm layers in call order:
    norm1 → <Norm>_0, norm2 → <Norm>_1, downsample norm → <Norm>_2."""
    norm_cls = {"batch": "FrozenBatchNorm", "instance": "InstanceNorm", "group": "GroupNorm"}[norm]
    b.conv(sd, f"{tkey}.conv1", *path, "conv1")
    b.conv(sd, f"{tkey}.conv2", *path, "conv2")
    if norm in ("batch", "group"):
        b.norm(sd, f"{tkey}.norm1", *path, f"{norm_cls}_0", kind=norm)
        b.norm(sd, f"{tkey}.norm2", *path, f"{norm_cls}_1", kind=norm)
    if has_down:
        b.conv(sd, f"{tkey}.downsample.0", *path, "downsample")
        if norm in ("batch", "group"):
            b.norm(sd, f"{tkey}.downsample.1", *path, f"{norm_cls}_2", kind=norm)


def _trunk(b: _TreeBuilder, sd, tprefix: str, path: Tuple[str, ...], norm: str, downsample: int):
    """EncoderTrunk ↔ reference stem+layer1-3 (core/extractor.py:144-150,
    168-174). Skip-path 1x1 exists iff stride>1 or channel change."""
    b.conv(sd, f"{tprefix}conv1", *path, "conv1")
    if norm == "batch":
        b.norm(sd, f"{tprefix}norm1", *path, "FrozenBatchNorm_0", kind="batch")
    elif norm == "group":
        b.norm(sd, f"{tprefix}norm1", *path, "GroupNorm_0", kind="group")
    _residual_block(b, sd, f"{tprefix}layer1.0", (*path, "layer1_0"), norm, has_down=False)
    _residual_block(b, sd, f"{tprefix}layer1.1", (*path, "layer1_1"), norm, has_down=False)
    _residual_block(b, sd, f"{tprefix}layer2.0", (*path, "layer2_0"), norm, has_down=True)  # 64→96
    _residual_block(b, sd, f"{tprefix}layer2.1", (*path, "layer2_1"), norm, has_down=False)
    _residual_block(b, sd, f"{tprefix}layer3.0", (*path, "layer3_0"), norm, has_down=True)  # 96→128
    _residual_block(b, sd, f"{tprefix}layer3.1", (*path, "layer3_1"), norm, has_down=False)


def convert_state_dict(
    sd: Mapping[str, np.ndarray], config: RAFTStereoConfig
) -> Dict[str, Any]:
    """torch state_dict → flax variables {'params': ..., 'batch_stats': ...}
    for `RAFTStereo(config)`. Exact up to the documented disparity-native
    weight slices."""
    b = _TreeBuilder()

    # --- context encoder (cnet, batch norm) ---
    _trunk(b, sd, "cnet.", ("cnet", "trunk"), "batch", config.n_downsample)
    n_heads = 2  # (hidden, context) — reference output_dim=[hidden_dims, context_dims]
    for j in range(n_heads):
        _residual_block(b, sd, f"cnet.outputs08.{j}.0", ("cnet", f"res08_{j}"), "batch", has_down=False)
        b.conv(sd, f"cnet.outputs08.{j}.1", "cnet", f"out08_{j}")
        if config.n_gru_layers >= 2:
            _residual_block(b, sd, f"cnet.outputs16.{j}.0", ("cnet", f"res16_{j}"), "batch", has_down=False)
            b.conv(sd, f"cnet.outputs16.{j}.1", "cnet", f"out16_{j}")
        if config.n_gru_layers >= 3:
            b.conv(sd, f"cnet.outputs32.{j}", "cnet", f"out32_{j}")
    if config.n_gru_layers >= 2:
        _residual_block(b, sd, "cnet.layer4.0", ("cnet", "layer4_0"), "batch", has_down=True)
        _residual_block(b, sd, "cnet.layer4.1", ("cnet", "layer4_1"), "batch", has_down=False)
    if config.n_gru_layers >= 3:
        _residual_block(b, sd, "cnet.layer5.0", ("cnet", "layer5_0"), "batch", has_down=True)
        _residual_block(b, sd, "cnet.layer5.1", ("cnet", "layer5_1"), "batch", has_down=False)

    # --- feature encoder ---
    if config.shared_backbone:
        _residual_block(b, sd, "conv2.0", ("conv2_res",), "instance", has_down=False)
        b.conv(sd, "conv2.1", "conv2_out")
    else:
        _trunk(b, sd, "fnet.", ("fnet", "trunk"), "instance", config.n_downsample)
        b.conv(sd, "fnet.conv2", "fnet", "conv2")

    # --- context zqr convs ---
    for i in range(config.n_gru_layers):
        b.conv(sd, f"context_zqr_convs.{i}", f"context_zqr_conv{i}")

    # --- update block (under the scanned iteration body) ---
    ub = ("iteration", "update_block")
    gru_names = ["gru08"] + (["gru16"] if config.n_gru_layers >= 2 else []) + (
        ["gru32"] if config.n_gru_layers >= 3 else []
    )
    for gname in gru_names:
        for gate in ("convz", "convr", "convq"):
            b.conv(sd, f"update_block.{gname}.{gate}", *ub, gname, gate)

    enc = (*ub, "encoder")
    b.conv(sd, "update_block.encoder.convc1", *enc, "convc1")
    b.conv(sd, "update_block.encoder.convc2", *enc, "convc2")
    # Disparity-native slice: flow conv keeps x-input channel only (exact —
    # flow-y ≡ 0 in the reference).
    w = sd["update_block.encoder.convf1.weight"]  # (64, 2, 7, 7)
    b._set(
        b.params,
        (*enc, "convf1", "Conv_0"),
        {"kernel": w[:, :1].transpose(2, 3, 1, 0), "bias": sd["update_block.encoder.convf1.bias"]},
    )
    b.conv(sd, "update_block.encoder.convf2", *enc, "convf2")
    b.conv(sd, "update_block.encoder.conv", *enc, "conv")

    fh = (*ub, "flow_head")
    b.conv(sd, "update_block.flow_head.conv1", *fh, "conv1")
    # Disparity-native slice: keep x-output row only (exact — y overwritten
    # with 0 in the reference, core/raft_stereo.py:120).
    w = sd["update_block.flow_head.conv2.weight"]  # (2, 256, 3, 3)
    b._set(
        b.params,
        (*fh, "conv2", "Conv_0"),
        {
            "kernel": w[:1].transpose(2, 3, 1, 0),
            "bias": sd["update_block.flow_head.conv2.bias"][:1],
        },
    )

    # Mask head lives outside the scanned iteration body (models/update.py
    # UpsampleMaskHead) — same weights, applied post-scan.
    b.conv(sd, "update_block.mask.0", "mask_head", "mask_conv1")
    b.conv(sd, "update_block.mask.2", "mask_head", "mask_conv2")

    return {"params": b.params, "batch_stats": b.stats}



def load_reference_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a reference `.pth` (or the `model.pth` of a training step
    directory) into {key: ndarray}, stripping the DataParallel `module.`
    prefix."""
    if os.path.isdir(path) and os.path.isfile(os.path.join(path, MODEL_NAME)):
        path = os.path.join(path, MODEL_NAME)  # a training step directory
    if os.path.isdir(path):
        raise ValueError(
            f"{path!r} is a directory: orbax checkpoints of the JAX package need the JAX stack to "
            "read; the port restores the reference's .pth state dicts only"
        )
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k[len("module."):] if k.startswith("module.") else k: v.numpy() for k, v in state.items()}


def load_reference_checkpoint(model: nn.Module, path: str) -> nn.Module:
    """Restore a reference `.pth` into a port `RAFTStereo` in place:
    `convert_state_dict`, then `load_jax_variables`."""
    return load_jax_variables(model, convert_state_dict(load_reference_state_dict(path), model.config))


def port_state_dict_from_reference(sd: Mapping[str, np.ndarray], config: RAFTStereoConfig) -> Dict[str, torch.Tensor]:
    """A reference state dict as the port's `RAFTStereo(config)` state dict
    (CPU tensors), without touching any served model: the hot-swap
    candidate of `StereoService.reload_checkpoint`. Raises KeyError or
    ValueError where the reference's keys or shapes do not fit `config`."""
    from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo

    with torch.device("meta"):
        model = RAFTStereo(config)
    model = model.to_empty(device="cpu")
    load_jax_variables(model, convert_state_dict(sd, config))
    return model.state_dict()


def export_reference_state_dict(model: nn.Module, state: Optional[Mapping[str, torch.Tensor]] = None
                                ) -> Dict[str, torch.Tensor]:
    """A port `RAFTStereo`'s weights as the reference's state dict, the
    layout `load_reference_state_dict` reads (`torch.save` it as a .pth):
    the inverse of `convert_state_dict`. The flow-y input channel of the
    motion encoder's flow conv and the flow-y output row of the flow head,
    which the port drops, are written as zeros (flow-y is identically zero
    in the reference). Each reference key is found by running the
    converter once on a probe whose every tensor holds its own key's index.
    `state` stands in for `model.state_dict()` (the trainer passes whole
    host copies of a sharded model's tensors)."""
    keys = []

    class _Probe(dict):
        def __getitem__(self, key):
            if key not in keys:
                keys.append(key)
            return np.full((2, 2, 2, 2), float(keys.index(key)), np.float32)

        def __contains__(self, key):
            return True

    origin = {path: keys[int(v.flat[0])] for path, v in _flatten(convert_state_dict(_Probe(), model.config)).items()}
    sd = {}
    for name, tensor in (model.state_dict() if state is None else state).items():
        key = origin[_flax_key(model, name)[0]]
        value = tensor.detach().float().cpu()
        if key == "update_block.encoder.convf1.weight":
            value = torch.cat([value, torch.zeros_like(value)], dim=1)
        elif key.startswith("update_block.flow_head.conv2."):
            value = torch.cat([value, torch.zeros_like(value)], dim=0)
        sd[key] = value.contiguous()
    return sd


# --- integrity manifest (a copy of the JAX package's protocol) -----------

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_VERSION = 1
RUN_STATE_NAME = "run_state.json"
CORRUPT_DIR_MARKER = ".corrupt-"

# Multi-host: process 0's bundle is RUN_STATE_NAME (manifest-covered, the
# durable core); every other process writes a best-effort per-host bundle
# `run_state.p<i>.json` carrying ITS host-local state (quarantine indices
# are per-shard — adopting process 0's would both lose this host's known
# corrupt samples and claim ones it never saw). Peer bundles are EXCLUDED
# from the manifest: they are written concurrently with process 0's commit
# and a barrier here would add a collective to every save; a torn/missing
# peer bundle degrades to the shared bundle at restore.
_PEER_RUN_STATE_RE = re.compile(r"run_state\.p\d+\.json")


def run_state_name(process_index: int = 0) -> str:
    return RUN_STATE_NAME if process_index == 0 else f"run_state.p{process_index}.json"


def _crc32_file(path: str, chunk: int = 1 << 20) -> str:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return f"{crc & 0xFFFFFFFF:08x}"


def _manifest_files(step_dir: str):
    """Yield (relpath, abspath) for every file under `step_dir` except the
    manifest itself, in a deterministic order. Relpaths use '/' so manifests
    are portable across hosts/OS."""
    for root, dirs, files in os.walk(step_dir):
        dirs.sort()
        for name in sorted(files):
            full = os.path.join(root, name)
            rel = os.path.relpath(full, step_dir).replace(os.sep, "/")
            # Skip the manifest itself, peer run-state bundles, and
            # in-flight atomic-write tmp files (".tmp.<pid>"): a peer
            # process may be mid-_atomic_write_json during this walk, and
            # capturing its transient tmp would either record a file the
            # imminent rename deletes (permanently invalidating a good
            # checkpoint) or vanish between stat and checksum.
            if rel == MANIFEST_NAME or _PEER_RUN_STATE_RE.fullmatch(rel) or ".tmp." in name:
                continue
            yield rel, full


def _atomic_write_json(path: str, payload: Dict[str, Any]) -> None:
    """Durable tmp + fsync + rename, the property the whole integrity
    scheme leans on (shared primitive: utils/run_report.py)."""
    from raft_stereo_tpu_torch.utils.run_report import atomic_write_json

    atomic_write_json(path, payload, durable=True)


def write_manifest(step_dir: str, step: int | None = None) -> Dict[str, Any]:
    """Checksum every file currently in `step_dir` and commit the manifest
    (atomic rename, written LAST: its presence marks the save durable).
    Call only after every file of the step is written."""
    files = {
        rel: {"size": os.path.getsize(full), "crc32": _crc32_file(full)}
        for rel, full in _manifest_files(step_dir)
    }
    manifest = {
        "manifest_version": MANIFEST_VERSION,
        "step": step,
        "files": files,
    }
    _atomic_write_json(os.path.join(step_dir, MANIFEST_NAME), manifest)
    return manifest


def read_manifest(step_dir: str) -> Dict[str, Any] | None:
    """The step's committed manifest, or None when absent (pre-manifest
    checkpoint, or a save killed before commit). Raises ValueError on an
    unreadable/garbage manifest — that is corruption, not absence."""
    path = os.path.join(step_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"unreadable checkpoint manifest {path!r}: {e}") from e


def validate_checkpoint(step_dir: str) -> list:
    """Byte-level integrity verdict for one checkpoint step dir against its
    manifest. Returns a list of human-readable problems; empty == valid.

    A missing manifest is a problem (the save never committed — or predates
    integrity manifests; either way the step cannot be trusted as a resume
    anchor). Files present on disk but absent from the manifest are ignored:
    the restore only reads manifested files, so extras cannot corrupt it."""
    if not os.path.isdir(step_dir):
        return [f"not a directory: {step_dir!r}"]
    try:
        manifest = read_manifest(step_dir)
    except ValueError as e:
        return [str(e)]
    if manifest is None:
        return [
            f"no {MANIFEST_NAME} in {step_dir!r} (save never committed, or a "
            "pre-manifest checkpoint)"
        ]
    if manifest.get("manifest_version") != MANIFEST_VERSION:
        return [
            f"manifest_version {manifest.get('manifest_version')!r} != "
            f"{MANIFEST_VERSION} in {step_dir!r}"
        ]
    files = manifest.get("files")
    if not isinstance(files, dict):
        return [f"manifest in {step_dir!r} has no file table"]
    problems = []
    for rel, meta in sorted(files.items()):
        full = os.path.join(step_dir, *rel.split("/"))
        try:
            if not os.path.isfile(full):
                problems.append(f"missing file {rel!r}")
                continue
            size = os.path.getsize(full)
            if size != meta.get("size"):
                problems.append(
                    f"size mismatch for {rel!r}: manifest {meta.get('size')}, disk {size}"
                )
                continue
            crc = _crc32_file(full)
        except OSError as e:
            # The file vanished or became unreadable MID-validation — e.g.
            # a peer process quarantine-renaming the step dir this process
            # is still walking (multi-host auto-resume). That is a verdict
            # ("not a trustworthy anchor"), never a crash.
            problems.append(f"unreadable file {rel!r}: {e}")
            continue
        if crc != meta.get("crc32"):
            problems.append(
                f"checksum mismatch for {rel!r}: manifest {meta.get('crc32')}, "
                f"disk {crc}"
            )
    return problems


def write_run_state(
    step_dir: str, run_state: Dict[str, Any], process_index: int = 0
) -> str:
    """Persist a host's run-state bundle next to the step's files. Process
    0's bundle must be written BEFORE write_manifest (the manifest covers
    it); peer bundles (process_index > 0) are manifest-exempt best-effort
    sidecars (see the naming notes above)."""
    path = os.path.join(step_dir, run_state_name(process_index))
    _atomic_write_json(path, run_state)
    return path


def read_run_state(step_dir: str, process_index: int = 0) -> Dict[str, Any] | None:
    """This host's run-state bundle — its own per-host sidecar when present
    and readable, else the shared (process-0) bundle — or None when the
    step predates run-state bundles entirely. A torn peer bundle silently
    degrades to the shared one: it is best-effort by design."""
    candidates = [run_state_name(process_index)]
    if process_index != 0:
        candidates.append(RUN_STATE_NAME)
    for name in candidates:
        path = os.path.join(step_dir, name)
        if not os.path.exists(path):
            continue
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            continue  # torn/unreadable: fall back (or report absent)
    return None


def commit_step_sidecars(
    step_dir: str, step: int, run_state: Dict[str, Any] | None = None
) -> None:
    """The durability commit for one checkpoint step: write the run-state
    bundle (when given), then checksum everything and write the manifest
    last. Until this returns, the step reads as invalid to
    `validate_checkpoint` — which is exactly the crash-consistency contract
    (a kill at any byte before the manifest rename discards the step; after
    it, the step is fully verifiable)."""
    if run_state is not None:
        write_run_state(step_dir, run_state)
    write_manifest(step_dir, step)


def list_checkpoint_steps(root: str) -> list:
    """Sorted step numbers present as (non-quarantined) dirs under a run's
    checkpoint root."""
    if not os.path.isdir(root):
        return []
    return sorted(
        int(d) for d in os.listdir(root)
        if d.isdigit() and os.path.isdir(os.path.join(root, d))
    )


def quarantine_step_dir(step_dir: str, reason: str = "invalid") -> str:
    """Move a torn/corrupt step dir out of the step scan's sight: `<step>`
    -> `<step>.corrupt-<reason>[-N]`. Digit-prefixed-but-not-all-digit
    names are invisible to the scan, so nothing lists, restores, or
    collides a future re-save with the dead timeline. Returns the new
    path."""
    base = f"{step_dir}{CORRUPT_DIR_MARKER}{reason}"
    target = base
    n = 0
    while os.path.exists(target):
        n += 1
        target = f"{base}-{n}"
    os.rename(step_dir, target)
    return target


def find_latest_valid_step(root: str, quarantine: bool = False):
    """Walk the manager root's steps newest-first to the first one whose
    manifest verifies. Returns (step | None, skipped) where `skipped` is
    [(step, problems), ...] for every newer step that failed validation.

    With `quarantine=True`, each failed step is renamed aside
    (`quarantine_step_dir`) — but ONLY once a valid anchor has been found
    below it: those steps are then provably dead timelines a resumed run
    will overwrite. When NO step validates (e.g. a legacy root saved before
    integrity manifests existed), nothing is renamed and (None, skipped) is
    returned — destroying every checkpoint on a schema technicality is an
    operator decision (`quarantine_step_dir`), not an auto-resume side
    effect."""
    import logging

    logger = logging.getLogger(__name__)
    skipped = []
    found = None
    for step in reversed(list_checkpoint_steps(root)):
        step_dir = os.path.join(root, str(step))
        problems = validate_checkpoint(step_dir)
        if not problems:
            found = step
            break
        logger.warning(
            "checkpoint step %d at %s failed validation: %s",
            step, step_dir, "; ".join(problems),
        )
        skipped.append((step, problems))
    if found is not None and quarantine:
        for step, problems in skipped:
            new_path = quarantine_step_dir(os.path.join(root, str(step)))
            logger.warning(
                "quarantined invalid checkpoint step %d -> %s", step, new_path
            )
    return found, skipped


# --- the port's training step format -------------------------------------

MODEL_NAME = "model.pth"
OPTIMIZER_NAME = "optimizer.pt"


def _atomic_torch_save(obj, path: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_step_files(step_dir: str, model_state: Dict[str, torch.Tensor], optimizer_state: Dict[str, Any]) -> None:
    """The step's payload, before its run state and manifest: `model.pth`
    (`model_state`, the reference's layout from
    `export_reference_state_dict`) and `optimizer.pt`."""
    os.makedirs(step_dir, exist_ok=True)
    _atomic_torch_save(model_state, os.path.join(step_dir, MODEL_NAME))
    _atomic_torch_save(optimizer_state, os.path.join(step_dir, OPTIMIZER_NAME))


def read_optimizer_state(step_dir: str) -> Dict[str, Any]:
    return torch.load(os.path.join(step_dir, OPTIMIZER_NAME), map_location="cpu", weights_only=False)


def resolve_step_dir(path: str, step: int | None = None) -> str:
    """A step directory from a run's checkpoint root (the newest step, or
    `step`) or from a step directory itself."""
    if os.path.isfile(os.path.join(path, MODEL_NAME)) and step is None:
        return path
    steps = list_checkpoint_steps(path)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoint step under {path!r}")
        step = steps[-1]
    step_dir = os.path.join(path, str(step))
    if not os.path.isdir(step_dir):
        raise FileNotFoundError(f"no checkpoint step {step} under {path!r}")
    return step_dir


def steps_to_prune(steps, max_to_keep: int, keep_period: int | None = None) -> list:
    """Steps a save leaves behind for deletion, as orbax's CheckpointManager
    prunes: the newest `max_to_keep` stay, and with `keep_period` every step
    divisible by it stays too."""
    steps = sorted(steps)
    keep = set(steps[-max_to_keep:])
    if keep_period:
        keep |= {s for s in steps if s % keep_period == 0}
    return [s for s in steps if s not in keep]
