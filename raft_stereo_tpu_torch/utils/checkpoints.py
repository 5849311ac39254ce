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
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models.layers import FrozenBatchNorm, GroupNorm

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
        tensor.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
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
    """Read a reference `.pth` into {key: ndarray}, stripping the
    DataParallel `module.` prefix."""
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


def export_reference_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A port `RAFTStereo`'s weights as the reference's state dict, the
    layout `load_reference_state_dict` reads (`torch.save` it as a .pth):
    the inverse of `convert_state_dict`. The flow-y input channel of the
    motion encoder's flow conv and the flow-y output row of the flow head,
    which the port drops, are written as zeros (flow-y is identically zero
    in the reference). Each reference key is found by running the
    converter once on a probe whose every tensor holds its own key's index."""
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
    for name, tensor in model.state_dict().items():
        key = origin[_flax_key(model, name)[0]]
        value = tensor.detach().float().cpu()
        if key == "update_block.encoder.convf1.weight":
            value = torch.cat([value, torch.zeros_like(value)], dim=1)
        elif key.startswith("update_block.flow_head.conv2."):
            value = torch.cat([value, torch.zeros_like(value)], dim=0)
        sd[key] = value.contiguous()
    return sd
