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
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

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
