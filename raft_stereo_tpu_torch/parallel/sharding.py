"""Rule-driven sharding engine: the port's counterpart of
`raft_stereo_tpu/parallel/sharding.py`.

The rule machinery is the JAX module's: a table of ``(regex, P)`` pairs is
matched against the name of every leaf of a tree (a Mapping, nested or
flat: the port's `named_parameters()` names, OIHW weights, are flat keys),
first match wins, scalars are never partitioned, an unmatched leaf is a
hard error, and every table ends with the ``.*`` catch-all.

The four preset names are the JAX package's, and `resolve_mesh_shape` is
its, verbatim. How a preset runs is PyTorch's:

- ``dp`` wraps the model in `DistributedDataParallel`: parameters whole on
  every rank, gradients averaged across the data axis in the backward (so
  do ``spatial`` and ``dp+spatial`` on a spatial axis of 1, where, as in
  JAX, they are inert).
- ``fsdp`` is FSDP2 (`fully_shard`) on the root module. Placement follows
  the rule table and JAX's divide-evenly-or-replicate demotion
  (`_fit_spec`): a conv weight whose C_out divides the data axis is
  sharded on dim 0, and so are its AdamW moments (they mirror the
  parameter, train/optimizer.py); biases, norm scales and non-dividing
  weights (the C_out=1 flow head; the 126-channel motion conv on 4-way
  meshes) stay whole on every rank. FSDP2 shards every parameter it owns,
  so those are `ignored_params` and `reduce_replicated_grads` all-reduces
  their gradients. The root owns every parameter, so the fused encoder and
  the correlation's autograd function, which read weights directly, see
  whole tensors inside the forward and the backward.
- a spatial axis above 1 (``spatial``, ``dp+spatial``, and ``dp`` on such
  a mesh, whose batch rules shard rows over ``spatial`` as JAX's do) runs
  row bands: the model runs under parallel/spatial.py's band scope (the
  counterpart of JAX's activation scope, with every halo, cross-band norm
  sum and ragged-level gather written out), parameters whole on every
  rank, and after the backward every gradient is summed over all the
  ranks in one flat all-reduce: each rank's loss is its share of the
  global batch's (its band's valid pixels over the global count), so the
  sum is the global batch's gradient. ``fused_encoder`` runs on bands in
  test mode (the trainer's validation), as JAX's trainer takes the fused
  branch only there.
- ``fsdp`` on a spatial axis above 1 is both: FSDP2 over the data axis
  (the 1-D data sub-mesh, so the DTensors carry that mesh and FSDP2's
  reduce-scatter averages over the data group only), inside the band
  scope. The reduce-scatter sums a band's gradients over its data group;
  `reduce_replicated_grads` then sums the local pieces over the spatial
  group, and the whole parameters' gradients over every rank.

Left out: the JAX module's HLO collective audit (`collective_counts`,
`assert_no_collectives`), which reads XLA's compiled text; the port has
no XLA program to read (its counterpart for the correlation chain counts
the band scope's exchanges, tests/test_torch_spatial.py).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import torch

from raft_stereo_tpu_torch.parallel.mesh import DATA_AXIS, SPATIAL_AXIS, Mesh, P

Rule = Tuple[str, P]


# ---------------------------------------------------------------------------
# Rule matching
# ---------------------------------------------------------------------------


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(name, leaf) in order: Mapping keys and sequence indices joined by
    '/', as JAX joins a key path."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _map_tree(fn, tree, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, Mapping):
        return {k: _map_tree(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_map_tree(fn, v, prefix + (str(i),)) for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def _leaf_shape(leaf) -> Tuple[int, ...]:
    """Shape of an array-ish leaf; python scalars count as shape ()."""
    return tuple(getattr(leaf, "shape", ()))


def _is_scalar(leaf) -> bool:
    shape = _leaf_shape(leaf)
    return len(shape) == 0 or math.prod(shape) == 1


def validate_rules(rules: Sequence[Rule]) -> Tuple[Rule, ...]:
    """Compile-check a rule table: patterns must be valid regexes, specs
    `P`s, and the LAST rule the literal catch-all ``.*``."""
    rules = tuple(rules)
    if not rules:
        raise ValueError("empty sharding rule table")
    for pattern, spec in rules:
        re.compile(pattern)
        if not isinstance(spec, P):
            raise ValueError(f"rule {pattern!r}: spec must be a P, got {type(spec)}")
    if rules[-1][0] != ".*":
        raise ValueError(f"rule table must end with the catch-all ('.*', ...); last rule is {rules[-1][0]!r}")
    return rules


def _match_leaf(rules: Sequence[Rule], name: str, leaf) -> Tuple[Optional[str], P]:
    """(winning pattern, spec) for one leaf. Scalars are never partitioned
    whatever a rule says."""
    if _is_scalar(leaf):
        return None, P()
    for pattern, spec in rules:
        if re.search(pattern, name):
            ndim = len(_leaf_shape(leaf))
            if len(spec) > ndim:
                raise ValueError(f"sharding rule {pattern!r} -> {spec} has rank {len(spec)} but leaf {name!r} "
                                 f"has rank {ndim}")
            return pattern, spec
    raise ValueError(f"no sharding rule matched leaf {name!r} (shape {_leaf_shape(leaf)}); add an explicit "
                     "rule or a trailing ('.*', P()) catch-all")


def match_partition_rules(rules: Sequence[Rule], tree) -> Any:
    """A tree of specs with the structure of `tree`: first match wins
    (``re.search`` over the leaf name); scalars get ``P()``; an unmatched
    leaf raises."""
    return _map_tree(lambda name, leaf: _match_leaf(rules, name, leaf)[1], tree)


def explain_sharding(rules: Sequence[Rule], tree, label: str = "tree") -> str:
    """Every leaf -> spec decision: name, shape, the rule that won (or the
    scalar exemption) and the spec (the ``--explain_sharding`` payload)."""
    leaves = list(_leaves(tree))
    lines = [f"# sharding decisions for {label} ({len(leaves)} leaves)"]
    for name, leaf in leaves:
        pattern, spec = _match_leaf(rules, name, leaf)
        why = "scalar (never partitioned)" if pattern is None else f"rule {pattern!r}"
        lines.append(f"{name:<60s} shape={_leaf_shape(leaf)!s:<20s} {why:<32s} -> {spec}")
    return "\n".join(lines)


def _sharded_dim(spec: P) -> Optional[int]:
    """The dim a spec shards over the data axis (the only axis a ported
    preset shards), or None."""
    for dim, axis in enumerate(spec):
        names = (axis,) if isinstance(axis, str) else tuple(axis or ())
        if DATA_AXIS in names:
            return dim
    return None


def make_shard_and_gather_fns(mesh: Mesh, spec_tree):
    """From a tree of specs, trees of ``shard_fn(full tensor) -> this rank's
    piece`` and ``gather_fn(tensor) -> the full tensor``. The piece is
    `torch.chunk` along the sharded dim, FSDP2's layout; a gather of a
    sharded `DTensor` is collective (every rank calls it in the same
    order), of a whole tensor a no-op."""
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    # make_mesh's row-major layout: rank = data index * spatial + spatial index.
    index = rank // mesh.spatial

    def _shard_fn(spec):
        dim = _sharded_dim(spec)
        if dim is None or mesh.data == 1:
            return lambda x: x
        return lambda x: x.chunk(mesh.data, dim=dim)[index % mesh.data]

    def _gather_fn(spec):
        return full_tensor

    return (_map_tree(lambda _, s: _shard_fn(s), spec_tree), _map_tree(lambda _, s: _gather_fn(s), spec_tree))


def full_tensor(x: torch.Tensor) -> torch.Tensor:
    """The whole of a (possibly sharded) tensor, or the tensor itself. A
    DTensor sharded on dim k of its 1-D mesh is gathered with one
    `all_gather_into_tensor` over the mesh's group (collective: every rank
    of the group calls it), not with `DTensor.full_tensor()`, whose
    functional collectives crash over gloo on CUDA tensors (ranks sharing
    one card)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return x
    import torch.distributed as dist

    (placement,) = x.placements
    local = x.to_local()
    if not isinstance(placement, Shard):
        return local
    mesh, dim = x.device_mesh, placement.dim
    if x.shape[dim] != mesh.size() * local.shape[dim]:
        raise ValueError(f"uneven shards: {tuple(x.shape)} over {mesh.size()} rank(s) on dim {dim}")
    piece = local.detach().movedim(dim, 0).contiguous()
    whole = piece.new_empty((mesh.size() * piece.shape[0], *piece.shape[1:]))
    dist.all_gather_into_tensor(whole, piece, group=mesh.get_group())
    return whole.movedim(0, dim).contiguous()


def local_tensor(x: torch.Tensor) -> torch.Tensor:
    """This rank's piece of a (possibly sharded) tensor, sharing storage."""
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def is_sharded(x: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard_as(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`full` laid out as `like`: a whole tensor on `like`'s device, or,
    for a DTensor sharded on dim k of a 1-D mesh, this rank's `torch.chunk`
    of it as a DTensor with `like`'s placement (no communication)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(like, DTensor):
        return full.to(like.device)
    (placement,) = like.placements
    mesh = like.device_mesh
    piece = full
    if isinstance(placement, Shard):
        piece = full.chunk(mesh.size(), dim=placement.dim)[mesh.get_local_rank()]
    return DTensor.from_local(piece.contiguous().to(like.to_local().device), mesh, like.placements,
                              run_check=False)


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

BATCH_RULES: Tuple[Rule, ...] = (
    (r"^(image1|image2|flow)$", P(DATA_AXIS, SPATIAL_AXIS, None, None)),
    (r"^valid$", P(DATA_AXIS, SPATIAL_AXIS, None)),
    (r".*", P()),
)

REPLICATE_ALL: Tuple[Rule, ...] = ((r".*", P()),)

# FSDP placement: every conv weight (OIHW, C_out first) splits its output
# channels over the data axis, as JAX's `kernel$ -> P(None, None, None,
# data)` splits an HWIO kernel's. The port names a norm's scale `weight`
# too (JAX: `scale`), so the norms are matched first and stay whole;
# biases and the rest fall through to the catch-all.
FSDP_RULES: Tuple[Rule, ...] = (
    (r"norm\d*\.weight$", P()),
    (r"weight$", P(DATA_AXIS, None, None, None)),
    (r".*", P()),
)

BATCH_TEMPLATE: Dict[str, int] = {"image1": 4, "image2": 4, "flow": 4, "valid": 3}


@dataclass(frozen=True)
class ShardingPreset:
    name: str
    param_rules: Tuple[Rule, ...]
    batch_rules: Tuple[Rule, ...]
    description: str


PRESETS: Dict[str, ShardingPreset] = {
    "dp": ShardingPreset("dp", validate_rules(REPLICATE_ALL), validate_rules(BATCH_RULES),
                         "pure data parallelism: DistributedDataParallel, gradients averaged"),
    "spatial": ShardingPreset("spatial", validate_rules(REPLICATE_ALL), validate_rules(BATCH_RULES),
                              "H-row sharding; corr volume + GRU state split over cards"),
    "dp+spatial": ShardingPreset("dp+spatial", validate_rules(REPLICATE_ALL), validate_rules(BATCH_RULES),
                                 "batch over data axis AND rows over spatial axis"),
    "fsdp": ShardingPreset("fsdp", validate_rules(FSDP_RULES), validate_rules(BATCH_RULES),
                           "FSDP2: conv weights + AdamW moments sharded over the data axis, batch over data"),
}


def resolve_mesh_shape(preset: str, n_devices: int, batch: int) -> Tuple[int, int]:
    """Default (data, spatial) mesh shape for a preset at a given device
    count and global batch (the JAX package's rule): dp and fsdp use as
    many chips as divide the batch, the spatial presets all chips."""
    if preset not in PRESETS:
        raise ValueError(f"unknown sharding preset {preset!r}; have {sorted(PRESETS)}")
    d = math.gcd(max(batch, 1), n_devices)
    if preset in ("dp", "fsdp"):
        return (d, 1)
    if preset == "spatial":
        return (1, n_devices)
    return (d, n_devices // d)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class ShardingEngine:
    """Binds a preset's rule tables to a mesh and wraps the model for it.
    One engine per Trainer."""

    def __init__(self, mesh: Mesh, rules: str = "dp"):
        if rules not in PRESETS:
            raise ValueError(f"unknown sharding preset {rules!r}; have {sorted(PRESETS)}")
        self.mesh = mesh
        self.preset = PRESETS[rules]

    def _fit_spec(self, spec: P, shape: Tuple[int, ...]) -> P:
        """Demote sharded dims that do not split evenly over their mesh axis
        to replicated (JAX's divide-evenly-or-leave-alone policy)."""
        if all(a is None for a in spec):
            return spec
        axes = []
        changed = False
        for dim, axis in zip(shape, spec):
            if axis is None:
                axes.append(None)
                continue
            names = (axis,) if isinstance(axis, str) else tuple(axis)
            size = math.prod(self.mesh.shape[n] for n in names)
            if dim % size == 0:
                axes.append(axis)
            else:
                axes.append(None)
                changed = True
        return P(*axes) if changed else spec

    def state_specs(self, tree):
        """The fitted spec of every leaf of `tree` (a model's named
        parameters, or any Mapping of tensors)."""
        return _map_tree(lambda name, leaf: self._fit_spec(_match_leaf(self.preset.param_rules, name, leaf)[1],
                                                            _leaf_shape(leaf)), tree)

    def param_specs(self, model: torch.nn.Module) -> Dict[str, P]:
        return self.state_specs(dict(model.named_parameters()))

    def replicated_params(self, model: torch.nn.Module):
        """The parameters the preset keeps whole on every rank."""
        specs = self.param_specs(model)
        return [p for name, p in model.named_parameters() if _sharded_dim(specs[name]) is None]

    @property
    def distributed(self) -> bool:
        return self.mesh.device_mesh is not None

    @property
    def banded(self) -> bool:
        """Image rows split over a spatial axis above 1."""
        return self.mesh.spatial > 1

    @property
    def fsdp(self) -> bool:
        return self.preset.name == "fsdp"

    @property
    def loss_scale(self) -> int:
        """What a rank's share of the global loss is scaled by before its
        backward: DDP and FSDP2 average the ranks' gradients over the data
        axis, so its size (under fsdp on bands too); the other banded
        presets sum them, so 1."""
        return 1 if self.banded and not self.fsdp else self.mesh.data

    def wrap(self, model: torch.nn.Module) -> torch.nn.Module:
        """The module the training step calls. Outside a process group the
        model itself; dp (or a spatial preset on a spatial axis of 1): a
        DistributedDataParallel around it; fsdp: the model, sharded in
        place by FSDP2 over the data axis (its parameters become DTensors
        outside the forward and backward); on a spatial axis above 1 that
        (fsdp) or the model itself (the other presets, parameters whole),
        in a `BandedModel`, on this rank's band of rows."""
        if not self.distributed:
            return model
        if self.fsdp:
            from torch.distributed.fsdp import fully_shard
            from torch.distributed.tensor import Shard

            specs = self.param_specs(model)
            placement = {id(p): _sharded_dim(specs[name]) for name, p in model.named_parameters()}
            # One unit, the root, and the backward follows the forward at
            # once: the whole parameters stay gathered between them, which
            # the fused encoder and the correlation's autograd function
            # (they read weights directly) need.
            fully_shard(model, mesh=self.mesh.device_mesh[DATA_AXIS], reshard_after_forward=False,
                        shard_placement_fn=lambda p: Shard(placement[id(p)]),
                        ignored_params=set(self.replicated_params(model)))
        if self.banded:
            from raft_stereo_tpu_torch.parallel import spatial

            return spatial.BandedModel(model, spatial.band_scope_for(self.mesh))
        if self.fsdp:
            return model
        from torch.nn.parallel import DistributedDataParallel

        on_card = next(model.parameters()).device.type == "cuda"
        # The frozen batch norm's statistics are equal on every rank by
        # construction: no per-forward broadcast.
        return DistributedDataParallel(model, device_ids=[torch.cuda.current_device()] if on_card else None,
                                       process_group=self.mesh.device_mesh[DATA_AXIS].get_group(),
                                       broadcast_buffers=False)

    def reduce_replicated_grads(self, model: torch.nn.Module) -> None:
        """The gradients no wrapper reduces: afterwards every rank holds the
        global batch's gradient (its piece of a sharded one). The whole
        parameters' (under fsdp the ones FSDP2 ignores, on bands every
        one) in one all-reduce over every rank, divided by `loss_scale`;
        under fsdp on bands, also the sharded gradients' local pieces
        (FSDP2's reduce-scatter summed them over the data group) in one
        all-reduce over the spatial group."""
        if not self.distributed or self.mesh.data * self.mesh.spatial == 1:
            return
        if self.fsdp:
            _all_reduce([p.grad for p in self.replicated_params(model)], None, self.loss_scale)
            if self.banded:
                _all_reduce([local_tensor(p.grad) for p in model.parameters() if is_sharded(p)],
                            self.mesh.device_mesh[SPATIAL_AXIS].get_group(), 1)
        elif self.banded:
            _all_reduce([p.grad for p in model.parameters()], None, 1)

    def explain(self, model: Optional[torch.nn.Module] = None,
                batch_template: Optional[Dict[str, int]] = None) -> str:
        """The --explain_sharding dump: every parameter -> spec decision and
        the batch template's, under the preset and mesh header. Fitted
        specs (a non-dividing weight shows as replicated) follow each
        rule's decision."""
        d, s = self.mesh.data, self.mesh.spatial
        lines = [f"sharding preset: {self.preset.name} ({self.preset.description})",
                 f"mesh: {d}x{s} (data x spatial) over {d * s} rank(s)"]
        if s == 1:
            lines.append("row bands: off")
        else:
            lines.append(f"row bands: rank k of the {s} in a spatial group holds rows [k*R/{s}, (k+1)*R/{s}) of "
                         "every level whose rows R divide by it (and every finer level's do); ragged levels whole "
                         "on every rank; " + (
                             f"conv weights and their AdamW moments sharded over the data axis ({d}), the same "
                             "shard on every rank of a spatial group; gradients reduce-scattered over data, then "
                             "summed over spatial (the whole parameters' over all ranks)" if self.fsdp else
                             "gradients summed over all ranks"))
        if model is not None:
            params = dict(model.named_parameters())
            lines.append(explain_sharding(self.preset.param_rules, params, label="parameters"))
            fitted = self.param_specs(model)
            demoted = [n for n, p in params.items()
                       if _match_leaf(self.preset.param_rules, n, p)[1] != fitted[n]]
            lines.append(f"# {len(demoted)} parameter(s) replicated because their dim does not divide the data "
                         f"axis ({d}): {', '.join(demoted) if demoted else 'none'}")
        template = BATCH_TEMPLATE if batch_template is None else batch_template
        probe = {name: torch.empty((2,) * ndim, device="meta") for name, ndim in template.items()}
        lines.append(explain_sharding(self.preset.batch_rules, probe, label="batch"))
        return "\n".join(lines)


def _all_reduce(tensors, group, divide: int) -> None:
    """Sum `tensors` (None entries skipped) over `group` (None: every rank)
    in one flat collective, divided by `divide`, written back in place."""
    import torch.distributed as dist

    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if divide > 1:
        flat.div_(divide)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
