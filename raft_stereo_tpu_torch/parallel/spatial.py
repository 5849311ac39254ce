"""Row bands over the spatial axis: the port's counterpart of the JAX
package's activation scope (`raft_stereo_tpu/parallel/sharding.py`
`activation_mesh`, `constrain_spatial`).

JAX pins the correlation state and the GRU hidden state to row shards and
lets XLA's partitioner write every halo and every cross-shard sum. Eager
PyTorch has no partitioner, so the layers write them here. Each rank of a
spatial group holds a band of image rows; a `BandScope` says which group,
band index and band count are in force, and inside it:

- `Conv` (models/layers.py) with a kernel taller than one row takes its
  halo with `halo_rows` and runs with zero row padding (the rows beyond
  the image are the zero rows `halo_rows` puts at the global top and
  bottom edges). A strided conv takes an asymmetric halo: a band starts
  on an even row, so the 7x7 stride-2 stem with padding 3 needs 3 rows
  above and 2 below, a 3x3 stride-2 conv 1 above and 0 below;
- `InstanceNorm` and `GroupNorm` sum their one-pass fp32 statistics over
  the group with `band_sum` and divide by the whole image's pixel count;
- `avg_pool2x` takes 1 row above, the convex upsample's 3x3 unfold 1 row
  on each side, and the align-corners resize to a banded level gathers
  its (coarser) operand whole and computes this band's output rows with
  the band's rows of the interpolation matrix.

- the fused encoder's layer1 (ops/encoder_cuda.py `fused_layer1`) takes
  its conv operands' neighbour rows with `raw_halo_rows` (no rows at the
  image's edges: the conv kernel pads z = form(x), not x, and is told how
  many halo rows it got) and sums its instance statistics with `band_sum`.

The correlation volume, pyramid, lookup and scatter are row-local (1-D
matching along a row), so the CUDA kernels run unchanged on each band and
the chain from `corr_state` to the taps makes no exchange
(`BandScope.exchanges` counts every collective this module makes).

The collectives go through a comm: `GroupComm` over a torch process group
(one band per rank), or `ThreadComm` between the threads of one process
(one band per thread, each on its own card or sharing one: the banded
serving engine, serving/engine.py, and the CPU tests).

**The band rule.** Rank k of s holds rows [k*R/s, (k+1)*R/s) of every
banded level, R being that level's rows. The image height must divide by
s * 2**n_downsample, so every level down to the correlation features is
banded with even bands (a stride-2 op's band then starts on an even row),
and leave at least 3 rows per band at 1/2**n_downsample, the halo of the
motion encoder's 7x7 conv (`config.band_shape_problem`). A height that
does not is refused with the height that would work; nothing is padded.

**The ragged-level rule.** Level l has R_l = ceil(R_{l-1} / 2) rows
(every stride-2 op of the model rounds up). It is banded when R_j divides
by s for every j <= l; otherwise it is ragged: the first ragged level is
computed from its finer level gathered whole (`gather_rows`), and it and
every coarser level are computed whole, the same values on every rank.
Where a whole level feeds a banded one (the update block's resize to the
finer GRU) the band's rows are taken. On a 48-row image over 2 ranks the
1/16 level (3 rows) and the 1/32 level are whole; on a 64-row image every
level is banded. Inside the scope each code path states its level
(`level`, `coarser`), and the layers read the state: banded or whole.

Outside a scope `banded()` is None and every layer runs exactly its
unsharded code (the trainer and the engines enter a scope only for a
spatial axis above 1). The state is per thread (a test
runs two bands in two threads of one process); the backward functions
keep their scope from the forward, and `checkpoint_contexts` restores it
where the training forward is recomputed in backward.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Tuple

import torch

from raft_stereo_tpu_torch.config import band_shape_problem

_local = threading.local()


def _state():
    return getattr(_local, "state", None)


class GroupComm:
    """The collectives of a band scope over a torch process group (gloo
    or NCCL; gloo carries CUDA tensors, which is how two ranks share one
    card)."""

    def __init__(self, group=None):
        self.group = group

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every band's `t`; bf16 travels as its bytes (a copy is exact,
        and every backend carries uint8)."""
        import torch.distributed as dist

        bits = t.contiguous()
        if bits.dtype == torch.bfloat16:
            bits = bits.view(torch.uint8)
        parts = [torch.empty_like(bits) for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(parts, bits, group=self.group)
        return [p.view(t.dtype) for p in parts]

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the bands, in place; a bf16 tensor is summed in fp32
        and rounded once."""
        import torch.distributed as dist

        if t.dtype == torch.bfloat16:
            wide = t.float()
            dist.all_reduce(wide, group=self.group)
            return t.copy_(wide)
        dist.all_reduce(t, group=self.group)
        return t


class ThreadComm:
    """The collectives of a band scope between the threads of one process,
    band k on thread k: a slot per band and a `threading.Barrier`.
    `bound(k)` is band k's comm. Its `all_gather` leaves a copy of the
    band's tensor in its slot (on a card with an event recorded after the
    copy on the thread's current stream), waits for every band, and takes
    the other bands' tensors onto its own device: on a card the streams that
    read them first wait on their producers' events, so nothing passes
    through the host and no thread blocks on the device. A second wait
    keeps a slot until every band has read it. `abort()` breaks the barrier
    (a band that failed), `reset()` makes it usable again once every band's
    thread has returned."""

    def __init__(self, n: int):
        self.count = n
        self.barrier = threading.Barrier(n)
        self.slots: list = [None] * n

    def bound(self, k: int) -> "_ThreadBand":
        return _ThreadBand(self, k)

    def abort(self) -> None:
        self.barrier.abort()

    def reset(self) -> None:
        self.barrier.reset()
        self.slots = [None] * self.count


class _ThreadBand:
    def __init__(self, comm: ThreadComm, k: int):
        self.comm = comm
        self.k = k

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        comm, k = self.comm, self.k
        mine = t.detach().clone(memory_format=torch.contiguous_format)
        ready = None
        if mine.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(mine.device))
        comm.slots[k] = (mine, ready)
        comm.barrier.wait()
        parts = []
        for j, (src, event) in enumerate(list(comm.slots)):
            if j == k:
                parts.append(mine)
                continue
            if event is not None:
                # The copy runs on the source card's current stream and the
                # result is read on this band's: both wait for the producer.
                for stream in {torch.cuda.current_stream(src.device), torch.cuda.current_stream(mine.device)}:
                    stream.wait_event(event)
                    src.record_stream(stream)
            parts.append(src.to(mine.device, non_blocking=True))
        comm.barrier.wait()
        return parts

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the bands in band order, the same on every band; a
        bf16 tensor is summed in fp32 and rounded once (as `GroupComm`)."""
        parts = self.all_gather(t)
        total = parts[0].float() if t.dtype == torch.bfloat16 else parts[0].clone()
        for p in parts[1:]:
            total += p
        return t.copy_(total)


class BandScope:
    """Band `index` of `count` over `comm`'s group (a `GroupComm`, a
    `ThreadComm.bound(index)`, or any object with `all_gather` and
    `all_reduce`). `height` is the whole
    image's rows at full resolution, set by `bands` for each forward."""

    def __init__(self, comm, index: int, count: int):
        if not 0 <= index < count:
            raise ValueError(f"band {index} out of range for {count} bands")
        self.comm = comm
        self.index = index
        self.count = count
        self.height: Optional[int] = None
        # Collectives made through this scope (halos, sums, gathers).
        self.exchanges = 0

    # -- levels -----------------------------------------------------------
    def rows(self, level: int) -> int:
        """Rows of the whole level `level` (full resolution is 0)."""
        r = self.height
        for _ in range(level):
            r = -(-r // 2)
        return r

    def banded_level(self, level: int) -> bool:
        """The ragged-level rule: banded iff every level down to this one
        divides the band count."""
        return all(self.rows(j) % self.count == 0 for j in range(level + 1))

    @contextlib.contextmanager
    def bands(self, band_rows: int, n_downsample: int):
        """The scope in force on this thread for one forward of images
        whose band has `band_rows` rows: full resolution banded."""
        height = band_rows * self.count
        problem = band_shape_problem(height, self.count, n_downsample)
        if problem is not None:
            raise ValueError(problem)
        self.height = height
        prev = _state()
        _local.state = (self, True)
        try:
            yield self
        finally:
            _local.state = prev

    # -- collectives ------------------------------------------------------
    def _gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        self.exchanges += 1
        return self.comm.all_gather(t)

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        self.exchanges += 1
        return self.comm.all_reduce(t)

    def halo_rows(self, x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
        """x (B, C, h, W), this band, with `top` rows of the band above and
        `bottom` rows of the band below around it (zero rows at the image's
        top and bottom edges). Differentiable: the halo rows' gradients go
        back to the bands they came from."""
        if top == 0 and bottom == 0:
            return x
        if top > x.shape[2] or bottom > x.shape[2]:
            raise ValueError(f"a halo of {top} + {bottom} rows is taller than the band's {x.shape[2]} rows")
        return _Halo.apply(x, self, top, bottom, True)

    def raw_halo_rows(self, x: torch.Tensor, top: int, bottom: int) -> Tuple[torch.Tensor, int, int]:
        """x (B, C, h, W), this band, with `top` rows of the band above and
        `bottom` rows of the band below attached only where that band exists
        (nothing at the image's top and bottom edges): (rows, rows attached
        above, rows attached below), for a kernel that pads its own operand
        (the fused conv pads z = form(x), not x). One exchange, as
        `halo_rows`; differentiable likewise."""
        k = self.index
        got_top = top if k > 0 else 0
        got_bottom = bottom if k < self.count - 1 else 0
        if top == 0 and bottom == 0:
            return x, 0, 0
        if top > x.shape[2] or bottom > x.shape[2]:
            raise ValueError(f"a halo of {top} + {bottom} rows is taller than the band's {x.shape[2]} rows")
        return _Halo.apply(x, self, top, bottom, False), got_top, got_bottom

    def band_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of `t` over the group's bands (differentiable)."""
        return _BandSum.apply(t, self)

    def gather_rows(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """The whole tensor from the bands along `dim` (differentiable: the
        gradient of the whole, summed over the group, back to this band)."""
        return _GatherRows.apply(x, self, dim)

    def take_band(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """This band's rows of a whole tensor along `dim`."""
        n = x.shape[dim]
        if n % self.count:
            raise ValueError(f"{n} rows do not split into {self.count} bands")
        step = n // self.count
        return x.narrow(dim, self.index * step, step)


class _Halo(torch.autograd.Function):
    """The halo exchange; `edges`: zero rows at the image's top and bottom
    edges (`halo_rows`), else nothing there (`raw_halo_rows`)."""

    @staticmethod
    def forward(ctx, x, scope, top, bottom, edges):
        k, (b, c, h, w) = scope.index, x.shape
        ctx.scope, ctx.top, ctx.bottom = scope, top, bottom
        ctx.got = (top if edges or k > 0 else 0, bottom if edges or k < scope.count - 1 else 0)
        # Each band sends its first `bottom` rows (the band above's lower
        # halo) and its last `top` rows (the band below's upper halo).
        parts = scope._gather(torch.cat([x[:, :, :bottom], x[:, :, h - top:]], dim=2))
        above = parts[k - 1][:, :, bottom:] if k > 0 else x.new_zeros((b, c, ctx.got[0], w))
        below = parts[k + 1][:, :, :bottom] if k < scope.count - 1 else x.new_zeros((b, c, ctx.got[1], w))
        return torch.cat([above, x, below], dim=2)

    @staticmethod
    def backward(ctx, g):
        scope, top, bottom = ctx.scope, ctx.top, ctx.bottom
        got_top, got_bottom = ctx.got
        b, c, rows, w = g.shape
        h = rows - got_top - got_bottom
        # Send each halo's gradient back: the upper halo's to the band
        # above (its last rows), the lower halo's to the band below; a
        # halo not attached sends zeros, so every band's part has one shape.
        g_top = g[:, :, :top] if got_top == top else g.new_zeros((b, c, top, w))
        g_bottom = g[:, :, got_top + h:] if got_bottom == bottom else g.new_zeros((b, c, bottom, w))
        parts = scope._gather(torch.cat([g_top, g_bottom], dim=2))
        dx = g[:, :, got_top:got_top + h].clone()
        k = scope.index
        if k > 0:
            dx[:, :, :bottom] += parts[k - 1][:, :, top:]
        if k < scope.count - 1:
            dx[:, :, h - top:] += parts[k + 1][:, :, :top]
        return dx, None, None, None, None


class _BandSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, scope):
        ctx.scope = scope
        return scope._sum(t.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.scope._sum(g.clone()), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scope, dim):
        ctx.scope, ctx.dim = scope, dim
        return torch.cat(scope._gather(x), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.scope.take_band(ctx.scope._sum(g.contiguous().clone()), ctx.dim).contiguous(), None, None


# -- the state the layers read ------------------------------------------------


def active() -> Optional[BandScope]:
    """The band scope in force on this thread (banded or whole), if any."""
    state = _state()
    return state[0] if state is not None else None


def banded() -> Optional[BandScope]:
    """The band scope when the code running now is on a banded level, else
    None: the layers' one question."""
    state = _state()
    return state[0] if state is not None and state[1] else None


@contextlib.contextmanager
def _mode(scope: BandScope, is_banded: bool):
    prev = _state()
    _local.state = (scope, is_banded)
    try:
        yield
    finally:
        _local.state = prev


def level(lv: int):
    """The code inside runs on level `lv` (0 is full resolution): banded or
    whole by the ragged-level rule. Outside a scope, nothing."""
    scope = active()
    if scope is None:
        return contextlib.nullcontext()
    return _mode(scope, scope.banded_level(lv))


def coarser(x: torch.Tensor, lv: int, fn: Callable[[torch.Tensor], torch.Tensor]):
    """`fn(x)` where x is on level `lv` and fn's result on level `lv + 1`
    (a stride-2 layer or a pooling): on the band when the coarser level is
    banded, on x gathered whole when it is the first ragged level, whole
    when x already is."""
    scope = active()
    if scope is None:
        return fn(x)
    if scope.banded_level(lv + 1):
        with _mode(scope, True):
            return fn(x)
    if scope.banded_level(lv):
        x = scope.gather_rows(x)
    with _mode(scope, False):
        return fn(x)


def interp_rows(x: torch.Tensor, lv_x: int, out_rows: int, lv_out: int,
                resize: Callable[[torch.Tensor, Optional[slice]], torch.Tensor]) -> torch.Tensor:
    """A row resize from level `lv_x` to the finer level `lv_out`, whose
    tensor here has `out_rows` rows: `resize(x_whole, rows)` with `rows`
    None for every output row or this band's slice of them."""
    scope = active()
    if scope is None:
        return resize(x, None)
    if scope.banded_level(lv_x):
        x = scope.gather_rows(x)
    if not scope.banded_level(lv_out):
        return resize(x, None)
    return resize(x, slice(scope.index * out_rows, (scope.index + 1) * out_rows))


def checkpoint_contexts():
    """`torch.utils.checkpoint`'s `context_fn`: the recomputation in
    backward runs in the band state of the forward it repeats."""
    state = _state()

    @contextlib.contextmanager
    def restore():
        prev = _state()
        _local.state = state
        try:
            yield
        finally:
            _local.state = prev

    return contextlib.nullcontext(), restore()


def conv_halo(kernel: int, stride: int, padding: int) -> tuple:
    """(top, bottom) rows a conv of this height, stride and padding needs
    around a band that starts on a multiple of the stride and holds a
    multiple of it, so that it yields the band's output rows with no row
    padding: `padding` above, kernel - padding - stride below (at least 0)."""
    return padding, max(kernel - padding - stride, 0)


class BandedModel(torch.nn.Module):
    """A `RAFTStereo` forward on this rank's band: images (B, h, W, C) of
    the band's rows in, the band's rows of every output out. `forward_whole`
    takes whole images and returns whole test-mode outputs (each rank takes
    its band and the flows are gathered), for evaluation."""

    def __init__(self, model: torch.nn.Module, scope: BandScope):
        super().__init__()
        self.model = model
        self.band_scope = scope
        self.config = model.config

    def forward(self, image1, image2, iters: int = 12, flow_init=None, test_mode: bool = False):
        with self.band_scope.bands(image1.shape[1], self.config.n_downsample):
            return self.model(image1, image2, iters=iters, flow_init=flow_init, test_mode=test_mode)

    def forward_whole(self, image1, image2, iters: int = 12):
        """Test mode on whole images (B, H, W, C): (flow_lowres, flow_up),
        both whole on every rank of the group."""
        scope = self.band_scope
        problem = band_shape_problem(image1.shape[1], scope.count, self.config.n_downsample)
        if problem is not None:
            raise ValueError(problem)
        lo, up = self(scope.take_band(image1, 1), scope.take_band(image2, 1), iters=iters, test_mode=True)
        return scope.gather_rows(lo, 1), scope.gather_rows(up, 1)


def band_scope_for(mesh) -> BandScope:
    """This rank's scope over the spatial axis of `mesh` (a parallel/mesh.py
    `Mesh` with its DeviceMesh)."""
    from raft_stereo_tpu_torch.parallel.mesh import SPATIAL_AXIS

    sub = mesh.device_mesh[SPATIAL_AXIS]
    return BandScope(GroupComm(sub.get_group()), sub.get_local_rank(), mesh.spatial)
