"""Optimizer and learning-rate schedule: counterpart of
`raft_stereo_tpu/train/optimizer.py`, computing what its optax chain
computes.

The recipe (reference train_stereo.py:73-80): global gradient-norm clipping
at 1.0, then AdamW(lr, b1=0.9, b2=0.999, eps=1e-8, weight decay 1e-5) under
a linear one-cycle schedule over `num_steps + 100`. Where optax and
`torch.optim` differ, this follows optax:

- clipping leaves the gradients unchanged when norm < max_norm and scales
  them to g / norm * max_norm otherwise (`torch.nn.utils.clip_grad_norm_`
  divides by norm + 1e-6 and clips at norm <= max_norm);
- update n (0-based) uses the schedule's value at n: optax reads the
  count before the update;
- the update is -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), eps outside
  the square root after bias correction, weight decay on every parameter
  (biases and norm scales included), decoupled and scaled by the
  scheduled lr.

The schedule is evaluated in fp32 as optax evaluates it, so the learning
rates agree exactly.

The step reads nothing back from the device, as the JAX step does not:
the count is a device integer, and the learning rate and both bias
corrections come from a table on the device with one entry per count,
computed once on the host with the same fp32 expressions. `step(finite=)`
is JAX's guarded apply (`jnp.where(finite, new, old)` over params and
opt_state): where the device flag is false, parameters, both moments and
the count keep their values.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

Schedule = Callable[[int], float]


def _linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule: init + (end - init) * clip(count / T, 0, 1),
    rounded as optax's polynomial schedule rounds it in fp32."""
    if transition_steps <= 0:
        return lambda count: float(np.float32(init_value))

    def schedule(count: int) -> float:
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1.0) - c / np.float32(transition_steps)
        return float(np.float32(init_value - end_value) * frac + np.float32(end_value))

    return schedule


def onecycle_linear(
    peak_lr: float,
    total_steps: int,
    pct_start: float = 0.01,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Schedule:
    """torch's OneCycleLR(anneal_strategy="linear") as the JAX package joins
    it from two optax linear schedules: max_lr/25 -> max_lr over the first
    1% of steps, then linearly down to max_lr/(25*1e4) at the last step."""
    # torch reaches peak at step `pct_start*total - 1` and the floor exactly at
    # the last step (OneCycleLR phase arithmetic), hence the -1s.
    warmup_end = max(int(round(pct_start * total_steps)) - 1, 1)
    initial = peak_lr / div_factor
    final = initial / final_div_factor
    warmup = _linear_schedule(initial, peak_lr, warmup_end)
    decay = _linear_schedule(peak_lr, final, total_steps - 1 - warmup_end)
    return lambda step: warmup(step) if step < warmup_end else decay(step - warmup_end)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm).

    Under fsdp a gradient is a DTensor of which this rank holds one piece:
    each piece's sum of squares is all-reduced across its data mesh (one
    collective for all of them), the whole (replicated) tensors, equal on
    every rank, are counted once, and the per-tensor sums are added in
    the tensors' order, as without sharding: every rank gets the norm of
    the whole gradient and clips by it, and one rank's norm is the
    unsharded one bit for bit. On a spatial axis above 1 the ranks of a
    spatial group hold the same piece (the sharding engine summed it over
    them) and each sums over its own data group, so each piece counts
    once there too."""
    from raft_stereo_tpu_torch.parallel.sharding import is_sharded

    tensors = list(tensors)
    pieces = [t for t in tensors if is_sharded(t)]
    if not pieces:
        return torch.sqrt(sum(torch.sum(t * t) for t in tensors))
    import torch.distributed as dist

    reduced = torch.stack([torch.sum(t.to_local() * t.to_local()) for t in pieces])
    dist.all_reduce(reduced, group=pieces[0].device_mesh.get_group())
    sums = iter(reduced)
    return torch.sqrt(sum(next(sums) if is_sharded(t) else torch.sum(t * t) for t in tensors))


def step_table(schedule: Schedule, b1: float, b2: float, counts: int) -> np.ndarray:
    """(counts, 3) fp32: for each count n the update's learning rate
    schedule(n) and the bias corrections 1 - b1**(n+1), 1 - b2**(n+1) of
    the update that advances the count to n + 1, formed in fp32 as optax
    forms them."""
    table = np.empty((counts, 3), np.float32)
    for n in range(counts):
        c = np.float32(n + 1)
        table[n] = (np.float32(schedule(n)), np.float32(1.0) - np.float32(b1) ** c,
                    np.float32(1.0) - np.float32(b2) ** c)
    return table


def _upload(table: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host table on `device`; onto a card from pinned memory without
    blocking the host (no sync)."""
    t = torch.from_numpy(table)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class AdamW(torch.optim.Optimizer):
    """optax.chain(clip_by_global_norm(grad_clip_norm), adamw(schedule, b1,
    b2, eps, weight_decay)) over the parameters' `.grad`.

    `clip_grads_()` clips the gradients in place and returns their global
    norm before clipping; `step(finite=None)` applies one update at the
    schedule's value for the current count and advances the count. With
    `finite`, a 0-dim bool tensor on the parameters' device, the update
    lands only where it is true: where it is false, parameters, moments
    and count keep their values, as optax's state does when the JAX step
    keeps the old state. Nothing here reads the device: `count` (a
    property) does, for checkpoints and tests.

    `table_counts` sizes the device table of learning rates and bias
    corrections (`step_table`) at the start; the host knows a bound of
    the count (the updates dispatched since it was last set) and extends
    the table before the count could pass it.

    Under fsdp a parameter, its gradient and its moments are DTensors
    sharded alike (the moments are created `zeros_like` the parameter); the
    update runs on this rank's pieces. `full_state_dict()` gathers the
    state whole (collective) and `load_state_dict` re-shards a whole state
    into the parameters' layout, so a checkpoint moves between world
    sizes and presets."""

    def __init__(self, params, schedule: Schedule, grad_clip_norm: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-5, table_counts: int = 1):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay))
        if len(self.param_groups) != 1:
            raise ValueError("AdamW takes one parameter group (one count, one table)")
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        device = self.param_groups[0]["params"][0].device
        self._count = torch.zeros((), dtype=torch.int64, device=device)
        self._count_bound = 0  # the count is at most this (a host number)
        self._table = _upload(step_table(schedule, b1, b2, max(int(table_counts), 1)), device)

    @property
    def count(self) -> int:
        """Updates applied so far (reads the device)."""
        return int(self._count.item())

    @count.setter
    def count(self, value: int) -> None:
        self._count.fill_(int(value))
        self._count_bound = int(value)

    def _reserve(self, counts: int) -> None:
        """Make the device table cover counts 0 .. counts - 1."""
        if counts > self._table.shape[0]:
            group = self.param_groups[0]
            table = step_table(self.schedule, group["b1"], group["b2"], max(counts, 2 * self._table.shape[0]))
            self._table = _upload(table, self._table.device)

    @torch.no_grad()
    def clip_grads_(self) -> torch.Tensor:
        from raft_stereo_tpu_torch.parallel.sharding import local_tensor

        grads = [p.grad for group in self.param_groups for p in group["params"] if p.grad is not None]
        norm = global_norm(grads)
        for g in map(local_tensor, grads):
            g.copy_(torch.where(norm < self.grad_clip_norm, g, g / norm * self.grad_clip_norm))
        return norm

    @torch.no_grad()
    def step(self, closure=None, finite: Optional[torch.Tensor] = None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        from raft_stereo_tpu_torch.parallel.sharding import local_tensor

        group = self.param_groups[0]
        b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
        self._reserve(self._count_bound + 1)
        self._count_bound += 1
        # This count's row of the table: index_select reads the count on
        # the device (indexing by a tensor in Python would fetch it).
        lr, c1, c2 = torch.index_select(self._table, 0, self._count.reshape(1))[0]
        neg_lr = -lr
        for p in group["params"]:
            if p.grad is None:
                continue
            state = self.state[p]
            if not state:
                state["mu"] = torch.zeros_like(p)
                state["nu"] = torch.zeros_like(p)
            g, w = local_tensor(p.grad), local_tensor(p)
            m, v = local_tensor(state["mu"]), local_tensor(state["nu"])
            mu = (1 - b1) * g + b1 * m
            nu = (1 - b2) * (g * g) + b2 * v
            update = (mu / c1) / (torch.sqrt(nu / c2) + eps) + wd * w
            if finite is None:
                m.copy_(mu)
                v.copy_(nu)
                w.add_(neg_lr * update)
            else:
                m.copy_(torch.where(finite, mu, m))
                v.copy_(torch.where(finite, nu, v))
                w.copy_(torch.where(finite, w + neg_lr * update, w))
        self._count.add_(1 if finite is None else finite.to(torch.int64))
        return None

    def full_state_dict(self) -> dict:
        """`state_dict()` with every moment whole, as host copies (the
        checkpoint's layout at any world size). Collective under fsdp:
        every rank calls it at the same step."""
        from raft_stereo_tpu_torch.parallel.sharding import full_tensor

        sd = self.state_dict()
        sd["state"] = {i: {k: full_tensor(v).detach().to("cpu", copy=True) for k, v in st.items()}
                       for i, st in sd["state"].items()}
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        """torch's load, then each moment laid out as its parameter (whole,
        or this rank's piece under fsdp)."""
        from raft_stereo_tpu_torch.parallel.sharding import full_tensor, shard_as

        super().load_state_dict(state_dict)
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state.get(p)
                for k in ("mu", "nu"):
                    if state and k in state:
                        state[k] = shard_as(full_tensor(state[k]), p)


def make_optimizer(params, lr: float, num_steps: int, wdecay: float = 1e-5,
                   grad_clip_norm: float = 1.0) -> Tuple[AdamW, Schedule]:
    """The recipe's optimizer over `params` and its schedule, one-cycle over
    `num_steps + 100` (reference train_stereo.py:73-80)."""
    schedule = onecycle_linear(lr, num_steps + 100)
    return AdamW(params, schedule, grad_clip_norm=grad_clip_norm, weight_decay=wdecay,
                 table_counts=num_steps + 101), schedule
