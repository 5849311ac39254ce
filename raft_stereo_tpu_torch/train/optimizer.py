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
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

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


class AdamW(torch.optim.Optimizer):
    """optax.chain(clip_by_global_norm(grad_clip_norm), adamw(schedule, b1,
    b2, eps, weight_decay)) over the parameters' `.grad`.

    `clip_grads_()` clips the gradients in place and returns their global
    norm before clipping; `step()` applies one update at the schedule's
    value for the current count and advances the count. A caller that
    drops a step calls neither `step()` nor anything else: parameters,
    moments and count stay as they were, as optax's state does when the
    JAX step keeps the old state.

    Under fsdp a parameter, its gradient and its moments are DTensors
    sharded alike (the moments are created `zeros_like` the parameter); the
    update runs on this rank's pieces. `full_state_dict()` gathers the
    state whole (collective) and `load_state_dict` re-shards a whole state
    into the parameters' layout, so a checkpoint moves between world
    sizes and presets."""

    def __init__(self, params, schedule: Schedule, grad_clip_norm: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-5):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay))
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.count = 0

    @torch.no_grad()
    def clip_grads_(self) -> torch.Tensor:
        from raft_stereo_tpu_torch.parallel.sharding import local_tensor

        grads = [p.grad for group in self.param_groups for p in group["params"] if p.grad is not None]
        norm = global_norm(grads)
        for g in map(local_tensor, grads):
            g.copy_(torch.where(norm < self.grad_clip_norm, g, g / norm * self.grad_clip_norm))
        return norm

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        from raft_stereo_tpu_torch.parallel.sharding import is_sharded, local_tensor

        lr = np.float32(self.schedule(self.count))
        self.count += 1
        for group in self.param_groups:
            b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
            # Bias corrections in fp32, as optax forms them from its count.
            c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(self.count))
            c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(self.count))
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                g, w = local_tensor(p.grad), local_tensor(p)
                mu = (1 - b1) * g + b1 * local_tensor(state["mu"])
                nu = (1 - b2) * (g * g) + b2 * local_tensor(state["nu"])
                if is_sharded(p):
                    local_tensor(state["mu"]).copy_(mu)
                    local_tensor(state["nu"]).copy_(nu)
                else:
                    state["mu"], state["nu"] = mu, nu
                update = (mu / c1) / (torch.sqrt(nu / c2) + eps) + wd * w
                w.add_(float(-lr) * update)
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
    return AdamW(params, schedule, grad_clip_norm=grad_clip_norm, weight_decay=wdecay), schedule
