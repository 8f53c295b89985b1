"""Optimizer, learning-rate schedule and ZeRO state sharding.

Port of ``galvatron_tpu/runtime/optimizer.py``. The reference builds an
optax chain; this module computes the same chain with plain tensor code, in
place:

    clip_by_global_norm(clip_grad) -> scale_by_adam(b1, b2, eps)
    -> add_decayed_weights(weight_decay, no decay on biases and norm scales)
    -> scale_by_learning_rate(schedule)

and the same three schedules (optax's warmup-cosine, and linear or constant
after a linear warmup). As in optax, the learning rate of a step is read at
the count BEFORE the step increments it, so the first step takes
``schedule(0)`` (0.0 for the warmup schedules).

Under ZeRO-1/2/3 the Adam moments are sharded over the layer's dp axes
(`moment_dim`, the reference's ``_shard_moment_spec``): the update then runs
on each rank's shard, and the global norm of the clip is summed over the
shards (`AdamW.update`'s ``sumsq``), each element counted once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn


@dataclass
class OptimizerArgs:
    lr: float = 1e-4
    min_lr: float = 1e-5
    weight_decay: float = 0.01
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    clip_grad: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    lr_decay_style: str = "cosine"  # cosine | linear | constant


Schedule = Callable[[int], float]


# ------------------------------------------------------------------ schedules
def _linear_schedule(init: float, end: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over `transition_steps`, then end."""
    if transition_steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init - end) * frac + end
    return schedule


def _cosine_decay_schedule(init: float, decay_steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps, got "
                         "decay_steps=%d." % decay_steps)

    def schedule(count):
        cosine = 0.5 * (1 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init * ((1 - alpha) * cosine + alpha)
    return schedule


def _join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: past boundary i, schedule i+1 from step - boundary."""
    def schedule(step):
        out = schedules[0](step)
        for boundary, nxt in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = nxt(step - boundary)
        return out
    return schedule


def make_schedule(a: OptimizerArgs) -> Schedule:
    warm = _linear_schedule(0.0, a.lr, max(a.warmup_steps, 1))
    if a.lr_decay_style == "constant":
        return _join_schedules([warm, lambda count: a.lr], [a.warmup_steps])
    if a.lr_decay_style == "linear":
        decay = _linear_schedule(a.lr, a.min_lr, max(a.total_steps - a.warmup_steps, 1))
        return _join_schedules([warm, decay], [a.warmup_steps])
    # optax.warmup_cosine_decay_schedule(0, lr, warmup, total, end_value=min_lr)
    warmup, total = max(a.warmup_steps, 1), max(a.total_steps, 2)
    alpha = 0.0 if a.lr == 0.0 else a.min_lr / a.lr
    cosine = _cosine_decay_schedule(a.lr, total - warmup, alpha)
    return _join_schedules([warm, cosine], [warmup])


def weight_decay_mask(name: str) -> bool:
    """Megatron convention: biases and norm scales are not decayed. True
    when the parameter `name` (a state-dict path) IS decayed."""
    return not ({"bias", "scale"} & set(name.split(".")))


# ------------------------------------------------------------- state sharding
def moment_dim(spec: Sequence[Tuple[str, ...]], shape: Sequence[int], dp_size: int,
               zero_opt: bool, zero3: bool) -> Optional[int]:
    """ZeRO-1/2: the dim of a parameter's moments (and accumulated
    gradient) that the dp axes shard — the first dim that is unsharded
    and divisible by the dp degree. None keeps the parameter's own
    placement: pure DP, a ZeRO-3 parameter (already dp-sharded), or no dim
    divides (the reference never pads)."""
    if not zero_opt or zero3:
        return None
    for i, n in enumerate(shape):
        ax = spec[i] if i < len(spec) else ()
        if not ax and n % dp_size == 0:
            return i
    return None


def moment_spec(spec: Sequence[Tuple[str, ...]], ndim: int, dim: Optional[int],
                dp_axes: Tuple[str, ...]) -> Tuple[Tuple[str, ...], ...]:
    """The placement of the moments: the parameter's, with the dp axes on
    `dim` (the reference's ``_shard_moment_spec``)."""
    out = list(spec) + [()] * (ndim - len(spec))
    if dim is not None:
        out[dim] = tuple(dp_axes)
    return tuple(out)


# ------------------------------------------------------------------ the chain
@dataclass
class AdamState:
    """optax's ScaleByAdamState: the step count and the two moments, keyed
    by parameter name. The schedule reads the same count."""

    count: int = 0
    mu: Dict[str, torch.Tensor] = field(default_factory=dict)
    nu: Dict[str, torch.Tensor] = field(default_factory=dict)


class AdamW:
    """The reference's optax chain as one in-place update (see the module
    note). `update` consumes the accumulated gradients and returns their
    global norm before clipping."""

    def __init__(self, args: OptimizerArgs, schedule: Schedule):
        self.args = args
        self.schedule = schedule

    def init(self, params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> AdamState:
        named = _named(params)
        return AdamState(count=0,
                         mu={n: torch.zeros_like(p) for n, p in named},
                         nu={n: torch.zeros_like(p) for n, p in named})

    @torch.no_grad()
    def update(self, params: Union[nn.Module, Mapping[str, torch.Tensor]],
               grads: Dict[str, torch.Tensor], state: AdamState,
               sumsq: Optional[Callable[[Dict[str, torch.Tensor]], torch.Tensor]] = None,
               grad_norm: Optional[torch.Tensor] = None,
               grad_norm_value: Optional[float] = None) -> torch.Tensor:
        """Update `params` (a module, or name -> tensor views such as ZeRO
        shards) in place from `grads`; returns the global gradient norm
        before clipping. `sumsq` (grads -> the global sum of squares) is how
        a sharded layout counts every element once; by default the norm is
        over the given tensors. A caller that has the norm already passes
        it as `grad_norm`, and the clip reads it on the host unless it is
        given there too (`grad_norm_value`)."""
        a = self.args
        named = _named(params)
        if grad_norm is None and sumsq is None:
            grad_norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(grads[n].float()) for n, _ in named]))
        elif grad_norm is None:
            grad_norm = sumsq(grads).sqrt()
        clip_to = None
        if a.clip_grad and a.clip_grad > 0:
            norm = float(grad_norm) if grad_norm_value is None else grad_norm_value
            if not norm < a.clip_grad:
                clip_to = norm
        count = state.count + 1
        bc1, bc2 = 1 - a.adam_beta1 ** count, 1 - a.adam_beta2 ** count
        lr = self.schedule(state.count)
        for name, p in named:
            g = grads[name]
            if clip_to is not None:
                g = g / clip_to * a.clip_grad
            mu, nu = state.mu[name], state.nu[name]
            mu.mul_(a.adam_beta1).add_(g, alpha=1 - a.adam_beta1)
            nu.mul_(a.adam_beta2).addcmul_(g, g, value=1 - a.adam_beta2)
            upd = (mu / bc1).div_((nu / bc2).sqrt_().add_(a.adam_eps))
            if a.weight_decay and weight_decay_mask(name):
                upd.add_(p, alpha=a.weight_decay)
            p.add_(upd, alpha=-lr)
        state.count = count
        return grad_norm


def _named(params):
    if isinstance(params, nn.Module):
        return list(params.named_parameters())
    return list(params.items())


def get_optimizer_and_scheduler(args: Optional[OptimizerArgs] = None) -> Tuple[AdamW, Schedule]:
    a = args or OptimizerArgs()
    schedule = make_schedule(a)
    return AdamW(a, schedule), schedule
