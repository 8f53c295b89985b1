"""Optimizer and learning-rate schedule.

Port of ``galvatron_tpu/runtime/optimizer.py`` (the optimizer above the
sharding helpers, which have no counterpart on one device). The reference
builds an optax chain; this module computes the same chain with plain tensor
code, in place:

    clip_by_global_norm(clip_grad) -> scale_by_adam(b1, b2, eps)
    -> add_decayed_weights(weight_decay, no decay on biases and norm scales)
    -> scale_by_learning_rate(schedule)

and the same three schedules (optax's warmup-cosine, and linear or constant
after a linear warmup). As in optax, the learning rate of a step is read at
the count BEFORE the step increments it, so the first step takes
``schedule(0)`` (0.0 for the warmup schedules).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

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

    def init(self, params: nn.Module) -> AdamState:
        named = list(params.named_parameters())
        return AdamState(count=0,
                         mu={n: torch.zeros_like(p) for n, p in named},
                         nu={n: torch.zeros_like(p) for n, p in named})

    @torch.no_grad()
    def update(self, params: nn.Module, grads: Dict[str, torch.Tensor],
               state: AdamState) -> torch.Tensor:
        a = self.args
        named = list(params.named_parameters())
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(grads[n].float()) for n, _ in named]))
        clip_to = None
        if a.clip_grad and a.clip_grad > 0:
            norm = float(grad_norm)
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


def get_optimizer_and_scheduler(args: Optional[OptimizerArgs] = None) -> Tuple[AdamW, Schedule]:
    a = args or OptimizerArgs()
    schedule = make_schedule(a)
    return AdamW(a, schedule), schedule
