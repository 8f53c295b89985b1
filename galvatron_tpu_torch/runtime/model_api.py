"""Model construction and the train step for one device.

Port of ``galvatron_tpu/runtime/model_api.py`` for world size 1: the
strategy is checked for what the port can execute, the returned model builds
its parameters on the given device from a ``torch.Generator`` seeded by the
caller, and `make_train_step` runs the reference's step: per-microbatch
loss and gradients (chunked accumulation weighted by each microbatch's share
of the valid tokens), then the optimizer chain. The per-layer tp/dp layouts
(and with them process groups and ZeRO) come with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

from galvatron_tpu_torch.config.strategy import HybridParallelConfig
from galvatron_tpu_torch.models import base as M
from galvatron_tpu_torch.runtime.optimizer import AdamState, AdamW


def check_single_device(hp: HybridParallelConfig) -> None:
    """Raise ValueError unless `hp` is a layout this slice executes: world
    size 1, so pp = tp = cp = 1 and no Ulysses sp on any layer."""
    problems = []
    if hp.world_size != 1:
        problems.append("world_size=%d" % hp.world_size)
    if hp.pp > 1:
        problems.append("pp=%d" % hp.pp)
    for name in ("tp", "cp", "sp"):
        degrees = sorted({getattr(s, name) for s in hp.layers})
        if any(d > (0 if name == "sp" else 1) for d in degrees):
            problems.append("%s=%s" % (name, degrees))
    if hp.vocab_tp > 1 or hp.vocab_cp > 1 or hp.vocab_sp:
        problems.append("vocab tp/cp/sp=%d/%d/%d" % (hp.vocab_tp, hp.vocab_cp, hp.vocab_sp))
    if problems:
        raise ValueError(
            "galvatron_tpu_torch runs world size 1 only in this slice; the "
            "strategy asks for %s (the tp/dp layouts come in a later slice)"
            % ", ".join(problems))


@dataclass
class HybridParallelModel:
    cfg: M.TransformerConfig
    hp: HybridParallelConfig
    device: torch.device

    def init_params(self, seed: int) -> M.TransformerLM:
        """Fresh parameters on `self.device`, drawn from a torch.Generator
        seeded with `seed`."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return M.init_model_params(self.cfg, gen, self.device)

    def loss_fn(self, params: M.TransformerLM, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return M.lm_loss_fn(params, batch, self.cfg, self.hp)

    def init_opt_state(self, tx: AdamW, params: M.TransformerLM) -> AdamState:
        return tx.init(params)

    def make_train_step(self, tx: AdamW, *, guard_anomalies: bool = False,
                        sdc_check: str = "off") -> Callable:
        """The (params, opt_state, batch) -> (params, opt_state, metrics)
        step; params and opt_state are updated in place and returned.
        metrics = {"loss", "grad_norm"}: the step's loss and the global norm
        of the accumulated gradients before clipping, as device scalars.
        The anomaly guard, the silent-corruption sentinel and the quantized
        gradient sync are refused until their slices are ported."""
        if guard_anomalies:
            raise ValueError("guard_anomalies is not ported yet: the anomaly guard comes "
                             "with the resilience slice of galvatron_tpu_torch")
        if sdc_check != "off":
            raise ValueError("sdc_check=%r is not ported yet: the silent-corruption "
                             "sentinel comes with the resilience slice" % sdc_check)
        if any(s.grad_comm_dtype != "none" or s.param_comm_dtype != "none"
               for s in self.hp.layers):
            raise ValueError("quantized gradient/parameter sync is not ported yet: it "
                             "comes with the data-parallel slice of galvatron_tpu_torch")
        chunks = self.hp.chunks

        def train_step(params, opt_state, batch):
            for p in params.parameters():
                p.grad = None
            if chunks == 1:
                loss = self.loss_fn(params, batch)
                loss.backward()
                loss = loss.detach()
            else:
                mbs = {k: v.reshape((chunks, v.shape[0] // chunks) + tuple(v.shape[1:]))
                       for k, v in batch.items()}
                # each microbatch loss is a mean over its own valid tokens:
                # weight it by its share of the step's valid tokens, so the
                # chunked objective equals the chunks == 1 one
                if "loss_mask" in batch:
                    sums = mbs["loss_mask"].float().sum(dim=tuple(range(1, mbs["loss_mask"].dim())))
                    weights = sums / sums.sum().clamp(min=1.0)
                else:
                    weights = torch.full((chunks,), 1.0 / chunks, device=batch["tokens"].device)
                loss = torch.zeros((), device=batch["tokens"].device)
                for c in range(chunks):
                    mb_loss = self.loss_fn(params, {k: v[c] for k, v in mbs.items()})
                    (mb_loss * weights[c]).backward()
                    loss = loss + mb_loss.detach() * weights[c]
            grads = {n: p.grad for n, p in params.named_parameters()}
            grad_norm = tx.update(params, grads, opt_state)
            for p in params.parameters():
                p.grad = None
            return params, opt_state, {"loss": loss, "grad_norm": grad_norm}

        return train_step


def construct_hybrid_parallel_model(
    cfg: M.TransformerConfig,
    hp: HybridParallelConfig,
    device,
) -> HybridParallelModel:
    check_single_device(hp)
    return HybridParallelModel(cfg=cfg, hp=hp, device=torch.device(device))
