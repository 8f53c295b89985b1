"""Model construction for one device.

Port of ``galvatron_tpu/runtime/model_api.construct_hybrid_parallel_model``
for world size 1: the strategy is checked for what this slice can execute,
and the returned model builds its parameters on the given device from a
``torch.Generator`` seeded by the caller. The per-layer tp/dp layouts (and
with them process groups, ZeRO and the train step) come with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from galvatron_tpu_torch.config.strategy import HybridParallelConfig
from galvatron_tpu_torch.models import base as M


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


def construct_hybrid_parallel_model(
    cfg: M.TransformerConfig,
    hp: HybridParallelConfig,
    device,
) -> HybridParallelModel:
    check_single_device(hp)
    return HybridParallelModel(cfg=cfg, hp=hp, device=torch.device(device))
