"""Model-family registry.

Port of ``galvatron_tpu/models/registry.py`` for the families this slice
runs: ``llama``. The reference's other families are known by name and
refused with the slice that brings them, so a typo and a family that is not
ported yet fail differently.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

from galvatron_tpu_torch.models import llama


@dataclass(frozen=True)
class ModelFamily:
    name: str
    config_fn: Callable[..., Any]  # (model_size: str, **overrides) -> TransformerConfig
    meta_configs: Dict[str, dict]
    default_size: str


_REGISTRY: Dict[str, ModelFamily] = {
    "llama": ModelFamily(
        name="llama",
        config_fn=llama.llama_config,
        meta_configs=llama.META_CONFIGS,
        default_size="llama-0.3b",
    ),
}

# families of the reference that later slices of the port bring
_NOT_PORTED = ("gpt", "gpt_fa", "llama_fa", "bert", "vit", "t5", "swin")


def get_family(name: str) -> ModelFamily:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _NOT_PORTED:
        raise ValueError(
            "model family %r is not ported to galvatron_tpu_torch yet: this "
            "slice serves the 'llama' family; the other families come with "
            "the later 'other families' slice (ROADMAP queue 1)" % name)
    raise KeyError("unknown model family %r; known: %s" % (name, family_names()))


def family_names():
    return sorted(_REGISTRY)
