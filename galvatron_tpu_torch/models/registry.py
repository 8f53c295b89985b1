"""Model-family registry.

Port of ``galvatron_tpu/models/registry.py`` for the families the port
runs: ``llama``, ``gpt``, their ``_fa`` variants (the same families pinned
to ``attn_impl="flash"``), ``bert`` (data kind ``lm``: the token stream)
and ``vit`` (data kind ``vision``: pixels and class labels). The
reference's other families are known by name and refused with the slice
that brings them, so a typo and a family that is not ported yet fail
differently.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

from galvatron_tpu_torch.models import bert, gpt, llama, vit


@dataclass(frozen=True)
class ModelFamily:
    name: str
    config_fn: Callable[..., Any]  # (model_size: str, **overrides) -> TransformerConfig
    meta_configs: Dict[str, dict]
    default_size: str
    # which input pipeline the train entry point wires up: "lm" (token
    # stream) or "vision" (pixels, labels); the reference's "seq2seq" comes
    # with T5
    data_kind: str = "lm"


def _fa(fn):
    """The config constructor pinned to the flash attention path (the
    reference's ``gpt_fa`` / ``llama_fa``)."""
    def cfg_fa(*args, **overrides):
        overrides.setdefault("attn_impl", "flash")
        return fn(*args, **overrides)
    return cfg_fa


_REGISTRY: Dict[str, ModelFamily] = {
    "gpt": ModelFamily(
        name="gpt",
        config_fn=gpt.gpt_config,
        meta_configs=gpt.META_CONFIGS,
        default_size="gpt-0.3b",
        data_kind="lm",
    ),
    "llama": ModelFamily(
        name="llama",
        config_fn=llama.llama_config,
        meta_configs=llama.META_CONFIGS,
        default_size="llama-0.3b",
        data_kind="lm",
    ),
    "gpt_fa": ModelFamily(
        name="gpt_fa",
        config_fn=_fa(gpt.gpt_config),
        meta_configs=gpt.META_CONFIGS,
        default_size="gpt-0.3b",
    ),
    "llama_fa": ModelFamily(
        name="llama_fa",
        config_fn=_fa(llama.llama_config),
        meta_configs=llama.META_CONFIGS,
        default_size="llama-0.3b",
    ),
    "bert": ModelFamily(
        name="bert",
        config_fn=bert.bert_config,
        meta_configs=bert.META_CONFIGS,
        default_size="bert-base",
    ),
    "vit": ModelFamily(
        name="vit",
        config_fn=vit.vit_config,
        meta_configs=vit.META_CONFIGS,
        default_size="vit-base",
        data_kind="vision",
    ),
}

# families of the reference that a later slice of the port brings
_NOT_PORTED = ("t5", "swin")


def get_family(name: str) -> ModelFamily:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _NOT_PORTED:
        raise ValueError(
            "model family %r is not ported to galvatron_tpu_torch yet: the port "
            "trains the %s families; T5 and Swin, with their own parameter trees and "
            "pipelines, come with the next 'other families' slice (ROADMAP queue 1 "
            "item 9)" % (name, ", ".join(family_names())))
    raise KeyError("unknown model family %r; known: %s" % (name, family_names()))


def family_names():
    return sorted(_REGISTRY)
