"""Model-family registry.

Port of ``galvatron_tpu/models/registry.py``: ``llama``, ``gpt``, their
``_fa`` variants (the same families pinned to ``attn_impl="flash"``),
``bert`` (data kind ``lm``: the token stream), ``vit`` (``vision``: pixels
and class labels), ``t5`` (``seq2seq``: encoder and decoder token streams)
and ``swin`` (``vision``). T5 and Swin have their own parameter trees and
carry the reference's family hooks: a `build` constructor, the layer types
the search prices (`layer_configs_fn`), their profiler (`make_profiler`),
whether a layer-type boundary may fall inside a pipeline stage, and
whether their attention has a sequence to shard. Every family carries its
HF bridge (`convert_from_hf`, `export_to_hf`, `config_from_hf`: the
reference's hooks, ``tools/convert_checkpoint.py`` calls them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from galvatron_tpu_torch.models import bert, gpt, llama, swin, t5, vit


@dataclass(frozen=True)
class ModelFamily:
    name: str
    config_fn: Callable[..., Any]  # (model_size: str, **overrides) -> TransformerConfig
    meta_configs: Dict[str, dict]
    default_size: str
    # which input pipeline the train entry point wires up: "lm" (token
    # stream), "seq2seq" (encoder + decoder token streams) or "vision"
    # (pixels, labels)
    data_kind: str = "lm"
    # (cfg, hp, device, mode="train", transport="p2p") -> HybridParallelModel
    # for a family with its own tree (t5, swin)
    build: Optional[Callable] = None
    # (cfg) -> [{"hidden_size", "seq_len", "layer_num"}, ...]: the layer
    # types of the search's multi-layer-type path (t5 enc/dec, swin per stage)
    layer_configs_fn: Optional[Callable] = None
    # (cfg, model_name, args) -> the family's model profiler
    make_profiler: Optional[Callable] = None
    # whether a layer-type boundary may fall inside a pipeline stage (swin's
    # merges may; t5's encoder/decoder boundary must be a stage boundary)
    mid_stage_type_boundaries: bool = False
    # whether the attention has a sequence that cp / Ulysses can shard
    supports_sequence_sharding: bool = True
    # the HF bridge: (state_dict, cfg) -> the port's state dict; (params,
    # cfg) -> HF state-dict arrays; (config namespace, **overrides) -> cfg
    convert_from_hf: Optional[Callable] = None
    export_to_hf: Optional[Callable] = None
    config_from_hf: Optional[Callable] = None


def _fa(fn):
    """The config constructor pinned to the flash attention path (the
    reference's ``gpt_fa`` / ``llama_fa``)."""
    def cfg_fa(*args, **overrides):
        overrides.setdefault("attn_impl", "flash")
        return fn(*args, **overrides)
    return cfg_fa


def _build(cfg, hp, device, mode: str = "train", transport: str = "p2p"):
    """A family's own tree through the layout path: ``runtime.model_api``
    picks its model def from the config (``model_def``), the counterpart
    of the reference's ``construct_t5_model`` / ``construct_swin_model``."""
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model

    return construct_hybrid_parallel_model(cfg, hp, device, mode=mode, transport=transport)


def _profiler(name: str):
    def make(cfg, model_name, args):
        from galvatron_tpu_torch.profiler import model as P

        return getattr(P, name)(cfg, model_name, args)
    return make


_REGISTRY: Dict[str, ModelFamily] = {
    "gpt": ModelFamily(
        name="gpt",
        config_fn=gpt.gpt_config,
        meta_configs=gpt.META_CONFIGS,
        default_size="gpt-0.3b",
        data_kind="lm",
        convert_from_hf=gpt.convert_hf_gpt2,
        export_to_hf=gpt.export_hf_gpt2,
        config_from_hf=gpt.gpt_config_from_hf,
    ),
    "llama": ModelFamily(
        name="llama",
        config_fn=llama.llama_config,
        meta_configs=llama.META_CONFIGS,
        default_size="llama-0.3b",
        data_kind="lm",
        convert_from_hf=llama.convert_hf_llama,
        export_to_hf=llama.export_hf_llama,
        config_from_hf=llama.llama_config_from_hf,
    ),
    "gpt_fa": ModelFamily(
        name="gpt_fa",
        config_fn=_fa(gpt.gpt_config),
        meta_configs=gpt.META_CONFIGS,
        default_size="gpt-0.3b",
        convert_from_hf=gpt.convert_hf_gpt2,
        export_to_hf=gpt.export_hf_gpt2,
        config_from_hf=_fa(gpt.gpt_config_from_hf),
    ),
    "llama_fa": ModelFamily(
        name="llama_fa",
        config_fn=_fa(llama.llama_config),
        meta_configs=llama.META_CONFIGS,
        default_size="llama-0.3b",
        convert_from_hf=llama.convert_hf_llama,
        export_to_hf=llama.export_hf_llama,
        config_from_hf=_fa(llama.llama_config_from_hf),
    ),
    "bert": ModelFamily(
        name="bert",
        config_fn=bert.bert_config,
        meta_configs=bert.META_CONFIGS,
        default_size="bert-base",
        convert_from_hf=bert.convert_hf_bert,
        export_to_hf=bert.export_hf_bert,
        config_from_hf=bert.bert_config_from_hf,
    ),
    "vit": ModelFamily(
        name="vit",
        config_fn=vit.vit_config,
        meta_configs=vit.META_CONFIGS,
        default_size="vit-base",
        data_kind="vision",
        convert_from_hf=vit.convert_hf_vit,
        export_to_hf=vit.export_hf_vit,
        config_from_hf=vit.vit_config_from_hf,
    ),
    "t5": ModelFamily(
        name="t5",
        config_fn=t5.t5_config,
        meta_configs=t5.META_CONFIGS,
        default_size="t5-base",
        data_kind="seq2seq",
        build=_build,
        layer_configs_fn=t5.t5_layer_configs,
        make_profiler=_profiler("T5ModelProfiler"),
        convert_from_hf=t5.convert_hf_t5,
        export_to_hf=t5.export_hf_t5,
        config_from_hf=t5.t5_config_from_hf,
    ),
    "swin": ModelFamily(
        name="swin",
        config_fn=swin.swin_config,
        meta_configs=swin.META_CONFIGS,
        default_size="swin-tiny",
        data_kind="vision",
        build=_build,
        layer_configs_fn=swin.swin_layer_configs,
        make_profiler=_profiler("SwinModelProfiler"),
        mid_stage_type_boundaries=True,
        supports_sequence_sharding=False,
        convert_from_hf=swin.convert_hf_swin,
        export_to_hf=swin.export_hf_swin,
        config_from_hf=swin.swin_config_from_hf,
    ),
}


def get_family(name: str) -> ModelFamily:
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError("unknown model family %r; known: %s" % (name, family_names()))


def family_names():
    return sorted(_REGISTRY)
