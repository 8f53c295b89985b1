"""BERT family: meta configs and the config constructor.

Port of ``galvatron_tpu/models/bert.py`` (META_CONFIGS, bert_config): a
post-norm bidirectional encoder (LayerNorm eps 1e-12 after each residual
add, exact gelu), learned positions and token-type embeddings summed and
normed before the first layer, and the MLM head (a dense transform, exact
gelu, LayerNorm, then the decoder tied to the token table plus a vocab
bias); vocab 30522, two token types. The HF converters
(``convert_hf_bert``/``export_hf_bert``) come with the checkpoint-conversion
slice (ROADMAP queue 1 item 9b)."""

from __future__ import annotations

from galvatron_tpu_torch.models.base import TransformerConfig

META_CONFIGS = {
    "bert-base": dict(hidden_size=768, num_heads=12, num_layers=12, max_seq_len=512),
    "bert-large": dict(hidden_size=1024, num_heads=16, num_layers=24, max_seq_len=512),
    "bert-huge-32": dict(hidden_size=1280, num_heads=16, num_layers=32, max_seq_len=512),
    "bert-huge-48": dict(hidden_size=1280, num_heads=16, num_layers=48, max_seq_len=512),
}


def bert_config(model_size: str = "bert-base", **overrides) -> TransformerConfig:
    base = dict(META_CONFIGS[model_size])
    base.update(
        vocab_size=30522,
        type_vocab_size=2,
        norm_type="layernorm",
        activation="gelu_exact",
        position_type="learned",
        causal=False,
        pre_norm=False,
        embed_norm=True,
        head_type="mlm",
        tie_embeddings=True,
        qkv_bias=True,
        mlp_bias=True,
        out_bias=True,
        layernorm_eps=1e-12,
    )
    base.update(overrides)
    return TransformerConfig(**base)
