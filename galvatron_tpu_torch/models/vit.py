"""ViT family: meta configs and the config constructor.

Port of ``galvatron_tpu/models/vit.py`` (META_CONFIGS, vit_config): a
pre-norm bidirectional encoder over 16x16 patches of a 224x224 RGB image
(196 patches and a cls token: 197 positions), LayerNorm eps 1e-12, exact
gelu, learned positions, and a classification head over 1000 classes on
the cls token after the final norm. The patch convolution is a dense on
patchified pixels (``models.base.patchify``). The HF converters
(``convert_hf_vit``/``export_hf_vit``) come with the checkpoint-conversion
slice (ROADMAP queue 1 item 9b)."""

from __future__ import annotations

from galvatron_tpu_torch.models.base import TransformerConfig

META_CONFIGS = {
    "vit-base": dict(hidden_size=768, num_heads=12, num_layers=12),
    "vit-large": dict(hidden_size=1024, num_heads=16, num_layers=24),
    "vit-huge": dict(hidden_size=1280, num_heads=16, num_layers=32),
    "vit-xhuge": dict(hidden_size=2560, num_heads=32, num_layers=36),
}


def vit_config(model_size: str = "vit-base", **overrides) -> TransformerConfig:
    base = dict(META_CONFIGS[model_size])
    base.update(
        vocab_size=1,  # unused for patch input
        num_classes=1000,
        image_size=224,
        patch_size=16,
        num_channels=3,
        input_type="patches",
        use_cls_token=True,
        head_type="classification",
        pool_type="cls",
        norm_type="layernorm",
        activation="gelu_exact",
        position_type="learned",
        causal=False,
        pre_norm=True,
        tie_embeddings=False,
        qkv_bias=True,
        mlp_bias=True,
        out_bias=True,
        layernorm_eps=1e-12,
    )
    base.update(overrides)
    return TransformerConfig(**base)
