"""HuggingFace checkpoint I/O shared by every family's converter.

The port's own copy of ``galvatron_tpu/models/hf_utils.py`` (`to_np`,
`linear`, `stack_qkv`: the slicing the reference's
``tools/checkpoint_convert_h2g.py`` shares), on torch tensors of any float
dtype or numpy arrays (the converters compute in torch, `to_t`, whose
copies run on every core; the exporters return numpy), and what the GPU
machine lacks without
``transformers`` and ``safetensors``:

- `read_hf_config`: a model directory's ``config.json`` as an attribute
  namespace, the keys the file leaves out (``save_pretrained`` writes only
  what differs from the family's defaults) filled from `HF_DEFAULTS`, the
  defaults of ``transformers``' config class of each family for the keys
  the families' ``*_config_from_hf`` read (and the values its constructor
  derives: LLaMA's kv heads, T5's decoder depth and gating);
- `read_safetensors` / `write_safetensors`: the format itself (an 8-byte
  little-endian header length, a JSON header of dtype, shape and byte
  offsets per tensor, then the raw buffer);
- `load_hf_state_dict`: a model directory, a torch ``.bin`` / ``.pt`` file
  or a ``.safetensors`` file. Sharded checkpoints (``*.index.json``) are
  not read, as in the reference.

Converters turn HF tensors to fp32 and export fp32 numpy, as the
reference's do.
"""

from __future__ import annotations

import json
import os
import struct
import types
from typing import Any, Dict, Mapping

import numpy as np
import torch


def to_np(t) -> np.ndarray:
    """torch tensor (any float dtype, any device) or array-like -> float32
    numpy (the exporters' arrays)."""
    if hasattr(t, "detach"):
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def to_t(t) -> torch.Tensor:
    """torch tensor (any float dtype, any device) or array-like -> a float32
    CPU tensor of its own (the converters' tensors: torch's copies and
    transposes run on every core, 1.9 B parameters' worth in seconds)."""
    if hasattr(t, "detach"):
        return t.detach().to("cpu", torch.float32, copy=True)
    return torch.from_numpy(np.array(t, np.float32))


def linear(state_dict, name):
    """torch Linear stores (out, in); the tree stores (in, out). Returns
    (kernel, bias)."""
    return to_t(state_dict[name + ".weight"]).T, to_t(state_dict[name + ".bias"])


def stack_qkv(state_dict, prefix, h, nh, hd, roles=("query", "key", "value")):
    """Separate q/k/v Linears -> fused head-major (h, 3, nh, hd) kernel +
    (3, nh, hd) bias."""
    ks, bs = [], []
    for role in roles:
        w, b = linear(state_dict, prefix + role)
        ks.append(w.reshape(h, nh, hd))
        bs.append(b.reshape(nh, hd))
    return torch.stack(ks, dim=1), torch.stack(bs, dim=0)


def to_state_dict(tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The converters' tensors -> the port's state dict: contiguous fp32 CPU
    tensors."""
    return {n: t.contiguous() for n, t in tree.items()}


def params_state(params) -> Dict[str, torch.Tensor]:
    """A module's parameters, or a state dict, by name."""
    if isinstance(params, torch.nn.Module):
        return {n: p.detach() for n, p in params.named_parameters()}
    return dict(params)


# ----------------------------------------------------------------- config.json
# per family: transformers' config-class defaults for the keys its
# `*_config_from_hf` reads (transformers 4.57: GPT2Config, LlamaConfig,
# BertConfig, ViTConfig, T5Config, SwinConfig)
HF_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "gpt": {"n_embd": 768, "n_head": 12, "n_layer": 12, "vocab_size": 50257,
            "n_positions": 1024, "layer_norm_epsilon": 1e-5},
    "llama": {"hidden_size": 4096, "num_attention_heads": 32, "num_hidden_layers": 32,
              "intermediate_size": 11008, "vocab_size": 32000,
              "max_position_embeddings": 2048, "tie_word_embeddings": False,
              "rms_norm_eps": 1e-6, "rope_theta": 10000.0},
    "bert": {"hidden_size": 768, "num_attention_heads": 12, "num_hidden_layers": 12,
             "vocab_size": 30522, "max_position_embeddings": 512, "intermediate_size": 3072,
             "type_vocab_size": 2, "layer_norm_eps": 1e-12},
    "vit": {"hidden_size": 768, "num_attention_heads": 12, "num_hidden_layers": 12,
            "intermediate_size": 3072, "image_size": 224, "patch_size": 16, "num_channels": 3,
            "layer_norm_eps": 1e-12},
    "t5": {"d_model": 512, "num_heads": 8, "num_layers": 6, "vocab_size": 32128, "d_kv": 64,
           "d_ff": 2048, "feed_forward_proj": "relu", "relative_attention_num_buckets": 32,
           "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-6,
           "tie_word_embeddings": True},
    "swin": {"embed_dim": 96, "depths": [2, 2, 6, 2], "num_heads": [3, 6, 12, 24],
             "image_size": 224, "patch_size": 4, "num_channels": 3, "window_size": 7,
             "mlp_ratio": 4.0, "qkv_bias": True, "layer_norm_eps": 1e-5},
}


class HFConfig(types.SimpleNamespace):
    """A config.json's keys as attributes; a key neither the file nor the
    family's defaults hold raises, naming it."""

    def __getattr__(self, key):
        if key.startswith("__"):
            raise AttributeError(key)
        raise AttributeError("config.json (%s) has no key %r, and the %s config gives it no "
                             "default" % (self.__dict__.get("_path"), key,
                                          self.__dict__.get("_family")))


def _derived(family: str, cfg: Dict[str, Any]) -> None:
    """What the family's config constructor derives from other keys."""
    if family == "llama" and cfg.get("num_key_value_heads") is None:
        cfg["num_key_value_heads"] = cfg["num_attention_heads"]
    if family == "t5":
        if cfg.get("num_decoder_layers") is None:
            cfg["num_decoder_layers"] = cfg["num_layers"]
        cfg.setdefault("is_gated_act", cfg["feed_forward_proj"].split("-")[0] == "gated")


def read_hf_config(path: str, family: str) -> HFConfig:
    """The ``config.json`` of a model directory (or the file itself) as the
    attribute namespace the family's ``*_config_from_hf`` reads."""
    base = family[:-3] if family.endswith("_fa") else family
    if base not in HF_DEFAULTS:
        raise KeyError("no HF config defaults for model family %r" % family)
    file = os.path.join(path, "config.json") if os.path.isdir(path) else path
    with open(file) as f:
        cfg = dict(HF_DEFAULTS[base], **json.load(f))
    _derived(base, cfg)
    return HFConfig(_path=file, _family=base, **cfg)


# ---------------------------------------------------------------- safetensors
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU, in file order."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(buf)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        if end == start:
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        size = torch.empty((), dtype=dtype).element_size()
        out[name] = torch.frombuffer(buf, dtype=dtype, count=(end - start) // size,
                                     offset=start).reshape(info["shape"])
    return out


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor]) -> None:
    """`tensors` (CPU or not, contiguous copies taken) as a ``.safetensors``
    file, the header padded with spaces to a multiple of 8 bytes."""
    names = {v: k for k, v in _ST_DTYPES.items()}
    header, offset, blobs = {}, 0, []
    for name, t in tensors.items():
        t = t.detach().to("cpu").contiguous()
        size = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        blobs.append(t.reshape(-1).view(torch.uint8).numpy())
        offset += size
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for b in blobs:
            f.write(memoryview(b))


def load_hf_state_dict(hf_path: str) -> Dict[str, torch.Tensor]:
    """A transformers model directory (``pytorch_model.bin`` or
    ``model.safetensors``), a torch ``.bin`` / ``.pt`` file or a
    ``.safetensors`` file -> its state dict."""
    if os.path.isdir(hf_path):
        for name in ("pytorch_model.bin", "model.safetensors"):
            cand = os.path.join(hf_path, name)
            if os.path.exists(cand):
                hf_path = cand
                break
        else:
            raise FileNotFoundError("no pytorch_model.bin / model.safetensors in %s" % hf_path)
    if hf_path.endswith(".safetensors"):
        return read_safetensors(hf_path)
    return torch.load(hf_path, map_location="cpu", weights_only=True, mmap=True)
