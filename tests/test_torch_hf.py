"""Port parity, the HF bridge of every family (``models/hf_utils.py`` and
each family's ``*_config_from_hf`` / ``convert_hf_*`` / ``export_hf_*``)
on the CPU, from tiny seeded ``transformers`` models:

- each ``convert_hf_*`` equals the JAX package's of the same state dict,
  carried across by ``tools.from_jax``, bit for bit;
- ``export_hf_*(convert_hf_*(sd))`` gives back every HF parameter bit for
  bit (derived buffers aside);
- the converted model's logits match the ``transformers`` model's on one
  seeded batch in fp32 within LOGIT_TOL (GPT-2, LLaMA with and without
  GQA, BERT, ViT, T5 relu-tied and gated-gelu, Swin);
- ``read_hf_config`` of a ``config.json`` (as ``save_pretrained`` writes
  it: the defaulted keys left out; and with every key) gives the config
  the JAX package derives from the ``transformers`` config object, its
  defaults table holds ``transformers``' defaults, and a key with no
  default raises naming it;
- the safetensors reader equals ``safetensors.numpy.load_file``, and the
  writer's file reads back through it.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from galvatron_tpu_torch.models import hf_utils as H
from galvatron_tpu_torch.tools.from_jax import _flatten

transformers = pytest.importorskip("transformers")

# fp32 on both sides, the same products in other orders: the logits
# (|x| <= ~30) agree to a few ulps of their size. T5's gated-gelu MLP is
# exact gelu in both packages where HF's "gated-gelu" is its tanh
# approximation ("gelu_new"; with it the port is within 1.2e-5): that case
# is held to 5e-4 of the largest logit (2.1e-4 measured; a swapped gate
# and up projection is off by far more)
LOGIT_TOL = 1e-4
GELU_TANH_REL = 5e-4
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_module(family):
    import importlib

    return importlib.import_module("galvatron_tpu.models.%s" % family)


def _port_module(family):
    import importlib

    return importlib.import_module("galvatron_tpu_torch.models.%s" % family)


# family -> (port module name, transformers config, model class, the
# names of the three functions, extra config_from_hf kwargs)
CASES = {
    "gpt": ("gpt", lambda: transformers.GPT2Config(
        n_embd=64, n_head=4, n_layer=2, n_positions=64, vocab_size=128, attn_pdrop=0.0,
        embd_pdrop=0.0, resid_pdrop=0.0), "GPT2LMHeadModel", "gpt2", {}),
    "llama": ("llama", lambda: transformers.LlamaConfig(
        hidden_size=64, num_attention_heads=4, num_hidden_layers=2, intermediate_size=128,
        vocab_size=128, max_position_embeddings=64), "LlamaForCausalLM", "llama", {}),
    "llama_gqa": ("llama", lambda: transformers.LlamaConfig(
        hidden_size=64, num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
        intermediate_size=128, vocab_size=128, max_position_embeddings=64,
        rms_norm_eps=1e-5, rope_theta=5e5), "LlamaForCausalLM", "llama", {}),
    "bert": ("bert", lambda: transformers.BertConfig(
        hidden_size=64, num_attention_heads=4, num_hidden_layers=2, intermediate_size=128,
        vocab_size=128, max_position_embeddings=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0), "BertForMaskedLM", "bert", {}),
    "vit": ("vit", lambda: transformers.ViTConfig(
        hidden_size=64, num_attention_heads=4, num_hidden_layers=2, intermediate_size=128,
        image_size=32, patch_size=8, num_labels=10, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0), "ViTForImageClassification", "vit",
        {"num_classes": 10}),
    "t5_relu_tied": ("t5", lambda: transformers.T5Config(
        d_model=64, num_heads=4, d_kv=16, d_ff=128, num_layers=2, num_decoder_layers=2,
        vocab_size=128, dropout_rate=0.0, decoder_start_token_id=0),
        "T5ForConditionalGeneration", "t5", {}),
    "t5_gated_untied": ("t5", lambda: transformers.T5Config(
        d_model=64, num_heads=4, d_kv=16, d_ff=128, num_layers=2, num_decoder_layers=3,
        vocab_size=128, dropout_rate=0.0, feed_forward_proj="gated-gelu",
        tie_word_embeddings=False, decoder_start_token_id=0),
        "T5ForConditionalGeneration", "t5", {}),
    "swin": ("swin", lambda: transformers.SwinConfig(
        image_size=32, patch_size=4, embed_dim=16, depths=[2, 2], num_heads=[2, 4],
        window_size=4, mlp_ratio=2.0, num_labels=10, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, drop_path_rate=0.0),
        "SwinForImageClassification", "swin", {"num_classes": 10}),
}
# HF state-dict entries that are derived buffers, not parameters
_NON_PARAM = ("position_ids", "relative_position_index", "masked_bias", "inv_freq", ".attn.bias")


def _fns(mod, tag):
    return (getattr(mod, "%s_config_from_hf" % ("gpt" if tag == "gpt2" else tag)),
            getattr(mod, "convert_hf_%s" % tag), getattr(mod, "export_hf_%s" % tag))


@pytest.fixture(scope="module", params=sorted(CASES))
def hf_case(request, tmp_path_factory):
    """A seeded tiny HF model, its config.json written by save_pretrained
    (defaulted keys left out), and both packages' configs and trees."""
    name = request.param
    family, make_cfg, cls, tag, extra = CASES[name]
    hf_cfg = make_cfg()
    torch.manual_seed(sorted(CASES).index(name))
    hf = getattr(transformers, cls)(hf_cfg).eval()
    d = tmp_path_factory.mktemp(name)
    hf_cfg.to_json_file(str(d / "config.json"))
    sd = hf.state_dict()
    t_cfg_fn, t_conv, t_exp = _fns(_port_module(family), tag)
    j_cfg_fn, j_conv, _ = _fns(_jax_module(family), tag)
    tcfg = t_cfg_fn(H.read_hf_config(str(d), family), compute_dtype=torch.float32, **extra)
    jcfg = j_cfg_fn(hf_cfg, compute_dtype=jnp.float32, **extra)
    flat = {}
    _flatten(jax.device_get(j_conv(sd, jcfg)), "", flat)
    return dict(name=name, family=family, hf=hf, sd=sd, dir=str(d), hf_cfg=hf_cfg, tcfg=tcfg,
                jcfg=jcfg, params=t_conv(sd, tcfg), jax_params=flat, export=t_exp)


def test_convert_equals_the_jax_packages_bitwise(hf_case):
    got, want = hf_case["params"], hf_case["jax_params"]
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        assert got[n].dtype == torch.float32
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(w), err_msg=n)


def test_export_gives_back_every_hf_parameter_bitwise(hf_case):
    back, sd = hf_case["export"](hf_case["params"], hf_case["tcfg"]), hf_case["sd"]
    assert not [k for k in back if k not in sd]
    assert not [k for k in sd if k not in back and not any(t in k for t in _NON_PARAM)]
    for k, v in back.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, sd[k].numpy(), err_msg=k)


def test_the_port_model_tree_takes_the_converted_state_dict(hf_case):
    from galvatron_tpu_torch.runtime.model_api import model_def
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig

    cfg = hf_case["tcfg"]
    tree = model_def(cfg, HybridParallelConfig.uniform(1, cfg.num_layers)).tree("meta")
    assert {n: tuple(p.shape) for n, p in tree.named_parameters()} == {
        n: tuple(t.shape) for n, t in hf_case["params"].items()}


def _logits(case):
    """(port logits, transformers logits) on one seeded batch."""
    from galvatron_tpu_torch.models import base as TM
    from galvatron_tpu_torch.runtime.model_api import model_def
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig

    cfg, hf, family = case["tcfg"], case["hf"], case["family"]
    model = model_def(cfg, HybridParallelConfig.uniform(1, cfg.num_layers)).tree("cpu")
    model.load_state_dict(case["params"])
    rng = np.random.RandomState(0)
    with torch.no_grad():
        if family in ("vit", "swin"):
            pixels = rng.randn(B, 3, 32, 32).astype(np.float32)
            want = hf(torch.from_numpy(pixels)).logits
            nhwc = torch.from_numpy(pixels.transpose(0, 2, 3, 1).copy())
            if family == "swin":
                from galvatron_tpu_torch.models.swin import swin_forward
                return swin_forward(model, nhwc, cfg), want
            return TM.model_forward(model, nhwc, None, cfg), want
        tokens = torch.from_numpy(rng.randint(0, 128, (B, S)))
        if family == "t5":
            from galvatron_tpu_torch.models.t5 import t5_forward

            dec = torch.from_numpy(rng.randint(0, 128, (B, S // 2)))
            mask = torch.ones(B, S, dtype=torch.int64)
            mask[1, S - 5:] = 0
            want = hf(input_ids=tokens, attention_mask=mask, decoder_input_ids=dec).logits
            got = t5_forward(model, {"tokens": tokens, "dec_tokens": dec,
                                     "attn_mask": mask.float()}, cfg)
            return got, want
        positions = torch.arange(S).expand(B, S)
        if family == "bert":
            types = torch.from_numpy(rng.randint(0, 2, (B, S)))
            want = hf(tokens, token_type_ids=types).logits
            return TM.model_forward(model, tokens, positions, cfg, token_type_ids=types), want
        return TM.model_forward(model, tokens, positions, cfg), hf(tokens).logits


def test_converted_model_logits_match_transformers(hf_case):
    got, want = _logits(hf_case)
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    if getattr(hf_case["tcfg"], "activation", None) == "gated-gelu":
        assert err <= GELU_TANH_REL * float(want.abs().max()), (hf_case["name"], err)
    else:
        assert err <= LOGIT_TOL, (hf_case["name"], err)


# -------------------------------------------------------------- config.json
def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in ("compute_dtype", "param_dtype")}


def test_config_reader_gives_the_jax_packages_config(hf_case, tmp_path):
    """The file transformers writes, the full one and one with every key
    that holds its default value removed all give the JAX package's config
    of the transformers object."""
    want = _fields(hf_case["jcfg"])
    assert _fields(hf_case["tcfg"]) == want
    family, _, _, tag, extra = CASES[hf_case["name"]]
    cfg_fn = _fns(_port_module(family), tag)[0]
    full = tmp_path / "config.json"
    hf_case["hf_cfg"].to_json_file(str(full), use_diff=False)
    assert _fields(cfg_fn(H.read_hf_config(str(full), family), **extra)) == want
    written = json.loads(full.read_text())
    # and the keys the config class derives where the file leaves them out
    derived = {"num_key_value_heads": "num_attention_heads", "num_decoder_layers": "num_layers"}
    dropped = [k for k, v in H.HF_DEFAULTS[family].items()
               if json.loads(json.dumps(v)) == written.get(k)] + ["is_gated_act"] + [
        k for k, src in derived.items() if k in written and written[k] == written.get(src)]
    assert dropped, "no key of the test holds its default"
    full.write_text(json.dumps({k: v for k, v in written.items() if k not in dropped}))
    assert _fields(cfg_fn(H.read_hf_config(str(full), family), **extra)) == want


@pytest.mark.parametrize("family,cls", [("gpt", "GPT2Config"), ("llama", "LlamaConfig"),
                                        ("bert", "BertConfig"), ("vit", "ViTConfig"),
                                        ("t5", "T5Config"), ("swin", "SwinConfig")])
def test_defaults_table_holds_the_transformers_defaults(family, cls, tmp_path):
    hf = getattr(transformers, cls)()
    for key, value in H.HF_DEFAULTS[family].items():
        got = getattr(hf, key)
        assert (list(got) if isinstance(got, (list, tuple)) else got) == value, (key, got)
    (tmp_path / "config.json").write_text(json.dumps({"model_type": hf.model_type}))
    ns = H.read_hf_config(str(tmp_path), family)
    derived = {"llama": ("num_key_value_heads",), "t5": ("num_decoder_layers", "is_gated_act")}
    for key in derived.get(family, ()):
        assert getattr(ns, key) == getattr(hf, key), key
    with pytest.raises(AttributeError, match="'no_such_key'"):
        ns.no_such_key


def test_a_save_pretrained_directory_reads_back(tmp_path):
    """``save_pretrained`` in both weight formats: ``load_hf_state_dict``
    gives its state dict, ``read_hf_config`` its config."""
    from galvatron_tpu.models.llama import llama_config_from_hf as jax_cfg
    from galvatron_tpu_torch.models.llama import llama_config_from_hf

    hf_cfg = CASES["llama_gqa"][1]()
    torch.manual_seed(11)
    hf = transformers.LlamaForCausalLM(hf_cfg)
    sd = hf.state_dict()
    for safe in (False, True):
        d = str(tmp_path / str(safe))
        hf.save_pretrained(d, safe_serialization=safe)
        got = H.load_hf_state_dict(d)
        assert sorted(got) == sorted(k for k in sd if "rotary" not in k)
        for k, v in got.items():
            assert torch.equal(v, sd[k]), k
        assert _fields(llama_config_from_hf(H.read_hf_config(d, "llama"))) == _fields(
            jax_cfg(hf_cfg))


# ------------------------------------------------------------- safetensors
def test_safetensors_reader_and_writer_match_the_safetensors_package(tmp_path):
    from safetensors.numpy import load_file, save_file

    rng = np.random.RandomState(0)
    arrays = {"a.weight": rng.randn(3, 5).astype(np.float32),
              "b": rng.randint(-9, 9, (7,)).astype(np.int8),
              "c.bias": rng.randn(4).astype(np.float16),
              "d": rng.randint(0, 9, (2, 3, 2)).astype(np.int64), "e": np.zeros((0, 3), np.float32)}
    save_file(arrays, str(tmp_path / "np.safetensors"), metadata={"format": "np"})
    got = H.read_safetensors(str(tmp_path / "np.safetensors"))
    want = load_file(str(tmp_path / "np.safetensors"))
    assert list(got) == sorted(want) or sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    bf16 = torch.randn(6, 4).to(torch.bfloat16)
    H.write_safetensors(str(tmp_path / "port.safetensors"), {"x": bf16, "y": torch.arange(5)})
    back = load_file(str(tmp_path / "port.safetensors"))
    np.testing.assert_array_equal(back["y"], np.arange(5))
    assert torch.equal(H.read_safetensors(str(tmp_path / "port.safetensors"))["x"], bf16)
    assert torch.equal(H.load_hf_state_dict(str(tmp_path / "port.safetensors"))["x"], bf16)
