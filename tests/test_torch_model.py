"""Port parity, model: a tiny llama (MHA and GQA) with weights transplanted
from the JAX reference through the numpy bridge. layer_forward(return_kv),
run_layers(collect_kv), lm_logits and decode_layer_forward match the
reference in fp32 on the CPU. The "flash" config has head_dim 128 and a
sequence of 128, so the port's prefill attention takes the flash kernel's
plain version while the reference (off-TPU) takes its XLA path."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from galvatron_tpu.models import base as JM
from galvatron_tpu.models import llama as JL
from galvatron_tpu.serve import kv_cache as JK
from galvatron_tpu_torch.models import base as TM
from galvatron_tpu_torch.models import llama as TL
from galvatron_tpu_torch.ops import flash_attention as TF
from galvatron_tpu_torch.serve import kv_cache as TK
from galvatron_tpu_torch.tools.from_jax import params_from_numpy, params_to_numpy

_ATOL = 5e-5  # fp32 both sides; matmul and softmax sums reassociate

_CONFIGS = {
    "mha": dict(hidden_size=64, num_heads=4, ffn_hidden=128, seq=16),
    "gqa": dict(hidden_size=64, num_heads=4, num_kv_heads=2, ffn_hidden=128, seq=16),
    "flash_gqa": dict(hidden_size=256, num_heads=2, num_kv_heads=1, ffn_hidden=128, seq=128),
}


def make(name):
    kw = dict(_CONFIGS[name])
    seq = kw.pop("seq")
    common = dict(num_layers=2, vocab_size=64, max_seq_len=max(seq, 32), **kw)
    jcfg = JL.llama_config("llama-0.3b", compute_dtype=jnp.float32, **common)
    tcfg = TL.llama_config("llama-0.3b", compute_dtype=torch.float32, **common)
    tree = jax.device_get(JM.init_model_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    # non-trivial norm scales, so a norm wired to the wrong scale shows
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: (np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32) * 0.1
                         if "scale" in jax.tree_util.keystr(path) else np.asarray(a)),
        tree)
    params = TM.TransformerLM(tcfg, "cpu")
    params.load_state_dict(params_from_numpy(tree, "cpu"))
    return jcfg, tcfg, tree, params, seq


def _x(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(np.float32)


def _mask(b, s):
    mask = np.ones((b, s), np.float32)
    mask[1, s - s // 4:] = 0.0
    return mask


def test_bridge_round_trip_keeps_names_shapes_dtypes():
    _, tcfg, tree, params, _ = make("gqa")
    names = set(params.state_dict())
    assert {"embed.wte", "layers.0.ln1.scale", "layers.1.wq.kernel", "layers.1.wkv.kernel",
            "final_norm.scale", "lm_head.kernel"} <= names
    assert tuple(params.layers[0].wkv.kernel.shape) == (64, 2, 2, 16)
    assert tuple(params.layers[0].wi.kernel.shape) == (64, 2, 128)
    back = params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(p) for p, _ in flat_a] == [jax.tree_util.keystr(p) for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_init_builds_the_reference_tree_on_the_device():
    jcfg, tcfg, tree, _, _ = make("mha")
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = TM.init_model_params(tcfg, gen, "cpu")
    shapes = {k: tuple(v.shape) for k, v in params_from_numpy(tree).items()}
    assert {k: tuple(v.shape) for k, v in params.state_dict().items()} == shapes
    assert all(p.dtype == torch.float32 for p in params.parameters())
    assert torch.all(params.layers[0].ln1.scale == 1)
    std = params.layers[0].wqkv.kernel.std().item()
    assert abs(std - 0.02) < 0.004
    proj = params.layers[0].wo.kernel.std().item()
    assert abs(proj - 0.02 / 2.0) < 0.003  # init_std / sqrt(2 * num_layers)


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_layer_forward_with_kv_matches_reference(name):
    jcfg, tcfg, tree, params, s = make(name)
    b = 2
    x = _x((b, s, tcfg.hidden_size), 2)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    mask = _mask(b, s)
    jb = JM.padding_attn_bias(jnp.asarray(mask))
    want, (wk, wv) = JM.layer_forward(tree["layers"][0], jnp.asarray(x), jnp.asarray(pos), jcfg,
                                      attn_bias=jb, return_kv=True)
    with torch.no_grad():
        got, (gk, gv) = TM.layer_forward(params.layers[0], torch.from_numpy(x),
                                         torch.from_numpy(pos), tcfg,
                                         attn_bias=TM.padding_attn_bias(torch.from_numpy(mask)),
                                         return_kv=True)
    valid = mask > 0  # padded rows differ by design (segment ids vs bias)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=_ATOL)
    # k/v are projections of the layer input: every row agrees
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=_ATOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=_ATOL)


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_run_layers_collect_kv_and_lm_logits_match_reference(name):
    jcfg, tcfg, tree, params, s = make(name)
    b = 2
    tokens = np.random.default_rng(3).integers(0, 64, size=(b, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    mask = _mask(b, s)
    jx = JM.embed_tokens(tree["embed"], jnp.asarray(tokens), jnp.asarray(pos), jcfg)
    jx, jkvs = JM.run_layers(tree, jx, jnp.asarray(pos), jcfg,
                             attn_bias=JM.padding_attn_bias(jnp.asarray(mask)), collect_kv=True)
    want = JM.lm_logits(tree, jx, jcfg)
    flash0 = TF.flash_attention_fwd.launches
    with torch.no_grad():
        tx = TM.embed_tokens(params.embed, torch.from_numpy(tokens), torch.from_numpy(pos), tcfg)
        tx, tkvs = TM.run_layers(params, tx, torch.from_numpy(pos), tcfg,
                                 attn_bias=TM.padding_attn_bias(torch.from_numpy(mask)),
                                 collect_kv=True)
        got = TM.lm_logits(params, tx, tcfg)
    assert TF.flash_attention_fwd.launches == flash0  # CPU: plain version only
    valid = mask > 0
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=_ATOL)
    assert len(tkvs) == len(jkvs) == tcfg.num_layers
    for li, ((gk, gv), (wk, wv)) in enumerate(zip(tkvs, jkvs)):
        # layer 0's k/v see only embeddings; deeper layers see padded rows'
        # garbage, so compare the valid positions there
        rows = slice(None) if li == 0 else valid
        np.testing.assert_allclose(gk.numpy()[rows], np.asarray(wk)[rows], atol=_ATOL)
        np.testing.assert_allclose(gv.numpy()[rows], np.asarray(wv)[rows], atol=_ATOL)


@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_decode_layer_forward_matches_reference(name):
    jcfg, tcfg, tree, params, _ = make(name)
    slots, ctx = 3, 16
    nkv, hd = tcfg.num_kv_heads, tcfg.head_dim
    kc, vc = _x((slots, ctx, nkv, hd), 4), _x((slots, ctx, nkv, hd), 5)
    x = _x((slots, 1, tcfg.hidden_size), 6)
    lengths = np.array([3, 7, 15], np.int32)
    want, wk, wv = JM.decode_layer_forward(
        tree["layers"][1], jnp.asarray(x), jnp.asarray(lengths[:, None]), jcfg,
        k_cache=jnp.asarray(kc), v_cache=jnp.asarray(vc), write_index=jnp.asarray(lengths),
        attn_bias=JK.length_bias(jnp.asarray(lengths), ctx))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tl = torch.from_numpy(lengths)
    with torch.no_grad():
        got, gk, gv = TM.decode_layer_forward(
            params.layers[1], torch.from_numpy(x), tl[:, None], tcfg,
            k_cache=tk, v_cache=tv, write_index=tl, attn_bias=TK.length_bias(tl, ctx))
    assert gk is tk and gv is tv  # updated in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(wk), atol=_ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(wv), atol=_ATOL)


def test_decode_write_index_clamps_like_dynamic_update_slice():
    """An inactive slot whose frozen length lies past the bucket writes at
    the last column, as lax.dynamic_update_slice clamps it."""
    cache = torch.zeros(2, 4, 1, 2)
    new = torch.ones(2, 1, 1, 2)
    TM._append_token_kv(cache, new, torch.tensor([1, 9], dtype=torch.int32))
    want = JM._append_token_kv(jnp.zeros((2, 4, 1, 2)), jnp.ones((2, 1, 1, 2)),
                               jnp.asarray([1, 9], jnp.int32))
    np.testing.assert_array_equal(cache.numpy(), np.asarray(want))
