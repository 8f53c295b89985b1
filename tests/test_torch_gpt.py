"""Port parity, the GPT-2 family: the presets, the weights transplanted from
the JAX package's tree (biases, the LayerNorm bias, the learned position
table, the head tied to the embedding), logits with and without key padding
(the "flash" config takes the flash kernel's plain version), greedy serve
tokens through prefill and decode (learned positions in decode), the FLOPs
count, a world-1 train run through the layout path with ZeRO-3 and ZeRO-2
against optax, and the flash route of Megatron-TP head slices at GPT-6.7B
width — all fp32 on the CPU."""

import dataclasses

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from galvatron_tpu.config.strategy import HybridParallelConfig as JHP
from galvatron_tpu.config.strategy import LayerStrategy as JLS
from galvatron_tpu.models import base as JM
from galvatron_tpu.models import gpt as JG
from galvatron_tpu.obs import flops as JFL
from galvatron_tpu.runtime import dataloader as JD
from galvatron_tpu.runtime import model_api as JAPI
from galvatron_tpu.runtime import optimizer as JO
from galvatron_tpu.serve import engine as JE
from galvatron_tpu.serve import kv_cache as JK
from galvatron_tpu_torch.config.strategy import HybridParallelConfig as THP
from galvatron_tpu_torch.config.strategy import LayerStrategy as TLS
from galvatron_tpu_torch.models import base as TM
from galvatron_tpu_torch.models import gpt as TG
from galvatron_tpu_torch.models.registry import get_family
from galvatron_tpu_torch.obs import flops as TFL
from galvatron_tpu_torch.ops import flash_attention as TF
from galvatron_tpu_torch.runtime import dataloader as TD
from galvatron_tpu_torch.runtime import distributed as TDIST
from galvatron_tpu_torch.runtime import model_api as TAPI
from galvatron_tpu_torch.runtime import optimizer as TO
from galvatron_tpu_torch.serve import engine as TE
from galvatron_tpu_torch.serve import kv_cache as TK
from galvatron_tpu_torch.tools.from_jax import (
    adam_state_to_numpy,
    params_from_numpy,
    params_to_numpy,
)

_ATOL = 5e-5  # fp32 both sides

_CONFIGS = {
    "tiny": dict(hidden_size=64, num_heads=4, num_layers=2, vocab_size=96, max_seq_len=32),
    # head_dim 128, sequence 128: prefill attention takes the flash route
    "flash": dict(hidden_size=256, num_heads=2, num_layers=2, vocab_size=64, max_seq_len=256),
}


@pytest.fixture
def one_rank_group():
    """The train step runs the layout path through one-rank groups of a
    default process group that the caller owns, as `cli train` does."""
    with TDIST.process_group("cpu"):
        yield


def make(name, seed=0):
    kw = _CONFIGS[name]
    jcfg = JG.gpt_config("gpt-0.3b", compute_dtype=jnp.float32, **kw)
    tcfg = TG.gpt_config("gpt-0.3b", compute_dtype=torch.float32, **kw)
    tree = jax.device_get(JM.init_model_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    # non-zero biases and norm scales, so a branch wired to the wrong one shows
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: (np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32) * 0.05
                         if any(k in jax.tree_util.keystr(path) for k in ("bias", "scale"))
                         else np.asarray(a)),
        tree)
    params = TM.TransformerLM(tcfg, "cpu")
    params.load_state_dict(params_from_numpy(tree, "cpu"))
    return jcfg, tcfg, tree, params


@pytest.mark.parametrize("size", sorted(JG.META_CONFIGS))
def test_gpt_presets_match_reference(size):
    j, t = JG.gpt_config(size), TG.gpt_config(size)
    skip = {"compute_dtype", "param_dtype"}
    assert {f.name: getattr(t, f.name) for f in dataclasses.fields(t) if f.name not in skip} == \
        {f.name: getattr(j, f.name) for f in dataclasses.fields(j) if f.name not in skip}
    assert (t.norm_type, t.activation, t.position_type, t.tie_embeddings, t.vocab_size,
            t.layernorm_eps) == ("layernorm", "gelu", "learned", True, 50257, 1e-5)


def test_gpt_tree_crosses_the_bridge_with_every_leaf():
    """The reference's GPT tree: qkv/out/mlp biases, LayerNorm biases, the
    position table, no separate head (tied)."""
    _, tcfg, tree, params = make("tiny")
    names = set(dict(params.named_parameters()))
    assert {"embed.wpe", "layers.0.wqkv.bias", "layers.0.wo.bias", "layers.0.wi.bias",
            "layers.0.wo_mlp.bias", "layers.0.ln1.bias", "final_norm.bias"} <= names
    assert not any(n.startswith("lm_head") for n in names)
    back = params_to_numpy(params)
    jax.tree.map(np.testing.assert_array_equal, back, tree)


@pytest.mark.parametrize("name", sorted(_CONFIGS))
@pytest.mark.parametrize("padded", [False, True])
def test_gpt_logits_match_reference(name, padded):
    jcfg, tcfg, tree, params = make(name)
    s = 128 if name == "flash" else 16
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, (2, s))
    mask = np.ones((2, s), np.float32)
    if padded:
        mask[1, s - s // 4:] = 0.0
    pos = np.broadcast_to(np.arange(s), (2, s))
    want = JM.model_forward(tree, jnp.asarray(tokens), jnp.asarray(pos), jcfg,
                            attn_mask=jnp.asarray(mask) if padded else None)
    n_fwd = TF.flash_attention_fwd.launches
    with torch.no_grad():
        got = TM.model_forward(params, torch.from_numpy(tokens), torch.from_numpy(pos.copy()), tcfg,
                               attn_mask=torch.from_numpy(mask) if padded else None)
    assert TF.flash_attention_fwd.launches == n_fwd  # plain versions on the CPU
    valid = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=_ATOL)


def test_gpt_greedy_serve_tokens_match_reference():
    jcfg, tcfg, tree, params = make("tiny", seed=5)
    kv_j = JK.KVCacheConfig(max_slots=2, page_size=8, max_pages=4)
    kv_t = TK.KVCacheConfig(max_slots=2, page_size=8, max_pages=4)
    kw = dict(vocab_size=jcfg.vocab_size, seed=3, prompt_len_range=(3, 14), max_new_tokens=6)
    jb = JE.ContinuousBatcher(JE.ServeEngine(jcfg, tree, kv_j), kv_j)
    tb = TE.ContinuousBatcher(TE.ServeEngine(tcfg, params, kv_t, device="cpu"), kv_t)
    jdone = {r.rid: [int(t) for t in r.output] for r in jb.run(JE.synthetic_requests(5, **kw))}
    tdone = {r.rid: [int(t) for t in r.output] for r in tb.run(TE.synthetic_requests(5, **kw))}
    assert len(tdone) == 5 and tdone == jdone


def test_gpt_serve_cli_runs_at_world_one():
    from galvatron_tpu_torch.cli import serve as S

    summary = S.main([
        "--model_type", "gpt", "--set_model_config_manually", "1", "--hidden_size", "64",
        "--num_attention_heads", "4", "--num_layers", "2", "--vocab_size", "96",
        "--seq_length", "64", "--device", "cpu", "--serve_max_concurrency", "2",
        "--serve_page_size", "16", "--num_requests", "3", "--max_new_tokens", "3"])
    assert summary["requests"] == 3


def test_gpt_flops_match_reference():
    for size in ("gpt-0.3b", "gpt-6.7b"):
        j, t = JG.gpt_config(size), TG.gpt_config(size)
        assert TFL.train_step_flops(t, 8) == JFL.train_step_flops(j, 8)
        assert TFL.model_fwd_flops(t, 2) == JFL.model_fwd_flops(j, 2)


def test_gpt_registry_entry():
    fam = get_family("gpt")
    assert fam.default_size == "gpt-0.3b" and fam.data_kind == "lm"
    assert fam.config_fn("gpt-6.7b").hidden_size == 4096
    assert get_family("gpt_fa").config_fn("gpt-0.3b").attn_impl == "flash"
    assert fam.build is None and fam.layer_configs_fn is None  # the generic tree
    with pytest.raises(KeyError, match="unknown model family"):
        get_family("gpt3")


@pytest.mark.usefixtures("one_rank_group")
def test_gpt_world_one_layout_train_steps_with_zero3_and_zero2_match_optax():
    """Five steps at world size 1 through the layout path (one-rank groups:
    ZeRO-3 gathers and reduce-scatters, ZeRO-2 shards and re-gathers)
    against the reference's jitted step: losses, grad norms, params and Adam
    moments."""
    jcfg, tcfg, tree, params = make("tiny", seed=2)
    layers = [dict(fsdp=1, checkpoint=1), dict()]
    hp_j = JHP(world_size=1, pp=1, layers=[JLS(**s) for s in layers], global_bsz=4, chunks=2,
               default_dp_type="zero2")
    hp_t = THP(world_size=1, pp=1, layers=[TLS(**s) for s in layers], global_bsz=4, chunks=2,
               default_dp_type="zero2")
    oargs = dict(lr=2e-3, min_lr=2e-4, warmup_steps=2, total_steps=10)
    jmodel = JAPI.construct_hybrid_parallel_model(jcfg, hp_j)
    tx, _ = JO.get_optimizer_and_scheduler(JO.OptimizerArgs(**oargs))
    jparams = jax.device_put(tree, jmodel.shardings())
    jstate = jmodel.init_opt_state(tx, jparams)
    jstep = jmodel.make_train_step(tx, donate=False)
    tmodel = TAPI.construct_hybrid_parallel_model(tcfg, hp_t, "cpu")
    assert {n for n, pl in tmodel.param_layouts.items() if pl.z3_dim is not None} == {
        "layers.0.%s" % n for n in ("ln1.scale", "ln1.bias", "ln2.scale", "ln2.bias",
                                    "wqkv.kernel", "wo.kernel", "wo.bias", "wi.kernel",
                                    "wo_mlp.kernel", "wo_mlp.bias")}
    ttx, _ = TO.get_optimizer_and_scheduler(TO.OptimizerArgs(**oargs))
    tparams = tmodel.shard_params(dict(params.named_parameters()))
    tstate = tmodel.init_opt_state(ttx, tparams)
    tstep = tmodel.make_train_step(ttx)
    jdata = JD.get_train_iterator(hp_j, jcfg.vocab_size, jcfg.max_seq_len, seed=7)
    tdata = TD.get_train_iterator(hp_t, tcfg.vocab_size, tcfg.max_seq_len, seed=7)
    for _ in range(5):
        jparams, jstate, jm = jstep(jparams, jstate, next(jdata))
        tparams, tstate, tm = tstep(tparams, tstate, next(tdata))
        assert abs(tm["loss"].item() - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
        assert abs(tm["grad_norm"].item() - float(jm["grad_norm"])) <= 1e-4 * float(jm["grad_norm"])
    adam = next(s for s in jstate if isinstance(s, optax.ScaleByAdamState))
    count, mu, nu = adam_state_to_numpy(tstate[0])
    assert count == 5
    for got, want, tol in ((params_to_numpy(tparams[0]), jparams, 1e-4), (mu, adam.mu, 1e-4),
                           (nu, adam.nu, 1e-4)):
        gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jax.device_get(want))
        scale = max(float(np.abs(w).max()) for w in wl)
        assert max(float(np.abs(g - w).max()) for g, w in zip(gl, wl)) <= tol * scale


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_tp_head_slices_at_gpt_6_7b_width_take_the_wgmma_route(tp):
    """Under TP each rank runs attention on its heads: q, k and v are
    slices of the fused (B, S, 3, 32/tp, 128) qkv projection. Their strides
    stay TMA-readable, so the kernels keep the wgmma route, forward and
    backward."""
    b, s, nh, hd = 1, 2048, 32 // tp, 128
    qkv = torch.empty((b, s, 3, nh, hd), dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = torch.empty((b, s, nh, hd), dtype=torch.bfloat16)
    assert TF.flash_route([q, k, v]) == "wgmma"
    assert TF.flash_route([q, k, v, out, out], backward=True) == "wgmma"
