"""Port parity, training: the loss and every gradient of a tiny llama (MHA
and GQA, head_dim 128 and a sequence of 256, so the port's attention takes
the flash Function's plain versions), per-layer remat, the optimizer chain
and its schedules against optax, the synthetic batches, and whole train
steps against ``galvatron_tpu``'s jitted step — all in fp32 on the CPU with
weights and Adam state carried across by the numpy bridge."""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from galvatron_tpu.config.strategy import HybridParallelConfig as JHP
from galvatron_tpu.config.strategy import LayerStrategy as JLS
from galvatron_tpu.models import base as JM
from galvatron_tpu.models import llama as JL
from galvatron_tpu.obs import flops as JFL
from galvatron_tpu.runtime import dataloader as JD
from galvatron_tpu.runtime import model_api as JAPI
from galvatron_tpu.runtime import optimizer as JO
from galvatron_tpu_torch.config.strategy import HybridParallelConfig as THP
from galvatron_tpu_torch.config.strategy import LayerStrategy as TLS
from galvatron_tpu_torch.models import base as TM
from galvatron_tpu_torch.models import llama as TL
from galvatron_tpu_torch.obs import flops as TFL
from galvatron_tpu_torch.ops import flash_attention as TF
from galvatron_tpu_torch.runtime import dataloader as TD
from galvatron_tpu_torch.runtime import distributed as TDIST
from galvatron_tpu_torch.runtime import model_api as TAPI
from galvatron_tpu_torch.runtime import optimizer as TO
from galvatron_tpu_torch.tools.from_jax import (
    adam_state_from_numpy,
    adam_state_to_numpy,
    params_from_numpy,
    params_to_numpy,
)

# fp32 both sides: sums reassociate (einsum vs XLA dots, one softmax vs the
# plain flash version); 1e-5 relative to each tensor's scale
_RTOL = 1e-5

_MODELS = {
    "mha": dict(hidden_size=256, num_heads=2, ffn_hidden=128),
    "gqa": dict(hidden_size=256, num_heads=2, num_kv_heads=1, ffn_hidden=128),
}
_SEQ, _VOCAB = 256, 64


@pytest.fixture
def one_rank_group():
    """The train step runs the layout path through one-rank groups of a
    default process group that the caller owns, as `cli train` does."""
    with TDIST.process_group("cpu"):
        yield


def _configs(name, num_layers=2):
    common = dict(num_layers=num_layers, vocab_size=_VOCAB, max_seq_len=_SEQ, **_MODELS[name])
    return (JL.llama_config("llama-0.3b", compute_dtype=jnp.float32, **common),
            TL.llama_config("llama-0.3b", compute_dtype=torch.float32, **common))


def _params(name, seed=0):
    jcfg, tcfg = _configs(name)
    tree = jax.device_get(JM.init_model_params(jax.random.PRNGKey(seed), jcfg))
    params = TM.TransformerLM(tcfg, "cpu")
    params.load_state_dict(params_from_numpy(tree))
    return jcfg, tcfg, tree, params


def _assert_tree_close(got, want, rtol=_RTOL, what=""):
    """Every leaf: max |got - want| <= rtol * max(|want|) (+ a floor for
    leaves that are all ~0)."""
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [jax.tree_util.keystr(p) for p, _ in gl] == [jax.tree_util.keystr(p) for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        scale = max(np.abs(w).max(), 1e-6)
        err = np.abs(g - w).max()
        assert err <= rtol * scale, "%s%s: max err %.3g, scale %.3g" % (
            what, jax.tree_util.keystr(path), err, scale)


def _batch_np(seed, b=2):
    tokens = np.random.RandomState(seed).randint(0, _VOCAB, (b, _SEQ))
    return tokens


# ----------------------------------------------------------- loss and grads
@pytest.mark.parametrize("name", sorted(_MODELS))
def test_loss_and_every_gradient_match_reference(name):
    jcfg, tcfg, tree, params = _params(name)
    tokens = _batch_np(1)
    jb = JD.prepare_batch(None, tokens)
    tb = TD.prepare_batch(None, tokens)
    want_loss, want_grads = jax.value_and_grad(lambda p: JM.lm_loss_fn(p, jb, jcfg))(tree)
    n_fwd, n_bwd = TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches
    loss = TM.lm_loss_fn(params, tb, tcfg)
    loss.backward()
    assert (TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches) == (n_fwd, n_bwd)
    assert abs(loss.item() - float(want_loss)) <= _RTOL * abs(float(want_loss))
    grads = params_to_numpy({n: p.grad for n, p in params.named_parameters()})
    _assert_tree_close(grads, jax.device_get(want_grads), what="grad ")


def test_cross_entropy_matches_reference_with_loss_mask():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 7))
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = JM.vocab_parallel_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                               None if m is None else jnp.asarray(m))
        got = TM.vocab_parallel_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                              None if m is None else torch.from_numpy(m))
        assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))


@pytest.mark.parametrize("policy", ["full", "dots_saveable", "nothing_saveable"])
def test_per_layer_remat_gives_the_same_gradients(policy):
    """Layer 0 under `policy`, layer 1 plain: the same loss and gradients as
    no remat at all; each remat layer's forward runs again in the
    backward."""
    _, tcfg, _, params = _params("gqa")
    tb = TD.prepare_batch(None, _batch_np(2))

    def grads(hp):
        for p in params.parameters():
            p.grad = None
        loss = TM.lm_loss_fn(params, tb, tcfg, hp)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in params.named_parameters()}

    plain_loss, plain = grads(THP.uniform(1, 2))
    hp = THP(world_size=1, pp=1, layers=[TLS(checkpoint=1, remat_policy=policy), TLS()])
    calls = []
    orig = TF.flash_attention_fwd_reference

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    TF.flash_attention_fwd_reference, saved = spy, orig
    try:
        remat_loss, remat = grads(hp)
    finally:
        TF.flash_attention_fwd_reference = saved
    assert len(calls) == 3  # two layers forward, layer 0 again in the backward
    assert remat_loss == plain_loss
    for n in plain:
        torch.testing.assert_close(remat[n], plain[n], atol=1e-7, rtol=1e-6)


# ------------------------------------------------------- optimizer, schedule
@pytest.mark.parametrize("style,warmup", [("cosine", 0), ("cosine", 5), ("linear", 3),
                                          ("constant", 0), ("constant", 4)])
def test_schedule_matches_optax(style, warmup):
    kw = dict(lr=3e-3, min_lr=1e-4, warmup_steps=warmup, total_steps=20, lr_decay_style=style)
    want = JO.make_schedule(JO.OptimizerArgs(**kw))
    got = TO.make_schedule(TO.OptimizerArgs(**kw))
    for step in range(0, 26):
        assert abs(got(step) - float(want(step))) <= 1e-6 * 3e-3 + 1e-7 * abs(float(want(step)))


def _toy_module(rng):
    m = torch.nn.Module()
    for sub, leaves in (("dense", {"kernel": (6, 5), "bias": (5,)}), ("norm", {"scale": (5,)}),
                        ("head", {"kernel": (5, 3)})):
        mod = torch.nn.Module()
        for leaf, shape in leaves.items():
            setattr(mod, leaf, torch.nn.Parameter(torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32))))
        setattr(m, sub, mod)
    return m


@pytest.mark.parametrize("style,clip", [("cosine", 1.0), ("linear", 0.5), ("constant", 0.0)])
def test_optimizer_chain_matches_optax_over_twelve_steps(style, clip):
    """clip -> Adam -> decoupled weight decay (biases and scales exempt) ->
    -lr: params and both moments track optax step by step."""
    rng = np.random.default_rng(5)
    args = dict(lr=1e-2, min_lr=1e-3, weight_decay=0.1, clip_grad=clip, warmup_steps=2,
                total_steps=12, lr_decay_style=style)
    module = _toy_module(rng)
    tree = jax.tree.map(jnp.asarray, params_to_numpy(module))
    tx, _ = JO.get_optimizer_and_scheduler(JO.OptimizerArgs(**args))
    jstate = tx.init(tree)
    ttx, _ = TO.get_optimizer_and_scheduler(TO.OptimizerArgs(**args))
    tstate = ttx.init(module)
    for step in range(12):
        grads = {n: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32)
                                     * (0.3 + step)) for n, p in module.named_parameters()}
        jgrads = jax.tree.map(jnp.asarray, params_to_numpy(grads))
        updates, jstate = tx.update(jgrads, jstate, tree)
        tree = optax.apply_updates(tree, updates)
        norm = ttx.update(module, grads, tstate)
        assert abs(norm.item() - float(optax.global_norm(jgrads))) <= 1e-5 * norm.item()
    _assert_tree_close(params_to_numpy(module), jax.device_get(tree), rtol=2e-6, what="param ")
    adam = next(s for s in jstate if isinstance(s, optax.ScaleByAdamState))
    count, mu, nu = adam_state_to_numpy(tstate)
    assert count == int(adam.count) == 12
    _assert_tree_close(mu, jax.device_get(adam.mu), rtol=2e-6, what="mu ")
    _assert_tree_close(nu, jax.device_get(adam.nu), rtol=2e-6, what="nu ")


# ---------------------------------------------------------------- the data
def test_synthetic_batches_match_reference():
    hp_j = JHP.uniform(1, 2, global_bsz=3)
    hp_t = THP.uniform(1, 2, global_bsz=3)
    jit = JD.get_train_iterator(hp_j, 97, 32, seed=11, start_step=4)
    tit = TD.get_train_iterator(hp_t, 97, 32, seed=11, start_step=4)
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)


@pytest.mark.parametrize("kw", [dict(cp=2), dict(cp=4), dict(cp=2, cp_mode="ring"),
                                dict(vocab_cp=2), dict(tp=2, sp=1)],
                         ids=["cp2", "cp4", "cp2_ring", "vcp2", "ulysses2"])
def test_context_parallel_batches_match_reference(kw):
    """Under zigzag cp (a layer's or vocab cp) both packages permute every
    field of the batch, key-padding masks included, along the sequence in
    the same order; ring cp and Ulysses leave it in order."""
    tokens = _batch_np(0)
    mask = np.ones(tokens.shape, np.float32)
    mask[:, -5:] = 0.0
    hp_t = THP.uniform(4, 2, global_bsz=4, **kw)
    hp_j = JHP.uniform(4, 2, global_bsz=4, **kw)
    tb = TD.prepare_batch(hp_t, tokens, attn_mask=mask)
    jb = JD.prepare_batch(hp_j, tokens, attn_mask=mask)
    assert sorted(tb) == sorted(jb)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
    permuted = hp_t.cp_mode == "zigzag" and hp_t.max_cp > 1
    assert permuted == (not np.array_equal(tb["positions"][0].numpy(), np.arange(_SEQ)))


def test_flops_accounting_matches_reference():
    jcfg, tcfg = _configs("gqa", num_layers=3)
    assert TFL.train_step_flops(tcfg, 8) == JFL.train_step_flops(jcfg, 8)
    assert TFL.model_fwd_flops(tcfg, 2) == JFL.model_fwd_flops(jcfg, 2)
    assert TFL.peak_flops_for("NVIDIA H100 80GB HBM3") == 989e12
    assert TFL.peak_flops_for("TPU v5 lite") == JFL.peak_flops_for("TPU v5 lite")
    assert TFL.mfu(1e12, 1000.0, 1e12) == JFL.mfu(1e12, 1000.0, 1e12) == 1.0


# ---------------------------------------------------------- the train step
_STEP_CASES = {
    "mha_chunks1": ("mha", 1, [JLS(), JLS()]),
    "mha_chunks2_full": ("mha", 2, [JLS(checkpoint=1), JLS()]),
    "gqa_chunks2_dots": ("gqa", 2, [JLS(checkpoint=1, remat_policy="dots_saveable"),
                                    JLS(checkpoint=1)]),
    "gqa_chunks1_full": ("gqa", 1, [JLS(checkpoint=1), JLS(checkpoint=1)]),
}


@pytest.mark.usefixtures("one_rank_group")
@pytest.mark.parametrize("case", sorted(_STEP_CASES))
def test_train_steps_match_reference(case):
    """Ten train steps in both packages on the same synthetic batches:
    losses, grad norms, params and Adam moments agree. The first step's
    learning rate is 0 (warmup), so step 1 checks the loss at the init."""
    name, chunks, layers = _STEP_CASES[case]
    jcfg, tcfg, tree, params = _params(name, seed=3)
    hp_j = JHP(world_size=1, pp=1, layers=layers, global_bsz=4, chunks=chunks)
    hp_t = THP(world_size=1, pp=1, global_bsz=4, chunks=chunks,
               layers=[TLS(checkpoint=s.checkpoint, remat_policy=s.remat_policy) for s in layers])
    oargs = dict(lr=2e-3, min_lr=2e-4, warmup_steps=2, total_steps=10)
    jmodel = JAPI.construct_hybrid_parallel_model(jcfg, hp_j)
    tx, _ = JO.get_optimizer_and_scheduler(JO.OptimizerArgs(**oargs))
    jparams = jax.device_put(tree, jmodel.shardings())
    jstate = jmodel.init_opt_state(tx, jparams)
    jstep = jmodel.make_train_step(tx, donate=False)
    tmodel = TAPI.construct_hybrid_parallel_model(tcfg, hp_t, "cpu")
    ttx, _ = TO.get_optimizer_and_scheduler(TO.OptimizerArgs(**oargs))
    adam = next(s for s in jstate if isinstance(s, optax.ScaleByAdamState))
    tstate = {0: adam_state_from_numpy(adam.count, jax.device_get(adam.mu),
                                       jax.device_get(adam.nu))}
    params = {0: params}
    tstep = tmodel.make_train_step(ttx)
    jdata = JD.get_train_iterator(hp_j, _VOCAB, _SEQ, seed=7)
    tdata = TD.get_train_iterator(hp_t, _VOCAB, _SEQ, seed=7)
    jlosses, tlosses = [], []
    for _ in range(10):
        jparams, jstate, jm = jstep(jparams, jstate, next(jdata))
        params, tstate, tm = tstep(params, tstate, next(tdata))
        jlosses.append(float(jm["loss"]))
        tlosses.append(tm["loss"].item())
        assert abs(tm["grad_norm"].item() - float(jm["grad_norm"])) <= 1e-4 * float(jm["grad_norm"])
    np.testing.assert_allclose(tlosses, jlosses, rtol=_RTOL)
    # Adam divides by sqrt(nu): coordinates with tiny gradients amplify the
    # fp32 reassociation noise of the gradients into their updates
    _assert_tree_close(params_to_numpy(params[0]), jax.device_get(jparams), rtol=2e-5,
                       what="param ")
    # the moments sum ten steps of gradients, each ~1e-5 apart (taken at
    # params that drifted apart by the above)
    adam = next(s for s in jstate if isinstance(s, optax.ScaleByAdamState))
    count, mu, nu = adam_state_to_numpy(tstate[0])
    assert count == int(adam.count) == 10
    _assert_tree_close(mu, jax.device_get(adam.mu), rtol=5e-5, what="mu ")
    _assert_tree_close(nu, jax.device_get(adam.nu), rtol=5e-5, what="nu ")


def test_train_step_refuses_the_unported_paths():
    """The quantized gradient sync is not ported; the sentinel's vote has
    no replicas to compare at world 1 (its digest mode is ported:
    tests/test_torch_sdc.py)."""
    _, tcfg = _configs("mha")
    model = TAPI.construct_hybrid_parallel_model(tcfg, THP.uniform(1, 2), "cpu")
    tx, _ = TO.get_optimizer_and_scheduler()
    with pytest.raises(ValueError, match="downgrade to 'digest'"):
        model.make_train_step(tx, sdc_check="vote")
    quant = TAPI.construct_hybrid_parallel_model(
        tcfg, THP(world_size=1, pp=1, layers=[TLS(grad_comm_dtype="int8")] * 2), "cpu")
    with pytest.raises(ValueError, match="data-parallel slice"):
        quant.make_train_step(tx)


@pytest.mark.usefixtures("one_rank_group")
def test_train_step_weights_uneven_microbatches_like_reference():
    """Key-padded micro-batches with unequal valid-token counts: each
    microbatch loss is weighted by its share of the valid tokens, so one
    chunked step equals the reference's, padded rows (flash segment ids here,
    the additive bias there) included."""
    jcfg, tcfg, tree, params = _params("gqa", seed=4)
    rng = np.random.RandomState(9)
    tokens = rng.randint(0, _VOCAB, (4, _SEQ))
    attn_mask = np.ones((4, _SEQ), np.float32)
    for row, pad in enumerate((0, 100, 30, 0)):
        if pad:
            attn_mask[row, -pad:] = 0.0
    loss_mask = attn_mask.copy()
    loss_mask[:, -1] = 0.0
    labels = np.roll(tokens, -1, axis=1)
    hp_j = JHP(world_size=1, pp=1, layers=[JLS(checkpoint=1), JLS()], global_bsz=4, chunks=2)
    hp_t = THP(world_size=1, pp=1, layers=[TLS(checkpoint=1), TLS()], global_bsz=4, chunks=2)
    oargs = dict(lr=1e-3, warmup_steps=0, total_steps=4, lr_decay_style="constant")
    jmodel = JAPI.construct_hybrid_parallel_model(jcfg, hp_j)
    tx, _ = JO.get_optimizer_and_scheduler(JO.OptimizerArgs(**oargs))
    jparams = jax.device_put(tree, jmodel.shardings())
    jstate = jmodel.init_opt_state(tx, jparams)
    jparams, jstate, jm = jmodel.make_train_step(tx, donate=False)(
        jparams, jstate, JD.prepare_batch(None, tokens, labels, loss_mask, attn_mask))
    tmodel = TAPI.construct_hybrid_parallel_model(tcfg, hp_t, "cpu")
    ttx, _ = TO.get_optimizer_and_scheduler(TO.OptimizerArgs(**oargs))
    params = {0: params}
    tstate = tmodel.init_opt_state(ttx, params)
    params, tstate, tm = tmodel.make_train_step(ttx)(
        params, tstate, TD.prepare_batch(None, tokens, labels, loss_mask, attn_mask))
    assert abs(tm["loss"].item() - float(jm["loss"])) <= _RTOL * float(jm["loss"])
    assert abs(tm["grad_norm"].item() - float(jm["grad_norm"])) <= 1e-4 * float(jm["grad_norm"])
    # after one step the moments are (1 - b1) g and (1 - b2) g^2 of the
    # weighted, clipped gradients; the params are not compared: a first Adam
    # step moves every coordinate by ~lr * sign(g), so a near-zero gradient's
    # reassociation noise decides its whole update
    adam = next(s for s in jstate if isinstance(s, optax.ScaleByAdamState))
    _, mu, nu = adam_state_to_numpy(tstate[0])
    _assert_tree_close(mu, jax.device_get(adam.mu), rtol=2e-5, what="mu ")
    _assert_tree_close(nu, jax.device_get(adam.nu), rtol=5e-5, what="nu ")
