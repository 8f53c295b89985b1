"""Port parity, serving: the port's ServeEngine and ContinuousBatcher against
the JAX reference's with the same transplanted weights, fp32 on the CPU, and
the KV-cache helpers. Decoding is greedy: sampled tokens cannot match across
the two random-number generators, greedy ones must."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from galvatron_tpu.models import base as JM
from galvatron_tpu.models import llama as JL
from galvatron_tpu.serve import engine as JE
from galvatron_tpu.serve import kv_cache as JK
from galvatron_tpu_torch.models import base as TM
from galvatron_tpu_torch.models import llama as TL
from galvatron_tpu_torch.serve import engine as TE
from galvatron_tpu_torch.serve import kv_cache as TK
from galvatron_tpu_torch.tools.from_jax import params_from_numpy

_ATOL = 5e-5  # fp32 both sides

# name -> (model overrides, page size, max pages, prompt lengths)
_SETUPS = {
    # tiny widths: the plain attention path throughout
    "tiny_gqa": (dict(hidden_size=64, num_heads=4, num_kv_heads=2, ffn_hidden=128),
                 8, 4, (5, 11)),
    # head_dim 128 at page 128: every prefill bucket takes the flash path
    # (the kernel's plain version on the CPU)
    "flash": (dict(hidden_size=256, num_heads=2, ffn_hidden=128), 128, 2, (100, 130)),
}


def build(name):
    kw, page, max_pages, prompts = _SETUPS[name]
    common = dict(num_layers=2, vocab_size=64, max_seq_len=page * max_pages, **kw)
    jcfg = JL.llama_config("llama-0.3b", compute_dtype=jnp.float32, **common)
    tcfg = TL.llama_config("llama-0.3b", compute_dtype=torch.float32, **common)
    tree = jax.device_get(JM.init_model_params(jax.random.PRNGKey(7), jcfg))
    params = TM.TransformerLM(tcfg, "cpu")
    params.load_state_dict(params_from_numpy(tree, "cpu"))
    kv_j = JK.KVCacheConfig(max_slots=2, page_size=page, max_pages=max_pages)
    kv_t = TK.KVCacheConfig(max_slots=2, page_size=page, max_pages=max_pages)
    rng = np.random.default_rng(11)
    prompt_tokens = [list(rng.integers(0, 64, size=n)) for n in prompts]
    return jcfg, tcfg, tree, params, kv_j, kv_t, prompt_tokens


@pytest.mark.parametrize("name", sorted(_SETUPS))
def test_engine_prefill_and_decode_match_reference(name):
    jcfg, tcfg, tree, params, kv_j, kv_t, prompts = build(name)
    jeng = JE.ServeEngine(jcfg, tree, kv_j)
    teng = TE.ServeEngine(tcfg, params, kv_t, device="cpu")
    cur = np.zeros((2,), np.int32)
    lens = np.zeros((2,), np.int64)
    for slot, prompt in enumerate(prompts):
        jt, jl = jeng.prefill(prompt, slot)
        tt, tl = teng.prefill(prompt, slot)
        np.testing.assert_allclose(tl, np.asarray(jl, np.float32), atol=_ATOL)
        assert tt == jt
        cur[slot], lens[slot] = tt, len(prompt)
    active = np.array([True, True])
    for _ in range(4):
        pages = JK.bucket_pages(int(lens.max()), kv_t.page_size, kv_t.max_pages)
        jn, jl = jeng.decode_step(cur, active, pages)
        tn, tl = teng.decode_step(cur, active, pages)
        np.testing.assert_allclose(tl, np.asarray(jl, np.float32), atol=_ATOL)
        np.testing.assert_array_equal(tn, np.asarray(jn))
        cur = tn.astype(np.int32)
        lens += 1
    jlen = np.asarray(jeng.cache["lengths"])
    np.testing.assert_array_equal(teng.cache["lengths"].numpy(), jlen)
    for li in range(tcfg.num_layers):
        for key in ("k", "v"):
            jc, tc = np.asarray(jeng.cache[key][li]), teng.cache[key][li].numpy()
            for slot in range(2):
                n = int(jlen[slot])
                np.testing.assert_allclose(tc[slot, :n], jc[slot, :n], atol=_ATOL)


def test_engine_inactive_slot_keeps_token_and_length():
    _, tcfg, _, params, _, kv_t, prompts = build("tiny_gqa")
    eng = TE.ServeEngine(tcfg, params, kv_t, device="cpu")
    tok, _ = eng.prefill(prompts[0], 0)
    nxt, _ = eng.decode_step(np.array([tok, 3], np.int32), np.array([True, False]), 2)
    assert nxt[1] == 3
    assert eng.cache["lengths"].tolist() == [len(prompts[0]) + 1, 0]


def test_batcher_outputs_match_reference_per_request():
    jcfg, tcfg, tree, params, kv_j, kv_t, _ = build("tiny_gqa")
    kw = dict(vocab_size=64, seed=3, prompt_len_range=(3, 20), max_new_tokens=5)
    jreqs = JE.synthetic_requests(6, **kw)
    treqs = TE.synthetic_requests(6, **kw)
    assert [r.prompt for r in jreqs] == [r.prompt for r in treqs]
    jb = JE.ContinuousBatcher(JE.ServeEngine(jcfg, tree, kv_j), kv_j)
    tb = TE.ContinuousBatcher(TE.ServeEngine(tcfg, params, kv_t, device="cpu"), kv_t)
    jdone = {r.rid: [int(t) for t in r.output] for r in jb.run(jreqs)}
    tdone = {r.rid: [int(t) for t in r.output] for r in tb.run(treqs)}
    assert len(tdone) == 6
    assert tdone == jdone
    assert tb.decode_steps == jb.decode_steps
    summary = TE.summarize(tb.completed, 1.0, shed=tb.shed)
    assert summary["requests"] == 6 and summary["output_tokens"] == 30


@pytest.mark.parametrize("scenario", ["drain", "oversize"])
def test_batcher_drain_and_shedding_match_reference(scenario):
    """Structured rejections and the control-plane drain: the same requests
    complete with the same tokens and the same ones shed, for the same
    reasons, in both packages."""
    jcfg, tcfg, tree, params, kv_j, kv_t, _ = build("tiny_gqa")
    kw = dict(vocab_size=64, seed=5, prompt_len_range=(3, 12), max_new_tokens=4)
    reqs = {"j": JE.synthetic_requests(6, **kw), "t": TE.synthetic_requests(6, **kw)}
    if scenario == "oversize":
        for r in (reqs["j"][2], reqs["t"][2]):
            r.prompt = r.prompt * 8  # prompt + output exceeds max_ctx 32
    control = (lambda b: "SIGTERM" if b.decode_steps >= 2 else None) \
        if scenario == "drain" else None
    out = {}
    for key, E, cfg, p, kv in (("j", JE, jcfg, tree, kv_j), ("t", TE, tcfg, params, kv_t)):
        eng = E.ServeEngine(cfg, p, kv) if key == "j" else E.ServeEngine(cfg, p, kv, device="cpu")
        b = E.ContinuousBatcher(eng, kv, control=control)
        done = b.run(reqs[key])
        out[key] = (sorted((r.rid, [int(t) for t in r.output]) for r in done),
                    sorted((r.rid, r.finish_reason, r.retryable) for r in b.shed),
                    b.drain_reason)
    assert out["t"] == out["j"]
    assert out["t"][1], "the scenario sheds something"


@pytest.mark.parametrize("length,page,max_pages", [(0, 16, 4), (15, 16, 4), (16, 16, 4),
                                                   (63, 16, 4), (127, 128, 16)])
def test_bucket_pages_and_request_fits_match_reference(length, page, max_pages):
    assert TK.bucket_pages(length, page, max_pages) == JK.bucket_pages(length, page, max_pages)
    kj = JK.KVCacheConfig(max_slots=2, page_size=page, max_pages=max_pages)
    kt = TK.KVCacheConfig(max_slots=2, page_size=page, max_pages=max_pages)
    assert kt.max_ctx == kj.max_ctx
    for new in (1, 8, 64):
        assert TK.request_fits(kt, length, new) == JK.request_fits(kj, length, new)


def test_bucket_pages_refuses_oversize_like_reference():
    with pytest.raises(ValueError):
        JK.bucket_pages(64, 16, 4)
    with pytest.raises(ValueError):
        TK.bucket_pages(64, 16, 4)


def test_length_bias_and_kv_bytes_match_reference():
    lengths = np.array([0, 5, 15], np.int32)
    want = JK.length_bias(jnp.asarray(lengths), 16)
    got = TK.length_bias(torch.from_numpy(lengths), 16)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cfg_j = JL.llama_config("llama-7b")
    cfg_t = TL.llama_config("llama-7b")
    assert TK.kv_bytes_per_slot(cfg_t, 2048) == JK.kv_bytes_per_slot(cfg_j, 2048)


def test_write_prompt_kv_and_init_match_reference():
    cfg_kw = dict(hidden_size=32, num_heads=2, num_layers=2, vocab_size=64, max_seq_len=32)
    jcfg = JM.TransformerConfig(compute_dtype=jnp.float32, **cfg_kw)
    tcfg = TM.TransformerConfig(compute_dtype=torch.float32, **cfg_kw)
    kv_j = JK.KVCacheConfig(max_slots=3, page_size=8, max_pages=4)
    kv_t = TK.KVCacheConfig(max_slots=3, page_size=8, max_pages=4)
    jc = JK.init_kv_cache(jcfg, kv_j)
    tc = TK.init_kv_cache(tcfg, kv_t, "cpu")
    assert [tuple(t.shape) for t in tc["k"]] == [tuple(t.shape) for t in jc["k"]]
    kvs = [(np.random.default_rng(i).standard_normal((1, 16, 2, 16)).astype(np.float32),
            np.random.default_rng(10 + i).standard_normal((1, 16, 2, 16)).astype(np.float32))
           for i in range(2)]
    jc = JK.write_prompt_kv(jc, [(jnp.asarray(k), jnp.asarray(v)) for k, v in kvs],
                            jnp.int32(1), jnp.int32(13))
    TK.write_prompt_kv(tc, [(torch.from_numpy(k), torch.from_numpy(v)) for k, v in kvs], 1, 13)
    np.testing.assert_array_equal(tc["lengths"].numpy(), np.asarray(jc["lengths"]))
    for key in ("k", "v"):
        for li in range(2):
            np.testing.assert_array_equal(tc[key][li].numpy(), np.asarray(jc[key][li]))


def test_percentile_and_summary_match_reference():
    vals = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6]
    for q in (0, 50, 90, 99, 100):
        assert TE.percentile(vals, q) == JE.percentile(vals, q)
    reqs_j = JE.synthetic_requests(3, vocab_size=10, seed=1, max_new_tokens=3)
    reqs_t = TE.synthetic_requests(3, vocab_size=10, seed=1, max_new_tokens=3)
    for rj, rt in zip(reqs_j, reqs_t):
        for r in (rj, rt):
            r.output = [1, 2, 3]
            r.first_token_t, r.done_t = 0.5 + r.rid, 1.0 + r.rid
    assert TE.summarize(reqs_t, 2.0) == JE.summarize(reqs_j, 2.0)
