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


# ------------------------------------------------------ serve layouts (world 8)
# name -> (the layout's uniform kwargs or per-layer list, kv heads, max_slots)
_KV_LAYOUTS = {
    "tp2": (dict(tp=2), 4, 8),
    "tp4": (dict(tp=4), 4, 8),
    "dp": ({}, 4, 8),
    "zero3": (dict(sdp=1), 4, 8),
    "tp2_zero3": (dict(tp=2, sdp=1), 4, 8),
    "gqa_nkv_below_tp": (dict(tp=4), 2, 8),  # kv replicated over tp
    "offgrid_slots": (dict(tp=2), 4, 6),  # 6 slots over dp 4: replicated
    "mixed": ([dict(tp=4), dict(fsdp=1), dict(tp=2, tp_consec=0), dict(tp=2, fsdp=1)], 2, 8),
}


def _layout_pair(name):
    """(JAX hp, JAX cfg, port hp, port cfg, max_slots) of a world-8 layout."""
    from galvatron_tpu.config.strategy import HybridParallelConfig as JHP
    from galvatron_tpu.config.strategy import LayerStrategy as JLS
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig as THP
    from galvatron_tpu_torch.config.strategy import LayerStrategy as TLS

    kw, nkv, slots = _KV_LAYOUTS[name]
    common = dict(hidden_size=32, num_heads=4, num_kv_heads=nkv, num_layers=4, vocab_size=64,
                  max_seq_len=40)
    jcfg = JM.TransformerConfig(compute_dtype=jnp.float32, **common)
    tcfg = TM.TransformerConfig(compute_dtype=torch.float32, **common)
    if isinstance(kw, list):
        jhp = JHP(world_size=8, pp=1, layers=[JLS(**s) for s in kw], global_bsz=8)
        thp = THP(world_size=8, pp=1, layers=[TLS(**s) for s in kw], global_bsz=8)
    else:
        jhp = JHP.uniform(8, 4, global_bsz=8, **kw)
        thp = THP.uniform(8, 4, global_bsz=8, **kw)
    return jhp, jcfg, thp, tcfg, slots


def _port_spec(p):
    """A PartitionSpec as the port's placement (a tuple of sub-axes per dim)."""
    return tuple(() if e is None else (e,) if isinstance(e, str) else tuple(e) for e in p)


@pytest.mark.parametrize("name", sorted(_KV_LAYOUTS))
def test_layer_kv_specs_and_kv_budget_match_reference(name, devices8):
    """Per layer, the cache placement is the reference's layer_kv_spec, and
    serve_kv_mb_per_device (the serve search's and the GLS014 budget's KV
    price) is the reference's; each rank's shard of a layer holds its slots
    and kv heads (one shared kv head where kv is replicated over tp)."""
    from galvatron_tpu.analysis import strategy_lint as JSL
    from galvatron_tpu.parallel.mesh import build_mesh
    from galvatron_tpu_torch.analysis import strategy_lint as TSL
    from galvatron_tpu_torch.parallel.mesh import RankMesh

    jhp, jcfg, thp, tcfg, slots = _layout_pair(name)
    jmesh = build_mesh(jhp, devices8)
    kv = TK.KVCacheConfig(max_slots=slots, page_size=8, max_pages=5)
    for rank in (0, 5):
        mesh = RankMesh(thp, rank)
        shards = TK.layer_shards(tcfg, kv, thp, mesh)
        for i in range(tcfg.num_layers):
            want = _port_spec(JK.layer_kv_spec(jhp, i, jmesh, jcfg, slots))
            got = TK.layer_kv_spec(thp, i, mesh, tcfg, slots)
            assert got == want, (name, i)
            sh = shards[i]
            assert sh.slots == slots // mesh.size(got[0])
            assert sh.start == mesh.shard_index(got[0]) * sh.slots
            kv_rep = tcfg.num_kv_heads % thp.layers[i].tp != 0
            assert sh.heads == (1 if kv_rep else tcfg.num_kv_heads // mesh.size(got[2]))
    for conc in (slots, 16):
        assert TSL.serve_kv_mb_per_device(thp, tcfg, conc, 8) == \
            JSL.serve_kv_mb_per_device(jhp, jcfg, conc, 8)


def test_kv_budget_refusal_matches_reference():
    """GLS014 when the KV cache of serve_max_concurrency slots plus the
    bf16 weights exceed the budget, in both packages' serve lint."""
    from galvatron_tpu.analysis import strategy_lint as JSL
    from galvatron_tpu_torch.analysis import strategy_lint as TSL

    jhp, jcfg, thp, tcfg, _ = _layout_pair("tp2")
    jhp.serve_max_concurrency = thp.serve_max_concurrency = 64
    for budget, refused in ((1e-4, True), (64.0, False)):
        codes = {"jax": [d.code for d in JSL.lint_hp(jhp, model_cfg=jcfg, mode="serve",
                                                     memory_budget_gb=budget).errors],
                 "port": [d.code for d in TSL.lint_hp(thp, model_cfg=tcfg, mode="serve",
                                                      memory_budget_gb=budget).errors]}
        assert codes["port"] == codes["jax"] == (["GLS014"] if refused else [])


@pytest.mark.parametrize("kw,refused", [
    (dict(pp=2), "pp=2"), (dict(cp=2), "cp=2"), (dict(tp=2, sp=1), "Ulysses"),
    (dict(tp=2, vocab_tp=2, vocab_sp=1), "vocab_sp=1"),
    (dict(tp=2, sdp=1, vocab_tp=2, embed_sdp=1), None),
])
def test_serve_layouts_run_dp_zero_tp_and_vocab_tp_and_refuse_the_rest(kw, refused):
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig as THP
    from galvatron_tpu_torch.runtime.model_api import check_layout

    hp = THP.uniform(4, 4, global_bsz=8, **kw)
    if refused is None:
        check_layout(hp, "serve")
    else:
        with pytest.raises(ValueError, match=refused):
            check_layout(hp, "serve")


# ------------------------------------------------------ the batcher across ranks
class _SkewClock:
    """Rank `r`'s clock: each read advances it by its own step."""

    def __init__(self, r):
        self.t, self.dt = 100.0 * r, 0.0007 * (1 + 3 * r)

    def __call__(self):
        self.t += self.dt
        return self.t


class _FakeEngine:
    """The scheduler-visible surface of a ServeEngine (no model)."""

    def prefill(self, prompt, slot):
        return int(sum(prompt) % 31), np.zeros((31,), np.float32)

    def decode_step(self, tokens, active, pages):
        nxt = (np.asarray(tokens, np.int64) + 1) % 31
        return nxt.astype(np.int32), np.zeros((len(tokens), 31), np.float32)


def _load():
    reqs = TE.synthetic_requests(24, vocab_size=31, seed=2, rate_rps=400.0,
                                 prompt_len_range=(2, 6), max_new_tokens=5)
    for r in reqs[::5]:
        r.deadline_s = r.arrival_s + 0.004
    return reqs


def _serve_rank(r, agree):
    kv = TK.KVCacheConfig(max_slots=2, page_size=8, max_pages=2)
    b = TE.ContinuousBatcher(_FakeEngine(), kv, clock=_SkewClock(r), p99_ttft_ms=6.0,
                             max_pending=6, min_shed_samples=2, agree=agree)
    done = b.run(_load())
    return (sorted((q.rid, tuple(q.output)) for q in done),
            sorted((q.rid, q.finish_reason) for q in b.shed), b.decode_steps)


def test_batcher_decisions_agree_across_ranks_with_skewed_clocks():
    """Three ranks, each reading its own clock (offset and rate), drive the
    same load through admission by arrival, deadlines, the predicted-TTFT
    shed and the pending bound. With `agree` (here an elementwise max at a
    thread barrier, standing in for the all-reduce) every rank admits,
    sheds and decodes alike; without it the same clocks make the ranks
    decide differently (which over real collectives hangs)."""
    import threading

    n = 3
    barrier = threading.Barrier(n, timeout=30)
    posted = [None] * n

    def agree_for(r):
        def agree(values):
            posted[r] = list(values)
            barrier.wait()
            assert len({len(v) for v in posted}) == 1, "ranks measured different step counts"
            out = [max(col) for col in zip(*posted)]
            barrier.wait()
            return out
        return agree

    results = [None] * n

    def rank(r):
        results[r] = _serve_rank(r, agree_for(r))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results[0] is not None and results[1] == results[0] and results[2] == results[0]
    done, shed, _ = results[0]
    assert done and shed, "the load both completes and sheds requests"
    alone = [_serve_rank(r, None) for r in range(n)]
    assert len({repr(a) for a in alone}) > 1, "the skewed clocks alone decide differently"


# ----------------------------------------------------- live migration (world 1)
def _migration_reqs(E):
    return [E.Request(rid=0, arrival_s=0.0, prompt=[5, 9, 2], max_new_tokens=6),
            E.Request(rid=1, arrival_s=0.0, prompt=[17, 3, 44, 8], max_new_tokens=6)]


@pytest.mark.parametrize("target", ["same_geometry", "smaller_cache"])
def test_migrate_to_replays_journals_and_sheds_like_reference(target):
    """Mid-run migration onto a freshly built engine: in-flight journals are
    re-prefilled (prompt + output[:-1], the last sampled token restored) and
    the continuation equals the uninterrupted run token for token; onto a
    cache too small for a journal, the request sheds retryable
    (``migrate_infeasible``). Both packages' real engines, the same
    outcome."""
    jcfg, tcfg, tree, params, kv_j, kv_t, _ = build("tiny_gqa")
    small = dict(max_slots=2, page_size=8, max_pages=1)
    out = {}
    for key, E, K, make in (
            ("j", JE, JK, lambda kv: JE.ServeEngine(jcfg, tree, kv)),
            ("t", TE, TK, lambda kv: TE.ServeEngine(tcfg, params, kv, device="cpu"))):
        kv = kv_j if key == "j" else kv_t
        ref = {r.rid: list(r.output) for r in
               E.ContinuousBatcher(make(kv), kv).run(_migration_reqs(E))}
        new_kv = kv if target == "same_geometry" else K.KVCacheConfig(**small)
        ticks, res = {"n": 0}, {}

        def control(b, make=make, new_kv=new_kv, res=res, ticks=ticks):
            ticks["n"] += 1
            if ticks["n"] == 3:
                res.update(b.migrate_to(make(new_kv), new_kv))
                for slot, req in enumerate(b.slot_req):
                    if req is not None:
                        assert int(b.slot_len[slot]) == len(req.journal) - 1
                        assert int(b.slot_tok[slot]) == req.output[-1]
            return None

        b = E.ContinuousBatcher(make(kv), kv, control=control)
        done = {r.rid: [int(t) for t in r.output] for r in b.run(_migration_reqs(E))}
        out[key] = (done, res, sorted((r.rid, r.finish_reason, r.retryable) for r in b.shed),
                    b.migrations)
        if target == "same_geometry":
            assert done == {k: [int(t) for t in v] for k, v in ref.items()}
            assert res == {"replayed": 2, "shed": 0}
        else:
            assert res == {"replayed": 0, "shed": 2} and not done
            assert all(reason == "migrate_infeasible" and retry for _, reason, retry in out[key][2])
    assert out["t"] == out["j"]


def test_surviving_world_search_refuses_with_gls015_like_reference():
    from galvatron_tpu.runtime import elastic as JEL
    from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError
    from galvatron_tpu_torch.runtime import elastic as TEL

    common = dict(hidden_size=32, num_heads=4, num_layers=2, vocab_size=64, max_seq_len=32)
    codes = {}
    for key, EL, cfg in (("j", JEL, JM.TransformerConfig(compute_dtype=jnp.float32, **common)),
                         ("t", TEL, TM.TransformerConfig(compute_dtype=torch.float32, **common))):
        with pytest.raises(ValueError) as e:
            EL.search_surviving_serve_strategy(cfg, live_world=2, memory_budget_gb=1e-9,
                                               serve_max_concurrency=8, serve_page_size=8)
        codes[key] = [d.code for d in e.value.diagnostics]
        assert "surviving" in e.value.diagnostics[0].message
    assert isinstance(e.value, DiagnosticError)
    assert codes["t"] == codes["j"] == ["GLS015"]
    # a feasible budget: a decode-compatible plan for the 2 survivors
    hp = TEL.search_surviving_serve_strategy(TM.TransformerConfig(
        compute_dtype=torch.float32, **common), 2, 16.0, 8, 8)
    assert hp.world_size == 2 and hp.pp == 1 and all(s.cp == 1 and not s.sp for s in hp.layers)
