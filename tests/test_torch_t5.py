"""Port parity, the T5 family (encoder-decoder, two layer types) on the CPU
against the JAX package, from the same seeded weights (the numpy bridge)
and inputs, at the reference's ``t5-test`` size (fp32 compute):

- the relative-position buckets equal the JAX package's integer for
  integer;
- relu and gated-gelu, on a batch whose encoder rows end in key padding:
  the loss within 2e-5 of ``t5_loss_fn`` and every gradient within
  1e-4 * max|g| + 1e-6 of ``jax.grad``'s; the same through the layout path
  at world 1 (ZeRO-3, ZeRO-2, remat) and as a 1F1B pp 2 pipeline (an
  encoder stage and a decoder stage) hosted in this process, against the
  port's unpipelined run and the JAX pp 1 loss;
- span-corruption batches of one corpus and the synthetic seq2seq stream
  equal the JAX package's batch for batch;
- the profiler writes the JAX package's file names and keys; ``cli
  search`` writes the JAX package's strategy JSON from the same profiles;
- a same-layout save and resume is bitwise; another strategy refuses with
  GLS206 and a restore across pipeline layouts with GLS207; T5 under GPipe
  is refused; the flops equal the JAX package's;
- ``cli train --model_type t5 --device cpu`` takes 3 steps from a corpus.

The world-2/4 layouts (tp 2 + ZeRO-3 + vocab tp 2, pp 2 x tp 2) ride the
workers of ``tests/test_torch_parallel.py``.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from galvatron_tpu.models import t5 as JT
from galvatron_tpu_torch.models import t5 as TT
from galvatron_tpu_torch.tools.from_jax import _flatten, params_from_numpy

LOSS_TOL, GRAD_REL, GRAD_ABS = 2e-5, 1e-4, 1e-6
B, S = 4, 32
SIZE = "t5-test"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread beside JAX's CPU backend in this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def weights(jcfg, seed=0):
    """The JAX init with the norm scales perturbed (so a norm wired wrong
    shows)."""
    tree = jax.device_get(JT.init_t5_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)

    def perturb(path, a):
        if "scale" in jax.tree_util.keystr(path):
            return np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32) * 0.1
        return np.asarray(a)
    return jax.tree_util.tree_map_with_path(perturb, tree)


def batch_np(seed=3, rows=B, seq=S, vocab=512):
    """Encoder rows with key-padding tails of uneven length, decoder rows
    with a few positions out of the loss."""
    rng = np.random.RandomState(seed)
    attn = np.ones((rows, seq), np.float32)
    lmask = np.ones((rows, seq), np.float32)
    for r in range(rows):
        attn[r, seq - (5 * r) % 13:] = 0.0
        lmask[r, seq - (3 * r) % 7:] = 0.0
    return {"tokens": rng.randint(0, vocab, (rows, seq)),
            "dec_tokens": rng.randint(0, vocab, (rows, seq)),
            "labels": rng.randint(0, vocab, (rows, seq)), "attn_mask": attn, "loss_mask": lmask}


def torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def assert_grads_close(got, want):
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        err = float(np.abs(np.asarray(got[n]) - w).max())
        assert err <= GRAD_REL * np.abs(w).max() + GRAD_ABS, (n, err, np.abs(w).max())


@pytest.fixture(scope="module", params=["relu", "gated-gelu"])
def case(request):
    jcfg = JT.t5_config(SIZE, compute_dtype=jnp.float32, activation=request.param)
    tcfg = TT.t5_config(SIZE, compute_dtype=torch.float32, activation=request.param)
    tree = weights(jcfg)
    b = batch_np()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: JT.t5_loss_fn(p, jb, jcfg)))(tree)
    flat = {}
    _flatten(jax.device_get(grads), "", flat)
    return dict(jcfg=jcfg, tcfg=tcfg, tree=tree, batch=b, loss=float(loss),
                grads={n: np.asarray(v) for n, v in flat.items()})


# ----------------------------------------------------------------- the model
@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_buckets_equal_the_jax_packages(bidirectional):
    rel = np.arange(-300, 301)
    want = np.asarray(JT.relative_position_bucket(
        jnp.asarray(rel, jnp.int32), bidirectional=bidirectional, num_buckets=32,
        max_distance=128))
    got = TT.relative_position_bucket(torch.from_numpy(rel), bidirectional=bidirectional,
                                      num_buckets=32, max_distance=128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_loss_and_every_gradient_match_the_jax_package(case):
    params = TT.T5Model(case["tcfg"], "cpu")
    params.load_state_dict(params_from_numpy(case["tree"]))
    loss = TT.t5_loss_fn(params, torch_batch(case["batch"]), case["tcfg"])
    loss.backward()
    assert abs(float(loss.detach()) - case["loss"]) <= LOSS_TOL, (float(loss), case["loss"])
    assert_grads_close({n: p.grad.numpy() for n, p in params.named_parameters()},
                       case["grads"])


_L = dict
STRATEGIES = {
    # the encoder ZeRO-3 under remat, the decoder ZeRO-2
    "zero3_zero2_remat": dict(layers=[_L(fsdp=1, checkpoint=1)] * 2 + [_L(), _L(checkpoint=1)],
                              chunks=2, default_dp_type="zero2"),
    # an encoder stage and a decoder stage, both hosted here
    "1f1b_pp2": dict(pp=2, layers=[_L(fsdp=1), _L(checkpoint=1), _L(), _L(fsdp=1)], chunks=2,
                     pipeline_type="pipedream_flush"),
}


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_world_one_layouts_and_pipelines_match_the_jax_package(strategy, case):
    """The layout path's loss and gathered gradients (chunks 2: the
    micro-batches weighted by their valid tokens), and its forward-only
    eval loss, within the limits above of the JAX pp 1 run."""
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig, LayerStrategy
    from galvatron_tpu_torch.runtime import distributed as TDIST
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model

    kw = dict(STRATEGIES[strategy])
    layers = [LayerStrategy(**s) for s in kw.pop("layers")]
    pp = kw.pop("pp", 1)
    hp = HybridParallelConfig(world_size=pp, pp=pp, layers=layers, global_bsz=B, **kw)
    with TDIST.process_group("cpu") as dev:
        model = construct_hybrid_parallel_model(case["tcfg"], hp, dev,
                                                transport="local" if pp > 1 else "p2p")
        params = model.shard_params(params_from_numpy(case["tree"]))
        loss, grads = model.loss_and_grads(params, torch_batch(case["batch"]))
        full = {n: g.numpy() for n, g in model.gather_grads(grads).items()}
        evaluated = float(model.eval_loss(params, torch_batch(case["batch"])))
    assert abs(float(loss) - case["loss"]) <= LOSS_TOL, (float(loss), case["loss"])
    assert abs(evaluated - case["loss"]) <= LOSS_TOL
    assert_grads_close(full, case["grads"])
    if pp > 1:
        assert model.arch.shared() == {"embed.wte": (0, 1)}


def test_pp2_channel_carries_the_encoder_output_and_the_decoder_state(case):
    """The boundary of the enc-dec pipeline: one tensor (the final-normed
    encoder output) out of the encoder stage; a decoder stage sends (h,
    mem)."""
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig

    hp = HybridParallelConfig.uniform(2, 4, pp=2, global_bsz=B, chunks=2,
                                      pipeline_type="pipedream_flush")
    mb = {k: v[:2] for k, v in torch_batch(case["batch"]).items()}
    mesh = type("M", (), {"size": staticmethod(lambda axes: 1)})()
    assert TT.T5Def(case["tcfg"], hp).boundary([mb], mesh)(0, 0) == [
        ((2, S, 64), torch.float32)]
    hp4 = HybridParallelConfig.uniform(4, 4, pp=4, global_bsz=B, chunks=2,
                                       pipeline_type="pipedream_flush")
    d = TT.T5Def(case["tcfg"], hp4)
    assert [len(d.boundary([mb], mesh)(0, s)) for s in range(3)] == [1, 1, 2]
    assert d.shared() == {"embed.wte": (0, 2, 3), "enc_rel_bias": (0, 1),
                          "dec_rel_bias": (2, 3)}


def test_flops_equal_the_jax_packages():
    from galvatron_tpu.obs import flops as JFL
    from galvatron_tpu_torch.obs import flops as TFL

    for size in ("t5-base", "t5-large"):
        j, t = JT.t5_config(size), TT.t5_config(size)
        assert TFL.train_step_flops(t, 8) == JFL.train_step_flops(j, 8)
    assert "cross-attention" in TFL.flops_note(t)


# ----------------------------------------------------------------------- data
def test_span_corruption_and_seq2seq_streams_equal_the_jax_packages(tmp_path):
    from galvatron_tpu.config.strategy import HybridParallelConfig as JHP
    from galvatron_tpu.data import dataset as JDS
    from galvatron_tpu.runtime import dataloader as JDL
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig as THP
    from galvatron_tpu_torch.data import dataset as TDS
    from galvatron_tpu_torch.runtime import dataloader as TDL

    rng = np.random.RandomState(0)
    prefix = str(tmp_path / "corpus")
    TDS.write_indexed_dataset(prefix, [rng.randint(0, 400, n) for n in rng.randint(5, 90, 60)])
    jhp, thp = JHP.uniform(1, 2, global_bsz=3), THP.uniform(1, 2, global_bsz=3)
    streams = [
        (JDS.t5_data_iterator(prefix, jhp, 32, 24, seed=5, start_step=2, vocab_size=512),
         TDS.t5_data_iterator(prefix, thp, 32, 24, seed=5, start_step=2, vocab_size=512)),
        (JDS.t5_data_iterator("0.3 %s 0.7 %s" % (prefix, prefix), jhp, 16, 16, seed=1,
                              split="valid", split_weights="8,1,1", vocab_size=512),
         TDS.t5_data_iterator("0.3 %s 0.7 %s" % (prefix, prefix), thp, 16, 16, seed=1,
                              split="valid", split_weights="8,1,1", vocab_size=512)),
        (JDL.get_seq2seq_train_iterator(jhp, 512, 20, 12, seed=3, start_step=4),
         TDL.get_seq2seq_train_iterator(thp, 512, 20, 12, seed=3, start_step=4)),
    ]
    for j_it, t_it in streams:
        for _ in range(3):
            jb, tb = next(j_it), next(t_it)
            assert sorted(jb) == sorted(tb)
            for k in jb:
                np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
    assert (tb["tokens"].dtype, tb["loss_mask"].dtype) == (torch.int64, torch.float32)
    for seed in range(20):  # the corruption alone, over odd windows
        window = np.arange(3, 3 + 5 + seed, dtype=np.int32)
        for j, t in zip(JDS.t5_span_corrupt(window, np.random.RandomState(seed), vocab_size=99),
                        TDS.t5_span_corrupt(window, np.random.RandomState(seed), vocab_size=99)):
            np.testing.assert_array_equal(t, j)


# ------------------------------------------------------- profiler and search
def _stub(calls):
    """One `_walltime` for either package's T5 profiler: seconds as a
    function of the timed program's (layers, batch, sequence) and of the
    call's index."""

    def stub(fn, args, *rest):
        a0, a1 = args[0], args[1]
        if isinstance(a1, dict):
            n = len(a0["enc_layers"]) if isinstance(a0, dict) else len(a0.enc_layers)
            bsz, s = a1["tokens"].shape
        else:
            n, (bsz, s) = len(a0), a1.shape[:2]
        calls.append((n, int(bsz), int(s)))
        return 1e-3 * (0.5 + 0.7 * n * bsz * (s / 64.0) ** 1.3) + 2e-5 * len(calls) ** 2
    return stub


def _keys(tree):
    if isinstance(tree, dict):
        return {str(k): _keys(v) for k, v in tree.items()}
    return None


def test_profiler_writes_the_jax_packages_files_and_keys(monkeypatch, tmp_path):
    """Both packages' T5 profilers under one timer stub: the same timed
    programs, equal computation tables (both layer types), file names,
    memory-table keys, per-type parameter sizes and model states."""
    import galvatron_tpu.profiler.model as JPM
    import galvatron_tpu_torch.profiler.model as TPM

    common = dict(profile_batch_size=2, layernum_min=1, layernum_max=2, max_tp_deg=2,
                  mixed_precision="fp32", warmup=1, iters=1, profile_seq_length=16)
    jcfg = JT.t5_config(SIZE, compute_dtype=jnp.float32)
    tcfg = TT.t5_config(SIZE, compute_dtype=torch.float32)
    jp = JPM.T5ModelProfiler(jcfg, "t5", JPM.ModelProfileArgs(config_dir=str(tmp_path / "jax"),
                                                             **common))
    tp = TPM.T5ModelProfiler(tcfg, "t5", TPM.ModelProfileArgs(
        device="cpu", config_dir=str(tmp_path / "torch"), **common))
    j_calls, t_calls = [], []
    monkeypatch.setattr(JPM, "_walltime", _stub(j_calls))
    monkeypatch.setattr(TPM, "_walltime", _stub(t_calls))
    monkeypatch.setattr(JPM.ModelProfiler, "_act_bytes_tp", lambda self, *a, **k: None)
    j_out, t_out = jp.profile_all(write=True), tp.profile_all(write=True)
    assert t_calls == j_calls
    assert t_out["computation"] == j_out["computation"]
    assert [p.replace("torch", "jax") for p in tp.config_paths().values()] == \
        list(jp.config_paths().values())
    jm, tm = j_out["memory"], t_out["memory"]
    assert _keys(tm) == _keys(jm)
    for t in ("layertype_0", "layertype_1"):
        assert tm[t]["parameter_size"] == jm[t]["parameter_size"]
    assert tm["other_memory_pp_off"]["model_states"] == jm["other_memory_pp_off"]["model_states"]


TIME = {"layertype_0": 3.1, "layertype_1": 4.6, "other_time": 0.9}
MEMORY = {
    "layertype_0": {"parameter_size": 0.19, "tp_activation_per_bsz_dict": {
        1: 3.0, 2: 1.6, 4: 0.9, 8: 0.5, "checkpoint": 0.1}},
    "layertype_1": {"parameter_size": 0.25, "tp_activation_per_bsz_dict": {
        1: 4.5, 2: 2.4, 4: 1.3, 8: 0.7, "checkpoint": 0.1}},
    "other_memory_pp_off": {"model_states": {1: 2.0, 2: 1.0, 4: 0.5, 8: 0.25},
                            "activation": {1: 0.9, 2: 0.45, 4: 0.225, 8: 0.112}},
    "other_memory_pp_on": {
        "first_stage": {"model_states": {1: 1.0, 2: 0.5, 4: 0.25, 8: 0.125},
                        "activation": {1: 0.45, 2: 0.225, 4: 0.112, 8: 0.056}},
        "last_stage": {"model_states": {1: 1.0, 2: 0.5, 4: 0.25, 8: 0.125},
                       "activation": {1: 0.45, 2: 0.225, 4: 0.112, 8: 0.056}}},
}
HW8 = {"allreduce_bandwidth_8chips.json": {"allreduce_size_8_consec_1": 150.0,
                                           "allreduce_size_4_consec_1": 155.0,
                                           "allreduce_size_4_consec_0": 150.0,
                                           "allreduce_size_2_consec_1": 130.0,
                                           "allreduce_size_2_consec_0": 145.0},
       "p2p_bandwidth_8chips.json": {"pp_size_2": 160.0, "pp_size_4": 140.0,
                                     "pp_size_8": 110.0},
       "overlap_coefficient.json": {"overlap_coe": 1.12}}


@pytest.mark.parametrize("extra", [["--memory_constraint", "0.6"],
                                   ["--memory_constraint", "0.6", "--search_space", "3d"]])
def test_cli_search_writes_the_jax_packages_json(extra, tmp_path, monkeypatch):
    """Both packages' ``cli search`` on one config dir (the two layer
    types' tables under the profiler's file names) write the same
    strategy JSON."""
    import galvatron_tpu.cli.search as JCLI
    import galvatron_tpu_torch.cli.search as TCLI
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig as THP

    d = tmp_path / "cfg"
    d.mkdir()
    tag = "bf16_hidden64_head4_seqlen512_t5"
    for name, data in (("computation_profiling_%s.json" % tag, TIME),
                       ("memory_profiling_%s.json" % tag, MEMORY), *HW8.items()):
        (d / name).write_text(json.dumps(data))
    monkeypatch.setenv("GALVATRON_WORLD_SIZE", "8")
    outs = {}
    for name, mod in (("jax", JCLI), ("torch", TCLI)):
        outs[name] = str(tmp_path / ("%s.json" % name))
        mod.main(["--model_type", "t5", "--model_size", SIZE, "--config_dir", str(d),
                  "--output_config_path", outs[name], "--log_dir", str(tmp_path / "logs"),
                  "--settle_bsz", "32"] + extra)
    with open(outs["jax"]) as f, open(outs["torch"]) as g:
        assert json.load(f) == json.load(g)
    hp = THP.from_json(outs["torch"], world_size=8)
    assert hp.num_layers == 4


# -------------------------------------------------- checkpoints, lint and CLI
T5_ARGV = ["--model_type", "t5", "--model_size", SIZE, "--set_seqlen_manually", "1",
           "--seq_length", "32", "--global_train_batch_size", "4", "--chunks", "2",
           "--lr", "1e-3", "--lr_decay_style", "constant", "--log_interval", "100",
           "--device", "cpu"]


def _corpus(tmp_path):
    from galvatron_tpu_torch.data.dataset import write_indexed_dataset

    rng = np.random.RandomState(1)
    prefix = str(tmp_path / "corpus")
    write_indexed_dataset(prefix, [rng.randint(0, 400, n) for n in rng.randint(20, 120, 80)])
    return prefix


def test_cli_train_from_a_corpus_and_a_same_layout_resume_is_bitwise(tmp_path):
    """``cli train`` takes 3 steps from span-corrupted batches with zero
    flash launches; resumed from its step-3 checkpoint it continues the
    6-step run's losses bitwise; the checkpoint under another strategy
    refuses (GLS206)."""
    from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError
    from galvatron_tpu_torch.cli import train as T

    argv = T5_ARGV + ["--data_path", _corpus(tmp_path), "--split", "1,0,0"]
    first = T.main(argv + ["--train_iters", "3", "--save", str(tmp_path / "ck")])
    assert len(first["losses"]) == 3 and np.isfinite(first["losses"]).all()
    assert first["flash_routes"] == [{"fwd": {}, "bwd": {}}] and "mfu_note" in first
    full = T.main(argv + ["--train_iters", "6"])
    assert full["losses"][:3] == first["losses"]
    resumed = T.main(argv + ["--train_iters", "6", "--load", str(tmp_path / "ck")])
    assert resumed["losses"] == full["losses"][3:]
    strategy = tmp_path / "zero.json"
    strategy.write_text(json.dumps({"pp_deg": 1, "tp_sizes_enc": "1,1,1,1",
                                    "tp_consecutive_flags": "1,1,1,1",
                                    "dp_types_enc": "1,1,0,0", "default_dp_type": "zero2",
                                    "global_bsz": 4, "chunks": 2}))
    with pytest.raises(DiagnosticError) as e:
        T.train(T.initialize_galvatron(argv=argv + [
            "--train_iters", "6", "--load", str(tmp_path / "ck"), "--galvatron_config_path",
            str(strategy)], mode="train"))
    assert e.value.diagnostics[0].code == "GLS206"


def test_restore_across_pipeline_layouts_is_refused_gls207(tmp_path):
    """A family with its own tree is restored across strategies only under
    the pipeline layout it was saved with: a pp 1 step into a hosted pp 2
    model refuses with GLS207 (the reference's migration refusal); under
    pp 1 another strategy restores."""
    from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError
    from galvatron_tpu_torch.cli import train as T
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig
    from galvatron_tpu_torch.runtime import checkpoint as ck
    from galvatron_tpu_torch.runtime import distributed as TDIST
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model
    from galvatron_tpu_torch.runtime.optimizer import OptimizerArgs, get_optimizer_and_scheduler

    T.main(T5_ARGV + ["--train_iters", "1", "--save", str(tmp_path / "ck")])
    cfg = TT.t5_config(SIZE, max_seq_len=32)
    tx, _ = get_optimizer_and_scheduler(OptimizerArgs())
    for pp, code in ((2, "GLS207"), (1, None)):
        hp = HybridParallelConfig.uniform(pp, 4, pp=pp, global_bsz=4, chunks=2, sdp=1,
                                          pipeline_type="pipedream_flush")
        with TDIST.process_group("cpu") as dev:
            model = construct_hybrid_parallel_model(cfg, hp, dev,
                                                    transport="local" if pp > 1 else "p2p")
            params = model.init_params(7)
            state = model.init_opt_state(tx, params)
            load = lambda: ck.load_checkpoint(str(tmp_path / "ck"), params_target=params,
                                              opt_state_target=state, target=model,
                                              allow_cross=True, model_cfg=cfg)
            if code is None:
                assert load()[2]["restore"]["cross_strategy"]
                continue
            with pytest.raises(DiagnosticError) as e:
                load()
            assert e.value.diagnostics[0].code == code


def test_gpipe_and_a_misaligned_boundary_are_refused():
    """T5 under pp runs 1F1B only, its encoder/decoder boundary on a stage
    boundary, as the reference's constructor refuses; the lint's model
    checks take it too."""
    from galvatron_tpu_torch.analysis.strategy_lint import lint_hp, train_refusals
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig

    cfg = TT.t5_config(SIZE)
    gpipe = HybridParallelConfig.uniform(2, 4, pp=2, global_bsz=4, chunks=2)
    assert any("pipedream_flush" in p for p in train_refusals(gpipe, cfg))
    misaligned = HybridParallelConfig.uniform(2, 4, pp=2, global_bsz=4, chunks=2,
                                              pipeline_type="pipedream_flush")
    assert train_refusals(misaligned, TT.t5_config(SIZE, num_enc_layers=1,
                                                    num_dec_layers=3))[0].startswith(
        "the encoder/decoder boundary must align")
    assert train_refusals(misaligned, cfg) == []
    assert lint_hp(gpipe, model_cfg=cfg, mode="train").ok


# ------------------------------------------------------- sequence sharding
def played_loss(params, batch, cfg, cp, tp, order=None):
    """T5's loss with every rank of each layer's cp x Ulysses group played
    by one process (``models.t5.LocalSeq``: the ranks' shards stacked along
    the batch, the key/value all-gather over cp and the all-to-alls over tp
    as those collectives move them). With `order` both streams come in that
    order of the sequence, with their true positions: a zigzag batch."""
    from galvatron_tpu_torch.models import base as TM

    play = TT.LocalSeq(cp, tp)
    rows, n = batch["tokens"].shape
    pos = torch.arange(n) if order is None else torch.as_tensor(order)
    b = {k: v[:, pos] for k, v in batch.items()}
    key_bias = TM.padding_attn_bias(b["attn_mask"])
    ranks = cp * tp

    def stack(ids, x, mem, table, decoder):
        bias = play.bias(table, pos, rows, cfg, bidirectional=not decoder,
                         key_bias=None if decoder else key_bias)
        x = play.rank_shards(x)
        if decoder:  # every rank's cross-attention reads the whole encoder output
            mem = mem[None].expand(ranks, *mem.shape).reshape(ranks * rows, *mem.shape[1:])
            cross = key_bias[None].expand(ranks, *key_bias.shape).reshape(
                ranks * rows, *key_bias.shape[1:])
        for i in ids:
            if decoder:
                x = TT.dec_layer_forward(params.dec_layers[str(i)], x, mem, cfg, bias, cross,
                                         seq=play)
            else:
                x = TT.enc_layer_forward(params.enc_layers[str(i)], x, cfg, bias, seq=play)
        return play.rank_unshard(x)

    h = TM.embed_tokens(params.embed, b["tokens"], None, cfg)
    h = stack(range(cfg.num_enc_layers), h, None, params.enc_rel_bias, False)
    mem = TT._rms(h, params.enc_norm, cfg)
    h = TM.embed_tokens(params.embed, b["dec_tokens"], None, cfg)
    h = stack(range(cfg.num_dec_layers), h, mem, params.dec_rel_bias, True)
    return TT._head_loss(params, h, b, cfg, None)


SEQ_SHARDING = {"cp2_zigzag": (2, 1, True), "cp2_ring": (2, 1, False),
                "ulysses2": (1, 2, False), "ulysses2_cp2_zigzag": (2, 2, True)}


@pytest.mark.parametrize("name", sorted(SEQ_SHARDING))
def test_sequence_sharded_layers_played_in_one_process_match_the_jax_package(name, case):
    """cp (zigzag: the batch in the zigzag order of ``prepare_batch`` with
    its true positions; ring: natural order) and Ulysses, every rank played
    by one process: the loss and every gradient within the limits above of
    the JAX package's unsharded ``t5_loss_fn``."""
    from galvatron_tpu_torch.ops.ring_attention import zigzag_permutation

    cp, tp, zigzag = SEQ_SHARDING[name]
    params = TT.T5Model(case["tcfg"], "cpu")
    params.load_state_dict(params_from_numpy(case["tree"]))
    loss = played_loss(params, torch_batch(case["batch"]), case["tcfg"], cp, tp,
                       zigzag_permutation(S, cp) if zigzag else None)
    loss.backward()
    assert abs(float(loss.detach()) - case["loss"]) <= LOSS_TOL, (float(loss), case["loss"])
    assert_grads_close({n: p.grad.numpy() for n, p in params.named_parameters()},
                       case["grads"])


def test_a_batch_in_zigzag_order_with_its_positions_gives_the_natural_loss(case):
    """Both streams permuted into zigzag order and carrying their true
    positions (``positions``, ``dec_positions``): the relative bias and the
    decoder's causal mask follow the positions, so the loss and gradients
    are the natural batch's (the JAX package's unsharded run)."""
    from galvatron_tpu_torch.ops.ring_attention import zigzag_permutation

    order = torch.from_numpy(zigzag_permutation(S, 2))
    batch = {k: v[:, order] for k, v in torch_batch(case["batch"]).items()}
    batch["positions"] = batch["dec_positions"] = order.expand(B, S)
    params = TT.T5Model(case["tcfg"], "cpu")
    params.load_state_dict(params_from_numpy(case["tree"]))
    loss = TT.t5_loss_fn(params, batch, case["tcfg"])
    loss.backward()
    assert abs(float(loss.detach()) - case["loss"]) <= LOSS_TOL, (float(loss), case["loss"])
    assert_grads_close({n: p.grad.numpy() for n, p in params.named_parameters()},
                       case["grads"])


def test_the_jax_packages_sharded_t5_matches_its_unsharded_run_on_its_own_batches(case):
    """The reference computes the relative bias by index, and GSPMD gathers
    the keys: on the batches its seq2seq streams make (natural order under
    every cp mode: ``prepare_batch``'s zigzag permutation is the token
    stream's) its cp 2 zigzag run equals its unsharded run. A batch in
    zigzag order it reads by index, as if natural (the port's `positions`
    and ``dec_positions`` carry the true order)."""
    from galvatron_tpu.config.strategy import HybridParallelConfig as JHP
    from galvatron_tpu.config.strategy import LayerStrategy as JLS
    from galvatron_tpu.ops.ring_attention import zigzag_permutation

    hp = JHP(world_size=2, pp=1, layers=[JLS(cp=2)] * 4, global_bsz=B, cp_mode="zigzag")
    model = JT.construct_t5_model(case["jcfg"], hp, jax.devices()[:2])
    params = jax.device_put(case["tree"], model.shardings())

    def sharded(b):
        return float(jax.jit(model.loss_fn)(params, model.shard_batch(
            {k: jnp.asarray(v) for k, v in b.items()})))

    assert abs(sharded(case["batch"]) - case["loss"]) <= LOSS_TOL
    perm = zigzag_permutation(S, 2)
    zig = {k: np.asarray(v)[:, perm] for k, v in case["batch"].items()}
    assert abs(sharded(zig) - case["loss"]) > 100 * LOSS_TOL
