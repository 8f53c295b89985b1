"""Port parity, the Swin family (hierarchical window attention) on the CPU
against the JAX package, from the same seeded weights (the numpy bridge)
and inputs, at the reference's ``swin-test`` size with depths 2/2/2/1 (64 x
64 images in 4 x 4 patches, window 4: shifted blocks in stages 0 and 1, a
stage whose window covers it, a last stage whose window clamps to its
2 x 2 resolution, three patch merges; fp32 compute):

- the loss within 2e-5 of ``swin_loss_fn`` and every gradient within
  1e-4 * max|g| + 1e-6 of ``jax.grad``'s; the same through the layout path
  at world 1 (ZeRO-3, ZeRO-2, remat) and as 1F1B pp 2 pipelines hosted in
  this process (a boundary inside a stage, and one after a merge);
- the profiler writes the JAX package's file names and keys; ``cli
  search`` writes the JAX package's strategy JSON from the same profiles;
- cp and Ulysses are refused at any pp, GPipe and heads that tp does not
  divide too; the lint takes per-stage head counts; no analytic FLOPs;
- ``cli train --model_type swin --device cpu`` takes 3 steps from a vision
  shard.

The world-2/4 layouts (tp 2 + ZeRO-2, pp 2 x tp 2) ride the workers of
``tests/test_torch_parallel.py``.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from galvatron_tpu.models import swin as JS
from galvatron_tpu_torch.models import swin as TS
from galvatron_tpu_torch.tools.from_jax import _flatten, params_from_numpy

LOSS_TOL, GRAD_REL, GRAD_ABS = 2e-5, 1e-4, 1e-6
B = 4
SIZE, DEPTHS = "swin-test", (2, 2, 2, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread beside JAX's CPU backend in this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    jcfg = JS.swin_config(SIZE, depths=DEPTHS, compute_dtype=jnp.float32)
    tcfg = TS.swin_config(SIZE, depths=DEPTHS, compute_dtype=torch.float32)
    tree = jax.device_get(JS.init_swin_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)

    def perturb(path, a):  # norm scales and biases off their init
        key = jax.tree_util.keystr(path)
        if "scale" in key or "bias" in key:
            return np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32) * 0.1
        return np.asarray(a)
    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    r = np.random.RandomState(3)
    b = {"pixels": r.randn(B, 64, 64, 3).astype(np.float32), "labels": r.randint(0, 10, (B,))}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: JS.swin_loss_fn(p, jb, jcfg)))(tree)
    flat = {}
    _flatten(jax.device_get(grads), "", flat)
    return dict(jcfg=jcfg, tcfg=tcfg, tree=tree, batch=b, loss=float(loss),
                grads={n: np.asarray(v) for n, v in flat.items()})


def torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def assert_grads_close(got, want):
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        err = float(np.abs(np.asarray(got[n]) - w).max())
        assert err <= GRAD_REL * np.abs(w).max() + GRAD_ABS, (n, err, np.abs(w).max())


def test_loss_and_every_gradient_match_the_jax_package(case):
    params = TS.SwinModel(case["tcfg"], "cpu")
    params.load_state_dict(params_from_numpy(case["tree"]))
    loss = TS.swin_loss_fn(params, torch_batch(case["batch"]), case["tcfg"])
    loss.backward()
    assert abs(float(loss.detach()) - case["loss"]) <= LOSS_TOL, (float(loss), case["loss"])
    assert_grads_close({n: p.grad.numpy() for n, p in params.named_parameters()},
                       case["grads"])


_L = dict
STRATEGIES = {
    "zero3_zero2_remat": dict(layers=[_L(fsdp=1, checkpoint=1), _L(), _L(fsdp=1), _L(),
                                      _L(checkpoint=1), _L(), _L(fsdp=1)], chunks=2,
                              default_dp_type="zero2"),
}
# 1F1B wants equal stages, so the pipelines run 8 blocks
PIPELINES = {
    # stages of 4: the boundary after block 3, the last of stage 1, where a
    # merge follows; remat and ZeRO-3 inside
    "1f1b_pp2_after_merge": dict(depths=(2, 2, 3, 1), pp=2,
                                 layers=[_L(fsdp=1), _L(checkpoint=1), _L(), _L()] * 2),
    # stages of 2 at depths 1/1/5/1: boundaries inside stage 2
    "1f1b_pp4_inside_stage": dict(depths=(1, 1, 5, 1), pp=4, layers=[_L()] * 8),
}


def _run_layout(tcfg, hp, tree, batch):
    from galvatron_tpu_torch.runtime import distributed as TDIST
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model

    with TDIST.process_group("cpu") as dev:
        model = construct_hybrid_parallel_model(tcfg, hp, dev,
                                                transport="local" if hp.pp > 1 else "p2p")
        params = model.shard_params(tree)
        loss, grads = model.loss_and_grads(params, torch_batch(batch))
        full = {n: g.numpy() for n, g in model.gather_grads(grads).items()}
        evaluated = float(model.eval_loss(params, torch_batch(batch)))
    return float(loss), full, evaluated


def test_world_one_layouts_match_the_jax_package(case):
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig, LayerStrategy

    kw = dict(STRATEGIES["zero3_zero2_remat"])
    hp = HybridParallelConfig(world_size=1, pp=1, global_bsz=B,
                              layers=[LayerStrategy(**s) for s in kw.pop("layers")], **kw)
    loss, full, evaluated = _run_layout(case["tcfg"], hp, params_from_numpy(case["tree"]),
                                        case["batch"])
    assert abs(loss - case["loss"]) <= LOSS_TOL and abs(evaluated - case["loss"]) <= LOSS_TOL
    assert_grads_close(full, case["grads"])


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_hosted_1f1b_pipelines_match_the_unpipelined_port_and_the_jax_loss(name, case):
    """A pipeline whose boundaries fall after a merge, or inside a stage
    (each boundary its own resolution and width): loss and gradients of
    the port's unpipelined run and the JAX pp 1 loss, within the limits
    above."""
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig, LayerStrategy

    kw = PIPELINES[name]
    jcfg = JS.swin_config(SIZE, depths=kw["depths"], compute_dtype=jnp.float32)
    tcfg = TS.swin_config(SIZE, depths=kw["depths"], compute_dtype=torch.float32)
    tree = jax.device_get(JS.init_swin_params(jax.random.PRNGKey(2), jcfg))
    jb = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    want = float(jax.jit(lambda p: JS.swin_loss_fn(p, jb, jcfg))(tree))
    plain = TS.SwinModel(tcfg, "cpu")
    plain.load_state_dict(params_from_numpy(tree))
    ref = TS.swin_loss_fn(plain, torch_batch(case["batch"]), tcfg)
    ref.backward()
    pp = kw["pp"]
    hp = HybridParallelConfig(world_size=pp, pp=pp, global_bsz=B, chunks=2,
                              pipeline_type="pipedream_flush",
                              layers=[LayerStrategy(**s) for s in kw["layers"]])
    loss, full, evaluated = _run_layout(tcfg, hp, params_from_numpy(tree), case["batch"])
    assert abs(loss - want) <= LOSS_TOL and abs(evaluated - want) <= LOSS_TOL
    assert abs(float(ref.detach()) - want) <= LOSS_TOL
    assert_grads_close(full, {n: p.grad.numpy() for n, p in plain.named_parameters()})


def test_refusals_and_the_lint():
    """cp and Ulysses are refused at any pp (the reference's
    ``validate_swin_config``), GPipe and unequal divisions under pp, heads
    that tp does not divide; the lint's model checks skip the per-stage
    head counts instead of failing on them; Swin has no analytic FLOPs."""
    from galvatron_tpu_torch.analysis.strategy_lint import lint_hp, train_refusals
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig, LayerStrategy
    from galvatron_tpu_torch.obs import flops as TFL

    cfg = TS.swin_config(SIZE, depths=DEPTHS)

    def hp(**kw):
        layers = kw.pop("layers", [LayerStrategy()] * 7)
        return HybridParallelConfig(global_bsz=4, layers=layers, **dict(dict(pp=1), **kw))

    for bad in (LayerStrategy(cp=2), LayerStrategy(tp=2, sp=1)):
        for pp, extra in ((1, {}), (2, dict(pp_division=[4, 3],
                                            pipeline_type="pipedream_flush"))):
            problems = train_refusals(hp(world_size=2 * pp, pp=pp, layers=[bad] * 7, **extra),
                                      cfg)
            assert any(p.startswith("swin windowed attention has no sequence dimension")
                       for p in problems), problems
    assert any("pipedream_flush" in p for p in train_refusals(
        hp(world_size=2, pp=2, pp_division=[4, 3]), TS.swin_config(SIZE, depths=DEPTHS)))
    assert any("requires equal layers per stage" in p for p in train_refusals(
        hp(world_size=2, pp=2, pp_division=[4, 3], pipeline_type="pipedream_flush"), cfg))
    three = TS.swin_config(SIZE, depths=DEPTHS, num_heads=(3, 2, 2, 2))
    tp2 = hp(world_size=2, layers=[LayerStrategy(tp=2)] * 7)
    assert train_refusals(tp2, three) == ["block 0 (stage 0) has 3 heads, not divisible by "
                                          "tp=2", "block 1 (stage 0) has 3 heads, not "
                                          "divisible by tp=2"]
    assert train_refusals(tp2, cfg) == []
    assert lint_hp(tp2, model_cfg=cfg, mode="train").ok
    assert TFL.train_step_flops(cfg, 8) is None and TFL.flops_note(cfg) is None


# ------------------------------------------------------- profiler and search
def _stub(calls, seq):
    """One `_walltime` for either package's Swin profiler: seconds as a
    function of the timed program's (blocks, batch, resolution; pixels at
    the stage-0 token count) and of the call's index."""

    def stub(fn, args, *rest):
        a0, a1 = args[0], args[1]
        if isinstance(a1, dict):
            n = len(a0["blocks"]) if isinstance(a0, dict) else len(a0.blocks)
            bsz, s = a1["pixels"].shape[0], seq
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
    """Both packages' Swin profilers under one timer stub: the same timed
    programs, equal computation tables (a layer type per stage), file
    names, memory-table keys, per-type parameter sizes and model states."""
    import galvatron_tpu.profiler.model as JPM
    import galvatron_tpu_torch.profiler.model as TPM

    common = dict(profile_batch_size=2, layernum_min=1, layernum_max=2, max_tp_deg=2,
                  mixed_precision="fp32", warmup=1, iters=1)
    jcfg = JS.swin_config(SIZE, image_size=32, compute_dtype=jnp.float32)
    tcfg = TS.swin_config(SIZE, image_size=32, compute_dtype=torch.float32)
    jp = JPM.SwinModelProfiler(jcfg, "swin", JPM.ModelProfileArgs(
        config_dir=str(tmp_path / "jax"), **common))
    tp = TPM.SwinModelProfiler(tcfg, "swin", TPM.ModelProfileArgs(
        device="cpu", config_dir=str(tmp_path / "torch"), **common))
    j_calls, t_calls = [], []
    monkeypatch.setattr(JPM, "_walltime", _stub(j_calls, 64))
    monkeypatch.setattr(TPM, "_walltime", _stub(t_calls, 64))
    monkeypatch.setattr(JPM.ModelProfiler, "_act_bytes_tp", lambda self, *a, **k: None)
    j_out, t_out = jp.profile_all(write=True), tp.profile_all(write=True)
    assert t_calls == j_calls
    assert t_out["computation"] == j_out["computation"]
    assert [p.replace("torch", "jax") for p in tp.config_paths().values()] == \
        list(jp.config_paths().values())
    jm, tm = j_out["memory"], t_out["memory"]
    assert _keys(tm) == _keys(jm)
    for t in range(4):
        assert tm["layertype_%d" % t]["parameter_size"] == jm["layertype_%d" % t]["parameter_size"]
    assert tm["other_memory_pp_off"]["model_states"] == jm["other_memory_pp_off"]["model_states"]


def _tables():
    act = {1: 3.0, 2: 1.6, 4: 0.9, 8: 0.5, "checkpoint": 0.1}
    states = {1: 2.0, 2: 1.0, 4: 0.5, 8: 0.25}
    half = {k: v / 2 for k, v in states.items()}
    other = {1: 0.9, 2: 0.45, 4: 0.225, 8: 0.112}
    memory = {"layertype_%d" % t: {"parameter_size": 0.05 * 2 ** t,
                                   "tp_activation_per_bsz_dict": {
                                       k: v / 2 ** t for k, v in act.items()}}
              for t in range(4)}
    memory["other_memory_pp_off"] = {"model_states": states, "activation": other}
    memory["other_memory_pp_on"] = {
        s: {"model_states": half, "activation": {k: v / 2 for k, v in other.items()}}
        for s in ("first_stage", "last_stage")}
    time_cfg = {"layertype_%d" % t: 2.0 - 0.3 * t for t in range(4)}
    time_cfg["other_time"] = 0.5
    return time_cfg, memory


@pytest.mark.parametrize("extra", [["--memory_constraint", "0.6"],
                                   ["--memory_constraint", "0.6", "--sp_space", "tp+sp",
                                    "--enable_cp", "1"]])
def test_cli_search_writes_the_jax_packages_json(extra, tmp_path, monkeypatch):
    """Both packages' ``cli search`` on one config dir (a layer type per
    stage) write the same strategy JSON; neither plan shards a sequence."""
    import galvatron_tpu.cli.search as JCLI
    import galvatron_tpu_torch.cli.search as TCLI
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig as THP

    d = tmp_path / "cfg"
    d.mkdir()
    time_cfg, memory = _tables()
    tag = "bf16_hidden32_head2_seqlen256_swin"
    hw = {"allreduce_bandwidth_8chips.json": {"allreduce_size_%d_consec_%d" % (n, c): 140.0
                                              for n in (2, 4, 8) for c in (0, 1)},
          "p2p_bandwidth_8chips.json": {"pp_size_2": 160.0, "pp_size_4": 140.0,
                                        "pp_size_8": 110.0},
          "overlap_coefficient.json": {"overlap_coe": 1.12}}
    for name, data in (("computation_profiling_%s.json" % tag, time_cfg),
                       ("memory_profiling_%s.json" % tag, memory), *hw.items()):
        (d / name).write_text(json.dumps(data))
    monkeypatch.setenv("GALVATRON_WORLD_SIZE", "8")
    outs = {}
    for name, mod in (("jax", JCLI), ("torch", TCLI)):
        outs[name] = str(tmp_path / ("%s.json" % name))
        mod.main(["--model_type", "swin", "--model_size", SIZE, "--config_dir", str(d),
                  "--output_config_path", outs[name], "--log_dir", str(tmp_path / "logs"),
                  "--settle_bsz", "32"] + extra)
    with open(outs["jax"]) as f, open(outs["torch"]) as g:
        assert json.load(f) == json.load(g)
    hp = THP.from_json(outs["torch"], world_size=8)
    assert hp.num_layers == 5 and not any(s.cp > 1 or s.sp for s in hp.layers)


def test_cli_train_runs_swin_from_a_vision_shard(tmp_path):
    from galvatron_tpu_torch.cli import train as T
    from galvatron_tpu_torch.data.dataset import write_vision_dataset

    rng = np.random.RandomState(0)
    write_vision_dataset(str(tmp_path / "shard"),
                         rng.randint(0, 256, (16, 64, 64, 3)).astype(np.uint8),
                         rng.randint(0, 10, 16))
    summary = T.main(["--model_type", "swin", "--model_size", SIZE, "--device", "cpu",
                      "--global_train_batch_size", "4", "--chunks", "2", "--train_iters", "3",
                      "--lr", "1e-3", "--log_interval", "100", "--data_path",
                      str(tmp_path / "shard"), "--split", "1,0,0"])
    assert len(summary["losses"]) == 3 and np.isfinite(summary["losses"]).all()
    assert summary["flash_routes"] == [{"fwd": {}, "bwd": {}}]
    assert summary["images_per_s"] == summary["samples_per_s"]
    assert "mfu" not in summary and "tokens_per_s" not in summary
