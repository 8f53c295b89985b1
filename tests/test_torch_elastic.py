"""Port parity, elastic resume on the CPU.

- Planning against the JAX package: ``analytic_model_profiles`` and
  ``analytic_hardware_profiles`` equal (tables bitwise) and
  ``search_surviving_strategy`` returns the same strategy JSON at worlds
  1, 2 and 4 (and under a budget that forces remat);
  ``estimate_stage_memory_mb`` equals it; the provenance block (with the
  memory budget) equals the JAX package's.
- Refusals, as the reference's ``tests/cli/test_elastic.py``: another model
  (GLS201), a checkpoint without optimizer state restored across
  strategies (GLS202), a budget nothing fits (GLS203), no provenance
  (GLS204), a changed world under ``resume`` without a strategy file
  (GLS205); the "match" and "strategy_file" plans; the train CLI exits 2
  on a refusal.
- A cross-strategy restore at world 1 in this process: the train CLI saves
  a pp 1 run at step 3; a pipeline of two stages that this process hosts
  (``LocalTransport``) restores it through ``load_checkpoint(target=, allow_cross=True)``
  (params and both moments bitwise against ``load_full_state``), trains
  three steps within 5e-5 of the uninterrupted run's losses, saves (one
  file per stage rank, ``rank_views``), and ``cli train --elastic resume``
  brings that pp 2 checkpoint back under pp 1, bitwise, to finish the run
  within the same limit; a plain ``--load`` under another strategy still
  refuses (GLS206).

The world-2 cases (a tp 2 + ZeRO-3 + ZeRO-2 checkpoint resumed under every
layer plain dp, under tp 1 and under 1F1B pp 2, the pp 2 checkpoint under
pp 1, and the world-2 checkpoint at world 1 in the pytest process) ride
the worker of ``tests/test_torch_parallel.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from galvatron_tpu.config.strategy import HybridParallelConfig as JHP
from galvatron_tpu.config.strategy import LayerStrategy as JLS
from galvatron_tpu.models import base as JM
from galvatron_tpu.runtime import elastic as JE
from galvatron_tpu.runtime.optimizer import OptimizerArgs as JOA
from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError
from galvatron_tpu_torch.config.strategy import HybridParallelConfig as THP
from galvatron_tpu_torch.config.strategy import LayerStrategy as TLS
from galvatron_tpu_torch.models import base as TM
from galvatron_tpu_torch.runtime import checkpoint as ck
from galvatron_tpu_torch.runtime import elastic as els
from galvatron_tpu_torch.runtime.optimizer import OptimizerArgs
from galvatron_tpu_torch.runtime.provenance import build_provenance

TRAJ_TOL = 5e-5  # the layout trajectory limit of tests/test_torch_parallel.py
TINY = dict(hidden_size=32, num_heads=2, num_layers=4, vocab_size=64, max_seq_len=16)
WIDE = dict(hidden_size=256, num_heads=4, num_layers=4, vocab_size=4096, max_seq_len=512)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread beside JAX's CPU backend in this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(**kw):
    kw = dict(TINY, **kw)
    return (JM.TransformerConfig(compute_dtype=jnp.float32, **kw),
            TM.TransformerConfig(compute_dtype=torch.float32, **kw))


class Args:
    """The flags resolve_resume_strategy reads."""

    def __init__(self, load, elastic="search", elastic_strategy=None, elastic_memory_gb=None):
        self.load, self.elastic, self.elastic_strategy = load, elastic, elastic_strategy
        self.elastic_memory_gb = elastic_memory_gb
        self.mixed_precision, self.model_type, self.config_dir = "fp32", "llama", None


def saved_provenance(tmp_path, tcfg, hp, budget=16.0, opt_state=True):
    """A committed step whose provenance records `hp` (its files hold a
    token parameter: planning reads the manifest alone)."""
    d = str(tmp_path / "ck")
    state = None
    if opt_state:
        from galvatron_tpu_torch.runtime.optimizer import AdamState
        state = AdamState(count=2, mu={"w": torch.zeros(2)}, nu={"w": torch.zeros(2)})
    ck.save_checkpoint(d, 2, {"w": torch.ones(2)}, state, hp,
                       provenance=build_provenance(hp, tcfg, OptimizerArgs(),
                                                   memory_budget_gb=budget))
    return d


# ---------------------------------------------------------------- planning
@pytest.mark.parametrize("world", [1, 2, 4])
def test_analytic_tables_and_surviving_search_equal_the_jax_packages(world):
    jcfg, tcfg = cfgs()
    assert els.analytic_model_profiles(tcfg, world) == JE.analytic_model_profiles(jcfg, world)
    assert els.analytic_hardware_profiles(world) == JE.analytic_hardware_profiles(world)
    for budget in (16.0, 0.05):  # 0.05 GB: remat or a pipeline must pay
        want = JE.search_surviving_strategy(jcfg, world, 8, budget, model_type="llama",
                                            default_dp_type="zero2")
        got = els.search_surviving_strategy(tcfg, world, 8, budget, model_type="llama",
                                            default_dp_type="zero2")
        assert (got is None) == (want is None)
        if want is not None:
            assert got.to_json_dict() == want.to_json_dict()


@pytest.mark.parametrize("kw", [
    dict(world_size=4, layers=[dict(tp=2), dict(fsdp=1), dict(checkpoint=1), dict(tp=4)],
         default_dp_type="zero2", chunks=2),
    dict(world_size=4, pp=2, layers=[dict(tp=2)] * 4, pipeline_type="pipedream_flush",
         chunks=4, vocab_tp=2),
    dict(world_size=2, pp=2, layers=[dict(checkpoint=1, remat_policy="dots_saveable")] * 4,
         chunks=2),
])
def test_stage_memory_estimate_equals_the_jax_packages(kw):
    from galvatron_tpu.analysis.strategy_lint import estimate_stage_memory_mb as jest
    from galvatron_tpu_torch.analysis.strategy_lint import estimate_stage_memory_mb as test

    jcfg, tcfg = cfgs(**WIDE)
    kw = dict(kw, global_bsz=8)
    kw.setdefault("pp", 1)
    layers = kw.pop("layers")
    jhp = JHP(layers=[JLS(**s) for s in layers], **kw)
    thp = THP(layers=[TLS(**s) for s in layers], **kw)
    assert test(thp, tcfg) == jest(jhp, jcfg)


def test_provenance_with_the_memory_budget_equals_the_jax_packages():
    jcfg, tcfg = cfgs()
    jhp, thp = JHP.uniform(4, 4, tp=2, global_bsz=8), THP.uniform(4, 4, tp=2, global_bsz=8)
    want = JE.build_provenance(jhp, jcfg, JOA(), memory_budget_gb=12.5)
    got = build_provenance(thp, tcfg, OptimizerArgs(), memory_budget_gb=12.5)
    assert got == want and got["memory_budget_gb"] == 12.5


# ---------------------------------------------------------------- refusals
def test_model_digest_mismatch_refused(tmp_path):
    _, tcfg = cfgs()
    d = saved_provenance(tmp_path, tcfg, THP.uniform(8, 4, global_bsz=8))
    with pytest.raises(DiagnosticError, match="GLS201"):
        els.resolve_resume_strategy(Args(d), cfgs(activation="swiglu")[1], 4)


def test_missing_provenance_refused(tmp_path):
    d = str(tmp_path / "ck")
    ck.save_checkpoint(d, 0, {"w": torch.ones(2, 2)})  # no provenance
    with pytest.raises(DiagnosticError, match="GLS204"):
        els.resolve_resume_strategy(Args(d), cfgs()[1], 4)


def test_infeasible_budget_refused(tmp_path):
    """A budget far below what any 2-device strategy needs refuses with
    GLS203 rather than emitting a doomed plan; so does a strategy file
    whose estimate exceeds it."""
    _, tcfg = cfgs(**WIDE)
    hp = THP.uniform(8, 4, global_bsz=8)
    d = saved_provenance(tmp_path, tcfg, hp)
    with pytest.raises(DiagnosticError, match="GLS203"):
        els.resolve_resume_strategy(Args(d, elastic_memory_gb=1e-4), tcfg, 2)
    spath = str(tmp_path / "two.json")
    THP.uniform(2, 4, global_bsz=8).save(spath)
    with pytest.raises(DiagnosticError, match="GLS203"):
        els.resolve_resume_strategy(Args(d, "resume", spath, elastic_memory_gb=0.01), tcfg, 2)


def test_resume_mode_without_strategy_refused(tmp_path):
    _, tcfg = cfgs()
    d = saved_provenance(tmp_path, tcfg, THP.uniform(8, 4, global_bsz=8))
    with pytest.raises(DiagnosticError, match="GLS205"):
        els.resolve_resume_strategy(Args(d, "resume"), tcfg, 4)


def test_matching_world_returns_saved_strategy_and_a_file_replans(tmp_path):
    _, tcfg = cfgs()
    hp = THP.uniform(8, 4, tp=2, global_bsz=8)
    d = saved_provenance(tmp_path, tcfg, hp)
    plan = els.resolve_resume_strategy(Args(d), tcfg, 8)
    assert plan.action == "match" and not plan.cross_strategy
    assert plan.hp.to_json_dict() == hp.to_json_dict() and plan.ckpt_iteration == 2
    spath = str(tmp_path / "replacement.json")
    THP.uniform(4, 4, tp=2, global_bsz=8).save(spath)
    plan = els.resolve_resume_strategy(Args(d, "resume", spath), tcfg, 4)
    assert plan.action == "strategy_file" and plan.cross_strategy
    assert plan.hp.world_size == 4 and plan.hp.layers[0].tp == 2
    assert plan.saved_hp.world_size == 8


def test_cross_strategy_restore_without_optimizer_state_refused(tmp_path):
    """The saved step has params only; the target wants its Adam state."""
    from galvatron_tpu_torch.runtime import distributed as TDIST
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model
    from galvatron_tpu_torch.runtime.optimizer import get_optimizer_and_scheduler

    _, tcfg = cfgs()
    with TDIST.process_group("cpu") as dev:
        saved = THP.uniform(1, 4, global_bsz=4, chunks=2)
        m = construct_hybrid_parallel_model(tcfg, saved, dev)
        params = m.init_params(0)
        d = str(tmp_path / "ck")
        ck.save_checkpoint(d, 1, m.checkpoint_view(params)[0], None, saved,
                           provenance=build_provenance(saved, tcfg))
        target = construct_hybrid_parallel_model(
            tcfg, THP.uniform(1, 4, sdp=1, checkpoint=1, global_bsz=4, chunks=2), dev)
        tx, _ = get_optimizer_and_scheduler(OptimizerArgs())
        p2 = target.init_params(1)
        with pytest.raises(DiagnosticError, match="GLS202"):
            ck.load_checkpoint(d, params_target=p2, opt_state_target=target.init_opt_state(
                tx, p2), target=target, allow_cross=True, model_cfg=tcfg)


@pytest.mark.parametrize("copy", ["exact", "one_element_off"])
def test_cross_strategy_restore_checks_continuity_against_the_manifest(copy, tmp_path,
                                                                       monkeypatch):
    """The continuity check holds the restored leaves against the
    manifest's records, not against leaves rebuilt by the copy's own code:
    a copy that is off in one element of one moment fails with GLS016; an
    exact one restores the saved state bitwise and checks every leaf."""
    from galvatron_tpu_torch.runtime import distributed as TDIST
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model
    from galvatron_tpu_torch.runtime.optimizer import get_optimizer_and_scheduler

    _, tcfg = cfgs()
    tx, _ = get_optimizer_and_scheduler(OptimizerArgs())
    d = str(tmp_path / "ck")
    gen = torch.Generator().manual_seed(0)
    with TDIST.process_group("cpu") as dev:
        saved = THP.uniform(1, 4, global_bsz=4, chunks=2)
        m = construct_hybrid_parallel_model(tcfg, saved, dev)
        params = m.init_params(0)
        state = m.init_opt_state(tx, params)
        for st in state.values():
            st.count = 5
            for t in (*st.mu.values(), *st.nu.values()):
                t.copy_(torch.randn(t.shape, generator=gen))
        ck.save_checkpoint(d, 5, *m.checkpoint_view(params, state), saved,
                           provenance=build_provenance(saved, tcfg))
        if copy != "exact":
            fill = ck.SavedShards.fill

            def off(self, item, name, out, region):
                fill(self, item, name, out, region)
                if item == "nu" and name == "layers.1.wo_mlp.kernel":
                    out.view(-1)[0] += 1.0
            monkeypatch.setattr(ck.SavedShards, "fill", off)
        target = construct_hybrid_parallel_model(
            tcfg, THP.uniform(1, 4, sdp=1, checkpoint=1, global_bsz=4, chunks=2), dev)
        p2 = target.init_params(1)
        s2 = target.init_opt_state(tx, p2)
        if copy != "exact":
            with pytest.raises(DiagnosticError, match="GLS016"):
                ck.load_checkpoint(d, params_target=p2, opt_state_target=s2, target=target,
                                   allow_cross=True, model_cfg=tcfg)
            return
        _, _, meta = ck.load_checkpoint(d, params_target=p2, opt_state_target=s2,
                                        target=target, allow_cross=True, model_cfg=tcfg)
        _assert_state_equal(_snapshot(target, p2, s2), ck.load_full_state(d, 5, tcfg))
    assert meta["restore"]["leaves_checked"] == 3 * len(dict(p2[0].named_parameters()))


def test_restore_telemetry_event_takes_the_cross_strategy_fields():
    """The restore event of a cross-strategy restore on a card (where the
    continuity check's device memory is measured) passes the telemetry
    schema: the event is emitted on the rank with the sink only, after the
    restore's last collective, so a rejected key would strand the others."""
    from galvatron_tpu_torch.obs import telemetry

    sink = telemetry.install(telemetry.MemorySink())
    try:
        ck._emit_restore(3, "ck", {"seconds": 1.5, "cross_strategy": True,
                                   "device_extra_gb": 0.52}, 1)
    finally:
        telemetry.uninstall(sink)
    (event,) = [e for e in sink.events if e["type"] == "checkpoint_restore"]
    assert event["device_extra_gb"] == 0.52 and event["cross_strategy"] is True
    assert event["torn_skipped"] == 1 and event["duration_ms"] == 1500.0


# ------------------------------------------------- world 1, pp 1 <-> pp 2
GPT_ARGV = ["--model_type", "gpt", "--set_model_config_manually", "1", "--hidden_size", "64",
            "--num_attention_heads", "4", "--num_layers", "4", "--vocab_size", "128",
            "--seq_length", "32", "--global_train_batch_size", "4", "--chunks", "2",
            "--lr", "1e-3", "--lr_decay_style", "constant", "--log_interval", "100",
            "--device", "cpu", "--mixed_precision", "fp32"]
PP1 = {"pp_deg": 1, "tp_sizes_enc": "1,1,1,1", "tp_consecutive_flags": "1,1,1,1",
       "dp_types_enc": "0,1,0,1", "checkpoint": "1,0,0,1", "default_dp_type": "zero2",
       "global_bsz": 4, "chunks": 2}
PP2 = {"pp_deg": 2, "pp_division": "1,3", "pipeline_type": "pipedream_flush",
       "tp_sizes_enc": "1,1,1,1", "tp_consecutive_flags": "1,1,1,1",
       "dp_types_enc": "0,0,1,0", "default_dp_type": "zero2", "global_bsz": 4, "chunks": 2}


def _train(argv):
    from galvatron_tpu_torch.cli import train as T

    return T.train(T.initialize_galvatron(argv=GPT_ARGV + argv, mode="train"))


def _assert_state_equal(a, b):
    pa, sa, _ = a
    pb, sb, _ = b
    assert sorted(pa) == sorted(pb) and sa.count == sb.count
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
        assert torch.equal(sa.mu[n], sb.mu[n]) and torch.equal(sa.nu[n], sb.nu[n]), n


def _snapshot(model, params, state):
    """Copies of the gathered params and Adam state (a one-rank gather may
    hand back the live tensors, which the steps update in place)."""
    from galvatron_tpu_torch.runtime.optimizer import AdamState

    full = model.gather_opt_state(state)
    return ({n: t.clone() for n, t in model.gather_params(params).items()},
            AdamState(count=full.count, mu={n: t.clone() for n, t in full.mu.items()},
                      nu={n: t.clone() for n, t in full.nu.items()}), None)


@pytest.fixture(scope="module")
def pipeline_round_trip(tmp_path_factory):
    """pp 1 (CLI) -> pp 2 hosted (model API) -> pp 1 (CLI, --elastic)."""
    from galvatron_tpu_torch.cli.arguments import initialize_galvatron, model_config_from_args
    from galvatron_tpu_torch.runtime import distributed as TDIST
    from galvatron_tpu_torch.runtime.dataloader import build_data_iterator
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model
    from galvatron_tpu_torch.runtime.optimizer import get_optimizer_and_scheduler
    from galvatron_tpu_torch.runtime.provenance import build_provenance as prov_of
    from galvatron_tpu_torch.cli.train import optimizer_args_from

    tmp = tmp_path_factory.mktemp("elastic")
    paths = {}
    for name, strategy in (("pp1", PP1), ("pp2", PP2)):
        paths[name] = str(tmp / ("%s.json" % name))
        with open(paths[name], "w") as f:
            json.dump(strategy, f)
    out = {"full": _train(["--train_iters", "9", "--galvatron_config_path", paths["pp1"]])}
    out["first"] = _train(["--train_iters", "3", "--galvatron_config_path", paths["pp1"],
                           "--save", str(tmp / "a")])
    # the pp 2 pipeline, both stages hosted here, restores the pp 1 step
    args = initialize_galvatron(GPT_ARGV + ["--train_iters", "6"], mode="train")
    fam, cfg = model_config_from_args(args)
    hp2 = THP.from_json(paths["pp2"], world_size=2, mixed_precision="fp32")
    with TDIST.process_group("cpu") as dev:
        model = construct_hybrid_parallel_model(cfg, hp2, dev, transport="local")
        tx, _ = get_optimizer_and_scheduler(optimizer_args_from(args))
        params = model.init_params(99)
        state = model.init_opt_state(tx, params)
        _, _, meta = ck.load_checkpoint(str(tmp / "a"), params_target=params,
                                        opt_state_target=state, target=model,
                                        allow_cross=True, model_cfg=cfg)
        out["restore_meta"] = meta
        out["restored"] = _snapshot(model, params, state)
        step = model.make_train_step(tx)
        stream = build_data_iterator(args, fam, cfg, hp2, start_step=3)
        losses = []
        for _ in range(3):
            params, state, metrics = step(params, state, next(stream))
            losses.append(float(metrics["loss"]))
        out["pp2_losses"] = losses
        ck.save_checkpoint(str(tmp / "b"), 6, None, rank_views=model.checkpoint_views(
            params, state), hp=hp2, provenance=prov_of(hp2, cfg, optimizer_args_from(args)),
            train_meta={"iteration": 6})
        out["pp2_trained"] = _snapshot(model, params, state)
    out["saved_a"] = ck.load_full_state(str(tmp / "a"), 3, cfg)
    out["saved_b"] = ck.load_full_state(str(tmp / "b"), 6, cfg)
    # pp 2 (world 2) -> pp 1 (world 1) through the CLI: zero steps and a
    # save (the restored state as written under pp 1), then the rest
    elastic = ["--elastic", "resume", "--elastic_strategy", paths["pp1"], "--load",
               str(tmp / "b")]
    out["restored_pp1"] = _train(elastic + ["--train_iters", "6", "--save", str(tmp / "c")])
    out["saved_c"] = ck.load_full_state(str(tmp / "c"), 6, cfg)
    out["resumed"] = _train(elastic + ["--train_iters", "9"])
    try:
        _train(["--train_iters", "9", "--galvatron_config_path", paths["pp1"], "--load",
                str(tmp / "b")])
        out["plain_refused"] = "none"
    except DiagnosticError as e:
        out["plain_refused"] = ",".join(d.code for d in e.diagnostics)
    out["dir"] = tmp
    return out


def test_pp1_checkpoint_restores_into_hosted_pp2_bitwise(pipeline_round_trip):
    r = pipeline_round_trip
    _assert_state_equal(r["restored"], r["saved_a"])
    meta = r["restore_meta"]
    assert meta["iteration"] == 3 and meta["restore"]["cross_strategy"]
    assert meta["restore"]["saved_world_size"] == 1


def test_hosted_pp2_continues_the_pp1_trajectory(pipeline_round_trip):
    r = pipeline_round_trip
    np.testing.assert_allclose(r["first"]["losses"], r["full"]["losses"][:3], rtol=0, atol=0)
    np.testing.assert_allclose(r["pp2_losses"], r["full"]["losses"][3:6], rtol=0, atol=TRAJ_TOL)


def test_hosted_pp2_save_writes_a_file_per_stage_rank(pipeline_round_trip):
    r = pipeline_round_trip
    files = sorted(os.listdir(os.path.join(r["dir"], "b", "6")))
    assert files == ["rank0.pt", "rank1.pt", "train_meta.json"]
    assert ck.read_manifest(str(r["dir"] / "b"), 6)["world_size"] == 2
    _assert_state_equal(r["saved_b"], r["pp2_trained"])


def test_pp2_checkpoint_resumes_under_pp1_through_the_cli(pipeline_round_trip):
    """The state the pp 1 run restored (written back by a zero-step run)
    is the pp 2 checkpoint's bitwise; its three more steps stay within the
    trajectory limit of the uninterrupted pp 1 run; a plain --load of the
    pp 2 checkpoint under pp 1 still refuses (GLS206)."""
    r = pipeline_round_trip
    assert r["restored_pp1"]["losses"] == []
    assert r["restored_pp1"]["checkpoint_restore"]["cross_strategy"]
    _assert_state_equal(r["saved_c"], r["saved_b"])
    np.testing.assert_allclose(r["resumed"]["losses"], r["full"]["losses"][6:], rtol=0,
                               atol=TRAJ_TOL)
    assert r["plain_refused"] == "GLS206"


def test_cli_exits_2_on_an_elastic_refusal(pipeline_round_trip, capsys):
    from galvatron_tpu_torch.cli import train as T

    with pytest.raises(SystemExit) as e:
        T.main(GPT_ARGV + ["--train_iters", "9", "--elastic", "resume", "--load",
                           str(pipeline_round_trip["dir"] / "b")])
    assert e.value.code == 2
    assert "GLS205" in capsys.readouterr().err
