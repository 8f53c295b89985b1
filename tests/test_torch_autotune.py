"""The port's online autotuner (``galvatron_tpu_torch/runtime/autotune.py``), its
steady-state detector (``obs/steady.py``) and the per-LayerRun predictions it
calibrates on (``obs/attribution.py``), held against the JAX package's
functions on the same inputs: the detector on the same series, the
calibrator on the same tables and rows, ``predicted_step_ms`` and
``calibrate_from_run`` on the analytic tables of the same strategies, and
``OnlineAutotuner.decide`` over the same decision sequences. Then the
driver: ``cli train --autotune apply`` from a misspecified start (full
remat) swaps once to the searched plan, in memory, and not back, and
``observe`` never swaps. (The reference's own driver tests are not the
oracle: they fail in its tier-1 run.)"""

import jax.numpy as jnp
import pytest
import torch

from galvatron_tpu.config.strategy import HybridParallelConfig as JHP
from galvatron_tpu.config.strategy import LayerStrategy as JLS
from galvatron_tpu.models import base as JM
from galvatron_tpu.obs import attribution as JA
from galvatron_tpu.obs import steady as JSt
from galvatron_tpu.runtime import autotune as JAT
from galvatron_tpu_torch.config.strategy import HybridParallelConfig as THP
from galvatron_tpu_torch.config.strategy import LayerStrategy as TLS
from galvatron_tpu_torch.models import base as TM
from galvatron_tpu_torch.obs import attribution as TA
from galvatron_tpu_torch.obs import steady as TSt
from galvatron_tpu_torch.runtime import autotune as TAT


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _st(state):
    """A SteadyState's fields (the two packages' classes differ)."""
    return None if state is None else vars(state)


SERIES = {
    "settles": [500.0, 300.0, 101.0, 99.0, 100.0, 100.5, 99.5, 100.0],
    "never": [10.0, 100.0, 10.0, 100.0, 10.0, 100.0],
    "empty_and_none": [None, None],
    "flat": [5.0] * 6,
    "late": [1.0, 50.0, 3.0, 90.0, 20.0, 20.0, 20.5, 19.5, 20.0, 20.0],
}


@pytest.mark.parametrize("name", sorted(SERIES))
@pytest.mark.parametrize("window,rel_std", [(5, 0.15), (3, 0.05)])
def test_steady_detection_matches_the_reference(name, window, rel_std):
    values = SERIES[name]
    assert _st(TSt.detect(values, window, rel_std)) == _st(JSt.detect(values, window, rel_std))
    port, ref = TSt.SteadyStateDetector(window, rel_std), JSt.SteadyStateDetector(window, rel_std)
    for v in values:
        assert _st(port.push(v)) == _st(ref.push(v))
        assert _st(port.state()) == _st(ref.state())
        assert port.steady_step_ms() == ref.steady_step_ms()
        assert port.steady_tail() == ref.steady_tail()
    port.reset()
    ref.reset()
    assert _st(port.state()) == _st(ref.state())


BODY = {"run": 0, "predicted_ms": 100.0, "flops_share": 0.8, "predicted_memory_mb": 500.0}
BASE_TIME = {"layertype_0": 10.0, "other_time": [1.0, 2.0], "maxbsz": 42}
BASE_MEM = {
    "layertype_0": {"parameter_size": 7.0, "tp_activation_per_bsz_dict": {"1": 10.0, "2": 6.0}},
    "other_memory_pp_off": {"model_states": {"1": 3.0}, "activation": {"1": 4.0}},
    "other_memory_pp_on": {"first_stage": {"model_states": {"1": 1.5},
                                           "activation": {"1": 2.0}}},
}
CALIBRATIONS = {
    "compute_ratio": ([BODY, {"run": -1, "flops_share": 0.2}], 250.0, {}),
    "comm_subtracted": ([BODY, {"run": -1, "flops_share": 0.2}], 250.0,
                        dict(pred_comm_ms=40.0)),
    "all_comm": ([BODY], 250.0, dict(pred_comm_ms=100.0)),
    "body_floor": ([BODY], 250.0, dict(comm_hidden_ms=1e6)),
    "priced_head": ([BODY, {"run": -1, "flops_share": 0.2, "predicted_ms": 10.0}], 250.0, {}),
    "memory_clamped": ([BODY], 250.0, dict(compiled_memory_mb=10000.0)),
    "memory_scaled": ([BODY], 250.0, dict(compiled_memory_mb=800.0)),
    "no_steady": ([BODY], None, {}),
    "no_rows": ([], 250.0, {}),
    "head_only": ([{"run": -1, "flops_share": 1.0}], 250.0, {}),
}


@pytest.mark.parametrize("name", sorted(CALIBRATIONS))
def test_measured_profiles_match_the_reference(name):
    rows, steady, kw = CALIBRATIONS[name]
    got = TAT.measured_model_profiles(BASE_TIME, BASE_MEM, [dict(r) for r in rows], steady, **kw)
    want = JAT.measured_model_profiles(BASE_TIME, BASE_MEM, [dict(r) for r in rows], steady,
                                       **kw)
    assert got == want


def _cfgs():
    common = dict(hidden_size=256, num_heads=8, num_layers=4, vocab_size=512, max_seq_len=128)
    return (JM.TransformerConfig(compute_dtype=jnp.float32, **common),
            TM.TransformerConfig(compute_dtype=torch.float32, **common))


STRATEGIES = {
    "dp4": dict(world_size=4, layers=[{}] * 4, global_bsz=8, chunks=2),
    "full_remat": dict(world_size=4, layers=[dict(checkpoint=1)] * 4, global_bsz=8, chunks=2),
    "tp2_zero3": dict(world_size=4, layers=[dict(tp=2, fsdp=1)] * 2 + [dict(tp=2)] * 2,
                      global_bsz=8, chunks=2, default_dp_type="zero2"),
    "pp2": dict(world_size=4, pp=2, layers=[{}] * 4, global_bsz=8, chunks=4),
    "mixed_remat": dict(world_size=2, layers=[dict(checkpoint=1, remat_policy="dots_saveable"),
                                              {}, dict(tp=2), dict(checkpoint=1)],
                        global_bsz=4, chunks=1),
}


def _hps(name):
    kw = dict(STRATEGIES[name])
    kw.setdefault("pp", 1)
    layers = kw.pop("layers")
    return (JHP(layers=[JLS(**l) for l in layers], **kw),
            THP(layers=[TLS(**l) for l in layers], **kw))


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_layer_run_predictions_and_step_price_match_the_reference(name):
    jcfg, tcfg = _cfgs()
    jhp, thp = _hps(name)
    got, want = TA.predict_layer_runs(tcfg, thp), JA.predict_layer_runs(jcfg, jhp)
    assert got == want
    assert TAT.predicted_step_ms(tcfg, thp) == pytest.approx(JAT.predicted_step_ms(jcfg, jhp),
                                                            rel=1e-12)


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_calibrate_from_run_matches_the_reference_on_analytic_tables(name):
    from galvatron_tpu.runtime import elastic as JE
    from galvatron_tpu_torch.runtime import elastic as TE

    jcfg, tcfg = _cfgs()
    jhp, thp = _hps(name)
    jbase, tbase = JE.analytic_model_profiles(jcfg, 4), TE.analytic_model_profiles(tcfg, 4)
    got = TAT.calibrate_from_run(tcfg, thp, tbase[0], tbase[1], TA.predict_layer_runs(tcfg, thp),
                                 123.0)
    want = JAT.calibrate_from_run(jcfg, jhp, jbase[0], jbase[1],
                                  JA.predict_layer_runs(jcfg, jhp), 123.0)
    assert got == want
    tcal, mcal = got
    assert TAT.predicted_step_ms(tcfg, thp, tcal, mcal) == pytest.approx(
        JAT.predicted_step_ms(jcfg, jhp, *want), rel=1e-12)


# each script: observed step times, then (incumbent, winner, remaining,
# identical) decisions, with a swap marked after a "swap" verdict
DECISIONS = {
    "swap": ([100.0] * 3, [(100.0, 80.0, 50, False)], {}),
    "hysteresis": ([100.0] * 3, [(100.0, 80.0, 50, False)], dict(margin=0.25)),
    "identical_and_infeasible": ([100.0] * 3, [(100.0, 100.0, 50, True)], {}),
    "infeasible": ([100.0] * 3, [(None, None, 50, False)], {}),
    "learned_swap_cost_blocks_the_next": (
        [100.0] * 3 + [900.0] + [80.0] * 3,
        [(100.0, 80.0, 50, False), (80.0, 70.0, 5, False)], {}),
}


@pytest.mark.parametrize("name", sorted(DECISIONS))
def test_online_decisions_match_the_reference(name):
    times, decisions, kw = DECISIONS[name]
    tuners = [m.OnlineAutotuner(m.AutotuneConfig(mode="apply", window=3, **kw))
              for m in (JAT, TAT)]
    trace = [[], []]
    for tuner, out in zip(tuners, trace):
        queue = list(times)
        for inc, win, remaining, same in decisions:
            while queue and not tuner.plan_pending:
                tuner.observe_step(queue.pop(0), iteration=len(out))
            out.append(tuner.plan_pending)
            d = tuner.decide(inc, win, remaining, identical=same)
            out.append((d.reason, d.swap, d.predicted_saving_ms, d.swap_cost_ms))
            if d.swap:
                tuner.mark_swapped(len(out), relayout_wall_ms=200.0,
                                   predicted_saving_ms=d.predicted_saving_ms)
        out.append((tuner.plans, tuner.swaps, tuner.config.swap_cost_ms))
    assert trace[0] == trace[1]


TINY = ["--model_type", "gpt", "--set_model_config_manually", "1", "--hidden_size", "64",
        "--num_attention_heads", "4", "--num_layers", "4", "--vocab_size", "96",
        "--seq_length", "32", "--global_train_batch_size", "4", "--chunks", "2",
        "--mixed_precision", "fp32", "--lr", "1e-2", "--device", "cpu", "--log_interval", "100",
        "--checkpoint", "1", "--train_iters", "14", "--autotune_window", "3",
        "--autotune_rel_std", "10"]


def _train(extra):
    from galvatron_tpu_torch.cli import train as T

    return T.train(T.initialize_galvatron(argv=TINY + extra, mode="train"))


def test_apply_swaps_once_from_full_remat_and_observe_never_swaps():
    """From every layer under full remat, the re-search on the measured
    tables finds a plan without it: apply swaps to it once in memory (the
    loss goes on from the same step), the next epoch finds it identical and
    stays; observe logs the same decision and swaps nothing."""
    applied = _train(["--autotune", "apply"])
    a = applied["autotune"]
    assert a["swaps"] == 1 and a["plans"] >= 2
    assert a["epochs"][0]["reason"] == "swap" and a["epochs"][0]["swapped"]
    assert all(not e["swapped"] for e in a["epochs"][1:])
    assert a["epochs"][1]["reason"] == "identical"
    assert applied["migrations"][0]["reason"] == "autotune"
    assert "1" not in applied["strategy"]["checkpoint"].split(",")
    assert len(applied["losses"]) == 14
    observed = _train(["--autotune", "observe"])
    o = observed["autotune"]
    assert o["swaps"] == 0 and o["epochs"][0]["reason"] == "swap"
    assert not o["epochs"][0]["swapped"] and "migrations" not in observed
    assert observed["losses"][:a["epochs"][0]["iteration"]] == \
        applied["losses"][:a["epochs"][0]["iteration"]]


def test_emit_profiles_writes_the_references_tables(tmp_path):
    """The offline calibrator on one telemetry stream (a run_start with
    the model's shape and strategy, step times that settle, the layer_run
    rows): both packages write the same measured tables, in the profiler's
    file names."""
    import json
    import os

    _, tcfg = _cfgs()
    _, thp = _hps("tp2_zero3")
    events = [{"type": "run_start", "hidden_size": 256, "num_heads": 8, "vocab_size": 512,
               "seq_len": 128, "num_layers": 4, "world_size": 4, "model_type": "llama",
               "mixed_precision": "bf16", "strategy": thp.to_json_dict()}]
    events += [{"type": "step", "iter": i, "iter_ms": ms}
               for i, ms in enumerate([300.0, 150.0, 101.0, 99.0, 100.0, 100.5, 99.5])]
    events += [dict(row, type="layer_run") for row in TA.predict_layer_runs(tcfg, thp)]
    got = TAT.emit_profiles(events, str(tmp_path / "port"))
    want = JAT.emit_profiles([dict(e) for e in events], str(tmp_path / "ref"))
    assert [os.path.basename(got[k]) for k in sorted(got)] == \
        [os.path.basename(want[k]) for k in sorted(want)]
    for k in got:
        with open(got[k]) as a, open(want[k]) as b:
            assert json.load(a) == json.load(b), k
