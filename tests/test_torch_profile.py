"""The port's profilers, validation and search CLI against the JAX
package's, on the CPU at tiny sizes.

- Model profiler: one timer stub (the same time for each (layers, batch,
  sequence) and call) fed to both packages gives equal computation tables
  and file names in every profile mode, with the remat fractions; the memory
  tables' parameter and model-state entries are equal, and the activation
  bytes autograd saves (the port's CPU count) stay within a stated ratio of
  the JAX package's compiled figure; a real CPU profile gives positive,
  finite numbers.
- Validation: the predictions equal the JAX package's (pure arithmetic);
  the measured side runs on the CPU.
- Search CLI: both packages' ``cli search`` write equal JSON over one
  ``--config_dir``; the port's ``cli train --device cpu`` trains it; the
  world-1 missing all-reduce file is the one stated divergence.
"""

import json
import math
import os

import jax.numpy as jnp
import pytest
import torch

import galvatron_tpu.cli.search as JCLI
import galvatron_tpu.profiler.model as JM
import galvatron_tpu.profiler.validate as JV
import galvatron_tpu_torch.cli.search as TCLI
import galvatron_tpu_torch.profiler.model as TM
import galvatron_tpu_torch.profiler.validate as TV
from galvatron_tpu.config.strategy import HybridParallelConfig as JHP
from galvatron_tpu.models.llama import llama_config as jax_llama
from galvatron_tpu_torch.config.strategy import HybridParallelConfig as THP
from galvatron_tpu_torch.models.llama import llama_config as torch_llama

TINY = dict(hidden_size=64, num_heads=4, num_layers=2, ffn_hidden=96, vocab_size=128,
            max_seq_len=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread beside JAX's CPU backend in this process: with
    both thread pools on every core, torch's small ops run several times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
WIDER = dict(hidden_size=128, num_heads=2, num_layers=2, ffn_hidden=256, vocab_size=256,
             max_seq_len=128)


def _cfgs(kw):
    return (jax_llama("llama-0.3b", compute_dtype=jnp.float32, **kw),
            torch_llama("llama-0.3b", compute_dtype=torch.float32, **kw))


def _profilers(kw, **pargs):
    jc, tc = _cfgs(kw)
    common = dict(profile_batch_size=2, layernum_min=1, layernum_max=2, max_tp_deg=2,
                  mixed_precision="fp32", warmup=1, iters=2, **pargs)
    jp = JM.ModelProfiler(jc, "llama", JM.ModelProfileArgs(**common))
    tp = TM.ModelProfiler(tc, "llama", TM.ModelProfileArgs(device="cpu", **common))
    return jp, tp


def _timer_stub(calls):
    """A `_walltime` stand-in for either package: seconds as a function of
    the timed program's (layers, batch, sequence) and of the call's index,
    so both packages see the same numbers iff they time the same programs
    in the same order."""

    def stub(fn, args, *rest):
        a0, a1 = args[0], args[1]
        if isinstance(a1, dict):  # the whole model: (params, batch)
            n = len(a0["layers"]) if isinstance(a0, dict) else len(a0.layers)
            bsz, seq = a1["tokens"].shape
        else:  # a layer stack: (layers, x)
            n = len(a0)
            bsz, seq = a1.shape[:2]
        calls.append((n, int(bsz), int(seq)))
        return 1e-3 * (0.5 + 0.7 * n * bsz * (seq / 64.0) ** 1.3) + 2e-5 * len(calls) ** 2

    return stub


@pytest.mark.parametrize("mode,extra", [
    ("static", dict(profile_remat=True)),
    ("batch", dict(profile_min_batch_size=1, profile_max_batch_size=4)),
    ("sequence", dict(profile_min_seq_length=32, profile_max_seq_length=96,
                      seq_length_step=32, profile_seq_length=64)),
])
def test_computation_tables_and_file_names_equal_under_one_timer(mode, extra, monkeypatch,
                                                                  tmp_path):
    jp, tp = _profilers(TINY, profile_mode=mode, config_dir=str(tmp_path), **extra)
    j_calls, t_calls = [], []
    monkeypatch.setattr(JM, "_walltime", _timer_stub(j_calls))
    monkeypatch.setattr(TM, "_walltime", _timer_stub(t_calls))
    j_comp, t_comp = jp.profile_computation(), tp.profile_computation()
    assert t_calls == j_calls and len(t_calls) >= 5
    assert t_comp == j_comp
    if mode == "static":
        fr = t_comp["remat_recompute_frac"]
        assert set(fr) == {"none", "full", "nothing_saveable", "dots_saveable"}
        assert fr["full"] > 0 and fr["dots_saveable"] <= fr["full"]
    assert tp.config_paths() == jp.config_paths()
    assert os.path.basename(tp.config_paths()["computation"]) == \
        "computation_profiling_fp32_hidden64_head4_seqlen64_llama.json"


@pytest.fixture(scope="module")
def memory_tables():
    """Both packages' memory tables for two tiny LLaMAs (the JAX side as a
    one-process profile writes them: tp rows act/k)."""
    out = {}
    orig = JM.ModelProfiler._act_bytes_tp
    JM.ModelProfiler._act_bytes_tp = lambda self, *a, **k: None
    try:
        for name, kw in (("tiny", TINY), ("wider", WIDER)):
            jp, tp = _profilers(kw)
            out[name] = (jp.profile_memory(), tp.profile_memory(), tp)
    finally:
        JM.ModelProfiler._act_bytes_tp = orig
    return out


@pytest.mark.parametrize("name", ["tiny", "wider"])
def test_memory_tables_states_equal_and_activations_within_ratio(name, memory_tables):
    """`parameter_size` and every `model_states` entry equal the JAX
    package's. Activations: the port counts what autograd saves between the
    forward and the backward, the JAX package reads XLA's compiled peak
    (temporaries + outputs, less twice the parameters). XLA fuses the
    elementwise chains (norms, rope, SwiGLU, softmax) and keeps fewer of
    their intermediates, so the port's per-layer count runs above it:
    1.07x (tiny) and 1.32x (wider) on this machine, bounded here at
    [0.9, 1.5]. The embedding/head/loss activation is 0.94x of it, bounded
    at [0.8, 1.25]."""
    j, t, _ = memory_tables[name]
    assert t["layertype_0"]["parameter_size"] == j["layertype_0"]["parameter_size"]
    assert t["other_memory_pp_off"]["model_states"] == j["other_memory_pp_off"]["model_states"]
    for stage in ("first_stage", "last_stage"):
        assert (t["other_memory_pp_on"][stage]["model_states"]
                == j["other_memory_pp_on"][stage]["model_states"])
    ratio = t["layertype_0"]["tp_activation_per_bsz_dict"][1] / \
        j["layertype_0"]["tp_activation_per_bsz_dict"][1]
    assert 0.9 <= ratio <= 1.5, ratio
    other = t["other_memory_pp_off"]["activation"][1] / j["other_memory_pp_off"]["activation"][1]
    assert 0.8 <= other <= 1.25, other
    act = t["layertype_0"]["tp_activation_per_bsz_dict"]
    assert act[2] == round(act[1] / 2, 3)  # one-process tp rows: act/k
    assert set(act) == set(j["layertype_0"]["tp_activation_per_bsz_dict"])


@pytest.mark.parametrize("name", ["tiny", "wider"])
def test_checkpoint_row_is_the_layer_input(name, memory_tables):
    """Under full remat a layer keeps its input alone: seq * hidden fp32
    values per sample (the JAX figure under remat is XLA's peak, which the
    backward's recompute working set dominates, so no ratio holds there)."""
    _, t, prof = memory_tables[name]
    kw = TINY if name == "tiny" else WIDER
    want = kw["max_seq_len"] * kw["hidden_size"] * 4 / 2**20
    assert t["layertype_0"]["tp_activation_per_bsz_dict"]["checkpoint"] == round(want, 3)
    assert [r["remat"] for r in prof.act_records] == [False, True]
    assert all(r["allocator"] is None for r in prof.act_records)  # no allocator on the CPU


def test_real_cpu_profile_run_is_positive_and_finite(tmp_path):
    """The unstubbed profiler through the CLI on a flash-eligible LLaMA
    (head_dim 128, seq 128: the flash kernels' plain versions)."""
    from galvatron_tpu_torch.cli import profile as P

    argv = ["--device", "cpu", "--model_type", "llama", "--set_model_config_manually", "1",
            "--hidden_size", "128", "--num_attention_heads", "1", "--ffn_hidden_size", "64",
            "--num_layers", "2", "--vocab_size", "64", "--seq_length", "128",
            "--profile_batch_size", "2", "--layernum_min", "1", "--layernum_max", "2",
            "--profile_remat", "1", "--config_dir", str(tmp_path)]
    out = P.main_model(argv)
    comp, mem = out["computation"], out["memory"]
    vals = [comp["layertype_0"], comp["other_time"], *comp["remat_recompute_frac"].values(),
            mem["layertype_0"]["parameter_size"],
            *mem["layertype_0"]["tp_activation_per_bsz_dict"].values(),
            *mem["other_memory_pp_off"]["activation"].values()]
    assert all(math.isfinite(v) and v >= 0 for v in vals)
    assert comp["layertype_0"] > 0 and mem["layertype_0"]["tp_activation_per_bsz_dict"][1] > 0
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(p) for p in out["paths"].values())


def test_profile_on_cuda_without_a_gpu_raises(tmp_path):
    """--device cuda (the default) never falls back to the CPU."""
    from galvatron_tpu_torch.cli import profile as P

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.main_model(["--model_type", "llama", "--set_model_config_manually", "1",
                      "--hidden_size", "64", "--num_attention_heads", "4", "--num_layers", "2",
                      "--vocab_size", "64", "--seq_length", "64", "--config_dir",
                      str(tmp_path)])
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------- validate
MEM = {
    "layertype_0": {"parameter_size": 0.133, "tp_activation_per_bsz_dict": {
        1: 0.31, 2: 0.155, 4: 0.078, "checkpoint": 0.016}},
    "other_memory_pp_off": {"model_states": {1: 0.25, 2: 0.125, 4: 0.0625},
                            "activation": {1: 0.12, 2: 0.06, 4: 0.03}},
    "other_memory_pp_on": {
        "first_stage": {"model_states": {1: 0.13, 2: 0.065, 4: 0.033},
                        "activation": {1: 0.06, 2: 0.03, 4: 0.015}},
        "last_stage": {"model_states": {1: 0.12, 2: 0.06, 4: 0.03},
                       "activation": {1: 0.06, 2: 0.03, 4: 0.015}}},
}
TIME = {"layertype_0": 0.21, "other_time": 0.05}
HW = {"allreduce": {"allreduce_size_2_consec_1": 120.0, "allreduce_size_4_consec_1": 110.0,
                    "allreduce_size_2_consec_0": 100.0},
      "p2p": {"pp_size_2": 90.0, "pp_size_4": 80.0}, "overlap": {"overlap_coe": 1.13},
      "sp": None}
STRATS = [
    dict(world_size=1, layers=[dict(), dict(checkpoint=1)] * 2, global_bsz=4, chunks=2),
    dict(world_size=4, layers=[dict(tp=2), dict(tp=2, checkpoint=1), dict(fsdp=1), dict()],
         global_bsz=8, chunks=2, default_dp_type="zero2", vocab_tp=2),
    dict(world_size=4, pp=2, layers=[dict(), dict(checkpoint=1), dict(tp=2), dict()],
         global_bsz=8, chunks=4, pipeline_type="pipedream_flush", pp_division=[1, 3]),
]


def _hp(cls, lcls, kw):
    kw = dict(kw)
    layers = [lcls(**l) for l in kw.pop("layers")]
    return cls(layers=layers, **{"pp": 1, **kw})


@pytest.mark.parametrize("i", range(len(STRATS)))
def test_predictions_equal_the_jax_packages(i):
    from galvatron_tpu.config.strategy import LayerStrategy as JL
    from galvatron_tpu_torch.config.strategy import LayerStrategy as TL

    jhp, thp = _hp(JHP, JL, STRATS[i]), _hp(THP, TL, STRATS[i])
    assert TV.predict_memory_mb(thp, MEM, 64, 64) == JV.predict_memory_mb(jhp, MEM, 64, 64)
    assert (TV.predict_step_time_ms(thp, TIME, MEM, HW, 64, 64)
            == JV.predict_step_time_ms(jhp, TIME, MEM, HW, 64, 64))


def test_validate_measures_on_the_cpu():
    _, tc = _cfgs(dict(TINY, num_layers=4))
    from galvatron_tpu_torch.config.strategy import LayerStrategy

    hp = _hp(THP, LayerStrategy, STRATS[0])
    tv = TV.validate_time(tc, hp, TIME, MEM, {"allreduce": {}, "overlap": {"overlap_coe": 1.0}},
                          device="cpu", iters=2)
    mv = TV.validate_memory(tc, hp, MEM, device="cpu")
    assert tv.predicted_ms > 0 and tv.measured_ms > 0 and math.isfinite(tv.ratio)
    assert mv.predicted_mb > 0 and mv.measured_mb > 0 and math.isfinite(mv.ratio)
    # the measured CPU figure holds at least the parameters, grads and Adam
    n = sum(p.numel() for p in TM.M.TransformerLM(tc, "meta").parameters())
    assert mv.measured_mb >= 16 * n / 2**20


def test_validate_gives_both_checks_from_one_build(monkeypatch):
    """`validate` builds the model once and predicts what the two
    single-check functions predict."""
    from galvatron_tpu_torch.config.strategy import LayerStrategy
    from galvatron_tpu_torch.runtime import model_api

    _, tc = _cfgs(dict(TINY, num_layers=4))
    hp = _hp(THP, LayerStrategy, STRATS[0])
    hw = {"allreduce": {}, "overlap": {"overlap_coe": 1.0}}
    builds = []
    build = model_api.construct_hybrid_parallel_model
    monkeypatch.setattr(model_api, "construct_hybrid_parallel_model",
                        lambda *a, **k: builds.append(1) or build(*a, **k))
    tv, mv = TV.validate(tc, hp, TIME, MEM, hw, device="cpu", iters=2)
    assert len(builds) == 1
    mp = tc.compute_dtype == torch.bfloat16
    assert tv.predicted_ms == TV.predict_step_time_ms(hp, TIME, MEM, hw, tc.max_seq_len,
                                                      tc.hidden_size, mixed_precision=mp)
    assert mv.predicted_mb == TV.predict_memory_mb(hp, MEM, tc.max_seq_len, tc.hidden_size,
                                                   mixed_precision=mp)["total_mb"]
    assert tv.measured_ms > 0 and mv.measured_mb >= 16 * sum(
        p.numel() for p in TM.M.TransformerLM(tc, "meta").parameters()) / 2**20


def test_hardware_profiler_defaults_to_the_card():
    """Without a device the hardware profiler takes the card, as the
    port's other entry points do: where none is visible it raises rather
    than time the CPU."""
    from galvatron_tpu_torch.profiler.hardware import HardwareProfileArgs, HardwareProfiler
    from galvatron_tpu_torch.runtime import distributed

    with distributed.process_group("cpu"):
        if torch.cuda.is_available():
            assert HardwareProfiler(HardwareProfileArgs()).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                HardwareProfiler(HardwareProfileArgs())
        assert HardwareProfiler(HardwareProfileArgs(), "cpu").device.type == "cpu"


# ------------------------------------------------------------- search CLI
MODEL_ARGV = ["--model_type", "llama", "--set_model_config_manually", "1", "--hidden_size",
              "128", "--num_attention_heads", "2", "--ffn_hidden_size", "64", "--num_layers",
              "4", "--vocab_size", "64", "--seq_length", "64"]
PROF_MEM = {
    "layertype_0": {"parameter_size": 1.377, "tp_activation_per_bsz_dict": {
        1: 4.0, 2: 2.0, 4: 1.0, 8: 0.5, "checkpoint": 0.25}},
    "other_memory_pp_off": {"model_states": {1: 2.0, 2: 1.0, 4: 0.5, 8: 0.25},
                            "activation": {1: 0.9, 2: 0.45, 4: 0.225, 8: 0.112}},
    "other_memory_pp_on": {
        "first_stage": {"model_states": {1: 1.0, 2: 0.5, 4: 0.25, 8: 0.125},
                        "activation": {1: 0.45, 2: 0.225, 4: 0.112, 8: 0.056}},
        "last_stage": {"model_states": {1: 1.0, 2: 0.5, 4: 0.25, 8: 0.125},
                       "activation": {1: 0.45, 2: 0.225, 4: 0.112, 8: 0.056}}},
}
PROF_TIME = {"layertype_0": 4.7, "other_time": 0.4,
             "remat_recompute_frac": {"none": 0.0, "full": 0.9, "nothing_saveable": 0.9,
                                      "dots_saveable": 0.35}}
HW8 = {"allreduce_bandwidth_8chips.json": {"allreduce_size_8_consec_1": 150.0,
                                           "allreduce_size_4_consec_1": 155.0,
                                           "allreduce_size_4_consec_0": 150.0,
                                           "allreduce_size_2_consec_1": 130.0,
                                           "allreduce_size_2_consec_0": 145.0},
       "p2p_bandwidth_8chips.json": {"pp_size_2": 160.0, "pp_size_4": 140.0,
                                     "pp_size_8": 110.0},
       "overlap_coefficient.json": {"overlap_coe": 1.12}}


def _config_dir(path, hw):
    os.makedirs(path, exist_ok=True)
    tag = "bf16_hidden128_head2_seqlen64_llama"
    for name, data in ((("computation_profiling_%s.json" % tag), PROF_TIME),
                       (("memory_profiling_%s.json" % tag), PROF_MEM), *hw.items()):
        with open(os.path.join(path, name), "w") as f:
            json.dump(data, f)
    return path


def _search_both(tmp_path, monkeypatch, world, extra, hw):
    d = _config_dir(str(tmp_path / "cfg"), hw)
    monkeypatch.setenv("GALVATRON_WORLD_SIZE", str(world))
    outs = {}
    for name, mod in (("jax", JCLI), ("torch", TCLI)):
        out = str(tmp_path / ("%s.json" % name))
        mod.main(MODEL_ARGV + ["--config_dir", d, "--output_config_path", out,
                               "--log_dir", str(tmp_path / "logs")] + extra)
        outs[name] = out
    return outs


@pytest.mark.parametrize("world,extra", [
    (8, ["--memory_constraint", "0.52", "--settle_bsz", "64"]),
    (8, ["--memory_constraint", "0.52", "--settle_bsz", "64", "--remat_search",
         "--sp_space", "tp+sp"]),
])
def test_cli_search_writes_the_jax_packages_json(world, extra, tmp_path, monkeypatch):
    outs = _search_both(tmp_path, monkeypatch, world, extra, HW8)
    with open(outs["jax"]) as f, open(outs["torch"]) as g:
        assert json.load(f) == json.load(g)
    assert (THP.from_json(outs["torch"], world_size=world)
            == THP.from_json(outs["jax"], world_size=world))
    assert (JHP.from_json(outs["torch"], world_size=world)
            == JHP.from_json(outs["jax"], world_size=world))


WORLD1 = ["--memory_constraint", "0.6", "--settle_bsz", "16", "--settle_chunk", "2"]


def test_cli_search_world1_trains_under_cli_train(tmp_path, monkeypatch):
    """World 1, all-reduce profile present but empty (what the one-device
    hardware profiler measures): equal JSON; the port's train CLI trains it
    for 2 steps on the CPU, and the model it builds runs that strategy."""
    hw = {"allreduce_bandwidth_1chips.json": {},
          "overlap_coefficient.json": {"overlap_coe": 1.0}}
    outs = _search_both(tmp_path, monkeypatch, 1, WORLD1, hw)
    with open(outs["jax"]) as f, open(outs["torch"]) as g:
        searched = json.load(f)
        assert searched == json.load(g)
    hp = THP.from_json(outs["torch"], world_size=1)
    assert hp == THP.from_json(outs["jax"], world_size=1)
    assert JHP.from_json(outs["torch"], world_size=1) == JHP.from_json(outs["jax"], world_size=1)
    ckpt = [s.checkpoint for s in hp.layers]
    assert 0 < sum(ckpt) < len(ckpt), ckpt  # the budget checkpoints some layers, not all

    from galvatron_tpu_torch.cli import train as T

    argv = MODEL_ARGV + ["--device", "cpu", "--galvatron_config_path", outs["torch"],
                         "--global_train_batch_size", str(hp.global_bsz), "--train_iters", "2",
                         "--lr", "1e-3", "--mixed_precision", "fp32"]
    summary = T.main(argv)
    assert len(summary["losses"]) == 2 and all(math.isfinite(x) for x in summary["losses"])
    args = T.initialize_galvatron(argv=argv, mode="train")
    from galvatron_tpu_torch.cli.arguments import hp_config_from_args

    assert hp_config_from_args(args, 4, 1).layers == hp.layers


def test_world1_missing_allreduce_file_is_the_stated_divergence(tmp_path, monkeypatch):
    """The one-device hardware profile writes no all-reduce file: the JAX
    CLI raises on it, the port's reads it as {} and writes what the JAX CLI
    writes with an empty file."""
    d = _config_dir(str(tmp_path / "cfg"), {"overlap_coefficient.json": {"overlap_coe": 1.0}})
    monkeypatch.setenv("GALVATRON_WORLD_SIZE", "1")
    base = MODEL_ARGV + ["--config_dir", d, "--log_dir", str(tmp_path / "logs")] + WORLD1
    with pytest.raises(FileNotFoundError):
        JCLI.main(base + ["--output_config_path", str(tmp_path / "jax.json")])
    TCLI.main(base + ["--output_config_path", str(tmp_path / "torch.json")])
    with open(os.path.join(d, "allreduce_bandwidth_1chips.json"), "w") as f:
        json.dump({}, f)
    JCLI.main(base + ["--output_config_path", str(tmp_path / "jax.json")])
    with open(tmp_path / "jax.json") as f, open(tmp_path / "torch.json") as g:
        assert json.load(f) == json.load(g)


def test_world2_missing_allreduce_file_raises_in_both(tmp_path, monkeypatch):
    d = _config_dir(str(tmp_path / "cfg"), {"overlap_coefficient.json": {"overlap_coe": 1.0}})
    monkeypatch.setenv("GALVATRON_WORLD_SIZE", "2")
    base = MODEL_ARGV + ["--config_dir", d, "--log_dir", str(tmp_path / "logs")] + WORLD1
    for mod in (JCLI, TCLI):
        with pytest.raises(FileNotFoundError):
            mod.main(base + ["--output_config_path", str(tmp_path / "s.json")])
    assert not (tmp_path / "s.json").exists()


def test_cli_flags_and_defaults_match_the_jax_packages():
    """search, profile and profile_hardware parse the JAX package's flags to
    the same defaults (the port adds --device to the profilers); the trace
    lint is refused."""
    from galvatron_tpu.cli import arguments as JA
    from galvatron_tpu_torch.cli import arguments as TA

    skip = {"coordinator_address", "num_processes", "process_id", "galvatron_mode"}
    for mode in ("search", "profile", "profile_hardware"):
        j = vars(JA.build_parser(mode).parse_args([]))
        t = vars(TA.build_parser(mode).parse_args([]))
        for k in skip:
            j.pop(k, None)
        if mode != "search":
            assert t.pop("device") == "cuda"
        assert {k: (int(v) if isinstance(v, bool) else v) for k, v in j.items()} == t, mode
    with pytest.raises(SystemExit):
        TA.build_parser("search").parse_args(["--trace_lint", "1"])
    assert TA.build_parser("search").parse_args(["--trace_lint", "0"]).trace_lint == 0


@pytest.mark.parametrize("mode,flag,default,other", [
    ("profile", "--profile_type_model", "computation", "memory"),
    ("profile", "--profile_dp_type", "zero3", "ddp"),
    ("search", "--time_profile_mode", "static", "batch"),
    ("search", "--memory_profile_mode", "static", "sequence"),
])
def test_flags_the_port_does_not_act_on_take_their_default_only(mode, flag, default, other):
    """A reference command line with the default parses; any other value is
    refused, never accepted and ignored."""
    from galvatron_tpu_torch.cli import arguments as TA

    dest = flag[2:].replace("profile_type_model", "profile_type")
    assert getattr(TA.build_parser(mode).parse_args([flag, default]), dest) == default
    with pytest.raises(SystemExit):
        TA.build_parser(mode).parse_args([flag, other])
