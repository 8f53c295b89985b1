"""The port's search (``galvatron_tpu_torch/search``) against the JAX
package's, over the mock profiles of ``tests/search_engine``: the cost
models bitwise on a grid, the native DP core against its numpy reference and
the JAX package's DPAlg, and for every search axis the strategy JSON that
``save_results`` writes. Pure CPU, pure float64 numpy: every comparison is
exact."""

import copy
import json
import os

import numpy as np
import pytest

import galvatron_tpu.search.cost_model as JC
import galvatron_tpu.search.cost_model_args as JA
import galvatron_tpu.search.dynamic_programming as JD
import galvatron_tpu.search.engine as JE
import galvatron_tpu_torch.search.cost_model as TC
import galvatron_tpu_torch.search.cost_model_args as TA
import galvatron_tpu_torch.search.dynamic_programming as TD
import galvatron_tpu_torch.search.engine as TE
from galvatron_tpu_torch.config.strategy import HybridParallelConfig

ALLREDUCE_BW = {
    "allreduce_size_8_consec_1": 150.0,
    "allreduce_size_4_consec_1": 155.0,
    "allreduce_size_4_consec_0": 150.0,
    "allreduce_size_2_consec_1": 130.0,
    "allreduce_size_2_consec_0": 145.0,
}
P2P_BW = {"pp_size_2": 160.0, "pp_size_4": 140.0, "pp_size_8": 110.0}
SP_TIME = {"allreduce": {"2": {"popt": [0.02, 0.01]}, "4": {"popt": [0.03, 0.02]},
                         "8": {"popt": [0.04, 0.03]}},
           "all2all": {"2": {"popt": [0.01, 0.01]}, "4": {"popt": [0.015, 0.02]},
                       "8": {"popt": [0.02, 0.03]}}}
TIME_CONFIG = {"layertype_0": 5.3, "other_time": 2.0}
MEMORY_CONFIG = {
    "layertype_0": {
        "parameter_size": 96.0,
        "tp_activation_per_bsz_dict": {1: 500.0, 2: 260.0, 4: 140.0, 8: 80.0, "checkpoint": 30.0},
    },
    "other_memory_pp_off": {
        "model_states": {1: 3000.0, 2: 1500.0, 4: 750.0, 8: 375.0},
        "activation": {1: 80.0, 2: 42.0, 4: 22.0, 8: 12.0},
    },
    "other_memory_pp_on": {
        "first_stage": {"model_states": {1: 2000.0, 2: 1000.0, 4: 500.0, 8: 250.0},
                        "activation": {1: 50.0, 2: 26.0, 4: 14.0, 8: 8.0}},
        "last_stage": {"model_states": {1: 1500.0, 2: 750.0, 4: 375.0, 8: 190.0},
                       "activation": {1: 30.0, 2: 16.0, 4: 8.0, 8: 5.0}},
    },
}
LAYER = {"hidden_size": 4096, "seq_len": 2048, "layer_num": 8}


def _two_type_profiles():
    t = dict(TIME_CONFIG, layertype_1=7.1)
    m = copy.deepcopy(MEMORY_CONFIG)
    m["layertype_1"] = {"parameter_size": 128.0, "tp_activation_per_bsz_dict": {
        1: 640.0, 2: 330.0, 4: 170.0, 8: 90.0, "checkpoint": 40.0}}
    return t, m


# --------------------------------------------------------------- cost models
def _grid_strategies():
    args = TE.SearchArgs(sp_space="tp+sp", disable_cp=False, remat_search=True,
                         comm_quant="int8")
    out = TE.generate_strategies(8, args)
    assert out == JE.generate_strategies(8, JE.SearchArgs(
        sp_space="tp+sp", disable_cp=False, remat_search=True, comm_quant="int8"))
    return out


def _args(mod, chunks):
    pha = mod.ProfileHardwareArgs(
        comm_coe_dict=mod.parse_hardware_profiles(ALLREDUCE_BW)["comm_coe_dict"],
        p2p_comm_coe_dict={2: 0.006, 4: 0.007, 8: 0.009},
        dp_overlap_coe=1.12, bct_overlap_coe=1.12,
        allreduce_dict={int(k): v for k, v in SP_TIME["allreduce"].items()},
        all2all_dict={int(k): v for k, v in SP_TIME["all2all"].items()},
    )
    return dict(
        model_args=mod.ModelArgs(parameter_size=96.0, seq_length=2048, hidden_size=4096,
                                 layer_num=8),
        train_args=mod.TrainArgs(),
        parallel_args=mod.ParallelArgs(chunks=chunks),
        profile_model_args=mod.ProfileModelArgs(
            forward_computation_time=[0.9, 1.3],
            tp_activation_per_bsz_dict=MEMORY_CONFIG["layertype_0"]["tp_activation_per_bsz_dict"],
            other_memory_pp_off=MEMORY_CONFIG["other_memory_pp_off"],
            other_memory_pp_on=MEMORY_CONFIG["other_memory_pp_on"],
            other_time_profiled=2.0,
            remat_recompute_frac={"none": 0.0, "full": 0.93, "dots_saveable": 0.41},
        ),
        profile_hardware_args=pha,
    )


@pytest.mark.parametrize("bsz", [8, 16, 64])
@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_cost_models_bitwise_equal(bsz, chunks):
    """TimeCostModel (fwd/bwd split) and MemoryCostModel (every entry) of
    the two packages agree bit for bit on every strategy of the full space
    (pp 1..8, tp, cp, Ulysses, fsdp, ckpt, remat policies, int8 wire)."""
    strategies = _grid_strategies()
    n = 0
    for s in strategies:
        for stage_idx in sorted({0, s[0] - 1}):
            ta, ja = _args(TA, chunks), _args(JA, chunks)
            kw = dict(global_batch_size=bsz, mbsz=max(1, bsz // 8), min_tp=1, max_tp=8,
                      stage_idx=stage_idx)
            tm = TC.MemoryCostModel(s, **kw, **{k: v for k, v in ta.items()
                                                if k != "profile_hardware_args"})
            jm = JC.MemoryCostModel(s, **kw, **{k: v for k, v in ja.items()
                                                if k != "profile_hardware_args"})
            assert repr(tm.get_memory_cost()) == repr(jm.get_memory_cost()), s
        t = TC.TimeCostModel(s, global_batch_size=bsz, **_args(TA, chunks))
        j = JC.TimeCostModel(s, global_batch_size=bsz, **_args(JA, chunks))
        assert t.gen_result_split() == j.gen_result_split(), s
        n += 1
    assert n > 100
    for vsp in (0, 1):
        for esdp in (False, True):
            kw = dict(mbsz=max(1, bsz // 8), pp_deg=2, world_size=8, vsp=vsp,
                      embed_sdp=esdp, min_tp=1, max_tp=8,
                      sequence_length_list=[2048])
            assert (TC.OtherTimeCostModel(**kw, **_args(TA, chunks)).gen_result()
                    == JC.OtherTimeCostModel(**kw, **_args(JA, chunks)).gen_result())


@pytest.mark.parametrize("pp,division", [(1, [8]), (2, [4, 4]), (4, [1, 3, 2, 2])])
def test_pipeline_costmodel_bitwise_equal(pp, division):
    strategies = [s for s in _grid_strategies() if s[0] == pp]
    rng = np.random.RandomState(pp)
    picks = [strategies[i] for i in rng.randint(0, len(strategies), 8)]
    out = []
    for mod, cm in ((TA, TC), (JA, JC)):
        a = _args(mod, 4)
        out.append(cm.pipeline_costmodel(
            cm.TimeCostModel, [8], [a["model_args"]], [a["train_args"]],
            [a["parallel_args"]], [a["profile_model_args"]],
            [a["profile_hardware_args"]], picks, division, 4, 32, min_tp=1,
            other_time_cost=[1.5] * pp, return_stage_cost=True))
    assert repr(out[0]) == repr(out[1])


def test_parse_hardware_profiles_equal_and_quant_default():
    for hw in ((ALLREDUCE_BW, P2P_BW, {"overlap_coe": 1.2}, SP_TIME),
               ({}, None, None, None),
               (ALLREDUCE_BW, None, {"overlap_coe": 1.1, "quant_overhead_coe": 0.5}, None)):
        assert TA.parse_hardware_profiles(*hw) == JA.parse_hardware_profiles(*hw)
    assert TA.parse_hardware_profiles({}, None, {"overlap_coe": 1.3})["quant_overhead_coe"] == 0.02
    assert TA.default_optimal_chunk_func(16, None, 3, 1) == JA.default_optimal_chunk_func(16, None, 3, 1)


# ---------------------------------------------------------------------- DP
def _random_tables(seed, L, S, M):
    rng = np.random.RandomState(seed)
    v = rng.randint(0, max(2, M // L), (L, S)).astype(np.int32)
    intra = rng.rand(L, S) * 10
    inter = rng.rand(L, S, S) * 2
    inter[0] = 0.0
    # ties: duplicate a strategy column so the argmin order decides
    v[:, 1], intra[:, 1] = v[:, 0], intra[:, 0]
    inter[:, :, 1], inter[:, 1, :] = inter[:, :, 0], inter[:, 0, :]
    other = {1: int(rng.randint(0, M // 4)), 2: int(rng.randint(0, M // 4)),
             4: M + 5}  # vtp 4 infeasible
    return v, intra, inter, other


@pytest.mark.parametrize("seed,L,S,M", [(0, 4, 3, 60), (1, 8, 6, 200), (2, 12, 9, 500),
                                        (3, 6, 12, 90), (4, 1, 5, 40)])
def test_dp_core_matches_numpy_and_jax(seed, L, S, M):
    v, intra, inter, other = _random_tables(seed, L, S, M)
    results = []
    for mod, cpp in ((TD, True), (TD, False), (JD, False), (JD, True)):
        dp = mod.DPAlg(max_mem=M, other_mem_cost=other,
                       other_time_cost={1: 0.5, 2: 0.25, 4: 0.0}, layer_num=L,
                       strategy_num=S, use_cpp_core=cpp)
        if mod is TD:
            assert dp.use_cpp_core == cpp
        dp.set_v_and_cost(v, intra, inter)
        results.append(dp.fit())
    for r in results[1:]:
        assert repr(r) == repr(results[0])
    cost, res, rem = results[0]
    assert res[4] is None and np.isinf(cost[4])
    assert res[1] is not None


def test_dp_core_builds_into_build_dir_not_jax_csrc():
    so = TD.build()
    assert os.path.dirname(so).endswith(os.path.join("build", "galvatron_tpu_torch"))
    assert os.path.basename(so).startswith("dp_core_")
    assert TD.SOURCE.endswith(os.path.join("galvatron_tpu_torch", "csrc", "dp_core.cpp"))
    assert TD._load_core() is not None


def test_dp_core_failed_build_raises_no_numpy_fallback(tmp_path, monkeypatch):
    """A broken compiler raises at DPAlg construction; no quiet numpy DP."""
    monkeypatch.setattr(TD, "library_path", lambda: str(tmp_path / "dp_core_x.so"))
    monkeypatch.setattr(TD, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        TD.DPAlg(max_mem=10, other_mem_cost={1: 0}, layer_num=2, strategy_num=2)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot build"):
        TD.DPAlg(max_mem=10, other_mem_cost={1: 0}, layer_num=2, strategy_num=2)
    assert not any(p.suffix == ".so" for p in tmp_path.iterdir())
    # asked for by name, the numpy DP needs no compiler
    TD.DPAlg(max_mem=10, other_mem_cost={1: 0}, layer_num=2, strategy_num=2,
             use_cpp_core=False)


# ----------------------------------------------------------- engine -> JSON
def _quant_hw():
    return ({"allreduce_size_%d_consec_1" % d: 2.0 for d in (2, 4, 8)}, None,
            {"overlap_coe": 1.12, "quant_overhead_coe": 0.001}, None)


TWO_T, TWO_M = _two_type_profiles()
# (id, SearchArgs kwargs, world, layer configs, (time, memory), hardware)
CASES = [
    ("default", dict(), 8, [LAYER], None, None),
    ("tight_memory", dict(memory_constraint=7.0), 8, [LAYER], None, None),
    ("infeasible", dict(memory_constraint=0.5), 8, [LAYER], None, None),
    ("pp_space", dict(search_space="pp", max_pp_deg=4, memory_constraint=7.0), 4,
     [LAYER], None, None),
    ("3d", dict(search_space="3d", memory_constraint=7.0), 8, [LAYER], None, None),
    ("sp_space_tp_sp", dict(sp_space="tp+sp", memory_constraint=10.0), 8, [LAYER], None,
     (ALLREDUCE_BW, P2P_BW, {"overlap_coe": 1.12}, SP_TIME)),
    ("sp_space_sp", dict(sp_space="sp", memory_constraint=8.0), 8, [LAYER], None,
     (ALLREDUCE_BW, P2P_BW, {"overlap_coe": 1.12}, SP_TIME)),
    ("enable_cp", dict(disable_cp=False, memory_constraint=6.0), 8, [LAYER], None,
     (ALLREDUCE_BW, P2P_BW, {"overlap_coe": 1.12}, SP_TIME)),
    ("remat_search", dict(remat_search=True, memory_constraint=5.0), 8, [LAYER], None, None),
    ("comm_quant_int8_budget", dict(search_space="dp", disable_pp=True, disable_tp=True,
                                    disable_vtp=True, comm_quant="int8",
                                    comm_quant_budget=0.5), 8, [LAYER], None, _quant_hw()),
    ("objective_serve", dict(objective="serve", memory_constraint=16.0), 8, [LAYER], None,
     None),
    ("uneven_pp", dict(search_space="pp", max_pp_deg=4, memory_constraint=10.0), 4,
     [dict(LAYER, layer_num=6)], None, None),
    ("uneven_pp_no_pipeline_costmodel", dict(search_space="pp", max_pp_deg=4,
                                              memory_constraint=10.0,
                                              use_pipeline_costmodel=False), 4,
     [dict(LAYER, layer_num=6)], None, None),
    ("two_layer_types", dict(memory_constraint=2.0), 8,
     [dict(LAYER, layer_num=4), dict(LAYER, layer_num=4)], (TWO_T, TWO_M), None),
    ("batch_fit_profile", dict(memory_constraint=3.0), 8, [LAYER],
     ({"layertype_0": [0.61, 0.4], "other_time": [0.2, 0.1],
       "remat_recompute_frac": {"none": 0.0, "full": 0.9, "dots_saveable": 0.3}},
      MEMORY_CONFIG), None),
    ("coarse_world4", dict(fine_grained_mode=False, memory_constraint=16.0), 4, [LAYER],
     None, None),
    ("world1_empty_allreduce", dict(memory_constraint=80.0, settle_bsz=8), 1, [LAYER], None,
     ({}, None, {"overlap_coe": 1.0}, None)),
]


def _run_engine(E, case, out_dir):
    name, kw, world, layers, profiles, hw = case
    kw = dict(kw)
    args = E.SearchArgs(**{"memory_constraint": 16.0, "settle_bsz": 16, "settle_chunk": 2,
                           "max_tp_deg": 8, **kw})
    eng = E.GalvatronSearchEngine(args, world, copy.deepcopy(layers),
                                  config_dir=str(out_dir), model_name="mock")
    t, m = profiles or (TIME_CONFIG, MEMORY_CONFIG)
    eng.set_model_profiles(copy.deepcopy(t), copy.deepcopy(m))
    eng.set_hardware_profiles(*copy.deepcopy(hw or (ALLREDUCE_BW, P2P_BW,
                                                    {"overlap_coe": 1.12})))
    eng.initialize_search_engine()
    best = (eng.serve_optimization() if args.objective == "serve"
            else eng.parallelism_optimization())
    if best is None:
        return None, None
    path = eng.save_results(best, str(out_dir / "strategy.json"))
    with open(path) as f:
        return best, json.load(f)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_engine_writes_the_jax_packages_json(case, tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    t_best, t_json = _run_engine(TE, case, tmp_path / "t")
    j_best, j_json = _run_engine(JE, case, tmp_path / "j")
    assert t_json == j_json
    if case[0] == "infeasible":
        assert t_best is None and j_best is None
        return
    assert t_json is not None
    assert repr(t_best["cost"]) == repr(j_best["cost"])
    assert t_best["strategies"] == j_best["strategies"]
    world = case[2]
    hp = HybridParallelConfig.from_json(str(tmp_path / "t" / "strategy.json"),
                                        world_size=world)
    assert hp.num_layers == sum(lc["layer_num"] for lc in case[3])
    if case[0] == "tight_memory":
        assert any(s.checkpoint or s.fsdp or s.tp > 1 for s in hp.layers)
    if case[0] == "remat_search":
        assert "dots_saveable" in {s.remat_policy for s in hp.layers if s.checkpoint}
    if case[0] == "comm_quant_int8_budget":
        assert sum(s.grad_comm_dtype == "int8" for s in hp.layers) == 4
    if case[0] == "uneven_pp":
        assert hp.pp == 4 and hp.pp_division == [2, 2, 1, 1]
    if case[0] == "pp_space":
        assert hp.pp == 4
    if case[0] == "two_layer_types":
        assert any(not s.tp_consec for s in hp.layers if s.tp > 1)
    if case[0] == "sp_space_sp":
        assert all(s.sp for s in hp.layers if s.tp > 1) and any(s.tp > 1 for s in hp.layers)
    if case[0] == "enable_cp":
        assert any(s.cp > 1 for s in hp.layers)
    if case[0] == "world1_empty_allreduce":
        assert hp.world_size == 1


def test_world4_needs_a_multi_gpu_allreduce_profile():
    """An empty all-reduce profile is a one-device profile: at world 4 both
    engines refuse to price dp groups they have no coefficient for."""
    for E in (TE, JE):
        eng = E.GalvatronSearchEngine(
            E.SearchArgs(memory_constraint=80, settle_bsz=8, settle_chunk=2), 4,
            [dict(LAYER)], model_name="mock")
        eng.set_model_profiles(TIME_CONFIG, MEMORY_CONFIG)
        eng.set_hardware_profiles({}, None, {"overlap_coe": 1.0})
        eng.initialize_search_engine()
        with pytest.raises(KeyError, match="no allreduce coefficient for group size 4"):
            eng.parallelism_optimization()


def test_trace_lint_is_refused(tmp_path):
    eng = TE.GalvatronSearchEngine(TE.SearchArgs(settle_bsz=8, settle_chunk=1,
                                                 trace_lint=True), 1,
                                   [dict(LAYER)], model_name="mock")
    eng.set_model_profiles(TIME_CONFIG, MEMORY_CONFIG)
    eng.set_hardware_profiles({}, None, None)
    eng.initialize_search_engine()
    best = eng.parallelism_optimization()
    with pytest.raises(ValueError, match="item 12"):
        eng.save_results(best, str(tmp_path / "s.json"))
    assert not (tmp_path / "s.json").exists()
