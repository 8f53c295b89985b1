"""Port parity, strategy schema: the shipped strategy fixtures load to equal
configs and equal layer runs in both packages, broken ones are refused with
the same codes, and the serve lint refuses the same layouts (GLS014)."""

import dataclasses
import glob
import os

import pytest

from galvatron_tpu.analysis import strategy_lint as JS
from galvatron_tpu.analysis.diagnostics import DiagnosticError as JDiagErr
from galvatron_tpu.config import strategy as JC
from galvatron_tpu_torch.analysis import strategy_lint as TS
from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError as TDiagErr
from galvatron_tpu_torch.config import strategy as TC
from galvatron_tpu_torch.runtime.model_api import check_layout

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "analysis", "fixtures")
VALID = sorted(glob.glob(os.path.join(FIXTURES, "valid", "*.json")))
BROKEN = sorted(glob.glob(os.path.join(FIXTURES, "broken", "*.json")))


@pytest.mark.parametrize("path", VALID, ids=[os.path.basename(p) for p in VALID])
def test_valid_fixture_loads_to_equal_config_and_runs(path):
    j = JC.HybridParallelConfig.from_json(path, world_size=8)
    t = TC.HybridParallelConfig.from_json(path, world_size=8)
    assert t.to_json_dict() == j.to_json_dict()
    jr = [(r.start, r.stop, dataclasses.asdict(r.strategy)) for r in JC.layer_runs(j)]
    tr = [(r.start, r.stop, dataclasses.asdict(r.strategy)) for r in TC.layer_runs(t)]
    assert tr == jr
    # the round trip through the on-disk form is stable
    again = TC.HybridParallelConfig.from_json(t.to_json_dict(), world_size=8)
    assert again.to_json_dict() == t.to_json_dict()


@pytest.mark.parametrize("path", BROKEN, ids=[os.path.basename(p) for p in BROKEN])
def test_broken_fixture_outcome_matches_reference(path):
    """Schema/structure errors raise with the same codes; fixtures that are
    only refused by the reference's model- or engine-aware lint construct
    in both."""
    def outcome(mod, err):
        try:
            mod.HybridParallelConfig.from_json(path, world_size=8)
        except err as e:
            return sorted(d.code for d in e.diagnostics)
        return "ok"

    assert outcome(TC, TDiagErr) == outcome(JC, JDiagErr)


_SERVE_LAYOUTS = {
    "pp2": dict(pp=2),
    "cp2": dict(cp=2),
    "ulysses": dict(tp=2, sp=1),
    "tp2": dict(tp=2),
    "dp8": dict(),
}


@pytest.mark.parametrize("name", sorted(_SERVE_LAYOUTS))
def test_serve_lint_gives_reference_gls014(name):
    kw = _SERVE_LAYOUTS[name]
    j = JC.HybridParallelConfig.uniform(8, 4, **kw)
    t = TC.HybridParallelConfig.uniform(8, 4, **kw)
    jd = [(d.code, d.layer, d.key) for d in JS.lint_hp(j, mode="serve").errors]
    td = [(d.code, d.layer, d.key) for d in TS.lint_hp(t, mode="serve").errors]
    assert td == jd
    assert all(code == "GLS014" for code, _, _ in td)
    assert bool(td) == (name in ("pp2", "cp2", "ulysses"))


def test_serve_lint_on_pp_fixture_matches_reference():
    path = os.path.join(FIXTURES, "broken", "gls014_serve_pp.json")
    j = JC.HybridParallelConfig.from_json(path, world_size=8)
    t = TC.HybridParallelConfig.from_json(path, world_size=8)
    assert TS.lint_hp(t, mode="serve", file=path).codes() == \
        JS.lint_hp(j, mode="serve", file=path).codes() == ["GLS014"]


def test_diagnostic_error_stays_a_value_error():
    with pytest.raises(ValueError, match="GLS002"):
        TC.HybridParallelConfig.uniform(4, 2, tp=3)


@pytest.mark.parametrize("kw", [dict(world_size=2), dict(world_size=2, tp=2),
                                dict(world_size=4, pp=2, tp=2), dict(world_size=2, cp=2),
                                dict(world_size=2, tp=2, sp=1)])
def test_runtime_refuses_layouts_beyond_one_device(kw):
    """The train path executes world 2, tp 2, pp 2, ring cp and Ulysses
    (the per-layer layout, pipeline and long-context slices); serving runs
    world 2 and tp 2 (the serve layouts) and refuses pp, cp and Ulysses
    (GLS014, as the serve lint)."""
    world = kw.pop("world_size")
    hp = TC.HybridParallelConfig.uniform(world, 4, **kw)
    check_layout(hp)
    refusal = ("pp=2" if kw.get("pp") else "cp=2" if kw.get("cp") else
               "Ulysses" if kw.get("sp") else None)
    if refusal is None:
        check_layout(hp, mode="serve")
    else:
        with pytest.raises(ValueError, match=refusal):
            check_layout(hp, mode="serve")


def test_runtime_accepts_world_one():
    check_layout(TC.HybridParallelConfig.uniform(1, 4, checkpoint=1))
    check_layout(TC.HybridParallelConfig.uniform(1, 4, checkpoint=1), mode="serve")


# codes the port's lint reports (GLS101 needs a budget, which these cases
# do not give); the reference's others need the manual-TP /
# quantized-collective paths
_PORTED_CODES = {"GLS001", "GLS002", "GLS003", "GLS004", "GLS005", "GLS006", "GLS007",
                 "GLS008", "GLS009", "GLS010", "GLS011", "GLS014", "GLS101", "GLS102",
                 "GLS103"}


def _constructs(path):
    try:
        JC.HybridParallelConfig.from_json(path, world_size=8)
    except JDiagErr:
        return False  # refused at construction: the broken-fixture test's case
    return True


LINTABLE = [p for p in VALID + BROKEN if _constructs(p)]


@pytest.mark.parametrize("path", LINTABLE, ids=[os.path.basename(p) for p in LINTABLE])
def test_train_lint_matches_reference_on_the_fixtures(path):
    """The train-mode lint reports the reference's diagnostics (code,
    severity, layer, key) wherever the code is ported, in the same order;
    both lint with the same llama config (heads 6, kv heads 3, vocab 1001,
    sequence 30), so the model-aware codes fire too."""
    from galvatron_tpu.models.llama import llama_config as j_llama
    from galvatron_tpu_torch.models.llama import llama_config as t_llama

    dims = dict(num_layers=4, hidden_size=192, num_heads=6, num_kv_heads=3,
                vocab_size=1001, max_seq_len=30)
    j = JC.HybridParallelConfig.from_json(path, world_size=8)
    t = TC.HybridParallelConfig.from_json(path, world_size=8)
    want = [(d.code, d.severity, d.layer, d.key)
            for d in JS.lint_hp(j, model_cfg=j_llama("llama-0.3b", **dims), mode="train").diagnostics
            if d.code in _PORTED_CODES]
    got = [(d.code, d.severity, d.layer, d.key)
           for d in TS.lint_hp(t, model_cfg=t_llama("llama-0.3b", **dims), mode="train").diagnostics]
    assert got == want


_MODEL_AWARE = {
    # GPT's vocab at vtp 2 (the reference's GLS009 error)
    "gpt_vocab_vtp2": ("gpt", dict(vocab_tp=2), {}),
    # heads 6 over tp 4, kv heads 3 over tp 2 and 6 (GLS007 error / warning)
    "heads_tp4": ("llama", dict(tp=4), dict(num_heads=6, num_kv_heads=3)),
    "kv_heads_tp2": ("llama", dict(tp=2), dict(num_heads=6, num_kv_heads=3)),
    # sequence 30 under Megatron-SP tp 4 (GLS008), and without SP (clean)
    "seq_sp_tp4": ("llama", dict(tp=4), dict(max_seq_len=30, num_heads=8, num_kv_heads=8)),
    "seq_no_sp_tp4": ("llama", dict(tp=4, sequence_parallel=False),
                      dict(max_seq_len=30, num_heads=8, num_kv_heads=8)),
    # Ulysses sp at tp 1 (GLS103) and a heterogeneous run of layers (GLS102)
    "ulysses_tp1": ("gpt", dict(sp=1), {}),
    "hetero": ("gpt", dict(layers=[dict(tp=2), dict(tp=4, fsdp=1), dict(tp=4, tp_consec=0),
                                   dict(tp=4), dict()]), {}),
}


@pytest.mark.parametrize("name", sorted(_MODEL_AWARE))
def test_model_aware_and_relayout_lint_matches_reference(name):
    """GLS007-009 (heads, sequence and vocab against tp and vocab tp),
    GLS102 (adjacent-layer re-layout) and the Ulysses-sp GLS103: the same
    diagnostics, in the same order, as the reference's lint on the same
    strategy and model."""
    from galvatron_tpu.models import gpt as JG
    from galvatron_tpu.models import llama as JL
    from galvatron_tpu_torch.models import gpt as TG
    from galvatron_tpu_torch.models import llama as TL

    family, kw, model = _MODEL_AWARE[name]
    kw = dict(kw)
    layers = kw.pop("layers", None)
    n = len(layers) if layers else 4
    dims = dict(num_layers=n, **model)
    if family == "gpt":
        jcfg, tcfg = JG.gpt_config("gpt-0.3b", **dims), TG.gpt_config("gpt-0.3b", **dims)
    else:
        jcfg = JL.llama_config("llama-0.3b", hidden_size=768, **dims)
        tcfg = TL.llama_config("llama-0.3b", hidden_size=768, **dims)
    if layers is None:
        j = JC.HybridParallelConfig.uniform(8, n, **kw)
        t = TC.HybridParallelConfig.uniform(8, n, **kw)
    else:
        j = JC.HybridParallelConfig(world_size=8, pp=1, layers=[JC.LayerStrategy(**s)
                                                                for s in layers], **kw)
        t = TC.HybridParallelConfig(world_size=8, pp=1, layers=[TC.LayerStrategy(**s)
                                                                for s in layers], **kw)
    want = [(d.code, d.severity, d.layer, d.key, d.message)
            for d in JS.lint_hp(j, model_cfg=jcfg, mode="train").diagnostics
            if d.code in _PORTED_CODES]
    got = [(d.code, d.severity, d.layer, d.key, d.message)
           for d in TS.lint_hp(t, model_cfg=tcfg, mode="train").diagnostics]
    assert got == want
    assert got or name == "seq_no_sp_tp4"
