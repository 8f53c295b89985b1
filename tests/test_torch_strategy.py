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
from galvatron_tpu_torch.runtime.model_api import check_single_device

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
    world = kw.pop("world_size")
    hp = TC.HybridParallelConfig.uniform(world, 4, **kw)
    with pytest.raises(ValueError, match="world size 1 only"):
        check_single_device(hp)


def test_runtime_accepts_world_one():
    check_single_device(TC.HybridParallelConfig.uniform(1, 4, checkpoint=1))


# codes the port's lint reports; the reference's others need its cost model
# or fire only on the tp/cp/sp layouts that come with later slices
_PORTED_CODES = {"GLS001", "GLS002", "GLS003", "GLS004", "GLS005", "GLS006", "GLS014",
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
    severity, layer, key) wherever the code is ported; the reference lints
    with a llama config, whose model-aware codes are not ported."""
    from galvatron_tpu.models.llama import llama_config as j_llama

    jcfg = j_llama("llama-0.3b", num_layers=4, hidden_size=192, num_heads=6, num_kv_heads=3,
                   vocab_size=1001, max_seq_len=30)
    j = JC.HybridParallelConfig.from_json(path, world_size=8)
    t = TC.HybridParallelConfig.from_json(path, world_size=8)
    want = [(d.code, d.severity, d.layer, d.key)
            for d in JS.lint_hp(j, model_cfg=jcfg, mode="train").diagnostics
            if d.code in _PORTED_CODES]
    got = [(d.code, d.severity, d.layer, d.key)
           for d in TS.lint_hp(t, mode="train").diagnostics]
    assert got == want
