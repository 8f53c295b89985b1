"""The port's ``cli lint`` (``cli/lint.py``, ``analysis/strategy_lint.py``,
``analysis/ckpt_lint.py``) against the JAX package's: every strategy
fixture under ``tests/analysis/fixtures/{valid,warn,broken}`` gives the
reference's codes, severities and exit code under each option set, but for
the fixtures of ROADMAP queue 1 item 10 (`ITEM_10`, each with its reason);
the GLS101 estimate is the reference's MB for MB; the checkpoint audit gives
the reference's codes on the reference's own checkpoints and the GLS21x
codes on planted faults in checkpoints the port's CPU trainer writes
(GLS214 under ``--deep``); the JAX-program analyses are refused."""

import glob
import io
import json
import os
import shutil
from contextlib import redirect_stderr, redirect_stdout

import jax.numpy as jnp
import pytest
import torch

from galvatron_tpu.analysis import ckpt_lint as JK
from galvatron_tpu.analysis import strategy_lint as JS
from galvatron_tpu.cli.lint import run as jax_lint
from galvatron_tpu.config.strategy import HybridParallelConfig as JHP
from galvatron_tpu.models.base import TransformerConfig as JCfg
from galvatron_tpu.runtime import checkpoint as jck
from galvatron_tpu.runtime import elastic as jels
from galvatron_tpu_torch.analysis import ckpt_lint as TK
from galvatron_tpu_torch.analysis import strategy_lint as TS
from galvatron_tpu_torch.cli import train as TTR
from galvatron_tpu_torch.cli.lint import run as torch_lint
from galvatron_tpu_torch.config.strategy import HybridParallelConfig as THP
from galvatron_tpu_torch.models.base import TransformerConfig as TCfg
from galvatron_tpu_torch.parallel.pipeline import validate_pipeline_config
from galvatron_tpu_torch.parallel.pipeline_1f1b import validate_1f1b_config
from galvatron_tpu_torch.runtime import checkpoint as tck

FIXTURES = os.path.join(os.path.dirname(__file__), "analysis", "fixtures")
STRATEGIES = sorted(os.path.relpath(p, FIXTURES) for p in glob.glob(
    os.path.join(FIXTURES, "*", "*.json")) if "ckpt_valid" not in p)
OPTIONS = {
    "plain": [],
    "model": ["--model_type", "gpt"],
    "budget": ["--model_type", "llama", "--memory_budget_gb", "0.0001"],
    "serve": ["--serve", "--model_type", "llama", "--memory_budget_gb", "64"],
}
# the quantized-collective fixtures: the reference prices them through
# parallel/quant_collectives.py (ROADMAP queue 1 item 10), which the port
# has not; its trainer refuses any quantized sync, and its lint says so
# (GLS013) outside serve mode
QUANT_REFUSAL = "the port's trainer refuses quantized syncs (item 10)"
NO_QUANT_REASON = "quant_comm_reason, the reference's serve-mode refusal, is item 10"
ITEM_10 = {
    ("valid/quant_dp8.json", "plain"): (QUANT_REFUSAL, [("GLS013", "error")]),
    ("valid/quant_dp8.json", "model"): (QUANT_REFUSAL, [("GLS013", "error")]),
    ("valid/quant_dp8.json", "budget"): (QUANT_REFUSAL, [("GLS101", "warning"),
                                                         ("GLS013", "error")]),
    ("warn/gls103_inert_param_comm.json", "plain"): (QUANT_REFUSAL, [("GLS013", "error")]),
    ("warn/gls103_inert_param_comm.json", "model"): (QUANT_REFUSAL, [("GLS013", "error")]),
    ("warn/gls103_inert_param_comm.json", "budget"): (QUANT_REFUSAL, [("GLS101", "warning"),
                                                                      ("GLS013", "error")]),
    ("warn/gls103_inert_param_comm.json", "serve"): (NO_QUANT_REASON, []),
    # the same code as the reference's, for the port's reason
    ("broken/gls013_quant_unsupported.json", "plain"): (QUANT_REFUSAL, [("GLS013", "error")]),
    ("broken/gls013_quant_unsupported.json", "model"): (QUANT_REFUSAL, [("GLS013", "error")]),
    ("broken/gls013_quant_unsupported.json", "budget"): (QUANT_REFUSAL, [("GLS101", "warning"),
                                                                         ("GLS013", "error")]),
    ("broken/gls013_quant_unsupported.json", "serve"): (NO_QUANT_REASON, []),
}
MODEL = dict(hidden_size=96, num_heads=6, num_layers=4, vocab_size=100, max_seq_len=100)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lint(fn, argv):
    """(exit code, parsed --json payload or None, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = fn(argv)
    try:
        payload = json.loads(out.getvalue())
    except ValueError:
        payload = None
    return rc, payload, out.getvalue(), err.getvalue()


def codes(payload):
    return sorted((d["code"], d["severity"]) for d in payload["diagnostics"])


@pytest.mark.parametrize("rel", STRATEGIES)
def test_strategy_fixture_lints_as_in_the_reference(rel):
    for name, extra in OPTIONS.items():
        argv = [os.path.join(FIXTURES, rel), "--world_size", "8", "--json"] + extra
        rc, got, _, _ = lint(torch_lint, argv)
        if (rel, name) in ITEM_10:
            reason, want = ITEM_10[(rel, name)]
            assert codes(got) == sorted(want), (rel, name, reason)
            assert rc == (1 if any(sev == "error" for _, sev in want) else 0)
            continue
        jrc, want, _, _ = lint(jax_lint, argv)
        assert (rc, codes(got)) == (jrc, codes(want)), (rel, name)
        assert [d["message"] for d in got["diagnostics"]] == \
            [d["message"] for d in want["diagnostics"]], (rel, name)


def test_item_10_exceptions_name_fixtures_that_exist_and_differ():
    for (rel, name) in ITEM_10:
        argv = [os.path.join(FIXTURES, rel), "--world_size", "8", "--json"] + OPTIONS[name]
        got, want = lint(torch_lint, argv)[1], lint(jax_lint, argv)[1]
        assert [(d["code"], d["message"]) for d in got["diagnostics"]] != \
            [(d["code"], d["message"]) for d in want["diagnostics"]], (rel, name)


@pytest.mark.parametrize("profile", [False, True], ids=["analytic", "profiled"])
def test_gls101_estimate_equals_the_references(profile, tmp_path):
    rel = os.path.join(FIXTURES, "warn", "gls101_over_budget.json")
    memory = {"layertype_0": {"parameter_size": 900.0,
                              "tp_activation_per_bsz_dict": {"1": 700.0, "2": 350.0,
                                                             "4": 175.0, "8": 90.0,
                                                             "checkpoint": 12.0}}}
    got = TS.lint_strategy_file(rel, 8).diagnostics  # constructs
    assert got == []
    t_hp, j_hp = THP.from_json(rel, world_size=8), JHP.from_json(rel, world_size=8)
    t_mb = TS.estimate_stage_memory_mb(t_hp, TCfg(**MODEL), memory if profile else None)
    j_mb = JS.estimate_stage_memory_mb(j_hp, JCfg(**MODEL), memory if profile else None)
    assert t_mb == j_mb and t_mb[0] > 0
    argv = [rel, "--world_size", "8", "--json", "--model_type", "llama", "--model_size",
            "llama-7b", "--memory_budget_gb", "1"]
    if profile:
        path = tmp_path / "memory.json"
        path.write_text(json.dumps(memory))
        argv += ["--memory_profile", str(path)]
    rc, got, _, _ = lint(torch_lint, argv)
    jrc, want, _, _ = lint(jax_lint, argv)
    assert rc == jrc == 0 and got["diagnostics"] == want["diagnostics"]
    assert [d["code"] for d in got["diagnostics"]] == ["GLS101"]
    rc, _, _, _ = lint(torch_lint, argv + ["--strict"])
    assert rc == 1


def _constructs(rel):
    try:
        THP.from_json(os.path.join(FIXTURES, rel), world_size=8)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("rel", [r for r in STRATEGIES if _constructs(r)])
def test_lint_and_the_engines_refuse_alike(rel):
    """GLS010 / GLS011 and the pipeline engines' refusals come from one
    rule (``HybridParallelConfig.pipeline_engine_findings``)."""
    hp = THP.from_json(os.path.join(FIXTURES, rel), world_size=8)
    lint_says = [d.code for d in hp.pipeline_engine_diagnostics()]
    validate = validate_1f1b_config if hp.pipeline_type == "pipedream_flush" \
        else validate_pipeline_config
    try:
        validate(hp)
        refused = False
    except ValueError:
        refused = True
    assert refused == bool(lint_says), (rel, lint_says)


@pytest.mark.parametrize("flag", ["--code", "--trace", "--compat", "module.py"])
def test_jax_program_analyses_are_refused(flag):
    rc, _, out, err = lint(torch_lint, [flag])
    assert rc == 2 and out == ""
    assert "ROADMAP queue 1 item 12" in err


def test_usage_failures_and_the_code_table(tmp_path, monkeypatch):
    assert lint(torch_lint, [])[0] == 2
    assert lint(torch_lint, ["--ckpt", str(tmp_path / "nope")])[0] == 2
    rc, _, out, _ = lint(torch_lint, ["--explain"])
    assert rc == 0 and all(c in out for c in ("GLS010", "GLS011", "GLS101", "GLS211", "GLS213"))
    from galvatron_tpu_torch.cli import __main__ as M

    monkeypatch.setattr("sys.argv", ["cli", "lint", os.path.join(FIXTURES, "broken",
                                                                  "gls010_gpipe_nonuniform.json")])
    with redirect_stdout(io.StringIO()) as out:
        assert M.main() == 1
    assert "GLS010" in out.getvalue()


# ---------------------------------------------------------- checkpoint audit
def jax_checkpoint(d, provenance=True):
    class Cfg:
        hidden_size, num_heads, num_layers, vocab_size, max_seq_len = 32, 2, 2, 64, 16

    hp = JHP.uniform(8, 2, global_bsz=8)
    prov = jels.build_provenance(hp, Cfg(), memory_budget_gb=16.0) if provenance else None
    jck.save_checkpoint(d, 2, {"w": jnp.arange(4.0)}, hp=hp, provenance=prov)
    return d


def _torn(d):
    os.remove(os.path.join(d, "manifests", "2.json"))


def _stray(d):
    os.makedirs(os.path.join(d, "editor_droppings"))
    shutil.rmtree(os.path.join(d, "2"))


def _bad_provenance(d):
    path = os.path.join(d, "manifests", "2.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["provenance"]["strategy"]["tp_sizes_enc"] = "3,1"  # 3 does not tile 8
    manifest["provenance"]["mesh_shape"] = {"pp": 2, "m0": 2}
    with open(path, "w") as f:
        json.dump(manifest, f)


@pytest.mark.parametrize("variant", ["fixture", "clean", "no_provenance", "torn", "stray",
                                     "bad_provenance"])
def test_audit_of_the_references_checkpoints_gives_its_codes(variant, tmp_path):
    """The reference's layout (orbax step directories, which the port cannot
    read: the codes only, no --deep) audited by both packages."""
    if variant == "fixture":
        d = os.path.join(FIXTURES, "ckpt_valid")
    else:
        d = jax_checkpoint(str(tmp_path / "ck"), provenance=variant != "no_provenance")
        {"torn": _torn, "stray": _stray, "bad_provenance": _bad_provenance}.get(
            variant, lambda d: None)(d)
    got = sorted((x.code, x.severity) for x in TK.audit_checkpoint_dir(d).diagnostics)
    want = sorted((x.code, x.severity) for x in JK.audit_checkpoint_dir(d).diagnostics)
    assert got == want
    rc, _, _, _ = lint(torch_lint, ["--ckpt", d])
    assert rc == (1 if any(sev == "error" for _, sev in want) else 0)


TRAIN = [
    "--device", "cpu", "--model_type", "llama", "--set_model_config_manually", "1",
    "--hidden_size", "64", "--num_attention_heads", "4", "--num_kv_heads", "2",
    "--ffn_hidden_size", "128", "--num_layers", "2", "--vocab_size", "64",
    "--seq_length", "32", "--global_train_batch_size", "4", "--chunks", "2",
    "--train_iters", "2", "--lr", "1e-3", "--save_interval", "1",
]


@pytest.fixture(scope="module")
def port_checkpoint(tmp_path_factory):
    """Steps 1 and 2 of the port's CPU trainer (params, Adam state and their
    folds in the manifest)."""
    d = str(tmp_path_factory.mktemp("port") / "ck")
    with redirect_stdout(io.StringIO()):
        TTR.main(TRAIN + ["--save", d])
    return d


def _flip_byte(d):
    path = tck._rank_file(d, 2, 0)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0x40  # inside the tensor data, past the zip's headers
    open(path, "wb").write(bytes(data))


def _edit_manifest(fn):
    def edit(d):
        path = os.path.join(d, "manifests", "2.json")
        with open(path) as f:
            manifest = json.load(f)
        fn(manifest)
        with open(path, "w") as f:
            json.dump(manifest, f)
    return edit


def _edit_meta(fn):
    def edit(d):
        path = os.path.join(d, "meta.json")
        with open(path) as f:
            meta = json.load(f)
        fn(meta)
        with open(path, "w") as f:
            json.dump(meta, f)
    return edit


PLANTED = {
    # name: (plant, extra flags, codes, exit code)
    "clean": (lambda d: None, [], [], 0),
    "clean_deep": (lambda d: None, ["--deep"], [], 0),
    "torn": (_torn, [], ["GLS210"], 1),
    "stray_entry": (lambda d: os.makedirs(os.path.join(d, "2.tmp-upload")), ["--strict"],
                    ["GLS211"], 1),
    "orphan_manifest": (lambda d: shutil.rmtree(os.path.join(d, "2")), ["--strict"],
                        ["GLS211"], 1),
    "malformed_manifest": (_edit_manifest(lambda m: m.update(iteration=7)), [], ["GLS212"],
                           1),
    "bad_provenance": (_edit_manifest(lambda m: m["provenance"].update(world_size="one")), [],
                       ["GLS212"], 1),
    "no_provenance": (_edit_manifest(lambda m: m.pop("provenance")), ["--strict"],
                      ["GLS213"], 1),
    "no_fold_deep": (_edit_manifest(lambda m: m["items"]["opt_state"].pop("fold")),
                     ["--deep", "--strict"], ["GLS213"], 1),
    "flipped_byte_deep": (_flip_byte, ["--deep"], ["GLS214"], 1),
    "no_model_record_deep": (_edit_meta(lambda m: m.pop("model_config")),
                             ["--deep", "--strict"], ["GLS213"], 1),
    "other_model_record_deep": (_edit_meta(lambda m: m["model_config"].update(vocab_size=96)),
                                ["--deep"], ["GLS212"], 1),
    "flipped_byte_shallow": (_flip_byte, [], [], 0),
}


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_audit_of_the_ports_checkpoint_finds_the_planted_fault(name, port_checkpoint,
                                                               tmp_path):
    plant, extra, want, want_rc = PLANTED[name]
    d = str(tmp_path / "ck")
    shutil.copytree(port_checkpoint, d)
    plant(d)
    rc, payload, _, _ = lint(torch_lint, ["--ckpt", d, "--json", "--device", "cpu"] + extra)
    assert sorted({c for c, _ in codes(payload)}) == want, payload
    assert rc == want_rc
    if name == "flipped_byte_deep":
        assert any("item 'opt_state'" in x["message"] or "item 'params'" in x["message"]
                   for x in payload["diagnostics"])
