"""The port's offline telemetry report (``obs/report.py``, ``cli report``)
and the rest of ``obs/attribution.py`` and ``obs/flops.py``, held against
the JAX package's on the same streams: the golden fixture of
``tests/obs``, and the streams the port's own ``cli train --device cpu
--telemetry`` and ``cli serve --device cpu --telemetry`` write (both
packages read one schema). The analysis dicts must be equal (floats to
1e-12 relative) and the rendered text identical."""

import io
import json
import math
import os
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from galvatron_tpu.models import gpt as JG
from galvatron_tpu.models import llama as JL
from galvatron_tpu.models import t5 as JT5
from galvatron_tpu.obs import attribution as JA
from galvatron_tpu.obs import flops as JF
from galvatron_tpu.obs import report as JR
from galvatron_tpu.obs import telemetry as JT
from galvatron_tpu_torch.cli import serve as TS
from galvatron_tpu_torch.cli import train as TTR
from galvatron_tpu_torch.config.strategy import HybridParallelConfig, LayerStrategy
from galvatron_tpu_torch.models import gpt as TG
from galvatron_tpu_torch.models import llama as TL
from galvatron_tpu_torch.models import t5 as TT5
from galvatron_tpu_torch.obs import attribution as TA
from galvatron_tpu_torch.obs import flops as TF
from galvatron_tpu_torch.obs import report as TR
from galvatron_tpu_torch.obs import telemetry as TT

GOLDEN = os.path.join(os.path.dirname(__file__), "obs", "fixtures", "golden_telemetry.jsonl")
REL = 1e-12

TRAIN = [
    "--device", "cpu", "--model_type", "llama", "--set_model_config_manually", "1",
    "--hidden_size", "64", "--num_attention_heads", "4", "--num_kv_heads", "2",
    "--ffn_hidden_size", "128", "--num_layers", "2", "--vocab_size", "64",
    "--seq_length", "32", "--global_train_batch_size", "4", "--chunks", "2",
    "--train_iters", "6", "--lr", "1e-3",
]
SERVE = [
    "--device", "cpu", "--model_type", "llama", "--set_model_config_manually", "1",
    "--hidden_size", "64", "--num_attention_heads", "4", "--num_kv_heads", "2",
    "--ffn_hidden_size", "128", "--num_layers", "2", "--vocab_size", "64",
    "--seq_length", "64", "--serve_max_concurrency", "2", "--serve_page_size", "16",
    "--num_requests", "5", "--prompt_len_min", "3", "--prompt_len_max", "20",
    "--max_new_tokens", "4",
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """JAX's CPU backend and torch's thread pool share the cores here: with
    both pools on every core, torch's small ops run several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same(got, want, path="analysis"):
    """Equal structures; floats within REL relative."""
    if isinstance(want, float) and isinstance(got, float):
        assert math.isclose(got, want, rel_tol=REL, abs_tol=0.0) or got == want, \
            "%s: %r != %r" % (path, got, want)
        return
    assert type(got) is type(want), "%s: %s != %s" % (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), "%s: keys %s != %s" % (path, list(got), list(want))
        for k in want:
            assert_same(got[k], want[k], "%s.%s" % (path, k))
    elif isinstance(want, list):
        assert len(got) == len(want), "%s: %d != %d entries" % (path, len(got), len(want))
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, "%s[%d]" % (path, i))
    else:
        assert got == want, "%s: %r != %r" % (path, got, want)


def both_reports(path):
    t_events, t_errors = TT.read_events(path, strict=False)
    j_events, j_errors = JT.read_events(path, strict=False)
    assert t_errors == j_errors == []
    got, want = TR.analyze(t_events), JR.analyze(j_events)
    assert_same(got, want)
    assert TR.render(got) == JR.render(want)
    return got


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    d = tmp_path_factory.mktemp("streams")
    train_path, serve_path = str(d / "train.jsonl"), str(d / "serve.jsonl")
    with redirect_stdout(io.StringIO()):
        train_summary = TTR.main(TRAIN + ["--telemetry", train_path])
        serve_summary = TS.main(SERVE + ["--telemetry", serve_path])
    return {"train": (train_path, train_summary), "serve": (serve_path, serve_summary)}


def test_report_on_the_golden_fixture_equals_the_references():
    got = both_reports(GOLDEN)
    # the fixture carries the item-10 events and a compile event: both read
    assert got["tp_overlap"] and got["quant_comm"]
    assert got["divergence"][0]["measured_memory_mb"] is not None
    assert got["serving"]["requests"] == 2 and got["integrity"]["mismatches"] == 1


def test_report_on_the_ports_train_stream_equals_the_references(streams):
    path, summary = streams["train"]
    got = both_reports(path)
    assert got["steps"]["n"] == 6 and got["counts"]["step"] == 6
    assert got["steady"]["step_ms"] > 0 and 0 < got["steady"]["mfu"]
    # one divergence row per layer run (one run of 2 layers) and the head;
    # the port's driver emits no compile event: no measured memory
    assert [r["run"] for r in got["divergence"]] == [0, TA.HEAD_RUN]
    assert got["compile"] == {} and all(r.get("measured_memory_mb") is None
                                        for r in got["divergence"])
    assert got["summary"]["iters"] == summary["iters"]


def test_report_on_the_ports_serve_stream_equals_the_references(streams):
    path, summary = streams["serve"]
    sv = both_reports(path)["serving"]
    assert sv["requests"] == summary["requests"] == 5
    for name in ("ttft_ms", "tpot_ms"):
        for q in ("p50", "p99"):
            assert sv[name][q] == pytest.approx(summary[name][q], rel=1e-6), (name, q)


def _predictions():
    hp = HybridParallelConfig(world_size=4, pp=1, layers=[LayerStrategy(tp=2)] * 2
                              + [LayerStrategy(checkpoint=1)] * 2, global_bsz=8, chunks=2)
    cfg = TL.llama_config("llama-0.3b", hidden_size=64, num_heads=4, num_layers=4,
                          vocab_size=128, max_seq_len=64, ffn_hidden=128)
    return TA.predict_layer_runs(cfg, hp)


@pytest.mark.parametrize("measured", [(None, None), (120.0, None), (120.0, 2048.0)],
                         ids=["unmeasured", "step", "step_and_memory"])
def test_divergence_rows_and_table_equal_the_references(measured):
    preds = _predictions()
    step_ms, memory_mb = measured
    got = TA.divergence_rows(preds, measured_step_ms=step_ms, measured_memory_mb=memory_mb)
    want = JA.divergence_rows(preds, measured_step_ms=step_ms, measured_memory_mb=memory_mb)
    assert_same(got, want, "rows")
    assert TA.render_divergence_table(got) == JA.render_divergence_table(want)
    assert TA.render_divergence_table([]) == JA.render_divergence_table([])


def _run_report(argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = TR.run(argv)
    return rc, out.getvalue(), err.getvalue()


def test_report_cli_exit_codes(tmp_path, monkeypatch):
    rc, out, _ = _run_report([GOLDEN, "--json"])
    assert rc == 0 and json.loads(out)["schema_errors"] == []
    bad = tmp_path / "bad.jsonl"
    bad.write_text(open(GOLDEN).read() + '{"v": 1, "type": "step", "bogus_key": 1}\n')
    rc, out, err = _run_report([str(bad)])
    assert rc == 1 and "schema:" in err and "telemetry report" in out
    rc, _, err = _run_report([str(tmp_path / "missing.jsonl")])
    assert rc == 2 and "cannot read" in err
    # through the package's entry point, as `python -m galvatron_tpu_torch.cli report`
    from galvatron_tpu_torch.cli import __main__ as M

    monkeypatch.setattr("sys.argv", ["cli", "report", str(tmp_path / "missing.jsonl")])
    with redirect_stderr(io.StringIO()):
        assert M.main() == 2


def _flops_cfgs():
    kw = dict(num_layers=2, max_seq_len=256)
    return [
        ("llama", JL.llama_config("llama-7b", **kw), TL.llama_config("llama-7b", **kw)),
        ("llama_gqa", JL.llama_config("llama-0.3b", num_kv_heads=4, **kw),
         TL.llama_config("llama-0.3b", num_kv_heads=4, **kw)),
        ("gpt", JG.gpt_config("gpt-1.5b", **kw), TG.gpt_config("gpt-1.5b", **kw)),
        ("t5", JT5.t5_config("t5-base"), TT5.t5_config("t5-base")),
    ]


@pytest.mark.parametrize("case", range(4), ids=["llama", "llama_gqa", "gpt", "t5"])
def test_decode_roofline_helpers_equal_the_references(case):
    _, jcfg, tcfg = _flops_cfgs()[case]
    for kw in ({}, dict(batch_size=4, context_len=128), dict(batch_size=1, context_len=2048)):
        assert TF.decode_step_flops(tcfg, **kw) == JF.decode_step_flops(jcfg, **kw)
        assert TF.model_bytes_per_decode_token(tcfg, **kw) == \
            JF.model_bytes_per_decode_token(jcfg, **kw)
    assert TF.model_bytes_per_decode_token(tcfg, dtype_bytes=4, batch_size=8) == \
        JF.model_bytes_per_decode_token(jcfg, dtype_bytes=4, batch_size=8)
    assert TF.decode_step_flops(object()) is None and TF.model_bytes_per_decode_token(object()) is None
