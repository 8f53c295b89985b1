"""The port's serve entry point: an end-to-end tiny llama run on the CPU,
the --device contract (cuda by default, never a silent CPU fallback), the
flags this slice refuses, and the telemetry stream read back by the
reference's reader. The CUDA run is in tests/test_torch_cuda.py."""

import json

import pytest
import torch

from galvatron_tpu.obs import telemetry as JT
from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError
from galvatron_tpu_torch.cli import serve as S
from galvatron_tpu_torch.ops import flash_attention as TF

TINY = [
    "--model_type", "llama", "--set_model_config_manually", "1",
    "--hidden_size", "64", "--num_attention_heads", "4", "--num_kv_heads", "2",
    "--ffn_hidden_size", "128", "--num_layers", "2", "--vocab_size", "64",
    "--seq_length", "64", "--serve_max_concurrency", "2", "--serve_page_size", "16",
    "--num_requests", "5", "--prompt_len_min", "3", "--prompt_len_max", "20",
    "--max_new_tokens", "4",
]


def test_serve_cpu_end_to_end_returns_summary(tmp_path):
    tele = tmp_path / "serve.jsonl"
    summary = S.main(TINY + ["--device", "cpu", "--telemetry", str(tele)])
    assert summary["requests"] == 5 and summary["shed"] == 0
    assert summary["output_tokens"] == 20
    assert summary["device"] == "cpu"
    assert summary["decode_steps"] > 0
    events, errors = JT.read_events(str(tele))  # the reference's reader
    assert errors == []
    kinds = [e["type"] for e in events]
    assert kinds.count("serve_request") == 5
    assert "decode_batch" in kinds


def test_serve_cpu_flash_route_with_page_128():
    """head_dim 128 at page 128: every prefill bucket is flash-eligible and
    takes the kernel's plain version on the CPU — no launches, no build."""
    argv = [
        "--device", "cpu", "--model_type", "llama", "--set_model_config_manually", "1",
        "--hidden_size", "256", "--num_attention_heads", "2", "--ffn_hidden_size", "128",
        "--num_layers", "2", "--vocab_size", "64", "--seq_length", "256",
        "--serve_max_concurrency", "2", "--serve_page_size", "128",
        "--num_requests", "3", "--prompt_len_min", "100", "--prompt_len_max", "200",
        "--max_new_tokens", "3",
    ]
    n0 = TF.flash_attention_fwd.launches
    summary = S.main(argv)
    assert summary["requests"] == 3
    assert TF.flash_attention_fwd.launches == n0


def test_default_device_is_cuda_and_never_falls_back():
    args = S.initialize_galvatron(argv=TINY)
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.serve(args)


@pytest.mark.parametrize("flag", [
    ["--load", "/tmp/ckpt"], ["--watchdog", "5"], ["--mesh_probe_interval", "1"],
    ["--migrate_on_degrade", "1"], ["--elastic_strategy", "x.json"],
    ["--elastic_memory_gb", "16"], ["--compile_cache", "1"],
])
def test_unported_flags_are_refused(flag):
    with pytest.raises(SystemExit):
        S.initialize_galvatron(argv=TINY + flag)


def test_multi_device_layout_is_refused_with_value_error():
    with pytest.raises(ValueError, match="world size 1 only"):
        S.main(TINY + ["--device", "cpu", "--world_size", "2"])


def test_serve_refuses_pipeline_with_gls014():
    with pytest.raises(DiagnosticError) as e:
        S.main(TINY + ["--device", "cpu", "--world_size", "2", "--pp_deg", "2"])
    assert "GLS014" in {d.code for d in e.value.diagnostics}


def test_unported_family_names_the_later_slice():
    with pytest.raises(ValueError, match="not ported"):
        S.main(["--device", "cpu", "--model_type", "gpt"])


def test_strategy_json_serve_knobs_set_the_cache(tmp_path):
    path = tmp_path / "serve.json"
    path.write_text(json.dumps({
        "pp_deg": 1, "tp_sizes_enc": "1,1", "tp_consecutive_flags": "1,1",
        "dp_types_enc": "0,0", "global_bsz": 1, "serve_max_concurrency": 3,
        "serve_page_size": 16,
    }))
    argv = [a for a in TINY]
    for flag in ("--serve_max_concurrency", "--serve_page_size"):
        i = argv.index(flag)
        del argv[i:i + 2]
    summary = S.main(argv + ["--device", "cpu", "--galvatron_config_path", str(path)])
    assert summary["requests"] == 5
