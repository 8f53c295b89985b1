"""The port's train entry point: end-to-end tiny llama runs on the CPU (global
flags, and a strategy JSON with per-layer remat whose attention takes the
flash Function's plain versions), the summary keys, the --device contract
(cuda by default, never a silent CPU fallback), the train-mode lint and the
flags the port refuses. The CUDA run is in tests/test_torch_cuda.py."""

import json
import math

import pytest
import torch

from galvatron_tpu_torch.cli import train as T
from galvatron_tpu_torch.ops import flash_attention as TF

TINY = [
    "--model_type", "llama", "--set_model_config_manually", "1",
    "--hidden_size", "64", "--num_attention_heads", "4", "--num_kv_heads", "2",
    "--ffn_hidden_size", "128", "--num_layers", "2", "--vocab_size", "64",
    "--seq_length", "32", "--global_train_batch_size", "4", "--chunks", "2",
    "--train_iters", "4", "--lr", "1e-3",
]
FLASH = [
    "--model_type", "llama", "--set_model_config_manually", "1",
    "--hidden_size", "256", "--num_attention_heads", "2", "--ffn_hidden_size", "128",
    "--num_layers", "3", "--vocab_size", "64", "--seq_length", "256",
    "--global_train_batch_size", "2", "--chunks", "2", "--train_iters", "3",
]
SUMMARY_KEYS = {"avg_iter_ms", "p50_iter_ms", "steady_step_ms", "samples_per_s", "peak_hbm_mb",
                "iters", "model_flops_per_step", "model_flops_per_s", "mfu", "losses",
                "tokens_per_s", "device"}


def test_train_cpu_end_to_end_returns_summary(capsys):
    summary = T.main(TINY + ["--device", "cpu", "--checkpoint", "1", "--log_interval", "2"])
    assert SUMMARY_KEYS <= set(summary)
    assert len(summary["losses"]) == 4 and all(math.isfinite(x) for x in summary["losses"])
    assert summary["iters"] == 2  # two warmup iterations left out
    assert summary["device"] == "cpu"
    assert summary["tokens_per_s"] == pytest.approx(summary["samples_per_s"] * 32)
    out = capsys.readouterr().out
    assert "iter    0" in out and "iter    2" in out and "iter    1" not in out
    assert "ckpt" in out  # the strategy's per-layer remat, as described


def test_train_cpu_strategy_json_with_per_layer_remat_takes_the_flash_route(tmp_path):
    path = tmp_path / "strategy.json"
    path.write_text(json.dumps({
        "pp_deg": 1, "tp_sizes_enc": "1,1,1", "tp_consecutive_flags": "1,1,1",
        "dp_types_enc": "0,0,0", "checkpoint": "1,1,0",
        "remat_policy": "full,dots_saveable,full", "global_bsz": 2, "chunks": 2,
    }))
    n_fwd, n_bwd = TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches
    summary = T.main(FLASH + ["--device", "cpu", "--galvatron_config_path", str(path)])
    assert len(summary["losses"]) == 3 and all(math.isfinite(x) for x in summary["losses"])
    # the CPU takes the plain versions: no build, no launch
    assert (TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches) == (n_fwd, n_bwd)


def test_train_default_device_is_cuda_and_never_falls_back():
    args = T.initialize_galvatron(argv=TINY, mode="train")
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.train(args)


@pytest.mark.parametrize("flag", [
    ["--data_path", "/tmp/corpus"], ["--save", "/tmp/ckpt"], ["--load", "/tmp/ckpt"],
    ["--eval_interval", "5"], ["--telemetry", "x.jsonl"], ["--anomaly_guard", "1"],
    ["--sdc_check", "digest"], ["--autotune", "observe"], ["--prefetch_batches", "2"],
    ["--elastic", "resume"], ["--serve_page_size", "16"],
])
def test_train_unported_flags_are_refused(flag):
    with pytest.raises(SystemExit):
        T.initialize_galvatron(argv=TINY + flag, mode="train")


def test_train_multi_device_layout_is_refused_with_value_error():
    with pytest.raises(ValueError, match="world size 1 only"):
        T.main(TINY + ["--device", "cpu", "--world_size", "2"])


def test_train_lint_warns_on_inert_serve_knobs(tmp_path, capsys):
    path = tmp_path / "strategy.json"
    path.write_text(json.dumps({
        "pp_deg": 1, "tp_sizes_enc": "1,1", "tp_consecutive_flags": "1,1",
        "dp_types_enc": "0,0", "global_bsz": 4, "chunks": 2, "serve_max_concurrency": 4,
    }))
    T.main(TINY + ["--device", "cpu", "--galvatron_config_path", str(path),
                   "--train_iters", "1"])
    assert "GLS103" in capsys.readouterr().out


def test_train_unported_family_names_the_later_slice():
    with pytest.raises(ValueError, match="not ported"):
        T.main(["--device", "cpu", "--model_type", "gpt"])


def test_train_cell_parses_to_its_per_layer_remat_and_lints_clean(tmp_path):
    """The configuration chip_smoke.py trains and tools/profile_train.py
    traces: its arguments and strategy JSON give the stated layers, batch
    and remat mix, and the train-mode lint finds nothing."""
    from galvatron_tpu_torch.analysis import strategy_lint
    from galvatron_tpu_torch.cli.arguments import hp_config_from_args, model_config_from_args
    from galvatron_tpu_torch.tools import train_cell as C

    args = T.initialize_galvatron(argv=C.argv(C.write_strategy(str(tmp_path))), mode="train")
    assert args.device == "cuda"
    _, cfg = model_config_from_args(args)
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.max_seq_len) == (8, 4096, 32, 2048)
    hp = hp_config_from_args(args, cfg.num_layers, 1)
    assert [s.checkpoint for s in hp.layers] == C.CHECKPOINT
    assert [s.remat_policy for s in hp.layers] == C.REMAT_POLICY
    assert (hp.global_bsz, hp.chunks) == (C.GLOBAL_BSZ, C.CHUNKS)
    assert strategy_lint.lint_hp(hp, mode="train").diagnostics == []
