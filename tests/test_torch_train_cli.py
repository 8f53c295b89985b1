"""The port's train entry point: end-to-end tiny llama runs on the CPU (global
flags, and a strategy JSON with per-layer remat whose attention takes the
flash Function's plain versions), the summary keys, the --device contract
(cuda by default, never a silent CPU fallback), the train-mode lint and the
flags the port refuses (its corpus, eval, checkpoint, guard and telemetry
flags are driven in tests/test_torch_resume.py). The CUDA run is in tests/test_torch_cuda.py."""

import dataclasses
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
                "tokens_per_s", "device", "flash_routes"}


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
    ["--trace_lint", "1"], ["--compile_cache", "1"], ["--serve_page_size", "16"],
])
def test_train_unported_flags_are_refused(flag):
    """The trace linter and the compilation cache (JAX runtime) are not
    ported; serve flags are not train flags."""
    with pytest.raises(SystemExit):
        T.initialize_galvatron(argv=TINY + flag, mode="train")


@pytest.mark.parametrize("flag", [
    ["--xla_trace", "trace_dir"], ["--xla_trace", "d", "--trace_steps", "2:3"],
    ["--profile", "1", "--train_log_dir", "logs"],
])
def test_train_observability_flags_parse_as_in_the_reference(flag):
    """--xla_trace (a torch.profiler trace here), --trace_steps, --profile
    and --train_log_dir parse to the JAX package's values and defaults."""
    from galvatron_tpu.cli.arguments import initialize_galvatron as jax_parse

    got = T.initialize_galvatron(argv=TINY + flag, mode="train")
    want = jax_parse(mode="train", argv=TINY + flag)
    for key in ("xla_trace", "trace_steps", "profile", "train_log_dir", "telemetry"):
        assert getattr(got, key) == getattr(want, key), key


def test_train_traces_a_step_window_and_tees_the_iteration_log(tmp_path, capsys):
    """--xla_trace --trace_steps 2:3 exports a Chrome trace of the window
    (rank 0's file) between trace start and stop events; --train_log_dir
    gets one line per iteration under --profile, and the summary is
    printed once."""
    from galvatron_tpu_torch.obs import telemetry

    trace_dir, log_dir, tele = tmp_path / "trace", tmp_path / "logs", tmp_path / "run.jsonl"
    argv = TINY + ["--device", "cpu", "--train_iters", "5", "--xla_trace", str(trace_dir),
                   "--trace_steps", "2:3", "--train_log_dir", str(log_dir), "--profile", "1",
                   "--log_interval", "4", "--telemetry", str(tele)]
    summary = T.main(argv)
    trace = json.loads((trace_dir / "trace_rank0.json").read_text())
    assert any(e.get("cat") == "cpu_op" for e in trace["traceEvents"])
    events, errors = telemetry.read_events(str(tele))
    assert errors == []
    marks = [(e["action"], e.get("first_step"), e.get("last_step")) for e in events
             if e["type"] == "trace"]
    assert marks == [("start", 2, 3), ("stop", None, None)]
    # the window is bracketed by full drains: it starts after step 1's
    # step event and stops right after step 3's
    order = [(e["type"], e.get("iter", e.get("action"))) for e in events
             if e["type"] in ("step", "trace")]
    assert order.index(("trace", "start")) == order.index(("step", 1)) + 1
    assert order.index(("trace", "stop")) == order.index(("step", 3)) + 1
    lines = (log_dir / "train_llama_llama-0.3b.log").read_text().splitlines()
    assert [int(line.split()[1]) for line in lines] == list(range(5))
    out = capsys.readouterr().out
    assert out.count("'steady_step_ms'") == 1 and len(summary["losses"]) == 5


RESILIENCE_FLAGS = [
    ["--watchdog", "30", "--watchdog_factor", "3", "--watchdog_startup_s", "120"],
    ["--mesh_probe_interval", "5", "--migrate_on_degrade", "1"],
    ["--sdc_check", "vote", "--sdc_interval", "4", "--sdc_strikes", "3"],
    ["--sdc_check", "digest"],
    ["--autotune", "apply", "--autotune_margin", "0.1"],
    ["--autotune", "observe"],
]


@pytest.mark.parametrize("flag", RESILIENCE_FLAGS)
def test_train_resilience_flags_parse_as_in_the_reference(flag):
    """The watchdog, mesh-probe, migration, sentinel and autotune flags
    parse to the JAX package's values (the port adds --autotune_window and
    --autotune_rel_std, driver state there)."""
    from galvatron_tpu.cli.arguments import initialize_galvatron as jax_parse

    got = T.initialize_galvatron(argv=TINY + flag, mode="train")
    want = jax_parse(mode="train", argv=TINY + flag)
    for key in ("watchdog", "watchdog_factor", "watchdog_startup_s", "mesh_probe_interval",
                "migrate_on_degrade", "sdc_check", "sdc_interval", "sdc_strikes", "autotune",
                "autotune_margin"):
        assert getattr(got, key) == getattr(want, key), key


@pytest.mark.parametrize("flag", [
    ["--elastic", "resume"], ["--elastic", "search", "--elastic_memory_gb", "12.5"],
    ["--elastic_strategy", "x.json", "--config_dir", "profiles"],
])
def test_train_elastic_flags_parse_as_in_the_reference(flag):
    """The elastic-resume flags (and --config_dir, which an elastic search
    reads) parse to the JAX package's values."""
    from galvatron_tpu.cli.arguments import initialize_galvatron as jax_parse

    got = T.initialize_galvatron(argv=TINY + flag, mode="train")
    want = jax_parse(mode="train", argv=TINY + flag)
    for key in ("elastic", "elastic_strategy", "elastic_memory_gb", "config_dir"):
        assert getattr(got, key) == getattr(want, key), key


def test_train_multi_device_layout_is_refused_with_value_error():
    """A world size other than the process group's (one rank here, no
    torchrun) is refused (the layouts this slice does not run are refused
    by check_layout, tests/test_torch_strategy.py)."""
    with pytest.raises(ValueError, match="process group has 1 rank"):
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
    """T5 trains in the port; the generic flags it has no field for refuse
    as in the reference (T5 and Swin take their sizes from --model_size)."""
    with pytest.raises(ValueError, match="not supported by family 't5'"):
        T.main(["--device", "cpu", "--model_type", "t5", "--set_layernum_manually", "1",
                "--num_layers", "2"])


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


GPT_TINY = [
    "--model_type", "gpt", "--set_model_config_manually", "1", "--hidden_size", "64",
    "--num_attention_heads", "4", "--num_layers", "4", "--vocab_size", "128",
    "--seq_length", "32", "--global_train_batch_size", "4", "--chunks", "2",
    "--train_iters", "4", "--lr", "1e-3", "--device", "cpu",
]


def fp32_compute(model_config_from_args):
    """`cli.arguments.model_config_from_args` with fp32 compute: the CLI
    computes in bf16, where a sharded run's sums differ from a one-rank
    run's by bf16 rounding; in fp32 they agree to ~1e-6."""
    def resolve(args):
        fam, cfg = model_config_from_args(args)
        return fam, dataclasses.replace(cfg, compute_dtype=torch.float32)
    return resolve


def test_torchrun_two_ranks_run_a_mixed_strategy_json_like_one_rank(tmp_path, monkeypatch):
    """``torchrun --nproc_per_node 2`` of the train CLI (`cli.train.main`,
    through this file's worker: the CLI with fp32 compute) on gloo, a
    strategy JSON mixing Megatron TP+SP (tp_consec 1 and 0), ZeRO-3, ZeRO-2
    (the default), plain DP rows and vocab TP with the tied head: rank 0's
    printed losses equal a one-rank run's within 2e-5."""
    import os
    import subprocess
    import sys

    path = tmp_path / "strategy.json"
    path.write_text(json.dumps({
        "pp_deg": 1, "tp_sizes_enc": "2,1,2,1", "tp_consecutive_flags": "1,1,0,1",
        "dp_types_enc": "0,1,0,0", "checkpoint": "0,0,1,0", "default_dp_type": "zero2",
        "vtp": 2, "global_bsz": 4, "chunks": 2,
    }))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_"))}
    env.update(PYTHONPATH=repo, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         os.path.abspath(__file__)] + GPT_TINY
        + ["--galvatron_config_path", str(path), "--world_size", "2"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("losses ")]
    assert len(lines) == 1, proc.stdout  # rank 0 prints, rank 1 does not
    got = [float(x) for x in lines[0].split()[1:]]
    assert "'world_size': 2" in proc.stdout
    # both ranks' route counts reach rank 0 (none on the CPU: plain versions)
    assert "'flash_routes': [{'fwd': {}, 'bwd': {}}, {'fwd': {}, 'bwd': {}}]" in proc.stdout
    monkeypatch.setattr(T, "model_config_from_args", fp32_compute(T.model_config_from_args))
    want = T.main(GPT_TINY + ["--checkpoint", "0"])["losses"]
    assert len(got) == len(want) == 4
    assert max(abs(a - b) for a, b in zip(got, want)) <= 2e-5, (got, want)


def test_gpt_train_cell_parses_to_its_layout_and_lints_clean(tmp_path):
    """The GPT configuration chip_smoke.py trains through the layout path:
    GPT-6.7B width at depth 8, layers 0-3 ZeRO-3 and the rest ZeRO-2, the
    LLaMA cell's remat mix; and the same with every fsdp 0."""
    from galvatron_tpu_torch.analysis import strategy_lint
    from galvatron_tpu_torch.cli.arguments import hp_config_from_args, model_config_from_args
    from galvatron_tpu_torch.tools import train_cell as C

    for fsdp in (True, False):
        args = T.initialize_galvatron(argv=C.gpt_argv(C.write_gpt_strategy(str(tmp_path), fsdp)),
                                      mode="train")
        _, cfg = model_config_from_args(args)
        assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.ffn_hidden, cfg.vocab_size,
                cfg.max_seq_len, cfg.tie_embeddings) == (8, 4096, 32, 16384, 50257, 2048, True)
        hp = hp_config_from_args(args, cfg.num_layers, 1)
        assert [hp.dp_type(i) for i in range(8)] == \
            ["zero3" if (fsdp and f) else "zero2" for f in C.GPT_FSDP]
        assert [s.remat_policy for s in hp.layers] == C.REMAT_POLICY
        assert strategy_lint.lint_hp(hp, model_cfg=cfg, mode="train").diagnostics == []
    # the 4-GPU strategy: every layout of the slice, refused by nothing; its
    # re-layouts are GLS102 warnings
    args = T.initialize_galvatron(argv=C.gpt_argv(C.write_gpt_world4_strategy(str(tmp_path))),
                                  mode="train")
    _, cfg = model_config_from_args(args)
    hp = hp_config_from_args(args, cfg.num_layers, 4)
    assert [s.tp for s in hp.layers] == C.GPT_WORLD4_TP
    report = strategy_lint.lint_hp(hp, model_cfg=cfg, mode="train")
    assert report.ok and {d.code for d in report.diagnostics} == {"GLS102"}
    from galvatron_tpu_torch.runtime.model_api import check_layout

    check_layout(hp)


if __name__ == "__main__":
    # a torchrun rank of the two-rank test: the train CLI with fp32 compute
    import sys

    T.model_config_from_args = fp32_compute(T.model_config_from_args)
    T.main(sys.argv[1:])
