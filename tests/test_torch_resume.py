"""The slice as a whole against the JAX package, on the CPU: a tiny LLaMA
trained 20 steps by each package's train loop from one indexed corpus
(``--data_path``) with a valid-split eval every 5 steps and a final test
eval. The JAX package's initial weights are carried to the port with
``tools/from_jax.py`` and both compute in fp32 (set in-process, as
tests/test_torch_train_cli.py does), so train and eval losses agree within
1e-5 (the tolerance of tests/test_torch_train.py). On the port, a run preempted at step 10
(SIGTERM -> emergency save) and resumed equals the uninterrupted run bit for
bit, and its losses match the JAX package's within 1e-5; a strike rollback
lands on the JAX train loop's iteration with its losses; ``cli serve --load``
serves the trained checkpoint."""

import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galvatron_tpu.cli import arguments as JA
from galvatron_tpu.cli import train as JT
from galvatron_tpu.obs import telemetry as JTEL
from galvatron_tpu.runtime import model_api as JAPI
from galvatron_tpu.runtime import resilience as JRSL
from galvatron_tpu_torch.cli import serve as TS
from galvatron_tpu_torch.cli import train as T
from galvatron_tpu_torch.data.dataset import write_indexed_dataset
from galvatron_tpu_torch.obs import telemetry as TTEL
from galvatron_tpu_torch.runtime import checkpoint as ck
from galvatron_tpu_torch.runtime import model_api as TAPI
from galvatron_tpu_torch.runtime import resilience as TRSL
from galvatron_tpu_torch.tools.from_jax import params_from_numpy
from tests.test_torch_prefetch import time_limit
from tests.test_torch_resilience import nan_batch_hooks

TOL = 1e-5
MODEL = [
    "--model_type", "llama", "--set_model_config_manually", "1",
    "--hidden_size", "32", "--num_attention_heads", "2", "--num_layers", "2",
    "--ffn_hidden_size", "64", "--vocab_size", "64", "--seq_length", "16",
    "--global_train_batch_size", "4", "--chunks", "2", "--lr", "1e-3",
    "--log_interval", "100", "--seed", "7",
]
STEPS = 20


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.RandomState(3)
    path = str(tmp_path_factory.mktemp("corpus") / "docs")
    write_indexed_dataset(path, [rng.randint(0, 64, rng.randint(10, 120)).tolist()
                                 for _ in range(300)])
    return path


@pytest.fixture
def fp32_drivers(monkeypatch):
    """Both train loops compute in fp32; the port starts from the JAX package's
    initial weights (what its train loop draws from PRNGKey(seed))."""
    jresolve = JT.model_config_from_args

    def jfp32(args):
        fam, cfg = jresolve(args)
        return fam, dataclasses.replace(cfg, compute_dtype=jnp.float32)

    tresolve = T.model_config_from_args

    def tfp32(args):
        fam, cfg = tresolve(args)
        return fam, dataclasses.replace(cfg, compute_dtype=torch.float32)

    monkeypatch.setattr(JT, "model_config_from_args", jfp32)
    monkeypatch.setattr(T, "model_config_from_args", tfp32)

    def jax_init(argv):
        args = JA.initialize_galvatron(mode="train_dist", argv=argv)
        _, cfg = jfp32(args)
        hp = JA.hp_config_from_args(args, cfg.num_layers, 1)
        model = JAPI.construct_hybrid_parallel_model(cfg, hp)
        return jax.device_get(model.init_params(jax.random.PRNGKey(args.seed)))

    full = params_from_numpy(jax_init(MODEL + ["--world_size", "1"]))
    monkeypatch.setattr(TAPI.HybridParallelModel, "init_params",
                        lambda self, seed: self.shard_params(full))


def jax_run(extra, hooks=None):
    args = JA.initialize_galvatron(mode="train_dist", argv=MODEL + ["--world_size", "1"] + extra)
    if hooks is not None:
        args.fault_hooks = hooks
    sink = JTEL.MemorySink()
    JTEL.install(sink)
    try:
        s = JT.train(args)
    finally:
        JTEL.uninstall(sink)
    return s, sink.events


def port_run(extra, hooks=None):
    args = T.initialize_galvatron(argv=MODEL + ["--device", "cpu"] + extra, mode="train")
    args.fault_hooks = hooks
    sink = TTEL.MemorySink()
    TTEL.install(sink)
    try:
        s = T.train(args)
    finally:
        TTEL.uninstall(sink)
    return s, sink.events


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a, b)
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()


@pytest.fixture
def reference(corpus, fp32_drivers):
    data = ["--data_path", corpus, "--split", "80,10,10", "--eval_interval", "5",
            "--eval_iters", "2", "--train_iters", str(STEPS)]
    return jax_run(data)[0], data


def test_corpus_train_and_eval_losses_match_jax_driver(reference):
    jsum, data = reference
    tsum, events = port_run(data)
    assert len(tsum["losses"]) == len(jsum["losses"]) == STEPS
    _close(tsum["losses"], jsum["losses"])
    assert [i for i, _ in tsum["valid_losses"]] == [i for i, _ in jsum["valid_losses"]] \
        == [5, 10, 15, 20]
    _close([v for _, v in tsum["valid_losses"]], [v for _, v in jsum["valid_losses"]])
    _close(tsum["test_loss"], jsum["test_loss"])
    evals = [e for e in events if e["type"] == "eval"]
    assert [e["split"] for e in evals] == ["valid"] * 4 + ["test"]


@time_limit(300)
def test_preempted_resume_is_bitwise_and_matches_jax_driver(reference, tmp_path):
    jsum, data = reference
    full, _ = port_run(data)
    d = str(tmp_path / "ck")

    def on_step(it):
        if it == 10:
            os.kill(os.getpid(), signal.SIGTERM)

    first, _ = port_run(data + ["--save", d], TRSL.FaultHooks(on_step=on_step))
    assert first["interrupted"] == "SIGTERM" and ck.intact_iterations(d) == [10]
    resumed, events = port_run(data + ["--load", d])
    assert first["losses"] + resumed["losses"] == full["losses"]
    assert resumed["valid_losses"] == full["valid_losses"][2:]
    assert resumed["test_loss"] == full["test_loss"]
    _close(resumed["losses"], jsum["losses"][10:])
    start = next(e for e in events if e["type"] == "run_start")
    assert start["start_iter"] == 10 and start["resumed_from"] == d


def _jax_nan_hooks(steps):
    def wrap(it, start):
        for i, b in enumerate(it):
            yield {k: np.full_like(np.asarray(v), np.nan)
                   if np.issubdtype(np.asarray(v).dtype, np.floating) else v
                   for k, v in b.items()} if start + i in steps else b
    return JRSL.FaultHooks(wrap_data_iter=wrap)


def test_strike_rollback_lands_where_the_jax_driver_does(fp32_drivers, tmp_path):
    """Synthetic stream (its loss mask is a float field a NaN poisons):
    three NaN batches, checkpoints every 2 steps, a reseeded stream."""
    flags = ["--train_iters", "7", "--save_interval", "2", "--anomaly_max_strikes", "3",
             "--anomaly_reseed", "1000"]
    jsum, jev = jax_run(flags + ["--save", str(tmp_path / "j")], _jax_nan_hooks({3, 4, 5}))
    tsum, tev = port_run(flags + ["--save", str(tmp_path / "t")], nan_batch_hooks({3, 4, 5}))
    jrb = [(e["to_iter"], e["at_iter"], e["stream_offset"]) for e in jev if e["type"] == "rollback"]
    trb = [(e["to_iter"], e["at_iter"], e["stream_offset"]) for e in tev if e["type"] == "rollback"]
    assert trb == jrb == [(4, 5, 1000)]
    assert tsum["resilience"]["anomalies_skipped"] == jsum["resilience"]["anomalies_skipped"] == 3
    _close(tsum["losses"], jsum["losses"])


def test_serve_load_serves_the_trained_checkpoint(reference, tmp_path, capsys):
    _, data = reference
    d = str(tmp_path / "ck")
    port_run(data[:-2] + ["--train_iters", "4", "--save", d])
    summary = TS.main(MODEL[:-8] + ["--device", "cpu", "--num_requests", "3",
                                    "--prompt_len_min", "4", "--prompt_len_max", "10",
                                    "--max_new_tokens", "3", "--load", d])
    assert summary["requests"] == 3
    assert "restored %s at iteration 4" % d in capsys.readouterr().out
