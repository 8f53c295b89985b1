"""The port's resilience layer (``galvatron_tpu_torch/runtime/resilience.py``)
and its wiring in the train loop, on the CPU: the unit and train-loop cases of
the reference's tests/runtime/test_resilience.py — the anomaly guard, retry
with backoff, the preemption flag, a NaN batch skipped with the state
bitwise unchanged, the spike cap inside the step, strike rollback, a
rollback with no checkpoint raising, the emergency save on SIGTERM and its
resume, a transient save failure retried, keep_latest_k and the summary's
counters — plus the telemetry the train loop emits. Tests that send signals or
start threads carry their own time limit."""

import json
import math
import os
import signal

import numpy as np
import pytest
import torch

from galvatron_tpu_torch.cli import train as T
from galvatron_tpu_torch.obs import telemetry
from galvatron_tpu_torch.runtime import checkpoint as ck
from galvatron_tpu_torch.runtime import resilience as rsl
from tests.test_torch_prefetch import time_limit

TINY = [
    "--model_type", "llama", "--set_model_config_manually", "1",
    "--hidden_size", "32", "--num_attention_heads", "2", "--num_layers", "2",
    "--vocab_size", "64", "--seq_length", "16", "--mixed_precision", "fp32",
    "--global_train_batch_size", "8", "--lr", "1e-2", "--device", "cpu",
    "--log_interval", "100",
]


def run(extra, hooks=None, base=TINY):
    args = T.initialize_galvatron(argv=base + extra, mode="train")
    args.fault_hooks = hooks
    return T.train(args)


def _poison(batch, fill):
    return {k: torch.full_like(v, fill) if v.is_floating_point() else v for k, v in batch.items()}


def nan_batch_hooks(steps, wrap_step_fn=None):
    """FaultHooks yielding an all-NaN batch (float fields) at the given
    absolute stream steps (a stream rebuilt with a reseed offset escapes)."""
    poisoned = set(steps)

    def wrap(it, start_step):
        for i, batch in enumerate(it):
            yield _poison(batch, float("nan")) if start_step + i in poisoned else batch

    return rsl.FaultHooks(wrap_data_iter=wrap, wrap_step_fn=wrap_step_fn)


def sigterm_hooks(at_step):
    def on_step(it):
        if it == at_step:
            os.kill(os.getpid(), signal.SIGTERM)
    return rsl.FaultHooks(on_step=on_step)


# ------------------------------------------------------------------ unit level
def test_anomaly_guard_nan_and_strikes():
    g = rsl.AnomalyGuard(rsl.AnomalyGuardConfig(max_strikes=2))
    assert g.observe(1.0) == "ok"
    assert g.observe(float("nan")) == "nan" and not g.should_roll_back
    assert g.observe(float("inf")) == "nan" and g.should_roll_back
    assert g.observe(0.9) == "ok" and g.strikes == 0
    g.reset_after_rollback()
    assert g.ema is None and g.accepted == 0


def test_anomaly_guard_spike_arms_after_history():
    g = rsl.AnomalyGuard(rsl.AnomalyGuardConfig(spike_factor=3.0, min_history=3))
    assert g.spike_cap() == float("inf")
    for x in (1.0, 1.1, 0.9):
        assert g.observe(x) == "ok"
    cap = g.spike_cap()
    assert np.isfinite(cap) and 2.0 < cap < 4.0
    assert g.observe(cap * 1.5) == "spike"
    assert g.observe(1.0) == "ok"


def _flaky(n_fail):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= n_fail:
            raise OSError("transient")
        return "done"
    return fn, calls


def test_with_retry_backs_off_then_succeeds():
    counters, delays = rsl.ResilienceCounters(), []
    fn, _ = _flaky(2)
    out = rsl.with_retry(fn, rsl.RetryPolicy(retries=3, base_delay_s=0.1, multiplier=2.0,
                                             jitter=False), counters, sleep=delays.append)
    assert out == "done" and delays == [0.1, 0.2]
    assert (counters.retries, counters.retries_succeeded, counters.retries_exhausted) == (2, 1, 0)


def test_with_retry_full_jitter_scales_backoff():
    delays = []
    fn, _ = _flaky(2)
    rsl.with_retry(fn, rsl.RetryPolicy(retries=3, base_delay_s=1.0, multiplier=2.0),
                   sleep=delays.append, rng=lambda: 0.5)
    assert delays == [0.5, 1.0]


def test_with_retry_total_elapsed_cap():
    counters, clock, slept = rsl.ResilienceCounters(), {"t": 0.0}, []

    def sleep(d):
        slept.append(d)
        clock["t"] += d

    with pytest.raises(OSError, match="always"):
        rsl.with_retry(lambda: (_ for _ in ()).throw(OSError("always")),
                       rsl.RetryPolicy(retries=10, base_delay_s=2.0, multiplier=1.0,
                                       jitter=False, max_elapsed_s=5.0),
                       counters, sleep=sleep, clock=lambda: clock["t"])
    assert slept == [2.0, 2.0]
    assert (counters.retries, counters.retries_exhausted, counters.retries_succeeded) == (2, 1, 0)


def test_with_retry_exhausts_and_propagates():
    counters = rsl.ResilienceCounters()
    with pytest.raises(OSError):
        rsl.with_retry(lambda: (_ for _ in ()).throw(OSError("always")),
                       rsl.RetryPolicy(retries=2, base_delay_s=0.0), counters,
                       sleep=lambda _: None)
    assert counters.retries_exhausted == 1 and counters.retries_succeeded == 0
    calls = {"n": 0}

    def bad():
        calls["n"] += 1
        raise ValueError("logic bug")

    with pytest.raises(ValueError):
        rsl.with_retry(bad, rsl.RetryPolicy(retries=5, base_delay_s=0.0), sleep=lambda _: None)
    assert calls["n"] == 1


@time_limit(20)
def test_preemption_handler_flags_sigterm():
    h = rsl.PreemptionHandler().install()
    try:
        assert not h.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.triggered and h.signal_name == "SIGTERM"
    finally:
        h.uninstall()


# ------------------------------------------------------------------ step level
def _snapshot(params, state):
    # one stage: its module and Adam state
    params, state = params[0], state[0]
    out = {"p/" + n: p.detach().clone() for n, p in params.named_parameters()}
    out.update({"mu/" + n: t.clone() for n, t in state.mu.items()})
    out.update({"nu/" + n: t.clone() for n, t in state.nu.items()})
    return out, state.count


@pytest.mark.parametrize("dp_type", ["ddp", "zero2"])
def test_spike_cap_and_nan_gate_the_update_inside_the_step(dp_type):
    """A step whose loss is over the cap, or non-finite, returns params,
    both moments, the ZeRO-2 shards and the Adam count bitwise as they
    were and flags metrics["anomalous"]; under the cap it applies."""
    from galvatron_tpu_torch.runtime import distributed
    from galvatron_tpu_torch.runtime.dataloader import get_train_iterator

    args = T.initialize_galvatron(argv=TINY + ["--lr_decay_style", "constant",
                                               "--default_dp_type", dp_type], mode="train")
    with distributed.process_group("cpu") as dev:
        r = T.build(args, dev)
        step = r.model.make_train_step(r.tx, guard_anomalies=True)
        batch = next(get_train_iterator(r.hp, r.cfg.vocab_size, r.cfg.max_seq_len))
        params, state = r.params, r.opt_state
        for cap, b in ((0.01, batch), (float("inf"), _poison(batch, float("nan")))):
            before, count = _snapshot(params, state)
            params, state, m = step(params, state, b, cap)
            assert m["anomalous"] is True
            after, count_after = _snapshot(params, state)
            assert count_after == count == 0
            for n in before:
                assert torch.equal(before[n], after[n]), n
            assert all(p.grad is None for p in params[0].parameters())
        params, state, m = step(params, state, batch, float("inf"))
        assert m["anomalous"] is False and state[0].count == 1
        after, _ = _snapshot(params, state)
        assert max(float((after[n] - before[n]).abs().max()) for n in before) > 0


# ------------------------------------------------------------ train loop level
def test_nan_batch_skipped_without_corrupting_state():
    seen = {}

    def check_step(fn):
        def step(params, state, batch, *rest):
            before, count = _snapshot(params, state)
            params, state, m = fn(params, state, batch, *rest)
            if m["anomalous"]:
                after, count_after = _snapshot(params, state)
                seen["unchanged"] = count == count_after and all(
                    torch.equal(before[n], after[n]) for n in before)
            return params, state, m
        return step

    s = run(["--train_iters", "4"], hooks=nan_batch_hooks([1], check_step))
    assert s["resilience"]["anomalies_skipped"] == 1 and s["resilience"]["rollbacks"] == 0
    assert seen["unchanged"] is True
    assert len(s["losses"]) == 3 and s["loss_iters"] == [0, 2, 3]
    assert np.isfinite(s["losses"]).all()
    assert s["losses"][0] == run(["--train_iters", "4"])["losses"][0]


def test_loss_spike_skipped_end_to_end():
    s = run(["--train_iters", "8", "--loss_spike_factor", "1.0005",
             "--anomaly_min_history", "2", "--anomaly_max_strikes", "100"])
    assert s["resilience"]["anomalies_skipped"] >= 1 and s["resilience"]["rollbacks"] == 0
    assert len(s["losses"]) == 8 - s["resilience"]["anomalies_skipped"]


def test_strike_rollback_recovers(tmp_path):
    d = str(tmp_path / "ck")
    s = run(["--train_iters", "7", "--save", d, "--save_interval", "2",
             "--anomaly_max_strikes", "3", "--anomaly_reseed", "1000"],
            hooks=nan_batch_hooks([3, 4, 5]))
    assert s["resilience"]["anomalies_skipped"] == 3 and s["resilience"]["rollbacks"] == 1
    # accepted: 0, 1, 2; the save at 4 holds the state after the skipped
    # step 3; rolled back to it, the offset stream runs 4, 5, 6 again
    assert s["loss_iters"] == [0, 1, 2, 4, 5, 6]
    assert np.isfinite(s["losses"]).all()


def test_rollback_without_checkpoint_raises():
    with pytest.raises(rsl.TrainingAnomalyError, match="no checkpoints"):
        run(["--train_iters", "6", "--anomaly_max_strikes", "2"],
            hooks=nan_batch_hooks([1, 2, 3, 4]))


def test_rollback_budget_exhausted_raises(tmp_path):
    d = str(tmp_path / "ck")
    with pytest.raises(rsl.TrainingAnomalyError, match="1 rollbacks used"):
        run(["--train_iters", "8", "--save", d, "--save_interval", "1",
             "--anomaly_max_strikes", "1", "--anomaly_max_rollbacks", "1"],
            hooks=nan_batch_hooks([2, 3, 4, 5, 6]))


@time_limit(120)
def test_emergency_save_on_sigterm_and_resume(tmp_path):
    """SIGTERM at a step boundary: an emergency checkpoint, a clean return,
    and a resume that reproduces the uninterrupted run bit for bit."""
    d = str(tmp_path / "ck")
    s = run(["--train_iters", "5", "--save", d], hooks=sigterm_hooks(2))
    assert s["interrupted"] == "SIGTERM" and s["resilience"]["emergency_saves"] == 1
    assert len(s["losses"]) == 2 and ck.intact_iterations(d) == [2]
    meta = ck.read_manifest(d, 2)
    assert meta is not None and meta["iteration"] == 2
    with open(os.path.join(d, "2", "train_meta.json")) as f:
        assert json.load(f) == {"iteration": 2, "emergency": True, "signal": "SIGTERM"}
    clean = run(["--train_iters", "5"])
    resumed = run(["--train_iters", "5", "--load", d])
    assert resumed["losses"] == clean["losses"][2:] and s["losses"] == clean["losses"][:2]


def test_deterministic_resume_bit_for_bit(tmp_path):
    d = str(tmp_path / "ck")
    sched = ["--lr_decay_style", "constant"]
    full = run(["--train_iters", "6"] + sched)
    first = run(["--train_iters", "3", "--save", d] + sched)
    assert first["losses"] == full["losses"][:3]
    resumed = run(["--train_iters", "6", "--load", d] + sched)
    assert resumed["losses"] == full["losses"][3:]
    assert resumed["checkpoint_restore"]["iteration"] == 3


@pytest.mark.parametrize("loop", [["--no_async_loop"], ["--prefetch_batches", "0"],
                                  ["--inflight_steps", "0"], ["--prefetch_batches", "3",
                                                              "--inflight_steps", "4"]])
def test_async_loop_knobs_leave_losses_bitwise(loop):
    base = run(["--train_iters", "5"])
    other = run(["--train_iters", "5"] + loop)
    assert other["losses"] == base["losses"]


def test_transient_save_failure_retried(tmp_path):
    d = str(tmp_path / "ck")
    orig, calls = ck._write_rank_file, {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("injected transient failure")
        return orig(*a, **kw)

    ck._write_rank_file = flaky
    try:
        s = run(["--train_iters", "2", "--save", d, "--ckpt_retry_backoff", "0.01"])
    finally:
        ck._write_rank_file = orig
    assert s["resilience"]["retries"] >= 1 and ck.intact_iterations(d) == [2]


def test_keep_latest_k_retention(tmp_path):
    d = str(tmp_path / "ck")
    run(["--train_iters", "6", "--save", d, "--save_interval", "1", "--keep_latest_k", "2"])
    assert ck.intact_iterations(d) == [5, 6]


def test_summary_reports_resilience_counters():
    s = run(["--train_iters", "2"])
    assert s["resilience"] == {
        "anomalies_skipped": 0, "rollbacks": 0, "retries": 0,
        "retries_succeeded": 0, "retries_exhausted": 0,
        "emergency_saves": 0, "torn_checkpoints_skipped": 0,
        "sdc_checks": 0, "sdc_mismatches": 0, "sdc_reexecutions": 0,
        "sdc_quarantines": 0,
    }


def test_donate_step_zero_is_refused():
    with pytest.raises(SystemExit):
        T.initialize_galvatron(argv=TINY + ["--donate_step", "0"], mode="train")


@time_limit(120)
def test_telemetry_stream_of_a_resumed_run_with_an_anomaly(tmp_path):
    """--telemetry writes the reference train loop's events, valid under the
    shared schema: run_start, step, eval, checkpoint_save, anomaly_skip,
    rollback, preemption, run_end."""
    d, path = str(tmp_path / "ck"), str(tmp_path / "t.jsonl")
    run(["--train_iters", "7", "--save", d, "--save_interval", "2", "--eval_interval", "3",
         "--eval_iters", "1", "--anomaly_max_strikes", "2", "--anomaly_reseed", "100",
         "--telemetry", path], hooks=nan_batch_hooks([3, 4]))
    events, errors = telemetry.read_events(path)
    assert errors == []
    types = [e["type"] for e in events]
    for t in ("run_start", "step", "eval", "checkpoint_save", "anomaly_skip", "rollback",
              "checkpoint_restore", "run_end"):
        assert t in types, t
    rb = next(e for e in events if e["type"] == "rollback")
    assert rb["to_iter"] == 4 and rb["stream_offset"] == 100
    steps = [e for e in events if e["type"] == "step"]
    assert all(math.isfinite(e["iter_ms"]) for e in steps)
    path2 = str(tmp_path / "t2.jsonl")
    run(["--train_iters", "5", "--save", d, "--telemetry", path2], hooks=sigterm_hooks(1))
    types = [e["type"] for e in telemetry.read_events(path2)[0]]
    assert "preemption" in types and types[-1] == "run_end"


def test_empty_eval_split_fails_before_training(tmp_path):
    from galvatron_tpu_torch.data.dataset import write_indexed_dataset

    rng = np.random.RandomState(0)
    corpus = str(tmp_path / "c")
    write_indexed_dataset(corpus, [rng.randint(0, 64, 40).tolist() for _ in range(20)])
    steps = []
    with pytest.raises(ValueError, match="empty document subset"):
        run(["--train_iters", "3", "--data_path", corpus, "--split", "95,5,0",
             "--eval_interval", "1"], hooks=rsl.FaultHooks(on_step=steps.append))
    assert steps == []


def test_save_profiled_memory_puts_snapshots_in_the_summary():
    s = run(["--train_iters", "3", "--save_profiled_memory", "1"])
    snaps = s["memory_snapshots"]
    assert sorted(snaps) == ["iter_0_after_step", "iter_3_end"]
    assert set(snaps["iter_3_end"]) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
