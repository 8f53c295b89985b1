"""The train loop's timing on the CPU (``profiler/runtime.py``): a step's
period runs from the previous step's end to its own, so time between steps
(a data wait) counts in the period, the throughput and the MFU, and not in
the device time; work inside ``boundary()`` (eval, checkpoint) counts in
neither."""

import time

import pytest

from galvatron_tpu_torch.profiler.runtime import RuntimeProfiler

WAIT_S, STEP_S, BOUNDARY_S = 0.03, 0.01, 0.2


def _steps(prof, its, boundary_before=None):
    for it in its:
        if it == boundary_before:
            with prof.boundary():
                time.sleep(BOUNDARY_S)
        time.sleep(WAIT_S)  # the host makes the batch: the device idles
        prof.start(it)
        time.sleep(STEP_S)
        prof.dispatched(it)
        prof.end(it, n_samples=4)


def test_period_counts_the_wait_between_steps_and_device_time_does_not():
    prof = RuntimeProfiler(warmup=1, model_flops=1e9, peak_flops=1e12)
    _steps(prof, range(4))
    prof.loop_fence()
    s = prof.summary()
    assert s["iters"] == 3
    assert s["steady_step_ms"] >= (WAIT_S + STEP_S) * 1e3
    assert STEP_S * 1e3 <= s["device_step_ms"] < s["steady_step_ms"] - WAIT_S * 1e3 / 2
    total_s = sum(prof.iter_times_ms) / 1e3
    assert s["samples_per_s"] == pytest.approx(12 / total_s)
    assert s["samples_per_s"] <= 4 / (WAIT_S + STEP_S)
    assert s["mfu"] == pytest.approx(1e9 / (s["avg_iter_ms"] / 1e3) / 1e12)
    # the fenced loop wall runs from the last warmup step's end: the three
    # periods and nothing else
    assert s["loop_wall_ms"] == pytest.approx(sum(prof.iter_times_ms), rel=0.05)


def test_boundary_work_is_left_out_of_the_next_period():
    prof = RuntimeProfiler(warmup=0)
    _steps(prof, range(4), boundary_before=2)
    prof.loop_fence()
    periods = prof.iter_times_ms
    assert min(periods[1:]) >= (WAIT_S + STEP_S) * 1e3
    assert periods[2] < (BOUNDARY_S + WAIT_S) * 1e3
    # the loop's wall keeps it (eval and checkpoints included)
    assert prof.summary()["loop_wall_ms"] >= sum(periods[1:]) + BOUNDARY_S * 1e3
