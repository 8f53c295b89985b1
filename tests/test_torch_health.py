"""The port's watchdog and mesh probe (``galvatron_tpu_torch/runtime/health.py``)
against the JAX package's (``galvatron_tpu/runtime/health.py``): the
reference's unit cases (tests/runtime/test_health.py) driven on both with
the same inputs and one injected clock, each step's decision compared;
then what only the port has (a probe over a process group, quarantined
ranks, the pump's hard exit) and the process-level contract through the
port's fault harness (tests/torch_fault_injection.py): an injected hang
under ``--watchdog`` exits 3 after an emergency save and a second run
resumes from it; a stalled decode tick drains ``cli serve`` and exits 3,
SIGTERM drains it and exits 0."""

import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from galvatron_tpu.runtime import health as JH
from galvatron_tpu_torch.obs import telemetry as TT
from galvatron_tpu_torch.runtime import health as TH
from tests import torch_fault_injection as FI

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = (JH, TH)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def make_wd(H, clock, **cfg_kw):
    cfg_kw.setdefault("floor_s", 1.0)
    cfg_kw.setdefault("factor", 2.0)
    cfg_kw.setdefault("min_history", 3)
    cfg_kw.setdefault("startup_deadline_s", 100.0)
    return H.Watchdog(H.WatchdogConfig(**cfg_kw), time_fn=clock)


# each scenario drives one watchdog through a script on an injected clock
# and returns its trace: every decision and the state the driver reads
def _deadline_learning(H):
    wd = make_wd(H, FakeClock())
    out = [wd.deadline_s()]
    for ms in (500.0, 1000.0, 1500.0):
        wd.observe_step_time(ms)
        out.append(wd.deadline_s())
    return out


def _deadline_median(H):
    wd = make_wd(H, FakeClock())
    for ms in (100.0, 100.0, 100.0, 100.0, 60000.0):
        wd.observe_step_time(ms)
    return [wd.deadline_s()]


def _ladder(H):
    clock = FakeClock()
    wd = make_wd(H, clock, startup_deadline_s=10.0)
    wd.arm(0, "fetch")
    out = [wd.check(clock.advance(dt)) for dt in (9.0, 2.0, 9.0, 2.0, 100.0)]
    s = wd.summary()
    return out + [wd.fires, wd.escalated, wd.abort_requested, s["escalated"],
                  [e["action"] for e in s["events"]]]


def _progress(H):
    clock = FakeClock()
    wd = make_wd(H, clock, startup_deadline_s=10.0)
    wd.arm(3, "inflight", inflight=2)
    out = [wd.check(clock.advance(11.0))]
    wd.progress(drained_iteration=3, inflight=1)
    out += [wd.check(clock.advance(9.0)), wd.check(clock.advance(2.0)), wd.fires]
    return out + [wd.diagnostics(include_stacks=False)["last_drained"]]


def _disarm(H):
    clock = FakeClock()
    wd = make_wd(H, clock, startup_deadline_s=10.0)
    wd.arm(0)
    wd.disarm()
    out = [wd.check(clock.advance(1000.0))]
    wd.arm(1)
    return out + [wd.check(clock.advance(11.0))]


def _retry_once(H):
    clock = FakeClock()
    wd = make_wd(H, clock, startup_deadline_s=10.0)
    wd.arm(0)
    wd.check(clock.advance(11.0))
    return [wd.take_retry_request(), wd.take_retry_request()]


def _arm_restarts(H):
    clock = FakeClock()
    wd = make_wd(H, clock, startup_deadline_s=10.0)
    wd.arm(0)
    clock.advance(9.0)
    wd.arm(1)
    return [wd.check(clock.advance(9.0)), wd.check(clock.advance(2.0))]


SCENARIOS = {
    "deadline_learning": (_deadline_learning, [100.0, 100.0, 100.0, 3.0]),
    "deadline_median": (_deadline_median, [2.0 * 0.1 + 1.0]),
    "fire_then_escalate": (_ladder, [None, "fire", None, "escalate", None, 1, True, True,
                                     True, ["fire", "escalate"]]),
    "progress_resets": (_progress, ["fire", None, "fire", 2, 3]),
    "disarm_rearm": (_disarm, [None, "fire"]),
    "retry_consumed_once": (_retry_once, [True, False]),
    "arm_restarts_interval": (_arm_restarts, [None, "fire"]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_watchdog_decisions_match_the_reference(name):
    fn, want = SCENARIOS[name]
    got_ref, got = fn(JH), fn(TH)
    assert got == got_ref
    assert got == pytest.approx(want) if all(isinstance(w, float) for w in want) else \
        got == want


def test_fire_emits_a_schema_valid_watchdog_event_with_stacks():
    sink = TT.MemorySink()
    TT.install(sink)
    try:
        clock = FakeClock()
        wd = make_wd(TH, clock, startup_deadline_s=10.0)
        wd.observe_step_time(100.0)
        wd.arm(7, "inflight", inflight=2)
        wd.check(clock.advance(11.0))
    finally:
        TT.uninstall(sink)
    events = [e for e in sink.events if e["type"] == "watchdog"]
    assert len(events) == 1
    ev = events[0]
    assert ev["action"] == "fire" and ev["iter"] == 7 and ev["phase"] == "inflight"
    assert ev["inflight_depth"] == 2 and ev["deadline_s"] == 10.0
    assert "test_torch_health" in ev["stacks"] or "Thread" in ev["stacks"]


def test_monitor_thread_fires_in_real_time():
    fired = threading.Event()
    wd = TH.Watchdog(TH.WatchdogConfig(startup_deadline_s=0.05, poll_interval_s=0.01,
                                       min_history=99),
                     on_fire=lambda diag: fired.set())
    with wd:
        wd.arm(0, "fetch")
        assert fired.wait(timeout=5.0)
    assert wd.fires == 1 and wd.retry_requested


def test_hard_exit_is_due_only_for_an_escalation_left_armed():
    """The pump's last resort (the port's divergence): an escalation the
    driver never takes up (still armed) is due for the hard exit after
    HARD_EXIT_GRACE deadlines plus HARD_EXIT_FLOOR_S; a disarmed one never."""
    clock = FakeClock()
    wd = make_wd(TH, clock, startup_deadline_s=10.0)
    wd.arm(0)
    assert wd.check(clock.advance(11.0)) == "fire"
    assert wd.check(clock.advance(11.0)) == "escalate"
    due_after = TH.HARD_EXIT_GRACE * wd.deadline_s() + TH.HARD_EXIT_FLOOR_S
    assert due_after == 80.0  # 2 x 10 + 60
    assert not wd.hard_exit_due(clock.advance(due_after - 1.0))
    assert wd.hard_exit_due(clock.advance(2.0))
    wd.disarm()  # the driver took the escalation up
    assert not wd.hard_exit_due(clock.advance(100.0))


# --------------------------------------------------------------- mesh health
class _Dev:
    def __init__(self, i):
        self.id = i


@pytest.mark.parametrize("expected,live", [
    ([0, 1, 2, 3], [0, 1, 2, 3]), ([0, 1, 2, 3], [0, 2]), ([0, 1], [0, 1, 2, 3]),
])
def test_classify_world_matches_the_reference(expected, live):
    got = TH.classify_world(expected, [_Dev(i) for i in live])
    assert got == JH.classify_world(expected, [_Dev(i) for i in live])
    assert TH.classify_world(expected, live) == got  # ranks count as ids


def test_mesh_monitor_interval_and_simulated_rank_loss_match_the_reference():
    """The reference's monitor case on both packages, one fake clock each:
    the same probe schedule and the same verdicts when half the world
    vanishes from the live list (enumeration only)."""
    traces = []
    for make in (lambda c, f: JH.MeshHealthMonitor(None, interval_s=60.0, devices_fn=f,
                                                   time_fn=c, collective=False,
                                                   expected_ids=[0, 1, 2, 3]),
                 lambda c, f: TH.MeshHealthMonitor(interval_s=60.0, devices_fn=f, time_fn=c,
                                                   collective=False,
                                                   expected_ids=[0, 1, 2, 3])):
        clock = FakeClock()
        live = {"ids": [_Dev(i) for i in range(4)]}
        mon = make(clock, lambda: live["ids"])
        trace = [mon.maybe_probe(), mon.maybe_probe(clock.advance(30.0))]
        v = mon.maybe_probe(clock.advance(31.0))
        trace.append((v["status"], v["live"], v["missing_ids"]))
        live["ids"] = live["ids"][:2]
        trace.append(mon.maybe_probe(clock.advance(10.0)))
        v = mon.maybe_probe(clock.advance(51.0))
        trace.append((v["status"], v["live"], v["missing_ids"]))
        traces.append(trace)
    assert traces[0] == traces[1]
    assert traces[1][-1] == ("degraded", 2, [2, 3])


def test_quarantined_rank_counts_as_missing_and_a_probe_runs_a_collective():
    """Expected ids default to the world's ranks (one here); a probe of a
    healthy world runs the timed all-reduce over the process group; a
    quarantined rank is missing although it is alive."""
    from galvatron_tpu_torch.runtime import distributed

    with distributed.process_group("cpu"):
        mon = TH.MeshHealthMonitor(interval_s=1.0, timeout_s=30.0)
        assert list(mon.expected_ids) == [0]
        v = mon.probe()
        assert v["status"] == "healthy" and v["collective_ok"] is True
        assert v["collective_elapsed_s"] is not None
        q = mon.quarantine([0])
        assert q["status"] == "degraded" and q["missing_ids"] == [0]
        assert q["quarantined_ids"] == [0] and "collective_ok" not in q


def test_due_starts_the_clock_and_probe_reschedules():
    clock = FakeClock()
    mon = TH.MeshHealthMonitor(interval_s=10.0, devices_fn=lambda: [0], time_fn=clock,
                               collective=False, expected_ids=[0])
    assert not mon.due()
    assert not mon.due(clock.advance(9.0))
    assert mon.due(clock.advance(2.0)) and mon.due()  # due until a probe runs
    mon.probe()
    assert not mon.due(clock.advance(1.0))


# ------------------------------------------------------- process contracts
def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _scenario(*argv, timeout=120):
    return subprocess.run([sys.executable, os.path.join(REPO, "tests", "torch_fault_injection.py"),
                           *argv], cwd=REPO, env=_env(), capture_output=True, text=True,
                          timeout=timeout)


def _line(out, key):
    return json.loads(next(x for x in out.splitlines() if x.startswith(key + "="))
                      .split("=", 1)[1])


def test_hang_escalates_to_an_emergency_save_and_exit_3_then_resume_continues(tmp_path):
    """The step call at 5 sleeps 4 s under --watchdog 0.5 (deadline 0.5 s
    + 2 x the median step): the watchdog fires, escalates, the loop takes
    the emergency-save exit at the next boundary and the process exits 3.
    A second run, ``--load --elastic resume``, starts from that save and
    its losses are the uninterrupted run's, bit for bit."""
    ckpt = str(tmp_path / "ckpt")
    proc = _scenario("--scenario", "hang", "--train_iters", "10", "--save", ckpt,
                     "--hang_at", "5", "--hang_s", "4", "--", "--watchdog", "0.5",
                     "--watchdog_factor", "2", "--watchdog_startup_s", "30",
                     "--inflight_steps", "0")
    assert proc.returncode == TH.WATCHDOG_EXIT_CODE, proc.stdout[-3000:] + proc.stderr[-3000:]
    summary = _line(proc.stdout, "SUMMARY")
    assert summary["interrupted"] == "watchdog"
    assert summary["watchdog"]["escalated"] and summary["watchdog"]["fires"] == 1
    assert summary["resilience"]["emergency_saves"] == 1
    hung = _line(proc.stdout, "LOSSES")
    from galvatron_tpu_torch.runtime import checkpoint as ck

    saved = ck.intact_iterations(ckpt)
    assert saved == [len(hung)]  # the emergency save, at the boundary after the hang
    with open(os.path.join(ckpt, str(saved[0]), "train_meta.json")) as f:
        assert json.load(f)["signal"] == "watchdog"
    plain = FI.run_train(FI.tiny_train_argv(10))["losses"]
    resumed = FI.run_train(FI.tiny_train_argv(10, load=ckpt, extra=["--elastic", "resume"]))
    assert hung == plain[:len(hung)]
    assert resumed["checkpoint_restore"]["iteration"] == saved[0]
    assert resumed["losses"] == plain[saved[0]:]


def test_serve_stalled_decode_tick_drains_and_exits_3():
    proc = _scenario("--scenario", "serve_hang", "--hang_at", "4", "--hang_s", "4", "--",
                     "--watchdog", "0.5", "--watchdog_factor", "2",
                     "--watchdog_startup_s", "30")
    assert proc.returncode == TH.WATCHDOG_EXIT_CODE, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = _line(proc.stdout, "SERVE")
    assert out["drain"] == "watchdog" and out["interrupted"] == "watchdog"
    assert out["watchdog"]["escalated"] and out["watchdog"]["fires"] == 1
    assert out["requests"] + out["shed"] == 4


def test_serve_sigterm_drains_gracefully_and_returns():
    """SIGTERM at decode step 3 (in this process, under the serve's own
    handler): admission stops, the admitted requests finish or shed
    retryable, the rest shed retryable, and serve returns (exit 0 from
    the CLI)."""
    out = FI.run_serve(FI.SERVE_ARGV, FI.sigterm_hooks(3))
    assert out["drain"] == "SIGTERM" and out["interrupted"] == "SIGTERM"
    assert out["requests"] + out["shed"] == 4 and out["shed"] >= 1
    assert "watchdog" not in out
