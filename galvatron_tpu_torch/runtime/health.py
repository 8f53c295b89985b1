"""Training watchdog and mesh-health probing: detect a wedged or degraded run.

Port of ``galvatron_tpu/runtime/health.py``. Checkpoints make a run
resumable after hardware trouble; this module is the detection half:

- :class:`Watchdog`: a monitor thread armed around every step (and, in the
  serve engine, every prefill and decode tick). The deadline is learned
  from the run: ``factor * median(steady step time) + floor`` once
  ``min_history`` steps have drained, a generous startup deadline before
  that. A missed deadline escalates in two stages: **fire** (a
  ``watchdog`` telemetry event with the diagnostic dump: in-flight window
  depth, last drained step, every thread's stack through
  :mod:`faulthandler`; the driver drains and retries) and **escalate**
  (the driver makes an emergency save and exits with
  :data:`WATCHDOG_EXIT_CODE`) when a further deadline passes with no
  progress. The decision is the pure :meth:`Watchdog.check`, which tests
  drive with an injected clock; the thread is only a pump.
- :func:`classify_world` / :class:`MeshHealthMonitor`: a periodic probe of
  the world, an enumeration diff of the live ranks against the ranks the
  strategy was planned for plus one timed all-reduce over the run's group,
  classifying it healthy / degraded / grown / wedged. The train driver's
  ``--migrate_on_degrade`` turns a degraded verdict into a live migration
  (``runtime/elastic.migrate``) instead of a crash and a resume.

Where the port differs from the reference (ROADMAP queue 3):

- A rank is a process, not a device of one controller. `devices_fn`
  returns live ranks (the world's ranks by default; tests inject a shrunken
  list to simulate a loss), and a rank that is quarantined or simulated as
  lost is still alive: it hands its shards over in the migration and then
  leaves. A rank that is really gone shows up as a ``wedged`` probe: the
  all-reduce did not complete within ``timeout_s``. The communicator can no
  longer be trusted, so the driver issues no further collective and exits
  with :data:`WATCHDOG_EXIT_CODE`; the run resumes from its last committed
  checkpoint (``--elastic resume``).
- `probe_collective` polls ``work.is_completed()`` of an asynchronous
  all-reduce against its deadline; no helper thread blocks in a
  collective.
- The monitor thread cannot unwedge a call that never returns, but where
  the reference only raises flags, the port's pump ends the process with
  :data:`WATCHDOG_EXIT_CODE` (stacks on stderr) when an escalation is not
  taken up by the driver within :data:`HARD_EXIT_GRACE` deadlines plus
  :data:`HARD_EXIT_FLOOR_S`: a rank stuck in a collective forever still exits
  with the code that says "resume me".
"""

from __future__ import annotations

import faulthandler
import os
import statistics
import sys
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from galvatron_tpu_torch.obs import telemetry

__all__ = [
    "WATCHDOG_EXIT_CODE",
    "Watchdog",
    "WatchdogConfig",
    "classify_world",
    "probe_collective",
    "MeshHealthMonitor",
    "thread_stack_dump",
]

# The driver's exit code when the watchdog escalated and forced the
# emergency-save path: distinct from 0 (clean), 1 (ordinary failure) and 2
# (the GLS2xx elastic-refusal contract), so a supervisor can tell "the run
# wedged and evacuated itself" from "needs operator input".
WATCHDOG_EXIT_CODE = 3


def thread_stack_dump(max_chars: int = 8000) -> str:
    """Every thread's current Python stack, through faulthandler (which
    dumps threads blocked in C calls too: the ones a hang diagnostic is
    about), truncated to keep the telemetry event bounded."""
    try:
        with tempfile.TemporaryFile(mode="w+") as fh:
            faulthandler.dump_traceback(file=fh, all_threads=True)
            fh.seek(0)
            text = fh.read()
    except Exception as e:  # faulthandler needs a real fd
        return "<stack dump unavailable: %s>" % e
    if len(text) > max_chars:
        text = text[:max_chars] + "\n<truncated>"
    return text


# ------------------------------------------------------------------ watchdog
# the pump's last resort (see the module note): an escalation the driver has
# not taken up after HARD_EXIT_GRACE deadlines plus HARD_EXIT_FLOOR_S ends
# the process
HARD_EXIT_GRACE = 2.0
HARD_EXIT_FLOOR_S = 60.0


@dataclass
class WatchdogConfig:
    """Deadline learning and escalation knobs (``--watchdog`` is floor_s,
    ``--watchdog_factor`` factor, ``--watchdog_startup_s``
    startup_deadline_s)."""

    floor_s: float = 30.0  # additive floor under the learned deadline
    factor: float = 4.0  # k in k * median(step time) + floor
    min_history: int = 3  # drained steps before the deadline arms
    startup_deadline_s: float = 600.0  # pre-history deadline (first steps build kernels)
    escalation_grace: float = 1.0  # extra deadlines after fire before escalate
    poll_interval_s: float = 0.25  # monitor-thread cadence
    history: int = 64  # step-time samples kept for the median


class Watchdog:
    """Per-step liveness monitor with a two-stage escalation ladder.

    The driver arms the watchdog at the top of each loop body (batch fetch,
    dispatch and the in-flight window) and reports progress at every
    drain; `disarm()` brackets legitimately slow sections (eval, checkpoint
    saves, migration). The monitor thread calls :meth:`check`; tests call
    it directly with a fake clock.

    Escalation contract (the driver polls the flags at the loop top, where
    params and Adam state are consistent):

    - ``fire`` -> `retry_requested`: drain the in-flight window and go on
      (a transient stall should not kill a multi-day run).
    - ``escalate`` -> `abort_requested`: emergency save and exit with
      :data:`WATCHDOG_EXIT_CODE`.
    """

    def __init__(
        self,
        cfg: Optional[WatchdogConfig] = None,
        time_fn: Callable[[], float] = time.monotonic,
        on_fire: Optional[Callable[[Dict[str, Any]], None]] = None,
        on_escalate: Optional[Callable[[Dict[str, Any]], None]] = None,
    ):
        self.cfg = cfg or WatchdogConfig()
        self._time = time_fn
        self._on_fire = on_fire
        self._on_escalate = on_escalate
        self._lock = threading.Lock()
        self._step_times_ms: deque = deque(maxlen=max(self.cfg.history, 1))
        self._armed = False
        self._armed_at: Optional[float] = None
        self._phase = ""
        self._iteration: Optional[int] = None
        self._inflight_depth = 0
        self._last_drained: Optional[int] = None
        self._fired_at: Optional[float] = None
        self._escalated_at: Optional[float] = None
        self.fires = 0
        self.escalated = False
        self.retry_requested = False
        self.abort_requested = False
        self.events: List[Dict[str, Any]] = []  # local record (summary dict)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- learning
    def observe_step_time(self, ms: float) -> None:
        with self._lock:
            self._step_times_ms.append(float(ms))

    def deadline_s(self) -> float:
        """The current no-progress budget: learned once `min_history`
        steps have drained, the startup deadline before that."""
        with self._lock:
            times = list(self._step_times_ms)
        if len(times) < max(self.cfg.min_history, 1):
            return float(self.cfg.startup_deadline_s)
        med_s = statistics.median(times) / 1e3
        return self.cfg.factor * med_s + self.cfg.floor_s

    # ------------------------------------------------------------ arm/disarm
    def arm(self, iteration: int, phase: str = "step", inflight: int = 0) -> None:
        """Start (or refresh) the armed interval: the deadline clock runs
        from now. Called at the top of each loop body and after dispatch."""
        now = self._time()
        with self._lock:
            self._armed = True
            self._armed_at = now
            self._phase = phase
            self._iteration = int(iteration)
            self._inflight_depth = int(inflight)
            self._fired_at = None  # a new interval: the ladder restarts

    def progress(self, drained_iteration: Optional[int] = None,
                 inflight: Optional[int] = None) -> None:
        """Report liveness: refreshes the deadline clock and clears a
        pending fire (the run recovered on its own)."""
        now = self._time()
        with self._lock:
            if drained_iteration is not None:
                self._last_drained = int(drained_iteration)
            if inflight is not None:
                self._inflight_depth = int(inflight)
            if self._armed:
                self._armed_at = now
                self._fired_at = None

    def disarm(self) -> None:
        """Suspend monitoring (eval passes, checkpoint saves, migration:
        slow by design, with their own containment)."""
        with self._lock:
            self._armed = False
            self._armed_at = None
            self._fired_at = None

    # -------------------------------------------------------------- decision
    def check(self, now: Optional[float] = None) -> Optional[str]:
        """The pure escalation decision: None | "fire" | "escalate".

        fire     - armed, no progress for a full deadline, not yet fired in
                   this interval.
        escalate - fired, and a further `escalation_grace` deadlines passed
                   with still no progress.
        """
        now = self._time() if now is None else now
        deadline = self.deadline_s()
        with self._lock:
            if not self._armed or self._armed_at is None or self.escalated:
                return None
            if self._fired_at is None:
                if now - self._armed_at <= deadline:
                    return None
                self._fired_at = now
                self.fires += 1
                self.retry_requested = True
                action = "fire"
            else:
                if now - self._fired_at <= deadline * max(self.cfg.escalation_grace, 0.0):
                    return None
                self.escalated = True
                self.abort_requested = True
                self._escalated_at = now
                action = "escalate"
            elapsed = now - self._armed_at
        self._report(action, elapsed, deadline)
        return action

    def take_retry_request(self) -> bool:
        """Consume a pending drain-and-retry request (driver loop top)."""
        with self._lock:
            req, self.retry_requested = self.retry_requested, False
            return req

    def hard_exit_due(self, now: Optional[float] = None) -> bool:
        """True when an escalation has gone untaken (still armed) for
        :data:`HARD_EXIT_GRACE` deadlines plus :data:`HARD_EXIT_FLOOR_S`."""
        now = self._time() if now is None else now
        with self._lock:
            if not (self.escalated and self._armed and self._escalated_at is not None):
                return False
            since = now - self._escalated_at
        return since > HARD_EXIT_GRACE * self.deadline_s() + HARD_EXIT_FLOOR_S

    # ------------------------------------------------------------ diagnostics
    def diagnostics(self, include_stacks: bool = True) -> Dict[str, Any]:
        with self._lock:
            times = list(self._step_times_ms)
            diag: Dict[str, Any] = {
                "iter": self._iteration,
                "phase": self._phase,
                "inflight_depth": self._inflight_depth,
                "last_drained": self._last_drained,
                "fires": self.fires,
                "steps_observed": len(times),
            }
        if times:
            diag["median_step_ms"] = float(statistics.median(times))
        if include_stacks:
            diag["stacks"] = thread_stack_dump()
        return diag

    def _report(self, action: str, elapsed: float, deadline: float) -> None:
        diag = self.diagnostics()
        diag.update(action=action, elapsed_s=elapsed, deadline_s=deadline)
        self.events.append({k: v for k, v in diag.items() if k != "stacks"})
        telemetry.emit(
            "watchdog", action=action, iter=diag.get("iter"),
            phase=diag.get("phase"), elapsed_s=elapsed, deadline_s=deadline,
            inflight_depth=diag.get("inflight_depth"),
            last_drained=diag.get("last_drained"), fires=diag.get("fires"),
            stacks=diag.get("stacks"),
        )
        telemetry.runtime_log(
            "watchdog %s: no progress for %.1fs (deadline %.1fs) at iter %s "
            "phase %r, %s step(s) in flight, last drained %s"
            % (action, elapsed, deadline, diag.get("iter"), diag.get("phase"),
               diag.get("inflight_depth"), diag.get("last_drained"))
        )
        cb = self._on_fire if action == "fire" else self._on_escalate
        if cb is not None:
            cb(diag)

    def summary(self) -> Dict[str, Any]:
        return {
            "fires": self.fires,
            "escalated": self.escalated,
            "deadline_s": self.deadline_s(),
            "events": list(self.events),
        }

    # ---------------------------------------------------------------- thread
    def start(self) -> "Watchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._monitor, name="galvatron-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(self.cfg.poll_interval_s * 4, 1.0))
            self._thread = None

    def _monitor(self) -> None:
        while not self._stop.wait(self.cfg.poll_interval_s):
            try:
                self.check()
                if self.hard_exit_due():
                    sys.stderr.write(
                        "watchdog: escalation not taken up by the driver; exiting %d\n%s\n"
                        % (WATCHDOG_EXIT_CODE, thread_stack_dump()))
                    sys.stderr.flush()
                    os._exit(WATCHDOG_EXIT_CODE)
            except Exception as e:  # the monitor must never kill the run
                telemetry.runtime_log("watchdog monitor error: %s" % e)

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc_info):
        self.stop()
        return False


# ------------------------------------------------------------- mesh health
def classify_world(expected_ids: Sequence[int], live_devices: Sequence[Any]) -> Dict[str, Any]:
    """Enumeration diff: the live ids (ranks, or anything with an ``id``)
    against the ids the running strategy was planned for. Pure
    bookkeeping."""
    expected = sorted(int(i) for i in expected_ids)
    live = sorted(int(getattr(d, "id", d)) for d in live_devices)
    missing = sorted(set(expected) - set(live))
    added = sorted(set(live) - set(expected))
    if missing:
        status = "degraded"
    elif added:
        status = "grown"
    else:
        status = "healthy"
    return {
        "status": status,
        "expected": len(expected),
        "live": len(live),
        "missing_ids": missing,
        "added_ids": added,
    }


def probe_collective(group=None, timeout_s: float = 5.0, device=None,
                     time_fn: Callable[[], float] = time.monotonic,
                     poll_s: float = 1e-3) -> Dict[str, Any]:
    """One all-reduce of a one-element tensor over `group` (default: the
    world; on `device`, by default the current GPU under NCCL, else the
    CPU), issued asynchronously and polled (``work.is_completed()``)
    against a deadline of `timeout_s` on `time_fn`'s clock. A healthy world
    answers in milliseconds; one whose collective does not complete in time
    reports ``ok=False, timed_out=True`` instead of hanging the driver (the
    collective stays posted: the caller must issue no further one). Every
    rank of `group` must call it."""
    import torch
    import torch.distributed as dist

    result: Dict[str, Any] = {"ok": False, "timed_out": False, "elapsed_s": None}
    try:
        n = dist.get_world_size(group)
        if device is None:  # NCCL reduces device tensors only
            device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
        t = torch.ones(1, dtype=torch.float32, device=device)
        t0 = time_fn()
        work = dist.all_reduce(t, group=group, async_op=True)
        while not work.is_completed():
            if time_fn() - t0 > max(timeout_s, 0.0):
                result["timed_out"] = True
                result["error"] = "collective did not complete within %.1fs" % timeout_s
                return result
            time.sleep(poll_s)
        work.wait()
        value = float(t.item())
        result["elapsed_s"] = time_fn() - t0
        result["ok"] = value == float(n)
        if not result["ok"]:
            result["error"] = "collective returned %r, expected %d" % (value, n)
    except Exception as e:  # noqa: BLE001 - reported, not raised
        result["error"] = "%s: %s" % (type(e).__name__, e)
    return result


def _world_ranks() -> List[int]:
    from galvatron_tpu_torch.runtime import distributed

    return list(range(distributed.world_size()))


@dataclass
class MeshHealthMonitor:
    """Periodic probe of the run's world, driven from the train loop's
    step boundaries (no thread of its own: a probe runs when the loop is
    live, which is when its verdict can be acted on).

    `expected_ids` are the world's ranks; `devices_fn` (default: the
    world's ranks) and `time_fn` are injectable, so tests simulate a lost
    rank without killing one. `quarantined_ids` holds ranks another
    subsystem convicted (the silent-corruption vote, ``runtime/sdc.py``): a
    quarantined rank counts as missing although it is alive, so every later
    probe reports the world degraded until the run migrates off it.

    Ranks must agree on when to probe (the probe is a collective): the
    driver asks `due` on every rank, agrees on it in its per-step flag
    all-reduce and calls `probe` on all of them; `maybe_probe` is the
    one-controller form of the reference."""

    group: Any = None  # the run's process group (None: the world)
    interval_s: float = 60.0
    timeout_s: float = 5.0
    devices_fn: Callable[[], Sequence[Any]] = None  # default: the world's ranks
    time_fn: Callable[[], float] = time.monotonic
    collective: bool = True  # enumeration diff only when False
    device: Any = None  # where the probe's tensor lives (the run's device)
    _next_due: Optional[float] = field(default=None, repr=False)
    expected_ids: Sequence[int] = ()
    quarantined_ids: set = field(default_factory=set)

    def __post_init__(self):
        if self.devices_fn is None:
            self.devices_fn = _world_ranks
        if not self.expected_ids:
            self.expected_ids = _world_ranks()

    def due(self, now: Optional[float] = None) -> bool:
        """True when a probe is due (every `interval_s`; the first call
        starts the clock). Does not reschedule: `probe` does."""
        now = self.time_fn() if now is None else now
        if self._next_due is None:
            self._next_due = now + self.interval_s
            return False
        return now >= self._next_due

    def maybe_probe(self, now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Run the probe when due; None otherwise."""
        now = self.time_fn() if now is None else now
        if not self.due(now):
            return None
        return self.probe(now)

    def quarantine(self, ids: Sequence[int]) -> Dict[str, Any]:
        """Convict `ids` and return the immediate (degraded) verdict the
        caller can feed into its migrate-on-degrade handler."""
        self.quarantined_ids.update(int(i) for i in ids)
        return self.probe()

    def probe(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = self.time_fn() if now is None else now
        self._next_due = now + self.interval_s
        live = [d for d in self.devices_fn()
                if int(getattr(d, "id", d)) not in self.quarantined_ids]
        verdict = classify_world(self.expected_ids, live)
        verdict["live_ids"] = sorted(int(getattr(d, "id", d)) for d in live)
        if self.quarantined_ids:
            verdict["quarantined_ids"] = sorted(self.quarantined_ids)
        if self.collective and verdict["status"] == "healthy":
            # the collective's deadline is real time, whatever clock
            # schedules the probes
            coll = probe_collective(self.group, timeout_s=self.timeout_s, device=self.device)
            verdict["collective_ok"] = coll["ok"]
            if coll.get("elapsed_s") is not None:
                verdict["collective_elapsed_s"] = coll["elapsed_s"]
            if not coll["ok"]:
                verdict["status"] = "wedged"
                verdict["error"] = coll.get("error")
        return verdict
