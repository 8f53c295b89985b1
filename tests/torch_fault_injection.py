"""Deterministic fault injection for the port's resilience layer.

Not a test module (pytest does not collect it) and free of the JAX
package: the injectors the port's resilience tests compose, the scenarios
of the reference's ``tests/runtime/fault_injection.py`` that the port
runs, and a ``__main__`` entry that runs one of them in a process of its
own, so a test can read a real exit code.

Injectors plug into the drivers through ``args.fault_hooks``
(``galvatron_tpu_torch.runtime.resilience.FaultHooks``):

    hang_hooks          a step call that sleeps after its work is done: to
                        the watchdog a wedged step or collective
    bitflip_hooks       one mantissa bit flipped in one rank's replica of
                        the first float parameter before the k-th step call,
                        once or (stuck at 1) on every call from then on
    serve_hang_hooks    a decode tick that sleeps
    sigusr1_hooks       SIGUSR1 to this process once at a step boundary: the
                        manual live-migration trigger
    sigterm_hooks       SIGTERM at a step (or decode tick) boundary
    device_loss_hooks   from a step on the mesh probe sees only the first
                        `live` ranks (a simulated lost rank: still alive)

Scenarios (``python tests/torch_fault_injection.py --scenario NAME ...``;
train scenarios print ``LOSSES=<json>``, serve ones ``SERVE=<json>``):

    train         plain tiny run
    hang          the step call --hang_at sleeps --hang_s seconds under
                  --watchdog: fire, escalate, emergency save, exit 3
    serve         plain tiny serve load
    serve_hang    decode tick --hang_at sleeps --hang_s seconds under
                  --watchdog: drain, exit 3
    serve_sigterm SIGTERM at decode step --sigterm_at: drain, exit 0
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hooks(**kw):
    from galvatron_tpu_torch.runtime.resilience import FaultHooks

    return FaultHooks(**kw)


def _original_rank() -> int:
    """This process's rank in the world it was launched into (torchrun's
    RANK): stable across a migration that renumbers the survivors."""
    return int(os.environ.get("RANK", "0"))


def hang_hooks(at_step: int, hang_s: float):
    """The `at_step`-th step call runs, waits for its device work, then
    sleeps `hang_s` inside the call: to the watchdog, a step that made no
    progress (it cannot tell, and must not care, where the time went)."""
    import torch

    state = {"calls": 0}

    def wrap(step_fn):
        def wrapped(*a, **kw):
            out = step_fn(*a, **kw)
            if state["calls"] == at_step:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                time.sleep(hang_s)
            state["calls"] += 1
            return out
        return wrapped

    return _hooks(wrap_step_fn=wrap)


# stuck-at-1 ladder of mantissa bits: each persistent flip sets the first
# one that is still 0, so the value never returns to the clean one
_LADDER = tuple(range(18, 23)) + tuple(range(17, -1, -1))


def flip_bit(params, persistent: bool) -> bool:
    """Flip mantissa bit 18 of the first element of the first float32
    parameter of this process's params; when `persistent`, set the next
    mantissa bit that is still 0 instead (stuck at 1: an XOR re-applied to
    a frozen, still-corrupt state would restore it, and so would clearing a
    bit once the ladder is full, which no stuck datapath does). False when
    there is no such parameter."""
    import torch

    for module in params.values():
        for p in module.parameters():
            if p.dtype != torch.float32 or not p.numel():
                continue
            with torch.no_grad():
                words = p.data.view(torch.int32).reshape(-1)
                w = int(words[0])
                if persistent:
                    b = next((b for b in _LADDER if not (w >> b) & 1), None)
                    if b is None:
                        raise RuntimeError("no mantissa bit left to stick at 1")
                    w |= 1 << b
                else:
                    w ^= 1 << 18
                words[0] = w - (1 << 32) if w >= 1 << 31 else w
            return True
    return False


def bitflip_hooks(at_step: int, rank: int, persistent: bool = False):
    """Before the `at_step`-th step call (and, `persistent`, every call
    after it), flip a bit in rank `rank`'s replica: silent corruption with
    no fault signal. Only the process launched as `rank` flips; a
    persistent fault leaves with that process when a migration moves the
    run off it."""
    state = {"calls": 0, "done": False}

    def wrap(step_fn):
        def wrapped(params, *rest):
            call = state["calls"]
            state["calls"] += 1
            fire = call >= at_step if persistent else call == at_step
            if fire and not state["done"] and _original_rank() == rank:
                flip_bit(params, persistent)
                if not persistent:
                    state["done"] = True
            return step_fn(params, *rest)
        return wrapped

    return _hooks(wrap_step_fn=wrap)


def serve_hang_hooks(at_tick: int, hang_s: float):
    """The `at_tick`-th decode tick sleeps `hang_s` after its work."""
    state = {"calls": 0}

    def wrap(step_fn):
        def wrapped(*a, **kw):
            out = step_fn(*a, **kw)
            if state["calls"] == at_tick:
                time.sleep(hang_s)
            state["calls"] += 1
            return out
        return wrapped

    return _hooks(wrap_step_fn=wrap)


def sigusr1_hooks(at_step: int):
    """SIGUSR1 to this process once, at the `at_step` boundary (the loop
    may pass the same boundary again after a migration: a real operator
    signal arrives once)."""
    sent = {"done": False}

    def on_step(it: int):
        if it == at_step and not sent["done"]:
            sent["done"] = True
            os.kill(os.getpid(), signal.SIGUSR1)

    return _hooks(on_step=on_step)


def sigterm_hooks(at_step: int):
    def on_step(it: int):
        if it == at_step:
            os.kill(os.getpid(), signal.SIGTERM)

    return _hooks(on_step=on_step)


def device_loss_hooks(at_step: int, live: int):
    """From the `at_step` boundary on, the mesh probe sees only ranks
    0..live-1 of the world it was planned for."""
    from galvatron_tpu_torch.runtime import distributed

    state = {"lost": False}

    def on_step(it: int):
        if it >= at_step:
            state["lost"] = True

    def probe():
        world = distributed.world_size()
        return list(range(min(live, world) if state["lost"] else world))

    return _hooks(on_step=on_step, probe_devices_fn=probe)


# ------------------------------------------------------------------ argv
TRAIN_ARGV = [
    "--device", "cpu", "--model_type", "llama", "--set_model_config_manually", "1",
    "--hidden_size", "32", "--num_attention_heads", "2", "--num_layers", "2",
    "--vocab_size", "64", "--seq_length", "16", "--mixed_precision", "fp32",
    "--global_train_batch_size", "8", "--lr", "1e-2", "--log_interval", "100",
]

SERVE_ARGV = [
    "--device", "cpu", "--model_type", "llama", "--set_model_config_manually", "1",
    "--hidden_size", "32", "--num_attention_heads", "2", "--num_layers", "2",
    "--vocab_size", "64", "--seq_length", "64", "--mixed_precision", "fp32",
    "--serve_max_concurrency", "2", "--serve_page_size", "16", "--num_requests", "4",
    "--prompt_len_min", "4", "--prompt_len_max", "8", "--max_new_tokens", "12",
]


def tiny_train_argv(train_iters: int, save=None, load=None, extra=()):
    argv = TRAIN_ARGV + ["--train_iters", str(train_iters)]
    if save:
        argv += ["--save", save]
    if load:
        argv += ["--load", load]
    return argv + list(extra)


def run_train(argv, hooks=None) -> dict:
    from galvatron_tpu_torch.cli import train as T

    args = T.initialize_galvatron(argv=argv, mode="train")
    args.fault_hooks = hooks
    return T.train(args)


def run_serve(argv, hooks=None) -> dict:
    from galvatron_tpu_torch.cli import serve as S

    args = S.initialize_galvatron(argv=argv)
    args.fault_hooks = hooks
    return S.serve(args)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scenario", required=True,
                   choices=("train", "hang", "serve", "serve_hang", "serve_sigterm"))
    p.add_argument("--train_iters", type=int, default=8)
    p.add_argument("--save", default=None)
    p.add_argument("--hang_at", type=int, default=5)
    p.add_argument("--hang_s", type=float, default=4.0)
    p.add_argument("--sigterm_at", type=int, default=3)
    p.add_argument("extra", nargs=argparse.REMAINDER,
                   help="after --: more flags for the driver (e.g. the watchdog's)")
    a = p.parse_args(argv)
    extra = [x for x in a.extra if x != "--"]
    import torch

    torch.set_num_threads(1)
    if a.scenario in ("train", "hang"):
        from galvatron_tpu_torch.cli import train as T
        from galvatron_tpu_torch.runtime.health import WATCHDOG_EXIT_CODE

        hooks = hang_hooks(a.hang_at, a.hang_s) if a.scenario == "hang" else None
        summary = run_train(tiny_train_argv(a.train_iters, save=a.save, extra=extra), hooks)
        print("LOSSES=" + json.dumps(summary["losses"]))
        print("SUMMARY=" + json.dumps({k: summary.get(k) for k in (
            "interrupted", "watchdog", "resilience")}, default=str))
        sys.stdout.flush()
        if (summary.get("watchdog") or {}).get("escalated"):
            return WATCHDOG_EXIT_CODE
        return 0
    from galvatron_tpu_torch.runtime.health import WATCHDOG_EXIT_CODE

    hooks = None
    if a.scenario == "serve_hang":
        hooks = serve_hang_hooks(a.hang_at, a.hang_s)
    elif a.scenario == "serve_sigterm":
        hooks = sigterm_hooks(a.sigterm_at)
    summary = run_serve(SERVE_ARGV + extra, hooks)
    print("SERVE=" + json.dumps({k: summary.get(k) for k in (
        "requests", "shed", "drain", "interrupted", "watchdog", "decode_steps")},
        default=str))
    sys.stdout.flush()
    if (summary.get("watchdog") or {}).get("escalated"):
        return WATCHDOG_EXIT_CODE
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
