"""The port's PrefetchIterator (``galvatron_tpu_torch/runtime/prefetch.py``):
every case of the reference's tests/runtime/test_prefetch.py — ordering,
bounded buffering, exceptions relayed to the consumer, clean shutdown, the
stall timeout with its diagnostics, closing under a stalled producer — and
the CPU half of the device placer. Host-only; each test has its own time
limit (a hung thread fails it instead of hanging the run). The CUDA half
(pinned copies on a side stream) is in tests/test_torch_cuda.py."""

import functools
import signal
import threading
import time

import pytest
import torch

from galvatron_tpu_torch.runtime.prefetch import (
    DevicePlacer,
    PrefetchIterator,
    PrefetchStalledError,
    consume,
)


def time_limit(seconds):
    """Fail the decorated test with TimeoutError after `seconds` (SIGALRM:
    tests run on the main thread)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            def expire(signum, frame):
                raise TimeoutError("%s exceeded its %ss limit" % (fn.__name__, seconds))
            prev = signal.signal(signal.SIGALRM, expire)
            signal.setitimer(signal.ITIMER_REAL, seconds)
            try:
                return fn(*a, **kw)
            finally:
                signal.setitimer(signal.ITIMER_REAL, 0)
                signal.signal(signal.SIGALRM, prev)
        return wrapped
    return deco


def wait_until(pred, timeout=5.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.005)
    return False


@time_limit(20)
def test_yields_in_source_order_and_exhausts():
    pf = PrefetchIterator(iter(range(10)), depth=3)
    assert list(pf) == list(range(10))
    with pytest.raises(StopIteration):
        next(pf)


@time_limit(20)
def test_place_fn_applied_off_thread():
    main = threading.get_ident()
    placed_on = []

    def place(x):
        placed_on.append(threading.get_ident())
        return x * 2

    pf = PrefetchIterator(iter([1, 2, 3]), depth=2, place_fn=place)
    assert list(pf) == [2, 4, 6]
    assert placed_on and all(t != main for t in placed_on)


@time_limit(20)
def test_buffering_is_bounded():
    pulled = []

    def source():
        for i in range(100):
            pulled.append(i)
            yield i

    pf = PrefetchIterator(source(), depth=2)
    # producer runs ahead only to depth + the one item in its hands
    assert wait_until(lambda: len(pulled) >= 3)
    time.sleep(0.1)
    assert len(pulled) <= 4
    assert next(pf) == 0
    assert wait_until(lambda: len(pulled) >= 4)
    time.sleep(0.1)
    assert len(pulled) <= 5
    pf.close()


@time_limit(20)
def test_source_exception_propagates_to_consumer():
    def source():
        yield 1
        yield 2
        raise OSError("corpus went away")

    pf = PrefetchIterator(source(), depth=2)
    assert next(pf) == 1
    assert next(pf) == 2
    with pytest.raises(OSError, match="corpus went away"):
        next(pf)
    # the failure is sticky, not swallowed into StopIteration
    with pytest.raises(OSError):
        next(pf)
    pf.close()


@time_limit(20)
def test_place_fn_exception_propagates():
    def bad_place(x):
        raise ValueError("shard_batch blew up")

    pf = PrefetchIterator(iter([1]), depth=1, place_fn=bad_place)
    with pytest.raises(ValueError, match="shard_batch blew up"):
        next(pf)
    pf.close()


@time_limit(20)
def test_close_unblocks_and_joins_producer():
    """close() must terminate a worker blocked on a full queue (the
    preemption / rollback path) without consuming the infinite source."""

    def infinite():
        i = 0
        while True:
            yield i
            i += 1

    pf = PrefetchIterator(infinite(), depth=1)
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(RuntimeError):
        next(pf)
    pf.close()  # idempotent


@time_limit(20)
def test_context_manager_closes():
    with PrefetchIterator(iter(range(5)), depth=2) as pf:
        assert next(pf) == 0
    assert not pf._thread.is_alive()


@time_limit(20)
def test_consumer_blocks_until_slow_producer_delivers():
    def slow():
        for i in range(3):
            time.sleep(0.05)
            yield i

    pf = PrefetchIterator(slow(), depth=2)
    assert [next(pf) for _ in range(3)] == [0, 1, 2]
    pf.close()


@time_limit(20)
def test_depth_must_be_positive():
    with pytest.raises(ValueError):
        PrefetchIterator(iter([]), depth=0)


# ----------------------------------------------------------- stall detection
def _wedged_place(release: threading.Event):
    def place(x):
        release.wait(timeout=30.0)  # a device_put stuck on a sick link
        return x

    return place


@time_limit(20)
def test_get_times_out_on_wedged_place_fn_with_diagnostics():
    release = threading.Event()
    pf = PrefetchIterator(iter(range(3)), depth=2,
                          place_fn=_wedged_place(release))
    with pytest.raises(PrefetchStalledError) as exc:
        pf.get(timeout=0.2)
    diag = exc.value.diagnostics
    assert diag["worker_alive"] is True
    assert diag["produced"] == 0 and diag["buffered"] == 0
    assert diag["busy_for_s"] is not None and diag["busy_for_s"] >= 0.2
    release.set()  # unwedge: the stall was transient, the item arrives
    assert pf.get(timeout=5.0) == 0
    pf.close()


@time_limit(20)
def test_constructor_stall_timeout_applies_to_next():
    release = threading.Event()
    pf = PrefetchIterator(iter(range(3)), depth=2,
                          place_fn=_wedged_place(release), stall_timeout=0.2)
    with pytest.raises(PrefetchStalledError):
        next(pf)
    release.set()
    pf.close()


@time_limit(20)
def test_no_timeout_waits_for_slow_producer():
    """stall_timeout=None keeps the pre-watchdog semantics: block until
    the (slow but live) producer delivers."""

    def slow():
        time.sleep(0.2)
        yield 42

    pf = PrefetchIterator(slow(), depth=1)
    assert pf.get() == 42
    pf.close()


@time_limit(20)
def test_close_under_stalled_producer_does_not_deadlock():
    release = threading.Event()
    pf = PrefetchIterator(iter(range(3)), depth=1,
                          place_fn=_wedged_place(release))
    time.sleep(0.05)  # let the worker get stuck inside place_fn
    t0 = time.time()
    pf.close(timeout=0.2)  # bounded join: returns despite the wedged worker
    assert time.time() - t0 < 2.0
    assert pf._closed
    release.set()  # let the daemon thread unwind


@time_limit(20)
def test_device_placer_on_cpu_passes_the_batch_through():
    batch = {"tokens": torch.arange(6).reshape(2, 3),
             "positions": torch.arange(3).expand(2, 3)}
    placed = DevicePlacer("cpu")(batch)
    assert placed[1] is None
    out = consume(placed)
    assert out is batch


@time_limit(20)
def test_prefetch_with_placer_keeps_source_order():
    src = ({"tokens": torch.full((2, 4), i)} for i in range(6))
    pf = PrefetchIterator(src, depth=2, place_fn=DevicePlacer("cpu"))
    got = [int(consume(b)["tokens"][0, 0]) for b in pf]
    assert got == list(range(6))
    pf.close()
