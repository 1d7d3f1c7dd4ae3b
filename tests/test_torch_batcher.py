"""The port's admission plumbing against the JAX package's: ``TTLCache``,
the work queues (``TokenBucket``, ``ExponentialBackoff``,
``RateLimitingQueue``) and the windowed ``Batcher`` (idle and max
windows, the ``max_items`` cap, the gate flush, the bounded queue's
priority shed, ``set_pressure``, ``shed_low_priority``, ``stop``).

Each scenario runs once per package with the same inputs and an injected
clock where the module takes one; the two traces must be equal, and each
also meets the reference's documented behavior.
"""

import importlib
import threading
import time

import pytest

from torch_parity import PACKAGES, fresh_router  # noqa: F401


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def both(scenario):
    ref, port = (scenario(pkg) for pkg in PACKAGES)
    assert port == ref
    return port


# -- ttlcache ----------------------------------------------------------------


def ttl_trace(pkg):
    now = [0.0]
    cache = mod(pkg, "utils.ttlcache").TTLCache(10.0, clock=lambda: now[0])
    out = []
    cache.set("a", 1)
    cache.set("b", 2, ttl=3.0)
    out.append((cache.get("a"), cache.get("b"), sorted(cache.keys())))
    now[0] = 3.0
    out.append((cache.get("a"), cache.get("b"), sorted(cache.keys())))
    out.append(cache.get_or_compute("b", lambda: 7))
    out.append(cache.get_or_compute("b", lambda: 8))
    now[0] = 10.0
    out.append((cache.get("a"), cache.get("b")))
    cache.delete("b")
    out.append(cache.get("b"))
    cache.set("c", 3)
    cache.clear()
    out.append(sorted(cache.keys()))
    return out


def test_ttlcache_expires_like_the_reference():
    trace = both(ttl_trace)
    assert trace[0] == (1, 2, ["a", "b"])
    assert trace[1] == (1, None, ["a"])
    assert trace[2:4] == [7, 7]
    assert trace[4] == (None, 7) and trace[5] is None and trace[6] == []


# -- workqueue ---------------------------------------------------------------


def bucket_trace(pkg):
    now = [0.0]
    b = mod(pkg, "utils.workqueue").TokenBucket(qps=2.0, burst=3, clock=lambda: now[0])
    out = [b.try_take() for _ in range(4)]
    out.append(round(b.wait_time(), 6))
    now[0] = 0.25
    out.append((b.try_take(), round(b.wait_time(), 6)))
    now[0] = 0.5
    out.append(b.try_take())
    now[0] = 10.0
    out.append([b.try_take() for _ in range(4)])
    out.append(b.take(timeout=0.0))
    return out


def test_token_bucket_like_the_reference():
    trace = both(bucket_trace)
    assert trace[:4] == [True, True, True, False]
    assert trace[4] == 0.5 and trace[5] == (False, 0.25) and trace[6] is True
    assert trace[7] == [True, True, True, False] and trace[8] is False


def backoff_trace(pkg):
    wq = mod(pkg, "utils.workqueue")
    bo = wq.ExponentialBackoff(base=0.01, cap=0.1)
    out = [bo.when("k") for _ in range(6)] + [bo.retries("k")]
    bo.forget("k")
    out += [bo.retries("k"), bo.when("k"), bo.when("other")]
    return out


def test_exponential_backoff_like_the_reference():
    trace = both(backoff_trace)
    assert trace[:6] == [0.01, 0.02, 0.04, 0.08, 0.1, 0.1]
    assert trace[6:] == [6, 0, 0.01, 0.01]


def queue_trace(pkg):
    wq = mod(pkg, "utils.workqueue")
    q = wq.RateLimitingQueue(backoff=wq.ExponentialBackoff(base=0.01, cap=0.05))
    out = []
    q.add("a")
    q.add("a")  # dedup while queued
    q.add("b")
    out.append(len(q))
    a = q.get()
    q.add("a")  # re-added while processing: dirty, requeued on done
    out.append((a, len(q)))
    q.done("a")
    out.append(len(q))
    out.append([q.get(), q.get()])
    q.done("b")
    q.done("a")
    out.append(q.get(timeout=0.01))  # empty: None after the timeout
    q.add_after("c", 0.05)
    out.append(q.get(timeout=0.01))
    out.append(q.get(timeout=2.0))
    q.done("c")
    q.backoff.when("d")  # an earlier failure: this retry waits 2 x base
    q.add_rate_limited("d")
    out.append(q.backoff.retries("d"))
    out.append(q.get(timeout=2.0))
    q.forget("d")
    q.done("d")
    out.append(q.backoff.retries("d"))
    q.add_after("e", 0.0)
    out.append(len(q))
    q.shut_down()
    out.append(q.is_shut_down())
    out.append(q.get())  # drained items still come out after shutdown
    q.done("e")
    with pytest.raises(wq.ShutDown):
        q.get()
    q.add("f")  # adds after shutdown are dropped
    out.append(len(q))
    return out


def test_rate_limiting_queue_like_the_reference():
    trace = both(queue_trace)
    assert trace[0] == 2 and trace[1] == ("a", 1) and trace[2] == 2
    assert trace[3] == ["b", "a"] and trace[4] is None
    assert trace[5] is None and trace[6] == "c"
    assert trace[7] == 2 and trace[8] == "d" and trace[9] == 0
    assert trace[10] == 1 and trace[11] is True and trace[12] == "e" and trace[13] == 0


# -- batcher -----------------------------------------------------------------


def Batcher(pkg, **kw):
    return mod(pkg, "utils.batcher").Batcher(**kw)


def window_trace(pkg):
    b = Batcher(pkg, idle_duration=0.05, max_duration=5.0)
    b.add("a")
    b.add("b")
    items, window = b.wait()
    return items, window < 1.0


def test_window_closes_on_idle():
    assert both(window_trace) == (["a", "b"], True)


def max_window_trace(pkg):
    b = Batcher(pkg, idle_duration=0.5, max_duration=0.6)
    stop = threading.Event()

    def feed():
        i = 0
        while not stop.is_set():
            b.add(i)
            i += 1
            time.sleep(0.02)

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    try:
        items, window = b.wait()
    finally:
        stop.set()
        t.join(timeout=5)
    assert not t.is_alive()
    # a steady trickle never idles out: the max duration closes the window
    return 0.55 <= window < 3.0, len(items) >= 3


def test_window_closes_at_max_duration():
    assert both(max_window_trace) == (True, True)


def cap_trace(pkg):
    b = Batcher(pkg, idle_duration=1.0, max_items=3)
    for i in range(5):
        b.add(i)
    first, _ = b.wait()
    return first, b.depth()


def test_max_items_cap():
    assert both(cap_trace) == ([0, 1, 2], 2)


def gate_trace(pkg):
    b = Batcher(pkg)
    gate = b.add("x")
    out = [gate.is_set()]
    b.flush()
    out.append(gate.is_set())
    gate2 = b.add("y")
    out.append(gate2.is_set())
    b.stop()
    out.append(gate2.is_set())
    out.append(b.add("z").is_set())  # after stop the gate comes pre-set
    out.append(b.wait())  # a stopped batcher hands out nothing
    return out


def test_gate_flush_and_stop():
    assert both(gate_trace) == [False, True, False, True, True, ([], 0.0)]


def shed_trace(pkg):
    shed = []
    b = Batcher(
        pkg, idle_duration=0.01, max_depth=3,
        priority_fn=lambda item: item[0], on_shed=lambda item, reason: shed.append((item, reason)),
    )
    for item in [(0, "a"), (5, "b"), (0, "c"), (-1, "d"), (5, "e"), (9, "f")]:
        b.add(item)
    out = [list(shed), b.depth(), b.shed_total, b.max_depth_seen]
    items, _ = b.wait()
    out.append(items)
    return out


def test_full_queue_sheds_the_oldest_lowest_priority():
    trace = both(shed_trace)
    # d (-1) is strictly the least important: it is shed on arrival; e then
    # sheds a (oldest of class 0), f sheds c
    assert trace[0] == [((-1, "d"), "queue_full"), ((0, "a"), "queue_full"),
                        ((0, "c"), "queue_full")]
    assert trace[1:4] == [3, 3, 3]
    assert trace[4] == [(5, "b"), (5, "e"), (9, "f")]


def shed_metric(pkg, reason):
    value = mod(pkg, "metrics").REGISTRY.get_sample_value(
        "karpenter_batcher_shed_total", {"reason": reason})
    return value or 0.0


def pressure_trace(pkg):
    b = Batcher(pkg, idle_duration=10.0, max_duration=20.0, max_items=10)
    out = [b.pressure()]
    b.set_pressure(0.2)
    out.append(b.pressure())
    for i in range(5):
        b.add(i)
    t0 = time.monotonic()
    items, _ = b.wait()  # the cap scales to 2 items
    out += [items, time.monotonic() - t0 < 1.0]
    b.set_pressure(0.0)
    out.append(b.pressure())  # clamped at 0.01
    b.set_pressure(3.0)
    out.append(b.pressure())  # clamped at 1.0
    return out


def test_set_pressure_scales_the_window():
    assert both(pressure_trace) == [1.0, 0.2, [0, 1], True, 0.01, 1.0]


def brownout_shed_trace(pkg):
    shed = []
    before = shed_metric(pkg, "brownout")
    b = Batcher(pkg, priority_fn=lambda item: item[0],
                on_shed=lambda item, reason: shed.append((item, reason)))
    for item in [(0, "a"), (-10, "b"), (10, "c"), (-10, "d")]:
        b.add(item)
    n = b.shed_low_priority(0)
    return n, shed, b.depth(), b.shed_total, shed_metric(pkg, "brownout") - before


def test_shed_low_priority_drains_below_the_floor():
    n, shed, depth, total, counted = both(brownout_shed_trace)
    assert n == 2 and depth == 2 and total == 2 and counted == 2.0
    assert shed == [((-10, "b"), "brownout"), ((-10, "d"), "brownout")]


def raising_hook_trace(pkg):
    def boom(item, reason):
        raise RuntimeError("hook")

    b = Batcher(pkg, idle_duration=0.01, max_depth=1, on_shed=boom,
                priority_fn=lambda item: 1 / 0)  # a raising priority is class 0
    b.add("a")
    gate = b.add("b")  # sheds a; the raising hook loses its event, not the add
    items, _ = b.wait()
    return items, gate.is_set(), b.shed_total


def test_raising_hooks_never_fail_an_add():
    assert both(raising_hook_trace) == (["b"], False, 1)


def test_batcher_defaults_match():
    ref, port = (mod(pkg, "utils.batcher") for pkg in PACKAGES)
    for name in ("MAX_BATCH_DURATION", "BATCH_IDLE_DURATION", "MAX_ITEMS_PER_BATCH",
                 "MAX_QUEUE_DEPTH"):
        assert getattr(port, name) == getattr(ref, name)
    b = port.Batcher()
    assert (b.max_duration, b.idle_duration, b.max_items, b.max_depth) == (10.0, 1.0, 2000, 10_000)
