"""Port parity: the async serving runtime (``repro_torch.serve.runtime``),
the cases of the reference's ``tests/test_runtime.py`` on the port.

The runtime's tokens are held to the port's synchronous engine (greedy and
sampled) and, greedy, to the reference model's greedy continuation; never
to the reference engine's tokens, which vary from run to run (ROADMAP.md
§C).  Every wait passes a timeout of a few seconds, so a hung pipeline
fails its test at once, and every runtime is closed in ``finally``.
"""

import threading

import jax
import numpy as np
import pytest

from repro.models import transformer as JT
from torch_parity import (greedy_continuation, np_params,  # noqa: F401
                          tiny_dense_config, torch_config, tp)

JCFG = tiny_dense_config()
TCFG = torch_config(JCFG)
WAIT = 20.0             # seconds: a few times what any wait here needs


@pytest.fixture(scope="module")
def params(tp):
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, tp.interop.params_from_jax(np_params(jp), TCFG, device="cpu")


@pytest.fixture(scope="module")
def RT(tp):
    from repro_torch.serve import runtime
    return runtime


def _prompts(lens=(1, 4, 7, 3, 9, 2)):
    rng = np.random.default_rng(0)
    return [rng.integers(1, JCFG.vocab_size, size=L).astype(np.int32)
            for L in lens]


def _reqs(tp, prompts, max_new=5, **kw):
    return [tp.engine.Request(prompt=p, max_new_tokens=max_new,
                              eos_id=JCFG.vocab_size, **kw)
            for p in prompts]


def _engine(tp, params, **kw):
    return tp.engine.ServeEngine(TCFG, params[1], device="cpu",
                                 batch_slots=2, capacity=32, page_size=8,
                                 **kw)


def _serve(rt, reqs):
    """``rt.run(reqs)`` on a thread joined with a timeout."""
    t = threading.Thread(target=rt.run, args=(reqs,), daemon=True)
    t.start()
    t.join(WAIT)
    assert not t.is_alive(), "the runtime did not finish in time"
    for r in reqs:
        assert r.done
    return reqs


# ---------------------------------------------------------------------------
# plumbing
# ---------------------------------------------------------------------------


def test_workqueue_bounded_and_counted(RT):
    q = RT.WorkQueue("t", maxsize=2)
    q.put(1)
    q.put(2)
    assert q.stats["puts"] == 2 and q.stats["max_depth"] == 2
    assert q.get() == 1 and q.get() == 2
    assert q.get() is None                  # empty: non-blocking None
    assert q.get(timeout=0.01) is None      # empty: timeout None
    assert q.stats["gets"] == 2


def test_workqueue_counts_producer_waits(RT):
    q = RT.WorkQueue("t", maxsize=1)
    q.put(0)
    t = threading.Thread(target=q.put, args=(1,), daemon=True)
    t.start()
    while q.stats["put_waits"] == 0 and t.is_alive():
        t.join(0.01)
    assert q.get(timeout=WAIT) == 0
    t.join(WAIT)
    assert not t.is_alive()
    assert q.stats["put_waits"] == 1 and q.get(timeout=WAIT) == 1


def test_transfer_buffer_pool_bounds_staging(tp, RT):
    pool = RT.TransferBufferPool(2, capacity=16)
    a = pool.acquire()
    a.stage(np.arange(5, dtype=np.int32))
    assert a.used == 5 and a.arr[4] == 4
    b = pool.acquire()
    assert pool.stats == {"acquires": 2, "acquire_waits": 0}
    pool.release(a)
    c = pool.acquire()                      # recycled, no new allocation
    assert c is a
    pool.release(b)
    pool.release(c)
    for kw in (dict(transfer_buffers=0), dict(queue_depth=0)):
        with pytest.raises(ValueError):
            RT.AsyncServeRuntime(object.__new__(tp.engine.ServeEngine), **kw)


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("queue_depth,buffers", [(2, 2), (4, 4), (1, 1)])
def test_async_matches_sync_greedy(tp, params, RT, queue_depth, buffers):
    sync = _engine(tp, params)
    ref = [r.out_tokens for r in sync.generate(_reqs(tp, _prompts()))]
    assert ref == greedy_continuation(params[0], JCFG, _prompts(), 5, 32)
    rt = RT.AsyncServeRuntime(_engine(tp, params), queue_depth=queue_depth,
                              transfer_buffers=buffers)
    try:
        out = _serve(rt, _reqs(tp, _prompts()))
    finally:
        rt.close()
    assert [r.out_tokens for r in out] == ref
    assert all(r.finish_reason == "length" for r in out)
    # the pipeline served through the queues it claims to
    assert rt.emit_q.stats["gets"] == rt.emit_q.stats["puts"] > 0
    assert rt.staged_q.stats["gets"] >= len(out)
    assert rt.buffers.stats["acquires"] == len(out)
    assert rt.engine.stats["generated_tokens"] == sync.stats[
        "generated_tokens"]


@pytest.mark.parametrize("seed", [11, 12])
def test_async_matches_sync_sampled(tp, params, RT, seed):
    """Sampling noise depends on (seed, request id, token index) only, so
    the runtime's scheduling cannot change sampled tokens either."""
    kw = dict(greedy=False, temperature=0.8, seed=seed)
    sync = _engine(tp, params, **kw)
    ref = [r.out_tokens for r in sync.generate(_reqs(tp, _prompts(),
                                                     max_new=6))]
    rt = RT.AsyncServeRuntime(_engine(tp, params, **kw))
    try:
        out = _serve(rt, _reqs(tp, _prompts(), max_new=6))
    finally:
        rt.close()
    assert [r.out_tokens for r in out] == ref


def test_async_prefix_cache_matches_sync(tp, params, RT):
    """The runtime over a prefix-sharing engine: the same tokens and the
    same sharing as the synchronous engine when requests come one at a
    time."""
    rng = np.random.default_rng(5)
    base = rng.integers(1, JCFG.vocab_size, size=16).astype(np.int32)
    prompts = [base, np.concatenate([base, base[:5]]), base]
    sync = _engine(tp, params, prefix_cache=True)
    ref = [sync.generate(_reqs(tp, [p]))[0].out_tokens for p in prompts]
    eng = _engine(tp, params, prefix_cache=True)
    rt = RT.AsyncServeRuntime(eng)
    try:
        out = [_serve(rt, _reqs(tp, [p]))[0].out_tokens for p in prompts]
    finally:
        rt.close()
    assert out == ref
    for k in ("prefix_hits", "prefix_misses", "shared_pages_mapped",
              "cow_forks", "prefill_tokens"):
        assert eng.stats[k] == sync.stats[k], k


def test_concurrent_submitters_stress(tp, params, RT):
    """Eight threads submit three sampled requests each at once, with the
    interpreter switching threads every 10 us: every request gets a unique
    rid, exactly one terminal event, and the tokens a synchronous engine
    gives the same prompt under the same rid."""
    import sys
    kw = dict(greedy=False, temperature=0.9, seed=5)
    prompts = _prompts((3, 5, 2, 8, 1, 6, 4, 7))
    rt = RT.AsyncServeRuntime(_engine(tp, params, **kw), queue_depth=2,
                              transfer_buffers=2)
    mine: dict[int, list] = {i: [] for i in range(8)}
    finishes: list = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def submit(i):
            for j in range(3):
                r = _reqs(tp, [prompts[(i + j) % 8]], max_new=4)[0]
                r.on_finish = finishes.append
                mine[i].append(rt.submit(r))

        threads = [threading.Thread(target=submit, args=(i,), daemon=True)
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
        handles = [h for hs in mine.values() for h in hs]
        for h in handles:
            h.result(timeout=WAIT)
    finally:
        sys.setswitchinterval(old)
        rt.close()
    reqs = [h.request for h in handles]
    assert sorted(r.rid for r in reqs) == list(range(24))
    assert len(finishes) == 24 and set(finishes) == {"length"}
    sync = _engine(tp, params, **kw)
    want = sync.generate([tp.engine.Request(
        prompt=r.prompt, max_new_tokens=4, eos_id=JCFG.vocab_size,
        rid=r.rid) for r in reqs])
    assert [r.out_tokens for r in reqs] == [w.out_tokens for w in want]


def test_dropped_engine_is_freed_without_the_collector(tp, params, RT):
    """An engine that served (sampled, with prefix sharing, per-request
    backends, through a runtime that streamed) holds no reference cycle:
    once its last reference goes, its weights and pages go with it, with
    the cycle collector off (on the card that is tens of GB)."""
    import gc
    import weakref
    gc.collect()
    gc.disable()
    try:
        eng = _engine(tp, params, greedy=False, prefix_cache=True)
        eng.generate(_reqs(tp, _prompts((9, 3)), max_new=3) + _reqs(
            tp, _prompts((4,)), max_new=2, gmm_backend="segment"))
        rt = RT.AsyncServeRuntime(eng)
        try:
            h = rt.submit(_reqs(tp, _prompts((9,)), max_new=3)[0])
            assert len(list(h.stream(timeout=WAIT))) == 3
        finally:
            rt.close()
        pools = weakref.ref(eng._cache[0].k)
        ref = weakref.ref(eng)
        del eng, rt, h
        assert ref() is None and pools() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------


def test_streaming_order_and_terminal_event(tp, params, RT):
    events = []
    reqs = _reqs(tp, _prompts((4, 7, 2)), max_new=4)
    for i, r in enumerate(reqs):
        r.on_token = lambda t, i=i: events.append(("tok", i, t))
        r.on_finish = lambda why, i=i: events.append(("fin", i, why))
    rt = RT.AsyncServeRuntime(_engine(tp, params))
    try:
        handles = [rt.submit(r) for r in reqs]
        for h in handles:
            assert h.result(timeout=WAIT) is h.request
            assert h.done and h.finish_reason == "length"
            assert h.tokens == h.request.out_tokens
    finally:
        rt.close()
    for i, r in enumerate(reqs):
        mine = [e for e in events if e[1] == i]
        # every token callback in emission order, then exactly one terminal
        assert mine == ([("tok", i, t) for t in r.out_tokens]
                        + [("fin", i, "length")])


def test_stream_iterator_and_eos(tp, params, RT):
    probe = _engine(tp, params).generate(_reqs(tp, _prompts((4,)),
                                               max_new=3))[0]
    first = probe.out_tokens[0]
    r = tp.engine.Request(prompt=_prompts((4,))[0], max_new_tokens=5,
                          eos_id=first)
    rt = RT.AsyncServeRuntime(_engine(tp, params))
    try:
        it = rt.stream(r, timeout=WAIT)
        seen = []
        try:
            while True:
                seen.append(next(it))
        except StopIteration as stop:
            reason = stop.value
    finally:
        rt.close()
    assert seen == r.out_tokens == [first]
    assert reason == "eos" and r.finish_reason == "eos"


def test_stream_timeout_raises_timeout_error(tp, RT):
    """A stalled pipeline surfaces as TimeoutError (or the pipeline's own
    error), never a raw ``queue.Empty``."""

    class _Idle:
        def _check_error(self):
            pass

    h = RT.RequestHandle(_reqs(tp, _prompts((2,)))[0], _Idle())
    with pytest.raises(TimeoutError, match="no token or terminal event"):
        next(h.stream(timeout=0.01))
    with pytest.raises(TimeoutError, match="did not finish"):
        h.result(timeout=0.01)

    class _Dead:
        def _check_error(self):
            raise RuntimeError("serving pipeline failed")

    h2 = RT.RequestHandle(_reqs(tp, _prompts((2,)))[0], _Dead())
    with pytest.raises(RuntimeError, match="serving pipeline failed"):
        next(h2.stream(timeout=0.01))


def test_submit_validates_on_the_callers_thread(tp, params, RT):
    eng = _engine(tp, params, gmm_backend="segment")
    rt = RT.AsyncServeRuntime(eng)
    try:
        R = tp.engine.Request
        with pytest.raises(ValueError, match="max_new_tokens"):
            rt.submit(R(prompt=_prompts((3,))[0], max_new_tokens=0))
        with pytest.raises(ValueError, match="exceeds engine capacity"):
            rt.submit(R(prompt=np.ones(40, np.int32)))
        assert rt._threads == []          # nothing started for them
    finally:
        rt.close()
    with pytest.raises(RuntimeError, match="closed"):
        rt.submit(_reqs(tp, _prompts((3,)))[0])


# ---------------------------------------------------------------------------
# failure path
# ---------------------------------------------------------------------------


def test_pipeline_error_surfaces_as_terminal_event(tp, params, RT):
    eng = _engine(tp, params)

    def boom(*a, **k):
        raise RuntimeError("injected device failure")

    # a failing decode step: prefill succeeds, the first decode dispatch
    # kills the device thread
    eng._decode_fns[eng.backend.name] = boom
    reqs = _reqs(tp, _prompts((4, 7)), max_new=4)
    finishes = []
    for r in reqs:
        r.on_finish = finishes.append
    rt = RT.AsyncServeRuntime(eng)
    try:
        handles = [rt.submit(r) for r in reqs]
        with pytest.raises(RuntimeError, match="serving pipeline failed"):
            for h in handles:
                h.result(timeout=WAIT)
        assert all(r.done and r.finish_reason == "error" for r in reqs)
        assert finishes == ["error", "error"]     # one terminal event each
    finally:
        with pytest.raises(RuntimeError, match="serving pipeline failed"):
            rt.close()
    # a dead runtime refuses new work rather than hanging it
    with pytest.raises(RuntimeError):
        rt.submit(_reqs(tp, _prompts((3,)))[0])
    for t in rt._threads:
        t.join(WAIT)
        assert not t.is_alive()


def test_sync_engine_error_ends_requests_with_error(tp, params):
    """The synchronous engine: a failing step ends every unfinished
    request with ``"error"`` and re-raises."""
    eng = _engine(tp, params)
    eng._decode_fns[eng.backend.name] = lambda *a, **k: 1 / 0
    reqs = _reqs(tp, _prompts((4, 7, 3)), max_new=4)
    with pytest.raises(ZeroDivisionError):
        eng.generate(reqs)
    assert all(r.done and r.finish_reason == "error" for r in reqs)
