"""Asynchronous serving runtime: the engine's scheduler stages on threads.

Mirrors ``repro/serve/runtime.py``.  ``ServeEngine._serve_group`` chains
admission, device and emission inline, so the host waits for every step's
tokens before it issues the next.  Here the same ``_GroupScheduler``
stages run on three threads joined by bounded :class:`WorkQueue`\\ s:

* **admission thread** — pops submitted requests, stages each prompt in a
  :class:`TransferBufferPool` buffer (the bounded pool is the backpressure:
  with every buffer in flight, admission waits) and hands the request on;
* **device thread** — owns the scheduler state (slots, page tables, pool,
  prefix trie) and the device-resident ``last_tok``; admits staged
  requests, issues prefill and decode steps, and hands each step's tokens
  to the emission queue without waiting for them: the tokens are copied
  into a fresh pinned host buffer by a non-blocking copy behind a CUDA
  event (a plain ``.cpu()`` on another thread would wait behind every step
  already issued on the stream);
* **emission thread** — waits on the step's event (the pipeline's only
  sync), appends and streams the tokens (``on_token``), decides EOS and
  budget finishes, and posts finished slots back for release.

The device thread may run ahead of finish notifications; that is harmless
because a slot freezes once it has written its last reserved position,
emission drops tokens of finished requests, and sampling noise depends only
on ``(seed, request id, token index)``.  So the runtime gives the
synchronous engine's tokens, greedy or sampled.

Two thread-local states are entered by the device thread itself:
``torch.inference_mode`` and the ``use_backend`` scope (a ``ContextVar``:
a new thread starts from the default context).

Every request ends with exactly one ``on_finish(reason)``: ``"eos"``,
``"length"`` or ``"error"`` (a failed pipeline ends every unfinished
request with ``"error"`` and re-raises from ``result`` / ``close``).
:meth:`AsyncServeRuntime.stream` yields token ids as they are emitted and
returns the finish reason as its ``StopIteration`` value.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import gmm_backend as GB
from repro_torch.serve.engine import (Request, ServeEngine, _finish_request,
                                      _GroupScheduler)

_SENTINEL = object()


class WorkQueue:
    """A bounded FIFO between stages with counters: puts, gets, the depth
    high-water mark and producer waits."""

    def __init__(self, name: str, maxsize: int = 0):
        self.name = name
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._lock = threading.Lock()
        self.stats = {"puts": 0, "gets": 0, "max_depth": 0, "put_waits": 0}

    def put(self, item) -> None:
        if self._q.maxsize and self._q.full():
            with self._lock:
                self.stats["put_waits"] += 1
        self._q.put(item)
        with self._lock:
            self.stats["puts"] += 1
            self.stats["max_depth"] = max(self.stats["max_depth"],
                                          self._q.qsize())

    def get(self, timeout: float | None = None):
        """Pop one item; ``None`` on timeout (at once when ``timeout`` is
        None and the queue is empty)."""
        try:
            item = (self._q.get_nowait() if timeout is None
                    else self._q.get(timeout=timeout))
        except queue.Empty:
            return None
        with self._lock:
            self.stats["gets"] += 1
        return item


class TransferBuffer:
    """One reusable host staging buffer: a prompt is copied in on the
    admission thread and the buffer is held until that request's prefill
    has been issued."""

    def __init__(self, capacity: int):
        self.arr = np.zeros(capacity, np.int32)
        self.used = 0

    def stage(self, prompt: np.ndarray) -> None:
        self.used = prompt.size
        self.arr[:self.used] = prompt


class TransferBufferPool:
    """A bounded pool of :class:`TransferBuffer`\\ s; ``acquire`` blocks
    while every buffer is in flight."""

    def __init__(self, n: int, capacity: int):
        self._free: queue.Queue = queue.Queue()
        for _ in range(n):
            self._free.put(TransferBuffer(capacity))
        self.size = n
        self.stats = {"acquires": 0, "acquire_waits": 0}

    def acquire(self) -> TransferBuffer:
        if self._free.empty():
            self.stats["acquire_waits"] += 1
        buf = self._free.get()
        self.stats["acquires"] += 1
        return buf

    def release(self, buf: TransferBuffer) -> None:
        self._free.put(buf)


class RequestHandle:
    """The caller's view of a submitted request: iterate :meth:`stream`
    for live tokens, or wait on :meth:`result`."""

    def __init__(self, request: Request, runtime: "AsyncServeRuntime"):
        self.request = request
        self._runtime = runtime
        # the callbacks hold the queue and the flag, not the handle, so a
        # finished request keeps neither the handle nor the runtime alive
        self._events = events = queue.Queue()
        self._done = done = threading.Event()
        prev_tok, prev_fin = request.on_token, request.on_finish

        def on_token(tok: int) -> None:
            events.put(("token", tok))
            if prev_tok is not None:
                prev_tok(tok)

        def on_finish(reason: str) -> None:
            events.put(("finish", reason))
            done.set()
            if prev_fin is not None:
                prev_fin(reason)

        request.on_token = on_token
        request.on_finish = on_finish

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def finish_reason(self) -> str | None:
        return self.request.finish_reason

    @property
    def tokens(self) -> list:
        return list(self.request.out_tokens)

    def stream(self, timeout: float = 60.0) -> Iterator[int]:
        """Yield token ids as they are emitted; the generator's return
        value is the finish reason.  Raises ``TimeoutError`` (after
        surfacing a pipeline error) when no event comes within
        ``timeout`` seconds."""
        while True:
            try:
                kind, payload = self._events.get(timeout=timeout)
            except queue.Empty:
                self._runtime._check_error()
                raise TimeoutError(
                    f"no token or terminal event within {timeout}s") from None
            if kind == "finish":
                return payload
            yield payload

    def result(self, timeout: float | None = None) -> Request:
        if not self._done.wait(timeout):
            raise TimeoutError("request did not finish in time")
        self._runtime._check_error()
        return self.request


def _tokens_to_host(toks: torch.Tensor):
    """Start a step's tokens toward the host: on the card, a non-blocking
    copy into a fresh pinned buffer and an event recorded behind it."""
    if toks.device.type != "cuda":
        return toks, None
    host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
    host.copy_(toks, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


class AsyncServeRuntime:
    """Pipelined front end over one :class:`ServeEngine`, serving the
    engine's own backend (a request that resolves to another is refused at
    ``submit``; use another engine).  Threads start at the first submit;
    ``close()`` (or leaving the context) drains and joins them."""

    def __init__(self, engine: ServeEngine, *, queue_depth: int = 4,
                 transfer_buffers: int = 4):
        if queue_depth < 1 or transfer_buffers < 1:
            raise ValueError("queue_depth and transfer_buffers must be >= 1")
        self.engine = engine
        self.buffers = TransferBufferPool(transfer_buffers, engine.capacity)
        self.ingress_q = WorkQueue("ingress")                     # admission
        self.staged_q = WorkQueue("staged", maxsize=queue_depth)  # device
        self.emit_q = WorkQueue("emit", maxsize=queue_depth)      # emission
        self.finish_q = WorkQueue("finish")                       # device
        self._sched: _GroupScheduler | None = None
        self._threads: list[threading.Thread] = []
        self._wake = threading.Event()
        self._closed = False
        self._error: BaseException | None = None
        self._lock = threading.Lock()
        self._bufs: dict[int, TransferBuffer] = {}   # rid -> staged buffer

    # -- lifecycle ----------------------------------------------------------

    def _ensure_started(self) -> None:
        # under the lock: threads submitting at once start one pipeline
        with self._lock:
            if self._threads:
                return
            self._sched = _GroupScheduler(self.engine, [],
                                          self.engine.backend.name)
            for name, fn in (("admission", self._admission_loop),
                             ("device", self._device_loop),
                             ("emission", self._emission_loop)):
                t = threading.Thread(target=fn, name=f"serve-{name}",
                                     daemon=True)
                t.start()
                self._threads.append(t)

    def _check_error(self) -> None:
        if self._error is not None:
            raise RuntimeError("serving pipeline failed") from self._error

    def close(self) -> None:
        """Drain in-flight requests, stop the pipeline, join the threads."""
        if self._closed:
            for t in self._threads:
                t.join(timeout=60.0)
            self._check_error()
            return
        self._closed = True
        if self._threads:
            self.ingress_q.put(_SENTINEL)
            self._wake.set()
            for t in self._threads:
                t.join(timeout=60.0)
        eng = self.engine
        if self._sched is not None and eng._pool is not None:
            eng.stats["peak_pages_used"] = max(
                eng.stats["peak_pages_used"],
                eng.num_pages - 1 - eng._pool.min_free)
        self._check_error()

    def __enter__(self) -> "AsyncServeRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- public API ---------------------------------------------------------

    def submit(self, request: Request) -> RequestHandle:
        """Validate (raises here, on the caller's thread) and hand the
        request to the pipeline; returns a handle at once."""
        if self._closed:
            raise RuntimeError("runtime is closed")
        self._check_error()
        resolved = self.engine.resolve_request(request)
        if resolved.name != self.engine.backend.name:
            raise ValueError(
                f"async runtime serves the engine backend "
                f"{self.engine.backend.name!r}; request asked for "
                f"{resolved.name!r} (use a separate engine)")
        self.engine._validate(request)
        handle = RequestHandle(request, self)
        self._ensure_started()
        self.ingress_q.put(request)
        return handle

    def stream(self, request: Request, timeout: float = 60.0):
        """Submit and iterate: token ids live, the finish reason as the
        generator's return value."""
        return self.submit(request).stream(timeout=timeout)

    def run(self, requests: list[Request]) -> list[Request]:
        """Submit a batch and wait until every request has finished; the
        runtime stays open."""
        handles = [self.submit(r) for r in requests]
        for h in handles:
            h.result(timeout=600.0)
        return requests

    # -- pipeline threads ---------------------------------------------------

    def _admission_loop(self) -> None:
        try:
            while True:
                item = self.ingress_q.get(timeout=0.1)
                if item is _SENTINEL:
                    self.staged_q.put(_SENTINEL)
                    return
                if item is None:
                    if self._error is not None:
                        return
                    continue
                buf = self.buffers.acquire()     # backpressure lives here
                buf.stage(item.prompt)
                self._bufs[item.rid] = buf
                self.staged_q.put(item)
                self._wake.set()
        except BaseException as e:      # pragma: no cover - defensive
            self._fail(e)

    def _device_loop(self) -> None:
        sched = self._sched
        dev = self.engine.params["embed"].device     # with its index
        try:
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            with torch.inference_mode(), GB.use_backend(sched.backend_name):
                closing = False
                while True:
                    progressed = False
                    while (s := self.finish_q.get()) is not None:
                        sched.release(s)
                        progressed = True
                    while (r := self.staged_q.get()) is not None:
                        if r is _SENTINEL:
                            closing = True
                        else:
                            sched.waiting.append(r)
                            progressed = True
                    admit = sched.try_admit()
                    if admit:
                        snap = [(s, sched.owner[s]) for s in admit]
                        ptoks = sched.dispatch_prefill(admit)
                        for s in admit:
                            buf = self._bufs.pop(sched.owner[s].rid, None)
                            if buf is not None:
                                self.buffers.release(buf)
                        self.emit_q.put(("prefill", snap,
                                         *_tokens_to_host(ptoks)))
                        progressed = True
                    out = sched.dispatch_decode()
                    if out is not None:
                        toks, snap = out
                        self.emit_q.put(("decode", snap,
                                         *_tokens_to_host(toks)))
                        progressed = True
                    if not progressed:
                        if closing and not sched.has_work():
                            self.emit_q.put(_SENTINEL)
                            return
                        self._wake.wait(0.002)
                        self._wake.clear()
        except BaseException as e:
            self._fail(e)
            self.emit_q.put(_SENTINEL)

    def _emission_loop(self) -> None:
        sched = self._sched
        try:
            while True:
                item = self.emit_q.get(timeout=0.1)
                if item is _SENTINEL:
                    return
                if item is None:
                    if self._error is not None:
                        return
                    continue
                kind, snap, host_toks, event = item
                if event is not None:
                    event.synchronize()          # the pipeline's only sync
                np_toks = host_toks.numpy()
                if kind == "prefill":
                    finished = sched.emit_prefill(snap, np_toks)
                else:
                    finished = sched.emit_decode(snap, np_toks)
                for s in finished:
                    self.finish_q.put(s)
                if finished:
                    self._wake.set()
        except BaseException as e:      # pragma: no cover - defensive
            self._fail(e)

    def _fail(self, exc: BaseException) -> None:
        """The first failure wins: record it, end every unfinished request
        with ``"error"`` and unblock the other stages."""
        with self._lock:
            if self._error is None:
                self._error = exc
        sched = self._sched
        seen = []
        if sched is not None:
            seen = sched.in_flight() + list(sched.waiting)
        while (r := self.ingress_q.get()) is not None:
            if r is not _SENTINEL:
                seen.append(r)
        while (r := self.staged_q.get()) is not None:
            if r is not _SENTINEL:
                seen.append(r)
        for r in seen:
            if isinstance(r, Request) and not r.done:
                _finish_request(r, "error")
        self._wake.set()
