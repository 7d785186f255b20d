"""Paged, continuously batched serving engine (greedy decoding).

Mirrors the synchronous path of ``repro/serve/engine.py``
(``ServeEngine.generate`` with ``_GroupScheduler``):

* **admission** — FIFO under the page budget: the head of the queue waits
  (``stats['blocked_admissions']``) and later requests do not jump it; a
  finished request's slot and pages return at once, so slots refill;
* **prefill** — one whole-prompt forward per admitted batch, bucketed to
  power-of-two ``(batch, seq)`` shapes, the seq bucket clamped to the page
  table's width;
* **decode** — one single-token step over the full slot array with every
  request at its own position; inactive slots point at the trash page, and
  slots that already wrote their last reserved position are routed there
  too ("frozen"), so they cannot touch live pages;
* **emission** — the only host sync: token ids to Python, EOS/limit
  decisions.

The grouped-GEMM backend (``moe_impl="blaze"``) is resolved once at
construction (engine argument > active ``use_backend`` scope >
``cfg.gmm_backend`` > ``REPRO_GMM_BACKEND`` > auto) and held in
``self.backend``; ``generate`` runs inside ``use_backend`` of it.

Not ported yet, and refused: prefix sharing with copy-on-write pages, int8
KV pages, temperature sampling (at construction), per-request grouped-GEMM
backends (at ``generate``).  The async runtime and its streaming callbacks
are not ported either.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import gmm_backend as GB
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.moe_block import check_supported as check_moe
from repro_torch.serve import paged_cache as PC


@dataclass
class Request:
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 32
    eos_id: int = 2
    out_tokens: list = field(default_factory=list)
    done: bool = False
    finish_reason: str | None = None    # "eos" | "length" | "error"
    gmm_backend: str | None = None      # per-request override (not ported)


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _finish_request(r: Request, reason: str) -> None:
    r.done = True
    if r.finish_reason is None:
        r.finish_reason = reason


def _params_device(params) -> torch.device:
    return params["embed"].device


class ServeEngine:
    """Greedy paged serving of ``cfg`` with ``params`` on ``device``
    (default ``"cuda"``; raises when no card is present)."""

    def __init__(self, cfg, params, *, batch_slots: int = 4,
                 capacity: int = 512, page_size: int = 16,
                 num_pages: int | None = None, kv_dtype: str | None = None,
                 greedy: bool = True, prefix_cache: bool = False,
                 gmm_backend: str | None = None, device=None):
        self.device = resolve_device(device)
        self.backend = GB.resolve(gmm_backend, config=cfg.gmm_backend)
        cfg = cfg.replace(gmm_backend=self.backend.name)
        if kv_dtype not in (None, "model"):
            raise NotImplementedError(
                f"kv_dtype={kv_dtype!r}: int8 KV pages are not ported yet "
                "(ROADMAP queue A, serving)")
        if not greedy:
            raise NotImplementedError(
                "temperature sampling is not ported yet; the port decodes "
                "greedily (ROADMAP queue A, serving)")
        if prefix_cache:
            raise NotImplementedError(
                "prefix sharing with copy-on-write pages is not ported yet "
                "(ROADMAP queue A, serving)")
        T.check_supported(cfg)
        if cfg.is_moe:
            check_moe(cfg)
        pdev = _params_device(params)
        if pdev.type != self.device.type or (
                self.device.index is not None and pdev != self.device):
            raise ValueError(f"params live on {pdev}, the engine runs on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.capacity = capacity
        self.page_size = page_size
        self.pages_per_seq = PC.pages_needed(capacity, page_size)
        self.num_pages = (num_pages if num_pages is not None
                          else 1 + batch_slots * self.pages_per_seq)
        if self.num_pages < 2:
            raise ValueError("num_pages must be >= 2 (one is the trash page)")
        self._pool: PC.PagePool | None = None
        self._cache = None
        self.stats = {"prefill_calls": 0, "prefill_tokens": 0,
                      "decode_steps": 0, "decode_slot_tokens": 0,
                      "generated_tokens": 0, "blocked_admissions": 0,
                      "truncated_budgets": 0, "peak_pages_used": 0}

    def _ensure_state(self) -> None:
        if self._pool is None:
            self._pool = PC.PagePool(self.num_pages)
            self._cache = T.init_paged_cache(self.cfg, self.num_pages,
                                             self.page_size,
                                             _params_device(self.params))

    def _limit(self, request: Request) -> int:
        """New-token budget: the cache holds ``prompt + (T - 1)`` written
        tokens for T generated, bounded by ``capacity``."""
        return min(request.max_new_tokens,
                   self.capacity - request.prompt.size + 1)

    def _validate(self, request: Request) -> None:
        if request.gmm_backend is not None:
            raise NotImplementedError(
                "a per-request gmm_backend is not ported; the engine serves "
                f"with its own ({self.backend.name}) (ROADMAP queue A5)")
        if request.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {request.max_new_tokens} "
                f"(prefill always samples one token)")
        if request.prompt.size > self.capacity:
            raise ValueError(
                f"prompt of {request.prompt.size} tokens exceeds engine "
                f"capacity {self.capacity}")
        need = PC.pages_needed(
            request.prompt.size + self._limit(request) - 1, self.page_size)
        if need > self.num_pages - 1:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.num_pages - 1} allocatable pages")

    @torch.inference_mode()
    def generate(self, requests: list[Request]) -> list[Request]:
        """Serve ``requests`` to completion (validated up front, before any
        device work); returns them with ``out_tokens`` filled."""
        for r in requests:
            self._validate(r)
        with GB.use_backend(self.backend.name):
            return self._generate(requests)

    def _generate(self, requests: list[Request]) -> list[Request]:
        sched = _Scheduler(self, requests)
        try:
            while sched.has_work():
                admit = sched.try_admit()
                if admit:
                    snap = [(s, sched.owner[s]) for s in admit]
                    toks = sched.prefill(admit)
                    for s in sched.emit_prefill(snap, toks):
                        sched.release(s)
                out = sched.decode()
                if out is None:
                    continue
                toks, live = out
                for s in sched.emit_decode(live, toks):
                    sched.release(s)
        except Exception:
            for r in sched.in_flight() + list(sched.waiting):
                if not r.done:
                    _finish_request(r, "error")
            raise
        self.stats["peak_pages_used"] = max(
            self.stats["peak_pages_used"],
            self.num_pages - 1 - self._pool.min_free)
        return requests


class _Scheduler:
    """Admission, device steps and emission for one ``generate`` call."""

    def __init__(self, eng: ServeEngine, requests: list[Request]):
        eng._ensure_state()
        self.eng = eng
        self.dev = _params_device(eng.params)
        self.pool = eng._pool
        self.ps = eng.page_size
        self.pps = eng.pages_per_seq
        n = eng.slots
        self.waiting: deque[Request] = deque(requests)
        self.free_slots = list(range(n - 1, -1, -1))
        self.owner: list[Request | None] = [None] * n
        self.mapped_pages: list[list[int] | None] = [None] * n
        self.cap_of = np.zeros(n, np.int32)     # max tokens ever written
        self.page_table = np.full((n, self.pps), PC.TRASH_PAGE, np.int32)
        self.lengths = np.zeros(n, np.int32)    # tokens in cache
        self.last_tok = torch.zeros((n, 1), dtype=torch.long,
                                    device=self.dev)

    def has_work(self) -> bool:
        return bool(self.waiting) or any(o is not None for o in self.owner)

    def in_flight(self) -> list[Request]:
        return [o for o in self.owner if o is not None]

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    # -- admission ----------------------------------------------------------

    def try_admit(self) -> list[int]:
        eng = self.eng
        admit: list[int] = []
        while self.waiting and self.free_slots:
            r = self.waiting[0]
            plen = int(r.prompt.size)
            limit = eng._limit(r)
            need = PC.pages_needed(plen + limit - 1, self.ps)
            if need > self.pool.free_pages:
                eng.stats["blocked_admissions"] += 1
                break
            self.waiting.popleft()
            if limit < r.max_new_tokens:
                eng.stats["truncated_budgets"] += 1
            slot = self.free_slots.pop()
            pages = self.pool.alloc(need)
            self.page_table[slot] = PC.TRASH_PAGE
            self.page_table[slot, :need] = pages
            self.owner[slot] = r
            self.mapped_pages[slot] = pages
            self.cap_of[slot] = plen + limit - 1
            self.lengths[slot] = 0
            admit.append(slot)
        return admit

    # -- device steps -------------------------------------------------------

    def prefill(self, admit: list[int]) -> list[int]:
        """One prefill over the admitted batch; returns the greedy first
        token of each admitted request."""
        eng = self.eng
        plens = [self.owner[s].prompt.size for s in admit]
        sb = min(_pow2(max(plens)), self.pps * self.ps)
        bb = _pow2(len(admit))
        toks = np.zeros((bb, sb), np.int32)
        lens = np.zeros(bb, np.int32)
        pt = np.full((bb, self.pps), PC.TRASH_PAGE, np.int32)
        for i, s in enumerate(admit):
            prompt = self.owner[s].prompt
            toks[i, :prompt.size] = prompt
            lens[i] = prompt.size
            pt[i] = self.page_table[s]
        logits = T.prefill(eng.params, self._tensor(toks),
                           self._tensor(lens), eng._cache,
                           self._tensor(pt), eng.cfg)
        first = torch.argmax(logits[:len(admit)], dim=-1)
        eng.stats["prefill_calls"] += 1
        eng.stats["prefill_tokens"] += int(lens.sum())
        slots = torch.as_tensor(admit, dtype=torch.long, device=self.dev)
        self.last_tok[slots, 0] = first
        for s in admit:
            self.lengths[s] = self.owner[s].prompt.size
        return first.tolist()

    def decode(self):
        """One decode step over the full slot array; ``None`` when no slot
        is live.  Returns (tokens per slot, live slots)."""
        eng = self.eng
        live = [s for s in range(eng.slots)
                if self.owner[s] is not None
                and self.lengths[s] < self.cap_of[s]]
        if not live:
            return None
        lens_step = self.lengths.copy()
        pt_step = self.page_table.copy()
        for s in range(eng.slots):
            if self.owner[s] is not None and s not in live:   # frozen
                lens_step[s] = 0
                pt_step[s] = PC.TRASH_PAGE
        logits = T.paged_decode_step(eng.params, eng._cache, self.last_tok,
                                     self._tensor(lens_step),
                                     self._tensor(pt_step), eng.cfg)
        toks = torch.argmax(logits, dim=-1)
        self.last_tok = toks[:, None]
        eng.stats["decode_steps"] += 1
        eng.stats["decode_slot_tokens"] += len(live)
        for s in live:
            self.lengths[s] += 1
        return toks.tolist(), live

    # -- emission -----------------------------------------------------------

    def _emit_one(self, r: Request, tok: int) -> bool:
        eng = self.eng
        r.out_tokens.append(tok)
        eng.stats["generated_tokens"] += 1
        if tok == r.eos_id:
            _finish_request(r, "eos")
        elif len(r.out_tokens) >= eng._limit(r):
            _finish_request(r, "length")
        return r.done

    def emit_prefill(self, snap, toks: list[int]) -> list[int]:
        return [s for i, (s, r) in enumerate(snap)
                if self._emit_one(r, toks[i])]

    def emit_decode(self, live: list[int], toks: list[int]) -> list[int]:
        return [s for s in live if self._emit_one(self.owner[s], toks[s])]

    def release(self, slot: int) -> None:
        """Return a finished slot's pages; stale table entries are reset so
        they cannot alias pages the pool hands out next."""
        self.pool.free(self.mapped_pages[slot])
        self.owner[slot] = None
        self.mapped_pages[slot] = None
        self.page_table[slot, :] = PC.TRASH_PAGE
        self.lengths[slot] = 0
        self.cap_of[slot] = 0
        self.free_slots.append(slot)
