"""Paged, continuously batched serving engine.

Mirrors ``repro/serve/engine.py`` (``ServeEngine`` with
``_GroupScheduler``).  Requests enter a queue (``enqueue`` / ``run``) or
come as a batch (``generate``) and pass three stages:

* **admission** — FIFO under the page budget: the head of the queue waits
  (``stats['blocked_admissions']``) and later requests do not jump it; a
  finished request's slot and pages return at once, so slots refill.
  With ``prefix_cache=True`` each prompt's full-page chain is looked up in
  a :class:`~repro_torch.serve.paged_cache.PrefixCache` first: cached pages
  are mapped read-only (one pool reference each) and only the unshared
  suffix is prefilled; a prompt that the cache covers exactly re-feeds its
  last token into a copy-on-write fork of its last shared page
  (``paged_cache.copy_page``), so a sharer's page is never written.  Cache
  pages are evicted least-recently-used leaf first when admission needs
  their room;
* **device** — one whole-prompt (or suffix) prefill per admitted batch,
  bucketed to power-of-two ``(batch, seq)`` shapes with the seq bucket
  clamped to the page table's width, and one single-token decode step over
  the full slot array with every request at its own position.  Slots that
  already wrote their last reserved position ("frozen") are routed to the
  trash page.  Each step's host inputs cross in one upload (a fresh pinned
  buffer and a non-blocking copy on the card), and the sampled tokens stay
  on the device, feeding the next step: this stage never waits for the
  card;
* **emission** — the only host sync: token ids to Python, ``on_token`` /
  ``on_finish`` callbacks, EOS and budget decisions.

``generate`` runs the stages inline; ``serve/runtime.AsyncServeRuntime``
runs them on threads.

Sampling: greedy argmax, or (``greedy=False``) ``argmax(logits / T + g)``
with Gumbel noise ``g`` hashed from ``(seed, request id, token index)``
(``serve/sampling.py``), so a request's tokens never depend on batching or
scheduling.  The reference draws from ``fold_in(fold_in(seed, rid),
token_index)``; JAX's threefry stream is not reproducible in PyTorch, so
sampled tokens match the reference's distribution, not its draws.

The grouped-GEMM backend (``moe_impl="blaze"``) is resolved at
construction (engine argument > active ``use_backend`` scope >
``cfg.gmm_backend`` > ``REPRO_GMM_BACKEND`` > auto) and held in
``self.backend``; a ``Request`` may carry its own, validated at
``enqueue``, and ``generate`` serves each group of requests that resolve
to one backend inside ``use_backend`` of it.  The paged-attention
implementation (``paged_kernel`` > ``REPRO_PAGED_ATTN`` > auto: the kernel
on the card, ``dense`` on the CPU) and the checkpoint plan (engine
argument ``remat_policy`` > ``cfg.remat_policy``; decode runs no backward,
so the plan is provenance) are resolved at construction as well.

``kv_dtype="int8"`` stores the pools quantized with ``serve/kv_quant``'s
symmetric per-(position, head) scheme; ``kv_bytes_per_token`` reports the
pools' bytes per cached token as the reference's serving bench does.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from functools import partial
from typing import Callable

import numpy as np
import torch

from repro_torch.core import checkpoint as CK
from repro_torch.core import gmm_backend as GB
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.moe_block import check_supported as check_moe
from repro_torch.serve import paged_cache as PC
from repro_torch.serve import sampling
from repro_torch.serve.kv_quant import cache_bytes


@dataclass
class Request:
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 32
    eos_id: int = 2
    gmm_backend: str | None = None  # per-request override of the engine's
    on_token: Callable[[int], None] | None = None   # streaming: per token
    on_finish: Callable[[str], None] | None = None  # terminal event (reason)
    out_tokens: list = field(default_factory=list)
    done: bool = False
    finish_reason: str | None = None    # "eos" | "length" | "error"
    rid: int | None = None              # engine-assigned id (noise lane)


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _emit_token(r: Request, tok: int) -> None:
    r.out_tokens.append(tok)
    if r.on_token is not None:
        r.on_token(tok)


def _finish_request(r: Request, reason: str) -> None:
    r.done = True
    if r.finish_reason is None:
        r.finish_reason = reason
    if r.on_finish is not None:
        r.on_finish(reason)


def _params_device(params) -> torch.device:
    return params["unembed"].device


class ServeEngine:
    """Paged serving of ``cfg`` with ``params`` on ``device`` (default
    ``"cuda"``; raises when no card is present)."""

    def __init__(self, cfg, params, *, batch_slots: int = 4,
                 capacity: int = 512, page_size: int = 16,
                 num_pages: int | None = None, kv_dtype: str | None = None,
                 greedy: bool = True, temperature: float = 1.0,
                 seed: int = 0, gmm_backend: str | None = None,
                 prefix_cache: bool = False, paged_kernel: str | None = None,
                 remat_policy=None, device=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "serving over a mesh is not ported; the engine runs on one "
                "card (ROADMAP.md §A item 6: ServeEngine(mesh=...))")
        self.device = resolve_device(device)
        self.backend = GB.resolve(gmm_backend, config=cfg.gmm_backend)
        # an unknown paged kernel or an unparseable plan raises here, never
        # mid-generate
        self.paged_attn = PC.resolve_paged_attn(paged_kernel,
                                                device=self.device)
        self.remat_plan = CK.resolve_plan(remat_policy,
                                          config=cfg.remat_policy)
        cfg = cfg.replace(gmm_backend=self.backend.name,
                          remat_policy=self.remat_plan.spec)
        if not T.paged_supported(cfg):
            raise ValueError(
                f"ServeEngine pages attention KV; {cfg.name} has "
                f"block pattern {cfg.block_pattern} (SSM carries are O(1) "
                f"per-slot state — serve those via T.decode_step directly)")
        if kv_dtype not in (None, "model", "int8"):
            raise ValueError(f"kv_dtype must be None|'model'|'int8', "
                             f"got {kv_dtype!r}")
        if not greedy and temperature <= 0:
            raise ValueError("temperature must be > 0 for sampling")
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
        self.quantized = kv_dtype == "int8"
        self.pages_per_seq = PC.pages_needed(capacity, page_size)
        self.num_pages = (num_pages if num_pages is not None
                          else 1 + batch_slots * self.pages_per_seq)
        if self.num_pages < 2:
            raise ValueError("num_pages must be >= 2 (one is the trash page)")
        self.greedy = greedy
        self.temperature = temperature
        self.seed = seed
        self.pending: list[Request] = []
        # one next() is atomic, so threads submitting to the async runtime
        # never mint the same rid
        self._rid_counter = itertools.count()
        # the pool, the KV pages and the prefix trie live as long as the
        # engine (prefix hits span generate calls), created at first use
        self._pool: PC.PagePool | None = None
        self._cache = None
        self._prefix = PC.PrefixCache() if prefix_cache else None
        self._decode_fns: dict[str, Callable] = {}
        self._prefill_fns: dict[tuple, Callable] = {}
        self.stats = {"prefill_calls": 0, "prefill_tokens": 0,
                      "decode_steps": 0, "decode_slot_tokens": 0,
                      "generated_tokens": 0, "blocked_admissions": 0,
                      "truncated_budgets": 0, "peak_pages_used": 0,
                      "prefix_hits": 0, "prefix_misses": 0,
                      "shared_pages_mapped": 0, "cow_forks": 0,
                      "prefix_evictions": 0}

    # -- persistent device state --------------------------------------------

    def _ensure_state(self) -> None:
        if self._pool is None:
            self._pool = PC.PagePool(self.num_pages)
            self._cache = T.init_paged_cache(self.cfg, self.num_pages,
                                             self.page_size,
                                             _params_device(self.params),
                                             quantized=self.quantized)

    @property
    def kv_bytes_per_token(self) -> float:
        """KV bytes (values and scales) one cached token costs across all
        layers: the pools, allocated in full at first use, over their
        positions."""
        self._ensure_state()
        return cache_bytes(self._cache) / (self.num_pages * self.page_size)

    def _upload(self, *arrays) -> list[torch.Tensor]:
        """The host arrays as int32 tensors on the engine's device, in one
        copy: packed into a fresh buffer (pinned on the card, each piece at
        a 16-byte boundary) that nothing writes after the non-blocking
        copy is issued."""
        flat = [np.ascontiguousarray(a, np.int32).ravel() for a in arrays]
        starts, n = [], 0
        for f in flat:
            starts.append(n)
            n += -(-f.size // 4) * 4
        cuda = self.device.type == "cuda"
        host = torch.zeros(max(n, 1), dtype=torch.int32, pin_memory=cuda)
        hv = host.numpy()
        for f, s in zip(flat, starts):
            hv[s:s + f.size] = f
        dev = host.to(self.device, non_blocking=cuda)
        return [dev[s:s + f.size].view(np.shape(a))
                for a, f, s in zip(arrays, flat, starts)]

    def _keys(self, rid, gidx) -> np.ndarray:
        """The rows' noise keys of ``(seed, rid, token index)``, hashed on
        the host, as int32 bit patterns for the upload (zeros when
        greedy)."""
        if self.greedy:
            return np.zeros(np.shape(rid), np.int32)
        return sampling.row_keys(self.seed, rid, gidx).astype(
            np.uint32).view(np.int32)

    def _sample(self, logits, keys):
        """(B, vocab) logits -> (B,) token ids: argmax, or the Gumbel-max
        draw of each row's key at the engine's temperature."""
        if self.greedy:
            return torch.argmax(logits, dim=-1)
        noise = sampling.noise_from_keys(keys, logits.shape[-1])
        return sampling.sample(logits, noise, self.temperature)

    def _decode_for(self, backend_name: str) -> Callable:
        """The decode step of one backend's group, called with the engine
        first (the cached step holds no reference to it, so a dropped
        engine frees its weights and pools at once)."""
        fn = self._decode_fns.get(backend_name)
        if fn is None:
            fn = partial(_decode_step,
                         cfg=self.cfg.replace(gmm_backend=backend_name),
                         impl=self.paged_attn.name)
            self._decode_fns[backend_name] = fn
        return fn

    def _prefill_for(self, backend_name: str, prefix: bool) -> Callable:
        """The whole-prompt (or, with ``prefix``, unshared-suffix) prefill
        of one backend's group, called with the engine first."""
        key = (backend_name, prefix)
        fn = self._prefill_fns.get(key)
        if fn is None:
            fn = partial(_prefill_step,
                         cfg=self.cfg.replace(gmm_backend=backend_name),
                         impl=self.paged_attn.name, prefix=prefix)
            self._prefill_fns[key] = fn
        return fn

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write fork of one physical page in every layer's pool."""
        for pages in self._cache:
            PC.copy_page(pages, src, dst)

    # -- validation ---------------------------------------------------------

    def resolve_request(self, request: Request) -> GB.ResolvedBackend:
        """The backend a request decodes with: its own override at the
        call-site slot, else the engine's.  Raises on unknown or
        unavailable names."""
        if request.gmm_backend in (None, "", "auto"):
            return self.backend
        return GB.resolve(request.gmm_backend, config=self.cfg.gmm_backend)

    def _limit(self, request: Request) -> int:
        """New-token budget: the cache holds ``prompt + (T - 1)`` written
        tokens for T generated, bounded by ``capacity``."""
        return min(request.max_new_tokens,
                   self.capacity - request.prompt.size + 1)

    def _validate(self, request: Request) -> None:
        self.resolve_request(request)
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
        if request.rid is None:
            request.rid = next(self._rid_counter)

    # -- queue API ----------------------------------------------------------

    def enqueue(self, request: Request) -> Request:
        """Add a request to the pending queue; an unknown ``gmm_backend`` or
        a request that can never be scheduled raises here."""
        self._validate(request)
        self.pending.append(request)
        return request

    def run(self) -> list[Request]:
        """Serve the pending queue to completion."""
        batch = self.pending
        self.pending = []
        return self.generate(batch)

    # -- batched generation -------------------------------------------------

    @torch.inference_mode()
    def generate(self, requests: list[Request]) -> list[Request]:
        """Serve ``requests`` to completion (every one validated before any
        device work), each group of one resolved backend in turn; returns
        them with ``out_tokens`` filled."""
        for r in requests:
            self._validate(r)
        groups: dict[str, list[Request]] = {}
        for r in requests:
            groups.setdefault(self.resolve_request(r).name, []).append(r)
        for name, group in groups.items():
            self._serve_group(group, name)
        return requests

    def _serve_group(self, requests: list[Request], backend_name: str):
        """The three stages inline over one backend's group."""
        sched = _GroupScheduler(self, requests, backend_name)
        with GB.use_backend(backend_name):
            try:
                while sched.has_work():
                    admit = sched.try_admit()
                    if admit:
                        snap = [(s, sched.owner[s]) for s in admit]
                        ptoks = sched.dispatch_prefill(admit)
                        for s in sched.emit_prefill(snap,
                                                    ptoks.cpu().numpy()):
                            sched.release(s)
                    out = sched.dispatch_decode()
                    if out is None:
                        continue
                    toks, snap = out
                    for s in sched.emit_decode(snap, toks.cpu().numpy()):
                        sched.release(s)
            except Exception:
                for r in sched.in_flight() + list(sched.waiting):
                    if not r.done:
                        _finish_request(r, "error")
                raise
        self.stats["peak_pages_used"] = max(
            self.stats["peak_pages_used"],
            self.num_pages - 1 - self._pool.min_free)


def _decode_step(eng: ServeEngine, tok, lens, pt, keys, *, cfg, impl):
    """One decode step over the full slot array: logits, then tokens.
    ``T.paged_decode_step`` is looked up at each call."""
    logits = T.paged_decode_step(eng.params, eng._cache, tok, lens, pt, cfg,
                                 attn_impl=impl)
    return eng._sample(logits, keys)


def _prefill_step(eng: ServeEngine, tok, lens, pt, offs, keys, *, cfg, impl,
                  prefix: bool):
    """One prefill (suffixes at ``offs`` with ``prefix``): the logits at
    each last token, then tokens (token index 0)."""
    logits = T.prefill(eng.params, tok, lens, eng._cache, pt, cfg,
                       offsets=offs if prefix else None, attn_impl=impl)
    return eng._sample(logits, keys)


class _GroupScheduler:
    """Admission, device and emission stages for one backend's group.

    * admission — :meth:`try_admit` (FIFO under the page budget, prefix
      lookup, pinning, eviction, copy-on-write forks);
    * device — :meth:`dispatch_prefill` / :meth:`dispatch_decode`: one
      upload of the step's host inputs, the step, tokens left on the
      device (each step's tokens feed the next);
    * emission — :meth:`emit_prefill` / :meth:`emit_decode` on host token
      ids; :meth:`release` returns a finished slot's pages (donating full
      prompt pages to the prefix cache).

    The synchronous engine calls them back to back; the async runtime
    calls admission and device on one thread and emission on another.
    """

    def __init__(self, eng: ServeEngine, requests: list[Request],
                 backend_name: str):
        eng._ensure_state()
        self.eng = eng
        self.backend_name = backend_name
        self.pool = eng._pool
        self.ps = eng.page_size
        self.pps = eng.pages_per_seq
        n = eng.slots
        self.waiting: deque[Request] = deque(requests)
        self.free_slots = list(range(n - 1, -1, -1))
        self.owner: list[Request | None] = [None] * n
        self.mapped_pages: list[list[int] | None] = [None] * n
        self.shared_cols: list[dict | None] = [None] * n
        self.suffix_start = [0] * n
        self.cap_of = np.zeros(n, np.int32)     # max tokens ever written
        self.page_table = np.full((n, self.pps), PC.TRASH_PAGE, np.int32)
        self.lengths = np.zeros(n, np.int32)    # tokens in cache
        self.gen_count = np.zeros(n, np.int32)  # tokens produced (noise lane)
        self.rid = np.zeros(n, np.int32)
        self.last_tok = torch.zeros((n, 1), dtype=torch.long,
                                    device=_params_device(eng.params))
        self.decode_fn = eng._decode_for(backend_name)

    def has_work(self) -> bool:
        return bool(self.waiting) or any(o is not None for o in self.owner)

    def in_flight(self) -> list[Request]:
        return [o for o in self.owner if o is not None]

    # -- admission stage ----------------------------------------------------

    def try_admit(self) -> list[int]:
        """Admit waiting requests while slots and pages allow, in FIFO
        order.  With the prefix cache, a prompt's cached chain is pinned
        before any eviction, mapped read-only, and shrinks the private
        pages to the unshared suffix; a prompt the chain covers exactly
        re-feeds its last token into a fork of the last shared page."""
        eng = self.eng
        st = eng.stats
        admit: list[int] = []
        while self.waiting and self.free_slots:
            r = self.waiting[0]
            plen = int(r.prompt.size)
            limit = eng._limit(r)
            total_need = PC.pages_needed(plen + limit - 1, self.ps)

            def plan(shared):
                n_shared = len(shared)
                refeed = n_shared > 0 and n_shared * self.ps >= plen
                sstart = plen - 1 if refeed else n_shared * self.ps
                need_private = total_need - n_shared + (1 if refeed else 0)
                return n_shared, refeed, sstart, need_private

            shared: list[int] = []
            if eng._prefix is not None:
                shared = eng._prefix.lookup(PC.page_keys(r.prompt, self.ps))
                # pinned first: evict() frees only pages the cache alone
                # holds, so it cannot take the chain about to be mapped
                for pg in shared:
                    self.pool.share(pg)
            n_shared, refeed, sstart, need_private = plan(shared)
            if need_private > self.pool.free_pages and eng._prefix is not None:
                st["prefix_evictions"] += eng._prefix.evict(
                    self.pool, need_private - self.pool.free_pages)
                if need_private > self.pool.free_pages and shared:
                    # not enough outside the chain: trade sharing for room,
                    # evict again (the chain was just used, so it goes
                    # last) and re-plan on what survives
                    for pg in shared:
                        self.pool.release(pg)
                    st["prefix_evictions"] += eng._prefix.evict(
                        self.pool, total_need - self.pool.free_pages)
                    shared = eng._prefix.lookup(
                        PC.page_keys(r.prompt, self.ps))
                    for pg in shared:
                        self.pool.share(pg)
                    n_shared, refeed, sstart, need_private = plan(shared)
            if need_private > self.pool.free_pages:
                # the head waits; the cache keeps its own references
                for pg in shared:
                    self.pool.release(pg)
                st["blocked_admissions"] += 1
                break
            self.waiting.popleft()
            if limit < r.max_new_tokens:
                st["truncated_budgets"] += 1
            if eng._prefix is not None:
                st["prefix_hits" if n_shared else "prefix_misses"] += 1
                st["shared_pages_mapped"] += n_shared
            slot = self.free_slots.pop()
            priv = self.pool.alloc(need_private)
            row = np.full(self.pps, PC.TRASH_PAGE, np.int32)
            row[:n_shared] = shared
            n_tail = total_need - n_shared
            if n_tail:
                row[n_shared:total_need] = priv[:n_tail]
            self.owner[slot] = r
            self.mapped_pages[slot] = shared + priv
            self.shared_cols[slot] = {c: shared[c] for c in range(n_shared)}
            self.suffix_start[slot] = sstart
            self.cap_of[slot] = plen + limit - 1
            self.lengths[slot] = 0
            self.gen_count[slot] = 0
            self.rid[slot] = r.rid
            if refeed:
                self._fork(slot, n_shared - 1, priv[n_tail], row)
            self.page_table[slot] = row
            admit.append(slot)
        return admit

    def _fork(self, slot: int, col: int, new_page: int, row) -> None:
        """Copy-on-write: copy shared column ``col`` into ``new_page``,
        remap the writer's row and drop its reference on the original."""
        eng = self.eng
        old = self.shared_cols[slot].pop(col)
        eng._copy_page(old, new_page)
        row[col] = new_page
        self.pool.release(old)
        self.mapped_pages[slot].remove(old)
        eng.stats["cow_forks"] += 1

    # -- device stage -------------------------------------------------------

    def dispatch_prefill(self, admit: list[int]) -> torch.Tensor:
        """One prefill over the admitted batch (suffixes with the prefix
        cache).  Returns the (bucket,) sampled tokens on the device; the
        admitted slots' ``last_tok`` rows are set on the device."""
        eng = self.eng
        use_prefix = eng._prefix is not None
        sufs = [self.owner[s].prompt.size - self.suffix_start[s]
                for s in admit]
        sb = min(_pow2(max(sufs)), self.pps * self.ps)
        bb = _pow2(len(admit))
        toks = np.zeros((bb, sb), np.int32)
        lens = np.zeros(bb, np.int32)
        offs = np.zeros(bb, np.int32)
        rid = np.zeros(bb, np.int32)
        pt = np.full((bb, self.pps), PC.TRASH_PAGE, np.int32)
        for i, s in enumerate(admit):
            r = self.owner[s]
            suf = r.prompt[self.suffix_start[s]:]
            toks[i, :suf.size] = suf
            lens[i] = suf.size
            offs[i] = self.suffix_start[s]
            rid[i] = self.rid[s]
            pt[i] = self.page_table[s]
        d_toks, d_lens, d_pt, d_offs, d_keys, d_slots = eng._upload(
            toks, lens, pt, offs, eng._keys(rid, np.zeros_like(rid)),
            np.asarray(admit, np.int32))
        pf = eng._prefill_for(self.backend_name, use_prefix)
        ptoks = pf(eng, d_toks, d_lens, d_pt, d_offs, d_keys)
        eng.stats["prefill_calls"] += 1
        eng.stats["prefill_tokens"] += int(lens[:len(admit)].sum())
        self.last_tok[d_slots.long(), 0] = ptoks[:len(admit)]
        for s in admit:
            self.lengths[s] = self.owner[s].prompt.size
            self.gen_count[s] = 1
        return ptoks

    def dispatch_decode(self):
        """One decode step over the full slot array.  Frozen slots (their
        last reserved position written; the async runtime may run ahead of
        their finish) are routed to the trash page.  Returns ``(tokens on
        the device, [(slot, request, token index), ...])``, or ``None``
        when no slot is live."""
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
        d_lens, d_pt, d_keys = eng._upload(
            lens_step, pt_step, eng._keys(self.rid, self.gen_count))
        toks = self.decode_fn(eng, self.last_tok, d_lens, d_pt, d_keys)
        self.last_tok = toks[:, None]
        eng.stats["decode_steps"] += 1
        eng.stats["decode_slot_tokens"] += len(live)
        snap = [(s, self.owner[s], int(self.gen_count[s])) for s in live]
        for s in live:
            self.lengths[s] += 1
            self.gen_count[s] += 1
        return toks, snap

    # -- emission stage -----------------------------------------------------

    def _emit_one(self, r: Request, tok: int) -> bool:
        """Append and stream one token; True when the request finished
        (EOS or budget)."""
        eng = self.eng
        _emit_token(r, tok)
        eng.stats["generated_tokens"] += 1
        if tok == r.eos_id:
            _finish_request(r, "eos")
        elif len(r.out_tokens) >= eng._limit(r):
            _finish_request(r, "length")
        return r.done

    def emit_prefill(self, snap: list[tuple[int, Request]],
                     np_toks) -> list[int]:
        """Each admitted request's first token; returns slots to release."""
        finished = []
        for i, (s, r) in enumerate(snap):
            if r.done:       # async run-ahead: already terminal
                continue
            if self._emit_one(r, int(np_toks[i])):
                finished.append(s)
        return finished

    def emit_decode(self, snap: list[tuple[int, Request, int]],
                    np_toks) -> list[int]:
        """One decode step's tokens; returns slots to release.  Tokens of
        requests that finished since dispatch (async run-ahead) are
        dropped; the synchronous path never makes them."""
        finished = []
        for s, r, _tidx in snap:
            if r.done:
                continue
            if self._emit_one(r, int(np_toks[s])):
                finished.append(s)
        return finished

    def release(self, slot: int) -> None:
        """Return a finished slot's pages.  With the prefix cache its full
        prompt pages are offered to the trie first (which adopts one
        reference per new node); every other reference is dropped in one
        batch, keeping the LIFO reuse order.  Stale table entries are reset
        so they cannot alias pages handed out next."""
        eng = self.eng
        r = self.owner[slot]
        pages = self.mapped_pages[slot]
        adopted: set[int] = set()
        if eng._prefix is not None:
            n_full = r.prompt.size // self.ps
            chain = [int(self.page_table[slot, c]) for c in range(n_full)]
            adopted = eng._prefix.insert(
                PC.page_keys(r.prompt, self.ps), chain)
        self.pool.free([p for p in pages if p not in adopted])
        self.owner[slot] = None
        self.mapped_pages[slot] = None
        self.shared_cols[slot] = None
        self.page_table[slot, :] = PC.TRASH_PAGE
        self.lengths[slot] = 0
        self.cap_of[slot] = 0
        self.free_slots.append(slot)
