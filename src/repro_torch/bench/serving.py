"""Serving-engine benchmark suite — the paged-KV decode story as tracked,
gated numbers.

The port's counterpart of ``repro/bench/serving.py``, with its entries,
gates and bounds, on the bench MoE config and weights drawn from seed 0
(``interop.init_params``; the reference's differ, so its tokens do, but
every deterministic entry depends on the tokens only through the
requests' lengths).  On the card the engine runs the port's kernels
(dispatch, gather-GMM, paged attention; flash attention at prefill where
the config asks for it).

* ``serving/parity/*`` — the left-pad regression, run as a measurement:
  a mixed-prompt-length batch through the continuous scheduler vs each
  request solo, token-mismatch count (MUST be zero — batched output may not
  depend on batch-mates).
* ``serving/sched/*`` — continuous-batching accounting: decode slot-steps
  must equal ``sum(T_r - 1)`` exactly (finished requests burn no decode
  FLOPs, one prefill logit per request), plus blocked-admission and
  page-pool stats under a page budget.
* ``serving/kv/*`` — MEASURED cache bytes (``kv_quant.cache_bytes`` over
  the actual tensors): the int8 paged pool vs dense bf16 slots
  (``transformer.init_cache``), per cached token.  The same-run gate
  requires >= 1.8x fewer bytes per token, and throughput (tokens/s) rides
  along informationally.
* ``serving/prefix/*`` — copy-on-write prefix sharing: a page-aligned
  same-prompt pair through a ``prefix_cache=True`` engine vs the
  no-sharing cost.  The same-run gate requires the pair's measured
  ``prefill_tokens`` to undercut 2x solo by AT LEAST one full page, with
  exact token parity against the solo run (sharing may not change tokens).
* ``serving/pipeline/*`` — the async three-stage runtime
  (``serve.runtime.AsyncServeRuntime``) vs the synchronous engine on the
  same requests: token mismatches (same-run gate: MUST be zero — the
  pipelined scheduler is token-identical under a fixed seed) plus
  pipelined throughput informationally.

The deterministic entries (byte counts, scheduler counts, parity) are
baseline-gated at 0% tolerance; wall-clock entries are informational.
``serving_gate_failures`` adds the baseline-independent same-run pairings,
like ``timing.fused_gate_failures`` and ``memory.sim_parity_failures``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.bench.memory import bench_config
from repro_torch.bench.record import entry
from repro_torch.core import memsim
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve import kv_quant as KQ
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.runtime import AsyncServeRuntime

#: required measured-bytes advantage of the int8 paged pool over bf16 dense
#: slots, per cached token (the acceptance bar's number).
INT8_KV_RATIO_MIN = 1.8

_SLOTS = 2
_CAPACITY = 64
_PAGE_SIZE = 8


def _prompts(cfg, n: int, *, seed: int = 0) -> list[np.ndarray]:
    """Mixed-length prompts (the shape that exposed the left-pad bug)."""
    rng = np.random.default_rng(seed)
    lens = [1 + (3 * i) % 8 for i in range(n)]
    return [rng.integers(1, cfg.vocab_size, size=L).astype(np.int32)
            for L in lens]


def _requests(prompts, cfg, max_new: int) -> list[Request]:
    # eos_id outside the vocab: every request runs to max_new_tokens, so the
    # scheduler counts below are exact and version-independent.
    return [Request(prompt=p, max_new_tokens=max_new, eos_id=cfg.vocab_size)
            for p in prompts]


def _mismatches(got: list[Request], want: list[Request]) -> int:
    n = 0
    for a, b in zip(got, want):
        n += sum(x != y for x, y in zip(a.out_tokens, b.out_tokens))
        n += abs(len(a.out_tokens) - len(b.out_tokens))
    return n


def serving_suite(*, small: bool = False, device=None) -> list:
    from repro_torch.interop import init_params
    dev = resolve_device(device)
    cfg = bench_config()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    n_req = 4 if small else 8
    max_new = 5 if small else 9
    prompts = _prompts(cfg, n_req)

    def engine(**kw) -> ServeEngine:
        kw = {"batch_slots": _SLOTS, **kw}
        return ServeEngine(cfg, params, capacity=_CAPACITY,
                           page_size=_PAGE_SIZE, device=dev, **kw)

    # -- batched-vs-solo parity (the left-pad bug, measured) ----------------
    batched = engine()
    b_reqs = _requests(prompts, cfg, max_new)
    t0 = time.perf_counter()
    batched.generate(b_reqs)
    batched_s = time.perf_counter() - t0
    mismatches = 0
    for p, r in zip(prompts, b_reqs):
        s_req = engine().generate(_requests([p], cfg, max_new))
        mismatches += _mismatches([r], s_req)

    # -- continuous-scheduler accounting ------------------------------------
    st = batched.stats
    expected_slot_tokens = sum(len(r.out_tokens) - 1 for r in b_reqs)
    gen_tokens = sum(len(r.out_tokens) for r in b_reqs)

    # -- measured KV bytes: int8 paged pool vs dense bf16 slots -------------
    num_pages = batched.num_pages
    paged_int8 = T.init_paged_cache(cfg, num_pages, _PAGE_SIZE, dev,
                                    quantized=True)
    dense_bf16 = T.init_cache(cfg.replace(dtype="bfloat16"), _SLOTS,
                              _CAPACITY, dev)
    int8_per_tok = KQ.cache_bytes(paged_int8) / (num_pages * _PAGE_SIZE)
    bf16_per_tok = KQ.cache_bytes(dense_bf16) / (_SLOTS * _CAPACITY)
    del paged_int8, dense_bf16

    # -- int8 engine: same requests, tokens/s + stats ------------------------
    int8_eng = engine(kv_dtype="int8")
    i_reqs = _requests(prompts, cfg, max_new)
    t0 = time.perf_counter()
    int8_eng.generate(i_reqs)
    int8_s = time.perf_counter() - t0
    int8_gen = sum(len(r.out_tokens) for r in i_reqs)

    sim = memsim.simulate_serve(
        cfg, batch_slots=_SLOTS, num_pages=num_pages, page_size=_PAGE_SIZE,
        prefill_tokens=max(p.size for p in prompts), quantized=False)

    # -- prefix sharing: page-aligned pair vs no-sharing ---------------------
    # One prompt of exactly two full pages, served twice through a
    # prefix_cache engine (batch_slots=1 so the first finishes — and
    # donates its pages — before the second is admitted).  The second
    # request maps both pages read-only and re-feeds only its last prompt
    # token into a COW fork, so the pair's prefill_tokens undercuts 2x the
    # solo cost by a page-and-change.
    prng = np.random.default_rng(1)
    shared_prompt = prng.integers(1, cfg.vocab_size,
                                  size=2 * _PAGE_SIZE).astype(np.int32)
    solo_pre = engine(batch_slots=1)
    solo_req = solo_pre.generate(_requests([shared_prompt], cfg, max_new))
    nosharing_pt = 2 * solo_pre.stats["prefill_tokens"]
    pre_eng = engine(batch_slots=1, prefix_cache=True)
    pre_reqs = _requests([shared_prompt, shared_prompt], cfg, max_new)
    for r in pre_reqs:
        pre_eng.enqueue(r)
    pre_eng.run()
    pst = pre_eng.stats
    prefix_mismatches = _mismatches(pre_reqs, solo_req * 2)
    sim_noshare = memsim.simulate_serve(
        cfg, batch_slots=_SLOTS, num_pages=num_pages, page_size=_PAGE_SIZE,
        prefill_tokens=2 * _PAGE_SIZE, quantized=False)
    sim_shared = memsim.simulate_serve(
        cfg, batch_slots=_SLOTS, num_pages=num_pages, page_size=_PAGE_SIZE,
        prefill_tokens=2 * _PAGE_SIZE, shared_pages=2, quantized=False)

    # -- pipelined async runtime vs the synchronous engine -------------------
    async_eng = engine()
    a_reqs = _requests(prompts, cfg, max_new)
    t0 = time.perf_counter()
    with AsyncServeRuntime(async_eng, queue_depth=2,
                           transfer_buffers=2) as rt:
        rt.run(a_reqs)
    async_s = time.perf_counter() - t0
    async_gen = sum(len(r.out_tokens) for r in a_reqs)
    async_mismatches = _mismatches(a_reqs, b_reqs)

    det = dict(kind="serving", tolerance_pct=0.0)
    info = dict(kind="serving", tolerance_pct=None)
    return [
        entry("serving/parity/mismatched_tokens", mismatches, unit="tokens",
              n_requests=n_req, max_new=max_new, **det),
        entry("serving/sched/decode_slot_tokens", st["decode_slot_tokens"],
              unit="tokens", **det),
        entry("serving/sched/expected_slot_tokens", expected_slot_tokens,
              unit="tokens", **det),
        entry("serving/sched/decode_steps", st["decode_steps"],
              unit="steps", **det),
        entry("serving/sched/blocked_admissions", st["blocked_admissions"],
              unit="events", **info),
        entry("serving/sched/peak_pages_used", st["peak_pages_used"],
              unit="pages", num_pages=num_pages, **det),
        entry("serving/kv/int8_paged_bytes_per_token", int8_per_tok,
              unit="bytes", num_pages=num_pages, page_size=_PAGE_SIZE,
              **det),
        entry("serving/kv/bf16_dense_bytes_per_token", bf16_per_tok,
              unit="bytes", slots=_SLOTS, capacity=_CAPACITY, **det),
        entry("serving/kv/sim_serve_peak_bytes", sim.peak_bytes,
              unit="bytes", peak_phase=sim.peak_phase, **det),
        entry("serving/throughput/tokens_per_s",
              gen_tokens / max(batched_s, 1e-9), unit="tokens/s",
              generated=gen_tokens, **info),
        entry("serving/throughput/int8_tokens_per_s",
              int8_gen / max(int8_s, 1e-9), unit="tokens/s",
              generated=int8_gen, **info),
        entry("serving/prefix/prefill_tokens_nosharing", nosharing_pt,
              unit="tokens", prompt_pages=2, page_size=_PAGE_SIZE, **det),
        entry("serving/prefix/prefill_tokens_shared", pst["prefill_tokens"],
              unit="tokens", prompt_pages=2, page_size=_PAGE_SIZE, **det),
        entry("serving/prefix/hits", pst["prefix_hits"], unit="hits",
              misses=pst["prefix_misses"],
              shared_pages=pst["shared_pages_mapped"], **det),
        entry("serving/prefix/cow_forks", pst["cow_forks"], unit="forks",
              **det),
        entry("serving/prefix/mismatched_tokens", prefix_mismatches,
              unit="tokens", **det),
        entry("serving/kv/sim_shared_prefill_bytes",
              sim_shared.phases[0].held_bytes
              + sim_shared.phases[0].transient_bytes, unit="bytes",
              nosharing_prefill_bytes=sim_noshare.phases[0].held_bytes
              + sim_noshare.phases[0].transient_bytes, shared_pages=2,
              **det),
        entry("serving/pipeline/async_sync_mismatches", async_mismatches,
              unit="tokens", n_requests=n_req, **det),
        entry("serving/pipeline/async_tokens_per_s",
              async_gen / max(async_s, 1e-9), unit="tokens/s",
              generated=async_gen, **info),
    ]


def serving_gate_failures(entries: list) -> list:
    """Baseline-independent same-run gates for the serving leg:

    1. batched-vs-solo token parity must be EXACT (the left-pad bugfix);
    2. decode slot-steps must equal ``sum(T_r - 1)`` — finished requests may
       not burn decode FLOPs;
    3. the measured int8 paged pool must be >= ``INT8_KV_RATIO_MIN``x
       smaller per cached token than dense bf16 slots;
    4. a page-aligned shared-prefix pair must prefill STRICTLY fewer tokens
       than 2x solo — by at least one full page — with exact token parity
       (prefix sharing is a cost optimization, never a numerics change);
    5. the pipelined async runtime must be token-identical to the
       synchronous engine on the same requests under the fixed seed.

    Returns human-readable failure lines (empty == all gates hold)."""
    by_name = {e["name"]: e for e in entries}
    need = ("serving/parity/mismatched_tokens",
            "serving/sched/decode_slot_tokens",
            "serving/sched/expected_slot_tokens",
            "serving/kv/int8_paged_bytes_per_token",
            "serving/kv/bf16_dense_bytes_per_token",
            "serving/prefix/prefill_tokens_nosharing",
            "serving/prefix/prefill_tokens_shared",
            "serving/prefix/mismatched_tokens",
            "serving/pipeline/async_sync_mismatches")
    if not any(n in by_name for n in need):
        # No serving family at all (synthetic/legacy record): nothing to
        # pair.  Fresh runs always emit the family via ``serving_suite``.
        return []
    if not all(n in by_name for n in need):
        return ["SERVING serving/* family incomplete in this run "
                "(regenerate the record with the current suite)"]
    fails = []
    par = by_name["serving/parity/mismatched_tokens"]["value"]
    if par != 0:
        fails.append(f"SERVING parity: {int(par)} token(s) differ between "
                     "batched and solo runs; batched output must not depend "
                     "on batch-mates")
    got = by_name["serving/sched/decode_slot_tokens"]["value"]
    want = by_name["serving/sched/expected_slot_tokens"]["value"]
    if got != want:
        fails.append(f"SERVING scheduler: {int(got)} decode slot-tokens vs "
                     f"sum(T_r - 1) = {int(want)}; finished requests must "
                     "release their slots")
    int8 = by_name["serving/kv/int8_paged_bytes_per_token"]["value"]
    bf16 = by_name["serving/kv/bf16_dense_bytes_per_token"]["value"]
    ratio = bf16 / max(int8, 1e-9)
    if ratio < INT8_KV_RATIO_MIN:
        fails.append(f"SERVING kv bytes: int8 paged pool is only {ratio:.2f}x"
                     f" smaller per token than dense bf16 slots "
                     f"(need >= {INT8_KV_RATIO_MIN}x)")
    noshare = by_name["serving/prefix/prefill_tokens_nosharing"]["value"]
    shared = by_name["serving/prefix/prefill_tokens_shared"]["value"]
    page = by_name["serving/prefix/prefill_tokens_shared"]["meta"].get(
        "page_size", _PAGE_SIZE)
    if noshare - shared < page:
        fails.append(f"SERVING prefix: shared pair prefilled {int(shared)} "
                     f"tokens vs {int(noshare)} without sharing; must save "
                     f"at least one full page ({int(page)} tokens)")
    pmis = by_name["serving/prefix/mismatched_tokens"]["value"]
    if pmis != 0:
        fails.append(f"SERVING prefix: {int(pmis)} token(s) differ between "
                     "shared-prefix and solo runs; COW sharing must not "
                     "change tokens")
    amis = by_name["serving/pipeline/async_sync_mismatches"]["value"]
    if amis != 0:
        fails.append(f"SERVING pipeline: {int(amis)} token(s) differ "
                     "between the async runtime and the synchronous engine; "
                     "the pipelined scheduler must be token-identical under "
                     "a fixed seed")
    return fails
