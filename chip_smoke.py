#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. card — the ``nvidia-smi`` name and power limit;
2. build — the four CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, in parallel);
3. parity — each kernel against its plain PyTorch version on the card, in
   bf16 at the serving slice's shapes (Mixtral-8x7B: d=4096, 32/8 heads of
   128, E=8, top-2, expert width 14336), plus edge cases: empty experts, all
   slots on one expert, slot counts that are not a multiple of the tile,
   position 0 and a dead page table;
4. timing — each kernel (median of warm runs, L2 flushed between runs) at
   the prefill and decode shapes, beside its plain version, its bound (the
   larger of bytes / 3.35 TB/s and operations / 989 TFLOP/s, from this
   run's inputs) and, where one PyTorch call computes the same function,
   that call;
5. end to end — Mixtral-8x7B at full width with the depth cut to 2 layers
   (random bf16 weights from seed 0; 32 layers would not fit one 80 GB
   card), served by the port's engine: 4 slots, capacity 1024, 16-token
   pages, 5 greedy requests (prompts of 37, 129, 300, 511 and 64 tokens, 16
   new tokens each; the 5th refills a slot), three times: cold, then warm
   (measured: every kernel's launch count must rise during this run), then
   traced with torch.profiler (device time by kernel, device busy share);
   all three must give the same tokens;
6. CPU cross-check — one 24-token prompt through the same weights copied
   to the CPU (plain versions there); prefill logits must agree with the
   card's within the bf16 tolerance below, with the same first token.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the
reference package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12          # dense bf16 tensor-core peak
BF16 = torch.bfloat16
EB = 2                           # bytes per bf16 element
# Kernel vs plain tolerances in bf16 (stated with their reasons):
#  gather-GMM: the same float32 sums in another order, rounded once to bf16
#    -> one bf16 step of the value (2^-7 relative) plus 1e-2 absolute;
#  combine: identical float32 rounding sequence -> exact (0);
#  paged attention: float32 softmax in another order, bf16 output -> 2e-2.
GMM_RTOL, GMM_ATOL = 2 ** -7, 1e-2
PAGED_ATOL = 2e-2
# CPU vs card logits: bf16 activations through 2 layers, rounded at other
# points and summed in other orders; logits of size ~4 have a bf16 step of
# 2^-5, so four steps.
CPU_LOGIT_ATOL = 0.125


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


class Timer:
    """Median device time of ``fn`` over warm runs, CUDA events around each
    run, with the L2 cache flushed before each (the weights and pages a real
    step reads come from HBM)."""

    def __init__(self, dev):
        self.flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)

    def __call__(self, fn, warm: int = 2, reps: int = 10) -> float:
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / BF16_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def require_close(name, got, want, rtol, atol) -> float:
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    bad = int((err > lim).sum())
    check(bad == 0, f"{name}: {bad} elements outside tolerance "
                    f"(max |err| {float(err.max()):.4g})")
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    return float(err.max()) if err.numel() else 0.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core import routing as TR
    from repro_torch.core.device import resolve_device
    from repro_torch.interop import init_params
    from repro_torch.kernels import _lib
    from repro_torch.kernels import combine as KC
    from repro_torch.kernels import dispatch as KD
    from repro_torch.kernels import gather_gmm as KG
    from repro_torch.kernels import paged_attention as KP
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as SE

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    torch.manual_seed(0)

    # -- 1. card ------------------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # -- 2. build -----------------------------------------------------------
    _lib.lib()
    log(f"build: {_lib.build_info['seconds']:.1f} s "
        f"(cached={_lib.build_info['cached']}) -> {_lib.build_info['path']}")

    # -- model and weights (used by every later phase) ----------------------
    cfg = get_config("mixtral-8x7b").replace(
        num_layers=2, dtype="bfloat16", moe_impl="blaze_pallas")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    n_weight_bytes = sum(t.numel() * t.element_size()
                         for t in _leaves(params))
    log(f"weights: {cfg.name} full width, depth cut 32 -> "
        f"{cfg.num_layers} layers, {n_weight_bytes / 1e9:.2f} GB bf16")
    moe = params["layers"][0]["moe"]
    E, k, d, h = cfg.num_experts, cfg.top_k, cfg.d_model, cfg.moe_d_ff
    rng = np.random.default_rng(0)

    def randn(*shape, dtype=BF16, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                .mul_(scale).to(dev, dtype))

    # slice shapes: prefill 4 slots x 512-token bucket, decode 4 slots
    L_pre, L_dec = 4 * 512, 4
    x_pre, x_dec = randn(L_pre, d), randn(L_dec, d)
    topk_pre = TR.top_k_gating(x_pre, moe["wg"], k).topk_experts.contiguous()
    topk_dec = TR.top_k_gating(x_dec, moe["wg"], k).topk_experts.contiguous()

    # -- 3. parity ----------------------------------------------------------
    errs = {n: 0.0 for n in ("build_dispatch", "gather_gmm", "combine",
                             "paged_attention")}

    def dispatch_case(name, topk, n_exp):
        got = KD.build_dispatch(topk, n_exp)
        want = TR.build_dispatch(topk, n_exp)
        for f in TR.Dispatch._fields:
            check(torch.equal(getattr(got, f), getattr(want, f)),
                  f"dispatch {name}: {f} differs")
        return got

    disp_pre = dispatch_case("prefill", topk_pre, E)
    disp_dec = dispatch_case("decode", topk_dec, E)
    dispatch_case("empty experts", torch.from_numpy(np.stack(
        [rng.permutation([1, 5]) for _ in range(300)]).astype(np.int32))
        .to(dev), E)
    dispatch_case("one expert", torch.full((777, 1), 3, dtype=torch.int32,
                                           device=dev), E)
    dispatch_case("ragged", topk_pre[:37].contiguous(), E)
    log("parity build_dispatch: bit-equal (prefill, decode, empty experts, "
        "one expert, 37 tokens)")

    def gmm_case(name, x, disp_or_off, w1, w2=None, idx=None, epilogue=True):
        off = disp_or_off
        got = KG.gather_gmm(x, idx, off, w1, w2, epilogue=epilogue)
        want = KG.gather_gmm_plain(x, idx, off, w1, w2, epilogue=epilogue)
        e = require_close(f"gather_gmm {name}", got, want, GMM_RTOL, GMM_ATOL)
        total = int(off[-1])
        check(not bool(got[total:].any()),
              f"gather_gmm {name}: rows past offsets[E] not zero")
        errs["gather_gmm"] = max(errs["gather_gmm"], e)
        return got

    y_pre = gmm_case("prefill dual", x_pre, disp_pre.expert_token_offsets,
                     moe["w1"], moe["w2"], disp_pre.expert_token_indices)
    p_pre = gmm_case("prefill w3", y_pre, disp_pre.expert_token_offsets,
                     moe["w3"])
    y_dec = gmm_case("decode dual", x_dec, disp_dec.expert_token_offsets,
                     moe["w1"], moe["w2"], disp_dec.expert_token_indices)
    p_dec = gmm_case("decode w3", y_dec, disp_dec.expert_token_offsets,
                     moe["w3"])
    ed = dispatch_case("gmm empty experts", torch.from_numpy(np.stack(
        [rng.permutation([2, 6]) for _ in range(100)]).astype(np.int32))
        .to(dev), E)
    gmm_case("empty experts, 200 slots", x_pre[:100].contiguous(),
             ed.expert_token_offsets, moe["w1"], moe["w2"],
             ed.expert_token_indices)
    short = torch.tensor([0, 3, 3, 5, 9, 9, 9, 10, 12], dtype=torch.int32,
                         device=dev)   # 12 of 16 slots routed: 4 dead rows
    gmm_case("rows past total", x_dec, short, moe["w1"], moe["w2"],
             torch.randint(0, L_dec, (16,), dtype=torch.int32, device=dev))
    log(f"parity gather_gmm: max |err| {errs['gather_gmm']:.4g} "
        f"(rtol 2^-7, atol {GMM_ATOL})")

    def combine_case(name, p, disp, L):
        g = torch.rand(L, k, device=dev).to(BF16)
        got = KC.combine(p, disp.token_index_map, g)
        want = KC.combine_plain(p, disp.token_index_map, g)
        check(torch.equal(got, want), f"combine {name}: not bit-equal")
        return g

    g_pre = combine_case("prefill", p_pre, disp_pre, L_pre)
    g_dec = combine_case("decode", p_dec, disp_dec, L_dec)
    log("parity combine: bit-equal (prefill, decode)")

    # decode attention at the slice's shapes: pool of a capacity-1024
    # engine, requests at the end of the run's prompts, a request at
    # position 0 and a dead slot
    ps, pps, Hq, Hkv, Dh = 16, 64, cfg.num_heads, cfg.num_kv_heads, 128
    n_pages = 1 + 4 * pps
    kp, vp = randn(n_pages, ps, Hkv, Dh), randn(n_pages, ps, Hkv, Dh)
    q_dec = randn(4, 1, Hq, Dh)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(1)) + 1
    table = perm[:4 * pps].reshape(4, pps).to(torch.int32).to(dev)
    pos = torch.tensor([36 + 15, 128 + 15, 299 + 15, 510 + 15],
                       dtype=torch.int32, device=dev)

    def paged_case(name, q, table_, pos_, window):
        got = KP.paged_attention(q, kp, vp, table_, pos_, window=window)
        want = KP.paged_attention_plain(q, kp, vp, table_, pos_,
                                        window=window)
        e = require_close(f"paged_attention {name}", got, want, 0.0,
                          PAGED_ATOL)
        errs["paged_attention"] = max(errs["paged_attention"], e)

    paged_case("decode", q_dec, table, pos, cfg.sliding_window)
    edge_table = table.clone()
    edge_table[2] = 0                                     # dead slot
    paged_case("pos 0 + dead table", q_dec, edge_table,
               torch.tensor([0, 700, 0, 1000], dtype=torch.int32,
                            device=dev), cfg.sliding_window)
    paged_case("window 100", q_dec, table, pos, 100)
    torch.cuda.synchronize()
    log(f"parity paged_attention: max |err| {errs['paged_attention']:.4g} "
        f"(atol {PAGED_ATOL})")

    # -- 4. timing ----------------------------------------------------------
    timer = Timer(dev)
    rows = {}

    def entry(ms, plain_ms, nbytes, ops, library_ms=None, shape=""):
        b, by = bound_ms(nbytes, ops)
        return {"shape": shape, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b, "bound_by": by, "library_ms": library_ms}

    def disp_entry(topk, shape):
        n = topk.numel()
        nbytes = 4 * (n + E + (E + 1) + 2 * n)
        return entry(timer(lambda: KD.build_dispatch(topk, E)),
                     timer(lambda: TR.build_dispatch(topk, E)),
                     nbytes, 0, None, shape)

    rows["build_dispatch"] = [
        disp_entry(topk_pre, f"prefill: L={L_pre}, k={k}, E={E}"),
        disp_entry(topk_dec, f"decode: L={L_dec}, k={k}, E={E}")]

    def gmm_entry(x, disp, w1, w2, idx, shape, plain_reps):
        off = disp.expert_token_offsets
        S = disp.num_slots
        lens = disp.expert_lengths.tolist()
        live = sum(1 for n in lens if n)
        nw = 2 if w2 is not None else 1
        d_in, h_out = w1.shape[1], w1.shape[2]
        x_rows = x.shape[0]
        nbytes = (x_rows * d_in * EB + (S * 4 if idx is not None else 0)
                  + (E + 1) * 4 + live * d_in * h_out * EB * nw
                  + S * h_out * EB)
        ops = 2.0 * sum(lens) * d_in * h_out * nw
        return entry(
            timer(lambda: KG.gather_gmm(x, idx, off, w1, w2)),
            timer(lambda: KG.gather_gmm_plain(x, idx, off, w1, w2),
                  warm=1 if plain_reps < 3 else 2, reps=plain_reps),
            nbytes, ops, None, shape)

    rows["gather_gmm"] = [
        gmm_entry(x_pre, disp_pre, moe["w1"], moe["w2"],
                  disp_pre.expert_token_indices,
                  f"prefill dual w1/w2: S={disp_pre.num_slots}, d={d}, "
                  f"h={h}", plain_reps=1),
        gmm_entry(y_pre, disp_pre, moe["w3"], None, None,
                  f"prefill w3: S={disp_pre.num_slots}, h={h}, d={d}",
                  plain_reps=1),
        gmm_entry(x_dec, disp_dec, moe["w1"], moe["w2"],
                  disp_dec.expert_token_indices,
                  f"decode dual w1/w2: S={disp_dec.num_slots}, d={d}, "
                  f"h={h}", plain_reps=5),
        gmm_entry(y_dec, disp_dec, moe["w3"], None, None,
                  f"decode w3: S={disp_dec.num_slots}, h={h}, d={d}",
                  plain_reps=5)]

    def comb_entry(p, disp, g, L, shape):
        tim = disp.token_index_map
        nbytes = p.numel() * EB + L * k * (4 + EB) + L * d * EB
        return entry(timer(lambda: KC.combine(p, tim, g)),
                     timer(lambda: KC.combine_plain(p, tim, g)),
                     nbytes, 2.0 * L * k * d, None, shape)

    rows["combine"] = [
        comb_entry(p_pre, disp_pre, g_pre, L_pre,
                   f"prefill: S={disp_pre.num_slots}, L={L_pre}, d={d}"),
        comb_entry(p_dec, disp_dec, g_dec, L_dec,
                   f"decode: S={disp_dec.num_slots}, L={L_dec}, d={d}")]

    window = cfg.sliding_window
    live_tokens = [min(int(p_) + 1, window) for p_ in pos.tolist()]
    nbytes = (q_dec.numel() * EB * 2 + sum(live_tokens) * Hkv * Dh * EB * 2
              + sum(-(-(n) // ps) for n in live_tokens) * 4 + 4 * 4)
    ops = 4.0 * sum(live_tokens) * Hq * Dh
    # library yardstick: scaled_dot_product_attention over K/V gathered to
    # a dense (B, Hkv, T, Dh) view beforehand (the gather is not timed)
    T_all = pps * ps
    kd = kp[table.long()].reshape(4, T_all, Hkv, Dh).transpose(1, 2)
    vd = vp[table.long()].reshape(4, T_all, Hkv, Dh).transpose(1, 2)
    t_ids = torch.arange(T_all, device=dev)
    mask = ((t_ids[None, :] <= pos[:, None].long())
            & (t_ids[None, :] > pos[:, None].long() - window))
    qd = q_dec.transpose(1, 2)
    lib_ms = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask[:, None, None, :], enable_gqa=True))
    rows["paged_attention"] = [entry(
        timer(lambda: KP.paged_attention(q_dec, kp, vp, table, pos,
                                         window=window)),
        timer(lambda: KP.paged_attention_plain(q_dec, kp, vp, table, pos,
                                               window=window)),
        nbytes, ops, lib_ms,
        f"decode: B=4, Hq={Hq}, Hkv={Hkv}, Dh={Dh}, page {ps}, "
        f"positions {pos.tolist()}")]
    for name, rs in rows.items():
        for r in rs:
            log(f"time {name} [{r['shape']}]: {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), library {r['library_ms']}")
    del kd, vd, y_pre, p_pre

    # -- 5. end to end ------------------------------------------------------
    prompt_lens = (37, 129, 300, 511, 64)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).astype(np.int32)
               for n in prompt_lens]
    phase_s = {"prefill": 0.0, "decode": 0.0}

    def timed(kind, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            phase_s[kind] += time.perf_counter() - t0
            return out
        return run

    def serve():
        eng = SE.ServeEngine(cfg, params, batch_slots=4, capacity=1024,
                             page_size=16, device=dev)
        reqs = [SE.Request(prompt=p, max_new_tokens=16,
                           eos_id=cfg.vocab_size) for p in prompts]
        eng.generate(reqs)
        return eng, reqs

    # Cold run: the first call of each prefill bucket and of the decode
    # step pays one-time costs (library heuristics, allocator growth);
    # the main run below is measured warm.
    t0 = time.perf_counter()
    _, reqs_cold = serve()
    torch.cuda.synchronize()
    cold_wall = time.perf_counter() - t0
    real_prefill, real_decode = T.prefill, T.paged_decode_step
    T.prefill = timed("prefill", real_prefill)
    T.paged_decode_step = timed("decode", real_decode)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        eng, reqs = serve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        T.prefill, T.paged_decode_step = real_prefill, real_decode
    log(f"e2e launches: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    for r in reqs:
        check(len(r.out_tokens) == 16 and r.finish_reason == "length",
              f"request of {r.prompt.size} tokens: {r.out_tokens}")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              "token out of range")
    st = eng.stats
    pre_tps = st["prefill_tokens"] / phase_s["prefill"]
    dec_tps = st["decode_slot_tokens"] / phase_s["decode"]
    log(f"e2e: cold run {cold_wall:.3f} s; warm run: "
        f"{len(reqs)} requests in {wall:.3f} s; prefill "
        f"{st['prefill_tokens']} tokens in {phase_s['prefill']:.4f} s "
        f"({pre_tps:.1f} tok/s); decode {st['decode_slot_tokens']} tokens "
        f"in {st['decode_steps']} steps, {phase_s['decode']:.4f} s "
        f"({dec_tps:.1f} tok/s); peak memory {peak / 2 ** 30:.3f} GiB "
        f"(weights {n_weight_bytes / 2 ** 30:.3f} GiB); stats {st}")
    # A third run is traced with torch.profiler: device time by kernel and
    # the device's busy share of the run's wall time.
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, reqs2 = serve()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    tokens = [r.out_tokens for r in reqs]
    check(tokens == [r.out_tokens for r in reqs2]
          and tokens == [r.out_tokens for r in reqs_cold],
          "repeat runs gave other tokens")
    log("e2e: cold, warm and traced runs gave identical tokens")
    by_kernel = _device_time_by_kernel(prof)
    busy = sum(by_kernel.values()) / 1e6
    log(f"trace (third run, profiler on): wall {traced_wall:.4f} s, device "
        f"busy {busy:.4f} s ({100 * busy / traced_wall:.1f}%)")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]:
        log(f"  {us / 1e3:10.3f} ms  {name[:110]}")
    for i, r in enumerate(reqs):
        log(f"  req[{i}] prompt {r.prompt.size} tokens -> {r.out_tokens}")

    # -- 6. CPU cross-check -------------------------------------------------
    prompt = rng.integers(3, cfg.vocab_size, size=24).astype(np.int32)

    def prefill_logits(p, device):
        cache = T.init_paged_cache(cfg, 3, 16, device)
        tok = torch.from_numpy(prompt[None]).to(device)
        lens = torch.tensor([24], dtype=torch.int32, device=device)
        table = torch.tensor([[1, 2]], dtype=torch.int32, device=device)
        with torch.inference_mode():
            return T.prefill(p, tok, lens, cache, table, cfg).float().cpu()

    gpu_logits = prefill_logits(params, dev)
    cpu_params = _to_device(params, torch.device("cpu"))
    torch.set_num_threads(8)
    t0 = time.perf_counter()
    cpu_logits = prefill_logits(cpu_params, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    check(gpu_logits.shape == (1, cfg.vocab_size), "logits shape")
    check(bool(torch.isfinite(gpu_logits).all()), "card logits not finite")
    diff = float((gpu_logits - cpu_logits).abs().max())
    top2 = torch.topk(gpu_logits[0], 2).values
    log(f"cpu cross-check: max |logit diff| {diff:.4g} (tol "
        f"{CPU_LOGIT_ATOL}), max |logit| {float(gpu_logits.abs().max()):.3f}"
        f", first token card {int(gpu_logits.argmax())} / cpu "
        f"{int(cpu_logits.argmax())}, card top-2 gap "
        f"{float(top2[0] - top2[1]):.4g}, cpu prefill {cpu_s:.1f} s")
    check(diff <= CPU_LOGIT_ATOL, "CPU and card logits disagree")
    check(int(gpu_logits.argmax()) == int(cpu_logits.argmax()),
          "CPU and card first tokens differ")

    # -- report ---------------------------------------------------------------
    sources = {
        "build_dispatch": ("src/repro_torch/csrc/dispatch.cu",
                           "src/repro/kernels/dispatch.py:81"),
        "gather_gmm": ("src/repro_torch/csrc/gather_gmm.cu",
                       "src/repro/kernels/gather_gmm.py:228"),
        "combine": ("src/repro_torch/csrc/combine.cu",
                    "src/repro/kernels/combine.py:44"),
        "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:97"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        main_row = rows[name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "shapes": rows[name]})
    e2e = {"prefill_tok_per_s": pre_tps, "decode_tok_per_s": dec_tps,
           "prefill_s": phase_s["prefill"], "decode_s": phase_s["decode"],
           "peak_bytes": peak, "weight_bytes": n_weight_bytes,
           "wall_s": wall, "cold_wall_s": cold_wall,
           "traced_wall_s": traced_wall,
           "traced_device_busy_s": busy, "stats": st}
    log(f"e2e-record: {json.dumps(e2e)}")
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _device_time_by_kernel(prof) -> dict[str, float]:
    """Self device time (us) of each device kernel in a profiler trace."""
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0 and ev.device_type.name == "CUDA":
            out[ev.key] = out.get(ev.key, 0.0) + us
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


if __name__ == "__main__":
    sys.exit(main())
