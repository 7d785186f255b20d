#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. card — the ``nvidia-smi`` name and power limit;
2. build — the eight CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, in parallel);
3. parity — each kernel against its plain PyTorch version on the card, in
   bf16 at the serving and training shapes (Mixtral-8x7B: d=4096, 32/8
   heads of 128, E=8, top-2, expert width 14336; training 2 x 2048 tokens,
   8192 slots), plus edge cases: empty experts, all slots on one expert,
   slot counts that are not a multiple of the tile, position 0 and a dead
   page table, windows shorter than the sequence, softcaps, float32; the
   expert layer's autograd Functions (``blaze_pallas``, ``moe_ffn_blaze``
   on ``pallas`` in each residual mode and on ``pallas_fused``) against
   autograd through the plain versions; and the bytes one full-width
   expert layer saves for its backward, per implementation;
4. timing — each kernel (median of warm runs, L2 flushed between runs) at
   the prefill, decode and training shapes, beside its plain version, its
   bound (the larger of bytes / 3.35 TB/s and operations / 989 TFLOP/s,
   from this run's inputs) and PyTorch calls that compute the same
   function, where there are (``torch._grouped_mm`` over pre-gathered
   rows, ``scaled_dot_product_attention``; for the fused pair the sum of
   its products as grouped_mm calls, a composition), timed only;
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
   card's within the bf16 tolerance below, with the same first token;
7. training — with the serving weights freed, Mixtral-8x7B at full width,
   2 layers, float32 master weights from seed 0, bf16 compute,
   ``blaze_pallas`` with ``use_pallas=True``, batches of 2 x 2048 tokens
   from the port's pipeline (seed 0), through ``make_train_step``: one
   cold step, 5 warm steps (measured: every training kernel's launch count
   must rise during them), one step traced with torch.profiler, then one
   batch fed 3 times, whose loss must fall; every loss and grad norm must
   be finite;
8. training on the reference's default expert layer — phase 7 again with
   ``moe_impl="blaze"`` on the ``pallas_fused`` backend (the fused forward
   and backward kernels must be launched), after phase 7's parameters and
   moments are freed;
9. CPU training cross-checks — one step of the reduced Mixtral (float32)
   from the same weights and batch on the card (kernels) and on the CPU
   (plain versions), for ``blaze_pallas`` and for ``blaze`` on
   ``pallas_fused``: loss, grad norm and updated parameters must agree
   within the float32 tolerances below.

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
from types import SimpleNamespace

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
#  grouped weight gradient: float32 sums in another order, one rounding ->
#    the gather-GMM tolerance in bf16; in float32 1e-5 relative over a
#    floor of 1e-5 times the output's scale;
#  flash attention in bf16: the kernel scales the float32 scores where the
#    plain version scales q in bf16 (2^-8 relative on the scores), and the
#    output rounds to bf16 -> 2e-2 absolute (outputs are averages of unit
#    normals, |o| < 4); in float32 1e-5;
#  expert layer Function vs autograd through the plain versions: float32
#    1e-4 relative over a floor of 1e-4 times each output's scale (chains
#    of products summed in other orders); bf16 rounds a, b, y_swi and every
#    elementwise term of the backward to bf16 where the plain autograd
#    keeps float32 -> 2^-4 of each output's scale (a wrong index, transpose
#    or term is off by the output's own scale).
F32_RTOL, F32_FLOOR = 1e-5, 1e-5
FLASH_ATOL = 2e-2
#  fused MoE forward and backward: float32 outputs whose sums over h-chunks,
#    slots and row tiles run through atomics in another order than the
#    plain version's, from bf16 operands (the backward also rounds da, db
#    and g y_swi to bf16 for the tensor cores, where the plain version
#    keeps float32) -> one bf16 step (2^-7) of each output's scale plus the
#    gather-GMM absolute term; in float32 1e-5 relative over a floor of
#    1e-5 times the output's scale.
FUSED_SCALE_STEP = 2 ** -7
LAYER_F32, LAYER_BF16 = 1e-4, 2 ** -4
# CPU vs card training step (float32, reduced Mixtral): loss and grad norm
# 1e-4 relative (two layers of float32 sums in other orders).  AdamW's
# first step moves each parameter by about lr (its gradient divided by its
# own magnitude), so an element whose gradient is at the float32 noise of
# the two sides (~1e-6 of its leaf's scale) may step either way: every
# element within lr, and all but 1e-3 of each leaf's elements within
# 2e-3 lr.
STEP_RTOL, STEP_FAR_SHARE = 1e-4, 1e-3
TRAIN_BATCH, TRAIN_SEQ = 2, 2048


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
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.kernels import fused_moe as KFM
    from repro_torch.kernels import gather_gmm as KG
    from repro_torch.kernels import gmm_dw as KW
    from repro_torch.kernels import paged_attention as KP
    from repro_torch.kernels import ops as KO
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as SE
    from repro_torch.core import moe_layer as ML
    M = SimpleNamespace(KG=KG, KW=KW, KF=KF, KC=KC, KO=KO, TR=TR, KFM=KFM,
                        ML=ML)

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
                             "paged_attention", "gmm_dw",
                             "flash_attention", "fused_moe_fwd",
                             "fused_moe_bwd")}

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

    # training shapes: 2 x 2048 tokens routed top-2 -> 8192 slots
    L_tr = TRAIN_BATCH * TRAIN_SEQ
    x_tr = randn(L_tr, d)
    topk_tr = TR.top_k_gating(x_tr, moe["wg"], k).topk_experts.contiguous()
    disp_tr = dispatch_case("training", topk_tr, E)
    tr = train_kernel_parity(M, dev, rng, randn, errs, moe, x_tr, disp_tr)
    log(f"parity gmm_dw: max |err| {errs['gmm_dw']:.4g}; flash_attention: "
        f"max |err| {errs['flash_attention']:.4g}; gather_gmm (with save_ab "
        f"and transposed weights): {errs['gather_gmm']:.4g}")
    fz = fused_kernel_parity(M, dev, rng, randn, errs, moe, x_tr, disp_tr,
                             x_dec, disp_dec)
    residual_bytes(M, moe, x_tr, disp_tr)

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

    def gmm_entry(x, disp, w1, w2, idx, shape, plain_reps, save_ab=False,
                  trans_w=False):
        off = disp.expert_token_offsets
        S = disp.num_slots
        lens = disp.expert_lengths.tolist()
        live = sum(1 for n in lens if n)
        nw = 2 if w2 is not None else 1
        d_in, h_out = ((w1.shape[2], w1.shape[1]) if trans_w
                       else (w1.shape[1], w1.shape[2]))
        x_rows = x.shape[0]
        n_out = 3 if save_ab else 1
        nbytes = (x_rows * d_in * EB + (S * 4 if idx is not None else 0)
                  + (E + 1) * 4 + live * d_in * h_out * EB * nw
                  + n_out * S * h_out * EB)
        ops = 2.0 * sum(lens) * d_in * h_out * nw
        kw = dict(save_ab=save_ab, trans_w=trans_w)
        lib_ms = library_gmm_ms(timer, x, idx, off, w1, w2, trans_w)
        return entry(
            timer(lambda: KG.gather_gmm(x, idx, off, w1, w2, **kw)),
            timer(lambda: KG.gather_gmm_plain(x, idx, off, w1, w2, **kw),
                  warm=1 if plain_reps < 3 else 2, reps=plain_reps),
            nbytes, ops, lib_ms, shape)

    S_tr = disp_tr.num_slots
    rows["gather_gmm"] = [
        gmm_entry(x_tr, disp_tr, moe["w1"], moe["w2"],
                  disp_tr.expert_token_indices,
                  f"training dual w1/w2 + save_ab: S={S_tr}, d={d}, h={h}",
                  plain_reps=1, save_ab=True),
        gmm_entry(tr["dyg"], disp_tr, moe["w3"], None, None,
                  f"training w3^T: S={S_tr}, {d}->{h}", plain_reps=1,
                  trans_w=True),
        gmm_entry(tr["da"], disp_tr, moe["w1"], None, None,
                  f"training w1^T: S={S_tr}, {h}->{d}", plain_reps=1,
                  trans_w=True),
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

    rows.update(train_kernel_timing(M, timer, entry, tr, disp_tr, E))
    rows.update(fused_kernel_timing(M, timer, entry, fz, moe))

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
    del kd, vd, y_pre, p_pre, tr, fz

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
    for name in ("build_dispatch", "gather_gmm", "combine",
                 "paged_attention"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the serving path")
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

    # -- 7. training ----------------------------------------------------------
    # The training step holds ~65 GB; free the serving weights and what
    # holds them first.
    del params, cpu_params, moe, eng, _
    torch.cuda.empty_cache()
    log(f"train: serving weights freed, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB still allocated")
    cfg_train = get_config("mixtral-8x7b").replace(
        num_layers=2, moe_impl="blaze_pallas", use_pallas=True)
    train = training_phase(cfg_train, dev, K, (
        "build_dispatch", "gather_gmm", "combine", "gmm_dw",
        "flash_attention"), "blaze_pallas")
    torch.cuda.empty_cache()

    # -- 8. training, the reference's default layer on the fused pair ---------
    # (the previous phase's parameters and moments are freed with it)
    cfg_fused = get_config("mixtral-8x7b").replace(
        num_layers=2, gmm_backend="pallas_fused", use_pallas=True)
    train_fused = training_phase(cfg_fused, dev, K, (
        "build_dispatch", "fused_moe_fwd", "fused_moe_bwd",
        "flash_attention"), "blaze+pallas_fused")
    torch.cuda.empty_cache()

    # -- 9. CPU training cross-checks -------------------------------------------
    xcheck = cpu_train_crosscheck(dev, moe_impl="blaze_pallas")
    xcheck_fused = cpu_train_crosscheck(dev, gmm_backend="pallas_fused")

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
        "gmm_dw": ("src/repro_torch/csrc/gmm_dw.cu",
                   "src/repro/kernels/gather_gmm.py:740"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:72"),
        "fused_moe_fwd": ("src/repro_torch/csrc/fused_moe_fwd.cu",
                          "src/repro/kernels/gather_gmm.py:399"),
        "fused_moe_bwd": ("src/repro_torch/csrc/fused_moe_bwd.cu",
                          "src/repro/kernels/gather_gmm.py:576"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        main_row = rows[name][0]
        # launches on the main path that runs the kernel: the warm steps of
        # the fused training phase for the fused pair, of the blaze_pallas
        # one for the others, or the serving path for a kernel that
        # training does not run
        phase = train_fused if name.startswith("fused_moe") else train
        n_train, n_serve = phase["launches"][name], launches[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_train or n_serve,
            "launches_train": n_train, "launches_serve": n_serve,
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
    for tag, rec, xc in (("blaze_pallas", train, xcheck),
                         ("blaze+pallas_fused", train_fused, xcheck_fused)):
        rec = {k_: v for k_, v in rec.items() if k_ != "by_kernel_ms"}
        log(f"train-record [{tag}]: "
            f"{json.dumps(dict(rec, crosscheck=xc))}")
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def library_gmm_ms(timer, x, idx, off, w1, w2, trans_w) -> float:
    """The library yardstick for gather-GMM: one ``torch._grouped_mm``
    over rows gathered beforehand (the dual branch as one product with
    w1 | w2 concatenated along h, epilogue excluded; a transposed weight
    as a strided view).  The gather and the concatenation are not timed."""
    xg = x if idx is None else x[idx.long()].contiguous()
    if w2 is not None:
        w = torch.cat([w1, w2], dim=2)
    else:
        w = w1.transpose(1, 2) if trans_w else w1
    ends = off[1:].contiguous()
    return timer(lambda: torch._grouped_mm(xg, w, offs=ends))


def train_kernel_parity(M, dev, rng, randn, errs, moe, x_tr, disp_tr):
    """Phase 3, training kernels: gather-GMM with ``save_ab`` and with
    transposed weights, the grouped weight gradient and flash attention at
    the training shapes and at edge cases, each against its plain version;
    the expert layer's autograd Function against autograd through the
    plain versions.  Returns the training-shape tensors for the timing."""
    KG, KW, KF = M.KG, M.KW, M.KF
    off, eti = disp_tr.expert_token_offsets, disp_tr.expert_token_indices
    S = disp_tr.num_slots
    d, h = moe["w1"].shape[1], moe["w1"].shape[2]

    def gmm_close(name, got, want):
        errs["gather_gmm"] = max(errs["gather_gmm"], require_close(
            f"gather_gmm {name}", got, want, GMM_RTOL, GMM_ATOL))

    got = KG.gather_gmm(x_tr, eti, off, moe["w1"], moe["w2"], save_ab=True)
    want = KG.gather_gmm_plain(x_tr, eti, off, moe["w1"], moe["w2"],
                               save_ab=True)
    for name, g_, w_ in zip(("y", "a", "b"), got, want):
        gmm_close(f"training save_ab {name}", g_, w_)
    y_swi = got[0]
    del want
    dyg = randn(S, d)
    da = randn(S, h, scale=0.05)
    for name, rows_, w in (("w3^T", dyg, moe["w3"]), ("w1^T", da, moe["w1"])):
        gmm_close(f"training {name}",
                  KG.gather_gmm(rows_, None, off, w, epilogue=False,
                                trans_w=True),
                  KG.gather_gmm_plain(rows_, None, off, w, epilogue=False,
                                      trans_w=True))

    def dw_case(name, lhs, dout, offsets):
        got = KW.gmm_dw(lhs, dout, offsets)
        want = KW.gmm_dw_plain(lhs, dout, offsets)
        if lhs.dtype == BF16:
            e = require_close(f"gmm_dw {name}", got, want, GMM_RTOL, GMM_ATOL)
        else:
            e = require_close(f"gmm_dw {name}", got, want, F32_RTOL,
                              F32_FLOOR * float(want.abs().max()))
        lens = (offsets[1:] - offsets[:-1]).tolist()
        for ex, n in enumerate(lens):
            check(n > 0 or not bool(got[ex].any()),
                  f"gmm_dw {name}: empty expert {ex} not zero")
        errs["gmm_dw"] = max(errs["gmm_dw"], e)

    xg = x_tr[eti.long()]
    dw_case("training dw1", xg, da, off)
    dw_case("training dw3", y_swi, dyg, off)
    for dt in (BF16, torch.float32):
        for name, lengths in (("empty experts", (0, 300, 0, 1000, 0, 7, 0,
                                                 0)),
                              ("one expert", (0, 0, 0, 0, 0, 2048, 0, 0)),
                              ("ragged rows", (130, 1, 65, 0, 200, 3, 77,
                                               500))):
            n = sum(lengths)
            offs = torch.tensor([0, *np.cumsum(lengths)], dtype=torch.int32,
                                device=dev)
            dw_case(f"{name} {dt}", randn(n, 256, dtype=dt),
                    randn(n, 384, dtype=dt), offs)

    def flash_case(name, q, k_, v, window, cap):
        got = KF.flash_attention(q, k_, v, causal=True, window=window,
                                 cap=cap)
        want = KF.flash_attention_plain(q, k_, v, causal=True, window=window,
                                        cap=cap, chunk=min(512, q.shape[1]))
        if q.dtype == BF16:
            e = require_close(f"flash_attention {name}", got, want, 0.0,
                              FLASH_ATOL)
        else:
            e = require_close(f"flash_attention {name}", got, want, F32_RTOL,
                              F32_FLOOR)
        errs["flash_attention"] = max(errs["flash_attention"], e)

    B, T_ = TRAIN_BATCH, TRAIN_SEQ
    q = randn(B, T_, 32, 128)
    kk, vv = randn(B, T_, 8, 128), randn(B, T_, 8, 128)
    flash_case("training (window 4096 >= S)", q, kk, vv, 4096, 0.0)
    flash_case("window 1000", q, kk, vv, 1000, 0.0)
    flash_case("softcap 30", q[:, :512].contiguous(),
               kk[:, :512].contiguous(), vv[:, :512].contiguous(), 0, 30.0)
    flash_case("float32, window 100, softcap 5",
               q[:1, :256].float().contiguous(),
               kk[:1, :256].float().contiguous(),
               vv[:1, :256].float().contiguous(), 100, 5.0)
    layer_function_parity(M, dev, rng)
    return {"x": x_tr, "xg": xg, "dyg": dyg, "da": da, "y_swi": y_swi,
            "q": q, "k": kk, "v": vv}


def layer_function_parity(M, dev, rng):
    """The expert layer's autograd Functions on the card against autograd
    through the plain versions (E=8, top-2, L=2048, widths 1024 -> 2048),
    in float32 and bf16: y, dx, dgates, dw1, dw2, dw3.  The kernel
    composition (``blaze_pallas``), ``moe_ffn_blaze`` on the ``pallas``
    backend in each residual mode, and on ``pallas_fused``."""
    L, d, h, E, k = 2048, 1024, 2048, 8, 2
    impls = [("blaze_pallas", lambda *a: M.KO.moe_ffn_blaze_pallas(*a))] + [
        (f"blaze+pallas {m}", lambda *a, m=m: M.ML.moe_ffn_blaze(
            *a, residuals=m, backend="pallas"))
        for m in ("ab_yswi", "ab", "x")] + [
        ("blaze+pallas_fused", lambda *a: M.ML.moe_ffn_blaze(
            *a, backend="pallas_fused"))]
    for dt, tol in ((torch.float32, LAYER_F32), (BF16, LAYER_BF16)):
        def make(*shape, s=1.0):
            a = rng.standard_normal(shape).astype(np.float32) * s
            return torch.from_numpy(a).to(dev, dt).requires_grad_()
        x, w1, w2 = make(L, d), make(E, d, h, s=d ** -0.5), \
            make(E, d, h, s=d ** -0.5)
        w3 = make(E, h, d, s=h ** -0.5)
        g = M.TR.top_k_gating(x.detach(), make(d, E).detach(), k)
        disp = M.TR.build_dispatch(g.topk_experts, E)
        gates = g.topk_weights.to(dt).requires_grad_()
        dy = torch.from_numpy(rng.standard_normal((L, d)).astype(
            np.float32)).to(dev, dt)
        ins = (x, gates, w1, w2, w3)
        y_swi = M.KG.gather_gmm_plain(x, disp.expert_token_indices,
                                      disp.expert_token_offsets, w1, w2)
        p_out = M.KG.gather_gmm_plain(y_swi, None, disp.expert_token_offsets,
                                      w3, epilogue=False)
        y_p = M.KC.combine_plain(p_out, disp.token_index_map, gates)
        want = [y_p, *torch.autograd.grad(y_p, ins, dy)]
        for label, fn in impls:
            y = fn(x, gates, disp, w1, w3, w2)
            got = [y, *torch.autograd.grad(y, ins, dy)]
            errs = []
            for name, g_, w_ in zip(("y", "dx", "dgates", "dw1", "dw2",
                                     "dw3"), got, want):
                g_, w_ = g_.detach(), w_.detach()
                scale = float(w_.float().abs().max())
                errs.append(require_close(f"layer {label} {dt} {name}", g_,
                                          w_, tol, tol * scale)
                            / max(scale, 1e-30))
            log(f"parity layer {label} {dt}: max |err| / scale per output "
                f"(y, dx, dgates, dw1, dw2, dw3) "
                f"{[round(e, 6) for e in errs]} (tolerance {tol})")


def slot_gates(M, x, wg, disp, k):
    """The gates of ``x`` in (S,) float32 slot order."""
    gates = M.TR.top_k_gating(x, wg, k).topk_weights
    g_slot = torch.zeros(disp.num_slots, dtype=torch.float32,
                         device=x.device)
    g_slot[disp.token_index_map.reshape(-1).long()] = gates.reshape(-1)
    return g_slot


def fused_kernel_parity(M, dev, rng, randn, errs, moe, x_tr, disp_tr, x_dec,
                        disp_dec):
    """Phase 3, the fused MoE pair: forward and backward against their
    plain versions at the training shape (real top-2 routing from the
    gate), at decode, with an empty expert and a slot count that is not a
    multiple of the row tile, and in float32 at a small shape.  Returns
    the training- and decode-shape inputs for the timing."""
    KFM = M.KFM
    E, k = moe["w1"].shape[0], 2
    w = (moe["w1"], moe["w2"], moe["w3"])

    def case(name, x, disp, g_slot, ws):
        idx, off = disp.expert_token_indices, disp.expert_token_offsets
        dy = randn(*x.shape, dtype=x.dtype)
        got = [KFM.fused_moe_fwd(x, g_slot, idx, off, *ws)]
        want = [KFM.fused_moe_fwd_plain(x, g_slot, idx, off, *ws)]
        got += KFM.fused_moe_bwd(x, dy, g_slot, idx, off, *ws)
        want += KFM.fused_moe_bwd_plain(x, dy, g_slot, idx, off, *ws)
        rel = []
        for i, (out, g_, w_) in enumerate(zip(
                ("y", "dx", "dgates", "dw1", "dw2", "dw3"), got, want)):
            scale = float(w_.abs().max())
            if x.dtype == BF16:
                rt, at = 0.0, FUSED_SCALE_STEP * scale + GMM_ATOL
            else:
                rt, at = F32_RTOL, F32_FLOOR * scale
            e = require_close(f"fused_moe {name} {out}", g_, w_, rt, at)
            key = "fused_moe_fwd" if i == 0 else "fused_moe_bwd"
            errs[key] = max(errs[key], e)
            rel.append(round(e / max(scale, 1e-30), 6))
        lens = disp.expert_lengths.tolist()
        for ex, n in enumerate(lens):
            check(n > 0 or not any(bool(t[ex].any()) for t in got[3:]),
                  f"fused_moe {name}: empty expert {ex} has weight grads")
        log(f"parity fused_moe {name}: max |err| / scale (y, dx, dgates, "
            f"dw1, dw2, dw3) {rel}")
        return dy

    g_tr = slot_gates(M, x_tr, moe["wg"], disp_tr, k)
    dy_tr = case(f"training S={disp_tr.num_slots}", x_tr, disp_tr, g_tr, w)
    g_dec = slot_gates(M, x_dec, moe["wg"], disp_dec, k)
    case("decode S=8", x_dec, disp_dec, g_dec, w)
    topk = torch.from_numpy(np.stack([rng.permutation([2, 6])
                                      for _ in range(150)]).astype(np.int32))
    topk[:50, 1] = 4
    d_emp = M.TR.build_dispatch(topk.to(dev), E)      # 5 empty experts
    x_emp = x_tr[:150].contiguous()
    case("5 empty experts, S=300", x_emp, d_emp,
         slot_gates(M, x_emp, moe["wg"], d_emp, k), w)
    L32, d32, h32 = 100, 256, 384
    x32 = randn(L32, d32, dtype=torch.float32)
    ws32 = (randn(E, d32, h32, dtype=torch.float32, scale=d32 ** -0.5),
            randn(E, d32, h32, dtype=torch.float32, scale=d32 ** -0.5),
            randn(E, h32, d32, dtype=torch.float32, scale=h32 ** -0.5))
    wg32 = randn(d32, E, dtype=torch.float32)
    d32_disp = M.TR.build_dispatch(
        M.TR.top_k_gating(x32, wg32, k).topk_experts, E)
    case(f"float32 L={L32} {d32}->{h32}", x32, d32_disp,
         slot_gates(M, x32, wg32, d32_disp, k), ws32)
    return {"x": x_tr, "dy": dy_tr, "g": g_tr, "disp": disp_tr, "x_dec": x_dec, "g_dec": g_dec,
            "disp_dec": disp_dec}


def residual_bytes(M, moe, x, disp):
    """Bytes that one full-width expert layer saves for its backward, per
    implementation, counted by ``saved_tensors_hooks`` (the weights
    excluded): the kernel composition (``blaze_pallas``), the unfused
    ``blaze`` layer on ``pallas`` in each residual mode, and the fused
    pair (``pallas_fused``)."""
    ws = [moe[n].detach().requires_grad_() for n in ("w1", "w2", "w3")]
    weight_ptrs = {t.data_ptr() for t in ws}
    gates = M.TR.top_k_gating(x, moe["wg"], 2).topk_weights.to(BF16)
    out = {}
    impls = [("blaze_pallas", None, None)] + [
        (f"blaze+pallas {m}", "pallas", m) for m in ("ab_yswi", "ab", "x")
    ] + [("blaze+pallas_fused", "pallas_fused", "ab_yswi")]
    for name, backend, mode in impls:
        saved = []

        def pack(t):
            if t.data_ptr() not in weight_ptrs:
                saved.append((tuple(t.shape), t.numel() * t.element_size()))
            return t

        xi = x.detach().requires_grad_()
        gi = gates.detach().requires_grad_()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            if backend is None:
                y = M.KO.moe_ffn_blaze_pallas(xi, gi, disp, ws[0], ws[2],
                                              ws[1])
            else:
                y = M.ML.moe_ffn_blaze(xi, gi, disp, ws[0], ws[2], ws[1],
                                       residuals=mode, backend=backend)
        del y
        total = sum(b for _, b in saved)
        big = [sh for sh, b in saved if b >= 2 ** 20]
        out[name] = total
        log(f"residual bytes {name}: {total / 1e6:.1f} MB saved "
            f"({len(saved)} tensors; of 1 MB or more: {big})")
    check(out["blaze+pallas_fused"] < 35e6,
          "the fused layer saves 35 MB or more")
    return out


def fused_kernel_timing(M, timer, entry, fz, moe):
    """Phase 4, the fused MoE pair at the training and decode shapes,
    beside its plain version and its bound.  No single PyTorch call
    computes the fused function; the library yardstick is the composition
    of its products as ``torch._grouped_mm`` calls over rows gathered
    beforehand (gathers, elementwise terms and the combine not timed)."""
    KFM = M.KFM
    w1, w2, w3 = moe["w1"], moe["w2"], moe["w3"]
    E, d, h = w1.shape
    w12 = torch.cat([w1, w2], dim=2)                       # (E, d, 2h)
    rows = {"fused_moe_fwd": [], "fused_moe_bwd": []}
    for label, x, g, disp in (("training", fz["x"], fz["g"], fz["disp"]),
                              ("decode", fz["x_dec"], fz["g_dec"],
                               fz["disp_dec"])):
        idx, off = disp.expert_token_indices, disp.expert_token_offsets
        S, L = disp.num_slots, x.shape[0]
        lens = disp.expert_lengths.tolist()
        n, live = sum(lens), sum(1 for c in lens if c)
        ends = off[1:].contiguous()
        dy = fz["dy"] if label == "training" else torch.randn_like(x)
        # the composition's operands, gathered and computed beforehand
        xg = x[idx.long()].contiguous()
        dyg = dy[idx.long()].contiguous()
        ab = torch._grouped_mm(xg, w12, offs=ends)
        y_swi = (torch.nn.functional.silu(ab[:, :h].float())
                 * ab[:, h:].float()).to(BF16)
        dadb = (ab * 0.01).contiguous()
        da, db = dadb[:, :h].contiguous(), dadb[:, h:].contiguous()
        xg_t, ys_t = xg.t(), y_swi.t()
        w12_t, w3_t = w12.transpose(1, 2), w3.transpose(1, 2)
        gm = torch._grouped_mm

        def lib_fwd():
            gm(xg, w12, offs=ends)
            gm(y_swi, w3, offs=ends)

        def lib_bwd():
            gm(xg, w12, offs=ends)
            gm(dyg, w3_t, offs=ends)
            gm(xg_t, da, offs=ends)
            gm(xg_t, db, offs=ends)
            gm(ys_t, dyg, offs=ends)
            gm(dadb, w12_t, offs=ends)

        wbytes = live * 3 * d * h * EB
        meta = S * 8 + (E + 1) * 4
        plain_reps = 3 if label == "training" else 5
        shape = f"{label}: L={L}, S={S}, d={d}, h={h}, E={E}"
        rows["fused_moe_fwd"].append(entry(
            timer(lambda: KFM.fused_moe_fwd(x, g, idx, off, w1, w2, w3)),
            timer(lambda: KFM.fused_moe_fwd_plain(x, g, idx, off, w1, w2,
                                                  w3), warm=1,
                  reps=plain_reps),
            L * d * EB + meta + wbytes + L * d * 4, 6.0 * n * d * h,
            timer(lib_fwd), shape + " (library: 2 grouped_mm, composition)"))
        rows["fused_moe_bwd"].append(entry(
            timer(lambda: KFM.fused_moe_bwd(x, dy, g, idx, off, w1, w2, w3)),
            timer(lambda: KFM.fused_moe_bwd_plain(x, dy, g, idx, off, w1,
                                                  w2, w3), warm=1,
                  reps=plain_reps),
            2 * L * d * EB + meta + wbytes + L * d * 4 + S * 4
            + 3 * E * d * h * 4, 16.0 * n * d * h,
            timer(lib_bwd), shape + " (library: 6 grouped_mm, composition)"))
        del xg, dyg, ab, y_swi, dadb, da, db
    return rows


def train_kernel_timing(M, timer, entry, tr, disp_tr, E):
    """Phase 4, training kernels at the training shapes: the grouped
    weight gradient (dw1 and dw3) and the flash-attention forward, each
    beside its plain version, its bound and its library yardstick."""
    KW, KF = M.KW, M.KF
    off = disp_tr.expert_token_offsets
    ends = off[1:].contiguous()
    lens = disp_tr.expert_lengths.tolist()
    S = disp_tr.num_slots
    rows = {"gmm_dw": [], "flash_attention": []}
    for name, lhs, dout in (("dw1", tr["xg"], tr["da"]),
                            ("dw3", tr["y_swi"], tr["dyg"])):
        d_in, h_out = lhs.shape[1], dout.shape[1]
        nbytes = (lhs.numel() + dout.numel() + E * d_in * h_out) * EB + \
            (E + 1) * 4
        ops = 2.0 * sum(lens) * d_in * h_out
        lhs_t = lhs.t()
        rows["gmm_dw"].append(entry(
            timer(lambda: KW.gmm_dw(lhs, dout, off)),
            timer(lambda: KW.gmm_dw_plain(lhs, dout, off), warm=1, reps=3),
            nbytes, ops,
            timer(lambda: torch._grouped_mm(lhs_t, dout, offs=ends)),
            f"training {name}: S={S}, {d_in}x{h_out} per expert, E={E}"))
    q, k, v = tr["q"], tr["k"], tr["v"]
    B, T_, H, Dh = q.shape
    window = 4096
    pairs = sum(min(t + 1, window) for t in range(T_))   # live (q, k) pairs
    ops = 4.0 * B * H * Dh * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * EB
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows["flash_attention"].append(entry(
        timer(lambda: KF.flash_attention(q, k, v, causal=True,
                                         window=window)),
        timer(lambda: KF.flash_attention_plain(q, k, v, causal=True,
                                               window=window, chunk=512),
              warm=1, reps=3),
        nbytes, ops,
        timer(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)),
        f"training: B={B}, S={T_}, {H}/{k.shape[2]} heads of {Dh}, causal"))
    return rows


def training_phase(cfg, dev, K, required, tag):
    """Phases 7 and 8: the Mixtral training step at full width through
    ``make_train_step``; every kernel in ``required`` must be launched
    during the warm steps.  Returns the measurements."""
    from repro_torch.configs import TrainConfig
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.interop import init_params
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import init_adamw
    tcfg = TrainConfig(learning_rate=1e-4, warmup_steps=2, total_steps=100,
                       batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev, dtype=torch.float32)
    opt = init_adamw(params)
    n_params = sum(t.numel() for t in _leaves(params))
    step_fn = make_train_step(cfg, tcfg, dev)
    batches = make_batch_iterator(cfg.vocab_size, tcfg.seq_len,
                                  tcfg.batch_size, tcfg.seed)
    tokens = tcfg.batch_size * tcfg.seq_len
    steps_warm = 5
    torch.cuda.synchronize()
    log(f"train [{tag}]: {cfg.name} full width, {cfg.num_layers} layers, "
        f"moe_impl={cfg.moe_impl}, gmm_backend "
        f"{step_fn.resolved_backend.name}, "
        f"{n_params / 1e9:.3f} B float32 master parameters, "
        f"{tcfg.batch_size} x {tcfg.seq_len} tokens per step; allocated "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB after init")
    history = []

    def run(batch, label):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step_fn(params, opt, batch)
        m = {k_: float(v) for k_, v in m.items()}    # waits for the card
        m["step_s"] = time.perf_counter() - t0
        check(all(np.isfinite(m[k_]) for k_ in ("loss", "grad_norm")),
              f"train {label}: non-finite loss or grad norm {m}")
        log(f"train [{tag}] {label}: loss {m['loss']:.5f} ce {m['ce']:.5f} aux "
            f"{m['aux']:.5f} grad_norm {m['grad_norm']:.5f} lr "
            f"{m['lr']:.3g} step {m['step_s']:.4f} s")
        history.append(dict(m, label=label))
        return m

    cold = run(next(batches), "cold step 0")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    warm = [run(next(batches), f"warm step {i + 1}")
            for i in range(steps_warm)]
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"train [{tag}] launches over {steps_warm} warm steps: {launches}")
    for name in required:
        check(launches[name] > 0,
              f"kernel {name} was not launched by the [{tag}] training "
              "steps")
    step_s = statistics.median(m["step_s"] for m in warm)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = run(next(batches), "traced step")
    by_kernel = _device_time_by_kernel(prof)
    busy = sum(by_kernel.values()) / 1e6
    # The forward and optimizer spans own their kernels; the backward's run
    # on autograd's thread, so the backward is the busy time left over.
    spans = {ev.key: ev.device_time_total / 1e3 for ev in prof.key_averages()
             if ev.key in ("train_step.forward", "train_step.optimizer")}
    spans["backward (rest)"] = busy * 1e3 - sum(spans.values())
    log(f"train [{tag}] trace (one step, profiler on): wall "
        f"{traced['step_s']:.4f} "
        f"s, device busy {busy:.4f} s "
        f"({100 * busy / traced['step_s']:.1f}%); device ms by part {spans}")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:20]:
        log(f"  {us / 1e3:10.3f} ms  {name[:110]}")
    again = next(batches)
    refed = [run(again, f"re-fed batch, pass {i + 1}") for i in range(3)]
    check(refed[-1]["loss"] < refed[0]["loss"],
          "the loss did not fall on a re-fed batch")
    log(f"train [{tag}]: {tokens / step_s:.1f} tokens/s (median warm step "
        f"{step_s:.4f} s), peak memory {peak / 2 ** 30:.3f} GiB "
        f"(max_memory_allocated over the warm steps), cold step "
        f"{cold['step_s']:.3f} s")
    return {"tokens_per_s": tokens / step_s, "step_s": step_s,
            "peak_bytes": peak, "busy_s": busy,
            "traced_wall_s": traced["step_s"], "launches": launches,
            "launches_per_step": {k_: v / steps_warm
                                  for k_, v in launches.items()},
            "by_kernel_ms": {k_: v / 1e3 for k_, v in by_kernel.items()},
            "span_device_ms": spans,
            "history": history, "n_params": n_params,
            "gmm_backend": step_fn.resolved_backend.name}


def cpu_train_crosscheck(dev, **overrides):
    """Phase 9: one training step of the reduced Mixtral (float32) with
    ``overrides`` from the same weights and batch on the card and on the
    CPU."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.interop import init_params
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import init_adamw, tree_leaves
    cfg = get_config("mixtral-8x7b").reduced().replace(use_pallas=True,
                                                       **overrides)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10,
                       batch_size=2, seq_len=128)
    gen = torch.Generator(device=dev).manual_seed(0)
    p_card = init_params(cfg, gen, dev, dtype=torch.float32)
    p_cpu = _to_device(p_card, torch.device("cpu"))
    batch = next(make_batch_iterator(cfg.vocab_size, tcfg.seq_len,
                                     tcfg.batch_size, 0))
    out = {}
    for name, p, device in (("card", p_card, dev),
                            ("cpu", p_cpu, torch.device("cpu"))):
        step = make_train_step(cfg, tcfg, device)
        _, _, m = step(p, init_adamw(p), batch)
        out[name] = {k_: float(v) for k_, v in m.items()}
    lr = tcfg.learning_rate
    worst, n_far, n_all = 0.0, 0, 0
    for a, b in zip(tree_leaves(p_card), tree_leaves(p_cpu)):
        err = (a.detach().cpu() - b.detach()).abs()
        worst = max(worst, float(err.max()))
        far = int((err > 2e-3 * lr).sum())
        check(far <= STEP_FAR_SHARE * err.numel(),
              f"train cross-check: {far} of {err.numel()} elements of a "
              "leaf moved apart by more than 2e-3 lr")
        n_far += far
        n_all += err.numel()
    log(f"train cross-check {overrides} (reduced Mixtral, float32, one "
        f"step): card "
        f"{out['card']} vs cpu {out['cpu']}; parameters max |diff| "
        f"{worst:.3g} (lr {lr}), {n_far} of {n_all} beyond 2e-3 lr")
    for key in ("loss", "ce", "grad_norm"):
        check(abs(out["card"][key] - out["cpu"][key])
              <= STEP_RTOL * abs(out["cpu"][key]),
              f"train cross-check: {key} differs")
    check(worst <= lr, "train cross-check: a parameter moved apart by more "
          "than lr")
    return {"card": out["card"], "cpu": out["cpu"], "param_max_diff": worst,
            "param_far": n_far}


def _device_time_by_kernel(prof) -> dict[str, float]:
    """Self device time (us) of each device kernel in a profiler trace
    (the training step's named spans are ranges, not kernels)."""
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if (us > 0 and ev.device_type.name == "CUDA"
                and not ev.key.startswith("train_step.")):
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
    return tree.detach().to(device, copy=True)


if __name__ == "__main__":
    sys.exit(main())
