#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. card — the ``nvidia-smi`` name and power limit;
2. build — the thirteen CUDA kernels from ``src/repro_torch/csrc`` (one
   nvcc per source, in parallel);
3. parity — each kernel against its plain PyTorch version on the card, in
   bf16 at the serving and training shapes (Mixtral-8x7B: d=4096, 32/8
   heads of 128, E=8, top-2, expert width 14336; training 2 x 2048 tokens,
   8192 slots), plus edge cases: empty experts, all slots on one expert,
   slot counts that are not a multiple of the tile, position 0 and a dead
   page table, windows shorter than the sequence, positions on and across
   the boundaries of paged attention's splits and a window that starts
   inside a split, softcaps, float32; gather-GMM's wgmma instantiations
   (the dual branch with and without ``save_ab``, the w3 forward, the
   transposed w3 and w1) at their tile edges (an expert of one row with
   300 slots and rows past the routed total, every slot on one expert,
   widths off the tiles), each call repeated bit-equal; the grouped
   weight gradient's bf16 kernel at dw1, dw2 and dw3 of the training
   shape, in ``ep_a2a``'s layout (rows past offsets[E], NaN there, that
   must contribute nothing) and at widths that leave partial TMA boxes,
   each call repeated bit-equal; the fused MoE pair's tile edges (two
   forward h-ranges and three backward ones with ragged last ones, an
   expert of one row, every slot on one expert, d off the 256-wide tile,
   slots past offsets[E] in ``routing.slice_dispatch``'s layout), the
   backward's dgates and weight gradients bit-equal across calls, and
   flash attention at Qwen3-14B's 40/8 heads (with a window and a
   softcap) and at S=300; the
   expert layer's autograd Functions (``blaze_pallas``, ``moe_ffn_blaze``
   on ``pallas`` in each residual mode, on ``pallas_fused`` and on
   ``ragged``, the backend ``auto`` resolves to) against
   autograd through the plain versions; ``ragged`` at Mixtral's widths
   with empty groups and rows past the group total (those rows, their
   input gradient and the empty groups' weight gradient exactly 0); and
   the bytes one full-width expert layer saves for its backward, per
   implementation;
4. timing — each kernel (median of warm runs, L2 flushed between runs
   and the host's launch time hidden behind a device sleep) at
   the prefill, decode and training shapes (gather-GMM at each of the
   training step's instantiations: the dual branch with ``save_ab``, the
   w3 forward, the backward's w3ᵀ and w1ᵀ), beside its plain version, its
   bound (the larger of bytes / 3.35 TB/s and operations / 989 TFLOP/s,
   from this run's inputs) and PyTorch calls that compute the same
   function, where there are (``torch._grouped_mm`` over pre-gathered
   rows, ``scaled_dot_product_attention``; for the fused pair the sum of
   its products as grouped_mm calls, a composition), timed only; flash
   attention at both models' training shapes (32/8 and 40/8 heads);
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
   within the float32 tolerances below;
10. the row gather — the dispatch builds of the ``ep_a2a`` path bit-equal
   to the plain build at its shapes (the pack by destination over 2 and 5
   groups, the local expert bank over 9 and 3, pads in its trash group)
   and the pack's send-buffer order against a plain pack at capacity 2.0
   and 0.25; the send-buffer kernel against its plain version, bit for
   bit, at Mixtral's width in bf16: the one-rank training buffer (2 x 2048
   tokens, 8192 rows, all valid) and one rank's buffer of four (a
   1024-token chunk packed by destination, about half the rows pads), at
   d=4100 in bf16 (the element-wise copy) and float32, from a misaligned
   source and at N=0; then their times beside the byte bound and
   ``index_select`` on clamped ids (which does not zero the pads), timed
   only;
11. the MoE layer on a mesh — this process as a one-rank NCCL group laid
   out as a (data=1, model=1) mesh; Mixtral-8x7B's MoE sublayer at full
   width (2 x 2048 tokens, bf16, ``blaze`` on ``pallas``) under ``ep``,
   ``ep_a2a`` (one and two chunks) and ``tp`` against the layer without a
   mesh: the output and the gradients of mean(y**2) (``ep`` and ``tp``
   bit-equal, since one rank runs the same kernels on the same rows),
   overflow exactly 0;
12. training ``ep_a2a`` — phase 7 with ``moe_impl="blaze"`` on ``pallas``
   and ``moe_parallel="ep_a2a"`` on the one-rank mesh (the packing, the
   row gather, the exchanges and the trash expert all run on the card):
   ``gather_rows`` exactly once per MoE layer a step, overflow 0;
13. several ranks on the one card — spawned ranks share the H100 over gloo
   (staged through host memory) at a reduced width (d=1024, expert width
   3584, 1024 tokens per rank): 2 ranks run ``ep``, ``ep_a2a`` (one and
   two chunks), ``tp`` and ``ep_a2a`` at capacity 0.25; 4 ranks run
   ``ep_a2a_hier``; 4 ranks (data=2, model=2) run one ``ep_a2a`` training
   step; each rank is held against this process's result without a mesh,
   the tight ``ep_a2a`` against this process's layer with the slots a
   plain pack drops given gate 0;
14. Qwen3-14B parity — with Mixtral's state freed, the dense model's
   kernels against their plain versions on the card in bf16 at its widths
   (d=5120, FFN width 17408, 40/8 heads of 128): the fused-SwiGLU forward,
   bwd_x and bwd_w at the training (L=4096) and decode (L=4) shapes, at a
   ragged L=300, with h or d not a multiple of the tile, with widths not
   a multiple of 8 and in float32; the ``swiglu`` autograd Function against
   autograd through the plain versions; the paged-attention kernel over
   bf16 and over int8 pages at the GQA group of 5 (a window, a softcap,
   position 0, a dead page table, split boundaries, a 2048-page table);
15. Qwen3-14B timing — those four kernels at the training, prefill and
   decode shapes, as phase 4 (library yardsticks: one ``torch.matmul``
   per kernel over w1 | w2 concatenated, the epilogue excluded;
   ``scaled_dot_product_attention`` over dequantized gathered pages);
16. Qwen3-14B serving at full width and full depth (40 layers, random
   bf16 weights from seed 0, ``use_pallas=True``): phase 5's requests,
   cold, warm (the fused-SwiGLU forward, flash attention and paged
   attention must be launched) and traced; then the same requests on an
   engine with int8 KV pages over the same weights (the int8 paged kernel
   must be launched; every first token must equal the bf16 run's, since
   prefill attends over the in-flight k/v), the share of decode tokens
   that agree, and the KV bytes per cached token of both pools;
17. Qwen3-14B CPU cross-check — phase 6 on a 2-layer cut of those weights;
18. Qwen3-14B training — with the serving weights freed, full width with
   the depth cut from 40 to 4 layers, as phase 7 (the three fused-SwiGLU
   kernels and flash attention must be launched during the warm steps);
19. Qwen3-14B CPU training cross-check — phase 9 on the reduced Qwen3-14B.

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
# CPU vs card training step (float32, reduced model): loss, grad norm and
# each gradient leaf 1e-4 relative (two layers of float32 sums in other
# orders; a gradient element over a floor of 1e-4 of its leaf's scale).  AdamW's
# first step moves each parameter by about lr (its gradient divided by its
# own magnitude), so an element whose gradient is at the float32 noise of
# the two sides (~1e-6 of its leaf's scale) may step either way: every
# element within lr, and all but 1e-3 of each leaf's elements within
# 2e-3 lr.
STEP_RTOL, STEP_FAR_SHARE = 1e-4, 1e-3
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
# The MoE layer on a mesh against the layer without one, in bf16: the
# reference's bf16 tolerance (tests/test_sharding.py:74-75, rtol = atol =
# 5e-2), with the absolute term taken relative to each output's scale (the
# gradients of mean(y**2) are of size ~1e-8): the a2a path sums each
# token's k expert outputs after rounding them to bf16 where the combine
# rounds once, and the modes sum in other orders.
LAYER_MESH_TOL = (5e-2, 5e-2)
# Ranks sharing the card (phase 13): widths (d, expert h), tokens per rank,
# and the training step's loss and grad norm against the step without a
# mesh: bf16 compute, the a2a sum over k rounded as above, and the
# load-balance loss estimated per rank's chunk -> 1e-3 relative (the
# readings are ~1e-5 for the loss and ~1e-4 for the grad norm).
MR_WIDTHS, MR_TOKENS, MR_STEP_RTOL = (1024, 3584), 1024, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


class Timer:
    """Median device time of ``fn`` over warm runs, CUDA events around each
    run, with the L2 cache flushed before each (the weights and pages a real
    step reads come from HBM).  A device-side sleep after the flush keeps
    the card busy while the host queues ``fn``'s launches, so a host slower
    than the flush adds no idle time to the reading."""

    SLEEP_CYCLES = 200_000     # ~0.1 ms at the H100's clock

    def __init__(self, dev):
        self.flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)

    def __call__(self, fn, warm: int = 2, reps: int = 10) -> float:
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def split_boundaries(KP, dev, Hkv: int, pps: int, ps: int):
    """Paged attention's kernel splits each request's page walk into runs
    of ``span`` positions.  Returns ``span`` and, for 4 requests, the
    positions on the last and the first row of a split, one row past a
    boundary and at the table's end (a window of ``2 span - 1`` then
    starts one row into a split)."""
    span = KP.split_pages(4, Hkv, pps, torch.cuda.get_device_properties(
        dev).multi_processor_count) * ps
    return span, torch.tensor([span - 1, span, 3 * span + 1, pps * ps - 1],
                              dtype=torch.int32, device=dev)


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
    from repro_torch.kernels import fused_swiglu as KS
    from repro_torch.kernels import gather_gmm as KG
    from repro_torch.kernels import gmm_dw as KW
    from repro_torch.kernels import paged_attention as KP
    from repro_torch.kernels import ops as KO
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as SE
    from repro_torch.serve import kv_quant as KQ
    from repro_torch.core import moe_layer as ML
    from repro_torch import sharding as SH
    from repro_torch.core import collectives as CL
    from repro_torch.core import memsim as MS
    from repro_torch.kernels import gather_rows as KR
    from repro_torch.launch import mesh as MESH
    from repro_torch.models import moe_block as MB
    M = SimpleNamespace(KG=KG, KW=KW, KF=KF, KC=KC, KO=KO, TR=TR, KFM=KFM,
                        ML=ML, KS=KS, KP=KP, KQ=KQ, SE=SE, T=T, K=K, SH=SH,
                        CL=CL, MS=MS, KR=KR, MESH=MESH, MB=MB)

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
                             "fused_moe_bwd", "fused_swiglu_fwd",
                             "fused_swiglu_bwd_x", "fused_swiglu_bwd_w",
                             "paged_attention_int8", "gather_rows")}

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
    span, split_pos = split_boundaries(KP, dev, Hkv, pps, ps)
    paged_case(f"split boundaries (span {span})", q_dec, table, split_pos,
               cfg.sliding_window)
    paged_case(f"window {2 * span - 1} (span {span})", q_dec, table,
               split_pos, 2 * span - 1)
    torch.cuda.synchronize()
    log(f"parity paged_attention: max |err| {errs['paged_attention']:.4g} "
        f"(atol {PAGED_ATOL})")

    # training shapes: 2 x 2048 tokens routed top-2 -> 8192 slots
    L_tr = TRAIN_BATCH * TRAIN_SEQ
    x_tr = randn(L_tr, d)
    topk_tr = TR.top_k_gating(x_tr, moe["wg"], k).topk_experts.contiguous()
    disp_tr = dispatch_case("training", topk_tr, E)
    tr = train_kernel_parity(M, dev, rng, randn, errs, moe, x_tr, disp_tr)
    gmm_edges(M, dev, errs, moe)
    dw_edges(M, dev, errs, tr, disp_tr)
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
        gmm_entry(tr["y_swi"], disp_tr, moe["w3"], None, None,
                  f"training w3 forward: S={S_tr}, {h}->{d}", plain_reps=1),
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
    mix = serving_phase(M, cfg, params, prompts, dev, (
        "build_dispatch", "gather_gmm", "combine", "paged_attention"), "")
    launches = mix["launches"]

    # -- 6. CPU cross-check -------------------------------------------------
    prompt = rng.integers(3, cfg.vocab_size, size=24).astype(np.int32)
    cpu_prefill_crosscheck(T, cfg, params, prompt, dev)

    # -- 7. training ----------------------------------------------------------
    # The training step holds ~65 GB; free the serving weights and what
    # holds them first.
    del params, moe
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
    torch.cuda.empty_cache()

    # -- 10. the row gather (the ep_a2a send buffer) ------------------------------
    rows["gather_rows"] = gather_rows_checks(M, dev, rng, timer, entry, randn,
                                             errs, dispatch_case, topk_tr)
    torch.cuda.empty_cache()

    # -- 11. the MoE layer on a one-rank NCCL mesh, full width -----------------
    mesh1 = one_rank_mesh(M, dev)
    layer1 = layer_mesh_parity(M, dev, mesh1)
    torch.cuda.empty_cache()

    # -- 12. training, ep_a2a on the one-rank mesh --------------------------------
    cfg_a2a = get_config("mixtral-8x7b").replace(
        num_layers=2, gmm_backend="pallas", moe_parallel="ep_a2a",
        use_pallas=True)
    train_a2a = training_phase(cfg_a2a, dev, K, (
        "build_dispatch", "gather_gmm", "gmm_dw", "flash_attention",
        "gather_rows"), "ep_a2a", mesh=mesh1,
        per_step={"gather_rows": cfg_a2a.num_layers})
    check(all(v == 0.0 for v in train_a2a["moe_overflow"]),
          "train [ep_a2a]: slots dropped at one rank")
    torch.distributed.destroy_process_group()
    del mesh1
    torch.cuda.empty_cache()

    # -- 13. several ranks on the one card ---------------------------------------
    multi = multi_rank_phase(M, dev)
    torch.cuda.empty_cache()

    # -- 14. Qwen3-14B parity ---------------------------------------------------
    qcfg = get_config("qwen3-14b").replace(use_pallas=True)
    qz = qwen_kernel_parity(M, dev, rng, randn, errs, qcfg)

    # -- 15. Qwen3-14B timing ---------------------------------------------------
    rows.update(qwen_kernel_timing(M, timer, entry, qz, randn))
    for name in ("fused_swiglu_fwd", "fused_swiglu_bwd_x",
                 "fused_swiglu_bwd_w", "paged_attention_int8"):
        for r in rows[name]:
            log(f"time {name} [{r['shape']}]: {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), library {r['library_ms']}")
    del qz

    # -- 16. Qwen3-14B serving, 40 layers, bf16 then int8 pages ----------------
    gen = torch.Generator(device=dev).manual_seed(0)
    qparams = init_params(qcfg, gen, dev)
    torch.cuda.synchronize()
    q_weight_bytes = sum(t.numel() * t.element_size()
                         for t in _leaves(qparams))
    log(f"weights: {qcfg.name} full width and full depth, "
        f"{qcfg.num_layers} layers, {q_weight_bytes / 1e9:.2f} GB bf16")
    qprompts = [rng.integers(3, qcfg.vocab_size, size=n).astype(np.int32)
                for n in prompt_lens]
    qserve = serving_phase(M, qcfg, qparams, qprompts, dev, (
        "fused_swiglu_fwd", "flash_attention", "paged_attention"),
        " [qwen3-14b bf16 pages]")
    qserve8 = serving_phase(M, qcfg, qparams, qprompts, dev, (
        "fused_swiglu_fwd", "flash_attention", "paged_attention_int8"),
        " [qwen3-14b int8 pages]", kv_dtype="int8")
    first_equal = all(a[0] == b[0] for a, b in zip(qserve["tokens"],
                                                   qserve8["tokens"]))
    pairs = [(x, y) for a, b in zip(qserve["tokens"], qserve8["tokens"])
             for x, y in zip(a[1:], b[1:])]
    n_agree = sum(x == y for x, y in pairs)
    log(f"int8 vs bf16 pages: first tokens equal {first_equal}; decode "
        f"tokens agreeing {n_agree / len(pairs):.4f} ({n_agree} of "
        f"{len(pairs)}); KV bytes per cached token bf16 "
        f"{qserve['kv_bytes_per_token']} / int8 "
        f"{qserve8['kv_bytes_per_token']}")
    check(first_equal, "int8 pages changed a first token")
    check(qserve["kv_bytes_per_token"] == 163840
          and qserve8["kv_bytes_per_token"] == 83200,
          "KV bytes per token are not 163,840 (bf16) and 83,200 (int8)")

    # -- 17. Qwen3-14B CPU cross-check, 2-layer cut ------------------------------
    qprompt = rng.integers(3, qcfg.vocab_size, size=24).astype(np.int32)
    qx = cpu_prefill_crosscheck(T, qcfg.replace(num_layers=2),
                                dict(qparams, layers=qparams["layers"][:2]),
                                qprompt, dev, allow_near_tie=True)
    del qparams
    torch.cuda.empty_cache()

    # -- 18. Qwen3-14B training, 4 layers --------------------------------------
    cfg_qtrain = get_config("qwen3-14b").replace(num_layers=4,
                                                 use_pallas=True)
    qtrain = training_phase(cfg_qtrain, dev, K, (
        "fused_swiglu_fwd", "fused_swiglu_bwd_x", "fused_swiglu_bwd_w",
        "flash_attention"), "qwen3-14b")
    torch.cuda.empty_cache()

    # -- 19. Qwen3-14B CPU training cross-check ----------------------------------
    # One element of a leaf may step apart: in the reduced Qwen3-14B a
    # 256-wide norm scale has an element whose gradient is ~1.7e-5 of its
    # leaf's scale, which clipping (grad norm ~8) brings to a few AdamW
    # epsilons, so its update follows the float32 noise of the two sides
    # (gradients agree to ~2e-6 of each leaf's scale, measured on the card);
    # a share of 1e-3 of 256 elements allows none.
    xcheck_q = cpu_train_crosscheck(dev, arch="qwen3-14b", far_floor=1)

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
        "fused_swiglu_fwd": ("src/repro_torch/csrc/fused_swiglu.cu",
                             "src/repro/kernels/fused_swiglu.py:69"),
        "fused_swiglu_bwd_x": ("src/repro_torch/csrc/fused_swiglu.cu",
                               "src/repro/kernels/fused_swiglu.py:124"),
        "fused_swiglu_bwd_w": ("src/repro_torch/csrc/fused_swiglu.cu",
                               "src/repro/kernels/fused_swiglu.py:180"),
        "paged_attention_int8": ("src/repro_torch/csrc/paged_attention.cu",
                                 "src/repro/kernels/paged_attention.py:97"),
        "gather_rows": ("src/repro_torch/csrc/gather_rows.cu",
                        "src/repro/kernels/gather_gmm.py:680"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        main_row = rows[name][0]
        # launches on the main path that runs the kernel: the warm steps of
        # the fused training phase for the fused pair, of the Qwen3-14B one
        # for the fused SwiGLU kernels, of the blaze_pallas one for the
        # others, or a warm serving run (Mixtral; Qwen3-14B over int8 pages
        # for the int8 kernel) for a kernel that training does not run
        if name.startswith("fused_swiglu"):
            n_train, n_serve = (qtrain["launches"][name],
                                qserve["launches"][name])
        elif name == "paged_attention_int8":
            n_train, n_serve = 0, qserve8["launches"][name]
        elif name == "gather_rows":
            n_train, n_serve = train_a2a["launches"][name], 0
        else:
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
    for tag, rec, nbytes in (("", mix, n_weight_bytes),
                             (" [qwen3-14b bf16 pages]", qserve,
                              q_weight_bytes),
                             (" [qwen3-14b int8 pages]", qserve8,
                              q_weight_bytes)):
        rec = {k_: v for k_, v in rec.items()
               if k_ not in ("tokens", "launches")}
        log(f"e2e-record{tag}: "
            f"{json.dumps(dict(rec, weight_bytes=nbytes))}")
    log(f"cpu cross-check [qwen3-14b, 2-layer cut]: {json.dumps(qx)}")
    log(f"layer-record [one-rank mesh]: {json.dumps(layer1)}")
    log(f"multi-rank-record: {json.dumps(multi)}")
    for tag, rec, xc in (("blaze_pallas", train, xcheck),
                         ("blaze+pallas_fused", train_fused, xcheck_fused),
                         ("ep_a2a", train_a2a, None),
                         ("qwen3-14b", qtrain, xcheck_q)):
        rec = {k_: v for k_, v in rec.items() if k_ != "by_kernel_ms"}
        log(f"train-record [{tag}]: "
            f"{json.dumps(dict(rec, crosscheck=xc))}")
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def serving_phase(M, cfg, params, prompts, dev, required, tag,
                  kv_dtype=None) -> dict:
    """Phases 5 and 16: ``prompts`` (16 new tokens each) served by the
    port's engine on 4 slots (capacity 1024, 16-token pages) three times:
    cold, then warm (measured: every kernel in ``required`` must be
    launched during this run), then traced with torch.profiler (device
    time by kernel, device busy share); all three must give the same
    tokens.  Returns the measurements."""
    SE, T, K = M.SE, M.T, M.K
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
                             page_size=16, kv_dtype=kv_dtype, device=dev)
        reqs = [SE.Request(prompt=p, max_new_tokens=16,
                           eos_id=cfg.vocab_size) for p in prompts]
        eng.generate(reqs)
        return eng, reqs

    # Cold run: the first call of each prefill bucket and of the decode
    # step pays one-time costs (library heuristics, allocator growth);
    # the main run below is measured warm.
    t0 = time.perf_counter()
    eng, reqs_cold = serve()
    torch.cuda.synchronize()
    cold_wall = time.perf_counter() - t0
    kv_bytes = eng.kv_bytes_per_token
    del eng
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
    st = dict(eng.stats)
    del eng
    log(f"e2e{tag} launches: {launches}")
    for name in required:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the serving path{tag}")
    for r in reqs:
        check(len(r.out_tokens) == 16 and r.finish_reason == "length",
              f"request of {r.prompt.size} tokens: {r.out_tokens}")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              "token out of range")
    pre_tps = st["prefill_tokens"] / phase_s["prefill"]
    dec_tps = st["decode_slot_tokens"] / phase_s["decode"]
    n_weight_bytes = sum(t.numel() * t.element_size()
                         for t in _leaves(params))
    log(f"e2e{tag}: cold run {cold_wall:.3f} s; warm run: "
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
    del _
    tokens = [r.out_tokens for r in reqs]
    check(tokens == [r.out_tokens for r in reqs2]
          and tokens == [r.out_tokens for r in reqs_cold],
          "repeat runs gave other tokens")
    log(f"e2e{tag}: cold, warm and traced runs gave identical tokens")
    by_kernel = _device_time_by_kernel(prof)
    busy = sum(by_kernel.values()) / 1e6
    log(f"trace{tag} (third run, profiler on): wall {traced_wall:.4f} s, "
        f"device busy {busy:.4f} s ({100 * busy / traced_wall:.1f}%)")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]:
        log(f"  {us / 1e3:10.3f} ms  {name[:110]}")
    for i, r in enumerate(reqs):
        log(f"  req[{i}] prompt {r.prompt.size} tokens -> {r.out_tokens}")
    return {"prefill_tok_per_s": pre_tps, "decode_tok_per_s": dec_tps,
            "prefill_s": phase_s["prefill"], "decode_s": phase_s["decode"],
            "peak_bytes": peak, "wall_s": wall, "cold_wall_s": cold_wall,
            "traced_wall_s": traced_wall, "traced_device_busy_s": busy,
            "stats": st, "kv_bytes_per_token": kv_bytes,
            "launches": launches, "tokens": tokens}


def cpu_prefill_crosscheck(T, cfg, params, prompt, dev,
                           allow_near_tie=False) -> dict:
    """Phases 6 and 17: one 24-token prompt through the same weights on the
    card and copied to the CPU (plain versions there); the prefill logits
    must agree within ``CPU_LOGIT_ATOL`` and give the same first token.
    With ``allow_near_tie`` (a vocabulary of 151,936 random logits, whose
    top two can lie closer than the tolerance) the first tokens may differ
    only where the card's top two logits are within the tolerance of each
    other."""
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
    del cpu_params
    check(gpu_logits.shape == (1, cfg.vocab_size), "logits shape")
    check(bool(torch.isfinite(gpu_logits).all()), "card logits not finite")
    diff = float((gpu_logits - cpu_logits).abs().max())
    top2 = torch.topk(gpu_logits[0], 2).values
    gap = float(top2[0] - top2[1])
    tok_card, tok_cpu = int(gpu_logits.argmax()), int(cpu_logits.argmax())
    log(f"cpu cross-check [{cfg.name}, {cfg.num_layers} layers]: max "
        f"|logit diff| {diff:.4g} (tol {CPU_LOGIT_ATOL}), max |logit| "
        f"{float(gpu_logits.abs().max()):.3f}, first token card {tok_card} "
        f"/ cpu {tok_cpu}, card top-2 gap {gap:.4g}, cpu prefill "
        f"{cpu_s:.1f} s")
    check(diff <= CPU_LOGIT_ATOL, "CPU and card logits disagree")
    check(tok_card == tok_cpu or (allow_near_tie and gap <= CPU_LOGIT_ATOL),
          "CPU and card first tokens differ")
    return {"max_logit_diff": diff, "first_token_card": tok_card,
            "first_token_cpu": tok_cpu, "top2_gap": gap, "cpu_s": cpu_s}


def qwen_kernel_parity(M, dev, rng, randn, errs, cfg) -> dict:
    """Phase 14: the fused-SwiGLU kernels and the int8 paged-attention
    kernel against their plain versions at Qwen3-14B's widths, and the
    ``swiglu`` autograd Function against autograd through the plain
    versions.  Returns the weights and the int8 decode inputs for the
    timing."""
    KS, KP, KQ = M.KS, M.KP, M.KQ
    d, h = cfg.d_model, cfg.d_ff
    w1 = randn(d, h, scale=d ** -0.5)
    w2 = randn(d, h, scale=d ** -0.5)
    names = ("fused_swiglu_fwd",) * 3 + ("fused_swiglu_bwd_x",) + \
        ("fused_swiglu_bwd_w",) * 2

    def case(name, L, w1_, w2_):
        dt = w1_.dtype
        x = randn(L, w1_.shape[0], dtype=dt)
        dy = randn(L, w1_.shape[1], dtype=dt)
        got = list(KS.fused_swiglu_fwd(x, w1_, w2_))
        want = list(KS.fused_swiglu_fwd_plain(x, w1_, w2_))
        a, b = got[1], got[2]
        got.append(KS.fused_swiglu_bwd_x(dy, a, b, w1_, w2_))
        want.append(KS.fused_swiglu_bwd_x_plain(dy, a, b, w1_, w2_))
        got += KS.fused_swiglu_bwd_w(x, dy, a, b)
        want += KS.fused_swiglu_bwd_w_plain(x, dy, a, b)
        rel = []
        for key, out, g_, w_ in zip(names, ("y", "a", "b", "dx", "dw1",
                                            "dw2"), got, want):
            scale = float(w_.float().abs().max())
            if dt == BF16:
                rt, at = 0.0, FUSED_SCALE_STEP * scale + GMM_ATOL
            else:
                rt, at = F32_RTOL, F32_FLOOR * scale
            e = require_close(f"fused_swiglu {name} {out}", g_, w_, rt, at)
            errs[key] = max(errs[key], e)
            rel.append(round(e / max(scale, 1e-30), 6))
        log(f"parity fused_swiglu {name}: max |err| / scale (y, a, b, dx, "
            f"dw1, dw2) {rel}")

    case(f"training L=4096, d={d}, h={h}", 4096, w1, w2)
    case("decode L=4", 4, w1, w2)
    case("ragged L=300", 300, w1, w2)
    h_odd = h - 24        # a multiple of 8, not of the 64-wide tile
    case(f"L=300, h={h_odd}", 300, w1[:, :h_odd].contiguous(),
         w2[:, :h_odd].contiguous())
    d_odd = d - 120       # a multiple of 8, not of the 256-wide tile
    case(f"L=300, d={d_odd}", 300, w1[:d_odd].contiguous(),
         w2[:d_odd].contiguous())
    case("widths not a multiple of 8: L=37, d=100, h=140", 37,
         randn(100, 140, scale=0.1), randn(100, 140, scale=0.1))
    case("float32 L=300, d=512, h=1000", 300,
         randn(512, 1000, dtype=torch.float32, scale=512 ** -0.5),
         randn(512, 1000, dtype=torch.float32, scale=512 ** -0.5))

    for dt, tol, (L, dd, hh) in ((BF16, LAYER_BF16, (2048, d, h)),
                                 (torch.float32, LAYER_F32,
                                  (1024, 1024, 2048))):
        x = randn(L, dd, dtype=dt).requires_grad_()
        v1 = randn(dd, hh, dtype=dt, scale=dd ** -0.5).requires_grad_()
        v2 = randn(dd, hh, dtype=dt, scale=dd ** -0.5).requires_grad_()
        dy = randn(L, hh, dtype=dt)
        y = M.KO.swiglu(x, v1, v2)
        got = [y, *torch.autograd.grad(y, (x, v1, v2), dy)]
        y_p = KS.fused_swiglu_fwd_plain(x, v1, v2)[0]
        want = [y_p, *torch.autograd.grad(y_p, (x, v1, v2), dy)]
        rel = []
        for out, g_, w_ in zip(("y", "dx", "dw1", "dw2"), got, want):
            g_, w_ = g_.detach(), w_.detach()
            scale = float(w_.float().abs().max())
            rel.append(round(require_close(
                f"swiglu Function {dt} {out}", g_, w_, tol, tol * scale)
                / max(scale, 1e-30), 6))
        log(f"parity swiglu Function {dt} L={L} {dd}->{hh}: max |err| / "
            f"scale (y, dx, dw1, dw2) {rel} (tolerance {tol})")
        del x, v1, v2, dy, y, got, want

    # paged decode attention over bf16 and int8 pages at Qwen3-14B's heads
    # (a GQA group of 5, its own instantiation of the split kernel): the
    # pool of a capacity-1024 engine (int8 quantized on the card),
    # requests at the end of the serving run's prompts, position 0 and a
    # dead slot, the split boundaries, and a long-context table (2048
    # pages a request, short and long positions: more than one run of 32
    # pages per request)
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    ps, pps = 16, 64
    n_pages = 1 + 4 * pps
    kq, ks = KQ.quantize(randn(n_pages, ps, Hkv, Dh))
    vq, vs = KQ.quantize(randn(n_pages, ps, Hkv, Dh))
    q = randn(4, 1, Hq, Dh)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(2)) + 1
    table = perm[:4 * pps].reshape(4, pps).to(torch.int32).to(dev)
    pos = torch.tensor([36 + 15, 128 + 15, 299 + 15, 510 + 15],
                       dtype=torch.int32, device=dev)
    edge_table = table.clone()
    edge_table[2] = 0                                     # dead slot
    edge_pos = torch.tensor([0, 700, 0, 1000], dtype=torch.int32,
                            device=dev)
    span, split_pos = split_boundaries(KP, dev, Hkv, pps, ps)
    long_pps = 2048
    long_table = torch.randint(1, n_pages, (4, long_pps), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(3)
                               ).to(dev)
    long_pos = torch.tensor([5, 600, 20000, long_pps * ps - 1],
                            dtype=torch.int32, device=dev)
    long_span = KP.split_pages(4, Hkv, long_pps, torch.cuda
                               .get_device_properties(dev)
                               .multi_processor_count) * ps
    # bf16 pages from their own generator: later phases draw from `rng`
    g_pages = torch.Generator(device=dev).manual_seed(4)
    kb, vb = (torch.randn(n_pages, ps, Hkv, Dh, generator=g_pages,
                          device=dev, dtype=BF16) for _ in range(2))
    cases = (
        ("decode", table, pos, 0, 0.0),
        ("window 100, softcap 30", table, pos, 100, 30.0),
        ("pos 0 + dead table", edge_table, edge_pos, 0, 0.0),
        (f"split boundaries (span {span})", table, split_pos, 0, 0.0),
        (f"window {2 * span - 1} (span {span})", table, split_pos,
         2 * span - 1, 0.0),
        (f"{long_pps} pages a request (span {long_span})", long_table,
         long_pos, 0, 0.0),
        (f"{long_pps} pages a request, window 700", long_table, long_pos,
         700, 0.0))
    for name, (kernel, plain, pages) in (
            ("paged_attention", (KP.paged_attention,
                                 KP.paged_attention_plain, (kb, vb))),
            ("paged_attention_int8", (KP.paged_attention_int8,
                                      KP.paged_attention_int8_plain,
                                      (kq, vq, ks, vs)))):
        for case_name, tab, ps_, window, cap in cases:
            args = (q, *pages, tab, ps_)
            got = kernel(*args, window=window, cap=cap)
            want = plain(*args, window=window, cap=cap)
            errs[name] = max(errs[name], require_close(
                f"{name} {case_name} ({Hq}/{Hkv} heads)", got, want, 0.0,
                PAGED_ATOL))
        torch.cuda.synchronize()
        log(f"parity {name} ({Hq}/{Hkv} heads of {Dh}; "
            f"{'; '.join(c[0] for c in cases)}): max |err| "
            f"{errs[name]:.4g} (atol {PAGED_ATOL})")
    del kb, vb, long_table
    return {"w1": w1, "w2": w2, "paged": (q, kq, vq, ks, vs, table, pos)}


def qwen_kernel_timing(M, timer, entry, qz, randn) -> dict:
    """Phase 15: the fused-SwiGLU kernels at the training (L=4096),
    prefill (L=2048, the serving run's 4 x 512 bucket) and decode (L=4)
    shapes, and the int8 paged kernel at decode, each beside its plain
    version, its bound and a library yardstick: ``torch.matmul`` of the
    kernel's products with w1 | w2 concatenated (the elementwise terms
    excluded), ``scaled_dot_product_attention`` over pages dequantized and
    gathered beforehand."""
    KS, KP, KQ = M.KS, M.KP, M.KQ
    w1, w2 = qz["w1"], qz["w2"]
    d, h = w1.shape
    w12 = torch.cat([w1, w2], dim=1)                       # (d, 2h)
    rows = {n: [] for n in ("fused_swiglu_fwd", "fused_swiglu_bwd_x",
                            "fused_swiglu_bwd_w", "paged_attention_int8")}
    for label, L in (("training", 4096), ("prefill", 2048), ("decode", 4)):
        x, dy = randn(L, d), randn(L, h)
        _, a, b = KS.fused_swiglu_fwd(x, w1, w2)
        dadb = torch.cat(KS.swiglu_grads(dy, a, b, BF16), dim=1)
        ops = 4.0 * L * d * h
        reps = 3 if L > 4 else 5
        shape = f"{label}: L={L}, d={d}, h={h}"
        rows["fused_swiglu_fwd"].append(entry(
            timer(lambda: KS.fused_swiglu_fwd(x, w1, w2)),
            timer(lambda: KS.fused_swiglu_fwd_plain(x, w1, w2), warm=1,
                  reps=reps),
            (L * d + 2 * d * h + 3 * L * h) * EB, ops,
            timer(lambda: torch.matmul(x, w12)),
            shape + " (library: x @ [w1|w2])"))
        rows["fused_swiglu_bwd_x"].append(entry(
            timer(lambda: KS.fused_swiglu_bwd_x(dy, a, b, w1, w2)),
            timer(lambda: KS.fused_swiglu_bwd_x_plain(dy, a, b, w1, w2),
                  warm=1, reps=reps),
            (3 * L * h + 2 * d * h + L * d) * EB, ops,
            timer(lambda: torch.matmul(dadb, w12.t())),
            shape + " (library: [da|db] @ [w1|w2]^T)"))
        rows["fused_swiglu_bwd_w"].append(entry(
            timer(lambda: KS.fused_swiglu_bwd_w(x, dy, a, b)),
            timer(lambda: KS.fused_swiglu_bwd_w_plain(x, dy, a, b), warm=1,
                  reps=reps),
            (L * d + 3 * L * h + 2 * d * h) * EB, ops,
            timer(lambda: torch.matmul(x.t(), dadb)),
            shape + " (library: x^T @ [da|db])"))
        del x, dy, a, b, dadb
    del w12

    q, kq, vq, ks, vs, table, pos = qz["paged"]
    B, _, Hq, Dh = q.shape
    ps, Hkv = kq.shape[1], kq.shape[2]
    live = [int(p_) + 1 for p_ in pos.tolist()]
    nbytes = (2 * q.numel() * EB + sum(live) * Hkv * 2 * (Dh + 2)
              + sum(-(-n // ps) for n in live) * 4 + 4 * B)
    ops = 4.0 * sum(live) * Hq * Dh
    T_all = table.shape[1] * ps
    pt = table.long()
    kd = KQ.dequantize(kq[pt], ks[pt], BF16).reshape(
        B, T_all, Hkv, Dh).transpose(1, 2)
    vd = KQ.dequantize(vq[pt], vs[pt], BF16).reshape(
        B, T_all, Hkv, Dh).transpose(1, 2)
    mask = (torch.arange(T_all, device=q.device)[None, :]
            <= pos[:, None].long())
    qd = q.transpose(1, 2)
    args = (q, kq, vq, ks, vs, table, pos)
    rows["paged_attention_int8"].append(entry(
        timer(lambda: KP.paged_attention_int8(*args)),
        timer(lambda: KP.paged_attention_int8_plain(*args)),
        nbytes, ops,
        timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask[:, None, None, :], enable_gqa=True)),
        f"decode: B={B}, Hq={Hq}, Hkv={Hkv}, Dh={Dh}, int8 pages of {ps}, "
        f"positions {pos.tolist()}"))
    return rows


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
    """Phase 3, training kernels: gather-GMM with ``save_ab``, the w3
    forward over identity rows and with transposed weights, the grouped
    weight gradient and flash attention at
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
    gmm_close("training w3 forward",
              KG.gather_gmm(y_swi, None, off, moe["w3"], epilogue=False),
              KG.gather_gmm_plain(y_swi, None, off, moe["w3"],
                                  epilogue=False))
    dyg = randn(S, d)
    da = randn(S, h, scale=0.05)
    for name, rows_, w in (("w3^T", dyg, moe["w3"]), ("w1^T", da, moe["w1"])):
        gmm_close(f"training {name}",
                  KG.gather_gmm(rows_, None, off, w, epilogue=False,
                                trans_w=True),
                  KG.gather_gmm_plain(rows_, None, off, w, epilogue=False,
                                      trans_w=True))

    def dw_case(name, lhs, dout, offsets):
        got, again = (KW.gmm_dw(lhs, dout, offsets) for _ in range(2))
        check(torch.equal(got, again),
              f"gmm_dw {name}: a repeated call differs")
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
    # Qwen3-14B's heads (40/8, G = 5) at its training shape, and a window
    # shorter than the sequence with a softcap
    q40 = randn(B, T_, 40, 128)
    flash_case("qwen3-14b heads 40/8", q40, kk, vv, 0, 0.0)
    flash_case("qwen3-14b heads, window 700, softcap 30", q40, kk, vv, 700,
               30.0)
    flash_case("S=300, Dh 64", randn(1, 300, 8, 64), randn(1, 300, 2, 64),
               randn(1, 300, 2, 64), 0, 0.0)
    layer_function_parity(M, dev, rng)
    ragged_edges(M, dev)
    return {"x": x_tr, "xg": xg, "dyg": dyg, "da": da, "y_swi": y_swi,
            "q": q, "q40": q40, "k": kk, "v": vv}


def layer_function_parity(M, dev, rng):
    """The expert layer's autograd Functions on the card against autograd
    through the plain versions (E=8, top-2, L=2048, widths 1024 -> 2048),
    in float32 and bf16: y, dx, dgates, dw1, dw2, dw3.  The kernel
    composition (``blaze_pallas``), ``moe_ffn_blaze`` on the ``pallas``
    backend in each residual mode, on ``pallas_fused``, and on ``ragged``
    (``torch._grouped_mm``, what ``gmm_backend="auto"`` resolves to)."""
    L, d, h, E, k = 2048, 1024, 2048, 8, 2
    impls = [("blaze_pallas", lambda *a: M.KO.moe_ffn_blaze_pallas(*a))] + [
        (f"blaze+pallas {m}", lambda *a, m=m: M.ML.moe_ffn_blaze(
            *a, residuals=m, backend="pallas"))
        for m in ("ab_yswi", "ab", "x")] + [
        ("blaze+pallas_fused", lambda *a: M.ML.moe_ffn_blaze(
            *a, backend="pallas_fused")),
        ("blaze+ragged", lambda *a: M.ML.moe_ffn_blaze(
            *a, backend="ragged"))]
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


def gmm_edges(M, dev, errs, moe):
    """Phase 3, gather-GMM's tile edges: each bf16 instantiation (the dual
    branch over gathered rows with and without ``save_ab``, the w3
    forward over identity rows, the backward's transposed w3 and w1)
    against its plain version (GMM_RTOL, GMM_ATOL) for an expert of one
    row with S = 300 slots and rows past offsets[E], every slot on one
    expert, and widths off the tiles (d = 328, h = 520, with empty
    experts); rows past offsets[E] exactly 0, and a repeated call
    bit-equal (every output element has one block, so no order of
    blocks shows).  Its inputs come from their own generator, so the
    later phases draw what they drew before these cases were added."""
    KG = M.KG
    gen = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(BF16)

    mix = (moe["w1"], moe["w2"], moe["w3"])
    d_, h_ = 328, 520
    cases = (("one-row expert", (1, 130, 0, 169, 0, 0, 0, 0), 20, *mix),
             ("one expert", (0, 0, 0, 0, 0, 300, 0, 0), 0, *mix),
             (f"d={d_}, h={h_}, empty experts", (0, 200, 0, 77), 23,
              randn(4, d_, h_, scale=d_ ** -0.5),
              randn(4, d_, h_, scale=d_ ** -0.5),
              randn(4, h_, d_, scale=h_ ** -0.5)))
    for name, lengths, past, w1, w2, w3 in cases:
        d, h = w1.shape[1], w1.shape[2]
        S = sum(lengths) + past
        L = S // 2
        x = randn(L, d)
        idx = torch.randint(0, L, (S,), generator=gen, device=dev,
                            dtype=torch.int32)
        off = torch.tensor([0, *np.cumsum(lengths)], dtype=torch.int32,
                           device=dev)
        rows_h, rows_d = randn(S, h), randn(S, d)
        for call, args, kw in (
                ("dual + save_ab", (x, idx, off, w1, w2), dict(save_ab=True)),
                ("dual", (x, idx, off, w1, w2), {}),
                ("w3 forward", (rows_h, None, off, w3), dict(epilogue=False)),
                ("w3^T", (rows_d, None, off, w3),
                 dict(epilogue=False, trans_w=True)),
                ("w1^T", (rows_h, None, off, w1),
                 dict(epilogue=False, trans_w=True))):
            got, again = (KG.gather_gmm(*args, **kw) for _ in range(2))
            want = KG.gather_gmm_plain(*args, **kw)
            got, again, want = ((t,) if isinstance(t, torch.Tensor) else t
                                for t in (got, again, want))
            for g_, a_, w_ in zip(got, again, want):
                errs["gather_gmm"] = max(errs["gather_gmm"], require_close(
                    f"gather_gmm {name} {call}", g_, w_, GMM_RTOL, GMM_ATOL))
                check(torch.equal(g_, a_),
                      f"gather_gmm {name} {call}: a repeated call differs")
                check(not bool(g_[sum(lengths):].any()),
                      f"gather_gmm {name} {call}: rows past offsets[E] "
                      f"not zero")
        log(f"parity gather_gmm edges [{name}: groups {lengths}, {past} rows "
            f"past offsets[E], {d}->{h}]: dual + save_ab, dual, w3 forward, "
            f"w3^T, w1^T within tolerance, repeated calls bit-equal, "
            f"trailing rows 0")


def dw_edges(M, dev, errs, tr, disp_tr):
    """Phase 3, the grouped weight gradient's bf16 kernel at what the
    paths give it beyond dw1 and dw3: dw2 at the training shape (x rows
    against db); ``ep_a2a``'s layout, whose rows past offsets[E] (the pad
    and overflow rows of the trash group, here NaN) must contribute
    nothing; widths that leave partial TMA boxes (d = 328, h = 520) with
    empty experts, one expert holding every row, and rows past offsets[E].
    Each against its plain version (GMM_RTOL, GMM_ATOL), empty experts
    exactly 0, a repeated call bit-equal.  Inputs come from their own
    generator, so later phases draw what they drew before."""
    KW, TR = M.KW, M.TR
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(BF16)

    def case(name, lhs, dout, off):
        got, again = (KW.gmm_dw(lhs, dout, off) for _ in range(2))
        want = KW.gmm_dw_plain(lhs, dout, off)
        errs["gmm_dw"] = max(errs["gmm_dw"], require_close(
            f"gmm_dw {name}", got, want, GMM_RTOL, GMM_ATOL))
        check(torch.equal(got, again),
              f"gmm_dw {name}: a repeated call differs")
        for ex, n in enumerate((off[1:] - off[:-1]).tolist()):
            check(n > 0 or not bool(got[ex].any()),
                  f"gmm_dw {name}: empty expert {ex} not zero")

    S, h = disp_tr.num_slots, tr["da"].shape[1]
    case(f"training dw2: S={S}", tr["xg"], randn(S, h, scale=0.05),
         disp_tr.expert_token_offsets)
    # ep_a2a: received k = 1 slots against 2 local experts, built over 3
    # groups (the last collects pads and overflow) and sliced to the real
    # range, so the trash rows lie past offsets[E]
    n, E_loc = 3000, 2
    ids = torch.randint(0, 4, (n, 1), generator=gen, device=dev,
                        dtype=torch.int32).clamp_(max=E_loc)
    loc = TR.slice_dispatch(TR.build_dispatch(ids, E_loc + 1), 0, E_loc)
    off = loc.expert_token_offsets
    total = int(off[-1])
    lhs, dout = randn(n, 4096), randn(n, h, scale=0.05)
    lhs[total:], dout[total:] = float("nan"), float("nan")
    case(f"ep_a2a layout: {total} of {n} rows routed, trash rows NaN",
         lhs, dout, off)
    for name, lengths, past in (("empty experts", (0, 200, 0, 77), 23),
                                ("one expert", (0, 0, 300, 0), 0)):
        offs = torch.tensor([0, *np.cumsum(lengths)], dtype=torch.int32,
                            device=dev)
        n_ = sum(lengths) + past
        lhs, dout = randn(n_, 328), randn(n_, 520)
        lhs[sum(lengths):] = float("nan")
        case(f"d=328, h=520, {name}, groups {lengths}, {past} rows past "
             f"offsets[E]", lhs, dout, offs)
    log(f"parity gmm_dw edges: dw2 at S={S}, the ep_a2a layout ({total} of "
        f"{n} rows routed, NaN past offsets[E]), d=328 x h=520 with empty "
        f"experts and with one expert: within tolerance, empty experts 0, "
        f"repeated calls bit-equal")


def ragged_edges(M, dev):
    """``ragged`` (``torch._grouped_mm``) at Mixtral's widths with empty
    groups and rows past the group total, in bf16 (the launchers' dtype)
    and float32: ``gmm``'s trailing rows, their input gradient and an
    empty group's weight gradient must be exactly 0, and the rest must
    match ``segment`` (each output within LAYER_BF16 / LAYER_F32 of its
    scale)."""
    GB = M.MB.GB
    d, h, S = 4096, 14336, 1000
    lengths = (300, 0, 41, 0, 200, 0, 77, 0)
    total = sum(lengths)
    empty = [e for e, n in enumerate(lengths) if not n]
    sizes = torch.tensor(lengths, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    for dt, tol in ((BF16, LAYER_BF16), (torch.float32, LAYER_F32)):
        def make(*shape, s=1.0):
            return (torch.randn(*shape, generator=gen, device=dev) * s).to(dt)
        lhs = make(S, d).requires_grad_()
        rhs = make(len(lengths), d, h, s=d ** -0.5).requires_grad_()
        dout = make(S, h)
        y = GB.RaggedBackend.gmm(lhs, rhs, sizes)
        dlhs, drhs = torch.autograd.grad(y, (lhs, rhs), dout)
        torch.cuda.synchronize()
        check(bool((y[total:] == 0).all()) and bool((dlhs[total:] == 0)
                                                    .all()),
              f"ragged {dt}: rows past the group total are not 0")
        check(bool((drhs[empty] == 0).all()),
              f"ragged {dt}: an empty group's weight gradient is not 0")
        lhs0, rhs0 = lhs.detach(), rhs.detach()
        errs = []
        for name, got, want in (
                ("gmm", y, GB.SegmentBackend.gmm(lhs0, rhs0, sizes)),
                ("gmm_dw", drhs,
                 GB.SegmentBackend.gmm_dw(lhs0, dout, sizes))):
            scale = float(want.float().abs().max())
            errs.append(require_close(f"ragged {dt} {name}", got.detach(),
                                      want, tol, tol * scale)
                        / max(scale, 1e-30))
        log(f"parity ragged edges {dt} (groups {lengths}, {S} rows, "
            f"{d}->{h}): trailing rows, their dx and empty groups' dw "
            f"exactly 0; max |err| / scale (gmm, gmm_dw) "
            f"{[round(e, 6) for e in errs]} (tolerance {tol})")
        del lhs, rhs, dout, y, dlhs, drhs


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
    multiple of the row tile, in float32 at a small shape, at the tile
    edges of both directions' h-ranges, and with slots past offsets[E]
    (``routing.slice_dispatch``'s layout, inputs from their own
    generator).  In bf16 the backward runs twice: dgates and dw1-3 must
    be bit-equal (one writer per element), and dgates past offsets[E]
    exactly 0.  Returns the training- and decode-shape inputs for the
    timing."""
    KFM = M.KFM
    E, k = moe["w1"].shape[0], 2
    w = (moe["w1"], moe["w2"], moe["w3"])

    def case(name, x, disp, g_slot, ws, dy=None):
        idx, off = disp.expert_token_indices, disp.expert_token_offsets
        if dy is None:
            dy = randn(*x.shape, dtype=x.dtype)
        got = [KFM.fused_moe_fwd(x, g_slot, idx, off, *ws)]
        want = [KFM.fused_moe_fwd_plain(x, g_slot, idx, off, *ws)]
        got += KFM.fused_moe_bwd(x, dy, g_slot, idx, off, *ws)
        want += KFM.fused_moe_bwd_plain(x, dy, g_slot, idx, off, *ws)
        if x.dtype == BF16:
            # one writer per element of dgates and dw1-3 (dx sums by atomics)
            again = KFM.fused_moe_bwd(x, dy, g_slot, idx, off, *ws)
            for out, g_, a_ in zip(("dgates", "dw1", "dw2", "dw3"), got[2:],
                                   again[1:]):
                check(torch.equal(g_, a_),
                      f"fused_moe {name} {out}: a repeated call differs")
            del again
            total = int(off[-1])
            check(not bool(got[2][total:].any()),
                  f"fused_moe {name}: dgates past offsets[E] not zero")
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
        h_ = ws[0].shape[2]
        plan = [w_ for _, w_ in KFM.h_ranges(
            h_, KFM.bwd_pass_width(idx.shape[0], h_))]
        log(f"parity fused_moe {name}: max |err| / scale (y, dx, dgates, "
            f"dw1, dw2, dw3) {rel}; backward h-ranges {plan}"
            + ("; repeated backward bit-equal" if x.dtype == BF16 else ""))
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
    # The bf16 forward's tile edges: all slots on one expert at full width
    # (k = 1); S = 8192 slots plan h-ranges of 2048, so h = 2600 runs two
    # passes with a ragged last range of 552; an expert holding one row
    # with d = 328, not a multiple of the 256-wide d tile.
    one = M.TR.build_dispatch(torch.full((2048, 1), 3, dtype=torch.int32,
                                         device=dev), E)
    x_one = x_tr[:2048].contiguous()
    case("all slots on expert 3, S=2048", x_one, one,
         torch.rand(2048, device=dev), w)
    for name, L_, d_, h_, one_row in (
            ("two passes, ragged last range, h=2600", 4096, 256, 2600,
             False),
            ("one-row expert, d=328", 129, 328, 264, True)):
        x_ = randn(L_, d_)
        ws_ = (randn(E, d_, h_, scale=d_ ** -0.5),
               randn(E, d_, h_, scale=d_ ** -0.5),
               randn(E, h_, d_, scale=h_ ** -0.5))
        if one_row:   # expert 0 takes token 0's first slot and no other
            pick = np.stack([rng.choice(np.arange(1, E), size=k,
                                        replace=False) for _ in range(L_)])
            pick[0, 0] = 0
            topk_ = torch.from_numpy(pick.astype(np.int32)).to(dev)
        else:
            topk_ = M.TR.top_k_gating(x_, randn(d_, E), k).topk_experts
        disp_ = M.TR.build_dispatch(topk_.contiguous(), E)
        if one_row:
            check(disp_.expert_lengths.tolist()[0] == 1,
                  "one-row case: expert 0 does not hold one row")
        else:
            check([w for _, w in KFM.h_ranges(
                h_, KFM.pass_width(disp_.num_slots, h_))] == [2048, 552],
                  "two-pass case: the plan is not two ranges of 2048, 552")
            check([w for _, w in KFM.h_ranges(
                h_, KFM.bwd_pass_width(disp_.num_slots, h_))]
                  == [1280, 1280, 40],
                  "two-pass case: the backward's plan is not 1280, 1280, 40")
        case(name, x_, disp_, torch.rand(disp_.num_slots, device=dev), ws_)
    # ep's layout at full width (routing.slice_dispatch): experts 2 and 3 of
    # the training routing's first 1024 tokens, their slots first, every
    # other slot past offsets[E]; inputs from their own generator
    gen = torch.Generator(device=dev).manual_seed(8)
    x_s = x_tr[:1024].contiguous()
    d_full = M.TR.build_dispatch(M.TR.top_k_gating(
        x_s, moe["wg"], k).topk_experts.contiguous(), E)
    loc = M.TR.slice_dispatch(d_full, 2, count=2)
    g_loc = torch.rand(loc.num_slots, generator=gen, device=dev)
    case(f"slots past offsets[E] (experts 2-3 of {E}, "
         f"{int(loc.expert_token_offsets[-1])} of {loc.num_slots} slots)",
         x_s, loc, g_loc, tuple(w_[2:4].contiguous() for w_ in w),
         dy=torch.randn(x_s.shape, generator=gen, device=dev).to(BF16))
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
    k, v = tr["k"], tr["v"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    window = 4096
    # Mixtral's training shape (32/8 heads), then Qwen3-14B's (40/8)
    for q, model in ((tr["q"], "mixtral-8x7b"), (tr["q40"], "qwen3-14b")):
        B, T_, H, Dh = q.shape
        pairs = sum(min(t + 1, window) for t in range(T_))  # live (q, k)
        ops = 4.0 * B * H * Dh * pairs
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * EB
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        rows["flash_attention"].append(entry(
            timer(lambda: KF.flash_attention(q, k, v, causal=True,
                                             window=window)),
            timer(lambda: KF.flash_attention_plain(q, k, v, causal=True,
                                                   window=window,
                                                   chunk=512),
                  warm=1, reps=3),
            nbytes, ops,
            timer(lambda: sdpa(qt, kt, vt, is_causal=True,
                               enable_gqa=True)),
            f"training {model}: B={B}, S={T_}, {H}/{k.shape[2]} heads of "
            f"{Dh}, causal"))
    return rows


def gather_rows_checks(M, dev, rng, timer, entry, randn, errs,
                       dispatch_case, topk_tr) -> list:
    """Phase 10: the ``ep_a2a`` path's send-buffer bookkeeping and the
    row-gather kernel.  The dispatch builds of ``_a2a_pack`` and of the
    local expert bank, bit-equal to the plain build at the shapes the path
    gives them, and the pack's send-buffer order against a plain pack (a
    wrong order within a destination drops the wrong slots at a tight
    capacity).  Then the kernel against its plain version, bit for bit, at
    the send buffers of the path at Mixtral's width (one rank: all 2 x 2048
    tokens' 8192 slots; four ranks: one rank's 1024-token chunk packed by
    destination at capacity 2.0, about half the rows pads), at an odd
    width in bf16 (the element-wise copy) and float32 (the vector copy), a
    misaligned source and N = 0; then their times."""
    KR, MB = M.KR, M.MB
    d, k, E = 4096, 2, 8
    i32 = torch.int32

    def pack_case(name, dest, G, C):
        dispatch_case(name, dest.to(i32).reshape(-1, 1).contiguous(), G + 1)
        src, slot_ok, *_ = MB._a2a_pack(dest, G, C)
        want = torch.full((G * C,), -1, dtype=i32, device=dev)
        for g in range(G):
            rows = (dest == g).nonzero().flatten()[:C]
            want[g * C:g * C + rows.numel()] = rows.to(i32)
        check(torch.equal(src, want) and torch.equal(slot_ok, want >= 0),
              f"a2a pack {name}: send-buffer order differs from the plain "
              "pack")
        log(f"parity a2a pack [{name}]: dispatch over {G + 1} groups "
            f"bit-equal, send buffer as the plain pack, "
            f"{int((want >= 0).sum())} of {dest.numel()} slots sent")
        return src, slot_ok

    def cap(c, slots, n):
        return M.MS._a2a_capacity(SimpleNamespace(moe_a2a_capacity=c),
                                  slots, n)

    # one rank: every slot goes to rank 0; the local bank gets them all
    n_slots = TRAIN_BATCH * TRAIN_SEQ * k
    pack_case(f"n=1: {n_slots} slots, capacity 2.0",
              torch.zeros(n_slots, dtype=i32, device=dev), 1,
              cap(2.0, n_slots, 1))
    dispatch_case("n=1 local bank", topk_tr.reshape(-1, 1).contiguous(),
                  E + 1)
    log(f"parity build_dispatch [n=1 local bank: {n_slots} rows, {E + 1} "
        "groups]: bit-equal")
    # four ranks: one rank's chunk routed top-2 over 8 experts, packed by
    # destination rank at the default capacity and at 0.25
    n, Lc = 4, 1024
    topk = torch.from_numpy(np.stack([rng.permutation(E)[:k]
                                      for _ in range(Lc)]).astype(np.int32))
    dest = (topk.to(dev) // (E // n)).reshape(-1)
    C = cap(2.0, Lc * k, n)
    src_of_slot, slot_ok = pack_case(f"n=4: {Lc * k} slots, capacity 2.0",
                                     dest, n, C)
    pack_case(f"n=4: {Lc * k} slots, capacity 0.25", dest, n,
              cap(0.25, Lc * k, n))
    e_loc = (topk.to(dev) % (E // n)).reshape(-1)
    bank = torch.where(slot_ok, e_loc[src_of_slot.long().clamp(min=0)],
                       E // n)
    dispatch_case("n=4 local bank", bank.to(i32).reshape(-1, 1)
                  .contiguous(), E // n + 1)
    log(f"parity build_dispatch [n=4 local bank: {bank.numel()} rows, "
        f"{E // n + 1} groups, the pads in the trash group]: bit-equal")

    def case(name, src, ids):
        got = KR.gather_rows(src, ids)
        want = KR.gather_rows_plain(src, ids)
        torch.cuda.synchronize()
        check(got.shape == want.shape and torch.equal(got, want),
              f"gather_rows {name}: differs from its plain version")
        check(not bool(got[ids < 0].any()),
              f"gather_rows {name}: a pad row is not zero")
        log(f"parity gather_rows [{name}]: bit-equal, {ids.numel()} rows, "
            f"{int((ids < 0).sum())} zero rows")

    # one rank: slot s of the send buffer holds token s // k
    src1 = randn(TRAIN_BATCH * TRAIN_SEQ, d)
    ids1 = (torch.arange(src1.shape[0] * k, device=dev) // k).to(i32)
    ids4 = torch.where(slot_ok, src_of_slot // k, -1).to(i32)
    src4 = randn(Lc, d)
    shape1 = (f"n=1 training send buffer: L={src1.shape[0]}, N={ids1.numel()}"
              f", d={d}, bf16")
    shape4 = f"n=4 rank send buffer: Lc={Lc}, C={C}, N={ids4.numel()}, d={d}"
    case(shape1, src1, ids1)
    case(shape4, src4, ids4)
    odd_ids = rng.integers(0, 300, size=513).astype(np.int32)
    odd_ids[::7] = -1                          # pad rows in every case
    odd_ids = torch.from_numpy(odd_ids).to(dev)
    case("d=4100 bf16, 8200-byte rows: element copy", randn(300, 4100),
         odd_ids)
    case("d=4100 float32, 16400-byte rows: vector copy",
         randn(300, 4100, dtype=torch.float32), odd_ids)
    shifted = randn(300 * d + 1)[1:].view(300, d)
    case("d=4096 bf16, source 2 bytes off 16-byte alignment: element copy",
         shifted, odd_ids)
    before = KR.gather_rows.launches
    empty = KR.gather_rows(src4, ids4[:0])
    check(empty.shape == (0, d) and KR.gather_rows.launches == before,
          "gather_rows N=0: wrong shape or a launch")
    log("parity gather_rows [N=0]: empty output, no launch")
    errs["gather_rows"] = 0.0

    def row(src, ids, shape):
        valid = ids[ids >= 0]
        n_src = int(valid.unique().numel())
        N = ids.numel()
        nbytes = n_src * d * EB + N * 4 + N * d * EB
        lib_ids = ids.clamp_min(0)
        return entry(timer(lambda: KR.gather_rows(src, ids)),
                     timer(lambda: KR.gather_rows_plain(src, ids)),
                     nbytes, 0, timer(lambda: torch.index_select(
                         src, 0, lib_ids)), shape)

    rows = [row(src1, ids1, shape1), row(src4, ids4, shape4)]
    for r in rows:
        log(f"time gather_rows [{r['shape']}]: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}: each referenced source row read once, ids, "
            f"the buffer written once), library {r['library_ms']:.4f} ms "
            "(index_select on clamped ids, which leaves the pad rows "
            "unzeroed)")
    return rows


def one_rank_mesh(M, dev):
    """Phase 11's process group: this process as a world of one rank over
    NCCL, laid out as a (data=1, model=1) mesh."""
    dist = torch.distributed
    M.MESH.init_distributed(dev)
    mesh = M.MESH.make_debug_mesh(1, 1)
    log(f"mesh: {mesh.shape}, world size {dist.get_world_size()}, backend "
        f"{dist.get_backend()}, transport "
        f"{M.CL.transport(mesh.group(mesh.axis_names), dev)}")
    return mesh


def _scaled_close(name, got, want, rtol, frac) -> float:
    """|got - want| <= rtol |want| + frac max|want|; returns the largest
    |err| over max|want|."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    err = (got - want).abs()
    bad = int((err > rtol * want.abs() + frac * scale).sum())
    check(bad == 0 and bool(torch.isfinite(got).all()),
          f"{name}: {bad} elements outside tolerance (max |err| / scale "
          f"{float(err.max()) / max(scale, 1e-30):.4g})")
    return float(err.max()) / max(scale, 1e-30)


def _layer_grads(MB, x, p, cfg, mesh=None):
    """y and the gradients of mean(y**2) with respect to x and the four
    MoE weights; the layer's overflow share."""
    names = ("wg", "w1", "w2", "w3")
    xr = x.detach().requires_grad_(True)
    leaves = [p[n].detach().requires_grad_(True) for n in names]
    pl = dict(zip(names, leaves))
    if mesh is None:
        y, _ = MB.moe_sublayer(xr, pl, cfg)
        over = 0.0
    else:
        y, _, st = MB.moe_sublayer(xr, pl, cfg, mesh=mesh, dp_axes=(),
                                   with_stats=True)
        over = float(st["a2a_overflow"])
    grads = torch.autograd.grad(y.float().square().mean(), [xr] + leaves)
    return dict(zip(("y", "dx") + tuple("d" + n for n in names),
                    (y.detach(),) + grads)), over


def layer_mesh_parity(M, dev, mesh) -> dict:
    """Phase 11: Mixtral-8x7B's MoE sublayer at full width (2 x 2048
    tokens, bf16, ``blaze`` on ``pallas``) under ``ep``, ``ep_a2a`` (one
    and two chunks) and ``tp`` on the one-rank mesh, against the layer
    without a mesh on the same weights and input: the output and the
    gradients of mean(y**2): bit-equal under ``ep`` and ``tp`` (one rank
    slices nothing off and runs the same kernels on the same rows), within
    LAYER_MESH_TOL of their scale under ``ep_a2a`` (its sum over k rounds
    each slot to bf16 first); the overflow must be exactly 0 (at one rank
    C = L k)."""
    from repro_torch.configs import get_config
    MB, SH, K = M.MB, M.SH, M.K
    cfg = get_config("mixtral-8x7b").replace(dtype="bfloat16",
                                             gmm_backend="pallas")
    E, d, h = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape, fan_in=1):
        return (torch.randn(shape, generator=gen, device=dev)
                .div_(fan_in ** 0.5).to(BF16))

    p = {"wg": rnd(d, E, fan_in=d), "w1": rnd(E, d, h, fan_in=d),
         "w2": rnd(E, d, h, fan_in=d), "w3": rnd(E, h, d, fan_in=h)}
    x = rnd(TRAIN_BATCH, TRAIN_SEQ, d)
    want, _ = _layer_grads(MB, x, p, cfg)
    out = {}
    for label, mode, chunks in (("ep", "ep", 1), ("ep_a2a", "ep_a2a", 1),
                                ("ep_a2a chunks 2", "ep_a2a", 2),
                                ("tp", "tp", 1)):
        c = cfg.replace(moe_parallel=mode, moe_a2a_chunks=chunks)
        local = SH.local_params({"moe": p}, mesh, mode)["moe"]
        K.reset_launches()
        got, over = _layer_grads(MB, x, local, c, mesh)
        torch.cuda.synchronize()
        n_gather = K.launch_counts()["gather_rows"]
        errs = {n: _scaled_close(f"layer [{label}] {n}", got[n], want[n],
                                 *LAYER_MESH_TOL) for n in want}
        exact = mode in ("ep", "tp")
        if exact:
            for n in want:
                check(torch.equal(got[n], want[n]),
                      f"layer [{label}] {n}: not bit-equal at one rank")
        check(over == 0.0, f"layer [{label}]: overflow {over} at one rank")
        check(n_gather == (1 if mode == "ep_a2a" else 0),
              f"layer [{label}]: {n_gather} gather_rows launches")
        log(f"parity layer [{label}, one-rank NCCL mesh, full width]: max "
            f"|err| / scale {json.dumps(errs)} ("
            + ("bit-equal required" if exact else
               f"tol {LAYER_MESH_TOL[0]} |want| + {LAYER_MESH_TOL[1]} scale")
            + f"); overflow {over}; "
            f"gather_rows launches {n_gather}")
        out[label] = {"err_over_scale": errs, "overflow": over}
        del got
    return out


def _a2a_tight_want(M, x, p, cfg, n: int):
    """The ``ep_a2a`` layer's output on ``n`` ranks at a tight capacity,
    run in this process: each rank's chunk routed as the rank routes it,
    the slots past each destination's capacity (in ascending slot order,
    as the reference packs them) given gate 0 in the single-device layer.
    Returns (y, the share of slots dropped)."""
    TR, MB = M.TR, M.MB
    E, k = cfg.num_experts, cfg.top_k
    xf = x.reshape(-1, x.shape[-1])
    Lc = xf.shape[0] // n
    C = M.MS._a2a_capacity(cfg, Lc * k, n)
    rb = MB.GB.resolve(None, config=cfg.gmm_backend)
    ys, dropped = [], 0
    with torch.no_grad():
        for r in range(n):
            xc = xf[r * Lc:(r + 1) * Lc]
            g = TR.top_k_gating(xc, p["wg"].to(xc.dtype), k)
            dest = (g.topk_experts // (E // n)).reshape(-1)
            keep = torch.zeros_like(dest, dtype=torch.bool)
            for j in range(n):
                keep[(dest == j).nonzero().flatten()[:C]] = True
            dropped += int((~keep).sum())
            gates = torch.where(keep, g.topk_weights.reshape(-1), 0.0)
            disp = TR.build_dispatch(g.topk_experts.contiguous(), E)
            ys.append(MB._expert_ffn(xc, gates.reshape(Lc, k).to(xc.dtype),
                                     disp, p, cfg, rb))
    return torch.cat(ys).reshape(x.shape), dropped / float(n * Lc * k)


def multi_rank_phase(M, dev) -> dict:
    """Phase 13: several ranks share the one card over gloo, staged through
    host memory, at a reduced width (MR_WIDTHS; 1024 tokens per rank,
    bf16, ``blaze`` on ``pallas``): 2 ranks (data=1, model=2) run ``ep``,
    ``ep_a2a`` (one and two chunks), ``tp`` and ``ep_a2a`` at capacity
    0.25; 4 ranks (data=1, node=2, model=2) run ``ep_a2a_hier``; 4 ranks
    (data=2, model=2) run one ``ep_a2a`` training step.  Every rank holds
    its output rows and gradients against this process's layer without a
    mesh (LAYER_MESH_TOL), the output at capacity 0.25 against this
    process's layer with the slots a plain pack drops given gate 0
    (LAYER_MESH_TOL; the same overflow share, which must be positive), the
    training step's loss and grad norm against this process's step without
    a mesh (MR_STEP_RTOL); the overflow must be 0 at capacity 8.0, and
    every rank must launch the row-gather kernel.  A rank that fails fails
    the phase."""
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.interop import init_params
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import init_adamw
    MB = M.MB
    d, h = MR_WIDTHS
    cfg = get_config("mixtral-8x7b").replace(
        d_model=d, moe_d_ff=h, num_heads=8, num_kv_heads=2, head_dim=128,
        num_layers=2, dtype="bfloat16", gmm_backend="pallas",
        moe_a2a_capacity=8.0, use_pallas=True)
    E = cfg.num_experts
    gen = torch.Generator(device=dev).manual_seed(6)

    def rnd(*shape, fan_in=1):
        return (torch.randn(shape, generator=gen, device=dev)
                .div_(fan_in ** 0.5).to(BF16))

    p = {"wg": rnd(d, E, fan_in=d), "w1": rnd(E, d, h, fan_in=d),
         "w2": rnd(E, d, h, fan_in=d), "w3": rnd(E, h, d, fan_in=h)}
    tcfg = TrainConfig(learning_rate=1e-4, warmup_steps=2, total_steps=100,
                       batch_size=4, seq_len=MR_TOKENS, seed=0)
    batch = next(make_batch_iterator(cfg.vocab_size, tcfg.seq_len,
                                     tcfg.batch_size, tcfg.seed))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev, dtype=torch.float32)
    _, _, m = make_train_step(cfg, tcfg, dev)(params, init_adamw(params),
                                              batch)
    step_ref = {k_: float(m[k_]) for k_ in ("loss", "grad_norm")}
    del params
    jobs = [
        ("2 ranks (data=1, model=2)", (1, 2), ("data", "model"),
         [("ep", "ep", {}), ("ep_a2a", "ep_a2a", {}),
          ("ep_a2a chunks 2", "ep_a2a", {"moe_a2a_chunks": 2}),
          ("tp", "tp", {}),
          ("ep_a2a capacity 0.25", "ep_a2a", {"moe_a2a_capacity": 0.25})],
         False),
        ("4 ranks (data=1, node=2, model=2)", (1, 2, 2),
         ("data", "node", "model"), [("ep_a2a_hier", "ep_a2a_hier", {})],
         False),
        ("4 ranks (data=2, model=2)", (2, 2), ("data", "model"), [], True)]
    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        work = Path(tmp)
        for label, sizes, names, cases, train in jobs:
            n_tok = int(np.prod(sizes)) * MR_TOKENS
            x = rnd(1, n_tok, d) if cases else None
            job = {"sizes": sizes, "names": names, "cfg": cfg, "cases": cases,
                   "train": train, "tcfg": tcfg, "batch": batch,
                   "device": dev.type}
            if cases:
                want, _ = _layer_grads(MB, x, p, cfg)
                tight = {}
                for label_, mode_, over_ in cases:
                    if "moe_a2a_capacity" in over_:
                        y_, share = _a2a_tight_want(
                            M, x, p, cfg.replace(moe_parallel=mode_, **over_),
                            sizes[-1])
                        check(share > 0.0, f"{label} {label_}: the plain "
                              "pack drops no slot")
                        tight[label_] = {"y": y_.cpu(), "overflow": share}
                job.update(x=x.cpu(), p={k_: v.cpu() for k_, v in p.items()},
                           want={k_: v.cpu() for k_, v in want.items()},
                           tight=tight)
            torch.save(job, work / "job.pt")
            t0 = time.perf_counter()
            world = int(np.prod(sizes))
            mp.start_processes(_rank_main, args=(world, str(work)),
                               nprocs=world, join=True, start_method="spawn")
            ranks = [torch.load(work / f"rank{r}.pt") for r in range(world)]
            for f in work.glob("*.pt"):
                f.unlink()
            (work / "store").unlink(missing_ok=True)
            for r, res in enumerate(ranks):
                check(res["gather_rows_launches"] > 0,
                      f"{label} rank {r}: gather_rows was not launched")
                for name, rec in res["cases"].items():
                    over = rec["overflow"]
                    want_over = job["tight"][name]["overflow"] \
                        if name in job.get("tight", {}) else 0.0
                    check(abs(over - want_over) <= 1e-6 * max(want_over, 1.0),
                          f"{label} {name} rank {r}: overflow {over}, want "
                          f"{want_over}")
                if train:
                    for k_, v in step_ref.items():
                        got = res["train"][k_]
                        check(abs(got - v) <= MR_STEP_RTOL * abs(v),
                              f"{label} rank {r}: {k_} {got} vs {v}")
            rec = {"transport": ranks[0]["transport"],
                   "seconds": time.perf_counter() - t0,
                   "cases": ranks[0]["cases"],
                   "gather_rows_launches": [r_["gather_rows_launches"]
                                            for r_ in ranks]}
            if train:
                rec["train"] = [r_["train"] for r_ in ranks]
                rec["train_ref"] = step_ref
            log(f"multi-rank [{label}] on one card, transport "
                f"{rec['transport']}: {json.dumps(rec)}")
            out[label] = rec
    return out


def _rank_main(rank: int, world: int, workdir: str) -> None:
    """One rank of phase 13, spawned: the job in ``workdir/job.pt``, its
    results to ``workdir/rank<r>.pt``."""
    import os
    from datetime import timedelta
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    from repro_torch import kernels as K
    from repro_torch import sharding as SH
    from repro_torch.core.collectives import transport
    from repro_torch.interop import init_params
    from repro_torch.launch.mesh import Mesh, init_distributed
    from repro_torch.models import moe_block as MB
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import init_adamw
    work = Path(workdir)
    job = torch.load(work / "job.pt", weights_only=False)
    dev = init_distributed(job["device"], backend="gloo",
                           init_method=f"file://{work / 'store'}",
                           timeout=timedelta(seconds=300))
    mesh = Mesh(job["sizes"], job["names"])
    K.reset_launches()
    out = {"transport": transport(mesh.group(mesh.axis_names), dev),
           "cases": {}}
    if job["cases"]:
        x = job["x"].to(dev)
        p = {k_: v.to(dev) for k_, v in job["p"].items()}
        want = job["want"]
        for label, mode, over in job["cases"]:
            cfg = job["cfg"].replace(moe_parallel=mode, **over)
            local = SH.local_params({"moe": p}, mesh, mode)["moe"]
            got, overflow = _layer_grads(MB, x, local, cfg, mesh)
            rec = {"overflow": overflow}
            if label in job["tight"]:
                want_y = job["tight"][label]["y"].to(dev)
                rec["want_overflow"] = job["tight"][label]["overflow"]
                rec["err_over_scale"] = {"y": _scaled_close(
                    f"rank {rank} [{label}] y", got["y"], want_y,
                    *LAYER_MESH_TOL)}
            else:
                grads = {k_[1:]: v for k_, v in got.items()
                         if k_ not in ("y", "dx")}
                whole = SH.gather_params({"moe": grads}, mesh, mode)["moe"]
                got.update({"d" + k_: v for k_, v in whole.items()})
                rec["err_over_scale"] = {
                    k_: _scaled_close(f"rank {rank} [{label}] {k_}", v,
                                      want[k_].to(dev), *LAYER_MESH_TOL)
                    for k_, v in got.items()}
            out["cases"][label] = rec
    if job["train"]:
        cfg = job["cfg"].replace(moe_parallel="ep_a2a")
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(cfg, gen, dev, dtype=torch.float32)
        step = make_train_step(cfg, job["tcfg"], dev, mesh=mesh)
        local = SH.local_params(params, mesh, step.moe_parallel)
        del params
        _, _, m = step(local, init_adamw(local), job["batch"])
        out["train"] = {k_: float(v) for k_, v in m.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["gather_rows_launches"] = K.launch_counts()["gather_rows"]
    torch.save(out, work / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def training_phase(cfg, dev, K, required, tag, mesh=None, per_step=None):
    """Phases 7, 8, 12 and 18: a training step at full width through
    ``make_train_step`` (on ``mesh``'s ranks when given); every kernel in
    ``required`` must be launched during the warm steps, and each kernel
    in ``per_step`` exactly that many times a step.  Returns the
    measurements."""
    from repro_torch import sharding as SH
    from repro_torch.configs import TrainConfig
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.interop import init_params
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import init_adamw
    tcfg = TrainConfig(learning_rate=1e-4, warmup_steps=2, total_steps=100,
                       batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev, dtype=torch.float32)
    step_fn = make_train_step(cfg, tcfg, dev, mesh=mesh)
    if mesh is not None:
        params = SH.local_params(params, mesh, step_fn.moe_parallel)
    opt = init_adamw(params)
    n_params = sum(t.numel() for t in _leaves(params))
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
            f"{m['lr']:.3g} moe_overflow {m['moe_overflow']} step "
            f"{m['step_s']:.4f} s")
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
    for name, n in (per_step or {}).items():
        check(launches[name] == n * steps_warm,
              f"kernel {name}: {launches[name]} launches over {steps_warm} "
              f"[{tag}] steps, expected {n} a step")
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
            "gmm_backend": step_fn.resolved_backend.name,
            "moe_parallel": step_fn.moe_parallel,
            "moe_overflow": [m_["moe_overflow"] for m_ in history]}


def cpu_train_crosscheck(dev, arch="mixtral-8x7b", far_floor=0,
                         **overrides):
    """Phases 9 and 19: one training step of the reduced ``arch``
    (float32) with ``overrides`` from the same weights and batch on the
    card and on the CPU.  The loss's gradients must agree leaf by leaf
    (``STEP_RTOL`` relative over ``STEP_RTOL`` of each leaf's scale, as
    ``tests/test_torch_train.py`` holds them to the reference); then the
    step's metrics and parameters as set out at ``STEP_FAR_SHARE``, with at
    least ``far_floor`` elements of each leaf allowed beyond 2e-3 lr."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.interop import init_params
    from repro_torch.models import transformer as T
    from repro_torch.train.loop import batch_to_device, make_train_step
    from repro_torch.train.optimizer import init_adamw, tree_leaves
    cfg = get_config(arch).reduced().replace(use_pallas=True, **overrides)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10,
                       batch_size=2, seq_len=128)
    gen = torch.Generator(device=dev).manual_seed(0)
    p_card = init_params(cfg, gen, dev, dtype=torch.float32)
    p_cpu = _to_device(p_card, torch.device("cpu"))
    batch = next(make_batch_iterator(cfg.vocab_size, tcfg.seq_len,
                                     tcfg.batch_size, 0))
    grads = {}
    for name, p, device in (("card", p_card, dev),
                            ("cpu", p_cpu, torch.device("cpu"))):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
        it = iter(leaves)
        loss, _ = T.train_loss(_map_leaves(p, lambda _: next(it)),
                               batch_to_device(batch, device), cfg)
        grads[name] = [g.detach().cpu() for g in
                       torch.autograd.grad(loss, leaves)]
    grad_rel = 0.0
    for g_card, g_cpu in zip(grads["card"], grads["cpu"]):
        scale = float(g_cpu.abs().max())
        grad_rel = max(grad_rel, float((g_card - g_cpu).abs().max())
                       / max(scale, 1e-30))
        check(bool(((g_card - g_cpu).abs()
                    <= STEP_RTOL * (g_cpu.abs() + scale)).all()),
              "train cross-check: a gradient leaf differs")
    del grads
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
        check(far <= max(far_floor, STEP_FAR_SHARE * err.numel()),
              f"train cross-check: {far} of {err.numel()} elements of a "
              "leaf moved apart by more than 2e-3 lr")
        n_far += far
        n_all += err.numel()
    log(f"train cross-check {arch} {overrides} (reduced, float32, one "
        f"step): gradients max |diff| / leaf scale {grad_rel:.3g} (tol "
        f"{STEP_RTOL}); card "
        f"{out['card']} vs cpu {out['cpu']}; parameters max |diff| "
        f"{worst:.3g} (lr {lr}), {n_far} of {n_all} beyond 2e-3 lr")
    for key in ("loss", "ce", "grad_norm"):
        check(abs(out["card"][key] - out["cpu"][key])
              <= STEP_RTOL * abs(out["cpu"][key]),
              f"train cross-check: {key} differs")
    check(worst <= lr, "train cross-check: a parameter moved apart by more "
          "than lr")
    return {"card": out["card"], "cpu": out["cpu"], "param_max_diff": worst,
            "param_far": n_far, "grad_max_rel_diff": grad_rel}


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


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn) for v in tree]
    return fn(tree)


def _to_device(tree, device):
    return _map_leaves(tree, lambda t: t.detach().to(device, copy=True))


if __name__ == "__main__":
    sys.exit(main())
