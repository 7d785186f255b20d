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
   the dispatch build at every shape of ``DISPATCH_SHAPES`` (decode to the
   paper's Table-1 sizes and both sides of its one-launch limit; each
   build called twice and held bit-equal both times),
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
   forward's y and every output of the backward bit-equal across calls
   (one writer per element), and
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
   w3 forward, the backward's w3ᵀ and w1ᵀ; the dispatch build at every
   shape of ``DISPATCH_SHAPES``), beside its plain version, its bound (the
   largest of bytes / 3.35 TB/s, operations / 989 TFLOP/s, both from this
   run's inputs, and the launch floor: empty kernels launched as a call
   of the kernel launches its kernels, one, several back to back or a
   programmatic-dependent pair, timed as the kernels are; no kernel may
   read under its bound) and PyTorch
   calls that compute the same function, where there are
   (``torch._grouped_mm`` over pre-gathered rows,
   ``scaled_dot_product_attention``; for the fused pair the sum of its
   products as grouped_mm calls, for the dispatch build the sort-based
   build, compositions), timed only; flash attention at both models'
   training shapes (32/8 and 40/8 heads);
5. end to end — Mixtral-8x7B at full width with the depth cut to 2 layers
   (random bf16 weights from seed 0; 32 layers would not fit one 80 GB
   card), served by the port's engine: 4 slots, capacity 1024, 16-token
   pages, 5 greedy requests (prompts of 37, 129, 300, 511 and 64 tokens, 16
   new tokens each; the 5th refills a slot), three times: cold, then warm
   (measured: every kernel's launch count must rise during this run), then
   traced with torch.profiler, device activity only (device time by
   kernel, device busy share);
   all three must give the same tokens;
6. CPU cross-check — one 24-token prompt through the same weights copied
   to the CPU (plain versions there); prefill logits must agree with the
   card's within the bf16 tolerance below, with the same first token;
7. training — with the serving weights freed, Mixtral-8x7B at full width,
   2 layers, float32 master weights from seed 0, bf16 compute,
   ``blaze_pallas`` with ``use_pallas=True``, batches of 2 x 2048 tokens
   from the port's pipeline (seed 0), through ``make_train_step`` under
   the config's checkpoint plan, ``"none"`` (each layer's forward rerun in
   the backward, as the reference's default remat): one cold step, 5 warm
   steps (measured: each training kernel launched exactly as often a step
   as the plan says, its forward kernels twice), one step traced with
   torch.profiler, then one batch fed 3 times, whose loss must fall; every
   loss and grad norm must be finite;
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
   ``gather_rows`` exactly twice per MoE layer a step (the forward and the
   backward's recompute), overflow 0;
13. several ranks on the one card — spawned ranks share the H100 (gloo
   for the handles, CUDA IPC for the tensors) at a reduced width (d=1024,
   expert width 3584, 1024 tokens per rank): 2 ranks run ``ep``,
   ``ep_a2a`` (one and two chunks), ``tp`` and ``ep_a2a`` at capacity
   0.25; 4 ranks run ``ep_a2a_hier``; 4 ranks (data=2, model=2) run one
   ``ep_a2a`` training step; each rank is held against this process's
   result without a mesh, the tight ``ep_a2a`` against this process's
   layer with the slots a plain pack drops given gate 0;
14. Qwen3-14B parity — with Mixtral's state freed, the dense model's
   kernels against their plain versions on the card in bf16 at its widths
   (d=5120, FFN width 17408, 40/8 heads of 128): the fused-SwiGLU forward,
   bwd_x and bwd_w at the training (L=4096) and decode (L=4 and L=1: the
   forward's split plan) shapes, at L=64, 65 and 129 (a consumer
   warpgroup without rows, with one row, a second row tile of one row), at
   d=0, at a ragged L=300, with h or d not a multiple of the tile, with
   widths not a multiple of 8 and in float32, each forward repeated
   bit-equal; the ``swiglu`` autograd Function against
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
19. Qwen3-14B CPU training cross-check — phase 9 on the reduced Qwen3-14B;
20. the plan sweep — Mixtral-8x7B at full width, 2 layers, 2 x 2048
   tokens, phase 7's parameters and batch, under every registry plan
   (``none``, ``paper_min``, ``paper``, ``dots``, ``full``) on
   ``blaze_pallas`` and the two moe-scoped specs of ``fit_candidates``
   (residual modes ``ab`` and ``x``) on ``blaze`` over ``pallas`` beside
   that layer's ``full``: the first step's loss (equal within each layer)
   and gradients (bit-equal to the layer's ``full`` but the embedding's,
   summed by atomics), the bytes held between forward and backward
   (ordered none < paper_min < paper < full and x < ab < ab_yswi), the
   median of 3 warm steps, the measured peak beside ``peak_sim_bytes``,
   ``estimate_saved_bytes`` beside the measured growth over ``none``, each
   kernel's launches a step; then ``make_train_step(hbm_budget=...)`` at
   8 x 2048 tokens (where the candidates' simulated peaks differ) with a
   budget between two of them must choose the plan the simulator's table
   says; the dense model (Qwen3-14B, 4 layers, the plain FFN path whose
   products carry the FFN tags): held bytes strictly ordered none <
   paper_min < paper < full;
21. the paper's comparison — the MoE layer alone at each of the paper's
   Table-1 confs (``paper_conf1``..``7``: exact d, E, k, B·S; h = 4d), in
   bf16: ``blaze`` in each residual mode and ``megablocks`` on the same
   ``pallas`` grouped GEMM, ``megablocks`` on ``ragged`` as the library
   column; saved-residual bytes (``compat.saved_residual_nbytes``), peak
   above the inputs, forward+backward time, the megablocks / blaze ratios
   beside the paper's claims (printed, not gated); blaze saves fewer
   bytes than megablocks and x < ab < ab_yswi at every conf, and blaze's
   y and dx agree with megablocks' at ``paper_conf1``;
22. Qwen3-30B-A3B parity — the kernels of its paths at its shapes (128
   experts, top-8, d=2048, expert width 768; 32/4 heads of 128, a GQA
   group of 8), bf16, against their plain versions: the dispatch build
   at the training (2 x 2048 tokens, 32,768 slots: past the one-launch
   limit) and decode (4 tokens, 32 slots, most experts empty) routing,
   gather-GMM's instantiations there (the dual branch with ``save_ab``,
   the w3 forward, the transposed w3 and w1), the grouped weight gradient
   (dw1, dw3), the fused pair (two forward h-ranges at training), the
   combine at k = 8, flash attention at 32/4 heads, paged attention over
   bf16 and int8 pages (decode, position 0 and a dead table, the split
   boundaries); every call whose outputs have one writer each repeated
   bit-equal;
23. Qwen3-30B-A3B timing — those kernels at those shapes, as phase 4;
24. Qwen3-30B-A3B serving at full width and full depth (48 layers, random
   bf16 weights from seed 0, ``use_pallas=True``, the kernel composition
   ``blaze_pallas``), as phase 16: bf16 pages cold, warm (the dispatch
   build, gather-GMM, the combine, flash and paged attention must be
   launched) and traced with identical tokens, then int8 pages (first
   tokens equal; KV bytes per cached token 98,304 / 49,920);
25. Qwen3-30B-A3B CPU cross-check — phase 6 on a 2-layer cut;
26. Qwen3-30B-A3B training — full width, depth cut from 48 to 4 layers, as
   phase 7 on ``blaze_pallas`` and as phase 8 on ``blaze`` over
   ``pallas_fused`` (each kernel's launches a step exact under
   ``"none"``), then phase 9's CPU cross-check on the reduced config;
27. gradient accumulation — Mixtral-8x7B, 2 layers, 2 x 2048 tokens: the
   step with two microbatches against the step with one, same weights and
   batch (loss and ce within ``MB_LOSS_RTOL``, grad norm within
   ``MB_NORM_RTOL``; the expert kernels launched twice as often);
28. 8 x 2048 tokens with four microbatches (the live set one 2 x 2048
   microbatch; at one microbatch this batch ran out of the card): a cold
   and a warm step, the state held between steps, the peak and the
   simulated peak;
29. a training checkpoint on the card — a reduced width of Qwen3-30B-A3B
   trained 2 steps, saved, restored (masters and AdamW state bit-equal)
   and restored into the serving layout, whose engine's greedy tokens
   must equal those of an engine over the in-memory masters cast alike;
30. temperature sampling (run after phase 6, on phase 5's weights and
   prompts) — ``greedy=False``, T = 0.8, seed 11: the same tokens cold
   and warm, on 4 slots and on 1, and in reversed submission order with
   the same request ids; seed 12 gives other tokens; the sampler's noise
   bit-equal on the CPU and the card; decode tokens/s sampled and greedy,
   the sampler's device time a step;
31. prefix sharing with copy-on-write pages, over bf16 and over int8
   pages — a 512-token prompt, the same plus 37 tokens, the first again
   (covered exactly: a re-fed token and a fork), then one request on a
   256-token prefix and three more with distinct suffixes in one batch:
   the stats of the reference's admission, the shared pages bit-unchanged
   by the fork, first-token logits within the CPU tolerance of an engine
   without sharing and its greedy tokens (or a first divergence at a
   top-2 gap within it), the paged kernel on every decode step; the
   prefill seconds with and without sharing and the suffix prefill's
   plain attention;
32. per-request backends and the paged-attention registry — one
   ``generate`` with requests on ``pallas``, ``ragged`` and the engine's
   own ``segment`` (``moe_impl="blaze"``): each group's tokens equal its
   own engine's, ``gather_gmm`` launched in the ``pallas`` group only; a
   ``paged_kernel="dense"`` engine launches no ``paged_attention`` and its
   logits lie within the CPU tolerance of the kernel engine's; the
   default engine resolves to the kernel from ``auto``;
33. the async runtime — on Mixtral (after phase 32) and on Qwen3-14B at
   full depth (after phase 17, phase 16's weights): tokens equal the
   synchronous engine's, greedy and sampled; each request's stream in
   order with one terminal event; the emission queue drained; sync and
   async wall times over 3 interleaved rounds;
34. Hymba-1.5B training — full width, all 32 layers (attention and Mamba
   heads in parallel, window 1024), 2 x 2048 tokens, ``use_pallas=True``,
   the default plan, as phase 7 with 3 warm steps: flash attention at
   head width 64 (25/5 heads) and the three fused-SwiGLU kernels at
   d = 1600, h = 5504 launched exactly as the plan says a step; then
   phase 9's CPU cross-check on the reduced (2-layer) Hymba;
35. Hymba-1.5B decode — all 32 layers, through ``init_cache`` /
   ``decode_step``: 4 requests teacher-forced through a 64-token prompt,
   every step's logits held against ``forward``'s on the card in float32
   (``DECODE_F32_ATOL``), then with random bf16 weights measured against
   the forward and not held (at full depth the random-init model
   amplifies bf16 rounding to the size of the logits), then 32 greedy
   tokens timed (tok/s) and again under torch.profiler (the same tokens;
   device busy share); a 2-layer cut decodes 1280 positions, past the
   1024-token window (the rolling cache wraps), held against the forward
   in float32 and in bf16 (``CPU_LOGIT_ATOL`` plus twice the bf16
   forward's distance from the float32 forward, which must stay within
   ``DECODE_TOL_CAP`` of the largest logit);
36. xLSTM-1.3B — phase 35's bf16 run at all 48 layers (7.3 GB bf16,
   measured, not held), an 8-layer float32 cut held against the forward,
   then training one group (7 mLSTM + 1 sLSTM layers) at full width, 2 x
   2048 tokens, 3 warm steps, and phase 9's CPU cross-check on the
   reduced width at the same 8 layers, its bounds widened to twice the
   CPU float32 step's own distance from its float64 step (random-init
   mLSTM layers amplify rounding); no kernel runs on this path (no
   attention, d_ff = 0, plain scans) and none may be launched;
37. Gemma2-27B served at full width and full depth (46 layers, 56.8 GB
   bf16): three requests on 2 slots of capacity 4608, one prompt of 4200
   tokens (past the 4096-token local window, so the window cuts in its
   prefill and every decode step), 32 greedy tokens each, as phase 16
   (flash attention with the window and softcap 50 at a GQA group of 2,
   the paged kernel with both, the fused SwiGLU forward at d = 4608,
   h = 36864); then phase 6's CPU cross-check on a 2-layer cut (one local
   and one global layer);
38. Yi-6B (32 layers) and DeepSeek-Coder-33B (4 of 62 layers: 62 would
   take 66.7 GB) served as phase 5, untraced, each with phase 6's CPU
   cross-check on a 2-layer cut;
39. the kernels at the new paths' shapes, against their plain versions
   and timed as phase 4: flash attention at Hymba's heads (window 1024,
   B = 2, S = 2048) and at Gemma2's (window 4096, softcap 50, S = 8192),
   the fused-SwiGLU trio at d = 1600, h = 5504 and d = 4608, h = 36864
   (L = 4096 and 4), paged attention with Gemma2's window and softcap;
40. the fused MoE pair's general path (float32, and bf16 with d = 1020,
   off the multiple of 8): 1024 tokens, top-2 of 8 experts, h = 2048;
   every output of both directions bit-equal over three calls (one
   writer per element) and held against its plain version, then timed;
41. the kernels at the frame and mixed paths' shapes, held and timed as
   phase 4: flash attention without the causal mask at HuBERT-XLarge's
   training shape (B = 2, S = 2048, 16/16 heads of 80: the tensor cores,
   padded to 128, in bf16; the general kernel in float32, beside SDPA in
   float32) and at 32/8 heads of 128 (the wgmma kernel's non-causal
   branch), causal at LLaVA-NeXT's prefill (B = 1, S = 6144, 32/8 heads
   of 128), each with the kernel that ran and its time over SDPA's; the
   fused-SwiGLU trio at d = 4096, h = 14336 over 6144 rows;
42. HuBERT-XLarge training at all 48 layers (frames from
   ``synthesize_batch``, 2 x 2048, about 82 s of 20 ms frames), as phase
   7: 96 flash launches a step (48 in the forward, 48 in the recompute),
   none on the general kernel, frames/s, peak, busy share and the flash
   kernels' share of the device time; then a CPU cross-check of the forward
   on a 2-layer cut (64 frames; every position's logits within the bf16
   tolerance of phase 6);
43. LLaVA-NeXT-Mistral-7B at full width and depth (32 layers, 14.5 GB
   bf16): ``forward`` with ``last_only`` over 1 x 6144 positions (all 2880
   anyres image slots and 3264 text tokens), cold, warm (tokens/s, peak;
   flash and the fused SwiGLU forward once a layer) and traced (busy
   share); then the CPU cross-check on a 2-layer cut (24 image slots, 24
   tokens);
44. LLaVA-NeXT decode through ``init_cache`` / ``decode_step`` at 32
   layers, as phase 35: B = 4 teacher-forced through a 64-token prompt
   (bf16, measured), 16 greedy tokens timed and traced; a 2-layer float32
   cut held against the forward;
45. LLaVA-NeXT training with the depth cut to 4 layers, 2 x 4096
   positions (2048 image slots each), ``use_pallas=True``, as phase 7;
46. ``moe_parallel="auto"`` at the H100's constants: the cost model's
   table (``roofline.select_moe_parallel``) for Mixtral-8x7B and
   Qwen3-30B-A3B on (data, model) = (1, 2) and (2, 2) and (data, node,
   model) = (1, 2, 2), at the training slab (2048 tokens a rank) and the
   decode slab (B = 4); every chosen mode feasible;
47. FSDP training in ranks sharing the card (gloo for the handles, CUDA
   IPC for the tensors; not NCCL): Mixtral-8x7B at full width, 2 layers, global
   batch 2 x 2048, ``blaze_pallas``, plan ``"none"``, three steps, on (a)
   2 ranks (data=2, model=1) and (b) 4 ranks (data=2, model=2) under
   ``auto`` (which must run phase 46's choice); each rank holds only its
   blocks of the parameters and AdamW moments (allocated bytes within 5%
   of its blocks under ``param_specs``), its step-1 loss and grad norm
   against this process's step without a mesh, the copies of a block on
   two ranks bit-equal after step 3, each rank's peak and step seconds;
48. a checkpoint under (a)'s mesh after step 2: saved from the ranks'
   blocks, restored without a mesh and held to the ranks' blocks exactly,
   restored under the mesh and one step taken, equal to the uninterrupted
   step 3 (loss, grad norm, every leaf's bits);
49. ``ServeEngine(mesh=...)``: Mixtral-8x7B at full width, 2 layers, 2
   ranks (data=1, model=2), ``ep`` and ``ep_a2a`` (served as ``ep``), 8
   greedy requests over bf16 pages, each rank's tokens held to this
   process's engine without a mesh (C7's rule), each rank launching paged
   attention, the dispatch build, gather-GMM and combine; tokens/s a rank;
50. the dry run (``launch/dryrun.py``: the step traced on fake CUDA
   tensors through the kernel wrappers, which launch nothing, and
   shape-only collectives): phase 7's step (peak within 10% of its
   measured peak, launches per kernel equal), phase 47's rank 0 on both
   meshes (parameter and moment bytes equal to its blocks, peak within
   10%, collectives per kind equal to rank 0's step 1), and ``run_one``
   for Mixtral-8x7B and Qwen3-30B-A3B x ``train_4k`` on the production
   mesh (16, 16), in processes of their own started after the build;
51. the bench harness (``repro_torch.bench``): its kernels, memory and
   serving suites at the full sweep (records under ``build/bench_torch/``),
   its four same-run gates (any failure line fails the script), then
   ``paper_tables.run()`` at the paper's full Table-1 sizes, each row
   printed beside the card's name and power limit.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the
reference package.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12          # dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12            # float32 outside the tensor cores
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
#  flash attention in bf16 over long sequences (phase 41: S = 2048 and
#    6144): each output averages hundreds to thousands of keys, so |o| is
#    about 0.03 and the absolute bound above would hide a dropped kv tile
#    or a wrong GQA head.  Each element is held to 2^-5 of |o| plus its
#    row's mean |o| (over Dh): room for a few bf16 roundings (2^-8 each:
#    the plain version's scaled q, the kernel's P and both outputs), far
#    below what a 64-key tile dropped from 2048 moves a row (about
#    sqrt(64 / 2048), 18% of its values).
FLASH_ROW_REL = 2 ** -5
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
# Gradient accumulation on the card (phase 27): M = 2 against M = 1 on one
# 2 x 2048 batch in bf16 compute.  Each token's routing, attention and
# expert rows are computed alike, but the cross entropy's mean and every
# weight gradient sum in other groupings (each microbatch's bf16 grouped
# weight gradient rounds once before the float32 sum), and the
# load-balance loss is estimated per microbatch (~1e-4 of a ~0.01 term):
# loss and ce 1e-4 relative, the grad norm 1e-2.
MB_LOSS_RTOL, MB_NORM_RTOL = 1e-4, 1e-2
# The dispatch build's shapes (label, L, k, E), held bit-equal in phase 3
# and timed in phase 4: Mixtral's decode, prefill and training, ep_a2a's
# pack on one rank (2 groups: rank 0 and the trash group),
# qwen3_moe_30b_a3b's training width, the paper's Table-1 confs 2 and 3
# (32 x 2048 tokens; src/repro/configs/paper_tables.py:11-12), the widest
# expert count the kernel takes, and both sides of its one-launch limit
# (kernels/dispatch.py:N_ONE, 16384 slots).
DISPATCH_SHAPES = (
    ("decode", 4, 2, 8), ("prefill", 2048, 2, 8), ("training", 4096, 2, 8),
    ("ep_a2a pack, one rank", 8192, 1, 2),
    ("qwen3_moe_30b_a3b training", 4096, 8, 128),
    ("paper_conf2", 65536, 2, 8), ("paper_conf3", 65536, 4, 16),
    ("widest", 8192, 8, 256), ("n = N_ONE", 8192, 2, 8),
    ("n = N_ONE + 1", 16385, 1, 8))


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


def bound_ms(nbytes: float, ops: float, launch_ms: float = 0.0,
             ops_per_s: float = BF16_OPS_PER_S) -> tuple[float, str]:
    """The least time for the work: the largest of its bytes over the
    memory rate, its operations over the peak for the inputs' type
    (``ops_per_s``: bf16 unless given) and ``launch_ms`` (the time of
    empty kernels launched as a call of the kernel launches its own)."""
    return max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
               (ops / ops_per_s * 1e3, "operations"),
               (launch_ms, "launch"), key=lambda t: t[0])


def random_topk(L: int, k: int, E: int, gen) -> torch.Tensor:
    """(L, k) int32 top-k of uniform scores: k distinct experts a row."""
    return (torch.rand(L, E, generator=gen, device=gen.device).argsort(1)
            [:, :k].to(torch.int32).contiguous())


def require_close(name, got, want, rtol, atol) -> float:
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    bad = int((err > lim).sum())
    worst = float(err.max()) if err.numel() else 0.0
    check(bad == 0, f"{name}: {bad} elements outside tolerance "
                    f"(max |err| {worst:.4g})")
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    return worst


def require_row_close(name, got, want, rel) -> dict:
    """Holds every element to ``rel`` times (|want| + its row's mean
    |want| over the last axis); returns the largest absolute error, the
    largest ratio of error to that scale, and max and mean |want|."""
    w = want.float()
    err = (got.float() - w).abs()
    scale = w.abs() + w.abs().mean(-1, keepdim=True)
    ratio = err / scale.clamp_min(torch.finfo(torch.float32).tiny)
    out = {"max_abs_err": float(err.max()), "max_ratio": float(ratio.max()),
           "max_abs_o": float(w.abs().max()),
           "mean_abs_o": float(w.abs().mean())}
    bad = int((ratio > rel).sum())
    check(bad == 0, f"{name}: {bad} elements beyond {rel:.4g} of |o| plus "
                    f"the row's mean |o| (max ratio {out['max_ratio']:.4g}, "
                    f"max |err| {out['max_abs_err']:.4g})")
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    return out


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
    from repro_torch.serve import paged_cache as PC
    from repro_torch.serve import runtime as RT
    from repro_torch.serve import sampling as SM
    from repro_torch.models import ssm as SSM
    M = SimpleNamespace(KG=KG, KW=KW, KF=KF, KC=KC, KO=KO, TR=TR, KFM=KFM,
                        ML=ML, KS=KS, KP=KP, KQ=KQ, SE=SE, T=T, K=K, SH=SH,
                        CL=CL, MS=MS, KR=KR, MESH=MESH, MB=MB, KD=KD, PC=PC,
                        RT=RT, SM=SM, SSM=SSM, init_params=init_params)

    t_start = time.perf_counter()

    def mark(phase: str) -> None:
        log(f"[phase {phase} starts at {time.perf_counter() - t_start:.1f} s]")

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
    # phase 50 (c)'s traces start now, on the host's spare cores
    dry_work = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    dry_procs = dryrun_start(dry_work)

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

    mark("3")
    # -- 3. parity ----------------------------------------------------------
    errs = {n: 0.0 for n in ("build_dispatch", "gather_gmm", "combine",
                             "paged_attention", "gmm_dw",
                             "flash_attention", "fused_moe_fwd",
                             "fused_moe_bwd", "fused_swiglu_fwd",
                             "fused_swiglu_bwd_x", "fused_swiglu_bwd_w",
                             "paged_attention_int8", "gather_rows")}

    def dispatch_case(name, topk, n_exp):
        want = TR.build_dispatch(topk, n_exp)
        for call in ("", ", repeated"):
            got = KD.build_dispatch(topk, n_exp)
            for f in TR.Dispatch._fields:
                check(torch.equal(getattr(got, f), getattr(want, f)),
                      f"dispatch {name}{call}: {f} differs")
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
        "one expert, 37 tokens), each call repeated bit-equal")
    # the shapes of DISPATCH_SHAPES, from their own generator so that later
    # phases draw what they drew before
    disp_gen = torch.Generator(device=dev).manual_seed(7)
    disp_topk = {}
    for label, L_, k_, E_ in DISPATCH_SHAPES:
        disp_topk[label] = random_topk(L_, k_, E_, disp_gen)
        dispatch_case(label, disp_topk[label], E_)
        plan = KD.dispatch_plan(L_ * k_, E_)
        log(f"parity build_dispatch [{label}: L={L_}, k={k_}, E={E_}, "
            f"n={L_ * k_}]: bit-equal, repeated bit-equal; {plan['path']} "
            f"path, {plan['launches']} kernel launch(es), grid "
            f"{plan['grid']} x {plan['threads']} threads, "
            f"{plan['smem']} B shared memory")

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

    mark("4")
    # -- 4. timing ----------------------------------------------------------
    timer = Timer(dev)
    rows = {}

    # Launch floors: empty kernels launched in the pattern a call of the
    # kernel needs (one; n back to back; a pair, the second the first's
    # programmatic dependent), timed as every kernel is (L2 flushed, the
    # host hidden behind the sleep).
    floors = {}

    def launch_floor(launches, dependent):
        key = (launches, dependent and launches > 1)
        if key not in floors:
            floors[key] = timer(lambda: _lib.noop(dev, *key), reps=20)
            log(f"launch floor [{launches} launch(es)"
                f"{', dependent' if key[1] else ''}]: {floors[key]:.4f} ms "
                "(empty kernels, timed as every kernel)")
        return floors[key]

    def entry(ms, plain_ms, nbytes, ops, library_ms=None, shape="",
              launches=1, dependent=False, ops_per_s=BF16_OPS_PER_S):
        b, by = bound_ms(nbytes, ops, launch_floor(launches, dependent),
                         ops_per_s)
        return {"shape": shape, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b, "bound_by": by, "library_ms": library_ms,
                "kernel_launches": launches}

    launch_floor(1, False)

    def disp_entry(label, topk, n_exp):
        L_, k_ = topk.shape
        n = L_ * k_
        nbytes = 4 * (n + n_exp + (n_exp + 1) + 2 * n)
        plan = KD.dispatch_plan(n, n_exp)
        return entry(timer(lambda: KD.build_dispatch(topk, n_exp)),
                     timer(lambda: TR.build_dispatch(topk, n_exp)),
                     nbytes, 0,
                     timer(lambda: TR.build_dispatch_sort(topk, n_exp)),
                     f"{label}: L={L_}, k={k_}, E={n_exp}, n={n} (library: "
                     "sort-based build, composition)",
                     launches=plan["launches"],
                     dependent=plan["path"] == "two")

    # Mixtral's own routing at prefill, decode and training; the rest of
    # DISPATCH_SHAPES from phase 3's draws
    mixtral_topk = {"prefill": topk_pre, "decode": topk_dec,
                    "training": topk_tr}
    n_exp = {label: E_ for label, _, _, E_ in DISPATCH_SHAPES}
    labels = list(mixtral_topk) + [lb for lb in n_exp
                                   if lb not in mixtral_topk]
    rows["build_dispatch"] = [
        disp_entry(lb, mixtral_topk.get(lb, disp_topk.get(lb)), n_exp[lb])
        for lb in labels]
    del disp_topk

    S_tr = disp_tr.num_slots
    gmm = partial(gmm_row, M, timer, entry)
    rows["gather_gmm"] = [
        gmm(x_tr, disp_tr, moe["w1"], moe["w2"], disp_tr.expert_token_indices,
            f"training dual w1/w2 + save_ab: S={S_tr}, d={d}, h={h}",
            plain_reps=1, save_ab=True),
        gmm(tr["y_swi"], disp_tr, moe["w3"], None, None,
            f"training w3 forward: S={S_tr}, {h}->{d}", plain_reps=1),
        gmm(tr["dyg"], disp_tr, moe["w3"], None, None,
            f"training w3^T: S={S_tr}, {d}->{h}", plain_reps=1,
            trans_w=True),
        gmm(tr["da"], disp_tr, moe["w1"], None, None,
            f"training w1^T: S={S_tr}, {h}->{d}", plain_reps=1,
            trans_w=True),
        gmm(x_pre, disp_pre, moe["w1"], moe["w2"],
            disp_pre.expert_token_indices,
            f"prefill dual w1/w2: S={disp_pre.num_slots}, d={d}, h={h}",
            plain_reps=1),
        gmm(y_pre, disp_pre, moe["w3"], None, None,
            f"prefill w3: S={disp_pre.num_slots}, h={h}, d={d}",
            plain_reps=1),
        gmm(x_dec, disp_dec, moe["w1"], moe["w2"],
            disp_dec.expert_token_indices,
            f"decode dual w1/w2: S={disp_dec.num_slots}, d={d}, h={h}",
            plain_reps=5),
        gmm(y_dec, disp_dec, moe["w3"], None, None,
            f"decode w3: S={disp_dec.num_slots}, h={h}, d={d}",
            plain_reps=5)]

    rows["combine"] = [
        combine_row(M, timer, entry, p_pre, disp_pre, g_pre,
                    f"prefill: S={disp_pre.num_slots}, L={L_pre}, d={d}"),
        combine_row(M, timer, entry, p_dec, disp_dec, g_dec,
                    f"decode: S={disp_dec.num_slots}, L={L_dec}, d={d}")]

    rows.update(train_kernel_timing(M, timer, entry, tr, disp_tr))
    rows.update(fused_kernel_timing(M, timer, entry, fz, moe))

    rows["paged_attention"] = [paged_row(
        M, timer, entry, q_dec, (kp, vp), table, pos, cfg.sliding_window,
        f"decode: B=4, Hq={Hq}, Hkv={Hkv}, Dh={Dh}, page {ps}, "
        f"positions {pos.tolist()}")]
    for name, rs in rows.items():
        for r in rs:
            log(f"time {name} [{r['shape']}]: {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), library {r['library_ms']}")
    del y_pre, p_pre, tr, fz

    mark("5")
    # -- 5. end to end ------------------------------------------------------
    prompt_lens = (37, 129, 300, 511, 64)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).astype(np.int32)
               for n in prompt_lens]
    mix = serving_phase(M, cfg, params, prompts, dev, (
        "build_dispatch", "gather_gmm", "combine", "paged_attention"), "")
    launches = mix["launches"]

    mark("6")
    # -- 6. CPU cross-check -------------------------------------------------
    prompt = rng.integers(3, cfg.vocab_size, size=24).astype(np.int32)
    cpu_prefill_crosscheck(T, cfg, params, prompt, dev)

    mark("30")
    # -- 30. temperature sampling -------------------------------------------
    samp = sampling_phase(M, cfg, params, prompts, dev, timer)

    mark("31")
    # -- 31. prefix sharing, bf16 and int8 pages ------------------------------
    pref = {"bf16": prefix_phase(M, cfg, params, dev, timer),
            "int8": prefix_phase(M, cfg, params, dev, timer, "int8")}

    mark("32")
    # -- 32. per-request backends and the paged-attention registry -----------
    backs = backends_phase(M, cfg, params, prompts, dev)

    mark("33")
    # -- 33. the async runtime (Mixtral) --------------------------------------
    rt_mix = runtime_phase(M, cfg, params, prompts, dev, " [mixtral-8x7b]")
    torch.cuda.empty_cache()

    mark("7")
    # -- 7. training ----------------------------------------------------------
    # The training step holds ~65 GB; free the serving weights and what
    # holds them first.
    del params, moe
    torch.cuda.empty_cache()
    log(f"train: serving weights freed, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB still allocated")
    # Exact launches a step under the configs' default plan "none": each
    # layer's forward kernels twice (the forward, then the backward's
    # recompute of the layer), its backward kernels once.
    cfg_train = get_config("mixtral-8x7b").replace(
        num_layers=2, moe_impl="blaze_pallas", use_pallas=True)
    n = cfg_train.num_layers
    train = training_phase(cfg_train, dev, K, (
        "build_dispatch", "gather_gmm", "combine", "gmm_dw",
        "flash_attention"), "blaze_pallas", per_step={
            "flash_attention": 2 * n, "build_dispatch": 2 * n,
            "gather_gmm": (2 * 2 + 3) * n, "combine": 2 * n,
            "gmm_dw": 3 * n})
    torch.cuda.empty_cache()

    mark("8")
    # -- 8. training, the reference's default layer on the fused pair ---------
    # (the previous phase's parameters and moments are freed with it)
    cfg_fused = get_config("mixtral-8x7b").replace(
        num_layers=2, gmm_backend="pallas_fused", use_pallas=True)
    train_fused = training_phase(cfg_fused, dev, K, (
        "build_dispatch", "fused_moe_fwd", "fused_moe_bwd",
        "flash_attention"), "blaze+pallas_fused", per_step={
            "flash_attention": 2 * n, "build_dispatch": 2 * n,
            "fused_moe_fwd": 2 * n, "fused_moe_bwd": n})
    torch.cuda.empty_cache()

    mark("9")
    # -- 9. CPU training cross-checks -------------------------------------------
    xcheck = cpu_train_crosscheck(dev, moe_impl="blaze_pallas")
    xcheck_fused = cpu_train_crosscheck(dev, gmm_backend="pallas_fused")
    torch.cuda.empty_cache()

    mark("10")
    # -- 10. the row gather (the ep_a2a send buffer) ------------------------------
    rows["gather_rows"] = gather_rows_checks(M, dev, rng, timer, entry, randn,
                                             errs, dispatch_case, topk_tr)
    torch.cuda.empty_cache()

    mark("11")
    # -- 11. the MoE layer on a one-rank NCCL mesh, full width -----------------
    mesh1 = one_rank_mesh(M, dev)
    layer1 = layer_mesh_parity(M, dev, mesh1)
    torch.cuda.empty_cache()

    mark("12")
    # -- 12. training, ep_a2a on the one-rank mesh --------------------------------
    cfg_a2a = get_config("mixtral-8x7b").replace(
        num_layers=2, gmm_backend="pallas", moe_parallel="ep_a2a",
        use_pallas=True)
    # per layer: two dispatch builds (the pack by destination, the local
    # bank), the send buffer's row gather and three grouped GEMMs forward;
    # three gmm_dw and three transposed products backward
    train_a2a = training_phase(cfg_a2a, dev, K, (
        "build_dispatch", "gather_gmm", "gmm_dw", "flash_attention",
        "gather_rows"), "ep_a2a", mesh=mesh1, per_step={
            "flash_attention": 2 * n, "build_dispatch": 2 * 2 * n,
            "gather_rows": 2 * n, "gather_gmm": (2 * 3 + 3) * n,
            "gmm_dw": 3 * n})
    check(all(v == 0.0 for v in train_a2a["moe_overflow"]),
          "train [ep_a2a]: slots dropped at one rank")
    torch.distributed.destroy_process_group()
    del mesh1
    torch.cuda.empty_cache()

    mark("13")
    # -- 13. several ranks on the one card ---------------------------------------
    multi = multi_rank_phase(M, dev)
    torch.cuda.empty_cache()

    mark("14")
    # -- 14. Qwen3-14B parity ---------------------------------------------------
    qcfg = get_config("qwen3-14b").replace(use_pallas=True)
    qz = qwen_kernel_parity(M, dev, rng, randn, errs, qcfg)

    mark("15")
    # -- 15. Qwen3-14B timing ---------------------------------------------------
    rows.update(qwen_kernel_timing(M, timer, entry, qz, randn))
    for name in ("fused_swiglu_fwd", "fused_swiglu_bwd_x",
                 "fused_swiglu_bwd_w", "paged_attention_int8"):
        for r in rows[name]:
            log(f"time {name} [{r['shape']}]: {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), library {r['library_ms']}")
    del qz

    mark("16")
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

    mark("17")
    # -- 17. Qwen3-14B CPU cross-check, 2-layer cut ------------------------------
    qprompt = rng.integers(3, qcfg.vocab_size, size=24).astype(np.int32)
    qx = cpu_prefill_crosscheck(T, qcfg.replace(num_layers=2),
                                dict(qparams, layers=qparams["layers"][:2]),
                                qprompt, dev, allow_near_tie=True)

    mark("33 [qwen3-14b]")
    # -- 33. the async runtime (Qwen3-14B, 40 layers) -------------------------
    rt_qwen = runtime_phase(M, qcfg, qparams, qprompts, dev, " [qwen3-14b]")
    del qparams
    torch.cuda.empty_cache()

    mark("18")
    # -- 18. Qwen3-14B training, 4 layers --------------------------------------
    cfg_qtrain = get_config("qwen3-14b").replace(num_layers=4,
                                                 use_pallas=True)
    nq = cfg_qtrain.num_layers
    qtrain = training_phase(cfg_qtrain, dev, K, (
        "fused_swiglu_fwd", "fused_swiglu_bwd_x", "fused_swiglu_bwd_w",
        "flash_attention"), "qwen3-14b", per_step={
            "flash_attention": 2 * nq, "fused_swiglu_fwd": 2 * nq,
            "fused_swiglu_bwd_x": nq, "fused_swiglu_bwd_w": nq})
    torch.cuda.empty_cache()

    mark("19")
    # -- 19. Qwen3-14B CPU training cross-check ----------------------------------
    # One element of a leaf may step apart: in the reduced Qwen3-14B a
    # 256-wide norm scale has an element whose gradient is ~1.7e-5 of its
    # leaf's scale, which clipping (grad norm ~8) brings to a few AdamW
    # epsilons, so its update follows the float32 noise of the two sides
    # (gradients agree to ~2e-6 of each leaf's scale, measured on the card);
    # a share of 1e-3 of 256 elements allows none.
    xcheck_q = cpu_train_crosscheck(dev, arch="qwen3-14b", far_floor=1)
    torch.cuda.empty_cache()

    mark("20")
    # -- 20. the plan sweep ------------------------------------------------------
    sweep = plan_sweep_phase(dev, K)
    torch.cuda.empty_cache()
    sweep["dense"] = dense_plan_held(dev)

    mark("21")
    # -- 21. the paper's comparison at the Table-1 sizes -------------------------
    paper = paper_table_phase(dev)
    torch.cuda.empty_cache()

    mark("22-23")
    # -- 22-23. Qwen3-30B-A3B's kernels at its shapes ---------------------------
    m_cfg = get_config("qwen3-moe-30b-a3b").replace(
        use_pallas=True, moe_impl="blaze_pallas")
    for name, rs in moe30_kernels(M, dev, timer, entry, errs, m_cfg).items():
        rows[name].extend(rs)
    torch.cuda.empty_cache()

    mark("24")
    # -- 24. Qwen3-30B-A3B serving, 48 layers, bf16 then int8 pages ---------------
    # the kernel composition (blaze_pallas), as phase 5 serves Mixtral: the
    # config's own "blaze" layer would resolve its grouped GEMMs to the
    # library ("auto" -> ragged)
    gen = torch.Generator(device=dev).manual_seed(0)
    mparams = init_params(m_cfg, gen, dev)
    torch.cuda.synchronize()
    m_weight_bytes = sum(t.numel() * t.element_size()
                         for t in _leaves(mparams))
    log(f"weights: {m_cfg.name} full width and full depth, "
        f"{m_cfg.num_layers} layers, {m_weight_bytes / 1e9:.2f} GB bf16 "
        f"({m_weight_bytes / 2 ** 30:.3f} GiB, "
        f"{m_weight_bytes / 2 / 1e9:.3f} B parameters); allocated "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")
    mprompts = [rng.integers(3, m_cfg.vocab_size, size=n).astype(np.int32)
                for n in prompt_lens]
    mserve = serving_phase(M, m_cfg, mparams, mprompts, dev, (
        "build_dispatch", "gather_gmm", "combine", "flash_attention",
        "paged_attention"), " [qwen3-moe-30b-a3b bf16 pages]")
    mserve8 = serving_phase(M, m_cfg, mparams, mprompts, dev, (
        "build_dispatch", "gather_gmm", "combine", "flash_attention",
        "paged_attention_int8"), " [qwen3-moe-30b-a3b int8 pages]",
        kv_dtype="int8", traced=False)
    first_equal = all(a[0] == b[0] for a, b in zip(mserve["tokens"],
                                                   mserve8["tokens"]))
    log(f"int8 vs bf16 pages [qwen3-moe-30b-a3b]: first tokens equal "
        f"{first_equal}; KV bytes per cached token bf16 "
        f"{mserve['kv_bytes_per_token']} / int8 "
        f"{mserve8['kv_bytes_per_token']}")
    check(first_equal, "int8 pages changed a first token [qwen3-moe-30b-a3b]")
    check(mserve["kv_bytes_per_token"] == 98304
          and mserve8["kv_bytes_per_token"] == 49920,
          "KV bytes per token are not 98,304 (bf16) and 49,920 (int8)")

    mark("25")
    # -- 25. Qwen3-30B-A3B CPU cross-check, 2-layer cut ---------------------------
    mprompt = rng.integers(3, m_cfg.vocab_size, size=24).astype(np.int32)
    mx = cpu_prefill_crosscheck(T, m_cfg.replace(num_layers=2),
                                dict(mparams, layers=mparams["layers"][:2]),
                                mprompt, dev, allow_near_tie=True)
    del mparams
    torch.cuda.empty_cache()

    mark("26")
    # -- 26. Qwen3-30B-A3B training, 4 layers ----------------------------------
    cfg_mtrain = get_config("qwen3-moe-30b-a3b").replace(
        num_layers=4, moe_impl="blaze_pallas", use_pallas=True)
    nm = cfg_mtrain.num_layers
    mtrain = training_phase(cfg_mtrain, dev, K, (
        "build_dispatch", "gather_gmm", "combine", "gmm_dw",
        "flash_attention"), "qwen3-moe-30b-a3b blaze_pallas", per_step={
            "flash_attention": 2 * nm, "build_dispatch": 2 * nm,
            "gather_gmm": (2 * 2 + 3) * nm, "combine": 2 * nm,
            "gmm_dw": 3 * nm})
    torch.cuda.empty_cache()
    mtrain_fused = training_phase(cfg_mtrain.replace(
        moe_impl="blaze", gmm_backend="pallas_fused"), dev, K, (
        "build_dispatch", "fused_moe_fwd", "fused_moe_bwd",
        "flash_attention"), "qwen3-moe-30b-a3b blaze+pallas_fused",
        per_step={"flash_attention": 2 * nm, "build_dispatch": 2 * nm,
                  "fused_moe_fwd": 2 * nm, "fused_moe_bwd": nm})
    torch.cuda.empty_cache()
    xcheck_m = cpu_train_crosscheck(dev, arch="qwen3-moe-30b-a3b",
                                    moe_impl="blaze_pallas")
    torch.cuda.empty_cache()

    mark("27-28")
    # -- 27-28. gradient accumulation (Mixtral-8x7B) ---------------------------
    micro = microbatch_phase(dev, K)
    torch.cuda.empty_cache()

    mark("29")
    # -- 29. a training checkpoint served on the card ---------------------------
    ckpt = checkpoint_phase(M, dev)
    torch.cuda.empty_cache()

    mark("34")
    # -- 34. Hymba-1.5B training, 32 layers ------------------------------------
    cfg_hy = get_config("hymba-1.5b").replace(use_pallas=True)
    nh = cfg_hy.num_layers
    htrain = training_phase(cfg_hy, dev, K, (
        "flash_attention", "fused_swiglu_fwd", "fused_swiglu_bwd_x",
        "fused_swiglu_bwd_w"), "hymba-1.5b", per_step={
            "flash_attention": 2 * nh, "fused_swiglu_fwd": 2 * nh,
            "fused_swiglu_bwd_x": nh, "fused_swiglu_bwd_w": nh},
        steps_warm=NEW_WARM_STEPS, spans=False)
    torch.cuda.empty_cache()
    xcheck_h = cpu_train_crosscheck(dev, arch="hymba-1.5b")
    torch.cuda.empty_cache()

    mark("35")
    # -- 35. Hymba-1.5B decode, 32 layers, and 2 layers past the window --------
    cfg_hyd = get_config("hymba-1.5b").replace(dtype="bfloat16",
                                               use_pallas=True)
    hdec = decode_phase(M, cfg_hyd, dev, " [hymba-1.5b, 32 layers]", K,
                        cut_cfg=cfg_hyd.replace(num_layers=2))
    check(hdec["launches"]["fused_swiglu_fwd"] == nh * DECODE_NEW,
          "decode [hymba-1.5b]: the fused SwiGLU forward is not launched "
          "once a layer a step")

    mark("36")
    # -- 36. xLSTM-1.3B decode (48 layers) and training (8 layers) --------------
    # no kernel runs on this path: no attention, no FFN (d_ff = 0), and the
    # scans are plain PyTorch as the reference's are plain JAX
    cfg_xd = get_config("xlstm-1.3b").replace(dtype="bfloat16",
                                              use_pallas=True)
    xdec = decode_phase(M, cfg_xd, dev, " [xlstm-1.3b, 48 layers]", K,
                        cut_cfg=cfg_xd.replace(num_layers=8, dtype="float32"),
                        cut_len=DECODE_PROMPT, f32_full=False)
    check(not any(xdec["launches"].values()),
          "decode [xlstm-1.3b]: a kernel was launched on a path that has none")
    cfg_xt = get_config("xlstm-1.3b").replace(num_layers=8, use_pallas=True)
    xtrain = training_phase(cfg_xt, dev, K, (), "xlstm-1.3b, 8 layers",
                            steps_warm=NEW_WARM_STEPS, spans=False)
    check(not any(xtrain["launches"].values()),
          "train [xlstm-1.3b]: a kernel was launched on a path that has none")
    log("xlstm-1.3b: decode and training launched no kernel (the path has "
        "none: no attention, d_ff = 0, plain scans)")
    torch.cuda.empty_cache()
    # one group, 7 mLSTM + 1 sLSTM layers: at a random init the mLSTM
    # layers amplify float32 rounding from layer to layer, past the fixed
    # bounds (the CPU's float32 gradients sit up to ~0.1 of a leaf's scale
    # from its float64 ones), so the bounds are twice that distance
    xcheck_x = cpu_train_crosscheck(dev, arch="xlstm-1.3b", num_layers=8,
                                    float64_spread=True)
    torch.cuda.empty_cache()

    mark("37")
    # -- 37. Gemma2-27B served at all 46 layers, one prompt past the window ----
    gcfg = get_config("gemma2-27b").replace(use_pallas=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    gparams = init_params(gcfg, gen, dev)
    torch.cuda.synchronize()
    g_weight_bytes = sum(t.numel() * t.element_size()
                         for t in _leaves(gparams))
    log(f"weights: {gcfg.name} full width and full depth, "
        f"{gcfg.num_layers} layers, {g_weight_bytes / 1e9:.2f} GB bf16; "
        f"allocated {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")
    # one prompt longer than the 4096-token local window: the window cuts in
    # prefill and in every decode step of that request
    gprompts = [rng.integers(3, gcfg.vocab_size, size=n).astype(np.int32)
                for n in (4200, 37, 300)]
    gserve = serving_phase(M, gcfg, gparams, gprompts, dev, (
        "fused_swiglu_fwd", "flash_attention", "paged_attention"),
        " [gemma2-27b bf16 pages]", slots=2, capacity=4608, max_new=32)
    gprompt = rng.integers(3, gcfg.vocab_size, size=24).astype(np.int32)
    gx = cpu_prefill_crosscheck(T, gcfg.replace(num_layers=2),
                                dict(gparams, layers=gparams["layers"][:2]),
                                gprompt, dev, allow_near_tie=True)
    del gparams
    torch.cuda.empty_cache()

    mark("38")
    # -- 38. Yi-6B (32 layers) and DeepSeek-Coder-33B (4 of 62 layers) ----------
    dense_e2e = {}
    for arch, layers in (("yi-6b", None), ("deepseek-coder-33b", 4)):
        dcfg = get_config(arch).replace(use_pallas=True)
        if layers is not None:
            dcfg = dcfg.replace(num_layers=layers)
        gen = torch.Generator(device=dev).manual_seed(0)
        dparams = init_params(dcfg, gen, dev)
        d_bytes = sum(t.numel() * t.element_size() for t in _leaves(dparams))
        log(f"weights: {dcfg.name} full width, {dcfg.num_layers} layers, "
            f"{d_bytes / 1e9:.2f} GB bf16")
        dprompts = [rng.integers(3, dcfg.vocab_size, size=n).astype(np.int32)
                    for n in prompt_lens]
        rec = serving_phase(M, dcfg, dparams, dprompts, dev, (
            "fused_swiglu_fwd", "flash_attention", "paged_attention"),
            f" [{arch} bf16 pages]", traced=False)
        dprompt = rng.integers(3, dcfg.vocab_size, size=24).astype(np.int32)
        rec["crosscheck"] = cpu_prefill_crosscheck(
            T, dcfg.replace(num_layers=2),
            dict(dparams, layers=dparams["layers"][:2]), dprompt, dev,
            allow_near_tie=True)
        rec["weight_bytes"] = d_bytes
        dense_e2e[arch] = rec
        del dparams
        torch.cuda.empty_cache()

    mark("39")
    # -- 39. the kernels at the new paths' shapes ---------------------------------
    for name, rs in new_shape_kernels(M, dev, timer, entry, errs).items():
        rows[name].extend(rs)
    torch.cuda.empty_cache()

    mark("40")
    # -- 40. the fused MoE pair's general path: one writer per element ---------
    for name, rs in general_path_phase(M, dev, timer, entry, errs).items():
        rows[name].extend(rs)
    torch.cuda.empty_cache()

    mark("41")
    # -- 41. the kernels at the frame and mixed paths' shapes ------------------
    for name, rs in frames_mixed_kernels(M, dev, timer, entry, errs).items():
        rows[name].extend(rs)
    torch.cuda.empty_cache()

    mark("42")
    # -- 42. HuBERT-XLarge training, all 48 layers, 2 x 2048 frames ------------
    # flash attention without the causal mask, heads of 80: once a layer in
    # the forward and once in the backward's recompute; the GELU FFN is two
    # plain products, as in the reference
    cfg_hu = get_config("hubert-xlarge").replace(use_pallas=True)
    nhu = cfg_hu.num_layers
    hutrain = training_phase(cfg_hu, dev, K, ("flash_attention",),
                             "hubert-xlarge", per_step={
                                 "flash_attention": 2 * nhu},
                             steps_warm=5, spans=False, seq=HUBERT_SEQ)
    check(hutrain["launches_per_step"]["flash_attention"] == 96,
          "train [hubert-xlarge]: not 96 flash launches a step")
    # heads of 80 in bf16 take the tensor cores (padded to 128)
    check(hutrain["launches_per_step"]["flash_attention_general"] == 0,
          "train [hubert-xlarge]: flash launches on the general kernel")
    flash_ms = sum(ms for name, ms in hutrain["by_kernel_ms"].items()
                   if "flash_wgmma_kernel" in name
                   or "flash_tiled_kernel" in name)
    hutrain["flash_share"] = flash_ms / (hutrain["busy_s"] * 1e3)
    log(f"train [hubert-xlarge]: {hutrain['tokens_per_s']:.1f} frames/s "
        f"({hutrain['tokens_per_s'] * 0.02:.1f} s of 20 ms frames a second "
        f"of training), step {hutrain['step_s']:.4f} s, peak "
        f"{hutrain['peak_bytes'] / 2 ** 30:.3f} GiB, device busy "
        f"{100 * hutrain['busy_s'] / hutrain['traced_wall_s']:.1f}%, flash "
        f"launches a step {hutrain['launches_per_step']['flash_attention']:g} "
        "(all on the tensor cores), flash kernels "
        f"{flash_ms:.3f} ms of the traced step's "
        f"{hutrain['busy_s'] * 1e3:.3f} ms of device time "
        f"({100 * hutrain['flash_share']:.2f}%)")
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    hu2 = cfg_hu.replace(num_layers=2, dtype="bfloat16")
    huparams = init_params(hu2, gen, dev)
    hux = cpu_forward_crosscheck(T, hu2, huparams, dev)
    del huparams
    torch.cuda.empty_cache()

    mark("43")
    # -- 43. LLaVA-NeXT-Mistral-7B: forward at all 32 layers over 6144 ---------
    #        positions, then the CPU cross-check on a 2-layer cut
    lcfg = get_config("llava-next-mistral-7b").replace(use_pallas=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    lparams = init_params(lcfg, gen, dev)
    torch.cuda.synchronize()
    l_weight_bytes = sum(t.numel() * t.element_size()
                         for t in _leaves(lparams))
    log(f"weights: {lcfg.name} full width and full depth, "
        f"{lcfg.num_layers} layers, {l_weight_bytes / 1e9:.2f} GB bf16 "
        f"({sum(t.numel() for t in _leaves(lparams)) / 1e9:.3f} B "
        "parameters)")
    lfwd = llava_forward_phase(M, lcfg, lparams, dev, K)
    lfwd["weight_bytes"] = l_weight_bytes
    lx = cpu_forward_crosscheck(T, lcfg.replace(num_layers=2),
                                dict(lparams, layers=lparams["layers"][:2]),
                                dev)
    del lparams
    torch.cuda.empty_cache()

    mark("44")
    # -- 44. LLaVA-NeXT decode through init_cache / decode_step, 32 layers -----
    ldec = decode_phase(M, lcfg.replace(dtype="bfloat16"), dev,
                        " [llava-next-mistral-7b, 32 layers]", K,
                        cut_cfg=lcfg.replace(num_layers=2, dtype="float32"),
                        cut_len=DECODE_PROMPT, f32_full=False,
                        n_new=LLAVA_DECODE_NEW)
    check(ldec["launches"]["fused_swiglu_fwd"]
          == lcfg.num_layers * LLAVA_DECODE_NEW,
          "decode [llava-next-mistral-7b]: the fused SwiGLU forward is not "
          "launched once a layer a step")
    torch.cuda.empty_cache()

    mark("45")
    # -- 45. LLaVA-NeXT training, 4 layers, 2 x 4096 positions -----------------
    cfg_lt = get_config("llava-next-mistral-7b").replace(num_layers=4,
                                                         use_pallas=True)
    nl = cfg_lt.num_layers
    ltrain = training_phase(cfg_lt, dev, K, (
        "fused_swiglu_fwd", "fused_swiglu_bwd_x", "fused_swiglu_bwd_w",
        "flash_attention"), "llava-next-mistral-7b, 4 layers", per_step={
            "flash_attention": 2 * nl, "fused_swiglu_fwd": 2 * nl,
            "fused_swiglu_bwd_x": nl, "fused_swiglu_bwd_w": nl},
        steps_warm=NEW_WARM_STEPS, seq=LLAVA_TRAIN_SEQ)
    torch.cuda.empty_cache()

    mark("46")
    # -- 46. moe_parallel="auto" at the H100's constants ----------------------
    auto = auto_phase(M)

    mark("47-49")
    # -- 47-49. FSDP training, a checkpoint and serving under a mesh ---------
    meshrec = mesh_phases(M, dev, auto)
    torch.cuda.empty_cache()

    mark("50")
    # -- 50. the dry run, held to phases 7 and 47, and on (16, 16) ---------
    dryrec = dryrun_phase(dev, train, cfg_train, meshrec, dry_procs)
    shutil.rmtree(dry_work)
    torch.cuda.empty_cache()

    mark("51")
    # -- 51. the bench harness: its suites, same-run gates, paper tables -----
    benchrec = bench_phase(M, dev, card)

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
        for r in rows[name]:
            check(r["ms"] >= r["bound_ms"],
                  f"{name} [{r['shape']}] reads {r['ms']:.4f} ms, under its "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        # the Qwen3-30B-A3B paths' launches, beside
        m_phase = mtrain_fused if name.startswith("fused_moe") else mtrain
        m_serve = mserve8 if name == "paged_attention_int8" else mserve
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_train or n_serve,
            "launches_train": n_train, "launches_serve": n_serve,
            "launches_qwen3_moe_train": m_phase["launches"].get(name, 0),
            "launches_qwen3_moe_serve": m_serve["launches"].get(name, 0),
            "launches_hymba_train": htrain["launches"].get(name, 0),
            "launches_hymba_decode": hdec["launches"].get(name, 0),
            "launches_gemma2_serve": gserve["launches"].get(name, 0),
            "launches_hubert_train": hutrain["launches"].get(name, 0),
            "launches_llava_forward": lfwd["launches"].get(name, 0),
            "launches_llava_decode": ldec["launches"].get(name, 0),
            "launches_llava_train": ltrain["launches"].get(name, 0),
            **{f"launches_mesh_train_{lb}": [
                r_.get(name, 0) for r_ in rec_["launches"]]
               for lb, rec_ in meshrec["train"].items()},
            **{f"launches_mesh_serve_{md}": [
                r_.get(name, 0) for r_ in rec_["launches"]]
               for md, rec_ in meshrec["serve"].items()},
            "launches_dryrun_train": dryrec["train"]["launches"].get(
                name, 0),
            "launches_bench": benchrec["launches"].get(name, 0),
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
                              q_weight_bytes),
                             (" [qwen3-moe-30b-a3b bf16 pages]", mserve,
                              m_weight_bytes),
                             (" [qwen3-moe-30b-a3b int8 pages]", mserve8,
                              m_weight_bytes),
                             (" [gemma2-27b bf16 pages]", gserve,
                              g_weight_bytes),
                             *((f" [{a} bf16 pages]", r, r["weight_bytes"])
                               for a, r in dense_e2e.items())):
        rec = {k_: v for k_, v in rec.items()
               if k_ not in ("tokens", "launches")}
        log(f"e2e-record{tag}: "
            f"{json.dumps(dict(rec, weight_bytes=nbytes))}")
    log(f"cpu cross-check [qwen3-14b, 2-layer cut]: {json.dumps(qx)}")
    log(f"cpu cross-check [qwen3-moe-30b-a3b, 2-layer cut]: "
        f"{json.dumps(mx)}")
    log(f"cpu cross-check [gemma2-27b, 2-layer cut]: {json.dumps(gx)}")
    log("decode-record: " + json.dumps({"hymba-1.5b": hdec,
                                          "xlstm-1.3b": xdec,
                                          "llava-next-mistral-7b": ldec}))
    log("frames-mixed-record: " + json.dumps({
        "llava-next-mistral-7b forward": lfwd,
        "cpu cross-check [hubert-xlarge, 2 layers]": hux,
        "cpu cross-check [llava-next-mistral-7b, 2 layers]": lx}))
    log(f"layer-record [one-rank mesh]: {json.dumps(layer1)}")
    log(f"multi-rank-record: {json.dumps(multi)}")
    log(f"auto-record: {json.dumps(auto)}")
    log(f"mesh-record: {json.dumps(meshrec)}")
    log(f"dryrun-record: {json.dumps(dryrec)}")
    log(f"bench-record: {json.dumps(benchrec)}")
    for tag, rec, xc in (("blaze_pallas", train, xcheck),
                         ("blaze+pallas_fused", train_fused, xcheck_fused),
                         ("ep_a2a", train_a2a, None),
                         ("qwen3-14b", qtrain, xcheck_q),
                         ("qwen3-moe-30b-a3b blaze_pallas", mtrain,
                          xcheck_m),
                         ("qwen3-moe-30b-a3b blaze+pallas_fused",
                          mtrain_fused, None),
                         ("hymba-1.5b", htrain, xcheck_h),
                         ("xlstm-1.3b, 8 layers", xtrain, xcheck_x),
                         ("hubert-xlarge", hutrain, None),
                         ("llava-next-mistral-7b, 4 layers", ltrain, None)):
        rec = {k_: v for k_, v in rec.items() if k_ != "by_kernel_ms"}
        log(f"train-record [{tag}]: "
            f"{json.dumps(dict(rec, crosscheck=xc))}")
    log(f"plan-sweep-record: {json.dumps(sweep)}")
    log(f"paper-table-record: {json.dumps(paper)}")
    log(f"microbatch-record: {json.dumps(micro)}")
    log(f"checkpoint-record: {json.dumps(ckpt)}")
    log(f"sampling-record: {json.dumps(samp)}")
    log(f"prefix-record: {json.dumps(pref)}")
    log(f"backends-record: {json.dumps(backs)}")
    log("runtime-record: " + json.dumps({"mixtral-8x7b": rt_mix,
                                         "qwen3-14b": rt_qwen}))
    # every main-path build is at most N_ONE slots: one kernel launch a call
    log("build_dispatch calls a step (one kernel launch each): " + ", ".join(
        f"{tag} {rec['launches_per_step']['build_dispatch']:g}"
        for tag, rec in (("blaze_pallas", train),
                         ("blaze+pallas_fused", train_fused),
                         ("ep_a2a", train_a2a)))
        + f"; a warm Mixtral serving run {launches['build_dispatch']}")
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# -- phase 51: the bench harness (repro_torch.bench) on the card ------------

#: where phase 51 writes the suites' records (git ignores build/)
BENCH_DIR = ROOT / "build" / "bench_torch"

#: the kernels the bench's suites and paper tables must launch
BENCH_KERNELS = ("build_dispatch", "gather_gmm", "gmm_dw", "combine",
                 "fused_moe_fwd", "fused_moe_bwd", "fused_swiglu_fwd",
                 "paged_attention", "paged_attention_int8")


def bench_phase(M, dev, card) -> dict:
    """Phase 51: ``repro_torch.bench``'s kernels, memory and serving suites
    at their full sweep on the card, each record written under
    ``build/bench_torch/``; the four same-run gates (simulated against
    traced peaks within 20%, the fused path against the unfused kernels,
    the parallel ranking against the cost model, the serving pairings),
    any failure line failing the script; then ``paper_tables.run()`` at the
    paper's full Table-1 sizes.  Launches are counted from 0 over the
    whole phase; each of ``BENCH_KERNELS`` must rise."""
    from repro_torch.bench import memory as BM
    from repro_torch.bench import paper_tables as BP
    from repro_torch.bench import record as BR
    from repro_torch.bench import serving as BS
    from repro_torch.bench import timing as BT
    K = M.K
    t_phase = time.perf_counter()
    BENCH_DIR.mkdir(parents=True, exist_ok=True)
    K.reset_launches()
    records, seconds = {}, {}
    for suite, fn in (("kernels", BT.kernels_suite),
                      ("memory", BM.memory_suite),
                      ("serving", BS.serving_suite)):
        t0 = time.perf_counter()
        entries = fn(small=False, device=dev)
        records[suite] = BR.make_record(suite, entries,
                                        config={"small": False}, device=dev)
        path = BR.write_record(records[suite],
                               str(BENCH_DIR / BR.BENCH_FILES[suite]))
        seconds[suite] = time.perf_counter() - t0
        log(f"bench [{suite}]: {len(entries)} entries in "
            f"{seconds[suite]:.1f} s -> {path}")
        for e in entries:
            if e["kind"] == "time_us" or e["name"].startswith(
                    ("peak_sim/", "serving/")) or "/allocated_bytes" in \
                    e["name"]:
                log(f"bench [{suite}] {e['name']}: {e['value']:.6g} "
                    f"{e['unit']} [{card}]")
        torch.cuda.empty_cache()
    gates = {
        "sim_parity": BM.sim_parity_failures(records["memory"]["entries"]),
        "fused": BT.fused_gate_failures(records["kernels"]["entries"]),
        "parallel": BT.parallel_gate_failures(records["kernels"]["entries"]),
        "serving": BS.serving_gate_failures(records["serving"]["entries"])}
    for name, fails in gates.items():
        log(f"bench gate [{name}]: " + ("; ".join(fails) if fails else "OK"))
    check(not any(gates.values()),
          "bench: a same-run gate failed: " + "; ".join(
              line for fails in gates.values() for line in fails))
    by = {e["name"]: e["value"] for r in records.values()
          for e in r["entries"]}
    sims = sorted(n for n in by if n.startswith("peak_sim/"))
    errs = {}
    for n in sims:
        _, c, plan, mode = n.split("/")
        m = by[f"memory/{c}/{plan}/{'segment' if mode == 'single' else mode}"
               "/peak_bytes"]
        errs[n] = (by[n] - m) / m
    log("bench sim vs traced peak: " + ", ".join(
        f"{n[len('peak_sim/'):]} {100 * e:+.1f}%" for n, e in errs.items()))

    t0 = time.perf_counter()
    rows = BP.run(print_fn=lambda line: log(f"paper tables [{card}]: "
                                            f"{line}"), device=dev)
    seconds["paper_tables"] = time.perf_counter() - t0
    for name, us, derived in rows:
        log(f"paper-tables row [{card}]: {name},{us:.1f},{derived}")
    torch.cuda.synchronize()
    launches = K.launch_counts()
    for name in BENCH_KERNELS:
        check(launches.get(name, 0) > 0,
              f"bench: {name} never launched in phase 51 ({launches})")
    seconds["phase"] = time.perf_counter() - t_phase
    log(f"bench: phase 51 took {seconds['phase']:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()
                    if k != "phase") + f"); launches {launches}")
    torch.cuda.empty_cache()
    return {"seconds": seconds, "launches": launches,
            "sim_vs_traced": errs, "gates": gates,
            "paper_tables": [list(r) for r in rows],
            "records": {k: str(BENCH_DIR / BR.BENCH_FILES[k])
                        for k in records}}


# -- phases 46-49: the distribution slice: auto at the H100's constants,
#    FSDP training, a checkpoint and serving under a mesh ------------------

# Phase 46's tables: (label, mesh axes) x (label, per-rank token slab)
AUTO_MESHES = (("(data, model) = (1, 2)", {"data": 1, "model": 2}),
               ("(data, model) = (2, 2)", {"data": 2, "model": 2}),
               ("(data, node, model) = (1, 2, 2)",
                {"data": 1, "node": 2, "model": 2}))
AUTO_SLABS = (("training", TRAIN_SEQ), ("decode", 4))
# Phase 47: Mixtral-8x7B at full width, global batch 2 x 2048, three steps;
# (label, mesh sizes, names, moe_parallel, layers).  The ranks read each
# other's large tensors on the card (CUDA IPC): through host memory over
# gloo the 2-layer steps took 34-88 s on the H100 (PERF.md).
MESH_TRAIN = (("a", (2, 1), ("data", "model"), "auto", 2),
              ("b", (2, 2), ("data", "model"), "auto", 2))
MESH_TRAIN_STEPS = 3
# each rank's parameter and moment bytes against the sum of its blocks
MESH_HELD_TOL = 0.05
# Phase 49: 8 greedy requests over bf16 pages on 2 ranks (data=1, model=2)
MESH_SERVE_REQS, MESH_SERVE_NEW = 8, 16


def auto_phase(M) -> dict:
    """Phase 46: ``roofline.select_moe_parallel``'s table at the H100's
    constants for Mixtral-8x7B and Qwen3-30B-A3B on (1, 2), (2, 2) and
    (1, 2, 2) meshes at each model's training slab (2048 tokens a rank)
    and decode slab (B = 4).  Every chosen mode must be feasible.  Pure
    arithmetic: no rank, no card."""
    from repro_torch import roofline as RL
    from repro_torch.configs import get_config
    out = {}
    for arch in ("mixtral-8x7b", "qwen3-moe-30b-a3b"):
        cfg = get_config(arch)
        for mlabel, shape in AUTO_MESHES:
            mesh = SimpleNamespace(shape=shape, axis_names=tuple(shape))
            for slabel, L in AUTO_SLABS:
                dec = RL.select_moe_parallel(cfg, mesh, L)
                chosen = [c for c in dec.table if c.chosen]
                check(len(chosen) == 1 and chosen[0].feasible,
                      f"auto [{arch} {mlabel} {slabel}]: chose "
                      f"{dec.mode!r}, which is not feasible")
                rows = "; ".join(
                    f"{c.mode}{'*' if c.chosen else ''} "
                    + (f"{c.t_total_s * 1e6:.1f} us, live "
                       f"{c.live_bytes / 2 ** 20:.1f} MiB, a2a "
                       f"{c.a2a_bytes / 2 ** 20:.2f} MiB, psum "
                       f"{c.psum_bytes / 2 ** 20:.2f} MiB"
                       if c.feasible else f"infeasible ({c.why})")
                    for c in dec.table)
                log(f"auto [{arch} {mlabel}, {slabel} slab {L} tokens a "
                    f"rank, H100 constants]: {dec.mode} ({rows})")
                out[f"{arch} {mlabel} {slabel}"] = {
                    "mode": dec.mode, "tokens": L,
                    "table": dec.table_rows()}
    return out


def _block_bytes(cfg, mesh_shape, mode) -> int:
    """Bytes of one rank's float32 blocks of the parameters and both AdamW
    moments under ``param_specs(..., fsdp=True, moe_parallel=mode)`` on a
    mesh of ``mesh_shape`` (from the specs and the whole shapes, not from
    the tensors)."""
    from repro_torch import sharding as SH
    from repro_torch.interop import param_shapes
    mesh = SimpleNamespace(shape=mesh_shape, axis_names=tuple(mesh_shape))
    size = lambda ax: int(np.prod([mesh_shape[a] for a in (
        ax if isinstance(ax, tuple) else (ax,))]))
    shapes = param_shapes(cfg)
    total = 0
    for shape, spec in zip(_leaves(shapes), SH.spec_leaves(
            SH.param_specs(shapes, mesh, fsdp=True, moe_parallel=mode),
            shapes)):
        n = 1
        for dim, ax in zip(shape, spec):
            n *= dim // (size(ax) if ax else 1)
        total += n
    return 3 * 4 * total


def _checksums(t: torch.Tensor) -> tuple:
    """Exact fingerprint of a float32 leaf's bits: sums of its int32
    words, of their squares and of every 7th, in int64 (wrapping)."""
    v = t.detach().reshape(-1).view(torch.int32)
    out = [0, 0, 0]
    for i in range(0, v.numel(), 1 << 26):
        c = v[i:i + (1 << 26)].long()
        out[0] += int(c.sum())
        out[1] += int((c * c).sum())
        out[2] += int(c[(7 - i % 7) % 7::7].sum())
    return tuple(x % (1 << 64) for x in out)


def _on_card(dev, fn, default=0):
    """``fn()`` on the card; ``default`` for a CPU rehearsal."""
    return fn() if dev.type == "cuda" else default


def mesh_phases(M, dev, auto, base=None, seq: int = TRAIN_SEQ) -> dict:
    """Phases 47-49 in ranks spawned on the one card, as phase 13's (gloo
    for the handles, CUDA IPC for the tensors).

    47. FSDP training: Mixtral-8x7B at full width and ``MESH_TRAIN``'s
       depth, global batch 2 x 2048, ``blaze_pallas``, plan
       ``"none"``, three steps, on (a) 2 ranks (data=2, model=1) and (b)
       4 ranks (data=2, model=2) under ``moe_parallel="auto"``, which
       must run the mode phase 46 chose at the training slab.  Each rank's
       loss and grad norm of step 1 against this process's step without a mesh
       (MR_STEP_RTOL); after step 3 the ranks that hold the same block of a
       leaf hold it bit for bit; each rank's parameter and moment bytes
       (allocated before the first step, less the baseline) within
       MESH_HELD_TOL of its blocks' bytes under the specs.
    48. A checkpoint under (a)'s mesh after step 2: saved, restored without
       a mesh by rank 0 and held to the ranks' blocks exactly (rank 0's
       by ``torch.equal``, the others' by their bits' fingerprints),
       restored under the mesh, one step taken and held to the
       uninterrupted step 3 exactly (loss, grad norm and every leaf's
       fingerprint).
    49. Serving under a mesh: Mixtral-8x7B at full width, 2 layers, 2
       ranks (data=1, model=2), ``ep``, ``ep_a2a`` (served as ``ep``) and
       ``auto`` (resolved per slab; the engine lays the experts out for
       each mode it resolves to), MESH_SERVE_REQS greedy requests over bf16
       pages; each rank's tokens held to this process's engine without a
       mesh by ``_explain``; every rank must launch paged attention, the
       dispatch build, gather-GMM and combine.  Phase 46's decode choice
       must be ``ep``, a layout every engine made.  Prints each rank's
       warm prefill and decode seconds and its peak memory.
    A rank's failure fails the phase.  ``base`` and ``seq`` cut the model
    and the sequence for a rehearsal on the CPU."""
    import torch.multiprocessing as mp
    from repro_torch import roofline as RL
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.interop import init_params
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import init_adamw
    base = base or get_config("mixtral-8x7b").replace(
        moe_impl="blaze_pallas", use_pallas=True)
    tcfg = TrainConfig(learning_rate=1e-4, warmup_steps=2, total_steps=100,
                       batch_size=TRAIN_BATCH, seq_len=seq, seed=0)
    batch = next(make_batch_iterator(base.vocab_size, tcfg.seq_len,
                                     tcfg.batch_size, tcfg.seed))
    refs = {}
    for layers in sorted({j[4] for j in MESH_TRAIN}):
        cfg = base.replace(num_layers=layers)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev, dtype=torch.float32)
        m = make_train_step(cfg, tcfg, dev)(params, init_adamw(params),
                                            batch)[2]
        refs[layers] = {k_: float(m[k_]) for k_ in ("loss", "grad_norm")}
        del params, m
        _on_card(dev, torch.cuda.empty_cache)
    out = {"train": {}, "reference_step": refs}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        work = Path(tmp)

        def spawn(job):
            torch.save(job, work / "job.pt")
            world = int(np.prod(job["sizes"]))
            t0 = time.perf_counter()
            mp.start_processes(_mesh_rank_main, args=(world, str(work)),
                               nprocs=world, join=True,
                               start_method="spawn")
            ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
                     for r in range(world)]
            for f in work.glob("rank*.pt"):
                f.unlink()
            (work / "store").unlink(missing_ok=True)
            return ranks, time.perf_counter() - t0

        for label, sizes, names, mode, layers in MESH_TRAIN:
            cfg = base.replace(num_layers=layers, moe_parallel=mode)
            shape = dict(zip(names, sizes))
            # auto at the live per-rank slab: phase 46's training row for
            # the (2, 2) mesh (a (2, 1) mesh has no expert axis: tp)
            want_mode = RL.select_moe_parallel(cfg, SimpleNamespace(
                shape=shape, axis_names=names),
                TRAIN_BATCH // shape["data"] * seq).mode
            job = {"kind": "train", "sizes": sizes, "names": names,
                   "cfg": cfg, "tcfg": tcfg, "batch": batch,
                   "steps": MESH_TRAIN_STEPS, "ckpt": label == "a",
                   "work": str(work), "device": dev.type}
            ranks, secs = spawn(job)
            tag = (f"mesh train [{label}: {len(ranks)} ranks {shape}, "
                   f"{cfg.name} d={cfg.d_model}, {layers} layers, "
                   f"{TRAIN_BATCH} x {seq}]")
            mode_run = ranks[0]["mode"]
            check(mode_run == want_mode, f"{tag}: ran {mode_run!r}, auto "
                  f"chose {want_mode!r} in phase 46")
            want_held = _block_bytes(cfg, shape, mode_run)
            for r, res in enumerate(ranks):
                for k_, v in refs[layers].items():
                    got = res["metrics"][0][k_]
                    check(abs(got - v) <= MR_STEP_RTOL * abs(v),
                          f"{tag} rank {r}: step 1 {k_} {got} vs {v}")
                check(abs(res["held"] - want_held) <= MESH_HELD_TOL
                      * want_held, f"{tag} rank {r}: holds "
                      f"{res['held']} B of parameters and moments, its "
                      f"blocks are {want_held} B")
                for name in ("build_dispatch", "gather_gmm", "combine",
                             "gmm_dw", "flash_attention"):
                    check(res["launches"][name] > 0,
                          f"{tag} rank {r}: {name} was not launched")
            # the same block on two ranks: bit for bit after the last step
            same = 0
            for key in ranks[0]["sums"]:
                groups = {}
                for res in ranks:
                    blk, sums = res["sums"][key]
                    groups.setdefault(blk, []).append(sums)
                for sums in groups.values():
                    check(all(s == sums[0] for s in sums),
                          f"{tag}: the ranks' copies of a block of {key} "
                          "differ after the last step")
                    same += len(sums) - 1
            rec = {"mode": mode_run, "layers": layers, "seconds": secs,
                   "held_bytes": [res["held"] for res in ranks],
                   "blocks_bytes": want_held,
                   "whole_bytes": _block_bytes(cfg, {"data": 1, "model": 1},
                                               mode_run),
                   "peak_bytes": [res["peak"] for res in ranks],
                   "step_s": [res["step_s"] for res in ranks],
                   "metrics": [res["metrics"] for res in ranks],
                   "replica_pairs_equal": same,
                   "launches": [res["launches"] for res in ranks],
                   "peak_step1_bytes": [res["peak_step1"] for res in ranks],
                   "collectives": [res["collectives"] for res in ranks],
                   "transport": ranks[0]["transport"]}
            for r, res in enumerate(ranks):
                log(f"{tag} rank {r}: mode {mode_run}, holds "
                    f"{res['held'] / 2 ** 30:.3f} GiB of parameters and "
                    f"moments (its blocks {want_held / 2 ** 30:.3f} GiB, "
                    f"the whole tree {rec['whole_bytes'] / 2 ** 30:.3f} "
                    f"GiB), peak {res['peak'] / 2 ** 30:.3f} GiB, step s "
                    f"{', '.join(f'{t:.3f}' for t in res['step_s'])} over "
                    f"{res['transport']} (ranks sharing one card, not "
                    f"NCCL), step 1 loss {res['metrics'][0]['loss']:.6f} "
                    f"(no mesh {refs[layers]['loss']:.6f}), grad norm "
                    f"{res['metrics'][0]['grad_norm']:.6f} (no mesh "
                    f"{refs[layers]['grad_norm']:.6f})")
            log(f"{tag}: {same} pairs of ranks hold the same block bit for "
                "bit after the last step")
            if "ckpt" in ranks[0]:
                ck = ranks[0]["ckpt"]
                log(f"mesh checkpoint [a, after step 2]: save "
                    f"{ck['save_s']:.1f} s ({ck['bytes'] / 2 ** 30:.3f} GiB "
                    f"on disk), restored without a mesh in "
                    f"{ck['restore_whole_s']:.1f} s and equal to the "
                    f"ranks' blocks ({ck['leaves']} leaves), restored "
                    f"under the mesh in "
                    f"{max(r_['ckpt']['restore_mesh_s'] for r_ in ranks):.1f}"
                    " s; the resumed step 3 equals the uninterrupted one "
                    f"(loss {ck['resumed']['loss']:.6f})")
                rec["checkpoint"] = [r_["ckpt"] for r_ in ranks]
            out["train"][label] = rec

        # -- 49. serving ----------------------------------------------------
        scfg = base.replace(num_layers=2, dtype="bfloat16")
        rng = np.random.default_rng(49)
        prompts = [rng.integers(3, scfg.vocab_size, size=n_).astype(np.int32)
                   for n_ in rng.integers(16, 600, size=MESH_SERVE_REQS)]
        params = init_params(scfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
        eng = M.SE.ServeEngine(scfg, params, batch_slots=4, capacity=1024,
                               device=dev)
        ref_reqs = [M.SE.Request(prompt=p, max_new_tokens=MESH_SERVE_NEW,
                                 eos_id=-1) for p in prompts]
        with _Rows(M.SE) as rec_rows:
            rec_rows.watch(eng)
            eng.generate(ref_reqs)
        first = ref_reqs[0].rid
        ref_rows = {(rid_ - first, t_): v_ for (rid_, t_), v_ in
                    rec_rows.rows.items()}
        ref = [list(r.out_tokens) for r in ref_reqs]
        rids = [r.rid - first for r in ref_reqs]
        del eng, params
        _on_card(dev, torch.cuda.empty_cache)
        want_mode = auto["mixtral-8x7b (data, model) = (1, 2) decode"]["mode"]
        job = {"kind": "serve", "sizes": (1, 2), "names": ("data", "model"),
               "cfg": scfg, "prompts": prompts,
               "modes": ("ep", "ep_a2a", "auto"), "work": str(work),
               "device": dev.type}
        ranks, secs = spawn(job)
        serve = {}
        for mode in job["modes"]:
            recs = [res[mode] for res in ranks]
            tag = f"mesh serve [{mode}, 2 ranks (data=1, model=2)]"
            served = "auto" if mode == "auto" else "ep"
            check(all(r_["engine_mode"] == served for r_ in recs),
                  f"{tag}: the engine does not serve as {served!r}")
            check(want_mode == "ep", f"{tag}: auto chose {want_mode!r} at "
                  "the decode slab in phase 46, the engine serves 'ep'")
            check(all("ep" in r_["layouts"] for r_ in recs),
                  f"{tag}: the decode slab's layout 'ep' was never made")
            div = []
            for r, r_ in enumerate(recs):
                check(r_["cold_tokens"] == r_["tokens"],
                      f"{tag} rank {r}: warm tokens differ from cold ones")
                div.append(_explain(f"{tag} rank {r}", M.SM,
                                    r_["cold_tokens"], r_["rows"], ref,
                                    ref_rows, rids))
                for name in ("paged_attention", "build_dispatch",
                             "gather_gmm", "combine"):
                    check(r_["launches"][name] > 0,
                          f"{tag} rank {r}: {name} was not launched")
            serve[mode] = {
                "tokens_per_s": [r_["tokens_per_s"] for r_ in recs],
                "wall_s": [r_["wall_s"] for r_ in recs],
                "prefill_s": [r_["prefill_s"] for r_ in recs],
                "decode_s": [r_["decode_s"] for r_ in recs],
                "peak_bytes": [r_["peak_bytes"] for r_ in recs],
                "layouts": recs[0]["layouts"],
                "divergences": div, "launches": [r_["launches"]
                                                 for r_ in recs],
                "local_w1": recs[0]["local_w1"],
                "equal_to_reference": [r_["cold_tokens"] == ref
                                       for r_ in recs]}
            each = lambda key, f: ", ".join(f(v) for v in serve[mode][key])
            log(f"{tag}: tokens/s a rank "
                f"{each('tokens_per_s', lambda v: f'{v:.1f}')}"
                f" ({MESH_SERVE_REQS} requests x {MESH_SERVE_NEW} tokens, "
                f"warm, over {ranks[0]['transport']}: ranks sharing one "
                f"card, not NCCL); prefill s "
                f"{each('prefill_s', lambda v: f'{v:.4f}')}, decode s "
                f"{each('decode_s', lambda v: f'{v:.4f}')}, peak GiB "
                f"{each('peak_bytes', lambda v: f'{v / 2 ** 30:.3f}')}; "
                f"expert layouts {recs[0]['layouts']}, experts a rank "
                f"{recs[0]['local_w1']}; "
                f"tokens equal to the engine without a mesh: "
                f"{serve[mode]['equal_to_reference']}, divergences "
                f"explained by rounding: {div}")
        out["serve"] = serve
        out["serve_seconds"] = secs
    return out


def _mesh_rank_main(rank: int, world: int, workdir: str) -> None:
    """One rank of phases 47-49, spawned: the job in ``workdir/job.pt``,
    its results to ``workdir/rank<r>.pt``."""
    import os
    from datetime import timedelta
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.collectives import transport
    from repro_torch.launch.mesh import Mesh, init_distributed
    work = Path(workdir)
    job = torch.load(work / "job.pt", weights_only=False)
    dev = init_distributed(job["device"], backend="gloo",
                           init_method=f"file://{work / 'store'}",
                           timeout=timedelta(seconds=900))
    mesh = Mesh(job["sizes"], job["names"])
    fn = _mesh_train_rank if job["kind"] == "train" else _mesh_serve_rank
    out = fn(mesh, dev, job)
    out["transport"] = transport(mesh.group(mesh.axis_names), dev)
    torch.save(out, work / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def _mesh_train_rank(mesh, dev, job) -> dict:
    import torch.distributed as dist
    from repro_torch import kernels as K
    from repro_torch.core import collectives as CL
    from repro_torch import sharding as SH
    from repro_torch.interop import init_params
    from repro_torch.train.checkpointing import restore_checkpoint
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import AdamWState, init_adamw
    cfg, tcfg, batch = job["cfg"], job["tcfg"], job["batch"]
    sync = lambda: _on_card(dev, torch.cuda.synchronize)
    sync()
    base = _on_card(dev, torch.cuda.memory_allocated)
    step = make_train_step(cfg, tcfg, dev, mesh=mesh)
    specs = step.param_specs
    local = None
    for r in range(mesh.axis_size(mesh.axis_names)):
        # one rank at a time draws the whole tree and keeps its blocks
        if r == mesh.rank:
            whole = init_params(cfg, torch.Generator(device=dev).manual_seed(
                0), dev, dtype=torch.float32)
            local = SH.shard_params(whole, mesh, specs)
            del whole
            _on_card(dev, torch.cuda.empty_cache)
        dist.barrier()
    opt = init_adamw(local)
    sync()
    out = {"held": _on_card(dev, torch.cuda.memory_allocated) - base,
           "mode": step.moe_parallel, "metrics": [], "step_s": []}
    _on_card(dev, torch.cuda.reset_peak_memory_stats)
    K.reset_launches()

    def run(local, opt):
        sync()
        t0 = time.perf_counter()
        local, opt, m = step(local, opt, batch)
        m = {k_: float(v) for k_, v in m.items()}
        return local, opt, m, time.perf_counter() - t0

    ck = None
    for i in range(job["steps"]):
        with CL.recording() as coll:
            local, opt, m, secs = run(local, opt)
        if i == 0:
            # what phase 50's dry run of this step is held to
            out["collectives"] = {"counts": coll.counts(),
                                  "bytes": coll.bytes_by_kind()}
            out["peak_step1"] = _on_card(
                dev, torch.cuda.max_memory_allocated) - base
        out["metrics"].append(m)
        out["step_s"].append(secs)
        if i == 0:
            out["launches"] = K.launch_counts()
        if job["ckpt"] and i == 1:
            ck = _mesh_checkpoint(mesh, dev, job, local, opt, specs)
    out["peak"] = _on_card(dev, torch.cuda.max_memory_allocated) - base
    leaves = SH.spec_leaves(specs, local)
    out["sums"] = {}
    for (key, t), spec in zip(_paths(local).items(), leaves):
        axes = SH.split_axes(spec, mesh)
        blk = tuple(mesh.axis_index(a) for a in axes)
        out["sums"][key] = (blk, _checksums(t))
    for i, (m_, v_) in enumerate(zip(opt.mu, opt.nu)):
        blk = tuple(mesh.axis_index(a) for a in SH.split_axes(leaves[i],
                                                              mesh))
        out["sums"][f"mu/{i}"] = (blk, _checksums(m_))
        out["sums"][f"nu/{i}"] = (blk, _checksums(v_))
    if ck is not None:
        # resume from the checkpoint under the mesh: one step from step 2's
        # state must give the uninterrupted step 3
        final = {k_: s_ for k_, (_, s_) in out["sums"].items()}
        del local, opt
        _on_card(dev, torch.cuda.empty_cache)
        tmpl = ck.pop("template")
        t0 = time.perf_counter()
        _, rl, ro = restore_checkpoint(
            ck.pop("path"), tmpl, AdamWState(
                0, [_meta(t) for t in _leaves(tmpl)],
                [_meta(t) for t in _leaves(tmpl)]),
            mesh=mesh, specs=specs, device=dev)
        ck["restore_mesh_s"] = time.perf_counter() - t0
        rl, ro, m, _ = run(rl, ro)
        ck["resumed"] = m
        check(m == out["metrics"][-1], f"rank {mesh.rank}: the resumed step "
              f"3 {m} differs from the uninterrupted {out['metrics'][-1]}")
        got = {k_: _checksums(t) for k_, t in _paths(rl).items()}
        got.update({f"mu/{i}": _checksums(t) for i, t in enumerate(ro.mu)})
        got.update({f"nu/{i}": _checksums(t) for i, t in enumerate(ro.nu)})
        check(got == final, f"rank {mesh.rank}: the resumed step 3's "
              "parameters or moments differ from the uninterrupted ones")
        out["ckpt"] = ck
    return out


def _mesh_checkpoint(mesh, dev, job, local, opt, specs) -> dict:
    """Phase 48 on each rank, after step 2: save under the mesh; rank 0
    restores without a mesh and holds every leaf to the tree the ranks
    hold: its own blocks exactly (``torch.equal``), the other ranks'
    blocks by their bits' fingerprints (``_checksums``), which the ranks
    exchange instead of gathering the tree again."""
    from repro_torch import sharding as SH
    from repro_torch.train.checkpointing import (restore_checkpoint,
                                                 save_checkpoint)
    from repro_torch.train.optimizer import AdamWState
    path = f"{job['work']}/ckpt/step_2"
    t0 = time.perf_counter()
    save_checkpoint(path, 2, local, opt, mesh=mesh, specs=specs)
    rec = {"save_s": time.perf_counter() - t0, "path": path,
           "template": _map_leaves(local, _meta)}
    if mesh.rank == 0:
        rec["bytes"] = sum(f.stat().st_size for f in Path(path).iterdir())
    leaf_specs = SH.spec_leaves(specs, local)
    mine = list(_leaves(local)) + opt.mu + opt.nu
    specs3 = leaf_specs * 3
    blocks = [tuple(mesh.axis_index(a) for a in mesh.axis_names)
              for _ in mine]
    sums = [_checksums(t) for t in mine]
    every = [None] * mesh.axis_size(mesh.axis_names)
    torch.distributed.all_gather_object(every, (blocks, sums))
    t0 = time.perf_counter()
    if mesh.rank == 0:
        whole = lambda t, sp: torch.empty(
            [n * (mesh.axis_size(ax) if ax else 1)
             for n, ax in zip(t.shape, sp)], dtype=t.dtype, device="meta")
        shapes = iter([whole(t, sp) for t, sp in zip(_leaves(local),
                                                     leaf_specs)])
        tmpl = _map_leaves(local, lambda _: next(shapes))
        _, rp, ro = restore_checkpoint(path, tmpl, AdamWState(
            0, [_meta(t) for t in _leaves(tmpl)],
            [_meta(t) for t in _leaves(tmpl)]), device="cpu")
        check(ro.step == opt.step, "checkpoint: the restored step differs")
        restored = list(_leaves(rp)) + ro.mu + ro.nu
        del rp, ro
        for i, (t, sp) in enumerate(zip(restored, specs3)):
            t = t.to(dev)
            for r, (blks, sms) in enumerate(every):
                coords = dict(zip(mesh.axis_names, blks[i]))
                blk = t
                for dim, ax in enumerate(sp):
                    if ax is None or mesh.axis_size(ax) == 1:
                        continue
                    axes = ax if isinstance(ax, tuple) else (ax,)
                    idx = 0
                    for a in axes:
                        idx = idx * mesh.shape[a] + coords[a]
                    n = blk.shape[dim] // mesh.axis_size(ax)
                    blk = blk.narrow(dim, idx * n, n)
                if r == 0:
                    check(torch.equal(blk, mine[i]),
                          f"checkpoint: leaf {i} restored without a mesh "
                          "differs from rank 0's block")
                check(_checksums(blk.contiguous()) == sms[i],
                      f"checkpoint: leaf {i} restored without a mesh "
                      f"differs from rank {r}'s block")
            restored[i] = t = None
    rec["restore_whole_s"] = time.perf_counter() - t0
    rec["leaves"] = len(mine)
    torch.distributed.barrier()     # step 3 starts on every rank at once
    return rec


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _paths(v, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _paths(v, f"{prefix}{i}/").items()}
    return {prefix.rstrip("/"): tree}


def _meta(t: torch.Tensor) -> torch.Tensor:
    """A storage-free stand-in of ``t`` (a checkpoint template)."""
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _mesh_serve_rank(mesh, dev, job) -> dict:
    """Phase 49 on one rank: the engine under the mesh for each mode, a
    recorded cold run (the logits rows kept) and a warm timed one."""
    from repro_torch import kernels as K
    from repro_torch.interop import init_params
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as SE
    cfg = job["cfg"]
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    out = {}
    for mode in job["modes"]:
        _on_card(dev, torch.cuda.reset_peak_memory_stats)
        eng = SE.ServeEngine(cfg.replace(moe_parallel=mode), params,
                             batch_slots=4, capacity=1024, device=dev,
                             mesh=mesh)
        reqs = lambda: [SE.Request(prompt=p, max_new_tokens=MESH_SERVE_NEW,
                                   eos_id=-1) for p in job["prompts"]]
        cold = reqs()
        with _Rows(SE) as rec_rows:
            rec_rows.watch(eng)
            eng.generate(cold)
        warm = reqs()
        K.reset_launches()
        phase_s = {"prefill": 0.0, "decode": 0.0}

        def timed(kind, fn):
            def run(*a, **kw):
                _on_card(dev, torch.cuda.synchronize)
                t0 = time.perf_counter()
                y = fn(*a, **kw)
                _on_card(dev, torch.cuda.synchronize)
                phase_s[kind] += time.perf_counter() - t0
                return y
            return run

        real = T.prefill, T.paged_decode_step
        T.prefill = timed("prefill", real[0])
        T.paged_decode_step = timed("decode", real[1])
        try:
            _on_card(dev, torch.cuda.synchronize)
            t0 = time.perf_counter()
            eng.generate(warm)
            _on_card(dev, torch.cuda.synchronize)
            wall = time.perf_counter() - t0
        finally:
            T.prefill, T.paged_decode_step = real
        # the recorded rows by (rid, token index), relabelled to the rids
        # the reference run gave the same requests (0, 1, ...)
        first = cold[0].rid
        out[mode] = {
            "engine_mode": eng.cfg.moe_parallel,
            "cold_tokens": [list(r.out_tokens) for r in cold],
            "tokens": [list(r.out_tokens) for r in warm],
            "rows": {(rid - first, t): v for (rid, t), v in
                     rec_rows.rows.items()},
            "launches": K.launch_counts(), "wall_s": wall,
            "tokens_per_s": sum(len(r.out_tokens) for r in warm) / wall,
            "prefill_s": phase_s["prefill"], "decode_s": phase_s["decode"],
            "peak_bytes": _on_card(dev, torch.cuda.max_memory_allocated),
            "layouts": sorted(eng._layouts),
            "local_w1": tuple(eng.params["layers"][0]["moe"]["w1"].shape)}
        del eng
        _on_card(dev, torch.cuda.empty_cache)
    return out


# -- phase 50: the dry run, held to the card -------------------------------

# a predicted peak within this share of the measured one
DRYRUN_PEAK_TOL = 0.10
# (c): launch.dryrun on the production mesh (16, 16), a process each
DRYRUN_PROD = (("mixtral_8x7b", "train_4k"), ("qwen3_moe_30b_a3b", "train_4k"))
# what phase 50 waits for them beyond (a) and (b)
DRYRUN_PROD_WAIT = 300


def dryrun_start(work: Path) -> list:
    """Start phase 50 (c): ``python -m repro_torch.launch.dryrun`` for each
    pair of DRYRUN_PROD (rank 0 of (16, 16) on fake CUDA tensors), in
    processes of their own at a lower priority, each writing its record
    to ``work``.  A trace takes one host core for minutes and touches no
    device memory, so the smoke starts them after the build and collects
    them in phase 50; they are killed when this process exits."""
    import atexit
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape in DRYRUN_PROD:
        out = work / f"{arch}.{shape}.jsonl"
        err = open(work / f"{arch}.{shape}.log", "w")
        procs.append((arch, shape, out, err, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", str(out)], env=env,
            stdout=err, stderr=subprocess.STDOUT, cwd=str(ROOT),
            preexec_fn=lambda: os.nice(10))))
    atexit.register(dryrun_stop, procs)
    return procs


def dryrun_stop(procs) -> None:
    """Kill phase 50 (c)'s processes that still run."""
    for *_, err, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()


def _dry_vs(tag, dry, peak, launches=None, coll=None, held=None,
            batch_bytes=0) -> dict:
    """Hold one dry-run trace (``train.loop.compiled_step_memory``) to a
    measured step: its peak within DRYRUN_PEAK_TOL of ``peak``, its
    launches per kernel equal to ``launches``, its collectives per kind
    equal to ``coll``, its held bytes (arguments less the batch) equal to
    ``held``."""
    got_l = {k_: v["launches"] for k_, v in dry["kernels"].items()}
    err = abs(dry["peak_bytes"] - peak) / peak
    log(f"dryrun {tag}: predicted peak {dry['peak_bytes'] / 2 ** 30:.3f} "
        f"GiB (arg {dry['arg_bytes'] / 2 ** 30:.3f}, temp "
        f"{dry['temp_bytes'] / 2 ** 30:.3f}, alias "
        f"{dry['alias_bytes'] / 2 ** 30:.3f}), measured "
        f"{peak / 2 ** 30:.3f} GiB ({100 * err:.2f}% off); launches "
        f"{got_l}; collectives {dry['collective_counts']} "
        f"{dry['collective_bytes_by_kind']}; {dry['flops']:.4e} FLOP, "
        f"{dry['bytes_accessed']:.4e} B accessed; traced in "
        f"{dry['trace_s']:.1f} s")
    check(err <= DRYRUN_PEAK_TOL, f"dryrun {tag}: predicted peak "
          f"{dry['peak_bytes']} B is {100 * err:.2f}% off the measured "
          f"{peak} B")
    if launches is not None:
        want = {k_: int(v) for k_, v in launches.items() if v}
        check(got_l == want, f"dryrun {tag}: launches {got_l}, the step "
              f"launched {want}")
    if coll is not None:
        check(dry["collective_counts"] == coll["counts"]
              and dry["collective_bytes_by_kind"] == coll["bytes"],
              f"dryrun {tag}: collectives {dry['collective_counts']} "
              f"{dry['collective_bytes_by_kind']}, rank 0 called {coll}")
    if held is not None:
        got = dry["arg_bytes"] - batch_bytes
        log(f"dryrun {tag}: holds {got} B of parameters and moments, "
            f"its blocks are {held} B")
        check(got == held, f"dryrun {tag}: holds {got} B, its blocks are "
              f"{held} B")
    return {"peak_pred": dry["peak_bytes"], "peak_meas": peak,
            "peak_err": err, **{k_: v for k_, v in dry.items()
                                if k_ != "kernels"},
            "launches": got_l}


def dryrun_phase(dev, train, train_cfg, meshrec, procs) -> dict:
    """Phase 50: the dry run (``launch/dryrun.py``: fake CUDA tensors
    through the kernel wrappers, shape-only collectives) held to what the
    card measured.

    (a) ``compiled_step_memory`` of phase 7's step: its peak within
        DRYRUN_PEAK_TOL of phase 7's ``max_memory_allocated``, its
        launches per kernel equal to the warm steps' per step;
    (b) the same on ``DryMesh`` rank 0 of phase 47's (2, 1) and (2, 2)
        meshes: its parameter and moment bytes equal to ``_block_bytes``,
        its peak within DRYRUN_PEAK_TOL of rank 0's step-1 peak, its
        collectives per kind equal to what rank 0 called in step 1;
    (c) ``run_one`` on (16, 16) for DRYRUN_PROD, started by
        :func:`dryrun_start` after the build: a one-line summary each,
        status OK.
    Kills (c)'s processes if anything fails."""
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.mesh import DryMesh
    from repro_torch.train.loop import compiled_step_memory
    tcfg = TrainConfig(learning_rate=1e-4, warmup_steps=2, total_steps=100,
                       batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=0)
    out = {"train": {}, "mesh": {}, "production": {}}
    try:
        dry = compiled_step_memory(train_cfg, tcfg, device=dev)
        out["train"] = _dry_vs(
            "[phase 7's step, blaze_pallas, 2 layers]", dry,
            train["peak_bytes"], launches=train["launches_per_step"])
        for label, sizes, names, mode, layers in MESH_TRAIN:
            cfg = train_cfg.replace(num_layers=layers, moe_parallel=mode)
            rec = meshrec["train"][label]
            shape = dict(zip(names, sizes))
            mesh = DryMesh(sizes, names, rank=0)
            dry = compiled_step_memory(cfg, tcfg, mesh=mesh, device=dev)
            n_dp = int(np.prod([shape[a] for a in names if a == "data"]))
            out["mesh"][label] = _dry_vs(
                f"[phase 47 {label}: {shape}, rank 0]", dry,
                rec["peak_step1_bytes"][0], launches=rec["launches"][0],
                coll=rec["collectives"][0],
                held=_block_bytes(cfg, shape, rec["mode"]),
                batch_bytes=2 * 4 * TRAIN_BATCH // n_dp * TRAIN_SEQ)
        t0 = time.perf_counter()
        for arch, shape, path, err, proc in procs:
            left = DRYRUN_PROD_WAIT - (time.perf_counter() - t0)
            rc = proc.wait(timeout=max(left, 1))
            err.close()
            check(rc == 0, f"dryrun [{arch} x {shape} x 16x16]: exit "
                  f"{rc}: {Path(err.name).read_text()[-2000:]}")
            r = json.loads(path.read_text().splitlines()[-1])
            check(r["status"] == "OK", f"dryrun [{arch} x {shape}]: "
                  f"{r['status']}")
            log(f"dryrun [{arch} x {shape} x {r['mesh']}, rank 0, fake "
                f"CUDA]: moe_parallel {r.get('moe_parallel')}, plan "
                f"{r['remat_plan']}, peak {r['peak_bytes'] / 2 ** 30:.3f} "
                f"GiB (arg {r['arg_bytes'] / 2 ** 30:.3f}, temp "
                f"{r['temp_bytes'] / 2 ** 30:.3f}), fits {r['fits_hbm']}, "
                f"simulated {r['peak_sim_bytes'] / 2 ** 30:.3f} GiB; "
                f"{r['flops_per_dev']:.4e} FLOP/dev, "
                f"{r['collective_bytes'] / 2 ** 20:.1f} MiB of collectives "
                f"{r['collective_counts']}; t compute "
                f"{r['t_compute_s']:.4f} s, memory {r['t_memory_s']:.4f} "
                f"s, collective {r['t_collective_s']:.4f} s: "
                f"{r['dominant']}; traced in {r['trace_s']} s")
            out["production"][f"{arch} x {shape}"] = r
    finally:
        dryrun_stop(procs)
    return out


def serving_phase(M, cfg, params, prompts, dev, required, tag,
                  kv_dtype=None, traced=True, slots=4, capacity=1024,
                  max_new=16) -> dict:
    """Phases 5, 16, 24, 37 and 38: ``prompts`` (``max_new`` new tokens
    each) served by the port's engine on ``slots`` slots (``capacity``
    positions, 16-token pages) three times: cold, then warm (measured:
    every kernel in ``required`` must be launched during this run), then
    traced with torch.profiler over device activity (device time by
    kernel, device busy share); all three must give the same tokens.
    Without ``traced`` the third run is left out.  Returns the
    measurements."""
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
        eng = SE.ServeEngine(cfg, params, batch_slots=slots,
                             capacity=capacity, page_size=16,
                             kv_dtype=kv_dtype, device=dev)
        reqs = [SE.Request(prompt=p, max_new_tokens=max_new,
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
        check(len(r.out_tokens) == max_new and r.finish_reason == "length",
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
    tokens = [r.out_tokens for r in reqs]
    check(tokens == [r.out_tokens for r in reqs_cold],
          "repeat runs gave other tokens")
    traced_wall = busy = None
    if traced:
        # A third run is traced with torch.profiler: device time by kernel
        # and the device's busy share of the run's wall time.  Device
        # activity alone: the same kernel times as with host activity, a
        # traced wall near the untraced one, and a trace read in about 40%
        # of the time (Qwen3-14B: 24.7 s against 60.1 s).
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, reqs2 = serve()
            torch.cuda.synchronize()
            traced_wall = time.perf_counter() - t0
        del _
        check(tokens == [r.out_tokens for r in reqs2],
              "repeat runs gave other tokens")
        t0 = time.perf_counter()
        by_kernel = _device_time_by_kernel(prof)
        busy = sum(by_kernel.values()) / 1e6
        log(f"trace{tag} (third run, profiler on): wall {traced_wall:.4f} "
            f"s, device busy {busy:.4f} s ({100 * busy / traced_wall:.1f}%);"
            f" trace read in {time.perf_counter() - t0:.1f} s")

        for name, us in sorted(by_kernel.items(),
                               key=lambda kv: -kv[1])[:15]:
            log(f"  {us / 1e3:10.3f} ms  {name[:110]}")
    log(f"e2e{tag}: cold, warm{' and traced' if traced else ''} runs gave "
        "identical tokens")
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

    def case(name, L, w1_, w2_, draw=randn):
        dt = w1_.dtype
        x = draw(L, w1_.shape[0], dtype=dt)
        dy = draw(L, w1_.shape[1], dtype=dt)
        got = list(KS.fused_swiglu_fwd(x, w1_, w2_))
        want = list(KS.fused_swiglu_fwd_plain(x, w1_, w2_))
        # the forward's split plan sums its pieces in a fixed order
        check(all(torch.equal(g_, r_) for g_, r_ in zip(
            got, KS.fused_swiglu_fwd(x, w1_, w2_))),
            f"fused_swiglu {name}: repeated forward not bit-equal")
        a, b = got[1], got[2]
        got.append(KS.fused_swiglu_bwd_x(dy, a, b, w1_, w2_))
        want.append(KS.fused_swiglu_bwd_x_plain(dy, a, b, w1_, w2_))
        got += KS.fused_swiglu_bwd_w(x, dy, a, b)
        want += KS.fused_swiglu_bwd_w_plain(x, dy, a, b)
        rel = []
        for key, out, g_, w_ in zip(names, ("y", "a", "b", "dx", "dw1",
                                            "dw2"), got, want):
            scale = float(w_.float().abs().max()) if w_.numel() else 0.0
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
    # the small-L cases draw from their own generator, so later phases'
    # inputs match the runs before these cases were added
    g_small = np.random.default_rng(5)

    def draw(*shape, dtype=BF16):
        return torch.from_numpy(g_small.standard_normal(shape).astype(
            np.float32)).to(w1.device, dtype)

    case("decode L=1", 1, w1, w2, draw)
    case("L=64: the second warpgroup without rows", 64, w1, w2, draw)
    case("L=65: one row for it", 65, w1, w2, draw)
    case("L=129: a second row tile of one row", 129, w1, w2, draw)
    case("d=0: no contraction", 4, w1[:0], w2[:0], draw)
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
    rows = swiglu_rows(M, timer, entry, qz["w1"], qz["w2"], randn,
                       (("training", 4096), ("prefill", 2048),
                        ("decode", 4)))
    rows["paged_attention_int8"] = []
    q, kq, vq, ks, vs, table, pos = qz["paged"]
    rows["paged_attention_int8"].append(paged_row(
        M, timer, entry, q, (kq, vq, ks, vs), table, pos, 0,
        f"decode: B={q.shape[0]}, Hq={q.shape[2]}, Hkv={kq.shape[2]}, "
        f"Dh={q.shape[3]}, int8 pages of {kq.shape[1]}, positions "
        f"{pos.tolist()}"))
    return rows


def swiglu_rows(M, timer, entry, w1, w2, randn, shapes, tag="") -> dict:
    """The fused-SwiGLU kernels' timing rows at (label, L) ``shapes`` for
    weights w1, w2 (d, h): each beside its plain version, its bound and
    ``torch.matmul`` of its products with w1 | w2 concatenated."""
    KS = M.KS
    d, h = w1.shape
    w12 = torch.cat([w1, w2], dim=1)                       # (d, 2h)
    rows = {n: [] for n in ("fused_swiglu_fwd", "fused_swiglu_bwd_x",
                            "fused_swiglu_bwd_w")}
    for label, L in shapes:
        x, dy = randn(L, d), randn(L, h)
        _, a, b = KS.fused_swiglu_fwd(x, w1, w2)
        dadb = torch.cat(KS.swiglu_grads(dy, a, b, BF16), dim=1)
        ops = 4.0 * L * d * h
        reps = 3 if L > 4 else 5
        shape = f"{tag}{label}: L={L}, d={d}, h={h}"
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
    return rows


def gmm_row(M, timer, entry, x, disp, w1, w2, idx, shape, plain_reps,
            save_ab=False, trans_w=False) -> dict:
    """Phase 4's row for one gather-GMM call: the kernel, its plain
    version (``plain_reps`` runs) and the library yardstick; bytes: x's
    rows, the slot ids, the offsets, the live experts' weights and the
    outputs; operations: 2 d h a routed slot and weight."""
    off = disp.expert_token_offsets
    S, lens = disp.num_slots, disp.expert_lengths.tolist()
    live = sum(1 for n in lens if n)
    nw = 2 if w2 is not None else 1
    d_in, h_out = ((w1.shape[2], w1.shape[1]) if trans_w
                   else (w1.shape[1], w1.shape[2]))
    nbytes = (x.shape[0] * d_in * EB + (S * 4 if idx is not None else 0)
              + (len(lens) + 1) * 4 + live * d_in * h_out * EB * nw
              + (3 if save_ab else 1) * S * h_out * EB)
    ops = 2.0 * sum(lens) * d_in * h_out * nw
    kw = dict(save_ab=save_ab, trans_w=trans_w)
    return entry(
        timer(lambda: M.KG.gather_gmm(x, idx, off, w1, w2, **kw)),
        timer(lambda: M.KG.gather_gmm_plain(x, idx, off, w1, w2, **kw),
              warm=1 if plain_reps < 3 else 2, reps=plain_reps),
        nbytes, ops, library_gmm_ms(timer, x, idx, off, w1, w2, trans_w),
        shape)


def combine_row(M, timer, entry, p, disp, g, shape) -> dict:
    """Phase 4's row for the combine: each partial read once, the slot ids
    and gates, each token's output written once."""
    tim = disp.token_index_map
    L, k = tim.shape
    d = p.shape[1]
    return entry(timer(lambda: M.KC.combine(p, tim, g)),
                 timer(lambda: M.KC.combine_plain(p, tim, g)),
                 p.numel() * EB + L * k * (4 + EB) + L * d * EB,
                 2.0 * L * k * d, None, shape)


def gmm_dw_row(M, timer, entry, lhs, dout, disp, shape) -> dict:
    """Phase 4's row for the grouped weight gradient; library: one
    ``torch._grouped_mm`` over lhs transposed."""
    off = disp.expert_token_offsets
    ends = off[1:].contiguous()
    E = off.shape[0] - 1
    d_in, h_out = lhs.shape[1], dout.shape[1]
    lhs_t = lhs.t()
    return entry(
        timer(lambda: M.KW.gmm_dw(lhs, dout, off)),
        timer(lambda: M.KW.gmm_dw_plain(lhs, dout, off), warm=1, reps=3),
        (lhs.numel() + dout.numel() + E * d_in * h_out) * EB + (E + 1) * 4,
        2.0 * sum(disp.expert_lengths.tolist()) * d_in * h_out,
        timer(lambda: torch._grouped_mm(lhs_t, dout, offs=ends)), shape)


def flash_row(M, timer, entry, q, k, v, window, shape, cap=0.0,
              causal=True) -> dict:
    """Phase 4's row for the flash-attention forward, causal unless
    ``causal`` is False (no window then): operations 4 B H Dh a live
    (query, key) pair, over the bf16 tensor-core peak or, for float32
    inputs, the float32 rate; bytes each input read and the output
    written once at the inputs' element size; library: SDPA on the same
    dtype (with a boolean causal-window mask where the window is shorter
    than the sequence; none with a softcap, which SDPA does not
    compute)."""
    B, T_, H, Dh = q.shape
    pairs = (T_ * T_ if not causal else
             sum(min(t + 1, window) if window else t + 1 for t in range(T_)))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = None
    if not cap and (not window or window >= T_):
        library = timer(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                     enable_gqa=True))
    elif not cap:
        i = torch.arange(T_, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        library = timer(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                     enable_gqa=True))
    return entry(
        timer(lambda: M.KF.flash_attention(q, k, v, causal=causal,
                                           window=window, cap=cap)),
        timer(lambda: M.KF.flash_attention_plain(q, k, v, causal=causal,
                                                 window=window, cap=cap,
                                                 chunk=512),
              warm=1, reps=3),
        (2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
        4.0 * B * H * Dh * pairs, library, shape,
        ops_per_s=F32_OPS_PER_S if q.dtype == torch.float32
        else BF16_OPS_PER_S)


def paged_row(M, timer, entry, q, pages, table, pos, window, shape,
              cap=0.0) -> dict:
    """Phase 4's row for paged decode attention over model-dtype pages
    ``(k, v)`` or int8 pages ``(kq, vq, ks, vs)``: bytes are q read and
    the output written, each live position's k and v (values and int8
    scales) and each live page's id; library: SDPA over the pages gathered
    (and dequantized) beforehand to a dense (B, Hkv, T, Dh) view, masked
    to each request's live window."""
    int8 = len(pages) == 4
    kernel, plain = ((M.KP.paged_attention_int8, M.KP.paged_attention_int8_plain)
                     if int8 else (M.KP.paged_attention,
                                   M.KP.paged_attention_plain))
    B, _, Hq, Dh = q.shape
    ps, Hkv = pages[0].shape[1], pages[0].shape[2]
    live = [min(int(p_) + 1, window) if window else int(p_) + 1
            for p_ in pos.tolist()]
    per_pos = (Dh + 2) if int8 else Dh * EB
    nbytes = (2 * q.numel() * EB + sum(live) * Hkv * 2 * per_pos
              + sum(-(-n // ps) for n in live) * 4 + 4 * B)
    T_all = table.shape[1] * ps
    pt = table.long()
    kd, vd = ((M.KQ.dequantize(pages[0][pt], pages[2][pt], BF16),
               M.KQ.dequantize(pages[1][pt], pages[3][pt], BF16)) if int8
              else (pages[0][pt], pages[1][pt]))
    kd, vd = (t.reshape(B, T_all, Hkv, Dh).transpose(1, 2) for t in (kd, vd))
    t_ids = torch.arange(T_all, device=q.device)[None, :]
    mask = t_ids <= pos[:, None].long()
    if window:
        mask &= t_ids > pos[:, None].long() - window
    qd = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = None if cap else timer(lambda: sdpa(
        qd, kd, vd, attn_mask=mask[:, None, None, :], enable_gqa=True))
    return entry(
        timer(lambda: kernel(q, *pages, table, pos, window=window, cap=cap)),
        timer(lambda: plain(q, *pages, table, pos, window=window, cap=cap)),
        nbytes, 4.0 * sum(live) * Hq * Dh, library,
        shape, launches=2, dependent=True)   # split walk + merge


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
        tim = disp.token_index_map
        got = [KFM.fused_moe_fwd(x, g_slot, idx, off, *ws, tim)]
        want = [KFM.fused_moe_fwd_plain(x, g_slot, idx, off, *ws)]
        got += KFM.fused_moe_bwd(x, dy, g_slot, idx, off, *ws, tim)
        want += KFM.fused_moe_bwd_plain(x, dy, g_slot, idx, off, *ws)
        if x.dtype == BF16:
            # one writer per element of every output (C9)
            again = [KFM.fused_moe_fwd(x, g_slot, idx, off, *ws, tim),
                     *KFM.fused_moe_bwd(x, dy, g_slot, idx, off, *ws, tim)]
            for out, g_, a_ in zip(("y", "dx", "dgates", "dw1", "dw2",
                                    "dw3"), got, again):
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
            + ("; repeated forward and backward bit-equal"
               if x.dtype == BF16 else ""))
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
        # kernel launches a call: 2 an h-range and the slot sum forward, 4
        # a range, the dgates sum and the slot sum backward
        n_fwd = len(KFM.h_ranges(h, KFM.pass_width(S, h)))
        n_bwd = len(KFM.h_ranges(h, KFM.bwd_pass_width(S, h)))
        tim = disp.token_index_map
        rows["fused_moe_fwd"].append(entry(
            timer(lambda: KFM.fused_moe_fwd(x, g, idx, off, w1, w2, w3,
                                            tim)),
            timer(lambda: KFM.fused_moe_fwd_plain(x, g, idx, off, w1, w2,
                                                  w3), warm=1,
                  reps=plain_reps),
            L * d * EB + meta + wbytes + L * d * 4, 6.0 * n * d * h,
            timer(lib_fwd), shape + " (library: 2 grouped_mm, composition)",
            launches=2 * n_fwd + 1))
        rows["fused_moe_bwd"].append(entry(
            timer(lambda: KFM.fused_moe_bwd(x, dy, g, idx, off, w1, w2, w3,
                                            tim)),
            timer(lambda: KFM.fused_moe_bwd_plain(x, dy, g, idx, off, w1,
                                                  w2, w3), warm=1,
                  reps=plain_reps),
            2 * L * d * EB + meta + wbytes + L * d * 4 + S * 4
            + 3 * E * d * h * 4, 16.0 * n * d * h,
            timer(lib_bwd), shape + " (library: 6 grouped_mm, composition)",
            launches=4 * n_bwd + 2))
        del xg, dyg, ab, y_swi, dadb, da, db
    return rows


def train_kernel_timing(M, timer, entry, tr, disp_tr):
    """Phase 4, training kernels at the training shapes: the grouped
    weight gradient (dw1 and dw3) and the flash-attention forward, each
    beside its plain version, its bound and its library yardstick."""
    S, E = disp_tr.num_slots, disp_tr.expert_lengths.numel()
    rows = {"gmm_dw": [
        gmm_dw_row(M, timer, entry, lhs, dout, disp_tr,
                   f"training {name}: S={S}, {lhs.shape[1]}x{dout.shape[1]}"
                   f" per expert, E={E}")
        for name, lhs, dout in (("dw1", tr["xg"], tr["da"]),
                                ("dw3", tr["y_swi"], tr["dyg"]))]}
    # Mixtral's training shape (32/8 heads), then Qwen3-14B's (40/8)
    rows["flash_attention"] = [
        flash_row(M, timer, entry, q, tr["k"], tr["v"], 4096,
                  f"training {model}: B={q.shape[0]}, S={q.shape[1]}, "
                  f"{q.shape[2]}/{tr['k'].shape[2]} heads of {q.shape[3]}, "
                  "causal")
        for q, model in ((tr["q"], "mixtral-8x7b"),
                         (tr["q40"], "qwen3-14b"))]
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
            ys.append(MB._blaze(xc, gates.reshape(Lc, k).to(xc.dtype),
                                disp, p, cfg, rb))
    return torch.cat(ys).reshape(x.shape), dropped / float(n * Lc * k)


def multi_rank_phase(M, dev) -> dict:
    """Phase 13: several ranks share the one card (gloo for the handles,
    CUDA IPC for the tensors) at a reduced width (MR_WIDTHS; 1024 tokens
    per rank, bf16, ``blaze`` on ``pallas``): 2 ranks (data=1, model=2) run
    ``ep``, ``ep_a2a`` (one and two chunks), ``tp`` and ``ep_a2a`` at
    capacity 0.25; 4 ranks (data=1, node=2, model=2) run ``ep_a2a_hier``;
    4 ranks (data=2, model=2) run one ``ep_a2a`` training step.  Every
    rank holds its output rows and gradients against this process's layer
    without a mesh (LAYER_MESH_TOL), the output at capacity 0.25 against
    this process's layer with the slots a plain pack drops given gate 0
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
                whole = SH.gather_params({"moe": grads}, mesh, SH.moe_specs(
                    {"moe": grads}, mesh, mode))["moe"]
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
        local = SH.shard_params(params, mesh, step.param_specs)
        del params
        _, _, m = step(local, init_adamw(local), job["batch"])
        out["train"] = {k_: float(v) for k_, v in m.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["gather_rows_launches"] = K.launch_counts()["gather_rows"]
    torch.save(out, work / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def training_phase(cfg, dev, K, required, tag, mesh=None, per_step=None,
                   steps_warm=5, spans=True, seq=TRAIN_SEQ):
    """Phases 7, 8, 12, 18, 34, 36, 42 and 45: a training step at full
    width through ``make_train_step`` (on ``mesh``'s ranks when given), on
    TRAIN_BATCH x ``seq`` batches of the config's input kind (the
    pipeline's packed tokens, or ``synthesize_batch``'s frames or image
    embeddings and tokens, seed 0 onwards); every kernel in ``required``
    must be launched during the ``steps_warm`` warm steps, and each kernel
    in ``per_step`` exactly that many times a step.  The traced step
    records host activity too, for the step's named spans, unless
    ``spans`` is False (device activity only: a model of many small ops,
    whose host trace takes a minute to read).  Returns the
    measurements."""
    from repro_torch import sharding as SH
    from repro_torch.configs import TrainConfig
    from repro_torch.data.pipeline import (make_batch_iterator,
                                           synthesize_batch)
    from repro_torch.interop import init_params
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import init_adamw
    tcfg = TrainConfig(learning_rate=1e-4, warmup_steps=2, total_steps=100,
                       batch_size=TRAIN_BATCH, seq_len=seq, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev, dtype=torch.float32)
    step_fn = make_train_step(cfg, tcfg, dev, mesh=mesh)
    if mesh is not None:
        params = SH.shard_params(params, mesh, step_fn.param_specs)
    opt = init_adamw(params)
    n_params = sum(t.numel() for t in _leaves(params))
    if cfg.input_kind == "tokens":
        batches = make_batch_iterator(cfg.vocab_size, tcfg.seq_len,
                                      tcfg.batch_size, tcfg.seed)
    else:
        batches = (synthesize_batch(cfg, tcfg.batch_size, tcfg.seq_len,
                                    seed=i) for i in range(1000))
    tokens = tcfg.batch_size * tcfg.seq_len
    torch.cuda.synchronize()
    log(f"train [{tag}]: {cfg.name} full width, {cfg.num_layers} layers, "
        f"moe_impl={cfg.moe_impl}, gmm_backend "
        f"{step_fn.resolved_backend.name}, checkpoint plan "
        f"{step_fn.resolved_plan.spec!r} ({step_fn.resolved_plan.source}), "
        f"simulated peak {step_fn.peak_sim_bytes / 2 ** 30:.3f} GiB, "
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
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if spans else [])) as prof:
        traced = run(next(batches), "traced step")
    by_kernel = _device_time_by_kernel(prof)
    busy = sum(by_kernel.values()) / 1e6
    # The forward and optimizer spans own their kernels; the backward's run
    # on autograd's thread, so the backward is the busy time left over.
    if spans:
        spans = {ev.key: ev.device_time_total / 1e3
                 for ev in prof.key_averages()
                 if ev.key in ("train_step.forward", "train_step.optimizer")}
        spans["backward (rest)"] = busy * 1e3 - sum(spans.values())
    else:
        spans = {}
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
            "remat_plan": step_fn.resolved_plan.spec,
            "peak_sim_bytes": step_fn.peak_sim_bytes,
            "moe_parallel": step_fn.moe_parallel,
            "moe_overflow": [m_["moe_overflow"] for m_ in history]}


# The plan sweep (phase 20): (label, moe_impl, gmm_backend, plan).  The
# registry plans run on ``blaze_pallas``; the two moe-scoped specs of
# ``fit_candidates`` ask for residual sets the kernel composition cannot
# keep, so they run on ``blaze`` over ``pallas`` beside that layer's
# ``full`` (mode ab_yswi).
SWEEP = (("full", "blaze_pallas", "auto", "full"),
         ("none", "blaze_pallas", "auto", "none"),
         ("paper_min", "blaze_pallas", "auto", "paper_min"),
         ("paper", "blaze_pallas", "auto", "paper"),
         ("dots", "blaze_pallas", "auto", "dots"),
         ("ab_yswi", "blaze", "pallas", "full"),
         ("ab", "blaze", "pallas", "full;moe:recompute=ffn_yswi"),
         ("x", "blaze", "pallas", "full;moe:recompute=ffn_a,ffn_b,ffn_yswi"))


def plan_sweep_phase(dev, K, base=None, seq: int = TRAIN_SEQ) -> dict:
    """Phase 20: Mixtral-8x7B at full width, 2 layers, 2 x 2048 tokens
    (phase 7's parameters and batch) under every plan of ``SWEEP``.  For
    each: the first step's loss and gradients (``train_loss`` from the
    same weights, held to the layer's ``full``), the bytes held between
    the forward and the backward (``memory_allocated`` after the loss less
    before the forward; and ``compat.saved_residual_nbytes``), then steps
    through ``make_train_step``: the median of 3 warm steps, the peak over
    them (``max_memory_allocated``) and each kernel's launches a step,
    beside ``step_fn.peak_sim_bytes`` and ``estimate_saved_bytes``.  Then
    ``make_train_step(hbm_budget=...)`` between two candidates' simulated
    peaks (at 4 x the batch) must choose what the simulator's table says.
    ``base`` and
    ``seq`` shrink the run for a rehearsal on the CPU."""
    from repro_torch.compat import saved_residual_nbytes
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import checkpoint as CK
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.interop import init_params
    from repro_torch.models import transformer as T
    from repro_torch.train.loop import batch_to_device, make_train_step
    from repro_torch.train.optimizer import init_adamw, tree_leaves
    if base is None:
        base = get_config("mixtral-8x7b").replace(num_layers=2,
                                                  use_pallas=True)
    tcfg = TrainConfig(learning_rate=1e-4, warmup_steps=2, total_steps=100,
                       batch_size=TRAIN_BATCH, seq_len=seq, seed=0)
    n_tokens = tcfg.batch_size * tcfg.seq_len
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(base, gen, dev, dtype=torch.float32)
    leaves = tree_leaves(params)
    i_embed = next(i for i, t in enumerate(leaves) if t is params["embed"])
    batches = make_batch_iterator(base.vocab_size, tcfg.seq_len,
                                  tcfg.batch_size, tcfg.seed)
    first = batch_to_device(next(batches), dev)
    # C1: the bf16 copies of the expert weights the port makes each step
    # (the reference's simulator has no such buffer)
    c1 = (base.num_layers * 3 * base.num_experts * base.d_model
          * base.moe_d_ff * EB)
    cfgs = {label: base.replace(moe_impl=impl, gmm_backend=backend,
                                remat_policy=plan)
            for label, impl, backend, plan in SWEEP}
    rows = {label: {"plan": CK.resolve_plan(config=c.remat_policy).spec,
                    "moe_impl": c.moe_impl, "gmm_backend": c.gmm_backend,
                    "residual_mode": CK.moe_residual_mode(c)}
            for label, c in cfgs.items()}
    # 1. the first step's loss, gradients and held bytes, from the pristine
    # weights; each layer's "full" is the baseline of its group
    ref_loss, ref_grads = None, None
    for label, cfg in cfgs.items():
        if label in ("full", "ab_yswi"):
            ref_loss, ref_grads = None, None
        for t in leaves:
            t.requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        loss, _ = T.train_loss(params, first, cfg)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - before
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        fb_peak = torch.cuda.max_memory_allocated() - before
        loss = float(loss.detach())
        storages = saved_residual_nbytes(T.train_loss, params, first, cfg)
        r = rows[label]
        r.update(loss=loss, held_bytes=held, held_storage_bytes=storages,
                 fwd_bwd_peak_above_weights=fb_peak)
        if ref_grads is None:
            ref_loss, ref_grads = loss, grads
            r.update(grads_bit_equal=True, embed_grad_rel_diff=0.0)
        else:
            # Every leaf but the embedding bit-equal; the embedding's
            # gradient is the backward of a row gather, summed by atomics
            # in no fixed order (two runs of one plan differ there too):
            # STEP_RTOL over STEP_RTOL of its scale.
            equal = all(torch.equal(a, b) for i, (a, b) in
                        enumerate(zip(grads, ref_grads)) if i != i_embed)
            a, b = grads[i_embed], ref_grads[i_embed]
            scale = float(b.abs().max())
            rel = float((a - b).abs().max()) / max(scale, 1e-30)
            r.update(grads_bit_equal=equal, embed_grad_rel_diff=rel)
            check(loss == ref_loss, f"plan sweep [{label}]: first-step loss "
                  f"{loss!r} differs from its full plan's {ref_loss!r}")
            check(equal, f"plan sweep [{label}]: a gradient leaf differs "
                  "from the full plan's")
            check(bool(((a - b).abs() <= STEP_RTOL * (b.abs() + scale))
                       .all()), f"plan sweep [{label}]: the embedding's "
                  f"gradient differs from the full plan's ({rel:.3g})")
        del grads
        log(f"plan sweep [{label}: {r['plan']}, {r['moe_impl']}"
            f"{'' if r['moe_impl'] == 'blaze_pallas' else '+pallas'}, "
            f"residuals {r['residual_mode']}]: first-step loss {loss!r}; "
            f"held {held / 2 ** 30:.3f} GiB (storages "
            f"{storages / 2 ** 30:.3f} GiB); gradients bit-equal to full: "
            f"{r['grads_bit_equal']} (embedding max |diff| / scale "
            f"{r['embed_grad_rel_diff']:.3g})")
    del ref_grads
    for t in leaves:
        t.requires_grad_(False)
    torch.cuda.empty_cache()
    held = {k: v["held_bytes"] for k, v in rows.items()}
    # paper and paper_min differ only in FFN_YSWI, which no MoE block tags
    # (the expert layer keeps its own residuals), so on Mixtral they hold
    # the same bytes, as the reference's own test orders its MoE stack
    # none < paper < full only; the strict order is the dense model's
    # (dense_plan_held)
    check(held["none"] < held["paper_min"] == held["paper"] < held["full"],
          f"plan sweep: held bytes not ordered none < paper_min = paper < "
          f"full: {held}")
    check(held["x"] < held["ab"] < held["ab_yswi"],
          f"plan sweep: held bytes not ordered x < ab < ab_yswi: {held}")
    none_held = held["none"]
    # 2. steps through make_train_step (the weights move from here on)
    opt = init_adamw(params)
    for label, cfg in cfgs.items():
        step_fn = make_train_step(cfg, tcfg, dev)
        step_fn(params, opt, next(batches))              # cold
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        times = []
        for _ in range(3):
            b = next(batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, m = step_fn(params, opt, b)
            float(m["loss"])                              # waits
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        r = rows[label]
        est = CK.estimate_saved_bytes(cfg, cfg.remat_policy, n_tokens,
                                      batch=tcfg.batch_size)
        r.update(step_s=statistics.median(times), peak_bytes=peak,
                 peak_sim_bytes=step_fn.peak_sim_bytes,
                 sim_over_measured=step_fn.peak_sim_bytes / peak,
                 est_saved_bytes=est,
                 est_over_measured=(
                     est / (r["held_bytes"] - none_held)
                     if est and r["held_bytes"] > none_held else None),
                 c1_share_of_peak=c1 / peak,
                 launches_per_step={k_: v / 3 for k_, v in
                                    K.launch_counts().items() if v})
        torch.cuda.empty_cache()
    del opt
    log(f"plan sweep: {base.name} full width, {base.num_layers} layers, "
        f"{tcfg.batch_size} x {tcfg.seq_len} tokens, bf16 compute, float32 "
        f"masters; bf16 expert-weight copies (C1) {c1 / 2 ** 30:.3f} GiB")
    log(f"  {'plan':10s} {'step s':>8s} {'peak GiB':>9s} {'sim GiB':>8s} "
        f"{'sim/peak':>8s} {'held GiB':>9s} {'est GiB':>8s} {'est/d':>6s} "
        f"{'C1/peak':>7s}  launches a step")
    for label, r in rows.items():
        est = r["est_saved_bytes"]
        eo = r["est_over_measured"]
        log(f"  {label:10s} {r['step_s']:8.4f} "
            f"{r['peak_bytes'] / 2 ** 30:9.3f} "
            f"{r['peak_sim_bytes'] / 2 ** 30:8.3f} "
            f"{r['sim_over_measured']:8.3f} "
            f"{r['held_bytes'] / 2 ** 30:9.3f} "
            f"{'n/a' if est is None else f'{est / 2 ** 30:.3f}':>8s} "
            f"{'n/a' if eo is None else f'{eo:.3f}':>6s} "
            f"{r['c1_share_of_peak']:7.3f}  {r['launches_per_step']}")
    # 3. the budget fit, on the layer that can keep every candidate's
    # residual set, at 4 x the batch: at 2 x 2048 tokens every candidate's
    # simulated peak is the optimizer update's (the same for all)
    fcfg = cfgs["ab_yswi"].replace(remat_policy="none")
    ftcfg = tcfg.replace(batch_size=4 * tcfg.batch_size)
    f_tokens = ftcfg.batch_size * ftcfg.seq_len
    peaks = sorted({row.sim_peak_bytes for row in CK.CheckpointPlan.fit(
        fcfg, f_tokens, 0, batch=ftcfg.batch_size).table})
    check(len(peaks) >= 3, f"plan fit: {len(peaks)} distinct simulated peaks")
    budget = (peaks[1] + peaks[2]) // 2
    fit = CK.CheckpointPlan.fit(fcfg, f_tokens, budget,
                                batch=ftcfg.batch_size)
    step_fn = make_train_step(fcfg, ftcfg, dev, hbm_budget=budget)
    want = next(row.spec for row in fit.table if row.fits)
    log(f"plan fit: {ftcfg.batch_size} x {ftcfg.seq_len} tokens, budget "
        f"{budget / 2 ** 30:.3f} GiB (between simulated peaks "
        f"{peaks[1] / 2 ** 30:.3f} and {peaks[2] / 2 ** 30:.3f} GiB); "
        f"make_train_step chose {step_fn.resolved_plan.spec!r} "
        f"({step_fn.resolved_plan.source}); the simulator's table "
        "(cheapest recompute first):")
    for row in fit.table:
        log(f"  {row.spec:42s} sim peak {row.sim_peak_bytes / 2 ** 30:8.3f}"
            f" GiB at {row.peak_phase:22s} fits {row.fits!s:5s} chosen "
            f"{row.chosen}")
    check(step_fn.resolved_plan.source == "fit"
          and step_fn.resolved_plan.spec == want == fit.plan.spec(),
          f"plan fit: make_train_step chose {step_fn.resolved_plan.spec!r}, "
          f"the table says {want!r}")
    # The chosen plan's step is not run: at 8 x 2048 tokens it ran out of
    # the card's memory in the plain float32 attention backward, whose
    # chunked scores the simulator does not price (PERF.md §7).
    del params, leaves
    torch.cuda.empty_cache()
    return {"rows": rows, "c1_bytes": c1, "fit_budget": budget,
            "fit_choice": step_fn.resolved_plan.spec,
            "fit_tokens": f_tokens,
            "fit_peak_sim_bytes": step_fn.peak_sim_bytes,
            "fit_table": [dataclasses.asdict(row) for row in fit.table]}


def dense_plan_held(dev, base=None, seq: int = TRAIN_SEQ) -> dict:
    """Phase 20, the dense model: Qwen3-14B at full width, 4 layers, 2 x
    2048 tokens, on the plain FFN path (``use_pallas=False``: its products
    are the producers of FFN_A, FFN_B and FFN_YSWI; the fused SwiGLU keeps
    its own residuals, as in the reference), weights from seed 0: the
    bytes held between the forward and the backward under each registry
    plan, strictly ordered none < paper_min < paper < full, beside
    ``estimate_saved_bytes`` against the growth over ``none``."""
    from repro_torch.configs import get_config
    from repro_torch.core import checkpoint as CK
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.interop import init_params
    from repro_torch.models import transformer as T
    from repro_torch.train.loop import batch_to_device
    from repro_torch.train.optimizer import tree_leaves
    if base is None:
        base = get_config("qwen3-14b").replace(num_layers=4)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(base, gen, dev, dtype=torch.float32)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    batch = batch_to_device(next(make_batch_iterator(
        base.vocab_size, seq, TRAIN_BATCH, 0)), dev)
    held, est = {}, {}
    for plan in CK.plan_order():
        cfg = base.replace(remat_policy=plan)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        loss, _ = T.train_loss(params, batch, cfg)
        torch.cuda.synchronize()
        held[plan] = torch.cuda.memory_allocated() - before
        del loss
        est[plan] = CK.estimate_saved_bytes(cfg, plan, TRAIN_BATCH * seq,
                                            batch=TRAIN_BATCH)
    del params
    torch.cuda.empty_cache()
    ratio = {p: est[p] / (held[p] - held["none"]) for p in held
             if est[p] and held[p] > held["none"]}
    log(f"plan sweep [dense: {base.name}, {base.num_layers} layers, plain "
        f"FFN path, {TRAIN_BATCH} x {seq} tokens]: held GiB " + ", ".join(
            f"{p} {b / 2 ** 30:.3f}" for p, b in held.items())
        + "; estimate / growth over none " + ", ".join(
            f"{p} {r:.3f}" for p, r in ratio.items()))
    check(held["none"] < held["paper_min"] < held["paper"] < held["full"],
          f"plan sweep [dense]: held bytes not ordered none < paper_min < "
          f"paper < full: {held}")
    return {"held_bytes": held, "est_saved_bytes": est,
            "est_over_growth": ratio}


# The paper's comparison (phase 21): implementation -> (layer, backend,
# residual mode); the first four run the same hand-written grouped GEMM
# (``pallas``), the last is the library column (``torch._grouped_mm``).
PAPER_IMPLS = {"blaze": ("blaze", "pallas", "ab_yswi"),
               "blaze_min": ("blaze", "pallas", "ab"),
               "blaze_x": ("blaze", "pallas", "x"),
               "megablocks": ("megablocks", "pallas", None),
               "megablocks+ragged": ("megablocks", "ragged", None)}


def paper_table_phase(dev, table=None) -> dict:
    """Phase 21: the MoE layer alone at each of the paper's Table-1 confs
    (exact d, E, k, B·S; h = 4d), as the reference's bench defines the
    layer function (``src/repro/bench/paper_tables.py:34-49``): gating, the
    dispatch build, the layer, ``(y.float() ** 2).sum()``, forward and
    backward with respect to x and the four weights, in bf16 (the reference
    configs say float32; every other training phase and the kernels' Hopper
    paths run bf16).  Per implementation: the saved-residual bytes
    (``compat.saved_residual_nbytes``), the peak above the inputs and the
    median forward+backward time (CUDA events, 3 warm runs after one).
    ``table`` (name -> (d, E, k, B, S)) shrinks it for a rehearsal."""
    from repro_torch.compat import saved_residual_nbytes
    from repro_torch.configs.paper_tables import PAPER_TABLE1
    from repro_torch.core import routing as TR
    from repro_torch.core.baseline import moe_ffn_megablocks
    from repro_torch.core.moe_layer import moe_ffn_blaze
    from repro_torch.kernels.dispatch import build_dispatch

    def layer_fn(impl, E, k):
        layer, backend, mode = PAPER_IMPLS[impl]

        def f(x, w1, w2, w3, wg):
            g = TR.top_k_gating(x, wg, k)
            disp = build_dispatch(g.topk_experts.contiguous(), E)
            gates = g.topk_weights.to(x.dtype)
            if layer == "megablocks":
                y = moe_ffn_megablocks(x, gates, disp, w1, w3, w2,
                                       backend=backend)
            else:
                y = moe_ffn_blaze(x, gates, disp, w1, w3, w2,
                                  residuals=mode, backend=backend)
            return (y.float() ** 2).sum(), y
        return f

    out = {}
    log("paper table: dtype bfloat16 (the reference's Table-1 configs say "
        "float32); h = 4 d; the paper claims >4x speed and >50% memory "
        "saving against existing MoE frameworks (printed, not gated)")
    for name, (d, E, k, B, S) in (table or PAPER_TABLE1).items():
        L, h = B * S, 4 * d
        gen = torch.Generator(device=dev).manual_seed(0)

        def rnd(*shape, scale):
            return (torch.randn(*shape, generator=gen, device=dev)
                    * scale).to(BF16).requires_grad_()
        ins = (rnd(L, d, scale=1.0), rnd(E, d, h, scale=d ** -0.5),
               rnd(E, d, h, scale=d ** -0.5), rnd(E, h, d, scale=h ** -0.5),
               rnd(d, E, scale=d ** -0.5))
        rec, results = {}, {}
        for impl in PAPER_IMPLS:
            f = layer_fn(impl, E, k)
            loss, y = f(*ins)                        # warm: builds, caches
            grads = torch.autograd.grad(loss, ins)
            if name == "paper_conf1" and impl in ("blaze", "megablocks"):
                results[impl] = (y.detach(), grads[0])
            del loss, y, grads
            saved = saved_residual_nbytes(lambda *a: f(*a)[0], *ins)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            loss, _ = f(*ins)
            grads = torch.autograd.grad(loss, ins)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            del loss, grads
            times = []
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                loss, _ = f(*ins)
                torch.autograd.grad(loss, ins)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
                del loss
            rec[impl] = {"saved_bytes": saved, "peak_bytes": peak,
                         "ms": statistics.median(times)}
            torch.cuda.empty_cache()
        if results:
            (yb, dxb), (ym, dxm) = results["blaze"], results["megablocks"]
            e_y = _scaled_close(f"paper table {name}: y blaze vs megablocks",
                                yb, ym, *LAYER_MESH_TOL)
            e_dx = _scaled_close(f"paper table {name}: dx blaze vs "
                                 "megablocks", dxb, dxm, *LAYER_MESH_TOL)
            log(f"paper table {name}: blaze vs megablocks y max |err| / "
                f"scale {e_y:.3g}, dx {e_dx:.3g} (tol {LAYER_MESH_TOL})")
        del ins, results
        torch.cuda.empty_cache()
        sb = {i: r["saved_bytes"] for i, r in rec.items()}
        check(sb["blaze"] < sb["megablocks"],
              f"paper table {name}: blaze saves {sb['blaze']} bytes, not "
              f"fewer than megablocks' {sb['megablocks']}")
        check(sb["blaze_x"] < sb["blaze_min"] < sb["blaze"],
              f"paper table {name}: saved bytes not x < ab < ab_yswi: {sb}")
        mb, bz = rec["megablocks"], rec["blaze"]
        ratios = {"saved": mb["saved_bytes"] / bz["saved_bytes"],
                  "peak": mb["peak_bytes"] / bz["peak_bytes"],
                  "time": mb["ms"] / bz["ms"]}
        out[name] = {"d": d, "E": E, "k": k, "tokens": L, "h": h,
                     "impls": rec, "megablocks_over_blaze": ratios}
        log(f"paper table {name} (d={d}, E={E}, k={k}, B*S={L}, h={h}):")
        for impl, r in rec.items():
            log(f"  {impl:18s} saved {r['saved_bytes'] / 2 ** 30:8.3f} GiB  "
                f"peak {r['peak_bytes'] / 2 ** 30:8.3f} GiB  fwd+bwd "
                f"{r['ms']:9.3f} ms")
        log(f"  megablocks / blaze: saved {ratios['saved']:.3f}x, peak "
            f"{ratios['peak']:.3f}x, time {ratios['time']:.3f}x (paper: "
            f"time >4x; memory saving >50%, i.e. >2x)")
    return out


def cpu_train_crosscheck(dev, arch="mixtral-8x7b", far_floor=0,
                         float64_spread=False, **overrides):
    """Phases 9, 19, 26, 34 and 36: one training step of the reduced
    ``arch`` (float32) with ``overrides`` from the same weights and batch
    on the card and on the CPU.  The loss's gradients must agree leaf by
    leaf (``STEP_RTOL`` relative over ``STEP_RTOL`` of each leaf's scale,
    as ``tests/test_torch_train.py`` holds them to the reference); then
    the step's metrics and parameters as set out at ``STEP_FAR_SHARE``,
    with at least ``far_floor`` elements of each leaf allowed beyond 2e-3
    lr.  With ``float64_spread`` the CPU step is run again in float64 (the
    recurrent scans stay float32 inside), and every bound is at least
    twice the CPU float32 step's own distance from it: a gradient leaf's
    relative bound twice its largest distance / scale, the loss's twice
    its distance, grad_norm's twice the L2 norm of the gradients'
    distance (|a| - |b| <= |a - b|), the count of elements beyond 2e-3
    lr, taken over the whole model, twice its count, the parameters'
    largest distance twice theirs.  Where a
    model amplifies rounding (random-init mLSTM layers) the card's and
    the CPU's float32 steps each sit about that far from the exact one."""
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
    cpu = torch.device("cpu")
    runs = [("card", p_card, dev, cfg), ("cpu", p_cpu, cpu, cfg)]
    if float64_spread:
        runs.append(("cpu float64", _map_leaves(p_cpu, lambda t: t.double()),
                     cpu, cfg.replace(dtype="float64")))
    grads = {}
    for name, p, device, rcfg in runs:
        leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
        it = iter(leaves)
        loss, _ = T.train_loss(_map_leaves(p, lambda _: next(it)),
                               batch_to_device(batch, device), rcfg)
        grads[name] = [g.detach().cpu().double() for g in
                       torch.autograd.grad(loss, leaves)]
    alt = "cpu float64" if float64_spread else None
    grad_rel, own_rel, own_l2 = 0.0, 0.0, 0.0
    for i, (g_card, g_cpu) in enumerate(zip(grads["card"], grads["cpu"])):
        scale = max(float(g_cpu.abs().max()), 1e-30)
        own = 0.0
        if alt:
            d_own = grads[alt][i] - g_cpu
            own = float(d_own.abs().max()) / scale
            own_l2 += float((d_own ** 2).sum())
        own_rel = max(own_rel, own)
        grad_rel = max(grad_rel, float((g_card - g_cpu).abs().max()) / scale)
        rtol = max(STEP_RTOL, 2 * own)
        check(bool(((g_card - g_cpu).abs()
                    <= rtol * (g_cpu.abs() + scale)).all()),
              f"train cross-check: gradient leaf {i} {tuple(g_cpu.shape)} "
              f"differs: max |diff| / scale {grad_rel:.3g}, bound "
              f"{rtol:.3g}")
    own_l2 = own_l2 ** 0.5
    del grads
    out, params = {}, {}
    for name, p, device, rcfg in runs:
        step = make_train_step(rcfg, tcfg, device)
        _, _, m = step(p, init_adamw(p), batch)
        out[name] = {k_: float(v) for k_, v in m.items()}
        params[name] = [t.detach().cpu().double() for t in tree_leaves(p)]
    lr = tcfg.learning_rate
    worst, n_far, n_all, fixed_far = 0.0, 0, 0, 0.0
    own_worst, own_far = 0.0, 0
    for i, (a, b) in enumerate(zip(params["card"], params["cpu"])):
        err = (a - b).abs()
        worst = max(worst, float(err.max()))
        far = int((err > 2e-3 * lr).sum())
        bound = max(far_floor, STEP_FAR_SHARE * err.numel())
        if alt:
            e_alt = (params[alt][i] - b).abs()
            own_worst = max(own_worst, float(e_alt.max()))
            own_far += int((e_alt > 2e-3 * lr).sum())
        else:
            check(far <= bound, f"train cross-check: {far} of "
                  f"{err.numel()} elements of a leaf moved apart by more "
                  "than 2e-3 lr")
        fixed_far += bound
        n_far += far
        n_all += err.numel()
    # against the float64 step the count is taken over the whole model:
    # a gradient's sign at a near-zero element, which a float32 rounding
    # may flip, moves it 2 lr, and a leaf of a few elements holds too few
    # for its own count to say anything
    check(not alt or n_far <= max(fixed_far, 2 * own_far),
          f"train cross-check: {n_far} of {n_all} elements moved apart by "
          f"more than 2e-3 lr (bound {max(fixed_far, 2 * own_far):.0f})")
    own = ""
    if alt:
        own = (f"; the CPU float32 step's own distance from its float64 "
               f"step: gradients max |diff| / leaf scale {own_rel:.3g}, L2 "
               f"{own_l2:.4g}, loss "
               f"{abs(out[alt]['loss'] - out['cpu']['loss']):.4g}, "
               f"grad_norm {out[alt]['grad_norm']:.8g} against "
               f"{out['cpu']['grad_norm']:.8g}, parameters max |diff| "
               f"{own_worst:.3g}, {own_far} beyond 2e-3 lr (every bound at "
               "least twice these)")
    log(f"train cross-check {arch} {overrides} (reduced, float32, one "
        f"step): gradients max |diff| / leaf scale {grad_rel:.3g} (tol "
        f"{STEP_RTOL}); card "
        f"{out['card']} vs cpu {out['cpu']}; parameters max |diff| "
        f"{worst:.3g} (lr {lr}), {n_far} of {n_all} beyond 2e-3 lr{own}")
    for key in ("loss", "ce", "grad_norm"):
        own_key = 0.0
        if alt:
            own_key = (own_l2 if key == "grad_norm"
                       else abs(out[alt][key] - out["cpu"][key]))
        check(abs(out["card"][key] - out["cpu"][key])
              <= max(STEP_RTOL * abs(out["cpu"][key]), 2 * own_key),
              f"train cross-check: {key} differs")
    check(worst <= max(lr, 2 * own_worst), "train cross-check: a parameter "
          "moved apart by more than lr")
    return {"card": out["card"], "cpu": out["cpu"], "param_max_diff": worst,
            "param_far": n_far, "grad_max_rel_diff": grad_rel,
            "cpu_float64_spread": {
                "grad_rel": own_rel, "grad_l2": own_l2,
                "grad_norm_float64": out[alt]["grad_norm"],
                "param_max_diff": own_worst, "param_far": own_far}
            if alt else None}


# Qwen3-30B-A3B at its own shapes (phases 22-23): 128 experts, top-8, d=2048,
# expert width 768; training 2 x 2048 tokens (32,768 slots, ~256 a live
# expert), decode 4 tokens (32 slots: most experts empty); attention 32/4
# heads of 128 (a GQA group of 8, the widest the paged kernel instantiates).
MOE30_DEC = 4


def moe30_kernels(M, dev, timer, entry, errs, cfg) -> dict:
    """Phases 22-23: every kernel that the Qwen3-30B-A3B paths run, against
    its plain version at the model's shapes (each call repeated
    bit-equal where one writer owns each output element), then timed as
    phase 4.  Returns the timing rows by kernel."""
    KG, KW, KC, KF, KFM, KP, KQ, KD, TR = (M.KG, M.KW, M.KC, M.KF, M.KFM,
                                           M.KP, M.KQ, M.KD, M.TR)
    E, k, d, h = cfg.num_experts, cfg.top_k, cfg.d_model, cfg.moe_d_ff
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    tag = "qwen3-moe-30b-a3b"
    gen = torch.Generator(device=dev).manual_seed(30)

    def randn(*shape, dtype=BF16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                .mul_(scale).to(dtype))

    w1, w2 = randn(E, d, h, scale=d ** -0.5), randn(E, d, h, scale=d ** -0.5)
    w3 = randn(E, h, d, scale=h ** -0.5)
    wg = randn(d, E, scale=d ** -0.5)
    shapes = {}
    for label, L in (("training", TRAIN_BATCH * TRAIN_SEQ),
                     ("decode", MOE30_DEC)):
        x = randn(L, d)
        g = TR.top_k_gating(x, wg, k)
        topk = g.topk_experts.contiguous()
        want = TR.build_dispatch(topk, E)
        for call in ("", ", repeated"):
            disp = KD.build_dispatch(topk, E)
            for f in TR.Dispatch._fields:
                check(torch.equal(getattr(disp, f), getattr(want, f)),
                      f"dispatch [{tag} {label}]{call}: {f} differs")
        lens = disp.expert_lengths.tolist()
        shapes[label] = SimpleNamespace(
            x=x, disp=disp, gates=g.topk_weights.to(BF16),
            g_slot=slot_gates(M, x, wg, disp, k), L=L, S=disp.num_slots,
            live=sum(1 for n_ in lens if n_), lens=lens)
        log(f"parity build_dispatch [{tag} {label}: L={L}, k={k}, E={E}]: "
            f"bit-equal, repeated bit-equal; {shapes[label].live} of {E} "
            f"experts hold rows (most {max(lens)})")
    tr, dec = shapes["training"], shapes["decode"]

    def same_twice(name, fn):
        got, again = fn(), fn()
        got_t = got if isinstance(got, (tuple, list)) else (got,)
        again_t = again if isinstance(again, (tuple, list)) else (again,)
        check(all(torch.equal(a, b) for a, b in zip(got_t, again_t)),
              f"{name}: a repeated call differs")
        return got

    def close(key, name, got, want, rtol, atol):
        e = require_close(f"{name} [{tag}]", got, want, rtol, atol)
        errs[key] = max(errs[key], e)
        return e

    # gather-GMM's instantiations
    for label, sh in (("training", tr), ("decode", dec)):
        idx, off = sh.disp.expert_token_indices, sh.disp.expert_token_offsets
        kw = dict(save_ab=True) if label == "training" else {}
        got = same_twice(f"gather_gmm {label} dual",
                         lambda: KG.gather_gmm(sh.x, idx, off, w1, w2, **kw))
        want = KG.gather_gmm_plain(sh.x, idx, off, w1, w2, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for part, g_, w_ in zip(("y", "a", "b"), got, want):
            close("gather_gmm", f"gather_gmm {label} dual {part}", g_, w_,
                  GMM_RTOL, GMM_ATOL)
        sh.y_swi = got[0]
        sh.p = same_twice(f"gather_gmm {label} w3", lambda: KG.gather_gmm(
            sh.y_swi, None, off, w3, epilogue=False))
        close("gather_gmm", f"gather_gmm {label} w3 forward", sh.p,
              KG.gather_gmm_plain(sh.y_swi, None, off, w3, epilogue=False),
              GMM_RTOL, GMM_ATOL)
        del got, want
    off = tr.disp.expert_token_offsets
    tr.dyg, tr.da = randn(tr.S, d), randn(tr.S, h, scale=0.05)
    for name, rows_, w in (("w3^T", tr.dyg, w3), ("w1^T", tr.da, w1)):
        got = same_twice(f"gather_gmm {name}", lambda: KG.gather_gmm(
            rows_, None, off, w, epilogue=False, trans_w=True))
        close("gather_gmm", f"gather_gmm training {name}", got,
              KG.gather_gmm_plain(rows_, None, off, w, epilogue=False,
                                  trans_w=True), GMM_RTOL, GMM_ATOL)
    log(f"parity gather_gmm [{tag}: S={tr.S} / {dec.S}, E={E}, d={d}, "
        f"h={h}; dual + save_ab, w3 forward, w3^T, w1^T, decode dual and "
        f"w3]: max |err| {errs['gather_gmm']:.4g}, every call repeated "
        "bit-equal")

    # the grouped weight gradient
    tr.xg = tr.x[tr.disp.expert_token_indices.long()]
    for name, lhs, dout in (("dw1", tr.xg, tr.da), ("dw3", tr.y_swi, tr.dyg)):
        got = same_twice(f"gmm_dw {name}", lambda: KW.gmm_dw(lhs, dout, off))
        close("gmm_dw", f"gmm_dw training {name}", got,
              KW.gmm_dw_plain(lhs, dout, off), GMM_RTOL, GMM_ATOL)
        for ex, n_ in enumerate(tr.lens):
            check(n_ > 0 or not bool(got[ex].any()),
                  f"gmm_dw {name}: empty expert {ex} not zero")
    log(f"parity gmm_dw [{tag}: S={tr.S}, E={E}, {d}x{h} and {h}x{d}]: max "
        f"|err| {errs['gmm_dw']:.4g}, repeated bit-equal")

    # the fused pair
    ws = (w1, w2, w3)
    for label, sh in (("training", tr), ("decode", dec)):
        idx, off_ = sh.disp.expert_token_indices, sh.disp.expert_token_offsets
        sh.dy = randn(sh.L, d)
        tim = sh.disp.token_index_map
        got = [KFM.fused_moe_fwd(sh.x, sh.g_slot, idx, off_, *ws, tim)]
        check(torch.equal(got[0], KFM.fused_moe_fwd(sh.x, sh.g_slot, idx,
                                                    off_, *ws, tim)),
              f"fused_moe_fwd [{tag} {label}]: a repeated call differs")
        want = [KFM.fused_moe_fwd_plain(sh.x, sh.g_slot, idx, off_, *ws)]
        # one writer per element of every output (C9)
        bwd = [KFM.fused_moe_bwd(sh.x, sh.dy, sh.g_slot, idx, off_, *ws, tim)
               for _ in range(2)]
        check(all(torch.equal(a, b) for a, b in zip(bwd[0], bwd[1])),
              f"fused_moe_bwd [{tag} {label}]: a repeated call differs")
        got += bwd[0]
        want += KFM.fused_moe_bwd_plain(sh.x, sh.dy, sh.g_slot, idx, off_,
                                        *ws)
        rel = []
        for i, (part, g_, w_) in enumerate(zip(
                ("y", "dx", "dgates", "dw1", "dw2", "dw3"), got, want)):
            scale = float(w_.float().abs().max())
            e = close("fused_moe_fwd" if i == 0 else "fused_moe_bwd",
                      f"fused_moe {label} {part}", g_, w_, 0.0,
                      FUSED_SCALE_STEP * scale + GMM_ATOL)
            rel.append(round(e / max(scale, 1e-30), 6))
        for ex, n_ in enumerate(sh.lens):
            check(n_ > 0 or not any(bool(t[ex].any()) for t in got[3:]),
                  f"fused_moe {label}: empty expert {ex} has weight grads")
        fwd_plan = [w_ for _, w_ in KFM.h_ranges(h, KFM.pass_width(sh.S, h))]
        bwd_plan = [w_ for _, w_ in KFM.h_ranges(
            h, KFM.bwd_pass_width(sh.S, h))]
        log(f"parity fused_moe [{tag} {label}: S={sh.S}, {sh.live} live "
            f"experts]: max |err| / scale (y, dx, dgates, dw1, dw2, dw3) "
            f"{rel}; h-ranges forward {fwd_plan}, backward {bwd_plan}; "
            "repeated forward and backward bit-equal")
        del got, want, bwd

    # the combine at k = 8
    for label, sh in (("training", tr), ("decode", dec)):
        tim = sh.disp.token_index_map
        got = KC.combine(sh.p, tim, sh.gates)
        check(torch.equal(got, KC.combine_plain(sh.p, tim, sh.gates)),
              f"combine [{tag} {label}]: not bit-equal")
    log(f"parity combine [{tag}: k={k}, d={d}, L={tr.L} / {dec.L}]: "
        "bit-equal")

    # flash attention at 32/4 heads (G = 8)
    q = randn(TRAIN_BATCH, TRAIN_SEQ, Hq, Dh)
    kk, vv = (randn(TRAIN_BATCH, TRAIN_SEQ, Hkv, Dh) for _ in range(2))
    close("flash_attention", f"flash_attention training {Hq}/{Hkv} heads",
          KF.flash_attention(q, kk, vv, causal=True),
          KF.flash_attention_plain(q, kk, vv, causal=True, chunk=512), 0.0,
          FLASH_ATOL)
    log(f"parity flash_attention [{tag}: B={TRAIN_BATCH}, S={TRAIN_SEQ}, "
        f"{Hq}/{Hkv} heads of {Dh}]: max |err| "
        f"{errs['flash_attention']:.4g} (atol {FLASH_ATOL})")

    # paged attention over bf16 and int8 pages at the group of 8
    ps, pps = 16, 64
    n_pages = 1 + 4 * pps
    kb, vb = randn(n_pages, ps, Hkv, Dh), randn(n_pages, ps, Hkv, Dh)
    kq, ks = KQ.quantize(kb)
    vq, vs = KQ.quantize(vb)
    qd = randn(4, 1, Hq, Dh)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(6)) + 1
    table = perm[:4 * pps].reshape(4, pps).to(torch.int32).to(dev)
    pos = torch.tensor([36 + 15, 128 + 15, 299 + 15, 510 + 15],
                       dtype=torch.int32, device=dev)
    edge_table = table.clone()
    edge_table[2] = 0
    edge_pos = torch.tensor([0, 700, 0, 1000], dtype=torch.int32, device=dev)
    span, split_pos = split_boundaries(KP, dev, Hkv, pps, ps)
    cases = (("decode", table, pos), ("pos 0 + dead table", edge_table,
                                       edge_pos),
             (f"split boundaries (span {span})", table, split_pos))
    for name, (kernel, plain, pages) in (
            ("paged_attention", (KP.paged_attention,
                                 KP.paged_attention_plain, (kb, vb))),
            ("paged_attention_int8", (KP.paged_attention_int8,
                                      KP.paged_attention_int8_plain,
                                      (kq, vq, ks, vs)))):
        for case_name, tab, p_ in cases:
            close(name, f"{name} {case_name}", kernel(qd, *pages, tab, p_),
                  plain(qd, *pages, tab, p_), 0.0, PAGED_ATOL)
        log(f"parity {name} [{tag}: {Hq}/{Hkv} heads of {Dh}, group "
            f"{Hq // Hkv}; {'; '.join(c[0] for c in cases)}]: max |err| "
            f"{errs[name]:.4g} (atol {PAGED_ATOL})")
    torch.cuda.synchronize()

    # -- timing (phase 23) --
    gmm = partial(gmm_row, M, timer, entry)
    idx_tr, idx_dec = (sh.disp.expert_token_indices for sh in (tr, dec))
    rows = {
        "gather_gmm": [
            gmm(tr.x, tr.disp, w1, w2, idx_tr, f"{tag} training dual w1/w2 "
                f"+ save_ab: S={tr.S}, E={E}, d={d}, h={h}", 1, save_ab=True),
            gmm(tr.y_swi, tr.disp, w3, None, None,
                f"{tag} training w3 forward: S={tr.S}, {h}->{d}", 1),
            gmm(tr.dyg, tr.disp, w3, None, None,
                f"{tag} training w3^T: S={tr.S}, {d}->{h}", 1, trans_w=True),
            gmm(tr.da, tr.disp, w1, None, None,
                f"{tag} training w1^T: S={tr.S}, {h}->{d}", 1, trans_w=True),
            gmm(dec.x, dec.disp, w1, w2, idx_dec, f"{tag} decode dual w1/w2: "
                f"S={dec.S}, {dec.live} live experts", 5),
            gmm(dec.y_swi, dec.disp, w3, None, None,
                f"{tag} decode w3: S={dec.S}", 5)],
        "gmm_dw": [
            gmm_dw_row(M, timer, entry, lhs, dout, tr.disp,
                       f"{tag} training {name}: S={tr.S}, "
                       f"{lhs.shape[1]}x{dout.shape[1]} per expert, E={E}")
            for name, lhs, dout in (("dw1", tr.xg, tr.da),
                                    ("dw3", tr.y_swi, tr.dyg))],
        "combine": [
            combine_row(M, timer, entry, sh.p, sh.disp, sh.gates,
                        f"{tag} {label}: S={sh.S}, L={sh.L}, k={k}, d={d}")
            for label, sh in (("training", tr), ("decode", dec))],
        "flash_attention": [flash_row(
            M, timer, entry, q, kk, vv, 0, f"{tag} training: "
            f"B={TRAIN_BATCH}, S={TRAIN_SEQ}, {Hq}/{Hkv} heads of {Dh}, "
            "causal")]}
    for name, pages_ in (("paged_attention", (kb, vb)),
                         ("paged_attention_int8", (kq, vq, ks, vs))):
        rows[name] = [paged_row(
            M, timer, entry, qd, pages_, table, pos, 0,
            f"{tag} decode: B=4, Hq={Hq}, Hkv={Hkv}, Dh={Dh}, pages of {ps},"
            f" positions {pos.tolist()}")]
    fused = fused_kernel_timing(M, timer, entry, {
        "x": tr.x, "g": tr.g_slot, "disp": tr.disp, "dy": tr.dy,
        "x_dec": dec.x, "g_dec": dec.g_slot, "disp_dec": dec.disp},
        {"w1": w1, "w2": w2, "w3": w3})
    for name, rs in fused.items():
        for r in rs:
            r["shape"] = f"{tag} {r['shape']}"
    rows.update(fused)
    for name, rs in rows.items():
        for r in rs:
            log(f"time {name} [{r['shape']}]: {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), library {r['library_ms']}")
    return rows


def microbatch_phase(dev, K, cfg=None, seq: int = TRAIN_SEQ) -> dict:
    """Phases 27-28: gradient accumulation on Mixtral-8x7B at full width,
    2 layers, float32 masters (``blaze_pallas``).  The step at 2 x 2048
    tokens with M = 2 against M = 1 on the same batch and weights (the
    first step's learning rate is 0, so neither moves a weight; the
    moments are reset between them): loss and ce within ``MB_LOSS_RTOL``,
    grad norm within ``MB_NORM_RTOL``.  Then 8 x 2048 tokens with M = 4,
    whose live set is one 2 x 2048 microbatch: a cold and a warm step must
    finish with finite numbers; the state held between steps, the warm
    step's peak and the simulated peak are printed beside the M = 1
    step's peak.  ``cfg`` and ``seq`` replace the model and the sequence
    length (a CPU rehearsal)."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.interop import init_params
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import init_adamw
    cfg = cfg or get_config("mixtral-8x7b").replace(
        num_layers=2, moe_impl="blaze_pallas", use_pallas=True)
    base = TrainConfig(learning_rate=1e-4, warmup_steps=2, total_steps=100,
                       batch_size=TRAIN_BATCH, seq_len=seq, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev, dtype=torch.float32)
    opt = init_adamw(params)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    out = {"state_bytes": held}

    def run(tcfg, batch, label):
        step = make_train_step(cfg, tcfg, dev)
        opt.step = 0
        for t in opt.mu + opt.nu:
            t.zero_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        _, _, m = step(params, opt, batch)
        m = {k_: float(v) for k_, v in m.items()}
        m["step_s"] = time.perf_counter() - t0
        m["peak_bytes"] = torch.cuda.max_memory_allocated()
        m["peak_sim_bytes"] = step.peak_sim_bytes
        m["launches"] = K.launch_counts()
        check(all(np.isfinite(m[k_]) for k_ in ("loss", "grad_norm")),
              f"microbatches {label}: non-finite loss or grad norm")
        log(f"train microbatches [{label}]: loss {m['loss']:.6f} ce "
            f"{m['ce']:.6f} grad_norm {m['grad_norm']:.6f} lr {m['lr']} "
            f"step {m['step_s']:.4f} s, peak {m['peak_bytes'] / 2 ** 30:.3f}"
            f" GiB (state held {held / 2 ** 30:.3f} GiB; simulated "
            f"{m['peak_sim_bytes'] / 2 ** 30:.3f} GiB); launches "
            f"{m['launches']}")
        return m

    batch = next(make_batch_iterator(cfg.vocab_size, seq, TRAIN_BATCH, 0))
    one = run(base, batch, f"M=1, {TRAIN_BATCH} x {seq}")
    two = run(dataclasses.replace(base, num_microbatches=2), batch,
              f"M=2, {TRAIN_BATCH} x {seq}")
    rel = {k_: abs(two[k_] - one[k_]) / abs(one[k_])
           for k_ in ("loss", "ce", "grad_norm")}
    log(f"train microbatches: M=2 against M=1, relative differences {rel} "
        f"(tolerances loss and ce {MB_LOSS_RTOL}, grad norm {MB_NORM_RTOL})")
    check(rel["loss"] <= MB_LOSS_RTOL and rel["ce"] <= MB_LOSS_RTOL
          and rel["grad_norm"] <= MB_NORM_RTOL,
          "M=2 and M=1 steps disagree beyond the stated tolerances")
    check(two["launches"]["gather_gmm"] == 2 * one["launches"]["gather_gmm"],
          "M=2 did not run the expert kernels twice as often as M=1")
    big = dataclasses.replace(base, batch_size=4 * TRAIN_BATCH,
                              num_microbatches=4)
    batches = make_batch_iterator(cfg.vocab_size, seq, big.batch_size, 0)
    cold = run(big, next(batches), f"M=4, {big.batch_size} x {seq}, cold")
    warm = run(big, next(batches), f"M=4, {big.batch_size} x {seq}, warm")
    tokens = big.batch_size * seq
    log(f"train microbatches [M=4, {big.batch_size} x {seq}]: "
        f"completes; {tokens / warm['step_s']:.1f} tokens/s (warm step "
        f"{warm['step_s']:.4f} s), peak {warm['peak_bytes'] / 2 ** 30:.3f} "
        f"GiB against {one['peak_bytes'] / 2 ** 30:.3f} GiB at M=1 on one "
        f"microbatch ({(warm['peak_bytes'] - one['peak_bytes']) / 2 ** 30:+.3f}"
        f" GiB); state held between steps {held / 2 ** 30:.3f} GiB")
    out.update(m1=one, m2=two, m4_cold=cold, m4_warm=warm,
               rel_m2_m1=rel, tokens_per_s_m4=tokens / warm["step_s"])
    return out


def checkpoint_phase(M, dev) -> dict:
    """Phase 29: a training checkpoint round trip on the card at a reduced
    width of Qwen3-30B-A3B (2 layers, d=512, 32 experts, top-8, expert
    width 256, GQA 8/1 heads of 128; float32 masters, bf16 compute).  Two
    steps, a save, a restore of the parameters (bit-equal to the masters)
    and of the AdamW state (bit-equal), and a restore into a serving
    template (matrices in bf16): its greedy tokens must equal those of an
    engine over the in-memory masters cast the same way, leaf for leaf."""
    import tempfile

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.interop import init_params
    from repro_torch.train.checkpointing import (restore_checkpoint,
                                                 save_checkpoint)
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import AdamWState, init_adamw
    cfg = get_config("qwen3-moe-30b-a3b").replace(
        num_layers=2, d_model=512, num_heads=8, num_kv_heads=1,
        num_experts=32, moe_d_ff=256, vocab_size=4096,
        moe_impl="blaze_pallas", use_pallas=True)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10,
                       batch_size=2, seq_len=256)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                         dtype=torch.float32)
    opt = init_adamw(params)
    step = make_train_step(cfg, tcfg, dev)
    batches = make_batch_iterator(cfg.vocab_size, tcfg.seq_len,
                                  tcfg.batch_size, 0)
    losses = [float(step(params, opt, next(batches))[2]["loss"])
              for _ in range(2)]
    serving = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                          dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/step_1"
        save_checkpoint(path, 1, params, opt)
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        other = lambda t: torch.full_like(t, 7.0)
        n, masters, opt2 = restore_checkpoint(
            path, _map_leaves(params, other),
            AdamWState(0, [other(t) for t in opt.mu],
                       [other(t) for t in opt.nu]))
        _, served = restore_checkpoint(path, serving)
    check(n == 1 and opt2.step == opt.step == 2, "checkpoint step")
    check(all(torch.equal(a.detach(), b) for a, b in zip(
        list(_leaves(params)) + opt.mu + opt.nu,
        list(_leaves(masters)) + opt2.mu + opt2.nu)),
        "checkpoint: a restored float32 leaf differs")
    dtypes = iter([t.dtype for t in _leaves(serving)])
    cast = _map_leaves(params, lambda t: t.detach().to(next(dtypes)))
    check(all(a.dtype == b.dtype and a.device == b.device
              and torch.equal(a, b)
              for a, b in zip(_leaves(cast), _leaves(served))),
          "checkpoint: the serving layout differs from the cast masters")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(3, cfg.vocab_size, size=n_).astype(np.int32)
               for n_ in (40, 7, 130)]
    tokens = []
    for weights in (served, cast):
        eng = M.SE.ServeEngine(cfg, weights, batch_slots=3, capacity=256,
                               device=dev)
        reqs = [M.SE.Request(prompt=p, max_new_tokens=8,
                             eos_id=cfg.vocab_size) for p in prompts]
        eng.generate(reqs)
        tokens.append([r.out_tokens for r in reqs])
    check(tokens[0] == tokens[1], "checkpoint: restored engine's tokens "
          "differ from the in-memory weights' engine")
    log(f"checkpoint round trip [{cfg.name}, 2 layers, d=512, E=32, top-8, "
        f"{sum(t.numel() for t in _leaves(params)) / 1e6:.1f} M float32 "
        f"parameters]: losses {losses}; {nbytes / 2 ** 20:.1f} MiB on disk; "
        f"masters and AdamW state bit-equal; serving layout equals the cast "
        f"masters; greedy tokens equal: {tokens[0]}")
    return {"losses": losses, "bytes": nbytes, "tokens": tokens[0]}


# -- phases 30-33: sampling, prefix sharing, per-request backends, the
#    async runtime ---------------------------------------------------------


class _Capture:
    """``T.prefill`` and ``T.paged_decode_step`` wrapped while the block
    runs: each call synchronized and timed (``seconds``), its float32
    logits kept on the host (``prefill`` / ``decode`` lists, one
    ``(rows, vocab)`` tensor a call)."""

    def __init__(self, T):
        self.T = T
        self.prefill, self.decode = [], []
        self.seconds = {"prefill": 0.0, "decode": 0.0}

    def __enter__(self):
        self.real = (self.T.prefill, self.T.paged_decode_step)

        def wrap(kind, fn, store):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                self.seconds[kind] += time.perf_counter() - t0
                store.append(out.float().cpu())
                return out
            return run

        self.T.prefill = wrap("prefill", self.real[0], self.prefill)
        self.T.paged_decode_step = wrap("decode", self.real[1], self.decode)
        return self

    def __exit__(self, *exc):
        self.T.prefill, self.T.paged_decode_step = self.real


def _timed_decode_stage(SE):
    """Patch ``_GroupScheduler.dispatch_decode`` to synchronize around each
    step (the sampler included) and add its seconds to the returned dict;
    call the returned ``undo`` to restore it."""
    real = SE._GroupScheduler.dispatch_decode
    acc = {"s": 0.0}

    def timed(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self)
        torch.cuda.synchronize()
        acc["s"] += time.perf_counter() - t0
        return out

    SE._GroupScheduler.dispatch_decode = timed

    def undo():
        SE._GroupScheduler.dispatch_decode = real
    return acc, undo


class _Rows:
    """While the block runs: for every token an engine samples, the float32
    logits row it was drawn from, on the host, by ``(rid, token index)``
    (``rows``).  ``watch(eng)`` wraps an engine's sampler; the scheduler's
    dispatch stages pair each sampled row with its request.  The host copy
    synchronizes each step: record only runs that are not timed."""

    def __init__(self, SE):
        self.SE = SE
        self.rows = {}
        self._last = {}
        self._watched = []

    def watch(self, eng):
        real = eng._sample

        def sample(logits, keys):
            self._last["logits"] = logits.float().cpu()
            return real(logits, keys)

        eng._sample = sample
        self._watched.append(eng)
        return eng

    def __enter__(self):
        S = self.SE._GroupScheduler
        self.real = (S.dispatch_prefill, S.dispatch_decode)
        rows, last = self.rows, self._last

        def prefill(sched, admit):
            reqs = [sched.owner[s] for s in admit]
            out = self.real[0](sched, admit)
            for i, r in enumerate(reqs):
                rows[(r.rid, 0)] = last["logits"][i]
            return out

        def decode(sched):
            out = self.real[1](sched)
            if out is not None:
                for s, r, tidx in out[1]:
                    rows[(r.rid, tidx)] = last["logits"][s]
            return out

        S.dispatch_prefill, S.dispatch_decode = prefill, decode
        return self

    def __exit__(self, *exc):
        S = self.SE._GroupScheduler
        S.dispatch_prefill, S.dispatch_decode = self.real
        # the wrapper refers to its engine: drop it, so that the engine,
        # and the weights it holds, go when the phase lets go of them
        for eng in self._watched:
            del eng._sample
        self._watched.clear()


def _explain(what, SM, got, got_rows, ref, ref_rows, rids, temperature=None,
             seed=0) -> list:
    """Tokens of two runs of the same requests: identical, or each
    request's first divergence must be one that rounding explains.  Runs
    batched or scheduled otherwise prefill in other buckets, whose bf16
    sums round otherwise, so a later step's logits may differ by a few bf16
    steps; a token may then flip where the two best scores (logits / T
    plus the request's noise, or the logits when greedy) lie within twice
    that difference of each other.  Checks the logits within
    ``CPU_LOGIT_ATOL`` and the gap within 2 x their difference / T.
    Returns the divergences."""
    out = []
    for a, b, rid in zip(got, ref, rids):
        if a == b:
            continue
        j = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        la, lb = got_rows[(rid, j)], ref_rows[(rid, j)]
        diff = float((la - lb).abs().max())
        score = lb.clone()
        t = 1.0
        if temperature is not None:
            t = temperature
            score = SM.sample_scores(lb[None], SM.gumbel_noise(
                seed, torch.tensor([rid]), torch.tensor([j]), lb.numel()),
                temperature)[0]
        top2 = torch.topk(score, 2).values
        gap = float(top2[0] - top2[1])
        out.append({"rid": rid, "token": j, "logit_diff": diff,
                    "top2_score_gap": gap})
        check(diff <= CPU_LOGIT_ATOL and gap <= 2 * diff / t,
              f"{what}: request {rid} diverges at token {j}: logits "
              f"{diff:.4g} apart, top-2 score gap {gap:.4g} (more than "
              "rounding explains)")
    return out


def sampling_phase(M, cfg, params, prompts, dev, timer) -> dict:
    """Phase 30: temperature sampling (``greedy=False``, T = 0.8, seed 11)
    on phase 5's engine and prompts, each request's rid fixed to its
    index.  Warm tokens must equal cold ones; on 1 slot and with the
    prompts submitted in reverse order the tokens must be the same, or
    diverge first where rounding explains it (``_explain``: another
    schedule prefills in other buckets); seed 12 must give other tokens.
    The sampler's noise for fixed float32 logits must be bit-equal on the
    CPU and the card, and so its tokens.  Logs the decode tokens/s (the
    step synchronized, the sampler included) sampled and greedy, and the
    sampler's device time a decode step."""
    SE, SM = M.SE, M.SM

    def serve(slots=4, order=None, seed=11, greedy=False, rec=None):
        eng = SE.ServeEngine(cfg, params, batch_slots=slots, capacity=1024,
                             page_size=16, greedy=greedy, temperature=0.8,
                             seed=seed, device=dev)
        reqs = [SE.Request(prompt=p, max_new_tokens=16,
                           eos_id=cfg.vocab_size, rid=i)
                for i, p in enumerate(prompts)]
        sub = reqs if order is None else [reqs[i] for i in order]
        if rec is None:
            eng.generate(sub)
        else:
            with rec:
                rec.watch(eng).generate(sub)
        return [r.out_tokens for r in reqs], eng.stats

    recs = {name: _Rows(SE) for name in ("cold", "one", "reversed")}
    cold, _ = serve(rec=recs["cold"])
    tps = {}
    for mode in ("sampled", "greedy"):
        acc, undo = _timed_decode_stage(SE)
        try:
            toks, st = serve(greedy=mode == "greedy")
        finally:
            undo()
        tps[mode] = st["decode_slot_tokens"] / acc["s"]
        if mode == "sampled":
            warm = toks
    one, _ = serve(slots=1, rec=recs["one"])
    rev, _ = serve(order=list(range(len(prompts)))[::-1],
                   rec=recs["reversed"])
    other, _ = serve(seed=12)
    check(warm == cold, "sampling: warm run gave other tokens than cold")
    rids = list(range(len(prompts)))
    diverged = {name: _explain(f"sampling [{name}]", SM, toks,
                               recs[name].rows, cold, recs["cold"].rows,
                               rids, 0.8, 11)
                for name, toks in (("one", one), ("reversed", rev))}
    check(other != cold, "sampling: seed 12 gave seed 11's tokens")
    # the sampler alone: the same noise and tokens on both devices
    V = cfg.vocab_size
    srng = np.random.default_rng(30)
    logits = torch.from_numpy(
        (3 * srng.standard_normal((4, V))).astype(np.float32))
    rid = torch.tensor([0, 1, 2, 70000], dtype=torch.int32)
    gidx = torch.tensor([0, 5, 9, 15], dtype=torch.int32)
    noise_cpu = SM.gumbel_noise(11, rid, gidx, V)
    noise_dev = SM.gumbel_noise(11, rid.to(dev), gidx.to(dev), V)
    keys = torch.from_numpy(SM.row_keys(11, rid.numpy(), gidx.numpy()))
    bits_equal = torch.equal(SM.uniform_bits(keys, V),
                             SM.uniform_bits(keys.to(dev), V).cpu())
    n_diff = int((noise_cpu != noise_dev.cpu()).sum())
    tok_cpu = SM.sample(logits, noise_cpu, 0.8)
    lg = logits.to(dev)
    tok_dev = SM.sample(lg, noise_dev, 0.8).cpu()
    check(bits_equal and n_diff == 0,
          f"sampling: noise differs between the CPU and the card "
          f"(hash bits equal {bits_equal}, {n_diff} noise values differ)")
    check(torch.equal(tok_cpu, tok_dev),
          "sampling: the CPU and the card sample other tokens")
    k_dev = keys.to(dev)
    sampler_ms = timer(lambda: SM.sample(
        lg, SM.noise_from_keys(k_dev, V), 0.8))
    argmax_ms = timer(lambda: torch.argmax(lg, dim=-1))
    log(f"sampling [T=0.8, seed 11]: warm tokens equal cold; 1 slot "
        f"{'equal' if one == cold else diverged['one']}; reversed "
        f"submission {'equal' if rev == cold else diverged['reversed']}; "
        f"seed 12 differs; noise over (4, {V}) bit-equal CPU vs card, "
        f"tokens {tok_dev.tolist()} on both")
    log(f"sampling: decode {tps['sampled']:.1f} tok/s sampled, "
        f"{tps['greedy']:.1f} greedy (step synchronized); sampler "
        f"{sampler_ms:.4f} ms a step against argmax {argmax_ms:.4f} ms "
        f"(4 x {V}, device time)")
    for i, t in enumerate(cold):
        log(f"  req[{i}] sampled -> {t}")
    return {"decode_tok_per_s_sampled": tps["sampled"],
            "decode_tok_per_s_greedy": tps["greedy"],
            "sampler_ms": sampler_ms, "argmax_ms": argmax_ms,
            "one_slot_equal": one == cold, "reversed_equal": rev == cold,
            "diverged": diverged, "tokens": cold}


def prefix_phase(M, cfg, params, dev, timer, kv_dtype=None) -> dict:
    """Phase 31: prefix sharing with copy-on-write pages, over bf16 (or
    int8) pages.  Scenario A serves a 512-token prompt, the same plus 37
    tokens, then the first again (covered exactly: the last token is
    re-fed into a fork of the last shared page); scenario B serves one
    request on a 256-token prefix, then three more with distinct suffixes
    in one batch.  The same calls run on an engine without sharing.

    The stats must be those of the reference's admission
    (``repro/serve/engine.py:432-519``): a miss prefills its whole prompt;
    a hit maps the cached chain of full pages and prefills from the chain's
    end; a prompt the chain covers prefills its last token and forks one
    page.  The chain's pages must be bit-unchanged by the fork, every first
    token's logits within ``CPU_LOGIT_ATOL`` of the engine without sharing,
    and greedy tokens equal to its tokens, or diverge first where that
    engine's top two logits lie within the tolerance.  The paged kernel
    must be launched on every decode step of every layer.  Logs the
    prefill seconds and tokens with and without sharing, and the suffix
    prefill's attention (the plain gather over the table's positions)."""
    SE, T, K, PC = M.SE, M.T, M.K, M.PC
    prng = np.random.default_rng(31)
    V, ps = cfg.vocab_size, 16
    base = prng.integers(3, V, size=512).astype(np.int32)
    ext = np.concatenate([base, prng.integers(3, V, size=37)]).astype(
        np.int32)
    pre = prng.integers(3, V, size=256)
    grp = [np.concatenate([pre, prng.integers(3, V, size=n)]).astype(
        np.int32) for n in (40, 77, 100, 13)]
    scenarios = {"A": [[base], [ext], [base]],
                 "B": [[grp[0]], grp[1:]]}
    # the reference's accounting for these lengths
    want = {"A": {"prefix_misses": 1, "prefix_hits": 2,
                  "shared_pages_mapped": 2 * (512 // ps), "cow_forks": 1,
                  "prefill_tokens": 512 + 37 + 1},
            "B": {"prefix_misses": 1, "prefix_hits": 3,
                  "shared_pages_mapped": 3 * (256 // ps), "cow_forks": 0,
                  "prefill_tokens": 296 + 77 + 100 + 13}}
    kernel = "paged_attention_int8" if kv_dtype == "int8" else \
        "paged_attention"

    def run(name, share, snapshot=None):
        eng = SE.ServeEngine(cfg, params, batch_slots=4, capacity=1024,
                             page_size=ps, kv_dtype=kv_dtype,
                             prefix_cache=share, device=dev)
        out, logits, unchanged = [], [], None
        with _Capture(T) as cap:
            for c, call in enumerate(scenarios[name]):
                if snapshot is not None and c == 2:
                    chain = eng._prefix.lookup(PC.page_keys(base, ps))
                    before = [a[chain].clone() for pages in eng._cache
                              for a in pages if a is not None]
                n_pre, n_dec = len(cap.prefill), len(cap.decode)
                reqs = [SE.Request(prompt=p, max_new_tokens=16,
                                   eos_id=V) for p in call]
                eng.generate(reqs)
                for i, r in enumerate(reqs):
                    # request i of a call sits in slot i (slots are handed
                    # out lowest first): row i of each step's logits
                    rows = [cap.prefill[n_pre][i]] + [
                        d[i] for d in cap.decode[n_dec:]][:15]
                    out.append(r.out_tokens)
                    logits.append(rows)
                if snapshot is not None and c == 2:
                    after = [a[chain] for pages in eng._cache
                             for a in pages if a is not None]
                    unchanged = all(torch.equal(x, y)
                                    for x, y in zip(before, after))
                    snapshot.append(sum(int(x.view(torch.uint8).long().sum())
                                        for x in before))
                    snapshot.append(sum(int(x.view(torch.uint8).long().sum())
                                        for x in after))
        return eng.stats, out, logits, cap.seconds["prefill"], unchanged

    rec = {}
    for name in scenarios:               # a cold pass of both engines first
        run(name, False)
        run(name, True)
    for name in scenarios:
        st0, toks0, lg0, pre0, _ = run(name, False)
        K.reset_launches()
        sums = []
        st1, toks1, lg1, pre1, unchanged = run(
            name, True, sums if name == "A" else None)
        launches = K.launch_counts()[kernel]
        for key, v in want[name].items():
            check(st1[key] == v, f"prefix [{name}, {kv_dtype or 'bf16'}]: "
                  f"{key} {st1[key]}, the reference's accounting gives {v}")
        check(launches == st1["decode_steps"] * cfg.num_layers,
              f"prefix [{name}]: {kernel} launched {launches} times in "
              f"{st1['decode_steps']} decode steps of {cfg.num_layers} "
              "layers")
        if name == "A":
            check(unchanged, "prefix: the fork changed a shared page")
        first = max(float((a[0] - b[0]).abs().max())
                    for a, b in zip(lg1, lg0))
        check(first <= CPU_LOGIT_ATOL,
              f"prefix [{name}]: first-token logits {first:.4g} from the "
              "engine without sharing")
        diverged = []
        for i, (a, b) in enumerate(zip(toks1, toks0)):
            if a == b:
                continue
            j = next(t for t, (x, y) in enumerate(zip(a, b)) if x != y)
            top2 = torch.topk(lg0[i][j], 2).values
            gap = float(top2[0] - top2[1])
            diverged.append({"request": i, "token": j, "top2_gap": gap})
            check(gap <= CPU_LOGIT_ATOL,
                  f"prefix [{name}]: request {i} diverges at token {j} "
                  f"where the top-2 gap is {gap:.4g}")
        rec[name] = {"stats": {k: st1[k] for k in want[name]},
                     "stats_without": {"prefill_tokens":
                                       st0["prefill_tokens"]},
                     "prefill_s": pre1, "prefill_s_without": pre0,
                     "first_logit_max_diff": first, "diverged": diverged,
                     "decode_steps": st1["decode_steps"],
                     "kernel_launches": launches}
        log(f"prefix [{name}, {kv_dtype or 'bf16'} pages]: stats "
            f"{rec[name]['stats']} (the reference's accounting); prefill "
            f"{st1['prefill_tokens']} tokens in {pre1:.4f} s with sharing, "
            f"{st0['prefill_tokens']} in {pre0:.4f} s without; first-token "
            f"logits max |diff| {first:.4g}; greedy tokens "
            f"{'equal' if not diverged else f'diverge {diverged}'}; "
            f"{kernel} {launches} launches in {st1['decode_steps']} decode "
            "steps")
        if name == "A":
            log(f"prefix [A]: the 32 shared pages bit-unchanged by the COW "
                f"fork (byte sums {sums[0]} before, {sums[1]} after)")
            rec[name]["page_byte_sums"] = sums
    # the suffix prefill's attention: the plain gather over pps x ps
    # positions (no kernel computes it, here or in the reference)
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    pages = T.init_paged_cache(cfg.replace(num_layers=1), 257, ps, dev,
                               quantized=kv_dtype == "int8")[0]
    for a in (a for a in pages if a is not None):
        if a.dtype.is_floating_point:
            a.copy_(torch.randn(a.shape, device=dev).to(a.dtype))
        else:
            a.copy_(torch.randint(-127, 128, a.shape, device=dev))
    table = (torch.randperm(256, device=dev)[:4 * 64].reshape(4, 64) + 1).to(
        torch.int32)
    rec["suffix_attention_ms"] = {}
    for B, Sq, off in ((1, 64, 512), (4, 128, 256)):
        q = torch.randn(B, Sq, Hq, Dh, device=dev).to(BF16)
        pos = (off + torch.arange(Sq, device=dev))[None].expand(B, Sq)
        ms = timer(lambda: PC.paged_gather_attention(q, pages, table[:B],
                                                     pos))
        rec["suffix_attention_ms"][f"B={B}, Sq={Sq}"] = ms
        log(f"prefix suffix attention [{kv_dtype or 'bf16'} pages, B={B}, "
            f"Sq={Sq}, {Hq}/{Hkv} heads of {Dh}, over 64 x {ps} positions]: "
            f"{ms:.4f} ms a layer (plain gather, device time)")
    return rec


def backends_phase(M, cfg, params, prompts, dev) -> dict:
    """Phase 32: per-request grouped-GEMM backends and the paged-attention
    registry, Mixtral with ``moe_impl="blaze"``.  One ``generate`` carries
    a request on ``pallas``, one on ``ragged`` and one on the engine's own
    (``segment``); each group's tokens must equal those of an engine built
    with that backend, and ``gather_gmm`` must be launched while the
    ``pallas`` group runs and in no other.  An engine with
    ``paged_kernel="dense"`` must launch no ``paged_attention``, and its
    first-token and first decode-step logits lie within
    ``CPU_LOGIT_ATOL`` of the kernel engine's; the default engine resolves
    to the kernel from ``auto``."""
    SE, T, K = M.SE, M.T, M.K
    cfg_b = cfg.replace(moe_impl="blaze")
    picks = {"pallas": prompts[0], "ragged": prompts[1], None: prompts[4]}

    def engine(**kw):
        return SE.ServeEngine(cfg_b, params, batch_slots=4, capacity=1024,
                              page_size=16, device=dev, **kw)

    eng = engine(gmm_backend="segment")
    by_group = {}
    real = eng._serve_group

    def serve_group(requests, name):
        K.reset_launches()
        real(requests, name)
        torch.cuda.synchronize()
        by_group[name] = K.launch_counts()

    eng._serve_group = serve_group
    reqs = {b: SE.Request(prompt=p, max_new_tokens=8, eos_id=cfg.vocab_size,
                          gmm_backend=b) for b, p in picks.items()}
    eng.generate(list(reqs.values()))
    del eng._serve_group        # the wrapper refers to the engine
    check(sorted(by_group) == ["pallas", "ragged", "segment"],
          f"backends: groups {sorted(by_group)}")
    for b, p in picks.items():
        name = b or "segment"
        alone = SE.Request(prompt=p, max_new_tokens=8, eos_id=cfg.vocab_size)
        engine(gmm_backend=name).generate([alone])
        check(reqs[b].out_tokens == alone.out_tokens,
              f"backends: the {name} group's tokens differ from a {name} "
              "engine's")
        n = by_group[name]["gather_gmm"]
        check((n > 0) == (name == "pallas"),
              f"backends: gather_gmm launched {n} times in the {name} group")
    default = SE.ServeEngine(cfg, params, batch_slots=4, capacity=1024,
                             page_size=16, device=dev)
    check((default.paged_attn.name, default.paged_attn.source)
          == ("pallas", "auto"),
          f"registry: the default engine resolved {default.paged_attn}")
    runs = {}
    for impl in ("pallas", "dense"):
        e = SE.ServeEngine(cfg, params, batch_slots=4, capacity=1024,
                           page_size=16, device=dev,
                           paged_kernel=None if impl == "pallas" else impl)
        rs = [SE.Request(prompt=p, max_new_tokens=8, eos_id=cfg.vocab_size)
              for p in prompts]
        K.reset_launches()
        with _Capture(T) as cap:
            e.generate(rs)
        runs[impl] = (K.launch_counts()["paged_attention"],
                      cap.prefill, cap.decode, [r.out_tokens for r in rs])
    check(runs["dense"][0] == 0 and runs["pallas"][0] > 0,
          f"registry: paged_attention launched {runs['dense'][0]} times by "
          f"the dense engine, {runs['pallas'][0]} by the kernel engine")
    d_first = float((runs["dense"][1][0] - runs["pallas"][1][0]).abs().max())
    d_step = float((runs["dense"][2][0] - runs["pallas"][2][0]).abs().max())
    check(d_first <= CPU_LOGIT_ATOL and d_step <= CPU_LOGIT_ATOL,
          f"registry: dense against the kernel: first-token logits "
          f"{d_first:.4g}, first decode step {d_step:.4g}")
    agree = sum(a == b for x, y in zip(runs["dense"][3], runs["pallas"][3])
                for a, b in zip(x, y))
    total = sum(len(x) for x in runs["pallas"][3])
    log(f"backends [blaze; engine segment]: one generate, groups "
        f"{sorted(by_group)}; each group's tokens equal its own engine's; "
        f"gather_gmm launches by group "
        f"{ {k: v['gather_gmm'] for k, v in by_group.items()} }")
    log(f"registry: default engine -> {default.paged_attn.name} "
        f"({default.paged_attn.source}); dense engine: paged_attention "
        f"launches {runs['dense'][0]} (kernel engine {runs['pallas'][0]}); "
        f"logits max |diff| first token {d_first:.4g}, first decode step "
        f"{d_step:.4g}; tokens agreeing {agree} of {total}")
    return {"gather_gmm_by_group": {k: v["gather_gmm"]
                                    for k, v in by_group.items()},
            "dense_paged_launches": runs["dense"][0],
            "kernel_paged_launches": runs["pallas"][0],
            "dense_first_logit_diff": d_first,
            "dense_step_logit_diff": d_step,
            "dense_tokens_agreeing": [agree, total],
            "default_paged_kernel": [default.paged_attn.name,
                                     default.paged_attn.source]}


def runtime_phase(M, cfg, params, prompts, dev, tag, rounds=3) -> dict:
    """Phase 33: the async runtime on the engine of phases 5 / 16 (4
    slots, capacity 1024, 16-token pages, 16 new tokens).
    ``AsyncServeRuntime.run`` must give the synchronous engine's tokens,
    greedy and sampled (T = 0.8, seed 11), or diverge first where rounding
    explains it (``_explain``: the runtime admits requests as they arrive,
    so its prefill batches, and their buckets, may differ from the
    synchronous engine's); every request's callbacks must stream its tokens
    in order and then exactly one terminal event; the stream iterator must
    yield a lone request's tokens (those of a synchronous engine serving it
    alone) and return its reason; the emission queue's gets must equal its
    puts, above 0; the paged kernel must be launched.  The same request set
    is timed synchronously (one engine) and asynchronously (one runtime
    over another engine) in ``rounds`` interleaved rounds after a warm one
    (wall seconds, end to end, nothing recorded)."""
    SE, K, RT, SM = M.SE, M.K, M.RT, M.SM

    def engine(rec=None, **kw):
        eng = SE.ServeEngine(cfg, params, batch_slots=4, capacity=1024,
                             page_size=16, device=dev, **kw)
        return eng if rec is None else rec.watch(eng)

    def requests(ps=prompts):
        return [SE.Request(prompt=p, max_new_tokens=16,
                           eos_id=cfg.vocab_size) for p in ps]

    def sync(rec=None, **kw):
        rs = requests()
        eng = engine(rec, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if rec is None:
            eng.generate(rs)
        else:
            with rec:
                eng.generate(rs)
        torch.cuda.synchronize()
        return [r.out_tokens for r in rs], time.perf_counter() - t0, {
            "prefill_calls": eng.stats["prefill_calls"],
            "decode_steps": eng.stats["decode_steps"]}

    def run_async(rec=None, **kw):
        rs, events = requests(), []
        for i, r in enumerate(rs):
            r.on_token = lambda t, i=i: events.append(("tok", i, t))
            r.on_finish = lambda why, i=i: events.append(("fin", i, why))
        eng = engine(rec, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if rec is None:
            with RT.AsyncServeRuntime(eng) as rt:
                rt.run(rs)
        else:
            with rec, RT.AsyncServeRuntime(eng) as rt:
                rt.run(rs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for i, r in enumerate(rs):
            mine = [e for e in events if e[1] == i]
            check(mine == [("tok", i, t) for t in r.out_tokens]
                  + [("fin", i, r.finish_reason)],
                  f"runtime{tag}: request {i}'s events out of order")
        q = rt.emit_q.stats
        check(q["gets"] == q["puts"] > 0,
              f"runtime{tag}: emission queue {q}")
        return [r.out_tokens for r in rs], wall, {
            "emit": dict(q), "staged": dict(rt.staged_q.stats),
            "buffers": dict(rt.buffers.stats),
            "prefill_calls": eng.stats["prefill_calls"],
            "decode_steps": eng.stats["decode_steps"]}

    rids = list(range(len(prompts)))
    diverged = {}
    for mode, kw in (("greedy", {}),
                     ("sampled", dict(greedy=False, temperature=0.8,
                                      seed=11))):
        rs_, ra_ = _Rows(SE), _Rows(SE)
        ts, _, _ = sync(rs_, **kw)
        ta, _, _ = run_async(ra_, **kw)
        diverged[mode] = _explain(
            f"runtime{tag} [{mode}]", SM, ta, ra_.rows, ts, rs_.rows, rids,
            kw.get("temperature"), kw.get("seed", 0))
        if mode == "greedy":
            ref = ts
    # The timed rounds reuse one engine and one runtime, as a server keeps
    # them (a new runtime starts threads whose first CUDA calls set up
    # per-thread state); each is warmed by one untimed round first.
    walls = {"sync": [], "async": []}
    agree = {"sync": [], "async": []}
    steps = {}
    sync_eng, async_eng = engine(), engine()
    rt = RT.AsyncServeRuntime(async_eng)
    try:
        for rnd in range(rounds + 1):
            for mode in ("sync", "async"):
                rs, events = requests(), []
                for i, r in enumerate(rs):
                    r.on_token = lambda t, i=i: events.append(("tok", i, t))
                    r.on_finish = lambda why, i=i: events.append(
                        ("fin", i, why))
                eng = sync_eng if mode == "sync" else async_eng
                before = dict(eng.stats)
                K.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if mode == "sync":
                    eng.generate(rs)
                else:
                    rt.run(rs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                toks = [r.out_tokens for r in rs]
                steps[mode] = {k: eng.stats[k] - before[k] for k in (
                    "prefill_calls", "decode_steps")}
                check(K.launch_counts()["paged_attention"] > 0,
                      f"runtime{tag}: paged_attention not launched")
                for i, r in enumerate(rs):
                    check([e for e in events if e[1] == i]
                          == [("tok", i, t) for t in r.out_tokens]
                          + [("fin", i, r.finish_reason)],
                          f"runtime{tag}: request {i}'s events out of order")
                if mode == "sync":          # one schedule, one result
                    check(toks == ref, f"runtime{tag}: a synchronous run "
                          "gave other tokens")
                if rnd:
                    walls[mode].append(wall)
                    agree[mode].append(toks == ref)
    finally:
        rt.close()
    q = rt.emit_q.stats
    check(q["gets"] == q["puts"] > 0, f"runtime{tag}: emission queue {q}")
    qstats = {"emit": dict(q), "staged": dict(rt.staged_q.stats),
              "buffers": dict(rt.buffers.stats), "steps": steps}
    alone = requests(prompts[:1])
    engine().generate(alone)
    with RT.AsyncServeRuntime(engine()) as rt:
        r = requests(prompts[:1])[0]
        it, seen = rt.stream(r, timeout=120.0), []
        try:
            while True:
                seen.append(next(it))
        except StopIteration as stop:
            reason = stop.value
    check(seen == alone[0].out_tokens == r.out_tokens and reason == "length",
          f"runtime{tag}: stream gave {seen} [{reason}], a lone "
          f"synchronous run {alone[0].out_tokens}")
    med = {m: statistics.median(w) for m, w in walls.items()}
    log(f"runtime{tag}: async against sync tokens: greedy "
        f"{'equal' if not diverged['greedy'] else diverged['greedy']}, "
        f"sampled (T=0.8 seed 11) "
        f"{'equal' if not diverged['sampled'] else diverged['sampled']}; "
        f"streams in order with one terminal event each; the stream "
        f"iterator equals a lone synchronous run")
    log(f"runtime{tag}: wall sync {walls['sync']} s, async "
        f"{walls['async']} s; medians {med['sync']:.4f} / "
        f"{med['async']:.4f} s (async / sync "
        f"{med['async'] / med['sync']:.3f}); timed rounds' tokens equal the "
        f"sync run's: sync {agree['sync']}, async {agree['async']}; the "
        f"runtime's queues over all rounds and the last round's steps "
        f"{qstats}")
    return {"wall_sync_s": walls["sync"], "wall_async_s": walls["async"],
            "median_sync_s": med["sync"], "median_async_s": med["async"],
            "timed_async_tokens_equal": agree["async"],
            "diverged": diverged, "queues": qstats}


# The recurrent and hybrid paths (phases 34-36): Hymba-1.5B trains at all
# 32 layers on 2 x 2048 tokens, 3 warm steps; decode runs B = 4 requests
# teacher-forced through a 64-token prompt and then 32 greedy tokens; the
# 2-layer run past Hymba's 1024-token window decodes 1280 positions (a
# multiple of the 256-position Mamba chunk, so the forward it is held to
# takes them whole).  xLSTM-1.3B trains one group (7 mLSTM + 1 sLSTM
# layers): 48 layers with float32 masters and AdamW take ~58 GB before
# activations.
NEW_WARM_STEPS = 3
DECODE_B, DECODE_PROMPT, DECODE_NEW = 4, 64, 32
WRAP_LEN = 1280


# Decode held against the forward (phases 35-36).  float32: a fixed
# DECODE_F32_ATOL (float32 logits of size ~5 summed in other orders through
# every layer).  bf16: CPU_LOGIT_ATOL plus twice the bf16 forward's own
# rounding (its distance from the float32 forward of the same weights);
# a held run fails if that rounding passes DECODE_TOL_CAP of the largest
# |logit|.  A run at a depth where a random-init model amplifies rounding
# past the cap is measured and logged as not a check.
DECODE_F32_ATOL = 1e-2
DECODE_TOL_CAP = 0.1


def decode_parity(M, cfg, params, toks, dev, tag, capacity=None,
                  held=True) -> dict:
    """``decode_step`` teacher-forced over every position of ``toks``
    (B, S) from ``init_cache(cfg, B, S)`` against ``forward``'s logits on
    the card, to the tolerance set out at ``DECODE_TOL_CAP``.  Held
    (``held``): every step's argmax must equal the forward's unless the
    forward's top two lie within the tolerance, and every logit within
    it.  Not held: the same steps (they fill the cache) and the distance
    logged as a measurement.  The cache holds ``capacity`` positions
    (default S).  Returns the cache after the last step, the last logits
    and the measurements."""
    T = M.T
    B, S = toks.shape
    full = T.forward(params, _token_batch(cfg, toks), cfg)[0]
    top = float(full.abs().max())
    cap = DECODE_TOL_CAP * top
    spread = None
    if cfg.dtype == "float32":
        tol = DECODE_F32_ATOL
        how = f"{DECODE_F32_ATOL} (float32)"
    else:
        p32 = _map_leaves(params, lambda t: t.float())
        spread = float((T.forward(p32, _token_batch(cfg, toks), cfg.replace(
            dtype="float32"))[0] - full).abs().max())
        del p32
        tol = CPU_LOGIT_ATOL + 2 * spread
        how = (f"{CPU_LOGIT_ATOL} + 2 x the bf16 forward's distance from "
               f"the float32 forward {spread:.4g} (cap {cap:.4g})")
        if held:
            check(spread <= cap, f"decode{tag}: the bf16 forward's own "
                  f"rounding {spread:.4g} passes the cap {cap:.4g}: no check")
    cache = T.init_cache(cfg, B, capacity or S, dev)
    worst, flips = 0.0, 0
    for t in range(S):
        lg, cache = T.decode_step(params, cache, {"tokens": toks[:, t:t + 1]},
                                  t, cfg)
        ref = full[:, t]
        worst = max(worst, float((lg - ref).abs().max()))
        top2 = ref.topk(2).values
        same = lg.argmax(-1) == ref.argmax(-1)
        check(not held or bool((same | (top2[:, 0] - top2[:, 1] <= tol))
                               .all()),
              f"decode{tag}: step {t} argmax differs from the forward's "
              "beyond a near tie")
        flips += int((~same).sum())
    verdict = "held" if held else "measured, NOT a check" + (
        "; the forward's own rounding passes the cap"
        if spread is not None and spread > cap else "")
    log(f"decode parity{tag}: {S} positions x B={B}, max |logit diff| vs "
        f"forward {worst:.4g}, tol {tol:.4g} = {how}; max |logit| "
        f"{top:.3f}, argmax flips {flips}; {verdict}")
    if held:
        check(worst <= tol, f"decode{tag}: logits disagree with the forward")
    del full
    return cache, lg, {"max_logit_diff": worst, "tol": tol, "cap": cap,
                       "held": held, "bf16_forward_spread": spread,
                       "argmax_flips": flips}


def _token_batch(cfg, toks) -> dict:
    """A forward's batch of the token stream ``toks`` (B, S): for a model
    of mixed inputs, with no image slot ahead of it (``decode_step``
    decodes a token stream, as the reference's does)."""
    if cfg.input_kind != "mixed":
        return {"tokens": toks}
    return {"tokens": toks, "image_embeds": torch.zeros(
        toks.shape[0], 0, cfg.d_model, device=toks.device)}


def decode_phase(M, cfg, dev, tag, K, cut_cfg=None, cut_len=WRAP_LEN,
                 f32_full=True, n_new=DECODE_NEW) -> dict:
    """Phases 35, 36 and 44 (decode): random bf16 weights from seed 0, B =
    DECODE_B requests teacher-forced through a DECODE_PROMPT-token prompt
    by ``decode_step`` (``decode_parity``: with ``f32_full`` held first
    with the same draws in float32; then in bf16, measured and not held,
    since at full depth a random-init model amplifies bf16 rounding past
    the cap), then ``n_new`` greedy tokens timed, and the same greedy
    tokens again from a copy of the cache under torch.profiler (the same
    tokens; device busy share).  With ``cut_cfg`` (fewer layers) a run
    of ``cut_len`` positions is held against the forward in float32 and,
    if ``cut_cfg`` is bf16, in bf16 too: Hymba cut to 2 layers over
    WRAP_LEN positions, past the 1024-token window; xLSTM cut to 8 layers
    in float32 only (at 48 layers two valid chunkings of a random-init
    xLSTM's float32 forward differ by several units, so full depth is
    measured in bf16 only).
    """
    T = M.T
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, gen, dev)
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    toks = torch.randint(3, cfg.vocab_size, (DECODE_B, DECODE_PROMPT),
                         generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    log(f"decode{tag}: weights {n_bytes / 1e9:.2f} GB bf16, "
        f"{cfg.num_layers} layers; B={DECODE_B}, prompt {DECODE_PROMPT}, "
        f"{n_new} greedy tokens")
    out = {"weight_bytes": n_bytes}
    with torch.inference_mode():
        if f32_full:
            # the same draws, unrounded: float32 rounding is 2^-16 of
            # bf16's, so the check stays sharp at full depth
            cfg32 = cfg.replace(dtype="float32")
            p32 = M.init_params(cfg32, torch.Generator(device=dev)
                                .manual_seed(0), dev, dtype=torch.float32)
            _, _, out["parity_float32"] = decode_parity(
                M, cfg32, p32, toks, dev, tag + " float32")
            del p32, _
            torch.cuda.empty_cache()
        cache, lg, out["parity"] = decode_parity(
            M, cfg, params, toks, dev, tag,
            capacity=DECODE_PROMPT + n_new, held=False)
        start = _clone_cache(cache)

        def greedy(c, lg_):
            tok, toks_out = lg_.argmax(-1, keepdim=True), []
            for i in range(n_new):
                lg_, c = T.decode_step(params, c, {"tokens": tok},
                                       DECODE_PROMPT + i, cfg)
                tok = lg_.argmax(-1, keepdim=True)
                toks_out.append(tok)
            return torch.cat(toks_out, 1)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        got = greedy(cache, lg)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            again = greedy(start, lg)
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        check(torch.equal(got, again), f"decode{tag}: a traced rerun gave "
              "other greedy tokens")
        busy = sum(_device_time_by_kernel(prof).values()) / 1e6
        del start, cache
        tps = DECODE_B * n_new / dec_s
        log(f"decode{tag} launches over {n_new} greedy steps: "
            f"{launches}")
        log(f"decode{tag}: {DECODE_B * n_new} greedy tokens in "
            f"{dec_s:.4f} s ({tps:.1f} tok/s, {1e3 * dec_s / n_new:.2f}"
            f" ms a step); traced rerun wall {traced_s:.4f} s, device busy "
            f"{busy:.4f} s ({100 * busy / traced_s:.1f}%); peak memory "
            f"{peak / 2 ** 30:.3f} GiB; tokens[0] {got[0].tolist()}")
        out.update(decode_tok_per_s=tps, decode_s=dec_s, busy_s=busy,
                   traced_wall_s=traced_s, peak_bytes=peak,
                   launches=launches)
        if cut_cfg is not None:
            ctoks = torch.randint(
                3, cfg.vocab_size, (2, cut_len),
                generator=torch.Generator(device=dev).manual_seed(2),
                device=dev)
            # the cut in float32 (the same draws, unrounded: the sharp
            # check), then in bf16 from the full model's own layers
            for key, ccfg in (("cut_float32", cut_cfg.replace(
                    dtype="float32")), ("cut", cut_cfg)):
                if key == "cut" and cut_cfg.dtype == "float32":
                    continue
                if ccfg.dtype == cfg.dtype:
                    cut = dict(params,
                               layers=params["layers"][:ccfg.num_layers])
                else:
                    cut = M.init_params(ccfg, torch.Generator(
                        device=dev).manual_seed(0), dev, dtype=getattr(
                            torch, ccfg.dtype))
                _, _, out[key] = decode_parity(
                    M, ccfg, cut, ctoks, dev,
                    f" [{ccfg.name}, {ccfg.num_layers} layers, "
                    f"{cut_len} positions, {ccfg.dtype}"
                    + (f", window {ccfg.sliding_window}]"
                       if ccfg.sliding_window else "]"))
                del cut
    del params
    torch.cuda.empty_cache()
    return out


def new_shape_kernels(M, dev, timer, entry, errs) -> dict:
    """Phase 39: the kernels at the shapes the new paths give them, each
    against its plain version and timed beside its bound, plain time and
    library time: flash attention at Hymba-1.5B's heads (25/5 of 64,
    window 1024, B = 2, S = 2048) and at Gemma2-27B's (32/16 of 128,
    window 4096, softcap 50, B = 1, S = 8192); the fused-SwiGLU trio at
    Hymba's widths (d = 1600, off the 128-row tile, h = 5504) and
    Gemma2's (d = 4608, h = 36864) at training (L = 4096) and decode
    (L = 4); paged decode attention with Gemma2's window and softcap at
    its GQA group of 2.  Returns the timing rows by kernel."""
    KF, KS, KP = M.KF, M.KS, M.KP
    g = torch.Generator(device=dev).manual_seed(26)

    def randn(*shape, dtype=BF16, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    rows = {n: [] for n in ("flash_attention", "fused_swiglu_fwd",
                            "fused_swiglu_bwd_x", "fused_swiglu_bwd_w",
                            "paged_attention")}
    for label, (B, S, H, Hkv, Dh, window, cap) in (
            ("hymba-1.5b", (2, 2048, 25, 5, 64, 1024, 0.0)),
            ("gemma2-27b", (1, 8192, 32, 16, 128, 4096, 50.0))):
        q, k, v = randn(B, S, H, Dh), randn(B, S, Hkv, Dh), \
            randn(B, S, Hkv, Dh)
        got = KF.flash_attention(q, k, v, causal=True, window=window,
                                 cap=cap)
        want = KF.flash_attention_plain(q, k, v, causal=True, window=window,
                                        cap=cap, chunk=512)
        e = require_close(f"flash_attention [{label}]", got, want, 0.0,
                          FLASH_ATOL)
        errs["flash_attention"] = max(errs["flash_attention"], e)
        shape = (f"{label}: B={B}, S={S}, {H}/{Hkv} heads of {Dh}, window "
                 f"{window}" + (f", softcap {cap:g}" if cap else ""))
        log(f"parity flash_attention [{shape}]: max |err| {e:.4g} (atol "
            f"{FLASH_ATOL})")
        rows["flash_attention"].append(flash_row(
            M, timer, entry, q, k, v, window, shape, cap=cap))
        del q, k, v, got, want
    for label, (d, h) in (("hymba-1.5b", (1600, 5504)),
                          ("gemma2-27b", (4608, 36864))):
        w1 = randn(d, h, scale=d ** -0.5)
        w2 = randn(d, h, scale=d ** -0.5)
        for L in (4096, 4):
            x, dy = randn(L, d), randn(L, h)
            got = list(KS.fused_swiglu_fwd(x, w1, w2))
            check(all(torch.equal(a, b) for a, b in zip(
                got, KS.fused_swiglu_fwd(x, w1, w2))),
                f"fused_swiglu [{label} L={L}]: repeated forward differs")
            want = list(KS.fused_swiglu_fwd_plain(x, w1, w2))
            a, b = got[1], got[2]
            got.append(KS.fused_swiglu_bwd_x(dy, a, b, w1, w2))
            want.append(KS.fused_swiglu_bwd_x_plain(dy, a, b, w1, w2))
            got += KS.fused_swiglu_bwd_w(x, dy, a, b)
            want += KS.fused_swiglu_bwd_w_plain(x, dy, a, b)
            rel = []
            for key, out, g_, w_ in zip(
                    ("fused_swiglu_fwd",) * 3 + ("fused_swiglu_bwd_x",)
                    + ("fused_swiglu_bwd_w",) * 2,
                    ("y", "a", "b", "dx", "dw1", "dw2"), got, want):
                scale = float(w_.float().abs().max())
                e = require_close(f"fused_swiglu [{label} L={L}] {out}", g_,
                                  w_, 0.0, FUSED_SCALE_STEP * scale
                                  + GMM_ATOL)
                errs[key] = max(errs[key], e)
                rel.append(round(e / max(scale, 1e-30), 6))
            log(f"parity fused_swiglu [{label}: L={L}, d={d}, h={h}]: max "
                f"|err| / scale (y, a, b, dx, dw1, dw2) {rel}; repeated "
                "forward bit-equal")
            del x, dy, got, want, a, b
        for name, rs in swiglu_rows(M, timer, entry, w1, w2, randn,
                                    (("training", 4096), ("decode", 4)),
                                    tag=f"{label} ").items():
            rows[name].extend(rs)
        del w1, w2
    # paged decode attention, Gemma2's heads (group 2), its window and
    # softcap, positions on both sides of the window's length
    ps, pps, Hq, Hkv, Dh = 16, 320, 32, 16, 128
    n_pages = 1 + 4 * pps
    kp, vp = randn(n_pages, ps, Hkv, Dh), randn(n_pages, ps, Hkv, Dh)
    q = randn(4, 1, Hq, Dh)
    table = (torch.randperm(n_pages - 1, generator=torch.Generator()
                            .manual_seed(26)) + 1)[:4 * pps].reshape(
        4, pps).to(torch.int32).to(dev)
    pos = torch.tensor([100, 4095, 4097, pps * ps - 1], dtype=torch.int32,
                       device=dev)
    got = KP.paged_attention(q, kp, vp, table, pos, window=4096, cap=50.0)
    want = KP.paged_attention_plain(q, kp, vp, table, pos, window=4096,
                                    cap=50.0)
    e = require_close("paged_attention [gemma2-27b]", got, want, 0.0,
                      PAGED_ATOL)
    errs["paged_attention"] = max(errs["paged_attention"], e)
    shape = (f"gemma2-27b decode: B=4, Hq={Hq}, Hkv={Hkv}, Dh={Dh}, page "
             f"{ps}, window 4096, softcap 50, positions {pos.tolist()}")
    log(f"parity paged_attention [{shape}]: max |err| {e:.4g} (atol "
        f"{PAGED_ATOL})")
    rows["paged_attention"].append(paged_row(
        M, timer, entry, q, (kp, vp), table, pos, 4096, shape, cap=50.0))
    for name, rs in rows.items():
        for r in rs:
            log(f"time {name} [{r['shape']}]: {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), library {r['library_ms']}")
    return rows


# The fused MoE pair's general path (phase 40): 1024 tokens routed top-2
# of 8 experts from uniform scores (2048 slots), d = 1024, h = 2048, in
# float32 and in bf16 with d = 1020 (off the multiple of 8 the tensor-core
# path needs).
GENERAL_SHAPES = (("float32", torch.float32, 1024), ("bf16, d=1020",
                                                     torch.bfloat16, 1020))
GENERAL_L, GENERAL_E, GENERAL_K, GENERAL_H = 1024, 8, 2, 2048


def general_path_phase(M, dev, timer, entry, errs) -> dict:
    """Phase 40: the fused MoE pair's general path (float32-FMA kernels,
    ``kernels/fused_moe.tensor_core_path`` false) at GENERAL_SHAPES: every
    output of the forward and the backward bit-equal across three calls
    (one writer per element), each against its plain version (float32:
    ``F32_RTOL`` over ``F32_FLOOR`` of the output's scale; bf16: one bf16
    step of the scale plus ``GMM_ATOL``), then timed beside its plain
    version and its bound (operations 6 S d h forward, 16 S d h backward,
    over the float32 peak for float32 inputs and the bf16 peak for bf16
    ones, as the rows of phase 4 count them).  Inputs from their own
    generator.  Returns the timing rows by kernel."""
    KFM = M.KFM
    gen = torch.Generator(device=dev).manual_seed(40)
    L, E, k, h = GENERAL_L, GENERAL_E, GENERAL_K, GENERAL_H
    topk = (torch.rand(L, E, generator=gen, device=dev).argsort(1)[:, :k]
            .to(torch.int32).contiguous())
    disp = M.TR.build_dispatch(topk, E)
    S = disp.num_slots
    idx, off = disp.expert_token_indices, disp.expert_token_offsets
    tim = disp.token_index_map
    g = torch.rand(S, generator=gen, device=dev)
    rows = {"fused_moe_fwd": [], "fused_moe_bwd": []}
    for label, dtype, d in GENERAL_SHAPES:
        def randn(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device=dev)
                    * scale).to(dtype)
        x, dy = randn(L, d), randn(L, d)
        ws = (randn(E, d, h, scale=d ** -0.5), randn(E, d, h, scale=d ** -0.5),
              randn(E, h, d, scale=h ** -0.5))
        check(not KFM.tensor_core_path(x, ws, dy),
              f"general path [{label}]: the inputs take the tensor-core path")
        fwd = lambda: KFM.fused_moe_fwd(x, g, idx, off, *ws, tim)
        bwd = lambda: KFM.fused_moe_bwd(x, dy, g, idx, off, *ws, tim)
        got = [fwd(), *bwd()]
        for call in range(2):
            for out, a, b in zip(("y", "dx", "dgates", "dw1", "dw2", "dw3"),
                                 got, [fwd(), *bwd()]):
                check(torch.equal(a, b), f"fused_moe general path [{label}] "
                      f"{out}: a repeated call differs")
        want = [KFM.fused_moe_fwd_plain(x, g, idx, off, *ws),
                *KFM.fused_moe_bwd_plain(x, dy, g, idx, off, *ws)]
        rel = []
        for i, (out, a, b) in enumerate(zip(
                ("y", "dx", "dgates", "dw1", "dw2", "dw3"), got, want)):
            scale = float(b.abs().max())
            if dtype == torch.float32:
                rt, at = F32_RTOL, F32_FLOOR * scale
            else:
                rt, at = 0.0, FUSED_SCALE_STEP * scale + GMM_ATOL
            e = require_close(f"fused_moe general path [{label}] {out}", a, b,
                              rt, at)
            key = "fused_moe_fwd" if i == 0 else "fused_moe_bwd"
            errs[key] = max(errs[key], e)
            rel.append(round(e / max(scale, 1e-30), 8))
        hc_f = KFM.general_pass_width(S, h)
        hc_b = KFM.general_bwd_pass_width(S, h)
        n_f = len(KFM.h_ranges(h, hc_f))
        n_b = len(KFM.h_ranges(h, hc_b))
        log(f"parity fused_moe general path [{label}: L={L}, S={S}, d={d}, "
            f"h={h}]: max |err| / scale (y, dx, dgates, dw1, dw2, dw3) "
            f"{rel}; every output bit-equal over three calls; h-ranges "
            f"{n_f} forward, {n_b} backward")
        eb = x.element_size()
        rate = F32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
        shape = f"general path, {label}: L={L}, S={S}, d={d}, h={h}"
        w_bytes = 3 * E * d * h * eb
        rows["fused_moe_fwd"].append(entry(
            timer(fwd), timer(lambda: KFM.fused_moe_fwd_plain(
                x, g, idx, off, *ws), warm=1, reps=3),
            L * d * eb + S * 8 + w_bytes + L * d * 4, 6.0 * S * d * h, None,
            shape, launches=2 * n_f + 1, ops_per_s=rate))
        rows["fused_moe_bwd"].append(entry(
            timer(bwd), timer(lambda: KFM.fused_moe_bwd_plain(
                x, dy, g, idx, off, *ws), warm=1, reps=3),
            2 * L * d * eb + S * 8 + w_bytes + L * d * 4 + S * 4
            + 3 * E * d * h * 4, 16.0 * S * d * h, None, shape,
            launches=5 * n_b + 2, ops_per_s=rate))
        del x, dy, ws, got, want
    for name, rs in rows.items():
        for r in rs:
            log(f"time {name} [{r['shape']}]: {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), library {r['library_ms']}")
    return rows


# The frame and mixed paths (phases 41-45).  HuBERT-XLarge trains at all 48
# layers on 2 x 2048 frames (about 82 s of 20 ms frames); LLaVA-NeXT's
# forward takes 1 x 6144 positions (all 2880 anyres image slots and 3264
# text tokens), its decode B = 4 over a 64-token prompt and 16 greedy
# tokens, its training 2 x 4096 positions (2048 image slots each, by the
# reference's min(num_image_tokens, S // 2)) at 4 of 32 layers.
HUBERT_SEQ = 2048
LLAVA_PREFILL, LLAVA_TRAIN_SEQ, LLAVA_DECODE_NEW = 6144, 4096, 16
# The short inputs of the CPU cross-checks (phase 43): 64 frames; 48
# positions of which 24 image slots.
XCHECK_SEQ = {"frames": 64, "mixed": 48}
# Phase 41's flash-attention shapes (label, (B, S, H, Hkv, Dh, causal,
# dtype)) and LLaVA's FFN widths (d, h).  HuBERT's shape also in float32:
# the general kernel.
FRAMES_MIXED_FLASH = (
    ("hubert-xlarge training", (2, 2048, 16, 16, 80, False, BF16)),
    ("hubert-xlarge training, float32",
     (2, 2048, 16, 16, 80, False, torch.float32)),
    ("bidirectional, wgmma", (2, 2048, 32, 8, 128, False, BF16)),
    ("llava-next-mistral-7b prefill", (1, 6144, 32, 8, 128, True, BF16)),
    # bf16 widths off a multiple of 64, which the tensor cores take padded
    # to 64 or 128 inside the kernel; causal and not
    *((f"bf16 Dh {dh}{', causal' if causal else ''}",
       (2, 2048, 16, 16, dh, causal, BF16))
      for dh in (16, 48, 72, 96, 112) for causal in (True, False)))
LLAVA_FFN = (4096, 14336)


def frames_mixed_kernels(M, dev, timer, entry, errs) -> dict:
    """Phase 41: the kernels at the shapes the frame and mixed paths give
    them, each against its plain version and timed beside its bound,
    plain time and library time: flash attention without the causal mask
    at HuBERT-XLarge's training shape (B = 2, S = 2048, 16/16 heads of 80:
    the tensor cores in bf16, padded to 128; the general kernel in
    float32, beside SDPA in float32) and at 32/8 heads of 128 (the wgmma
    kernel's non-causal branch), causal at LLaVA-NeXT's prefill (B =
    1, S = 6144, 32/8 heads of 128), and at B = 2, S = 2048, 16/16 heads
    of 16, 48, 72, 96 and 112 in bf16, causal and not (widths the tensor
    cores take off a multiple of 64), each row naming the kernel that ran
    and its time over SDPA's; the fused-SwiGLU trio at LLaVA's widths
    (d = 4096, h = 14336) over the prefill's L = 6144 rows.  Returns the
    timing rows by kernel."""
    KF, KS = M.KF, M.KS
    g = torch.Generator(device=dev).manual_seed(41)

    def randn(*shape, dtype=BF16, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    rows = {n: [] for n in ("flash_attention", "fused_swiglu_fwd",
                            "fused_swiglu_bwd_x", "fused_swiglu_bwd_w")}
    for label, (B, S, H, Hkv, Dh, causal, dt) in FRAMES_MIXED_FLASH:
        q, k, v = (randn(B, S, n, Dh, dtype=dt) for n in (H, Hkv, Hkv))
        tensor_cores = KF.tensor_core_path(q, k, v)
        general = KF.flash_attention.general_launches
        got = KF.flash_attention(q, k, v, causal=causal)
        check(KF.flash_attention.general_launches
              == general + (not tensor_cores),
              f"flash_attention [{label}]: not the kernel tensor_core_path "
              "chose")
        check(torch.equal(got, KF.flash_attention(q, k, v, causal=causal)),
              f"flash_attention [{label}]: a repeated call differs")
        want = KF.flash_attention_plain(q, k, v, causal=causal, chunk=512)
        path = "tensor cores" if tensor_cores else "general kernel"
        shape = (f"{label}: B={B}, S={S}, {H}/{Hkv} heads of {Dh}, "
                 + ("causal" if causal else "causal=False") + f", {path}")
        if dt == torch.float32:
            e = require_close(f"flash_attention [{label}]", got, want,
                              F32_RTOL, F32_FLOOR)
            errs["flash_attention"] = max(errs["flash_attention"], e)
            log(f"parity flash_attention [{shape}]: max |err| {e:.4g} (rtol "
                f"{F32_RTOL}, atol {F32_FLOOR}); repeated call bit-equal")
        else:
            r = require_row_close(f"flash_attention [{label}]", got, want,
                                  FLASH_ROW_REL)
            errs["flash_attention"] = max(errs["flash_attention"],
                                          r["max_abs_err"])
            log(f"parity flash_attention [{shape}]: max |err| "
                f"{r['max_abs_err']:.4g}, max |o| {r['max_abs_o']:.4g}, mean "
                f"|o| {r['mean_abs_o']:.4g}, max |err| / (|o| + row mean "
                f"|o|) {r['max_ratio']:.4g} (bound {FLASH_ROW_REL:.4g}); "
                "repeated call bit-equal")
        row = flash_row(M, timer, entry, q, k, v, 0, shape, causal=causal)
        log(f"flash_attention [{shape}]: {row['ms']:.4f} ms on the "
            f"{path}, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"SDPA ({str(dt)[6:]}) {row['library_ms']:.4f} ms, "
            f"{row['ms'] / row['library_ms']:.2f}x SDPA's time, "
            f"{row['ms'] / row['bound_ms']:.1f}x the bound")
        rows["flash_attention"].append(row)
        del q, k, v, got, want
    (d, h), L = LLAVA_FFN, LLAVA_PREFILL
    w1, w2 = randn(d, h, scale=d ** -0.5), randn(d, h, scale=d ** -0.5)
    x, dy = randn(L, d), randn(L, h)
    got = list(KS.fused_swiglu_fwd(x, w1, w2))
    check(all(torch.equal(a, b) for a, b in zip(
        got, KS.fused_swiglu_fwd(x, w1, w2))),
        "fused_swiglu [llava]: repeated forward differs")
    want = list(KS.fused_swiglu_fwd_plain(x, w1, w2))
    a, b = got[1], got[2]
    got.append(KS.fused_swiglu_bwd_x(dy, a, b, w1, w2))
    want.append(KS.fused_swiglu_bwd_x_plain(dy, a, b, w1, w2))
    got += KS.fused_swiglu_bwd_w(x, dy, a, b)
    want += KS.fused_swiglu_bwd_w_plain(x, dy, a, b)
    rel = []
    for key, out, g_, w_ in zip(
            ("fused_swiglu_fwd",) * 3 + ("fused_swiglu_bwd_x",)
            + ("fused_swiglu_bwd_w",) * 2,
            ("y", "a", "b", "dx", "dw1", "dw2"), got, want):
        scale = float(w_.float().abs().max())
        e = require_close(f"fused_swiglu [llava L={L}] {out}", g_, w_, 0.0,
                          FUSED_SCALE_STEP * scale + GMM_ATOL)
        errs[key] = max(errs[key], e)
        rel.append(round(e / max(scale, 1e-30), 6))
    log(f"parity fused_swiglu [llava-next-mistral-7b: L={L}, d={d}, h={h}]: "
        f"max |err| / scale (y, a, b, dx, dw1, dw2) {rel}; repeated forward "
        "bit-equal")
    del x, dy, got, want, a, b
    for name, rs in swiglu_rows(M, timer, entry, w1, w2, randn,
                                (("prefill", L),),
                                tag="llava-next-mistral-7b ").items():
        rows[name].extend(rs)
    del w1, w2
    for name, rs in rows.items():
        for r in rs:
            log(f"time {name} [{r['shape']}]: {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), library {r['library_ms']}")
    return rows


def cpu_forward_crosscheck(T, cfg, params, dev) -> dict:
    """Phase 43: a short batch of the config's input kind
    (``synthesize_batch``, seed 5: XCHECK_SEQ positions) through the same
    weights on the card and copied to the CPU (plain versions there): the
    forward's logits at every position must agree within
    ``CPU_LOGIT_ATOL``, and the last position's argmax, unless the card's
    top two lie within the tolerance of each other."""
    from repro_torch.data.pipeline import synthesize_batch
    from repro_torch.train.loop import batch_to_device
    batch = synthesize_batch(cfg, 1, XCHECK_SEQ[cfg.input_kind], seed=5)
    cpu = torch.device("cpu")
    with torch.inference_mode():
        card = T.forward(params, batch_to_device(batch, dev), cfg)[0]
        card = card.float().cpu()
        cpu_params = _to_device(params, cpu)
        torch.set_num_threads(8)
        t0 = time.perf_counter()
        on_cpu = T.forward(cpu_params, batch_to_device(batch, cpu),
                           cfg)[0].float()
        cpu_s = time.perf_counter() - t0
    del cpu_params
    check(bool(torch.isfinite(card).all()), "card logits not finite")
    diff = float((card - on_cpu).abs().max())
    top2 = torch.topk(card[0, -1], 2).values
    gap = float(top2[0] - top2[1])
    tok_card, tok_cpu = int(card[0, -1].argmax()), int(on_cpu[0, -1].argmax())
    log(f"cpu cross-check [{cfg.name}, {cfg.num_layers} layers, forward over "
        f"{card.shape[1]} positions]: max |logit diff| {diff:.4g} (tol "
        f"{CPU_LOGIT_ATOL}), max |logit| {float(card.abs().max()):.3f}, last "
        f"position argmax card {tok_card} / cpu {tok_cpu}, card top-2 gap "
        f"{gap:.4g}, cpu forward {cpu_s:.1f} s")
    check(diff <= CPU_LOGIT_ATOL, "CPU and card logits disagree")
    check(tok_card == tok_cpu or gap <= CPU_LOGIT_ATOL,
          "CPU and card argmax differ beyond a near tie")
    return {"max_logit_diff": diff, "argmax_card": tok_card,
            "argmax_cpu": tok_cpu, "top2_gap": gap, "cpu_s": cpu_s,
            "positions": int(card.shape[1])}


def llava_forward_phase(M, cfg, params, dev, K) -> dict:
    """Phase 43: ``forward`` with ``last_only`` over one LLAVA_PREFILL
    mixed input (``synthesize_batch``, seed 0: every image slot and the
    text after them) at the config's depth, cold, then warm (timed:
    tokens/s, peak; flash attention and the fused SwiGLU forward launched
    once a layer), then under torch.profiler (device busy share); the
    logits finite and the same in all three runs."""
    from repro_torch.data.pipeline import synthesize_batch
    from repro_torch.train.loop import batch_to_device
    T = M.T
    batch = batch_to_device(synthesize_batch(cfg, 1, LLAVA_PREFILL), dev)
    n_img = batch["image_embeds"].shape[1]

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            lg = T.forward(params, batch, cfg, last_only=True)[0]
        torch.cuda.synchronize()
        return lg, time.perf_counter() - t0

    cold, cold_s = run()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    warm, warm_s = run()
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced, traced_s = run()
    busy = sum(_device_time_by_kernel(prof).values()) / 1e6
    check(cold.shape == (1, 1, cfg.vocab_size), "forward: logits shape")
    check(bool(torch.isfinite(warm).all()), "forward: logits not finite")
    check(torch.equal(cold, warm) and torch.equal(warm, traced),
          "forward: the cold, warm and traced runs differ")
    n = cfg.num_layers
    for name in ("flash_attention", "fused_swiglu_fwd"):
        check(launches[name] == n, f"forward [{cfg.name}]: {name} launched "
              f"{launches[name]} times, expected {n} (one a layer)")
    tps = LLAVA_PREFILL / warm_s
    log(f"forward [{cfg.name}, {n} layers, last_only]: 1 x {LLAVA_PREFILL} "
        f"positions ({n_img} image slots, {LLAVA_PREFILL - n_img} text "
        f"tokens) in {warm_s:.4f} s warm ({tps:.1f} tokens/s; cold "
        f"{cold_s:.3f} s); traced wall {traced_s:.4f} s, device busy "
        f"{busy:.4f} s ({100 * busy / traced_s:.1f}%); peak memory "
        f"{peak / 2 ** 30:.3f} GiB; launches {launches}; argmax "
        f"{int(warm.argmax())}")
    return {"tokens_per_s": tps, "forward_s": warm_s, "cold_s": cold_s,
            "busy_s": busy, "traced_wall_s": traced_s, "peak_bytes": peak,
            "launches": launches, "image_slots": n_img,
            "positions": LLAVA_PREFILL}


def _device_time_by_kernel(prof) -> dict[str, float]:
    """Device time (us) of each device kernel, copy and fill in a profiler
    trace, read from the trace that ``export_chrome_trace`` writes
    (building the profiler's per-event Python objects for
    ``key_averages`` took a minute for a serving trace of Gemma2-27B's
    ~170,000 kernels); the training step's named spans are annotations,
    not kernels."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    out = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_EVENT_CATS:
            out[ev["name"]] = out.get(ev["name"], 0.0) + float(ev["dur"])
    return out


#: The trace categories of device work: kernels, copies and fills.
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


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


def _clone_cache(tree):
    """A copy of a decode cache (lists of tuples and named tuples of
    tensors)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone_cache(t) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_cache(t) for t in tree)
    return tree


def _to_device(tree, device):
    return _map_leaves(tree, lambda t: t.detach().to(device, copy=True))


if __name__ == "__main__":
    sys.exit(main())
