"""Times the bf16 fused MoE forward or backward at Mixtral-8x7B's training
shape for several h-range widths.

``kernels/fused_moe.py:pass_width`` picks the width ``hc`` of the ranges
the forward walks: the widest whose bf16 ``(S, hc)`` chunk fits 32 MiB
(2048 at S = 8192); ``bwd_pass_width`` picks the backward's, whose three
bf16 ``(S, hc)`` chunks (da, db, g·y_swi) fit 64 MiB (1280 at S = 8192).
A wider range means fewer passes, so fewer float32 reductions into the
scattered output (y or dx) and fewer launches, and a larger workspace.
This script calls the kernel's C entry with each width given, on the same
inputs as ``chip_smoke.py``'s training shape (2 x 2048 tokens of
Mixtral-8x7B's width, top-2 of 8 experts from a random gate, seed 0), and
reports for each width the call's median time (``chip_smoke.Timer``: L2
flushed before each run), the device time of each kernel per call from
``torch.profiler``, and the largest error against the plain version
relative to its scale (for the backward, over its five outputs).

    python tools/fused_moe_ranges.py [--direction fwd|bwd]
                                     [--widths 512,1024,2048,3584,14336]

The last line of the output is a JSON list of the readings.  Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
L, D, H, E, K = 4096, 4096, 14336, 8, 2


KERNELS = ("moe_up_wgmma", "moe_down_wgmma", "moe_bwd_up_wgmma",
           "moe_dw_wgmma", "sum_dgates")


def kernel_ms(fn, calls: int = 3) -> dict[str, float]:
    """Device ms per call of each of the call's kernels (by name, template
    arguments included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if any(name in ev.key for name in KERNELS):
            out[ev.key] = ev.device_time_total / 1e3 / calls
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--direction", choices=("fwd", "bwd"), default="fwd")
    ap.add_argument("--widths", default=None,
                    help="default 512,1024,2048,3584,14336 forward, "
                         "640,1024,1280,2048,2688 backward")
    args = ap.parse_args()
    widths = args.widths or ("512,1024,2048,3584,14336"
                             if args.direction == "fwd"
                             else "640,1024,1280,2048,2688")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from chip_smoke import Timer
    from repro_torch.core import routing
    from repro_torch.kernels import _lib
    from repro_torch.kernels import fused_moe as FM

    if not torch.cuda.is_available():
        print("fused_moe_ranges: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    x = randn(L, D)
    w1, w2 = randn(E, D, H, scale=D ** -0.5), randn(E, D, H, scale=D ** -0.5)
    w3 = randn(E, H, D, scale=H ** -0.5)
    disp = routing.build_dispatch(
        routing.top_k_gating(x, randn(D, E), K).topk_experts.contiguous(), E)
    idx, off = disp.expert_token_indices, disp.expert_token_offsets
    S = disp.num_slots
    g_slot = torch.rand(S, generator=gen, device=dev)
    timer = Timer(dev)
    lib = _lib.lib()
    code = _lib.DTYPE_CODE[x.dtype]
    stream = _lib.stream_ptr(x)
    f32 = dict(dtype=torch.float32, device=dev)
    if args.direction == "fwd":
        want = [FM.fused_moe_fwd_plain(x, g_slot, idx, off, w1, w2, w3)]
        outs = [torch.empty(L, D, **f32)]
        planned, n_chunks = FM.pass_width(S, H), 1
    else:
        dy = randn(L, D)
        want = FM.fused_moe_bwd_plain(x, dy, g_slot, idx, off, w1, w2, w3)
        outs = [torch.empty_like(t) for t in want]
        part = torch.empty(-(-H // FM.H_TILE), S, **f32)
        planned, n_chunks = FM.bwd_pass_width(S, H), 3
    ys = torch.zeros(S, D, **f32)          # the per-slot float32 buffer
    tim = disp.token_index_map
    readings = []
    for hc in (int(w) for w in widths.split(",")):
        chunk = torch.empty(n_chunks, S, hc, dtype=torch.bfloat16,
                            device=dev)

        def run():
            outs[0].zero_()
            ys.zero_()
            if args.direction == "fwd":
                rc = lib.repro_fused_moe_fwd(
                    code, x.data_ptr(), g_slot.data_ptr(), idx.data_ptr(),
                    off.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                    w3.data_ptr(), outs[0].data_ptr(), chunk.data_ptr(), hc,
                    S, L, D, H, E, ys.data_ptr(), tim.data_ptr(),
                    tim.shape[1], stream)
            else:
                rc = lib.repro_fused_moe_bwd(
                    code, x.data_ptr(), dy.data_ptr(), g_slot.data_ptr(),
                    idx.data_ptr(), off.data_ptr(), w1.data_ptr(),
                    w2.data_ptr(), w3.data_ptr(),
                    *(t.data_ptr() for t in outs), chunk.data_ptr(),
                    part.data_ptr(), hc, S, L, D, H, E, ys.data_ptr(),
                    tim.data_ptr(), tim.shape[1], stream)
            _lib.check(f"repro_fused_moe_{args.direction}", rc)

        run()
        torch.cuda.synchronize()
        err = max(float((o - w).abs().max()) / float(w.abs().max())
                  for o, w in zip(outs, want))
        rec = {"hc": hc, "passes": len(FM.h_ranges(H, hc)),
               "chunk_mib": n_chunks * S * hc * 2 / 2 ** 20,
               "planned": hc == planned, "ms": timer(run),
               "kernels_ms": kernel_ms(run), "max_err_over_scale": err}
        print(json.dumps(rec), flush=True)
        readings.append(rec)
        del chunk
    print(json.dumps({"card": card, "S": S, "direction": args.direction,
                      "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
