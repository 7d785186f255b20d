"""Interleaved A/B of kernel times across checkouts.

Times kernels at their training shapes with each checkout's kernels, so
that two commits can be compared on one card in one call: a kernel's
reading moves between smoke runs of the same code by more than the 5%
that a row is held to.  Inputs are bf16 from seed 0:

- ``fused_swiglu_bwd_x``: Qwen3-14B, L = 4096, d = 5120, h = 17408 (a
  and b from the checkout's own ``fused_swiglu_fwd``);
- ``flash_attention``: B = 2, S = 2048, 32/8 heads of 128 (Mixtral) and
  40/8 (Qwen3-14B), causal, window 4096;
- ``fused_moe_fwd``: Mixtral-8x7B, 2 x 2048 tokens, d = 4096, h = 14336,
  top-2 of 8 experts from a random gate;
- ``gather_gmm``: the same routing and weights, each instantiation as the
  training step calls it (the dual branch with ``save_ab``, the w3
  forward over identity rows, the backward's w3ᵀ and w1ᵀ), and the dual
  branch at serving's prefill (4 x 512 tokens) and decode (4 tokens);
- ``fused_swiglu_bwd_w``: Qwen3-14B at ``fused_swiglu_bwd_x``'s shape;
- ``fused_moe_bwd``: ``fused_moe_fwd``'s routing and weights, at the
  training shape and at decode (4 tokens, 8 slots);
- ``gmm_dw``: the same routing, dw1 (gathered x rows against a (S, h) da)
  and dw3 (a (S, h) g·y_swi against the gathered dy rows).

    python tools/kernel_ab.py TREE_A TREE_B [--kernels a,b] [--rounds 4]

One process per (round, tree), the trees in the order A B B A A B ...
Every checkout is built first, in parallel.  Each process reports, per
kernel, the median of ``--reps`` runs (``chip_smoke.Timer`` of this
checkout: L2 flushed before each run).  The last line of the output is
a JSON summary with the card, every reading per kernel and tree, and
their medians.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ("fused_swiglu_bwd_x", "flash_attention", "fused_moe_fwd",
           "gather_gmm", "fused_swiglu_bwd_w", "fused_moe_bwd", "gmm_dw")
TAG = "KERNEL_AB "


def cases(name: str, dev):
    """``(label, fn)`` pairs timing kernel ``name``."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    if name.startswith("fused_swiglu"):
        from repro_torch.kernels import fused_swiglu as KS
        L, d, h = 4096, 5120, 17408
        x, dy = randn(L, d), randn(L, h)
        w1, w2 = randn(d, h, scale=d ** -0.5), randn(d, h, scale=d ** -0.5)
        _, a, b = KS.fused_swiglu_fwd(x, w1, w2)
        if name == "fused_swiglu_bwd_w":
            return [(f"L={L}, d={d}, h={h}",
                     lambda: KS.fused_swiglu_bwd_w(x, dy, a, b))]
        return [(f"L={L}, d={d}, h={h}",
                 lambda: KS.fused_swiglu_bwd_x(dy, a, b, w1, w2))]
    if name == "flash_attention":
        from repro_torch.kernels import flash_attention as KF
        k, v = randn(2, 2048, 8, 128), randn(2, 2048, 8, 128)
        out = []
        for H in (32, 40):
            q = randn(2, 2048, H, 128)
            out.append((f"B=2, S=2048, {H}/8 heads of 128", (
                lambda q=q: KF.flash_attention(q, k, v, causal=True,
                                               window=4096))))
        return out
    from repro_torch.core import routing
    L, d, h, E = 4096, 4096, 14336, 8
    x = randn(L, d)
    w1, w2 = randn(E, d, h, scale=d ** -0.5), randn(E, d, h, scale=d ** -0.5)
    w3 = randn(E, h, d, scale=h ** -0.5)
    wg = randn(d, E)

    def route(rows):
        disp = routing.build_dispatch(routing.top_k_gating(
            rows, wg, 2).topk_experts.contiguous(), E)
        return disp, disp.expert_token_indices, disp.expert_token_offsets

    disp, idx, off = route(x)
    S = disp.num_slots
    if name == "fused_moe_fwd":
        from repro_torch.kernels import fused_moe as FM
        g_slot = torch.rand(S, generator=gen, device=dev)
        return [(f"L={L}, S={S}, d={d}, h={h}, E={E}",
                 lambda: FM.fused_moe_fwd(x, g_slot, idx, off, w1, w2, w3))]
    if name == "fused_moe_bwd":
        from repro_torch.kernels import fused_moe as FM
        dy = randn(L, d)
        out = []
        for label, n in (("training", L), ("decode", 4)):
            ds, ids, offs = (disp, idx, off) if n == L else route(x[:n])
            g_slot = torch.rand(ds.num_slots, generator=gen, device=dev)
            out.append((f"{label}: L={n}, S={ds.num_slots}, d={d}, h={h}",
                        lambda n=n, g_slot=g_slot, ids=ids, offs=offs:
                        FM.fused_moe_bwd(x[:n], dy[:n], g_slot, ids, offs,
                                         w1, w2, w3)))
        return out
    if name == "gmm_dw":
        from repro_torch.kernels import gmm_dw as KW
        xg = x[idx.long()]
        dyg = randn(L, d)[idx.long()]
        da, yg = randn(S, h, scale=0.05), randn(S, h)
        return [(f"training dw1: S={S}, {d}x{h} per expert, E={E}",
                 lambda: KW.gmm_dw(xg, da, off)),
                (f"training dw3: S={S}, {h}x{d} per expert, E={E}",
                 lambda: KW.gmm_dw(yg, dyg, off))]
    from repro_torch.kernels import gather_gmm as KG
    y_swi, dyg, da = randn(S, h), randn(S, d), randn(S, h, scale=0.05)
    out = [
        (f"training dual + save_ab: S={S}, {d}->{h}",
         lambda: KG.gather_gmm(x, idx, off, w1, w2, save_ab=True)),
        (f"training w3 forward: S={S}, {h}->{d}",
         lambda: KG.gather_gmm(y_swi, None, off, w3, epilogue=False)),
        (f"training w3^T: S={S}, {d}->{h}",
         lambda: KG.gather_gmm(dyg, None, off, w3, epilogue=False,
                               trans_w=True)),
        (f"training w1^T: S={S}, {h}->{d}",
         lambda: KG.gather_gmm(da, None, off, w1, epilogue=False,
                               trans_w=True))]
    for label, n in (("prefill", 2048), ("decode", 4)):
        xs = x[:n]
        ds, ids, offs = route(xs)
        out.append((f"{label} dual: S={ds.num_slots}, {d}->{h}",
                    lambda xs=xs, ids=ids, offs=offs:
                    KG.gather_gmm(xs, ids, offs, w1, w2)))
    return out


def child(tree: str, kernels: list[str], reps: int) -> None:
    sys.path[:0] = [str(Path(tree).resolve() / "src"), str(ROOT)]
    import torch

    import repro_torch
    from chip_smoke import Timer

    assert Path(repro_torch.__file__).resolve().is_relative_to(
        Path(tree).resolve()), repro_torch.__file__
    dev = torch.device("cuda")
    timer = Timer(dev)
    ms = {}
    for name in kernels:
        for label, fn in cases(name, dev):
            ms[f"{name} [{label}]"] = timer(fn, reps=reps)
        torch.cuda.empty_cache()
    print(TAG + json.dumps({"tree": tree, "ms": ms}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        ap.error(f"--kernels: choose from {KERNELS}")
    if args.child:
        child(args.trees[0], kernels, args.reps)
        return 0
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import _lib; _lib.lib()",
         str(Path(t).resolve() / "src")]) for t in args.trees]
    if any(p.wait() for p in builds):
        print("kernel_ab: a checkout's kernels did not build", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    results: dict[str, dict[str, list[float]]] = {}
    for r in range(args.rounds):
        for tree in args.trees if r % 2 == 0 else args.trees[::-1]:
            proc = subprocess.run(
                [sys.executable, __file__, "--child", tree, "--kernels",
                 args.kernels, "--reps", str(args.reps)],
                capture_output=True, text=True, timeout=600)
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith(TAG)]
            if proc.returncode or not lines:
                print(proc.stdout[-4000:], proc.stderr[-4000:],
                      file=sys.stderr)
                return 1
            for key, ms in json.loads(lines[-1][len(TAG):])["ms"].items():
                results.setdefault(key, {t: [] for t in args.trees})
                results[key][tree].append(ms)
                print(f"round {r} {tree}: {key} {ms} ms", flush=True)
    print(json.dumps({"card": card, "ms": results, "median_ms": {
        key: {t: statistics.median(v) for t, v in trees.items()}
        for key, trees in results.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
