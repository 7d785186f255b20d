"""Interleaved A/B of kernel times across checkouts.

Times kernels at their training shapes with each checkout's kernels, so
that two commits can be compared on one card in one call: a kernel's
reading moves between smoke runs of the same code by more than the 5%
that a row is held to.  Inputs are bf16 from seed 0:

- ``fused_swiglu_bwd_x``: Qwen3-14B, L = 4096, d = 5120, h = 17408 (a
  and b from the checkout's own ``fused_swiglu_fwd``);
- ``fused_swiglu_fwd``: Qwen3-14B's widths at training (L = 4096),
  prefill (L = 2048) and decode (L = 4, and L = 16 and 64 on either side
  of the split plan's limit);
- ``combine``: Mixtral-8x7B's width (d = 4096), top-2 of 8 experts from a
  random gate, at prefill (L = 2048, S = 4096) and decode (L = 4, S = 8);
- ``flash_attention``: B = 2, S = 2048, 32/8 heads of 128 (Mixtral) and
  40/8 (Qwen3-14B), causal, window 4096;
- ``fused_moe_fwd`` and ``fused_moe_bwd``: Mixtral-8x7B (d = 4096, h =
  14336, top-2 of 8 experts) and Qwen3-30B-A3B (d = 2048, h = 768, top-8
  of 128 experts), each at training (2 x 2048 tokens) and decode (4
  tokens), experts from a random gate;
- ``gather_gmm``: Mixtral's routing and weights, each instantiation as the
  training step calls it (the dual branch with ``save_ab``, the w3
  forward over identity rows, the backward's w3ᵀ and w1ᵀ), and the dual
  branch at serving's prefill (4 x 512 tokens) and decode (4 tokens);
- ``fused_swiglu_bwd_w``: Qwen3-14B at ``fused_swiglu_bwd_x``'s shape;
- ``gmm_dw``: the same routing, dw1 (gathered x rows against a (S, h) da)
  and dw3 (a (S, h) g·y_swi against the gathered dy rows);
- ``build_dispatch``: ``chip_smoke.DISPATCH_SHAPES`` (decode to the
  paper's Table-1 sizes, both sides of the one-launch limit), top-k of
  uniform random scores;
- ``gather_rows``: ``ep_a2a``'s send buffers at Mixtral's width (d =
  4096, bf16): one rank's (2 x 2048 tokens, N = 8192 rows) and one rank's
  of four (a 1024-token chunk packed by destination at capacity 2.0,
  about half the rows pads), each beside ``index_select`` on the clamped
  ids (which leaves the pads unzeroed) in the same process.

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
           "gather_gmm", "fused_swiglu_bwd_w", "fused_moe_bwd", "gmm_dw",
           "fused_swiglu_fwd", "combine", "build_dispatch", "gather_rows")
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
        if name == "fused_swiglu_fwd":
            return [(f"{label}: L={n}, d={d}, h={h}",
                     lambda n=n: KS.fused_swiglu_fwd(x[:n], w1, w2))
                    for label, n in (("training", L), ("prefill", 2048),
                                     ("decode", 4), ("decode", 16),
                                     ("decode", 64))]
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
    if name == "build_dispatch":
        from chip_smoke import DISPATCH_SHAPES, random_topk
        from repro_torch.kernels import dispatch as KD
        out = []
        for label, L, k, E in DISPATCH_SHAPES:
            topk = random_topk(L, k, E, gen)
            out.append((f"{label}: L={L}, k={k}, E={E}, n={L * k}",
                        lambda topk=topk, E=E: KD.build_dispatch(topk, E)))
        return out
    if name == "gather_rows":
        from types import SimpleNamespace

        from repro_torch.core.memsim import _a2a_capacity
        from repro_torch.kernels import gather_rows as KR
        from repro_torch.models.moe_block import _a2a_pack
        d, k, E, n, Lc = 4096, 2, 8, 4, 1024
        src1 = randn(4096, d)
        ids1 = (torch.arange(8192, device=dev) // k).to(torch.int32)
        from chip_smoke import random_topk
        dest = (random_topk(Lc, k, E, gen) // (E // n)).reshape(-1)
        C = _a2a_capacity(SimpleNamespace(moe_a2a_capacity=2.0), Lc * k, n)
        src_of_slot, slot_ok, *_ = _a2a_pack(dest, n, C)
        ids4 = torch.where(slot_ok, src_of_slot // k, -1).to(torch.int32)
        src4 = randn(Lc, d)
        out = []
        for label, src, ids in (
                (f"n=1 send buffer: L=4096, N={ids1.numel()}", src1, ids1),
                (f"n=4 rank send buffer: Lc={Lc}, C={C}, N={ids4.numel()}",
                 src4, ids4)):
            lib_ids = ids.clamp_min(0)
            out += [(label, lambda src=src, ids=ids: KR.gather_rows(src, ids)),
                    (label + ", index_select",
                     lambda src=src, ids=lib_ids: torch.index_select(
                         src, 0, ids))]
        return out
    from repro_torch.core import routing
    if name in ("fused_moe_fwd", "fused_moe_bwd"):
        return fused_moe_cases(name, dev, randn, gen)
    L, d, h, E = 4096, 4096, 14336, 8
    if name == "combine":
        from repro_torch.kernels import combine as KC
        wg = randn(d, E)
        out = []
        for label, n in (("prefill", 2048), ("decode", 4)):
            tim = routing.build_dispatch(routing.top_k_gating(
                randn(n, d), wg, 2).topk_experts.contiguous(),
                E).token_index_map
            p, g = randn(2 * n, d), randn(n, 2)
            out.append((f"{label}: L={n}, S={2 * n}, d={d}, k=2",
                        lambda p=p, tim=tim, g=g: KC.combine(p, tim, g)))
        return out
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


def fused_moe_cases(name: str, dev, randn, gen):
    """The fused MoE forward or backward at each model's training and
    decode shapes, the token map passed as the training path passes it
    where the checkout's kernel takes one."""
    import inspect

    import torch

    from repro_torch.core import routing
    from repro_torch.kernels import fused_moe as FM
    fn = getattr(FM, name)
    takes_tim = "tim" in inspect.signature(fn).parameters
    out = []
    for model, d, h, E, k in (("mixtral-8x7b", 4096, 14336, 8, 2),
                              ("qwen3-moe-30b-a3b", 2048, 768, 128, 8)):
        x, dy = randn(4096, d), randn(4096, d)
        w1 = randn(E, d, h, scale=d ** -0.5)
        w2 = randn(E, d, h, scale=d ** -0.5)
        w3 = randn(E, h, d, scale=h ** -0.5)
        wg = randn(d, E)
        for label, n in (("training", 4096), ("decode", 4)):
            ds = routing.build_dispatch(routing.top_k_gating(
                x[:n], wg, k).topk_experts.contiguous(), E)
            S = ds.num_slots
            g_slot = torch.rand(S, generator=gen, device=dev)
            args = (x[:n], g_slot) if name == "fused_moe_fwd" else \
                (x[:n], dy[:n], g_slot)
            args += (ds.expert_token_indices, ds.expert_token_offsets,
                     w1, w2, w3)
            kw = {"tim": ds.token_index_map} if takes_tim else {}
            out.append((f"{model} {label}: L={n}, S={S}, d={d}, h={h}, "
                        f"E={E}", lambda args=args, kw=kw: fn(*args, **kw)))
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
