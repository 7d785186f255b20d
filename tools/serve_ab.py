"""Interleaved A/B of a serving phase of ``chip_smoke.py`` across checkouts.

Serves the requests of ``chip_smoke.py``'s serving phases (4 slots,
capacity 1024, 16-token pages; prompts of 37, 129, 300, 511 and 64
tokens, 16 new tokens each, from seed 0) with the engine of each
checkout given, and reports the seconds spent in prefill calls and in
decode steps (each timed between two device syncs, as the smoke does)
for every run.  ``--arch qwen3-14b`` (the default) is phase 16: 40
layers, random bf16 weights from seed 0, ``use_pallas=True``, on bf16
and on int8 KV pages.  ``--arch mixtral-8x7b`` is phase 5: full width,
the depth cut to 2 layers, ``moe_impl="blaze_pallas"``, bf16 pages.

    python tools/serve_ab.py TREE_A TREE_B [--arch qwen3-14b] [--rounds 4]
        [--runs 3] [--out chiprun_out/serve_ab.json]

One process per (round, tree), the trees in the order A B B A A B ...,
so that a drift of the host's speed falls on both alike.  Each process
builds its checkout's kernels (all checkouts are built first, in
parallel), serves once cold on each pool, then makes ``--runs``
measured runs on each pool, alternating the pools, then one run on each
pool traced with torch.profiler (its wall seconds and the device's busy
seconds: the kernels' self device time).  The last line of the output
is a JSON summary: per tree and pool, every run's decode seconds, their
median and mean, the decode tokens per second at the median, the
prefill seconds' median and the traced runs' busy seconds and wall
seconds.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

PROMPT_LENS = (37, 129, 300, 511, 64)
POOLS = {"qwen3-14b": ("model", "int8"), "mixtral-8x7b": ("model",)}
TAG = "SERVE_AB "


def child(tree: str, arch: str, runs: int) -> None:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import numpy as np
    import torch

    import repro_torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.interop import init_params
    from repro_torch.kernels import _lib
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as SE

    assert Path(repro_torch.__file__).resolve().is_relative_to(
        Path(tree).resolve()), repro_torch.__file__
    _lib.lib()
    dev = torch.device("cuda")
    cfg = (get_config(arch).replace(use_pallas=True) if arch == "qwen3-14b"
           else get_config(arch).replace(num_layers=2, dtype="bfloat16",
                                         moe_impl="blaze_pallas"))
    pools = POOLS[arch]
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    spent = {"prefill": 0.0, "decode": 0.0}

    def timed(kind, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[kind] += time.perf_counter() - t0
            return out
        return run

    T.prefill = timed("prefill", T.prefill)
    T.paged_decode_step = timed("decode", T.paged_decode_step)

    def serve(pool):
        spent["prefill"] = spent["decode"] = 0.0
        K.reset_launches()
        eng = SE.ServeEngine(cfg, params, batch_slots=4, capacity=1024,
                             page_size=16, device=dev,
                             kv_dtype=None if pool == "model" else pool)
        reqs = [SE.Request(prompt=p, max_new_tokens=16,
                           eos_id=cfg.vocab_size) for p in prompts]
        eng.generate(reqs)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        return {"pool": pool, "prefill_s": spent["prefill"],
                "decode_s": spent["decode"],
                "prefill_tokens": eng.stats["prefill_tokens"],
                "decode_slot_tokens": eng.stats["decode_slot_tokens"],
                "decode_steps": eng.stats["decode_steps"],
                "paged_launches": launches["paged_attention"]
                + launches["paged_attention_int8"]}

    for pool in pools:                              # cold runs
        serve(pool)
    out = [serve(pool) for _ in range(runs) for pool in pools]
    from torch.profiler import ProfilerActivity, profile
    traced = []
    for pool in pools:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            serve(pool)
            wall = time.perf_counter() - t0
        busy = sum(ev.self_device_time_total for ev in prof.key_averages()
                   if ev.device_type.name == "CUDA") / 1e6
        traced.append({"pool": pool, "busy_s": busy, "wall_s": wall})
    print(TAG + json.dumps({"tree": tree, "runs": out, "traced": traced}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--arch", choices=sorted(POOLS), default="qwen3-14b")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.trees[0], args.arch, args.runs)
        return 0
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import _lib; _lib.lib()",
         str(Path(t).resolve() / "src")]) for t in args.trees]
    if any(p.wait() for p in builds):
        print("serve_ab: a checkout's kernels did not build", file=sys.stderr)
        return 1
    pools = POOLS[args.arch]
    results = {t: {pool: [] for pool in pools} for t in args.trees}
    traced = {t: {pool: [] for pool in pools} for t in args.trees}
    for r in range(args.rounds):
        order = args.trees if r % 2 == 0 else args.trees[::-1]
        for tree in order:
            proc = subprocess.run(
                [sys.executable, __file__, "--child", tree, "--arch",
                 args.arch, "--runs", str(args.runs)],
                capture_output=True, text=True,
                timeout=600)
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith(TAG)]
            if proc.returncode or not lines:
                print(proc.stdout[-4000:], proc.stderr[-4000:],
                      file=sys.stderr)
                return 1
            rec = json.loads(lines[-1][len(TAG):])
            for run in rec["runs"]:
                results[tree][run["pool"]].append(run)
                print(f"round {r} {tree} {run['pool']}: decode "
                      f"{run['decode_s']} s, prefill {run['prefill_s']} s, "
                      f"paged launches {run['paged_launches']}", flush=True)
            for run in rec["traced"]:
                traced[tree][run["pool"]].append(run)
                print(f"round {r} {tree} {run['pool']} traced: busy "
                      f"{run['busy_s']} s of {run['wall_s']} s", flush=True)
    summary = {}
    for tree, pools in results.items():
        for pool, runs in pools.items():
            dec = [x["decode_s"] for x in runs]
            med = statistics.median(dec)
            summary[f"{tree} [{pool}]"] = {
                "decode_s": dec, "decode_s_median": med,
                "decode_s_mean": statistics.fmean(dec),
                "decode_tok_per_s_at_median":
                    runs[0]["decode_slot_tokens"] / med,
                "prefill_s_median": statistics.median(
                    x["prefill_s"] for x in runs),
                "prefill_tok_per_s_at_median":
                    runs[0]["prefill_tokens"] / statistics.median(
                        x["prefill_s"] for x in runs),
                "traced_busy_s": [x["busy_s"] for x in traced[tree][pool]],
                "traced_wall_s": [x["wall_s"] for x in traced[tree][pool]]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"arch": args.arch, "results": results, "traced": traced,
             "summary": summary}, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
