"""``python -m repro_torch.bench`` — run the tracked benchmark suites and/or
gate against baselines.

    python -m repro_torch.bench --small                 # run + write baselines
    python -m repro_torch.bench --small --check         # run + fail on regression
    python -m repro_torch.bench --check --record r.json # gate a pre-built record
    python -m repro_torch.bench --small --device cpu    # the plain versions

The counterpart of ``repro/bench/cli.py``, with its flags, its four
same-run gate blocks and its exit codes, plus ``--device`` (default: the
card).  Default mode writes ``BENCH_kernels.json`` / ``BENCH_memory.json``
/ ``BENCH_serving.json`` to ``--baseline-dir`` (``build/bench_torch/``,
which git ignores: the ``BENCH_*.json`` at the repo root are the
reference's baselines).  ``--check`` never rewrites baselines: it runs the
suites (or loads ``--record``), compares entry-by-entry against the
baseline files, prints a report, and exits 1 on any gated regression.
``--out-dir`` additionally saves the freshly measured records.
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.bench import record as R

_BASELINE_DIR = os.path.join(R.REPO_ROOT, "build", "bench_torch")


def _run_suite(suite: str, small: bool, device) -> dict:
    if suite == "kernels":
        from repro_torch.bench.timing import kernels_suite
        entries = kernels_suite(small=small, device=device)
    elif suite == "memory":
        from repro_torch.bench.memory import memory_suite
        entries = memory_suite(small=small, device=device)
    elif suite == "serving":
        from repro_torch.bench.serving import serving_suite
        entries = serving_suite(small=small, device=device)
    else:
        raise ValueError(suite)
    return R.make_record(suite, entries, config={"small": small},
                         device=device)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--suite", default="all",
                    choices=["all", "kernels", "memory", "serving"])
    ap.add_argument("--small", action="store_true",
                    help="reduced sweep (CI / tests)")
    ap.add_argument("--check", action="store_true",
                    help="compare against the baselines; exit 1 on "
                         "regression; never rewrite baselines")
    ap.add_argument("--record", default=None,
                    help="with --check: gate this pre-built record file "
                         "instead of running the suites")
    ap.add_argument("--baseline", default=None,
                    help="explicit baseline record file (default: "
                         "BENCH_<suite>.json under --baseline-dir)")
    ap.add_argument("--baseline-dir", default=_BASELINE_DIR,
                    help="where the baseline BENCH_*.json live / are written")
    ap.add_argument("--out-dir", default=None,
                    help="also write freshly measured records here "
                         "(artifacts; independent of the baselines)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    if args.record:
        if not args.check:
            ap.error("--record only makes sense with --check")
        records = [R.load_record(args.record)]
    else:
        suites = (["kernels", "memory", "serving"] if args.suite == "all"
                  else [args.suite])
        records = []
        for suite in suites:
            print(f"# running {suite} suite (small={args.small}) ...",
                  file=sys.stderr)
            records.append(_run_suite(suite, args.small, args.device))

    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        for rec in records:
            path = os.path.join(args.out_dir, R.BENCH_FILES[rec["suite"]])
            print(f"# wrote {R.write_record(rec, path)}", file=sys.stderr)

    if not args.check:
        os.makedirs(args.baseline_dir, exist_ok=True)
        for rec in records:
            path = os.path.join(args.baseline_dir, R.BENCH_FILES[rec["suite"]])
            print(f"# baseline updated: {R.write_record(rec, path)}")
        return 0

    ok = True
    for rec in records:
        base_path = args.baseline or os.path.join(
            args.baseline_dir, R.BENCH_FILES[rec["suite"]])
        if not os.path.exists(base_path):
            print(f"MISSING BASELINE {base_path} for suite {rec['suite']!r} "
                  "(run `python -m repro_torch.bench` to write it)")
            ok = False
            continue
        rec_ok, lines = R.check_records(rec, R.load_record(base_path))
        print(f"== {rec['suite']} vs {base_path} ==")
        for line in lines:
            print(line)
        ok = ok and rec_ok

    # Simulated-vs-measured peak parity: gate the memsim model against the
    # traced peaks of THIS run (baseline-independent — the simulator must
    # track what the port actually allocates).
    from repro_torch.bench.memory import sim_parity_failures
    for rec in records:
        if rec["suite"] != "memory":
            continue
        fails = sim_parity_failures(rec["entries"])
        n_sim = sum(e["name"].startswith("peak_sim/")
                    for e in rec["entries"])
        print(f"== memory sim-vs-measured parity ({n_sim} entries) ==")
        for line in fails:
            print(line)
        if not fails:
            print("OK: every peak_sim/* entry within tolerance of its "
                  "measured peak")
        ok = ok and not fails

    # Fused-path pairing gates: the fused MoE layer must save zero (L*k, .)
    # slot buffers and must not be slower than the unfused kernel
    # composition measured in the SAME run (baseline-independent, like the
    # sim-parity gate — wall time only pairs against itself).
    from repro_torch.bench.timing import fused_gate_failures
    for rec in records:
        if rec["suite"] != "kernels":
            continue
        fails = fused_gate_failures(rec["entries"])
        print("== fused-path same-run gates ==")
        for line in fails:
            print(line)
        if not fails:
            print("OK: fused path saves no slot buffers and is not slower "
                  "than the unfused pallas path")
        ok = ok and not fails

    # Parallel same-run gates: the roofline cost model's predicted ep vs
    # ep_a2a ranking must agree with the wall times measured in THIS run,
    # the chunked exchange must hold parity with the unchunked one, and
    # `auto` must have resolved to the predicted winner.
    from repro_torch.bench.timing import parallel_gate_failures
    for rec in records:
        if rec["suite"] != "kernels":
            continue
        fails = parallel_gate_failures(rec["entries"])
        print("== parallel same-run gates ==")
        for line in fails:
            print(line)
        if not fails:
            print("OK: predicted mode ranking agrees with measured, "
                  "chunked exchange holds parity, auto picked the winner")
        ok = ok and not fails

    # Serving same-run gates: batched-vs-solo token parity (the left-pad
    # bugfix), decode slot-steps == sum(T_r - 1) (continuous slot release),
    # the int8 paged pool's measured bytes-per-token advantage over dense
    # bf16 slots, the shared-prefix pair's prefill-token saving (>= one
    # full page vs 2x solo, tokens unchanged), and async-pipeline ==
    # sync-engine token identity — all pairings within THIS run's record.
    from repro_torch.bench.serving import serving_gate_failures
    for rec in records:
        if rec["suite"] != "serving":
            continue
        fails = serving_gate_failures(rec["entries"])
        print("== serving same-run gates ==")
        for line in fails:
            print(line)
        if not fails:
            print("OK: batched==solo tokens, slots released on finish, "
                  "int8 paged KV >= 1.8x smaller than dense bf16 slots, "
                  "prefix pair >= 1 page cheaper than 2x solo, "
                  "async pipeline == sync engine")
        ok = ok and not fails
    return 0 if ok else 1
