"""Stable benchmark-record schema + the regression gate.

The port's counterpart of ``repro/bench/record.py``, with its schema, its
names and its one-sided gate.  A *record* is one JSON document
(``BENCH_kernels.json`` / ``BENCH_memory.json`` / ``BENCH_serving.json``
under ``--baseline-dir``, by default ``build/bench_torch/``: the
reference's own files at the repo root are its baselines, not the port's)
holding a flat list of named *entries* plus provenance.  Entries carry
their own gating policy: ``tolerance_pct`` is the allowed relative
increase vs the baseline before ``--check`` fails, or ``None`` for
informational metrics that are recorded but never gated.

All gated metrics are lower-is-better (seconds, bytes, flops), so the gate is
one-sided: improvements are reported, only increases beyond tolerance fail.

Schema (version 1)::

    {"schema_version": 1, "suite": "kernels",
     "provenance": {"git_sha": ..., "torch_version": ...,
                    "cuda_version": ..., "device": ..., ...},
     "config": {...},                      # suite parameters (e.g. small=true)
     "entries": [{"name": ..., "kind": ..., "value": ..., "unit": ...,
                  "tolerance_pct": ... | null, "meta": {...}}, ...]}

The provenance stamps ``torch.__version__``, ``torch.version.cuda``, the
device the suites ran on and the grouped-GEMM backend the run resolves by
default; on the card also ``nvidia-smi``'s name and power limit, which
every time on the card must stand beside.
"""

from __future__ import annotations

import json
import os
import subprocess

SCHEMA_VERSION = 1

#: default tolerance used by ``--check`` for entries that predate per-entry
#: tolerances (and by tests); the acceptance gate of the harness.
DEFAULT_TOLERANCE_PCT = 20.0

BENCH_FILES = {
    "kernels": "BENCH_kernels.json",
    "memory": "BENCH_memory.json",
    "serving": "BENCH_serving.json",
}

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def entry(name: str, value: float, *, kind: str, unit: str = "",
          tolerance_pct: float | None = None, **meta) -> dict:
    """One benchmark data point.  ``tolerance_pct=None`` means informational
    (never gated)."""
    return {"name": name, "kind": kind, "value": float(value), "unit": unit,
            "tolerance_pct": tolerance_pct, "meta": meta}


def git_sha(repo_dir: str | None = None) -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=repo_dir, capture_output=True,
            text=True, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except OSError:
        pass
    return "unknown"


def card_name_and_power() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or
    None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except OSError:
        return None
    if out.returncode != 0 or not out.stdout.strip():
        return None
    return out.stdout.strip().splitlines()[0].strip()


def provenance(device=None) -> dict:
    """Where and with what a record was measured: git sha, torch and CUDA
    versions, ``device`` (default: the card), the grouped-GEMM backend the
    run resolves by default and, on the card, its name and power limit."""
    import platform

    import torch

    from repro_torch.core import gmm_backend as GB
    from repro_torch.core.device import resolve_device
    dev = resolve_device(device)
    # The grouped-GEMM backend this run resolves by default — stamped through
    # the resolver (context/env/auto precedence), never a raw env-var read.
    gmm_rb = GB.resolve(None)
    out = {"git_sha": git_sha(REPO_ROOT),
           "torch_version": torch.__version__,
           "cuda_version": torch.version.cuda,
           "device": dev.type,
           "gmm_backend": gmm_rb.name,
           "gmm_backend_source": gmm_rb.source,
           "python_version": platform.python_version()}
    if dev.type == "cuda":
        out["card"] = card_name_and_power()
        out["device_name"] = torch.cuda.get_device_name(dev)
    return out


def make_record(suite: str, entries: list, config: dict | None = None, *,
                device=None) -> dict:
    names = [e["name"] for e in entries]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(f"duplicate entry names in {suite!r} record: {dupes}")
    return {"schema_version": SCHEMA_VERSION, "suite": suite,
            "provenance": provenance(device), "config": dict(config or {}),
            "entries": entries}


def write_record(record: dict, path: str) -> str:
    with open(path, "w") as f:
        json.dump(record, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_record(path: str) -> dict:
    with open(path) as f:
        record = json.load(f)
    version = record.get("schema_version")
    if version != SCHEMA_VERSION:
        raise ValueError(
            f"{path}: schema_version {version!r} != {SCHEMA_VERSION} "
            "(regenerate the baseline with `python -m repro_torch.bench "
            "--small` — keep the sweep size the baselines were written with)")
    for key in ("suite", "provenance", "entries"):
        if key not in record:
            raise ValueError(f"{path}: missing record field {key!r}")
    return record


def compare_records(current: dict, baseline: dict,
                    default_tolerance_pct: float = DEFAULT_TOLERANCE_PCT
                    ) -> list[dict]:
    """Entry-by-entry comparison.  Returns one row per *gated* baseline entry
    (``tolerance_pct`` not null): ``regressed`` is True when the current value
    exceeds baseline by more than the tolerance, or when a gated baseline
    entry disappeared from the current record.  Current-only entries (e.g. a
    backend that runs only on the card) are ignored — they enter the gate
    once written to the baseline."""
    cur = {e["name"]: e for e in current["entries"]}
    rows = []
    for base in baseline["entries"]:
        tol = base.get("tolerance_pct", default_tolerance_pct)
        if tol is None:
            continue
        name = base["name"]
        c = cur.get(name)
        if c is None:
            rows.append({"name": name, "baseline": base["value"],
                         "current": None, "pct_change": None,
                         "tolerance_pct": tol, "regressed": True,
                         "reason": "missing from current record"})
            continue
        b = base["value"]
        pct = (c["value"] - b) / b * 100.0 if b else (
            0.0 if c["value"] == 0 else float("inf"))
        rows.append({"name": name, "baseline": b, "current": c["value"],
                     "pct_change": pct, "tolerance_pct": tol,
                     "regressed": pct > tol,
                     "reason": f"+{pct:.1f}% > {tol:.0f}%" if pct > tol else ""})
    return rows


def check_records(current: dict, baseline: dict,
                  default_tolerance_pct: float = DEFAULT_TOLERANCE_PCT
                  ) -> tuple[bool, list[str]]:
    """Regression gate.  Returns (ok, human-readable report lines)."""
    if current.get("suite") != baseline.get("suite"):
        return False, [f"suite mismatch: current={current.get('suite')!r} "
                       f"baseline={baseline.get('suite')!r}"]
    if current.get("config") != baseline.get("config"):
        # small vs full sweeps emit the same entry names with very different
        # values — comparing across them would gate nothing meaningful.
        return False, [f"config mismatch: current={current.get('config')!r} "
                       f"baseline={baseline.get('config')!r} "
                       "(run --check with the sweep the baseline was "
                       "committed with)"]
    rows = compare_records(current, baseline, default_tolerance_pct)
    lines = []
    ok = True
    for r in rows:
        if r["regressed"]:
            ok = False
            cur = "missing" if r["current"] is None else f"{r['current']:.4g}"
            lines.append(f"REGRESSION {r['name']}: baseline "
                         f"{r['baseline']:.4g} -> {cur} ({r['reason']})")
        elif r["pct_change"] is not None and abs(r["pct_change"]) > 1e-9:
            lines.append(f"ok {r['name']}: {r['baseline']:.4g} -> "
                         f"{r['current']:.4g} ({r['pct_change']:+.1f}%)")
    lines.append(f"checked {len(rows)} gated entries of "
                 f"{len(baseline['entries'])} in suite "
                 f"{baseline.get('suite')!r}: "
                 + ("OK" if ok else "REGRESSED"))
    return ok, lines
