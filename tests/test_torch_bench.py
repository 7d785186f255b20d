"""Port parity: the bench harness (``repro_torch.bench``) against the
reference's (``repro.bench``), on the CPU.

- Every case of ``tests/test_bench.py`` on the port: the record schema's
  round trip, duplicates and a bad schema refused, the one-sided
  regression gate, ``--check``'s exit codes, the activation-memory
  accountant under ``segment`` and the auto backend, the expert-parallel
  residual pair, the timing protocol.
- ``check_records`` and the four same-run gates (``sim_parity_failures``,
  ``fused_gate_failures``, ``parallel_gate_failures``,
  ``serving_gate_failures``) on shared synthetic records: the port's lines
  equal the reference's string for string, failing or not.
- ``memory_suite(small=True)`` against the reference's arithmetic on the
  same configs, computed in the test: ``est_saved_bytes`` exactly; the
  residual bytes within 0.3 relative (``tests/test_torch_checkpoint.py``'s
  tolerance), but for the MoE config under ``dots``, which the port holds
  between the reference's ``ragged`` and ``segment`` counts (the
  reference's ``segment`` runs every expert over every slot row, and
  ``dots`` keeps those ``E`` products; the port's runs each group's rows);
  every ``peak_sim/*`` entry is the port's simulator on its own timeline
  (``schedule="torch"``, ROADMAP §C, C11), whose ``"xla"`` timeline equals
  the reference's entry exactly, and the parity gate holds on the port's
  traced peaks.
- ``paper_tables.residual_bytes`` at the paper's full sizes for conf1-2,
  every implementation and activation, within 0.3 of the reference's.
- The serving suite's deterministic entries equal the reference's, and the
  port's token-mismatch counts are 0.
- ``roofline.bench_entries`` has the reference's names, kinds, values and
  tolerances for one analysis dict.

The parallel gate is held on synthetic entries only: its measured half
spawns eight gloo ranks (``python -m repro_torch.bench`` and the card's
smoke run it).
"""

import json

import pytest

from repro.bench import memory as JM
from repro.bench import record as JR
from repro.bench import serving as JS
from repro.bench import timing as JT
from repro.core import checkpoint as JCK
from repro.core import memsim as JMS
from torch_parity import port as _port_modules
from torch_parity import torch_config

BATCH, SEQ = 2, 32


@pytest.fixture(scope="module")
def B():
    """torch (threads capped) and the port's bench modules."""
    from types import SimpleNamespace
    _port_modules()
    from repro_torch import roofline
    from repro_torch.bench import cli, memory, paper_tables, record, serving
    from repro_torch.bench import timing
    from repro_torch.core import gmm_backend, memsim
    return SimpleNamespace(R=record, M=memory, T=timing, S=serving,
                           P=paper_tables, cli=cli, roofline=roofline,
                           GB=gmm_backend, MS=memsim)


def _toy_entries(R):
    return [
        R.entry("toy/a/bytes", 1000.0, kind="residual_bytes", unit="bytes",
                tolerance_pct=20.0, batch=2),
        R.entry("toy/a/time", 123.4, kind="time_us", unit="us"),
        R.entry("toy/b/bytes", 500.0, kind="temp_bytes", unit="bytes",
                tolerance_pct=100.0),
    ]


def _toy_record(B, **overrides):
    rec = B.R.make_record("kernels", _toy_entries(B.R),
                          config={"small": True}, device="cpu")
    rec.update(overrides)
    return rec


# -- tests/test_bench.py on the port -----------------------------------------


def test_record_roundtrip(B, tmp_path):
    rec = _toy_record(B)
    path = B.R.write_record(rec, str(tmp_path / "r.json"))
    back = B.R.load_record(path)
    assert back == json.loads(json.dumps(rec))     # JSON-stable
    assert back["schema_version"] == B.R.SCHEMA_VERSION == JR.SCHEMA_VERSION
    assert back["suite"] == "kernels"
    for key in ("git_sha", "torch_version", "cuda_version", "device",
                "gmm_backend", "gmm_backend_source"):
        assert key in back["provenance"], key
    assert back["provenance"]["device"] == "cpu"
    assert [e["name"] for e in back["entries"]] == [
        "toy/a/bytes", "toy/a/time", "toy/b/bytes"]
    assert B.R.BENCH_FILES == JR.BENCH_FILES
    assert B.R.DEFAULT_TOLERANCE_PCT == JR.DEFAULT_TOLERANCE_PCT == 20.0


def test_record_rejects_duplicates_and_bad_schema(B, tmp_path):
    R = B.R
    with pytest.raises(ValueError, match="duplicate"):
        R.make_record("kernels", [R.entry("x", 1, kind="k"),
                                  R.entry("x", 2, kind="k")], device="cpu")
    rec = _toy_record(B, schema_version=99)
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        json.dump(rec, f)
    with pytest.raises(ValueError, match="schema_version"):
        R.load_record(path)


def test_regression_gate_semantics(B):
    R = B.R
    base = _toy_record(B)
    ok, _ = R.check_records(_toy_record(B), base)
    assert ok
    bad = _toy_record(B)
    bad["entries"][0] = dict(bad["entries"][0], value=1500.0)
    ok, lines = R.check_records(bad, base)
    assert not ok
    assert any("REGRESSION toy/a/bytes" in ln for ln in lines)
    loose = _toy_record(B)
    loose["entries"][2] = dict(loose["entries"][2], value=750.0)
    ok, _ = R.check_records(loose, base)
    assert ok
    noisy = _toy_record(B)
    noisy["entries"][1] = dict(noisy["entries"][1], value=12340.0)
    ok, _ = R.check_records(noisy, base)
    assert ok
    missing = _toy_record(B)
    missing["entries"] = missing["entries"][1:]
    ok, lines = R.check_records(missing, base)
    assert not ok
    assert any("missing" in ln for ln in lines)
    better = _toy_record(B)
    better["entries"][0] = dict(better["entries"][0], value=100.0)
    ok, _ = R.check_records(better, base)
    assert ok
    mismatch = _toy_record(B, config={"small": False})
    ok, lines = R.check_records(mismatch, base)
    assert not ok
    assert any("config mismatch" in ln for ln in lines)


def test_cli_check_exit_codes(B, tmp_path):
    """``python -m repro_torch.bench --check`` exits 1 on a record with a
    >20% regression, 0 on a clean one and 1 on a missing baseline, as the
    reference's; nothing is written outside the given directories."""
    R = B.R
    base_path = R.write_record(_toy_record(B), str(tmp_path / "base.json"))
    bad = _toy_record(B)
    bad["entries"][0] = dict(bad["entries"][0], value=1300.0)   # +30%
    bad_path = R.write_record(bad, str(tmp_path / "bad.json"))
    assert B.cli.main(["--check", "--record", base_path,
                       "--baseline", base_path]) == 0
    assert B.cli.main(["--check", "--record", bad_path,
                       "--baseline", base_path]) == 1
    assert B.cli.main(["--check", "--record", bad_path,
                       "--baseline-dir", str(tmp_path / "none")]) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == ["bad.json",
                                                          "base.json"]


def test_memory_accountant_smoke_segment_and_auto(B):
    """The accountant runs on the tiny config under ``segment`` and the
    auto backend, and its three accountants agree on basic sanity."""
    cfg = B.M.bench_config()
    backends = list(dict.fromkeys(["segment", B.GB.resolve(None).name]))
    residuals = {}
    for backend in backends:
        r = B.M.activation_memory_report(cfg, "paper", backend=backend,
                                         device="cpu")
        assert r["backend"] == backend
        assert r["temp_bytes"] > 0 and r["peak_bytes"] > r["temp_bytes"]
        assert r["residual_bytes"] > 0
        assert r["est_saved_bytes"] is not None and r["est_saved_bytes"] > 0
        residuals[backend] = r["residual_bytes"]
    # the residual set is a property of the math, not the backend
    assert len(set(residuals.values())) == 1, residuals


def test_ep_residual_entries_dispatch_strictly_below_dense(B):
    """The dispatch-driven EP path saves strictly fewer residual bytes than
    the dense-EP formulation, on one rank of the (1, 2) mesh."""
    vals = {e["name"]: e["value"]
            for e in B.M.ep_saved_residual_entries(small=True, device="cpu")}
    dense = vals["memory/tiny_moe_ep/ep_dense/residual_bytes"]
    disp = vals["memory/tiny_moe_ep/ep_dispatch/residual_bytes"]
    assert 0 < disp < dense, vals


def test_median_time_us_protocol(B):
    import torch
    us = B.T.median_time_us(lambda x: x * 2, torch.ones(8), warmup=1,
                            iters=3)
    assert us > 0


# -- the gates on shared synthetic records -----------------------------------


def _e(name, value, *, tol=None, kind="k", **meta):
    return {"name": name, "kind": kind, "value": float(value), "unit": "",
            "tolerance_pct": tol, "meta": meta}


def _records(R, base_vals, cur_vals, cur_config=None):
    def rec(vals, config):
        return {"schema_version": 1, "suite": "memory", "provenance": {},
                "config": config,
                "entries": [_e(n, v, tol=t) for n, (v, t) in vals.items()]}
    return (rec(cur_vals, cur_config or {"small": True}),
            rec(base_vals, {"small": True}))


_BASE = {"a": (1000.0, 20.0), "b": (0.0, 0.0), "c": (50.0, None),
         "d": (200.0, 100.0)}
CHECK_CASES = {
    "clean": dict(_BASE),
    "regressed": dict(_BASE, a=(1300.0, 20.0), d=(500.0, 100.0)),
    "improved": dict(_BASE, a=(10.0, 20.0), d=(199.0, 100.0)),
    "from_zero": dict(_BASE, b=(3.0, 0.0)),
    "missing": {k: v for k, v in _BASE.items() if k != "a"},
}


@pytest.mark.parametrize("case", [*CHECK_CASES, "config", "suite"])
def test_check_records_lines_match_reference(B, case):
    cur, base = _records(None, _BASE, CHECK_CASES.get(case, _BASE),
                         {"small": False} if case == "config" else None)
    if case == "suite":
        cur["suite"] = "kernels"
    assert B.R.check_records(cur, base) == JR.check_records(cur, base)
    assert B.R.compare_records(cur, base) == JR.compare_records(cur, base)


def _sim_entries(sim, meas, mode="single", plan="paper", measured=True):
    backend = "segment" if mode == "single" else mode
    out = [_e(f"peak_sim/tiny_moe/{plan}/{mode}", sim, tol=20.0)]
    if measured:
        out.append(_e(f"memory/tiny_moe/{plan}/{backend}/peak_bytes", meas,
                      tol=100.0))
    return out


SIM_CASES = {
    "within": _sim_entries(1_100_000, 1_000_000),
    "over": _sim_entries(1_300_000, 1_000_000),
    "under": _sim_entries(700_000, 1_000_000, mode="ep_a2a"),
    "missing": _sim_entries(1_000_000, 0, mode="ep", measured=False),
    "none": [_e("memory/tiny_moe/none/segment/peak_bytes", 5)],
}


def _fused(fused_t, unfused_t, n=0, drop=None):
    pre = "kernels/fused_path"
    out = [_e(f"{pre}/fused/time", fused_t),
           _e(f"{pre}/fused/slot_buffers", n, tol=0.0),
           _e(f"{pre}/unfused_pallas/time", unfused_t)]
    return [e for e in out if e["name"] != drop]


FUSED_CASES = {
    "ok": _fused(900, 1000), "slower": _fused(1100, 1000),
    "buffers": _fused(900, 1000, n=3), "both": _fused(1200, 1000, n=1),
    "incomplete": _fused(900, 1000, drop="kernels/fused_path/fused/time"),
    "absent": [],
}


def _parallel(ep, a2a, ep_p, a2a_p, ch, resolved, drop=None):
    pre = "kernels/parallel"
    out = [_e(f"{pre}/ep/time", ep), _e(f"{pre}/ep_a2a/time", a2a),
           _e(f"{pre}/ep/predicted", ep_p),
           _e(f"{pre}/ep_a2a/predicted", a2a_p),
           _e(f"{pre}/ep_a2a_chunked/time", ch),
           _e(f"{pre}/auto_mode", resolved == "ep_a2a", tol=0.0,
              resolved=resolved)]
    return [e for e in out if e["name"] != drop]


PARALLEL_CASES = {
    "ok": _parallel(60e3, 30e3, 9.4, 4.9, 33e3, "ep_a2a"),
    "ranking": _parallel(20e3, 30e3, 9.4, 4.9, 33e3, "ep_a2a"),
    "chunked": _parallel(60e3, 30e3, 9.4, 4.9, 40e3, "ep_a2a"),
    "auto": _parallel(60e3, 30e3, 9.4, 4.9, 33e3, "ep"),
    "all": _parallel(20e3, 30e3, 9.4, 4.9, 40e3, "ep"),
    "incomplete": _parallel(60e3, 30e3, 9.4, 4.9, 33e3, "ep_a2a",
                            drop="kernels/parallel/ep/time"),
    "absent": [],
}


def _serving(**over):
    vals = {"serving/parity/mismatched_tokens": 0,
            "serving/sched/decode_slot_tokens": 16,
            "serving/sched/expected_slot_tokens": 16,
            "serving/kv/int8_paged_bytes_per_token": 272,
            "serving/kv/bf16_dense_bytes_per_token": 520,
            "serving/prefix/prefill_tokens_nosharing": 32,
            "serving/prefix/prefill_tokens_shared": 17,
            "serving/prefix/mismatched_tokens": 0,
            "serving/pipeline/async_sync_mismatches": 0}
    vals.update(over)
    return [_e(n, v, tol=0.0, **({"page_size": 8} if n.endswith("_shared")
                                 else {}))
            for n, v in vals.items() if v is not None]


SERVING_CASES = {
    "ok": _serving(),
    "every": _serving(**{"serving/parity/mismatched_tokens": 2,
                         "serving/sched/decode_slot_tokens": 18,
                         "serving/kv/int8_paged_bytes_per_token": 400,
                         "serving/prefix/prefill_tokens_shared": 30,
                         "serving/prefix/mismatched_tokens": 1,
                         "serving/pipeline/async_sync_mismatches": 3}),
    "incomplete": _serving(**{"serving/prefix/mismatched_tokens": None}),
    "absent": [],
}

GATES = {
    "sim": (SIM_CASES, lambda B: B.M.sim_parity_failures,
            JM.sim_parity_failures),
    "fused": (FUSED_CASES, lambda B: B.T.fused_gate_failures,
              JT.fused_gate_failures),
    "parallel": (PARALLEL_CASES, lambda B: B.T.parallel_gate_failures,
                 JT.parallel_gate_failures),
    "serving": (SERVING_CASES, lambda B: B.S.serving_gate_failures,
                JS.serving_gate_failures),
}


@pytest.mark.parametrize("gate,case", [(g, c) for g, (cases, _, _) in
                                       GATES.items() for c in cases])
def test_gate_lines_match_reference(B, gate, case):
    """The same entries give the same failure lines, string for string;
    the bounds are the reference's."""
    cases, port_fn, ref_fn = GATES[gate]
    entries = cases[case]
    got = port_fn(B)(entries)
    assert got == ref_fn(entries)
    assert bool(got) == (case not in ("ok", "within", "absent", "none"))
    assert B.M.SIM_PARITY_TOLERANCE_PCT == JM.SIM_PARITY_TOLERANCE_PCT
    assert B.S.INT8_KV_RATIO_MIN == JS.INT8_KV_RATIO_MIN
    assert B.T.PARALLEL_CHUNK_TOL == JT.PARALLEL_CHUNK_TOL


# -- the memory suite against the reference's arithmetic ----------------------


@pytest.fixture(scope="module")
def mem(B):
    return {e["name"]: e for e in B.M.memory_suite(small=True, device="cpu")}


def test_memory_suite_matches_reference(B, mem):
    jcfgs = {"tiny_moe": JM.bench_config(), "tiny_dense": JM.bench_dense_config()}
    assert B.M.POLICY_ORDER == JM.POLICY_ORDER
    for name, jcfg in jcfgs.items():
        assert torch_config(jcfg) == getattr(
            B.M, "bench_config" if name == "tiny_moe"
            else "bench_dense_config")()
        for plan in JM.POLICY_ORDER:
            est = JCK.resolve_plan(plan).plan.estimate_saved_bytes(
                jcfg, BATCH * SEQ, batch=BATCH)
            key = f"memory/{name}/{plan}/est_saved_bytes"
            if est is None:
                assert key not in mem
            else:
                assert mem[key]["value"] == est, key
            got = mem[f"memory/{name}/{plan}/residual_bytes"]["value"]
            seg = JM.residual_bytes(jcfg.replace(gmm_backend="segment"), plan,
                                    batch=BATCH, seq=SEQ)
            if name == "tiny_moe" and plan == "dots":
                rag = JM.residual_bytes(jcfg.replace(gmm_backend="ragged"),
                                        plan, batch=BATCH, seq=SEQ)
                assert rag < got < seg, (rag, got, seg)
            else:
                assert got == pytest.approx(seg, rel=0.3), (name, plan)


def test_peak_sim_entries_are_the_port_schedule(B, mem):
    """Every ``peak_sim/*`` entry is ``simulate_peak(schedule="torch")``;
    the same call on the reference's timeline (``"xla"``) gives the
    reference's entry exactly; and the port's traced peaks hold the parity
    gate (the reference's timeline alone would not: C11)."""
    sims = [e for n, e in mem.items() if n.startswith("peak_sim/")]
    assert len(sims) == 20
    xla_fails = 0
    for e in sims:
        _, cname, plan, mode = e["name"].split("/")
        jcfg = (JM.bench_config() if cname == "tiny_moe"
                else JM.bench_dense_config())
        if mode != "single":
            jcfg = jcfg.replace(moe_parallel=mode, gmm_backend="segment")
        kw = dict(batch=BATCH, plan=plan, mode=mode,
                  n_model=1 if mode == "single" else 2, base="grad")
        tcfg = torch_config(jcfg)
        assert e["value"] == B.MS.simulate_peak(tcfg, BATCH * SEQ,
                                                schedule="torch", **kw)
        assert B.MS.simulate_peak(tcfg, BATCH * SEQ, **kw) == \
            JMS.simulate_peak(jcfg, BATCH * SEQ, **kw)
        meas = mem[f"memory/{cname}/{plan}/"
                   f"{'segment' if mode == 'single' else mode}/peak_bytes"]
        xla = B.MS.simulate_peak(tcfg, BATCH * SEQ, **kw)
        xla_fails += abs(xla - meas["value"]) > 0.2 * meas["value"]
    assert B.M.sim_parity_failures(list(mem.values())) == []
    assert xla_fails > 0


@pytest.mark.parametrize("name", ["paper_conf1", "paper_conf2"])
def test_paper_residual_bytes_match_reference(B, name):
    from repro.bench import paper_tables as JP
    conf = JP.PAPER_TABLE1[name]
    assert B.P.PAPER_TABLE1[name] == conf
    assert B.P.IMPLS == JP.IMPLS
    for act in ("silu", "swiglu"):
        for impl in JP.IMPLS:
            got = B.P.residual_bytes(conf, impl, act)
            assert got == pytest.approx(JP.residual_bytes(conf, impl, act),
                                        rel=0.3), (impl, act)


def test_serving_deterministic_entries_match_reference(B):
    got = {e["name"]: e for e in B.S.serving_suite(small=True, device="cpu")}
    want = {e["name"]: e for e in JS.serving_suite(small=True)}
    assert list(got) == list(want)
    for name, e in want.items():
        if e["tolerance_pct"] is None or "mismatch" in name:
            continue
        assert got[name]["value"] == e["value"], name
    for name in ("serving/parity/mismatched_tokens",
                 "serving/prefix/mismatched_tokens",
                 "serving/pipeline/async_sync_mismatches"):
        assert got[name]["value"] == 0, name
    assert B.S.serving_gate_failures(list(got.values())) == []


def test_roofline_bench_entries_match_reference(B, mem):
    """The reference's names, kinds, values and tolerances for one analysis
    dict; the memory suite records the ``paper`` plan's."""
    from repro import roofline as JRF
    analysis = {"dominant": "memory", "n_chips": 1, "flops_per_dev": 7.5e7,
                "hlo_bytes_per_dev": 3.8e7, "peak_bytes": 2.8e6,
                "t_compute_s": 7.3e-8, "t_memory_s": 1.1e-5,
                "t_collective_s": 0.0}
    got = B.roofline.bench_entries(analysis, "memory/tiny_moe/roofline")
    assert got == JRF.bench_entries(analysis, "memory/tiny_moe/roofline")
    for e in got:
        assert e["name"] in mem, e["name"]
        assert mem[e["name"]]["kind"] == e["kind"]
        assert mem[e["name"]]["tolerance_pct"] == e["tolerance_pct"]
