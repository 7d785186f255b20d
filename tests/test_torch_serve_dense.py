"""Port parity: serving the dense SwiGLU model (reduced Qwen3-14B, float32).

Weights come from the reference's ``init_params`` through
``repro_torch.interop.params_from_jax``; the port runs ``use_pallas=True``
(the fused-SwiGLU Function and flash attention at prefill, the paged
attention kernels at decode, here through their plain versions) and the
reference its plain path.

- Prefill and teacher-forced decode logits against the reference's
  ``prefill`` / ``paged_decode_step``, over model-dtype pages and over int8
  pages (``init_paged_cache(..., quantized=True)``); the int8 pools hold
  the reference's bytes.
- Engine tokens against the reference *model's* greedy decode (``forward``
  over each prompt and the tokens so far); the reference engine's own
  tokens vary from run to run (ROADMAP §C), its accounting does not.
- The int8 engine runs: its first tokens equal the model-dtype engine's
  (prefill attends over the in-flight k/v, not the pages) and its
  accounting is the same.

Logit tolerance 1e-4 (float32 sums in another order through two layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.models import transformer as JT
from repro.serve import kv_quant as JKQ
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from torch_parity import np_params, to_torch, torch_config, tp  # noqa: F401

JCFG = get_config("qwen3_14b").reduced()
TCFG = torch_config(JCFG).replace(use_pallas=True)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STAT_KEYS = ("prefill_calls", "prefill_tokens", "decode_steps",
             "decode_slot_tokens", "generated_tokens", "blocked_admissions",
             "truncated_budgets", "peak_pages_used")
CAPACITY, MAX_NEW = 48, 6


@pytest.fixture(scope="module")
def params(tp):
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, tp.interop.params_from_jax(np_params(jp), TCFG, device="cpu")


@pytest.mark.parametrize("quantized", [False, True], ids=["model", "int8"])
def test_prefill_and_decode_logits_match(tp, params, quantized):
    TT, torch = tp.transformer, tp.torch
    jp, tparams = params
    rng = np.random.default_rng(0)
    B, S, ps, pps = 2, 16, 8, 4
    lengths = np.array([5, 11], np.int32)
    tokens = np.zeros((B, S), np.int32)
    for b, n in enumerate(lengths):
        tokens[b, :n] = rng.integers(3, JCFG.vocab_size, size=n)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    n_pages = 1 + B * pps
    jcache = JT.init_paged_cache(JCFG, n_pages, ps, quantized=quantized)
    tcache = TT.init_paged_cache(TCFG, n_pages, ps, "cpu",
                                 quantized=quantized)
    assert all(p.quantized == quantized for p in tcache)
    assert (tp.kv_quant.cache_bytes(tcache)
            == JKQ.cache_bytes(jcache))
    jl, jcache = JT.prefill(jp, jnp.asarray(tokens), jnp.asarray(lengths),
                            jcache, jnp.asarray(table), JCFG)
    with torch.inference_mode():
        tl = TT.prefill(tparams, to_torch(tokens), to_torch(lengths), tcache,
                        to_torch(table), TCFG)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    pos = lengths.copy()
    for _ in range(3):                      # teacher-forced decode steps
        tok = rng.integers(3, JCFG.vocab_size, size=(B, 1)).astype(np.int32)
        jl, jcache = JT.paged_decode_step(jp, jcache, jnp.asarray(tok),
                                          jnp.asarray(pos),
                                          jnp.asarray(table), JCFG)
        with torch.inference_mode():
            tl = TT.paged_decode_step(tparams, tcache, to_torch(tok),
                                      to_torch(pos), to_torch(table), TCFG)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        pos += 1
    if quantized:          # the written pages hold the reference's int8
        j0 = jcache[0][0]
        for name in ("k", "v", "k_scale", "v_scale"):
            want = np.asarray(getattr(j0, name))[0]
            got = getattr(tcache[0], name).numpy()
            assert (got == want).all(), name


def _engine_prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(3, JCFG.vocab_size, size=n).astype(np.int32)
            for n in (3, 40, 17, 9, 25)]


@pytest.fixture(scope="module")
def greedy_ref(params):
    """The reference model's greedy continuation of each prompt (see
    ``tests/test_torch_serve.py``)."""
    jp = params[0]
    fwd = jax.jit(lambda p, t: JT.forward(p, {"tokens": t}, JCFG)[0])
    prompts = _engine_prompts()
    seqs = [list(p) for p in prompts]
    for _ in range(MAX_NEW):
        toks = np.zeros((len(seqs), CAPACITY), np.int32)
        for i, q in enumerate(seqs):
            toks[i, :len(q)] = q
        logits = np.asarray(fwd(jp, jnp.asarray(toks)))
        for i, q in enumerate(seqs):
            q.append(int(logits[i, len(q) - 1].argmax()))
    return [q[len(p):] for q, p in zip(seqs, prompts)]


def _run(tp, tparams, **kw):
    eng = tp.engine.ServeEngine(TCFG, tparams, device="cpu",
                                batch_slots=3, capacity=CAPACITY,
                                page_size=16, **kw)
    reqs = eng.generate([tp.engine.Request(
        prompt=p, max_new_tokens=MAX_NEW, eos_id=JCFG.vocab_size)
        for p in _engine_prompts()])
    return eng, reqs


def test_engine_greedy_tokens_and_stats_match(tp, params, greedy_ref):
    jp, tparams = params
    jeng = JServeEngine(JCFG, jp, batch_slots=3, capacity=CAPACITY,
                        page_size=16)
    jreqs = jeng.generate([JRequest(prompt=p, max_new_tokens=MAX_NEW,
                                    eos_id=JCFG.vocab_size)
                           for p in _engine_prompts()])
    eng, treqs = _run(tp, tparams)
    for want, j, t in zip(greedy_ref, jreqs, treqs):
        assert t.out_tokens == want
        assert t.finish_reason == j.finish_reason
    for k in STAT_KEYS:
        assert eng.stats[k] == jeng.stats[k], k


def test_int8_engine_runs(tp, params):
    """The int8 engine serves the same requests: the same accounting, the
    same first token of every request, the int8 kernel's plain version on
    the decode path, and the reference's bytes per cached token."""
    from repro.core.memsim import kv_bytes_per_token
    tparams = params[1]
    base, b_reqs = _run(tp, tparams)
    before = tp.paged_attention.paged_attention_int8_plain
    calls = []

    def spy(*a, **kw):
        calls.append(1)
        return before(*a, **kw)

    tp.paged_attention.paged_attention_int8_plain = spy
    try:
        # the kernel named: a CPU engine's auto is the plain gather (C6)
        int8, i_reqs = _run(tp, tparams, kv_dtype="int8",
                            paged_kernel="pallas")
    finally:
        tp.paged_attention.paged_attention_int8_plain = before
    assert len(calls) == int8.stats["decode_steps"] * JCFG.num_layers > 0
    assert all(p.quantized for p in int8._cache)
    for rb, rq in zip(b_reqs, i_reqs):
        assert len(rq.out_tokens) == MAX_NEW
        assert rq.out_tokens[0] == rb.out_tokens[0]
    for k in STAT_KEYS:
        assert int8.stats[k] == base.stats[k], k
    assert base.kv_bytes_per_token == kv_bytes_per_token(JCFG)
    assert int8.kv_bytes_per_token == kv_bytes_per_token(JCFG,
                                                         quantized=True)
