"""Port parity: per-request grouped-GEMM backends and the paged-attention
registry.

- One ``generate`` whose requests ask for different backends is served in
  groups, one per resolved backend (``use_backend`` of each); every
  group's greedy tokens equal the reference model's greedy continuation
  (``tests/test_torch_serve.py``'s reduced Mixtral, ``moe_impl="blaze"``).
- An unknown override raises at ``enqueue`` and before any token at
  ``generate``, as in the reference.
- ``resolve_paged_attn``: names, precedence (arg > config >
  ``REPRO_PAGED_ATTN`` > auto), provenance and errors against the
  reference's.  One deliberate deviation (ROADMAP.md §C, C6): auto is the
  kernel (``pallas``) for a CUDA engine, because the kernel is the port's
  decode path; for a CPU engine it is ``dense``, the reference's auto.
- ``dense`` (the plain gather) and the kernel's plain version agree on the
  CPU, and with the reference's ``dense``, over model-dtype and int8 pages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.models import transformer as JT
from repro.serve import paged_cache as JPC
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from torch_parity import (greedy_continuation, np_params,  # noqa: F401
                          to_torch, torch_config, tp)

JCFG = get_config("mixtral_8x7b").reduced()
TCFG = torch_config(JCFG)
CAPACITY, MAX_NEW = 48, 5


@pytest.fixture(scope="module")
def params(tp):
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, tp.interop.params_from_jax(np_params(jp), TCFG, device="cpu")


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(3, JCFG.vocab_size, size=n).astype(np.int32)
            for n in (3, 40, 17, 9, 25)]


@pytest.fixture(scope="module")
def greedy_ref(params):
    return greedy_continuation(params[0], JCFG, _prompts(), MAX_NEW,
                               CAPACITY)


@pytest.mark.parametrize("engine_backend,overrides", [
    ("segment", ("pallas", "ragged", None, "pallas_fused", "pallas")),
    ("pallas", (None, None, "segment", None, "auto")),
    ("ragged", ("ragged", "segment", "pallas_fused", "pallas", None))],
    ids=["segment", "pallas", "ragged"])
def test_per_request_backends_grouped(tp, params, greedy_ref,
                                      engine_backend, overrides):
    eng = tp.engine.ServeEngine(TCFG, params[1], device="cpu", batch_slots=2,
                                capacity=CAPACITY, page_size=16,
                                gmm_backend=engine_backend)
    groups = []
    real = eng._serve_group

    def serve_group(requests, name):
        from repro_torch.core import gmm_backend as GB
        groups.append((name, [r.rid for r in requests]))
        real(requests, name)
        assert GB.active_backend() is None      # the scope was left

    eng._serve_group = serve_group
    reqs = [tp.engine.Request(prompt=p, max_new_tokens=MAX_NEW,
                              eos_id=JCFG.vocab_size, gmm_backend=b)
            for p, b in zip(_prompts(), overrides)]
    eng.generate(reqs)
    names = [b if b not in (None, "auto") else engine_backend
             for b in overrides]
    want_groups = {}
    for r, n in zip(reqs, names):
        want_groups.setdefault(n, []).append(r.rid)
    assert groups == list(want_groups.items())
    assert set(eng._decode_fns) == set(names)
    for r, want, n in zip(reqs, greedy_ref, names):
        assert r.out_tokens == want, n
        assert r.finish_reason == "length"
        src = "arg" if r.gmm_backend not in (None, "auto") else \
            eng.backend.source
        assert (eng.resolve_request(r).name,
                eng.resolve_request(r).source) == (n, src)


def test_group_scope_reaches_the_expert_layer(tp, params, monkeypatch):
    """Inside a group the MoE sublayer resolves the group's backend: the
    backend's ``gmm`` is the one called."""
    from repro_torch.core import gmm_backend as GB
    seen = []
    for name in ("segment", "pallas"):
        cls = GB._REGISTRY[name]
        real = cls.gmm

        def spy(lhs, rhs, gs, real=real, name=name):
            seen.append(name)
            return real(lhs, rhs, gs)

        monkeypatch.setattr(cls, "gmm", staticmethod(spy))
    eng = tp.engine.ServeEngine(TCFG, params[1], device="cpu", batch_slots=2,
                                capacity=CAPACITY, gmm_backend="segment")
    R = tp.engine.Request
    p = _prompts()[0]
    eng.generate([R(prompt=p, max_new_tokens=2), R(prompt=p,
                  max_new_tokens=2, gmm_backend="pallas")])
    half = len(seen) // 2
    assert seen[:half] == ["segment"] * half
    assert seen[half:] == ["pallas"] * half


def test_unknown_backend_raises_at_enqueue_not_mid_generate(tp, params):
    eng = tp.engine.ServeEngine(TCFG, params[1], device="cpu", batch_slots=2,
                                capacity=16)
    jeng = JServeEngine(JCFG, params[0], batch_slots=2, capacity=16)
    R = tp.engine.Request
    for e, Req in ((eng, R), (jeng, JRequest)):
        with pytest.raises(ValueError, match="unknown gmm backend"):
            e.enqueue(Req(prompt=np.array([1], np.int32), gmm_backend="cuda"))
        assert e.pending == []
    good = R(prompt=np.array([1, 2], np.int32), max_new_tokens=2)
    bad = R(prompt=np.array([1, 2], np.int32), gmm_backend="cuda")
    with pytest.raises(ValueError, match="unknown gmm backend"):
        eng.generate([good, bad])
    assert good.out_tokens == []
    # the queue drains through run(); each request keeps its rid
    for i in range(3):
        eng.enqueue(R(prompt=np.array([1 + i, 2], np.int32),
                      max_new_tokens=3, gmm_backend=("pallas" if i == 1
                                                     else None)))
    done = eng.run()
    assert eng.pending == [] and len(done) == 3
    assert all(len(r.out_tokens) == 3 for r in done)


# ---------------------------------------------------------------------------
# the paged-attention registry
# ---------------------------------------------------------------------------


def _resolutions(PC, env, **kw):
    old = os.environ.pop(PC.PAGED_ATTN_ENV, None)
    try:
        if env is not None:
            os.environ[PC.PAGED_ATTN_ENV] = env
        out = []
        for arg, config in ((None, None), ("pallas", None), ("dense", None),
                            (None, "pallas"), ("auto", "dense"),
                            ("", None), ("dense", "pallas")):
            r = PC.resolve_paged_attn(arg, config=config, **kw)
            out.append((r.name, r.source, str(r)))
            assert PC.resolve_paged_attn(r) is r
        for bad in ("nope", "flash"):
            with pytest.raises(ValueError, match="unknown paged-attention"):
                PC.resolve_paged_attn(bad, **kw)
        return out
    finally:
        os.environ.pop(PC.PAGED_ATTN_ENV, None)
        if old is not None:
            os.environ[PC.PAGED_ATTN_ENV] = old


@pytest.mark.parametrize("env", [None, "pallas", "dense", "auto"])
def test_resolve_paged_attn_matches_reference(tp, env):
    """On a CPU engine every resolution is the reference's."""
    PC = tp.paged_cache
    assert PC.paged_attn_names() == JPC.paged_attn_names()
    assert PC.available_paged_attn() == JPC.available_paged_attn()
    assert _resolutions(PC, env, device="cpu") == _resolutions(JPC, env)
    assert _resolutions(PC, env) == _resolutions(JPC, env)


def test_auto_paged_attn_is_the_kernel_on_cuda(tp):
    """C6: auto resolves to the kernel for a CUDA engine; the chain above
    auto is unchanged."""
    PC = tp.paged_cache
    old = os.environ.pop(PC.PAGED_ATTN_ENV, None)
    try:
        r = PC.resolve_paged_attn(None, device="cuda")
        assert (r.name, r.source) == ("pallas", "auto")
        assert PC.resolve_paged_attn("dense", device="cuda").name == "dense"
        os.environ[PC.PAGED_ATTN_ENV] = "dense"
        assert (PC.resolve_paged_attn(None, device="cuda").source) == "env"
    finally:
        os.environ.pop(PC.PAGED_ATTN_ENV, None)
        if old is not None:
            os.environ[PC.PAGED_ATTN_ENV] = old


def test_engine_resolves_paged_kernel(tp, params):
    E = tp.engine.ServeEngine
    eng = E(TCFG, params[1], device="cpu")
    assert (eng.paged_attn.name, eng.paged_attn.source) == ("dense", "auto")
    assert E(TCFG, params[1], device="cpu",
             paged_kernel="pallas").paged_attn.source == "arg"
    with pytest.raises(ValueError, match="unknown paged-attention impl"):
        E(TCFG, params[1], device="cpu", paged_kernel="nope")


@pytest.mark.parametrize("quantized", [False, True], ids=["model", "int8"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (10, 0.0), (0, 5.0)])
def test_dense_and_kernel_plain_agree(tp, quantized, window, cap):
    torch = tp.torch
    PC = tp.paged_cache
    rng = np.random.default_rng(1)
    P, ps, Hkv, G, Dh = 13, 8, 2, 2, 16
    k = rng.normal(size=(P * ps, Hkv, Dh)).astype(np.float32)
    v = rng.normal(size=(P * ps, Hkv, Dh)).astype(np.float32)
    phys = np.repeat(np.arange(P), ps).astype(np.int32)
    off = np.tile(np.arange(ps), P).astype(np.int32)
    pages = PC.init_paged_kv(P, ps, Hkv, Dh, torch.float32, "cpu",
                             quantized=quantized)
    PC._scatter(pages, torch.from_numpy(k), torch.from_numpy(v),
                torch.from_numpy(phys).long(), torch.from_numpy(off).long())
    jpages = JPC._scatter(JPC.init_paged_kv(P, ps, Hkv, Dh, jnp.float32,
                                            quantized=quantized),
                          jnp.asarray(k), jnp.asarray(v), jnp.asarray(phys),
                          jnp.asarray(off))
    q = rng.normal(size=(4, 1, Hkv * G, Dh)).astype(np.float32)
    table = np.array([[3, 7, 0, 0], [5, 0, 0, 0], [0, 0, 0, 0],
                      [1, 2, 9, 12]], np.int32)
    pos = np.array([12, 0, 0, 27], np.int32)
    args = (to_torch(q), pages, to_torch(table), to_torch(pos))
    dense = PC.paged_attention(*args, window=window, cap=cap, impl="dense")
    kern = PC.paged_attention(*args, window=window, cap=cap, impl="pallas")
    want = JPC.paged_attention(jnp.asarray(q), jpages, jnp.asarray(table),
                               jnp.asarray(pos), window=window, cap=cap,
                               impl="dense")
    np.testing.assert_allclose(dense.numpy(), kern.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="unknown paged-attention impl"):
        PC.paged_attention(*args, impl="nope")


def test_dense_engine_tokens_equal_kernel_engine(tp, params, greedy_ref):
    """Both registered decode paths give the reference model's greedy
    tokens; only the kernel path calls the kernel's plain version."""
    calls = []
    before = tp.paged_attention.paged_attention_plain

    def spy(*a, **kw):
        calls.append(1)
        return before(*a, **kw)

    tp.paged_attention.paged_attention_plain = spy
    try:
        for impl in ("dense", "pallas"):
            del calls[:]
            eng = tp.engine.ServeEngine(TCFG, params[1], device="cpu",
                                        batch_slots=3, capacity=CAPACITY,
                                        page_size=16, paged_kernel=impl)
            reqs = eng.generate([tp.engine.Request(
                prompt=p, max_new_tokens=MAX_NEW, eos_id=JCFG.vocab_size)
                for p in _prompts()])
            assert [r.out_tokens for r in reqs] == greedy_ref
            n = eng.stats["decode_steps"] * JCFG.num_layers
            assert len(calls) == (n if impl == "pallas" else 0)
    finally:
        tp.paged_attention.paged_attention_plain = before
