"""Port parity: prefix sharing with copy-on-write pages.

- ``PagePool`` refcounts, ``page_keys`` and ``PrefixCache`` insert /
  lookup / adopt / LRU eviction against the reference's classes, on the
  same seeded operation sequences (every return value, every refusal, the
  free count and the refcounts after each operation);
- the engine with ``prefix_cache=True`` on the reference serving tests'
  model: its greedy tokens equal the reference model's greedy continuation
  (never the reference engine's tokens, which vary from run to run,
  ROADMAP.md §C) and its stats equal the reference engine's, which depend
  only on lengths and scheduling, for the three-request scenario and the
  eviction cases of ``tests/test_prefix_cache.py``;
- ``copy_page`` on model-dtype and int8 pools against the reference's;
- the suffix prefill (``prefill(offsets=...)``) logits against the
  reference's, float32, 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import transformer as JT
from repro.serve import paged_cache as JPC
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from torch_parity import (greedy_continuation, np_params,  # noqa: F401
                          tiny_dense_config, to_torch, torch_config, tp)

JCFG = tiny_dense_config()
TCFG = torch_config(JCFG)
PS = 8
CAP = 32
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
PREFIX_KEYS = ("prefix_hits", "prefix_misses", "shared_pages_mapped",
               "cow_forks", "prefix_evictions", "prefill_calls",
               "prefill_tokens", "decode_steps", "decode_slot_tokens",
               "generated_tokens", "blocked_admissions", "truncated_budgets",
               "peak_pages_used")


@pytest.fixture(scope="module")
def params(tp):
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, tp.interop.params_from_jax(np_params(jp), TCFG, device="cpu")


# ---------------------------------------------------------------------------
# the pool and the trie, operation by operation against the reference
# ---------------------------------------------------------------------------


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e).split(":")[0])


def _pool_trace(PC, seed: int, n_ops: int = 300):
    """A seeded sequence of allocs, shares, releases and batch frees (some
    invalid) on one pool; every outcome and the pool's state after it."""
    rng = np.random.default_rng(seed)
    pool = PC.PagePool(12)
    held: list[int] = []
    trace = []
    for _ in range(n_ops):
        op = rng.integers(0, 5)
        if op == 0:
            n = int(rng.integers(0, 5))
            out = _outcome(lambda: pool.alloc(n))
            if out[0] == "ok":
                held.extend(out[1])
        elif op == 1 and held:
            p = held[int(rng.integers(len(held)))]
            out = _outcome(lambda: pool.share(p))
            if out[0] == "ok":
                held.append(p)
        elif op == 2:
            p = (held[int(rng.integers(len(held)))] if held and
                 rng.random() < 0.8 else int(rng.integers(0, 12)))
            out = _outcome(lambda: pool.release(p))
            if out[0] == "ok":
                held.remove(p)
        elif op == 3:
            k = int(rng.integers(0, 4))
            picks = rng.integers(0, max(len(held), 1), size=k)
            batch = [held[int(i)] for i in picks] if held else []
            if rng.random() < 0.2:
                batch.append(int(rng.integers(0, 12)))
            out = _outcome(lambda: pool.free(batch))
            if out[0] == "ok":
                for p in batch:
                    held.remove(p)
        else:
            out = ("state", pool.min_free)
        trace.append((out, pool.free_pages,
                      [pool.refcount(p) for p in range(12)]))
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_pool_refcounts_match_reference(tp, seed):
    assert _pool_trace(tp.paged_cache, seed) == _pool_trace(JPC, seed)


def test_pool_guards_match_reference(tp):
    """The reference's own pool cases: a shared page survives its owner's
    free, a rejected batch frees nothing, k releases of a page need a count
    of k."""
    def case(PC):
        pool = PC.PagePool(6)
        a, b = pool.alloc(2)
        out = [pool.share(a), pool.release(a), pool.release(a),
               _outcome(lambda: pool.release(a)),
               _outcome(lambda: pool.share(PC.TRASH_PAGE)),
               _outcome(lambda: pool.free([b, a])), pool.refcount(b)]
        c, d = pool.alloc(2)
        out += [_outcome(lambda: pool.free([c, d, c])), pool.free_pages,
                pool.share(c), _outcome(lambda: pool.free([c, c, d])),
                pool.free_pages, _outcome(lambda: pool.alloc(5)),
                pool.alloc(pool.free_pages)]
        return out
    assert case(tp.paged_cache) == case(JPC)


@pytest.mark.parametrize("n,ps", [(13, 8), (16, 8), (7, 8), (0, 4), (33, 16)])
def test_page_keys_match_reference(tp, n, ps):
    p = np.random.default_rng(n).integers(0, 1000, size=n).astype(np.int32)
    assert tp.paged_cache.page_keys(p, ps) == JPC.page_keys(p, ps)


def _trie_trace(PC, seed: int, n_ops: int = 200):
    """Seeded lookups, inserts (adopting pages the trace allocates) and
    evictions, with sharers pinning pages in between."""
    rng = np.random.default_rng(seed)
    pool = PC.PagePool(24)
    cache = PC.PrefixCache()
    prompts = [rng.integers(0, 4, size=int(rng.integers(1, 6)) * PS)
               .astype(np.int32) for _ in range(6)]
    pinned: list[int] = []
    trace = []
    for _ in range(n_ops):
        op = rng.integers(0, 4)
        keys = PC.page_keys(prompts[int(rng.integers(len(prompts)))], PS)
        if op == 0:
            out = cache.lookup(keys)
        elif op == 1:
            if len(keys) > pool.free_pages:
                out = ("full", cache.evict(pool, len(keys)))
            else:
                pages = pool.alloc(len(keys))
                adopted = cache.insert(keys, pages)
                pool.free([p for p in pages if p not in adopted])
                out = sorted(adopted)
        elif op == 2:
            out = cache.evict(pool, int(rng.integers(1, 4)))
        else:
            chain = cache.lookup(keys)
            if chain and rng.random() < 0.5:
                pool.share(chain[-1])
                pinned.append(chain[-1])
            elif pinned:
                pool.release(pinned.pop())
            out = ("pins", len(pinned))
        trace.append((out, len(cache), pool.free_pages))
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_prefix_trie_matches_reference(tp, seed):
    assert _trie_trace(tp.paged_cache, seed) == _trie_trace(JPC, seed)


# ---------------------------------------------------------------------------
# copy_page
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True], ids=["model", "int8"])
def test_copy_page_matches_reference(tp, quantized):
    torch = tp.torch
    rng = np.random.default_rng(2)
    P, Hkv, Dh = 6, 2, 8
    k = rng.normal(size=(P * PS, Hkv, Dh)).astype(np.float32)
    v = rng.normal(size=(P * PS, Hkv, Dh)).astype(np.float32)
    phys = np.repeat(np.arange(P), PS).astype(np.int32)
    off = np.tile(np.arange(PS), P).astype(np.int32)
    jp = JPC._scatter(JPC.init_paged_kv(P, PS, Hkv, Dh, jnp.float32,
                                        quantized=quantized),
                      jnp.asarray(k), jnp.asarray(v), jnp.asarray(phys),
                      jnp.asarray(off))
    tpg = tp.paged_cache.init_paged_kv(P, PS, Hkv, Dh, torch.float32, "cpu",
                                       quantized=quantized)
    tp.paged_cache._scatter(tpg, torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(phys).long(),
                            torch.from_numpy(off).long())
    before = [a.clone() for a in tpg if a is not None]
    jp = JPC.copy_page(jp, jnp.int32(2), jnp.int32(5))
    tp.paged_cache.copy_page(tpg, 2, 5)
    for name, b in zip(("k", "v", "k_scale", "v_scale"), before):
        got = getattr(tpg, name)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jp, name)))
        assert torch.equal(got[2], b[2])             # the source unchanged
        assert torch.equal(got[5], b[2])
        assert torch.equal(got[:5], b[:5])           # nothing else written


# ---------------------------------------------------------------------------
# the suffix prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True], ids=["model", "int8"])
def test_suffix_prefill_matches_reference(tp, params, quantized):
    """Two requests prefill a 16- and a 9-token prefix, then their
    suffixes (5 and 11 tokens) at offsets 16 and 8, reading the prefix
    from the pages; the suffix logits against the reference's
    ``prefill(offsets=...)``."""
    TT, torch = tp.transformer, tp.torch
    jp, tparams = params
    rng = np.random.default_rng(4)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jcache = JT.init_paged_cache(JCFG, 9, PS, quantized=quantized)
    tcache = TT.init_paged_cache(TCFG, 9, PS, "cpu", quantized=quantized)
    pre = np.zeros((2, 16), np.int32)
    pre_len = np.array([16, 9], np.int32)
    for b, n in enumerate(pre_len):
        pre[b, :n] = rng.integers(1, JCFG.vocab_size, size=n)
    jl, jcache = JT.prefill(jp, jnp.asarray(pre), jnp.asarray(pre_len),
                            jcache, jnp.asarray(table), JCFG)
    with torch.inference_mode():
        tl = TT.prefill(tparams, to_torch(pre), to_torch(pre_len), tcache,
                        to_torch(table), TCFG)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    suf = np.zeros((2, 16), np.int32)
    suf_len = np.array([5, 11], np.int32)
    offs = np.array([16, 8], np.int32)
    for b, n in enumerate(suf_len):
        suf[b, :n] = rng.integers(1, JCFG.vocab_size, size=n)
    jl, jcache = JT.prefill(jp, jnp.asarray(suf), jnp.asarray(suf_len),
                            jcache, jnp.asarray(table), JCFG,
                            offsets=jnp.asarray(offs))
    with torch.inference_mode():
        tl = TT.prefill(tparams, to_torch(suf), to_torch(suf_len), tcache,
                        to_torch(table), TCFG, offsets=to_torch(offs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    if quantized:       # the suffix rows were written as the reference's
        for name in ("k", "v", "k_scale", "v_scale"):
            want = np.asarray(getattr(jcache[0][0], name))[0]
            np.testing.assert_array_equal(getattr(tcache[0], name).numpy(),
                                          want)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _serve(calls, eng, Request, max_new):
    """Each element of ``calls`` one ``generate`` on ``eng``; returns every
    request's tokens, in call order."""
    out = []
    for prompts in calls:
        rs = eng.generate([Request(prompt=p, max_new_tokens=max_new,
                                   eos_id=JCFG.vocab_size) for p in prompts])
        out.extend(r.out_tokens for r in rs)
    return out


def _scenario(name):
    """The reference's engine cases (``tests/test_prefix_cache.py:145-240``):
    the calls, engine arguments and new tokens of each."""
    V = JCFG.vocab_size
    if name == "share_refeed_fork":
        rng = np.random.default_rng(5)
        base = rng.integers(1, V, size=2 * PS).astype(np.int32)
        ext = np.concatenate(
            [base, rng.integers(1, V, size=5).astype(np.int32)])
        return [[base], [ext], [base]], {}, 6
    if name == "matching_chain_under_exhaustion":
        rng = np.random.default_rng(7)
        p = rng.integers(1, V, size=16).astype(np.int32)
        return [[p], [p]], {"num_pages": 4}, 2
    if name == "eviction_spares_looked_up_chain":
        rng = np.random.default_rng(8)
        p1 = rng.integers(1, V, size=16).astype(np.int32)
        p2 = rng.integers(1, V, size=16).astype(np.int32)
        return [[p1], [p2], [p1]], {"num_pages": 6}, 2
    if name == "eviction_under_page_pressure":
        rng = np.random.default_rng(6)
        p1 = rng.integers(1, V, size=16).astype(np.int32)
        p2 = rng.integers(1, V, size=17).astype(np.int32)
        return [[p1], [p2]], {"num_pages": 5}, 6
    # four requests on one 2-page prefix, three of them in one batch
    rng = np.random.default_rng(9)
    pre = rng.integers(1, V, size=2 * PS)
    grp = [np.concatenate([pre, rng.integers(1, V, size=n)]).astype(np.int32)
           for n in (3, 9, 1, 6)]
    return [grp[:1], grp[1:]], {"batch_slots": 3}, 5


SCENARIOS = ("share_refeed_fork", "matching_chain_under_exhaustion",
             "eviction_spares_looked_up_chain", "eviction_under_page_pressure",
             "batched_sharers")


@pytest.mark.parametrize("name", SCENARIOS)
def test_engine_prefix_sharing_tokens_and_stats(tp, params, name):
    jp, tparams = params
    calls, extra, max_new = _scenario(name)
    kw = dict(batch_slots=1, capacity=CAP, page_size=PS, prefix_cache=True)
    kw.update(extra)
    teng = tp.engine.ServeEngine(TCFG, tparams, device="cpu", **kw)
    ttoks = _serve(calls, teng, tp.engine.Request, max_new)
    jeng = JServeEngine(JCFG, jp, **kw)
    _serve(calls, jeng, JRequest, max_new)
    prompts = [p for call in calls for p in call]
    assert ttoks == greedy_continuation(jp, JCFG, prompts, max_new, CAP)
    for k in PREFIX_KEYS:
        assert teng.stats[k] == jeng.stats[k], k
    # under exhaustion the chain is traded for room, and under pressure the
    # second prompt shares nothing: no hit there, as in the reference
    assert (teng.stats["prefix_hits"] > 0) == (name in (
        "share_refeed_fork", "eviction_spares_looked_up_chain",
        "batched_sharers"))
    if name == "share_refeed_fork":
        assert (teng.stats["cow_forks"], teng.stats["prefill_tokens"]) == \
            (1, 2 * PS + 5 + 1)
    if name.startswith("eviction") or name.startswith("matching"):
        assert teng.stats["prefix_evictions"] >= 1
    # the cache holds exactly the pages the pool counts as cached: every
    # page the engine still holds is a trie page with one reference
    held = [p for p in range(teng.num_pages)
            if teng._pool.refcount(p) > 0]
    assert len(held) == len(teng._prefix)
    assert all(teng._pool.refcount(p) == 1 for p in held)


def test_engine_fork_leaves_the_shared_page(tp, params):
    """The fully covered prompt re-feeds its last token into a fork: the
    cached chain's pages hold the same bytes before and after, and the
    fork's page holds the chain's last page plus the re-fed row."""
    jp, tparams = params
    torch = tp.torch
    calls, _, _ = _scenario("share_refeed_fork")
    base = calls[0][0]
    eng = tp.engine.ServeEngine(TCFG, tparams, device="cpu", batch_slots=1,
                                capacity=CAP, page_size=PS, prefix_cache=True)
    R = tp.engine.Request
    for p in calls[0] + calls[1]:
        eng.generate([R(prompt=p, max_new_tokens=6, eos_id=JCFG.vocab_size)])
    chain = eng._prefix.lookup(tp.paged_cache.page_keys(base, PS))
    before = [a[chain].clone() for pages in eng._cache for a in pages
              if a is not None]
    eng.generate([R(prompt=base, max_new_tokens=6, eos_id=JCFG.vocab_size)])
    after = [a[chain] for pages in eng._cache for a in pages if a is not None]
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert eng.stats["cow_forks"] == 1
