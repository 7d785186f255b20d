"""Port parity: temperature sampling.

The reference samples ``jax.random.categorical(key, logits / T)`` with
``key = fold_in(fold_in(PRNGKey(seed), rid), token_index)``
(``repro/serve/engine.py:_sample_traced``), which is ``argmax(logits / T +
gumbel(key))``.  JAX's threefry stream cannot be drawn in PyTorch, so the
port hashes its own Gumbel noise from ``(seed, rid, token index, vocab
index)`` (``repro_torch/serve/sampling.py``).  Held here:

- the port's ``sample(logits, noise, T)``, fed the reference's own noise
  ``jax.random.gumbel(key)``, gives the reference engine's tokens for the
  same keys;
- a fixed seed gives the same tokens, another seed other tokens; tokens
  depend on neither the slot count nor the submission order;
- ``temperature <= 0`` raises when sampling, as in the reference;
- the noise is uniform enough: a chi-square test of 20,000 draws over a
  fixed 8-way logit vector, and the hash's bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JServeEngine
from torch_parity import (np_params, tiny_dense_config,  # noqa: F401
                          torch_config, tp)

JCFG = tiny_dense_config()
TCFG = torch_config(JCFG)


@pytest.fixture(scope="module")
def params(tp):
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, tp.interop.params_from_jax(np_params(jp), TCFG, device="cpu")


@pytest.fixture(scope="module")
def SM(tp):
    from repro_torch.serve import sampling
    return sampling


@pytest.mark.parametrize("temperature", [0.5, 0.8, 1.0, 2.0])
@pytest.mark.parametrize("seed", [0, 11])
def test_sampler_fed_jax_noise_equals_reference_engine(tp, params, SM,
                                                       temperature, seed):
    """Eight rows of random logits over a 64-word vocabulary at (rid,
    token index) pairs; the reference engine's in-graph sampler against the
    port's ``sample`` fed ``gumbel(fold_in(fold_in(seed, rid), index))``."""
    torch = tp.torch
    jeng = JServeEngine(JCFG, params[0], greedy=False,
                        temperature=temperature, seed=seed)
    rng = np.random.default_rng(seed)
    V = JCFG.vocab_size
    logits = (3 * rng.standard_normal((8, V))).astype(np.float32)
    rid = np.array([0, 1, 2, 3, 7, 7, 40, 1000], np.int32)
    gidx = np.array([0, 0, 5, 1, 0, 9, 3, 15], np.int32)
    want = np.asarray(jeng._sample_traced(jnp.asarray(logits),
                                          jnp.asarray(rid),
                                          jnp.asarray(gidx)))
    base = jax.random.PRNGKey(seed)
    noise = np.stack([np.array(jax.random.gumbel(
        jax.random.fold_in(jax.random.fold_in(base, int(r)), int(g)), (V,),
        jnp.float32)) for r, g in zip(rid, gidx)])
    got = SM.sample(torch.from_numpy(logits), torch.from_numpy(noise),
                    temperature)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("temperature", [0.7, 1.3])
@pytest.mark.parametrize("V", [8, 512, 32000])
def test_sampler_equals_jax_categorical(tp, SM, temperature, V):
    torch = tp.torch
    rng = np.random.default_rng(V)
    for i in range(4):
        key = jax.random.PRNGKey(100 + i)
        logits = (2 * rng.standard_normal((3, V))).astype(np.float32)
        want = np.asarray(jax.random.categorical(
            key, jnp.asarray(logits) / temperature))
        noise = np.array(jax.random.gumbel(key, (3, V), jnp.float32))
        got = SM.sample(torch.from_numpy(logits), torch.from_numpy(noise),
                        temperature)
        np.testing.assert_array_equal(got.numpy(), want)


def _prompts(lens=(1, 4, 7, 3, 9, 2)):
    rng = np.random.default_rng(0)
    return [rng.integers(1, JCFG.vocab_size, size=L).astype(np.int32)
            for L in lens]


def _sampled(tp, tparams, slots=2, seed=11, order=None, temperature=0.8):
    eng = tp.engine.ServeEngine(TCFG, tparams, device="cpu",
                                batch_slots=slots, capacity=32, page_size=8,
                                greedy=False, temperature=temperature,
                                seed=seed)
    reqs = [tp.engine.Request(prompt=p, max_new_tokens=6,
                              eos_id=JCFG.vocab_size, rid=i)
            for i, p in enumerate(_prompts())]
    eng.generate(reqs if order is None else [reqs[i] for i in order])
    return [r.out_tokens for r in reqs]


def test_fixed_seed_same_tokens_other_seed_other_tokens(tp, params):
    a = _sampled(tp, params[1])
    assert a == _sampled(tp, params[1])
    assert a != _sampled(tp, params[1], seed=12)
    assert a != _sampled(tp, params[1], temperature=2.0)


@pytest.mark.parametrize("slots,order", [(1, None), (3, None),
                                         (2, [5, 4, 3, 2, 1, 0]),
                                         (4, [2, 0, 5, 1, 4, 3])])
def test_tokens_do_not_depend_on_slots_or_order(tp, params, slots, order):
    assert _sampled(tp, params[1], slots=slots, order=order) == \
        _sampled(tp, params[1])


def test_engine_rids_are_assigned_in_submission_order(tp, params):
    eng = tp.engine.ServeEngine(TCFG, params[1], device="cpu", greedy=False)
    reqs = [tp.engine.Request(prompt=p, max_new_tokens=2) for p in _prompts()]
    for r in reqs:
        eng.enqueue(r)
    assert [r.rid for r in reqs] == list(range(len(reqs)))


@pytest.mark.parametrize("temperature", [0.0, -1.0])
def test_temperature_must_be_positive_when_sampling(tp, params, temperature):
    for make in (lambda **kw: tp.engine.ServeEngine(TCFG, params[1],
                                                    device="cpu", **kw),
                 lambda **kw: JServeEngine(JCFG, params[0], **kw)):
        with pytest.raises(ValueError, match="temperature"):
            make(greedy=False, temperature=temperature)
        make(greedy=True, temperature=temperature)    # greedy ignores it


def test_chi_square_over_eight_way_logits(tp, SM):
    """20,000 draws, one per (rid, token index), over fixed logits at
    T = 0.8: Pearson's statistic with 7 degrees of freedom under 24.32
    (p = 0.001)."""
    torch = tp.torch
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 0.25, 1.5]])
    n = 20000
    rid = torch.arange(n, dtype=torch.int32) // 4
    gidx = torch.arange(n, dtype=torch.int32) % 4
    noise = SM.gumbel_noise(3, rid, gidx, 8)
    toks = SM.sample(logits.expand(n, 8), noise, 0.8)
    counts = np.bincount(toks.numpy(), minlength=8)
    p = torch.softmax(logits[0] / 0.8, 0).double().numpy()
    chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
    assert chi2 < 24.32, (chi2, counts, n * p)


def test_noise_bits_are_uniform_and_distinct(tp, SM):
    """The hashes of 4 rows x 32,000 vocabulary entries, top 4 bits: each
    of 16 equal bins within 4% of its share, no two rows alike, and the
    noise a function of (seed, rid, index) only (a row's noise is the same
    in any batch); row keys agree with a plain-integer murmur3 finalizer."""
    torch = tp.torch
    rid = torch.tensor([0, 1, 0, 5], dtype=torch.int32)
    gidx = torch.tensor([0, 0, 1, 0], dtype=torch.int32)
    bits = SM.uniform_bits(torch.from_numpy(SM.row_keys(7, rid, gidx)),
                           32000)
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32
    hist = np.bincount((bits >> 28).numpy().ravel(), minlength=16)
    assert np.all(np.abs(hist / (bits.numel() / 16) - 1) < 0.04), hist
    assert len({tuple(r[:64].tolist()) for r in bits}) == 4
    alone = SM.gumbel_noise(7, rid[3:], gidx[3:], 32000)
    assert torch.equal(alone[0], SM.gumbel_noise(7, rid, gidx, 32000)[3])
    assert not torch.equal(SM.gumbel_noise(8, rid, gidx, 32000),
                           SM.gumbel_noise(7, rid, gidx, 32000))

    def fmix(x):
        x ^= x >> 16
        x = x * 0x85EBCA6B % 2 ** 32
        x ^= x >> 13
        x = x * 0xC2B2AE35 % 2 ** 32
        return x ^ (x >> 16)

    for seed, r, g in ((7, 0, 0), (2 ** 40 + 3, 70000, 15), (0, -1, 9)):
        k = fmix(fmix(fmix((seed ^ 0x243F6A88) % 2 ** 32) ^ (r % 2 ** 32))
                 ^ g)
        assert int(SM.row_keys(seed, np.array([r]), np.array([g]))[0]) == k
        v = fmix(5 ^ 0x6A09E667)
        want = fmix(k ^ v)
        got = SM.uniform_bits(torch.tensor([k]), 6)[0, 5]
        assert int(got) == want
