"""Port parity: the cache decode path (``init_cache`` / ``decode_step``),
its attention (``decode_attention`` over a rolling ``KVCache``) and the
dense int8 cache of ``serve/kv_quant.py``.

- ``decode_attention`` against the reference's on the same caches: empty
  slots, a scalar and a per-request ``(B,)`` position, a window, a
  softcap, float32 and bfloat16 caches.
- The attention sublayer's cache branch fed token by token past its
  capacity (the rolling slot ``pos % C`` wraps), with per-request
  positions, against the reference's sublayer.
- The quantized cache at the cases of ``tests/test_kv_quant.py``.
- ``init_cache`` and N steps of ``decode_step`` against the reference for
  reduced Hymba (past its window), xLSTM, Gemma2-27B (past its local
  window) and Qwen3-14B, with weights converted from the reference's init.
- The reference's ``ValueError``s: ``init_paged_cache``, ``ServeEngine``
  and ``launch/serve.py`` for a recurrent pattern, ``decode_step`` for
  frame inputs.

Tolerances: float32 attention 1e-5 absolute (the same float32 sums in
another order); bfloat16 attention one bf16 step (2^-7) of the output's
scale (both sides round q to bf16, take float32 scores and round the
output once); the int8 cache as tight as the reference's own tests (its
3e-2 against the float cache; against the reference's int8 attention
1e-5, the same float32 arithmetic); decode logits 1e-4 (float32 through
two to eight layers, sums in another order), and for xLSTM 1e-4 over
1e-3 of the logits' scale: its mLSTM normalizer amplifies float32
rounding from layer to layer (measured: ~3.5x a layer at the reduced
init), so eight layers take a looser absolute floor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.serve import kv_quant as JQ
from torch_parity import as_dtype, f32, np_params, to_torch, torch_config
from torch_parity import tp  # noqa: F401


def _attn_inputs(seed, B=3, C=24, Hq=4, Hkv=2, Dh=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, C, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, C, Hkv, Dh)).astype(np.float32)
    # rolling caches: request b holds positions up to 30 + 7 b; two empty
    # slots in request 0
    slot_pos = np.full((B, C), -1, np.int32)
    for b in range(B):
        for t in range(31 + 7 * b):
            slot_pos[b, t % C] = t
    slot_pos[0, 3] = slot_pos[0, 9] = -1
    return q, k, v, slot_pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos,window,cap", [
    (30, 0, 0.0), ((30, 37, 44), 0, 0.0), ((30, 37, 44), 10, 0.0),
    (25, 0, 5.0), ((12, 40, 44), 16, 20.0)])
def test_decode_attention_matches_reference(tp, dtype, pos, window, cap):
    q, k, v, slot_pos = _attn_inputs(len(str(pos)) + window)
    q, k, v = (as_dtype(a, dtype) for a in (q, k, v))
    p = np.asarray(pos, np.int32)
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(slot_pos), jnp.asarray(p),
                               window=window, cap=cap)
    from repro_torch.models.attention import decode_attention
    got = decode_attention(to_torch(q), to_torch(k), to_torch(v),
                           to_torch(slot_pos), to_torch(p), window=window,
                           cap=cap)
    assert got.dtype == tp.dtype[dtype] and got.shape == q.shape
    want = f32(want)
    atol = (1e-5 if dtype == "float32"
            else 2 ** -7 * float(np.abs(want).max()))
    np.testing.assert_allclose(f32(got), want, atol=atol)


@pytest.mark.parametrize("local", [False, True])
def test_rolling_cache_sublayer_matches_reference(tp, local):
    """Reduced Gemma2's attention (window 64, softcap 50) decoding 80
    tokens into a cache of 48 slots: the slot of position p is p % 48, so
    the cache wraps; requests sit at their own positions (the second two
    tokens behind)."""
    torch = tp.torch
    from repro_torch.models.attention import attention_sublayer, init_kv_cache
    jcfg = get_config("gemma2_27b").reduced().replace(num_layers=2)
    tcfg = torch_config(jcfg)
    jp = JA.init_attn_params(jax.random.PRNGKey(1), jcfg, jcfg.d_model)
    tpar = {k: to_torch(v) for k, v in np_params(jp).items()}
    B, C, T = 2, 48, 80
    dh = jcfg.resolved_head_dim
    x = np.random.default_rng(3).standard_normal(
        (T, B, 1, jcfg.d_model)).astype(np.float32)
    jcache = JA.init_kv_cache(B, C, jcfg.num_kv_heads, dh, jnp.float32)
    tcache = init_kv_cache(B, C, jcfg.num_kv_heads, dh, torch.float32, "cpu")
    step = jax.jit(lambda x_, c_, pos_: JA.attention_sublayer(
        x_, jp, jcfg, is_local=local, positions=pos_, cache=c_))
    for t in range(T):
        pos = np.array([t, max(t - 2, 0)], np.int32)
        want, jcache = step(jnp.asarray(x[t]), jcache, jnp.asarray(pos))
        with torch.no_grad():
            got, tcache = attention_sublayer(
                to_torch(x[t]), tpar, tcfg, is_local=local,
                positions=to_torch(pos), cache=tcache)
        np.testing.assert_allclose(f32(got), f32(want), atol=1e-5,
                                   err_msg=f"t={t}")
    np.testing.assert_array_equal(tcache.slot_pos.numpy(),
                                  np.asarray(jcache.slot_pos))
    np.testing.assert_allclose(f32(tcache.k), f32(jcache.k), atol=1e-6)


def test_quant_roundtrip_and_dtypes(tp):
    KQ = tp.kv_quant
    x = np.random.default_rng(0).standard_normal((4, 8, 64)).astype(
        np.float32) * 3
    q, s = KQ.quantize(to_torch(x))
    jq, js = JQ.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    x2 = KQ.dequantize(q, s)
    assert float((x2 - to_torch(x)).abs().max()) / np.abs(x).max() < 1e-2
    assert q.dtype == tp.torch.int8 and s.dtype == tp.torch.float16
    for dt in (tp.torch.float32, tp.torch.bfloat16, tp.torch.float16):
        assert KQ.dequantize(q, s, dt).dtype == dt


@pytest.mark.parametrize("window,pos", [(0, 23), (16, 23), (0, (11, 23)),
                                        (16, (5, 23))])
def test_quant_decode_matches_reference_and_fp(tp, window, pos):
    """The reference's ``test_quant_decode_matches_fp`` case (24 tokens
    appended, scalar and per-request positions, with and without a
    window): the port's int8 attention against the reference's, and
    against the port's float cache at the reference test's 3e-2."""
    torch, KQ = tp.torch, tp.kv_quant
    from repro_torch.models.attention import decode_attention, init_kv_cache
    B, C, Hq, Hkv, Dh, S = 2, 32, 4, 2, 16, 24
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, 1, Hq, Dh)).astype(np.float32)
    kk = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    vv = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    fp = init_kv_cache(B, C, Hkv, Dh, torch.float32, "cpu")
    qc = KQ.init_quant_cache(B, C, Hkv, Dh)
    jqc = JQ.init_quant_cache(B, C, Hkv, Dh)
    for t in range(S):
        fp.k[:, t] = to_torch(kk[:, t])
        fp.v[:, t] = to_torch(vv[:, t])
        fp.slot_pos[:, t] = t
        qc = KQ.append(qc, to_torch(kk[:, t]), to_torch(vv[:, t]), t)
        jqc = JQ.append(jqc, jnp.asarray(kk[:, t]), jnp.asarray(vv[:, t]),
                        jnp.array(t))
    for got, want in zip(qc, jqc):
        np.testing.assert_array_equal(f32(got), f32(want))
    p = np.asarray(pos, np.int32)
    out = KQ.decode_attention_quant(to_torch(q), qc, to_torch(p),
                                    window=window, cap=5.0 if window else 0.0)
    want = JQ.decode_attention_quant(jnp.asarray(q), jqc, jnp.asarray(p),
                                     window=window,
                                     cap=5.0 if window else 0.0)
    np.testing.assert_allclose(f32(out), f32(want), atol=1e-5)
    if not window:
        ref = decode_attention(to_torch(q), fp.k, fp.v, fp.slot_pos,
                               to_torch(p), window=window)
        np.testing.assert_allclose(f32(out), f32(ref), atol=3e-2, rtol=3e-2)


def test_quant_cache_rolls_halves_bytes_and_takes_request_positions(tp):
    """The reference's rolling, byte and per-request cases."""
    torch, KQ = tp.torch, tp.kv_quant
    from repro_torch.models.attention import init_kv_cache
    qc = KQ.init_quant_cache(1, 8, 1, 8)
    for t in range(20):
        k = torch.full((1, 1, 8), float(t))
        qc = KQ.append(qc, k, k, t)
    assert sorted(qc.slot_pos[0].tolist()) == list(range(12, 20))
    fp_b = KQ.cache_bytes(init_kv_cache(2, 128, 4, 64, torch.bfloat16, "cpu"))
    qc_b = KQ.cache_bytes(KQ.init_quant_cache(2, 128, 4, 64))
    assert qc_b == JQ.cache_bytes(JQ.init_quant_cache(2, 128, 4, 64))
    assert qc_b < 0.55 * fp_b
    # per-request positions: each row equals its solo run
    B, C, Hq, Hkv, Dh = 2, 16, 2, 1, 8
    rng = np.random.default_rng(3)
    q = to_torch(rng.standard_normal((B, 1, Hq, Dh)).astype(np.float32))
    kk = to_torch(rng.standard_normal((B, C, Hkv, Dh)).astype(np.float32))
    vv = to_torch(rng.standard_normal((B, C, Hkv, Dh)).astype(np.float32))
    lens = [5, 11]
    qc = KQ.init_quant_cache(B, C, Hkv, Dh)
    for t in range(C):
        qc = KQ.append(qc, kk[:, t], vv[:, t], t)
    out = KQ.decode_attention_quant(q, qc, torch.tensor([L - 1 for L in lens]))
    for b, L in enumerate(lens):
        solo = KQ.init_quant_cache(1, C, Hkv, Dh)
        for t in range(L):
            solo = KQ.append(solo, kk[b:b + 1, t], vv[b:b + 1, t], t)
        ref = KQ.decode_attention_quant(q[b:b + 1], solo, L - 1)
        np.testing.assert_allclose(f32(out[b]), f32(ref[0]), atol=1e-5)
    stag = KQ.append(KQ.init_quant_cache(B, C, Hkv, Dh), kk[:, 0], vv[:, 0],
                     torch.tensor([2, 7]))
    sp = stag.slot_pos.numpy()
    assert sp[0, 2] == 2 and sp[1, 7] == 7 and sp[0, 7] == -1 \
        and sp[1, 2] == -1


def _decode_cases():
    return [
        # window 64, so 80 steps into a 96-slot cache pass the window
        ("hymba", get_config("hymba_1_5b").reduced(), 96, 80, 1e-4),
        ("xlstm", get_config("xlstm_1_3b").reduced().replace(
            num_layers=8, d_model=64, num_heads=2, vocab_size=128), 32, 24,
         1e-3),
        ("gemma2", get_config("gemma2_27b").reduced(), 96, 80, 1e-4),
        ("qwen3-14b", get_config("qwen3_14b").reduced(), 32, 24, 1e-4)]


@pytest.mark.parametrize("name,jcfg,capacity,steps,floor", _decode_cases(),
                         ids=[c[0] for c in _decode_cases()])
def test_decode_steps_match_reference(tp, name, jcfg, capacity, steps,
                                      floor):
    """``init_cache`` then ``steps`` teacher-forced ``decode_step`` calls
    (B=2) from weights converted from the reference's init: every step's
    logits against the reference's, and the final cache."""
    torch = tp.torch
    T = tp.transformer
    tcfg = torch_config(jcfg)
    jp = JT.init_params(jax.random.PRNGKey(5), jcfg)
    params = tp.interop.params_from_jax(np_params(jp), tcfg, device="cpu",
                                        dtype=torch.float32)
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, size=(2, steps)).astype(np.int32)
    jcache = JT.init_cache(jcfg, 2, capacity)
    tcache = T.init_cache(tcfg, 2, capacity, "cpu")
    assert len(tcache) == tcfg.num_layers
    assert tp.kv_quant.cache_bytes(tcache) == sum(
        a.size * a.dtype.itemsize for a in jax.tree.leaves(jcache))
    jstep = jax.jit(lambda c, t, pos: JT.decode_step(jp, c, {"tokens": t},
                                                     pos, jcfg))
    for t in range(steps):
        want, jcache = jstep(jcache, jnp.asarray(toks[:, t:t + 1]), t)
        with torch.no_grad():
            got, tcache = T.decode_step(params, tcache,
                                        {"tokens": to_torch(toks[:, t:t + 1])},
                                        t, tcfg)
        want = f32(want)
        np.testing.assert_allclose(f32(got), want, rtol=1e-4,
                                   atol=max(1e-4, floor * np.abs(want).max()),
                                   err_msg=f"{name} step {t}")


def test_refusals_match_reference(tp):
    """A recurrent pattern is refused by ``init_paged_cache`` and
    ``ServeEngine`` with the reference's ``ValueError``; ``decode_step``
    refuses frame inputs as the reference does."""
    T, SE = tp.transformer, tp.engine
    for arch in ("hymba_1_5b", "xlstm_1_3b"):
        tcfg = torch_config(get_config(arch).reduced())
        assert not T.paged_supported(tcfg)
        assert not JT.paged_supported(get_config(arch))
        with pytest.raises(ValueError, match="use T.decode_step"):
            T.init_paged_cache(tcfg, 4, 16, "cpu")
        with pytest.raises(ValueError, match="serve those via T.decode_step"):
            SE.ServeEngine(tcfg, tp.interop.init_params(tcfg, device="cpu"),
                           device="cpu")
    from repro_torch.launch import serve as launch_serve
    for arch, layers in (("hymba-1.5b", "2"), ("xlstm-1.3b", "8")):
        with pytest.raises(ValueError, match="serve those via T.decode_step"):
            launch_serve.main(["--arch", arch, "--reduced", "--layers",
                               layers, "--device", "cpu"])
    for arch in ("gemma2_27b", "yi_6b", "deepseek_coder_33b"):
        assert T.paged_supported(torch_config(get_config(arch)))
    hubert = torch_config(get_config("hubert_xlarge").reduced())
    with pytest.raises(ValueError, match="encoder-only"):
        T.decode_step({}, [], {"tokens": None}, 0, hubert)
    with pytest.raises(NotImplementedError, match="§A item 5"):
        T.forward({}, {"tokens": None}, hubert)
