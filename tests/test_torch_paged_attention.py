"""Port parity: paged decode attention.

The plain version runs here against the reference's Pallas kernel
(interpret mode) and its dense gather path, for {float32, bfloat16} x
{sliding window, softcap}, including a request at position 0 and a dead
slot (table all trash).  Tolerances: float32 1e-5; bfloat16 2e-2 (the dense
reference rounds the scaled query and the probabilities to bf16, the kernel
keeps float32, and the output rounds to bf16 once).

The int8 branch: ``kv_quant.quantize`` is bit-equal to the reference's
(round half to even of the value over the float32 scale, the scale stored
as float16), and the plain version over int8 pools against the reference's
Pallas kernel (interpret) and its dense gather path on the same pools, with
a GQA group of 5, the same windows and softcaps, position 0 and a dead
slot.  Tolerances: a float32 query 1e-5; a bfloat16 query 2e-2 (the dense
reference rounds the scaled query to bf16, the kernel keeps float32, and
the bf16 output of either kernel may round to a neighbouring value).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.paged_attention import paged_attention_pallas
from repro.serve import kv_quant as JKQ
from repro.serve import paged_cache as JPC
from torch_parity import as_dtype, f32, to_torch, tp  # noqa: F401

P, PS, HKV, G, DH = 13, 8, 2, 2, 16
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _case(dtype, seed=0):
    """4 requests: mid-sequence, position 0, a dead slot (all trash, pos 0)
    and a long one reaching into its 4th page."""
    rng = np.random.default_rng(seed)
    k = as_dtype(rng.normal(size=(P, PS, HKV, DH)), dtype)
    v = as_dtype(rng.normal(size=(P, PS, HKV, DH)), dtype)
    q = as_dtype(rng.normal(size=(4, 1, HKV * G, DH)), dtype)
    table = np.array([[3, 7, 0, 0], [5, 0, 0, 0], [0, 0, 0, 0],
                      [1, 2, 9, 12]], np.int32)
    pos = np.array([12, 0, 0, 27], np.int32)
    return q, k, v, table, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (10, 0.0), (0, 5.0),
                                        (6, 5.0)])
def test_paged_attention_matches_reference(tp, dtype, window, cap):
    q, k, v, table, pos = _case(dtype)
    ref_kernel = paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None,
        jnp.asarray(table), jnp.asarray(pos), window=window, cap=cap)
    ref_dense = JPC.paged_gather_attention(
        jnp.asarray(q), JPC.PagedKV(jnp.asarray(k), jnp.asarray(v), None,
                                    None),
        jnp.asarray(table), jnp.asarray(pos)[:, None], window=window, cap=cap)
    tq, tk, tv, tt, tpos = (to_torch(a) for a in (q, k, v, table, pos))
    out = tp.paged_attention.paged_attention(tq, tk, tv, tt, tpos,
                                             window=window, cap=cap)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(f32(out), f32(ref_kernel), **TOL[dtype])
    np.testing.assert_allclose(f32(out), f32(ref_dense), **TOL[dtype])
    # the port's dense path, same rounding points as the reference's
    dense = tp.paged_cache.paged_gather_attention(
        tq, tp.paged_cache.PagedKV(tk, tv), tt, tpos[:, None],
        window=window, cap=cap)
    np.testing.assert_allclose(f32(dense), f32(ref_dense), **TOL["float32"])
    assert np.isfinite(f32(out)).all()


def test_quantize_matches_reference(tp):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 3, 16)).astype(np.float32) * 3.0
    x[0, 0] = 0.0                              # absmax 0: the 1e-8 floor
    x[1, 0, :4] = [127.0, -63.5, 0.5, 1.5]     # ties round half to even
    jq, js = JKQ.quantize(jnp.asarray(x))
    tq, ts = tp.kv_quant.quantize(to_torch(x))
    assert tq.dtype == tp.torch.int8 and ts.dtype == tp.torch.float16
    assert (tq.numpy() == np.asarray(jq)).all()
    assert (ts.numpy() == np.asarray(js)).all()
    deq = tp.kv_quant.dequantize(tq, ts)
    np.testing.assert_array_equal(deq.numpy(),
                                  np.asarray(JKQ.dequantize(jq, js)))


def _int8_case(dtype, seed=1):
    """As :func:`_case` with a GQA group of 5 and int8 pools quantized from
    normal keys and values."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(P, PS, HKV, DH)).astype(np.float32)
    v = rng.normal(size=(P, PS, HKV, DH)).astype(np.float32)
    q = as_dtype(rng.normal(size=(4, 1, HKV * 5, DH)), dtype)
    kq, ks = (np.asarray(a) for a in JKQ.quantize(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in JKQ.quantize(jnp.asarray(v)))
    _, _, _, table, pos = _case(dtype)
    return q, kq, vq, ks, vs, table, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (10, 0.0), (0, 5.0),
                                        (6, 5.0)])
def test_paged_attention_int8_matches_reference(tp, dtype, window, cap):
    q, kq, vq, ks, vs, table, pos = _int8_case(dtype)
    jin = [jnp.asarray(a) for a in (q, kq, vq, ks, vs, table, pos)]
    ref_kernel = paged_attention_pallas(*jin, window=window, cap=cap)
    ref_dense = JPC.paged_gather_attention(
        jin[0], JPC.PagedKV(*jin[1:5]), jin[5], jin[6][:, None],
        window=window, cap=cap)
    tin = [to_torch(a) for a in (q, kq, vq, ks, vs, table, pos)]
    out = tp.paged_attention.paged_attention_int8(*tin, window=window,
                                                  cap=cap)
    assert out.dtype == tin[0].dtype and out.shape == tin[0].shape
    np.testing.assert_allclose(f32(out), f32(ref_kernel), **TOL[dtype])
    np.testing.assert_allclose(f32(out), f32(ref_dense), **TOL[dtype])
    # the port's dense path over int8 pools, same rounding points as the
    # reference's
    pages = tp.paged_cache.PagedKV(*tin[1:5])
    dense = tp.paged_cache.paged_gather_attention(
        tin[0], pages, tin[5], tin[6][:, None], window=window, cap=cap)
    np.testing.assert_allclose(f32(dense), f32(ref_dense), **TOL[dtype])
    # and the serving entry point picks the int8 kernel for int8 pools
    via_pool = tp.paged_cache.paged_attention(tin[0], pages, tin[5], tin[6],
                                              window=window, cap=cap)
    assert tp.torch.equal(via_pool, out)
    assert np.isfinite(f32(out)).all()


# The split walk (the card kernel's design) in plain PyTorch.  Requests:
# far into the table (a window of 30 starts mid-split at every split size
# here, one of 100 masks whole splits), position 0, a dead slot (table all
# trash), the last position of page 5 and the first of page 6 (split
# boundaries for splits of 1, 2 and 3 pages of 8).
SPLIT_PPS = 16
SPLIT_POS = np.array([120, 0, 0, 47, 48], np.int32)
_SPLIT_REF: dict = {}


def _split_case(kind, seed=5):
    rng = np.random.default_rng(seed)
    n_pages = 1 + 5 * SPLIT_PPS
    table = (1 + rng.permutation(n_pages - 1)[:5 * SPLIT_PPS]).reshape(
        5, SPLIT_PPS).astype(np.int32)
    table[2] = 0
    k = rng.normal(size=(n_pages, PS, HKV, DH)).astype(np.float32)
    v = rng.normal(size=(n_pages, PS, HKV, DH)).astype(np.float32)
    g = 5 if kind == "int8" else G
    q = as_dtype(rng.normal(size=(5, 1, HKV * g, DH)),
                 "float32" if kind == "float32" else "bfloat16")
    if kind == "int8":
        kq, ks = (np.asarray(a) for a in JKQ.quantize(jnp.asarray(k)))
        vq, vs = (np.asarray(a) for a in JKQ.quantize(jnp.asarray(v)))
        return [q, kq, vq, ks, vs, table, SPLIT_POS]
    k, v = as_dtype(k, kind), as_dtype(v, kind)
    return [q, k, v, None, None, table, SPLIT_POS]


def _split_reference(kind, window, cap):
    key = (kind, window, cap)
    if key not in _SPLIT_REF:
        ins = _split_case(kind)
        _SPLIT_REF[key] = f32(paged_attention_pallas(
            *(None if a is None else jnp.asarray(a) for a in ins),
            window=window, cap=cap))
    return _SPLIT_REF[key]


@pytest.mark.parametrize("pages", [1, 2, 3])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (30, 0.0), (100, 5.0),
                                        (0, 5.0)])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_split_walk_matches_reference(tp, kind, window, cap, pages):
    """``paged_attention[_int8]_split_plain`` (per-split (m, l, acc),
    merged in order) against the reference's Pallas kernel (interpret
    mode) at splits of 1, 2 and 3 pages, with wholly masked splits
    (positions past the request's, before its window, a dead slot) and
    windows that start mid-split.  Tolerances as above (an int8 pool with
    a bfloat16 query as a bfloat16 query)."""
    A = tp.paged_attention
    ins = _split_case(kind)
    want = _split_reference(kind, window, cap)
    tin = [to_torch(a) for a in ins if a is not None]
    fn = (A.paged_attention_int8_split_plain if kind == "int8"
          else A.paged_attention_split_plain)
    got = fn(*tin, pages_per_split=pages, window=window, cap=cap)
    assert got.dtype == tin[0].dtype and got.shape == tin[0].shape
    tol = TOL["float32" if kind == "float32" else "bfloat16"]
    np.testing.assert_allclose(f32(got), want, **tol)
    assert np.isfinite(f32(got)).all()


def test_split_pages_covers_the_card(tp):
    """The split rule: about 8 blocks per SM over the whole table (at the
    serving smoke's 4 requests x 8 kv heads x 64 pages on 132 SMs, 2 pages
    a split), never fewer than one page and never more than 32 (a long
    table gets more splits)."""
    sp = tp.paged_attention.split_pages
    assert sp(4, 8, 64, 132) == 2
    assert sp(1, 1, 4, 132) == 1
    assert sp(64, 8, 64, 132) == 32
    assert sp(4, 8, 2048, 132) == 32
    assert sp(64, 8, 4096, 132) == 32
