"""Port parity: paged decode attention.

The plain version runs here against the reference's Pallas kernel
(interpret mode) and its dense gather path, for {float32, bfloat16} x
{sliding window, softcap}, including a request at position 0 and a dead
slot (table all trash).  Tolerances: float32 1e-5; bfloat16 2e-2 (the dense
reference rounds the scaled query and the probabilities to bf16, the kernel
keeps float32, and the output rounds to bf16 once).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.paged_attention import paged_attention_pallas
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
