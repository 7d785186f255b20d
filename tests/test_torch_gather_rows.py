"""Port parity: the row gather with zero rows (the ``ep_a2a`` send-buffer
builder) and its gradient.

The reference's Pallas ``gather_rows_pallas`` does not trace on the
installed JAX (it calls ``pl.load``), so the oracle is the reference's own
jnp path with the same semantics: the masked take of
``repro/models/moe_block.py:_a2a_gather_x`` for the forward and
``repro/kernels/ops.py:_gather_rows_bwd`` for the gradient.

Tolerances: the forward is a copy, so the plain version, the wrapper (its
CPU path) and the autograd Function must equal the reference bit for bit.
The gradient scatter-adds each source row's cotangents in ``src.dtype``,
rounding after each addition, in an order neither side fixes.  A row
gathered once or twice is exact (a sum of two numbers commutes); for a row
gathered n times the two sums may differ by twice the bound of recursive
summation, 2 (n - 1) u sum(|cotangents|), with u the unit roundoff of the
dtype (2^-24 for float32, 2^-8 for bfloat16).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.ops import _gather_rows_bwd
from torch_parity import as_dtype, f32, to_torch
from torch_parity import tp  # noqa: F401

UNIT_ROUNDOFF = {"float32": 2.0 ** -24, "bfloat16": 2.0 ** -8}

# (L, d, row ids): pads and duplicates, every row twice, a row many
# times, N = 0, widths that are not a multiple of 8
CASES = {
    "pads": (37, 64, [3, -1, 0, 36, -1, 5, 5, 12, -1, 0]),
    "twice": (16, 32, list(range(16)) * 2),
    "many": (6, 24, [2] * 9 + [-1, 4, 2]),
    "empty": (5, 16, []),
    "odd_width": (20, 100, [19, -1, 7, 7, 0, -1, 3]),
    "width_5": (9, 5, [8, -1, 1, 1, 4]),
}


def _ref_forward(src, ids):
    """``_a2a_gather_x``'s masked take (``moe_block.py:313-315``)."""
    ok = ids >= 0
    return jnp.where(ok[:, None], jnp.take(src, jnp.maximum(ids, 0), axis=0),
                     jnp.zeros((), src.dtype))


def _inputs(case, dtype):
    L, d, ids = CASES[case]
    rng = np.random.default_rng(L * d)
    src = as_dtype(rng.normal(size=(L, d)), dtype)
    dout = as_dtype(rng.normal(size=(len(ids), d)), dtype)
    return src, np.asarray(ids, np.int32).reshape(-1), dout


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_gather_rows_matches_reference(tp, case, dtype):
    src, ids, dout = _inputs(case, dtype)
    want = np.asarray(_ref_forward(jnp.asarray(src), jnp.asarray(ids)))
    want_f = want.astype(np.float32)
    s, i = to_torch(src), to_torch(ids)
    for name, got in (
            ("plain", tp.gather_rows.gather_rows_plain(s, i)),
            ("wrapper", tp.gather_rows.gather_rows(s, i)),
            ("Function", tp.ops.gather_rows(s, i))):
        assert got.dtype == s.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(f32(got), want_f, err_msg=name)
    assert np.all(f32(tp.ops.gather_rows(s, i))[ids < 0] == 0.0)

    dsrc_ref, _ = _gather_rows_bwd((jnp.asarray(src), jnp.asarray(ids)),
                                   jnp.asarray(dout))
    s_req = s.clone().requires_grad_(True)
    y = tp.ops.gather_rows(s_req, i)
    (dsrc,) = tp.torch.autograd.grad(y, s_req, to_torch(dout),
                                     allow_unused=True)
    assert dsrc.dtype == s.dtype
    ok = ids >= 0
    n = np.bincount(ids[ok], minlength=src.shape[0])
    abs_sum = np.zeros(src.shape, np.float32)
    np.add.at(abs_sum, ids[ok], np.abs(dout[ok].astype(np.float32)))
    bound = 2 * np.maximum(n - 1, 0)[:, None] * UNIT_ROUNDOFF[dtype] * abs_sum
    err = np.abs(f32(dsrc) - np.asarray(dsrc_ref, np.float32))
    assert np.all(err <= bound), float((err - bound).max())


def test_gather_rows_duplicate_gradient_doubles(tp):
    """A row gathered twice gets twice its cotangent; a row that is never
    gathered, or only by pad ids, gets zero."""
    torch = tp.torch
    src = torch.randn(4, 8, requires_grad=True)
    ids = torch.tensor([2, 2, -1], dtype=torch.int32)
    dout = torch.randn(3, 8)
    (dsrc,) = torch.autograd.grad(tp.ops.gather_rows(src, ids), src, dout)
    assert torch.equal(dsrc[2], dout[0] + dout[1])
    assert torch.equal(dsrc[[0, 1, 3]], torch.zeros(3, 8))
