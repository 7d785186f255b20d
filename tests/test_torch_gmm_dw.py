"""Port parity: the grouped weight gradient.

The port's plain ``gmm_dw`` (what a CPU tensor runs) against the
reference's Pallas ``gmm_dw_pallas`` in interpret mode, on rows already in
expert order: an empty expert, all rows on one expert, row counts that are
not a multiple of the 128-row tile, and rows past ``offsets[E]`` (which
belong to no expert).

Tolerances: float32 1e-5 relative (the same products summed in another
order) over an absolute floor of 1e-5 times the output's scale; bfloat16
one bf16 step (2^-7 relative) plus the same floor, since both sides sum in
float32 and round once to bf16, and a sum next to a rounding boundary may
round either way.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.gather_gmm import gmm_dw_pallas
from torch_parity import as_dtype, f32, to_torch, tp  # noqa: F401

D, H = 32, 48
RTOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
CASES = {
    "empty_expert": (30, 0, 41, 25),
    "one_expert": (0, 0, 200, 0),
    "ragged_tiles": (130, 7, 0, 64),        # 201 rows: not a multiple of 128
    "rows_past_total": (20, 0, 33, 10),     # offsets[E] = 63 of 90 rows
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gmm_dw_matches_pallas(tp, dtype, case):
    lengths = CASES[case]
    S = sum(lengths) + (27 if case == "rows_past_total" else 0)
    rng = np.random.default_rng(len(case))
    lhs = as_dtype(rng.normal(size=(S, D)), dtype)
    dout = as_dtype(rng.normal(size=(S, H)), dtype)
    off = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    ref = gmm_dw_pallas(jnp.asarray(lhs), jnp.asarray(dout),
                        jnp.asarray(off), interpret=True)
    out = tp.gmm_dw.gmm_dw(to_torch(lhs), to_torch(dout), to_torch(off))
    assert out.dtype == tp.dtype[dtype]
    assert tuple(out.shape) == (len(lengths), D, H)
    want = f32(ref)
    np.testing.assert_allclose(f32(out), want, rtol=RTOL[dtype],
                               atol=1e-5 * float(np.abs(want).max()))
    for e, n in enumerate(lengths):
        if n == 0:
            assert not out[e].any(), f"empty expert {e} must be exact zeros"


def test_gmm_dw_pallas_traces_here():
    """The reference kernel this file compares against traces and runs in
    interpret mode on the installed JAX."""
    out = gmm_dw_pallas(jnp.ones((9, 8)), jnp.ones((9, 16)),
                        jnp.array([0, 4, 9], jnp.int32), interpret=True)
    assert out.shape == (2, 8, 16)
    np.testing.assert_array_equal(np.asarray(out[0]), 4.0)
