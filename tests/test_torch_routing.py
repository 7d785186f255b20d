"""Port parity: top-k gating and the dispatch build.

The dispatch integers must be bit-identical to the reference's sort-free
build and to its Pallas kernel (interpret mode).  Gating is compared at
float32 rounding; the chosen experts must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import routing as R
from repro.kernels.dispatch import build_dispatch_pallas
from torch_parity import to_torch, tp  # noqa: F401


def _topk(L, E, k, seed, experts=None):
    """(L, k) distinct expert ids per row, drawn from ``experts`` (all by
    default; a subset leaves the others empty)."""
    rng = np.random.default_rng(seed)
    pool = np.arange(E) if experts is None else np.asarray(experts)
    return np.stack([rng.choice(pool, size=k, replace=False)
                     for _ in range(L)]).astype(np.int32)


def test_gating_matches_reference(tp):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 32)).astype(np.float32)
    w = rng.normal(size=(32, 8)).astype(np.float32)
    ref = R.top_k_gating(jnp.asarray(x), jnp.asarray(w), 2)
    out = tp.routing.top_k_gating(to_torch(x), to_torch(w), 2)
    np.testing.assert_array_equal(out.topk_experts.numpy(),
                                  np.asarray(ref.topk_experts))
    # float32 dots of 32 terms summed in another order: |err| <~ 32 * eps *
    # |terms| ~ 4e-6 on logits of size ~10.
    for name in ("topk_weights", "router_probs", "logits"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-5, err_msg=name)


CASES = [
    (1, 4, 1, None),            # one token
    (37, 4, 2, None),           # ragged against every tile size
    (100, 8, 2, None),
    (64, 16, 4, None),
    (300, 8, 2, [1, 5]),        # six empty experts, > one 256-slot chunk
    (129, 8, 2, [0, 3]),        # empty experts at both ends
    (50, 8, 1, [7]),            # every slot on one expert
]


@pytest.mark.parametrize("L,E,k,experts", CASES)
def test_dispatch_bit_identical(tp, L, E, k, experts):
    topk = _topk(L, E, k, seed=L * E + k, experts=experts)
    ref = R.build_dispatch(jnp.asarray(topk), E)
    pallas = build_dispatch_pallas(jnp.asarray(topk), E)
    plain = tp.routing.build_dispatch(to_torch(topk), E)
    wrapped = tp.dispatch.build_dispatch(to_torch(topk), E)  # CPU: plain
    for name in R.Dispatch._fields:
        want = np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(np.asarray(getattr(pallas, name)),
                                      want, err_msg=f"pallas {name}")
        for got in (plain, wrapped):
            t = getattr(got, name)
            assert t.dtype == tp.torch.int32, name
            np.testing.assert_array_equal(t.numpy(), want, err_msg=name)
