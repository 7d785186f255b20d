"""Port parity: top-k gating and the dispatch build.

The dispatch integers must be bit-identical to the reference's sort-free
build and to its Pallas kernel (interpret mode); the ported sort-based
build to the reference's sort-based and sort-free builds.  The kernel's
launch plan (``kernels/dispatch.py:dispatch_plan``) is held to its
contract: one launch (one cluster) up to ``N_ONE`` slots, two past it,
tiles and scratch for every slot, shared memory within the card's opt-in
limit.  Gating is compared at
float32 rounding; the chosen experts must be equal.  ``slice_dispatch``
must give the reference's integers for every expert range, and the
sliced gather-GMM and combine, summed over a partition of the experts
into ranges, must give the whole layer's output (float32: the same
products summed in another order, 1e-6 relative over a floor of 1e-6
times the output's scale).
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


@pytest.mark.parametrize("L,E,k,experts", CASES + [(300, 16, 4, None)])
def test_dispatch_sort_matches_reference(tp, L, E, k, experts):
    topk = _topk(L, E, k, seed=L * E + k, experts=experts)
    ref_sort = R.build_dispatch_sort(jnp.asarray(topk), E)
    ref = R.build_dispatch(jnp.asarray(topk), E)
    got = tp.routing.build_dispatch_sort(to_torch(topk), E)
    for name in R.Dispatch._fields:
        t = getattr(got, name)
        assert t.dtype == tp.torch.int32, name
        for want in (ref_sort, ref):
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("E", [1, 256])
@pytest.mark.parametrize("n", [0, 1, 8, "N_ONE", "N_ONE+1", 262144])
def test_dispatch_plan(tp, n, E):
    D = tp.dispatch
    n = {"N_ONE": D.N_ONE, "N_ONE+1": D.N_ONE + 1}.get(n, n)
    plan = D.dispatch_plan(n, E)
    assert D.N_ONE >= 16384
    assert plan["launches"] <= 2
    if n <= D.N_ONE:
        assert (plan["path"], plan["launches"]) == ("one", 1)
        assert plan["grid"] <= D.CLUSTER and plan["scratch"] == 0
    else:
        assert (plan["path"], plan["launches"]) == ("two", 2)
        assert plan["scratch"] == E * plan["grid"]     # counts of every tile
    # the tiles cover the slots, and none is empty past the first
    assert plan["tile"] >= 32 and plan["grid"] == max(1, -(-n // plan["tile"]))
    assert 32 <= plan["threads"] <= 1024 and plan["threads"] % 32 == 0
    # a warp's run of 32-slot pieces covers the tile
    W = plan["threads"] // 32
    assert W * 32 * -(-plan["tile"] // (32 * W)) >= plan["tile"]
    # ids, per-warp count rows, totals, bases and offsets fit the 48 KB a
    # launch gets without opting in (well within the card's 227 KB)
    assert plan["smem"] >= 4 * (plan["tile"] + W * E + 4 * E + 1)
    assert plan["smem"] <= D.SMEM_DEFAULT == 48 * 1024


SLICE_CASES = [(37, 4, 2, None), (100, 8, 2, None), (129, 8, 2, [0, 3]),
               (50, 8, 1, [7])]


@pytest.mark.parametrize("L,E,k,experts", SLICE_CASES)
def test_slice_dispatch_matches_reference(tp, L, E, k, experts):
    topk = _topk(L, E, k, seed=L + E + k, experts=experts)
    ref = R.build_dispatch(jnp.asarray(topk), E)
    disp = tp.routing.build_dispatch(to_torch(topk), E)
    for lo in range(E):
        for hi in range(lo + 1, E + 1):
            want = R.slice_dispatch(ref, lo, hi)
            for e_lo in (lo, tp.torch.tensor(lo)):
                got = tp.routing.slice_dispatch(disp, e_lo, count=hi - lo)
                for name in R.Dispatch._fields:
                    t = getattr(got, name)
                    assert t.dtype == tp.torch.int32, name
                    np.testing.assert_array_equal(
                        t.numpy(), np.asarray(getattr(want, name)),
                        err_msg=f"[{lo}, {hi}) {name}")


@pytest.mark.parametrize("n_ranges", [2, 4])
def test_sliced_layer_sums_to_whole(tp, n_ranges):
    L, E, k, d, h = 45, 8, 2, 16, 24
    rng = np.random.default_rng(7)
    topk = _topk(L, E, k, seed=11, experts=[0, 1, 2, 5, 6, 7])
    x = to_torch(rng.normal(size=(L, d)).astype(np.float32))
    w1, w2 = (to_torch(rng.normal(size=(E, d, h)).astype(np.float32))
              for _ in range(2))
    g = to_torch(rng.uniform(size=(L, k)).astype(np.float32))
    disp = tp.routing.build_dispatch(to_torch(topk), E)

    def layer(dd, w1_, w2_):
        p = tp.gather_gmm.gather_gmm(x, dd.expert_token_indices,
                                     dd.expert_token_offsets, w1_, w2_)
        return tp.combine.combine(p, dd.token_index_map, g)

    want = layer(disp, w1, w2)
    E_loc = E // n_ranges
    total = tp.torch.zeros_like(want)
    for r in range(n_ranges):
        ws = slice(r * E_loc, (r + 1) * E_loc)
        total += layer(tp.routing.slice_dispatch(disp, r * E_loc,
                                                 count=E_loc), w1[ws], w2[ws])
    scale = float(want.abs().max())
    assert tp.torch.all((total - want).abs()
                        <= 1e-6 * (want.abs() + scale))
