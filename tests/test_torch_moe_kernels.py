"""Port parity: gather-GMM, combine and the kernel-composed expert layer.

The plain versions run here against the reference's Pallas kernels in
interpret mode and its segment-backend expert layer.  Where the installed
JAX can no longer trace the reference's gather-GMM and combine kernels
(``pallas.load`` was removed from the API), those comparisons go through
the kernels' own plain oracles in ``repro/kernels/ref.py``.

Tolerances: float32 1e-5 (the same products summed in another order);
bfloat16 one bf16 step (2^-7 relative) plus a small absolute floor, since
both sides round a float32 result to bf16 once and a sum that lands next to
a rounding boundary may round either way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from repro.core import routing as R
from repro.core.moe_layer import moe_ffn_blaze
from repro.kernels import ref as JREF
from repro.kernels.combine import combine as pallas_combine
from repro.kernels.gather_gmm import gather_gmm as pallas_gather_gmm
from torch_parity import as_dtype, f32, to_torch, tp  # noqa: F401

L, D, H, E, K = 48, 32, 64, 4, 2
# The reference's gather-GMM and combine kernels load rows with
# ``pallas.load``; without it they cannot trace and the ref.py oracles stand
# in for them.
PALLAS_ROW_LOADS = hasattr(pl, "load")


def jax_gather_gmm(x, idx, off, w1, w2=None, *, epilogue=True):
    if PALLAS_ROW_LOADS:
        return pallas_gather_gmm(x, idx, off, w1, w2, epilogue=epilogue)
    out = JREF.gather_gmm_ref(x, idx, off, w1, w2, epilogue=epilogue)
    return out[0] if w2 is not None else out


def jax_combine(p, tim, g):
    if PALLAS_ROW_LOADS:
        return pallas_combine(p, tim, g)
    return JREF.combine_ref(p, tim, g)


def jax_moe_blaze_pallas(x, gates, disp, w1, w3, w2):
    """Forward of ``ops.moe_ffn_blaze_pallas`` (``_moe_pallas_fwd``)."""
    S = disp.expert_token_indices.shape[0]
    y_swi = jax_gather_gmm(x, disp.expert_token_indices,
                           disp.expert_token_offsets, w1, w2)
    p_out = jax_gather_gmm(y_swi, jnp.arange(S, dtype=jnp.int32),
                           disp.expert_token_offsets, w3, epilogue=False)
    return jax_combine(p_out, disp.token_index_map, gates.astype(x.dtype))


TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=1e-2)}


def _inputs(dtype, seed=0, lengths=(30, 0, 41, 25)):
    """x, row ids, offsets (whose total may stop short of S) and weights.
    ``lengths`` has an empty expert; its sum 96 equals S = L*K."""
    rng = np.random.default_rng(seed)
    S = L * K
    x = as_dtype(rng.normal(size=(L, D)), dtype)
    idx = rng.integers(0, L, size=S).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    w1 = as_dtype(rng.normal(size=(E, D, H)) * 0.2, dtype)
    w2 = as_dtype(rng.normal(size=(E, D, H)) * 0.2, dtype)
    return x, idx, offsets, w1, w2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths", [(30, 0, 41, 25), (10, 0, 20, 5)],
                         ids=["full", "rows_past_total"])
def test_gather_gmm_dual_epilogue(tp, dtype, lengths):
    x, idx, off, w1, w2 = _inputs(dtype, lengths=lengths)
    ref = jax_gather_gmm(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(off),
                         jnp.asarray(w1), jnp.asarray(w2))
    out = tp.gather_gmm.gather_gmm(to_torch(x), to_torch(idx), to_torch(off),
                                   to_torch(w1), to_torch(w2))
    assert out.dtype == tp.dtype[dtype] and out.shape == (L * K, H)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL[dtype])
    total = int(off[-1])
    assert not out[total:].any(), "rows past offsets[E] must be exactly 0"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_gmm_single_identity_rows(tp, dtype):
    """The second GEMM: one weight, rows already in expert order."""
    rng = np.random.default_rng(1)
    _, _, off, _, _ = _inputs(dtype)
    S = L * K
    y = as_dtype(rng.normal(size=(S, H)), dtype)
    w3 = as_dtype(rng.normal(size=(E, H, D)) * 0.2, dtype)
    ref = jax_gather_gmm(jnp.asarray(y), jnp.arange(S, dtype=jnp.int32),
                         jnp.asarray(off), jnp.asarray(w3), epilogue=False)
    out = tp.gather_gmm.gather_gmm(to_torch(y), None, to_torch(off),
                                   to_torch(w3), epilogue=False)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL[dtype])


@pytest.mark.parametrize("call", ["dual_save_ab", "w3_forward", "w3_t"])
@pytest.mark.parametrize("lengths,past", [
    ((1, 30, 0, 49), 16),                 # an expert of one row
    ((0, 0, 96, 0), 0),                   # every slot on one expert
    ((0, 40, 0, 17), 39)],                # empty experts, rows past total
    ids=["one_row_expert", "one_expert", "empty_experts_rows_past"])
def test_gather_gmm_edges_match_reference(tp, call, lengths, past):
    """The tile edges the card kernels are held at, in bf16: the dual
    branch with ``save_ab`` (y, a, b), the w3 forward over identity rows
    and the transposed w3 (the reference multiplies by the transposed
    weight itself), against the reference; rows past offsets[E] exactly
    0 and a repeated call equal."""
    rng = np.random.default_rng(sum(lengths) + past)
    S = sum(lengths) + past
    off = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    x = as_dtype(rng.normal(size=(L, D)), "bfloat16")
    idx = rng.integers(0, L, size=S).astype(np.int32)
    w1, w2 = (as_dtype(rng.normal(size=(E, D, H)) * 0.2, "bfloat16")
              for _ in range(2))
    w3 = as_dtype(rng.normal(size=(E, H, D)) * 0.2, "bfloat16")
    rows_h = as_dtype(rng.normal(size=(S, H)), "bfloat16")
    rows_d = as_dtype(rng.normal(size=(S, D)), "bfloat16")
    ident = np.arange(S, dtype=np.int32)
    G = tp.gather_gmm
    if call == "dual_save_ab":
        ref = JREF.gather_gmm_ref(*map(jnp.asarray, (x, idx, off, w1, w2)))
        outs = [G.gather_gmm(*map(to_torch, (x, idx, off, w1, w2)),
                             save_ab=True) for _ in range(2)]
    elif call == "w3_forward":
        ref = (JREF.gather_gmm_ref(*map(jnp.asarray, (rows_h, ident, off,
                                                      w3))),)
        outs = [(G.gather_gmm(to_torch(rows_h), None, to_torch(off),
                              to_torch(w3), epilogue=False),)
                for _ in range(2)]
    else:
        ref = (JREF.gather_gmm_ref(jnp.asarray(rows_d), jnp.asarray(ident),
                                   jnp.asarray(off),
                                   jnp.swapaxes(jnp.asarray(w3), 1, 2)),)
        outs = [(G.gather_gmm(to_torch(rows_d), None, to_torch(off),
                              to_torch(w3), epilogue=False, trans_w=True),)
                for _ in range(2)]
    total = int(off[-1])
    for got, again, want in zip(*outs, ref):
        np.testing.assert_allclose(f32(got), f32(want), **TOL["bfloat16"])
        assert not got[total:].any(), "rows past offsets[E] must be 0"
        assert bool((got == again).all()), "a repeated call differs"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine(tp, dtype):
    rng = np.random.default_rng(2)
    topk = np.stack([rng.choice(E, size=K, replace=False)
                     for _ in range(L)]).astype(np.int32)
    disp = R.build_dispatch(jnp.asarray(topk), E)
    p = as_dtype(rng.normal(size=(L * K, D)), dtype)
    g = as_dtype(rng.uniform(size=(L, K)), dtype)
    tim = np.asarray(disp.token_index_map)
    ref = jax_combine(jnp.asarray(p), jnp.asarray(tim), jnp.asarray(g))
    out = tp.combine.combine(to_torch(p), to_torch(tim), to_torch(g))
    np.testing.assert_allclose(f32(out), f32(ref), **TOL[dtype])


def _layer_inputs(dtype, seed=3):
    rng = np.random.default_rng(seed)
    x = as_dtype(rng.normal(size=(L, D)), dtype)
    w1, w2 = (as_dtype(rng.normal(size=(E, D, H)) * 0.2, dtype)
              for _ in range(2))
    w3 = as_dtype(rng.normal(size=(E, H, D)) * 0.2, dtype)
    scores = rng.normal(size=(L, E)).astype(np.float32)
    topk = np.argsort(-scores, axis=1)[:, :K].astype(np.int32)
    gates = np.take_along_axis(scores, topk, 1)
    gates = np.exp(gates) / np.exp(gates).sum(1, keepdims=True)
    return x, w1, w2, w3, topk, as_dtype(gates, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_matches_reference(tp, dtype):
    x, w1, w2, w3, topk, gates = _layer_inputs(dtype)
    jd = R.build_dispatch(jnp.asarray(topk), E)
    jargs = [jnp.asarray(a) for a in (x, gates)]
    ref_pallas = jax_moe_blaze_pallas(jargs[0], jargs[1], jd,
                                      jnp.asarray(w1), jnp.asarray(w3),
                                      jnp.asarray(w2))
    ref_seg = moe_ffn_blaze(jargs[0], jargs[1], jd, jnp.asarray(w1),
                            jnp.asarray(w3), jnp.asarray(w2),
                            backend="segment")
    td = tp.routing.build_dispatch(to_torch(topk), E)
    out = tp.ops.moe_ffn_blaze_pallas(to_torch(x), to_torch(gates), td,
                                      to_torch(w1), to_torch(w3),
                                      to_torch(w2))
    # Same rounding points as the kernel composition (y_swi, partials,
    # output), so the bf16 bound is the one-step TOL.  The segment layer
    # also rounds a and b to bf16 before the epilogue: two bf16 steps of
    # the output's scale there.
    np.testing.assert_allclose(f32(out), f32(ref_pallas), **TOL[dtype])
    seg_tol = TOL[dtype] if dtype == "float32" else dict(
        rtol=2 ** -6, atol=2 ** -6 * float(np.abs(f32(ref_seg)).max()))
    np.testing.assert_allclose(f32(out), f32(ref_seg), **seg_tol)


def test_moe_forward_refuses_grad(tp):
    """An input that requires grad is taken, not refused: the layer records
    its autograd Function and gives the same output as without grad."""
    x, w1, w2, w3, topk, gates = _layer_inputs("float32")
    td = tp.routing.build_dispatch(to_torch(topk), E)
    args = [to_torch(a) for a in (x, gates, w1, w3, w2)]
    y0 = tp.ops.moe_ffn_blaze_pallas(args[0], args[1], td, *args[2:])
    y1 = tp.ops.moe_ffn_blaze_pallas(args[0].clone().requires_grad_(),
                                     args[1], td, *args[2:])
    assert type(y1.grad_fn).__name__ == "MoEBlazePallasBackward"
    assert tp.torch.equal(y0, y1.detach())
