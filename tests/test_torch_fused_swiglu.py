"""Port parity: the fused dense SwiGLU kernels and their autograd Function.

The port's plain versions (what its wrappers run on CPU tensors, and what
the card's kernels are held to) against the reference's Pallas kernels in
interpret mode, at the reference tests' small shapes, in float32 and
bfloat16; and ``ops.swiglu``'s gradients against ``jax.vjp`` of the
reference's ``swiglu`` custom VJP.  Both follow the Pallas kernels'
rounding points: y, a, b rounded once; da, db rounded to the working
dtype before the products; bwd_x's two products summed in one float32
accumulator (``repro/kernels/ref.py`` rounds each to bf16 first).

Tolerances: float32 1e-5 of each output's scale (the same float32 sums in
another order); bfloat16 one bf16 step (2^-7) of each output's scale (one
rounding of a float32 value that the two sides may round to neighbouring
bf16 numbers, and da, db that may round apart before a product).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ops as jops
from repro.kernels.fused_swiglu import (fused_swiglu_bwd_w, fused_swiglu_bwd_x,
                                        fused_swiglu_fwd)
from torch_parity import as_dtype, f32, to_torch, tp  # noqa: F401

SCALE_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
SHAPES = [(128, 256, 512), (64, 128, 256)]


def _inputs(L, d, h, dtype, seed=0):
    rng = np.random.default_rng(seed + L + d + h)
    x = as_dtype(rng.normal(size=(L, d)), dtype)
    w1 = as_dtype(rng.normal(size=(d, h)) * d ** -0.5, dtype)
    w2 = as_dtype(rng.normal(size=(d, h)) * d ** -0.5, dtype)
    dy = as_dtype(rng.normal(size=(L, h)), dtype)
    return x, w1, w2, dy


def _close(got, want, dtype, name):
    want = f32(want)
    tol = SCALE_TOL[dtype] * float(np.abs(want).max())
    np.testing.assert_allclose(f32(got), want, rtol=0.0, atol=tol,
                               err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,d,h", SHAPES)
def test_plain_versions_match_reference_kernels(tp, dtype, L, d, h):
    from repro_torch.kernels import fused_swiglu as FS
    x, w1, w2, dy = _inputs(L, d, h, dtype)
    jx, jw1, jw2, jdy = (jnp.asarray(a) for a in (x, w1, w2, dy))
    jy, ja, jb = fused_swiglu_fwd(jx, jw1, jw2)
    jdx = fused_swiglu_bwd_x(jdy, ja, jb, jw1, jw2)
    jdw1, jdw2 = fused_swiglu_bwd_w(jx, jdy, ja, jb)

    tx, tw1, tw2, tdy = (to_torch(a) for a in (x, w1, w2, dy))
    y, a, b = FS.fused_swiglu_fwd(tx, tw1, tw2)
    for name, got, want in (("y", y, jy), ("a", a, ja), ("b", b, jb)):
        assert got.dtype == tx.dtype and got.shape == (L, h)
        _close(got, want, dtype, name)
    # the backward from the reference's own a and b, so that each kernel
    # is compared on the same inputs
    ta, tb = to_torch(np.asarray(ja)), to_torch(np.asarray(jb))
    dx = FS.fused_swiglu_bwd_x(tdy, ta, tb, tw1, tw2)
    dw1, dw2 = FS.fused_swiglu_bwd_w(tx, tdy, ta, tb)
    assert dx.dtype == tx.dtype and dx.shape == (L, d)
    assert dw1.dtype == tx.dtype and dw1.shape == (d, h)
    _close(dx, jdx, dtype, "dx")
    _close(dw1, jdw1, dtype, "dw1")
    _close(dw2, jdw2, dtype, "dw2")


def test_rounding_points(tp):
    """bwd_x sums da w1ᵀ and db w2ᵀ in float32 and rounds once (the Pallas
    kernel), not each product to bf16 first (``ref.py``); the dsilu term
    is s (1 + a (1 - s))."""
    torch = tp.torch
    from repro_torch.kernels import fused_swiglu as FS
    x, w1, w2, dy = _inputs(64, 128, 256, "bfloat16", seed=5)
    tx, tw1, tw2, tdy = (to_torch(a) for a in (x, w1, w2, dy))
    _, a, b = FS.fused_swiglu_fwd(tx, tw1, tw2)
    da, db = FS.swiglu_grads(tdy, a, b, torch.bfloat16)
    af, s = a.float(), torch.sigmoid(a.float())
    want_da = tdy.float() * b.float() * (s * (1 + af * (1 - s)))
    assert torch.equal(da, want_da.to(torch.bfloat16))
    dx = FS.fused_swiglu_bwd_x(tdy, a, b, tw1, tw2)
    one_acc = (da.float() @ tw1.float().T + db.float() @ tw2.float().T)
    assert torch.equal(dx, one_acc.to(torch.bfloat16))
    two_roundings = ((da.float() @ tw1.float().T).to(torch.bfloat16).float()
                     + (db.float() @ tw2.float().T).to(torch.bfloat16)
                     .float()).to(torch.bfloat16)
    assert not torch.equal(dx, two_roundings)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_function_grads_match_reference_vjp(tp, dtype):
    """``ops.swiglu`` (forward kernel, saving x, w1, w2, a, b; backward
    kernels) against ``jax.vjp`` of the reference's custom VJP; dw1 and
    dw2 come back in x's dtype."""
    L, d, h = 128, 256, 512
    x, w1, w2, dy = _inputs(L, d, h, dtype, seed=7)
    y_ref, vjp = jax.vjp(jops.swiglu, jnp.asarray(x), jnp.asarray(w1),
                         jnp.asarray(w2))
    grads_ref = vjp(jnp.asarray(dy))
    tx, tw1, tw2 = (to_torch(a).requires_grad_() for a in (x, w1, w2))
    y = tp.ops.swiglu(tx, tw1, tw2)
    y.backward(to_torch(dy))
    _close(y, y_ref, dtype, "y")
    for name, t, r in zip(("dx", "dw1", "dw2"), (tx, tw1, tw2), grads_ref):
        assert t.grad.dtype == tx.dtype
        _close(t.grad, r, dtype, name)


def test_swiglu_function_saves_a_and_b_not_y(tp):
    torch = tp.torch
    x, w1, w2, _ = _inputs(64, 128, 256, "float32")
    tx, tw1, tw2 = (to_torch(a).requires_grad_() for a in (x, w1, w2))
    shapes = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: shapes.append(tuple(t.shape)) or t, lambda t: t):
        tp.ops.swiglu(tx, tw1, tw2)
    assert sorted(shapes) == sorted([(64, 128), (128, 256), (128, 256),
                                     (64, 256), (64, 256)])


@pytest.mark.parametrize("L,d,h,grid,tail", [
    (1, 5120, 17408, 132, 32),    # Qwen3-14B decode: 136 tiles, 132 SMs
    (4, 5120, 17408, 132, 32),    # 4 tiles past the wave, 8 pieces each
    (16, 5120, 17408, 132, 32),
    (17, 5120, 17408, 132, 0),    # past decode: no split
    (4, 5120, 4096, 132, 132),    # 32 tiles: all split, 4 pieces or so
    (4, 512, 1000, 64, 64),       # 8 tiles of 8 k-steps: 8 pieces each
    (4, 64, 17408, 132, 0),       # one k-step: nothing to split
    (64, 5120, 17408, 132, 0),
    (128, 5120, 16896, 132, 0),   # exactly one wave of 132 tiles
    (2048, 5120, 17408, 132, 0),  # prefill
    (4096, 5120, 17408, 132, 0),  # training
    (4, 0, 17408, 0, 0)])         # no contraction: nothing to launch
def test_fwd_plan_splits_only_a_partial_wave_at_decode(tp, L, d, h, grid,
                                                      tail):
    """The bf16 forward runs one persistent block per SM (fewer when
    there is less work); at decode (L <= 16) the tiles of a partial last
    wave are shared by ``tail`` blocks, each tile in at most
    ``FWD_SPLIT_MAX`` pieces."""
    from repro_torch.kernels import fused_swiglu as FS
    assert FS.fwd_plan(L, d, h, 132) == (grid, tail)
