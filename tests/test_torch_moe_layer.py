"""Port parity: the reference's default expert layer, ``moe_ffn_blaze``.

The port's ``core/moe_layer.moe_ffn_blaze`` (output, and the gradients of
x, the gates and the expert weights) against ``jax.vjp`` of the
reference's on the same inputs: SwiGLU over every ported backend, residual
mode and dtype, and the plain-MLP activations in float32.  The reference
runs its ``segment`` backend (its ``pallas`` one does not trace on the
installed JAX).  Then the MoE sublayer with ``moe_impl="blaze"`` from
weights converted by ``interop.params_from_jax``, against the reference's.

Tolerances are the reference's own for this comparison
(``tests/test_fused_path.py``): 5e-4 in float32, 5e-2 in bfloat16, both
relative and absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.core import routing as R
from repro.core.moe_layer import moe_ffn_blaze as j_moe_ffn_blaze
from repro.models import moe_block as JMB
from repro.models import transformer as JT
from torch_parity import as_dtype, f32, np_params, to_torch, torch_config
from torch_parity import tp  # noqa: F401

L, D, H, E, K = 64, 64, 128, 8, 2


def _tol(dtype):
    return (dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16"
            else dict(rtol=5e-4, atol=5e-4))


def _inputs(dtype, swiglu=True, seed=0):
    rng = np.random.default_rng(seed)
    x = as_dtype(rng.normal(size=(L, D)), dtype)
    w1 = as_dtype(rng.normal(size=(E, D, H)) * 0.1, dtype)
    w2 = as_dtype(rng.normal(size=(E, D, H)) * 0.1, dtype) if swiglu else None
    w3 = as_dtype(rng.normal(size=(E, H, D)) * 0.1, dtype)
    scores = rng.normal(size=(L, E)).astype(np.float32)
    scores[:, 6] -= 100.0                       # expert 6 stays empty
    topk = np.argsort(-scores, axis=1)[:, :K].astype(np.int32)
    g = np.exp(np.take_along_axis(scores, topk, 1))
    gates = as_dtype(g / g.sum(1, keepdims=True), dtype)
    dy = as_dtype(rng.normal(size=(L, D)), dtype)
    return x, gates, w1, w2, w3, topk, dy


def _check(tp, dtype, activation, residuals, backend, seed):
    from repro_torch.core.moe_layer import moe_ffn_blaze
    swiglu = activation == "swiglu"
    x, gates, w1, w2, w3, topk, dy = _inputs(dtype, swiglu, seed)
    ins = [x, gates, w1, w3] + ([w2] if swiglu else [])
    jd = R.build_dispatch(jnp.asarray(topk), E)

    def ref(x_, g_, w1_, w3_, *w2_):
        return j_moe_ffn_blaze(x_, g_, jd, w1_, w3_, *w2_,
                               activation=activation, residuals=residuals,
                               backend="segment")

    y_ref, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in ins))
    grads_ref = vjp(jnp.asarray(dy))
    td = tp.routing.build_dispatch(to_torch(topk), E)
    ts = [to_torch(a).requires_grad_() for a in ins]
    y = moe_ffn_blaze(ts[0], ts[1], td, ts[2], ts[3], *ts[4:],
                      activation=activation, residuals=residuals,
                      backend=backend)
    assert y.dtype == ts[0].dtype
    y.backward(to_torch(dy))
    np.testing.assert_allclose(f32(y), f32(y_ref), **_tol(dtype))
    for name, t, r in zip(("x", "gates", "w1", "w3", "w2"), ts, grads_ref):
        assert t.grad.dtype == t.dtype, name
        np.testing.assert_allclose(f32(t.grad), f32(r), **_tol(dtype),
                                   err_msg=f"d{name}")
    assert not ts[2].grad[6].any(), "the empty expert's dw1 must be zero"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residuals", ["ab_yswi", "ab", "x"])
@pytest.mark.parametrize("backend", ["segment", "pallas", "pallas_fused"])
def test_swiglu_layer_matches_reference(tp, backend, residuals, dtype):
    _check(tp, dtype, "swiglu", residuals, backend, seed=1)


@pytest.mark.parametrize("backend", ["segment", "pallas"])
@pytest.mark.parametrize("activation", ["silu", "relu", "gelu"])
def test_mlp_layer_matches_reference(tp, activation, backend):
    _check(tp, "float32", activation, "ab", backend, seed=2)


def test_layer_refuses_bad_arguments(tp):
    from repro_torch.core.moe_layer import moe_ffn_blaze
    x, gates, w1, w2, w3, topk, _ = (to_torch(a) if a is not None else None
                                     for a in _inputs("float32"))
    d = tp.routing.build_dispatch(topk, E)
    with pytest.raises(ValueError, match="residual mode"):
        moe_ffn_blaze(x, gates, d, w1, w3, w2, residuals="nope")
    with pytest.raises(ValueError, match="w2"):
        moe_ffn_blaze(x, gates, d, w1, w3)
    with pytest.raises(ValueError, match="activation"):
        moe_ffn_blaze(x, gates, d, w1, w3, activation="tanh")


@pytest.mark.parametrize("backend", ["segment", "pallas_fused"])
def test_blaze_sublayer_from_converted_weights(tp, backend):
    """The MoE sublayer of the reduced Mixtral (``moe_impl="blaze"``), with
    weights from the reference's init converted by ``params_from_jax``:
    output and auxiliary loss against the reference's ``_moe_local``."""
    from repro_torch.models.moe_block import moe_local
    jcfg = get_config("mixtral_8x7b").reduced().replace(gmm_backend=backend)
    tcfg = torch_config(jcfg)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jmoe = jax.tree.map(lambda a: a[0], jp["layers"][0]["moe"])
    xf = np.random.default_rng(3).normal(
        size=(48, jcfg.d_model)).astype(np.float32)
    y_ref, aux_ref = JMB._moe_local(jnp.asarray(xf), jmoe, jcfg)
    tparams = tp.interop.params_from_jax(np_params(jp), tcfg, device="cpu",
                                         dtype=tp.torch.float32)
    y, aux = moe_local(to_torch(xf), tparams["layers"][0]["moe"], tcfg)
    np.testing.assert_allclose(f32(y), f32(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-5)
