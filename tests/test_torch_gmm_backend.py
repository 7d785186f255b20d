"""Port parity: the grouped-GEMM backend registry.

- ``gmm`` / ``gmm_dw`` of the port's ``segment``, ``pallas`` (through its
  kernels' plain versions here) and ``ragged`` backends against the
  reference's ``segment`` backend, with an empty group and rows past the
  group total.  The reference's ``pallas`` backend does not trace on the
  installed JAX (no ``pallas.load``), so its exact oracle is used.
- The port's ``ragged`` (``torch._grouped_mm``) against the reference's
  ``ragged`` (``jax.lax.ragged_dot[_general]``): outputs with exact-zero
  trailing rows and an empty group's zero gradient, gradients through its
  autograd Functions against ``jax.vjp``, and ``moe_ffn_blaze`` on
  ``ragged`` against the reference layer on ``ragged``.
- The ``pallas`` autograd Functions (each backward built from the other
  kernel, a transposed weight read in place) against autograd through the
  ``segment`` backend.
- The resolution chain, as ``tests/test_backend_resolution.py`` holds the
  reference to it: call-site > ``use_backend`` scope > config >
  ``REPRO_GMM_BACKEND`` > auto, with the same names and the same auto
  choice.

Tolerances: float32 1e-5 relative over 1e-5 of each output's scale (the
same sums in another order); bfloat16 one bf16 step (2^-7) of the scale
(both sides round once from float32 sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import gmm_backend as JGB
from repro.core import routing as R
from repro.core.moe_layer import moe_ffn_blaze as j_moe_ffn_blaze
from torch_parity import as_dtype, f32, to_torch
from torch_parity import tp  # noqa: F401

S, D, H = 40, 24, 16
SIZES = np.array([9, 0, 14, 12], np.int32)      # 35 of 40 rows grouped


def _tol(dtype, want):
    scale = float(np.abs(want).max())
    if dtype == "bfloat16":
        return dict(rtol=0.0, atol=2 ** -7 * scale)
    return dict(rtol=1e-5, atol=1e-5 * scale)


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    lhs = as_dtype(rng.normal(size=(S, D)), dtype)
    rhs = as_dtype(rng.normal(size=(len(SIZES), D, H)) * 0.3, dtype)
    dout = as_dtype(rng.normal(size=(S, H)), dtype)
    return lhs, rhs, dout


@pytest.fixture(scope="module")
def GB(tp):
    from repro_torch.core import gmm_backend
    return gmm_backend


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["segment", "pallas", "ragged"])
def test_gmm_and_gmm_dw_match_reference_segment(GB, backend, dtype):
    lhs, rhs, dout = _inputs(dtype)
    sizes = jnp.asarray(SIZES)
    want = f32(JGB.gmm(jnp.asarray(lhs), jnp.asarray(rhs), sizes,
                       backend="segment"))
    got = GB.gmm(to_torch(lhs), to_torch(rhs), to_torch(SIZES),
                 backend=backend)
    assert got.dtype == to_torch(lhs).dtype
    np.testing.assert_allclose(f32(got), want, **_tol(dtype, want))
    assert not f32(got)[SIZES.sum():].any(), "rows past the groups are zero"
    want = f32(JGB.gmm_dw(jnp.asarray(lhs), jnp.asarray(dout), sizes,
                          backend="segment"))
    got = GB.gmm_dw(to_torch(lhs), to_torch(dout), to_torch(SIZES),
                    backend=backend)
    np.testing.assert_allclose(f32(got), want, **_tol(dtype, want))
    assert not f32(got)[1].any(), "the empty group's gradient is zero"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_matches_reference_ragged(GB, dtype):
    """``torch._grouped_mm`` against ``jax.lax.ragged_dot[_general]``: rows
    past the group total exact zeros (``_grouped_mm`` leaves them
    unwritten), the empty group's weight gradient exact zeros."""
    assert JGB.get_backend("ragged").available()
    lhs, rhs, dout = _inputs(dtype, seed=3)
    sizes = jnp.asarray(SIZES)
    want = f32(JGB.gmm(jnp.asarray(lhs), jnp.asarray(rhs), sizes,
                       backend="ragged"))
    got = GB.gmm(to_torch(lhs), to_torch(rhs), to_torch(SIZES),
                 backend="ragged")
    assert got.dtype == to_torch(lhs).dtype and got.shape == (S, H)
    np.testing.assert_allclose(f32(got), want, **_tol(dtype, want))
    assert (f32(got)[SIZES.sum():] == 0).all(), "trailing rows are zeros"
    want = f32(JGB.gmm_dw(jnp.asarray(lhs), jnp.asarray(dout), sizes,
                          backend="ragged"))
    got = GB.gmm_dw(to_torch(lhs), to_torch(dout), to_torch(SIZES),
                    backend="ragged")
    assert got.dtype == to_torch(lhs).dtype and got.shape == (4, D, H)
    np.testing.assert_allclose(f32(got), want, **_tol(dtype, want))
    assert (f32(got)[1] == 0).all(), "the empty group's gradient is zero"


def test_ragged_refusals_raise_naming_the_explicit_backends(GB, tp):
    """What ``torch._grouped_mm`` refuses raises, naming the backends that
    take every case; it never falls back to ``segment`` quietly."""
    torch = tp.torch
    sizes = to_torch(SIZES)
    for lhs, rhs in ((torch.zeros(S, 22), torch.zeros(4, 22, H)),   # 88 B
                     (torch.zeros(S, D, dtype=torch.bfloat16),
                      torch.zeros(4, D, H))):                        # mixed
        with pytest.raises(RuntimeError,
                           match="'segment', 'pallas' or 'pallas_fused'"):
            GB.gmm(lhs, rhs, sizes, backend="ragged")


def test_ragged_gradients_match_reference_vjp(GB, tp):
    """Gradients through ``ragged``'s autograd Functions (gmm with a plain
    and a transposed weight, gmm_dw) against ``jax.vjp`` of the reference
    on the same loss, in float32: its ``ragged`` gmm, and its ``segment``
    gmm_dw (JAX has no transpose rule for ``ragged_dot_general`` with
    ragged contracting rows, so the reference's ``ragged`` gmm_dw has no
    VJP; the two compute the same function)."""
    torch = tp.torch
    lhs, rhs, dout = _inputs("float32", seed=4)
    rng = np.random.default_rng(5)
    w3 = rng.normal(size=(len(SIZES), D, H)).astype(np.float32)
    cot = rng.normal(size=(S, D)).astype(np.float32)
    cdw = rng.normal(size=(len(SIZES), D, H)).astype(np.float32)

    def ref(a, w, o, v):
        sizes = jnp.asarray(SIZES)
        y = JGB.gmm(a, w, sizes, backend="ragged")
        z = JGB.gmm(y, jnp.swapaxes(v, 1, 2), sizes, backend="ragged")
        return z, JGB.gmm_dw(a, o, sizes, backend="segment")

    (z_ref, dw_ref), vjp = jax.vjp(ref, *(jnp.asarray(t) for t in
                                          (lhs, rhs, dout, w3)))
    want = vjp((jnp.asarray(cot), jnp.asarray(cdw)))
    a, w, o, v = (to_torch(t).requires_grad_() for t in (lhs, rhs, dout, w3))
    sizes = to_torch(SIZES)
    y = GB.gmm(a, w, sizes, backend="ragged")
    z = GB.gmm(y, v.transpose(1, 2), sizes, backend="ragged")
    dw = GB.gmm_dw(a, o, sizes, backend="ragged")
    np.testing.assert_allclose(f32(z), f32(z_ref), rtol=1e-5,
                               atol=1e-5 * float(np.abs(f32(z_ref)).max()))
    np.testing.assert_allclose(f32(dw), f32(dw_ref), rtol=1e-5,
                               atol=1e-5 * float(np.abs(f32(dw_ref)).max()))
    got = torch.autograd.grad((z, dw), (a, w, o, v),
                              (to_torch(cot), to_torch(cdw)))
    for name, g, r in zip(("lhs", "rhs", "dout", "w_t"), got, want):
        r = f32(r)
        np.testing.assert_allclose(f32(g), r, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(r).max()),
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_blaze_on_ragged_matches_reference_ragged(GB, tp, dtype):
    """The expert layer on the port's ``ragged`` against the reference
    layer on its ``ragged``: output and the gradients of x, the gates and
    the expert weights (the reference's own tolerances for the layer,
    ``tests/test_fused_path.py``: 5e-4 in float32, 5e-2 in bfloat16)."""
    from repro_torch.core.moe_layer import moe_ffn_blaze
    Lm, Dm, Hm, Em, Km = 64, 64, 128, 8, 2
    rng = np.random.default_rng(6)
    x = as_dtype(rng.normal(size=(Lm, Dm)), dtype)
    w1, w2 = (as_dtype(rng.normal(size=(Em, Dm, Hm)) * 0.1, dtype)
              for _ in range(2))
    w3 = as_dtype(rng.normal(size=(Em, Hm, Dm)) * 0.1, dtype)
    scores = rng.normal(size=(Lm, Em)).astype(np.float32)
    scores[:, 5] -= 100.0                       # expert 5 stays empty
    topk = np.argsort(-scores, axis=1)[:, :Km].astype(np.int32)
    g = np.exp(np.take_along_axis(scores, topk, 1))
    gates = as_dtype(g / g.sum(1, keepdims=True), dtype)
    dy = as_dtype(rng.normal(size=(Lm, Dm)), dtype)
    ins = [x, gates, w1, w3, w2]
    jd = R.build_dispatch(jnp.asarray(topk), Em)
    y_ref, vjp = jax.vjp(
        lambda *a: j_moe_ffn_blaze(a[0], a[1], jd, a[2], a[3], a[4],
                                   backend="ragged"),
        *(jnp.asarray(a) for a in ins))
    grads_ref = vjp(jnp.asarray(dy))
    td = tp.routing.build_dispatch(to_torch(topk), Em)
    ts = [to_torch(a).requires_grad_() for a in ins]
    y = moe_ffn_blaze(ts[0], ts[1], td, ts[2], ts[3], ts[4],
                      backend="ragged")
    y.backward(to_torch(dy))
    tol = (dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16"
           else dict(rtol=5e-4, atol=5e-4))
    assert y.dtype == ts[0].dtype
    np.testing.assert_allclose(f32(y), f32(y_ref), **tol)
    for name, t, r in zip(("x", "gates", "w1", "w3", "w2"), ts, grads_ref):
        assert t.grad.dtype == t.dtype, name
        np.testing.assert_allclose(f32(t.grad), f32(r), **tol,
                                   err_msg=f"d{name}")
    assert not ts[2].grad[5].any(), "the empty expert's dw1 must be zero"


def test_pallas_autograd_matches_segment(GB, tp):
    """Gradients of a loss through gmm (plain and transposed weight) and
    gmm_dw, pallas against segment, in float32."""
    torch = tp.torch
    lhs, rhs, dout = _inputs("float32", seed=1)
    rng = np.random.default_rng(2)
    w3 = rng.normal(size=(len(SIZES), D, H)).astype(np.float32)

    def grads(backend):
        a, w, o, v = (to_torch(t).requires_grad_()
                      for t in (lhs, rhs, dout, w3))
        sizes = to_torch(SIZES)
        y = GB.gmm(a, w, sizes, backend=backend)            # (S, H)
        z = GB.gmm(y, v.transpose(1, 2), sizes, backend=backend)  # (S, D)
        dw = GB.gmm_dw(a, o, sizes, backend=backend)        # (E, D, H)
        loss = (z * z).sum() + (dw * w).sum()
        return torch.autograd.grad(loss, (a, w, o, v))

    for name, got, want in zip(("lhs", "rhs", "dout", "w_t"),
                               grads("pallas"), grads("segment")):
        want = f32(want)
        np.testing.assert_allclose(f32(got), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=name)


def test_names_and_availability_mirror_reference(GB):
    assert GB.backend_names() == JGB.backend_names()
    assert GB.available_backends() == JGB.available_backends()
    assert getattr(GB.get_backend("pallas_fused"), "fused_moe", False)
    assert not getattr(GB.get_backend("pallas"), "fused_moe", False)
    assert GB.resolve("ragged").name == JGB.resolve("ragged").name
    with pytest.raises(ValueError, match="unknown gmm backend"):
        GB.resolve("nope")


def test_precedence_chain(GB, monkeypatch):
    monkeypatch.setenv(GB.ENV_VAR, "pallas")
    with GB.use_backend("pallas"):
        rb = GB.resolve("segment", config="pallas")
    assert (rb.name, rb.source) == ("segment", "arg")
    with GB.use_backend("segment"):
        rb = GB.resolve(None, config="pallas")
    assert (rb.name, rb.source) == ("segment", "context")
    rb = GB.resolve(None, config="segment")
    assert (rb.name, rb.source) == ("segment", "config")
    rb = GB.resolve(None)
    assert (rb.name, rb.source) == ("pallas", "env")
    monkeypatch.delenv(GB.ENV_VAR)
    # auto walks ("ragged", "segment") and lands where the reference does
    rb = GB.resolve(None)
    jrb = JGB.resolve(None)
    assert (rb.name, rb.source) == (jrb.name, jrb.source) == ("ragged",
                                                               "auto")
    assert GB.resolve(rb) is rb
    assert rb.torch_version == GB.torch.__version__


def test_scopes_nest_validate_and_stay_transparent(GB, monkeypatch):
    monkeypatch.delenv(GB.ENV_VAR, raising=False)
    assert GB.resolve("auto", config="auto").source == "auto"
    with GB.use_backend("segment"):
        with GB.use_backend("pallas"):
            assert GB.resolve(None).name == "pallas"
        with GB.use_backend(None):
            assert GB.resolve(None).name == "segment"
        with GB.use_backend("auto"):
            assert GB.resolve(None).source == "context"
    assert GB.active_backend() is None
    with GB.use_backend("ragged"), JGB.use_backend("ragged"):
        assert GB.resolve(None).name == JGB.resolve(None).name == "ragged"
    with pytest.raises(ValueError):
        with GB.use_backend("nope"):
            pass


def test_train_step_and_engine_resolve_once(GB, tp, monkeypatch):
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.train.loop import make_train_step
    cfg = get_config("mixtral-8x7b").reduced()
    tcfg = TrainConfig(total_steps=1, batch_size=1, seq_len=16)
    monkeypatch.setenv(GB.ENV_VAR, "pallas")
    step = make_train_step(cfg, tcfg, "cpu")
    assert (step.resolved_backend.name,
            step.resolved_backend.source) == ("pallas", "env")
    step = make_train_step(cfg.replace(gmm_backend="segment"), tcfg, "cpu")
    assert step.resolved_backend.source == "config"
    step = make_train_step(cfg.replace(gmm_backend="segment"),
                           tcfg.replace(gmm_backend="pallas_fused"), "cpu")
    assert step.resolved_backend.name == "pallas_fused"
    with GB.use_backend("segment"):
        step = make_train_step(cfg, tcfg.replace(gmm_backend="pallas"),
                               "cpu")
    assert step.resolved_backend.source == "context"
    step = make_train_step(cfg, tcfg, "cpu", backend="pallas_fused")
    assert step.resolved_backend.source == "arg"

    params = tp.interop.init_params(cfg, tp.torch.Generator().manual_seed(0),
                                    "cpu")
    eng = tp.engine.ServeEngine(cfg, params, capacity=32, device="cpu")
    monkeypatch.setenv(GB.ENV_VAR, "segment")
    assert eng.backend.name == "pallas"
    eng = tp.engine.ServeEngine(cfg, params, capacity=32, device="cpu",
                                gmm_backend="pallas_fused")
    assert (eng.backend.name, eng.backend.source) == ("pallas_fused", "arg")
