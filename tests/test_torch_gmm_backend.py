"""Port parity: the grouped-GEMM backend registry.

- ``gmm`` / ``gmm_dw`` of the port's ``segment`` and ``pallas`` backends
  (the latter through its kernels' plain versions here) against the
  reference's ``segment`` backend, with an empty group and rows past the
  group total.  The reference's ``pallas`` backend does not trace on the
  installed JAX (no ``pallas.load``), so its exact oracle is used.
- The ``pallas`` autograd Functions (each backward built from the other
  kernel, a transposed weight read in place) against autograd through the
  ``segment`` backend.
- The resolution chain, as ``tests/test_backend_resolution.py`` holds the
  reference to it: call-site > ``use_backend`` scope > config >
  ``REPRO_GMM_BACKEND`` > auto, with the same names.

Tolerances: float32 1e-5 relative over 1e-5 of each output's scale (the
same sums in another order); bfloat16 one bf16 step (2^-7) of the scale
(both sides round once from float32 sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import gmm_backend as JGB
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
@pytest.mark.parametrize("backend", ["segment", "pallas"])
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
    assert GB.available_backends() == ["segment", "pallas", "pallas_fused"]
    assert getattr(GB.get_backend("pallas_fused"), "fused_moe", False)
    assert not getattr(GB.get_backend("pallas"), "fused_moe", False)
    with pytest.raises(RuntimeError, match="A2"):
        GB.resolve("ragged")
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
    # auto walks ("ragged", "segment") as the reference does where ragged is
    # unavailable
    rb = GB.resolve(None)
    assert (rb.name, rb.source) == ("segment", "auto")
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
    with pytest.raises(RuntimeError):
        with GB.use_backend("ragged"):
            pass
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
