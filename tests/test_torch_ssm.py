"""Port parity: the recurrent scans and sublayers of ``models/ssm.py``.

- Each scan (mLSTM, sLSTM, Mamba, the Mamba dual form) against the
  reference tests' naive float64 recurrences (``tests/test_ssm.py``) at
  their shapes and chunks, and against the reference's own scan on the
  same numpy inputs.
- The single-step updates against the scans, the carry from one half of
  a sequence into the other, and the carry state itself.
- The three sublayers' outputs and gradients (of a fixed random
  cotangent) against the reference's ``jax.vjp``, with weights converted
  from the reference's init at reduced widths.

Tolerances: the reference's own, 2e-4 absolute against the naive
recurrence in float32 (``tests/test_ssm.py:92``, ``:119``, ``:133``,
``:148``) and 1e-4 for a carried or stepped sequence against the whole
scan (``:108``, ``:168``); a torch scan against the reference's scan 2e-4
absolute over 1e-5 of the output's scale (the log-depth scan and the
chunk loop sum in another order than ``jax.lax.associative_scan``); the
sublayers' outputs and gradients 1e-4 relative over 1e-4 of each
tensor's scale, as ``tests/test_torch_dense.py`` holds gradients.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.models import ssm as JS
from test_ssm import naive_mamba, naive_mlstm, naive_slstm
from torch_parity import f32, np_params, to_torch, torch_config
from torch_parity import tp  # noqa: F401


@pytest.fixture(scope="module")
def TS(tp):
    from repro_torch.models import ssm
    return ssm


def _draw(seed, shapes, shift=None):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if shift is not None:
        out[shift] += 2.0          # open forget gates, as the reference's
    return out


def _pair(tp, arrays):
    return [jnp.asarray(a) for a in arrays], [to_torch(a) for a in arrays]


def _close(got, want, atol):
    want = f32(want)
    np.testing.assert_allclose(f32(got), want,
                               atol=atol + 1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_mlstm_scan_matches_naive_and_reference(tp, TS, chunk):
    B, S, H, D = 2, 64, 2, 8
    arrs = _draw(chunk, [(B, S, H, D)] * 3 + [(B, S, H)] * 2, shift=4)
    ja, ta = _pair(tp, arrs)
    out, (C, n, m) = TS.mlstm_scan(*ta, chunk=chunk)
    np.testing.assert_allclose(f32(out), naive_mlstm(*arrs), atol=2e-4)
    ref, (jC, jn, jm) = JS.mlstm_scan(*ja, chunk=chunk)
    _close(out, ref, 2e-4)
    for got, want in ((C, jC), (n, jn), (m, jm)):
        _close(got, want, 2e-4)


@pytest.mark.parametrize("chunk", [8, 32])
def test_slstm_scan_matches_naive_and_reference(tp, TS, chunk):
    B, S, D = 2, 64, 16
    arrs = _draw(10 + chunk, [(B, S, D)] * 4, shift=3)
    ja, ta = _pair(tp, arrs)
    out, state = TS.slstm_scan(*ta, chunk=chunk)
    np.testing.assert_allclose(f32(out), naive_slstm(*arrs), atol=2e-4)
    ref, jstate = jax.jit(partial(JS.slstm_scan, chunk=chunk))(*ja)
    _close(out, ref, 2e-4)
    for got, want in zip(state, jstate):
        _close(got, want, 2e-4)


def _mamba_inputs(seed, B=2, S=32, H=3, P=4, N=8):
    u, dt_pre, bm, cm, a_log = _draw(seed, [(B, S, H, P), (B, S, H),
                                            (B, S, N), (B, S, N), (H,)])
    return [u, dt_pre, bm, cm, a_log * 0.3]


@pytest.mark.parametrize("dual,chunk", [(False, 4), (False, 16), (True, 8),
                                        (True, 32)])
def test_mamba_scans_match_naive_and_reference(tp, TS, dual, chunk):
    arrs = _mamba_inputs(20 + chunk)
    ja, ta = _pair(tp, arrs)
    scan_t = TS.mamba_scan_dual if dual else TS.mamba_scan
    scan_j = JS.mamba_scan_dual if dual else JS.mamba_scan
    out, h = scan_t(*ta, chunk=chunk)
    np.testing.assert_allclose(f32(out), naive_mamba(*arrs), atol=2e-4)
    ref, jh = scan_j(*ja, chunk=chunk)
    _close(out, ref, 2e-4)
    _close(h, jh, 2e-4)
    # both forms carry the same state
    _close(h, TS.mamba_scan(*ta, chunk=chunk)[1], 2e-4)


def test_steps_match_scans(tp, TS):
    """Feeding one position at a time through the step functions (the
    decode path) gives the scans' outputs and final states."""
    torch = tp.torch
    q, k, v, i_pre, f_pre = (to_torch(a) for a in _draw(
        30, [(1, 16, 2, 8)] * 3 + [(1, 16, 2)] * 2, shift=4))
    full, fstate = TS.mlstm_scan(q, k, v, i_pre, f_pre, chunk=8)
    st, outs = None, []
    for t in range(16):
        sl = slice(t, t + 1)
        o, st = TS.mlstm_step(q[:, sl], k[:, sl], v[:, sl], i_pre[:, sl],
                              f_pre[:, sl], st)
        outs.append(o)
    np.testing.assert_allclose(f32(torch.cat(outs, 1)), f32(full), atol=1e-4)
    for got, want in zip(st, fstate):
        np.testing.assert_allclose(f32(got), f32(want), atol=1e-4, rtol=1e-5)

    z, o_pre, i_s, f_s = (to_torch(a) for a in _draw(31, [(1, 16, 8)] * 4,
                                                     shift=3))
    full, _ = TS.slstm_scan(z, o_pre, i_s, f_s, chunk=16)
    st, outs = None, []
    for t in range(16):
        sl = slice(t, t + 1)
        o, st = TS.slstm_scan(z[:, sl], o_pre[:, sl], i_s[:, sl], f_s[:, sl],
                              chunk=1, state=st)
        outs.append(o)
    np.testing.assert_allclose(f32(torch.cat(outs, 1)), f32(full), atol=1e-4)

    u, dt_pre, bm, cm, a_log = (to_torch(a) for a in _mamba_inputs(
        32, B=1, S=16, H=2))
    full, _ = TS.mamba_scan(u, dt_pre, bm, cm, a_log, chunk=8)
    st = None
    for t in range(16):
        sl = slice(t, t + 1)
        y, st = TS.mamba_step(u[:, sl], dt_pre[:, sl], bm[:, sl], cm[:, sl],
                              a_log, st)
        np.testing.assert_allclose(f32(y[:, 0]), f32(full[:, t]), atol=1e-4)


def test_state_carries_across_halves(tp, TS):
    """Scan of the first half, its state into the scan of the second half:
    the whole scan's second half (the reference's
    ``test_mlstm_state_carry_decode``, and the same for sLSTM and
    Mamba)."""
    q, k, v, i_pre, f_pre = (to_torch(a) for a in _draw(
        40, [(1, 32, 2, 8)] * 3 + [(1, 32, 2)] * 2, shift=4))
    full, _ = TS.mlstm_scan(q, k, v, i_pre, f_pre, chunk=8)
    first = [t[:, :16] for t in (q, k, v, i_pre, f_pre)]
    second = [t[:, 16:] for t in (q, k, v, i_pre, f_pre)]
    _, st = TS.mlstm_scan(*first, chunk=8)
    out, _ = TS.mlstm_scan(*second, chunk=8, state=st)
    np.testing.assert_allclose(f32(out), f32(full[:, 16:]), atol=1e-4)

    sl_in = [to_torch(a) for a in _draw(41, [(2, 32, 8)] * 4, shift=3)]
    full, _ = TS.slstm_scan(*sl_in, chunk=8)
    _, st = TS.slstm_scan(*(t[:, :16] for t in sl_in), chunk=8)
    out, _ = TS.slstm_scan(*(t[:, 16:] for t in sl_in), chunk=8, state=st)
    np.testing.assert_allclose(f32(out), f32(full[:, 16:]), atol=1e-4)

    m_in = [to_torch(a) for a in _mamba_inputs(42)]
    seq, a_log = m_in[:4], m_in[4]
    for scan in (TS.mamba_scan, TS.mamba_scan_dual):
        full, _ = scan(*seq, a_log, chunk=8)
        _, st = scan(*(t[:, :16] for t in seq), a_log, chunk=8)
        out, _ = scan(*(t[:, 16:] for t in seq), a_log, chunk=8, state=st)
        np.testing.assert_allclose(f32(out), f32(full[:, 16:]), atol=1e-4)


def test_slstm_keeps_the_log_floor(tp, TS):
    """A decay that underflows float32 meets the 1e-30 floor before the
    log (``ssm.py:183-185``): outputs and gradients stay finite and match
    the reference's."""
    B, S, D = 1, 16, 4
    z, o_pre, i_pre, f_pre = _draw(50, [(B, S, D)] * 4)
    f_pre[:, 5:8] = -200.0           # log sigmoid ~ -200: exp underflows
    ja, ta = _pair(tp, [z, o_pre, i_pre, f_pre])
    for t in ta:
        t.requires_grad_(True)
    out, _ = TS.slstm_scan(*ta, chunk=8)
    grads = tp.torch.autograd.grad(out.square().sum(), ta)
    ref, vjp = jax.vjp(jax.jit(lambda *a: JS.slstm_scan(*a, chunk=8)[0]),
                       *ja)
    jgrads = vjp(2 * ref)
    _close(out, ref, 2e-4)
    for got, want in zip(grads, jgrads):
        assert np.isfinite(f32(got)).all()
        _close(got, want, 2e-4)


def _sublayer_cases():
    hy = get_config("hymba_1_5b").reduced()
    xl = get_config("xlstm_1_3b").reduced()
    return [("mlstm", xl, "init_mlstm_params", "mlstm_sublayer", 32),
            ("slstm", xl, "init_slstm_params", "slstm_sublayer", 32),
            ("mamba", hy, "init_mamba_params", "mamba_sublayer", 32),
            ("mamba_dual", hy.replace(mamba_dual=True), "init_mamba_params",
             "mamba_sublayer", 32)]


@pytest.mark.parametrize("name,jcfg,init,fn,S", _sublayer_cases(),
                         ids=[c[0] for c in _sublayer_cases()])
def test_sublayer_outputs_and_grads_match_jax_vjp(tp, TS, name, jcfg, init,
                                                   fn, S):
    """Each sublayer on weights from the reference's init (float32, d=256)
    and a 2 x S input: the output, the carried state, and the gradients of
    <out, cotangent> with respect to the input and every weight."""
    torch = tp.torch
    jp = getattr(JS, init)(jax.random.PRNGKey(3), jcfg, jcfg.d_model)
    tcfg = torch_config(jcfg)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    # chunk 16: two chunks, so the carry between chunks is differentiated
    jfn = jax.jit(lambda x_, p_: getattr(JS, fn)(x_, p_, jcfg, chunk=16))
    (ref, jstate), vjp = jax.vjp(jfn, jnp.asarray(x), jp)
    zero_state = jax.tree.map(jnp.zeros_like, jstate)
    jdx, jdp = vjp((jnp.asarray(ct), zero_state))
    params = {k: to_torch(np.asarray(v)).requires_grad_(True)
              for k, v in np_params(jp).items()}
    tx = to_torch(x).requires_grad_(True)
    out, state = getattr(TS, fn)(tx, params, tcfg, chunk=16)
    names = list(params)
    grads = torch.autograd.grad((out * to_torch(ct)).sum(),
                                [tx] + [params[k] for k in names])
    np.testing.assert_allclose(f32(out), f32(ref), rtol=1e-4,
                               atol=1e-4 * float(np.abs(f32(ref)).max()))
    jstate = jstate if isinstance(jstate, tuple) else (jstate,)
    state = state if isinstance(state, tuple) else (state,)
    for got, want in zip(state, jstate):
        want = f32(want)
        np.testing.assert_allclose(f32(got), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))
    for key, got, want in zip(["x"] + names, grads,
                              [jdx] + [jdp[k] for k in names]):
        want = f32(want)
        np.testing.assert_allclose(f32(got), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=f"{name} d{key}")
