"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips where there is no CUDA device;
on a machine with one, run ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_kernels_gpu.py``.  The file imports only torch and numpy
(the machine with the card has no JAX), and torch only inside fixtures.
Each kernel is compared with its plain version on the same CUDA tensors,
at small shapes that exercise the edge cases (empty experts, all slots on one expert, ragged tiles and
widths, position 0, a dead page table).

Tolerances: dispatch and combine must be bit-equal (same integers; the
combine rounds each product and sum as the plain version does).  Gather-GMM,
the grouped weight gradient and paged attention sum in another order than
the plain version, so float32 agrees to 1e-5 and bfloat16 to one bf16 step
(2^-7 relative) plus 1e-2.  Flash attention in bf16 scales the float32
scores where the plain version scales q in bf16, so 2e-2 absolute.  The
expert layer's autograd Function against autograd through the plain
versions: float32 1e-4 relative over a floor of 1e-4 times each output's
scale (a chain of products summed in other orders).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=1e-2)}


@pytest.fixture
def dev():
    """The card.  torch is imported here, not at collection (see
    ``tests/torch_parity.py``)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def K(dev):
    """The port's kernel modules."""
    from types import SimpleNamespace

    from repro_torch.core import routing
    from repro_torch.kernels import (combine, dispatch, flash_attention,
                                     gather_gmm, gmm_dw, ops,
                                     paged_attention)
    return SimpleNamespace(routing=routing, combine=combine,
                           dispatch=dispatch, gather_gmm=gather_gmm,
                           paged_attention=paged_attention, gmm_dw=gmm_dw,
                           flash_attention=flash_attention, ops=ops)


def _t(a, dev, dtype=None):
    import torch
    t = torch.from_numpy(np.array(a)).to(dev)
    return t if dtype is None else t.to(getattr(torch, dtype))


def _sync():
    import torch
    torch.cuda.synchronize()


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


def _topk(L, E, k, seed, experts=None):
    rng = np.random.default_rng(seed)
    pool = np.arange(E) if experts is None else np.asarray(experts)
    return np.stack([rng.choice(pool, size=k, replace=False)
                     for _ in range(L)]).astype(np.int32)


@pytest.mark.parametrize("L,E,k,experts", [
    (1, 4, 1, None), (37, 4, 2, None), (300, 8, 2, [1, 5]),
    (129, 8, 2, [0, 3]), (50, 8, 1, [7]), (2048, 8, 2, None),
    (700, 256, 4, None)])
def test_dispatch_kernel(dev, K, L, E, k, experts):
    topk = _t(_topk(L, E, k, seed=L + E, experts=experts), dev)
    before = K.dispatch.build_dispatch.launches
    got = K.dispatch.build_dispatch(topk, E)
    want = K.routing.build_dispatch(topk, E)
    _sync()
    assert K.dispatch.build_dispatch.launches == before + 1
    for name in K.routing.Dispatch._fields:
        assert (getattr(got, name) == getattr(want, name)).all(), name


def test_dispatch_kernel_refuses_too_many_experts(dev, K):
    with pytest.raises(ValueError, match="at most 256"):
        K.dispatch.build_dispatch(_t(np.zeros((4, 2), np.int32), dev), 257)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,d,h,lengths", [
    (48, 32, 64, (30, 0, 41, 25)),        # empty expert, total == S
    (50, 36, 70, (30, 0, 41, 20)),        # ragged widths, rows past total
    (200, 64, 136, (0, 400, 0, 0)),       # all slots on one expert
    (3, 64, 128, (2, 1, 0, 3))])          # decode-sized
def test_gather_gmm_kernel(dev, K, dtype, L, d, h, lengths):
    rng = np.random.default_rng(L + d)
    S = sum(lengths) + (7 if L == 50 else 0)
    E = len(lengths)
    x = _t(rng.normal(size=(L, d)), dev, dtype)
    idx = _t(rng.integers(0, L, size=S).astype(np.int32), dev)
    off = _t(np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32), dev)
    w1, w2 = (_t(rng.normal(size=(E, d, h)) * 0.2, dev, dtype)
              for _ in range(2))
    w3 = _t(rng.normal(size=(E, h, d)) * 0.2, dev, dtype)
    G = K.gather_gmm
    before = G.gather_gmm.launches
    y = G.gather_gmm(x, idx, off, w1, w2)
    _close(y, G.gather_gmm_plain(x, idx, off, w1, w2), dtype)
    p = G.gather_gmm(y, None, off, w3, epilogue=False)
    _close(p, G.gather_gmm_plain(y, None, off, w3, epilogue=False), dtype)
    a = G.gather_gmm(x, idx, off, w1, w2, epilogue=False)
    _close(a, G.gather_gmm_plain(x, idx, off, w1, w2, epilogue=False), dtype)
    _sync()
    assert G.gather_gmm.launches == before + 3
    total = int(off[-1])
    assert not y[total:].any() and not p[total:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,E,k,d", [(48, 4, 2, 32), (2048, 8, 2, 4096),
                                     (5, 8, 1, 100)])
def test_combine_kernel(dev, K, dtype, L, E, k, d):
    rng = np.random.default_rng(L)
    td = K.routing.build_dispatch(_t(_topk(L, E, k, seed=L), dev), E)
    p = _t(rng.normal(size=(L * k, d)), dev, dtype)
    g = _t(rng.uniform(size=(L, k)), dev, dtype)
    before = K.combine.combine.launches
    got = K.combine.combine(p, td.token_index_map, g)
    want = K.combine.combine_plain(p, td.token_index_map, g)
    _sync()
    assert K.combine.combine.launches == before + 1
    assert (got == want).all()


def _paged_case(dtype, dev, P=13, ps=8, hkv=2, g=2, dh=16):
    rng = np.random.default_rng(0)
    k = _t(rng.normal(size=(P, ps, hkv, dh)), dev, dtype)
    v = _t(rng.normal(size=(P, ps, hkv, dh)), dev, dtype)
    q = _t(rng.normal(size=(4, 1, hkv * g, dh)), dev, dtype)
    table = _t(np.array([[3, 7, 0, 0], [5, 0, 0, 0], [0, 0, 0, 0],
                         [1, 2, 9, 12]], np.int32), dev)
    pos = _t(np.array([12, 0, 0, 27], np.int32), dev)
    return q, k, v, table, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (10, 0.0), (0, 5.0),
                                        (6, 5.0)])
def test_paged_attention_kernel(dev, K, dtype, window, cap):
    args = _paged_case(dtype, dev)
    A = K.paged_attention
    before = A.paged_attention.launches
    got = A.paged_attention(*args, window=window, cap=cap)
    want = A.paged_attention_plain(*args, window=window, cap=cap)
    _sync()
    assert A.paged_attention.launches == before + 1
    _close(got, want, dtype)


def test_paged_attention_kernel_mixtral_heads(dev, K):
    """32 query heads over 8 kv heads of 128, 16-token pages."""
    args = _paged_case("bfloat16", dev, P=20, ps=16, hkv=8, g=4, dh=128)
    got = K.paged_attention.paged_attention(*args, window=20)
    want = K.paged_attention.paged_attention_plain(*args, window=20)
    _sync()
    _close(got, want, "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,d,h,lengths", [
    (48, 32, 64, (30, 0, 41, 25)),        # empty expert
    (50, 64, 136, (0, 400, 0, 0)),        # all slots on one expert
    (60, 128, 64, (130, 7, 0, 64)),       # not a multiple of the tile
    (30, 36, 70, (20, 0, 33, 10))])       # ragged widths
def test_gather_gmm_save_ab_and_transposed(dev, K, dtype, L, d, h,
                                           lengths):
    rng = np.random.default_rng(L + h)
    S, E = sum(lengths), len(lengths)
    x = _t(rng.normal(size=(L, d)), dev, dtype)
    idx = _t(rng.integers(0, L, size=S).astype(np.int32), dev)
    off = _t(np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32), dev)
    w1, w2 = (_t(rng.normal(size=(E, d, h)) * 0.2, dev, dtype)
              for _ in range(2))
    G = K.gather_gmm
    before = G.gather_gmm.launches
    got = G.gather_gmm(x, idx, off, w1, w2, save_ab=True)
    want = G.gather_gmm_plain(x, idx, off, w1, w2, save_ab=True)
    for g_, w_ in zip(got, want):
        _close(g_, w_, dtype)
    # (S, h) rows times the transposed (E, d, h) weights -> (S, d)
    dyu = _t(rng.normal(size=(S, h)), dev, dtype)
    t = G.gather_gmm(dyu, None, off, w1, epilogue=False, trans_w=True)
    _close(t, G.gather_gmm_plain(dyu, None, off, w1, epilogue=False,
                                 trans_w=True), dtype)
    _sync()
    assert G.gather_gmm.launches == before + 2
    assert t.shape == (S, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,h,lengths", [
    (32, 48, (30, 0, 41, 25)),            # empty expert
    (64, 128, (0, 0, 200, 0)),            # all rows on one expert
    (128, 64, (130, 7, 0, 64)),           # rows not a multiple of the tile
    (36, 70, (20, 0, 33, 10))])           # ragged widths
def test_gmm_dw_kernel(dev, K, dtype, d, h, lengths):
    rng = np.random.default_rng(d + h)
    S = sum(lengths) + 5                  # 5 rows past offsets[E]
    lhs = _t(rng.normal(size=(S, d)), dev, dtype)
    dout = _t(rng.normal(size=(S, h)), dev, dtype)
    off = _t(np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32), dev)
    W = K.gmm_dw
    before = W.gmm_dw.launches
    got = W.gmm_dw(lhs, dout, off)
    want = W.gmm_dw_plain(lhs, dout, off)
    _sync()
    assert W.gmm_dw.launches == before + 1
    _close(got, want, dtype)
    for e, n in enumerate(lengths):
        if n == 0:
            assert not got[e].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,Hkv,Dh,causal,window,cap", [
    (256, 4, 4, 64, True, 0, 0.0),
    (256, 8, 2, 128, True, 100, 0.0),      # G = 4, window < S
    (192, 4, 2, 128, True, 0, 5.0),        # softcap, S not a power of two
    (100, 4, 1, 64, True, 30, 20.0),       # S not a multiple of the tile
    (128, 4, 2, 48, False, 0, 0.0)])       # other head width, bidirectional
def test_flash_attention_kernel(dev, K, dtype, S, H, Hkv, Dh, causal,
                                window, cap):
    rng = np.random.default_rng(S + Dh)
    q = _t(rng.normal(size=(2, S, H, Dh)), dev, dtype)
    k, v = (_t(rng.normal(size=(2, S, Hkv, Dh)), dev, dtype)
            for _ in range(2))
    A = K.flash_attention
    before = A.flash_attention.launches
    got = A.flash_attention(q, k, v, causal=causal, window=window, cap=cap)
    want = A.flash_attention_plain(q, k, v, causal=causal, window=window,
                                   cap=cap, chunk=S)
    _sync()
    assert A.flash_attention.launches == before + 1
    if dtype == "bfloat16":
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), atol=2e-2)
    else:
        _close(got, want, dtype)


def _plain_layer(K, x, gates, disp, w1, w3, w2):
    """The expert layer through the plain versions (autograd-able)."""
    G, C = K.gather_gmm, K.combine
    y_swi = G.gather_gmm_plain(x, disp.expert_token_indices,
                               disp.expert_token_offsets, w1, w2)
    p = G.gather_gmm_plain(y_swi, None, disp.expert_token_offsets, w3,
                           epilogue=False)
    return C.combine_plain(p, disp.token_index_map, gates)


def test_moe_layer_function_matches_plain_autograd(dev, K):
    """The autograd Function on the card (E=8, top-2, widths 256 -> 512)
    against autograd through the plain versions on the same tensors."""
    import torch
    L, d, h, E, k = 512, 256, 512, 8, 2
    rng = np.random.default_rng(7)
    topk = _t(_topk(L, E, k, seed=7), dev)
    disp = K.routing.build_dispatch(topk, E)
    make = lambda *shape, s=1.0: _t(rng.normal(size=shape) * s, dev,
                                    "float32").requires_grad_()
    x, w1, w2 = make(L, d), make(E, d, h, s=0.1), make(E, d, h, s=0.1)
    w3 = make(E, h, d, s=0.1)
    gates = _t(rng.uniform(size=(L, k)), dev, "float32").requires_grad_()
    dy = _t(rng.normal(size=(L, d)), dev, "float32")
    ins = (x, gates, w1, w3, w2)
    before = dict(g=K.gather_gmm.gather_gmm.launches,
                  w=K.gmm_dw.gmm_dw.launches)
    y = K.ops.moe_ffn_blaze_pallas(x, gates, disp, w1, w3, w2)
    got = [y] + list(torch.autograd.grad(y, ins, dy))
    y_p = _plain_layer(K, x, gates, disp, w1, w3, w2)
    want = [y_p] + list(torch.autograd.grad(y_p, ins, dy))
    _sync()
    assert K.gather_gmm.gather_gmm.launches == before["g"] + 5
    assert K.gmm_dw.gmm_dw.launches == before["w"] + 3
    for name, g_, w_ in zip(("y", "dx", "dgates", "dw1", "dw3", "dw2"),
                            got, want):
        w_ = w_.detach().float().cpu().numpy()
        np.testing.assert_allclose(
            g_.detach().float().cpu().numpy(), w_, rtol=1e-4,
            atol=1e-4 * float(np.abs(w_).max()), err_msg=name)


def test_flash_attention_function_backward(dev, K):
    """dq, dk, dv of the differentiable wrapper equal autograd through the
    plain attention (the wrapper's backward recomputes through it)."""
    import torch
    rng = np.random.default_rng(3)
    q = _t(rng.normal(size=(1, 128, 4, 64)), dev, "float32").requires_grad_()
    k, v = (_t(rng.normal(size=(1, 128, 2, 64)), dev,
               "float32").requires_grad_() for _ in range(2))
    do = _t(rng.normal(size=(1, 128, 4, 64)), dev, "float32")
    A = K.flash_attention
    got = torch.autograd.grad(A.flash_attention_fused(q, k, v, True, 50),
                              (q, k, v), do)
    want = torch.autograd.grad(
        A.flash_attention_plain(q, k, v, window=50, chunk=128), (q, k, v), do)
    for g_, w_ in zip(got, want):
        _close(g_, w_, "float32")
