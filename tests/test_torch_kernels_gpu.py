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
scores where the plain version scales q in bf16, so 2e-2 absolute
(``FLASH_ATOL``); where each output averages hundreds of keys (the
bidirectional cases), 2^-5 of |o| plus its row's mean |o|
(``FLASH_ROW_REL``); each flash call also holds the kernel it ran (the
tensor cores or the general kernel).  The
expert layer's autograd Function against autograd through the plain
versions: float32 1e-4 relative over a floor of 1e-4 times each output's
scale (a chain of products summed in other orders).  The fused MoE pair:
float32 outputs summed in another order, so float32 agrees to
1e-5 relative over 1e-5 of each output's scale, and bfloat16 (whose
backward also feeds da, db and g y_swi to the tensor cores in bf16) to one
bf16 step (2^-7) of each output's scale plus 1e-2.  The fused dense SwiGLU
kernels: the same float32 sums in another order from the same bf16
operands (da and db rounded to bf16 on both sides, with a fast exponential
in the kernel), so float32 agrees to 1e-5 relative over 1e-5 of each
output's scale and bfloat16 to one bf16 step of each output's scale plus
1e-2; their autograd Function against autograd through the plain versions
as the expert layer's.  The int8 paged kernel: as the model-dtype one.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=1e-2)}
FLASH_ATOL = 2e-2
FLASH_ROW_REL = 2 ** -5


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
    from repro_torch.core import moe_layer
    from repro_torch.kernels import (combine, dispatch, flash_attention,
                                     fused_moe, fused_swiglu, gather_gmm,
                                     gather_rows, gmm_dw, ops,
                                     paged_attention)
    from repro_torch.serve import kv_quant
    return SimpleNamespace(routing=routing, combine=combine,
                           dispatch=dispatch, gather_gmm=gather_gmm,
                           paged_attention=paged_attention, gmm_dw=gmm_dw,
                           flash_attention=flash_attention, ops=ops,
                           fused_moe=fused_moe, moe_layer=moe_layer,
                           fused_swiglu=fused_swiglu, kv_quant=kv_quant,
                           gather_rows=gather_rows)


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


def _equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and bool(torch.equal(a, b))


def _topk(L, E, k, seed, experts=None):
    rng = np.random.default_rng(seed)
    pool = np.arange(E) if experts is None else np.asarray(experts)
    return np.stack([rng.choice(pool, size=k, replace=False)
                     for _ in range(L)]).astype(np.int32)


def _one_row_topk(L, E):
    """Top-2 routing in which expert 0 receives exactly one slot."""
    topk = _topk(L, E, 2, seed=L, experts=range(1, E))
    topk[0, 0] = 0
    return topk


# The main path's shapes (L, E, k): decode, prefill, training, ep_a2a's
# pack on one rank, qwen3_moe_30b_a3b's training width, the paper's Table-1
# confs 2 and 3 (32 x 2048 tokens), the widest expert count, and both sides
# of the one-launch limit N_ONE (16384 slots).
PATH_SHAPES = [(4, 8, 2), (2048, 8, 2), (4096, 8, 2), (8192, 2, 1),
               (4096, 128, 8), (65536, 8, 2), (65536, 16, 4), (8192, 256, 8),
               (8192, 8, 2), (16385, 8, 1)]


# Qwen3-30B-A3B's expert bank (E = 128, k = 8): ragged training rows with
# a quarter of the experts empty, and the decode slots (4 tokens x 8 = 32
# slots, 96 experts empty)
E128_TRAIN = tuple((i * 53) % 97 + 1 if i % 4 else 0 for i in range(128))
E128_DECODE = tuple(1 if i % 4 == 0 else 0 for i in range(128))


def _topk_fast(L, E, k, seed):
    """(L, k) distinct expert ids per row, vectorized for large L."""
    rng = np.random.default_rng(seed)
    return np.argsort(rng.random((L, E)), axis=1)[:, :k].astype(np.int32)


@pytest.mark.parametrize("L,E,k,experts", [
    (1, 4, 1, None), (37, 4, 2, None), (300, 8, 2, [1, 5]),
    (129, 8, 2, [0, 3]), (50, 8, 1, [7]), (2048, 8, 2, None),
    (700, 256, 4, None)] + [(L, E, k, "fast") for L, E, k in PATH_SHAPES])
def test_dispatch_kernel(dev, K, L, E, k, experts):
    """Bit-equal to the plain build, twice (a second call gives the same
    integers), one wrapper launch a call."""
    ids = (_topk_fast(L, E, k, seed=L + E) if experts == "fast"
           else _topk(L, E, k, seed=L + E, experts=experts))
    topk = _t(ids, dev)
    want = K.routing.build_dispatch(topk, E)
    for _ in range(2):
        before = K.dispatch.build_dispatch.launches
        got = K.dispatch.build_dispatch(topk, E)
        _sync()
        assert K.dispatch.build_dispatch.launches == before + 1
        for name in K.routing.Dispatch._fields:
            assert _equal(getattr(got, name), getattr(want, name)), name


def test_dispatch_kernel_empty(dev, K):
    """n = 0: zero lengths and offsets, empty maps, one launch."""
    topk = _t(np.zeros((0, 2), np.int32), dev)
    got = K.dispatch.build_dispatch(topk, 8)
    _sync()
    want = K.routing.build_dispatch(topk, 8)
    for name in K.routing.Dispatch._fields:
        assert _equal(getattr(got, name), getattr(want, name)), name


def test_dispatch_kernel_refuses_too_many_experts(dev, K):
    with pytest.raises(ValueError, match="at most 256"):
        K.dispatch.build_dispatch(_t(np.zeros((4, 2), np.int32), dev), 257)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_attention_long_table(dev, K, quant):
    """A long-context table (2048 pages of 16 a request, Qwen3-14B's heads)
    with short and long positions: the split rule's cap of 32 pages gives
    64 splits, of which a short request has one or two live."""
    import torch
    A = K.paged_attention
    hkv, g, dh, ps, pps = 8, 5, 128, 16, 2048
    assert A.split_pages(4, hkv, pps, torch.cuda.get_device_properties(
        dev).multi_processor_count) == 32
    q, k, v, _, _ = _paged_case("bfloat16", dev, P=97, ps=ps, hkv=hkv, g=g,
                                dh=dh)
    rng = np.random.default_rng(4)
    table = _t(rng.integers(1, 97, size=(4, pps)).astype(np.int32), dev)
    pos = _t(np.array([5, 600, 20000, pps * ps - 1], np.int32), dev)
    if quant:
        kq, ks = K.kv_quant.quantize(k)
        vq, vs = K.kv_quant.quantize(v)
        args = (q, kq, vq, ks, vs, table, pos)
        kernel, plain = A.paged_attention_int8, A.paged_attention_int8_plain
    else:
        args = (q, k, v, table, pos)
        kernel, plain = A.paged_attention, A.paged_attention_plain
    for window in (0, 700):
        got = kernel(*args, window=window)
        _sync()
        _close(got, plain(*args, window=window), "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,lengths", [
    (700, (300, 0, 41, 0, 200, 0, 77, 0)),   # empty groups, rows past total
    (64, (0, 0, 0, 0)),                      # every group empty
    (96, (0, 96, 0))])                       # one group takes every row
def test_ragged_backend_edges_on_card(dev, dtype, S, lengths):
    """``ragged`` (``torch._grouped_mm``) on the card in the launchers' bf16
    and in float32: the rows past the group total of ``gmm`` (and of its
    input gradient) and an empty group's ``gmm_dw`` are exactly 0; the
    rest matches ``segment``."""
    import torch
    from repro_torch.core import gmm_backend as GB
    rng = np.random.default_rng(S)
    E, d, h = len(lengths), 64, 128
    lhs = _t(rng.normal(size=(S, d)), dev, dtype).requires_grad_()
    rhs = _t(rng.normal(size=(E, d, h)) * d ** -0.5, dev,
             dtype).requires_grad_()
    dout = _t(rng.normal(size=(S, h)), dev, dtype)
    sizes = _t(np.array(lengths, np.int32), dev)
    total, empty = sum(lengths), [e for e, n in enumerate(lengths) if not n]
    rb, sb = GB.RaggedBackend, GB.SegmentBackend
    y = rb.gmm(lhs, rhs, sizes)
    dlhs, drhs = torch.autograd.grad(y, (lhs, rhs), dout)
    dw = rb.gmm_dw(lhs.detach(), dout, sizes)
    _sync()
    assert (y[total:] == 0).all() and (dlhs[total:] == 0).all()
    assert (dw[empty] == 0).all() and (drhs[empty] == 0).all()
    lhs0 = lhs.detach()
    _close(y.detach(), sb.gmm(lhs0, rhs.detach(), sizes), dtype)
    _close(dw, sb.gmm_dw(lhs0, dout, sizes), dtype)
    _close(drhs, sb.gmm_dw(lhs0, dout, sizes), dtype)


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
@pytest.mark.parametrize("L,E,k,d,off", [
    (48, 4, 2, 32, 0), (2048, 8, 2, 4096, 0), (5, 8, 1, 100, 0),
    (2048, 8, 1, 4096, 0),     # k = 1
    (300, 8, 8, 4096, 0),      # k = 8: every expert
    (4, 8, 8, 4096, 0),        # decode rows, k = 8
    (37, 8, 2, 4100, 0),       # d not a multiple of the 16-byte piece
    (64, 8, 2, 4096, 1),       # p's base one element off 16-byte alignment
    (4096, 128, 8, 2048, 0),   # Qwen3-30B-A3B: k = 8 at d = 2048
    (4, 128, 8, 2048, 0)])     # its decode rows
def test_combine_kernel(dev, K, dtype, L, E, k, d, off):
    """Bit-equal to the plain version, one launch a call, on the 16-byte
    path and on the element-wise one (d = 4100, a misaligned p)."""
    rng = np.random.default_rng(L)
    td = K.routing.build_dispatch(_t(_topk(L, E, k, seed=L), dev), E)
    flat = _t(rng.normal(size=(off + L * k * d)), dev, dtype)
    p = flat[off:].view(L * k, d)
    assert (p.data_ptr() % 16 != 0) == (off != 0)
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


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("g", [4, 5, 8])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (40, 0.0), (0, 30.0)])
def test_paged_attention_split_boundaries(dev, K, quant, g, window, cap):
    """The split walk at the serving shapes (8 kv heads of 128, 16-token
    pages, 64 pages a request) with the GQA groups of Mixtral (4),
    Qwen3-14B (5) and Qwen3-30B-A3B (8, the widest instantiated): positions on the last and first row of a split, one
    row past a boundary, and the table's end; against the plain version
    and against the split walk's plain version at the kernel's split."""
    import torch
    A = K.paged_attention
    hkv, dh, ps, pps = 8, 128, 16, 64
    span = A.split_pages(4, hkv, pps, torch.cuda.get_device_properties(
        dev).multi_processor_count) * ps
    q, k, v, _, _ = _paged_case("bfloat16", dev, P=1 + 4 * pps, ps=ps,
                                hkv=hkv, g=g, dh=dh)
    perm = np.random.default_rng(3).permutation(4 * pps) + 1
    table = _t(perm.reshape(4, pps).astype(np.int32), dev)
    pos = _t(np.array([span - 1, span, 3 * span + 1, pps * ps - 1],
                      np.int32), dev)
    if quant:
        kq, ks = K.kv_quant.quantize(k)
        vq, vs = K.kv_quant.quantize(v)
        args = (q, kq, vq, ks, vs, table, pos)
        kernel, plain = A.paged_attention_int8, A.paged_attention_int8_plain
        split = A.paged_attention_int8_split_plain
    else:
        args = (q, k, v, table, pos)
        kernel, plain = A.paged_attention, A.paged_attention_plain
        split = A.paged_attention_split_plain
    before = kernel.launches
    got = kernel(*args, window=window, cap=cap)
    _sync()
    assert kernel.launches == before + 1
    _close(got, plain(*args, window=window, cap=cap), "bfloat16")
    _close(got, split(*args, window=window, cap=cap,
                      pages_per_split=span // ps), "bfloat16")


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


@pytest.mark.parametrize("d,h,lengths,past", [
    (256, 384, (1, 130, 0, 169), 0),      # an expert of one row; S = 300
    (328, 520, (0, 200, 0, 77), 23),      # empty experts, rows past total;
                                          # widths off the 256 / 128 tiles
    (512, 1000, (0, 0, 300, 0), 0),       # every slot on one expert
    (1024, 2048, (2, 1, 0, 3, 0, 0, 1, 1), 0),    # decode: 8 slots
    (256, 384, (0, 0, 0, 0), 300),        # no routed row: all rows zeroed
    pytest.param(2048, 768, E128_TRAIN, 0, id="qwen3-moe-e128-training"),
    pytest.param(2048, 768, E128_DECODE, 0, id="qwen3-moe-e128-decode")])
def test_gather_gmm_wgmma_instantiations(dev, K, d, h, lengths, past):
    """The three wgmma instantiations of gather-GMM in bf16 (the dual
    branch over gathered rows with and without ``save_ab`` and over
    identity rows, the single weight over identity rows, and the
    transposed weight) at tile edges
    against the plain version (bf16 tolerance as above); rows at or past
    offsets[E] exactly 0; a repeated call bit-equal (one block owns each
    output element, so nothing depends on the order of blocks)."""
    import torch
    rng = np.random.default_rng(d + h + past)
    E = len(lengths)
    S = sum(lengths) + past
    L = max(S // 2, 1)
    x = _t(rng.normal(size=(L, d)), dev, "bfloat16")
    idx = _t(rng.integers(0, L, size=S).astype(np.int32), dev)
    off = _t(np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32), dev)
    w1, w2 = (_t(rng.normal(size=(E, d, h)) * d ** -0.5, dev, "bfloat16")
              for _ in range(2))
    w3 = _t(rng.normal(size=(E, h, d)) * h ** -0.5, dev, "bfloat16")
    rows_h = _t(rng.normal(size=(S, h)), dev, "bfloat16")
    rows_d = _t(rng.normal(size=(S, d)), dev, "bfloat16")
    G = K.gather_gmm
    calls = [
        ("dual + save_ab", (x, idx, off, w1, w2), dict(save_ab=True)),
        ("dual", (x, idx, off, w1, w2), {}),
        ("dual over identity rows", (rows_d, None, off, w1, w2), {}),
        ("w3 forward", (rows_h, None, off, w3), dict(epilogue=False)),
        ("w3^T", (rows_d, None, off, w3), dict(epilogue=False,
                                                trans_w=True)),
        ("w1^T", (rows_h, None, off, w1), dict(epilogue=False,
                                                trans_w=True))]
    total = int(off[-1])
    for name, args, kw in calls:
        before = G.gather_gmm.launches
        got = G.gather_gmm(*args, **kw)
        again = G.gather_gmm(*args, **kw)
        _sync()
        assert G.gather_gmm.launches == before + 2, name
        want = G.gather_gmm_plain(*args, **kw)
        got, again, want = ((t,) if isinstance(t, torch.Tensor) else t
                            for t in (got, again, want))
        for g_, a_, w_ in zip(got, again, want):
            assert torch.equal(g_, a_), f"{name}: repeated call differs"
            assert not g_[total:].any(), f"{name}: rows past total"
            _scale_close(name, g_, w_, "bfloat16")


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


@pytest.mark.parametrize("d,h,lengths,past", [
    (328, 520, (0, 200, 0, 77), 23),      # partial TMA boxes, empty experts
    (256, 384, (0, 0, 300, 0), 0),        # every row on one expert
    (64, 64, (1, 0, 63, 65), 5),          # one row; rows on a step boundary
    (4096, 256, (1000, 700), 300),        # ep_a2a: a trash group past E
    pytest.param(2048, 768, E128_TRAIN, 0, id="qwen3-moe-dw1"),
    pytest.param(768, 2048, E128_TRAIN, 0, id="qwen3-moe-dw3")])
def test_gmm_dw_wgmma_edges(dev, K, d, h, lengths, past):
    """The bf16 kernel (moe_dw_wgmma): rows past offsets[E] hold NaN and
    contribute nothing, empty experts are exactly 0, a repeated call is
    bit-equal (one block per output tile), against the plain version."""
    import torch
    rng = np.random.default_rng(d + h + past)
    S = sum(lengths) + past
    lhs = _t(rng.normal(size=(S, d)), dev, "bfloat16")
    dout = _t(rng.normal(size=(S, h)), dev, "bfloat16")
    lhs[sum(lengths):] = float("nan")
    dout[sum(lengths):] = float("nan")
    off = _t(np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32), dev)
    W = K.gmm_dw
    got, again = W.gmm_dw(lhs, dout, off), W.gmm_dw(lhs, dout, off)
    want = W.gmm_dw_plain(lhs, dout, off)
    _sync()
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got.float()).all())
    _close(got, want, "bfloat16")
    for e, n in enumerate(lengths):
        if n == 0:
            assert not got[e].any()


@pytest.mark.parametrize("L,E,d,h,experts,lo,count", [
    (4, 8, 512, 256, None, 0, 8),                # decode: 8 slots
    (300, 8, 136, 72, (1, 2, 6), 0, 8),          # 5 empty experts
    # S = 8192 slots: backward h-ranges of 1280, 1280 and a ragged 40
    pytest.param(4096, 4, 256, 2600, None, 0, 4, id="three-ranges-ragged"),
    # routing.slice_dispatch's layout: 2 of 8 experts, the other slots
    # past offsets[E]
    pytest.param(100, 8, 128, 96, (0, 1, 2, 4, 5, 6, 7), 2, 2,
                 id="sliced-dead-slots"),
    # Qwen3-30B-A3B: top-8 of 128 experts, 85 of them empty
    pytest.param(512, 128, 2048, 768,
                 _topk(512, 128, 8, seed=3, experts=range(0, 128, 3)), 0,
                 128, id="qwen3-moe-e128-top8")])
def test_fused_moe_bwd_wgmma(dev, K, L, E, d, h, experts, lo, count):
    """The bf16 backward (moe_bwd_up_wgmma, moe_dw_wgmma's gathered
    instantiations, moe_down_wgmma with two products, the dgates sum, the
    slot sum of dx): every output bit-equal across calls (one writer per
    element), dgates past offsets[E] and empty experts' gradients exactly
    0, every output against the plain version."""
    import torch
    F = K.fused_moe
    x, dy, g, disp, ws = _fused_inputs(dev, "bfloat16", L, E, d, h,
                                       experts, seed=L + h)
    if (lo, count) != (0, E):
        disp = K.routing.slice_dispatch(disp, lo, count=count)
        ws = tuple(w[lo:lo + count].contiguous() for w in ws)
    idx, off = disp.expert_token_indices, disp.expert_token_offsets
    tim = disp.token_index_map
    got = F.fused_moe_bwd(x, dy, g, idx, off, *ws, tim)
    again = F.fused_moe_bwd(x, dy, g, idx, off, *ws, tim)
    want = F.fused_moe_bwd_plain(x, dy, g, idx, off, *ws)
    _sync()
    for name, g_, a_, w_ in zip(("dx", "dgates", "dw1", "dw2", "dw3"), got,
                                again, want):
        assert torch.equal(g_, a_), name
        _scale_close(name, g_, w_, "bfloat16")
    assert not got[1][int(off[-1]):].any()
    for e, n in enumerate(disp.expert_lengths.tolist()):
        if n == 0:
            assert not any(t[e].any() for t in got[2:]), e


# The tensor-core kernel's other widths (multiples of 8 up to 128, padded
# to 64 or 128 with zero columns), each at one position, at S = 100 with a
# window and a softcap, and at S = 300 causal and with both; GQA groups
# 1-8 by turns.
_GROUPS = ((4, 4), (4, 2), (6, 2), (8, 2), (10, 2), (6, 1), (7, 1), (8, 1))
_WIDTH_CASES = [
    (S, *_GROUPS[(4 * i + j) % 8], Dh, True, window, cap)
    for i, Dh in enumerate((16, 48, 72, 80, 96, 112))
    for j, (S, window, cap) in enumerate(((1, 0, 0.0), (100, 30, 20.0),
                                          (300, 0, 0.0), (300, 200, 5.0)))]


def _flash_run(A, q, k, v, **kw):
    """One kernel call through the wrapper: its output and whether it took
    the tensor cores, held against the launch counts (every call counted,
    the general kernel's also on their own)."""
    before = (A.flash_attention.launches, A.flash_attention.general_launches)
    tensor_cores = A.tensor_core_path(q, k, v)
    got = A.flash_attention(q, k, v, **kw)
    assert A.flash_attention.launches == before[0] + 1
    assert (A.flash_attention.general_launches
            == before[1] + (not tensor_cores))
    return got, tensor_cores


def _tensor_core_width(dtype, Dh) -> bool:
    return dtype == "bfloat16" and Dh % 8 == 0 and Dh <= 128


def _row_close(got, want):
    """Each element within FLASH_ROW_REL of |o| plus its row's mean |o|."""
    w = want.float()
    scale = w.abs() + w.abs().mean(-1, keepdim=True)
    ratio = float(((got.float() - w).abs() / scale).max())
    assert ratio <= FLASH_ROW_REL, ratio


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,Hkv,Dh,causal,window,cap", [
    (256, 4, 4, 64, True, 0, 0.0),
    (256, 8, 2, 128, True, 100, 0.0),      # G = 4, window < S
    (192, 4, 2, 128, True, 0, 5.0),        # softcap, S not a power of two
    (100, 4, 1, 64, True, 30, 20.0),       # S not a multiple of the tile
    (128, 4, 2, 48, False, 0, 0.0),        # other head width, bidirectional
    (256, 40, 8, 128, True, 0, 0.0),       # Qwen3-14B's heads: G = 5
    (1, 4, 2, 128, True, 0, 0.0),          # one position
    (2048, 4, 2, 128, True, 700, 30.0),    # window < S and a softcap
    (300, 4, 2, 64, True, 0, 0.0),         # S not a multiple of 128
    (300, 8, 2, 128, True, 200, 0.0),
    (2048, 32, 4, 128, True, 0, 0.0),      # Qwen3-30B-A3B's heads: G = 8
    *_WIDTH_CASES])
def test_flash_attention_kernel(dev, K, dtype, S, H, Hkv, Dh, causal,
                                window, cap):
    rng = np.random.default_rng(S + Dh)
    q = _t(rng.normal(size=(2, S, H, Dh)), dev, dtype)
    k, v = (_t(rng.normal(size=(2, S, Hkv, Dh)), dev, dtype)
            for _ in range(2))
    A = K.flash_attention
    got, tensor_cores = _flash_run(A, q, k, v, causal=causal, window=window,
                                   cap=cap)
    want = A.flash_attention_plain(q, k, v, causal=causal, window=window,
                                   cap=cap, chunk=S)
    _sync()
    assert tensor_cores == _tensor_core_width(dtype, Dh)
    if dtype == "bfloat16":
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   atol=FLASH_ATOL)
    else:
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype,S,H,Hkv,Dh,causal,window,cap,misaligned", [
    ("float32", 300, 8, 2, 64, True, 0, 0.0, False),
    ("float32", 300, 6, 2, 80, True, 100, 5.0, False),
    ("float32", 2048, 16, 16, 80, False, 0, 0.0, False),   # HuBERT's heads
    ("float32", 100, 4, 1, 80, True, 0, 0.0, True),
    ("bfloat16", 300, 8, 2, 100, True, 0, 0.0, False),     # Dh % 8 != 0
    ("bfloat16", 300, 4, 4, 100, False, 0, 0.0, False),
    ("bfloat16", 300, 8, 1, 160, True, 200, 20.0, False),  # Dh > 128
    ("bfloat16", 256, 4, 2, 256, True, 0, 0.0, False),
    ("bfloat16", 1, 4, 2, 256, True, 0, 0.0, False),
    ("bfloat16", 300, 8, 2, 80, True, 0, 0.0, True),       # off 16 bytes
    ("bfloat16", 300, 4, 4, 128, False, 0, 0.0, True)])
def test_flash_attention_general_kernel(dev, K, dtype, S, H, Hkv, Dh,
                                        causal, window, cap, misaligned):
    """The general kernel: float32 at the tensor-core widths and at
    HuBERT-XLarge's (its whole training shape without the causal mask),
    bf16 at widths the tensor cores do not take, and tensors one element
    off their allocation's 16-byte start (q misaligned, k and v aligned),
    against the plain version."""
    import torch
    rng = np.random.default_rng(S + Dh + misaligned)
    q = _t(rng.normal(size=(2, S, H, Dh)), dev, dtype)
    if misaligned:
        buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
        q = buf[1:].view(q.shape).copy_(q)
        assert q.data_ptr() % 16 != 0
    k, v = (_t(rng.normal(size=(2, S, Hkv, Dh)), dev, dtype)
            for _ in range(2))
    A = K.flash_attention
    got, tensor_cores = _flash_run(A, q, k, v, causal=causal, window=window,
                                   cap=cap)
    want = A.flash_attention_plain(q, k, v, causal=causal, window=window,
                                   cap=cap, chunk=S if S <= 512 else 512)
    _sync()
    assert not tensor_cores
    if dtype == "float32":
        _close(got, want, dtype)
    elif not causal and S >= 300:
        _row_close(got, want)
    else:
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   atol=FLASH_ATOL)


def test_flash_attention_refuses_tensor_cores_it_cannot_take(dev, K):
    """The C entry point refuses the tensor-core kernel for float32, a
    width off the multiple of 8 or above 128, and a pointer off 16 bytes
    (nothing launched: the output keeps its sentinel)."""
    import torch

    from repro_torch.kernels import _lib
    lib = _lib.lib()
    for dtype, Dh, shift in ((torch.float32, 64, 0), (torch.bfloat16, 100, 0),
                             (torch.bfloat16, 160, 0),
                             (torch.bfloat16, 64, 1)):
        n = 2 * 128 * 4 * Dh
        buf = torch.randn(n + 1, device=dev).to(dtype)
        q = buf[shift:shift + n].view(2, 128, 4, Dh)
        k = torch.randn(2, 128, 2, Dh, device=dev).to(dtype)
        v = torch.randn(2, 128, 2, Dh, device=dev).to(dtype)
        out = torch.full_like(q, 7.0)
        rc = lib.repro_flash_attention(
            _lib.DTYPE_CODE[dtype], 1, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), 2, 128, 4, 2, Dh, 1, 0, 0.0,
            Dh ** -0.5, _lib.stream_ptr(q))
        assert rc != 0, (dtype, Dh, shift)
        _sync()
        assert bool((out == 7.0).all()), (dtype, Dh, shift)


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


@pytest.mark.parametrize("spec", ["none", "paper"])
def test_blaze_pallas_layer_in_a_checkpoint_region(dev, K, spec):
    """The ``blaze_pallas`` MoE sublayer (bf16, E=8, top-2, widths 256 ->
    512) in a checkpoint region of ``spec``'s policy against the same
    sublayer unwrapped: the output and every gradient bit-equal (every
    kernel on the path is deterministic and the recompute reruns them on
    the same inputs), and the forward's kernels launched once more for
    the recompute (dispatch, two gather-GMMs, combine)."""
    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import checkpoint as CK
    from repro_torch.models.moe_block import moe_sublayer
    cfg = ModelConfig(name="t", arch_type="moe", d_model=256,
                      num_experts=8, top_k=2, moe_d_ff=512,
                      block_pattern=("attn_moe",), moe_impl="blaze_pallas",
                      remat_policy=spec)
    _, policy = CK.plan_policies(cfg.checkpoint_plan, cfg.block_pattern)
    rng = np.random.default_rng(11)
    make = lambda *shape, s=1.0: _t(rng.normal(size=shape) * s, dev,
                                    "float32").requires_grad_()
    p = {"wg": make(256, 8, s=0.1), "w1": make(8, 256, 512, s=0.05),
         "w2": make(8, 256, 512, s=0.05), "w3": make(8, 512, 256, s=0.05)}
    x = _t(rng.normal(size=(4, 128, 256)), dev, "bfloat16").requires_grad_()
    dy = _t(rng.normal(size=(4, 128, 256)), dev, "bfloat16")
    ins = (x,) + tuple(p.values())
    names = ("dispatch", "gather_gmm", "combine", "gmm_dw")
    mods = (K.dispatch.build_dispatch, K.gather_gmm.gather_gmm,
            K.combine.combine, K.gmm_dw.gmm_dw)
    out, launches = {}, {}
    for wrap in (False, True):
        before = [m.launches for m in mods]
        if wrap:
            y, _ = CK.checkpoint(lambda x_: moe_sublayer(x_, p, cfg), x,
                                 policy=policy)
        else:
            y, _ = moe_sublayer(x, p, cfg)
        out[wrap] = [y] + list(torch.autograd.grad(y, ins, dy))
        _sync()
        launches[wrap] = [m.launches - b for m, b in zip(mods, before)]
    assert launches[False] == [1, 5, 1, 3], launches
    assert launches[True] == [2, 7, 2, 3], launches
    for name, a, b in zip(("y", "dx", "dwg", "dw1", "dw2", "dw3"),
                          out[True], out[False]):
        assert _equal(a, b), name


@pytest.mark.parametrize("Dh", [64, 80])
def test_flash_attention_function_backward(dev, K, Dh):
    """dq, dk, dv of the differentiable wrapper equal autograd through the
    plain attention (the wrapper's backward recomputes through it), at
    head widths 64 and 80 (HuBERT-XLarge's)."""
    import torch
    rng = np.random.default_rng(3)
    q = _t(rng.normal(size=(1, 128, 4, Dh)), dev, "float32").requires_grad_()
    k, v = (_t(rng.normal(size=(1, 128, 2, Dh)), dev,
               "float32").requires_grad_() for _ in range(2))
    do = _t(rng.normal(size=(1, 128, 4, Dh)), dev, "float32")
    A = K.flash_attention
    got = torch.autograd.grad(A.flash_attention_fused(q, k, v, True, 50),
                              (q, k, v), do)
    want = torch.autograd.grad(
        A.flash_attention_plain(q, k, v, window=50, chunk=128), (q, k, v), do)
    for g_, w_ in zip(got, want):
        _close(g_, w_, "float32")


def _fused_inputs(dev, dtype, L, E, d, h, experts, seed):
    """``experts``: the pool each token's two experts come from (None:
    all), or the (L, k) routing itself."""
    from repro_torch.core import routing
    rng = np.random.default_rng(seed)
    topk = (experts if isinstance(experts, np.ndarray)
            else _topk(L, E, 2, seed, experts))
    disp = routing.build_dispatch(_t(topk, dev), E)
    g_slot = _t(rng.uniform(size=disp.num_slots), dev, "float32")
    x = _t(rng.normal(size=(L, d)), dev, dtype)
    dy = _t(rng.normal(size=(L, d)), dev, dtype)
    w1, w2 = (_t(rng.normal(size=(E, d, h)) * d ** -0.5, dev, dtype)
              for _ in range(2))
    w3 = _t(rng.normal(size=(E, h, d)) * h ** -0.5, dev, dtype)
    return x, dy, g_slot, disp, (w1, w2, w3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,E,d,h,experts", [
    (100, 8, 256, 192, (0, 1, 2, 4, 5, 6, 7)),   # empty expert 3; S=200
    (300, 8, 136, 72, (1, 2, 6)),                # 5 empty; d, h not tiles
    (37, 4, 100, 60, None),                      # d, h not multiples of 8
    (4, 8, 512, 256, None),                      # decode: 8 slots
    # the bf16 forward's tiles: S = 8192 slots take h-ranges of 2048, so
    # h = 2600 is two passes with a ragged last range of 552
    pytest.param(4096, 4, 256, 2600, None, id="two-passes-ragged-range"),
    # expert 0 holds one row; d = 328 is not a multiple of the 256-wide
    # d tile
    pytest.param(129, 4, 328, 264, _one_row_topk(129, 4),
                 id="one-row-expert-d328"),
    # k = 1, every slot on expert 5
    pytest.param(300, 8, 256, 384, np.full((300, 1), 5, np.int32),
                 id="all-slots-one-expert"),
    # Qwen3-30B-A3B's widths: top-8 of 128 experts (85 empty), and its
    # decode (4 tokens, 32 slots over 128 experts)
    pytest.param(512, 128, 2048, 768,
                 _topk(512, 128, 8, seed=3, experts=range(0, 128, 3)),
                 id="qwen3-moe-e128-top8"),
    pytest.param(4, 128, 2048, 768, _topk(4, 128, 8, seed=4),
                 id="qwen3-moe-decode")])
def test_fused_moe_kernels(dev, K, dtype, L, E, d, h, experts):
    F = K.fused_moe
    x, dy, g, disp, ws = _fused_inputs(dev, dtype, L, E, d, h, experts,
                                       seed=L + d)
    idx, off = disp.expert_token_indices, disp.expert_token_offsets
    tim = disp.token_index_map
    before = (F.fused_moe_fwd.launches, F.fused_moe_bwd.launches)
    got = [F.fused_moe_fwd(x, g, idx, off, *ws, tim),
           *F.fused_moe_bwd(x, dy, g, idx, off, *ws, tim)]
    want = [F.fused_moe_fwd_plain(x, g, idx, off, *ws),
            *F.fused_moe_bwd_plain(x, dy, g, idx, off, *ws)]
    _sync()
    assert (F.fused_moe_fwd.launches,
            F.fused_moe_bwd.launches) == (before[0] + 1, before[1] + 1)
    for name, g_, w_ in zip(("y", "dx", "dgates", "dw1", "dw2", "dw3"),
                            got, want):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape, name
        w_ = w_.cpu().numpy()
        scale = float(np.abs(w_).max())
        tol = (dict(rtol=0.0, atol=2 ** -7 * scale + 1e-2)
               if dtype == "bfloat16"
               else dict(rtol=1e-5, atol=1e-5 * scale))
        np.testing.assert_allclose(g_.cpu().numpy(), w_, err_msg=name,
                                   **tol)
    lens = disp.expert_lengths.tolist()
    for e, n in enumerate(lens):
        if n == 0:
            assert not any(t[e].any() for t in got[3:]), e


def test_fused_moe_refuses_what_it_does_not_take(dev, K):
    """A CUDA tensor of another dtype or layout raises; it is never handed
    to the plain version."""
    import torch
    F = K.fused_moe
    x, dy, g, disp, ws = _fused_inputs(dev, "bfloat16", 16, 4, 64, 32, None,
                                       seed=0)
    idx, off = disp.expert_token_indices, disp.expert_token_offsets
    tim = disp.token_index_map
    before = F.fused_moe_fwd.launches
    bad = [
        (x.half(), g, idx, off, *ws, tim),                  # float16
        (x.t().contiguous().t(), g, idx, off, *ws, tim),    # strided x
        (x, g.to(torch.bfloat16), idx, off, *ws, tim),      # bf16 gates
        (x, g, idx.long(), off, *ws, tim),                  # int64 ids
        (x, g, idx, off, ws[0].float(), ws[1], ws[2], tim),  # mixed dtypes
        (x, g, idx, off, ws[0], ws[1], ws[0], tim),         # w3 shape
        (x, g, idx, off[:-1], *ws, tim),                    # offsets
        (x, g, idx, off, *ws),                              # no token map
        (x, g, idx, off, *ws, tim.long()),                  # int64 map
        (x, g, idx, off, *ws, tim[:-1])]                    # map rows
    for args in bad:
        with pytest.raises(ValueError):
            F.fused_moe_fwd(*args)
    with pytest.raises(ValueError):
        F.fused_moe_bwd(x, dy.float(), g, idx, off, *ws, tim)
    assert F.fused_moe_fwd.launches == before


@pytest.mark.parametrize("backend,residuals", [
    ("pallas", "ab_yswi"), ("pallas", "ab"), ("pallas", "x"),
    ("pallas_fused", "ab_yswi"), ("ragged", "ab_yswi")])
def test_moe_ffn_blaze_on_card_matches_plain_autograd(dev, K, backend,
                                                      residuals):
    """``moe_ffn_blaze`` on the card (its kernels, or ``torch._grouped_mm``
    on ``ragged``) against autograd through the plain versions on the same
    tensors, float32, E=8, top-2, widths 256 -> 512."""
    import torch
    L, d, h, E, k = 512, 256, 512, 8, 2
    rng = np.random.default_rng(11)
    disp = K.routing.build_dispatch(_t(_topk(L, E, k, seed=11), dev), E)
    make = lambda *shape, s=1.0: _t(rng.normal(size=shape) * s, dev,
                                    "float32").requires_grad_()
    x, w1, w2 = make(L, d), make(E, d, h, s=0.1), make(E, d, h, s=0.1)
    w3 = make(E, h, d, s=0.1)
    gates = _t(rng.uniform(size=(L, k)), dev, "float32").requires_grad_()
    dy = _t(rng.normal(size=(L, d)), dev, "float32")
    ins = (x, gates, w1, w3, w2)
    counts = lambda: (K.gather_gmm.gather_gmm.launches,
                      K.fused_moe.fused_moe_fwd.launches,
                      K.fused_moe.fused_moe_bwd.launches)
    before = counts()
    y = K.moe_layer.moe_ffn_blaze(x, gates, disp, w1, w3, w2,
                                  residuals=residuals, backend=backend)
    got = [y] + list(torch.autograd.grad(y, ins, dy))
    y_p = _plain_layer(K, x, gates, disp, w1, w3, w2)
    want = [y_p] + list(torch.autograd.grad(y_p, ins, dy))
    _sync()
    after = counts()
    if backend == "pallas_fused":
        assert after[1:] == (before[1] + 1, before[2] + 1)
    elif backend == "ragged":      # torch._grouped_mm: no kernel of the port
        assert after == before
    else:
        assert after[0] > before[0] and after[1:] == before[1:]
    for name, g_, w_ in zip(("y", "dx", "dgates", "dw1", "dw3", "dw2"),
                            got, want):
        w_ = w_.detach().float().cpu().numpy()
        np.testing.assert_allclose(
            g_.detach().float().cpu().numpy(), w_, rtol=1e-4,
            atol=1e-4 * float(np.abs(w_).max()), err_msg=name)


def _scale_close(name, got, want, dtype):
    want = want.float()
    scale = float(want.abs().max()) if want.numel() else 0.0
    if dtype == "bfloat16":
        tol = dict(rtol=0.0, atol=2 ** -7 * scale + 1e-2)
    else:
        tol = dict(rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.cpu().numpy(), err_msg=name, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,d,h", [
    (256, 256, 512),     # whole tiles
    (4, 512, 1000),      # decode rows; h not a multiple of the tile
    (300, 320, 520),     # ragged rows and d
    (37, 100, 140),      # widths not a multiple of 8 (general path)
    (0, 64, 128),        # no rows: zero weight gradients
    (1, 5120, 17408),    # Qwen3-14B decode rows: the split plan
    (4, 5120, 17408),
    (64, 5120, 17408),   # the second consumer warpgroup without rows
    (65, 5120, 17408),   # one row for it
    (129, 5120, 17408),  # a second row tile of one row
    (4, 0, 128)])        # no contraction: zeros
def test_fused_swiglu_kernels(dev, K, dtype, L, d, h):
    import torch
    rng = np.random.default_rng(L + d + h)
    x = _t(rng.normal(size=(L, d)), dev, dtype)
    w1, w2 = (_t(rng.normal(size=(d, h)) * max(d, 1) ** -0.5, dev, dtype)
              for _ in range(2))
    dy = _t(rng.normal(size=(L, h)), dev, dtype)
    FS = K.fused_swiglu
    before = [f.launches for f in (FS.fused_swiglu_fwd,
                                   FS.fused_swiglu_bwd_x,
                                   FS.fused_swiglu_bwd_w)]
    got = FS.fused_swiglu_fwd(x, w1, w2)
    want = FS.fused_swiglu_fwd_plain(x, w1, w2)
    for name, g_, w_ in zip(("y", "a", "b"), got, want):
        assert g_.dtype == x.dtype and g_.shape == (L, h)
        _scale_close(name, g_, w_, dtype)
    # the split plan sums its pieces in a fixed order: a second call gives
    # the same bits
    for g_, again in zip(got, FS.fused_swiglu_fwd(x, w1, w2)):
        assert torch.equal(g_, again)
    _, a, b = got
    dx = FS.fused_swiglu_bwd_x(dy, a, b, w1, w2)
    _scale_close("dx", dx, FS.fused_swiglu_bwd_x_plain(dy, a, b, w1, w2),
                 dtype)
    dw = FS.fused_swiglu_bwd_w(x, dy, a, b)
    for name, g_, w_ in zip(("dw1", "dw2"), dw,
                            FS.fused_swiglu_bwd_w_plain(x, dy, a, b)):
        assert g_.dtype == x.dtype and g_.shape == (d, h)
        _scale_close(name, g_, w_, dtype)
    if L == 0:
        assert not dw[0].any() and not dw[1].any()
    _sync()
    after = [f.launches for f in (FS.fused_swiglu_fwd,
                                  FS.fused_swiglu_bwd_x,
                                  FS.fused_swiglu_bwd_w)]
    assert after == [before[0] + 2, before[1] + 1, before[2] + 1]
    assert bool(torch.isfinite(dx.float()).all())


@pytest.mark.parametrize("L,d,h", [
    (4096, 5120, 17408),   # Qwen3-14B training width
    (300, 5120, 17408),    # L not a multiple of the 128-row tile
    (256, 5000, 17408),    # d not a multiple of the 256-column tile
    (128, 512, 17400),     # h not a multiple of the 32-deep k-step
    (4, 5120, 17408)])     # decode rows: one tile, its second half empty
def test_fused_swiglu_bwd_x_wgmma(dev, K, L, d, h):
    """The wgmma/TMA ``bwd_x`` at Qwen3-14B's widths and their ragged
    edges, against its plain version (bf16 tolerance as above)."""
    import torch
    rng = np.random.default_rng(L + d + h)
    dy, a, b = (_t(rng.normal(size=(L, h)), dev, "bfloat16")
                for _ in range(3))
    w1, w2 = (_t(rng.normal(size=(d, h)) * h ** -0.5, dev, "bfloat16")
              for _ in range(2))
    FS = K.fused_swiglu
    before = FS.fused_swiglu_bwd_x.launches
    dx = FS.fused_swiglu_bwd_x(dy, a, b, w1, w2)
    _sync()
    assert FS.fused_swiglu_bwd_x.launches == before + 1
    assert dx.shape == (L, d) and dx.dtype == torch.bfloat16
    _scale_close("dx", dx, FS.fused_swiglu_bwd_x_plain(dy, a, b, w1, w2),
                 "bfloat16")


@pytest.mark.parametrize("L,d,h", [
    (4096, 5120, 17408),   # Qwen3-14B training width
    (300, 5120, 17408),    # L not a multiple of the 64-row stage
    (256, 5000, 17408),    # d not a multiple of the 256-column tile
    (128, 512, 17400),     # h not a multiple of the 64-column tile
    (4, 5120, 17408),      # decode rows: one stage, mostly zero-filled
    (33, 264, 136)])       # every edge at once, a few tiles
def test_fused_swiglu_bwd_w_wgmma(dev, K, L, d, h):
    """The wgmma/TMA ``bwd_w`` at Qwen3-14B's widths and their ragged
    edges, against its plain version (bf16 tolerance as above)."""
    import torch
    rng = np.random.default_rng(L + d + h)
    x = _t(rng.normal(size=(L, d)), dev, "bfloat16")
    dy, a, b = (_t(rng.normal(size=(L, h)), dev, "bfloat16")
                for _ in range(3))
    FS = K.fused_swiglu
    before = FS.fused_swiglu_bwd_w.launches
    dw = FS.fused_swiglu_bwd_w(x, dy, a, b)
    _sync()
    assert FS.fused_swiglu_bwd_w.launches == before + 1
    for name, g_, w_ in zip(("dw1", "dw2"), dw,
                            FS.fused_swiglu_bwd_w_plain(x, dy, a, b)):
        assert g_.shape == (d, h) and g_.dtype == torch.bfloat16
        _scale_close(name, g_, w_, "bfloat16")


def test_fused_swiglu_refuses_what_it_does_not_take(dev, K):
    import torch
    FS = K.fused_swiglu
    x = torch.zeros(8, 16, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(16, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        FS.fused_swiglu_fwd(x, w.float(), w)
    with pytest.raises(ValueError, match="bad shapes"):
        FS.fused_swiglu_fwd(x, w, w[:8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        FS.fused_swiglu_bwd_w(x, w.t(), w.t(), w.t())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        FS.fused_swiglu_fwd(x.half(), w.half(), w.half())


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2 ** -4)])
def test_swiglu_function_matches_plain_autograd(dev, K, dtype, tol):
    """``ops.swiglu`` on the card (the three kernels) against autograd
    through the plain forward: y, dx, dw1, dw2, each within ``tol`` of its
    scale (bf16 rounds da and db to bf16 where autograd keeps float32)."""
    import torch
    rng = np.random.default_rng(11)
    L, d, h = 1024, 1024, 2048

    def make(*shape, s=1.0):
        return _t(rng.normal(size=shape) * s, dev, dtype).requires_grad_()

    x, w1, w2 = make(L, d), make(d, h, s=d ** -0.5), make(d, h, s=d ** -0.5)
    dy = _t(rng.normal(size=(L, h)), dev, dtype)
    y = K.ops.swiglu(x, w1, w2)
    got = [y, *torch.autograd.grad(y, (x, w1, w2), dy)]
    y_p = K.fused_swiglu.fused_swiglu_fwd_plain(x, w1, w2)[0]
    want = [y_p, *torch.autograd.grad(y_p, (x, w1, w2), dy)]
    for name, g_, w_ in zip(("y", "dx", "dw1", "dw2"), got, want):
        w_ = w_.detach().float()
        scale = float(w_.abs().max())
        np.testing.assert_allclose(g_.detach().float().cpu().numpy(),
                                   w_.cpu().numpy(), rtol=tol,
                                   atol=tol * scale, err_msg=name)
        assert g_.dtype == x.dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (10, 0.0), (0, 5.0),
                                        (6, 5.0)])
@pytest.mark.parametrize("hkv,g,dh,ps", [(2, 2, 16, 8), (8, 5, 128, 16),
                                         (4, 8, 128, 16)],
                         ids=["small", "qwen3_heads", "qwen3_moe_heads"])
def test_paged_attention_int8_kernel(dev, K, dtype, window, cap, hkv, g, dh,
                                     ps):
    """Over int8 pools quantized on the card; the Qwen3-14B heads (40
    query heads over 8 kv heads of 128, a group of 5) and Qwen3-30B-A3B's
    (32 over 4, a group of 8); position 0 and a dead slot (table all
    trash)."""
    q, k, v, table, pos = _paged_case(dtype, dev, P=13, ps=ps, hkv=hkv, g=g,
                                      dh=dh)
    kq, ks = K.kv_quant.quantize(k)
    vq, vs = K.kv_quant.quantize(v)
    A = K.paged_attention
    before = A.paged_attention_int8.launches
    args = (q, kq, vq, ks, vs, table, pos)
    got = A.paged_attention_int8(*args, window=window, cap=cap)
    want = A.paged_attention_int8_plain(*args, window=window, cap=cap)
    _sync()
    assert A.paged_attention_int8.launches == before + 1
    _close(got, want, dtype)


def _row_ids(N, L, pad_share, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, L, size=N).astype(np.int32)
    ids[rng.random(N) < pad_share] = -1
    return ids


@pytest.mark.parametrize("dtype,L,d,N,pad_share", [
    ("bfloat16", 4096, 4096, 8192, 0.0),    # training send buffer, n = 1
    ("bfloat16", 1024, 4096, 4096, 0.5),    # a rank's buffer, n = 4
    ("float32", 33, 4100, 70, 0.3),         # width not a multiple of 4
    ("bfloat16", 40, 4100, 70, 0.3),        # 8200-byte rows: element copy
    ("bfloat16", 9, 5, 31, 0.2),
    ("float32", 7, 64, 1, 1.0),             # one pad row
    ("bfloat16", 300, 4096, 17, 0.3),       # a block with idle warps
    ("bfloat16", 50, 2048, 48, 1.0)])       # every row a pad
def test_gather_rows_kernel(dev, K, dtype, L, d, N, pad_share):
    import torch
    src = torch.randn(L, d, device=dev).to(getattr(torch, dtype))
    ids = _t(_row_ids(N, L, pad_share, seed=L + d + N), dev)
    before = K.gather_rows.gather_rows.launches
    got = K.gather_rows.gather_rows(src, ids)
    want = K.gather_rows.gather_rows_plain(src, ids)
    _sync()
    assert K.gather_rows.gather_rows.launches == before + 1
    assert got.dtype == src.dtype and got.shape == (N, d)
    assert torch.equal(got, want)
    assert bool((got[ids < 0] == 0).all())


def test_gather_rows_kernel_edges(dev, K):
    """N = 0 launches nothing; a source that is not 16-byte aligned takes
    the element copy and stays bit-equal; what the kernel does not take
    raises."""
    import torch
    f = K.gather_rows.gather_rows
    src = torch.randn(16, 64, device=dev, dtype=torch.bfloat16)
    before = f.launches
    out = f(src, torch.zeros(0, dtype=torch.int32, device=dev))
    assert out.shape == (0, 64) and f.launches == before
    buf = torch.randn(16 * 64 + 1, device=dev, dtype=torch.bfloat16)
    odd = buf[1:].view(16, 64)                 # 2 bytes past alignment
    ids = _t(_row_ids(40, 16, 0.25, seed=3), dev)
    assert torch.equal(f(odd, ids), K.gather_rows.gather_rows_plain(odd, ids))
    with pytest.raises(ValueError, match="int32"):
        f(src, ids.long())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        f(src.half(), ids)
    with pytest.raises(ValueError, match="CUDA tensor"):
        f(src, ids.cpu())


@pytest.mark.parametrize("R,G,cap", [(8192, 1, 8192), (2048, 4, 1024),
                                     (2048, 4, 128), (777, 3, 5)])
def test_a2a_pack_on_the_card(dev, R, G, cap):
    """``_a2a_pack`` on a CUDA tensor (its dispatch build on the kernel)
    gives the CPU pack's six outputs exactly: at a tight capacity the
    kernel's order within each destination decides which slots drop."""
    import torch
    from repro_torch.models.moe_block import _a2a_pack
    rng = np.random.default_rng(R + G + cap)
    ids = rng.integers(0, G + 1, size=R).astype(np.int32)   # G: trash
    got = _a2a_pack(_t(ids, dev), G, cap)
    want = _a2a_pack(torch.from_numpy(ids), G, cap)
    _sync()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lo,count", [(0, 2), (2, 2), (6, 2), (4, 4)])
def test_kernels_on_a_sliced_dispatch(dev, K, dtype, lo, count):
    """The expert-parallel ranks run the kernels on ``slice_dispatch``'s
    rotated slots: the local experts' slots first, every other slot in the
    dead zone.  Gather-GMM writes zeros there, the combine picks them up
    bit for bit, the weight gradient and the fused pair ignore the dead
    rows; each against its plain version on the same sliced inputs."""
    import torch
    x, dy, g_slot, disp, ws = _fused_inputs(dev, dtype, 100, 8, 128, 96,
                                            (0, 1, 2, 4, 5, 6, 7), seed=lo)
    loc = K.routing.slice_dispatch(disp, lo, count=count)
    idx, off = loc.expert_token_indices, loc.expert_token_offsets
    w1, w2, w3 = (w[lo:lo + count].contiguous() for w in ws)
    G = K.gather_gmm
    a = G.gather_gmm(x, idx, off, w1, w2)
    _close(a, G.gather_gmm_plain(x, idx, off, w1, w2), dtype)
    assert not a[int(off[-1]):].any()
    p = G.gather_gmm(a, None, off, w3, epilogue=False)
    gates = torch.rand(100, 2, device=dev).to(x.dtype)
    tim = loc.token_index_map
    assert torch.equal(K.combine.combine(p, tim, gates),
                       K.combine.combine_plain(p, tim, gates))
    _close(K.gmm_dw.gmm_dw(x[idx.long()], a, off),
           K.gmm_dw.gmm_dw_plain(x[idx.long()], a, off), dtype)
    F = K.fused_moe
    got = [F.fused_moe_fwd(x, g_slot, idx, off, w1, w2, w3, tim),
           *F.fused_moe_bwd(x, dy, g_slot, idx, off, w1, w2, w3, tim)]
    want = [F.fused_moe_fwd_plain(x, g_slot, idx, off, w1, w2, w3),
            *F.fused_moe_bwd_plain(x, dy, g_slot, idx, off, w1, w2, w3)]
    _sync()
    for name, g_, w_ in zip(("y", "dx", "dgates", "dw1", "dw2", "dw3"),
                            got, want):
        w_ = w_.cpu().numpy()
        scale = float(np.abs(w_).max())
        tol = (dict(rtol=0.0, atol=2 ** -7 * scale + 1e-2)
               if dtype == "bfloat16"
               else dict(rtol=1e-5, atol=1e-5 * scale))
        np.testing.assert_allclose(g_.cpu().numpy(), w_, err_msg=name, **tol)
    # no gate gradient in the dead zone
    assert not got[2][int(off[-1]):].any()


def test_train_step_microbatches_match_on_card(dev):
    """``make_train_step`` with two microbatches against one, on the card
    at a reduced width of Qwen3-30B-A3B (2 layers, d=512, top-8 of 32
    experts, bf16 compute on ``blaze_pallas``), from the same float32
    weights and batch, without the load-balance loss (estimated per
    microbatch, so not invariant): loss and cross entropy 1e-5 relative
    (the same per-token terms summed in other groupings), grad norm 1e-2
    (each microbatch's bf16 weight gradients round before the float32
    sum); the expert kernels run twice as often."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.interop import init_params
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import init_adamw
    cfg = get_config("qwen3-moe-30b-a3b").replace(
        num_layers=2, d_model=512, num_heads=8, num_kv_heads=1,
        num_experts=32, moe_d_ff=256, vocab_size=4096, aux_loss_weight=0.0,
        moe_impl="blaze_pallas", use_pallas=True)
    batch = next(make_batch_iterator(cfg.vocab_size, 256, 4, 0))
    out = {}
    for M in (1, 2):
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev, dtype=torch.float32)
        step = make_train_step(cfg, TrainConfig(batch_size=4, seq_len=256,
                                                num_microbatches=M), dev)
        kernels.reset_launches()
        _, _, m = step(params, init_adamw(params), batch)
        out[M] = ({k: float(v) for k, v in m.items()},
                  kernels.launch_counts()["gather_gmm"])
    for key, rtol in (("loss", 1e-5), ("ce", 1e-5), ("grad_norm", 1e-2)):
        np.testing.assert_allclose(out[2][0][key], out[1][0][key], rtol=rtol,
                                   err_msg=key)
    assert out[2][1] == 2 * out[1][1] > 0


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_paged_kernels_over_shared_and_forked_pages(dev, K, quantized):
    """Prefix sharing maps one physical page into several page tables, and
    a copy-on-write fork copies a shared page into a private one: the
    paged kernels over such tables (rows 0-2 share pages 1-4; row 3 holds
    a fork of page 4 in page 9, then its own pages) against their plain
    versions, before and after the fork; the fork leaves page 4 as it
    was."""
    import torch

    from repro_torch.serve import paged_cache as PC
    rng = np.random.default_rng(3)
    P, ps, hkv, g, dh = 16, 16, 8, 4, 128
    pages = PC.init_paged_kv(P, ps, hkv, dh, torch.bfloat16, dev,
                             quantized=quantized)
    k = _t(rng.normal(size=(P, ps, hkv, dh)), dev, "bfloat16")
    v = _t(rng.normal(size=(P, ps, hkv, dh)), dev, "bfloat16")
    table = np.array([[1, 2, 3, 4, 5, 0], [1, 2, 3, 4, 6, 7],
                      [1, 2, 3, 4, 0, 0], [1, 2, 3, 9, 10, 0]], np.int32)
    pos = _t(np.array([70, 95, 63, 73], np.int32), dev)
    flat_p = torch.arange(P, device=dev).repeat_interleave(ps)
    flat_o = torch.arange(ps, device=dev).repeat(P)
    PC._scatter(pages, k.reshape(P * ps, hkv, dh), v.reshape(P * ps, hkv, dh),
                flat_p, flat_o)
    q = _t(rng.normal(size=(4, 1, hkv * g, dh)), dev, "bfloat16")
    A = K.paged_attention

    def both(tab):
        tab = _t(tab, dev)
        if quantized:
            args = (q, pages.k, pages.v, pages.k_scale, pages.v_scale, tab,
                    pos)
            got = A.paged_attention_int8(*args)
            want = A.paged_attention_int8_plain(*args)
        else:
            args = (q, pages.k, pages.v, tab, pos)
            got = A.paged_attention(*args)
            want = A.paged_attention_plain(*args)
        _close(got, want, "bfloat16")
        return got

    both(table)
    shared = [a[4].clone() for a in pages if a is not None]
    PC.copy_page(pages, 4, 9)
    _sync()
    assert all(_equal(a[4], b) for a, b in
               zip([a for a in pages if a is not None], shared))
    assert all(_equal(a[4], a[9]) for a in pages if a is not None)
    forked = table.copy()
    forked[3] = [1, 2, 3, 9, 10, 0]
    out = both(forked)
    # row 3 reads the fork's copy of page 4: the same values as row 3 of a
    # table that maps page 4 itself
    forked[3, 3] = 4
    ref = both(forked)
    assert _equal(out[3], ref[3])


def test_sampling_noise_bit_equal_on_cpu_and_card(dev):
    """The sampler's counter-based hash of each row key and vocabulary
    index, and its Gumbel noise, give the same bits on the CPU and the
    card, and so the same tokens."""
    import torch

    from repro_torch.serve import sampling as SM
    V = 32000
    rid = torch.tensor([0, 1, 7, 70000, 2 ** 31 - 1], dtype=torch.int32)
    gidx = torch.tensor([0, 3, 15, 1023, 0], dtype=torch.int32)
    for seed in (0, 11, 2 ** 40 + 5):
        keys = torch.from_numpy(SM.row_keys(seed, rid.numpy(), gidx.numpy()))
        assert _equal(SM.uniform_bits(keys, V),
                      SM.uniform_bits(keys.to(dev), V).cpu())
        n_cpu = SM.gumbel_noise(seed, rid, gidx, V)
        n_dev = SM.gumbel_noise(seed, rid.to(dev), gidx.to(dev), V)
        assert _equal(n_cpu, n_dev.cpu())
        logits = torch.from_numpy(np.random.default_rng(seed % 97).normal(
            size=(5, V)).astype(np.float32))
        for temp in (0.8, 1.0, 1.7):
            assert _equal(SM.sample(logits, n_cpu, temp),
                          SM.sample(logits.to(dev), n_dev, temp).cpu())


@pytest.mark.parametrize("L,E,k,d,h,dtype", [
    pytest.param(4096, 8, 2, 4096, 14336, "bfloat16", id="mixtral-training"),
    pytest.param(4096, 128, 8, 2048, 768, "bfloat16",
                 id="qwen3-moe-training"),
    # the general path (float32, and bf16 with d off the multiple of 8)
    pytest.param(1024, 8, 2, 1024, 2048, "float32", id="general-float32"),
    pytest.param(1024, 8, 2, 1020, 2048, "bfloat16",
                 id="general-bf16-d1020")])
def test_fused_moe_repeats_bit_equal(dev, K, L, E, k, d, h, dtype):
    """The fused MoE forward's y and the backward's outputs are bit-equal
    across repeated calls at Mixtral-8x7B's training shape (2 x 2048
    tokens, 8192 slots, seven forward h-ranges) and Qwen3-30B-A3B's
    (32,768 slots over 128 experts, top-8), and on the general path
    (float32, and bf16 with d = 1020): every output element has one
    writer (a per-slot buffer summed over each token's slots in a fixed
    order, weight-gradient tiles that walk their expert's rows), so the
    recompute inside a checkpoint region sees the forward's bits; y
    against the plain version at its dtype's tolerance, and on the
    general path every output."""
    import torch
    F = K.fused_moe
    gen = torch.Generator(device=dev).manual_seed(L + E)
    topk = (torch.rand(L, E, generator=gen, device=dev).argsort(1)[:, :k]
            .to(torch.int32).contiguous())
    disp = K.routing.build_dispatch(topk, E)
    S = disp.num_slots
    dt = dict(device=dev, dtype=getattr(torch, dtype))
    x, dy = (torch.randn(L, d, generator=gen, device=dev).to(dt["dtype"])
             for _ in range(2))
    w1, w2 = ((torch.randn(E, d, h, generator=gen, device=dev)
               * d ** -0.5).to(**dt) for _ in range(2))
    w3 = (torch.randn(E, h, d, generator=gen, device=dev)
          * h ** -0.5).to(**dt)
    general = not F.tensor_core_path(x, (w1, w2, w3), dy)
    assert general == (dtype == "float32" or d % 8 != 0)
    g = torch.rand(S, generator=gen, device=dev)
    idx, off = disp.expert_token_indices, disp.expert_token_offsets
    tim = disp.token_index_map
    y = F.fused_moe_fwd(x, g, idx, off, w1, w2, w3, tim)
    for call in range(2):
        assert _equal(F.fused_moe_fwd(x, g, idx, off, w1, w2, w3, tim), y)
    _scale_close("y", y, F.fused_moe_fwd_plain(x, g, idx, off, w1, w2, w3),
                 dtype)
    outs = F.fused_moe_bwd(x, dy, g, idx, off, w1, w2, w3, tim)
    again = F.fused_moe_bwd(x, dy, g, idx, off, w1, w2, w3, tim)
    for name, a, b in zip(("dx", "dgates", "dw1", "dw2", "dw3"), outs, again):
        assert _equal(a, b), name
    if general:
        want = F.fused_moe_bwd_plain(x, dy, g, idx, off, w1, w2, w3)
        for name, a, b in zip(("dx", "dgates", "dw1", "dw2", "dw3"), outs,
                              want):
            _scale_close(name, a, b, dtype)
    del outs, again
    _sync()


@pytest.mark.parametrize("d,dtype", [
    pytest.param(64, "bfloat16", id="tensor-core"),
    pytest.param(64, "float32", id="general-float32"),
    pytest.param(60, "bfloat16", id="general-bf16-d60")])
def test_fused_moe_no_tokens(dev, K, d, dtype):
    """A call with no tokens (L = 0, so no slots) on either path gives
    y and dx of shape (0, d), no dgates, and weight gradients of exact
    zeros, though the allocator hands the outputs memory that last held
    NaNs."""
    import torch
    F = K.fused_moe
    E, k, h = 4, 2, 128
    dt = dict(device=dev, dtype=getattr(torch, dtype))
    x = dy = torch.empty(0, d, **dt)
    w1, w2 = (torch.randn(E, d, h, device=dev).to(**dt) for _ in range(2))
    w3 = torch.randn(E, h, d, device=dev).to(**dt)
    assert F.tensor_core_path(x, (w1, w2, w3), dy) == (
        dtype == "bfloat16" and d % 8 == 0)
    idx = torch.empty(0, dtype=torch.int32, device=dev)
    off = torch.zeros(E + 1, dtype=torch.int32, device=dev)
    tim = torch.empty(0, k, dtype=torch.int32, device=dev)
    g = torch.empty(0, device=dev)
    stale = torch.full((8 * E * d * h,), float("nan"), device=dev)
    del stale
    y = F.fused_moe_fwd(x, g, idx, off, w1, w2, w3, tim)
    dx, dg, dw1, dw2, dw3 = F.fused_moe_bwd(x, dy, g, idx, off, w1, w2, w3,
                                            tim)
    _sync()
    assert y.shape == dx.shape == (0, d) and dg.shape == (0,)
    for name, dw, w in (("dw1", dw1, w1), ("dw2", dw2, w2),
                        ("dw3", dw3, w3)):
        assert dw.shape == w.shape, name
        assert _equal(dw, torch.zeros_like(dw)), name


def test_fused_moe_refuses_tensor_cores_it_cannot_take(dev, K):
    """The wrappers choose the path (``tensor_core_path``) and size the
    workspace for it; the C entries refuse the tensor-core path for
    inputs it cannot take (float32, d off the multiple of 8) rather than
    write its bf16 chunk into a workspace sized for the other path."""
    import torch

    from repro_torch.kernels import _lib
    F = K.fused_moe
    E, k, h, L = 2, 1, 128, 16
    lib = _lib.lib()
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 60)):
        x = dy = torch.randn(L, d, device=dev).to(dtype)
        w1, w2 = (torch.randn(E, d, h, device=dev).to(dtype)
                  for _ in range(2))
        w3 = torch.randn(E, h, d, device=dev).to(dtype)
        assert not F.tensor_core_path(x, (w1, w2, w3), dy)
        idx = torch.arange(L, dtype=torch.int32, device=dev)
        off = torch.tensor([0, L // 2, L], dtype=torch.int32, device=dev)
        tim = idx.view(L, k)
        g = torch.ones(L, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        y, ys = torch.zeros(L, d, **f32), torch.zeros(L, d, **f32)
        ws = torch.empty(3, L, h, **f32)
        code = _lib.DTYPE_CODE[dtype]
        rc = lib.repro_fused_moe_fwd(
            code, 1, x.data_ptr(), g.data_ptr(), idx.data_ptr(),
            off.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
            y.data_ptr(), ws.data_ptr(), h, L, L, d, h, E, ys.data_ptr(),
            tim.data_ptr(), k, _lib.stream_ptr(x))
        assert rc != 0
        outs = [torch.empty(L, d, **f32), torch.empty(L, **f32),
                torch.empty(E, d, h, **f32), torch.empty(E, d, h, **f32),
                torch.empty(E, h, d, **f32)]
        part = torch.empty(h // F.GENERAL_H_TILE, L, **f32)
        rc = lib.repro_fused_moe_bwd(
            code, 1, x.data_ptr(), dy.data_ptr(), g.data_ptr(),
            idx.data_ptr(), off.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            w3.data_ptr(), *(t.data_ptr() for t in outs), ws.data_ptr(),
            part.data_ptr(), h, L, L, d, h, E, ys.data_ptr(),
            tim.data_ptr(), k, _lib.stream_ptr(x))
        assert rc != 0
    _sync()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh", [80, 64, 128, 16, 48, 72, 96, 112])
def test_flash_attention_bidirectional(dev, K, dtype, Dh):
    """Flash attention without the causal mask (an encoder's, HuBERT's)
    at head widths 80 (HuBERT-XLarge's), 64 and 128 and the tensor-core
    kernel's padded widths, with a GQA group of 2 and S = 300, not a
    multiple of the 128-key tile: bf16 on the tensor cores at every one
    of these widths, float32 on the general kernel."""
    rng = np.random.default_rng(Dh)
    S, H, Hkv = 300, 8, 4
    q = _t(rng.normal(size=(2, S, H, Dh)), dev, dtype)
    k, v = (_t(rng.normal(size=(2, S, Hkv, Dh)), dev, dtype)
            for _ in range(2))
    A = K.flash_attention
    got, tensor_cores = _flash_run(A, q, k, v, causal=False)
    want = A.flash_attention_plain(q, k, v, causal=False, chunk=S)
    _sync()
    assert tensor_cores == (dtype == "bfloat16")
    if dtype == "bfloat16":
        # each output averages up to 300 keys (|o| about 0.06), so each
        # element is held to 2^-5 of |o| plus its row's mean |o|, as
        # chip_smoke.py's phase 41 holds the long sequences
        _row_close(got, want)
    else:
        _close(got, want, dtype)


@pytest.mark.parametrize("B,S,window", [(2, 2048, 1024), (1, 300, 100)])
def test_flash_attention_hymba_heads(dev, K, B, S, window):
    """Flash attention at Hymba-1.5B's heads: 25 query heads over 5 KV
    heads of 64 (a GQA group of 5 on the Dh-64 instantiation), its
    1024-token window at its training length, and a short ragged case."""
    rng = np.random.default_rng(S)
    q = _t(rng.normal(size=(B, S, 25, 64)), dev, "bfloat16")
    k, v = (_t(rng.normal(size=(B, S, 5, 64)), dev, "bfloat16")
            for _ in range(2))
    A = K.flash_attention
    got = A.flash_attention(q, k, v, causal=True, window=window)
    want = A.flash_attention_plain(q, k, v, causal=True, window=window,
                                   chunk=512)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=2e-2)


@pytest.mark.parametrize("L", [4096, 300, 4, 1])
def test_fused_swiglu_hymba_widths(dev, K, L):
    """The fused SwiGLU forward, bwd_x and bwd_w at Hymba-1.5B's widths,
    d = 1600 (not a multiple of the 128-row tile: the tail path) and
    h = 5504, at the training rows, a ragged count and decode."""
    import torch
    d, h = 1600, 5504
    rng = np.random.default_rng(L)
    x = _t(rng.normal(size=(L, d)), dev, "bfloat16")
    w1, w2 = (_t(rng.normal(size=(d, h)) * d ** -0.5, dev, "bfloat16")
              for _ in range(2))
    dy = _t(rng.normal(size=(L, h)), dev, "bfloat16")
    FS = K.fused_swiglu
    got = FS.fused_swiglu_fwd(x, w1, w2)
    for name, g_, w_ in zip(("y", "a", "b"), got,
                            FS.fused_swiglu_fwd_plain(x, w1, w2)):
        _scale_close(name, g_, w_, "bfloat16")
    for g_, again in zip(got, FS.fused_swiglu_fwd(x, w1, w2)):
        assert torch.equal(g_, again)
    _, a, b = got
    _scale_close("dx", FS.fused_swiglu_bwd_x(dy, a, b, w1, w2),
                 FS.fused_swiglu_bwd_x_plain(dy, a, b, w1, w2), "bfloat16")
    for name, g_, w_ in zip(("dw1", "dw2"), FS.fused_swiglu_bwd_w(x, dy, a, b),
                            FS.fused_swiglu_bwd_w_plain(x, dy, a, b)):
        _scale_close(name, g_, w_, "bfloat16")


def test_hymba_decode_matches_forward_on_card(dev):
    """Reduced Hymba (2 layers, d = 256, window 64) in bf16 on the card:
    ``decode_step`` teacher-forced over 80 positions (past the window, so
    the rolling cache wraps) against ``forward``'s logits at the same
    positions (flash attention and the fused SwiGLU kernels in the
    forward; decode attention, the Mamba step and the fused SwiGLU
    forward at decode rows in the steps): within 0.125 (logits of size ~4
    through two bf16 layers rounded at other points), and every step's
    argmax equal to the forward's unless the forward's top two lie within
    that tolerance."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.interop import init_params
    from repro_torch.models import transformer as T
    cfg = get_config("hymba-1.5b").reduced().replace(
        dtype="bfloat16", use_pallas=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    toks = torch.randint(3, cfg.vocab_size, (2, 128),
                         generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    with torch.inference_mode():
        full, _ = T.forward(params, {"tokens": toks}, cfg)
        cache = T.init_cache(cfg, 2, 64, dev)
        for t in range(80):
            step, cache = T.decode_step(params, cache,
                                        {"tokens": toks[:, t:t + 1]}, t, cfg)
            ref = full[:, t]
            assert float((step - ref).abs().max()) <= 0.125, t
            top2 = ref.topk(2).values
            same = step.argmax(-1) == ref.argmax(-1)
            assert bool((same | (top2[:, 0] - top2[:, 1] <= 0.125)).all()), t


def test_bench_suites_on_card(dev):
    """``repro_torch.bench`` at its small sweep on the card: the kernels
    suite's fused-path gates hold and its timed paths go through the
    hand-written kernels (gather-GMM and ``gmm_dw`` under the ``pallas``
    backend, the fused pair, the fused SwiGLU forward: each count rises);
    the memory suite's simulated peaks agree with the traced ones."""
    from repro_torch import kernels as KN
    from repro_torch.bench import memory, timing
    KN.reset_launches()
    kern = timing.kernels_suite(small=True, device=dev)
    launches = KN.launch_counts()
    assert timing.fused_gate_failures(kern) == []
    for name in ("gather_gmm", "gmm_dw", "fused_moe_fwd", "fused_moe_bwd",
                 "fused_swiglu_fwd"):
        assert launches[name] > 0, (name, launches)
    mem = memory.memory_suite(small=True, device=dev)
    assert memory.sim_parity_failures(mem) == []
    assert any(e["name"].endswith("/allocated_bytes") for e in mem)
