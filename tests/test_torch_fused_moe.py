"""Port parity: the fused dispatch→GEMM→combine kernel pair.

The plain versions of ``fused_moe_fwd`` / ``fused_moe_bwd`` (what a CPU
tensor takes, and the yardstick the CUDA kernels are held to on the card)
against the reference's Pallas kernels in interpret mode, on the same
inputs: an expert left empty, and a slot count that is not a multiple of
the reference's row tile.  The bf16 kernels' h-range plans (pure Python:
ranges that cover h in multiples of the tile, a workspace within its cap,
one range at decode) and their pass decompositions, in plain PyTorch,
against the same reference kernels.  Then the ``MoEBlazeFused`` autograd
Function against ``jax.vjp`` of the reference's ``moe_ffn_blaze_fused``.

Tolerances: float32 1e-5 relative over 1e-5 of each output's scale (the
same products, summed in another order); bfloat16 one bf16 step (2^-7) of
the scale: both sides round ``y_swi`` and ``dyu`` at the same points, but a
float32 sum in another order can round one element to the neighbouring
bf16 value.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import routing as R
from repro.kernels.gather_gmm import fused_moe_bwd as j_bwd
from repro.kernels.gather_gmm import fused_moe_fwd as j_fwd
from repro.kernels.ops import moe_ffn_blaze_fused as j_layer
from torch_parity import as_dtype, f32, to_torch
from torch_parity import tp  # noqa: F401

D, H, E, K = 64, 128, 8, 2


def _tol(dtype, want):
    scale = float(np.abs(want).max())
    if dtype == "bfloat16":
        return dict(rtol=0.0, atol=2 ** -7 * scale)
    return dict(rtol=1e-5, atol=1e-5 * scale)


def _inputs(L, dtype, empty=None, seed=0, h=H):
    rng = np.random.default_rng(seed)
    x = as_dtype(rng.normal(size=(L, D)), dtype)
    w1, w2 = (as_dtype(rng.normal(size=(E, D, h)) * 0.15, dtype)
              for _ in range(2))
    w3 = as_dtype(rng.normal(size=(E, h, D)) * 0.1, dtype)
    scores = rng.normal(size=(L, E)).astype(np.float32)
    if empty is not None:
        scores[:, empty] -= 100.0
    topk = np.argsort(-scores, axis=1)[:, :K].astype(np.int32)
    g = np.exp(np.take_along_axis(scores, topk, 1))
    gates = (g / g.sum(1, keepdims=True)).astype(np.float32)
    dy = as_dtype(rng.normal(size=(L, D)), dtype)
    return x, w1, w2, w3, topk, gates, dy


def _slot_inputs(topk, gates):
    d = R.build_dispatch(jnp.asarray(topk), E)
    S = topk.size
    g_slot = np.zeros(S, np.float32)
    g_slot[np.asarray(d.token_index_map).reshape(-1)] = gates.reshape(-1)
    return (g_slot, np.asarray(d.expert_token_indices),
            np.asarray(d.expert_token_offsets))


CASES = [pytest.param(64, None, 128, id="L64"),
         pytest.param(64, 5, 128, id="L64-empty-expert"),
         pytest.param(50, None, 32, id="S100-ragged-tile")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,empty,bl", CASES)
def test_plain_fused_pair_matches_reference_kernels(tp, L, empty, bl, dtype):
    from repro_torch.kernels import fused_moe as FM
    x, w1, w2, w3, topk, gates, dy = _inputs(L, dtype, empty)
    g_slot, idx, off = _slot_inputs(topk, gates)
    j_args = [jnp.asarray(a) for a in (g_slot, idx, off, w1, w2, w3)]
    t_args = [to_torch(a) for a in (g_slot, idx, off, w1, w2, w3)]
    want = f32(j_fwd(jnp.asarray(x), *j_args, bl=bl))
    got = FM.fused_moe_fwd(to_torch(x), *t_args)
    assert got.dtype == tp.torch.float32
    np.testing.assert_allclose(f32(got), want, **_tol(dtype, want))

    wants = j_bwd(jnp.asarray(x), jnp.asarray(dy), *j_args, bl=bl)
    gots = FM.fused_moe_bwd(to_torch(x), to_torch(dy), *t_args)
    for name, g, w in zip(("dx", "dgates", "dw1", "dw2", "dw3"), gots,
                          wants):
        w = f32(w)
        assert g.dtype == tp.torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(f32(g), w, **_tol(dtype, w), err_msg=name)
    if empty is not None:
        for g in gots[2:]:
            assert not g[empty].any(), "the empty expert's dw must be zero"


@pytest.mark.parametrize("S,h,n_ranges", [
    pytest.param(8192, 14336, 7, id="mixtral-training"),  # 7 of 2048
    pytest.param(8192, 14400, 8, id="ragged-last-64"),
    pytest.param(4096, 17408, 5, id="ragged-last-1024"),  # 4096 wide
    pytest.param(100, 200, 1, id="one-ragged-range"),
    # above the cap's slot count (131,072): one tile wide
    pytest.param(140000, 1000, 8, id="above-cap-slots"),
    pytest.param(1, 8, 1, id="one-slot")])
def test_h_ranges_cover_h_in_tiles(tp, S, h, n_ranges):
    from repro_torch.kernels import fused_moe as FM
    hc = FM.pass_width(S, h)
    ranges = FM.h_ranges(h, hc)
    assert hc % FM.H_TILE == 0 and hc > 0
    assert len(ranges) == n_ranges
    assert [h0 for h0, _ in ranges] == list(range(0, h, hc))
    assert all(w == hc for _, w in ranges[:-1])
    assert 0 < ranges[-1][1] <= hc
    assert sum(w for _, w in ranges) == h


def test_pass_width_keeps_the_chunk_within_its_cap(tp):
    """Every slot count from 1 to 65,536, at Mixtral's and Qwen3-14B's
    expert widths; at Mixtral's training shape the chunk is exactly the
    cap (S = 8192, hc = 2048)."""
    from repro_torch.kernels import fused_moe as FM
    cap = FM.CHUNK_CAP_BYTES
    assert cap == 32 * 2 ** 20
    for h in (14336, 17408):
        widths = [FM.pass_width(S, h) for S in range(1, 65537)]
        assert all(S * hc * 2 <= cap for S, hc in enumerate(widths, 1))
        assert all(hc % FM.H_TILE == 0 for hc in widths)
    assert FM.pass_width(8192, 14336) * 8192 * 2 == cap


@pytest.mark.parametrize("h", [14336, 17408, 200])
@pytest.mark.parametrize("S", [1, 4, 8, 64, 256])
def test_one_range_at_decode(tp, S, h):
    from repro_torch.kernels import fused_moe as FM
    assert FM.h_ranges(h, FM.pass_width(S, h)) == [(0, h)]


H_RAGGED = 200   # two ranges of the 128-wide tile: 128 and a ragged 72


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,empty,bl", CASES)
def test_pass_decomposition_matches_reference_kernel(tp, L, empty, bl,
                                                     dtype):
    """The bf16 kernel's passes (rounded y_swi chunk of each h-range, then
    its gated combine), in plain PyTorch, against the reference's fused
    forward in interpret mode, at h not a multiple of the range width."""
    from repro_torch.kernels import fused_moe as FM
    x, w1, w2, w3, topk, gates, _ = _inputs(L, dtype, empty, h=H_RAGGED)
    g_slot, idx, off = _slot_inputs(topk, gates)
    j_args = [jnp.asarray(a) for a in (g_slot, idx, off, w1, w2, w3)]
    want = f32(j_fwd(jnp.asarray(x), *j_args, bl=bl))
    assert [w for _, w in FM.h_ranges(H_RAGGED, FM.H_TILE)] == [128, 72]
    got = FM.fused_moe_fwd_passes_plain(
        to_torch(x), *(to_torch(a) for a in (g_slot, idx, off, w1, w2, w3)),
        hc=FM.H_TILE)
    assert got.dtype == tp.torch.float32
    np.testing.assert_allclose(f32(got), want, **_tol(dtype, want))


def test_bwd_pass_width_keeps_the_workspace_within_its_cap(tp):
    """The backward's three bf16 (S, hc) chunks stay within their cap for
    every slot count from 1 to 65,536 at Mixtral's and Qwen3-14B's expert
    widths; Mixtral's training shape (S = 8192) takes 12 ranges of 1280."""
    from repro_torch.kernels import fused_moe as FM
    cap = FM.BWD_CHUNK_CAP_BYTES
    assert cap == 64 * 2 ** 20
    for h in (14336, 17408):
        widths = [FM.bwd_pass_width(S, h) for S in range(1, 65537)]
        assert all(3 * S * hc * 2 <= cap for S, hc in enumerate(widths, 1))
        assert all(hc % FM.H_TILE == 0 for hc in widths)
    hc = FM.bwd_pass_width(8192, 14336)
    assert hc == 1280 and len(FM.h_ranges(14336, hc)) == 12


@pytest.mark.parametrize("h", [14336, 17408, 200])
@pytest.mark.parametrize("S", [1, 4, 8, 64, 256])
def test_bwd_one_range_at_decode(tp, S, h):
    from repro_torch.kernels import fused_moe as FM
    assert FM.h_ranges(h, FM.bwd_pass_width(S, h)) == [(0, h)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,empty,bl", CASES)
def test_bwd_pass_decomposition_matches_reference_kernel(tp, L, empty, bl,
                                                         dtype):
    """The bf16 backward's passes (per h-range: da, db and g y_swi rounded
    to the I/O dtype, the range's weight-gradient blocks, its dx products
    and its dgates partial), in plain PyTorch, against the reference's
    fused backward in interpret mode, at h not a multiple of the range
    width.  bf16: the reference keeps da, db and g y_swi in float32, so
    the rounding of the tensor-core operands stays within one bf16 step of
    each output's scale (the tolerance of the other bf16 comparisons)."""
    from repro_torch.kernels import fused_moe as FM
    x, w1, w2, w3, topk, gates, dy = _inputs(L, dtype, empty, h=H_RAGGED)
    g_slot, idx, off = _slot_inputs(topk, gates)
    j_args = [jnp.asarray(a) for a in (g_slot, idx, off, w1, w2, w3)]
    wants = j_bwd(jnp.asarray(x), jnp.asarray(dy), *j_args, bl=bl)
    gots = FM.fused_moe_bwd_passes_plain(
        to_torch(x), to_torch(dy),
        *(to_torch(a) for a in (g_slot, idx, off, w1, w2, w3)),
        hc=FM.H_TILE)
    for name, g, w in zip(("dx", "dgates", "dw1", "dw2", "dw3"), gots,
                          wants):
        w = f32(w)
        assert g.dtype == tp.torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(f32(g), w, **_tol(dtype, w), err_msg=name)
    if empty is not None:
        for g in gots[2:]:
            assert not g[empty].any(), "the empty expert's dw must be zero"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_layer_function_matches_reference(tp, dtype):
    """``moe_ffn_blaze_fused``: output in x's dtype, and the gradients of
    x, the (L, k) gates and the three weights."""
    import jax
    x, w1, w2, w3, topk, gates, dy = _inputs(64, dtype, empty=2, seed=1)
    gates = as_dtype(gates, dtype)
    jd = R.build_dispatch(jnp.asarray(topk), E)
    y_ref, vjp = jax.vjp(
        lambda x_, g_, a_, b_, c_: j_layer(x_, g_, jd, a_, c_, b_),
        *(jnp.asarray(a) for a in (x, gates, w1, w2, w3)))
    grads_ref = vjp(jnp.asarray(dy))
    td = tp.routing.build_dispatch(to_torch(topk), E)
    tx, tg, t1, t2, t3 = (to_torch(a).requires_grad_()
                          for a in (x, gates, w1, w2, w3))
    y = tp.ops.moe_ffn_blaze_fused(tx, tg, td, t1, t3, t2)
    assert y.dtype == tx.dtype
    y.backward(to_torch(dy))
    want = f32(y_ref)
    np.testing.assert_allclose(f32(y), want, **_tol(dtype, want))
    for name, t, r in zip(("x", "gates", "w1", "w2", "w3"),
                          (tx, tg, t1, t2, t3), grads_ref):
        want = f32(r)
        assert t.grad.dtype == t.dtype, name
        np.testing.assert_allclose(f32(t.grad), want, **_tol(dtype, want),
                                   err_msg=f"d{name}")


def _per_expert_pair(torch, x, dy, g_slot, idx, offsets, w1, w2, w3):
    """The pair one expert at a time (the products of each expert's own
    slots, as the kernels compute them), for the batched plain versions to
    be held to."""
    from repro_torch.kernels.fused_moe import _dsilu, _expert_rows, _round
    S, f = idx.shape[0], torch.float32
    y, dx = torch.zeros(x.shape, dtype=f), torch.zeros(x.shape, dtype=f)
    dg = torch.zeros(S, dtype=f)
    dws = [torch.zeros(w.shape, dtype=f) for w in (w1, w2, w3)]
    for e, lo, hi in _expert_rows(offsets, S):
        rows = idx[lo:hi].long()
        xe, dye, g = x[rows].float(), dy[rows].float(), g_slot[lo:hi, None]
        a, b = xe @ w1[e].float(), xe @ w2[e].float()
        sa = torch.nn.functional.silu(a)
        y_swi = _round(sa * b, x.dtype)
        y.index_add_(0, rows, g * (y_swi @ w3[e].float()))
        dyu = _round(dye @ w3[e].float().T, x.dtype)
        da, db = dyu * g * b * _dsilu(a), dyu * g * sa
        dg[lo:hi] = (y_swi * dyu).sum(-1)
        dws[0][e], dws[1][e] = xe.T @ da, xe.T @ db
        dws[2][e] = (y_swi * g).T @ dye
        dx.index_add_(0, rows, da @ w1[e].float().T + db @ w2[e].float().T)
    return y, (dx, dg, *dws)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["balanced", "empty experts",
                                  "all on one expert", "dead slots"])
def test_plain_pair_batches_the_experts(tp, case, dtype):
    """The plain pair runs every expert in one batched product a weight
    (3 products forward, 8 backward, whatever E; no per-expert product),
    over each expert's slots padded to the largest group, and gives what
    the pair computed one expert at a time gives, to 1e-5 of each
    output's scale: empty experts, every slot on one expert, and slots
    past offsets[E] (no expert's, so they add nothing)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels import fused_moe as F
    torch = tp.torch
    L = 48
    x, w1, w2, w3, topk, gates, dy = _inputs(L, dtype, empty=(
        [1, 5] if case == "empty experts" else None))
    if case == "all on one expert":
        topk = np.stack([np.full(L, 3), np.full(L, 6)], 1).astype(np.int32)
    x, w1, w2, w3, dy = (to_torch(a) for a in (x, w1, w2, w3, dy))
    disp = tp.routing.build_dispatch(torch.as_tensor(topk), E)
    idx, off = disp.expert_token_indices, disp.expert_token_offsets
    if case == "dead slots":       # the last 20 slots belong to no expert
        off = torch.clamp(off, max=idx.shape[0] - 20)
    g_slot = torch.rand(idx.shape[0], generator=torch.Generator()
                        .manual_seed(1))

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in ("mm", "bmm", "addmm", "matmul"):
                self.n[name] = self.n.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    with Products() as fwd_n:
        y = F.fused_moe_fwd_plain(x, g_slot, idx, off, w1, w2, w3)
    with Products() as bwd_n:
        grads = F.fused_moe_bwd_plain(x, dy, g_slot, idx, off, w1, w2, w3)
    assert fwd_n.n == {"bmm": 3} and bwd_n.n == {"bmm": 8}
    want_y, want_g = _per_expert_pair(torch, x, dy, g_slot, idx, off, w1,
                                      w2, w3)
    for got, want in zip((y, *grads), (want_y, *want_g)):
        want = f32(want)
        np.testing.assert_allclose(f32(got), want, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-30))
