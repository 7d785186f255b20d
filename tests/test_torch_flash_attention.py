"""Port parity: the flash-attention forward and its differentiable wrapper.

The port's plain attention (what a CPU tensor runs) against the reference's
Pallas ``flash_attention_pallas`` in interpret mode, with causal masks,
sliding windows, softcaps and grouped query heads, and at HuBERT-XLarge's
head width of 80 without the causal mask; the port's autograd
``FlashAttention`` against ``jax.vjp`` of the reference's
``flash_attention_fused`` (whose backward is autodiff through the plain
chunked attention, as the port's is); and the rule by which a CUDA call
takes the tensor-core kernel or the general one (``tensor_core_path``).

Tolerances: float32 1e-5 (the same float32 sums in another order).
bfloat16 2e-2 absolute: the port scales q in bf16 before the float32 dot
(as the reference's plain attention does) where the Pallas kernel scales
the float32 q, so scores differ by a bf16 rounding of q (2^-8 relative),
and the output rounds once more to bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.flash_attention import (flash_attention_fused,
                                           flash_attention_pallas)
from torch_parity import as_dtype, f32, to_torch, tp  # noqa: F401

B, S, DH = 2, 256, 16
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=0.0, atol=2e-2)}
# (heads, kv heads, causal, window, softcap)
CASES = {
    "causal": (4, 4, True, 0, 0.0),
    "gqa4_window": (8, 2, True, 100, 0.0),
    "softcap": (4, 2, True, 0, 5.0),
    "window_softcap": (4, 1, True, 64, 20.0),
    "bidirectional": (4, 2, False, 0, 0.0),
}


def _qkv(dtype, H, Hkv, seed=0):
    rng = np.random.default_rng(seed)
    return (as_dtype(rng.normal(size=(B, S, H, DH)), dtype),
            as_dtype(rng.normal(size=(B, S, Hkv, DH)), dtype),
            as_dtype(rng.normal(size=(B, S, Hkv, DH)), dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_pallas(tp, dtype, case):
    H, Hkv, causal, window, cap = CASES[case]
    q, k, v = _qkv(dtype, H, Hkv)
    ref = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 window=window, cap=cap, interpret=True)
    out = tp.flash_attention.flash_attention(
        to_torch(q), to_torch(k), to_torch(v), causal=causal, window=window,
        cap=cap)
    assert out.dtype == tp.dtype[dtype] and tuple(out.shape) == q.shape
    np.testing.assert_allclose(f32(out), f32(ref), **TOL[dtype])


@pytest.mark.parametrize("case", ["causal", "gqa4_window", "window_softcap"])
def test_flash_attention_grads_match_reference(tp, case):
    H, Hkv, causal, window, cap = CASES[case]
    q, k, v = _qkv("float32", H, Hkv, seed=1)
    do = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    y_ref, vjp = jax.vjp(
        lambda q_, k_, v_: flash_attention_fused(q_, k_, v_, causal, window,
                                                 cap),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_ref = vjp(jnp.asarray(do))
    tq, tk, tv = (to_torch(a).requires_grad_() for a in (q, k, v))
    y = tp.flash_attention.flash_attention_fused(tq, tk, tv, causal, window,
                                                 cap)
    y.backward(to_torch(do))
    np.testing.assert_allclose(f32(y), f32(y_ref), **TOL["float32"])
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad),
                               grads_ref):
        np.testing.assert_allclose(
            f32(got), f32(want), rtol=1e-5,
            atol=1e-5 * float(np.abs(f32(want)).max()), err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_hubert_heads_match_pallas(tp, dtype):
    """HuBERT-XLarge's attention cut to a few heads: 4/4 heads of 80 (the
    width its card calls take through the tensor cores padded to 128),
    ``causal=False``, S = 128."""
    rng = np.random.default_rng(80)
    q, k, v = (as_dtype(rng.normal(size=(2, 128, 4, 80)), dtype)
               for _ in range(3))
    ref = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=False,
                                 interpret=True)
    out = tp.flash_attention.flash_attention(to_torch(q), to_torch(k),
                                             to_torch(v), causal=False)
    assert out.dtype == tp.dtype[dtype] and tuple(out.shape) == q.shape
    np.testing.assert_allclose(f32(out), f32(ref), **TOL[dtype])


PATH_WIDTHS = (8, 16, 48, 64, 72, 80, 96, 112, 128, 100, 160, 256)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("Dh", PATH_WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_core_path_rule(tp, dtype, Dh, aligned):
    """The tensor cores take bf16 at a head width that is a multiple of 8
    up to 128 with q, k and v on 16 bytes; everything else (float32, other
    widths, a tensor one element off its allocation's start) takes the
    general kernel.  The misaligned tensor is q, k or v by turns."""
    torch = tp.torch
    dt = tp.dtype[dtype]
    shapes = {"q": (1, 3, 4, Dh), "k": (1, 3, 2, Dh), "v": (1, 3, 2, Dh)}
    off = "qkv"[PATH_WIDTHS.index(Dh) % 3]
    ts = {}
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        shift = 0 if aligned or name != off else 1
        ts[name] = torch.zeros(n + 1, dtype=dt)[shift:shift + n].view(shape)
        assert ts[name].is_contiguous()
        assert (ts[name].data_ptr() % 16 == 0) == (aligned or name != off)
    want = dtype == "bfloat16" and Dh % 8 == 0 and Dh <= 128 and aligned
    assert tp.flash_attention.tensor_core_path(ts["q"], ts["k"],
                                               ts["v"]) == want
