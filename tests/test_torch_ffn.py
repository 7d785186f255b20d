"""Port parity: the dense FFN sublayer.

``models/ffn.py:ffn_sublayer`` against the reference's
(``repro/models/ffn.py``) on the same float32 weights and input: SwiGLU
with ``use_pallas`` on (the fused kernels' autograd Function against the
reference's Pallas custom VJP in interpret mode) and off (plain ``a``,
``b``, ``silu(a) b``), and the ``gelu`` (tanh form), ``relu`` and
``silu`` MLPs without ``w2``; the output and the gradients of the input
and of every weight.  Tolerance: 1e-5 of each output's scale (float32
sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.models.ffn import ffn_sublayer as j_ffn
from repro.models.ffn import init_ffn_params
from torch_parity import f32, to_torch, torch_config, tp  # noqa: F401

B, S = 2, 64                 # 128 rows: a whole Pallas row block
BASE = get_config("qwen3_14b").reduced()


@pytest.mark.parametrize("act,use_pallas", [
    ("swiglu", True), ("swiglu", False), ("gelu", False), ("relu", False),
    ("silu", False)])
def test_ffn_sublayer_matches_reference(tp, act, use_pallas):
    from repro_torch.models.ffn import ffn_sublayer
    jcfg = BASE.replace(ffn_act=act, use_pallas=use_pallas)
    tcfg = torch_config(jcfg)
    jp = init_ffn_params(jax.random.PRNGKey(1), jcfg, jcfg.d_model,
                         jcfg.d_ff)
    assert ("w2" in jp) == (act == "swiglu")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    dy = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda x_, p_: j_ffn(x_, p_, jcfg),
                         jnp.asarray(x), jp)
    dx_ref, dp_ref = vjp(jnp.asarray(dy))

    tx = to_torch(x).requires_grad_()
    tparams = {k: to_torch(np.asarray(v)).requires_grad_()
               for k, v in jp.items()}
    y = ffn_sublayer(tx, tparams, tcfg)
    y.backward(to_torch(dy))

    def close(got, want, name):
        want = f32(want)
        np.testing.assert_allclose(
            f32(got), want, rtol=0.0,
            atol=1e-5 * float(np.abs(want).max()), err_msg=name)

    close(y, y_ref, "y")
    close(tx.grad, dx_ref, "dx")
    for k, t in tparams.items():
        close(t.grad, dp_ref[k], f"d{k}")
