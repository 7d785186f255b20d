"""Port parity: the ``ep_a2a`` bookkeeping, its capacity arithmetic and the
sharding rules, none of which needs a process group.

- ``_a2a_pack`` against the reference's (pure jnp, runs without a mesh):
  all six outputs equal, with ample and with tight capacity (which slots
  a tight capacity drops depends on the order inside each group).
- ``_a2a_capacity`` / ``_a2a_rows`` / ``_a2a_hier_rows`` against
  ``repro.core.memsim``.
- ``param_specs`` / ``batch_specs`` against ``repro.sharding`` on the
  reference test's MoE config (``tests/test_sharding.py:27-30``) over a
  (2, 2) and a (1, 2, 2) mesh.  The port's layer leaves have no stacked
  group dimension, so each is held to the reference's spec without its
  leading ``None``.
"""

import jax
import numpy as np
import pytest

from repro import sharding as JS
from repro.configs import get_config
from repro.core import memsim as JM
from repro.launch import specs as JSP
from repro.launch.mesh import make_debug_mesh as j_debug_mesh
from repro.launch.mesh import make_node_mesh as j_node_mesh
from repro.models.moe_block import _a2a_pack as j_a2a_pack
from torch_parity import to_torch, torch_config
from torch_parity import tp  # noqa: F401

MOE_CFG = get_config("mixtral_8x7b").reduced().replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    num_experts=4, top_k=2, moe_d_ff=64, vocab_size=128, sliding_window=16,
    attn_chunk=16)


@pytest.mark.parametrize("R,G,C", [(37, 4, 37), (37, 4, 3), (64, 2, 20),
                                   (9, 3, 1), (50, 4, 12)])
def test_a2a_pack_matches_reference(tp, R, G, C):
    from repro_torch.models.moe_block import _a2a_pack
    rng = np.random.default_rng(R * G + C)
    ids = rng.integers(0, G + 1, size=R).astype(np.int32)   # G = trash
    want = j_a2a_pack(jax.numpy.asarray(ids), G, C)
    got = _a2a_pack(to_torch(ids), G, C)
    names = ("src_of_slot", "slot_ok", "buf_idx", "valid", "sent",
             "dropped")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    counts = np.bincount(ids, minlength=G + 1)[:G]
    assert int(got[5]) == int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("capacity,chunks", [(2.0, 1), (0.25, 1), (1.3, 2),
                                             (8.0, 3)])
def test_capacity_arithmetic_matches_reference(capacity, chunks):
    from repro_torch.core import memsim as PM
    jcfg = MOE_CFG.replace(moe_a2a_capacity=capacity, moe_a2a_chunks=chunks)
    cfg = torch_config(jcfg)
    for slots in (1, 7, 64, 8192):
        for n in (1, 2, 3, 4, 8):
            for clamp in (None, 5, 100):
                assert PM._a2a_capacity(cfg, slots, n, clamp) == \
                    JM._a2a_capacity(jcfg, slots, n, clamp)
    for tokens in (1, 64, 4096):
        for n in (1, 2, 4):
            assert PM._a2a_rows(cfg, tokens, n) == JM._a2a_rows(jcfg,
                                                                tokens, n)
            assert PM._a2a_hier_rows(cfg, tokens, 2, n) == \
                JM._a2a_hier_rows(jcfg, tokens, 2, n)


class _FakeMesh:
    def __init__(self, jmesh):
        self.axis_names = tuple(jmesh.axis_names)
        self.shape = dict(jmesh.shape)


@pytest.mark.parametrize("mesh", ["flat", "node"])
@pytest.mark.parametrize("moe_parallel", ["auto", "ep", "tp"])
@pytest.mark.parametrize("fsdp", [True, False])
def test_specs_match_reference(tp, mesh, moe_parallel, fsdp):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 host devices")
    from repro_torch import sharding as SH
    from repro_torch.interop import init_params
    jmesh = j_debug_mesh(2, 2) if mesh == "flat" else j_node_mesh(1, 2, 2)
    pmesh = _FakeMesh(jmesh)
    cfg = torch_config(MOE_CFG)
    want = JS.param_specs(JSP.params_shapes(MOE_CFG), jmesh, fsdp=fsdp,
                          moe_parallel=moe_parallel)
    got = SH.param_specs(init_params(cfg, device="cpu"), pmesh, fsdp=fsdp,
                         moe_parallel=moe_parallel)
    for key in ("embed", "unembed", "final_norm"):
        assert got[key] == tuple(want[key]), key
    for i, layer in enumerate(got["layers"]):
        ref = want["layers"][i % MOE_CFG.pattern_period]

        def walk(g, w, path):
            if isinstance(g, dict):
                for k in g:
                    walk(g[k], w[k], f"{path}/{k}")
            else:
                assert g == tuple(w)[1:], path
        walk(layer, ref, f"layers/{i}")
    for b in (8, 3, 1):
        shapes = {"tokens": np.zeros((b, 32)), "labels": np.zeros((b, 32))}
        want_b = JS.batch_specs(MOE_CFG, shapes, jmesh)
        got_b = SH.batch_specs(shapes, pmesh)
        assert {k: tuple(v) for k, v in want_b.items()} == got_b, b
