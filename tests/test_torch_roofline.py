"""Port parity: the roofline cost model behind ``moe_parallel="auto"``.

The port's ``repro_torch.roofline`` takes its device constants as a
``launch.mesh.Hardware`` record (default ``H100_SXM``).  Given the
reference's constants (read from ``repro.launch.mesh``) and a tile of 128
(the reference's lane pad), every row of ``moe_parallel_costs`` must equal
the reference's over a grid of configs (Mixtral's and Qwen3-30B-A3B's
reduced configs and the MoE configs of ``tests/test_sharding.py``), expert
axes (``n_model`` 1, 2, 4, 8; ``n_node`` 1, 2), slabs from 8 to 65,536
tokens and ``moe_a2a_chunks`` 1 and 2: mode, feasibility and reason
equal, times to 1e-12 relative, bytes exactly; and so must
``select_moe_parallel``'s mode and source, ``select_moe_tiles`` and
``model_flops``.  The reference's own cost-model tests
(``tests/test_roofline.py:93-218``) are ported under the same constants.
The port's default record is the H100's, not the reference's.

The port is imported inside the fixture, as the other port tests do.
"""

import math
from types import SimpleNamespace

import pytest

from repro import roofline as JR
from repro.configs import get_config
from repro.launch import mesh as JM
from torch_parity import torch_config

MOE_CFG = get_config("mixtral_8x7b").reduced().replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    num_experts=4, top_k=2, moe_d_ff=64, vocab_size=128, sliding_window=16,
    attn_chunk=16)
# tests/test_sharding.py:400-436, and the reduced configs of the slice
GRID_CFGS = {
    "mixtral_reduced": get_config("mixtral_8x7b").reduced(),
    "qwen3_moe_reduced": get_config("qwen3_moe_30b_a3b").reduced(),
    "sharding_moe": MOE_CFG,
    "a2a_wins": MOE_CFG.replace(num_experts=8, moe_d_ff=198,
                                moe_a2a_capacity=1.0),
    "a2a_loses": MOE_CFG.replace(num_experts=8, moe_d_ff=66,
                                 moe_a2a_capacity=2.0),
    "hier": MOE_CFG.replace(num_experts=8, moe_d_ff=389,
                            moe_a2a_capacity=1.0),
}
SLABS = (8, 24, 64, 512, 1000, 4096, 16384, 65536)
# tests/test_roofline.py:16-19
BASE = get_config("mixtral_8x7b").reduced().replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    num_experts=8, top_k=2, moe_d_ff=198, vocab_size=128, sliding_window=16,
    attn_chunk=16, moe_a2a_capacity=1.0)


class FakeMesh:
    """Axis names and sizes: all the cost model reads of a mesh."""

    def __init__(self, **shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def debug_mesh(data, model):
    return FakeMesh(data=data, model=model)


def node_mesh(data, node, model):
    return FakeMesh(data=data, node=node, model=model)


@pytest.fixture(scope="module")
def R():
    """The port's roofline module and the reference's constants as a
    ``Hardware`` record."""
    from repro_torch import roofline
    from repro_torch.launch import mesh
    hw = mesh.Hardware(name="reference", peak_flops_bf16=JM.PEAK_FLOPS_BF16,
                       hbm_bw=JM.HBM_BW, hbm_bytes=JM.HBM_BYTES,
                       intra_node_bw=JM.ICI_BW_PER_LINK,
                       cross_node_bw=JM.DCN_BW, gemm_tile=128)
    return SimpleNamespace(rl=roofline, mesh=mesh, hw=hw)


def _same_row(a, b, where):
    assert (a.mode, a.feasible, a.why) == (b.mode, b.feasible, b.why), where
    for f in ("t_compute_s", "t_memory_s", "t_collective_s", "t_total_s"):
        assert math.isclose(getattr(a, f), getattr(b, f), rel_tol=1e-12,
                            abs_tol=0.0), (where, f)
    for f in ("live_bytes", "a2a_bytes", "psum_bytes", "chosen"):
        assert getattr(a, f) == getattr(b, f), (where, f)


@pytest.mark.parametrize("chunks", (1, 2))
@pytest.mark.parametrize("name", list(GRID_CFGS))
def test_cost_model_matches_reference(R, name, chunks):
    jcfg = GRID_CFGS[name].replace(moe_a2a_chunks=chunks)
    cfg = torch_config(jcfg)
    for n_model in (1, 2, 4, 8):
        for n_node in (1, 2):
            mesh = (node_mesh(2, n_node, n_model) if n_node > 1
                    else debug_mesh(2, n_model))
            for L in SLABS:
                where = (name, chunks, n_model, n_node, L)
                got = R.rl.moe_parallel_costs(cfg, n_model=n_model,
                                              n_node=n_node, n_tokens=L,
                                              hw=R.hw)
                want = JR.moe_parallel_costs(jcfg, n_model=n_model,
                                             n_node=n_node, n_tokens=L)
                assert len(got) == len(want) == 4
                for a, b in zip(got, want):
                    _same_row(a, b, where)
                for mode in ("auto", "ep", "tp"):
                    dg = R.rl.select_moe_parallel(
                        cfg.replace(moe_parallel=mode), mesh, L, hw=R.hw)
                    dw = JR.select_moe_parallel(
                        jcfg.replace(moe_parallel=mode), mesh, L)
                    assert (dg.mode, dg.source, dg.n_tokens,
                            dg.mesh_axes) == (dw.mode, dw.source,
                                              dw.n_tokens, dw.mesh_axes), \
                        (where, mode)
                    for a, b in zip(dg.table, dw.table):
                        _same_row(a, b, where + (mode,))


def test_tiles_and_model_flops_match_reference(R):
    for n_rows, d, h in ((8, 64, 64), (4096, 4096, 14336), (300, 2048, 768),
                         (65536, 1024, 512), (16, 5120, 17408)):
        for limit in (8 * 1024 * 1024, 2 * 1024 * 1024, 227 * 1024):
            for it in (2, 4):
                assert R.rl.select_moe_tiles(
                    n_rows, d, h, dtype_bytes=it, smem_limit_bytes=limit,
                    hw=R.hw) == JR.select_moe_tiles(
                    n_rows, d, h, dtype_bytes=it, vmem_limit_bytes=limit)
    for jcfg in (GRID_CFGS["mixtral_reduced"], GRID_CFGS["qwen3_moe_reduced"],
                 get_config("qwen3_14b").reduced(), MOE_CFG):
        for kind, batch, seq in (("train", 8, 256), ("prefill", 2, 100),
                                 ("decode", 4, 64)):
            want = JR.model_flops(jcfg, SimpleNamespace(
                global_batch=batch, seq_len=seq, kind=kind))
            got = R.rl.model_flops(torch_config(jcfg), global_batch=batch,
                                   seq_len=seq, kind=kind)
            assert math.isclose(got, want, rel_tol=1e-12), (jcfg.name, kind)


def test_default_constants_are_the_h100s(R):
    hw = R.mesh.H100_SXM
    import inspect
    for fn in (R.rl.moe_parallel_costs, R.rl.select_moe_parallel,
               R.rl.select_moe_tiles, R.rl._psum_cost, R.rl._a2a_hop_cost,
               R.mesh.axis_bandwidth):
        assert inspect.signature(fn).parameters["hw"].default is hw
    assert (hw.peak_flops_bf16, hw.hbm_bw, hw.hbm_bytes, hw.intra_node_bw,
            hw.cross_node_bw, hw.gemm_tile) == (989e12, 3.35e12, 80e9,
                                                450e9, 50e9, 128)
    for mine, ref in ((hw.peak_flops_bf16, JM.PEAK_FLOPS_BF16),
                      (hw.hbm_bw, JM.HBM_BW), (hw.hbm_bytes, JM.HBM_BYTES),
                      (hw.intra_node_bw, JM.ICI_BW_PER_LINK),
                      (hw.cross_node_bw, JM.DCN_BW)):
        assert mine != ref
    assert R.mesh.axis_bandwidth("node") == hw.cross_node_bw
    assert R.mesh.axis_bandwidth("pod") == hw.cross_node_bw
    assert R.mesh.axis_bandwidth("model") == hw.intra_node_bw
    assert R.mesh.axis_bandwidth("data") == hw.intra_node_bw


# -- the reference's cost-model tests (tests/test_roofline.py:93-218), under
#    the reference's constants


def _modes(decision):
    return {c.mode: c for c in decision.table}


def test_psum_cost_ring_formula_and_bandwidth_tiers(R):
    L, d, it = 128, 64, 4
    b_model, t_model = R.rl._psum_cost(L, d, it, (("model", 4),), R.hw)
    assert b_model == int(2 * 3 / 4 * L * d * it)
    assert t_model == pytest.approx(b_model / JM.ICI_BW_PER_LINK)
    b_node, t_node = R.rl._psum_cost(L, d, it, (("node", 4),), R.hw)
    assert b_node == b_model
    assert t_node == pytest.approx(b_node / JM.DCN_BW)
    assert t_node > t_model
    assert R.mesh.axis_bandwidth("node", R.hw) == JM.DCN_BW
    assert R.mesh.axis_bandwidth("model", R.hw) == JM.ICI_BW_PER_LINK
    assert R.rl._psum_cost(L, d, it, (("model", 1),), R.hw) == (0, 0.0)


def test_a2a_hop_cost(R):
    rows, n, d, it = 256, 4, 64, 2
    b, t = R.rl._a2a_hop_cost(rows, n, d, it, "model", R.hw)
    assert b == int(2 * rows * 3 / 4 * d * it)
    assert t == pytest.approx(b / JM.ICI_BW_PER_LINK)
    assert R.rl._a2a_hop_cost(rows, 1, d, it, "model", R.hw) == (0, 0.0)


def _select(R, cfg, mesh, L):
    return R.rl.select_moe_parallel(torch_config(cfg), mesh, L, hw=R.hw)


def test_auto_picks_ep_a2a_where_predicted_faster(R):
    d = _select(R, BASE, debug_mesh(2, 4), 1024)
    assert d.mode == "ep_a2a"
    assert d.source == "auto"
    row = _modes(d)
    assert row["ep_a2a"].chosen and not row["ep"].chosen
    assert row["ep_a2a"].t_total_s < row["ep"].t_total_s
    assert row["ep_a2a"].a2a_bytes > 0
    assert row["ep"].a2a_bytes == 0
    assert not row["tp"].feasible


def test_auto_picks_ep_where_exchange_does_not_pay(R):
    cfg = BASE.replace(moe_d_ff=66, moe_a2a_capacity=2.0)
    d = _select(R, cfg, debug_mesh(2, 4), 1024)
    assert d.mode == "ep"
    row = _modes(d)
    assert row["ep"].t_total_s < row["ep_a2a"].t_total_s


def test_auto_falls_back_to_tp_on_awkward_expert_count(R):
    cfg = BASE.replace(num_experts=6, moe_d_ff=64)
    d = _select(R, cfg, debug_mesh(2, 4), 1024)
    assert d.mode == "tp"
    row = _modes(d)
    assert not row["ep"].feasible and "divisible" in row["ep"].why


def test_auto_live_bytes_tiebreak_within_slack(R):
    cfg = BASE.replace(d_model=128, moe_d_ff=390, moe_a2a_capacity=2.0)
    d = _select(R, cfg, debug_mesh(2, 4), 2048)
    row = _modes(d)
    assert row["ep_a2a"].t_total_s <= row["ep"].t_total_s * \
        (1.0 + R.rl.AUTO_TIME_SLACK)
    assert row["ep"].live_bytes - row["ep_a2a"].live_bytes \
        > R.rl.AUTO_LIVE_EPS
    assert d.mode == "ep_a2a"


def test_auto_prefers_ep_on_tiny_slabs(R):
    cfg = BASE.replace(moe_d_ff=66, moe_a2a_capacity=2.0)
    assert _select(R, cfg, debug_mesh(2, 4), 32).mode == "ep"


def test_hier_selected_on_node_mesh(R):
    cfg = BASE.replace(moe_d_ff=389)
    d = _select(R, cfg, node_mesh(2, 2, 2), 1024)
    row = _modes(d)
    assert not row["ep_a2a"].feasible
    assert row["ep_a2a_hier"].feasible
    assert d.mode == "ep_a2a_hier"


def test_forced_mode_keeps_table_provenance(R):
    d = _select(R, BASE.replace(moe_parallel="ep"), debug_mesh(2, 4), 1024)
    assert d.mode == "ep" and d.source == "config"
    assert _modes(d)["ep"].chosen
    rows = d.table_rows()
    assert all(isinstance(r, dict) and "t_total_s" in r and "chosen" in r
               for r in rows)
    assert sum(r["chosen"] for r in rows) == 1


def test_no_mesh_resolves_single(R):
    d = _select(R, BASE, None, 1024)
    assert d.mode == "single" and d.source == "single"
    assert d.table == ()


def test_chunked_model_never_slower_than_unchunked(R):
    mesh = debug_mesh(2, 4)
    for L in (256, 1024, 4096):
        un = _modes(_select(R, BASE, mesh, L))["ep_a2a"]
        ch = _modes(_select(R, BASE.replace(moe_a2a_chunks=4), mesh,
                            L))["ep_a2a"]
        assert ch.t_total_s <= un.t_total_s + 1e-12


def test_resolve_moe_parallel_matches_reference(R):
    """``models.moe_block.resolve_moe_parallel_ex`` resolves ``auto``
    through the cost model (at the H100's constants), keeps a forced mode
    with its table, and raises the reference's errors for a bad pairing;
    ``auto`` never raises (tests/test_sharding.py:151-165, 400-436)."""
    from repro.models.moe_block import resolve_moe_parallel as j_resolve
    from repro_torch.models import moe_block as MB
    from repro_torch.launch.mesh import H100_SXM
    mesh = debug_mesh(2, 4)
    for name, jcfg in GRID_CFGS.items():
        for L in (32, 1024, 4096):
            dec = MB.resolve_moe_parallel_ex(torch_config(jcfg), mesh, L)
            want = R.rl.select_moe_parallel(torch_config(jcfg), mesh, L,
                                            hw=H100_SXM)
            assert (dec.mode, dec.source) == (want.mode, "auto"), name
            # the same model at the reference's constants: the reference's
            # own choice
            assert _select(R, jcfg, mesh, L).mode == j_resolve(jcfg, mesh, L)
    bad = torch_config(MOE_CFG.replace(num_experts=6, moe_parallel="ep"))
    with pytest.raises(ValueError, match="divisible"):
        MB.resolve_moe_parallel(bad, mesh)
    assert MB.resolve_moe_parallel(bad.replace(moe_parallel="auto"),
                                   mesh) == "tp"
    forced = MB.resolve_moe_parallel_ex(
        torch_config(MOE_CFG.replace(moe_parallel="tp")), mesh, 64)
    assert forced.mode == "tp" and forced.source == "config"
    assert len(forced.table) == 4
    assert MB.resolve_moe_parallel(torch_config(MOE_CFG), None) == "single"
