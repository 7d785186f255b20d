"""Port parity: the dry run (``repro_torch.launch.dryrun``) and what it
stands on: ``launch/specs.py``, ``sharding.cache_specs``,
``moe_impl="proxy_gmm"``, the run record's plan and ``moe_parallel``
fields, the live-storage tracer (``compat.trace_step``), the shape-only
collectives and their recorder, and the kernel wrappers' dry launches.

Every trace here runs on the CPU: on fake CPU tensors (a CPU-only build
of PyTorch aborts in the backward of a fake CUDA step), except the
wrappers' forward calls, which take fake CUDA tensors under
``kernels._lib.dry_run()`` with the kernel library patched to raise.
``run_one`` on the production mesh is the card's (``chip_smoke.py``
phase 50); here the record is built on a ``DryMesh(2, 4)`` at the
reference test's sizes (``tests/test_sharding.py:437``).

The reference's dry-run module sets ``XLA_FLAGS`` for 512 host devices
when imported; the fixture initialises JAX's backend first (8 devices,
``tests/conftest.py``) and puts the variable back.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import os
import pickle
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro import sharding as jshd
from repro.configs import ARCH_IDS, get_config
from repro.configs.base import INPUT_SHAPES, InputShape
from repro.launch import mesh as JM
from repro.launch import specs as JS
from repro.models import transformer as JT
from torch_parity import torch_config

# tests/test_sharding.py:28-31 and :437-447
MOE_CFG = get_config("mixtral_8x7b").reduced().replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    num_experts=4, top_k=2, moe_d_ff=64, vocab_size=128, sliding_window=16,
    attn_chunk=16)
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, num_experts=4, top_k=2, moe_d_ff=64,
             vocab_size=128, sliding_window=16, attn_chunk=16)
TINY = {"train": InputShape("tiny_train", 64, 8, "train"),
        "prefill": InputShape("tiny_prefill", 64, 8, "prefill"),
        "decode": InputShape("tiny_decode", 64, 8, "decode")}
# the reference MoE tests' float32 tolerance (tests/test_sharding.py:74)
F32_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def port():
    import torch
    torch.set_num_threads(2)
    from repro_torch import compat, roofline
    from repro_torch import sharding as SH
    from repro_torch.core import collectives as CL
    from repro_torch.kernels import _lib
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch import mesh as M
    from repro_torch.models import moe_block as MB
    from repro_torch.models import transformer as T
    from repro_torch.train import loop
    return SimpleNamespace(torch=torch, compat=compat, rl=roofline, SH=SH,
                           CL=CL, lib=_lib, dryrun=dryrun, specs=specs,
                           M=M, MB=MB, T=T, loop=loop)


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module, imported without changing this
    process's JAX devices or leaving its ``XLA_FLAGS`` behind."""
    jax.devices()                       # the backend is up: 8 devices
    saved = os.environ.get("XLA_FLAGS")
    try:
        mod = importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


def _same_leaf(port, t, sds, where):
    assert tuple(t.shape) == tuple(sds.shape), where
    assert t.dtype == getattr(port.torch, str(np.dtype(sds.dtype))), where


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


# -- (a) specs ---------------------------------------------------------------


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(port, arch, shape_name):
    """``applicable`` (its words), ``batch_shapes`` and ``decode_shapes``
    of the reduced configs at the four input shapes: shapes and dtypes
    exact, each layer's cache leaf the reference's group-stacked leaf of
    its pattern position without the group dimension."""
    jcfg = get_config(arch).reduced()
    cfg = torch_config(jcfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        port.dryrun.get_config(arch).reduced())
    shape = INPUT_SHAPES[shape_name]
    pshape = port.dryrun.INPUT_SHAPES[shape_name]
    assert dataclasses.asdict(pshape) == dataclasses.asdict(shape)
    assert port.specs.applicable(cfg, pshape) == JS.applicable(jcfg, shape)
    if shape.kind != "decode":
        want = JS.batch_shapes(jcfg, shape)
        got = port.specs.batch_shapes(cfg, pshape)
        assert sorted(got) == sorted(want)
        for k in want:
            _same_leaf(port, got[k], want[k], k)
        return
    if port.specs.applicable(cfg, pshape):
        return
    want = JS.decode_shapes(jcfg, shape)
    got = port.specs.decode_shapes(cfg, pshape)
    for k in ("tokens", "pos"):
        _same_leaf(port, got[k], want[k], k)
    period = cfg.pattern_period
    assert len(got["cache"]) == cfg.num_layers
    for layer, sub in enumerate(got["cache"]):
        ref = jax.tree.leaves(want["cache"][layer % period])
        mine = _leaves(sub)
        assert len(mine) == len(ref), layer
        for t, r in zip(mine, ref):
            assert tuple(t.shape) == tuple(r.shape[1:]), layer
            assert t.dtype == getattr(port.torch, str(np.dtype(r.dtype)))
            assert t.device.type == "meta"


# -- (b) cache_specs ---------------------------------------------------------


def _entries(spec) -> tuple:
    return tuple(None if e is None else (tuple(e) if isinstance(e, tuple)
                                         else (e,)) for e in spec)


def _pairs(port, cache, specs) -> list:
    """(leaf, spec) of a cache tree and its congruent spec tree."""
    out = []
    port.SH._map_cache(lambda t, s: out.append((t, s)), cache, specs)
    return out


def _cache_case(port, jcfg, batch, cap, jmesh, pmesh):
    cfg = torch_config(jcfg)
    jc = jax.eval_shape(lambda: JT.init_cache(jcfg, batch, cap))
    jspecs = jshd.cache_specs(jcfg, jc, jmesh)
    pc = port.T.init_cache(cfg, batch, cap, "meta")
    pspecs = port.SH.cache_specs(cfg, pc, pmesh)
    period = cfg.pattern_period
    flat_j = [jax.tree.leaves(jspecs[i], is_leaf=lambda x: isinstance(x, P))
              for i in range(period)]
    for layer, (sub, spec) in enumerate(zip(pc, pspecs)):
        mine = [s for _, s in _pairs(port, sub, spec)]
        ref = flat_j[layer % period]
        assert len(mine) == len(ref)
        for got, want in zip(mine, ref):
            assert _entries(got) == _entries(want)[1:], (layer, got, want)
    return pspecs


# the architectures that decode (an encoder has no cache)
DECODE_ARCHS = [a for a in ARCH_IDS if get_config(a).causal
                and get_config(a).input_kind != "frames"]


@pytest.mark.parametrize("batch,cap", [(8, 64), (1, 1024)])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_cache_specs_match_reference(port, arch, batch, cap):
    """``cache_specs`` on (2, 4), per layer, equal to the reference's for
    the layer's pattern position without the group entry: a batch that
    divides the data axis, and a single row (context parallelism)."""
    jcfg = get_config(arch).reduced()
    _cache_case(port, jcfg, batch, cap, JM.make_debug_mesh(2, 4),
                port.M.DryMesh((2, 4), ("data", "model")))


def test_cache_specs_long_context_matches_reference(port):
    """The ``long_500k``-style case of tests/test_sharding.py:273: batch 1
    cannot be split, so the sequence axis is."""
    specs = _cache_case(port, MOE_CFG.replace(sliding_window=0), 1, 1024,
                        JM.make_debug_mesh(2, 4),
                        port.M.DryMesh((2, 4), ("data", "model")))
    kv = specs[0][0]
    assert any(ax for ax in kv.k)


# -- (c) proxy_gmm -----------------------------------------------------------


def _moe_inputs(jcfg, seed=3):
    from repro.models.moe_block import init_moe_params
    p = init_moe_params(jax.random.PRNGKey(seed), jcfg, jcfg.d_model)
    x = np.random.default_rng(seed).standard_normal(
        (48, jcfg.d_model)).astype(np.float32)
    return x, {k: np.array(v, np.float32) for k, v in p.items()}


@pytest.mark.parametrize("act", ["swiglu", "silu"])
@pytest.mark.parametrize("path", ["local", "ep"])
def test_proxy_gmm_matches_reference(port, path, act):
    """``moe_impl="proxy_gmm"``: the single-device (and ``tp``) stand-in
    against the reference's ``_moe_local`` and the expert-parallel one
    against its ``_moe_proxy_ep``, float32, output and aux loss."""
    import jax.numpy as jnp

    from repro.models import moe_block as JB
    jcfg = MOE_CFG.replace(dtype="float32", param_dtype="float32",
                           moe_impl="proxy_gmm", ffn_act=act)
    x, p = _moe_inputs(jcfg)    # init_moe_params draws w2 for swiglu only
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: port.torch.from_numpy(v) for k, v in p.items()}
    xt = port.torch.from_numpy(x)
    cfg = torch_config(jcfg)
    if path == "local":
        jy, jaux = JB._moe_local(jnp.asarray(x), jp, jcfg)
        y, aux = port.MB.moe_local(xt, tp, cfg)
    else:
        jy, jaux = JB._moe_proxy_ep(jnp.asarray(x), jp, jcfg, 2)
        y, aux = port.MB._moe_proxy_ep(xt, tp, cfg, 2)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **F32_TOL)


# -- (d) the record's plan and moe_parallel fields ---------------------------


def _ref_plan_fields(jdry, jcfg, ishape, jmesh, *, hbm_budget=None):
    """The reference's ``run_one`` up to its compile
    (``repro/launch/dryrun.py:214-288``), on its own functions."""
    from repro.core import checkpoint as CK
    from repro.core import memsim
    from repro.models.moe_block import resolve_moe_parallel_ex
    n_dp = 1
    for a in ("pod", "data"):
        if a in jmesh.axis_names:
            n_dp *= jmesh.shape[a]
    b_dev = max(ishape.global_batch // max(n_dp, 1), 1)
    if ishape.kind == "train":
        b_dev = max(b_dev // jdry._num_microbatches(ishape, jmesh, jcfg), 1)
    n_model = max(jmesh.shape.get("model", 1), 1)
    n_node = max(jmesh.shape.get("node", 1), 1)
    rec, moe_mode = {}, None
    if jcfg.is_moe:
        d = resolve_moe_parallel_ex(jcfg, jmesh, b_dev * ishape.seq_len)
        moe_mode = d.mode
        rec.update(moe_parallel=d.mode, moe_parallel_source=d.source,
                   moe_parallel_tokens=d.n_tokens,
                   moe_parallel_decision=d.table_rows())
    if hbm_budget is not None:
        fit = CK.CheckpointPlan.fit(
            jcfg, b_dev * ishape.seq_len, hbm_budget, batch=b_dev,
            mode=moe_mode, n_model=n_model, n_node=n_node)
        plan_r = fit.resolved
        rec["remat_fit"] = [dict(dataclasses.asdict(r), source="fit")
                            for r in fit.table]
        rec["hbm_budget"] = fit.budget_bytes
        timeline = fit.timeline
    else:
        plan_r = CK.resolve_plan(None, config=jcfg.remat_policy)
        timeline = memsim.simulate(
            jcfg, b_dev * ishape.seq_len, batch=b_dev, plan=plan_r.plan,
            mode=moe_mode, n_model=n_model, n_node=n_node, base="train")
        src = "explicit" if plan_r.source == "arg" else plan_r.source
        rec["remat_fit"] = [dict(
            spec=plan_r.spec,
            est_saved_bytes=plan_r.plan.estimate_saved_bytes(
                jcfg, b_dev * ishape.seq_len, batch=b_dev),
            fits=None, chosen=True, sim_peak_bytes=timeline.peak_bytes,
            peak_phase=timeline.peak_phase, source=src)]
    rec.update(remat_plan=plan_r.spec, remat_plan_source=plan_r.source,
               peak_sim_bytes=timeline.peak_bytes,
               peak_sim_phase=timeline.peak_phase,
               sim_phases=[{"phase": p.name, "held_bytes": p.held_bytes,
                            "transient_bytes": p.transient_bytes,
                            "collective_bytes": p.collective_bytes,
                            "live_bytes": p.live_bytes}
                           for p in sorted(timeline.phases,
                                           key=lambda p: -p.live_bytes)[:4]])
    return rec


MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.mark.parametrize("budget", [None, 2 ** 30])
@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_plan_fields_match_reference(port, jdry, mesh_name, shape_name,
                                     budget):
    """``_num_microbatches``, ``_prefill_chunks`` and the record's
    ``remat_fit`` / ``hbm_budget`` / ``peak_sim_bytes`` / ``sim_phases`` /
    ``moe_parallel*`` fields for reduced Mixtral on (2, 4) and (2, 2, 2),
    with the reference's TPU constants as ``hw``: equal to the
    reference's, exactly."""
    from repro.compat import make_mesh
    sizes, names = MESHES[mesh_name]
    jmesh = make_mesh(sizes, names)
    pmesh = port.M.DryMesh(sizes, names)
    jcfg = get_config("mixtral_8x7b").reduced()
    cfg = torch_config(jcfg)
    ishape = INPUT_SHAPES[shape_name]
    pshape = port.dryrun.INPUT_SHAPES[shape_name]
    assert port.dryrun._num_microbatches(pshape, pmesh, cfg) == \
        jdry._num_microbatches(ishape, jmesh, jcfg)
    assert port.dryrun._num_microbatches(pshape, pmesh) == \
        jdry._num_microbatches(ishape, jmesh)
    assert port.dryrun._prefill_chunks(cfg, pshape, pmesh) == \
        jdry._prefill_chunks(jcfg, ishape, jmesh)
    hw = port.M.Hardware(name="reference", peak_flops_bf16=JM.PEAK_FLOPS_BF16,
                         hbm_bw=JM.HBM_BW, hbm_bytes=JM.HBM_BYTES,
                         intra_node_bw=JM.ICI_BW_PER_LINK,
                         cross_node_bw=JM.DCN_BW, gemm_tile=128)
    got, _ = port.dryrun._plan_fields(cfg, pshape, pmesh, hbm_budget=budget,
                                      hw=hw)
    want = _ref_plan_fields(jdry, jcfg, ishape, jmesh, hbm_budget=budget)
    assert got == want


# -- (e) the record on a small mesh ------------------------------------------


def _block_bytes(port, tree, specs, mesh) -> int:
    """Bytes of this rank's blocks, from the specs and the whole shapes."""
    total = 0
    flat_t = port.compat._tensors(tree)
    flat_s = port.SH.spec_leaves(specs, tree)
    for t, spec in zip(flat_t, flat_s):
        n = t.element_size()
        for dim, ax in zip(t.shape, spec):
            n *= dim // (mesh.axis_size(ax) if ax else 1)
        total += n
    return total


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dryrun_small_mesh_end_to_end(port, kind):
    """The counterpart of tests/test_sharding.py:437: Mixtral at the
    reference test's sizes on ``DryMesh(2, 4)`` rank 0, train with two
    microbatches, prefill and decode: status OK, ``temp_bytes > 0``, and
    ``arg_bytes`` equal to the rank's blocks of the parameters (and AdamW
    moments, or the cache) and of the batch, exactly."""
    D, SH = port.dryrun, port.SH
    mesh = port.M.DryMesh((2, 4), ("data", "model"))
    shape = TINY[kind]
    rec = D.run_one("mixtral_8x7b", shape.name, device="cpu",
                    cfg_overrides=SMALL, verbose=False, mesh=mesh,
                    shape=shape, microbatches=2 if kind == "train" else None,
                    cost_probe=False)
    assert rec["status"] == "OK" and rec["temp_bytes"] > 0
    assert rec["mesh"] == "2x4" and rec["n_chips"] == 8
    cfg = D.get_config("mixtral_8x7b").replace(**SMALL)
    if kind == "decode":
        cfg = cfg.replace(param_dtype="bfloat16")
    # tokens of the rank's MoE slab: a microbatch's rows, a prefill
    # chunk's row (4 chunks of the rank's 4 rows), the decode rows
    n_tok = {"train": 8 // 2 // 2 * 64, "prefill": 64, "decode": 4}[kind]
    mode = port.MB.resolve_moe_parallel(cfg, mesh, n_tok)
    whole = port.specs.params_shapes(cfg)
    specs = SH.param_specs(whole, mesh, fsdp=True, moe_parallel=mode)
    want = _block_bytes(port, whole, specs, mesh)
    if kind == "train":
        want *= 3                       # float32 masters and two moments
        want += 2 * 8 // 2 * 64 * 4     # tokens and labels, 4 rows
    elif kind == "prefill":
        want += 2 * 8 // 2 * 64 * 4
    else:
        ds = port.specs.decode_shapes(cfg, shape)
        cs = SH.cache_specs(cfg, ds["cache"], mesh)
        for t, spec in _pairs(port, ds["cache"], cs):
            n = t.element_size()
            for dim, ax in zip(t.shape, spec):
                n *= dim // (mesh.axis_size(ax) if ax else 1)
            want += n
        want += 8 // 2 * 4              # the rank's tokens
    assert rec["arg_bytes"] == want


def test_run_one_record_has_the_reference_keys(port):
    """Every key the reference's ``run_one`` writes for a MoE train pair
    with its cost probes, ``trace_s`` for ``lower_s`` / ``compile_s``."""
    mesh = port.M.DryMesh((2, 4), ("data", "model"))
    rec = port.dryrun.run_one("mixtral_8x7b", "tiny_train", device="cpu",
                              cfg_overrides=SMALL, verbose=False, mesh=mesh,
                              shape=TINY["train"], microbatches=2)
    keys = {"arch", "shape", "mesh", "moe_parallel", "moe_parallel_source",
            "moe_parallel_tokens", "moe_parallel_decision", "remat_fit",
            "remat_plan", "remat_plan_source", "peak_sim_bytes",
            "peak_sim_phase", "sim_phases", "gmm_backend", "status",
            "trace_s", "flops_per_dev", "hlo_bytes_per_dev",
            "collective_bytes", "collective_counts",
            "collective_bytes_by_kind", "arg_bytes", "out_bytes",
            "temp_bytes", "peak_bytes", "fits_hbm", "t_compute_s",
            "t_memory_s", "t_collective_s", "dominant",
            "model_flops_global", "useful_flops_ratio", "n_chips",
            "cost_probe"}
    assert keys <= set(rec), sorted(keys - set(rec))
    assert rec["cost_probe"] == "extrapolated(1,2 groups unrolled)"
    assert rec["peak_bytes"] == (rec["arg_bytes"] + rec["out_bytes"]
                                 + rec["temp_bytes"] - rec["alias_bytes"])


def test_cuda_device_needs_a_cuda_build(port):
    """On a build with no card ``--device cuda`` raises, naming
    ``--device cpu``."""
    if port.torch.cuda.is_available():
        pytest.skip("this build has a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        port.dryrun.run_one("yi_6b", "train_4k", verbose=False)


# -- (f), (g) the tracer -----------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3_14b", "mixtral_8x7b"])
def test_tracer_real_step_equals_fake_trace(port, arch):
    """The tracer on a real CPU training step of a tiny model and on the
    same step over fake tensors: ``arg_bytes``, ``out_bytes``,
    ``temp_bytes``, ``alias_bytes``, ``peak_bytes`` and the FLOPs equal,
    byte for byte."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import TrainConfig
    from repro_torch.interop import init_params
    from repro_torch.train.optimizer import init_adamw
    torch = port.torch
    cfg = port.dryrun.get_config(arch).reduced()
    if cfg.is_moe:
        cfg = cfg.replace(moe_impl="dense")
    tcfg = TrainConfig(batch_size=2, seq_len=32, warmup_steps=2,
                       total_steps=10)
    step = port.loop.make_train_step(cfg, tcfg, "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                         dtype=torch.float32)
    batch = {k: torch.as_tensor(tokens, dtype=torch.int32)
             for k in ("tokens", "labels")}
    _, real = port.compat.trace_step(step, params, init_adamw(params),
                                     batch)
    with FakeTensorMode():
        params = port.compat.empty_tree(init_params(
            cfg, device="meta", dtype=torch.float32), "cpu")
        batch = {k: torch.empty(2, 32, dtype=torch.int32)
                 for k in ("tokens", "labels")}
        _, fake = port.compat.trace_step(step, params, init_adamw(params),
                                         batch)
    for f in ("arg_bytes", "out_bytes", "temp_bytes", "alias_bytes",
              "peak_bytes", "flops"):
        assert getattr(real, f) == getattr(fake, f), f
    assert real.temp_bytes > 0 and real.alias_bytes > 0


def test_flops_equal_a_hand_count(port):
    """A tiny dense step (2 layers, plan ``full``: no recompute) counts
    exactly its products: per layer the q, k, v and output projections,
    the scores and the weighted values over every (query, key) chunk pair
    the plain attention computes, the three FFN products, and the logits;
    the backward twice each (both operands need a gradient)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import TrainConfig
    from repro_torch.interop import init_params
    from repro_torch.train.optimizer import init_adamw
    torch = port.torch
    cfg = torch_config(get_config("yi_6b").reduced().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=96, attn_chunk=16, remat_policy="full"))
    B, S = 2, 32
    step = port.loop.make_train_step(cfg, TrainConfig(
        batch_size=B, seq_len=S, warmup_steps=2, total_steps=10), "cpu")
    with FakeTensorMode():
        params = port.compat.empty_tree(init_params(
            cfg, device="meta", dtype=torch.float32), "cpu")
        batch = {k: torch.empty(B, S, dtype=torch.int32)
                 for k in ("tokens", "labels")}
        _, tr = port.compat.trace_step(step, params, init_adamw(params),
                                       batch)
    T, d, H, Hkv, dh, f, V = (B * S, cfg.d_model, cfg.num_heads,
                              cfg.num_kv_heads, cfg.resolved_head_dim,
                              cfg.d_ff, cfg.vocab_size)
    layer = (2 * T * d * H * dh + 2 * 2 * T * d * Hkv * dh
             + 2 * 2 * B * S * H * S * dh        # every chunk pair: causal
             + 2 * T * H * dh * d                # from position 0 on
             + 2 * 2 * T * d * f + 2 * T * f * d)
    fwd = cfg.num_layers * layer + 2 * T * d * V
    assert tr.flops == 3 * fwd


# -- (h) collectives: the real ranks against the dry run ---------------------


@pytest.mark.parametrize("case", ["fsdp_2x1", "ep_a2a_1x2"])
def test_dry_collectives_equal_a_real_run(port, tmp_path, case):
    """A tiny Mixtral step on spawned gloo ranks (``dense``, the CPU
    trace's ``moe_impl``: under ``ep_a2a`` it falls through to the
    grouped GEMM on ``ragged``) records per kind the collectives rank 0
    called; the dry run of the same step on ``DryMesh`` rank 0 records
    the same counts and bytes, exactly."""
    import torch.multiprocessing as mp

    import torch_dist_worker
    sizes, mode = {"fsdp_2x1": ((2, 1), "auto"),
                   "ep_a2a_1x2": ((1, 2), "ep_a2a")}[case]
    names = ("data", "model")
    cfg = torch_config(MOE_CFG.replace(
        moe_impl="dense", moe_parallel=mode, moe_a2a_capacity=8.0,
        dtype="bfloat16"))          # 'ragged' takes bf16 on the CPU
    tcfg = dict(batch_size=2, seq_len=16, warmup_steps=2, total_steps=10)
    job = {"kind": "collectives", "cfg": dataclasses.asdict(cfg),
           "tcfg": tcfg}
    (tmp_path / "job.pkl").write_bytes(pickle.dumps(
        {"sizes": sizes, "names": names, "cases": {"c": job}}))
    world = math.prod(sizes)
    mp.start_processes(torch_dist_worker.run, args=(world, str(tmp_path)),
                       nprocs=world, join=True, start_method="spawn")
    real = pickle.loads((tmp_path / "rank0.pkl").read_bytes())["c"]
    from repro_torch.configs import TrainConfig
    dry = port.loop.compiled_step_memory(
        cfg, TrainConfig(**tcfg), mesh=port.M.DryMesh(sizes, names),
        device="cpu")
    assert real["counts"], "the real step called no collective"
    assert dry["collective_counts"] == real["counts"]
    assert dry["collective_bytes_by_kind"] == real["bytes"]


# -- (i) the wrappers' dry launches ------------------------------------------


def _wrapper_calls(port):
    from repro_torch.kernels import (combine, dispatch, flash_attention,
                                     fused_moe, fused_swiglu, gather_gmm,
                                     gather_rows, gmm_dw, paged_attention)
    torch = port.torch
    bf, i32, f32 = torch.bfloat16, torch.int32, torch.float32
    L, k, E, d, h = 64, 2, 8, 128, 256
    S = L * k

    def e(*shape, dt=bf):
        return torch.empty(*shape, dtype=dt, device="cuda:0")

    def disp():
        return dispatch.build_dispatch(e(L, k, dt=i32), E)

    def moe_args():
        dd = disp()
        return (e(L, d), e(S, dt=f32), dd.expert_token_indices,
                dd.expert_token_offsets, e(E, d, h), e(E, d, h), e(E, h, d),
                dd.token_index_map)

    return {
        "build_dispatch": (lambda: disp().token_index_map, (L, k)),
        "gather_gmm": (lambda: gather_gmm.gather_gmm(
            e(L, d), e(S, dt=i32), e(E + 1, dt=i32), e(E, d, h),
            e(E, d, h), save_ab=True)[2], (S, h)),
        "gmm_dw": (lambda: gmm_dw.gmm_dw(e(S, d), e(S, h),
                                         e(E + 1, dt=i32)), (E, d, h)),
        "combine": (lambda: combine.combine(e(S, d), e(L, k, dt=i32),
                                            e(L, k)), (L, d)),
        "gather_rows": (lambda: gather_rows.gather_rows(
            e(L, d), e(S, dt=i32)), (S, d)),
        "flash_attention": (lambda: flash_attention.flash_attention(
            e(2, 128, 4, 64), e(2, 128, 2, 64), e(2, 128, 2, 64)),
            (2, 128, 4, 64)),
        "fused_moe_fwd": (lambda: fused_moe.fused_moe_fwd(*moe_args()),
                          (L, d)),
        "fused_moe_bwd": (lambda: fused_moe.fused_moe_bwd(
            *(lambda a: (a[0], e(L, d)) + a[1:])(moe_args()))[2],
            (E, d, h)),
        "fused_swiglu_fwd": (lambda: fused_swiglu.fused_swiglu_fwd(
            e(4, d), e(d, h), e(d, h))[0], (4, h)),
        "fused_swiglu_bwd_x": (lambda: fused_swiglu.fused_swiglu_bwd_x(
            e(4, h), e(4, h), e(4, h), e(d, h), e(d, h)), (4, d)),
        "fused_swiglu_bwd_w": (lambda: fused_swiglu.fused_swiglu_bwd_w(
            e(4, d), e(4, h), e(4, h), e(4, h))[1], (d, h)),
        "paged_attention": (lambda: paged_attention.paged_attention(
            e(2, 1, 8, 128), e(33, 16, 2, 128), e(33, 16, 2, 128),
            e(2, 16, dt=i32), e(2, dt=i32)), (2, 1, 8, 128)),
        "paged_attention_int8": (lambda: paged_attention.paged_attention_int8(
            e(2, 1, 8, 128), e(33, 16, 2, 128, dt=torch.int8),
            e(33, 16, 2, 128, dt=torch.int8),
            e(33, 16, 2, 1, dt=torch.float16),
            e(33, 16, 2, 1, dt=torch.float16), e(2, 16, dt=i32),
            e(2, dt=i32)), (2, 1, 8, 128)),
    }


WRAPPERS = ("build_dispatch", "gather_gmm", "gmm_dw", "combine",
            "gather_rows", "flash_attention", "fused_moe_fwd",
            "fused_moe_bwd", "fused_swiglu_fwd", "fused_swiglu_bwd_x",
            "fused_swiglu_bwd_w", "paged_attention", "paged_attention_int8")


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_dry_launch(port, monkeypatch, name):
    """Each kernel wrapper under ``_lib.dry_run()`` on fake CUDA tensors
    (forward only), with the kernel library patched to raise: outputs of
    the right shape, the call recorded (one launch, its operations and
    bytes), the wrapper's own launch count untouched; the same call
    outside the context raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import kernels as K

    def no_library():
        raise AssertionError("the kernel library was called")
    monkeypatch.setattr(port.lib, "lib", no_library)
    K.reset_launches()
    call, want = _wrapper_calls(port)[name]
    with FakeTensorMode():
        with port.lib.dry_run() as rec:
            out = call()
        assert tuple(out.shape) == want
        assert out.is_cuda
        assert rec.kernels[name]["launches"] == 1
        assert rec.kernels[name]["bytes"] > 0
        if name not in ("build_dispatch", "gather_rows"):
            assert rec.kernels[name]["ops"] > 0
        with pytest.raises(RuntimeError, match="outside _lib.dry_run"):
            call()
    assert all(v == 0 for v in K.launch_counts().values())


def test_dry_run_refuses_real_tensors(port):
    """Inside ``dry_run()`` a real tensor that reaches a kernel raises:
    the dry run launches nothing, so its outputs would be garbage."""
    t = port.torch.empty(4, 8)
    with port.lib.dry_run():
        with pytest.raises(RuntimeError, match="real tensor"):
            port.lib.dry("combine", 0.0, (t,), ())


# -- the shape-only collectives ----------------------------------------------


def test_shape_only_collectives(port):
    """Over a ``DryMesh`` group every collective returns its result's
    shape, moves nothing, and is recorded with its kind, result bytes and
    axes; ``collective_stats`` has the reference's keys."""
    torch, C = port.torch, port.CL
    mesh = port.M.DryMesh((2, 4), ("data", "model"), rank=5)
    g = mesh.group("model")
    assert (g.size, g.rank, g.axes) == (4, 1, ("model",))
    assert mesh.group(("data", "model")).rank == 5
    x = torch.ones(8, 3)
    with C.recording() as rec:
        assert C.all_reduce_(x, g) is x
        assert C.all_to_all(x, g).shape == (8, 3)
        assert C.all_gather_cat(x, mesh.group("data"), 1).shape == (8, 6)
        assert C.pmean(x, g).shape == (8, 3)
        assert C.gather_to_rank0(x, g) is None
    assert rec.counts() == {"all-reduce": 2, "all-to-all": 1,
                            "all-gather": 1, "gather": 1}
    assert rec.bytes_by_kind()["all-gather"] == 8 * 6 * 4
    assert rec.bytes_by_axes() == {"model": 3 * 96 + 4 * 96, "data": 192}
    st = port.rl.collective_stats(rec)
    assert set(st) == {"bytes", "counts", "total_bytes", "total_count"}
    assert st["counts"]["reduce-scatter"] == 0
    assert st["total_count"] == 5
    prod = port.M.make_production_mesh(dry=True)
    assert (prod.shape, prod.axis_names) == ({"data": 16, "model": 16},
                                             ("data", "model"))
    pod = port.M.make_production_mesh(multi_pod=True, dry=True)
    assert pod.axis_names == ("pod", "data", "model")
    assert pod.axis_size(pod.axis_names) == 512
