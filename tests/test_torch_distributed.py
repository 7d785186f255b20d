"""Port parity: the MoE distribution modes over ``torch.distributed``.

Gloo ranks spawned from the test (``tests/torch_dist_worker.py``, which
imports torch and the port only) run the port's ``moe_sublayer`` under
``ep``, ``ep_a2a`` (one and two chunks) and ``tp`` on ('data', 'model')
meshes of 1 x 2 and 2 x 2 ranks, and ``ep_a2a_hier`` on a ('data', 'node',
'model') mesh of 1 x 2 x 2, on the ``segment`` and ``pallas`` backends
(the latter builds the a2a send buffer through ``gather_rows``, whose CPU
path is its plain version).  Each rank's output rows, its input gradient
and the parameter gradients (summed over the data axes, gathered whole)
are held against the JAX single-device oracle, the reference's
``moe_sublayer(mesh=None)`` on ``segment``, at the reference's shapes
(``tests/test_sharding.py:27-30``) and its tolerances ``_TOL``
(``tests/test_sharding.py:74-75``: bf16 rounds at every grouped-GEMM
boundary and the modes order their float32 sums differently).

At a tight capacity (0.25) ``ep_a2a`` drops slots: its output and its
overflow share are held against the reference's ``ep_a2a`` under a JAX
mesh of the same shape (the first 4 of the 8 host devices), which shows
the same slots are dropped.  One sharded training step on the 2 x 2 mesh
per mode (``ep``, ``ep_a2a``, ``tp``) is held against the reference's
single-device step with the reference's configuration and tolerances
(``tests/test_sharding.py:240-270``: learning rate 1e-3 with the default
warmup, so the first step moves no parameter; loss 5e-4 relative, for the
load-balance loss is estimated per rank's slab; parameters 1e-4
absolute).  The step's gradients are held tighter with the auxiliary
losses off, where the sharded step must give the single-device numbers up
to float32 sums in other orders: loss and grad norm 1e-5 relative, the
AdamW first moments (a tenth of the clipped gradients) 1e-4 relative over
a floor of 1e-4 times each leaf's scale, as ``tests/test_torch_train.py``
holds the gradients.  These steps run the configs' default checkpoint
plan, ``"none"``, so every rank reruns its exchanges in the backward's
recompute; one more ``ep_a2a`` step under ``"paper"`` (the tagged
projections kept, the rest recomputed) is held to the same gradients, as
is one ``ep`` step under ``"full"`` (no region: the backward gathers the
leaves the products saved again), and
one with two microbatches (the gradients accumulated over them, then
summed over the data axis once) to the reference's single-device step
with two microbatches (``tests/test_sharding.py:243-260``).
The validation errors need no ranks.

The JAX oracles run in this process; the ranks get numpy arrays.  Each
mesh is one spawn that runs all of its cases.
"""

import dataclasses
import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker
from repro.configs import get_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import transformer as JT
from repro.models.moe_block import moe_sublayer as j_moe_sublayer
from repro.train.loop import make_train_step as j_make_train_step
from repro.train.optimizer import init_adamw as j_init_adamw
from torch_parity import as_dtype, np_params, torch_config
from torch_parity import tp  # noqa: F401

MOE_CFG = get_config("mixtral_8x7b").reduced().replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    num_experts=4, top_k=2, moe_d_ff=64, vocab_size=128, sliding_window=16,
    attn_chunk=16)
B, S, D = 4, 16, MOE_CFG.d_model
_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
        "bfloat16": dict(rtol=5e-2, atol=5e-2)}
DTYPES = ("float32", "bfloat16")
BACKENDS = ("segment", "pallas")
# case name -> (moe_parallel, extra config fields)
FLAT_MODES = {"ep": ("ep", {}), "ep_a2a": ("ep_a2a", {}),
              "ep_a2a_chunks2": ("ep_a2a", {"moe_a2a_chunks": 2}),
              "tp": ("tp", {}),
              "ep_kernels": ("ep", {"moe_impl": "blaze_pallas"})}
TRAIN_MODES = ("ep", "ep_a2a", "tp", "auto")
TIGHT = 0.25
# ServeEngine under the (1, 2) mesh: requests, budget and pool
SERVE_PROMPTS = ((5, 17, 99, 3, 42, 7, 61), (88, 1, 12, 30), (9,) * 11)
SERVE_NEW, SERVE_CAPACITY = 6, 32
SERVE_MODES = ("ep", "ep_a2a", "auto")
# a reduced config whose vocabulary divides over no axis of the 2 x 2 mesh
ODD = dict(vocab_size=127)


def _inputs(dtype: str):
    """x (B, S, d) and the MoE weights at the reference's init scales,
    drawn with numpy and rounded to ``dtype``."""
    rng = np.random.default_rng(4)
    E, h = MOE_CFG.num_experts, MOE_CFG.moe_d_ff
    p = {"wg": rng.normal(size=(D, E)) / math.sqrt(D),
         "w1": rng.normal(size=(E, D, h)) / math.sqrt(D),
         "w2": rng.normal(size=(E, D, h)) / math.sqrt(D),
         "w3": rng.normal(size=(E, h, D)) / math.sqrt(h)}
    x = rng.normal(size=(B, S, D))
    return as_dtype(x, dtype), {k: as_dtype(v, dtype) for k, v in p.items()}


def _jcfg(dtype, backend="segment", mode="auto", **kw):
    return MOE_CFG.replace(dtype=dtype, param_dtype=dtype,
                           gmm_backend=backend, moe_parallel=mode,
                           moe_a2a_capacity=8.0, **kw)


def _wire(a):
    """numpy array for a rank: bfloat16 as its uint16 bit pattern."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _layer_case(dtype, backend, mode, **kw):
    x, p = _inputs(dtype)
    cfg = _jcfg(dtype, backend, mode, **kw)
    return {"kind": "layer", "cfg": dataclasses.asdict(cfg), "x": _wire(x),
            "p": {k: _wire(v) for k, v in p.items()}}


def _spawn(workdir, sizes, names, cases) -> list[dict]:
    """Run ``cases`` on ``prod(sizes)`` spawned gloo ranks; returns each
    rank's results.  A rank that fails fails the spawn."""
    import torch.multiprocessing as mp
    (workdir / "job.pkl").write_bytes(pickle.dumps(
        {"sizes": sizes, "names": names, "cases": cases}))
    world = math.prod(sizes)
    mp.start_processes(torch_dist_worker.run, args=(world, str(workdir)),
                       nprocs=world, join=True, start_method="spawn")
    return [pickle.loads((workdir / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def _flat_cases():
    return {f"{name}/{backend}/{dtype}": _layer_case(dtype, backend, mode,
                                                     **kw)
            for name, (mode, kw) in FLAT_MODES.items()
            for backend in BACKENDS for dtype in DTYPES}


@pytest.fixture(scope="module")
def oracle():
    """The single-device JAX layer: y and the gradients of mean(y**2)
    with respect to x and the weights, per dtype (float32 numpy)."""
    out = {}
    for dtype in DTYPES:
        x, p = _inputs(dtype)
        cfg = _jcfg(dtype)
        xj = jnp.asarray(x)
        pj = {k: jnp.asarray(v) for k, v in p.items()}

        def loss(x_, p_):
            y, _ = j_moe_sublayer(x_, p_, cfg, mesh=None)
            return (y.astype(jnp.float32) ** 2).mean()

        y, _ = j_moe_sublayer(xj, pj, cfg, mesh=None)
        gx, gp = jax.grad(loss, argnums=(0, 1))(xj, pj)
        f = lambda a: np.asarray(a, np.float32)
        out[dtype] = {"y": f(y), "dx": f(gx),
                      "grads": {k: f(v) for k, v in gp.items()}}
    return out


def _train_batch():
    rng = np.random.default_rng(2)
    toks = rng.integers(0, MOE_CFG.vocab_size, size=(8, 32)).astype(np.int32)
    return {"tokens": toks, "labels": toks}


TCFG = dict(learning_rate=1e-3, batch_size=8, seq_len=32)
TCFG_MB2 = dict(TCFG, num_microbatches=2)
# the reference's configuration, and the same without the auxiliary losses
TRAIN_CFGS = {"train": MOE_CFG,
              "train_noaux": MOE_CFG.replace(aux_loss_weight=0.0,
                                             z_loss_weight=0.0)}


@pytest.fixture(scope="module")
def jtrain():
    """The reference's single-device training step (float32) for each of
    ``TRAIN_CFGS``."""
    params = JT.init_params(jax.random.PRNGKey(0), MOE_CFG)
    batch = _train_batch()
    out = {"params": np_params(params), "batch": batch}
    for name, cfg in TRAIN_CFGS.items():
        p1, o1, m1 = jax.jit(j_make_train_step(cfg, JTrainConfig(**TCFG)))(
            params, j_init_adamw(params),
            {k: jnp.asarray(v) for k, v in batch.items()})
        out[name] = {"p1": np_params(jax.device_get(p1)),
                     "mu": np_params(jax.device_get(o1.mu)),
                     "metrics": {k: float(m1[k])
                                 for k in ("loss", "grad_norm")}}
    # two microbatches (tests/test_sharding.py:243-260)
    p1, o1, m1 = jax.jit(j_make_train_step(
        TRAIN_CFGS["train_noaux"], JTrainConfig(**TCFG_MB2)))(
        params, j_init_adamw(params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    out["train_noaux_mb2"] = {
        "mu": np_params(jax.device_get(o1.mu)),
        "metrics": {k: float(m1[k]) for k in ("loss", "grad_norm")}}
    return out


def _whole_ckpt(tp, path, params_np):
    """A checkpoint written without a mesh: the parameters and an AdamW
    state of seeded moments at step 5; returns the trees as numpy."""
    torch = tp.torch
    from repro_torch.train.checkpointing import save_checkpoint
    from repro_torch.train.optimizer import AdamWState, tree_leaves
    params = _port_tree(tp, params_np)
    gen = torch.Generator().manual_seed(9)
    leaves = tree_leaves(params)
    mu = [torch.randn(t.shape, generator=gen) for t in leaves]
    nu = [torch.rand(t.shape, generator=gen) for t in leaves]
    save_checkpoint(str(path), 5, params, AdamWState(step=5, mu=mu, nu=nu))
    as_np = lambda ts: [t.numpy() for t in ts]
    return {"params": [t.numpy() for t in leaves], "mu": as_np(mu),
            "nu": as_np(nu), "step": 5}


@pytest.fixture(scope="module")
def flat12(tmp_path_factory, tp, jtrain):
    work = tmp_path_factory.mktemp("mesh12")
    cases = _flat_cases()
    cfg = dataclasses.asdict(torch_config(MOE_CFG))
    written = _whole_ckpt(tp, work / "ck_in", jtrain["params"])
    cases["ckpt"] = {"kind": "ckpt", "cfg": cfg, "tcfg": TCFG,
                     "params": jtrain["params"], "batch": jtrain["batch"],
                     "in": str(work / "ck_in"), "out": str(work / "ck_out")}
    cases["held"] = {"kind": "held", "cfg": dict(cfg, moe_parallel="ep"),
                     "tcfg": TCFG, "params": jtrain["params"],
                     "batch": {k: v[:2] for k, v in jtrain["batch"].items()}}
    for mode in SERVE_MODES:
        cases[f"serve/{mode}"] = {
            "kind": "serve", "cfg": dict(cfg, moe_parallel=mode),
            "params": jtrain["params"], "prompts": SERVE_PROMPTS,
            "max_new": SERVE_NEW, "capacity": SERVE_CAPACITY, "slots": 4}
    ranks = _spawn(work, (1, 2), ("data", "model"), cases)
    return {"ranks": ranks, "work": work, "written": written}


@pytest.fixture(scope="module")
def flat22(tmp_path_factory, jtrain):
    cases = _flat_cases()
    cases["tight"] = _layer_case("float32", "segment", "ep_a2a")
    cases["tight"]["cfg"]["moe_a2a_capacity"] = TIGHT
    for name, jcfg in TRAIN_CFGS.items():
        for mode in TRAIN_MODES:
            cfg = torch_config(jcfg).replace(moe_parallel=mode)
            cases[f"{name}/{mode}"] = {
                "kind": "train", "cfg": dataclasses.asdict(cfg),
                "tcfg": TCFG, "params": jtrain["params"],
                "batch": jtrain["batch"]}
    cfg = torch_config(TRAIN_CFGS["train_noaux"]).replace(
        moe_parallel="ep_a2a", remat_policy="paper")
    cases["train_noaux/ep_a2a/paper"] = {
        "kind": "train", "cfg": dataclasses.asdict(cfg), "tcfg": TCFG,
        "params": jtrain["params"], "batch": jtrain["batch"]}
    cfg = torch_config(TRAIN_CFGS["train_noaux"]).replace(
        moe_parallel="ep", remat_policy="full")
    cases["train_noaux/ep/full"] = {
        "kind": "train", "cfg": dataclasses.asdict(cfg), "tcfg": TCFG,
        "params": jtrain["params"], "batch": jtrain["batch"]}
    cfg = torch_config(TRAIN_CFGS["train_noaux"]).replace(
        moe_parallel="ep_a2a")
    cases["train_noaux/ep_a2a/mb2"] = {
        "kind": "train", "cfg": dataclasses.asdict(cfg), "tcfg": TCFG_MB2,
        "params": jtrain["params"], "batch": jtrain["batch"]}
    cases["odd/auto"] = {"kind": "train", "cfg": dataclasses.asdict(
        torch_config(MOE_CFG.replace(**ODD))), "tcfg": TCFG,
        "params": np_params(JT.init_params(jax.random.PRNGKey(1),
                                           MOE_CFG.replace(**ODD))),
        "batch": {k: v % ODD["vocab_size"]
                  for k, v in jtrain["batch"].items()},
        "steps": 3, "local": True}
    return _spawn(tmp_path_factory.mktemp("mesh22"), (2, 2),
                  ("data", "model"), cases)


@pytest.fixture(scope="module")
def node122(tmp_path_factory):
    cases = {f"hier/{backend}/{dtype}": _layer_case(dtype, backend,
                                                    "ep_a2a_hier")
             for backend in BACKENDS for dtype in DTYPES}
    return _spawn(tmp_path_factory.mktemp("mesh122"), (1, 2, 2),
                  ("data", "node", "model"), cases)


def _check_layer(ranks, name, ref, dtype):
    tol = _TOL[dtype]
    for r, res in enumerate(ranks):
        got = res[name]
        lo, rows = got["lo"], got["y"].shape[0]
        msg = f"{name} rank {r}"
        np.testing.assert_allclose(got["y"], ref["y"][lo:lo + rows], **tol,
                                   err_msg=f"y {msg}")
        np.testing.assert_allclose(got["dx"], ref["dx"][lo:lo + rows], **tol,
                                   err_msg=f"dx {msg}")
        for k, g in ref["grads"].items():
            np.testing.assert_allclose(got["grads"][k], g, **tol,
                                       err_msg=f"d{k} {msg}")
        assert got["overflow"] == 0.0, msg       # ample capacity


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", list(FLAT_MODES))
@pytest.mark.parametrize("mesh", ["flat12", "flat22"])
def test_mode_matches_single_device(request, oracle, mesh, mode, backend,
                                    dtype):
    ranks = request.getfixturevalue(mesh)
    ranks = ranks["ranks"] if mesh == "flat12" else ranks
    _check_layer(ranks, f"{mode}/{backend}/{dtype}", oracle[dtype], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_hier_matches_single_device(node122, oracle, backend, dtype):
    _check_layer(node122, f"hier/{backend}/{dtype}", oracle[dtype], dtype)


def test_tight_capacity_drops_the_reference_slots(flat22):
    """ep_a2a at capacity 0.25 against the reference's ep_a2a under a JAX
    (2, 2) mesh: the same output (so the same slots dropped) and the same
    overflow share, which must be positive."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 host devices")
    from jax.sharding import Mesh as JMesh
    jmesh = JMesh(np.array(jax.devices()[:4]).reshape(2, 2),
                  ("data", "model"))
    x, p = _inputs("float32")
    cfg = _jcfg("float32", "segment", "ep_a2a").replace(
        moe_a2a_capacity=TIGHT)
    with jmesh:
        y, _, st = jax.jit(lambda x_, p_: j_moe_sublayer(
            x_, p_, cfg, mesh=jmesh, dp_axes=("data",),
            with_stats=True))(jnp.asarray(x),
                              {k: jnp.asarray(v) for k, v in p.items()})
    y = np.asarray(y, np.float32)
    ref_over = float(st["a2a_overflow"])
    assert ref_over > 0.0
    for r, res in enumerate(flat22):
        got = res["tight"]
        lo, rows = got["lo"], got["y"].shape[0]
        np.testing.assert_allclose(got["y"], y[lo:lo + rows],
                                   **_TOL["float32"], err_msg=f"rank {r}")
        np.testing.assert_allclose(got["overflow"], ref_over,
                                   **_TOL["float32"], err_msg=f"rank {r}")


def _walk(a, b, fn, path=""):
    if isinstance(b, dict):
        for k in b:
            _walk(a[k], b[k], fn, f"{path}/{k}")
    elif isinstance(b, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _walk(x, y, fn, f"{path}/{i}")
    else:
        fn(a, b, path)


def _port_tree(tp, np_tree):
    return tp.interop.params_from_jax(np_tree, torch_config(MOE_CFG),
                                      device="cpu", dtype=tp.torch.float32)


def _same_metrics(ranks, name):
    """Every rank reports the same metrics."""
    for res in ranks[1:]:
        assert res[name]["metrics"] == ranks[0][name]["metrics"]


def _want_mode(mode: str, tokens: int) -> str:
    """The mode a step on the 2 x 2 mesh runs: a forced one, or the one
    the port's cost model gives ``auto`` at the per-rank slab."""
    if mode != "auto":
        return mode
    from repro_torch.roofline import select_moe_parallel
    return select_moe_parallel(torch_config(MOE_CFG),
                               _FakeMesh(data=2, model=2), tokens).mode


@pytest.mark.parametrize("mode", TRAIN_MODES)
def test_sharded_train_step_matches_reference(tp, flat22, jtrain, mode):
    """The FSDP step (each rank holding its blocks of the parameters and
    moments) against the reference's single-device step, at the
    reference's tolerances (tests/test_sharding.py:264-270)."""
    ref = jtrain["train"]
    want = _port_tree(tp, ref["p1"])
    for r, res in enumerate(flat22):
        got = res[f"train/{mode}"]
        assert got["mode"] == _want_mode(mode, 4 * 32)
        np.testing.assert_allclose(got["metrics"]["loss"],
                                   ref["metrics"]["loss"], rtol=5e-4,
                                   err_msg=f"rank {r}")
        _walk(got["params"], want, lambda a, b, path: (
            np.testing.assert_allclose(a, b.numpy(), atol=1e-4,
                                       err_msg=f"{path} rank {r}")))
    _same_metrics(flat22, f"train/{mode}")


@pytest.mark.parametrize("mode", TRAIN_MODES + ("ep_a2a/paper",
                                                 "ep_a2a/mb2", "ep/full"))
def test_sharded_train_step_gradients_match_reference(tp, flat22, jtrain,
                                                      mode):
    ref = jtrain["train_noaux_mb2" if mode.endswith("/mb2")
                 else "train_noaux"]
    want = _port_tree(tp, ref["mu"])

    def close(a, b, path):
        b = b.numpy()
        scale = float(np.abs(b).max())
        assert np.all(np.abs(a - b) <= 1e-4 * (np.abs(b) + scale)), path

    for r, res in enumerate(flat22):
        got = res[f"train_noaux/{mode}"]
        assert got["plan"] == {"paper": "paper", "full": "full"}.get(
            mode.split("/")[-1], "none")
        assert got["mode"] == _want_mode(mode.split("/")[0],
                                         (2 if mode.endswith("/mb2")
                                          else 4) * 32)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k],
                                       rtol=1e-5, err_msg=f"{k} rank {r}")
        _walk(got["mu"], want, close)
    _same_metrics(flat22, f"train_noaux/{mode}")


class _FakeMesh:
    """Axis names and sizes only: the validation runs before any
    collective."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)

    def axis_size(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        return math.prod(self.shape[a] for a in axes)


def test_validation_errors(tp):
    from repro_torch.configs import TrainConfig
    from repro_torch.models.moe_block import (moe_sublayer,
                                              resolve_moe_parallel)
    from repro_torch.train.loop import make_train_step
    flat, node = _FakeMesh(data=2, model=4), _FakeMesh(data=1, node=2,
                                                       model=2)
    cfg = torch_config(MOE_CFG)
    bad = cfg.replace(num_experts=6, moe_parallel="ep")
    with pytest.raises(ValueError, match="divisible"):
        resolve_moe_parallel(bad, flat)
    with pytest.raises(ValueError, match="divisible"):
        make_train_step(bad, TrainConfig(), "cpu", mesh=flat)
    with pytest.raises(ValueError, match="node"):
        resolve_moe_parallel(cfg.replace(moe_parallel="ep_a2a"), node)
    with pytest.raises(ValueError, match="node"):
        resolve_moe_parallel(cfg.replace(moe_parallel="ep_a2a_hier"), flat)
    with pytest.raises(ValueError, match="tokens/device"):
        moe_sublayer(tp.torch.zeros(2, 15, D), {},
                     cfg.replace(moe_parallel="ep_a2a"), mesh=flat)
    # auto never raises: it falls back to tp for an awkward expert count
    assert resolve_moe_parallel(bad.replace(moe_parallel="auto"),
                                flat) == "tp"
    assert resolve_moe_parallel(cfg, flat) in ("ep", "ep_a2a", "tp")
    assert resolve_moe_parallel(cfg, None) == "single"
    # the engine validates the pairing at construction, after turning
    # ep_a2a into ep (tests/test_sharding.py:151-165)
    from repro_torch.serve.engine import ServeEngine
    with pytest.raises(ValueError, match="divisible"):
        ServeEngine(bad.replace(moe_parallel="ep_a2a"), {}, device="cpu",
                    mesh=flat)


def test_init_distributed_backend_choice(tp, monkeypatch):
    """NCCL with a card per rank is the only setup inferred on the card:
    more ranks than cards raise unless gloo is asked for by name; the CPU
    takes gloo only.  Every case raises before a process group starts."""
    from repro_torch.launch import mesh as MESH
    torch = tp.torch
    with pytest.raises(ValueError, match="CPU runs gloo"):
        MESH.init_distributed("cpu", backend="nccl")
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        MESH.init_distributed("cpu", backend="mpi")
    monkeypatch.setattr(MESH, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="2 ranks on this host but 1"):
        MESH.init_distributed()
    with pytest.raises(RuntimeError, match="NCCL needs a card per rank"):
        MESH.init_distributed(backend="nccl")
    assert not torch.distributed.is_initialized()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _spec_shapes(cfg, mode):
    """Leaf path -> the block shape ``param_specs`` gives a rank of the
    2 x 2 mesh under ``mode``."""
    from repro_torch import sharding as SH
    from repro_torch.interop import param_shapes
    mesh = _FakeMesh(data=2, model=2)
    shapes = param_shapes(cfg)
    specs = SH.param_specs(shapes, mesh, fsdp=True, moe_parallel=mode)
    out = {}
    for path, shape in torch_dist_worker._paths(shapes).items():
        spec = SH._at(specs, path.split("/"))
        out[path] = tuple(n // (mesh.axis_size(ax) if ax else 1)
                          for n, ax in zip(shape, spec))
    return out


@pytest.mark.parametrize("case", ["train/ep", "train/tp", "train/auto",
                                  "odd/auto"])
def test_fsdp_blocks_have_the_spec_shapes(tp, flat22, case):
    """Each rank holds exactly its blocks under ``param_specs(...,
    fsdp=True, moe_parallel=<the step's mode>)``: a quarter of a leaf split
    over both axes, half of one split over one, the whole of a dimension
    that divides over no axis (the odd vocabulary's rows)."""
    jcfg = MOE_CFG.replace(**ODD) if case.startswith("odd") else MOE_CFG
    cfg = torch_config(jcfg)
    for r, res in enumerate(flat22):
        got = res[case]
        want = _spec_shapes(cfg, got["mode"])
        assert got["shapes"] == want, f"rank {r}"
    whole = dict(torch_dist_worker._paths(
        __import__("repro_torch.interop", fromlist=["x"]).param_shapes(cfg)))
    mine = flat22[0][case]["shapes"]
    split = [k for k in mine if mine[k] != whole[k]]
    assert "layers/0/attn/wq" in split and "embed" in split
    if case.startswith("odd"):
        # (127, 64): the rows divide over no axis, the columns over 'data'
        assert mine["embed"] == (127, 32)
        assert mine["unembed"] == (32, 127)
    held = sum(np.prod(v) for v in mine.values())
    assert held < 0.4 * sum(np.prod(v) for v in whole.values())


def test_replicated_blocks_bit_equal_after_three_steps(flat22):
    """Three FSDP steps on the odd-vocabulary config under ``auto``: every
    two ranks that hold the same block of a leaf (the same coordinates on
    the axes it is split over; every rank for a whole leaf) hold it bit for
    bit, and every rank reports the same metrics."""
    from repro_torch import sharding as SH
    cfg = torch_config(MOE_CFG.replace(**ODD))
    from repro_torch.interop import param_shapes
    mesh = _FakeMesh(data=2, model=2)
    mode = flat22[0]["odd/auto"]["mode"]
    specs = SH.param_specs(param_shapes(cfg), mesh, fsdp=True,
                           moe_parallel=mode)
    checked = 0
    for path, a in flat22[0]["odd/auto"]["local"].items():
        spec = SH._at(specs, path.split("/"))
        axes = {x for ax in spec if ax for x in
                (ax if isinstance(ax, tuple) else (ax,))}
        groups = {}
        for res in flat22:
            got = res["odd/auto"]
            key = tuple(got["coords"][x] for x in sorted(axes))
            groups.setdefault(key, []).append(got["local"][path])
        for blocks in groups.values():
            for b in blocks[1:]:
                assert np.array_equal(b, blocks[0]), path
                checked += 1
    assert checked > 0
    _same_metrics(flat22, "odd/auto")


def test_checkpoint_under_a_mesh_round_trips(tp, flat12, jtrain):
    """Saved under the (1, 2) mesh, a checkpoint restores without a mesh
    to the tree the ranks gather, exactly; a checkpoint written without a
    mesh restores under it to the tree written, exactly."""
    from repro_torch.train.checkpointing import restore_checkpoint
    from repro_torch.train.optimizer import init_adamw, tree_leaves
    ranks = flat12["ranks"]
    tmpl = _port_tree(tp, jtrain["params"])
    step, p, o = restore_checkpoint(str(flat12["work"] / "ck_out"), tmpl,
                                    init_adamw(tmpl))
    assert step == 1 and o.step == 1
    for r, res in enumerate(ranks):
        saved = res["ckpt"]["saved"]
        assert saved["step"] == 1
        for a, b in zip(tree_leaves(p), _leaves(saved["params"])):
            assert np.array_equal(a.numpy(), b), f"params rank {r}"
        for name, got in (("mu", o.mu), ("nu", o.nu)):
            for a, b in zip(got, _leaves(saved[name])):
                assert np.array_equal(a.numpy(), b), f"{name} rank {r}"
        back = res["ckpt"]["restored"]
        written = flat12["written"]
        assert back["step"] == written["step"]
        for name in ("params", "mu", "nu"):
            for a, b in zip(_leaves(back[name]), written[name]):
                assert np.array_equal(a, b), f"restored {name} rank {r}"
    assert ranks[0]["ckpt"]["shapes"]["layers/0/moe/w1"][0] * 2 == \
        MOE_CFG.num_experts or ranks[0]["ckpt"]["shapes"][
            "layers/0/moe/w1"][2] * 2 == MOE_CFG.moe_d_ff


@pytest.fixture(scope="module")
def greedy_ref(jtrain):
    """The reference model's greedy continuation of the serving prompts
    (float32, the same weights)."""
    from torch_parity import greedy_continuation
    params = jax.tree.map(jnp.asarray, jtrain["params"])
    return greedy_continuation(params, MOE_CFG, SERVE_PROMPTS, SERVE_NEW,
                               SERVE_CAPACITY)


@pytest.mark.parametrize("mode", SERVE_MODES)
def test_serve_engine_under_a_mesh(flat12, greedy_ref, mode):
    """``ServeEngine(mesh=...)`` on the (1, 2) mesh: every rank's greedy
    float32 tokens equal the reference model's greedy continuation of the
    same weights (the port's engines are held to it, not to the
    reference engine's run-to-run tokens: ROADMAP.md §C); ``ep_a2a``
    serves as ``ep`` (tests/test_sharding.py:168), ``auto`` stays ``auto``
    and resolves per slab (``ep`` at the decode slab of 4 rows, ``tp`` at
    the prefill slabs of 16 rows and more: the engine lays the experts
    out for both); the experts are split over 'model'."""
    want_mode = {"ep_a2a": "ep"}.get(mode, mode)
    for r, res in enumerate(flat12["ranks"]):
        got = res[f"serve/{mode}"]
        assert got["mode"] == want_mode, f"rank {r}"
        assert got["layouts"] == (["ep", "tp"] if mode == "auto"
                                  else ["ep"]), f"rank {r}"
        assert got["w1"] == (MOE_CFG.num_experts // 2, MOE_CFG.d_model,
                             MOE_CFG.moe_d_ff)
        assert got["tokens"] == [list(t) for t in greedy_ref], f"rank {r}"


def test_fsdp_forward_holds_no_gathered_leaf(flat12):
    """Under every plan the FSDP forward's graph holds exactly what the
    same forward holds with the dense leaves whole and no gather: inside a
    checkpoint region (``"none"``) the recompute gathers a layer's leaves
    again, and outside one (the head, and every layer under ``"full"``)
    autograd saves a gathered leaf as its shard and the backward gathers
    it again (``collectives.regather_saved``).  The gathered leaves are
    not empty: the layers' and the head's whole values are larger than
    the rank's blocks."""
    for r, res in enumerate(flat12["ranks"]):
        held = res["held"]
        assert held["gathered"] > 0 and held["head"] > 0, (r, held)
        for plan in ("none", "full"):
            assert held[plan]["fsdp"] == held[plan]["whole"], (r, plan, held)
