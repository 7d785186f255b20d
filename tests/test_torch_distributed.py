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
projections kept, the rest recomputed) is held to the same gradients, and
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
              "tp": ("tp", {})}
TRAIN_MODES = ("ep", "ep_a2a", "tp")
TIGHT = 0.25


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


@pytest.fixture(scope="module")
def flat12(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("mesh12"), (1, 2),
                  ("data", "model"), _flat_cases())


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
        moe_parallel="ep_a2a")
    cases["train_noaux/ep_a2a/mb2"] = {
        "kind": "train", "cfg": dataclasses.asdict(cfg), "tcfg": TCFG_MB2,
        "params": jtrain["params"], "batch": jtrain["batch"]}
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
    _check_layer(request.getfixturevalue(mesh), f"{mode}/{backend}/{dtype}",
                 oracle[dtype], dtype)


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


@pytest.mark.parametrize("mode", TRAIN_MODES)
def test_sharded_train_step_matches_reference(tp, flat22, jtrain, mode):
    ref = jtrain["train"]
    want = _port_tree(tp, ref["p1"])
    for r, res in enumerate(flat22):
        got = res[f"train/{mode}"]
        assert got["mode"] == mode
        np.testing.assert_allclose(got["metrics"]["loss"],
                                   ref["metrics"]["loss"], rtol=5e-4,
                                   err_msg=f"rank {r}")
        _walk(got["params"], want, lambda a, b, path: (
            np.testing.assert_allclose(a, b.numpy(), atol=1e-4,
                                       err_msg=f"{path} rank {r}")))
    _same_metrics(flat22, f"train/{mode}")


@pytest.mark.parametrize("mode", TRAIN_MODES + ("ep_a2a/paper",
                                                 "ep_a2a/mb2"))
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
        assert got["plan"] == ("paper" if mode.endswith("/paper")
                               else "none")
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
    with pytest.raises(NotImplementedError, match="roofline"):
        resolve_moe_parallel(cfg, flat)
    assert resolve_moe_parallel(cfg, None) == "single"
    from repro_torch.serve.engine import ServeEngine
    with pytest.raises(NotImplementedError, match="mesh"):
        ServeEngine(cfg, {}, device="cpu", mesh=flat)


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
