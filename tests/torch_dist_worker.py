"""The rank program of ``tests/test_torch_distributed.py``.

Spawned ranks import torch and the port, never JAX: the test computes the
JAX oracle in its own process and hands each rank a job of numpy arrays
(``job.pkl``); each rank writes its results, as numpy, to
``rank<r>.pkl`` in the same directory.  The process group is gloo on the
CPU, initialised through a file store in that directory, so parallel test
workers never share a port.
"""

from __future__ import annotations

import os
import pickle
from datetime import timedelta
from pathlib import Path

import numpy as np


def _tensor(a, dtype=None):
    import torch
    a = np.array(a, copy=True)
    if a.dtype == np.uint16:                 # bfloat16 bit pattern
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(a)
    return t if dtype is None else t.to(dtype)


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


def layer_case(mesh, case: dict) -> dict:
    """``moe_sublayer`` on this rank's slab; the gradients of the global
    ``mean(y**2)``, summed over the data axes and gathered whole."""
    import torch

    from repro_torch import sharding as SH
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.collectives import all_reduce_
    from repro_torch.models.moe_block import moe_sublayer

    cfg = ModelConfig(**case["cfg"])
    x = _tensor(case["x"])
    B, S, d = x.shape
    p = {k: _tensor(v) for k, v in case["p"].items()}
    dp = SH.batch_axes(mesh, B)
    rows = B // (mesh.axis_size(dp) if dp else 1)
    lo = (mesh.flat_index(dp) if dp else 0) * rows
    xl = x[lo:lo + rows].clone().requires_grad_(True)
    pl = SH.local_params({"moe": p}, mesh, cfg.moe_parallel)["moe"]
    names = sorted(pl)
    for k in names:
        pl[k].requires_grad_(True)
    y, aux, stats = moe_sublayer(xl, pl, cfg, mesh=mesh, dp_axes=dp,
                                 with_stats=True)
    loss = (y.float() ** 2).sum() / float(B * S * d)
    grads = torch.autograd.grad(loss, [xl] + [pl[k] for k in names])
    gp = dict(zip(names, grads[1:]))
    if dp:
        for g in gp.values():
            all_reduce_(g, mesh.group(dp))
    whole = SH.gather_params({"moe": gp}, mesh, cfg.moe_parallel)["moe"]
    return {"lo": lo, "y": _np(y), "dx": _np(grads[0]),
            "grads": {k: _np(v) for k, v in whole.items()},
            "aux": float(aux), "overflow": float(stats["a2a_overflow"])}


def train_case(mesh, case: dict) -> dict:
    """One sharded training step from the whole parameters; returns the
    metrics and the updated parameters gathered whole."""
    import torch

    from repro_torch import sharding as SH
    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.interop import params_from_jax
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import init_adamw

    cfg = ModelConfig(**case["cfg"])
    tcfg = TrainConfig(**case["tcfg"])
    params = params_from_jax(case["params"], cfg, device="cpu",
                             dtype=torch.float32)
    step = make_train_step(cfg, tcfg, "cpu", mesh=mesh)
    local = SH.local_params(params, mesh, step.moe_parallel)
    local, opt, m = step(local, init_adamw(local), case["batch"])
    mu = iter(opt.mu)
    mu = _tree(local, lambda _: next(mu))
    gather = lambda t: _tree(SH.gather_params(t, mesh, step.moe_parallel),
                             _np)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": gather(local), "mu": gather(mu),
            "mode": step.moe_parallel, "plan": step.resolved_plan.spec}


CASES = {"layer": layer_case, "train": train_case}


def run(rank: int, world: int, workdir: str) -> None:
    """Entry point of one spawned rank."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh, init_distributed

    torch.set_num_threads(1)
    work = Path(workdir)
    job = pickle.loads((work / "job.pkl").read_bytes())
    init_distributed("cpu", init_method=f"file://{work / 'store'}",
                     timeout=timedelta(seconds=120))
    mesh = Mesh(job["sizes"], job["names"])
    out = {name: CASES[case["kind"]](mesh, case)
           for name, case in job["cases"].items()}
    (work / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    dist.destroy_process_group()
