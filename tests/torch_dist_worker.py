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
    whole = SH.gather_params({"moe": gp}, mesh, SH.moe_specs(
        {"moe": gp}, mesh, cfg.moe_parallel))["moe"]
    return {"lo": lo, "y": _np(y), "dx": _np(grads[0]),
            "grads": {k: _np(v) for k, v in whole.items()},
            "aux": float(aux), "overflow": float(stats["a2a_overflow"])}


def _paths(tree, prefix=""):
    """Leaf path -> leaf."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _paths(v, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _paths(v, f"{prefix}{i}/").items()}
    return {prefix.rstrip("/"): tree}


def _moments(local, opt):
    mu, nu = iter(opt.mu), iter(opt.nu)
    return (_tree(local, lambda _: next(mu)), _tree(local, lambda _: next(nu)))


def train_case(mesh, case: dict) -> dict:
    """``case["steps"]`` (default 1) FSDP training steps from the whole
    parameters, each rank holding its blocks under the step's
    ``param_specs``; returns the first step's metrics, the parameters and
    first moments gathered whole, and this rank's blocks (their shapes,
    with ``local`` the blocks themselves and the rank's coordinates)."""
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
    local = SH.shard_params(params, mesh, step.param_specs)
    opt = init_adamw(local)
    first = None
    for _ in range(case.get("steps", 1)):
        local, opt, m = step(local, opt, case["batch"])
        first = first or {k: float(v) for k, v in m.items()}
    mu, _ = _moments(local, opt)
    gather = lambda t: _tree(SH.gather_params(t, mesh, step.param_specs),
                             _np)
    out = {"metrics": first, "params": gather(local), "mu": gather(mu),
           "mode": step.moe_parallel, "plan": step.resolved_plan.spec,
           "shapes": {k: tuple(v.shape) for k, v in _paths(local).items()}}
    if case.get("local"):
        out["local"] = {k: v.detach().numpy().copy()
                        for k, v in _paths(local).items()}
        out["coords"] = {a: mesh.axis_index(a) for a in mesh.axis_names}
    return out


def ckpt_case(mesh, case: dict) -> dict:
    """A checkpoint under the mesh both ways: one FSDP step, saved under
    the mesh to ``case["out"]`` (returned gathered whole); and the whole
    checkpoint at ``case["in"]`` restored under the mesh (returned
    gathered whole)."""
    import torch

    from repro_torch import sharding as SH
    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.interop import params_from_jax
    from repro_torch.train.checkpointing import (restore_checkpoint,
                                                 save_checkpoint)
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import init_adamw

    cfg = ModelConfig(**case["cfg"])
    params = params_from_jax(case["params"], cfg, device="cpu",
                             dtype=torch.float32)
    step = make_train_step(cfg, TrainConfig(**case["tcfg"]), "cpu",
                           mesh=mesh)
    specs = step.param_specs
    local = SH.shard_params(params, mesh, specs)
    local, opt, _ = step(local, init_adamw(local), case["batch"])
    save_checkpoint(case["out"], 1, local, opt, mesh=mesh, specs=specs)

    def whole(p, o):
        mu, nu = _moments(p, o)
        g = lambda t: _tree(SH.gather_params(t, mesh, specs), _np)
        return {"params": g(p), "mu": g(mu), "nu": g(nu), "step": o.step}

    tmpl = SH.shard_params(params, mesh, specs)
    _, rp, ro = restore_checkpoint(case["in"], tmpl, init_adamw(tmpl),
                                   mesh=mesh, specs=specs)
    return {"saved": whole(local, opt), "restored": whole(rp, ro),
            "shapes": {k: tuple(v.shape) for k, v in _paths(rp).items()}}


def serve_case(mesh, case: dict) -> dict:
    """``ServeEngine(mesh=...)`` on the whole weights: greedy tokens of
    every request, the engine's mode, the expert layouts it made and this
    rank's expert shard."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.interop import params_from_jax
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = ModelConfig(**case["cfg"])
    params = params_from_jax(case["params"], cfg, device="cpu")
    eng = ServeEngine(cfg, params, device="cpu", mesh=mesh,
                      batch_slots=case["slots"], capacity=case["capacity"],
                      page_size=8)
    reqs = [Request(prompt=np.asarray(p, np.int32),
                    max_new_tokens=case["max_new"], eos_id=-1)
            for p in case["prompts"]]
    eng.generate(reqs)
    return {"tokens": [list(r.out_tokens) for r in reqs],
            "mode": eng.cfg.moe_parallel, "layouts": sorted(eng._layouts),
            "w1": tuple(eng.params["layers"][0]["moe"]["w1"].shape)}


def held_case(mesh, case: dict) -> dict:
    """Bytes the training forward's graph holds for its backward, with the
    FSDP gathers and with every dense leaf whole (the serving layout, no
    gather), under the checkpoint plans ``"none"`` and ``"full"``; the
    bytes of the whole values of the layers' leaves the FSDP forward
    gathers, and of the head's (``unembed``)."""
    import torch

    from repro_torch import sharding as SH
    from repro_torch.compat import saved_residual_nbytes
    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.interop import params_from_jax
    from repro_torch.models import transformer as T
    from repro_torch.train.loop import batch_to_device, make_train_step

    out = {}
    for plan in ("none", "full"):
        cfg = ModelConfig(**case["cfg"]).replace(remat_policy=plan)
        params = params_from_jax(case["params"], cfg, device="cpu",
                                 dtype=torch.float32)
        step = make_train_step(cfg, TrainConfig(**case["tcfg"]), "cpu",
                               mesh=mesh)
        local = SH.shard_params(params, mesh, step.param_specs)
        whole = SH.local_params(params, mesh, step.moe_parallel)
        batch = batch_to_device(case["batch"], "cpu")
        fsdp = SH.FSDP(mesh, step.param_specs, (), torch.float32)
        for tree in (local, whole):
            for t in _paths(tree).values():
                t.requires_grad_(True)
        loss = lambda p, f: T.train_loss(p, batch, cfg, mesh=mesh,
                                         dp_axes=(), fsdp=f)[0]
        out[plan] = {"fsdp": saved_residual_nbytes(loss, local, fsdp),
                     "whole": saved_residual_nbytes(loss, whole, None)}
    extra = {k: w.numel() * w.element_size() if w.numel() != b.numel()
             else 0 for (k, w), b in zip(_paths(whole).items(),
                                         _paths(local).values())}
    out["gathered"] = sum(v for k, v in extra.items()
                          if k.startswith("layers/"))
    out["head"] = extra["unembed"]
    return out


def collectives_case(mesh, case: dict) -> dict:
    """One FSDP training step from parameters drawn on the rank, under
    ``collectives.recording()``: the counts and result bytes per kind of
    the collectives this rank called."""
    import torch

    from repro_torch import sharding as SH
    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.core.collectives import recording
    from repro_torch.interop import init_params
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import init_adamw

    cfg = ModelConfig(**case["cfg"])
    tcfg = TrainConfig(**case["tcfg"])
    step = make_train_step(cfg, tcfg, "cpu", mesh=mesh)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                         dtype=torch.float32)
    local = SH.shard_params(params, mesh, step.param_specs)
    rows = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (tcfg.batch_size, tcfg.seq_len)).astype(np.int32)
    with recording() as rec:
        step(local, init_adamw(local), {"tokens": rows, "labels": rows})
    return {"counts": rec.counts(), "bytes": rec.bytes_by_kind()}


CASES = {"layer": layer_case, "train": train_case, "ckpt": ckpt_case,
         "serve": serve_case, "held": held_case,
         "collectives": collectives_case}


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
