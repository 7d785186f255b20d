"""Training launcher of the port: float32 master weights from the seed,
batches from the synthetic pipeline, the MoEBlaze training step.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
        --reduced --steps 3 --device cpu [--batch 2] [--seq 64] [--layers 2]
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \
        --reduced --steps 3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen3-moe-30b-a3b --reduced --steps 4 --batch 4 --seq 64 \
        --microbatches 2 --device cpu --ckpt-dir build/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
        --reduced --steps 2 --batch 2 --seq 64 --device cpu
        (also xlstm-1.3b, gemma2-27b, yi-6b, deepseek-coder-33b)
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch mixtral-8x7b --reduced --device cpu --mesh 1,2 \
        --moe-parallel ep_a2a

Runs on the card by default (``--device cuda``), with ``use_pallas=True``:
attention through the flash-attention kernel and, for a dense SwiGLU
model or Hymba, the FFN through the fused SwiGLU kernels (xLSTM runs no
kernel: its scans are plain PyTorch, as the reference's are plain JAX).  A MoE model's expert
layer is the config's ``moe_impl`` (``blaze`` for Mixtral); the
grouped-GEMM backend is chosen, as in the reference, by
``REPRO_GMM_BACKEND`` (``ragged``, ``torch._grouped_mm``, when unset;
``pallas_fused`` runs the fused kernel pair).  Kernels take their plain versions on the CPU.

The launcher feeds the pipeline's packed token batches, as the
reference's does, so a model of frame or mixed inputs (hubert-xlarge,
llava-next-mistral-7b) stops at its first step with the reference's
``KeyError`` for the missing ``features`` or ``image_embeds``; train
those through ``train.loop.make_train_step`` on
``data.pipeline.synthesize_batch`` batches.

``--microbatches M`` accumulates the gradients of M pieces of each batch
(the live activations are one piece's).  ``--ckpt-dir DIR`` saves the
parameters and the optimizer state to ``DIR/step_<n>`` at step ``steps //
2`` (``train/checkpointing.py``; ``launch/serve.py --ckpt`` serves them).

``--mesh D,M`` (or ``D,M,N``) lays the ranks that torchrun starts out as a
``('data', 'model')`` mesh of D x M ranks (or ``('data', 'node',
'model')`` with N nodes of M ranks each) and runs the MoE layers in the
``--moe-parallel`` mode (``ep``, ``ep_a2a``, ``ep_a2a_hier``, ``tp``, or
the config's default ``auto``, which the roofline cost model resolves at
the per-rank slab).  Each rank keeps only its block of every parameter
and AdamW moment, placed by ``sharding.param_specs(..., fsdp=True)`` as
the reference's launcher places them, and gathers a layer's leaves whole
just before the layer runs.  ``--ckpt-dir`` under a mesh writes the whole
trees from rank 0.  Prints a line per logged step and then one JSON run
record (rank 0), which names the resolved backend, the resolved mode, the
mesh, the transport and rank 0's parameter and moment bytes.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import TrainConfig, get_config
from repro_torch.core.collectives import transport
from repro_torch.core.device import resolve_device
from repro_torch.launch.mesh import (init_distributed, make_debug_mesh,
                                     make_node_mesh)
from repro_torch.train.loop import train
from repro_torch.train.optimizer import tree_leaves


def _mesh(spec: str):
    sizes = [int(v) for v in spec.split(",")]
    if len(sizes) == 2:
        return make_debug_mesh(*sizes)
    if len(sizes) == 3:
        data, model, node = sizes
        return make_node_mesh(data, node, model)
    raise ValueError(f"--mesh takes D,M or D,M,N, got {spec!r}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default="",
                    help="save a checkpoint here at step steps // 2")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None,
                    help="D,M: data x model ranks; D,M,N: with N nodes")
    ap.add_argument("--moe-parallel", default=None,
                    help="auto | ep | ep_a2a | ep_a2a_hier | tp (with "
                         "--mesh; the config's default is auto)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.replace(use_pallas=True)
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    if args.moe_parallel is not None:
        cfg = cfg.replace(moe_parallel=args.moe_parallel)
    tcfg = TrainConfig(total_steps=args.steps, batch_size=args.batch,
                       seq_len=args.seq, learning_rate=args.lr,
                       num_microbatches=args.microbatches,
                       log_every=args.log_every,
                       checkpoint_every=(args.steps // 2 if args.ckpt_dir
                                         else 0),
                       checkpoint_dir=args.ckpt_dir)
    mesh = None
    if args.mesh is not None:
        dev = init_distributed(args.device)
        mesh = _mesh(args.mesh)
    else:
        dev = resolve_device(args.device)
    rank0 = mesh is None or mesh.rank == 0
    log = print if rank0 else (lambda *_: None)
    params, opt, history = train(cfg, tcfg, device=dev, mesh=mesh, log=log)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "param_dtype": cfg.param_dtype, "device": str(dev),
           "device_name": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
           "moe_impl": cfg.moe_impl if cfg.is_moe else None,
           "gmm_backend": history[-1]["gmm_backend"],
           "moe_parallel": (history[-1]["moe_parallel"] if mesh is not None
                            else None),
           "rank_param_bytes": nbytes(tree_leaves(params)),
           "rank_moment_bytes": nbytes(opt.mu + opt.nu),
           "mesh": mesh.shape if mesh is not None else None,
           "transport": (transport(mesh.group(mesh.axis_names), dev)
                         if mesh is not None else None),
           "moe_overflow": history[-1]["moe_overflow"],
           "batch": args.batch, "seq": args.seq,
           "microbatches": args.microbatches,
           "checkpoint_dir": args.ckpt_dir or None, "history": history}
    if rank0:
        print(f"run-record: {json.dumps(rec)}")
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
