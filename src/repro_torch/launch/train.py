"""Training launcher of the port: float32 master weights from the seed,
batches from the synthetic pipeline, the MoEBlaze training step.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
        --reduced --steps 3 --device cpu [--batch 2] [--seq 64] [--layers 2]
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \
        --reduced --steps 3 --device cpu

Runs on the card by default (``--device cuda``), with ``use_pallas=True``:
attention through the flash-attention kernel and, for a dense SwiGLU
model, the FFN through the fused SwiGLU kernels.  A MoE model's expert
layer is the config's ``moe_impl`` (``blaze`` for Mixtral); the
grouped-GEMM backend is chosen, as in the reference, by
``REPRO_GMM_BACKEND`` (``segment`` when unset; ``pallas_fused`` runs the
fused kernel pair).  Kernels take their plain
versions on the CPU.  Prints a line per logged step and then one JSON run
record, which names the resolved backend.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import TrainConfig, get_config
from repro_torch.core.device import resolve_device
from repro_torch.train.loop import train


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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.replace(use_pallas=True)
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    tcfg = TrainConfig(total_steps=args.steps, batch_size=args.batch,
                       seq_len=args.seq, learning_rate=args.lr,
                       num_microbatches=args.microbatches,
                       log_every=args.log_every)
    dev = resolve_device(args.device)
    _, _, history = train(cfg, tcfg, device=dev)
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "param_dtype": cfg.param_dtype, "device": str(dev),
           "device_name": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
           "moe_impl": cfg.moe_impl if cfg.is_moe else None,
           "gmm_backend": history[-1]["gmm_backend"],
           "batch": args.batch, "seq": args.seq, "history": history}
    print(f"run-record: {json.dumps(rec)}")


if __name__ == "__main__":
    main()
