"""Serving launcher of the port: random weights from seed 0, a few random
prompts, greedy decoding through the paged engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --reduced --device cpu [--layers 2] [--prompts 4] [--max-new 16]

Runs on the card by default (``--device cuda``).  Prints each request's
tokens and then one JSON run record with the engine stats and the
resolved grouped-GEMM backend (``REPRO_GMM_BACKEND`` selects it, as in the
reference).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.interop import init_params
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    eng = ServeEngine(cfg, params, batch_slots=args.prompts,
                      capacity=args.capacity, page_size=args.page_size,
                      device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(
        3, cfg.vocab_size, size=int(rng.integers(2, 9))).astype(np.int32),
        max_new_tokens=args.max_new) for _ in range(args.prompts)]
    t0 = time.perf_counter()
    eng.generate(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    for i, r in enumerate(reqs):
        print(f"req[{i}]: prompt={r.prompt.tolist()} -> {r.out_tokens} "
              f"[{r.finish_reason}]")
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "device": str(dev),
           "device_name": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
           "moe_impl": cfg.moe_impl, "gmm_backend": eng.backend.name,
           "gmm_backend_source": eng.backend.source,
           "capacity": args.capacity, "page_size": args.page_size,
           "seconds": seconds, "stats": dict(eng.stats)}
    print(f"run-record: {json.dumps(rec)}")


if __name__ == "__main__":
    main()
