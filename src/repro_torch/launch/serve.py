"""Serving launcher of the port: random weights from seed 0, a few random
prompts, greedy decoding through the paged engine, synchronously or
through the async runtime with live token streaming.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --reduced --device cpu [--layers 2] [--prompts 4] [--max-new 16]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --reduced --device cpu [--kv-dtype int8]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-30b-a3b --reduced --device cpu \
        --ckpt build/ckpt/step_2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --reduced --device cpu --stream --prefix-cache [--paged-kernel dense]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \
        --reduced --device cpu        (also yi-6b, deepseek-coder-33b)

The paged engine serves attention block patterns only: for hymba-1.5b
and xlstm-1.3b it raises the reference engine's ``ValueError`` (their
recurrent state decodes through ``models.transformer.decode_step``).  An
encoder (hubert-xlarge) has nothing to decode: the launcher exits with
the reference's message.  The paged engine decodes token streams: for
llava-next-mistral-7b (image and text inputs) its prefill raises the
reference's ``ValueError``.

Runs on the card by default (``--device cuda``).  ``--kv-dtype int8``
stores the KV pages as int8 with float16 scales.  ``--ckpt DIR`` serves
the parameters of a training checkpoint (``launch/train.py --ckpt-dir``):
its float32 masters are restored into the serving layout, matrices cast
to the config's dtype.  ``--stream`` serves through
``serve.runtime.AsyncServeRuntime`` and prints each token as it is
emitted and each request's terminal event; ``--prefix-cache`` turns on
copy-on-write prefix sharing; ``--paged-kernel dense|pallas`` picks the
decode attention (default: ``REPRO_PAGED_ATTN``, else the kernel on the
card and ``dense`` on the CPU).  Prints each request's tokens and then one
JSON run record with the mode, the engine stats, the KV bytes per cached
token, the resolved grouped-GEMM backend (``REPRO_GMM_BACKEND`` selects
it, as in the reference) and the resolved paged kernel with where it was
decided.
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
from repro_torch.train.checkpointing import restore_checkpoint


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
    ap.add_argument("--kv-dtype", choices=("model", "int8"), default="model")
    ap.add_argument("--stream", action="store_true",
                    help="serve through the async runtime and print tokens "
                         "as they are emitted")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="copy-on-write prefix sharing: full prompt pages "
                         "of finished requests are cached and mapped "
                         "read-only by later page-aligned prefix matches")
    ap.add_argument("--paged-kernel", default=None,
                    choices=["dense", "pallas"],
                    help="decode attention: pallas is the kernel, dense "
                         "the plain gather (default: REPRO_PAGED_ATTN, "
                         "else the kernel on the card)")
    ap.add_argument("--ckpt", default="",
                    help="serve the parameters of this training checkpoint")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    if not cfg.causal or cfg.input_kind == "frames":
        raise SystemExit(f"{cfg.name} is encoder-only; nothing to decode")
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    if args.ckpt:
        _, params = restore_checkpoint(args.ckpt, params)
    eng = ServeEngine(cfg, params, batch_slots=args.prompts,
                      capacity=args.capacity, page_size=args.page_size,
                      kv_dtype=args.kv_dtype,
                      prefix_cache=args.prefix_cache,
                      paged_kernel=args.paged_kernel, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(
        3, cfg.vocab_size, size=int(rng.integers(2, 9))).astype(np.int32),
        max_new_tokens=args.max_new) for _ in range(args.prompts)]
    t0 = time.perf_counter()
    if args.stream:
        from repro_torch.serve.runtime import AsyncServeRuntime
        for i, r in enumerate(reqs):
            r.on_token = (lambda tok, i=i:
                          print(f"req[{i}] token: {tok}", flush=True))
            r.on_finish = (lambda reason, i=i:
                           print(f"req[{i}] finished: {reason}", flush=True))
        with AsyncServeRuntime(eng) as rt:
            rt.run(reqs)
    else:
        eng.generate(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    for i, r in enumerate(reqs):
        print(f"req[{i}]: prompt={r.prompt.tolist()} -> {r.out_tokens} "
              f"[{r.finish_reason}]")
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "device": str(dev),
           "mode": "async-stream" if args.stream else "sync",
           "device_name": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
           "moe_impl": cfg.moe_impl if cfg.is_moe else None,
           "gmm_backend": eng.backend.name,
           "gmm_backend_source": eng.backend.source,
           "paged_kernel": eng.paged_attn.name,
           "paged_kernel_source": eng.paged_attn.source,
           "prefix_cache": args.prefix_cache,
           "capacity": args.capacity, "page_size": args.page_size,
           "kv_dtype": args.kv_dtype,
           "kv_bytes_per_token": eng.kv_bytes_per_token,
           "checkpoint": args.ckpt or None,
           "seconds": seconds, "stats": dict(eng.stats)}
    print(f"run-record: {json.dumps(rec)}")


if __name__ == "__main__":
    main()
