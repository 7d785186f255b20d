"""Parameters for the port: converted from the reference's init, or drawn
from a seed.

:func:`params_from_jax` takes the reference's ``init_params`` pytree as
numpy arrays (layer leaves stacked ``(num_groups, ...)``, one dict per
block of the pattern) and returns the port's layout: ``{"layers": [one
dict per layer], "embed", "unembed", "final_norm"}``.

Storage dtype: both functions take ``dtype``, the dtype of the matrices
(every leaf but the norm scales, which stay float32 because ``rms_norm``
reads them as float32).  Serving stores them in ``cfg.dtype`` (the
default), so the forward's casts on use are no-ops.  Training stores every
leaf in ``cfg.param_dtype`` (float32 masters) and the forward casts on use.

The reference casts ``wq``/``wk``/``wv``/``wo``, ``wg``, ``embed`` and
``unembed`` to the model dtype on use, but multiplies by its float32
expert weights ``w1``/``w2``/``w3`` uncast (``jnp.dot`` of bf16 rows and
float32 weights promotes to float32).  The port does not: it rounds the
expert weights to the model dtype as well, once per step in training
(``models/moe_block.py``) and once here in serving, so the expert GEMMs
run on bf16 tensor cores.  In float32 configs the two agree; in bf16 the
difference is bounded by ``tests/test_torch_train.py`` and recorded in
ROADMAP §C.

A bfloat16 numpy array arrives as its ``uint16`` bit pattern (numpy has no
bfloat16 of its own) and is reinterpreted, not converted.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.transformer import (MOE_KINDS, check_supported,
                                            layer_kinds)

#: leaves stored in the storage dtype: the ones the forward casts to the
#: model dtype on use (the dense FFN's ``w1``/``w2``/``w3`` among them), and
#: the expert weights, which the port casts as well where the reference
#: keeps them float32 (everything else is a norm scale, the ``q_norm`` and
#: ``k_norm`` scales included, kept float32)
CAST_TO_MODEL_DTYPE = {"wq", "wk", "wv", "wo", "wg", "w1", "w2", "w3",
                       "embed", "unembed"}


def _tensor(a: np.ndarray, name: str, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # the tensor owns its memory
    if a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    target = dtype if name in CAST_TO_MODEL_DTYPE else torch.float32
    return t.to(device=device, dtype=target).contiguous()


def params_from_jax(np_params: dict, cfg, device=None,
                    dtype: torch.dtype | None = None) -> dict:
    """Convert the reference's parameter pytree (numpy leaves); matrices
    are stored in ``dtype`` (default ``cfg.dtype``, the serving layout)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype or getattr(torch, cfg.dtype)
    conv = lambda tree: {k: (conv(v) if isinstance(v, dict)
                             else _tensor(v, k, dt, dev))
                         for k, v in tree.items()}

    def slice_tree(tree, g):
        return {k: (slice_tree(v, g) if isinstance(v, dict) else v[g])
                for k, v in tree.items()}

    groups = np_params["layers"]          # tuple over the block pattern
    layers = []
    for g in range(cfg.num_groups):
        for j in range(cfg.pattern_period):
            layers.append(conv(slice_tree(groups[j], g)))
    out = {"layers": layers}
    for k in ("embed", "unembed", "final_norm"):
        out[k] = _tensor(np_params[k], k, dt, dev)
    return out


def init_params(cfg, generator: torch.Generator | None = None,
                device=None, dtype: torch.dtype | None = None) -> dict:
    """Random parameters drawn from ``generator`` on ``device``, with the
    reference's init scales (LeCun-normal over the fan-in, embeddings
    N(0, 0.02^2), zero norm scales), in the port's layout; matrices are
    stored in ``dtype`` (default ``cfg.dtype``, the serving layout).  The
    numbers are not the reference's (the generators differ).  A MoE block
    draws ``moe = {wg, w1, w2, w3}``; a dense block draws ``ffn = {w1 (d,
    d_ff), w2 (d, d_ff) for swiglu, w3 (d_ff, d)}``."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype or getattr(torch, cfg.dtype)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d, E, h, d_ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff, cfg.d_ff
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return w.div_(fan_in ** 0.5).to(dt)

    zeros = lambda: torch.zeros(d, dtype=torch.float32, device=dev)
    layers = []
    for kind in layer_kinds(cfg):
        attn = {"wq": dense((d, H * dh), d), "wk": dense((d, Hkv * dh), d),
                "wv": dense((d, Hkv * dh), d), "wo": dense((H * dh, d), H * dh)}
        if cfg.qk_norm:
            attn["q_norm"] = torch.zeros(dh, device=dev)
            attn["k_norm"] = torch.zeros(dh, device=dev)
        layer = {"ln1": zeros(), "ln2": zeros(), "attn": attn}
        if kind in MOE_KINDS:
            moe = {"wg": dense((d, E), d), "w1": dense((E, d, h), d)}
            if cfg.ffn_act == "swiglu":
                moe["w2"] = dense((E, d, h), d)
            moe["w3"] = dense((E, h, d), h)
            layer["moe"] = moe
        else:
            ffn = {"w1": dense((d, d_ff), d)}
            if cfg.ffn_act == "swiglu":
                ffn["w2"] = dense((d, d_ff), d)
            ffn["w3"] = dense((d_ff, d), d_ff)
            layer["ffn"] = ffn
        if cfg.post_norms:
            layer["ln1_post"] = zeros()
            layer["ln2_post"] = zeros()
        layers.append(layer)
    embed = torch.randn((cfg.vocab_size, d), generator=generator, device=dev,
                        dtype=torch.float32).mul_(0.02).to(dt)
    return {"layers": layers, "embed": embed,
            "unembed": dense((d, cfg.vocab_size), d), "final_norm": zeros()}
