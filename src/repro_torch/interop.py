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

#: leaves stored in the storage dtype: the matrices the forward casts to
#: the model dtype on use (the dense FFN's ``w1``/``w2``/``w3`` and the
#: recurrent blocks' projections among them), and the expert weights,
#: which the port casts as well where the reference keeps them float32.
#: Everything else stays float32: the norm scales (``q_norm`` and
#: ``k_norm`` included), the biases ``f_bias`` and ``dt_bias`` and the
#: skip ``d_skip``, which the sublayers cast to the model dtype on use as
#: the reference does, and Mamba's ``a_log``, which the scan reads as
#: float32.
CAST_TO_MODEL_DTYPE = {"wq", "wk", "wv", "wo", "wg", "w1", "w2", "w3",
                       "embed", "unembed", "frontend_proj", "img_proj",
                       "w_up", "w_z", "wif", "w_down",        # mLSTM
                       "w_zifo", "w_up1", "w_up2",            # sLSTM
                       "w_in", "w_dt", "w_b", "w_c", "w_out"}  # Mamba


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
    for k in ("embed", "unembed", "final_norm", "frontend_proj",
              "img_proj"):
        if k in np_params:          # the input kind's embeddings
            out[k] = _tensor(np_params[k], k, dt, dev)
    return out


def param_shapes(cfg) -> dict:
    """The parameter tree's leaves as shape tuples (no storage)."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return tuple(t.shape)
    return walk(init_params(cfg, device="meta"))


def init_params(cfg, generator: torch.Generator | None = None,
                device=None, dtype: torch.dtype | None = None) -> dict:
    """Random parameters drawn from ``generator`` on ``device``, with the
    reference's init scales (LeCun-normal over the fan-in, embeddings
    N(0, 0.02^2), zero norm scales), in the port's layout; matrices are
    stored in ``dtype`` (default ``cfg.dtype``, the serving layout).  The
    numbers are not the reference's (the generators differ).  A MoE block
    draws ``moe = {wg, w1, w2, w3}``; a dense block draws ``ffn = {w1 (d,
    d_ff), w2 (d, d_ff) for swiglu, w3 (d_ff, d)}``; the recurrent and
    hybrid blocks draw the leaves of the reference's ``init_mlstm_params``,
    ``init_slstm_params`` and ``init_mamba_params`` (``models/ssm.py``),
    with its constant biases (forget gates at 3, ``a_log`` 0, ``d_skip``
    1).  A Hymba block is ``{ln1, ln2, attn, mamba, ffn}``.  The
    embeddings are those the reference draws for ``cfg.input_kind``:
    ``embed`` for tokens and mixed inputs, a (d, d) LeCun-normal
    ``frontend_proj`` for frames and ``img_proj`` for mixed inputs.
    ``device="meta"`` gives the tree's shapes and dtypes without storage
    (:func:`param_shapes`)."""
    check_supported(cfg)
    meta = str(device) == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    dt = dtype or getattr(torch, cfg.dtype)
    if generator is None and not meta:
        generator = torch.Generator(device=dev).manual_seed(0)

    def randn(shape):
        if meta:
            return torch.empty(shape, device=dev)
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32)
    d, E, h, d_ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff, cfg.d_ff
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def dense(shape, fan_in):
        return randn(shape).div_(fan_in ** 0.5).to(dt)

    zeros = lambda: torch.zeros(d, dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)

    def attn():
        p = {"wq": dense((d, H * dh), d), "wk": dense((d, Hkv * dh), d),
             "wv": dense((d, Hkv * dh), d), "wo": dense((H * dh, d), H * dh)}
        if cfg.qk_norm:
            p["q_norm"] = torch.zeros(dh, device=dev)
            p["k_norm"] = torch.zeros(dh, device=dev)
        return p

    def ffn():
        p = {"w1": dense((d, d_ff), d)}
        if cfg.ffn_act == "swiglu":
            p["w2"] = dense((d, d_ff), d)
        p["w3"] = dense((d_ff, d), d_ff)
        return p

    def mlstm():
        # the reference's init_mlstm_params: H heads of width 2 d / H
        return {"w_up": dense((d, 2 * d), d), "w_z": dense((d, 2 * d), d),
                "wq": dense((2 * d, 2 * d), 2 * d),
                "wk": dense((2 * d, 2 * d), 2 * d),
                "wv": dense((2 * d, 2 * d), 2 * d),
                "wif": dense((2 * d, 2 * H), 2 * d),
                "f_bias": torch.full((H,), 3.0, **f32),
                "w_down": dense((2 * d, d), 2 * d)}

    def slstm():
        return {"w_zifo": dense((d, 4 * d), d),
                "f_bias": torch.full((d,), 3.0, **f32),
                "w_up1": dense((d, 2 * d), d), "w_up2": dense((d, 2 * d), d),
                "w_down": dense((2 * d, d), 2 * d)}

    def mamba():
        Hs, N = cfg.ssm_heads, cfg.ssm_state
        return {"w_in": dense((d, Hs * dh), d), "w_dt": dense((d, Hs), d),
                "dt_bias": torch.zeros(Hs, **f32),
                "w_b": dense((d, N), d), "w_c": dense((d, N), d),
                "a_log": torch.zeros(Hs, **f32),
                "d_skip": torch.ones(Hs, 1, **f32),
                "w_out": dense((Hs * dh, d), Hs * dh)}

    layers = []
    for kind in layer_kinds(cfg):
        if kind in ("mlstm", "slstm"):
            layers.append({"ln1": zeros(),
                           kind: mlstm() if kind == "mlstm" else slstm()})
            continue
        if kind == "hymba":
            layers.append({"ln1": zeros(), "ln2": zeros(), "attn": attn(),
                           "mamba": mamba(), "ffn": ffn()})
            continue
        layer = {"ln1": zeros(), "ln2": zeros(), "attn": attn()}
        if kind in MOE_KINDS:
            moe = {"wg": dense((d, E), d), "w1": dense((E, d, h), d)}
            if cfg.ffn_act == "swiglu":
                moe["w2"] = dense((E, d, h), d)
            moe["w3"] = dense((E, h, d), h)
            layer["moe"] = moe
        else:
            layer["ffn"] = ffn()
        if cfg.post_norms:
            layer["ln1_post"] = zeros()
            layer["ln2_post"] = zeros()
        layers.append(layer)
    out = {"layers": layers}
    if cfg.input_kind in ("tokens", "mixed"):
        out["embed"] = randn((cfg.vocab_size, d)).mul_(0.02).to(dt)
    out["unembed"] = dense((d, cfg.vocab_size), d)
    out["final_norm"] = zeros()
    if cfg.input_kind == "frames":
        out["frontend_proj"] = dense((d, d), d)
    if cfg.input_kind == "mixed":
        out["img_proj"] = dense((d, d), d)
    return out
