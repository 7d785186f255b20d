"""Shared helpers for the port's parity tests (``test_torch_*.py``).

Inputs are drawn with numpy from a seed and handed to both the reference
(JAX) and the port (PyTorch).  bfloat16 crosses as its bit pattern:
``ml_dtypes.bfloat16`` on the numpy/JAX side, a ``uint16`` view on the way
into the port, ``torch.bfloat16`` inside it.

torch (and so the port) is imported only when a test first asks for it
(the ``port`` fixture), never while a test module is collected: every
test worker collects every module, and a process that has imported torch
lays out its memory differently, which changes the outcome of reference
tests that depend on host-buffer timing (the reference engine hands numpy
buffers to asynchronous jitted calls and then mutates them).
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest


def port() -> SimpleNamespace:
    """torch and the port's modules, imported on first use."""
    import torch

    from repro_torch import interop
    from repro_torch.core import routing
    from repro_torch.kernels import (combine, dispatch, flash_attention,
                                     gather_gmm, gather_rows, gmm_dw, ops,
                                     paged_attention)
    from repro_torch.models import transformer
    from repro_torch.serve import engine, kv_quant, paged_cache

    # The suite runs with several worker processes; keep each one's
    # intra-op pool small.
    torch.set_num_threads(2)
    return SimpleNamespace(
        torch=torch, interop=interop, routing=routing, combine=combine,
        dispatch=dispatch, gather_gmm=gather_gmm, gather_rows=gather_rows,
        gmm_dw=gmm_dw,
        flash_attention=flash_attention, ops=ops,
        paged_attention=paged_attention, transformer=transformer,
        engine=engine, paged_cache=paged_cache, kv_quant=kv_quant,
        dtype={"float32": torch.float32, "bfloat16": torch.bfloat16})


@pytest.fixture(scope="module")
def tp() -> SimpleNamespace:
    """The ``port()`` namespace, once per test module."""
    return port()


def to_torch(a, device="cpu"):
    """numpy / JAX array -> torch tensor (bfloat16 by bit pattern)."""
    import torch
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(
            np.array(a).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def as_dtype(a: np.ndarray, dtype: str) -> np.ndarray:
    return a.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)


def f32(a) -> np.ndarray:
    """Any array or tensor -> float32 numpy."""
    if hasattr(a, "detach"):
        return a.detach().cpu().float().numpy()
    return np.asarray(a).astype(np.float32)


def np_params(jax_params):
    """JAX params pytree -> numpy leaves, bfloat16 as uint16 views (the
    input contract of ``repro_torch.interop.params_from_jax``)."""
    import jax

    def leaf(x):
        a = np.asarray(x)
        return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a
    return jax.tree.map(leaf, jax_params)


def torch_config(jax_cfg):
    """The port's ModelConfig with the reference config's field values
    (``repro_torch.configs`` imports no torch)."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**dataclasses.asdict(jax_cfg))


def tiny_dense_config():
    """The reference serving tests' model (``tests/test_prefix_cache.py``,
    ``tests/test_runtime.py``): yi-6b cut to 2 layers, d=64, 2 heads of 32,
    FFN 128, vocabulary 64, float32.  The port runs it as its dense
    ``attn_ffn`` model."""
    from repro.configs import get_config
    return get_config("yi_6b").reduced().replace(
        num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=64, attn_chunk=16)


def greedy_continuation(jax_params, jax_cfg, prompts, max_new: int,
                        capacity: int):
    """The reference model's greedy continuation of each prompt: its
    ``forward`` over prompt + tokens so far, right-padded to ``capacity``
    (one compiled shape; causal, so the padding does not reach the real
    positions), the argmax at the last real position.  The port's engines
    are held to these tokens, not to the reference engine's, which vary
    from run to run (ROADMAP.md §C)."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JT
    fwd = jax.jit(lambda p, t: JT.forward(p, {"tokens": t}, jax_cfg)[0])
    seqs = [list(p) for p in prompts]
    for _ in range(max_new):
        toks = np.zeros((len(seqs), capacity), np.int32)
        for i, q in enumerate(seqs):
            toks[i, :len(q)] = q
        logits = np.asarray(fwd(jax_params, jnp.asarray(toks)))
        for i, q in enumerate(seqs):
            q.append(int(logits[i, len(q) - 1].argmax()))
    return [q[len(p):] for q, p in zip(seqs, prompts)]
