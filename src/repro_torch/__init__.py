"""PyTorch and CUDA port of the MoEBlaze reproduction (``repro``).

Three slices: serving (Mixtral-style attention + MoE blocks served by a
paged, continuously batched greedy engine), training (the MoEBlaze
expert layer with its Algorithm-1 backward, AdamW on float32 master
weights), and the reference's default expert layer ``moe_impl="blaze"``
over the grouped-GEMM backend registry (``core.gmm_backend``,
``core.moe_layer``).  Hand-written CUDA kernels (``repro_torch.kernels``)
cover the dispatch build, the gather-GMM, the combine, paged decode
attention, the grouped weight gradient, the flash-attention forward and
the fused MoE forward and backward.  Entry points run
on the card unless the caller passes ``device="cpu"``; on the CPU every
kernel wrapper takes its plain PyTorch version.

This package imports neither JAX nor the ``repro`` package.
"""

__all__ = ["configs", "core", "data", "kernels", "models", "serve", "train",
           "launch", "interop"]
