"""PyTorch and CUDA port of the MoEBlaze reproduction (``repro``).

The serving slice: Mixtral-style attention + MoE blocks served by a paged,
continuously batched greedy engine, with hand-written CUDA kernels for the
dispatch build, the gather-GMM, the combine and paged decode attention
(``repro_torch.kernels``).  Entry points run on the card unless the caller
passes ``device="cpu"``; on the CPU every kernel wrapper takes its plain
PyTorch version.

This package imports neither JAX nor the ``repro`` package.
"""

__all__ = ["configs", "core", "kernels", "models", "serve", "launch",
           "interop"]
