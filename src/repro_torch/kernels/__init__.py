"""Hand-written CUDA kernels of the port, each beside its plain version.

Every wrapper takes the plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors (or raises); it counts its launches in its
``launches`` attribute.  :func:`launch_counts` and :func:`reset_launches`
read and zero those counts together.
"""

from __future__ import annotations


def _wrappers() -> dict:
    from repro_torch.kernels.combine import combine
    from repro_torch.kernels.dispatch import build_dispatch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_moe import fused_moe_bwd, fused_moe_fwd
    from repro_torch.kernels.gather_gmm import gather_gmm
    from repro_torch.kernels.gmm_dw import gmm_dw
    from repro_torch.kernels.paged_attention import paged_attention
    return {"build_dispatch": build_dispatch, "gather_gmm": gather_gmm,
            "combine": combine, "paged_attention": paged_attention,
            "gmm_dw": gmm_dw, "flash_attention": flash_attention,
            "fused_moe_fwd": fused_moe_fwd, "fused_moe_bwd": fused_moe_bwd}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
