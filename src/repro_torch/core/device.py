"""Device resolution for the port's entry points.

Entry points run on the card unless the caller names the CPU.  Asking for
CUDA where there is none raises: the port never carries on on the CPU in
place of the card.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device with no card present
    raises ``RuntimeError``.

    Also pins float32 matmuls to full precision: the router's f32 logits
    decide the top-k experts, and TF32 would flip routing decisions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch entry points run on the card by default and "
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
