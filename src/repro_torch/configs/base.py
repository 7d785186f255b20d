"""Model configuration for the PyTorch port.

A copy of the reference package's ``ModelConfig`` with the same field names
and defaults, so that a reference config converts field for field:
``ModelConfig(**dataclasses.asdict(reference_cfg))``.  The properties
``checkpoint_plan`` and ``resolved_save_yswi`` read the plan through the
port's ``core/checkpoint.py``.  :class:`TrainConfig` is the reference's
training config; its checkpoint directory has no default (the reference
writes under ``/tmp``), so saving needs one named.  :class:`InputShape`
and :data:`INPUT_SHAPES` are the reference's four workload shapes
(``repro/configs/base.py:157-170``), which the dry run
(``launch/dryrun.py``) traces every architecture at.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description; ``reduced()`` yields the CPU test variant
    of the same family."""

    name: str
    arch_type: str                       # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                    # 0 -> d_model // num_heads
    d_ff: int = 512
    vocab_size: int = 1024
    ffn_act: str = "swiglu"              # swiglu | gelu | silu | relu

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                    # per-expert hidden dim
    moe_impl: str = "blaze"              # blaze | blaze_pallas | megablocks | dense
    moe_parallel: str = "auto"           # auto | ep | ep_a2a | ep_a2a_hier | tp
    moe_a2a_capacity: float = 2.0
    moe_a2a_chunks: int = 1
    gmm_backend: str = "auto"
    save_yswi: bool = True
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3

    # --- attention variants --------------------------------------------------
    sliding_window: int = 0              # 0 -> full attention
    local_global_period: int = 0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    qk_norm: bool = False
    post_norms: bool = False
    causal: bool = True
    rope_theta: float = 10_000.0

    # --- SSM / hybrid --------------------------------------------------------
    block_pattern: tuple[str, ...] = ("attn_ffn",)
    ssm_state: int = 0
    ssm_heads: int = 0
    mamba_dual: bool = False
    slstm_every: int = 0

    # --- modality frontends --------------------------------------------------
    input_kind: str = "tokens"           # tokens | frames | mixed
    num_image_tokens: int = 0

    # --- numerics / system ---------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat_policy: str = "none"
    scan_layers: bool = True
    attn_chunk: int = 512                # flash-attention KV chunk
    use_pallas: bool = False             # fused-kernel attention path
    block_causal_skip: bool = True
    serve_replicate_weights: bool = False
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def checkpoint_plan(self):
        """The resolved :class:`repro_torch.core.checkpoint.CheckpointPlan`
        behind ``remat_policy`` (name or spec)."""
        from repro_torch.core.checkpoint import resolve_plan
        return resolve_plan(config=self.remat_policy).plan

    @property
    def resolved_save_yswi(self) -> bool:
        """The plan's FFN_YSWI decision in the MoE scope (the
        ``save_yswi`` alias when the plan leaves it open)."""
        from repro_torch.core.checkpoint import moe_residual_mode
        return moe_residual_mode(self) == "ab_yswi"

    @property
    def pattern_period(self) -> int:
        if self.slstm_every:
            return self.slstm_every
        if self.local_global_period:
            return self.local_global_period
        return 1

    @property
    def num_groups(self) -> int:
        if self.num_layers % self.pattern_period:
            raise ValueError(f"num_layers={self.num_layers} is not a multiple "
                             f"of the pattern period {self.pattern_period}")
        return self.num_layers // self.pattern_period

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 groups, d_model<=256, <=4 experts."""
        period = self.pattern_period
        kw = dict(
            num_layers=2 * period if period > 1 else 2,
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            attn_chunk=64,
            dtype="float32",
        )
        if self.is_moe:
            kw.update(num_experts=4, top_k=min(self.top_k, 2), moe_d_ff=128)
        if self.ssm_heads:
            kw.update(ssm_heads=2)
        if self.num_image_tokens:
            kw.update(num_image_tokens=16)
        return self.replace(**kw)


@dataclass(frozen=True)
class InputShape:
    """A workload shape: ``seq_len`` positions for each of
    ``global_batch`` rows, of ``kind`` train, prefill or decode (a decode
    shape is one new token a row over a ``seq_len`` cache)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                            # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule and batch shape of a training run."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    batch_size: int = 8
    seq_len: int = 256
    num_microbatches: int = 1            # gradient accumulation
    gmm_backend: str = "auto"            # over ModelConfig.gmm_backend
    seed: int = 0
    checkpoint_every: int = 0            # 0 -> disabled
    checkpoint_dir: str = ""             # required when checkpoint_every > 0
    log_every: int = 10

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
