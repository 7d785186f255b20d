"""Model assembly: embeddings, the attention + MoE or dense FFN blocks
and the recurrent and hybrid blocks, the full-sequence forward and
training loss, the cache decode entry points, and the paged prefill /
decode entry points of serving.

Mirrors ``repro/models/transformer.py`` (``_apply_sublayer`` for the
``attn_moe`` / ``attn_local_moe`` and ``attn_ffn`` / ``attn_local_ffn``
kinds, whose dense blocks add no auxiliary loss, and for ``mlstm``,
``slstm`` and ``hymba``; ``_embed_inputs`` for token, frame and mixed
inputs; ``forward`` and ``train_loss``, causal or not; ``init_cache``
and ``decode_step``, which decodes token streams and refuses an
encoder's frames; ``paged_supported``,
``init_paged_cache``, ``prefill`` with prefix offsets,
``paged_decode_step``).  Layers run in a Python loop where the
reference scans over stacked groups; ``params["layers"]`` is a list with
one dict per layer (see ``repro_torch.interop``) and a decode cache is a
list with one tuple per layer (the reference's per-sublayer tuple).
Weights are cast to ``cfg.dtype`` on use, as in the reference (a no-op
for serving weights, which are stored cast).  The KV pools, and the
``KVCache`` buffers of ``decode_step``, are updated in place; the
recurrent states of ``decode_step`` are new tensors.

The training forward applies the checkpoint plan of ``cfg.remat_policy``
as the reference's ``forward`` does (``core/checkpoint.plan_policies``):
each group of ``cfg.pattern_period`` layers runs in one checkpoint region
(``group``), or each sublayer in its own (``per_kind``), or none
(``full``).  The default ``"none"`` keeps only each region's input and
recomputes the rest in the backward.  A forward without autograd
(``torch.no_grad``) and the serving entry points run unwrapped.
"""

from __future__ import annotations

from functools import partial

import torch

from repro_torch import sharding as SH
from repro_torch.core import checkpoint as CK
from repro_torch.core.collectives import all_reduce_, regather_saved
from repro_torch.models import ssm
from repro_torch.models.attention import (attention_sublayer, init_kv_cache,
                                          paged_attention_sublayer)
from repro_torch.models.common import rms_norm, softcap
from repro_torch.models.ffn import FFN_ACTS, ffn_sublayer
from repro_torch.models.moe_block import check_supported as check_moe
from repro_torch.models.moe_block import moe_sublayer
from repro_torch.serve.paged_cache import init_paged_kv

MOE_KINDS = ("attn_moe", "attn_local_moe")
DENSE_KINDS = ("attn_ffn", "attn_local_ffn")
ATTN_KINDS = MOE_KINDS + DENSE_KINDS
#: the recurrent (xLSTM) and hybrid (Hymba) kinds of ``models/ssm.py``
SSM_KINDS = ("mlstm", "slstm", "hymba")
KINDS = ATTN_KINDS + SSM_KINDS


def layer_kinds(cfg) -> list[str]:
    """Block kind of each layer (the pattern repeated over groups)."""
    return [cfg.block_pattern[i % cfg.pattern_period]
            for i in range(cfg.num_layers)]


def check_supported(cfg) -> None:
    """Raise for configurations the port does not run yet (the MoE
    settings are checked by ``moe_block.check_supported``)."""
    bad = sorted(set(cfg.block_pattern) - set(KINDS))
    if bad:
        raise NotImplementedError(
            f"block kinds {bad} are not ported; the port runs "
            f"{KINDS}")
    CK.resolve_plan(config=cfg.remat_policy)  # raises for a bad spec
    if (set(cfg.block_pattern) & {*DENSE_KINDS, "hymba"}
            and cfg.ffn_act not in FFN_ACTS):
        raise NotImplementedError(
            f"ffn_act={cfg.ffn_act!r}: the dense FFN takes {FFN_ACTS}")


def _apply_sublayer(x, p, kind: str, cfg, attend, *, cache=None, mesh=None,
                    dp_axes=("pod", "data"), fsdp=None, spec=None):
    """One block.  ``attend(h, p_attn, cfg, is_local=..., cache=...)`` is
    the attention sublayer (full-sequence, cache decode or paged) and
    returns ``(out, new_cache)``.  ``cache`` is the layer's decode cache
    tuple (``init_cache``) or None.  Returns the new residual stream, the
    block's auxiliary loss and its ``ep_a2a`` overflow share (both zero
    but for a MoE block) and the layer's new cache tuple (its entries None
    where there is no cache).  ``mesh`` and ``dp_axes`` go to the MoE
    sublayer.  With ``fsdp`` (``sharding.FSDP``), ``p`` holds this rank's
    blocks under ``spec`` and is gathered first, inside whatever
    checkpoint region runs the block."""
    if fsdp is not None:
        p = fsdp.gather(p, spec)
    zero = (None if kind in MOE_KINDS
            else torch.zeros((), dtype=torch.float32, device=x.device))
    c0 = cache[0] if cache is not None else None
    if kind in ("mlstm", "slstm"):
        sub = ssm.mlstm_sublayer if kind == "mlstm" else ssm.slstm_sublayer
        h, st = sub(rms_norm(x, p["ln1"]), p[kind], cfg, state=c0)
        return x + h, zero, zero, (st,)
    if kind == "hymba":
        # attention and Mamba heads in parallel on the same input, fused by
        # their mean, then the FFN
        h = rms_norm(x, p["ln1"])
        ha, kv = attend(h, p["attn"], cfg, is_local=cfg.sliding_window > 0,
                        cache=c0)
        hm, st = ssm.mamba_sublayer(
            h, p["mamba"], cfg, state=cache[1] if cache is not None else None)
        x = x + 0.5 * (ha + hm)
        h = ffn_sublayer(rms_norm(x, p["ln2"]), p["ffn"], cfg)
        return x + h, zero, zero, (kv, st)
    is_local = "local" in kind and cfg.sliding_window > 0
    h, kv = attend(rms_norm(x, p["ln1"]), p["attn"], cfg, is_local=is_local,
                   cache=c0)
    if cfg.post_norms:
        h = rms_norm(h, p["ln1_post"])
    x = x + h
    h = rms_norm(x, p["ln2"])
    if kind in MOE_KINDS:
        h, aux, stats = moe_sublayer(h, p["moe"], cfg, mesh=mesh,
                                     dp_axes=dp_axes, with_stats=True)
        overflow = stats["a2a_overflow"]
    else:
        h = ffn_sublayer(h, p["ffn"], cfg)
        aux = overflow = zero
    if cfg.post_norms:
        h = rms_norm(h, p["ln2_post"])
    return x + h, aux, overflow, (kv,)


def paged_supported(cfg) -> bool:
    """Paged serving covers the attention block patterns (a recurrent
    carry is O(1) state a slot: nothing to page)."""
    return all(k in ATTN_KINDS for k in cfg.block_pattern)


def init_paged_cache(cfg, num_pages: int, page_size: int, device, *,
                     quantized: bool = False):
    """One :class:`~repro_torch.serve.paged_cache.PagedKV` pool per layer
    (physical page 0 is the trash page), in the model dtype, or with
    ``quantized`` int8 values and float16 per-(position, head) scales.
    Raises ``ValueError`` for a pattern that is not all attention, as the
    reference does."""
    if not paged_supported(cfg):
        raise ValueError(
            f"paged serving needs an attention block pattern; "
            f"{cfg.name} has {cfg.block_pattern} (use T.decode_step)")
    check_supported(cfg)
    dt = getattr(torch, cfg.dtype)
    return [init_paged_kv(num_pages, page_size, cfg.num_kv_heads,
                          cfg.resolved_head_dim, dt, device,
                          quantized=quantized)
            for _ in range(cfg.num_layers)]


def init_cache(cfg, batch: int, capacity: int, device) -> list:
    """Decode cache of :func:`decode_step`: one tuple per layer.  An
    attention layer holds a :class:`~repro_torch.models.attention.KVCache`
    of ``capacity`` slots (the window's, if shorter, for a local layer);
    an mLSTM layer its (C, n, m) state with heads of width 2 d / H; an
    sLSTM layer its (c, n, m); a Hymba layer a KVCache of its window and
    its Mamba state (B, ssm_heads, head_dim, ssm_state).  States are
    float32, KV in the model dtype."""
    check_supported(cfg)
    dt = getattr(torch, cfg.dtype)
    dh = cfg.resolved_head_dim
    f32 = dict(dtype=torch.float32, device=device)

    def kv(cap):
        return init_kv_cache(batch, cap, cfg.num_kv_heads, dh, dt, device)

    def sub_cache(kind):
        if kind in ATTN_KINDS:
            local = "local" in kind and cfg.sliding_window
            return (kv(min(cfg.sliding_window, capacity) if local
                       else capacity),)
        if kind == "mlstm":
            H = cfg.num_heads
            dhh = 2 * cfg.d_model // H
            return ((torch.zeros(batch, H, dhh, dhh, **f32),
                     torch.zeros(batch, H, dhh, **f32),
                     torch.full((batch, H), -1e30, **f32)),)
        if kind == "slstm":
            d = cfg.d_model
            return ((torch.zeros(batch, d, **f32),
                     torch.zeros(batch, d, **f32),
                     torch.full((batch, d), -1e30, **f32)),)
        cap = (min(cfg.sliding_window, capacity) if cfg.sliding_window
               else capacity)
        return (kv(cap), torch.zeros(batch, cfg.ssm_heads, dh, cfg.ssm_state,
                                     **f32))

    return [sub_cache(kind) for kind in layer_kinds(cfg)]


def decode_step(params, cache: list, batch, pos, cfg, *, mesh=None,
                fsdp=None, cache_specs=None):
    """One-token decode.  batch["tokens"]: (B, 1); ``pos``: the scalar
    absolute position of the token (an int or a 0-d tensor; the batch
    decodes in lockstep).  Returns float32 logits (B, vocab) and the new
    cache (the KV buffers written in place, the recurrent states new).
    Under a ``mesh`` the ranks that share the MoE's expert axes decode
    the same batch (ranks at other 'data' coordinates may decode other
    rows) and ``params`` are each rank's ``sharding.local_params``: the
    MoE sublayers split the experts over the mesh and sum their partial
    outputs.  With ``fsdp`` (``sharding.FSDP``) ``params`` are instead
    this rank's blocks under ``fsdp.specs``, each layer's gathered whole
    just before it runs, as in :func:`forward` (the dry run's layout of
    a decode step).  With ``cache_specs`` (``sharding.cache_specs``)
    ``cache`` holds this rank's blocks: each layer's is gathered whole
    but for the batch rows before the layer runs and its new value
    written back into the blocks in place (``sharding.gather_cache`` /
    ``keep_cache_block``)."""
    if cfg.input_kind == "frames":
        raise ValueError("encoder-only architectures do not decode")
    check_supported(cfg)
    x = _embed(_top(params, fsdp, ("embed",)), batch["tokens"], cfg)
    positions = torch.full((1,), int(pos), dtype=torch.long,
                           device=x.device)
    attend = partial(attention_sublayer, positions=positions)
    new_cache = []
    specs = (fsdp.specs["layers"] if fsdp is not None
             else [None] * len(cache))
    for p, kind, c, spec, cs in zip(params["layers"], layer_kinds(cfg),
                                    cache, specs,
                                    cache_specs or [None] * len(cache)):
        whole = c if cs is None else SH.gather_cache(c, cs, mesh)
        x, _, _, nc = _apply_sublayer(x, p, kind, cfg, attend, cache=whole,
                                      mesh=mesh, dp_axes=(), fsdp=fsdp,
                                      spec=spec)
        if cs is not None:
            nc = SH.keep_cache_block(c, nc, cs, mesh)
        new_cache.append(nc)
    return (_logits(_top(params, fsdp, ("final_norm", "unembed")), x[:, 0],
                    cfg), new_cache)


def _embed(params, tokens, cfg):
    dt = getattr(torch, cfg.dtype)
    return params["embed"][tokens.long()].to(dt) * (cfg.d_model ** 0.5)


def _embed_inputs(params, batch, cfg):
    """The model's input rows, in the model dtype, times sqrt(d): token
    embeddings; frame embeddings ``features`` (B, S, d) through
    ``frontend_proj``; or image patch embeddings ``image_embeds`` (B, n, d)
    through ``img_proj`` followed by the text tokens' embeddings."""
    dt = getattr(torch, cfg.dtype)
    if cfg.input_kind == "tokens":
        return _embed(params, batch["tokens"], cfg)
    if cfg.input_kind == "frames":
        x = batch["features"].to(dt) @ params["frontend_proj"].to(dt)
    elif cfg.input_kind == "mixed":
        img = batch["image_embeds"].to(dt) @ params["img_proj"].to(dt)
        tok = params["embed"][batch["tokens"].long()].to(dt)
        x = torch.cat([img, tok], dim=1)
    else:
        raise ValueError(cfg.input_kind)
    return x * (cfg.d_model ** 0.5)


def _logits(params, x, cfg):
    x = rms_norm(x, params["final_norm"])
    return softcap((x @ params["unembed"].to(x.dtype)).float(),
                   cfg.final_softcap)


def _layers(params, x, cfg, *, positions, cache, page_table, prefill,
            offsets=None, attn_impl="pallas", mesh=None):
    for p, kind, pages in zip(params["layers"], layer_kinds(cfg), cache):
        def attend(h, p_attn, cfg, *, is_local, cache, pages=pages):
            return paged_attention_sublayer(
                h, p_attn, cfg, is_local=is_local, positions=positions,
                pages=pages, page_table=page_table, prefill=prefill,
                offsets=offsets, attn_impl=attn_impl), None
        x = _apply_sublayer(x, p, kind, cfg, attend, mesh=mesh,
                            dp_axes=())[0]
    return x


def forward(params, batch, cfg, *, mesh=None, dp_axes=("pod", "data"),
            fsdp=None, last_only: bool = False, with_stats: bool = False):
    """Full-sequence forward (training and prefill).  ``batch`` holds the
    input kind's arrays: ``tokens`` (B, S) token ids; ``features`` (B, S,
    d) frame embeddings; or ``image_embeds`` (B, n, d) and ``tokens`` (B,
    S - n), the image positions first.  Returns float32 logits (B, S,
    vocab), or (B, 1, vocab) for the last position with ``last_only``,
    and the layers' summed auxiliary loss (float32 scalar), plus
    ``{"moe_overflow"}`` (the layers' summed ``ep_a2a`` overflow share)
    with ``with_stats``.  Attention is causal unless ``cfg.causal`` is
    False (an encoder's).

    Under a mesh, ``batch`` and ``params`` are this rank's (its batch rows
    when the batch is split over ``dp_axes``; its blocks of the leaves,
    ``sharding.shard_params``, with ``fsdp``, else its
    ``sharding.local_params``); every block but the MoE sublayer runs
    whole on each rank.  With ``fsdp`` each leaf is gathered whole just
    before its use: a layer's inside its checkpoint region (the backward's
    recompute gathers it again), the embeddings before the first layer and
    the head after the last; outside a region, autograd saves a gathered
    leaf as its shard and the backward gathers it again
    (``collectives.regather_saved``), so under every plan the graph holds
    no whole leaf."""
    if fsdp is None:
        return _forward(params, batch, cfg, mesh, dp_axes, None, last_only,
                        with_stats)
    with regather_saved():
        return _forward(params, batch, cfg, mesh, dp_axes, fsdp, last_only,
                        with_stats)


def _forward(params, batch, cfg, mesh, dp_axes, fsdp, last_only,
             with_stats):
    check_supported(cfg)
    if cfg.is_moe:
        check_moe(cfg)
    x = _embed_inputs(_top(params, fsdp, ("embed", "frontend_proj",
                                           "img_proj")), batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    attend = partial(attention_sublayer, positions=positions)
    sub = partial(_apply_sublayer, cfg=cfg, attend=attend, mesh=mesh,
                  dp_axes=dp_axes, fsdp=fsdp)
    mode, payload = CK.plan_policies(
        CK.resolve_plan(config=cfg.remat_policy).plan, cfg.block_pattern)
    if not torch.is_grad_enabled():
        mode = "full"
    if mode == "per_kind":
        sub = partial(_checkpointed, sub, payload)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    overflow = torch.zeros((), dtype=torch.float32, device=x.device)
    P = cfg.pattern_period
    for g in range(cfg.num_groups):
        specs = (fsdp.specs["layers"][g * P:(g + 1) * P]
                 if fsdp is not None else [None] * P)
        group = partial(_apply_group, sub=sub,
                        layers=params["layers"][g * P:(g + 1) * P],
                        kinds=cfg.block_pattern, specs=specs)
        if mode == "group":
            x, a, o = CK.checkpoint(group, x, policy=payload)
        else:
            x, a, o = group(x)
        aux = aux + a
        overflow = overflow + o
    if last_only:
        x = x[:, -1:]
    logits = _logits(_top(params, fsdp, ("final_norm", "unembed")), x, cfg)
    if with_stats:
        return logits, aux, {"moe_overflow": overflow}
    return logits, aux


def _top(params, fsdp, keys) -> dict:
    """``params``' top-level leaves ``keys`` (those it has), whole."""
    part = {k: params[k] for k in keys if k in params}
    if fsdp is None:
        return part
    return fsdp.gather(part, {k: fsdp.specs[k] for k in part})


def _apply_group(x, *, sub, layers, kinds, specs):
    """One pattern group: its sublayers in order, their auxiliary losses
    and overflow shares summed."""
    aux = overflow = 0.0
    for p, kind, spec in zip(layers, kinds, specs):
        x, a, o, _ = sub(x, p, kind, spec=spec)
        aux = aux + a
        overflow = overflow + o
    return x, aux, overflow


def _checkpointed(sub, policies, x, p, kind, spec=None):
    """``sub`` in a checkpoint region of its own, with its kind's policy
    (the ``per_kind`` application)."""
    return CK.checkpoint(partial(sub, p=p, kind=kind, spec=spec), x,
                         policy=policies[kind])


def train_loss(params, batch, cfg, *, mesh=None, dp_axes=("pod", "data"),
               fsdp=None):
    """Next-token cross entropy (labels < 0 masked) plus the auxiliary
    loss.  Returns ``(loss, {"ce", "aux", "moe_overflow"})``.  Image
    positions (mixed inputs) carry no loss: their logits are dropped
    before the shift.  An encoder (``cfg.causal`` False) predicts each
    position's own label, with no shift.

    Under a mesh whose ``dp_axes`` split the batch, the cross entropy is
    the global masked mean: this rank's masked sum over the mask count
    summed over those axes.  The returned ``loss`` is then this rank's
    share, whose gradients summed over the data axes are the global
    loss's; ``metrics["ce"]`` is the global cross entropy (no gradient)."""
    logits, aux, stats = forward(params, batch, cfg, mesh=mesh,
                                 dp_axes=dp_axes, fsdp=fsdp, with_stats=True)
    labels = batch["labels"].long()
    if cfg.input_kind == "mixed":
        logits = logits[:, batch["image_embeds"].shape[1]:]
    if cfg.causal:
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    count = mask.sum()
    data = _data_group(mesh, dp_axes)
    if data is not None:
        count = all_reduce_(count.detach().clone(), data)
    ce = (nll * mask).sum() / torch.clamp(count, min=1.0)
    ce_all = ce.detach()
    if data is not None:
        ce_all = all_reduce_(ce_all.clone(), data)
    return ce + aux, {"ce": ce_all, "aux": aux,
                      "moe_overflow": stats["moe_overflow"]}


def _data_group(mesh, dp_axes):
    """The process group the batch is split over, or None."""
    if mesh is None:
        return None
    axes = tuple(a for a in mesh.axis_names if a in dp_axes)
    return mesh.group(axes) if axes else None


def prefill(params, tokens, lengths, cache, page_table, cfg, *, mesh=None,
            offsets=None, attn_impl: str = "pallas"):
    """Whole-prompt forward that fills the paged cache in one call.

    tokens: (B, S) right-padded prompts; lengths: (B,) true lengths;
    page_table: (B, pages_per_seq) int32.  Every position is written through
    the page table (pad tails land on the trash page or in slots that decode
    overwrites before reading).  Returns float32 logits (B, vocab) at each
    request's last prompt token.

    With ``offsets`` (B,) (prefix sharing), ``tokens`` holds each request's
    unshared suffix (``lengths`` the suffix lengths): rows are written at
    absolute ``offsets[b] + t`` and attend through the page table, reading
    the shared prefix from the cache; the logits row is still the last real
    token (relative index ``lengths - 1``).  ``attn_impl`` is accepted for
    the reference's signature; prefill attends without the paged kernel.
    Raises ``ValueError`` for frame and mixed inputs, as the reference
    does.  Under a ``mesh`` every rank runs the same batch and ``params``
    are its ``sharding.local_params`` (as in :func:`decode_step`)."""
    check_supported(cfg)
    if cfg.input_kind != "tokens":
        raise ValueError("paged serving decodes token streams")
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=x.device)
    if offsets is not None:
        positions = offsets.long()[:, None] + positions[None, :]
    x = _layers(params, x, cfg, positions=positions, cache=cache,
                page_table=page_table, prefill=True, offsets=offsets,
                attn_impl=attn_impl, mesh=mesh)
    idx = torch.clamp(lengths.long() - 1, 0, S - 1)
    x_last = x[torch.arange(B, device=x.device), idx]
    return _logits(params, x_last, cfg)


def paged_decode_step(params, cache, tokens, lengths, page_table, cfg, *,
                      mesh=None, attn_impl: str = "pallas"):
    """One decode step with every request at its own position.

    tokens: (B, 1) last token per request; lengths: (B,) int32 position the
    token is written at.  ``attn_impl`` picks the paged-attention
    implementation (``pallas``: the kernel; ``dense``: the plain gather).
    Returns float32 logits (B, vocab).  ``mesh`` as in :func:`prefill`."""
    check_supported(cfg)
    x = _embed(params, tokens, cfg)
    x = _layers(params, x, cfg, positions=lengths, cache=cache,
                page_table=page_table, prefill=False, attn_impl=attn_impl,
                mesh=mesh)
    return _logits(params, x[:, 0], cfg)
