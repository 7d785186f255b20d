"""MoE transformer sublayer: router + MoEBlaze expert FFN, on one device or
distributed over a :class:`~repro_torch.launch.mesh.Mesh`.

Mirrors ``repro/models/moe_block.py``.  On one device (``mesh=None``),
``moe_local`` runs top-k gating on float32 logits, the kernel dispatch
build, the expert layer of ``cfg.moe_impl``, and the auxiliary
load-balance and router z losses.  The expert layers: ``"blaze"``
(``core/moe_layer.py`` over the resolved grouped-GEMM backend, with the
residual set of the checkpoint plan, ``core/checkpoint.moe_residual_mode``),
``"blaze_pallas"`` (the kernel-composed layer with its Algorithm-1
backward and a fixed residual set; a plan whose moe-scoped decisions ask
for another set raises), and the paper's baselines of
``core/baseline.py``: ``"megablocks"`` (the materialized routed buffer,
plain autograd) and ``"dense"`` (the masked dense oracle); and
``"proxy_gmm"``, the reference's cost stand-in for its dry run's probes
(``repro/models/moe_block.py:178-199``, ``_moe_proxy_ep`` at ``:220``):
the grouped GEMM's useful operations and one read of the expert bank,
NOT numerically the MoE.  The router's top-k weights are the producer of
the checkpoint tag ``MOE_GATES``.

Under a mesh each rank runs the reference's ``shard_map`` body on its own
slab (``x`` holds this rank's batch rows, ``p`` its slice of the expert
weights from ``sharding.local_params``), through one Dispatch-driven path:

  * ``ep`` — experts split over the expert axes ('model', or ('node',
    'model') on a node mesh).  Each rank gates its whole slab, slices the
    dispatch to its expert range (``routing.slice_dispatch``) and runs
    ``moe_ffn_blaze``; non-local slots land in the dead zone, where the
    grouped GEMM writes zeros.  One all-reduce sums the partial outputs.
  * ``ep_a2a`` — tokens split over 'model' as well: each rank routes its
    ``L / n`` chunk, packs its slots by destination rank with the same
    dispatch build, fills the send buffer with the ``gather_rows`` kernel
    (under ``pallas`` / ``pallas_fused``), and exchanges capacity-bounded
    buffers with ``all_to_all`` (counts first; dropped slots are counted in
    the ``a2a_overflow`` stat).  Received rows run against the local
    expert bank, whose extra trash expert collects the pad rows, and return
    by the same exchange.  ``cfg.moe_a2a_chunks > 1`` splits the buffers
    into chunks whose exchanges are issued one chunk ahead of the grouped
    GEMMs (``async_op=True`` under NCCL).
  * ``ep_a2a_hier`` — two hops on a node mesh: over 'model' to the
    destination lane, then one exchange over 'node'.
  * ``tp`` — every expert's hidden dim split over 'model'; the
    single-device layer runs per shard and one all-reduce sums.

The collectives carry ``shard_map``'s gradient semantics
(``core/collectives.py``): the slab and the router weight enter through
``enter_replicated`` over the axes whose partial outputs are summed, so
``dx`` and ``dwg`` match the single-device gradients on every rank, and
the expert shards get their own gradients.  ``moe_parallel="auto"`` under
a mesh ranks the modes with the roofline cost model (``roofline.py``, at
the H100's constants) at the rank's token slab; the caller lays the
expert leaves out for the mode chosen there (a training step by its
``param_specs``, a serving engine per slab).

The expert weights are cast to the activations' dtype before the layer,
where the reference multiplies bf16 activations by its float32 expert
weights (``moe_block.py:165-166``; ``jnp.dot`` promotes to float32).  The
port keeps the expert GEMMs on bf16 tensor cores; the gradients flow back
to the float32 masters through the cast.  ``tests/test_torch_train.py``
bounds the difference in bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import collectives as C
from repro_torch.core import gmm_backend as GB
from repro_torch.core import routing
from repro_torch.core.baseline import moe_ffn_dense, moe_ffn_megablocks
from repro_torch.core.checkpoint import (MOE_GATES, moe_residual_mode,
                                         tagged)
from repro_torch.core.memsim import _a2a_capacity
from repro_torch.core.moe_layer import moe_ffn_blaze
from repro_torch.kernels.dispatch import build_dispatch
from repro_torch.kernels.ops import gather_rows, moe_ffn_blaze_pallas

MOE_IMPLS = ("blaze", "blaze_pallas", "megablocks", "dense", "proxy_gmm")
FFN_ACTS = ("swiglu", "silu", "relu", "gelu")
MOE_PARALLEL_MODES = ("auto", "ep", "ep_a2a", "ep_a2a_hier", "tp")
_EP_MODES = ("ep", "ep_a2a", "ep_a2a_hier")


def check_supported(cfg) -> None:
    """Raise for MoE settings the port does not run yet."""
    if cfg.moe_impl not in MOE_IMPLS:
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}; known: "
                         f"{MOE_IMPLS}")
    if cfg.moe_parallel not in MOE_PARALLEL_MODES:
        raise ValueError(f"unknown moe_parallel {cfg.moe_parallel!r}; "
                         f"known: {MOE_PARALLEL_MODES}")
    acts = FFN_ACTS if cfg.moe_impl != "blaze_pallas" else ("swiglu",)
    if cfg.ffn_act not in acts:
        raise NotImplementedError(
            f"ffn_act={cfg.ffn_act!r}: moe_impl={cfg.moe_impl!r} takes "
            f"{acts}")
    if cfg.moe_impl in ("blaze", "megablocks"):
        GB.resolve(config=cfg.gmm_backend)  # raises for an unavailable one
    moe_residual_mode(cfg)  # raises for a plan that splits A from B


def resolve_moe_parallel(cfg, mesh, n_tokens: int | None = None) -> str:
    """The concrete distribution mode for (cfg, mesh): ``single``,
    ``ep``, ``ep_a2a``, ``ep_a2a_hier`` or ``tp`` (the string half of
    :func:`resolve_moe_parallel_ex`)."""
    return resolve_moe_parallel_ex(cfg, mesh, n_tokens).mode


def resolve_moe_parallel_ex(cfg, mesh, n_tokens: int | None = None, *,
                            hw=None):
    """Resolve ``cfg.moe_parallel`` against a mesh, with provenance: a
    ``roofline.ParallelDecision`` (the mode, its source and the table of
    predicted costs it was ranked from, at the H100's constants).
    ``n_tokens`` is the per-device token slab where the caller knows it;
    ``auto`` only selects a mode that is feasible at that slab.

    A forced mode is validated here, as the reference does: expert
    parallelism with ``E`` not divisible by the expert axes would drop
    experts; flat ``ep_a2a`` on a node mesh would route cross-node rows
    over the flat exchange; ``ep_a2a_hier`` without a 'node' axis has no
    second hop.  ``hw`` (a ``launch.mesh.Hardware``) prices the modes at
    other constants than the H100's."""
    from repro_torch import roofline
    if cfg.moe_parallel not in MOE_PARALLEL_MODES:
        raise ValueError(f"unknown moe_parallel {cfg.moe_parallel!r}; "
                         f"known: {MOE_PARALLEL_MODES}")
    decision = roofline.select_moe_parallel(
        cfg, mesh, n_tokens, **({} if hw is None else {"hw": hw}))
    if decision.mode == "single":
        return decision
    mode = decision.mode
    n_model = mesh.shape.get("model", 1)
    n_node = mesh.shape.get("node", 1)
    n_exp = max(n_model, 1) * max(n_node, 1)
    if mode in _EP_MODES and n_exp > 1 and cfg.num_experts % n_exp != 0:
        raise ValueError(
            f"moe_parallel={mode!r} requires num_experts divisible by the "
            f"expert axes, got E={cfg.num_experts} % n_exp={n_exp} (node x "
            "model) != 0 — E_loc = E // n_exp would silently drop experts.  "
            "Use moe_parallel='tp' or resize the mesh.")
    if mode == "ep_a2a" and n_node > 1:
        raise ValueError(
            "moe_parallel='ep_a2a' is the flat single-hop exchange; this "
            f"mesh declares a 'node' axis (n_node={n_node}) — use "
            "moe_parallel='ep_a2a_hier' (two-hop) or 'ep'.")
    if mode == "ep_a2a_hier" and n_node <= 1:
        raise ValueError(
            "moe_parallel='ep_a2a_hier' needs a factored 'model' axis: the "
            "mesh must declare a 'node' axis (see "
            "launch.mesh.make_node_mesh); this mesh has none.  Use "
            "moe_parallel='ep_a2a' on flat meshes.")
    return decision


def _aux_of(g: routing.GatingOut, cfg) -> torch.Tensor:
    return (cfg.aux_loss_weight
            * routing.load_balance_loss(g.router_probs, g.topk_experts,
                                        cfg.num_experts)
            + cfg.z_loss_weight * routing.router_z_loss(g.logits))


def _weights(p: dict, dt):
    """The expert weights w1, w3, w2 (None without one) cast to the
    activations' dtype."""
    w2 = p["w2"].to(dt) if "w2" in p else None
    return p["w1"].to(dt), p["w3"].to(dt), w2


def _gates(g: routing.GatingOut, dt) -> torch.Tensor:
    with tagged(MOE_GATES):
        return g.topk_weights.to(dt)


def _blaze(xf, gates, disp, p, cfg, rb):
    """``moe_ffn_blaze`` with the plan's residual set."""
    w1, w3, w2 = _weights(p, xf.dtype)
    return moe_ffn_blaze(xf, gates, disp, w1, w3, w2,
                         activation=cfg.ffn_act,
                         residuals=moe_residual_mode(cfg), backend=rb)


def _moe_dispatch(xf, p, cfg, g, disp, rb):
    """The Dispatch-driven expert compute over a whole or sliced dispatch:
    the tagged gates and the layer of ``cfg.moe_impl``.  Under a sliced
    dispatch ``dense`` falls through to ``moe_ffn_blaze``, as in the
    reference (the dense oracle has no dispatch to slice).  The kernel
    composition (``blaze_pallas``) runs on the sliced dispatch too, where
    the reference falls through: its grouped GEMMs write zeros in the
    dead zone, so the combine adds nothing for a non-local slot and the
    backward's slot gradients there are zero (the partial output and
    gradients of the local experts, as ``moe_ffn_blaze`` gives them)."""
    gates = _gates(g, xf.dtype)
    if cfg.moe_impl == "megablocks":
        w1, w3, w2 = _weights(p, xf.dtype)
        return moe_ffn_megablocks(xf, gates, disp, w1, w3, w2,
                                  activation=cfg.ffn_act, backend=rb)
    if cfg.moe_impl == "blaze_pallas":
        # The kernel composition has a fixed residual set; a plan whose
        # moe-scoped decisions ask for another one fails here.
        mode = moe_residual_mode(cfg)
        if mode != ("ab_yswi" if cfg.save_yswi else "ab"):
            raise ValueError(
                f"moe_impl='blaze_pallas' cannot honor the checkpoint "
                f"plan's moe-scoped residual mode {mode!r} (the kernel "
                "composition keeps a fixed residual set); use "
                "moe_impl='blaze' or drop the moe-scoped overrides")
        w1, w3, w2 = _weights(p, xf.dtype)
        return moe_ffn_blaze_pallas(xf, gates, disp, w1, w3, w2)
    return _blaze(xf, gates, disp, p, cfg, rb)


def _moe_proxy(xf, p, cfg, g):
    """``proxy_gmm`` on one device or a ``tp`` shard: the dispatch build,
    the L·k routed rows through one d -> h -> d product on the sum of the
    expert bank (one read of every expert's weights) and the gated
    combine.  A cost stand-in, not the MoE."""
    dt = xf.dtype
    L, k = g.topk_experts.shape
    disp = build_dispatch(g.topk_experts.contiguous(), cfg.num_experts)
    gates = g.topk_weights.to(dt)
    xg = xf[disp.expert_token_indices.long()]
    a = xg @ p["w1"].sum(0).to(dt)
    y_act = F.silu(a)
    if "w2" in p:
        y_act = y_act * (xg @ p["w2"].sum(0).to(dt))
    p_out = y_act @ p["w3"].sum(0).to(dt)
    parts = p_out[disp.token_index_map.reshape(-1).long()].reshape(L, k, -1)
    return torch.einsum("lk,lkd->ld", gates, parts)


def _moe_proxy_ep(xf, p, cfg, n_exp: int):
    """``proxy_gmm`` under an expert-parallel mode: about L·k / n_exp
    rows through one d -> h -> d product on the sum of the local expert
    bank, scattered back onto the slab and scaled by the mean gate, as
    the reference's ``_moe_proxy_ep``.  A cost stand-in, not the MoE."""
    dt = xf.dtype
    L = xf.shape[0]
    g = routing.top_k_gating(xf, p["wg"].to(dt), cfg.top_k)
    rows = max(L * cfg.top_k // n_exp, 1)
    ids = torch.arange(rows, device=xf.device) % L
    xg = xf[ids]
    y_act = F.silu(xg @ p["w1"].sum(0).to(dt))
    if "w2" in p:
        y_act = y_act * (xg @ p["w2"].sum(0).to(dt))
    p_out = y_act @ p["w3"].sum(0).to(dt)
    y = torch.zeros_like(xf).index_add(0, ids, p_out)
    return y * g.topk_weights.to(dt).mean(), _aux_of(g, cfg)


def moe_local(xf: torch.Tensor, p: dict, cfg, backend=None):
    """(L, d) token slab -> ((L, d), aux loss).  ``backend`` enters the
    grouped-GEMM precedence chain at the call-site slot, ``cfg.gmm_backend``
    at the config slot (``blaze`` and ``megablocks``).  Also the ``tp``
    body, on this rank's hidden shard of the expert weights."""
    check_supported(cfg)
    dt = xf.dtype
    g = routing.top_k_gating(xf, p["wg"].to(dt), cfg.top_k)
    if cfg.moe_impl == "proxy_gmm":
        return _moe_proxy(xf, p, cfg, g), _aux_of(g, cfg)
    if cfg.moe_impl == "dense":
        w1, w3, w2 = _weights(p, dt)
        y = moe_ffn_dense(xf, g.router_probs, g.topk_experts,
                          g.topk_weights.to(dt), w1, w3, w2,
                          activation=cfg.ffn_act)
        return y, _aux_of(g, cfg)
    disp = build_dispatch(g.topk_experts.contiguous(), cfg.num_experts)
    rb = (None if cfg.moe_impl == "blaze_pallas"
          else GB.resolve(backend, config=cfg.gmm_backend))
    return _moe_dispatch(xf, p, cfg, g, disp, rb), _aux_of(g, cfg)


def _moe_ep(xf, p, cfg, n_exp: int, idx: int, rb):
    """Expert-parallel body: this rank owns experts ``[idx * E_loc, (idx +
    1) * E_loc)``.  Gating and the dispatch build run on the whole slab;
    the sliced dispatch runs ``_moe_dispatch`` (``moe_ffn_blaze`` under
    ``dense``, as in the reference)."""
    E, k = cfg.num_experts, cfg.top_k
    E_loc = E // max(n_exp, 1)
    g = routing.top_k_gating(xf, p["wg"].to(xf.dtype), k)
    disp = build_dispatch(g.topk_experts.contiguous(), E)
    loc = routing.slice_dispatch(disp, idx * E_loc, count=E_loc)
    y = _moe_dispatch(xf, p, cfg, g, loc, rb)
    return y, _aux_of(g, cfg)


def _a2a_pack(ids: torch.Tensor, G: int, C: int):
    """Slot bookkeeping of one capacity-bounded exchange hop.

    ``ids`` (R,) int32 destination group per routing slot, in ``[0, G]``
    (``G`` is the trash group: rows that must not travel).  The dispatch
    build over ``G + 1`` groups keeps each group's rows in ascending order,
    so a tight capacity drops the same slots as the reference.  Returns

      ``src_of_slot`` (G*C,) int32  source row per buffer slot (-1: pad),
      ``slot_ok``     (G*C,) bool   buffer-slot occupancy,
      ``buf_idx``     (R,)   int32  destination buffer slot per row
                                    (``G*C`` = dropped),
      ``valid``       (R,)   bool   row made it under the capacity bound,
      ``sent``        (G,)   int32  rows packed per destination,
      ``dropped``     ()     int32  rows lost to the capacity bound.
    """
    R = ids.shape[0]
    dev = ids.device
    dr = build_dispatch(ids.to(torch.int32).reshape(R, 1).contiguous(), G + 1)
    ids = ids.long()
    off = dr.expert_token_offsets.long()
    pos = dr.token_index_map.reshape(-1).long() - off[ids]
    valid = (ids < G) & (pos < C)
    buf_idx = torch.where(valid, ids * C + pos, G * C)
    slot_rank = torch.arange(G, device=dev).repeat_interleave(C)
    slot_pos = torch.arange(C, device=dev).repeat(G)
    lens = dr.expert_lengths[:G].long()
    sent = torch.clamp(lens, max=C)
    slot_ok = slot_pos < sent[slot_rank]
    src_slot = torch.clamp(off[slot_rank] + slot_pos, max=R - 1)
    src_of_slot = torch.where(slot_ok,
                              dr.expert_token_indices[src_slot].long(), -1)
    dropped = (lens - sent).sum()
    i32 = torch.int32
    return (src_of_slot.to(i32), slot_ok, buf_idx.to(i32), valid,
            sent.to(i32), dropped.to(i32))


def _a2a_gather_x(xc, src_of_slot, slot_ok, k: int, rb):
    """Fill the send buffer's x rows: buffer slot <- token ``src // k``.
    Under ``pallas`` / ``pallas_fused`` the rows go through the
    ``gather_rows`` kernel (on a CUDA slab); ``ragged`` and ``segment``
    take the masked index op, as the reference takes its masked
    ``jnp.take``."""
    row_ids = torch.where(slot_ok, torch.div(src_of_slot, k,
                                             rounding_mode="floor"), -1)
    if rb.name in ("pallas", "pallas_fused"):
        return gather_rows(xc, row_ids.to(torch.int32))
    rows = xc[row_ids.long().clamp(min=0)]
    return torch.where(slot_ok[:, None], rows, rows.new_zeros(()))


def _a2a_gather(vals, src_of_slot, slot_ok, fill):
    """Fill a per-slot send buffer (gates / expert ids) by the same
    slot<->buffer gather; pad slots carry ``fill``."""
    picked = vals[src_of_slot.long().clamp(min=0)]
    return torch.where(slot_ok, picked, torch.full((), fill,
                                                   dtype=vals.dtype,
                                                   device=vals.device))


def _a2a_unpack(back, buf_idx, valid, n_rows: int):
    """Inverse of the send-buffer build: each routing slot's output row,
    gathered out of the returned buffer (dropped slots give zeros)."""
    parts = back[buf_idx.long().clamp(max=n_rows - 1)]
    return torch.where(valid[:, None], parts, parts.new_zeros(()))


def _local_expert_ffn(rx, rg, re, E_loc: int, p: dict, cfg, rb):
    """Run received k=1 slots against the local expert bank: build over
    ``E_loc + 1`` experts (the extra one collects pads and overflow) and
    slice the real range, so trash slots land in the dead zone."""
    full = build_dispatch(re.to(torch.int32).reshape(-1, 1).contiguous(),
                          E_loc + 1)
    loc = routing.slice_dispatch(full, 0, E_loc)
    return _blaze(rx, rg[:, None], loc, p, cfg, rb)


def _exchange_meta(sent, vals, n: int, cap: int, group):
    """Counts first, then the per-slot metadata; rows past each source's
    announced count are re-masked on receipt.  ``vals`` is a list of
    ``(send buffer (n*C,), fill)``; returns the received counts' mask and
    the received buffers."""
    recv_cnt = C.all_to_all(sent.reshape(n, 1), group).reshape(n)
    row_valid = (torch.arange(cap, device=sent.device)[None, :]
                 < recv_cnt[:, None]).reshape(n * cap)
    out = []
    for buf, fill in vals:
        r = C.all_to_all(buf.reshape(n, cap), group).reshape(n * cap)
        out.append(torch.where(row_valid, r, torch.full(
            (), fill, dtype=r.dtype, device=r.device)))
    return out


def _moe_ep_a2a(xf, p, cfg, mesh, rb):
    """Token-exchanged expert parallelism over 'model' (capacity-bounded,
    padding-free), as the reference's ``_moe_ep_a2a``.  Returns ``(y
    (L, d) with this rank's chunk filled and zeros elsewhere, aux,
    overflow fraction)``."""
    E, k = cfg.num_experts, cfg.top_k
    n = mesh.shape["model"]
    group = mesh.group("model")
    E_loc = E // n
    L, d = xf.shape
    Lc = L // n
    chunks = max(int(getattr(cfg, "moe_a2a_chunks", 1)), 1)
    idx = mesh.axis_index("model")
    xc = xf[idx * Lc:(idx + 1) * Lc]
    g = routing.top_k_gating(xc, p["wg"].to(xc.dtype), k)
    gates = _gates(g, xc.dtype)
    dest_rank = torch.div(g.topk_experts, E_loc,
                          rounding_mode="floor").reshape(-1)
    Cap = _a2a_capacity(cfg, Lc * k, n)
    if chunks > 1:
        Cap = -(-Cap // chunks) * chunks      # pad to a chunk multiple
    src, slot_ok, buf_idx, valid, sent, dropped = _a2a_pack(dest_rank, n,
                                                            Cap)
    send_x = _a2a_gather_x(xc, src, slot_ok, k, rb)
    send_g = _a2a_gather(gates.reshape(-1), src, slot_ok, 0)
    e_local = (g.topk_experts % E_loc).reshape(-1).to(torch.int32)
    send_e = _a2a_gather(e_local, src, slot_ok, E_loc)
    recv_g, recv_e = _exchange_meta(sent, [(send_g, 0), (send_e, E_loc)], n,
                                    Cap, group)
    if chunks == 1:
        recv_x = C.all_to_all(send_x.reshape(n, Cap, d),
                              group).reshape(n * Cap, d)
        y_rows = _local_expert_ffn(recv_x, recv_g, recv_e, E_loc, p, cfg, rb)
        back = C.all_to_all(y_rows.reshape(n, Cap, d),
                            group).reshape(n * Cap, d)
    else:
        # Buffer positions j*Cc..(j+1)*Cc of every rank are chunk j, a
        # complete (n, Cc) exchange of its own; chunk j+1's exchange is
        # issued before chunk j's grouped GEMMs.
        Cc = Cap // chunks
        sx = send_x.reshape(n, chunks, Cc, d)
        ge = recv_g.reshape(n, chunks, Cc)
        ee = recv_e.reshape(n, chunks, Cc)
        cur = C.PendingAllToAll(sx[:, 0], group)
        backs = []
        for j in range(chunks):
            nxt = (C.PendingAllToAll(sx[:, j + 1], group)
                   if j + 1 < chunks else None)
            y_j = _local_expert_ffn(cur.wait().reshape(n * Cc, d),
                                    ge[:, j].reshape(-1),
                                    ee[:, j].reshape(-1), E_loc, p, cfg, rb)
            backs.append(C.all_to_all(y_j.reshape(n, Cc, d), group))
            cur = nxt
        back = torch.stack(backs, dim=1).reshape(n * Cap, d)
    parts = _a2a_unpack(back, buf_idx, valid, n * Cap).reshape(Lc, k, d)
    yc = parts.sum(dim=1).to(xf.dtype)
    y = F.pad(yc, (0, 0, idx * Lc, L - (idx + 1) * Lc))
    overflow = dropped.float() / float(Lc * k)
    return y, _aux_of(g, cfg), overflow


def _moe_ep_a2a_hier(xf, p, cfg, mesh, rb):
    """Two-hop token exchange on a node mesh, as the reference's
    ``_moe_ep_a2a_hier``: hop 1 over 'model' to the destination lane
    ``(e // E_loc) % n_model`` inside the node, hop 2 over 'node' to the
    destination node.  Hop-1 pad rows carry the global sentinel expert
    ``E``, which lands in hop 2's trash group; hop 2's send buffer is a
    plain index op, as in the reference."""
    E, k = cfg.num_experts, cfg.top_k
    nn, nl = mesh.shape["node"], mesh.shape["model"]
    g_node, g_lane = mesh.group("node"), mesh.group("model")
    n = nn * nl
    E_loc = E // n
    L, d = xf.shape
    Lc = L // n
    gdev = mesh.flat_index(("node", "model"))
    xc = xf[gdev * Lc:(gdev + 1) * Lc]
    g = routing.top_k_gating(xc, p["wg"].to(xc.dtype), k)
    gates = _gates(g, xc.dtype)
    eg = g.topk_experts.reshape(-1).to(torch.int32)      # global expert ids
    # hop 1: align rows with their destination lane, inside the node
    dest_lane = torch.div(eg, E_loc, rounding_mode="floor") % nl
    C1 = _a2a_capacity(cfg, Lc * k, nl)
    R1 = nl * C1
    src1, ok1, buf1, valid1, sent1, drop1 = _a2a_pack(dest_lane, nl, C1)
    s1x = _a2a_gather_x(xc, src1, ok1, k, rb)
    s1g = _a2a_gather(gates.reshape(-1), src1, ok1, 0)
    s1e = _a2a_gather(eg, src1, ok1, E)                  # sentinel: global E
    r1g, r1e = _exchange_meta(sent1, [(s1g, 0), (s1e, E)], nl, C1, g_lane)
    r1x = C.all_to_all(s1x.reshape(nl, C1, d), g_lane).reshape(R1, d)
    # hop 2: one cross-node exchange; pad rows (e == E) fall into the
    # trash group nn, since E // (E_loc * nl) == nn
    dest_node = torch.clamp(torch.div(r1e, E_loc * nl, rounding_mode="floor"),
                            max=nn)
    C2 = _a2a_capacity(cfg, Lc * k, nn, clamp=R1)
    R2 = nn * C2
    src2, ok2, buf2, valid2, sent2, drop2 = _a2a_pack(dest_node, nn, C2)
    rows2 = r1x[src2.long().clamp(min=0)]
    s2x = torch.where(ok2[:, None], rows2, rows2.new_zeros(()))
    s2g = _a2a_gather(r1g, src2, ok2, 0)
    s2e = _a2a_gather(r1e, src2, ok2, E)
    r2g, r2e = _exchange_meta(sent2, [(s2g, 0), (s2e, E)], nn, C2, g_node)
    r2x = C.all_to_all(s2x.reshape(nn, C2, d), g_node).reshape(R2, d)
    # compute against the local bank; a row not owned here (pads only, by
    # construction) goes to the trash expert
    lo = gdev * E_loc
    el = torch.where((r2e >= lo) & (r2e < lo + E_loc), r2e - lo, E_loc)
    y2 = _local_expert_ffn(r2x, r2g, el, E_loc, p, cfg, rb)
    # inverse hop 2, then inverse hop 1
    b2 = C.all_to_all(y2.reshape(nn, C2, d), g_node).reshape(R2, d)
    y1 = _a2a_unpack(b2, buf2, valid2, R2)               # (R1, d)
    b1 = C.all_to_all(y1.reshape(nl, C1, d), g_lane).reshape(R1, d)
    parts = _a2a_unpack(b1, buf1, valid1, R1).reshape(Lc, k, d)
    yc = parts.sum(dim=1).to(xf.dtype)
    y = F.pad(yc, (0, 0, gdev * Lc, L - (gdev + 1) * Lc))
    # every dropped row is counted once, at its source (hop 1) or its
    # relay (hop 2)
    overflow = (drop1 + drop2).float() / float(Lc * k)
    return y, _aux_of(g, cfg), overflow


def moe_sublayer(x: torch.Tensor, p: dict, cfg, *, mesh=None,
                 dp_axes=("pod", "data"), with_stats: bool = False):
    """(B, S, d) -> ((B, S, d), aux loss), plus ``{"a2a_overflow"}`` with
    ``with_stats`` (the share of routed slots the ``ep_a2a*`` capacity
    bounds dropped; 0.0 in every other mode).

    Under a mesh, ``x`` is this rank's slab: its batch rows when the batch
    is split over ``dp_axes`` (those of the mesh's axes the caller split it
    over; pass ``()`` for a batch every rank holds whole), and ``p`` this
    rank's ``sharding.local_params`` for the mode.  The output is the
    rank's slab of the layer's output; the aux loss is averaged over the
    batch and expert ranks, as the reference's ``pmean``."""
    B, S, d = x.shape
    mode = resolve_moe_parallel(cfg, mesh, B * S)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "single":
        y, aux = moe_local(x.reshape(B * S, d), p, cfg)
        y = y.reshape(B, S, d)
        return (y, aux, {"a2a_overflow": zero}) if with_stats else (y, aux)

    check_supported(cfg)
    n_model = mesh.shape.get("model", 1)
    n_node = mesh.shape.get("node", 1)
    n_exp = n_model * n_node
    rb = GB.resolve(None, config=cfg.gmm_backend)
    if mode in ("ep_a2a", "ep_a2a_hier") and (B * S) % n_exp != 0:
        raise ValueError(
            f"moe_parallel={mode!r} splits the per-device token slab over "
            f"the expert axes: {B * S} tokens/device % n_exp={n_exp} != 0.  "
            "Pad the batch/sequence or use moe_parallel='ep'.")
    # Partials are summed over every expert axis; 'tp' splits the hidden
    # dim over 'model' only (node ranks hold identical replicas).
    psum_axes = (("node", "model") if n_node > 1 else ("model",)) \
        if mode in _EP_MODES else ("model",)
    batch_axes = tuple(a for a in mesh.axis_names if a in dp_axes)
    red_group = mesh.group(batch_axes + psum_axes)
    group = mesh.group(psum_axes)
    xf = C.enter_replicated(x.reshape(B * S, d), group)
    pl = dict(p, wg=C.enter_replicated(p["wg"], group))
    overflow = zero
    if mode in _EP_MODES and cfg.moe_impl == "proxy_gmm":
        y, aux = _moe_proxy_ep(xf, pl, cfg, n_exp)
    elif mode == "ep":
        y, aux = _moe_ep(xf, pl, cfg, n_exp, mesh.flat_index(psum_axes), rb)
    elif mode == "ep_a2a":
        y, aux, overflow = _moe_ep_a2a(xf, pl, cfg, mesh, rb)
    elif mode == "ep_a2a_hier":
        y, aux, overflow = _moe_ep_a2a_hier(xf, pl, cfg, mesh, rb)
    else:
        y, aux = moe_local(xf, pl, cfg, backend=rb)
    y = C.psum_partials(y, group).reshape(B, S, d)
    aux = C.pmean(aux, red_group)
    if not with_stats:
        return y, aux
    n_red = mesh.axis_size(batch_axes + psum_axes)
    overflow = C.all_reduce_(overflow.detach().clone(), red_group) / n_red
    return y, aux, {"a2a_overflow": overflow}
