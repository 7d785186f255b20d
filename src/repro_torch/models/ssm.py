"""Recurrent sublayers: mLSTM and sLSTM (xLSTM) and the Mamba-style
selective heads of Hymba, with chunked scans for training and
full-sequence forwards and single-step updates for decode.

Mirrors ``repro/models/ssm.py`` function for function, with the same
formulation, chunking and float32 arithmetic:

  * mLSTM in the chunkwise form: the (D x D) matrix state carried from
    chunk to chunk, a quadratic attention-like term inside a chunk, with
    log-space max stabilization;
  * sLSTM with exponential gating and no hidden-to-gate recurrence (the
    reference's R = 0), so the stabilizer and both linear recurrences are
    associative scans;
  * Mamba heads with one scalar decay per head (no causal conv), in the
    state-materializing form or, with ``cfg.mamba_dual``, the chunked dual
    form.

PyTorch has no ``associative_scan``: :func:`assoc_scan` is a log-depth
(Hillis-Steele) scan over one axis, and the loop over chunks plays the
reference's ``lax.scan``, each chunk's prefixes combined with the carry of
the chunks before it.  Its sums run in another order than
``jax.lax.associative_scan``'s, so the two agree to float32 rounding (the
reference's own tests hold its scans to the naive recurrence at 2e-4).
Like the reference, every scan asserts that the sequence is a multiple of
its chunk (taken as ``min(chunk, S)``).  No scan is a Pallas kernel in the
reference; here they are plain PyTorch too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Generic chunked associative scan
# ---------------------------------------------------------------------------


def assoc_scan(op, elems: tuple, dim: int) -> tuple:
    """Inclusive prefix combination of ``elems`` (a tuple of tensors of
    one length along ``dim``) under the associative ``op(a, b)`` (``a``
    the earlier), in ceil(log2 n) steps."""
    n = elems[0].shape[dim]
    off = 1
    while off < n:
        a = tuple(e.narrow(dim, 0, n - off) for e in elems)
        b = tuple(e.narrow(dim, off, n - off) for e in elems)
        elems = tuple(torch.cat([e.narrow(dim, 0, off), c], dim)
                      for e, c in zip(elems, op(a, b)))
        off *= 2
    return elems


def chunked_assoc_scan(op, elems: tuple, seq_axis: int, chunk: int) -> tuple:
    """Prefix scan over ``seq_axis`` in chunks of ``min(chunk, S)``: a
    log-depth scan inside each chunk, then the carry (the last prefix of
    the chunks before) combined into it."""
    S = elems[0].shape[seq_axis]
    chunk = min(chunk, S)
    assert S % chunk == 0, (S, chunk)
    outs, carry = [], None
    for c0 in range(0, S, chunk):
        inner = assoc_scan(op, tuple(e.narrow(seq_axis, c0, chunk)
                                     for e in elems), seq_axis)
        if carry is not None:
            inner = op(tuple(c.unsqueeze(seq_axis).expand_as(i)
                             for c, i in zip(carry, inner)), inner)
        carry = tuple(i.select(seq_axis, chunk - 1) for i in inner)
        outs.append(inner)
    return tuple(torch.cat(parts, seq_axis) for parts in zip(*outs))


def _decay_op(a, b):
    """Linear recurrence y_t = a_t y_{t-1} + x_t as an associative op on
    (log a, x) pairs."""
    la1, x1 = a
    la2, x2 = b
    return la1 + la2, x1 * torch.exp(la2) + x2


def _maxplus_op(a, b):
    """m_t = max(m_{t-1} + lf_t, li_t) as an associative op on (lf, li)."""
    f1, m1 = a
    f2, m2 = b
    return f1 + f2, torch.maximum(m1 + f2, m2)


# ---------------------------------------------------------------------------
# mLSTM (matrix memory), chunkwise
# ---------------------------------------------------------------------------


def mlstm_scan(q, k, v, i_pre, f_pre, *, chunk: int = 256, state=None):
    """q, k, v: (B, S, H, D); i_pre, f_pre: (B, S, H) pre-activations;
    ``state``: optional carry-in (C (B, H, D, D), n (B, H, D), m (B, H)).
    Returns (out (B, S, H, D) in q's dtype, state out)."""
    B, S, H, D = q.shape
    dt = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    lf = F.logsigmoid(f_pre.float())
    li = i_pre.float()
    k = k * (D ** -0.5)
    chunk = min(chunk, S)
    assert S % chunk == 0
    if state is None:
        C = q.new_zeros(B, H, D, D)
        n = q.new_zeros(B, H, D)
        m = q.new_full((B, H), -1e30)
    else:
        C, n, m = state
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=q.device))
    outs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        qq, kk, vv, lff, lii = q[:, sl], k[:, sl], v[:, sl], lf[:, sl], \
            li[:, sl]
        b = torch.cumsum(lff, dim=1)                       # (B, T, H)
        total = b[:, -1]                                   # (B, H)
        w_inter = b + m[:, None]
        w_intra = b[:, :, None] - b[:, None, :] + lii[:, None, :]
        w_intra = torch.where(tri[None, :, :, None], w_intra,
                              w_intra.new_tensor(-1e30))
        m_t = torch.maximum(w_inter, w_intra.amax(dim=2))  # (B, T, H)
        inter_s = torch.exp(w_inter - m_t)
        intra_s = torch.exp(w_intra - m_t[:, :, None])
        h_inter = torch.einsum("bthd,bhde->bthe", qq, C) * inter_s[..., None]
        n_inter = torch.einsum("bthd,bhd->bth", qq, n) * inter_s
        sc = torch.einsum("bthd,bshd->btsh", qq, kk) * intra_s
        h_intra = torch.einsum("btsh,bshe->bthe", sc, vv)
        n_intra = sc.sum(dim=2)
        denom = torch.maximum((n_inter + n_intra).abs(), torch.exp(-m_t))
        outs.append((h_inter + h_intra) / denom[..., None])
        w_new = total[:, None] - b + lii
        m_new = torch.maximum(total + m, w_new.amax(dim=1))
        kw = torch.exp(w_new - m_new[:, None])[..., None] * kk
        decay = torch.exp(total + m - m_new)
        C = decay[..., None, None] * C + torch.einsum("bthd,bthe->bhde",
                                                      kw, vv)
        n = decay[..., None] * n + kw.sum(dim=1)
        m = m_new
    return torch.cat(outs, dim=1).to(dt), (C, n, m)


def mlstm_step(q, k, v, i_pre, f_pre, state):
    """Single-step update: q, k, v (B, 1, H, D); returns (out, state)."""
    return mlstm_scan(q, k, v, i_pre, f_pre, chunk=1, state=state)


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, exponential gating, R = 0)
# ---------------------------------------------------------------------------


def slstm_scan(z, o_pre, i_pre, f_pre, *, chunk: int = 1024, state=None):
    """z, o_pre, i_pre, f_pre: (B, S, D).  Returns (out, (c, n, m))."""
    B, S, D = z.shape
    dt = z.dtype
    zf = torch.tanh(z.float())
    lf = F.logsigmoid(f_pre.float())
    li = i_pre.float()
    if state is None:
        c0 = zf.new_zeros(B, D)
        n0 = zf.new_zeros(B, D)
        m0 = zf.new_full((B, D), -1e30)
    else:
        c0, n0, m0 = state
    # stabilizer scan: m_t = max(m_{t-1} + lf_t, li_t)
    li_eff = torch.cat([torch.maximum(m0 + lf[:, 0], li[:, 0])[:, None],
                        li[:, 1:]], dim=1)
    _, m = chunked_assoc_scan(_maxplus_op, (lf, li_eff), 1, chunk)
    m_prev = torch.cat([m0[:, None], m[:, :-1]], dim=1)
    a = torch.exp(lf + m_prev - m)                         # decay
    bi = torch.exp(li - m)                                 # input
    # the floor stays a normal float32 (a subnormal may flush to zero and
    # make the log and its gradient non-finite), as in the reference
    la = torch.log(torch.clamp(a, min=1e-30))
    c0_term = torch.cat([(a[:, 0] * c0 + bi[:, 0] * zf[:, 0])[:, None],
                         (bi * zf)[:, 1:]], dim=1)
    n0_term = torch.cat([(a[:, 0] * n0 + bi[:, 0])[:, None], bi[:, 1:]],
                        dim=1)
    _, c = chunked_assoc_scan(_decay_op, (la, c0_term), 1, chunk)
    _, n = chunked_assoc_scan(_decay_op, (la, n0_term), 1, chunk)
    h = torch.sigmoid(o_pre.float()) * c / torch.clamp(n.abs(), min=1.0)
    return h.to(dt), (c[:, -1], n[:, -1], m[:, -1])


# ---------------------------------------------------------------------------
# Mamba-style selective heads (Hymba)
# ---------------------------------------------------------------------------


def _chunks(t: torch.Tensor, chunk: int):
    return [p.float() for p in t.split(chunk, dim=1)]


def mamba_scan(u, dt_pre, bmat, cmat, a_log, *, chunk: int = 128,
               state=None):
    """u: (B, S, H, P); dt_pre: (B, S, H); bmat, cmat: (B, S, N); a_log:
    (H,).  h_t = exp(-exp(a_log) dt) h_{t-1} + dt u_t (x) B_t; y_t = h_t C_t.
    The (B, chunk, H, P, N) states of one chunk at a time are
    materialized.  Returns (y in u's dtype, state (B, H, P, N))."""
    B, S, H, Pd = u.shape
    N = bmat.shape[-1]
    dtp = u.dtype
    chunk = min(chunk, S)
    assert S % chunk == 0
    a = -torch.exp(a_log.float())
    h = (u.new_zeros(B, H, Pd, N, dtype=torch.float32) if state is None
         else state.float())
    ys = []
    for uf, dtv_pre, bm, cm in zip(*(_chunks(t, chunk)
                                     for t in (u, dt_pre, bmat, cmat))):
        dtv = F.softplus(dtv_pre)                          # (B, T, H)
        la = a * dtv                                       # log decay
        x = dtv[..., None, None] * uf[..., :, None] * bm[:, :, None, None, :]
        # the log decay stays (B, T, H, 1, 1): the op broadcasts it
        _, hs = assoc_scan(_decay_op, (la[..., None, None], x), 1)
        hs = hs + torch.exp(torch.cumsum(la, dim=1))[..., None, None] \
            * h[:, None]
        ys.append(torch.einsum("bshpn,bsn->bshp", hs, cm))
        h = hs[:, -1]
    return torch.cat(ys, dim=1).to(dtp), h


def mamba_step(u, dt_pre, bmat, cmat, a_log, state):
    return mamba_scan(u, dt_pre, bmat, cmat, a_log, chunk=1, state=state)


def mamba_scan_dual(u, dt_pre, bmat, cmat, a_log, *, chunk: int = 64,
                    state=None):
    """The Mamba-2 chunked dual form: inside a chunk the output comes from
    a (T x T) decay-weighted score matrix, and only the (B, H, P, N)
    boundary state is carried across chunks.  The same function as
    :func:`mamba_scan`."""
    B, S, H, Pd = u.shape
    N = bmat.shape[-1]
    dtp = u.dtype
    chunk = min(chunk, S)
    assert S % chunk == 0
    a = -torch.exp(a_log.float())
    h = (u.new_zeros(B, H, Pd, N, dtype=torch.float32) if state is None
         else state.float())
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=u.device))
    ys = []
    for uf, dtv_pre, bm, cm in zip(*(_chunks(t, chunk)
                                     for t in (u, dt_pre, bmat, cmat))):
        dtv = F.softplus(dtv_pre)                          # (B, T, H)
        cum = torch.cumsum(a * dtv, dim=1)                 # inclusive
        scores = torch.einsum("btn,bsn->bts", cm, bm)
        decay = torch.exp(torch.clamp(cum[:, :, None] - cum[:, None, :],
                                      -60.0, 0.0))         # (B, T, T, H)
        w = scores[..., None] * decay * dtv[:, None]
        w = torch.where(tril[None, :, :, None], w, w.new_zeros(()))
        y = torch.einsum("btsh,bshp->bthp", w, uf)
        y = y + torch.exp(cum)[..., None] * torch.einsum("btn,bhpn->bthp",
                                                         cm, h)
        total = cum[:, -1]
        kw = torch.exp(total[:, None] - cum) * dtv
        h = torch.exp(total)[..., None, None] * h + torch.einsum(
            "bth,bthp,btn->bhpn", kw, uf, bm)
        ys.append(y)
    return torch.cat(ys, dim=1).to(dtp), h


# ---------------------------------------------------------------------------
# Sublayers (the reference's init_*_params give the leaf shapes; the
# port draws them in interop.init_params)
# ---------------------------------------------------------------------------


def mlstm_sublayer(x, p, cfg, *, state=None, chunk: int = 256):
    """mLSTM block: up-projection to 2d, H heads of width 2d / H, the
    SiLU-gated output projected back to d.  Returns (out, state)."""
    B, S, d = x.shape
    dt = x.dtype
    H = cfg.num_heads
    dh = 2 * d // H
    u = x @ p["w_up"].to(dt)
    z = x @ p["w_z"].to(dt)
    q = (u @ p["wq"].to(dt)).reshape(B, S, H, dh)
    k = (u @ p["wk"].to(dt)).reshape(B, S, H, dh)
    v = (u @ p["wv"].to(dt)).reshape(B, S, H, dh)
    i_f = (u @ p["wif"].to(dt)).reshape(B, S, 2, H)
    i_pre = i_f[:, :, 0]
    f_pre = i_f[:, :, 1] + p["f_bias"].to(dt)
    if state is None and S > 1:
        out, new_state = mlstm_scan(q, k, v, i_pre, f_pre, chunk=chunk)
    else:
        out, new_state = mlstm_step(q, k, v, i_pre, f_pre, state)
    out = out.reshape(B, S, 2 * d) * F.silu(z)
    return out @ p["w_down"].to(dt), new_state


def slstm_sublayer(x, p, cfg, *, state=None, chunk: int = 1024):
    """sLSTM block with its post up-projection GLU.  Returns (out,
    state)."""
    B, S, d = x.shape
    dt = x.dtype
    zifo = (x @ p["w_zifo"].to(dt)).reshape(B, S, 4, d)
    z, i_pre, f_pre, o_pre = (zifo[:, :, j] for j in range(4))
    f_pre = f_pre + p["f_bias"].to(dt)
    h, new_state = slstm_scan(z, o_pre, i_pre, f_pre, chunk=min(chunk, S),
                              state=state)
    y = F.silu(h @ p["w_up1"].to(dt)) * (h @ p["w_up2"].to(dt))
    return y @ p["w_down"].to(dt), new_state


def mamba_sublayer(x, p, cfg, *, state=None, chunk: int = 256):
    """Hymba's Mamba heads: ``cfg.ssm_heads`` heads of
    ``cfg.resolved_head_dim``, state size ``cfg.ssm_state``, with the D
    skip.  Returns (out, state)."""
    B, S, d = x.shape
    dt = x.dtype
    H, dh = cfg.ssm_heads, cfg.resolved_head_dim
    u = (x @ p["w_in"].to(dt)).reshape(B, S, H, dh)
    dt_pre = x @ p["w_dt"].to(dt) + p["dt_bias"].to(dt)
    bmat = x @ p["w_b"].to(dt)
    cmat = x @ p["w_c"].to(dt)
    if state is None and S > 1:
        scan = mamba_scan_dual if cfg.mamba_dual else mamba_scan
        y, new_state = scan(u, dt_pre, bmat, cmat, p["a_log"],
                            chunk=min(chunk, S))
    else:
        y, new_state = mamba_step(u, dt_pre, bmat, cmat, p["a_log"], state)
    y = y + p["d_skip"].to(dt) * u
    return y.reshape(B, S, H * dh) @ p["w_out"].to(dt), new_state
