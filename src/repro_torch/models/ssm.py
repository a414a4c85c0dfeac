"""Recurrent sequence mixers: the Mamba (SSD) mixer of the hybrid family
and the xLSTM family's mLSTM and sLSTM (the port's counterpart of
``repro.models.ssm``).

The Mamba mixer's SSD form and the mLSTM's matrix memory are both a gated
linear recurrence

    h_t = a_t * h_{t-1} + k_t v_t^T ;   y_t = q_t . h_t

computed in the chunked (gated-linear-attention) form of ``chunked_gla``:
O(S * Lc) work inside each chunk of Lc tokens and a scan over the S / Lc
chunks, each an einsum (no kernel of its own in either package). Mamba's
q and k are its C and B projections broadcast over its heads.

Sequence parallelism needs the contiguous sequence layout
(``train.step.make_runtime`` forces it for SSM and hybrid stacks): each
rank runs its slice from a zero state, then the ranks' (final state, total
log decay) summaries are gathered in linear rank order and each rank adds
the term its predecessors' states contribute (``cross_shard_correction``):
exact, and zero at one rank. Mamba's depthwise causal conv reads the last
``d_conv - 1`` inputs of the previous rank as its halo
(``Runtime.ppermute_prev_shard``; zeros on rank 0).

The sLSTM's recurrence is nonlinear, so it keeps the JAX package's
documented approximation: during training and prefill each rank starts
its recurrence from zero; the decode step is exact. The step loop runs in
Python, one token at a time.

Einsum layouts and the float32 cast points follow the JAX code line for
line. Blocks take the rank's parameter subtree (``models.factory.
shard_params``) and read every leaf through ``rt.dense``. One difference
from the JAX package: ``mamba_block(return_state=True)`` returns the raw
pre-conv inputs as the conv cache, which is what the decode step convolves
(ROADMAP.md §C).
"""

from __future__ import annotations

import types

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MambaConfig, ModelConfig, XLSTMConfig
from repro_torch.models import blocks
from repro_torch.models.spec import PSpec

QKV_AXES = ("embed", "heads", "head_dim")
GATE_AXES = ("embed", "heads")
O_AXES = ("heads", "head_dim", "embed_out")
WX_AXES = ("embed", "mamba_inner")
R_AXES = ("heads", "head_dim", None)
# square (d, d): only the output dim carries the FSDP axis
SO_AXES = ("embed_nosplit", "embed_out")
IN_PROJ_AXES = ("embed", "mamba_inner")
OUT_PROJ_AXES = ("mamba_inner", "embed_out")
CONV_AXES = ("conv", "mamba_inner")
STATE_AXES = ("state",)
INNER_NORM_AXES = ("embed_nosplit",)


# ---------------------------------------------------------------------------
# the chunked gated linear recurrence
# ---------------------------------------------------------------------------

def chunked_gla(q, k, v, log_decay, chunk: int):
    """Chunked gated linear attention.

    q, k: (B, S, H, N); v: (B, S, H, P); log_decay: (B, S, H), entries <= 0.
    Returns:
      y       (B, S, H, P)  with h0 = 0
      h_fin   (B, H, N, P)  final state
      ld_tot  (B, H)        total log decay over the shard
      la      (B, S, H)     inclusive cumulative log decay (for the h0
                            correction)
    """
    B, S, H, N = q.shape
    P = v.shape[-1]
    Lc = min(chunk, S)
    if S % Lc:
        raise ValueError(f"S={S} % chunk={Lc}")
    nc = S // Lc
    qc = q.float().reshape(B, nc, Lc, H, N)
    kc = k.float().reshape(B, nc, Lc, H, N)
    vc = v.float().reshape(B, nc, Lc, H, P)
    ld = log_decay.float().reshape(B, nc, Lc, H)
    la = torch.cumsum(ld, dim=2)                     # inclusive within chunk

    # intra-chunk: y_intra[i] = sum_{j<=i} exp(la_i - la_j) (q_i.k_j) v_j
    scores = torch.einsum("bclhn,bcmhn->bchlm", qc, kc)  # (B,nc,H,Lc,Lc)
    decay = la[..., :, None, :] - la[..., None, :, :]    # (B,nc,Lc,Lc,H)
    decay = torch.movedim(decay, -1, 2)                  # (B,nc,H,Lc,Lc)
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                device=q.device))
    # mask BEFORE the exp: the upper triangle's positive exponents overflow
    # to inf, and the backward's inf * 0 gives NaN
    w = torch.where(tri, torch.exp(torch.where(tri, decay, 0.0)), 0.0)
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", scores * w, vc)

    # chunk summaries: state_c = sum_j exp(la_L - la_j) k_j v_j^T
    wk = torch.exp(la[:, :, -1:, :] - la)                # (B,nc,Lc,H)
    state_c = torch.einsum("bclhn,bclh,bclhp->bchnp", kc, wk, vc)
    ld_chunk = la[:, :, -1, :]                           # (B,nc,H)

    # inter-chunk scan: the state entering each chunk
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=q.device)
    h_ins = []
    for c in range(nc):
        h_ins.append(h)
        h = h * torch.exp(ld_chunk[:, c])[..., None, None] + state_c[:, c]
    h_ins = torch.stack(h_ins, dim=1)                    # (B,nc,H,N,P)

    # inter-chunk contribution: y_inter[i] = exp(la_i) q_i . h_in(chunk)
    y_inter = torch.einsum("bclhn,bclh,bchnp->bclhp", qc, torch.exp(la),
                           h_ins)

    y = (y_intra + y_inter).reshape(B, S, H, P)
    ld_tot = torch.sum(log_decay.float(), dim=1)         # (B,H)
    # make la cumulative across chunks too
    chunk_off = torch.cat(
        [torch.zeros((B, 1, H), dtype=torch.float32, device=q.device),
         torch.cumsum(ld_chunk, dim=1)[:, :-1]], dim=1)
    la_full = (la + chunk_off[:, :, None, :]).reshape(B, S, H)
    return y, h, ld_tot, la_full


def cross_shard_correction(rt, q, la_full, h_fin, ld_tot):
    """The h0 term from the preceding SP ranks (contiguous layout).

    q: (B, S, H, N); la_full: (B, S, H); h_fin: (B, H, N, P); ld_tot:
    (B, H). Returns the correction ``y_corr`` (B, S, H, P), None at one
    rank (where it is exactly zero), and this rank's true final state (for
    serving).
    """
    if rt.sp_size() == 1:
        return None, h_fin
    stacked_h = rt.all_gather_sp_stack(h_fin)        # (Psp, B, H, N, P)
    stacked_ld = rt.all_gather_sp_stack(ld_tot)      # (Psp, B, H)
    psp = stacked_ld.shape[0]
    rank = rt.sp_rank()
    cs = torch.cumsum(stacked_ld, dim=0)             # inclusive
    # weight for rank p' (< rank): exp(sum_{p''=p'+1..rank-1} ld[p''])
    #   = exp(cs[rank-1] - cs[p'])
    cs_prev = cs[rank - 1] if rank > 0 else torch.zeros_like(cs[0])
    valid = (torch.arange(psp, device=cs.device) < rank)[:, None, None]
    # mask BEFORE the exp: entries at/after this rank have positive
    # exponents that overflow to inf (then inf * 0 -> NaN in the backward)
    delta = torch.where(valid, cs_prev[None] - cs, float("-inf"))
    w = torch.exp(delta)                             # (Psp, B, H)
    h0 = torch.einsum("pbh,pbhnq->bhnq", w, stacked_h)
    y_corr = torch.einsum("bshn,bsh,bhnq->bshq", q.float(),
                          torch.exp(la_full), h0)
    h_true = h0 * torch.exp(ld_tot)[..., None, None] + h_fin
    return y_corr, h_true


def _from_last_shard(rt, x):
    """The last SP rank's value of ``x`` on every rank (decode caches)."""
    if rt.sp_size() == 1:
        return x
    if rt.sp_rank() != rt.sp_size() - 1:
        x = torch.zeros_like(x)
    return rt.psum_model(x)


# ---------------------------------------------------------------------------
# Mamba (SSD) mixer
# ---------------------------------------------------------------------------

def mamba_specs(cfg: ModelConfig):
    m = cfg.mamba or MambaConfig()
    d = cfg.d_model
    di = m.expand * d
    hm = di // m.head_dim
    n = m.d_state
    return {
        "in_proj": PSpec((d, 2 * di + 2 * n + hm), IN_PROJ_AXES),
        "conv_w": PSpec((m.d_conv, di), CONV_AXES, scale=m.d_conv ** -0.5),
        "A_log": PSpec((hm,), STATE_AXES, init="zeros"),
        "dt_bias": PSpec((hm,), STATE_AXES, init="zeros"),
        "D_skip": PSpec((hm,), STATE_AXES, init="ones"),
        "norm_in": blocks.rmsnorm_specs(d),
        "norm": {"scale": PSpec((di,), INNER_NORM_AXES, init="ones")},
        "out_proj": PSpec((di, d), OUT_PROJ_AXES),
    }


def _causal_conv(rt, x, w):
    """Depthwise causal conv across rank boundaries. x (B, S, C); w (K, C).
    The first K - 1 outputs read the previous rank's last K - 1 inputs
    (zeros on rank 0). JAX's ``halo_exchange=False`` branch, which no
    caller takes, is not ported."""
    K = w.shape[0]
    halo = rt.ppermute_prev_shard(x[:, -(K - 1):])
    pad = torch.cat([halo, x], dim=1)
    S = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for o in range(K):
        out = out + pad[:, o:o + S].float() * w[o].float()
    return out.to(x.dtype)


def mamba_in(rt, p, x, cfg: ModelConfig):
    """The pre-norm input projection, split: (xin, z, B, C, dt_raw), xin
    (B, S, d_inner) the conv's raw input."""
    m = cfg.mamba or MambaConfig()
    di = m.expand * cfg.d_model
    n = m.d_state
    h = blocks.rmsnorm(p.norm_in, x, cfg.norm_eps)
    u = torch.einsum("bsd,dx->bsx", h, rt.dense(p.in_proj, IN_PROJ_AXES))
    return torch.split(u, [di, di, n, n, u.shape[-1] - 2 * di - 2 * n],
                       dim=-1)


def mamba_out(rt, p, x, y, z, cfg: ModelConfig):
    """The gated inner norm and output projection with residual: y (B, S,
    d_inner) f32, z the gate's pre-activation."""
    y = y * F.silu(z.float())
    norm = types.SimpleNamespace(scale=rt.dense(p.norm.scale,
                                                INNER_NORM_AXES))
    y = blocks.rmsnorm(norm, y.to(x.dtype), cfg.norm_eps)
    return x + torch.einsum("bsx,xd->bsd", y,
                            rt.dense(p.out_proj, OUT_PROJ_AXES))


def mamba_block(rt, p, x, cfg: ModelConfig, return_state: bool = False):
    """Pre-norm Mamba (SSD) mixer with residual. x: (B, S_local, D). With
    ``return_state`` also the decode cache, the last rank's on every rank:
    ``conv`` (B, d_conv - 1, d_inner), the last raw (pre-conv) inputs in
    x's dtype, and ``state`` (B, Hm, N, P) f32, the cross-shard-corrected
    final state."""
    m = cfg.mamba or MambaConfig()
    B, S, D = x.shape
    di = m.expand * D
    hm = di // m.head_dim
    n = m.d_state

    xin, z, Bc, Cc, dt_raw = mamba_in(rt, p, x, cfg)
    xc = _causal_conv(rt, xin, rt.dense(p.conv_w, CONV_AXES))
    xc = F.silu(xc.float())

    dt = F.softplus(dt_raw.float()
                    + rt.dense(p.dt_bias, STATE_AXES).float())  # (B,S,Hm)
    log_decay = -torch.exp(rt.dense(p.A_log, STATE_AXES).float()) * dt

    xh = xc.reshape(B, S, hm, m.head_dim)
    v = xh * dt[..., None]
    q = Cc.float()[:, :, None, :].expand(B, S, hm, n)
    k = Bc.float()[:, :, None, :].expand(B, S, hm, n)

    y, h_fin, ld_tot, la = chunked_gla(q, k, v, log_decay, m.chunk)
    y_corr, h_true = cross_shard_correction(rt, q, la, h_fin, ld_tot)
    if y_corr is not None:
        y = y + y_corr
    d_skip = rt.dense(p.D_skip, STATE_AXES).float()
    y = y + d_skip[None, None, :, None] * xh
    out = mamba_out(rt, p, x, y.reshape(B, S, di), z, cfg)
    if return_state:
        # the decode step convolves the cached inputs with the new one, so
        # the cache holds the raw in_proj slice (JAX caches the conv's
        # SiLU'd output here, repro/models/ssm.py:194, :217)
        conv = xin[:, -(m.d_conv - 1):].contiguous()   # not a view of u
        return out, {"conv": _from_last_shard(rt, conv),
                     "state": _from_last_shard(rt, h_true)}
    return out


# ---------------------------------------------------------------------------
# mLSTM mixer (xLSTM matrix memory)
# ---------------------------------------------------------------------------

def mlstm_specs(cfg: ModelConfig):
    d = cfg.d_model
    hq = cfg.num_heads
    dk = d // hq
    return {
        "wq": PSpec((d, hq, dk), QKV_AXES),
        "wk": PSpec((d, hq, dk), QKV_AXES),
        "wv": PSpec((d, hq, dk), QKV_AXES),
        "wi": PSpec((d, hq), GATE_AXES, scale=d ** -0.5),
        "wf": PSpec((d, hq), GATE_AXES, scale=d ** -0.5),
        "wo": PSpec((hq, dk, d), O_AXES),
        "norm": blocks.rmsnorm_specs(d),
    }


def mlstm_block(rt, p, x, cfg: ModelConfig, return_state: bool = False):
    """Pre-norm mLSTM with residual. x: (B, S_local, D). With
    ``return_state`` also ``{'state': (B, H, dk, dk + 1) f32}``, the last
    rank's cross-shard-corrected final state, on every rank."""
    xc = cfg.xlstm or XLSTMConfig()
    h = blocks.rmsnorm(p.norm, x, cfg.norm_eps)
    wq = rt.dense(p.wq, QKV_AXES)
    wk = rt.dense(p.wk, QKV_AXES)
    wv = rt.dense(p.wv, QKV_AXES)
    wi = rt.dense(p.wi, GATE_AXES)
    wf = rt.dense(p.wf, GATE_AXES)
    wo = rt.dense(p.wo, O_AXES)

    dk = wq.shape[-1]
    q = torch.einsum("bsd,dhk->bshk", h, wq) * dk ** -0.5
    k = torch.einsum("bsd,dhk->bshk", h, wk)
    v = torch.einsum("bsd,dhk->bshk", h, wv)
    ig = torch.sigmoid(torch.einsum("bsd,dh->bsh", h, wi).float())
    log_decay = F.logsigmoid(torch.einsum("bsd,dh->bsh", h, wf).float())

    k = k.float() * ig[..., None]                   # fold input gate into k
    v_aug = torch.cat(                              # extra channel: normaliser
        [v.float(), torch.ones(v.shape[:3] + (1,), dtype=torch.float32,
                               device=v.device)], dim=-1)
    y_aug, h_fin, ld_tot, la = chunked_gla(q.float(), k, v_aug, log_decay,
                                           xc.chunk)
    y_corr, h_true = cross_shard_correction(rt, q.float(), la, h_fin,
                                            ld_tot)
    if y_corr is not None:
        y_aug = y_aug + y_corr
    y, ndot = y_aug[..., :-1], y_aug[..., -1]
    y = y / torch.clamp(ndot.abs(), min=1.0)[..., None]
    out = x + torch.einsum("bshk,hkd->bsd", y.to(x.dtype), wo)
    if return_state:
        return out, {"state": _from_last_shard(rt, h_true)}
    return out


# ---------------------------------------------------------------------------
# sLSTM mixer (shard-local recurrence; exact at decode time)
# ---------------------------------------------------------------------------

def slstm_specs(cfg: ModelConfig):
    d = cfg.d_model
    hq = cfg.num_heads
    dh = d // hq
    return {
        "wx": PSpec((d, 4 * d), WX_AXES),
        "r": PSpec((hq, dh, 4 * dh), R_AXES, scale=dh ** -0.5),
        "norm": blocks.rmsnorm_specs(d),
        "wo": PSpec((d, d), SO_AXES),
    }


def slstm_recurrent_weight(rt, p):
    """The recurrent weight ``r`` (H, dh, 4 dh) in f32, every head.

    The JAX package reads ``r`` raw (``repro/models/ssm.py:304``,
    ``repro/serve/step.py:191``), but its ``heads`` axis is stored sharded
    over ``sp_team`` under the ``tp`` rules: there each rank's einsum
    broadcasts its own heads' slice over all heads. The port gathers ``r``
    through ``rt.dense`` like every other leaf, so ``tp`` computes what
    ``default`` does (ROADMAP.md §C)."""
    return rt.dense(p.r, R_AXES).float()


def slstm_cell(gx, hs, cs, r):
    """One sLSTM step: gx (B, H, 4 dh) input gates, hs / cs (B, H, dh) the
    state, r (H, dh, 4 dh). Returns the new (hs, cs), f32."""
    gr = torch.einsum("bhk,hkg->bhg", hs, r)
    z, i, f, o = torch.chunk(gx + gr, 4, dim=-1)
    cs = torch.sigmoid(f) * cs + torch.sigmoid(i) * torch.tanh(z)
    hs = torch.sigmoid(o) * torch.tanh(cs)
    return hs, cs


def slstm_block(rt, p, x, cfg: ModelConfig, return_state: bool = False):
    """Pre-norm sLSTM with residual, each rank's recurrence from zero.
    x: (B, S_local, D). With ``return_state`` also ``{'h', 'c'}`` (B, H,
    dh) f32, the last rank's final state, on every rank."""
    B, S, D = x.shape
    hq = cfg.num_heads
    dh = D // hq
    h = blocks.rmsnorm(p.norm, x, cfg.norm_eps)
    wx = rt.dense(p.wx, WX_AXES)
    r = slstm_recurrent_weight(rt, p)
    wo = rt.dense(p.wo, SO_AXES)

    gates_x = torch.einsum("bsd,dg->bsg", h, wx).float()
    gates_x = gates_x.reshape(B, S, hq, 4 * dh)

    hs = torch.zeros((B, hq, dh), dtype=torch.float32, device=x.device)
    cs = torch.zeros_like(hs)
    ys = []
    for t in range(S):
        hs, cs = slstm_cell(gates_x[:, t], hs, cs, r)
        ys.append(hs)
    y = torch.stack(ys, dim=1).reshape(B, S, D).to(x.dtype)
    out = x + torch.einsum("bsd,de->bse", y, wo)
    if return_state:
        return out, {"h": _from_last_shard(rt, hs),
                     "c": _from_last_shard(rt, cs)}
    return out


# (specs, block) of each recurrent mixer, by its ``layer_pattern`` name
MIXERS = {"mamba": (mamba_specs, mamba_block),
          "mlstm": (mlstm_specs, mlstm_block),
          "slstm": (slstm_specs, slstm_block)}
