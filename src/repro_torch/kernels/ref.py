"""Plain PyTorch oracles for attention and the Mamba-2 SSD scan
(counterpart of ``repro.kernels.ref``).

``attention_ref`` has the JAX oracle's semantics: a fully masked row is a
softmax over equal ``NEG_INF`` scores, i.e. a uniform average of V.  The
flash kernel's own plain version (``kernels.flash_attention``) differs
there: it outputs 0.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -2.3819763e38   # close to bf16 min, matches the JAX package


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """Reference multi-head attention.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) with Hq % Hkv == 0 (GQA).
    ``q_offset``: global position of q[..., 0, :] relative to k.
    Returns (B, Hq, Sq, D) in q's dtype; computes in float32.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, hkv, g, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor, *,
            d_skip: Optional[torch.Tensor] = None,
            init_state: Optional[torch.Tensor] = None,
            return_state: bool = False):
    """Reference Mamba-2 SSD (state-space duality) recurrence: the exact
    sequential scan the chunked kernel must reproduce.

    x:  (B, L, H, P)   per-head inputs
    dt: (B, L, H)      softplus-activated step sizes (> 0)
    a:  (H,)           negative state decay rates (A = -exp(a_log))
    b:  (B, L, G, S)   input->state projection (G groups, H % G == 0)
    c:  (B, L, G, S)   state->output projection
    d_skip: (H,)       optional skip connection weight
    init_state: (B, H, P, S) carried state; zeros if None.

    Recurrence per head h (group g = h // (H // G)):
        st_t = exp(dt_t * a_h) * st_{t-1} + dt_t * b_t (outer) x_t
        y_t  = c_t . st_t  (+ d_skip * x_t)
    Returns y (B, L, H, P) in x's dtype [and the final f32 state
    (B, H, P, S)].
    """
    bsz, l, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    if h % g:
        raise ValueError(f"heads {h} not a multiple of groups {g}")
    rep = h // g
    xf = x.float()
    dtf = dt.float()
    bf = torch.repeat_interleave(b.float(), rep, dim=2)       # (B, L, H, S)
    cf = torch.repeat_interleave(c.float(), rep, dim=2)
    decay = torch.exp(dtf * a.float()[None, None, :])           # (B, L, H)
    st = (torch.zeros((bsz, h, p, s), dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    ys = []
    for t in range(l):
        upd = torch.einsum("bhp,bhs->bhps", dtf[:, t, :, None] * xf[:, t],
                           bf[:, t])
        st = decay[:, t, :, None, None] * st + upd
        ys.append(torch.einsum("bhps,bhs->bhp", st, cf[:, t]))
    y = torch.stack(ys, dim=1)
    if d_skip is not None:
        y = y + d_skip.float()[None, None, :, None] * xf
    y = y.to(x.dtype)
    if return_state:
        return y, st
    return y


def ssd_final_state(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, *,
                    init_state: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The state ``ssd_ref(..., return_state=True)`` ends with, in closed
    form: one weighted contraction over L instead of L sequential steps,

        state[b,h,p,s] = sum_t exp(cum_L - cum_t) dt_t x_t[p] b_t[s]
                         + exp(cum_L) init_state[b,h,p,s],

    with cum_t the running sum of dt a.  The decay after t is summed from
    the end (a suffix sum), so a late term's small exponent is not the
    difference of two large running sums.  Every factor exp(.) <= 1.
    ``c`` is unused (the state does not depend on it); it keeps
    ``ssd_ref``'s signature.  Returns (B, H, P, S) float32.
    """
    del c
    bsz, l, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    if h % g:
        raise ValueError(f"heads {h} not a multiple of groups {g}")
    # (B, H, L), so the scan runs along the innermost dim: along L of a
    # (B, L, H) tensor it is an outer-dim scan, many times slower on a GPU
    da = (dt.float() * a.float()[None, None, :]).transpose(1, 2).contiguous()
    after = da.flip(-1).cumsum(-1).flip(-1)                     # incl. t
    w = torch.exp(F.pad(after[..., 1:], (0, 1))).transpose(1, 2) * dt.float()
    xw = (x.float() * w[..., None]).reshape(bsz, l, g, h // g, p)
    st = torch.einsum("blgrp,blgs->bgrps", xw, b.float()).reshape(
        bsz, h, p, s)
    if init_state is not None:
        decay = torch.exp(after[..., 0])[:, :, None, None]       # exp(cum_L)
        st = st + decay * init_state.float()
    return st


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, *,
                    d_skip: Optional[torch.Tensor] = None,
                    chunk: int = 128) -> torch.Tensor:
    """Vectorised chunked SSD: the kernel's math in straight-line PyTorch,
    all chunks batched.  JAX carries the inter-chunk combine
    ``(d1, s1), (d2, s2) -> (d1*d2, s2 + d2*s1)`` with
    ``associative_scan``; torch has none, so it is a loop over chunks that
    yields the state entering each chunk.  Differentiable: the SSD
    autograd ``Function`` takes its backward through this function."""
    bsz, l, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    rep = h // g
    ck = min(chunk, l)
    while l % ck:
        ck //= 2
    nc = l // ck

    xf = x.float().reshape(bsz, nc, ck, h, p)
    dtf = dt.float().reshape(bsz, nc, ck, h)
    bf = torch.repeat_interleave(b.float(), rep, dim=2).reshape(
        bsz, nc, ck, h, s)
    cf = torch.repeat_interleave(c.float(), rep, dim=2).reshape(
        bsz, nc, ck, h, s)
    da = dtf * a.float()[None, None, None, :]                   # (B,nc,ck,H)
    cum = torch.cumsum(da, dim=2)                                # within chunk
    total = cum[:, :, -1]                                        # (B,nc,H)

    xdt = xf * dtf[..., None]
    # intra-chunk: (B,nc,H,ck,ck) masked decay attention
    cb = torch.einsum("bnkhs,bnjhs->bnhkj", cf, bf)
    cum_t = cum.permute(0, 1, 3, 2)                              # (B,nc,H,ck)
    seg = cum_t[..., :, None] - cum_t[..., None, :]
    mask = torch.tril(torch.ones((ck, ck), dtype=torch.bool,
                                 device=x.device))
    seg = torch.where(mask, seg, torch.full_like(seg, -1e30))  # before exp
    y_intra = torch.einsum("bnhkj,bnjhp->bnkhp", cb * torch.exp(seg), xdt)

    # chunk states: (B,nc,H,P,S)
    w = torch.exp(total[:, :, None, :] - cum)[..., None] * xdt  # (B,nc,ck,H,P)
    st = torch.einsum("bnkhp,bnkhs->bnhps", w, bf)
    dec = torch.exp(total)                                       # (B,nc,H)
    # state ENTERING chunk n: the combine folded left to right
    run = torch.zeros_like(st[:, 0])
    entering = []
    for n in range(nc):
        entering.append(run)
        run = dec[:, n, :, None, None] * run + st[:, n]
    st_in = torch.stack(entering, dim=1)
    y_inter = torch.einsum("bnkhs,bnhps->bnkhp", cf, st_in) * \
        torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(bsz, l, h, p)
    if d_skip is not None:
        y = y + d_skip.float()[None, None, :, None] * x.float()
    return y.to(x.dtype)
