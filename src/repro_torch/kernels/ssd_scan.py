"""Mamba-2 chunked SSD scan: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro.kernels.ssd_scan`` (the Pallas TPU kernel
``_ssd_kernel``).  ``ssd_scan_fwd`` launches ``csrc/ssd_scan.cu`` on CUDA
tensors and counts its launches in ``ssd_scan_fwd.launches``;
``ssd_scan_plain`` computes the same function in plain PyTorch, chunk by
chunk in the kernel's order.

Layouts (``kernels.ops.ssd_scan`` transposes from the model layout):
  xdt: (B, H, L, P)  = dt * x
  da:  (B, H, L)     = dt * a_h, float32 (<= 0: decay increments)
  b:   (B, G, L, S)  input->state (G groups, H % G == 0)
  c:   (B, G, L, S)  state->output
  y:   (B, H, L, P)  in xdt's dtype

Per chunk of ``chunk`` rows, in float32:
  cum_i   = cumsum(da)_i
  y_intra = ((c @ b^T) * exp(cum_i - cum_j) * [j <= i]) @ xdt
  y_inter = (c @ state^T) * exp(cum)
  state'  = exp(cum_Q) * state + ((exp(cum_Q - cum) * xdt)^T @ b)

L need not be a multiple of ``chunk``: the last chunk is short.  That is
the JAX wrapper's zero padding (da = 0 leaves the state alone, xdt = b = 0
add nothing) without the copy; the plain version pads, the kernel masks.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ssd_scan_plain(xdt: torch.Tensor, da: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """The kernel's function in plain PyTorch, float32 inside, one chunk
    at a time with the (B, H, P, S) state carried between chunks."""
    bs, h, l, p = xdt.shape
    g = b.shape[1]
    pad = (-l) % chunk
    xf = F.pad(xdt.float(), (0, 0, 0, pad))
    daf = F.pad(da.float(), (0, pad))
    # head h reads group h // (H // G)
    bf = b.float().repeat_interleave(h // g, dim=1)
    cf = c.float().repeat_interleave(h // g, dim=1)
    bf = F.pad(bf, (0, 0, 0, pad))
    cf = F.pad(cf, (0, 0, 0, pad))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xdt.device))
    state = xf.new_zeros((bs, h, p, b.shape[3]))
    ys = []
    for l0 in range(0, l + pad, chunk):
        x_c = xf[:, :, l0:l0 + chunk]                       # (B, H, Q, P)
        b_c = bf[:, :, l0:l0 + chunk]                       # (B, H, Q, S)
        c_c = cf[:, :, l0:l0 + chunk]
        cum = torch.cumsum(daf[:, :, l0:l0 + chunk], dim=-1)
        total = cum[..., -1:]                               # (B, H, 1)
        seg = cum[..., :, None] - cum[..., None, :]
        seg = torch.where(mask, seg, torch.full_like(seg, -1e30))
        y = ((c_c @ b_c.transpose(-1, -2)) * torch.exp(seg)) @ x_c
        y = y + (c_c @ state.transpose(-1, -2)) * torch.exp(cum)[..., None]
        ys.append(y)
        w = torch.exp(total - cum)[..., None] * x_c         # (B, H, Q, P)
        state = (torch.exp(total)[..., None] * state
                 + w.transpose(-1, -2) @ b_c)
    return torch.cat(ys, dim=2)[:, :, :l].to(xdt.dtype)


def _check(xdt: torch.Tensor, da: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor, chunk: int) -> None:
    for name, t in (("xdt", xdt), ("da", da), ("b", b), ("c", c)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != xdt.device:
            raise ValueError("xdt, da, b and c must lie on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xdt.dtype not in _DTYPES:
        raise ValueError(f"dtype {xdt.dtype} not supported; "
                         f"one of {list(_DTYPES)}")
    if b.dtype != xdt.dtype or c.dtype != xdt.dtype:
        raise ValueError(f"b {b.dtype} and c {c.dtype} must have xdt's "
                         f"dtype {xdt.dtype}")
    if da.dtype != torch.float32:
        raise ValueError(f"da must be float32, got {da.dtype}")
    if xdt.dim() != 4 or da.dim() != 3 or b.dim() != 4:
        raise ValueError(f"want xdt (B,H,L,P), da (B,H,L), b/c (B,G,L,S); "
                         f"got {tuple(xdt.shape)}, {tuple(da.shape)}, "
                         f"{tuple(b.shape)}")
    bs, h, l, p = xdt.shape
    g, s = b.shape[1], b.shape[3]
    if (tuple(da.shape) != (bs, h, l) or tuple(b.shape) != (bs, g, l, s)
            or c.shape != b.shape):
        raise ValueError(f"shapes xdt {tuple(xdt.shape)} da "
                         f"{tuple(da.shape)} b {tuple(b.shape)} c "
                         f"{tuple(c.shape)} do not match")
    if g < 1 or h % g:
        raise ValueError(f"heads {h} not a multiple of groups {g}")
    if not 1 <= p <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {p} not in [1, {MAX_HEAD_DIM}]")
    if not 1 <= s <= MAX_STATE:
        raise ValueError(f"d_state {s} not in [1, {MAX_STATE}]")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in [1, {MAX_CHUNK}]")


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def ssd_scan_fwd(xdt: torch.Tensor, da: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: xdt (B, H, L, P) and
    b/c (B, G, L, S) contiguous, float32 or bfloat16; da (B, H, L) float32;
    P <= 64, S <= 128, chunk <= 128.  Returns y (B, H, L, P) in xdt's
    dtype.  Raises on anything the kernel does not take, and if the launch
    fails."""
    _check(xdt, da, b, c, chunk)
    bs, h, l, p = xdt.shape
    g, s = b.shape[1], b.shape[3]
    y = torch.empty_like(xdt)
    if y.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_fwd(xdt.data_ptr(), da.data_ptr(), b.data_ptr(),
                               c.data_ptr(), y.data_ptr(), _DTYPES[xdt.dtype],
                               bs, h, g, l, p, s, chunk, stream)
    if err != 0:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan kernel launch failed: {msg}")
    ssd_scan_fwd.launches += 1
    return y


ssd_scan_fwd.launches = 0
