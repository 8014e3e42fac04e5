"""Mamba-2 chunked SSD scan: the CUDA kernels' wrapper and their plain version.

Counterpart of ``repro.kernels.ssd_scan`` (the Pallas TPU kernel
``_ssd_kernel``).  Two CUDA kernels compute it, and ``route_for`` picks one
by (dtype, P, S, chunk): ``"sm90"`` is ``csrc/ssd_scan_sm90.cu`` (bf16 on
the tensor cores, wgmma fed by TMA) for bf16 at P = 64, S = 128 and chunk
128, any G; ``"cuda_cores"`` is ``csrc/ssd_scan.cu`` (f32 FMAs) for every
other case, f32 included.  ``ssd_scan_fwd`` launches the routed kernel on
CUDA tensors and counts its launches in ``ssd_scan_fwd.launches`` and, by
route, in ``ssd_scan_fwd.route_launches``; ``ssd_scan_plain`` computes the
same function in plain PyTorch, chunk by chunk in the kernels' order.

Layouts (``kernels.ops.ssd_scan`` forms them from the model layout):
  xdt: (B, H, L, P)  = dt * x
  da:  (B, H, L)     = dt * a_h, float32 (<= 0: decay increments)
  b:   (B, G, L, S)  input->state (G groups, H % G == 0)
  c:   (B, G, L, S)  state->output
  y:   (B, H, L, P)  in xdt's dtype

The ``sm90`` kernel reads xdt, b, c and da through their strides (the last
dim of xdt, b and c unit-stride, their other strides and base addresses
16-byte aligned, as TMA's tensor maps need), so the model's (B, L, H, P)
and (B, L, G, S) tensors go in as transposed views without a copy; y comes
back in xdt's memory layout (``empty_like``).  The ``cuda_cores`` kernel
takes contiguous copies.

Per chunk of ``chunk`` rows, in float32:
  cum_i   = cumsum(da)_i
  y_intra = ((c @ b^T) * exp(cum_i - cum_j) * [j <= i]) @ xdt
  y_inter = (c @ state^T) * exp(cum)
  state'  = exp(cum_Q) * state + ((exp(cum_Q - cum) * xdt)^T @ b)

L need not be a multiple of ``chunk``: the last chunk is short.  That is
the JAX wrapper's zero padding (da = 0 leaves the state alone, xdt = b = 0
add nothing) without the copy; the plain version pads, the kernels mask.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (P, S, chunk) of the sm90 kernel: mamba2-370m's, in bf16
SM90_SHAPE = (64, 128, 128)
# route -> its source in csrc/, which also prefixes its C entry points
_KERNELS = {"sm90": "ssd_scan_sm90", "cuda_cores": "ssd_scan"}


def route_for(dtype: torch.dtype, p: int, s: int, chunk: int) -> str:
    """The kernel that takes (dtype, head dim P, state dim S, chunk):
    ``"sm90"`` for bf16 at ``SM90_SHAPE``, ``"cuda_cores"`` otherwise."""
    return ("sm90" if dtype == torch.bfloat16 and (p, s, chunk) == SM90_SHAPE
            else "cuda_cores")


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


def _tma_strides(name: str, t: torch.Tensor) -> list:
    """The (dim 0, 1, 2) element strides of a bf16 tensor the sm90 kernel
    reads through a tensor map: the last dim unit-stride, the base address
    and every stride of a dim longer than 1 a multiple of 16 bytes.  A dim
    of length 1 is never stepped, so its stride is reported as the
    contiguous one."""
    if t.stride(3) != 1:
        raise ValueError(f"{name} must have a unit-stride last dim, got "
                         f"strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned (TMA)")
    out = []
    for d in range(3):
        st = t.stride(d) if t.shape[d] > 1 else math.prod(t.shape[d + 1:])
        if (st * t.element_size()) % 16:
            raise ValueError(f"{name} stride {t.stride(d)} of dim {d} is not "
                             f"a multiple of 16 bytes (TMA)")
        out.append(st)
    return out


def _entry(route: str):
    """The routed kernel's launch function and error-string function."""
    name = _KERNELS[route]
    lib = build.load(name)
    fn, err = getattr(lib, f"{name}_fwd"), getattr(lib, f"{name}_error_string")
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + ([ctypes.c_void_p] if route == "sm90" else [])
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def ssd_scan_fwd(xdt: torch.Tensor, da: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, *, chunk: int = 128,
                 route: Optional[str] = None) -> torch.Tensor:
    """Launch a CUDA kernel on the current stream: xdt (B, H, L, P) and
    b/c (B, G, L, S), float32 or bfloat16; da (B, H, L) float32; P <= 64,
    S <= 128, chunk <= 128.  ``route`` defaults to ``route_for``'s; naming
    one runs that kernel instead (to time one design against the other).
    The ``sm90`` kernel reads its inputs through their strides and returns
    y in xdt's memory layout; the ``cuda_cores`` kernel reads contiguous
    copies and returns y contiguous.  Raises on anything the kernel does
    not take, and if the launch fails."""
    _check(xdt, da, b, c, chunk)
    bs, h, l, p = xdt.shape
    g, s = b.shape[1], b.shape[3]
    table = route_for(xdt.dtype, p, s, chunk)
    route = table if route is None else route
    if route not in _KERNELS:
        raise ValueError(f"route {route!r} not in {sorted(_KERNELS)}")
    if route == "sm90":
        if table != "sm90":
            raise ValueError(f"the sm90 kernel takes bfloat16 at (P, S, "
                             f"chunk) = {SM90_SHAPE}, got {xdt.dtype}, "
                             f"{(p, s, chunk)}")
        strides = (_tma_strides("xdt", xdt) + list(da.stride())
                   + _tma_strides("b", b) + _tma_strides("c", c))
        y = torch.empty_like(xdt)
        strides += list(y.stride()[:3])
        extra = [(ctypes.c_longlong * 15)(*strides)]
    else:
        xdt, da, b, c = (t.contiguous() for t in (xdt, da, b, c))
        y = torch.empty_like(xdt)
        extra = []
    if y.numel() == 0:
        return y
    fn, error_string = _entry(route)
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xdt.data_ptr(), da.data_ptr(), b.data_ptr(), c.data_ptr(),
                 y.data_ptr(), _DTYPES[xdt.dtype], bs, h, g, l, p, s, chunk,
                 *extra, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan {route} kernel launch failed: "
                           f"{error_string(err).decode()}")
    ssd_scan_fwd.launches += 1
    ssd_scan_fwd.route_launches[route] += 1
    return y


def reset_launches() -> None:
    """Set the launch count and every route's count to 0."""
    ssd_scan_fwd.launches = 0
    ssd_scan_fwd.route_launches = {r: 0 for r in _KERNELS}


reset_launches()
