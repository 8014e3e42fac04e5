"""Flash attention forward: the CUDA kernels' wrapper and their plain version.

Counterpart of ``repro.kernels.flash_attention`` (the Pallas TPU kernel
``_flash_fwd_kernel``).  Two CUDA kernels compute it, and ``ROUTES`` picks
one by (dtype, head dim): ``"sm90"`` is ``csrc/flash_attention_sm90.cu``
(bf16 on the tensor cores, wgmma fed by TMA) for bf16 at head dims 64, 72
(the 2D DiT's, its product depth padded to 80 inside the kernel) and 128,
and ``"cuda_cores"`` is ``csrc/flash_attention.cu`` (f32 FMAs) for the
rest: f32 stays there, since the tensor cores would compute in TF32 and
miss its 1e-4 bar.  ``flash_attention_fwd``
launches the routed kernel on CUDA tensors and counts its launches in
``flash_attention_fwd.launches``, by route in
``flash_attention_fwd.route_launches``, by head dim in
``flash_attention_fwd.head_dim_launches`` and by (q heads, K/V heads) in
``flash_attention_fwd.heads_launches``.  ``flash_attention_plain``
computes the same function in plain PyTorch with the kernels' semantics,
including their one difference from ``ref.attention_ref``: a fully masked
row outputs 0, not a uniform average of V.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 72, 128, 160, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SM90_HEAD_DIMS = (64, 72, 128)
# (dtype, head dim) -> the kernel that takes it
ROUTES = {(dtype, d): ("sm90" if dtype == torch.bfloat16
                       and d in SM90_HEAD_DIMS else "cuda_cores")
          for dtype in _DTYPES for d in HEAD_DIMS}
# route -> its source in csrc/, which also prefixes its C entry points
_KERNELS = {"sm90": "flash_attention_sm90", "cuda_cores": "flash_attention"}


def _mask(sq: int, skv: int, *, causal: bool, window: Optional[int],
          q_offset: int, device) -> torch.Tensor:
    q_pos = q_offset + torch.arange(sq, device=device)
    k_pos = torch.arange(skv, device=device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in float32: q (B, Hq, Sq, D),
    k/v (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's dtype."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    s = torch.einsum("bhgqd,bhkd->bhgqk",
                     q.reshape(b, hkv, g, sq, d).float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = _mask(sq, skv, causal=causal, window=window, q_offset=q_offset,
                 device=q.device)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)                       # exp(-inf) = 0 where masked
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(b, hq, sq, d).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, S, D), got {t.shape}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported; "
                         f"one of {list(_DTYPES)}")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if hq % k.shape[1]:
        raise ValueError(f"query heads {hq} not a multiple of kv heads "
                         f"{k.shape[1]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported; one of {HEAD_DIMS}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v must lie on one device")


def _entry(route: str):
    """The routed kernel's launch function and error-string function."""
    name = _KERNELS[route]
    lib = build.load(name)
    fn, err = getattr(lib, f"{name}_fwd"), getattr(lib, f"{name}_error_string")
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None,
                        q_offset: int = 0,
                        route: Optional[str] = None) -> torch.Tensor:
    """Launch a CUDA kernel on the current stream: q (B, Hq, Sq, D),
    k/v (B, Hkv, Skv, D), contiguous, float32 or bfloat16 on one card.
    ``route`` defaults to ``ROUTES[(dtype, D)]``; naming one runs that
    kernel instead (to time one design against the other).  Raises on
    anything the kernel does not take, and if the launch fails."""
    _check(q, k, v)
    table = ROUTES[(q.dtype, q.shape[-1])]
    route = table if route is None else route
    if route not in _KERNELS:
        raise ValueError(f"route {route!r} not in {sorted(_KERNELS)}")
    if route == "sm90":
        if table != "sm90":
            raise ValueError(f"the sm90 kernel takes bfloat16 at head dims "
                             f"{SM90_HEAD_DIMS}, got {q.dtype}, "
                             f"{q.shape[-1]}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} is not 16-byte aligned (TMA)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn, error_string = _entry(route)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], b, hq, hkv, sq, skv, d,
                 d ** -0.5 if scale is None else scale, int(causal),
                 0 if window is None else window,
                 0.0 if softcap is None else softcap, q_offset, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {route} kernel launch failed: "
                           f"{error_string(err).decode()}")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.route_launches[route] += 1
    flash_attention_fwd.head_dim_launches[d] += 1
    heads = flash_attention_fwd.heads_launches
    heads[(hq, hkv)] = heads.get((hq, hkv), 0) + 1
    return out


def reset_launches() -> None:
    """Set the launch count and every route's, head dim's and head
    count's count to 0."""
    flash_attention_fwd.launches = 0
    flash_attention_fwd.route_launches = {r: 0 for r in _KERNELS}
    flash_attention_fwd.head_dim_launches = {d: 0 for d in HEAD_DIMS}
    flash_attention_fwd.heads_launches = {}


reset_launches()
