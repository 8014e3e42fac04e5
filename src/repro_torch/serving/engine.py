"""Serving engine on one device: batched prefill + decode (counterpart of
``repro.serving.engine`` with no mesh, where the JAX engine's plan is
``mode="none"`` and every sharding hook is the identity).

``generate`` is the static-batch loop: one shared prefill, then all live
sequences step together.  Per-request ``max_new_tokens`` and EOS early-exit
are handled by masking outside the decode step.  ``serve(...,
continuous=True)`` delegates to ``serving.scheduler.ContinuousScheduler``;
the static loop stays as the reference path and the parity oracle for it.

Prefill runs the flash-attention kernel (attention layers) and the SSD
scan kernel (SSM layers) whenever the engine's tensors are on the card
(the kernels' plain versions on the CPU); decode attends and advances the
SSM state in plain PyTorch, as the JAX package's decode does in jnp.
Meshes, ``replan`` and paged serving come with the planner.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import lm as LM
from repro_torch.serving.metrics import RequestMetrics


KV_SEQ_DIM = 3          # KV leaves are (periods, B, Hkv, S, Dh)


def is_kv_leaf(path, leaf) -> bool:
    """Whether a cache leaf at key path ``path`` is a stacked KV tensor
    (the rule of JAX's ``parallel.partition.is_kv_leaf``); SSM ``conv``
    and ``state`` leaves are not."""
    return ("k" in path or "v" in path) and leaf.ndim == KV_SEQ_DIM + 2


@dataclasses.dataclass
class RequestResult:
    """What serving a request produced.  ``tokens`` includes the stop token
    when the request ended on EOS; ``metrics`` carries the wall-clock
    breakdown (None on the static reference path)."""
    tokens: List[int]
    finish_reason: str = ""              # "eos" | "budget"
    metrics: Optional[RequestMetrics] = None


@dataclasses.dataclass
class Request:
    prompt: Any                          # (S,) integer tensor or array
    max_new_tokens: int = 16
    eos_id: Optional[int] = None         # per-request stop token
    arrival_time: float = 0.0            # seconds from run start (replay)
    request_id: Optional[int] = None
    result: Optional[RequestResult] = None

    @property
    def generated(self) -> Optional[List[int]]:
        """Generated token ids (None until served)."""
        return None if self.result is None else self.result.tokens


class ServingEngine:
    """Single-device engine over ``params`` (already on ``device``)."""

    def __init__(self, params, cfg: LM.LMConfig, *, max_len: int = 512,
                 device="cuda"):
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params on {table.device}, engine on "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.max_len = max_len

    # -- steps ---------------------------------------------------------------

    @torch.no_grad()
    def _prefill(self, tokens):
        logits, caches = LM.forward_prefill(self.params, tokens, self.cfg)
        pad = self.max_len - tokens.shape[1]

        # widen the KV leaves' sequence dim to max_len for subsequent
        # decode appends; SSM leaves have no sequence dim
        def widen(path, a):
            if pad > 0 and is_kv_leaf(path, a):
                return F.pad(a, (0, 0, 0, pad))
            return a
        periods = LM.tree_map_with_path(widen, caches["periods"])
        return logits, {"pos": caches["pos"], "periods": periods}

    @torch.no_grad()
    def _decode(self, token, caches):
        return LM.forward_decode(self.params, token, caches, self.cfg)

    # -- host-side serving loop ----------------------------------------------

    def generate(self, prompts: torch.Tensor,
                 max_new_tokens: Union[int, Sequence[int]] = 16,
                 greedy: bool = True, *, eos_id: Optional[int] = None,
                 pad_id: int = 0) -> torch.Tensor:
        """prompts: (B, S) -> (B, max(max_new_tokens)) generated ids.

        ``max_new_tokens`` may be one int or a per-request sequence; rows
        that hit their budget (or emit ``eos_id``) keep stepping through the
        same decode, their outputs masked to ``pad_id``.  Without an EOS the
        loop never reads a token on the host; with ``eos_id`` the host
        inspects each token and exits early once every row finished.
        """
        if not greedy:
            raise NotImplementedError("only greedy decoding is ported")
        prompts = torch.as_tensor(prompts, device=self.device)
        b = prompts.shape[0]
        if isinstance(max_new_tokens, (int, np.integer)):
            limits = np.full((b,), int(max_new_tokens), np.int64)
        else:
            limits = np.asarray(max_new_tokens, np.int64)
            if limits.shape != (b,):
                raise ValueError(f"max_new_tokens shape {limits.shape} "
                                 f"!= batch ({b},)")
        if limits.min() < 1:
            raise ValueError("max_new_tokens must be >= 1 per request")
        steps = int(limits.max())
        if prompts.shape[1] + steps > self.max_len:
            raise ValueError(
                f"prompt {prompts.shape[1]} + new {steps} exceeds "
                f"max_len {self.max_len}")

        logits, caches = self._prefill(prompts)
        token = torch.argmax(logits[:, -1], dim=-1)[:, None]

        if eos_id is None:
            out: List[torch.Tensor] = []
            for t in range(steps):
                out.append(token[:, 0])
                if t + 1 < steps:
                    logits, caches = self._decode(token, caches)
                    token = torch.argmax(logits[:, -1], dim=-1)[:, None]
            stacked = torch.stack(out, dim=1)
            if int(limits.min()) < steps:
                keep = (torch.as_tensor(limits, device=self.device)[:, None]
                        > torch.arange(steps, device=self.device)[None])
                stacked = torch.where(keep, stacked,
                                      torch.full_like(stacked, pad_id))
            return stacked

        done = np.zeros((b,), bool)
        cols: List[np.ndarray] = []
        for t in range(steps):
            cur = token[:, 0].cpu().numpy()
            active = (~done) & (t < limits)
            cols.append(np.where(active, cur, pad_id))
            done |= active & (cur == eos_id)
            done |= (t + 1) >= limits
            if t + 1 >= steps:
                break
            if done.all():
                cols.extend([np.full((b,), pad_id, cols[0].dtype)]
                            * (steps - t - 1))
                break
            logits, caches = self._decode(token, caches)
            token = torch.argmax(logits[:, -1], dim=-1)[:, None]
        return torch.as_tensor(np.stack(cols, axis=1), device=self.device)

    def serve(self, requests: List[Request], *,
              eos_id: Optional[int] = None, pad_id: int = 0,
              continuous: bool = False, max_batch: Optional[int] = None,
              token_budget: Optional[int] = None, stream=None,
              scheduler=None):
        """Serve a list of Requests, filling ``Request.result`` on each.

        ``continuous=True`` delegates to ``ContinuousScheduler``: FIFO
        admission on arrival times, ``max_batch`` recycled slots, per-token
        ``stream`` callbacks, latency metrics.  Pass ``scheduler`` to keep
        its pool and metrics across calls.  The default static path is the
        reference oracle: one lockstep batch (equal prompt lengths), and
        continuous serving is token-identical to it.
        """
        if continuous:
            from repro_torch.serving.scheduler import ContinuousScheduler
            sched = scheduler or ContinuousScheduler(
                self, max_batch or min(len(requests), 8),
                token_budget=token_budget)
            sched.run(requests, stream=stream, eos_id=eos_id)
            return requests
        lens = {len(r.prompt) for r in requests}
        if len(lens) != 1:
            raise ValueError(f"static batch needs equal prompt lengths, "
                             f"got {sorted(lens)}")
        # per-request EOS resolves as in continuous mode (own id, else the
        # default); the static batch cannot express mixed effective ids
        eff = {r.eos_id if r.eos_id is not None else eos_id
               for r in requests}
        if len(eff) > 1:
            raise ValueError(
                f"static batch needs one effective EOS id per batch, got "
                f"{sorted(eff, key=repr)} (use continuous=True)")
        eos = eff.pop() if eff else eos_id
        prompts = torch.stack([torch.as_tensor(r.prompt, device=self.device)
                               for r in requests])
        out = self.generate(prompts, [r.max_new_tokens for r in requests],
                            eos_id=eos, pad_id=pad_id)
        arr = out.cpu().numpy()
        for i, r in enumerate(requests):
            row = arr[i, :r.max_new_tokens]
            reason = "budget"
            if eos is not None and (row == eos).any():
                row = row[:int(np.argmax(row == eos)) + 1]
                reason = "eos"
            if stream is not None:
                for t in row.tolist():
                    stream(r, int(t))
            r.result = RequestResult(tokens=row.tolist(),
                                     finish_reason=reason)
        return requests
