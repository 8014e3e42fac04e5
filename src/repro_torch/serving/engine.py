"""Plan-aware serving engine: batched prefill + decode (counterpart of
``repro.serving.engine``), on one device or sharded under DSP or ``tp``.

``ServingEngine(params, cfg, mesh=, plan=, topology=)`` derives its
parallel triple (plan, schedule, sharder) from a ``("data", "model")``
process mesh (``launch.mesh``): the switching schedule solved on the
topology (``Topology.uniform`` by default: each transition priced at its
bytes), the parameters cut to the rank's slices by ``param_pspecs``, and
the ``Sharder``.  Prefill runs as the training forward does on the
rank's sequence shard (K1 and K2 on the rank's heads); its K/V are
re-cut onto the cache's blocks (``Sharder.kv_cache``).  The decode
caches stay sequence-sharded over ``model`` (``cache_pspecs``): each rank
attends its block and merges softmax partials with the others', and the
SSM state stays head-sharded.  ``next_tokens`` is the distributed greedy
argmax every host loop reads.  ``replan(n)`` re-derives the triple on
the first n ranks and moves the parameters; the slot pool moves its
caches itself (``KVPool.migrate``).  Under ``ParallelPlan(mode="tp")``
there is no schedule: the prefill's blocks gather the sequence and
reduce-scatter it back, the parameters are the rank's columns and rows
(``param_pspecs`` of the ``tp`` plan), the K/V re-cut is one all-to-all
from the rank's heads onto its block of the cache, and a decode step
gathers the step's q/k/v heads, attends the rank's block with every
head and sums the rows' partial outputs (one all-reduce a block).

``generate`` is the static-batch loop: one shared prefill, then all live
sequences step together.  Per-request ``max_new_tokens`` and EOS
early-exit are handled by masking outside the decode step.  ``serve(...,
continuous=True)`` delegates to ``serving.scheduler.ContinuousScheduler``,
``serve(..., paged=True)`` to ``serving.scheduler.PagedScheduler`` (the
block pool, the prefix tree and chunked prefill through ``_chunk``); the
static loop stays as the reference path and the parity oracle for both.
Decode attends and advances the SSM state in plain PyTorch, as the JAX
package's decode does in jnp; a paged prefill chunk on one device goes
through K1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import dsp
from repro_torch.core.layout import from_mesh
from repro_torch.device import resolve_device
from repro_torch.models import lm as LM
from repro_torch.parallel.partition import (
    ParallelPlan, assert_kv_cache_on_mesh, cache_pspecs,
    global_shape, make_sharder, mesh_sizes, param_pspecs, reshard,
    shard_params, tree_map_with_path)
from repro_torch.serving.metrics import RequestMetrics


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
    """``mesh``/``plan``/``topology`` derive the engine's parallel triple;
    all three default to the unsharded engine on ``device``.  ``params``
    are the whole tree, every rank alike (the engine cuts them).  On a
    mesh every rank of it constructs the engine and drives the same host
    loop."""

    def __init__(self, params, cfg: LM.LMConfig, *, max_len: int = 512,
                 mesh=None, plan: Optional[ParallelPlan] = None,
                 topology=None, device="cuda"):
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params on {table.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.max_len = max_len
        self.active = True          # False on a rank ``replan`` dropped
        self._build(mesh, plan, topology, params, None, None)
        ctx = self.sharder.ctx
        # from the first mesh, so a replan keeps the data dim's size
        self._data_axis = (ctx.size("data") if ctx is not None
                           and "data" in ctx.mesh.mesh_dim_names else 1)

    # -- (plan, schedule, sharder) derivation --------------------------------

    def _build(self, mesh, plan, topology, params, old_specs,
               old_ctx) -> None:
        """Derive the triple for ``mesh`` and lay ``params`` (laid out by
        ``old_specs`` on ``old_ctx``; whole when None) out for it."""
        if plan is None:
            plan = (ParallelPlan(mode="dsp") if mesh is not None
                    else ParallelPlan(mode="none"))
        ctx = from_mesh(mesh) if mesh is not None else None
        sp = ctx.sp_size if ctx is not None else 1
        schedule = None
        if ctx is not None and plan.mode in ("dsp", "tp"):
            if self.max_len % sp:
                raise ValueError(
                    f"max_len {self.max_len} must be divisible by the SP "
                    f"degree {sp} (the KV cache is sequence-sharded)")
        if ctx is not None and plan.mode == "dsp":
            if topology is None:
                from repro_torch.core.topology import Topology
                topology = Topology.uniform(sp)
            schedule = LM.dsp_schedule(self.cfg, sp, topology=topology)
        specs = None
        if ctx is not None and (plan.zero or plan.shard_vocab
                                or plan.mode == "tp"):
            template = tree_map_with_path(
                lambda _, p, s: torch.empty(global_shape(p.shape, s,
                                                         old_ctx),
                                            dtype=p.dtype, device="meta"),
                params, old_specs if old_specs is not None
                else tree_map_with_path(lambda *_: (), params))
            specs = param_pspecs(template, plan, axis_sizes=mesh_sizes(ctx))
        self.params = (reshard(params, old_specs, old_ctx, specs, ctx)
                       if old_specs is not None or specs is not None
                       else params)
        self.mesh, self.plan = mesh, plan
        self.topology, self.schedule = topology, schedule
        self.sharder = LM.fit_sharder(
            make_sharder(mesh, plan, schedule, param_specs=specs), self.cfg)

    @property
    def sp_degree(self) -> int:
        return self.sharder.sp_size

    def replan(self, n_devices: int):
        """Elastic resize onto the first ``n_devices`` ranks of the world
        (``launch.mesh.elastic_submesh``, shared with ``Trainer.replan``):
        the data dim kept where it divides, the plan kept, the topology
        resized, the schedule re-solved, and the parameters moved one leaf
        at a time (``reshard``).  Every rank of the world calls it; ranks
        past ``n_devices`` take part in the moves, keep nothing and go
        inactive.  At one device the mesh is dropped (plan ``none``);
        growing onto ranks that left raises ``NotImplementedError``.
        Returns self.  Callers holding live caches move them too
        (``KVPool.migrate``); ``generate`` prefills per batch and needs
        nothing more."""
        from repro_torch.launch.mesh import elastic_submesh
        old_ctx = self.sharder.ctx
        mesh, leaving = elastic_submesh(
            n_devices, data=self._data_axis,
            held=old_ctx.world_size if old_ctx is not None else 1,
            active=self.active, device_type=self.device.type,
            regrow="restart the server with that many ranks")
        old_specs = self.sharder.param_specs
        if leaving:
            reshard(self.params, old_specs, old_ctx, None, None,
                    leaving=True)
            self.params = None
            self.active = False
            self.mesh, self.plan = None, ParallelPlan(mode="none")
            self.sharder = make_sharder(None, self.plan)
            return self
        if mesh is None:
            plan, topology = ParallelPlan(mode="none"), None
        else:
            plan = self.plan
            topology = (self.topology.resized(from_mesh(mesh).sp_size)
                        if self.topology is not None else None)
        params, self.params = self.params, None
        self._build(mesh, plan, topology, params, old_specs, old_ctx)
        return self

    def shard_caches(self, caches):
        """A cache tree, whole on every rank, cut to this rank's slices on
        the engine's current mesh (``cache_pspecs``); itself off a
        mesh."""
        if self.sharder.ctx is None:
            return caches
        return shard_params(caches, cache_pspecs(caches, self.plan),
                            self.sharder.ctx)

    # -- steps ---------------------------------------------------------------

    @torch.no_grad()
    def _prefill(self, tokens):
        """tokens (B, S), the whole batch on every rank -> (logits of the
        rank's rows at the last position, caches in the rank's layout with
        the KV widened to ``max_len``).  On a mesh the prompt is padded on
        the right to ``lm.prefill_shard_len`` positions a rank, the rank
        runs its batch slice and sequence shard, and the K/V are re-cut
        onto the cache's blocks (``Sharder.kv_cache``)."""
        sh = self.sharder
        tokens = torch.as_tensor(tokens, device=self.device)
        s = tokens.shape[1]
        if sh.ctx is None:
            logits, caches = LM.forward_prefill(self.params, tokens, self.cfg)
        else:
            n = sh.sp_size
            tokens = F.pad(tokens, (0, n * LM.prefill_shard_len(
                self.cfg, s, n) - s))
            local = LM.shard_lm_batch({"tokens": tokens}, sh)["tokens"]
            logits, caches = LM.forward_prefill(self.params, local, self.cfg,
                                                sharder=sh, length=s)
        periods = {}
        for j, pc in caches["periods"].items():
            if "kv" in pc:
                kv = sh.kv_cache(torch.stack([pc["kv"]["k"], pc["kv"]["v"]]),
                                 s, self.max_len)
                pc = {"kv": {"k": kv[0], "v": kv[1]}}
            periods[j] = pc
        return logits, {"pos": caches["pos"], "periods": periods}

    @torch.no_grad()
    def _decode(self, token, caches):
        """token (B, 1), the whole batch on every rank (the rank decodes
        its rows over ``data``) -> (logits of the rank's rows, caches)."""
        sh = self.sharder
        token = torch.as_tensor(token, device=self.device)
        if sh.dp_size > 1:
            token = dsp.shard(token, 0, sh.dp_size, sh.dp_index)
        return LM.forward_decode(self.params, token, caches, self.cfg,
                                 sharder=sh)

    @torch.no_grad()
    def _chunk(self, tokens, caches, slot: int, start: int):
        """One prefill chunk of a block-pool slot (JAX's ``_chunk_impl``):
        tokens (1, c), whole on every rank, advance ``slot``'s row of the
        pool through the decode path's layers (per-row position masking
        makes c > 1 causal), so a long prompt streams into its blocks
        slice by slice while the rest of the pool decodes between slices.
        ``start`` is the row's position, a host int the scheduler holds: K1
        takes it as its query offset on one device.  Returns (logits (1, c,
        V or the rank's vocab chunk), caches with the slot's ``pos``
        advanced by c)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        row = {"pos": caches["pos"][slot:slot + 1],
               "table": caches["table"][slot:slot + 1],
               "periods": caches["periods"]}
        logits, new = LM.forward_decode(self.params, tokens, row, self.cfg,
                                        sharder=self.sharder, start=start)
        caches["pos"][slot:slot + 1] = new["pos"]
        return logits, caches

    @torch.no_grad()
    def next_tokens(self, logits) -> torch.Tensor:
        """The greedy tokens (B,) of the whole batch, the same on every
        rank: the argmax of the last position over the vocab
        (``lm.sharded_argmax``: one all-gather where the logits are
        vocab-sharded), the rows gathered over ``data`` (one all-gather)
        where the batch is split."""
        sh = self.sharder
        tok = LM.sharded_argmax(logits[:, -1], self.cfg, sh)
        if sh.dp_size > 1:
            tok = dsp.gather(tok, 0, sh.ctx.group("data"))
        return tok

    # -- host-side serving loop ----------------------------------------------

    def generate(self, prompts: torch.Tensor,
                 max_new_tokens: Union[int, Sequence[int]] = 16,
                 greedy: bool = True, *, eos_id: Optional[int] = None,
                 pad_id: int = 0, check_sharding: bool = False
                 ) -> torch.Tensor:
        """prompts: (B, S) -> (B, max(max_new_tokens)) generated ids.

        ``max_new_tokens`` may be one int or a per-request sequence; rows
        that hit their budget (or emit ``eos_id``) keep stepping through the
        same decode, their outputs masked to ``pad_id``.  Without an EOS the
        loop never reads a token on the host; with ``eos_id`` the host
        inspects each token and exits early once every row finished.
        ``check_sharding`` asserts the prefill's KV caches landed
        sequence-sharded on the mesh (``assert_kv_cache_on_mesh``).
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
        if check_sharding:
            assert_kv_cache_on_mesh(caches["periods"], self.sharder.ctx,
                                    self.plan, self.max_len)
        token = self.next_tokens(logits)[:, None]

        if eos_id is None:
            out: List[torch.Tensor] = []
            for t in range(steps):
                out.append(token[:, 0])
                if t + 1 < steps:
                    logits, caches = self._decode(token, caches)
                    token = self.next_tokens(logits)[:, None]
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
            token = self.next_tokens(logits)[:, None]
        return torch.as_tensor(np.stack(cols, axis=1), device=self.device)

    def serve(self, requests: List[Request], *,
              eos_id: Optional[int] = None, pad_id: int = 0,
              continuous: bool = False, max_batch: Optional[int] = None,
              token_budget: Optional[int] = None, stream=None,
              scheduler=None, paged: bool = False, block_size: int = 16,
              n_blocks: Optional[int] = None, prefix_cache: bool = True,
              prefill_chunk: Optional[int] = None):
        """Serve a list of Requests, filling ``Request.result`` on each.

        ``continuous=True`` delegates to ``ContinuousScheduler``: FIFO
        admission on arrival times, ``max_batch`` recycled slots, per-token
        ``stream`` callbacks, latency metrics.  ``paged=True`` (implies
        continuous) serves through ``PagedScheduler`` instead:
        ``block_size``-token KV blocks (``n_blocks`` of them, full
        capacity by default), a radix prefix cache (``prefix_cache``) and
        chunked prefill (``prefill_chunk`` tokens a slice; None: one slice
        a prompt).  Pass ``scheduler`` to keep its pool and metrics across
        calls.  The default static path is the reference oracle: one
        lockstep batch (equal prompt lengths), and continuous serving,
        slot-based and paged, is token-identical to it.
        """
        if paged:
            from repro_torch.serving.scheduler import PagedScheduler
            sched = scheduler or PagedScheduler(
                self, max_batch or min(len(requests), 8),
                block_size=block_size, n_blocks=n_blocks,
                prefix_cache=prefix_cache, prefill_chunk=prefill_chunk)
            sched.run(requests, stream=stream, eos_id=eos_id)
            return requests
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
