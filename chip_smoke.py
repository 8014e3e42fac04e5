#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero.  The gloo
ranks of 17 (b), 18 (b), 19 (b) and 20 (b) run beside the next phase's
world-1 part, 27 (e)'s beside phases 28 and 29 (a), and 31 (d)'s beside
31 (a)-(c) (``behind``): their checks print where they are joined,
before the next ranks start.

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together);
3. each kernel against its plain PyTorch version on the card, logging
   the route each case took: flash attention (K1) over its test cases and
   every shape the served trace gives it (``sm90`` for bf16 at head dims
   64, 72 and 128, ``cuda_cores`` otherwise); the SSD scan (K2) over its test
   cases, the training slice's full-width shape and a ragged length at
   that width, one row, a part chunk and two B/C groups (``sm90`` for
   bf16 at P 64 or 128, S 128, chunk 128, ``cuda_cores`` otherwise), and
   the slice on ``cuda_cores`` in bf16 too; K2 at P 128 (``JAMBA_SSD_CASES``:
   jamba's prefill with 8 B/C groups and a ragged length with one, bf16 on
   ``sm90`` and on ``cuda_cores`` and f32; one row and a part chunk in
   bf16; P 96, a partial second 64-column tile, on ``cuda_cores``); and K1
   at head dim 72, non-causal,
   at the 2D DiT's shapes, bf16 on ``sm90`` and f32 on ``cuda_cores``:
   spatial (a few folded frames, 16 heads, 4096 patches), temporal (4096
   folded patches, 16 heads, the frames) and a ragged length; and both at
   the shapes a rank of phase 16 (b) gives them, bf16 on ``sm90``: K1 on
   qwen3-14b's 10 q and 2 K/V heads over 4096 tokens, K2 on mamba2-370m's
   8 heads (``LM_RANK_ATTN``, ``LM_RANK_SSD``); and at the shapes a rank
   of phase 17 (b)'s (2, 2) mesh gives them: K1 on 20 q and 4 K/V heads,
   K2 on 16 heads (``LM_ZERO_ATTN``, ``LM_ZERO_SSD``); and K2 at phase
   18's shapes, 2 sequences on 32, 8 and 16 heads (``CKPT_SSD``); and
   both at the shapes a rank of phase 19 (b) gives them, each prompt
   padded to a whole share a rank: K1 on 10 q and 2 K/V heads (4 ranks)
   and on 20 and 4 (2 ranks), K2 on 8 heads (``SERVE_RANK_ATTN``,
   ``SERVE_RANK_SSD``); and K1 at the shapes phase 20 (a)'s prefill
   chunks give it, bf16 on ``sm90``: 512 queries at offset L - 512
   against L keys for L in 512, 1024, 1536, 2048, and a ragged 64-token
   chunk at offset 1024 (``PAGED_ATTN``); and K1 at the shapes a rank of
   phase 21 (b) gives it, f32 on ``cuda_cores``: 4 folded frames of a
   spatial block, the 2048 folded patches of a temporal one
   (``T2D_ZERO_ATTN``); and K1 at the prefill shapes of phase 22's models
   in bf16 (``MODEL_ATTN``: starcoder2-7b's 36 q and 4 K/V heads and
   qwen2-moe-a2.7b's 16 and 16 at 2048 tokens, D 128, on ``sm90``;
   gemma2-2b's 8 and 4 at D 256 with softcap 50 and window 4096 over
   4608 keys, on ``cuda_cores``) and at the shapes a rank of phase 23 (b)
   gives it, f32 on ``cuda_cores`` (``MOE_RANK_ATTN``); and K1 at
   mistral-large-123b's prefill shape, 96 q and 8 K/V heads over 2048
   tokens, and at one rank's heads under ``tp`` at n = 4, 24 and 2, in
   bf16 on ``sm90`` (``TP_ATTN``), and at the shapes a rank of phase 25
   (b) gives it, f32 on ``cuda_cores`` (``TP_RANK_ATTN``); and K1 at
   seamless-m4t-large-v2's three shapes, 16 heads of 64 in bf16 on
   ``sm90`` (``SEAMLESS_ATTN``: the encoder's 4096 frames not causal, the
   decoder's 2048 tokens causal, and the cross-attention of 2048 queries
   against 4096 keys, not causal), and at the shapes a rank of phase 26
   (e) gives it, f32 on ``cuda_cores`` (``SEAMLESS_RANK_ATTN``); and K1
   at arctic-480b's prefill shape, 56 q and 8 K/V heads over 2048
   tokens, and at one rank's heads under ``tp`` at n = 4, 14 and 2, in
   bf16 on ``sm90`` (``ARCTIC_ATTN``), and at the shapes a rank of phase
   27 (e) gives it, f32 on ``cuda_cores`` (``ARCTIC_RANK_ATTN``); and K1
   at jamba-1.5-large-398b's prefill shape, 64 q and 8 K/V heads over
   2048 tokens, bf16 on ``sm90`` (``JAMBA_ATTN``), and K1 and K2 at the
   shapes a rank of phase 31 (d) gives them, f32 on ``cuda_cores``
   (``JAMBA_RANK_ATTN``, ``JAMBA_RANK_SSD``);
4. time each kernel, its plain version and, where one exists, one PyTorch
   library call that computes the same function (a yardstick the port
   never calls); K1's routed kernel and the library call three times each
   in turns (medians), and its ``cuda_cores`` kernel; K2 on ``sm90`` and
   on ``cuda_cores`` three times each in turns (medians); K1 at the DiT's
   spatial shape and at one temporal layer's, on ``sm90`` and on
   ``cuda_cores``, against ``scaled_dot_product_attention``, three times
   each in turns (medians); K1 at each chunk shape of ``PAGED_ATTN``
   against ``scaled_dot_product_attention`` with the chunk's mask, three
   times each in turns (medians); K1 at each shape of ``MODEL_ATTN``
   against ``scaled_dot_product_attention`` (causal, GQA) three times
   each in turns (medians), gemma2's against ``flex_attention`` compiled
   with its softcap and window (``library_attention``); K1 at each shape
   of ``TP_ATTN``, ``SEAMLESS_ATTN`` and ``ARCTIC_ATTN`` the same way
   (the library call causal where the shape is; arctic's on
   ``cuda_cores`` too);
5. qwen3-14b serving at full width, random weights from a seeded
   generator: at depth 2, prefill logits through the kernel against the
   plain path at the longest prompt and at a ragged one (bar 2e-2 of the
   largest logit); at depth 40, eight requests (prompts 512-2048 tokens,
   32 new tokens each, 4 slots, all arriving at 0) through
   ``ContinuousScheduler`` with every launch counter set to 0 just before
   and read just after; K1 must launch 40 x 8 = 320 times, every launch on
   the ``sm90`` route;
6. the serve CLI (``repro_torch.launch.serve``) at SMOKE size;
7. mamba2-370m training at full width: at depth 2, ``lm_loss`` and every
   gradient through the kernel against the plain path (bars 1e-4 of the
   loss, 2e-2 of each leaf's max |plain|); at depth 48, six AdamW steps
   of the port's ``Trainer`` at batch 8 x 4096 tokens, with the launch
   counters set to 0 just before and read just after; K2 must launch
   2 x 48 x 6 = 576 times (forward and checkpointed recompute), every
   launch on the ``sm90`` route;
8. the train CLI (``repro_torch.launch.train``) at SMOKE size, where the
   loss must fall;
9. mamba2-370m serving at full width: at depth 2, prefill logits at the
   longest prompt and then 8 greedy decode steps, kernel path against
   plain (bar 2e-2 of the largest logit); one layer's prefill state
   (``ssd_final_state``) against the sequential ``ssd_ref`` at the longest
   prompt (bar 1e-4 of its max); at depth 48, the same eight-request trace
   as phase 5; K2 must launch 48 x 8 = 384 times (one per layer per
   prefill; decode runs in plain PyTorch), every launch on ``sm90``;
10. qwen3-14b training at full width, cut to depth 4 of 40 (AdamW's f32
    moments and master copy for all 14.8B parameters would exceed one
    card): at depth 2, ``lm_loss`` and every gradient through the kernel
    against the plain path at 1 x 4096 tokens (phase 7's bars); at depth
    4, four AdamW steps of the ``Trainer`` at 1 x 4096 tokens; K1 must
    launch 2 x 4 x 4 = 32 times (forward and checkpointed recompute; the
    backward recomputes through ``attention_ref`` and launches none),
    every launch on ``sm90``;
11. the serve CLI with mamba2-370m and the train CLI with qwen3-14b at
    SMOKE size, where the loss must fall;
12. transformer2d-720m (the paper's 2D video DiT) training at full width,
    every block's modulation drawn from seeded normals (adaLN-zero's init
    makes every block the identity, with attention and MLP gradients of
    exactly 0): at depth 2, ``t2d_loss`` and every gradient through the
    kernel against the plain path at 1 x 4 frames x 4096 patches (phase
    7's bars); at depth 28, four AdamW steps of the ``Trainer`` at 1 x 16
    frames x 4096 patches, every group of 2 pairs checkpointed; K1 must
    launch 2 x 28 x 4 = 224 times, every launch on ``sm90`` (``DIT_ROUTE``)
    at head dim 72; then the train CLI with the DiT at SMOKE size;
13. transformer2d-720m under DSP on a ``("data", "model")`` process mesh:
    (a) at world size 1 over NCCL, phase 12's four steps again (same
    init, batches and Trainer) with the mesh: the losses must equal phase
    12's within 1e-4 relative, every rank's ``torch.distributed`` calls
    are counted (``core.dsp``) with the counters set to 0 just before and
    read just after, and must be exactly the planned all-to-alls (28 a
    forward from the executor's accounting, times forward, checkpointed
    recompute and backward: 3 x 28 x 4 = 336) and one all-reduce a step;
    K1 must launch 224 times, all ``sm90`` at head dim 72; one
    switch of the (1, 16, 4096, 1152) stream is timed with its parts;
    (b) 4 processes sharing the card over gloo (NCCL refuses two ranks on
    one GPU) on a (1, 4) mesh, each this script again with
    ``--dsp-rank``: every rank's depth-2 loss and grads at 1 x 16 x 4096
    against (a)'s path at depth 2 (phase 7's bars), the gathered depth-28
    forward against (a)'s within 2e-2 of its largest |value|, and per rank
    exactly the planned all-to-alls and K1 launches.  gloo takes the
    card's tensors itself; a collective it refused would fail the run;
14. transformer2d-720m under the paper's embedded-SP baselines and DSP's
    overlapped switch (``SP_MODES``: ``ulysses``, ``ulysses_fused``,
    ``ring``, ``megatron``, ``hybrid`` on the ``("sp_out", "sp_in")``
    grid, and ``dsp`` with ``overlap="chunked"``): (a) at world size 1
    over NCCL, for each mode the depth-2 loss and grads at 1 x 4 x 4096
    against plan ``none``'s plain path (phase 7's bars), the depth-2
    (SP_DEPTH) forward at 1 x 16 x 4096 against plan ``none``'s within
    2e-2 of its largest |value|, and 2 Trainer steps at depth 2 (step 2's
    time logged); (b) 4 processes sharing the card over gloo, each this
    script with ``--sp-rank``, every mode's depth-2 loss and grads and
    gathered depth-2 forward against (a)'s.  Each mode's step at depth 28
    sat inside plan none's spread (PERF.md §5), and the checks, counts and
    bars hold at any depth.  Around every run the
    counters are set to 0 just before and read just after: each rank's
    collectives, their bytes (``core.dsp.volume``) and K1's launches must
    be exactly the contract's (``sp_contract``; PERF.md §6), every K1
    launch on ``sm90`` at head dim 72; (b) logs Table 3's bytes per
    rank at n = 4;
15. transformer2d-720m on dim pairs: ``forward2d`` over the ``("sp_out",
    "sp_in")`` grid, each boundary planned by ``dsp2d_schedule`` and run
    by the explicit ``ScheduleExecutor2D``: (a) at world size 1 over NCCL
    on the (1, 1) grid, the depth-2 forward at 1 x 4 x 4096 and the
    depth-28 one at 1 x 16 x 4096 against plan ``none``'s ``forward``
    within 2e-2 of its largest |value|, with the counters set to 0 just
    before and read just after each: the all-to-alls must be exactly the
    executor's ``expected_carry_collectives`` (30 at depth 28) and K1 must
    launch once a block (28), all ``sm90`` at head dim 72; then the
    depth-28 forward and plan ``none``'s timed three times each in turns
    (medians); (b) 4 processes sharing the card over gloo, each this
    script with ``--l2d-rank``, at grids (2, 2), (1, 4) and (4, 1): the
    gathered depth-28 forward against (a)'s within 2e-2, per rank exactly
    the planned all-to-alls and 28 K1 launches, all ``sm90``, and each
    rank's bytes beside ``Schedule2D.per_device_bytes``; then (2, 2) at
    1 x 2 x 4096, where the plan's spatial core shards heads (K1 at 8
    heads), against plan ``none``'s ``forward`` at world size 1;
16. qwen3-14b and mamba2-370m under DSP: the ``Sharder``'s hooks
    (``parallel.partition``, plan ``dsp`` with zero and shard_vocab off)
    on a ``("data", "model")`` process mesh, the joint planned schedule,
    ``lm_loss(sharder=)`` on each rank's shard: (a) at world size 1 over
    NCCL, phase 10's four steps (depth 4) and phase 7's first two (depth
    48) again through the Trainer with the mesh: the losses must equal
    theirs within 1e-4 relative, the calls and bytes must be exactly the
    hooks' contract (``lm.collective_contract`` through ``lm.remat_step``:
    at one rank every switch and gather is issued, the conv's halo is not)
    and one all-reduce a step, K1 must launch 2 x 4 x 4 = 32 times and K2
    2 x 48 x 2 = 192, all ``sm90``; each step time is logged beside the
    plan-none phase's; (b) 4 processes sharing the card over gloo on a
    (1, 4) mesh, each this script with ``--lm-rank``: qwen3-14b at depth
    1 and mamba2-370m at depth 1 (qwen3 at depth 2 until phase 26 needed
    the seconds, mamba2 until phase 27 did), full width, 1 x 4096 tokens, one loss and its grads
    summed over the ranks against (a)'s path at the same depth (phase 7's
    bars), and per rank exactly the contract's calls and bytes, K1 on 10
    of 40 q and 2 of 8 K/V heads and K2 on 8 of 32 heads, twice a layer,
    all ``sm90``;
17. qwen3-14b and mamba2-370m under their specs' own plans
    (``ParallelPlan(mode="dsp", zero=True, shard_vocab=True)``): the
    parameters laid out by ``param_pspecs`` and cut to each rank's slices
    (``shard_params``; ZeRO-3 over ``("data", "model")`` flattened, the
    embedding tables over ``model``), gathered where the model reads them,
    the embedding through the vocab ring, AdamW's state made from the
    slices: (a) at world size 1 over NCCL, phase 16 (a)'s runs again: the
    losses must equal phase 16 (a)'s within 1e-4 relative, the calls and
    bytes must be exactly the hooks' contract plus ``lm.param_contract``
    each step (``zero_contract``), K1 must launch 32 times and K2 192, all
    ``sm90``; step time and peak memory logged beside phase 16 (a)'s; (b)
    4 processes sharing the card over gloo, each this script with
    ``--zero-rank``: qwen3-14b at depth 1 and mamba2-370m at depth 2 on a
    (2, 2) mesh at 2 x 4096 tokens: one loss, and each rank's grad slices
    against the same slices of (a)'s path at the same depth and batch
    (phase 7's bars, each leaf's worst over the ranks), the clip's norm
    within 1e-3;
    per rank exactly the contract's calls and bytes, K1 and K2 twice a
    layer at the rank's head counts, all ``sm90``; one Trainer step on
    mamba2 at (2, 2) with the contract's calls and a grad norm within
    1e-3 of world 1's; each rank's peak device memory,
    peak resident host memory and pinned host blocks logged;
18. mamba2-370m checkpoints (``train.checkpoint``), resume, int8
    error-feedback compression (``optim.compress``) and ``replan``, under
    its spec's own plan with ``grad_compress`` on: (a) at world size 1
    over NCCL, full width and depth at 2 x 4096, 4 steps uninterrupted
    (and 4 without compression, their step times side by side), then 2
    steps with an async checkpoint at step 2, a fresh ``Trainer`` whose
    ``try_resume`` must restore the saved state bit for bit (params,
    moments, master copy, step, residuals) and steps 3 and 4, whose losses
    must be within 1e-5 relative of the uninterrupted run's (the gap
    printed); K2 must launch 2 x 48 a step, all ``sm90``, in every run;
    the checkpoint's bytes and the seconds of snapshot, write, publish
    and restore are logged; (b) 4 processes sharing the card over gloo,
    each this script with ``--ckpt-rank``, at depth 1: one step at (2,
    2), saved; restored at (1, 4) in the same processes and at world size
    1 in this one, each gathered bit-equal to the saved global tree; step
    2 at (1, 4) and, after ``replan(2)`` (ranks 2 and 3 leave), step 3 on
    the survivors, within phase 7's loss bar of the (2, 2) run's; (c) the
    train CLI with ``--ckpt-dir``, then ``--resume``, then the serve CLI
    from the same checkpoint, at SMOKE size;
19. qwen3-14b and mamba2-370m served sharded (``ServingEngine(mesh=,
    plan=)``: the KV cache sequence-sharded over ``model``, the SSM state
    head-sharded): (a) at world size 1 over NCCL, phases 5's and 9's
    trace at full width and depth under SERVE_PLAN (the serve CLI's
    default, ZeRO and the vocab split on), with the counters set to 0
    just before and read just after: the tokens must equal theirs, K1
    (K2) launch 320 (384) times on ``sm90``, and the calls and bytes must
    be exactly ``lm.serve_contract``'s; (b) 4 processes sharing the card
    over gloo, each this script with ``--serve-rank``, qwen3-14b at depth
    1 and mamba2-370m at depth 2 of 48 on a (1, 4) mesh: the
    teacher-forced logits (SERVE_FORCED requests, SERVE_FORCED_STEPS
    decode steps on the one-rank reference's tokens) under SERVE_PLAN
    within LOGIT_BAR of the reference's, at each forced check's depth and
    dtype (mamba2: depth 2, in f32 and in bf16); the trace, 8 new
    tokens a request, through the scheduler under SERVE_RANK_PLAN with
    the pool asserted on the mesh after every step, every request
    finished, per rank each segment's calls and bytes exactly the
    contract's and K1 (K2) once a layer a prefill on the rank's heads,
    all ``sm90``; on qwen3 ``replan(2)`` at decode step 3 with the moved
    pool bit-equal and the survivors' forced logits within the bar; (c),
    run in phase 28, the serve CLI under ``torchrun --nproc-per-node 4
    ... --mode dsp --backend gloo``: continuous over a Poisson trace with
    world 1's tokens, static ``--replan 2`` with identical output;
20. qwen3-14b served paged (``PagedScheduler``: the block pool, the
    radix prefix tree, chunked prefill): (a) on one card under plan
    ``none`` at full width and depth, 8 requests of a shared 1024-token
    system prompt and seeded suffixes of 64, 256, 512 and 1024 tokens
    (twice), 32 new tokens each, 4 slots, 16-token blocks, 512-token
    chunks, first through ``ContinuousScheduler`` (the slot path), then
    paged with the counters set to 0 just before and read just after:
    every request finished, exactly 4 x 1024 = 4096 prefix-hit tokens and
    18 chunks, K1 launched exactly 40 x 18 = 720 times, all ``sm90``; the
    teacher-forced logits of a request that missed (its prompt across two
    chunk boundaries) and one that hit, through the paged path against
    the slot path, within 2e-2 of the largest logit; TTFT and TPOT of
    both logged, with the share of equal tokens; (b) 4 processes sharing
    the card over gloo, each this script with ``--paged-rank``, qwen3-14b
    at depth 2 on a (1, 4) mesh under SERVE_RANK_PLAN, the blocks
    sequence-sharded within: the teacher-forced logits against a one-rank
    reference within 2e-2 before and after ``replan(2)``, which fires at
    a decode step with a prefill mid-prompt (the blocks gathered before
    and after bit-equal, the tables and ref counts unchanged), the trace
    with prefix hits and 128-token chunks, the pool asserted on the mesh
    after every step, per rank each segment's calls and bytes exactly
    ``lm.serve_contract``'s, a paged decode step's equal to a slot decode
    step's, K1 launched 0 times (a chunk on a mesh attends through plain
    softmax partials); (c), run in phase 28, the serve CLI ``--paged
    --prefill-chunk 8`` on the card and under ``torchrun --nproc-per-node
    4 ... --mode dsp --backend gloo``, the ranks' tokens one card's;
21. transformer2d-720m under its spec's own plan
    (``ParallelPlan(mode="dsp", zero=True, shard_vocab=False)``): the
    parameters laid out by ``param_pspecs`` and cut to each rank's slices
    (ZeRO-3 over ``("data", "model")`` flattened), each checkpointed group
    of block pairs gathering its weights inside its checkpoint
    (``t2d_loss(param_specs=)``), AdamW's state made from the slices
    (``Trainer(param_specs=)``): (a) at world size 1 over NCCL, phase 13's
    first step's loss and every grad again in the layout, bit-equal to
    phase 13's path, then phase 13's four steps: the losses bit-equal to
    phase 13's (or within 1e-5 relative where the clip's norm from slices
    sums in another order, the grad norms shown), the calls and bytes
    exactly ``transformer2d.step_contract`` each step (the planned
    all-to-alls three times over plus ``transformer2d.param_contract``;
    ``t2d_zero_contract``), K1
    224 launches on ``sm90`` at head dim 72, step time and peak memory
    logged beside phase 13's; (b) 4 processes sharing the card over gloo,
    each this script with ``--t2d-zero-rank``, at depth 2 in f32 on 2 x 4
    frames x 4096 patches, at (2, 2) and (1, 4): the loss and the clip's
    norm within 1e-5 relative of one rank without ZeRO, each rank's slice
    of every grad within 1e-4 of its leaf's max, per rank the contract's
    calls and bytes exactly and 4 K1 launches on ``cuda_cores``, peak
    memory logged; then one Trainer step at (2, 2) saved and restored by
    a fresh Trainer at (1, 4), its state bit-equal to the saved state's
    (1, 4) slices;
22. starcoder2-7b, gemma2-2b and qwen2-moe-a2.7b on one card, bf16,
    random weights from seed 0, the card freed between models: (a)
    starcoder2-7b's depth-2 prefill logits at 2048 and 512 tokens, kernel
    against plain within 2e-2 of the largest logit, then at full depth 32
    4 requests (prompts 512-2048, 16 new tokens) through
    ``ContinuousScheduler``: K1 exactly 32 x 4 = 128 launches, all
    ``sm90`` (GQA 36/4); (b) gemma2-2b the same at a 4608-token and a
    512-token prompt, then at full depth 26 4 requests, one of 4608
    tokens (past its window of 4096): K1 104 launches, all ``cuda_cores``
    (D 256, softcap 50, window 4096); (c) qwen2-moe-a2.7b (14.31B
    parameters, 60 experts padded to 64): depth-2 prefill logits and
    ``lm_loss`` kernel against plain in bf16 and, with every grad, in f32
    (phase 5's and 7's bars; in bf16 the paths send some pairs to other
    experts, each moving a token's whole contribution between two
    experts' grads; the share of such routes logged), phase 5's
    8-request trace at full depth 24 (K1 192, all ``sm90``), and 4
    Trainer steps at depth 4 at 1 x 4096 (K1 32;
    TTFT, TPOT, step time, tokens/s, peak memory and the dropped share
    logged);
23. MoE under DSP with ``ep`` on a (data, model) mesh, qwen2-moe-a2.7b
    under its spec's own plan (``dsp``, ``ep``, ZeRO-3, the vocab ring):
    (a) at world size 1 over NCCL, phase 22 (c)'s training again, the
    losses within 1e-4 relative of phase 22's, the calls and bytes
    exactly the contract each step (``zero_contract``: the count exchange,
    the dispatch and the combine, their rows from the step's kept pairs,
    plus ``lm.param_contract``), K1 32 on ``sm90``; then (b)'s
    reference; (b) 4 processes sharing the card over gloo, each this
    script with ``--moe-rank``, at full width but a vocab of 32768, depth
    1 in f32 at 2 x 1024 tokens, at (1, 4) and (2, 2): the loss within 1e-5 relative of one
    rank's, each rank's grad slices within 1e-4 of their leaf's max, the
    dropped pairs of each MoE call and the dropped share exactly one
    rank's, per rank the calls and bytes exactly the contract (the
    dispatch's rows by ``route_rows`` of the run's routing)
    and 4 K1 launches on ``cuda_cores``; (c), run in phase 28, the train
    CLI at SMOKE size under ``torchrun --nproc-per-node 4 --mesh 1,4
    --backend gloo``, every rank one rank's loss;
24. mistral-large-123b (its published config: 96 q and 8 K/V heads of
    128, its KV cache in float8_e4m3fn) on one card, bf16, random weights
    from seed 0: (a) at depth 2, kernel against plain (bar 2e-2 of the
    largest logit): the prefill logits at a 2048-token prompt and 4
    decode steps; the static decode write at a scalar position into an
    fp8 ``init_caches`` cache holding each path's prefill K/V (the write
    ``index_copy_`` lacks for fp8); the engine's ``generate``; 4 requests
    over 512-2048 tokens teacher-forced through the slot pool (per-slot
    fp8 writes) and through the block pool (fp8 block writes, K1 on each
    prefill chunk over the blocks widened to bf16, the decode's reads),
    the plain path through ``plain_attention``; (b) at depth 16 of 88
    (22.95B parameters, 45.9 GB) those 4 requests, 16 new tokens each,
    through ``ContinuousScheduler``: K1 exactly 16 x 4 = 64 launches, all
    ``sm90``; (c) 4 Trainer steps at depth 2 at 1 x 4096 (AdamW's f32
    state for 123B parameters fits no card): K1 exactly 2 x 2 x 4 = 16
    launches, all ``sm90`` (TTFT, TPOT, step time, tokens/s and peak
    memory logged);
25. mistral-large-123b under its spec's own plan (``tp``, ZeRO-3 over
    ``data``, the vocab ring): (a) at world size 1 over NCCL, phase 24
    (c)'s training, the losses within 1e-4 relative of phase 24's, the
    calls and bytes exactly the contract each step (``zero_contract(tp=
    True)``: per block an all-gather and a reduce-scatter of the whole
    sequence three times over, plus ``lm.param_contract``), K1 16 on
    ``sm90``; phase 24 (b)'s trace on the same weights, the tokens phase
    24's, K1 64 on ``sm90``, the calls exactly ``lm.serve_contract``;
    then (b)'s references; (b) 4 processes sharing the card over gloo,
    each this script with ``--tp-rank``, at full width, depth 1 in f32 at
    2 x 256 tokens (depth 2's 14.3 GB of f32 weights took 96 s for the
    two meshes' steps, and with its reference the 4 ranks' host memory
    ended a rank), at (1, 4) (the ranks' K/V heads their own) and (2,
    2): the loss within 1e-5 relative of one rank's, each rank's grad
    slices within 1e-4 of their leaf's max, per rank the calls and bytes
    exactly the contract and 2 K1 launches on ``cuda_cores`` on the
    rank's heads; then at (1, 4) with ZeRO and the vocab split off and
    an f32 KV cache 2 requests through
    ``ContinuousScheduler`` and ``replan(2)`` at decode step 3, the
    tokens one rank's; host memory logged; (c), run in phase 28, the train
    CLI at ``--mesh 1,4`` and the serve CLI at ``--mode tp
    --continuous``, SMOKE size, under ``torchrun --nproc-per-node 4
    --backend gloo``;
26. seamless-m4t-large-v2 (``models/encdec.py``: 24 encoder and 24
    decoder layers, d 1024, 16 heads of 64, vocab 256206; 1.37B
    parameters), bf16, random weights from seed 0: (a) at depth 2 + 2,
    kernel against plain, the loss and every grad at 2 x (4096 frames,
    2048 tokens) on weights drawn in bf16, in f32 (the weights upcast; K1
    on ``cuda_cores``; bars 1e-4 and 2e-2) and in bf16 (K1 on ``sm90``;
    the loss 1e-4 against plain; each grad leaf against the f32 plain
    path's, the kernel's max error within twice the plain bf16 path's or
    2e-2, FlashAttention's tests' rule), the prefill of 4 requests of
    4096 frames with 16-token prompts and 4 decode steps (2e-2 of the largest
    logit), and the kernel path's first decode step against a full
    decoder forward over the prompt and that token (2e-2); (b) at full
    depth those 4 requests, 32 new tokens each, caches of 48 positions,
    with the counters set to 0 just before and read just after: K1
    exactly 24 + 2 x 24 = 72 launches (the prefill's; a decode step
    attends in plain PyTorch), all ``sm90``; TTFT, TPOT p50/p99 and peak
    memory logged; (c) 4 Trainer steps at full depth at 2 x (4096, 2048):
    K1 exactly 2 x 72 x 4 = 576 launches (forward and checkpointed
    recompute), all ``sm90``; (d) (c) again at world size 1 over NCCL
    under the spec's own plan (``dsp``, ZeRO-3 over ``("data",
    "model")``, each layer gathering its weights inside its checkpoint):
    the losses bit-equal to (c)'s or within 1e-4 relative (said which),
    the calls and bytes exactly ``lm.remat_step`` of
    ``encdec.collective_contract`` plus
    ``encdec.param_contract`` each step, K1 576 on ``sm90``; then (e)'s
    reference; (e) 4 processes sharing the card over gloo, each this
    script with ``--seamless-rank``, at full width, depth 1 + 1 in f32
    at 2 x (1024, 256), at (1, 4) (the table whole: 4 does not divide
    256206) and (2, 2) (the table split over ``model``): the loss within
    1e-5 relative of one rank's, each rank's grad slices within 1e-4 of
    their leaf's max, both runs with the ReLU's gradient held at 0 where
    the one-rank pre-activation lies within 2e-5 of the layer's RMS of 0
    (``relu_held``) and no pre-activation outside those entries changed
    in sign, per rank the calls and bytes exactly the contract and 6 K1
    launches on ``cuda_cores`` on the rank's heads; then, in
    phase 28, the train CLI at SMOKE size under ``torchrun
    --nproc-per-node 4 --mesh 1,4 --backend gloo``;
27. arctic-480b (its published config: 35 layers, d 7168, 56 q and 8
    K/V heads of 128, 128 experts top-2 of F 4864 beside a dense
    residual MLP of 4864, its KV cache in float8_e4m3fn) and MoE served
    on a mesh, bf16, random weights from seed 0: (a) at depth 1 of 35
    (14.1B parameters, 28.2 GB), kernel against plain on one set of
    weights with the plain path's routing replayed (``replayed``: where
    the paths' roundings flip a top-2 pick; the share logged), each
    within 2e-2 of the largest logit: the prefill logits at a
    2048-token prompt and 4 decode steps, and 4 requests over 512-2048
    tokens teacher-forced 4 decode steps through the slot pool and the
    block pool, both in the fp8 cache; (b) those 4 requests, 16 new
    tokens each, on the same weights through ``ContinuousScheduler``: K1
    exactly 1 x 4 = 4 launches, all ``sm90``; the same trace under
    ``tp`` + ``ep`` (the serving rule: experts over ``model``, their
    hidden columns over ``data``) at world size 1 over NCCL, the tokens
    equal, K1 4 on ``sm90``, the calls exactly
    ``lm.serve_contract`` (at one rank each expert read copies its leaf:
    beside depth 2's 55.4 GB that exceeds the card); (c) 4 Trainer steps
    at depth 1 with the experts cut from 128 to 16 at 1 x 4096: K1
    exactly 2 x 1 x 4 = 8, all ``sm90``; the same under the spec's plan
    (``tp``, ``ep``, ZeRO-3 over ``data``, the vocab ring) at world size
    1: the losses within 1e-4 relative, the dropped shares equal, the
    calls and bytes exactly ``zero_contract(tp=True)`` each step; (d)
    qwen2-moe-a2.7b at full width and depth, phase 22's trace under
    ``dsp`` + ``ep`` at world size 1: the tokens phase 22's, K1 192 on
    ``sm90``, the calls exactly ``lm.serve_contract``; (e) 4 processes
    sharing the card over gloo beside phases 28 and 29 (a), each this
    script with ``--arctic-rank``: arctic's widths at depth 1 with 8
    experts in f32, trained under the spec's plan at 2 x 256 tokens at
    (1, 4) and (2, 2): the loss within 1e-5 relative of one rank's,
    each rank's grad slices within 1e-4 of their leaf's max, the dropped
    shares one rank's, per rank the calls and bytes exactly the contract (the
    dispatch's rows by ``route_rows``) and 2 K1 launches on
    ``cuda_cores`` on the rank's heads; then at (1, 4) with an f32 cache,
    ZeRO and the vocab split off, 2 requests under ``dsp`` without
    ``ep``, then under ``tp`` + ``ep`` through ``replan(2)`` at decode
    step 3: the tokens one rank's; host memory logged; (f), started
    after (b) and checked in phase 28, the train CLI at ``--mesh 1,4``
    and the serve CLI at ``--mode tp --continuous``, SMOKE size, under
    ``torchrun --nproc-per-node 4 --backend gloo``;
28. the CLIs under ``torchrun`` of phases 19 (c), 20 (c), 23 (c), 25
    (c), 26 (e) and 27 (f), each checked against its one-rank run in this
    process: the other five start together at the top of phase 27, the
    four of ``EARLY_CLIS`` once its (b)'s run under ``tp`` + ``ep`` has
    given the card back its memory, and run beside (c)-(e), whose times
    may carry that load (``cli_launches``: each launch spends most of its
    time starting its ranks);
29. seamless-m4t-large-v2 served on a ``("data", "model")`` mesh: (a)
    phase 26 (b)'s trace at full width and depth at world size 1 over
    NCCL under its spec's plan (``dsp`` + ZeRO-3): the tokens phase 26
    (b)'s, the calls and bytes exactly ``encdec.serve_contract``'s, K1
    72 launches on ``sm90`` at D 64, TTFT and TPOT beside phase 26 (b)'s;
    (b) 4 processes sharing the card over gloo, each this script with
    ``--seamless-serve-rank``: seamless's widths at depth 1 + 1 in f32
    with ZeRO off, 4 requests of 1024 frames, 16-token prompts and 8 new
    tokens at (1, 4) and (2, 2): each rank's tokens one rank's up to a
    near-tie, its calls and bytes exactly the contract, 3 K1 launches on
    ``cuda_cores`` on its heads;
30. pixtral-12b (40 layers, d 5120, 32/8 heads of 160, its stub VLM
    frontend's 1024 patch rows), bf16: (a) at depth 2 kernel against
    plain on 1 x 4096 tokens whose first 1024 positions are patch rows:
    the prefill's last logits within 2e-2 of the largest, the loss within
    1e-4 relative, every grad leaf (the frontend's too) within 2e-2 of its
    max; (b) at full depth 4 requests of 512-2048 prompt tokens and 16
    new tokens behind the scheduler (text, as JAX's engine serves it; K1
    160 launches on ``cuda_cores``, ``sm90`` takes D 64/72/128), then one
    ``forward_prefill(extra=)`` of 2048 tokens with the patch rows (K1
    40); (c) 4 Trainer steps at depth 2, 1 x 4096 with the patch rows (K1
    16), and again under its spec's plan (``dsp`` + ZeRO-3) at world size
    1: the losses bit-equal or within 1e-4, the calls and bytes exactly
    ``zero_contract`` with ``lm.param_contract(patches=True)``; (d) K1 at
    its prefill shape, (1, 32, 2048, 160) against (1, 8, 2048, 160)
    causal, against its plain version and ``scaled_dot_product_attention``
    (causal, GQA), medians of 3 in turns;
31. jamba-1.5-large-398b (the JAX config's SSD heads of P 128, 8 B/C groups,
    S 128; Mamba-2 heads are the JAX package's choice, not the paper's) at
    full width, one 8-layer period with 8 of its 16 experts (25.9B
    parameters, 51.8 GB; all 16 exceed the card), bf16, the KV cache in
    float8_e4m3fn: (a) kernel against plain (``plain_kernels``), the plain
    path's routing replayed: the prefill logits of a 2048-token prompt and 4
    decode steps, and 4 requests of 512-2048 tokens teacher-forced 4 decode
    steps through the slot pool, each within 2e-2 of the largest logit, or
    twice the plain path's own noise where that reaches it
    (``nudged_plain``: one period in bf16 turns any float32 summation
    difference into ~2e-2); (b) those requests, 16 new tokens each, through
    ``ContinuousScheduler`` (K1 exactly 4, K2 exactly 28, all ``sm90``;
    TTFT, TPOT), then under ``dsp`` + ``ep`` with ZeRO off at world size 1
    over NCCL (the tokens equal, K1 4 and K2 28, the calls and bytes exactly
    ``lm.serve_contract``); (c) K2 at jamba's prefill shape on ``sm90``, on
    ``cuda_cores`` and plain beside its bound, K1 at (1, 64/8, 2048, 128)
    causal beside ``scaled_dot_product_attention``, medians of 3 in turns;
    (d) 4 processes sharing the card over gloo (``--jamba-rank``), beside
    (a)-(c): one period at cut widths with jamba's head shapes in f32
    trained at (1, 4) and (2, 2) under its spec's plan (``dsp`` + ``ep`` +
    ZeRO-3; loss 1e-5, grad slices 1e-4 of their leaf's max or twice the
    reference's own f32 noise on it, the dropped pairs one rank's and not
    none; a router bias makes them drop), calls and bytes exactly the
    contract, K1 2 and K2 14 on ``cuda_cores``), then 2 requests served at
    (1, 4) under ``dsp`` + ``ep`` with ZeRO off (tokens one rank's up to a
    near-tie, calls and bytes exactly ``serve_contract``, K1 2 and K2 14 a
    rank on ``cuda_cores``);
32. a ``{"kernels": [...]}`` line, whose ``launches`` sum each kernel's
    counts over the paths above (K1 320 + 32 + 224 + 224 + phase 14's
    training runs, 8 per mode, 4 for ring and hybrid, + phase 15 (a)'s
    28 + phase 16 (a)'s 32 + phase 17 (a)'s 32 + phase 19 (a)'s 320 +
    phase 20 (a)'s 720 + phase 21 (a)'s 224 + phase 22's 128 + 104 + 192
    + 32 + phase 23 (a)'s 32 + phase 24's 64 + 16 + phase 25 (a)'s 16 +
    64 + phase 26's 72 + 576 + 576 + phase 27's 4 + 4 + 8 + 8 + 192
    + phase 29 (a)'s 72 + phase 30's 160 + 40 + 16 + 16, these 232 on
    ``cuda_cores``, + phase 31's 4 + 4);
    K2 576 + 384 + phase 16 (a)'s 192 + phase
    17 (a)'s 192 + phase 18 (a)'s 2 x 48 x 12 = 1152 + phase 19 (a)'s
    384 + phase 31's 28 + 28, at P 128)
    and whose ``launches_by_route`` split that sum by the route each
    launch took (``sm90``, and gemma2's 104 on ``cuda_cores``), with phase
    19 (b)'s and 20 (b)'s per rank beside (phase 21 (b)'s, 23 (b)'s,
    25 (b)'s, 26 (e)'s and 27 (e)'s too), phase 4's chunk timings and the
    models' shapes (``models``, mistral's two of ``TP_ATTN``, seamless's
    three of ``SEAMLESS_ATTN`` and arctic's two of ``ARCTIC_ATTN`` with
    them), then the last
    line
    ``{"ok": true, "device": {...}}``.  Phases 29 (b)'s and 30 (d)'s
    numbers stand in ``models`` too, phase 31 (c)'s K1 there and its K2
    under ``ssd_scan_fwd``'s ``jamba-1.5-large-398b`` with phase 3's P 128
    checks and (d)'s launches per rank.

Each phase's header logs the seconds since the start and the host's
memory since the previous header (the peaks of the process tree's
resident memory, of the machine's used memory and of its tmpfs), and
every time logged carries the card's name and power limit.
"""
import collections
import dataclasses
import gc
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Generator

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import (  # noqa: E402
    arctic_480b, gemma2_2b, jamba_1_5_large_398b, mamba2_370m,
    mistral_large_123b, pixtral_12b, qwen2_moe_a2_7b, qwen3_14b,
    seamless_m4t_large_v2, starcoder2_7b, transformer2d_720m)
from repro_torch.core import dsp  # noqa: E402
from repro_torch.core.layout import from_mesh  # noqa: E402
from repro_torch.core.schedule import (  # noqa: E402
    ScheduleExecutor, ScheduleExecutor2D)
from repro_torch.data.pipeline import DataConfig, make_batch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    ROUTES, flash_attention_fwd, flash_attention_plain, reset_launches)
from repro_torch.kernels.ref import ssd_final_state, ssd_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    reset_launches as reset_ssd_launches, route_for as ssd_route,
    ssd_scan_fwd, ssd_scan_plain)
from repro_torch.launch.mesh import (  # noqa: E402
    BACKEND_OF, make_mesh, make_sp2d_mesh)
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models import transformer2d as t2d  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.parallel.partition import (  # noqa: E402
    ParallelPlan, make_sharder, mesh_sizes, param_pspecs, reshard,
    shard_params, slice_index, unshard_params)
from repro_torch.serving.block_pool import BlockPool  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.kv_pool import KVPool  # noqa: E402
from repro_torch.serving.scheduler import (  # noqa: E402
    ContinuousScheduler, PagedScheduler)
from repro_torch.train.trainer import (  # noqa: E402
    ElasticSpec, Trainer, TrainerConfig, allreduce_grads, slices_norm)

# a phase's (b) part: a generator over ``ranks_exit``, its value the result
Part = Generator[None, None, dict]

# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# B, Hq, Hkv, Sq, Skv, D, causal, window, softcap (tests/test_kernels.py)
ATTN_CASES = [
    (2, 4, 4, 128, 128, 64, False, None, None),
    (1, 8, 2, 256, 256, 32, True, None, None),
    (1, 4, 1, 100, 100, 64, True, 37, None),
    (1, 2, 2, 64, 192, 64, False, None, 30.0),
    (2, 6, 3, 80, 80, 16, True, None, None),
    (1, 2, 2, 1, 300, 64, True, None, None),
    (1, 4, 4, 128, 128, 128, True, 64, 50.0),
]
# |kernel - plain| <= rel * (the row's max |plain|) + abs.  Both compute in
# f32 from the same inputs, so in bf16 they differ by one rounding of the
# output: one ulp, at most 2**-7 |x|.  The bar allows two.
TOL = {torch.float32: (0.0, 1e-4), torch.bfloat16: (2.0 ** -6, 1e-6)}

# B, L, H, P, G, S, chunk (tests/test_kernels.py SSD_CASES)
SSD_CASES = [
    (2, 128, 4, 16, 2, 32, 64),
    (1, 64, 2, 32, 1, 16, 16),
    (1, 200, 4, 16, 4, 32, 64),
    (2, 96, 8, 8, 2, 64, 32),
]
# the training slice: one mamba2-370m layer's scan at train_4k's sequence,
# batch 8; and a ragged length at the same width
SSD_SLICE = (8, 4096, 32, 64, 1, 128, 128)
SSD_RAGGED = (8, 4000, 32, 64, 1, 128, 128)
# more of the sm90 route in bf16: one row, a part chunk, two B/C groups
SSD_SM90_EDGES = [(2, 1, 4, 64, 1, 128, 128), (2, 100, 4, 64, 1, 128, 128),
                  (2, 1000, 4, 64, 2, 128, 128)]
# mamba2 depth-2 loss and grads, kernel against plain: the loss's
# |delta| / |loss| and every grad leaf's max |delta| / max |plain|
LOSS_BAR, GRAD_BAR = 1e-4, 2e-2

# serving, depth 2, kernel against plain: logits within this share of the
# largest logit, at prefill and at each of DECODE_CHECK_STEPS decode steps
LOGIT_BAR, DECODE_CHECK_STEPS = 2e-2, 8
# one mamba2-370m layer's prefill state, ssd_final_state against the
# sequential ssd_ref: max |delta| / max |ssd_ref|, f32 sums in another
# order over the prompt
STATE_BAR = 1e-4

N_REQUESTS, MAX_BATCH, NEW_TOKENS = 8, 4, 32
# the training slices: train_4k's sequence at batch 8 (of its 256, one
# card) for mamba2-370m; at batch 1 and depth 4 of 40 for qwen3-14b, whose
# f32 AdamW state at full depth (14.8B params x 12 B) exceeds one card
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 4096, 6
QWEN_TRAIN_BATCH, QWEN_TRAIN_DEPTH, QWEN_TRAIN_STEPS = 1, 4, 4
PROMPT_LENS = np.linspace(512, 2048, N_REQUESTS).astype(int).tolist()
# the DiT training slice: video_0.5m's 4096 patches a frame at batch 1 (of
# its 32) and 16 frames (of its 128), cut to fit one card (PERF.md §4);
# every group of 2 block pairs checkpointed; the depth-2 check at 4 frames
DIT_BATCH, DIT_FRAMES, DIT_PATCHES, DIT_STEPS = 1, 16, 4096, 4
DIT_REMAT_GROUP, DIT_CHECK_FRAMES = 2, 4
# the DSP phase: phase 12's training at world size 1 over NCCL, whose
# losses must equal phase 12's (the switch only moves bytes there); then
# DSP_RANKS processes sharing the card over gloo on a (1, DSP_RANKS) mesh:
# depth-2 loss and grads against the world-1 path (phase 7's bars), and
# the depth-28 forward against world 1 within DSP_OUT_BAR of its largest
# |value| (bf16 activations, summed in another order)
DSP_RANKS, DSP_LOSS_BAR, DSP_OUT_BAR = 4, 1e-4, 2e-2
# the baselines phase: the paper's embedded-SP modes and DSP's overlapped
# switch, each at world size 1 over NCCL (depth-2 grads against plan
# none's plain path at phase 7's bars, the SP_DEPTH forward against plan
# none's within DSP_OUT_BAR, SP_TRAIN_STEPS Trainer steps at SP_DEPTH), then
# over DSP_RANKS processes sharing the card over gloo against world 1
SP_MODES = (("ulysses", None), ("ulysses_fused", None), ("ring", None),
            ("megatron", None), ("hybrid", None), ("dsp", "chunked"))
SP_TRAIN_STEPS = 2
# the dim-pair phase: forward2d at world size 1 over NCCL on the (1, 1) grid
# against plan none's forward (depth 2 at DIT_CHECK_FRAMES frames, depth 28
# at DIT_FRAMES), within DSP_OUT_BAR of its largest |value|; then
# DSP_RANKS processes sharing the card over gloo at each (grid, frames) of
# L2D_CASES against world 1; forwards timed in L2D_TURNS (plan none's
# beside).  At L2D_HEAD_FRAMES frames T cannot go diagonal over the (2, 2)
# grid, so the plan's spatial core shards heads over sp_in: the stacked
# q/k/v and the attention output take the switches, and K1 runs 8 heads
L2D_HEAD_FRAMES = 2
L2D_CASES = (((2, 2), DIT_FRAMES), ((1, 4), DIT_FRAMES), ((4, 1), DIT_FRAMES),
             ((2, 2), L2D_HEAD_FRAMES))
L2D_TURNS = ("2d", "none", "none", "2d", "2d", "none")
LM_PLAN = ParallelPlan(mode="dsp", zero=False, shard_vocab=False)
# the LM phase: phase 10's and phase 7's training at world size 1 over NCCL
# under DSP (LM_PLAN: the specs' plan with zero and shard_vocab off), whose
# losses must equal theirs within DSP_LOSS_BAR (the switches only move
# bytes there), mamba2-370m for LM_MAMBA_STEPS of phase 7's steps; then
# DSP_RANKS processes sharing the card over gloo on a (1, DSP_RANKS) mesh:
# one loss and its grads of each LM at LM_RANK_DEPTHS, 1 x TRAIN_SEQ
# tokens, against the world-1 path at the same depth (phase 7's bars)
LM_MAMBA_STEPS = 2
# (mamba2 at depth 4 until phases 24-25 needed the seconds, 2 until phase
# 27 did; qwen3 at depth 2 until phase 26 did)
LM_RANK_DEPTHS = (("qwen3-14b", 1), ("mamba2-370m", 1))
# the kernels at the shapes one of those ranks gives them (the heads split
# DSP_RANKS ways by the switch, the whole sequence), held against their
# plain versions in phase 3: K1 on qwen3-14b's 10 q and 2 K/V heads, K2 on
# mamba2-370m's 8 heads of its one B/C group
_Q, _M = qwen3_14b.CONFIG, mamba2_370m.CONFIG.ssm_cfg
LM_RANK_ATTN = (1, _Q.n_heads // DSP_RANKS, _Q.n_kv_heads // DSP_RANKS,
                TRAIN_SEQ, TRAIN_SEQ, _Q.head_dim, True, None, None)
LM_RANK_SSD = (1, TRAIN_SEQ, _M.n_heads // DSP_RANKS, _M.head_dim,
               _M.n_groups, _M.d_state, _M.chunk)
# grads summed over the gloo ranks in f32 pieces of this many elements
LM_REDUCE_PIECE = 1 << 26
# the ZeRO phase: the LM family under its specs' own plans (ZeRO-3 over
# ("data", "model"), the vocab ring): phase 16 (a)'s training again at
# world size 1 over NCCL, whose losses must equal phase 16 (a)'s within
# DSP_LOSS_BAR; then DSP_RANKS processes sharing the card over gloo, each
# case (LM, depth, (data, model) mesh, global batch of that many x
# TRAIN_SEQ) one loss and its grad slices against the same slices of
# world 1's at the same depth and batch (phase 7's bars), and on the cases
# of ZERO_TRAIN one Trainer step, whose grad norm must be within
# ZERO_NORM_BAR of world 1's
ZERO_CASES = (("qwen3-14b", 1, (2, 2), 2), ("mamba2-370m", 2, (2, 2), 2))
# (mamba2 at depth 4 until phases 29-30 needed the seconds; qwen3 at depth
# 2 until phase 27 did; at (1, 4) too, its Trainer step until phases 24-25 needed its 27
# s, its loss and grad slices until phase 26 needed their ~25 s: DSP with
# ZeRO-3 at (1, 4) stays on the card in phases 23 (b) and 26 (e), the
# vocab ring over 4 ranks in 25 (b))
ZERO_TRAIN = ("mamba2-370m/2x2",)
ZERO_NORM_BAR = 1e-3
# the checkpoint phase: mamba2-370m under its spec's plan with grad_compress
# at CKPT_BATCH x TRAIN_SEQ, CKPT_STEPS steps uninterrupted against a run
# checkpointed at CKPT_RESUME and resumed by a fresh Trainer (losses within
# CKPT_LOSS_BAR relative; bit-equal expected); then DSP_RANKS processes
# sharing the card over gloo at depth CKPT_RANK_DEPTH: save at (2, 2),
# restore at (1, 4) and at world size 1, replan(2)
CKPT_BATCH, CKPT_STEPS, CKPT_RESUME, CKPT_LOSS_BAR = 2, 4, 2, 1e-5
# (4 until phases 24-25 needed the seconds, 2 until phase 27 did)
CKPT_RANK_DEPTH = 1
# the kernels at the shapes a rank of the (2, 2) cases gives them: K1 on
# qwen3-14b's 20 q and 4 K/V heads, K2 on mamba2-370m's 16 heads
LM_ZERO_ATTN = (1, _Q.n_heads // 2, _Q.n_kv_heads // 2, TRAIN_SEQ, TRAIN_SEQ,
                _Q.head_dim, True, None, None)
LM_ZERO_SSD = (1, TRAIN_SEQ, _M.n_heads // 2, _M.head_dim, _M.n_groups,
               _M.d_state, _M.chunk)
# K2 at the shapes the checkpoint phase gives it: CKPT_BATCH sequences on
# all 32 heads (world 1), on 8 (a rank at (1, 4)) and on 16 (a rank at
# (1, 2) after replan(2))
CKPT_SSD = tuple((CKPT_BATCH, TRAIN_SEQ, _M.n_heads // n, _M.head_dim,
                  _M.n_groups, _M.d_state, _M.chunk) for n in (1, 4, 2))


# the sharded-serving phase: phases 5's and 9's trace under SERVE_PLAN (the
# CLI's default plan: ZeRO and the vocab split on), at world size 1 over
# NCCL against their tokens; then DSP_RANKS processes sharing the card over
# gloo, each case (LM, depth: None for full, whether to replan) against a
# one-rank reference at the same depth: the logits of SERVE_FORCED_STEPS
# decode steps fed the reference's tokens within LOGIT_BAR, and on the
# replan case replan(SERVE_REPLAN_TO) at decode step SERVE_REPLAN_STEP.
# qwen3-14b's 40 layers whole on 4 ranks would need ~118 GB: depth 1
# (depth 4 until the DiT's ZeRO phase 21 needed its seconds, 2 until
# phase 27 did).  On the 4
# ranks the CLI's plan holds the teacher-forced check: the
# SERVE_FORCED requests (the shortest and the longest prompt) and
# SERVE_FORCED_STEPS decode steps.  The trace itself runs under
# SERVE_RANK_PLAN, the same without ZeRO: ZeRO gathers every weight a
# decode step, 2.64 GB a rank at qwen3's depth 4, which gloo moves through
# the host at ~0.9 GB/s on one H100 80GB HBM3 at 700 W (2.89 s a step,
# 205 s the trace; mamba2's ~200 gathers a step, 1.64 s)
SERVE_PLAN = ParallelPlan(mode="dsp")
SERVE_RANK_PLAN = ParallelPlan(mode="dsp", zero=False)
# (LM, depth: None for full, whether to replan, the forced checks: each a
# depth and a dtype).  mamba2-370m's 48 layers amplify any change of
# arithmetic: in bf16 on one H100 K2's kernel and its plain version already
# drift 0.17-0.40 of the largest logit apart over the forced steps
# (``serve_refs`` logs it, and the gap layer by layer), in f32 the 4 ranks
# stay within 7.6e-4 of one card; so its forced check at the served depth
# runs in f32 (K2 on ``cuda_cores``), and one in bf16 holds K2's
# ``sm90`` route; the trace runs in bf16 (on ``sm90``).  mamba2 serves at
# depth 2 of 48 on the ranks (48 until phases 24-25 needed the seconds,
# 12 until phase 26 did, 6 until phase 27 did, 4 until phases 29-30 did)
SERVE_RANK_CASES = (("qwen3-14b", 1, True, ((1, torch.bfloat16),)),
                    ("mamba2-370m", 2, False,
                     ((2, torch.float32), (2, torch.bfloat16))))
SERVE_FORCED, SERVE_FORCED_STEPS = (0, N_REQUESTS - 1), 4
# the new tokens of each request of the ranks' trace (NEW_TOKENS until
# phases 24-25 needed the seconds)
SERVE_RANK_NEW = 8
SERVE_REPLAN_STEP, SERVE_REPLAN_TO = 3, 2
# the kernels at the shapes a rank of (b) gives them, held against their
# plain versions in phase 3: each prompt of the trace padded on the right
# to a whole share a rank (``lm.prefill_shard_len``), K1 on qwen3-14b's
# heads over DSP_RANKS ranks and over SERVE_REPLAN_TO (after the replan),
# K2 on mamba2-370m's heads over DSP_RANKS
SERVE_RANK_ATTN = tuple(
    (1, _Q.n_heads // n, _Q.n_kv_heads // n, s, s, _Q.head_dim, True, None,
     None)
    for n in (DSP_RANKS, SERVE_REPLAN_TO)
    for s in sorted({n * lm.prefill_shard_len(qwen3_14b.CONFIG, t, n)
                     for t in PROMPT_LENS}))
SERVE_RANK_SSD = tuple(
    (1, s, _M.n_heads // DSP_RANKS, _M.head_dim, _M.n_groups, _M.d_state,
     _M.chunk)
    for s in sorted({DSP_RANKS * lm.prefill_shard_len(
        mamba2_370m.CONFIG, t, DSP_RANKS) for t in PROMPT_LENS}))
# the baselines phase's DiT depth: its six modes at world size 1 each sat
# inside plan none's spread at depth 28 (PERF.md §6); one block pair keeps
# every check, count and bar (2 pairs until phases 24-25 needed the
# seconds)
SP_DEPTH = 2
# the paged phase (20): (a) one card, plan none, qwen3-14b at full width
# and depth through PagedScheduler (a chat service whose requests share one
# system prompt): 8 requests arriving at 0, each a shared PAGED_SYSTEM-
# token prompt and a seeded suffix of PAGED_SUFFIXES tokens (in that order
# twice), NEW_TOKENS new tokens each, MAX_BATCH slots, PAGED_BLOCK-token
# blocks, PAGED_CHUNK-token chunks, the prefix cache on.  Requests 0-3 are
# admitted together before any insert; 4-7 each find the system prompt in
# the tree: PAGED_HITS tokens; chunks 3 + 3 + 3 + 4, then 1 + 1 + 1 + 2
# (tests/test_torch_paged.py pins both on a tiny model).  The forced
# check: requests PAGED_FORCED (a miss across two chunk boundaries, a hit)
# teacher-forced through the paged and the slot path, SERVE_FORCED_STEPS
# decode steps, within LOGIT_BAR
PAGED_SYSTEM, PAGED_SUFFIXES = 1024, (64, 256, 512, 1024)
PAGED_BLOCK, PAGED_CHUNK = 16, 512
PAGED_HITS, PAGED_CHUNKS = 4 * PAGED_SYSTEM, 18
PAGED_FORCED = (0, 4)
# (b) PAGED_RANK_SLOTS processes sharing the card over gloo at (1,
# DSP_RANKS), qwen3-14b at depth PAGED_RANK_DEPTH under SERVE_RANK_PLAN:
# 4 requests of a PAGED_RANK_SYSTEM-token shared prefix and suffixes of
# PAGED_RANK_SUFFIXES, PAGED_RANK_NEW new tokens, PAGED_RANK_CHUNK-token
# chunks, 2 slots, replan(SERVE_REPLAN_TO) at the first decode step with a
# prefill mid-prompt
# (depth 4 until phases 24-25 needed the seconds)
PAGED_RANK_DEPTH, PAGED_RANK_SLOTS = 2, 2
PAGED_RANK_SYSTEM, PAGED_RANK_SUFFIXES = 256, (32, 128, 64, 96)
PAGED_RANK_CHUNK, PAGED_RANK_NEW = 128, 8
PAGED_RANK_FORCED = (0, 2)
# K1 at the shapes phase 20 (a)'s chunks give it: 512 queries of the 40
# heads at offset L - 512 against the row's L keys of 8 K/V heads, and a
# ragged 64-token chunk at offset 1024
PAGED_ATTN = tuple((1, _Q.n_heads, _Q.n_kv_heads, 512, n, _Q.head_dim, True,
                    None, None) for n in (512, 1024, 1536, 2048)) + (
    (1, _Q.n_heads, _Q.n_kv_heads, 64, 1088, _Q.head_dim, True, None, None),)


# phase 22: starcoder2-7b and gemma2-2b each serve MODEL_REQUESTS requests
# of MODEL_NEW_TOKENS new tokens, starcoder2's prompts over 512-2048
# tokens, gemma2's with one of GEMMA_LONG tokens, past its window of 4096;
# qwen2-moe-a2.7b serves phase 5's trace and trains at depth
# MOE_TRAIN_DEPTH of 24 (AdamW's f32 state for its 15.1B stored
# parameters does not fit one card), MOE_TRAIN_STEPS steps at 1 x
# TRAIN_SEQ
MODEL_REQUESTS, MODEL_NEW_TOKENS = 4, 16
STARCODER_LENS = np.linspace(512, 2048, MODEL_REQUESTS).astype(int).tolist()
GEMMA_LONG = 4608
GEMMA_LENS = [512, 1024, 2048, GEMMA_LONG]
MOE_TRAIN_DEPTH, MOE_TRAIN_STEPS = 4, 4
# phase 23 (b): qwen2-moe-a2.7b at full width but its vocab, depth
# MOE_RANK_DEPTH in float32 at MOE_RANK_BATCH x MOE_RANK_SEQ, under its
# spec's plan (dsp, ep, ZeRO-3) at each mesh of MOE_RANK_MESHES against
# one rank: the loss within MOE_LOSS_BAR relative, each grad slice within
# MOE_GRAD_BAR of its leaf's max (tests/test_torch_moe_ep.py's bars)
# (depth 2 at 2048 tokens until phases 24-25 needed its seconds).  Its
# vocab is cut to MOE_RANK_VOCAB for the script's clock (151936 until
# phase 31 needed the seconds): at depth 1 its two f32 tables are 2.49 GB
# of the model's 4.77 GB, which ZeRO's gathers, the vocab ring and the
# grads' sums move through the host (2.82 GB in all at 32768), and no
# check of the phase reads the vocab
MOE_RANK_DEPTH, MOE_RANK_BATCH, MOE_RANK_SEQ = 1, 2, 1024
MOE_RANK_VOCAB = 32768
MOE_RANK_MESHES = ((1, 4), (2, 2))
MOE_LOSS_BAR, MOE_GRAD_BAR = 1e-5, 1e-4
# K1 at the three models' prefill shapes: starcoder2's GQA group of 9,
# qwen2-moe's 16 heads, gemma2's D 256 with window and softcap at
# GEMMA_LONG keys (phase 3, timed in phase 4); and at a rank's shapes in
# phase 23 (b), float32 (16 heads over 4 ranks at batch 2, over 2 at 1)
MODEL_ATTN = {
    "starcoder2-7b": (1, 36, 4, 2048, 2048, 128, True, None, None),
    "qwen2-moe-a2.7b": (1, 16, 16, 2048, 2048, 128, True, None, None),
    "gemma2-2b": (1, 8, 4, GEMMA_LONG, GEMMA_LONG, 256, True, 4096, 50.0)}
MOE_RANK_ATTN = ((2, 4, 4, MOE_RANK_SEQ, MOE_RANK_SEQ, 128, True, None, None),
                 (1, 8, 8, MOE_RANK_SEQ, MOE_RANK_SEQ, 128, True, None, None))
# phases 24-25: mistral-large-123b (its published config, the KV cache in
# float8_e4m3fn) on one card, bf16, random weights from seed 0: (a) at
# depth 2 the kernel path against the plain path, the prefill at
# max(MISTRAL_LENS) tokens; (b) at depth MISTRAL_SERVE_DEPTH of 88 (16 x
# 1.384B + the two 0.40B tables = 22.95B parameters, 45.9 GB, the deepest
# that leaves the card room for the pool and a prefill)
# MISTRAL_REQUESTS requests over MISTRAL_LENS, MODEL_NEW_TOKENS new tokens
# each, through ContinuousScheduler; (c) MISTRAL_TRAIN_STEPS Trainer steps
# at depth MISTRAL_TRAIN_DEPTH at 1 x TRAIN_SEQ (AdamW's f32 state for
# 123B parameters fits no card).  Phase 25 runs them under the spec's own
# plan (TP_PLAN: tp, ZeRO-3 over data, the vocab ring), at world size 1
# over NCCL and on DSP_RANKS gloo ranks at each mesh of TP_RANK_MESHES,
# depth TP_RANK_DEPTH in float32 at TP_RANK_BATCH x TP_RANK_SEQ against
# one rank (TP_LOSS_BAR, TP_GRAD_BAR: tests/test_torch_tp.py's bars), and
# serves TP_RANK_LENS at (1, DSP_RANKS) through replan(SERVE_REPLAN_TO)
MISTRAL_REQUESTS, MISTRAL_SERVE_DEPTH = 4, 16
MISTRAL_LENS = np.linspace(512, 2048, MISTRAL_REQUESTS).astype(int).tolist()
MISTRAL_TRAIN_DEPTH, MISTRAL_TRAIN_STEPS = 2, 4
TP_PLAN = mistral_large_123b.SPEC.plan
TP_RANK_DEPTH, TP_RANK_BATCH, TP_RANK_SEQ = 1, 2, 256
TP_RANK_MESHES = ((1, 4), (2, 2))
TP_LOSS_BAR, TP_GRAD_BAR = 1e-5, 1e-4
TP_RANK_LENS, TP_RANK_NEW = (256, 512), 8
# the ranks' tokens must be one rank's up to a step where one rank's two
# best logits lie within TP_TIE_BAR of its largest |logit| (f32 sums over
# 4 ranks round apart by ~1e-6 of it; random weights make near-ties)
TP_TIE_BAR = 1e-4
# the 4 ranks' trace runs with ZeRO and the vocab split off, as phase 19
# (b)'s runs with ZeRO off: ZeRO gathers every weight a decode step and
# the ring moves the whole f32 table a prefill, through the host over gloo
TP_RANK_SERVE_PLAN = dataclasses.replace(TP_PLAN, zero=False,
                                         shard_vocab=False)
_MI = mistral_large_123b.CONFIG
# K1 at mistral's prefill shape (96 q and 8 K/V heads, a GQA group of 12)
# and at one rank's heads under tp at n = 4 (24 and 2), bf16 on ``sm90``
# (phase 3, timed in phase 4); and at the shapes a rank of phase 25 (b)
# gives it, f32 on ``cuda_cores`` (TP_RANK_ATTN)
TP_ATTN = {
    "mistral-large-123b": (1, _MI.n_heads, _MI.n_kv_heads, 2048, 2048,
                           _MI.head_dim, True, None, None),
    "mistral-large-123b/rank": (1, _MI.n_heads // DSP_RANKS,
                                _MI.n_kv_heads // DSP_RANKS, 2048, 2048,
                                _MI.head_dim, True, None, None)}
TP_RANK_ATTN = tuple(
    (TP_RANK_BATCH // dp, _MI.n_heads // mp, _MI.n_kv_heads // mp,
     TP_RANK_SEQ, TP_RANK_SEQ, _MI.head_dim, True, None, None)
    for dp, mp in TP_RANK_MESHES)
# phase 26: seamless-m4t-large-v2 (24 + 24 layers, d 1024, 16 heads of
# 64, vocab 256206: 1.37B parameters), bf16, random weights from seed 0:
# (a) at depth 2 + 2 the loss and grads at SEAMLESS_BATCH x (SEAMLESS_ENC
# frames, SEAMLESS_DEC tokens) and the serving path kernel against plain
# (SEAMLESS_CHECK_STEPS decode steps); (b) at full depth SEAMLESS_REQUESTS
# requests of SEAMLESS_ENC frames with SEAMLESS_PROMPT-token prompts and
# SEAMLESS_NEW new tokens each (speech-to-text translation over long
# audio); (c) SEAMLESS_STEPS Trainer steps at full depth; (d) (c) at world
# size 1 over NCCL under the spec's plan (SEAMLESS_PLAN: dsp, ZeRO-3);
# (e) DSP_RANKS gloo ranks at each mesh of SEAMLESS_RANK_MESHES, depth
# SEAMLESS_RANK_DEPTH + SEAMLESS_RANK_DEPTH in float32 at
# SEAMLESS_RANK_BATCH x (SEAMLESS_RANK_ENC, SEAMLESS_RANK_DEC) against one
# rank (tests/test_torch_encdec_dsp.py's bars)
_SE = seamless_m4t_large_v2.CONFIG
SEAMLESS_PLAN = seamless_m4t_large_v2.SPEC.plan
SEAMLESS_BATCH, SEAMLESS_ENC, SEAMLESS_DEC, SEAMLESS_STEPS = 2, 4096, 2048, 4
SEAMLESS_REQUESTS, SEAMLESS_PROMPT, SEAMLESS_NEW = 4, 16, 32
SEAMLESS_CHECK_STEPS = 4
SEAMLESS_RANK_DEPTH, SEAMLESS_RANK_BATCH = 1, 2
SEAMLESS_RANK_ENC, SEAMLESS_RANK_DEC = 1024, 256
SEAMLESS_RANK_MESHES = ((1, 4), (2, 2))
SEAMLESS_LOSS_BAR, SEAMLESS_GRAD_BAR = 1e-5, 1e-4
# the cross-attention's K bias: its gradient is zero in exact arithmetic
# (no rope, and the softmax is invariant to a shift along the keys), so
# two paths' rounding noise there is held against the whole gradient's
# largest |value|, not the leaf's
SEAMLESS_ZERO_GRAD = "cross_attn/wk/b"
# (a)'s bf16 grads against the f32 plain path's: the kernel's max error
# of each leaf at most this many times the plain bf16 path's own, the rule
# FlashAttention's tests hold their bf16 gradients to
BF16_SPREAD = 2
# (e)'s ReLUs: where the two runs' f32 roundings put a pre-activation on
# either side of 0 (one of (e)'s 4.2M decoder entries on an H100), that
# token's whole term moves its unit's column of ``wi`` (5.9e-3 of the
# leaf's max) and every leaf upstream (up to 7.4e-4).  Both runs take the
# ReLU's gradient as 0 at the entries whose one-rank pre-activation lies
# within SEAMLESS_HELD_TAU times the layer's RMS of 0 (``relu_held``; the
# forward is unchanged), and the ranks show that no entry outside them
# changed sign: every leaf is then held to SEAMLESS_GRAD_BAR
SEAMLESS_HELD_TAU = 2e-5
# K1 at seamless's three shapes, bf16 on ``sm90`` at D 64 (phase 3, timed
# in phase 4 beside scaled_dot_product_attention): the encoder's
# bidirectional self-attention, the decoder's causal one, and the
# cross-attention of S_dec queries against S_enc keys, not causal; and at
# the shapes a rank of (e) gives it, f32 on ``cuda_cores``
SEAMLESS_ATTN = {
    "seamless/encoder": (1, _SE.n_heads, _SE.n_kv_heads, SEAMLESS_ENC,
                         SEAMLESS_ENC, _SE.head_dim, False, None, None),
    "seamless/decoder": (1, _SE.n_heads, _SE.n_kv_heads, SEAMLESS_DEC,
                         SEAMLESS_DEC, _SE.head_dim, True, None, None),
    "seamless/cross": (1, _SE.n_heads, _SE.n_kv_heads, SEAMLESS_DEC,
                       SEAMLESS_ENC, _SE.head_dim, False, None, None)}
SEAMLESS_RANK_ATTN = tuple(
    (SEAMLESS_RANK_BATCH // dp, _SE.n_heads // mp, _SE.n_kv_heads // mp,
     sq, skv, _SE.head_dim, causal, None, None)
    for dp, mp in SEAMLESS_RANK_MESHES
    for sq, skv, causal in ((SEAMLESS_RANK_ENC, SEAMLESS_RANK_ENC, False),
                            (SEAMLESS_RANK_DEC, SEAMLESS_RANK_DEC, True),
                            (SEAMLESS_RANK_DEC, SEAMLESS_RANK_ENC, False)))
# phase 27: arctic-480b (35 layers, d 7168, 56/8 heads of 128, 128 experts
# top-2 of F 4864 beside a dense residual MLP of 4864, vocab 32000, its KV
# cache in float8_e4m3fn: 13.61B parameters a layer), bf16, random weights
# from seed 0: (a) at depth ARCTIC_DEPTH (14.1B parameters, 28.2 GB)
# kernel against plain; (b) ARCTIC_LENS's requests, ARCTIC_NEW new tokens
# each, on the same weights on one card, and again under
# ARCTIC_SERVE_PLAN at world size 1 (at one rank every read of a leaf
# that a spec splits over ``data`` is an all-gather that copies it: a
# period's 13.4B expert parameters copied beside depth 2's 55.4 GB exceed
# the card).  At depth 2 the init must stage a period on the host (~21
# s) and its serving cannot be the mesh run's reference; (c)
# ARCTIC_TRAIN_STEPS Trainer steps at depth 1 with the experts cut to ARCTIC_TRAIN_EXPERTS
# (AdamW's f32 state for one full layer fits no card), at 1 x TRAIN_SEQ,
# and again under the spec's plan (ARCTIC_PLAN: tp, ep, ZeRO-3 over data,
# the vocab ring) at world size 1; (d) qwen2-moe-a2.7b's phase-22 trace
# under QWEN_MESH_PLAN at world size 1; (e) DSP_RANKS gloo ranks, arctic's
# widths at depth ARCTIC_RANK_DEPTH with ARCTIC_RANK_EXPERTS experts in
# float32 at ARCTIC_RANK_BATCH x ARCTIC_RANK_SEQ under ARCTIC_PLAN at each
# mesh of ARCTIC_RANK_MESHES against one rank (TP_LOSS_BAR, TP_GRAD_BAR),
# then ARCTIC_RANK_LENS's requests at (1, DSP_RANKS) under each of
# ARCTIC_RANK_PLANS (ZeRO and the vocab split off, as 25 (b)'s), ``tp`` +
# ``ep`` through replan(SERVE_REPLAN_TO)
_AR = arctic_480b.CONFIG
ARCTIC_DEPTH, ARCTIC_NEW = 1, 16
ARCTIC_LENS = np.linspace(512, 2048, 4).astype(int).tolist()
ARCTIC_TRAIN_EXPERTS, ARCTIC_TRAIN_STEPS = 16, 4
ARCTIC_PLAN = arctic_480b.SPEC.plan
# the serving rule of ``param_pspecs`` for tp with ep: the experts over
# model, each expert's hidden columns over data
ARCTIC_SERVE_PLAN = ParallelPlan(mode="tp", ep=True, zero=False)
# (d)'s plan without ZeRO or the vocab split, whose per-step gathers of
# every weight, or of both tables (each a copy at world 1), took TPOT p50
# from 101 to 305 ms, or 162, on one H100 80GB HBM3 at 700 W
QWEN_MESH_PLAN = ParallelPlan(mode="dsp", ep=True, zero=False,
                              shard_vocab=False)
ARCTIC_RANK_DEPTH, ARCTIC_RANK_EXPERTS = 1, 8
ARCTIC_RANK_BATCH, ARCTIC_RANK_SEQ = 2, 256
ARCTIC_RANK_MESHES = ((1, 4), (2, 2))
ARCTIC_RANK_LENS, ARCTIC_RANK_NEW = (64, 128), 6
ARCTIC_RANK_PLANS = {
    "dsp": ParallelPlan(mode="dsp", zero=False, shard_vocab=False),
    "tp_ep": dataclasses.replace(ARCTIC_SERVE_PLAN, shard_vocab=False)}
ARCTIC_SERVE_CLI = ["--arch", "arctic-480b", "--batch", "4", "--prompt-len",
                    "16", "--new-tokens", "8", "--continuous"]
# K1 at arctic's prefill shape (56 q and 8 K/V heads, a GQA group of 7)
# and at one rank's heads under tp at n = 4 (14 and 2), bf16 on ``sm90``
# (phase 3, timed in phase 4 with the ``cuda_cores`` route); and at the
# shapes a rank of (e) gives it, f32 on ``cuda_cores``: training at each
# mesh, and each prompt padded to a whole share a rank
ARCTIC_ATTN = {
    "arctic-480b": (1, _AR.n_heads, _AR.n_kv_heads, 2048, 2048,
                    _AR.head_dim, True, None, None),
    "arctic-480b/rank": (1, _AR.n_heads // DSP_RANKS,
                         _AR.n_kv_heads // DSP_RANKS, 2048, 2048,
                         _AR.head_dim, True, None, None)}
ARCTIC_RANK_ATTN = tuple(
    (ARCTIC_RANK_BATCH // dp, _AR.n_heads // mp, _AR.n_kv_heads // mp,
     ARCTIC_RANK_SEQ, ARCTIC_RANK_SEQ, _AR.head_dim, True, None, None)
    for dp, mp in ARCTIC_RANK_MESHES) + tuple(
    (1, _AR.n_heads // DSP_RANKS, _AR.n_kv_heads // DSP_RANKS, s, s,
     _AR.head_dim, True, None, None)
    for s in sorted({DSP_RANKS * lm.prefill_shard_len(_AR, t, DSP_RANKS)
                     for t in ARCTIC_RANK_LENS}))


# phase 29: seamless-m4t-large-v2 served on a (data, model) mesh: (a) phase
# 26 (b)'s trace at full width and depth at world size 1 over NCCL under
# SEAMLESS_PLAN (dsp, ZeRO-3), the tokens phase 26 (b)'s and the calls and
# bytes exactly ``encdec.serve_contract``'s; (b) DSP_RANKS gloo ranks,
# seamless's widths at depth SEAMLESS_RANK_DEPTH + SEAMLESS_RANK_DEPTH in
# float32 at each mesh of SEAMLESS_RANK_MESHES under
# SEAMLESS_SERVE_RANK_PLAN (ZeRO off: over gloo its per-step gathers would
# move the 1.05 GB float32 table a step, as phase 19 (b) avoids),
# SEAMLESS_REQUESTS requests of SEAMLESS_RANK_ENC frames with
# SEAMLESS_PROMPT-token prompts and SEAMLESS_SERVE_RANK_NEW new tokens: the
# tokens one rank's up to a near-tie (TP_TIE_BAR), the calls exactly the
# contract
SEAMLESS_SERVE_RANK_PLAN = dataclasses.replace(SEAMLESS_PLAN, zero=False)
SEAMLESS_SERVE_RANK_NEW = 8
SEAMLESS_SERVE_RANK_ATTN = tuple(
    (SEAMLESS_REQUESTS // dp, _SE.n_heads // mp, _SE.n_kv_heads // mp, sq,
     skv, _SE.head_dim, causal, None, None)
    for dp, mp in SEAMLESS_RANK_MESHES
    for sq, skv, causal in ((SEAMLESS_RANK_ENC, SEAMLESS_RANK_ENC, False),
                            (SEAMLESS_PROMPT, SEAMLESS_PROMPT, True),
                            (SEAMLESS_PROMPT, SEAMLESS_RANK_ENC, False)))
# phase 30: pixtral-12b (40 layers, d 5120, 32/8 heads of 160, F 14336,
# vocab 131072 untied, a stub frontend of 1024 patch rows of 1024
# features: 12.77B parameters, 5.2M of them in the frontend, 25.5 GB; the
# heads of 160 are the JAX package's config, whose source marks itself
# unverified: the published model's are of 128), bf16,
# random weights from seed 0: (a) at depth PIXTRAL_DEPTH kernel against
# plain with a 1 x TRAIN_SEQ batch whose patch rows replace its first
# 1024 positions; (b) PIXTRAL_LENS's requests, PIXTRAL_NEW new tokens each,
# at full depth behind the scheduler (text, as JAX's engine serves it),
# then one ``forward_prefill(extra=)`` of a PIXTRAL_PREFILL-token prompt
# with its patch rows; (c) PIXTRAL_STEPS Trainer steps at depth
# PIXTRAL_DEPTH, 1 x TRAIN_SEQ with the patch rows, and again under the
# spec's plan (PIXTRAL_PLAN: dsp, ZeRO-3) at world size 1; (d) K1 at the
# prefill's shape (PIXTRAL_ATTN), on ``cuda_cores`` (``sm90`` takes D
# 64/72/128), against its plain version and scaled_dot_product_attention
_PX = pixtral_12b.CONFIG
PIXTRAL_PLAN = pixtral_12b.SPEC.plan
PIXTRAL_DEPTH, PIXTRAL_STEPS = 2, 4
PIXTRAL_LENS = np.linspace(512, 2048, 4).astype(int).tolist()
PIXTRAL_NEW, PIXTRAL_PREFILL = 16, 2048
PIXTRAL_ROUTE = ROUTES[(torch.bfloat16, _PX.head_dim)]
PIXTRAL_ATTN = {"pixtral-12b": (1, _PX.n_heads, _PX.n_kv_heads,
                                PIXTRAL_PREFILL, PIXTRAL_PREFILL,
                                _PX.head_dim, True, None, None)}

# the jamba phase (31): jamba-1.5-large-398b (arXiv:2403.19887; the SSD
# geometry P 128, S 128, G 8 is the JAX config's own choice, Jamba's paper
# builds its SSM layers from Mamba) at full width, one 8-layer period
# (attention at layer 3, SSD elsewhere, MoE on the odd layers), bf16, the
# KV cache in float8_e4m3fn, weights from seed 0.  The period holds 6.58B
# parameters beside its experts and 2.42B for each expert kept; all 16
# (45.2B, 90.4 GB) exceed the card, so it keeps JAMBA_EXPERTS: 25.9B, 51.8
# GB (top-2 over 8 leaves each token's path jamba's).  (a) kernel against
# plain on one set of weights, the plain path's routing replayed: the
# prefill logits of a JAMBA_PREFILL-token prompt and SERVE_FORCED_STEPS
# decode steps, JAMBA_LENS's requests teacher-forced through the slot pool
# (BlockPool refuses SSM layers); (b) those requests, JAMBA_NEW new tokens
# each, one card, then under JAMBA_SERVE_PLAN at world size 1 over NCCL
# (JAX's serving rule drops ZeRO for decode; ``tp_flat`` waits for ``tp``
# with SSM layers); (c) K2 at JAMBA_SSD and K1 at JAMBA_ATTN timed; (d)
# DSP_RANKS gloo ranks in f32 on JAMBA_RANK_MESHES, widths cut with the
# head shapes kept (P 128, S 128, chunk 128, attention D 128), trained
# under the spec's plan and served under JAMBA_SERVE_PLAN
_JA = jamba_1_5_large_398b.CONFIG
_JS = _JA.ssm_cfg
JAMBA_PLAN = jamba_1_5_large_398b.SPEC.plan
JAMBA_SERVE_PLAN = dataclasses.replace(JAMBA_PLAN, zero=False)
JAMBA_EXPERTS, JAMBA_NEW, JAMBA_PREFILL = 8, 16, 2048
JAMBA_LENS = np.linspace(512, 2048, 4).astype(int).tolist()
JAMBA_SSD = (1, JAMBA_PREFILL, _JS.n_heads, _JS.head_dim, _JS.n_groups,
             _JS.d_state, _JS.chunk)
JAMBA_ATTN = {"jamba-1.5-large-398b": (1, _JA.n_heads, _JA.n_kv_heads,
                                       JAMBA_PREFILL, JAMBA_PREFILL,
                                       _JA.head_dim, True, None, None)}
# phase 3's K2 cases at P 128 (B, L, H, P, G, S, chunk), each with the
# dtypes and routes it runs on (None: the route ``ssd_route`` gives):
# jamba's prefill (G 8), one B/C group at a ragged length, the edge
# lengths of SSD_SM90_EDGES, and P 96, whose second 64-column tile is
# partial, on ``cuda_cores``
JAMBA_SSD_CASES = (
    (JAMBA_SSD, ((torch.bfloat16, None), (torch.bfloat16, "cuda_cores"),
                 (torch.float32, None))),
    ((2, 2000, 8, 128, 1, 128, 128),
     ((torch.bfloat16, None), (torch.bfloat16, "cuda_cores"),
      (torch.float32, None))),
    ((2, 1, 4, 128, 1, 128, 128), ((torch.bfloat16, None),)),
    ((2, 100, 4, 128, 2, 128, 128), ((torch.bfloat16, None),
                                     (torch.float32, None))),
    ((1, 300, 4, 96, 2, 128, 128), ((torch.bfloat16, None),
                                    (torch.float32, None))),
)
# (a)'s bar: LOGIT_BAR, or JAMBA_NOISE_FACTOR times the plain path's own
# rounding noise where that reaches it (phase 26's rule for seamless's
# bf16 grads).  One period of jamba at full width in bf16 turns any
# difference of float32 summation order into ~2e-2 of the largest logit:
# the plain path against itself with K2's float32 result nudged by 2**-20
# drifted 1.91e-2-2.45e-2 per row, K2 on ``cuda_cores`` 1.95e-2-2.55e-2,
# on ``sm90`` 2.13e-2-2.48e-2 (one H100 80GB HBM3 at 700 W; K1 alone
# 0.94e-2-1.10e-2).  The noise is measured in the run, as
# ``nudged_plain``: each plain K1 and K2 call's float32 result perturbed
# by JAMBA_NUDGE relative noise
JAMBA_NUDGE, JAMBA_NOISE_FACTOR = 2.0 ** -20, 2.0
# (d): one period at cut widths with jamba's head shapes (about 0.42B
# parameters, 1.7 GB in float32), JAMBA_RANK_EXPERTS experts (at 4 no
# pair dropped in phase 27 (e), which left its drop check empty), trained
# on JAMBA_RANK_BATCH x JAMBA_RANK_SEQ at each mesh of JAMBA_RANK_MESHES,
# then JAMBA_RANK_LENS's requests served at (1, DSP_RANKS), JAMBA_RANK_NEW
# new tokens each
JAMBA_RANK_WIDTHS = dict(d_model=1024, n_heads=8, n_kv_heads=4, d_ff=2048,
                         d_inner=2048, n_groups=4)
JAMBA_RANK_EXPERTS = 8
# the router bias of (d)'s weights towards expert 0 (a ``b`` leaf the
# router reads, as tests/_torch_moe_ep_jax.py's ``biased`` config): at
# seed 0 the routing is near uniform, and a capacity of twice the mean
# load dropped no pair (one H100 80GB HBM3 at 700 W), which would leave
# the drop check empty
JAMBA_RANK_ROUTER_BIAS = 1.2
# (d)'s grad bar: MOE_GRAD_BAR of a leaf's max, or JAMBA_NOISE_FACTOR
# times the reference's own f32 noise on that leaf where it reaches that:
# the reference against itself with its embedding table nudged by
# JAMBA_RANK_NUDGE relative noise.  The SSD layers' ``a_log`` grads sum
# terms of both signs over every token: one rank's and 4 ranks' f32 sums
# in other orders (GEMMs over 2 x 512 rows against 2 x 128) put the worst
# slice at 1.199e-4 of its leaf's max, all others below (one H100 80GB
# HBM3 at 700 W), where the reference's own noise was 1.084e-4
JAMBA_RANK_NUDGE = 2.0 ** -23
JAMBA_RANK_MESHES = ((1, 4), (2, 2))
JAMBA_RANK_BATCH, JAMBA_RANK_SEQ = 2, 512
JAMBA_RANK_LENS, JAMBA_RANK_NEW = (256, 512), 4
# the kernels at the shapes a rank of (d) gives them, in float32 (on
# ``cuda_cores``): the heads split over the model ranks by the switch, the
# whole sequence, the batch over the data ranks; training at each mesh,
# then each served prompt at (1, DSP_RANKS)
_JW = JAMBA_RANK_WIDTHS
JAMBA_RANK_ATTN = tuple(
    (b, _JW["n_heads"] // m, _JW["n_kv_heads"] // m, s, s, _JA.head_dim,
     True, None, None)
    for b, m, s in [(JAMBA_RANK_BATCH // d, m, JAMBA_RANK_SEQ)
                    for d, m in JAMBA_RANK_MESHES]
    + [(1, DSP_RANKS, s) for s in JAMBA_RANK_LENS])
JAMBA_RANK_SSD = tuple(
    (b, s, _JW["d_inner"] // _JS.head_dim // m, _JS.head_dim,
     _JW["n_groups"] // m, _JS.d_state, _JS.chunk)
    for b, m, s in [(JAMBA_RANK_BATCH // d, m, JAMBA_RANK_SEQ)
                    for d, m in JAMBA_RANK_MESHES]
    + [(1, DSP_RANKS, s) for s in JAMBA_RANK_LENS])


def prefill_case(s: int):
    """One qwen3-14b prefill layer's attention at an s-token prompt."""
    return (1, 40, 8, s, s, 128, True, None, None)


# the serving slice: the longest prompt's prefill layer, 2048 tokens
SLICE = prefill_case(max(PROMPT_LENS))
# K1 at the DiT's head dim 72 (1152 / 16), non-causal: a spatial layer's
# attention over 2 folded frames, a temporal layer's over the 4096 folded
# patches of DIT_FRAMES frames, and a ragged length
DIT_HEADS, DIT_DH = 16, 72
DIT_TEMPORAL = (DIT_PATCHES, DIT_HEADS, DIT_HEADS, DIT_FRAMES, DIT_FRAMES,
                DIT_DH, False, None, None)
DIT_ATTN_CASES = [
    (2, DIT_HEADS, DIT_HEADS, DIT_PATCHES, DIT_PATCHES, DIT_DH, False, None,
     None),
    DIT_TEMPORAL,
    (1, 3, 3, 100, 100, DIT_DH, False, None, None)]
# K1's timing shape on the DiT path: 4 of a spatial layer's folded frames
# (the kernel's time grows with their count)
DIT_SLICE = (4, DIT_HEADS, DIT_HEADS, DIT_PATCHES, DIT_PATCHES, DIT_DH,
             False, None, None)
# the route every K1 launch of the DiT (bf16 at head dim 72) must take
DIT_ROUTE = "sm90"
# the DiT's ZeRO phase (21): transformer2d-720m under its spec's own plan,
# ZeRO-3 over ("data", "model"): (a) phase 13's four steps at world size 1
# over NCCL, the first step's loss and grads bit-equal to phase 13's path,
# the losses bit-equal to phase 13's (or within T2D_ZERO_LOSS_BAR where
# the clip's norm from slices sums in another order); (b) DSP_RANKS
# processes sharing the card over gloo at each mesh of T2D_ZERO_MESHES,
# depth T2D_ZERO_DEPTH at T2D_ZERO_BATCH x T2D_ZERO_FRAMES x DIT_PATCHES in
# float32 against one rank without ZeRO: the loss within T2D_ZERO_LOSS_BAR
# relative and each grad slice within T2D_ZERO_GRAD_BAR of its leaf's max
# (tests/test_torch_t2d_zero.py's bars; in bf16 each rank's partial grads
# round to 8 bits before the reduce-scatter sums them, ~4e-3 of a leaf),
# then a (2, 2) checkpoint restored at (1, 4) bit for bit (depth 4 until
# phases 24-25 needed the seconds, 8 frames until phase 27 did)
T2D_ZERO_DEPTH, T2D_ZERO_BATCH, T2D_ZERO_FRAMES = 2, 2, 4
T2D_ZERO_MESHES = ((2, 2), (1, 4))
T2D_ZERO_LOSS_BAR, T2D_ZERO_GRAD_BAR = 1e-5, 1e-4
# K1 at the shapes a rank of (b) gives it at either mesh, in float32: 2
# folded frames of a spatial block, the 2048 folded patches of a temporal
# block's 4 frames
T2D_ZERO_ATTN = (
    (T2D_ZERO_BATCH * T2D_ZERO_FRAMES // DSP_RANKS, DIT_HEADS, DIT_HEADS,
     DIT_PATCHES, DIT_PATCHES, DIT_DH, False, None, None),
    (2048, DIT_HEADS, DIT_HEADS, T2D_ZERO_FRAMES, T2D_ZERO_FRAMES, DIT_DH,
     False, None, None))


# the card's name and power limit (phase 1), logged beside every time
CARD = "card not read yet"


def log(*a):
    print(*a, flush=True)


def log_t(*a):
    """``log`` with the card's name and power limit after the line."""
    log(*a, f"[{CARD}]")


def card_facts() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def attn_inputs(case, dtype, seed):
    b, hq, hkv, sq, skv, d = case[:6]
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]


def attn_kw(case, q_offset=None):
    _, _, _, sq, skv, _, causal, window, softcap = case
    if q_offset is None:
        q_offset = skv - sq if causal else 0
    return dict(causal=causal, window=window, softcap=softcap,
                q_offset=q_offset)


def attn_worst_share(got, want, dtype) -> float:
    """The largest share of K1's bar ``TOL[dtype]`` over the output: per
    (b, h, row), |delta| <= rel * the row's max |plain| + abs."""
    want_f = want.float()
    diff = (got.float() - want_f).abs()
    rel, atol = TOL[dtype]
    bar = rel * want_f.abs().amax(dim=-1, keepdim=True) + atol
    return float((diff / bar).max())


def check_attention(case, dtype, seed, q_offset=None) -> float:
    """K1 against flash_attention_plain under ``attn_worst_share``'s bar,
    on the route ``ROUTES`` gives the case; the launch must take it."""
    q, k, v = attn_inputs(case, dtype, seed)
    kw = attn_kw(case, q_offset)
    route = ROUTES[(dtype, case[5])]
    before = flash_attention_fwd.route_launches[route]
    got = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    if flash_attention_fwd.route_launches[route] != before + 1:
        raise AssertionError(f"{case} {dtype} did not take route {route}")
    want = flash_attention_plain(q, k, v, **kw)
    err = float((got.float() - want.float()).abs().max())
    worst = attn_worst_share(got, want, dtype)
    log(f"  {tuple(case)} {str(dtype)[6:]} q_offset={kw['q_offset']} "
        f"route={route}: max |kernel - plain| = {err:.3e} ({worst:.3f} of "
        f"the bar)")
    if not worst <= 1.0:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version: {worst} of the bar {TOL[dtype]}")
    return err


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(case, dtype) -> dict:
    """Least time on the card: q, k, v read once and o written once, over
    the memory rate; 4 * D FLOP per visible (query, key) pair over the
    peak rate of the input type."""
    b, hq, hkv, sq, skv, d = case[:6]
    kw = attn_kw(case)
    qp = kw["q_offset"] + torch.arange(sq)[:, None]
    kp = torch.arange(skv)[None, :]
    vis = torch.ones(sq, skv, dtype=torch.bool)
    if kw["causal"]:
        vis &= kp <= qp
    if kw["window"] is not None:
        vis &= kp > qp - kw["window"]
    flops = 4 * d * b * hq * int(vis.sum())
    item = torch.finfo(dtype).bits // 8
    nbytes = item * d * (2 * b * hq * sq + 2 * b * hkv * skv)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def ssd_inputs(case, dtype, seed):
    """As tests/test_kernels.py builds them, in the kernel layout that
    ``kernels.ops.ssd_scan`` forms: xdt = x dt, da = dt a (float32)."""
    b, l, h, p, g, s, _ = case
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = r(b, l, h, p).to(dtype)
    dt = F.softplus(r(b, l, h)).to(dtype)
    a = -torch.exp(0.5 * r(h))
    bm, cm = r(b, l, g, s).to(dtype), r(b, l, g, s).to(dtype)
    xdt = (x * dt[..., None]).transpose(1, 2).contiguous()
    da = (dt * a).transpose(1, 2).contiguous()
    return (xdt, da, bm.transpose(1, 2).contiguous(),
            cm.transpose(1, 2).contiguous())


def ssd_worst_share(got, want) -> float:
    """The largest share of K2's bar over the output.  f32: max |delta| <=
    1e-4 max |plain| over the whole output (the two add the chunks in
    different orders and y grows with L).  bf16: per (b, h, l) row over P,
    |delta| <= 2**-6 the row's max |plain| + 1e-6, two ulps of one
    rounding, as K1's bar."""
    want_f = want.float()
    diff = (got.float() - want_f).abs()
    if want.dtype == torch.float32:
        bar = 1e-4 * want_f.abs().max()
    else:
        bar = 2.0 ** -6 * want_f.abs().amax(dim=-1, keepdim=True) + 1e-6
    return float((diff / bar).max())


def check_ssd(case, dtype, seed, route=None) -> float:
    """K2 against ssd_scan_plain under ``ssd_worst_share``'s bar, on
    ``route`` or, by default, the route ``ssd_route`` gives the case; the
    launch must take it."""
    xdt, da, b, c = ssd_inputs(case, dtype, seed)
    _, _, _, p, _, s, chunk = case
    route = route or ssd_route(dtype, p, s, chunk)
    before = ssd_scan_fwd.route_launches[route]
    got = ssd_scan_fwd(xdt, da, b, c, chunk=chunk, route=route)
    torch.cuda.synchronize()
    if ssd_scan_fwd.route_launches[route] != before + 1:
        raise AssertionError(f"ssd {case} {dtype} did not take route {route}")
    want = ssd_scan_plain(xdt, da, b, c, chunk=chunk)
    err = float((got.float() - want.float()).abs().max())
    worst = ssd_worst_share(got, want)
    log(f"  ssd {tuple(case)} {str(dtype)[6:]} route={route}: max |kernel "
        f"- plain| = {err:.3e} ({worst:.3f} of the bar)")
    if not worst <= 1.0:
        raise AssertionError(f"ssd_scan disagrees with its plain version at "
                             f"{case} {dtype}: {worst} of the bar")
    return err


def ssd_bound_ms(case, dtype) -> dict:
    """Least time on the card, the larger of two.  Operations, over the
    peak rate of the input type, for a chunk of n rows: c b^T over its
    causal triangle, 2S n(n+1)/2 FLOP once per B/C group (the group's
    heads share it); per head, the masked product with xdt, 2P n(n+1)/2,
    and the inter-chunk output and the state update, 2 x 2nPS.  Bytes,
    over the memory rate: xdt, da, b, c read once and y written once."""
    b, l, h, p, g, s, q = case
    tri = sum(n * (n + 1) for n in (min(q, l - i) for i in range(0, l, q)))
    flops = b * (g * s * tri + h * (p * tri + 4 * p * s * l))
    item = torch.finfo(dtype).bits // 8
    nbytes = item * (2 * b * h * l * p + 2 * b * g * l * s) + 4 * b * h * l
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def ptxas_report(log_text: str) -> list:
    """``-Xptxas -v``'s registers and spills (and any warning), one line
    per kernel instantiation, named by its mangled symbol's tail."""
    out, entry = [], "?"
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            tags = [t for t in ("flash_fwd", "ssd_scan") if t in entry]
            entry = entry[entry.rfind(tags[0]):] if tags else entry[-48:]
        elif "registers" in line or "spill" in line or "arning" in line:
            out.append(f"{entry.split('EEEv')[0]}: "
                       f"{line.replace('ptxas info    :', '').strip()}")
    return out


def sdpa(q, k, v, causal=True):
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


def logit_gap(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def full_width_prefill_check(cfg, lens, decode_steps=0,
                             device="cuda") -> None:
    """Depth-2 ``cfg``: last-position prefill logits through the kernel
    against the plain path, relative to the largest logit; then
    ``decode_steps`` greedy decode steps from each path's caches."""
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = lm.init_lm(0, cfg2, device=device)
    g = torch.Generator(device=device).manual_seed(2)
    for s in lens:
        tok = torch.randint(0, cfg.vocab, (1, s), generator=g, device=device)
        with torch.no_grad():
            got, c_got = lm.forward_prefill(params, tok, cfg2,
                                            backend="kernel")
            want, c_want = lm.forward_prefill(params, tok, cfg2,
                                              backend="ref")
            gaps = [logit_gap(got, want)]
            for _ in range(decode_steps):
                nxt = torch.argmax(want[:, -1], dim=-1)[:, None]
                got, c_got = lm.forward_decode(params, nxt, c_got, cfg2)
                want, c_want = lm.forward_decode(params, nxt, c_want, cfg2)
                gaps.append(logit_gap(got, want))
        log(f"  depth-2 prefill logits at {s} tokens: max |kernel - plain| "
            f"/ max |logit| = {gaps[0]:.3e}" + (
                f"; then {decode_steps} decode steps, worst "
                f"{max(gaps[1:]):.3e}" if decode_steps else ""))
        if not max(gaps) <= LOGIT_BAR:
            raise AssertionError(f"depth-2 prefill or decode logits disagree "
                                 f"at {s} tokens: {gaps}")
    del params
    torch.cuda.empty_cache()


def ssd_state_check(cfg, device="cuda") -> float:
    """One mamba2-370m layer's prefill state at the longest prompt:
    ``ssd_final_state`` (the closed form the prefill takes) against the
    sequential ``ssd_ref``, on bf16 inputs with the init's decay rates."""
    sc = cfg.ssm_cfg
    l, h = max(PROMPT_LENS), sc.n_heads
    gen = torch.Generator(device=device).manual_seed(4)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=device)
    x = r(1, l, h, sc.head_dim).bfloat16()
    dt = F.softplus(r(1, l, h)).bfloat16()
    a = -torch.linspace(1.0, 16.0, h, device=device)
    b, c = (r(1, l, sc.n_groups, sc.d_state).bfloat16() for _ in range(2))
    got = ssd_final_state(x, dt, a, b, c)
    _, want = ssd_ref(x, dt, a, b, c, return_state=True)
    rel = float((got - want).abs().max() / want.abs().max())
    log(f"  prefill state at {l} tokens, one layer (1, {h}, {sc.head_dim}, "
        f"{sc.d_state}): max |closed form - ssd_ref| / max |ssd_ref| = "
        f"{rel:.3e}")
    if not rel <= STATE_BAR:
        raise AssertionError(f"prefill state disagrees with ssd_ref: {rel}")
    return rel


def trace_requests(cfg, device="cuda", lens=None,
                   new_tokens: int = NEW_TOKENS) -> list:
    """The served trace: prompts of ``lens`` tokens (PROMPT_LENS by
    default) from a seeded generator, ``new_tokens`` new tokens each, all
    arriving at 0."""
    g = torch.Generator(device=device).manual_seed(3)
    return [Request(prompt=torch.randint(0, cfg.vocab, (n,), generator=g,
                                         device=device),
                    max_new_tokens=new_tokens, request_id=i)
            for i, n in enumerate(PROMPT_LENS if lens is None else lens)]


def meta_tree(params):
    """``params`` as meta tensors: the global tree ``serve_contract``
    reads."""
    return lm.tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                             device="meta"), params)


class StepLog:
    """Wraps an engine's steps and logs what each ran on, (SP degree,
    batch, prompt length) a prefill and (SP degree, rows) a decode step,
    for ``expected``: the sum of ``lm.serve_contract`` over them and the
    scheduler's loop turns, as {kind: [calls, bytes]}.  Under ``ep`` each
    prefill's routing is kept (``routes``, this rank's ``moe_calls``
    record), and at world size 1 its dispatch rows come from it
    (``world_one_rows``); on more ranks the caller finds them in the
    ranks' routing (``route_rows``) and hands them to ``expected``."""

    def __init__(self, eng):
        self.prefills, self.decodes, self.every_prefill = [], [], []
        self.rows, self.routes = [], []
        self.max_len = eng.max_len
        pre, dec = eng._prefill, eng._decode

        def prefill(tokens):
            self.prefills.append((eng.sp_degree, *tuple(tokens.shape)))
            self.every_prefill.append(self.prefills[-1])
            if not eng.plan.ep:
                return pre(tokens)
            with moe_calls() as calls:
                out = pre(tokens)
            self.routes.append(calls)
            if eng.sp_degree == 1 and eng.sharder.dp_size == 1:
                self.rows.append(world_one_rows(eng, calls,
                                                tokens.shape[1]))
            return out

        def decode(token, caches):
            self.decodes.append((eng.sp_degree, token.shape[0]))
            return dec(token, caches)
        eng._prefill, eng._decode = prefill, decode

    def expected(self, cfg, template, plan, ticks: int) -> dict:
        out = steps_contract(cfg, template, plan, self.prefills,
                             self.decodes, ticks, self.max_len,
                             self.rows or None)
        self.prefills, self.decodes, self.rows = [], [], []
        return out


def steps_contract(cfg, template, plan, prefills, decodes, ticks: int,
                   max_len: int, rows=None) -> dict:
    """The sum of ``lm.serve_contract`` over the prefills ((SP degree,
    batch, prompt length) each, its dispatch's ``rows`` under ``ep``), the
    decode steps ((SP degree, rows) each) and the scheduler's loop turns,
    as {kind: [calls, bytes]}."""
    rows = rows or [None] * len(prefills)
    parts = [lm.serve_contract(cfg, n, template, plan, prefill=(b, s),
                               max_len=max_len, moe_rows=r)
             for (n, b, s), r in zip(prefills, rows)]
    parts += [lm.serve_contract(cfg, n, template, plan, decode=r)
              for n, r in decodes]
    parts.append(lm.serve_contract(cfg, 1, template, plan, ticks=ticks))
    return add_contracts(*parts)


def world_one_rows(eng, calls, seq: int) -> tuple:
    """A prefill's dispatch rows under ``ep`` at world size 1 (``lm
    .collective_contract``'s ``moe_rows``): every kept pair goes to the
    one rank and comes back, so (kept, kept) over its MoE calls, each
    call's kept pairs by ``kept_pairs`` of its routing."""
    if eng.sp_degree != 1 or eng.sharder.dp_size != 1:
        raise ValueError("the rows of a prefill on more ranks follow the "
                         "ranks' routing: route_rows")
    e_phys = lm.moe_meta(eng.cfg).e_phys
    cap = lm_capacity(eng.cfg, seq)
    kept = sum(int(kept_pairs(c["experts"], e_phys, cap).sum())
               for c in calls)
    return kept, kept


def add_contracts(*parts) -> dict:
    """{kind: [calls, bytes]} summed over ``serve_contract`` results."""
    out = {}
    for c in parts:
        for k, n in c["calls"].items():
            have = out.setdefault(k, [0, 0])
            have[0] += n
            have[1] += c["bytes"][k]
    return out


def counted() -> dict:
    """{kind: [calls, bytes]} since the last ``dsp.reset_calls``, then
    reset."""
    out = {k: [dsp.calls.get(k, 0), dsp.volume.get(k, 0)]
           for k in sorted(set(dsp.calls) | set(dsp.volume))}
    dsp.reset_calls()
    return out


def full_width_serve(cfg, kernel, device="cuda", mesh=None,
                     plan=None, lens=None, new_tokens: int = NEW_TOKENS,
                     route: str = "sm90", params=None) -> dict:
    """``cfg`` at full depth behind ContinuousScheduler: 8 requests, prompts
    spread over 512-2048 tokens (or ``lens``), 32 (``new_tokens``) new
    tokens each, all arriving at 0.  K1 must launch once per attention
    layer and K2 once per SSM layer a prefill (``kernel_layers``), every
    launch on ``route``; ``launches`` and ``routes`` are ``kernel``'s (K1's
    or K2's wrapper), ``kernels`` every launching kernel's.
    With ``mesh`` (and ``plan``) the engine serves sharded, and the calls
    and bytes counted must be exactly ``lm.serve_contract``'s.  The
    weights are ``lm.init_lm(0, cfg)``'s, or ``params`` (the caller's
    last reference to them)."""
    lens = PROMPT_LENS if lens is None else lens
    t0 = time.perf_counter()
    if params is None:
        params = lm.init_lm(0, cfg, device=device)
    torch.cuda.synchronize()
    stored = sum(p.numel() for p in lm.tree_leaves(params))
    log_t(f"  init {lm.param_counts(cfg)['total'] / 1e9:.2f}B params "
          f"({stored / 1e9:.2f}B stored, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB) in "
          f"{time.perf_counter() - t0:.1f} s")
    template = meta_tree(params)
    eng = ServingEngine(params, cfg, max_len=max(lens) + new_tokens,
                        device=device, mesh=mesh, plan=plan)
    del params
    steps = StepLog(eng)
    bad = torch.zeros((), dtype=torch.long, device=device)

    def watch(step):
        def inner(*a):
            logits, caches = step(*a)
            bad.add_((~torch.isfinite(logits)).sum())
            return logits, caches
        return inner

    eng._prefill, eng._decode = watch(eng._prefill), watch(eng._decode)
    reqs = trace_requests(cfg, device, lens, new_tokens)
    sched = ContinuousScheduler(eng, max_batch=MAX_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reset_ssd_launches()
    dsp.reset_calls()
    eng.serve(reqs, continuous=True, scheduler=sched)
    torch.cuda.synchronize()
    calls = counted()
    launches = kernel.launches
    routes = dict(kernel.route_launches)
    summary = sched.metrics.summary()
    summary["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    prefills = summary["prefills"]
    log(f"  launches: {kernel.__name__} {launches} over {prefills} "
        f"prefills of {cfg.n_layers} layers, by route {routes}; "
        f"flash_attention_fwd {flash_attention_fwd.launches}, ssd_scan_fwd "
        f"{ssd_scan_fwd.launches} in all")
    if prefills != len(lens):
        raise AssertionError(f"{prefills} prefills, expected {len(lens)}")
    kernels = {}
    for k, layers in kernel_layers(cfg).items():
        got = dict(k.route_launches)
        kernels[k.__name__] = {"launches": k.launches,
                               "routes": nonzero(got)}
        if k.launches != layers * prefills or got[route] != k.launches:
            raise AssertionError(f"{k.__name__} launched {k.launches} "
                                 f"times, by route {got}; expected {layers} "
                                 f"x {len(lens)}, all on {route}")
    for r in reqs:
        if r.result is None or len(r.generated) != new_tokens:
            raise AssertionError(f"request {r.request_id} did not finish "
                                 f"with {new_tokens} tokens")
    if int(bad):
        raise AssertionError(f"{int(bad)} non-finite logits")
    if mesh is not None:
        want = steps.expected(cfg, template, eng.plan, sched.ticks)
        log(f"  torch.distributed calls [count, bytes] {calls}; "
            f"serve_contract over {prefills} prefills, "
            f"{summary['decode_steps']} decode steps and {sched.ticks} loop "
            f"turns {want}")
        if calls != want:
            raise AssertionError(f"calls {calls}, the contract says {want}")
    log_t("  metrics " + json.dumps(summary, sort_keys=True))
    del eng, sched, steps
    free_device()
    return {"launches": launches, "routes": nonzero(routes),
            "kernels": kernels, "metrics": summary,
            "tokens": [r.generated for r in reqs]}


def kernel_layers(cfg) -> dict:
    """{kernel wrapper: its launches a prefill of ``cfg``}: K1 once per
    attention layer, K2 once per SSM layer (none of a kernel the model
    does not run)."""
    mixers = [sp.mixer for sp in cfg.period_specs()] * cfg.n_periods
    out = {flash_attention_fwd: mixers.count("attn"),
           ssd_scan_fwd: mixers.count("ssm")}
    return {k: n for k, n in out.items() if n}


def free_device() -> None:
    """Give the card back what a dropped engine held: its wrapped steps
    refer to it in a cycle, which only the collector frees."""
    gc.collect()
    torch.cuda.empty_cache()


def leaf_paths(tree, path="") -> list:
    """The key paths of ``lm.tree_leaves``'s leaves, in its order."""
    if isinstance(tree, dict):
        return [q for k in tree for q in leaf_paths(tree[k], f"{path}/{k}")]
    return [path]


def loss_and_grads(params, batch, cfg, loss_fn, backend: str):
    """``loss_fn``'s loss and its grads, leaf by leaf, on ``backend``."""
    leaves = lm.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = loss_fn(leaves, batch, cfg, backend=backend)
    return loss.detach(), torch.autograd.grad(loss, lm.tree_leaves(leaves))


def grad_shares(grads, refs, paths, zero_grads=()) -> list:
    """Each leaf's max |grad - ref| / max |ref|.  A leaf whose path ends
    in one of ``zero_grads`` has a zero gradient in exact arithmetic (two
    paths' rounding noise apart): it is held against the largest |ref| of
    the whole gradient instead."""
    top = max(float(r.float().abs().max()) for r in refs)
    return [float((g.float() - r.float()).abs().max()
                  / (top if path.endswith(zero_grads) else
                     r.float().abs().max().clamp_min(1e-30)))
            for g, r, path in zip(grads, refs, paths)]


def loss_grads_gap(params, batch, cfg, loss_fn=lm.lm_loss,
                   zero_grads=()) -> dict:
    """``loss_fn`` (``lm_loss``, ``t2d_loss`` or ``encdec_loss``) and every
    gradient with the kernels against the plain path: the loss's |delta| /
    |loss|, and the worst grad leaf's ``grad_shares`` with that leaf's
    path."""
    loss_k, grads_k = loss_and_grads(params, batch, cfg, loss_fn, "kernel")
    loss_r, grads_r = loss_and_grads(params, batch, cfg, loss_fn, "ref")
    paths = leaf_paths(params)
    shares = grad_shares(grads_k, grads_r, paths, zero_grads)
    worst = int(np.argmax(shares))
    return {"loss": float(loss_r),
            "loss_rel": float((loss_k - loss_r).abs() / loss_r.abs()),
            "grad_rel": shares[worst], "leaf": paths[worst],
            "leaves": len(shares)}


def gap_passes(gap) -> bool:
    return gap["loss_rel"] <= LOSS_BAR and gap["grad_rel"] <= GRAD_BAR


def full_width_grads_check(cfg, batch_size, device="cuda") -> None:
    """Depth-2 ``cfg``, ``batch_size`` x 4096 tokens, under ``gap_passes``.
    Both backends take the backward through the same plain reference
    (``ssd_chunked_ref``, ``attention_ref``); only the forward kernel
    differs, by bf16 roundings."""
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = lm.init_lm(0, cfg2, device=device)
    batch = make_batch(DataConfig(task="lm_random", vocab=cfg.vocab,
                                  seq=TRAIN_SEQ, batch=batch_size), 0,
                       device=device)
    gap = loss_grads_gap(params, batch, cfg2)
    log(f"  depth-2 loss {gap['loss']:.6f}: |kernel - plain| / |loss| = "
        f"{gap['loss_rel']:.3e}; worst grad leaf {gap['leaf']} max |delta| "
        f"/ max |plain| = {gap['grad_rel']:.3e} over {gap['leaves']} leaves")
    if not gap_passes(gap):
        raise AssertionError(f"depth-2 loss or grads disagree: {gap}")
    del params
    torch.cuda.empty_cache()


def full_width_train(cfg, kernel, batch_size, n_steps,
                     device="cuda") -> dict:
    """``cfg``: ``n_steps`` AdamW steps of the port's Trainer at
    ``batch_size`` x 4096 tokens on lm_shift batches, under
    ``run_trainer``'s checks with every launch on the ``sm90`` route."""
    dcfg = DataConfig(task="lm_shift", vocab=cfg.vocab, seq=TRAIN_SEQ,
                      batch=batch_size)
    return run_trainer(
        lambda: lm.init_lm(0, cfg, device=device),
        lambda p, b: lm.lm_loss(p, b, cfg, backend="kernel"),
        lambda s: make_batch(dcfg, s, device=device), kernel,
        tokens=batch_size * TRAIN_SEQ, n_steps=n_steps,
        n_layers=cfg.n_layers, route="sm90", device=device)


def run_trainer(init, loss_fn, data_fn, kernel, *, tokens, n_steps,
                n_layers, route, device="cuda", mesh=None,
                launches_per_step=None, sharder=None,
                param_specs=None) -> dict:
    """``n_steps`` AdamW steps of the port's Trainer from ``init()``'s
    params, with every launch counter set to 0 just before and read just
    after.  ``kernel`` (K1's or K2's wrapper) must launch
    ``launches_per_step`` times a step (by default twice per layer: the
    forward and the checkpointed recompute; the backward goes through a
    plain reference), every launch on ``route``; every loss and grad norm
    must be finite.  Logs each step, the median step time of the steps
    after the first, ``tokens`` per step over it, and the peak device
    memory.  With ``mesh``, or the ``sharder`` of ``loss_fn`` on one (its
    ``param_specs`` the layout of ``init()``'s slices), the Trainer runs
    on it, and the ``torch.distributed`` calls of the run and their bytes
    are returned by kind; a loss with no sharder gives the layout as
    ``param_specs`` beside ``mesh``."""
    if launches_per_step is None:
        launches_per_step = 2 * n_layers
    t0 = time.perf_counter()
    params = init()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.tree_leaves(params))
    log_t(f"  init {n_params / 1e6:.1f}M params in "
          f"{time.perf_counter() - t0:.1f} s")
    trainer = Trainer(
        loss_fn=loss_fn, params=params,
        opt_cfg=OptConfig(peak_lr=3e-4, warmup_steps=2, total_steps=n_steps),
        cfg=TrainerConfig(total_steps=n_steps, log_every=1),
        data_fn=data_fn, device=device, mesh=mesh, sharder=sharder,
        param_specs=param_specs)
    del params
    steps = []
    inner = trainer.step_fn

    def timed(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        steps.append({"seconds": time.perf_counter() - t,
                      "loss": float(out[2]["loss"]),
                      "grad_norm": float(out[2]["grad_norm"]),
                      "dropped": float(out[2].get("moe_dropped", 0.0))})
        return out
    trainer.step_fn = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_ssd_launches()
    reset_launches()
    dsp.reset_calls()
    out = trainer.run()
    torch.cuda.synchronize()
    collectives, volume = dict(dsp.calls), dict(dsp.volume)
    launches = kernel.launches
    routes = dict(kernel.route_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, st in enumerate(steps):
        log_t(f"  step {i + 1}: loss {st['loss']:.6f}  grad norm "
              f"{st['grad_norm']:.6f}  {st['seconds'] * 1e3:.2f} ms")
    warm = sorted(st["seconds"] for st in steps[1:])
    step_s = warm[len(warm) // 2]
    summary = {"step_ms_first": steps[0]["seconds"] * 1e3,
               "step_ms_median": step_s * 1e3,
               "step_ms_range": [warm[0] * 1e3, warm[-1] * 1e3],
               "tokens_per_s": tokens / step_s,
               "peak_memory_gb": peak_gb,
               "losses": [st["loss"] for st in steps],
               "grad_norms": [st["grad_norm"] for st in steps],
               "dropped": [st["dropped"] for st in steps]}
    log(f"  launches: {kernel.__name__} {launches} over {n_steps} steps of "
        f"{n_layers} layers (forward + checkpointed recompute), by route "
        f"{routes}; flash_attention_fwd {flash_attention_fwd.launches} "
        f"(by head dim {nonzero(flash_attention_fwd.head_dim_launches)}), "
        f"ssd_scan_fwd {ssd_scan_fwd.launches} in all")
    log_t("  metrics " + json.dumps(summary, sort_keys=True))
    if launches != launches_per_step * n_steps:
        raise AssertionError(f"{kernel.__name__} launched {launches} times, "
                             f"expected {launches_per_step} x {n_steps}")
    if routes[route] != launches:
        raise AssertionError(f"not every training launch of "
                             f"{kernel.__name__} took the {route} route: "
                             f"{routes}")
    if len(out["history"]) != n_steps or not all(
            np.isfinite(st["loss"]) and np.isfinite(st["grad_norm"])
            for st in steps):
        raise AssertionError(f"non-finite training step: {steps}")
    del trainer
    torch.cuda.empty_cache()
    return {"launches": launches, "routes": nonzero(routes),
            "metrics": summary, "collectives": collectives, "volume": volume}


def nonzero(counts: dict) -> dict:
    return {k: n for k, n in counts.items() if n}


def by_route(runs) -> dict:
    """The launches of ``runs`` (each with its ``routes``) summed by route."""
    total = {}
    for run in runs:
        for route, n in run["routes"].items():
            total[route] = total.get(route, 0) + n
    return total


def perturb_modulation(params, seed: int):
    """Draw every block's modulation projection from seeded normals (w at
    0.5 / sqrt(d), b at 0.1), in place.  adaLN-zero's init leaves it at 0,
    which makes each block the identity and every attention and MLP
    gradient exactly 0: a kernel-against-plain check there compares
    zeros."""
    for i, kind in enumerate(("spatial", "temporal")):
        proj = params["layers"][kind]["mod"]["proj"]
        g = torch.Generator(device=proj["w"].device).manual_seed(seed + i)
        d = proj["w"].shape[-2]
        for name, scale in (("w", 0.5 / math.sqrt(d)), ("b", 0.1)):
            t = proj[name]
            t.copy_(torch.randn(t.shape, generator=g, device=t.device)
                    * scale)
    return params


def dit_batch(cfg, frames: int, step: int, device="cuda") -> dict:
    """A video batch at DIT_BATCH x ``frames`` x DIT_PATCHES, x and target
    in the model dtype."""
    dcfg = DataConfig(task="video", batch=DIT_BATCH, temporal=frames,
                      spatial=DIT_PATCHES, in_dim=cfg.in_dim)
    return t2d.model_dtype_batch(make_batch(dcfg, step, device=device), cfg)


def dit_grads_check(cfg, device="cuda") -> dict:
    """Depth-2 (one pair) ``cfg`` at DIT_CHECK_FRAMES frames, modulation
    perturbed: ``t2d_loss`` and every grad through K1 against the plain
    path, under ``gap_passes``."""
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = perturb_modulation(t2d.init_t2d(0, cfg2, device=device), 5)
    gap = loss_grads_gap(params, dit_batch(cfg, DIT_CHECK_FRAMES, 0, device),
                         cfg2, loss_fn=t2d.t2d_loss)
    log(f"  depth-2 loss {gap['loss']:.6f} at {DIT_BATCH} x "
        f"{DIT_CHECK_FRAMES} x {DIT_PATCHES}: |kernel - plain| / |loss| = "
        f"{gap['loss_rel']:.3e}; worst grad leaf {gap['leaf']} max |delta| "
        f"/ max |plain| = {gap['grad_rel']:.3e} over {gap['leaves']} leaves")
    if not gap_passes(gap):
        raise AssertionError(f"depth-2 DiT loss or grads disagree: {gap}")
    del params
    torch.cuda.empty_cache()
    return gap


def dit_train(cfg, device="cuda") -> dict:
    """``cfg`` at full depth: DIT_STEPS AdamW steps at DIT_BATCH x
    DIT_FRAMES x DIT_PATCHES, modulation perturbed, remat group
    DIT_REMAT_GROUP; every K1 launch on DIT_ROUTE at head dim 72."""
    route = ROUTES[(cfg.dtype, cfg.dh)]
    if route != DIT_ROUTE or cfg.dh != DIT_DH:
        raise AssertionError(f"the DiT's K1 route is {route} at {cfg.dh}, "
                             f"expected {DIT_ROUTE} at {DIT_DH}")
    log(f"  remat_group {DIT_REMAT_GROUP} ({cfg.n_layers // 2} pairs, "
        f"{cfg.n_layers // 2 // DIT_REMAT_GROUP} checkpointed groups)")
    trained = run_trainer(
        lambda: perturb_modulation(t2d.init_t2d(0, cfg, device=device), 6),
        lambda p, b: t2d.t2d_loss(p, b, cfg, backend="kernel",
                                  remat_group=DIT_REMAT_GROUP),
        lambda s: dit_batch(cfg, DIT_FRAMES, s, device), flash_attention_fwd,
        tokens=DIT_BATCH * DIT_FRAMES * DIT_PATCHES, n_steps=DIT_STEPS,
        n_layers=cfg.n_layers, route=DIT_ROUTE, device=device)
    dims = nonzero(flash_attention_fwd.head_dim_launches)
    if dims != {DIT_DH: trained["launches"]}:
        raise AssertionError(f"K1 launches by head dim {dims}, expected "
                             f"all at {DIT_DH}")
    return trained


def planned_a2a(cfg, n: int, *, passes: int, backward: bool) -> int:
    """All-to-alls a rank issues for ``passes`` forward passes of ``cfg``
    at DIT_BATCH x DIT_FRAMES x DIT_PATCHES over ``n`` model ranks, and one
    backward when ``backward``, from the explicit executor's accounting of
    the planned schedule."""
    ps = t2d.dsp_schedule(cfg, n, t_len=DIT_FRAMES, s_len=DIT_PATCHES,
                          batch=DIT_BATCH)
    ex = ScheduleExecutor(ps, backend="explicit")
    n_pairs = cfg.n_layers // 2
    fwd = ex.expected_collectives(n_pairs).get("all-to-all", 0)
    bwd = ex.expected_bwd_collectives(n_pairs).get("all-to-all", 0)
    return passes * fwd + (bwd if backward else 0)


def dsp_grads(cfg, mesh, device="cuda"):
    """Depth-2 (one pair) ``cfg`` at DIT_BATCH x DIT_FRAMES x DIT_PATCHES,
    modulation perturbed as phase 12's check: this rank's
    ``t2d_loss(mesh=mesh)`` and its grads, summed over the world in one
    all-reduce.  Returns (loss, [f32 grad leaves])."""
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = perturb_modulation(t2d.init_t2d(0, cfg2, device=device), 5)
    batch = t2d.shard_video_batch(dit_batch(cfg, DIT_FRAMES, 0, device), mesh)
    leaves = lm.tree_map(lambda p: p.requires_grad_(True), params)
    loss, _ = t2d.t2d_loss(leaves, batch, cfg2, backend="kernel", mesh=mesh)
    grads = iter(torch.autograd.grad(loss, lm.tree_leaves(leaves)))
    loss, grads = allreduce_grads(loss.detach(), lm.tree_map(
        lambda p: next(grads), leaves))
    return loss, lm.tree_leaves(grads)


def dsp_forward(cfg, mesh, device="cuda"):
    """``make_spmd_forward(mode="dsp")`` at full depth over phase 12's
    first batch, taken whole by every rank; returns the rank's shard."""
    params = perturb_modulation(t2d.init_t2d(0, cfg, device=device), 6)
    batch = dit_batch(cfg, DIT_FRAMES, 0, device)
    fwd = t2d.make_spmd_forward(cfg, mesh, mode="dsp", backend="kernel")
    with torch.no_grad():
        return fwd(params, batch["x"], batch["t"])


def time_switch(mesh, shape, device="cuda") -> dict:
    """One planned switch (T -> S) of the DiT's residual stream at
    ``shape`` on ``mesh``'s model group, and its parts: the all-to-all
    alone on a buffer of the same bytes, and the permute-copies a
    ``DSP_RANKS``-way switch of the same stream adds per rank (its T
    shard's S chunks moved to the front, the received chunks merged into
    T).  CUDA events, medians of 3 runs of 10."""
    g = torch.Generator(device=device).manual_seed(11)
    x = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
    flat = x.reshape(-1)
    out = torch.empty_like(flat)
    b, t, s, c = shape
    n, t_loc = DSP_RANKS, t // DSP_RANKS
    part = x[:, :t_loc]
    group = mesh.get_group("model")

    def permute():
        send = part.reshape(b, t_loc, n, s // n, c).movedim(2, 0).contiguous()
        return send.movedim(0, 1).reshape(b, t, s // n, c)

    fns = {"switch": lambda: dsp.dynamic_switch(x, 1, 2, group),
           "all_to_all": lambda: dist.all_to_all_single(
               out, flat, group=group),
           "permute_copies": permute}
    ms = {k: float(np.median([time_ms(f, iters=10, warmup=2)
                              for _ in range(3)])) for k, f in fns.items()}
    nbytes = x.numel() * x.element_size()
    log_t(f"  one switch of {tuple(shape)} bf16 ({nbytes / 1e6:.1f} MB) at "
          f"world size {dist.get_world_size()}: {ms['switch']:.4f} ms; the "
          f"all-to-all alone {ms['all_to_all']:.4f} ms "
          f"({2 * nbytes / ms['all_to_all'] / 1e6:.1f} GB/s read + "
          f"written); the permute-copies of a {DSP_RANKS}-way switch's "
          f"{tuple(part.shape)} shard {ms['permute_copies']:.4f} ms")
    return {"bytes": nbytes, **{f"{k}_ms": v for k, v in ms.items()}}


def dsp_world_of_one(cfg, phase12: dict, work: str, device="cuda") -> dict:
    """(a) Phase 12's training at world size 1 on a (1, 1) mesh over NCCL:
    the same init, batches and steps through the Trainer with the mesh.
    Every planned switch is issued (an NCCL all-to-all of one rank); the
    losses must equal phase 12's within DSP_LOSS_BAR relative, the
    all-to-alls must be exactly what the executor plans (forward,
    checkpointed recompute and backward each step), the grads take one
    all-reduce a step, and K1 launches as in phase 12.  Then the references
    of (b): the depth-2 loss and grads and the depth-28 forward on this
    path, written to ``work``."""
    backend = BACKEND_OF[torch.device(device).type]
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(work, "store1"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), torch.device(device).type)
        planned = DIT_STEPS * planned_a2a(cfg, 1, passes=2, backward=True)
        log(f"  mesh (1, 1) over {backend}; planned all-to-alls: "
            f"{DIT_STEPS} steps x (2 forward passes + 1 backward) x "
            f"{planned // DIT_STEPS // 3} = {planned}")
        trained = run_trainer(
            lambda: perturb_modulation(t2d.init_t2d(0, cfg, device=device),
                                       6),
            lambda p, b: t2d.t2d_loss(p, b, cfg, backend="kernel",
                                      remat_group=DIT_REMAT_GROUP, mesh=mesh),
            lambda st: t2d.shard_video_batch(
                dit_batch(cfg, DIT_FRAMES, st, device), mesh),
            flash_attention_fwd, tokens=DIT_BATCH * DIT_FRAMES * DIT_PATCHES,
            n_steps=DIT_STEPS, n_layers=cfg.n_layers, route=DIT_ROUTE,
            device=device, mesh=mesh)
        dims = nonzero(flash_attention_fwd.head_dim_launches)
        if dims != {cfg.dh: trained["launches"]}:
            raise AssertionError(f"K1 launches by head dim {dims}")
        calls = trained["collectives"]
        log(f"  torch.distributed calls: {calls}")
        if calls != {"all-to-all": planned, "all-reduce": DIT_STEPS}:
            raise AssertionError(f"collectives {calls}, planned "
                                 f"{planned} all-to-alls and {DIT_STEPS} "
                                 f"all-reduces")
        losses = trained["metrics"]["losses"]
        ref = phase12["metrics"]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        log_t(f"  losses {losses} against phase 12's {ref}: worst "
              f"|delta| / |loss| = {rel:.3e}; step (median) "
              f"{trained['metrics']['step_ms_median']:.2f} ms against "
              f"phase 12's {phase12['metrics']['step_ms_median']:.2f} ms")
        if not rel <= DSP_LOSS_BAR:
            raise AssertionError(f"world-1 DSP losses {losses} differ from "
                                 f"phase 12's {ref}")
        switch = time_switch(mesh, (DIT_BATCH, DIT_FRAMES, DIT_PATCHES,
                                   cfg.d_model), device)
        loss, grads = dsp_grads(cfg, mesh, device)
        torch.save({"loss": loss.cpu(), "grads": [g.cpu() for g in grads]},
                   os.path.join(work, "ref_grads.pt"))
        del grads
        torch.save(dsp_forward(cfg, mesh, device).cpu(),
                   os.path.join(work, "ref_out.pt"))
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return {**trained, "planned_a2a": planned, "switch": switch}


def dsp_rank_main(rank: int, world: int, work: str) -> None:
    """One of (b)'s ranks, started by ``dsp_four_ranks`` as ``chip_smoke.py
    --dsp-rank <rank> <world> <dir>``: gloo over the card's CUDA tensors on
    a (1, world) mesh.  Checks its depth-2 loss and grads against (a)'s,
    writes its depth-28 forward shard, and writes what it counted to
    ``<dir>/rank<rank>.json``."""
    job = json.load(open(os.path.join(work, "job.json")))
    device = job["device"]
    cfg = dataclasses.replace(
        transformer2d_720m.CONFIG, **job["cfg"],
        dtype=getattr(torch, job["dtype"].split(".")[-1]))
    full_f32()
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "store4"), world), rank=rank, world_size=world)
    try:
        mesh = make_mesh((1, world), ("data", "model"),
                         torch.device(device).type, backend="gloo")
        res = {"coord": from_mesh(mesh).sp_index}
        ref = torch.load(os.path.join(work, "ref_grads.pt"))
        for name, run in (("grads", lambda: dsp_grads(cfg, mesh, device)),
                          ("forward", lambda: dsp_forward(cfg, mesh, device))):
            reset_launches()
            dsp.reset_calls()
            t0 = time.perf_counter()
            got = run()
            if device == "cuda":
                torch.cuda.synchronize()
            res[name] = {"seconds": time.perf_counter() - t0,
                         "calls": dict(dsp.calls),
                         "k1": flash_attention_fwd.launches,
                         "k1_routes": nonzero(
                             flash_attention_fwd.route_launches)}
            if name == "grads":
                loss, grads = got
                shares = [float((g.cpu() - w).abs().max()
                                / w.abs().max().clamp_min(1e-30))
                          for g, w in zip(grads, ref["grads"])]
                res[name].update(
                    loss=float(loss), loss_rel=float(
                        (loss.cpu() - ref["loss"]).abs() / ref["loss"].abs()),
                    grad_rel=max(shares), leaves=len(shares))
                del grads
            else:
                torch.save(got.cpu(), os.path.join(work, f"out{rank}.pt"))
                res[name]["shape"] = list(got.shape)
        json.dump(res, open(os.path.join(work, f"rank{rank}.json"), "w"))
    finally:
        dist.destroy_process_group()


def dsp_four_ranks(cfg, work: str, device="cuda") -> Part:
    """(b) DSP_RANKS processes sharing the card over gloo on a (1,
    DSP_RANKS) mesh (a 4-rank NCCL group cannot be built on one card).
    Checks layouts and values, not speed: every rank's depth-2 loss and
    grads against (a)'s within phase 7's bars; the gathered depth-28
    forward against (a)'s within DSP_OUT_BAR of its largest |value|; per
    rank exactly the planned all-to-alls and K1 launches, all
    DIT_ROUTE."""
    with open(os.path.join(work, "job.json"), "w") as f:
        json.dump({"device": device, "dtype": str(cfg.dtype),
                   "cfg": {"n_layers": cfg.n_layers,
                           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                           "d_ff": cfg.d_ff, "in_dim": cfg.in_dim}}, f)
    t0 = time.perf_counter()
    rcs = yield from ranks_exit("--dsp-rank", work, timeout=900)
    log_t(f"  {DSP_RANKS} ranks exited {rcs} after "
          f"{time.perf_counter() - t0:.1f} s")
    if any(rcs):
        raise AssertionError(f"a DSP rank failed: exit codes {rcs}")
    ranks = [json.load(open(os.path.join(work, f"rank{r}.json")))
             for r in range(DSP_RANKS)]
    # depth 2: the forward, its checkpointed recompute and the backward;
    # K1 in each block's forward and recompute
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    want = {"grads": ({"all-to-all": planned_a2a(cfg2, DSP_RANKS, passes=2,
                                                 backward=True),
                       "all-reduce": 1}, 2 * cfg2.n_layers),
            "forward": ({"all-to-all": planned_a2a(cfg, DSP_RANKS, passes=1,
                                                   backward=False)},
                        cfg.n_layers)}
    log(f"  planned per rank: {want}")
    for r, res in enumerate(ranks):
        g, f = res["grads"], res["forward"]
        log_t(f"  rank {r} (gloo on {device} tensors): depth-2 loss "
              f"{g['loss']:.6f}, |delta| / |loss| against world 1 "
              f"{g['loss_rel']:.3e}, worst grad leaf {g['grad_rel']:.3e} "
              f"over {g['leaves']} leaves, in {g['seconds']:.1f} s, calls "
              f"{g['calls']}, K1 {g['k1']} {g['k1_routes']}; depth-"
              f"{cfg.n_layers} forward {f['shape']} in {f['seconds']:.1f} s, "
              f"calls {f['calls']}, K1 {f['k1']} {f['k1_routes']}")
        if not (g["loss_rel"] <= LOSS_BAR and g["grad_rel"] <= GRAD_BAR):
            raise AssertionError(f"rank {r}'s depth-2 loss or grads "
                                 f"disagree with world 1: {g}")
        for name, (calls, k1) in want.items():
            if (res[name]["calls"] != calls or res[name]["k1"] != k1
                    or res[name]["k1_routes"] != {DIT_ROUTE: k1}):
                raise AssertionError(f"rank {r} {name}: {res[name]}, "
                                     f"planned {calls} and {k1} K1 "
                                     f"launches")
    order = sorted(range(DSP_RANKS), key=lambda r: ranks[r]["coord"])
    got = torch.cat([torch.load(os.path.join(work, f"out{r}.pt"))
                     for r in order], dim=1).float()
    want = torch.load(os.path.join(work, "ref_out.pt")).float()
    rel = float((got - want).abs().max() / want.abs().max())
    log(f"  depth-{cfg.n_layers} forward, {DSP_RANKS} ranks gathered "
        f"{tuple(got.shape)} against world 1: max |delta| / max |world 1| "
        f"= {rel:.3e}")
    if not (got.shape == want.shape and torch.isfinite(got).all()
            and rel <= DSP_OUT_BAR):
        raise AssertionError(f"the {DSP_RANKS}-rank forward disagrees with "
                             f"world 1: {rel}")
    return {"ranks": ranks, "out_rel": rel}


# ---------------------------------------------------------------------------
# Phase 14: the embedded-SP baselines and DSP's overlapped switch
# ---------------------------------------------------------------------------

def sp_label(mode: str, overlap) -> str:
    return mode if overlap is None else f"{mode}+{overlap}"


def sp_meshes(world: int, device: str, backend=None) -> dict:
    """The meshes of phase 14 over ``world`` ranks: ``("data", "model")``
    of (1, world) and, for ``hybrid``, the SP grid ``make_sp2d_mesh`` of
    (2, world / 2), (1, 1) at one rank."""
    outer = 2 if world > 1 else 1
    return {"1d": make_mesh((1, world), ("data", "model"), device,
                            backend=backend),
            "2d": make_sp2d_mesh(outer, world // outer, device_type=device,
                                 backend=backend)}


def sp_mesh_of(meshes: dict, mode: str):
    return meshes["2d" if mode == "hybrid" else "1d"]


def sp_contract(cfg, mode: str, overlap, n: int, outer: int, frames: int):
    """The contract table of PERF.md §6: a rank's {kind: (calls, bytes)} in
    one forward of ``cfg`` at DIT_BATCH x ``frames`` x DIT_PATCHES over
    ``n`` SP ranks (``outer`` of them across ``sp_out`` for hybrid), the
    same in its backward (each collective's transpose; a ring's last hop
    carries blocks nothing reads, so its backward has n - 1 hops a
    stream), and K1's launches a forward.  Bytes as ``core.dsp.volume``
    counts them; M is the residual stream, kv = 2M the K + V of one
    attention (MHA, heads x head dim = d)."""
    p = cfg.n_layers // 2
    item = cfg.dtype.itemsize
    m = DIT_BATCH * frames * DIT_PATCHES * cfg.d_model * item
    kv = 2 * DIT_BATCH * frames * DIT_PATCHES * cfg.kvh * cfg.dh * item
    a2a, perm = "all-to-all", "collective-permute"
    if overlap is not None:
        fwd = {perm: (2 * (n - 1) * p, 2 * m // n * (n - 1) // n * p)}
        bwd = fwd
    elif mode == "dsp":
        fwd = bwd = {a2a: (2 * p, 2 * m // n * p)}
    elif mode in ("ulysses", "ulysses_fused"):
        k = 4 if mode == "ulysses" else 2
        fwd = bwd = {a2a: (k * p, (2 * m + kv) // n * p)}
    elif mode == "ring":
        fwd = {perm: (2 * n * p, kv * p)}
        bwd = {perm: (2 * (n - 1) * p, kv * (n - 1) // n * p)}
    elif mode == "megatron":
        fwd = bwd = {"all-gather": (4 * p, 4 * m * p),
                     "reduce-scatter": (4 * p, 4 * m * p)}
    else:
        inner = (4 * p, (2 * m + kv) // n * p)
        fwd = {a2a: inner, perm: (2 * outer * p, kv * outer // n * p)}
        bwd = {a2a: inner, perm: (2 * (outer - 1) * p,
                                  kv * (outer - 1) // n * p)}
    k1 = p if mode in ("ring", "hybrid") else 2 * p
    return fwd, bwd, k1


def sp_expected(cfg, mode: str, overlap, n: int, outer: int, frames: int, *,
                passes: int, backward: bool, bucket: int = 0):
    """A rank's {kind: [calls, bytes]} and K1 launches over ``passes``
    forward passes (the forward and the checkpointed recompute), the
    backward when ``backward``, and with ``bucket`` one all-reduce of that
    many f32 gradients (2 x its bytes)."""
    fwd, bwd, k1 = sp_contract(cfg, mode, overlap, n, outer, frames)
    out = {}
    for rows, times in ((fwd, passes), (bwd, int(backward))):
        for kind, (c, b) in rows.items():
            got = out.setdefault(kind, [0, 0])
            got[0] += c * times
            got[1] += b * times
    if bucket:
        out["all-reduce"] = [1, 2 * 4 * bucket]
    return {k: v for k, v in out.items() if v[0]}, k1 * passes


def reset_counts() -> None:
    reset_launches()
    dsp.reset_calls()


def read_counts() -> dict:
    """The run's {kind: [calls, bytes]} and K1's launches by route and by
    head dim, read after a synchronise."""
    torch.cuda.synchronize()
    return {"calls": {k: [dsp.calls.get(k, 0), dsp.volume.get(k, 0)]
                      for k in sorted(set(dsp.calls) | set(dsp.volume))},
            "k1": flash_attention_fwd.launches,
            "k1_routes": nonzero(flash_attention_fwd.route_launches),
            "k1_dims": {str(d): n for d, n in nonzero(
                flash_attention_fwd.head_dim_launches).items()}}


def check_counts(what: str, got: dict, calls: dict, k1: int) -> None:
    """``got`` (``read_counts``) must be exactly ``calls`` and ``k1``
    launches, all on DIT_ROUTE at the DiT's head dim."""
    if (got["calls"] != calls or got["k1"] != k1
            or got["k1_routes"] != ({DIT_ROUTE: k1} if k1 else {})
            or got["k1_dims"] != ({str(DIT_DH): k1} if k1 else {})):
        raise AssertionError(f"{what}: counted {got}, the contract says "
                             f"{calls} and {k1} K1 launches on {DIT_ROUTE} "
                             f"at head dim {DIT_DH}")


def sp_grads(cfg2, params2, batch, mesh, mode: str, overlap):
    """This rank's ``t2d_loss(mesh=..., mode=..., overlap=...)`` on its
    shard of ``batch`` and its grads, summed over the world in one
    all-reduce.  Returns (loss, [f32 grad leaves])."""
    local = t2d.shard_video_batch(batch, mesh)
    leaves = lm.tree_map(lambda p: p.detach().requires_grad_(True), params2)
    loss, _ = t2d.t2d_loss(leaves, local, cfg2, backend="kernel", mesh=mesh,
                           mode=mode, overlap=overlap)
    grads = iter(torch.autograd.grad(loss, lm.tree_leaves(leaves)))
    loss, grads = allreduce_grads(loss.detach(), lm.tree_map(
        lambda p: next(grads), leaves))
    return loss, lm.tree_leaves(grads)


def grads_gap(loss, grads, ref_loss, ref_grads) -> dict:
    """|loss - ref| / |ref|, and the worst leaf's max |delta| / max |ref|,
    on the device of ``grads``."""
    shares = []
    for g, w in zip(grads, ref_grads):
        w = w.to(g.device).float()
        shares.append(float((g.float() - w).abs().max()
                            / w.abs().max().clamp_min(1e-30)))
    ref_loss = ref_loss.float().to(loss.device)
    return {"loss": float(loss), "loss_rel": float(
                (loss.float() - ref_loss).abs() / ref_loss.abs()),
            "grad_rel": max(shares), "leaves": len(shares)}


def sp_world_of_one(cfg, work: str, device="cuda") -> dict:
    """(a) Each mode of SP_MODES at world size 1 over NCCL (``hybrid`` on a
    (1, 1) SP grid): the depth-2 ``t2d_loss`` and every grad at
    DIT_CHECK_FRAMES frames against plan ``none``'s plain path (phase 7's
    bars); the forward at ``cfg``'s depth (SP_DEPTH) and DIT_FRAMES
    frames against plan ``none``'s within DSP_OUT_BAR of its largest
    |value|; SP_TRAIN_STEPS Trainer steps at that depth.  Around each, the counters set to 0 just
    before and read just after: the collectives and bytes and K1's
    launches must be the contract's at n = 1.  Writes (b)'s references to
    ``work``."""
    backend = BACKEND_OF[torch.device(device).type]
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(work, "store14a"), 1), rank=0, world_size=1)
    try:
        meshes = sp_meshes(1, torch.device(device).type)
        cfg2 = dataclasses.replace(cfg, n_layers=2)
        params2 = perturb_modulation(t2d.init_t2d(0, cfg2, device=device), 5)
        batch2 = dit_batch(cfg, DIT_CHECK_FRAMES, 0, device)
        leaves = lm.tree_map(lambda p: p.detach().requires_grad_(True),
                             params2)
        ref_loss, _ = t2d.t2d_loss(leaves, batch2, cfg2, backend="ref")
        ref_grads = torch.autograd.grad(ref_loss, lm.tree_leaves(leaves))
        ref_loss = ref_loss.detach()
        del leaves
        bucket2 = sum(p.numel() for p in lm.tree_leaves(params2)) + 1
        params = perturb_modulation(t2d.init_t2d(0, cfg, device=device), 6)
        bucket = sum(p.numel() for p in lm.tree_leaves(params)) + 1
        batch = dit_batch(cfg, DIT_FRAMES, 0, device)
        with torch.no_grad():
            ref_out = t2d.forward(params, batch["x"], batch["t"], cfg,
                                  backend="kernel").float()
        torch.cuda.empty_cache()
        results = {}
        for mode, overlap in SP_MODES:
            label = sp_label(mode, overlap)
            mesh = sp_mesh_of(meshes, mode)
            log(f"  {label} on {tuple(mesh.mesh_dim_names)} "
                f"{tuple(mesh.shape)} ({elapsed()})")
            res = {}
            reset_counts()
            loss, grads = sp_grads(cfg2, params2, batch2, mesh, mode, overlap)
            got = read_counts()
            gap = grads_gap(loss, grads, ref_loss, ref_grads)
            log(f"    depth-2 loss {gap['loss']:.6f} at {DIT_BATCH} x "
                f"{DIT_CHECK_FRAMES} x {DIT_PATCHES} against plan none's "
                f"plain path: |delta| / |loss| {gap['loss_rel']:.3e}, worst "
                f"grad leaf {gap['grad_rel']:.3e} of its max over "
                f"{gap['leaves']} leaves; counted {got}")
            if not (gap["loss_rel"] <= LOSS_BAR and gap["grad_rel"]
                    <= GRAD_BAR):
                raise AssertionError(f"{label}: depth-2 loss or grads "
                                     f"disagree with plan none: {gap}")
            check_counts(f"{label} depth 2", got, *sp_expected(
                cfg2, mode, overlap, 1, 1, DIT_CHECK_FRAMES, passes=2,
                backward=True, bucket=bucket2))
            torch.save({"loss": loss.cpu(), "grads": [g.cpu() for g in grads]},
                       os.path.join(work, f"{label}.grads.pt"))
            del grads
            reset_counts()
            with torch.no_grad():
                out = t2d.make_spmd_forward(cfg, mesh, mode=mode,
                                            overlap=overlap, backend="kernel")(
                    params, batch["x"], batch["t"])
            got = read_counts()
            rel = float((out.float() - ref_out).abs().max()
                        / ref_out.abs().max())
            log(f"    depth-{cfg.n_layers} forward {tuple(out.shape)} against "
                f"plan none's: max |delta| / max |none| = {rel:.3e}; counted "
                f"{got}")
            if not (torch.isfinite(out).all() and rel <= DSP_OUT_BAR):
                raise AssertionError(f"{label}: depth-{cfg.n_layers} forward "
                                     f"disagrees with plan none: {rel}")
            check_counts(f"{label} depth {cfg.n_layers}", got, *sp_expected(
                cfg, mode, overlap, 1, 1, DIT_FRAMES, passes=1,
                backward=False))
            torch.save(out.cpu(), os.path.join(work, f"{label}.out.pt"))
            del out
            torch.cuda.empty_cache()
            per_step, k1_step = sp_expected(
                cfg, mode, overlap, 1, 1, DIT_FRAMES, passes=2, backward=True,
                bucket=bucket)
            trained = run_trainer(
                lambda: perturb_modulation(
                    t2d.init_t2d(0, cfg, device=device), 6),
                lambda p, b, mesh=mesh, mode=mode, overlap=overlap:
                    t2d.t2d_loss(p, b, cfg, backend="kernel",
                                 remat_group=DIT_REMAT_GROUP, mesh=mesh,
                                 mode=mode, overlap=overlap),
                lambda st, mesh=mesh: t2d.shard_video_batch(
                    dit_batch(cfg, DIT_FRAMES, st, device), mesh),
                flash_attention_fwd,
                tokens=DIT_BATCH * DIT_FRAMES * DIT_PATCHES,
                n_steps=SP_TRAIN_STEPS, n_layers=cfg.n_layers,
                route=DIT_ROUTE, device=device, mesh=mesh,
                launches_per_step=k1_step)
            got = {"calls": {k: [trained["collectives"].get(k, 0),
                                 trained["volume"].get(k, 0)]
                             for k in sorted(set(trained["collectives"])
                                             | set(trained["volume"]))},
                   "k1": trained["launches"], "k1_routes": nonzero(
                       flash_attention_fwd.route_launches),
                   "k1_dims": {str(d): n for d, n in nonzero(
                       flash_attention_fwd.head_dim_launches).items()}}
            want = {k: [c * SP_TRAIN_STEPS, b * SP_TRAIN_STEPS]
                    for k, (c, b) in per_step.items()}
            check_counts(f"{label} training", got, want,
                         k1_step * SP_TRAIN_STEPS)
            step_ms = trained["metrics"]["step_ms_median"]
            log_t(f"    {label}: step 2 of {SP_TRAIN_STEPS} at depth "
                  f"{cfg.n_layers} {step_ms:.2f} ms (one step: ranks "
                  f"nothing); counted {got}")
            res.update(gap=gap, out_rel=rel, step_ms=step_ms,
                       launches=trained["launches"],
                       routes=trained["routes"],
                       peak_memory_gb=trained["metrics"]["peak_memory_gb"])
            results[label] = res
        del params, params2, ref_grads, ref_out
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return {"modes": results, "bucket2": bucket2}


def sp_rank_main(rank: int, world: int, work: str) -> None:
    """One of (b)'s ranks, started by ``sp_four_ranks`` as ``chip_smoke.py
    --sp-rank <rank> <world> <dir>``: gloo over the card's CUDA tensors.
    For each mode of SP_MODES, its depth-2 loss and grads against (a)'s,
    its SP_DEPTH forward shard written to ``<dir>``, and what it counted
    around each, to ``<dir>/sp_rank<rank>.json``."""
    job = json.load(open(os.path.join(work, "job14.json")))
    device = job["device"]
    cfg = dataclasses.replace(
        transformer2d_720m.CONFIG, **job["cfg"],
        dtype=getattr(torch, job["dtype"].split(".")[-1]))
    full_f32()
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "store14b"), world), rank=rank, world_size=world)
    try:
        meshes = sp_meshes(world, torch.device(device).type, backend="gloo")
        cfg2 = dataclasses.replace(cfg, n_layers=2)
        params2 = perturb_modulation(t2d.init_t2d(0, cfg2, device=device), 5)
        batch2 = dit_batch(cfg, DIT_CHECK_FRAMES, 0, device)
        params = perturb_modulation(t2d.init_t2d(0, cfg, device=device), 6)
        batch = dit_batch(cfg, DIT_FRAMES, 0, device)
        results = {}
        for mode, overlap in SP_MODES:
            label = sp_label(mode, overlap)
            mesh = sp_mesh_of(meshes, mode)
            ref = torch.load(os.path.join(work, f"{label}.grads.pt"))
            res = {"coord": from_mesh(mesh).sp_index}
            reset_counts()
            t0 = time.perf_counter()
            loss, grads = sp_grads(cfg2, params2, batch2, mesh, mode, overlap)
            res["grads"] = {**read_counts(), **grads_gap(
                loss, grads, ref["loss"], ref["grads"]),
                "seconds": time.perf_counter() - t0}
            del grads, ref
            reset_counts()
            t0 = time.perf_counter()
            with torch.no_grad():
                out = t2d.make_spmd_forward(cfg, mesh, mode=mode,
                                            overlap=overlap, backend="kernel")(
                    params, batch["x"], batch["t"])
            res["forward"] = {**read_counts(), "shape": list(out.shape),
                              "seconds": time.perf_counter() - t0}
            torch.save(out.cpu(), os.path.join(work, f"{label}.out{rank}.pt"))
            del out
            results[label] = res
        json.dump(results, open(os.path.join(work, f"sp_rank{rank}.json"),
                                "w"))
    finally:
        dist.destroy_process_group()


def sp_four_ranks(cfg, bucket2: int, work: str, device="cuda") -> Part:
    """(b) DSP_RANKS processes sharing the card over gloo, each mode on a
    (1, DSP_RANKS) mesh (``hybrid`` on the (2, DSP_RANKS / 2) SP grid).
    Checks layouts and values, not speed: every rank's depth-2 loss and
    grads against (a)'s within phase 7's bars; the gathered SP_DEPTH
    forward against (a)'s within DSP_OUT_BAR of its largest |value|; per
    rank exactly the contract's collectives, bytes and K1 launches.  Logs
    each mode's bytes per rank beside ``per_device_bytes``: Table 3 at n =
    DSP_RANKS.  ``bucket2`` is the depth-2 model's gradient count, plus
    one for the loss, that the grads' all-reduce sums."""
    with open(os.path.join(work, "job14.json"), "w") as f:
        json.dump({"device": device, "dtype": str(cfg.dtype),
                   "cfg": {"n_layers": cfg.n_layers,
                           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                           "d_ff": cfg.d_ff, "in_dim": cfg.in_dim}}, f)
    t0 = time.perf_counter()
    rcs = yield from ranks_exit("--sp-rank", work, timeout=900)
    log_t(f"  {DSP_RANKS} ranks exited {rcs} after "
          f"{time.perf_counter() - t0:.1f} s")
    if any(rcs):
        raise AssertionError(f"an SP rank failed: exit codes {rcs}")
    ranks = [json.load(open(os.path.join(work, f"sp_rank{r}.json")))
             for r in range(DSP_RANKS)]
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    n, p = DSP_RANKS, cfg.n_layers // 2
    m = DIT_BATCH * DIT_FRAMES * DIT_PATCHES * cfg.d_model * cfg.dtype.itemsize
    table = {}
    for mode, overlap in SP_MODES:
        label = sp_label(mode, overlap)
        outer = 2 if mode == "hybrid" else 1
        want_g = sp_expected(cfg2, mode, overlap, n, outer, DIT_CHECK_FRAMES,
                             passes=2, backward=True, bucket=bucket2)
        want_f = sp_expected(cfg, mode, overlap, n, outer, DIT_FRAMES,
                             passes=1, backward=False)
        for r, rank in enumerate(ranks):
            g, f = rank[label]["grads"], rank[label]["forward"]
            log_t(f"  {label} rank {r} (gloo on {device} tensors): depth-2 "
                  f"|delta loss| / |loss| against world 1 {g['loss_rel']:.3e},"
                  f" worst grad leaf {g['grad_rel']:.3e} in "
                  f"{g['seconds']:.1f} s, counted {g['calls']} K1 {g['k1']};"
                  f" depth-{cfg.n_layers} forward {f['shape']} in "
                  f"{f['seconds']:.1f} s, counted {f['calls']} K1 {f['k1']}")
            if not (g["loss_rel"] <= LOSS_BAR and g["grad_rel"] <= GRAD_BAR):
                raise AssertionError(f"{label} rank {r}: depth-2 loss or "
                                     f"grads disagree with world 1: {g}")
            check_counts(f"{label} rank {r} depth 2", g, *want_g)
            check_counts(f"{label} rank {r} depth {cfg.n_layers}", f,
                         *want_f)
        order = sorted(range(n), key=lambda r: ranks[r][label]["coord"])
        got = torch.cat([torch.load(os.path.join(work, f"{label}.out{r}.pt"))
                         for r in order], dim=1).float()
        want = torch.load(os.path.join(work, f"{label}.out.pt")).float()
        rel = float((got - want).abs().max() / want.abs().max())
        strategy = "ulysses" if mode == "ulysses_fused" else mode
        stages = 2 * p if mode == "megatron" else p
        analytic = stages * dsp.per_device_bytes(strategy, m, n, outer=outer)
        if overlap is not None:
            analytic = analytic * (n - 1) / n
        moved = sum(b for _, b in ranks[0][label]["forward"]["calls"].values())
        table[label] = {"bytes": moved, "analytic": analytic, "out_rel": rel}
        log(f"  {label}: depth-{cfg.n_layers} forward, {n} ranks gathered "
            f"{tuple(got.shape)} against world 1: max |delta| / max |world "
            f"1| = {rel:.3e}; bytes per rank {moved} against "
            f"per_device_bytes {analytic:.0f} ({moved / analytic:.2f})")
        if not (got.shape == want.shape and torch.isfinite(got).all()
                and rel <= DSP_OUT_BAR):
            raise AssertionError(f"{label}: the {n}-rank forward disagrees "
                                 f"with world 1: {rel}")
        if moved != analytic:
            raise AssertionError(f"{label}: {moved} bytes per rank, "
                                 f"per_device_bytes says {analytic}")
    log(f"  Table 3 at n = {n}, bytes per rank of one depth-{cfg.n_layers} "
        f"forward: " + json.dumps({k: v["bytes"] for k, v in table.items()}))
    return table


# ---------------------------------------------------------------------------
# Phase 15: the DiT on dim pairs (forward2d over the ("sp_out", "sp_in") grid)
# ---------------------------------------------------------------------------

def l2d_plan(cfg, grid, frames: int) -> dict:
    """The 2D plan of ``cfg`` at DIT_BATCH x ``frames`` x DIT_PATCHES on
    ``grid``: its layouts, the all-to-alls a rank issues in one forward
    (the executor's ``expected_carry_collectives``) and the planned bytes
    per rank (``Schedule2D.per_device_bytes``)."""
    ps = t2d.dsp2d_schedule(cfg, grid, t_len=frames, s_len=DIT_PATCHES,
                            batch=DIT_BATCH)
    calls = ScheduleExecutor2D(ps, backend="null") \
        .expected_carry_collectives(cfg.n_layers // 2)
    return {"layouts": [list(lo) for lo in ps.layouts], "calls": calls,
            "planned_bytes": ps.schedule.per_device_bytes()}


def check_l2d_counts(what: str, got: dict, plan: dict, k1: int) -> None:
    """``got`` (``read_counts``) must hold exactly the plan's collectives
    (the calls; their bytes are logged) and ``k1`` K1 launches, all on
    DIT_ROUTE at the DiT's head dim."""
    calls = {k: c for k, (c, _) in got["calls"].items()}
    if (calls != plan["calls"] or got["k1"] != k1
            or got["k1_routes"] != {DIT_ROUTE: k1}
            or got["k1_dims"] != {str(DIT_DH): k1}):
        raise AssertionError(f"{what}: counted {got}, the plan says "
                             f"{plan['calls']} and {k1} K1 launches on "
                             f"{DIT_ROUTE} at head dim {DIT_DH}")


def l2d_forward(cfg, params, batch, mesh):
    """``make_spmd_forward2d`` on ``batch`` (whole on every rank), no
    grad: the rank's shard at the plan's final layout."""
    with torch.no_grad():
        return t2d.make_spmd_forward2d(cfg, mesh, backend="kernel")(
            params, batch["x"], batch["t"])


def l2d_label(grid, frames: int) -> str:
    return f"{grid[0]}x{grid[1]}@{frames}"


def l2d_ref_file(frames: int) -> str:
    return f"l2d_out.{frames}.pt"


def l2d_world_of_one(cfg, work: str, device="cuda") -> dict:
    """(a) ``forward2d`` at world size 1 over NCCL on the (1, 1) grid:
    at depth 2 (DIT_CHECK_FRAMES frames) and at depth 28 (DIT_FRAMES)
    against plan ``none``'s ``forward`` within DSP_OUT_BAR of its largest
    |value|; around each the counters set to 0 just before and read just
    after, which must hold exactly the planned all-to-alls and one K1
    launch a block, all on DIT_ROUTE.  Then the depth-28 forward and plan
    ``none``'s timed in L2D_TURNS (medians).  Writes (b)'s references to
    ``work``: the depth-28 output, and plan ``none``'s depth-28 forward at
    L2D_HEAD_FRAMES frames."""
    backend = BACKEND_OF[torch.device(device).type]
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(work, "store15a"), 1), rank=0, world_size=1)
    try:
        mesh = make_sp2d_mesh(1, 1, device_type=torch.device(device).type)
        runs = {}
        for depth, frames in ((2, DIT_CHECK_FRAMES),
                              (cfg.n_layers, DIT_FRAMES)):
            dcfg = dataclasses.replace(cfg, n_layers=depth)
            params = perturb_modulation(t2d.init_t2d(0, dcfg, device=device),
                                        6)
            batch = dit_batch(cfg, frames, 0, device)
            with torch.no_grad():
                ref = t2d.forward(params, batch["x"], batch["t"], dcfg,
                                  backend="kernel").float()
            plan = l2d_plan(dcfg, (1, 1), frames)
            reset_counts()
            out = l2d_forward(dcfg, params, batch, mesh)
            got = read_counts()
            rel = float((out.float() - ref).abs().max() / ref.abs().max())
            log(f"  depth {depth} at {DIT_BATCH} x {frames} x {DIT_PATCHES}, "
                f"plan {plan['layouts']}: forward2d {tuple(out.shape)} "
                f"against plan none's forward: max |delta| / max |none| = "
                f"{rel:.3e}; counted {got}; bytes per rank "
                f"{sum(b for _, b in got['calls'].values())} against "
                f"per_device_bytes {plan['planned_bytes']:.0f}")
            if not (out.shape == ref.shape and torch.isfinite(out).all()
                    and rel <= DSP_OUT_BAR):
                raise AssertionError(f"depth-{depth} forward2d disagrees "
                                     f"with plan none: {rel}")
            check_l2d_counts(f"forward2d depth {depth}", got, plan, depth)
            runs[depth] = {"out_rel": rel, "calls": got["calls"],
                           "launches": got["k1"], "routes": got["k1_routes"]}
        torch.save(out.cpu(), os.path.join(work, l2d_ref_file(DIT_FRAMES)))
        del out, ref
        heads = dit_batch(cfg, L2D_HEAD_FRAMES, 0, device)
        with torch.no_grad():
            torch.save(t2d.forward(params, heads["x"], heads["t"], cfg,
                                   backend="kernel").cpu(),
                       os.path.join(work, l2d_ref_file(L2D_HEAD_FRAMES)))
        fns = {"2d": lambda: l2d_forward(cfg, params, batch, mesh),
               "none": lambda: t2d.forward(params, batch["x"], batch["t"],
                                           cfg, backend="kernel")}
        turns = {k: [] for k in fns}
        with torch.no_grad():
            for who in L2D_TURNS:
                turns[who].append(time_ms(fns[who], iters=1, warmup=0))
        ms = {k: float(np.median(v)) for k, v in turns.items()}
        log_t(f"  depth-{cfg.n_layers} forward at {DIT_BATCH} x {DIT_FRAMES} "
              f"x {DIT_PATCHES}, in turns: forward2d (1, 1) runs "
              f"{turns['2d']}, median {ms['2d']:.2f} ms; plan none runs "
              f"{turns['none']}, median {ms['none']:.2f} ms "
              f"({100 * (ms['2d'] / ms['none'] - 1):+.2f}%)")
        del params
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    top = runs[cfg.n_layers]
    return {"depths": runs, "ms": ms, "turns": turns,
            "launches": top["launches"], "routes": top["routes"]}


def l2d_rank_main(rank: int, world: int, work: str) -> None:
    """One of (b)'s ranks, started by ``l2d_four_ranks`` as ``chip_smoke.py
    --l2d-rank <rank> <world> <dir>``: gloo over the card's CUDA tensors.
    At each (grid, frames) of L2D_CASES, the depth-28 ``forward2d`` shard
    written to ``<dir>`` and what it counted around it, to
    ``<dir>/l2d_rank<r>.json``."""
    job = json.load(open(os.path.join(work, "job15.json")))
    device = job["device"]
    cfg = dataclasses.replace(
        transformer2d_720m.CONFIG, **job["cfg"],
        dtype=getattr(torch, job["dtype"].split(".")[-1]))
    full_f32()
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "store15b"), world), rank=rank, world_size=world)
    try:
        params = perturb_modulation(t2d.init_t2d(0, cfg, device=device), 6)
        results = {}
        for grid, frames in L2D_CASES:
            batch = dit_batch(cfg, frames, 0, device)
            mesh = make_sp2d_mesh(*grid, device_type=torch.device(device).type,
                                  backend="gloo")
            ctx = from_mesh(mesh)
            reset_counts()
            t0 = time.perf_counter()
            out = l2d_forward(cfg, params, batch, mesh)
            got = read_counts()
            label = l2d_label(grid, frames)
            results[label] = {**got, "shape": list(out.shape),
                              "seconds": time.perf_counter() - t0,
                              "coord": [ctx.index("sp_out"),
                                        ctx.index("sp_in")]}
            torch.save(out.cpu(), os.path.join(work, f"l2d.{label}.{rank}.pt"))
            del out
        json.dump(results, open(os.path.join(work, f"l2d_rank{rank}.json"),
                                "w"))
    finally:
        dist.destroy_process_group()


def l2d_four_ranks(cfg, work: str, device="cuda") -> Part:
    """(b) DSP_RANKS processes sharing the card over gloo, at each (grid,
    frames) of L2D_CASES: the gathered depth-28 forward2d against (a)'s
    reference at those frames within DSP_OUT_BAR of its largest |value|;
    per rank exactly the planned all-to-alls and one K1 launch a block,
    all on DIT_ROUTE; each rank's bytes (``core.dsp.volume``) logged
    beside ``per_device_bytes``.  The case at L2D_HEAD_FRAMES fails unless
    its plan shards heads in a core."""
    with open(os.path.join(work, "job15.json"), "w") as f:
        json.dump({"device": device, "dtype": str(cfg.dtype),
                   "cfg": {"n_layers": cfg.n_layers,
                           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                           "d_ff": cfg.d_ff, "in_dim": cfg.in_dim}}, f)
    t0 = time.perf_counter()
    rcs = yield from ranks_exit("--l2d-rank", work)
    log_t(f"  {DSP_RANKS} ranks exited {rcs} after "
          f"{time.perf_counter() - t0:.1f} s")
    if any(rcs):
        raise AssertionError(f"a dim-pair rank failed: exit codes {rcs}")
    ranks = [json.load(open(os.path.join(work, f"l2d_rank{r}.json")))
             for r in range(DSP_RANKS)]
    table = {}
    for grid, frames in L2D_CASES:
        label = l2d_label(grid, frames)
        want = torch.load(os.path.join(work, l2d_ref_file(frames))).float()
        plan = l2d_plan(cfg, grid, frames)
        by_head = [lo for lo in plan["layouts"] if 3 in lo]
        log(f"  grid {grid} at {DIT_BATCH} x {frames} x {DIT_PATCHES}: plan "
            f"{plan['layouts']} (head-sharded cores {by_head}), per rank "
            f"{plan['calls']}, per_device_bytes {plan['planned_bytes']:.0f}")
        if frames == L2D_HEAD_FRAMES and not by_head:
            raise AssertionError(f"grid {grid} at {frames} frames: the plan "
                                 f"{plan['layouts']} shards no heads")
        shards = [[None] * grid[1] for _ in range(grid[0])]
        for r, rank in enumerate(ranks):
            res = rank[label]
            moved = sum(b for _, b in res["calls"].values())
            log_t(f"    rank {r} at {tuple(res['coord'])} (gloo on {device} "
                  f"tensors): forward2d {res['shape']} in "
                  f"{res['seconds']:.1f} s, counted {res['calls']}, K1 "
                  f"{res['k1']} {res['k1_routes']}; bytes {moved} against "
                  f"per_device_bytes {plan['planned_bytes']:.0f} "
                  f"({moved / plan['planned_bytes']:.4f})")
            check_l2d_counts(f"{label} rank {r}", res, plan, cfg.n_layers)
            a, b = res["coord"]
            shards[a][b] = torch.load(os.path.join(work,
                                                   f"l2d.{label}.{r}.pt"))
        # the final layout (1, 2): T over sp_out, S over sp_in
        got = torch.cat([torch.cat(row, dim=2) for row in shards],
                        dim=1).float()
        rel = float((got - want).abs().max() / want.abs().max())
        log(f"  grid {grid} at {frames} frames: depth-{cfg.n_layers} "
            f"forward2d, {DSP_RANKS} ranks gathered {tuple(got.shape)} "
            f"against world 1: max "
            f"|delta| / max |world 1| = {rel:.3e}")
        if not (got.shape == want.shape and torch.isfinite(got).all()
                and rel <= DSP_OUT_BAR):
            raise AssertionError(f"{label}: the {DSP_RANKS}-rank "
                                 f"forward2d disagrees with world 1: {rel}")
        table[label] = {"out_rel": rel, "bytes": [
            sum(b for _, b in rank[label]["calls"].values())
            for rank in ranks], "planned_bytes": plan["planned_bytes"],
            "k1": [rank[label]["k1"] for rank in ranks]}
    return table


# ---------------------------------------------------------------------------
# Phase 16: the LM family under DSP (the Sharder's hooks on a process mesh)
# ---------------------------------------------------------------------------

def lm_config(name: str, depth=None):
    cfg = {"qwen3-14b": qwen3_14b.CONFIG,
           "mamba2-370m": mamba2_370m.CONFIG}[name]
    return cfg if depth is None else dataclasses.replace(cfg, n_layers=depth)


def lm_sharder(cfg, mesh, batch: int):
    """LM_PLAN on ``mesh`` with the joint planned schedule of ``cfg`` at
    ``batch`` x TRAIN_SEQ tokens."""
    n = from_mesh(mesh).sp_size
    return make_sharder(mesh, LM_PLAN, schedule=lm.dsp_schedule(
        cfg, n, seq=TRAIN_SEQ, batch=batch, joint=True))


def lm_contract(cfg, n: int, batch: int) -> dict:
    """{kind: [calls, bytes]} of one loss and its grads with remat per
    rank of a (1, ``n``) mesh at ``batch`` x TRAIN_SEQ tokens:
    ``lm.remat_step`` of ``lm.collective_contract``."""
    step = lm.remat_step(lm.collective_contract(cfg, n, batch,
                                                TRAIN_SEQ // n))
    return {k: [step["calls"][k], step["bytes"][k]]
            for k in sorted(step["calls"])}


def lm_batch(cfg, batch: int, step: int, device="cuda") -> dict:
    return make_batch(DataConfig(task="lm_shift", vocab=cfg.vocab,
                                 seq=TRAIN_SEQ, batch=batch), step,
                      device=device)


def lm_grads(cfg, sharder, device="cuda"):
    """Depth-cut ``cfg``'s ``lm_loss(sharder=)`` on this rank's shard of
    the first 1 x TRAIN_SEQ batch and its grads (this rank's share of the
    global ones), K1 and K2 through their kernels.  Returns (loss, grads,
    their leaf paths)."""
    params = lm.init_lm(0, cfg, device=device)
    leaves = lm.tree_map(lambda p: p.requires_grad_(True), params)
    batch = lm.shard_lm_batch(lm_batch(cfg, 1, 0, device), sharder)
    loss, _ = lm.lm_loss(leaves, batch, cfg, sharder=sharder,
                         backend="kernel")
    grads = torch.autograd.grad(loss, lm.tree_leaves(leaves))
    return loss.detach(), list(grads), leaf_paths(params)


def lm_world_of_one(refs: dict, work: str, device="cuda") -> dict:
    """(a) At world size 1 on a (1, 1) mesh over NCCL: phase 10's training
    (qwen3-14b at depth QWEN_TRAIN_DEPTH, QWEN_TRAIN_STEPS steps at 1 x
    TRAIN_SEQ) and phase 7's first LM_MAMBA_STEPS steps (mamba2-370m at
    depth 48, TRAIN_BATCH x TRAIN_SEQ), each with the sharder of LM_PLAN
    and the joint planned schedule through the Trainer with the mesh.
    Every hook's switch and gather is issued (a collective of one rank);
    the losses must equal the plan-none phase's within DSP_LOSS_BAR, the
    calls and bytes must be exactly ``lm_contract`` each step plus one
    all-reduce, and K1 (K2) must launch as in phase 10 (7), all on
    ``sm90``.  Then the references of (b): the depth-cut loss and grads of
    LM_RANK_DEPTHS on this path, written to ``work``."""
    backend = BACKEND_OF[torch.device(device).type]
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(work, "store16a"), 1), rank=0, world_size=1)
    out = {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"), torch.device(device).type)
        runs = (("qwen3-14b", QWEN_TRAIN_DEPTH, QWEN_TRAIN_BATCH,
                 QWEN_TRAIN_STEPS, flash_attention_fwd),
                ("mamba2-370m", None, TRAIN_BATCH, LM_MAMBA_STEPS,
                 ssd_scan_fwd))
        for name, depth, batch, steps, kernel in runs:
            cfg = lm_config(name, depth)
            sharder = lm_sharder(cfg, mesh, batch)
            step = lm_contract(cfg, 1, batch)
            want = {k: [c * steps, b * steps] for k, (c, b) in step.items()}
            log(f"  {name} depth {cfg.n_layers}, {batch} x {TRAIN_SEQ}, "
                f"{steps} steps; per step the contract {step} and one "
                f"all-reduce")
            trained = run_trainer(
                lambda: lm.init_lm(0, cfg, device=device),
                lambda p, b: lm.lm_loss(p, b, cfg, sharder=sharder,
                                        backend="kernel"),
                lambda st: lm.shard_lm_batch(lm_batch(cfg, batch, st,
                                                      device), sharder),
                kernel, tokens=batch * TRAIN_SEQ, n_steps=steps,
                n_layers=cfg.n_layers, route="sm90", device=device,
                mesh=mesh)
            got = {k: [trained["collectives"][k], trained["volume"][k]]
                   for k in sorted(trained["collectives"])}
            reduced = got.pop("all-reduce", [0, 0])
            log(f"  torch.distributed calls [count, bytes]: {got}, "
                f"all-reduce {reduced}")
            if got != want or reduced[0] != steps:
                raise AssertionError(f"{name}: collectives {got} and "
                                     f"all-reduce {reduced}, the contract "
                                     f"says {want} and {steps}")
            ref = refs[name]["metrics"]
            losses = trained["metrics"]["losses"]
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(losses, ref["losses"]))
            log_t(f"  losses {losses} against plan none's "
                  f"{ref['losses'][:steps]}: worst |delta| / |loss| = "
                  f"{rel:.3e}; step (median) "
                  f"{trained['metrics']['step_ms_median']:.2f} ms against "
                  f"plan none's {ref['step_ms_median']:.2f} ms")
            if not rel <= DSP_LOSS_BAR:
                raise AssertionError(f"{name}: world-1 DSP losses {losses} "
                                     f"differ from plan none's")
            out[name] = trained
        for name, depth in LM_RANK_DEPTHS:
            cfg = lm_config(name, depth)
            loss, grads, _ = lm_grads(cfg, lm_sharder(cfg, mesh, 1), device)
            torch.save({"loss": loss.cpu(), "grads": [g.cpu() for g in grads]},
                       os.path.join(work, f"lm_ref.{name}.pt"))
            del grads
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def lm_rank_main(rank: int, world: int, work: str) -> None:
    """One of (b)'s ranks, started by ``lm_four_ranks`` as ``chip_smoke.py
    --lm-rank <rank> <world> <dir>``: gloo over the card's CUDA tensors on
    a (1, world) mesh.  For each of LM_RANK_DEPTHS: its loss and grads
    with what it counted around them, then the loss and each grad leaf
    summed over the ranks (f32 pieces, not counted) and, on rank 0, held
    against (a)'s reference leaf by leaf; written to
    ``<dir>/lm_rank<r>.json``."""
    device = json.load(open(os.path.join(work, "job16.json")))["device"]
    full_f32()
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "store16b"), world), rank=rank, world_size=world)
    try:
        mesh = make_mesh((1, world), ("data", "model"),
                         torch.device(device).type, backend="gloo")
        res = {"coord": from_mesh(mesh).sp_index}
        for name, depth in LM_RANK_DEPTHS:
            cfg = lm_config(name, depth)
            sharder = lm_sharder(cfg, mesh, 1)
            reset_counts()
            reset_ssd_launches()
            t0 = time.perf_counter()
            loss, grads, paths = lm_grads(cfg, sharder, device)
            got = read_counts()
            got.update(
                seconds=time.perf_counter() - t0,
                k1_heads={f"{q}/{kv}": n for (q, kv), n in
                          flash_attention_fwd.heads_launches.items()},
                k2=ssd_scan_fwd.launches,
                k2_routes=nonzero(ssd_scan_fwd.route_launches),
                k2_heads={str(h): n for h, n in
                          ssd_scan_fwd.heads_launches.items()})
            dist.all_reduce(loss)
            ref = (torch.load(os.path.join(work, f"lm_ref.{name}.pt"),
                              mmap=True) if rank == 0 else None)
            shares = []
            for i, g in enumerate(grads):
                total = g.float().reshape(-1)
                for piece in total.split(LM_REDUCE_PIECE):
                    dist.all_reduce(piece)
                if rank == 0:
                    w = ref["grads"][i].to(device).float().reshape(-1)
                    shares.append(float((total - w).abs().max()
                                        / w.abs().max().clamp_min(1e-30)))
                grads[i] = None
                del total
            if rank == 0:
                worst = int(np.argmax(shares))
                got.update(loss=float(loss), loss_rel=float(
                    (loss.cpu() - ref["loss"]).abs() / ref["loss"].abs()),
                    grad_rel=shares[worst], leaves=len(shares),
                    leaf=paths[worst])
            res[name] = got
            del grads, ref
            torch.cuda.empty_cache()
        json.dump(res, open(os.path.join(work, f"lm_rank{rank}.json"), "w"))
    finally:
        dist.destroy_process_group()


def lm_four_ranks(work: str, device="cuda") -> Part:
    """(b) DSP_RANKS processes sharing the card over gloo on a (1,
    DSP_RANKS) mesh, each LM of LM_RANK_DEPTHS at full width, 1 x
    TRAIN_SEQ tokens: the loss and every grad leaf summed over the ranks
    against (a)'s within phase 7's bars; per rank exactly the contract's
    calls and bytes (``lm_contract``), and K1 (K2) launched twice a layer
    (forward and recompute) on the rank's heads (qwen3-14b: 10 of 40 q
    and 2 of 8 K/V heads; mamba2-370m: 8 of 32), all on ``sm90``."""
    with open(os.path.join(work, "job16.json"), "w") as f:
        json.dump({"device": device}, f)
    t0 = time.perf_counter()
    rcs = yield from ranks_exit("--lm-rank", work)
    log_t(f"  {DSP_RANKS} ranks exited {rcs} after "
          f"{time.perf_counter() - t0:.1f} s")
    if any(rcs):
        raise AssertionError(f"an LM rank failed: exit codes {rcs}")
    ranks = [json.load(open(os.path.join(work, f"lm_rank{r}.json")))
             for r in range(DSP_RANKS)]
    n = DSP_RANKS
    for name, depth in LM_RANK_DEPTHS:
        cfg = lm_config(name, depth)
        want = lm_contract(cfg, n, 1)
        if name == "qwen3-14b":
            heads = {"k1": 2 * depth, "k1_heads": {
                f"{cfg.n_heads // n}/{cfg.n_kv_heads // n}": 2 * depth},
                "k2": 0, "k2_heads": {}}
        else:
            heads = {"k1": 0, "k1_heads": {}, "k2": 2 * depth, "k2_heads": {
                str(cfg.ssm_cfg.n_heads // n): 2 * depth}}
        g = ranks[0][name]
        log_t(f"  {name} depth {depth}: loss {g['loss']:.6f} summed over "
              f"{DSP_RANKS} ranks, |delta| / |loss| against world 1 "
              f"{g['loss_rel']:.3e}, worst grad leaf {g['leaf']} "
              f"{g['grad_rel']:.3e} over {g['leaves']} leaves")
        if not (g["loss_rel"] <= LOSS_BAR and g["grad_rel"] <= GRAD_BAR):
            raise AssertionError(f"{name}: the {DSP_RANKS}-rank loss or "
                                 f"grads disagree with world 1: {g}")
        log(f"  {name}: per rank the contract {want}, {heads}")
        for r, res in enumerate(ranks):
            got = res[name]
            log_t(f"  rank {r} (sequence chunk {res['coord']}): "
                  f"{got['seconds']:.1f} s, calls {got['calls']}, K1 "
                  f"{got['k1_heads']} {got['k1_routes']}, K2 "
                  f"{got['k2_heads']} {got['k2_routes']}")
            routes_ok = (got["k1_routes"] == ({"sm90": heads["k1"]}
                                              if heads["k1"] else {})
                         and got["k2_routes"] == ({"sm90": heads["k2"]}
                                                  if heads["k2"] else {}))
            if (got["calls"] != want or not routes_ok
                    or any(got[k] != v for k, v in heads.items())):
                raise AssertionError(f"rank {r} {name}: {got}, the contract "
                                     f"says {want} and {heads}")
    return {"ranks": ranks}


# ---------------------------------------------------------------------------
# Phase 17: the LM family under its specs' own plans (ZeRO-3, the vocab ring)
# ---------------------------------------------------------------------------

def zero_layout(name: str, cfg, mesh, batch: int, device="cuda") -> dict:
    """``cfg``'s parameters from seed 0 under the spec's own plan on
    ``mesh``: the whole tree laid out by ``param_pspecs`` and cut to this
    rank's slices (``shard_params``), the sharder of the joint planned
    schedule at ``batch`` x TRAIN_SEQ tokens, and the step's contract
    (``zero_contract``)."""
    plan = {"qwen3-14b": qwen3_14b.SPEC.plan,
            "mamba2-370m": mamba2_370m.SPEC.plan}[name]
    ctx = from_mesh(mesh)
    sizes = mesh_sizes(ctx)
    params = lm.init_lm(0, cfg, device=device)
    specs = param_pspecs(params, plan, axis_sizes=sizes)
    contract = zero_contract(cfg, (ctx.dp_size, ctx.sp_size), batch,
                             lm.param_contract(cfg, params, plan, sizes))
    sharder = make_sharder(mesh, plan, schedule=lm.dsp_schedule(
        cfg, ctx.sp_size, seq=TRAIN_SEQ, batch=batch, joint=True),
        param_specs=specs)
    return {"params": shard_params(params, specs, ctx), "specs": specs,
            "sharder": sharder, "plan": plan, "contract": contract}


def zero_contract(cfg, shape, batch: int, layout: dict, seq=TRAIN_SEQ,
                  rows=None, tp: bool = False) -> dict:
    """{kind: [calls, bytes]} per rank of one loss, its grads, their sums
    and the clip's norm with remat on a ``shape`` (data, model) mesh at a
    global ``batch`` x ``seq`` tokens: the hooks' (``lm.remat_step`` of
    ``lm.collective_contract``; with MoE under ``ep``, the dispatch and
    combine moving ``rows``; under ``tp`` its blocks' gathers and
    reduce-scatters) plus the layouts' (``lm.param_contract``: the
    gathers, the ring, the trainer's all-reduces)."""
    dp, mp = shape
    hooks = lm.remat_step(lm.collective_contract(
        cfg, mp, batch // dp, seq // mp, dp=dp, ep=rows is not None,
        moe_rows=rows, tp=tp))
    return {k: [hooks["calls"].get(k, 0) + layout["calls"].get(k, 0),
                hooks["bytes"].get(k, 0) + layout["bytes"].get(k, 0)]
            for k in sorted(set(hooks["calls"]) | set(layout["calls"]))}


def zero_grads(cfg, lay: dict, batch_size: int, device="cuda"):
    """``lm_loss(sharder=)`` on this rank's shard of the first ``batch_size``
    x TRAIN_SEQ batch with this rank's slices, its grads summed by
    ``allreduce_grads`` (each over the dims its leaf is not split over)
    and the clip's norm (``slices_norm``), K1 and K2
    through their kernels.  Returns (loss, norm, grads)."""
    sharder, specs = lay["sharder"], lay["specs"]
    ctx = sharder.ctx
    leaves = lm.tree_map(lambda p: p.detach().requires_grad_(True),
                         lay["params"])
    batch = lm.shard_lm_batch(lm_batch(cfg, batch_size, 0, device), sharder)
    loss, _ = lm.lm_loss(leaves, batch, cfg, sharder=sharder,
                         backend="kernel")
    grads = iter(torch.autograd.grad(loss, lm.tree_leaves(leaves)))
    loss, grads = allreduce_grads(loss.detach(), lm.tree_map(
        lambda p: next(grads), leaves), specs, ctx)
    norm = slices_norm(grads, specs, ctx)
    return loss, norm, grads


def zero_label(name: str, shape) -> str:
    return f"{name}/{shape[0]}x{shape[1]}"


def zero_world_of_one(phase16: dict, work: str, device="cuda") -> dict:
    """(a) At world size 1 on a (1, 1) mesh over NCCL, phase 16 (a)'s runs
    again under the specs' own plans: qwen3-14b at depth QWEN_TRAIN_DEPTH
    for QWEN_TRAIN_STEPS steps at 1 x TRAIN_SEQ, mamba2-370m at depth 48
    for LM_MAMBA_STEPS steps at TRAIN_BATCH x TRAIN_SEQ, the parameters
    and AdamW's state in the layout (at one rank each slice is the whole
    leaf, each gather a copy).  The losses must equal phase 16 (a)'s
    within DSP_LOSS_BAR, the calls and bytes must be exactly
    ``zero_contract`` each step, and K1 (K2) must launch as in phase 16
    (a), all on ``sm90``; step time and peak memory are logged beside
    phase 16 (a)'s.  Then the references of (b): each case of ZERO_CASES
    at world size 1 (loss, grads in the parameters' dtype, norm), written
    to ``work``."""
    backend = BACKEND_OF[torch.device(device).type]
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(work, "store17a"), 1), rank=0, world_size=1)
    out = {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"), torch.device(device).type)
        runs = (("qwen3-14b", QWEN_TRAIN_DEPTH, QWEN_TRAIN_BATCH,
                 QWEN_TRAIN_STEPS, flash_attention_fwd),
                ("mamba2-370m", None, TRAIN_BATCH, LM_MAMBA_STEPS,
                 ssd_scan_fwd))
        for name, depth, batch, steps, kernel in runs:
            cfg = lm_config(name, depth)
            lay = zero_layout(name, cfg, mesh, batch, device)
            want = {k: [c * steps, b * steps]
                    for k, (c, b) in lay["contract"].items()}
            log(f"  {name} depth {cfg.n_layers}, {batch} x {TRAIN_SEQ}, "
                f"{steps} steps, plan {lay['plan']}; per step the contract "
                f"{lay['contract']}")
            sharder = lay["sharder"]
            trained = run_trainer(
                lambda: lay.pop("params"),
                lambda p, b: lm.lm_loss(p, b, cfg, sharder=sharder,
                                        backend="kernel"),
                lambda st: lm.shard_lm_batch(lm_batch(cfg, batch, st,
                                                      device), sharder),
                kernel, tokens=batch * TRAIN_SEQ, n_steps=steps,
                n_layers=cfg.n_layers, route="sm90", device=device,
                sharder=sharder)
            got = {k: [trained["collectives"][k], trained["volume"][k]]
                   for k in sorted(trained["collectives"])}
            log(f"  torch.distributed calls [count, bytes]: {got}")
            if got != want:
                raise AssertionError(f"{name}: collectives {got}, the "
                                     f"contract says {want}")
            ref = phase16[name]["metrics"]
            met = trained["metrics"]
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(met["losses"], ref["losses"]))
            log_t(f"  losses {met['losses']} against phase 16 (a)'s "
                  f"{ref['losses']}: worst |delta| / |loss| = {rel:.3e}; "
                  f"step (median) {met['step_ms_median']:.2f} ms against "
                  f"{ref['step_ms_median']:.2f} ms; peak "
                  f"{met['peak_memory_gb']:.2f} GB against "
                  f"{ref['peak_memory_gb']:.2f} GB")
            if not rel <= DSP_LOSS_BAR:
                raise AssertionError(f"{name}: losses {met['losses']} "
                                     f"differ from phase 16 (a)'s")
            out[name] = trained
            del lay
            torch.cuda.empty_cache()
        for name, depth, shape, batch in ZERO_CASES:
            cfg = lm_config(name, depth)
            lay = zero_layout(name, cfg, mesh, batch, device)
            dtypes = [p.dtype for p in lm.tree_leaves(lay["params"])]
            loss, norm, grads = zero_grads(cfg, lay, batch, device)
            torch.save({"loss": loss.cpu(), "norm": norm.cpu(),
                        "grads": [g.to(t).cpu() for g, t in
                                  zip(lm.tree_leaves(grads), dtypes)]},
                       os.path.join(work, f"zero_ref.{name}.{batch}.pt"))
            log_t(f"  reference {zero_label(name, shape)}: depth {depth}, "
                  f"{batch} x {TRAIN_SEQ}, loss {float(loss):.6f}, grad "
                  f"norm {float(norm):.6f}")
            del lay, grads
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def zero_rank_main(rank: int, world: int, work: str) -> None:
    """One of (b)'s ranks, started by ``zero_four_ranks`` as ``chip_smoke.py
    --zero-rank <rank> <world> <dir>``: gloo over the card's CUDA tensors.
    For each case of ZERO_CASES, on its (data, model) mesh: the spec's
    layout, one ``zero_grads`` with what it counted and its peak memory,
    then each grad slice held against the same slice of (a)'s reference
    (``slice_gap``), each leaf's gap the largest over the ranks; on the
    cases of ZERO_TRAIN one Trainer step, counted, with its grad norm;
    the host's peak resident memory after each.  Written to
    ``<dir>/zero_rank<r>.json``."""
    device = json.load(open(os.path.join(work, "job17.json")))["device"]
    full_f32()
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "store17b"), world), rank=rank, world_size=world)
    try:
        res = {}
        for name, depth, shape, batch in ZERO_CASES:
            label = zero_label(name, shape)
            mesh = make_mesh(shape, ("data", "model"),
                             torch.device(device).type, backend="gloo")
            cfg = lm_config(name, depth)
            lay = zero_layout(name, cfg, mesh, batch, device)
            ctx = lay["sharder"].ctx
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            reset_ssd_launches()
            t0 = time.perf_counter()
            loss, norm, grads = zero_grads(cfg, lay, batch, device)
            got = read_counts()
            got.update(
                seconds=time.perf_counter() - t0,
                coord=[ctx.dp_index, ctx.sp_index],
                contract=lay["contract"],
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                k1_heads={f"{q}/{kv}": n for (q, kv), n in
                          flash_attention_fwd.heads_launches.items()},
                k2=ssd_scan_fwd.launches,
                k2_routes=nonzero(ssd_scan_fwd.route_launches),
                k2_heads={str(h): n for h, n in
                          ssd_scan_fwd.heads_launches.items()})
            got["host_gib"] = {"grads": host_state()}
            # each rank holds its own slices against the same slices of the
            # reference (memory-mapped, its pages shared by the ranks), and
            # each leaf's largest gap and value are the ranks' maxima: no
            # rank holds a whole leaf.  That, and the pinned blocks gloo
            # kept (~9.4 GiB a rank a qwen3 case) given back after each
            # case, keeps the 4 ranks well inside the host's 96 GiB, which
            # whole leaves and every case's blocks together outgrew
            ref = torch.load(os.path.join(work, f"zero_ref.{name}.{batch}"
                                          f".pt"), mmap=True)
            gaps = torch.tensor([slice_gap(g, w[tuple(
                slice(a, b) for a, b in slice_index(w.shape, spec, ctx))])
                for g, w, spec in zip(lm.tree_leaves(grads), ref["grads"],
                                      lm.tree_leaves(lay["specs"]))],
                dtype=torch.float64)
            dist.all_reduce(gaps, op=dist.ReduceOp.MAX)
            shares = (gaps[:, 0] / gaps[:, 1].clamp_min(1e-30)).tolist()
            got["host_gib"]["check"] = host_state()
            host_empty_cache()
            del grads
            if rank == 0:
                worst = int(np.argmax(shares))
                got.update(loss=float(loss), loss_rel=float(
                    (loss.cpu() - ref["loss"]).abs() / ref["loss"].abs()),
                    norm=float(norm), ref_norm=float(ref["norm"]),
                    norm_rel=float(
                        (norm.cpu() - ref["norm"]).abs() / ref["norm"]),
                    grad_rel=shares[worst], leaves=len(shares),
                    leaf=leaf_paths(lay["specs"])[worst])
            del ref
            torch.cuda.empty_cache()
            if label in ZERO_TRAIN:
                got["train"] = zero_train_step(cfg, lay, batch, device)
                got["host_gib"]["train"] = host_state()
                host_empty_cache()
            res[label] = got
            del lay
            torch.cuda.empty_cache()
        json.dump(res, open(os.path.join(work, f"zero_rank{rank}.json"),
                            "w"))
    finally:
        dist.destroy_process_group()


def host_peak_gib() -> float:
    """This process's peak resident host memory so far, GiB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def host_state() -> dict:
    """GiB of host memory: this process's peak resident so far, and the
    pinned blocks the caching host allocator holds (gloo stages each
    collective of a CUDA tensor through one, and keeps it)."""
    stats = getattr(torch.cuda, "host_memory_stats", dict)()
    return {"peak_rss": round(host_peak_gib(), 2), "pinned": round(
        stats.get("allocated_bytes.current", 0) / 2**30, 2)}


def host_empty_cache() -> None:
    """Give the cached pinned host blocks back (torch >= 2.6 has the
    call), so that one case's blocks do not stay beside the next's."""
    fn = getattr(torch._C, "_host_emptyCache", None)
    if fn is not None:
        fn()


def slice_gap(got: torch.Tensor, want: torch.Tensor) -> list:
    """[max |got - want|, max |want|] of one slice (``got`` on its device,
    ``want`` a view of the memory-mapped reference), compared in pieces of
    about LM_REDUCE_PIECE elements along dim 0."""
    got, want = got.reshape((-1,) + tuple(got.shape[1:])), \
        want.reshape((-1,) + tuple(want.shape[1:]))
    rows = max(1, LM_REDUCE_PIECE // max(1, got[0].numel()))
    gap = top = 0.0
    for a, b in zip(got.split(rows), want.split(rows)):
        b = b.to(a.device).float()
        gap = max(gap, float((a.float() - b).abs().max()))
        top = max(top, float(b.abs().max()))
    return [gap, top]


def slice_sq(got: torch.Tensor, want: torch.Tensor) -> list:
    """[sum (got - want)^2, sum want^2] of one slice, in pieces as
    ``slice_gap`` compares them."""
    got, want = got.reshape((-1,) + tuple(got.shape[1:])), \
        want.reshape((-1,) + tuple(want.shape[1:]))
    rows = max(1, LM_REDUCE_PIECE // max(1, got[0].numel()))
    out = [0.0, 0.0]
    for a, b in zip(got.split(rows), want.split(rows)):
        b = b.to(a.device).float()
        out[0] += float((a.float() - b).square().sum())
        out[1] += float(b.square().sum())
    return out


def zero_train_step(cfg, lay: dict, batch: int, device="cuda") -> dict:
    """One Trainer step with this rank's slices (AdamW's state made from
    them) on the first batch: its loss and grad norm, the calls it made
    and the peak memory."""
    sharder = lay["sharder"]
    trainer = Trainer(
        loss_fn=lambda p, b: lm.lm_loss(p, b, cfg, sharder=sharder,
                                        backend="kernel"),
        params=lay.pop("params"),
        opt_cfg=OptConfig(peak_lr=3e-4, warmup_steps=2, total_steps=1),
        cfg=TrainerConfig(total_steps=1, log_every=1),
        data_fn=lambda st: lm.shard_lm_batch(lm_batch(cfg, batch, st,
                                                      device), sharder),
        device=device, sharder=sharder)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dsp.reset_calls()
    t0 = time.perf_counter()
    _, _, metrics = trainer.step_fn(trainer.params, trainer.opt_state,
                                    trainer.data_fn(0))
    torch.cuda.synchronize()
    out = {"loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "seconds": time.perf_counter() - t0,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "calls": {k: [dsp.calls.get(k, 0), dsp.volume.get(k, 0)]
                     for k in sorted(set(dsp.calls) | set(dsp.volume))}}
    del trainer
    torch.cuda.empty_cache()
    return out


def zero_four_ranks(work: str, device="cuda") -> Part:
    """(b) DSP_RANKS processes sharing the card over gloo, each case of
    ZERO_CASES at full width: the loss and every grad leaf (each rank's
    slices against the same slices of (a)'s reference, the worst over the
    ranks) within phase 7's bars, the clip's
    norm within ZERO_NORM_BAR; per rank exactly the contract's calls and
    bytes, K1 (K2) launched twice a layer on the rank's heads (qwen3-14b
    at (2, 2) on 20 of 40 q and 4 of 8 K/V heads, at (1, 4) on 10 and 2;
    mamba2-370m at (2, 2) on 16 of 32), all on ``sm90``; on ZERO_TRAIN's
    cases one Trainer step with the contract's calls and a grad norm
    within ZERO_NORM_BAR of world 1's; each rank's peak device memory
    and its host memory after each stage logged."""
    with open(os.path.join(work, "job17.json"), "w") as f:
        json.dump({"device": device}, f)
    t0 = time.perf_counter()
    rcs = yield from ranks_exit("--zero-rank", work)
    log_t(f"  {DSP_RANKS} ranks exited {rcs} after "
          f"{time.perf_counter() - t0:.1f} s")
    if any(rcs):
        raise AssertionError(f"a ZeRO rank failed: exit codes {rcs}")
    ranks = [json.load(open(os.path.join(work, f"zero_rank{r}.json")))
             for r in range(DSP_RANKS)]
    for name, depth, shape, batch in ZERO_CASES:
        label = zero_label(name, shape)
        cfg = lm_config(name, depth)
        mp = shape[1]
        if name == "qwen3-14b":
            heads = {"k1": 2 * depth, "k1_heads": {
                f"{cfg.n_heads // mp}/{cfg.n_kv_heads // mp}": 2 * depth},
                "k2": 0, "k2_heads": {}}
        else:
            heads = {"k1": 0, "k1_heads": {}, "k2": 2 * depth, "k2_heads": {
                str(cfg.ssm_cfg.n_heads // mp): 2 * depth}}
        g = ranks[0][label]
        log_t(f"  {label} depth {depth}, {batch} x {TRAIN_SEQ}: loss "
              f"{g['loss']:.6f}, |delta| / |loss| against world 1 "
              f"{g['loss_rel']:.3e}, grad norm {g['norm']:.6f} "
              f"({g['norm_rel']:.3e}), worst grad leaf {g['leaf']} "
              f"{g['grad_rel']:.3e} over {g['leaves']} leaves")
        if not (g["loss_rel"] <= LOSS_BAR and g["grad_rel"] <= GRAD_BAR
                and g["norm_rel"] <= ZERO_NORM_BAR):
            raise AssertionError(f"{label}: the {DSP_RANKS}-rank loss, "
                                 f"grads or norm disagree with world 1: {g}")
        log(f"  {label}: per rank the contract {g['contract']}, {heads}")
        for r, res in enumerate(ranks):
            got = res[label]
            log_t(f"  rank {r} (data {got['coord'][0]}, model "
                  f"{got['coord'][1]}): {got['seconds']:.1f} s, peak "
                  f"{got['peak_gb']:.2f} GB, calls {got['calls']}, K1 "
                  f"{got['k1_heads']} {got['k1_routes']}, K2 "
                  f"{got['k2_heads']} {got['k2_routes']}; host GiB "
                  f"{got['host_gib']}")
            routes_ok = (got["k1_routes"] == ({"sm90": heads["k1"]}
                                              if heads["k1"] else {})
                         and got["k2_routes"] == ({"sm90": heads["k2"]}
                                                  if heads["k2"] else {}))
            if (got["calls"] != got["contract"] or not routes_ok
                    or any(got[k] != v for k, v in heads.items())):
                raise AssertionError(f"rank {r} {label}: {got}, the "
                                     f"contract says {got['contract']} and "
                                     f"{heads}")
            if label in ZERO_TRAIN:
                tr = got["train"]
                rel = abs(tr["grad_norm"] - g["ref_norm"]) / g["ref_norm"]
                log_t(f"  rank {r} Trainer step: loss {tr['loss']:.6f}, "
                      f"grad norm {tr['grad_norm']:.6f} against world 1's "
                      f"{g['ref_norm']:.6f} ({rel:.3e}), "
                      f"{tr['seconds']:.1f} s, peak {tr['peak_gb']:.2f} GB, "
                      f"calls {tr['calls']}")
                if tr["calls"] != got["contract"] or not rel <= ZERO_NORM_BAR:
                    raise AssertionError(f"rank {r} {label} Trainer step: "
                                         f"{tr}, the contract says "
                                         f"{got['contract']}, world 1's "
                                         f"norm {g['ref_norm']}")
    return {"ranks": ranks}


# ---------------------------------------------------------------------------
# Phase 18: checkpoints that reshard on load, resume, compression, replan
# ---------------------------------------------------------------------------

def state_bits(tree) -> list:
    """The leaves of a training state (tensors and the step count) as
    comparable values: a copy of each tensor's bytes on its device (AdamW
    updates the live leaves in place), each int itself."""
    out = []
    for t in lm.tree_leaves(tree):
        if isinstance(t, int):
            out.append(t)
        else:
            out.append(t.detach().reshape(-1).view(torch.uint8).clone())
    return out


def same_bits(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        (x == y) if isinstance(x, int) or isinstance(y, int)
        else (x.shape == y.shape and bool(torch.equal(x, y.to(x.device))))
        for x, y in zip(a, b))


def ckpt_trainer(cfg, lay: dict, *, steps: int, ckpt_dir=None,
                 ckpt_every: int = 0, compress: bool = True,
                 device="cuda") -> Trainer:
    """The Trainer of phase 18 on ``lay`` (``zero_layout``): the global
    CKPT_BATCH x TRAIN_SEQ batches, each rank's shard cut by the loss (as
    ``ElasticSpec.make_loss`` must, for ``replan``), K2 through its
    kernel."""
    def make_loss(mesh, sharder, schedule):
        return lambda p, b: lm.lm_loss(p, lm.shard_lm_batch(b, sharder), cfg,
                                       sharder=sharder, backend="kernel")

    def solve_schedule(sp):
        return lm.dsp_schedule(cfg, sp, seq=TRAIN_SEQ, batch=CKPT_BATCH,
                               joint=True)
    sharder = lay["sharder"]
    return Trainer(
        loss_fn=make_loss(None, sharder, None), params=lay.pop("params"),
        opt_cfg=OptConfig(peak_lr=3e-4, warmup_steps=2,
                          total_steps=CKPT_STEPS),
        cfg=TrainerConfig(total_steps=steps, log_every=1,
                          ckpt_every=ckpt_every, grad_compress=compress),
        data_fn=lambda st: lm_batch(cfg, CKPT_BATCH, st, device),
        ckpt_dir=ckpt_dir, device=device, sharder=sharder,
        elastic=ElasticSpec(make_loss=make_loss,
                            solve_schedule=solve_schedule, plan=lay["plan"]))


def timed_run(trainer: Trainer) -> dict:
    """``trainer.run()`` with K2's counters set to 0 just before and read
    just after, each step timed (synchronised) with its loss."""
    steps = []
    inner = trainer.step_fn

    def timed(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        steps.append({"seconds": time.perf_counter() - t,
                      "loss": float(out[-1]["loss"])})
        return out
    trainer.step_fn = timed
    reset_ssd_launches()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    trainer.step_fn = inner
    return {"steps": steps, "seconds": time.perf_counter() - t0,
            "launches": ssd_scan_fwd.launches,
            "routes": nonzero(ssd_scan_fwd.route_launches)}


def check_k2(what: str, run: dict, depth: int) -> None:
    want = 2 * depth * len(run["steps"])
    log(f"  {what}: K2 {run['launches']} launches by route {run['routes']} "
        f"(2 x {depth} x {len(run['steps'])} = {want})")
    if run["launches"] != want or run["routes"] != {"sm90": want}:
        raise AssertionError(f"{what}: K2 launched {run['routes']}, "
                             f"expected {want} on sm90")


def ckpt_world_of_one(work: str, device="cuda") -> dict:
    """(a) At world size 1 on a (1, 1) mesh over NCCL, mamba2-370m at full
    width and depth under its spec's own plan (``zero_layout``), at
    CKPT_BATCH x TRAIN_SEQ with ``grad_compress``: CKPT_STEPS steps
    uninterrupted; then the same run checkpointed async at step
    CKPT_RESUME, a fresh Trainer that ``try_resume``s (its state bit-equal
    to the one saved: params, moments, master copy, step, residuals) and
    runs the rest, its losses within CKPT_LOSS_BAR relative of the
    uninterrupted run's (the gap printed); K2 exactly 2 x 48 a step on
    ``sm90`` in every run; the checkpoint's bytes and seconds (snapshot,
    write, publish, restore) logged; and one uncompressed run's steps
    beside the compressed run's."""
    dist.init_process_group(BACKEND_OF[torch.device(device).type],
                            store=dist.FileStore(os.path.join(
                                work, "store18a"), 1), rank=0, world_size=1)
    out = {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"), torch.device(device).type)
        cfg = lm_config("mamba2-370m")
        runs = {}
        for name, compress in (("compressed", True), ("plain", False)):
            trainer = ckpt_trainer(cfg, zero_layout(
                "mamba2-370m", cfg, mesh, CKPT_BATCH, device),
                steps=CKPT_STEPS, compress=compress, device=device)
            runs[name] = timed_run(trainer)
            check_k2(f"{name} run", runs[name], cfg.n_layers)
            del trainer
            torch.cuda.empty_cache()
        whole = runs["compressed"]
        med = {k: float(np.median([st["seconds"] for st in r["steps"][1:]]))
               for k, r in runs.items()}
        for name, r in runs.items():
            log_t(f"  {name}: step ms {[st['seconds'] * 1e3 for st in r['steps']]}"
                  f" (median of steps 2-{CKPT_STEPS} {med[name] * 1e3:.2f}); "
                  f"losses {[st['loss'] for st in r['steps']]}")
        log_t(f"  compression: {(med['compressed'] - med['plain']) * 1e3:+.2f}"
              f" ms a step ({med['compressed'] / med['plain'] - 1:+.2%})")
        ckdir = tempfile.mkdtemp(prefix="ckpt18.", dir=work)
        first = ckpt_trainer(cfg, zero_layout("mamba2-370m", cfg, mesh,
                                              CKPT_BATCH, device),
                             steps=CKPT_RESUME, ckpt_dir=ckdir,
                             ckpt_every=CKPT_RESUME, device=device)
        need = sum(t.numel() * t.element_size()
                   for t in lm.tree_leaves(first._state())
                   if not isinstance(t, int))
        free = shutil.disk_usage(ckdir).free
        log(f"  checkpoint dir {ckdir}: {free / 1e9:.1f} GB free, the state "
            f"holds {need / 1e9:.2f} GB")
        if free < 1.5 * need:
            raise AssertionError(f"the filesystem of {ckdir} lacks room for "
                                 f"a {need / 1e9:.2f} GB checkpoint: "
                                 f"{free / 1e9:.1f} GB free")
        part1 = timed_run(first)
        check_k2("run to the checkpoint", part1, cfg.n_layers)
        save = dict(first.ckpt.last_save)
        on_disk = sum(os.path.getsize(os.path.join(r, f))
                      for r, _, fs in os.walk(ckdir) for f in fs)
        log_t(f"  async save at step {CKPT_RESUME}: {save['bytes']} B of "
              f"shards, {on_disk} B on disk; snapshot "
              f"{save['snapshot_s']:.3f} s (device to host, the caller's "
              f"thread), write {save['write_s']:.3f} s, publish "
              f"{save['publish_s']:.3f} s ({save['bytes'] / 1e9 / save['write_s']:.2f}"
              f" GB/s written)")
        saved = state_bits(first._state())
        del first
        torch.cuda.empty_cache()
        second = ckpt_trainer(cfg, zero_layout("mamba2-370m", cfg, mesh,
                                               CKPT_BATCH, device),
                              steps=CKPT_STEPS, ckpt_dir=ckdir,
                              device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        second.try_resume()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        equal = same_bits(state_bits(second._state()), saved)
        log_t(f"  try_resume: step {second.start_step} in {restore_s:.3f} s "
              f"({save['bytes'] / 1e9 / restore_s:.2f} GB/s); restored "
              f"state bit-equal to the saved one: {equal}")
        if not (equal and second.start_step == CKPT_RESUME):
            raise AssertionError("the restored state differs from the saved "
                                 "one")
        del saved
        # the resumed run's own end checkpoint would double the disk the
        # phase needs; the save path was timed above
        second.ckpt = None
        part2 = timed_run(second)
        check_k2("resumed run", part2, cfg.n_layers)
        got = [s["loss"] for s in part1["steps"] + part2["steps"]]
        want = [s["loss"] for s in whole["steps"]]
        gap = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        log_t(f"  resumed losses {got} against uninterrupted {want}: worst "
              f"|delta| / |loss| = {gap:.3e} (bit-equal: {got == want})")
        if len(got) != len(want) or not gap <= CKPT_LOSS_BAR:
            raise AssertionError(f"resumed losses {got} differ from the "
                                 f"uninterrupted {want}")
        del second
        shutil.rmtree(ckdir)
        torch.cuda.empty_cache()
        out = {"launches": sum(r["launches"] for r in
                               (whole, runs["plain"], part1, part2)),
               "routes": by_route([whole, runs["plain"], part1, part2]),
               "save": save, "restore_s": restore_s, "gap": gap}
    finally:
        dist.destroy_process_group()
    return out


def ckpt_rank_main(rank: int, world: int, work: str) -> None:
    """One of (b)'s ranks, started by ``ckpt_four_ranks`` as
    ``chip_smoke.py --ckpt-rank <rank> <world> <dir>``: gloo over the
    card's tensors.  mamba2-370m at depth CKPT_RANK_DEPTH under its spec's
    plan with ``grad_compress``: one Trainer step at (2, 2), saved into
    ``<dir>/ck``; the saved state gathered whole (rank 0 writes it to
    ``<dir>/saved18.pt``); two more steps at (2, 2), whose losses are the
    reference; then a fresh Trainer at (1, 4) that resumes (gathered
    state bit-equal to the saved one), takes step 2, ``replan(2)``s (ranks
    2 and 3 leave) and takes step 3 on the survivors.  Written to
    ``<dir>/ckpt_rank<r>.json``."""
    device = json.load(open(os.path.join(work, "job18.json")))["device"]
    full_f32()
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "store18b"), world), rank=rank, world_size=world)
    try:
        cfg = lm_config("mamba2-370m", CKPT_RANK_DEPTH)
        res = {}
        ckdir = os.path.join(work, "ck")

        def layout(shape):
            mesh = make_mesh(shape, ("data", "model"),
                             torch.device(device).type, backend="gloo")
            return zero_layout("mamba2-370m", cfg, mesh, CKPT_BATCH, device)
        t0 = time.perf_counter()
        first = ckpt_trainer(cfg, layout((2, 2)), steps=1, ckpt_dir=ckdir,
                             ckpt_every=1, device=device)
        run = timed_run(first)
        res["save"] = first.ckpt.last_save
        with torch.no_grad():
            saved = unshard_params(first._state(), first._state_specs(),
                                   first.ctx)
        if rank == 0:
            torch.save(lm.tree_map(lambda t: t if isinstance(t, int)
                                   else t.cpu(), saved),
                       os.path.join(work, "saved18.pt"))
        saved = state_bits(saved)
        first.ckpt = None
        first.cfg = dataclasses.replace(first.cfg, total_steps=3)
        ref = timed_run(first)
        res["ref_losses"] = [s["loss"] for s in run["steps"] + ref["steps"]]
        del first
        torch.cuda.empty_cache()
        second = ckpt_trainer(cfg, layout((1, 4)), steps=2, ckpt_dir=ckdir,
                              device=device)
        t1 = time.perf_counter()
        second.try_resume()
        torch.cuda.synchronize()
        res["restore_s"] = time.perf_counter() - t1
        with torch.no_grad():
            got = unshard_params(second._state(), second._state_specs(),
                                 second.ctx)
        res["restored_equal"] = same_bits(state_bits(got), saved)
        res["start_step"] = second.start_step
        del got, saved
        step2 = timed_run(second)
        # replan's own peak: the old slices, the new ones and one whole
        # leaf at a time
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t2 = time.perf_counter()
        second.replan(2)
        torch.cuda.synchronize()
        res["replan"] = {"s": time.perf_counter() - t2,
                         "before_gb": before / 1e9,
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                         "after_gb": torch.cuda.memory_allocated() / 1e9}
        res["active"] = second.active
        res["mesh"] = (None if second.mesh is None
                       else list(second.mesh.shape))
        second.cfg = dataclasses.replace(second.cfg, total_steps=3)
        step3 = timed_run(second)
        res["losses"] = [s["loss"] for s in step2["steps"] + step3["steps"]]
        res["k2"] = {"launches": run["launches"] + ref["launches"]
                     + step2["launches"] + step3["launches"]}
        res["seconds"] = time.perf_counter() - t0
        res["peak_gb"] = max(peak, torch.cuda.max_memory_allocated()) / 1e9
        res["host_gib"] = host_peak_gib()
        json.dump(res, open(os.path.join(work, f"ckpt_rank{rank}.json"),
                            "w"))
    finally:
        dist.destroy_process_group()


def ckpt_four_ranks(work: str, device="cuda") -> Part:
    """(b) DSP_RANKS processes sharing the card over gloo
    (``ckpt_rank_main``): the state saved at (2, 2) restores bit-equal at
    (1, 4) on the ranks and at world size 1 here (gathered against the
    saved global tree); step 2's loss at (1, 4) and step 3's on the
    survivors of ``replan(2)``, a (1, 2) mesh, within phase 7's LOSS_BAR
    of the (2, 2) run's."""
    with open(os.path.join(work, "job18.json"), "w") as f:
        json.dump({"device": device}, f)
    t0 = time.perf_counter()
    rcs = yield from ranks_exit("--ckpt-rank", work)
    log_t(f"  {DSP_RANKS} ranks exited {rcs} after "
          f"{time.perf_counter() - t0:.1f} s")
    if any(rcs):
        raise AssertionError(f"a checkpoint rank failed: exit codes {rcs}")
    ranks = [json.load(open(os.path.join(work, f"ckpt_rank{r}.json")))
             for r in range(DSP_RANKS)]
    ref = ranks[0]["ref_losses"]
    for r, res in enumerate(ranks):
        got = res["losses"]
        gaps = [abs(a - b) / abs(b) for a, b in zip(got, ref[1:])]
        log_t(f"  rank {r}: saved {res['save']['bytes']} B in "
              f"{res['save']['write_s']:.3f} s (+ snapshot "
              f"{res['save']['snapshot_s']:.3f} s, publish "
              f"{res['save']['publish_s']:.3f} s); restored at (1, 4) "
              f"step {res['start_step']} in {res['restore_s']:.3f} s, "
              f"bit-equal {res['restored_equal']}; losses {got} against "
              f"(2, 2)'s {ref[1:]}: gaps {[f'{g:.2e}' for g in gaps]}; after "
              f"replan(2) active {res['active']} on {res['mesh']} in "
              f"{res['replan']['s']:.3f} s (GB held before "
              f"{res['replan']['before_gb']:.3f}, peak "
              f"{res['replan']['peak_gb']:.3f}, after "
              f"{res['replan']['after_gb']:.3f}); K2 "
              f"{res['k2']['launches']}; {res['seconds']:.1f} s, peak "
              f"{res['peak_gb']:.2f} GB, host peak resident "
              f"{res['host_gib']:.2f} GiB")
        want_len = 2 if r < 2 else 1
        if not (res["restored_equal"] and res["start_step"] == 1
                and len(got) == want_len and all(g <= LOSS_BAR for g in gaps)
                and res["active"] == (r < 2)
                and (r >= 2 or res["mesh"] == [1, 2])):
            raise AssertionError(f"rank {r}: {res}")
    # world size 1: the 4 ranks' checkpoint restored whole in this process
    from repro_torch.train.checkpoint import CheckpointManager
    saved = torch.load(os.path.join(work, "saved18.pt"))
    template = lm.tree_map(lambda t: t if isinstance(t, int) else
                           torch.empty(t.shape, dtype=t.dtype, device="meta"),
                           saved)
    t1 = time.perf_counter()
    step, got = CheckpointManager(os.path.join(work, "ck")).restore(
        template, 1, device=device)
    torch.cuda.synchronize()
    equal = same_bits(state_bits(got), state_bits(saved))
    log_t(f"  world 1: step {step} restored whole in "
          f"{time.perf_counter() - t1:.3f} s, bit-equal to the saved global "
          f"tree: {equal}")
    if not equal:
        raise AssertionError("the world-1 restore differs from the saved "
                             "global tree")
    return {"ranks": ranks}


def ckpt_clis(work: str, train_main, serve_main) -> None:
    """(c) The CLIs at SMOKE size on one checkpoint directory: train with
    ``--ckpt-dir --grad-compress``, train on with ``--resume``, serve from
    the checkpoint (which must print ``restored step N``)."""
    import contextlib
    import io
    d = os.path.join(work, "cli")
    base = ["--arch", "mamba2-370m", "--ckpt-dir", d, "--grad-compress"]
    first = train_main(base + ["--steps", "8"])
    second = train_main(base + ["--steps", "16", "--resume"])
    log(f"  train: {first['history']}; resumed: {second['history']}")
    if (first["final_step"] != 8 or second["final_step"] != 16
            or second["history"][0][0] <= 8):
        raise AssertionError(f"train CLI resume: {first} {second}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve_main(["--arch", "mamba2-370m", "--ckpt-dir", d,
                          "--batch", "2", "--prompt-len", "16",
                          "--new-tokens", "8"])
    text = buf.getvalue()
    log(f"  serve: {text.splitlines()[0]}; generated {out.shape}")
    if "restored step 16" not in text or tuple(out.shape) != (2, 8):
        raise AssertionError(f"serve CLI from the checkpoint: {text}")


def train_cli(train_main, arch: str) -> None:
    """The train CLI at SMOKE size for 30 steps; the loss must fall."""
    hist = train_main(["--arch", arch, "--steps", "30"])["history"]
    log(f"  {arch}: loss {hist[0][1]:.4f} -> {hist[-1][1]:.4f}")
    if not hist[-1][1] < hist[0][1]:
        raise AssertionError(f"train CLI loss did not fall for {arch}: "
                             f"{hist}")


# ---------------------------------------------------------------------------
# Phase 19: the LM family served sharded, the KV sequence-sharded
# ---------------------------------------------------------------------------

def serve_world_of_one(served: dict, work: str, device="cuda") -> dict:
    """(a) At world size 1 on a (1, 1) mesh over NCCL, SERVE_PLAN: phases
    5's and 9's trace again through ``full_width_serve`` with the mesh
    (every collective a device copy): the tokens must equal theirs, K1
    (K2) launch 320 (384) times on ``sm90``, the calls and bytes exactly
    ``serve_contract``'s; TTFT and TPOT logged beside theirs."""
    backend = BACKEND_OF[torch.device(device).type]
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(work, "store19a"), 1), rank=0, world_size=1)
    out = {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"), torch.device(device).type)
        for name, kernel in (("qwen3-14b", flash_attention_fwd),
                             ("mamba2-370m", ssd_scan_fwd)):
            log(f"  {name}, full depth, {SERVE_PLAN}")
            res = full_width_serve(lm_config(name), kernel, device, mesh=mesh,
                                   plan=SERVE_PLAN)
            ref = served[name]
            same = res["tokens"] == ref["tokens"]
            m, r = res["metrics"], ref["metrics"]
            log_t(f"  tokens equal to plan none's phase: {same}; TTFT p50 "
                  f"{m['ttft_p50_s']:.4f} s against {r['ttft_p50_s']:.4f}, "
                  f"TPOT p50 {m['tpot_p50_s'] * 1e3:.2f} ms against "
                  f"{r['tpot_p50_s'] * 1e3:.2f} (no order claimed: TPOT "
                  f"moves up to 2x between calls)")
            if not same:
                raise AssertionError(f"{name}: world-1 sharded tokens differ "
                                     f"from plan none's")
            out[name] = res
    finally:
        dist.destroy_process_group()
    return out


def serve_max_len() -> int:
    """The trace's longest prompt and new tokens, in whole blocks of the
    sequence-sharded cache over DSP_RANKS ranks (2080 = 4 x 520)."""
    need = max(PROMPT_LENS) + NEW_TOKENS
    return need + (-need) % DSP_RANKS


def serve_case(name: str) -> tuple:
    return {c[0]: c for c in SERVE_RANK_CASES}[name]


def serve_cfg(name: str):
    """A case of SERVE_RANK_CASES at its served depth."""
    return lm_config(name, serve_case(name)[1])


def forced_cfgs(name: str) -> list:
    """(label, cfg) of each teacher-forced check of a case of
    SERVE_RANK_CASES, at its depth and dtype."""
    out = []
    for depth, dtype in serve_case(name)[3]:
        cfg = dataclasses.replace(lm_config(name, depth), dtype=dtype)
        out.append((f"depth {cfg.n_layers} {str(dtype)[6:]}", cfg))
    return out


def kernel_drift(cfg, reqs, device="cuda") -> float:
    """One card, ``cfg``: the forced steps' logits with the kernels (K1,
    K2) against their plain versions, the worst row relative to its
    largest logit: how far two arithmetic paths of the model drift apart
    on their own."""
    params = lm.init_lm(0, cfg, device=device)
    worst = 0.0
    with torch.no_grad():
        for r in reqs:
            tok = r.prompt[None]
            a, ca = lm.forward_prefill(params, tok, cfg, backend="kernel")
            b, cb = lm.forward_prefill(params, tok, cfg, backend="ref")
            worst = max(worst, logit_gap(a, b))
            for _ in range(SERVE_FORCED_STEPS):
                nxt = torch.argmax(a[:, -1], dim=-1)[:, None]
                a, ca = lm.forward_decode(params, nxt, ca, cfg)
                b, cb = lm.forward_decode(params, nxt, cb, cfg)
                worst = max(worst, logit_gap(a, b))
    del params
    free_device()
    return worst


@torch.no_grad()
def layer_drift(cfg, prompt, device="cuda") -> dict:
    """One card, ``cfg`` in bf16, one prompt's prefill walked a layer at a
    time.  Per layer, the gap max |a - b| / max |b| over the hidden states
    (1, S, d) of: ``local``, the layer through the kernels against through
    their plain versions, both on the plain path's input; ``carried``, the
    kernel path against the plain path, each from the embedding;
    ``nudged``, the plain path from the embedding raised by one bf16 ulp
    against the plain path.  Local gaps at one rounding and a carried gap
    that grows as the nudged one does show rounding amplified by depth,
    not a fault of the kernel."""
    params = lm.init_lm(0, cfg, device=device)
    sh = make_sharder(None, ParallelPlan(mode="none"))
    x = lm.sharded_embed(params, prompt[None], cfg, sh)
    xk, xr = x, x
    xn = (x.contiguous().view(torch.int16) + 1).view(x.dtype)
    out = {"local": [], "carried": [], "nudged": []}
    for pp in lm.unstack(params["periods"], cfg.n_periods):
        for j, spec in enumerate(cfg.period_specs()):
            def layer(h, backend):
                return lm._apply_layer(pp[str(j)], h, cfg, spec, sh, backend,
                                       True)[0]
            yr = layer(xr, "ref")
            out["local"].append(logit_gap(layer(xr, "kernel"), yr))
            xk, xr, xn = layer(xk, "kernel"), yr, layer(xn, "ref")
            out["carried"].append(logit_gap(xk, xr))
            out["nudged"].append(logit_gap(xn, xr))
    del params, x, xk, xr, xn
    free_device()
    return out


@torch.no_grad()
def forced_logits(eng, reqs, tokens, device="cuda") -> torch.Tensor:
    """Teacher forcing: each request prefilled into its own slot of a pool
    of ``len(reqs)`` slots on the engine's mesh, then SERVE_FORCED_STEPS
    decode steps fed ``tokens`` (the reference's own, the first one
    generated at index 0).  Returns the logits (requests, 1 +
    SERVE_FORCED_STEPS, V or this rank's vocab chunk) in float32."""
    pool = KVPool(eng.cfg, len(reqs), eng.max_len, mesh=eng.mesh,
                  plan=eng.plan, device=device)
    rows = []
    for i, r in enumerate(reqs):
        logits, caches = eng._prefill(r.prompt[None])
        eng.next_tokens(logits)         # as the scheduler reads each step
        rows.append([logits[0, -1].float()])
        pool.insert(i, caches, len(r.prompt))
    fed = torch.tensor([t[:SERVE_FORCED_STEPS] for t in tokens],
                       device=device)
    for t in range(SERVE_FORCED_STEPS):
        logits, pool.caches = eng._decode(fed[:, t:t + 1], pool.caches)
        eng.next_tokens(logits)
        for i in range(len(reqs)):
            rows[i].append(logits[i, -1].float())
    return torch.stack([torch.stack(r) for r in rows])


def serve_refs(work: str, device="cuda") -> None:
    """(b)'s references on one rank, plan none: the trace's tokens through
    the scheduler at each case's served depth, and the teacher-forced
    logits on them at each of its forced checks' depth and dtype, written
    to ``work``.  Logs how far the kernels drift from their plain versions
    at the served depth: over the forced logits (``kernel_drift``) and
    layer by layer over a prefill (``layer_drift``)."""
    for name, *_ in SERVE_RANK_CASES:
        cfg = serve_cfg(name)
        eng = ServingEngine(lm.init_lm(0, cfg, device=device), cfg,
                            max_len=serve_max_len(), device=device)
        reqs = trace_requests(cfg, device, new_tokens=SERVE_RANK_NEW)
        eng.serve(reqs, continuous=True, max_batch=MAX_BATCH)
        tokens = [r.generated for r in reqs]
        del eng
        free_device()
        forced = [reqs[i] for i in SERVE_FORCED]
        log_t(f"  {name}: one card in {cfg.dtype}, the forced steps' "
              f"logits, kernels against plain versions: worst row "
              f"{kernel_drift(cfg, forced, device):.3e}")
        gaps = layer_drift(cfg, forced[-1].prompt, device)
        log_t(f"  {name}: the {len(forced[-1].prompt)}-token prefill layer "
              f"by layer, hidden states' max |delta| / max |plain|: the "
              f"worst local (one layer, kernels against plain on the same "
              f"input) {max(gaps['local']):.3e}; carried (kernel path "
              f"against plain path) at the last layer "
              f"{gaps['carried'][-1]:.3e}, nudged (plain path from an "
              f"embedding one bf16 ulp up) {gaps['nudged'][-1]:.3e}")
        for what, row in gaps.items():
            log(f"    {what}: " + " ".join(f"{g:.1e}" for g in row))
        logits = {}
        for label, fcfg in forced_cfgs(name):
            eng = ServingEngine(lm.init_lm(0, fcfg, device=device), fcfg,
                                max_len=serve_max_len(), device=device)
            logits[label] = forced_logits(
                eng, forced, [tokens[i] for i in SERVE_FORCED], device).cpu()
            del eng
            free_device()
        torch.save({"tokens": tokens, "logits": logits},
                   os.path.join(work, f"serve_ref.{name}.pt"))


def forced_gap(got: torch.Tensor, want: torch.Tensor, sharder) -> float:
    """The worst logits row of ``got`` (this rank's vocab chunk when the
    logits are vocab-sharded) against the same rows of ``want`` (the whole
    reference): max |got - want| / max |want| per row, each the maximum
    over the ranks (one MAX all-reduce, not counted)."""
    v = got.shape[-1]
    first = sharder.sp_index * v if v != want.shape[-1] else 0
    want = want[..., first:first + v].to(got.device)
    parts = torch.stack([(got - want).abs().amax(-1), want.abs().amax(-1)])
    if sharder.ctx is not None:
        dist.all_reduce(parts, op=dist.ReduceOp.MAX,
                        group=sharder.ctx.sp_group)
    return float((parts[0] / parts[1]).max())


def heads_expected(cfg, log_prefills) -> dict:
    """{heads: launches} of K1 (attention layers: "q/kv") or K2 (SSM
    layers: "h") over the logged prefills, once a layer at each's SP
    degree."""
    out = {}
    for n, _, _ in log_prefills:
        if cfg.ssm_cfg is not None:
            key = str(cfg.ssm_cfg.n_heads // n)
        else:
            # K/V heads fewer than the ranks are repeated up to them
            kv = cfg.n_kv_heads * (-(-n // cfg.n_kv_heads)
                                   if cfg.n_kv_heads < n else 1)
            key = f"{cfg.n_heads // n}/{kv // n}"
        out[key] = out.get(key, 0) + cfg.n_layers
    return out


def serve_rank_main(rank: int, world: int, work: str) -> None:
    """One of (b)'s ranks, started by ``serve_four_ranks`` as
    ``chip_smoke.py --serve-rank <rank> <world> <dir>``: gloo over the
    card's CUDA tensors on a (1, world) mesh.  For each case of
    SERVE_RANK_CASES: under SERVE_PLAN the teacher-forced logits against
    the reference's at each of its forced checks' depth and dtype,
    counted; under SERVE_RANK_PLAN the trace through the
    scheduler with the pool asserted on the mesh after every step, the
    calls and bytes of each segment and K1/K2's launches by heads; on the
    replan case ``replan(SERVE_REPLAN_TO)`` at decode step
    SERVE_REPLAN_STEP, the pool gathered before and after (bit for bit),
    its seconds and memory, and the teacher-forced logits again on the
    survivors.  Written to ``<dir>/serve_rank<r>.json``."""
    device = json.load(open(os.path.join(work, "job19.json")))["device"]
    full_f32()
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "store19b"), world), rank=rank, world_size=world)
    res = {}
    try:
        for name, _, replan, _ in SERVE_RANK_CASES:
            cfg = serve_cfg(name)
            # the check after the replan runs the served engine
            served_label = [label for label, fcfg in forced_cfgs(name)
                            if fcfg == cfg]
            if replan and not served_label:
                raise ValueError(f"{name}: no forced check at the served "
                                 f"depth and dtype for after the replan")
            ref = torch.load(os.path.join(work, f"serve_ref.{name}.pt"))
            got = res[name] = {"host_gib": {}, "forced": {}}
            mesh = make_mesh((1, world), ("data", "model"), device,
                             backend="gloo")
            reqs = trace_requests(cfg, device, new_tokens=SERVE_RANK_NEW)
            forced = [reqs[i] for i in SERVE_FORCED]
            forced_tokens = [ref["tokens"][i] for i in SERVE_FORCED]
            segments, seen = {}, {}
            # the CLI's plan: the teacher-forced checks, counted
            for label, fcfg in forced_cfgs(name):
                params = lm.init_lm(0, fcfg, device=device)
                eng = ServingEngine(params, fcfg, max_len=serve_max_len(),
                                    mesh=mesh, plan=SERVE_PLAN,
                                    device=device)
                steps = StepLog(eng)
                dsp.reset_calls()
                got["forced"][label] = forced_gap(forced_logits(
                    eng, forced, forced_tokens, device),
                    ref["logits"][label], eng.sharder)
                segments[f"forced {label}"] = [counted(), steps.expected(
                    fcfg, meta_tree(params), SERVE_PLAN, 0)]
                del eng, steps, params
                free_device()
                got["host_gib"][f"forced {label}"] = host_state()
                host_empty_cache()
            # the trace, without ZeRO
            params = lm.init_lm(0, cfg, device=device)
            template = meta_tree(params)
            eng = ServingEngine(params, cfg, max_len=serve_max_len(),
                                mesh=mesh, plan=SERVE_RANK_PLAN,
                                device=device)
            del params
            free_device()
            steps = StepLog(eng)
            sched = ContinuousScheduler(eng, max_batch=MAX_BATCH)

            def on_step(s, k):
                s.pool.assert_on_mesh()
                if not (replan and k == SERVE_REPLAN_STEP):
                    return
                segments["before"] = [counted(), steps.expected(
                    cfg, template, SERVE_RANK_PLAN, s.ticks)]
                seen["ticks"] = s.ticks
                before = flatten_pool(s.pool)
                torch.cuda.synchronize()
                mem0 = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                dsp.reset_calls()
                t0 = time.perf_counter()
                s.replan(SERVE_REPLAN_TO)
                torch.cuda.synchronize()
                seen["replan_seconds"] = time.perf_counter() - t0
                segments["migrate"] = [counted(), add_contracts(
                    lm.serve_contract(cfg, world, template, SERVE_RANK_PLAN,
                                      migrate=(MAX_BATCH, s.engine.max_len,
                                               SERVE_REPLAN_TO)))]
                seen["memory_gb"] = [mem0 / 1e9,
                                     torch.cuda.max_memory_allocated() / 1e9,
                                     torch.cuda.memory_allocated() / 1e9]
                if s.engine.active:
                    after = flatten_pool(s.pool)
                    seen["moved_equal"] = all(torch.equal(before[p], after[p])
                                              for p in before)
                del before
                dsp.reset_calls()

            torch.cuda.synchronize()
            reset_launches()
            reset_ssd_launches()
            dsp.reset_calls()
            t0 = time.perf_counter()
            sched.run(reqs, on_step=on_step)
            torch.cuda.synchronize()
            got["seconds"] = time.perf_counter() - t0
            got["active"] = eng.active
            got.update({k: v for k, v in seen.items() if k != "ticks"})
            k1_heads = heads_expected(cfg, steps.every_prefill)
            if eng.active:
                segments["after"] = [counted(), steps.expected(
                    cfg, template, SERVE_RANK_PLAN,
                    sched.ticks - seen.get("ticks", 0))]
                got["finished"] = all(
                    r.result is not None
                    and len(r.generated) == SERVE_RANK_NEW for r in reqs)
                got["token_share"] = float(np.mean([
                    a == b for r, t in zip(reqs, ref["tokens"])
                    for a, b in zip(r.generated, t)]))
                got["metrics"] = sched.metrics.summary()
            got["segments"] = segments
            kernel = ssd_scan_fwd if cfg.ssm_cfg is not None \
                else flash_attention_fwd
            got["heads"] = {("/".join(map(str, k)) if isinstance(k, tuple)
                             else str(k)): n
                            for k, n in kernel.heads_launches.items()}
            got["heads_expected"] = k1_heads
            got["routes"] = nonzero(kernel.route_launches)
            got["launches"] = kernel.launches
            if replan and eng.active:
                dsp.reset_calls()
                got["forced_after"] = forced_gap(forced_logits(
                    eng, forced, forced_tokens, device),
                    ref["logits"][served_label[0]], eng.sharder)
                segments["forced after"] = [counted(), steps.expected(
                    cfg, template, SERVE_RANK_PLAN, 0)]
            got["host_gib"]["served"] = host_state()
            del eng, sched, ref, steps
            free_device()
            host_empty_cache()
            dist.barrier()
        json.dump(res, open(os.path.join(work, f"serve_rank{rank}.json"),
                            "w"))
    finally:
        dist.destroy_process_group()


def flatten_pool(pool) -> dict:
    """The pool's KV and SSM leaves gathered whole on its mesh (not
    counted: the caller resets the counters after)."""
    from repro_torch.parallel.partition import cache_pspecs
    whole = unshard_params(pool.caches, cache_pspecs(pool.caches, pool.plan),
                           pool.ctx)
    return {"/".join(p): t.clone() for p, t in
            zip(leaf_paths_of(whole), lm.tree_leaves(whole))}


def leaf_paths_of(tree, path=()) -> list:
    if isinstance(tree, dict):
        return [q for k in tree for q in leaf_paths_of(tree[k], path + (k,))]
    return [path]


def serve_four_ranks(work: str, device="cuda") -> Part:
    """(b) DSP_RANKS processes sharing the card over gloo, each case of
    SERVE_RANK_CASES at full width: the teacher-forced logits within
    LOGIT_BAR of the one-rank reference's, every request finished, the
    calls and bytes of each segment exactly ``serve_contract``'s, K1 (K2)
    once a layer a prefill on each rank's heads, all ``sm90``; on the
    replan case the moved pool bit-equal and the survivors' forced logits
    within the bar.  The share of tokens equal to the reference's is
    logged, not gated."""
    with open(os.path.join(work, "job19.json"), "w") as f:
        json.dump({"device": device}, f)
    t0 = time.perf_counter()
    serve_refs(work, device)
    free_device()
    log_t(f"  references at one rank in {time.perf_counter() - t0:.1f} s, "
          f"this process holding {torch.cuda.memory_reserved() / 1e9:.2f} "
          f"GB of the card ({elapsed()})")
    t0 = time.perf_counter()
    rcs = yield from ranks_exit("--serve-rank", work, timeout=900)
    log_t(f"  {DSP_RANKS} ranks exited {rcs} after "
          f"{time.perf_counter() - t0:.1f} s")
    if any(rcs):
        raise AssertionError(f"a serving rank failed: exit codes {rcs}")
    ranks = [json.load(open(os.path.join(work, f"serve_rank{r}.json")))
             for r in range(DSP_RANKS)]
    for name, _, replan, _ in SERVE_RANK_CASES:
        cfg = serve_cfg(name)
        log(f"  {name} depth {cfg.n_layers}: forced logits at "
            f"{[label for label, _ in forced_cfgs(name)]} under "
            f"{SERVE_PLAN}, the trace under {SERVE_RANK_PLAN}"
            + (f", replan({SERVE_REPLAN_TO}) at decode step "
               f"{SERVE_REPLAN_STEP}" if replan else ""))
        # the decode step's embedding per rank: the port's masked lookup
        # and one all-reduce of the (slots, 1, d) rows, where JAX's
        # sharded_embed rings the whole table (n permutes of a chunk)
        log(f"  decode embedding bytes a rank a step at {MAX_BATCH} slots: "
            f"all-reduce {2 * MAX_BATCH * cfg.d_model * cfg.dtype.itemsize}"
            f", JAX's table ring {cfg.vocab * cfg.d_model * cfg.dtype.itemsize}")
        for r, res in enumerate(ranks):
            got = res[name]
            log_t(f"  rank {r}: forced logits' worst row {got['forced']}"
                  f" (after the replan {got.get('forced_after')}); served "
                  f"{got['seconds']:.1f} s, still serving {got['active']}, "
                  f"share of tokens equal to the reference's "
                  f"{got.get('token_share')}; launches by heads "
                  f"{got['heads']} (expected {got['heads_expected']}), "
                  f"{got['routes']}; host GiB {got['host_gib']}")
            if "replan_seconds" in got:
                log_t(f"  rank {r}: replan({SERVE_REPLAN_TO}) "
                      f"{got['replan_seconds']:.3f} s, device memory GB "
                      f"before / peak / after {got['memory_gb']}, moved "
                      f"pool bit-equal {got.get('moved_equal')}")
            if got["active"]:
                log_t(f"  rank {r} metrics " + json.dumps(got["metrics"],
                                                         sort_keys=True))
            for seg, (calls, want) in got["segments"].items():
                log(f"  rank {r} {seg}: calls {calls}; contract {want}")
                if calls != want:
                    raise AssertionError(f"rank {r} {name} {seg}: calls "
                                         f"{calls}, the contract says {want}")
            bars = list(got["forced"].values()) + (
                [got["forced_after"]] if "forced_after" in got else [])
            if not max(bars) <= LOGIT_BAR:
                raise AssertionError(f"rank {r} {name}: forced logits "
                                     f"{bars} past {LOGIT_BAR}")
            if (got["heads"] != got["heads_expected"]
                    or got["routes"] != {"sm90": got["launches"]}):
                raise AssertionError(f"rank {r} {name}: launches "
                                     f"{got['heads']} {got['routes']}, "
                                     f"expected {got['heads_expected']} "
                                     f"on sm90")
            if got["active"] and not got["finished"]:
                raise AssertionError(f"rank {r} {name}: not every request "
                                     f"finished")
            if replan and got["active"] and not got["moved_equal"]:
                raise AssertionError(f"rank {r} {name}: the moved pool "
                                     f"differs from the one before")
    return {"ranks": ranks}


SERVE_CLI = ["--arch", "qwen3-14b", "--batch", "4", "--prompt-len", "16",
             "--new-tokens", "8"]
SERVE_CLI_CONT = ["--continuous", "--arrival", "0.01"]


def serve_cli_ranks(serve_main, launched: dict) -> None:
    """Phase 19 (c), run in phase 28: the serve CLI at SMOKE size under
    ``torchrun --nproc-per-node`` DSP_RANKS on the card, gloo over its
    tensors (``--backend gloo``: NCCL takes one rank a card), ``--mode
    dsp``: continuous over a Poisson trace (``--arrival 0.01``), whose
    tokens must be world 1's (run in this process), and static with
    ``--replan 2``, which must print ``replan output identical: True``."""
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        want = [r.generated for r in serve_main(SERVE_CLI + SERVE_CLI_CONT)]
    for name in ("19c/continuous", "19c/replan"):
        rc, text, err, seconds = finish(launched[name])
        log_t(f"  {name}: exit {rc} in {seconds:.1f} s; "
              f"{text.splitlines()[0] if text else err[-2000:]}")
        if rc:
            raise AssertionError(f"serve CLI under torchrun {name}: "
                                 f"{text[-2000:]}{err[-3000:]}")
        if name == "19c/continuous":
            got = [json.loads(m) for m in re.findall(r"s: (\[[^\]]*\])",
                                                     text)]
            log(f"  tokens equal to world 1's: {got == want}")
            if got != want or "KV pool sequence-sharded over 4-way" \
                    not in text:
                raise AssertionError(f"serve CLI continuous on "
                                     f"{DSP_RANKS} ranks: {text[-2000:]}")
        elif "replan output identical: True" not in text:
            raise AssertionError(f"serve CLI --replan 2: {text[-2000:]}")
        else:
            log("  replan output identical: True")


# ---------------------------------------------------------------------------
# Phase 20: paged serving (block pool, prefix tree, chunked prefill)
# ---------------------------------------------------------------------------

def paged_requests(cfg, system: int, suffixes, new: int,
                   device="cuda") -> list:
    """A shared ``system``-token prompt and a seeded suffix of each length
    of ``suffixes``, ``new`` new tokens each, all arriving at 0."""
    g = torch.Generator(device=device).manual_seed(5)
    head = torch.randint(0, cfg.vocab, (system,), generator=g, device=device)
    return [Request(prompt=torch.cat([head, torch.randint(
                0, cfg.vocab, (n,), generator=g, device=device)]),
                    max_new_tokens=new, request_id=i)
            for i, n in enumerate(suffixes)]


def paged_max_len(system: int, suffixes, new: int) -> int:
    need = system + max(suffixes) + new
    return need + (-need) % PAGED_BLOCK


@torch.no_grad()
def paged_forced_logits(eng, reqs, tokens, chunk: int):
    """Teacher forcing through the paged tier: the requests admitted in
    turn into one ``PagedScheduler``'s pool (the prefix tree on, so a later
    request reads an earlier one's blocks), each prompt streamed in chunks
    of ``chunk`` tokens (``_chunk_step``), then SERVE_FORCED_STEPS decode
    steps of the pool fed ``tokens`` (the reference's own, the first one
    generated at index 0).  Returns (the logits (requests, 1 +
    SERVE_FORCED_STEPS, V or this rank's vocab chunk) in float32, the
    scheduler)."""
    sched = PagedScheduler(eng, max_batch=len(reqs), block_size=PAGED_BLOCK,
                           prefill_chunk=chunk)
    sched._t0 = sched._clock()
    seen = []
    steps = {"_chunk": eng._chunk, "_decode": eng._decode}

    def grab(fn):
        def inner(*a):
            logits, caches = fn(*a)
            seen.append(logits)
            return logits, caches
        return inner
    for name, fn in steps.items():
        setattr(eng, name, grab(fn))
    try:
        rows = []
        for r in reqs:
            sched._admit(collections.deque([r]), 0.0, None)
            while sched._prefilling:
                sched._chunk_step(None)
            rows.append([seen[-1][0, -1].float()])
        for t in range(SERVE_FORCED_STEPS):
            for i, slot in enumerate(sorted(sched._active)):
                sched._active[slot].last_token = tokens[i][t]
            _, sched.pool.caches = sched._decode_step(sched.pool.caches)
            for i, slot in enumerate(sorted(sched._active)):
                rows[i].append(seen[-1][slot, -1].float())
    finally:
        for name, fn in steps.items():
            setattr(eng, name, fn)
    return torch.stack([torch.stack(r) for r in rows]), sched


def paged_world_of_one(device="cuda") -> dict:
    """(a) qwen3-14b at full width and depth, plan none, on one card: the
    paged trace through the slot path (``ContinuousScheduler``) and then
    through ``PagedScheduler`` with every launch counter set to 0 just
    before and read just after: every request finished, PAGED_HITS
    prefix-hit tokens, PAGED_CHUNKS chunks, K1 40 x PAGED_CHUNKS launches
    all on ``sm90``; the forced requests' teacher-forced logits through
    the paged path against the slot path's within LOGIT_BAR.  Logs the
    share of tokens equal to the slot path's, TTFT and TPOT p50/p99 of
    both, the peak blocks."""
    cfg = qwen3_14b.CONFIG
    t0 = time.perf_counter()
    params = lm.init_lm(0, cfg, device=device)
    torch.cuda.synchronize()
    log_t(f"  init {lm.param_counts(cfg)['total'] / 1e9:.2f}B params in "
          f"{time.perf_counter() - t0:.1f} s")
    eng = ServingEngine(params, cfg, max_len=paged_max_len(
        PAGED_SYSTEM, PAGED_SUFFIXES, NEW_TOKENS), device=device)
    del params
    suffixes = PAGED_SUFFIXES * 2
    slot_reqs = paged_requests(cfg, PAGED_SYSTEM, suffixes, NEW_TOKENS,
                               device)
    slot = ContinuousScheduler(eng, max_batch=MAX_BATCH)
    slot.run(slot_reqs)
    torch.cuda.synchronize()
    slot_m = slot.metrics.summary()
    del slot
    free_device()
    reqs = paged_requests(cfg, PAGED_SYSTEM, suffixes, NEW_TOKENS, device)
    sched = PagedScheduler(eng, max_batch=MAX_BATCH, block_size=PAGED_BLOCK,
                           prefill_chunk=PAGED_CHUNK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reset_ssd_launches()
    t0 = time.perf_counter()
    sched.run(reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = flash_attention_fwd.launches
    routes = dict(flash_attention_fwd.route_launches)
    m = sched.metrics.summary()
    m["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    share = float(np.mean([a == b for r, q in zip(reqs, slot_reqs)
                           for a, b in zip(r.generated, q.generated)]))
    log_t(f"  paged: {seconds:.1f} s, {m['prefill_chunk_steps']} chunks, "
          f"{m['prefix_hit_tokens']} prefix-hit tokens of "
          f"{sum(len(r.prompt) for r in reqs)}, peak blocks "
          f"{m['peak_blocks_in_use']} of {sched.pool.n_blocks - 1}; K1 "
          f"{launches} launches by route {routes}; share of tokens equal "
          f"to the slot path's {share:.4f}")
    log_t(f"  TTFT p50 / p99 paged {m['ttft_p50_s']:.4f} / "
          f"{m['ttft_p99_s']:.4f} s, slot path {slot_m['ttft_p50_s']:.4f} "
          f"/ {slot_m['ttft_p99_s']:.4f} s; TPOT p50 / p99 paged "
          f"{m['tpot_p50_s'] * 1e3:.2f} / {m['tpot_p99_s'] * 1e3:.2f} ms, "
          f"slot path {slot_m['tpot_p50_s'] * 1e3:.2f} / "
          f"{slot_m['tpot_p99_s'] * 1e3:.2f} ms")
    log_t("  metrics " + json.dumps(m, sort_keys=True))
    log_t("  slot path metrics " + json.dumps(slot_m, sort_keys=True))
    if any(r.result is None or len(r.generated) != NEW_TOKENS
           for r in reqs):
        raise AssertionError("not every paged request finished")
    if m["prefix_hit_tokens"] != PAGED_HITS \
            or m["prefill_chunk_steps"] != PAGED_CHUNKS:
        raise AssertionError(f"prefix hits {m['prefix_hit_tokens']}, chunks "
                             f"{m['prefill_chunk_steps']}: expected "
                             f"{PAGED_HITS} and {PAGED_CHUNKS}")
    if launches != cfg.n_layers * PAGED_CHUNKS or routes["sm90"] != launches:
        raise AssertionError(f"K1 launched {launches} times by route "
                             f"{routes}, expected {cfg.n_layers} x "
                             f"{PAGED_CHUNKS} on sm90")
    forced = [reqs[i] for i in PAGED_FORCED]
    tokens = [r.generated for r in forced]
    got, fsched = paged_forced_logits(eng, forced, tokens, PAGED_CHUNK)
    hits = fsched.metrics.prefix_hit_tokens
    del fsched
    want = forced_logits(eng, forced, tokens, device)
    gap = logit_gap(got, want)
    rows = ((got - want).abs().amax(-1) / want.abs().amax()).tolist()
    log(f"  forced logits of requests {PAGED_FORCED} (prefix-hit tokens "
        f"{hits}), paged against the slot path over {SERVE_FORCED_STEPS} "
        f"decode steps: max |delta| / max |logit| = {gap:.3e}; by request, "
        f"the prefill's last position then each step: "
        + "; ".join(" ".join(f"{g:.2e}" for g in r) for r in rows))
    if hits != PAGED_SYSTEM or not gap <= LOGIT_BAR:
        raise AssertionError(f"forced logits: gap {gap}, hits {hits}")
    del eng, sched, got, want
    free_device()
    return {"launches": launches, "routes": nonzero(routes),
            "metrics": m, "slot_metrics": slot_m, "token_share": share,
            "forced_gap": gap}


def paged_rank_cfg():
    return lm_config("qwen3-14b", PAGED_RANK_DEPTH)


def paged_rank_requests(cfg, device="cuda") -> list:
    return paged_requests(cfg, PAGED_RANK_SYSTEM, PAGED_RANK_SUFFIXES,
                          PAGED_RANK_NEW, device)


def paged_rank_max_len() -> int:
    return paged_max_len(PAGED_RANK_SYSTEM, PAGED_RANK_SUFFIXES,
                         PAGED_RANK_NEW)


def paged_refs(work: str, device="cuda") -> None:
    """(b)'s reference on one rank, plan none, depth PAGED_RANK_DEPTH: the
    trace's tokens through ``PagedScheduler`` and the teacher-forced
    logits on them, written to ``work``."""
    cfg = paged_rank_cfg()
    eng = ServingEngine(lm.init_lm(0, cfg, device=device), cfg,
                        max_len=paged_rank_max_len(), device=device)
    reqs = paged_rank_requests(cfg, device)
    PagedScheduler(eng, max_batch=PAGED_RANK_SLOTS, block_size=PAGED_BLOCK,
                   prefill_chunk=PAGED_RANK_CHUNK).run(reqs)
    tokens = [r.generated for r in reqs]
    logits, _ = paged_forced_logits(
        eng, [reqs[i] for i in PAGED_RANK_FORCED],
        [tokens[i] for i in PAGED_RANK_FORCED], PAGED_RANK_CHUNK)
    torch.save({"tokens": tokens, "logits": logits.cpu()},
               os.path.join(work, "paged_ref.pt"))
    del eng
    free_device()


class PagedLog:
    """Wraps an engine's chunk and decode steps and its argmax, for
    ``expected``: (SP degree, tokens) a chunk, (SP degree, rows) a decode
    step (whose argmax ``serve_contract(decode=)`` counts), the SP degree
    of each argmax outside a decode step (a prompt's first token); the sum
    of ``lm.serve_contract`` over them and the loop's turns, as {kind:
    [calls, bytes]}."""

    def __init__(self, eng):
        self.chunks, self.decodes, self.firsts = [], [], []
        self.decoded = False
        chunk, dec, argmax = eng._chunk, eng._decode, eng.next_tokens

        def chunk_step(tokens, caches, slot, start):
            self.chunks.append((eng.sp_degree, tokens.shape[1]))
            return chunk(tokens, caches, slot, start)

        def decode(token, caches):
            self.decodes.append((eng.sp_degree, token.shape[0]))
            self.decoded = True
            return dec(token, caches)

        def next_tokens(logits):
            if not self.decoded:
                self.firsts.append(eng.sp_degree)
            self.decoded = False
            return argmax(logits)
        eng._chunk, eng._decode, eng.next_tokens = (chunk_step, decode,
                                                    next_tokens)

    def expected(self, cfg, template, plan, ticks: int) -> dict:
        parts = [lm.serve_contract(cfg, n, template, plan, chunk=c)
                 for n, c in self.chunks]
        parts += [lm.serve_contract(cfg, n, template, plan, decode=r)
                  for n, r in self.decodes]
        parts += [lm.serve_contract(cfg, n, template, plan, first_tokens=1)
                  for n in self.firsts]
        parts.append(lm.serve_contract(cfg, 1, template, plan, ticks=ticks))
        self.chunks, self.decodes, self.firsts = [], [], []
        return add_contracts(*parts)


def flatten_blocks(pool) -> dict:
    """The block pool's KV leaves gathered whole on its mesh (not counted:
    the caller resets the counters after)."""
    from repro_torch.parallel.partition import cache_pspecs
    periods = pool.caches["periods"]
    if pool.ctx is not None:
        periods = unshard_params(periods, cache_pspecs(
            periods, pool.plan, paged=True), pool.ctx)
    return {"/".join(p): t.clone() for p, t in
            zip(leaf_paths_of(periods), lm.tree_leaves(periods))}


def paged_rank_main(rank: int, world: int, work: str) -> None:
    """One of (b)'s ranks, started by ``paged_four_ranks`` as
    ``chip_smoke.py --paged-rank <rank> <world> <dir>``: gloo over the
    card's CUDA tensors on a (1, world) mesh, qwen3-14b at depth
    PAGED_RANK_DEPTH under SERVE_RANK_PLAN.  The teacher-forced logits
    against the reference's, then one paged and one slot decode step of
    the forced pool's rows, each counted; the trace through
    ``PagedScheduler`` with the pool asserted on the mesh after every step
    and ``replan(SERVE_REPLAN_TO)`` at the first decode step with a
    prefill mid-prompt (the blocks gathered before and after, the tables
    and ref counts), each segment counted; the forced logits again on the
    survivors.  K1 must launch 0 times (a chunk on a mesh is plain).
    Written to ``<dir>/paged_rank<r>.json``."""
    device = json.load(open(os.path.join(work, "job20.json")))["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
    full_f32()
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "store20b"), world), rank=rank, world_size=world)
    plan = SERVE_RANK_PLAN
    try:
        cfg = paged_rank_cfg()
        ref = torch.load(os.path.join(work, "paged_ref.pt"))
        mesh = make_mesh((1, world), ("data", "model"), device,
                         backend="gloo")
        params = lm.init_lm(0, cfg, device=device)
        template = meta_tree(params)
        eng = ServingEngine(params, cfg, max_len=paged_rank_max_len(),
                            mesh=mesh, plan=plan, device=device)
        del params
        free_device()
        reset_launches()
        steps = PagedLog(eng)
        reqs = paged_rank_requests(cfg, device)
        forced = [reqs[i] for i in PAGED_RANK_FORCED]
        forced_tokens = [ref["tokens"][i] for i in PAGED_RANK_FORCED]
        segments, got = {}, {}
        dsp.reset_calls()
        logits, fsched = paged_forced_logits(eng, forced, forced_tokens,
                                             PAGED_RANK_CHUNK)
        got["forced"] = forced_gap(logits, ref["logits"], eng.sharder)
        segments["forced"] = [counted(), steps.expected(cfg, template, plan,
                                                        0)]
        # a paged and a slot decode step of the same rows, each counted
        token = torch.tensor([[t[0]] for t in forced_tokens], device=device)
        for name, caches in (("paged decode", fsched.pool.caches),
                             ("slot decode", KVPool(
                                 cfg, len(forced), eng.max_len, mesh=mesh,
                                 plan=plan, device=device).caches)):
            eng.next_tokens(eng._decode(token, caches)[0])
            segments[name] = [counted(), steps.expected(cfg, template, plan,
                                                        0)]
        del fsched, logits
        free_device()
        sched = PagedScheduler(eng, max_batch=PAGED_RANK_SLOTS,
                               block_size=PAGED_BLOCK,
                               prefill_chunk=PAGED_RANK_CHUNK)
        seen = {}

        def on_step(s, k):
            s.pool.assert_on_mesh()
            if seen or not s._prefilling:
                return
            pf = s._prefilling[0]
            if not 0 < pf.done < len(pf.prompt):
                return
            segments["before"] = [counted(), steps.expected(
                cfg, template, plan, s.ticks)]
            seen.update(step=k, ticks=s.ticks, done=pf.done)
            before = flatten_blocks(s.pool)
            host = (s.pool.caches["table"].clone(), s.pool.ref.copy(),
                    s.pool.slot_blocks(pf.slot))
            dsp.reset_calls()
            t0 = time.perf_counter()
            s.replan(SERVE_REPLAN_TO)
            torch.cuda.synchronize()
            seen["replan_seconds"] = time.perf_counter() - t0
            segments["migrate"] = [counted(), add_contracts(
                lm.serve_contract(cfg, world, template, plan, paged_migrate=(
                    PAGED_RANK_SLOTS, eng.max_len, PAGED_BLOCK,
                    s.pool.n_blocks, SERVE_REPLAN_TO)))]
            if s.engine.active:
                after = flatten_blocks(s.pool)
                seen["moved_equal"] = all(torch.equal(before[p], after[p])
                                          for p in before)
                seen["host_equal"] = bool(
                    torch.equal(s.pool.caches["table"], host[0])
                    and (s.pool.ref == host[1]).all()
                    and s.pool.slot_blocks(pf.slot) == host[2])
            del before
            dsp.reset_calls()

        t0 = time.perf_counter()
        sched.run(reqs, on_step=on_step)
        torch.cuda.synchronize()
        got.update(seconds=time.perf_counter() - t0, active=eng.active,
                   **{k: v for k, v in seen.items() if k != "ticks"})
        if eng.active:
            segments["after"] = [counted(), steps.expected(
                cfg, template, plan, sched.ticks - seen["ticks"])]
            got["finished"] = all(
                r.result is not None and len(r.generated) == PAGED_RANK_NEW
                for r in reqs)
            got["token_share"] = float(np.mean([
                a == b for r, t in zip(reqs, ref["tokens"])
                for a, b in zip(r.generated, t)]))
            got["metrics"] = sched.metrics.summary()
            dsp.reset_calls()
            logits, fsched = paged_forced_logits(
                eng, [paged_rank_requests(cfg, device)[i]
                      for i in PAGED_RANK_FORCED],
                forced_tokens, PAGED_RANK_CHUNK)
            got["forced_after"] = forced_gap(logits, ref["logits"],
                                             eng.sharder)
            segments["forced after"] = [counted(), steps.expected(
                cfg, template, plan, 0)]
            del fsched, logits
        got["segments"] = segments
        got["k1_launches"] = flash_attention_fwd.launches
        got["host_gib"] = host_state()
        del eng, sched
        free_device()
        json.dump(got, open(os.path.join(work, f"paged_rank{rank}.json"),
                            "w"))
    finally:
        dist.destroy_process_group()


def paged_four_ranks(work: str, device="cuda") -> Part:
    """(b) DSP_RANKS processes sharing the card over gloo at (1,
    DSP_RANKS): the teacher-forced logits within LOGIT_BAR of the one-rank
    reference's before and after ``replan(SERVE_REPLAN_TO)``, which fires
    with a prefill mid-prompt; the moved blocks bit-equal, the tables and
    ref counts untouched; every request finished; per rank each segment's
    calls and bytes exactly ``serve_contract``'s, a paged decode step's
    equal to a slot decode step's; K1 0 launches.  The share of tokens
    equal to the reference's is logged, not gated."""
    with open(os.path.join(work, "job20.json"), "w") as f:
        json.dump({"device": device}, f)
    t0 = time.perf_counter()
    paged_refs(work, device)
    log_t(f"  reference at one rank in {time.perf_counter() - t0:.1f} s "
          f"({elapsed()})")
    t0 = time.perf_counter()
    rcs = yield from ranks_exit("--paged-rank", work)
    log_t(f"  {DSP_RANKS} ranks exited {rcs} after "
          f"{time.perf_counter() - t0:.1f} s")
    if any(rcs):
        raise AssertionError(f"a paged serving rank failed: exit codes "
                             f"{rcs}")
    ranks = [json.load(open(os.path.join(work, f"paged_rank{r}.json")))
             for r in range(DSP_RANKS)]
    for r, got in enumerate(ranks):
        log_t(f"  rank {r}: forced logits' worst row {got['forced']:.3e} "
              f"(after the replan {got.get('forced_after')}); replan at "
              f"decode step {got['step']} with a prefill at {got['done']} "
              f"tokens, {got['replan_seconds']:.3f} s, moved blocks "
              f"bit-equal {got.get('moved_equal')}, tables and ref counts "
              f"unchanged {got.get('host_equal')}; served "
              f"{got['seconds']:.1f} s, still serving {got['active']}, "
              f"share of tokens equal to the reference's "
              f"{got.get('token_share')}; K1 {got['k1_launches']}; host "
              f"GiB {got['host_gib']}")
        if got["active"]:
            log_t(f"  rank {r} metrics " + json.dumps(got["metrics"],
                                                     sort_keys=True))
        for seg, (calls, want) in got["segments"].items():
            log(f"  rank {r} {seg}: calls {calls}; contract {want}")
            if calls != want:
                raise AssertionError(f"rank {r} {seg}: calls {calls}, the "
                                     f"contract says {want}")
        segs = got["segments"]
        if segs["paged decode"][0] != segs["slot decode"][0]:
            raise AssertionError(f"rank {r}: a paged decode step's calls "
                                 f"{segs['paged decode'][0]} differ from a "
                                 f"slot decode step's "
                                 f"{segs['slot decode'][0]}")
        bars = [got["forced"]] + ([got["forced_after"]]
                                  if "forced_after" in got else [])
        if not max(bars) <= LOGIT_BAR:
            raise AssertionError(f"rank {r}: forced logits {bars} past "
                                 f"{LOGIT_BAR}")
        if got["k1_launches"]:
            raise AssertionError(f"rank {r}: K1 launched "
                                 f"{got['k1_launches']} times on a mesh")
        if got["active"] and not (got["finished"] and got["moved_equal"]
                                  and got["host_equal"]):
            raise AssertionError(f"rank {r}: finished {got['finished']}, "
                                 f"moved blocks equal {got['moved_equal']}"
                                 f", host state equal {got['host_equal']}")
    if sum(got["active"] for got in ranks) != SERVE_REPLAN_TO:
        raise AssertionError("replan kept the wrong number of ranks")
    return {"ranks": ranks}


PAGED_CLI = ["--arch", "qwen3-14b", "--batch", "4", "--prompt-len", "16",
             "--new-tokens", "8", "--paged", "--prefill-chunk", "8"]


def paged_clis(serve_main, launched: dict) -> None:
    """Phase 20 (c), run in phase 28: the serve CLI ``--paged
    --prefill-chunk 8`` at SMOKE size on the card (in this process), and
    under ``torchrun --nproc-per-node`` DSP_RANKS with ``--mode dsp
    --backend gloo``: both exit 0, the ranks' tokens one card's."""
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        want = [r.generated for r in serve_main(PAGED_CLI)]
    log(f"  one card: {len(want)} requests served")
    rc, text, err, seconds = finish(launched["20c/paged"])
    got = [json.loads(m) for m in re.findall(r"s: (\[[^\]]*\])", text)]
    log_t(f"  20c/paged: exit {rc} in {seconds:.1f} s; tokens equal to one "
          f"card's {got == want}; " + " ".join(
              line for line in text.splitlines() if line.startswith("paged")))
    if rc or got != want or "KV pool sequence-sharded over 4-way" not in text:
        raise AssertionError(f"serve CLI --paged under torchrun: "
                             f"{text[-2000:]}{err[-3000:]}")


# ---------------------------------------------------------------------------
# Phase 21: the DiT under its spec's own plan (ZeRO-3 over ("data", "model"))
# ---------------------------------------------------------------------------

def t2d_zero_layout(cfg, mesh, device="cuda") -> dict:
    """``cfg``'s parameters from seed 0, modulation perturbed as phase 12's
    training's (``perturb_modulation`` seed 6), under transformer2d-720m's
    own plan on ``mesh``: the whole tree laid out by ``param_pspecs`` and
    cut to this rank's slices (``shard_params``; at one rank each slice
    is the whole leaf), and the whole tree's shapes (``meta_tree``) for
    ``t2d_zero_contract``."""
    plan = transformer2d_720m.SPEC.plan
    ctx = from_mesh(mesh)
    params = perturb_modulation(t2d.init_t2d(0, cfg, device=device), 6)
    specs = param_pspecs(params, plan, axis_sizes=mesh_sizes(ctx))
    return {"params": shard_params(params, specs, ctx), "specs": specs,
            "plan": plan, "meta": meta_tree(params)}


def t2d_zero_contract(cfg, lay: dict, shape, batch: int,
                      frames: int) -> dict:
    """{kind: [calls, bytes]} per rank of one loss of ``cfg`` with remat,
    its grads, their sums and the clip's norm in ``lay``'s layout
    (``t2d_zero_layout``) on a ``shape`` (data, model) mesh at a global
    ``batch`` x ``frames`` x DIT_PATCHES: ``t2d.step_contract`` (the
    planned all-to-alls three times over plus ``t2d.param_contract``)."""
    step = t2d.step_contract(cfg, lay["meta"], lay["plan"],
                             {"data": shape[0], "model": shape[1]},
                             batch=batch, frames=frames, patches=DIT_PATCHES)
    return {k: [c, step["bytes"][k]] for k, c in step["calls"].items()}


def t2d_first_step(cfg, mesh, lay=None, device="cuda"):
    """Phase 13's first step's loss and grads (its init, its first batch
    at DIT_BATCH x DIT_FRAMES x DIT_PATCHES, remat group
    DIT_REMAT_GROUP), summed by ``allreduce_grads``: on the whole
    parameters over the world (``lay`` None, phase 13's path), or on
    ``lay``'s slices (``t2d_zero_layout``), each grad over the dims its
    leaf is not split over.  Returns (loss, [grad leaves])."""
    if lay is None:
        params = perturb_modulation(t2d.init_t2d(0, cfg, device=device), 6)
        specs = ctx = None
    else:
        params, specs, ctx = lay.pop("params"), lay["specs"], from_mesh(mesh)
    leaves = lm.tree_map(lambda p: p.detach().requires_grad_(True), params)
    del params
    batch = t2d.shard_video_batch(dit_batch(cfg, DIT_FRAMES, 0, device), mesh)
    loss, _ = t2d.t2d_loss(leaves, batch, cfg, backend="kernel",
                           remat_group=DIT_REMAT_GROUP, mesh=mesh,
                           param_specs=specs)
    grads = iter(torch.autograd.grad(loss, lm.tree_leaves(leaves)))
    loss, grads = allreduce_grads(loss.detach(), lm.tree_map(
        lambda p: next(grads), leaves), specs, ctx)
    return loss, lm.tree_leaves(grads)


def t2d_zero_rank_cfg():
    """(b)'s model: transformer2d-720m at full width, depth T2D_ZERO_DEPTH,
    in float32."""
    return dataclasses.replace(transformer2d_720m.CONFIG,
                               n_layers=T2D_ZERO_DEPTH, dtype=torch.float32)


def t2d_zero_batch(cfg, step: int, device="cuda") -> dict:
    """(b)'s global batch of step ``step``: T2D_ZERO_BATCH x
    T2D_ZERO_FRAMES x DIT_PATCHES, the same on every rank."""
    dcfg = DataConfig(task="video", batch=T2D_ZERO_BATCH,
                      temporal=T2D_ZERO_FRAMES, spatial=DIT_PATCHES,
                      in_dim=cfg.in_dim)
    return t2d.model_dtype_batch(make_batch(dcfg, step, device=device), cfg)


def t2d_zero_world_of_one(cfg, phase13: dict, work: str,
                          device="cuda") -> dict:
    """(a) At world size 1 on a (1, 1) mesh over NCCL, phase 13's training
    under transformer2d-720m's own plan: the parameters and AdamW's state
    in the ZeRO-3 layout (each slice the whole leaf, each gather a copy).
    The first step's loss and every grad must equal phase 13's path's bit
    for bit; then DIT_STEPS steps through the Trainer, whose calls and
    bytes must be exactly ``t2d_zero_contract`` a step, whose K1 launches
    must be phase 13's (224, all DIT_ROUTE at head dim 72), and whose
    losses must equal phase 13's: bit for bit, or, where the clip's norm
    from slices (``slices_norm``) sums in another order than
    ``apply_adamw``'s (the grad norms then differ, and the log shows
    them), within T2D_ZERO_LOSS_BAR relative.  Step time and peak memory
    are logged beside phase 13's.  Then (b)'s reference: one rank without
    ZeRO or mesh, ``t2d_zero_rank_cfg`` on the first
    ``t2d_zero_batch``, its loss and grads written to ``work``.  What
    earlier phases still hold on the card is logged first: the peaks
    count it."""
    free_device()
    held = torch.cuda.memory_allocated() / 1e9
    log(f"  held on the card before the phase: {held:.2f} GB")
    backend = BACKEND_OF[torch.device(device).type]
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(work, "store21a"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), torch.device(device).type)
        ref_loss, ref_grads = t2d_first_step(cfg, mesh, device=device)
        lay = t2d_zero_layout(cfg, mesh, device)
        loss, grads = t2d_first_step(cfg, mesh, lay, device)
        same = [torch.equal(a.float(), b.float())
                for a, b in zip(grads, ref_grads)]
        log_t(f"  first step: loss {float(loss):.9f} against phase 13's "
              f"path's {float(ref_loss):.9f}, bit-equal "
              f"{torch.equal(loss, ref_loss)}; grads bit-equal in "
              f"{sum(same)} of {len(same)} leaves")
        if not (torch.equal(loss, ref_loss) and all(same)):
            raise AssertionError("the ZeRO-3 first step differs from phase "
                                 "13's path")
        del grads, ref_grads, lay
        torch.cuda.empty_cache()
        lay = t2d_zero_layout(cfg, mesh, device)
        specs = lay["specs"]
        contract = t2d_zero_contract(cfg, lay, (1, 1), DIT_BATCH,
                                     DIT_FRAMES)
        want = {k: [c * DIT_STEPS, b * DIT_STEPS]
                for k, (c, b) in contract.items()}
        log(f"  plan {lay['plan']}; per step the contract [count, bytes] "
            f"{contract}")
        trained = run_trainer(
            lambda: lay.pop("params"),
            lambda p, b: t2d.t2d_loss(p, b, cfg, backend="kernel",
                                      remat_group=DIT_REMAT_GROUP, mesh=mesh,
                                      param_specs=specs),
            lambda st: t2d.shard_video_batch(
                dit_batch(cfg, DIT_FRAMES, st, device), mesh),
            flash_attention_fwd, tokens=DIT_BATCH * DIT_FRAMES * DIT_PATCHES,
            n_steps=DIT_STEPS, n_layers=cfg.n_layers, route=DIT_ROUTE,
            device=device, mesh=mesh, param_specs=specs)
        dims = nonzero(flash_attention_fwd.head_dim_launches)
        if dims != {cfg.dh: trained["launches"]}:
            raise AssertionError(f"K1 launches by head dim {dims}")
        got = {k: [trained["collectives"][k], trained["volume"][k]]
               for k in sorted(trained["collectives"])}
        log(f"  torch.distributed calls [count, bytes]: {got}")
        if got != want:
            raise AssertionError(f"collectives {got}, the contract says "
                                 f"{want}")
        met, ref = trained["metrics"], phase13["metrics"]
        bit = met["losses"] == ref["losses"]
        norms = met["grad_norms"] == ref["grad_norms"]
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(met["losses"], ref["losses"]))
        log_t(f"  losses {met['losses']} against phase 13's "
              f"{ref['losses']}: bit-equal {bit}, worst |delta| / |loss| "
              f"{rel:.3e}; grad norms {met['grad_norms']} against "
              f"{ref['grad_norms']}: bit-equal {norms}; step (median) "
              f"{met['step_ms_median']:.2f} ms against phase 13's "
              f"{ref['step_ms_median']:.2f} ms; peak "
              f"{met['peak_memory_gb']:.2f} GB ({held:.2f} GB of it held "
              f"before the phase) against {ref['peak_memory_gb']:.2f} GB")
        if not (bit or (rel <= T2D_ZERO_LOSS_BAR and not norms)):
            raise AssertionError(f"ZeRO-3 losses {met['losses']} differ "
                                 f"from phase 13's {ref['losses']}")
        del lay
        torch.cuda.empty_cache()
        rcfg = t2d_zero_rank_cfg()
        leaves = lm.tree_map(lambda p: p.requires_grad_(True),
                             perturb_modulation(t2d.init_t2d(
                                 0, rcfg, device=device), 6))
        loss, _ = t2d.t2d_loss(leaves, t2d_zero_batch(rcfg, 0, device), rcfg,
                               backend="kernel")
        grads = torch.autograd.grad(loss, lm.tree_leaves(leaves))
        loss = loss.detach()
        norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        torch.save({"loss": loss.cpu(), "norm": norm.cpu(),
                    "grads": [g.cpu() for g in grads]},
                   os.path.join(work, "t2d_zero_ref.pt"))
        log_t(f"  reference of (b): depth {rcfg.n_layers} in float32, "
              f"{T2D_ZERO_BATCH} x {T2D_ZERO_FRAMES} x {DIT_PATCHES}, one "
              f"rank without ZeRO: loss {float(loss):.9f}, grad norm "
              f"{float(norm):.6f}")
        del leaves, grads
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return {**trained, "contract": contract, "bit_equal": bit,
            "held_gb": held}


def t2d_zero_trainer(cfg, lay: dict, mesh, ckpt_dir: str,
                     device="cuda") -> Trainer:
    """A one-step Trainer of (b)'s ``cfg`` on ``lay``'s slices on
    ``mesh``, checkpointing into ``ckpt_dir``."""
    specs = lay["specs"]
    return Trainer(
        loss_fn=lambda p, b: t2d.t2d_loss(p, b, cfg, backend="kernel",
                                          mesh=mesh, param_specs=specs),
        params=lay.pop("params"),
        opt_cfg=OptConfig(peak_lr=3e-4, warmup_steps=2, total_steps=2),
        cfg=TrainerConfig(total_steps=1, log_every=1),
        data_fn=lambda st: t2d.shard_video_batch(
            t2d_zero_batch(cfg, st, device), mesh),
        ckpt_dir=ckpt_dir, device=device, mesh=mesh, param_specs=specs)


def t2d_zero_ckpt(cfg, work: str, device="cuda") -> dict:
    """(b)'s checkpoint: one Trainer step of ``cfg`` on its (2, 2) slices,
    saved by the ranks into ``<work>/ck21``; the saved state moved to its
    (1, 4) slices by the (2, 2) mesh's own gathers (``reshard``: one whole
    leaf at a time, not through the checkpoint); a fresh Trainer at (1, 4)
    that ``try_resume``s, whose state must equal those slices bit for
    bit."""
    ckdir = os.path.join(work, "ck21")
    meshes = {shape: make_mesh(shape, ("data", "model"),
                               torch.device(device).type, backend="gloo")
              for shape in ((2, 2), (1, 4))}
    first = t2d_zero_trainer(cfg, t2d_zero_layout(cfg, meshes[2, 2], device),
                             meshes[2, 2], ckdir, device)
    first.run()
    out = {"save": dict(first.ckpt.last_save)}
    second = t2d_zero_trainer(cfg, t2d_zero_layout(cfg, meshes[1, 4],
                                                   device),
                              meshes[1, 4], ckdir, device)
    want = state_bits(reshard(first._state(), first._state_specs(),
                              first.ctx, second._state_specs(), second.ctx))
    del first
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    second.try_resume()
    torch.cuda.synchronize()
    out.update(restore_s=time.perf_counter() - t0,
               start_step=second.start_step,
               restored_equal=same_bits(state_bits(second._state()), want))
    del second, want
    torch.cuda.empty_cache()
    return out


def t2d_zero_rank_main(rank: int, world: int, work: str) -> None:
    """One of (b)'s ranks, started by ``t2d_zero_four_ranks`` as
    ``chip_smoke.py --t2d-zero-rank <rank> <world> <dir>``: gloo over the
    card's tensors.  At each mesh of T2D_ZERO_MESHES: ``t2d_zero_rank_cfg``
    on its slices (``t2d_zero_layout``), one ``t2d_loss(param_specs=)`` on
    its shard of the first ``t2d_zero_batch`` with its grads summed by
    ``allreduce_grads`` and the clip's norm (``slices_norm``), what it
    counted and its peak memory; each grad slice held against the same
    slice of (a)'s reference (``slice_gap``), each leaf's gap the largest
    over the ranks.  Then ``t2d_zero_ckpt``.  Written to
    ``<dir>/t2d_zero_rank<r>.json``."""
    device = json.load(open(os.path.join(work, "job21.json")))["device"]
    full_f32()
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "store21b"), world), rank=rank, world_size=world)
    try:
        cfg = t2d_zero_rank_cfg()
        ref = torch.load(os.path.join(work, "t2d_zero_ref.pt"), mmap=True)
        res = {}
        for shape in T2D_ZERO_MESHES:
            mesh = make_mesh(shape, ("data", "model"),
                             torch.device(device).type, backend="gloo")
            ctx = from_mesh(mesh)
            lay = t2d_zero_layout(cfg, mesh, device)
            specs = lay["specs"]
            leaves = lm.tree_map(lambda p: p.requires_grad_(True),
                                 lay.pop("params"))
            batch = t2d.shard_video_batch(t2d_zero_batch(cfg, 0, device),
                                          mesh)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            loss, _ = t2d.t2d_loss(leaves, batch, cfg, backend="kernel",
                                   mesh=mesh, param_specs=specs)
            grads = iter(torch.autograd.grad(loss, lm.tree_leaves(leaves)))
            loss, grads = allreduce_grads(loss.detach(), lm.tree_map(
                lambda p: next(grads), leaves), specs, ctx)
            norm = slices_norm(grads, specs, ctx)
            got = read_counts()
            got.update(seconds=time.perf_counter() - t0,
                       coord=[ctx.dp_index, ctx.sp_index],
                       contract=t2d_zero_contract(
                           cfg, lay, shape, T2D_ZERO_BATCH, T2D_ZERO_FRAMES),
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            gaps = torch.tensor([slice_gap(g, w[tuple(
                slice(a, b) for a, b in slice_index(w.shape, spec, ctx))])
                for g, w, spec in zip(lm.tree_leaves(grads), ref["grads"],
                                      lm.tree_leaves(specs))],
                dtype=torch.float64)
            dist.all_reduce(gaps, op=dist.ReduceOp.MAX)
            shares = (gaps[:, 0] / gaps[:, 1].clamp_min(1e-30)).tolist()
            worst = int(np.argmax(shares))
            got.update(
                loss=float(loss), loss_rel=float(
                    (loss.cpu() - ref["loss"]).abs() / ref["loss"].abs()),
                norm=float(norm), norm_rel=float(
                    (norm.cpu() - ref["norm"]).abs() / ref["norm"]),
                grad_rel=shares[worst], leaves=len(shares),
                leaf=leaf_paths(specs)[worst], host_gib=host_state())
            res[f"{shape[0]}x{shape[1]}"] = got
            del leaves, grads, lay
            host_empty_cache()
            torch.cuda.empty_cache()
        del ref
        t0 = time.perf_counter()
        res["ckpt"] = t2d_zero_ckpt(cfg, work, device)
        res["ckpt"]["seconds"] = time.perf_counter() - t0
        res["host_gib"] = host_state()
        json.dump(res, open(os.path.join(work, f"t2d_zero_rank{rank}.json"),
                            "w"))
    finally:
        dist.destroy_process_group()


def t2d_zero_four_ranks(work: str, device="cuda") -> Part:
    """(b) DSP_RANKS processes sharing the card over gloo
    (``t2d_zero_rank_main``), ``t2d_zero_rank_cfg`` in float32, so that
    only the order of the sums differs from one rank: at each mesh of
    T2D_ZERO_MESHES the loss and the clip's norm within T2D_ZERO_LOSS_BAR
    relative of (a)'s one-rank reference, each rank's slice of every
    grad within T2D_ZERO_GRAD_BAR of its leaf's max; per rank exactly the
    contract's calls and bytes and 2 K1 launches a block (forward and
    recompute; f32 takes ``ROUTES``' ``cuda_cores``); each rank's peak
    memory logged; the (2, 2) checkpoint restored at (1, 4) bit-equal."""
    with open(os.path.join(work, "job21.json"), "w") as f:
        json.dump({"device": device}, f)
    t0 = time.perf_counter()
    rcs = yield from ranks_exit("--t2d-zero-rank", work)
    log_t(f"  {DSP_RANKS} ranks exited {rcs} after "
          f"{time.perf_counter() - t0:.1f} s")
    if any(rcs):
        raise AssertionError(f"a ZeRO DiT rank failed: exit codes {rcs}")
    ranks = [json.load(open(os.path.join(work, f"t2d_zero_rank{r}.json")))
             for r in range(DSP_RANKS)]
    cfg = t2d_zero_rank_cfg()
    route = ROUTES[(cfg.dtype, cfg.dh)]
    k1 = 2 * cfg.n_layers
    for shape in T2D_ZERO_MESHES:
        label = f"{shape[0]}x{shape[1]}"
        g = ranks[0][label]
        log_t(f"  {label}: depth {cfg.n_layers} in float32, "
              f"{T2D_ZERO_BATCH} x {T2D_ZERO_FRAMES} x {DIT_PATCHES}: loss "
              f"{g['loss']:.9f}, |delta| / |loss| against one rank "
              f"{g['loss_rel']:.3e}, grad norm {g['norm']:.6f} "
              f"({g['norm_rel']:.3e}), worst grad slice {g['leaf']} "
              f"{g['grad_rel']:.3e} of its leaf's max over {g['leaves']} "
              f"leaves; per rank the contract {g['contract']}")
        if not (g["grad_rel"] <= T2D_ZERO_GRAD_BAR
                and g["norm_rel"] <= T2D_ZERO_LOSS_BAR):
            raise AssertionError(f"{label}: the {DSP_RANKS}-rank grads or "
                                 f"norm disagree with one rank: {g}")
        for r, res in enumerate(ranks):
            got = res[label]
            log_t(f"  rank {r} (data {got['coord'][0]}, model "
                  f"{got['coord'][1]}): {got['seconds']:.1f} s, peak "
                  f"{got['peak_gb']:.2f} GB, calls {got['calls']}, K1 "
                  f"{got['k1']} {got['k1_routes']}; host GiB "
                  f"{got['host_gib']}")
            if not (got["loss_rel"] <= T2D_ZERO_LOSS_BAR
                    and got["calls"] == got["contract"] and got["k1"] == k1
                    and got["k1_routes"] == {route: k1}):
                raise AssertionError(f"rank {r} {label}: {got}, the contract "
                                     f"says {got['contract']} and {k1} K1 "
                                     f"launches on {route}")
    for r, res in enumerate(ranks):
        ck = res["ckpt"]
        log_t(f"  rank {r}: saved at (2, 2) {ck['save']['bytes']} B (write "
              f"{ck['save']['write_s']:.3f} s, snapshot "
              f"{ck['save']['snapshot_s']:.3f} s, publish "
              f"{ck['save']['publish_s']:.3f} s); restored at (1, 4) step "
              f"{ck['start_step']} in {ck['restore_s']:.3f} s, bit-equal "
              f"{ck['restored_equal']}; {ck['seconds']:.1f} s; host GiB "
              f"{res['host_gib']}")
        if not (ck["restored_equal"] and ck["start_step"] == 1):
            raise AssertionError(f"rank {r}: the (2, 2) checkpoint did not "
                                 f"come back at (1, 4): {ck}")
    return {"ranks": ranks, "k1": k1}


# ---------------------------------------------------------------------------
# Phase 22: starcoder2-7b, gemma2-2b and qwen2-moe-a2.7b on one card
# ---------------------------------------------------------------------------

def model_cfg(name: str, depth=None, dtype=None):
    cfg = {"starcoder2-7b": starcoder2_7b.CONFIG,
           "gemma2-2b": gemma2_2b.CONFIG,
           "qwen2-moe-a2.7b": qwen2_moe_a2_7b.CONFIG}[name]
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


@contextlib.contextmanager
def moe_calls(replay=None):
    """While open, records each MoE call of the model in call order, as a
    dict: ``experts``, the (B, S, K) experts its router picks
    (``models.moe._route``); ``dropped``, the share of dropped pairs its
    aux reports (``models.moe.moe_gather``, a rank's share on a mesh);
    and ``layer``, the data pointer of its router's weight, which names
    its layer in every path over the same parameters.  With ``replay``
    (``layer_routes`` of an earlier record, or a list of experts in call
    order, for paths that call each layer more than once) each call takes
    that record's experts for its layer (its place) instead of its own
    top-k, its gate values read from its own router probabilities at
    those experts, and ``differ`` counts the pairs on which its own pick
    differs: two paths compared so route alike, which top-k, not being
    continuous, does not promise."""
    calls = []
    route, gather = moe._route, moe.moe_gather

    def recorded_route(p, x, meta, norm_topk):
        probs, vals, idx = route(p, x, meta, norm_topk)
        layer = p["router"]["w"].data_ptr()
        call = {"layer": layer, "experts": idx.detach().cpu()}
        if replay is not None:
            want = (replay[len(calls)] if isinstance(replay, list)
                    else replay[layer]).to(idx.device)
            call["differ"] = int((~(idx[..., :, None]
                                    == want[..., None, :]).any(-1)).sum())
            idx, vals = want, probs.gather(-1, want)
            if norm_topk:                           # as ``moe._route``
                vals = vals / (vals.sum(-1, keepdim=True) + 1e-9)
        calls.append(call)
        return probs, vals, idx

    def recorded_gather(*args, **kwargs):
        y, aux = gather(*args, **kwargs)
        calls[-1]["dropped"] = float(aux["dropped"])
        return y, aux

    moe._route, moe.moe_gather = recorded_route, recorded_gather
    try:
        yield calls
    finally:
        moe._route, moe.moe_gather = route, gather


def layer_routes(calls) -> dict:
    """``moe_calls``' record as a replay table: layer -> experts."""
    return {c["layer"]: c["experts"] for c in calls}


def route_disagreement(got: list, want: list) -> float:
    """The share of (token, k) routes whose expert one path picks and the
    other does not, over every MoE call of two ``moe_calls`` records."""
    differ = total = 0
    for g, w in zip(got, want):
        same = (g["experts"][..., :, None]
                == w["experts"][..., None, :]).any(-1)
        differ += int((~same).sum())
        total += same.numel()
    return differ / max(total, 1)


def lm_capacity(cfg, seq: int) -> int:
    """The expert capacity of ``cfg``'s MoE layers at a row of ``seq``
    tokens: ``lm`` calls ``moe.moe`` with its default capacity factor,
    which the gather dispatch raises to at least 2."""
    meta = lm.moe_meta(cfg)
    return moe._capacity(seq, meta.top_k, meta.e_phys, 2.0)


def kept_pairs(experts: torch.Tensor, e_phys: int, cap: int) -> torch.Tensor:
    """The (B, S, K) pairs of a whole batch's routing ``experts`` that
    their experts keep: a pair's slot is the count of its row's pairs
    before it (token-major, then k) on its expert, and a slot past
    ``cap`` is dropped (JAX's ``moe`` semantics, counted here with one-hot
    sums, apart from the port's sort)."""
    b, s, k = experts.shape
    flat = experts.reshape(b, s * k, 1).long()
    hot = F.one_hot(flat[..., 0], e_phys)
    slot = (hot.cumsum(1) - hot).gather(-1, flat)[..., 0]
    return (slot < cap).reshape(b, s, k)


def route_rows(routes, e_phys: int, cap: int, dp: int, n: int,
               dp_index: int, seq_index: int):
    """From the GLOBAL routing of some MoE calls (each the experts (B, S,
    K) of a whole batch), the rows the rank at (``dp_index``,
    ``seq_index``) of a (dp, n) mesh with ``ep`` receives in their
    dispatches (kept pairs of its data slice's rows on its experts) and
    gets back in their combines (its own tokens' kept pairs):
    ``lm.collective_contract``'s ``moe_rows``."""
    received = returned = 0
    el = e_phys // n
    for experts in routes:
        kept = kept_pairs(experts, e_phys, cap)
        bl, sl = experts.shape[0] // dp, experts.shape[1] // n
        rows = slice(dp_index * bl, (dp_index + 1) * bl)
        e, k = experts[rows], kept[rows]
        received += int((k & (e // el == seq_index)).sum())
        returned += int(k[:, seq_index * sl:(seq_index + 1) * sl].sum())
    return received, returned


def moe_depth2_checks(cfg, device="cuda") -> dict:
    """Depth-2 ``cfg`` (qwen2-moe-a2.7b), the kernel against the plain
    path: in bf16 the last-position prefill logits at the longest and
    shortest prompts (phase 5's bar), each path routing itself; then, at 1
    x TRAIN_SEQ, ``lm_loss`` with each path routing itself (phase 7's loss
    bar), and ``lm_loss`` and every grad with the plain path's routing
    replayed in the kernel path (``moe_calls``; phase 7's bars): top-k is
    not continuous, so where the paths' roundings pick another expert for
    a pair, that pair's whole contribution moves from one expert's grad to
    another's.  Then the same in float32, each path routing itself.  The
    share of (token, k) routes on which the two paths' own picks differ
    is logged for each."""
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = lm.init_lm(0, cfg2, device=device)
    g = torch.Generator(device=device).manual_seed(2)
    out = {}
    for s in (max(PROMPT_LENS), min(PROMPT_LENS)):
        tok = torch.randint(0, cfg.vocab, (1, s), generator=g, device=device)
        logits, routes = {}, {}
        with torch.no_grad():
            for backend in ("kernel", "ref"):
                with moe_calls() as routes[backend]:
                    logits[backend] = lm.forward_prefill(
                        params, tok, cfg2, backend=backend)[0]
        gap = logit_gap(logits["kernel"], logits["ref"])
        share = route_disagreement(routes["kernel"], routes["ref"])
        log(f"  depth-2 prefill logits at {s} tokens: max |kernel - plain| "
            f"/ max |logit| = {gap:.3e}; routes that differ {share:.3e}")
        if not gap <= LOGIT_BAR:
            raise AssertionError(f"depth-2 prefill logits disagree at {s} "
                                 f"tokens: {gap}")
        out[f"prefill_{s}"] = {"gap": gap, "routes_differ": share}
    batch = make_batch(DataConfig(task="lm_random", vocab=cfg.vocab,
                                  seq=TRAIN_SEQ, batch=1), 0, device=device)
    for dtype in (torch.bfloat16, torch.float32):
        cfg_d = dataclasses.replace(cfg2, dtype=dtype)
        if dtype == torch.float32:              # the same weights, widened
            params = lm.tree_map(lambda p: p.float(), params)
        losses, routes = {}, {}
        with torch.no_grad():
            for b in ("kernel", "ref"):
                with moe_calls() as routes[b]:
                    losses[b] = lm.lm_loss(params, batch, cfg_d,
                                           backend=b)[0]
        share = route_disagreement(routes["kernel"], routes["ref"])
        own = float((losses["kernel"] - losses["ref"]).abs()
                    / losses["ref"].abs())
        name = str(dtype).split(".")[-1]
        replay = (layer_routes(routes["ref"]) if dtype == torch.bfloat16
                  else None)
        with moe_calls(replay) as calls:
            gap = loss_grads_gap(params, batch, cfg_d)
        replayed = "routing replayed" if replay else "own routing"
        log(f"  {name}: depth-2 loss {gap['loss']:.6f}: each path routing "
            f"itself |kernel - plain| / |loss| = {own:.3e}, routes that "
            f"differ {share:.3e}; {replayed} over {len(calls)} MoE calls "
            f"|kernel - plain| / |loss| = {gap['loss_rel']:.3e}, worst "
            f"grad leaf {gap['leaf']} max |delta| / max |plain| = "
            f"{gap['grad_rel']:.3e} over {gap['leaves']} leaves")
        if not (own <= LOSS_BAR and gap_passes(gap)):
            raise AssertionError(f"depth-2 {name} loss or grads disagree: "
                                 f"{own}, {gap}")
        out[f"loss/{name}"] = {**gap, "loss_rel_own_routing": own,
                               "routes_differ": share,
                               "routing_replayed": replay is not None}
    del params
    free_device()
    return out


def models_on_one_card(device="cuda") -> dict:
    """(a) starcoder2-7b: depth-2 prefill logits kernel against plain, then
    full depth behind the scheduler (MODEL_REQUESTS requests over
    STARCODER_LENS, MODEL_NEW_TOKENS new tokens), K1 once a layer a
    prefill on ``sm90``.  (b) gemma2-2b the same over GEMMA_LENS, one
    prompt past its window, K1 on ``cuda_cores`` (D 256).  (c)
    qwen2-moe-a2.7b: ``moe_depth2_checks``, phase 5's trace at full depth,
    and MOE_TRAIN_STEPS Trainer steps at depth MOE_TRAIN_DEPTH."""
    out = {}
    log("  (a) starcoder2-7b")
    cfg = model_cfg("starcoder2-7b")
    full_width_prefill_check(cfg, (max(STARCODER_LENS), min(STARCODER_LENS)))
    out["starcoder2-7b"] = full_width_serve(
        cfg, flash_attention_fwd, lens=STARCODER_LENS,
        new_tokens=MODEL_NEW_TOKENS)
    log(f"  (b) gemma2-2b ({elapsed()})")
    cfg = model_cfg("gemma2-2b")
    full_width_prefill_check(cfg, (GEMMA_LONG, min(GEMMA_LENS)))
    out["gemma2-2b"] = full_width_serve(
        cfg, flash_attention_fwd, lens=GEMMA_LENS,
        new_tokens=MODEL_NEW_TOKENS, route=ROUTES[(torch.bfloat16, 256)])
    log(f"  (c) qwen2-moe-a2.7b ({elapsed()})")
    cfg = model_cfg("qwen2-moe-a2.7b")
    out["qwen2-moe-a2.7b/checks"] = moe_depth2_checks(cfg, device)
    out["qwen2-moe-a2.7b"] = full_width_serve(cfg, flash_attention_fwd)
    log(f"  training at depth {MOE_TRAIN_DEPTH}, {MOE_TRAIN_STEPS} steps "
        f"at 1 x {TRAIN_SEQ} ({elapsed()})")
    out["qwen2-moe-a2.7b/train"] = trained = full_width_train(
        model_cfg("qwen2-moe-a2.7b", MOE_TRAIN_DEPTH), flash_attention_fwd,
        1, MOE_TRAIN_STEPS)
    log(f"  dropped share of (token, k) pairs per step "
        f"{trained['metrics']['dropped']}")
    free_device()
    return out


# ---------------------------------------------------------------------------
# Phase 23: MoE under DSP, with ep, on a (data, model) mesh
# ---------------------------------------------------------------------------

MOE_PLAN = qwen2_moe_a2_7b.SPEC.plan


def moe_layout(cfg, mesh, batch: int, seq: int, device="cuda",
               plan=None, init=None) -> dict:
    """``cfg``'s parameters from seed 0 (``init(cfg, device)``, by default
    ``lm.init_lm``'s) under ``plan`` (MOE_PLAN by default) on ``mesh``: the
    rank's slices, the specs, the sharder of the joint planned schedule at
    ``batch`` x ``seq`` and the layouts' contract."""
    plan = MOE_PLAN if plan is None else plan
    ctx = from_mesh(mesh)
    sizes = mesh_sizes(ctx)
    params = (init(cfg, device) if init is not None
              else lm.init_lm(0, cfg, device=device))
    specs = param_pspecs(params, plan, axis_sizes=sizes)
    layout = lm.param_contract(cfg, meta_tree(params), plan, sizes)
    sharder = make_sharder(mesh, plan, schedule=lm.dsp_schedule(
        cfg, ctx.sp_size, seq=seq, batch=batch, joint=True),
        param_specs=specs)
    return {"params": shard_params(params, specs, ctx), "specs": specs,
            "sharder": sharder, "layout": layout}


def moe_world_of_one(phase22: dict, work: str, device="cuda") -> dict:
    """(a) At world size 1 on a (1, 1) mesh over NCCL: phase 22 (c)'s
    training under the spec's own plan (``dsp``, ``ep``, ZeRO-3, the vocab
    ring), the losses within DSP_LOSS_BAR of phase 22's, the calls and
    bytes exactly ``zero_contract`` each step (the dispatch's rows the
    step's kept pairs in phase 22, from its dropped share), K1 as in phase
    22, all on ``sm90``; the dropped shares equal phase 22's step by step.
    Then (b)'s reference: depth MOE_RANK_DEPTH in float32 at
    MOE_RANK_BATCH x MOE_RANK_SEQ, plan none, its loss, grads, dropped
    share and routing, written to ``work``."""
    backend = BACKEND_OF[torch.device(device).type]
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(work, "store23a"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), torch.device(device).type)
        cfg = model_cfg("qwen2-moe-a2.7b", MOE_TRAIN_DEPTH)
        lay = moe_layout(cfg, mesh, 1, TRAIN_SEQ, device)
        sharder = lay["sharder"]
        trained = run_trainer(
            lambda: lay.pop("params"),
            lambda p, b: lm.lm_loss(p, b, cfg, sharder=sharder,
                                    backend="kernel"),
            lambda st: lm.shard_lm_batch(lm_batch(cfg, 1, st, device),
                                         sharder),
            flash_attention_fwd, tokens=TRAIN_SEQ, n_steps=MOE_TRAIN_STEPS,
            n_layers=cfg.n_layers, route="sm90", device=device,
            sharder=sharder)
        met = trained["metrics"]
        ref = phase22["qwen2-moe-a2.7b/train"]["metrics"]
        if met["dropped"] != ref["dropped"]:
            raise AssertionError(f"qwen2-moe under {MOE_PLAN} dropped "
                                 f"{met['dropped']}, phase 22 "
                                 f"{ref['dropped']}")
        # the dispatch's rows from phase 22's kept pairs, counted there
        # with no mesh and no exchange: at world 1 every kept pair goes to
        # the one rank and comes back
        pairs = lm.n_moe_layers(cfg) * TRAIN_SEQ * cfg.top_k
        want = {}
        for dropped in ref["dropped"]:
            kept = pairs - round(dropped * pairs)
            step = zero_contract(cfg, (1, 1), 1, lay["layout"],
                                 rows=(kept, kept))
            for k, (c, b) in step.items():
                have = want.setdefault(k, [0, 0])
                have[0] += c
                have[1] += b
        got = {k: [trained["collectives"][k], trained["volume"][k]]
               for k in sorted(trained["collectives"])}
        log(f"  torch.distributed calls [count, bytes]: {got}; the contract "
            f"{want}")
        if got != want:
            raise AssertionError(f"qwen2-moe under {MOE_PLAN}: collectives "
                                 f"{got}, the contract says {want}")
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(met["losses"], ref["losses"]))
        log_t(f"  losses {met['losses']} against phase 22's "
              f"{ref['losses']}: worst |delta| / |loss| = {rel:.3e}; "
              f"dropped {met['dropped']} against {ref['dropped']}; step "
              f"(median) {met['step_ms_median']:.2f} ms against "
              f"{ref['step_ms_median']:.2f} ms; peak "
              f"{met['peak_memory_gb']:.2f} GB against "
              f"{ref['peak_memory_gb']:.2f} GB")
        if not rel <= DSP_LOSS_BAR:
            raise AssertionError(f"qwen2-moe losses {met['losses']} differ "
                                 f"from phase 22's")
        del lay
        free_device()
        moe_rank_ref(work, device)
    finally:
        dist.destroy_process_group()
    return trained


def moe_rank_cfg():
    return dataclasses.replace(
        model_cfg("qwen2-moe-a2.7b", MOE_RANK_DEPTH, torch.float32),
        vocab=MOE_RANK_VOCAB)


def moe_rank_batch(cfg, device="cuda") -> dict:
    return make_batch(DataConfig(task="lm_shift", vocab=cfg.vocab,
                                 seq=MOE_RANK_SEQ, batch=MOE_RANK_BATCH), 0,
                      device=device)


def moe_rank_ref(work: str, device="cuda") -> None:
    """(b)'s reference on one rank without a mesh: ``moe_rank_cfg``'s loss,
    grads (float32), dropped share and routing on ``moe_rank_batch``,
    written to ``work/moe_ref.pt``."""
    cfg = moe_rank_cfg()
    params = lm.init_lm(0, cfg, device=device)
    leaves = lm.tree_map(lambda p: p.requires_grad_(True), params)
    batch = moe_rank_batch(cfg, device)
    with torch.no_grad(), moe_calls() as calls:
        lm.forward(params, batch["tokens"], cfg, backend="kernel",
                   remat=False)
    loss, metrics = lm.lm_loss(leaves, batch, cfg, backend="kernel")
    grads = torch.autograd.grad(loss, lm.tree_leaves(leaves))
    torch.save({"loss": loss.detach().cpu(),
                "dropped": float(metrics["moe_dropped"]),
                "routes": [c["experts"] for c in calls],
                "call_dropped": [c["dropped"] for c in calls],
                "grads": [g.cpu() for g in grads]},
               os.path.join(work, "moe_ref.pt"))
    log_t(f"  reference: depth {cfg.n_layers} in float32, {MOE_RANK_BATCH} "
          f"x {MOE_RANK_SEQ}: loss {float(loss.detach()):.6f}, dropped "
          f"share {float(metrics['moe_dropped']):.6f}")
    del params, leaves, grads
    free_device()


def moe_rank_main(rank: int, world: int, work: str) -> None:
    """One of (b)'s ranks, started by ``moe_four_ranks`` as
    ``chip_smoke.py --moe-rank <rank> <world> <dir>``: gloo over the
    card's tensors.  At each mesh of MOE_RANK_MESHES: ``moe_rank_cfg`` on
    its slices under MOE_PLAN, one ``lm_loss(sharder=)`` on its shard of
    ``moe_rank_batch`` with its grads summed by ``allreduce_grads`` and
    the clip's norm, what it counted, its peak memory, its dropped share
    and its routing (the forward's MoE calls); each grad slice held
    against the same slice of (a)'s reference.  Written to
    ``<dir>/moe_rank<r>.json`` and ``.pt``; every rank waits at a barrier,
    then leaves the group."""
    device = json.load(open(os.path.join(work, "job23.json")))["device"]
    full_f32()
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "store23b"), world), rank=rank, world_size=world)
    try:
        cfg = moe_rank_cfg()
        ref = torch.load(os.path.join(work, "moe_ref.pt"), mmap=True)
        res, routes = {}, {}
        for shape in MOE_RANK_MESHES:
            label = f"{shape[0]}x{shape[1]}"
            mesh = make_mesh(shape, ("data", "model"),
                             torch.device(device).type, backend="gloo")
            ctx = from_mesh(mesh)
            lay = moe_layout(cfg, mesh, MOE_RANK_BATCH, MOE_RANK_SEQ, device)
            specs, sharder = lay["specs"], lay["sharder"]
            leaves = lm.tree_map(lambda p: p.requires_grad_(True),
                                 lay.pop("params"))
            batch = lm.shard_lm_batch(moe_rank_batch(cfg, device), sharder)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            with moe_calls() as calls:          # the forward's, not the
                loss, metrics = lm.lm_loss(      # backward's recompute
                    leaves, batch, cfg, sharder=sharder, backend="kernel")
            routes[label] = calls
            grads = iter(torch.autograd.grad(loss, lm.tree_leaves(leaves)))
            loss, grads = allreduce_grads(loss.detach(), lm.tree_map(
                lambda p: next(grads), leaves), specs, ctx)
            slices_norm(grads, specs, ctx)
            got = read_counts()
            got.update(seconds=time.perf_counter() - t0,
                       coord=[ctx.dp_index, ctx.sp_index],
                       layout=lay["layout"],
                       dropped=float(metrics["moe_dropped"]),
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            gaps = torch.tensor([slice_gap(g, w[tuple(
                slice(a, b) for a, b in slice_index(w.shape, spec, ctx))])
                for g, w, spec in zip(lm.tree_leaves(grads), ref["grads"],
                                      lm.tree_leaves(specs))],
                dtype=torch.float64)
            dist.all_reduce(gaps, op=dist.ReduceOp.MAX)
            shares = (gaps[:, 0] / gaps[:, 1].clamp_min(1e-30)).tolist()
            worst = int(np.argmax(shares))
            got.update(
                loss=float(loss), loss_rel=float(
                    (loss.cpu() - ref["loss"]).abs() / ref["loss"].abs()),
                grad_rel=shares[worst], leaves=len(shares),
                leaf=leaf_paths(specs)[worst], host_gib=host_state())
            res[label] = got
            del leaves, grads, lay
            host_empty_cache()
            torch.cuda.empty_cache()
        torch.save(routes, os.path.join(work, f"moe_rank{rank}.pt"))
        json.dump(res, open(os.path.join(work, f"moe_rank{rank}.json"), "w"))
    finally:
        dist.barrier()
        dist.destroy_process_group()


def assemble_routes(parts: dict, shape) -> list:
    """The run's global routing from each rank's (coord -> its
    ``moe_calls`` record): per MoE call, the experts (B, S, K)."""
    dp, mp = shape
    calls = len(next(iter(parts.values())))
    return [torch.cat([torch.cat([parts[(a, b)][i]["experts"]
                                  for b in range(mp)], dim=1)
                       for a in range(dp)], dim=0) for i in range(calls)]


def moe_four_ranks(work: str, device="cuda") -> Part:
    """(b) DSP_RANKS processes sharing the card over gloo
    (``moe_rank_main``), ``moe_rank_cfg`` in float32 at each mesh of
    MOE_RANK_MESHES under MOE_PLAN: the loss within MOE_LOSS_BAR relative
    of (a)'s one-rank reference, each rank's grad slices within
    MOE_GRAD_BAR of their leaf's max, the ranks' dropped shares summed
    equal to the reference's, call by call and in all (the reference's
    per call its routing's, by ``kept_pairs``), each rank's calls and
    bytes exactly ``zero_contract`` with the dispatch's rows from the
    run's routing (``route_rows``), 2 K1 launches a layer on the f32
    route; each rank's peak memory and host memory logged."""
    with open(os.path.join(work, "job23.json"), "w") as f:
        json.dump({"device": device}, f)
    t0 = time.perf_counter()
    rcs = yield from ranks_exit("--moe-rank", work)
    log_t(f"  {DSP_RANKS} ranks exited {rcs} after "
          f"{time.perf_counter() - t0:.1f} s")
    if any(rcs):
        raise AssertionError(f"a MoE rank failed: exit codes {rcs}")
    ranks = [json.load(open(os.path.join(work, f"moe_rank{r}.json")))
             for r in range(DSP_RANKS)]
    routes = [torch.load(os.path.join(work, f"moe_rank{r}.pt"))
              for r in range(DSP_RANKS)]
    ref = torch.load(os.path.join(work, "moe_ref.pt"), mmap=True)
    cfg = moe_rank_cfg()
    e_phys = lm.moe_meta(cfg).e_phys
    route = ROUTES[(cfg.dtype, cfg.head_dim)]
    k1 = 2 * cfg.n_layers
    cap = lm_capacity(cfg, MOE_RANK_SEQ)
    pairs = MOE_RANK_BATCH * MOE_RANK_SEQ * cfg.top_k

    def count(shares):
        return [int(round(float(x) * pairs)) for x in shares]
    ref_dropped = count(ref["call_dropped"])
    if ref_dropped != [int((~kept_pairs(e, e_phys, cap)).sum())
                       for e in ref["routes"]]:
        raise AssertionError(f"one rank's dropped pairs per MoE call "
                             f"{ref_dropped} are not its routing's")
    for shape in MOE_RANK_MESHES:
        label = f"{shape[0]}x{shape[1]}"
        parts = {tuple(res[label]["coord"]): rt[label]
                 for res, rt in zip(ranks, routes)}
        glob = assemble_routes(parts, shape)
        # each call's dropped pairs: the ranks' shares summed
        dropped = count(np.sum([[c["dropped"] for c in calls]
                                for calls in parts.values()], axis=0))
        share = sum(res[label]["dropped"] for res in ranks)
        g = ranks[0][label]
        log_t(f"  {label}: depth {cfg.n_layers} in float32, "
              f"{MOE_RANK_BATCH} x {MOE_RANK_SEQ}: loss {g['loss']:.9f}, "
              f"|delta| / |loss| against one rank {g['loss_rel']:.3e}, "
              f"worst grad slice {g['leaf']} {g['grad_rel']:.3e} of its "
              f"leaf's max over {g['leaves']} leaves; dropped pairs per MoE "
              f"call {dropped} against one rank's {ref_dropped}, share "
              f"{share} against {ref['dropped']}")
        if not (g["grad_rel"] <= MOE_GRAD_BAR and dropped == ref_dropped
                and share == ref["dropped"]):
            raise AssertionError(f"{label}: the {DSP_RANKS}-rank grads or "
                                 f"drops disagree with one rank: {g}, "
                                 f"dropped {dropped} against {ref_dropped}")
        for r, res in enumerate(ranks):
            got = res[label]
            i, j = got["coord"]
            rows = route_rows(glob, e_phys, cap, shape[0], shape[1], i, j)
            want = zero_contract(cfg, shape, MOE_RANK_BATCH, got["layout"],
                                 MOE_RANK_SEQ, rows)
            log_t(f"  rank {r} (data {i}, model {j}): {got['seconds']:.1f} "
                  f"s, peak {got['peak_gb']:.2f} GB, dispatch rows "
                  f"(received, returned) {rows}, calls {got['calls']}, K1 "
                  f"{got['k1']} {got['k1_routes']}; host GiB "
                  f"{got['host_gib']}")
            if not (got["loss_rel"] <= MOE_LOSS_BAR and got["calls"] == want
                    and got["k1"] == k1 and got["k1_routes"] == {route: k1}):
                raise AssertionError(f"rank {r} {label}: {got}, the contract "
                                     f"says {want} and {k1} K1 launches on "
                                     f"{route}")
    return {"ranks": ranks, "k1": k1}


def train_cli_ranks(name: str, launched: dict, train_main, arch: str,
                    plan) -> None:
    """A train CLI at SMOKE size under ``torchrun --nproc-per-node``
    DSP_RANKS on the card, gloo over its tensors, ``--mesh 1,4``
    (``cli_launches``' ``name``): exit 0, ``plan`` printed, every rank
    one rank's loss without a mesh (run in this process)."""
    hist = train_main(["--arch", arch, "--steps", "3"])["history"]
    rc, out, err, seconds = finish(launched[name])
    lines = [l for l in out.splitlines() if l.startswith("loss ")]
    plans = {l for l in out.splitlines() if l.startswith("plan ")}
    one = f"loss {hist[0][1]:.4f} -> {hist[-1][1]:.4f}"
    log_t(f"  {name}: exit {rc} in {seconds:.1f} s; {sorted(plans)}; "
          f"{lines[:1]} on each of {len(lines)} ranks; one rank: {one}")
    if rc or lines != [one] * DSP_RANKS or plans != {f"plan {plan}"}:
        raise AssertionError(f"train CLI under torchrun {name}: "
                             f"{out[-2000:]}{err[-3000:]}")


# ---------------------------------------------------------------------------
# Phase 24: mistral-large-123b on one card, its KV cache in fp8
# ---------------------------------------------------------------------------

def mistral_cfg(depth: int, dtype=None):
    cfg = dataclasses.replace(mistral_large_123b.CONFIG, n_layers=depth)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


@contextlib.contextmanager
def plain_attention():
    """While open, every K1 call of the model's attention layers
    (``models.attention.flash_attention``) takes its plain version, so
    the engine's steps, which run the kernel path, run the plain one."""
    inner = attn_mod.flash_attention

    def plain(*a, **kw):
        return inner(*a, **{**kw, "backend": "ref"})
    attn_mod.flash_attention = plain
    try:
        yield
    finally:
        attn_mod.flash_attention = inner


@torch.no_grad()
def fp8_cache_checks(cfg, device="cuda") -> dict:
    """(a)'s fp8 cache at depth 2, the kernel path against the plain path
    (``plain_attention``) on the same weights, each within LOGIT_BAR of
    the largest logit: the static decode write at a scalar position (the
    one ``index_copy_`` lacks for fp8) into an fp8 ``init_caches`` cache
    holding each path's prefill K/V, SERVE_FORCED_STEPS steps; the
    engine's ``generate`` (whose cache is the prefill's, bf16, as JAX's);
    the slot pool (``forced_logits``: the per-slot fp8 writes) and the
    block pool (``paged_forced_logits``: the fp8 block writes, K1 over the
    blocks widened to bf16 for each prefill chunk, the decode's reads),
    MISTRAL_REQUESTS requests over MISTRAL_LENS teacher-forced
    SERVE_FORCED_STEPS decode steps."""
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = lm.init_lm(0, cfg2, device=device)
    g = torch.Generator(device=device).manual_seed(6)
    s = max(MISTRAL_LENS)
    tok = torch.randint(0, cfg.vocab, (1, s + SERVE_FORCED_STEPS),
                        generator=g, device=device)
    rows = {}
    for backend in ("kernel", "ref"):
        _, pre = lm.forward_prefill(params, tok[:, :s], cfg2,
                                    backend=backend)
        caches = lm.init_caches(cfg2, 1, s + SERVE_FORCED_STEPS,
                                device=device)
        for j, pc in pre["periods"].items():
            for kv in ("k", "v"):
                caches["periods"][j]["kv"][kv][..., :s, :].copy_(
                    pc["kv"][kv])
        caches["pos"] = torch.tensor(s, device=device)
        out = []
        for t in range(SERVE_FORCED_STEPS):
            logits, caches = lm.forward_decode(
                params, tok[:, s + t:s + t + 1], caches, cfg2)
            out.append(logits[0, -1].float())
        rows[backend] = torch.stack(out)
        kv_dtype = caches["periods"]["0"]["kv"]["k"].dtype
    gaps = {"static": logit_gap(rows["kernel"], rows["ref"])}
    eng = ServingEngine(params, cfg2, max_len=paged_max_len(
        0, [s], SERVE_FORCED_STEPS), device=device)
    generated = eng.generate(tok[:, :s], SERVE_FORCED_STEPS)
    reqs = trace_requests(cfg2, device, MISTRAL_LENS, SERVE_FORCED_STEPS)
    fed = torch.randint(0, cfg.vocab, (len(reqs), SERVE_FORCED_STEPS),
                        generator=g, device=device).tolist()
    for name, fn in (
            ("slot", lambda: forced_logits(eng, reqs, fed, device)),
            ("paged", lambda: paged_forced_logits(eng, reqs, fed,
                                                  PAGED_CHUNK)[0])):
        reset_launches()
        got = fn()
        launches = flash_attention_fwd.launches
        with plain_attention():
            want = fn()
        gaps[name] = logit_gap(got, want)
        log(f"  {name} pool: K1 {launches} launches "
            f"{nonzero(flash_attention_fwd.route_launches)} on the kernel "
            f"path")
    log(f"  fp8 cache ({kv_dtype}): teacher-forced logits, max |kernel - "
        f"plain| / max |logit| {gaps}; generate {generated.tolist()}")
    if kv_dtype != torch.float8_e4m3fn or not max(gaps.values()) <= LOGIT_BAR:
        raise AssertionError(f"fp8 cache paths disagree: {gaps}, cache "
                             f"{kv_dtype}")
    if tuple(generated.shape) != (1, SERVE_FORCED_STEPS):
        raise AssertionError(f"generate gave {generated.shape}")
    del params, eng
    free_device()
    return gaps


def mistral_on_one_card(device="cuda") -> dict:
    """(a) depth 2, kernel against plain: the prefill logits at
    max(MISTRAL_LENS) tokens and SERVE_FORCED_STEPS decode steps, then
    ``fp8_cache_checks``; (b) depth MISTRAL_SERVE_DEPTH behind the
    scheduler, K1 once a layer a prefill on ``sm90``; (c)
    MISTRAL_TRAIN_STEPS Trainer steps at depth MISTRAL_TRAIN_DEPTH, K1
    twice a layer a step on ``sm90``."""
    out = {}
    cfg = mistral_large_123b.CONFIG
    log(f"  (a) depth 2, kernel against plain, the KV cache in "
        f"{cfg.cache_dtype}")
    full_width_prefill_check(cfg, (max(MISTRAL_LENS),),
                             decode_steps=SERVE_FORCED_STEPS, device=device)
    out["fp8"] = fp8_cache_checks(cfg, device)
    log(f"  (b) depth {MISTRAL_SERVE_DEPTH} of {cfg.n_layers}: "
        f"{MISTRAL_REQUESTS} requests over {MISTRAL_LENS} tokens "
        f"({elapsed()})")
    out["serve"] = full_width_serve(
        mistral_cfg(MISTRAL_SERVE_DEPTH), flash_attention_fwd, device,
        lens=MISTRAL_LENS, new_tokens=MODEL_NEW_TOKENS)
    log(f"  (c) training at depth {MISTRAL_TRAIN_DEPTH}, "
        f"{MISTRAL_TRAIN_STEPS} steps at 1 x {TRAIN_SEQ} ({elapsed()})")
    out["train"] = full_width_train(mistral_cfg(MISTRAL_TRAIN_DEPTH),
                                    flash_attention_fwd, 1,
                                    MISTRAL_TRAIN_STEPS, device)
    free_device()
    return out


# ---------------------------------------------------------------------------
# Phase 25: mistral-large-123b under tp on a (data, model) mesh
# ---------------------------------------------------------------------------

def tp_layout(cfg, mesh, device="cuda", plan=None) -> dict:
    """``cfg``'s parameters from seed 0 under ``plan`` (TP_PLAN by default)
    on ``mesh``: the rank's slices (its columns and rows over ``model``,
    ZeRO over ``data``; under ``ep`` its experts), the specs, the sharder
    (no schedule) and the layouts' contract."""
    plan = TP_PLAN if plan is None else plan
    ctx = from_mesh(mesh)
    sizes = mesh_sizes(ctx)
    params = lm.init_lm(0, cfg, device=device)
    specs = param_pspecs(params, plan, axis_sizes=sizes)
    layout = lm.param_contract(cfg, meta_tree(params), plan, sizes)
    return {"params": shard_params(params, specs, ctx), "specs": specs,
            "sharder": make_sharder(mesh, plan, param_specs=specs),
            "layout": layout}


def tp_world_of_one(phase24: dict, work: str, device="cuda") -> dict:
    """(a) At world size 1 on a (1, 1) mesh over NCCL, under TP_PLAN:
    phase 24 (c)'s training, the losses within DSP_LOSS_BAR of phase
    24's, the calls and bytes exactly ``zero_contract(tp=True)`` each step
    (the blocks' gathers and reduce-scatters three times over, plus
    ``lm.param_contract``), K1 as there; phase 24 (b)'s trace on the same
    weights, the tokens phase 24's, K1 as there, the calls exactly
    ``lm.serve_contract``.  Then (b)'s references (``tp_rank_refs``)."""
    backend = BACKEND_OF[torch.device(device).type]
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(work, "store25a"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), torch.device(device).type)
        cfg = mistral_cfg(MISTRAL_TRAIN_DEPTH)
        lay = tp_layout(cfg, mesh, device)
        sharder = lay["sharder"]
        trained = run_trainer(
            lambda: lay.pop("params"),
            lambda p, b: lm.lm_loss(p, b, cfg, sharder=sharder,
                                    backend="kernel"),
            lambda st: lm.shard_lm_batch(lm_batch(cfg, 1, st, device),
                                         sharder),
            flash_attention_fwd, tokens=TRAIN_SEQ,
            n_steps=MISTRAL_TRAIN_STEPS, n_layers=cfg.n_layers,
            route="sm90", device=device, sharder=sharder)
        step = zero_contract(cfg, (1, 1), 1, lay["layout"], TRAIN_SEQ,
                             tp=True)
        want = {k: [c * MISTRAL_TRAIN_STEPS, b * MISTRAL_TRAIN_STEPS]
                for k, (c, b) in step.items()}
        got = {k: [trained["collectives"][k], trained["volume"][k]]
               for k in sorted(trained["collectives"])}
        met, ref = trained["metrics"], phase24["train"]["metrics"]
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(met["losses"], ref["losses"]))
        log_t(f"  training under {TP_PLAN}: calls [count, bytes] {got}; the "
              f"contract {want}; losses {met['losses']} against phase 24's "
              f"{ref['losses']}: worst |delta| / |loss| = {rel:.3e}; step "
              f"(median) {met['step_ms_median']:.2f} ms against "
              f"{ref['step_ms_median']:.2f} ms; peak "
              f"{met['peak_memory_gb']:.2f} GB against "
              f"{ref['peak_memory_gb']:.2f} GB")
        if got != want or not rel <= DSP_LOSS_BAR:
            raise AssertionError(f"mistral under {TP_PLAN}: calls {got}, "
                                 f"the contract says {want}; losses "
                                 f"{met['losses']} against {ref['losses']}")
        del lay
        free_device()
        log(f"  serving phase 24 (b)'s trace under {TP_PLAN} ({elapsed()})")
        served = full_width_serve(
            mistral_cfg(MISTRAL_SERVE_DEPTH), flash_attention_fwd, device,
            mesh=mesh, plan=TP_PLAN, lens=MISTRAL_LENS,
            new_tokens=MODEL_NEW_TOKENS)
        same = served["tokens"] == phase24["serve"]["tokens"]
        log(f"  tokens equal to phase 24 (b)'s: {same}")
        if not same:
            raise AssertionError(f"tp at world 1 served "
                                 f"{served['tokens']}, one card "
                                 f"{phase24['serve']['tokens']}")
        tp_rank_refs(work, device)
    finally:
        dist.destroy_process_group()
    return {"train": trained, "serve": served}


def tp_rank_cfg():
    """(b)'s model: mistral at depth TP_RANK_DEPTH in float32, its KV cache
    in float32 too: an fp8 cache rounds the ranks' f32 differences (~1e-7
    of a value) to whole fp8 steps, which moved a logit 6.5e-3 of the
    largest and a token (the fp8 pools are phase 24 (a)'s)."""
    return dataclasses.replace(mistral_cfg(TP_RANK_DEPTH, torch.float32),
                               cache_dtype=None)


def tp_rank_batch(cfg, device="cuda") -> dict:
    return make_batch(DataConfig(task="lm_shift", vocab=cfg.vocab,
                                 seq=TP_RANK_SEQ, batch=TP_RANK_BATCH), 0,
                      device=device)


def tp_rank_max_len() -> int:
    need = max(TP_RANK_LENS) + TP_RANK_NEW
    return need + (-need) % DSP_RANKS


def tp_rank_refs(work: str, device="cuda") -> None:
    """(b)'s references on one rank without a mesh, ``tp_rank_cfg`` in
    float32: the loss and grads on ``tp_rank_batch`` (``work/tp_ref.pt``)
    and the tokens of TP_RANK_LENS's requests, TP_RANK_NEW new tokens
    each, through ``ContinuousScheduler``, with each generated token's
    margin (its two best logits' gap over the largest |logit|, from
    ``forward`` over the prompt and the tokens before it)
    (``work/tp_serve.json``)."""
    cfg = tp_rank_cfg()
    free = shutil.disk_usage(work).free
    params = lm.init_lm(0, cfg, device=device)
    leaves = lm.tree_map(lambda p: p.requires_grad_(True), params)
    loss, _ = lm.lm_loss(leaves, tp_rank_batch(cfg, device), cfg,
                         backend="kernel")
    grads = torch.autograd.grad(loss, lm.tree_leaves(leaves))
    torch.save({"loss": loss.detach().cpu(),
                "grads": [g.cpu() for g in grads]},
               os.path.join(work, "tp_ref.pt"))
    del leaves, grads
    eng = ServingEngine(params, cfg, max_len=tp_rank_max_len(),
                        device=device)
    reqs = trace_requests(cfg, device, TP_RANK_LENS, TP_RANK_NEW)
    eng.serve(reqs, continuous=True, max_batch=len(reqs))
    margins = []
    with torch.no_grad():
        for r in reqs:
            seq = torch.cat([r.prompt, torch.tensor(r.generated[:-1],
                                                    device=device)])
            x, _ = lm.forward(params, seq[None], cfg, remat=False)
            logits = lm.logits_fn(params, x[:, len(r.prompt) - 1:],
                                  cfg)[0].float()
            top = logits.topk(2, dim=-1).values
            margins.append(((top[:, 0] - top[:, 1])
                            / logits.abs().amax(-1)).tolist())
    json.dump({"tokens": [r.generated for r in reqs], "margins": margins},
              open(os.path.join(work, "tp_serve.json"), "w"))
    log_t(f"  references: depth {cfg.n_layers} in float32, "
          f"{TP_RANK_BATCH} x {TP_RANK_SEQ}: loss {float(loss.detach()):.6f}, "
          f"{os.path.getsize(os.path.join(work, 'tp_ref.pt')) / 1e9:.2f} GB "
          f"written ({free / 1e9:.1f} GB were free); tokens "
          f"{[r.generated for r in reqs]}")
    del params, eng
    free_device()


def in_turn(rank: int, world: int, fn):
    """``fn()`` on each rank in turn, the others waiting at a barrier, so
    that one rank at a time holds the whole tree it cuts to its slices."""
    out = None
    for r in range(world):
        if r == rank:
            out = fn()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def tp_rank_main(rank: int, world: int, work: str) -> None:
    """One of (b)'s ranks, started by ``tp_four_ranks`` as ``chip_smoke.py
    --tp-rank <rank> <world> <dir>``: gloo over the card's tensors.  At
    each mesh of TP_RANK_MESHES: ``tp_rank_cfg`` on its slices under
    TP_PLAN (the ranks cut theirs in turn), one ``lm_loss(sharder=)`` on
    its shard of ``tp_rank_batch`` with its grads summed by
    ``allreduce_grads`` and the clip's norm, what it counted, its peak
    memory, each grad slice against the same slice of (a)'s reference.
    Then at (1, world) TP_RANK_LENS's requests under TP_RANK_SERVE_PLAN
    through ``ContinuousScheduler``, ``replan(SERVE_REPLAN_TO)`` at
    decode step SERVE_REPLAN_STEP: the tokens.  Rank 0 logs its progress
    (``note``).  Written to ``<dir>/tp_rank<r>.json``;
    every rank waits at a barrier, then leaves the group."""
    device = json.load(open(os.path.join(work, "job25.json")))["device"]
    full_f32()
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "store25b"), world), rank=rank, world_size=world)
    t_start = time.perf_counter()

    def note(what):
        if rank == 0:
            log(f"    rank 0: {what} at {time.perf_counter() - t_start:.1f} "
                f"s, {torch.cuda.memory_allocated() / 1e9:.2f} GB held, "
                f"host GiB {host_state()}")
    try:
        cfg = tp_rank_cfg()
        ref = torch.load(os.path.join(work, "tp_ref.pt"), mmap=True)
        res = {}
        for shape in TP_RANK_MESHES:
            label = f"{shape[0]}x{shape[1]}"
            mesh = make_mesh(shape, ("data", "model"),
                             torch.device(device).type, backend="gloo")
            ctx = from_mesh(mesh)
            lay = in_turn(rank, world, lambda: tp_layout(cfg, mesh, device))
            note(f"{label}: the slices cut")
            specs, sharder = lay["specs"], lay["sharder"]
            leaves = lm.tree_map(lambda p: p.requires_grad_(True),
                                 lay.pop("params"))
            batch = lm.shard_lm_batch(tp_rank_batch(cfg, device), sharder)
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            loss, _ = lm.lm_loss(leaves, batch, cfg, sharder=sharder,
                                 backend="kernel")
            grads = iter(torch.autograd.grad(loss, lm.tree_leaves(leaves)))
            loss, grads = allreduce_grads(loss.detach(), lm.tree_map(
                lambda p: next(grads), leaves), specs, ctx)
            slices_norm(grads, specs, ctx)
            got = read_counts()
            got.update(seconds=time.perf_counter() - t0,
                       coord=[ctx.dp_index, ctx.sp_index],
                       layout=lay["layout"],
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            note(f"{label}: the loss and grads")
            gaps = torch.tensor([slice_gap(g, w[tuple(
                slice(a, b) for a, b in slice_index(w.shape, spec, ctx))])
                for g, w, spec in zip(lm.tree_leaves(grads), ref["grads"],
                                      lm.tree_leaves(specs))],
                dtype=torch.float64)
            dist.all_reduce(gaps, op=dist.ReduceOp.MAX)
            shares = (gaps[:, 0] / gaps[:, 1].clamp_min(1e-30)).tolist()
            worst = int(np.argmax(shares))
            got.update(
                loss=float(loss), loss_rel=float(
                    (loss.cpu() - ref["loss"]).abs() / ref["loss"].abs()),
                grad_rel=shares[worst], leaves=len(shares),
                leaf=leaf_paths(specs)[worst], host_gib=host_state())
            res[label] = got
            del leaves, grads, lay
            host_empty_cache()
            torch.cuda.empty_cache()
            note(f"{label}: the slices held against the reference")
        mesh = make_mesh((1, world), ("data", "model"),
                         torch.device(device).type, backend="gloo")
        eng = in_turn(rank, world, lambda: ServingEngine(
            lm.init_lm(0, cfg, device=device), cfg,
            max_len=tp_rank_max_len(), mesh=mesh, plan=TP_RANK_SERVE_PLAN,
            device=device))
        note("the engine built")
        reqs = trace_requests(cfg, device, TP_RANK_LENS, TP_RANK_NEW)
        sched = ContinuousScheduler(eng, max_batch=len(reqs))

        def on_step(s, k):
            if k == SERVE_REPLAN_STEP:
                note("the replan")
                s.replan(SERVE_REPLAN_TO)
                host_empty_cache()
                torch.cuda.empty_cache()
                note("replanned")
        reset_counts()
        t0 = time.perf_counter()
        sched.run(reqs, on_step=on_step)
        got = read_counts()
        res["serve"] = {
            "active": eng.active, "seconds": time.perf_counter() - t0,
            "tokens": [r.generated for r in reqs] if eng.active else None,
            "k1": got["k1"], "k1_routes": got["k1_routes"],
            "host_gib": host_state()}
        note("served")
        json.dump(res, open(os.path.join(work, f"tp_rank{rank}.json"), "w"))
    finally:
        dist.barrier()
        dist.destroy_process_group()


def tp_four_ranks(work: str, device="cuda") -> Part:
    """(b) DSP_RANKS processes sharing the card over gloo
    (``tp_rank_main``), ``tp_rank_cfg`` in float32 at each mesh of
    TP_RANK_MESHES under TP_PLAN: the loss within TP_LOSS_BAR relative of
    (a)'s one-rank reference, each rank's grad slices within TP_GRAD_BAR
    of their leaf's max, each rank's calls and bytes exactly
    ``zero_contract(tp=True)``, K1 twice a layer on the f32 route on the
    rank's heads; then the requests served through the replan, the
    tokens of the ranks still serving the reference's up to a near-tie
    (TP_TIE_BAR), after which the two runs decode other prefixes.  Each
    rank's peak memory and host memory logged."""
    with open(os.path.join(work, "job25.json"), "w") as f:
        json.dump({"device": device}, f)
    t0 = time.perf_counter()
    rcs = yield from ranks_exit("--tp-rank", work)
    log_t(f"  {DSP_RANKS} ranks exited {rcs} after "
          f"{time.perf_counter() - t0:.1f} s")
    if any(rcs):
        raise AssertionError(f"a tp rank failed: exit codes {rcs}")
    ranks = [json.load(open(os.path.join(work, f"tp_rank{r}.json")))
             for r in range(DSP_RANKS)]
    cfg = tp_rank_cfg()
    route = ROUTES[(cfg.dtype, cfg.head_dim)]
    k1 = 2 * cfg.n_layers
    for shape in TP_RANK_MESHES:
        label = f"{shape[0]}x{shape[1]}"
        g = ranks[0][label]
        log_t(f"  {label}: depth {cfg.n_layers} in float32, {TP_RANK_BATCH} "
              f"x {TP_RANK_SEQ}: loss {g['loss']:.9f}, |delta| / |loss| "
              f"against one rank {g['loss_rel']:.3e}, worst grad slice "
              f"{g['leaf']} {g['grad_rel']:.3e} of its leaf's max over "
              f"{g['leaves']} leaves")
        if not g["grad_rel"] <= TP_GRAD_BAR:
            raise AssertionError(f"{label}: the {DSP_RANKS}-rank grads "
                                 f"disagree with one rank: {g}")
        for r, res in enumerate(ranks):
            got = res[label]
            want = zero_contract(cfg, shape, TP_RANK_BATCH, got["layout"],
                                 TP_RANK_SEQ, tp=True)
            log_t(f"  rank {r} (data {got['coord'][0]}, model "
                  f"{got['coord'][1]}): {got['seconds']:.1f} s, peak "
                  f"{got['peak_gb']:.2f} GB, calls {got['calls']}, K1 "
                  f"{got['k1']} {got['k1_routes']} {got['k1_dims']}; host "
                  f"GiB {got['host_gib']}")
            if not (got["loss_rel"] <= TP_LOSS_BAR and got["calls"] == want
                    and got["k1"] == k1 and got["k1_routes"] == {route: k1}):
                raise AssertionError(f"rank {r} {label}: {got}, the contract "
                                     f"says {want} and {k1} K1 launches on "
                                     f"{route}")
    ref = json.load(open(os.path.join(work, "tp_serve.json")))
    want = ref["tokens"]
    k1 = cfg.n_layers * len(TP_RANK_LENS)
    for r, res in enumerate(ranks):
        sv = res["serve"]
        # per request the first step that differs, and one rank's margin
        # there
        apart = [next(([t, m[t]] for t, (a, b) in enumerate(zip(g, w))
                       if a != b), None)
                 for g, w, m in zip(sv["tokens"] or [], want,
                                    ref["margins"])]
        log_t(f"  rank {r} served {sv['seconds']:.1f} s, still serving "
              f"{sv['active']}, tokens {sv['tokens']}, K1 {sv['k1']} "
              f"{sv['k1_routes']}; host GiB {sv['host_gib']}; [first step "
              f"apart, one rank's margin there] {apart}")
        if (sv["active"] != (r < SERVE_REPLAN_TO)
                or any(a is not None and a[1] > TP_TIE_BAR for a in apart)
                or sv["k1_routes"] != {route: k1}):
            raise AssertionError(f"rank {r} served {sv}, one rank {ref} "
                                 f"with {k1} K1 launches on {route}")
    log(f"  tokens through replan({SERVE_REPLAN_TO}) against one rank's "
        f"{want}, margins {ref['margins']}")
    return {"ranks": ranks}


TP_SERVE_CLI = ["--arch", "mistral-large-123b", "--batch", "4",
                "--prompt-len", "16", "--new-tokens", "8", "--continuous"]


def tp_cli_ranks(launched: dict, serve_main, name: str = "25c/serve",
                 cli=None) -> None:
    """Phase 25 (c)'s serve CLI (or phase 27 (f)'s, ``name`` and its
    ``cli``), run in phase 28: ``--mode tp --continuous`` under ``torchrun
    --nproc-per-node`` DSP_RANKS on the card, gloo over its tensors: exit
    0, one rank's tokens (run in this process).  Its train CLI is
    ``train_cli_ranks``'."""
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        want = [r.generated for r in serve_main(
            TP_SERVE_CLI if cli is None else cli)]
    rc, out, err, seconds = finish(launched[name])
    got = [json.loads(m) for m in re.findall(r"s: (\[[^\]]*\])", out)]
    log_t(f"  {name}: exit {rc} in {seconds:.1f} s; "
          f"{out.splitlines()[0] if out else ''}; tokens equal to one "
          f"rank's: {got == want}")
    if rc or got != want or "KV pool sequence-sharded over 4-way" not in out:
        raise AssertionError(f"serve CLI --mode tp under torchrun: "
                             f"{out[-2000:]}{err[-3000:]}")


# ---------------------------------------------------------------------------
# Phase 26: seamless-m4t-large-v2, the enc-dec model
# ---------------------------------------------------------------------------

def seamless_cfg(depth=None, dtype=None):
    """seamless's published config, ``depth`` encoder and ``depth``
    decoder layers where given, in ``dtype`` where given."""
    cfg = _SE if depth is None else dataclasses.replace(
        _SE, n_enc_layers=depth, n_dec_layers=depth)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def seamless_batch(cfg, batch: int, s_enc: int, s_dec: int, step: int,
                   device="cuda") -> dict:
    return make_batch(DataConfig(task="encdec", vocab=cfg.vocab, seq=s_dec,
                                 enc_seq=s_enc, batch=batch,
                                 frontend_dim=cfg.frontend_dim), step,
                      device=device)


def seamless_requests(cfg, device="cuda") -> dict:
    """SEAMLESS_REQUESTS requests of SEAMLESS_ENC frames each and a
    SEAMLESS_PROMPT-token decoder prompt, as one batch."""
    b = seamless_batch(cfg, SEAMLESS_REQUESTS, SEAMLESS_ENC, SEAMLESS_PROMPT,
                       7, device)
    return {"feats": b["feats"], "tokens": b["tokens"]}


def seamless_checks(device="cuda") -> dict:
    """(a) depth 2 + 2 at full width, kernel against plain, on weights
    drawn in bf16: the loss and every grad at SEAMLESS_BATCH x
    (SEAMLESS_ENC frames, SEAMLESS_DEC tokens) in f32 (the weights
    upcast; K1 on ``cuda_cores``) under LOSS_BAR and GRAD_BAR, and in
    bf16 (K1 on ``sm90``) with the loss under LOSS_BAR and each grad leaf
    held, as FlashAttention's own tests hold theirs, against the f32
    plain path's (the truth): its max |kernel - truth| / max |truth| at
    most BF16_SPREAD times the plain bf16 path's own, or GRAD_BAR where
    that is larger (``seamless_bf16_grads``); then in bf16 the prefill
    of seamless_requests and SEAMLESS_CHECK_STEPS decode steps (each path
    its own caches, the plain path's tokens fed to both) within LOGIT_BAR
    of the largest logit; the kernel path's first decode step against a
    full decoder forward over the prompt and that token (the step writes
    past the prompt, not on its last row)."""
    cfg = seamless_cfg(2, torch.bfloat16)
    params = ED.init_encdec(0, cfg, device=device)
    batch = seamless_batch(cfg, SEAMLESS_BATCH, SEAMLESS_ENC, SEAMLESS_DEC,
                           0, device)
    paths = leaf_paths(params)
    zero = (SEAMLESS_ZERO_GRAD,)
    cfg32 = seamless_cfg(2, torch.float32)
    params32 = lm.tree_map(lambda p: p.float(), params)
    loss_t, truth = loss_and_grads(params32, batch, cfg32, ED.encdec_loss,
                                   "ref")
    loss_k, grads_k = loss_and_grads(params32, batch, cfg32, ED.encdec_loss,
                                     "kernel")
    shares = grad_shares(grads_k, truth, paths, zero)
    worst = int(np.argmax(shares))
    gaps32 = {"loss": float(loss_t),
              "loss_rel": float((loss_k - loss_t).abs() / loss_t.abs()),
              "grad_rel": shares[worst], "leaf": paths[worst],
              "leaves": len(shares)}
    log(f"  depth-2 + 2 in float32, K1 on "
        f"{ROUTES[(torch.float32, cfg.head_dim)]}: loss {gaps32['loss']:.6f}"
        f" at {SEAMLESS_BATCH} x ({SEAMLESS_ENC} frames, {SEAMLESS_DEC} "
        f"tokens): |kernel - plain| / |loss| = {gaps32['loss_rel']:.3e}; "
        f"worst grad leaf {gaps32['leaf']} max |delta| / max |plain| = "
        f"{gaps32['grad_rel']:.3e} over {gaps32['leaves']} leaves")
    if not gap_passes(gaps32):
        raise AssertionError(f"seamless depth-2 loss or grads disagree in "
                             f"float32: {gaps32}")
    del params32, grads_k
    free_device()
    gap = seamless_bf16_grads(params, batch, cfg, truth, paths)
    del truth
    free_device()
    del batch
    reqs = seamless_requests(cfg, device)
    max_len = SEAMLESS_PROMPT + SEAMLESS_CHECK_STEPS
    with torch.no_grad():
        got, c_got = ED.prefill(params, reqs, cfg, backend="kernel",
                                max_len=max_len)
        want, c_want = ED.prefill(params, reqs, cfg, backend="ref",
                                  max_len=max_len)
        gaps = [logit_gap(got, want)]
        first = None
        for i in range(SEAMLESS_CHECK_STEPS):
            nxt = want.argmax(-1)
            got, c_got = ED.decode_step(params, nxt, c_got, cfg)
            want, c_want = ED.decode_step(params, nxt, c_want, cfg)
            gaps.append(logit_gap(got, want))
            if i == 0:
                first = (nxt, got)
        tokens = torch.cat([reqs["tokens"], first[0]], 1)
        enc = ED.encode(params, reqs["feats"], cfg, remat=False)
        x = ED.decode(params, tokens, enc, cfg, remat=False)
        full = x[:, -1:] @ params["embed"]["table"].t()
        first_gap = logit_gap(first[1], full)
    log(f"  depth-2 + 2 prefill of {SEAMLESS_REQUESTS} x ({SEAMLESS_ENC} "
        f"frames, {SEAMLESS_PROMPT} tokens): max |kernel - plain| / max "
        f"|logit| = {gaps[0]:.3e}; then {SEAMLESS_CHECK_STEPS} decode steps, "
        f"worst {max(gaps[1:]):.3e}; the first step against a full decoder "
        f"forward over {tokens.shape[1]} tokens {first_gap:.3e}")
    if not max(gaps + [first_gap]) <= LOGIT_BAR:
        raise AssertionError(f"seamless depth-2 serving disagrees: {gaps}, "
                             f"first step against a full forward "
                             f"{first_gap}")
    del params, c_got, c_want, enc
    free_device()
    return {"loss_grads": gap, "loss_grads_f32": gaps32, "serve_gaps": gaps,
            "first_step": first_gap}


def seamless_bf16_grads(params, batch, cfg, truth, paths) -> dict:
    """(a)'s bf16 loss and grads: the kernel path and the plain path in
    bf16, each leaf's ``grad_shares`` against ``truth`` (the f32 plain
    path's grads on the same weights upcast): the kernel's within
    BF16_SPREAD times the plain path's, or GRAD_BAR where that is larger;
    the loss kernel against plain within LOSS_BAR.  Both bf16 paths
    round their ReLUs' pre-activations on either side of 0 where the
    truth does not, which moves a unit's column of ``wi`` by a token's
    whole term: several per cent of the leaf's max, in the plain path as
    in the kernel's."""
    kw = dict(loss_fn=ED.encdec_loss, backend="kernel")
    loss_k, grads_k = loss_and_grads(params, batch, cfg, **kw)
    kw["backend"] = "ref"
    loss_p, grads_p = loss_and_grads(params, batch, cfg, **kw)
    zero = (SEAMLESS_ZERO_GRAD,)
    vs_plain = grad_shares(grads_k, grads_p, paths, zero)
    err_k = grad_shares(grads_k, truth, paths, zero)
    del grads_k
    err_p = grad_shares(grads_p, truth, paths, zero)
    del grads_p
    bars = [max(GRAD_BAR, BF16_SPREAD * e) for e in err_p]
    ratio = [k / b for k, b in zip(err_k, bars)]
    worst, tight = int(np.argmax(vs_plain)), int(np.argmax(ratio))
    gap = {"loss": float(loss_p),
           "loss_rel": float((loss_k - loss_p).abs() / loss_p.abs()),
           "grad_rel": vs_plain[worst], "leaf": paths[worst],
           "leaves": len(paths),
           "vs_truth": {paths[i]: [err_k[i], err_p[i]]
                        for i in np.argsort(err_k)[::-1][:5]},
           "tightest": [paths[tight], err_k[tight], bars[tight]]}
    log(f"  depth-2 + 2 in bfloat16, K1 on "
        f"{ROUTES[(torch.bfloat16, cfg.head_dim)]}: loss {gap['loss']:.6f}: "
        f"|kernel - plain| / |loss| = {gap['loss_rel']:.3e}; worst grad "
        f"leaf {gap['leaf']} max |kernel - plain| / max |plain| = "
        f"{gap['grad_rel']:.3e} over {gap['leaves']} leaves; against the "
        f"f32 truth [kernel, plain bf16], worst five by the kernel's: "
        f"{gap['vs_truth']}; the leaf nearest its bar {gap['tightest'][0]} "
        f"{gap['tightest'][1]:.3e} of {gap['tightest'][2]:.3e} "
        f"(max({GRAD_BAR}, {BF16_SPREAD} x the plain path's))")
    if not (gap["loss_rel"] <= LOSS_BAR and max(ratio) <= 1):
        over = [[p, k, b] for p, k, b in zip(paths, err_k, bars) if k > b]
        raise AssertionError(f"seamless depth-2 loss or grads disagree in "
                             f"bfloat16: {gap}; over their bars: {over}")
    return gap


def seamless_greedy(params, reqs, cfg, max_len: int, new: int,
                    sharder=None, margins=None) -> dict:
    """``reqs`` (one batch, on a mesh the rank's shard) through ``prefill``
    into caches of ``max_len`` positions and greedy ``decode_step``s
    (``encdec.argmax``) to ``new`` tokens a request, the counters set to
    0 just before and read just after: the tokens, TTFT (the prefill and
    the first token), TPOT p50/p99 over the decode steps, peak memory,
    and what was counted (``read_counts``).  ``margins`` (a list; whole
    logits only) takes each step's per-row margin: its two best logits'
    gap over its largest |logit|."""
    def pick(logits):
        if margins is not None:
            top = logits[:, -1].float().topk(2, dim=-1).values
            margins.append(((top[:, 0] - top[:, 1]) / logits[:, -1].float()
                            .abs().amax(-1)).tolist())
        return ED.argmax(logits, cfg, sharder)

    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        logits, caches = ED.prefill(params, reqs, cfg, sharder=sharder,
                                    backend="kernel", max_len=max_len)
        toks = [pick(logits)]
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        tpot = []
        for _ in range(new - 1):
            t = time.perf_counter()
            logits, caches = ED.decode_step(params, toks[-1], caches, cfg,
                                            sharder=sharder)
            toks.append(pick(logits))
            torch.cuda.synchronize()
            tpot.append(time.perf_counter() - t)
        got = read_counts()
    rows = reqs["tokens"].shape[0]
    return {"tokens": torch.cat(toks, 1).tolist(), "counts": got,
            "metrics": {"ttft_ms": ttft * 1e3,
                        "tpot_ms_p50": float(np.percentile(tpot, 50)) * 1e3,
                        "tpot_ms_p99": float(np.percentile(tpot, 99)) * 1e3,
                        "peak_memory_gb":
                            torch.cuda.max_memory_allocated() / 1e9,
                        "new_tokens": rows * new}}


def seamless_serve(device="cuda") -> dict:
    """(b) at full width and depth: seamless_requests through ``prefill``
    (caches of SEAMLESS_PROMPT + SEAMLESS_NEW positions) and greedy
    ``decode_step``s to SEAMLESS_NEW new tokens a request
    (``seamless_greedy``): K1 exactly n_enc + 2 n_dec launches, all
    ``sm90`` (the prefill's; a decode step attends in plain PyTorch);
    TTFT, TPOT p50/p99, peak memory."""
    cfg = seamless_cfg()
    t0 = time.perf_counter()
    params = ED.init_encdec(0, cfg, device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.tree_leaves(params))
    log_t(f"  init {n_params / 1e6:.1f}M params in "
          f"{time.perf_counter() - t0:.1f} s")
    reqs = seamless_requests(cfg, device)
    k1 = cfg.n_enc_layers + 2 * cfg.n_dec_layers
    run = seamless_greedy(params, reqs, cfg, SEAMLESS_PROMPT + SEAMLESS_NEW,
                          SEAMLESS_NEW)
    got, tokens, metrics = run["counts"], run["tokens"], run["metrics"]
    log_t(f"  {SEAMLESS_REQUESTS} requests of {SEAMLESS_ENC} frames, "
          f"{SEAMLESS_PROMPT}-token prompts, {SEAMLESS_NEW} new tokens each: "
          f"K1 {got['k1']} {got['k1_routes']} at head dims {got['k1_dims']}; "
          f"metrics " + json.dumps(metrics, sort_keys=True))
    if got["k1"] != k1 or got["k1_routes"] != {"sm90": k1}:
        raise AssertionError(f"seamless serving launched K1 {got}, expected "
                             f"{k1} on sm90")
    if any(len(t) != SEAMLESS_NEW for t in tokens):
        raise AssertionError(f"seamless serving did not finish: {tokens}")
    del params
    free_device()
    return {"launches": got["k1"], "routes": got["k1_routes"],
            "tokens": tokens, "metrics": metrics}


def seamless_train(device="cuda") -> dict:
    """(c) SEAMLESS_STEPS Trainer steps at full width and depth,
    SEAMLESS_BATCH x (SEAMLESS_ENC frames, SEAMLESS_DEC tokens): K1 twice
    a step per attention (the forward's n_enc + 2 n_dec and the
    checkpointed recompute's; the backward recomputes through
    ``attention_ref``), all ``sm90``; tokens/s counts frames and tokens."""
    cfg = seamless_cfg()
    return run_trainer(
        lambda: ED.init_encdec(0, cfg, device=device),
        lambda p, b: ED.encdec_loss(p, b, cfg, backend="kernel"),
        lambda s: seamless_batch(cfg, SEAMLESS_BATCH, SEAMLESS_ENC,
                                 SEAMLESS_DEC, s, device),
        flash_attention_fwd,
        tokens=SEAMLESS_BATCH * (SEAMLESS_ENC + SEAMLESS_DEC),
        n_steps=SEAMLESS_STEPS, n_layers=cfg.n_enc_layers + cfg.n_dec_layers,
        route="sm90", device=device,
        launches_per_step=2 * (cfg.n_enc_layers + 2 * cfg.n_dec_layers))


def seamless_layout(cfg, mesh, batch: int, s_enc: int, s_dec: int,
                    device="cuda") -> dict:
    """``cfg``'s parameters from seed 0 under SEAMLESS_PLAN on ``mesh``:
    the rank's slices (``param_pspecs``,
    ZeRO-3 over ``("data", "model")``, the table over ``model`` where the
    ranks divide the vocab), the sharder of the joint planned schedule at
    ``batch`` x (``s_enc``, ``s_dec``), and the step's contract
    (``seamless_contract``)."""
    ctx = from_mesh(mesh)
    sizes = mesh_sizes(ctx)
    params = ED.init_encdec(0, cfg, device=device)
    specs = param_pspecs(params, SEAMLESS_PLAN, axis_sizes=sizes)
    sharder = make_sharder(mesh, SEAMLESS_PLAN, schedule=ED.dsp_schedule(
        cfg, ctx.sp_size, s_enc=s_enc, s_dec=s_dec, batch=batch,
        joint=True), param_specs=specs)
    layout = ED.param_contract(cfg, meta_tree(params), SEAMLESS_PLAN, sizes)
    return {"params": shard_params(params, specs, ctx), "specs": specs,
            "sharder": sharder, "contract": seamless_contract(
                cfg, (ctx.dp_size, ctx.sp_size), batch, s_enc, s_dec,
                layout)}


def seamless_contract(cfg, shape, batch: int, s_enc: int, s_dec: int,
                      layout: dict) -> dict:
    """{kind: [calls, bytes]} per rank of one loss, its grads, their sums
    and the clip's norm with remat on a ``shape`` (data, model) mesh at a
    global ``batch`` x (``s_enc``, ``s_dec``): ``lm.remat_step`` of
    ``encdec.collective_contract`` (the switches three times over) plus
    ``layout``
    (``encdec.param_contract``: ZeRO-3's gathers per checkpointed layer,
    its reduce-scatters, the trainer's all-reduces)."""
    dp, mp = shape
    hooks = lm.remat_step(ED.collective_contract(
        cfg, mp, batch // dp, s_enc // mp, s_dec // mp))
    return {k: [hooks["calls"].get(k, 0) + layout["calls"].get(k, 0),
                hooks["bytes"].get(k, 0) + layout["bytes"].get(k, 0)]
            for k in sorted(set(hooks["calls"]) | set(layout["calls"]))}


def seamless_world_of_one(phase_c: dict, work: str, device="cuda") -> dict:
    """(d) (c)'s training at world size 1 on a (1, 1) mesh over NCCL under
    SEAMLESS_PLAN (ZeRO-3, each layer gathering its weights inside its
    checkpoint): the losses bit-equal to (c)'s or within DSP_LOSS_BAR
    relative (said which), the calls and bytes exactly
    ``seamless_contract`` each step, K1 as in (c), the step time beside
    (c)'s.  Then (e)'s reference (``seamless_rank_ref``)."""
    backend = BACKEND_OF[torch.device(device).type]
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(work, "store26d"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), torch.device(device).type)
        cfg = seamless_cfg()
        lay = seamless_layout(cfg, mesh, SEAMLESS_BATCH, SEAMLESS_ENC,
                              SEAMLESS_DEC, device)
        sharder = lay["sharder"]
        trained = run_trainer(
            lambda: lay.pop("params"),
            lambda p, b: ED.encdec_loss(p, lm.shard_lm_batch(b, sharder),
                                        cfg, sharder=sharder,
                                        backend="kernel"),
            lambda s: seamless_batch(cfg, SEAMLESS_BATCH, SEAMLESS_ENC,
                                     SEAMLESS_DEC, s, device),
            flash_attention_fwd,
            tokens=SEAMLESS_BATCH * (SEAMLESS_ENC + SEAMLESS_DEC),
            n_steps=SEAMLESS_STEPS,
            n_layers=cfg.n_enc_layers + cfg.n_dec_layers, route="sm90",
            device=device, sharder=sharder,
            launches_per_step=2 * (cfg.n_enc_layers + 2 * cfg.n_dec_layers))
        want = {k: [c * SEAMLESS_STEPS, b * SEAMLESS_STEPS]
                for k, (c, b) in lay["contract"].items()}
        got = {k: [trained["collectives"][k], trained["volume"][k]]
               for k in sorted(trained["collectives"])}
        met, ref = trained["metrics"], phase_c["metrics"]
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(met["losses"], ref["losses"]))
        same = met["losses"] == ref["losses"]
        agree = "bit-equal" if same else f"worst |delta| / |loss| {rel:.3e}"
        log_t(f"  training under {SEAMLESS_PLAN}: calls [count, bytes] {got}; "
              f"the contract {want}; losses {met['losses']} against (c)'s "
              f"{ref['losses']}: {agree} (grad norms {met['grad_norms']} "
              f"against {ref['grad_norms']}); step (median) "
              f"{met['step_ms_median']:.2f} ms against "
              f"{ref['step_ms_median']:.2f} ms; peak "
              f"{met['peak_memory_gb']:.2f} GB against "
              f"{ref['peak_memory_gb']:.2f} GB")
        if got != want or not rel <= DSP_LOSS_BAR:
            raise AssertionError(f"seamless under {SEAMLESS_PLAN}: calls "
                                 f"{got}, the contract says {want}; losses "
                                 f"{met['losses']} against {ref['losses']}")
        del lay
        free_device()
        seamless_rank_ref(work, device)
    finally:
        dist.destroy_process_group()
    trained["bit_equal"] = same
    return trained


def seamless_rank_cfg():
    """(e)'s model: seamless at depth SEAMLESS_RANK_DEPTH +
    SEAMLESS_RANK_DEPTH in float32 (in bf16 each rank's partial grads
    round to 8 bits before the sums, far past the 1e-4 bar)."""
    return seamless_cfg(SEAMLESS_RANK_DEPTH, torch.float32)


def seamless_rank_batch(cfg, device="cuda") -> dict:
    return seamless_batch(cfg, SEAMLESS_RANK_BATCH, SEAMLESS_RANK_ENC,
                          SEAMLESS_RANK_DEC, 0, device)


@contextlib.contextmanager
def relu_held(held: dict, seen: dict):
    """While open, ``layers.mlp`` (seamless's ReLU MLP) computes the same
    function with the ReLU's gradient 0 on the entries ``held`` marks: a
    bool mask of the pre-activations (B, S, d_ff) in the call's own
    layout (on a mesh the rank's shard), keyed by the input's sequence
    length S (the encoder's frames and the decoder's tokens, which differ
    in (e)).  Each length's first pre-activations (the forward's; a
    checkpoint's recompute comes later) go into ``seen``."""
    inner = L.mlp

    def mlp(p, x, kind="silu_glu"):
        if kind != "relu":
            raise ValueError(f"relu_held holds a ReLU MLP, not {kind}")
        pre = L.linear(p["wi"], x)
        seen.setdefault(x.shape[1], pre.detach())
        act = F.relu(pre)
        if x.shape[1] in held:
            act = torch.where(held[x.shape[1]], act.detach(), act)
        return L.linear(p["wo"], act)
    L.mlp = mlp
    try:
        yield
    finally:
        L.mlp = inner


def seamless_rank_ref(work: str, device="cuda") -> None:
    """(e)'s reference on one rank without a mesh, on
    ``seamless_rank_batch``: the forward's ReLU pre-activations of
    ``seamless_rank_cfg`` (the encoder's and the decoder's), the entries
    within SEAMLESS_HELD_TAU of the layer's RMS of 0, and the loss and
    grads with the ReLU's gradient held at 0 there (``relu_held``), in
    ``work/seamless_ref.pt``."""
    cfg = seamless_rank_cfg()
    params = ED.init_encdec(0, cfg, device=device)
    batch = seamless_rank_batch(cfg, device)
    lengths = {"enc": SEAMLESS_RANK_ENC, "dec": SEAMLESS_RANK_DEC}
    seen = {}
    with torch.no_grad(), relu_held({}, seen):
        ED.encdec_loss(params, batch, cfg, backend="kernel")
    pre = {k: seen[n] for k, n in lengths.items()}
    tau = {k: SEAMLESS_HELD_TAU * float(v.square().mean().sqrt())
           for k, v in pre.items()}
    held = {k: pre[k].abs() <= tau[k] for k in lengths}
    leaves = lm.tree_map(lambda p: p.requires_grad_(True), params)
    with relu_held({n: held[k] for k, n in lengths.items()}, {}):
        loss, _ = ED.encdec_loss(leaves, batch, cfg, backend="kernel")
        grads = torch.autograd.grad(loss, lm.tree_leaves(leaves))
    torch.save({"loss": loss.detach().cpu(),
                "grads": [g.cpu() for g in grads], "tau": tau,
                "pre": {k: v.cpu() for k, v in pre.items()},
                "held": {k: v.cpu() for k, v in held.items()}},
               os.path.join(work, "seamless_ref.pt"))
    counts = {k: [int(v.sum()), v.numel(), tau[k]] for k, v in held.items()}
    log_t(f"  (e)'s reference: depth {cfg.n_enc_layers} + {cfg.n_dec_layers} "
          f"in float32, {SEAMLESS_RANK_BATCH} x ({SEAMLESS_RANK_ENC} frames, "
          f"{SEAMLESS_RANK_DEC} tokens): loss {float(loss.detach()):.6f}; "
          f"ReLU entries held [count, of all, tau]: {counts}; "
          f"{os.path.getsize(os.path.join(work, 'seamless_ref.pt')) / 1e9:.2f}"
          f" GB written")
    del params, leaves, grads, seen, pre, held
    free_device()


def relu_signs(seen: dict, mine: dict, lengths: dict) -> dict:
    """(e)'s ReLUs on this rank against the reference's same entries
    (``mine``: the rank's shard of its ``pre`` and ``held``): the sign
    changes outside and inside the held entries, summed over the world,
    and the largest |pre-activation delta| over the world, by layer."""
    out = {}
    for k, n in lengths.items():
        got, want = seen[n], mine[f"pre_{k}"]
        flip = (got > 0) != (want > 0)
        held = mine[f"held_{k}"]
        counts = torch.stack([(flip & ~held).sum(), (flip & held).sum()])
        delta = (got - want).abs().max().reshape(1).double()
        dist.all_reduce(counts)
        dist.all_reduce(delta, op=dist.ReduceOp.MAX)
        out[k] = {"outside": int(counts[0]), "inside": int(counts[1]),
                  "delta": float(delta)}
    return out


def seamless_rank_main(rank: int, world: int, work: str) -> None:
    """One of (e)'s ranks, started by ``seamless_four_ranks`` as
    ``chip_smoke.py --seamless-rank <rank> <world> <dir>``: gloo over the
    card's tensors.  At each mesh of SEAMLESS_RANK_MESHES:
    ``seamless_rank_cfg`` on its slices under SEAMLESS_PLAN (the ranks cut
    theirs in turn), one ``encdec_loss(sharder=)`` on its shard of
    ``seamless_rank_batch`` (its batch slice, its shard of both
    sequences), its grads summed by ``allreduce_grads`` and the clip's
    norm, what it counted, its peak memory, each grad slice against the
    same slice of (d)'s reference.  Written to
    ``<dir>/seamless_rank<r>.json``; every rank waits at a barrier, then
    leaves the group."""
    device = json.load(open(os.path.join(work, "job26.json")))["device"]
    full_f32()
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "store26e"), world), rank=rank, world_size=world)
    try:
        cfg = seamless_rank_cfg()
        ref = torch.load(os.path.join(work, "seamless_ref.pt"), mmap=True)
        res = {}
        for shape in SEAMLESS_RANK_MESHES:
            label = f"{shape[0]}x{shape[1]}"
            mesh = make_mesh(shape, ("data", "model"),
                             torch.device(device).type, backend="gloo")
            ctx = from_mesh(mesh)
            lay = in_turn(rank, world, lambda: seamless_layout(
                cfg, mesh, SEAMLESS_RANK_BATCH, SEAMLESS_RANK_ENC,
                SEAMLESS_RANK_DEC, device))
            specs, sharder = lay["specs"], lay["sharder"]
            leaves = lm.tree_map(lambda p: p.requires_grad_(True),
                                 lay.pop("params"))
            batch = lm.shard_lm_batch(seamless_rank_batch(cfg, device),
                                      sharder)
            mine = lm.shard_lm_batch(
                {f"{a}_{k}": ref[a][k].to(device) for a in ("pre", "held")
                 for k in ("enc", "dec")}, sharder)
            lengths = {"enc": batch["feats"].shape[1],
                       "dec": batch["tokens"].shape[1]}
            assert lengths["enc"] != lengths["dec"], lengths
            seen = {}
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            with relu_held({n: mine[f"held_{k}"]
                            for k, n in lengths.items()}, seen):
                loss, _ = ED.encdec_loss(leaves, batch, cfg, sharder=sharder,
                                         backend="kernel")
                grads = iter(torch.autograd.grad(loss,
                                                 lm.tree_leaves(leaves)))
            loss, grads = allreduce_grads(loss.detach(), lm.tree_map(
                lambda p: next(grads), leaves), specs, ctx)
            slices_norm(grads, specs, ctx)
            got = read_counts()
            got.update(seconds=time.perf_counter() - t0,
                       coord=[ctx.dp_index, ctx.sp_index],
                       contract=lay["contract"],
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            leaves_g = lm.tree_leaves(grads)
            cuts = [tuple(slice(a, b) for a, b in slice_index(
                w.shape, spec, ctx)) for w, spec in zip(
                    ref["grads"], lm.tree_leaves(specs))]
            gaps = torch.tensor([slice_gap(g, w[c]) for g, w, c in zip(
                leaves_g, ref["grads"], cuts)], dtype=torch.float64)
            dist.all_reduce(gaps, op=dist.ReduceOp.MAX)
            paths = leaf_paths(specs)
            relu = relu_signs(seen, mine, lengths)
            sq = torch.tensor([slice_sq(g, w[c]) for g, w, c in zip(
                leaves_g, ref["grads"], cuts)], dtype=torch.float64)
            dist.all_reduce(sq)
            frob = (sq[:, 0] / sq[:, 1].clamp_min(1e-300)).sqrt().tolist()
            shares = (gaps[:, 0] / gaps[:, 1].clamp_min(1e-30)).tolist()
            # the cross-attention's K bias has a zero gradient in exact
            # arithmetic (no rope; the softmax is invariant to a shift
            # along the keys): its rounding noise against the largest grad
            top = float(gaps[:, 1].max())
            for i, p in enumerate(paths):
                if p.endswith(SEAMLESS_ZERO_GRAD):
                    shares[i] = float(gaps[i, 0]) / top
            order = np.argsort(shares)[::-1]
            by_norm = [i for i in np.argsort(frob)[::-1]
                       if not paths[i].endswith(SEAMLESS_ZERO_GRAD)]
            got.update(
                loss=float(loss), loss_rel=float(
                    (loss.cpu() - ref["loss"]).abs() / ref["loss"].abs()),
                grad_rel=shares[order[0]], leaves=len(shares),
                leaf=paths[order[0]],
                next=[[paths[i], shares[i]] for i in order[1:5]],
                norm_rel=[[paths[i], frob[i]] for i in by_norm[:5]],
                relu=relu, tau=ref["tau"], host_gib=host_state())
            res[label] = got
            del leaves, grads, lay, seen, mine
            host_empty_cache()
            torch.cuda.empty_cache()
        json.dump(res, open(os.path.join(work, f"seamless_rank{rank}.json"),
                            "w"))
    finally:
        dist.barrier()
        dist.destroy_process_group()


def seamless_four_ranks(work: str, device="cuda") -> Part:
    """(e) DSP_RANKS processes sharing the card over gloo
    (``seamless_rank_main``), ``seamless_rank_cfg`` in float32 at each
    mesh of SEAMLESS_RANK_MESHES under SEAMLESS_PLAN: the loss within
    SEAMLESS_LOSS_BAR relative of (d)'s one-rank reference, each rank's
    grad slices within SEAMLESS_GRAD_BAR of their leaf's max, both runs
    with the ReLU's gradient held at 0 on the same entries (``relu_held``)
    and no pre-activation outside them changed in sign, each rank's
    calls and bytes exactly ``seamless_contract``, K1 twice per attention
    on ``cuda_cores`` (f32) on the rank's heads."""
    with open(os.path.join(work, "job26.json"), "w") as f:
        json.dump({"device": device}, f)
    t0 = time.perf_counter()
    rcs = yield from ranks_exit("--seamless-rank", work)
    log_t(f"  {DSP_RANKS} ranks exited {rcs} after "
          f"{time.perf_counter() - t0:.1f} s")
    if any(rcs):
        raise AssertionError(f"a seamless rank failed: exit codes {rcs}")
    ranks = [json.load(open(os.path.join(work, f"seamless_rank{r}.json")))
             for r in range(DSP_RANKS)]
    cfg = seamless_rank_cfg()
    route = ROUTES[(cfg.dtype, cfg.head_dim)]
    k1 = 2 * (cfg.n_enc_layers + 2 * cfg.n_dec_layers)
    for shape in SEAMLESS_RANK_MESHES:
        label = f"{shape[0]}x{shape[1]}"
        g = ranks[0][label]
        relu = {k: [v["outside"], v["inside"], v["delta"], g["tau"][k]]
                for k, v in g["relu"].items()}
        log_t(f"  {label}: depth {cfg.n_enc_layers} + {cfg.n_dec_layers} in "
              f"float32, {SEAMLESS_RANK_BATCH} x ({SEAMLESS_RANK_ENC} frames, "
              f"{SEAMLESS_RANK_DEC} tokens): loss {g['loss']:.9f}, |delta| / "
              f"|loss| against one rank {g['loss_rel']:.3e}, worst grad slice "
              f"{g['leaf']} {g['grad_rel']:.3e} of its leaf's max over "
              f"{g['leaves']} leaves (next {g['next']}); by norm "
              f"{g['norm_rel']}; ReLU pre-activations against one rank's "
              f"[sign changes outside the held entries, inside them, the "
              f"largest |delta|, tau]: {relu}")
        if any(v["outside"] for v in g["relu"].values()):
            raise AssertionError(f"{label}: a ReLU pre-activation changed "
                                 f"sign outside the held entries: "
                                 f"{g['relu']}")
        if not g["grad_rel"] <= SEAMLESS_GRAD_BAR:
            raise AssertionError(f"{label}: the {DSP_RANKS}-rank grads "
                                 f"disagree with one rank: {g}")
        for r, res in enumerate(ranks):
            got = res[label]
            log_t(f"  rank {r} (data {got['coord'][0]}, model "
                  f"{got['coord'][1]}): {got['seconds']:.1f} s, peak "
                  f"{got['peak_gb']:.2f} GB, calls {got['calls']}, K1 "
                  f"{got['k1']} {got['k1_routes']} {got['k1_dims']}; host "
                  f"GiB {got['host_gib']}")
            if not (got["loss_rel"] <= SEAMLESS_LOSS_BAR
                    and got["calls"] == got["contract"]
                    and got["k1"] == k1 and got["k1_routes"] == {route: k1}):
                raise AssertionError(f"rank {r} {label}: {got}, {k1} K1 "
                                     f"launches on {route} expected")
    return {"ranks": ranks}


def seamless_phase(work: str, device="cuda", early=None) -> dict:
    """Phase 26, (a) to (e); (e)'s train CLI runs in phase 28.
    ``early()`` runs before (e) (phase 25 (b)'s join)."""
    out = {}
    log("  (a) depth 2 + 2, kernel against plain")
    out["checks"] = seamless_checks(device)
    log(f"  (b) serving at full width and depth ({elapsed()})")
    out["serve"] = seamless_serve(device)
    log(f"  (c) training at full width and depth, {SEAMLESS_STEPS} steps at "
        f"{SEAMLESS_BATCH} x ({SEAMLESS_ENC} frames, {SEAMLESS_DEC} tokens) "
        f"({elapsed()})")
    out["train"] = seamless_train(device)
    log(f"  (d) world size 1 over NCCL under {SEAMLESS_PLAN} ({elapsed()})")
    out["dsp"] = seamless_world_of_one(out["train"], work, device)
    if early is not None:
        early()
    log(f"  (e) {DSP_RANKS} ranks on the card over gloo, depth "
        f"{SEAMLESS_RANK_DEPTH} + {SEAMLESS_RANK_DEPTH} in float32 "
        f"({elapsed()})")
    out["ranks"] = run_part(seamless_four_ranks(work, device))
    return out


# ---------------------------------------------------------------------------
# Phase 27: arctic-480b under its own plan, and MoE served on a mesh
# ---------------------------------------------------------------------------

def arctic_cfg(depth: int, experts=None, dtype=None):
    """arctic-480b's published config at ``depth``, with ``experts``
    routed experts (top-2 kept) and in ``dtype`` where given."""
    cfg = dataclasses.replace(arctic_480b.CONFIG, n_layers=depth)
    if experts is not None:
        cfg = dataclasses.replace(cfg, n_experts=experts)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def replayed(fn, plain=None, against=None) -> dict:
    """``fn()`` (its logits) on the plain path (``plain``, by default
    ``plain_attention``; each MoE call routing itself), then on the kernel
    path (or under ``against``) with the plain path's routing replayed
    call by call (``moe_calls``): {"gap": max |kernel - plain| / max
    |logit|, "launches": the kernel path's K1 launches by route,
    "k2_launches": its K2 launches by route, "differ": the share of
    (token, k) routes on which the kernel path's own pick differs}."""
    with (torch.no_grad(), (plain or plain_attention)(),
          moe_calls() as ref):
        want = fn()
    reset_launches()
    reset_ssd_launches()
    with (torch.no_grad(), (against or contextlib.nullcontext)(),
          moe_calls([c["experts"] for c in ref]) as calls):
        got = fn()
    differ = sum(c["differ"] for c in calls)
    total = sum(c["experts"].numel() for c in calls)
    return {"gap": logit_gap(got, want),
            "launches": nonzero(flash_attention_fwd.route_launches),
            "k2_launches": nonzero(ssd_scan_fwd.route_launches),
            "differ": differ / max(total, 1), "calls": len(calls)}


def arctic_checks(params, cfg, device="cuda") -> dict:
    """(a) ``cfg`` (depth ARCTIC_DEPTH at full width in bf16) on
    ``params``, the kernel path against the plain one, the plain path's
    routing replayed (``replayed``), each within LOGIT_BAR of the largest
    logit: the prefill logits at max(ARCTIC_LENS) tokens and
    SERVE_FORCED_STEPS decode steps; ARCTIC_LENS's requests teacher-forced
    SERVE_FORCED_STEPS decode steps through the slot pool and the block
    pool, both in the config's float8_e4m3fn cache (``forced_logits``,
    ``paged_forced_logits``)."""
    g = torch.Generator(device=device).manual_seed(6)
    s = max(ARCTIC_LENS)
    tok = torch.randint(0, cfg.vocab, (1, s + SERVE_FORCED_STEPS),
                        generator=g, device=device)

    def static():
        logits, caches = lm.forward_prefill(params, tok[:, :s], cfg)
        rows = [logits[0, -1].float()]
        for t in range(SERVE_FORCED_STEPS):
            logits, caches = lm.forward_decode(
                params, tok[:, s + t:s + t + 1], caches, cfg)
            rows.append(logits[0, -1].float())
        return torch.stack(rows)
    eng = ServingEngine(params, cfg, max_len=paged_max_len(
        0, ARCTIC_LENS, SERVE_FORCED_STEPS), device=device)
    reqs = trace_requests(cfg, device, ARCTIC_LENS, SERVE_FORCED_STEPS)
    fed = torch.randint(0, cfg.vocab, (len(reqs), SERVE_FORCED_STEPS),
                        generator=g, device=device).tolist()
    out = {}
    for name, fn in (
            ("static", static),
            ("slot", lambda: forced_logits(eng, reqs, fed, device)),
            ("paged", lambda: paged_forced_logits(eng, reqs, fed,
                                                  PAGED_CHUNK)[0])):
        out[name] = r = replayed(fn)
        log_t(f"  {name}: max |kernel - plain| / max |logit| "
              f"{r['gap']:.3e} over {r['calls']} MoE calls, the plain "
              f"path's routing replayed (the kernel path's own pick differs "
              f"on {r['differ']:.3e} of the routes); K1 {r['launches']} on "
              f"the kernel path")
    kv = KVPool(cfg, 1, 16, device=device).caches["periods"]["0"]["kv"]["k"]
    if kv.dtype != torch.float8_e4m3fn or not max(
            r["gap"] for r in out.values()) <= LOGIT_BAR:
        raise AssertionError(f"arctic at depth {ARCTIC_DEPTH}: kernel "
                             f"against plain {out}, pool {kv.dtype}")
    del eng
    free_device()
    return out


def arctic_mesh_serve(cfg, ref: dict, mesh, plan, device="cuda",
                      **kw) -> dict:
    """``full_width_serve`` of ``cfg`` on ``mesh`` under ``plan`` (the
    calls exactly ``lm.serve_contract``'s, the dispatch's rows from each
    prefill's routing), the tokens ``ref``'s (the same trace without a
    mesh), and TPOT p50 beside ``ref``'s."""
    served = full_width_serve(cfg, flash_attention_fwd, device, mesh=mesh,
                              plan=plan, **kw)
    same = served["tokens"] == ref["tokens"]
    log(f"  tokens under {plan} at world 1 equal to one card's: {same}; "
        f"TPOT p50 {served['metrics']['tpot_p50_s'] * 1e3:.2f} ms against "
        f"{ref['metrics']['tpot_p50_s'] * 1e3:.2f}")
    if not same:
        raise AssertionError(f"{cfg.name} under {plan}: {served['tokens']}, "
                             f"one card {ref['tokens']}")
    return served


def arctic_world_of_one(out: dict, phase22: dict, work: str,
                        device="cuda", early=None) -> None:
    """At world size 1 on a (1, 1) mesh over NCCL: (b)'s depth-1 trace
    under ARCTIC_SERVE_PLAN (``arctic_mesh_serve``); (c)'s training under
    the spec's plan (ARCTIC_PLAN), the losses within DSP_LOSS_BAR of
    (c)'s, the dropped shares equal, the calls and bytes exactly
    ``zero_contract(tp=True)`` each step with the dispatch's rows the
    step's kept pairs in (c); (d) qwen2-moe-a2.7b's phase-22 trace at
    full width and depth under QWEN_MESH_PLAN, the tokens phase 22's; then
    (e)'s references (``arctic_rank_refs``).  ``early()`` runs once (b)'s
    run has given the card back its memory (phase 28's early launches)."""
    backend = BACKEND_OF[torch.device(device).type]
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(work, "store27"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), torch.device(device).type)
        log(f"  (b) the depth-{ARCTIC_DEPTH} trace under "
            f"{ARCTIC_SERVE_PLAN} at world size 1 ({elapsed()})")
        out["tp_serve"] = arctic_mesh_serve(
            arctic_cfg(ARCTIC_DEPTH), out["serve"], mesh,
            ARCTIC_SERVE_PLAN, device, lens=ARCTIC_LENS,
            new_tokens=ARCTIC_NEW)
        if early is not None:
            early()
        log(f"  (c) training under {ARCTIC_PLAN} at world size 1 "
            f"({elapsed()})")
        cfg = arctic_cfg(1, ARCTIC_TRAIN_EXPERTS)
        lay = tp_layout(cfg, mesh, device, plan=ARCTIC_PLAN)
        sharder = lay["sharder"]
        trained = run_trainer(
            lambda: lay.pop("params"),
            lambda p, b: lm.lm_loss(p, b, cfg, sharder=sharder,
                                    backend="kernel"),
            lambda st: lm.shard_lm_batch(lm_batch(cfg, 1, st, device),
                                         sharder),
            flash_attention_fwd, tokens=TRAIN_SEQ,
            n_steps=ARCTIC_TRAIN_STEPS, n_layers=cfg.n_layers, route="sm90",
            device=device, sharder=sharder)
        met, ref = trained["metrics"], out["train"]["metrics"]
        pairs = lm.n_moe_layers(cfg) * TRAIN_SEQ * cfg.top_k
        want = {}
        for dropped in ref["dropped"]:
            kept = pairs - round(dropped * pairs)
            step = zero_contract(cfg, (1, 1), 1, lay["layout"], TRAIN_SEQ,
                                 rows=(kept, kept), tp=True)
            for k, (c, b) in step.items():
                have = want.setdefault(k, [0, 0])
                have[0] += c
                have[1] += b
        got = {k: [trained["collectives"][k], trained["volume"][k]]
               for k in sorted(trained["collectives"])}
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(met["losses"], ref["losses"]))
        log_t(f"  calls [count, bytes] {got}; the contract {want}; losses "
              f"{met['losses']} against (c)'s {ref['losses']}: worst "
              f"|delta| / |loss| = {rel:.3e}; dropped {met['dropped']} "
              f"against {ref['dropped']}; step (median) "
              f"{met['step_ms_median']:.2f} ms against "
              f"{ref['step_ms_median']:.2f} ms; peak "
              f"{met['peak_memory_gb']:.2f} GB against "
              f"{ref['peak_memory_gb']:.2f} GB")
        if (got != want or not rel <= DSP_LOSS_BAR
                or met["dropped"] != ref["dropped"]):
            raise AssertionError(f"arctic under {ARCTIC_PLAN}: calls {got}, "
                                 f"the contract says {want}; losses "
                                 f"{met['losses']} against {ref['losses']}")
        out["tp_train"] = trained
        del lay
        free_device()
        log(f"  (d) qwen2-moe-a2.7b's phase-22 trace under {QWEN_MESH_PLAN} "
            f"at world size 1 ({elapsed()})")
        out["qwen2_mesh"] = arctic_mesh_serve(
            model_cfg("qwen2-moe-a2.7b"), phase22["qwen2-moe-a2.7b"], mesh,
            QWEN_MESH_PLAN, device)
        arctic_rank_refs(work, device)
    finally:
        dist.destroy_process_group()


def arctic_rank_cfg():
    """(e)'s model: arctic's widths at depth ARCTIC_RANK_DEPTH with
    ARCTIC_RANK_EXPERTS experts, in float32 with an f32 KV cache (phase 25
    (b)'s reason)."""
    return dataclasses.replace(arctic_cfg(ARCTIC_RANK_DEPTH,
                                          ARCTIC_RANK_EXPERTS,
                                          torch.float32), cache_dtype=None)


def arctic_rank_batch(cfg, device="cuda") -> dict:
    return make_batch(DataConfig(task="lm_shift", vocab=cfg.vocab,
                                 seq=ARCTIC_RANK_SEQ,
                                 batch=ARCTIC_RANK_BATCH), 0, device=device)


def arctic_rank_max_len() -> int:
    need = max(ARCTIC_RANK_LENS) + ARCTIC_RANK_NEW
    return need + (-need) % DSP_RANKS


def arctic_rank_refs(work: str, device="cuda") -> None:
    """(e)'s references on one rank without a mesh, ``arctic_rank_cfg``:
    the loss, grads and dropped share on ``arctic_rank_batch``
    (``work/arctic_ref.pt``), and the tokens of ARCTIC_RANK_LENS's
    requests through ``ContinuousScheduler`` with each generated token's
    margin, as ``tp_rank_refs`` takes them (``work/arctic_serve.json``)."""
    cfg = arctic_rank_cfg()
    params = lm.init_lm(0, cfg, device=device)
    leaves = lm.tree_map(lambda p: p.requires_grad_(True), params)
    loss, metrics = lm.lm_loss(leaves, arctic_rank_batch(cfg, device), cfg,
                               backend="kernel")
    grads = torch.autograd.grad(loss, lm.tree_leaves(leaves))
    torch.save({"loss": loss.detach().cpu(),
                "dropped": float(metrics["moe_dropped"]),
                "grads": [g.cpu() for g in grads]},
               os.path.join(work, "arctic_ref.pt"))
    del leaves, grads
    eng = ServingEngine(params, cfg, max_len=arctic_rank_max_len(),
                        device=device)
    reqs = trace_requests(cfg, device, ARCTIC_RANK_LENS, ARCTIC_RANK_NEW)
    eng.serve(reqs, continuous=True, max_batch=len(reqs))
    margins = []
    with torch.no_grad():
        for r in reqs:
            seq = torch.cat([r.prompt, torch.tensor(r.generated[:-1],
                                                    device=device)])
            x, _ = lm.forward(params, seq[None], cfg, remat=False)
            logits = lm.logits_fn(params, x[:, len(r.prompt) - 1:],
                                  cfg)[0].float()
            top = logits.topk(2, dim=-1).values
            margins.append(((top[:, 0] - top[:, 1])
                            / logits.abs().amax(-1)).tolist())
    json.dump({"tokens": [r.generated for r in reqs], "margins": margins},
              open(os.path.join(work, "arctic_serve.json"), "w"))
    log_t(f"  (e)'s references: depth {cfg.n_layers}, {cfg.n_experts} "
          f"experts in float32, {ARCTIC_RANK_BATCH} x {ARCTIC_RANK_SEQ}: "
          f"loss {float(loss.detach()):.6f}, dropped share "
          f"{float(metrics['moe_dropped']):.6f}; tokens "
          f"{[r.generated for r in reqs]}")
    del params, eng
    free_device()


def arctic_rank_main(rank: int, world: int, work: str) -> None:
    """One of (e)'s ranks, started by ``arctic_four_ranks`` as
    ``chip_smoke.py --arctic-rank <rank> <world> <dir>``: gloo over the
    card's tensors.  At each mesh of ARCTIC_RANK_MESHES: ``arctic_rank_cfg``
    on its slices under ARCTIC_PLAN (the ranks cut theirs in turn), one
    ``lm_loss(sharder=)`` on its shard of ``arctic_rank_batch`` with its
    grads summed by ``allreduce_grads`` and the clip's norm, what it
    counted, its routing (the forward's MoE calls), its dropped share and
    peak memory, each grad slice against the same slice of the reference.
    Then at (1, world) ARCTIC_RANK_LENS's requests through
    ``ContinuousScheduler`` under each of ARCTIC_RANK_PLANS, ``tp`` + ``ep``
    with ``replan(SERVE_REPLAN_TO)`` at decode step SERVE_REPLAN_STEP: the
    tokens and K1's launches.  Written to ``<dir>/arctic_rank<r>.json`` and
    ``.pt``; every rank waits at a barrier, then leaves the group."""
    device = json.load(open(os.path.join(work, "job27.json")))["device"]
    full_f32()
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "store27e"), world), rank=rank, world_size=world)
    t_start = time.perf_counter()

    def note(what):
        if rank == 0:
            log(f"    rank 0: {what} at {time.perf_counter() - t_start:.1f} "
                f"s, {torch.cuda.memory_allocated() / 1e9:.2f} GB held, "
                f"host GiB {host_state()}")
    try:
        cfg = arctic_rank_cfg()
        ref = torch.load(os.path.join(work, "arctic_ref.pt"), mmap=True)
        res, routes = {}, {}
        for shape in ARCTIC_RANK_MESHES:
            label = f"{shape[0]}x{shape[1]}"
            mesh = make_mesh(shape, ("data", "model"),
                             torch.device(device).type, backend="gloo")
            ctx = from_mesh(mesh)
            lay = in_turn(rank, world, lambda: tp_layout(
                cfg, mesh, device, plan=ARCTIC_PLAN))
            note(f"{label}: the slices cut")
            specs, sharder = lay["specs"], lay["sharder"]
            leaves = lm.tree_map(lambda p: p.requires_grad_(True),
                                 lay.pop("params"))
            batch = lm.shard_lm_batch(arctic_rank_batch(cfg, device),
                                      sharder)
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            with moe_calls() as calls:
                loss, metrics = lm.lm_loss(leaves, batch, cfg,
                                           sharder=sharder, backend="kernel")
            routes[label] = calls
            grads = iter(torch.autograd.grad(loss, lm.tree_leaves(leaves)))
            loss, grads = allreduce_grads(loss.detach(), lm.tree_map(
                lambda p: next(grads), leaves), specs, ctx)
            slices_norm(grads, specs, ctx)
            got = read_counts()
            got.update(seconds=time.perf_counter() - t0,
                       coord=[ctx.dp_index, ctx.sp_index],
                       layout=lay["layout"],
                       dropped=float(metrics["moe_dropped"]),
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            note(f"{label}: the loss and grads")
            gaps = torch.tensor([slice_gap(g, w[tuple(
                slice(a, b) for a, b in slice_index(w.shape, spec, ctx))])
                for g, w, spec in zip(lm.tree_leaves(grads), ref["grads"],
                                      lm.tree_leaves(specs))],
                dtype=torch.float64)
            dist.all_reduce(gaps, op=dist.ReduceOp.MAX)
            shares = (gaps[:, 0] / gaps[:, 1].clamp_min(1e-30)).tolist()
            worst = int(np.argmax(shares))
            got.update(
                loss=float(loss), loss_rel=float(
                    (loss.cpu() - ref["loss"]).abs() / ref["loss"].abs()),
                grad_rel=shares[worst], leaves=len(shares),
                leaf=leaf_paths(specs)[worst], host_gib=host_state())
            res[label] = got
            del leaves, grads, lay
            host_empty_cache()
            torch.cuda.empty_cache()
        torch.save(routes, os.path.join(work, f"arctic_rank{rank}.pt"))
        mesh = make_mesh((1, world), ("data", "model"),
                         torch.device(device).type, backend="gloo")
        for name, plan in ARCTIC_RANK_PLANS.items():
            eng = in_turn(rank, world, lambda: ServingEngine(
                lm.init_lm(0, cfg, device=device), cfg,
                max_len=arctic_rank_max_len(), mesh=mesh, plan=plan,
                device=device))
            note(f"serve {name}: the engine built")
            reqs = trace_requests(cfg, device, ARCTIC_RANK_LENS,
                                  ARCTIC_RANK_NEW)
            sched = ContinuousScheduler(eng, max_batch=len(reqs))

            def on_step(s, k):
                if plan.mode == "tp" and k == SERVE_REPLAN_STEP:
                    s.replan(SERVE_REPLAN_TO)
                    host_empty_cache()
                    torch.cuda.empty_cache()
                    note(f"serve {name}: replanned")
            reset_counts()
            t0 = time.perf_counter()
            sched.run(reqs, on_step=on_step)
            got = read_counts()
            res[f"serve/{name}"] = {
                "active": eng.active, "seconds": time.perf_counter() - t0,
                "tokens": ([r.generated for r in reqs] if eng.active
                           else None),
                "k1": got["k1"], "k1_routes": got["k1_routes"],
                "host_gib": host_state()}
            note(f"serve {name}: served")
            del eng, sched
            free_device()
        json.dump(res, open(os.path.join(work, f"arctic_rank{rank}.json"),
                            "w"))
    finally:
        dist.barrier()
        dist.destroy_process_group()


def arctic_four_ranks(work: str, device="cuda") -> Part:
    """(e) DSP_RANKS processes sharing the card over gloo
    (``arctic_rank_main``), ``arctic_rank_cfg`` in float32 at each mesh of
    ARCTIC_RANK_MESHES under ARCTIC_PLAN: the loss within TP_LOSS_BAR
    relative of the one-rank reference, each rank's grad slices within
    TP_GRAD_BAR of their leaf's max, the ranks' dropped shares summed
    equal to the reference's, each rank's calls and bytes exactly
    ``zero_contract(tp=True)`` with the dispatch's rows from the run's
    routing (``route_rows``), K1 twice a layer on the f32 route on the
    rank's heads; then the requests served under each plan, the tokens
    one rank's up to a near-tie (TP_TIE_BAR), K1 once a layer a prefill.
    Each rank's peak memory and host memory logged."""
    with open(os.path.join(work, "job27.json"), "w") as f:
        json.dump({"device": device}, f)
    t0 = time.perf_counter()
    rcs = yield from ranks_exit("--arctic-rank", work)
    log_t(f"  {DSP_RANKS} ranks exited {rcs} after "
          f"{time.perf_counter() - t0:.1f} s")
    if any(rcs):
        raise AssertionError(f"an arctic rank failed: exit codes {rcs}")
    ranks = [json.load(open(os.path.join(work, f"arctic_rank{r}.json")))
             for r in range(DSP_RANKS)]
    routes = [torch.load(os.path.join(work, f"arctic_rank{r}.pt"))
              for r in range(DSP_RANKS)]
    ref = torch.load(os.path.join(work, "arctic_ref.pt"), mmap=True)
    cfg = arctic_rank_cfg()
    e_phys = lm.moe_meta(cfg).e_phys
    route = ROUTES[(cfg.dtype, cfg.head_dim)]
    k1 = 2 * cfg.n_layers
    cap = lm_capacity(cfg, ARCTIC_RANK_SEQ)
    for shape in ARCTIC_RANK_MESHES:
        label = f"{shape[0]}x{shape[1]}"
        parts = {tuple(res[label]["coord"]): rt[label]
                 for res, rt in zip(ranks, routes)}
        glob = assemble_routes(parts, shape)
        share = sum(res[label]["dropped"] for res in ranks)
        g = ranks[0][label]
        log_t(f"  {label}: depth {cfg.n_layers}, {cfg.n_experts} experts in "
              f"float32, {ARCTIC_RANK_BATCH} x {ARCTIC_RANK_SEQ}: loss "
              f"{g['loss']:.9f}, |delta| / |loss| against one rank "
              f"{g['loss_rel']:.3e}, worst grad slice {g['leaf']} "
              f"{g['grad_rel']:.3e} of its leaf's max over {g['leaves']} "
              f"leaves; dropped share {share} against {ref['dropped']}")
        if not (g["grad_rel"] <= TP_GRAD_BAR
                and abs(share - ref["dropped"]) < 1e-9):
            raise AssertionError(f"{label}: the {DSP_RANKS}-rank grads or "
                                 f"drops disagree with one rank: {g}, "
                                 f"dropped {share} against {ref['dropped']}")
        for r, res in enumerate(ranks):
            got = res[label]
            i, j = got["coord"]
            rows = route_rows(glob, e_phys, cap, shape[0], shape[1], i, j)
            want = zero_contract(cfg, shape, ARCTIC_RANK_BATCH,
                                 got["layout"], ARCTIC_RANK_SEQ, rows,
                                 tp=True)
            log_t(f"  rank {r} (data {i}, model {j}): {got['seconds']:.1f} "
                  f"s, peak {got['peak_gb']:.2f} GB, dispatch rows "
                  f"(received, returned) {rows}, calls {got['calls']}, K1 "
                  f"{got['k1']} {got['k1_routes']} {got['k1_dims']}; host "
                  f"GiB {got['host_gib']}")
            if not (got["loss_rel"] <= TP_LOSS_BAR and got["calls"] == want
                    and got["k1"] == k1 and got["k1_routes"] == {route: k1}):
                raise AssertionError(f"rank {r} {label}: {got}, the contract "
                                     f"says {want} and {k1} K1 launches on "
                                     f"{route}")
    sref = json.load(open(os.path.join(work, "arctic_serve.json")))
    k1 = cfg.n_layers * len(ARCTIC_RANK_LENS)
    for name, plan in ARCTIC_RANK_PLANS.items():
        for r, res in enumerate(ranks):
            sv = res[f"serve/{name}"]
            apart = [next(([t, m[t]] for t, (a, b) in enumerate(zip(g, w))
                           if a != b), None)
                     for g, w, m in zip(sv["tokens"] or [], sref["tokens"],
                                        sref["margins"])]
            survives = plan.mode != "tp" or r < SERVE_REPLAN_TO
            log_t(f"  serve {name}, rank {r}: {sv['seconds']:.1f} s, still "
                  f"serving {sv['active']}, tokens {sv['tokens']}, K1 "
                  f"{sv['k1']} {sv['k1_routes']}; host GiB "
                  f"{sv['host_gib']}; [first step apart, one rank's margin "
                  f"there] {apart}")
            if (sv["active"] != survives
                    or any(a is not None and a[1] > TP_TIE_BAR
                           for a in apart)
                    or sv["k1_routes"] != {route: k1}):
                raise AssertionError(f"serve {name}, rank {r}: {sv}, one "
                                     f"rank {sref} with {k1} K1 launches on "
                                     f"{route}")
    log(f"  tokens against one rank's {sref['tokens']}, margins "
        f"{sref['margins']}")
    return {"ranks": ranks}


def arctic_phase(phase22: dict, work: str, device="cuda",
                 early=None) -> dict:
    """Phase 27, (a) to (d); (e) is ``arctic_four_ranks``, whose ranks run
    beside phases 28 and 29 (a); (f)'s CLIs start with ``early`` (beside
    (c) to (e)) and are checked in phase 28."""
    out = {}
    cfg = arctic_cfg(ARCTIC_DEPTH)
    log(f"  (a) depth {ARCTIC_DEPTH} of {arctic_480b.CONFIG.n_layers}, "
        f"kernel against plain, the KV cache in {cfg.cache_dtype}")
    t0 = time.perf_counter()
    box = {"params": lm.init_lm(0, cfg, device=device)}
    torch.cuda.synchronize()
    log_t(f"  init {lm.param_counts(cfg)['total'] / 1e9:.2f}B params "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB) in "
          f"{time.perf_counter() - t0:.1f} s")
    out["checks"] = arctic_checks(box["params"], cfg, device)
    log(f"  (b) depth {ARCTIC_DEPTH}, the same weights: {len(ARCTIC_LENS)} "
        f"requests over {ARCTIC_LENS} tokens, {ARCTIC_NEW} new tokens each, "
        f"one card, the reference of its run under {ARCTIC_SERVE_PLAN} "
        f"({elapsed()})")
    out["serve"] = full_width_serve(cfg, flash_attention_fwd, device,
                                    lens=ARCTIC_LENS, new_tokens=ARCTIC_NEW,
                                    params=box.pop("params"))
    log(f"  (c) training at depth 1 with {ARCTIC_TRAIN_EXPERTS} experts, "
        f"{ARCTIC_TRAIN_STEPS} steps at 1 x {TRAIN_SEQ} ({elapsed()})")
    out["train"] = full_width_train(arctic_cfg(1, ARCTIC_TRAIN_EXPERTS),
                                    flash_attention_fwd, 1,
                                    ARCTIC_TRAIN_STEPS, device)
    free_device()
    arctic_world_of_one(out, phase22, work, device, early)
    return out


# ---------------------------------------------------------------------------
# Phase 29: seamless-m4t-large-v2 served on a (data, model) mesh
# ---------------------------------------------------------------------------

def seamless_serve_contract(cfg, template, plan, shape, requests: int,
                            s_enc: int, new: int) -> dict:
    """{kind: [calls, bytes]} per rank of ``seamless_greedy`` on a
    ``shape`` (data, model) mesh under ``plan``: one prefill of
    ``requests`` requests of ``s_enc`` frames and SEAMLESS_PROMPT-token
    prompts and ``new`` - 1 decode steps, each with its argmax
    (``encdec.serve_contract``)."""
    dp, n = shape
    return add_contracts(
        ED.serve_contract(cfg, n, template, plan, dp=dp,
                          prefill=(requests, s_enc, SEAMLESS_PROMPT)),
        *[ED.serve_contract(cfg, n, template, plan, dp=dp,
                            decode=requests)] * (new - 1))


def seamless_mesh_world_of_one(served: dict, work: str,
                               device="cuda") -> dict:
    """(a) phase 26 (b)'s trace at full width and depth on a (1, 1) mesh
    over NCCL under SEAMLESS_PLAN (ZeRO-3: each layer's weights and the
    table gathered where they are read, at one rank a copy): the tokens
    phase 26 (b)'s, the calls and bytes exactly
    ``seamless_serve_contract``, K1 n_enc + 2 n_dec launches on ``sm90``
    at D 64; TTFT and TPOT beside phase 26 (b)'s.  Then (b)'s reference
    (``seamless_serve_rank_ref``)."""
    backend = BACKEND_OF[torch.device(device).type]
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(work, "store29a"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), torch.device(device).type)
        ctx = from_mesh(mesh)
        cfg = seamless_cfg()
        t0 = time.perf_counter()
        params = ED.init_encdec(0, cfg, device=device)
        template = meta_tree(params)
        specs = param_pspecs(params, SEAMLESS_PLAN,
                             axis_sizes=mesh_sizes(ctx))
        params = shard_params(params, specs, ctx)
        sharder = make_sharder(mesh, SEAMLESS_PLAN, param_specs=specs)
        torch.cuda.synchronize()
        log_t(f"  init and layout in {time.perf_counter() - t0:.1f} s")
        reqs = lm.shard_lm_batch(seamless_requests(cfg, device), sharder)
        run = seamless_greedy(params, reqs, cfg,
                              SEAMLESS_PROMPT + SEAMLESS_NEW, SEAMLESS_NEW,
                              sharder)
        got, met = run["counts"], run["metrics"]
        want = seamless_serve_contract(cfg, template, SEAMLESS_PLAN, (1, 1),
                                       SEAMLESS_REQUESTS, SEAMLESS_ENC,
                                       SEAMLESS_NEW)
        k1 = cfg.n_enc_layers + 2 * cfg.n_dec_layers
        ref = served["metrics"]
        same = run["tokens"] == served["tokens"]
        log_t(f"  under {SEAMLESS_PLAN}: tokens "
              f"{'equal to' if same else 'NOT'} phase 26 (b)'s; TTFT {met['ttft_ms']:.2f} ms, TPOT p50 "
              f"{met['tpot_ms_p50']:.2f} p99 {met['tpot_ms_p99']:.2f} ms "
              f"against one card's {ref['ttft_ms']:.2f}, "
              f"{ref['tpot_ms_p50']:.2f}, {ref['tpot_ms_p99']:.2f}; peak "
              f"{met['peak_memory_gb']:.2f} GB against "
              f"{ref['peak_memory_gb']:.2f}; K1 {got['k1']} "
              f"{got['k1_routes']} at head dims {got['k1_dims']}; calls "
              f"[count, bytes] {got['calls']}, the contract {want}")
        if (not same or got["calls"] != want
                or got["k1"] != k1 or got["k1_routes"] != {"sm90": k1}
                or got["k1_dims"] != {str(cfg.head_dim): k1}):
            raise AssertionError(f"seamless served under {SEAMLESS_PLAN}: "
                                 f"tokens {run['tokens']} against "
                                 f"{served['tokens']}, counted {got}, the "
                                 f"contract {want}, {k1} K1 on sm90")
        del params
        free_device()
        seamless_serve_rank_ref(work, device)
    finally:
        dist.destroy_process_group()
    return {"launches": got["k1"], "routes": got["k1_routes"],
            "tokens": run["tokens"], "metrics": met}


def seamless_serve_rank_requests(cfg, device="cuda") -> dict:
    """(b)'s requests: SEAMLESS_REQUESTS of SEAMLESS_RANK_ENC frames and
    SEAMLESS_PROMPT-token prompts, as one batch."""
    b = seamless_batch(cfg, SEAMLESS_REQUESTS, SEAMLESS_RANK_ENC,
                       SEAMLESS_PROMPT, 9, device)
    return {"feats": b["feats"], "tokens": b["tokens"]}


def seamless_serve_rank_ref(work: str, device="cuda") -> None:
    """(b)'s reference on one rank without a mesh: ``seamless_rank_cfg``
    in float32 served greedily (``seamless_greedy``), each generated
    token's margin beside it (``work/seamless_serve.json``)."""
    cfg = seamless_rank_cfg()
    params = ED.init_encdec(0, cfg, device=device)
    margins = []
    run = seamless_greedy(params, seamless_serve_rank_requests(cfg, device),
                          cfg, SEAMLESS_PROMPT + SEAMLESS_SERVE_RANK_NEW,
                          SEAMLESS_SERVE_RANK_NEW, margins=margins)
    json.dump({"tokens": run["tokens"],
               "margins": [list(m) for m in zip(*margins)]},
              open(os.path.join(work, "seamless_serve.json"), "w"))
    log_t(f"  (b)'s reference: depth {cfg.n_enc_layers} + "
          f"{cfg.n_dec_layers} in float32, tokens {run['tokens']}")
    del params
    free_device()


def seamless_serve_rank_main(rank: int, world: int, work: str) -> None:
    """One of (b)'s ranks, started by ``seamless_serve_four_ranks`` as
    ``chip_smoke.py --seamless-serve-rank <rank> <world> <dir>``: gloo over
    the card's tensors.  At each mesh of SEAMLESS_RANK_MESHES:
    ``seamless_rank_cfg`` laid out under SEAMLESS_SERVE_RANK_PLAN (the
    ranks cut theirs in turn), its shard of
    ``seamless_serve_rank_requests`` served greedily
    (``seamless_greedy(sharder=)``), the tokens, the calls and K1's
    launches beside the contract, in ``<dir>/seamless_serve_rank<r>.json``;
    every rank waits at a barrier, then leaves the group."""
    device = json.load(open(os.path.join(work, "job29.json")))["device"]
    full_f32()
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "store29b"), world), rank=rank, world_size=world)
    try:
        cfg = seamless_rank_cfg()
        res = {}
        for shape in SEAMLESS_RANK_MESHES:
            label = f"{shape[0]}x{shape[1]}"
            mesh = make_mesh(shape, ("data", "model"),
                             torch.device(device).type, backend="gloo")
            ctx = from_mesh(mesh)

            def layout():
                whole = ED.init_encdec(0, cfg, device=device)
                specs = param_pspecs(whole, SEAMLESS_SERVE_RANK_PLAN,
                                     axis_sizes=mesh_sizes(ctx))
                return (shard_params(whole, specs, ctx), specs,
                        meta_tree(whole))
            params, specs, template = in_turn(rank, world, layout)
            sharder = make_sharder(mesh, SEAMLESS_SERVE_RANK_PLAN,
                                   param_specs=specs)
            reqs = lm.shard_lm_batch(seamless_serve_rank_requests(
                cfg, device), sharder)
            t0 = time.perf_counter()
            run = seamless_greedy(
                params, reqs, cfg, SEAMLESS_PROMPT + SEAMLESS_SERVE_RANK_NEW,
                SEAMLESS_SERVE_RANK_NEW, sharder)
            res[label] = {
                **run["counts"], "tokens": run["tokens"],
                "seconds": time.perf_counter() - t0,
                "coord": [ctx.dp_index, ctx.sp_index],
                "contract": seamless_serve_contract(
                    cfg, template, SEAMLESS_SERVE_RANK_PLAN, shape,
                    SEAMLESS_REQUESTS, SEAMLESS_RANK_ENC,
                    SEAMLESS_SERVE_RANK_NEW),
                "host_gib": host_state()}
            del params
            host_empty_cache()
            torch.cuda.empty_cache()
        json.dump(res, open(os.path.join(
            work, f"seamless_serve_rank{rank}.json"), "w"))
    finally:
        dist.barrier()
        dist.destroy_process_group()


def seamless_serve_four_ranks(work: str, device="cuda") -> Part:
    """(b) DSP_RANKS processes sharing the card over gloo
    (``seamless_serve_rank_main``): at each mesh of SEAMLESS_RANK_MESHES
    each rank's tokens (its batch slice) one rank's up to a near-tie (at
    the first step that differs, one rank's two best logits within
    TP_TIE_BAR of its largest), its calls and bytes exactly the contract,
    K1 n_enc + 2 n_dec launches on the float32 route on its heads."""
    with open(os.path.join(work, "job29.json"), "w") as f:
        json.dump({"device": device}, f)
    t0 = time.perf_counter()
    rcs = yield from ranks_exit("--seamless-serve-rank", work)
    log_t(f"  {DSP_RANKS} ranks exited {rcs} after "
          f"{time.perf_counter() - t0:.1f} s")
    if any(rcs):
        raise AssertionError(f"a seamless serving rank failed: exit codes "
                             f"{rcs}")
    ranks = [json.load(open(os.path.join(
        work, f"seamless_serve_rank{r}.json"))) for r in range(DSP_RANKS)]
    ref = json.load(open(os.path.join(work, "seamless_serve.json")))
    cfg = seamless_rank_cfg()
    route = ROUTES[(cfg.dtype, cfg.head_dim)]
    k1 = cfg.n_enc_layers + 2 * cfg.n_dec_layers
    for shape in SEAMLESS_RANK_MESHES:
        label = f"{shape[0]}x{shape[1]}"
        rows = SEAMLESS_REQUESTS // shape[0]
        for r, res in enumerate(ranks):
            got = res[label]
            first = got["coord"][0] * rows
            want = ref["tokens"][first:first + rows]
            apart = [next(([t, m[t]] for t, (a, b) in enumerate(zip(g, w))
                           if a != b), None)
                     for g, w, m in zip(got["tokens"], want,
                                        ref["margins"][first:first + rows])]
            log_t(f"  {label} rank {r} (data {got['coord'][0]}, model "
                  f"{got['coord'][1]}): {got['seconds']:.1f} s, tokens "
                  f"{got['tokens']}, [first step apart, one rank's margin "
                  f"there] {apart}; calls {got['calls']}; K1 {got['k1']} "
                  f"{got['k1_routes']}; host GiB {got['host_gib']}")
            if (any(a is not None and a[1] > TP_TIE_BAR for a in apart)
                    or got["calls"] != got["contract"] or got["k1"] != k1
                    or got["k1_routes"] != {route: k1}):
                raise AssertionError(f"rank {r} {label}: {got}, one rank's "
                                     f"tokens {want}, {k1} K1 on {route}")
    log(f"  one rank's tokens {ref['tokens']}")
    return {"ranks": ranks}


# ---------------------------------------------------------------------------
# Phase 30: pixtral-12b and the VLM frontend
# ---------------------------------------------------------------------------

def pixtral_cfg(depth=None):
    return _PX if depth is None else dataclasses.replace(_PX, n_layers=depth)


def pixtral_batch(cfg, seq: int, step: int, device="cuda") -> dict:
    """One ``lm_random`` sequence of ``seq`` tokens with its patch rows
    (``extra["patch_embeds"]``, float32), as JAX's data gives a VLM
    config."""
    return make_batch(DataConfig(
        task="lm_random", vocab=cfg.vocab, seq=seq, batch=1,
        frontend_tokens=cfg.frontend_tokens, in_dim=cfg.frontend_dim), step,
        device=device)


def pixtral_checks(device="cuda") -> dict:
    """(a) depth PIXTRAL_DEPTH, kernel against plain on ``pixtral_batch``
    at TRAIN_SEQ tokens whose patch rows replace the first 1024: the
    prefill's last logits within LOGIT_BAR of the largest, the loss within
    LOSS_BAR relative and every grad leaf, the frontend's included, within
    GRAD_BAR of its max."""
    cfg = pixtral_cfg(PIXTRAL_DEPTH)
    params = lm.init_lm(0, cfg, device=device)
    batch = pixtral_batch(cfg, TRAIN_SEQ, 0, device)
    with torch.no_grad():
        got, _ = lm.forward_prefill(params, batch["tokens"], cfg,
                                    backend="kernel", extra=batch["extra"])
        want, _ = lm.forward_prefill(params, batch["tokens"], cfg,
                                     backend="ref", extra=batch["extra"])
    logits = logit_gap(got, want)
    gap = loss_grads_gap(params, batch, cfg)
    log_t(f"  depth {cfg.n_layers}, 1 x {TRAIN_SEQ} with {cfg.frontend_tokens}"
          f" patch rows: prefill logits |kernel - plain| / max |logit| "
          f"{logits:.3e}; loss {gap['loss']:.6f}, |delta| / |loss| "
          f"{gap['loss_rel']:.3e}; worst grad leaf {gap['leaf']} "
          f"{gap['grad_rel']:.3e} over {gap['leaves']} leaves")
    if not (logits <= LOGIT_BAR and gap_passes(gap)):
        raise AssertionError(f"pixtral depth {cfg.n_layers}: logits "
                             f"{logits}, {gap}")
    del params
    free_device()
    return {"logits": logits, **gap}


def pixtral_serve(device="cuda") -> dict:
    """(b) full depth behind the scheduler (``full_width_serve``, text, K1
    once a layer a prefill on PIXTRAL_ROUTE), then one
    ``forward_prefill(extra=)`` of a PIXTRAL_PREFILL-token prompt with its
    patch rows, the counters set to 0 just before and read just after:
    K1 once a layer on PIXTRAL_ROUTE, finite logits."""
    cfg = pixtral_cfg()
    params = lm.init_lm(0, cfg, device=device)
    out = full_width_serve(cfg, flash_attention_fwd, lens=PIXTRAL_LENS,
                           new_tokens=PIXTRAL_NEW, route=PIXTRAL_ROUTE,
                           params=params)
    batch = pixtral_batch(cfg, PIXTRAL_PREFILL, 1, device)
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        logits, _ = lm.forward_prefill(params, batch["tokens"], cfg,
                                       backend="kernel",
                                       extra=batch["extra"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = read_counts()
    log_t(f"  one prefill of {PIXTRAL_PREFILL} tokens with "
          f"{cfg.frontend_tokens} patch rows: {seconds * 1e3:.2f} ms, K1 "
          f"{got['k1']} {got['k1_routes']} at head dims {got['k1_dims']}")
    if (got["k1"] != cfg.n_layers
            or got["k1_routes"] != {PIXTRAL_ROUTE: cfg.n_layers}
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"pixtral's prefill with patch rows: {got}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    del params, logits
    free_device()
    return {**out, "patch_prefill": {"launches": got["k1"],
                                     "routes": got["k1_routes"],
                                     "ms": seconds * 1e3}}


def pixtral_train(device="cuda") -> tuple:
    """(c) PIXTRAL_STEPS Trainer steps at depth PIXTRAL_DEPTH, 1 x
    TRAIN_SEQ with the patch rows (``run_trainer``, K1 twice a layer a
    step on PIXTRAL_ROUTE); then the same at world size 1 on a (1, 1)
    mesh over NCCL under PIXTRAL_PLAN (ZeRO-3, the frontend gathered
    where it is read): the losses within DSP_LOSS_BAR of the first run's
    (bit-equal said so), the calls and bytes exactly ``zero_contract``
    with ``param_contract(patches=True)`` each step."""
    cfg = pixtral_cfg(PIXTRAL_DEPTH)
    one = run_trainer(
        lambda: lm.init_lm(0, cfg, device=device),
        lambda p, b: lm.lm_loss(p, b, cfg, backend="kernel"),
        lambda st: pixtral_batch(cfg, TRAIN_SEQ, st, device),
        flash_attention_fwd, tokens=TRAIN_SEQ, n_steps=PIXTRAL_STEPS,
        n_layers=cfg.n_layers, route=PIXTRAL_ROUTE, device=device)
    backend = BACKEND_OF[torch.device(device).type]
    with tempfile.TemporaryDirectory() as work:
        dist.init_process_group(backend, store=dist.FileStore(
            os.path.join(work, "store30c"), 1), rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"),
                             torch.device(device).type)
            ctx = from_mesh(mesh)
            sizes = mesh_sizes(ctx)
            params = lm.init_lm(0, cfg, device=device)
            specs = param_pspecs(params, PIXTRAL_PLAN, axis_sizes=sizes)
            contract = zero_contract(cfg, (1, 1), 1, lm.param_contract(
                cfg, meta_tree(params), PIXTRAL_PLAN, sizes, patches=True))
            sharder = make_sharder(mesh, PIXTRAL_PLAN, schedule=(
                lm.dsp_schedule(cfg, 1, seq=TRAIN_SEQ, batch=1, joint=True)),
                param_specs=specs)
            params = [shard_params(params, specs, ctx)]
            zero = run_trainer(
                lambda: params.pop(),
                lambda p, b: lm.lm_loss(p, b, cfg, sharder=sharder,
                                        backend="kernel"),
                lambda st: lm.shard_lm_batch(
                    pixtral_batch(cfg, TRAIN_SEQ, st, device), sharder),
                flash_attention_fwd, tokens=TRAIN_SEQ,
                n_steps=PIXTRAL_STEPS, n_layers=cfg.n_layers,
                route=PIXTRAL_ROUTE, device=device, sharder=sharder)
        finally:
            dist.destroy_process_group()
    want = {k: [c * PIXTRAL_STEPS, b * PIXTRAL_STEPS]
            for k, (c, b) in contract.items()}
    got = {k: [zero["collectives"][k], zero["volume"][k]]
           for k in sorted(zero["collectives"])}
    met, ref = zero["metrics"], one["metrics"]
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(met["losses"], ref["losses"]))
    same = met["losses"] == ref["losses"]
    log_t(f"  under {PIXTRAL_PLAN}: calls [count, bytes] {got}; the "
          f"contract {want}; losses {met['losses']} against "
          f"{ref['losses']}: "
          + ("bit-equal" if same else f"worst |delta| / |loss| {rel:.3e}")
          + f"; step (median) {met['step_ms_median']:.2f} ms against "
          f"{ref['step_ms_median']:.2f} ms; peak {met['peak_memory_gb']:.2f} "
          f"GB against {ref['peak_memory_gb']:.2f} GB")
    if got != want or not rel <= DSP_LOSS_BAR:
        raise AssertionError(f"pixtral under {PIXTRAL_PLAN}: calls {got}, "
                             f"the contract {want}; losses {met['losses']} "
                             f"against {ref['losses']}")
    zero["bit_equal"] = same
    free_device()
    return one, zero


def pixtral_phase(device="cuda") -> dict:
    """Phase 30, (a) to (d)."""
    out = {}
    log(f"  (a) depth {PIXTRAL_DEPTH}, kernel against plain, with patch rows")
    out["checks"] = pixtral_checks(device)
    log(f"  (b) served at full width and depth ({elapsed()})")
    out["serve"] = pixtral_serve(device)
    log(f"  (c) trained at depth {PIXTRAL_DEPTH}, {PIXTRAL_STEPS} steps at 1 "
        f"x {TRAIN_SEQ} with patch rows, then under {PIXTRAL_PLAN} at world "
        f"size 1 ({elapsed()})")
    out["train"], out["zero"] = pixtral_train(device)
    log(f"  (d) K1 at pixtral's prefill shape ({elapsed()})")
    out["attn"] = {name: time_model_attention(name, case)
                   for name, case in PIXTRAL_ATTN.items()}
    return out


# ---------------------------------------------------------------------------
# Phase 31: jamba-1.5-large-398b
# ---------------------------------------------------------------------------

def jamba_cfg(experts=JAMBA_EXPERTS, dtype=None):
    """jamba's published config cut to one period (8 layers) with
    ``experts`` of its 16 experts, in ``dtype`` where given."""
    cfg = dataclasses.replace(_JA, n_layers=len(_JA.period_specs()),
                              n_experts=experts)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


@contextlib.contextmanager
def nudged_plain(seed: int = 11):
    """``plain_kernels``, with the float32 result of every plain K1 and K2
    call perturbed by JAMBA_NUDGE relative noise (seeded normals) before
    its one rounding to the model's dtype: the plain path as another
    order of the same float32 sums would give it."""
    fa, ssd = kernel_ops.flash_attention_plain, kernel_ops.ssd_scan_plain
    gen = {}

    def nudge(y, dtype):
        if not gen:
            gen["g"] = torch.Generator(device=y.device).manual_seed(seed)
        noise = torch.randn(y.shape, generator=gen["g"], device=y.device)
        return (y * (1 + JAMBA_NUDGE * noise)).to(dtype)

    def fa_nudged(q, k, v, **kw):
        return nudge(fa(q.float(), k.float(), v.float(), **kw), q.dtype)

    def ssd_nudged(xdt, da, b, c, *, chunk=128):
        return nudge(ssd(xdt.float(), da, b.float(), c.float(), chunk=chunk),
                     xdt.dtype)
    kernel_ops.flash_attention_plain = fa_nudged
    kernel_ops.ssd_scan_plain = ssd_nudged
    try:
        with plain_kernels():
            yield
    finally:
        kernel_ops.flash_attention_plain = fa
        kernel_ops.ssd_scan_plain = ssd


@contextlib.contextmanager
def plain_kernels():
    """``plain_attention``, and every K2 call of the model's SSM layers
    (``models.ssm.ssd_scan``) on its plain version too."""
    inner = ssm_mod.ssd_scan

    def plain(*a, **kw):
        return inner(*a, **{**kw, "backend": "ref"})
    ssm_mod.ssd_scan = plain
    try:
        with plain_attention():
            yield
    finally:
        ssm_mod.ssd_scan = inner


def jamba_checks(params, cfg, device="cuda") -> dict:
    """(a) ``cfg`` (one period at full width in bf16, JAMBA_EXPERTS
    experts) on ``params``, the kernel path against the plain one
    (``plain_kernels``), the plain path's routing replayed
    (``replayed``): the prefill logits of a JAMBA_PREFILL-token prompt and
    SERVE_FORCED_STEPS decode steps; JAMBA_LENS's requests teacher-forced
    SERVE_FORCED_STEPS decode steps through the slot pool in the config's
    float8_e4m3fn cache beside the SSM states (``forced_logits``).  Each
    within LOGIT_BAR of the largest logit or, where the plain path's own
    rounding noise reaches that, within JAMBA_NOISE_FACTOR times it: the
    plain path against itself with each kernel's float32 result nudged
    (``nudged_plain``), the same routing.  The kernel path's launches: K1
    once and K2 seven times a prefill, on ``sm90``."""
    g = torch.Generator(device=device).manual_seed(6)
    s = JAMBA_PREFILL
    tok = torch.randint(0, cfg.vocab, (1, s + SERVE_FORCED_STEPS),
                        generator=g, device=device)

    def static():
        logits, caches = lm.forward_prefill(params, tok[:, :s], cfg)
        rows = [logits[0, -1].float()]
        for t in range(SERVE_FORCED_STEPS):
            logits, caches = lm.forward_decode(
                params, tok[:, s + t:s + t + 1], caches, cfg)
            rows.append(logits[0, -1].float())
        return torch.stack(rows)
    eng = ServingEngine(params, cfg, max_len=max(JAMBA_LENS)
                        + SERVE_FORCED_STEPS, device=device)
    reqs = trace_requests(cfg, device, JAMBA_LENS, SERVE_FORCED_STEPS)
    fed = torch.randint(0, cfg.vocab, (len(reqs), SERVE_FORCED_STEPS),
                        generator=g, device=device).tolist()
    layers = {k.__name__: n for k, n in kernel_layers(cfg).items()}
    out = {}
    for name, fn, prefills in (
            ("static", static, 1),
            ("slot", lambda: forced_logits(eng, reqs, fed, device),
             len(reqs))):
        out[name] = r = replayed(fn, plain_kernels)
        r["noise"] = replayed(fn, plain_kernels, nudged_plain)["gap"]
        r["bar"] = max(LOGIT_BAR, JAMBA_NOISE_FACTOR * r["noise"])
        log_t(f"  {name}: max |kernel - plain| / max |logit| "
              f"{r['gap']:.3e} over {r['calls']} MoE calls, the plain "
              f"path's routing replayed (the kernel path's own pick differs "
              f"on {r['differ']:.3e} of the routes); the plain path "
              f"against itself nudged {r['noise']:.3e}, so the bar "
              f"{r['bar']:.3e}; K1 {r['launches']}, K2 {r['k2_launches']} "
              f"on the kernel path")
        want = ({"sm90": layers["flash_attention_fwd"] * prefills},
                {"sm90": layers["ssd_scan_fwd"] * prefills})
        if (r["launches"], r["k2_launches"]) != want:
            raise AssertionError(f"jamba (a) {name}: K1 {r['launches']}, K2 "
                                 f"{r['k2_launches']}; expected {want}")
    kv = next(v for v in KVPool(cfg, 1, 16, device=device).caches[
        "periods"].values() if "kv" in v)["kv"]["k"]
    if kv.dtype != torch.float8_e4m3fn or not all(
            r["gap"] <= r["bar"] for r in out.values()):
        raise AssertionError(f"jamba: kernel against plain {out}, pool "
                             f"{kv.dtype}")
    del eng
    free_device()
    return out


def time_ssd(case, seed: int, what: str) -> dict:
    """K2 at ``case`` in bf16 on its route (``sm90``) and on ``cuda_cores``,
    three times each in turns (medians), its plain version, beside the
    bound (``ssd_bound_ms``); no PyTorch call computes the chunked scan.
    ``what`` names the shape in the log."""
    xdt, da, b, c = ssd_inputs(case, torch.bfloat16, seed=seed)
    chunk = case[6]
    route = ssd_route(torch.bfloat16, case[3], case[5], chunk)
    runs = {route: [], "cuda_cores": []}
    for who in (route, "cuda_cores", "cuda_cores", route, route,
                "cuda_cores"):
        runs[who].append(time_ms(
            lambda: ssd_scan_fwd(xdt, da, b, c, chunk=chunk, route=who),
            iters=20 if who == "sm90" else 5))
    med = {w: float(np.median(r)) for w, r in runs.items()}
    plain_ms = time_ms(lambda: ssd_scan_plain(xdt, da, b, c, chunk=chunk),
                       iters=5)
    bound = ssd_bound_ms(case, torch.bfloat16)
    log_t(f"  ssd_scan at {what} {tuple(case)}: {route} {med[route]:.4f} ms "
          f"(runs {runs[route]})  cuda_cores {med['cuda_cores']:.4f} ms "
          f"(runs {runs['cuda_cores']})  plain {plain_ms:.4f} ms  library "
          f"none  bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
          f"{bound['flops']:.3e} FLOP, {bound['bytes']:.3e} B; {route} at "
          f"{100 * bound['bound_ms'] / med[route]:.1f}% of the bound, "
          f"{bound['bytes'] / med[route] / 1e6:.1f} GB/s)")
    del xdt, da, b, c
    torch.cuda.empty_cache()
    return {"shape": list(case), "route": route, "ms": med[route],
            "cuda_cores_ms": med["cuda_cores"], "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"]}


def jamba_world_of_one(out: dict, work: str, device="cuda") -> None:
    """(b) at world size 1 on a (1, 1) mesh over NCCL: the trace under
    JAMBA_SERVE_PLAN (``arctic_mesh_serve``: the tokens one card's, the
    calls and bytes exactly ``lm.serve_contract``'s, K1 4 and K2 28 on
    ``sm90``)."""
    backend = BACKEND_OF[torch.device(device).type]
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(work, "store31b"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), torch.device(device).type)
        out["mesh_serve"] = arctic_mesh_serve(
            jamba_cfg(), out["serve"], mesh, JAMBA_SERVE_PLAN, device,
            lens=JAMBA_LENS, new_tokens=JAMBA_NEW)
    finally:
        dist.destroy_process_group()


def jamba_rank_cfg():
    """(d)'s model: one period of jamba's layers at cut widths with its
    head shapes kept (JAMBA_RANK_WIDTHS: SSD heads of P 128, S 128, chunk
    128, attention heads of 128), JAMBA_RANK_EXPERTS experts top-2, in
    float32 with an f32 KV cache (phase 25 (b)'s reason)."""
    w = JAMBA_RANK_WIDTHS
    sc = dataclasses.replace(_JS, d_model=w["d_model"],
                             d_inner=w["d_inner"], n_groups=w["n_groups"])
    return dataclasses.replace(
        jamba_cfg(JAMBA_RANK_EXPERTS, torch.float32), d_model=w["d_model"],
        n_heads=w["n_heads"], n_kv_heads=w["n_kv_heads"], d_ff=w["d_ff"],
        ssm_cfg=sc, cache_dtype=None)


def jamba_rank_init(cfg, device="cuda"):
    """(d)'s weights: ``lm.init_lm(0, cfg)`` with a router bias
    (JAMBA_RANK_ROUTER_BIAS on expert 0) on every MoE layer."""
    params = lm.init_lm(0, cfg, device=device)
    for layer in params["periods"].values():
        if "moe" in layer:
            w = layer["moe"]["router"]["w"]                 # (P, d, E)
            b = w.new_zeros((w.shape[0], w.shape[2]))
            b[:, 0] = JAMBA_RANK_ROUTER_BIAS
            layer["moe"]["router"]["b"] = b
    return params


def jamba_rank_batch(cfg, device="cuda") -> dict:
    return make_batch(DataConfig(task="lm_shift", vocab=cfg.vocab,
                                 seq=JAMBA_RANK_SEQ,
                                 batch=JAMBA_RANK_BATCH), 0, device=device)


def jamba_rank_max_len() -> int:
    need = max(JAMBA_RANK_LENS) + JAMBA_RANK_NEW
    return need + (-need) % DSP_RANKS


def jamba_rank_refs(work: str, device="cuda"):
    """(d)'s references on one rank without a mesh, ``jamba_rank_cfg``:
    the loss (the load-balance aux included), grads, dropped share and
    each MoE call's routing and drops on ``jamba_rank_batch``
    (``work/jamba_ref.pt``), and the tokens of JAMBA_RANK_LENS's requests
    through ``ContinuousScheduler`` with each generated token's margin
    (``work/jamba_serve.json``), as ``arctic_rank_refs`` takes them; and
    each grad leaf's own f32 noise, max |nudged - grad| / max |grad| with
    the embedding table nudged by JAMBA_RANK_NUDGE (``noise``).  Returns
    the model's tree as meta tensors."""
    cfg = jamba_rank_cfg()
    params = jamba_rank_init(cfg, device)
    template = meta_tree(params)
    batch = jamba_rank_batch(cfg, device)
    with torch.no_grad(), moe_calls() as calls:
        lm.forward(params, batch["tokens"], cfg, backend="kernel",
                   remat=False)

    def loss_grads(tree):
        leaves = lm.tree_map(lambda p: p.detach().requires_grad_(True), tree)
        loss, metrics = lm.lm_loss(leaves, batch, cfg, backend="kernel")
        return loss.detach(), metrics, torch.autograd.grad(
            loss, lm.tree_leaves(leaves))
    loss, metrics, grads = loss_grads(params)
    table = params["embed"]["table"]
    gen = torch.Generator(device=table.device).manual_seed(12)
    _, _, nudged = loss_grads({**params, "embed": {"table": table * (
        1 + JAMBA_RANK_NUDGE * torch.randn(table.shape, generator=gen,
                                           device=table.device))}})
    noise = [float((n - g).abs().max() / g.abs().max().clamp_min(1e-30))
             for n, g in zip(nudged, grads)]
    torch.save({"loss": loss.cpu(),
                "dropped": float(metrics["moe_dropped"]),
                "routes": [c["experts"] for c in calls],
                "call_dropped": [c["dropped"] for c in calls],
                "grads": [g.cpu() for g in grads], "noise": noise},
               os.path.join(work, "jamba_ref.pt"))
    del grads, nudged
    eng = ServingEngine(params, cfg, max_len=jamba_rank_max_len(),
                        device=device)
    reqs = trace_requests(cfg, device, JAMBA_RANK_LENS, JAMBA_RANK_NEW)
    eng.serve(reqs, continuous=True, max_batch=len(reqs))
    margins = []
    with torch.no_grad():
        for r in reqs:
            seq = torch.cat([r.prompt, torch.tensor(r.generated[:-1],
                                                    device=device)])
            x, _ = lm.forward(params, seq[None], cfg, remat=False)
            logits = lm.logits_fn(params, x[:, len(r.prompt) - 1:],
                                  cfg)[0].float()
            top = logits.topk(2, dim=-1).values
            margins.append(((top[:, 0] - top[:, 1])
                            / logits.abs().amax(-1)).tolist())
    json.dump({"tokens": [r.generated for r in reqs], "margins": margins},
              open(os.path.join(work, "jamba_serve.json"), "w"))
    worst = int(np.argmax(noise))
    log_t(f"  (d)'s references: {lm.param_counts(cfg)['total'] / 1e9:.2f}B "
          f"params in float32, {JAMBA_RANK_BATCH} x {JAMBA_RANK_SEQ}: loss "
          f"{float(loss):.6f}, dropped share "
          f"{float(metrics['moe_dropped']):.6f}; the grads' own noise at "
          f"worst {leaf_paths(template)[worst]} {noise[worst]:.3e} of its "
          f"max; tokens {[r.generated for r in reqs]}")
    del params, eng
    free_device()
    return template


def read_k2() -> dict:
    """K2's launches since the last ``reset_ssd_launches``: in all, by
    route and by head count."""
    return {"k2": ssd_scan_fwd.launches,
            "k2_routes": nonzero(ssd_scan_fwd.route_launches),
            "k2_heads": {str(h): n for h, n in nonzero(
                ssd_scan_fwd.heads_launches).items()}}


def jamba_rank_main(rank: int, world: int, work: str) -> None:
    """One of (d)'s ranks, started by ``jamba_four_ranks`` as
    ``chip_smoke.py --jamba-rank <rank> <world> <dir>``: gloo over the
    card's tensors.  At each mesh of JAMBA_RANK_MESHES: ``jamba_rank_cfg``
    on its slices under JAMBA_PLAN (``moe_layout``; the ranks cut theirs in
    turn), one ``lm_loss(sharder=)`` on its shard of ``jamba_rank_batch``
    with its grads summed by ``allreduce_grads`` and the clip's norm, what
    it counted (calls, K1 and K2 launches), its routing (the forward's MoE
    calls), dropped share and peak memory, each grad slice against the
    same slice of the reference.  Then at (1, world) JAMBA_RANK_LENS's
    requests through ``ContinuousScheduler`` under JAMBA_SERVE_PLAN: the
    tokens, the launches, the calls, and what each step ran on with each
    prefill's routing (``StepLog``) for the contract.  Written to
    ``<dir>/jamba_rank<r>.json`` and ``.pt``; every rank waits at a
    barrier, then leaves the group."""
    device = json.load(open(os.path.join(work, "job31.json")))["device"]
    full_f32()
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "store31d"), world), rank=rank, world_size=world)
    t_start = time.perf_counter()

    def note(what):
        if rank == 0:
            log(f"    rank 0: {what} at {time.perf_counter() - t_start:.1f} "
                f"s, {torch.cuda.memory_allocated() / 1e9:.2f} GB held, "
                f"host GiB {host_state()}")
    try:
        cfg = jamba_rank_cfg()
        ref = torch.load(os.path.join(work, "jamba_ref.pt"), mmap=True)
        res, routes = {}, {}
        for shape in JAMBA_RANK_MESHES:
            label = f"{shape[0]}x{shape[1]}"
            mesh = make_mesh(shape, ("data", "model"),
                             torch.device(device).type, backend="gloo")
            ctx = from_mesh(mesh)
            lay = in_turn(rank, world, lambda: moe_layout(
                cfg, mesh, JAMBA_RANK_BATCH, JAMBA_RANK_SEQ, device,
                plan=JAMBA_PLAN, init=jamba_rank_init))
            note(f"{label}: the slices cut")
            specs, sharder = lay["specs"], lay["sharder"]
            leaves = lm.tree_map(lambda p: p.requires_grad_(True),
                                 lay.pop("params"))
            batch = lm.shard_lm_batch(jamba_rank_batch(cfg, device),
                                      sharder)
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            reset_ssd_launches()
            t0 = time.perf_counter()
            with moe_calls() as calls:          # the forward's, not the
                loss, metrics = lm.lm_loss(      # backward's recompute
                    leaves, batch, cfg, sharder=sharder, backend="kernel")
            routes[label] = calls
            grads = iter(torch.autograd.grad(loss, lm.tree_leaves(leaves)))
            loss, grads = allreduce_grads(loss.detach(), lm.tree_map(
                lambda p: next(grads), leaves), specs, ctx)
            slices_norm(grads, specs, ctx)
            got = {**read_counts(), **read_k2()}
            got.update(seconds=time.perf_counter() - t0,
                       coord=[ctx.dp_index, ctx.sp_index],
                       layout=lay["layout"],
                       dropped=float(metrics["moe_dropped"]),
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            note(f"{label}: the loss and grads")
            gaps = torch.tensor([slice_gap(g, w[tuple(
                slice(a, b) for a, b in slice_index(w.shape, spec, ctx))])
                for g, w, spec in zip(lm.tree_leaves(grads), ref["grads"],
                                      lm.tree_leaves(specs))],
                dtype=torch.float64)
            dist.all_reduce(gaps, op=dist.ReduceOp.MAX)
            shares = (gaps[:, 0] / gaps[:, 1].clamp_min(1e-30)).tolist()
            worst = int(np.argmax(shares))
            got.update(
                loss=float(loss), loss_rel=float(
                    (loss.cpu() - ref["loss"]).abs() / ref["loss"].abs()),
                grad_rel=shares[worst], leaves=len(shares), shares=shares,
                leaf=leaf_paths(specs)[worst], host_gib=host_state())
            res[label] = got
            del leaves, grads, lay
            host_empty_cache()
            torch.cuda.empty_cache()
        mesh = make_mesh((1, world), ("data", "model"),
                         torch.device(device).type, backend="gloo")
        eng = in_turn(rank, world, lambda: ServingEngine(
            jamba_rank_init(cfg, device), cfg,
            max_len=jamba_rank_max_len(), mesh=mesh, plan=JAMBA_SERVE_PLAN,
            device=device))
        note("serve: the engine built")
        reqs = trace_requests(cfg, device, JAMBA_RANK_LENS, JAMBA_RANK_NEW)
        steps = StepLog(eng)
        sched = ContinuousScheduler(eng, max_batch=len(reqs))
        reset_counts()
        reset_ssd_launches()
        t0 = time.perf_counter()
        sched.run(reqs)
        got = {**read_counts(), **read_k2()}
        routes["serve"] = steps.routes
        res["serve"] = {
            **got, "seconds": time.perf_counter() - t0,
            "tokens": [r.generated for r in reqs],
            "prefills": steps.prefills, "decodes": steps.decodes,
            "ticks": sched.ticks, "coord": [eng.sharder.dp_index,
                                            eng.sharder.sp_index],
            "host_gib": host_state()}
        note("serve: served")
        del eng, sched, steps
        free_device()
        torch.save(routes, os.path.join(work, f"jamba_rank{rank}.pt"))
        json.dump(res, open(os.path.join(work, f"jamba_rank{rank}.json"),
                            "w"))
    finally:
        dist.barrier()
        dist.destroy_process_group()


def jamba_four_ranks(work: str, template, device="cuda") -> Part:
    """(d) DSP_RANKS processes sharing the card over gloo
    (``jamba_rank_main``), ``jamba_rank_cfg`` in float32.  Training at
    each mesh of JAMBA_RANK_MESHES under the spec's plan: the loss within
    MOE_LOSS_BAR relative of the one-rank reference, each rank's grad
    slices within MOE_GRAD_BAR of their leaf's max or JAMBA_NOISE_FACTOR
    times the reference's own noise on the leaf, the dropped pairs of
    each MoE call (the ranks' shares summed) the reference's and not all
    zero; per rank the calls and bytes exactly ``zero_contract`` with the
    dispatch's rows from the run's routing (``route_rows``), K1 twice per
    attention layer and K2 twice per SSM layer (the forward and the
    checkpointed recompute) on ``cuda_cores`` at the rank's heads.
    Serving at (1, DSP_RANKS) under JAMBA_SERVE_PLAN: the tokens one
    rank's up to a near-tie (TP_TIE_BAR), per rank the calls and bytes
    exactly ``lm.serve_contract`` over the run's prefills (each
    dispatch's rows from the ranks' routing of it), decode steps and
    loop turns, K1 and K2 once per layer a prefill on ``cuda_cores``
    (``template``: the model's tree as meta tensors, which the contract
    reads).  Each rank's peak memory and host memory logged."""
    with open(os.path.join(work, "job31.json"), "w") as f:
        json.dump({"device": device}, f)
    t0 = time.perf_counter()
    rcs = yield from ranks_exit("--jamba-rank", work)
    log_t(f"  {DSP_RANKS} ranks exited {rcs} after "
          f"{time.perf_counter() - t0:.1f} s")
    if any(rcs):
        raise AssertionError(f"a jamba rank failed: exit codes {rcs}")
    ranks = [json.load(open(os.path.join(work, f"jamba_rank{r}.json")))
             for r in range(DSP_RANKS)]
    routes = [torch.load(os.path.join(work, f"jamba_rank{r}.pt"))
              for r in range(DSP_RANKS)]
    ref = torch.load(os.path.join(work, "jamba_ref.pt"), mmap=True)
    cfg = jamba_rank_cfg()
    e_phys = lm.moe_meta(cfg).e_phys
    layers = {k.__name__: n for k, n in kernel_layers(cfg).items()}
    n_attn, n_ssm = layers["flash_attention_fwd"], layers["ssd_scan_fwd"]
    cap = lm_capacity(cfg, JAMBA_RANK_SEQ)
    pairs = JAMBA_RANK_BATCH * JAMBA_RANK_SEQ * cfg.top_k

    def count(shares):
        return [int(round(float(x) * pairs)) for x in shares]
    ref_dropped = count(ref["call_dropped"])
    if ref_dropped != [int((~kept_pairs(e, e_phys, cap)).sum())
                       for e in ref["routes"]] or not sum(ref_dropped):
        raise AssertionError(f"one rank's dropped pairs per MoE call "
                             f"{ref_dropped} are not its routing's, or none")
    for shape in JAMBA_RANK_MESHES:
        label = f"{shape[0]}x{shape[1]}"
        parts = {tuple(res[label]["coord"]): rt[label]
                 for res, rt in zip(ranks, routes)}
        glob = assemble_routes(parts, shape)
        dropped = count(np.sum([[c["dropped"] for c in calls]
                                for calls in parts.values()], axis=0))
        share = sum(res[label]["dropped"] for res in ranks)
        g = ranks[0][label]
        bars = [max(MOE_GRAD_BAR, JAMBA_NOISE_FACTOR * n)
                for n in ref["noise"]]
        near = int(np.argmax([a / b for a, b in zip(g["shares"], bars)]))
        worst = g["shares"].index(g["grad_rel"])
        log_t(f"  {label}: {cfg.n_layers} layers in float32, "
              f"{JAMBA_RANK_BATCH} x {JAMBA_RANK_SEQ}: loss {g['loss']:.9f}, "
              f"|delta| / |loss| against one rank {g['loss_rel']:.3e}, "
              f"worst grad slice {g['leaf']} {g['grad_rel']:.3e} of its "
              f"leaf's max over {g['leaves']} leaves (the reference's own "
              f"noise there {ref['noise'][worst]:.3e}), nearest its bar "
              f"{leaf_paths(template)[near]} {g['shares'][near]:.3e} against "
              f"{bars[near]:.3e}; dropped pairs per MoE call {dropped} "
              f"against one rank's {ref_dropped}, share {share} against "
              f"{ref['dropped']}")
        if not (all(a <= b for a, b in zip(g["shares"], bars))
                and dropped == ref_dropped
                and abs(share - ref["dropped"]) < 1e-9):
            raise AssertionError(f"{label}: the {DSP_RANKS}-rank grads or "
                                 f"drops disagree with one rank: {g}, "
                                 f"dropped {dropped} against {ref_dropped}")
        for r, res in enumerate(ranks):
            got = res[label]
            i, j = got["coord"]
            rows = route_rows(glob, e_phys, cap, shape[0], shape[1], i, j)
            want = zero_contract(cfg, shape, JAMBA_RANK_BATCH, got["layout"],
                                 JAMBA_RANK_SEQ, rows)
            k1, k2 = 2 * n_attn, 2 * n_ssm
            heads = str(cfg.ssm_cfg.n_heads // shape[1])
            log_t(f"  rank {r} (data {i}, model {j}): {got['seconds']:.1f} "
                  f"s, peak {got['peak_gb']:.2f} GB, dispatch rows "
                  f"(received, returned) {rows}, calls {got['calls']}, K1 "
                  f"{got['k1']} {got['k1_routes']}, K2 {got['k2']} "
                  f"{got['k2_routes']} at {got['k2_heads']} heads; host GiB "
                  f"{got['host_gib']}")
            if not (got["loss_rel"] <= MOE_LOSS_BAR and got["calls"] == want
                    and got["k1_routes"] == {"cuda_cores": k1}
                    and got["k2_routes"] == {"cuda_cores": k2}
                    and got["k2_heads"] == {heads: k2}):
                raise AssertionError(f"rank {r} {label}: {got}, the contract "
                                     f"says {want}, K1 {k1} and K2 {k2} at "
                                     f"{heads} heads on cuda_cores")
    sref = json.load(open(os.path.join(work, "jamba_serve.json")))
    n = DSP_RANKS
    # each prefill's global routing, from its ranks' records, and the rows
    # each model rank's dispatch moves at its padded length's capacity
    rows_of = []
    for p, (_, _, s) in enumerate(ranks[0]["serve"]["prefills"]):
        glob = assemble_routes({(0, res["serve"]["coord"][1]):
                                rt["serve"][p]
                                for res, rt in zip(ranks, routes)}, (1, n))
        cap = lm_capacity(cfg, n * lm.prefill_shard_len(cfg, s, n))
        rows_of.append([route_rows(glob, e_phys, cap, 1, n, 0, j)
                        for j in range(n)])
    for r, res in enumerate(ranks):
        sv = res["serve"]
        j = sv["coord"][1]
        prefills = [tuple(p) for p in sv["prefills"]]
        want = steps_contract(cfg, template, JAMBA_SERVE_PLAN, prefills,
                              [tuple(d) for d in sv["decodes"]], sv["ticks"],
                              jamba_rank_max_len(),
                              [rows[j] for rows in rows_of])
        apart = [next(([t, m[t]] for t, (a, b) in enumerate(zip(g, w))
                       if a != b), None)
                 for g, w, m in zip(sv["tokens"], sref["tokens"],
                                    sref["margins"])]
        k1, k2 = n_attn * len(prefills), n_ssm * len(prefills)
        log_t(f"  serve, rank {r}: {sv['seconds']:.1f} s, tokens "
              f"{sv['tokens']}, K1 {sv['k1']} {sv['k1_routes']}, K2 "
              f"{sv['k2']} {sv['k2_routes']} at {sv['k2_heads']} heads, "
              f"calls {sv['calls']}; host GiB {sv['host_gib']}; [first step "
              f"apart, one rank's margin there] {apart}")
        if (any(a is not None and a[1] > TP_TIE_BAR for a in apart)
                or sv["calls"] != want
                or sv["k1_routes"] != {"cuda_cores": k1}
                or sv["k2_routes"] != {"cuda_cores": k2}):
            raise AssertionError(f"serve, rank {r}: {sv}, one rank {sref}, "
                                 f"the contract {want}, K1 {k1} and K2 {k2} "
                                 f"on cuda_cores")
    log(f"  tokens against one rank's {sref['tokens']}, margins "
        f"{sref['margins']}")
    return {"ranks": ranks}


def jamba_phase(work: str, device="cuda") -> dict:
    """Phase 31, (a) to (d): (d)'s references first, then its ranks beside
    (a) to (c) (``behind``; 4 x ~1.6 GB beside (a)-(b)'s ~54 GB), joined
    last."""
    out = {}
    log(f"  (d)'s references, {DSP_RANKS} ranks started beside (a)-(c) "
        f"({elapsed()})")
    template = jamba_rank_refs(work, device)
    ranks = behind(jamba_four_ranks(work, template, device), work)
    cfg = jamba_cfg()
    log(f"  (a) one period of {_JA.n_layers} layers at full width with "
        f"{cfg.n_experts} of {_JA.n_experts} experts, kernel against plain, "
        f"the KV cache in {cfg.cache_dtype} ({elapsed()})")
    t0 = time.perf_counter()
    box = {"params": lm.init_lm(0, cfg, device=device)}
    torch.cuda.synchronize()
    log_t(f"  init {lm.param_counts(cfg)['total'] / 1e9:.2f}B params "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB) in "
          f"{time.perf_counter() - t0:.1f} s")
    out["checks"] = jamba_checks(box["params"], cfg, device)
    log(f"  (b) the same weights: {len(JAMBA_LENS)} requests over "
        f"{JAMBA_LENS} tokens, {JAMBA_NEW} new tokens each, one card, then "
        f"under {JAMBA_SERVE_PLAN} at world size 1 ({elapsed()})")
    out["serve"] = full_width_serve(cfg, flash_attention_fwd, device,
                                    lens=JAMBA_LENS, new_tokens=JAMBA_NEW,
                                    params=box.pop("params"))
    jamba_world_of_one(out, work, device)
    log(f"  (c) K2 and K1 at jamba's prefill shapes ({elapsed()})")
    out["ssd"] = time_ssd(JAMBA_SSD, 9, "jamba's prefill")
    out["attn"] = {name: time_model_attention(name, case)
                   for name, case in JAMBA_ATTN.items()}
    out["ranks"] = join(ranks, "(d)")
    return out


# ---------------------------------------------------------------------------
# The 4-rank phases' processes
# ---------------------------------------------------------------------------

# the flags whose ranks run with expandable segments: 4 caching allocators
# share the card, and expandable segments let each give back what it frees
EXPANDABLE = ("--zero-rank", "--ckpt-rank", "--serve-rank", "--paged-rank",
              "--t2d-zero-rank", "--moe-rank", "--tp-rank", "--seamless-rank",
              "--arctic-rank", "--seamless-serve-rank", "--jamba-rank")
# (flag, work) -> the rank processes ``prespawn`` started, not yet released
_READY: dict = {}


def _start_ranks(flag: str, work: str) -> list:
    env = (dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
           if flag in EXPANDABLE else None)
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), flag,
                              str(r), str(DSP_RANKS), work], env=env)
            for r in range(DSP_RANKS)]


def prespawn(flag: str, work: str) -> None:
    """Start a phase's DSP_RANKS rank processes (this script with
    ``flag`` on ``work``) at the top of the phase: each imports the port,
    then waits for ``spawn_ranks`` to release it (``wait_for_go``), so
    that the ~8 s of imports overlap the phase's world-1 part."""
    _READY[(flag, work)] = _start_ranks(flag, work)


def spawn_ranks(flag: str, work: str) -> list:
    """The phase's rank processes, released to their work: those that
    ``prespawn`` started, or new ones."""
    open(os.path.join(work, "go" + flag), "w").close()
    procs = _READY.pop((flag, work), None)
    return procs if procs is not None else _start_ranks(flag, work)


def wait_for_go(flag: str, work: str) -> None:
    """A rank process: wait until ``spawn_ranks`` releases the ranks of
    ``flag``, or leave when its phase has ended without them (``work``
    removed)."""
    go = os.path.join(work, "go" + flag)
    while not os.path.exists(go):
        if not os.path.isdir(work):
            raise SystemExit(1)
        time.sleep(0.05)


def ranks_exit(flag: str, work: str, timeout: int = 600):
    """Release the ranks of ``flag`` (``spawn_ranks``) and pause once: a
    phase's (b) part, a generator that runs this by ``yield from``, stops
    there while its caller goes on (``behind``), and is resumed to wait
    for its ranks (``run_part``, ``join``).  Returns their exit codes; a
    rank still running after ``timeout`` s, or when the part is closed,
    is killed."""
    procs = spawn_ranks(flag, work)
    try:
        yield
        return [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _resume(part):
    """Resume the (b) part ``part`` from its pause to its end: its value."""
    try:
        next(part)
    except StopIteration as stop:
        return stop.value
    raise AssertionError("a (b) part paused twice")


def run_part(part):
    """Run the (b) part ``part`` (a generator over ``ranks_exit``) through:
    its ranks started and waited for, its checks made."""
    next(part)
    return _resume(part)


# (b) parts that ``behind`` started and no ``join`` has ended: (part, work)
_BEHIND: list = []
# the directories of ``work_dir`` not yet removed
_WORK: list = []


def work_dir() -> str:
    """A new directory for a phase whose (b) part outlives the phase:
    ``join`` or ``remove_dir`` removes it, or ``stop_ready`` if the script
    stops first."""
    _WORK.append(tempfile.mkdtemp())
    return _WORK[-1]


def remove_dir(work: str) -> None:
    shutil.rmtree(work, ignore_errors=True)
    _WORK.remove(work)


def behind(part, work: str) -> tuple:
    """Start the (b) part ``part`` as far as its ranks' release, and leave
    them running beside the next phase's world-1 part, whose device memory
    theirs must leave room for.  ``join`` ends it; ``work`` (the phase's
    directory, made by ``work_dir``) is removed then."""
    next(part)
    handle = (part, work)
    _BEHIND.append(handle)
    return handle


def join(handle: tuple, label: str):
    """Wait for the ranks that ``behind`` left running, make the part's
    checks and log them here, under ``label``: the part's value."""
    part, work = handle
    _BEHIND.remove(handle)
    log(f"  {label}, its ranks run beside this phase: waited for and "
        f"checked ({elapsed()})")
    try:
        return _resume(part)
    finally:
        remove_dir(work)


def stop_ready() -> None:
    """Stop the rank processes that no phase released or waited for."""
    for procs in _READY.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    _READY.clear()
    for part, _ in _BEHIND:
        part.close()
    _BEHIND.clear()
    for work in _WORK:
        shutil.rmtree(work, ignore_errors=True)
    _WORK.clear()


# ---------------------------------------------------------------------------
# Phase 28: the CLIs under torchrun, side by side
# ---------------------------------------------------------------------------

# the launches that start in phase 27 once (b)'s run under tp + ep at
# world size 1 has given the card back its memory, and run beside (c)-(e):
# ~4 GiB of host memory and ~3 GB of the card a launch, where phase 28's
# nine together took 116-136 s.  The other five start at the top of phase
# 27, beside (a)-(e), whose world-1 parts leave the host's cores idle
# (after phase 27 they took phase 28 66-71 s; beside 26 (c)-(e) they
# slowed 26 (e)'s host-bound ranks by ~45 s)
EARLY_CLIS = ("25c/train", "26e/train", "27f/train", "27f/serve")


def cli_commands() -> dict:
    """{name: (CLI module, arguments)} of every CLI that phases 19, 20, 23,
    25, 26 and 27 run under ``torchrun``."""
    dsp_serve = ["--mode", "dsp", "--backend", "gloo"]
    mesh = ["--mesh", f"1,{DSP_RANKS}", "--backend", "gloo", "--steps", "3"]
    return {
        "19c/continuous": ("serve", SERVE_CLI + dsp_serve + SERVE_CLI_CONT),
        "19c/replan": ("serve", SERVE_CLI + dsp_serve + ["--replan", "2"]),
        "20c/paged": ("serve", PAGED_CLI + dsp_serve),
        "23c/train": ("train", ["--arch", "qwen2-moe-a2.7b", *mesh]),
        "25c/train": ("train", ["--arch", "mistral-large-123b", *mesh]),
        "25c/serve": ("serve", TP_SERVE_CLI + ["--mode", "tp", "--backend",
                                               "gloo"]),
        "26e/train": ("train", ["--arch", "seamless-m4t-large-v2", *mesh]),
        "27f/train": ("train", ["--arch", "arctic-480b", *mesh]),
        "27f/serve": ("serve", ARCTIC_SERVE_CLI + ["--mode", "tp",
                                                   "--backend", "gloo"])}


def cli_launches(names) -> dict:
    """Start the CLIs ``names`` of ``cli_commands`` under ``torchrun
    --standalone --nproc-per-node`` DSP_RANKS on the card, gloo over its
    tensors, all at once, each in a temporary directory of its own: {name:
    (Popen, start time, directory)}.  Each launch spends most of its time
    starting its ranks, so side by side they take about one launch's
    time."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = {}
    for name, (cli, args) in cli_commands().items():
        if name not in names:
            continue
        work = tempfile.mkdtemp()
        out[name] = (subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(DSP_RANKS), "-m",
             f"repro_torch.launch.{cli}", *args], cwd=work, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            time.perf_counter(), work)
    return out


def finish(launch) -> tuple:
    """(exit code, stdout, stderr, seconds since its start) of a launch of
    ``cli_launches``, waited for."""
    proc, t0, _ = launch
    out, err = proc.communicate(timeout=600)
    return proc.returncode, out, err, time.perf_counter() - t0


def close_launches(launched: dict) -> None:
    """Kill what is still running of ``cli_launches``' launches and remove
    their directories."""
    for proc, _, work in launched.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)


def library_attention(case, compile: bool = True):
    """One PyTorch call that computes K1's function at ``case`` where
    ``scaled_dot_product_attention`` cannot, for a softcap or a window:
    ``flex_attention`` with the softcap as its ``score_mod`` and the
    causal and window limits at ``q_offset`` as its block mask, GQA on,
    compiled into its Triton kernel where ``compile``.  Returns fn(q, k,
    v); it is timed beside the kernel and used nowhere in the port."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    _, _, _, sq, skv, _, causal, window, softcap = case
    q_offset = attn_kw(case)["q_offset"]

    def mask_mod(b, h, q_idx, kv_idx):
        q_pos = q_idx + q_offset
        keep = kv_idx <= q_pos if causal else kv_idx >= 0
        if window is not None:
            keep = keep & (kv_idx > q_pos - window)
        return keep

    def score_mod(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    if compile:
        import torch._inductor.config as inductor
        inductor.compile_threads = 1            # no pool of workers
        flex_attention = torch.compile(flex_attention, dynamic=False)
    cache = {}

    def fn(q, k, v):
        if q.device not in cache:
            cache[q.device] = create_block_mask(mask_mod, None, None, sq,
                                                skv, device=q.device)
        return flex_attention(q, k, v,
                              score_mod=None if softcap is None
                              else score_mod,
                              block_mask=cache[q.device], enable_gqa=True)
    return fn


def time_model_attention(name: str, case=None,
                         cuda_cores: bool = False) -> dict:
    """K1 at ``name``'s prefill shape (MODEL_ATTN, or ``case``) in bf16 on
    its route,
    and one library call for the same function: ``scaled_dot_product_
    attention`` (causal, GQA), or ``library_attention``'s compiled
    ``flex_attention`` where the shape has a softcap or a window (its
    first call, the compile, untimed, and its output held against the
    plain version's at K1's bar), three times each in turns (medians);
    the plain version once, and the bound."""
    case = MODEL_ATTN[name] if case is None else case
    q, k, v = attn_inputs(case, torch.bfloat16, seed=13)
    kw = attn_kw(case)
    route = ROUTES[(torch.bfloat16, case[5])]
    fns = {route: lambda: flash_attention_fwd(q, k, v, **kw)}
    plain = flash_attention_plain(q, k, v, **kw)
    if case[8] is None and case[7] is None:
        library = "scaled_dot_product_attention"
        fns["library"] = lambda: sdpa(q, k, v, causal=case[6])
    else:
        library = "flex_attention (torch.compile)"
        flex = library_attention(case)
        t0 = time.perf_counter()
        share = attn_worst_share(flex(q, k, v), plain, torch.bfloat16)
        torch.cuda.synchronize()
        log_t(f"  {name}: {library} compiled and run in "
              f"{time.perf_counter() - t0:.1f} s; against the plain "
              f"version {share:.3f} of K1's bar")
        if not share <= 1.0:
            raise AssertionError(f"{library} at {case} is not K1's "
                                 f"function: {share} of the bar")
        fns["library"] = lambda: flex(q, k, v)
    del plain
    runs = {who: [] for who in fns}
    for order in (tuple(fns), tuple(fns)[::-1], tuple(fns)):
        for who in order:
            runs[who].append(time_ms(fns[who], iters=10, warmup=2))
    med = {w: float(np.median(r)) for w, r in runs.items()}
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, **kw), iters=2,
                       warmup=1)
    cores_ms = (time_ms(lambda: flash_attention_fwd(
        q, k, v, route="cuda_cores", **kw), iters=3, warmup=1)
        if cuda_cores else None)
    bound = attention_bound_ms(case, torch.bfloat16)
    log_t(f"  {name} {case[:6]} window {case[7]} softcap {case[8]}: kernel "
          f"({route}) {med[route]:.4f} ms (runs {runs[route]})  plain "
          f"{plain_ms:.4f} ms  {library} {med['library']:.4f} ms (runs "
          f"{runs['library']})  bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}; the kernel at "
          f"{100 * bound['bound_ms'] / med[route]:.1f}% of the bound)"
          + (f"; cuda_cores kernel {cores_ms:.4f} ms" if cuda_cores else ""))
    del q, k, v
    torch.cuda.empty_cache()
    return {"shape": list(case[:6]), "window": case[7], "softcap": case[8],
            "route": route, "ms": med[route], "plain_ms": plain_ms,
            "cuda_cores_ms": cores_ms, "causal": case[6],
            "library": library, "library_ms": med["library"],
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}


def time_chunk_attention(case) -> dict:
    """K1 at a paged chunk's ``case`` in bf16 on its route, and
    ``scaled_dot_product_attention`` with the chunk's mask (keys up to
    the query's position at ``q_offset = Skv - Sq``), three times each in
    turns (medians); the plain version once, and the bound."""
    q, k, v = attn_inputs(case, torch.bfloat16, seed=12)
    kw = attn_kw(case)
    route = ROUTES[(torch.bfloat16, case[5])]
    sq, skv = case[3], case[4]
    mask = (torch.arange(skv, device="cuda")[None, :]
            <= kw["q_offset"] + torch.arange(sq, device="cuda")[:, None])
    fns = {route: lambda: flash_attention_fwd(q, k, v, **kw),
           "library": lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=mask, enable_gqa=True)}
    runs = {who: [] for who in fns}
    for order in ((route, "library"), ("library", route), (route, "library")):
        for who in order:
            runs[who].append(time_ms(fns[who], iters=20, warmup=2))
    ms, library_ms = (float(np.median(runs[w])) for w in fns)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, **kw), iters=3,
                       warmup=1)
    bound = attention_bound_ms(case, torch.bfloat16)
    log_t(f"  chunk {case[:6]} q_offset {kw['q_offset']}: kernel ({route}) "
          f"{ms:.4f} ms (runs {runs[route]})  plain {plain_ms:.4f} ms  "
          f"scaled_dot_product_attention {library_ms:.4f} ms (runs "
          f"{runs['library']})  bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}; the kernel at "
          f"{100 * bound['bound_ms'] / ms:.1f}% of the bound)")
    del q, k, v
    torch.cuda.empty_cache()
    return {"shape": list(case[:6]), "q_offset": kw["q_offset"],
            "route": route, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"]}


def time_dit_attention(shape) -> dict:
    """K1 at a DiT ``shape`` in bf16 on its route (DIT_ROUTE) and on
    ``cuda_cores``, and ``scaled_dot_product_attention``, three times each
    in turns (medians); the plain version once, and the bound."""
    q, k, v = attn_inputs(shape, torch.bfloat16, seed=9)
    kw = attn_kw(shape)
    route = ROUTES[(torch.bfloat16, shape[5])]
    if route != DIT_ROUTE:
        raise AssertionError(f"K1 at {shape[:6]} takes {route}, expected "
                             f"{DIT_ROUTE}")
    fns = {route: lambda: flash_attention_fwd(q, k, v, **kw),
           "cuda_cores": lambda: flash_attention_fwd(
               q, k, v, route="cuda_cores", **kw),
           "library": lambda: sdpa(q, k, v, causal=False)}
    runs = {who: [] for who in fns}
    for order in ((route, "cuda_cores", "library"),
                  ("library", "cuda_cores", route),
                  (route, "library", "cuda_cores")):
        for who in order:
            runs[who].append(time_ms(
                fns[who], iters=5 if who == "cuda_cores" else 20, warmup=1))
    ms, cuda_cores_ms, library_ms = (float(np.median(runs[w])) for w in fns)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, **kw), iters=3,
                       warmup=1)
    bound = attention_bound_ms(shape, torch.bfloat16)
    log_t(f"  DiT {shape[:6]} non-causal: kernel ({route}) runs "
          f"{runs[route]}  cuda_cores runs {runs['cuda_cores']}  library "
          f"runs {runs['library']}")
    log_t(f"  DiT {shape[:6]}: kernel ({route}) {ms:.4f} ms  cuda_cores "
          f"kernel {cuda_cores_ms:.4f} ms  plain {plain_ms:.4f} ms  "
          f"scaled_dot_product_attention {library_ms:.4f} ms  bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
          f"{bound['flops']:.3e} FLOP, {bound['bytes']:.3e} B; the kernel at "
          f"{bound['flops'] / ms / 1e9:.1f} TFLOP/s, "
          f"{100 * bound['bound_ms'] / ms:.1f}% of the bound)")
    del q, k, v
    torch.cuda.empty_cache()
    return {"shape": list(shape[:6]), "route": route, "ms": ms,
            "cuda_cores_ms": cuda_cores_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"]}


T0 = time.perf_counter()


def _meminfo() -> dict:
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            out[key] = int(value.split()[0]) * 1024
    return out


def _tree_rss() -> int:
    """Resident bytes summed over this process and its descendants (the
    ranks and compilers it starts)."""
    parent, rss = {}, {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        parent[int(pid)] = int(fields[1])
        rss[int(pid)] = int(fields[21]) * os.sysconf("SC_PAGE_SIZE")
    mine, total = {os.getpid()}, 0
    for pid in sorted(parent):
        p, seen = pid, set()
        while p in parent and p not in mine and p not in seen and p > 1:
            seen.add(p)
            p = parent[p]
        if p in mine:
            mine |= seen
    for pid in mine:
        total += rss.get(pid, 0)
    return total


class HostMemory:
    """The host's memory, sampled every 0.25 s on a thread: the resident
    bytes of this process tree, the machine's used memory (MemTotal less
    MemAvailable, which counts files in tmpfs) and its Shmem (tmpfs).
    ``take()`` gives the peaks since the last ``take()`` and starts anew;
    every phase header prints them, so a phase that holds too much of the
    host shows in the log."""

    def __init__(self):
        import threading
        self.lock = threading.Lock()
        self.peak = {}
        self.base = _meminfo()
        threading.Thread(target=self._run, daemon=True).start()

    def _sample(self) -> dict:
        m = _meminfo()
        return {"tree": _tree_rss(),
                "used": m["MemTotal"] - m["MemAvailable"],
                "shmem": m.get("Shmem", 0)}

    def _run(self) -> None:
        while True:
            try:
                s = self._sample()
            except (OSError, ValueError, KeyError, IndexError):
                return
            with self.lock:
                for k, v in s.items():
                    self.peak[k] = max(self.peak.get(k, 0), v)
            time.sleep(0.25)

    def take(self) -> str:
        now = self._sample()
        with self.lock:
            peak, self.peak = self.peak, dict(now)
        peak = {k: max(v, peak.get(k, 0)) for k, v in now.items()}
        return (f"host peak: tree RSS {peak['tree'] / 2**30:.1f} GiB, "
                f"machine used {peak['used'] / 2**30:.1f} of "
                f"{self.base['MemTotal'] / 2**30:.1f} GiB (now "
                f"{now['used'] / 2**30:.1f}), shmem "
                f"{peak['shmem'] / 2**30:.1f} GiB")


HOST = None


def fs_type(path: str) -> str:
    """The type of the filesystem that holds ``path`` (its longest mount
    point in /proc/mounts), e.g. ``tmpfs``, whose files live in memory."""
    path = os.path.realpath(path)
    best, kind = "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            _, mnt, typ = line.split()[:3]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) > len(best):
                best, kind = mnt, typ
    return kind


def full_f32() -> None:
    """No TF32: float32 products in full precision, as the plain versions
    and the references are held to."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def elapsed() -> str:
    host = "" if HOST is None else f"; since the last header {HOST.take()}"
    return f"t = {time.perf_counter() - T0:.1f} s, {CARD}{host}"


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    full_f32()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    log("[1] device")
    global CARD, HOST
    facts = CARD = card_facts()
    log(facts)
    HOST = HostMemory()
    tmp = tempfile.gettempdir()
    log(f"  temp dir {tmp} on {fs_type(tmp)}, "
        f"{shutil.disk_usage(tmp).free / 2**30:.1f} GiB free")

    log(f"[2] build ({elapsed()})")
    t0 = time.perf_counter()
    report = build.build()
    log_t(f"  built {sorted(report) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, r in report.items():
        for line in ptxas_report(r["log"]):
            log(f"  {name}: {line}")

    log(f"[3] kernels against their plain versions ({elapsed()})")
    for i, case in enumerate(ATTN_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            check_attention(case, dtype, seed=i)
    for dtype in (torch.float32, torch.bfloat16):   # fully masked rows -> 0
        check_attention((1, 2, 2, 96, 96, 64, True, None, None), dtype,
                        seed=50, q_offset=-40)
    slice_err = max(check_attention(prefill_case(s), torch.bfloat16,
                                    seed=100 + s) for s in PROMPT_LENS)
    for i, case in enumerate(SSD_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            check_ssd(case, dtype, seed=200 + i)
    ssd_err = check_ssd(SSD_SLICE, torch.bfloat16, seed=210)
    check_ssd(SSD_RAGGED, torch.bfloat16, seed=211)
    for i, case in enumerate(SSD_SM90_EDGES):
        check_ssd(case, torch.bfloat16, seed=213 + i)
    check_ssd(SSD_SLICE, torch.bfloat16, seed=210, route="cuda_cores")
    for case in (SSD_SLICE, SSD_RAGGED):
        check_ssd(case, torch.float32, seed=212)
    for i, case in enumerate(DIT_ATTN_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            err = check_attention(case, dtype, seed=300 + i)
            if i == 0 and dtype == torch.bfloat16:
                dit_err = err
    check_attention(LM_RANK_ATTN, torch.bfloat16, seed=400)
    check_ssd(LM_RANK_SSD, torch.bfloat16, seed=401)
    check_attention(LM_ZERO_ATTN, torch.bfloat16, seed=402)
    check_ssd(LM_ZERO_SSD, torch.bfloat16, seed=403)
    for i, case in enumerate(CKPT_SSD):
        check_ssd(case, torch.bfloat16, seed=404 + i)
    for i, case in enumerate(SERVE_RANK_ATTN):
        check_attention(case, torch.bfloat16, seed=410 + i)
    for i, case in enumerate(SERVE_RANK_SSD):
        check_ssd(case, torch.bfloat16, seed=430 + i)
    for i, case in enumerate(PAGED_ATTN):
        check_attention(case, torch.bfloat16, seed=440 + i)
    for i, case in enumerate(T2D_ZERO_ATTN):
        check_attention(case, torch.float32, seed=450 + i)
    model_errs = {name: check_attention(case, torch.bfloat16, seed=460 + i)
                  for i, (name, case) in enumerate(MODEL_ATTN.items())}
    for i, case in enumerate(MOE_RANK_ATTN):
        check_attention(case, torch.float32, seed=470 + i)
    tp_errs = {name: check_attention(case, torch.bfloat16, seed=480 + i)
               for i, (name, case) in enumerate(TP_ATTN.items())}
    for i, case in enumerate(TP_RANK_ATTN):
        check_attention(case, torch.float32, seed=490 + i)
    seamless_errs = {name: check_attention(case, torch.bfloat16,
                                           seed=500 + i)
                     for i, (name, case) in enumerate(SEAMLESS_ATTN.items())}
    for i, case in enumerate(SEAMLESS_RANK_ATTN):
        check_attention(case, torch.float32, seed=510 + i)
    arctic_errs = {name: check_attention(case, torch.bfloat16, seed=520 + i)
                   for i, (name, case) in enumerate(ARCTIC_ATTN.items())}
    for i, case in enumerate(ARCTIC_RANK_ATTN):
        check_attention(case, torch.float32, seed=530 + i)
    for i, case in enumerate(SEAMLESS_SERVE_RANK_ATTN):
        check_attention(case, torch.float32, seed=540 + i)
    pixtral_errs = {name: check_attention(case, torch.bfloat16, seed=550 + i)
                    for i, (name, case) in enumerate(PIXTRAL_ATTN.items())}
    jamba_ssd_errs = {}
    for i, (case, runs) in enumerate(JAMBA_SSD_CASES):
        for dtype, route in runs:
            err = check_ssd(case, dtype, seed=560 + i, route=route)
            route = route or ssd_route(dtype, case[3], case[5], case[6])
            jamba_ssd_errs[f"{tuple(case)} {str(dtype)[6:]} {route}"] = err
    jamba_errs = {name: check_attention(case, torch.bfloat16, seed=570 + i)
                  for i, (name, case) in enumerate(JAMBA_ATTN.items())}
    for i, case in enumerate(JAMBA_RANK_ATTN):
        check_attention(case, torch.float32, seed=580 + i)
    for i, case in enumerate(JAMBA_RANK_SSD):
        check_ssd(case, torch.float32, seed=590 + i)

    log(f"[4] timing at the slice's shape, bf16 ({elapsed()})")
    q, k, v = attn_inputs(SLICE, torch.bfloat16, seed=7)
    kw = attn_kw(SLICE)
    route = ROUTES[(torch.bfloat16, SLICE[5])]
    # the kernel and the library call in turns (k, l, l, k, k, l): medians
    runs = {"kernel": [], "library": []}
    for who in ("kernel", "library", "library", "kernel", "kernel",
                "library"):
        fn = ((lambda: flash_attention_fwd(q, k, v, **kw)) if who == "kernel"
              else (lambda: sdpa(q, k, v)))
        runs[who].append(time_ms(fn, iters=50))
    ms, library_ms = (float(np.median(runs[w])) for w in ("kernel", "library"))
    cuda_cores_ms = time_ms(lambda: flash_attention_fwd(
        q, k, v, route="cuda_cores", **kw), iters=20)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, **kw), iters=10)
    bound = attention_bound_ms(SLICE, torch.bfloat16)
    log_t(f"  kernel ({route}) runs {runs['kernel']}  library runs "
          f"{runs['library']}")
    log_t(f"  kernel ({route}) {ms:.4f} ms  cuda_cores kernel "
          f"{cuda_cores_ms:.4f} ms  plain {plain_ms:.4f} ms  "
          f"scaled_dot_product_attention {library_ms:.4f} ms  "
          f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
          f"{bound['flops']:.3e} FLOP, {bound['bytes']:.3e} B; the kernel "
          f"at {bound['flops'] / ms / 1e9:.1f} TFLOP/s)")
    del q, k, v
    ssd_t = time_ssd(SSD_SLICE, 8, "the training slice")
    dit = time_dit_attention(DIT_SLICE)
    dit_temporal = time_dit_attention(DIT_TEMPORAL)
    chunks = [time_chunk_attention(case) for case in PAGED_ATTN]
    models = {name: {**time_model_attention(name),
                     "max_abs_err": model_errs[name]}
              for name in MODEL_ATTN}
    tp_times = {name: {**time_model_attention(name, TP_ATTN[name]),
                       "max_abs_err": tp_errs[name]}
                for name in TP_ATTN}
    seamless_times = {
        name: {**time_model_attention(name, SEAMLESS_ATTN[name],
                                      cuda_cores=True),
               "max_abs_err": seamless_errs[name]}
        for name in SEAMLESS_ATTN}
    arctic_times = {
        name: {**time_model_attention(name, ARCTIC_ATTN[name],
                                      cuda_cores=True),
               "max_abs_err": arctic_errs[name]}
        for name in ARCTIC_ATTN}

    log(f"[5] qwen3-14b serving at full width ({elapsed()})")
    cfg = qwen3_14b.CONFIG
    full_width_prefill_check(cfg, (max(PROMPT_LENS), PROMPT_LENS[1]))
    served = full_width_serve(cfg, flash_attention_fwd)

    log(f"[6] serve CLI at SMOKE size ({elapsed()})")
    from repro_torch.launch.serve import main as serve_main
    reqs = serve_main(["--arch", "qwen3-14b", "--continuous", "--batch", "4",
                       "--prompt-len", "16", "--new-tokens", "8"])
    if any(len(r.generated) != 8 for r in reqs):
        raise AssertionError("serve CLI requests did not finish")

    log(f"[7] mamba2-370m training at full width ({elapsed()})")
    mcfg = mamba2_370m.CONFIG
    full_width_grads_check(mcfg, batch_size=2)
    trained = full_width_train(mcfg, ssd_scan_fwd, TRAIN_BATCH, TRAIN_STEPS)

    log(f"[8] train CLI at SMOKE size ({elapsed()})")
    from repro_torch.launch.train import main as train_main
    train_cli(train_main, "mamba2-370m")

    log(f"[9] mamba2-370m serving at full width ({elapsed()})")
    full_width_prefill_check(mcfg, (max(PROMPT_LENS),),
                             decode_steps=DECODE_CHECK_STEPS)
    ssd_state_check(mcfg)
    m_served = full_width_serve(mcfg, ssd_scan_fwd)

    log(f"[10] qwen3-14b training at full width, depth {QWEN_TRAIN_DEPTH} "
        f"({elapsed()})")
    full_width_grads_check(cfg, batch_size=QWEN_TRAIN_BATCH)
    q_trained = full_width_train(
        dataclasses.replace(cfg, n_layers=QWEN_TRAIN_DEPTH),
        flash_attention_fwd, QWEN_TRAIN_BATCH, QWEN_TRAIN_STEPS)

    log(f"[11] serve CLI (mamba2-370m) and train CLI (qwen3-14b) at SMOKE "
        f"size ({elapsed()})")
    reqs = serve_main(["--arch", "mamba2-370m", "--continuous", "--batch",
                       "4", "--prompt-len", "16", "--new-tokens", "8"])
    if any(len(r.generated) != 8 for r in reqs):
        raise AssertionError("serve CLI requests did not finish")
    train_cli(train_main, "qwen3-14b")

    log(f"[12] transformer2d-720m training at full width ({elapsed()})")
    dcfg = transformer2d_720m.CONFIG
    dit_grads_check(dcfg)
    dit_trained = dit_train(dcfg)
    train_cli(train_main, "transformer2d-720m")

    log(f"[13] transformer2d-720m under DSP ({elapsed()})")
    with tempfile.TemporaryDirectory() as work:
        prespawn("--dsp-rank", work)
        log("  (a) world size 1 over NCCL, full width and depth")
        dsp_trained = dsp_world_of_one(dcfg, dit_trained, work)
        log(f"  (b) {DSP_RANKS} ranks on the card over gloo "
            f"({elapsed()})")
        run_part(dsp_four_ranks(dcfg, work))
    log(f"  done ({elapsed()})")

    log(f"[14] transformer2d-720m under the embedded-SP baselines and the "
        f"overlapped switch ({elapsed()})")
    spcfg = dataclasses.replace(dcfg, n_layers=SP_DEPTH)
    with tempfile.TemporaryDirectory() as work:
        prespawn("--sp-rank", work)
        log(f"  (a) world size 1 over NCCL, full width, depth {SP_DEPTH}")
        sp = sp_world_of_one(spcfg, work)
        log(f"  (b) {DSP_RANKS} ranks on the card over gloo ({elapsed()})")
        run_part(sp_four_ranks(spcfg, sp["bucket2"], work))
    sp_launches = sum(r["launches"] for r in sp["modes"].values())
    log(f"  done ({elapsed()})")

    log(f"[15] transformer2d-720m on dim pairs, forward2d over the "
        f"(sp_out, sp_in) grid ({elapsed()})")
    with tempfile.TemporaryDirectory() as work:
        prespawn("--l2d-rank", work)
        log("  (a) world size 1 over NCCL, grid (1, 1), full width")
        l2d = l2d_world_of_one(dcfg, work)
        log(f"  (b) {DSP_RANKS} ranks on the card over gloo at grids "
            f"{[g for g, _ in L2D_CASES]} ({elapsed()})")
        l2d_ranks = run_part(l2d_four_ranks(dcfg, work))
    dit_runs = [dit_trained, dsp_trained, *sp["modes"].values(), l2d]
    log(f"  done ({elapsed()})")

    log(f"[16] qwen3-14b and mamba2-370m under DSP, the Sharder's hooks on "
        f"a (data, model) mesh ({elapsed()})")
    with tempfile.TemporaryDirectory() as work:
        prespawn("--lm-rank", work)
        log("  (a) world size 1 over NCCL, full width")
        lm_dsp = lm_world_of_one({"qwen3-14b": q_trained,
                                  "mamba2-370m": trained}, work)
        log(f"  (b) {DSP_RANKS} ranks on the card over gloo ({elapsed()})")
        lm_ranks = run_part(lm_four_ranks(work))
    q_dsp, m_dsp = lm_dsp["qwen3-14b"], lm_dsp["mamba2-370m"]
    log(f"  done ({elapsed()})")

    # Phases 17 to 20 leave their (b) ranks running beside the next
    # phase's world-1 part (``behind``), in directories of their own, and
    # check them (``join``) before the next phase's ranks start: the
    # ranks spend their time on the host's gloo copies, the world-1 part
    # on the card, and both fit its memory together (17 (b)'s 4 x 11.3 GB
    # beside 18 (a)'s ~21 GB; at most 4 x 5.4 GB beside 19 (a)'s 33.5 GB).
    log(f"[17] qwen3-14b and mamba2-370m under their specs' own plans, "
        f"ZeRO-3 over (data, model) and the vocab ring ({elapsed()})")
    work17 = work_dir()
    prespawn("--zero-rank", work17)
    log("  (a) world size 1 over NCCL, full width")
    lm_zero = zero_world_of_one(lm_dsp, work17)
    log(f"  (b) {DSP_RANKS} ranks on the card over gloo, beside phase 18 (a) "
        f"({elapsed()})")
    zero_b = behind(zero_four_ranks(work17), work17)
    q_zero, m_zero = lm_zero["qwen3-14b"], lm_zero["mamba2-370m"]
    log(f"  done but (b) ({elapsed()})")

    log(f"[18] mamba2-370m checkpoints: save, resume, compression, "
        f"resharding and replan ({elapsed()})")
    t18 = time.perf_counter()
    work18 = work_dir()
    prespawn("--ckpt-rank", work18)
    log("  (a) world size 1 over NCCL, full width and depth")
    m_ckpt = ckpt_world_of_one(work18)
    zero_ranks = join(zero_b, "[17] (b)")
    log(f"  (b) {DSP_RANKS} ranks on the card over gloo, beside (c) and "
        f"phase 19 (a) ({elapsed()})")
    ckpt_b = behind(ckpt_four_ranks(work18), work18)
    log(f"  (c) the CLIs at SMOKE size ({elapsed()})")
    ckpt_clis(work18, train_main, serve_main)
    log_t(f"  done but (b): phase 18 took {time.perf_counter() - t18:.1f} s "
          f"({elapsed()})")

    log(f"[19] qwen3-14b and mamba2-370m served sharded: the KV cache "
        f"sequence-sharded, the SSM state head-sharded ({elapsed()})")
    t19 = time.perf_counter()
    work19 = work_dir()
    prespawn("--serve-rank", work19)
    log("  (a) world size 1 over NCCL, full width and depth")
    sv = serve_world_of_one({"qwen3-14b": served,
                             "mamba2-370m": m_served}, work19)
    ckpt_ranks = join(ckpt_b, "[18] (b)")
    log(f"  (b) {DSP_RANKS} ranks on the card over gloo, beside phases 20 "
        f"(a) and 21 (a) ({elapsed()})")
    serve_b = behind(serve_four_ranks(work19), work19)
    q_sv, m_sv = sv["qwen3-14b"], sv["mamba2-370m"]
    log_t(f"  done but (b): phase 19 took {time.perf_counter() - t19:.1f} s "
          f"({elapsed()})")

    # 20 (a) and 21 (a) run beside 19 (b)'s ranks, 22 beside 20 (b)'s
    # (4 x ~3 GB beside its 54.7 GB); 21 (b) follows 22
    log(f"[20] qwen3-14b paged: block pool, prefix tree, chunked prefill "
        f"({elapsed()})")
    t20 = time.perf_counter()
    work20 = work_dir()
    prespawn("--paged-rank", work20)
    log("  (a) one card, plan none, full width and depth")
    paged = paged_world_of_one()
    log_t(f"  done but (b): phase 20 took {time.perf_counter() - t20:.1f} s "
          f"({elapsed()})")

    log(f"[21] transformer2d-720m under its spec's own plan, ZeRO-3 over "
        f"(data, model) ({elapsed()})")
    t21 = time.perf_counter()
    work21 = work_dir()
    prespawn("--t2d-zero-rank", work21)
    log("  (a) world size 1 over NCCL, full width and depth")
    t2d_zero = t2d_zero_world_of_one(dcfg, dsp_trained, work21)
    dit_runs.append(t2d_zero)
    log_t(f"  done but (b): phase 21 took {time.perf_counter() - t21:.1f} s "
          f"({elapsed()})")
    serve_ranks = join(serve_b, "[19] (b)")
    log(f"  [20] (b) {DSP_RANKS} ranks on the card over gloo, depth "
        f"{PAGED_RANK_DEPTH}, beside phase 22 ({elapsed()})")
    paged_b = behind(paged_four_ranks(work20), work20)

    log(f"[22] starcoder2-7b, gemma2-2b and qwen2-moe-a2.7b on one card "
        f"({elapsed()})")
    t22 = time.perf_counter()
    m22 = models_on_one_card()
    log_t(f"  done: phase 22 took {time.perf_counter() - t22:.1f} s "
          f"({elapsed()})")
    paged_ranks = join(paged_b, "[20] (b)")
    log(f"  [21] (b) {DSP_RANKS} ranks on the card over gloo, depth "
        f"{T2D_ZERO_DEPTH} in float32 ({elapsed()})")
    t2d_zero_ranks = run_part(t2d_zero_four_ranks(work21))
    remove_dir(work21)

    log(f"[23] qwen2-moe-a2.7b under its spec's own plan: MoE with ep under "
        f"DSP on a (data, model) mesh ({elapsed()})")
    t23 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        prespawn("--moe-rank", work)
        log("  (a) world size 1 over NCCL, full width, depth "
            f"{MOE_TRAIN_DEPTH}")
        moe_dsp = moe_world_of_one(m22, work)
        log(f"  (b) {DSP_RANKS} ranks on the card over gloo, depth "
            f"{MOE_RANK_DEPTH} in float32 ({elapsed()})")
        moe_ranks = run_part(moe_four_ranks(work))
    log_t(f"  done: phase 23 took {time.perf_counter() - t23:.1f} s "
          f"({elapsed()})")

    log(f"[24] mistral-large-123b on one card, its KV cache in "
        f"{mistral_large_123b.CONFIG.cache_dtype} ({elapsed()})")
    t24 = time.perf_counter()
    m24 = mistral_on_one_card()
    log_t(f"  done: phase 24 took {time.perf_counter() - t24:.1f} s "
          f"({elapsed()})")

    log(f"[25] mistral-large-123b under its spec's own plan: tp with ZeRO-3 "
        f"over data and the vocab ring on a (data, model) mesh "
        f"({elapsed()})")
    t25 = time.perf_counter()
    work25 = work_dir()
    prespawn("--tp-rank", work25)
    log(f"  (a) world size 1 over NCCL, full width, depth "
        f"{MISTRAL_TRAIN_DEPTH} (training) and {MISTRAL_SERVE_DEPTH} "
        f"(serving)")
    m25 = tp_world_of_one(m24, work25)
    log(f"  (b) {DSP_RANKS} ranks on the card over gloo, depth "
        f"{TP_RANK_DEPTH} in float32, beside phase 26 (a)-(d) "
        f"({elapsed()})")
    tp_b = behind(tp_four_ranks(work25), work25)
    log_t(f"  done but (b): phase 25 took {time.perf_counter() - t25:.1f} s "
          f"({elapsed()})")

    log(f"[26] seamless-m4t-large-v2, the enc-dec model: served and trained "
        f"on one card, and under its spec's own plan on a (data, model) "
        f"mesh ({elapsed()})")
    t26 = time.perf_counter()
    joined = {}

    def before_26e():
        # 25 (b)'s ranks ran beside (a)-(d): 4 x 9.1 GB beside <= 31 GB
        joined["tp_ranks"] = join(tp_b, "[25] (b)")
    with tempfile.TemporaryDirectory() as work:
        prespawn("--seamless-rank", work)
        m26 = seamless_phase(work, early=before_26e)
    tp_ranks = joined["tp_ranks"]
    log_t(f"  done: phase 26 took {time.perf_counter() - t26:.1f} s "
          f"({elapsed()})")

    log(f"[27] arctic-480b under its spec's own plan (tp with ep and "
        f"ZeRO-3) on a (data, model) mesh, and MoE served on a mesh "
        f"({elapsed()})")
    t27 = time.perf_counter()
    work27 = work_dir()
    # phase 28's CLI launches, started here and after 27 (b)
    launched = {}
    try:
        launched.update(cli_launches([n for n in cli_commands()
                                      if n not in EARLY_CLIS]))
        prespawn("--arctic-rank", work27)
        m27 = arctic_phase(m22, work27, early=lambda: launched.update(
            cli_launches(EARLY_CLIS)))
        log(f"  (e) {DSP_RANKS} ranks on the card over gloo, depth "
            f"{ARCTIC_RANK_DEPTH} with {ARCTIC_RANK_EXPERTS} experts in "
            f"float32, beside phases 28 and 29 (a) ({elapsed()})")
        arctic_b = behind(arctic_four_ranks(work27), work27)
    except BaseException:
        close_launches(launched)
        raise
    log_t(f"  done but (e): phase 27 took {time.perf_counter() - t27:.1f} s "
          f"({elapsed()})")

    log(f"[28] the CLIs under torchrun at SMOKE size, side by side: phases "
        f"19 (c), 20 (c), 23 (c), 25 (c), 26 (e) and 27 (f)'s, "
        f"{sorted(n for n in launched if n not in EARLY_CLIS)} started at "
        f"the top of phase 27, {sorted(EARLY_CLIS)} after its (b) "
        f"({elapsed()})")
    t28 = time.perf_counter()
    try:
        launched.update(cli_launches(
            [n for n in cli_commands() if n not in launched]))
        serve_cli_ranks(serve_main, launched)
        paged_clis(serve_main, launched)
        train_cli_ranks("23c/train", launched, train_main,
                        "qwen2-moe-a2.7b", MOE_PLAN)
        train_cli_ranks("25c/train", launched, train_main,
                        "mistral-large-123b", TP_PLAN)
        tp_cli_ranks(launched, serve_main)
        train_cli_ranks("26e/train", launched, train_main,
                        "seamless-m4t-large-v2", SEAMLESS_PLAN)
        train_cli_ranks("27f/train", launched, train_main, "arctic-480b",
                        ARCTIC_PLAN)
        tp_cli_ranks(launched, serve_main, "27f/serve", ARCTIC_SERVE_CLI)
    finally:
        close_launches(launched)
    log_t(f"  done: phase 28 took {time.perf_counter() - t28:.1f} s "
          f"({elapsed()})")

    log(f"[29] seamless-m4t-large-v2 served on a (data, model) mesh under "
        f"its spec's own plan ({elapsed()})")
    t29 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        prespawn("--seamless-serve-rank", work)
        log("  (a) world size 1 over NCCL, full width and depth, phase 26 "
            "(b)'s trace")
        m29 = {"serve": seamless_mesh_world_of_one(m26["serve"], work)}
        m27["ranks"] = join(arctic_b, "[27] (e)")
        log(f"  (b) {DSP_RANKS} ranks on the card over gloo, depth "
            f"{SEAMLESS_RANK_DEPTH} + {SEAMLESS_RANK_DEPTH} in float32 "
            f"({elapsed()})")
        m29["ranks"] = run_part(seamless_serve_four_ranks(work))
    log_t(f"  done: phase 29 took {time.perf_counter() - t29:.1f} s "
          f"({elapsed()})")

    log(f"[30] pixtral-12b with the VLM frontend on one card and under its "
        f"spec's own plan ({elapsed()})")
    t30 = time.perf_counter()
    m30 = pixtral_phase()
    log_t(f"  done: phase 30 took {time.perf_counter() - t30:.1f} s "
          f"({elapsed()})")
    log(f"[31] jamba-1.5-large-398b: one period at full width on one "
        f"card, served under {JAMBA_SERVE_PLAN} at world size 1, and on "
        f"{DSP_RANKS} ranks under its spec's own plan ({elapsed()})")
    t31 = time.perf_counter()
    work31 = work_dir()
    prespawn("--jamba-rank", work31)
    m31 = jamba_phase(work31)
    log_t(f"  done: phase 31 took {time.perf_counter() - t31:.1f} s "
          f"({elapsed()})")
    pixtral_runs = [m30["serve"], m30["serve"]["patch_prefill"],
                    m30["train"], m30["zero"]]
    jamba_runs = [m31["serve"], m31["mesh_serve"]]
    jamba_k2 = [r["kernels"]["ssd_scan_fwd"] for r in jamba_runs]
    arctic_runs = [m27["serve"], m27["tp_serve"],
                   m27["train"], m27["tp_train"], m27["qwen2_mesh"]]
    model_runs = [m22["starcoder2-7b"], m22["gemma2-2b"],
                  m22["qwen2-moe-a2.7b"], m22["qwen2-moe-a2.7b/train"],
                  moe_dsp, m24["serve"], m24["train"], m25["train"],
                  m25["serve"], m26["serve"], m26["train"], m26["dsp"],
                  *arctic_runs, m29["serve"], *pixtral_runs, *jamba_runs]

    log(facts)
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:36",
        "launches": (served["launches"] + q_trained["launches"]
                     + dit_trained["launches"] + dsp_trained["launches"]
                     + sp_launches + l2d["launches"] + q_dsp["launches"]
                     + q_zero["launches"] + q_sv["launches"]
                     + paged["launches"] + t2d_zero["launches"]
                     + sum(r["launches"] for r in model_runs)),
        "launches_by_route": by_route([served, q_trained, q_dsp, q_zero,
                                       q_sv, paged] + dit_runs + model_runs),
        "models": {**{name: {**models[name],
                             "launches": m22[name]["launches"],
                             "routes": m22[name]["routes"]}
                      for name in MODEL_ATTN},
                   "qwen2-moe-a2.7b/train": {
                       "launches": m22["qwen2-moe-a2.7b/train"]["launches"],
                       "routes": m22["qwen2-moe-a2.7b/train"]["routes"]},
                   "qwen2-moe-a2.7b/dsp": {
                       "launches": moe_dsp["launches"],
                       "routes": moe_dsp["routes"]},
                   "qwen2-moe-a2.7b/rank_launches": [
                       {label: r[label]["k1_routes"] for label in r}
                       for r in moe_ranks["ranks"]],
                   **{name: {**tp_times[name]} for name in TP_ATTN},
                   "mistral-large-123b/launches": {
                       "serve": m24["serve"]["launches"],
                       "train": m24["train"]["launches"],
                       "tp_train": m25["train"]["launches"],
                       "tp_serve": m25["serve"]["launches"],
                       "routes": by_route([m24["serve"], m24["train"],
                                           m25["train"], m25["serve"]])},
                   "mistral-large-123b/rank_launches": [
                       {label: r[label]["k1_routes"] for label in r}
                       for r in tp_ranks["ranks"]],
                   **seamless_times,
                   "seamless-m4t-large-v2/launches": {
                       "serve": m26["serve"]["launches"],
                       "train": m26["train"]["launches"],
                       "dsp_train": m26["dsp"]["launches"],
                       "routes": by_route([m26["serve"], m26["train"],
                                           m26["dsp"]])},
                   "seamless-m4t-large-v2/rank_launches": [
                       {label: r[label]["k1_routes"] for label in r}
                       for r in m26["ranks"]["ranks"]],
                   **arctic_times,
                   "arctic-480b/launches": {
                       "serve": m27["serve"]["launches"],
                       "tp_ep_serve": m27["tp_serve"]["launches"],
                       "train": m27["train"]["launches"],
                       "tp_ep_zero_train": m27["tp_train"]["launches"],
                       "qwen2-moe_dsp_ep_serve":
                           m27["qwen2_mesh"]["launches"],
                       "routes": by_route(arctic_runs)},
                   "arctic-480b/rank_launches": [
                       {label: r[label]["k1_routes"] for label in r}
                       for r in m27["ranks"]["ranks"]],
                   "seamless-m4t-large-v2/mesh_serve": {
                       "launches": m29["serve"]["launches"],
                       "routes": m29["serve"]["routes"],
                       "metrics": m29["serve"]["metrics"]},
                   "seamless-m4t-large-v2/mesh_serve_rank_launches": [
                       {label: r[label]["k1_routes"] for label in r}
                       for r in m29["ranks"]["ranks"]],
                   **{name: {**m30["attn"][name],
                             "max_abs_err": pixtral_errs[name]}
                      for name in PIXTRAL_ATTN},
                   "pixtral-12b/launches": {
                       "serve": m30["serve"]["launches"],
                       "patch_prefill": m30["serve"]["patch_prefill"][
                           "launches"],
                       "train": m30["train"]["launches"],
                       "dsp_zero_train": m30["zero"]["launches"],
                       "routes": by_route(pixtral_runs)},
                   **{name: {**m31["attn"][name],
                             "max_abs_err": jamba_errs[name]}
                      for name in JAMBA_ATTN},
                   "jamba-1.5-large-398b/launches": {
                       "serve": m31["serve"]["launches"],
                       "dsp_ep_serve": m31["mesh_serve"]["launches"],
                       "routes": by_route(jamba_runs)},
                   "jamba-1.5-large-398b/rank_launches": [
                       {label: r[label]["k1_routes"] for label in r}
                       for r in m31["ranks"]["ranks"]]},
        "paged_launches": paged["launches"],
        "paged_rank_launches": [r["k1_launches"]
                                for r in paged_ranks["ranks"]],
        "paged_chunks": chunks,
        "lm_dsp_launches": q_dsp["launches"],
        "lm_dsp_rank_launches": [r["qwen3-14b"]["k1_heads"]
                                 for r in lm_ranks["ranks"]],
        "serve_sharded_launches": q_sv["launches"],
        "serve_sharded_rank_launches": [
            r["qwen3-14b"]["heads"] for r in serve_ranks["ranks"]],
        "lm_zero_launches": q_zero["launches"],
        "lm_zero_rank_launches": {
            label: [r[label]["k1_heads"] for r in zero_ranks["ranks"]]
            for label in ("qwen3-14b/2x2",)},
        "max_abs_err": slice_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": library_ms,
        "kernel_route": route, "cuda_cores_ms": cuda_cores_ms,
        "dit": {**dit, "launches": dit_trained["launches"],
                "dsp_launches": dsp_trained["launches"],
                "sp_launches": {k: r["launches"]
                                for k, r in sp["modes"].items()},
                "l2d_launches": l2d["launches"],
                "l2d_rank_launches": {k: v["k1"]
                                      for k, v in l2d_ranks.items()},
                "zero_launches": t2d_zero["launches"],
                "zero_rank_launches": [
                    {label: r[label]["k1_routes"] for label in
                     (f"{a}x{b}" for a, b in T2D_ZERO_MESHES)}
                    for r in t2d_zero_ranks["ranks"]],
                "launches_by_route": by_route(dit_runs),
                "max_abs_err": dit_err, "temporal": dit_temporal}}, {
        "name": "ssd_scan_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_sm90.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:35",
        "launches": (trained["launches"] + m_served["launches"]
                     + m_dsp["launches"] + m_zero["launches"]
                     + m_ckpt["launches"] + m_sv["launches"]
                     + sum(r["launches"] for r in jamba_k2)),
        "launches_by_route": by_route([trained, m_served, m_dsp, m_zero,
                                       m_ckpt, m_sv, *jamba_k2]),
        "jamba-1.5-large-398b": {
            **m31["ssd"],
            "max_abs_err": jamba_ssd_errs[
                f"{tuple(JAMBA_SSD)} bfloat16 sm90"],
            "launches": {"serve": jamba_k2[0]["launches"],
                         "dsp_ep_serve": jamba_k2[1]["launches"],
                         "routes": by_route(jamba_k2)},
            "p128_checks": jamba_ssd_errs,
            "rank_launches": [{label: r[label]["k2_routes"] for label in r}
                              for r in m31["ranks"]["ranks"]]},
        "serve_sharded_launches": m_sv["launches"],
        "serve_sharded_rank_launches": [
            r["mamba2-370m"]["heads"] for r in serve_ranks["ranks"]],
        "lm_dsp_launches": m_dsp["launches"],
        "lm_dsp_rank_launches": [r["mamba2-370m"]["k2_heads"]
                                 for r in lm_ranks["ranks"]],
        "lm_zero_launches": m_zero["launches"],
        "lm_zero_rank_launches": [r["mamba2-370m/2x2"]["k2_heads"]
                                  for r in zero_ranks["ranks"]],
        "ckpt_launches": m_ckpt["launches"],
        "ckpt_rank_launches": [r["k2"]["launches"]
                               for r in ckpt_ranks["ranks"]],
        "max_abs_err": ssd_err,
        "ms": ssd_t["ms"], "plain_ms": ssd_t["plain_ms"],
        "bound_ms": ssd_t["bound_ms"], "bound_by": ssd_t["bound_by"],
        "library_ms": None, "kernel_route": ssd_t["route"],
        "cuda_cores_ms": ssd_t["cuda_cores_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] and sys.argv[1].endswith("-rank"):
        wait_for_go(sys.argv[1], sys.argv[4])
    if sys.argv[1:2] == ["--dsp-rank"]:
        dsp_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--sp-rank"]:
        sp_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--l2d-rank"]:
        l2d_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--lm-rank"]:
        lm_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--zero-rank"]:
        zero_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--ckpt-rank"]:
        ckpt_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--serve-rank"]:
        serve_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--paged-rank"]:
        paged_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--t2d-zero-rank"]:
        t2d_zero_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--moe-rank"]:
        moe_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--tp-rank"]:
        tp_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--seamless-rank"]:
        seamless_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--arctic-rank"]:
        arctic_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--seamless-serve-rank"]:
        seamless_serve_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                 sys.argv[4])
    elif sys.argv[1:2] == ["--jamba-rank"]:
        jamba_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        try:
            main()
        finally:
            stop_ready()
