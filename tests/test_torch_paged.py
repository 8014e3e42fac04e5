"""The port's paged serving tier (``BlockPool``, ``PrefixTree``, chunked
prefill, ``PagedScheduler``) against the JAX package's on the CPU, one
process: the analog of every case of tests/test_paged.py, each run beside
JAX's ``PagedScheduler`` on the same TINY config, weights carried across
through ``bridge.params_from_numpy``, f32.

Bars: tokens equal to JAX's paged run's and to the port's static
``generate``; after each run the block tables, ref counts, free lists, tree
size and metrics counters equal JAX's.  The paged attention layer and the
chunk's K1 route (its plain version here) within 1e-5 of JAX's paged
attention; an idle lane stepped past ``max_len`` writes nothing, as JAX's
scatter drops it; the block and chunk counts of the card's paged trace
(``chip_smoke.py`` phase 20 (a)) at its lengths, on a tiny model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models.lm import LMConfig as JConfig
from repro.models.lm import init_lm as jinit
from repro.serving.block_pool import BlockPool as JBlockPool
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.prefix_tree import PrefixTree as JPrefixTree
from repro.serving.scheduler import ContinuousScheduler as JContinuous
from repro.serving.scheduler import PagedScheduler as JPaged
from repro_torch import bridge
from repro_torch.models import attention as TA
from repro_torch.models.lm import LMConfig, init_lm
from repro_torch.serving import (GARBAGE_BLOCK, BlockPool, PagedScheduler,
                                 PoolExhausted, PrefixTree)
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.scheduler import ContinuousScheduler
from _torch_threads import one_thread  # noqa: E402,F401

TINY = dict(name="tiny-paged", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, head_dim=8, d_ff=64, vocab=64)
JTINY = JConfig(**TINY, dtype=jnp.float32)
TTINY = LMConfig(**TINY, dtype=torch.float32)
MAX_LEN = 32
ATTN_BAR = 1e-5
# the card's paged trace (chip_smoke.py phase 20 (a)): a shared system
# prompt, then suffixes of these lengths in this order twice, 4 slots,
# 16-token blocks, 512-token chunks, 32 new tokens each
SYSTEM, SUFFIXES, NEW, CHUNK = 1024, (64, 256, 512, 1024), 32, 512


@pytest.fixture(scope="module")
def engines():
    jp = jinit(jax.random.PRNGKey(0), JTINY)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    return (JEngine(jp, JTINY, max_len=MAX_LEN),
            ServingEngine(tp, TTINY, max_len=MAX_LEN, device="cpu"))


def _ids(seed, shape):
    return np.random.RandomState(seed).randint(0, TINY["vocab"], shape)


@pytest.fixture(scope="module")
def prompts():
    return _ids(1, (3, 8))


def _reqs(prompts, budgets, **kw):
    """The same requests for both packages: (JAX's, the port's)."""
    return ([JRequest(prompt=jnp.asarray(p), max_new_tokens=m, request_id=i,
                      **kw) for i, (p, m) in enumerate(zip(prompts, budgets))],
            [Request(prompt=torch.from_numpy(np.asarray(p)),
                     max_new_tokens=m, request_id=i, **kw)
             for i, (p, m) in enumerate(zip(prompts, budgets))])


def _static(teng, prompt, budget):
    """The port's static ``generate`` of one request alone."""
    return teng.generate(torch.from_numpy(np.asarray(prompt))[None],
                         budget)[0].tolist()


COUNTERS = ("decode_steps", "prefills", "slots_allocated",
            "tokens_generated", "prefill_chunk_steps", "prefix_hit_tokens",
            "prompt_tokens", "blocks_in_use", "blocks_free",
            "peak_blocks_in_use")


def _same_state(js, ts):
    """The host state after a run equals JAX's: tables, ref counts, free
    lists, slot blocks, tree, metrics counters."""
    jp, tp = js.pool, ts.pool
    assert np.asarray(jp.caches["table"]).tolist() == \
        tp.caches["table"].tolist()
    assert jp.ref.tolist() == tp.ref.tolist()
    assert jp._free_blocks == tp._free_blocks
    assert jp._free_slots == tp._free_slots
    assert jp._slot_blocks == tp._slot_blocks
    assert jp.lengths.tolist() == tp.lengths.tolist()
    assert jp.peak_blocks_in_use == tp.peak_blocks_in_use
    assert (js.tree is None) == (ts.tree is None)
    if js.tree is not None:
        assert len(js.tree) == len(ts.tree)
        assert (js.tree.hits, js.tree.misses) == (ts.tree.hits,
                                                  ts.tree.misses)
    for k in COUNTERS:
        assert getattr(js.metrics, k) == getattr(ts.metrics, k), k


def _both(engines, prompts, budgets, *, sched_kw=None, run_kw=None,
          on_step=None):
    """One trace through JAX's and the port's ``PagedScheduler``: (JAX's
    scheduler and requests, the port's)."""
    jeng, teng = engines
    jr, tr = _reqs(prompts, budgets)
    js = JPaged(jeng, **(sched_kw or {}))
    ts = PagedScheduler(teng, **(sched_kw or {}))
    js.run(jr, **(run_kw or {}))
    ts.run(tr, on_step=on_step, **(run_kw or {}))
    for j, t in zip(jr, tr):
        assert t.generated == j.generated, t.request_id
        assert t.result.finish_reason == j.result.finish_reason
    _same_state(js, ts)
    return (js, jr), (ts, tr)


# ---------------------------------------------------------------------------
# Block pool (host bookkeeping)
# ---------------------------------------------------------------------------

def _pools(**kw):
    return (JBlockPool(JTINY, max_batch=2, max_len=MAX_LEN, block_size=8,
                       **kw),
            BlockPool(TTINY, max_batch=2, max_len=MAX_LEN, block_size=8,
                      device="cpu", **kw))


def test_block_pool_alloc_free_refcount():
    jp, pool = _pools()
    assert pool.blocks_per_slot == 4 and pool.n_blocks == jp.n_blocks
    n = pool.n_blocks - 1                       # block 0 is the garbage sink
    assert pool.free_blocks == n
    blocks = pool.alloc_blocks(3)
    assert blocks == jp.alloc_blocks(3)
    assert len(set(blocks)) == 3 and GARBAGE_BLOCK not in blocks
    assert pool.free_blocks == n - 3
    assert all(pool.ref[b] == 1 for b in blocks)
    for p in (jp, pool):
        p.incref(blocks[:1])                    # a second reader
        assert p.decref(blocks) == blocks[1:]   # the shared block survives
    assert pool.free_blocks == n - 1
    assert pool.decref(blocks[:1]) == jp.decref(blocks[:1]) == blocks[:1]
    assert pool.free_blocks == n
    assert pool.ref.tolist() == jp.ref.tolist()
    assert pool._free_blocks == jp._free_blocks
    # the garbage sink is pinned: never allocated, never freed
    assert pool.ref[GARBAGE_BLOCK] == 1
    with pytest.raises(PoolExhausted):
        pool.alloc_blocks(n + 1)
    with pytest.raises(ValueError):
        pool.can_admit(pool.blocks_per_slot + 1)   # can NEVER fit a slot
    # the leaves are zeros, in the layout (periods, blocks, Hkv, b, D)
    k = pool.caches["periods"]["0"]["kv"]["k"]
    assert k.shape == jp.caches["periods"]["0"]["kv"]["k"].shape
    assert not k.any()


def test_block_pool_bind_free_slot():
    jp, pool = _pools()
    blocks = pool.alloc_blocks(2)
    jp.alloc_blocks(2)
    before = {k: v.clone() for k, v in
              pool.caches["periods"]["0"]["kv"].items()}
    slot = pool.bind(blocks, start=5)
    assert slot == jp.bind(blocks, start=5)
    assert pool.slot_blocks(slot) == blocks
    table = pool.caches["table"]
    assert table.dtype == torch.long and pool.caches["pos"][slot] == 5
    assert table[slot, :2].tolist() == blocks
    assert (table[slot, 2:] == GARBAGE_BLOCK).all()
    assert table.tolist() == np.asarray(jp.caches["table"]).tolist()
    freed = pool.free_slot(slot)
    assert sorted(freed) == sorted(blocks) == sorted(jp.free_slot(slot))
    assert (pool.caches["table"][slot] == GARBAGE_BLOCK).all()
    assert pool.n_free_slots == 2
    # bind and free_slot write a table row and pos, never the leaves
    for k, v in pool.caches["periods"]["0"]["kv"].items():
        assert torch.equal(v, before[k])


def test_block_pool_rejects_ssm():
    kw = dict(name="ssm", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
              head_dim=8, d_ff=64, vocab=64, pure_ssm=True)
    with pytest.raises(ValueError, match="KVPool"):
        JBlockPool(JConfig(**kw, dtype=jnp.float32), max_batch=2,
                   max_len=32, block_size=8)
    with pytest.raises(ValueError, match="KVPool"):
        BlockPool(LMConfig(**kw, dtype=torch.float32), max_batch=2,
                  max_len=32, block_size=8, device="cpu")


# ---------------------------------------------------------------------------
# Prefix tree (host structure)
# ---------------------------------------------------------------------------

def test_prefix_tree_match_insert_evict():
    """JAX's sequence of operations on both trees, the same answers and
    the same hit and miss counters."""
    trees = (JPrefixTree(block_size=4), PrefixTree(block_size=4))
    for t in trees:
        toks = list(range(10))                  # 2 full blocks + tail of 2
        assert t.match(toks) == ([], 0)
        assert t.insert(toks, [5, 6]) == [5, 6]
        assert len(t) == 2
        assert t.match(toks) == ([5, 6], 8)     # the tail never matches
        assert t.match(toks[:4]) == ([5], 4)
        assert t.match([99] * 8) == ([], 0)
        assert t.insert(toks, [7, 8]) == []     # first writer wins
        assert t.match(toks)[0] == [5, 6]
        toks2 = toks[:4] + [50, 51, 52, 53]
        assert t.insert(toks2, [5, 9]) == [9]
        assert len(t) == 3
        t.match(toks2)                          # branch 2 is now recent
        assert t.evict(1) == [6]
        assert t.evict(1, evictable=lambda b: False) == []
        assert t.evict(2) == [9, 5]             # 9 (leaf), then 5
        assert len(t) == 0
    assert [(t.hits, t.misses, t._clock) for t in trees] == \
        [(7, 2, 9)] * 2


def test_prefix_tree_peek_is_read_only():
    for cls in (JPrefixTree, PrefixTree):
        t = cls(block_size=4)
        toks = list(range(8))
        t.insert(toks, [1, 2])
        before = (t.hits, t.misses, t._clock)
        assert t.match(toks, peek=True) == ([1, 2], 8)
        assert t.match([99] * 8, peek=True) == ([], 0)
        assert (t.hits, t.misses, t._clock) == before
        t2 = cls(block_size=2)
        t2.insert([0, 1], [3])
        t2.insert([5, 6], [4])
        t2.match([5, 6])                  # branch B is now the recent one
        t2.match([0, 1], peek=True)       # a probe of the stale branch A
        assert t2.evict(1) == [3]         # A still evicts first


# ---------------------------------------------------------------------------
# The paged attention layer against JAX's
# ---------------------------------------------------------------------------

ATTN = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)
ATTN_CFGS = {"plain": {}, "window": {"window": 6},
             "softcap": {"softcap": 5.0}}


def _paged_inputs(s):
    """A block pool's layer at block 4, 10 blocks, 2 rows of 4 table
    entries, random K/V in every block; row 0 at position 9 (mid-prefill
    for a chunk), row 1 at 2; x (rows, s, 32)."""
    rng = np.random.RandomState(3)
    kv = rng.randn(2, 10, 2, 4, 8).astype(np.float32)
    table = np.array([[3, 7, 1, 5], [2, 9, 0, 0]], np.int32)
    pos = np.array([9, 2], np.int32)
    x = rng.randn(2, s, 32).astype(np.float32)
    return kv, table, pos, x


@pytest.mark.parametrize("name", list(ATTN_CFGS))
@pytest.mark.parametrize("s", [1, 5])
def test_paged_attention_matches_jax(name, s):
    """``attention(cache={k, v, pos, table})`` against JAX's paged branch:
    a decode step of 2 rows (S = 1) and a prefill chunk of one row (S =
    5: the K1 route, its plain version on the CPU), the output within 1e-5
    of the largest |value| and the written blocks equal."""
    jcfg = JA.AttnConfig(**ATTN, **ATTN_CFGS[name])
    tcfg = TA.AttnConfig(**ATTN, **ATTN_CFGS[name])
    jp = JA.init_attention(jax.random.PRNGKey(4), jcfg)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    kv, table, pos, x = _paged_inputs(s)
    rows = 2 if s == 1 else 1
    jcache = {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1]),
              "pos": jnp.asarray(pos[:rows]),
              "table": jnp.asarray(table[:rows])}
    want, jnew = JA.attention(jp, jnp.asarray(x[:rows]), jcfg, cache=jcache,
                              backend="ref")
    tcache = {"k": torch.from_numpy(kv[0].copy()),
              "v": torch.from_numpy(kv[1].copy()),
              "pos": torch.from_numpy(pos[:rows]).long(),
              "table": torch.from_numpy(table[:rows]).long()}
    if s > 1:
        tcache["start"] = int(pos[0])
    got, tnew = TA.attention(tp, torch.from_numpy(x[:rows]), tcfg,
                             cache=tcache)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= ATTN_BAR * np.abs(want).max()
    for key in ("k", "v"):
        np.testing.assert_allclose(tnew[key].numpy(), np.asarray(jnew[key]),
                                   rtol=0, atol=ATTN_BAR)
    assert tnew["pos"].tolist() == np.asarray(jnew["pos"]).tolist()


def test_chunk_k1_route_matches_ref_decode_paged(monkeypatch):
    """The one-device chunk goes through ``kernels.ops.flash_attention`` at
    ``q_offset = start`` (counted here), and its output equals JAX's
    ``_ref_decode_paged`` over the row's gathered blocks within 1e-5."""
    calls = []
    real = TA.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw["q_offset"]))
        return real(q, k, v, **kw)
    monkeypatch.setattr(TA, "flash_attention", spy)
    cfg = TA.AttnConfig(**ATTN)
    rng = np.random.RandomState(6)
    kv = rng.randn(2, 10, 2, 4, 8).astype(np.float32)
    table = np.array([[3, 7, 1, 5]])
    q = rng.randn(1, 4, 5, 8).astype(np.float32)
    start = 9
    got = TA._paged_chunk(torch.from_numpy(q), torch.from_numpy(kv[0]),
                          torch.from_numpy(kv[1]), torch.from_numpy(table),
                          start, cfg, True, "kernel")
    assert calls == [((1, 4, 5, 8), (1, 2, 14, 8), 9)]
    want = JA._ref_decode_paged(
        jnp.asarray(q), jnp.asarray(kv[0][table]), jnp.asarray(kv[1][table]),
        JA.AttnConfig(**ATTN), jnp.asarray([start]), True)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= ATTN_BAR * np.abs(want).max()
    with pytest.raises(ValueError, match="host int"):
        TA._paged_chunk(torch.from_numpy(q), torch.from_numpy(kv[0]),
                        torch.from_numpy(kv[1]), torch.from_numpy(table),
                        None, cfg, True, "kernel")


def test_idle_lane_past_max_len_writes_nothing():
    """A freed lane keeps stepping: past the end of its table (4 blocks of
    4) JAX's table read gives an out-of-range index and its scatter drops
    the write; the port drops it too, and the row inside the table still
    writes.  Both packages' blocks are equal after the step."""
    jcfg, tcfg = JA.AttnConfig(**ATTN), TA.AttnConfig(**ATTN)
    jp = JA.init_attention(jax.random.PRNGKey(4), jcfg)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    kv, table, _, x = _paged_inputs(1)
    pos = np.array([17, 3], np.int32)           # row 0 past 4 x 4 = 16
    jcache = {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1]),
              "pos": jnp.asarray(pos), "table": jnp.asarray(table)}
    _, jnew = JA.attention(jp, jnp.asarray(x), jcfg, cache=jcache,
                           backend="ref")
    tk, tv = torch.from_numpy(kv[0].copy()), torch.from_numpy(kv[1].copy())
    TA.attention(tp, torch.from_numpy(x), tcfg,
                 cache={"k": tk, "v": tv, "pos": torch.from_numpy(pos).long(),
                        "table": torch.from_numpy(table).long()})
    # row 1 wrote block table[1, 0] = 2 at offset 3; nothing else moved
    moved = (tk.numpy() != kv[0]).any(axis=(1, 3))
    assert moved.nonzero() == (np.array([2]), np.array([3]))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jnew["k"]), rtol=0,
                               atol=ATTN_BAR)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jnew["v"]), rtol=0,
                               atol=ATTN_BAR)


# ---------------------------------------------------------------------------
# The paged scheduler against JAX's and the static oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 4, 5])
def test_paged_parity_and_block_lifecycle(engines, prompts, chunk):
    """Fewer slots than requests (slot and block reuse), whole-prompt,
    aligned and ragged chunks: tokens equal to JAX's paged run and to the
    port's static generate; the state equals JAX's."""
    budgets = (8, 3, 5)
    _, (ts, tr) = _both(engines, prompts, budgets,
                        sched_kw=dict(max_batch=2, block_size=8,
                                      prefill_chunk=chunk))
    ref = engines[1].generate(torch.from_numpy(prompts), list(budgets))
    for i, r in enumerate(tr):
        assert r.generated == ref[i, :budgets[i]].tolist(), i
        assert r.result.finish_reason == "budget"
    assert ts.metrics.slots_allocated == 3 > ts.max_batch
    assert ts.pool.n_free_slots == 2
    assert len(ts.tree) == 3 and ts.pool.blocks_in_use == 3
    assert ts.metrics.prefill_chunk_steps == {None: 3, 4: 6, 5: 6}[chunk]


def test_paged_eos_and_streaming_parity(engines, prompts):
    ref = engines[1].generate(torch.from_numpy(prompts), 8).numpy()
    eos = int(ref[0, 2])
    got = {}
    _, (_, tr) = _both(
        engines, prompts, (8, 8, 8),
        sched_kw=dict(max_batch=2, block_size=8, prefill_chunk=4),
        run_kw=dict(eos_id=eos, stream=lambda r, t: got.setdefault(
            r.request_id, []).append(t)))
    for i, r in enumerate(tr):
        row = ref[i]
        want = row.tolist()
        if (row == eos).any():
            want = row[:int(np.argmax(row == eos)) + 1].tolist()
            assert r.result.finish_reason == "eos"
        assert r.generated == want, i
    # JAX's run streamed into ``got`` first, the port's after: each request
    # twice, the same tokens
    for r in tr:
        assert got[r.request_id] == r.generated * 2


def test_prefix_sharing_hits_and_refcounts(engines):
    """Two requests with the same 16-token prompt, one after the other:
    the second reads the first's cached block (the last full block is
    trimmed so the last prompt token is recomputed: 8 hit tokens), and
    the shared blocks return to the free list only when the tree lets
    go."""
    jeng, teng = engines
    pre = _ids(3, (16,))
    js = JPaged(jeng, max_batch=1, block_size=8, prefill_chunk=4)
    ts = PagedScheduler(teng, max_batch=1, block_size=8, prefill_chunk=4)
    for i in range(2):
        (jr,), (tr,) = _reqs([pre], (6,))
        js.run([jr])
        ts.run([tr])
        assert tr.generated == jr.generated == _static(teng, pre, 6)
        _same_state(js, ts)
        if i == 0:
            blocks = ts.tree.match(pre, peek=True)
    assert ts.metrics.prefix_hit_tokens == 8
    assert ts.metrics.summary()["prefix_hit_rate"] == 8 / 32
    assert ts.tree.match(pre, peek=True) == blocks
    assert all(ts.pool.ref[b] == 1 for b in blocks[0])
    assert ts.pool.blocks_in_use == len(ts.tree)
    ts.pool.decref(ts.tree.evict(len(ts.tree)))
    assert ts.pool.blocks_in_use == 0


def test_cow_divergence_after_shared_prefix(engines):
    """Two prompts share an 8-token prefix, then diverge: the second
    references the first's prefix block and writes its own tail."""
    jeng, teng = engines
    pre, tails = _ids(3, (8,)), _ids(5, (2, 4))
    ps = [np.concatenate([pre, t]) for t in tails]
    js = JPaged(jeng, max_batch=2, block_size=8, prefill_chunk=4)
    ts = PagedScheduler(teng, max_batch=2, block_size=8, prefill_chunk=4)
    jr, tr = _reqs(ps, (5, 5))
    for j, t in zip(jr, tr):
        js.run([j])
        ts.run([t])
        _same_state(js, ts)
    for p, j, t in zip(ps, jr, tr):
        assert t.generated == j.generated == _static(teng, p, 5)
    assert ts.metrics.prefix_hit_tokens == 8
    assert len(ts.tree.match(pre, peek=True)[0]) == 1 and len(ts.tree) == 1


def test_paged_no_prefix_cache_and_exhaustion(engines, prompts):
    """No prefix cache, an over-subscribed pool (4 usable blocks): FIFO
    admission without deadlock; an impossible request raises."""
    budgets = (8, 3, 5)
    _, (ts, tr) = _both(engines, prompts, budgets,
                        sched_kw=dict(max_batch=2, block_size=8,
                                      prefix_cache=False, n_blocks=5))
    ref = engines[1].generate(torch.from_numpy(prompts), list(budgets))
    for i, r in enumerate(tr):
        assert r.generated == ref[i, :budgets[i]].tolist(), i
    assert ts.tree is None and ts.pool.blocks_in_use == 0
    with pytest.raises(ValueError, match="blocks"):
        PagedScheduler(engines[1], max_batch=2, block_size=4).run(
            _reqs(prompts[:1], (60,))[1])


def test_paged_deadlock_raises_not_spins(engines):
    """A head whose fresh blocks exceed the free and the evictable ones
    raises, as JAX's does: its own matched prefix is reader-ref'd during
    admission and must not count as headroom.  The probe peeks: exactly
    one real match moves the tree's counters."""
    jeng, teng = engines
    pre = _ids(7, (16,))
    ext = np.concatenate([pre, _ids(8, (8,))])
    js = JPaged(jeng, max_batch=2, block_size=8, n_blocks=4)
    ts = PagedScheduler(teng, max_batch=2, block_size=8, n_blocks=4)
    jr, tr = _reqs([pre], (8,))
    js.run(jr)
    ts.run(tr)
    _same_state(js, ts)
    assert len(ts.tree) == 2 and ts.pool.free_blocks == 1
    hits, misses = ts.tree.hits, ts.tree.misses
    jr, tr = _reqs([ext], (8,))
    with pytest.raises(RuntimeError, match="deadlock"):
        js.run(jr)
    with pytest.raises(RuntimeError, match="deadlock"):
        ts.run(tr)
    assert (ts.tree.hits, ts.tree.misses) == (hits + 2, misses + 1)
    _same_state(js, ts)


def test_paged_metrics_summary_schema(engines, prompts):
    """The paged summary's keys equal JAX's, and the slot scheduler's
    summary has the same key set (its paged gauges zero or None)."""
    (js, _), (ts, _) = _both(engines, prompts, (4, 4, 4),
                             sched_kw=dict(max_batch=2, block_size=8,
                                           prefill_chunk=4))
    s = ts.metrics.summary()
    assert set(s) == set(js.metrics.summary())
    assert s["tokens_generated"] == 12
    assert s["prefill_chunk_steps"] == 6
    assert s["prefix_hit_rate"] == 0.0              # distinct prompts
    assert s["peak_blocks_in_use"] >= s["blocks_in_use"]
    assert s["blocks_free"] == ts.pool.free_blocks
    cs = ContinuousScheduler(engines[1], max_batch=2)
    cs.run(_reqs(prompts, (2, 2, 2))[1])
    jcs = JContinuous(engines[0], max_batch=2)
    jcs.run(_reqs(prompts, (2, 2, 2))[0])
    cs_s = cs.metrics.summary()
    assert set(cs_s) == set(s) == set(jcs.metrics.summary())
    assert cs_s["prefill_chunk_steps"] == 0 and cs_s["blocks_in_use"] is None


def test_paged_replan_mid_prefill_parity(engines):
    """``replan(1)`` while a chunked prefill is mid-prompt (decode step 2,
    after the step's pos roll-back): the remaining slices stream into the
    moved pool, the tokens equal the static oracle's, the blocks are
    bit-equal across the move and the tables and ref counts untouched."""
    jeng, teng = engines
    long_p, short_p = _ids(9, (16,)), _ids(10, (8,))
    budgets = (8, 8)
    forced = []

    def on_step(s, k):
        if k != 2:
            return
        assert s._prefilling, "no prefill mid-prompt at the replan"
        pf = s._prefilling[0]
        assert 0 < pf.done < len(pf.prompt)
        state = (s.pool.caches["table"].clone(), s.pool.ref.copy())
        leaves = [t.clone() for t in
                  s.pool.caches["periods"]["0"]["kv"].values()]
        s.replan(1)
        assert torch.equal(s.pool.caches["table"], state[0])
        assert (s.pool.ref == state[1]).all()
        for a, b in zip(leaves, s.pool.caches["periods"]["0"]["kv"]
                        .values()):
            assert torch.equal(a, b)
        forced.append((k, pf.done))

    _, (_, tr) = _both(engines, [short_p, long_p], budgets,
                       sched_kw=dict(max_batch=2, block_size=8,
                                     prefill_chunk=5), on_step=on_step)
    assert forced == [(2, 5)]
    for p, m, r in zip((short_p, long_p), budgets, tr):
        assert r.generated == _static(teng, p, m)


# ---------------------------------------------------------------------------
# The card's trace: block and chunk counts (host arithmetic)
# ---------------------------------------------------------------------------

def test_card_trace_counts():
    """``chip_smoke.py`` phase 20 (a)'s trace on a 2-layer model at the
    same lengths: 8 requests of a shared 1024-token prompt and suffixes of
    64, 256, 512, 1024 (twice), 4 slots, 16-token blocks, 512-token
    chunks.  Requests 0-3 are admitted together before any insert; 4-7
    each find the shared prompt in the tree: 4 x 1024 = 4096 hit tokens;
    chunks 3 + 3 + 3 + 4, then 1 + 1 + 1 + 2 = 18."""
    cfg = LMConfig(name="trace", n_layers=2, d_model=32, n_heads=4,
                   n_kv_heads=2, head_dim=8, d_ff=64, vocab=512,
                   dtype=torch.float32)
    max_len = SYSTEM + max(SUFFIXES) + NEW
    eng = ServingEngine(init_lm(0, cfg, device="cpu"), cfg,
                        max_len=max_len + (-max_len) % 16, device="cpu")
    rng = np.random.RandomState(0)
    system = rng.randint(0, cfg.vocab, SYSTEM)
    reqs = [Request(prompt=torch.from_numpy(np.concatenate(
        [system, rng.randint(0, cfg.vocab, n)])), max_new_tokens=NEW,
        request_id=i) for i, n in enumerate(SUFFIXES * 2)]
    sched = PagedScheduler(eng, max_batch=4, block_size=16,
                           prefill_chunk=CHUNK)
    sched.run(reqs)
    m = sched.metrics
    assert all(len(r.generated) == NEW for r in reqs)
    assert m.prefix_hit_tokens == 4 * SYSTEM == 4096
    assert m.prefill_chunk_steps == 3 + 3 + 3 + 4 + 1 + 1 + 1 + 2 == 18
    assert sched.pool.n_blocks == 1 + 4 * 130
