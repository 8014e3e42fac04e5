"""Radix tree over prompt token prefixes, at KV-block granularity (a copy
of ``repro.serving.prefix_tree``; the port imports nothing of ``repro``).

The tree's edges are FULL blocks of ``block_size`` token ids; a path from
the root spells out a prompt prefix and each node names the physical KV
block (in ``serving.block_pool.BlockPool``) holding that span's K/V.  A new
request walks the tree block-by-block: every hit is a block it *references*
instead of prefilling — a shared system prompt is computed once and read by
every matching request.

Sharing is copy-on-write at block granularity, the vLLM prefix-caching
discipline: only blocks FULLY covered by the prompt are ever shared, and a
request's decode writes always land at positions >= its prompt length,
i.e. in blocks it allocated privately — so a shared block is physically
immutable and "copy" means "the partial tail block is simply prefilled
privately", never an in-place mutation racing a reader.  Divergence after
a shared prefix is therefore free: two requests share the prefix blocks
and write their own tails (tests/test_torch_paged.py pins this).

Under DSP none of this touches a device: blocks are rank-symmetric
(sequence-sharded WITHIN), so a tree hit is a host-side int handed to the
block table — zero collectives, zero resharding.

The tree holds one pool reference per cached block (``BlockPool.incref``
by the caller on ``insert``); ``evict`` releases least-recently-used
*leaf* nodes when the pool runs dry — a block whose last reader is the
tree is physically freed by the caller's ``decref``, one still read by a
live request merely stops being discoverable.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple


class _Node:
    __slots__ = ("children", "parent", "key", "block", "last_use")

    def __init__(self, parent: Optional["_Node"] = None,
                 key: Optional[Tuple[int, ...]] = None,
                 block: Optional[int] = None):
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.parent = parent
        self.key = key
        self.block = block
        self.last_use = 0


class PrefixTree:
    """Block-granular radix tree; all token sequences are 1-D int lists."""

    def __init__(self, block_size: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = block_size
        self.root = _Node()
        self._clock = 0          # monotonic LRU tick
        self.hits = 0            # block-level counters (scheduler reports
        self.misses = 0          # token-level hit rate from match lengths)

    def __len__(self) -> int:
        """Number of cached blocks (nodes below the root)."""
        n, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            n += len(node.children)
            stack.extend(node.children.values())
        return n

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _keys(self, tokens) -> List[Tuple[int, ...]]:
        bs = self.block_size
        n_full = len(tokens) // bs
        return [tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
                for i in range(n_full)]

    # -- lookup ---------------------------------------------------------------

    def match(self, tokens, *, peek: bool = False) -> Tuple[List[int], int]:
        """Longest cached full-block prefix of ``tokens``: returns the
        physical blocks (root-to-leaf order) and the token count they
        cover.  Touches every matched node's LRU clock and the hit/miss
        counters — unless ``peek``, the read-only mode for feasibility
        probes: a request that is merely being *checked* (not admitted)
        must neither refresh its prefix's recency (skewing LRU eviction
        against other cached prefixes) nor inflate the hit stats."""
        blocks: List[int] = []
        node = self.root
        now = None if peek else self._tick()
        for key in self._keys(tokens):
            child = node.children.get(key)
            if child is None:
                if not peek:
                    self.misses += 1
                break
            if not peek:
                child.last_use = now
                self.hits += 1
            blocks.append(child.block)
            node = child
        return blocks, len(blocks) * self.block_size

    # -- registration ---------------------------------------------------------

    def insert(self, tokens, blocks) -> List[int]:
        """Register ``tokens``' full-block prefix as cached in ``blocks``
        (one physical block per full token block, root order — a request's
        table prefix).  Existing nodes keep their block (first writer
        wins); returns the physical blocks of NEWLY created nodes, for
        which the caller must take a pool reference (``incref``) — the
        tree's ownership share."""
        added: List[int] = []
        node = self.root
        now = self._tick()
        for key, block in zip(self._keys(tokens), blocks):
            child = node.children.get(key)
            if child is None:
                child = _Node(parent=node, key=key, block=int(block))
                node.children[key] = child
                added.append(int(block))
            child.last_use = now
            node = child
        return added

    # -- eviction -------------------------------------------------------------

    def evict(self, n_blocks: int, evictable=None) -> List[int]:
        """Remove up to ``n_blocks`` least-recently-used LEAF nodes (leaves
        only: an inner node's block is the prefix of its children, evicting
        it would orphan them).  ``evictable(block) -> bool`` restricts the
        candidates — the scheduler passes "the tree is the sole owner", so
        eviction only ever touches blocks whose ``decref`` actually frees
        memory; a prefix still read by a live request stays cached instead
        of being dropped for zero gain.  Returns the evicted physical
        blocks; the caller drops the tree's pool reference on each
        (``decref``).

        One DFS collects the initial leaf set; from there the candidate
        set is maintained incrementally through a min-heap on
        ``last_use`` (evicting a node may turn its parent into a leaf —
        push it then), so reclaiming K blocks costs O(tree + K log tree)
        instead of re-walking the whole tree per victim."""
        evicted: List[int] = []
        heap: List[Tuple[int, int, _Node]] = []
        seq = 0                  # insertion tie-break; never compares nodes
        stack = [self.root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                if child.children:
                    stack.append(child)
                else:
                    heap.append((child.last_use, seq, child))
                    seq += 1
        heapq.heapify(heap)
        while heap and len(evicted) < n_blocks:
            _, _, victim = heapq.heappop(heap)
            if evictable is not None and not evictable(victim.block):
                continue         # stays cached; keeps its parent pinned too
            del victim.parent.children[victim.key]
            evicted.append(victim.block)
            parent = victim.parent
            if parent is not self.root and not parent.children:
                heapq.heappush(heap, (parent.last_use, seq, parent))
                seq += 1
        return evicted
