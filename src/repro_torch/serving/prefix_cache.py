"""Prefix (radix) caching over shared paged KV blocks (twin of
``repro.serving.prefix_cache``).

Serving traffic with shared system prompts re-prefills, and re-stores,
identical KV blocks for every request. A prefix cache lets requests
whose prompts share a prefix share that prefix's pool blocks instead of
recomputing them; ``DecodeEngine.kv_stats`` counts the prefill tokens
and KV bytes that were never moved.

**Radix trie, block-granular.** Nodes are keyed on the token ids of one
full KV block (``block_size`` tokens): a path root -> node spells a
cached prefix, and each node carries the pool block holding that span's
K/V (and scale tiles: quantized pools ride the same block ids).
``match`` walks the trie over a new prompt and returns the longest
cached prefix; ``insert`` (at retirement) adds the request's full blocks,
deduplicating against what is cached.

**Refcounts, not ownership.** ``BlockAllocator`` counts references: the
trie holds one per node, every admitted request one per table entry, and
a block returns to the free list when the last is released.

**Copy-on-write at the divergence block.** A prompt that diverges from a
cached prefix mid-block (or equals it: the last token is re-scored to
emit, so its block will be appended to) cannot write into the shared
block. The matched block is copied into a fresh one (``paged.copy_block``:
every pool leaf and layer, scales included) and only the copy enters the
request's table. Positions past the divergence are masked by the slot's
length like the zero padding of a cold prefill.

**LRU eviction under pool pressure.** ``evict`` releases least recently
matched leaf nodes that no live request shares (refcount 1, the trie's
own), walking up as parents become leaves. Admission retains its matched
nodes before evicting, so an eviction can never take blocks a
just-admitted hit needs.

**Session KV: full-history insert and the host spill tier.** A
multi-turn conversation resubmits turn N's prompt plus the model's reply
as turn N + 1's prompt, so ``insert`` caches a retired request's whole
history (prompt and emitted output, full blocks only). In the port those
blocks are written by two formulations: prefill runs flash attention in
torch ops, decode and verify run the paged-attention kernel (its plain
twin on the CPU). They do not round alike, so a later prefill that reads
decode-written blocks is not bitwise the cold run that prefilled them;
the contract is held per formulation (README, "PyTorch / H100 port").
When eviction would destroy that history, an armed ``PrefixSpill``
(``repro_torch.serving.swap``) snapshots each victim block to host
memory keyed by its trie path; ``promote`` pages the longest spilled
continuation of a new prompt back into free pool blocks, gated on the
restore-vs-reprefill ratio (``promote_ratio`` > 1). Promotion restores
device content at once through the engine's callback, so a promoted node
is ordinary evictable content even if the admission that wanted it
fails, and it uses free blocks only: spill -> promote -> spill cannot
thrash the pool.

This module is host bookkeeping only: given the same operations, its
matches, copy-on-write sources, eviction order, promotions and stats
equal the reference's.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

from repro_torch import obs
from repro_torch.serving.faults import AllocatorError


def _lcp(a, b) -> int:
    """Length of the longest common prefix of two token sequences."""
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class TrieNode:
    """One cached full block: ``key`` is its block_size-token span.
    ``seq`` is a creation-order serial, the LRU tiebreak for nodes
    touched at the same clock tick."""

    __slots__ = ("key", "block", "children", "parent", "last_used", "seq")

    def __init__(self, key: tuple, block: int, parent: "TrieNode | None",
                 seq: int = 0):
        self.key = key
        self.block = block
        self.children: dict[tuple, TrieNode] = {}
        self.parent = parent
        self.last_used = 0
        self.seq = seq


@dataclass
class PrefixMatch:
    """Result of a trie walk over one prompt.

    ``blocks`` are the fully shared blocks (retain before use), ``hit``
    the cached tokens usable by the request (at most ``len(prompt) - 1``:
    the final prompt token is always re-scored so the request has logits
    to emit from), and ``cow_src`` the block to copy when ``hit`` ends
    mid-block (else None)."""

    blocks: list[int] = field(default_factory=list)
    hit: int = 0
    cow_src: int | None = None


class PrefixCache:
    """Block-granular radix trie over the shared KV pool.

    Host bookkeeping only: the trie never touches device tensors (the
    engine performs the copy-on-write it requests and the restores of
    ``promote``). Every reference it creates or drops goes through the
    allocator's retain / release, so free + held == capacity holds under
    any interleaving of admissions, retirements and evictions."""

    def __init__(self, allocator, block_size: int):
        self.allocator = allocator
        self.block_size = block_size
        self.root = TrieNode((), -1, None)
        self._clock = 0
        self._nseq = 0
        self.stats = {"requests": 0, "hits": 0, "hit_tokens": 0,
                      "prompt_tokens": 0, "cow_blocks": 0,
                      "evicted_blocks": 0, "nodes": 0,
                      "promoted_blocks": 0, "promoted_tokens": 0}
        self.obs = obs.NULL          # the owning engine's telemetry
        # the session spill tier (armed by the engine; None / 0 keeps it
        # off): the host store, the device restore callback (blocks,
        # snapshots) -> None, and the restore-vs-reprefill ratio
        self.spill = None
        self.promote_fn = None
        self.promote_ratio = 0.0

    # ------------------------------------------------------------ match ----

    def match(self, prompt: list) -> PrefixMatch:
        """Longest cached prefix of ``prompt`` (LRU-touches the path).

        Walks full-block edges while they match, then checks the last
        matched node's children for a partial (mid-block) match, the
        copy-on-write case. Retains nothing: the caller retains
        ``blocks`` (and protects ``cow_src``) before any allocation or
        eviction runs."""
        bs = self.block_size
        # every match advances the clock, before any early return, so the
        # mix of trivial misses cannot skew node ages between runs
        self._clock += 1
        if len(prompt) < 2:
            return PrefixMatch()
        node = self.root
        blocks: list[int] = []
        m = 0
        while m + bs <= len(prompt):
            child = node.children.get(tuple(prompt[m:m + bs]))
            if child is None:
                break
            child.last_used = self._clock
            node = child
            blocks.append(child.block)
            m += bs
        partial = 0
        partial_block = None
        rem = prompt[m:]
        if rem:
            best = None
            for child in node.children.values():
                n = _lcp(child.key, rem)
                if n > partial:
                    partial, best = n, child
            if best is not None:
                partial_block = best.block
                best.last_used = self._clock
        hit = min(m + partial, len(prompt) - 1)
        n_shared = hit // bs
        cow_src = None
        if hit % bs:
            # the block holding positions [n_shared * bs, hit) is shared
            # but will be appended to: copy it
            cow_src = (blocks[n_shared] if n_shared < len(blocks)
                       else partial_block)
        return PrefixMatch(blocks[:n_shared], hit, cow_src)

    # ------------------------------------------------------------ insert ---

    def insert(self, tokens: list, blocks: list[int]) -> None:
        """Cache a retired request's resident tokens (full blocks only).

        ``tokens`` is the span of the request's sequence resident in its
        blocks: with session KV, prompt + output truncated to
        ``len(prompt) + len(output) - 1`` (the last emitted token waits in
        the next-token buffer, never written to the cache). ``blocks`` is
        the request's table row in position order. Existing nodes are
        kept (the duplicate block is released with the request's other
        references); new nodes retain their block."""
        bs = self.block_size
        self._clock += 1
        node = self.root
        for i in range(len(tokens) // bs):
            if i >= len(blocks):
                break
            key = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                self._nseq += 1
                child = TrieNode(key, blocks[i], node, self._nseq)
                node.children[key] = child
                self.allocator.retain([blocks[i]])
                self.stats["nodes"] += 1
            child.last_used = self._clock
            node = child

    # ------------------------------------------------------------ evict ----

    def _evictable_leaves(self) -> list[TrieNode]:
        out = []
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif self.allocator.refcount(n.block) == 1:
                out.append(n)       # only the trie holds it
        return out

    def evict(self, n: int) -> int:
        """Free up to ``n`` pool blocks by dropping least recently used
        unreferenced leaves (parents become evictable as their children
        go); returns the blocks freed. Never touches a node whose block a
        live request shares. One traversal seeds a min-heap; after each
        eviction only the victim's parent is examined again."""
        def entry(nd):
            return (nd.last_used, nd.seq, nd)

        heap = [entry(nd) for nd in self._evictable_leaves()]
        heapq.heapify(heap)
        freed = 0
        while freed < n and heap:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            parent.children.pop(victim.key)
            if self.spill is not None:
                # spill instead of drop, before the pool reference goes
                # (children before parents: promote re-extends outward)
                self.spill.put(self._path_key(victim), victim.block)
            self.allocator.release([victim.block])
            self.stats["nodes"] -= 1
            self.stats["evicted_blocks"] += 1
            freed += 1
            if (parent is not self.root and not parent.children
                    and self.allocator.refcount(parent.block) == 1):
                heapq.heappush(heap, entry(parent))
        if freed and self.obs.enabled:
            self.obs.trace.instant("prefix_evict", freed=freed,
                                   requested=n)
        return freed

    # ------------------------------------------------------------ promote --

    @staticmethod
    def _path_key(node: TrieNode) -> tuple:
        """The full token path root -> ``node``: the spill tier's key."""
        parts = []
        while node.parent is not None:
            parts.append(node.key)
            node = node.parent
        return tuple(t for key in reversed(parts) for t in key)

    def _resident_frontier(self, prompt: list) -> tuple[TrieNode, int]:
        """Deepest trie node on ``prompt``'s full-block path and the
        tokens it covers (no LRU touch)."""
        bs = self.block_size
        node, m = self.root, 0
        while m + bs <= len(prompt):
            child = node.children.get(tuple(prompt[m:m + bs]))
            if child is None:
                break
            node, m = child, m + bs
        return node, m

    def promote(self, prompt: list, rid: int | None = None) -> int:
        """Page the longest host-spilled continuation of ``prompt`` back
        into fresh pool blocks and trie nodes; returns blocks promoted.

        Gated on ``promote_ratio > 1`` (one block's host-link restore
        forecast faster than re-prefilling its tokens). Uses free blocks
        only, never evicts, and restores device content at once through
        ``promote_fn`` (one batched scatter for the chain). A chain cut
        short by pool exhaustion is still a valid, shorter prefix."""
        if (self.spill is None or self.promote_fn is None
                or not len(self.spill) or not self.promote_ratio > 1.0):
            return 0
        bs = self.block_size
        node, m = self._resident_frontier(prompt)
        chain = []                               # (key, block, snapshot)
        while m + bs <= len(prompt):
            key = tuple(prompt[:m + bs])
            if key not in self.spill:
                break
            try:
                blk = self.allocator.alloc(1)[0]
            except AllocatorError:
                break
            chain.append((key, blk, self.spill.take(key)))
            m += bs
        if not chain:
            return 0
        self.promote_fn([blk for _, blk, _ in chain],
                        [snap for _, _, snap in chain])
        for key, blk, _ in chain:
            self._nseq += 1
            child = TrieNode(key[-bs:], blk, node, self._nseq)
            child.last_used = self._clock
            node.children[child.key] = child
            node = child
            self.stats["nodes"] += 1
        self.stats["promoted_blocks"] += len(chain)
        self.stats["promoted_tokens"] += len(chain) * bs
        if self.obs.enabled:
            self.obs.trace.instant("prefix_promote", rid=rid,
                                   blocks=len(chain),
                                   tokens=len(chain) * bs)
        return len(chain)

    # ------------------------------------------------------------ stats ----

    def note_admitted(self, hit: int, prompt_len: int, cow: bool,
                      rid: int | None = None) -> None:
        """Admission-time accounting (``match`` has no stats side effect,
        so re-matching a blocked head does not inflate the hit rate)."""
        self.stats["requests"] += 1
        self.stats["prompt_tokens"] += prompt_len
        if hit:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += hit
            if self.obs.enabled:
                self.obs.trace.instant("prefix_hit", rid=rid,
                                       hit_tokens=hit,
                                       prompt_tokens=prompt_len,
                                       cow=int(cow))
        if cow:
            self.stats["cow_blocks"] += 1

    @property
    def hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from the cache."""
        tot = self.stats["prompt_tokens"]
        return self.stats["hit_tokens"] / tot if tot else 0.0

    @property
    def num_nodes(self) -> int:
        return self.stats["nodes"]
