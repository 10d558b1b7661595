"""Host-memory tiers for paged KV blocks: preemption snapshots and the
session prefix spill tier (twin of ``repro.serving.swap``).

Preemption to host (``KVSwap``): under pool pressure the scheduler can
preempt a decoding request instead of letting the FIFO head wait. The
victim's blocks, every pool leaf (quantized payloads and their scale
tiles alike, ``paged.extract_blocks``), are copied to host memory
(pinned when the pool is on the card), the blocks are released and the
slot is freed. When capacity returns the request is re-admitted into
fresh blocks (their ids need not match: content is addressed through
the slot's table), the snapshot is scattered back
(``paged.restore_blocks``), the slot's cached length returns to
``prefill_pos + emitted - 1`` (the last emitted token waits in the
engine's next-token buffer, not in the cache) and decoding resumes.
Every byte the request computed comes back, and the decode step runs
all ``max_slots`` rows whichever slots are live, so the continuation is
bitwise its never-preempted run.

Session prefix spill (``PrefixSpill``): the same host copies applied to
the prefix cache's evicted trie nodes. With the tier armed,
``PrefixCache.evict`` snapshots each victim block into this LRU-bounded
host store keyed by the node's trie path (the full token prefix it
encodes), and ``PrefixCache.promote`` can page a host-resident
continuation back into fresh pool blocks when the restore-vs-reprefill
forecast (``repro_torch.ecm.hopper.predicted_restore_vs_reprefill``)
says the host-link copy beats re-running prefill.

Both tiers raise a typed ``SwapMissError`` when asked about a request
id or trie path they do not hold, lookups and drops alike, so a lost
snapshot surfaces as a typed failure instead of a silent no-op.
"""

from __future__ import annotations

from collections import OrderedDict

from repro_torch import obs
from repro_torch.models import paged
from repro_torch.serving.faults import SwapMissError


class KVSwap:
    """Host-memory tier for preempted requests' KV blocks.

    One snapshot per request id: ``swap_out`` gathers the listed blocks of
    every pool leaf to host tensors, ``swap_in`` scatters them back into
    (possibly different) blocks and forgets the snapshot, ``drop`` forgets
    it without restoring (cancellation or expiry while preempted).
    ``swap_in`` and ``drop`` of an id with no snapshot both raise
    ``SwapMissError`` (callers that may race a teardown check ``holds``
    first)."""

    def __init__(self):
        self._store: dict[int, dict] = {}
        self._nblocks: dict[int, int] = {}
        # host_bytes is the current residency (it drops on swap_in and
        # drop); host_bytes_total is all swap-out traffic, and
        # restored_bytes_total all swap-in traffic
        self.stats = {"swapped_out_blocks": 0, "restored_blocks": 0,
                      "dropped_blocks": 0, "host_bytes": 0,
                      "host_bytes_total": 0, "restored_bytes_total": 0}
        self.obs = obs.NULL          # the owning engine's telemetry

    def __len__(self) -> int:
        return len(self._store)

    def holds(self, rid: int) -> bool:
        return rid in self._store

    def swap_out(self, rid: int, caches: dict, blocks: list[int]) -> None:
        if rid in self._store:
            raise AssertionError(f"request {rid} already swapped out")
        snap = paged.extract_blocks(caches, blocks)
        self._store[rid] = snap
        self._nblocks[rid] = len(blocks)
        nbytes = paged.snapshot_bytes(snap)
        self.stats["swapped_out_blocks"] += len(blocks)
        self.stats["host_bytes"] += nbytes
        self.stats["host_bytes_total"] += nbytes
        if self.obs.enabled:
            self.obs.trace.instant("swap_out", rid=rid, blocks=len(blocks))

    def swap_in(self, rid: int, caches: dict, blocks: list[int]) -> None:
        """Restore ``rid``'s snapshot into ``blocks`` (same count, any
        ids), in place. Raises ``SwapMissError`` when no snapshot is held
        for ``rid``."""
        if rid not in self._store:
            raise SwapMissError(
                f"swap_in: no host snapshot held for request {rid}")
        n = self._nblocks[rid]
        if len(blocks) != n:
            raise AssertionError(
                f"request {rid}: snapshot holds {n} blocks, restore "
                f"offered {len(blocks)}")
        snap = self._store.pop(rid)
        del self._nblocks[rid]
        nbytes = paged.snapshot_bytes(snap)
        self.stats["restored_blocks"] += n
        self.stats["host_bytes"] -= nbytes
        self.stats["restored_bytes_total"] += nbytes
        if self.obs.enabled:
            self.obs.trace.instant("swap_in", rid=rid, blocks=n)
        paged.restore_blocks(caches, blocks, snap)

    def drop(self, rid: int) -> None:
        """Forget ``rid``'s snapshot without restoring. Raises
        ``SwapMissError`` for an unknown id, symmetric with ``swap_in``."""
        if rid not in self._store:
            raise SwapMissError(
                f"drop: no host snapshot held for request {rid}")
        snap = self._store.pop(rid)
        n = self._nblocks.pop(rid)
        self.stats["dropped_blocks"] += n
        self.stats["host_bytes"] -= paged.snapshot_bytes(snap)
        if self.obs.enabled:
            self.obs.trace.instant("swap_drop", rid=rid, blocks=n)


class PrefixSpill:
    """LRU-bounded host tier for evicted prefix-cache blocks, keyed by
    trie path.

    One entry per evicted trie node: the key is the node's full token
    prefix (root -> node, a whole number of blocks), the value the host
    snapshot of its one pool block across every pool leaf. ``put`` runs
    inside ``PrefixCache.evict`` (spill instead of drop); ``take`` hands
    the snapshot to ``PrefixCache.promote`` for the device restore into
    a freshly allocated block. ``capacity`` bounds the residency in
    blocks: an over-capacity ``put`` drops the least recently spilled
    entry for real (counted: the only place session KV still loses
    computed work).

    Content is position-independent (table-addressed, like ``KVSwap``
    snapshots), so a promote may land in any free block and is bitwise
    the snapshot. Re-spilling a resident key overwrites it with the
    newer block. The two need not be bitwise equal: a path's block may
    have been written by a prefill or by decode / verify steps, and the
    port's decode formulation (the paged-attention kernel) does not
    round like its prefill formulation (flash attention in torch ops),
    so only the tokens the path spells are the same.
    """

    def __init__(self, capacity: int, snapshot_fn):
        if capacity <= 0:
            raise ValueError("spill tier needs a positive block capacity")
        self.capacity = capacity
        self._snapshot_fn = snapshot_fn      # blocks -> {leaf: tensor}
        self._store: OrderedDict[tuple, dict] = OrderedDict()
        self._nbytes: dict[tuple, int] = {}
        # host_bytes is the current residency; *_total are cumulative
        # traffic (spilled: device -> host, promoted: host -> device)
        self.stats = {"spilled_blocks": 0, "promoted_blocks": 0,
                      "dropped_blocks": 0, "host_bytes": 0,
                      "spilled_bytes_total": 0, "promoted_bytes_total": 0}
        self.obs = obs.NULL          # the owning engine's telemetry

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: tuple) -> bool:
        return key in self._store

    def put(self, key: tuple, block: int) -> None:
        """Snapshot ``block`` to host memory under ``key``, dropping the
        least recently spilled entry if over capacity."""
        if key in self._store:
            # the newer block replaces the resident one; residency exact
            self._store.pop(key)
            self.stats["host_bytes"] -= self._nbytes.pop(key)
        snap = self._snapshot_fn([block])
        nbytes = paged.snapshot_bytes(snap)
        self._store[key] = snap
        self._nbytes[key] = nbytes
        self.stats["spilled_blocks"] += 1
        self.stats["host_bytes"] += nbytes
        self.stats["spilled_bytes_total"] += nbytes
        if self.obs.enabled:
            self.obs.trace.instant("prefix_spill", tokens=len(key),
                                   resident_blocks=len(self._store))
        while len(self._store) > self.capacity:
            old, _ = self._store.popitem(last=False)
            self.stats["host_bytes"] -= self._nbytes.pop(old)
            self.stats["dropped_blocks"] += 1

    def take(self, key: tuple) -> dict:
        """Remove and return the snapshot for ``key`` (the caller owns the
        device restore). Raises ``SwapMissError`` for an unknown key."""
        if key not in self._store:
            raise SwapMissError(
                f"prefix spill tier holds no snapshot for a "
                f"{len(key)}-token path")
        snap = self._store.pop(key)
        nbytes = self._nbytes.pop(key)
        self.stats["promoted_blocks"] += 1
        self.stats["host_bytes"] -= nbytes
        self.stats["promoted_bytes_total"] += nbytes
        return snap
