"""Paged-KV serving (twin of ``repro.serving``): continuous batching over
shared block pools, chunked prefill, speculative decoding, sampling,
prefix caching with session KV, preemption to host and the
fault-tolerance layer (typed failures, numerics guard, keyed fault
injection, failover to a degraded engine).

  engine       — refcounting ``BlockAllocator``, strict-FIFO
                 ``Scheduler``, ``DecodeEngine`` and the draft -> verify
                 -> accept ``SpecDecodeEngine``
  prefix_cache — the block-granular radix trie (``PrefixCache``):
                 shared-prefix hits, copy-on-write, LRU eviction and
                 promotion from the spill tier
  swap         — host-memory tiers: ``KVSwap`` (preemption snapshots) and
                 ``PrefixSpill`` (evicted trie blocks)
  faults       — typed recoverable exceptions, the per-step logit
                 ``NumericsGuard``, the keyed ``FaultInjector`` and the
                 degraded-retry ``FailoverServer``
"""

from repro_torch.serving.engine import (BlockAllocator, DecodeEngine,
                                        Request, Scheduler,
                                        SpecDecodeEngine)
from repro_torch.serving.faults import (AdmissionError, AllocatorError,
                                        FailoverServer, FaultInjector,
                                        FaultSpec, NumericsGuard,
                                        ProposerStallError, ServingError,
                                        StallError, SwapMissError,
                                        degraded_engine)
from repro_torch.serving.prefix_cache import (PrefixCache, PrefixMatch,
                                              TrieNode)
from repro_torch.serving.swap import KVSwap, PrefixSpill

__all__ = ["BlockAllocator", "DecodeEngine", "Request", "Scheduler",
           "SpecDecodeEngine", "AdmissionError", "AllocatorError",
           "FailoverServer", "FaultInjector", "FaultSpec", "NumericsGuard",
           "ProposerStallError", "ServingError", "StallError",
           "SwapMissError", "degraded_engine", "PrefixCache",
           "PrefixMatch", "TrieNode", "KVSwap", "PrefixSpill"]
