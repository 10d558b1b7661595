"""Paged-KV serving (twin of ``repro.serving``): continuous batching over
shared block pools, chunked prefill, speculative decoding, sampling and
the fault-tolerance layer (typed failures, numerics guard, keyed fault
injection, failover to a degraded engine).

  engine  — refcounting ``BlockAllocator``, strict-FIFO ``Scheduler``,
            ``DecodeEngine`` and the draft -> verify -> accept
            ``SpecDecodeEngine``
  faults  — typed recoverable exceptions, the per-step logit
            ``NumericsGuard``, the keyed ``FaultInjector`` and the
            degraded-retry ``FailoverServer``

Prefix caching and the host swap tier (``prefix_cache``, ``swap``,
``SwapMissError``) wait for ROADMAP queue A item 7.
"""

from repro_torch.serving.engine import (BlockAllocator, DecodeEngine,
                                        Request, Scheduler,
                                        SpecDecodeEngine)
from repro_torch.serving.faults import (AdmissionError, AllocatorError,
                                        FailoverServer, FaultInjector,
                                        FaultSpec, NumericsGuard,
                                        ProposerStallError, ServingError,
                                        StallError, degraded_engine)

__all__ = ["BlockAllocator", "DecodeEngine", "Request", "Scheduler",
           "SpecDecodeEngine", "AdmissionError", "AllocatorError",
           "FailoverServer", "FaultInjector", "FaultSpec", "NumericsGuard",
           "ProposerStallError", "ServingError", "StallError",
           "degraded_engine"]
