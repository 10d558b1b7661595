"""Speculative decoding (twin of ``repro.spec``).

A proposer guesses up to k tokens per decoding slot, ONE verify pass
(``repro_torch.models.api.verify_fn``) scores every slot's window
against the paged KV, and the accept rule emits between 1 and k + 1
tokens per slot: greedy streams are the non-speculative greedy streams,
and sampled streams stay keyed on the request's (seed, emit index), with
the emitted marginal exactly the target distribution.

  propose  — prompt-lookup n-gram proposer and a draft-model proposer
             with its own paged KV cache (greedy or keyed sampled drafts)
  verify   — fixed-shape window packing for the verify pass
  sampler  — the greedy accept rule and keyed exact rejection sampling

The engine is ``repro_torch.serving.engine.SpecDecodeEngine``.
"""

from repro_torch.spec import sampler
from repro_torch.spec.propose import DraftModelProposer, NGramProposer, \
    Proposer
from repro_torch.spec.sampler import greedy_verify, rejection_sample, \
    target_dist
from repro_torch.spec.verify import pack_windows

__all__ = ["DraftModelProposer", "NGramProposer", "Proposer", "sampler",
           "greedy_verify", "rejection_sample", "target_dist",
           "pack_windows"]
