"""Speculative decoding (twin of ``repro.spec``), greedy requests only.

A proposer guesses up to k tokens per decoding slot, ONE verify pass
(``repro_torch.models.api.verify_fn``) scores every slot's window
against the paged KV, and the greedy accept rule emits between 1 and
k + 1 tokens per slot: the stream is the non-speculative greedy stream.

  propose  — prompt-lookup n-gram proposer and a draft-model proposer
             with its own paged KV cache
  verify   — fixed-shape window packing for the verify pass
  sampler  — the greedy accept rule

The engine is ``repro_torch.serving.engine.SpecDecodeEngine``. Sampled
requests (``rejection_sample`` and keyed drafting) wait for ROADMAP
queue A item 4.
"""

from repro_torch.spec.propose import DraftModelProposer, NGramProposer, \
    Proposer
from repro_torch.spec.sampler import greedy_verify
from repro_torch.spec.verify import pack_windows

__all__ = ["DraftModelProposer", "NGramProposer", "Proposer",
           "greedy_verify", "pack_windows"]
