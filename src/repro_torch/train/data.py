"""Deterministic synthetic LM data pipeline (a copy of
``repro.train.data``; numpy only, so batches are bitwise the reference's).

Batches are generated from a counter-based RNG keyed on (seed, step, shard),
which gives the two properties a 1000-node deployment needs:

* **Restart determinism** — after a checkpoint restore at step k, batch k+1 is
  bit-identical to what it would have been without the failure.
* **Elastic resharding** — the global batch for a step does not depend on how
  many hosts produce it; each host slices [host_id * per_host, ...) from the
  same logical batch.

The "corpus" is a Zipfian token stream with a deterministic shift pattern so
the LM has actual structure to learn.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.config import ModelConfig


class SyntheticLM:
    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0,
                 structured: bool = True):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.structured = structured
        # Zipf-ish stationary distribution over the vocab
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._probs = (1.0 / ranks**1.1)
        self._probs /= self._probs.sum()

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self.seed, step]))

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        K = self.cfg.n_codebooks
        shape = (self.batch, self.seq_len + 1)
        if K > 1:
            shape = shape + (K,)
        toks = rng.choice(len(self._probs), size=shape, p=self._probs).astype(np.int32)
        if self.structured:
            # make token t+1 depend on token t: x[t+1] = (x[t] + delta) % v for
            # a patterned subset of positions -> learnable structure
            v = self.cfg.vocab_size
            idx = np.arange(1, self.seq_len + 1)
            mask = (idx % 2) == 0
            if K > 1:
                toks[:, idx[mask]] = (toks[:, idx[mask] - 1] + 7) % v
            else:
                toks[:, idx[mask]] = (toks[:, idx[mask] - 1] + 7) % v
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.n_prefix:
            batch["vision_embeds"] = rng.standard_normal(
                (self.batch, self.cfg.n_prefix, self.cfg.d_model)).astype(np.float32)
        return batch

    def host_batch(self, step: int, host_id: int = 0, n_hosts: int = 1
                   ) -> Dict[str, np.ndarray]:
        g = self.global_batch(step)
        per = self.batch // n_hosts
        lo, hi = host_id * per, (host_id + 1) * per
        return {k: v[lo:hi] for k, v in g.items()}
