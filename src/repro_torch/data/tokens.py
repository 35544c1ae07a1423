"""Synthetic LM data pipeline (numpy only: the reference's
``data/tokens.py`` as it is, so both packages draw the same batches).

Deterministic, shardable, restart-safe: batch contents are a pure function
of (seed, step, shard), so a restarted job regenerates exactly the batches
it would have seen — the data-side half of fault tolerance (no data-loader
checkpoint needed).

The stream is a learnable-structure synthetic corpus: an order-1 Markov
chain over a Zipf-distributed vocabulary (models can actually reduce loss
on it, unlike uniform noise), built per-seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from ..configs.base import ArchConfig


@dataclass
class SyntheticLM:
    cfg: ArchConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    n_states: int = 64  # Markov states (kept small so structure is learnable)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.cfg.vocab_size
        # Zipf unigram over the vocab, shared across states
        ranks = np.arange(1, v + 1, dtype=np.float64)
        base = ranks ** -1.1
        base /= base.sum()
        # each Markov state skews toward a band of the vocabulary
        self.state_bias = rng.integers(0, v, self.n_states)
        self.base = base
        self.trans = rng.integers(0, self.n_states, (self.n_states, 8)).astype(np.int64)

    def _tokens(self, step: int, shard: int, shards: int) -> np.ndarray:
        b_local = self.global_batch // shards
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard
        )
        v = self.cfg.vocab_size
        out = np.empty((b_local, self.seq_len + 1), np.int32)
        state = rng.integers(0, self.n_states, b_local)
        for t in range(self.seq_len + 1):
            # banded zipf: shift the distribution by the state bias
            u = rng.random(b_local)
            # inverse-cdf sampling on the shared base via searchsorted
            cdf = np.cumsum(self.base)
            tok = np.searchsorted(cdf, u)
            out[:, t] = (tok + self.state_bias[state]) % v
            state = self.trans[state, rng.integers(0, 8, b_local)]
        return out

    def batch(self, step: int, shard: int = 0, shards: int = 1) -> Dict[str, np.ndarray]:
        toks = self._tokens(step, shard, shards)
        if self.cfg.frontend != "none":
            # modality frontend stub: deterministic pseudo-embeddings + labels
            rng = np.random.default_rng(self.seed * 7 + step)
            b_local = self.global_batch // shards
            emb = rng.standard_normal(
                (b_local, self.seq_len, self.cfg.d_model)
            ).astype(np.float32)
            return {"embeds": emb, "labels": toks[:, 1:] % self.cfg.vocab_size}
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
