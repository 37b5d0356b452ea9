"""Deterministic, shardable, checkpointable synthetic data pipeline (a
copy of ``repro.data.pipeline``, numpy only: its batches are bit-equal to
the reference's at any (seed, step, shard)).

Counter-based generation (numpy Philox keyed on (seed, step, shard)) gives
the three properties a 1000-node training fleet needs from its input
pipeline, without any files on disk:

  * **determinism** — any (step, host) pair regenerates identical data, so a
    restarted/reshuffled job replays exactly;
  * **sharding** — each host draws only its ``global_batch / num_hosts``
    rows, keyed by shard id (no cross-host coordination);
  * **checkpointability** — pipeline state is ONE integer (the step),
    stored in the training checkpoint manifest.

The stream models packed LM documents: variable-length 'documents' (Zipf
token distribution) packed back-to-back with EOS separators, labels = next
token, -100 at padding.  Frontend (VLM/audio) archs get synthetic embedding
batches with the same determinism guarantees.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig

EOS = 0
IGNORE = -100


@dataclass
class PipelineState:
    step: int = 0

    def to_dict(self) -> Dict[str, int]:
        return {"step": self.step}

    @staticmethod
    def from_dict(d: Dict[str, int]) -> "PipelineState":
        return PipelineState(step=int(d.get("step", 0)))


class TokenPipeline:
    """Packed-document LM batches for one host shard."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *,
                 seed: int = 0, num_shards: int = 1, shard_id: int = 0,
                 mean_doc_len: int = 512):
        if shape.global_batch % num_shards:
            raise ValueError(
                f"global batch {shape.global_batch} % shards {num_shards}")
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.local_batch = shape.global_batch // num_shards
        self.mean_doc_len = mean_doc_len
        self.state = PipelineState()

    # ------------------------------------------------------------------ #
    @staticmethod
    def _splitmix64(x: int) -> int:
        """Diffuse a counter into 64 well-mixed bits (numpy's Philox keying
        is insensitive to low-bit differences in the raw key words)."""
        x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        z = x
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        return z ^ (z >> 31)

    def _rng(self, step: int) -> np.random.Generator:
        base = (self.seed << 40) ^ (step << 16) ^ self.shard_id
        key = [self._splitmix64(base), self._splitmix64(base ^ 0xda7a)]
        return np.random.Generator(np.random.Philox(key=key))

    def _pack_row(self, rng: np.random.Generator, seq: int) -> np.ndarray:
        row = np.empty(seq + 1, dtype=np.int32)
        pos = 0
        v = self.cfg.vocab_size
        while pos <= seq:
            n = max(8, int(rng.exponential(self.mean_doc_len)))
            n = min(n, seq + 1 - pos)
            # Zipf-ish marginal over the vocab, offset past EOS.
            doc = rng.zipf(1.3, size=n).astype(np.int64)
            row[pos:pos + n] = (doc % (v - 1)) + 1
            pos += n
            if pos <= seq:
                row[pos - 1] = EOS
        return row

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Materialize this shard's batch for an absolute step (pure)."""
        rng = self._rng(step)
        seq = self.shape.seq_len
        rows = np.stack([self._pack_row(rng, seq)
                         for _ in range(self.local_batch)])
        batch = {"tokens": rows[:, :-1].astype(np.int32),
                 "labels": rows[:, 1:].astype(np.int32)}
        if self.cfg.frontend != "none":
            emb = self._rng(step ^ 0x5eed).standard_normal(
                (self.local_batch, seq, self.cfg.d_model),
                dtype=np.float32) * 0.1
            batch = {"embeds": emb, "labels": batch["labels"]}
        if self.cfg.rope == "mrope":
            base = np.broadcast_to(np.arange(seq, dtype=np.int32),
                                   (self.local_batch, seq))
            batch["positions"] = np.broadcast_to(
                base[None], (3, self.local_batch, seq)).copy()
        return batch

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    # --------------------------------------------------------- checkpoint
    def state_dict(self) -> Dict[str, int]:
        return self.state.to_dict()

    def load_state_dict(self, d: Dict[str, int]) -> None:
        self.state = PipelineState.from_dict(d)
