"""Data pipeline for fine-tune jobs: tokenize -> pack -> shard (a numpy
copy of ``repro/data/pipeline.py`` on the port's own tokenizer; its
batches equal the reference's exactly).

A deterministic synthetic corpus (seeded), documents packed into fixed
seq_len + 1 windows with EOS separators, sharded by data-parallel rank so
ranks read disjoint streams. On a real cluster the source would be a file
list; the pipeline's interface is the same."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.engine.tokenizer import EOS_ID, ByteTokenizer


@dataclass
class DataConfig:
    seq_len: int = 128
    batch_size: int = 8
    seed: int = 0
    n_docs: int = 2048
    dp_rank: int = 0
    dp_size: int = 1


_WORDS = ("serve scale pod engine cache prefill decode token flow tensor "
          "schedule cluster shard expert attention state page fork warm dram "
          "npu link transfer batch queue master executor radix prefix").split()


def synthetic_corpus(cfg: DataConfig) -> Iterator[str]:
    rng = np.random.RandomState(cfg.seed)
    for i in range(cfg.n_docs):
        n = rng.randint(8, 64)
        words = [_WORDS[rng.randint(len(_WORDS))] for _ in range(n)]
        yield f"doc{i}: " + " ".join(words) + "."


class PackedDataset:
    """Packs tokenized docs into (batch, seq_len + 1) windows; iterating
    yields (tokens, targets, mask) numpy arrays for the train step."""

    def __init__(self, cfg: DataConfig,
                 tokenizer: Optional[ByteTokenizer] = None,
                 docs: Optional[List[str]] = None):
        self.cfg = cfg
        tok = tokenizer or ByteTokenizer()
        stream: List[int] = []
        for i, doc in enumerate(docs if docs is not None
                                else synthetic_corpus(cfg)):
            if i % cfg.dp_size != cfg.dp_rank:
                continue                         # another rank's shard
            stream.extend(tok.encode(doc) + [EOS_ID])
        window = cfg.seq_len + 1
        n_win = len(stream) // window
        self.windows = np.asarray(stream[: n_win * window],
                                  np.int32).reshape(n_win, window)

    def __len__(self) -> int:
        return len(self.windows) // self.cfg.batch_size

    def batches(self, epochs: int = 1
                ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        rng = np.random.RandomState(self.cfg.seed + 1)
        for _ in range(epochs):
            order = rng.permutation(len(self.windows))
            bs = self.cfg.batch_size
            for i in range(len(self.windows) // bs):
                w = self.windows[order[i * bs:(i + 1) * bs]]
                tokens, targets = w[:, :-1], w[:, 1:]
                mask = (targets != 0).astype(np.float32)
                yield tokens, targets, mask
