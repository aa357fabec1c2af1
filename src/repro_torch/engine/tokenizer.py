"""Self-contained byte-level tokenizer (FLOWSERVE's tokenizer module).

The paper treats the tokenizer as an independent, separately-scalable
module; ours is a deterministic byte-level codec with special tokens so
prefix-cache keys are stable across processes. Token ids: 0=PAD, 1=BOS,
2=EOS, 3..258 = bytes. Always fits every assigned vocab (min 32000).
"""
from __future__ import annotations

from typing import List

PAD_ID, BOS_ID, EOS_ID = 0, 1, 2
_BYTE_OFFSET = 3
VOCAB_FLOOR = 259


class ByteTokenizer:
    def __init__(self, vocab_size: int = VOCAB_FLOOR):
        assert vocab_size >= VOCAB_FLOOR, vocab_size
        self.vocab_size = vocab_size

    def encode(self, text: str, bos: bool = True) -> List[int]:
        ids = [b + _BYTE_OFFSET for b in text.encode("utf-8")]
        return ([BOS_ID] + ids) if bos else ids

    def decode(self, ids) -> str:
        bs = bytes(i - _BYTE_OFFSET for i in ids
                   if _BYTE_OFFSET <= i < _BYTE_OFFSET + 256)
        return bs.decode("utf-8", errors="replace")
