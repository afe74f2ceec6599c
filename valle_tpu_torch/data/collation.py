"""Text token collation: symbols -> padded int batches.

A host-side copy of ``valle_tpu/data/collation.py`` (which reaches
``jax`` through ``valle_tpu.utils``). Vocabulary layout is
``<pad>=0, <bos>, <eos>`` followed by the sorted symbols; ``index``
returns (B, L) int64 ids and lengths that include bos/eos.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np

from ..utils.symbol_table import SymbolTable


class TextTokenCollater:
    def __init__(self, text_tokens: List[str], add_eos: bool = True,
                 add_bos: bool = True, pad_symbol: str = "<pad>",
                 bos_symbol: str = "<bos>", eos_symbol: str = "<eos>"):
        self.pad_symbol = pad_symbol
        self.add_eos = add_eos
        self.add_bos = add_bos
        self.bos_symbol = bos_symbol
        self.eos_symbol = eos_symbol
        unique_tokens = (
            [pad_symbol]
            + ([bos_symbol] if add_bos else [])
            + ([eos_symbol] if add_eos else [])
            + sorted(text_tokens)
        )
        self.token2idx = {t: i for i, t in enumerate(unique_tokens)}
        self.idx2token = list(unique_tokens)

    @property
    def vocab_size(self) -> int:
        return len(self.idx2token)

    def index(self, tokens_list: List[List[str]],
              pad_to: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        seqs, seq_lens = [], []
        for tokens in tokens_list:
            missing = [s for s in tokens if s not in self.token2idx]
            assert not missing, f"tokens not in vocabulary: {missing[:5]}"
            seq = (([self.bos_symbol] if self.add_bos else [])
                   + list(tokens)
                   + ([self.eos_symbol] if self.add_eos else []))
            seqs.append(seq)
            seq_lens.append(len(seq))
        max_len = max(max(seq_lens), pad_to)
        for seq, n in zip(seqs, seq_lens):
            seq.extend([self.pad_symbol] * (max_len - n))
        tokens = np.array([[self.token2idx[t] for t in seq] for seq in seqs],
                          dtype=np.int64)
        return tokens, np.array(seq_lens, dtype=np.int32)

    def __call__(self, texts: List[str],
                 pad_to: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        return self.index([[p for p in text] for text in texts],
                          pad_to=pad_to)


def get_text_token_collater(text_tokens_file: str) -> TextTokenCollater:
    unique_tokens = SymbolTable.from_file(Path(text_tokens_file))
    return TextTokenCollater(unique_tokens.symbols, add_bos=True,
                             add_eos=True)
