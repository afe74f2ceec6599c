"""Symbol <-> integer-id table with the k2 text file format.

A copy of ``valle_tpu/utils/symbol_table.py``: the JAX package's
``valle_tpu.utils`` imports ``jax.numpy`` (``utils/common.py``), so the
port keeps its own host-side copy.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Generic, List, Optional, TypeVar, Union

Symbol = TypeVar("Symbol")


class SymbolTable(Generic[Symbol]):
    """Mapping between symbols and integer ids; one ``<symbol> <id>`` pair
    per line on disk (the reference's ``unique_text_tokens.k2symbols``)."""

    def __init__(self, sym2id: Optional[Dict[Symbol, int]] = None,
                 eps: Symbol = "<eps>") -> None:
        self._sym2id: Dict[Symbol, int] = {}
        self._id2sym: Dict[int, Symbol] = {}
        self.eps = eps
        if sym2id:
            for sym, idx in sym2id.items():
                self._check_and_insert(sym, idx)
        if eps is not None and eps not in self._sym2id:
            self._check_and_insert(eps, 0)

    def _check_and_insert(self, symbol: Symbol, index: int) -> None:
        if index in self._id2sym and self._id2sym[index] != symbol:
            raise ValueError(f"Duplicate id {index}: "
                             f"{self._id2sym[index]!r} vs {symbol!r}")
        if symbol in self._sym2id and self._sym2id[symbol] != index:
            raise ValueError(f"Duplicate symbol {symbol!r}: "
                             f"{self._sym2id[symbol]} vs {index}")
        self._sym2id[symbol] = index
        self._id2sym[index] = symbol

    @staticmethod
    def from_str(s: str) -> "SymbolTable":
        table = SymbolTable(eps=None)
        for line in s.splitlines():
            fields = line.split()
            if not fields:
                continue
            if len(fields) != 2:
                raise ValueError(f"Expect 'symbol id' per line, got: {line!r}")
            table._check_and_insert(fields[0], int(fields[1]))
        table.eps = "<eps>" if "<eps>" in table._sym2id else None
        return table

    @staticmethod
    def from_file(filename: Union[str, Path]) -> "SymbolTable":
        with open(filename, "r", encoding="utf-8") as f:
            return SymbolTable.from_str(f.read())

    def to_file(self, filename: Union[str, Path]) -> None:
        with open(filename, "w", encoding="utf-8") as f:
            for idx in sorted(self._id2sym):
                f.write(f"{self._id2sym[idx]} {idx}\n")

    def add(self, symbol: Symbol, index: Optional[int] = None) -> int:
        if symbol in self._sym2id:
            return self._sym2id[symbol]
        if index is None:
            index = (max(self._id2sym) + 1) if self._id2sym else 0
        self._check_and_insert(symbol, index)
        return index

    def merge(self, other: "SymbolTable") -> "SymbolTable":
        merged = SymbolTable(eps=None)
        for idx in sorted(self._id2sym):
            merged._check_and_insert(self._id2sym[idx], idx)
        for sym in other.symbols:
            if sym not in merged._sym2id:
                merged.add(sym)
        merged.eps = self.eps
        return merged

    def get(self, k: Union[int, Symbol]) -> Union[Symbol, int]:
        if isinstance(k, int):
            return self._id2sym[k]
        return self._sym2id[k]

    def __getitem__(self, k: Union[int, Symbol]) -> Union[Symbol, int]:
        return self.get(k)

    def __contains__(self, k: Union[int, Symbol]) -> bool:
        if isinstance(k, int):
            return k in self._id2sym
        return k in self._sym2id

    def __len__(self) -> int:
        return len(self._sym2id)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, SymbolTable):
            return NotImplemented
        return self._sym2id == other._sym2id

    @property
    def ids(self) -> List[int]:
        return sorted(self._id2sym)

    @property
    def symbols(self) -> List[Symbol]:
        return sorted(self._sym2id, key=self._sym2id.get)
