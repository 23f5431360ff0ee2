"""Port bitmap. Reference: nomad/structs/bitmap.go:6.

Backed by a Python int used as a bitset — set/check are O(1) amortized
and the TPU path summarizes these into dense per-node availability
counts anyway (see models/matrix.py).
"""

from __future__ import annotations

from typing import List


class Bitmap:
    __slots__ = ("size", "_bits")

    def __init__(self, size: int):
        if size <= 0:
            raise ValueError("bitmap size must be positive")
        self.size = size
        self._bits = 0

    def set(self, idx: int) -> None:
        self._bits |= 1 << idx

    def check(self, idx: int) -> bool:
        return bool(self._bits >> idx & 1)

    def clear(self) -> None:
        self._bits = 0

    def copy(self) -> "Bitmap":
        b = Bitmap(self.size)
        b._bits = self._bits
        return b

    def indexes_in_range(self, set_value: bool, lo: int, hi: int) -> List[int]:
        """All indexes in [lo, hi] whose bit equals set_value."""
        out = []
        bits = self._bits
        for i in range(lo, min(hi, self.size - 1) + 1):
            if bool(bits >> i & 1) == set_value:
                out.append(i)
        return out
