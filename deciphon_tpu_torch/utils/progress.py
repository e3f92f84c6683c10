"""Batched work-progress meter.

Mirrors the reference's lock-minimizing progress meter semantics
(src/core/progress.c:256-294): work is consumed in raw units against a
total, but the callback only fires when at least one *meter* unit (default
1/100 of the total) has been crossed — so scheduler PATCHes happen ~100
times per job, not once per (seq, profile).
"""

from __future__ import annotations

from typing import Callable


class Progress:
    def __init__(
        self,
        total: int,
        units: int = 100,
        callback: Callable[[int], None] | None = None,
    ):
        self.total = max(1, int(total))
        self.units = units
        self.callback = callback
        self.consumed = 0
        self._reported = 0

    def consume(self, n: int) -> None:
        self.consumed = min(self.total, self.consumed + int(n))
        done_units = (self.consumed * self.units) // self.total
        if done_units > self._reported:
            inc = done_units - self._reported
            self._reported = done_units
            if self.callback:
                self.callback(inc)

    def finish(self) -> None:
        """Flush any unreported remainder (progress_finishup)."""
        if self.consumed < self.total:
            self.consume(self.total - self.consumed)
        elif self._reported < self.units:
            inc = self.units - self._reported
            self._reported = self.units
            if self.callback:
                self.callback(inc)
