"""What a per-layer metric's reader sees of a traced run."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..roofline import work as W
from .trace import TraceSummary


@dataclass
class LayerView:
    shapes: W.Shapes
    B: int                     # slots
    M: int                     # block: rows per slot per decode step
    page: int
    table_cols: int            # a page table row's entries
    segments: list             # spans inside the window
    prefills: list
    trace: Optional[TraceSummary] = None
    _work: Optional[W.Work] = field(default=None, repr=False)

    @property
    def traced_segments(self) -> List:
        return [s for s in self.segments if s.traced]

    @property
    def traced_prefills(self) -> List:
        return [p for p in self.prefills if p.traced]

    @property
    def traced_work(self) -> W.Work:
        """The work of the traced sub-window's forwards."""
        if self._work is None:
            w = W.Work()
            for s in self.traced_segments:
                W.add_segment(w, self.shapes, self.M, self.page,
                              self.table_cols, s)
            for p in self.traced_prefills:
                W.add_prefill(w, self.shapes, p.tokens)
            self._work = w
        return self._work
