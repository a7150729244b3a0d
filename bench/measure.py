"""What a run recorded, and the counts the metric readers take from it.

A `Served` batch keeps the host clock's (start, end) of each step the
engine ran, as the harness's step meter saw them: the prefill first, then
one decode step a generated token, each ended by a device synchronise.
Token j of a row is ready at the end of step j (the prefill's logits give
token 0).  Only the rows of real requests and only each request's own τout
tokens count as served; padding rows and the tokens decoded past a
request's τout cost time and count nothing.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bench import flops
from bench.spec import Cell
from bench.traffic import Batch


@dataclasses.dataclass
class Served:
    batch: Batch
    out: np.ndarray                      # [B, steps] tokens the engine returned
    walls: list[tuple[float, float]]     # (start, end) of the prefill, then each decode step

    @property
    def prefill_s(self) -> float:
        return self.walls[0][1] - self.walls[0][0]

    @property
    def decode_s(self) -> list[float]:
        return [b - a for a, b in self.walls[1:]]

    @property
    def ends(self) -> np.ndarray:
        return np.array([b for _, b in self.walls])


@dataclasses.dataclass
class Run:
    cell: Cell
    served: list[Served]                 # the measured window's batches
    window_s: float                      # host clock, window open to the last step's end
    setup_s: float
    capture_s: float                     # the engine's warm-ups and captures
    joules: float | None = None          # the card's counter over the energy window
    energy_s: float | None = None        # the energy window's length
    trace: dict | None = None            # `devtrace.reduce` of the traced span
    traced: list[Served] = dataclasses.field(default_factory=list)

    @property
    def spec(self):
        return self.cell.spec

    def requests(self):
        """(served batch, row, request) of every request the window finished."""
        for s in self.served:
            for row, r in enumerate(s.batch.requests):
                yield s, row, r

    def out_tokens(self) -> int:
        return sum(r.tau_out for _, _, r in self.requests())

    def gaps(self) -> np.ndarray:
        """Every inter-token gap of every request: ends[j] - ends[j-1] for
        its tokens j = 1 .. τout - 1."""
        out = []
        for s in self.served:
            d = np.diff(s.ends)
            for r in s.batch.requests:
                out.append(d[:r.tau_out - 1])
        return np.concatenate(out) if out else np.zeros(0)

    def summary(self) -> str:
        """One line on the window's batches, for the run's standard error:
        each batch's shape and mean decode step."""
        parts = [f"{s.batch.prompt}x{s.batch.steps}:{np.mean(s.decode_s) * 1e3:.2f}"
                 for s in self.served]
        return (f"window {self.window_s:.3f} s, {len(self.served)} batches, "
                f"{self.out_tokens()} tokens; decode ms a batch " + " ".join(parts))

    def useful_flops(self) -> int:
        return sum(flops.request_flops(self.spec, r.tau_in, r.tau_out)
                   for _, _, r in self.requests())
