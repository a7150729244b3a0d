"""Port copy of `repro.serving.requests`, numpy only, with its imports renamed;
tests/test_torch_serve.py holds it to the reference.

Request/response objects for the serving path."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Request:
    request_id: int
    tokens: np.ndarray          # [tau_in] int32 prompt
    max_new_tokens: int
    model: str | None = None    # filled by the router

    @property
    def tau_in(self) -> int:
        return int(len(self.tokens))


@dataclasses.dataclass
class Response:
    request_id: int
    model: str
    tokens: np.ndarray          # generated ids
    prefill_s: float
    decode_s: float
    energy_j: float             # metered (real or modeled)

    @property
    def tau_out(self) -> int:
        return int(len(self.tokens))

    @property
    def runtime_s(self) -> float:
        return self.prefill_s + self.decode_s
