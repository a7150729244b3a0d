"""The offline job a cell serves: one general generator over a traffic file.

A traffic file gives each length's log-normal (`log_mean`, `log_sigma`),
its clip (`min`, `max`) and its buckets.  A job of n requests takes the
log-normal's quantiles at (i + 1/2) / n, clipped and truncated to whole
tokens (as `alpaca_like_workload` truncates its draws), and pairs prompt
and output lengths by a fixed permutation (`pairing_seed`): a fixed sample
of the distribution, so every seed serves the same sizes.  The seed orders
them: requests are grouped by (prompt bucket, output bucket), each group
in a seeded order cut into batches of the cell's size (the last one
repeat-padded, as `token_batches` pads), and the batches of the job run in
a seeded order.  Token ids are uniform over 1 .. vocab - 1 and padded
with 0 past each prompt, as `repro_torch.data.token_batches` makes them
(its logic copied here, so the yardstick stays fixed).
"""

from __future__ import annotations

import dataclasses
import math
import statistics

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int          # index in the job's fixed sample of sizes
    tau_in: int
    tau_out: int


@dataclasses.dataclass
class Batch:
    """One generate: `tokens` [B, prompt] int32, the first len(requests)
    rows real, the rest repeat-padding."""
    prompt: int       # the prompt bucket: the batch's padded length
    steps: int        # the output bucket: tokens decoded for every row
    requests: list[Request]
    tokens: np.ndarray


def quantile_lengths(dist: dict, n: int) -> np.ndarray:
    nd = statistics.NormalDist(dist["log_mean"], dist["log_sigma"])
    x = np.array([math.exp(nd.inv_cdf((i + 0.5) / n)) for i in range(n)])
    return np.clip(x, dist["min"], dist["max"]).astype(int)


def sizes(traffic: dict, n: int) -> list[tuple[int, int]]:
    """The job's (τin, τout) pairs: the same for every seed."""
    tin = quantile_lengths(traffic["prompt"], n)
    tout = quantile_lengths(traffic["output"], n)
    perm = np.random.default_rng(traffic["pairing_seed"]).permutation(n)
    return [(int(a), int(b)) for a, b in zip(tin, tout[perm])]


def bucket(n: int, buckets: list[int]) -> int:
    for b in sorted(buckets):
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds the largest bucket {max(buckets)}")


def shapes(traffic: dict, n: int) -> list[tuple[int, int]]:
    """The (prompt bucket, output bucket) pairs a job of n requests runs."""
    return sorted({(bucket(a, traffic["prompt"]["buckets"]),
                    bucket(b, traffic["output"]["buckets"])) for a, b in sizes(traffic, n)})


def seed_words(seed: int) -> list[int]:
    """A whole-number seed of any size or sign as SeedSequence entropy."""
    seed %= 1 << 128
    return [(seed >> (32 * i)) & 0xFFFFFFFF for i in range(4)]


def job(traffic: dict, n: int, batch: int, vocab: int, seed: int, k: int) -> list[Batch]:
    """Job `k` of a run seeded `seed`: its batches in the order served."""
    rng = np.random.default_rng(seed_words(seed) + [k])
    reqs = [Request(i, a, b) for i, (a, b) in enumerate(sizes(traffic, n))]
    groups: dict[tuple[int, int], list[Request]] = {}
    for i in rng.permutation(n):
        r = reqs[i]
        key = (bucket(r.tau_in, traffic["prompt"]["buckets"]),
               bucket(r.tau_out, traffic["output"]["buckets"]))
        groups.setdefault(key, []).append(r)
    batches = []
    for (prompt, steps), rs in sorted(groups.items()):
        for i in range(0, len(rs), batch):
            chunk = rs[i:i + batch]
            lens = np.array([r.tau_in for r in chunk] + [chunk[-1].tau_in] * (batch - len(chunk)))
            toks = rng.integers(1, vocab, size=(batch, prompt), dtype=np.int64)
            toks = np.where(np.arange(prompt)[None, :] < lens[:, None], toks, 0)
            batches.append(Batch(prompt, steps, chunk, toks.astype(np.int32)))
    return [batches[i] for i in rng.permutation(len(batches))]
