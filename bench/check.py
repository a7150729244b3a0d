"""The comparison that decides `correct`.

After the window, a sample of the requests it finished, drawn from the
seed with the longest (most output tokens, then the longest prompt) in
it, is run through the plain reference once each: the prompt row as the
engine served it (padded to its bucket) followed by the request's served
tokens.  A served token's gap is the amount by which its reference logit lies
below the reference's best logit at that position.  `widest_gap` is the
largest over every served token of the sample, `mean_gap` their mean; a
cell's file names the numbers it compares and their limits.  The served
tokens are greedy, so a sound program reads only rounding.

The control puts the reference computed in float8 in the program's place:
at each position of the same sequences it takes the token the float8
pass ranks first and reads the reference's gaps for those tokens.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.measure import Run, Served
from bench.traffic import seed_words

CHECK_STREAM = 7          # the sample's draw, apart from the jobs' streams


def sample(run: Run, n: int, seed: int) -> list[tuple[Served, int, object]]:
    """The longest request and n - 1 others drawn from `seed`."""
    reqs = list(run.requests())
    longest = max(range(len(reqs)), key=lambda i: (reqs[i][2].tau_out, reqs[i][2].tau_in))
    rest = [i for i in range(len(reqs)) if i != longest]
    rng = np.random.default_rng(seed_words(seed) + [CHECK_STREAM])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [reqs[longest]] + [reqs[rest[i]] for i in sorted(pick)]


def sequences(picked) -> tuple[list[np.ndarray], list[int], list[np.ndarray]]:
    """(token sequences, first scored position, served tokens) of each
    sampled request: the logits at positions first .. first + τout - 1
    pick its τout served tokens."""
    seqs, first, served = [], [], []
    for s, row, r in picked:
        toks = s.out[row, :r.tau_out]
        seqs.append(np.concatenate([s.batch.tokens[row], toks[:-1]]))
        first.append(s.batch.prompt - 1)
        served.append(toks)
    return seqs, first, served


def gaps(ref: list[torch.Tensor], served: list[np.ndarray]) -> np.ndarray:
    """Each served token's gap: the reference's best logit at its position
    less the reference's logit of the served token."""
    out = []
    for lg, tok in zip(ref, served):
        t = torch.as_tensor(tok, dtype=torch.long, device=lg.device)
        out.append((lg.max(-1).values - lg.gather(-1, t[:, None])[:, 0]).cpu().numpy())
    return np.concatenate(out)


def numbers(ref: list[torch.Tensor], served: list[np.ndarray]) -> dict:
    """The numbers a cell may compare: the widest gap and the mean gap."""
    g = gaps(ref, served)
    return {"widest_gap": float(g.max()), "mean_gap": float(g.mean())}


def control_numbers(ref: list[torch.Tensor], ctl: list[torch.Tensor]) -> dict:
    """The same numbers for the tokens the control ranks first."""
    return numbers(ref, [c.argmax(-1).cpu().numpy() for c in ctl])
