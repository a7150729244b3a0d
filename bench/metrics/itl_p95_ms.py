"""The 95th percentile of every inter-token gap of every request in the
window: the time between the ends of consecutive steps (the prefill, then
each decode step), once for each request still inside its τout."""

import numpy as np


def read(run):
    gaps = run.gaps()
    return float(np.percentile(gaps, 95)) * 1e3 if gaps.size else None
