"""Every decode step's wall in the window (the engine's step meter: its
call to the end of its device work), over their count."""

import numpy as np


def read(run):
    walls = [w for s in run.served for w in s.decode_s]
    return float(np.mean(walls)) * 1e3 if walls else None
