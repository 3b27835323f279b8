"""sssp_ms_p90 (end to end, host clock): the 90th percentile of the wall
times of all the window's searches, each from the call to ``run_hytm``
until its distances are on the host (numpy's linear interpolation)."""

import numpy as np


def read(obs):
    if obs.algorithm != "sssp" or not obs.runs:
        return None
    return float(np.percentile([r.wall_s for r in obs.runs], 90)) * 1e3
