"""relax_roofline.sssp (layer: kernels; device trace): the least time the
card needs for the bytes of the traced SSSP runs' relaxations, at its
memory bandwidth, over the time the card was busy in those runs, in percent.

The bytes are what relaxing the active arcs needs, each counted once,
whatever kernel or engine does the work: per active arc its destination and weight (4 + 4 bytes),
from the history's active arcs of each iteration.  The vertex arrays
(values, pending deltas, arc ranges: 4 bytes a vertex each) are left out:
they fit in the L2, or nearly, so no DRAM traffic is certain for them.  The
count is a floor, so the share passes 100% only if the busy time misses
work."""

from hytbench.peaks import HBM_BYTES_PER_S

BYTES_PER_ACTIVE_ARC = 8


def read(obs):
    t = obs.trace
    if obs.algorithm != "sssp" or t is None or not t.runs or t.busy_s <= 0:
        return None
    need = BYTES_PER_ACTIVE_ARC * sum(r.active_edges for r in t.runs)
    return 100.0 * need / HBM_BYTES_PER_S / t.busy_s
