"""sssp_gteps (end to end, host clock): Graph500's traversed edges of every
search of the window, the undirected edges of the source's connected
component, over the summed wall time of those same searches, in 1e9 edges
a second.  One rate over all the work and all the time."""


def read(obs):
    if obs.algorithm != "sssp" or not obs.runs:
        return None
    return sum(r.edges for r in obs.runs) / sum(r.wall_s for r in obs.runs) / 1e9
