"""pagerank_s (end to end, host clock): the summed wall time of the
window's completed Delta-PageRank runs over their count."""


def read(obs):
    if obs.algorithm != "pagerank" or not obs.runs:
        return None
    return sum(r.wall_s for r in obs.runs) / len(obs.runs)
