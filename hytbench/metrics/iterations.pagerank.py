"""iterations.pagerank (layer: driver, `run_hytm`; program counter): the mean of
`HyTMResult.iterations` over the window's pagerank runs."""


def read(obs):
    if obs.algorithm != "pagerank" or not obs.runs:
        return None
    return sum(r.iterations for r in obs.runs) / len(obs.runs)
