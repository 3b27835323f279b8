"""launches_per_iter.pagerank (layer: sweep; program counter): the launches of
the port's graph kernels (the wrappers' `launches` counters of
`segment_spmm`, `frontier_compact`, `hyb_gather`) over the window's pagerank
iterations."""


def read(obs):
    iters = sum(r.iterations for r in obs.runs)
    if obs.algorithm != "pagerank" or not iters:
        return None
    return sum(obs.launches.values()) / iters
