"""launches_per_iter.sssp (layer: sweep; program counter): the launches of
the port's graph kernels (the wrappers' `launches` counters of
`segment_spmm`, `frontier_compact`, `hyb_gather`) over the window's sssp
iterations."""


def read(obs):
    iters = sum(r.iterations for r in obs.runs)
    if obs.algorithm != "sssp" or not iters:
        return None
    return sum(obs.launches.values()) / iters
