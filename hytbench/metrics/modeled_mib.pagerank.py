"""modeled_mib.pagerank (layer: plan, the paper's objective; program counter):
`HyTMResult.total_transfer_bytes` of a pagerank run in MiB, the mean over the
window's runs.  The cost model's link bytes, not a transfer measured on the
card: the port keeps the whole CSR in device memory."""


def read(obs):
    if obs.algorithm != "pagerank" or not obs.runs:
        return None
    return sum(r.transfer_bytes for r in obs.runs) / len(obs.runs) / 2**20
