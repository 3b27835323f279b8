"""host_syncs_per_iter.sssp (layer: driver; program counter): the blocking
device-to-host reads of `run_hytm` (`repro_torch.core.hytm.host_syncs`,
every site summed) over the iterations it ran (`hytm.iterations_run`), both
counted since the process started: every sssp run up to the read, the
warm-up, the window and the traced segment, which read alike a run (an
iteration's fetch, a chunk's history drain and frontier count, a run's two
copies out).  None without a window's runs, or where the program keeps no
such counter."""


def read(obs):
    if obs.algorithm != "sssp" or not obs.runs:
        return None
    from repro_torch.core import hytm

    syncs, iters = getattr(hytm, "host_syncs", None), getattr(hytm, "iterations_run", 0)
    if syncs is None or not iters:
        return None
    return sum(syncs.values()) / iters
