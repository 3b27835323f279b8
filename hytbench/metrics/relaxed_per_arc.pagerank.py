"""relaxed_per_arc.pagerank (layer: plan; program counter): the arcs the schedule
had the sweep relax in a pagerank run, the sum over its iterations of
`history["active_edges"]`, over the graph's arcs; the mean over the
window's runs."""


def read(obs):
    if obs.algorithm != "pagerank" or not obs.runs:
        return None
    return sum(r.active_edges for r in obs.runs) / len(obs.runs) / obs.arcs
