"""idle_share.pagerank (layer: device; device trace): the share of the traced
segment of pagerank runs in which no operation ran on the card,
1 - (union of device activity) / (traced window), in percent."""


def read(obs):
    if obs.algorithm != "pagerank" or obs.trace is None:
        return None
    return 100.0 * (1.0 - obs.trace.busy_s / obs.trace.window_s)
