"""prep_s (layer: set-up; host clock): the program's preprocessing of the
graph, ``hub_sort`` and ``build_runtime`` (partitioning and the upload of
``DeviceCSR``), up to a device synchronize.  Moves setup_s."""


def read(obs):
    return obs.prep_s
