"""The paper's own workload as an arch: the HyTM graph-analytics engine
(port of ``repro.configs.hytgraph_paper``).

Not one of the assigned model cells: ``--arch hytgraph`` names the
reproduction itself (SSSP / BFS / CC / PageRank over RMAT), driven by
``examples/torch_quickstart.py`` and ``chip_smoke.py``.  The reference's
``ArchSpec`` (with no cells) comes with the arch specs.
"""

from dataclasses import dataclass

from repro_torch.core.hytm import HyTMConfig


@dataclass(frozen=True)
class HyTGraphWorkload:
    algorithm: str = "sssp"
    n_nodes: int = 100_000
    n_edges: int = 1_600_000
    n_partitions: int = 64
    hytm: HyTMConfig = HyTMConfig(n_partitions=64)


CONFIG = HyTGraphWorkload()
