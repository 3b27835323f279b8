"""The paper's own workload as an arch: the HyTM graph-analytics engine
(port of ``repro.configs.hytgraph_paper``).

Not one of the assigned model cells: ``--arch hytgraph`` names the
reproduction itself (SSSP / BFS / CC / PageRank over RMAT), driven by
``examples/torch_quickstart.py`` and ``chip_smoke.py``; its ``ArchSpec``
has no cells (the dry run skips it).
"""

from dataclasses import dataclass

from repro_torch.configs.common import ArchSpec
from repro_torch.core.hytm import HyTMConfig


@dataclass(frozen=True)
class HyTGraphWorkload:
    algorithm: str = "sssp"
    n_nodes: int = 100_000
    n_edges: int = 1_600_000
    n_partitions: int = 64
    hytm: HyTMConfig = HyTMConfig(n_partitions=64)


CONFIG = HyTGraphWorkload()

ARCH = ArchSpec(
    name="hytgraph",
    family="graph",
    cells={},  # driven by examples/torch_quickstart.py and chip_smoke.py, not the dry run
    model_config=CONFIG,
)
