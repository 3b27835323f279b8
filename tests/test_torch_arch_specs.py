"""The arch specs: ``repro_torch.configs.get_arch`` returns an ``ArchSpec``
for every arch, with the reference's cells, skips and reasons, and each
cell's ``model_flops`` and arguments as the reference's on both production
meshes (the twin of ``tests/test_smoke_archs.py``'s
``test_registry_covers_assignment``, and more).

The reference's side runs in one subprocess with 512 forced host devices
(``repro.launch.mesh.forced_host_device_env``): it builds every cell on
``make_production_mesh()`` and ``make_production_mesh(multi_pod=True)``
and writes each cell's ``model_flops`` and each argument leaf's local shape
(``NamedSharding.shard_shape``, no compile).  The port's side builds the
same cells on a mesh stub of the same axes (building a cell makes no
collective) and takes each leaf's local shape from its spec.

Leaves are compared as a multiset of (local shape, item size): the
reference stacks its scan layers' parameters and caches on a leading axis,
the port holds one tensor a layer (an LM's stacked leaf of n layers counts
as n leaves of its trailing shape), and the reference's train state
carries its step counter as an int32 leaf where the port's is a Python
int.  The
optimizer state is kept in the reference's stacked shapes on both sides.
``model_flops`` equal to 1e-9 relative.
"""

import json
import subprocess
import sys
import textwrap
from collections import Counter

import pytest
import torch

from repro.launch.mesh import forced_host_device_env
from repro_torch.configs import get_arch, list_archs
from repro_torch.dist.sharding import _children

FLOPS_RTOL = 1e-9
MESHES = {"pod16x16": (("data", "model"), (16, 16)),
          "pod2x16x16": (("pod", "data", "model"), (2, 16, 16))}
LM_ARCHS = ["kimi-k2-1t-a32b", "deepseek-v2-lite-16b", "internlm2-1.8b", "granite-20b",
            "gemma3-12b"]
GNN_ARCHS = ["graphsage-reddit", "pna", "gatedgcn", "meshgraphnet"]

_REFERENCE = """
    import json, sys
    import jax, numpy as np
    from jax.tree_util import tree_flatten_with_path
    from repro.configs import get_arch, list_archs
    from repro.launch.mesh import make_production_mesh
    assert len(jax.devices()) == 512
    meshes = {"pod16x16": make_production_mesh(),
              "pod2x16x16": make_production_mesh(multi_pod=True)}
    out = {"archs": list_archs(), "shapes": {}, "skips": {}, "cells": {}}

    def key(p):
        for attr in ("key", "idx", "name"):
            if hasattr(p, attr):
                return getattr(p, attr)
        return str(p)

    for a in list_archs():
        spec = get_arch(a)
        out["shapes"][a] = spec.shapes()
        out["skips"][a] = spec.skips
        for shape in spec.cells:
            for mname, mesh in meshes.items():
                b = spec.cells[shape](mesh)
                leaves = []
                for i, (arg, sh) in enumerate(zip(b.args, b.in_shardings)):
                    flat, _ = tree_flatten_with_path(arg)
                    shs = jax.tree.leaves(
                        sh, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
                    if len(shs) == 1 and len(flat) > 1:
                        shs = shs * len(flat)
                    assert len(shs) == len(flat), (a, shape, i)
                    state = type(arg).__name__ == "TrainState"
                    for (path, leaf), s in zip(flat, shs):
                        keys = [key(p) for p in path]
                        if state and keys[:1] == [3]:
                            continue   # the step counter
                        local = list(s.shard_shape(leaf.shape))
                        stacked = spec.family == "lm" and (
                            keys[:2] == [0, "layers"] if state else keys[:1] == ["layers"])
                        leaves.append([local[1:] if stacked else local,
                                       np.dtype(leaf.dtype).itemsize,
                                       local[0] if stacked else 1])
                out["cells"][f"{a}|{shape}|{mname}"] = {"model_flops": b.model_flops,
                                                        "leaves": leaves}
    json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("arch_specs") / "reference.json"
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE), str(path)],
                          capture_output=True, text=True, timeout=600,
                          env=forced_host_device_env(512))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(path.read_text())


class _Mesh:
    """Axis names and sizes: enough to build a cell and read its specs."""

    def __init__(self, names, sizes):
        self.axis_names, self.shape = names, dict(zip(names, sizes))


def _with_specs(tree, spec):
    """(tensor, spec) of every tensor leaf of a cell argument and its spec
    tree."""
    kids = _children(tree)
    if kids is None:
        if isinstance(tree, torch.Tensor):
            yield tree, spec
        return
    for k, child in kids:
        yield from _with_specs(child, spec[k])


def local_shape(shape, spec, sizes: dict) -> list:
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for a in axes:
            n *= sizes[a]
        assert dim % n == 0, (shape, spec)
        out.append(dim // n)
    return out


def _port_leaves(build, sizes) -> Counter:
    leaves = Counter()
    for arg, spec in zip(build.args, build.in_shardings):
        for t, s in _with_specs(arg, spec):
            leaves[(tuple(local_shape(t.shape, s, sizes)), t.element_size())] += 1
    return leaves


def _reference_leaves(rows) -> Counter:
    leaves = Counter()
    for shape, itemsize, n in rows:
        leaves[(tuple(shape), itemsize)] += n
    return leaves


def test_registry_covers_assignment(reference):
    """Every arch is an ``ArchSpec``; 40 assigned cells, four shapes an arch,
    the reference's shape names, skips and reasons; ``hytgraph`` has none."""
    assert list_archs() == reference["archs"]
    required = set(LM_ARCHS + GNN_ARCHS + ["dlrm-mlperf"])
    assert required <= set(list_archs())
    total = 0
    for a in list_archs():
        spec = get_arch(a)
        assert spec.name == a
        assert spec.shapes() == reference["shapes"][a], a
        assert spec.skips == reference["skips"][a], a
        if a in required:
            assert len(spec.shapes()) == 4, a
            total += len(spec.shapes())
    assert total == 40
    assert get_arch("hytgraph").shapes() == [] and get_arch("hytgraph").family == "graph"
    families = {a: get_arch(a).family for a in required}
    assert {families[a] for a in LM_ARCHS} == {"lm"}
    assert {families[a] for a in GNN_ARCHS} == {"gnn"}
    assert families["dlrm-mlperf"] == "recsys"


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS + GNN_ARCHS + ["dlrm-mlperf"])
def test_cells_match_reference_model_flops_and_local_shapes(reference, arch, mesh_name):
    """Every cell of ``arch`` on a production mesh: ``model_flops`` within
    1e-9 relative of the reference's, and the arguments' local shapes (with
    their item sizes) the reference's ``shard_shape``s, leaf for leaf."""
    names, sizes = MESHES[mesh_name]
    mesh = _Mesh(names, sizes)
    spec = get_arch(arch)
    assert spec.cells
    for shape, builder in spec.cells.items():
        ref = reference["cells"][f"{arch}|{shape}|{mesh_name}"]
        build = builder(mesh)
        assert abs(build.model_flops - ref["model_flops"]) <= FLOPS_RTOL * abs(
            ref["model_flops"]), (shape, build.model_flops, ref["model_flops"])
        got, want = _port_leaves(build, mesh.shape), _reference_leaves(ref["leaves"])
        assert got == want, (shape, got - want, want - got)


def test_lm_cells_run_on_the_meta_device():
    """A cell's arguments hold no storage: the LM train state of kimi-k2's
    trillion parameters is on the meta device."""
    build = get_arch("kimi-k2-1t-a32b").cells["train_4k"](_Mesh(*MESHES["pod16x16"]))
    state, batch = build.args
    assert all(p.is_meta for p in state.params.parameters())
    assert batch["tokens"].is_meta and batch["tokens"].dtype == torch.int32
    assert build.donate_argnums == (0,)
