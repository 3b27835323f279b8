"""Dry run of every (arch x shape x mesh) cell on the production meshes,
with no card and no compiler (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 256 or 512 forced host
devices and reads XLA's memory and cost analyses and the HLO's
collectives.  Here one CPU process joins a *fake* process group of 256 or
512 ranks (``torch.testing._internal.distributed.fake_pg``: collectives
return at once), places every argument on the cell's specs as DTensors of
*fake* tensors (``FakeTensorMode``: shapes, dtypes, no storage), and runs
the cell's step once (the whole train step with its update, or one
prefill or decode) as rank 0 of the mesh.  A dispatch mode under DTensor
sees every local op of rank 0 and reads:

* ``memory``: ``argument_bytes`` and ``output_bytes``, the local shards'
  bytes of the arguments and outputs; ``alias_bytes``, the outputs' bytes
  that share storage with an argument (the state a train step updates in
  place, the reference's donation); ``peak_device_bytes``, the most bytes
  of fake storage alive at once during the step, the arguments included;
  ``temp_bytes`` such that peak = argument + output + temp - alias, as
  the reference's;
* ``cost``: ``flops``, this rank's flops from its local ops
  (``torch.utils.flop_counter``'s formulas: products, attention,
  convolutions; the flops of a DTensor product are its local shard's, not
  the global product's), and ``bytes_accessed``, the bytes each local op
  reads and writes;
* ``collectives``: by kind (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``), the
  functional and c10d collectives' ``count``, ``result_bytes`` and
  ``wire_bytes`` by the reference's ring factors (``dryrun.py:59-93``);
  DTensor's redistributions and the MoE's exchanges alike;
* ``grad_placements``: each gradient that autograd left placed otherwise
  than its parameter (a ``Partial`` the step then reduces), which the
  census must show.

These are a CPU's predictions for the card: fake tensors run no kernel,
and the peak counts storage, not the allocator's blocks.  Records land in
``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json`` (the
reference's own records stay in ``experiments/dryrun``).  The fake
backend belongs to this module and its tests only; nothing that trains or
serves picks it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun               # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-12b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single # 16x16 only
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_arch, list_archs
from repro_torch.dist.sharding import distribute
from repro_torch.launch.mesh import device_mesh, make_production_mesh

MESHES = {False: ("pod16x16", 256), True: ("pod2x16x16", 512)}

# functional (``_c10d_functional``) and c10d op names -> the reference's kinds
_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(args) -> int:
    """The group size of a collective's arguments: a functional op names
    its group, a c10d op passes the ProcessGroup (boxed)."""
    for a in args:
        if isinstance(a, str):
            try:
                return dist.distributed_c10d._resolve_process_group(a).size()
            except (KeyError, RuntimeError, ValueError):
                continue
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a).size()
    raise ValueError("a collective without a process group")


def wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Per-device wire bytes by the reference's ring factors."""
    n = max(n, 2)
    if kind == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / n
    if kind in ("all-gather", "all-to-all"):
        return result_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)      # the result is the scattered shard
    return result_bytes


# DTensor runs each op once on fake tensors of the *global* shape to learn
# its output's shape (sharding propagation); those ops are not rank 0's work
_PROPAGATORS = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")


class StepMeter(TorchDispatchMode):
    """Rank 0's local ops while entered (DTensor ops pass through to the
    DTensor dispatch, whose local ops come back here; the global-shape ops
    of DTensor's sharding propagation are not counted): flops, bytes
    accessed, collectives by kind, and the bytes of storage alive, from
    the bytes of the tensors ``held`` (the arguments) up, with its peak; a
    view of a held tensor adds nothing."""

    def __init__(self, held=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.collectives = defaultdict(lambda: {"count": 0, "result_bytes": 0.0,
                                                "wire_bytes": 0.0})
        self._seen = weakref.WeakKeyDictionary()
        for t in held:
            self._seen[t.untyped_storage()] = t.untyped_storage().nbytes()
        self.live = self.peak = sum(self._seen.values())
        self._muted = 0
        self._patched = {}
        self._entered = 0

    def __enter__(self):
        # entered again (``with self`` around a decomposition) it patches nothing
        self._entered += 1
        if self._entered > 1:
            return super().__enter__()
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        for name in _PROPAGATORS:
            orig = ShardingPropagator.__dict__.get(name)
            if orig is None:
                continue

            def muted(*a, _orig=orig, **k):
                self._muted += 1
                try:
                    return _orig(*a, **k)
                finally:
                    self._muted -= 1

            self._patched[name] = orig
            setattr(ShardingPropagator, name, muted)
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        self._entered -= 1
        if self._entered == 0:
            for name, orig in self._patched.items():
                setattr(ShardingPropagator, name, orig)
            self._patched = {}
        return super().__exit__(*exc)

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if self._muted:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        ns, _, name = packet._qualified_op_name.partition("::")
        if ns == "aten" and packet not in self.flop_registry:
            # a composite op (``matmul`` under inference mode) counts as the
            # ops it decomposes into, which come back here
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        kind = _KINDS.get(name) if ns in _NAMESPACES else None
        if kind is not None:
            res = sum(_nbytes(t) for t in (outs or list(_tensors(args))))
            if name.endswith("_") and ns == "c10d":   # in place: the result is the argument
                res = sum(_nbytes(t) for t in _tensors(args[:1]))
            rec = self.collectives[kind]
            rec["count"] += 1
            rec["result_bytes"] += res
            rec["wire_bytes"] += wire_bytes(kind, res, _group_size(list(args) + list(kwargs.values())))
        elif packet in self.flop_registry:
            self.flops += float(self.flop_registry[packet](*args, **kwargs, out_val=out))
        self.bytes_accessed += sum(_nbytes(t) for t in _tensors(args)) + sum(
            _nbytes(t) for t in outs)
        for t in outs:
            if not t.is_meta:
                self._track(t)
        return out


def local_leaves(tree) -> list:
    """The local tensors of every tensor leaf of ``tree`` (modules by their
    parameters, dataclasses by their fields)."""
    from repro_torch.dist.sharding import _children

    out = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            out.append(node.to_local() if hasattr(node, "to_local") else node)
            return
        kids = _children(node)
        if kids:
            for _, child in kids:
                walk(child)

    walk(tree)
    return out


def storage_bytes(tensors) -> tuple[int, set]:
    seen, total = set(), 0
    for t in tensors:
        key = id(t.untyped_storage())
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total, seen


def _grad_watch(args, out: dict) -> list:
    """Hooks that record each DTensor parameter whose accumulated gradient
    is placed otherwise than the parameter."""
    from torch import nn

    hooks = []
    for a in args:
        module = getattr(a, "params", a)
        if not isinstance(module, nn.Module):
            continue
        for name, p in module.named_parameters():
            if not (p.requires_grad and hasattr(p, "placements")):
                continue

            def hook(param, name=name):
                g = param.grad
                if g is not None and tuple(g.placements) != tuple(param.placements):
                    out[name] = [str(tuple(g.placements)), str(tuple(param.placements))]

            hooks.append(p.register_post_accumulate_grad_hook(hook))
    return hooks


def empty_shard(t: torch.Tensor, local_shape: tuple) -> torch.Tensor:
    """This rank's shard of meta tensor ``t``: an empty tensor of its local
    shape (a fake one under ``FakeTensorMode``)."""
    return torch.empty(local_shape, dtype=t.dtype, device="cpu").requires_grad_(t.requires_grad)


def place(build, dm, make_local=empty_shard) -> tuple:
    """A cell's arguments placed on ``dm`` by its specs, each shard made by
    ``make_local``."""
    return tuple(distribute(a, dm, s, make_local=make_local)
                 for a, s in zip(build.args, build.in_shardings))


def measure(build, dm, make_local=empty_shard) -> dict:
    """Run a cell's step once on ``dm`` as this rank (its arguments placed
    with ``make_local``'s shards) and read the record's ``memory``,
    ``cost``, ``collectives`` and ``grad_placements``.  Fake tensors under
    the dry run; real ones (a gloo mesh) run the same meter."""
    t0 = time.time()
    args = place(build, dm, make_local)
    arg_leaves = local_leaves(args)
    arg_bytes, arg_storages = storage_bytes(arg_leaves)
    t_place = time.time() - t0
    grads = {}
    hooks = _grad_watch(args, grads)
    t0 = time.time()
    with StepMeter(held=arg_leaves) as meter:
        out = build.fn(*args)
    t_run = time.time() - t0
    for h in hooks:
        h.remove()
    out_leaves = local_leaves(out)
    out_bytes, _ = storage_bytes(out_leaves)
    alias = sum(t.untyped_storage().nbytes() for t in
                {id(t.untyped_storage()): t for t in out_leaves}.values()
                if id(t.untyped_storage()) in arg_storages)
    peak = max(meter.peak, arg_bytes + out_bytes - alias)
    return {
        "lower_s": round(t_place, 2),      # building and placing the arguments
        "compile_s": 0.0,                  # nothing is compiled
        "run_s": round(t_run, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": peak - arg_bytes - out_bytes + alias,
            "alias_bytes": alias,
            "peak_device_bytes": peak,
        },
        "cost": {"flops": meter.flops, "bytes_accessed": meter.bytes_accessed},
        "collectives": {k: dict(v) for k, v in meter.collectives.items()},
        "grad_placements": grads,
        "model_flops": build.model_flops,
        "note": build.note,
    }


def run_cell(arch_name: str, shape: str, multi_pod: bool) -> dict:
    """One cell's record on the fake group that ``fake_process_group``
    made (``multi_pod``: the 512-rank mesh)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    arch = get_arch(arch_name)
    mesh_name, n_devices = MESHES[multi_pod]
    record = {"arch": arch_name, "shape": shape, "mesh": mesh_name, "n_devices": n_devices}
    if shape in arch.skips:
        record["status"] = "SKIP"
        record["reason"] = arch.skips[shape]
        return record
    if dist.get_world_size() != n_devices:
        raise RuntimeError(f"the fake group has {dist.get_world_size()} ranks, {mesh_name} "
                           f"needs {n_devices}")
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    dm = device_mesh(mesh)
    build = arch.cells[shape](mesh)
    with FakeTensorMode(allow_non_fake_inputs=True):
        record.update(status="OK", **measure(build, dm))
    return record


def fake_process_group(world_size: int) -> None:
    """This process as rank 0 of a fake group of ``world_size`` ranks
    (replacing any fake group it had)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs its own process: a real process group is "
                               "initialized")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def run(archs, shapes, meshes, out_dir) -> list:
    """Every cell's record (written to ``out_dir``), printed one line a
    cell; returns the failed cells' tags."""
    os.makedirs(out_dir, exist_ok=True)
    failures = []
    for multi_pod in meshes:
        mesh_name, n_devices = MESHES[multi_pod]
        fake_process_group(n_devices)
        for arch_name in archs:
            arch = get_arch(arch_name)
            for shape in shapes or arch.shapes():
                tag = f"{arch_name}__{shape}__{mesh_name}"
                try:
                    rec = run_cell(arch_name, shape, multi_pod)
                except Exception as e:  # a failure here is a bug in the port
                    rec = {"arch": arch_name, "shape": shape, "mesh": mesh_name,
                           "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    failures.append(tag)
                with open(os.path.join(out_dir, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                status, extra = rec["status"], ""
                if status == "OK":
                    peak = rec["memory"]["peak_device_bytes"] / 2**30
                    extra = (f"peak {peak:.2f} GiB/dev | {rec['cost']['flops']:.3g} flops/dev"
                             f" | run {rec['run_s']}s")
                elif status == "FAIL":
                    extra = rec["error"][:160]
                print(f"[{status:4s}] {tag}: {extra}", flush=True)
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="single arch (default: all)")
    ap.add_argument("--shape", default=None, help="single shape (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else [a for a in list_archs() if a != "hytgraph"]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    failures = run(archs, [args.shape] if args.shape else None, meshes, args.out)
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print("\nall dry-run cells passed")


if __name__ == "__main__":
    main()
