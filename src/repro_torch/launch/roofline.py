"""Roofline terms of one cell, counted from its eager dispatch, with the
constants of one NVIDIA H100.

    compute term    = FLOPs / PEAK_FLOPS                 (per device)
    memory term     = bytes / HBM_BW                     (per device)
    collective term = collective wire bytes / LINK_BW    (per device)

Port of ``repro.launch.roofline``. The reference reads XLA's cost and
memory analysis of the compiled SPMD module and parses its collectives
from the optimized HLO. The port has no compiled program, so it counts
the cell's eager dispatch instead: :func:`count_cost` runs the step once
(on meta tensors in the dry-run: shapes, no storage) under a
``TorchDispatchMode`` that records, per aten op that is not a view,

  * FLOPs, with ``torch.utils.flop_counter``'s formulas (matmuls,
    convolutions, attention; elementwise ops count 0, as XLA's dots
    dominate its count);
  * bytes: every tensor input and output, each at the elements it spans
    (a broadcast dim counts once) — the eager counterpart of XLA's
    ``bytes accessed``;
  * peak live bytes: the storages created inside the step and not yet
    freed, the counterpart of ``temp_size_in_bytes``;
  * the largest tensors created, by dtype and shape, with counts (the
    counterpart of the reference's "top HLO buffers");
  * each read of a watched tensor (the parameters) by a matmul or an
    index lookup: the uses the collective accounting below prices.

Eager dispatch counts every attention chunk and every time step of a
recurrence, so the reference's ``scan_hidden_flops`` (the FLOPs XLA
misses inside a scan body counted once) has no counterpart.

**Per device.** The cell runs at the global shapes; the counted FLOPs,
bytes and peak live bytes are divided by the device count: every matmul
is split by the specs (batch over the DP axes, weights over ``model``).
``argument_bytes`` is the sum of the per-device shards
(``sharding.shard_shape``) of every parameter, optimizer moment, cache
leaf and input.

**Collectives.** :func:`collective_records` derives them from the specs
and the counted uses, under this accounting:

  * an FSDP weight (a dim over DP axes) is all-gathered over those axes
    before each use: the forward, the remat recompute and the backward
    each read it once; a train step reduce-scatters its gradient once
    (a weight no DP axis shards all-reduces its gradient instead);
  * a row-parallel weight — rows over ``model``, DP on a later dim:
    ``wo``, ``w_down`` / ``fc2``, ``w_wkv_out``, ``cm_v``, ``out_proj``,
    expert ``w_down`` — costs one all-reduce over ``model`` of its output
    activation per use;
  * experts over ``model`` cost two all-to-alls (dispatch and combine) of
    the routed tokens per layer and pass (per use of ``w_gate``);
  * a KV cache with its sequence dim sharded costs, in a decode step, one
    all-reduce of the partial attention output per layer; prefill writes
    its shards where they lie.

Activations are per device by the batch's DP shards. :func:`collective_bytes`
prices records ``(kind, group_size, in_bytes, out_bytes)`` under ring
accounting, as the reference prices its HLO lines:

    all-gather       (N−1)/N · output_bytes
    reduce-scatter   (N−1)/N · input_bytes
    all-reduce       2·(N−1)/N · input_bytes   (RS + AG)
    all-to-all       (N−1)/N · input_bytes
    collective-permute  input_bytes

**Constants** (NVIDIA's H100 SXM data sheet, at the 700 W limit): 989
TFLOP/s dense bf16, 3.35 TB/s HBM3, and one 400 Gb/s NDR InfiniBand port
per GPU, 50 GB/s: every axis of a 256-GPU mesh spans more than one 8-GPU
node, so the inter-node hop binds, as the reference's one ICI link does.
NVLink's 450 GB/s per direction inside a node is not used.
"""
from __future__ import annotations

import re
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .. import sharding as shd
from ..models.layers import dtype_of

__all__ = ["RooflineReport", "CostCount", "count_cost", "collective_bytes",
           "collective_records", "analyze_cell", "argument_bytes",
           "model_flops",
           "extrapolate_report", "PEAK_FLOPS", "HBM_BW", "LINK_BW"]

PEAK_FLOPS = 989e12      # dense bf16 per H100 SXM
HBM_BW = 3.35e12         # bytes/s, HBM3
LINK_BW = 50e9           # bytes/s, one 400 Gb/s NDR InfiniBand port

_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")
_LOOKUP = torch.ops.aten.index.Tensor      # the embedding lookup


def _span_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` spans: a dim of stride 0 (broadcast)
    counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a pytree, a module's parameters and buffers
    included."""
    out = []
    for t in pytree.tree_leaves(tree):
        if isinstance(t, torch.nn.Module):
            out += list(t.parameters()) + list(t.buffers())
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


@dataclass
class CostCount:
    """What :func:`count_cost` recorded over one run of a step (global
    shapes, all devices together)."""
    flops: int = 0
    bytes: int = 0
    peak_bytes: int = 0           # storages created in the step, at peak
    output_bytes: int = 0         # the step's outputs created in the step
    ops: int = 0                  # non-view aten ops dispatched
    buffers: Dict[Tuple[str, Tuple[int, ...]], List[int]] = field(
        default_factory=dict)     # (dtype, shape) -> [bytes, count]
    uses: List[Tuple[str, int, int]] = field(
        default_factory=list)     # (watched name, output rows, itemsize)


class _Counter(TorchDispatchMode):
    def __init__(self, count: CostCount, external: Iterable[int],
                 watch: Mapping[int, str]):
        super().__init__()
        self.count = count
        self.external = set(external)
        self.watch = dict(watch)
        self.live: Dict[int, int] = {}
        self.live_bytes = 0

    def _free(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_keys = {_key(t) for t in ins}
        if not func._schema.is_mutable and any(_key(t) in in_keys
                                               for t in outs):
            return out           # an alias (detach, _unsafe_view): no data
        c = self.count
        c.ops += 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            c.flops += int(formula(*args, **kwargs, out_val=out))
        if not func.__name__.startswith("empty"):
            c.bytes += sum(_span_bytes(t) for t in ins + outs)
        for t in outs:
            key = _key(t)
            if key in self.external or key in self.live:
                continue
            nbytes = t.untyped_storage().nbytes()
            self.live[key] = nbytes
            self.live_bytes += nbytes
            weakref.finalize(t.untyped_storage(), self._free, key)
            buf = c.buffers.setdefault(
                (str(t.dtype).replace("torch.", ""), tuple(t.shape)),
                [nbytes, 0])
            buf[1] += 1
        c.peak_bytes = max(c.peak_bytes, self.live_bytes)
        if self.watch and (formula is not None or func is _LOOKUP):
            used = {self.watch[_key(t)] for t in ins
                    if _key(t) in self.watch}
            if used and outs:
                o = outs[0]
                rows = o.numel() // max(o.shape[-1], 1) if o.dim() else 1
                c.uses.extend((name, rows, o.element_size())
                              for name in sorted(used))
        return out


def count_cost(fn, *args, watch: Optional[Mapping[str, torch.Tensor]] = None
               ) -> CostCount:
    """Run ``fn(*args)`` once under a dispatch mode that counts its FLOPs,
    bytes, peak live bytes and created tensors (module docstring), and the
    matmul / index uses of the tensors of ``watch`` ({name: tensor}).
    Storages of ``args`` are the step's arguments: never counted as
    created."""
    count = CostCount()
    external = {_key(t) for t in _tensors(args)}
    keys = {_key(t): name for name, t in (watch or {}).items()}
    with _Counter(count, external, keys) as mode:
        out = fn(*args)
        count.output_bytes = sum(
            mode.live.get(k, 0) for k in {_key(t) for t in _tensors(out)})
    del out
    return count


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def collective_bytes(records: Iterable[Tuple[str, int, float, float]]
                     ) -> Dict[str, float]:
    """Per-device wire bytes by collective kind (+ raw operand bytes) of
    records ``(kind, group_size, in_bytes, out_bytes)``."""
    out: Dict[str, Any] = {k: 0.0 for k in _KINDS}
    out.update(operand_bytes=0.0, count=0)
    for kind, n, in_bytes, out_bytes in records:
        if kind not in _KINDS:
            raise ValueError(f"unknown collective {kind!r}")
        frac = (n - 1) / n if n > 1 else 0.0
        if kind == "all-gather":
            wire = frac * out_bytes
        elif kind == "all-reduce":
            wire = 2.0 * frac * in_bytes
        elif kind in ("reduce-scatter", "all-to-all"):
            wire = frac * in_bytes
        else:  # collective-permute
            wire = float(in_bytes)
        out[kind] += wire
        out["operand_bytes"] += in_bytes
        out["count"] += 1
    out["wire_bytes"] = sum(out[k] for k in _KINDS)
    return out


_ROW_PARALLEL = re.compile(
    r"(^|/)(wo|w_down|w_out|fc2|w_wkv_out|cm_v|out_proj)$")


def _has(entry, axes) -> bool:
    names = entry if isinstance(entry, tuple) else (entry,)
    return any(a in axes for a in names if a is not None)


def _without(spec, axes) -> Tuple:
    """``spec`` with the ``axes`` removed from every entry."""
    out = []
    for entry in spec:
        names = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        kept = tuple(a for a in names if a not in axes)
        out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
    return tuple(out)


def _nbytes(shape, itemsize: int) -> int:
    n = itemsize
    for d in shape:
        n *= d
    return n


def collective_records(cell, uses: Iterable[Tuple[str, int, int]]
                       ) -> List[Tuple[str, int, int, int]]:
    """The per-device collectives of ``cell`` (``steps.Cell``) under the
    accounting of the module docstring: ``uses`` are
    :attr:`CostCount.uses` of its parameters."""
    mesh, cfg = cell.mesh, cell.cfg
    model, pspecs = cell.args[0], cell.in_specs[0]
    params = dict(model.named_parameters())
    axes = tuple(mesh.axis_names)
    dp_axes = tuple(a for a in shd.DP_AXES if a in axes)
    tp = mesh.shape.get(shd.TP_AXIS, 1)
    batch_div = cell.batch_shards
    recs: List[Tuple[str, int, int, int]] = []

    def fsdp(name):
        """(group, shard bytes, gathered bytes) of an FSDP weight, else
        None."""
        spec, p = pspecs[name], params[name]
        groups = [e for e in spec if e is not None and _has(e, dp_axes)]
        if not groups:
            return None
        n = 1
        for e in groups:
            names = e if isinstance(e, tuple) else (e,)
            n *= shd._axes_size(mesh, tuple(a for a in names
                                            if a in dp_axes))
        shard = shd.shard_shape(p.shape, spec, mesh)
        gathered = shd.shard_shape(p.shape, _without(spec, dp_axes), mesh)
        item = p.element_size()
        return n, _nbytes(shard, item), _nbytes(gathered, item)

    for name, rows, item in uses:
        spec, p = pspecs[name], params[name]
        path = shd.reference_path(name)
        f = fsdp(name)
        if f is not None and f[0] > 1:
            recs.append(("all-gather", f[0], f[1], f[2]))
        if tp > 1 and p.dim() >= 2 and spec and _has(spec[0], (shd.TP_AXIS,)):
            act = rows * p.shape[-1] * item // batch_div
            if _ROW_PARALLEL.search(path):
                recs.append(("all-reduce", tp, act, act))
            elif re.search(r"experts/w_gate$", path):
                routed = rows * cfg.d_model * item // batch_div
                recs += [("all-to-all", tp, routed, routed)] * 2
    if cell.kind == "train":
        dp = shd._dp_size(mesh)
        for name, p in params.items():
            f = fsdp(name)
            if f is not None and f[0] > 1:
                recs.append(("reduce-scatter", f[0], f[2], f[1]))
            elif f is None and dp > 1:
                b = _nbytes(shd.shard_shape(p.shape, pspecs[name], mesh),
                            p.element_size())
                recs.append(("all-reduce", dp, b, b))
    if cell.kind == "decode":
        cache, cspecs = cell.args[2], cell.in_specs[2]
        act_item = torch.empty(
            (), dtype=dtype_of(cfg.compute_dtype)).element_size()
        for name in ("k", "xk"):
            if name not in cache or len(cspecs[name]) < 3 \
                    or cspecs[name][2] is None:
                continue
            leaf, spec = cache[name], cspecs[name]
            group = shd._axes_size(mesh, spec[2])
            b = leaf.shape[1] // (shd._axes_size(mesh, spec[1])
                                  if spec[1] is not None else 1)
            part = b * cfg.n_heads * cfg.hd * act_item
            recs += [("all-reduce", group, part, part)] * leaf.shape[0]
    return recs


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------

@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll: Dict[str, float]
    argument_bytes: int
    temp_bytes: int
    output_bytes: int
    model_flops_total: float

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll["wire_bytes"] / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step time = max of the three overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / (counted FLOPs · chips) — remat/redundancy
        waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Roofline-model FLOP utilization: useful FLOPs / (chips · peak
        · step time)."""
        denom = self.chips * PEAK_FLOPS * self.step_s
        return self.model_flops_total / denom if denom else 0.0

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops/dev": self.flops_per_device,
            "bytes/dev": self.bytes_per_device,
            "coll_wire_bytes/dev": self.coll["wire_bytes"],
            "coll_ops": self.coll["count"],
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck, "step_s": self.step_s,
            "useful_flops_frac": self.useful_flops_frac, "mfu": self.mfu,
            "arg_bytes/dev": self.argument_bytes,
            "temp_bytes/dev": self.temp_bytes,
        }


def model_flops(cfg, shape) -> float:
    """6·N·D for training (fwd+bwd), 2·N·D for prefill, 2·N·B for one
    decode step; N = active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def extrapolate_report(r1: RooflineReport, r2: RooflineReport,
                       trips: int, *, temp_grows: bool = True
                       ) -> RooflineReport:
    """Two-point depth extrapolation: a cell built at u trips of depth
    costs ``fixed + u · per_trip``, so from u = 1, 2

        true = c1 + (trips−1)·max(c2−c1, 0)

    for FLOPs, bytes and every float collective bucket (the op count
    stays r1's), as the reference. The u = 1 cell holds one trip of
    parameters (the reference's u = 1 lowering holds the whole depth), so
    argument and output bytes extrapolate too, and so does the peak of
    live bytes when ``temp_grows`` (a train step keeps every layer's
    saved activations and gradients); else (a serve step, whose layers'
    transients die before the next layer's but one) the peak is r2's."""
    k = trips - 1

    def ex(a, b):
        return a + k * max(b - a, 0.0)

    coll = {key: (ex(r1.coll[key], r2.coll[key])
                  if isinstance(r1.coll[key], float) else r1.coll[key])
            for key in r1.coll}
    coll["count"] = r1.coll["count"]
    return RooflineReport(
        arch=r1.arch, shape=r1.shape, mesh=r1.mesh, chips=r1.chips,
        flops_per_device=ex(r1.flops_per_device, r2.flops_per_device),
        bytes_per_device=ex(r1.bytes_per_device, r2.bytes_per_device),
        coll=coll,
        argument_bytes=ex(r1.argument_bytes, r2.argument_bytes),
        temp_bytes=(ex(r1.temp_bytes, r2.temp_bytes) if temp_grows
                    else max(r1.temp_bytes, r2.temp_bytes)),
        output_bytes=ex(r1.output_bytes, r2.output_bytes),
        model_flops_total=r1.model_flops_total,
    )


def argument_bytes(cell) -> int:
    """Per-device bytes of every argument of ``cell``: the shards of each
    tensor by its spec."""
    total = 0
    for arg, specs in zip(cell.args, cell.in_specs):
        if isinstance(arg, torch.nn.Module):
            arg = dict(arg.named_parameters())
        flat = _flat(arg, specs)
        for t, spec in flat:
            total += _nbytes(shd.shard_shape(t.shape, spec, cell.mesh),
                             t.element_size())
    return total


def _flat(arg, specs):
    """(tensor, spec) pairs of an argument and its specs (nested dicts of
    the same keys, or one tensor and one spec)."""
    if isinstance(arg, torch.Tensor):
        return [(arg, specs)]
    if isinstance(arg, Mapping):
        return [pair for k, v in arg.items() for pair in _flat(v, specs[k])]
    return []


def analyze_cell(cell, mesh_name: str) -> Tuple[RooflineReport, CostCount]:
    """Count ``cell`` once (:func:`count_cost`, its parameters watched) and
    build its per-device report."""
    chips = cell.mesh.size
    count = count_cost(cell.fn, *cell.args,
                       watch=dict(cell.args[0].named_parameters()))
    coll = collective_bytes(collective_records(cell, count.uses))
    report = RooflineReport(
        arch=cell.cfg.name, shape=cell.shape.name, mesh=mesh_name,
        chips=chips,
        flops_per_device=count.flops / chips,
        bytes_per_device=count.bytes / chips,
        coll=coll,
        argument_bytes=argument_bytes(cell),
        temp_bytes=count.peak_bytes / chips,
        output_bytes=count.output_bytes / chips,
        model_flops_total=model_flops(cell.cfg, cell.shape),
    )
    return report, count
