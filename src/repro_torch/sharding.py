"""Sharding: the model-side partition specs over the production mesh
axes ("pod", "data", "model"), and the ER executor's device mesh and its
collectives, driven by one process.

Port of ``repro.sharding``. **Model-side specs** (reference
``sharding.py:59-305``), used by the cell harness (``launch/steps.py``,
``launch/dryrun.py``):

  * 2-D weight sharding — tensor-parallel dims over ``model``, FSDP over
    ("pod", "data") on the other large dim; MoE experts expert-parallel
    over ``model``; KV caches batch over ("pod", "data"), kv-heads over
    ``model`` when divisible, else the sequence (context parallelism).
  * Rules match name patterns over the reference's ``/``-joined param
    paths, first match wins, and a dim that an axis does not divide stays
    unsharded. The port's tree has one node per layer (``layers.3.wq``;
    zamba2's ``blocks`` flattened into ``n_layers`` nodes), so a port
    name is turned into the reference's path (``layers/wq``) and matched
    with no leading stack dims.
  * A spec is a :class:`P`: a tuple with one entry per leading dim — an
    axis name, a tuple of names, or None — trailing Nones dropped, as
    ``jax.sharding.PartitionSpec``. :func:`shard_shape` gives the
    per-device sizes. The production meshes are :class:`AbstractMesh`es:
    axis names and sizes, no devices.
  * The sharding-constraint hooks (:func:`constrain`, ``act_constrain``,
    ``attn_logits_constrain``; reference ``sharding.py:59-127``) sit where
    the reference calls them. The port runs no SPMD program, so a hook
    returns its input, the same tensor; inside a :func:`set_mesh` context
    (``jax.set_mesh``'s counterpart) it also appends a :class:`Record` of
    what the reference's constraint asks, which a test or a caller reads.

**The ER mesh** (``make_er_mesh``). The reference
is single-controller: one Python process plans and drives ``shard_map``
over a ``jax.sharding.Mesh``. The port keeps that shape with no
``torch.distributed`` at all:

  * a :class:`Mesh` is a ``(n_data, n_model)`` grid of ``torch.device``,
    row-major with ``model`` fastest, as the reference reshapes it — one
    device per position, or one device repeated (logical shards, the
    counterpart of the reference tests' simulated host devices);
  * a :class:`Sharded` matrix is the grid of its per-position tensors
    (:func:`shard_rows` row-shards over ``data`` and column-shards over
    ``model``; :func:`replicate` copies the rows to every ``data``
    position);
  * a collective is an explicit tensor move between the positions'
    devices, ``Tensor.to(device, non_blocking=True)``: a peer copy
    between two GPUs, nothing at all between two logical shards of one
    device (the result then aliases its source, which the executor only
    reads).

``all_gather`` and ``ppermute`` take an optional ``traffic`` list (one
int per position) and add the bytes a position receives from ANOTHER
position, whether or not they cross a wire — the quantity the comms
formulas of ``er/compiler/comms.py`` account.
"""
from __future__ import annotations

import re
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import (Any, Dict, Iterator, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

__all__ = ["Mesh", "AbstractMesh", "Sharded", "make_er_mesh", "shard_rows",
           "replicate", "all_gather", "ppermute", "psum", "axis_index",
           "P", "set_mesh", "get_mesh", "MeshContext", "Record",
           "constrain", "act_constrain", "attn_logits_constrain",
           "param_spec", "param_shardings", "batch_spec", "cache_spec",
           "cache_shardings", "shard_shape", "DP_AXES", "TP_AXIS"]

DP_AXES = ("pod", "data")
TP_AXIS = "model"


class Mesh:
    """A 2-D grid of torch devices with named axes.

    ``devices`` is the ``(n_axis0, n_axis1)`` object array of
    ``torch.device``; ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does. Every device of a mesh has one type
    (all CUDA or all CPU)."""

    def __init__(self, devices, axis_names: Sequence[str] = ("data",
                                                             TP_AXIS)):
        shape = np.shape(devices)
        if len(shape) != 2 or len(axis_names) != 2 or 0 in shape:
            raise ValueError("a mesh is a non-empty 2-D device grid with "
                             "two axis names")
        grid = np.empty(shape, object)
        for i, j in np.ndindex(shape):
            grid[i, j] = torch.device(devices[i][j])
        types = {d.type for d in grid.flat}
        if len(types) != 1 or types - {"cuda", "cpu"}:
            raise ValueError(f"mesh devices must all be CUDA or all CPU "
                             f"(got {sorted(types)})")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    @property
    def first_device(self) -> torch.device:
        """Position (0, 0): where the host-side stages (verifier, legacy
        results) run."""
        return self.devices.flat[0]

    def grid(self, axis: str = "data",
             model_axis: Optional[str] = None) -> np.ndarray:
        """The ``(n_data, n_model)`` device grid of a data flow that shards
        rows over ``axis`` and columns over ``model_axis``. Without a
        model axis every data position uses its first model column (the
        other columns would repeat its work)."""
        if axis not in self.axis_names:
            raise ValueError(f"unknown mesh axis {axis!r}")
        grid = (self.devices if self.axis_names.index(axis) == 0
                else self.devices.T)
        if model_axis is None:
            return grid[:, :1]
        if model_axis == axis or model_axis not in self.axis_names:
            raise ValueError(f"model_axis {model_axis!r} must be the "
                             f"mesh's other axis")
        return grid


class AbstractMesh:
    """Named axes and their sizes, no devices: the production meshes of
    the dry-run (``launch/mesh.py``), as ``jax.sharding.AbstractMesh``.
    ``shape`` maps each axis name to its size, as :class:`Mesh`'s
    does."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        if len(axis_sizes) != len(axis_names) or not axis_names \
                or min(axis_sizes) < 1 \
                or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"an abstract mesh needs one size >= 1 per "
                             f"distinct axis name, got {axis_sizes} "
                             f"{axis_names}")
        self.axis_sizes = tuple(int(n) for n in axis_sizes)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def make_er_mesh(n_data: int, n_model: int = 1, *,
                 devices: Optional[Sequence] = None) -> Mesh:
    """The ER executor's 2-D ``(data, model)`` mesh: corpus rows shard
    over ``data``, the hashed n-gram feature dimension over ``model``
    (``compiler.execute(model_axis="model")`` psums the partial tile
    scores). Devices fill the grid row-major, ``model`` fastest, so a
    model group's devices are adjacent.

    By default the first ``n_data·n_model`` CUDA devices; raises
    ``ValueError`` when there are fewer (nothing falls back to the CPU).
    ``devices=`` lists them explicitly and may repeat one device:
    ``["cpu"] * 8`` gives 8 logical CPU shards, ``["cuda:0"] * 8`` 8
    logical shards of one card."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    need = n_data * n_model
    if n_data < 1 or n_model < 1 or len(devices) < need:
        raise ValueError(f"need {need} devices for a ({n_data}, {n_model}) "
                         f"mesh, have {len(devices)}")
    grid = [devices[i * n_model:(i + 1) * n_model] for i in range(n_data)]
    return Mesh(grid, ("data", TP_AXIS))


@dataclass(frozen=True)
class Sharded:
    """A matrix laid out over a device grid: ``blocks[d][m]`` lies on the
    grid's device (d, m) and holds row block d (all rows when
    ``row_split`` is false — replicated over ``data``) and column block
    m. ``shape`` is the global (rows, cols)."""
    blocks: Tuple[Tuple[torch.Tensor, ...], ...]
    shape: Tuple[int, int]
    row_split: bool

    def column(self, m: int) -> List[torch.Tensor]:
        """The blocks of column block ``m``, one per data position."""
        return [row[m] for row in self.blocks]


def _to_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _layout(x, grid: np.ndarray, row_split: bool) -> Sharded:
    t = _to_tensor(x)
    n_data, n_model = grid.shape
    rows, cols = int(t.shape[0]), int(t.shape[1])
    if row_split and rows % n_data:
        raise ValueError(f"{rows} rows do not shard over {n_data} data "
                         f"positions")
    if cols % n_model:
        raise ValueError(f"{cols} columns do not shard over {n_model} "
                         f"model positions")
    nl = rows // n_data if row_split else rows
    dl = cols // n_model
    blocks = []
    for d in range(n_data):
        r0 = d * nl if row_split else 0
        blocks.append(tuple(
            t[r0:r0 + nl, m * dl:(m + 1) * dl].to(
                grid[d, m], non_blocking=True).contiguous()
            for m in range(n_model)))
    return Sharded(blocks=tuple(blocks), shape=(rows, cols),
                   row_split=row_split)


def shard_rows(x, grid: np.ndarray) -> Sharded:
    """Row-shard ``x`` (numpy or a tensor, rows divisible by n_data,
    columns by n_model) over an ``(n_data, n_model)`` device grid."""
    return _layout(x, grid, row_split=True)


def replicate(x, grid: np.ndarray) -> Sharded:
    """Every data position holds all rows of ``x``; columns shard over
    the model positions."""
    return _layout(x, grid, row_split=False)


def _received(traffic: Optional[List[int]], pos: int, nbytes: int) -> None:
    if traffic is not None:
        traffic[pos] += int(nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather(shards: Sequence[torch.Tensor], devices: Sequence,
               traffic: Optional[List[int]] = None) -> List[torch.Tensor]:
    """Tiled all-gather: position i gets every shard, concatenated along
    rows in position order, on ``devices[i]``."""
    out = []
    for i, dev in enumerate(devices):
        out.append(torch.cat([s.to(dev, non_blocking=True) for s in shards],
                             dim=0))
        _received(traffic, i, sum(_nbytes(s) for j, s in enumerate(shards)
                                  if j != i))
    return out


def ppermute(shards: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]],
             devices: Sequence,
             traffic: Optional[List[int]] = None) -> List[torch.Tensor]:
    """Send ``shards[src]`` to position ``dst`` for each ``(src, dst)`` of
    ``perm``; a position that receives nothing gets zeros, as
    ``jax.lax.ppermute`` gives it."""
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    for src, dst in perm:
        out[dst] = shards[src].to(devices[dst], non_blocking=True)
        if src != dst:
            _received(traffic, dst, _nbytes(shards[src]))
    return [torch.zeros_like(shards[i]) if t is None else t
            for i, t in enumerate(out)]


def psum(shards: Sequence[torch.Tensor],
         devices: Sequence) -> List[torch.Tensor]:
    """All-reduce sum: every position gets the sum of all shards, added in
    position order on ``devices[0]`` and copied back (a reduce and a
    broadcast; the executor's ``psum_bytes`` counter keeps the
    reference's ring all-reduce accounting)."""
    total = shards[0].to(devices[0], non_blocking=True)
    for s in shards[1:]:
        total = total + s.to(devices[0], non_blocking=True)
    return [total] + [total.to(dev, non_blocking=True)
                      for dev in devices[1:]]


def axis_index(mesh: Mesh, axis: str) -> np.ndarray:
    """Each mesh position's coordinate along ``axis``, shaped like
    ``mesh.devices`` (``jax.lax.axis_index`` evaluated at every
    position)."""
    return np.indices(mesh.devices.shape)[mesh.axis_names.index(axis)]


# ---------------------------------------------------------------------------
# Model-side partition specs (reference sharding.py:59-305)
# ---------------------------------------------------------------------------

class P(tuple):
    """A partition spec: one entry per leading dim (an axis name, a tuple
    of axis names, or None), as ``jax.sharding.PartitionSpec(*entries)``;
    the dims past its length are unsharded. A one-name tuple is stored as
    the name, as ``PartitionSpec`` stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)}"


def _filter_spec(spec: Tuple, axes: Tuple[str, ...]) -> P:
    """Drop mesh axes that do not exist in ``axes`` (lets the same rules
    serve the (data, model) single-pod and (pod, data, model) multi-pod
    meshes and the 1-device test mesh), and trailing Nones."""
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in axes)
            out.append(kept if kept else None)
        else:
            out.append(entry if entry in axes else None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _axes_size(mesh, entry) -> int:
    names = entry if isinstance(entry, tuple) else (entry,)
    return int(np.prod([mesh.shape[a] for a in names]))


def shard_shape(shape: Sequence[int], spec: Sequence, mesh) -> Tuple[int, ...]:
    """Per-device sizes of an array of ``shape`` laid out by ``spec`` over
    ``mesh``; raises if an axis does not divide its dim."""
    out = list(shape)
    if len(spec) > len(out):
        raise ValueError(f"spec {spec} has more entries than {tuple(shape)} "
                         "has dims")
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        n = _axes_size(mesh, entry)
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not shard over "
                             f"{entry} ({n} devices)")
        out[i] //= n
    return tuple(out)


class Record(NamedTuple):
    """One hook call inside a mesh context: the tensor's shape, its dtype's
    name (``"float32"``, ``"int32"``) and the spec filtered by the active
    mesh's axes."""
    shape: Tuple[int, ...]
    dtype: str
    spec: P


@dataclass(frozen=True)
class MeshContext:
    """What :func:`set_mesh` makes active: the mesh and the records of the
    hook calls made inside it, in call order."""
    mesh: Any
    records: List[Record] = field(default_factory=list)


_CONTEXT: ContextVar[Optional[MeshContext]] = ContextVar(
    "repro_torch_mesh_context", default=None)


@contextmanager
def set_mesh(mesh) -> Iterator[Optional[MeshContext]]:
    """Make ``mesh`` (a :class:`Mesh` or an :class:`AbstractMesh`) the
    active mesh inside the ``with`` block, as ``jax.set_mesh``; yields
    the :class:`MeshContext` whose ``records`` the hooks append to.
    ``None`` makes no mesh active (the hooks only check ranks). Nests;
    the outer context (or none) is restored on exit and on an exception.
    A ``ContextVar``: another thread does not see this context."""
    if mesh is not None and not hasattr(mesh, "axis_names"):
        raise TypeError(f"set_mesh takes a Mesh, an AbstractMesh or None, "
                        f"not {type(mesh).__name__}")
    ctx = None if mesh is None else MeshContext(mesh)
    token = _CONTEXT.set(ctx)
    try:
        yield ctx
    finally:
        _CONTEXT.reset(token)


def get_mesh():
    """The active mesh, or None outside a :func:`set_mesh` context."""
    ctx = _CONTEXT.get()
    return None if ctx is None else ctx.mesh


def _check_rank(x, n: int) -> None:
    if n > len(x.shape):
        raise ValueError(f"a spec of {n} entries does not fit a tensor of "
                         f"{len(x.shape)} dims")


def constrain(x, *spec):
    """The reference's ``with_sharding_constraint`` hook. Returns ``x``
    itself: the port runs no SPMD program, and a constraint moves layout,
    never values. Inside a :func:`set_mesh` context it appends the
    :class:`Record` of ``x`` and ``spec`` filtered by the mesh's axes, as
    the reference constrains to that filtered spec; outside one it only
    checks that the spec fits ``x``'s rank (``x`` a tensor or an array)."""
    _check_rank(x, len(spec))
    ctx = _CONTEXT.get()
    if ctx is not None:
        ctx.records.append(Record(
            tuple(int(n) for n in x.shape),
            str(x.dtype).removeprefix("torch."),
            _filter_spec(spec, tuple(ctx.mesh.axis_names))))
    return x


def act_constrain(x, mode: str):
    """Layer-boundary activation constraint for a (B, S, d) tensor
    ("seq": S over model, "d": d over model, "full_dp": the batch over
    every axis, else the batch over the DP axes); returns ``x``."""
    if mode == "seq":
        return constrain(x, DP_AXES, TP_AXIS, None)
    if mode == "d":
        return constrain(x, DP_AXES, None, TP_AXIS)
    if mode == "full_dp":
        return constrain(x, DP_AXES + (TP_AXIS,), None, None)
    return constrain(x, DP_AXES, None, None)


def attn_logits_constrain(x):
    """(B, G, KV, Q, S) attention logits over the model axis; returns
    ``x``. The reference's order: the group dim when tp divides it (the
    g-major head layout makes that the common case), else the kv dim,
    else the key dim (split-K), else the batch only. No record outside a
    context, without a ``model`` axis, or at tp 1."""
    _check_rank(x, 5)
    mesh = get_mesh()
    if mesh is None or TP_AXIS not in mesh.axis_names:
        return x
    tp = mesh.shape[TP_AXIS]
    if tp <= 1:
        return x
    _, g, kv, _, s = x.shape
    if g % tp == 0:
        return constrain(x, DP_AXES, TP_AXIS, None, None, None)
    if kv % tp == 0:
        return constrain(x, DP_AXES, None, TP_AXIS, None, None)
    if s % tp == 0:
        return constrain(x, DP_AXES, None, None, None, TP_AXIS)
    return constrain(x, DP_AXES, None, None, None, None)


# (path-regex, spec for the *last* ndim dims). First match wins.
_RULES = [
    # --- MoE experts: (E, d, f) — EP over model, FSDP on d ---
    (r"experts.*(w_gate|w_up)", (TP_AXIS, DP_AXES, None)),
    (r"experts.*w_down", (TP_AXIS, None, DP_AXES)),
    (r"router", (DP_AXES, None)),
    # --- embeddings / lm head ---
    (r"embed", (DP_AXES, TP_AXIS)),
    (r"(^|/)head", (DP_AXES, TP_AXIS)),
    (r"vis_proj", (DP_AXES, TP_AXIS)),
    # --- attention ---
    (r"wq|wk|wv|w_qkv", (DP_AXES, TP_AXIS)),
    (r"wo", (TP_AXIS, DP_AXES)),
    (r"b[qkv]$", (TP_AXIS,)),
    # --- dense FFN ---
    (r"w_gate|w_up|w_in|fc1", (DP_AXES, TP_AXIS)),
    (r"w_down|w_out|fc2", (TP_AXIS, DP_AXES)),
    # --- rwkv6 time-mix / channel-mix ---
    (r"(w_r|w_k|w_v|w_g)$", (DP_AXES, TP_AXIS)),
    (r"w_wkv_out", (TP_AXIS, DP_AXES)),
    (r"w_decay$", (DP_AXES, TP_AXIS)),
    (r"w_decay_b", (TP_AXIS,)),
    (r"cm_(k|r)", (DP_AXES, TP_AXIS)),
    (r"cm_v", (TP_AXIS, DP_AXES)),
    # --- mamba2 ---
    (r"in_proj", (DP_AXES, TP_AXIS)),
    (r"out_proj", (TP_AXIS, DP_AXES)),
    (r"conv_w", (TP_AXIS, None)),
    (r"(A_log|D$|dt_bias|conv_b)", (TP_AXIS,)),
]


def param_spec(path: str, ndim: int, stacked: int) -> Tuple:
    """Spec entries (one per dim) for one param leaf of ``ndim`` dims, by
    its reference path (``layers/wq``). ``stacked`` = number of leading
    layer-stack dims: 0 for every leaf of the port's tree."""
    eff = ndim - stacked
    lead = (None,) * stacked
    for pat, spec in _RULES:
        if re.search(pat, path):
            if len(spec) == eff:
                return lead + tuple(spec)
            # bias-like reduced rank: keep the last axes of the rule
            if eff == 1 and len(spec) >= 1:
                return lead + (spec[-1],)
    return (None,) * ndim  # norms, scalars: replicated


def reference_path(name: str) -> str:
    """A port parameter name as the reference's params path: the layer
    indices dropped, ``/``-joined (``layers.3.experts.w_gate`` →
    ``layers/experts/w_gate``; ``blocks.7.in_proj`` → ``blocks/in_proj``)."""
    return "/".join(part for part in name.split(".") if not part.isdigit())


def param_shardings(params, mesh) -> Dict[str, P]:
    """{name: spec} for a model (an ``nn.Module``) or a mapping name →
    tensor, over ``mesh`` (an :class:`AbstractMesh` or a :class:`Mesh`).
    A dim that its axes do not divide stays unsharded."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    axes = tuple(mesh.axis_names)
    out = {}
    for name, t in params.items():
        shape = tuple(t.shape)
        spec = param_spec(reference_path(name), len(shape), 0)
        sized = []
        for dim, entry in zip(shape, spec):
            names = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            names = tuple(a for a in names if a in axes)
            if names and dim % _axes_size(mesh, names) == 0:
                sized.append(names if len(names) > 1 else names[0])
            else:
                sized.append(None)
        out[name] = _filter_spec(tuple(sized), axes)
    return out


_CACHE_RULES = [
    # (pattern, spec-for-trailing-dims after the leading layer-stack dim)
    (r"^(k|v|xk|xv)$", ("B", "S", TP_AXIS, None)),       # (L, B, S, KV, hd)
    (r"^wkv$", ("B", TP_AXIS, None, None)),              # (L, B, H, hd, hd)
    (r"^(tm_x|cm_x)$", ("B", TP_AXIS)),                  # (L, B, d)
    (r"^ssm$", (None, "B", TP_AXIS, None, None)),        # (nsup, every, B, nh, hd, ds)
    (r"^conv$", (None, "B", None, TP_AXIS)),             # (nsup, every, B, K-1, C)
]


def _dp_size(mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in DP_AXES
                        if a in mesh.axis_names]))


def _tp_size(mesh) -> int:
    return mesh.shape[TP_AXIS] if TP_AXIS in mesh.axis_names else 1


def _cache_leaf_spec(name: str, shape, mesh, batch_ok: bool) -> P:
    axes = tuple(mesh.axis_names)
    dp, tp = _dp_size(mesh), _tp_size(mesh)
    for pat, rule in _CACHE_RULES:
        if not re.search(pat, name):
            continue
        spec = [None]  # leading layer-stack dim
        dims = shape[1:]
        if rule[0] == "B" and rule[1] == "S":   # k/v caches
            s_dim, h_dim = dims[1], dims[2]
            heads_ok = tp > 1 and h_dim % tp == 0
            # batch → dp; kv-heads → model when divisible, else the
            # sequence takes the model axis (split-K); batch 1 puts dp on
            # the sequence (context parallelism)
            seq_axes = []
            if batch_ok:
                spec.append(DP_AXES)
            else:
                spec.append(None)
                if dp > 1:
                    seq_axes += [a for a in DP_AXES if a in axes]
            if not heads_ok and TP_AXIS in axes and tp > 1:
                seq_axes.append(TP_AXIS)
            sz = int(np.prod([mesh.shape[a] for a in seq_axes])) \
                if seq_axes else 1
            if seq_axes and s_dim % sz == 0:
                spec.append(tuple(seq_axes) if len(seq_axes) > 1
                            else seq_axes[0])
            else:
                spec.append(None)
            spec.append(TP_AXIS if heads_ok else None)
            spec.append(None)
            return _filter_spec(tuple(spec), axes)
        for dim, entry in zip(dims, rule):
            if entry == "B":
                spec.append(DP_AXES if batch_ok else None)
            elif entry == TP_AXIS:
                spec.append(TP_AXIS if (tp > 1 and dim % tp == 0) else None)
            else:
                spec.append(None)
        return _filter_spec(tuple(spec), axes)
    return P()  # pos and the like


def cache_shardings(cache: Mapping[str, Any], mesh,
                    batch_size: int) -> Dict[str, P]:
    """{name: spec} for a serve cache dict (tensors or shapes; ``pos`` an
    int). 'B' entries shard the batch over (pod, data) when divisible; a
    k/v cache whose batch cannot shard (long_500k, batch 1) puts the dp
    axes on the sequence dim instead — context parallelism."""
    dp = _dp_size(mesh)
    batch_ok = dp > 1 and batch_size % dp == 0
    return {name: _cache_leaf_spec(name, tuple(getattr(v, "shape", ())),
                                   mesh, batch_ok)
            for name, v in cache.items()}


def batch_spec(mesh) -> P:
    """Token batches: batch dim over (pod, data)."""
    return _filter_spec((DP_AXES,), tuple(mesh.axis_names))


def cache_spec(mesh, n_kv_heads: int, batch_size: int) -> P:
    """KV cache (L, B, S, KV, hd): B over (pod, data) when divisible,
    kv-heads over model when divisible; else sequence over model."""
    axes = tuple(mesh.axis_names)
    dp, tp = _dp_size(mesh), _tp_size(mesh)
    b_entry = DP_AXES if batch_size % max(dp, 1) == 0 and dp > 1 else None
    if n_kv_heads % max(tp, 1) == 0 and tp > 1:
        spec = (None, b_entry, None, TP_AXIS, None)
    else:
        spec = (None, b_entry, TP_AXIS, None, None)  # context-parallel seq
    return _filter_spec(spec, axes)
