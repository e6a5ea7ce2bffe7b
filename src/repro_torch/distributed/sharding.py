"""Logical-axis sharding rules, and multi-switch (S-axis) sharding over a
mesh of torch devices: the counterpart of ``repro/distributed/sharding.py``.

**The spec half** (``_PARAM_RULES`` to ``fake_device_mesh``): ``repro``'s
MaxText-style rules for params, inputs and caches on the production mesh
(``data`` 16 × ``model`` 16, optionally ``pod`` 2): batch over
("pod","data"); params FSDP over ``data`` on the d_model dim and TP over
``model`` on one output dim, with divisibility-checked fallbacks; KV
caches batch over ``data`` and kv-heads (else the sequence) over
``model``. Here they are a resolver over axis sizes (a mapping of axis
name to size, anything with ``axis_names`` and ``devices.shape``, or a
torch ``DeviceMesh``), which returns one tuple per tensor dim, each entry
``None``, an axis name or a tuple of names: ``repro``'s ``PartitionSpec``
padded with ``None`` to the tensor's rank. :func:`to_placements` turns a
spec into DTensor placements (``Shard(dim)`` or ``Replicate()`` per mesh
axis) and :func:`to_named` places a tree by a spec tree, ``repro``'s
``to_named`` (a ``NamedSharding`` per leaf); :func:`named_shardings` gives
the tree of :class:`NamedSharding` records itself, which a checkpoint
restore places by (``checkpoint.ckpt.restore_checkpoint(shardings=...)``).
:func:`fake_device_mesh`
stands one process in for every rank of a production mesh (PyTorch's
``fake`` process group, ``repro``'s 512 placeholder host devices):
``launch/dryrun.py`` runs each step there on meta DTensors, and
``layers.constrain`` redistributes activations to their specs.

**The multi-switch half** (``switch_mesh``, ``vecsim_mesh``,
``olaf_combine_sharded``, ``olaf_step_sharded``):

The fused kernels batch independent queues on a leading S axis, one per
switch. On one device the axis folds into one launch; over a mesh it is
split into contiguous blocks, one per device, and each device runs its
block's launch. ``repro`` does this with ``shard_map`` from one controller
over ``jax.devices()``; here one process walks the mesh's devices in turn.
A :class:`Mesh` is a numpy object array of ``torch.device`` with axis
names, read like ``jax.sharding.Mesh``. An explicit device list may name
one device more than once (the counterpart of ``repro``'s forced host
device count): every shard then runs on that device, one after another,
with the same results as on separate cards.

The collectives :func:`all_gather` and :func:`psum` work on a list of
per-shard tensors; :func:`all_gather` always returns a fresh tensor, never
a view of a part (``x.to(dev)`` returns ``x`` itself when it is already
there, ROADMAP hazard H10).
"""
from __future__ import annotations

import contextlib
import math
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.olaf_queue import TorchQueueState
from repro_torch.device import resolve_device
from repro_torch.models.module import tree_paths

# ---------------------------------------------------------------------------
# The spec half: params, inputs and caches
# ---------------------------------------------------------------------------
Spec = Tuple[Any, ...]  # one entry per dim: None, an axis name, or a tuple

# dim annotation -> ordered candidate mesh-axis names
FSDP = ("data",)
TP = ("model",)
NONE: Tuple[str, ...] = ()

# (path regex, per-dim candidates, priority order of dims for resolution),
# ``repro``'s table: dims are those of the unstacked tensor; a leading layer
# axis is detected by the rank and gets no sharding; None replicates
_PARAM_RULES: List[Tuple[str, Optional[Tuple[Tuple[str, ...], ...]],
                         Tuple[int, ...]]] = [
    (r"embedding/embed$",        (TP, FSDP),           (0, 1)),
    (r"embedding/unembed$",      (FSDP, TP),           (1, 0)),
    (r"patch_proj$",             (FSDP, TP),           (1, 0)),
    (r"attn/wq$",                (FSDP, TP, NONE),     (1, 0)),
    (r"attn/wk$",                (FSDP, TP, NONE),     (1, 0)),
    (r"attn/wv$",                (FSDP, TP, NONE),     (1, 0)),
    (r"attn/wo$",                (TP, NONE, FSDP),     (0, 2)),
    (r"mlp/wg$",                 (FSDP, TP),           (1, 0)),
    (r"mlp/wu$",                 (FSDP, TP),           (1, 0)),
    (r"mlp/wd$",                 (TP, FSDP),           (0, 1)),
    (r"moe/router$",             (FSDP, NONE),         (0,)),
    (r"moe/wg$",                 (TP, FSDP, TP),       (0, 2, 1)),
    (r"moe/wu$",                 (TP, FSDP, TP),       (0, 2, 1)),
    (r"moe/wd$",                 (TP, TP, FSDP),       (0, 1, 2)),
    (r"moe/dense/w[gud]$",       (FSDP, TP),           (1, 0)),
    (r"ssm/w[zx]$",              (FSDP, TP),           (1, 0)),
    (r"ssm/w(B|C|dt)$",          (FSDP, NONE),         (0,)),
    (r"ssm/wo$",                 (TP, FSDP),           (0, 1)),
    (r"ssm/conv_[wb]$",          None,                 ()),
    (r"ssm/(A_log|dt_bias|D|norm_scale)$", None,       ()),
    (r"rec/w_(gate|rec)_branch$", (FSDP, TP),          (1, 0)),
    (r"rec/w_[ax]$",             (FSDP, TP),           (1, 0)),
    (r"rec/conv_[wb]$",          None,                 ()),
    (r"rec/lam$",                None,                 ()),
    (r"rec/wo$",                 (TP, FSDP),           (0, 1)),
    (r"(ln1|ln2|ln_x|final_norm|enc_final|dec_final|norm)/", None, ()),
    (r"(scale|bias)$",           None,                 ()),
]

_ATTN_PAT = re.compile(r"(attn)/w[qkvo]$")


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mapping, of a mesh (``axis_names`` and
    ``devices.shape``: this module's :class:`Mesh` or ``repro``'s), or of a
    torch ``DeviceMesh`` (``mesh_dim_names`` and ``shape``)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _resolve_spec(shape: Sequence[int],
                  dims: Optional[Tuple[Tuple[str, ...], ...]],
                  priority: Tuple[int, ...], sizes: Mapping[str, int],
                  lead_pad: int) -> Spec:
    """At most one mesh axis per tensor dim, honouring divisibility."""
    spec: List[Optional[str]] = [None] * len(shape)
    if dims is None:
        return tuple(spec)
    used: set = set()
    for di in priority:
        idx = di + lead_pad
        if idx >= len(shape):
            continue
        for cand in dims[di]:
            if cand in used or cand not in sizes:
                continue
            if shape[idx] % sizes[cand] == 0 and shape[idx] > 0:
                spec[idx] = cand
                used.add(cand)
                break
    return tuple(spec)


def params_pspecs(param_tree, mesh) -> Any:
    """A params tree (tensors, meta or not) -> a tree of per-dim specs."""
    sizes = axis_sizes(mesh)
    specs: Dict[str, Spec] = {}
    for path, leaf in tree_paths(param_tree).items():
        shape = tuple(leaf.shape)
        specs[path] = (None,) * len(shape)  # unmatched: replicate
        for pat, dims, prio in _PARAM_RULES:
            if re.search(pat, path):
                lead = len(shape) - len(dims) if dims else 0
                specs[path] = _resolve_spec(shape, dims, prio, sizes, lead)
                break
    return _unflatten_like(param_tree, specs)


def params_pspecs_cfg(param_tree, mesh, cfg) -> Any:
    """:func:`params_pspecs`, with the TP entries stripped from attention
    weights when ``cfg.attn_mode == "replicated"`` (tiny-head archs whose
    attention is replicated over the model axis)."""
    specs = params_pspecs(param_tree, mesh)
    if cfg is None or cfg.attn_mode != "replicated":
        return specs
    flat = tree_paths_like(specs)
    return _unflatten_like(param_tree, {
        path: (tuple(a if a == "data" else None for a in spec)
               if _ATTN_PAT.search(path) else spec)
        for path, spec in flat.items()})


def tree_paths_like(spec_tree) -> Dict[str, Spec]:
    """A spec tree flattened to {'a/b/c': spec} (dicts only: a spec is a
    tuple, so it is a leaf here)."""
    flat: Dict[str, Spec] = {}

    def rec(t, prefix=""):
        if isinstance(t, dict):
            for k, v in t.items():
                rec(v, f"{prefix}/{k}" if prefix else k)
        else:
            flat[prefix] = t

    rec(spec_tree)
    return flat


def _unflatten_like(tree, flat_specs: Dict[str, Spec], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, flat_specs,
                                   f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(v, flat_specs, f"{prefix}/{i}")
                          for i, v in enumerate(tree))
    return flat_specs[prefix]


def batch_axes(mesh) -> Tuple[str, ...]:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _shardable(size: int, mesh, axes: Tuple[str, ...]) -> bool:
    sizes = axis_sizes(mesh)
    n = int(np.prod([sizes[a] for a in axes]))
    return size % n == 0 and size >= n


def _entry(axes: Tuple[str, ...]):
    """A spec entry naming ``axes``: one name stands alone, as
    ``PartitionSpec`` normalises ("data",) to "data"."""
    return axes[0] if len(axes) == 1 else axes


def data_pspecs(specs: Dict[str, Any], mesh, cfg) -> Dict[str, Any]:
    """Specs of a train/prefill/decode input dict (``api.input_specs``):
    the batch dim over the batch axes where divisible, else ``data``."""
    ba = batch_axes(mesh)
    out: Dict[str, Any] = {}
    for name, leaf in specs.items():
        if name == "caches":
            out[name] = cache_pspecs(leaf, mesh, cfg)
            continue
        shape = tuple(leaf.shape)
        b_spec = (_entry(ba) if _shardable(shape[0], mesh, ba)
                  else "data" if _shardable(shape[0], mesh, ("data",))
                  else None)
        out[name] = (b_spec,) + (None,) * (len(shape) - 1)
    return out


def cache_pspecs(cache_tree, mesh, cfg) -> Any:
    """KV caches: batch over data (+pod), kv-heads over model if divisible,
    else the sequence (sequence-parallel decode). Recurrent states: batch
    over data, channels or head dims over model where divisible. A stacked
    layer axis leads under ``layers/`` and on encdec's ``self_``/``cross_``
    leaves."""
    ba = batch_axes(mesh)
    msize = axis_sizes(mesh).get("model", 1)

    def leaf_spec(path: str, leaf) -> Spec:
        shape = tuple(leaf.shape)
        name = path.split("/")[-1]
        lead = 1 if (path.startswith("layers/")
                     or name.startswith(("self_", "cross_"))) else 0
        spec: List[Any] = [None] * len(shape)
        if _shardable(shape[lead], mesh, ba):
            spec[lead] = _entry(ba)
        elif _shardable(shape[lead], mesh, ("data",)):
            spec[lead] = "data"
        if name in ("k", "v", "self_k", "self_v", "cross_k", "cross_v"):
            kv_idx, s_idx = lead + 2, lead + 1
            if shape[kv_idx] % msize == 0:
                spec[kv_idx] = "model"
            elif shape[s_idx] % msize == 0:
                spec[s_idx] = "model"  # sequence-parallel cache
        elif name == "state":  # SSD state (B, H, P, N)
            for idx in (lead + 1, lead + 2):
                if shape[idx] % msize == 0:
                    spec[idx] = "model"
                    break
        elif name == "h":  # RG-LRU state (B, w)
            if shape[lead + 1] % msize == 0:
                spec[lead + 1] = "model"
        elif name == "conv":  # (B, K-1, C)
            if shape[lead + 2] % msize == 0:
                spec[lead + 2] = "model"
        return tuple(spec)

    return _unflatten_like(cache_tree, {p: leaf_spec(p, x) for p, x in
                                        tree_paths(cache_tree).items()})


def out_pspecs_for(kind: str, mesh, cfg, in_specs, data_specs):
    """Out specs are assembled per step type by the dry run, as in
    ``repro``, which leaves this unimplemented too."""
    raise NotImplementedError


def to_placements(spec: Optional[Spec], axis_names: Sequence[str],
                  sizes: Optional[Sequence[int]] = None) -> tuple:
    """A per-dim spec as DTensor placements over a mesh whose axes are
    ``axis_names``: ``Shard(d)`` on each axis that dim ``d``'s entry names
    (a tuple such as ``("pod", "data")`` shards one dim over both, the
    first axis major, as a ``PartitionSpec`` does), ``Replicate()`` on the
    rest. ``None`` (no spec) replicates. Given the axes' ``sizes``, an axis
    of one rank replicates (a shard over one rank is the whole tensor, and
    some torch versions refuse views of it)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(axis_names)
    seen = set()
    for d, entry in enumerate(spec or ()):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            if a in seen:
                raise ValueError(f"axis {a!r} named twice in {spec}")
            seen.add(a)
            i = axis_names.index(a)
            if sizes is None or sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


class NamedSharding:
    """``jax.sharding.NamedSharding``'s counterpart: a torch ``DeviceMesh``
    and a per-dim spec (a tuple of this module's entries; ``None`` or
    ``()`` replicates). A shardings tree of these places what
    ``checkpoint.ckpt.restore_checkpoint(shardings=..., opt_shardings=...)``
    restores. A plain class, neither a tuple nor a dataclass, so the tree
    walks of ``models.module`` take it as a leaf."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: Optional[Spec]):
        self.mesh = mesh
        self.spec = tuple(spec or ())

    def placements(self) -> tuple:
        """The spec as DTensor placements over :attr:`mesh`
        (:func:`to_placements`, an axis of one rank replicated)."""
        return to_placements(self.spec, tuple(self.mesh.mesh_dim_names),
                             tuple(self.mesh.shape))

    def place(self, x: torch.Tensor, src_data_rank: Optional[int] = 0):
        """``x`` distributed over :attr:`mesh`: from ``src_data_rank``'s
        copy (a collective, every rank calls it), or, with ``None``, each
        rank's shard cut from its own ``x`` (no communication: every rank
        holds the same values)."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(x, self.mesh, self.placements(),
                                 src_data_rank=src_data_rank)

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh == self.mesh
                and other.spec == self.spec)

    def __hash__(self) -> int:
        return hash((self.mesh, self.spec))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _map_specs(fn, tree, spec_tree):
    """``fn(leaf, spec)`` over ``tree`` (a dict, tuple or ``NamedTuple`` of
    tensors) and the spec tree of the same structure; ``None`` stays."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, spec_tree[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_specs(fn, v, s)
                            for v, s in zip(tree, spec_tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v, s)
                          for v, s in zip(tree, spec_tree))
    return fn(tree, spec_tree)


def named_shardings(tree, spec_tree, device_mesh):
    """``repro``'s ``to_named`` of a spec tree: a :class:`NamedSharding`
    over ``device_mesh`` per leaf of ``tree`` (which gives the structure:
    a spec is itself a tuple)."""
    return _map_specs(lambda _, spec: NamedSharding(device_mesh, spec),
                      tree, spec_tree)


def to_named(tree, spec_tree, device_mesh):
    """``repro``'s ``to_named``, applied: each leaf of ``tree`` (a dict,
    tuple or ``NamedTuple`` of tensors, meta or not) distributed over the
    torch ``device_mesh`` by its spec in ``spec_tree`` (a tree of the same
    structure). Returns the same tree of DTensors; a ``None`` leaf stays
    ``None``."""
    return _map_specs(
        lambda x, spec: NamedSharding(device_mesh, spec).place(x),
        tree, spec_tree)


@contextlib.contextmanager
def fake_device_mesh(sizes: Mapping[str, int]):
    """A torch ``DeviceMesh`` of ``sizes`` (``{axis name: size}`` in axis
    order) over PyTorch's ``fake`` process group of ``prod(sizes)`` ranks,
    this process rank 0: one process stands in for every rank. Collectives
    on it move nothing and return no real values (ROADMAP hazard H30), so
    it serves shapes, placements, the collectives' plan and memory, never
    a comparison of values. The group is destroyed on exit, after an
    error too. Refuses to open while a process group is initialized."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_device_mesh: a process group is already "
                           "initialized in this process")
    names, shape = tuple(sizes), tuple(int(n) for n in sizes.values())
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The multi-switch half: a mesh of torch devices
# ---------------------------------------------------------------------------


class Mesh:
    """A named grid of devices: ``devices`` is a numpy object array of
    ``torch.device`` whose axes ``axis_names`` names, in order."""

    def __init__(self, devices, axis_names: Sequence[str]):
        shape = np.shape(np.asarray(devices, dtype=object))
        flat = [_norm(d) for d in np.asarray(devices, dtype=object).flat]
        self.devices = _object_array(flat).reshape(shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> List[torch.device]:
        return list(self.devices.flat)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def _object_array(devs: Sequence[torch.device]) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = list(devs)
    return arr


def _norm(device) -> torch.device:
    """``device`` resolved (no silent fallback); a bare ``cuda`` gets the
    current card's index, so it compares equal to a tensor's device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices() -> List[torch.device]:
    """Every visible card, as ``jax.devices()`` lists every device. Raises
    without a card: a CPU mesh is asked for with an explicit device list."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is available for the mesh; pass "
                           "an explicit device list (e.g. ['cpu'] * 4) to "
                           "run the shards on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def device_list(devices=None) -> List[torch.device]:
    """``devices`` resolved one by one (repeats kept), or every visible
    card when None."""
    if devices is None:
        return visible_devices()
    return [_norm(d) for d in devices]


def switch_mesh(n_switches, devices=None) -> Mesh:
    """1-D mesh on axis ``"switch"`` sized to the largest divisor of
    ``n_switches`` that the devices support. Accepts the switch count or a
    ``TopologySpec`` (anything with ``num_switches``); ``devices`` defaults
    to every visible card."""
    n_switches = int(getattr(n_switches, "num_switches", n_switches))
    devs = device_list(devices)
    n = 1
    for d in range(min(n_switches, len(devs)), 0, -1):
        if n_switches % d == 0:
            n = d
            break
    return Mesh(_object_array(devs[:n]), ("switch",))


def _pow2_at_most(n: int) -> int:
    return 1 << max(int(n), 1).bit_length() - 1


def vecsim_mesh(n_switches=None, *, n_clusters: Optional[int] = None,
                worker_shards: int = 1, devices=None) -> Mesh:
    """2-D ``("switch", "worker")`` mesh for the sharded vectorized
    simulator (:func:`repro_torch.core.vecsim.run_vecsim` with ``mesh=``):
    per-switch state over ``"switch"``, worker generation / txctl / AoM
    state over ``"worker"``. Shard counts are powers of two, which divide
    the simulator's power-of-two padded axes: the worker axis gets at most
    ``worker_shards`` devices (capped by ``n_clusters`` so the AoM rows
    still split), the switch axis the largest power of two that fits the
    remaining devices and the switch count. ``devices`` defaults to every
    visible card."""
    n_switches = int(getattr(n_switches, "num_switches", n_switches or 1))
    devs = device_list(devices)
    nw = _pow2_at_most(min(worker_shards, len(devs)))
    if n_clusters is not None:
        nw = min(nw, _pow2_at_most(n_clusters))
    ns = _pow2_at_most(min(n_switches, len(devs) // nw))
    return Mesh(_object_array(devs[:ns * nw]).reshape(ns, nw),
                ("switch", "worker"))


# ---------------------------------------------------------------------------
# collectives over a list of per-shard tensors
# ---------------------------------------------------------------------------
def all_gather(parts: Sequence[torch.Tensor], dim: int = 0,
               device=None) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)`` over the shards of one mesh axis:
    the parts concatenated along ``dim`` in shard order, on ``device``
    (default the first part's). Always a fresh tensor: a one-part gather is
    a copy, never the part itself. Dtypes are kept."""
    device = parts[0].device if device is None else device
    if len(parts) == 1:
        return parts[0].to(device, copy=True)
    return torch.cat([p.to(device) for p in parts], dim=dim)


def psum(parts: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """``lax.psum`` of per-shard values as an exact int32 sum (a bool part
    counts 0 or 1), on ``device`` (default the first part's)."""
    device = parts[0].device if device is None else device
    return torch.stack([p.to(device).to(torch.int32) for p in parts]).sum(
        0, dtype=torch.int32)


def _blocks(n: int, mesh: Mesh, what: str) -> Tuple[List[torch.device], int]:
    devs = mesh.device_list()
    if n % len(devs):
        raise ValueError(f"{what}: {n} switches do not split over "
                         f"{len(devs)} devices")
    return devs, n // len(devs)


def olaf_combine_sharded(slots, counts, updates, clusters, gate, *,
                         reset=None, mesh: Optional[Mesh] = None):
    """``ops.olaf_combine_multi`` with the S axis split over the switch
    mesh: one call per shard on its device (one kernel launch each on a
    card), the results concatenated on the slots' device. A one-device
    mesh makes the single folded call. ``reset`` (S, Q) bool is the
    optional mask of slots that restart from this window; each shard's
    slice goes to its own call. ``mesh`` defaults to :func:`switch_mesh`
    over every visible card."""
    from repro_torch.kernels import ops
    home = slots.device
    if mesh is None:
        mesh = switch_mesh(slots.shape[0])
    devs, k = _blocks(slots.shape[0], mesh, "olaf_combine_sharded")
    ops_ = [torch.as_tensor(x).to(home) for x in
            (slots, counts, updates, clusters, gate)]
    rs = None if reset is None else torch.as_tensor(reset).to(home)
    outs = [ops.olaf_combine_multi(
                *(x[i * k:(i + 1) * k].to(d) for x in ops_),
                reset=None if rs is None else rs[i * k:(i + 1) * k].to(d))
            for i, d in enumerate(devs)]
    if len(outs) == 1:
        return tuple(o.to(home) for o in outs[0])
    return tuple(torch.cat([o[j].to(home) for o in outs])
                 for j in range(2))


def olaf_step_sharded(states: TorchQueueState, clusters, workers, gen_times,
                      rewards, payloads, reward_threshold=math.inf,
                      send=None, capacities=None, *, k: int,
                      mesh: Optional[Mesh] = None):
    """``ops.olaf_step_multi`` with the S axis split over the switch mesh:
    the full enqueue→drain cycle of every switch, one call per shard on its
    device (one ``olaf_step`` launch each on a card), the new states and
    drained rows concatenated on the queue's device.

    ``capacities`` is an optional ``(S,)`` per-switch slot vector (switches
    of different queue sizes ride one padded ``(S, Qmax)`` state); each
    shard gets its slice. ``reward_threshold`` is a number, or anything
    that broadcasts to ``(S, 1)``, of which each shard reads its first
    row's value, as ``repro``'s ``th[0, 0]``. On a card each call updates
    its shard of the queue in place: treat ``states`` as consumed."""
    from repro_torch.kernels import ops
    home = states.payload.device
    S = states.payload.shape[0]
    if mesh is None:
        mesh = switch_mesh(S)
    devs, n = _blocks(S, mesh, "olaf_step_sharded")
    cap = None if capacities is None else torch.as_tensor(
        capacities, dtype=torch.int32, device=home).expand(S)
    thr = reward_threshold
    if isinstance(thr, (torch.Tensor, np.ndarray)):
        thr = torch.as_tensor(thr, dtype=torch.float32,
                              device=home).broadcast_to((S, 1))
    results = []
    for i, d in enumerate(devs):
        a, b = i * n, (i + 1) * n

        def part(x):
            return None if x is None else x[a:b].to(d)

        st = TorchQueueState(**{f: part(v)
                                for f, v in states.fields().items()})
        th = thr[a, 0].to(d) if isinstance(thr, torch.Tensor) else thr
        results.append(ops.olaf_step_multi(
            st, part(clusters), part(workers), part(gen_times), part(rewards),
            part(payloads), th, part(send), part(cap), k=k))
    if len(results) == 1:
        st, out = results[0]
        return (TorchQueueState(**{f: v.to(home)
                                   for f, v in st.fields().items()}),
                {f: v.to(home) for f, v in out.items()})
    new = TorchQueueState(**{
        f: torch.cat([r[0].fields()[f].to(home) for r in results])
        for f in states.fields()})
    out = {f: torch.cat([r[1][f].to(home) for r in results])
           for f in results[0][1]}
    return new, out
