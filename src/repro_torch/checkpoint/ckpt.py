"""Checkpoint save and restore in ``repro.checkpoint.ckpt``'s file layout.

A checkpoint is ``ckpt_%08d.npz`` holding ``params/<path>`` for every param
leaf (``models.module.tree_paths``), ``opt/<i>`` for the optimizer state's
leaves and ``aux/<name>/<i>`` for each named auxiliary tree, both in
``jax.tree_util``'s leaf order (``models.module.tree_leaves``: an
``OptState``'s step, then m, then v, each by sorted key), plus a JSON
manifest ``ckpt_%08d.json``; ``LATEST`` names the newest step. bfloat16
leaves are stored widened to float32, as ``repro`` stores them. Every file
is written to a temporary name and renamed, and ``LATEST`` flips last, so a
killed writer never leaves a step whose files are incomplete. So a
checkpoint written by ``repro`` restores here, and one written here
restores in ``repro``. The manifest's structure strings are the port's own
(``repro`` writes ``jax`` treedefs); neither side reads them back.

Elastic re-mesh, as in ``repro``: a tree of DTensors saves whole (each
leaf gathered by ``full_tensor()``, a collective every rank of its mesh
calls; the mesh's first rank alone writes, and the others wait for it), and
:func:`restore_checkpoint` places each array by ``shardings`` /
``opt_shardings`` (a ``torch.device`` or a
``distributed.sharding.NamedSharding`` per leaf), so a run saved on one mesh
or device restarts on another. The like trees may be meta tensors
(``models.api.param_spec``), ``jax.eval_shape``'s counterpart.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.module import tree_leaves, tree_paths, tree_unflatten


def _atomic_write_text(path: Path, text: str) -> None:
    """tmp + rename so a killed writer never leaves a truncated file."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _dtensor_type():
    from torch.distributed.tensor import DTensor

    return DTensor


def _to_np(v) -> np.ndarray:
    """A leaf as a host array; bfloat16 widened to float32 (npz has no
    bfloat16); a DTensor gathered whole first."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if isinstance(v, _dtensor_type()):
            v = v.full_tensor()
        if v.dtype == torch.bfloat16:
            v = v.to(torch.float32)
        return v.cpu().numpy()
    return np.asarray(v)


def _mesh_barrier(mesh) -> None:
    """Returns on every rank of ``mesh`` only once its first rank has
    entered: a barrier over each mesh dim's group in turn (a rank leaves
    the dim-``d`` barrier after the rank at coordinate 0 of that dim, which
    left the earlier dims' after the first rank)."""
    import torch.distributed as dist

    for d in range(mesh.ndim):
        if mesh.size(d) > 1:
            dist.barrier(group=mesh.get_group(d))


def _describe(tree) -> str:
    return f"{type(tree).__name__}[{len(tree_leaves(tree))} leaves]"


def _entries(params, opt_state, aux):
    """``(file key, leaf)`` in the file's order: ``params/<path>``,
    ``opt/<i>``, ``aux/<name>/<i>``."""
    yield from ((f"params/{k}", v) for k, v in tree_paths(params).items())
    yield from ((f"opt/{i}", v) for i, v in enumerate(tree_leaves(opt_state)))
    for name, tree in (aux or {}).items():
        yield from ((f"aux/{name}/{i}", v)
                    for i, v in enumerate(tree_leaves(tree)))


def save_checkpoint(directory: str, step: int, params: Any,
                    opt_state: Any = None, extra: Optional[dict] = None,
                    aux: Optional[Dict[str, Any]] = None) -> str:
    """Atomic save of ``params``, ``opt_state`` and the named ``aux`` trees
    (tensors, DTensors or numpy arrays: queue, txctl, AoM state, host
    counters); returns the checkpoint's path. Reads the tensors back to the
    host.

    Where the trees hold DTensors, every rank of their mesh must call this
    (each leaf's ``full_tensor()`` is a collective, taken in the file's
    order): the mesh's first rank (rank 0 where the mesh spans the world)
    alone writes the files, and every rank returns only once it has, so no
    two ranks race on ``LATEST``. Only the writer raises a write error."""
    d = Path(directory)
    path = d / f"ckpt_{step:08d}.npz"
    dt = _dtensor_type()
    mesh = next((v.device_mesh for _, v in _entries(params, opt_state, aux)
                 if isinstance(v, dt)), None)
    if mesh is None:
        return _write(d, path, step, params, opt_state, extra, aux)
    import torch.distributed as dist

    try:
        if dist.get_rank() == int(mesh.mesh.flatten()[0]):
            return _write(d, path, step, params, opt_state, extra, aux)
        for _, v in _entries(params, opt_state, aux):
            if isinstance(v, dt):
                v.full_tensor()  # the writer's gathers, in its order
        return str(path)
    finally:
        _mesh_barrier(mesh)


def _write(d: Path, path: Path, step: int, params, opt_state, extra,
           aux) -> str:
    d.mkdir(parents=True, exist_ok=True)
    flat = {k: _to_np(v) for k, v in _entries(params, opt_state, aux)}
    aux_manifest = {name: {"n_leaves": len(tree_leaves(tree)),
                           "treedef": _describe(tree)}
                    for name, tree in (aux or {}).items()}
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz")
    os.close(fd)
    try:
        np.savez(tmp, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    manifest = {"step": step, "n_arrays": len(flat),
                "opt_treedef": (_describe(opt_state) if opt_state is not None
                                else None),
                "aux": aux_manifest, "extra": extra or {}}
    _atomic_write_text(d / f"ckpt_{step:08d}.json", json.dumps(manifest))
    _atomic_write_text(d / "LATEST", str(step))
    return str(path)


def latest_step(directory: str) -> Optional[int]:
    f = Path(directory) / "LATEST"
    if not f.exists():
        return None
    return int(f.read_text().strip())


def read_manifest(directory: str, step: Optional[int] = None) -> dict:
    """The JSON manifest of ``step`` (default: the latest)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    return json.loads((Path(directory) / f"ckpt_{step:08d}.json").read_text())


def _fit(arr: np.ndarray, shape) -> np.ndarray:
    """Pad with zeros / slice so ``arr`` matches ``shape`` (head/vocab
    padding differences between the saving and the restoring run)."""
    if tuple(arr.shape) == tuple(shape):
        return arr
    if arr.ndim != len(shape):
        raise ValueError(f"checkpoint array of shape {arr.shape} cannot "
                         f"fit {tuple(shape)}")
    slices = tuple(slice(0, min(a, b)) for a, b in zip(arr.shape, shape))
    out = np.zeros(shape, arr.dtype)
    out[slices] = arr[slices]
    return out


def _restore_leaf(data, key: str, like, sharding=None):
    """``data[key]`` fitted to ``like``'s shape (:func:`_fit`), cast to its
    dtype and placed: by ``sharding`` (a ``torch.device`` or device
    string, or a ``NamedSharding``: each rank cuts its shard from its own
    copy of the file); without one, a numpy ``like`` gives numpy (float64
    host counters come back exact), a DTensor ``like`` its own mesh and
    placements, any other tensor its device. A meta ``like`` holds no
    device to restore onto, so it needs a sharding."""
    dtensor = isinstance(like, _dtensor_type())
    if sharding is None and not dtensor and getattr(like, "is_meta", False):
        raise ValueError(
            f"restore_checkpoint: {key} has a meta like and no sharding; "
            f"pass shardings= (params) or opt_shardings= (optimizer state): "
            f"a torch.device or a distributed.sharding.NamedSharding per "
            f"leaf")
    arr = _fit(data[key], tuple(like.shape))
    if sharding is None and isinstance(like, np.ndarray):
        return np.asarray(arr, like.dtype)
    t = torch.from_numpy(np.require(arr, requirements=("C", "W")))
    if sharding is None:
        if dtensor:
            from torch.distributed.tensor import distribute_tensor

            return distribute_tensor(t.to(like.dtype), like.device_mesh,
                                     like.placements, src_data_rank=None)
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(sharding, (torch.device, str)):
        return t.to(device=sharding, dtype=like.dtype)
    return sharding.place(t.to(like.dtype), src_data_rank=None)


def _sharding_leaves(shardings, n: int, what: str) -> list:
    """The leaves of a shardings tree (``None``: ``n`` Nones)."""
    if shardings is None:
        return [None] * n
    leaves = tree_leaves(shardings)
    if len(leaves) != n:
        raise ValueError(f"restore_checkpoint: {what} has {len(leaves)} "
                         f"leaves, its like {n}")
    return leaves


def restore_checkpoint(directory: str, step: Optional[int] = None, *,
                       params_like: Any, opt_like: Any = None,
                       shardings: Any = None, opt_shardings: Any = None,
                       aux_like: Optional[Dict[str, Any]] = None):
    """Restore the checkpoint of ``step`` (default: the latest) onto
    (possibly different) shardings: ``repro``'s elastic re-mesh.

    ``params_like``/``opt_like`` give the trees' structure, shapes and
    dtypes (tensors, meta tensors or DTensors); ``shardings``/
    ``opt_shardings``, trees of the same structure, place each leaf (a
    ``torch.device`` or a ``distributed.sharding.NamedSharding``; in a
    process group every rank of the mesh calls this and reads the files).
    An array whose saved shape differs only by head or vocabulary padding
    is zero-padded or sliced to fit. Without a sharding a leaf keeps its
    like's device (and a DTensor like its placements); a meta like without
    one raises ``ValueError``. ``aux_like`` maps names to like trees
    (tensors or numpy arrays) and takes no sharding, as in ``repro``.

    Returns ``(step, params, opt_state)``, or ``(step, params, opt_state,
    aux)`` with ``aux_like``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    with np.load(Path(directory) / f"ckpt_{step:08d}.npz") as data:
        paths = tree_paths(params_like)
        sh = tree_paths(shardings) if shardings is not None else {}
        if shardings is not None and set(sh) != set(paths):
            raise ValueError("restore_checkpoint: shardings do not match "
                             "params_like's paths")
        restored = {p: _restore_leaf(data, f"params/{p}", like, sh.get(p))
                    for p, like in paths.items()}
        params = _rebuild(params_like, restored)
        opt_state = None
        if opt_like is not None:
            likes = tree_leaves(opt_like)
            shs = _sharding_leaves(opt_shardings, len(likes), "opt_shardings")
            opt_state = tree_unflatten(opt_like, [
                _restore_leaf(data, f"opt/{i}", like, s)
                for i, (like, s) in enumerate(zip(likes, shs))])
        if aux_like is None:
            return step, params, opt_state
        aux = {name: tree_unflatten(tree, [
            _restore_leaf(data, f"aux/{name}/{i}", like)
            for i, like in enumerate(tree_leaves(tree))])
            for name, tree in aux_like.items()}
    return step, params, opt_state, aux


def _rebuild(like, by_path: Dict[str, Any], prefix: str = ""):
    """A nested dict of ``like``'s structure from a ``{path: leaf}`` map."""
    if isinstance(like, dict):
        return {k: _rebuild(v, by_path, f"{prefix}/{k}" if prefix else k)
                for k, v in like.items()}
    return by_path[prefix]
