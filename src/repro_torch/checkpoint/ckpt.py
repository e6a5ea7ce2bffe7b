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


def _to_np(v) -> np.ndarray:
    """A leaf as a host array; bfloat16 widened to float32 (npz has no
    bfloat16)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.to(torch.float32)
        return v.cpu().numpy()
    return np.asarray(v)


def _describe(tree) -> str:
    return f"{type(tree).__name__}[{len(tree_leaves(tree))} leaves]"


def save_checkpoint(directory: str, step: int, params: Any,
                    opt_state: Any = None, extra: Optional[dict] = None,
                    aux: Optional[Dict[str, Any]] = None) -> str:
    """Atomic save of ``params``, ``opt_state`` and the named ``aux`` trees
    (tensors or numpy arrays: queue, txctl, AoM state, host counters);
    returns the checkpoint's path. Reads the tensors back to the host."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    flat = {f"params/{k}": _to_np(v) for k, v in tree_paths(params).items()}
    manifest_opt = None
    if opt_state is not None:
        for i, leaf in enumerate(tree_leaves(opt_state)):
            flat[f"opt/{i}"] = _to_np(leaf)
        manifest_opt = _describe(opt_state)
    aux_manifest = {}
    for name, tree in (aux or {}).items():
        leaves = tree_leaves(tree)
        for i, leaf in enumerate(leaves):
            flat[f"aux/{name}/{i}"] = _to_np(leaf)
        aux_manifest[name] = {"n_leaves": len(leaves),
                              "treedef": _describe(tree)}
    path = d / f"ckpt_{step:08d}.npz"
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
                "opt_treedef": manifest_opt, "aux": aux_manifest,
                "extra": extra or {}}
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


def _restore_leaf(arr: np.ndarray, like):
    """``arr`` shaped and typed as ``like``: a numpy ``like`` gives numpy
    (float64 host counters come back exact), a tensor gives a tensor on
    ``like``'s device."""
    arr = _fit(arr, tuple(like.shape))
    if isinstance(like, np.ndarray):
        return np.asarray(arr, like.dtype)
    return torch.from_numpy(np.array(arr)).to(device=like.device,
                                              dtype=like.dtype)


def restore_checkpoint(directory: str, step: Optional[int] = None, *,
                       params_like: Any, opt_like: Any = None,
                       aux_like: Optional[Dict[str, Any]] = None):
    """Restore the checkpoint of ``step`` (default: the latest) into trees
    shaped like ``params_like``/``opt_like`` and the named ``aux_like``
    trees (tensors or numpy arrays; their dtypes and devices are kept).
    Returns ``(step, params, opt_state)``, or ``(step, params, opt_state,
    aux)`` with ``aux_like``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    with np.load(Path(directory) / f"ckpt_{step:08d}.npz") as data:
        paths = tree_paths(params_like)
        restored = {p: _restore_leaf(data[f"params/{p}"], like)
                    for p, like in paths.items()}
        params = _rebuild(params_like, restored)
        opt_state = None
        if opt_like is not None:
            opt_state = tree_unflatten(opt_like, [
                _restore_leaf(data[f"opt/{i}"], like)
                for i, like in enumerate(tree_leaves(opt_like))])
        if aux_like is None:
            return step, params, opt_state
        aux = {name: tree_unflatten(tree, [
            _restore_leaf(data[f"aux/{name}/{i}"], like)
            for i, like in enumerate(tree_leaves(tree))])
            for name, tree in aux_like.items()}
    return step, params, opt_state, aux


def _rebuild(like, by_path: Dict[str, Any], prefix: str = ""):
    """A nested dict of ``like``'s structure from a ``{path: leaf}`` map."""
    if isinstance(like, dict):
        return {k: _rebuild(v, by_path, f"{prefix}/{k}" if prefix else k)
                for k, v in like.items()}
    return by_path[prefix]
