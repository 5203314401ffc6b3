"""Atomic checkpoints of a tree of tensors (port of
``repro.train.checkpoint``).

Layout: ``<dir>/step_<n>/state.npz`` (+ ``meta.json``).

* atomic: written to a tmp dir, then ``os.rename``'d, so a crash mid-save
  never corrupts the latest checkpoint; ``keep`` newest are kept.
* every leaf is stored whole as numpy. numpy has no bfloat16, so a
  bfloat16 leaf is stored as its 16-bit patterns and named in
  ``meta.json``'s ``leaf_dtypes``; it is restored bit for bit.
* :func:`load` restores each leaf in its template leaf's dtype and on its
  device; given ``shardings`` (the elastic re-lay), each leaf becomes a
  DTensor laid out on the current mesh, whatever mesh saved it.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

Tree = Any
_SEP = "/"


def _flatten(tree: Tree, prefix: str = "", is_leaf=lambda x: False
             ) -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a nested dict / list / tuple, dict keys sorted."""
    if is_leaf(tree):
        yield prefix[:-len(_SEP)], tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}{_SEP}", is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}{_SEP}", is_leaf)
    else:
        yield prefix[:-len(_SEP)], tree


def _rebuild(tree: Tree, leaf_fn, prefix: str = "") -> Tree:
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf_fn, f"{prefix}{k}{_SEP}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaf_fn, f"{prefix}{i}{_SEP}")
                          for i, v in enumerate(tree))
    return leaf_fn(prefix[:-len(_SEP)], tree)


def save(ckpt_dir: str | Path, step: int, state: Tree,
         meta: Optional[dict] = None, keep: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays: Dict[str, np.ndarray] = {}
    leaf_dtypes: Dict[str, str] = {}
    for key, leaf in _flatten(state):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.view(torch.int16)
            leaf_dtypes[key] = "bfloat16"
        arrays[key] = leaf.numpy()
    np.savez(tmp / "state.npz", **arrays)
    (tmp / "meta.json").write_text(json.dumps(
        {"step": step, **(meta or {}), "leaf_dtypes": leaf_dtypes},
        indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir())
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
                   if p.is_dir() and (p / "state.npz").exists())
    return steps[-1] if steps else None


def load(ckpt_dir: str | Path, template: Tree, step: Optional[int] = None,
         shardings: Optional[Tree] = None) -> Tuple[Tree, dict]:
    """The checkpoint at ``step`` (default: the latest) in ``template``'s
    structure, each leaf a new tensor in its template leaf's dtype and on
    its device (only those are read). Returns (state, meta).

    ``shardings``, a tree of the template's structure whose leaves are
    :class:`~repro_torch.parallel.sharding.NamedSharding`, re-lays the
    checkpoint on the current mesh: each leaf comes back as a DTensor with
    that sharding's placements, on this rank's device of the mesh's type.
    Each rank reads its own block from the file; no collective runs."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = ckpt_dir / f"step_{step:08d}"
    meta = json.loads((path / "meta.json").read_text())
    leaf_dtypes = meta.get("leaf_dtypes", {})
    lay = None
    if shardings is not None:
        from repro_torch.parallel.sharding import NamedSharding

        lay = dict(_flatten(shardings,
                            is_leaf=lambda x: isinstance(x, NamedSharding)))
    with np.load(path / "state.npz") as z:
        def restore(key, leaf):
            bf16 = leaf_dtypes.get(key) == "bfloat16"
            if lay is None:
                return _from_numpy(z[key], bf16).to(device=leaf.device,
                                                    dtype=leaf.dtype)
            return _relay(z[key], bf16, leaf.dtype, lay[key])

        return _rebuild(template, restore), meta


def _from_numpy(a: np.ndarray, bf16: bool) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.bfloat16) if bf16 else t


def _relay(a: np.ndarray, bf16: bool, dtype: torch.dtype, sharding):
    """This rank's block of the whole leaf ``a`` under ``sharding``, as a
    DTensor of ``a``'s shape on this rank's device of the mesh's type."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.dist import rank_device
    from repro_torch.parallel.sharding import local_block

    shape, offset = local_block(sharding, a.shape)
    block = a[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    kind = sharding.mesh.device_type
    dev = rank_device() if kind == "cuda" else torch.device(kind)
    local = _from_numpy(block, bf16).to(device=dev, dtype=dtype)
    whole = torch.empty(a.shape, device="meta")
    return DTensor.from_local(local, sharding.mesh, list(sharding.placements),
                              run_check=False, shape=whole.shape,
                              stride=whole.stride())
