"""Checkpoint / resume for MPC-stack state.

Counterpart of ``strided_tpu/utils/checkpoint.py``, over
``torch.utils._pytree``, in the same ``.npz`` format: a ``__manifest__``
of uint8 JSON (``nleaves``, the leaves' key ``paths`` and their ``leaves``
shapes and dtypes, and an informational ``treedef``), then ``leaf_i``.
Compatibility is checked against the manifest (leaf count, each key path,
each leaf's shape and dtype), read from attributes only, so validating
against a template on the card moves nothing to the host. Checkpoints of
the older format (no manifest) keep their per-leaf shape and dtype check.

Dtypes are written under their numpy names and key paths come from
``keystr``, which spells dict, list and tuple paths as JAX does, so a
checkpoint of such a tree written by either package loads into the other.
:class:`~strided_tpu_torch.mpc.LinearMPC` and
:class:`~strided_tpu_torch.mpc.CondensedQP` are registered here as pytree
nodes (tensor fields as ``.name`` leaves, the scalars as static context),
so a controller round-trips.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Any

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..mpc.mpc import LinearMPC
from ..mpc.qp import CondensedQP

__all__ = ["save_pytree", "load_pytree"]


def _register(cls, static) -> None:
    """The fields named in ``static`` are context, the others children
    (tensors, or a registered node), each under the key ``.name``."""
    kids = tuple(f.name for f in dataclasses.fields(cls) if f.name not in static)

    def flatten(obj):
        return [getattr(obj, n) for n in kids], tuple(getattr(obj, n) for n in static)

    def flatten_with_keys(obj):
        leaves, ctx = flatten(obj)
        return [(pytree.GetAttrKey(n), v) for n, v in zip(kids, leaves)], ctx

    def unflatten(leaves, ctx):
        return cls(**dict(zip(kids, leaves)), **dict(zip(static, ctx)))

    pytree.register_pytree_node(cls, flatten, unflatten,
                                serialized_type_name=f"{cls.__module__}.{cls.__qualname__}",
                                flatten_with_keys_fn=flatten_with_keys)


_register(CondensedQP, ("rho", "N", "n", "m", "use_chol"))
_register(LinearMPC, ("admm_iters", "constrained", "admm_coarse_iters"))


def _dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype ("float32", "int32", ...)."""
    return str(dtype).removeprefix("torch.")


def _leaf_spec(leaf):
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None or dtype is None:  # plain python scalar leaf
        arr = np.asarray(leaf)
        shape, dtype = arr.shape, arr.dtype
    return {"shape": [int(d) for d in shape], "dtype": _dtype_name(dtype)}


def _manifest(tree):
    """(paths, specs) from attributes only: no device transfer."""
    path_leaves, _ = pytree.tree_flatten_with_path(tree)
    return ([pytree.keystr(p) for p, _ in path_leaves],
            [_leaf_spec(leaf) for _, leaf in path_leaves])


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("save_pytree: bfloat16 has no numpy dtype to write it as")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any) -> None:
    """Persist any pytree of tensors (controller, warm start, trajectory)."""
    leaves, treespec = pytree.tree_flatten(tree)
    arrays = {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
    paths, specs = _manifest(tree)
    meta = json.dumps({
        "nleaves": len(leaves),
        "paths": paths,
        "leaves": specs,
        "treedef": str(treespec),  # informational only
    })
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez_compressed(path, __manifest__=np.frombuffer(meta.encode(), dtype=np.uint8),
                        **arrays)


def load_pytree(path: str, like: Any) -> Any:
    """Restore a pytree saved by :func:`save_pytree`; ``like`` supplies the
    tree structure, and each leaf comes back as a tensor on the device of
    ``like``'s leaf (the CPU where that leaf is not a tensor). Raises
    ``ValueError`` when the saved leaf count, any key path, or any leaf's
    shape/dtype does not match ``like``'s structure."""
    with np.load(path, allow_pickle=False) as data:
        like_leaves, treespec = pytree.tree_flatten(like)
        if "__manifest__" in data.files:
            meta = json.loads(bytes(data["__manifest__"]).decode())
            saved_n = meta["nleaves"]
            if saved_n != len(like_leaves):
                raise ValueError(
                    f"checkpoint structure mismatch: saved {saved_n} leaves, expected "
                    f"{len(like_leaves)}\n saved treedef: {meta.get('treedef', '<unknown>')}"
                    f"\n expected: {treespec}"
                )
            want_paths, want_specs = _manifest(like)
            for i, (sp, wp) in enumerate(zip(meta.get("paths", want_paths), want_paths)):
                if sp != wp:
                    raise ValueError(f"checkpoint structure mismatch at leaf {i}: saved key "
                                     f"path {sp!r}, expected {wp!r}")
            for i, (s, w) in enumerate(zip(meta["leaves"], want_specs)):
                if s["shape"] != w["shape"] or s["dtype"] != w["dtype"]:
                    raise ValueError(f"checkpoint leaf {i} mismatch: saved "
                                     f"{s['dtype']}{s['shape']}, expected {w['dtype']}{w['shape']}")
        else:  # the older format: leaves only, perhaps a treedef string
            saved_n = len([k for k in data.files if k.startswith("leaf_")])
            saved_def = (bytes(data["__treedef__"]).decode() if "__treedef__" in data.files
                         else "<unknown>")
            if saved_n != len(like_leaves):
                raise ValueError(
                    f"checkpoint structure mismatch: saved {saved_n} leaves, expected "
                    f"{len(like_leaves)}\n saved treedef: {saved_def}\n expected: {treespec}"
                )
            if saved_def != str(treespec):
                warnings.warn(
                    "checkpoint without a manifest: its treedef differs from the template's "
                    f"(saved: {saved_def!r}); loading by leaf position -- verify the "
                    "structures really correspond",
                    stacklevel=2,
                )
            # the arrays carry shape and dtype: a different structure with a
            # matching leaf COUNT is still rejected
            for i, leaf in enumerate(like_leaves):
                arr, w = data[f"leaf_{i}"], _leaf_spec(leaf)
                if list(arr.shape) != w["shape"] or str(arr.dtype) != w["dtype"]:
                    raise ValueError(f"checkpoint leaf {i} mismatch: saved {arr.dtype}"
                                     f"{list(arr.shape)}, expected {w['dtype']}{w['shape']}")
        leaves = [
            torch.from_numpy(data[f"leaf_{i}"]).to(
                leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
            for i, leaf in enumerate(like_leaves)
        ]
    return pytree.tree_unflatten(leaves, treespec)
