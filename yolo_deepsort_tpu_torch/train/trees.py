"""Parameter trees of the training code, between numpy and torch.

The trainable state is a tree of dicts and lists (the JAX package's
layouts: HWIO conv weights, BN gamma/beta beside them, running statistics
in a tree of their own), so a tree of numpy arrays -- the JAX package's
params and stats, a checkpoint -- becomes the port's tensors with
``to_torch`` and goes back with ``to_numpy``. Leaves are visited in the
reference's pytree order (``utils/checkpoint.tree_leaves``).

``shard_train_tree`` takes such a tree to one rank's tensors on a training
mesh (``parallel/mesh.py``): the ReID head's mp slices (``MP_SPLIT``),
every other leaf whole; ``gather_train_tree`` brings the slices back
together as numpy arrays, the tree the JAX package holds.

``full_f32`` scopes float32 convs and matmuls without TF32 on a CUDA
device (cuDNN takes TF32 for f32 convs by default), so a training step on
the card can be held against the same step on the CPU up to the order of
the sums. It must cover the backward pass as well as the forward.
``deterministic_convs`` scopes cuDNN's deterministic algorithms, so two
trainings from one seed on the card give one result.
"""

from __future__ import annotations

import contextlib
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

# The leaves of the ReID training trees sharded over mp, by their path in
# the params tree (``reid_train.init_train_params``) or the stats tree: the
# dim that is split. fc2_b stays whole on every rank.
MP_SPLIT = {
    ("classifier", "fc1_w"): 1, ("classifier", "fc1_b"): 0,
    ("classifier", "bn", "gamma"): 0, ("classifier", "bn", "beta"): 0,
    ("classifier", "fc2_w"): 0,
    ("classifier", "mean"): 0, ("classifier", "var"): 0,
}


def tree_map_with_path(fn, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over every leaf of a tree of dicts, lists and
    tuples; ``path`` holds the keys and indices down to the leaf (``None``
    stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_map(fn, tree: Any) -> Any:
    """``fn`` over every leaf of a tree of dicts, lists and tuples (``None``
    stays ``None``)."""
    return tree_map_with_path(lambda _, v: fn(v), tree)


def _tensor(v, device, trainable: bool) -> torch.Tensor:
    t = (v.detach() if isinstance(v, torch.Tensor)
         else torch.tensor(np.asarray(v, np.float32)))
    return t.to(device, torch.float32).clone().requires_grad_(trainable)


def to_torch(tree: Any, device, trainable: bool = False) -> Any:
    """numpy (or tensor) leaves -> float32 tensors on ``device``;
    ``trainable`` leaves require grad."""
    return tree_map(lambda v: _tensor(v, device, trainable), tree)


def shard_train_tree(tree: Any, mesh, trainable: bool = False) -> Any:
    """A whole training tree (numpy or tensor leaves, the JAX package's
    layout) -> this rank's float32 tensors on ``mesh.device``: of each
    ``MP_SPLIT`` leaf the ``mesh.mp_rank``-th of ``mesh.mp`` equal slices
    along its dim, every other leaf whole. ``mesh.mp`` must divide the
    split dims (the head's 256 features)."""
    def leaf(path, v):
        dim = MP_SPLIT.get(path)
        if dim is not None and mesh.mp > 1:
            size = v.shape[dim]
            if size % mesh.mp:
                raise ValueError(f"mp={mesh.mp} does not divide {path}'s "
                                 f"{size} (dim {dim})")
            k = size // mesh.mp
            v = _tensor(v, "cpu", False).narrow(dim, mesh.mp_rank * k, k)
        return _tensor(v, mesh.device, trainable)
    return tree_map_with_path(leaf, tree)


def gather_train_tree(tree: Any, mesh) -> Any:
    """The inverse of ``shard_train_tree``: this rank's tensors -> the whole
    tree as numpy arrays (copies), each ``MP_SPLIT`` leaf all-gathered over
    ``mesh.mp_group`` in mp order. Every rank of the mesh calls it."""
    def leaf(path, v):
        v = v.detach()
        dim = MP_SPLIT.get(path)
        if dim is not None and mesh.mp > 1:
            x = v.movedim(dim, 0).contiguous()
            out = torch.empty((mesh.mp * x.shape[0], *x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, x, group=mesh.mp_group)
            v = out.movedim(0, dim)
        return v.to("cpu", copy=True).numpy()  # a copy, also on the CPU
    return tree_map_with_path(leaf, tree)


def to_numpy(tree: Any) -> Any:
    """tensor leaves -> numpy arrays (host copies)."""
    return tree_map(lambda v: v.detach().cpu().numpy()
                    if isinstance(v, torch.Tensor) else np.asarray(v), tree)


@contextlib.contextmanager
def full_f32():
    """float32 convs and matmuls without TF32 while the block runs."""
    was = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = was


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic algorithms while the block runs: its default
    weight-gradient algorithms may sum in an order that changes from run to
    run, so two trainings from one seed on the card would part."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was
