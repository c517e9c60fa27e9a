"""Parameter trees of the training code, between numpy and torch.

The trainable state is a tree of dicts and lists (the JAX package's
layouts: HWIO conv weights, BN gamma/beta beside them, running statistics
in a tree of their own), so a tree of numpy arrays -- the JAX package's
params and stats, a checkpoint -- becomes the port's tensors with
``to_torch`` and goes back with ``to_numpy``. Leaves are visited in the
reference's pytree order (``utils/checkpoint.tree_leaves``).

``full_f32`` scopes float32 convs and matmuls without TF32 on a CUDA
device (cuDNN takes TF32 for f32 convs by default), so a training step on
the card can be held against the same step on the CPU up to the order of
the sums. It must cover the backward pass as well as the forward.
"""

from __future__ import annotations

import contextlib
from typing import Any

import numpy as np
import torch


def tree_map(fn, tree: Any) -> Any:
    """``fn`` over every leaf of a tree of dicts, lists and tuples (``None``
    stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def to_torch(tree: Any, device, trainable: bool = False) -> Any:
    """numpy (or tensor) leaves -> float32 tensors on ``device``;
    ``trainable`` leaves require grad."""
    def leaf(v):
        t = (v.detach() if isinstance(v, torch.Tensor)
             else torch.tensor(np.asarray(v, np.float32)))
        return t.to(device, torch.float32).clone().requires_grad_(trainable)
    return tree_map(leaf, tree)


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
