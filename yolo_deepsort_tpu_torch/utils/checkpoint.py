"""Checkpoint IO for parameter and state trees (port of
yolo_deepsort_tpu/utils/checkpoint.py, numpy only).

Any tree of dicts, lists, tuples, ``None`` and arrays (numpy arrays or
tensors, which are copied to the host) serializes to one ``.npz`` with
slash-joined key paths -- the reference package's on-disk format, so
either package reads the other's files:

* dict str key ``k``  -> segment ``s<urlquote(k)>`` ("/" and "%" escaped)
* dict int key ``k``  -> segment ``i<k>``
* list / tuple        -> marker leaf ``!L<n>`` / ``!T<n>``, items ``e<i>``
* ``None``            -> marker leaf ``!none``

``load_pytree`` returns plain dicts, lists and tuples; ``restore_like``
puts the loaded leaves back into a template's structure (named tuples
included).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List
from urllib.parse import quote, unquote

import numpy as np
import torch


def _seg(key: Any) -> str:
    if isinstance(key, bool):  # bool is an int subclass; be explicit
        raise TypeError(f"unsupported dict key type: {key!r}")
    if isinstance(key, (int, np.integer)):
        return f"i{int(key)}"
    if isinstance(key, str):
        return "s" + quote(key, safe="")
    raise TypeError(f"unsupported dict key type: {key!r}")


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]):
    if tree is None:
        out[prefix + "/!none"] = np.zeros(0)
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            _flatten(tree[k], f"{prefix}/{_seg(k)}", out)
    elif isinstance(tree, (list, tuple)):
        tag = "L" if isinstance(tree, list) else "T"
        out[f"{prefix}/!{tag}{len(tree)}"] = np.zeros(0)
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/e{i}", out)
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
    else:
        out[prefix] = np.asarray(tree)


def save_pytree(path: str | os.PathLike, tree: Any) -> None:
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "root", flat)
    with open(path, "wb") as f:
        np.savez(f, **flat)


def _decode(node: Any) -> Any:
    if isinstance(node, np.ndarray):
        return node
    if "!none" in node:
        return None
    marker = next((k for k in node if k.startswith("!")), None)
    if marker is not None:
        tag, n = marker[1], int(marker[2:])
        items = [_decode(node[f"e{i}"]) for i in range(n)]
        return items if tag == "L" else tuple(items)
    out: Dict[Any, Any] = {}
    for seg, child in node.items():
        key = int(seg[1:]) if seg[0] == "i" else unquote(seg[1:])
        out[key] = _decode(child)
    return out


def load_pytree(path: str | os.PathLike) -> Any:
    with np.load(path, allow_pickle=False) as z:
        store = {k: z[k] for k in z.files}
    trie: Dict[str, Any] = {}
    for key, val in store.items():
        parts = key.split("/")
        node = trie
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _decode(trie["root"])


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in the reference's pytree order: dict keys sorted, sequences
    in order, ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _unflatten_like(template: Any, leaves: Iterator[Any]) -> Any:
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten_like(template[k], leaves)
                for k in sorted(template)}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten_like(v, leaves) for v in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_like(v, leaves) for v in template)
    return next(leaves)


def restore_like(template: Any, loaded: Any) -> Any:
    """Map ``loaded``'s leaves onto ``template``'s structure; both must hold
    the same number of leaves with the same shapes."""
    t_leaves, l_leaves = tree_leaves(template), tree_leaves(loaded)
    if len(t_leaves) != len(l_leaves):
        raise ValueError(
            f"checkpoint structure mismatch: template has {len(t_leaves)} "
            f"leaves, checkpoint has {len(l_leaves)}")
    for t, leaf in zip(t_leaves, l_leaves):
        ts, ls = tuple(np.shape(t)), tuple(np.shape(leaf))
        if ts != ls:
            raise ValueError(f"leaf shape mismatch: template {ts} vs "
                             f"checkpoint {ls}")
    return _unflatten_like(template, iter(l_leaves))


def save_reid_checkpoint(path: str | os.PathLike, params: Any, acc: float,
                         epoch: int, stats: Any = None,
                         opt_state: Any = None) -> None:
    """Training checkpoint mirroring the reference's {'net_dict', 'acc',
    'epoch'} dict, plus BN stats and optimizer state."""
    save_pytree(path, {
        "net_dict": params,
        "acc": np.float64(acc),
        "epoch": np.int64(epoch),
        "stats": stats,
        "opt_state": opt_state,
    })


def load_reid_checkpoint_npz(path: str | os.PathLike) -> Dict:
    return load_pytree(path)
