"""ReID training / evaluation CLIs (port of
yolo_deepsort_tpu/train/reid_cli.py).

The reference's deep_sort/deep/train.py, test.py and evaluate.py:
ImageFolder layout (one directory per identity), RandomCrop((128, 64),
padding=4) + horizontal flip, SGD(lr .1, momentum .9, wd 5e-4),
cross-entropy, lr x0.1 every ``--lr-decay-every`` epochs, top-1 test,
checkpoint {'net_dict', 'acc', 'epoch'} (+ BN stats), --resume; ``test``
dumps query/gallery features; ``evaluate`` computes cosine rank-1. Runs on
the CUDA card unless ``--device cpu``:

  python -m yolo_deepsort_tpu_torch.train.reid_cli train --data-dir DATA ...
  python -m yolo_deepsort_tpu_torch.train.reid_cli test --data-dir DATA \\
      --ckpt C
  python -m yolo_deepsort_tpu_torch.train.reid_cli evaluate --features F.npz

The checkpoint is the JAX package's format: either package's
``load_reid_checkpoint`` folds it into inference params.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..utils.checkpoint import load_reid_checkpoint_npz, save_reid_checkpoint
from .reid_train import init_train_params, make_train_step, reid_train_apply
from .trees import full_f32, to_torch

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def list_image_folder(root: str) -> Tuple[List[str], List[int],
                                          Dict[str, int]]:
    """torchvision.ImageFolder-compatible listing: class-per-subdir,
    sorted."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    class_to_idx = {c: i for i, c in enumerate(classes)}
    paths, labels = [], []
    for c in classes:
        cdir = os.path.join(root, c)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                paths.append(os.path.join(cdir, fname))
                labels.append(class_to_idx[c])
    return paths, labels, class_to_idx


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((64, 128), Image.BILINEAR)
        return np.asarray(im, np.uint8)


def _augment(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """RandomCrop((128, 64), padding=4) + random horizontal flip."""
    padded = np.pad(img, ((4, 4), (4, 4), (0, 0)), mode="constant")
    dy, dx = rng.integers(0, 9, 2)
    img = padded[dy:dy + 128, dx:dx + 64]
    if rng.uniform() < 0.5:
        img = img[:, ::-1]
    return img


def _normalize(batch_uint8: np.ndarray) -> np.ndarray:
    return ((batch_uint8.astype(np.float32) / 255.0) - MEAN) / STD


def _trees_on(ck, device):
    return (to_torch(ck["net_dict"], device, trainable=True),
            to_torch(ck["stats"], device))


def train(args) -> None:
    device = torch.device(args.device)
    train_dir = os.path.join(args.data_dir, "train")
    test_dir = os.path.join(args.data_dir, "test")
    paths, labels, class_to_idx = list_image_folder(train_dir)
    num_classes = len(class_to_idx)
    print(f"train: {len(paths)} images, {num_classes} identities")

    start_epoch = 0
    best_acc = 0.0
    if args.resume and os.path.exists(args.ckpt):
        ck = load_reid_checkpoint_npz(args.ckpt)
        params, stats = _trees_on(ck, device)
        start_epoch = int(ck["epoch"]) + 1
        best_acc = float(ck["acc"])
        print(f"resumed from epoch {start_epoch - 1}, acc {best_acc:.3f}")
    else:
        params, stats = init_train_params(num_classes=num_classes, seed=0)
        params = to_torch(params, device, trainable=True)
        stats = to_torch(stats, device)

    opt_init, step = make_train_step(lr=args.lr, momentum=0.9,
                                     weight_decay=5e-4)
    opt = opt_init(params)

    rng = np.random.default_rng(0)
    images_u8 = np.stack([_load_image(p) for p in paths])
    labels_np = np.asarray(labels, np.int64)

    for epoch in range(start_epoch, args.epochs):
        if epoch and epoch % args.lr_decay_every == 0:
            args.lr *= 0.1  # the momentum trace carries over, as in optax
            for group in opt.param_groups:
                group["lr"] = args.lr
        order = rng.permutation(len(paths))
        t0, running = time.time(), 0.0
        nb = len(order) // args.batch_size
        for bi in range(nb):
            idx = order[bi * args.batch_size:(bi + 1) * args.batch_size]
            batch = np.stack([_augment(images_u8[i], rng) for i in idx])
            stats, loss, acc = step(params, opt, stats,
                                    torch.from_numpy(_normalize(batch)),
                                    torch.from_numpy(labels_np[idx]))
            running += float(loss)
            if (bi + 1) % args.log_interval == 0:
                print(f"epoch {epoch} [{bi + 1}/{nb}] loss "
                      f"{running / args.log_interval:.4f} acc "
                      f"{float(acc):.3f} ({time.time() - t0:.0f}s)")
                running = 0.0
        test_acc = _test_top1(params, stats, test_dir, args)
        print(f"epoch {epoch}: test top-1 {test_acc:.4f}")
        if test_acc >= best_acc:
            best_acc = test_acc
            save_reid_checkpoint(args.ckpt, params, best_acc, epoch, stats)
            print(f"saved checkpoint -> {args.ckpt}")


@torch.no_grad()
def _test_top1(params, stats, test_dir, args) -> float:
    """Top-1 accuracy of the eval-mode classifier on ``test_dir``."""
    if not os.path.isdir(test_dir):
        return 0.0
    paths, labels, _ = list_image_folder(test_dir)
    if not paths:
        return 0.0
    device = torch.device(args.device)
    correct = 0
    for i in range(0, len(paths), args.batch_size):
        chunk = paths[i:i + args.batch_size]
        batch = _normalize(np.stack([_load_image(p) for p in chunk]))
        with full_f32():
            logits, _ = reid_train_apply(
                params, stats, torch.from_numpy(batch).to(device),
                train=False)
        pred = logits.argmax(1).cpu().numpy()
        correct += int((pred == np.asarray(labels[i:i + len(chunk)])).sum())
    return correct / len(paths)


@torch.no_grad()
def test(args) -> None:
    """Dump query/gallery features (reference deep/test.py)."""
    device = torch.device(args.device)
    params, stats = _trees_on(load_reid_checkpoint_npz(args.ckpt), device)

    def embed(paths):
        feats = []
        for i in range(0, len(paths), args.batch_size):
            batch = _normalize(np.stack(
                [_load_image(p) for p in paths[i:i + args.batch_size]]))
            with full_f32():
                f, _ = reid_train_apply(params, stats,
                                        torch.from_numpy(batch).to(device),
                                        train=False, features_only=True)
            feats.append(f.cpu().numpy())
        return np.concatenate(feats) if feats else np.zeros((0, 512))

    qp, ql, _ = list_image_folder(os.path.join(args.data_dir, "query"))
    gp, gl, _ = list_image_folder(os.path.join(args.data_dir, "gallery"))
    np.savez(args.features, query=embed(qp), query_labels=ql,
             gallery=embed(gp), gallery_labels=gl)
    print(f"features -> {args.features}")


def evaluate(args) -> None:
    """Cosine rank-1 accuracy from dumped features (reference
    deep/evaluate.py)."""
    z = np.load(args.features)
    q, g = z["query"], z["gallery"]
    ql, gl = z["query_labels"], z["gallery_labels"]
    sims = q @ g.T
    top1 = gl[sims.argmax(1)]
    acc = float((top1 == ql).mean()) if len(ql) else 0.0
    print(f"rank-1: {acc:.4f}")


def main(argv=None) -> None:
    from ..device import resolve_device

    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("train", "test", "evaluate"):
        sp = sub.add_parser(name)
        sp.add_argument("--data-dir", default="data")
        sp.add_argument("--ckpt", default="checkpoint/ckpt.npz")
        sp.add_argument("--features", default="features.npz")
        sp.add_argument("--batch-size", type=int, default=64)
        sp.add_argument("--lr", type=float, default=0.1)
        sp.add_argument("--epochs", type=int, default=40)
        sp.add_argument("--lr-decay-every", type=int, default=20)
        sp.add_argument("--log-interval", type=int, default=100)
        sp.add_argument("--resume", action="store_true")
        sp.add_argument("--device", default="cuda",
                        help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.cmd != "evaluate":
        args.device = str(resolve_device(args.device))
    os.makedirs(os.path.dirname(args.ckpt) or ".", exist_ok=True)
    {"train": train, "test": test, "evaluate": evaluate}[args.cmd](args)


if __name__ == "__main__":
    main()
