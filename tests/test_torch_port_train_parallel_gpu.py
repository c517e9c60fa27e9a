"""The training mesh on the card: a real one-rank NCCL mesh against the mesh
without a group, and the seeded training cases the CPU tests
(``tests/test_torch_port_train_parallel.py``) share.

The ``gpu`` tests skip without a CUDA device. This file imports no jax, so
it also runs on a machine without it:

    python -m pytest --noconftest -q -m gpu tests/test_torch_port_train_parallel_gpu.py

Over one NCCL rank both axes of ``make_train_mesh()`` are the group, so
every collective of a train step -- the BN statistics, the loss counts,
the gradients' flat buffer, the ReID head's pair -- runs through NCCL;
three steps must equal the mesh without a group bit for bit (losses,
params, statistics), with cuDNN deterministic (its default wgrad
algorithms may sum in an order that changes from run to run).
"""

import numpy as np
import pytest
import torch

from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES
from yolo_deepsort_tpu_torch.models.darknet import build_network
from yolo_deepsort_tpu_torch.train import reid_train as RT
from yolo_deepsort_tpu_torch.train import yolo_cli as TC
from yolo_deepsort_tpu_torch.train.trees import shard_train_tree
from yolo_deepsort_tpu_torch.utils.checkpoint import tree_leaves
from yolo_deepsort_tpu_torch.weights import random_raw_params

N_CLASSES = 4
DET_ARCH, DET_SIZE, DET_BATCH, DET_LR = "yolov3-tiny", 96, 4, 1e-3


def reid_case():
    """The reference's dp test (``tests/test_parallel_train.py:131``): 4
    classes, seed 3; 8 crops from ``default_rng(4)`` and their labels."""
    params, stats = RT.init_train_params(num_classes=N_CLASSES, seed=3)
    rng = np.random.default_rng(4)
    images = rng.normal(0, 1, (8, 128, 64, 3)).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, 8).astype(np.int64)
    return params, stats, images, labels


def detector_case():
    """After the reference's ``:353``: yolov3-tiny-96, seed 2, 4 images,
    one object an image (the reference's rows), then a later target in the
    cell of image 1's (the same best anchor at both heads: it takes the
    cell's box), and a padded row on image 3."""
    plan = build_network(ARCHITECTURES[DET_ARCH](img_size=DET_SIZE))
    params, stats = TC.raw_params_to_train(
        random_raw_params(plan.defs(), seed=2), plan.defs())
    rng = np.random.default_rng(4)
    images = rng.normal(size=(DET_BATCH, DET_SIZE, DET_SIZE, 3)).astype(
        np.float32)
    targets = np.zeros((2 * DET_BATCH, 6), np.float32)
    tmask = np.zeros(2 * DET_BATCH, bool)
    for i in range(DET_BATCH):
        targets[i] = [i, i % 3, 0.3 + 0.04 * i, 0.5, 0.2, 0.3]
    targets[4] = [1, 2, 0.35, 0.51, 0.25, 0.2]
    targets[6] = [3, 1, 0.6, 0.6, 0.1, 0.1]
    tmask[:5] = True
    return plan, params, stats, images, targets, tmask


@pytest.fixture
def nccl_device():
    """The card, cuDNN deterministic and a one-rank NCCL process group,
    all undone after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import socket

    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    dist.init_process_group("nccl", store=dist.TCPStore(
        "127.0.0.1", port, 1, True), world_size=1, rank=0, device_id=dev)
    try:
        yield dev
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = was


def _three_steps(net, mesh):
    """-> (losses, params, stats) after 3 steps of ``net``'s case."""
    if net == "reid":
        params, stats, images, labels = reid_case()
        init, step = RT.make_train_step(mesh=mesh)
        rest = (labels,)
    else:
        plan, params, stats, images, targets, tmask = detector_case()
        step = TC.make_detection_train_step(plan, mesh=mesh)
        rest = (targets, tmask)
    params = shard_train_tree(params, mesh, trainable=True)
    stats = shard_train_tree(stats, mesh)
    opt = (init(params) if net == "reid" else
           torch.optim.SGD(tree_leaves(params), lr=DET_LR))
    losses = []
    for _ in range(3):
        stats, loss, _ = step(params, opt, stats, images, *rest)
        losses.append(float(loss))
    return losses, tree_leaves(params), tree_leaves(stats)


@pytest.mark.gpu
@pytest.mark.parametrize("net", ["reid", "detector"])
def test_nccl_one_rank_equals_no_group(nccl_device, net):
    """Three steps through the one-rank NCCL mesh equal the mesh without a
    group bit for bit."""
    import torch.distributed as dist

    from yolo_deepsort_tpu_torch.parallel.mesh import make_train_mesh

    nccl = make_train_mesh(device=nccl_device)
    assert dist.get_backend(nccl.dp_group) == "nccl"
    assert nccl.mp_group is nccl.dp_group
    got = _three_steps(net, nccl)
    want = _three_steps(net, make_train_mesh(1, 1, device=nccl_device))
    assert got[0] == want[0]
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        assert torch.equal(a, b)
