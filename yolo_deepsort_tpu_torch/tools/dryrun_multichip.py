"""Multi-rank dryrun of training (port of parts (a) and (d) of
``__graft_entry__.py`` ``dryrun_multichip``; parts (b) and (c), serving,
are ``tools/dryrun_multihost.py``).

Runs as one process (rank) of an N-process ``torch.distributed`` job, one
device per rank, and drives the port's training mesh
(``parallel/mesh.py`` ``make_train_mesh``):

  (a) the ReID train step on a dp x mp mesh, mp = 2 when N is even, else
      1: a 64-class head (seeded params, the classifier's fc1 columns and
      fc2 rows with their BN sharded over mp, the rest replicated), SGD lr
      0.1, momentum 0.9, decay 5e-4, a batch of dp * 2 zero images;
  (d) the dp-sharded detector train step over all N ranks: yolov3-tiny at
      96 px with seeded weights, SGD lr 1e-4, one zero image a rank and 2N
      padded target rows.

Each rank prints the reference's two lines. ``--device cuda`` (the
default) runs on the card ``cuda:{process id % cards}`` over NCCL and
raises without one; ``--device cpu`` runs on the CPU over gloo. Run every
process id at once, e.g. rank 0 of 2 on the CPU:

  python -m yolo_deepsort_tpu_torch.tools.dryrun_multichip \\
      --coordinator 127.0.0.1:9345 --num-processes 2 --process-id 0 \\
      --device cpu
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.mesh import make_train_mesh
from ..train.trees import shard_train_tree
from .dryrun_multihost import join, rank_parser


def reid_step(n: int, device) -> str:
    """Part (a): one ReID train step on the dp x mp mesh."""
    from ..train.reid_train import init_train_params, make_train_step

    mp = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_train_mesh(n // mp, mp, device=device)
    params, stats = init_train_params(num_classes=64, seed=0)
    params = shard_train_tree(params, mesh, trainable=True)
    stats = shard_train_tree(stats, mesh)
    init, step = make_train_step(mesh=mesh)
    images = torch.zeros((2, 128, 64, 3), device=device)  # this dp shard
    labels = torch.zeros((2,), dtype=torch.int64, device=device)
    stats, loss, acc = step(params, init(params), stats, images, labels)
    return (f"[dryrun] reid train step ok on {mesh.dp}x{mesh.mp} dp/mp "
            f"mesh: loss={float(loss):.4f}")


def detector_step(n: int, device) -> str:
    """Part (d): one dp-sharded detector train step over all ranks."""
    from ..cfg.architectures import ARCHITECTURES
    from ..models.darknet import build_network
    from ..train.yolo_cli import make_detection_train_step, raw_params_to_train
    from ..utils.checkpoint import tree_leaves
    from ..weights import random_raw_params

    mesh = make_train_mesh(n, 1, device=device)
    plan = build_network(ARCHITECTURES["yolov3-tiny"](img_size=96))
    params, stats = raw_params_to_train(
        random_raw_params(plan.defs(), seed=1), plan.defs())
    params = shard_train_tree(params, mesh, trainable=True)
    stats = shard_train_tree(stats, mesh)
    opt = torch.optim.SGD(tree_leaves(params), lr=1e-4)  # optax.sgd(1e-4)
    step = make_detection_train_step(plan, mesh=mesh)
    images = torch.zeros((1, 96, 96, 3), device=device)  # this dp shard
    targets = torch.zeros((2 * n, 6), device=device)  # the whole batch's
    tmask = torch.zeros((2 * n,), dtype=torch.bool, device=device)
    stats, loss, _ = step(params, opt, stats, images, targets, tmask)
    return (f"[dryrun] dp-sharded detector train step ok over {n} devices: "
            f"loss={float(loss):.4f}")


def main(argv=None) -> int:
    args = rank_parser(__doc__).parse_args(argv)
    n, me = args.num_processes, args.process_id
    device = join(args)
    try:
        print(f"rank {me}: {reid_step(n, device)}", flush=True)
        print(f"rank {me}: {detector_step(n, device)}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
