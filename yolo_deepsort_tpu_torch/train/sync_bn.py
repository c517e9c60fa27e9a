"""Batch statistics of the training BNs, over one rank's batch or over the
dp ranks of a training mesh (``parallel/mesh.py`` ``TrainMesh``).

The reference's train-mode BN takes the mean over the GLOBAL batch, which
XLA turns into a cross-device all-reduce when the batch is sharded. Over
the mesh the port sums on each rank and all-reduces the sums over the dp
group (the mp ranks of one dp index hold the same images), in the
reference's two passes: the mean, then the biased variance about it -- not
E[x^2] - mean^2 from one all-reduce of sums and squares, which rounds
otherwise and cancels badly. The all-reduce passes gradients back summed
over the group (``collectives.all_reduce_sum``). Every rank holds the same
shard size (the train steps check it), so the global count is the local
one times dp.
"""

from __future__ import annotations

import math

from ..parallel.collectives import all_reduce_sum


def batch_stats(x, dims, mesh=None):
    """(mean, biased variance) of ``x`` over ``dims``, channels at dim 1:
    over this tensor with ``mesh`` None, else over the mesh's dp ranks."""
    shape = [1] * x.dim()
    shape[1] = -1
    if mesh is None:
        mean = x.mean(dims)
        return mean, (x - mean.reshape(shape)).square().mean(dims)
    n = math.prod(x.shape[d] for d in dims) * mesh.dp
    mean = all_reduce_sum(x.sum(dims), mesh.dp_group) / n
    var = all_reduce_sum((x - mean.reshape(shape)).square().sum(dims),
                         mesh.dp_group) / n
    return mean, var
