"""The port's multi-rank training on the CPU: ``parallel/mesh.py``
``make_train_mesh``, ``parallel/collectives.py``, ``train/sync_bn.py``, the
mesh paths of ``make_train_step`` and ``make_detection_train_step``,
``trees.shard_train_tree`` / ``gather_train_tree`` and
``tools/dryrun_multichip.py``.

In this process: the collectives without a group (the identity, gradients
included), the sync-BN forwards on a one-rank mesh against ``mesh=None``,
the shard / gather round trip, every refusal of ``make_train_mesh``.

Across processes (gloo on 127.0.0.1, one intra-op thread a rank, as
``tests/test_torch_port_multirank.py``): every process of this file starts
once, when its first test runs, and each world size runs all its cases in
one job, so torch's import is paid once a rank:

* 2 ranks: the ReID step at dp 2 and the detector step at dp 2, then a
  dp group whose ranks hold unequal shards (it must raise);
* 4 ranks: the ReID step at dp 2 x mp 2;
* the dryrun tool on 2 ranks.

Every process shares one limit of TIME_LIMIT seconds from the start; on
expiry, or when one fails, every child is killed and the test fails.

The ReID case is the reference's ``tests/test_parallel_train.py:131`` (4
classes, seed 3, images (8, 128, 64, 3) from ``default_rng(4)``, SGD lr
0.1, momentum 0.9, decay 5e-4); the detector case its ``:353``
(yolov3-tiny-96, seed 2, ``optax.sgd(1e-3)``, here batch 4 with two
targets in one cell of one image and objects on both ranks' images; both
cases are ``tests/test_torch_port_train_parallel_gpu.py``'s). Each
runs 3 steps. The ranks report their whole state (gathered over mp) before
and after every step; step k is held to the one-rank port step
(``mesh=None``, the whole batch) started from the ranks' own state before
it, so every step meets the same bounds, the reference tests' own.
"""

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import cpu_subprocess_env
from test_torch_port_multirank import _free_port
from test_torch_port_train_parallel_gpu import (
    DET_ARCH,
    DET_LR,
    DET_SIZE,
    detector_case,
    reid_case,
)
from yolo_deepsort_tpu.models.darknet import build_network as j_build
from yolo_deepsort_tpu.train import reid_train as JT
from yolo_deepsort_tpu.train import yolo_cli as JC
from yolo_deepsort_tpu_torch.parallel import mesh as M
from yolo_deepsort_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    check_equal_shards,
    copy_to_mp,
    reduce_from_mp,
    sum_grads,
)
from yolo_deepsort_tpu_torch.train import reid_train as RT
from yolo_deepsort_tpu_torch.train import yolo_cli as TC
from yolo_deepsort_tpu_torch.train.trees import (
    gather_train_tree,
    shard_train_tree,
    to_torch,
)
from yolo_deepsort_tpu_torch.train.yolo_loss import yolo_loss
from yolo_deepsort_tpu_torch.utils.checkpoint import tree_leaves
from torch_port_threads import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TIME_LIMIT = 120  # seconds, every process of this file together
STEPS = 3
CPU = torch.device("cpu")

# One rank: runs every case of its job, writes what each step gave.
WORKER = r"""
import pickle, sys
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, port, case_path, out_path = sys.argv[1:6]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
try:
    from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES
    from yolo_deepsort_tpu_torch.models.darknet import build_network
    from yolo_deepsort_tpu_torch.parallel.collectives import (
        check_equal_shards)
    from yolo_deepsort_tpu_torch.parallel.mesh import make_train_mesh
    from yolo_deepsort_tpu_torch.train import reid_train as RT
    from yolo_deepsort_tpu_torch.train import yolo_cli as TC
    from yolo_deepsort_tpu_torch.train.trees import (
        gather_train_tree, shard_train_tree, tree_map)
    from yolo_deepsort_tpu_torch.utils.checkpoint import tree_leaves

    with open(case_path, "rb") as f:
        case = pickle.load(f)
    res = {}
    for name, job in case["jobs"].items():
        mesh = make_train_mesh(job["dp"], job["mp"], device="cpu")
        params = shard_train_tree(job["params"], mesh, trainable=True)
        stats = shard_train_tree(job["stats"], mesh)
        b = job["images"].shape[0] // mesh.dp
        images = torch.from_numpy(job["images"][mesh.dp_rank * b:][:b])
        if job["net"] == "reid":
            init, step = RT.make_train_step(mesh=mesh)
            opt = init(params)
            rest = (torch.from_numpy(job["labels"][mesh.dp_rank * b:][:b]),)
        else:
            plan = build_network(ARCHITECTURES[job["arch"]](
                img_size=job["size"]))
            step = TC.make_detection_train_step(plan, mesh=mesh)
            opt = torch.optim.SGD(tree_leaves(params), lr=job["lr"])
            rest = (torch.from_numpy(job["targets"]),
                    torch.from_numpy(job["tmask"]))

        def state():
            bufs = tree_map(lambda p: opt.state.get(p, {}).get(
                "momentum_buffer"), params)
            return (gather_train_tree(params, mesh),
                    gather_train_tree(stats, mesh),
                    gather_train_tree(bufs, mesh))

        out = {"states": [state()], "loss": [], "metric": []}
        for _ in range(job["steps"]):
            stats, loss, metric = step(params, opt, stats, images, *rest)
            out["loss"].append(float(loss))
            out["metric"].append(float(metric) if job["net"] == "reid"
                                 else {k: float(v) for k, v in
                                       metric.items()})
            out["states"].append(state())
        res[name] = out
    if case.get("unequal_shards"):
        mesh = make_train_mesh(world, 1, device="cpu")
        try:
            check_equal_shards(mesh.dp_group, 2 + rank, "cpu")
        except ValueError as e:
            res["unequal_shards"] = str(e)
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
finally:
    dist.destroy_process_group()
"""


# ---------------------------------------------------------------- the cases

def _jobs():
    """{world size: the content of its case file}."""
    p, s, x, y = reid_case()
    reid = dict(net="reid", params=p, stats=s, images=x, labels=y,
                steps=STEPS)
    _, dp_, ds, dx, dt, dm = detector_case()
    det = dict(net="detector", arch=DET_ARCH, size=DET_SIZE, lr=DET_LR,
               params=dp_, stats=ds, images=dx, targets=dt, tmask=dm,
               steps=STEPS, dp=2, mp=1)
    return {
        2: dict(jobs={"reid": dict(reid, dp=2, mp=1), "detector": det},
                unequal_shards=True),
        4: dict(jobs={"reid": dict(reid, dp=2, mp=2)}),
    }


class Ranks:
    """Every process of this file, started at once; ``result(key)`` waits
    for one job under the shared deadline."""

    def __init__(self, tmp: Path):
        self.deadline = time.monotonic() + TIME_LIMIT
        env = cpu_subprocess_env(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        env["PYTHONPATH"] = os.pathsep.join(
            [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        self.procs, self.outs, self.results = {}, {}, {}
        for world, case in _jobs().items():
            case_path = tmp / f"case{world}.pkl"
            with open(case_path, "wb") as f:
                pickle.dump(case, f)
            port = _free_port()
            self.outs[world] = [tmp / f"w{world}r{r}.pkl"
                                for r in range(world)]
            self.procs[world] = [self._start(
                [sys.executable, "-c", WORKER, str(r), str(world), str(port),
                 str(case_path), str(self.outs[world][r])], env)
                for r in range(world)]
        port = _free_port()
        self.procs["dryrun"] = [self._start(
            [sys.executable, "-m", "yolo_deepsort_tpu_torch.tools."
             "dryrun_multichip", "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(r), "--device",
             "cpu"], env) for r in range(2)]

    @staticmethod
    def _start(argv, env):
        return subprocess.Popen(argv, cwd=REPO, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)

    def result(self, key):
        """-> each rank's results (``world``) or printed output
        (``"dryrun"``)."""
        if key not in self.results:
            outs = []
            try:
                for i, p in enumerate(self.procs[key]):
                    left = max(1.0, self.deadline - time.monotonic())
                    out, _ = p.communicate(timeout=left)
                    outs.append(out)
                    assert p.returncode == 0, \
                        f"{key}: rank {i} failed:\n{out[-4000:]}"
            except subprocess.TimeoutExpired:
                self.kill()
                pytest.fail(f"the ranks did not finish within {TIME_LIMIT} s")
            except AssertionError:
                self.kill()
                raise
            if key != "dryrun":
                outs = []
                for path in self.outs[key]:
                    with open(path, "rb") as f:
                        outs.append(pickle.load(f))
            self.results[key] = outs
        return self.results[key]

    def kill(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    r = Ranks(tmp_path_factory.mktemp("train_ranks"))
    yield r
    r.kill()


# ---------------------------------------------------- in-process: no group

def _leaf(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32)).requires_grad_(True)


@pytest.mark.parametrize("op", [all_reduce_sum, copy_to_mp, reduce_from_mp])
def test_collective_without_a_group_is_the_identity(op):
    """An axis of one rank has no group: forward and gradient pass
    through unchanged."""
    x = _leaf((3, 5), 0)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 5)).astype(
        np.float32))
    y = op(x * 1.0, None)
    assert torch.equal(y, x)
    y.backward(g)
    assert torch.equal(x.grad, g)


def test_grad_sum_and_shard_check_without_a_group():
    """``sum_grads`` and ``check_equal_shards`` do nothing without a
    group: the gradients stay the same tensors."""
    a, b = _leaf((4,), 2), _leaf((2, 3), 3)
    (a.sum() + (b * b).sum()).backward()
    grads = (a.grad, b.grad)
    sum_grads([a, b], None)
    assert a.grad is grads[0] and b.grad is grads[1]
    check_equal_shards(None, 5, CPU)


def _mesh1():
    return M.make_train_mesh(1, 1, device="cpu")


def test_reid_sync_bn_on_one_rank_matches_no_mesh():
    """The ReID train-mode forward on a one-rank mesh without a group (sums
    over the global count) against ``mesh=None`` (means): logits and every
    new BN statistic within f32 rounding (rtol 1e-5, atol 1e-6)."""
    params, stats, images, _ = reid_case()
    x = torch.from_numpy(images[:4])
    with torch.no_grad():
        want, want_stats = RT.reid_train_apply(
            to_torch(params, CPU), to_torch(stats, CPU), x)
        got, got_stats = RT.reid_train_apply(
            shard_train_tree(params, _mesh1()),
            shard_train_tree(stats, _mesh1()), x, mesh=_mesh1())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(tree_leaves(got_stats), tree_leaves(want_stats)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("box_loss", ["mse", "ciou"])
def test_detector_sync_bn_on_one_rank_matches_no_mesh(box_loss):
    """The detector's train-mode forward, loss and gradients on a one-rank
    mesh without a group against ``mesh=None``, with either box loss (each
    masked mean over the mesh's global count): head maps, BN statistics
    and loss within f32 rounding (rtol 1e-5, atol 1e-6), every gradient
    within 1e-4 of its leaf's largest."""
    plan, params, stats, images, targets, tmask = detector_case()
    outs = []
    for mesh in (None, _mesh1()):
        p = to_torch(params, CPU, trainable=True)
        maps, new_stats = TC.make_forward_train(plan, mesh=mesh)(
            p, to_torch(stats, CPU), torch.from_numpy(images))
        loss, _ = yolo_loss(plan, maps, torch.from_numpy(targets),
                            torch.from_numpy(tmask), box_loss=box_loss,
                            mesh=mesh)
        loss.backward()
        outs.append((maps, new_stats, loss, [q.grad for q in tree_leaves(p)]))
    (m0, s0, l0, g0), (m1, s1, l1, g1) = outs
    for a, b in zip(m1 + tree_leaves(s1), m0 + tree_leaves(s0)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(l1.item(), l0.item(), rtol=1e-5)
    for a, b in zip(g1, g0):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_shard_and_gather_round_trip():
    """``shard_train_tree`` of a mp-rank of 2 takes the ``MP_SPLIT``
    leaves' halves (fc1 columns, fc2 rows, the head's BN and stats) and
    every other leaf whole; on a one-rank mesh ``gather_train_tree`` gives
    the tree back exactly. (Across 4 ranks: ``test_reid_steps_over_ranks``
    holds the gathered initial state to the tree.)"""
    params, stats, _, _ = reid_case()
    for tree in (params, stats):
        back = gather_train_tree(shard_train_tree(tree, _mesh1()), _mesh1())
        for a, b in zip(tree_leaves(back), tree_leaves(tree)):
            np.testing.assert_array_equal(a, b)
    half = M.TrainMesh(None, None, 0, 1, 1, 2, CPU)
    p = shard_train_tree(params, half)
    c = params["classifier"]
    np.testing.assert_array_equal(p["classifier"]["fc1_w"],
                                  c["fc1_w"][:, 128:])
    np.testing.assert_array_equal(p["classifier"]["fc2_w"], c["fc2_w"][128:])
    np.testing.assert_array_equal(p["classifier"]["bn"]["beta"],
                                  c["bn"]["beta"][128:])
    np.testing.assert_array_equal(p["classifier"]["fc2_b"], c["fc2_b"])
    np.testing.assert_array_equal(p["stem"]["w"], params["stem"]["w"])
    s = shard_train_tree(stats, half)
    assert s["classifier"]["mean"].shape == (128,)
    with pytest.raises(ValueError, match="does not divide"):
        shard_train_tree(params, M.TrainMesh(None, None, 0, 0, 1, 3, CPU))
    with pytest.raises(ValueError, match="does not divide"):
        RT.make_train_step(mesh=M.TrainMesh(None, None, 0, 0, 1, 3, CPU))


@pytest.fixture
def one_rank_gloo():
    """A one-rank gloo process group in this process, destroyed after."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


REFUSALS = {
    "several ranks, no group": (dict(dp=2, device="cpu"), ValueError,
                                "process group"),
    "dp x mp without a group": (dict(dp=1, mp=2, device="cpu"), ValueError,
                                "process group"),
    "mp does not divide": (dict(mp=2, device="cpu"), ValueError,
                           "does not divide"),
    "an empty axis": (dict(dp=0, device="cpu"), ValueError, "at least one"),
    "no card": (dict(dp=1), RuntimeError, "no CUDA device"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_make_train_mesh_refuses(case):
    """No quiet fallback: each of these raises."""
    if case == "no card" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    kw, exc, match = REFUSALS[case]
    with pytest.raises(exc, match=match):
        M.make_train_mesh(**kw)


def test_make_train_mesh_over_a_group(one_rank_gloo, monkeypatch):
    """Over a one-rank gloo group: both axes are the group (its
    collectives run for real), ``dp=1, mp=1`` is the mesh without a group,
    a size that is not the group's raises, and so does a gloo group on a
    card."""
    mesh = M.make_train_mesh(device="cpu")
    assert (mesh.dp, mesh.mp, mesh.dp_rank, mesh.mp_rank) == (1, 1, 0, 0)
    assert mesh.dp_group is one_rank_gloo and mesh.mp_group is one_rank_gloo
    x = _leaf((6,), 4)
    y = all_reduce_sum(x * 2.0, mesh.dp_group)
    y.backward(torch.ones(6))
    assert torch.equal(y, x * 2.0) and torch.equal(x.grad, torch.full(
        (6,), 2.0))
    none = M.make_train_mesh(1, 1, device="cpu")
    assert none.dp_group is None and none.mp_group is None
    with pytest.raises(ValueError, match="the process group has 1"):
        M.make_train_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="the process group has 1"):
        M.make_train_mesh(1, 2, device="cpu", group=one_rank_gloo)
    monkeypatch.setattr(M, "_rank_device",
                        lambda device, rank: torch.device("cuda", 0))
    with pytest.raises(ValueError, match="nccl process group, not gloo"):
        M.make_train_mesh(device="cuda")


# ------------------------------------------------------ across processes

def _reid_one_rank(state, images, labels):
    """The one-rank port step (``mesh=None``) from a gathered state: ->
    (loss, acc, params, stats) after it."""
    params, stats, bufs = state
    params = to_torch(params, CPU, trainable=True)
    init, step = RT.make_train_step()
    opt = init(params)
    for p, buf in zip(tree_leaves(params), tree_leaves(bufs)):  # none at 0
        opt.state[p]["momentum_buffer"] = torch.from_numpy(buf.copy())
    stats, loss, acc = step(params, opt, to_torch(stats, CPU), images, labels)
    return float(loss), float(acc), params, stats


@pytest.fixture(scope="module")
def reid_first_step():
    """The one-rank step from the seeded state, which both world sizes
    start from (each test holds its ranks' initial state to it)."""
    params, stats, images, labels = reid_case()
    return _reid_one_rank((params, stats, None), images, labels)


def _update_ratio(got, want, before):
    """|got - want| over |want - before|, every leaf flattened together."""
    flat = [np.concatenate([np.asarray(a).ravel() for a in tree_leaves(t)])
            for t in (got, want, before)]
    return np.linalg.norm(flat[0] - flat[1]) / np.linalg.norm(
        flat[1] - flat[2])


def _same_on_every_rank(ranks, job):
    """The replicated (and gathered) state is equal on every rank, bit for
    bit, after every step."""
    for r in ranks[1:]:
        for k, (a, b) in enumerate(zip(r[job]["states"],
                                       ranks[0][job]["states"])):
            for u, v in zip(tree_leaves(a), tree_leaves(b)):
                np.testing.assert_array_equal(u, v, err_msg=f"state {k}")
        assert r[job]["loss"] == ranks[0][job]["loss"]


@pytest.mark.parametrize("world", [2, 4])
def test_reid_steps_over_ranks(ranks, world, reid_first_step):
    """The ReID step at 2 ranks (dp 2) and 4 (dp 2 x mp 2) against the
    one-rank port step, each of 3 steps from the ranks' own state before
    it: the loss within rtol 1e-5 and the accuracy equal (the reference
    test's bounds), the new BN statistics within rtol 1e-4, atol 1e-6, and
    the update of all params together within 2e-2 of its norm (the L2
    norm of the difference over that of the one-rank step's update). A
    rank's convs see half the batch and sum in another order; a ReLU
    whose input lies within that rounding of zero passes its gradient on
    one side only, and the batch-statistics BN spreads it over the
    channel, so the first step's update differs by 6.3e-3 of its norm at
    both world sizes (at most 1.7e-4 after) -- as far as the one-rank
    f32 step lies from the same step in f64 (6.8e-3). The state is equal
    on every rank; the gathered initial state is the seeded tree."""
    params, stats, images, labels = reid_case()
    res = ranks.result(world)
    _same_on_every_rank(res, "reid")
    out = res[0]["reid"]
    for a, b in zip(tree_leaves(out["states"][0][:2]),
                    tree_leaves((params, stats))):
        np.testing.assert_array_equal(a, b)
    for k in range(STEPS):
        loss, acc, p, s = (reid_first_step if k == 0 else _reid_one_rank(
            out["states"][k], images, labels))
        np.testing.assert_allclose(out["loss"][k], loss, rtol=1e-5,
                                   err_msg=f"step {k}")
        assert out["metric"][k] == acc, k
        for a, b in zip(tree_leaves(out["states"][k + 1][1]),
                        tree_leaves(s)):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=f"stats, step {k}")
        ratio = _update_ratio(out["states"][k + 1][0],
                              [q.detach().numpy() for q in tree_leaves(p)],
                              out["states"][k][0])
        assert ratio <= 2e-2, (k, ratio)


def test_detector_steps_over_two_ranks(ranks):
    """The detector step at 2 ranks (dp 2, 2 images each) against the
    one-rank port step, each of 3 steps from the ranks' own state before
    it: loss rtol 1e-4, params and BN statistics rtol 2e-4, atol 2e-5
    (the reference test's bounds), every loss term within rtol 1e-4. The
    state is equal on both ranks."""
    plan, params, stats, images, targets, tmask = detector_case()
    res = ranks.result(2)
    _same_on_every_rank(res, "detector")
    out = res[0]["detector"]
    step = TC.make_detection_train_step(plan)
    for k in range(STEPS):
        p = to_torch(out["states"][k][0], CPU, trainable=True)
        opt = torch.optim.SGD(tree_leaves(p), lr=DET_LR)
        s, loss, metrics = step(p, opt, to_torch(out["states"][k][1], CPU),
                                images, targets, tmask)
        np.testing.assert_allclose(out["loss"][k], float(loss), rtol=1e-4,
                                   err_msg=f"step {k}")
        for name, v in metrics.items():
            np.testing.assert_allclose(out["metric"][k][name], float(v),
                                       rtol=1e-4, atol=1e-7,
                                       err_msg=f"{name}, step {k}")
        for a, b in zip(tree_leaves(out["states"][k + 1][:2]),
                        tree_leaves((p, s))):
            np.testing.assert_allclose(a, b.detach().numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=f"step {k}")


def test_unequal_shards_raise(ranks):
    """A dp group whose ranks hold 2 and 3 rows: both ranks raise."""
    res = ranks.result(2)
    for r in res:
        assert "every rank must hold the same shard" in r["unequal_shards"]


@pytest.mark.parametrize("net", ["reid", "detector"])
def test_first_step_loss_matches_jax(ranks, net):
    """The first step's loss of every multi-rank run equals the loss the
    JAX package's single-device step takes on the same inputs -- its
    train-mode forward and loss, jitted without the update, which the
    other tests hold: ReID rtol 1e-5, detector rtol 1e-4 (the reference
    tests' bounds; the JAX package's own slow tests hold that step equal
    to its dp-sharded one)."""
    if net == "reid":
        params, stats, images, labels = reid_case()

        def loss_of(p, s, x, y):  # the JAX step's loss_fn
            logits, _ = JT.reid_train_apply(p, s, x, train=True)
            logp = jax.nn.log_softmax(logits)
            return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))

        want = jax.jit(loss_of)(params, stats, images,
                                labels.astype(np.int32))
        got = [ranks.result(w)[0]["reid"]["loss"][0] for w in (2, 4)]
        rtol = 1e-5
    else:
        from yolo_deepsort_tpu.cfg.architectures import (
            ARCHITECTURES as J_ARCH)
        from yolo_deepsort_tpu.train.yolo_loss import yolo_loss as j_loss

        _, params, stats, images, targets, tmask = detector_case()
        jplan = j_build(J_ARCH[DET_ARCH](img_size=DET_SIZE))
        forward = JC.make_forward_train(jplan, bn_update=0.01)

        def loss_of(p, s, x, t, m):  # the JAX step's loss_fn
            return j_loss(jplan, forward(p, s, x)[0], t, m)[0]

        want = jax.jit(loss_of)(params, stats, images, targets, tmask)
        got = [ranks.result(2)[0]["detector"]["loss"][0]]
        rtol = 1e-4
    for g in got:
        np.testing.assert_allclose(g, float(want), rtol=rtol)


def test_dryrun_multichip_two_cpu_processes(ranks):
    """The port's dryrun tool, 2 gloo ranks: part (a) on a 1 x 2 dp/mp
    mesh and part (d) over both ranks, the reference's lines with the
    losses of zero inputs (log 64 for the head)."""
    outs = ranks.result("dryrun")
    for i, out in enumerate(outs):
        assert (f"rank {i}: [dryrun] reid train step ok on 1x2 dp/mp mesh: "
                f"loss=4.1589") in out, out[-2000:]
        assert (f"rank {i}: [dryrun] dp-sharded detector train step ok over "
                f"2 devices: loss=") in out, out[-2000:]
