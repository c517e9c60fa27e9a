"""The int8 gates' kernel routes on the card against their plain versions
(``yolo_deepsort_tpu_torch/tools/int8_gate.py``, ``int8_detect_gate.py``):

* the int8-resident embed (kernel 8, 15 launches a call) equal to its
  plain version on the same card tensors, bit for bit;
* the detector's int8 route (kernel 7's int8 mode on the packaged layers,
  its bf16 mode elsewhere) against the plain twin on the honest load at
  yolov3-416, 2 x 1080p: decoded outputs exactly equal (kernel 7's int8
  mode equals its plain version, and every unpackaged conv runs kernel 7
  on both routes), kernel 7 launched once per conv on the kernel route and
  once per unpackaged conv on the twin;
* the track gate's int8 path (``tools/int8_track_gate.py``: the
  reference gate's load at yolov3-416, 2 x 1080p, 12 steps) on kernel 7
  emits exactly the rows of its plain twin, step for step;
* F10's third reading: the trained gate's first two train steps at
  yolov3-416, batch 8, on the card and on the CPU from the same state
  (``port_first_steps``, which the CPU witness
  ``test_torch_port_f10_witness.py`` runs beside the JAX step): step 0's
  losses within ``TRAINED_LOSS_RTOL``, step 1 finite on both or on
  neither; each device's record printed (``pytest -s``).

The ``gpu`` tests skip without a CUDA device. This file imports no jax, so
on the machine with the card:

    python -m pytest --noconftest -q -m gpu tests/test_torch_port_int8_gates_gpu.py
"""

import copy
import json

import numpy as np
import pytest
import torch

TRAINED_LOSS_RTOL = 1e-4  # as test_torch_port_int8_detect_gates.py


def objectness_max(raw_maps, n_classes) -> float:
    """Largest objectness logit over the YOLO heads' raw NHWC maps (3
    anchors a head, objectness at channel 4 of each anchor's block); NaN
    where a map holds a NaN."""
    heads = []
    for m in raw_maps:
        m = np.asarray(m, np.float32)
        heads.append(m.reshape(m.shape[:3] + (-1, 5 + n_classes))[..., 4].max())
    return float(np.max(heads))


def port_first_steps(device, model="yolov3", size=416, batch=8, lr=5e-4,
                     seed=0, steps=2):
    """The trained int8 gate's first ``steps`` train steps on ``device``,
    from the state ``tools/int8_gate_trained.py`` ``train_detector`` builds
    (``random_raw_params(seed)``, ``4 * batch`` scenes, ``ClippedAdam``,
    its draw order, cuDNN-deterministic convs), with the largest
    objectness logit read before each step and after the last. -> (every
    step's loss, ``steps + 1`` logits)."""
    from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES
    from yolo_deepsort_tpu_torch.models.darknet import build_network
    from yolo_deepsort_tpu_torch.tools import int8_gate_trained as TTG
    from yolo_deepsort_tpu_torch.train.trees import (
        deterministic_convs,
        full_f32,
        to_torch,
    )
    from yolo_deepsort_tpu_torch.train.yolo_cli import (
        make_detection_train_step,
        make_forward_train,
        raw_params_to_train,
    )
    from yolo_deepsort_tpu_torch.utils.checkpoint import tree_leaves
    from yolo_deepsort_tpu_torch.weights import random_raw_params

    plan = build_network(ARCHITECTURES[model](img_size=size))
    rng = np.random.default_rng(seed)
    raw = random_raw_params(plan.defs(), seed=seed)
    n_train = 4 * batch
    scenes = [TTG.synth_scene(rng, size) for _ in range(n_train)]
    # train_detector's loop, with a forward read before each step
    params, stats = raw_params_to_train(raw, plan.defs())
    params = to_torch(params, device, trainable=True)
    stats = to_torch(stats, device)
    opt = TTG.ClippedAdam(tree_leaves(params), lr, max_norm=5.0)
    step = make_detection_train_step(plan)
    forward = make_forward_train(plan)
    imgs_all = np.stack([s[0] for s in scenes]).astype(np.float32) / 255.0
    losses, logits = [], []

    def read(imgs):
        with torch.no_grad(), full_f32(), deterministic_convs():
            maps, _ = forward(params, stats, torch.from_numpy(imgs).to(device))
        return objectness_max([m.cpu().numpy() for m in maps],
                              plan.num_classes)

    for _ in range(steps):
        idx = rng.choice(n_train, batch, replace=False)
        imgs = imgs_all[idx]
        targets, tmask = TTG.batch_targets([scenes[i][1] for i in idx])
        logits.append(read(imgs))
        with deterministic_convs():
            stats, loss, _ = step(params, opt, stats, imgs, targets, tmask)
        losses.append(float(loss))
    logits.append(read(imgs))
    return losses, logits


def first_steps_record(side, losses, logits, **fields) -> dict:
    """One printed JSON line of a ``port_first_steps``-shaped reading."""
    rec = {"side": side, **fields, "losses": losses,
           "objectness_max_per_step": logits[:-1],
           "objectness_max_after_last_step": logits[-1],
           "step1_loss_finite": bool(np.isfinite(losses[1]))}
    print("F10_WITNESS " + json.dumps(rec), flush=True)
    return rec


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_resident_embed_kernel_equals_plain(cuda_device):
    from yolo_deepsort_tpu_torch.models.quantize import (
        quantize_reid_params_resident,
        reid_apply_int8_resident,
    )
    from yolo_deepsort_tpu_torch.models.reid import random_reid_params
    from yolo_deepsort_tpu_torch.ops import conv_int8_kernel
    from yolo_deepsort_tpu_torch.weights import reid_int8_package_to_torch

    params = random_reid_params(0)
    rng = np.random.default_rng(0)
    calib = torch.from_numpy(rng.normal(size=(64, 128, 64, 3)).astype(
        np.float32)).to(cuda_device)
    x = torch.from_numpy(rng.normal(size=(40, 128, 64, 3)).astype(
        np.float32)).to(cuda_device)
    qres = reid_int8_package_to_torch(
        quantize_reid_params_resident(params, calib), cuda_device)
    before = conv_int8_kernel.launches
    got = reid_apply_int8_resident(qres, x, use_pallas=True)
    assert conv_int8_kernel.launches - before == 15
    want = reid_apply_int8_resident(qres, x, use_pallas=False)
    assert conv_int8_kernel.launches - before == 15
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_detector_int8_route_equals_the_plain_twin(cuda_device):
    from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES
    from yolo_deepsort_tpu_torch.models.darknet import build_network
    from yolo_deepsort_tpu_torch.models.quantize_darknet import (
        quantize_darknet_from_frames,
    )
    from yolo_deepsort_tpu_torch.ops.letterbox import letterbox_batch
    from yolo_deepsort_tpu_torch.tools.honest_load import bn_consistent_raw
    from yolo_deepsort_tpu_torch.tools.int8_detect_gate import int8_decode
    from yolo_deepsort_tpu_torch.train.trees import full_f32
    from yolo_deepsort_tpu_torch.weights import darknet_from_raw

    plan = build_network(ARCHITECTURES["yolov3"](img_size=416))
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 1080, 1920, 3), dtype=np.uint8)).to(cuda_device)
    det = darknet_from_raw(plan, bn_consistent_raw(plan, frames)).to(
        cuda_device)
    with full_f32():
        pkg = quantize_darknet_from_frames(det, frames, 416)
    assert len(pkg) == 65
    det16 = copy.deepcopy(det).to(cuda_device, torch.bfloat16,
                                  memory_format=torch.channels_last)
    xs = letterbox_batch(frames, 416)
    got, k7_kernel = int8_decode(det16, xs, pkg, plain_twin=False)
    want, k7_twin = int8_decode(det16, xs, pkg, plain_twin=True)
    assert (k7_kernel, k7_twin) == (len(det16.convs),
                                    len(det16.convs) - len(pkg))
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_track_gate_int8_route_emits_the_plain_twins_rows(cuda_device):
    from yolo_deepsort_tpu_torch.config import DetectorConfig, TrackerConfig
    from yolo_deepsort_tpu_torch.ops import conv_kernel
    from yolo_deepsort_tpu_torch.tools import int8_track_gate as TG

    hw, steps = (1080, 1920), 12
    load = TG.gate_load("yolov3", 416, 2, hw, 0, 100.0, False, 32, 64,
                        cuda_device)
    assert len(load.pkg) == 65
    det_cfg = DetectorConfig(img_size=416, conf_thres=load.thr,
                             nms_thres=0.4, max_dets=64)
    trk_cfg = TrackerConfig(max_dets=64, max_tracks=128)
    paths, det16, reid16 = TG.make_paths(load.detector, load.reid_params,
                                         load.pkg, det_cfg, trk_cfg, hw)
    rows, k7 = {}, {}
    for name in ("int8", "int8_plain"):
        before = conv_kernel.launches
        rows[name] = TG.track_rows(*paths[name], trk_cfg, load.frames,
                                   steps, 0)
        k7[name] = conv_kernel.launches - before
    n_reid = sum(isinstance(m, torch.nn.Conv2d) for m in reid16.modules())
    # the detector's convs count at its eager first step and at the capture
    # of its graph (a replay counts none), the ReID net's every step
    assert k7 == {"int8": 2 * len(det16.convs) + steps * n_reid,
                  "int8_plain": 2 * (len(det16.convs) - len(load.pkg))
                  + steps * n_reid}
    emitted = 0
    for step, (a, b) in enumerate(zip(rows["int8"], rows["int8_plain"])):
        for s, (ra, rb) in enumerate(zip(a, b)):
            np.testing.assert_array_equal(ra, rb,
                                          err_msg=f"step {step} stream {s}")
            emitted += len(ra)
    assert emitted > 0


@pytest.mark.gpu
def test_f10_first_steps_card_against_cpu(cuda_device):
    """F10's third reading: the port's step on the card and on the CPU
    from the same state at the gate's recipe (yolov3-416, batch 8, lr
    5e-4), 2 steps."""
    recs = {dev: first_steps_record(f"port-{dev}", *port_first_steps(dev),
                                    device=str(dev))
            for dev in (cuda_device, "cpu")}
    card, cpu = recs[cuda_device], recs["cpu"]
    np.testing.assert_allclose(card["losses"][0], cpu["losses"][0],
                               rtol=TRAINED_LOSS_RTOL)
    assert card["step1_loss_finite"] == cpu["step1_loss_finite"]
