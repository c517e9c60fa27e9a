"""The int8 gates' kernel routes on the card against their plain versions
(``yolo_deepsort_tpu_torch/tools/int8_gate.py``, ``int8_detect_gate.py``):

* the int8-resident embed (kernel 8, 15 launches a call) equal to its
  plain version on the same card tensors, bit for bit;
* the detector's int8 route (kernel 7's int8 mode on the packaged layers,
  its bf16 mode elsewhere) against the plain twin on the honest load at
  yolov3-416, 2 x 1080p: decoded outputs exactly equal (kernel 7's int8
  mode equals its plain version, and every unpackaged conv runs kernel 7
  on both routes), kernel 7 launched once per conv on the kernel route and
  once per unpackaged conv on the twin.

The ``gpu`` tests skip without a CUDA device. This file imports no jax, so
on the machine with the card:

    python -m pytest --noconftest -q -m gpu tests/test_torch_port_int8_gates_gpu.py
"""

import copy

import numpy as np
import pytest
import torch


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
