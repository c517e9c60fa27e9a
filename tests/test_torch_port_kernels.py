"""Each kernel module's plain PyTorch version against the JAX package's
Pallas kernel run in interpret mode, as the JAX package's own tests run it
on the CPU. (The CUDA kernels against their plain versions on the card:
tests/test_torch_port_gpu.py.)"""

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from yolo_deepsort_tpu.config import TrackerConfig
from yolo_deepsort_tpu.ops.pallas_crops import pallas_crop_and_normalize_batch
from yolo_deepsort_tpu.ops.pallas_letterbox import pallas_letterbox_batch
from yolo_deepsort_tpu.tracking.tracker import init_tracker_state as j_init
from yolo_deepsort_tpu.tracking.tracker_pallas import (
    tracker_step_fused_batched as j_fused,
)
from yolo_deepsort_tpu_torch.ops import crops_kernel, letterbox_kernel
from yolo_deepsort_tpu_torch.tracking import tracker_kernel
from yolo_deepsort_tpu_torch.tracking.tracker import init_tracker_state

from test_torch_port_tracking import DISCRETE, pack, scene
from torch_port_threads import torch_threads  # noqa: F401


def _frames(seed, b, h, w):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3),
                                                np.uint8)


def _crop_boxes(seed, b, d, h, w, max_w=40, max_h=30):
    rng = np.random.default_rng(seed)
    bw = rng.uniform(2, max_w, (b, d))
    bh = rng.uniform(2, max_h, (b, d))
    x1 = rng.uniform(-10, w, (b, d))
    y1 = rng.uniform(-10, h, (b, d))
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1)
    return np.clip(boxes, 0, [w - 1, h - 1, w - 1, h - 1]).astype(np.float32)


@pytest.mark.parametrize("hw", [(48, 64), (64, 48), (36, 64)])
def test_letterbox_plain_vs_pallas_interpret(hw):
    frames = _frames(0, 2, *hw)
    want = np.asarray(pallas_letterbox_batch(frames, size=32, tile=8,
                                             interpret=True))
    got = letterbox_kernel.letterbox_batch_fused(
        torch.from_numpy(frames), 32).numpy()
    np.testing.assert_allclose(got, want, atol=3e-3)  # Pallas test tolerance


def test_crops_plain_vs_pallas_interpret():
    frames = _frames(2, 2, 64, 128)
    boxes = _crop_boxes(2, 2, 5, 64, 128)
    want = np.asarray(pallas_crop_and_normalize_batch(
        frames, boxes, 32, 40, interpret=True))
    got = crops_kernel.crop_and_normalize_fused(
        torch.from_numpy(frames), torch.from_numpy(boxes), 32, 40).numpy()
    assert got.shape == (2, 5, 128, 64, 3)
    # bf16 operands on both sides; the Pallas kernel's aligned window and
    # matmul order move the f32 sums (its own test's tolerance)
    np.testing.assert_allclose(got, want, atol=0.06)


@pytest.mark.parametrize("case", ["multistream", "churn"])
def test_tracker_plain_vs_pallas_interpret(case):
    if case == "multistream":
        cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=5,
                            feat_dim=64)
        rng = np.random.default_rng(3)
        scenes = [scene(rng, 4, 12, 240, 320, dropout=0.1) for _ in range(2)]
    else:
        cfg = TrackerConfig(max_tracks=8, max_dets=8, nn_budget=3,
                            feat_dim=64, max_age=4)
        scenes = [scene(np.random.default_rng(11), 10, 14, 240, 320,
                        dropout=0.35)]
    s = len(scenes)
    img_hw = jnp.array([240, 320], jnp.int32)
    step = jax.jit(lambda st, a, b, c, d: j_fused(cfg, st, a, b, c, d, img_hw,
                                                  interpret=True))
    j_state = jax.tree.map(lambda x: jnp.stack([x] * s), j_init(cfg))
    t_state = init_tracker_state(cfg, s, "cpu")
    for f in range(len(scenes[0])):
        args = pack(scenes, f, cfg.max_dets)
        j_state, j_out, j_emit = step(j_state, *args)
        t_state, t_out, t_emit = tracker_kernel.tracker_step_fused_batched(
            cfg, t_state, *(torch.from_numpy(a) for a in args), (240, 320))
        for name in DISCRETE:
            np.testing.assert_array_equal(
                getattr(t_state, name).numpy(),
                np.asarray(getattr(j_state, name)), err_msg=f"{f}: {name}")
        np.testing.assert_array_equal(t_emit.numpy(), np.asarray(j_emit))
        np.testing.assert_array_equal(t_out.numpy()[..., 4],
                                      np.asarray(j_out)[..., 4])
        np.testing.assert_allclose(t_out.numpy()[..., :4],
                                   np.asarray(j_out)[..., :4], atol=1)
        np.testing.assert_allclose(t_state.mean.numpy(),
                                   np.asarray(j_state.mean), rtol=2e-4,
                                   atol=2e-3)
