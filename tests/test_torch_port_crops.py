"""The K=1 step's bf16 ReID crops against the JAX package on the CPU.

The reference's K=1 step (``yolo_deepsort_tpu/parallel/streams.py``
``make_batched_step``) picks with ``lax.cond`` between
``crop_and_normalize_windowed`` (every consumed crop fits the window) and
``crop_and_normalize`` (some crop does not); both round in the dense (XLA)
order and are equal wherever the guard takes the windowed one. The port's
step makes its bf16 crops with one call (``make_k1_crops``: the dense crop
entry, on CPU tensors its plain version ``crop_and_normalize_batch``). Held
here bit for bit: that call against the reference's branch on both sides
of the guard, and the bf16 step with a window against the step without one.
"""

import copy

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from yolo_deepsort_tpu.ops.crops import crop_and_normalize as j_dense
from yolo_deepsort_tpu.ops.crops import (
    crop_and_normalize_windowed as j_windowed,
)
from yolo_deepsort_tpu_torch.config import DetectorConfig, TrackerConfig
from yolo_deepsort_tpu_torch.ops import crops as TC
from yolo_deepsort_tpu_torch.ops import crops_kernel
from yolo_deepsort_tpu_torch.parallel import streams as TS

from test_torch_port_batched_step import H, S, W_, setup  # noqa: F401
from torch_port_threads import torch_threads  # noqa: F401

FRAME_HW, WINDOW = (96, 160), (48, 64)


def _case(seed, oversize):
    """Seeded frames (2, 96, 160, 3) and 7 boxes per frame that fit
    WINDOW; ``oversize`` makes box 1 of frame 0 taller and box 4 of frame 1
    wider than it."""
    rng = np.random.default_rng(seed)
    h, w = FRAME_HW
    frames = rng.integers(0, 256, (2, h, w, 3), np.uint8)
    bw = rng.uniform(1, WINDOW[1] - 1, (2, 7))
    bh = rng.uniform(1, WINDOW[0] - 1, (2, 7))
    x1 = rng.uniform(-5, w - 2, (2, 7))
    y1 = rng.uniform(-5, h - 2, (2, 7))
    if oversize:
        y1[0, 1], bh[0, 1] = 10.0, WINDOW[0] + 20.5
        x1[1, 4], bw[1, 4] = 30.0, WINDOW[1] + 41.25
    boxes = np.clip(np.stack([x1, y1, x1 + bw, y1 + bh], -1), 0,
                    [w - 1, h - 1, w - 1, h - 1]).astype(np.float32)
    return frames, boxes


def _reference(frames, boxes):
    """(windowed, dense) crops of the reference, bf16, vmapped over frames."""
    wh, ww = WINDOW
    win = jax.vmap(lambda f, b: j_windowed(f, b, wh, ww,
                                           compute_dtype=jnp.bfloat16))
    den = jax.vmap(lambda f, b: j_dense(f, b, compute_dtype=jnp.bfloat16))
    return (np.asarray(win(jnp.asarray(frames), jnp.asarray(boxes))),
            np.asarray(den(jnp.asarray(frames), jnp.asarray(boxes))))


@pytest.mark.parametrize("oversize", [False, True],
                         ids=["all-fit", "taller-and-wider"])
def test_k1_crops_equal_the_reference_bf16(oversize):
    frames, boxes = _case(3, oversize)
    h, w = FRAME_HW
    corners = TC.crop_window_bounds(torch.from_numpy(boxes), h, w)
    x1, y1, x2, y2 = (c.numpy() for c in corners)
    fits = bool(((y2 - y1 <= WINDOW[0]) & (x2 - x1 <= WINDOW[1])).all())
    assert fits != oversize
    crops = TS.make_k1_crops(FRAME_HW, WINDOW, torch.bfloat16)
    mask = torch.ones(boxes.shape[:2], dtype=torch.bool)
    got = crops(torch.from_numpy(frames), torch.from_numpy(boxes), mask)
    assert got.dtype == torch.float32 and got.shape == (2, 7, 128, 64, 3)
    windowed, dense = _reference(frames, boxes)
    # the reference's lax.cond: windowed where every crop fits, else dense
    np.testing.assert_array_equal(got.numpy(), windowed if fits else dense)
    np.testing.assert_array_equal(got.numpy(), dense)
    if oversize:  # what the guard protects: the window truncates them
        assert not np.array_equal(windowed, dense)


def test_dense_crops_plain_is_the_per_frame_form():
    """The dense entry's plain version, one set of ops over the batch,
    against the per-frame ``crop_and_normalize`` at bf16, bit for bit
    (frames whose W*3 is not a multiple of 16, 1-pixel and full-frame
    boxes)."""
    rng = np.random.default_rng(9)
    frames = torch.from_numpy(rng.integers(0, 256, (3, 37, 53, 3), np.uint8))
    boxes = torch.from_numpy(np.array([
        [[0, 0, 52, 36], [5, 6, 5.5, 6.5], [40, 30, 52, 36], [0, 0, 1, 1]],
        [[10, 2, 30, 35], [0, 10, 52, 11], [3, 3, 4, 30], [51, 35, 52, 36]],
        [[1.5, 2.5, 20.5, 9.5], [0, 0, 52, 36], [7, 7, 8, 8],
         [20, 0, 21, 36]],
    ], np.float32))
    got = crops_kernel.crop_and_normalize_dense(frames, boxes)
    want = torch.stack([TC.crop_and_normalize(frames[i], boxes[i],
                                              compute_dtype=torch.bfloat16)
                        for i in range(3)])
    assert torch.equal(got, want)
    assert crops_kernel.crop_and_normalize_dense(
        frames[:, :, :, :], boxes[:, :0]).shape == (3, 0, 128, 64, 3)


def test_bf16_k1_step_window_changes_nothing(setup):  # noqa: F811
    """The bf16 K=1 step (bf16 detector and ReID on the CPU) with
    ``crop_window`` (8, 8) -- every crop exceeds it -- and (32, 40) gives the
    outputs, emits, gallery and means of the step without a window, bit for
    bit, as the f32 step does (``test_window_guard_takes_the_dense_crops``)."""
    det_cfg = DetectorConfig(img_size=64, conf_thres=setup["thr"],
                             max_dets=8)
    trk_cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
    detector = copy.deepcopy(setup["detector"]).to(torch.bfloat16)
    reid = copy.deepcopy(setup["reid"]).to(torch.bfloat16)
    frames = torch.from_numpy(setup["frames"])
    results = []
    for window in (None, (8, 8), (32, 40)):
        step = TS.make_batched_step(detector, reid, det_cfg, trk_cfg,
                                    (H, W_), cap=6, crop_window=window)
        st = TS.init_stream_states(trk_cfg, S, "cpu")
        emitted = 0
        for _ in range(3):
            st, (out, emit) = step(st, frames)
            emitted += int(emit.sum())
        results.append((st, out, emit, emitted))
    assert results[0][3] > 0, "tracks confirmed and were emitted"
    for st, out, emit, _ in results[1:]:
        assert torch.equal(out, results[0][1])
        assert torch.equal(emit, results[0][2])
        assert torch.equal(st.gallery, results[0][0].gallery)
        assert torch.equal(st.mean, results[0][0].mean)


def test_dense_crops_bytes_count_the_pixels_the_taps_weigh():
    """``chip_smoke.crops_dense_io_bytes`` on hand-worked boxes of a 256 x
    128 frame: a box of the crop's own size weighs 128 rows by 64 columns
    (every coordinate an integer: the second tap weighs 0), the full frame
    every pixel (two taps of 1/2 per output line), a box as wide as the
    frame and 128 rows tall 128 x 128 pixels; two boxes of one frame that
    overlap are counted once, the same box in two frames twice."""
    import chip_smoke

    def count(boxes):
        boxes = torch.tensor(boxes, dtype=torch.float32)
        out = torch.zeros(boxes.shape[:2] + (128, 64, 3))
        return chip_smoke.crops_dense_io_bytes(boxes, (256, 128), out) - (
            boxes.numel() * 4 + out.numel() * 4)

    assert count([[[10, 20, 74, 148]]]) == 3 * 128 * 64
    assert count([[[0, 0, 128, 256]]]) == 3 * 256 * 128
    assert count([[[0, 100, 128, 228]]]) == 3 * 128 * 128
    assert count([[[10, 20, 74, 148], [0, 0, 128, 256]]]) == 3 * 256 * 128
    assert count([[[10, 20, 74, 148]], [[10, 20, 74, 148]]]) == (
        2 * 3 * 128 * 64)


def test_strip_heights_mirror_the_kernel_source():
    """``crops_kernel.STRIP_ROWS`` holds the strip heights that
    ``csrc/crops_stage.cuh`` builds with by default, and ``strip_defines``
    names the three defines it reads."""
    import re

    from yolo_deepsort_tpu_torch.kernels import build

    src = (build.CSRC / "crops_stage.cuh").read_text()
    defaults = dict(re.findall(r"#define (CROPS_STRIP_\w+) (\d+)", src))
    assert {k: int(v) for k, v in defaults.items()} == {
        f"CROPS_STRIP_{entry.upper()}": rows
        for entry, rows in crops_kernel.STRIP_ROWS.items()}
    assert crops_kernel.strip_defines(16) == {k: 16 for k in defaults}


def test_variant_builds_are_keyed_and_flagged_by_their_defines(monkeypatch):
    """A build of one source with extra defines (``build.load_variants``)
    lands under a name of its own per set of defines, and its nvcc command
    carries the package's flags (``sm_90a``, ``--fmad=false``) and every
    define."""
    from yolo_deepsort_tpu_torch.kernels import build

    a = build.variant_path("crops", crops_kernel.strip_defines(8))
    b = build.variant_path("crops", crops_kernel.strip_defines(16))
    stamped = build.variant_path("crops", {"CROPS_STAMPS": 1})
    assert len({a, b, stamped, build.library_path()}) == 4
    assert a == build.variant_path("crops", crops_kernel.strip_defines(8))
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    cmd = build.variant_command("crops", {"CROPS_STAMPS": 1,
                                          "CROPS_STRIP_DENSE": 16}, "x.so")
    assert cmd[0] == "nvcc" and "--fmad=false" in cmd
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-DCROPS_STAMPS=1" in cmd and "-DCROPS_STRIP_DENSE=16" in cmd
    assert cmd[-1].endswith("crops.cu") and "-shared" in cmd


def test_crops_phases_reads_stamps():
    """``tools/crops_phases.phases`` on hand-made stamps of two blocks on
    one SM, two sub-strips each: the phases' mean cycles and the blocks
    the SM ran at once."""
    from yolo_deepsort_tpu_torch.tools.crops_phases import SLOTS, phases

    st = np.zeros((2, SLOTS))
    # start, taps, set-up, first copies, end, SM; sub-strips' landed / stored
    st[0, :8] = [0, 10, 30, 60, 200, 7, 70, 120]
    st[0, 8:10] = [130, 200]
    st[1, :8] = [100, 110, 130, 160, 300, 7, 170, 220]
    st[1, 8:10] = [230, 300]
    got = phases(st, 2)
    assert got["life"] == 200 and got["taps"] == 10
    assert got["row_list_and_setup"] == 20 and got["first_copies"] == 30
    assert got["wait_first_substrip"] == 10
    assert got["wait_per_substrip"] == 10
    assert got["compute_per_substrip"] == 60
    assert got["blocks_at_once_per_sm"] == 400 / 300


def _chunk_case(frame_w):
    """Seeded (2, 64, frame_w, 3) frames and 6 boxes per frame whose
    integer crops fit a (32, 40) window."""
    rng = np.random.default_rng(21)
    h = 64
    frames = rng.integers(0, 256, (2, h, frame_w, 3), np.uint8)
    bw, bh = rng.uniform(1, 38, (2, 6)), rng.uniform(1, 30, (2, 6))
    x1, y1 = rng.uniform(-5, frame_w - 2, (2, 6)), rng.uniform(-5, h - 2,
                                                               (2, 6))
    boxes = np.clip(np.stack([x1, y1, x1 + bw, y1 + bh], -1), 0,
                    [frame_w - 1, h - 1, frame_w - 1, h - 1])
    return frames, boxes.astype(np.float32)


@pytest.mark.parametrize("frame_w", [120, 128], ids=["refused", "gated"])
def test_chunk_crops_follow_the_reference_crop_gate(frame_w, monkeypatch):
    """The chunk step's bf16 windowed crops (``make_chunk_crops``, the
    bucketed track stage's) on a frame the reference's crop gate refuses
    (64 x 120: 120 % 128 != 0) equal the JAX step's crops there bit for
    bit -- ``crop_and_normalize_windowed`` at bf16, the dense order, on its
    CPU and TPU backends alike -- and come from the dense entry, not kernel
    2's plain version. On a frame the gate takes (64 x 128) they are kernel
    2's plain version, as before."""
    frames, boxes = _chunk_case(frame_w)
    assert crops_kernel.crops_pallas_order_supported(64, frame_w) == (
        frame_w == 128)
    k2_calls = []
    plain = crops_kernel.crops_plain
    monkeypatch.setattr(crops_kernel, "crops_plain",
                        lambda *a: k2_calls.append(1) or plain(*a))
    crops = TS.make_chunk_crops((64, frame_w), (32, 40), torch.bfloat16)
    got = crops(torch.from_numpy(frames), torch.from_numpy(boxes)).numpy()
    if frame_w == 128:
        assert k2_calls == [1]
        want = plain(torch.from_numpy(frames), torch.from_numpy(boxes), 32,
                     40).numpy()
        np.testing.assert_array_equal(got, want)
        return
    assert k2_calls == []
    win = jax.vmap(lambda f, b: j_windowed(f, b, 32, 40,
                                           compute_dtype=jnp.bfloat16))
    want = np.asarray(win(jnp.asarray(frames), jnp.asarray(boxes)))
    np.testing.assert_array_equal(got, want)
    # what the fault was: kernel 2's rounding order differs almost
    # everywhere on such a frame
    k2 = plain(torch.from_numpy(frames), torch.from_numpy(boxes), 32,
               40).numpy()
    assert (k2 != want).mean() > 0.5


@pytest.mark.parametrize("window", [None, (64, 128)],
                         ids=["no-window", "full-frame-window"])
def test_chunk_crops_dense_branch_equals_the_reference(window):
    """The chunk step's bf16 crops without a window (a chunk whose largest
    crop exceeds the ladder's top, or a full-frame window) are one call of
    the dense entry, bit-equal to the JAX step's ``vmap(crop_and_normalize)``
    at bf16."""
    frames, boxes = _chunk_case(128)
    boxes[0, 0] = [0, 0, 127, 63]  # a full-frame box
    crops = TS.make_chunk_crops((64, 128), window, torch.bfloat16)
    got = crops(torch.from_numpy(frames), torch.from_numpy(boxes)).numpy()
    den = jax.vmap(lambda f, b: j_dense(f, b, compute_dtype=jnp.bfloat16))
    want = np.asarray(den(jnp.asarray(frames), jnp.asarray(boxes)))
    np.testing.assert_array_equal(got, want)


def test_dense_crops_batch_is_the_per_frame_form_f32():
    """``crop_and_normalize_batch`` at f32 -- the f32 dense crops of the
    monolithic step (``streams.dense_crops(..., batched=True)``) -- against
    the per-frame ``crop_and_normalize``, bit for bit: every output sums two
    non-zero taps per axis, and the batched contractions add them in the
    same order."""
    rng = np.random.default_rng(9)
    for b, h, w, d in ((3, 37, 53, 4), (4, 96, 160, 7), (2, 270, 480, 16)):
        frames = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3),
                                               np.uint8))
        x1, y1 = rng.uniform(-5, w, (b, d)), rng.uniform(-5, h, (b, d))
        bw, bh = rng.uniform(1, w, (b, d)), rng.uniform(1, h, (b, d))
        boxes = torch.from_numpy(np.clip(
            np.stack([x1, y1, x1 + bw, y1 + bh], -1), 0,
            [w - 1, h - 1, w - 1, h - 1]).astype(np.float32))
        got = TS.dense_crops(frames, boxes, torch.float32, batched=True)
        want = torch.stack([TC.crop_and_normalize(frames[i], boxes[i])
                            for i in range(b)])
        assert torch.equal(got, want), (b, h, w, d)
