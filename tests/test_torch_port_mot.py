"""The port's tracking-quality gate and its copied host utilities.

* ``utils/mot.py``, ``utils/metrics.py`` and ``utils/profiling.py`` of the
  port against the JAX package's on the same inputs (MOTChallenge file IO
  on a generated sequence directory included).
* MOT parity: the scene of ``tests/test_integration_mot.py`` (seed 3, 40
  frames, 4 objects, feature dimension 32) through the port's
  ``tracker_step`` reaches exactly the JAX tracker's MOTA, ID switches and
  IDF1. The scene generator (``chip_smoke.mot_scene``, which the smoke's
  tracking-quality phase runs on the card) first reproduces
  ``synthetic_eval``'s JAX numbers exactly (``benchmarks/mot_eval.py``).
"""

import dataclasses
import json
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: E402

import chip_smoke

from yolo_deepsort_tpu.config import TrackerConfig as JTrackerConfig
from yolo_deepsort_tpu.tracking.tracker import init_tracker_state as j_init
from yolo_deepsort_tpu.tracking.tracker import tracker_step as j_step
from yolo_deepsort_tpu.utils import metrics as JM
from yolo_deepsort_tpu.utils import mot as JMOT
from yolo_deepsort_tpu.utils import profiling as JP
from yolo_deepsort_tpu_torch.config import TrackerConfig
from yolo_deepsort_tpu_torch.tracking.tracker import (
    init_tracker_state,
    tracker_step,
)
from yolo_deepsort_tpu_torch.utils import metrics as TM
from yolo_deepsort_tpu_torch.utils import mot as TMOT
from yolo_deepsort_tpu_torch.utils import profiling as TP

REPO = Path(__file__).resolve().parent.parent
SCENE = dict(seed=3, n_frames=40, n_objects=4, feat_dim=32)
IMG_HW = (1080, 1920)


def _random_tracks(rng, n_frames, n_ids, jitter):
    """Per-frame gt rows [id, x1, y1, x2, y2] of walking boxes and
    hypothesis rows [x1, y1, x2, y2, id] near them, with misses, false
    positives and relabelings."""
    pos = rng.uniform(0, 500, (n_ids, 2))
    vel = rng.normal(0, 4, (n_ids, 2))
    gt, hyp = [], []
    for t in range(n_frames):
        g, h = [], []
        for i in range(n_ids):
            x, y = pos[i] + vel[i] * t
            box = np.array([x, y, x + 40, y + 90])
            if rng.uniform() < 0.9:
                g.append([i + 1, *box])
            if rng.uniform() < 0.85:
                hid = i + 1 + (10 if t > n_frames // 2 and i == 0 else 0)
                h.append([*(box + rng.normal(0, jitter, 4)), hid])
        if rng.uniform() < 0.3:
            h.append([*rng.uniform(0, 600, 2), 700, 700, 99])
        gt.append(np.array(g, np.float64).reshape(-1, 5))
        hyp.append(np.array(h, np.float64).reshape(-1, 5))
    return gt, hyp


@pytest.mark.parametrize("jitter", [2.0, 12.0])
def test_mot_metrics_equal_the_originals(jitter):
    gt, hyp = _random_tracks(np.random.default_rng(int(jitter)), 30, 5,
                             jitter)
    for thr in (0.5, 0.3):
        got = dataclasses.asdict(TMOT.evaluate_mot(gt, hyp, thr))
        want = dataclasses.asdict(JMOT.evaluate_mot(gt, hyp, thr))
        assert np.isnan(got.pop("idf1")) and np.isnan(want.pop("idf1"))
        assert got == want and got["id_switches"] > 0
        assert TMOT.idf1_score(gt, hyp, thr) == JMOT.idf1_score(gt, hyp, thr)
    a, b = np.concatenate(gt)[:, 1:], np.concatenate(hyp)[:, :4]
    np.testing.assert_array_equal(TMOT._iou(a, b), JMOT._iou(a, b))
    m = TMOT.evaluate_mot(gt, hyp)
    m.idf1 = TMOT.idf1_score(gt, hyp)
    j = JMOT.evaluate_mot(gt, hyp)
    j.idf1 = JMOT.idf1_score(gt, hyp)
    assert str(m) == str(j)


def test_mot_file_io_equals_the_originals(tmp_path):
    """``load_mot_file`` and ``mot_sequence_frames`` on a generated
    MOTChallenge sequence directory: gt rows with non-person classes,
    low visibility and ignore regions, det rows with -1 placeholders."""
    rng = np.random.default_rng(4)
    seq = tmp_path / "SYN-01"
    (seq / "gt").mkdir(parents=True)
    (seq / "det").mkdir()
    gt_rows, det_rows = [], []
    for f in range(1, 13):
        for i in range(1, 6):
            if f in (4, 5) and i > 1:
                continue  # frames with few rows; frame 7 has none below
            if f == 7:
                continue
            x, y = rng.uniform(0, 900, 2)
            cls = [1, 1, 2, 7, -1][i - 1]
            conf = 0 if (f, i) == (3, 2) else 1
            gt_rows.append([f, i, x, y, 40, 90, conf, cls,
                            rng.uniform(0, 1)])
            det_rows.append([f, -1, x + 1, y - 1, 41, 88,
                             rng.uniform(0, 1), -1, -1, -1])
    np.savetxt(seq / "gt" / "gt.txt", gt_rows, delimiter=",", fmt="%.4f")
    np.savetxt(seq / "det" / "det.txt", det_rows, delimiter=",",
               fmt="%.4f")
    for name, kwargs in (("gt", dict(min_visibility=0.25)),
                         ("gt", dict(person_only=False)),
                         ("det", dict())):
        path = seq / name / f"{name}.txt"
        got = TMOT.load_mot_file(path, **kwargs)
        want = JMOT.load_mot_file(path, **kwargs)
        assert sorted(got) == sorted(want)
        for f in want:
            np.testing.assert_array_equal(got[f], want[f])
        frames_t = TMOT.mot_sequence_frames(got, 12)
        frames_j = JMOT.mot_sequence_frames(want, 12)
        assert len(frames_t) == 12
        for a, b in zip(frames_t, frames_j):
            np.testing.assert_array_equal(a, b)
    assert 7 not in got and frames_t[6].shape == (0, 5)


def _detections(rng, n, n_cls=3):
    """(n, 7) detection rows (x1, y1, x2, y2, obj, cls_conf, cls)."""
    xy = rng.uniform(0, 300, (n, 2))
    wh = rng.uniform(10, 80, (n, 2))
    return np.concatenate([xy, xy + wh, rng.uniform(0, 1, (n, 2)),
                           rng.integers(0, n_cls, (n, 1))], 1)


def test_detection_metrics_equal_the_originals():
    rng = np.random.default_rng(8)
    outputs = [_detections(rng, int(n)) for n in rng.integers(0, 9, 6)]
    outputs[2] = None
    targets = []
    for i, out in enumerate(outputs):
        if out is None or not len(out):
            continue
        # half the targets near a prediction, half elsewhere
        for row in out[: len(out) // 2 + 1]:
            targets.append([i, row[6], *(row[:4] + rng.normal(0, 3, 4))])
        targets.append([i, rng.integers(0, 3), 5, 5, 40, 60])
    targets = np.asarray(targets, np.float64)
    for thr in (0.5, 0.75):
        got = TM.get_batch_statistics(outputs, targets, thr)
        want = JM.get_batch_statistics(outputs, targets, thr)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(TM.evaluate_map(outputs, targets, thr),
                        JM.evaluate_map(outputs, targets, thr)):
            np.testing.assert_array_equal(a, b)
    a, b = _detections(rng, 5)[:, :4], _detections(rng, 7)[:, :4]
    np.testing.assert_array_equal(TM._iou_matrix(a, b), JM._iou_matrix(a, b))
    rec, prec = np.sort(rng.uniform(0, 1, 9)), rng.uniform(0, 1, 9)
    assert TM.compute_ap(rec, prec) == JM.compute_ap(rec, prec)
    tp = rng.integers(0, 2, 20).astype(float)
    conf, pred = rng.uniform(0, 1, 20), rng.integers(0, 4, 20)
    target_cls = rng.integers(0, 5, 12)
    for a, b in zip(TM.ap_per_class(tp, conf, pred, target_cls),
                    JM.ap_per_class(tp, conf, pred, target_cls)):
        np.testing.assert_array_equal(a, b)
    empty = (np.zeros((0, 6)), [None, None])
    for a, b in zip(TM.evaluate_map(empty[1], empty[0]),
                    JM.evaluate_map(empty[1], empty[0])):
        np.testing.assert_array_equal(a, b)


def test_pipeline_stats_equal_the_original():
    """``PipelineStats`` on the reference's single-stream inputs (a (T,)
    state, a scalar next_id) counts as the original; on the port's
    ``TrackerState`` of S streams it sums S frames per step."""
    class _State:
        def __init__(self, st, nid):
            self.state, self.next_id = st, nid

    steps = [(np.array([True, False, True]), _State(np.array([2, 0, 1, 0]),
                                                    np.int32(3)),
              np.array([True, False, False, False])),
             (np.ones(3, bool), _State(np.array([2, 2, 1, 2]), np.int32(5)),
              np.array([True, True, False, True]))]
    got, want = TP.PipelineStats(), JP.PipelineStats()
    for mask, st, emit in steps:
        got.update(mask, st, emit)
        want.update(mask, st, emit)
    for s in (got, want):
        s.absorb_saturation({"sat_nms_topk": 3, "sat_nms_dets": 1})
    assert got.as_dict() == want.as_dict()
    assert got.lane_saturated_frames == 1 and got.max_track_id == 4

    cfg = TrackerConfig(max_tracks=4, max_dets=2, feat_dim=4, nn_budget=2)
    st = init_tracker_state(cfg, 3, "cpu")
    st.state[1] = 2  # stream 1: every lane occupied
    st.next_id[:] = torch.tensor([1, 5, 3], dtype=torch.int32)
    stats = TP.PipelineStats()
    stats.update(torch.ones((3, 2), dtype=torch.bool), st,
                 torch.zeros((3, 4), dtype=torch.bool))
    assert stats.as_dict() == dict(
        frames=3, detections=6, emitted_tracks=0, max_track_id=4,
        active_tracks=4, confirmed_tracks=4, lane_saturated_frames=1,
        sat_nms_topk=0, sat_nms_dets=0)


def test_timers_and_trace():
    """``StageTimer`` and ``FpsMeter`` are the originals' (same source);
    ``device_trace`` is inert for None and writes a Chrome trace of the
    block otherwise."""
    import inspect

    for name in ("StageTimer", "FpsMeter"):
        assert (inspect.getsource(getattr(TP, name))
                == inspect.getsource(getattr(JP, name))), name
    timer = TP.StageTimer()
    with timer("a"):
        time.sleep(0.01)
    assert timer.count["a"] == 1 and timer.total["a"] >= 0.01
    with TP.device_trace(None):
        pass


def test_device_trace_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "prof"
    with TP.device_trace(str(out)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (trace,) = list(out.iterdir())
    assert trace.name.startswith("trace_") and trace.suffix == ".json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def _scores(gt, hyp):
    m = TMOT.evaluate_mot(gt, hyp)
    m.idf1 = TMOT.idf1_score(gt, hyp)
    return dataclasses.asdict(m)


def test_mot_parity_with_the_jax_tracker():
    """``tests/test_integration_mot.py``'s scene: the JAX tracker on the
    scene of ``chip_smoke.mot_scene`` (the generator the smoke's quality
    phase runs on the card) gives exactly ``synthetic_eval``'s numbers, and
    the port's
    ``tracker_step`` exactly the JAX tracker's MOTA, MOTP, ID switches,
    misses, false positives and IDF1."""
    sys.path.insert(0, str(REPO / "benchmarks"))
    try:
        from mot_eval import synthetic_eval
    finally:
        sys.path.remove(str(REPO / "benchmarks"))
    m_jax, _ = synthetic_eval(**SCENE)

    gt, dets = chip_smoke.mot_scene(**SCENE)
    fd = SCENE["feat_dim"]
    kw = dict(max_tracks=64, max_dets=32, feat_dim=fd, nn_budget=100)
    j_fn = jax.jit(partial(j_step, JTrackerConfig(**kw)))
    j_st = j_init(JTrackerConfig(**kw))
    cfg = TrackerConfig(**kw)
    t_st = init_tracker_state(cfg, 1, "cpu")
    j_hyp, t_hyp = [], []
    for frame in dets:
        packed = chip_smoke.pack_scene_frame([frame], cfg.max_dets, fd)
        j_st, boxes, emit = j_fn(j_st, *(a[0] for a in packed),
                                 np.asarray(IMG_HW, np.int32))
        j_hyp.append(np.asarray(boxes)[np.asarray(emit)].astype(np.float64))
        t_st, boxes, emit = tracker_step(
            cfg, t_st, *(torch.from_numpy(a) for a in packed), IMG_HW)
        t_hyp.append(boxes[0][emit[0]].numpy().astype(np.float64))
    want = dataclasses.asdict(m_jax)
    assert _scores(gt, j_hyp) == want
    got = _scores(gt, t_hyp)
    assert got == want
    assert got["mota"] > 0.5 and got["num_frames"] == SCENE["n_frames"]
