"""The plain reference against the program's own plain CPU path, in
float32, on tiny inputs: the darknet forward (yolov3-tiny at 64 px and
yolov4 cut to 64 px), the letterbox, the NMS, the ReID crops and embed,
and the tracker, step by step and from a snapshot of the program's state.

    python -m pytest -q gpubench/
"""

import numpy as np
import pytest
import torch

from gpubench import load, run
from gpubench.reference import darknet as ref_darknet
from gpubench.reference import nms as ref_nms
from gpubench.reference import reid as ref_reid
from gpubench.reference.tracker import Tracker

CPU = torch.device("cpu")


def _cfg(name):
    return ref_darknet.parse_cfg((run.HERE / "configs" / name).read_text())


@pytest.mark.parametrize("name", ["yolov3-tiny.cfg", "yolov4.cfg"])
def test_darknet_forward_matches_the_program(name):
    """BN statistics spread over a range, not captured: captured on two
    64 px frames, a deep layer's 2 x 2 maps give BN a handful of values a
    channel, and its near-zero variances amplify float32 rounding."""
    from yolo_deepsort_tpu_torch.models.darknet import build_network
    from yolo_deepsort_tpu_torch.ops.letterbox import letterbox_batch
    from yolo_deepsort_tpu_torch.weights import darknet_from_raw

    size = 64
    defs = _cfg(name)
    frames = load.frames(7, 2, (48, 80), CPU)[0]
    raw = load.darknet_raw(defs[1:], size, 7, CPU)
    for layer in raw.values():
        if "bn_var" in layer:
            c = layer["bn_var"].shape[0]
            layer.update(bn_var=torch.linspace(0.5, 2.0, c),
                         bn_mean=torch.linspace(-0.1, 0.1, c),
                         bn_weight=torch.linspace(0.8, 1.2, c),
                         bn_bias=torch.linspace(-0.05, 0.05, c))
    load.plant_box_prior(defs[1:], raw, size, (48, 80), [600.0, 900.0],
                         0.41)
    x = ref_darknet.letterbox(frames, size)
    torch.testing.assert_close(
        x.permute(0, 2, 3, 1), letterbox_batch(frames, size),
        rtol=0, atol=1e-6)
    want = ref_darknet.forward(defs[1:], raw, x, size)
    plan = build_network(defs, size)
    prog = darknet_from_raw(plan, {i: {k: v.numpy() for k, v in l.items()}
                                   for i, l in raw.items()})
    with torch.no_grad():
        got = prog(x.permute(0, 2, 3, 1))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_bn_capture_makes_the_eval_forward_reproduce_the_capture_pass():
    defs = _cfg("yolov3-tiny.cfg")[1:]
    frames = load.frames(8, 3, (48, 80), CPU)[0]
    raw = load.darknet_raw(defs, 64, 8, CPU)
    x = ref_darknet.letterbox(frames, 64)
    train = ref_darknet.forward(defs, raw, x, 64, capture_bn=True)
    torch.testing.assert_close(ref_darknet.forward(defs, raw, x, 64), train)
    conv0 = torch.nn.functional.conv2d(x, raw[0]["conv_weight"], None, 1, 1)
    torch.testing.assert_close(raw[0]["bn_var"], (conv0 ** 2).mean((0, 2, 3)))
    assert not raw[0]["bn_mean"].any()


@pytest.mark.parametrize("name", ["yolov3-tiny.cfg", "yolov4.cfg"])
def test_head_logits_invert_the_decode(name):
    from gpubench import compare

    defs = _cfg(name)[1:]
    g = torch.Generator().manual_seed(4)
    heads = ref_darknet.yolo_heads(defs)
    size, raws, decoded = 64, [], []
    grid = compare.head_grid(defs, size)
    for idx, anchors, classes, sxy in heads:
        cells = {c["index"]: c["hout"]
                 for c in ref_darknet.conv_shapes(defs, size)}[idx - 1]
        raw = torch.randn((2, len(anchors) * (5 + classes), cells, cells),
                          generator=g, dtype=torch.float64)
        decoded.append(ref_darknet.decode(raw, anchors, classes, size, sxy))
        a = len(anchors)
        raws.append(raw.reshape(2, a, 5 + classes, cells, cells).permute(
            0, 1, 3, 4, 2).reshape(2, -1, 5 + classes))
    want = torch.cat(raws, 1).numpy()
    got = compare.head_logits(torch.cat(decoded, 1).numpy(), grid)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_nms_matches_the_program():
    from yolo_deepsort_tpu_torch.ops.nms import batched_nms_with_stats_plain

    g = torch.Generator().manual_seed(3)
    n, b, c = 3, 300, 4
    xy = torch.rand((n, b, 2), generator=g) * 200
    wh = torch.rand((n, b, 2), generator=g) * 40 + 10
    scores = torch.rand((n, b, 1 + c), generator=g)
    pred = torch.cat([xy, wh, scores], -1)
    thr = [0.7, 0.8, 0.9]
    boxes7, mask, _ = batched_nms_with_stats_plain(
        pred, torch.tensor(thr), 0.4, 64, 32)
    for i in range(n):
        want = ref_nms.nms_image(pred[i].numpy(), thr[i], 0.4, 64, 32)
        got = boxes7[i][mask[i]].numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)



def _candidates(seed, frames, b=300, c=3):
    """(frames, b, 6 + c) rows in row order with their row index last,
    clustered so that boxes of one class overlap and merge."""
    g = np.random.default_rng(seed)
    xy = g.uniform(0, 120, (frames, b, 2))
    wh = g.uniform(10, 40, (frames, b, 2))
    scores = g.uniform(0, 1, (frames, b, 1 + c)).astype(np.float32)
    idx = np.broadcast_to(np.arange(b, dtype=float)[:, None], (frames, b, 1))
    return np.concatenate([xy, wh, scores, idx], -1)


@pytest.mark.parametrize("seed", [1, 2])
def test_kept_count_matches_the_reference_nms(seed):
    cand = _candidates(seed, 2)
    for rows in cand:
        count = load.KeptCount(rows, 0.4, 64, 20)
        for thr in np.linspace(0.2, 0.99, 40):
            assert count(thr) == len(ref_nms.nms_image(
                rows[:, :-1], thr, 0.4, 64, 20)), thr


def test_thresholds_leave_the_fullest_frame_its_count():
    det = {"nms_thres": 0.4, "max_boxes": 64, "max_dets": 40}
    cand = _candidates(3, 6).reshape(3, 2, 300, -1)
    thr = load.stream_thresholds(cand, 12, det)
    for s, t in enumerate(thr):
        counts = [len(ref_nms.nms_image(cand[v, s, :, :-1], t, 0.4, 64, 40))
                  for v in range(3)]
        assert max(counts) == 12, counts
    t = load.pooled_threshold(cand, 15, det)
    assert max(len(ref_nms.nms_image(c[:, :-1], t, 0.4, 64, 40))
               for c in cand.reshape(6, 300, -1)) == 15


def test_reid_crops_and_embed_match_the_program():
    from yolo_deepsort_tpu_torch.models.reid import params_from_state_dict
    from yolo_deepsort_tpu_torch.ops.crops import crop_and_normalize
    from yolo_deepsort_tpu_torch.weights import reid_from_params

    frame = load.frames(5, 1, (120, 200), CPU)[0, 0]
    boxes = torch.tensor([[3.7, 5.2, 60.9, 110.4], [100.0, 0.0, 199.0, 119.0],
                          [150.5, 60.5, 151.2, 61.0]])
    x = ref_reid.crops(frame, boxes.double())
    torch.testing.assert_close(
        x.permute(0, 2, 3, 1), crop_and_normalize(frame, boxes),
        rtol=1e-5, atol=1e-5)
    sd = load.reid_state_dict(5, CPU)
    net = reid_from_params(params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}))
    with torch.no_grad():
        torch.testing.assert_close(net(x.permute(0, 2, 3, 1)),
                                   ref_reid.embed(sd, x), rtol=1e-4,
                                   atol=1e-5)


TRK = {"max_tracks": 16, "max_dets": 8, "feat_dim": 8, "nn_budget": 5,
       "max_dist": 0.2, "min_confidence": 0.3, "nms_max_overlap": 1.0,
       "max_iou_distance": 0.7, "max_age": 4, "n_init": 3}
HW = (480, 640)


def _scene(seed, frames=24, objects=5):
    """Moving boxes with dropouts, a few low-confidence rows, unit
    features near one vector per object."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(objects, TRK["feat_dim"]))
    pos = rng.uniform([50, 50], [500, 350], (objects, 2))
    vel = rng.uniform(-6, 6, (objects, 2))
    size = rng.uniform([30, 60], [60, 120], (objects, 2))
    out = []
    for t in range(frames):
        tlwh, conf, feat = [], [], []
        for o in range(objects):
            if rng.uniform() < 0.15 or (o == 4 and 8 <= t < 15):
                continue
            tlwh.append(np.r_[pos[o] + vel[o] * t + rng.normal(0, 1, 2),
                              size[o]])
            conf.append(rng.uniform(0.2, 1.0))
            f = base[o] + rng.normal(0, 0.05, TRK["feat_dim"])
            feat.append(f / np.linalg.norm(f))
        out.append((np.array(tlwh, np.float32).reshape(-1, 4),
                    np.array(conf, np.float32),
                    np.array(feat, np.float32).reshape(-1, TRK["feat_dim"])))
    return out


def _pad(frame, d):
    tlwh, conf, feat = frame
    n = len(tlwh)
    t = np.zeros((d, 4), np.float32)
    c = np.zeros(d, np.float32)
    f = np.zeros((d, TRK["feat_dim"]), np.float32)
    t[:n], c[:n], f[:n] = tlwh, conf, feat
    return t, c, f, np.arange(d) < n


@pytest.mark.parametrize("seed", range(4))
def test_tracker_matches_the_program(seed):
    from yolo_deepsort_tpu_torch.config import TrackerConfig
    from yolo_deepsort_tpu_torch.tracking.tracker import (init_tracker_state,
                                                          tracker_step)

    from gpubench import serve

    cfg = TrackerConfig(**TRK)
    scenes = [_scene(seed), _scene(seed + 100)]
    state = init_tracker_state(cfg, 2, CPU)
    refs = [Tracker(TRK, HW) for _ in scenes]
    for t in range(len(scenes[0])):
        if t == 12:  # follow the program from a snapshot of its state
            arrays = serve.state_arrays(state)
            refs = [Tracker.from_arrays(TRK, HW, {k: v[s] for k, v in
                                                  arrays.items()})
                    for s in range(2)]
        padded = [_pad(sc[t], TRK["max_dets"]) for sc in scenes]
        t4, c, f, m = (torch.from_numpy(np.stack(x)) for x in zip(*padded))
        state, rows, emit = tracker_step(cfg, state, t4, c, f, m, HW)
        for s, sc in enumerate(scenes):
            want = refs[s].step(*(a.astype(np.float64) for a in sc[t]))
            got = {int(r[4]): tuple(int(v) for v in r[:4])
                   for r in rows[s][emit[s]].numpy()}
            assert got.keys() == want.keys(), (t, s)
            for k in got:
                assert max(abs(a - b) for a, b in zip(got[k], want[k])) <= 1


def test_a_detection_of_no_height_never_joins_a_track():
    """Its aspect is 0: it starts a tentative track of its own, is
    matched to none, and nothing turns to NaN."""
    cfg = run.load_json(run.HERE / "configs" / "yolov3-416.json")["tracker"]
    trk = Tracker(cfg, (1080, 1920))
    feat = np.zeros((1, 512))
    feat[0, 0] = 1.0
    box = np.array([[100.0, 300.0, 50.0, 120.0]])
    for _ in range(4):
        rows = trk.step(box, np.array([0.9]), feat)
    assert list(rows) == [1]
    flat = np.array([[100.0, 0.0, 50.0, 0.0]])
    for _ in range(3):
        rows = trk.step(flat, np.array([0.9]), feat)
    confirmed = [t for t in trk.tracks if t.state == 2]
    assert [t.track_id for t in confirmed] == [1]
    assert all(np.isfinite(t.mean).all() for t in trk.tracks)
