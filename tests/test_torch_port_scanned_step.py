"""The monolithic chunk step (``make_scanned_step``) and its per-frame body
(``fused_frame_step``) against the JAX package on the CPU, and against the
port's own K=1 and bucketed steps.

Setup (``test_torch_port_batched_step.setup``): yolov3-tiny at 64, 2
streams of 64x128 frames, identical seeded parameters, static frames so
that tracks confirm, K=3 frames per chunk, max_tracks 16, max_dets 8; one
detection threshold halfway between two objectness values, so the
frameworks' last-bit differences flip no candidate.

bf16: each framework runs its own bf16 forward. Both round where the
reference rounds (bf16 operands, f32 sums, f32 bias and activation, one
rounding per conv); what is left between them is the order of the f32
sums, which flips a bf16 rounding now and then
(``test_bf16_detectors_round_apart`` states the gap). Every bf16 case uses
the setup's threshold but one, which keeps both forwards at a threshold in
the widest gap of the objectness ranks
(``test_scanned_step_bf16_own_forwards_match_jax``).

Tolerances, per frame, f32 and bf16 alike:
* track ids, emit and the state's discrete fields: exactly equal;
* boxes: within 1 px (a Kalman mean an ulp apart truncates to either side);
* Kalman means: rtol 2e-4 / atol 2e-3, as
  ``tests/test_torch_port_tracking.py``.
"""

import copy

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from yolo_deepsort_tpu.config import DetectorConfig as JDetectorConfig
from yolo_deepsort_tpu.config import TrackerConfig as JTrackerConfig
from yolo_deepsort_tpu.models.darknet import network_apply
from yolo_deepsort_tpu.ops.letterbox import letterbox as j_letterbox
from yolo_deepsort_tpu.parallel import streams as JS
from yolo_deepsort_tpu.tracking.tracker import init_tracker_state as j_init
from yolo_deepsort_tpu_torch.config import DetectorConfig, TrackerConfig
from yolo_deepsort_tpu_torch.ops.letterbox_kernel import letterbox_batch_fused
from yolo_deepsort_tpu_torch.parallel import streams as TS

from test_torch_port_batched_step import H, S, W_, setup  # noqa: F401
from test_torch_port_slice import _snapshot
from test_torch_port_tracking import DISCRETE
from torch_port_threads import torch_threads  # noqa: F401

K, CHUNKS = 3, 2
TRK = dict(max_tracks=16, max_dets=8, nn_budget=4)


@pytest.fixture(scope="module")
def scan_setup(setup):  # noqa: F811
    """The shared setup plus the bf16 models, the reference's own f32 and
    bf16 forwards of the frames (``j32``; ``j16`` compiled, as inside its
    step) and classes to filter on (every other class among the first
    frame's detections)."""
    xs = jax.vmap(lambda f: j_letterbox(f, 64))(setup["frames"])
    j32 = setup["dec"]
    j16 = np.asarray(jax.jit(lambda x: network_apply(
        setup["jplan"], setup["folded"], x, compute_dtype=jnp.bfloat16))(xs))
    keep = j32[..., 4] >= setup["thr"]
    classes = np.unique(j32[..., 5:].argmax(-1)[keep])
    assert len(classes) > 1
    return dict(setup, classes=classes[::2].tolist(), j32=j32, j16=j16,
                det16=copy.deepcopy(setup["detector"]).to(torch.bfloat16),
                reid16=copy.deepcopy(setup["reid"]).to(torch.bfloat16))


def _cfgs(thr):
    return (DetectorConfig(img_size=64, conf_thres=thr, max_dets=8),
            TrackerConfig(**TRK),
            JDetectorConfig(img_size=64, conf_thres=thr, max_dets=8),
            JTrackerConfig(**TRK))


def _chunk(setup):  # noqa: F811
    return np.broadcast_to(setup["frames"][None], (K, S, H, W_, 3)).copy()


def _assert_states(t_st, j_st, tag):
    for name in DISCRETE:
        np.testing.assert_array_equal(
            getattr(t_st, name).numpy(), np.asarray(getattr(j_st, name)),
            err_msg=f"{tag}: {name}")
    np.testing.assert_allclose(t_st.mean.numpy(), np.asarray(j_st.mean),
                               rtol=2e-4, atol=2e-3, err_msg=tag)


def _assert_rows(t_out, t_emit, j_out, j_emit, tag):
    np.testing.assert_array_equal(t_emit.numpy(), np.asarray(j_emit),
                                  err_msg=tag)
    np.testing.assert_array_equal(t_out.numpy()[..., 4],
                                  np.asarray(j_out)[..., 4], err_msg=tag)
    np.testing.assert_allclose(t_out.numpy()[..., :4],
                               np.asarray(j_out)[..., :4], atol=1,
                               err_msg=tag)


def _jax_chunks(su, j_det, j_trk, dtype, id_sets):
    """CHUNKS chunks through the JAX package's make_scanned_step, one
    compile for every entry of ``id_sets`` (class-id arrays of one length,
    passed traced as its ``tracked_class_ids``): {key: [(states, outputs,
    emit)] per chunk}. Its tracker branch is ``tracker_step`` (its fused
    kernel runs in Pallas interpret mode on the CPU, and the JAX suite
    holds the two equal)."""
    chunk = _chunk(su)
    step = jax.jit(lambda ids, *args: JS.make_scanned_step(
        su["jplan"], j_det, j_trk, (H, W_), K, tracked_class_ids=ids,
        compute_dtype=(jnp.bfloat16 if dtype == "bf16" else jnp.float32),
        donate_state=False, use_fused_tracker=False).__wrapped__(*args))
    runs = {}
    for key, ids in id_sets.items():
        st, runs[key] = JS.init_stream_states(j_trk, S), []
        for _ in range(CHUNKS):
            st, (rows, emit) = step(jnp.asarray(ids, jnp.int32),
                                    su["folded"], su["j_reid"], st,
                                    jnp.asarray(chunk))
            runs[key].append((st, np.asarray(rows), np.asarray(emit)))
    return runs


@pytest.fixture(scope="module")
def jax_scanned(scan_setup):
    """get(dtype) -> {filtered: [(states, outputs, emit)] per chunk}, the
    JAX step run once per dtype. Unfiltered is every class id; the filter
    is ``classes`` repeated to the same length, so both share a compile.
    bf16: the JAX step's own bf16 forward (module docstring)."""
    su, runs = scan_setup, {}
    _, _, j_det, j_trk = _cfgs(su["thr"])
    n_cls = su["j32"].shape[-1] - 5
    id_sets = {False: np.arange(n_cls), True: np.resize(su["classes"], n_cls)}

    def get(dtype):
        if dtype not in runs:
            runs[dtype] = _jax_chunks(su, j_det, j_trk, dtype, id_sets)
        return runs[dtype]

    return get


def _port_models(setup, dtype):  # noqa: F811
    if dtype == "bf16":
        return setup["det16"], setup["reid16"]
    return setup["detector"], setup["reid"]


@pytest.fixture(scope="module")
def port_scanned(scan_setup):
    """get(dtype, filtered) -> [(states, outputs, emit)] after each of
    CHUNKS chunks of the port's make_scanned_step on its default tracker
    branch (kernel 3), run once per dtype and filter for the file; the
    states are copies (the step writes the gallery in place)."""
    su, runs = scan_setup, {}
    det_cfg, trk_cfg, _, _ = _cfgs(su["thr"])

    def get(dtype, filtered):
        if (dtype, filtered) not in runs:
            detector, reid = _port_models(su, dtype)
            runs[dtype, filtered] = _port_chunks(TS.make_scanned_step(
                detector, reid, det_cfg, trk_cfg, (H, W_), K,
                tracked_class_ids=su["classes"] if filtered else None),
                torch.from_numpy(_chunk(su)))
        return runs[dtype, filtered]

    return get


def _port_chunks(step, chunk):
    """[(states, outputs, emit)] after each of CHUNKS chunks of the port's
    ``step`` from fresh states; the states are copies (the step writes the
    gallery in place)."""
    st, run = TS.init_stream_states(TrackerConfig(**TRK), S, "cpu"), []
    for _ in range(CHUNKS):
        st, (out, emit) = step(st, chunk)
        run.append((_snapshot(st), out, emit))
    return run


@pytest.mark.parametrize("filtered", [False, True],
                         ids=["all-classes", "class-filter"])
@pytest.mark.parametrize("fused", [True, False],
                         ids=["fused-tracker", "tracker-step"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_scanned_step_matches_jax(scan_setup, jax_scanned, port_scanned,
                                  dtype, fused, filtered):
    """Two chunks of K=3 through both make_scanned_steps: per frame, ids
    and emit exactly equal, boxes within 1 px; after each chunk the
    discrete state exactly equal and the means within 2e-3 px. Both of
    the port's tracker branches are held to the reference's
    ``tracker_step`` branch (``jax_scanned``); the fused branch is the
    default one, whose runs ``port_scanned`` keeps."""
    su = scan_setup
    det_cfg, trk_cfg, _, _ = _cfgs(su["thr"])
    if fused:
        port = port_scanned(dtype, filtered)
    else:
        detector, reid = _port_models(su, dtype)
        port = _port_chunks(TS.make_scanned_step(
            detector, reid, det_cfg, trk_cfg, (H, W_), K,
            tracked_class_ids=su["classes"] if filtered else None,
            use_fused_tracker=False), torch.from_numpy(_chunk(su)))
    emitted = 0
    for c, ((j_st, j_out, j_emit), (st, out, emit)) in enumerate(
            zip(jax_scanned(dtype)[filtered], port, strict=True)):
        assert out.shape == (K, S, trk_cfg.max_tracks, 5)
        tag = f"{dtype} fused={fused} filtered={filtered} chunk {c}"
        _assert_rows(out, emit, j_out, j_emit, tag)
        _assert_states(st, j_st, tag)
        emitted += int(emit.sum())
    assert emitted > 0, "tracks confirmed and were emitted"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_scanned_step_equals_repeated_batched_step(scan_setup, port_scanned,
                                                   dtype):
    """A chunk of K frames through the scanned step equals K calls of the
    port's make_batched_step (the JAX suite's
    ``test_scanned_step_equals_repeated_batched``), here bit for bit: the
    same ops on the same rows, the stateless stages at another batch."""
    su = scan_setup
    det_cfg, trk_cfg, _, _ = _cfgs(su["thr"])
    detector, reid = _port_models(su, dtype)
    batched = TS.make_batched_step(detector, reid, det_cfg, trk_cfg, (H, W_))
    st_b = TS.init_stream_states(trk_cfg, S, "cpu")
    chunk = torch.from_numpy(_chunk(su))
    for st_a, out_a, emit_a in port_scanned(dtype, False):
        outs, emits = [], []
        for t in range(K):
            st_b, (o, e) = batched(st_b, chunk[t])
            outs.append(o)
            emits.append(e)
        assert torch.equal(emit_a, torch.stack(emits))
        assert torch.equal(out_a, torch.stack(outs))
    for name in DISCRETE + ("mean", "gallery"):
        assert torch.equal(getattr(st_a, name), getattr(st_b, name)), name
    assert int(emit_a.sum()) > 0


@pytest.mark.parametrize("case", ["full-capacity", "class-filter",
                                  "bf16-refused-frame"])
def test_bucketed_step_equals_scanned_step(scan_setup, port_scanned, case):
    """The bucketed step reproduces the monolithic step (the JAX suite's
    ``test_bucketed_scanned_step_equals_full_capacity`` and
    ``test_bucketed_step_class_filter_parity``): buckets (2, 4), a window
    ladder, two chunks, state carried across them. Emit and ids exactly
    equal, boxes within 1 px, the discrete state exactly equal and the
    means within 2e-3 px (the embed runs at another batch per bucket).
    ``bf16-refused-frame``: bf16 models on 64 x 120 frames, which the
    reference's crop gate refuses, so the bucketed step's windowed crops
    are the dense entry's, as the scanned step's are."""
    su = scan_setup
    det_cfg, trk_cfg, _, _ = _cfgs(su["thr"])
    w = W_
    detector, reid = su["detector"], su["reid"]
    chunk = torch.from_numpy(_chunk(su))
    classes = su["classes"] if case == "class-filter" else None
    if case == "bf16-refused-frame":
        w = 120
        detector, reid = su["det16"], su["reid16"]
        chunk = chunk[:, :, :, :w].contiguous()
        runs = _port_chunks(TS.make_scanned_step(
            detector, reid, det_cfg, trk_cfg, (H, w), K), chunk)
    else:  # the f32 scanned step on the setup's frames
        runs = port_scanned("f32", classes is not None)
    bucketed = TS.make_scanned_step_bucketed(
        detector, reid, det_cfg, trk_cfg, (H, w), buckets=(2, 4),
        tracked_class_ids=classes, windows=((16, 16), (32, 40), (48, 64)))
    st_b = TS.init_stream_states(trk_cfg, S, "cpu")
    emitted = 0
    for st_a, out_a, emit_a in runs:
        st_b, (out_b, emit_b) = bucketed(st_b, chunk)
        assert bucketed.last_max_count <= bucketed.last_bucket
        _assert_rows(out_b, emit_b, out_a, emit_a, case)
        emitted += int(emit_b.sum())
    assert bucketed.last_window != (H, w), "the windowed crops ran"
    for name in DISCRETE:
        assert torch.equal(getattr(st_a, name), getattr(st_b, name)), name
    np.testing.assert_allclose(st_b.mean.numpy(), st_a.mean.numpy(),
                               rtol=0, atol=2e-3)
    assert emitted > 0


@pytest.fixture(scope="module")
def jax_frame_steps(scan_setup):
    """The JAX package's fused_frame_step over 3 frames of stream 0, its
    three return modes in one compile: [(track, dets, boxes)] per frame,
    the tracking mode carrying its one-stream state."""
    su = scan_setup
    _, _, j_det, j_trk = _cfgs(su["thr"])

    def modes(st, fr):
        return tuple(JS.fused_frame_step(
            su["jplan"], j_det, j_trk, (H, W_), su["folded"], su["j_reid"],
            st, fr, return_dets=mode) for mode in (False, True, "boxes"))

    j_fn, j_st, out = jax.jit(modes), j_init(j_trk), []
    for _ in range(3):
        track, dets, boxes = j_fn(j_st, jnp.asarray(su["frames"][0]))
        j_st = track[0]
        out.append((track, dets, boxes))
    return out


@pytest.mark.parametrize("mode", [False, True, "boxes"],
                         ids=["track", "dets", "boxes"])
def test_fused_frame_step_matches_jax(scan_setup, jax_frame_steps, mode):
    """The per-frame body of one stream against the JAX package's, f32, in
    its three return modes over 3 frames of stream 0 (the tracking mode
    carries the one-stream state): detections and masks exactly equal,
    boxes within 1e-3 px, features within 1e-5; tracking rows and state as
    in the scanned step's test. The boxes mode also takes the frame's
    letterboxed input and its decoded rows in place of its own stages, to
    the same result."""
    su = scan_setup
    det_cfg, trk_cfg, _, _ = _cfgs(su["thr"])
    frame = torch.from_numpy(su["frames"][0])
    t_st = TS.init_stream_states(trk_cfg, 1, "cpu")
    emitted = 0
    for f, j_modes in enumerate(jax_frame_steps):
        got = TS.fused_frame_step(su["detector"], su["reid"], det_cfg,
                                  trk_cfg, (H, W_), t_st, frame,
                                  return_dets=mode)
        want = j_modes[[False, True, "boxes"].index(mode)]
        if mode is False:
            t_st, (out, emit) = got
            j_st, (j_out, j_emit) = want
            assert out.shape == (trk_cfg.max_tracks, 5)
            _assert_rows(out, emit, j_out, j_emit, f"frame {f}")
            j_batched = jax.tree.map(lambda x: x[None], j_st)
            _assert_states(t_st, j_batched, f"frame {f}")
            emitted += int(emit.sum())
            continue
        tlwh, conf, third, fourth = (np.asarray(a) for a in want)
        np.testing.assert_allclose(got[0].numpy(), tlwh, rtol=0, atol=1e-3)
        np.testing.assert_allclose(got[1].numpy(), conf, rtol=0, atol=1e-5)
        if mode is True:  # (tlwh, conf, feats, mask)
            np.testing.assert_array_equal(got[3].numpy(), fourth)
            assert fourth.any()
            np.testing.assert_allclose(got[2].numpy(), third, rtol=0,
                                       atol=1e-5)
            continue
        # (tlwh, conf, mask, xyxy)
        np.testing.assert_array_equal(got[2].numpy(), third)
        assert third.any()
        np.testing.assert_allclose(got[3].numpy(), fourth, rtol=0, atol=1e-3)
        with torch.no_grad():
            xs = letterbox_batch_fused(frame[None], 64, torch.float32)
            decoded = su["detector"](xs)
        for given in ({"letterboxed": xs[0]}, {"decoded": decoded[0]}):
            again = TS.fused_frame_step(
                su["detector"], su["reid"], det_cfg, trk_cfg, (H, W_), t_st,
                frame, return_dets="boxes", **given)
            for a, b in zip(again, got):
                assert torch.equal(a, b), given.keys()
    if mode is False:
        assert emitted > 0


def _rank_safe_threshold(t16, j16):
    """A threshold at which the two bf16 forwards (N, A, 5+C) keep the same
    candidates in the same score order (obj * class conf, NMS's rank) in
    every frame: the widest of the gaps between objectness ranks 2..20 of
    the reference's forward that gives that."""
    obj = np.sort(j16[..., 4].ravel())[::-1][2:21]
    for g in np.argsort(obj[1:] - obj[:-1]):  # widest gap first
        thr = float((obj[g] + obj[g + 1]) / 2)
        orders = [[np.argsort(-np.where(d[..., 4] >= thr, d[..., 4]
                                        * d[..., 5:].max(-1), -1),
                              -1, kind="stable")[i][:(d[i, :, 4] >= thr)
                                                    .sum()]
                   for i in range(len(d))] for d in (t16, j16)]
        if all(np.array_equal(a, b) for a, b in zip(*orders)):
            return thr
    raise AssertionError("no threshold keeps the same ranks")


def test_scanned_step_bf16_own_forwards_match_jax(scan_setup):
    """bf16 end to end with each framework's own forward: the port's bf16
    scanned step (kernel 1's bf16 letterbox into the bf16 detector inside
    the step, fused tracker branch) against the JAX step at bf16, two
    chunks. The threshold (``_rank_safe_threshold``) lies in a gap of the
    objectness ranks where both forwards keep the same candidates in the
    same NMS order. Ids, emit and the discrete state exactly equal, boxes
    within 1 px, the Kalman means as in the other cases (rtol 2e-4, atol
    2e-3; measured exactly equal: the rows that differ in the last bit,
    ``test_bf16_detectors_round_apart``, are not among the kept ones)."""
    su = scan_setup
    with torch.no_grad():
        t16 = su["det16"](letterbox_batch_fused(
            torch.from_numpy(su["frames"]), 64, torch.bfloat16)).numpy()
    thr = _rank_safe_threshold(t16, su["j16"])
    det_cfg, trk_cfg, j_det, j_trk = _cfgs(thr)
    n_cls = su["j16"].shape[-1] - 5
    want = _jax_chunks(su, j_det, j_trk, "bf16",
                       {None: np.arange(n_cls)})[None]
    step = TS.make_scanned_step(su["det16"], su["reid16"], det_cfg, trk_cfg,
                                (H, W_), K)
    st = TS.init_stream_states(trk_cfg, S, "cpu")
    emitted = 0
    for c, (j_st, j_out, j_emit) in enumerate(want):
        st, (out, emit) = step(st, torch.from_numpy(_chunk(su)))
        tag = f"bf16 own forwards chunk {c}"
        _assert_rows(out, emit, j_out, j_emit, tag)
        _assert_states(st, j_st, tag)
        emitted += int(emit.sum())
    assert emitted > 0


def test_bf16_detectors_round_apart(scan_setup):
    """What is left between the two frameworks' bf16 forwards of the same
    frames now that both round where the reference rounds: the order of
    the f32 sums (oneDNN's conv against XLA's), which now and then flips a
    bf16 rounding, and a flip travels on through the layers after it.
    Bounds: decoded boxes within 1e-3 px of the 64-px input (measured
    3.7e-4; 0.0154 before the port's bf16 conv summed in f32), objectness
    within 5e-4 (measured 2.4e-4; 4.8e-4 before: one bf16 ulp of a head
    output in [0.25, 0.5) through the sigmoid is up to 4.9e-4, which a
    single flip gives, so no rounding point brings this bound lower), at
    most 5% of the decoded values differing at all (measured 3.3%; 54%
    before); and both forwards within the bf16 rounding of the f32 forward
    (0.2 px, 1e-2)."""
    su = scan_setup
    j16, j32 = su["j16"], su["j32"]
    with torch.no_grad():
        t16 = su["det16"](letterbox_batch_fused(
            torch.from_numpy(su["frames"]), 64, torch.bfloat16)).numpy()
    for got, want, box, obj in ((t16, j16, 1e-3, 5e-4),
                                (t16, j32, 0.2, 1e-2),
                                (j16, j32, 0.2, 1e-2)):
        assert np.abs(got[..., :4] - want[..., :4]).max() <= box
        assert np.abs(got[..., 4] - want[..., 4]).max() <= obj
    assert (t16 != j16).mean() <= 0.05
