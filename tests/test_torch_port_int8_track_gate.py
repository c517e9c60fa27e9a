"""The port's track-level int8 gate (``yolo_deepsort_tpu_torch/tools/
int8_track_gate.py``) against the reference tool and the JAX package on the
CPU, from the same seeded numpy inputs:

* ``PairScore`` equal to the reference's, summary for summary. The
  reference's class is nested in its ``main``, so it is compiled here from
  the tool's source with the reference's ``greedy_match``. Cases: seeded
  row sets, empty frames, a consistent relabeling (remaps 0) and a
  mid-sequence id switch;
* at yolov3-tiny-64, 2 streams of 64x128, 8 steps on the reference gate's
  load (the honest load of ``test_torch_port_int8_gates.py``'s fixture:
  ``bench_probes.bn_weights_and_frames`` at seed 0 is the gate's load), each
  comparison at a threshold in the widest gap of its own objectness: the
  port's f32 path against the JAX f32 ``make_batched_step`` (ids equal,
  boxes within ``TOL_F32_PX``), its plain-twin int8 path against the JAX
  ``"xla-twin"`` step (``PairScore`` churn 0, remaps 0);
* ``main --device cpu`` at a tiny size: one JSON line carrying every key
  of the reference's record (read from the reference's source), plus
  ``device`` and ``launches``.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_port_int8_gates import (  # noqa: F401 (fixtures)
    TINY,
    _darknet,
    loads,
    ref,
)
from chip_smoke import widest_gap
from yolo_deepsort_tpu.config import DetectorConfig as JDetectorConfig
from yolo_deepsort_tpu.config import TrackerConfig as JTrackerConfig
from yolo_deepsort_tpu.models.darknet import network_apply
from yolo_deepsort_tpu.models.quantize_darknet import make_xla_int8_conv_impl
from yolo_deepsort_tpu.models.reid import random_reid_params as j_reid_params
from yolo_deepsort_tpu.ops.letterbox import letterbox as j_letterbox
from yolo_deepsort_tpu.parallel import streams as JS
from yolo_deepsort_tpu_torch.config import DetectorConfig, TrackerConfig
from yolo_deepsort_tpu_torch.kernels.launches import LAUNCH_COUNTERS
from yolo_deepsort_tpu_torch.models.quantize_darknet import (
    quantize_darknet_from_frames,
)
from yolo_deepsort_tpu_torch.models.reid import random_reid_params
from yolo_deepsort_tpu_torch.tools import int8_track_gate as TG
from torch_port_threads import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
REFERENCE = REPO / "tools" / "int8_track_gate.py"
STEPS = 8
MAX_DETS = 6
# the widest-gap window of the pooled objectness (2 streams): ranks
# 1.5S..4.5S, about 1-5 candidates a frame under MAX_DETS
GAP_RANKS = (3, 9)
# f32 path against the JAX f32 step: emitted boxes in frame pixels (both
# f32 forwards sum in another order)
TOL_F32_PX = 1e-3
TINY_ARGV = ["--model", "yolov3-tiny", "--img-size", "64", "--streams", "2",
             "--steps", "3", "--warmup", "1", "--frame-h", "64",
             "--frame-w", "128", "--target-dets", "4", "--max-dets", "4",
             "--device", "cpu"]


def _reference_source():
    return ast.parse(REFERENCE.read_text())


def _reference_pair_score(ref_detect_gate):
    """The reference's ``PairScore``, compiled from its tool's source (it
    is defined inside ``main``) over the reference's ``greedy_match``."""
    tree = _reference_source()
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    cls = next(n for n in ast.walk(main)
               if isinstance(n, ast.ClassDef) and n.name == "PairScore")
    ns = {"np": np, "greedy_match": ref_detect_gate.greedy_match}
    exec(compile(ast.Module(body=[cls], type_ignores=[]), str(REFERENCE),
                 "exec"), ns)
    return ns["PairScore"]


def _reference_record_keys():
    """The keys of the dict the reference's ``main`` prints."""
    for node in ast.walk(_reference_source()):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys
                    if isinstance(k, ast.Constant)}
            if "gate" in keys and "churn_budget" in keys:
                return keys
    raise AssertionError("no record dict in the reference tool")


# --- PairScore, case for case


def _rows(rng, n, first_id=1):
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(10, 60, (n, 2))
    ids = np.arange(first_id, first_id + n)[:, None]
    return np.concatenate([xy, xy + wh, ids], 1).astype(np.float32)


def _jitter(rng, rows, px=2.0):
    out = rows.copy()
    out[:, :4] += rng.uniform(-px, px, (len(rows), 4)).astype(np.float32)
    return out


def _case_seeded(rng):
    """Both runs from one seeded scene: b jittered, some rows dropped or
    added, ids offset."""
    frames = []
    for _ in range(6):
        per = []
        for _s in range(2):
            a = _rows(rng, int(rng.integers(0, 7)))
            b = _jitter(rng, a)
            b[:, 4] += 100
            keep = rng.uniform(size=len(b)) > 0.2
            b = np.concatenate([b[keep], _rows(rng, int(rng.integers(0, 2)),
                                               500)])
            per.append((a, b))
        frames.append(per)
    return frames


def _case_empty(rng):
    a = _rows(rng, 4)
    none = np.zeros((0, 5), np.float32)
    return [[(none, none), (a, none)], [(none, a), (none, none)],
            [(a, _jitter(rng, a)), (none, none)]]


def _case_relabel(rng):
    """The same tracks under a consistent relabeling: remaps 0."""
    a = _rows(rng, 5)
    relabel = {1: 7, 2: 3, 3: 9, 4: 1, 5: 2}
    b = a.copy()
    b[:, 4] = [relabel[int(i)] for i in a[:, 4]]
    return [[(a, _jitter(rng, b, 0.5))] for _ in range(5)]


def _case_switch(rng):
    """Two tracks swap their ids on one side mid-sequence: remaps 2."""
    a = _rows(rng, 3)
    b = a.copy()
    b[:, 4] += 10
    swapped = b.copy()
    swapped[[0, 1], 4] = swapped[[1, 0], 4]
    return [[(a, b)], [(a, b)], [(a, swapped)], [(a, swapped)]]


PAIR_CASES = {"seeded": _case_seeded, "empty": _case_empty,
              "relabel": _case_relabel, "switch": _case_switch}


@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_pair_score_equals_the_reference(ref, case):
    RefPairScore = _reference_pair_score(ref["int8_detect_gate"])
    frames = PAIR_CASES[case](np.random.default_rng(7))
    got, want = TG.PairScore(), RefPairScore()
    for per in frames:
        for s, (ta, tb) in enumerate(per):
            got.score_frame(s, ta, tb)
            want.score_frame(s, ta, tb)
    assert got.summary() == want.summary()
    assert got.remaps == want.remaps
    rec = TG.score_runs([[ta for ta, _ in per] for per in frames],
                        [[tb for _, tb in per] for per in frames])
    assert rec == {**want.summary(), "remaps": want.remaps}
    if case == "relabel":
        assert (rec["remaps"], rec["churn"]) == (0, 0.0)
    if case == "switch":
        assert rec["remaps"] == 2 and rec["id_remap_rate"] > 0


# --- the serving paths against the JAX steps


def _j_rows(outs):
    return [[np.asarray(out, np.float32)[s][np.asarray(emit)[s]]
             for s in range(out.shape[0])] for out, emit in outs]


@pytest.fixture(scope="module")
def jpkg(loads):
    """The int8 package of the gate's load on the JAX-folded weights,
    calibrated on two of its frames by the port (byte-equal ``wq`` to the
    JAX package's, ``test_torch_port_int8_detect_gates.py``); both
    frameworks' int8 paths run on it."""
    det = _darknet(loads["load"].plan, loads["jfolded"])
    return quantize_darknet_from_frames(det, loads["jframes"][0], TINY[1],
                                        max_frames=2)


@pytest.fixture(scope="module")
def paths(loads, jpkg):
    """Both frameworks' f32 and int8-twin runs on the reference gate's load
    (the fixture's JAX-folded weights in both), each at a threshold in the
    widest gap of its own arithmetic's pooled objectness."""
    jplan, jfolded = loads["jplan"], loads["jfolded"]
    frames = loads["jframes"][0]
    size, hw = TINY[1], TINY[2]
    jparams = jax.tree_util.tree_map(jnp.asarray, jfolded)
    xs = jax.vmap(lambda f: j_letterbox(f, size))(jnp.asarray(frames))
    dec = {
        "f32": jax.jit(lambda x: network_apply(jplan, jparams, x))(xs),
        "int8": jax.jit(lambda x: network_apply(
            jplan, jparams, x, compute_dtype=jnp.bfloat16,
            conv_impl=make_xla_int8_conv_impl(jpkg)))(xs),
    }
    det = _darknet(loads["load"].plan, jfolded)
    trk_cfg = TrackerConfig(max_tracks=16, max_dets=MAX_DETS, nn_budget=4)
    j_trk = JTrackerConfig(max_tracks=16, max_dets=MAX_DETS, nn_budget=4)
    fr = torch.from_numpy(frames.copy())
    out = {}
    for name, port_path, j_kw in (
            ("f32", "f32", dict(compute_dtype=jnp.float32)),
            ("int8", "int8_plain", dict(compute_dtype=jnp.bfloat16,
                                        use_pallas_conv="xla-twin",
                                        backbone_int8_pkg=jpkg))):
        obj = torch.from_numpy(np.asarray(dec[name][..., 4], np.float32))
        thr, margin = widest_gap(obj, *GAP_RANKS)
        steps, _, _ = TG.make_paths(
            det, random_reid_params(1), jpkg,
            DetectorConfig(img_size=size, conf_thres=thr, nms_thres=0.4,
                           max_dets=MAX_DETS), trk_cfg, hw)
        got = TG.track_rows(*steps[port_path], trk_cfg, fr, STEPS, 0)
        j_step = JS.make_batched_step(
            jplan, JDetectorConfig(img_size=size, conf_thres=thr,
                                   nms_thres=0.4, max_dets=MAX_DETS),
            j_trk, hw, donate_state=False, **j_kw)
        j_states = JS.init_stream_states(j_trk, frames.shape[0])
        j_reid = j_reid_params(1)
        outs = []
        for _ in range(STEPS):
            j_states, res = j_step(jparams, j_reid, j_states,
                                   jnp.asarray(frames))
            outs.append(res)
        out[name] = dict(got=got, want=_j_rows(outs), margin=margin,
                         obj=obj, thr=thr)
    # the port's own forward of each arithmetic, for the margin check
    from yolo_deepsort_tpu_torch.ops.letterbox import letterbox_batch
    from yolo_deepsort_tpu_torch.ops.letterbox_kernel import (
        letterbox_batch_fused,
    )
    from yolo_deepsort_tpu_torch.tools.int8_detect_gate import int8_decode

    with torch.no_grad():
        out["f32"]["port_obj"] = det(letterbox_batch(fr, size))[..., 4]
        det16 = _darknet(loads["load"].plan, jfolded, torch.bfloat16)
        out["int8"]["port_obj"] = int8_decode(
            det16, letterbox_batch_fused(fr, size, out_dtype=torch.bfloat16),
            jpkg, True)[0][..., 4].float()
    return out


@pytest.mark.parametrize("path", ["f32", "int8"])
def test_margin_exceeds_the_objectness_change(paths, path):
    """The comparison below is meaningful only if no candidate crosses the
    threshold between the two frameworks' forwards."""
    p = paths[path]
    change = float((p["port_obj"] - p["obj"]).abs().max())
    assert p["margin"] > change, (p["margin"], change)


def test_f32_path_matches_the_jax_step(paths):
    p = paths["f32"]
    emitted = 0
    for step, (got, want) in enumerate(zip(p["got"], p["want"],
                                           strict=True)):
        for s, (g, w) in enumerate(zip(got, want, strict=True)):
            tag = f"step {step} stream {s}"
            np.testing.assert_array_equal(g[:, 4], w[:, 4], err_msg=tag)
            np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0,
                                       atol=TOL_F32_PX, err_msg=tag)
            emitted += len(g)
    assert emitted > 0


def test_int8_plain_twin_matches_the_jax_twin(paths):
    p = paths["int8"]
    rec = TG.score_runs(p["want"], p["got"])
    assert rec["tracks_a"] > 0
    assert (rec["churn"], rec["remaps"]) == (0.0, 0), rec


def test_gate_load_is_the_reference_load(loads, jpkg):
    """The port's ``gate_load`` at seed 0 draws the fixture's frames and
    packages the same layers on its own weights as on the JAX-folded
    ones."""
    model, size, hw = TINY
    load = TG.gate_load(model, size, 2, hw, 0, 100.0, False, 4, MAX_DETS,
                        "cpu")
    np.testing.assert_array_equal(load.frames.numpy(), loads["jframes"][0])
    assert set(load.pkg) == set(jpkg) and load.pkg
    assert np.isfinite(load.thr)


# --- the command line


def test_main_prints_one_json_line(capsys):
    rc = TG.main(TINY_ARGV)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    keys = _reference_record_keys()
    assert keys <= set(rec), keys - set(rec)
    assert {"device", "launches"} <= set(rec)
    assert rc == (0 if rec["ok"] else 1)
    assert (rec["route"], rec["device"]) == ("cpu", "cpu")
    assert rec["scored_frames"] == 2
    assert set(rec["launches"]) == set(LAUNCH_COUNTERS)
    assert not any(rec["launches"].values())  # nothing launches on the CPU
    # on the CPU both int8 routes are plain versions: equal
    twin = rec["int8_kernel_vs_plain"]
    assert (twin["churn"], twin["remaps"], twin["decoded_max_abs"]) == (
        0.0, 0, 0.0)

