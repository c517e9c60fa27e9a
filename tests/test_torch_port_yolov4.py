"""yolov4 (AlexeyAB ``cfg/yolov4.cfg``, as ``gpubench/configs/yolov4.cfg``
holds it) through the port's K=1 step (``make_batched_step``), held module
by module to the benchmark's plain reference (``gpubench/reference/
darknet.py``): 64 px, 2 streams of 48 x 80, the seeded random weights and
frames of a benchmark run (``gpubench/load.py``), on the CPU.

* float32: the detector the step ran is captured once more on the same
  frames, and its decoded rows are the step's bit for bit; the letterbox
  and every module's output (162 modules: mish, leaky and linear convs,
  the SPP's max-pools, routes, upsamples, shortcuts, ``scale_x_y`` heads)
  within 1e-5 of the largest magnitude of the reference's module on the
  program's own inputs of it; the step's NMS keeps exactly the reference
  NMS's rows of the step's decoded rows, in its order, with its classes
  and scores, and merged corners within 1e-4 px.
* bfloat16 (the CPU's emulation of the card's rounding): the layer judge
  of ``gpubench/compare.py`` reads inside the limit of the benchmark cell
  ``yolov4-608.k1.s8.d32`` (``det_layer_cos``), and the reference with
  W8A8 rounding on every conv, in the program's place, reads outside it.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import compare, load, serve
from gpubench.reference import darknet as ref_darknet
from gpubench.reference import nms as ref_nms
from yolo_deepsort_tpu_torch.cfg.parse import parse_model_config
from yolo_deepsort_tpu_torch.config import DetectorConfig, TrackerConfig
from yolo_deepsort_tpu_torch.models.darknet import build_network
from yolo_deepsort_tpu_torch.models.reid import random_reid_params
from yolo_deepsort_tpu_torch.parallel import streams as TS
from yolo_deepsort_tpu_torch.weights import darknet_from_raw, reid_from_params

ROOT = Path(__file__).resolve().parent.parent
CFG = ROOT / "gpubench" / "configs" / "yolov4.cfg"
LIMIT = json.loads((ROOT / "gpubench" / "limits" / "yolov4-608.k1.s8.d32.json"
                    ).read_text())["det_layer_cos"]
IMG, S, HW, SEED = 64, 2, (48, 80), 2 ** 31 + 25
PRIOR = {"heights": [600.0, 800.0, 1000.0], "aspect": 0.41}
NMS_THRES, MAX_BOXES, CAP = 0.4, 64, 6
TRK = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the small ops of a 64 px net run faster alone
    than with a pool spinning over the test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    defs = ref_darknet.parse_cfg(CFG.read_text())[1:]
    frames = load.frames(SEED, S, HW, CPU)[0]
    raw = load.detector_weights(defs, IMG, frames, SEED, PRIOR)
    plan = build_network(parse_model_config(str(CFG)), IMG)
    raw_np = {i: {k: v.numpy() for k, v in layer.items()}
              for i, layer in raw.items()}
    return dict(defs=defs, frames=frames, raw=raw, plan=plan, raw_np=raw_np)


def _step(run, dtype, monkeypatch):
    """One K=1 step of ``dtype`` on the run's frames -> (the detector, the
    decoded rows handed to the NMS, its (dets, mask), the threshold)."""
    detector = darknet_from_raw(run["plan"], run["raw_np"]).to(
        CPU, dtype, memory_format=torch.channels_last)
    reid = reid_from_params(random_reid_params(0)).to(CPU, dtype)
    xs, decoded, _ = serve.capture(detector, None, run["frames"], IMG)
    # the threshold halfway between the 8th and 9th objectness of all
    obj = decoded[..., 4].float().flatten().sort(descending=True).values
    thr = float((obj[7] + obj[8]) / 2)
    seen = []
    nms = TS.batched_nms

    def recorded(dec, *args):
        out = nms(dec, *args)
        seen.append((dec.clone(), out))
        return out

    monkeypatch.setattr(TS, "batched_nms", recorded)
    det_cfg = DetectorConfig(img_size=IMG, conf_thres=thr,
                             nms_thres=NMS_THRES, max_boxes=MAX_BOXES,
                             max_dets=TRK.max_dets)
    step = TS.make_batched_step(detector, reid, det_cfg, TRK, HW, cap=CAP,
                                crop_window=(32, 32))
    step(TS.init_stream_states(TRK, S, CPU), run["frames"])
    ((dec, (dets, mask)),) = seen
    return detector, dec, dets, mask, thr


def test_f32_step_holds_to_the_reference_module_by_module(run, monkeypatch):
    defs = run["defs"]
    detector, dec, dets, mask, thr = _step(run, torch.float32, monkeypatch)
    xs, decoded, layers = serve.capture(detector, None, run["frames"], IMG)
    assert torch.equal(decoded, dec)  # the capture is what the step ran
    assert len(layers) == len(defs) == 162

    def close(got, want, tag):
        scale = float(want.abs().max())
        assert float((got.float() - want).abs().max()) <= 1e-5 * scale, tag

    with ref_darknet.f32_exact(), torch.no_grad():
        close(xs.permute(0, 3, 1, 2),
              ref_darknet.letterbox(run["frames"], IMG), "letterbox")
        for i, d in enumerate(defs):
            ins = [(xs if j < 0 else layers[j]).permute(0, 3, 1, 2).float()
                   for j in ref_darknet.sources(defs, i)]
            want = ref_darknet.module(defs, run["raw"], i, ins, IMG)
            got = (layers[i] if d["type"] == "yolo"
                   else layers[i].permute(0, 3, 1, 2))
            close(got, want, (i, d["type"], d.get("activation")))

    kept = 0
    for s in range(S):
        want = ref_nms.nms_image(dec[s].double().numpy(), thr, NMS_THRES,
                                 MAX_BOXES, CAP)
        got = dets[s][mask[s]].double().numpy()
        assert mask[s].tolist() == [True] * len(got) + [False] * (
            CAP - len(got))  # a score-descending prefix
        assert got.shape == want.shape, s
        np.testing.assert_array_equal(got[:, 6], want[:, 6])  # classes
        np.testing.assert_array_equal(got[:, 4:6].astype(np.float32),
                                      want[:, 4:6].astype(np.float32))
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0,
                                   atol=1e-4)
        kept += len(got)
    assert kept >= S  # the rows were there to compare


def test_bf16_step_reads_inside_the_cells_layer_limit(run, monkeypatch):
    detector, dec, _, _, _ = _step(run, torch.bfloat16, monkeypatch)
    xs, decoded, layers = serve.capture(detector, None, run["frames"], IMG)
    assert torch.equal(decoded, dec)
    judged = compare.judge_layers(run["defs"], run["raw"], IMG, run["frames"],
                                  xs, layers, range(S), int8=True)
    sound = max(judged["per_module"].values())
    control = max(judged["int8_per_module"].values())
    assert 0.0 < sound <= LIMIT, sound
    assert control > LIMIT, control
