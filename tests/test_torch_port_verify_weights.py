"""The port's per-layer weight harness (``yolo_deepsort_tpu_torch/tools/
verify_weights.py``) against the reference tool (``tools/verify_weights.py``,
run in-process, its table parsed) on the CPU, at yolov3-tiny, img 64,
seed 0, random raw params:

* the same modules, types and shapes, and every row's max abs difference
  from the numpy oracle within ``ROW_TOL`` of the reference's: absolute at
  feature maps; at the yolo modules relative to the layer's largest
  magnitude, since their decoded rows are pixels (up to ~5e2 here, where
  one f32 ulp is 6e-5) and the two frameworks' f32 convs sum in another
  order;
* ``main``: the reference's table and exit 0 at the default threshold, and
  exit 1 with the layer flagged when one conv's weight is perturbed in the
  port's module alone (a fold or layout bug), so the check can fail.
"""

import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from specs import model_np
from yolo_deepsort_tpu_torch import weights as W
from yolo_deepsort_tpu_torch.cfg import parse_model_config
from yolo_deepsort_tpu_torch.models.darknet import build_network
from yolo_deepsort_tpu_torch.tools import verify_weights as VW
from torch_port_threads import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
CFG = str(REPO / "config" / "yolov3-tiny.cfg")
ARGV = ["--cfg", CFG, "--img-size", "64", "--seed", "0"]
ROW_TOL = 1e-5
ROW = re.compile(r"^\s*(\d+) (\S+)\s+(\(.*?\))\s+(\S+)\s+(\S+)")


def _rows_of(text):
    """{idx: (type, shape, max abs)} of a printed table."""
    out = {}
    for line in text.splitlines():
        m = ROW.match(line)
        if m:
            out[int(m[1])] = (m[2], m[3], float(m[4]))
    return out


@pytest.fixture(scope="module")
def reference_text():
    spec = importlib.util.spec_from_file_location(
        "reference_tool_verify_weights", REPO / "tools" / "verify_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf, argv = io.StringIO(), sys.argv
    sys.argv = ["verify_weights.py"] + ARGV
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()  # returns on success, sys.exit(1) otherwise
    finally:
        sys.argv = argv
    return buf.getvalue()


def _layer_scales():
    plan = build_network(parse_model_config(CFG), img_size=64)
    defs = plan.defs()
    x = np.random.default_rng(0).uniform(0, 1, (1, 3, 64, 64))
    _, layers = model_np.forward(defs, W.random_raw_params(defs, seed=0),
                                 x.astype(np.float32), img_dim=64)
    return [float(np.abs(o).max()) for o in layers]


def test_rows_match_the_reference_tool(reference_text):
    want = _rows_of(reference_text)
    rows = VW.verify(CFG, img_size=64, seed=0, device="cpu",
                     log=lambda _: None)["f32"]
    scales = _layer_scales()
    assert len(rows) == len(want) == len(scales) == 24
    for r in rows:
        typ, shape, ref_abs = want[r["idx"]]
        assert (r["type"], str(r["shape"])) == (typ, shape)
        tol = ROW_TOL * (scales[r["idx"]] if typ == "yolo" else 1.0)
        assert abs(r["max_abs"] - ref_abs) <= tol, (r, ref_abs)
    assert "OK: all layers within tolerance" in reference_text


@pytest.mark.parametrize("perturb", [False, True])
def test_main_table_and_exit_code(perturb, reference_text, monkeypatch,
                                  capsys):
    if perturb:  # one conv's weight off in the port's module alone
        build = W.darknet_from_raw

        def perturbed(plan, raw):
            model = build(plan, raw)
            with torch.no_grad():
                model.convs["13"].weight[0, 0, 0, 0] += 0.5
            return model
        monkeypatch.setattr(W, "darknet_from_raw", perturbed)
    rc = VW.main(ARGV + ["--device", "cpu"])
    out = capsys.readouterr().out
    got = _rows_of(out)
    assert set(got) == set(_rows_of(reference_text))
    assert out.splitlines()[0] == reference_text.splitlines()[0]  # the note
    if not perturb:
        assert rc == 0 and "OK: all layers within tolerance" in out
        assert "DIVERGES" not in out
        return
    assert rc == 1 and "OK:" not in out
    flagged = [i for i, line in enumerate(out.splitlines())
               if "<-- DIVERGES" in line]
    assert flagged
    assert got[13][2] > 1e-2 and all(got[i][2] < 1e-4 for i in range(13))
    assert "worst layer: " in out
