"""The port's real-weights runbook (``yolo_deepsort_tpu_torch/tools/
parity_real.py``) on the CPU, against the reference's pieces:

* the whole ``--standins`` flow of the tool's ``main`` (``--device cpu``),
  called in the test's process: ``ok`` with no failures, the STAND-IN
  marker, an OK per-layer row and a MOTA row, as
  ``tests/test_parity_runbook.py`` checks the reference's;
* step 4's MOTA / ID switches / IDF1 on the stand-in sequence equal to
  ``benchmarks/mot_eval.py`` ``sequence_eval`` run in-process on the same
  directory with the same stand-in ``ckpt.t7``;
* the port's copies of what the reference runbook takes from the tests:
  the reference Net's state-dict layout (``test_reid.TorchNet``: keys,
  shapes, dtypes; both packages' loaders fold it alike) and the MOT16
  stand-in sequence (``test_mot_eval_seq._make_mot16_dir``: gt and det
  files byte-equal, the same frames, PNG here and JPEG there).
"""

import json
import os

import numpy as np
import pytest
import torch

from test_mot_eval_seq import _make_mot16_dir
from test_reid import TorchNet
from yolo_deepsort_tpu.models import reid as JR
from yolo_deepsort_tpu_torch.data.datasets import load_rgb
from yolo_deepsort_tpu_torch.models import reid as PR
from yolo_deepsort_tpu_torch.tools import parity_real as PRL
from torch_port_threads import torch_threads  # noqa: F401


def test_standins_flow_in_a_subprocess(tmp_path, capsys):
    """The flow's one JSON line and its report, from ``main`` called in
    this process: nothing here needs a fresh one."""
    out = tmp_path / "PARITY_STANDIN_torch.md"
    rc = PRL.main(["--standins", "--device", "cpu", "--out", str(out)])
    stdout = capsys.readouterr().out
    assert rc == 0, stdout[-2000:]
    rec = json.loads(stdout.strip().splitlines()[-1])
    assert rec == {"ok": True, "failures": [], "out": str(out)}
    text = out.read_text()
    assert "STAND-IN" in text  # honesty marker
    assert "| per-layer oracle diff (yolov3-tiny.weights) | OK: " in text
    assert "| MOT16-99 MOTA / IDsw / IDF1 | " in text
    assert "ckpt.t7 load + L2-norm features | OK (dim 512)" in text
    assert "COCO mAP@0.5 (3 imgs)" in text


@pytest.fixture(scope="module")
def standins(tmp_path_factory):
    return PRL.make_standins(str(tmp_path_factory.mktemp("standins")))


def test_sequence_eval_matches_mot_eval(standins):
    from benchmarks.mot_eval import sequence_eval

    seq = os.path.join(standins["mot_root"], "MOT16-99")
    got = PRL.sequence_eval(seq, None, None, standins["reid_ckpt"], 416,
                            device="cpu")
    want = sequence_eval(seq, None, None, standins["reid_ckpt"], 416)
    assert got.num_gt == want.num_gt == 24
    assert (got.mota, got.id_switches, got.idf1) == (
        want.mota, want.id_switches, want.idf1)
    assert got.mota > 0.5 and got.id_switches == 0


def _leaves(tree):
    """The arrays of a folded param tree, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [] if tree is None else [tree]


def test_reference_net_state_dict_layout(standins):
    got = PRL.reference_net_state_dict(751)
    want = TorchNet(num_classes=751).state_dict()
    assert list(got) == list(want)
    for k in want:
        assert (got[k].shape, got[k].dtype) == (want[k].shape, want[k].dtype), k
    ck = torch.load(standins["reid_ckpt"], weights_only=True)
    assert set(ck) == {"net_dict", "acc", "epoch"}
    mine, ref = (PR.load_reid_checkpoint(standins["reid_ckpt"]),
                 JR.load_reid_checkpoint(standins["reid_ckpt"]))
    assert len(_leaves(mine)) == len(_leaves(ref)) > 0
    for a, b in zip(_leaves(mine), _leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mot16_dir_matches_the_reference(tmp_path):
    PRL.make_mot16_dir(str(tmp_path / "port"), n_frames=12, seed=3)
    _make_mot16_dir(str(tmp_path / "ref"), n_frames=12, seed=3)
    for name in ("gt/gt.txt", "det/det.txt"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes())
    port = sorted((tmp_path / "port" / "img1").iterdir())
    ref = sorted((tmp_path / "ref" / "img1").iterdir())
    assert [p.stem for p in port] == [p.stem for p in ref]
    assert {p.suffix for p in port} == {".png"}
    for a, b in zip(port, ref):  # lossless here, JPEG there
        diff = np.abs(load_rgb(str(a)).astype(int)
                      - load_rgb(str(b)).astype(int))
        assert diff.mean() < 2.0
