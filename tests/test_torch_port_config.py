"""The port's copies of the JAX package's jax-free pieces -- the config
dataclasses, the darknet topologies, the cfg parser and emitter, the COCO
names and the darknet weight IO -- held equal to the originals."""

import dataclasses

import numpy as np
import pytest

from specs.weights_np import random_darknet_weights
from yolo_deepsort_tpu import cfg as JCFG
from yolo_deepsort_tpu import config as JC
from yolo_deepsort_tpu.cfg.architectures import ARCHITECTURES as J_ARCH
from yolo_deepsort_tpu.models import weights as JW
from yolo_deepsort_tpu_torch import cfg as TCFG
from yolo_deepsort_tpu_torch import config as TC
from yolo_deepsort_tpu_torch import weights as TW
from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES as T_ARCH
from yolo_deepsort_tpu_torch.models.darknet import conv_layer_shapes
from torch_port_threads import torch_threads  # noqa: F401


@pytest.mark.parametrize("name", ["TrackerConfig", "DetectorConfig"])
def test_config_dataclasses_match(name):
    j, t = getattr(JC, name), getattr(TC, name)
    assert ([(f.name, f.default) for f in dataclasses.fields(j)]
            == [(f.name, f.default) for f in dataclasses.fields(t)])


@pytest.mark.parametrize("name,kw", [
    ("yolov3", {}), ("yolov3", dict(img_size=608, num_classes=3)),
    ("yolov3-tiny", {}), ("yolov3-tiny", dict(img_size=64, num_classes=1)),
    ("yolov4", {}), ("yolov4", dict(img_size=416, num_classes=2)),
])
def test_architectures_match(name, kw):
    defs = T_ARCH[name](**kw)
    assert defs == J_ARCH[name](**kw)
    assert conv_layer_shapes(defs[1:]) == JW.conv_layer_shapes(defs[1:])


@pytest.mark.parametrize("name", ["yolov3-tiny", "yolov3"])
def test_weight_parsing_and_folding_match(name):
    defs = J_ARCH[name](img_size=64)[1:]
    blob = random_darknet_weights(defs, seed=3, well_conditioned=True)
    j_header, j_raw = JW.load_darknet_weights(blob, defs)
    t_header, t_raw = TW.load_darknet_weights(blob, defs)
    np.testing.assert_array_equal(t_header, j_header)
    assert t_raw.keys() == j_raw.keys()
    j_fold = JW.fold_inference_params(j_raw, defs)
    t_fold = TW.fold_inference_params(t_raw, defs)
    for i in j_raw:
        for key in j_raw[i]:
            np.testing.assert_array_equal(t_raw[i][key], j_raw[i][key])
        for key in ("w", "b"):
            np.testing.assert_array_equal(t_fold[i][key], j_fold[i][key])
    with pytest.raises(ValueError, match="mismatch"):
        TW.load_darknet_weights(blob + b"\0\0\0\0", defs)


@pytest.mark.parametrize("name", ["yolov3", "yolov3-tiny", "yolov4"])
def test_cfg_emit_and_parse_match(name, tmp_path):
    defs = J_ARCH[name]()
    text = TCFG.emit_cfg(defs, tmp_path / "t.cfg")
    assert text == JCFG.emit_cfg(defs)
    parsed = TCFG.parse_model_config(tmp_path / "t.cfg")
    assert parsed == JCFG.parse_model_config(tmp_path / "t.cfg")
    assert len(parsed) == len(defs)
    (tmp_path / "x.data").write_text(
        "# comment\nclasses = 80\ntrain=data/train.txt\nnames=coco.names\n")
    assert (TCFG.parse_data_config(tmp_path / "x.data")
            == JCFG.parse_data_config(tmp_path / "x.data"))


def test_coco_names_match(tmp_path):
    assert TCFG.COCO_NAMES == JCFG.COCO_NAMES and len(TCFG.COCO_NAMES) == 80
    (tmp_path / "a.names").write_text("person\n\nbicycle \ncar")
    assert (TCFG.load_classes(tmp_path / "a.names")
            == JCFG.load_classes(tmp_path / "a.names"))


def test_random_raw_params_and_cutoff_loads_match(tmp_path):
    defs = J_ARCH["yolov4"](img_size=64)[1:]
    j_raw, t_raw = JW.random_raw_params(defs, seed=2), TW.random_raw_params(
        defs, seed=2)
    assert t_raw.keys() == j_raw.keys() and len(t_raw) == 110
    for i in j_raw:
        for key in j_raw[i]:
            np.testing.assert_array_equal(t_raw[i][key], j_raw[i][key])
    header = np.array([0, 2, 0, 32, 0], np.int32)
    TW.save_darknet_weights(tmp_path / "t.weights", header, t_raw, defs,
                            cutoff=40)
    JW.save_darknet_weights(tmp_path / "j.weights", header, j_raw, defs,
                            cutoff=40)
    assert ((tmp_path / "t.weights").read_bytes()
            == (tmp_path / "j.weights").read_bytes())
    t_header, t_cut = TW.load_darknet_weights(tmp_path / "t.weights", defs,
                                              cutoff=40)
    np.testing.assert_array_equal(t_header, header)
    assert sorted(t_cut) == [i for i in sorted(j_raw) if i < 40]
    assert TW.fold_inference_params(t_cut, defs).keys() == t_cut.keys()
