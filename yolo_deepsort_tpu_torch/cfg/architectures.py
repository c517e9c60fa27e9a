"""Builders of the stock darknet topologies (copy of
yolo_deepsort_tpu/cfg/architectures.py).

They emit module_defs lists with the layer order, channel counts, routes
and shortcuts of the upstream yolov3.cfg (75 conv, 23 shortcut, 4 route,
2 upsample, 3 yolo), yolov3-tiny.cfg (13 conv, 6 maxpool, 2 yolo) and
yolov4.cfg (110 conv, CSP backbone + SPP + PAN). The darknet ``.weights``
stream is consumed in this order. ``tests/test_torch_port_config.py``
holds them equal to the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List

YOLOV3_ANCHORS = "10,13, 16,30, 33,23, 30,61, 62,45, 59,119, 116,90, 156,198, 373,326"
YOLOV3_TINY_ANCHORS = "10,14, 23,27, 37,58, 81,82, 135,169, 344,319"
YOLOV4_ANCHORS = "12,16, 19,36, 40,28, 36,75, 76,55, 72,146, 142,110, 192,243, 459,401"


def _net(width: int, height: int) -> Dict:
    return {
        "type": "net",
        "batch": "64",
        "subdivisions": "16",
        "width": str(width),
        "height": str(height),
        "channels": "3",
        "momentum": "0.9",
        "decay": "0.0005",
        "angle": "0",
        "saturation": "1.5",
        "exposure": "1.5",
        "hue": ".1",
        "learning_rate": "0.001",
        "burn_in": "1000",
        "max_batches": "500200",
        "policy": "steps",
        "steps": "400000,450000",
        "scales": ".1,.1",
    }


def _conv(filters, size, stride=1, activation="leaky", bn=1) -> Dict:
    d = {
        "type": "convolutional",
        "batch_normalize": str(bn),
        "filters": str(filters),
        "size": str(size),
        "stride": str(stride),
        "pad": "1",
        "activation": activation,
    }
    if not bn:
        del d["batch_normalize"]
        d["batch_normalize"] = "0"
    return d


def _head_conv(filters) -> Dict:
    return _conv(filters, 1, activation="linear", bn=0)


def _maxpool(size, stride) -> Dict:
    return {"type": "maxpool", "size": str(size), "stride": str(stride)}


def _upsample() -> Dict:
    return {"type": "upsample", "stride": "2"}


def _route(layers, groups=None, group_id=None) -> Dict:
    d = {"type": "route", "layers": layers}
    if groups is not None:
        d["groups"] = str(groups)
        d["group_id"] = str(group_id)
    return d


def _shortcut(frm) -> Dict:
    return {"type": "shortcut", "from": str(frm), "activation": "linear"}


def _yolo(mask, anchors, classes=80, scale_x_y=None, ignore_thresh=".5") -> Dict:
    d = {
        "type": "yolo",
        "mask": mask,
        "anchors": anchors,
        "classes": str(classes),
        "num": str(len(anchors.split(",")) // 2),
        "jitter": ".3",
        "ignore_thresh": ignore_thresh,
        "truth_thresh": "1",
        "random": "1",
    }
    if scale_x_y is not None:
        d["scale_x_y"] = str(scale_x_y)
    return d


def yolov3_tiny(num_classes: int = 80, img_size: int = 416) -> List[Dict]:
    """The stock yolov3-tiny topology (13 conv, 6 maxpool, 2 yolo heads at
    strides 32/16; note the canonical anchor masks 3,4,5 and 1,2,3)."""
    out_filters = 3 * (5 + num_classes)
    m = [_net(img_size, img_size)]
    m += [_conv(16, 3), _maxpool(2, 2)]          # 0, 1
    m += [_conv(32, 3), _maxpool(2, 2)]          # 2, 3
    m += [_conv(64, 3), _maxpool(2, 2)]          # 4, 5
    m += [_conv(128, 3), _maxpool(2, 2)]         # 6, 7
    m += [_conv(256, 3), _maxpool(2, 2)]         # 8, 9
    m += [_conv(512, 3), _maxpool(2, 1)]         # 10, 11
    m += [_conv(1024, 3)]                        # 12
    m += [_conv(256, 1)]                         # 13
    m += [_conv(512, 3)]                         # 14
    m += [_head_conv(out_filters)]               # 15
    m += [_yolo("3,4,5", YOLOV3_TINY_ANCHORS, num_classes)]  # 16
    m += [_route("-4")]                          # 17 -> 13
    m += [_conv(128, 1)]                         # 18
    m += [_upsample()]                           # 19
    m += [_route("-1, 8")]                       # 20
    m += [_conv(256, 3)]                         # 21
    m += [_head_conv(out_filters)]               # 22
    m += [_yolo("1,2,3", YOLOV3_TINY_ANCHORS, num_classes)]  # 23
    return m


def yolov3(num_classes: int = 80, img_size: int = 416) -> List[Dict]:
    """Darknet-53 backbone + 3-scale FPN head (75 conv, 23 shortcut, 4 route,
    2 upsample, 3 yolo; routes to layers 61 and 36)."""
    out_filters = 3 * (5 + num_classes)
    m = [_net(img_size, img_size)]
    m += [_conv(32, 3)]  # 0

    def res_stage(channels, blocks):
        m.append(_conv(channels, 3, stride=2))
        for _ in range(blocks):
            m.append(_conv(channels // 2, 1))
            m.append(_conv(channels, 3))
            m.append(_shortcut(-3))

    res_stage(64, 1)      # 1..4
    res_stage(128, 2)     # 5..11
    res_stage(256, 8)     # 12..36  (stage output at 36)
    res_stage(512, 8)     # 37..61  (stage output at 61)
    res_stage(1024, 4)    # 62..74

    # head scale 1 (stride 32)
    for f in (512, 1024, 512, 1024, 512, 1024):
        m.append(_conv(f, 1 if f == 512 else 3))         # 75..80
    m.append(_head_conv(out_filters))                    # 81
    m.append(_yolo("6,7,8", YOLOV3_ANCHORS, num_classes))  # 82

    # head scale 2 (stride 16)
    m.append(_route("-4"))                               # 83 -> 79
    m.append(_conv(256, 1))                              # 84
    m.append(_upsample())                                # 85
    m.append(_route("-1, 61"))                           # 86
    for f in (256, 512, 256, 512, 256, 512):
        m.append(_conv(f, 1 if f == 256 else 3))         # 87..92
    m.append(_head_conv(out_filters))                    # 93
    m.append(_yolo("3,4,5", YOLOV3_ANCHORS, num_classes))  # 94

    # head scale 3 (stride 8)
    m.append(_route("-4"))                               # 95 -> 91
    m.append(_conv(128, 1))                              # 96
    m.append(_upsample())                                # 97
    m.append(_route("-1, 36"))                           # 98
    for f in (128, 256, 128, 256, 128, 256):
        m.append(_conv(f, 1 if f == 128 else 3))         # 99..104
    m.append(_head_conv(out_filters))                    # 105
    m.append(_yolo("0,1,2", YOLOV3_ANCHORS, num_classes))  # 106
    return m


def yolov4(num_classes: int = 80, img_size: int = 608) -> List[Dict]:
    """CSPDarknet-53 (mish) + SPP + PAN head (leaky), 110 conv layers,
    scale_x_y per head -- the stock yolov4.cfg topology."""
    out_filters = 3 * (5 + num_classes)
    m = [_net(img_size, img_size)]

    def cm(f, s, stride=1):
        m.append(_conv(f, s, stride=stride, activation="mish"))

    def cl(f, s, stride=1):
        m.append(_conv(f, s, stride=stride, activation="leaky"))

    cm(32, 3)  # 0
    # --- CSP stage 1: 64, one block at full width (inner 32->64)
    cm(64, 3, 2)      # 1
    cm(64, 1)         # 2  (split branch kept for the tail concat)
    m.append(_route("-2"))  # 3 -> 1
    cm(64, 1)         # 4
    cm(32, 1)         # 5
    cm(64, 3)         # 6
    m.append(_shortcut(-3))  # 7
    cm(64, 1)         # 8
    m.append(_route("-1,-7"))  # 9: 8 + 2
    cm(64, 1)         # 10

    def csp_stage(out_ch, half_ch, blocks, tail_route_offset):
        cm(out_ch, 3, 2)
        cm(half_ch, 1)
        m.append(_route("-2"))
        cm(half_ch, 1)
        for _ in range(blocks):
            cm(half_ch, 1)
            cm(half_ch, 3)
            m.append(_shortcut(-3))
        cm(half_ch, 1)
        m.append(_route(f"-1,{tail_route_offset}"))
        cm(out_ch, 1)

    csp_stage(128, 64, 2, -10)    # 11..23
    csp_stage(256, 128, 8, -28)   # 24..54  (stage output at 54)
    csp_stage(512, 256, 8, -28)   # 55..85  (stage output at 85)
    csp_stage(1024, 512, 4, -16)  # 86..104

    # --- SPP
    cl(512, 1)   # 105
    cl(1024, 3)  # 106
    cl(512, 1)   # 107
    m.append(_maxpool(5, 1))      # 108
    m.append(_route("-2"))        # 109 -> 107
    m.append(_maxpool(9, 1))      # 110
    m.append(_route("-4"))        # 111 -> 107
    m.append(_maxpool(13, 1))     # 112
    m.append(_route("-1,-3,-5,-6"))  # 113: 112,110,108,107
    cl(512, 1)   # 114
    cl(1024, 3)  # 115
    cl(512, 1)   # 116

    # --- PAN up path
    cl(256, 1)   # 117
    m.append(_upsample())         # 118
    m.append(_route("85"))        # 119
    cl(256, 1)   # 120
    m.append(_route("-1, -3"))    # 121: 120 + 118
    cl(256, 1)   # 122
    cl(512, 3)   # 123
    cl(256, 1)   # 124
    cl(512, 3)   # 125
    cl(256, 1)   # 126
    cl(128, 1)   # 127
    m.append(_upsample())         # 128
    m.append(_route("54"))        # 129
    cl(128, 1)   # 130
    m.append(_route("-1, -3"))    # 131: 130 + 128
    cl(128, 1)   # 132
    cl(256, 3)   # 133
    cl(128, 1)   # 134
    cl(256, 3)   # 135
    cl(128, 1)   # 136

    # --- head stride 8
    cl(256, 3)   # 137
    m.append(_head_conv(out_filters))  # 138
    m.append(
        _yolo("0,1,2", YOLOV4_ANCHORS, num_classes, scale_x_y=1.2,
              ignore_thresh=".7")
    )  # 139

    # --- PAN down path, head stride 16
    m.append(_route("-4"))        # 140 -> 136
    cl(256, 3, 2)  # 141
    m.append(_route("-1, -16"))   # 142: 141 + 126
    cl(256, 1)   # 143
    cl(512, 3)   # 144
    cl(256, 1)   # 145
    cl(512, 3)   # 146
    cl(256, 1)   # 147
    cl(512, 3)   # 148
    m.append(_head_conv(out_filters))  # 149
    m.append(
        _yolo("3,4,5", YOLOV4_ANCHORS, num_classes, scale_x_y=1.1,
              ignore_thresh=".7")
    )  # 150

    # --- head stride 32
    m.append(_route("-4"))        # 151 -> 147
    cl(512, 3, 2)  # 152
    m.append(_route("-1, -37"))   # 153: 152 + 116
    cl(512, 1)   # 154
    cl(1024, 3)  # 155
    cl(512, 1)   # 156
    cl(1024, 3)  # 157
    cl(512, 1)   # 158
    cl(1024, 3)  # 159
    m.append(_head_conv(out_filters))  # 160
    m.append(
        _yolo("6,7,8", YOLOV4_ANCHORS, num_classes, scale_x_y=1.05,
              ignore_thresh=".7")
    )  # 161
    return m


ARCHITECTURES = {
    "yolov3": yolov3,
    "yolov3-tiny": yolov3_tiny,
    "yolov4": yolov4,
}
