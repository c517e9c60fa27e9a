"""Darknet ``.cfg`` compatibility layer: parser, emitter, COCO names and
the stock YOLOv3 / YOLOv3-tiny / YOLOv4 builders (copies of
yolo_deepsort_tpu/cfg)."""

from .architectures import ARCHITECTURES, yolov3, yolov3_tiny, yolov4  # noqa: F401
from .coco_names import COCO_NAMES, load_classes  # noqa: F401
from .parse import emit_cfg, parse_data_config, parse_model_config  # noqa: F401
