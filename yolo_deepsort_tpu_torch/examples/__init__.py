"""Example command-line programs of the port (run as ``python3 -m
yolo_deepsort_tpu_torch.examples.<name>``), twins of the repo's
``examples/``. Each takes ``--device cuda|cpu`` (default the card) and
imports PIL or ``cv2`` only inside ``main``."""
