"""Command-line tools of the port (run as ``python3 -m
yolo_deepsort_tpu_torch.tools.<name>``)."""
