"""Darknet ``.cfg`` / ``.data`` parsing and emission (copy of
yolo_deepsort_tpu/cfg/parse.py; ``tests/test_torch_port_config.py`` holds
the two equal). Stock cfg files load unchanged.
"""

from __future__ import annotations

import os
from typing import Dict, List


def parse_model_config(path: str | os.PathLike) -> List[Dict[str, str]]:
    """Parse a darknet cfg into a list of section dicts (``type`` key holds
    the section name; all values kept as strings; ``batch_normalize``
    defaults to 0 for convolutional sections, like the reference)."""
    with open(path, "r", encoding="utf-8") as f:
        lines = f.read().split("\n")
    lines = [l.strip() for l in lines]
    lines = [l for l in lines if l and not l.startswith("#")]

    module_defs: List[Dict[str, str]] = []
    for line in lines:
        if line.startswith("["):
            module_defs.append({"type": line[1:-1].rstrip()})
            if module_defs[-1]["type"] == "convolutional":
                module_defs[-1]["batch_normalize"] = "0"
        else:
            key, value = line.split("=", 1)
            module_defs[-1][key.rstrip()] = value.lstrip()
    return module_defs


def parse_data_config(path: str | os.PathLike) -> Dict[str, str]:
    """Parse a darknet .data config (train/valid paths, names, gpus...)."""
    options: Dict[str, str] = {"gpus": "0,1,2,3", "num_workers": "10"}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            key, value = line.split("=", 1)
            options[key.strip()] = value.strip()
    return options


def emit_cfg(module_defs: List[Dict], path: str | os.PathLike | None = None) -> str:
    """Serialize module_defs back to darknet cfg text (round-trips through
    parse_model_config)."""
    out = []
    for mdef in module_defs:
        out.append(f"[{mdef['type']}]")
        for k, v in mdef.items():
            if k == "type":
                continue
            if k == "batch_normalize" and str(v) == "0":
                continue  # implicit default
            out.append(f"{k}={v}")
        out.append("")
    text = "\n".join(out)
    if path is not None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
    return text
