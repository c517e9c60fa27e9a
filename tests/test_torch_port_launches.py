"""The port's launch-counter registry (``yolo_deepsort_tpu_torch/kernels/
launches.py``), which the tools and ``chip_smoke.py`` read:

* it names every module-level launch counter that a kernel wrapper of the
  package keeps, and nothing else;
* ``read_launches`` reads each counter under its kernel's name and
  ``zero_launches`` resets every one of them.
"""

import importlib
import re
from pathlib import Path

from yolo_deepsort_tpu_torch.kernels import launches as KL
from torch_port_threads import torch_threads  # noqa: F401

PKG = Path(__file__).resolve().parent.parent / "yolo_deepsort_tpu_torch"
COUNTER = re.compile(r"^([a-z_]*launches[a-z_]*) *= *0\b", re.M)


def test_registry_names_every_wrapper_counter():
    found = set()
    for path in PKG.rglob("*.py"):
        mod = ".".join(path.relative_to(PKG).with_suffix("").parts)
        found |= {(mod, attr) for attr in COUNTER.findall(path.read_text())}
    assert set(KL.LAUNCH_COUNTERS.values()) == found
    assert len(KL.LAUNCH_COUNTERS) == len(found)  # one name per counter


def test_read_and_zero_launches_cover_every_counter():
    mods = {name: (importlib.import_module(f"yolo_deepsort_tpu_torch.{m}"),
                   attr) for name, (m, attr) in KL.LAUNCH_COUNTERS.items()}
    saved = {name: getattr(m, attr) for name, (m, attr) in mods.items()}
    try:
        for i, (m, attr) in enumerate(mods.values()):
            setattr(m, attr, i + 1)
        assert KL.read_launches() == {
            name: i + 1 for i, name in enumerate(mods)}
        KL.zero_launches()
        assert KL.read_launches() == {name: 0 for name in mods}
    finally:
        for name, (m, attr) in mods.items():
            setattr(m, attr, saved[name])
