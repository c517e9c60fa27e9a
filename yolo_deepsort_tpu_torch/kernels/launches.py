"""Every kernel launch counter of the port, read and reset together.

Each kernel's wrapper module keeps a module-level count that only its
launch adds to. ``LAUNCH_COUNTERS`` names them all; ``zero_launches`` sets
every count to 0 and ``read_launches`` reads them, so a caller can show
which kernels a run went through.
"""

from __future__ import annotations

import importlib
from typing import Dict

# {kernel name: (module of the port, its launch counter)}
LAUNCH_COUNTERS = {
    "letterbox": ("ops.letterbox_kernel", "launches"),
    "crops": ("ops.crops_kernel", "launches"),
    "crops_interleaved": ("ops.crops_kernel", "launches_interleaved"),
    "crops_dense": ("ops.crops_kernel", "launches_dense"),
    "tracker": ("tracking.tracker_kernel", "launches"),
    "jv_cascade": ("ops.assignment_kernel", "cascade_launches"),
    "jv_two_stage": ("ops.assignment_kernel", "two_stage_launches"),
    "conv": ("ops.conv_kernel", "launches"),
    "conv_int8": ("ops.conv_int8_kernel", "launches"),
    "resblock": ("ops.resblock_kernel", "launches"),
    "matmul_probe": ("tools.int8_probe", "launches"),
}


def _counters():
    """{kernel name: (module, counter attribute)}, the modules imported."""
    pkg = __name__.rsplit(".", 2)[0]
    return {name: (importlib.import_module(f"{pkg}.{mod}"), attr)
            for name, (mod, attr) in LAUNCH_COUNTERS.items()}


def zero_launches() -> None:
    for module, attr in _counters().values():
        setattr(module, attr, 0)


def read_launches() -> Dict[str, int]:
    return {name: int(getattr(module, attr))
            for name, (module, attr) in _counters().items()}
