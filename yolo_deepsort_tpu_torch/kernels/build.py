"""Build the package's CUDA kernels with nvcc and load them through ctypes.

The sources in ``csrc/`` are compiled at first use, for ``sm_90a`` (Hopper),
into ONE shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC --fmad=false -c <file>.cu      (per file, all at once)
    nvcc -shared -o libydt_kernels_<hash>.so *.o

A source that names ``CONV_RING_BM`` (the instantiations of the main loop
that kernels 7-10 share, the slowest files to compile) is compiled once per
tile height, ``-DCONV_RING_BM=64`` and ``=128``, side by side.

``load_variants`` builds one source alone with extra ``-D`` defines into a
library of its own, for a tool or test that launches another build of a
kernel (the crop kernels at another strip height, or with clock stamps).

The library lands in ``yolo_deepsort_tpu_torch/build/`` (git-ignored) under
a name keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the cached build. Nothing here links
against PyTorch: each kernel's C entry point takes raw device pointers and
the CUDA stream as ``void*`` and returns the ``cudaError_t`` of its launch.

Importing this module does nothing; ``load()`` builds (if needed) and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# --fmad=false: every kernel must round like its plain PyTorch version (the
# tracker's KF algebra, Cholesky and JV reduced costs decide gates and argmin
# ties; the crop weights are compared bit for bit), so nvcc may not contract
# a*b+c into an FMA. That costs nothing: the kernels are bound by bytes or
# latency, and the conv kernels' products run on the tensor cores (their f32
# epilogues must round like the plain versions for the int8 codes to be
# exactly equal).
BASE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
              "--fmad=false"]

# C entry points: name -> (argtypes, restype); every pointer and the stream
# are c_void_p (a bare Python int would be passed as a 32-bit C int)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # frames, out, b, h, w, size, top, left, side, out_bf16, stream
    "ydt_letterbox": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # frames, boxes, out, b, d, h, w, win_h, win_w, stream
    "ydt_crops": [_P, _P, _P] + [_I] * 6 + [_P],
    "ydt_crops_interleaved": [_P, _P, _P] + [_I] * 6 + [_P],
    # frames, boxes, out, b, d, h, w, stream
    "ydt_crops_dense": [_P, _P, _P] + [_I] * 4 + [_P],
    # app, det_tlwh, det_conf, det_mask, state, hits, age, tsu, track_id,
    # mean, cov, next_id, mean_out, cov_out, ints_out, next_id_out,
    # scratch, s, t, d, max_dist, max_iou_distance, max_age, n_init,
    # min_confidence, staged (host int, out), stream
    "ydt_tracker_step": [_P] * 17 + [_I, _I, _I, _F, _F, _I, _I, _F, _P,
                                     _P],
    # cost, levels, row_mask, col_mask, maxd, maxd_stride, maxd_value, out,
    # s, r, c, staged (host int, out), stream
    "ydt_jv_cascade": [_P] * 5 + [_I, _F, _P, _I, _I, _I, _P, _P],
    # cost_a, levels_a, rows_a, cols, maxd_a, stride_a, value_a, cost_b,
    # rows_b, maxd_b, stride_b, value_b, out_a, out_b, s, r, c, staged
    # (host int, out), stream
    "ydt_jv_two_stage": [_P] * 5 + [_I, _F] + [_P] * 3 + [_I, _F]
    + [_P] * 2 + [_I, _I, _I, _P, _P],
    # x, w, bias, scale, res, xinv, out, n, hi, wi, ci, ho, wo, co, k,
    # stride, pad, act, mode, ldw, bm, bn, stages, split, stream
    "ydt_conv": [_P] * 5 + [_F, _P] + [_I] * 17 + [_P],
    # x, w, scale, bias, res, res_scale, oinv, out, n, hi, wi, ci, ho, wo,
    # co, k, stride, pad, relu, out_int8, ldw, bm, bn, stages, split, stream
    "ydt_conv_int8": [_P] * 5 + [_F, _F, _P] + [_I] * 17 + [_P],
    # x, out, tmp, mid, w1, w2, b1, b2, s1, s2, xinv (host), n, h, w, ci,
    # cm, nblk, act, ldw1, ldw2, bm1, bn1, stages1, split1, bm2, bn2,
    # stages2, split2, int8_mode, launched (host int, out), stream
    "ydt_resblock_chain": [_P] * 11 + [_I] * 18 + [_P, _P],
    # x, w, out, m, k, n, ldw, int8_mode, bm, bn, stages, split, stream
    "ydt_matmul_probe": [_P] * 3 + [_I] * 9 + [_P],
    # pred, thr (or NULL), thr_scalar, keys, tile_valid, dets, mask, sat, n,
    # nb, ncols, k, max_dets, nms_thres, stream
    "ydt_nms": [_P, _P, _F] + [_P] * 5 + [_I] * 5 + [_F, _P],
    # boxes, scores, mask, keep, d, max_overlap, stream
    "ydt_roi_nms": [_P] * 4 + [_I, _F, _P],
}

_lock = threading.Lock()
_lib = None
_variants = {}


def nvcc_path() -> str:
    """The nvcc to build with: $CUDA_HOME/bin/nvcc, then PATH, then the
    toolkit's usual prefix. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of "
        "yolo_deepsort_tpu_torch cannot be built on this machine")


ROW_TILES = (64, 128)  # values of CONV_RING_BM


def sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def compile_units():
    """(source, object name, extra flags) of every nvcc -c the build runs."""
    units = []
    for src in sources():
        if src.suffix != ".cu":
            continue
        if b"CONV_RING_BM" in src.read_bytes():
            units += [(src, f"{src.stem}_{bm}.o", [f"-DCONV_RING_BM={bm}"])
                      for bm in ROW_TILES]
        else:
            units.append((src, src.stem + ".o", []))
    return units


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(repr((ARCH_FLAGS, BASE_FLAGS, ROW_TILES)).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libydt_kernels_{source_hash()}.so"


def _run_all(cmds):
    """Run the commands at once; raise with every failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile csrc/*.cu into the hash-keyed library (no-op when present)."""
    out = library_path()
    if out.exists():
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        units = compile_units()
        objs = [str(Path(tmp) / obj) for _, obj, _ in units]
        _run_all([[nvcc] + ARCH_FLAGS + BASE_FLAGS + flags
                  + ["-I", str(CSRC), "-c", str(src), "-o", obj]
                  for (src, _, flags), obj in zip(units, objs)])
        tmp_so = Path(tmp) / out.name
        _run_all([[nvcc] + ARCH_FLAGS + ["-shared", "-o", str(tmp_so)]
                  + objs])
        os.replace(tmp_so, out)  # atomic: a concurrent loader sees all or none
    return out


def _bind(lib, required=True):
    """Set the argument and result types of the C entries ``lib`` has."""
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name) if required else getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def load():
    """Build if needed, then load the library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def variant_path(stem: str, defines: dict) -> Path:
    """The library of ``csrc/<stem>.cu`` built with ``defines``, keyed by
    the sources, the flags and the defines."""
    key = f"{source_hash()}|{stem}|{sorted(defines.items())!r}"
    digest = hashlib.sha256(key.encode()).hexdigest()[:16]
    return BUILD_DIR / f"libydt_{stem}_{digest}.so"


def variant_command(stem: str, defines: dict, out) -> list:
    """The nvcc command that builds ``csrc/<stem>.cu`` alone, with the
    package's flags and ``-D<name>=<value>`` of every define, into ``out``."""
    return ([nvcc_path()] + ARCH_FLAGS + BASE_FLAGS
            + [f"-D{k}={v}" for k, v in sorted(defines.items())]
            + ["-I", str(CSRC), "-shared", "-o", str(out),
               str(CSRC / f"{stem}.cu")])


def load_variants(stem: str, defines_list) -> list:
    """``csrc/<stem>.cu`` built alone once per dict of defines (every
    missing build at once), each library loaded once per process, its C
    entries bound as ``load()`` binds them. The package's own kernels go
    through ``load()``; these are other builds of them for a tool or test."""
    paths = [variant_path(stem, d) for d in defines_list]
    todo = {p: d for p, d in zip(paths, defines_list) if not p.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            tmps = {p: Path(tmp) / p.name for p in todo}
            _run_all([variant_command(stem, d, tmps[p])
                      for p, d in todo.items()])
            for p in todo:
                os.replace(tmps[p], p)
    with _lock:
        for p in paths:
            if p not in _variants:
                _variants[p] = _bind(ctypes.CDLL(str(p)), required=False)
        return [_variants[p] for p in paths]


def check_launch(name: str, err: int) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel's C entry."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")


def require_cuda(name: str, *tensors, contiguous: bool = True) -> None:
    """Every tensor handed to a kernel must be a CUDA tensor, and contiguous
    where its pointer goes to the kernel as it is."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got device "
                             f"{t.device}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
