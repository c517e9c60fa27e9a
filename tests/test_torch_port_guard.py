"""Guards of the PyTorch port: it never imports jax or the JAX package, nor
cv2 or PIL at import time (only inside the functions that decode, encode
or draw), chip_smoke.py refuses to run
without a CUDA device, a kernel wrapper handed a non-CPU tensor launches its
kernel or raises -- it never takes the plain version -- and a facade or a
training CLI asked for a CUDA device that does not exist raises."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from conftest import cpu_subprocess_env

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import yolo_deepsort_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
missing = {"yolo_deepsort_tpu_torch." + m
           for m in ("utils.mot", "utils.metrics", "utils.profiling",
                     "data.datasets", "data.letterbox_np", "train.yolo_loss",
                     "train.yolo_cli", "train.reid_train", "train.reid_cli",
                     "train.trees", "models.layers", "train.sync_bn",
                     "parallel.mesh", "parallel.collectives",
                     "tools.dryrun_multihost", "tools.dryrun_multichip",
                     "tools.train_mesh_clocks", "tools.honest_load",
                     "tools.int8_gate", "tools.int8_detect_gate",
                     "tools.int8_gate_trained", "tools.soak",
                     "tools.soak_multichip", "kernels.launches",
                     "tools.verify_weights", "tools.parity_real",
                     "tools.bench_video",
                     "examples.detect_image", "examples.detect_folder",
                     "examples.track_video", "examples.track_multicamera",
                     "examples.make_demo")} - set(names)
assert not missing, missing
for name in names:
    importlib.import_module(name)
import chip_smoke  # and what the smoke run imports inside its phases
importlib.import_module("specs.weights_np")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "yolo_deepsort_tpu",
                                    "cv2", "PIL"))
print(len(names), "modules;", "jax or JAX-package modules:", bad)
sys.exit(1 if bad else 0)
"""


def _env(**extra):
    env = cpu_subprocess_env(**extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def test_port_never_imports_jax():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "jax or JAX-package modules: []" in res.stdout


def test_chip_smoke_fails_without_cuda():
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_env(CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def _calls():
    from yolo_deepsort_tpu_torch.config import TrackerConfig
    from yolo_deepsort_tpu_torch.ops import (
        assignment_kernel,
        conv_kernel,
        crops_kernel,
        letterbox_kernel,
        resblock_kernel,
    )
    from yolo_deepsort_tpu_torch.tools import int8_probe
    from yolo_deepsort_tpu_torch.tracking import tracker_kernel
    from yolo_deepsort_tpu_torch.tracking.tracker import init_tracker_state

    cfg = TrackerConfig(max_tracks=8, max_dets=4, nn_budget=2, feat_dim=8)
    meta = torch.device("meta")

    def tracker():
        st = init_tracker_state(cfg, 1, meta)
        return tracker_kernel.tracker_step_fused_batched(
            cfg, st, torch.zeros((1, 4, 4), device=meta),
            torch.zeros((1, 4), device=meta),
            torch.zeros((1, 4, 8), device=meta),
            torch.zeros((1, 4), dtype=torch.bool, device=meta), (32, 32))

    def jv(*stage_b):
        def call():
            r, c = 6, 4
            args = (torch.zeros((2, r, c), device=meta),
                    torch.zeros((2, r), dtype=torch.int32, device=meta),
                    torch.ones((2, r), dtype=torch.bool, device=meta),
                    torch.ones((2, c), dtype=torch.bool, device=meta), 0.2)
            if not stage_b:
                return assignment_kernel.solve_cascade_assignment_fused(*args)
            return assignment_kernel.solve_two_stage_assignment_fused(
                *args, args[0], args[2], 0.7)
        return call

    def conv(int8):
        def call():
            x = torch.zeros((1, 8, 8, 128), dtype=torch.bfloat16, device=meta)
            b = torch.zeros((128,), device=meta)
            if not int8:
                return conv_kernel.conv_bf16(
                    x, torch.zeros((3, 3, 128, 128), dtype=torch.bfloat16,
                                   device=meta), b)
            return conv_kernel.conv_int8(
                x, torch.zeros((3, 3, 128, 128), dtype=torch.int8,
                               device=meta), b,
                torch.ones((128,), device=meta), 1.0)
        return call

    def resblock(int8):
        def call():
            x = torch.zeros((1, 8, 8, 128), dtype=torch.bfloat16, device=meta)
            wdt = torch.int8 if int8 else torch.bfloat16
            w1 = torch.zeros((2, 128, 128), dtype=wdt, device=meta)
            w2 = torch.zeros((2, 3, 3, 128, 128), dtype=wdt, device=meta)
            b = torch.zeros((2, 128), device=meta)
            if not int8:
                return resblock_kernel.resblock_chain_bf16(x, w1, b, w2, b)
            return resblock_kernel.resblock_chain_int8(
                x, w1, b, w2, b, b, b, torch.ones((2, 2), device=meta))
        return call

    def probe(dtype):
        return lambda: int8_probe.matmul_probe(
            torch.zeros((128, 64), dtype=dtype, device=meta),
            torch.zeros((64, 128), dtype=dtype, device=meta))

    # (module, plain function, launch counter, call)
    return {
        "resblock_bf16": (resblock_kernel, "resblock_chain_plain_bf16",
                          "launches", resblock(False)),
        "resblock_int8": (resblock_kernel, "resblock_chain_plain_int8",
                          "launches", resblock(True)),
        "probe_bf16": (int8_probe, "matmul_probe_plain", "launches",
                       probe(torch.bfloat16)),
        "probe_int8": (int8_probe, "matmul_probe_plain", "launches",
                       probe(torch.int8)),
        "conv_bf16": (conv_kernel, "conv_plain_bf16", "launches",
                      conv(False)),
        "conv_int8": (conv_kernel, "conv_plain_int8", "launches",
                      conv(True)),
        "letterbox": (letterbox_kernel, "letterbox_batch", "launches",
                      lambda: letterbox_kernel.letterbox_batch_fused(
                          torch.zeros((1, 8, 8, 3), dtype=torch.uint8,
                                      device=meta), 16)),
        "crops": (crops_kernel, "crops_plain", "launches",
                  lambda: crops_kernel.crop_and_normalize_fused(
                      torch.zeros((1, 8, 8, 3), dtype=torch.uint8,
                                  device=meta),
                      torch.zeros((1, 2, 4), device=meta), 4, 4)),
        "crops_dense": (crops_kernel, "crop_and_normalize_batch",
                        "launches_dense",
                        lambda: crops_kernel.crop_and_normalize_dense(
                            torch.zeros((1, 8, 8, 3), dtype=torch.uint8,
                                        device=meta),
                            torch.zeros((1, 2, 4), device=meta))),
        "tracker": (tracker_kernel, "tracker_step", "launches", tracker),
        "jv_cascade": (assignment_kernel, "solve_cascade_assignment",
                       "cascade_launches", jv()),
        "jv_two_stage": (assignment_kernel, "solve_two_stage_assignment",
                         "two_stage_launches", jv(True)),
    }


@pytest.mark.parametrize("kernel", ["letterbox", "crops", "crops_dense",
                                    "tracker",
                                    "jv_cascade", "jv_two_stage",
                                    "conv_bf16", "conv_int8",
                                    "resblock_bf16", "resblock_int8",
                                    "probe_bf16", "probe_int8"])
def test_non_cpu_tensor_never_takes_the_plain_version(kernel, monkeypatch,
                                                      tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel would launch")
    from yolo_deepsort_tpu_torch.kernels import build

    module, plain_name, counter, call = _calls()[kernel]

    def plain_called(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(module, plain_name, plain_called)
    before = getattr(module, counter)
    # a non-CPU, non-CUDA tensor is refused by the device check
    with pytest.raises(ValueError, match="CUDA"):
        call()
    # let it past the device check: with no library and no nvcc, the build
    # raises instead of falling back
    monkeypatch.setattr(build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_lib", None)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        call()
    assert getattr(module, counter) == before


@pytest.mark.parametrize("facade", ["DeepSort", "Extractor", "Darknet"])
def test_facade_on_a_missing_cuda_device_raises(facade):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from yolo_deepsort_tpu_torch import api

    kwargs = {"DeepSort": dict(use_cuda=True), "Extractor": dict(),
              "Darknet": dict(source="yolov3-tiny", device="cuda")}[facade]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(api, facade)(**kwargs)
    assert api.DeepSort(use_cuda=True, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("entry", ["Darknet", "init_tracker_state",
                                   "init_stream_states", "DeepSort",
                                   "make_stream_mesh", "init_global_ids"])
def test_entry_points_default_to_the_card(entry):
    """``device=None`` means the CUDA card: without one the entry point
    raises, and only an explicit ``device="cpu"`` takes the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from yolo_deepsort_tpu_torch import api
    from yolo_deepsort_tpu_torch.config import TrackerConfig
    from yolo_deepsort_tpu_torch.parallel.streams import (
        init_global_ids,
        init_stream_states,
        make_stream_mesh,
    )
    from yolo_deepsort_tpu_torch.tracking.tracker import init_tracker_state

    cfg = TrackerConfig(max_tracks=8, max_dets=4, nn_budget=2, feat_dim=8)
    make = {
        "Darknet": lambda **kw: api.Darknet("yolov3-tiny", img_size=64,
                                            **kw).device,
        "init_tracker_state": lambda **kw: init_tracker_state(
            cfg, 1, **kw).mean.device,
        "init_stream_states": lambda **kw: init_stream_states(
            cfg, 2, **kw).mean.device,
        "DeepSort": lambda **kw: api.DeepSort(**kw).device,
        "make_stream_mesh": lambda **kw: make_stream_mesh(**kw).device,
        "init_global_ids": lambda **kw: init_global_ids(
            cfg, 2, **kw).gid.device,
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    assert make(device="cpu").type == "cpu"


def test_native_frame_pool_build_failure_raises(monkeypatch, tmp_path):
    """The port's frame-ring binding has no quiet fallback: a build that
    fails raises from ``FramePool``."""
    from yolo_deepsort_tpu_torch.runtime import native

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_SRC", str(tmp_path / "missing.cpp"))
    (tmp_path / "missing.cpp").write_text("this is not C++")
    with pytest.raises(RuntimeError, match="native frame_ring"):
        native.FramePool(1, 8, 8)


@pytest.mark.parametrize("cli", ["yolo", "reid"])
def test_training_clis_default_to_the_card(cli, tmp_path):
    """Both training CLIs take ``--device cuda`` by default: without a card
    they raise before reading any data; ``--device cpu`` is the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from yolo_deepsort_tpu_torch.train import reid_cli, yolo_cli

    missing = str(tmp_path / "missing")
    if cli == "yolo":
        argv = ["--cfg", missing, "--data", missing]
        main = yolo_cli.main
    else:
        argv = ["train", "--data-dir", missing]
        main = reid_cli.main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    with pytest.raises(FileNotFoundError):  # the CPU is taken: it reads
        main(argv + ["--device", "cpu"])


def test_stream_mesh_of_several_ranks_needs_a_group():
    """No quiet fallback to one rank: more than one device without an
    initialized process group raises, on the card and on the CPU."""
    from yolo_deepsort_tpu_torch.parallel.mesh import make_stream_mesh

    for device in (None, "cpu"):
        with pytest.raises(ValueError, match="process group"):
            make_stream_mesh(2, device=device)
    mesh = make_stream_mesh(1, device="cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)


@pytest.mark.parametrize("dp, mp", [(2, 1), (1, 2), (2, 2)])
def test_train_mesh_of_several_ranks_needs_a_group(dp, mp):
    """The training mesh likewise: a dp x mp mesh of more than one rank
    without an initialized process group raises, on the card and on the
    CPU; dp = mp = 1 is the mesh of one rank with no group."""
    from yolo_deepsort_tpu_torch.parallel.mesh import make_train_mesh

    for device in (None, "cpu"):
        with pytest.raises(ValueError, match="process group"):
            make_train_mesh(dp, mp, device=device)
    mesh = make_train_mesh(1, 1, device="cpu")
    assert (mesh.dp_group, mesh.mp_group, mesh.dp, mesh.mp) == (None, None,
                                                                 1, 1)


def test_dryrun_tool_defaults_to_the_card():
    """The multi-rank dryrun takes ``--device cuda`` (NCCL) by default:
    without a card it raises before it joins any process group."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from yolo_deepsort_tpu_torch.tools import dryrun_multihost

    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multihost.main(["--num-processes", "1", "--process-id", "0"])


def test_training_dryrun_tool_defaults_to_the_card():
    """So does the training dryrun (``tools/dryrun_multichip.py``)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from yolo_deepsort_tpu_torch.tools import dryrun_multichip

    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip.main(["--num-processes", "1", "--process-id", "0"])


@pytest.mark.parametrize("tool", ["int8_gate", "int8_detect_gate",
                                  "int8_gate_trained", "soak",
                                  "soak_multichip", "honest_load"])
def test_gate_and_soak_tools_default_to_the_card(tool):
    """The gates and soaks take ``--device cuda`` by default (the honest
    load ``device=None``): without a card they raise before any work, and
    no route falls back to the plain versions quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib

    mod = importlib.import_module(f"yolo_deepsort_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if tool == "honest_load":
            mod.bn_weights_and_frames("yolov3-tiny", 64, 1, 1, (64, 64), 4)
        elif tool == "soak_multichip":
            mod.main(["--num-processes", "1", "--process-id", "0"])
        else:
            mod.main([])
