"""Time the kernels on the conv kernels' main loop, and the tracker and JV
kernels, on two clocks, in this checkout or in another one.

    python3 yolo_deepsort_tpu_torch/tools/conv_clocks.py --out clocks.json
    python3 yolo_deepsort_tpu_torch/tools/conv_clocks.py --root DIR --out ...
    python3 yolo_deepsort_tpu_torch/tools/conv_clocks.py --kernels k9 k10
    python3 yolo_deepsort_tpu_torch/tools/conv_clocks.py --kernels k3 k4 k5
    python3 yolo_deepsort_tpu_torch/tools/conv_clocks.py --kernels k1 k2 k6 k1crops
    python3 yolo_deepsort_tpu_torch/tools/conv_clocks.py --kernels mish

Kernel 7 at the 15 eligible conv shapes of yolov3-416 at batch 8 plus the mish
shape (bf16 mode, and int8 mode with bf16 activations), kernel 8 at the nine
shape classes of one int8-resident ReID embed in every epilogue its layers
use, at 320 and at 512 crops; each through the package's public wrapper
(``conv_bf16``, ``conv_int8``; ``conv_int8_kernel.conv_int8``) with HWIO
weights; kernel 9 at the three chain classes of yolov3-416 the chain route
takes, both modes, batch 8 and 32 (``resblock_chain_bf16`` /
``resblock_chain_int8`` on the operands of ``seeded_chain_case``, the
weights packed once where the checkout's module packs them:
``pack_chain_args``); kernel 10 at the probe's (32768, 256) x (256, 256),
both types (``matmul_probe``, the weight packed once where the module
packs it: ``pack_probe_weight``); kernel 3 on the sixth frame of
``chip_smoke.py``'s tracker scene (``_tracker_scene``, seeded 0 here: S=8,
T=128, D=40, F=512, the state advanced through frames 0-4 by the
checkout's own step), kernels 4 and 5 on ``jv_problem`` at ``JV_SHAPE``
(8, 128, 64), seeded 0 -- each the kernel alone on the inputs its
checkout's wrapper hands it (``pack_inputs``; ``cascade_inputs`` /
``two_stage_inputs``, or ``prep`` / ``two_stage_prep`` in a checkout that
predates them) and the whole wrapper beside it (``tracker_step_cuda``, the
two public solvers); kernel 1 on 8 1080p frames to (8, 416, 416, 3) bf16,
kernels 2 and 6 on ``chip_smoke.py``'s ``crops_case`` (8 x 40 boxes, window
(320, 192)), seeded 0, and ``k1crops``: the K=1 step's bf16 crops of those
boxes as the checkout makes them (``k1_crops_fn``); ``strips`` times the
three crop entries at every height of a block's strip of output rows
(``STRIP_SWEEP``; a build of ``csrc/crops.cu`` per height,
``CROPS_STRIP_*``), and the dense entry on boxes as wide as the frame;
``mish`` times kernel 7's bf16 mode at yolov4-608's mish conv shapes at
batch 8 (``MISH_CLASSES``), each with ``mish``, ``linear`` and ``leaky`` on
the one plan the planner gives it, summed over the 72 layers of one
forward: mish over linear and over leaky price the mish epilogue (linear
is no floor where the codes after leaky in ``activate`` pay for mish's
code). Two clocks, both
CUDA events around 50 calls (10 for kernel 9 and ``k1crops``):

* ``called_ms``: the calls made from Python back to back. Where a kernel is
  shorter than its wrapper's time on the host, this is the host's time.
* ``device_ms``: the same calls captured into one CUDA graph and replayed
  (the median of three replays): the card's time with the host out of the
  way.

The sums printed are those of the serving routes: the K=1 step's 19 routed
backbone layers (nine in bf16 mode, ten in int8 mode), the 15 convs of
one embed and the three chains of one forward. ``--root`` imports the package from another checkout -- an earlier
commit unpacked beside this one -- so that two designs are timed on one card,
one after the other, by one script; the script calls only what the wrappers
have taken since they were added. Run it as a file, as above (with ``-m``
Python would import this checkout's package before ``--root`` is read). Needs
the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPS = 50
BATCH = 8
K9_REPS = 10
K1CROPS_REPS = 10
STRIP_SWEEP = (8, 16, 32, 64, 128)  # output rows per block of the crops
# (map, Ci, Cm, blocks): the chains of yolov3-416 the chain route takes, at
# the K=1 step's batch and the chunked step's
K9_CLASSES = ((52, 256, 128, 8), (26, 512, 256, 8), (13, 1024, 512, 4))
K9_BATCHES = (8, 32)
PROBE_SHAPE = (32768, 256, 256)

# (map, Ci, Co, k, stride, act): the eligible conv shapes of yolov3-416, the
# mish shape last; beside each the routed layers of the K=1 step that have it
# (bf16 mode, int8 mode)
K7_CLASSES = (
    ((52, 256, 128, 1, 1, "leaky"), 0, 0),
    ((52, 128, 256, 3, 1, "leaky"), 0, 0),
    ((52, 256, 512, 3, 2, "leaky"), 1, 0),
    ((26, 512, 256, 1, 1, "leaky"), 0, 0),
    ((26, 256, 512, 3, 1, "leaky"), 0, 0),
    ((26, 512, 1024, 3, 2, "leaky"), 0, 0),
    ((13, 1024, 512, 1, 1, "leaky"), 0, 7),
    ((13, 512, 1024, 3, 1, "leaky"), 7, 0),
    ((13, 1024, 255, 1, 1, "linear"), 0, 0),
    ((13, 512, 256, 1, 1, "leaky"), 0, 1),
    ((26, 768, 256, 1, 1, "leaky"), 0, 0),
    ((26, 512, 255, 1, 1, "linear"), 0, 1),
    ((26, 256, 128, 1, 1, "leaky"), 0, 1),
    ((52, 384, 128, 1, 1, "leaky"), 1, 0),
    ((52, 256, 255, 1, 1, "linear"), 0, 0),
    ((26, 256, 512, 3, 1, "mish"), 0, 0),
)
# (map, Ci, Co, k, stride) of yolov4-608's mish convs (the cfg's
# gpubench/configs/yolov4.cfg), each with its count of layers: 26 shapes, 72
# convs, 758.6 M outputs at batch 8. The stem's Ci 3 is padded to 8, as the
# bf16 forward pads it.
MISH_CLASSES = (
    ((608, 3, 32, 3, 1), 1),
    ((608, 32, 64, 3, 2), 1),
    ((304, 32, 64, 3, 1), 1),
    ((304, 64, 32, 1, 1), 1),
    ((304, 64, 64, 1, 1), 3),
    ((304, 64, 128, 3, 2), 1),
    ((304, 128, 64, 1, 1), 1),
    ((152, 64, 64, 1, 1), 3),
    ((152, 64, 64, 3, 1), 2),
    ((152, 128, 64, 1, 1), 2),
    ((152, 128, 128, 1, 1), 1),
    ((152, 128, 256, 3, 2), 1),
    ((76, 128, 128, 1, 1), 9),
    ((76, 128, 128, 3, 1), 8),
    ((76, 256, 128, 1, 1), 2),
    ((76, 256, 256, 1, 1), 1),
    ((76, 256, 512, 3, 2), 1),
    ((38, 256, 256, 1, 1), 9),
    ((38, 256, 256, 3, 1), 8),
    ((38, 512, 256, 1, 1), 2),
    ((38, 512, 512, 1, 1), 1),
    ((38, 512, 1024, 3, 2), 1),
    ((19, 512, 512, 1, 1), 5),
    ((19, 512, 512, 3, 1), 4),
    ((19, 1024, 512, 1, 1), 2),
    ((19, 1024, 1024, 1, 1), 1),
)
# (k, stride, h, w, Ci, Co) and the class's layers as (relu, int8 out,
# residual) -> how many layers of one embed
K8_CLASSES = (
    ((3, 2, 64, 32, 64, 128), {(True, True, False): 1}),
    ((1, 2, 64, 32, 64, 128), {(False, True, False): 1}),
    ((3, 1, 32, 16, 128, 128), {(True, True, True): 2,
                                (True, True, False): 1}),
    ((3, 2, 32, 16, 128, 256), {(True, True, False): 1}),
    ((1, 2, 32, 16, 128, 256), {(False, True, False): 1}),
    ((3, 1, 16, 8, 256, 256), {(True, True, True): 2,
                               (True, True, False): 1}),
    ((3, 2, 16, 8, 256, 512), {(True, True, False): 1}),
    ((1, 2, 16, 8, 256, 512), {(False, True, False): 1}),
    ((3, 1, 8, 4, 512, 512), {(True, True, True): 1, (True, True, False): 1,
                              (True, False, True): 1}),
)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else ""


def both_clocks(torch, fn, reps=REPS):
    """(called_ms, device_ms) of fn()."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    called = start.elapsed_time(end) / reps
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return called, sorted(times)[1]


def time_k9(torch, dev, rng):
    """Kernel 9 per chain class, mode and batch, and the three chains of
    one forward summed."""
    from yolo_deepsort_tpu_torch.ops import resblock_kernel as RK

    packed = getattr(RK, "pack_chain_args", lambda args: args)
    classes, forward = [], {}
    for n in K9_BATCHES:
        for h, ci, cm, nblk in K9_CLASSES:
            case = RK.seeded_chain_case(rng, dev, n, h, ci, cm, nblk)
            for mode, fn in (("bf16", RK.resblock_chain_bf16),
                             ("int8", RK.resblock_chain_int8)):
                args = packed(case[mode])
                called, device = both_clocks(torch, lambda: fn(*args),
                                             K9_REPS)
                classes.append({"shape": [n, h, ci, cm, nblk], "mode": mode,
                                "called_ms": called, "device_ms": device})
                tot = forward.setdefault(f"{mode} N={n}", {
                    "called_ms": 0.0, "device_ms": 0.0})
                tot["called_ms"] += called
                tot["device_ms"] += device
                print(f"k9 {mode} N={n} {h}x{h} {ci}/{cm} x{nblk}: called "
                      f"{called:.4f} ms, device {device:.4f} ms", flush=True)
            del case
    for key, tot in forward.items():
        print(f"k9, one forward's three chains, {key}: called "
              f"{tot['called_ms']:.6f} ms, device {tot['device_ms']:.6f} ms",
              flush=True)
    return {"per_class": classes, "forward_3_chains": forward}


def time_mish(torch, dev):
    """Kernel 7's bf16 mode per mish shape class, with ``mish``, ``linear``
    and ``leaky`` on the same plan (the planner's for this card), and the
    forward's 72 layers summed: ``epilogue_ms`` is mish minus linear."""
    from yolo_deepsort_tpu_torch.ops import conv_kernel, conv_plan

    gen = torch.Generator(device=dev).manual_seed(0)
    classes = []
    acts = ("mish", "linear", "leaky")
    forward = {act: {"called_ms": 0.0, "device_ms": 0.0} for act in acts}
    for (hi, ci, co, k, stride), layers in MISH_CLASSES:
        cp, pad = -(-ci // 8) * 8, (k - 1) // 2
        ho = (hi + 2 * pad - k) // stride + 1
        x = torch.zeros((BATCH, hi, hi, cp), device=dev, dtype=torch.bfloat16)
        x[..., :ci] = torch.randn((BATCH, hi, hi, ci), generator=gen,
                                  device=dev)
        w = torch.zeros((k, k, cp, co), device=dev)
        w[:, :, :ci] = torch.randn((k, k, ci, co), generator=gen,
                                   device=dev) / (k * k * ci) ** 0.5
        wp = conv_plan.pack_conv_weights(w.to(torch.bfloat16))
        b = torch.randn((co,), generator=gen, device=dev)
        plan = conv_plan.plan_for(dev, BATCH * ho * ho, co, k * k * cp, 2)
        row = {"shape": [hi, ci, co, k, stride], "layers": layers,
               "plan": list(plan)}
        for act in acts:
            called, device = both_clocks(
                torch, lambda: conv_kernel.conv_bf16_cuda(
                    x, wp, b, stride=stride, pad=pad, act=act, plan=plan))
            row[act] = {"called_ms": called, "device_ms": device}
            forward[act]["called_ms"] += layers * called
            forward[act]["device_ms"] += layers * device
        row["epilogue_ms"] = (row["mish"]["device_ms"]
                              - row["linear"]["device_ms"])
        classes.append(row)
        print(f"mish class {k}x{k} s{stride} {hi} {ci}->{co} x{layers} plan "
              f"{tuple(plan)}: device mish {row['mish']['device_ms']:.6f} "
              f"ms, linear {row['linear']['device_ms']:.6f} ms, leaky "
              f"{row['leaky']['device_ms']:.6f} ms", flush=True)
        del x, w, wp
    epilogue = forward["mish"]["device_ms"] - forward["linear"]["device_ms"]
    print(f"mish convs, one forward's 72 layers: device mish "
          f"{forward['mish']['device_ms']:.6f} ms, linear "
          f"{forward['linear']['device_ms']:.6f} ms, leaky "
          f"{forward['leaky']['device_ms']:.6f} ms, epilogue "
          f"{epilogue:.6f} ms", flush=True)
    return {"per_class": classes, "forward_72_layers": forward,
            "epilogue_ms": epilogue}


def time_k10(torch, dev):
    """Kernel 10 at the probe's shape, both types."""
    from yolo_deepsort_tpu_torch.tools import int8_probe as P

    pack = getattr(P, "pack_probe_weight", lambda w: w)
    xb, wb, xi, wi = P.probe_operands(*PROBE_SHAPE, dev)
    out = {}
    for mode, x, w in (("bf16", xb, wb), ("int8", xi, wi)):
        wk = pack(w)
        called, device = both_clocks(torch, lambda: P.matmul_probe(x, wk))
        out[mode] = {"called_ms": called, "device_ms": device}
        print(f"k10 {mode} {PROBE_SHAPE}: called {called:.6f} ms, device "
              f"{device:.6f} ms", flush=True)
    return out


def _smoke():
    """This checkout's ``chip_smoke.py`` as a module (its scene and problem
    makers; it imports numpy only at the top)."""
    import importlib.util

    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_ydt_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_tracker_jv(torch, dev, kernels):
    """Kernels 3-5 alone and inside their wrappers, on both clocks."""
    from yolo_deepsort_tpu_torch.config import TrackerConfig
    from yolo_deepsort_tpu_torch.ops import assignment_kernel as AK
    from yolo_deepsort_tpu_torch.tracking import tracker_kernel as TK
    from yolo_deepsort_tpu_torch.tracking.tracker import init_tracker_state

    smoke = _smoke()
    out = {}

    def record(name, fn):
        called, device = both_clocks(torch, fn)
        out[name] = {"called_ms": called, "device_ms": device}
        print(f"{name}: called {called:.6f} ms, device {device:.6f} ms",
              flush=True)

    if "k3" in kernels:
        cfg = TrackerConfig(max_dets=40)
        hw = (smoke.FRAME_H, smoke.FRAME_W)
        scene = smoke._tracker_scene(np.random.default_rng(0), smoke.STREAMS,
                                     40, 6, cfg.feat_dim)
        state = init_tracker_state(cfg, smoke.STREAMS, dev)
        for args in scene[:5]:
            state, _, _ = TK.tracker_step_fused_batched(
                cfg, state, *(a.to(dev) for a in args), hw)
        args = [a.to(dev) for a in scene[5]]
        packed = TK.pack_inputs(cfg, state, *args)
        record("k3", lambda: TK.kernel_batched(cfg, *packed))
        # the whole step writes the gallery in place: every replay sees a
        # gallery one write further on, the same work
        record("k3 whole step", lambda: TK.tracker_step_cuda(
            cfg, state, *args, hw))
    prob = [v.to(dev) for v in smoke.jv_problem(np.random.default_rng(0),
                                                *smoke.JV_SHAPE)]
    c = smoke.JV_SHAPE[2]
    if "k4" in kernels:
        if hasattr(AK, "cascade_inputs"):
            bufs = AK.cascade_inputs(*prob[:5])
        else:
            bufs = AK.prep(*prob[:5])
        record("k4", lambda: AK.cascade_kernel(*bufs))
        record("k4 whole wrapper",
               lambda: AK.solve_cascade_assignment_fused(*prob[:5]))
    if "k5" in kernels:
        if hasattr(AK, "two_stage_inputs"):
            bufs5 = AK.two_stage_inputs(*prob, 0.7)
            fn = lambda: AK.two_stage_kernel(*bufs5)  # noqa: E731
        else:
            bufs5 = AK.two_stage_prep(*prob, 0.7)
            fn = lambda: AK.two_stage_kernel(*bufs5, c)  # noqa: E731
        record("k5", fn)
        record("k5 whole wrapper",
               lambda: AK.solve_two_stage_assignment_fused(*prob, 0.7))
    return out


def time_letterbox_crops(torch, dev, kernels):
    """Kernels 1, 2 and 6 alone on the smoke's inputs (``crops_case``), and
    the K=1 step's crops as the checkout makes them (``k1crops``)."""
    from yolo_deepsort_tpu_torch.ops import crops_kernel as CK
    from yolo_deepsort_tpu_torch.ops import letterbox_kernel as LK

    smoke = _smoke()
    out = {}

    def record(name, fn, reps=REPS):
        called, device = both_clocks(torch, fn, reps)
        out[name] = {"called_ms": called, "device_ms": device}
        print(f"{name}: called {called:.6f} ms, device {device:.6f} ms",
              flush=True)

    frames, boxes = smoke.crops_case(np.random.default_rng(0), dev)
    win = smoke.K1_WINDOW
    if "k1" in kernels:
        record("k1", lambda: LK.letterbox_cuda(frames, 416, torch.bfloat16))
    if "k2" in kernels:
        record("k2", lambda: CK.crops_cuda(frames, boxes, *win))
    if "k6" in kernels:
        record("k6", lambda: CK.crops_cuda(frames, boxes, *win,
                                           interleaved=True))
    if "k1crops" in kernels:
        record("k1crops", k1_crops_fn(torch, smoke, frames, boxes, win),
               K1CROPS_REPS)
    if "strips" in kernels:
        # output rows per block of each entry, and the dense entry on boxes
        # as wide as the frame (their tap columns are gathered)
        wide = boxes.clone()
        wide[..., 0], wide[..., 2] = 0.0, float(frames.shape[2] - 1)
        from yolo_deepsort_tpu_torch.kernels import build

        libs = build.load_variants(
            "crops", [CK.strip_defines(rows) for rows in STRIP_SWEEP])
        for rows, lib in zip(STRIP_SWEEP, libs):
            record(f"k2 strip {rows}", lambda: CK.crops_cuda(
                frames, boxes, *win, lib=lib))
            record(f"k6 strip {rows}", lambda: CK.crops_cuda(
                frames, boxes, *win, interleaved=True, lib=lib))
            record(f"dense strip {rows}", lambda: CK.crops_dense_cuda(
                frames, boxes, lib=lib))
            record(f"dense wide strip {rows}", lambda: CK.crops_dense_cuda(
                frames, wide, lib=lib))
    return out


def k1_crops_fn(torch, smoke, frames, boxes, win):
    """fn() -> the K=1 step's bf16 crops of every box (all consumed), as
    the checkout's step makes them: ``streams.make_k1_crops`` where the
    checkout has it; before it, kernel 2 and the per-frame dense crops,
    selected on the window guard's device flag (``chip_smoke.py``
    ``k1_crops_parent``)."""
    from yolo_deepsort_tpu_torch.parallel import streams as ST

    hw = tuple(frames.shape[1:3])
    mask = torch.ones(boxes.shape[:2], dtype=torch.bool, device=boxes.device)
    if hasattr(ST, "make_k1_crops"):
        crops = ST.make_k1_crops(hw, win, torch.bfloat16)
        return lambda: crops(frames, boxes, mask)
    return lambda: smoke.k1_crops_parent(frames, boxes, mask, hw, win)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="the checkout whose package is timed (default: "
                         "this one)")
    ap.add_argument("--crops", type=int, nargs="*", default=[320, 512])
    ap.add_argument("--kernels", nargs="*", default=["k7", "k8", "k9", "k10"],
                    help="which kernels to time (k1 k2 k6 k1crops k3 k4 "
                         "k5 k7 k8 k9 k10; strips: the crop entries at "
                         "every strip height, this checkout only; mish: "
                         "kernel 7 at yolov4-608's mish conv shapes, mish "
                         "against linear and leaky)")
    ap.add_argument("--out", default=None, help="write the JSON record here")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve() if args.root else \
        Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))

    import torch

    from yolo_deepsort_tpu_torch.ops import conv_int8_kernel, conv_kernel

    if not torch.cuda.is_available():
        raise SystemExit("conv_clocks: needs the card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {"root": str(root), "card": card_line(), "reps": REPS,
           "k7": [], "k8": {}}
    routed = {"called_ms": 0.0, "device_ms": 0.0}
    for (hi, ci, co, k, stride, act), n_bf16, n_int8 in (
            K7_CLASSES if "k7" in args.kernels else ()):
        x = torch.from_numpy(rng.standard_normal(
            (BATCH, hi, hi, ci), np.float32)).to(dev, torch.bfloat16)
        w = (rng.standard_normal((k, k, ci, co), np.float32)
             / np.sqrt(k * k * ci)).astype(np.float32)
        wscale = (np.abs(w).reshape(-1, co).max(0) / 127.0).astype(np.float32)
        wq = torch.from_numpy(np.clip(np.rint(w / wscale), -127, 127).astype(
            np.int8)).to(dev)
        xscale = np.float32(float(x.float().abs().max()) / 127.0)
        scale = torch.from_numpy(xscale * wscale).to(dev)
        xinv = np.float32(1.0 / xscale)
        wb = torch.from_numpy(w).to(dev, torch.bfloat16)
        b = torch.from_numpy(rng.standard_normal((co,), np.float32)).to(dev)
        kw = dict(stride=stride, pad=(k - 1) // 2, act=act)
        modes = (
            ("bf16", n_bf16, lambda: conv_kernel.conv_bf16(x, wb, b, **kw)),
            ("int8", n_int8, lambda: conv_kernel.conv_int8(
                x, wq, b, scale, xinv, **kw)))
        for mode, n_routed, fn in modes:
            called, device = both_clocks(torch, fn)
            out["k7"].append({"shape": [hi, ci, co, k, stride, act],
                              "mode": mode, "routed_layers": n_routed,
                              "called_ms": called, "device_ms": device})
            routed["called_ms"] += n_routed * called
            routed["device_ms"] += n_routed * device
            print(f"k7 {k}x{k} s{stride} {hi} {ci}->{co} {act} {mode}: "
                  f"called {called:.4f} ms, device {device:.4f} ms",
                  flush=True)
    if "k7" in args.kernels:
        out["k7_routed_19_layers"] = routed
        print(f"k7, the K=1 step's 19 routed layers: called "
              f"{routed['called_ms']:.6f} ms, device "
              f"{routed['device_ms']:.6f} ms", flush=True)
    for crops in (args.crops if "k8" in args.kernels else ()):
        layers = []
        embed = {"called_ms": 0.0, "device_ms": 0.0}
        for (k, stride, h, w_, ci, co), epilogues in K8_CLASSES:
            ho, wo = h // stride, w_ // stride
            xq = torch.from_numpy(rng.integers(
                -127, 128, (crops, h, w_, ci)).astype(np.int8)).to(dev)
            wq = torch.from_numpy(rng.integers(
                -127, 128, (k, k, ci, co)).astype(np.int8)).to(dev)
            scale = torch.full((co,), 1e-4, device=dev)
            b = torch.zeros((co,), device=dev)
            res = torch.from_numpy(rng.integers(
                -127, 128, (crops, ho, wo, co)).astype(np.int8)).to(dev)
            for (relu, out_int8, has_res), count in epilogues.items():
                def fn():
                    return conv_int8_kernel.conv_int8(
                        xq, wq, scale, b, 20.0, res if has_res else None,
                        0.03 if has_res else None, stride=stride,
                        pad=(k - 1) // 2, relu=relu, out_int8=out_int8)
                called, device = both_clocks(torch, fn)
                layers.append({"shape": [k, stride, h, w_, ci, co],
                               "relu": relu, "out_int8": out_int8,
                               "residual": has_res, "layers": count,
                               "called_ms": called, "device_ms": device})
                embed["called_ms"] += count * called
                embed["device_ms"] += count * device
                print(f"k8 N={crops} {k}x{k} s{stride} {h}x{w_} {ci}->{co} "
                      f"relu={relu} int8={out_int8} residual={has_res}: "
                      f"called {called:.4f} ms, device {device:.4f} ms",
                      flush=True)
        out["k8"][str(crops)] = {"per_epilogue": layers,
                                 "embed_15_layers": embed}
        print(f"k8, one embed of {crops} crops (15 layers): called "
              f"{embed['called_ms']:.6f} ms, device "
              f"{embed['device_ms']:.6f} ms", flush=True)
    if "k9" in args.kernels:
        out["k9"] = time_k9(torch, dev, rng)
    if "k10" in args.kernels:
        out["k10"] = time_k10(torch, dev)
    if "mish" in args.kernels:
        out["mish"] = time_mish(torch, dev)
    if {"k3", "k4", "k5"} & set(args.kernels):
        out["tracker_jv"] = time_tracker_jv(torch, dev, args.kernels)
    if {"k1", "k2", "k6", "k1crops", "strips"} & set(args.kernels):
        out["letterbox_crops"] = time_letterbox_crops(torch, dev,
                                                      args.kernels)
    print(out["card"])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
