"""One run of a cell: inputs, program, warm-up, window, optional traced
slice, the program's detector captured layer by layer on the sampled
frames after the window, then the reference's verdict. ``run.py`` is the
command around it; the control and the tests call it directly (on the
CPU, at tiny sizes)."""

from __future__ import annotations

import contextlib
import functools
import gc
import statistics
import time
from collections import Counter
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import compare, flops, load, serve, trace
from .reference import darknet as ref_darknet

INF = float("inf")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_numpy(smp: Dict) -> compare.Sample:
    return compare.Sample(
        pre=serve.state_arrays(smp["pre"]),
        post=serve.state_arrays(smp["post"]),
        outputs=smp["outputs"], emit=smp["emit"],
        frame_ids=smp["frame_ids"],
        decoded={f: d.float().cpu().numpy()
                 for f, d in smp["decoded"].items()},
        nms_conf=smp["nms_conf"].cpu().numpy(),
        inputs=[tuple(t.float().cpu().numpy() if t.is_floating_point()
                      else t.cpu().numpy() for t in frame)
                for frame in smp["inputs"]])


def _median_call_s(fn, device, calls: int = 5) -> float:
    """Median device seconds of ``fn()`` by CUDA events (host clock on the
    CPU), after one call to warm it."""
    fn()
    times = []
    for _ in range(calls):
        if device.type == "cuda":
            a, b = torch.cuda.Event(True), torch.cuda.Event(True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        else:
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
    return statistics.median(times)


def _nms_caps(cfg: Dict, traffic: Dict) -> Dict:
    """The NMS's IoU threshold and capacities, as the cell's step runs it
    (the K=1 step at its cap)."""
    return dict(nms_thres=cfg["detect"]["nms_thres"],
                max_boxes=cfg["detect"]["max_boxes"],
                max_dets=(traffic["cap"] if traffic["kind"] == "k1"
                          else cfg["tracker"]["max_dets"]))


def _thresholds(defs, raw, frames_v, img: int, traffic: Dict, cfg: Dict
                ) -> List[float]:
    """The mix's thresholds, one a stream, from the reference's float32
    objectness on every frame of the run (``load.stream_thresholds``;
    K=1: one pooled threshold, ``load.pooled_threshold``)."""
    det = _nms_caps(cfg, traffic)
    fullest = traffic["target_dets"] - traffic["margin"]
    cand = load.candidates(defs, raw, frames_v, img,
                           4 * traffic["target_dets"])
    if traffic["kind"] == "k1":
        return [load.pooled_threshold(cand, fullest, det)] * cand.shape[1]
    return load.stream_thresholds(cand, fullest, det)


@contextlib.contextmanager
def _steady():
    """No garbage collection inside a timed window: what is alive is
    frozen out of the collector's sight, and it is switched off until the
    window closes."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()


def run_cell(cfg: Dict, cfg_path: str, traffic: Dict, limits: Dict,
             seed: int, seconds: float, traced: bool, device,
             e2e: List[str], layer: List[str], t_start: float,
             read_metric: Optional[Callable] = None, route: str = "stated",
             fault: Optional[Callable] = None,
             controls: bool = False) -> Dict:
    """-> {"line": the result object, "detail": earlier lines, "numbers":
    the numbers compared, "samples": per-sample numbers}. ``fault`` wraps
    the built step (the tests' broken programs); ``route="int8"`` is the
    program's control. ``controls`` adds, judged on the same samples, the
    numbers with the reference tracker's state rounded to bfloat16 in the
    program's place ("tracker_bf16") and the detector's ``det_cos`` and
    ``det_layer_cos`` with the reference computed with W8A8 rounding in
    its place ("detector_int8": the whole forward, and each conv on the
    program's own inputs of it)."""
    from yolo_deepsort_tpu_torch.kernels.launches import (read_launches,
                                                          zero_launches)

    k1 = traffic["kind"] == "k1"
    hw = tuple(traffic["frame_hw"])
    s_n, k = traffic["streams"], traffic.get("chunk", 1)
    img = cfg["img_size"]
    with open(cfg_path) as f:
        cfg_text = f.read()
    defs = ref_darknet.parse_cfg(cfg_text)[1:]

    v_n = traffic["variants"]
    frames_v = load.frames(seed, s_n, hw, device, v_n,
                           traffic["noise_sigma"])
    raw = load.detector_weights(defs, img, frames_v[0], seed,
                                cfg["box_prior"])
    reid_sd = load.reid_state_dict(seed, device)
    thr = _thresholds(defs, raw, frames_v, img, traffic, cfg)
    make_step, detector, reid, conv_impl = serve.build(
        cfg, traffic, cfg_path, raw, reid_sd, device, route, frames_v[0])
    ids = list(range(v_n)) if k1 else [f % v_n for f in range(k)]
    frames = (frames_v if k1 or ids == list(range(v_n)) else frames_v[ids])
    step, states = make_step(thr)
    if fault is not None:
        step = fault(step)
    rng = np.random.default_rng(seed % 2 ** 63)
    window = functools.partial(
        serve.k1_window if k1 else serve.chunk_window, frame_ids=ids,
        pick=rng)

    # warm-up: the first unit (from the fresh state) is the start sample
    start = window(step, states, frames, INF, sample_at=[0.0], max_units=1)
    warm = window(step, start.states, frames, INF,
                  max_units=traffic["warmup"])
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sample_at = list(rng.uniform(0.05, 0.95, traffic["samples"]) * seconds)
    zero_launches()
    readbacks = getattr(step, "host_readbacks", 0)
    setup_s = time.time() - t_start
    with _steady():
        w = window(step, warm.states, frames, seconds, sample_at=sample_at)
        _sync(device)
    launches = read_launches()
    readbacks = getattr(step, "host_readbacks", 0) - readbacks
    mem = (torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else 0)

    tr: Dict = {}
    extra: Dict = {}
    if traced:
        with trace.profiled(tr), _steady():
            t = time.perf_counter()
            wb = window(step, w.states, frames, INF, spans=True,
                        max_units=traffic["trace_units"])
            _sync(device)
            tr["window_s"] = time.perf_counter() - t
        tr["units"] = wb.units
        del wb
        if not k1:
            extra = _stage_timings(detector, reid, frames, img, w, device)
    samples = [_to_numpy(x) for x in start.samples + w.samples]
    saturation = step.saturation() if hasattr(step, "saturation") else None
    del step, states, reid, start, warm, frames
    w.states = None
    w.samples = []
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    t_judge = time.perf_counter()
    captures = _captures(detector, conv_impl, frames_v, samples, defs, raw,
                         img, controls)
    capture_peak = (torch.cuda.max_memory_allocated(device)
                    if device.type == "cuda" else 0)
    del detector, conv_impl
    if device.type == "cuda":
        torch.cuda.empty_cache()
    judge = compare.Judge(compare.Reference(
        defs, raw, reid_sd, frames_v, img, _nms_caps(cfg, traffic),
        cfg["tracker"]), hw, captures)
    per_sample = [judge.judge(x) for x in samples]
    numbers = judge.numbers()
    control_numbers = None
    if controls:
        judge.total = compare.Tally()
        judge.tracker_round = compare.bf16_round
        for x in samples:
            judge.judge(x)
        control_numbers = {"tracker_bf16": judge.numbers(),
                           "detector_int8": {
                               "det_cos": judge.int8_det_cos(),
                               "det_layer_cos": functools.reduce(
                                   compare.worst,
                                   (v for c in captures.values()
                                    for v in c.int8_per_module.values()))}}
    ok, checks = compare.verdict(numbers, limits)
    failed = sum(not compare.verdict(n, limits)[0] for n in per_sample[1:])
    judge_s = time.perf_counter() - t_judge

    dets_per_frame = float(np.mean([m.sum() / m.shape[0] for x in samples
                                    for *_, m in x.inputs] or [0.0]))
    metrics: Dict = {}
    values = {
        "fps": lambda: w.frames / w.secs,
        "k1_p50_ms": lambda: float(np.percentile(w.latency_s, 50)) * 1e3,
        "k1_p95_ms": lambda: float(np.percentile(w.latency_s, 95)) * 1e3,
        "setup_s": lambda: setup_s,
    }
    units = {"fps": "frames/s", "k1_p50_ms": "ms", "k1_p95_ms": "ms",
             "setup_s": "s"}
    if not traced:
        for name in e2e:
            metrics[name] = {"value": values[name](), "unit": units[name]}
    else:
        ctx = dict(kind=traffic["kind"], trace=tr, flops=flops,
                   window=w, k=k, streams=s_n, dets_per_frame=dets_per_frame,
                   detector_convs=flops.detector_convs(cfg_text, img),
                   reid_convs=flops.reid_convs(), **extra)
        for name in layer:
            v = read_metric(name, ctx)
            if v is not None:
                metrics[name] = v
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(mem)}
    line = {"correct": bool(ok and failed == 0), "attempted": w.units,
            "failed": int(failed), "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": [list(x) for x in tr["device_ops"]],
                             "idle_gaps": [list(x) for x in tr["idle_gaps"]]}
    line["checks"] = checks
    detail = [{"window": {
        "units": w.units, "frames": w.frames, "secs": w.secs,
        "setup_s": setup_s, "thresholds": thr,
        "dets_per_frame": dets_per_frame,
        "buckets": dict(Counter(map(str, w.buckets))),
        "max_counts": dict(Counter(map(str, w.counts))),
        "crop_windows": dict(Counter(map(str, w.windows))),
        "launches": launches, "host_readbacks": readbacks,
        "saturation": saturation,
        "latency_ms": ([float(np.percentile(w.latency_s, q)) * 1e3
                        for q in (50, 95, 99)] if w.latency_s else None),
        "route": route}},
        {"samples": per_sample, "error": judge.total.error,
         "judge_s": judge_s, "capture_peak_bytes": int(capture_peak),
         "layers": [_layer_detail(defs, key, c)
                    for key, c in captures.items()]}]
    if traced:
        detail.append({"trace": {key: tr[key] for key in (
            "span_s", "span_count", "busy_s", "window_s", "unattributed_s",
            "n_device_ops", "units")}, "stage_timings": {
                key: v for key, v in extra.items()}})
    res = {"line": line, "detail": detail, "numbers": numbers,
           "samples": per_sample}
    if controls:
        res["controls"] = control_numbers
    return res


def _captures(detector, conv_impl, frames_v, samples, defs, raw, img: int,
              int8: bool) -> Dict[tuple, compare.Capture]:
    """Of every distinct sampled unit (its frame ids): the program's eager
    forward of the unit's frames, the batch its detector ran
    (``serve.capture``), judged layer by layer on the device as the
    capture is walked (``compare.judge_layers``, with the reference's W8A8
    in the program's place if ``int8``) at the unit's sampled frame
    positions, and its decoded rows there. Only those numbers and rows are
    kept."""
    out = {}
    for key in dict.fromkeys(tuple(x.frame_ids) for x in samples):
        pos = sorted({f for x in samples if tuple(x.frame_ids) == key
                      for f in x.decoded})
        unit = frames_v[list(key)]  # (K, S, H, W, 3)
        s = unit.shape[1]
        flat = unit.reshape(-1, *unit.shape[2:])
        xs, decoded, layers = serve.capture(detector, conv_impl, flat, img)
        judged = compare.judge_layers(
            defs, raw, img, flat, xs, layers,
            [f * s + j for f in pos for j in range(s)], int8)
        out[key] = compare.Capture(decoded={
            f: decoded[f * s:(f + 1) * s].float().cpu().numpy()
            for f in pos}, **judged)
        del flat, xs, decoded, layers
    return out


def _layer_detail(defs, key: tuple, cap: compare.Capture) -> Dict:
    """A capture's readings for the detail line: the largest by kind of
    module (a conv by its activation) and the six largest modules, of the
    program and of the W8A8 control."""
    def kind(i):
        if i < 0:
            return "letterbox"
        d = defs[i]
        return (d.get("activation", "linear")
                if d["type"] == "convolutional" else d["type"])

    def summary(per):
        by_kind: Dict[str, float] = {}
        for i, v in per.items():
            by_kind[kind(i)] = compare.worst(by_kind.get(kind(i), 0.0), v)
        top = sorted(per, key=lambda i: -per[i])[:6]
        return {"by_kind": by_kind,
                "top": [[i, kind(i), per[i]] for i in top]}

    out = {"frames": list(key), "program": summary(cap.per_module)}
    if cap.int8_per_module:
        out["detector_int8"] = summary(cap.int8_per_module)
    return out


def _stage_timings(detector, reid, frames, img, w, device) -> Dict:
    """Device seconds of one detector forward on the chunk's letterboxed
    frames and of one embed of the chunk's crop batch (its most common
    bucket), each the median of a few calls."""
    from yolo_deepsort_tpu_torch.ops.letterbox_kernel import (
        letterbox_batch_fused)

    k, s = frames.shape[0], frames.shape[1]
    dtype = next(detector.parameters()).dtype
    with torch.no_grad():
        xs = letterbox_batch_fused(frames.reshape(k * s, *frames.shape[2:]),
                                   img, out_dtype=dtype)
        det_s = _median_call_s(lambda: detector(xs), device)
        del xs
        bucket = Counter(w.buckets).most_common(1)[0][0]
        crops = torch.randn((bucket * k * s, 128, 64, 3), device=device,
                            generator=load.generator(0, 9, device)
                            ).to(dtype)
        reid_s = _median_call_s(lambda: reid(crops), device)
    return {"detector_forward_s": det_s, "reid_embed_s": reid_s,
            "reid_batch": bucket * k * s, "frames_per_chunk": k * s}
