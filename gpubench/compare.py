"""The comparison that decides ``correct``: what the timed path produced in
sampled chunks (or K=1 steps), against the plain reference on the same
inputs. Each stage is judged on its own, on what the stage before it
handed it, so a discrete choice upstream (which of two candidates a
bf16 objectness ranks first) does not pass for an error downstream:

* detector: the decoded rows the detect stage handed its NMS, of every
  stream in the first frame of the sample and in one more drawn from the
  seed (the frames of a chunk may all differ), against the reference's
  float32 forward on the same frames, in the head's own terms: every
  anchor's box offsets (the inverse of the decode: tx, ty, tw, th),
  objectness logit and class logits. ``det_cos``: the largest, over frames
  and over those three groups, of 1 - cosine between the program's values
  and the reference's over all anchors (as ``feat_cos`` for the features:
  rounding moves it by its square, a wrong value by its whole). It judges
  the whole forward at once, so every layer's rounding is compounded
  through the net: on a deep random detector bf16 alone moves the heads as
  far from float32 as W8A8 does (yolov4-608), and no limit can hold such a
  net to its precision.
  ``det_layer_cos``: the same judged one module at a time. After the
  window the program's own detector runs once more, eagerly, on the
  sampled units' frames (the serving steps' letterbox, the step's conv
  route), with every module's output captured; each module's output is
  compared with ``reference.darknet.module`` applied in float32 to the
  program's own inputs of that module, and the program's letterbox with
  the reference's of the frames: the largest 1 - cosine over streams and
  modules (letterbox, conv, shortcut, route, max-pool, upsample; a [yolo]
  module's decoded rows in the head's terms as ``det_cos``, against the
  reference's decode of the program's head). Each layer's rounding is
  judged once, so the sound reading does not grow with depth, and a
  shifted letterbox, a wrong activation, a lost shortcut, swapped route
  parts, a head's lost ``scale_x_y`` or a layer at a lower precision each
  read far above it.
  ``det_replay``: the share of sampled stream frames whose decoded rows,
  as the timed step handed them to its NMS, differ bit for bit from the
  captured forward's: the capture is of what the timed path computed.
  ``frame_copies``: the share of those second frames, of another variant
  than the first, whose decoded rows equal the first frame's bit for bit
  (the frames differ by sensor noise, too little for ``det_cos`` to tell
  one from the other: a step that copied one frame's work to the others
  would show here).
* NMS: in those frames, the reference's NMS run on the program's decoded
  rows with the run's thresholds, against the detections the tracker was
  handed, in rank order. ``nms_miss``: rows missing on one side,
  or with a corner more than 0.05 frame pixels or a confidence more than
  1e-6 away, over the reference's rows.
* embed: in those frames, ``feat_cos``, the largest 1 - cosine between
  the program's ReID feature of a detection and the reference's crop +
  embed of the same box in the same frame.
* tracker: a reference DeepSORT starts from the program's own tracker
  state before the sample and steps through its frames on the program's
  detections and features. ``track_rows``: emitted rows (by track id)
  present on one side only or with a corner more than one pixel apart
  (boxes are truncated to whole pixels, so float rounding moves one by
  one), over the reference's rows; ``state_miss``: tracks whose id,
  lifecycle state, hits, age, time since update or gallery differ after
  the sample, or a differing next id, over the reference's tracks;
  ``kalman_px``: the largest gap of a common track's box (tlwh of its
  Kalman mean) after the sample.

Each number has its limit in ``limits/<cell>.json``; ``det_cos`` alone may
have none (null) in a cell where no control separates it and
``det_layer_cos`` does."""

from __future__ import annotations

import dataclasses
import functools
import traceback
from typing import Dict, List, Sequence

import numpy as np
import torch

from .reference import darknet as ref_darknet
from .reference import nms as ref_nms
from .reference import reid as ref_reid
from .reference.tracker import Tracker

NUMBERS = ("det_cos", "det_layer_cos", "det_replay", "frame_copies",
           "nms_miss", "feat_cos", "track_rows", "state_miss", "kalman_px")
CLIP = 1e-6  # sigmoid outputs within this of 0 or 1 are saturated
NMS_BOX_PX = 0.05
NMS_CONF = 1e-6


@dataclasses.dataclass
class Sample:
    """One sampled chunk (K frames) or K=1 step (K = 1) of the program:
    its tracker state before and after (per-field numpy arrays, stream
    axis first), its emitted rows (K, S, T, 5) and mask (K, S, T), the
    variant each of its frames serves, the decoded rows of every stream
    (S, B, 5 + C) in some of its frames (by position) with the NMS
    thresholds (S,), and each frame's tracker inputs (tlwh (S, D, 4),
    confidence (S, D), features (S, D, F), mask (S, D))."""

    pre: Dict[str, np.ndarray]
    post: Dict[str, np.ndarray]
    outputs: np.ndarray
    emit: np.ndarray
    frame_ids: List[int]
    decoded: Dict[int, np.ndarray]
    nms_conf: np.ndarray
    inputs: List[tuple]


@dataclasses.dataclass
class Reference:
    """What the reference needs of a run: the detector's defs and raw
    params, the ReID state dict, the frames (V, S, H, W, 3), and the
    geometry."""

    defs: list
    raw: Dict
    reid_sd: Dict
    frames: torch.Tensor
    img_size: int
    det: Dict        # nms_thres, max_boxes, max_dets
    tracker: Dict    # the configuration's tracker section


def head_grids(defs, img_size: int) -> Dict[int, np.ndarray]:
    """[yolo] module -> (A*G*G, 7) per anchor of its decoded rows: grid x,
    grid y, stride, anchor w, anchor h (input pixels), scale_x_y, and its
    offset."""
    hout = {c["index"]: c["hout"]
            for c in ref_darknet.conv_shapes(defs, img_size)}
    grids = {}
    for idx, anchors, _, sxy in ref_darknet.yolo_heads(defs):
        g = hout[idx - 1]
        gy, gx = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
        cells = np.stack([gx.ravel(), gy.ravel()], 1).astype(float)
        rows = []
        for aw, ah in anchors:  # anchor-major, then rows, then columns
            rest = [img_size / g, aw, ah, sxy, 0.5 * (sxy - 1.0)]
            rows.append(np.concatenate([cells, np.tile(rest, (g * g, 1))],
                                       1))
        grids[idx] = np.concatenate(rows)
    return grids


def head_grid(defs, img_size: int) -> np.ndarray:
    """(B, 7): ``head_grids`` of every head, in the decoded rows' order."""
    return np.concatenate(list(head_grids(defs, img_size).values()))


def head_logits(decoded: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """Decoded rows (N, B, 5 + C) -> what the heads computed, (N, B, 5 + C)
    float64: tx, ty (inverse sigmoid of the centre's offset in its cell),
    tw, th (log of the size over the anchor's), and the objectness and
    class logits."""
    d = decoded.astype(np.float64)
    gx, gy, stride, aw, ah, sxy, off = grid.T

    def logit(p):
        p = np.clip(p, CLIP, 1.0 - CLIP)
        return np.log(p / (1.0 - p))

    out = np.empty_like(d)
    out[..., 0] = logit((d[..., 0] / stride - gx + off) / sxy)
    out[..., 1] = logit((d[..., 1] / stride - gy + off) / sxy)
    out[..., 2] = np.log(np.maximum(d[..., 2], 1e-30) / aw)
    out[..., 3] = np.log(np.maximum(d[..., 3], 1e-30) / ah)
    out[..., 4:] = logit(d[..., 4:])
    return out


def worst(a: float, b: float) -> float:
    """The larger of two gaps; a gap that is not a number is infinite (a
    plain ``max`` would keep the other one)."""
    return max(float("inf") if v != v else v for v in (a, b))


def head_gap(prog: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Head values (N, B, 5 + C) of two sides -> (N,): of each image the
    largest, over box offsets, objectness and classes, of 1 - cosine
    between the two over all anchors."""
    worst = np.zeros(len(prog))
    for cols in (slice(0, 4), slice(4, 5), slice(5, None)):
        a = prog[:, :, cols].reshape(len(prog), -1)
        b = ref[:, :, cols].reshape(len(prog), -1)
        cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                                * np.linalg.norm(b, axis=1))
        worst = np.maximum(worst, 1.0 - cos)
    return worst


def cos_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, ...) twice -> (N,) float64: 1 - cosine of each image's values,
    as half the squared distance of the unit vectors (no cancellation near
    1); 0 where both are zero, 1 where one is."""
    a = a.reshape(len(a), -1).double()
    b = b.reshape(len(b), -1).double()
    na, nb = a.norm(dim=1, keepdim=True), b.norm(dim=1, keepdim=True)
    gap = 0.5 * ((a / na.clamp_min(1e-300) - b / nb.clamp_min(1e-300)) ** 2
                 ).sum(1)
    both = (na[:, 0] == 0) & (nb[:, 0] == 0)
    return torch.where(both, torch.zeros_like(gap), gap)


@dataclasses.dataclass
class Capture:
    """The layer-wise judge of one sampled unit: of each module the largest
    1 - cosine over streams (``judge_layers``; the largest over modules is
    ``det_layer_cos``), the same for the reference's W8A8 rounding in the
    program's place (the detector's control; empty unless asked for), and
    the captured forward's decoded rows (S, B, 5 + C) at the unit's sampled
    frame positions."""

    per_module: Dict[int, float]
    int8_per_module: Dict[int, float]
    decoded: Dict[int, np.ndarray]

    @property
    def layer_cos(self) -> float:
        return functools.reduce(worst, self.per_module.values())


@torch.no_grad()
def judge_layers(defs, params: Dict[int, Dict], img_size: int,
                 frames: torch.Tensor, x: torch.Tensor, layers: List,
                 rows: Sequence[int], int8: bool = False) -> Dict:
    """Walk the program's capture of one forward: ``x`` (N, S, S, 3) its
    letterbox of ``frames`` (N, H, W, 3), ``layers`` every module's output
    (NHWC maps, a [yolo] module's decoded rows), as
    ``Darknet.forward(x, capture_all_layers=True)`` returns them. The
    letterbox (module -1) is judged against the reference's of the frames,
    each module's output against ``reference.darknet.module`` in float32
    on the program's own inputs of that module, at the batch rows
    ``rows``; an output is dropped from ``layers`` once its last reader is
    judged. -> {"per_module": {module: largest 1 - cosine over the rows},
    "int8_per_module": the same of the reference's W8A8 rounding in the
    program's place (``int8``)}."""
    rows = torch.as_tensor(list(rows), device=x.device)
    last = {j: i for i in range(len(defs))  # the last reader of each output
            for j in ref_darknet.sources(defs, i)}
    grids = head_grids(defs, img_size)

    def nchw(j):
        t = x if j < 0 else layers[j]
        return t.index_select(0, rows).permute(0, 3, 1, 2).float()

    per, per8 = {}, {}
    with ref_darknet.f32_exact():
        per[-1] = float(cos_gap(nchw(-1), ref_darknet.letterbox(
            frames.index_select(0, rows), img_size)).max())
        for i, d in enumerate(defs):
            srcs = ref_darknet.sources(defs, i)
            ins = [nchw(j) for j in srcs]
            want = ref_darknet.module(defs, params, i, ins, img_size)
            if d["type"] == "yolo":
                got = layers[i].index_select(0, rows)
                per[i] = float(head_gap(
                    head_logits(got.float().cpu().numpy(), grids[i]),
                    head_logits(want.cpu().numpy(), grids[i])).max())
            else:
                got = layers[i].index_select(0, rows).permute(0, 3, 1, 2)
                per[i] = float(cos_gap(got, want).max())
                if int8 and d["type"] == "convolutional":
                    per8[i] = float(cos_gap(ref_darknet.module(
                        defs, params, i, ins, img_size, int8=True),
                        want).max())
            del ins, want, got
            for j in srcs + [i]:
                if last.get(j, -2) <= i and j >= 0:
                    layers[j] = None
    return {"per_module": per, "int8_per_module": per8}


def bf16_round(a: np.ndarray) -> np.ndarray:
    """The tracker's control: float64 values rounded to bfloat16."""
    return torch.from_numpy(a).to(torch.bfloat16).double().numpy()


def stream_slice(state: Dict[str, np.ndarray], s: int) -> Dict:
    return {k: v[s] for k, v in state.items()}


class Tally:
    """Counts and largest gaps of the numbers compared."""

    def __init__(self):
        self.n = {k: 0.0 for k in ("copies", "pairs", "replay_bad",
                                   "replay_frames", "nms_bad", "nms_ref",
                                   "rows_bad", "rows_ref", "state_bad",
                                   "state_ref")}
        self.gap = {"det_cos": 0.0, "det_layer_cos": 0.0, "feat_cos": 0.0,
                    "kalman_px": 0.0}
        self.error = None

    def merge(self, other: "Tally") -> None:
        for k, v in other.n.items():
            self.n[k] += v
        for k, v in other.gap.items():
            self.gap[k] = worst(self.gap[k], v)
        self.error = self.error or other.error

    def numbers(self) -> Dict[str, float]:
        if self.error:
            return {k: float("inf") for k in NUMBERS}
        n = self.n
        return {
            "det_cos": self.gap["det_cos"],
            "det_layer_cos": self.gap["det_layer_cos"],
            "det_replay": n["replay_bad"] / max(n["replay_frames"], 1.0),
            "frame_copies": n["copies"] / max(n["pairs"], 1.0),
            "nms_miss": n["nms_bad"] / max(n["nms_ref"], 1.0),
            "feat_cos": self.gap["feat_cos"],
            "track_rows": n["rows_bad"] / max(n["rows_ref"], 1.0),
            "state_miss": n["state_bad"] / max(n["state_ref"], 1.0),
            "kalman_px": self.gap["kalman_px"],
        }


class Judge:
    """Runs the reference once per distinct input and accumulates the
    numbers over every sample. ``captures``: the layer-wise judge of the
    program's capture of each sampled unit, by the unit's frame ids
    (``judge_layers``). ``tracker_round`` rounds the reference tracker's
    state (the tracker's control)."""

    def __init__(self, ref: Reference, frame_hw,
                 captures: Dict[tuple, Capture], tracker_round=None):
        self.ref = ref
        self.hw = tuple(frame_hw)
        self.captures = captures
        self.tracker_round = tracker_round
        self.grid = head_grid(ref.defs, ref.img_size)
        self._logits: Dict[int, np.ndarray] = {}
        self._feats: Dict[tuple, np.ndarray] = {}
        self._nms: Dict[tuple, np.ndarray] = {}
        self.total = Tally()
        self.tally = self.total

    def judge(self, smp: Sample) -> Dict[str, float]:
        """Judge one sample; -> its own numbers (the run's totals also
        take them in)."""
        self.tally = Tally()
        try:
            self._judge(smp)
        except (ValueError, np.linalg.LinAlgError) as e:
            # outputs the reference cannot follow (a NaN state) are wrong
            # outputs
            where = traceback.extract_tb(e.__traceback__)[-1]
            self.tally.error = (f"{type(e).__name__}: {e} "
                                f"({where.name}:{where.lineno})")
        finally:
            self.total.merge(self.tally)
        return self.tally.numbers()

    def numbers(self) -> Dict[str, float]:
        return self.total.numbers()

    def _judge(self, smp: Sample) -> None:
        k, s_n = smp.outputs.shape[:2]
        if len(smp.inputs) != k:
            raise ValueError(f"the tracker entry was seen {len(smp.inputs)}"
                             f" times in a sample of {k} frames")
        self._judge_detector(smp)
        for s in range(s_n):
            trk = Tracker.from_arrays(self.ref.tracker, self.hw,
                                      stream_slice(smp.pre, s),
                                      self.tracker_round)
            for f, (tlwh, conf, feat, mask) in enumerate(smp.inputs):
                m = mask[s]
                t32 = tlwh[s][m].astype(np.float32)
                xyxy = np.concatenate([t32[:, :2], t32[:, :2] + t32[:, 2:]],
                                      1).astype(np.float64)
                if f in smp.decoded:
                    self._judge_nms(self._nms_of(smp, f, s), xyxy,
                                    conf[s][m])
                    self._judge_feats(smp.frame_ids[f], s, xyxy, feat[s][m])
                want = trk.step(t32.astype(np.float64), conf[s][m],
                                feat[s][m].astype(np.float64))
                got = {int(r[4]): tuple(int(v) for v in r[:4])
                       for r in smp.outputs[f, s][smp.emit[f, s]]}
                self._judge_rows(got, want)
            self._judge_state(trk, stream_slice(smp.post, s))

    def _judge_detector(self, smp: Sample) -> None:
        g, n = self.tally.gap, self.tally.n
        cap = self.captures.get(tuple(smp.frame_ids))
        if cap is None:
            raise ValueError(f"no capture of the frames {smp.frame_ids}")
        g["det_layer_cos"] = worst(g["det_layer_cos"], cap.layer_cos)
        for f, decoded in smp.decoded.items():
            g["det_cos"] = worst(g["det_cos"], self.det_cos(
                decoded, smp.frame_ids[f]))
            for timed, eager in zip(decoded, cap.decoded[f]):
                n["replay_frames"] += 1
                n["replay_bad"] += float(timed.tobytes() != eager.tobytes())
            if f and smp.frame_ids[f] != smp.frame_ids[0]:
                n["pairs"] += 1
                n["copies"] += float(np.array_equal(decoded,
                                                    smp.decoded[0]))

    def _forward(self, v: int, int8: bool = False) -> np.ndarray:
        ref = self.ref
        with ref_darknet.f32_exact(), torch.no_grad():
            return ref_darknet.forward(
                ref.defs, ref.raw, ref_darknet.letterbox(ref.frames[v],
                                                         ref.img_size),
                ref.img_size, int8=int8).cpu().numpy()

    def det_cos(self, decoded: np.ndarray, v: int) -> float:
        """1 - cosine against the reference's head values on variant v's
        frames, the largest over streams and over box offsets,
        objectness, classes."""
        if v not in self._logits:
            self._logits[v] = head_logits(self._forward(v), self.grid)
        return float(head_gap(head_logits(decoded, self.grid),
                              self._logits[v]).max())

    def int8_det_cos(self) -> float:
        """The detector's control: ``det_cos`` of the reference itself
        computed with W8A8 rounding on every conv, in the program's
        place, on the first variant's frames."""
        return self.det_cos(self._forward(0, int8=True), 0)

    def _nms_of(self, smp: Sample, f: int, s: int) -> np.ndarray:
        """The reference's NMS of the program's decoded rows of stream s
        in frame f: rows (x1, y1, x2, y2 in frame pixels, class score)."""
        rows = smp.decoded[f][s]
        key = (rows.tobytes(), float(smp.nms_conf[s]))
        if key not in self._nms:
            d = self.ref.det
            rows = ref_nms.nms_image(rows, float(smp.nms_conf[s]),
                                     d["nms_thres"], d["max_boxes"],
                                     d["max_dets"])
            self._nms[key] = np.concatenate([ref_nms.to_frame(
                rows[:, :4], self.ref.img_size, self.hw), rows[:, 5:6]], 1)
        return self._nms[key]

    def _judge_nms(self, want: np.ndarray, xyxy: np.ndarray,
                   conf: np.ndarray) -> None:
        n = min(len(want), len(xyxy))
        bad = abs(len(want) - len(xyxy))
        if n:
            far = ((np.abs(want[:n, :4] - xyxy[:n]).max(1) > NMS_BOX_PX)
                   | (np.abs(want[:n, 4] - conf[:n]) > NMS_CONF))
            bad += int(far.sum())
        self.tally.n["nms_bad"] += bad
        self.tally.n["nms_ref"] += len(want)

    def features(self, v: int, s: int, frame_xyxy: np.ndarray
                 ) -> np.ndarray:
        key = (v, s, frame_xyxy.tobytes())
        if key not in self._feats:
            boxes = torch.as_tensor(frame_xyxy, dtype=torch.float64,
                                    device=self.ref.frames.device)
            with ref_darknet.f32_exact(), torch.no_grad():
                x = ref_reid.crops(self.ref.frames[v, s], boxes)
                f = ref_reid.embed(self.ref.reid_sd, x)
            self._feats[key] = f.double().cpu().numpy()
        return self._feats[key]

    def _judge_feats(self, v: int, s: int, xyxy: np.ndarray,
                     feat: np.ndarray):
        if len(feat):
            want = self.features(v, s, xyxy)
            cos = (want * feat).sum(1) / (np.linalg.norm(want, axis=1)
                                          * np.linalg.norm(feat, axis=1))
            g = self.tally.gap
            g["feat_cos"] = worst(g["feat_cos"], float((1.0 - cos).max()))

    def _judge_rows(self, got: Dict, want: Dict) -> None:
        bad = len(set(got) ^ set(want))
        for tid in set(got) & set(want):
            if max(abs(a - b) for a, b in zip(got[tid], want[tid])) > 1:
                bad += 1
        self.tally.n["rows_bad"] += bad
        self.tally.n["rows_ref"] += len(want)

    def _judge_state(self, trk: Tracker, post: Dict) -> None:
        prog = Tracker.from_arrays(self.ref.tracker, self.hw, post)
        mine = {t.track_id: t for t in trk.tracks}
        theirs = {t.track_id: t for t in prog.tracks}
        bad = len(set(mine) ^ set(theirs)) + int(trk.next_id != prog.next_id)
        g = self.tally.gap
        for tid in set(mine) & set(theirs):
            a, b = mine[tid], theirs[tid]
            ga, gb = trk.gallery(a), prog.gallery(b)
            # the gallery holds the program's own features on both sides
            if ((a.state, a.hits, a.age, a.tsu, ga.shape)
                    != (b.state, b.hits, b.age, b.tsu, gb.shape)
                    or (ga != gb).any()):
                bad += 1
            g["kalman_px"] = worst(g["kalman_px"], _box_gap(a.tlwh(),
                                                            b.tlwh()))
        self.tally.n["state_bad"] += bad
        self.tally.n["state_ref"] += len(mine)


def _box_gap(a: np.ndarray, b: np.ndarray) -> float:
    """The largest gap between two boxes; infinite where one side is not
    finite and the other is (a track born of a detection of no height
    holds an infinite aspect on both sides)."""
    fa, fb = np.isfinite(a), np.isfinite(b)
    if (fa != fb).any():
        return float("inf")
    return float(np.abs(a[fa] - b[fa]).max(initial=0.0))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """-> (every number within its limit, {name: {"value", "limit"}} of
    the numbers compared). A limit of None leaves its number uncompared in
    that cell: only ``det_cos``, where no control separates it and
    ``det_layer_cos`` does (a deep random detector's whole forward)."""
    checks = {k: {"value": numbers[k], "limit": limits[k]}
              for k in sorted(numbers) if limits[k] is not None}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
