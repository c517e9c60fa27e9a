"""Plain DeepSORT tracker (nwojke/deep_sort ``deep_sort/sort/*`` and the
``deep_sort_pytorch`` facade's output rule), float64 numpy, one stream.

The Kalman filter, the gated cosine matching cascade, the IoU matching of
tentative and just-missed tracks, the per-track feature gallery with its
budget and the track lifecycle follow the original code; the Hungarian
solves are scipy's. One departure: tracks born in the same frame take
their ids in the order of their detections (the original numbers them in
the order its matching left them unmatched, an artefact of its lists).
A tracker can start from a snapshot of any tracker's
state (``from_arrays``: per-slot arrays, the gallery as a ring), so a
run can be followed a few frames at a time from where it stood.

Detections of no height (candidates in the letterbox's padding, clipped
to the frame) are defined here, where the original divides by zero: such
a box has the aspect 0, and a pair is admissible to a match only where
its cost is within the limit (``not cost <= limit``, which the original's
``cost > limit`` equals on every number), so no cost that is not a number
reaches the Kalman state."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import scipy.linalg
from scipy.optimize import linear_sum_assignment

INFTY_COST = 1e5
CHI2INV95_4 = 9.4877
TENTATIVE, CONFIRMED = 1, 2


class Kalman:
    """deep_sort/sort/kalman_filter.py: state (cx, cy, a, h, velocities)."""

    def __init__(self):
        self.F = np.eye(8)
        self.F[:4, 4:] = np.eye(4)
        self.H = np.eye(4, 8)
        self.wp, self.wv = 1.0 / 20, 1.0 / 160

    def initiate(self, z):
        h = z[3]
        std = [2 * self.wp * h, 2 * self.wp * h, 1e-2, 2 * self.wp * h,
               10 * self.wv * h, 10 * self.wv * h, 1e-5, 10 * self.wv * h]
        return np.r_[z, np.zeros(4)], np.diag(np.square(std))

    def predict(self, mean, cov):
        # F @ mean and H @ mean written out, term by term: the same on
        # every number, and an infinite aspect stays in its own term
        h = mean[3]
        std = [self.wp * h, self.wp * h, 1e-2, self.wp * h,
               self.wv * h, self.wv * h, 1e-5, self.wv * h]
        return (np.r_[mean[:4] + mean[4:], mean[4:]],
                self.F @ cov @ self.F.T + np.diag(np.square(std)))

    def project(self, mean, cov):
        h = mean[3]
        std = [self.wp * h, self.wp * h, 1e-1, self.wp * h]
        return mean[:4], self.H @ cov @ self.H.T + np.diag(np.square(std))

    def update(self, mean, cov, z):
        pm, pc = self.project(mean, cov)
        chol = scipy.linalg.cho_factor(pc, lower=True, check_finite=False)
        gain = scipy.linalg.cho_solve(chol, (cov @ self.H.T).T,
                                      check_finite=False).T
        return mean + (z - pm) @ gain.T, cov - gain @ pc @ gain.T

    def gating_distance(self, mean, cov, zs):
        pm, pc = self.project(mean, cov)
        d = scipy.linalg.solve_triangular(np.linalg.cholesky(pc), (zs - pm).T,
                                          lower=True, check_finite=False)
        return np.sum(d * d, axis=0)


def tlwh_to_xyah(tlwh):
    """A box of no height has the aspect 0 (the original divides by its
    height)."""
    r = np.array(tlwh, np.float64)
    r[:2] += r[2:] / 2
    r[2] = r[2] / r[3] if r[3] > 0 else 0.0
    return r


class Track:
    def __init__(self, mean, cov, track_id, state=TENTATIVE, hits=1, age=1,
                 tsu=0, features=None):
        self.mean, self.cov, self.track_id = mean, cov, track_id
        self.state, self.hits, self.age, self.tsu = state, hits, age, tsu
        self.features: List[np.ndarray] = list(
            features if features is not None else [])

    def tlwh(self):
        r = self.mean[:4].copy()
        r[2] *= r[3]
        r[:2] -= r[2:] / 2
        return r


def _min_cost_matching(cost_fn, max_distance, tracks, track_idx, det_idx):
    if not len(track_idx) or not len(det_idx):
        return [], list(track_idx), list(det_idx)
    cost = cost_fn(tracks, track_idx, det_idx)
    cost[~(cost <= max_distance)] = max_distance + 1e-5
    rows, cols = linear_sum_assignment(cost)
    matches, um_t, um_d = [], [], []
    for c, d in enumerate(det_idx):
        if c not in cols:
            um_d.append(d)
    for r, t in enumerate(track_idx):
        if r not in rows:
            um_t.append(t)
    for r, c in zip(rows, cols):
        if cost[r, c] > max_distance:
            um_t.append(track_idx[r])
            um_d.append(det_idx[c])
        else:
            matches.append((track_idx[r], det_idx[c]))
    return matches, um_t, um_d


class Tracker:
    """deep_sort/sort/tracker.py with nn_matching's cosine gallery."""

    def __init__(self, cfg: Dict, img_hw, round_state=None):
        self.max_dist = cfg["max_dist"]
        self.min_confidence = cfg["min_confidence"]
        self.max_iou_distance = cfg["max_iou_distance"]
        self.max_age = cfg["max_age"]
        self.n_init = cfg["n_init"]
        self.budget = cfg["nn_budget"]
        self.img_hw = img_hw
        self.kf = Kalman()
        # applied to every Kalman mean and covariance it computes: the
        # identity here, a lower precision in the control
        self.round = round_state or (lambda a: a)
        self.tracks: List[Track] = []
        self.samples: Dict[int, np.ndarray] = {}  # (n, F), oldest first
        self.next_id = 1

    @classmethod
    def from_arrays(cls, cfg, img_hw, a: Dict[str, np.ndarray],
                    round_state=None):
        """A tracker in the state of one stream's snapshot: per slot
        "mean" (T, 8), "cov" (T, 8, 8), "track_id", "state" (0 free, 1
        tentative, 2 confirmed), "hits", "age", "tsu", the gallery (T, B,
        F) with "head" (next write) and "count", and the scalar "next_id".
        Tracks are ordered by id (the order of their creation)."""
        tr = cls(cfg, img_hw, round_state)
        tr.next_id = int(a["next_id"])
        b = a["gallery"].shape[1]
        for slot in np.argsort(a["track_id"], kind="stable"):
            if a["state"][slot] == 0:
                continue
            n, head = int(a["count"][slot]), int(a["head"][slot])
            order = range(n) if n < b else [(head + j) % b for j in range(b)]
            feats = a["gallery"][slot, list(order)].astype(np.float64)
            t = Track(a["mean"][slot].astype(np.float64),
                      a["cov"][slot].astype(np.float64),
                      int(a["track_id"][slot]), int(a["state"][slot]),
                      int(a["hits"][slot]), int(a["age"][slot]),
                      int(a["tsu"][slot]))
            if t.state == CONFIRMED:
                tr.samples[t.track_id] = feats
            else:
                t.features = list(feats)
            tr.tracks.append(t)
        return tr

    def gallery(self, track: Track) -> np.ndarray:
        """The track's features (n, F), oldest first."""
        if track.state == CONFIRMED:
            return self.samples.get(track.track_id, np.zeros((0, 0)))
        return np.array(track.features)

    def step(self, tlwh: np.ndarray, conf: np.ndarray, feats: np.ndarray):
        """One frame: detections (D, 4) tlwh, (D,) confidence, (D, F) unit
        features. -> emitted rows {id: (x1, y1, x2, y2)} of confirmed
        tracks updated this frame or the one before."""
        keep = np.asarray(conf) > self.min_confidence
        tlwh = np.asarray(tlwh, np.float64)[keep]
        feats = np.asarray(feats, np.float64)[keep]
        xyah = np.array([tlwh_to_xyah(t) for t in tlwh]).reshape(-1, 4)
        for t in self.tracks:
            t.mean, t.cov = map(self.round, self.kf.predict(t.mean, t.cov))
            t.age += 1
            t.tsu += 1
        matches, um_tracks, um_dets = self._match(tlwh, xyah, feats)
        for ti, di in matches:
            t = self.tracks[ti]
            t.mean, t.cov = map(self.round,
                                self.kf.update(t.mean, t.cov, xyah[di]))
            t.features.append(feats[di])
            t.hits += 1
            t.tsu = 0
            if t.state == TENTATIVE and t.hits >= self.n_init:
                t.state = CONFIRMED
        dead = set()
        for ti in um_tracks:
            t = self.tracks[ti]
            if t.state == TENTATIVE or t.tsu > self.max_age:
                dead.add(ti)
        for di in sorted(um_dets):  # ids in detection order
            mean, cov = map(self.round, self.kf.initiate(xyah[di]))
            self.tracks.append(Track(mean, cov, self.next_id,
                                     features=[feats[di]]))
            self.next_id += 1
        self.tracks = [t for i, t in enumerate(self.tracks) if i not in dead]
        active = {t.track_id for t in self.tracks if t.state == CONFIRMED}
        for t in self.tracks:
            if t.state == CONFIRMED and t.features:
                old = self.samples.get(t.track_id)
                g = np.array(t.features) if old is None else np.concatenate(
                    [old, t.features])
                self.samples[t.track_id] = g[-self.budget:]
                t.features = []
        self.samples = {k: v for k, v in self.samples.items() if k in active}
        for t in self.tracks:  # a tentative gallery, as a ring holds it
            t.features = t.features[-self.budget:]
        return self.rows()

    def rows(self) -> Dict[int, tuple]:
        h, w = self.img_hw
        out = {}
        for t in self.tracks:
            if t.state != CONFIRMED or t.tsu > 1:
                continue
            x, y, bw, bh = t.tlwh()
            out[t.track_id] = (max(int(x), 0), max(int(y), 0),
                               min(int(x + bw), w - 1),
                               min(int(y + bh), h - 1))
        return out

    def _match(self, tlwh, xyah, feats):
        def gated_cosine(tracks, t_idx, d_idx):
            f = feats[d_idx]
            cost = np.zeros((len(t_idx), len(d_idx)))
            for r, ti in enumerate(t_idx):
                g = self.samples[tracks[ti].track_id]
                cost[r] = (1.0 - g @ f.T).min(0)
                gd = self.kf.gating_distance(tracks[ti].mean, tracks[ti].cov,
                                             xyah[d_idx])
                cost[r, ~(gd <= CHI2INV95_4)] = INFTY_COST
            return cost

        def iou_cost(tracks, t_idx, d_idx):
            cost = np.zeros((len(t_idx), len(d_idx)))
            cand = tlwh[d_idx]
            for r, ti in enumerate(t_idx):
                if tracks[ti].tsu > 1:
                    cost[r] = INFTY_COST
                    continue
                b = tracks[ti].tlwh()
                tl = np.maximum(b[:2], cand[:, :2])
                br = np.minimum(b[:2] + b[2:], cand[:, :2] + cand[:, 2:])
                inter = np.prod(np.maximum(0.0, br - tl), axis=1)
                union = b[2:].prod() + cand[:, 2:].prod(1) - inter
                iou = np.divide(inter, union, out=np.zeros_like(inter),
                                where=union > 0)  # zero-area pairs: 0
                cost[r] = 1.0 - iou
            return cost

        confirmed = [i for i, t in enumerate(self.tracks)
                     if t.state == CONFIRMED]
        unconfirmed = [i for i, t in enumerate(self.tracks)
                       if t.state != CONFIRMED]
        um_dets = list(range(len(tlwh)))
        matches_a = []
        for level in range(self.max_age):  # the matching cascade
            if not um_dets:
                break
            level_idx = [k for k in confirmed
                         if self.tracks[k].tsu == 1 + level]
            if not level_idx:
                continue
            m, _, um_dets = _min_cost_matching(gated_cosine, self.max_dist,
                                               self.tracks, level_idx,
                                               um_dets)
            matches_a += m
        um_a = list(set(confirmed) - {k for k, _ in matches_a})
        iou_cand = unconfirmed + [k for k in um_a if self.tracks[k].tsu == 1]
        um_a = [k for k in um_a if self.tracks[k].tsu != 1]
        matches_b, um_b, um_dets = _min_cost_matching(
            iou_cost, self.max_iou_distance, self.tracks, iou_cand, um_dets)
        return matches_a + matches_b, list(set(um_a + um_b)), um_dets
