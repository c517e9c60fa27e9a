"""The tracker fuzz (the reference's 34-seed campaign: randomized 5-object
30-frame scenes with 12% detector dropout) over the port's tracker against
the numpy DeepSORT oracle (``specs/tracker_np.py`` ``DeepSortLogic``),
frame by frame, up to a consistent relabeling of ids (``compare``).

On the CPU: 8 seeds through ``tracker_step`` (the plain version of both
kernels). Marked ``gpu``: all 34 seeds through kernel 3
(``tracker_step_fused_batched``) and kernel 5 (``tracker_step``) on the
card. This file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -q -m gpu tests/test_torch_port_fuzz.py

``make_scenario``, ``run_oracle`` and ``compare`` are copies of
``tests/test_tracker.py``'s (which imports jax), held equal to them by
``test_scenario_and_compare_are_the_reference_suites``.
"""

import numpy as np
import pytest
import torch

from specs.tracker_np import DeepSortLogic
from yolo_deepsort_tpu_torch.config import TrackerConfig
from yolo_deepsort_tpu_torch.tracking.tracker import (
    init_tracker_state,
    tracker_step,
)
from yolo_deepsort_tpu_torch.tracking.tracker_kernel import (
    tracker_step_fused_batched,
)
from torch_port_threads import torch_threads  # noqa: F401

IMG_HW = (720, 1280)
FEAT_DIM = 32
CFG = TrackerConfig(max_tracks=32, max_dets=16, feat_dim=FEAT_DIM,
                    nn_budget=20)
FUZZ = dict(n_objects=5, n_frames=30, dropout=0.12)
CPU_SEEDS, CARD_SEEDS = range(8), range(34)


def make_scenario(seed, n_objects=4, n_frames=25, dropout=0.08):
    """Objects with constant velocity + jitter; unit appearance vectors with
    noise; randomized visibility windows. Returns per-frame (xywh, conf, feat)."""
    rng = np.random.default_rng(seed)
    base_feat = rng.normal(size=(n_objects, FEAT_DIM))
    base_feat /= np.linalg.norm(base_feat, axis=1, keepdims=True)
    pos = rng.uniform([100, 100], [900, 500], (n_objects, 2))
    vel = rng.uniform(-8, 8, (n_objects, 2))
    size = rng.uniform([30, 60], [60, 120], (n_objects, 2))
    t_in = rng.integers(0, 5, n_objects)
    t_out = rng.integers(n_frames - 5, n_frames + 10, n_objects)

    frames = []
    for t in range(n_frames):
        rows, confs, feats = [], [], []
        for k in range(n_objects):
            if not (t_in[k] <= t < t_out[k]):
                continue
            if rng.uniform() < dropout:
                continue
            cx, cy = pos[k] + vel[k] * t + rng.normal(0, 1.5, 2)
            w, h = size[k] * (1 + rng.normal(0, 0.02, 2))
            f = base_feat[k] + rng.normal(0, 0.05, FEAT_DIM)
            f /= np.linalg.norm(f)
            rows.append([cx, cy, w, h])
            confs.append(float(rng.uniform(0.5, 0.95)))
            feats.append(f)
        frames.append(
            (
                np.array(rows, np.float64).reshape(-1, 4),
                confs,
                np.array(feats, np.float64).reshape(-1, FEAT_DIM),
            )
        )
    return frames


def run_oracle(frames, **kw):
    ds = DeepSortLogic(**kw)
    outs = []
    for xywh, confs, feats in frames:
        outs.append(ds.update(xywh, confs, feats, IMG_HW))
    return outs


def compare(oracle_outs, jax_outs, atol=2):
    """Frame-by-frame comparison, tolerant to a *consistent bijective
    relabeling* of track ids.

    The reference's new-track id order within a frame depends on scipy's
    unmatched-detection ordering (never-assigned dets first, threshold-dropped
    dets appended after, linear_assignment.py:~55-75); our tracker initiates
    strictly in detection-index order. Ids never feed back into matching, so
    a same-frame permutation of freshly-born ids is behaviorally irrelevant --
    but the mapping must stay consistent for the whole sequence (no identity
    switches allowed)."""
    id_map = {}
    for t, (o, j) in enumerate(zip(oracle_outs, jax_outs)):
        assert len(o) == len(j), (
            f"frame {t}: oracle emitted {len(o)} tracks, jax {len(j)}\n"
            f"oracle:\n{o}\njax:\n{j}"
        )
        if not len(o):
            continue
        # match rows by box proximity (boxes are near-identical by contract)
        used = set()
        for orow in o:
            dists = np.abs(j[:, :4] - orow[None, :4]).max(axis=1)
            dists[list(used)] = 1 << 30
            k = int(np.argmin(dists))
            assert dists[k] <= atol, (
                f"frame {t}: no jax box within {atol}px of oracle row {orow}\n"
                f"oracle:\n{o}\njax:\n{j}"
            )
            used.add(k)
            oid, jid = int(orow[4]), int(j[k, 4])
            if oid in id_map:
                assert id_map[oid] == jid, (
                    f"frame {t}: id switch -- oracle id {oid} was jax id "
                    f"{id_map[oid]}, now {jid}\noracle:\n{o}\njax:\n{j}"
                )
            else:
                assert jid not in id_map.values(), (
                    f"frame {t}: jax id {jid} mapped to two oracle ids"
                )
                id_map[oid] = jid


def run_port(frames, cfg, step, device):
    """The scene through one stream of the port's tracker (``step``:
    ``tracker_step`` or ``tracker_step_fused_batched``) on ``device``:
    per frame the emitted rows [x1, y1, x2, y2, id], ordered by id."""
    state = init_tracker_state(cfg, 1, device)
    d = cfg.max_dets
    outs = []
    for xywh, confs, feats in frames:
        n = xywh.shape[0]
        tlwh = np.zeros((1, d, 4), np.float32)
        tlwh[0, :n, 0] = xywh[:, 0] - xywh[:, 2] / 2
        tlwh[0, :n, 1] = xywh[:, 1] - xywh[:, 3] / 2
        tlwh[0, :n, 2:] = xywh[:, 2:]
        conf = np.zeros((1, d), np.float32)
        conf[0, :n] = confs
        feat = np.zeros((1, d, cfg.feat_dim), np.float32)
        feat[0, :n] = feats
        mask = np.zeros((1, d), bool)
        mask[0, :n] = True
        state, boxes, emit = step(
            cfg, state, *(torch.from_numpy(a).to(device)
                          for a in (tlwh, conf, feat, mask)), IMG_HW)
        boxes = boxes[0].cpu().numpy()[emit[0].cpu().numpy()]
        outs.append(boxes[np.argsort(boxes[:, 4])] if len(boxes) else
                    np.zeros((0, 5), np.int64))
    return outs


def test_scenario_and_compare_are_the_reference_suites():
    """The copies above are ``tests/test_tracker.py``'s, word for word, with
    its scene constants and tracker configuration."""
    import inspect

    import test_tracker

    for name in ("make_scenario", "run_oracle", "compare"):
        assert (inspect.getsource(globals()[name])
                == inspect.getsource(getattr(test_tracker, name))), name
    assert (IMG_HW, FEAT_DIM) == (test_tracker.IMG_HW, test_tracker.FEAT_DIM)
    from dataclasses import asdict

    assert asdict(CFG) == asdict(test_tracker.CFG)


@pytest.mark.parametrize("seed", CPU_SEEDS)
def test_fuzz_tracker_step_matches_oracle(seed):
    frames = make_scenario(seed, **FUZZ)
    compare(run_oracle(frames, nn_budget=CFG.nn_budget),
            run_port(frames, CFG, tracker_step, "cpu"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["k3", "k5"])
@pytest.mark.parametrize("seed", CARD_SEEDS)
def test_fuzz_kernels_match_oracle(cuda_device, seed, kernel):
    """Kernel 3 (the fused step) and kernel 5 (``tracker_step``'s two-stage
    JV) on the card, every seed of the campaign."""
    from yolo_deepsort_tpu_torch.tracking import tracker_kernel
    from yolo_deepsort_tpu_torch.ops import assignment_kernel

    module = tracker_kernel if kernel == "k3" else assignment_kernel
    counter = "launches" if kernel == "k3" else "two_stage_launches"
    before = getattr(module, counter)
    step = tracker_step_fused_batched if kernel == "k3" else tracker_step
    frames = make_scenario(seed, **FUZZ)
    got = run_port(frames, CFG, step, cuda_device)
    assert getattr(module, counter) == before + len(frames)
    compare(run_oracle(frames, nn_budget=CFG.nn_budget), got)
