"""F10's witness: the trained int8 gate's first two train steps at
yolov3-416, batch 8, on the JAX step and on the port's step, on the CPU,
from the state both gate tools build.

* JAX, as ``tools/int8_gate_trained.py`` builds it: ``random_raw_params
  (seed=0)``, ``raw_params_to_train``, ``optax.chain(clip_by_global_norm
  (5.0), adam(5e-4))``, 32 ``synth_scene``s, then one ``rng.choice`` batch
  a step.
* The port, as ``yolo_deepsort_tpu_torch/tools/int8_gate_trained.py``
  ``train_detector`` builds it (``test_torch_port_int8_gates_gpu.py``
  ``port_first_steps``, which also gives the card's reading): the same raw
  params and scenes, ``ClippedAdam``, the same draw order.

Step 0's losses agree within ``TRAINED_LOSS_RTOL``. The record, printed as
one JSON line per side, gives each step's loss, the largest objectness
logit of each step's forward (step 1's forward runs on the params after
step 0) and of the forward after step 1, and whether step 1's loss is
finite. An objectness logit above ~16.6 makes both losses non-finite
(``test_torch_port_train_yolo.py`` ``test_saturated_objectness_matches_
jax``). The JAX tool reads its loss only every 50th step; this reads every
step on both sides.

The whole witness takes minutes and ~10 GiB: ``slow`` tier
(``RUN_SLOW=1 python -m pytest -s tests/test_torch_port_f10_witness.py``).
"""

import gc
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import jax  # noqa: E402
import optax  # noqa: E402

from test_torch_port_int8_gates_gpu import (
    TRAINED_LOSS_RTOL,
    first_steps_record,
    objectness_max,
    port_first_steps,
)
from yolo_deepsort_tpu.cfg.architectures import ARCHITECTURES as J_ARCH
from yolo_deepsort_tpu.models import weights as JW
from yolo_deepsort_tpu.models.darknet import build_network as j_build
from yolo_deepsort_tpu.train import yolo_cli as JYC
from torch_port_threads import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
# the gate's recipe at the size where the port's card run went NaN
MODEL, SIZE, BATCH, LR, SEED, STEPS = "yolov3", 416, 8, 5e-4, 0, 2
RECIPE = {"model": MODEL, "img_size": SIZE, "batch": BATCH, "lr": LR}


def _reference_gate():
    spec = importlib.util.spec_from_file_location(
        "reference_tool_int8_gate_trained",
        REPO / "tools" / "int8_gate_trained.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_first_steps():
    """The reference tool's training loop for ``STEPS`` steps, with the
    largest objectness logit read before each step and after the last."""
    ref = _reference_gate()
    plan = j_build(J_ARCH[MODEL](img_size=SIZE))
    rng = np.random.default_rng(SEED)
    raw = JW.random_raw_params(plan.defs(), seed=SEED)
    params, stats = JYC.raw_params_to_train(raw, plan.defs())
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(LR))
    opt_state = tx.init(params)
    step = jax.jit(JYC.make_detection_train_step(plan, tx))
    forward = jax.jit(JYC.make_forward_train(plan))
    n_train = 4 * BATCH
    scenes = [ref.synth_scene(rng, SIZE) for _ in range(n_train)]
    imgs_all = np.stack([s[0] for s in scenes]).astype(np.float32) / 255.0
    losses, logits = [], []
    for _ in range(STEPS):
        idx = rng.choice(n_train, BATCH, replace=False)
        imgs = imgs_all[idx]
        targets, tmask = ref.batch_targets([scenes[i][1] for i in idx])
        logits.append(objectness_max(forward(params, stats, imgs)[0],
                                     plan.num_classes))
        params, opt_state, stats, loss, _ = step(
            params, opt_state, stats, imgs, targets, tmask)
        losses.append(float(loss))
    logits.append(objectness_max(forward(params, stats, imgs)[0],
                                 plan.num_classes))
    return losses, logits


@pytest.mark.slow
def test_f10_witness_yolov3_416():
    want = first_steps_record("jax", *jax_first_steps(), **RECIPE)
    jax.clear_caches()
    gc.collect()
    got = first_steps_record(
        "port-cpu", *port_first_steps("cpu", MODEL, SIZE, BATCH, LR, SEED,
                                      STEPS), **RECIPE)
    np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                               rtol=TRAINED_LOSS_RTOL, atol=0)
    # step 0's forward runs on the same params: its largest logit agrees
    np.testing.assert_allclose(got["objectness_max_per_step"][0],
                               want["objectness_max_per_step"][0],
                               rtol=TRAINED_LOSS_RTOL)
    # the branch F10 takes (ROADMAP.md queue 3): both sides alike
    assert got["step1_loss_finite"] == want["step1_loss_finite"]
