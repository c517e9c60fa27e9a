"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs a CUDA device and nvcc; exits non-zero without them. Phases, each of
which ends the run with a non-zero exit code when it fails:

1. build: compile the CUDA kernels of ``yolo_deepsort_tpu_torch/csrc`` with
   nvcc for sm_90a (first use; cached by source hash under
   ``yolo_deepsort_tpu_torch/build/``).
2. kernels vs plain, at the serving path's shapes, each held to its plain
   PyTorch version on the same inputs with the tolerance stated below:
     letterbox     (8, 1080, 1920, 3) uint8 -> (8, 416, 416, 3) bf16
     crops         8 frames x 40 boxes, window (320, 192) -> (8, 40, 128, 64, 3)
     tracker       a seeded 10-frame scene, S=8 streams, T=128, D=40, F=512
                   (plain version on CPU copies; discrete state exactly equal)
     jv_cascade    S=8 seeded cascades, R=128 rows, C=64 columns (NC=192):
     jv_two_stage  exact ties, INFTY gates, inactive rows, levels 0-5, a
                   stream with no active row (plain on CPU copies; every
                   assignment exactly equal)
     conv          every distinct eligible conv shape of yolov3-416 at batch
                   8 (15 classes: 3x3 and 1x1, stride 1 and 2, 52/26/13 maps,
                   Ci 128-1024 incl. 384 and 768, Co 128-1024 and 255) plus
                   one mish shape, in bf16 mode (within 2 bf16 ulps) and in
                   int8 mode (exactly equal); ``check_conv``
     conv (default bf16 path)  every other conv shape the bf16 forwards give
                   kernel 7 (``check_bf16_rounding``): the rest of
                   yolov3-416 at batch 8 (layer 0's 3 input channels
                   zero-padded to 8, the 416/208/104 maps) and every conv of
                   both ReID nets at EMBED_CROPS crops (the ReLU and ELU
                   codes; the f32-output form of each block's second conv
                   and projection shortcut): bf16 outputs within 2 bf16
                   ulps, f32 outputs within TOL_CONV_F32; then the small
                   bf16 detector and both bf16 ReID nets on the card against
                   the CPU's plain forwards (``check_small_bf16_nets``)
     crops_interleaved  the same boxes through kernel 6 (the interleaved-RGB
                   variant of the same staged main loop): to its plain
                   version within the crops tolerance, and exactly equal to
                   kernel 2
     crops_dense   the K=1 step's crops (the dense-order entry of the same
                   loop, whole-frame window) on those boxes with a
                   full-frame, a tall and a wide box in every frame: exactly
                   equal to its plain version, the batched
                   ``crop_and_normalize`` at bf16; ``check_crops_dense``
     conv_int8     kernel 8 at the nine conv shape classes of one int8-
                   resident ReID embed of 320 crops (``REID_INT8_CLASSES``),
                   each in every epilogue its layers use (ReLU, residual,
                   f32 out): int8 codes exactly equal, f32 out within 1e-5
                   relative; ``check_conv_int8``. After path 4c the same
                   once more at the chunked step's own crop count (K x S x
                   the bucket it took)
     resblock      kernel 9 at the three residual-chain classes of
                   yolov3-416 at full chain length (52x52 256/128 x 8, 26x26
                   512/256 x 8, 13x13 1024/512 x 4) plus one mish chain, at
                   batch 8 and at batch 32 (the K=1 and the chunked step's):
                   int8 mode exactly equal, bf16 mode every element inside
                   rtol = atol = 3e-2 and every block alone within 4 bf16
                   ulps; timed (weights packed once, as the route holds
                   them) beside the same blocks layer by layer through the
                   library and through kernel 7; ``check_resblock``
     matmul_probe  kernel 10 at (32768, 256) x (256, 256), inside the probe
                   tool's own run (path 4e): int8 exactly equal (floor
                   division), bf16 within 1 bf16 ulp; timed on both clocks
                   beside ``torch.matmul`` / ``torch._int_mm``
     nms           the batched NMS of ``csrc/nms.cu`` (after the main path's
                   setup, on its decoded chunk: N 32, B 10647, C 80,
                   max_boxes 512): the calibrated per-stream thresholds at
                   max_dets 64 and the K=1 step's 8 frames at cap 40, a
                   saturated case (top-k drops, max_dets fills) and a tie
                   case (scores rounded to 1/16): masks, order, sat and the
                   obj / cls_conf / cls columns exactly equal, merged boxes
                   within ``ops/nms_kernel.py`` MERGE_TOL (1e-5 of the box
                   scale); ``check_nms``
     roi_nms       the ROI NMS of the same file at D = 64, max_overlap 0.5,
                   a seeded scene and tied clusters: keep masks exactly
                   equal; ``check_roi_nms``
   The kernel times (``ms``, and ``library_ms`` beside them) are CUDA-event
   means of repeated calls from Python on the same inputs (K1, K2, K6 and
   the dense crops also replayed from a CUDA graph, ``device_ms``; the
   tracker and
   the JV solvers: the kernel alone, with the whole wrapper beside it, and
   the kernel alone replayed from a CUDA graph, ``device_ms``; their lines
   also carry the longest stream's ``rows`` and ``dijkstra_steps``, counted
   by the plain solver on the same inputs, and ``chain_bound_ms``: (rows +
   steps) x ``CHAIN_STEP_CYCLES`` at the card's maximum SM clock). The
   two conv kernels at their small shapes take the card less time than
   their wrappers take the host, so they, their library yardstick, kernels
   9 and 10 and their yardsticks are also timed with the host out of the
   way, the same calls replayed from a CUDA graph: ``device_ms``,
   ``library_device_ms``, ``k7_device_ms``. Each kernel's line also gives its roofline bound
   (``roofline``: bytes in and out over 3.35 TB/s, or operations over the
   card's peak for their type; for kernels 2 and 6 the bytes in are the
   frame pixels that lie in a box, ``crops_io_bytes``, for the dense crops
   the pixels its taps weigh, ``crops_dense_io_bytes``) and, for the conv, the time of the library
   call that computes the same function (``F.conv2d`` + activation), a
   yardstick the port never calls.
3. small paths: ``BucketedScannedStep`` on the card against the same step on
   the CPU, where every wrapper runs its plain version (yolov3-tiny at 64,
   2 streams of 64x128, 3 chunks of K=2; ``check_small_path``), and the K=1
   step ``make_batched_step`` likewise (``check_small_k1``); and
   ``reid_apply_int8_resident`` with kernel 8 on the card against the same
   package on the CPU (``check_small_reid_int8``); and a small residual
   detector through the K=1 step with the chain route, bf16 and int8 chains
   (``check_small_resblock``); and the monolithic chunk step
   ``make_scanned_step`` likewise on both tracker branches, 2 chunks of
   K=3 (``check_small_scanned``: ids, emit and discrete state equal, boxes
   within 1 px, per chunk K1 1, the dense crops 1, K2 0, K3 3 or K5 3).
4. main path: yolov3-416 at full width in bf16 with seeded well-conditioned
   random weights (head biases aimed at person-sized boxes, per-stream
   thresholds calibrated to ~32 detections per frame), 8 temporally static
   1080p streams, K=4 frames per chunk, 6 chunks through
   ``BucketedScannedStep``. Checks finite state, confirmed tracks, emitted
   rows, one wait per chunk for the stats readback and no other
   synchronizing CUDA call (sync debug mode "error"), and that each
   kernel's launch counter moved during the counted run.
4b. K=1 path (``run_k1_path``): the same model, weights and frames through
   the single-frame step ``make_batched_step`` with cap 40 and crop window
   (320, 192), the backbone convs of a FIXED layer set (``CONV_ROUTE``: 9
   layers through the bf16 conv kernel, 10 through the int8 one, package
   calibrated from two of the frames) routed through kernel 7. On the card
   the step's detector is replayed from a CUDA graph from its second call
   on (``parallel/streams.py`` ``DetectorGraph``): its kernels count at
   its eager first call and at the capture, a replay counts one
   ``detector_graph`` and none of them; so the warm-up's counts hold the
   detector's convs twice, the counted steps none. Checks per counted
   step: one replay, K1, the dense crops and K3 launch once, K2 never, K7
   once per ReID conv, one readback and no other synchronizing call; on
   F5's margin load (the
   threshold in the widest gap of the unrouted objectness, ``margin_load``)
   the route's rows equal its plain twin's (``check_twin_rows``: its int8
   layers move objectness past every margin the load offers, which is
   printed) and its tracks against the unrouted run's are measured
   (``PairScore``); prints p50/p99 ms per step with the route and without
   it, and the step's crops alone beside the earlier design's (K2, the
   per-frame dense crops and the window guard's ``torch.where``) on both
   clocks.
4c. int8-resident ReID embed (``run_int8_embed_paths``): the package of
   ``quantize_reid_params_resident`` (seeded ReID weights, 64 N(0, 1) crops,
   calibrated on the card) through the chunked step and the K=1 step with
   ``embed_int8="resident_pallas"`` on the main path's model and frames:
   per chunk K8 15 launches, K1 1, K2 1, K3 K; per K=1 step K8 15, K1, the
   dense crops, K3 1 and one replay of the detector's graph (K7 0); one
   readback each and no other synchronizing call;
   frames/s and p50/p99 beside the bf16 embed's in alternated blocks; on
   the margin load each step's tracks are the bf16 embed's (churn 0, mean
   IoU >= ROUTE_MIN_IOU, an id remap rate of at most 0.02); and
   both steps under ``YDT_CROPS_LAYOUT=interleaved`` (K6 1 per chunk and 0
   per step, K2 0, rows equal to the planar run's).
4d. fused residual chains (``run_resblock_paths``): the chunked step and
   the K=1 step with ``use_resblock=True`` and ``use_resblock="int8"`` (the
   package of the 40 chain convs calibrated on the card from two frames) on
   the main path's model and frames: per chunk, and per K=1 step at its
   eager call and its capture (a replay of the detector's graph counts
   none), K9 3 launches (one per routed chain, what
   ``plan_chain_schedule`` promises) and 40 kernels behind them, two per
   block of the model's chains, as the C entry counts its launches
   (``device_kernels``), K1, K2 (the K=1 step: the dense crops), K3 as
   before,
   one readback and no other synchronizing call; the routed
   detector's decoded output against the unrouted one; frames/s and p50/p99
   beside the unrouted run's in alternated blocks; on the margin load the
   bf16 chains' tracks are the unrouted run's (churn 0, mean IoU >=
   ROUTE_MIN_IOU, no id remapped) and the int8 chains' rows exactly those
   of kernel 7's int8 modes layer by layer, chunked and K=1.
4e. the int8 probe (``run_probe_path``): ``tools/int8_probe.py``
   ``run_probe`` at its default shape; its JSON record on a line of its own.
4f. the monolithic chunk step (``run_scanned_path``): ``make_scanned_step``
   on the main path's model and frames (8 x 1080p, K=4, max_dets 64,
   max_tracks 128, nn_budget 100) with one threshold calibrated to ~32
   detections a frame, on both tracker branches: per chunk K1 1, the dense
   crops 1 (all K x S x 64 rows), K2 0, and K3 4 (fused) or K5 4
   (``tracker_step``); no host wait inside the step (sync debug mode
   "error"); then frames/s and device ms per chunk beside
   ``BucketedScannedStep``'s on the same chunks (alternated blocks,
   medians), with the card's name and power limit.
4g. F8 (``run_f8_path``): ``BucketedScannedStep`` bf16 on 480 x 854
   frames, which the reference's crop gate refuses: the windowed crops are
   one launch of the dense entry (K2 0), bit-equal to its plain version.
5. public JV ops (``run_jv_ops``): ``solve_cascade_assignment_fused`` and
   ``solve_masked_assignment_fused`` on the card over 8 streams of
   tracker-sized problems, equal to the same ops on the CPU.
6. facades (``run_facades``): the ``Darknet`` facade loads a yolov3-416
   ``.weights`` file written from the seeded weights; ``VideoTracker``
   (bf16, one 1080p stream, threshold calibrated to ~32 detections) runs
   ``track_frame`` over 8 static frames -- confirmed rows from frame
   n_init on, kernels K1, NMS and K5 once per frame, K3 never, one readback per
   call and no other synchronizing call -- then one ``track_frames`` chunk
   of K=4 (K1, K2, K3); ``DeepSort.update`` on the card over a seeded
   8-frame 1080p scene of ~32 textured walking objects with dropouts
   gives exactly the rows of ``DeepSort(device="cpu")``, and so does
   ``DeepSort(nms_max_overlap=0.5)``, the ROI NMS kernel once a call.
7. multi-stream runtime (``run_multistream``): ``MultiStreamTracker``'s loop
   over 8 x 1080p with producer threads pushing seeded frames into the
   native frame pool (g++ at first use) in place of video decoders; one
   stream ends early, and the ``with_validity`` step must leave its state
   untouched and emit nothing for it.
7b. cross-camera global ids (``run_global_ids``): (a)
   ``MultiStreamTracker(global_ids=True, global_id_every=2)`` with the
   same producers, model, weights and threshold over 8 x 1080p streams of
   one frame: per step K1 1, the dense crops 1, K3 1, K7 20 and one
   replay of the detector's graph or one eager forward (K7 75 more at its
   eager calls and its capture), one readback,
   every emitted id > 0, and after every step the card's gid table equals,
   bit for bit, the one-rank step (``assign_provisional_gids`` between
   rounds) run on the CPU over a CPU copy of the card's states; fewer
   global ids than live tracks (every camera sees the same objects, so
   aliasing is the designed outcome); (b) the reference's handoff and
   no-aliasing scenes at the served tracker sizes (T 128, nn_budget 100,
   F 512, 8 cameras) through kernel 3 and the gid step on the card, every
   frame's table equal to the CPU's, the handoff keeping gid 1 and no two
   live tracks sharing one; (c) a real NCCL process group of one rank
   (``init_process_group("nccl", world_size=1)`` over a local store):
   through it the gid step and the matcher equal the mesh without a group
   bit for bit -- an NCCL that cannot start fails the run, there is no
   gloo fallback; (d) the gid step's device ms (CUDA events) and peak
   memory at S = 8 and 16 beside its bound (its f32 products over 67
   TFLOP/s), the matcher's at D = 64, and ``MultiStreamTracker`` ms per
   step with global ids off and on in alternated blocks (off, on, on,
   off, on, off, off, on), each stream's ring holding all its frames, and
   one more block off with the default ring of 8, where the producers
   find their rings full and wait for pops (F9: they used to spin), with
   the card's name and power limit.
8. tracking quality (``run_tracking_quality``): 4 streams of the reference's
   synthetic MOT scene (``mot_scene``: 120 frames, 8 objects, seeds 0-3)
   through kernel 3 and kernel 5 on the card and ``tracker_step`` on the
   CPU, scored with the port's ``utils/mot.py``: per stream MOTA, ID
   switches and IDF1 of both kernels equal the CPU's.
9. training (``run_yolo_training``, ``run_reid_training``; library convs
   and autograd, as the reference leaves training to XLA): yolov3 at full
   width, 416 px, batch 8, and the 512-d ReID net with a 751-class head at
   128 x 64, batch 64, each TRAIN_STEPS SGD steps on a fixed generated
   batch (loss finite and falling; ms per step and peak memory); each
   one's tiny net for 3 steps on the card against the CPU
   (``_forced_steps``); both CLIs on the card on generated files: train,
   checkpoint, resume, export (YOLO) or test and evaluate (ReID).
9b. the training mesh (``run_parallel_training``; ``parallel/mesh.py``
   ``make_train_mesh``): the same two full-width loads, 3 SGD steps each
   from one seeded start through ``mesh=None``, a mesh without a group
   and a real NCCL process group of one rank (both axes the group, so
   every collective of the step runs through NCCL): NCCL equal to no group
   bit for bit (losses, params, statistics), the mesh held to ``mesh=None``
   within the TOL_TRAIN_* bounds; ms per step and peak memory of each;
   then ``tools/dryrun_multichip.py`` on one NCCL rank. The multi-rank
   arithmetic is held on the CPU over gloo
   (``tests/test_torch_port_train_parallel.py``): NCCL refuses two ranks
   on one card.
9c. the int8 gates and the serving soaks (``run_int8_gates``,
   ``run_soaks``; the port's ``tools/``, all on the honest load of
   ``tools/honest_load.py`` but the ReID gate): the ReID gate, the detector
   gate and the trained detector gate at their defaults (verdicts printed
   as measurements; kernel 8's resident embed equal to its plain version,
   kernel 7's int8 route equal to the plain twin before NMS, their
   launches counted), then ``tools/soak.py`` (yolov3-416 bf16, K 16, 8 x
   1080p, SOAK_CHUNKS chunks) and ``tools/soak_multichip.py`` on one NCCL
   rank: every invariant must hold, every kernel of their paths launch.
   Between them the track-level gate (``run_int8_track_gate``,
   ``tools/int8_track_gate.py`` at its defaults: yolov3-416, 2 x 1080p,
   60 K=1 steps of f32, bf16, the int8 route and its plain twin): verdict
   printed; the int8 route's tracks exactly the twin's, its decoded tensor
   equal, kernel 7 launched once a conv a step (bf16 and int8 paths) or an
   unpackaged conv (the twin).
9d. the tools (``run_tools``): (a) ``tools/verify_weights.py`` ``verify``
   at yolov3-416, batch 1, float32 and the bfloat16 module (kernel 7 on all
   75 convs), against the numpy oracle on a well-conditioned random
   ``.weights`` (float32 within the tool's default threshold, 1e-2, or the
   run fails) and on random raw params (read only: there the deep
   activations grow until float32 rounding alone passes the threshold and
   the yolo decode overflows, as on the reference's tool); one JSON line
   each with the worst layers; (b) ``tools/parity_real.py --standins`` in a
   subprocess on the card: ``ok`` or the run fails, its report's rows
   printed; (c) ``ImageDetector(interp="nearest")`` and ``"bilinear"``
   (kernel 1) on one 1080p noise frame, yolov3-416 float32 on (a)'s
   well-conditioned weights, at a threshold midway between the CPU's 32nd
   and 33rd objectness: the same set of rows and classes as the same
   detector on the CPU (rows of near-equal score may sort in another
   order), boxes within TOL_TOOLS_BOXES px and scores within
   TOL_TOOLS_SCORES; launches: kernel 7 75 per bf16 forward of (a), kernel
   1 once in (c)'s bilinear detect, nothing else.
9e. decoded video (``run_video``; clips of ``tools/soak.py``
   ``ensure_clips`` written with cv2 into a temp dir, the cuts from the
   tools' defaults listed at VIDEO_CHUNKS): (a) ``tools/soak.py --ingest``
   (yolov3-416 bf16, 8 x 1080p, K 16; looping cv2 decoders, the native
   rings, two pinned chunk buffers, the upload and the step pipelined one
   chunk deep): ``ok``, per chunk K1 1, K2 1, K3 16, K7 95 and one stats
   readback, and every uploaded chunk, summed per frame and channel on the
   card, equal to its clip's frames in order, looped, BGR turned RGB; (b)
   ``tools/bench_video.py`` (one 1080p clip, chunk 16, through
   ``VideoTracker.track``): the frames of a pass, and per chunk of its
   timed pass K1 1, K2 1, K3 16, K7 95; (c) ``MultiStreamTracker`` with its
   own cv2 decoders over (a)'s 8 clips, rings of 8: every frame of every
   stream, one readback a step, ms per step; then F9's numbers on the
   seeded load of phase 7, full rings of 8 against rings holding every
   frame; (d) ``examples/track_video.py`` and ``track_multicamera.py``
   with ``--device cuda`` through their ``main``.

Since the bf16 forwards round where the reference rounds, kernel 7 runs
every conv of the bf16 detector and ReID net: the counted paths hold its
launches to one per conv layer per forward (yolov3 75, the 512-d ReID net
20), measured: per chunk on the main path, per K=1 step (the routed layers
included), on the int8-embed paths (the detector's alone), on the chain
paths (the convs off the chains) and on the scanned path.

Each of paths 4-8 is run with the launch counters set to 0 just before it
and read just after (the ``kernels`` line: ``launches`` from path 4,
``launches_k1_path``, ``launches_scanned_path`` from 4f -- its counted
chunk of each tracker branch, every counter of the port read -- and
``launches_quality_gate`` from 8, likewise, ``launches_global_ids_path``
from 7b's counted run, ``launches_int8_gates_path`` from 9c's three
gates, ``launches_int8_track_gate_path`` from its track gate,
``launches_soak_path`` and ``launches_soak_multichip_path`` from
the soaks' timed loops, ``launches_tools_path`` from 9d's (a) and (c),
``launches_video_path`` from the timed loops of 9e's (a) and (b)). Prints frames/s and per-stage times,
the facades' ms per call, a JSON line of per-kernel results, the card's
name and power limit, and as the last line ``{"ok": true, "device":
{...}}``.

    python3 chip_smoke.py --profile

builds the kernels and the main path's, the K=1 path's and the facades'
setups, then prints where their time goes instead (``profile_main_path``,
``profile_k1``, ``profile_int8_embed``, ``profile_resblock``,
``profile_facades``), with no
result line.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

STREAMS, FRAME_H, FRAME_W, K_FRAMES, CHUNKS = 8, 1080, 1920, 4, 6
TARGET_DETS = 32
JV_SHAPE = (8, 128, 64)  # streams, rows (max_tracks), columns (max_dets)
FACADE_FRAMES = 8
# the NMS kernels (``check_nms``, ``check_roi_nms``): the ROI NMS's boxes
# (the facades' padded D) and overlap (deep_sort's NMS_MAX_OVERLAP); the
# batched NMS's candidates an image taken over the threshold in its
# saturated cases (past max_boxes, 512)
ROI_NMS_D, ROI_NMS_OVERLAP = 64, 0.5
NMS_SATURATED_TOP = 1024

# the K=1 low-latency step (the reference bench's K=1 settings)
K1_CAP, K1_WINDOW, K1_STEPS = 40, (320, 192), 30
# Conv routing of the K=1 path: a FIXED layer set for bring-up, not a tuned
# one. These are the module indices the reference routes for yolov3-416 at
# batch 8 (bf16 kernel / int8 kernel); no timing on this card chose them.
CONV_ROUTE = {
    "bf16": frozenset({37, 64, 67, 70, 73, 76, 78, 80, 99}),
    "int8": frozenset({63, 66, 69, 72, 75, 77, 79, 84, 93, 96}),
}
N_ROUTED = len(CONV_ROUTE["bf16"]) + len(CONV_ROUTE["int8"])
MST_FRAMES, MST_SHORT = 6, 3  # frames per stream; the last stream's
# the global-id phase (``run_global_ids``): frames per stream of the
# full-width run and the gid rounds' cadence; the timed blocks (global ids
# off or on, alternated twice over), steps timed in each after the warm
# ones; the reference's scenes'
# frames; the matcher's queries per stream; calls per device timing
GID_FRAMES, GID_EVERY = 8, 2
GID_TIMED_STEPS, GID_WARM_STEPS = 20, 3
GID_BLOCKS = (False, True, True, False, True, False, False, True)  # on?
GID_HANDOFF_FRAMES, GID_NO_ALIAS_FRAMES = 16, 6
GID_MATCH_DETS, GID_REPS = 64, 10

# The int8-resident ReID embed (kernel 8). One embed runs 15 quantized convs
# in nine shape classes: (layers, k, stride, input map h, w, Ci, Co). A
# layer's epilogue follows from its name (``_reid_layer_epilogue``).
REID_INT8_CLASSES = (
    (("l1b0c1",), 3, 2, 64, 32, 64, 128),
    (("l1b0d",), 1, 2, 64, 32, 64, 128),
    (("l1b0c2", "l1b1c1", "l1b1c2"), 3, 1, 32, 16, 128, 128),
    (("l2b0c1",), 3, 2, 32, 16, 128, 256),
    (("l2b0d",), 1, 2, 32, 16, 128, 256),
    (("l2b0c2", "l2b1c1", "l2b1c2"), 3, 1, 16, 8, 256, 256),
    (("l3b0c1",), 3, 2, 16, 8, 256, 512),
    (("l3b0d",), 1, 2, 16, 8, 256, 512),
    (("l3b0c2", "l3b1c1", "l3b1c2"), 3, 1, 8, 4, 512, 512),
)
EMBED_CROPS = STREAMS * K1_CAP  # crops of one K=1 embed
N_INT8_CONVS = sum(len(c[0]) for c in REID_INT8_CLASSES)  # 15
INT8_CHUNKS, INT8_K1_STEPS = 4, 20

# the fused residual chains (kernel 9) at yolov3-416: (map, Ci, Cm, blocks,
# module index of the chain's first conv). The other two chains of
# darknet-53 (starts 2 and 6: 208x208 and 104x104 maps) fail the route's
# gates and stay on the library convs.
RESBLOCK_CLASSES = (
    (52, 256, 128, 8, 13),
    (26, 512, 256, 8, 38),
    (13, 1024, 512, 4, 63),
)
RESBLOCK_CHUNKS, RESBLOCK_K1_STEPS = 3, 15
# kernel 9 against its plain version: the bounds and the seeded operands are
# those of ``ops/resblock_kernel.py`` (CHAIN_TOL, CHAIN_BLOCK_ULPS,
# ``seeded_chain_case``): bf16 mode, every element of a whole chain inside
# rtol = atol = 3e-2 and every block, fed the plain chain's state, within 4
# bf16 ulps of max(|x|, |out|, 2^-3); int8 mode with a leaky activation
# exactly equal; mish to the bf16 bounds in both modes.
# routed detector against the unrouted one: each decoded column relative to
# its largest magnitude (the reference's bound for its hook), for the bf16
# and the W8A8 chains alike, at the K=1 and at the chunked step's batch
TOL_ROUTED_DECODED = 4e-2
# F5's margin load, the route checks' thresholds (the main path keeps its
# calibrated ones): the midpoint of the widest gap in the unrouted bf16
# detector's objectness between ranks 16 and 48 of each stream's frame (a
# chunked step's per-stream thresholds) or 16 S and 48 S of the streams'
# pooled values (the one threshold of a K=1 step), half the gap its margin.
# A route's objectness change is taken over each frame's candidates within
# MARGIN_NEAR ranks of its threshold (the unrouted order). A route held to
# the unrouted run must change objectness by less than the margin; while it
# does not, the window widens along MARGIN_WINDOWS (the window taken is
# printed). The W8A8 routes (the K=1 conv route's int8 layers, the int8
# chains) move objectness by 4-7 bf16 ulps of the logit, and the noise
# load's candidates lie about one ulp apart in every window: no window
# holds them (the smoke prints each one's change beside the widest margin
# the windows offer), so they are held exactly to a second implementation
# of their own arithmetic instead (``check_twin_rows``), and their tracks
# against the unrouted run's are printed as a measurement.
MARGIN_WINDOWS = ((16, 48), (8, 64), (4, 96))
MARGIN_NEAR = 48
# routed against unrouted serving runs on that load, through
# ``tools/int8_track_gate.py`` ``PairScore`` (greedy IoU matching a frame,
# ids followed across frames): churn 0, matched boxes at a mean IoU of at
# least ROUTE_MIN_IOU, ids remapped at most at the reference gate's rate
# (its MAX_REMAP_RATE) -- and never where the tracker sees the same
# detections (the bf16 chains; the int8 embed changes only the features)
ROUTE_MIN_IOU = 0.99

# the card's published peaks (H100 SXM, dense): the roofline bounds below
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}

# tolerances of the kernel-vs-plain phase
TOL_LETTERBOX = 2.0 ** -8  # one bf16 ulp of a value in [0.5, 1): rounding
#                            flips where the f32 sums differ in the last bit
TOL_CROPS = 1e-4  # same bf16 rounding points, two taps per axis: exact in
#                   practice; the bound allows the f32 affine's last bit
TOL_TRACKER_MEAN = 2e-3  # KF means, absolute px: unrolled Cholesky vs LAPACK
# K3-K5's chain bound: the least latency, in SM cycles, assumed for one
# dependent step of a solve (a row's set-up or one Dijkstra step): two warp
# reductions (redux.sync), one shuffle and one shared-memory load in a
# chain, ~25 cycles each on Hopper; counted once per row and per step
CHAIN_STEP_CYCLES = 100
# small-path detect boxes, absolute px: f32 convs (TF32 off) summed in
# another order on the card than on the CPU
TOL_SMALL_BOXES = 1e-3
# conv kernel, bf16 mode: bf16 products are exact in f32 and only the order
# of the f32 sums differs from the plain version (the tensor cores do not
# accumulate in IEEE round-to-nearest), which can move the final bf16
# rounding: 2 bf16 ulps of max(|want|, 2^-6), compared in f32 (inputs
# ~N(0, 1); below 2^-6 the sums' own rounding outweighs the value's ulp).
# int8 mode: int32 sums are exact, the f32 epilogue is the plain version's op
# for op (--fmad=false): exactly equal. The kernel's mish is another form
# than the plain version's: int8 mode within 1 bf16 ulp there.
TOL_CONV_ULPS = 2.0
CONV_ULP_FLOOR = 2.0 ** -6
# kernel 7's f32-output form: the same products summed in another order
# and not rounded to bf16; the tensor cores do not accumulate in IEEE
# round-to-nearest, so the sums of a deep layer drift by more than an f32
# ulp (1.6e-5 relative measured at depth 2304): within 2^-13 of
# max(|want|, 1), 64 times tighter than the bf16 bound
TOL_CONV_F32 = 2.0 ** -13
# the bf16 nets on the card (kernel 7) against the CPU (its plain version),
# check_small_bf16_nets: both round at the same points, and the tensor
# cores' sums, which truncate, flip a bf16 rounding more often than the
# two frameworks' CPU forwards do (3.3% of the decoded values there): a
# flip moves objectness by up to a bf16 ulp of the head through the
# sigmoid. Decoded boxes in px of the 64-px input (measured 3.9e-3),
# objectness (4.8e-4), the share of decoded values that differ (16%), max
# |feature diff| of the 512-d and 128-d embeds (3.8e-4, 1.5e-3)
TOL_BF16_BOXES, TOL_BF16_OBJ, MAX_BF16_DIFFER = 1e-2, 1e-3, 0.3
TOL_BF16_REID = {"512": 1e-3, "128": 4e-3}
# kernel 8: int32 sums are exact and its f32 epilogue is the plain version's
# op for op, so int8 codes must be exactly equal; the f32 output (the last
# conv) is held to 1e-5 relative (of max(|want|, 1e-3))
TOL_CONV_INT8_F32 = 1e-5
# reid_apply_int8_resident, card vs CPU, bf16 front on both: the two fronts
# sum in another order and round to bf16, which flips int8 codes at the
# first quantize; minimum feature cosine
MIN_COS_REID_INT8 = 0.999


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def roofline(n_bytes: float, ops: float = 0.0, kind: str = "f32"):
    """(bound ms, "bytes" | "operations"): the larger of the bytes over the
    card's memory rate and the operations over its peak for their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


_GRAPH_POOL = None  # one memory pool for every graph cuda_graph_ms captures


def cuda_graph_ms(fn, reps: int, own_pool: bool = False) -> float:
    """Mean device time of fn() with the host out of the way: ``reps``
    calls captured into one CUDA graph (after one warm-up), the graph
    replayed between two events, the median of three replays. Kernels 7 and
    8 at their smaller shapes take less time on the card than their Python
    wrappers take on the host, so back-to-back calls (``cuda_ms``) would
    time the host there. The graphs are replayed one at a time and their
    outputs never read, so all share one memory pool: none pays to reserve
    and to return the memory of its ``reps`` outputs. ``own_pool`` gives
    the graph a pool of its own instead (a function of many framework ops,
    whose temporaries the shared pool's allocator bookkeeping refuses)."""
    import torch

    global _GRAPH_POOL
    if _GRAPH_POOL is None:
        _GRAPH_POOL = torch.cuda.graph_pool_handle()
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=None if own_pool else _GRAPH_POOL):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[1]


def check_letterbox(rng, dev):
    import torch

    from yolo_deepsort_tpu_torch.ops import letterbox_kernel as LK
    from yolo_deepsort_tpu_torch.ops.letterbox import letterbox_batch

    frames = torch.from_numpy(rng.integers(
        0, 256, (STREAMS, FRAME_H, FRAME_W, 3), dtype=np.uint8)).to(dev)
    got = LK.letterbox_cuda(frames, 416, torch.bfloat16)
    want = letterbox_batch(frames, 416, torch.bfloat16)
    err = (got.float() - want.float()).abs().max().item()
    if got.shape != (STREAMS, 416, 416, 3) or not err <= TOL_LETTERBOX:
        raise AssertionError(f"letterbox: shape {tuple(got.shape)}, "
                             f"max |err| {err} > {TOL_LETTERBOX}")
    ms = cuda_ms(lambda: LK.letterbox_cuda(frames, 416, torch.bfloat16), 50)
    device_ms = cuda_graph_ms(
        lambda: LK.letterbox_cuda(frames, 416, torch.bfloat16), 50)
    plain_ms = cuda_ms(lambda: letterbox_batch(frames, 416, torch.bfloat16), 10)
    return (err, ms, plain_ms, f", {device_ms:.4f} ms of device time",
            nbytes(frames, got), {"device_ms": device_ms})


def crops_io_bytes(boxes, frame_hw, out) -> int:
    """The bytes a windowed crop must move: every frame pixel that lies in
    at least one box of its frame read once (3 bytes; the rest of the frame
    is never needed), the boxes read, the crops written."""
    from yolo_deepsort_tpu_torch.ops.crops import crop_window_bounds

    h, w = frame_hw
    corners = crop_window_bounds(boxes.cpu(), h, w)
    x1, y1, x2, y2 = (c.numpy() for c in corners)
    needed = np.zeros((boxes.shape[0], h, w), bool)
    for s, d in np.ndindex(*x1.shape):
        needed[s, y1[s, d]:y2[s, d], x1[s, d]:x2[s, d]] = True
    return 3 * int(needed.sum()) + nbytes(boxes, out)


def crops_dense_io_bytes(boxes, frame_hw, out) -> int:
    """The bytes the dense crop entry must move: every frame pixel that a
    box's taps weigh (its rows of a non-zero Y weight by its columns of a
    non-zero X weight, over the whole frame) read once per frame, the boxes
    read, the crops written. A box downsampled in a direction names at most
    two source lines per output line there: a full-frame 1080p box, 256 rows
    by 128 columns."""
    import torch

    from yolo_deepsort_tpu_torch.ops.crops import (
        CROP_H,
        CROP_W,
        _interp_matrix,
        crop_window_bounds,
    )

    h, w = frame_hw
    pixels = 0
    for frame_boxes in boxes.cpu():
        x1, y1, x2, y2 = crop_window_bounds(frame_boxes, h, w)
        rows = (_interp_matrix(y1, y2, h, CROP_H, torch.float32) != 0).any(1)
        cols = (_interp_matrix(x1, x2, w, CROP_W, torch.float32) != 0).any(1)
        needed = np.zeros((h, w), bool)
        for r, c in zip(rows.numpy(), cols.numpy()):
            needed[np.ix_(r, c)] = True
        pixels += int(needed.sum())
    return 3 * pixels + nbytes(boxes, out)


def crops_case(rng, dev):
    """The crop kernels' inputs at the served shape: 8 1080p frames and 40
    boxes per frame that fit the (320, 192) window."""
    import torch

    frames = torch.from_numpy(rng.integers(
        0, 256, (STREAMS, FRAME_H, FRAME_W, 3), dtype=np.uint8)).to(dev)
    d = K1_CAP
    bw = rng.uniform(20, 190, (STREAMS, d))
    bh = rng.uniform(40, 318, (STREAMS, d))
    x1 = rng.uniform(0, FRAME_W - 1, (STREAMS, d))
    y1 = rng.uniform(0, FRAME_H - 1, (STREAMS, d))
    boxes = np.stack([x1, y1, np.minimum(x1 + bw, FRAME_W - 1),
                      np.minimum(y1 + bh, FRAME_H - 1)], -1)
    return frames, torch.from_numpy(boxes.astype(np.float32)).to(dev)


def check_crops(rng, dev, interleaved=False):
    """Kernel 2 or, with ``interleaved``, kernel 6 against ``crops_plain``
    (the plain version of both: same rounding points); kernel 6 also against
    kernel 2, exactly."""
    import torch

    from yolo_deepsort_tpu_torch.ops import crops_kernel as CK

    frames, boxes = crops_case(rng, dev)
    d = boxes.shape[1]
    got = CK.crops_cuda(frames, boxes, 320, 192, interleaved=interleaved)
    want = CK.crops_plain(frames, boxes, 320, 192)
    err = (got - want).abs().max().item()
    if got.shape != (STREAMS, d, 128, 64, 3) or not err <= TOL_CROPS:
        raise AssertionError(f"crops: shape {tuple(got.shape)}, max |err| "
                             f"{err} > {TOL_CROPS}")
    note = ""
    if interleaved:
        if not torch.equal(got, CK.crops_cuda(frames, boxes, 320, 192)):
            raise AssertionError("crops: kernel 6 differs from kernel 2")
        note = ", exactly equal to kernel 2"
    ms = cuda_ms(lambda: CK.crops_cuda(frames, boxes, 320, 192,
                                       interleaved=interleaved), 50)
    device_ms = cuda_graph_ms(lambda: CK.crops_cuda(
        frames, boxes, 320, 192, interleaved=interleaved), 50)
    plain_ms = cuda_ms(lambda: CK.crops_plain(frames, boxes, 320, 192), 5)
    return (err, ms, plain_ms, note + f", {device_ms:.4f} ms of device time",
            crops_io_bytes(boxes, (FRAME_H, FRAME_W), got),
            {"device_ms": device_ms})


def check_crops_dense(rng, dev):
    """The dense crop entry (the K=1 step's crops) against its plain
    version, the batched ``crop_and_normalize`` at bf16, bit for bit, at the
    K=1 shape: ``crops_case``'s boxes with, in every frame, one full-frame
    box, one taller and one wider than the K=1 window."""
    import torch

    from yolo_deepsort_tpu_torch.ops import crops_kernel as CK
    from yolo_deepsort_tpu_torch.ops.crops import crop_and_normalize_batch

    frames, boxes = crops_case(rng, dev)
    big = boxes.clone()
    for s in range(STREAMS):
        x0 = float(rng.uniform(0, FRAME_W - 900))
        y0 = float(rng.uniform(0, FRAME_H - 700))
        big[s, 0] = torch.tensor([0.0, 0.0, FRAME_W - 1, FRAME_H - 1])
        big[s, 1] = torch.tensor([x0, y0, x0 + 150.5, y0 + 690.25])
        big[s, 2] = torch.tensor([x0, y0, x0 + 890.75, y0 + 200.5])
    got = CK.crops_dense_cuda(frames, big)
    want = crop_and_normalize_batch(frames, big, torch.bfloat16)
    err = (got - want).abs().max().item()
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"crops_dense: shape {tuple(got.shape)}, max "
                             f"|err| {err}, not equal to its plain version")
    ms = cuda_ms(lambda: CK.crops_dense_cuda(frames, big), 50)
    device_ms = cuda_graph_ms(lambda: CK.crops_dense_cuda(frames, big), 50)
    plain_ms = cuda_ms(
        lambda: crop_and_normalize_batch(frames, big, torch.bfloat16), 5)
    # the K=1 step's own boxes (crops_case's alone) bound it too
    k1_case_bound_ms = roofline(
        crops_dense_io_bytes(boxes, (FRAME_H, FRAME_W), got))[0]
    return (err, ms, plain_ms, f", {device_ms:.4f} ms of device time, "
            "exactly equal to its plain version (a full-frame, a tall and a "
            "wide box in every frame); bound on crops_case's boxes alone "
            f"{k1_case_bound_ms:.6f} ms",
            crops_dense_io_bytes(big, (FRAME_H, FRAME_W), got),
            {"device_ms": device_ms, "k1_case_bound_ms": k1_case_bound_ms})


def k1_crops_parent(frames, boxes, mask, frame_hw, win):
    """The K=1 step's bf16 crops as the earlier design made them (kernel
    2, the per-frame dense crops and a ``torch.where`` on the window
    guard's device flag), to time beside ``streams.make_k1_crops``."""
    import torch

    from yolo_deepsort_tpu_torch.ops.crops import (
        crop_and_normalize,
        crop_window_bounds,
    )
    from yolo_deepsort_tpu_torch.ops.crops_kernel import (
        crop_and_normalize_fused,
    )

    x1, y1, x2, y2 = crop_window_bounds(boxes, *frame_hw)
    fits = (~mask | (((y2 - y1) <= win[0]) & ((x2 - x1) <= win[1]))).all()
    dense = torch.stack([
        crop_and_normalize(frames[i], boxes[i], compute_dtype=torch.bfloat16)
        for i in range(frames.shape[0])])
    return torch.where(fits, crop_and_normalize_fused(frames, boxes, *win),
                       dense)


def _tracker_scene(rng, s, d, n_frames, feat_dim):
    """Walking boxes with jitter, detector dropout and per-object features:
    births, confirmations, cascade levels > 0 and deletions."""
    import torch

    n_obj = 36
    base = np.stack([
        rng.uniform(10, FRAME_W - 200, (s, n_obj)),
        rng.uniform(10, FRAME_H - 320, (s, n_obj)),
        rng.uniform(40, 110, (s, n_obj)),
        rng.uniform(100, 270, (s, n_obj))], -1)
    vel = rng.normal(0, 3.0, (s, n_obj, 2))
    feats = rng.normal(0, 1, (s, n_obj, feat_dim))
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    frames = []
    for f in range(n_frames):
        tl = np.zeros((s, d, 4), np.float32)
        fe = np.zeros((s, d, feat_dim), np.float32)
        mk = np.zeros((s, d), bool)
        for si in range(s):
            keep = np.flatnonzero(rng.uniform(size=n_obj) > 0.15)[:d]
            box = base[si, keep].copy()
            box[:, :2] += vel[si, keep] * f + rng.normal(0, 1.0, (len(keep), 2))
            ft = feats[si, keep] + rng.normal(0, 0.05, (len(keep), feat_dim))
            ft /= np.linalg.norm(ft, axis=-1, keepdims=True)
            tl[si, :len(keep)] = box
            fe[si, :len(keep)] = ft
            mk[si, :len(keep)] = True
        conf = np.where(mk, 0.9, 0.0).astype(np.float32)
        frames.append(tuple(map(torch.from_numpy, (tl, conf, fe, mk))))
    return frames


def _stream_slice(state, si):
    """Stream ``si`` of a tracker state as a one-stream state; the gallery
    is copied (the plain step writes it in place)."""
    fields = {f.name: getattr(state, f.name)[si:si + 1]
              for f in dataclasses.fields(state)}
    fields["gallery"] = fields["gallery"].clone()
    return type(state)(**fields)


def longest_stream_work(solves):
    """(rows, Dijkstra steps) the plain solver did for the stream with the
    most rows + steps; ``solves`` runs one stream's plain solve each. The
    kernels' solve for all streams lasts as long as that stream's chain."""
    from yolo_deepsort_tpu_torch.ops import assignment as A

    best = (0, 0)
    for run in solves:
        A.rows_augmented = A.dijkstra_steps = 0
        run()
        if A.rows_augmented + A.dijkstra_steps > sum(best):
            best = (A.rows_augmented, A.dijkstra_steps)
    return best


def sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return float(res.stdout.strip().splitlines()[0])


def chain_entry(work, device_ms):
    """The latency-chain fields of a JV kernel's line: the longest stream's
    rows and steps, and the chain bound (rows + steps) x the assumed least
    latency of one dependent step at the card's maximum SM clock."""
    rows, steps = work
    mhz = sm_clock_mhz()
    return {"device_ms": device_ms, "rows": rows, "dijkstra_steps": steps,
            "chain_bound_ms": (rows + steps) * CHAIN_STEP_CYCLES / mhz / 1e3,
            "chain_step_cycles": CHAIN_STEP_CYCLES, "sm_clock_mhz": mhz}


def _tensors(*xs):
    """The tensors among xs, tuples opened (a kernel's threshold argument
    is a tuple holding a tensor or None)."""
    import torch

    out = []
    for x in xs:
        if isinstance(x, tuple):
            out += _tensors(*x)
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def check_tracker(rng, dev):
    import torch

    from yolo_deepsort_tpu_torch.config import TrackerConfig
    from yolo_deepsort_tpu_torch.tracking import tracker_kernel as TK
    from yolo_deepsort_tpu_torch.tracking.tracker import (
        init_tracker_state,
        tracker_step,
    )

    cfg = TrackerConfig(max_dets=40)
    s, d = STREAMS, 40
    scene = _tracker_scene(rng, s, d, 10, cfg.feat_dim)
    st_k = init_tracker_state(cfg, s, dev)
    st_p = init_tracker_state(cfg, s, "cpu")
    err, k_ms, p_ms, confirmed, packed, work = 0.0, [], [], 0, None, None
    for f, args in enumerate(scene):
        if f == 5:  # a mid-scene frame: its kernel inputs, timed below
            work = longest_stream_work([
                lambda si=si: tracker_step(
                    cfg, _stream_slice(st_p, si),
                    *(a[si:si + 1] for a in args), (FRAME_H, FRAME_W))
                for si in range(s)])
        t0 = time.perf_counter()
        st_p, out_p, emit_p = tracker_step(cfg, st_p, *args,
                                           (FRAME_H, FRAME_W))
        p_ms.append((time.perf_counter() - t0) * 1e3)
        dargs = [a.to(dev) for a in args]
        if f == 5:
            packed = TK.pack_inputs(cfg, st_k, *dargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_k, out_k, emit_k = TK.tracker_step_cuda(cfg, st_k, *dargs,
                                                   (FRAME_H, FRAME_W))
        torch.cuda.synchronize()
        k_ms.append((time.perf_counter() - t0) * 1e3)
        if not TK.last_staged:
            raise AssertionError("tracker: the serving shape left shared "
                                 "memory")
        for name in ("state", "hits", "age", "time_since_update", "track_id",
                     "gallery_head", "gallery_count", "next_id"):
            a, b = getattr(st_p, name), getattr(st_k, name).cpu()
            if not torch.equal(a, b):
                raise AssertionError(f"tracker frame {f}: {name} differs")
        if not torch.equal(emit_p, emit_k.cpu()):
            raise AssertionError(f"tracker frame {f}: emit differs")
        if not torch.equal(out_p[..., 4], out_k[..., 4].cpu()):
            raise AssertionError(f"tracker frame {f}: emitted ids differ")
        box_diff = (out_p[..., :4] - out_k[..., :4].cpu()).abs().max().item()
        if box_diff > 1:  # int truncation of a KF mean one ulp apart
            raise AssertionError(f"tracker frame {f}: boxes differ by "
                                 f"{box_diff} px")
        err = max(err, (st_p.mean - st_k.mean.cpu()).abs().max().item())
        confirmed = int((st_p.state == 2).sum())
    if not err <= TOL_TRACKER_MEAN or confirmed == 0:
        raise AssertionError(f"tracker: mean max |err| {err} > "
                             f"{TOL_TRACKER_MEAN} or no confirmed tracks")
    # the kernel alone (the launch is pure: same inputs, same outputs),
    # called from Python and replayed from a CUDA graph; the whole wrapper
    # step and the plain step by host clock, steady-state frames only (the
    # first call also builds the gallery)
    kernel_ms = cuda_ms(lambda: TK.kernel_batched(cfg, *packed), 50)
    device_ms = cuda_graph_ms(lambda: TK.kernel_batched(cfg, *packed), 50)
    note = (f", device {device_ms:.4f} ms, wrapper step "
            f"{float(np.median(k_ms[2:])):.4f} ms (host clock); longest "
            f"stream {work[0]} rows, {work[1]} Dijkstra steps")
    # in: the packed buffers; out: mean, cov, the 7 int planes, next_id
    io_bytes = nbytes(*packed) + nbytes(*packed[9:11]) + 7 * nbytes(
        packed[4]) + nbytes(packed[11])
    return (err, kernel_ms, float(np.median(p_ms[2:])), note, io_bytes,
            chain_entry(work, device_ms))


def _small_setup():
    """The small input of the card-vs-CPU checks: yolov3-tiny at 64 with
    seeded weights aimed at ~12 px boxes, 2 streams of 64x128 frames, the
    f32 detector on the CPU with its objectness on those frames, and makers
    of fresh f32 detectors and bf16 ReID nets."""
    import torch

    from specs.weights_np import random_darknet_weights
    from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES
    from yolo_deepsort_tpu_torch.models.darknet import build_network
    from yolo_deepsort_tpu_torch.models.reid import random_reid_params
    from yolo_deepsort_tpu_torch.ops.letterbox import letterbox_batch
    from yolo_deepsort_tpu_torch.tools.honest_load import plant_box_prior
    from yolo_deepsort_tpu_torch.weights import (
        darknet_from_raw,
        load_darknet_weights,
        reid_from_params,
    )

    h, w, s, size = 64, 128, 2, 64
    plan = build_network(ARCHITECTURES["yolov3-tiny"](img_size=size))
    blob = random_darknet_weights(plan.defs(), seed=0, well_conditioned=True)
    _, raw = load_darknet_weights(blob, plan.defs())
    # ~12 px letterboxed boxes (the prior's heights are 1080p frame pixels),
    # so the crops fit a window of the ladder and the windowed route runs
    raw = plant_box_prior(raw, plan, (h, w), heights=(405.0,), aspect=0.5)
    base = np.random.default_rng(0).integers(0, 256, (s, h, w, 3), np.uint8)
    cpu_det = darknet_from_raw(plan, raw)
    with torch.no_grad():
        obj = cpu_det(letterbox_batch(torch.from_numpy(base), size))[..., 4]
    return dict(
        h=h, w=w, s=s, size=size, base=base, cpu_det=cpu_det, obj=obj,
        det=lambda: darknet_from_raw(plan, raw),
        reid=lambda: reid_from_params(random_reid_params(0)).to(
            torch.bfloat16, memory_format=torch.channels_last))


def check_small_path(dev):
    """The serving step on the card against the same step on the CPU, where
    every kernel wrapper runs its plain version, on a small input
    (``_small_setup``; 3 chunks of K=2, an f32 detector and a bf16 ReID net,
    so all three kernels run on the card). Detect stage:
    mask and stats equal, boxes within TOL_SMALL_BOXES; track stage, both
    sides fed the card's detect outputs: emit and track ids equal, boxes
    within 1 px, and the same bucket and crop window."""
    import torch

    from yolo_deepsort_tpu_torch.config import DetectorConfig, TrackerConfig
    from yolo_deepsort_tpu_torch.parallel.streams import (
        BucketedScannedStep,
        init_stream_states,
    )

    su = _small_setup()
    h, w, s, size, base = (su[n] for n in ("h", "w", "s", "size", "base"))
    k = 2
    cl = torch.channels_last
    frames = torch.from_numpy(np.broadcast_to(base[None], (k, s, h, w, 3))
                              .copy())
    cpu_det = su["cpu_det"]
    # per-stream thresholds halfway between the 6th and 7th objectness, so
    # the two devices' last-bit differences cannot flip a candidate
    top = torch.sort(su["obj"], -1, descending=True).values
    thr = ((top[:, 5] + top[:, 6]) / 2).numpy()

    det_cfg = DetectorConfig(img_size=size, conf_thres=0.5, max_dets=8)
    trk_cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
    kw = dict(buckets=(4, 8), conf_thres_per_stream=thr,
              windows=((16, 16), (32, 40), (48, 64)))
    ref = BucketedScannedStep(cpu_det, su["reid"](), det_cfg, trk_cfg,
                              (h, w), **kw)
    card = BucketedScannedStep(
        su["det"]().to(dev, memory_format=cl),
        su["reid"]().to(dev, memory_format=cl), det_cfg, trk_cfg, (h, w),
        **kw)
    st_ref = init_stream_states(trk_cfg, s, "cpu")
    st_card = init_stream_states(trk_cfg, s, dev)
    frames_dev = frames.to(dev)
    box_err, emitted = 0.0, 0
    for c in range(3):
        h_ref = ref.detect(frames)
        h_card = card.detect(frames_dev)
        b7, mask, stats = (a.cpu() for a in h_card[1:4])
        if not (torch.equal(mask, h_ref[2]) and torch.equal(stats, h_ref[3])):
            raise AssertionError(f"small path chunk {c}: detect mask/stats "
                                 f"differ: {stats.tolist()} vs "
                                 f"{h_ref[3].tolist()}")
        box_err = max(box_err, (b7 - h_ref[1]).abs().max().item())
        if not box_err <= TOL_SMALL_BOXES:
            raise AssertionError(f"small path chunk {c}: boxes differ by "
                                 f"{box_err} > {TOL_SMALL_BOXES}")
        st_ref, (out_r, emit_r) = ref.track(st_ref, (frames, b7, mask, stats))
        st_card, (out_c, emit_c) = card.track(st_card, h_card)
        out_c, emit_c = out_c.cpu(), emit_c.cpu()
        if not (torch.equal(emit_r, emit_c)
                and torch.equal(out_r[..., 4], out_c[..., 4])):
            raise AssertionError(f"small path chunk {c}: emitted tracks "
                                 "differ")
        if (out_r[..., :4] - out_c[..., :4]).abs().max().item() > 1:
            raise AssertionError(f"small path chunk {c}: track boxes differ "
                                 "by more than 1 px")
        if ((card.last_bucket, card.last_window)
                != (ref.last_bucket, ref.last_window)):
            raise AssertionError(f"small path chunk {c}: bucket/window "
                                 "differ")
        emitted += int(emit_c.sum())
    if emitted == 0 or card.last_window == (h, w):
        raise AssertionError("small path: no emitted tracks, or the crops "
                             "took the dense route")
    return box_err, emitted, card.last_bucket, card.last_window


def check_small_k1(dev):
    """The K=1 step on the card against the same step on the CPU on a small
    input (``_small_setup``: yolov3-tiny at 64, 2 streams of 64x128, an f32
    detector and a bf16 ReID net; cap 6, window (48, 64), conv route off),
    4 static frames: emit and track ids exactly equal, boxes within 1 px (a
    Kalman mean an ulp apart truncates to either side)."""
    import torch

    from yolo_deepsort_tpu_torch.config import DetectorConfig, TrackerConfig
    from yolo_deepsort_tpu_torch.parallel.streams import (
        init_stream_states,
        make_batched_step,
    )

    su = _small_setup()
    cl = torch.channels_last
    # one threshold for both streams, in the widest gap of the objectness
    # ranks 8..20, so the devices' last-bit differences flip no candidate
    obj = torch.sort(su["obj"].flatten(), descending=True).values[8:21]
    gap = int(torch.argmax(obj[:-1] - obj[1:]))
    det_cfg = DetectorConfig(img_size=su["size"], max_dets=8,
                             conf_thres=float((obj[gap] + obj[gap + 1]) / 2))
    trk_cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
    hw = (su["h"], su["w"])
    kw = dict(cap=6, crop_window=(48, 64))
    ref = make_batched_step(su["cpu_det"], su["reid"](), det_cfg, trk_cfg, hw,
                            **kw)
    card = make_batched_step(su["det"]().to(dev, memory_format=cl),
                             su["reid"]().to(dev, memory_format=cl),
                             det_cfg, trk_cfg, hw, **kw)
    st_ref = init_stream_states(trk_cfg, su["s"], "cpu")
    st_card = init_stream_states(trk_cfg, su["s"], dev)
    frames = torch.from_numpy(su["base"])
    frames_dev = frames.to(dev)
    emitted = 0
    for f in range(4):
        st_ref, (out_r, emit_r) = ref(st_ref, frames)
        st_card, (out_c, emit_c) = card(st_card, frames_dev)
        out_c, emit_c = out_c.cpu(), emit_c.cpu()
        if not (torch.equal(emit_r, emit_c)
                and torch.equal(out_r[..., 4], out_c[..., 4])):
            raise AssertionError(f"small K=1 frame {f}: emitted tracks "
                                 "differ between the card and the CPU")
        if (out_r[..., :4] - out_c[..., :4]).abs().max().item() > 1:
            raise AssertionError(f"small K=1 frame {f}: boxes differ by more "
                                 "than 1 px")
        for name in ("state", "hits", "age", "time_since_update", "track_id",
                     "gallery_head", "gallery_count", "next_id"):
            if not torch.equal(getattr(st_ref, name),
                               getattr(st_card, name).cpu()):
                raise AssertionError(f"small K=1 frame {f}: {name} differs")
        emitted += int(emit_c.sum())
    if emitted == 0:
        raise AssertionError("small K=1: no emitted tracks")
    return emitted


def conv_shape_classes(dev):
    """The distinct eligible conv shapes of yolov3-416 at batch STREAMS, as
    the model's own forward presents them to the conv hook: {(hi, ci, co, k,
    stride, act): [module indices]} (15 classes over 65 layers)."""
    import torch

    from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES
    from yolo_deepsort_tpu_torch.models.darknet import Darknet, build_network
    from yolo_deepsort_tpu_torch.ops.conv_kernel import backbone_conv_eligible

    plan = build_network(ARCHITECTURES["yolov3"](img_size=416))
    model = Darknet(plan).to(dev, torch.bfloat16,
                             memory_format=torch.channels_last).eval()
    classes = {}

    def record(x, w, b, stride, pad, act, idx):
        hi, wi, ci = (int(v) for v in x.shape[1:])
        k, co = int(w.shape[0]), int(w.shape[3])
        if pad == (k - 1) // 2 and backbone_conv_eligible(hi, wi, ci, co, k,
                                                          stride, act):
            classes.setdefault((hi, ci, co, k, stride, act), []).append(idx)
        return None

    with torch.no_grad():
        model(torch.zeros((STREAMS, 416, 416, 3), dtype=torch.bfloat16,
                          device=dev), conv_impl=record)
    return classes


def _bf16_ulps(got, want):
    import torch

    ulp = torch.exp2(torch.floor(torch.log2(
        want.abs().clamp(min=CONV_ULP_FLOOR))) - 7)
    return float(((got - want).abs() / ulp).max())


def _conv_case(rng, dev, n, hi, ci, co, k):
    """Seeded operands of one conv shape on the card: x ~ N(0, 1) as bf16
    and as the f32 it was rounded from, w ~ N(0, 1/K) as bf16 HWIO and as an
    int8 package with its scales."""
    import torch

    x = torch.from_numpy(rng.standard_normal((n, hi, hi, ci), np.float32))
    w = (rng.standard_normal((k, k, ci, co), np.float32)
         / np.sqrt(k * k * ci)).astype(np.float32)
    b = torch.from_numpy(rng.standard_normal((co,), np.float32)).to(dev)
    wscale = (np.abs(w).reshape(-1, co).max(0) / 127.0).astype(np.float32)
    wq = np.clip(np.rint(w / wscale), -127, 127).astype(np.int8)
    xscale = np.float32(float(x.abs().max()) / 127.0)
    return dict(
        x=x.to(dev, torch.bfloat16), x32=x.to(dev), b=b,
        w=torch.from_numpy(w).to(dev, torch.bfloat16),
        wq=torch.from_numpy(wq).to(dev),
        scale=torch.from_numpy(xscale * wscale).to(dev),
        xinv=np.float32(1.0 / xscale))


def check_conv(rng, dev):
    """Kernel 7 against its plain versions at every distinct eligible conv
    shape of yolov3-416 at batch 8 (15 classes) plus one mish shape: bf16
    mode within TOL_CONV_ULPS bf16 ulps, int8 mode exactly equal: with bf16
    activations at every class, and with f32 activations (the kernel's third
    instantiation, which quantizes f32 in the tile load) at the Co=255
    heads, the stride-2 classes, the 3x3 classes at 26x26 and the mish
    shape. Times per class, on two clocks: ``called_*``, the kernel in both
    modes called from Python 50 times back to back between two events
    (``cuda_ms``, the clock of every kernel's ``ms``; host-bound where the
    kernel is shorter than its wrapper), and ``ms_*``, the device time of
    the same 50 calls replayed from a CUDA graph (``cuda_graph_ms``); the
    plain versions; and as a yardstick one library call on both clocks --
    ``F.conv2d`` with bias on the same channels_last bf16 tensors, then the
    activation -- which the port's route never calls. Returns {class:
    {...}} with each class's layers, times, bounds and errors, and per mode
    the tile plan taken (``plan_conv_tiles``: BM, BN, stages, split), the
    rate reached and the share of the bound (both from the device time)."""
    import torch
    import torch.nn.functional as F

    from yolo_deepsort_tpu_torch.ops import conv_kernel as CV
    from yolo_deepsort_tpu_torch.ops.conv_plan import plan_for

    classes = conv_shape_classes(dev)
    if len(classes) != 15 or sum(len(v) for v in classes.values()) != 65:
        raise AssertionError(f"expected 15 eligible conv shape classes over "
                             f"65 layers, found {len(classes)}")
    cases = [(key, layers) for key, layers in classes.items()]
    cases.append(((26, 256, 512, 3, 1, "mish"), []))
    out = {}
    for (hi, ci, co, k, stride, act), layers in cases:
        c = _conv_case(rng, dev, STREAMS, hi, ci, co, k)
        kw = dict(stride=stride, pad=(k - 1) // 2, act=act)
        got = CV.conv_bf16(c["x"], c["w"], c["b"], **kw)
        want = CV.conv_plain_bf16(c["x"], c["w"], c["b"], **kw)
        torch.cuda.synchronize()
        ulps = _bf16_ulps(got.float(), want.float())
        err = float((got.float() - want.float()).abs().max())
        if got.shape != want.shape or not ulps <= TOL_CONV_ULPS:
            raise AssertionError(f"conv bf16 {hi, ci, co, k, stride, act}: "
                                 f"{ulps} bf16 ulps > {TOL_CONV_ULPS} (max "
                                 f"|err| {err})")
        q_args = (c["x"], c["wq"], c["b"], c["scale"], c["xinv"])
        got8 = CV.conv_int8(*q_args, **kw)
        want8 = CV.conv_plain_int8(*q_args, **kw)
        torch.cuda.synchronize()
        err8 = float((got8.float() - want8.float()).abs().max())
        same = (torch.equal(got8, want8) if act != "mish" else
                _bf16_ulps(got8.float(), want8.float()) <= 1)
        if not same or not bool(want8.float().abs().max() > 0):
            raise AssertionError(f"conv int8 {hi, ci, co, k, stride, act}: "
                                 f"differs from its plain version (max |err| "
                                 f"{err8})")
        err32 = ms32 = None
        if co == 255 or stride == 2 or (k == 3 and hi == 26):
            f_args = (c["x32"],) + q_args[1:]
            got32 = CV.conv_int8(*f_args, **kw)
            want32 = CV.conv_plain_int8(*f_args, **kw)
            torch.cuda.synchronize()
            err32 = float((got32.float() - want32.float()).abs().max())
            same = (torch.equal(got32, want32) if act != "mish" else
                    _bf16_ulps(got32.float(), want32.float()) <= 1)
            if not same or torch.equal(got32, got8):
                raise AssertionError(
                    f"conv int8 with f32 activations "
                    f"{hi, ci, co, k, stride, act}: differs from its plain "
                    f"version (max |err| {err32}), "
                    "or took the bf16 activations")
            ms32 = cuda_graph_ms(lambda: CV.conv_int8(*f_args, **kw), 50)
        # the library yardstick, on the layouts a channels_last model holds
        x_cl = c["x"].permute(0, 3, 1, 2)
        w_cl = c["w"].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        b16 = c["b"].to(torch.bfloat16)

        def library():
            y = F.conv2d(x_cl, w_cl, b16, stride=stride, padding=kw["pad"])
            return F.leaky_relu_(y, 0.1) if act == "leaky" else (
                F.mish(y) if act == "mish" else y)

        ho = hi // stride
        m, depth = STREAMS * ho * ho, k * k * ci
        ops = 2.0 * m * depth * co
        io = nbytes(c["x"], c["b"], got)
        r = dict(
            layers=layers, ulps=ulps, err_bf16=err, err_int8=err8,
            err_int8_f32=err32, ms_int8_f32=ms32,
            ms_bf16=cuda_graph_ms(lambda: CV.conv_bf16(
                c["x"], c["w"], c["b"], **kw), 50),
            ms_int8=cuda_graph_ms(lambda: CV.conv_int8(*q_args, **kw), 50),
            called_bf16=cuda_ms(lambda: CV.conv_bf16(
                c["x"], c["w"], c["b"], **kw), 50),
            called_int8=cuda_ms(lambda: CV.conv_int8(*q_args, **kw), 50),
            plain_bf16=cuda_ms(lambda: CV.conv_plain_bf16(
                c["x"], c["w"], c["b"], **kw), 5),
            plain_int8=cuda_ms(lambda: CV.conv_plain_int8(*q_args, **kw), 2),
            library=cuda_graph_ms(library, 50),
            library_called=cuda_ms(library, 50),
            bound_bf16=roofline(io + nbytes(c["w"]), ops, "bf16"),
            bound_int8=roofline(io + nbytes(c["wq"], c["scale"]), ops,
                                "int8"))
        for mode, es in (("bf16", 2), ("int8", 1)):
            # the plan the wrapper took, the rate reached (T operations/s)
            # and the share of the bound
            r[f"plan_{mode}"] = tuple(plan_for(dev, m, co, depth, es,
                                               quantizing=es == 1))
            r[f"tops_{mode}"] = ops / r[f"ms_{mode}"] * 1e-9
            r[f"share_{mode}"] = r[f"bound_{mode}"][0] / r[f"ms_{mode}"]
        out[(hi, ci, co, k, stride, act)] = r
    return out


def bf16_layer_shapes(model, x):
    """Every conv a bf16 model's forward of ``x`` runs through
    ``models/layers.conv_layer_bf16`` (kernel 7 on the card), as {(n, hi,
    wi, ci, co, k, stride, act, out f32, residual dtype name or None):
    [layer numbers in call order]}."""
    import torch

    from yolo_deepsort_tpu_torch.models import darknet, reid

    shapes, count = {}, [0]

    def recorded(conv, xin, act, out_dtype=torch.bfloat16, residual=None):
        n, hi, wi, ci = (int(v) for v in xin.shape)
        key = (n, hi, wi, ci, conv.out_channels, conv.kernel_size[0],
               conv.stride[0], act, out_dtype == torch.float32,
               None if residual is None else str(residual.dtype)[6:])
        shapes.setdefault(key, []).append(count[0])
        count[0] += 1
        return layer_bf16(conv, xin, act, out_dtype, residual)

    layer_bf16 = darknet.conv_layer_bf16
    darknet.conv_layer_bf16 = reid.conv_layer_bf16 = recorded
    try:
        with torch.no_grad():
            model(x)
    finally:
        darknet.conv_layer_bf16 = reid.conv_layer_bf16 = layer_bf16
    return shapes


def check_bf16_rounding(rng, dev):
    """Kernel 7 at every conv shape the default bf16 forwards give it that
    ``check_conv`` does not cover: the convs of yolov3-416 at batch 8 off
    the eligible classes (layer 0 with its 3 input channels zero-padded to
    8, the 416, 208 and 104 maps, Ci 32-128), and every conv of both ReID
    nets at the K=1 step's embed of EMBED_CROPS crops -- the ReLU and ELU
    codes, the residual form of each block's second conv (a shortcut ~ N(0,
    1) in its dtype) and the f32-output form of each projection shortcut.
    Each against its plain version on the same
    operands (x ~ N(0, 1), w ~ N(0, 1/K), b ~ N(0, 1)): bf16 outputs within
    TOL_CONV_ULPS, f32 outputs within TOL_CONV_F32; timed on both clocks
    beside the library's bf16 conv + activation on the same tensors (a
    yardstick: the repair needs the kernel's f32 sums whatever it costs).
    Then the small bf16 detector (yolov3-tiny at 64, 2 frames) and both
    ReID nets (24 crops) on the card against their plain forwards on the
    CPU. Returns ({"detector" | "reid512" | "reid128": {shape: record}},
    {small check: numbers})."""
    import torch
    import torch.nn.functional as F

    from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES
    from yolo_deepsort_tpu_torch.models.darknet import Darknet, build_network
    from yolo_deepsort_tpu_torch.models.reid import (
        random_original_reid_params,
        random_reid_params,
    )
    from yolo_deepsort_tpu_torch.ops import conv_kernel as CV
    from yolo_deepsort_tpu_torch.ops.conv_plan import plan_for
    from yolo_deepsort_tpu_torch.weights import reid_from_params

    cl = torch.channels_last
    covered = {(hi, ci, co, k, stride, act)
               for (hi, ci, co, k, stride, act) in conv_shape_classes(dev)}
    det = Darknet(build_network(ARCHITECTURES["yolov3"](img_size=416))).to(
        dev, torch.bfloat16, memory_format=cl).eval()
    nets = {"detector": bf16_layer_shapes(det, torch.zeros(
        (STREAMS, 416, 416, 3), dtype=torch.bfloat16, device=dev))}
    if sum(len(v) for v in nets["detector"].values()) != len(det.convs):
        raise AssertionError("the bf16 detector ran a conv past kernel 7")
    nets["detector"] = {k: v for k, v in nets["detector"].items()
                        if (k[1], k[3], k[4], k[5], k[6], k[7])
                        not in covered}
    del det
    crops = torch.zeros((EMBED_CROPS, 128, 64, 3), dtype=torch.bfloat16,
                        device=dev)
    for name, params in (("reid512", random_reid_params(0)),
                         ("reid128", random_original_reid_params(0))):
        net = reid_from_params(params).to(dev, torch.bfloat16,
                                          memory_format=cl)
        nets[name] = bf16_layer_shapes(net, crops)
    out = {}
    for net_name, shapes in nets.items():
        out[net_name] = {}
        for key, layers in shapes.items():
            n, hi, wi, ci, co, k, stride, act, f32_out, res = key
            x = torch.from_numpy(rng.standard_normal(
                (n, hi, wi, ci), np.float32)).to(dev, torch.bfloat16)
            w = torch.from_numpy((rng.standard_normal((k, k, ci, co),
                                                      np.float32)
                                  / np.sqrt(k * k * ci)).astype(np.float32)
                                 ).to(dev, torch.bfloat16)
            b = torch.from_numpy(rng.standard_normal((co,), np.float32)).to(
                dev)
            pad_c = (-ci) % 8  # layer 0: 3 channels, zero-padded to 8
            xk = F.pad(x, (0, pad_c)).contiguous() if pad_c else x
            wk = F.pad(w, (0, 0, 0, pad_c)).contiguous() if pad_c else w
            kw = dict(stride=stride, pad=(k - 1) // 2, act=act,
                      out_dtype=torch.float32 if f32_out else torch.bfloat16)
            if res is not None:
                kw["residual"] = torch.from_numpy(rng.standard_normal(
                    (n, hi // stride, wi // stride, co), np.float32)).to(
                    dev, getattr(torch, res))
            got = CV.conv_bf16(xk, wk, b, **kw)
            want = CV.conv_plain_bf16(x, w, b, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if f32_out:
                held = float(((got - want).abs() / want.abs().clamp(min=1.0))
                             .max())
                ok = got.dtype == torch.float32 and held <= TOL_CONV_F32
            else:
                held = _bf16_ulps(got.float(), want.float())
                ok = got.dtype == torch.bfloat16 and held <= TOL_CONV_ULPS
            if got.shape != want.shape or not ok:
                raise AssertionError(f"conv {net_name} {key}: {held} > bound "
                                     f"(max |err| {err})")
            x_cl = x.permute(0, 3, 1, 2)
            w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=cl)
            b16 = b.to(torch.bfloat16)

            def library():
                y = F.conv2d(x_cl, w_cl, b16, stride=stride,
                             padding=kw["pad"])
                return CV.apply_act(y, act)

            m, depth = int(np.prod(got.shape[:3])), k * k * (ci + pad_c)
            ops = 2.0 * m * k * k * ci * co
            io = nbytes(x, b, got, w, *([kw["residual"]] if res else []))
            out[net_name][key] = dict(
                layers=layers, held=held, err=err,
                device_ms=cuda_graph_ms(lambda: CV.conv_bf16(xk, wk, b, **kw),
                                        20),
                ms=cuda_ms(lambda: CV.conv_bf16(xk, wk, b, **kw), 20),
                plain_ms=cuda_ms(lambda: CV.conv_plain_bf16(x, w, b, **kw),
                                 2),
                library_device_ms=cuda_graph_ms(library, 20),
                library_ms=cuda_ms(library, 20),
                bound=roofline(io, ops, "bf16"),
                plan=tuple(plan_for(dev, m, co, depth, 2)))
    return out, check_small_bf16_nets(dev)


def check_small_bf16_nets(dev):
    """The small bf16 detector (``_small_setup``'s yolov3-tiny at 64, its
    2 frames) and both bf16 ReID nets (24 seeded N(0, 1) crops) on the card
    (kernel 7 on every conv) against the same nets on the CPU (its plain
    version), which round at the same points and sum in another order:
    decoded boxes within TOL_BF16_BOXES px, objectness within TOL_BF16_OBJ,
    at most MAX_BF16_DIFFER of the decoded values differing; features
    within TOL_BF16_REID[layout]. Returns the measured numbers."""
    import torch

    from yolo_deepsort_tpu_torch.models.reid import (
        random_original_reid_params,
        random_reid_params,
    )
    from yolo_deepsort_tpu_torch.ops import conv_kernel
    from yolo_deepsort_tpu_torch.ops.letterbox import letterbox_batch
    from yolo_deepsort_tpu_torch.weights import reid_from_params

    su = _small_setup()
    x = letterbox_batch(torch.from_numpy(su["base"]), su["size"]).to(
        torch.bfloat16)
    cpu = su["det"]().to(torch.bfloat16)
    card = su["det"]().to(dev, torch.bfloat16,
                          memory_format=torch.channels_last)
    conv_kernel.launches = 0
    with torch.no_grad():
        want = cpu(x)
        got = card(x.to(dev)).cpu()
    res = {"detector_k7_launches": conv_kernel.launches,
           "boxes": float((got[..., :4] - want[..., :4]).abs().max()),
           "obj": float((got[..., 4] - want[..., 4]).abs().max()),
           "differ": float((got != want).float().mean())}
    if res["detector_k7_launches"] != len(card.convs):
        raise AssertionError(f"small bf16 detector: {res} K7 launches, "
                             f"expected {len(card.convs)}")
    crops = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (24, 128, 64, 3)).astype(np.float32)).to(torch.bfloat16)
    for name, params in (("512", random_reid_params(0)),
                         ("128", random_original_reid_params(0))):
        net = reid_from_params(params)
        with torch.no_grad():
            want = net.to(torch.bfloat16)(crops)
            got = net.to(dev, memory_format=torch.channels_last)(
                crops.to(dev)).cpu()
        res[f"reid{name}"] = float((got - want).abs().max())
    if (res["boxes"] > TOL_BF16_BOXES or res["obj"] > TOL_BF16_OBJ
            or res["differ"] > MAX_BF16_DIFFER
            or any(res[f"reid{n}"] > t for n, t in TOL_BF16_REID.items())):
        raise AssertionError(f"small bf16 nets card vs CPU: {res}")
    return res


def conv_kernel_entry(per_class, rounding, launches):
    """K7's entry of the ``kernels`` line. Its times are those of the
    default bf16 path of one K=1 step: every conv of the yolov3-416
    detector at batch 8 and of the 512-d ReID embed of EMBED_CROPS crops,
    each layer's shape time in bf16 mode (``check_conv``'s classes, the
    other shapes from ``check_bf16_rounding``), summed, with the plain,
    bound and library times of the same layers likewise. ``ms`` and
    ``library_ms`` are on the clock of every other kernel's (called from
    Python back to back, ``cuda_ms``); ``device_ms`` and
    ``library_device_ms`` are the same sums of device time
    (``cuda_graph_ms``). ``route_k1`` keeps the earlier totals over the
    K=1 step's routed layers (CONV_ROUTE, each in the mode it is routed
    in). ``per_shape`` lists every eligible class in both modes,
    ``per_shape_default_path`` every other shape of the default path and
    of the 128-d ReID net, with the held error (bf16 ulps, or relative for
    the f32-output form). ``launches``: {path: count} of the counted
    runs."""
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
               device_ms=0.0, library_device_ms=0.0)
    by = {"operations": 0.0, "bytes": 0.0}  # bound ms by what bounds a layer

    def add(n, ms, device_ms, plain_ms, bound, library_ms, library_device):
        tot["ms"] += n * ms
        tot["device_ms"] += n * device_ms
        tot["plain_ms"] += n * plain_ms
        tot["bound_ms"] += n * bound[0]
        tot["library_ms"] += n * library_ms
        tot["library_device_ms"] += n * library_device
        by[bound[1]] += n * bound[0]

    for r in per_class.values():
        add(len(r["layers"]), r["called_bf16"], r["ms_bf16"],
            r["plain_bf16"], r["bound_bf16"], r["library_called"],
            r["library"])
    for net in ("detector", "reid512"):
        for r in rounding[net].values():
            add(len(r["layers"]), r["ms"], r["device_ms"], r["plain_ms"],
                r["bound"], r["library_ms"], r["library_device_ms"])
    by_layer = {idx: r for r in per_class.values() for idx in r["layers"]}
    route = dict(ms=0.0, device_ms=0.0, library_ms=0.0,
                 library_device_ms=0.0)
    for mode in ("bf16", "int8"):
        for idx in CONV_ROUTE[mode]:
            r = by_layer[idx]
            route["ms"] += r[f"called_{mode}"]
            route["device_ms"] += r[f"ms_{mode}"]
            route["library_ms"] += r["library_called"]
            route["library_device_ms"] += r["library"]
    shapes = [{
        "shape": list(key), "layers": r["layers"],
        "ms_bf16": r["called_bf16"], "ms_int8": r["called_int8"],
        "device_ms_bf16": r["ms_bf16"], "device_ms_int8": r["ms_int8"],
        "plain_ms_bf16": r["plain_bf16"], "plain_ms_int8": r["plain_int8"],
        "library_ms": r["library_called"], "library_device_ms": r["library"],
        "bound_ms_bf16": r["bound_bf16"][0], "bound_ms_int8":
        r["bound_int8"][0], "bound_by": r["bound_bf16"][1],
        "bf16_ulps": r["ulps"], "max_abs_err_bf16": r["err_bf16"],
        "max_abs_err_int8": r["err_int8"],
        "max_abs_err_int8_f32_input": r["err_int8_f32"],
        "device_ms_int8_f32_input": r["ms_int8_f32"],
        "plan_bf16": list(r["plan_bf16"]), "plan_int8": list(r["plan_int8"]),
        "tera_ops_per_s_bf16": r["tops_bf16"],
        "tera_ops_per_s_int8": r["tops_int8"],
        "bound_share_bf16": r["share_bf16"],
        "bound_share_int8": r["share_int8"]}
        for key, r in per_class.items()]
    default_shapes = [{
        "net": net, "shape": list(key), "layers": len(r["layers"]),
        "held": r["held"], "max_abs_err": r["err"], "ms": r["ms"],
        "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
        "library_ms": r["library_ms"],
        "library_device_ms": r["library_device_ms"],
        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "plan": list(r["plan"])}
        for net, recs in rounding.items() for key, r in recs.items()]
    errs = {form: max([r["err"] for recs in rounding.values()
                       for key, r in recs.items() if pick(key)] or [0.0])
            for form, pick in (
                ("relu_elu", lambda k: k[7] in ("relu", "elu") and not k[8]),
                ("f32_out", lambda k: k[8]),
                ("residual", lambda k: k[9] is not None))}
    return {
        "name": "conv", "route": "cuda",
        "source": "yolo_deepsort_tpu_torch/csrc/conv.cu",
        "replaces": "yolo_deepsort_tpu/ops/pallas_conv.py:74",
        "launches": launches["main"],
        "launches_k1_path": launches["k1"],
        "max_abs_err": max(r["err_bf16"] for r in per_class.values()),
        "max_abs_err_relu_elu": errs["relu_elu"],
        "max_abs_err_f32_out": errs["f32_out"],
        "max_abs_err_residual": errs["residual"],
        **tot,
        "bound_by": max(by, key=by.get),
        "route_k1": route,
        "per_shape": shapes,
        "per_shape_default_path": default_shapes,
    }


def _reid_layer_epilogue(name):
    """(relu, out_int8, residual) of a quantized ReID conv by its name:
    conv1 ReLU; the shortcut conv neither; conv2 ReLU after the residual;
    the last conv2 emits f32."""
    if name.endswith("d"):
        return False, True, False
    if name.endswith("c1"):
        return True, True, False
    return True, name != "l3b1c2", True


def check_conv_int8(rng, dev, n=EMBED_CROPS):
    """Kernel 8 against ``conv_int8_plain`` at the nine shape classes of one
    embed (``REID_INT8_CLASSES``) of ``n`` crops (the K=1 step's EMBED_CROPS,
    or a chunk's K x S x bucket), in every epilogue the class's layers use: int8 codes exactly equal, the f32 output within
    TOL_CONV_INT8_F32 relative. Times per class and epilogue on two clocks
    (``called``: 50 calls from Python back to back, ``cuda_ms``, the clock
    of every kernel's ``ms``; ``ms``: the device time of the same calls
    replayed from a CUDA graph, ``cuda_graph_ms``), the plain version (mean
    of 2), the bound (int8 peak), and as a yardstick only the bf16
    ``F.conv2d`` (with bias) of the same layer on channels_last tensors, on
    both clocks. Returns {layer name: {...}}, with the tile plan taken (BM,
    BN, stages, split), the rate reached (T operations/s) and the share of
    the bound (both from the device time)."""
    import torch
    import torch.nn.functional as F

    from yolo_deepsort_tpu_torch.ops import conv_int8_kernel as C8
    from yolo_deepsort_tpu_torch.ops.conv_plan import plan_for

    out = {}
    for layers, k, stride, hi, wi, ci, co in REID_INT8_CLASSES:
        ho, wo = hi // stride, wi // stride
        plan = tuple(plan_for(dev, n * ho * wo, co, k * k * ci, 1))
        xq = torch.from_numpy(rng.integers(
            -127, 128, (n, hi, wi, ci)).astype(np.int8)).to(dev)
        w = (rng.standard_normal((k, k, ci, co), np.float32)
             / np.sqrt(k * k * ci)).astype(np.float32)
        wscale = (np.abs(w).reshape(-1, co).max(0) / 127.0).astype(np.float32)
        wq = torch.from_numpy(np.clip(np.rint(w / wscale), -127, 127).astype(
            np.int8)).to(dev)
        # codes ~U(-127, 127) stand for activations of scale 0.02; the
        # output requantizes at a scale that keeps it off the clip
        scale = torch.from_numpy(np.float32(0.02) * wscale).to(dev)
        b = torch.from_numpy(rng.normal(0, 0.1, co).astype(np.float32)).to(dev)
        oinv, res_scale = np.float32(1.0 / 0.05), np.float32(0.03)
        res = torch.from_numpy(rng.integers(
            -127, 128, (n, ho, wo, co)).astype(np.int8)).to(dev)
        x_cl = (xq.float() * 0.02).to(torch.bfloat16).permute(0, 3, 1, 2)
        w_cl = torch.from_numpy(w).to(dev, torch.bfloat16).permute(
            3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b16 = b.to(torch.bfloat16)
        def library_call():
            return F.conv2d(x_cl, w_cl, b16, stride=stride,
                            padding=(k - 1) // 2)

        library = cuda_graph_ms(library_call, 50)
        library_called = cuda_ms(library_call, 50)
        ops = 2.0 * n * ho * wo * k * k * ci * co
        done = {}
        for name in layers:
            relu, out_int8, has_res = epi = _reid_layer_epilogue(name)
            if epi not in done:
                args = (xq, wq, scale, b, oinv, res if has_res else None,
                        res_scale if has_res else None)
                kw = dict(stride=stride, pad=(k - 1) // 2, relu=relu,
                          out_int8=out_int8)
                got = C8.conv_int8(*args, **kw)
                want = C8.conv_int8_plain(*args, **kw)
                torch.cuda.synchronize()
                tag = (f"conv_int8 N={n} {k}x{k} s{stride} {hi}x{wi} {ci}->"
                       f"{co} relu={relu} int8={out_int8} residual={has_res}")
                if got.shape != want.shape or got.dtype != want.dtype:
                    raise AssertionError(f"{tag}: {got.shape} {got.dtype}")
                if not bool(want.float().abs().max() > 0):
                    raise AssertionError(f"{tag}: all-zero reference")
                err = float((got.float() - want.float()).abs().max())
                ok = (torch.equal(got, want) if out_int8 else bool(
                    ((got - want).abs() <= TOL_CONV_INT8_F32
                     * want.abs().clamp(min=1e-3)).all()))
                if not ok:
                    raise AssertionError(f"{tag}: differs from its plain "
                                         f"version (max |err| {err})")
                io = nbytes(xq, wq, scale, b, got) + (nbytes(res) if has_res
                                                      else 0)
                done[epi] = dict(
                    err=err, bound=roofline(io, ops, "int8"),
                    ms=cuda_graph_ms(lambda: C8.conv_int8(*args, **kw), 50),
                    called=cuda_ms(lambda: C8.conv_int8(*args, **kw), 50),
                    plain_ms=cuda_ms(lambda: C8.conv_int8_plain(*args, **kw),
                                     2))
                done[epi]["tops"] = ops / done[epi]["ms"] * 1e-9
                done[epi]["share"] = done[epi]["bound"][0] / done[epi]["ms"]
            out[name] = dict(done[epi], library=library,
                             library_called=library_called, relu=relu,
                             out_int8=out_int8, residual=has_res, plan=plan,
                             shape=[k, stride, hi, wi, ci, co])
    return out


def _conv_int8_embed_totals(per_layer):
    """The 15 launches of one embed, summed: kernel, plain, bound and
    library (bf16 ``F.conv2d``) times, and each layer's own numbers. ``ms``
    and ``library_ms`` are on the clock of every other kernel's (called
    from Python back to back); ``device_ms`` and ``library_device_ms`` are
    the same sums of device time."""
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
               device_ms=0.0, library_device_ms=0.0)
    by = {"operations": 0.0, "bytes": 0.0}
    for r in per_layer.values():
        tot["ms"] += r["called"]
        tot["device_ms"] += r["ms"]
        tot["plain_ms"] += r["plain_ms"]
        tot["bound_ms"] += r["bound"][0]
        tot["library_ms"] += r["library_called"]
        tot["library_device_ms"] += r["library"]
        by[r["bound"][1]] += r["bound"][0]
    return {
        "max_abs_err": max(r["err"] for r in per_layer.values()),
        **tot, "bound_by": max(by, key=by.get),
        "per_layer": [{
            "layer": name, "shape": r["shape"], "relu": r["relu"],
            "out_int8": r["out_int8"], "residual": r["residual"],
            "ms": r["called"], "device_ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_called"],
            "library_device_ms": r["library"], "max_abs_err": r["err"],
            "plan": list(r["plan"]), "tera_ops_per_s": r["tops"],
            "bound_share": r["share"]}
            for name, r in per_layer.items()],
    }


def conv_int8_kernel_entry(per_layer, launches, launches_k1, chunk_crops,
                           per_layer_chunk):
    """K8's entry of the ``kernels`` line: its times are those of one embed
    of EMBED_CROPS crops (the K=1 step's), and under ``at_chunk_crops``
    those of one embed of ``chunk_crops`` crops (the chunked step's)."""
    return {
        "name": "conv_int8", "route": "cuda",
        "source": "yolo_deepsort_tpu_torch/csrc/conv_int8.cu",
        "replaces": "yolo_deepsort_tpu/ops/pallas_conv_int8.py:59",
        "launches": launches, "launches_k1_path": launches_k1,
        **_conv_int8_embed_totals(per_layer),
        "at_chunk_crops": {"crops": chunk_crops,
                           **_conv_int8_embed_totals(per_layer_chunk)},
    }


def reid_int8_package(dev):
    """The int8-resident package of the seeded ReID weights, calibrated on
    the card from 64 seeded N(0, 1) crops (the reference bench's calibration
    input), as the numpy package and as device tensors with a bf16 front."""
    from yolo_deepsort_tpu_torch.models.quantize import (
        quantize_reid_params_resident,
    )
    from yolo_deepsort_tpu_torch.models.reid import random_reid_params
    from yolo_deepsort_tpu_torch.weights import reid_int8_package_to_torch

    calib = np.random.default_rng(5).normal(0, 1, (64, 128, 64, 3)).astype(
        np.float32)
    pkg = quantize_reid_params_resident(random_reid_params(0), calib)
    on_card = reid_int8_package_to_torch(pkg)  # the card by default
    if on_card["in_scale"].device != dev:
        raise AssertionError("the int8 package did not take the card")
    return pkg, on_card


def check_small_reid_int8(dev):
    """``reid_apply_int8_resident`` with kernel 8 on the card against the
    same package on the CPU (kernel 8's plain version), 24 seeded crops, a
    bf16 front on both: features finite, (24, 512), minimum cosine above
    MIN_COS_REID_INT8; on the card the kernel route and the plain route
    (same front) give features within 1e-6."""
    import torch

    from yolo_deepsort_tpu_torch.models.quantize import (
        reid_apply_int8_resident,
    )
    from yolo_deepsort_tpu_torch.ops import conv_int8_kernel
    from yolo_deepsort_tpu_torch.weights import reid_int8_package_to_torch

    pkg, on_card = reid_int8_package(dev)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (24, 128, 64, 3)).astype(np.float32))
    before = conv_int8_kernel.launches
    card = reid_apply_int8_resident(on_card, x.to(dev), use_pallas=True)
    launched = conv_int8_kernel.launches - before
    plain = reid_apply_int8_resident(on_card, x.to(dev))
    cpu = reid_apply_int8_resident(reid_int8_package_to_torch(pkg, "cpu"), x,
                                   use_pallas=True)
    cos = float((card.cpu() * cpu).sum(1).min())
    twin = float((card - plain).abs().max())
    if (card.shape != (24, 512) or not bool(torch.isfinite(card).all())
            or launched != N_INT8_CONVS or not cos > MIN_COS_REID_INT8
            or not twin <= 1e-6):
        raise AssertionError(f"int8-resident embed card vs CPU: shape "
                             f"{tuple(card.shape)}, {launched} K8 launches, "
                             f"min cosine {cos}, kernel vs plain route on "
                             f"the card {twin}")
    return cos, twin


def check_nms(dev, setup):
    """The batched NMS kernel against its plain version on the main path's
    decoded output: yolov3-416 bf16 over the K x S = 32 frames of the
    chunk (N 32, B 10647, C 80, max_boxes 512), (a) at the calibrated
    per-stream thresholds, max_dets 64 (~32 detections a frame); (b) the
    K=1 step's 8 frames at cap 40; (c) saturated: per image the
    NMS_SATURATED_TOP-th largest objectness as threshold (top-k drops
    candidates, max_dets fills with some left); (d) ties: (c) with obj and
    class scores rounded to 1/16 (exact score ties across the top-k
    boundary, class argmax ties). Times (a) and (b) on both clocks beside
    the plain version. -> the phase loop's record."""
    import torch

    from yolo_deepsort_tpu_torch.ops import nms_kernel as NK
    from yolo_deepsort_tpu_torch.ops.letterbox_kernel import (
        letterbox_batch_fused,
    )
    from yolo_deepsort_tpu_torch.ops.nms import batched_nms_with_stats_plain

    _, _, frames, parts = setup
    k, s = frames.shape[:2]
    with torch.no_grad():
        dec = parts["detector"](letterbox_batch_fused(
            frames.reshape(k * s, FRAME_H, FRAME_W, 3), 416,
            torch.bfloat16)).float()
    thr = torch.as_tensor(parts["conf_vec"], device=dev).repeat(k)
    sat_thr = torch.sort(dec[..., 4], -1, descending=True).values[
        :, NMS_SATURATED_TOP - 1].contiguous()
    ties = dec.clone()
    ties[..., 4:] = (ties[..., 4:] * 16).round() / 16
    cases = {"calibrated": (dec, thr, 64), "k1": (dec[:s], thr[:s], K1_CAP),
             "saturated": (dec, sat_thr, 64), "ties": (ties, sat_thr, 64)}
    errs, outs = {}, {}
    for name, (pred, conf, max_dets) in cases.items():
        args = (pred, conf, 0.4, 512, max_dets)
        outs[name] = NK.nms_cuda(*args)
        why, errs[name] = NK.mismatch(outs[name],
                                      batched_nms_with_stats_plain(*args))
        if why:
            raise AssertionError(f"nms kernel, case {name}: {why}")
    sat = outs["saturated"][2]
    if not (bool((sat[:, 0] > 0).all()) and bool((sat[:, 1] > 0).any())):
        raise AssertionError(f"nms saturated case: sat {sat.tolist()}")
    dets_per_frame = float(outs["calibrated"][1].sum()) / (k * s)

    def run(name):
        pred, conf, max_dets = cases[name]
        return lambda: NK.nms_cuda(pred, conf, 0.4, 512, max_dets)

    def plain(name):
        pred, conf, max_dets = cases[name]
        return lambda: batched_nms_with_stats_plain(pred, conf, 0.4, 512,
                                                    max_dets)

    ms, device_ms = cuda_ms(run("calibrated"), 50), cuda_graph_ms(
        run("calibrated"), 20)
    plain_ms = cuda_ms(plain("calibrated"), 5)
    k1_ms, k1_device_ms = cuda_ms(run("k1"), 50), cuda_graph_ms(run("k1"), 20)
    k1_plain_ms = cuda_ms(plain("k1"), 5)
    sat_device_ms = cuda_graph_ms(run("saturated"), 20)
    err = max(errs.values())
    dets, mask, sat = outs["calibrated"]
    io_bytes = nbytes(dec, thr, dets, mask, sat)
    # the key pass compares every column of every row once; the greedy
    # loop, ~20 operations a candidate a step it ran
    ops = dec.numel() + 20 * 512 * int(mask.sum(-1).max())
    note = (f" ({device_ms:.6f} ms of device time); K=1 cap {K1_CAP} at "
            f"{s} frames kernel {k1_ms:.4f} ms, {k1_device_ms:.6f} ms of "
            f"device time, plain {k1_plain_ms:.4f} ms; saturated "
            f"{sat_device_ms:.6f} ms of device time (its sat summed over "
            f"images {outs['saturated'][2].sum(0).tolist()}); "
            f"{dets_per_frame:.1f} detections a frame; merged boxes max "
            f"|err| per case {errs}; masks, order, sat and obj / cls_conf / "
            f"cls exactly equal in all four cases")
    return (err, ms, plain_ms, note, io_bytes,
            {"device_ms": device_ms, "k1_ms": k1_ms,
             "k1_device_ms": k1_device_ms, "k1_plain_ms": k1_plain_ms,
             "saturated_device_ms": sat_device_ms, "ops": ops,
             "detections_per_frame": dets_per_frame})


def check_roi_nms(rng, dev):
    """The ROI NMS kernel against its plain version at the facades' D
    (ROI_NMS_D) and ROI_NMS_OVERLAP: a seeded scene of overlapping boxes
    with a fifth masked out, and clusters of near-copies with tied scores;
    keep masks exactly equal. Timed on both clocks beside the plain
    version. -> the phase loop's record."""
    import torch

    from yolo_deepsort_tpu_torch.ops import nms_kernel as NK
    from yolo_deepsort_tpu_torch.ops.nms import roi_nms_mask_plain

    d = ROI_NMS_D
    xy = rng.uniform(0, 400, (d, 2))
    boxes = np.concatenate([xy, rng.uniform(30, 120, (d, 2))], 1)
    scores = rng.uniform(0, 1, d)
    scores[::9] = 0.5  # exact ties
    mask = rng.uniform(0, 1, d) < 0.8
    clusters = (np.repeat(rng.uniform(0, 400, (8, 4)) * [1, 1, 0.2, 0.2]
                          + [0, 0, 40, 40], 8, 0)
                + rng.uniform(-3, 3, (d, 4)))
    cases = {"scene": (boxes, scores, mask),
             "clusters": (clusters, np.repeat(rng.uniform(0, 1, 8), 8),
                          np.ones(d, bool))}
    kept = {}
    for name, (b, sc, m) in cases.items():
        args = (torch.from_numpy(b.astype(np.float32)).to(dev),
                torch.from_numpy(sc.astype(np.float32)).to(dev),
                torch.from_numpy(m).to(dev), ROI_NMS_OVERLAP)
        got, want = NK.roi_nms_cuda(*args), roi_nms_mask_plain(*args)
        if not torch.equal(got, want):
            raise AssertionError(f"roi_nms kernel, case {name}: keep masks "
                                 "differ")
        kept[name] = (int(want.sum()), int(m.sum()))
        cases[name] = args
    args = cases["scene"]
    ms = cuda_ms(lambda: NK.roi_nms_cuda(*args), 50)
    device_ms = cuda_graph_ms(lambda: NK.roi_nms_cuda(*args), 50)
    plain_ms = cuda_ms(lambda: roi_nms_mask_plain(*args), 5)
    # the rank pass compares every pair once; each kept box's overlap with
    # the later masked boxes, ~10 operations a pair
    m = args[2].cpu().numpy()
    order = np.argsort(np.where(m, -args[1].cpu().numpy(), np.inf),
                       kind="stable")
    keep = roi_nms_mask_plain(*args).cpu().numpy()
    later = m[order][::-1].cumsum()[::-1] - m[order]
    pairs = int((later * keep[order]).sum())
    note = (f" ({device_ms:.6f} ms of device time); D {d}, max_overlap "
            f"{ROI_NMS_OVERLAP}: kept / masked {kept}, keep masks exactly "
            "equal")
    return (0.0, ms, plain_ms, note, nbytes(*args[:3]) + d,
            {"device_ms": device_ms, "ops": d * d + 10 * pairs})


def main_path_setup(dev):
    """yolov3-416 bf16 with its per-stream thresholds, the serving step,
    fresh states for 8 streams and one chunk of K static 1080p frames."""
    import torch

    from specs.weights_np import random_darknet_weights
    from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES
    from yolo_deepsort_tpu_torch.config import DetectorConfig, TrackerConfig
    from yolo_deepsort_tpu_torch.models.darknet import build_network
    from yolo_deepsort_tpu_torch.models.reid import random_reid_params
    from yolo_deepsort_tpu_torch.ops.letterbox_kernel import (
        letterbox_batch_fused,
    )
    from yolo_deepsort_tpu_torch.parallel.streams import (
        BucketedScannedStep,
        init_stream_states,
    )
    from yolo_deepsort_tpu_torch.tools.honest_load import plant_box_prior
    from yolo_deepsort_tpu_torch.weights import (
        darknet_from_raw,
        load_darknet_weights,
        reid_from_params,
    )

    plan = build_network(ARCHITECTURES["yolov3"](img_size=416))
    blob = random_darknet_weights(plan.defs(), seed=0, well_conditioned=True)
    _, raw = load_darknet_weights(blob, plan.defs())
    raw = plant_box_prior(raw, plan, (FRAME_H, FRAME_W))
    cl = torch.channels_last
    detector = darknet_from_raw(plan, raw).to(dev, torch.bfloat16,
                                              memory_format=cl)
    reid = reid_from_params(random_reid_params(0)).to(dev, torch.bfloat16,
                                                      memory_format=cl)
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.integers(
        0, 256, (STREAMS, FRAME_H, FRAME_W, 3), dtype=np.uint8)).to(dev)
    frames = base[None].expand(K_FRAMES, -1, -1, -1, -1).contiguous()

    # per-stream thresholds: the TARGET_DETS-th largest objectness
    with torch.no_grad():
        obj = detector(letterbox_batch_fused(base, 416, torch.bfloat16))[..., 4]
    conf = torch.sort(obj, -1, descending=True).values[:, TARGET_DETS - 1]
    conf_vec = conf.float().cpu().numpy()

    trk_cfg = TrackerConfig(max_dets=64)
    det_cfg = DetectorConfig(img_size=416, conf_thres=float(conf_vec.mean()),
                             nms_thres=0.4, max_dets=64)
    step = BucketedScannedStep(detector, reid, det_cfg, trk_cfg,
                               (FRAME_H, FRAME_W),
                               buckets=(16, 24, 32, 36, 40, 48),
                               conf_thres_per_stream=conf_vec)
    states = init_stream_states(trk_cfg, STREAMS, dev)
    return step, states, frames, dict(
        detector=detector, reid=reid, det_cfg=det_cfg, trk_cfg=trk_cfg,
        conf_vec=conf_vec, plan=plan, raw=raw)


def n_convs(module) -> int:
    """The conv layers of a net: one kernel 7 launch each per bf16
    forward (``models/layers.conv_layer_bf16``)."""
    import torch

    return sum(isinstance(m, torch.nn.Conv2d) for m in module.modules())


def n_blocks(module) -> int:
    """The residual blocks of a ReID net: one of its kernel 7 launches per
    bf16 forward carries the block's tail (``conv_residual``); 0 for a
    detector."""
    from yolo_deepsort_tpu_torch.models.reid import BasicBlock

    return sum(isinstance(m, BasicBlock) for m in module.modules())


def pipelined(step, states, frames, chunks, event_readback=True):
    """``chunks`` chunks through the step, each chunk's track stage enqueued
    after the NEXT chunk's detect stage. ``event_readback=False`` hands the
    track stage the handle without its readback event, so it reads the
    stats with a plain copy, which waits for the whole stream."""
    nxt = step.detect(frames)
    for i in range(chunks):
        cur = nxt
        if i + 1 < chunks:
            nxt = step.detect(frames)
        states, (outputs, emit) = step.track(
            states, cur if event_readback else cur[:4])
    return states, (outputs, emit)


def run_main_path(dev, setup=None):
    """yolov3-416 bf16, 8 x 1080p, K=4 through BucketedScannedStep."""
    import torch

    from yolo_deepsort_tpu_torch.ops import (
        conv_kernel,
        crops_kernel,
        letterbox_kernel,
        nms_kernel,
    )
    from yolo_deepsort_tpu_torch.tracking import tracker_kernel

    step, states, frames, parts = setup or main_path_setup(dev)
    trk_cfg = parts["trk_cfg"]
    for _ in range(2):  # warm-up: tracks confirm after n_init frames
        states, (outputs, emit) = step(states, frames)
    torch.cuda.synchronize()

    # the design waits for the device once per chunk, for the stats that
    # pick the bucket and window (an event wait, counted by the step). In
    # sync debug mode "error" every other synchronizing CUDA call raises.
    readbacks = step.host_readbacks
    torch.cuda.set_sync_debug_mode("error")
    try:
        states, (outputs, emit) = pipelined(step, states, frames, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    readbacks = step.host_readbacks - readbacks
    if readbacks != 2:
        raise AssertionError(f"{readbacks} stats readbacks in 2 chunks")

    kernels = (letterbox_kernel, crops_kernel, tracker_kernel, conv_kernel,
               nms_kernel)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    states, (outputs, emit) = pipelined(step, states, frames, CHUNKS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(zip(("letterbox", "crops", "tracker", "conv", "nms"),
                        (k.launches for k in kernels)))
    if launches["nms"] != CHUNKS:  # one per detect stage
        raise AssertionError(f"main path: {launches['nms']} NMS launches in "
                             f"{CHUNKS} chunks, expected 1 a chunk")
    # kernel 7 runs every conv of the bf16 detector and ReID net, once per
    # chunk each
    per_chunk = n_convs(parts["detector"]) + n_convs(parts["reid"])
    if launches["conv"] != per_chunk * CHUNKS:
        raise AssertionError(f"main path: {launches['conv']} K7 launches in "
                             f"{CHUNKS} chunks, expected {per_chunk} a chunk")

    # per-stage times of one more chunk, each stage synchronized
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    handle = step.detect(frames)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    states, (outputs, emit) = step.track(states, handle)
    torch.cuda.synchronize()
    t3 = time.perf_counter()

    fps = STREAMS * K_FRAMES * CHUNKS / dt
    n_conf = int((states.state == 2).sum())
    finite = bool(torch.isfinite(states.mean).all()
                  and torch.isfinite(states.cov).all())
    if outputs.shape != (K_FRAMES, STREAMS, trk_cfg.max_tracks, 5):
        raise AssertionError(f"outputs shape {tuple(outputs.shape)}")
    if not finite:
        raise AssertionError("non-finite tracker state")
    if n_conf == 0 or int(emit.sum()) == 0:
        raise AssertionError("no confirmed / emitted tracks on the main path")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    print(f"main path: yolov3-416 bf16, {STREAMS} x {FRAME_H}p, K="
          f"{K_FRAMES}, {CHUNKS} chunks: {fps:.2f} frames/s "
          f"(chunk {dt / CHUNKS * 1e3:.2f} ms pipelined); detect stage "
          f"{(t2 - t1) * 1e3:.2f} ms, track stage {(t3 - t2) * 1e3:.2f} ms "
          f"per chunk; bucket {step.last_bucket}, window {step.last_window}, "
          f"max count {step.last_max_count}, confirmed tracks {n_conf}, "
          f"emitted rows {int(emit.sum())}, saturation {step.saturation()}, "
          f"stats readbacks per chunk {readbacks // 2} and no other sync; "
          f"K7 launches per chunk {per_chunk} (every conv of the bf16 "
          f"detector and ReID net), NMS 1", flush=True)
    return launches


def widest_gap(obj, lo: int, hi: int):
    """A threshold with a margin: the midpoint of the widest gap between
    neighbours of ``obj``'s values sorted descending, among ranks ``lo`` ..
    ``hi`` (0-based, both included). -> (threshold, margin: half the
    gap)."""
    import torch

    top = torch.sort(obj.flatten().float(), descending=True).values[lo:hi + 1]
    gaps = top[:-1] - top[1:]
    k = int(torch.argmax(gaps))
    return float((top[k] + top[k + 1]) / 2), float(gaps[k]) / 2


def route_objectness(detector, frames, **impls):
    """The bf16 detector's objectness on (N, H, W, 3) uint8 frames through
    the serving steps' letterbox, with ``conv_impl`` / ``block_impl`` as
    given: (N, B) float32."""
    import torch

    from yolo_deepsort_tpu_torch.ops.letterbox_kernel import (
        letterbox_batch_fused,
    )

    with torch.no_grad():
        xs = letterbox_batch_fused(frames, 416, torch.bfloat16)
        return detector(xs, **impls)[..., 4].float()


def near_change(ref, got, thr):
    """``got`` (N, B) against ``ref`` (N, B) at thresholds ``thr`` (N,):
    -> (each frame's largest |got - ref| over its candidates within
    MARGIN_NEAR ranks of the threshold in ``ref``'s order (N,), the
    candidates on the other side of the threshold in ``got``)."""
    import torch

    order = torch.argsort(ref, dim=-1, descending=True)
    above = (ref > thr[:, None]).sum(-1, keepdim=True)
    rank = torch.arange(ref.shape[1], device=ref.device)[None]
    near = (rank >= above - MARGIN_NEAR) & (rank < above + MARGIN_NEAR)
    diff = (got - ref).abs().gather(1, order)
    crossed = (ref > thr[:, None]) != (got > thr[:, None])
    return torch.where(near, diff, 0.0).amax(-1), int(crossed.sum())


def margin_load(ref, held, measured, per_stream):
    """F5's margin load over ``ref`` (S, B), the unrouted objectness of one
    frame a stream: thresholds in the widest gap of MARGIN_WINDOWS' first
    window in which every ``held`` route's change stays below the margin.
    ``held`` and ``measured`` {name: (N, B) objectness, row k * S + s a
    frame of stream s}: a route's forward, or the unrouted one at another
    batch; the ``measured`` routes are reported, each with the largest
    slack (its stream's margin less its change, at the stream where that is
    least) any window offers it. -> {"thr": one float, or (S,) float32 per
    stream, "margin" (S,), "window", "change" {name: largest change},
    "crossed" {name: candidates across}, "measured" {name: (change, largest
    slack of any window)}}."""
    import torch

    s = ref.shape[0]
    tried, best, found = [], {}, None
    for lo, hi in MARGIN_WINDOWS:
        if per_stream:
            gaps = [widest_gap(ref[i], lo, hi) for i in range(s)]
        else:
            gaps = [widest_gap(ref, lo * s, hi * s)] * s
        thr = torch.tensor([g[0] for g in gaps], device=ref.device)
        margin = np.array([g[1] for g in gaps])
        change, crossed = {}, {}
        for name, got in {**held, **measured}.items():
            k = got.shape[0] // s
            per_frame, crossed[name] = near_change(ref.repeat(k, 1), got,
                                                   thr.repeat(k))
            change[name] = per_frame.reshape(k, s).amax(0).cpu().numpy()
        for name in measured:
            # the window's slack for this route: its least margin - change
            best[name] = max(best.get(name, -np.inf),
                             float((margin - change[name]).min()))
        tried.append(((lo, hi), float(margin.min()),
                      {n: float(c.max()) for n, c in change.items()}))
        if found is None and all((change[n] < margin).all() for n in held):
            found = {"thr": (thr.cpu().numpy() if per_stream
                             else float(thr[0])),
                     "margin": margin, "window": (lo, hi),
                     "change": {n: float(c.max())
                                for n, c in change.items()},
                     "crossed": crossed}
    if found is None:
        raise AssertionError(f"margin load: a held route's objectness change "
                             f"beats the margin in every window (window, "
                             f"smallest margin, changes): {tried}")
    found["measured"] = {n: (found["change"][n], best[n]) for n in measured}
    return found


def margin_note(m) -> str:
    """One printed line's worth of a ``margin_load``."""
    lo, hi = m["window"]
    note = (f"margin load: window of ranks {lo}-{hi}, margin (half the "
            f"widest gap) {float(m['margin'].min()):.6g} smallest, "
            f"{float(m['margin'].max()):.6g} largest; objectness change "
            f"within {MARGIN_NEAR} ranks of the threshold "
            + ", ".join(f"{n} {c:.6g}" for n, c in m["change"].items())
            + "; candidates across the threshold "
            + ", ".join(f"{n} {c}" for n, c in m["crossed"].items()))
    for name, (change, slack) in m["measured"].items():
        note += (f"; {name}: margin less change at best {slack:.6g} over "
                 f"windows {list(MARGIN_WINDOWS)} (held: {slack > 0})")
    return note


def chunk_rows(res):
    """A chunked step's (outputs (K, S, T, 5), emit (K, S, T)) -> a list
    over its K frames of a list over the streams of (n, 5) emitted rows."""
    from yolo_deepsort_tpu_torch.api import _emitted_rows

    out, emit = res
    rows, s = _emitted_rows(out, emit), out.shape[1]
    return [rows[k * s:(k + 1) * s] for k in range(out.shape[0])]


def check_twin_rows(tag, twin, routed):
    """A W8A8 route's emitted rows against a second implementation of the
    same arithmetic (its plain twin, or kernel 7's int8 modes layer by
    layer for the int8 chains), each a list over frames of a list over
    streams of (n, 5) rows: exactly equal, frame for frame. -> the
    ``PairScore`` summary (churn 0, no id remapped)."""
    from yolo_deepsort_tpu_torch.tools.int8_track_gate import score_runs

    for f, (a, b) in enumerate(zip(twin, routed, strict=True)):
        for s, (ra, rb) in enumerate(zip(a, b, strict=True)):
            if not np.array_equal(ra, rb):
                raise AssertionError(f"{tag}: frame {f} stream {s} emits "
                                     f"{rb.tolist()}, its twin "
                                     f"{ra.tolist()}")
    rec = score_runs(twin, routed)
    if rec["tracks_a"] == 0:
        raise AssertionError(f"{tag}: no tracks emitted")
    return rec


def check_route_rows(tag, unrouted, routed, same_detections):
    """The routed run's emitted rows against the unrouted run's, each a list
    over frames of a list over streams of (n, 5) rows, through
    ``PairScore``: churn 0, mean IoU >= ROUTE_MIN_IOU, an id remap rate of
    at most the reference gate's, none with ``same_detections``. -> the
    summary."""
    from yolo_deepsort_tpu_torch.tools.int8_track_gate import (
        MAX_REMAP_RATE,
        score_runs,
    )

    rec = score_runs(unrouted, routed)
    max_remaps = 0 if same_detections else MAX_REMAP_RATE
    if not (rec["tracks_a"] > 0 and rec["churn"] == 0
            and rec["mean_iou"] >= ROUTE_MIN_IOU
            and rec["id_remap_rate"] <= max_remaps):
        raise AssertionError(f"{tag}: the routed run's tracks differ from "
                             f"the unrouted run's on the margin load: {rec}")
    return rec


def k1_setup(dev, setup=None):
    """The K=1 low-latency step of the main path's model: yolov3-416 bf16,
    8 x 1080p, cap K1_CAP, crop window K1_WINDOW, with the conv route
    CONV_ROUTE (int8 package calibrated from two of the frames by the f32
    detector on the card) and without it. ``make_batched_step`` takes one
    threshold for all streams, in the reference as here (per-stream
    thresholds belong to the chunked detect stage): F5's margin load over
    the streams' pooled objectness (``margin_load``; ``parts["margin"]``),
    with the conv route's change measured beside it. ``parts["twin"]`` is
    the route's plain twin: the packaged layers through
    ``conv_plain_int8``, every other conv as on the route."""
    from yolo_deepsort_tpu_torch.models.quantize_darknet import (
        quantize_darknet_from_frames,
    )
    from yolo_deepsort_tpu_torch.parallel.streams import (
        _make_conv_impl,
        make_batched_step,
    )
    from yolo_deepsort_tpu_torch.weights import darknet_from_raw

    _, _, frames, parts = setup or main_path_setup(dev)
    base = frames[0]
    pkg = quantize_darknet_from_frames(
        darknet_from_raw(parts["plan"], parts["raw"]).to(dev), base,
        parts["det_cfg"].img_size, max_frames=2, layers=CONV_ROUTE["int8"])
    if set(pkg) != set(CONV_ROUTE["int8"]):
        raise AssertionError(f"int8 package holds layers {sorted(pkg)}")
    detector = parts["detector"]
    margin = margin_load(route_objectness(detector, base), {}, {
        "conv route": route_objectness(
            detector, base, conv_impl=_make_conv_impl(CONV_ROUTE, pkg))},
        per_stream=False)
    det_cfg = dataclasses.replace(parts["det_cfg"], conf_thres=margin["thr"])
    hw = (FRAME_H, FRAME_W)
    args = (detector, parts["reid"], det_cfg, parts["trk_cfg"], hw)
    kw = dict(cap=K1_CAP, crop_window=K1_WINDOW)
    routed = make_batched_step(*args, use_pallas_conv=CONV_ROUTE,
                               backbone_int8_pkg=pkg, **kw)
    unrouted = make_batched_step(*args, **kw)
    twin = make_batched_step(*args, use_pallas_conv="plain-twin",
                             backbone_int8_pkg=pkg, **kw)
    return routed, unrouted, base, dict(parts, int8_pkg=pkg, det_cfg=det_cfg,
                                        margin=margin, twin=twin)


def _k1_latency(step, states, base, steps):
    """``steps`` K=1 steps, each ending in its one readback: ms per step by
    host clock, every step's rows (a list over streams of (n, 5) emitted
    rows) and the states."""
    from yolo_deepsort_tpu_torch.api import _emitted_rows

    ms, rows = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        states, (outputs, emit) = step(states, base)
        rows.append(_emitted_rows(outputs, emit))
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, rows, states


def run_k1_path(dev, setup=None):
    """The K=1 path at full width. Checks: per step K1, the dense crops and
    K3 launch once, K2 never, and K7 once per routed layer; a step with its
    readback makes no other synchronizing call (2 steps in sync debug mode
    "error"); tracks confirm on the static scene and rows are emitted.
    On F5's margin load (``k1_setup``) the route's int8 layers move
    objectness past every window's margin, so the routed run's rows over
    the K1_STEPS counted steps must equal its plain twin's exactly
    (``check_twin_rows``), and its tracks against the unrouted run's are
    printed (``PairScore``). Prints p50/p99 ms per step with the conv route
    and without it (alternated blocks on fresh states), the margin and the
    comparisons' summaries, and the step's crops alone beside the earlier
    design's (kernel 2, the per-frame dense crops and the guard's
    ``torch.where``), on both clocks.
    Returns the launches of the counted run."""
    import torch

    from yolo_deepsort_tpu_torch.parallel.streams import (
        init_stream_states,
        make_k1_crops,
    )
    from yolo_deepsort_tpu_torch.tools.int8_track_gate import score_runs

    routed, unrouted, base, parts = k1_setup(dev, setup)
    trk_cfg = parts["trk_cfg"]
    states = init_stream_states(trk_cfg, STREAMS)  # the card by default
    if states.mean.device.type != "cuda":
        raise AssertionError("init_stream_states did not take the card")
    # tracks confirm; the detector runs eagerly, then is captured
    (_, _, states), warm = _counted(
        lambda: _k1_latency(routed, states, base, 5))
    # K7: the routed layers in their modes, every other conv of the bf16
    # detector and ReID net in bf16 mode; the detector's at its eager call
    # and its capture only
    n_det, per_step = n_convs(parts["detector"]), n_convs(parts["reid"])
    want = _only(letterbox=5, crops_dense=5, tracker=5, nms=5,
                 conv=2 * n_det + 5 * per_step,
                 conv_residual=5 * n_blocks(parts["reid"]), detector_graph=4,
                 detector_capture=1, detector_eager=1)
    if warm != want:
        raise AssertionError(f"K=1 launches over the 5 warm-up steps "
                             f"{warm}, expected {want}")

    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, states = _k1_latency(routed, states, base, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")

    (on_ms, on_rows, states), launches = _counted(
        lambda: _k1_latency(routed, states, base, K1_STEPS))
    # every counted step replays the detector: K7 the ReID net's convs
    want = _only(letterbox=K1_STEPS, crops_dense=K1_STEPS, tracker=K1_STEPS,
                 conv=per_step * K1_STEPS,
                 conv_residual=n_blocks(parts["reid"]) * K1_STEPS,
                 nms=K1_STEPS, detector_graph=K1_STEPS)
    if launches != want:
        raise AssertionError(f"K=1 launches over {K1_STEPS} steps "
                             f"{launches}, expected {want}")
    n_conf = int((states.state == 2).sum())
    if n_conf == 0 or sum(len(r) for r in on_rows[-1]) == 0:
        raise AssertionError("no confirmed / emitted tracks on the K=1 path")
    if not bool(torch.isfinite(states.mean).all()):
        raise AssertionError("non-finite tracker state on the K=1 path")

    # the same step with the conv route off, on fresh states and the same
    # frames, then the routed step again from fresh states: off, on
    off_states = init_stream_states(trk_cfg, STREAMS)
    _, _, off_states = _k1_latency(unrouted, off_states, base, 7)
    off_ms, off_rows, _ = _k1_latency(unrouted, off_states, base, K1_STEPS)
    # the route against its plain twin, from fresh states over as many steps
    _, twin_rows, _ = _k1_latency(parts["twin"], init_stream_states(
        trk_cfg, STREAMS), base, 7 + K1_STEPS)
    twin = check_twin_rows("K=1 conv route", twin_rows[7:], on_rows)
    against_off = score_runs(off_rows, on_rows)

    # the step's crops alone, and the earlier design's (kernel 2, the dense
    # crops per frame and the guard's torch.where), on the same boxes
    _, boxes = crops_case(np.random.default_rng(2), dev)
    mask = torch.ones(boxes.shape[:2], dtype=torch.bool, device=dev)
    hw = (FRAME_H, FRAME_W)
    crops_of = make_k1_crops(hw, K1_WINDOW, torch.bfloat16)
    crop_ms = {}
    for name, fn in (
            ("parent", lambda: k1_crops_parent(base, boxes, mask, hw,
                                               K1_WINDOW)),
            ("new", lambda: crops_of(base, boxes, mask)),
            ("new2", lambda: crops_of(base, boxes, mask)),
            ("parent2", lambda: k1_crops_parent(base, boxes, mask, hw,
                                                K1_WINDOW))):
        crop_ms[name] = (cuda_ms(fn, 10), cuda_graph_ms(fn, 10, True))

    def pct(ms, q):
        return float(np.percentile(ms, q))

    print(f"K=1 path: yolov3-416 bf16, {STREAMS} x {FRAME_H}p, cap {K1_CAP}, "
          f"window {K1_WINDOW}, fixed conv route ({len(CONV_ROUTE['bf16'])} "
          f"bf16 + {len(CONV_ROUTE['int8'])} int8 layers), {K1_STEPS} steps: "
          f"launches per step K1 1, K2 0, dense crops 1, K3 1, NMS 1, K7 "
          f"{per_step} (the ReID net's), 1 replay of the detector's graph "
          f"(K7 {n_det} at its eager call and its capture, {N_ROUTED} of "
          f"them the routed layers); 1 readback "
          f"per step and no other sync; p50 {pct(on_ms, 50):.4f} ms, p99 "
          f"{pct(on_ms, 99):.4f} ms per step; conv route off: p50 "
          f"{pct(off_ms, 50):.4f} ms, p99 {pct(off_ms, 99):.4f} ms; threshold "
          f"{parts['det_cfg'].conf_thres:.6g}, {margin_note(parts['margin'])}"
          f"; over {K1_STEPS} steps the routed rows equal its plain twin's "
          f"({json.dumps(twin)}); its tracks against the unrouted run's "
          f"(measured): {json.dumps(against_off)}; confirmed tracks "
          f"{n_conf}; the step's crops alone (called / device ms, "
          f"{STREAMS} x {K1_CAP} boxes): one dense launch "
          f"{crop_ms['new']} {crop_ms['new2']}, the earlier design (K2 + dense "
          f"crops per frame + torch.where) {crop_ms['parent']} "
          f"{crop_ms['parent2']}", flush=True)
    return launches


def run_int8_embed_paths(dev, setup):
    """The int8-resident ReID embed at full width (phase 4c of the module
    docstring) on the main path's model, weights and frames. Returns the
    launch counts of its three counted runs."""
    import os

    import torch

    from yolo_deepsort_tpu_torch.ops import (
        conv_int8_kernel,
        conv_kernel,
        crops_kernel,
        letterbox_kernel,
        nms_kernel,
    )
    from yolo_deepsort_tpu_torch.parallel.streams import (
        BucketedScannedStep,
        init_stream_states,
        make_batched_step,
    )
    from yolo_deepsort_tpu_torch.parallel import streams
    from yolo_deepsort_tpu_torch.tracking import tracker_kernel

    _, _, frames, parts = setup
    n_det = n_convs(parts["detector"])  # K7 per forward; the embed is K8's
    trk_cfg, det_cfg = parts["trk_cfg"], parts["det_cfg"]
    hw = (FRAME_H, FRAME_W)
    _, pkg = reid_int8_package(dev)
    # F5's margin load: the route leaves the detector as it is, so its
    # change is the unrouted detector's own, at the chunk's batch and again
    # at the K=1 step's
    base = frames[0]
    ref = route_objectness(parts["detector"], base)
    margin = {
        "chunked": margin_load(ref, {"detector at 32 frames": (
            route_objectness(parts["detector"], frames.flatten(0, 1)))},
            {}, per_stream=True),
        "K=1": margin_load(ref, {"detector again": route_objectness(
            parts["detector"], base)}, {}, per_stream=False)}
    chunk_kw = dict(buckets=(16, 24, 32, 36, 40, 48),
                    conf_thres_per_stream=margin["chunked"]["thr"])
    bf16_step = BucketedScannedStep(parts["detector"], parts["reid"],
                                    det_cfg, trk_cfg, hw, **chunk_kw)
    int8_step = BucketedScannedStep(parts["detector"], pkg, det_cfg, trk_cfg,
                                    hw, embed_int8="resident_pallas",
                                    **chunk_kw)

    def reset_counters():
        for m in (letterbox_kernel, crops_kernel, tracker_kernel,
                  conv_int8_kernel, conv_kernel, nms_kernel):
            m.launches = 0
        crops_kernel.launches_interleaved = 0
        crops_kernel.launches_dense = 0

    def counts():
        return {"letterbox": letterbox_kernel.launches,
                "crops": crops_kernel.launches,
                "crops_interleaved": crops_kernel.launches_interleaved,
                "crops_dense": crops_kernel.launches_dense,
                "tracker": tracker_kernel.launches,
                "conv_int8": conv_int8_kernel.launches,
                "conv": conv_kernel.launches,
                "nms": nms_kernel.launches}

    # chunked path: both embeds from fresh states over the same chunks
    st = {"int8": init_stream_states(trk_cfg, STREAMS),
          "bf16": init_stream_states(trk_cfg, STREAMS)}
    steps = {"int8": int8_step, "bf16": bf16_step}
    for name, step in steps.items():
        for _ in range(2):  # warm-up: tracks confirm after n_init frames
            st[name], _ = step(st[name], frames)
    torch.cuda.synchronize()
    readbacks = int8_step.host_readbacks
    torch.cuda.set_sync_debug_mode("error")
    try:
        st["int8"], _ = pipelined(int8_step, st["int8"], frames, 2)
        st["bf16"], _ = pipelined(bf16_step, st["bf16"], frames, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    readbacks = int8_step.host_readbacks - readbacks
    if readbacks != 2:
        raise AssertionError(f"int8 embed: {readbacks} stats readbacks in 2 "
                             "chunks")
    fps, last, chunk_counts = {"int8": [], "bf16": []}, {}, None
    for name in ("bf16", "int8", "int8", "bf16"):
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st[name], last[name] = pipelined(steps[name], st[name], frames,
                                         INT8_CHUNKS)
        torch.cuda.synchronize()
        fps[name].append(STREAMS * K_FRAMES * INT8_CHUNKS
                         / (time.perf_counter() - t0))
        if name == "int8":
            chunk_counts = counts()
    want = {"letterbox": INT8_CHUNKS, "crops": INT8_CHUNKS,
            "crops_interleaved": 0, "crops_dense": 0,
            "tracker": K_FRAMES * INT8_CHUNKS,
            "conv_int8": N_INT8_CONVS * INT8_CHUNKS,
            "conv": n_det * INT8_CHUNKS, "nms": INT8_CHUNKS}
    if chunk_counts != want:
        raise AssertionError(f"int8 embed, chunked: launches over "
                             f"{INT8_CHUNKS} chunks {chunk_counts}, expected "
                             f"{want}")
    out8, emit8 = last["int8"]
    n_conf = int((st["int8"].state == 2).sum())
    if (n_conf == 0 or int(emit8.sum()) == 0
            or not bool(torch.isfinite(st["int8"].mean).all())
            or not bool(torch.isfinite(st["int8"].gallery).all())):
        raise AssertionError("int8 embed, chunked: no confirmed / emitted "
                             "tracks, or a non-finite state")
    same = check_route_rows("int8 embed, chunked", chunk_rows(last["bf16"]),
                            chunk_rows(last["int8"]), same_detections=False)
    crops_per_chunk = K_FRAMES * STREAMS * int8_step.last_bucket
    print(f"int8 embed, chunked (yolov3-416 bf16, {STREAMS} x {FRAME_H}p, "
          f"K={K_FRAMES}, embed_int8=resident_pallas, {crops_per_chunk} crops "
          f"per chunk at bucket {int8_step.last_bucket}, window "
          f"{int8_step.last_window}): launches per chunk K8 {N_INT8_CONVS}, "
          f"K7 {n_det}, K1 1, K2 1, K3 {K_FRAMES}; 1 readback per chunk and "
          f"no other "
          f"sync; frames/s over {INT8_CHUNKS} chunks, blocks bf16 int8 int8 "
          f"bf16: int8 {fps['int8']}, bf16 {fps['bf16']}; confirmed tracks "
          f"{n_conf}, emitted rows {int(emit8.sum())}; "
          f"{margin_note(margin['chunked'])}; the last chunk's tracks against "
          f"the bf16 embed's (churn 0, mean IoU >= {ROUTE_MIN_IOU}, id remap "
          f"rate <= 0.02): {json.dumps(same)}", flush=True)

    # kernel 6 on the chunked path: the same chunks from fresh states under
    # YDT_CROPS_LAYOUT=interleaved and planar; kernels 6 and 2 are equal bit
    # for bit, so the rows must be
    def chunk_run():
        states = init_stream_states(trk_cfg, STREAMS)
        for _ in range(2):
            states, _ = int8_step(states, frames)
        reset_counters()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, res = pipelined(int8_step, states, frames, INT8_CHUNKS)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return res, counts()

    os.environ["YDT_CROPS_LAYOUT"] = "interleaved"
    try:
        (out6, emit6), k6_chunk_counts = chunk_run()
    finally:
        del os.environ["YDT_CROPS_LAYOUT"]
    (out2, emit2), _ = chunk_run()
    want = dict(want, crops=0, crops_interleaved=INT8_CHUNKS)
    if k6_chunk_counts != want:
        raise AssertionError(f"int8 embed, chunked, interleaved crops: "
                             f"launches over {INT8_CHUNKS} chunks "
                             f"{k6_chunk_counts}, expected {want}")
    if (int(emit6.sum()) == 0 or not torch.equal(emit6, emit2)
            or not torch.equal(out6[emit6], out2[emit2])):
        raise AssertionError("chunked rows under YDT_CROPS_LAYOUT=interleaved "
                             "differ from the planar run's, or none emitted")
    print(f"int8 embed, chunked, under YDT_CROPS_LAYOUT=interleaved: "
          f"launches per chunk K6 1, K2 0, K8 {N_INT8_CONVS}, K1 1, K3 "
          f"{K_FRAMES}; no sync besides the readback; {int(emit6.sum())} "
          f"emitted rows equal to the planar run's", flush=True)

    # K=1 path: the int8 embed, planar then interleaved crops, and the bf16
    # embed, each from fresh states over the same number of steps
    k1_cfg = dataclasses.replace(det_cfg, conf_thres=margin["K=1"]["thr"])
    args = (parts["detector"], pkg, k1_cfg, trk_cfg, hw)
    kw = dict(cap=K1_CAP, crop_window=K1_WINDOW)
    k1_int8 = make_batched_step(*args, embed_int8="resident_pallas", **kw)
    k1_bf16 = make_batched_step(parts["detector"], parts["reid"], k1_cfg,
                                trk_cfg, hw, **kw)

    def k1_run(step, check_sync):
        states = init_stream_states(trk_cfg, STREAMS)
        _, _, states = _k1_latency(step, states, base, 5)
        if check_sync:
            torch.cuda.set_sync_debug_mode("error")
            try:
                _, _, states = _k1_latency(step, states, base, 2)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        else:
            _, _, states = _k1_latency(step, states, base, 2)
        reset_counters()
        replays = streams.detector_graph_launches
        ms, rows, states = _k1_latency(step, states, base, INT8_K1_STEPS)
        # every counted step replays the detector's graph: its K7 launches
        # counted at its capture, in the warm-up
        return ms, rows, states, dict(
            counts(),
            detector_graph=streams.detector_graph_launches - replays)

    ms8, rows8, st8, k1_counts = k1_run(k1_int8, True)
    want = {"letterbox": INT8_K1_STEPS, "crops": 0,
            "crops_interleaved": 0, "crops_dense": INT8_K1_STEPS,
            "tracker": INT8_K1_STEPS,
            "conv_int8": N_INT8_CONVS * INT8_K1_STEPS,
            "conv": 0, "nms": INT8_K1_STEPS,
            "detector_graph": INT8_K1_STEPS}
    if k1_counts != want:
        raise AssertionError(f"int8 embed, K=1: launches over "
                             f"{INT8_K1_STEPS} steps {k1_counts}, expected "
                             f"{want}")
    if (int((st8.state == 2).sum()) == 0
            or sum(len(r) for r in rows8[-1]) == 0
            or not bool(torch.isfinite(st8.mean).all())):
        raise AssertionError("int8 embed, K=1: no confirmed / emitted tracks")
    ms16, rows16, _, _ = k1_run(k1_bf16, False)
    os.environ["YDT_CROPS_LAYOUT"] = "interleaved"
    try:
        ms6, rows6, _, k6_counts = k1_run(k1_int8, True)
    finally:
        del os.environ["YDT_CROPS_LAYOUT"]
    if k6_counts != want:  # the K=1 step's crops are the dense entry
        raise AssertionError(f"int8 embed, K=1, interleaved crops: launches "
                             f"{k6_counts}, expected {want}")
    if not all(np.array_equal(a, b) for s6, s8 in zip(rows6, rows8)
               for a, b in zip(s6, s8)):
        raise AssertionError("K=1 rows under YDT_CROPS_LAYOUT=interleaved "
                             "differ from the planar run's")
    same = check_route_rows("int8 embed, K=1", rows16, rows8,
                            same_detections=False)

    def pct(ms, q):
        return float(np.percentile(ms, q))

    print(f"int8 embed, K=1 (cap {K1_CAP}, window {K1_WINDOW}, "
          f"{EMBED_CROPS} crops per step, no conv route, {INT8_K1_STEPS} "
          f"steps): launches per step K8 {N_INT8_CONVS}, 1 replay of the "
          f"detector's graph (K7 {n_det} at its capture), K1 1, "
          f"K2 0, dense "
          f"crops 1, K3 1; 1 "
          f"readback per step and no other sync; p50 {pct(ms8, 50):.4f} ms, "
          f"p99 {pct(ms8, 99):.4f} ms per step; bf16 embed: p50 "
          f"{pct(ms16, 50):.4f} ms, p99 {pct(ms16, 99):.4f} ms; threshold "
          f"{k1_cfg.conf_thres:.6g}, {margin_note(margin['K=1'])}; tracks "
          f"against the bf16 embed's over {INT8_K1_STEPS} steps: "
          f"{json.dumps(same)}; under "
          f"YDT_CROPS_LAYOUT=interleaved: launches per step K6 0, K2 0, "
          f"dense crops 1, K8 "
          f"{N_INT8_CONVS}, rows equal to the planar run's, p50 "
          f"{pct(ms6, 50):.4f} ms, p99 {pct(ms6, 99):.4f} ms", flush=True)
    return {"conv_int8": chunk_counts["conv_int8"],
            "conv_int8_k1": k1_counts["conv_int8"],
            "crops_interleaved": k6_chunk_counts["crops_interleaved"],
            "crops_interleaved_k1": k6_counts["crops_interleaved"],
            "crops_per_chunk": crops_per_chunk}


def check_resblock(rng, dev):
    """Kernel 9 against its plain versions at the three chain classes of
    yolov3-416 at full chain length (``RESBLOCK_CLASSES``), plus one mish
    chain (13x13, 128/128, 2 blocks), in both modes and at both batches the
    main paths give it: STREAMS (the K=1 step's) and K_FRAMES * STREAMS (the
    chunked step's, where the schedule gives a work item several column
    tiles). int8 mode with a leaky activation exactly equal; everything else
    with every element inside rtol = atol = CHAIN_TOL, and in bf16 mode
    every block of the chain alone, fed the plain chain's state, within
    CHAIN_BLOCK_ULPS. Times per class, mode and batch: the kernel with its
    weights packed once, as the route calls it, called from Python back to
    back (``cuda_ms``) and as device time (``cuda_graph_ms``), the plain
    version, the bound (the chain's operations over the bf16 / int8 peak
    against x read once, out written once and the weights), and two
    yardsticks the route never calls: the same blocks layer by layer through
    ``F.conv2d`` + activation + add (the library), and through kernel 7 +
    add, on both clocks as well. Returns {(h, ci, cm, nblk, act): {...}}."""
    import torch
    import torch.nn.functional as F

    from yolo_deepsort_tpu_torch.ops import conv_kernel as CV
    from yolo_deepsort_tpu_torch.ops import resblock_kernel as RK

    def library(x, w1b, b1, w2b, b2, act):
        nblk = w1b.shape[0]
        w1c = [w1b[b].t()[:, :, None, None].contiguous(
            memory_format=torch.channels_last) for b in range(nblk)]
        w2c = [w2b[b].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last) for b in range(nblk)]
        b1h, b2h = b1.to(torch.bfloat16), b2.to(torch.bfloat16)
        x_cl = x.permute(0, 3, 1, 2)
        fn = ((lambda y: F.leaky_relu_(y, 0.1)) if act == "leaky"
              else F.mish)

        def run():
            cur = x_cl
            for b in range(nblk):
                mid = fn(F.conv2d(cur, w1c[b], b1h[b]))
                cur = cur + fn(F.conv2d(mid, w2c[b], b2h[b], padding=1))
            return cur
        return run

    def through_k7(case, mode, act):
        if mode == "bf16":
            x, w1, b1, w2, b2 = case["bf16"]
        else:
            x, w1, b1, w2, b2, s1, s2, _ = case["int8"]
        xinv = case["xinv"]

        def run():
            cur = x
            for b in range(w1.shape[0]):
                if mode == "bf16":
                    mid = CV.conv_bf16(cur, w1[b][None, None], b1[b], pad=0,
                                       act=act)
                    y = CV.conv_bf16(mid, w2[b], b2[b], pad=1, act=act)
                else:
                    mid = CV.conv_int8(cur, w1[b][None, None], b1[b], s1[b],
                                       xinv[b, 0], pad=0, act=act)
                    y = CV.conv_int8(mid, w2[b], b2[b], s2[b], xinv[b, 1],
                                     pad=1, act=act)
                cur = y + cur
            return cur
        return run

    out = {}
    cases = [(h, ci, cm, nblk, "leaky") for h, ci, cm, nblk, _ in
             RESBLOCK_CLASSES] + [(13, 128, 128, 2, "mish")]
    for h, ci, cm, nblk, act in cases:
        r = {}
        for n in (STREAMS, K_FRAMES * STREAMS):
            case = RK.seeded_chain_case(rng, dev, n, h, ci, cm, nblk, act)
            ops = 2.0 * n * h * h * 10 * ci * cm * nblk
            for mode, fn, plain in (
                    ("bf16", RK.resblock_chain_bf16,
                     RK.resblock_chain_plain_bf16),
                    ("int8", RK.resblock_chain_int8,
                     RK.resblock_chain_plain_int8)):
                args = case[mode]
                # weights packed once, as the route holds them: the object
                # held to the plain version is the one timed
                packed = RK.pack_chain_args(args)
                tag = f"resblock {mode} N={n} {h}x{h} {ci}/{cm} x{nblk} {act}"
                calls, kernels = RK.launches, RK.device_kernels
                got = fn(*packed, act=act)
                torch.cuda.synchronize()
                calls = RK.launches - calls
                kernels = RK.device_kernels - kernels
                if calls != 1 or kernels != 2 * nblk:
                    raise AssertionError(
                        f"{tag}: {calls} calls of the C entry launching "
                        f"{kernels} kernels, expected 1 and two per block")
                if got.shape != args[0].shape or got.dtype != torch.bfloat16:
                    raise AssertionError(f"{tag}: {got.shape} {got.dtype}")
                want = plain(*args, act=act)
                err = float((got.float() - want.float()).abs().max())
                outside = RK.chain_outside_tol(got, want)
                ulps = _bf16_ulps(got.float(), want.float())
                exact = mode == "int8" and act == "leaky"
                ok = torch.equal(got, want) if exact else outside == 0
                if not ok or not bool(want.float().abs().max() > 0):
                    raise AssertionError(
                        f"{tag}: differs from its plain version: max |err| "
                        f"{err}, {outside} elements outside rtol = atol = "
                        f"{RK.CHAIN_TOL}, {ulps} bf16 ulps")
                sched = RK.plan_chain_schedule(n, h, h, ci, cm, nblk,
                                               mode == "int8")
                io = nbytes(*args) + nbytes(got)
                rec = dict(
                    err=err, ulps=ulps,
                    rms=float(want.float().pow(2).mean().sqrt()),
                    ms=cuda_ms(lambda: fn(*packed, act=act), 10),
                    device=cuda_graph_ms(lambda: fn(*packed, act=act), 5),
                    plain=cuda_ms(lambda: plain(*args, act=act), 2),
                    # the yardsticks are 16-40 launches each: called from
                    # Python like the kernel, and replayed from a graph as
                    # device time
                    library=cuda_ms(library(*case["bf16"], act), 10),
                    k7=cuda_ms(through_k7(case, mode, act), 5),
                    library_device=cuda_graph_ms(
                        library(*case["bf16"], act), 5),
                    k7_device=cuda_graph_ms(through_k7(case, mode, act), 5),
                    bound=roofline(io, ops, mode), launches=calls,
                    kernel_launches=kernels,
                    plans=[list(sched.conv1), list(sched.conv2)])
                del got, want
                if mode == "bf16":
                    # every block alone, on the plain chain's state
                    state, worst = args[0], 0.0
                    for b in range(nblk):
                        w_b = plain(state, *RK.block_args(args[1:], b),
                                    act=act)
                        got_b = fn(state, *RK.block_args(packed[1:], b),
                                   act=act)
                        worst = max(worst,
                                    RK.chain_block_ulps(got_b, w_b, state))
                        state = w_b
                    rec["block_ulps"] = worst
                    if not worst <= RK.CHAIN_BLOCK_ULPS:
                        raise AssertionError(
                            f"{tag}: a block alone is {worst} bf16 ulps of "
                            f"max(|x|, |out|, 2^-3) from its plain version")
                r[(mode, n)] = rec
            del case
        out[(h, ci, cm, nblk, act)] = r
    return out


def resblock_kernel_entry(per_class, launches, launches_k1,
                          kernels_per_step):
    """K9's entry of the ``kernels`` line: its times are those of the three
    routed chains of one yolov3-416 forward in bf16 mode at batch STREAMS
    (the K=1 step's), summed: ``ms`` called from Python, ``device_ms`` as
    device time; ``library_ms`` is the layer-by-layer ``F.conv2d`` +
    activation + add yardstick of the same blocks (there is no single
    PyTorch call for a chain), ``k7_ms`` the same blocks through kernel 7,
    ``library_device_ms`` and ``k7_device_ms`` the two yardsticks as device
    time; ``int8`` the same sums in W8A8 mode, ``at_chunk_batch`` both at
    K_FRAMES * STREAMS (the chunked step's); ``per_class`` every class.
    ``launches`` counts calls of the C entry (one per chain),
    ``launches_k1_path`` those of the K=1 steps' warm-ups (the detector's
    eager call and its capture: a replay of its graph counts none),
    ``device_kernels_per_forward`` the kernels those calls launched per
    forward of the chain route, as the C entry counts them
    (``resblock_kernel.device_kernels``); ``launches_per_chain`` and
    ``kernels_per_chain`` per class are counted around the checked call."""
    def totals(mode, n):
        tot = dict(ms=0.0, device_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   k7_ms=0.0, library_device_ms=0.0, k7_device_ms=0.0)
        plain, by = 0.0, {"operations": 0.0, "bytes": 0.0}
        for (h, ci, cm, nblk, act), r in per_class.items():
            if act != "leaky":
                continue
            rec = r[(mode, n)]
            tot["ms"] += rec["ms"]
            tot["device_ms"] += rec["device"]
            tot["bound_ms"] += rec["bound"][0]
            tot["library_ms"] += rec["library"]
            tot["k7_ms"] += rec["k7"]
            tot["library_device_ms"] += rec["library_device"]
            tot["k7_device_ms"] += rec["k7_device"]
            by[rec["bound"][1]] += rec["bound"][0]
            plain += rec["plain"]
        tot["bound_by"] = max(by, key=by.get)
        tot["plain_ms"] = plain
        return tot

    n_chunk = K_FRAMES * STREAMS
    classes = []
    for (h, ci, cm, nblk, act), r in per_class.items():
        for (mode, n), rec in r.items():
            classes.append({
                "shape": [n, h, ci, cm, nblk, act], "mode": mode,
                "ms": rec["ms"], "device_ms": rec["device"],
                "plain_ms": rec["plain"],
                "bound_ms": rec["bound"][0], "bound_by": rec["bound"][1],
                "library_ms": rec["library"], "k7_ms": rec["k7"],
                "library_device_ms": rec["library_device"],
                "k7_device_ms": rec["k7_device"],
                "launches_per_chain": rec["launches"],
                "kernels_per_chain": rec["kernel_launches"],
                "plans_1x1_3x3": rec["plans"], "max_abs_err": rec["err"],
                "out_rms": rec["rms"], "bf16_ulps": rec["ulps"],
                "one_block_ulps": rec.get("block_ulps")})
    return {
        "name": "resblock", "route": "cuda",
        "source": "yolo_deepsort_tpu_torch/csrc/resblock.cu",
        "replaces": "yolo_deepsort_tpu/ops/pallas_resblock.py:80",
        "launches": launches, "launches_k1_path": launches_k1,
        "device_kernels_per_forward": kernels_per_step["bf16"],
        "max_abs_err": max(rec["err"] for r in per_class.values()
                           for (mode, _), rec in r.items() if mode == "bf16"),
        **totals("bf16", STREAMS),
        "int8": {**totals("int8", STREAMS),
                 "device_kernels_per_forward": kernels_per_step["int8"]},
        "at_chunk_batch": {"n": n_chunk, "bf16": totals("bf16", n_chunk),
                           "int8": totals("int8", n_chunk)},
        "per_class": classes,
    }


def _residual_defs(size=64):
    """A small residual detector: a stride-2 stem to width 128, one chain of
    two residual blocks (128/128) at size/2, a linear head and a yolo layer
    with 3 classes."""
    def conv(filters, k, stride=1, act="leaky", bn="1"):
        return {"type": "convolutional", "batch_normalize": bn,
                "filters": str(filters), "size": str(k),
                "stride": str(stride), "pad": "1", "activation": act}

    block = [conv(128, 1), conv(128, 3),
             {"type": "shortcut", "from": "-3", "activation": "linear"}]
    return ([{"type": "net", "width": str(size), "height": str(size),
              "channels": "3"}, conv(128, 3, stride=2)]
            + [dict(d) for d in block] + [dict(d) for d in block]
            + [conv(24, 1, act="linear", bn="0"),
               {"type": "yolo", "mask": "0,1,2",
                "anchors": "10,13, 16,30, 33,23", "classes": "3",
                "num": "3"}])


def check_small_resblock(dev):
    """A small residual detector (``_residual_defs``: one chain of two
    blocks at 32x32, width 128; f32, 2 streams of 64x128) through the K=1
    step with the chain route on the card against the same step on the CPU,
    where the chain runs its plain version, in both modes (the int8 package
    calibrated once, on the CPU): one K9 launch at the first step (the
    detector eager) and at the second (its capture), none at a replay; emit
    and track ids equal, boxes within 1 px, over 4 frames. Returns the
    emitted rows per mode."""
    import torch

    from specs.weights_np import random_darknet_weights
    from yolo_deepsort_tpu_torch.config import DetectorConfig, TrackerConfig
    from yolo_deepsort_tpu_torch.models.darknet import build_network
    from yolo_deepsort_tpu_torch.models.quantize_darknet import (
        quantize_darknet_from_frames,
    )
    from yolo_deepsort_tpu_torch.models.reid import random_reid_params
    from yolo_deepsort_tpu_torch.ops import resblock_kernel
    from yolo_deepsort_tpu_torch.ops.letterbox import letterbox_batch
    from yolo_deepsort_tpu_torch.parallel.streams import (
        _make_block_impl,
        init_stream_states,
        make_batched_step,
    )
    from yolo_deepsort_tpu_torch.tools.honest_load import plant_box_prior
    from yolo_deepsort_tpu_torch.weights import (
        darknet_from_raw,
        load_darknet_weights,
        reid_from_params,
    )

    h, w, s, size = 64, 128, 2, 64
    plan = build_network(_residual_defs(size))
    blob = random_darknet_weights(plan.defs(), seed=0, well_conditioned=True)
    _, raw = load_darknet_weights(blob, plan.defs())
    raw = plant_box_prior(raw, plan, (h, w), heights=(405.0,), aspect=0.5)
    base = np.random.default_rng(0).integers(0, 256, (s, h, w, 3), np.uint8)
    frames = torch.from_numpy(base)
    cpu_det = darknet_from_raw(plan, raw)
    pkg = quantize_darknet_from_frames(cpu_det, base, size)
    if not {1, 2, 4, 5} <= set(pkg):
        raise AssertionError(f"small residual net: package holds {set(pkg)}")
    cl = torch.channels_last
    reid = lambda: reid_from_params(random_reid_params(0)).to(  # noqa: E731
        torch.bfloat16, memory_format=cl)
    trk_cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
    emitted = {}
    for mode in (True, "int8"):
        route = dict(use_resblock=mode,
                     backbone_int8_pkg=pkg if mode == "int8" else None)
        # one threshold in the widest gap of the routed objectness (CPU),
        # ranks 8..20, so a bf16 ulp between the devices flips no candidate
        with torch.no_grad():
            obj = cpu_det(letterbox_batch(frames, size),
                          block_impl=_make_block_impl(
                              plan, mode, route["backbone_int8_pkg"]))[..., 4]
        det_cfg = DetectorConfig(img_size=size, max_dets=8,
                                 conf_thres=widest_gap(obj, 8, 20)[0])
        kw = dict(cap=6, crop_window=(48, 64), **route)
        ref = make_batched_step(cpu_det, reid(), det_cfg, trk_cfg, (h, w),
                                **kw)
        card = make_batched_step(
            darknet_from_raw(plan, raw).to(dev, memory_format=cl),
            reid().to(dev, memory_format=cl), det_cfg, trk_cfg, (h, w), **kw)
        st_ref = init_stream_states(trk_cfg, s, "cpu")
        st_card = init_stream_states(trk_cfg, s, dev)
        frames_dev = frames.to(dev)
        rows = 0
        for f in range(4):
            before = resblock_kernel.launches
            st_ref, (out_r, emit_r) = ref(st_ref, frames)
            st_card, (out_c, emit_c) = card(st_card, frames_dev)
            if resblock_kernel.launches != before + (f < 2):
                raise AssertionError(
                    f"small residual step ({mode}) frame {f}: "
                    f"{resblock_kernel.launches - before} K9 launches")
            out_c, emit_c = out_c.cpu(), emit_c.cpu()
            if not (torch.equal(emit_r, emit_c)
                    and torch.equal(out_r[..., 4], out_c[..., 4])):
                raise AssertionError(f"small residual step ({mode}) frame "
                                     f"{f}: emitted tracks differ between "
                                     "the card and the CPU")
            if (out_r[..., :4] - out_c[..., :4]).abs().max().item() > 1:
                raise AssertionError(f"small residual step ({mode}) frame "
                                     f"{f}: boxes differ by more than 1 px")
            rows += int(emit_c.sum())
        if rows == 0:
            raise AssertionError(f"small residual step ({mode}): no rows")
        emitted[str(mode)] = rows
    return emitted


def resblock_chain_layers(plan):
    """The conv layers (module indices) of the chains the route takes at
    yolov3-416: both convs of every block of ``RESBLOCK_CLASSES``."""
    from yolo_deepsort_tpu_torch.ops.resblock_kernel import (
        find_residual_spans,
    )

    starts = {c[4] for c in RESBLOCK_CLASSES}
    chains = [c for c in find_residual_spans(plan) if c[0] in starts]
    if sorted(len(c) for c in chains) != sorted(
            c[3] for c in RESBLOCK_CLASSES):
        raise AssertionError(f"yolov3 chains {chains}")
    return frozenset(l for c in chains for s in c for l in (s, s + 1))


def resblock_routes(dev, parts, base):
    """The two chain routes of the full-width paths as keyword arguments of
    the serving steps: bf16 chains, and W8A8 chains with the package of the
    40 chain convs, calibrated on the card from two of the frames by the
    f32 detector."""
    from yolo_deepsort_tpu_torch.models.quantize_darknet import (
        quantize_darknet_from_frames,
    )
    from yolo_deepsort_tpu_torch.weights import darknet_from_raw

    layers = resblock_chain_layers(parts["plan"])
    pkg = quantize_darknet_from_frames(
        darknet_from_raw(parts["plan"], parts["raw"]).to(dev), base,
        parts["det_cfg"].img_size, max_frames=2, layers=layers)
    if set(pkg) != set(layers):
        raise AssertionError(f"chain package holds {sorted(pkg)}")
    return {"bf16": dict(use_resblock=True),
            "int8": dict(use_resblock="int8", backbone_int8_pkg=pkg)}


def run_resblock_paths(dev, setup):
    """The fused residual-chain route at full width (yolov3-416 bf16, 8 x
    1080p) on the main path's model, weights and frames: the chunked
    ``BucketedScannedStep`` (K=4) and the K=1 ``make_batched_step`` (cap 40,
    window (320, 192)) with ``use_resblock=True`` and with ``"int8"`` (the
    package of the 40 chain convs, calibrated on the card from two of the
    frames). Checks: K9 launches per chunk and per step equal to what the
    planner promises (one per routed chain: 3), K1/K2/K3 as on the unrouted
    paths, one readback and no other synchronizing call (sync debug mode
    "error"); the routed detector's decoded output against the unrouted one
    at both batches, 8 and 32 frames (both routes within TOL_ROUTED_DECODED
    of each column's scale); confirmed tracks and emitted rows; on F5's
    margin load (``margin_load``, held against the bf16 chains' objectness
    change, the int8 chains' measured) the bf16 chains' tracks equal to the
    unrouted run's (``check_route_rows``: churn 0, mean IoU >=
    ROUTE_MIN_IOU, no id remapped) and the int8 chains' rows exactly those
    of kernel 7's int8 modes on the same package layer by layer
    (``check_twin_rows``), over the last chunk and over the K=1 steps.
    Prints frames/s and p50 / p99 beside the unrouted run's in alternated
    blocks, the margins and the comparisons' summaries, the int8 chains'
    against the unrouted run measured. Returns the launch counts of the
    counted runs."""
    import torch

    from yolo_deepsort_tpu_torch.ops import (
        conv_kernel,
        crops_kernel,
        letterbox_kernel,
        resblock_kernel,
    )
    from yolo_deepsort_tpu_torch.ops.letterbox_kernel import (
        letterbox_batch_fused,
    )
    from yolo_deepsort_tpu_torch.parallel import streams
    from yolo_deepsort_tpu_torch.parallel.streams import (
        BucketedScannedStep,
        _make_block_impl,
        init_stream_states,
        make_batched_step,
    )
    from yolo_deepsort_tpu_torch.tools.int8_track_gate import score_runs
    from yolo_deepsort_tpu_torch.tracking import tracker_kernel

    _, _, frames, parts = setup
    trk_cfg, det_cfg, plan = parts["trk_cfg"], parts["det_cfg"], parts["plan"]
    detector, base = parts["detector"], frames[0]
    hw = (FRAME_H, FRAME_W)
    routes = resblock_routes(dev, parts, base)

    # what the planner promises per forward, and the routed detector's
    # decoded output against the unrouted one, at the K=1 step's batch and
    # at the chunked step's (all K_FRAMES * STREAMS frames of a chunk)
    promised, decoded_err, box_err, obj = {}, {}, {}, {}
    batches = {STREAMS: base, K_FRAMES * STREAMS: frames.flatten(0, 1)}
    with torch.no_grad():
        for n, batch in batches.items():
            xs = letterbox_batch_fused(batch, det_cfg.img_size,
                                       torch.bfloat16)
            want = detector(xs)
            obj[("off", n)] = want[..., 4].float()
            scale = want.abs().amax((0, 1)).clamp(min=1.0)
            for name, route in routes.items():
                promised[(name, n)] = sum(
                    resblock_kernel.plan_chain_schedule(
                        n, h, h, ci, cm, nblk, name == "int8") is not None
                    for h, ci, cm, nblk, _ in RESBLOCK_CLASSES)
                impl = _make_block_impl(plan, route["use_resblock"],
                                        route.get("backbone_int8_pkg"))
                before = resblock_kernel.launches
                got = detector(xs, block_impl=impl)
                obj[(name, n)] = got[..., 4].float()
                if resblock_kernel.launches - before != promised[(name, n)]:
                    raise AssertionError(
                        f"routed forward ({name}, {n} frames): "
                        f"{resblock_kernel.launches - before} K9 launches, "
                        f"the planner promises {promised[(name, n)]}")
                decoded_err[(name, n)] = float(
                    ((got - want).abs() / scale).max())
                box_err[(name, n)] = float((got - want)[..., :4].abs().max())
                if not decoded_err[(name, n)] <= TOL_ROUTED_DECODED:
                    raise AssertionError(
                        f"routed detector ({name} chains, {n} frames): "
                        f"decoded output {decoded_err[(name, n)]} of its "
                        f"column scale from the unrouted one")
            del xs, want, got
    # F5's margin load over the unrouted detector at the K=1 step's batch,
    # held against the bf16 chains' change (and, for the chunked steps, the
    # unrouted detector's own at the chunk's batch), the int8 chains'
    # measured beside it
    chunk = K_FRAMES * STREAMS
    margin = {
        "chunked": margin_load(obj[("off", STREAMS)], {
            "bf16 chains": obj[("bf16", chunk)],
            "unrouted at 32 frames": obj[("off", chunk)]},
            {"int8 chains": obj[("int8", chunk)]}, per_stream=True),
        "K=1": margin_load(obj[("off", STREAMS)], {
            "bf16 chains": obj[("bf16", STREAMS)]},
            {"int8 chains": obj[("int8", STREAMS)]}, per_stream=False)}
    del obj
    if set(promised.values()) != {len(RESBLOCK_CLASSES)}:
        raise AssertionError(f"planner promises {promised} launches per "
                             "forward, expected one per chain")
    n_chains = len(RESBLOCK_CLASSES)
    # the kernels behind those calls: two per block of the model's chains,
    # held against what the C entry reports it launched
    n_kernels = 2 * sum(c[3] for c in RESBLOCK_CLASSES)
    # kernel 7: every conv of the bf16 detector and ReID net off the chains
    k7_off = n_convs(detector) + n_convs(parts["reid"])
    k7_routed = k7_off - n_kernels

    counters = {"letterbox": letterbox_kernel, "crops": crops_kernel,
                "tracker": tracker_kernel, "resblock": resblock_kernel,
                "conv": conv_kernel}

    def reset_counters():
        for m in counters.values():
            m.launches = 0
        resblock_kernel.device_kernels = 0
        crops_kernel.launches_dense = 0

    def counts():
        return {**{name: m.launches for name, m in counters.items()},
                "crops_dense": crops_kernel.launches_dense,
                "resblock_kernels": resblock_kernel.device_kernels}

    # chunked path
    kw = dict(buckets=(16, 24, 32, 36, 40, 48),
              conf_thres_per_stream=margin["chunked"]["thr"])
    steps = {"off": BucketedScannedStep(detector, parts["reid"], det_cfg,
                                        trk_cfg, hw, **kw)}
    for name, route in routes.items():
        steps[name] = BucketedScannedStep(detector, parts["reid"], det_cfg,
                                          trk_cfg, hw, **kw, **route)
    st = {name: init_stream_states(trk_cfg, STREAMS) for name in steps}
    for name, step in steps.items():
        for _ in range(2):  # warm-up: weights packed, tracks confirm
            st[name], _ = step(st[name], frames)
    torch.cuda.synchronize()
    for name in routes:
        readbacks = steps[name].host_readbacks
        torch.cuda.set_sync_debug_mode("error")
        try:
            st[name], _ = pipelined(steps[name], st[name], frames, 2)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if steps[name].host_readbacks - readbacks != 2:
            raise AssertionError(f"chain route ({name}): "
                                 f"{steps[name].host_readbacks - readbacks} "
                                 "stats readbacks in 2 chunks")
    st["off"], _ = pipelined(steps["off"], st["off"], frames, 2)
    fps = {name: [] for name in steps}
    last, chunk_counts = {}, {}
    for name in ("off", "bf16", "int8", "int8", "bf16", "off"):
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st[name], last[name] = pipelined(steps[name], st[name], frames,
                                         RESBLOCK_CHUNKS)
        torch.cuda.synchronize()
        fps[name].append(STREAMS * K_FRAMES * RESBLOCK_CHUNKS
                         / (time.perf_counter() - t0))
        chunk_counts[name] = counts()
    for name in routes:
        want_counts = {"letterbox": RESBLOCK_CHUNKS, "crops": RESBLOCK_CHUNKS,
                       "crops_dense": 0,
                       "tracker": K_FRAMES * RESBLOCK_CHUNKS,
                       "resblock": n_chains * RESBLOCK_CHUNKS,
                       "resblock_kernels": n_kernels * RESBLOCK_CHUNKS,
                       "conv": k7_routed * RESBLOCK_CHUNKS}
        if chunk_counts[name] != want_counts:
            raise AssertionError(f"chain route ({name}), chunked: launches "
                                 f"over {RESBLOCK_CHUNKS} chunks "
                                 f"{chunk_counts[name]}, expected "
                                 f"{want_counts}")
        out, emit = last[name]
        if (int((st[name].state == 2).sum()) == 0 or int(emit.sum()) == 0
                or not bool(torch.isfinite(st[name].mean).all())):
            raise AssertionError(f"chain route ({name}), chunked: no "
                                 "confirmed / emitted tracks, or a "
                                 "non-finite state")
    if chunk_counts["off"]["resblock"] != 0:
        raise AssertionError("the unrouted step launched K9")

    # the bf16 chains against the unrouted run; the int8 chains, whose
    # change the margin cannot hold, against kernel 7's int8 modes on the
    # same package layer by layer (the same arithmetic: ``mid`` rounded to
    # bf16 and quantized by the second conv, a bf16 shortcut add), from
    # fresh states over as many chunks, and measured against the unrouted
    # run
    per_layer = dict(use_pallas_conv={"int8": resblock_chain_layers(plan)},
                     backbone_int8_pkg=routes["int8"]["backbone_int8_pkg"])
    twin_step = BucketedScannedStep(detector, parts["reid"], det_cfg,
                                    trk_cfg, hw, **kw, **per_layer)
    twin_states = init_stream_states(trk_cfg, STREAMS)
    for _ in range(4 + 2 * RESBLOCK_CHUNKS):
        twin_states, twin_last = twin_step(twin_states, frames)
    same = {
        "bf16": check_route_rows(
            "chain route (bf16), chunked", chunk_rows(last["off"]),
            chunk_rows(last["bf16"]), same_detections=True),
        "int8": check_twin_rows(
            "chain route (int8), chunked", chunk_rows(twin_last),
            chunk_rows(last["int8"])),
        "int8 against off": score_runs(chunk_rows(last["off"]),
                                       chunk_rows(last["int8"]))}
    del twin_step, twin_states, twin_last
    print(f"chain route, chunked (yolov3-416 bf16, {STREAMS} x {FRAME_H}p, "
          f"K={K_FRAMES}, {K_FRAMES * STREAMS} frames per forward): launches "
          f"per chunk K9 {n_chains} (the planner's promise: one per chain, "
          f"chains at 52x52, 26x26, 13x13; {n_kernels} kernels behind "
          f"them, two per block), K7 {k7_routed} (the other convs), K1 1, "
          f"K2 1, K3 {K_FRAMES}; 1 "
          f"readback per chunk and no other sync; decoded output against "
          f"the unrouted detector at {STREAMS} / {K_FRAMES * STREAMS} "
          f"frames, max |err| over the column's scale (each <= "
          f"{TOL_ROUTED_DECODED}): bf16 chains "
          f"{decoded_err[('bf16', STREAMS)]:.4g} / "
          f"{decoded_err[('bf16', K_FRAMES * STREAMS)]:.4g}, int8 chains "
          f"{decoded_err[('int8', STREAMS)]:.4g} / "
          f"{decoded_err[('int8', K_FRAMES * STREAMS)]:.4g}, its box "
          f"columns, max |err| in input pixels: "
          f"{box_err[('bf16', STREAMS)]:.4g} / "
          f"{box_err[('bf16', K_FRAMES * STREAMS)]:.4g} and "
          f"{box_err[('int8', STREAMS)]:.4g} / "
          f"{box_err[('int8', K_FRAMES * STREAMS)]:.4g}; frames/s over "
          f"{RESBLOCK_CHUNKS} chunks, blocks off bf16 int8 int8 bf16 off: "
          f"off {fps['off']}, bf16 {fps['bf16']}, int8 {fps['int8']}; "
          f"{margin_note(margin['chunked'])}; the last chunk's tracks: bf16 "
          f"chains against the unrouted run's (churn 0, mean IoU >= "
          f"{ROUTE_MIN_IOU}, no id remapped) {json.dumps(same['bf16'])}; "
          f"int8 chains equal to kernel 7's int8 modes layer by layer "
          f"{json.dumps(same['int8'])}, against the unrouted run's "
          f"(measured) {json.dumps(same['int8 against off'])}", flush=True)

    # K=1 path
    k1_cfg = dataclasses.replace(det_cfg, conf_thres=margin["K=1"]["thr"])
    args = (detector, parts["reid"], k1_cfg, trk_cfg, hw)
    k1_kw = dict(cap=K1_CAP, crop_window=K1_WINDOW)
    k1 = {"off": make_batched_step(*args, **k1_kw)}
    for name, route in routes.items():
        k1[name] = make_batched_step(*args, **k1_kw, **route)
    ms, rows, k1_counts = {}, {}, {}
    n_reid = n_convs(parts["reid"])
    for name in ("off", "bf16", "int8"):
        # the warm-up: the detector runs eagerly, then is captured, so its
        # kernels count twice; the ReID net's every step
        states = init_stream_states(trk_cfg, STREAMS)
        reset_counters()
        _, _, states = _k1_latency(k1[name], states, base, 5)
        k1_counts[name] = counts()
        routed = name != "off"
        want_counts = {"letterbox": 5, "crops": 0, "crops_dense": 5,
                       "tracker": 5, "resblock": 2 * n_chains * routed,
                       "resblock_kernels": 2 * n_kernels * routed,
                       "conv": 2 * ((k7_routed if routed else k7_off)
                                    - n_reid) + 5 * n_reid}
        if k1_counts[name] != want_counts:
            raise AssertionError(f"chain route ({name}), K=1: launches over "
                                 f"the 5 warm-up steps {k1_counts[name]}, "
                                 f"expected {want_counts}")
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, _, states = _k1_latency(k1[name], states, base, 2)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        reset_counters()
        replays = streams.detector_graph_launches
        ms[name], rows[name], states = _k1_latency(k1[name], states, base,
                                                   RESBLOCK_K1_STEPS)
        got = dict(counts(),
                   detector_graph=streams.detector_graph_launches - replays)
        # every counted step replays the detector's graph
        want_counts = {"letterbox": RESBLOCK_K1_STEPS, "crops": 0,
                       "crops_dense": RESBLOCK_K1_STEPS,
                       "tracker": RESBLOCK_K1_STEPS, "resblock": 0,
                       "resblock_kernels": 0,
                       "conv": n_reid * RESBLOCK_K1_STEPS,
                       "detector_graph": RESBLOCK_K1_STEPS}
        if got != want_counts:
            raise AssertionError(f"chain route ({name}), K=1: launches over "
                                 f"{RESBLOCK_K1_STEPS} steps {got}, "
                                 f"expected {want_counts}")
        if (int((states.state == 2).sum()) == 0
                or sum(len(r) for r in rows[name][-1]) == 0
                or not bool(torch.isfinite(states.mean).all())):
            raise AssertionError(f"chain route ({name}), K=1: no confirmed "
                                 "/ emitted tracks")

    def pct(v, q):
        return float(np.percentile(v, q))

    _, twin_rows, _ = _k1_latency(
        make_batched_step(*args, **k1_kw, **per_layer),
        init_stream_states(trk_cfg, STREAMS), base, 7 + RESBLOCK_K1_STEPS)
    same = {"bf16": check_route_rows("chain route (bf16), K=1", rows["off"],
                                     rows["bf16"], same_detections=True),
            "int8": check_twin_rows("chain route (int8), K=1",
                                    twin_rows[7:], rows["int8"]),
            "int8 against off": score_runs(rows["off"], rows["int8"])}

    print(f"chain route, K=1 (cap {K1_CAP}, window {K1_WINDOW}, {STREAMS} "
          f"frames per forward, {RESBLOCK_K1_STEPS} steps): launches per "
          f"step 1 replay of the detector's graph, K7 {n_reid} (the ReID "
          f"net's), K1 1, dense crops 1, K3 1; at its eager call and its "
          f"capture K9 {n_chains} ({n_kernels} kernels) and K7 "
          f"{k7_routed - n_reid} (off: {k7_off - n_reid}); 1 "
          f"readback per step and "
          f"no other sync; p50 / p99 ms per step: off {pct(ms['off'], 50):.4f}"
          f" / {pct(ms['off'], 99):.4f}, bf16 chains "
          f"{pct(ms['bf16'], 50):.4f} / {pct(ms['bf16'], 99):.4f}, int8 "
          f"chains {pct(ms['int8'], 50):.4f} / {pct(ms['int8'], 99):.4f}; "
          f"threshold {k1_cfg.conf_thres:.6g}, {margin_note(margin['K=1'])}; "
          f"tracks over {RESBLOCK_K1_STEPS} steps: bf16 chains against the "
          f"unrouted run's {json.dumps(same['bf16'])}; int8 chains equal to "
          f"kernel 7's int8 modes layer by layer {json.dumps(same['int8'])}, "
          f"against the unrouted run's (measured) "
          f"{json.dumps(same['int8 against off'])}", flush=True)
    return {"resblock": chunk_counts["bf16"]["resblock"]
            + chunk_counts["int8"]["resblock"],
            "resblock_k1": k1_counts["bf16"]["resblock"]
            + k1_counts["int8"]["resblock"],
            "resblock_kernels_per_step": {
                name: k1_counts[name]["resblock_kernels"] // 2
                for name in routes}}


def run_probe_path(dev):
    """The int8 probe tool at its default shape, (32768, 256) x (256, 256):
    ``run_probe`` holds kernel 10 to its plain version (int8 exactly equal,
    bf16 within 1 bf16 ulp), then times the library and the kernel in both
    types. Prints the probe's JSON record on a line of its own. Returns
    (the record, K10's launches, the bytes in and out per mode, the
    operations)."""
    from yolo_deepsort_tpu_torch.tools import int8_probe

    m, k, n = 32768, 256, 256
    int8_probe.launches = 0
    rec = int8_probe.run_probe(m, k, n, dev)
    launches = int8_probe.launches
    print(json.dumps(rec), flush=True)
    io = {"bf16": 2 * (m * k + k * n + m * n), "int8": m * k + k * n + m * n}
    return rec, launches, io, 2.0 * m * k * n


def probe_kernel_entry(rec, launches, io, ops):
    """K10's entry of the ``kernels`` line: the bf16 product's numbers, the
    int8 product's under ``int8``; ``ms`` called from Python, ``device_ms``
    replayed from a CUDA graph (the library's likewise)."""
    b_bf16 = roofline(io["bf16"], ops, "bf16")
    b_int8 = roofline(io["int8"], ops, "int8")
    return {
        "name": "matmul_probe", "route": "cuda",
        "source": "yolo_deepsort_tpu_torch/csrc/matmul_probe.cu",
        "replaces": "tools/int8_probe.py:90",
        "launches": launches,
        "max_abs_err": rec["kernel_bf16_max_abs_err"],
        "ms": rec["kernel_bf16_ms"], "plain_ms": rec["plain_bf16_ms"],
        "device_ms": rec["kernel_bf16_device_ms"],
        "bound_ms": b_bf16[0], "bound_by": b_bf16[1],
        "library_ms": rec["library_bf16_ms"],
        "library_device_ms": rec["library_bf16_device_ms"],
        "bf16_ulps": rec["kernel_bf16_ulps"], "plan": rec["plan_bf16"],
        "int8": {"ms": rec["kernel_int8_ms"],
                 "device_ms": rec["kernel_int8_device_ms"],
                 "plain_ms": rec["plain_int8_ms"], "bound_ms": b_int8[0],
                 "bound_by": b_int8[1],
                 "library_ms": rec["library_int8_ms"],
                 "library_device_ms": rec["library_int8_device_ms"],
                 "max_abs_err": rec["kernel_int8_max_abs_err"],
                 "plan": rec["plan_int8"]},
        "shape": [rec["m"], rec["k"], rec["n"]],
    }


def seeded_streams(model, frame, thr, counts, **kw):
    """A ``MultiStreamTracker`` (yolov3-416 bf16, seeded ReID weights) over
    len(counts) streams whose producers push ``frame`` counts[i] times into
    the native frame pool in place of a video decoder; ``kw`` goes to the
    constructor."""
    from yolo_deepsort_tpu_torch.config import DetectorConfig
    from yolo_deepsort_tpu_torch.models.reid import random_reid_params
    from yolo_deepsort_tpu_torch.runtime.multistream import MultiStreamTracker

    frame_bgr = np.ascontiguousarray(frame[:, :, ::-1])

    class SeededStreams(MultiStreamTracker):
        def _decoder(self, stream, path):  # a producer without a video file
            try:
                for _ in range(int(path)):
                    if not self._push(stream, frame_bgr):
                        return
            finally:
                self.pool.mark_finished(stream)

    return SeededStreams(model, [str(n) for n in counts],
                         random_reid_params(0), (FRAME_H, FRAME_W),
                         det_config=DetectorConfig(img_size=416,
                                                   conf_thres=thr), **kw)


def run_multistream(dev, tmp_dir):
    """``MultiStreamTracker``'s loop at full width without cv2: producer
    threads push seeded 1080p frames into the port's ``FramePool`` (built
    with g++ at first use), the last stream ends early, and the
    ``with_validity`` step must leave an invalid stream's state untouched
    and emit nothing for it. One readback per step."""
    import torch

    model, frame, thr = facade_model(dev, tmp_dir)
    counts = [MST_FRAMES] * (STREAMS - 1) + [MST_SHORT]
    mst = seeded_streams(model, frame, thr, counts)
    fields = ("mean", "cov", "track_id", "state", "hits", "age",
              "time_since_update", "gallery", "gallery_head",
              "gallery_count", "next_id")
    last = STREAMS - 1
    seen = np.zeros(STREAMS, int)
    steps = frozen = rows = 0
    before = {f: getattr(mst.states, f)[last].clone() for f in fields}
    t0 = time.perf_counter()
    for outputs, emit, valid in mst.run(max_steps=None):
        steps += 1
        seen += valid
        rows += int(emit.sum())
        if outputs.shape != (STREAMS, mst.trk_cfg.max_tracks, 5):
            raise AssertionError(f"outputs shape {outputs.shape}")
        if emit[~valid].any():
            raise AssertionError("an invalid stream emitted rows")
        now = {f: getattr(mst.states, f)[last].clone() for f in fields}
        if not valid[last]:
            frozen += 1
            for f in fields:
                if not torch.equal(now[f], before[f]):
                    raise AssertionError(f"invalid stream's {f} changed")
        before = now
    dt = time.perf_counter() - t0
    mst.close()
    if (seen.tolist() != counts or frozen == 0 or rows == 0
            or mst.host_readbacks != steps):
        raise AssertionError(f"multistream: frames per stream "
                             f"{seen.tolist()} (pushed {counts}), {frozen} "
                             f"steps with the short stream invalid, {rows} "
                             f"rows, {mst.host_readbacks} readbacks in "
                             f"{steps} steps")
    print(f"multistream (yolov3-416 bf16, {STREAMS} x {FRAME_H}p through the "
          f"native frame pool, stream {last} ends after {MST_SHORT} of "
          f"{MST_FRAMES} frames): {steps} steps, frames per stream "
          f"{seen.tolist()}, {frozen} steps left the ended stream's state "
          f"untouched and emitted nothing for it, {rows} rows emitted, 1 "
          f"readback per step, {dt / steps * 1e3:.2f} ms per step "
          f"(host clock, decode threads included)", flush=True)


def _cpu_copy(states):
    """A CPU copy of a ``TrackerState`` or ``GlobalIDState``."""
    if dataclasses.is_dataclass(states):
        return type(states)(**{f.name: getattr(states, f.name).cpu()
                               for f in dataclasses.fields(states)})
    return type(states)(*(t.cpu() for t in states))


def _check_gids(got, want, tag):
    """The card's table ``got`` equals the CPU's ``want`` bit for bit."""
    import torch

    got = _cpu_copy(got)
    for name in ("gid", "owner"):
        a, b = getattr(got, name), getattr(want, name)
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: the card's {name} table differs "
                                 f"from the CPU's at "
                                 f"{int((a != b).sum())} lanes")


def gid_full_width(model, frame, thr):
    """Part 1 of ``run_global_ids``: ``MultiStreamTracker(global_ids=True,
    global_id_every=GID_EVERY)`` over STREAMS x 1080p streams of one frame,
    counted. Every step: emitted ids > 0, and the card's table equals the
    one-rank step (or ``assign_provisional_gids`` between rounds) run on
    the CPU over a CPU copy of the card's states and previous table."""
    import torch

    from yolo_deepsort_tpu_torch.config import TrackerConfig
    from yolo_deepsort_tpu_torch.models.reid import random_reid_params
    from yolo_deepsort_tpu_torch.parallel.streams import (
        assign_provisional_gids,
        init_global_ids,
        make_global_id_step,
        make_stream_mesh,
    )
    from yolo_deepsort_tpu_torch.tracking.tracker import STATE_CONFIRMED
    from yolo_deepsort_tpu_torch.weights import reid_from_params

    cpu_step = make_global_id_step(make_stream_mesh(1, device="cpu"),
                                   TrackerConfig(), STREAMS)
    mst = seeded_streams(model, frame, thr, [GID_FRAMES] * STREAMS,
                         global_ids=True, global_id_every=GID_EVERY)

    def drive():
        prev = init_global_ids(mst.trk_cfg, STREAMS, "cpu")
        steps = rows = rounds = 0
        for outputs, emit, _ in mst.run():
            ids = outputs[emit][:, 4]
            if (ids <= 0).any():
                raise AssertionError(f"step {steps} emitted ids {ids}")
            states = _cpu_copy(mst.states)
            if steps % GID_EVERY == 0:
                want = cpu_step(states, prev)
                rounds += 1
            else:
                want = assign_provisional_gids(states.track_id, prev,
                                               n_streams_total=STREAMS)
            _check_gids(mst.gid_state, want, f"full width, step {steps}")
            prev = want
            steps += 1
            rows += len(ids)
        return steps, rows, rounds, states, prev

    (steps, rows, rounds, states, gids), launched = _counted(drive)
    mst.close()
    counted, graph = _graph_counts(launched, steps)
    reid = reid_from_params(random_reid_params(0))
    want = _only(letterbox=steps, crops_dense=steps,
                 conv=n_convs(model.module) * counted + n_convs(reid) * steps,
                 conv_residual=n_blocks(reid) * steps,
                 tracker=steps, nms=steps, **graph)
    if launched != want:
        raise AssertionError(f"global ids: launches {launched}, want {want}")
    live = gids.gid[states.state == STATE_CONFIRMED]
    unique = len(set(live.tolist()))
    if (mst.host_readbacks != steps or rows == 0 or len(live) == 0
            or not unique < len(live)):
        raise AssertionError(f"global ids: {mst.host_readbacks} readbacks in "
                             f"{steps} steps, {rows} rows, {len(live)} live "
                             f"tracks with {unique} global ids")
    return dict(steps=steps, rows=rows, rounds=rounds, live=len(live),
                unique=unique, launches=launched)


def gid_scene_inputs(scene, cfg, n, t, rng, feats):
    """Frame ``t`` of the reference's two scenes (tests/test_parallel_train
    .py, ``test_global_id_handoff_across_cameras`` and
    ``test_global_id_no_false_aliasing``) at ``cfg``'s sizes: numpy (tlwh,
    conf, feat, mask). Handoff: camera 0 sees the object for t < 10,
    camera n - 1 from t >= 8, each feature its appearance plus noise of
    the reference's norm (sigma 0.02 at 32 dims, scaled by sqrt(32 / F));
    no aliasing: two objects of distinct appearance on every camera."""
    d, f = cfg.max_dets, cfg.feat_dim
    tlwh = np.zeros((n, d, 4), np.float32)
    conf = np.zeros((n, d), np.float32)
    feat = np.zeros((n, d, f), np.float32)
    mask = np.zeros((n, d), bool)
    if scene == "handoff":
        sigma = 0.02 * np.sqrt(32 / f)
        for cam, on, box in ((0, t < 10, [200 + 5 * t, 300, 40, 80]),
                             (n - 1, t >= 8, [100 + 5 * t, 400, 40, 80])):
            if on:
                tlwh[cam, 0], conf[cam, 0], mask[cam, 0] = box, 0.9, True
                v = feats + rng.normal(0, sigma, f)
                feat[cam, 0] = v / np.linalg.norm(v)
    else:
        for s in range(n):
            for j in range(2):
                tlwh[s, j] = [150 + 300 * j + 4 * t, 300, 40, 80]
                conf[s, j], feat[s, j], mask[s, j] = 0.9, feats[s, j], True
    return tlwh, conf, feat, mask


def gid_scene(dev, scene):
    """Part 2 of ``run_global_ids``: one of the reference's scenes at the
    served tracker sizes (``TrackerConfig()``: T 128, nn_budget 100, F 512,
    D 64), STREAMS cameras, through the fused tracker step on the card
    (kernel 3) and the global-id step after every frame; every frame's
    table equals the CPU's on a CPU copy of the card's states. Then the
    scene's claim. -> (states, table) on the card after the last frame,
    and the live tracks' gids."""
    import torch

    from yolo_deepsort_tpu_torch.config import TrackerConfig
    from yolo_deepsort_tpu_torch.parallel.streams import (
        init_global_ids,
        init_stream_states,
        make_global_id_step,
        make_stream_mesh,
    )
    from yolo_deepsort_tpu_torch.tracking.tracker import STATE_CONFIRMED
    from yolo_deepsort_tpu_torch.tracking.tracker_kernel import (
        tracker_step_fused_batched,
    )

    cfg, n = TrackerConfig(), STREAMS
    step = make_global_id_step(make_stream_mesh(1, device=dev), cfg, n)
    cpu_step = make_global_id_step(make_stream_mesh(1, device="cpu"), cfg, n)
    rng = np.random.default_rng(0 if scene == "handoff" else 3)
    if scene == "handoff":
        feats = rng.normal(size=cfg.feat_dim)
        feats /= np.linalg.norm(feats)
        frames = GID_HANDOFF_FRAMES
    else:
        feats = rng.normal(size=(n, 2, cfg.feat_dim))
        feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
        frames = GID_NO_ALIAS_FRAMES
    states = init_stream_states(cfg, n, dev)
    gids = init_global_ids(cfg, n, dev)
    for t in range(frames):
        inputs = gid_scene_inputs(scene, cfg, n, t, rng, feats)
        states, _, _ = tracker_step_fused_batched(
            cfg, states, *(torch.from_numpy(a).to(dev) for a in inputs),
            (720, 1280))
        prev = _cpu_copy(gids)
        gids = step(states, gids)
        _check_gids(gids, cpu_step(_cpu_copy(states), prev),
                    f"{scene} scene, frame {t}")
    g, trk = gids.gid.cpu(), states.state.cpu()
    live = g[trk == STATE_CONFIRMED].tolist()
    if scene == "handoff":
        lane = int(torch.argmax((trk[n - 1] == STATE_CONFIRMED).int()))
        if trk[n - 1, lane] != STATE_CONFIRMED or g[n - 1, lane] != 1:
            raise AssertionError(f"no handoff: camera {n - 1}'s gids "
                                 f"{g[n - 1].tolist()}")
    elif len(live) != 2 * n or len(set(live)) != 2 * n:
        raise AssertionError(f"false aliasing: live gids {sorted(live)}")
    return states, gids, live


def gid_queries(states, d, seed):
    """(S, d, F) unit queries on the states' device, seeded: the first half
    gallery slot 0 of random lanes plus a little noise (a match exists),
    the rest random."""
    import torch

    s, t, _, f = states.gallery.shape
    gen = torch.Generator(device=states.gallery.device).manual_seed(seed)
    dev = states.gallery.device
    lanes = torch.randint(0, t, (s, d), generator=gen, device=dev)
    rows = torch.gather(states.gallery, 1,
                        lanes[..., None, None].expand(s, d, 1, f))[:, :, 0]
    noise = torch.randn((s, d, f), generator=gen, device=dev)
    q = torch.where((torch.arange(d, device=dev) < d // 2)[None, :, None],
                    rows + 0.01 * noise, noise)
    return torch.nn.functional.normalize(q, dim=-1)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def init_one_rank_nccl(dev) -> None:
    """A real NCCL process group of one rank over a local store. An NCCL
    that cannot start raises (no gloo fallback)."""
    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", free_port(), 1, True)
    dist.init_process_group("nccl", store=store, world_size=1, rank=0,
                            device_id=dev)


def gid_nccl(dev, cases):
    """Part 3 of ``run_global_ids``: a real NCCL process group of one rank
    over a local store. Through it the global-id step and the matcher must
    equal the mesh without a group bit for bit. An NCCL that cannot start
    fails the phase (no gloo fallback)."""
    import torch
    import torch.distributed as dist

    from yolo_deepsort_tpu_torch.config import TrackerConfig
    from yolo_deepsort_tpu_torch.parallel.streams import (
        make_cross_camera_matcher,
        make_global_id_step,
        make_stream_mesh,
    )

    init_one_rank_nccl(dev)
    try:
        grouped = make_stream_mesh(device=dev)
        plain = make_stream_mesh(1, device=dev)
        if grouped.group is None or dist.get_backend(grouped.group) != "nccl":
            raise AssertionError("the mesh did not take the NCCL group")
        cfg = TrackerConfig()
        checked = 0
        for tag, states, gids in cases:
            a = make_global_id_step(grouped, cfg, STREAMS)(states, gids)
            b = make_global_id_step(plain, cfg, STREAMS)(states, gids)
            _check_gids(a, _cpu_copy(b), f"NCCL group vs none, {tag}")
            q = gid_queries(states, GID_MATCH_DETS, checked)
            qmask = torch.ones(q.shape[:2], dtype=torch.bool, device=dev)
            ids_a, d_a = make_cross_camera_matcher(grouped, cfg)(states, q,
                                                                 qmask)
            ids_b, d_b = make_cross_camera_matcher(plain, cfg)(states, q,
                                                               qmask)
            if not (torch.equal(ids_a, ids_b) and torch.equal(d_a, d_b)):
                raise AssertionError(f"NCCL group vs none, matcher, {tag}")
            checked += 1
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    return checked


def gid_step_timings(dev):
    """Part 4 of ``run_global_ids``, the device side: the global-id step's
    device ms (CUDA events, GID_REPS calls) and peak memory on a mesh of
    one rank at S = 8 and 16 streams of the served sizes, every lane a
    confirmed track with a full gallery (the work is dense: the same at
    any fill), and the matcher's at S = 8, D = GID_MATCH_DETS queries."""
    import torch

    from yolo_deepsort_tpu_torch.config import TrackerConfig
    from yolo_deepsort_tpu_torch.parallel.streams import (
        init_global_ids,
        init_stream_states,
        make_cross_camera_matcher,
        make_global_id_step,
        make_stream_mesh,
    )
    from yolo_deepsort_tpu_torch.tracking.tracker import STATE_CONFIRMED

    cfg = TrackerConfig()
    t, b, f = cfg.max_tracks, cfg.nn_budget, cfg.feat_dim
    mesh = make_stream_mesh(1, device=dev)
    out = {}
    for s in (8, 16):
        gen = torch.Generator(device=dev).manual_seed(s)
        states = dataclasses.replace(
            init_stream_states(cfg, s, dev),
            gallery=torch.nn.functional.normalize(torch.randn(
                (s, t, b, f), generator=gen, device=dev), dim=-1),
            state=torch.full((s, t), STATE_CONFIRMED, dtype=torch.int32,
                             device=dev),
            track_id=torch.arange(1, t + 1, dtype=torch.int32,
                                  device=dev).expand(s, t).contiguous(),
            gallery_head=torch.randint(0, b, (s, t), generator=gen,
                                       device=dev, dtype=torch.int32),
            gallery_count=torch.full((s, t), b, dtype=torch.int32,
                                     device=dev))
        gids = init_global_ids(cfg, s, dev)
        step = make_global_id_step(mesh, cfg, s)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(states, gids)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = cuda_ms(lambda: step(states, gids), GID_REPS)
        q = s * t
        bound = roofline(nbytes(states.gallery), 2.0 * s * t * b * f * q,
                         "f32")
        rec = dict(ms=ms, peak_gib=peak / 2 ** 30, bound=bound,
                   sims_gib=s * t * b * q * 4 / 2 ** 30)
        if s == 8:
            match = make_cross_camera_matcher(mesh, cfg)
            qf = gid_queries(states, GID_MATCH_DETS, 1)
            qmask = torch.ones(qf.shape[:2], dtype=torch.bool, device=dev)
            rec["match_ms"] = cuda_ms(lambda: match(states, qf, qmask),
                                      GID_REPS)
            qm = s * GID_MATCH_DETS
            rec["match_bound"] = roofline(nbytes(states.gallery, qf),
                                          2.0 * s * t * b * f * qm, "f32")
        out[s] = rec
        del states, gids
    return out


def gid_step_ms(model, frame, thr):
    """Part 4 of ``run_global_ids``, end to end: ``MultiStreamTracker`` ms
    per step (host clock between yields, the first GID_WARM_STEPS left
    out) with global ids off and on, in the alternated blocks of
    GID_BLOCKS; -> {"off": [...], "on": [...], "full": [...]}, each block's
    median. Each stream's ring holds all of its frames, so the producers
    push them and exit. The last block ("full", global ids off) keeps the
    default ring of 8, where a producer finds its ring full; it used to
    loop on ``push`` and the GIL there (F9), and now waits for a pop."""
    import time as _time

    n = GID_WARM_STEPS + GID_TIMED_STEPS
    res = {"off": [], "on": [], "full": []}
    for on, key, depth in ([(on, "on" if on else "off", n)
                            for on in GID_BLOCKS] + [(False, "full", 8)]):
        mst = seeded_streams(model, frame, thr, [n] * STREAMS,
                             ring_depth=depth, global_ids=on,
                             global_id_every=GID_EVERY)
        times, last = [], None
        for i, _ in enumerate(mst.run()):
            now = _time.perf_counter()
            if i >= GID_WARM_STEPS:
                times.append((now - last) * 1e3)
            last = now
        mst.close()
        res[key].append(float(np.median(times)))
    return res


def run_global_ids(dev, tmp_dir, card):
    """The cross-camera global-ID path (``parallel/streams.py``
    ``make_global_id_step``, ``make_cross_camera_matcher``; the stream mesh
    of ``parallel/mesh.py``), four parts: the full-width
    ``MultiStreamTracker(global_ids=True)`` run (counted), the reference's
    two scenes at the served tracker sizes, a real NCCL group of one rank,
    and the timings. -> the counted run's launches."""
    model, frame, thr = facade_model(dev, tmp_dir)
    full = gid_full_width(model, frame, thr)
    print(f"global ids (MultiStreamTracker(global_ids=True, global_id_every="
          f"{GID_EVERY}), yolov3-416 bf16, {STREAMS} x {FRAME_H}p, one frame "
          f"on every stream): {full['steps']} steps, {full['rounds']} gid "
          f"rounds, every table equal to the CPU's one-rank step on the "
          f"card's states bit for bit, {full['rows']} rows emitted with ids "
          f"> 0, 1 readback per step, {full['live']} live tracks under "
          f"{full['unique']} global ids; launches per step K1 1, dense "
          f"crops 1, K7 {full['launches']['conv'] // full['steps']}, K3 1",
          flush=True)
    cases = []
    for scene in ("handoff", "no_aliasing"):
        states, gids, live = gid_scene(dev, scene)
        cases.append((scene, states, gids))
        print(f"global ids, {scene} scene ({STREAMS} cameras, T 128, "
              f"nn_budget 100, F 512, kernel 3): every frame's table equal "
              f"to the CPU's bit for bit; "
              + ("camera 7's track took gid 1" if scene == "handoff" else
                 f"{len(live)} live tracks, {len(set(live))} global ids"),
              flush=True)
    checked = gid_nccl(dev, cases)
    print(f"global ids through a real NCCL group of one rank: the gid step "
          f"and the matcher ({GID_MATCH_DETS} queries a stream) equal the "
          f"mesh without a group bit for bit ({checked} cases)", flush=True)
    del cases
    timings = gid_step_timings(dev)
    for s, r in timings.items():
        extra = ("" if "match_ms" not in r else
                 f"; matcher at D = {GID_MATCH_DETS}: {r['match_ms']:.4f} ms "
                 f"of device time, bound {r['match_bound'][0]:.4f} ms "
                 f"({r['match_bound'][1]})")
        print(f"global-id step at S = {s} (T 128, nn_budget 100, F 512, "
              f"f32 products, TF32 off): {r['ms']:.4f} ms of device time, "
              f"peak memory {r['peak_gib']:.4f} GiB above its inputs "
              f"(the similarities alone {r['sims_gib']:.4f} GiB), bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]}){extra} ({card})",
              flush=True)
    ms = gid_step_ms(model, frame, thr)
    print(f"MultiStreamTracker ms per step ({STREAMS} x {FRAME_H}p, "
          f"yolov3-416 bf16, host clock, rings holding every frame, medians "
          f"of {GID_TIMED_STEPS} steps, blocks alternated): global ids "
          f"off {[round(v, 4) for v in ms['off']]}, on (every {GID_EVERY} "
          f"steps) {[round(v, 4) for v in ms['on']]}; off with full rings "
          f"of 8, the producers waiting for pops: "
          f"{[round(v, 4) for v in ms['full']]} ({card})", flush=True)
    return full["launches"]


def jv_problem(rng, s, r, c):
    """A seeded batch of two-stage JV problems (torch CPU tensors): costs
    on a coarse grid (exact ties), INFTY gates, inactive rows and columns,
    cascade levels 0-5, per-stream stage-A thresholds, stream 0 with no
    active stage-A row."""
    import torch

    cost_a = rng.integers(0, 12, (s, r, c)).astype(np.float32) / 40
    cost_a[rng.uniform(size=(s, r, c)) < 0.3] = 1e5
    levels = rng.integers(0, 6, (s, r)).astype(np.int32)
    rows_a = rng.uniform(size=(s, r)) < 0.6
    rows_a[0] = False
    cols = rng.uniform(size=(s, c)) < 0.85
    cost_b = rng.integers(0, 30, (s, r, c)).astype(np.float32) / 30
    cost_b[rng.uniform(size=(s, r, c)) < 0.2] = 1e5
    rows_b = (rng.uniform(size=(s, r)) < 0.4) | (
        rows_a & (rng.uniform(size=(s, r)) < 0.5))
    maxd_a = (rng.integers(3, 9, s) / 40).astype(np.float32)
    return [torch.from_numpy(v) for v in (cost_a, levels, rows_a, cols,
                                          maxd_a, cost_b, rows_b)]


def _host_ms(fn, reps: int) -> float:
    """Median host-clock ms of fn() (CPU work, or CUDA work it syncs)."""
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def _synced(fn):
    import torch

    def run():
        out = fn()
        torch.cuda.synchronize()
        return out
    return run


def check_jv_cascade(rng, dev):
    import torch

    from yolo_deepsort_tpu_torch.ops import assignment_kernel as AK
    from yolo_deepsort_tpu_torch.ops.assignment import (
        solve_cascade_assignment,
    )

    prob = jv_problem(rng, *JV_SHAPE)[:5]
    on_dev = [v.to(dev) for v in prob]
    got = AK.cascade_cuda(*on_dev).cpu()
    want = AK.solve_cascade_assignment_fused(*prob)
    if not torch.equal(got, want) or int((want >= 0).sum()) == 0:
        raise AssertionError("jv_cascade: kernel assignments differ from "
                             "the plain solver (or nothing matched)")
    if not AK.last_staged:
        raise AssertionError("jv_cascade: JV_SHAPE left shared memory")
    work = longest_stream_work([
        lambda i=i: solve_cascade_assignment(
            *(v[i] for v in prob[:4]), float(prob[4][i]))
        for i in range(JV_SHAPE[0])])
    bufs = AK.cascade_inputs(*on_dev)
    kernel_ms = cuda_ms(lambda: AK.cascade_kernel(*bufs), 50)
    device_ms = cuda_graph_ms(lambda: AK.cascade_kernel(*bufs), 50)
    wrapper_ms = _host_ms(_synced(lambda: AK.cascade_cuda(*on_dev)), 10)
    plain_ms = _host_ms(lambda: AK.solve_cascade_assignment_fused(*prob), 5)
    return 0.0, kernel_ms, plain_ms, (
        f" (CPU), {int((want >= 0).sum())} matches; device {device_ms:.4f} "
        f"ms; whole wrapper {wrapper_ms:.4f} ms (host clock); longest "
        f"stream {work[0]} rows, {work[1]} Dijkstra steps"), nbytes(
        *_tensors(*bufs), got), chain_entry(work, device_ms)


def check_jv_two_stage(rng, dev):
    import torch

    from yolo_deepsort_tpu_torch.ops import assignment_kernel as AK
    from yolo_deepsort_tpu_torch.ops.assignment import (
        solve_two_stage_assignment,
    )

    prob = jv_problem(rng, *JV_SHAPE)
    args = prob + [0.7]
    on_dev = [v.to(dev) for v in prob] + [0.7]
    got = AK.two_stage_cuda(*on_dev)
    want = AK.solve_two_stage_assignment_fused(*args)
    for stage, g, w in zip("AB", got, want):
        if not torch.equal(g.cpu(), w) or int((w >= 0).sum()) == 0:
            raise AssertionError(f"jv_two_stage: stage {stage} assignments "
                                 "differ from the plain solver (or nothing "
                                 "matched)")
    if not AK.last_staged:
        raise AssertionError("jv_two_stage: JV_SHAPE left shared memory")
    work = longest_stream_work([
        lambda i=i: solve_two_stage_assignment(
            *(v[i] for v in prob[:4]), float(prob[4][i]), prob[5][i],
            prob[6][i], 0.7)
        for i in range(JV_SHAPE[0])])
    bufs = AK.two_stage_inputs(*on_dev)
    kernel_ms = cuda_ms(lambda: AK.two_stage_kernel(*bufs), 50)
    device_ms = cuda_graph_ms(lambda: AK.two_stage_kernel(*bufs), 50)
    wrapper_ms = _host_ms(_synced(lambda: AK.two_stage_cuda(*on_dev)), 10)
    plain_ms = _host_ms(lambda: AK.solve_two_stage_assignment_fused(*args),
                        5)
    return 0.0, kernel_ms, plain_ms, (
        f" (CPU), {int((want[0] >= 0).sum())} + {int((want[1] >= 0).sum())}"
        f" matches; device {device_ms:.4f} ms; whole wrapper "
        f"{wrapper_ms:.4f} ms (host clock); longest stream {work[0]} rows, "
        f"{work[1]} Dijkstra steps"), nbytes(*_tensors(*bufs), *got), \
        chain_entry(work, device_ms)


def run_jv_ops(dev):
    """The public JV ops on the card over 8 streams of tracker-sized
    problems, against the same ops on the CPU. Returns K4's launches."""
    import torch

    from yolo_deepsort_tpu_torch.ops import assignment_kernel as AK

    cost, levels, rows, cols, maxd, cost_b, rows_b = jv_problem(
        np.random.default_rng(7), *JV_SHAPE)
    AK.cascade_launches = 0
    got = [AK.solve_cascade_assignment_fused(
        *(v.to(dev) for v in (cost, levels, rows, cols, maxd))),
        AK.solve_masked_assignment_fused(
            *(v.to(dev) for v in (cost_b, rows_b, cols)), 0.7)]
    launches = AK.cascade_launches
    want = [AK.solve_cascade_assignment_fused(cost, levels, rows, cols, maxd),
            AK.solve_masked_assignment_fused(cost_b, rows_b, cols, 0.7)]
    for name, g, w in zip(("cascade", "masked"), got, want):
        if not torch.equal(g.cpu(), w):
            raise AssertionError(f"public JV op {name}: card and CPU differ")
    if launches != 2:
        raise AssertionError(f"public JV ops: {launches} K4 launches, not 2")
    print(f"public JV ops (S={JV_SHAPE[0]}, R={JV_SHAPE[1]}, C="
          f"{JV_SHAPE[2]}): cascade and masked solves on the card equal the "
          f"CPU ({int((want[0] >= 0).sum())} and {int((want[1] >= 0).sum())}"
          f" matches); K4 launches {launches}", flush=True)
    return launches


def _walking_scene(rng, n_obj, n_frames, h, w):
    """Textured objects walking on a jittered grid, one per cell (no two
    boxes overlap), each missing from ~15% of frames (occlusions): (frames
    (N, H, W, 3) uint8, per-frame (n, 4) cx, cy, w, h boxes)."""
    rows, cols = 4, (n_obj + 3) // 4
    cell_h, cell_w = h // rows, w // cols
    # sizes and drift keep every box inside its cell and the frame
    sizes = np.stack([rng.uniform(40, 0.6 * cell_w, n_obj),
                      rng.uniform(100, 0.6 * cell_h, n_obj)], 1).astype(int)
    centre = np.stack([(np.arange(n_obj) % cols + 0.5) * cell_w,
                       (np.arange(n_obj) // cols + 0.5) * cell_h], 1)
    centre += rng.uniform(-8, 8, centre.shape)
    vel = rng.uniform(-3, 3, (n_obj, 2))
    textures = [rng.integers(0, 256, (bh, bw, 3), np.uint8)
                for bw, bh in sizes]
    frames = np.full((n_frames, h, w, 3), 30, np.uint8)
    boxes = []
    for t in range(n_frames):
        seen = rng.uniform(size=n_obj) > 0.15
        rows_t = []
        for i in np.flatnonzero(seen):
            cx, cy = centre[i] + vel[i] * t
            bw, bh = sizes[i]
            x1, y1 = int(cx - bw / 2), int(cy - bh / 2)
            frames[t, y1:y1 + bh, x1:x1 + bw] = textures[i]
            rows_t.append((cx, cy, bw, bh))
        boxes.append(np.array(rows_t, np.float32))
    return frames, boxes


def facade_model(dev, tmp_dir):
    """The ``Darknet`` facade (yolov3-416) loaded from a ``.weights`` file
    of the seeded weights, a 1080p frame, and the objectness threshold that
    lets ~TARGET_DETS of its candidates through."""
    import torch

    from specs.weights_np import random_darknet_weights
    from yolo_deepsort_tpu_torch import api
    from yolo_deepsort_tpu_torch.ops import letterbox_kernel
    from yolo_deepsort_tpu_torch.tools.honest_load import plant_box_prior
    from yolo_deepsort_tpu_torch.weights import (
        load_darknet_weights,
        save_darknet_weights,
    )

    model = api.Darknet("yolov3", img_size=416, device=dev)
    blob = random_darknet_weights(model.plan.defs(), seed=0,
                                  well_conditioned=True)
    header, raw = load_darknet_weights(blob, model.plan.defs())
    raw = plant_box_prior(raw, model.plan, (FRAME_H, FRAME_W))
    path = f"{tmp_dir}/yolov3-416.weights"
    save_darknet_weights(path, header, raw, model.plan.defs())
    model.load_darknet_weights(path)

    frame = np.random.default_rng(3).integers(
        0, 256, (FRAME_H, FRAME_W, 3), np.uint8)
    with torch.no_grad():
        x = letterbox_kernel.letterbox_batch_fused(
            torch.from_numpy(frame[None]).to(dev), 416, torch.bfloat16)
        obj = model.module_for(torch.bfloat16)(x)[0, :, 4]
    thr = float(torch.sort(obj, descending=True).values[TARGET_DETS - 1])
    return model, frame, thr


def facade_setup(dev, tmp_dir):
    """``facade_model`` and a bf16 ``VideoTracker`` at its threshold, warmed
    up and reset."""
    from yolo_deepsort_tpu_torch import api

    model, frame, thr = facade_model(dev, tmp_dir)
    vt = api.VideoTracker(model, tracked_classes=None, conf_thres=thr,
                          half=True)
    vt.track_frame(frame)  # warm-up: library handles, the bf16 model copy
    vt.reset()
    return frame, thr, vt


def run_facades(dev, tmp_dir):
    """The public facades on the card at full width (``run_facades`` in
    the module docstring). Returns the launches of K5, the NMS (in
    ``track_frame``) and the ROI NMS (in ``DeepSort.update`` with
    ``nms_max_overlap`` ROI_NMS_OVERLAP)."""
    import torch

    from yolo_deepsort_tpu_torch import api
    from yolo_deepsort_tpu_torch.ops import (
        assignment_kernel,
        crops_kernel,
        letterbox_kernel,
        nms_kernel,
    )
    from yolo_deepsort_tpu_torch.tracking import tracker_kernel

    frame, thr, vt = facade_setup(dev, tmp_dir)
    n_init = vt.trk_cfg.n_init
    counters = (letterbox_kernel, crops_kernel, tracker_kernel, nms_kernel)
    for k in counters:
        k.launches = 0
    assignment_kernel.two_stage_launches = 0
    readbacks, ms, rows = vt.host_readbacks, [], []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(FACADE_FRAMES):
            t0 = time.perf_counter()
            rows.append(vt.track_frame(frame))
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    per_frame = {"letterbox": letterbox_kernel.launches,
                 "crops": crops_kernel.launches,
                 "tracker": tracker_kernel.launches,
                 "jv_two_stage": assignment_kernel.two_stage_launches,
                 "nms": nms_kernel.launches}
    readbacks = vt.host_readbacks - readbacks
    counts = [len(r) for r in rows]
    if (any(counts[:n_init - 1]) or not all(counts[n_init - 1:])
            or readbacks != FACADE_FRAMES):
        raise AssertionError(f"track_frame: rows per frame {counts}, "
                             f"{readbacks} readbacks in {FACADE_FRAMES} calls")
    want = {"letterbox": FACADE_FRAMES, "crops": 0, "tracker": 0,
            "jv_two_stage": FACADE_FRAMES, "nms": FACADE_FRAMES}
    if per_frame != want:
        raise AssertionError(f"track_frame launches {per_frame}, expected "
                             f"{want}")
    track_frame_ms = float(np.median(ms[1:]))

    for k in counters:
        k.launches = 0
    chunk = vt.track_frames(np.stack([frame] * 4))
    chunked = {k.__name__.rsplit(".", 1)[1]: k.launches for k in counters}
    if min(chunked.values()) == 0 or not all(len(r) for r in chunk):
        raise AssertionError(f"track_frames: launches {chunked}, rows per "
                             f"frame {[len(r) for r in chunk]}")

    # DeepSort: the card against the CPU on one seeded scene
    frames, boxes = _walking_scene(np.random.default_rng(5), TARGET_DETS,
                                   FACADE_FRAMES, FRAME_H, FRAME_W)
    conf = [np.full(len(b), 0.9, np.float32) for b in boxes]
    api.DeepSort(device=dev).update(boxes[0], conf[0], frames[0])  # warm-up
    card, cpu = api.DeepSort(device=dev), api.DeepSort(device="cpu")
    assignment_kernel.two_stage_launches = 0
    card_ms, emitted = [], 0
    for t in range(FACADE_FRAMES):
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            got = card.update(boxes[t], conf[t], frames[t])
            card_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want_rows = cpu.update(boxes[t], conf[t], frames[t])
        if not np.array_equal(got, want_rows):
            raise AssertionError(f"DeepSort frame {t}: card rows differ "
                                 f"from the CPU's:\n{got}\n{want_rows}")
        emitted += len(got)
    update_launches = assignment_kernel.two_stage_launches
    if (emitted == 0 or card.host_readbacks != FACADE_FRAMES
            or update_launches != FACADE_FRAMES):
        raise AssertionError(f"DeepSort: {emitted} rows, "
                             f"{card.host_readbacks} readbacks, "
                             f"{update_launches} K5 launches")
    update_ms = float(np.median(card_ms[1:]))

    # DeepSort with the ROI NMS on (the deep_sort config's NMS_MAX_OVERLAP):
    # the card (its kernel, once a call) against the CPU (its plain version)
    card = api.DeepSort(device=dev, nms_max_overlap=ROI_NMS_OVERLAP)
    cpu = api.DeepSort(device="cpu", nms_max_overlap=ROI_NMS_OVERLAP)
    nms_kernel.roi_launches = 0
    roi_rows = 0
    for t in range(FACADE_FRAMES):
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = card.update(boxes[t], conf[t], frames[t])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want_rows = cpu.update(boxes[t], conf[t], frames[t])
        if not np.array_equal(got, want_rows):
            raise AssertionError(f"DeepSort with the ROI NMS, frame {t}: "
                                 f"card rows differ from the CPU's:\n{got}\n"
                                 f"{want_rows}")
        roi_rows += len(got)
    roi_launches = nms_kernel.roi_launches
    if roi_rows == 0 or roi_launches != FACADE_FRAMES:
        raise AssertionError(f"DeepSort with the ROI NMS: {roi_rows} rows, "
                             f"{roi_launches} ROI NMS launches")
    print(f"facades (yolov3-416 bf16 from a .weights file, 1 x {FRAME_H}p, "
          f"threshold {thr:.4f}): track_frame x{FACADE_FRAMES} rows per frame "
          f"{counts}, launches {per_frame}, 1 readback per call and no other "
          f"sync, median {track_frame_ms:.4f} ms per call; track_frames K=4 "
          f"launches {chunked}, rows {[len(r) for r in chunk]}; "
          f"DeepSort.update x{FACADE_FRAMES} ({sum(len(b) for b in boxes)} "
          f"boxes, f32 ReID) card rows == CPU rows ({emitted} rows), "
          f"{update_launches} K5 launches, median {update_ms:.4f} ms per "
          f"call; with nms_max_overlap {ROI_NMS_OVERLAP}: card rows == CPU "
          f"rows ({roi_rows} rows), {roi_launches} ROI NMS launches",
          flush=True)
    return {"jv_two_stage": per_frame["jv_two_stage"] + update_launches,
            "nms": per_frame["nms"], "roi_nms": roi_launches}


def _timed(fn, repeats: int):
    """(last result, median host ms) of fn() between two synchronizes."""
    import torch

    out, ms = None, []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(ms))


def _device_kernels(run):
    """``torch.profiler`` over run(): {device op name: [launches, device
    us]}."""
    import torch

    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            acc = per_kernel.setdefault(e.name, [0, 0.0])
            acc[0] += 1
            acc[1] += e.time_range.elapsed_us()
    return per_kernel


def _device_profile(run, units: int, unit: str, unprofiled_ms: float):
    """``torch.profiler`` over run(), which does ``units`` units of work:
    prints the device time per unit, the device ops per unit, the idle share
    against ``unprofiled_ms`` per unit, and the top 15 device ops."""
    per_kernel = _device_kernels(run)
    dev_ms = sum(us for _, us in per_kernel.values()) / 1e3 / units
    print(f"profile: device time per {unit} {dev_ms:.4f} ms over "
          f"{sum(n for n, _ in per_kernel.values()) // units} device ops; "
          f"unprofiled {unit} {unprofiled_ms:.4f} ms; idle share "
          f"{1 - dev_ms / unprofiled_ms:.4f}", flush=True)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:15]
    for name, (n, us) in top:
        print(f"profile:   {us / 1e3 / units:9.4f} ms/{unit} "
              f"{n // units:6d} per {unit}  {name[:100]}")
    return per_kernel


def profile_main_path(dev, repeats: int = 5):
    """``--profile``: where the main path's time goes. Prints, on the setup
    of ``run_main_path``: the pipelined chunk with the event readback
    against the plain-copy readback (runs alternated A B B A, 4 times);
    each stage and each part alone by host clock around a synchronize
    (medians of ``repeats``); and the device time per chunk from
    ``torch.profiler``
    over 4 pipelined chunks, its top ops, and the idle share it implies."""
    import torch

    from yolo_deepsort_tpu_torch.ops.crops_kernel import (
        crop_and_normalize_fused,
    )
    from yolo_deepsort_tpu_torch.ops.letterbox_kernel import (
        letterbox_batch_fused,
    )
    from yolo_deepsort_tpu_torch.ops.nms import (
        batched_nms_with_stats,
        batched_nms_with_stats_plain,
    )
    from yolo_deepsort_tpu_torch.parallel.streams import _frame_boxes
    from yolo_deepsort_tpu_torch.tracking.tracker_kernel import (
        tracker_step_fused_batched,
    )

    step, states, frames, parts = main_path_setup(dev)
    det_cfg, trk_cfg = parts["det_cfg"], parts["trk_cfg"]
    for _ in range(2):
        states, _ = step(states, frames)
    torch.cuda.synchronize()

    def chunk_ms(event_readback):
        nonlocal states
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, _ = pipelined(step, states, frames, CHUNKS, event_readback)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / CHUNKS * 1e3

    ab = {True: [], False: []}
    for mode in (True, False, False, True) * 4:
        ab[mode].append(chunk_ms(mode))
    print(f"profile: pipelined chunk ms, event readback {ab[True]}, plain "
          f"copy readback {ab[False]}", flush=True)

    def timed(fn):
        return _timed(fn, repeats)

    handle, detect_ms = timed(lambda: step.detect(frames))
    _, track_ms = timed(lambda: step.track(states, handle))
    k, s = frames.shape[:2]
    flat = frames.reshape(k * s, FRAME_H, FRAME_W, 3)
    thr = torch.as_tensor(parts["conf_vec"], device=dev).repeat(k)
    cap, win = step.last_bucket, step.last_window
    with torch.no_grad():
        xs, lb_ms = timed(lambda: letterbox_batch_fused(flat, 416,
                                                        torch.bfloat16))
        dec, bb_ms = timed(lambda: parts["detector"](xs))
        (b7, mask, _), nms_ms = timed(lambda: batched_nms_with_stats(
            dec, thr, det_cfg.nms_thres, det_cfg.max_boxes,
            trk_cfg.max_dets))
        _, nms_plain_ms = timed(lambda: batched_nms_with_stats_plain(
            dec, thr, det_cfg.nms_thres, det_cfg.max_boxes,
            trk_cfg.max_dets))
        xyxy, tlwh = _frame_boxes(b7[:, :cap], 416, FRAME_H, FRAME_W)
        crops, crops_ms = timed(lambda: crop_and_normalize_fused(
            flat, xyxy.contiguous(), *win))
        feats, reid_ms = timed(lambda: parts["reid"](
            crops.reshape(-1, *crops.shape[2:])))
    cfg_c = dataclasses.replace(trk_cfg, max_dets=cap)
    feats = feats.reshape(k, s, cap, -1)
    tlwh, conf = tlwh.reshape(k, s, cap, 4), b7[:, :cap, 5].reshape(k, s, cap)
    m = mask[:, :cap].reshape(k, s, cap)
    _, trk_ms = timed(lambda: tracker_step_fused_batched(
        cfg_c, states, tlwh[0], conf[0], feats[0], m[0],
        (FRAME_H, FRAME_W)))
    print(f"profile: detect stage {detect_ms:.4f} ms, track stage "
          f"{track_ms:.4f} ms; alone: letterbox {lb_ms:.4f}, backbone + "
          f"decode {bb_ms:.4f}, NMS {nms_ms:.4f} (kernel; its plain "
          f"version {nms_plain_ms:.4f}), crops {crops_ms:.4f}, "
          f"ReID embed ({crops.shape[0] * crops.shape[1]} crops) "
          f"{reid_ms:.4f}, one tracker step {trk_ms:.4f} ms", flush=True)

    def advance():
        nonlocal states
        states, _ = pipelined(step, states, frames, 4)

    _device_profile(advance, 4, "chunk", float(np.median(ab[True])))


def profile_k1(dev, repeats: int = 5):
    """``--profile``: where a K=1 step's time goes, on the setup of
    ``run_k1_path``: the whole step (with its readback) with the conv route
    and without it, each part alone by host clock around a synchronize
    (medians of ``repeats``), then the device time per step from
    ``torch.profiler`` over 4 routed steps, the idle share, and the conv
    kernel's share of the device time."""
    import torch

    from yolo_deepsort_tpu_torch.ops.letterbox_kernel import (
        letterbox_batch_fused,
    )
    from yolo_deepsort_tpu_torch.ops.nms import (
        batched_nms,
        batched_nms_with_stats_plain,
    )
    from yolo_deepsort_tpu_torch.parallel.streams import (
        _frame_boxes,
        _make_conv_impl,
        init_stream_states,
        make_k1_crops,
    )
    from yolo_deepsort_tpu_torch.tracking.tracker_kernel import (
        tracker_step_fused_batched,
    )

    routed, unrouted, base, parts = k1_setup(dev)
    det_cfg, trk_cfg = parts["det_cfg"], parts["trk_cfg"]
    states = init_stream_states(trk_cfg, STREAMS)
    _, _, states = _k1_latency(routed, states, base, 6)
    on_ms, _, states = _k1_latency(routed, states, base, 10)
    off_ms, _, states = _k1_latency(unrouted, states, base, 10)
    step_ms = float(np.median(on_ms))

    def timed(fn):
        return _timed(fn, repeats)

    # the routed step's conv hook, rebuilt from the same package
    impl = _make_conv_impl(CONV_ROUTE, parts["int8_pkg"])
    cfg_c = dataclasses.replace(trk_cfg, max_dets=K1_CAP)
    with torch.no_grad():
        xs, lb_ms = timed(lambda: letterbox_batch_fused(base, 416,
                                                        torch.bfloat16))
        parts["detector"](xs, conv_impl=impl)  # upload the package once
        dec, bb_on = timed(lambda: parts["detector"](xs, conv_impl=impl))
        _, bb_off = timed(lambda: parts["detector"](xs))
        (b7, mask), nms_ms = timed(lambda: batched_nms(
            dec, det_cfg.conf_thres, det_cfg.nms_thres, det_cfg.max_boxes,
            K1_CAP))
        _, nms_plain_ms = timed(lambda: batched_nms_with_stats_plain(
            dec, det_cfg.conf_thres, det_cfg.nms_thres, det_cfg.max_boxes,
            K1_CAP))
        xyxy, tlwh = _frame_boxes(b7, 416, FRAME_H, FRAME_W)
        crops_of = make_k1_crops((FRAME_H, FRAME_W), K1_WINDOW,
                                 torch.bfloat16)
        crops, crops_ms = timed(lambda: crops_of(base, xyxy, mask))
        feats, reid_ms = timed(lambda: parts["reid"](
            crops.reshape(-1, *crops.shape[2:])))
        feats = feats.reshape(STREAMS, K1_CAP, -1)
        _, trk_ms = timed(lambda: tracker_step_fused_batched(
            cfg_c, states, tlwh, b7[..., 5], feats, mask,
            (FRAME_H, FRAME_W)))
    print(f"profile: K=1 step {step_ms:.4f} ms with the conv route, "
          f"{float(np.median(off_ms)):.4f} ms without; alone: letterbox "
          f"{lb_ms:.4f}, backbone + decode {bb_on:.4f} routed / {bb_off:.4f} "
          f"library convs, NMS (cap {K1_CAP}) {nms_ms:.4f} (kernel; its "
          f"plain version {nms_plain_ms:.4f}), crops (one "
          f"dense launch) {crops_ms:.4f}, ReID embed ({STREAMS * K1_CAP} "
          f"crops) {reid_ms:.4f}, tracker step {trk_ms:.4f} ms", flush=True)

    def advance():
        nonlocal states
        _, _, states = _k1_latency(routed, states, base, 4)

    per_kernel = _device_profile(advance, 4, "K=1 step", step_ms)
    conv = [(c, us) for name, (c, us) in per_kernel.items()
            if "conv_ring_kernel" in name and ("BackboneEpilogue" in name
                                               or "ShortcutEpilogue" in name)]
    conv_us = sum(us for _, us in conv)
    total_us = sum(us for _, us in per_kernel.values())
    print(f"profile: conv kernel (K7) {conv_us / 4e3:.4f} ms per K=1 step "
          f"over {sum(c for c, _ in conv) / 4:.0f} launches (every conv of "
          f"the bf16 detector and ReID net, {N_ROUTED} of them routed), "
          f"share of device time {conv_us / total_us:.4f}", flush=True)


def profile_int8_embed(dev, repeats: int = 5):
    """``--profile``: the ReID embed's share of device time with the int8
    route and without it, on the setups of ``run_int8_embed_paths``. Per
    embed route: the pipelined chunk (host clock, median of ``repeats``) and
    its device time (``torch.profiler``, 4 chunks), the embed alone on the
    chunk's crops (host clock and device time), their ratio, and the same
    for one K=1 embed of EMBED_CROPS crops with its top 8 device ops; for
    the int8 route also kernel 8's own device time per chunk."""
    import torch

    from yolo_deepsort_tpu_torch.models.quantize import (
        reid_apply_int8_resident,
    )
    from yolo_deepsort_tpu_torch.ops.crops_kernel import (
        crop_and_normalize_fused,
    )
    from yolo_deepsort_tpu_torch.parallel.streams import (
        BucketedScannedStep,
        _frame_boxes,
        init_stream_states,
    )

    bf16_step, _, frames, parts = main_path_setup(dev)
    trk_cfg, det_cfg = parts["trk_cfg"], parts["det_cfg"]
    _, pkg = reid_int8_package(dev)
    int8_step = BucketedScannedStep(
        parts["detector"], pkg, det_cfg, trk_cfg, (FRAME_H, FRAME_W),
        buckets=(16, 24, 32, 36, 40, 48),
        conf_thres_per_stream=parts["conf_vec"],
        embed_int8="resident_pallas")
    embeds = {
        "bf16": (bf16_step, parts["reid"]),
        "int8": (int8_step, lambda c: reid_apply_int8_resident(
            pkg, c, use_pallas=True)),
    }
    k, s = frames.shape[:2]
    flat = frames.reshape(k * s, FRAME_H, FRAME_W, 3)
    for name, (step, embed) in embeds.items():
        states = init_stream_states(trk_cfg, STREAMS)
        for _ in range(2):
            states, _ = step(states, frames)

        def advance():
            nonlocal states
            states, _ = pipelined(step, states, frames, 4)

        _, four_ms = _timed(advance, repeats)
        per_kernel = _device_kernels(advance)
        chunk_dev = sum(us for _, us in per_kernel.values()) / 4e3
        k8_dev = sum(us for n, (_, us) in per_kernel.items()
                     if "conv_ring_kernel" in n
                     and "ReidEpilogue" in n) / 4e3
        cap, win = step.last_bucket, step.last_window
        with torch.no_grad():
            b7 = step.detect(frames)[1]
            xyxy, _ = _frame_boxes(b7[:, :cap], 416, FRAME_H, FRAME_W)
            crops = crop_and_normalize_fused(flat, xyxy.contiguous(), *win)
            crops = crops.reshape(-1, *crops.shape[2:])
            _, embed_ms = _timed(lambda: embed(crops), repeats)
            embed_dev = sum(us for _, us in _device_kernels(
                lambda: embed(crops)).values()) / 1e3
            k1_crops = crops[:EMBED_CROPS]
            _, k1_ms = _timed(lambda: embed(k1_crops), repeats)
            k1_kernels = _device_kernels(lambda: embed(k1_crops))
            k1_dev = sum(us for _, us in k1_kernels.values()) / 1e3
        print(f"profile: {name} embed: pipelined chunk {four_ms / 4:.4f} ms, "
              f"device time {chunk_dev:.4f} ms per chunk; the embed alone on "
              f"the chunk's {crops.shape[0]} crops (bucket {cap}) "
              f"{embed_ms:.4f} ms by host clock, {embed_dev:.4f} ms of "
              f"device time, share of the chunk's device time "
              f"{embed_dev / chunk_dev:.4f}; kernel 8 {k8_dev:.4f} ms per "
              f"chunk; one K=1 embed of {k1_crops.shape[0]} crops "
              f"{k1_ms:.4f} ms by host clock, {k1_dev:.4f} ms of device time",
              flush=True)
        top = sorted(k1_kernels.items(), key=lambda kv: -kv[1][1])[:8]
        for op, (n, us) in top:
            print(f"profile:   {us / 1e3:9.4f} ms/embed {n:6d} per embed  "
                  f"{op[:100]}")


def profile_resblock(dev, repeats: int = 5):
    """``--profile``: the routed detect stage. The main path's detector on
    the K=1 step's 8 frames and on a chunk's 32, without the chain route,
    with bf16 chains and with int8 chains: backbone + decode by host clock
    around a synchronize (median of ``repeats``), its device time from
    ``torch.profiler``, the part and share of kernels 7 and 9 (one main
    loop under one kernel name: since the bf16 forward runs every conv off
    the chains through kernel 7, their times are read together), and the
    top 6 device ops; then the whole detect stage of the chunked step per
    route."""
    import torch

    from yolo_deepsort_tpu_torch.ops.letterbox_kernel import (
        letterbox_batch_fused,
    )
    from yolo_deepsort_tpu_torch.parallel.streams import (
        _make_block_impl,
        make_scanned_detect_stage,
    )

    _, _, frames, parts = main_path_setup(dev)
    det_cfg, trk_cfg, plan = parts["det_cfg"], parts["trk_cfg"], parts["plan"]
    detector = parts["detector"]
    routes = dict(off={}, **resblock_routes(dev, parts, frames[0]))
    k, s = frames.shape[:2]
    flat = frames.reshape(k * s, FRAME_H, FRAME_W, 3)
    with torch.no_grad():
        for n, batch in ((STREAMS, frames[0]), (k * s, flat)):
            xs = letterbox_batch_fused(batch, det_cfg.img_size,
                                       torch.bfloat16)
            n_ops = {}
            for name, route in routes.items():
                impl = _make_block_impl(plan, route.get("use_resblock"),
                                        route.get("backbone_int8_pkg"))
                run = lambda: detector(xs, block_impl=impl)  # noqa: E731
                run()  # the chains' weights are packed on the first call
                _, host_ms = _timed(run, repeats)
                per_kernel = _device_kernels(run)
                dev_ms = sum(us for _, us in per_kernel.values()) / 1e3
                # kernels 7 (every conv off the chains, the bf16
                # default) and 9 launch one main loop under one kernel
                # name: their device time is read together
                k9_ms = sum(us for op, (_, us) in per_kernel.items()
                            if "conv_ring_kernel" in op) / 1e3
                k9_n = sum(c for op, (c, _) in per_kernel.items()
                           if "conv_ring_kernel" in op)
                n_ops[name] = sum(c for c, _ in per_kernel.values())
                print(f"profile: backbone + decode, {n} frames, chain route "
                      f"{name}: {host_ms:.4f} ms by host clock, device time "
                      f"{dev_ms:.4f} ms over {n_ops[name]} device ops "
                      f"(unrouted: {n_ops['off']}); kernels 7 and 9 "
                      f"{k9_ms:.4f} ms in {k9_n} kernels, "
                      f"share of the backbone's device time "
                      f"{k9_ms / dev_ms:.4f}", flush=True)
                top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:6]
                for op, (c, us) in top:
                    print(f"profile:   {us / 1e3:9.4f} ms {c:5d} launches  "
                          f"{op[:100]}")
    for name, route in routes.items():
        detect = make_scanned_detect_stage(
            detector, det_cfg, trk_cfg, (FRAME_H, FRAME_W),
            conf_thres_per_stream=parts["conf_vec"], **route)
        detect(frames)
        _, stage_ms = _timed(lambda: detect(frames), repeats)
        per_kernel = _device_kernels(lambda: detect(frames))
        print(f"profile: detect stage of a chunk, chain route {name}: "
              f"{stage_ms:.4f} ms by host clock, device time "
              f"{sum(us for _, us in per_kernel.values()) / 1e3:.4f} ms",
              flush=True)


def profile_facades(dev, tmp_dir, repeats: int = 5):
    """``--profile``: where a facade call's time goes, on the setup of
    ``run_facades``: ``VideoTracker.track_frame`` whole and each part alone
    by host clock around a synchronize (medians of ``repeats``), then the
    device time per call from ``torch.profiler`` over 4 calls, its top ops
    and idle share; the same for ``DeepSort.update`` on the smoke scene."""
    import torch

    from yolo_deepsort_tpu_torch import api
    from yolo_deepsort_tpu_torch.ops import boxes as B
    from yolo_deepsort_tpu_torch.ops.crops import crop_and_normalize
    from yolo_deepsort_tpu_torch.ops.letterbox_kernel import (
        letterbox_batch_fused,
    )
    from yolo_deepsort_tpu_torch.ops.nms import (
        batched_nms,
        batched_nms_with_stats_plain,
    )
    from yolo_deepsort_tpu_torch.parallel.streams import _frame_boxes
    from yolo_deepsort_tpu_torch.tracking.tracker import tracker_step

    frame, _, vt = facade_setup(dev, tmp_dir)
    for _ in range(4):  # confirmed tracks, galleries filling
        vt.track_frame(frame)
    _, call_ms = _timed(lambda: vt.track_frame(frame), repeats)
    det, trk, dtype = vt.det_cfg, vt.trk_cfg, vt.compute_dtype
    hw = (FRAME_H, FRAME_W)
    with torch.no_grad():
        up, up_ms = _timed(lambda: torch.from_numpy(frame[None]).pin_memory()
                           .to(dev, non_blocking=True), repeats)
        x, lb_ms = _timed(lambda: letterbox_batch_fused(
            up, det.img_size, dtype), repeats)
        dec, bb_ms = _timed(lambda: vt.model.module_for(dtype)(x), repeats)
        (b7, mask), nms_ms = _timed(lambda: batched_nms(
            dec, det.conf_thres, det.nms_thres, det.max_boxes,
            trk.max_dets), repeats)
        _, nms_plain_ms = _timed(lambda: batched_nms_with_stats_plain(
            dec, det.conf_thres, det.nms_thres, det.max_boxes,
            trk.max_dets), repeats)
        xyxy, tlwh = _frame_boxes(b7, det.img_size, *hw)
        crops, crops_ms = _timed(lambda: crop_and_normalize(
            up[0], xyxy[0], compute_dtype=dtype), repeats)
        feats, reid_ms = _timed(lambda: vt.reid(crops), repeats)
        _, trk_ms = _timed(lambda: tracker_step(
            trk, vt.state, tlwh, b7[..., 5], feats[None], mask, hw), repeats)
    print(f"profile: track_frame {call_ms:.4f} ms per call; alone: upload "
          f"{up_ms:.4f}, letterbox {lb_ms:.4f}, backbone + decode "
          f"{bb_ms:.4f}, NMS {nms_ms:.4f} (kernel; its plain version "
          f"{nms_plain_ms:.4f}), dense crops {crops_ms:.4f}, ReID "
          f"embed ({crops.shape[0]} crops) {reid_ms:.4f}, tracker step with "
          f"K5 {trk_ms:.4f} ms", flush=True)
    _device_profile(lambda: [vt.track_frame(frame) for _ in range(4)], 4,
                    "track_frame", call_ms)

    frames, boxes = _walking_scene(np.random.default_rng(5), TARGET_DETS,
                                   FACADE_FRAMES, FRAME_H, FRAME_W)
    ds = api.DeepSort(device=dev)
    for t in range(4):
        ds.update(boxes[t], np.full(len(boxes[t]), 0.9), frames[t])
    conf = np.full(len(boxes[4]), 0.9)
    _, upd_ms = _timed(lambda: ds.update(boxes[4], conf, frames[4]), repeats)
    n, d = len(boxes[4]), ds.cfg.max_dets
    tl = np.zeros((1, d, 4), np.float32)
    tl[0, :n, :2] = boxes[4][:, :2] - boxes[4][:, 2:] / 2
    tl[0, :n, 2:] = boxes[4][:, 2:]
    tl = torch.from_numpy(tl).to(dev)
    cf = torch.from_numpy(np.where(np.arange(d) < n, 0.9, 0.0)[None].astype(
        np.float32)).to(dev)
    img = torch.from_numpy(frames[4]).to(dev)
    with torch.no_grad():
        crops, crops_ms = _timed(lambda: crop_and_normalize(
            img, B.tlwh_to_xyxy(tl[0])), repeats)
        feats, reid_ms = _timed(lambda: ds.reid(crops), repeats)
        _, trk_ms = _timed(lambda: tracker_step(
            ds.cfg, ds.state, tl, cf, feats[None], cf > 0, hw), repeats)
    print(f"profile: DeepSort.update {upd_ms:.4f} ms per call; alone: dense "
          f"crops {crops_ms:.4f}, ReID embed ({d} crops, f32) {reid_ms:.4f}, "
          f"tracker step with K5 {trk_ms:.4f} ms", flush=True)
    _device_profile(lambda: [ds.update(boxes[4], conf, frames[4])
                             for _ in range(4)], 4, "update", upd_ms)


# ---- the monolithic chunk step, F8 and the tracking-quality gate

SCAN_BLOCKS, SCAN_BLOCK_CHUNKS = 4, 3  # timed blocks per step, chunks each
F8_HW = (480, 854)  # a frame the reference's crop gate refuses (854 % 128)
# the tracking-quality scene: benchmarks/mot_eval.py synthetic_eval's, one
# seed per stream, at its tracker configuration
MOT_STREAMS, MOT_FRAMES, MOT_OBJECTS, MOT_FEAT = 4, 120, 8, 64
TRAIN_STEPS = 5  # SGD steps of each training phase on its fixed batch
YOLO_TRAIN_BATCH, REID_TRAIN_BATCH, REID_CLASSES = 8, 64, 751
# the tiny nets' 3 steps on the card against the CPU, each card step
# started from the CPU step's params, optimizer state and BN stats: the
# loss within TOL_TRAIN_LOSS relative, the BN stats within TOL_TRAIN_STATS
# relative (atol 1e-6), the step's update of all params together within
# TOL_TRAIN_UPDATE of its norm (L2 norm of the difference over the L2
# norm of the CPU's update): f32 without TF32 on both, summed in another
# order. A ReLU whose input lies within rounding of zero passes its
# gradient on one side only, and the batch-statistics BN spreads that over
# the channel (tests/test_torch_port_train_reid.py): measured 8.1e-3 for
# the ReID net (cuDNN's f32 convs against oneDNN's; the CPU against the JAX
# package 1.1e-3), 3.7e-6 for the detector (leaky ReLU); single ReID leaves
# 3-10% of their own change
TOL_TRAIN_LOSS, TOL_TRAIN_STATS, TOL_TRAIN_UPDATE = 1e-4, 1e-3, 3e-2


def _forced_steps(tag, cpu_state, step, to_card, n=3):
    """``n`` training steps on the CPU and on the card, each card step
    started from a copy of the CPU's state before it (``to_card``): per
    step the loss, the returned BN stats and the params' update held to
    the TOL_TRAIN_* bounds. ``cpu_state``: (params, opt, stats);
    ``step(state)`` -> (state, loss). Returns the worst ratios seen."""
    import torch

    from yolo_deepsort_tpu_torch.utils.checkpoint import tree_leaves

    worst = {"loss": 0.0, "stats": 0.0, "update": 0.0}
    for k in range(n):
        card_state = to_card(cpu_state)
        before = [p.detach().clone() for p in tree_leaves(cpu_state[0])]
        cpu_state, cpu_loss = step(cpu_state)
        card_state, card_loss = step(card_state)
        rel = abs(float(card_loss) - float(cpu_loss)) / abs(float(cpu_loss))
        worst["loss"] = max(worst["loss"], rel)
        for a, b in zip(tree_leaves(card_state[2]), tree_leaves(cpu_state[2])):
            r = float(((a.cpu() - b).abs() - 1e-6).clamp(min=0).max()
                      / b.abs().max().clamp(min=1e-12))
            worst["stats"] = max(worst["stats"], r)
        card, cpu = (torch.cat([p.detach().cpu().flatten() for p in
                                tree_leaves(st[0])]) for st in (card_state,
                                                           cpu_state))
        moved = cpu - torch.cat([p.flatten() for p in before])
        ratio = float((card - cpu).norm() / moved.norm())
        worst["update"] = max(worst["update"], ratio)
        if (rel > TOL_TRAIN_LOSS or worst["stats"] > TOL_TRAIN_STATS
                or ratio > TOL_TRAIN_UPDATE):
            raise AssertionError(f"{tag} step {k}: card vs CPU {worst}")
    return worst


def _timed_steps(step_once, n):
    """n calls of step_once() -> (losses, ms per step by CUDA events, peak
    device memory in GiB)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step_once()
        end.record()
        torch.cuda.synchronize()
        losses.append(float(loss))
        ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"training losses {losses}: not finite or not "
                             "falling")
    return losses, ms, peak


def _generated_targets(rng, batch, max_targets, n_classes, per_image=4):
    """(max_targets, 6) rows [b, cls, cx, cy, w, h] and the mask: per_image
    boxes in each image, normalized."""
    t = np.zeros((max_targets, 6), np.float32)
    mask = np.zeros(max_targets, bool)
    for i in range(batch * per_image):
        t[i] = [i // per_image, rng.integers(0, n_classes),
                *rng.uniform(0.2, 0.8, 2), *rng.uniform(0.05, 0.4, 2)]
        mask[i] = True
    return t, mask


def run_yolo_training(dev, tmp_dir):
    """YOLO detection training (``train/yolo_cli.py``) on the card: yolov3
    at full width, 416 px, batch YOLO_TRAIN_BATCH of generated images
    (uniform [0, 1]) and targets (4 boxes an image), TRAIN_STEPS SGD steps
    of the cfg's optimizer without burn-in (lr 1e-3, momentum 0.9, decay
    5e-4) on the fixed batch: the loss finite and falling; ms per step and
    peak memory. Then the JAX CLI tests' tiny net (64 px, batch 4) for 3
    steps on the card against the CPU (``_forced_steps``), and the CLI
    itself on the card on a generated image list: 1 epoch, ``--resume`` for
    a second, ``--export-weights``, the file loaded into the inference
    ``Darknet`` on the card."""
    import os

    import torch
    from PIL import Image

    from yolo_deepsort_tpu_torch.cfg import parse_model_config
    from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES
    from yolo_deepsort_tpu_torch.models.darknet import build_network
    from yolo_deepsort_tpu_torch.train import yolo_cli as TC
    from yolo_deepsort_tpu_torch.train.trees import to_torch
    from yolo_deepsort_tpu_torch.utils.checkpoint import load_pytree
    from yolo_deepsort_tpu_torch.weights import (darknet_from_raw,
                                                 load_darknet_weights,
                                                 random_raw_params)

    rng = np.random.default_rng(3)
    defs = ARCHITECTURES["yolov3"](img_size=416)
    plan = build_network(defs)
    params, stats = TC.raw_params_to_train(random_raw_params(plan.defs()),
                                           plan.defs())
    params = to_torch(params, dev, trainable=True)
    stats = [to_torch(stats, dev)]
    opt = TC.build_optimizer(dict(defs[0], burn_in="0"), params)
    step = TC.make_detection_train_step(plan)
    imgs = torch.from_numpy(rng.uniform(0, 1, (YOLO_TRAIN_BATCH, 416, 416, 3))
                            .astype(np.float32)).to(dev)
    t, mask = _generated_targets(rng, YOLO_TRAIN_BATCH, 64, 80)
    t, mask = torch.from_numpy(t).to(dev), torch.from_numpy(mask).to(dev)

    def once():
        stats[0], loss, _ = step(params, opt, stats[0], imgs, t, mask)
        return loss

    losses, ms, peak = _timed_steps(once, TRAIN_STEPS)
    rec = {"losses": losses, "ms": ms, "peak_gib": peak}
    del params, stats, opt

    # the tiny net, card against CPU
    cfg = os.path.join(tmp_dir, "tiny.cfg")
    with open(cfg, "w") as f:
        f.write(TINY_TRAIN_CFG)
    tdefs = parse_model_config(cfg)
    tplan = build_network(tdefs)
    raw = random_raw_params(tplan.defs())
    p0, s0 = TC.raw_params_to_train(raw, tplan.defs())
    timgs = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    tt, tm = _generated_targets(rng, 4, 8, 2, per_image=1)
    tstep = TC.make_detection_train_step(tplan)

    def fresh(params, opt_state, stats, device):
        params = to_torch(params, device, trainable=True)
        opt = TC.build_optimizer(tdefs[0], params)
        if opt_state is not None:
            opt.load_state(opt_state)
        return params, opt, to_torch(stats, device)

    def one(state):
        params, opt, stats = state
        stats, loss, _ = tstep(params, opt, stats, timgs, tt, tm)
        return (params, opt, stats), loss

    rec["tiny"] = _forced_steps(
        "tiny detector", fresh(p0, None, s0, "cpu"), one,
        lambda st: fresh(st[0], st[1].state(), st[2], dev))

    # the CLI on the card
    paths = []
    os.makedirs(os.path.join(tmp_dir, "images"))
    os.makedirs(os.path.join(tmp_dir, "labels"))
    for i in range(8):
        p = os.path.join(tmp_dir, "images", f"im{i}.png")
        Image.fromarray(rng.integers(0, 256, (48, 64, 3), np.uint8)).save(p)
        with open(os.path.join(tmp_dir, "labels", f"im{i}.txt"), "w") as f:
            f.write("0 0.5 0.5 0.3 0.3\n1 0.2 0.3 0.1 0.2")
        paths.append(p)
    lst = os.path.join(tmp_dir, "train.txt")
    with open(lst, "w") as f:
        f.write("\n".join(paths))
    ckpt = os.path.join(tmp_dir, "yolo.npz")
    out = os.path.join(tmp_dir, "out.weights")
    args = ["--cfg", cfg, "--data", lst, "--batch-size", "4",
            "--max-targets", "16", "--ckpt", ckpt, "--log-interval", "100"]
    TC.main(args + ["--epochs", "1"])  # --device: the card by default
    TC.main(args + ["--epochs", "1", "--resume", "--export-weights", out])
    ck = load_pytree(ckpt)
    if int(ck["seen"]) != 16 or int(ck["opt_state"]["count"]) != 4:
        raise AssertionError(f"yolo CLI: seen {ck['seen']}, count "
                             f"{ck['opt_state']['count']}")
    _, raw_out = load_darknet_weights(out, tplan.defs())
    model = darknet_from_raw(tplan, raw_out).to(dev)
    with torch.no_grad():
        dets = model(torch.from_numpy(timgs.clip(0, 1)).to(dev))
    if dets.shape != (4, 3 * 8 * 8, 7) or not bool(torch.isfinite(dets).all()):
        raise AssertionError("yolo CLI: the exported weights do not run")
    return rec


def run_reid_training(dev, tmp_dir):
    """ReID classifier training (``train/reid_train.py``) on the card: the
    512-d net with a REID_CLASSES-class head at 128 x 64, batch
    REID_TRAIN_BATCH of N(0, 1) crops and seeded labels, TRAIN_STEPS SGD
    steps (lr 0.1, momentum 0.9, decay 5e-4) on the fixed batch: the loss
    finite and falling; ms per step and peak memory. Then 3 steps of a
    5-class net on 4 crops on the card against the CPU
    (``_forced_steps``), and the CLI on the card on a generated image
    folder: train 1 epoch, resume for a second, test, evaluate."""
    import os

    import torch
    from PIL import Image

    from yolo_deepsort_tpu_torch.train import reid_cli
    from yolo_deepsort_tpu_torch.train import reid_train as RT
    from yolo_deepsort_tpu_torch.train.trees import to_torch
    from yolo_deepsort_tpu_torch.utils.checkpoint import tree_leaves

    rng = np.random.default_rng(4)
    params, stats = RT.init_train_params(num_classes=REID_CLASSES)
    params = to_torch(params, dev, trainable=True)
    stats = [to_torch(stats, dev)]
    init, step = RT.make_train_step()
    opt = init(params)
    x = torch.from_numpy(rng.normal(0, 1, (REID_TRAIN_BATCH, 128, 64, 3))
                         .astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, REID_CLASSES,
                                           REID_TRAIN_BATCH)).to(dev)

    def once():
        stats[0], loss, _ = step(params, opt, stats[0], x, labels)
        return loss

    losses, ms, peak = _timed_steps(once, TRAIN_STEPS)
    rec = {"losses": losses, "ms": ms, "peak_gib": peak}
    del params, stats, opt

    p0, s0 = RT.init_train_params(num_classes=5, seed=3)
    cx = rng.normal(0, 1, (4, 128, 64, 3)).astype(np.float32)
    cl = np.array([0, 1, 2, 3])

    def fresh(params, bufs, stats, device):
        params = to_torch(params, device, trainable=True)
        opt = init(params)
        for p, buf in zip(tree_leaves(params), bufs):
            if buf is not None:
                opt.state[p]["momentum_buffer"] = buf.detach().to(
                    device).clone()
        return params, opt, to_torch(stats, device)

    def one(state):
        params, opt, stats = state
        stats, loss, _ = step(params, opt, stats, cx, cl)
        return (params, opt, stats), loss

    def to_card(st):
        bufs = [st[1].state.get(p, {}).get("momentum_buffer")
                for p in tree_leaves(st[0])]
        return fresh(st[0], bufs, st[2], dev)

    rec["tiny"] = _forced_steps("tiny ReID", fresh(p0, [], s0, "cpu"), one,
                                to_card)

    root = os.path.join(tmp_dir, "reid")
    for split in ("train", "test", "query", "gallery"):
        for c in range(3):
            d = os.path.join(root, split, f"id{c}")
            os.makedirs(d)
            for i in range(4):
                img = np.clip(rng.normal(60 * c + 40, 30, (128, 64, 3)), 0,
                              255).astype(np.uint8)
                Image.fromarray(img).save(os.path.join(d, f"{i}.png"))
    feats = os.path.join(tmp_dir, "feats.npz")
    common = ["--data-dir", root, "--ckpt", os.path.join(tmp_dir, "r.npz"),
              "--batch-size", "4", "--log-interval", "100", "--features",
              feats]
    reid_cli.main(["train", "--epochs", "1"] + common)
    reid_cli.main(["train", "--epochs", "2", "--resume"] + common)
    reid_cli.main(["test"] + common)
    reid_cli.main(["evaluate"] + common)
    z = np.load(feats)
    if z["query"].shape != (12, 512) or not np.allclose(
            np.linalg.norm(z["query"], axis=1), 1.0, atol=1e-5):
        raise AssertionError("ReID CLI: query features")
    return rec


# ---- the training mesh (``parallel/mesh.py`` ``make_train_mesh``)

PARALLEL_TRAIN_STEPS = 3  # SGD steps of each net through each mesh
TRAIN_MESHES = ("none", "no group", "NCCL")


def _train_through_meshes(meshes, start):
    """PARALLEL_TRAIN_STEPS steps from one start through each mesh.
    ``start(mesh)`` -> (params, stats, step_once), ``step_once()`` -> the
    loss (the stats kept inside). -> {mesh name: {"losses", "ms",
    "peak_gib", "first", "last"}}: per-step losses, ms by CUDA events,
    peak device memory, and the (params, stats) after the first step and
    after the last, flat, copied to the host (so no mesh's copies weigh on
    the next one's peak; the first step's copy lies inside its timing,
    with cuDNN's set-up)."""
    import torch

    from yolo_deepsort_tpu_torch.utils.checkpoint import tree_leaves

    recs = {}
    for name in TRAIN_MESHES:
        params, stats, step_once = start(meshes[name])

        def flat():
            return (torch.cat([p.detach().flatten()
                               for p in tree_leaves(params)]).cpu(),
                    torch.cat([v.flatten()
                               for v in tree_leaves(stats[0])]).cpu())

        rec = recs[name] = {}

        def once():
            loss = step_once()
            if "first" not in rec:
                rec["first"] = flat()
            return loss

        rec["losses"], rec["ms"], rec["peak_gib"] = _timed_steps(
            once, PARALLEL_TRAIN_STEPS)
        rec["last"] = flat()
        del params, stats, step_once, once
    return recs


def _check_train_meshes(tag, recs, before):
    """The NCCL mesh against the mesh without a group: every loss, and the
    params and statistics after the first step and after the last, bit for
    bit. The mesh against ``mesh=None`` (its BN and loss divide sums by the
    global count where ``mesh=None`` takes means), over the first step,
    which both take from one start: the loss within TOL_TRAIN_LOSS
    relative, the stats within TOL_TRAIN_STATS of their largest (atol
    1e-6), the update of the params within TOL_TRAIN_UPDATE of its norm.
    The later steps start from states that differ by that rounding, so
    only their losses are reported (``loss_later``). -> the ratios."""
    import torch

    nccl, grouped, none = (recs[k] for k in ("NCCL", "no group", "none"))
    if not (nccl["losses"] == grouped["losses"] and all(
            torch.equal(a, b) for at in ("first", "last")
            for a, b in zip(nccl[at], grouped[at]))):
        raise AssertionError(f"{tag}: the NCCL mesh differs from the mesh "
                             f"without a group: losses {nccl['losses']} "
                             f"against {grouped['losses']}")
    (p_mesh, s_mesh), (p_none, s_none) = grouped["first"], none["first"]
    rel = [abs(a - b) / abs(b) for a, b in zip(grouped["losses"],
                                              none["losses"])]
    worst = {
        "loss": rel[0], "loss_later": max(rel[1:]),
        "stats": float(((s_mesh - s_none).abs() - 1e-6).clamp(min=0).max()
                       / s_none.abs().max()),
        "update": float((p_mesh - p_none).norm() / (p_none - before).norm())}
    if (worst["loss"] > TOL_TRAIN_LOSS or worst["stats"] > TOL_TRAIN_STATS
            or worst["update"] > TOL_TRAIN_UPDATE):
        raise AssertionError(f"{tag}: the mesh against mesh=None {worst}")
    return worst


def _parallel_yolo(dev, meshes):
    """``run_yolo_training``'s load (yolov3-416, full width and depth,
    batch YOLO_TRAIN_BATCH, the cfg's SGD without burn-in) through each
    mesh; on a mesh the targets are the whole batch's and the images this
    rank's shard, which on one rank is the batch."""
    import torch

    from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES
    from yolo_deepsort_tpu_torch.models.darknet import build_network
    from yolo_deepsort_tpu_torch.train import yolo_cli as TC
    from yolo_deepsort_tpu_torch.train.trees import shard_train_tree, to_torch
    from yolo_deepsort_tpu_torch.utils.checkpoint import tree_leaves
    from yolo_deepsort_tpu_torch.weights import random_raw_params

    rng = np.random.default_rng(3)
    defs = ARCHITECTURES["yolov3"](img_size=416)
    plan = build_network(defs)
    p0, s0 = TC.raw_params_to_train(random_raw_params(plan.defs()),
                                    plan.defs())
    imgs = torch.from_numpy(rng.uniform(0, 1, (YOLO_TRAIN_BATCH, 416, 416, 3))
                            .astype(np.float32)).to(dev)
    t, mask = _generated_targets(rng, YOLO_TRAIN_BATCH, 64, 80)
    t, mask = torch.from_numpy(t).to(dev), torch.from_numpy(mask).to(dev)

    def start(mesh):
        if mesh is None:
            params, stats = to_torch(p0, dev, True), [to_torch(s0, dev)]
        else:
            params = shard_train_tree(p0, mesh, trainable=True)
            stats = [shard_train_tree(s0, mesh)]
        opt = TC.build_optimizer(dict(defs[0], burn_in="0"), params)
        step = TC.make_detection_train_step(plan, mesh=mesh)

        def once():
            stats[0], loss, _ = step(params, opt, stats[0], imgs, t, mask)
            return loss
        return params, stats, once

    recs = _train_through_meshes(meshes, start)
    before = torch.cat([torch.from_numpy(np.asarray(p)).flatten()
                        for p in tree_leaves(p0)])
    return recs, _check_train_meshes("yolov3-416 training", recs, before)


def _parallel_reid(dev, meshes):
    """``run_reid_training``'s load (the 512-d net, a REID_CLASSES-class
    head, batch REID_TRAIN_BATCH, SGD lr 0.1, momentum 0.9, decay 5e-4)
    through each mesh; on the NCCL mesh both axes are the group, so the
    head's copy_to_mp / reduce_from_mp go through NCCL too."""
    import torch

    from yolo_deepsort_tpu_torch.train import reid_train as RT
    from yolo_deepsort_tpu_torch.train.trees import shard_train_tree, to_torch
    from yolo_deepsort_tpu_torch.utils.checkpoint import tree_leaves

    rng = np.random.default_rng(4)
    p0, s0 = RT.init_train_params(num_classes=REID_CLASSES)
    x = torch.from_numpy(rng.normal(0, 1, (REID_TRAIN_BATCH, 128, 64, 3))
                         .astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, REID_CLASSES,
                                           REID_TRAIN_BATCH)).to(dev)

    def start(mesh):
        if mesh is None:
            params, stats = to_torch(p0, dev, True), [to_torch(s0, dev)]
        else:
            params = shard_train_tree(p0, mesh, trainable=True)
            stats = [shard_train_tree(s0, mesh)]
        init, step = RT.make_train_step(mesh=mesh)
        opt = init(params)

        def once():
            stats[0], loss, _ = step(params, opt, stats[0], x, labels)
            return loss
        return params, stats, once

    recs = _train_through_meshes(meshes, start)
    before = torch.cat([torch.from_numpy(np.asarray(p)).flatten()
                        for p in tree_leaves(p0)])
    return recs, _check_train_meshes("ReID training", recs, before)


def run_parallel_training(dev):
    """The training mesh on one card (``parallel/mesh.py``
    ``make_train_mesh``, ``parallel/collectives.py``, ``train/sync_bn.py``):
    the full-width loads of ``run_yolo_training`` and
    ``run_reid_training``, each PARALLEL_TRAIN_STEPS steps from one seeded
    start through ``mesh=None``, a mesh without a group (its collectives
    the identity) and a real one-rank NCCL mesh, whose dp and mp axes are
    the NCCL group: every all-reduce -- the BN statistics, the loss
    counts, the gradients' flat buffer, the ReID head's pair -- goes
    through NCCL. ``_check_train_meshes`` holds them together; ms per step
    and peak memory of each. cuDNN runs deterministic in this phase (its
    default wgrad algorithms may sum in an order that changes from run to
    run). Then the dryrun tool (``tools/dryrun_multichip.py``) on one
    NCCL rank. -> ({net: (records, ratios)}, the dryrun's lines)."""
    import contextlib
    import io

    import torch
    import torch.distributed as dist

    from yolo_deepsort_tpu_torch.parallel.mesh import make_train_mesh
    from yolo_deepsort_tpu_torch.tools import dryrun_multichip

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    init_one_rank_nccl(dev)
    try:
        meshes = {"none": None, "no group": make_train_mesh(1, 1, device=dev),
                  "NCCL": make_train_mesh(device=dev)}
        nccl = meshes["NCCL"]
        if not (nccl.dp_group is not None and nccl.mp_group is not None
                and dist.get_backend(nccl.dp_group) == "nccl"):
            raise AssertionError(f"the mesh did not take the NCCL group: "
                                 f"{nccl}")
        out = {"yolov3-416": _parallel_yolo(dev, meshes),
               "ReID 512-d": _parallel_reid(dev, meshes)}
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = was
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip.main(["--coordinator", f"127.0.0.1:{free_port()}",
                               "--num-processes", "1", "--process-id", "0"])
    lines = buf.getvalue().strip().splitlines()
    if not (any("reid train step ok on 1x1 dp/mp mesh" in ln
                for ln in lines)
            and any("dp-sharded detector train step ok over 1 devices" in ln
                    for ln in lines)):
        raise AssertionError(f"dryrun_multichip on one NCCL rank: {lines}")
    return out, lines


def print_parallel_training(parallel, dryrun_lines) -> None:
    """The lines of ``run_parallel_training``."""
    for net, (recs, worst) in parallel.items():
        runs = "; ".join(
            f"{name}: ms per step {[round(v, 3) for v in r['ms']]}, peak "
            f"{r['peak_gib']:.3f} GiB, losses "
            f"{[round(v, 4) for v in r['losses']]}"
            for name, r in recs.items())
        print(f"training mesh, {net}, {PARALLEL_TRAIN_STEPS} SGD steps from "
              f"one start through mesh=None, a mesh without a group and a "
              f"one-rank NCCL mesh (cuDNN deterministic; the first step "
              f"includes cuDNN's set-up and a host copy of the state): "
              f"{runs}; NCCL equal to no group "
              f"bit for bit ({recs['NCCL']['last'][0].numel()} params, "
              f"{recs['NCCL']['last'][1].numel()} statistics, every loss); "
              f"the mesh against mesh=None over the first step: loss "
              f"{worst['loss']:.3g} relative (<= {TOL_TRAIN_LOSS}), stats "
              f"{worst['stats']:.3g} (<= {TOL_TRAIN_STATS}), update "
              f"{worst['update']:.3g} of its norm (<= {TOL_TRAIN_UPDATE}); "
              f"later losses within {worst['loss_later']:.3g}", flush=True)
    for line in dryrun_lines:
        print(f"dryrun_multichip on one NCCL rank: {line}", flush=True)


TINY_TRAIN_CFG = """[net]
batch=4
width=64
height=64
channels=3
learning_rate=0.0005
burn_in=2
momentum=0.9
decay=0.0005
steps=100000
scales=.1

[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[convolutional]
filters=21
size=1
stride=1
pad=1
activation=linear

[yolo]
mask=0,1,2
anchors=8,8, 16,16, 32,32
classes=2
num=3
jitter=.3
ignore_thresh=.5
truth_thresh=1
random=1
"""  # the JAX CLI tests' tiny net (tests/test_yolo_cli.py TINY_CFG)


SOAK_CHUNKS = 20  # each soak's chunks in the smoke (the tools' default: 100)


def run_int8_gates():
    """The three int8 accuracy gates at their defaults through their
    ``run`` (``tools/int8_gate.py``: 512-d ReID, 32 ids, 300 steps;
    ``tools/int8_detect_gate.py``: yolov3-416 on the honest load, 4 x
    1080p; ``tools/int8_gate_trained.py``: yolov3-tiny-320, 300 steps),
    each counted (``_counted``). The gates' verdicts are measurements,
    printed as they come; what is asserted is the routes: kernel 8's
    resident embed equal to its plain version (the two records' rank-1 and
    cosine too), 15 K8 launches a resident embed call (two calls), and
    kernel 7's int8 route equal to the plain twin on the decoded tensor
    before NMS, with K7 launched once a conv on the kernel route and once an
    unpackaged conv on the twin. -> {kernel: launches of all three}."""
    from yolo_deepsort_tpu_torch.tools import (
        int8_detect_gate,
        int8_gate,
        int8_gate_trained,
    )

    launched = {}
    for name, mod in (("int8_gate", int8_gate),
                      ("int8_detect_gate", int8_detect_gate),
                      ("int8_gate_trained", int8_gate_trained)):
        t0 = time.perf_counter()
        rec, launches = _counted(lambda: mod.run([]))
        print(f"gate {name} ({time.perf_counter() - t0:.1f} s): "
              f"{json.dumps(rec)}", flush=True)
        for k, n in launches.items():
            launched[k] = launched.get(k, 0) + n
        if name == "int8_gate":
            if not (rec["int8_res_kernel_vs_plain_max_abs"] == 0
                    and rec["rank1_int8_res"] == rec["rank1_int8_res_plain"]
                    and rec["cos_int8_res_vs_f32"]
                    == rec["cos_int8_res_plain_vs_f32"]):
                raise AssertionError("ReID gate: kernel 8's resident embed "
                                     "differs from its plain version")
            if launches["conv_int8"] != 2 * N_INT8_CONVS:
                raise AssertionError(f"ReID gate: {launches['conv_int8']} K8 "
                                     f"launches in 2 resident embed calls")
            continue
        if rec.get("error"):
            raise AssertionError(f"{name}: {rec['error']}")
        if rec["decoded_kernel_vs_plain_max_abs"] != 0:
            raise AssertionError(f"{name}: kernel 7's int8 route differs "
                                 "from the plain twin before NMS by "
                                 f"{rec['decoded_kernel_vs_plain_max_abs']}")
        if (rec["k7_launches_kernel_route"], rec["k7_launches_plain_twin"]) \
                != (rec["convs"], rec["convs"] - rec["int8_layers"]):
            raise AssertionError(f"{name}: K7 launches {rec}")
    return launched


def run_int8_track_gate():
    """``tools/int8_track_gate.py`` at its defaults through its ``run``
    (yolov3-416 on the reference gate's load, 2 x 1080p, 60 steps of the
    f32, bf16, int8 and int8 plain-twin K=1 steps, scored from step 10).
    The verdict is a measurement, printed as it comes; what is asserted is
    the route: the int8 path on kernel 7 emits exactly the plain twin's
    tracks (churn 0, no id remapped) and decodes exactly its tensor before
    NMS, kernel 7 launches once a conv of the bf16 detector and ReID net a
    step on the int8 and bf16 paths and once an unpackaged one on the twin,
    none on the f32 path, and every path launches the letterbox, the NMS
    and the tracker kernel once a step. -> {kernel: launches of the run}."""
    from yolo_deepsort_tpu_torch.tools import int8_track_gate

    t0 = time.perf_counter()
    rec = int8_track_gate.run([])
    secs = time.perf_counter() - t0
    print(f"gate int8_track_gate ({secs:.1f} s): {json.dumps(rec)}",
          flush=True)
    if rec.get("reason"):
        raise AssertionError(f"int8_track_gate: {rec['reason']}")
    twin = rec["int8_kernel_vs_plain"]
    if not (twin["tracks_a"] > 0 and twin["churn"] == 0
            and twin["remaps"] == 0 and twin["decoded_max_abs"] == 0):
        raise AssertionError(f"int8_track_gate: kernel 7's int8 route "
                             f"differs from the plain twin: {twin}")
    n, convs, reid = rec["steps"], rec["convs"], rec["reid_convs"]
    # K7 per forward of the detector, counted at its eager call and its
    # capture, and of the ReID net, every step
    k7 = {"f32": (0, 0), "bf16": (convs, reid), "int8": (convs, reid),
          "int8_plain": (convs - rec["int8_layers"], reid)}
    for path, (det, per_step) in k7.items():
        got = rec["launches_per_path"][path]
        counted, graph = _graph_counts(got, n)
        want = dict(conv=det * counted + per_step * n, letterbox=n, nms=n,
                    tracker=n, **graph)
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"int8_track_gate, {path} path: launches "
                                 f"{got}, expected {want} in {n} steps")
    return rec["launches"]


def run_soaks():
    """``tools/soak.py`` at its defaults but SOAK_CHUNKS chunks (yolov3-416
    bf16, K 16, 8 x 1080p, the honest load), then ``tools/
    soak_multichip.py`` on one NCCL rank (its defaults, yolov3-tiny-160 at
    256 x 320, K 4, SOAK_CHUNKS chunks). Every invariant must
    hold; per chunk of the soak K1 1, K2 1 (1080 % 8 == 0 and 1920 % 128 ==
    0: the windowed crops), K3 16, K7 95 and one stats readback; per step
    of the multichip soak K1 1, dense crops 1, K3 1, K7 20 (the ReID net's)
    and one replay of the detector's graph (yolov3-tiny's 13 convs count at
    its capture, in the warm-up). The counts are
    the tools' own (their counters set to 0 just before their timed loops).
    -> {tool: record}."""
    from yolo_deepsort_tpu_torch.tools import soak, soak_multichip

    recs = {}
    t0 = time.perf_counter()
    rec = soak.run(["--chunks", str(SOAK_CHUNKS)])
    print(f"soak ({time.perf_counter() - t0:.1f} s): {json.dumps(rec)}",
          flush=True)
    n, k = SOAK_CHUNKS, 16
    want = _only(letterbox=n, crops=n, tracker=k * n, conv=95 * n,
                 conv_residual=8 * n, nms=n)
    if not rec["ok"] or rec["launches"] != want or rec["stats_readbacks"] != n:
        raise AssertionError(f"soak: failures {rec['failures']}, launches "
                             f"{rec['launches']} (want {want}), readbacks "
                             f"{rec['stats_readbacks']}")
    recs["soak"] = rec
    t0 = time.perf_counter()
    rec = soak_multichip.run([
        "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes", "1",
        "--process-id", "0", "--chunks", str(SOAK_CHUNKS)])
    print(f"soak_multichip on one NCCL rank ({time.perf_counter() - t0:.1f}"
          f" s): {json.dumps(rec)}", flush=True)
    steps = 4 * SOAK_CHUNKS
    # the timed steps replay the detector's graph (yolov3-tiny's 13 convs
    # counted at its capture, in the warm-up); K7 the ReID net's 20 convs
    counted, graph = _graph_counts(rec["launches"], steps)
    want = _only(letterbox=steps, crops_dense=steps, tracker=steps,
                 conv=13 * counted + 20 * steps, conv_residual=8 * steps,
                 nms=steps, **graph)
    if (not rec["ok"] or rec["backend"] != "nccl"
            or rec["launches"] != want):
        raise AssertionError(f"soak_multichip: failures {rec['failures']}, "
                             f"backend {rec['backend']}, launches "
                             f"{rec['launches']} (want {want})")
    recs["soak_multichip"] = rec
    return recs

# the tools phase (``run_tools``): the nearest and bilinear
# ``ImageDetector`` rows on the card against the CPU's (float32, TF32 off:
# the convs sum in another order), frame pixels and scores (measured
# 7.3e-4 px and 5.4e-7)
TOL_TOOLS_BOXES, TOL_TOOLS_SCORES = 1e-2, 1e-5


def run_tools(dev, tmp_dir):
    """The port's verify_weights, parity_real and the facade's nearest
    letterbox on the card (9d in the module docstring). -> {kernel:
    launches of (a) and (c)}."""
    import os

    import torch

    from specs.weights_np import random_darknet_weights
    from yolo_deepsort_tpu_torch import api
    from yolo_deepsort_tpu_torch.cfg import parse_model_config
    from yolo_deepsort_tpu_torch.tools import verify_weights as VW
    from yolo_deepsort_tpu_torch.train.trees import full_f32

    repo = os.path.dirname(os.path.abspath(__file__))
    launched = {}

    def count(run):
        out, launches = _counted(run)
        for k, n in launches.items():
            launched[k] = launched.get(k, 0) + n
        return out, launches

    # (a) the per-layer harness at yolov3-416, batch 1: gated on the
    # well-conditioned weights; random raw params read only (there the
    # deep activations grow until f32 rounding alone passes the threshold
    # and the yolo exp() overflows, on the reference's tool as well)
    cfg = os.path.join(repo, "config", "yolov3.cfg")
    defs = [d for d in parse_model_config(cfg) if d["type"] != "net"]
    wpath = os.path.join(tmp_dir, "yolov3-well-conditioned.weights")
    with open(wpath, "wb") as f:
        f.write(random_darknet_weights(defs, seed=0, well_conditioned=True))
    for name, weights in (("well-conditioned", wpath), ("random raw", None)):
        t0 = time.perf_counter()
        tables, launches = count(lambda: VW.verify(
            cfg, weights, img_size=416, batch=1, device=dev,
            dtypes=("f32", "bf16"), log=lambda _: None))
        rec = {"tool": "verify_weights", "cfg": "yolov3.cfg", "img_size": 416,
               "batch": 1, "weights": name}
        for dtype, rows in tables.items():
            value, idx = VW.worst_of(rows)
            rec.update({f"{dtype}_worst_layer": idx, f"{dtype}_max_abs": value,
                        f"{dtype}_layers_over_threshold": sum(
                            r["max_abs"] > VW.THRESHOLD
                            for r in rows)})
        rec.update(k7_launches=launches["conv"],
                   secs=round(time.perf_counter() - t0, 2))
        print(json.dumps(rec), flush=True)
        if launches != _only(conv=75):
            raise AssertionError(f"verify_weights {name}: launches {launches}"
                                 " (want kernel 7 once a conv of the bf16 "
                                 "forward)")
        if (weights is not None
                and rec["f32_max_abs"] > VW.THRESHOLD):
            raise AssertionError(f"verify_weights: f32 layer "
                                 f"{rec['f32_worst_layer']} off the oracle by "
                                 f"{rec['f32_max_abs']}")

    # (b) the runbook's stand-in flow, as a user runs it
    t0 = time.perf_counter()
    report = os.path.join(tmp_dir, "PARITY_REAL_torch.md")
    r = subprocess.run(
        [sys.executable, "-m", "yolo_deepsort_tpu_torch.tools.parity_real",
         "--standins", "--out", report], capture_output=True, text=True,
        cwd=repo, timeout=600)
    lines = r.stdout.strip().splitlines()
    rec = json.loads(lines[-1]) if r.returncode == 0 and lines else None
    if rec is None or not rec["ok"]:
        raise AssertionError(f"parity_real --standins: rc {r.returncode}, "
                             f"{lines[-1:]}\n{r.stderr[-2000:]}")
    with open(report) as f:
        table = [ln for ln in f.read().splitlines() if ln.startswith("| ")]
    print(json.dumps({"tool": "parity_real --standins", "ok": rec["ok"],
                      "failures": rec["failures"], "report": table[1:],
                      "secs": round(time.perf_counter() - t0, 2)}),
          flush=True)

    # (c) ImageDetector's nearest letterbox (and kernel 1's bilinear one)
    # on one 1080p noise frame, (a)'s well-conditioned weights (no box
    # prior: its near-equal scores make NMS's order, and so its merges,
    # turn on the last bits of the sums): the card's rows against the
    # CPU's, as a set, at a threshold midway between the CPU's 32nd and
    # 33rd objectness
    t0 = time.perf_counter()
    model = api.Darknet("yolov3", img_size=416, device=dev)
    model.load_darknet_weights(wpath)
    cpu_model = api.Darknet("yolov3", img_size=416, device="cpu")
    cpu_model.load_darknet_weights(wpath)
    frame = np.random.default_rng(3).integers(
        0, 256, (FRAME_H, FRAME_W, 3), np.uint8)
    from yolo_deepsort_tpu_torch.ops.letterbox import (
        letterbox_batch,
        letterbox_nearest_batch,
    )

    for interp, lbox, want_launches in (
            ("nearest", letterbox_nearest_batch, _only(nms=1)),
            ("bilinear", letterbox_batch, _only(letterbox=1, nms=1))):
        with torch.no_grad():
            obj = cpu_model(lbox(torch.from_numpy(frame[None]), 416))[0, :, 4]
        top = torch.sort(obj, descending=True).values
        thr = float(top[TARGET_DETS - 1] + top[TARGET_DETS]) / 2
        with full_f32():
            got, launches = count(lambda: api.ImageDetector(
                model, conf_thres=thr, interp=interp).detect(frame))
        want = api.ImageDetector(cpu_model, conf_thres=thr,
                                 interp=interp).detect(frame)
        box_err = score_err = None
        if got.shape == want.shape and len(got):
            # near-equal scores may sort in another order on the two
            # devices: each card row against the CPU row nearest to it,
            # one to one
            near = np.abs(got[:, None, :4] - want[None, :, :4]).max(-1)
            order = near.argmin(1)
            if len(set(order.tolist())) == len(got):
                want = want[order]
                box_err = float(np.abs(got[:, :4] - want[:, :4]).max())
                score_err = float(np.abs(got[:, 4:6] - want[:, 4:6]).max())
        print(json.dumps({"tool": "ImageDetector", "interp": interp,
                          "frame": [FRAME_H, FRAME_W], "threshold": thr,
                          "rows": len(got), "rows_cpu": len(want),
                          "box_max_abs_px": box_err,
                          "score_max_abs": score_err, "launches": {
                              k: n for k, n in launches.items() if n}}),
              flush=True)
        if (box_err is None or box_err > TOL_TOOLS_BOXES
                or score_err > TOL_TOOLS_SCORES
                or not np.array_equal(got[:, 6], want[:, 6])
                or launches != want_launches):
            raise AssertionError(f"ImageDetector interp={interp}: card rows "
                                 f"differ from the CPU's or launches "
                                 f"{launches}:\n{got}\n{want}")
    print(f"tools: ImageDetector nearest and bilinear "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launched


# phase 9e (``run_video``): decoded video on the card, cut from the tools'
# defaults as follows: the ingest soak runs VIDEO_CHUNKS chunks (default
# 100) of K 16 on clips of VIDEO_CLIP_FRAMES frames (300) -- shorter than
# the 176 frames a stream it consumes, so its decoders loop -- after a
# VIDEO_PROBE_SECS decode probe (6 s); bench_video measures
# VIDEO_BENCH_FRAMES frames a pass (256); the F9 blocks feed
# F9_FRAMES seeded frames a stream into rings of 8 (full) or of F9_FRAMES
# (holding every frame), alternated
VIDEO_CHUNKS, VIDEO_CLIP_FRAMES, VIDEO_PROBE_SECS = 10, 64, 2.0
VIDEO_K, VIDEO_BENCH_FRAMES = 16, 64
F9_FRAMES = GID_WARM_STEPS + GID_TIMED_STEPS  # 23
F9_BLOCKS = (8, F9_FRAMES, F9_FRAMES, 8)
EXAMPLE_STEPS = 16  # track_multicamera's --max-steps


def clip_channel_sums(path) -> np.ndarray:
    """(frames, 3) int64: every decoded frame's sum over its pixels of each
    channel, in RGB order (the order the rings hand the step)."""
    import cv2

    cap = cv2.VideoCapture(path)
    sums = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            sums.append(frame.reshape(-1, 3).sum(0, dtype=np.int64)[::-1])
    finally:
        cap.release()
    return np.stack(sums)


def run_ingest_soak(dev, clip_dir):
    """9e (a): ``tools/soak.py --ingest`` (yolov3-416 bf16, 8 x 1080p, K 16)
    with the cuts above. Every uploaded chunk's per-frame channel sums are
    taken on the card (one reduction a chunk, read back once at the end) and
    must equal, stream by stream, those of the clip's frames in order from
    its first, looped, BGR turned RGB: a frame lost, repeated, reordered,
    left unswizzled or overwritten while its upload was in flight shows.
    Per chunk K1 1, K2 1, K3 16, K7 95 and one stats readback. -> the
    record."""
    import torch

    from yolo_deepsort_tpu_torch.tools import soak

    args = soak.parser().parse_args([
        "--ingest", "--chunks", str(VIDEO_CHUNKS), "--scan", str(VIDEO_K),
        "--clip-frames", str(VIDEO_CLIP_FRAMES), "--decode-probe-secs",
        str(VIDEO_PROBE_SECS), "--clip-dir", clip_dir])
    sums = []

    def tap(frames):  # (K, S, H, W, 3) uint8 on the card -> (K, S, 3)
        sums.append(frames.flatten(2, 3).sum(2, dtype=torch.int64))

    t0 = time.perf_counter()
    rec = soak.soak_ingest(args, dev, tap)
    print(f"soak --ingest ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(rec)}", flush=True)
    n, k = VIDEO_CHUNKS, VIDEO_K
    want = _only(letterbox=n, crops=n, tracker=k * n, conv=95 * n,
                 conv_residual=8 * n, nms=n)
    if not rec["ok"] or rec["launches"] != want or rec["stats_readbacks"] != n:
        raise AssertionError(f"soak --ingest: failures {rec['failures']}, "
                             f"launches {rec['launches']} (want {want}), "
                             f"readbacks {rec['stats_readbacks']}")
    got = torch.cat(sums).cpu().numpy()  # (frames a stream, S, 3)
    clips = soak.ensure_clips(clip_dir, STREAMS, (FRAME_H, FRAME_W),
                              VIDEO_CLIP_FRAMES)  # the paths, already there
    for s, path in enumerate(clips):
        want_s = clip_channel_sums(path)
        if len(want_s) != VIDEO_CLIP_FRAMES:
            raise AssertionError(f"{path}: {len(want_s)} frames decoded")
        if not np.array_equal(got[:, s], want_s[np.arange(len(got))
                                                % len(want_s)]):
            raise AssertionError(f"soak --ingest: stream {s}'s uploaded "
                                 "chunks are not its clip's frames in order")
    print(f"soak --ingest: {len(got)} uploaded frames a stream ({n + 1} "
          f"chunks, the warm-up's first) equal to the clips' "
          f"{VIDEO_CLIP_FRAMES} frames in order, looped, BGR turned RGB "
          f"(per-frame channel sums); launches per chunk K1 1, K2 1, K3 "
          f"{k}, K7 95, one stats readback", flush=True)
    return rec


def run_bench_video(clip_dir):
    """9e (b): ``tools/bench_video.py`` (yolov3-416 bf16, one 1080p clip,
    chunk 16) on VIDEO_BENCH_FRAMES frames a pass. Its timed pass draws
    VIDEO_BENCH_FRAMES frames and enqueues one chunk more than it draws;
    per chunk K1 1, K2 1, K3 16, K7 95. -> the record."""
    from yolo_deepsort_tpu_torch.tools import bench_video

    t0 = time.perf_counter()
    rec = bench_video.run(["--chunk", str(VIDEO_K), "--frames",
                           str(VIDEO_BENCH_FRAMES), "--clip-dir", clip_dir])
    print(f"bench_video ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(rec)}", flush=True)
    c, k = rec["chunks_run"], VIDEO_K
    want = _only(letterbox=c, crops=c, tracker=k * c, conv=95 * c,
                 conv_residual=8 * c, nms=c)
    if (rec["frames"] != VIDEO_BENCH_FRAMES
            or c != VIDEO_BENCH_FRAMES // k + 1 or rec["launches"] != want):
        raise AssertionError(f"bench_video: {rec['frames']} frames, {c} "
                             f"chunks, launches {rec['launches']} (want "
                             f"{want})")
    return rec


def _ms_per_step(mst):
    """Run ``mst`` to its end and close it: (host-clock ms of each step
    after the first GID_WARM_STEPS, frames per stream, steps, rows emitted,
    full-ring rejections)."""
    seen = np.zeros(mst.s, int)
    times, steps, rows, last = [], 0, 0, time.perf_counter()
    for _, emit, valid in mst.run():
        now = time.perf_counter()
        if steps >= GID_WARM_STEPS:
            times.append((now - last) * 1e3)
        last = now
        seen += valid
        rows += int(emit.sum())
        steps += 1
    dropped = mst.stats()["dropped"]
    mst.close()
    return times, seen.tolist(), steps, rows, dropped


def run_decoded_streams(dev, tmp_dir, clips, card):
    """9e (c): ``MultiStreamTracker`` with its own cv2 decoders over the 8
    1080p clips of (a), rings of 8 (``facade_model``'s yolov3-416 bf16 and
    threshold): every stream's frames arrive, one readback a step. Then F9's
    numbers on ``run_multistream``'s seeded load: ms per step with
    F9_FRAMES frames a stream into full rings of 8 and into rings that hold
    every frame, alternated (F9_BLOCKS). -> (model, threshold)."""
    from yolo_deepsort_tpu_torch.config import DetectorConfig
    from yolo_deepsort_tpu_torch.models.reid import random_reid_params
    from yolo_deepsort_tpu_torch.runtime.multistream import MultiStreamTracker

    model, frame, thr = facade_model(dev, tmp_dir)
    mst = MultiStreamTracker(model, clips, random_reid_params(0),
                             (FRAME_H, FRAME_W),
                             det_config=DetectorConfig(img_size=416,
                                                       conf_thres=thr),
                             ring_depth=8)
    times, seen, steps, rows, dropped = _ms_per_step(mst)
    if seen != [VIDEO_CLIP_FRAMES] * STREAMS or mst.host_readbacks != steps:
        raise AssertionError(f"MultiStreamTracker over decoded clips: "
                             f"frames per stream {seen}, "
                             f"{mst.host_readbacks} readbacks in {steps} "
                             "steps")
    print(f"MultiStreamTracker over {STREAMS} decoded {FRAME_H}p clips "
          f"(cv2 decoders, rings of 8, yolov3-416 bf16): {steps} steps, "
          f"frames per stream {seen}, {rows} rows emitted, 1 readback per "
          f"step, {float(np.median(times)):.4f} ms per step (host clock, "
          f"median after {GID_WARM_STEPS}), {dropped} full-ring rejections "
          f"({card})", flush=True)
    ms = {}
    for depth in F9_BLOCKS:
        times, seen, _, _, _ = _ms_per_step(seeded_streams(
            model, frame, thr, [F9_FRAMES] * STREAMS, ring_depth=depth))
        if seen != [F9_FRAMES] * STREAMS:
            raise AssertionError(f"seeded streams: frames per stream {seen}")
        ms.setdefault(depth, []).append(float(np.median(times)))
    print(f"F9, MultiStreamTracker on the seeded load ({STREAMS} x "
          f"{FRAME_H}p, {F9_FRAMES} frames a stream, yolov3-416 bf16, "
          f"host clock, medians of {F9_FRAMES - GID_WARM_STEPS} steps, "
          f"blocks alternated): full rings of {F9_BLOCKS[0]} "
          f"{[round(v, 4) for v in ms[F9_BLOCKS[0]]]} ms per step, rings "
          f"holding "
          f"every frame {[round(v, 4) for v in ms[F9_FRAMES]]} ({card})",
          flush=True)
    return model, thr


def run_examples(tmp_dir, clips, thr):
    """9e (d): ``examples/track_video.py`` and ``track_multicamera.py``
    with ``--device cuda``, in process through their ``main`` (their
    printing captured), on (a)'s clips and ``facade_model``'s weights file:
    every frame tracked and written; EXAMPLE_STEPS steps of two cameras."""
    import contextlib
    import io
    import os

    from yolo_deepsort_tpu_torch.examples import track_multicamera, track_video

    weights = f"{tmp_dir}/yolov3-416.weights"  # facade_model's
    out_path = os.path.join(tmp_dir, "tracked.mp4")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        track_video.main([clips[0], "--weights", weights, "--conf-thres",
                          str(thr), "--half", "--classes", "--out",
                          out_path, "--device", "cuda"])
    lines = out.getvalue().strip().splitlines()
    written = len(clip_channel_sums(out_path))
    if lines[-1:] != [f"{VIDEO_CLIP_FRAMES} frames -> {out_path}"] \
            or written != VIDEO_CLIP_FRAMES:
        raise AssertionError(f"track_video: {lines[-1:]}, {written} frames "
                             "written")
    print(f"example track_video on the card "
          f"({time.perf_counter() - t0:.1f} s): {lines[-1]}, "
          f"{written} frames in the written clip", flush=True)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        track_multicamera.main([clips[0], clips[1], "--weights", weights,
                                "--max-steps", str(EXAMPLE_STEPS),
                                "--device", "cuda"])
    lines = out.getvalue().strip().splitlines()
    steps = {int(ln.split()[1]) for ln in lines if ln.startswith("step ")}
    if any(s >= EXAMPLE_STEPS for s in steps):
        raise AssertionError(f"track_multicamera ran past --max-steps: "
                             f"{sorted(steps)}")
    print(f"example track_multicamera on the card "
          f"({time.perf_counter() - t0:.1f} s): 2 cameras, "
          f"{EXAMPLE_STEPS} steps, {len(lines)} global-id rows printed "
          f"over {len(steps)} steps", flush=True)


def run_video(dev, card):
    """Phase 9e: decoded video on the card, (a)-(d) in a temp dir of their
    own. -> {kernel: launches of the timed loops of (a) and (b)}."""
    import os

    from yolo_deepsort_tpu_torch.tools.soak import ensure_clips

    with tempfile.TemporaryDirectory() as tmp_dir:
        clip_dir = os.path.join(tmp_dir, "clips")
        ingest = run_ingest_soak(dev, clip_dir)
        bench = run_bench_video(clip_dir)
        clips = ensure_clips(clip_dir, STREAMS, (FRAME_H, FRAME_W),
                             VIDEO_CLIP_FRAMES)
        _, thr = run_decoded_streams(dev, tmp_dir, clips, card)
        run_examples(tmp_dir, clips, thr)
    return {name: ingest["launches"][name] + bench["launches"][name]
            for name in ingest["launches"]}


MOT_HW = (1080, 1920)


def _counted(run):
    """run() with every launch counter of the port set to 0 just before it:
    (its result, {kernel name: launches}), every kernel read."""
    from yolo_deepsort_tpu_torch.kernels.launches import (
        read_launches,
        zero_launches,
    )

    zero_launches()
    out = run()
    return out, read_launches()


def _only(**launched):
    """{kernel name: launches}: the given kernels' counts, every other
    kernel of the port 0."""
    from yolo_deepsort_tpu_torch.kernels.launches import LAUNCH_COUNTERS

    return {**{name: 0 for name in LAUNCH_COUNTERS}, **launched}


def _graph_counts(launched, steps):
    """The K=1 step's detector graph in a counted run of ``steps`` steps on
    the card (``parallel/streams.py`` ``DetectorGraph``): each step either
    replays the graph or runs the detector eagerly, and the detector's
    kernels count at its eager calls and its captures, never at a replay.
    -> (forwards whose kernels were counted, the three graph counters as
    ``launched`` must hold them)."""
    graph = {k: launched[k] for k in ("detector_graph", "detector_capture",
                                      "detector_eager")}
    if graph["detector_graph"] + graph["detector_eager"] != steps:
        raise AssertionError(f"detector graph: {graph} in {steps} steps")
    return graph["detector_eager"] + graph["detector_capture"], graph


def _dense_calls(run):
    """run() with every call of the dense crop entry that
    ``parallel/streams.py`` makes recorded: (its result, [(frames, boxes,
    crops)]), each to be held against the plain version
    (``_check_dense_calls``)."""
    from yolo_deepsort_tpu_torch.parallel import streams

    seen = []
    dense = streams.crop_and_normalize_dense

    def recorded(frames, boxes):
        out = dense(frames, boxes)
        seen.append((frames, boxes, out))
        return out

    streams.crop_and_normalize_dense = recorded
    try:
        return run(), seen
    finally:
        streams.crop_and_normalize_dense = dense


def _check_dense_calls(seen, tag):
    """Each recorded dense-entry call bit-equal to its plain version (the
    batched ``crop_and_normalize`` at bf16) on the same card tensors."""
    import torch

    from yolo_deepsort_tpu_torch.ops.crops import crop_and_normalize_batch

    for frames, boxes, out in seen:
        if not torch.equal(out, crop_and_normalize_batch(frames, boxes,
                                                         torch.bfloat16)):
            raise AssertionError(f"{tag}: the dense entry's crops of "
                                 f"{tuple(boxes.shape[:2])} boxes differ "
                                 "from its plain version")


def _scan_launches(k, fused, conv, residual):
    """The launches of one chunk of K frames through make_scanned_step with
    a bf16 ReID net: K1 once, NMS once, the dense crops once, K2 never, K3
    (the fused branch) or K5 (``tracker_step``) once per frame, and K7
    ``conv`` times (one forward of each bf16 net per chunk, a launch per
    conv), ``residual`` of them with a block's tail."""
    return _only(letterbox=1, crops_dense=1, tracker=k if fused else 0,
                 jv_two_stage=0 if fused else k, conv=conv,
                 conv_residual=residual, nms=1)


def check_small_scanned(dev):
    """The monolithic chunk step on the card against the same step on the
    CPU (``_small_setup``: yolov3-tiny at 64, 2 streams of 64x128, an f32
    detector and a bf16 ReID net; one threshold in the widest gap of the
    objectness ranks 8..20, as ``check_small_k1``), 2 chunks of K=3 static
    frames, on both tracker branches: emit, ids and the discrete state
    exactly equal, boxes within 1 px; per chunk on the card
    ``_scan_launches``. Returns {branch: emitted rows}."""
    import torch

    from yolo_deepsort_tpu_torch.config import DetectorConfig, TrackerConfig
    from yolo_deepsort_tpu_torch.parallel.streams import (
        init_stream_states,
        make_scanned_step,
    )

    su = _small_setup()
    cl = torch.channels_last
    obj = torch.sort(su["obj"].flatten(), descending=True).values[8:21]
    gap = int(torch.argmax(obj[:-1] - obj[1:]))
    det_cfg = DetectorConfig(img_size=su["size"], max_dets=8,
                             conf_thres=float((obj[gap] + obj[gap + 1]) / 2))
    trk_cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
    hw, k, s = (su["h"], su["w"]), 3, su["s"]
    frames = torch.from_numpy(np.broadcast_to(su["base"][None],
                                              (k, s, *hw, 3)).copy())
    frames_dev = frames.to(dev)
    card_det = su["det"]().to(dev, memory_format=cl)
    card_reid = su["reid"]().to(dev, memory_format=cl)
    emitted = {}
    for fused in (True, False):
        ref = make_scanned_step(su["cpu_det"], su["reid"](), det_cfg,
                                trk_cfg, hw, k, use_fused_tracker=fused)
        card = make_scanned_step(card_det, card_reid, det_cfg, trk_cfg, hw,
                                 k, use_fused_tracker=fused)
        st_ref = init_stream_states(trk_cfg, s, "cpu")
        st_card = init_stream_states(trk_cfg, s, dev)
        rows = 0
        for c in range(2):
            st_ref, (out_r, emit_r) = ref(st_ref, frames)
            (st_card, (out_c, emit_c)), launched = _counted(
                lambda: card(st_card, frames_dev))
            tag = f"small scanned step (fused={fused}) chunk {c}"
            if launched != _scan_launches(k, fused, n_convs(card_reid),
                                          n_blocks(card_reid)):
                raise AssertionError(f"{tag}: launches {launched}")
            out_c, emit_c = out_c.cpu(), emit_c.cpu()
            if not (torch.equal(emit_r, emit_c)
                    and torch.equal(out_r[..., 4], out_c[..., 4])):
                raise AssertionError(f"{tag}: emitted tracks differ between "
                                     "the card and the CPU")
            if (out_r[..., :4] - out_c[..., :4]).abs().max().item() > 1:
                raise AssertionError(f"{tag}: boxes differ by more than 1 px")
            for name in ("state", "hits", "age", "time_since_update",
                         "track_id", "gallery_head", "gallery_count",
                         "next_id"):
                if not torch.equal(getattr(st_ref, name),
                                   getattr(st_card, name).cpu()):
                    raise AssertionError(f"{tag}: {name} differs")
            rows += int(emit_c.sum())
        if rows == 0:
            raise AssertionError(f"small scanned step (fused={fused}): no "
                                 "emitted tracks")
        emitted["fused" if fused else "tracker_step"] = rows
    return emitted


def run_scanned_path(dev, setup):
    """The monolithic chunk step at full width (phase 4f of the module
    docstring) on the main path's model, weights and frames, with one
    threshold (the step has one): the (TARGET_DETS x STREAMS)-th largest
    objectness of the 8 frames, about TARGET_DETS detections a frame. On
    both tracker branches: one chunk in sync debug mode "error" (no host
    wait), its launches (``_scan_launches``), the dense entry's crops of
    all K x S x 64 rows bit-equal to its plain version, finite state and
    emitted
    rows, the same on both branches. Then frames/s (host clock,
    synchronized blocks of SCAN_BLOCK_CHUNKS chunks, alternated scanned /
    bucketed / bucketed / scanned, median of SCAN_BLOCKS blocks each) and
    device ms per chunk (``torch.profiler`` over one more block) of the
    fused branch beside
    ``BucketedScannedStep``'s (same threshold, pipelined as it serves) on
    the same chunks. Returns {branch: launches of its counted chunk}."""
    import torch

    from yolo_deepsort_tpu_torch.config import DetectorConfig
    from yolo_deepsort_tpu_torch.ops.letterbox_kernel import (
        letterbox_batch_fused,
    )
    from yolo_deepsort_tpu_torch.parallel.streams import (
        BucketedScannedStep,
        init_stream_states,
        make_scanned_step,
    )

    _, _, frames, parts = setup
    detector, reid, trk_cfg = parts["detector"], parts["reid"], parts[
        "trk_cfg"]
    hw = (FRAME_H, FRAME_W)
    with torch.no_grad():
        obj = detector(letterbox_batch_fused(frames[0], 416,
                                             torch.bfloat16))[..., 4]
    thr = float(torch.sort(obj.flatten(), descending=True).values[
        TARGET_DETS * STREAMS - 1])
    det_cfg = DetectorConfig(img_size=416, conf_thres=thr, nms_thres=0.4,
                             max_dets=trk_cfg.max_dets)
    steps = {fused: make_scanned_step(detector, reid, det_cfg, trk_cfg, hw,
                                      K_FRAMES, use_fused_tracker=fused)
             for fused in (True, False)}
    launches, rows = {}, {}
    states = {}
    for fused, step in steps.items():
        st = init_stream_states(trk_cfg, STREAMS, dev)
        for _ in range(2):  # warm-up: tracks confirm after n_init frames
            st, _ = step(st, frames)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ((st, (outputs, emit)), seen), launched = _counted(
                lambda: _dense_calls(lambda: step(st, frames)))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        name = "fused" if fused else "tracker_step"
        # the dense entry at the step's shape: all K x S x max_dets rows
        _check_dense_calls(seen, f"scanned step ({name})")
        want = _scan_launches(K_FRAMES, fused,
                              n_convs(detector) + n_convs(reid),
                              n_blocks(reid))
        if launched != want:
            raise AssertionError(f"scanned step ({name}): launches per chunk "
                                 f"{launched}, expected "
                                 f"{want}")
        if outputs.shape != (K_FRAMES, STREAMS, trk_cfg.max_tracks, 5):
            raise AssertionError(f"scanned step outputs {outputs.shape}")
        if not (bool(torch.isfinite(st.mean).all()) and int(emit.sum())):
            raise AssertionError(f"scanned step ({name}): non-finite state "
                                 "or no emitted rows")
        launches[name], rows[name], states[fused] = launched, emit, st
    if not torch.equal(rows["fused"], rows["tracker_step"]):
        raise AssertionError("scanned step: the two tracker branches emit "
                             "different rows")

    bucketed = BucketedScannedStep(detector, reid, det_cfg, trk_cfg, hw,
                                   buckets=(16, 24, 32, 36, 40, 48))
    b_states = init_stream_states(trk_cfg, STREAMS, dev)
    b_states, _ = pipelined(bucketed, b_states, frames, 3)
    scan_states = states[True]

    def block(which):
        nonlocal scan_states, b_states
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if which == "scanned":
            for _ in range(SCAN_BLOCK_CHUNKS):
                scan_states, out = steps[True](scan_states, frames)
        else:
            b_states, out = pipelined(bucketed, b_states, frames,
                                      SCAN_BLOCK_CHUNKS)
        torch.cuda.synchronize()
        return STREAMS * K_FRAMES * SCAN_BLOCK_CHUNKS / (
            time.perf_counter() - t0), out

    fps = {"scanned": [], "bucketed": []}
    outs = {}
    for which in ("scanned", "bucketed", "bucketed", "scanned") * (
            SCAN_BLOCKS // 2):
        f, outs[which] = block(which)
        fps[which].append(f)
    differ = int((outs["scanned"][1] != outs["bucketed"][1]).sum())
    dev_ms = {}
    for which in ("scanned", "bucketed"):
        per_kernel = _device_kernels(lambda: block(which))
        dev_ms[which] = sum(us for _, us in per_kernel.values()) / 1e3 / (
            SCAN_BLOCK_CHUNKS)
    med = {k: float(np.median(v)) for k, v in fps.items()}
    print(f"scanned step: yolov3-416 bf16, {STREAMS} x {FRAME_H}p, K="
          f"{K_FRAMES}, max_dets {trk_cfg.max_dets}, max_tracks "
          f"{trk_cfg.max_tracks}, nn_budget {trk_cfg.nn_budget}, one "
          f"threshold {thr:.4f}: launches per chunk fused {launches['fused']}"
          f", tracker_step {launches['tracker_step']}; no host wait inside "
          f"the step on either branch; both branches emit the same rows; "
          f"frames/s median of {SCAN_BLOCKS} blocks of {SCAN_BLOCK_CHUNKS} "
          f"chunks {med['scanned']:.2f} (blocks {fps['scanned']}), device "
          f"ms per chunk {dev_ms['scanned']:.4f}; BucketedScannedStep on "
          f"the same chunks (bucket {bucketed.last_bucket}, window "
          f"{bucketed.last_window}) {med['bucketed']:.2f} frames/s (blocks "
          f"{fps['bucketed']}), device ms per chunk "
          f"{dev_ms['bucketed']:.4f}; emit flags that differ between the "
          f"two in the last chunk {differ}; card {card_line()}", flush=True)
    return launches


def run_f8_path(dev, setup):
    """F8 on the card: ``BucketedScannedStep`` with the main path's bf16
    models on a chunk of K_FRAMES x STREAMS frames of F8_HW, which the
    reference's crop gate refuses (W % 128 != 0; per-stream thresholds
    calibrated on them as ``main_path_setup`` does). The track stage's
    windowed crops must be one launch of the dense entry and none of K2,
    bit-equal to the dense entry's plain version on the same frames and
    boxes. Returns the launches of the counted chunk."""
    import torch

    from yolo_deepsort_tpu_torch.config import DetectorConfig
    from yolo_deepsort_tpu_torch.ops.letterbox_kernel import (
        letterbox_batch_fused,
    )
    from yolo_deepsort_tpu_torch.parallel import streams

    _, _, _, parts = setup
    h, w = F8_HW
    rng = np.random.default_rng(8)
    base = torch.from_numpy(rng.integers(0, 256, (STREAMS, h, w, 3),
                                         dtype=np.uint8)).to(dev)
    frames = base[None].expand(K_FRAMES, -1, -1, -1, -1).contiguous()
    with torch.no_grad():
        obj = parts["detector"](letterbox_batch_fused(
            base, 416, torch.bfloat16))[..., 4]
    conf = torch.sort(obj, -1, descending=True).values[:, TARGET_DETS - 1]
    conf_vec = conf.float().cpu().numpy()
    det_cfg = DetectorConfig(img_size=416, conf_thres=float(conf_vec.mean()),
                             nms_thres=0.4, max_dets=64)
    step = streams.BucketedScannedStep(
        parts["detector"], parts["reid"], det_cfg, parts["trk_cfg"], (h, w),
        buckets=(16, 24, 32, 36, 40, 48), conf_thres_per_stream=conf_vec)
    states = streams.init_stream_states(parts["trk_cfg"], STREAMS, dev)
    states, _ = step(states, frames)
    ((states, (_, emit)), seen), launched = _counted(
        lambda: _dense_calls(lambda: step(states, frames)))
    if step.last_window == (h, w):
        raise AssertionError("F8: the chunk took no crop window")
    if (launched["crops"], launched["crops_dense"], len(seen)) != (0, 1, 1):
        raise AssertionError(f"F8: launches {launched} on a {h} x {w} "
                             "chunk, expected K2 0 and the dense entry 1")
    _check_dense_calls(seen, "F8")
    boxes = seen[0][1]
    print(f"F8: BucketedScannedStep bf16 on {STREAMS} x {h}x{w} (refused by "
          f"the reference's crop gate), K={K_FRAMES}: window "
          f"{step.last_window}, bucket {step.last_bucket}, crops K2 0, "
          f"dense entry 1 launch of {boxes.shape[0]} x {boxes.shape[1]} "
          f"boxes, bit-equal to its plain version; emitted rows "
          f"{int(emit.sum())}", flush=True)
    return launched


def mot_scene(seed=0, n_frames=120, n_objects=8, feat_dim=64):
    """The scene of ``benchmarks/mot_eval.py`` ``synthetic_eval``: per
    frame the gt rows [id, x1, y1, x2, y2] and the detections (xywh
    centres, confidences, unit features), drawn in the same order from the
    same seeded generator (``tests/test_torch_port_mot.py`` holds it to the
    reference's numbers)."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n_objects, feat_dim))
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    pos = rng.uniform([100, 200], [1700, 800], (n_objects, 2))
    vel = rng.uniform(-12, 12, (n_objects, 2))
    size = rng.uniform([40, 90], [90, 200], (n_objects, 2))
    t_in = rng.integers(0, 20, n_objects)
    t_out = rng.integers(n_frames - 30, n_frames + 30, n_objects)
    occl = [(rng.integers(30, 70), rng.integers(3, 15))
            for _ in range(n_objects)]
    gt_frames, dets = [], []
    for t in range(n_frames):
        rows, confs, fs, gts = [], [], [], []
        for k in range(n_objects):
            if not (t_in[k] <= t < t_out[k]):
                continue
            o_start, o_len = occl[k]
            cx, cy = pos[k] + vel[k] * t
            w, h = size[k]
            cx = float(np.clip(cx, w / 2, 1920 - w / 2))
            cy = float(np.clip(cy, h / 2, 1080 - h / 2))
            gts.append([k + 1, cx - w / 2, cy - h / 2, cx + w / 2,
                        cy + h / 2])
            if o_start <= t < o_start + o_len:
                continue  # occluded: no detection, gt persists
            if rng.uniform() < 0.05:
                continue  # detector miss
            jit_xy = rng.normal(0, 2, 2)
            f = feats[k] + rng.normal(0, 0.08, feat_dim)
            rows.append([cx + jit_xy[0], cy + jit_xy[1], w, h])
            confs.append(float(rng.uniform(0.5, 0.95)))
            fs.append(f / np.linalg.norm(f))
        gt_frames.append(np.array(gts, np.float64).reshape(-1, 5))
        dets.append((np.array(rows, np.float64).reshape(-1, 4), confs,
                     np.array(fs, np.float64).reshape(-1, feat_dim)))
    return gt_frames, dets


def pack_scene_frame(dets, d, feat_dim):
    """One frame's detections of S streams -> (tlwh (S, D, 4), conf (S,
    D), feat (S, D, F), mask (S, D)) numpy f32 / bool, D rows per stream."""
    s = len(dets)
    tlwh = np.zeros((s, d, 4), np.float32)
    conf = np.zeros((s, d), np.float32)
    feat = np.zeros((s, d, feat_dim), np.float32)
    mask = np.zeros((s, d), bool)
    for i, (xywh, confs, fs) in enumerate(dets):
        n = len(xywh)
        tlwh[i, :n, 0] = xywh[:, 0] - xywh[:, 2] / 2
        tlwh[i, :n, 1] = xywh[:, 1] - xywh[:, 3] / 2
        tlwh[i, :n, 2:] = xywh[:, 2:]
        conf[i, :n] = confs
        feat[i, :n] = fs
        mask[i, :n] = True
    return tlwh, conf, feat, mask


def run_tracking_quality(dev):
    """The tracking-quality gate on the card: MOT_STREAMS streams, each the
    ``mot_scene`` of its own seed (MOT_FRAMES frames, MOT_OBJECTS objects),
    through kernel 3 (``tracker_step_fused_batched``) and kernel 5
    (``tracker_step``), one launch per frame for all streams, at the
    reference's synthetic-eval configuration (max_tracks 64, max_dets 32,
    feat_dim 64, nn_budget 100), and through ``tracker_step`` on the CPU.
    Per stream, MOTA, ID switches and IDF1 (``utils/mot.py``) of both
    kernels must equal the CPU's. Returns {kernel name: launches} over both
    runs, every counter of the port read."""
    import torch

    from yolo_deepsort_tpu_torch.config import TrackerConfig
    from yolo_deepsort_tpu_torch.tracking.tracker import (
        init_tracker_state,
        tracker_step,
    )
    from yolo_deepsort_tpu_torch.tracking.tracker_kernel import (
        tracker_step_fused_batched,
    )
    from yolo_deepsort_tpu_torch.utils.mot import evaluate_mot, idf1_score

    cfg = TrackerConfig(max_tracks=64, max_dets=32, feat_dim=MOT_FEAT,
                        nn_budget=100)
    scenes = [mot_scene(seed, MOT_FRAMES, MOT_OBJECTS, MOT_FEAT)
              for seed in range(MOT_STREAMS)]
    packed = [pack_scene_frame([sc[1][t] for sc in scenes], cfg.max_dets,
                               MOT_FEAT) for t in range(MOT_FRAMES)]

    def run(step, device):
        st = init_tracker_state(cfg, MOT_STREAMS, device)
        hyps = [[] for _ in range(MOT_STREAMS)]
        for frame in packed:
            st, boxes, emit = step(cfg, st, *(torch.from_numpy(a).to(device)
                                              for a in frame), MOT_HW)
            boxes, emit = boxes.cpu().numpy(), emit.cpu().numpy()
            for i in range(MOT_STREAMS):
                hyps[i].append(boxes[i][emit[i]].astype(np.float64))
        scores = []
        for i, hyp in enumerate(hyps):
            m = evaluate_mot(scenes[i][0], hyp)
            scores.append((float(m.mota), m.id_switches,
                           idf1_score(scenes[i][0], hyp), float(m.motp)))
        return scores

    want = run(tracker_step, "cpu")
    got, launches = {}, _only()
    for name, step in (("tracker", tracker_step_fused_batched),
                       ("jv_two_stage", tracker_step)):
        got[name], counts = _counted(lambda: run(step, dev))
        if counts != _only(**{name: MOT_FRAMES}):
            raise AssertionError(f"tracking quality: {name}'s run launched "
                                 f"{counts}, expected {name} {MOT_FRAMES}")
        launches = {k: launches[k] + counts[k] for k in launches}
        if [s[:3] for s in got[name]] != [s[:3] for s in want]:
            raise AssertionError(f"tracking quality through {name}: MOTA, "
                                 f"IDSW, IDF1 {got[name]} differ from the "
                                 f"CPU's {want}")
    print(f"tracking quality ({MOT_STREAMS} streams x {MOT_FRAMES} frames, "
          f"{MOT_OBJECTS} objects each, seeds 0-{MOT_STREAMS - 1}; "
          f"per stream (MOTA, IDSW, IDF1, MOTP)): K3 {got['tracker']}, K5 "
          f"{got['jv_two_stage']}, CPU {want}; MOTA, IDSW and IDF1 equal",
          flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)

    from yolo_deepsort_tpu_torch.kernels import build

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    marks = [("build", time.perf_counter())]  # (phase that ended, when)

    def mark(phase):
        marks.append((phase, time.perf_counter()))

    if "--profile" in sys.argv[1:]:
        profile_main_path(dev)
        profile_k1(dev)
        profile_int8_embed(dev)
        profile_resblock(dev)
        with tempfile.TemporaryDirectory() as tmp_dir:
            profile_facades(dev, tmp_dir)
        return 0

    rng = np.random.default_rng(1)
    results = {}
    for name, check in (("letterbox", check_letterbox),
                        ("crops", check_crops),
                        ("crops_interleaved",
                         lambda r, d: check_crops(r, d, interleaved=True)),
                        ("crops_dense", check_crops_dense),
                        ("tracker", check_tracker),
                        ("jv_cascade", check_jv_cascade),
                        ("jv_two_stage", check_jv_two_stage)):
        err, ms, plain_ms, note, io_bytes, extra = check(rng, dev)
        # K1, K2 and K6 move bytes (the crops: the box pixels, not the whole
        # frames); K3-K5 are latency chains, far above their byte bound,
        # which is what ``bound_ms`` states: their chain bound is beside it
        bound_ms, bound_by = roofline(io_bytes)
        results[name] = (err, ms, plain_ms, bound_ms, bound_by, extra)
        if "chain_bound_ms" in extra:
            note += (f"; chain bound {extra['chain_bound_ms']:.6f} ms "
                     f"({CHAIN_STEP_CYCLES} cycles a row or step at "
                     f"{extra['sm_clock_mhz']:.0f} MHz)")
        print(f"kernel {name}: max |err| {err:.3g}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms{note}; bound {bound_ms:.6f} ms "
              f"({bound_by}: {io_bytes} in and out), library call: none",
              flush=True)
    mark("kernels 1-6, dense crops")
    conv = check_conv(rng, dev)
    mark("kernel 7")
    for (hi, ci, co, k, stride, act), r in conv.items():
        f32_in = ("" if r["ms_int8_f32"] is None else
                  f"; int8 with f32 activations max |err| "
                  f"{r['err_int8_f32']:.3g}, kernel {r['ms_int8_f32']:.4f} ms "
                  f"of device time")
        print(f"kernel conv {k}x{k} s{stride} {hi}x{hi} {ci}->{co} {act} "
              f"(layers {r['layers']}): bf16 {r['ulps']:.3g} bf16 ulps (max "
              f"|err| {r['err_bf16']:.3g}), kernel {r['called_bf16']:.4f} ms "
              f"called, {r['ms_bf16']:.4f} ms of device time, "
              f"plain {r['plain_bf16']:.4f} ms, bound "
              f"{r['bound_bf16'][0]:.4f} ms ({r['bound_bf16'][1]}); int8 "
              f"max |err| {r['err_int8']:.3g}, kernel {r['called_int8']:.4f} "
              f"ms called, {r['ms_int8']:.4f} ms of device time, "
              f"plain {r['plain_int8']:.4f} ms, bound "
              f"{r['bound_int8'][0]:.4f} ms ({r['bound_int8'][1]}){f32_in}; "
              f"library conv2d+act {r['library_called']:.4f} ms called, "
              f"{r['library']:.4f} ms of device time; plan (BM, BN, "
              f"stages, split) bf16 {r['plan_bf16']} {r['tops_bf16']:.1f} "
              f"TFLOP/s, share of the bound {r['share_bf16']:.3f}; int8 "
              f"{r['plan_int8']} {r['tops_int8']:.1f} TOP/s, share "
              f"{r['share_int8']:.3f}", flush=True)

    rounding, small16 = check_bf16_rounding(rng, dev)
    mark("kernel 7 on the default bf16 path")
    for net, recs in rounding.items():
        for (n, hi, wi, ci, co, k, stride, act, f32_out, res), r in \
                recs.items():
            held = (f"{r['held']:.3g} of max(|want|, 1) (f32 out)" if f32_out
                    else f"{r['held']:.3g} bf16 ulps")
            tail = "" if res is None else f" + {res} shortcut"
            print(f"kernel conv default path {net} {k}x{k} s{stride} "
                  f"{hi}x{wi} {ci}->{co} {act}{tail} N={n} "
                  f"({len(r['layers'])} "
                  f"layers): {held}, max |err| {r['err']:.3g}, kernel "
                  f"{r['ms']:.4f} ms called, {r['device_ms']:.4f} ms of "
                  f"device time, plain {r['plain_ms']:.4f} ms, bound "
                  f"{r['bound'][0]:.4f} ms ({r['bound'][1]}); library bf16 "
                  f"conv2d+act {r['library_ms']:.4f} ms called, "
                  f"{r['library_device_ms']:.4f} ms of device time; plan "
                  f"(BM, BN, stages, split) {r['plan']}", flush=True)
    print(f"small bf16 nets card (kernel 7) vs CPU (plain): yolov3-tiny-64 "
          f"detector {small16['detector_k7_launches']} K7 launches, boxes "
          f"max |err| {small16['boxes']:.3g} px (<= {TOL_BF16_BOXES}), "
          f"objectness {small16['obj']:.3g} (<= {TOL_BF16_OBJ}), decoded "
          f"values differing {small16['differ']:.3g} (<= {MAX_BF16_DIFFER});"
          f" ReID 512-d max |feature err| {small16['reid512']:.3g} (<= "
          f"{TOL_BF16_REID['512']}), 128-d {small16['reid128']:.3g} (<= "
          f"{TOL_BF16_REID['128']})", flush=True)

    def conv_int8_lines(per_layer, n):
        for name, r in per_layer.items():
            k, stride, hi, wi, ci, co = r["shape"]
            print(f"kernel conv_int8 {name} {k}x{k} s{stride} {hi}x{wi} "
                  f"{ci}->{co} N={n} relu={r['relu']} int8_out="
                  f"{r['out_int8']} residual={r['residual']}: max |err| "
                  f"{r['err']:.3g}, kernel {r['called']:.4f} ms called, "
                  f"{r['ms']:.4f} ms of device time, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
                  f"({r['bound'][1]}); library bf16 conv2d "
                  f"{r['library_called']:.4f} ms called, {r['library']:.4f} "
                  f"ms of device time; plan (BM, BN, stages, split) "
                  f"{r['plan']}, {r['tops']:.1f} TOP/s, share of the bound "
                  f"{r['share']:.3f}", flush=True)

    conv8 = check_conv_int8(rng, dev)
    conv_int8_lines(conv8, EMBED_CROPS)
    mark("kernel 8")

    chains = check_resblock(rng, dev)
    mark("kernel 9")
    for (h, ci, cm, nblk, act), r in chains.items():
        for (mode, n), rec in r.items():
            held = (f"max |err| {rec['err']:.3g} (output rms "
                    f"{rec['rms']:.3g}), every element inside rtol = atol = "
                    f"3e-2, {rec['ulps']:.3g} bf16 ulps"
                    + (f", every block alone within {rec['block_ulps']:.3g} "
                       f"ulps of max(|x|, |out|, 2^-3)" if "block_ulps" in rec
                       else "")
                    + f", plain {rec['plain']:.4f} ms; ")
            print(f"kernel resblock {mode} N={n} {h}x{h} {ci}/{cm} x{nblk} "
                  f"{act}: {held}kernel {rec['ms']:.4f} ms called, "
                  f"{rec['device']:.4f} ms of device time, in "
                  f"{rec['launches']} call of {rec['kernel_launches']} "
                  f"kernels (plans (BM, BN, stages, split) 1x1 "
                  f"{rec['plans'][0]}, 3x3 {rec['plans'][1]}), bound "
                  f"{rec['bound'][0]:.4f} ms ({rec['bound'][1]}); layer by "
                  f"layer: library conv2d+act+add {rec['library']:.4f} ms "
                  f"({rec['library_device']:.4f} of device time), kernel 7 + "
                  f"add {rec['k7']:.4f} ms ({rec['k7_device']:.4f} of device "
                  f"time)", flush=True)

    box_err, emitted, bucket, window = check_small_path(dev)
    print(f"small path (yolov3-tiny-64, 2 x 64x128, 3 chunks of K=2) card "
          f"vs CPU: detect mask and stats equal, boxes max |err| "
          f"{box_err:.3g} px; emitted tracks equal ({emitted} rows); bucket "
          f"{bucket}, window {window}", flush=True)
    emitted = check_small_k1(dev)
    print(f"small K=1 step (yolov3-tiny-64, 2 x 64x128, cap 6, window "
          f"(48, 64), 4 frames) card vs CPU: emit, ids and discrete state "
          f"equal, boxes within 1 px ({emitted} rows)", flush=True)
    emitted = check_small_scanned(dev)
    print(f"small scanned step (yolov3-tiny-64, 2 x 64x128, 2 chunks of K=3, "
          f"both tracker branches) card vs CPU: emit, ids and discrete state "
          f"equal, boxes within 1 px, launches per chunk K1 1, dense crops "
          f"1, K2 0, K3 3 or K5 3 (rows {emitted})", flush=True)

    emitted = check_small_resblock(dev)
    print(f"small residual detector (width 128, one chain of 2 blocks at "
          f"32x32, f32, 2 x 64x128, K=1 step, cap 6, 4 frames) with the "
          f"chain route, card vs CPU: 1 K9 launch per step; emit and ids "
          f"equal, boxes within 1 px (rows: bf16 chains {emitted['True']}, "
          f"int8 chains {emitted['int8']})", flush=True)

    cos, twin = check_small_reid_int8(dev)
    print(f"small int8-resident embed (24 crops, bf16 front, {N_INT8_CONVS} "
          f"K8 launches) card vs CPU: min feature cosine {cos:.6f} (> "
          f"{MIN_COS_REID_INT8}); kernel vs plain route on the card max "
          f"|err| {twin:.3g}", flush=True)

    mark("small paths")
    setup = main_path_setup(dev)
    for name, check in (("nms", lambda: check_nms(dev, setup)),
                        ("roi_nms", lambda: check_roi_nms(rng, dev))):
        err, ms, plain_ms, note, io_bytes, extra = check()
        bound_ms, bound_by = roofline(io_bytes, extra["ops"], "f32")
        results[name] = (err, ms, plain_ms, bound_ms, bound_by, extra)
        print(f"kernel {name}: max |err| {err:.3g}, kernel {ms:.4f} ms "
              f"called, plain {plain_ms:.4f} ms{note}; bound "
              f"{bound_ms:.6g} ms ({bound_by}: {io_bytes} bytes in and out, "
              f"{extra['ops']} operations), library call: none", flush=True)
    mark("NMS kernels")
    launches = run_main_path(dev, setup)
    mark("main path")
    # the K=1 path's counts; the chunked path's counts of K1-K3 stay in
    # ``launches`` (both paths launched every kernel they list)
    k1_launches = run_k1_path(dev, setup)
    mark("K=1 path")
    int8_launches = run_int8_embed_paths(dev, setup)
    mark("int8 embed paths")
    chain_launches = run_resblock_paths(dev, setup)
    mark("chain paths")
    scan_launches = run_scanned_path(dev, setup)
    mark("scanned path")
    run_f8_path(dev, setup)
    mark("F8")
    del setup
    probe_rec, probe_launches, probe_io, probe_ops = run_probe_path(dev)
    # kernel 6's paths are the chunked and the K=1 step under
    # YDT_CROPS_LAYOUT=interleaved
    launches["crops_interleaved"] = int8_launches["crops_interleaved"]
    k1_launches["crops_interleaved"] = int8_launches["crops_interleaved_k1"]
    # the dense crops' path is the K=1 step
    launches["crops_dense"] = k1_launches["crops_dense"]
    # kernel 8 once more at the chunked path's own crop count
    chunk_crops = int8_launches["crops_per_chunk"]
    conv8_chunk = check_conv_int8(rng, dev, chunk_crops)
    conv_int8_lines(conv8_chunk, chunk_crops)
    mark("probe, kernel 8 at the chunk's crops")
    launches["jv_cascade"] = run_jv_ops(dev)
    with tempfile.TemporaryDirectory() as tmp_dir:
        facade_launches = run_facades(dev, tmp_dir)
        launches["jv_two_stage"] = facade_launches["jv_two_stage"]
        launches["roi_nms"] = facade_launches["roi_nms"]
        mark("JV ops, facades")
        run_multistream(dev, tmp_dir)
        mark("multistream")
        gid_launches = run_global_ids(dev, tmp_dir, card)
    mark("global ids")
    quality_launches = run_tracking_quality(dev)
    mark("tracking quality")
    with tempfile.TemporaryDirectory() as tmp_dir:
        train_yolo = run_yolo_training(dev, tmp_dir)
    mark("yolo training")
    with tempfile.TemporaryDirectory() as tmp_dir:
        train_reid = run_reid_training(dev, tmp_dir)
    mark("ReID training")
    parallel, dryrun_lines = run_parallel_training(dev)
    mark("training meshes")
    gate_launches = run_int8_gates()
    mark("int8 gates")
    track_gate_launches = run_int8_track_gate()
    mark("int8 track gate")
    soaks = run_soaks()
    mark("soaks")
    with tempfile.TemporaryDirectory() as tmp_dir:
        tool_launches = run_tools(dev, tmp_dir)
    mark("tools")
    video_launches = run_video(dev, card)
    mark("decoded video")
    for name, rec, shape, cli in (
            ("YOLO detection (yolov3-416, full width)", train_yolo,
             f"batch {YOLO_TRAIN_BATCH} x 416 x 416", "exported"),
            (f"ReID classifier (512-d, {REID_CLASSES} classes)", train_reid,
             f"batch {REID_TRAIN_BATCH} x 128 x 64",
             "tested and evaluated")):
        print(f"training {name}, {shape}, {TRAIN_STEPS} SGD steps on a fixed "
              f"generated batch: losses {[round(v, 4) for v in rec['losses']]}"
              f"; ms per step {[round(v, 3) for v in rec['ms']]} (the first "
              f"includes cuDNN's first-call set-up), peak device memory "
              f"{rec['peak_gib']:.3f} GiB; its tiny net's 3 steps card vs "
              f"CPU: worst loss {rec['tiny']['loss']:.3g} relative (<= "
              f"{TOL_TRAIN_LOSS}), param update {rec['tiny']['update']:.3g} "
              f"of its norm (<= {TOL_TRAIN_UPDATE}); the "
              f"CLI trained, checkpointed, resumed and {cli} on the card",
              flush=True)
    print_parallel_training(parallel, dryrun_lines)
    # the scanned path's counts: its two counted chunks, one per tracker
    # branch, every counter of the port read
    scanned = {name: sum(b[name] for b in scan_launches.values())
               for name in _only()}
    src = "yolo_deepsort_tpu_torch/csrc/"
    meta = {
        "letterbox": ("letterbox.cu", "yolo_deepsort_tpu/ops/pallas_letterbox.py:109"),
        "crops": ("crops.cu", "yolo_deepsort_tpu/ops/pallas_crops.py:150"),
        "crops_interleaved": ("crops.cu",
                              "yolo_deepsort_tpu/ops/pallas_crops.py:282"),
        "crops_dense": ("crops.cu",
                        "yolo_deepsort_tpu/ops/crops.py:78 (XLA "
                        "crop_and_normalize; crop_and_normalize_windowed "
                        ":109) and the K=1 window guard, yolo_deepsort_tpu/"
                        "parallel/streams.py:290-307"),
        "tracker": ("tracker.cu", "yolo_deepsort_tpu/tracking/tracker_pallas.py:127"),
        "jv_cascade": ("assignment.cu", "yolo_deepsort_tpu/ops/assignment_pallas.py:158"),
        "jv_two_stage": ("assignment.cu", "yolo_deepsort_tpu/ops/assignment_pallas.py:174"),
        "nms": ("nms.cu", "yolo_deepsort_tpu/ops/nms.py:31 (XLA _nms_single: "
                "lax.top_k and the lax.while_loop at :91; no Pallas kernel)"),
        "roi_nms": ("nms.cu", "yolo_deepsort_tpu/ops/nms.py:164 (XLA "
                    "roi_nms_mask: the lax.fori_loop at :206; no Pallas "
                    "kernel)"),
    }
    kernels = [{
        "name": name, "route": "cuda", "source": src + meta[name][0],
        "replaces": meta[name][1], "launches": launches[name],
        "max_abs_err": results[name][0], "ms": results[name][1],
        "plain_ms": results[name][2], "bound_ms": results[name][3],
        "bound_by": results[name][4], "library_ms": None,
        "launches_k1_path": k1_launches[name],
        "launches_scanned_path": scanned[name],
        "launches_quality_gate": quality_launches[name],
        **results[name][5],
    } for name in meta]
    kernels.append(conv_kernel_entry(
        conv, rounding, {"main": launches["conv"], "k1": k1_launches["conv"]}))
    kernels.append(conv_int8_kernel_entry(
        conv8, int8_launches["conv_int8"], int8_launches["conv_int8_k1"],
        chunk_crops, conv8_chunk))
    kernels.append(resblock_kernel_entry(
        chains, chain_launches["resblock"], chain_launches["resblock_k1"],
        chain_launches["resblock_kernels_per_step"]))
    kernels.append(probe_kernel_entry(probe_rec, probe_launches, probe_io,
                                      probe_ops))
    for entry in kernels:
        entry["launches_scanned_path"] = scanned[entry["name"]]
        entry["launches_quality_gate"] = quality_launches[entry["name"]]
        entry["launches_global_ids_path"] = gid_launches[entry["name"]]
        entry["launches_int8_gates_path"] = gate_launches[entry["name"]]
        entry["launches_int8_track_gate_path"] = \
            track_gate_launches[entry["name"]]
        entry["launches_soak_path"] = soaks["soak"]["launches"][entry["name"]]
        entry["launches_soak_multichip_path"] = \
            soaks["soak_multichip"]["launches"][entry["name"]]
        entry["launches_tools_path"] = tool_launches[entry["name"]]
        entry["launches_video_path"] = video_launches[entry["name"]]
        if entry["launches"] <= 0:
            raise AssertionError(f"kernel {entry['name']} was launched on "
                                 "no counted path")
    spent = ", ".join(f"{name} {t1 - t0:.0f}" for (_, t0), (name, t1)
                      in zip(marks, marks[1:]))
    print(f"smoke: all phases passed in {time.perf_counter() - t_start:.0f} "
          f"s ({spent})", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
