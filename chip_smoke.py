#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's eval, train and LiDAL-round paths, with MinkUNet
and with SPVCNN, on SemanticKITTI and on nuScenes, its prep stages, its
checkpoint import, its three probe entry points, every selection metric and
its multi-device path, on an NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases (each prints what it found; any failed check raises, exit code != 0):

1. device: a CUDA card is required; prints its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them, and the torch / CUDA versions.  TF32 is turned off for matmuls and
   cuDNN, so every comparison below is f32 against f32.
2. build: compiles ``lidal_tpu_torch/csrc/*.cu`` with nvcc, one process per
   source, all started together (seconds printed).
3. lookup kernel vs its plain version on the B x 26 rulebook streams of one
   SemanticKITTI-scale batch at every level, plus edge streams: bit-equal;
   per level the tiles whose window took the device-memory branch.
4. conv kernel vs its plain version at every (K, cin, cout, epilogue, m, n)
   the forward runs: |kernel - plain| <= 1e-4 * max(1, |plain|) elementwise
   (f32 sums in another order), no further from the plain version in f64 than
   F64_FACTOR times the f32 plain version is (+ 1e-6 of the abs-sum, as in
   phase 7), bit-equal on a rerun; kernel and plain times (CUDA events), the
   f32-FFMA bound and the split-TF32 bound per shape.
5. the eval slice: ``run_eval`` over B = 4 synthetic SemanticKITTI frames of
   120k points with the full-width MinkUNet (seeded random weights), caps
   ``SK_CONFIG.level_caps``: one warm-up batch, then 3 timed batches; points/s,
   per-level overflow, mIoU and each kernel's launch count in that run.
6. whole forward on one batch, kernel path vs plain path on the card: logits
   within atol = rtol = 1e-3 and argmax agreement >= 0.999 of valid voxels.
7. backward kernel vs its plain version at every (K, c_src, c_dst, c_f, m, n)
   of one full-width train step (B = 5 frames of 120k points, as
   ``SK_CONFIG.batch_size``): dx and dwg within 1e-4 * plain_abs elementwise,
   plain_abs being the plain version on |src|, |w2| and |f| (a reordered
   f32 sum over up to 655k rows; gradients are ~1e-6, so no floor of 1);
   each no further from the plain version in f64 than F64_FACTOR times the
   f32 plain version is; dwg bit-equal across two runs (no atomics); kernel
   and plain times per shape and per step, the dx and dW halves apart (dW
   alone is the ``need_dx=False`` call), the real pairs per tap, each half's
   bound at the split-TF32 and the f32 FFMA rate (bytes: the src rows the map
   names and the f rows with a real tap, each read once, the map, w2 for dx,
   and the outputs), and a yardstick for the dW products:
   f32 ``torch.mm`` with TF32 off per tap on the real pairs' operands gathered
   beforehand (the products without the gathers; not a library call of the
   same function, so ``library_ms`` stays null).
8. the train slice: a temporary SemanticKITTI tree of synthetic 120k-point
   frames, ``run_train`` through its loader (``metric_name="full"``,
   ``r_id=1``): one warm-up step, then TIMED_STEPS steps; steps/s, points/s,
   loss per step, per-level overflow, each kernel's launch count in that run;
   where one step's time goes (prepare, forward, backward, optimizer); the
   checkpoint restores into a fresh model equal to the trained one; then 10
   steps on one repeated batch must end below their first loss.
9. one whole train step from one state and one batch.  Under one forward
   (the kernels', deterministic, so every ReLU mask is the same) the
   backward kernel's gradients against the plain backward's: each within
   BWD_TOL of that gradient's max (f32 sums of up to 655k rows in another
   order through ~40 layers of backward, BN's cancellation included).  The
   kernel path against the plain path: loss within 1e-5 relative; BN
   running statistics within 1e-4 * max(1, |plain|); gradients within
   GRAD_WORST of their max, since either f32 forward flips a few ReLUs whose
   input is near 0 (measured on a small step: one flip at level 0 moved a
   gradient by 1.8 % of its max); after the Adam step every parameter within 2 * lr and all
   but 1e-3 of the entries within 1e-2 * lr.

Phases 10-13 share a second temporary SemanticKITTI tree: one sequence of
ROUND_FRAMES frames of 120k points that see ONE static synthetic world from a
moving, turning pose (``poses.txt`` / ``calib.txt`` register them, so
neighbouring frames hold points within 0.1 m of each other), labels,
supervoxel files from a coarse numpy grid, and round-1 flags.

10. ``build_grid`` on the card against ``build_grid`` on the CPU for one
    registered 120k-point frame: every field equal (cells are
    ``floor(xyz / cell)`` with a true f32 division on both).
11. ``nn_band`` kernel vs its plain version at the main-path shape (26 slots x
    131072 queries, the grids of 26 consecutive frames, one of them the
    query): ``d2`` and ``row`` bit-equal on every query; edge cases (an empty
    band, a table of only BIG rows, an exact tie, a tie whose rows lie in two
    groups visited out of row order, a pair at 0.1 m -+ 1 ulp); kernel ms per
    launch, mean band length, the pairs in the bands and the pairs the kernel
    evaluated (its device counter), the share of groups each query's own
    bound excluded for matched and unmatched queries, the brute-force floor
    of the bands' pairs, the kernel's ``-Xptxas -v`` line, the share of
    points with a match.
12. the LiDAL slice at full width, ``inf_reps = 8``, from one set of seeded
    weights: (a) staged ``run_prob_inference`` -> ``run_lidal_round``; (b)
    fused ``run_fused_lidal_round``.  Prob rows sum to 1 within 1e-4; (a) and
    (b) give identical prob and pred npys, supervoxel scores, statistics and
    ``sv_flag`` files; some supervoxel is selected; ``nn_band``, ``subm_conv``
    and ``lookup_sorted`` each launched in (b).  Frames/s of (b), seconds per
    frame of (a)'s scoring, and where one fused frame's time goes.
13. ``run_active_round`` for ``r_id = 1`` on that tree, a few train steps at
    full width: trains, evaluates, infers and scores, writes round-2 flags.

Phases 14-18 drive the second model family, SPVCNN (``model_name="SPVCNN"``),
through the same entry points; they run beside the MinkUNet phase whose batch
or tree they share (14 and 16 after 6, 15 and 17 after 9, 18 after 13).

14. ``gather8`` and ``child_sum`` kernels vs their plain versions at every
    call of one full-width SPVCNN forward (B = 4: ``gather8`` for the two
    trilinear devoxelizes, ``child_sum`` for the two point->voxel averages,
    each a chain of 4 or 2 levels in one launch), plus an all-sentinel map,
    an unsorted map with duplicate and out-of-range targets and an inf weight:
    bit-equal, sign of zero included, and on a rerun; each chain also bit-equal
    to its levels run as one ``gather8`` launch each, which is timed beside
    it.  Kernel, plain and bound times per call and per forward, and the
    trilinear shapes on full maps and the chains on full trees;
    ``library_ms`` is ``F.embedding_bag(nbr, feats_ext, per_sample_weights=w8,
    mode="sum", padding_idx=n)`` for ``gather8``, and ``index_add_`` of the
    points into their ancestors for ``child_sum``.
15. ``scatter8`` kernel vs its plain version (``index_add_``) at both shapes
    of one SPVCNN train step (B = 5): within SCATTER_TOL * sum |w8| |dy| per
    target (the plain version adds with atomics in no fixed order, and a
    level-4 voxel collects thousands of terms), no further from the plain
    version in f64 than F64_FACTOR times the f32 plain version is, bit-equal
    across two runs; the transposed map the kernel builds on the card equal
    to ``build_transpose``'s.  The kernel's time includes building that map,
    which is also timed alone (beside ``torch.sort`` + ``searchsorted``,
    the plain version's map), and the sum as the difference; ``library_ms`` is the backward of
    that ``embedding_bag`` call.
16. the SPVCNN eval slice: ``run_eval`` with ``model_name="SPVCNN"``, one
    warm-up batch and 3 timed batches; points/s, overflow, launches
    (``gather8`` and ``child_sum`` 2 each per batch); kernel path vs plain
    path logits as phase 6.
17. the SPVCNN train slice as phase 8 (``gather8``, ``child_sum`` and
    ``scatter8`` 2 launches each per step, dropout on, per-frame seeds), and the train step of
    phase 9 with fixed dropout seeds.
18. ``run_fused_lidal_round`` with SPVCNN on phase 12's tree: prob maps finite
    with rows summing to 1, some supervoxel selected, frames/s.

Phases 19-22 hold the three bf16 probe kernels (operands rounded to bf16, f32
sums: the gather-first tile on ``wgmma``, the fused backward's dw on
``mma.sync`` over per-tap pair lists) and drive the probe entry points; they
run beside the phase whose maps they share (19 and 20 after 4, 21 and 22 after
7).

19. ``conv_gather_first``, unpipelined and pipelined, vs its plain version at
    the six shapes of ``tools/probe_conv_v3`` (its maps and data) and at three
    convs of the B = 4 forward's real maps (the widest K = 27, a down and an up
    conv): |kernel - plain| <= PROBE_TOL * (|bf16 feats| @ |bf16 w|) elementwise
    (products of bf16 values are exact in f32, so only the order of the f32
    sums differs), ``pipelined`` bit-equal to not, bit-equal across two runs;
    ms of the wrapper (casts included) for both, of the kernel alone on packed
    operands, of the plain version and of the f32 ``subm_conv`` kernel, and
    the bound; the kernel's TFLOP/s on the real pairs and on the products its
    tiles issue (``cuda_conv_bf16.tile_products``), and their ratio.
20. ``conv_byte_planes`` bit-equal to ``conv_gather_first`` at the two shapes of
    ``tools/probe_int8_gather``, on an all-sentinel map and on an unsorted map
    with out-of-range indices; ms of both kernels on packed operands.
21. ``conv_dx_dw_fused`` in its three modes at the three shapes of
    ``tools/probe_dxdw_features`` and at every shape of phase 7's train step: dx
    and dw within PROBE_TOL of the abs-sum form of the plain version,
    ``dx_zero_dw`` gives zeros, dx equal in all modes, dw bit-equal across two
    runs, neither further from the plain version in f64 than F64_FACTOR times
    the f32 plain version is; ms per mode beside the f32 ``conv_dx_dw`` kernel
    (phase 7's time on the same arguments), the plain version and the bound,
    per shape and per train step; TFLOP/s on the real pairs and on the
    products issued (dx's tiles and dw's pairs), and their ratio.
22. the three probes through their entry points (``main()`` of
    ``lidal_tpu_torch.tools.probe_conv_v3``, ``probe_int8_gather`` and
    ``probe_dxdw_features``): their own checks pass and each kernel launched.
23. on phase 12's tree: the previous round's prob / pred / outfeat maps
    of the 30 frames by ``run_prob_inference`` (SCORE_VIEWS views), then
    ``score_command`` for ENT, MAR, CONF, SEGENT, CSET and RAND (frame level, on
    SCORE_SEQS sequences that all point at those 30 frames' maps, so that 1 %
    of the frame entries is a frame) and for ReDAL and RAND (supervoxel level,
    on the one sequence): each once on the card and once on the CPU with equal
    flag files, the expected number of frames or points added, the three
    device scores within 1e-6 of the CPU's, seconds per metric.

Phases 24-28 drive the nuScenes path on a temporary v1.0-trainval-like tree
(``write_nu_tree``): a train scene of 40 keyframes (nuScenes's 20 s at 2 Hz)
and a val scene of 30, each keyframe 34,700 points of 5 columns, all of one
static world at map coordinates of ~10^3 m seen from a route that moves
2.5 m and turns 0.5 degrees a keyframe, through a LIDAR_TOP mounted with
nuScenes's rotation, with 1 cm of noise; ``NU_CONFIG``'s widths and caps.

24. ``prep_command`` grids, supervoxels (the native k-means; its g++ build
    timed apart), bootstrap, and vccs and boundary over the first 4 frames:
    seconds per stage, artifact counts, the supervoxel count.
25. the NU eval slice as phases 5 and 6, with MinkUNet and with SPVCNN:
    ``evaluate_command`` once as the warm-up, then ``run_eval`` over 3
    batches of B = 2 x 15 = 30 val keyframes (1,966,080 rows at level 0);
    points/s, overflow, launches; kernel path vs plain path logits.
26. the NU train slice as phase 8 through ``_build_nu_train_loader``
    (``metric_name="full"``), B = 15, 1 + 5 steps: steps/s, points/s, the
    step split, the checkpoint round trip, descent.
27. ``build_grid`` on the card == the CPU's for a registered NU frame;
    ``nn_band`` at 26 slots x 65536 queries bit-equal to its plain version;
    staged and fused NU rounds (``inf_reps = 8``, the frames enumerated as
    ``cli/commands._dataset_frames`` does) with identical prob / pred npys,
    statistics and ``sv_flag`` files, some supervoxel selected; frames/s.
28. the seeded NU MinkUNet and SPVCNN exported to a torchsparse-layout
    ``current.pt``, imported by ``import_torch_command`` and restored by
    ``_load_eval_variables``: logits on the 30-frame batch bit-equal to the
    source model's.

Phase 29 drives the multi-device path (``parallel/mesh.py``, the ``group``
argument of the entry points) as far as one card allows: NCCL puts no two
ranks on one GPU.  Any failed group or rank fails the run.

29. (i) after phase 17, a world-size-1 NCCL group (``tcp://127.0.0.1`` on a
    free port): ``run_train`` at B = 5 with and without the group, 3 steps
    each from the seed, every tensor bit-equal and ``all_reduce.calls > 0``;
    steps/s of 1 + 5 steps without and with the group in six turns (plain, group,
    group, plain, plain, group) beside phase 8's; ``run_eval`` through the group on phase 5's
    model, batches and generator gives phase 5's confusion.  (ii) two
    processes on the card joined by gloo (CUDA tensors all-reduced through
    the host), one train step at a global B = 4 (2 frames a rank) of the
    full-width MinkUNet from phase 8's state against one process's B = 4 step
    from it (phase 9's tolerances), and the eval confusion of 8 frames in
    global batches of 4 equal to one process's; steps/s of the two ranks at
    a global B = 4 beside one process's, and a step's small all-reduces
    through gloo.  (iii) after phase 12, two gloo ranks on the card split
    phase 12's frames as ``torchrun`` would over cards: ``run_prob_inference``
    over each rank's ``process_shard`` with maps bit-equal to phase 12's,
    then ``run_fused_lidal_round`` over the group with flags, saved maps and
    selections identical to phase 12's, ``nn_band`` launched once a frame.

Phase 30 drives the bf16 route (``ops/conv.bf16_route``, the command line's
``--bf16_route``: ``ops/conv.BF16_OPERANDS`` and
``ops/cuda_gather8.SCATTER8_BF16``, the counterparts of the JAX package's
``conv.USE_PALLAS`` and ``pallas_gather8.USE_PALLAS_BWD``: operands staged in
bf16, sums in f32) at full width with the seeded weights, batches and caps of
phases 5, 8, 12, 16-18 and 25-29; every earlier phase runs on the f32 route,
the default, as before.  Its parts run beside the phase whose model or tree
they share (a and b after 6 and 16, a and c after 9 and 17, d after 29 (iii),
e after 25, 26 and 27, f, g and h's round after 23, h's groups after 29 (ii));
on the route no f32 conv, backward, gather8, child_sum or scatter8 may launch.

30. (a) every routed call at the shapes of one B = 4 forward and one B = 5
    step against its plain bf16 version, with the gates of phases 19-21
    (PROBE_TOL of the abs-sum, F64_FACTOR times the plain version's distance
    from f64, bit-equal reruns): ``conv_gather_first`` with the eval-BN
    epilogue (rows with no real tap exactly 0; the wrapper's casts timed
    apart, the f32 ``subm_conv`` beside it), ``conv_dx_dw_fused`` (the stem's
    dW alone, beside its dx + dW call; the f32 ``conv_dx_dw`` beside it),
    ``gather8`` and ``child_sum`` as in phase 14 on bf16-rounded tables
    (bit-equal) and ``scatter8`` on bf16-rounded rows, none allocating more
    than its f32 instance (the kernels round f32 rows in registers: no bf16
    copy).
    (b) ``run_eval`` with MinkUNet and SPVCNN at B = 4 on both routes in
    turns (f32, bf16, bf16, f32): points/s; one batch's logits on the route
    against the f32 route's (max difference over the largest logit, rms,
    argmax agreement at least ROUTE_ARGMAX_AGREE, bit-equal on a rerun).
    (c) ``run_train`` at B = 5 from the seeded state on both routes in turns
    (MinkUNet: f32, bf16, bf16, f32; SPVCNN: bf16, f32): steps/s, each step's
    loss on both (the first step, from one state, within ROUTE_LOSS_TOL),
    the bf16 runs bit-equal.  (d) phase 12's fused MinkUNet round on the
    route, twice: frames/s, the runs' maps, flags and selection bit-equal,
    both rounds' selections within the budget, and the selected supervoxels
    against phase 12's f32 round (counts and |A n B| / |A u B|, printed, not
    gated).  (e) nuScenes beside phases 25-27: eval at B = 30 with MinkUNet
    and SPVCNN as (b) (argmax agreement with f32 at least
    ROUTE_ARGMAX_AGREE), training at B = 15 as (c), and phase 27's fused
    round on the route (frames/s beside phase 27's, the selections against
    its).  (f) after phase 23, on phase 12's prepared tree and weights: the
    MinkUNet round on the route staged and fused, bit-equal (maps, flags,
    supervoxel scores, selection), and phase 18's SPVCNN fused round on the
    route; frames/s beside phases 12 and 18, selections against theirs.  (g)
    ``cli.main(["run-experiment", "--rounds", "3", "--bf16_route", ...])``
    in this process on phase 12's tree (round 0 labels every third frame,
    EXPERIMENT_STEPS train steps a round, eval on) beside the same command
    without the flag: seconds of each, and per round the supervoxels each
    selects and their overlap (recorded, not gated).  (h) 29's multi-device
    paths on the route, each rank turning it on itself: the one-rank NCCL
    group (3 steps bit-equal to no group's, eval confusion equal), the two
    gloo ranks' train step and eval (after 29 (ii); the step no further from
    one process's than the f32 route's step is from the route's, every
    weight within 2 lr, the eval confusion equal), and (f)'s round split
    over two gloo ranks (maps bit-equal to (f)'s staged round, selection,
    flags and maps identical to its fused round).  The record's
    ``subm_conv_bf16``, ``conv_dx_dw_bf16``, ``gather8_bf16``,
    ``child_sum_bf16`` and ``scatter8_bf16`` entries are (a)'s numbers,
    with the launches of the bf16 runs of (b)-(g).
31. PTv3's patch attention kernels (``csrc/patch_attention.cu``) at
    ``sk_ptv3_train``'s level-0 (ATTN_SHAPES: 300 patches x 2 heads) and
    level-3 shapes (28 x 16), K = 1024, d = 16: o, lse, dq, dk and dv no further
    from the plain version in f64 than F64_FACTOR times the f32 plain version
    (+ 1e-6 of the abs-sum, ``attention_abs_sums``; lse: of |lse|), two
    forwards and two backwards bit-equal;
    forward and backward timed apart beside their plain versions, their
    bounds (the forward's 4 and the backward's 8 x P x K^2 x C operations at
    495 / 3 TFLOP/s; q, k, v, o, lse, dO, dq, dk, dv once each) and the
    library's memory-efficient ``F.scaled_dot_product_attention`` and its
    backward as the yardstick (``library_ms``), which the port never calls.
32. PTv3's main paths at ``sk_ptv3_train``'s shapes (``ptv3_sk``, B = 5
    frames of the SK tree): ``run_train`` with ``model_name="PTv3"``, then an
    eval forward of the trained model on the B = 4 eval batch; one
    ``launch.attn_fwd`` a block and forward and two ``launch.attn_bwd`` (dq,
    then dk and dv) a block and backward, counted from 0 just before.

The launch counts of the JSON record are those of the main paths (the eval
runs of phases 5, 16 and 25, the train runs of phases 8, 17 and 26, the fused
rounds of phases 12, 18 and 27, the probes' run of phase 22, PTv3's train run
and eval forward of phase 32; on the route
the runs of 30 (b)-(g)), each counted from 0 just before it.  ``bound_ms`` is the least time the card could
take for the same work: the larger of the bytes the function must move (each
input read once, each output written once) over 3.35 TB/s and its operations
over 67 TFLOP/s (f32 outside the tensor cores; integer compares at half that),
counting the work this run's data needs (real (row, tap) pairs of the convs);
``nn_band``'s 8 operations per pair may not be fused into FMAs, so they are
held to 33.5e12 unfused f32 operations/s (132 SMs x 128 lanes x 1.98 GHz),
counting the pairs its pruned scan evaluated; ``subm_conv`` and ``conv_dx_dw``, whose
products run on the tensor cores as three tf32 products each (split TF32, f32
accuracy), are held to 495 / 3 TFLOP/s (phases 4 and 7 print their f32-FFMA
bounds beside it); the bf16
probe kernels are held to the bf16 tensor-core rate of 989 TFLOP/s and to the
bf16 table rows their map names.  ``library_ms`` times one PyTorch call that
computes the same function where there is one (``torch.searchsorted`` for the
lookup, ``embedding_bag`` and its backward for ``gather8`` / ``scatter8``,
``index_add_`` for ``child_sum``, and their bf16 instances, on the same
rounded operands), used nowhere in the port.  The last two lines of standard output are
the kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np

SEED = 0
DEVICE = "cuda"
B = 4
N_PTS = 120_000
TIMED_BATCHES = 3
CONV_TOL = 1e-4
LOGIT_TOL = 1e-3
ARGMAX_AGREE = 0.999
TIMED_STEPS = 5
DESCENT_STEPS = 10
F64_FACTOR = 4.0  # a kernel's distance from f64 against the plain version's (phase 7)
SCATTER_TOL = 1e-4  # scatter8 kernel vs index_add_, share of sum |w8| |dy| per target (phase 15)
BWD_TOL = 1e-3  # backward kernel vs plain under one forward, share of each gradient's max (phase 9)
GRAD_WORST = 0.1  # kernel path vs plain path, share of each gradient's max (phase 9)
LR = 1e-3
DROPOUT_SEEDS = (11, 12, 13, 14, 15)  # SPVCNN's per-frame dropout seeds where a phase fixes them
ROUND_FRAMES = 30  # frames of the LiDAL round's sequence (a frame has 24 neighbours)
ROUND_STEPS = 3  # train steps of phase 13's round
WORLD_POINTS = 200_000  # points of the static world; each frame sees N_PTS of them
SV_CELL = 10.0  # metres: side of the coarse grid cells that stand in for supervoxels
PROB_SUM_TOL = 1e-4
PROBE_TOL = 1e-5  # bf16 probe kernels vs their plain versions, share of the abs-sum (phases 19-21, 30)
ROUTE_ARGMAX_AGREE = 0.99  # logits of the bf16 route against the f32 route's on one batch (phase 30)
ROUTE_LOSS_TOL = 1e-2  # the first train step's loss on the bf16 route against the f32 route's, relative (phase 30)
SCORE_VIEWS = 2  # views of phase 23's inference (the scorers read maps; their depth is no concern of theirs)
SCORE_SEQS = 4  # sequences of phase 23's frame-level tree, all pointing at the ROUND_FRAMES frames' maps
SCORE_TOL = 1e-6  # a frame's device score on the card vs on the CPU (phase 23)
NU_TRAIN_SCENE, NU_VAL_SCENE = "scene-0001", "scene-0003"  # a train and a val scene of the official split
NU_TRAIN_FRAMES, NU_VAL_FRAMES = 40, 30  # keyframes: nuScenes's 20 s scenes at 2 Hz; the val scene is one eval batch
NU_PTS = 34_700  # points of a nuScenes LIDAR_TOP keyframe
NU_WORLD_POINTS = 200_000  # points of the static world both NU scenes see
NU_ORIGIN = np.array([1010.0, 1610.0, 0.0])  # map coordinates (m) of the NU route's start, as in Boston seaport's map
NU_STEP, NU_TURN = 2.5, 0.5  # metres and degrees the NU ego moves and turns a keyframe
NU_PREP_FRAMES = 4  # frames of the vccs and boundary stages (host code)
ATTN_SHAPES = ((300, 2), (28, 16))  # (patches, heads) of sk_ptv3_train's level 0 and level 3 (phase 31)
ATTN_K = 1024  # tokens a patch
# NVIDIA H100 SXM data-sheet peaks: HBM bytes/s, f32 FLOP/s outside the tensor
# cores; integer compares are taken at half the f32 rate (64 INT32 lanes per SM
# against 128 FP32 lanes)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# f32 operations that are not fused multiply-adds: 132 SMs x 128 lanes x 1.98 GHz (nn_band may not contract)
PEAK_F32_UNFUSED = 132 * 128 * 1.98e9
PEAK_I32 = PEAK_F32 / 2
PEAK_BF16 = 989e12  # dense bf16 on the tensor cores
PEAK_TF32 = 495e12  # dense tf32 on the tensor cores
PEAK_SPLIT_TF32 = PEAK_TF32 / 3  # f32-accurate products as three tf32 products (the conv kernel)
# raw SemanticKITTI ids of 19 distinct train classes (car, bicycle, ..., traffic-sign)
RAW_IDS = np.array([10, 11, 15, 18, 20, 30, 31, 32, 40, 44, 48, 49, 50, 51, 70, 71, 72, 80, 81], np.uint32)


def synthetic_sk_frame(rng, n):
    """Surface-like LiDAR frame (ground rings + structures) at SemanticKITTI scale."""
    n_g = int(n * 0.6)
    n_w = n - n_g
    r = 2 + 78 * rng.random(n_g) ** 1.5
    th = rng.uniform(0, 2 * np.pi, n_g)
    ground = np.stack([r * np.cos(th), r * np.sin(th), 0.05 * rng.standard_normal(n_g)], 1)
    cx, cy = rng.uniform(-60, 60, (2, 24))
    wi = rng.integers(0, 24, n_w)
    walls = np.stack(
        [
            cx[wi] + rng.normal(scale=2.0, size=n_w),
            cy[wi] + rng.normal(scale=2.0, size=n_w),
            rng.uniform(0, 4, n_w),
        ],
        1,
    )
    xyz = np.concatenate([ground, walls]).astype(np.float32)
    sig = rng.random(n).astype(np.float32)
    return xyz, sig


def make_batch(rng, point_cap, b=B):
    """One loader-style batch dict of b frames, labels in 0..18."""
    xyz = np.zeros((b, point_cap, 3), np.float32)
    sig = np.zeros((b, point_cap), np.float32)
    valid = np.zeros((b, point_cap), bool)
    labels = np.full((b, point_cap), 255, np.int32)
    for i in range(b):
        x, s = synthetic_sk_frame(rng, N_PTS)
        xyz[i, :N_PTS], sig[i, :N_PTS], valid[i, :N_PTS] = x, s, True
        labels[i, :N_PTS] = rng.integers(0, 19, N_PTS)
    return {"xyz": xyz, "sig": sig, "valid": valid, "labels": labels, "trunc_points": 0}


class Bound:
    """Sum of the least times the card could take for a kernel's calls."""

    def __init__(self):
        self.ms = {"bytes": 0.0, "operations": 0.0}

    def add(self, nbytes: float, ops: float, peak_ops: float = PEAK_F32, calls: int = 1) -> float:
        t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES, 1e3 * ops / peak_ops
        by = "bytes" if t_bytes >= t_ops else "operations"
        self.ms[by] += calls * max(t_bytes, t_ops)
        return max(t_bytes, t_ops)

    @property
    def total(self) -> float:
        return self.ms["bytes"] + self.ms["operations"]

    @property
    def by(self) -> str:
        """What binds the larger share of the sum."""
        return max(self.ms, key=self.ms.get)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


KERNELS = ("lookup_sorted", "subm_conv", "conv_dx_dw", "nn_band", "gather8", "scatter8",
           "conv_gather_first", "conv_byte_planes", "conv_dx_dw_fused", "gather8_bf16", "scatter8_bf16",
           "child_sum", "child_sum_bf16", "attn_fwd", "attn_bwd")


def reset_launches() -> None:
    """Set every count of ``utils.profiling`` to 0, each kernel's launches
    and the all-reduces (just before a main path runs)."""
    from lidal_tpu_torch.utils import profiling

    profiling.reset()


def read_launches(expected) -> dict:
    """Every kernel's launch count (just after a main path ran); the kernels
    named in ``expected`` must have launched."""
    from lidal_tpu_torch.utils import profiling

    counts = {k: profiling.counter(f"launch.{k}") for k in KERNELS}
    never = [k for k in expected if counts[k] == 0]
    require(not never, f"kernels of the path that never launched: {never} ({counts})")
    return counts


def conv_close(got, want):
    """(within CONV_TOL * max(1, |plain|) everywhere and finite, max |kernel - plain|)."""
    diff = (got - want).abs()
    ok = bool((diff <= CONV_TOL * want.abs().clamp_min(1.0)).all()) and bool(got.isfinite().all())
    return ok, float(diff.max()) if diff.numel() else 0.0


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, after warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def randomise_bn(model, seed: int) -> None:
    """BN affine and running statistics drawn like tests/ts_oracle.py's, so the
    fused epilogues do real work."""
    import torch

    from lidal_tpu_torch.models.layers import MaskedBatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MaskedBatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(0.5 + torch.rand(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))


def write_sk_tree(root, rng, n_frames):
    """A SemanticKITTI sequence "00" of synthetic 120k-point frames (.bin and
    .label with raw ids of the 19 train classes) under ``root/sequences``."""
    seq = os.path.join(root, "sequences", "00")
    os.makedirs(os.path.join(seq, "velodyne"))
    os.makedirs(os.path.join(seq, "labels"))
    for i in range(n_frames):
        xyz, sig = synthetic_sk_frame(rng, N_PTS)
        np.concatenate([xyz, sig[:, None]], 1).astype(np.float32).tofile(os.path.join(seq, "velodyne", f"{i:06d}.bin"))
        RAW_IDS[rng.integers(0, len(RAW_IDS), N_PTS)].tofile(os.path.join(seq, "labels", f"{i:06d}.label"))
    return os.path.join(root, "sequences")


def backward_phase(state, tb):
    """7: every conv_dx_dw call of one train step against its plain version.
    Per shape and per step it times the two halves apart (dW alone is the
    ``need_dx=False`` call on the same arguments, dx the rest), prints the
    real pairs per tap, and times a yardstick: f32 ``torch.mm`` (TF32 off)
    per tap on the real pairs' operands already gathered.  Returns (max
    |kernel - plain|, kernel ms per step, plain ms per step, the step's Bound
    at the split-TF32 rate over the real (row, tap) pairs and the rows they
    read, the step's distinct calls as {shape key: arguments}, {shape key:
    calls per step}, {shape key: kernel ms})."""
    import torch

    from lidal_tpu_torch.ops import cuda_conv_dxdw
    from lidal_tpu_torch.runtime.train import train_step

    captured, calls = {}, {}
    kernel, plain = cuda_conv_dxdw.conv_dx_dw, cuda_conv_dxdw.conv_dx_dw_plain

    def recorder(src, w2, nbr, f, need_dx=True):
        key = (nbr.shape[1], src.shape[1], w2.shape[2], f.shape[1], nbr.shape[0], src.shape[0], bool(need_dx))
        calls[key] = calls.get(key, 0) + 1
        if key not in captured:
            captured[key] = (src.clone(), w2.clone(), nbr.clone(), f.clone(), bool(need_dx))
        return kernel(src, w2, nbr, f, need_dx)

    cuda_conv_dxdw.conv_dx_dw = recorder
    try:
        train_step(state, tb)
    finally:
        cuda_conv_dxdw.conv_dx_dw = kernel
    err = k_total = p_total = 0.0
    least = Bound()  # the whole call at the split-TF32 rate (the kernels' record)
    halves = {h: {"ms": 0.0, "plain": 0.0, "tf32": Bound(), "f32": Bound()} for h in ("dx", "dW")}
    yard_total = 0.0
    kernel_ms = {}
    for key in sorted(captured):
        args = captured[key]
        src, w2, nbr, f, need_dx = args
        k, c_src, c_dst, c_f, m, n, _ = key
        c = calls[key]
        dx, dwg = kernel(*args)
        real = (nbr >= 0) & (nbr < n)
        per_tap = real.sum(0).tolist()
        # bytes: only the src rows the map names and the f rows with a real tap are read
        pairs, src_bytes = bf16_rows_bytes(nbr, n, 4 * c_src)
        f_bytes = int(real.any(1).sum()) * 4 * c_f
        b_ms = least.add(src_bytes + f_bytes + nbytes(w2 if need_dx else None, nbr, dx, dwg),
                         2.0 * pairs * c_src * ((c_dst if need_dx else 0) + c_f), PEAK_SPLIT_TF32, calls=c)
        h_bound = {}
        for h, moved, flop in (("dx", src_bytes + nbytes(w2, nbr, dx), c_dst),
                               ("dW", src_bytes + f_bytes + nbytes(nbr, dwg), c_f)):
            if h == "dx" and not need_dx:
                h_bound[h] = (0.0, 0.0)
                continue
            h_bound[h] = tuple(halves[h][r].add(moved, 2.0 * pairs * c_src * flop, peak, calls=c)
                               for r, peak in (("tf32", PEAK_SPLIT_TF32), ("f32", PEAK_F32)))
        _, dwg2 = kernel(*args)
        want = plain(*args)
        ref = plain(src.double(), w2.double(), nbr, f.double(), need_dx)
        bound = plain(src.abs(), w2.abs(), nbr, f.abs(), need_dx)
        require(torch.equal(dwg, dwg2), f"conv_dx_dw {key}: dwg differs between two runs")
        e, notes = 0.0, []
        for name, got, p, r, b in zip(("dx", "dwg"), (dx, dwg), want, ref, bound):
            if got is None:
                continue
            d = (got - p).abs()
            require(bool(got.isfinite().all()) and bool((d <= CONV_TOL * b).all()),
                    f"conv_dx_dw {key}: {name} max |kernel - plain| {float(d.max())}")
            e_k = float((got.double() - r).abs().max())
            e_p = float((p.double() - r).abs().max())
            require(e_k <= F64_FACTOR * e_p + 1e-6 * float(b.max()),
                    f"conv_dx_dw {key}: {name} {e_k:.2e} from f64 against the plain version's {e_p:.2e}")
            e = max(e, float(d.max()))
            notes.append(f"{name} from f64 {e_k:.1e} (plain {e_p:.1e})")
        err = max(err, e)
        k_ms = cuda_ms(lambda: kernel(*args))
        dw_ms = cuda_ms(lambda: kernel(src, w2, nbr, f, False)) if need_dx else k_ms
        p_ms = cuda_ms(lambda: plain(*args), reps=3)
        pdw_ms = cuda_ms(lambda: plain(src, w2, nbr, f, False), reps=3) if need_dx else p_ms
        # the yardstick: the products alone, on operands gathered beforehand
        ops = []
        for tap in range(k):
            i = real[:, tap].nonzero()[:, 0]
            ops.append((f[i].t(), src[nbr[i, tap].long()]))
        y_ms = cuda_ms(lambda: [torch.mm(a, b) for a, b in ops], reps=3)
        del ops
        kernel_ms[key] = k_ms
        k_total += c * k_ms
        p_total += c * p_ms
        halves["dW"]["ms"] += c * dw_ms
        halves["dW"]["plain"] += c * pdw_ms
        halves["dx"]["ms"] += c * (k_ms - dw_ms)
        halves["dx"]["plain"] += c * (p_ms - pdw_ms)
        yard_total += c * y_ms
        print(f"[7 backward] K={k} c_src={c_src} c_dst={c_dst} c_f={c_f} m={m} n={n} dx={int(need_dx)} "
              f"x{c}: max|d|={e:.2e}, {', '.join(notes)}, dwg bit-equal across runs; "
              f"kernel {k_ms:.3f} ms (dx {k_ms - dw_ms:.3f}, dW {dw_ms:.3f}; bound split TF32 "
              f"{h_bound['dx'][0]:.3f} / {h_bound['dW'][0]:.3f}, f32 {h_bound['dx'][1]:.3f} / {h_bound['dW'][1]:.3f}), "
              f"plain {p_ms:.3f} ms (dW {pdw_ms:.3f}), torch.mm on gathered pairs {y_ms:.3f} ms, "
              f"bound {b_ms:.3f} ms; {pairs} real pairs, per tap {per_tap}")
    dx_h, dw_h = halves["dx"], halves["dW"]
    print(f"[7 backward] {len(captured)} shapes, {sum(calls.values())} calls per train step; per step: "
          f"kernel {k_total:.1f} ms (dx {dx_h['ms']:.1f}, dW {dw_h['ms']:.1f}), plain {p_total:.1f} ms "
          f"(dx {dx_h['plain']:.1f}, dW {dw_h['plain']:.1f}), bound {least.total:.2f} ms (split TF32, by {least.by})")
    for h, v in halves.items():
        print(f"[7 backward] {h} per step: kernel {v['ms']:.2f} ms, plain {v['plain']:.1f} ms, bound split TF32 "
              f"{v['tf32'].total:.3f} ms (by {v['tf32'].by}), f32 FFMA {v['f32'].total:.3f} ms (by {v['f32'].by})")
    print(f"[7 backward] yardstick: f32 torch.mm (TF32 off) per tap on the real pairs' gathered operands "
          f"{yard_total:.2f} ms per step against the dW kernel's {dw_h['ms']:.2f} ms (gathers included)")
    return err, k_total, p_total, least, captured, calls, kernel_ms


def step_split(state, batch, gen, caps, dev, spvcnn=False):
    """Milliseconds of one train step's prepare (h2d + augment + voxelize +
    plan, for SPVCNN the point plan too), forward + loss, backward and
    optimizer, by CUDA events."""
    import torch

    from lidal_tpu_torch.data.pipeline import forward_batch, prepare_train_batch
    from lidal_tpu_torch.runtime.train import cross_entropy_ignore

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    tb = prepare_train_batch(
        gen, *(torch.as_tensor(batch[k]).to(dev) for k in ("xyz", "sig", "valid", "labels")), level_caps=caps,
        with_points=spvcnn,
    )
    ev[1].record()
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    seeds = DROPOUT_SEEDS[: len(tb.feats)] if spvcnn else None
    loss = cross_entropy_ignore(forward_batch(state.model, tb, seeds)[0], tb.labels)
    ev[2].record()
    loss.backward()
    ev[3].record()
    state.optimizer.step()
    state.step += 1
    ev[4].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)], tb


def train_slice_phase(cfg, dev, caps, tag="8 slice", n_pts=N_PTS):
    """8 (MinkUNet), 17 (SPVCNN) and 26 (nuScenes): run_train through its
    loader over frames of ``n_pts`` points; returns (the trained state, a
    batch, each kernel's launches in the run, its steps/s)."""
    import torch

    from lidal_tpu_torch.runtime.paths import Paths
    from lidal_tpu_torch.runtime import checkpoint as ckpt
    from lidal_tpu_torch.runtime.train import train_step
    from lidal_tpu_torch.runtime.train_loop import build_train_loader, init_state, run_train

    b_train = cfg.data.batch_size
    times, losses = [], []

    def on_step(step, loss):
        losses.append(float(loss))  # waits for the step to finish
        times.append(time.perf_counter())

    spvcnn = cfg.is_spvcnn
    reset_launches()
    state = run_train(cfg, max_iter=1 + TIMED_STEPS, log_every=1, on_step=on_step, device=dev)
    launches = read_launches(("lookup_sorted", "subm_conv", "conv_dx_dw") +
                             (("gather8", "child_sum", "scatter8") if spvcnn else ()))
    require(state.step == 1 + TIMED_STEPS, f"run_train took {state.step} steps")
    per_step = tuple(launches[k] / state.step for k in ("gather8", "child_sum", "scatter8"))
    require(per_step == ((2, 2, 2) if spvcnn else (0, 0, 0)),
            f"gather8, child_sum and scatter8 launched {per_step} times per step")
    require(all(np.isfinite(x) for x in losses), f"losses {losses}")
    seconds = times[-1] - times[0]
    print(f"[{tag}] run_train ({cfg.dataset_name} {cfg.model_name}): {TIMED_STEPS} steps of {b_train} x {n_pts}-point "
          f"frames after 1 warm-up in {seconds:.3f} s = {TIMED_STEPS / seconds:.3f} steps/s = "
          f"{TIMED_STEPS * b_train * n_pts / seconds:,.0f} "
          f"points/s; losses {[round(x, 4) for x in losses]}; launches {launches}")

    path = ckpt.ckpt_path(Paths(cfg).ckpt_dir())
    require(os.path.exists(path), f"no checkpoint at {path}")
    fresh = init_state(dataclasses.replace(cfg, seed=cfg.seed + 1), dev)
    require(ckpt.restore_checkpoint(Paths(cfg).ckpt_dir(), fresh) is not None, "checkpoint did not restore")
    trained = state.model.state_dict()
    same = all(torch.equal(v, trained[k]) for k, v in fresh.model.state_dict().items())
    require(same and fresh.step == state.step, "the restored model differs from the trained one")
    print(f"[{tag}] checkpoint {os.path.basename(path)} restores a fresh model equal to the trained one "
          f"(step {fresh.step}, {len(trained)} tensors)")

    batch = next(iter(build_train_loader(cfg, shuffle=False)))
    gen = torch.Generator(device="cpu").manual_seed(SEED + 3)
    split = np.mean([step_split(fresh, batch, gen, caps, dev, spvcnn)[0] for _ in range(3)], axis=0)
    _, tb = step_split(fresh, batch, gen, caps, dev, spvcnn)
    print(f"[{tag}] one step (CUDA events, mean of 3): prepare {split[0]:.1f} ms, forward {split[1]:.1f} ms, "
          f"backward {split[2]:.1f} ms, optimizer {split[3]:.1f} ms; overflow per level "
          f"{tb.overflow.sum(dim=0).tolist()}")

    seeds = DROPOUT_SEEDS[: len(tb.feats)] if spvcnn else None  # SPVCNN: dropout on, the same masks every step
    descent = [float(train_step(fresh, tb, seeds)) for _ in range(DESCENT_STEPS)]
    require(descent[-1] < descent[0], f"no descent over {DESCENT_STEPS} steps on one batch: {descent}")
    print(f"[{tag}] {DESCENT_STEPS} steps on one batch: loss {descent[0]:.4f} -> {descent[-1]:.4f}")
    return state, tb, launches, TIMED_STEPS / seconds


def train_step_parity_phase(state, tb, tag="9 train step"):
    """9 (MinkUNet) and 17 (SPVCNN, fixed dropout seeds): one train step from
    the same state and batch, kernel path vs plain path, and the backward
    kernels against their plain versions under one forward."""
    import torch

    from lidal_tpu_torch.data.pipeline import forward_batch
    from lidal_tpu_torch.ops import cuda_conv, cuda_conv_dxdw, cuda_gather8
    from lidal_tpu_torch.runtime.train import cross_entropy_ignore, make_optimizer

    seeds = DROPOUT_SEEDS[: len(tb.feats)] if tb.pplan is not None else None
    # SPVCNN's Linear biases sit in front of a BN, which removes the mean: their gradient is zero by
    # construction and what it holds is rounding noise, so it is held to that and not to a share of its max
    noise = {n for n, _ in state.model.named_parameters() if n.startswith("point_transforms.") and n.endswith(".0.bias")}

    def run(plain_forward, plain_backward):
        model = copy.deepcopy(state.model).train()
        opt = make_optimizer(model, lr=LR)
        # load_state_dict keeps tensors that are already on the right device:
        # copy them, or one run's step would move the next run's start
        opt.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
        kernels = (cuda_conv.subm_conv, cuda_conv_dxdw.conv_dx_dw, cuda_gather8.gather8_forward,
                   cuda_gather8.child_sum, cuda_gather8.scatter8)
        if plain_forward:
            cuda_conv.subm_conv = cuda_conv.subm_conv_plain
            cuda_gather8.gather8_forward = cuda_gather8.gather8_plain
            cuda_gather8.child_sum = cuda_gather8.child_sum_plain
        if plain_backward:
            cuda_conv_dxdw.conv_dx_dw = cuda_conv_dxdw.conv_dx_dw_plain
            cuda_gather8.scatter8 = cuda_gather8.scatter8_plain
        try:
            opt.zero_grad(set_to_none=True)
            loss = cross_entropy_ignore(forward_batch(model, tb, seeds)[0], tb.labels)
            loss.backward()
        finally:
            (cuda_conv.subm_conv, cuda_conv_dxdw.conv_dx_dw, cuda_gather8.gather8_forward,
             cuda_gather8.child_sum, cuda_gather8.scatter8) = kernels
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        stats = {n: b.clone() for n, b in model.named_buffers()}
        opt.step()
        return float(loss.detach()), grads, stats, {n: p.detach().clone() for n, p in model.named_parameters()}

    def share_of_max(got, want):
        return {n: float((got[n] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                for n, w in want.items() if n not in noise}

    loss, grads, stats, params = run(False, False)
    loss_p, grads_p, stats_p, params_p = run(True, True)
    _, grads_b, _, _ = run(False, True)  # the kernels' forward, the plain backward
    require(abs(loss - loss_p) <= 1e-5 * abs(loss_p), f"loss {loss} vs plain {loss_p}")
    require(all(bool(g.isfinite().all()) for g in grads.values()), "non-finite gradients")
    for name in noise:
        g_b, g_w = float(grads[name].abs().max()), float(grads[name.replace("bias", "weight")].abs().max())
        require(g_b <= 1e-3 * g_w, f"{name}: gradient {g_b:.2e} beside its weight's {g_w:.2e}, expected rounding noise")
    bwd = share_of_max(grads, grads_b)
    worst = max(bwd, key=bwd.get)
    require(bwd[worst] <= BWD_TOL, f"backward kernel vs plain under one forward: {worst} {bwd[worst]:.2e} of its max")
    path = share_of_max(grads, grads_p)
    worst_p = max(path, key=path.get)
    require(path[worst_p] <= GRAD_WORST, f"gradient {worst_p}: {path[worst_p]:.2e} of its max from the plain path")
    s_err = 0.0
    for name, want in stats_p.items():
        d = (stats[name] - want).abs()
        require(bool((d <= 1e-4 * want.abs().clamp_min(1.0)).all()), f"BN statistic {name}: {float(d.max())}")
        s_err = max(s_err, float(d.max()))
    far = total = 0
    for name, want in params_p.items():
        d = (params[name] - want).abs()
        require(float(d.max()) <= 2 * LR, f"parameter {name} after Adam: {float(d.max())}")
        far += int((d > 1e-2 * LR).sum())
        total += d.numel()
    require(far <= 1e-3 * total, f"{far} of {total} parameters differ by more than 1e-2 * lr after Adam")
    print(f"[{tag}] loss: kernels {loss:.7f}, plain {loss_p:.7f}; under one forward the backward kernels' "
          f"gradients are within {bwd[worst]:.2e} of each one's max of the plain backward's (tol {BWD_TOL}; "
          f"worst {worst}); whole paths: worst {path[worst_p]:.2e} ({worst_p}, tol {GRAD_WORST}), median "
          f"{float(np.median(list(path.values()))):.2e}; BN statistics max|d| {s_err:.2e}; after Adam {far} of "
          f"{total} parameters beyond 1e-2 * lr")


def write_round_tree(root, rng, cfg):
    """A SemanticKITTI sequence "00" whose ROUND_FRAMES frames see ONE static
    world (WORLD_POINTS points, a label each) from a pose that moves 0.5 m and
    turns 0.5 degrees per frame: each frame is N_PTS of the world's points in
    its own sensor coordinates with 1 cm of range noise.  ``calib.txt`` holds a
    KITTI-like ``Tr`` and ``poses.txt`` the camera poses that register the
    frames.  A second sequence "08" of 2 unrelated frames is the val split.
    Also writes each train frame's supervoxel file (cells of a SV_CELL grid over
    the registered x, y) and round-1 flags (every third frame fully labelled).
    Returns the number of supervoxels."""
    from lidal_tpu_torch.data.selection import save_sv_info
    from lidal_tpu_torch.prep.poses import transform_points
    from lidal_tpu_torch.runtime.paths import Paths, ensure_dir

    world, _ = synthetic_sk_frame(rng, WORLD_POINTS)
    world = world.astype(np.float64) + np.array([7.0, 0.0, 0.0])
    world_raw = RAW_IDS[rng.integers(0, len(RAW_IDS), WORLD_POINTS)]
    tr = np.eye(4)
    tr[:3, :3] = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]  # velodyne -> camera axes, as KITTI's Tr
    tr[:3, 3] = [0.0, -0.08, -0.27]
    seq = os.path.join(cfg.data_root, "00")
    os.makedirs(os.path.join(seq, "velodyne"))
    os.makedirs(os.path.join(seq, "labels"))
    paths = Paths(cfg)
    svi_dir = ensure_dir(paths.supervoxel_dir("00", "KMeans"))
    flag_dir = ensure_dir(paths.sv_flag_dir("00", r_id=1))
    cam_poses, gid = [], 0
    for i in range(ROUND_FRAMES):
        yaw = np.deg2rad(0.5 * i)
        pose = np.eye(4)  # the sensor in the world
        pose[:3, :3] = [[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]
        pose[:3, 3] = [0.5 * i, 0.02 * i, 0.0]
        cam_poses.append(tr @ pose @ np.linalg.inv(tr))
        seen = np.sort(rng.choice(WORLD_POINTS, N_PTS, replace=False))
        xyz = transform_points(world[seen], np.linalg.inv(pose)) + 0.01 * rng.standard_normal((N_PTS, 3))
        sig = rng.random(N_PTS)
        np.concatenate([xyz, sig[:, None]], 1).astype(np.float32).tofile(os.path.join(seq, "velodyne", f"{i:06d}.bin"))
        world_raw[seen].tofile(os.path.join(seq, "labels", f"{i:06d}.label"))
        cells = np.floor(world[seen][:, :2] / SV_CELL).astype(np.int64)
        _, point2sv = np.unique(cells[:, 0] * 100_000 + cells[:, 1], return_inverse=True)
        n_sv = int(point2sv.max()) + 1
        save_sv_info(os.path.join(svi_dir, f"{i:06d}.npz"), point2sv, np.arange(gid, gid + n_sv))
        np.save(os.path.join(flag_dir, f"{i:06d}.npy"), np.full(n_sv, int(i % 3 == 0), np.int32))
        gid += n_sv
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        for key in ("P0", "P1", "P2", "P3"):
            f.write(f"{key}: " + " ".join(f"{v:.12e}" for v in np.eye(4)[:3].reshape(-1)) + "\n")
        f.write("Tr: " + " ".join(f"{v:.12e}" for v in tr[:3].reshape(-1)) + "\n")
    with open(os.path.join(seq, "poses.txt"), "w") as f:
        for pose in cam_poses:
            f.write(" ".join(f"{v:.12e}" for v in pose[:3].reshape(-1)) + "\n")
    val = os.path.join(cfg.data_root, "08")
    os.makedirs(os.path.join(val, "velodyne"))
    os.makedirs(os.path.join(val, "labels"))
    for i in range(2):
        xyz, sig = synthetic_sk_frame(rng, N_PTS)
        np.concatenate([xyz, sig[:, None]], 1).astype(np.float32).tofile(os.path.join(val, "velodyne", f"{i:06d}.bin"))
        RAW_IDS[rng.integers(0, len(RAW_IDS), N_PTS)].tofile(os.path.join(val, "labels", f"{i:06d}.label"))
    return gid


def grid_phase(cfg, dev, seq="00", name=f"{ROUND_FRAMES // 2:06d}", n_pts=N_PTS, tag="10 grid"):
    """10 (and 27 on nuScenes): build_grid on the card == build_grid on the
    CPU, field by field, for the registered frame ``name`` of ``seq``."""
    import torch

    from lidal_tpu_torch.active import lidal
    from lidal_tpu_torch.active.nn_match import build_grid
    from lidal_tpu_torch.prep.grid import load_grid_points
    from lidal_tpu_torch.runtime.paths import Paths

    xyz = load_grid_points(os.path.join(Paths(cfg).grid_dir(seq), f"{name}.npz")).astype(np.float32)
    require(xyz.shape == (n_pts, 3), f"registered frame {xyz.shape}")
    pad = np.zeros((cfg.data.point_cap, 3), np.float32)
    pad[:n_pts] = xyz
    valid = np.arange(cfg.data.point_cap) < n_pts
    with torch.inference_mode():
        on_cpu = build_grid(torch.from_numpy(pad), torch.from_numpy(valid), lidal.DIS_THRESH)
        on_card = build_grid(torch.from_numpy(pad).to(dev), torch.from_numpy(valid).to(dev), lidal.DIS_THRESH)
    for name, a, b in zip(on_cpu._fields, on_card, on_cpu):
        require(a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.cpu(), b), f"build_grid field {name} differs")
    cells = int((torch.diff(on_cpu.key_hi[:n_pts]) != 0).sum() + 1)
    print(f"[{tag}] build_grid of one registered {n_pts}-point frame (cap {on_cpu.key_hi.shape[0]}; coordinates "
          f"{np.round(xyz.min(0).astype(np.float64), 1).tolist()} to "
          f"{np.round(xyz.max(0).astype(np.float64), 1).tolist()} m): card == CPU on "
          f"{', '.join(on_cpu._fields)}; {cells} distinct x cells of {lidal.DIS_THRESH} m")


def nn_band_groups_needed(tbl, q_t, blo, nb, d2):
    """int32 [S, p]: per (slot, query) the groups of ``GROUP`` rows in its band
    whose lower bound (each axis's rounded gap to the group's box, summed as
    the kernel sums it) does not exceed the query's answer ``d2``.  An exact
    scan over these boxes must evaluate every one of them, whatever its order;
    the others it may skip once it holds the answer."""
    import torch

    from lidal_tpu_torch.ops import cuda_nnband

    group = cuda_nnband.GROUP
    s, _, cap = tbl.shape
    boxes = tbl.view(s, 3, cap // group, group)
    lo, hi = boxes.amin(dim=3), boxes.amax(dim=3)  # [S, 3, cap / GROUP]
    per_block = cuda_nnband.TN // group
    out = torch.zeros(d2.shape, dtype=torch.int32, device=d2.device)
    widest = nb.max(dim=0).values.tolist()
    ar = torch.arange(max(widest + [0]) * per_block, device=d2.device)
    for t, blocks in enumerate(widest):
        if blocks == 0:
            continue
        cols = slice(t * cuda_nnband.TILE, (t + 1) * cuda_nnband.TILE)
        g = (blo[:, t, None] * per_block + ar[None, : blocks * per_block]).clamp_max(cap // group - 1)
        in_band = ar[None, : blocks * per_block] < nb[:, t, None] * per_block  # [S, W]
        idx = g[:, None, :].expand(-1, 3, -1)
        g_lo, g_hi = lo.gather(2, idx)[:, :, None, :], hi.gather(2, idx)[:, :, None, :]  # [S, 3, 1, W]
        q = q_t[None, :, cols, None]  # [1, 3, TILE, 1]
        gap = torch.where(q < g_lo, g_lo - q, torch.where(q > g_hi, q - g_hi, torch.zeros((), device=q.device)))
        lb = (gap[:, 0] * gap[:, 0] + gap[:, 1] * gap[:, 1]) + gap[:, 2] * gap[:, 2]  # [S, TILE, W]
        out[:, cols] = ((lb <= d2[:, cols, None]) & in_band[:, None, :]).sum(dim=2, dtype=torch.int32)
    return out


def nn_band_phase(cfg, dev, seq="00", names=None, n_pts=N_PTS, tag="11 nn_band", edge_cases=True):
    """11 (and 27 on nuScenes): the nn_band kernel against its plain version at
    the main-path shape, on the grids of the frames ``names`` of ``seq`` (each
    of ``n_pts`` points; by default the first 26 of the round's sequence), and
    on edge cases.  Returns the kernel's record fields."""
    import torch

    from lidal_tpu_torch import kernels_build
    from lidal_tpu_torch.active import lidal, nn_match
    from lidal_tpu_torch.ops import cuda_nnband
    from lidal_tpu_torch.prep.grid import load_grid_points
    from lidal_tpu_torch.runtime.paths import Paths
    from lidal_tpu_torch.utils import profiling

    cap, slots = cfg.data.point_cap, lidal.NEI_NUM + 2
    grid_dir = Paths(cfg).grid_dir(seq)
    names = names or [f"{i:06d}" for i in range(slots)]
    valid = torch.arange(cap, device=dev) < n_pts
    grids = []
    with torch.inference_mode():
        for name in names:
            pad = np.zeros((cap, 3), np.float32)
            pad[:n_pts] = load_grid_points(os.path.join(grid_dir, f"{name}.npz"))
            grids.append(nn_match.build_grid(torch.from_numpy(pad).to(dev), valid, lidal.DIS_THRESH))
        q_slot = slots // 2
        pq = nn_match.prepared_from_grid(grids[q_slot])
        grids = nn_match.stack_grids(grids)
        blo, nb = nn_match.band_bounds(grids, pq)
        args = (grids.planar, pq.q_t, blo, nb)
        require(grids.planar.shape == (slots, 3, cap) and pq.q_t.shape == (3, cap), "main-path shape")
        before = profiling.counter("launch.nn_band")
        d2, row = cuda_nnband.nn_band(*args)
        torch.cuda.synchronize()
        require(profiling.counter("launch.nn_band") == before + 1, "nn_band did not count its launch")
        t0 = time.perf_counter()
        d2_p, row_p = cuda_nnband.nn_band_plain(*args)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        bad = int((d2 != d2_p).sum()), int((row != row_p).sum())
        require(bad == (0, 0), f"nn_band: {bad[0]} d2 and {bad[1]} row values differ from the plain version")
        err = float((d2 - d2_p).abs().nan_to_num(0.0, 0.0, 0.0).max())  # inf - inf where both bands are empty
        c_d2, c_row, pairs, needed = cuda_nnband.nn_band_counted(*args)
        require(torch.equal(c_d2, d2) and torch.equal(c_row, row), "nn_band with its counters differs")
        k_ms = cuda_ms(lambda: cuda_nnband.nn_band(*args))
        p_ms = cuda_ms(lambda: cuda_nnband.nn_band_plain(*args), reps=1, warmup=0)

        others = torch.arange(slots, device=dev) != q_slot
        matched = (torch.sqrt(d2) <= torch.full((), lidal.DIS_THRESH, device=dev)) & pq.s_ok
        share = float(matched[others].any(dim=0).sum()) / n_pts
        per_slot = float(matched[others].float().sum(dim=1).mean()) / n_pts
        require(share > 0, "no point of the query frame has a match in any neighbour")
        band_rows = float(nb.float().mean()) * cuda_nnband.TN
        band_pairs = int(nb.long().sum()) * cuda_nnband.TN * cuda_nnband.TILE
        require(0 < pairs <= band_pairs, f"{pairs} pairs evaluated of the bands' {band_pairs}")
        # the groups each real query's own bound could not exclude, against its band's groups
        groups = nb.repeat_interleave(cuda_nnband.TILE, dim=1).float() * (cuda_nnband.TN // cuda_nnband.GROUP)
        real = pq.s_ok[None, :] & others[:, None]
        skipped = {name: 1.0 - float(needed[real & m].float().sum()) / max(float(groups[real & m].sum()), 1.0)
                   for name, m in (("matched", matched), ("unmatched", ~matched))}
        # the pairs this data needs: each query against the rows of the groups its answer cannot exclude
        floor_groups = nn_band_groups_needed(*args, d2)
        require(bool((needed >= floor_groups).all()), "a query's lane skipped a group its answer cannot exclude")
        floor_pairs = int(floor_groups.long().sum()) * cuda_nnband.GROUP
        bound = Bound()
        # per pair: 3 subtractions, 3 products, 2 sums, unfused (the compare and selects not counted)
        bound.add(nbytes(*args, d2, row), 8.0 * floor_pairs, PEAK_F32_UNFUSED)
        evaluated = 1e3 * 8.0 * pairs / PEAK_F32_UNFUSED
        brute = 1e3 * 8.0 * band_pairs / PEAK_F32_UNFUSED
        ptxas = [ln.strip() for ln in kernels_build.BUILD_LOG["nn_band"][1].splitlines() if "registers" in ln]
        print(f"[{tag}] {slots} slots x {cap} queries on tables of {cap} rows: d2 and row bit-equal to the plain "
              f"version on all {d2.numel()} (slot, query) pairs (plain took {plain_s:.1f} s the first time); kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.1f} ms, bound {bound.total:.3f} ms (by {bound.by}: {floor_pairs:.4e} pairs, "
              f"each query against the groups its answer cannot exclude, at {PEAK_F32_UNFUSED:.3g} unfused f32 "
              f"operations/s); at that rate the pairs the warps evaluated {evaluated:.3f} ms and a brute-force scan of "
              f"the bands {brute:.3f} ms; mean band {band_rows:.0f} rows per (slot, tile), {band_pairs:.4e} pairs in "
              f"the bands ({floor_pairs / band_pairs:.4f} needed), {pairs:.4e} evaluated "
              f"({pairs / band_pairs:.4f}) = {pairs / (k_ms * 1e-3):.4e} pairs/s; groups "
              f"skipped by their own bound: {skipped['matched']:.4f} for matched, {skipped['unmatched']:.4f} for "
              f"unmatched queries; {share:.4f} of the query frame's points match in some neighbour, {per_slot:.4f} in "
              f"one neighbour on average")
        print(f"[{tag}] ptxas: {' | '.join(ptxas)}")
        if not edge_cases:
            return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound.total, "bound_by": bound.by}

        # edge cases: an empty band, only BIG rows, an exact tie, a pair at 0.1 m -+ 1 ulp
        e_cap, e_p = 2 * cuda_nnband.TN, cuda_nnband.TILE
        tbl = torch.full((4, 3, e_cap), cuda_nnband.BIG_COORD)
        tbl[1, :, 1030] = torch.tensor([0.05, 0.0, 0.0])
        tbl[1, :, 3] = torch.tensor([-0.05, 0.0, 0.0])
        tbl[1, :, 900] = torch.tensor([0.0, 0.05, 0.0])
        below, above = np.nextafter(np.float32(0.1), np.float32(0)), np.nextafter(np.float32(0.1), np.float32(1))
        tbl[2, 0, 5], tbl[2, 1:, 5] = float(below), 0.0
        tbl[3, 0, 5], tbl[3, 1:, 5] = float(above), 0.0
        e_args = [t.to(dev) for t in (tbl, torch.zeros((3, e_p)), torch.zeros((4, 1), dtype=torch.int32),
                                      torch.tensor([[0], [2], [1], [1]], dtype=torch.int32))]
        e_d2, e_row = cuda_nnband.nn_band(*e_args)
        p_d2, p_row = cuda_nnband.nn_band_plain(*e_args)
        require(torch.equal(e_d2, p_d2) and torch.equal(e_row, p_row), "nn_band edge cases differ from the plain version")
        require(bool(torch.isinf(e_d2[0]).all()) and not bool(e_row[0].any()), "empty band must give (inf, 0)")
        require(int(e_row[1, 0]) == 3, f"tie: row {int(e_row[1, 0])} won, not the lowest (3)")
        thresh = torch.full((), lidal.DIS_THRESH, device=dev)
        require(bool(torch.sqrt(e_d2[2, 0]) <= thresh) and not bool(torch.sqrt(e_d2[3, 0]) <= thresh),
                "the pair 1 ulp below 0.1 m must match and the pair 1 ulp above must not")
        big = [e_args[0][:1].contiguous(), e_args[1], e_args[2][:1].contiguous(),
               torch.full((1, 1), 2, dtype=torch.int32, device=dev)]
        b_d2, b_row = cuda_nnband.nn_band(*big)
        require(torch.equal(b_d2, cuda_nnband.nn_band_plain(*big)[0]) and bool(torch.isfinite(b_d2).all())
                and not bool(b_row.any()), "a table of only BIG rows")
        # a tie at rows 0 and 1040 whose groups are visited out of row order: the box of the group of row 1040
        # holds the queries, the group of row 0 lies 0.3 m away
        tbl = torch.full((1, 3, e_cap), cuda_nnband.BIG_COORD)
        tbl[0, :, 0:32] = torch.tensor([0.3, 0.0, 0.0])[:, None]
        tbl[0, :, 1024:1056] = torch.tensor([0.35, 0.0, 0.0])[:, None]
        tbl[0, :, 1040] = torch.tensor([-0.3, 0.0, 0.0])
        t_args = [tbl.to(dev), e_args[1], e_args[2][:1].contiguous(), torch.full((1, 1), 2, dtype=torch.int32, device=dev)]
        t_d2, t_row = cuda_nnband.nn_band(*t_args)
        require(torch.equal(t_d2, cuda_nnband.nn_band_plain(*t_args)[0]) and bool((t_row == 0).all()),
                "a tie across groups visited out of row order: the lowest row must win")
        print("[11 nn_band] edge cases bit-equal: empty band -> (inf, 0); only BIG rows; tie -> lowest row, also across "
              "groups visited out of row order; 0.1 m - 1 ulp matches, + 1 ulp does not")
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound.total, "bound_by": bound.by}


def lidal_slice_phase(cfg, root, dev, n_sv):
    """12: staged and fused LiDAL rounds from the same weights; returns (the
    kernels' launches in the fused round, its selection, {"staged": seconds
    of inference + scoring, "fused": seconds of the fused round})."""
    import torch

    from lidal_tpu_torch.active import lidal, lidal_runner
    from lidal_tpu_torch.active.nn_match import HashGrid, band_bounds, prepared_from_grid
    from lidal_tpu_torch.data import semantic_kitti as sk
    from lidal_tpu_torch.data.pipeline import pad_points
    from lidal_tpu_torch.ops import cuda_nnband
    from lidal_tpu_torch.prep.grid import load_grid_points
    from lidal_tpu_torch.runtime.paths import Paths
    from lidal_tpu_torch.runtime.prob_inference import frame_generator, make_multiview_fn, run_prob_inference
    from lidal_tpu_torch.runtime.train_loop import init_state

    model = init_state(cfg, dev).model.eval()
    randomise_bn(model, SEED + 7)
    files = sk.list_frames(cfg.data_root, cfg.data.train_split)
    require(len(files) == ROUND_FRAMES, f"{len(files)} train frames")
    frame_index = {sk.frame_id(p): i for i, p in enumerate(files)}
    by_id = {sk.frame_id(p): p for p in files}
    tpn = cfg.data.train_point_num

    # the fused round gets its own copy of the prepared tree, so that the two
    # rounds' artifacts can be compared file by file
    cfg_f = dataclasses.replace(cfg, processing_root=os.path.join(root, "Processing_fused"))
    shutil.copytree(cfg.processing_root, cfg_f.processing_root)

    selections = []
    select = lidal.select

    def recording_select(*args, **kwargs):
        selections.append([np.array(a) for a in args[:5]])
        return select(*args, **kwargs)

    lidal.select = recording_select
    try:
        # (a) staged
        inf_cfg = lidal_runner._prev_cfg(cfg)
        t0 = time.perf_counter()
        run_prob_inference(inf_cfg, model, files, lambda p: sk.read_frame(p, with_labels=False), sk.frame_id, device=dev)
        torch.cuda.synchronize()
        t_inf = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_a = lidal_runner.run_lidal_round(cfg, device=dev)
        t_score = time.perf_counter() - t0
        # (b) fused: the main path of this slice
        reset_launches()
        t0 = time.perf_counter()
        res_b = lidal_runner.run_fused_lidal_round(
            cfg_f, model, lambda seq, name: sk.read_frame(by_id[(seq, name)], with_labels=False)[:2],
            frame_index=frame_index, device=dev,
        )
        t_fused = time.perf_counter() - t0
        launches = read_launches(("lookup_sorted", "subm_conv", "nn_band"))
    finally:
        lidal.select = select
    require(launches["nn_band"] == ROUND_FRAMES, f"nn_band launched {launches['nn_band']} times for {ROUND_FRAMES} frames")

    # identical artifacts, scores and selections
    pa, pb = Paths(lidal_runner._prev_cfg(cfg)), Paths(lidal_runner._prev_cfg(cfg_f))
    worst_sum = 0.0
    for i in range(ROUND_FRAMES):
        name = f"{i:06d}"
        prob_a = np.load(os.path.join(pa.prob_dir("00"), f"{name}.npy"))
        require(prob_a.shape == (N_PTS, cfg.data.num_classes) and prob_a.dtype == np.float32, f"prob {prob_a.shape}")
        require(bool(np.isfinite(prob_a).all()), f"non-finite prob in frame {name}")
        worst_sum = max(worst_sum, float(np.abs(prob_a.sum(1) - 1.0).max()))
        require(np.array_equal(prob_a, np.load(os.path.join(pb.prob_dir("00"), f"{name}.npy"))), f"prob {name}: staged != fused")
        pred_a = np.load(os.path.join(pa.pred_dir("00"), f"{name}.npy"))
        require(pred_a.dtype == np.int32 and np.array_equal(pred_a, prob_a.argmax(1)), f"pred {name}")
        require(np.array_equal(pred_a, np.load(os.path.join(pb.pred_dir("00"), f"{name}.npy"))), f"pred {name}: staged != fused")
        flag_a = np.load(os.path.join(Paths(cfg).sv_flag_dir("00"), f"{name}.npy"))
        flag_b = np.load(os.path.join(Paths(cfg_f).sv_flag_dir("00"), f"{name}.npy"))
        require(np.array_equal(flag_a, flag_b), f"sv_flag {name}: staged != fused")
    require(worst_sum <= PROB_SUM_TOL, f"prob rows sum to 1 within {worst_sum}")
    require(len(selections) == 2 and all(np.array_equal(a, b) for a, b in zip(*selections)),
            "supervoxel flags, scores, point counts or centres differ between the staged and the fused round")
    for a, b in zip(res_a, res_b):
        require(np.array_equal(a, b), "selections differ between the staged and the fused round")
    _, sv_interds, sv_interes, sv_pnums, _ = selections[0]
    require(len(sv_interds) == n_sv and bool(np.isfinite(sv_interds).all()) and bool(np.isfinite(sv_interes).all()),
            "supervoxel scores")
    require(len(res_b.al_added) > 0 and len(res_b.sl_added) > 0, "no supervoxel was selected")
    print(f"[12 slice] staged: run_prob_inference {ROUND_FRAMES} frames x {cfg.inf_reps} views in {t_inf:.2f} s "
          f"({ROUND_FRAMES / t_inf:.3f} frames/s), run_lidal_round in {t_score:.2f} s = {t_score / ROUND_FRAMES:.4f} "
          f"s/frame of scoring (npy load, ring insert, nn_band, accumulation, aggregate, selection)")
    print(f"[12 slice] fused: run_fused_lidal_round in {t_fused:.2f} s = {ROUND_FRAMES / t_fused:.3f} frames/s "
          f"(staged total {ROUND_FRAMES / (t_inf + t_score):.3f} frames/s); launches {launches}")
    print(f"[12 slice] staged == fused: {ROUND_FRAMES} prob and pred npys, {n_sv} supervoxel scores, statistics and "
          f"sv_flag files identical; prob rows sum to 1 within {worst_sum:.1e}; {int((sv_interds > 0).sum())} of {n_sv} "
          f"supervoxels have divergence > 0; selected {len(res_b.al_added)} for labels ({int(sv_pnums[res_b.al_added].sum())} "
          f"points of a budget of {round(0.01 * tpn)}) and {len(res_b.sl_added)} for pseudo labels")

    # where one fused frame's time goes
    with torch.inference_mode():
        fn = make_multiview_fn(lidal_runner._prev_cfg(cfg), model, with_feat=False)
        mid = ROUND_FRAMES // 2
        xyz_raw, sig, _ = sk.read_frame(files[mid], with_labels=False)
        frame = [torch.from_numpy(a).to(dev) for a in pad_points(xyz_raw, sig, None, cfg.data.point_cap)[:3]]
        t_infer = cuda_ms(lambda: fn(frame_generator(cfg.seed, mid), *frame), reps=3)
        prob = fn(frame_generator(cfg.seed, mid), *frame)[0]
        ring = lidal_runner.NeighborRing(lidal.NEI_NUM + 2, cfg.data.point_cap, device=dev)
        gxyz = {i: load_grid_points(os.path.join(Paths(cfg).grid_dir("00"), f"{i:06d}.npz")).astype(np.float32)
                for i in range(lidal.NEI_NUM + 2)}
        ring.ensure(list(gxyz), lambda k: (gxyz[k], prob))
        nei = [k for k in gxyz if k != mid][: lidal.NEI_NUM]
        buf = np.zeros((cfg.data.point_cap, 3), np.float32)
        buf[:N_PTS] = gxyz[0]
        prob0 = torch.where((torch.arange(cfg.data.point_cap, device=dev) < N_PTS)[:, None], prob, 0.0)
        # one frame entering the ring: coords upload, build_grid, slot writes (slot 0 rewritten with itself)
        t_insert = cuda_ms(lambda: ring._insert(ring.key2slot[0], torch.from_numpy(buf).to(dev), N_PTS, prob0), reps=3)
        w = torch.from_numpy(ring.weights(nei)).to(dev)
        t_slot = cuda_ms(lambda: lidal.score_slot(ring.state, ring.key2slot[mid], w), reps=3)
        pq = prepared_from_grid(HashGrid(*(f[ring.key2slot[mid]] for f in ring.state[0])))
        blo, nb = band_bounds(ring.state[0], pq)
        t_band = cuda_ms(lambda: cuda_nnband.nn_band(ring.state[0].planar, pq.q_t, blo, nb), reps=3)
        scores = lidal.score_slot(ring.state, ring.key2slot[mid], w).cpu()
    agg = lidal_runner._SvAggregator(cfg, n_sv).make_aggregate("00", 0, Paths(cfg).supervoxel_dir("00", "KMeans"),
                                                                [f"{i:06d}" for i in range(ROUND_FRAMES)], False)
    t0 = time.perf_counter()
    agg(mid, N_PTS, gxyz[mid], scores)
    t_agg = 1e3 * (time.perf_counter() - t0)
    print(f"[12 slice] one fused frame (CUDA events, mean of 3): inference ({cfg.inf_reps} views) {t_infer:.1f} ms, ring "
          f"insert {t_insert:.1f} ms, score_slot {t_slot:.1f} ms of which nn_band {t_band:.3f} ms (its one launch a "
          f"frame) and band bounds + "
          f"accumulation {t_slot - t_band:.1f} ms; host aggregate {t_agg:.1f} ms (host clock)")
    del model, ring, prob
    torch.cuda.empty_cache()
    return launches, res_b, {"staged": t_inf + t_score, "fused": t_fused}


def active_round_phase(cfg, dev):
    """13: run_active_round for r_id = 1: train, evaluate, fused inference +
    scoring; round-2 flags written."""
    from lidal_tpu_torch.runtime.paths import Paths
    from lidal_tpu_torch.runtime.round import run_active_round

    out_dir = Paths(dataclasses.replace(cfg, r_id=2)).sv_flag_dir("00")
    shutil.rmtree(out_dir, ignore_errors=True)  # phase 12's staged round wrote there
    t0 = time.perf_counter()
    out = run_active_round(dataclasses.replace(cfg, r_id=1), 1, evaluate=True, max_iter=ROUND_STEPS, device=dev)
    seconds = time.perf_counter() - t0
    require(0.0 <= out["miou"] <= 1.0, f"mIoU {out['miou']}")
    flags = [np.load(os.path.join(out_dir, f"{i:06d}.npy")) for i in range(ROUND_FRAMES)]
    prev = [np.load(os.path.join(Paths(dataclasses.replace(cfg, r_id=1)).sv_flag_dir("00"), f"{i:06d}.npy"))
            for i in range(ROUND_FRAMES)]
    new_labels = sum(int(((f == 1) & (p != 1)).sum()) for f, p in zip(flags, prev))
    kept = all(bool((f[p == 1] == 1).all()) for f, p in zip(flags, prev))
    require(new_labels > 0 and kept, f"round-2 flags: {new_labels} new labels, earlier labels kept: {kept}")
    print(f"[13 round] run_active_round(r_id=1): {ROUND_STEPS} train steps, eval mIoU {out['miou']:.4f} (random labels), "
          f"fused inference + scoring of {ROUND_FRAMES} frames, {new_labels} supervoxels newly labelled and "
          f"{sum(int((f == 2).sum()) for f in flags)} pseudo-labelled in the round-2 flags; {seconds:.1f} s in all")


def dense_map_inputs(m, rows, c, dev, targets=None):
    """(values f32 [rows, c], nbr int32 [m, 8], w8 f32 [m, 8]) of a map with no
    sentinel: row i's 8 targets lie near ``i * targets // m``, as the corners
    of a point's ancestor voxel lie near it in a sorted voxel table."""
    import torch

    targets = rows if targets is None else targets
    g = torch.Generator().manual_seed(SEED + 9)
    base = torch.arange(m, dtype=torch.int64) * targets // m
    delta = torch.tensor([0, 1, 2, 3, 30, 31, 32, 33])
    nbr = (base[:, None] + delta[None, :]).clamp_max(targets - 1).to(torch.int32)
    values = torch.randn((rows, c), generator=g)
    return values.to(dev), nbr.to(dev), torch.rand((m, 8), generator=g).to(dev)


def allocations(fn) -> int:
    """Device allocations made while ``fn()`` runs (the caching allocator's count)."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    fn()
    torch.cuda.synchronize()
    return torch.cuda.memory_stats()["allocation.all.allocated"] - before


def chain_work(children, counts, cap0, c):
    """(bytes, operations) the child-sum chain needs on these maps: the child
    row of every node reached from the last level (32 bytes each), every point
    under the last level read once in f32, the counts, the output; one add
    per real child per column and one divide per output value."""
    import torch

    reached = torch.ones(counts.shape, dtype=torch.bool, device=counts.device)
    caps = [cap0] + [ch.shape[1] for ch in children]
    node_rows = adds = 0
    for level in reversed(range(len(children))):
        node_rows += int(reached.sum())
        frame, row = reached.nonzero(as_tuple=True)
        ch = children[level][frame, row]  # [nodes, 8]
        real = (ch >= 0) & (ch < caps[level])
        adds += int(real.sum()) * c
        reached = torch.zeros((counts.shape[0], caps[level]), dtype=torch.bool, device=counts.device)
        reached[frame[:, None].expand_as(ch)[real], ch[real]] = True
    points = int(reached.sum())
    nbytes_ = 32.0 * node_rows + 4.0 * points * c + 4.0 * counts.numel() + 4.0 * counts.numel() * c
    return nbytes_, adds + counts.numel() * c, points


def chain_by_levels(x, children, counts, route):
    """The child-sum chain as one ``gather8`` launch a level (weights 1), then
    the divide: the design ``child_sum`` replaces, to compare with."""
    import torch

    from lidal_tpu_torch.ops import cuda_gather8

    b, c = x.shape[0], x.shape[2]
    for child in children:
        nbr = cuda_gather8._flatten_children(child, x.shape[1])
        ones = torch.ones(nbr.shape, dtype=torch.float32, device=x.device)
        x = cuda_gather8.gather8_forward(x.reshape(-1, c), nbr, ones, route).reshape(b, child.shape[1], c)
    return x / counts.clamp_min(1).to(x.dtype)[..., None]


def full_tree_inputs(x_shape, caps, dev):
    """(x, children, counts) of a chain whose every point has an ancestor at
    the last level: level l's rows split evenly over level l + 1's (row f
    under f * cap_{l+1} // cap_l, at most 8 a parent), as frames whose voxels
    fit the caps would give."""
    import torch

    b, cap0, c = x_shape
    g = torch.Generator().manual_seed(SEED + 10)
    children = []
    for cap_f, cap_c in zip((cap0,) + tuple(caps[:-1]), caps):
        f = torch.arange(cap_f)
        parent = f * cap_c // cap_f
        slot = f - torch.searchsorted(parent, parent)
        child = torch.full((cap_c, 8), cap_f, dtype=torch.int32)
        child[parent, slot] = f.to(torch.int32)
        children.append(child[None].expand(b, -1, -1).contiguous().to(dev))
    x = torch.randn(x_shape, generator=g).to(dev)
    return x, children, torch.ones((b, caps[-1]), dtype=torch.int32, device=dev)


def gather_work_phase(model, eb, route=False):
    """14 (f32 route) and 30 (a) (``route``: the bf16 route): every ``gather8``
    and ``child_sum`` call of one SPVCNN B = 4 eval forward against its plain
    version, bit for bit (sign of zero included) and on a rerun; on the route
    neither allocates more than the f32 instance (no bf16 copy).  ms of the
    kernel, the plain version, the library call (``embedding_bag`` for the
    trilinear gathers, ``index_add_`` over the points' ancestors for the
    chains, on the same rounded operands on the route), the bound (f32 rows on
    both routes: the kernels read f32 and round in registers); the chains also
    against the same levels run as one ``gather8`` launch each.  Then the
    trilinear shapes on full maps and the chains on full trees.  Returns the
    record fields of ``gather8`` and of ``child_sum`` (or their bf16 twins)."""
    import torch
    import torch.nn.functional as F

    from lidal_tpu_torch.data.pipeline import forward_batch
    from lidal_tpu_torch.ops import cuda_gather8
    from lidal_tpu_torch.ops.conv import _flatten_idx

    tag = "30a" if route else "14"
    g_calls, c_calls = {}, {}
    kernel, plain = cuda_gather8.gather8_forward, cuda_gather8.gather8_plain
    chain, chain_plain = cuda_gather8.child_sum, cuda_gather8.child_sum_plain

    def g_recorder(feats, nbr, w8, bf16_table=False):
        require(bf16_table == route, f"gather8 asked for bf16_table={bf16_table} on the {'bf16' if route else 'f32'} route")
        key = (nbr.shape[0], feats.shape[0], feats.shape[1])
        n_, args = g_calls.get(key, (0, None))
        g_calls[key] = (n_ + 1, args or (feats.clone(), nbr.clone(), w8.clone()))
        return kernel(feats, nbr, w8, bf16_table)

    def c_recorder(x, children, counts, bf16=False):
        require(bf16 == route, f"child_sum asked for bf16={bf16} on the {'bf16' if route else 'f32'} route")
        key = (len(children), x.shape[1], counts.shape[1], x.shape[2])
        n_, args = c_calls.get(key, (0, None))
        c_calls[key] = (n_ + 1, args or (x.clone(), [ch.clone() for ch in children], counts.clone()))
        return chain(x, children, counts, bf16)

    cuda_gather8.gather8_forward, cuda_gather8.child_sum = g_recorder, c_recorder
    try:
        with torch.inference_mode(), bf16_route() if route else contextlib.nullcontext():
            forward_batch(model, eb)
    finally:
        cuda_gather8.gather8_forward, cuda_gather8.child_sum = kernel, chain
    n_g, n_c = sum(v[0] for v in g_calls.values()), sum(v[0] for v in c_calls.values())
    require((n_g, n_c) == (2, 2), f"{n_g} gather8 and {n_c} child_sum calls in one forward, not 2 and 2")

    rnd = _bf16 if route else (lambda t: t)
    rec = {name: {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": Bound()} for name in ("gather8", "child_sum")}
    with torch.inference_mode():
        for key in sorted(g_calls):
            calls, (feats, nbr, w8) = g_calls[key]
            m, n, c = key
            out = kernel(feats, nbr, w8, route)
            want = plain(feats, nbr, w8, route)
            require(torch.equal(out.view(torch.int32), want.view(torch.int32)) and bool(out.isfinite().all())
                    and torch.equal(kernel(feats, nbr, w8, route), out),
                    f"gather8 {key}: {int((out != want).sum())} values differ from the plain version, or a rerun differs")
            if route:
                require(allocations(lambda: kernel(feats, nbr, w8, True)) == allocations(lambda: kernel(feats, nbr, w8)) == 1,
                        f"gather8 {key}: the route allocated more than its output")
            real = (nbr >= 0) & (nbr < n)
            pairs, rows = int(real.sum()), int(torch.unique(nbr[real]).numel())  # table rows this map reads, in f32
            b_ms = rec["gather8"]["bound"].add(nbytes(nbr, w8, out) + 4.0 * rows * c, 2.0 * pairs * c, calls=calls)
            # the one library call of the same function, on the (rounded) table with the zero row appended
            fx = torch.cat([rnd(feats), feats.new_zeros((1, c))])
            lib = F.embedding_bag(nbr, fx, per_sample_weights=w8, mode="sum", padding_idx=n)
            require(torch.allclose(lib, out, rtol=1e-4, atol=1e-4), f"gather8 {key}: embedding_bag computes another function")
            del want, lib
            ms = {"ms": cuda_ms(lambda: kernel(feats, nbr, w8, route)),
                  "plain": cuda_ms(lambda: plain(feats, nbr, w8, route), reps=3),
                  "lib": cuda_ms(lambda: F.embedding_bag(nbr, fx, per_sample_weights=w8, mode="sum", padding_idx=n),
                                 reps=3)}
            for name in ms:
                rec["gather8"][name] += calls * ms[name]
            print(f"[{tag} gather8] m={m} n={n} c={c} x{calls}{' bf16 table' if route else ''}: bit-equal to the plain "
                  f"version and on a rerun{', allocates its output alone' if route else ''}; kernel {ms['ms']:.3f} ms, "
                  f"plain {ms['plain']:.3f} ms, embedding_bag {ms['lib']:.3f} ms, bound {b_ms:.3f} ms ({pairs} real "
                  f"pairs on {rows} table rows)")
            del out, fx
        avg_of = {2: eb.pplan.avg2, 4: eb.pplan.avg4}
        for key in sorted(c_calls):
            calls, (x, children, counts) = c_calls[key]
            levels, cap0, cap_l, c = key
            b = x.shape[0]
            out = chain(x, children, counts, route)
            want = chain_plain(x, children, counts, route)
            require(torch.equal(out.view(torch.int32), want.view(torch.int32)) and bool(out.isfinite().all())
                    and torch.equal(chain(x, children, counts, route).view(torch.int32), out.view(torch.int32)),
                    f"child_sum {key}: {int((out != want).sum())} values differ from the plain version, or a rerun differs")
            if route:
                require(allocations(lambda: chain(x, children, counts, True)) == allocations(lambda: chain(x, children, counts))
                        == 1, f"child_sum {key}: the route allocated more than its output")
            require(torch.equal(chain_by_levels(x, children, counts, route).view(torch.int32), out.view(torch.int32)),
                    f"child_sum {key}: differs from its levels run as gather8 launches")
            work, ops, points = chain_work(children, counts, cap0, c)
            b_ms = rec["child_sum"]["bound"].add(work, ops, calls=calls)
            # the library call: the points' sums into their ancestors at the last level, index_add_
            anc = _flatten_idx(avg_of[levels].anc, cap_l).long().reshape(-1)
            xr = rnd(x).reshape(-1, c)
            sums = torch.zeros((b * cap_l + 1, c), device=x.device)

            def lib_call():
                return sums.zero_().index_add_(0, anc, xr)

            lib = lib_call()[:-1].reshape(b, cap_l, c) / counts.clamp_min(1)[..., None]
            abs_lib = torch.zeros_like(sums).index_add_(0, anc, xr.abs())[:-1].reshape(b, cap_l, c) / counts.clamp_min(1)[..., None]
            require(bool(((lib - out).abs() <= (2.0**-6 if route else 1e-5) * abs_lib + 1e-30).all()),
                    f"child_sum {key}: index_add_ computes another function")
            del want, lib, abs_lib
            ms = {"ms": cuda_ms(lambda: chain(x, children, counts, route)),
                  "plain": cuda_ms(lambda: chain_plain(x, children, counts, route), reps=3),
                  "lib": cuda_ms(lib_call, reps=3)}
            levels_ms = cuda_ms(lambda: chain_by_levels(x, children, counts, route))
            for name in ms:
                rec["child_sum"][name] += calls * ms[name]
            print(f"[{tag} child_sum] {levels} levels {cap0} -> {cap_l} rows a frame x{b}, c={c}"
                  f"{' bf16 levels' if route else ''}: bit-equal to the plain chain and on a rerun"
                  f"{', allocates its output alone' if route else ''}; kernel {ms['ms']:.3f} ms, the levels as "
                  f"{levels} gather8 launches {levels_ms:.3f} ms, plain {ms['plain']:.3f} ms, index_add_ "
                  f"{ms['lib']:.3f} ms, bound {b_ms:.3f} ms ({points} points under the last level)")
            del out, sums
        # edge cases: a map of sentinels only; targets in no order, twice in a row, out of range;
        # a row of sentinels whose weight is inf (its sum is NaN, not +0)
        dev = eb.feats.device
        g = torch.Generator().manual_seed(SEED + 8)
        feats = torch.randn((3000, 256), generator=g).to(dev)
        nbr = torch.randint(0, 3000, (20000, 8), generator=g, dtype=torch.int32)
        nbr[torch.rand((20000, 8), generator=g) > 0.8] = 3000
        nbr[::7, 3] = nbr[::7, 1]
        nbr[5::11] = 3000
        nbr[2, 0], nbr[3, 1] = -1, 3005
        nbr[17] = 3000
        w8 = torch.randn((20000, 8), generator=g)
        w8[17, 3] = float("inf")
        nbr, w8 = nbr.to(dev), w8.to(dev)
        out, want = kernel(feats, nbr, w8, route), plain(feats, nbr, w8, route)
        fin = want.isfinite()
        require(torch.equal(fin, out.isfinite()) and torch.equal(out[fin], want[fin]) and not bool(out[5::11].any())
                and bool(out[17].isnan().all()), "gather8 on an unsorted map")
        sent = torch.full_like(nbr, 3000)
        out = kernel(feats, sent, w8.nan_to_num(posinf=1.0), route)
        require(not bool(out.any()) and torch.equal(out, plain(feats, sent, w8.nan_to_num(posinf=1.0), route)),
                "gather8 on an all-sentinel map")
        # The synthetic frames overflow the coarse caps, so few points keep a level-4 or level-2
        # ancestor: the trilinear maps above are mostly sentinels and the chains' trees sparse.
        # The same shapes with full maps and full trees, as frames that fit would give:
        for (m, n, c) in sorted(g_calls):
            feats, nbr, w8 = dense_map_inputs(m, n, c, eb.feats.device)
            out = kernel(feats, nbr, w8, route)
            require(torch.equal(out, plain(feats, nbr, w8, route)), f"gather8 on a full map {m, n, c}")
            k_ms = cuda_ms(lambda: kernel(feats, nbr, w8, route))
            b_ms = 1e3 * nbytes(feats, nbr, w8, out) / PEAK_BYTES
            print(f"[{tag} gather8] full map m={m} n={n} c={c} ({8 * m // n} pairs per table row): bit-equal; kernel "
                  f"{k_ms:.3f} ms, bound {b_ms:.3f} ms")
            del feats, nbr, w8, out
        for key in sorted(c_calls):
            _, (x, children, counts) = c_calls[key]
            x, children, counts = full_tree_inputs(tuple(x.shape), [ch.shape[1] for ch in children], x.device)
            out = chain(x, children, counts, route)
            require(torch.equal(out.view(torch.int32), chain_plain(x, children, counts, route).view(torch.int32)),
                    f"child_sum on a full tree {key}")
            b = x.shape[0]
            k_ms = cuda_ms(lambda: chain(x, children, counts, route))
            l_ms = cuda_ms(lambda: chain_by_levels(x, children, counts, route))
            work, _, points = chain_work(children, counts, x.shape[1], x.shape[2])
            print(f"[{tag} child_sum] full tree {key[0]} levels {key[1]} -> {key[2]} rows a frame x{b}, c={key[3]} "
                  f"({points} points under the last level): bit-equal; kernel {k_ms:.3f} ms, the levels as "
                  f"gather8 launches {l_ms:.3f} ms, bound {1e3 * work / PEAK_BYTES:.3f} ms")
            del x, children, counts, out
    g, ch = rec["gather8"], rec["child_sum"]
    print(f"[{tag} gather8] per forward{' on the bf16 route' if route else ''}: gather8 x2 {g['ms']:.3f} ms + "
          f"child_sum x2 {ch['ms']:.3f} ms = {g['ms'] + ch['ms']:.3f} ms (no cast: the wrapper is the kernel), bound "
          f"{g['bound'].total:.3f} + {ch['bound'].total:.3f} ms; plain {g['plain'] + ch['plain']:.1f} ms; library "
          f"{g['lib'] + ch['lib']:.3f} ms; all bit-equal to the plain versions")
    return tuple({"max_abs_err": 0.0, "ms": r["ms"], "plain_ms": r["plain"], "bound_ms": r["bound"].total,
                  "bound_by": r["bound"].by, "library_ms": r["lib"]} for r in (g, ch))


def scatter8_phase(state, tb):
    """15: both scatter8 calls of one SPVCNN train step against the plain
    version.  Returns the kernel's record fields."""
    import torch
    import torch.nn.functional as F

    from lidal_tpu_torch.ops import cuda_gather8
    from lidal_tpu_torch.runtime.train import train_step

    captured = {}
    kernel, plain = cuda_gather8.scatter8, cuda_gather8.scatter8_plain

    def recorder(dy, nbr, w8, n, bf16=False):
        require(not bf16, "scatter8 on the f32 route asked for bf16 rows")
        captured[(dy.shape[0], n, dy.shape[1])] = (dy.clone(), nbr.clone(), w8.clone(), n)
        return kernel(dy, nbr, w8, n)

    cuda_gather8.scatter8 = recorder
    try:
        train_step(state, tb, DROPOUT_SEEDS[: len(tb.feats)])
    finally:
        cuda_gather8.scatter8 = kernel
    require(len(captured) == 2, f"{len(captured)} scatter8 shapes in one train step, not 2")

    err = k_total = t_total = p_total = lib_total = 0.0
    least = Bound()
    for key in sorted(captured):
        dy, nbr, w8, n = args = captured[key]
        m, _, c = key
        got = kernel(*args)
        require(torch.equal(got, kernel(*args)), f"scatter8 {key}: two runs differ")
        want = plain(*args)
        abs_sum = plain(dy.abs(), nbr, w8.abs(), n)
        d = (got - want).abs()
        require(bool(got.isfinite().all()) and bool((d <= SCATTER_TOL * abs_sum).all()),
                f"scatter8 {key}: max |kernel - plain| {float(d.max())}")
        ref = plain(dy.double(), nbr, w8.double(), n)
        e_k, e_p = float((got.double() - ref).abs().max()), float((want.double() - ref).abs().max())
        require(e_k <= F64_FACTOR * e_p + 1e-6 * float(abs_sum.max()),
                f"scatter8 {key}: {e_k:.2e} from f64 against the plain version's {e_p:.2e}")
        e = float(d.max())
        err = max(err, e)
        real = (nbr >= 0) & (nbr < n)
        pairs = int(real.sum())
        rows = int(real.any(dim=1).sum())  # dy rows with a real tap: what this map reads
        order, offsets = cuda_gather8.transpose_map(nbr, n)
        want_order, want_offsets = cuda_gather8.build_transpose(nbr, n)
        require(torch.equal(offsets, want_offsets) and torch.equal(order[:pairs], want_order[:pairs]),
                f"scatter8 {key}: the device-built map differs from build_transpose")
        fan = torch.diff(offsets)
        b_ms = least.add(nbytes(nbr, w8, got) + 4.0 * rows * c, 2.0 * pairs * c)
        del ref, abs_sum, want, d, order, want_order
        k_ms = cuda_ms(lambda: kernel(*args))
        t_ms = cuda_ms(lambda: cuda_gather8.transpose_map(nbr, n))
        s_ms = cuda_ms(lambda: cuda_gather8.build_transpose(nbr, n))
        p_ms = cuda_ms(lambda: plain(*args), reps=3)
        # the library call of the same function: the backward of embedding_bag (atomics)
        fx = torch.zeros((n + 1, c), device=dy.device, requires_grad=True)
        bag = F.embedding_bag(nbr, fx, per_sample_weights=w8, mode="sum", padding_idx=n)
        lib = torch.autograd.grad(bag, fx, dy, retain_graph=True)[0][:n]
        require(torch.allclose(lib, got, rtol=1e-3, atol=1e-3 * float(got.abs().max())),
                f"scatter8 {key}: the backward of embedding_bag computes another function")
        lib_ms = cuda_ms(lambda: torch.autograd.grad(bag, fx, dy, retain_graph=True), reps=3)
        del bag, fx, lib
        k_total += k_ms
        t_total += t_ms
        p_total += p_ms
        lib_total += lib_ms
        print(f"[15 scatter8] m={m} n={n} c={c}: max|d|={e:.2e} (tol {SCATTER_TOL} of sum |w8||dy|), from f64 {e_k:.1e} "
              f"(plain {e_p:.1e}), bit-equal across runs, device map == build_transpose; kernel {k_ms:.3f} ms: the "
              f"transposed map {t_ms:.3f} ms (torch.sort + searchsorted {s_ms:.3f}), the sum {k_ms - t_ms:.3f} ms "
              f"(difference); plain {p_ms:.3f} ms, embedding_bag backward {lib_ms:.3f} ms, bound {b_ms:.3f} ms; "
              f"{pairs} real pairs from {rows} rows, per target mean {float(fan.float().mean()):.0f}, max {int(fan.max())}")
    # as in phase 14: the same shapes with a full map (a level-4 voxel then collects 512 pairs)
    for (m, n, c) in sorted(captured):
        dy, nbr, w8 = dense_map_inputs(m, m, c, state.model.classifier[0].weight.device, targets=n)
        got = kernel(dy, nbr, w8, n)
        require(torch.equal(got, kernel(dy, nbr, w8, n)), f"scatter8 on a full map {m, n, c}: two runs differ")
        want, abs_sum = plain(dy, nbr, w8, n), plain(dy.abs(), nbr, w8.abs(), n)
        require(bool(((got - want).abs() <= SCATTER_TOL * abs_sum).all()), f"scatter8 on a full map {m, n, c}")
        del want, abs_sum
        order, offsets = cuda_gather8.transpose_map(nbr, n)
        want_order, want_offsets = cuda_gather8.build_transpose(nbr, n)
        require(torch.equal(offsets, want_offsets) and torch.equal(order, want_order),
                f"scatter8 on a full map {m, n, c}: the device-built map differs from build_transpose")
        del order, want_order
        k_ms = cuda_ms(lambda: kernel(dy, nbr, w8, n))
        t_ms = cuda_ms(lambda: cuda_gather8.transpose_map(nbr, n))
        s_ms = cuda_ms(lambda: cuda_gather8.build_transpose(nbr, n))
        b_ms = 1e3 * nbytes(dy, nbr, w8, got) / PEAK_BYTES
        print(f"[15 scatter8] full map m={m} n={n} c={c} ({8 * m // n} pairs per target): within tolerance, bit-equal "
              f"across runs, device map == build_transpose; kernel {k_ms:.3f} ms: the transposed map {t_ms:.3f} ms "
              f"(torch.sort + searchsorted {s_ms:.3f}), the sum {k_ms - t_ms:.3f} ms (difference); bound {b_ms:.3f} ms")
        del dy, nbr, w8, got
    print(f"[15 scatter8] 2 calls per train step: kernel {k_total:.3f} ms (the transposed maps {t_total:.3f} ms, the sums "
          f"{k_total - t_total:.3f} ms), plain {p_total:.2f} ms, embedding_bag "
          f"backward {lib_total:.2f} ms, bound {least.total:.3f} ms (by {least.by})")
    return {"max_abs_err": err, "ms": k_total, "plain_ms": p_total, "bound_ms": least.total, "bound_by": least.by,
            "library_ms": lib_total}


def eval_slice_phase(cfg, model, batches, prepare, dev, caps, slice_tag, forward_tag, b=B, n_pts=N_PTS, warm_up=None):
    """5 and 6 (MinkUNet), 16 (SPVCNN), 25 (nuScenes): run_eval over the timed
    batches (each of ``b`` frames of ``n_pts`` points) after a warm-up (by
    default run_eval over the first batch; ``warm_up()`` where given), where
    one batch's time goes, and the whole forward on the kernel path against
    the plain path.  Returns (each kernel's launches in the timed run, its
    confusion matrix)."""
    import torch

    from lidal_tpu_torch.data.pipeline import forward_batch
    from lidal_tpu_torch.ops import cuda_conv, cuda_gather8, cuda_merge
    from lidal_tpu_torch.runtime.evaluate import run_eval

    spvcnn = cfg.is_spvcnn
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    if warm_up is None:
        run_eval(cfg, model, batches[:1], dev, gen)
    else:
        warm_up()
    torch.cuda.synchronize()
    reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res = run_eval(cfg, model, batches[1:], dev, gen)
    end.record()
    torch.cuda.synchronize()
    launches = read_launches(("lookup_sorted", "subm_conv") + (("gather8", "child_sum") if spvcnn else ()))
    seconds = start.elapsed_time(end) / 1e3
    require(launches["gather8"] == launches["child_sum"] == (2 * TIMED_BATCHES if spvcnn else 0)
            and launches["scatter8"] == 0,
            f"gather8 and child_sum launched {launches['gather8']} and {launches['child_sum']} times in "
            f"{TIMED_BATCHES} batches")
    require(res.points == TIMED_BATCHES * b * n_pts, f"points evaluated {res.points}")
    require(0.0 <= res.miou <= 1.0 and int(res.confusion.sum()) > 0, f"mIoU {res.miou}")
    print(f"[{slice_tag}] run_eval ({cfg.dataset_name} {cfg.model_name}): {TIMED_BATCHES} batches x {b} frames x {n_pts} points in "
          f"{seconds:.3f} s = {res.points / seconds:,.0f} points/s; overflow per level {res.overflow.tolist()}; "
          f"mIoU {res.miou:.4f} (random weights); launches {launches}")

    # where one batch's time goes (CUDA events around each stage)
    eb = prepare(batches[1], SEED, spvcnn)
    with torch.inference_mode():
        t_prep = cuda_ms(lambda: prepare(batches[1], SEED, spvcnn), reps=3)
        t_fwd = cuda_ms(lambda: forward_batch(model, eb), reps=3)
        logits, feats = forward_batch(model, eb)
    print(f"[{slice_tag}] one batch: prepare (augment+voxelize+plan{'+point plan' if spvcnn else ''}) {t_prep:.1f} ms, "
          f"forward {t_fwd:.1f} ms")

    # whole forward: kernel path vs plain path
    kernels = cuda_merge.lookup_sorted, cuda_conv.subm_conv, cuda_gather8.gather8_forward, cuda_gather8.child_sum
    cuda_merge.lookup_sorted = cuda_merge.lookup_sorted_plain
    cuda_conv.subm_conv = cuda_conv.subm_conv_plain
    cuda_gather8.gather8_forward = cuda_gather8.gather8_plain
    cuda_gather8.child_sum = cuda_gather8.child_sum_plain
    try:
        eb_p = prepare(batches[1], SEED, spvcnn)
        with torch.inference_mode():
            logits_p, _ = forward_batch(model, eb_p)
    finally:
        cuda_merge.lookup_sorted, cuda_conv.subm_conv, cuda_gather8.gather8_forward, cuda_gather8.child_sum = kernels
    for lk, lp in zip(eb.plan.levels, eb_p.plan.levels):
        require(torch.equal(lk.nbr3, lp.nbr3), "rulebooks of the kernel and plain paths differ")
    if spvcnn:
        for kmap, pmap in zip(eb.pplan, eb_p.pplan):
            require(all(torch.equal(x, y) for x, y in zip(kmap, pmap)), "point plans of the kernel and plain paths differ")
    require(logits.shape == (b, caps[0], cfg.data.num_classes) and feats.shape == (b, caps[0], 96), "shapes")
    require(bool(torch.isfinite(logits).all()), "non-finite logits")
    valid0 = eb.plan.levels[0].valid
    require(not bool(logits[~valid0].any()), "logits on invalid rows")
    logit_err = float((logits - logits_p).abs().max())
    require(torch.allclose(logits, logits_p, atol=LOGIT_TOL, rtol=LOGIT_TOL), f"logits differ by {logit_err}")
    agree = float((logits.argmax(-1) == logits_p.argmax(-1))[valid0].float().mean())
    require(agree >= ARGMAX_AGREE, f"argmax agreement {agree}")
    print(f"[{forward_tag}] kernel vs plain path: max|d logits| {logit_err:.2e} (tol {LOGIT_TOL}), argmax agreement "
          f"{agree:.6f} over {int(valid0.sum())} valid voxels; logits std {float(logits[valid0].std()):.3f}")
    return launches, res.confusion


def spvcnn_round_phase(cfg_mink, dev, n_sv):
    """18: run_fused_lidal_round with SPVCNN on the round tree.  Returns (each
    kernel's launches in it, its selection, its seconds)."""
    from lidal_tpu_torch.active import lidal_runner
    from lidal_tpu_torch.data import semantic_kitti as sk
    from lidal_tpu_torch.runtime.paths import Paths
    from lidal_tpu_torch.runtime.train_loop import init_state

    cfg = dataclasses.replace(cfg_mink, model_name="SPVCNN")
    # flags are kept per model: SPVCNN's round starts from the same round-1 labels
    shutil.copytree(Paths(cfg_mink).sv_flag_dir("00", r_id=1), Paths(cfg).sv_flag_dir("00", r_id=1))
    model = init_state(cfg, dev).model.eval()
    randomise_bn(model, SEED + 7)
    files = sk.list_frames(cfg.data_root, cfg.data.train_split)
    frame_index = {sk.frame_id(p): i for i, p in enumerate(files)}
    by_id = {sk.frame_id(p): p for p in files}
    reset_launches()
    t0 = time.perf_counter()
    res = lidal_runner.run_fused_lidal_round(
        cfg, model, lambda seq, name: sk.read_frame(by_id[(seq, name)], with_labels=False)[:2],
        frame_index=frame_index, device=dev,
    )
    seconds = time.perf_counter() - t0
    launches = read_launches(("lookup_sorted", "subm_conv", "nn_band", "gather8", "child_sum"))
    require(launches["nn_band"] == ROUND_FRAMES, f"nn_band launched {launches['nn_band']} times for {ROUND_FRAMES} frames")
    prev = Paths(lidal_runner._prev_cfg(cfg))
    worst_sum = 0.0
    for i in range(ROUND_FRAMES):
        prob = np.load(os.path.join(prev.prob_dir("00"), f"{i:06d}.npy"))
        require(prob.shape == (N_PTS, cfg.data.num_classes) and bool(np.isfinite(prob).all()), f"prob of frame {i}")
        worst_sum = max(worst_sum, float(np.abs(prob.sum(1) - 1.0).max()))
        pred = np.load(os.path.join(prev.pred_dir("00"), f"{i:06d}.npy"))
        require(np.array_equal(pred, prob.argmax(1)), f"pred of frame {i}")
        flags = np.load(os.path.join(Paths(cfg).sv_flag_dir("00"), f"{i:06d}.npy"))
        require(bool(np.isin(flags, (0, 1, 2)).all()), f"sv_flag of frame {i}")
    require(worst_sum <= PROB_SUM_TOL, f"prob rows sum to 1 within {worst_sum}")
    require(len(res.sv_flags) == n_sv and len(res.al_added) > 0, "no supervoxel was selected")
    print(f"[18 round] run_fused_lidal_round (SPVCNN): {ROUND_FRAMES} frames x {cfg.inf_reps} views in {seconds:.2f} s = "
          f"{ROUND_FRAMES / seconds:.3f} frames/s; prob rows sum to 1 within {worst_sum:.1e}; selected "
          f"{len(res.al_added)} supervoxels for labels and {len(res.sl_added)} for pseudo labels; launches {launches}")
    return launches, res, seconds


def bf16_rows_bytes(nbr, n, row_bytes):
    """(real (row, tap) pairs, bytes of the table rows the map names)."""
    import torch

    real = (nbr >= 0) & (nbr < n)
    return int(real.sum()), int(torch.unique(nbr[real]).numel()) * row_bytes


def gather_first_phase(real_convs, dev):
    """19: conv_gather_first, both ``pipelined`` values, against its plain
    version at the probe's six shapes and on three real maps of the forward.
    Returns the kernel's record fields (summed over the probe's shapes)."""
    import torch

    from lidal_tpu_torch.ops import cuda_conv, cuda_conv_bf16 as cb
    from lidal_tpu_torch.tools import probe_conv_v3

    rng = np.random.default_rng(0)  # the probe's generator: the same maps and data, in its order of draws
    cases = []
    for n, cin, cout, label in probe_conv_v3.SHAPES:
        nbr = torch.from_numpy(probe_conv_v3.make_nbr(rng, n, 27, max(300, n // 40))).to(dev)
        feats = torch.from_numpy(rng.standard_normal((n, cin)).astype(np.float32)).to(dev)
        w = torch.from_numpy((rng.standard_normal((27, cin, cout)) * 0.05).astype(np.float32)).to(dev)
        cases.append((f"probe {label}", feats, w, nbr, True))
    cases += [(label, *args, False) for label, args in real_convs.items()]

    err = 0.0
    total = {"ms": 0.0, "piped": 0.0, "packed": 0.0, "plain_ms": 0.0, "f32": 0.0}
    least = Bound()
    with torch.inference_mode():
        for label, feats, w, nbr, of_probe in cases:
            (n, cin), (m, k), cout = feats.shape, nbr.shape, w.shape[2]
            got = cb.conv_gather_first(feats, w, nbr)
            piped = cb.conv_gather_first(feats, w, nbr, pipelined=True)
            want = cb.conv_gather_first_plain(feats, w, nbr)
            abs_sum = cb.conv_gather_first_plain(feats.abs(), w.abs(), nbr)
            d = (got - want).abs()
            require(bool(got.isfinite().all()) and bool((d <= PROBE_TOL * abs_sum).all()),
                    f"conv_gather_first {label}: max |kernel - plain| {float(d.max())}")
            require(torch.equal(piped, got), f"conv_gather_first {label}: pipelined differs from unpipelined")
            require(torch.equal(cb.conv_gather_first(feats, w, nbr), got) and
                    torch.equal(cb.conv_gather_first(feats, w, nbr, pipelined=True), got),
                    f"conv_gather_first {label}: two runs differ")
            e, share = float(d.max()), float((d / abs_sum.clamp_min(1e-30)).max())
            del want, abs_sum, d, piped
            table, wt = cb.pack_table(feats), cb.pack_weights(w)
            pairs, row_bytes = bf16_rows_bytes(nbr, n, 2 * table.shape[1])
            real, issued = 2.0 * pairs * cin * cout, 2.0 * cb.tile_products(nbr, n, table.shape[1], cout)
            b = (least if of_probe else Bound()).add(row_bytes + nbytes(wt, nbr, got), real, PEAK_BF16)
            ms = {
                "ms": cuda_ms(lambda: cb.conv_gather_first(feats, w, nbr)),
                "piped": cuda_ms(lambda: cb.conv_gather_first(feats, w, nbr, pipelined=True)),
                "packed": cuda_ms(lambda: cb.gather_first_packed(table, wt, nbr)),
                "packed_piped": cuda_ms(lambda: cb.gather_first_packed(table, wt, nbr, pipelined=True)),
                "plain_ms": cuda_ms(lambda: cb.conv_gather_first_plain(feats, w, nbr), reps=3),
                "f32": cuda_ms(lambda: cuda_conv.subm_conv(feats, w, nbr)),
            }
            if of_probe:
                err = max(err, e)
                for key in total:
                    total[key] += ms[key]
            print(f"[19 gather-first] {label}: K={k} cin={cin} cout={cout} m={m} n={n}: max|d|={e:.2e} = {share:.1e} of the "
                  f"abs-sum (tol {PROBE_TOL}), pipelined bit-equal, bit-equal across runs; wrapper {ms['ms']:.3f} ms, "
                  f"pipelined {ms['piped']:.3f} ms, kernel alone {ms['packed']:.3f} / {ms['packed_piped']:.3f} ms, plain "
                  f"{ms['plain_ms']:.3f} ms, f32 subm_conv kernel {ms['f32']:.3f} ms, bound {b:.3f} ms ({pairs} real pairs); "
                  f"kernel alone {real / ms['packed'] / 1e9:.1f} TFLOP/s on the real pairs, {issued / ms['packed'] / 1e9:.1f} on "
                  f"the products issued, issue/real {issued / max(real, 1.0):.2f}")
            del got, table, wt
    print(f"[19 gather-first] the probe's {len(probe_conv_v3.SHAPES)} shapes in all: wrapper {total['ms']:.2f} ms, pipelined "
          f"{total['piped']:.2f} ms, kernel alone {total['packed']:.2f} ms, plain {total['plain_ms']:.2f} ms, f32 subm_conv "
          f"kernel {total['f32']:.2f} ms, bound {least.total:.3f} ms (by {least.by})")
    return {"max_abs_err": err, "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": least.total,
            "bound_by": least.by, "library_ms": None}


def byte_planes_phase(dev):
    """20: conv_byte_planes bit-equal to conv_gather_first at the probe's two
    shapes and on edge maps.  Returns the kernel's record fields."""
    import torch

    from lidal_tpu_torch.ops import cuda_conv_bf16 as cb
    from lidal_tpu_torch.tools import probe_int8_gather

    rng = np.random.default_rng(0)  # the probe's generator and order of draws
    n = probe_int8_gather.N
    err = k_total = ref_total = p_total = 0.0
    least = Bound()
    with torch.inference_mode():
        for cin, cout in probe_int8_gather.SHAPES:
            feats = torch.from_numpy(rng.standard_normal((n, cin)).astype(np.float32)).to(dev)
            w = torch.from_numpy((0.1 * rng.standard_normal((27, cin, cout))).astype(np.float32)).to(dev)
            nbr = torch.from_numpy(probe_int8_gather.make_nbr(rng, n, 27, max(300, n // 40))).to(dev)
            planes, table, wt = cb.to_byte_planes(feats), cb.pack_table(feats), cb.pack_weights(w)
            require(torch.equal(cb.from_byte_planes(planes), table), "byte planes do not rebuild the bf16 table")
            ref = cb.conv_gather_first(feats, w, nbr)
            got = cb.conv_byte_planes(planes, w, nbr)
            require(torch.equal(got, ref) and bool(got.isfinite().all()),
                    f"conv_byte_planes c{cin}->{cout}: {int((got != ref).sum())} values differ from conv_gather_first")
            want = cb.conv_byte_planes_plain(planes, w, nbr)
            abs_sum = cb.conv_gather_first_plain(feats.abs(), w.abs(), nbr)
            d = (got - want).abs()
            require(bool((d <= PROBE_TOL * abs_sum).all()), f"conv_byte_planes c{cin}->{cout}: max |kernel - plain| {float(d.max())}")
            err = max(err, float(d.max()))
            unsorted = nbr[torch.randperm(n, generator=torch.Generator().manual_seed(SEED)).to(dev)].contiguous()
            unsorted[2, 0], unsorted[3, 1] = -1, n + 5
            require(torch.equal(cb.conv_byte_planes(planes, w, unsorted), cb.conv_gather_first(feats, w, unsorted)),
                    "conv_byte_planes on an unsorted map with out-of-range indices")
            sentinel = torch.full_like(nbr, n)
            zero = cb.conv_byte_planes(planes, w, sentinel)
            require(not bool(zero.any()) and torch.equal(zero, cb.conv_gather_first(feats, w, sentinel)),
                    "conv_byte_planes on an all-sentinel map")
            pairs, row_bytes = bf16_rows_bytes(nbr, n, planes.shape[1])
            b = least.add(row_bytes + nbytes(wt, nbr, got), 2.0 * pairs * cin * cout, PEAK_BF16)
            del want, abs_sum, d, zero, unsorted, sentinel
            k_ms = cuda_ms(lambda: cb.byte_planes_packed(planes, wt, nbr))
            r_ms = cuda_ms(lambda: cb.gather_first_packed(table, wt, nbr))
            p_ms = cuda_ms(lambda: cb.conv_byte_planes_plain(planes, w, nbr), reps=3)
            k_total, ref_total, p_total = k_total + k_ms, ref_total + r_ms, p_total + p_ms
            print(f"[20 byte planes] c{cin}->{cout} n={n} K=27: bit-equal to conv_gather_first (also on an unsorted map with "
                  f"out-of-range indices and on an all-sentinel map); on packed operands: byte planes {k_ms:.3f} ms, bf16 "
                  f"table {r_ms:.3f} ms; plain {p_ms:.3f} ms, bound {b:.3f} ms ({pairs} real pairs)")
    print(f"[20 byte planes] both shapes: byte planes {k_total:.2f} ms, bf16 table {ref_total:.2f} ms, plain {p_total:.2f} ms, "
          f"bound {least.total:.3f} ms (by {least.by})")
    return {"max_abs_err": err, "ms": k_total, "plain_ms": p_total, "bound_ms": least.total, "bound_by": least.by,
            "library_ms": None}


def fused_backward_phase(captured, calls, f32_ms, dev):
    """21: conv_dx_dw_fused in its three modes at the probe's shapes and at
    every shape of one train step.  Returns the kernel's record fields (mode
    ``dx_dw``, summed over the probe's shapes)."""
    import torch

    from lidal_tpu_torch.ops import cuda_conv_bf16 as cb, cuda_conv_dxdw, cuda_conv_dxdw_fused as fz
    from lidal_tpu_torch.tools import probe_dxdw_features as probe

    rng = np.random.default_rng(0)  # the probe's generator and order of draws
    cases = [("probe", probe.probe_inputs(rng), 1, None)]
    cases += [(f"probe {label}", probe.step_inputs(rng, *shape), 1, None) for label, *shape in probe.STEP_SHAPES]
    cases = [(label, tuple(torch.from_numpy(a).to(dev) for a in arrays), c, t) for label, arrays, c, t in cases]
    cases += [(f"step K={key[0]}", captured[key][:4], calls[key], f32_ms[key]) for key in sorted(captured)]

    err = 0.0
    probe_total = {mode: 0.0 for mode in fz.MODES} | {"plain": 0.0}
    step_total = {mode: 0.0 for mode in fz.MODES} | {"f32": 0.0}
    least, step_least = Bound(), Bound()
    for label, (src, w2, nbr, f), n_calls, t_f32 in cases:
        of_probe = label.startswith("probe")
        (n, c_src), (m, k), c_dst, c_f = src.shape, nbr.shape, w2.shape[2], f.shape[1]
        dx, dw = fz.conv_dx_dw_fused(src, w2, nbr, f, "dx_dw")
        dx_a, none = fz.conv_dx_dw_fused(src, w2, nbr, f, "dx")
        dx_b, zeros = fz.conv_dx_dw_fused(src, w2, nbr, f, "dx_zero_dw")
        require(none is None and torch.equal(dx_a, dx) and torch.equal(dx_b, dx), f"conv_dx_dw_fused {label}: dx differs between modes")
        require(zeros.shape == dw.shape and not bool(zeros.any()), f"conv_dx_dw_fused {label}: dx_zero_dw must give zeros")
        del dx_a, dx_b, zeros
        dx2, dw2 = fz.conv_dx_dw_fused(src, w2, nbr, f, "dx_dw")
        require(torch.equal(dw, dw2) and torch.equal(dx, dx2), f"conv_dx_dw_fused {label}: two runs differ")
        del dx2, dw2
        want = fz.conv_dx_dw_fused_plain(src, w2, nbr, f)
        bound = fz.conv_dx_dw_fused_plain(src.abs(), w2.abs(), nbr, f.abs())
        ref = cuda_conv_dxdw.conv_dx_dw_plain(src.bfloat16().double(), w2.bfloat16().double(), nbr, f.bfloat16().double())
        e, notes = 0.0, []
        for name, got, p, r, b in zip(("dx", "dw"), (dx, dw), want, ref, bound):
            d = (got - p).abs()
            require(bool(got.isfinite().all()) and bool((d <= PROBE_TOL * b).all()),
                    f"conv_dx_dw_fused {label}: {name} max |kernel - plain| {float(d.max())}")
            e_k, e_p = float((got.double() - r).abs().max()), float((p.double() - r).abs().max())
            require(e_k <= F64_FACTOR * e_p + 1e-6 * float(b.max()),
                    f"conv_dx_dw_fused {label}: {name} {e_k:.2e} from f64 against the plain version's {e_p:.2e}")
            e = max(e, float(d.max()))
            notes.append(f"{name} from f64 {e_k:.1e} (plain {e_p:.1e})")
        del want, bound, ref
        pairs, row_bytes = bf16_rows_bytes(nbr, n, 2 * c_src)
        real = 2.0 * pairs * c_src * (c_dst + c_f)
        c_s, c_d, c_ff = fz.padded_channels(c_src, c_dst, c_f)
        issued = 2.0 * (cb.tile_products(nbr, n, c_s, c_d) + pairs * c_s * c_ff)  # dx's tile, dw's pair lists
        b_ms = (least if of_probe else step_least).add(
            row_bytes + nbytes(nbr, dx, dw) + 2 * (w2.numel() + f.numel()), real, PEAK_BF16, calls=n_calls)
        del dx, dw
        ms = {mode: cuda_ms(lambda: fz.conv_dx_dw_fused(src, w2, nbr, f, mode), reps=3) for mode in fz.MODES}
        if of_probe:
            err = max(err, e)
            p_ms = cuda_ms(lambda: fz.conv_dx_dw_fused_plain(src, w2, nbr, f), reps=2)
            for mode in fz.MODES:
                probe_total[mode] += ms[mode]
            probe_total["plain"] += p_ms
            beside = f"plain {p_ms:.3f} ms"
        else:
            for mode in fz.MODES:
                step_total[mode] += n_calls * ms[mode]
            step_total["f32"] += n_calls * t_f32
            beside = f"f32 conv_dx_dw kernel {t_f32:.3f} ms"
        print(f"[21 fused backward] {label}: c_src={c_src} c_dst={c_dst} c_f={c_f} m={m} n={n} x{n_calls}: max|d|={e:.2e} (tol "
              f"{PROBE_TOL} of the abs-sum), {', '.join(notes)}, modes agree on dx, dx_zero_dw gives zeros, bit-equal across "
              f"runs; dx {ms['dx']:.3f} ms, dx_zero_dw {ms['dx_zero_dw']:.3f} ms, dx_dw {ms['dx_dw']:.3f} ms, {beside}, bound "
              f"{b_ms:.3f} ms ({pairs} real pairs); dx_dw {real / ms['dx_dw'] / 1e9:.1f} TFLOP/s on the real pairs, "
              f"{issued / ms['dx_dw'] / 1e9:.1f} on the products issued, issue/real {issued / max(real, 1.0):.2f}")
    print(f"[21 fused backward] the probe's {1 + len(probe.STEP_SHAPES)} shapes in all: dx {probe_total['dx']:.2f} ms, dx_zero_dw "
          f"{probe_total['dx_zero_dw']:.2f} ms, dx_dw {probe_total['dx_dw']:.2f} ms, plain {probe_total['plain']:.2f} ms, bound "
          f"{least.total:.3f} ms (by {least.by})")
    print(f"[21 fused backward] {len(captured)} shapes, {sum(calls.values())} calls per train step; per step: dx "
          f"{step_total['dx']:.1f} ms, dx_zero_dw {step_total['dx_zero_dw']:.1f} ms, dx_dw {step_total['dx_dw']:.1f} ms, f32 "
          f"conv_dx_dw kernel {step_total['f32']:.1f} ms, bound {step_least.total:.2f} ms (by {step_least.by})")
    return {"max_abs_err": err, "ms": probe_total["dx_dw"], "plain_ms": probe_total["plain"], "bound_ms": least.total,
            "bound_by": least.by, "library_ms": None}


def probes_phase(dev):
    """22: the three probes through their entry points; returns each kernel's
    launches in that run."""
    from lidal_tpu_torch.tools import probe_conv_v3, probe_dxdw_features, probe_int8_gather

    reset_launches()
    t0 = time.perf_counter()
    rows_v3 = probe_conv_v3.main(dev)
    rows_i8 = probe_int8_gather.main(dev)
    rows_dx = probe_dxdw_features.main(dev)
    seconds = time.perf_counter() - t0
    launches = read_launches(("conv_gather_first", "conv_byte_planes", "conv_dx_dw_fused"))
    require(len(rows_v3) == len(probe_conv_v3.SHAPES) and len(rows_i8) == len(probe_int8_gather.SHAPES)
            and len(rows_dx) == 1 + len(probe_dxdw_features.STEP_SHAPES), "a probe skipped a shape")
    require(all(r["max_abs_diff"] == 0.0 for r in rows_i8), "the int8 probe's outputs differ")
    print(f"[22 probes] probe_conv_v3, probe_int8_gather and probe_dxdw_features ran through main() in {seconds:.1f} s, their "
          f"own checks passed; launches {({k: launches[k] for k in KERNELS[6:9]})}")
    return launches


def scoring_phase(cfg_round, root, dev):
    """23: every selection metric but LiDAL through score_command, on the card
    and on the CPU, over maps the port's own inference wrote."""
    import torch

    from lidal_tpu_torch.active import frame_level as fl
    from lidal_tpu_torch.cli.commands import score_command
    from lidal_tpu_torch.data import semantic_kitti as sk
    from lidal_tpu_torch.data.selection import load_sv_info
    from lidal_tpu_torch.runtime.paths import Paths, ensure_dir
    from lidal_tpu_torch.runtime.prob_inference import run_prob_inference
    from lidal_tpu_torch.runtime.train_loop import init_state

    seqs = tuple(f"{i:02d}" for i in range(SCORE_SEQS))
    score_root = os.path.join(root, "Processing_score")
    base = dataclasses.replace(cfg_round, processing_root=score_root, r_id=1, inf_reps=SCORE_VIEWS)
    prev = Paths(dataclasses.replace(base, r_id=0, label_unit="fr"))  # what a round-1 scorer reads
    model = init_state(cfg_round, dev).model.eval()
    randomise_bn(model, SEED + 7)
    files = sk.list_frames(cfg_round.data_root, ("00",))
    t0 = time.perf_counter()
    run_prob_inference(prev.cfg, model, files, lambda p: sk.read_frame(p, with_labels=False), sk.frame_id, device=dev)
    t_inf = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    names = [f"{i:06d}" for i in range(ROUND_FRAMES)]
    for kind_dir in (prev.prob_dir, prev.pred_dir, prev.outfeat_dir):
        require(sorted(os.listdir(kind_dir("00"))) == [f"{n}.npy" for n in names], f"{kind_dir('00')} misses a frame")
    outfeat = np.load(os.path.join(prev.outfeat_dir("00"), f"{names[0]}.npy"))
    require(outfeat.shape == (N_PTS, 96) and bool(np.isfinite(outfeat).all()), f"outfeat {outfeat.shape}")

    # supervoxels: the round tree's own (also as the VCCS partition ReDAL reads); a boundary value per point;
    # the further sequences are names for the same maps
    src = Paths(cfg_round)
    for part in ("KMeans", "VCCS"):
        os.makedirs(os.path.dirname(prev.supervoxel_dir("00", part)), exist_ok=True)
        os.symlink(src.supervoxel_dir("00", "KMeans"), prev.supervoxel_dir("00", part))
    rng = np.random.default_rng(SEED + 10)
    bdir = ensure_dir(prev.boundary_dir("00"))
    sv_sizes = []
    for i, name in enumerate(names):
        np.save(os.path.join(bdir, f"{name}.npy"), (0.1 * rng.random(N_PTS)).astype(np.float32))
        n_sv = len(load_sv_info(os.path.join(src.supervoxel_dir("00"), f"{name}.npz"))[1])
        sv_sizes.append(n_sv)
        for metric in ("ReDAL", "RAND"):  # round-0 supervoxel flags of both partitions: every third frame labelled
            np.save(os.path.join(ensure_dir(prev.sv_flag_dir("00", r_id=0, metric=metric)), f"{name}.npy"),
                    np.full(n_sv, int(i % 3 == 0), np.int32))
    for seq in seqs[1:]:
        for d in (prev.prob_dir, prev.pred_dir, prev.outfeat_dir, prev.supervoxel_dir):
            os.symlink(d("00"), d(seq))
    flag_dir = ensure_dir(prev.frame_flag_dir(r_id=0))
    for seq in seqs:
        np.save(os.path.join(flag_dir, f"{seq}.npy"), np.arange(ROUND_FRAMES) % 10 == 0)
    n_entries = SCORE_SEQS * ROUND_FRAMES
    labelled0 = SCORE_SEQS * len(range(0, ROUND_FRAMES, 10))
    print(f"[23 scoring] run_prob_inference ({SCORE_VIEWS} views) wrote prob, pred and outfeat maps of {ROUND_FRAMES} frames x "
          f"{N_PTS} points x {cfg_round.data.num_classes} classes in {t_inf:.1f} s; the frame-level tree has {SCORE_SEQS} "
          f"sequences that all point at those maps: {n_entries} frame entries, {labelled0} labelled")

    # the three device scorers on the card against the same functions on the CPU
    worst = 0.0
    for name in names[:3]:
        prob = torch.from_numpy(np.load(os.path.join(prev.prob_dir("00"), f"{name}.npy")))
        for fn in (fl.entropy_score, fl.margin_score, fl.least_confidence_score):
            on_card, on_cpu = float(fn(prob.to(dev))), float(fn(prob))
            require(np.isfinite(on_card) and abs(on_card - on_cpu) <= SCORE_TOL, f"{fn.__name__} {on_card} on the card, {on_cpu} on the CPU")
            worst = max(worst, abs(on_card - on_cpu))
    print(f"[23 scoring] entropy, margin and least-confidence scores of 3 frames: card within {worst:.1e} of the CPU (tol {SCORE_TOL})")

    def read_flags(out_dirs):
        return {(d, n): np.load(os.path.join(d, n)) for d in out_dirs for n in sorted(os.listdir(d))}

    budget = round(0.01 * cfg_round.data.train_point_num)
    for metric, unit in [(m, "fr") for m in ("ENT", "MAR", "CONF", "SEGENT", "CSET", "RAND")] + [("ReDAL", "sv"), ("RAND", "sv")]:
        split = seqs if unit == "fr" else ("00",)
        cfg = dataclasses.replace(base, metric_name=metric, label_unit=unit,
                                  data_override=dataclasses.replace(base.data, train_split=split))
        out_dirs = [Paths(cfg).frame_flag_dir()] if unit == "fr" else [Paths(cfg).sv_flag_dir("00")]
        runs, seconds = [], []
        for device in (dev, "cpu"):
            for d in out_dirs:
                shutil.rmtree(d, ignore_errors=True)
            t0 = time.perf_counter()
            score_command(cfg, device)
            seconds.append(time.perf_counter() - t0)
            runs.append(read_flags(out_dirs))
        on_card, on_cpu = runs
        require(on_card.keys() == on_cpu.keys() and all(np.array_equal(on_card[k], on_cpu[k]) for k in on_card),
                f"{metric}/{unit}: the card's flag files differ from the CPU's")
        if unit == "fr":
            require(len(on_card) == SCORE_SEQS, f"{metric}: {len(on_card)} flag files")
            flags = np.concatenate([on_card[k] for k in sorted(on_card)])
            added = int(flags.sum()) - labelled0
            require(flags.dtype == bool and flags.shape == (n_entries,) and added == round(0.01 * n_entries),
                    f"{metric}/fr: {added} frames added to {labelled0}, expected {round(0.01 * n_entries)}")
            what = f"{added} frame added to {labelled0} of {n_entries}"
        else:
            require(len(on_card) == ROUND_FRAMES, f"{metric}: {len(on_card)} flag files")
            points = 0
            for i, name in enumerate(names):
                new = on_card[(out_dirs[0], f"{name}.npy")]
                require(len(new) == sv_sizes[i] and bool(np.isin(new, (0, 1)).all()) and (i % 3 != 0 or bool(new.all())),
                        f"{metric}/sv: flags of frame {name}")
                if i % 3:
                    point2sv = load_sv_info(os.path.join(src.supervoxel_dir("00"), f"{name}.npz"))[0]
                    points += int(np.bincount(point2sv[point2sv >= 0], minlength=len(new))[new == 1].sum())
            require(0 < points <= budget, f"{metric}/sv: {points} points added on a budget of {budget}")
            what = f"{points} points added on a budget of {budget}"
        print(f"[23 scoring] score_command {metric}/{unit}: {what}; flag files on the card == on the CPU; "
              f"{seconds[0]:.2f} s on the card, {seconds[1]:.2f} s on the CPU")


def attention_abs_sums(q, k, v, do):
    """The abs-sums of the patch attention's outputs (f64): each output's sum
    of the magnitudes of its terms down the chain that computes it, ``P |v|``
    for o, ``P^T |dO|`` for dv, and for dq and dk ``scale P (|dO| |v|^T +
    rowsum(|dO| |o|))`` times ``|k|`` and, transposed, ``|q|`` (P >= 0).  The
    f64 gate's floor, as the abs-sum of the convs' gate (phase 7)."""
    import torch

    q, k, v, do = (x.double() for x in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    outs = [torch.empty_like(q) for _ in range(4)]
    step = max(1, (1 << 24) // (q.shape[1] * q.shape[2] * q.shape[2]))
    for s in range(0, q.shape[0], step):
        b = slice(s, s + step)
        p = torch.softmax((q[b] @ k[b].transpose(-2, -1)) * scale, -1)
        o_abs = p @ v[b].abs()
        ds = p * (do[b].abs() @ v[b].abs().transpose(-2, -1) + (do[b].abs() * (p @ v[b]).abs()).sum(-1, keepdim=True))
        outs[0][b], outs[3][b] = o_abs, p.transpose(-2, -1) @ do[b].abs()
        outs[1][b], outs[2][b] = scale * ds @ k[b].abs(), scale * ds.transpose(-2, -1) @ q[b].abs()
    return outs  # o, dq, dk, dv


def attention_phase(dev) -> dict:
    """31: the patch attention kernels against their plain versions at
    ATTN_SHAPES; its record entry's numbers, forward and backward summed over
    the shapes."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from lidal_tpu_torch.ops import patch_attention as pa

    def distance(x, ref):
        return float((x.double() - ref).abs().max()) / float(ref.abs().max())

    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    bound, worst = Bound(), 0.0
    for p, h in ATTN_SHAPES:
        g = torch.Generator(device=dev).manual_seed(SEED + p * h)
        q, k, v, do = (torch.randn(p, h, ATTN_K, pa.HEAD_DIM, generator=g, device=dev) * sc for sc in (1.5, 1.5, 1, 1))
        o, lse = pa.patch_attention_forward(q, k, v)
        grads = pa.patch_attention_backward(q, k, v, o, lse, do)
        o2, lse2 = pa.patch_attention_forward(q, k, v)
        grads2 = pa.patch_attention_backward(q, k, v, o, lse, do)
        require(torch.equal(o, o2) and torch.equal(lse, lse2) and all(torch.equal(a, b) for a, b in zip(grads, grads2)),
                f"attention {p} x {h}: two runs differ")
        ref_o, ref_lse = pa.patch_attention_plain(q.double(), k.double(), v.double())
        ref_g = pa.patch_attention_backward_plain(q.double(), k.double(), v.double(), ref_o, ref_lse, do.double())
        f32_o, f32_lse = pa.patch_attention_plain(q, k, v)
        f32_g = pa.patch_attention_backward_plain(q, k, v, f32_o, f32_lse, do)
        dists = {}
        a_o, a_dq, a_dk, a_dv = attention_abs_sums(q, k, v, do)
        sums = (a_o, ref_lse.abs(), a_dq, a_dk, a_dv)
        for name, got, f32, ref, b in zip(("o", "lse", "dq", "dk", "dv"), (o, lse) + grads, (f32_o, f32_lse) + f32_g,
                                          (ref_o, ref_lse) + ref_g, sums):
            e_k, e_p = (float((x.double() - ref).abs().max()) for x in (got, f32))
            dists[name] = (distance(got, ref), distance(f32, ref))
            require(bool(got.isfinite().all()) and e_k <= F64_FACTOR * e_p + 1e-6 * float(b.max()),
                    f"attention {p} x {h} {name}: kernel {e_k:.3g} from f64, plain f32 {e_p:.3g}")
            worst = max(worst, float((got - f32).abs().max()))
        del ref_o, ref_g, f32_o, f32_g, o2, grads2, sums, a_o, a_dq, a_dk, a_dv
        fwd_ms = cuda_ms(lambda: pa.patch_attention_forward(q, k, v))
        bwd_ms = cuda_ms(lambda: pa.patch_attention_backward(q, k, v, o, lse, do))
        plain_fwd = cuda_ms(lambda: pa.patch_attention_plain(q, k, v), reps=2)
        plain_bwd = cuda_ms(lambda: pa.patch_attention_backward_plain(q, k, v, o, lse, do), reps=2)
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves)
            lib_bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
        del out, leaves
        work = 4.0 * p * h * ATTN_K * ATTN_K * pa.HEAD_DIM
        b_fwd = bound.add(nbytes(q, k, v, o, lse), work, PEAK_SPLIT_TF32)
        b_bwd = bound.add(nbytes(q, k, v, o, lse, do, *grads), 2 * work, PEAK_SPLIT_TF32)
        tot["ms"] += fwd_ms + bwd_ms
        tot["plain_ms"] += plain_fwd + plain_bwd
        tot["library_ms"] += lib_fwd + lib_bwd
        print(f"[31 attention] {p} patches x {h} heads x {ATTN_K}: forward {fwd_ms:.3f} ms (plain {plain_fwd:.3f}, "
              f"bound {b_fwd:.3f}, {100 * b_fwd / fwd_ms:.1f} %; memory-efficient SDPA {lib_fwd:.3f}), backward "
              f"{bwd_ms:.3f} ms (plain {plain_bwd:.3f}, bound {b_bwd:.3f}, {100 * b_bwd / bwd_ms:.1f} %; SDPA backward "
              f"{lib_bwd:.3f}); distance from f64, kernel / plain f32: "
              + ", ".join(f"{n} {a:.3g} / {b:.3g}" for n, (a, b) in dists.items()) + "; reruns bit-equal")
        del q, k, v, do, o, lse, grads
        torch.cuda.empty_cache()
    return {"max_abs_err": worst, "bound_ms": bound.total, "bound_by": bound.by, **tot}


def ptv3_path_phase(cfg, eb, dev) -> dict:
    """32: PTv3's train run (``cfg`` with ``model_name="PTv3"``) and an eval
    forward of the trained model on ``eb``; the kernels' launches in both,
    counted from 0 just before them."""
    import torch

    from lidal_tpu_torch.data.pipeline import forward_batch
    from lidal_tpu_torch.models import ptv3
    from lidal_tpu_torch.runtime.train_loop import run_train

    losses = []
    reset_launches()
    state = run_train(dataclasses.replace(cfg, model_name="PTv3"), max_iter=1 + TIMED_STEPS, log_every=1,
                      on_step=lambda step, loss: losses.append(float(loss)), device=dev)
    model = state.model.eval()
    with torch.no_grad():
        logits = forward_batch(model, eb)[0]
    finite = bool(logits.isfinite().all())
    launches = read_launches(("attn_fwd", "attn_bwd"))
    blocks = sum(isinstance(m, ptv3.Attention) for m in model.modules())
    require(state.step == 1 + TIMED_STEPS, f"run_train took {state.step} steps")
    require(all(np.isfinite(x) for x in losses) and finite, f"PTv3: losses {losses}, eval logits finite {finite}")
    want = {"attn_fwd": (state.step + 1) * blocks, "attn_bwd": 2 * state.step * blocks}
    got = {k: launches[k] for k in want}
    require(got == want, f"PTv3's attention launched {got}, {want} expected ({blocks} blocks, {state.step} steps "
                         "and one eval forward)")
    print(f"[32 PTv3] run_train: {state.step} steps of {cfg.data.batch_size} frames, losses "
          f"{[round(x, 4) for x in losses]}; eval forward on {len(eb.feats)} frames; attention launches {got} "
          f"({blocks} blocks); all launches {launches}")
    del state, model, logits
    return launches


def lookup_phase(eb) -> dict:
    """3: the lookup kernel against its plain version on every level's rulebook
    streams of one batch and on edge streams; its record entry's numbers."""
    import torch

    from lidal_tpu_torch.ops import cuda_merge
    from lidal_tpu_torch.ops.hashing import SENTINEL_KEY, key64
    from lidal_tpu_torch.ops.kernel_map import rulebook_streams

    lookup_err = 0
    lookup_ms = lookup_plain_ms = lookup_lib_ms = 0.0
    lookup_bound = Bound()
    for lvl, lv in enumerate(eb.plan.levels):
        streams = rulebook_streams(lv.coords, lv.valid)
        for found in (True, False):
            got = cuda_merge.lookup_sorted(*streams, with_found=found)
            want = cuda_merge.lookup_sorted_plain(*streams, with_found=found)
            bad = int((got != want).sum())
            lookup_err = max(lookup_err, int((got.long() - want.long()).abs().max()))
            require(bad == 0, f"lookup level {lvl} found={found}: {bad} results differ")
        k_ms = cuda_ms(lambda: cuda_merge.lookup_sorted(*streams, with_found=True))
        p_ms = cuda_ms(lambda: cuda_merge.lookup_sorted_plain(*streams, with_found=True))
        lookup_ms += k_ms
        lookup_plain_ms += p_ms
        # the one library call of the same function: torch.searchsorted over int64 keys
        tk = key64(streams[0], streams[1])
        qk = key64(streams[2], streams[3]).reshape(tk.shape[0], -1)
        lib_ms = cuda_ms(lambda: torch.searchsorted(tk, qk))
        lookup_lib_ms += lib_ms
        n_queries, n_table = streams[2].numel(), streams[0].shape[1]
        b_ms = lookup_bound.add(
            nbytes(*streams) + 4 * n_queries, 2.0 * n_queries * max(1, n_table).bit_length(), PEAK_I32
        )
        del tk, qk
        n_wide, n_tiles = cuda_merge.wide_tiles(*streams)
        print(f"[3 lookup] level {lvl}: {streams[2].shape[0]} streams x {streams[2].shape[1]} queries "
              f"on {streams[0].shape[0]} tables, bit-equal (both modes); kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
              f"torch.searchsorted on ready int64 keys {lib_ms:.3f} ms, bound {b_ms:.4f} ms; "
              f"{n_wide} of {n_tiles} tiles searched their window in device memory")
    t_hi, t_lo, q_hi, q_lo = rulebook_streams(eb.plan.levels[0].coords, eb.plan.levels[0].valid)
    sent_t = torch.full_like(t_hi, SENTINEL_KEY)
    dup_hi, dup_lo = q_hi.clone(), q_lo.clone()
    dup_hi[:, 1::2], dup_lo[:, 1::2] = dup_hi[:, ::2], dup_lo[:, ::2]  # sorted, every key twice
    edges = {
        "all-sentinel tables": (sent_t, sent_t, q_hi, q_lo),
        "all-sentinel queries": (t_hi, t_lo, torch.full_like(q_hi, SENTINEL_KEY), torch.full_like(q_lo, SENTINEL_KEY)),
        "duplicate queries": (t_hi, t_lo, dup_hi, dup_lo),
        "zero-width tables": (t_hi[:, :0].contiguous(), t_lo[:, :0].contiguous(), q_hi, q_lo),
    }
    for name, streams in edges.items():
        for found in (True, False):
            got = cuda_merge.lookup_sorted(*streams, with_found=found)
            want = cuda_merge.lookup_sorted_plain(*streams, with_found=found)
            require(torch.equal(got, want), f"lookup edge case {name} found={found}")
    print(f"[3 lookup] edge streams bit-equal: {', '.join(edges)}")
    return {"max_abs_err": lookup_err, "ms": lookup_ms, "plain_ms": lookup_plain_ms, "bound_ms": lookup_bound.total,
            "bound_by": lookup_bound.by, "library_ms": lookup_lib_ms}


def conv_phase(model, eb):
    """4: the conv kernel against its plain version (and f64) at every shape of
    one forward of ``model`` on ``eb``.  Returns its record entry's numbers and
    three real maps for phase 19."""
    import torch

    from lidal_tpu_torch.ops import cuda_conv

    captured, calls = {}, {}
    kernel_conv = cuda_conv.subm_conv

    def recorder(feats, w, nbr, scale=None, shift=None, relu=False):
        key = (nbr.shape[1], feats.shape[1], w.shape[2], relu, nbr.shape[0], feats.shape[0])
        calls[key] = calls.get(key, 0) + 1
        if key not in captured:
            captured[key] = (feats.clone(), w.clone(), nbr.clone(), scale.clone(), shift.clone(), relu)
        return kernel_conv(feats, w, nbr, scale, shift, relu)

    cuda_conv.subm_conv = recorder
    try:
        with torch.inference_mode():
            model(eb.feats, eb.plan)
    finally:
        cuda_conv.subm_conv = kernel_conv

    conv_err = 0.0
    conv_ms = conv_plain_ms = 0.0
    conv_bound_f32, conv_bound = Bound(), Bound()  # FFMA at 67 TFLOP/s; split TF32 at 495 / 3
    with torch.inference_mode():
        for key in sorted(captured):
            args = captured[key]
            out = cuda_conv.subm_conv(*args)
            plain = cuda_conv.subm_conv_plain(*args)
            ok, err = conv_close(out, plain)
            require(ok, f"conv {key}: max |kernel - plain| {err}")
            require(torch.equal(out, cuda_conv.subm_conv(*args)), f"conv {key}: differs between two runs")
            feats, w, nbr, scale, shift, relu = args
            ref = cuda_conv.subm_conv_plain(feats.double(), w.double(), nbr, scale.double(), shift.double(), relu)
            abs_sum = cuda_conv.subm_conv_plain(feats.abs(), w.abs(), nbr) * scale.abs()
            e_k = float((out.double() - ref).abs().max())
            e_p = float((plain.double() - ref).abs().max())
            require(e_k <= F64_FACTOR * e_p + 1e-6 * float(abs_sum.max()),
                    f"conv {key}: {e_k:.2e} from f64 against the plain version's {e_p:.2e}")
            pairs = int((nbr < feats.shape[0]).sum())  # real (row, tap) pairs
            ops = 2.0 * pairs * key[1] * key[2]
            f32_ms = conv_bound_f32.add(nbytes(*args[:5], out), ops, calls=calls[key])
            b_ms = conv_bound.add(nbytes(*args[:5], out), ops, PEAK_SPLIT_TF32, calls=calls[key])
            del out, plain, ref, abs_sum
            conv_err = max(conv_err, err)
            k_ms = cuda_ms(lambda: cuda_conv.subm_conv(*args))
            p_ms = cuda_ms(lambda: cuda_conv.subm_conv_plain(*args), reps=3)
            conv_ms += calls[key] * k_ms
            conv_plain_ms += calls[key] * p_ms
            k, cin, cout, relu, m, n = key
            print(f"[4 conv] K={k} cin={cin} cout={cout} relu={int(relu)} m={m} n={n} x{calls[key]}: "
                  f"max|d|={err:.2e}, from f64 {e_k:.1e} (plain {e_p:.1e}), bit-equal on a rerun; kernel {k_ms:.3f} ms, "
                  f"plain {p_ms:.3f} ms, bound f32 {f32_ms:.3f} ms, split TF32 {b_ms:.3f} ms ({pairs} real pairs)")
        # the no-epilogue form at the widest level-0 shape
        key = max(captured, key=lambda kk: (kk[4], kk[1] * kk[2]))
        feats, w, nbr = captured[key][:3]
        ok, err = conv_close(cuda_conv.subm_conv(feats, w, nbr), cuda_conv.subm_conv_plain(feats, w, nbr))
        require(ok, f"conv without epilogue {key[:3]}: max |kernel - plain| {err}")
    print(f"[4 conv] {len(captured)} shapes, {sum(calls.values())} calls per forward; within "
          f"{CONV_TOL} * max(1, |plain|) and within {F64_FACTOR}x the plain version's distance from f64; per forward: "
          f"kernel {conv_ms:.2f} ms, plain {conv_plain_ms:.1f} ms, bound f32 {conv_bound_f32.total:.2f} ms "
          f"(by {conv_bound_f32.by}), split TF32 {conv_bound.total:.2f} ms (by {conv_bound.by})")
    # three real maps for phase 19: the widest K = 27 conv of level 0, the largest down conv (m < n) and up conv (m > n)
    picks = {
        "forward K=27": max((kk for kk in captured if kk[0] == 27), key=lambda kk: (kk[4], kk[1] * kk[2])),
        "forward down": max((kk for kk in captured if kk[0] == 8 and kk[4] < kk[5]), key=lambda kk: (kk[5], kk[1] * kk[2])),
        "forward up": max((kk for kk in captured if kk[0] == 8 and kk[4] > kk[5]), key=lambda kk: (kk[4], kk[1] * kk[2])),
    }
    real_convs = {label: captured[kk][:3] for label, kk in picks.items()}
    return {"max_abs_err": conv_err, "ms": conv_ms, "plain_ms": conv_plain_ms, "bound_ms": conv_bound.total,
            "bound_by": conv_bound.by, "library_ms": None}, real_convs


def nu_yaw(deg: float) -> list:
    """[w, x, y, z] quaternion of a turn by ``deg`` degrees about z."""
    a = np.deg2rad(deg) / 2
    return [float(np.cos(a)), 0.0, 0.0, float(np.sin(a))]


def write_nu_tree(root, rng) -> str:
    """A v1.0-trainval-like nuScenes tree under ``root/nuScenes``: the JSON
    tables scene, sample, sample_data, ego_pose, calibrated_sensor and
    lidarseg, ``splits.json``, and per keyframe a 5-column ``.pcd.bin`` and a
    uint8 lidarseg ``.bin`` (raw ids 0-31).  Scene NU_TRAIN_SCENE has
    NU_TRAIN_FRAMES keyframes (nuScenes's 20 s at 2 Hz), NU_VAL_SCENE
    NU_VAL_FRAMES.  Both see ONE static world of NU_WORLD_POINTS points around
    a route that starts at the map coordinates NU_ORIGIN (nuScenes maps
    register frames at 10^2-10^3 m) and moves NU_STEP m and turns NU_TURN
    degrees a keyframe (the val scene's ego 3 m to the side); each keyframe
    is NU_PTS of the world's points within 70 m, in LIDAR_TOP coordinates
    (calibrated with nuScenes's rotation of about -90 degrees and a small
    tilt, 1.84 m up), with 1 cm of noise.  Returns the tree's root."""
    from lidal_tpu_torch.data.nuscenes import pose_matrix

    nu_root = os.path.join(root, "nuScenes")
    version = os.path.join(nu_root, "v1.0-trainval")
    for d in (version, os.path.join(nu_root, "samples", "LIDAR_TOP"), os.path.join(nu_root, "lidarseg", "v1.0-trainval")):
        os.makedirs(d)
    yaw = np.deg2rad(NU_TURN * np.arange(NU_TRAIN_FRAMES))
    route = NU_ORIGIN + np.cumsum(NU_STEP * np.stack([np.cos(yaw), np.sin(yaw), 0 * yaw], 1), axis=0)
    world, _ = synthetic_sk_frame(rng, NU_WORLD_POINTS)
    world = world.astype(np.float64) + route[NU_TRAIN_FRAMES // 2]
    world_raw = rng.integers(0, 32, NU_WORLD_POINTS).astype(np.uint8)
    cal = {"token": "lidar_top_cal", "rotation": [0.7077955, -0.0064922, 0.0106462, -0.7063073],
           "translation": [0.943713, 0.0, 1.84023]}
    sensor2ego = pose_matrix(cal["rotation"], cal["translation"])
    tables = {"scene": [], "sample": [], "sample_data": [], "ego_pose": [], "calibrated_sensor": [cal], "lidarseg": []}
    for si, (scene, n_frames, side) in enumerate(((NU_TRAIN_SCENE, NU_TRAIN_FRAMES, 0.0),
                                                  (NU_VAL_SCENE, NU_VAL_FRAMES, 3.0))):
        tokens = [f"s{si}k{k:02d}" for k in range(n_frames)]
        tables["scene"].append({"token": f"scene{si}", "name": scene, "first_sample_token": tokens[0]})
        for k, tok in enumerate(tokens):
            tables["sample"].append({"token": tok, "scene_token": f"scene{si}", "prev": tokens[k - 1] if k else "",
                                     "next": tokens[k + 1] if k + 1 < n_frames else ""})
            pos = route[k] + side * np.array([-np.sin(yaw[k]), np.cos(yaw[k]), 0.0])
            ego = {"token": f"ego_{tok}", "rotation": nu_yaw(NU_TURN * k), "translation": pos.tolist()}
            tables["ego_pose"].append(ego)
            pose = pose_matrix(ego["rotation"], ego["translation"]) @ sensor2ego
            near = np.flatnonzero(np.hypot(*(world[:, :2] - pos[:2]).T) < 70.0)
            seen = np.sort(rng.choice(near, NU_PTS, replace=False))
            inv = np.linalg.inv(pose)
            xyz = world[seen] @ inv[:3, :3].T + inv[:3, 3] + 0.01 * rng.standard_normal((NU_PTS, 3))
            cols = np.concatenate([xyz, 255 * rng.random((NU_PTS, 1)), rng.integers(0, 32, (NU_PTS, 1))], 1)
            sd = {"token": f"sd_{tok}", "sample_token": tok, "is_key_frame": True,
                  "filename": f"samples/LIDAR_TOP/{tok}__LIDAR_TOP.pcd.bin", "calibrated_sensor_token": cal["token"],
                  "ego_pose_token": ego["token"]}
            tables["sample_data"].append(sd)
            cols.astype(np.float32).tofile(os.path.join(nu_root, sd["filename"]))
            seg = {"token": f"seg_{tok}", "sample_data_token": sd["token"],
                   "filename": f"lidarseg/v1.0-trainval/{sd['token']}_lidarseg.bin"}
            tables["lidarseg"].append(seg)
            world_raw[seen].tofile(os.path.join(nu_root, seg["filename"]))
    for name, rows in tables.items():
        with open(os.path.join(version, f"{name}.json"), "w") as f:
            json.dump(rows, f)
    with open(os.path.join(nu_root, "splits.json"), "w") as f:
        json.dump({"train": [NU_TRAIN_SCENE], "val": [NU_VAL_SCENE]}, f)
    return nu_root


def nu_prep_phase(cfg) -> int:
    """24: prep_command's stages on the nuScenes tree (grids, supervoxels by
    the native k-means, bootstrap; vccs and boundary over the first
    NU_PREP_FRAMES frames), each timed, the artifacts counted; then round-1
    labels (every third frame's supervoxels) for ``cfg``'s round 2.  Returns
    the supervoxel count."""
    from lidal_tpu_torch.cli.commands import prep_command
    from lidal_tpu_torch.data import nuscenes as nu
    from lidal_tpu_torch.prep import native
    from lidal_tpu_torch.prep.supervoxel_vccs import prepare_supervoxels_vccs
    from lidal_tpu_torch.prep.surface_variation import prepare_surface_variation
    from lidal_tpu_torch.runtime.paths import Paths
    from lidal_tpu_torch.runtime.train_loop import nu_seq_frames

    paths, seconds = Paths(cfg), {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        seconds[name] = time.perf_counter() - t0

    timed("grids", prep_command, cfg, "grids")
    timed("native build", native.load)
    build_s, _ = native.BUILD_LOG[native.library_path()]
    timed("supervoxels", prep_command, cfg, "supervoxels")
    first = {s: e[:NU_PREP_FRAMES] for s, e in nu_seq_frames(cfg).items()}
    require(list(first) == [NU_TRAIN_SCENE], f"train scenes {list(first)}")

    def read_xyz(e):
        return nu.read_frame(e, with_labels=False)[0]

    timed("vccs", prepare_supervoxels_vccs, cfg, first, read_xyz)
    timed("boundary", prepare_surface_variation, cfg, first, read_xyz)
    timed("bootstrap", prep_command, cfg, "bootstrap")

    def count(d, ext):
        return len([f for f in os.listdir(d) if f.endswith(ext)])

    s = NU_TRAIN_SCENE
    counts = {
        "grid": count(paths.grid_dir(s), ".npz"), "KMeans": count(paths.supervoxel_dir(s, "KMeans"), ".npz"),
        "VCCS": count(paths.supervoxel_dir(s, "VCCS"), ".npz"), "boundary": count(paths.boundary_dir(s), ".npy"),
        "sv_flag 0r": count(paths.sv_flag_dir(s, r_id=0), ".npy"),
    }
    want = {"grid": NU_TRAIN_FRAMES, "KMeans": NU_TRAIN_FRAMES, "VCCS": NU_PREP_FRAMES, "boundary": NU_PREP_FRAMES,
            "sv_flag 0r": NU_TRAIN_FRAMES}
    require(counts == want, f"artifacts {counts}, expected {want}")
    require(os.path.exists(os.path.join(paths.frame_flag_dir(r_id=0), f"{s}.npy")), "no round-0 frame flags")
    with np.load(os.path.join(cfg.processing_root, "NU", "super_voxel", "KMeans", "id2sv.npz")) as z:
        n_sv = len(z["seq"])
    require(n_sv == 20 * NU_TRAIN_FRAMES, f"{n_sv} k-means supervoxels")
    with np.load(os.path.join(cfg.processing_root, "NU", "super_voxel", "VCCS", "id2sv.npz")) as z:
        n_vccs = len(z["seq"])
    require(n_vccs > 0, "no VCCS supervoxel kept")
    sigma = np.load(os.path.join(paths.boundary_dir(s), sorted(os.listdir(paths.boundary_dir(s)))[0]))
    require(sigma.shape == (NU_PTS,) and bool(np.isfinite(sigma).all()) and sigma.max() <= np.float32(0.1), "boundary")
    svdir, r1_dir = paths.sv_flag_dir(s, r_id=0), paths.sv_flag_dir(s, r_id=1)
    os.makedirs(r1_dir)
    for i, name in enumerate(sorted(os.listdir(svdir))):  # round-1 labels: every third frame's supervoxels
        n = len(np.load(os.path.join(svdir, name)))
        np.save(os.path.join(r1_dir, name), np.full(n, int(i % 3 == 0), np.int32))
    print(f"[24 prep] nuScenes tree: {NU_TRAIN_FRAMES} + {NU_VAL_FRAMES} keyframes x {NU_PTS} points; prep_command "
          f"grids {seconds['grids']:.2f} s, supervoxels {seconds['supervoxels']:.2f} s (native build "
          f"{build_s:.2f} s with g++, load {seconds['native build']:.2f} s), bootstrap {seconds['bootstrap']:.2f} s; over "
          f"{NU_PREP_FRAMES} frames vccs {seconds['vccs']:.2f} s ({n_vccs} supervoxels kept), boundary "
          f"{seconds['boundary']:.2f} s; artifacts {counts}; {n_sv} k-means supervoxels")
    return n_sv


def nu_eval_phase(cfg, dev, route):
    """25: the NU eval slice (B = 2 x batch_size = 30 val keyframes, NU caps)
    with MinkUNet and SPVCNN; each warmed up through ``evaluate_command``;
    beside each, 30 (e): the same batches on the bf16 route
    (``route_eval_phase``), its launches into ``route``.  Returns ({family:
    launches}, one eval batch dict)."""
    import torch

    from lidal_tpu_torch.cli.commands import _dataset_frames, evaluate_command
    from lidal_tpu_torch.data.loader import FrameBatchLoader
    from lidal_tpu_torch.data.pipeline import prepare_eval_batch
    from lidal_tpu_torch.runtime import checkpoint as ckpt
    from lidal_tpu_torch.runtime.paths import Paths
    from lidal_tpu_torch.runtime.train_loop import init_state

    caps = cfg.data.level_caps
    files, read_fn, _ = _dataset_frames(cfg, "val")
    loader = FrameBatchLoader(files, lambda e: read_fn(e, with_labels=True), point_cap=cfg.data.point_cap,
                              batch_size=2 * cfg.data.batch_size)
    batch = next(iter(loader))
    require(batch["n_frames"] == NU_VAL_FRAMES == 2 * cfg.data.batch_size, f"{batch['n_frames']} frames a batch")

    def prepare(b, seed, with_points=False):
        return prepare_eval_batch(
            torch.Generator(device="cpu").manual_seed(seed),
            *(torch.as_tensor(b[k], device=dev) for k in ("xyz", "sig", "valid")),
            level_caps=caps, with_points=with_points,
        )

    launches = {}
    for family in ("Mink", "SPVCNN"):
        cfg_f = dataclasses.replace(cfg, model_name=family)
        state = init_state(cfg_f, dev)
        randomise_bn(state.model, SEED + 1)
        ckpt.save_checkpoint(Paths(cfg_f).ckpt_dir(), state, 0)  # what evaluate_command restores
        model = state.model.eval()
        launches[family], _ = eval_slice_phase(
            cfg_f, model, [batch] * (1 + TIMED_BATCHES), prepare, dev, caps, f"25 slice {family}",
            f"25 forward {family}", b=NU_VAL_FRAMES, n_pts=NU_PTS, warm_up=lambda: evaluate_command(cfg_f, dev),
        )
        route[f"NU eval {family}"] = route_eval_phase(cfg_f, model, [batch] * (1 + TIMED_BATCHES), prepare, dev, caps,
                                                      b=NU_VAL_FRAMES, n_pts=NU_PTS, tag=f"[30e eval NU {family}]")
        del state, model
        torch.cuda.empty_cache()
    return launches, batch


def nu_round_phase(cfg, root, dev, n_sv):
    """27 (after the grid and nn_band checks): staged and fused NU LiDAL rounds
    from the same weights, over the frames as the commands enumerate them;
    returns (the kernels' launches in the fused round, its selection, its
    seconds)."""
    import torch

    from lidal_tpu_torch.active import lidal, lidal_runner
    from lidal_tpu_torch.cli.commands import _dataset_frames
    from lidal_tpu_torch.runtime.paths import Paths
    from lidal_tpu_torch.runtime.prob_inference import run_prob_inference
    from lidal_tpu_torch.runtime.train_loop import init_state

    model = init_state(cfg, dev).model.eval()
    randomise_bn(model, SEED + 7)
    files, read_fn, frame_id = _dataset_frames(cfg, "train")
    require(len(files) == NU_TRAIN_FRAMES, f"{len(files)} train frames")
    by_id = {frame_id(e): e for e in files}
    cfg_f = dataclasses.replace(cfg, processing_root=os.path.join(root, "Processing_fused"))
    shutil.copytree(cfg.processing_root, cfg_f.processing_root)

    selections = []
    select = lidal.select

    def recording_select(*args, **kwargs):
        selections.append([np.array(a) for a in args[:5]])
        return select(*args, **kwargs)

    lidal.select = recording_select
    try:
        t0 = time.perf_counter()
        run_prob_inference(lidal_runner._prev_cfg(cfg), model, files, lambda e: read_fn(e, with_labels=False),
                           frame_id, device=dev)
        torch.cuda.synchronize()
        t_inf = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_a = lidal_runner.run_lidal_round(cfg, device=dev)
        t_score = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        res_b = lidal_runner.run_fused_lidal_round(
            cfg_f, model, lambda seq, name: read_fn(by_id[(seq, name)], with_labels=False)[:2],
            frame_index={frame_id(e): i for i, e in enumerate(files)}, device=dev,
        )
        t_fused = time.perf_counter() - t0
        launches = read_launches(("lookup_sorted", "subm_conv", "nn_band"))
    finally:
        lidal.select = select
    require(launches["nn_band"] == NU_TRAIN_FRAMES, f"nn_band launched {launches['nn_band']} times")
    pa, pb = Paths(lidal_runner._prev_cfg(cfg)), Paths(lidal_runner._prev_cfg(cfg_f))
    worst_sum = 0.0
    for e in files:
        name = e["token"]
        prob_a = np.load(os.path.join(pa.prob_dir(NU_TRAIN_SCENE), f"{name}.npy"))
        require(prob_a.shape == (NU_PTS, cfg.data.num_classes) and bool(np.isfinite(prob_a).all()), f"prob {name}")
        worst_sum = max(worst_sum, float(np.abs(prob_a.sum(1) - 1.0).max()))
        for kind, da, db in (("prob", pa.prob_dir, pb.prob_dir), ("pred", pa.pred_dir, pb.pred_dir)):
            a = np.load(os.path.join(da(NU_TRAIN_SCENE), f"{name}.npy"))
            require(np.array_equal(a, np.load(os.path.join(db(NU_TRAIN_SCENE), f"{name}.npy"))),
                    f"{kind} {name}: staged != fused")
        flag_a = np.load(os.path.join(Paths(cfg).sv_flag_dir(NU_TRAIN_SCENE), f"{name}.npy"))
        flag_b = np.load(os.path.join(Paths(cfg_f).sv_flag_dir(NU_TRAIN_SCENE), f"{name}.npy"))
        require(np.array_equal(flag_a, flag_b), f"sv_flag {name}: staged != fused")
    require(worst_sum <= PROB_SUM_TOL, f"prob rows sum to 1 within {worst_sum}")
    require(len(selections) == 2 and all(np.array_equal(a, b) for a, b in zip(*selections)),
            "supervoxel flags, scores, point counts or centres differ between the staged and the fused round")
    for a, b in zip(res_a, res_b):
        require(np.array_equal(a, b), "selections differ between the staged and the fused round")
    _, sv_interds, _, sv_pnums, sv_centers = selections[0]
    require(len(sv_interds) == n_sv and bool(np.isfinite(sv_interds).all()), "supervoxel scores")
    require(float(np.abs(sv_centers[:, :2]).min()) > 500.0, "supervoxel centres not in map coordinates")
    require(len(res_b.al_added) > 0, "no supervoxel was selected")
    print(f"[27 round] staged: run_prob_inference {NU_TRAIN_FRAMES} frames x {cfg.inf_reps} views in {t_inf:.2f} s "
          f"({NU_TRAIN_FRAMES / t_inf:.3f} frames/s), run_lidal_round in {t_score:.2f} s; fused: "
          f"run_fused_lidal_round in {t_fused:.2f} s = {NU_TRAIN_FRAMES / t_fused:.3f} frames/s; launches {launches}")
    print(f"[27 round] staged == fused: {NU_TRAIN_FRAMES} prob and pred npys, {n_sv} supervoxel scores, statistics and "
          f"sv_flag files identical; prob rows sum to 1 within {worst_sum:.1e}; {int((sv_interds > 0).sum())} of "
          f"{n_sv} supervoxels have divergence > 0; selected {len(res_b.al_added)} for labels "
          f"({int(sv_pnums[res_b.al_added].sum())} points of a budget of {round(0.01 * cfg.data.train_point_num)}) and "
          f"{len(res_b.sl_added)} for pseudo labels")
    del model
    torch.cuda.empty_cache()
    return launches, res_b, t_fused


def nu_import_phase(cfg, batch, dev):
    """28: the seeded NU MinkUNet and SPVCNN exported to a torchsparse-layout
    ``current.pt`` (names under ``module.``), imported by
    ``import_torch_command`` and restored by ``_load_eval_variables``: logits
    on one NU eval batch bit-equal to the source model's."""
    import torch

    from lidal_tpu_torch.cli.commands import _load_eval_variables, import_torch_command
    from lidal_tpu_torch.data.pipeline import forward_batch, prepare_eval_batch
    from lidal_tpu_torch.runtime import checkpoint as ckpt, import_torch
    from lidal_tpu_torch.runtime.paths import Paths
    from lidal_tpu_torch.runtime.train_loop import init_state

    for family, export in (("Mink", import_torch.export_minkunet_state_dict),
                           ("SPVCNN", import_torch.export_spvcnn_state_dict)):
        cfg_f = dataclasses.replace(cfg, model_name=family, r_id=0,
                                    checkpoint_root=os.path.join(cfg.checkpoint_root, "imported"))
        source = init_state(dataclasses.replace(cfg_f, seed=SEED + 9), dev).model.eval()
        randomise_bn(source, SEED + 10)
        path = os.path.join(cfg.checkpoint_root, f"current_{family}.pt")
        sd = export(source.state_dict())
        torch.save({"model_state_dict": {f"module.{k}": v for k, v in sd.items()}, "iteration": 1234, "ep_id": 3}, path)
        t0 = time.perf_counter()
        import_torch_command(cfg_f, path, dev)
        seconds = time.perf_counter() - t0
        model = _load_eval_variables(cfg_f, dev)
        saved = torch.load(ckpt.ckpt_path(Paths(cfg_f).ckpt_dir()), map_location="cpu", weights_only=True)
        require((saved["iteration"], saved["ep_id"]) == (1234, 3), "imported step and epoch")
        eb = prepare_eval_batch(torch.Generator(device="cpu").manual_seed(SEED),
                                *(torch.as_tensor(batch[k], device=dev) for k in ("xyz", "sig", "valid")),
                                level_caps=cfg.data.level_caps, with_points=family == "SPVCNN")
        with torch.inference_mode():
            logits, _ = forward_batch(model, eb)
            logits_src, _ = forward_batch(source, eb)
        require(torch.equal(logits, logits_src), f"{family}: imported logits differ from the source model's")
        valid0 = eb.plan.levels[0].valid
        print(f"[28 import] {family}: {len(sd)} tensors in the torchsparse layout -> import_torch_command "
              f"({seconds:.2f} s) -> _load_eval_variables: logits on {NU_VAL_FRAMES} NU frames bit-equal to the "
              f"source model's ({int(valid0.sum())} valid voxels, std {float(logits[valid0].std()):.3f})")
        del source, model, eb, logits, logits_src
        torch.cuda.empty_cache()


def free_port() -> int:
    """A TCP port of 127.0.0.1 that nothing listens on now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def timed_run_train(cfg, dev, group=None):
    """run_train for 1 + TIMED_STEPS steps; steps/s of the timed ones (host
    clock; each step's loss read, as phase 8)."""
    from lidal_tpu_torch.runtime.train_loop import run_train

    times = []

    def on_step(step, loss):
        float(loss)  # waits for the step to finish
        times.append(time.perf_counter())

    run_train(cfg, max_iter=1 + TIMED_STEPS, log_every=10**9, on_step=on_step, device=dev, group=group)
    return TIMED_STEPS / (times[-1] - times[0])


def group_phase(cfg_train, cfg_eval, root, dev, batches, conf5, rate8):
    """29 (i): the group path in a world-size-1 NCCL group: ``run_train`` at
    B = 5 bit-equal to no group after 3 steps, with all-reduces counted, and
    its steps/s beside no group's (six turns) and
    phase 8's; ``run_eval`` through the group gives phase 5's confusion."""
    import torch
    import torch.distributed as dist

    from lidal_tpu_torch.models.minkunet import MinkUNet
    from lidal_tpu_torch.parallel import mesh
    from lidal_tpu_torch.runtime.evaluate import run_eval
    from lidal_tpu_torch.runtime.train_loop import run_train
    from lidal_tpu_torch.utils import profiling

    def cfg_at(tag):
        return dataclasses.replace(cfg_train, checkpoint_root=os.path.join(root, f"check_points_29_{tag}"))

    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    print(f"[29 group] NCCL group of one rank on {dev} in {time.perf_counter() - t0:.1f} s")
    group = dist.group.WORLD
    try:
        n0 = profiling.counter("all_reduce.calls")
        plain = run_train(cfg_at("plain"), max_iter=3, log_every=10**9, device=dev).model.state_dict()
        grouped = run_train(cfg_at("group"), max_iter=3, log_every=10**9, device=dev, group=group).model.state_dict()
        n_all_reduces = profiling.counter("all_reduce.calls") - n0
        differ = [k for k, v in plain.items() if not torch.equal(v, grouped[k])]
        require(not differ, f"3 steps through the group differ from 3 without it: {differ[:4]}")
        require(n_all_reduces > 0, "no all-reduce ran in the group's run_train")
        turns = ("plain", "group", "group", "plain", "plain", "group")
        rates = [timed_run_train(cfg_at(f"rate{i}"), dev, group if tag == "group" else None)
                 for i, tag in enumerate(turns)]
        by = {tag: sorted(r for t, r in zip(turns, rates) if t == tag) for tag in ("plain", "group")}
        small = torch.zeros(97, device=dev)  # a BN's count and channel sums
        t_ar = cuda_ms(lambda: [mesh.all_reduce_(small, group) for _ in range(n_all_reduces // 3)], reps=3)
        print(f"[29 group] run_train B = {cfg_train.data.batch_size}: after 3 steps {len(plain)} tensors bit-equal "
              f"with and without the group, {n_all_reduces} all-reduces ({n_all_reduces // 3} a step); steps/s in "
              f"turns {', '.join(f'{t} {r:.3f}' for t, r in zip(turns, rates))}: plain {by['plain'][0]:.3f}-"
              f"{by['plain'][-1]:.3f} (median {by['plain'][1]:.3f}), group {by['group'][0]:.3f}-{by['group'][-1]:.3f} "
              f"(median {by['group'][1]:.3f}); phase 8 {rate8:.3f}; a step's {n_all_reduces // 3} all-reduces "
              f"alone, of 97 floats each, take {t_ar:.2f} ms (CUDA events)")

        torch.manual_seed(SEED)  # phase 5's model and generator
        model = MinkUNet(num_classes=cfg_eval.data.num_classes).eval()
        randomise_bn(model, SEED + 1)
        model = model.to(dev)
        gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
        run_eval(cfg_eval, model, batches[:1], dev, gen, group=group)
        res = run_eval(cfg_eval, model, batches[1:], dev, gen, group=group)
        require(np.array_equal(res.confusion, conf5), "run_eval through the group differs from phase 5's confusion")
        print(f"[29 group] run_eval through the group: {TIMED_BATCHES} batches x {B}, confusion equal to phase 5's "
              f"({int(res.confusion.sum())} points)")
    finally:
        dist.destroy_process_group()


def gloo_rank(rank, port, cfg, max_iter, eval_files, out_dir, device, route=False):
    """29 (ii), one of two ranks on ``device`` joined by gloo: training of the
    global B = 4 (2 frames a rank) up to step ``max_iter``, then eval of
    global batches of 4; then steps/s of 1 + 5 steps from the seed at the
    same batch, and the time of a step's small all-reduces alone.  With
    ``route`` (30 (h)) all of it on the bf16 route: a spawned process starts
    from the modules' defaults, so the rank turns the route on itself."""
    import datetime

    import torch
    import torch.distributed as dist

    from lidal_tpu_torch.data import semantic_kitti as sk
    from lidal_tpu_torch.data.loader import FrameBatchLoader
    from lidal_tpu_torch.parallel import mesh
    from lidal_tpu_torch.runtime.evaluate import run_eval
    from lidal_tpu_torch.runtime.train_loop import run_train
    from lidal_tpu_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=300))
    try:
        group = dist.group.WORLD
        reset_launches()
        with bf16_route(route):
            state = run_train(cfg, max_iter=max_iter, device=dev, group=group)
            loader = FrameBatchLoader(eval_files, lambda p: sk.read_frame(p, with_labels=True),
                                      point_cap=cfg.data.point_cap, batch_size=4)
            res = run_eval(cfg, state.model, loader, dev, torch.Generator(device="cpu").manual_seed(SEED + 9),
                           group=group)
        if route:  # the rank's step and eval on the route: no f32 kernel
            read_route_launches(("lookup_sorted", "conv_gather_first", "conv_dx_dw_fused"))
        np.save(os.path.join(out_dir, f"confusion{rank}.npy"), res.confusion)
        np.save(os.path.join(out_dir, f"all_reduces{rank}.npy"), profiling.counter("all_reduce.calls"))
        n0 = profiling.counter("all_reduce.calls")
        with bf16_route(route):
            rate = timed_run_train(dataclasses.replace(cfg, checkpoint_root=os.path.join(out_dir, "timed")), dev, group)
        per_step = (profiling.counter("all_reduce.calls") - n0) // (1 + TIMED_STEPS)
        small = torch.zeros(97, device=dev)  # a BN's count and channel sums
        t_ar = cuda_ms(lambda: [mesh.all_reduce_(small, group) for _ in range(per_step)], reps=3)
        np.save(os.path.join(out_dir, f"timing{rank}.npy"), np.array([rate, per_step, t_ar]))
    finally:
        dist.destroy_process_group()


def step_distance(got, want):
    """Two state dicts after a train step: (parameter entries further apart
    than 1e-2 lr, parameter entries, the largest parameter difference, the
    largest BN-statistic difference over max(1, |want|))."""
    far = total = 0
    worst = stats = 0.0
    for name, w in want.items():
        d = (got[name] - w).abs()
        if "running" in name:
            stats = max(stats, float((d / w.abs().clamp_min(1.0)).max()))
            continue
        worst = max(worst, float(d.max()))
        far += int((d > 1e-2 * LR).sum())
        total += d.numel()
    return far, total, worst, stats


def gloo_phase(cfg_train, root, dev, route=False):
    """29 (ii): two processes on the one card joined by gloo (NCCL puts no two
    ranks on one GPU): one train step at a global B = 4 of the full-width
    MinkUNet from phase 8's trained state and Adam moments, as phase 9's step,
    against one process's B = 4 step from the same state (phase 9's
    tolerances; from a fresh Adam every near-zero gradient whose sign the sum
    order flips moves its weight by 2 lr), and the eval confusion of the
    group-trained weights against one process's.  With ``route`` (30 (h)) the
    ranks and the one process all on the bf16 route, with the same gates."""
    import torch
    import torch.multiprocessing as tmp_mp

    from lidal_tpu_torch.data import semantic_kitti as sk
    from lidal_tpu_torch.data.loader import FrameBatchLoader
    from lidal_tpu_torch.runtime import checkpoint as ckpt
    from lidal_tpu_torch.runtime.evaluate import run_eval
    from lidal_tpu_torch.runtime.paths import Paths
    from lidal_tpu_torch.runtime.train_loop import init_state, run_train

    tag, suffix = ("[30h gloo]", "_bf16") if route else ("[29 gloo]", "")
    out_dir = os.path.join(root, "gloo" + suffix)
    os.makedirs(out_dir)
    cfg2 = dataclasses.replace(cfg_train, checkpoint_root=os.path.join(root, "check_points_29_gloo" + suffix),
                               data_override=dataclasses.replace(cfg_train.data, batch_size=2))
    cfg1 = dataclasses.replace(cfg_train, checkpoint_root=os.path.join(root, "check_points_29_one" + suffix),
                               data_override=dataclasses.replace(cfg_train.data, batch_size=4))
    eval_files = sk.list_frames(cfg_train.data_root, ["00"])[:8]
    phase8 = ckpt.ckpt_path(Paths(cfg_train).ckpt_dir())
    for cfg in (cfg1, cfg2):
        os.makedirs(Paths(cfg).ckpt_dir())
        shutil.copy(phase8, ckpt.ckpt_path(Paths(cfg).ckpt_dir()))
    step0 = torch.load(phase8, weights_only=True)["iteration"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rank_dev = str(torch.device("cuda", torch.cuda.current_device())) if dev.type == "cuda" else str(dev)
    tmp_mp.start_processes(gloo_rank, args=(free_port(), cfg2, step0 + 1, eval_files, out_dir, rank_dev, route),
                           nprocs=2, join=True, start_method="spawn")
    t_ranks = time.perf_counter() - t0
    confs = [np.load(os.path.join(out_dir, f"confusion{r}.npy")) for r in range(2)]
    all_reduces = [int(np.load(os.path.join(out_dir, f"all_reduces{r}.npy"))) for r in range(2)]
    require(min(all_reduces) > 0 and np.array_equal(*confs), f"the ranks' results differ: {all_reduces}")

    reset_launches()
    with bf16_route(route):
        single = run_train(cfg1, max_iter=step0 + 1, log_every=10**9, device=dev).model.state_dict()
    if route:
        read_route_launches(("lookup_sorted", "conv_gather_first", "conv_dx_dw_fused"))
    trained = init_state(cfg2, dev)
    require(ckpt.restore_checkpoint(Paths(cfg2).ckpt_dir(), trained) is not None and trained.step == step0 + 1,
            "rank 0 wrote no checkpoint of its step")
    far, total, worst, stats = step_distance(trained.model.state_dict(), single)
    if not route:
        require(stats <= 1e-4, f"BN statistics differ by {stats:.2e} of max(1, |plain|)")  # phase 9's
        require(worst <= 2 * LR, f"a parameter after Adam differs by {worst}")
        require(far <= 1e-3 * total, f"{far} of {total} parameters differ by more than 1e-2 * lr after Adam")
        bar = f"(tol {2 * LR})"
    else:
        # On the route a reordered f32 sum ahead of a bf16 rounding (the ranks' BN sums) moves the few operands
        # near a rounding boundary by a whole bf16 step, and Adam turns a gradient's flipped sign into a 2 lr
        # move: the ranks' step is held to be no further from one process's than the f32 route's step from the
        # same state is from the route's; each weight within 2 lr plus its own f32 rounding.
        cfg1f = dataclasses.replace(cfg1, checkpoint_root=cfg1.checkpoint_root + "_f32")
        os.makedirs(Paths(cfg1f).ckpt_dir())
        shutil.copy(phase8, ckpt.ckpt_path(Paths(cfg1f).ckpt_dir()))
        f32 = run_train(cfg1f, max_iter=step0 + 1, log_every=10**9, device=dev).model.state_dict()
        far_f32, _, worst_f32, stats_f32 = step_distance(f32, single)
        require(stats <= max(1e-4, stats_f32), f"BN statistics differ by {stats:.2e} (the f32 route's {stats_f32:.2e})")
        require(worst <= 2 * LR * (1 + 1e-4), f"a parameter after Adam differs by {worst}")
        require(far <= far_f32, f"{far} of {total} parameters differ by more than 1e-2 * lr after Adam, the f32 "
                                f"route's step from one process's {far_f32}")
        bar = (f"(tol {2 * LR}); the f32 route's step against the route's from the same state: worst |d| "
               f"{worst_f32:.2e}, {far_f32} beyond 1e-2 * lr, BN statistics {stats_f32:.2e}; the ranks' BN "
               f"statistics {stats:.2e} of max(1, |x|)")
    model = trained.model.eval()
    loader = FrameBatchLoader(eval_files, lambda p: sk.read_frame(p, with_labels=True),
                              point_cap=cfg1.data.point_cap, batch_size=4)
    with bf16_route(route):
        rate1 = timed_run_train(dataclasses.replace(cfg1, checkpoint_root=os.path.join(out_dir, "timed1")), dev)
        res = run_eval(cfg1, model, loader, dev, torch.Generator(device="cpu").manual_seed(SEED + 9))
    rate2, per_step, t_ar = np.load(os.path.join(out_dir, "timing0.npy"))
    require(np.array_equal(res.confusion, confs[0]), "the two ranks' eval confusion differs from one process's")
    print(f"{tag} 2 processes on {dev} joined by gloo: train step {step0 + 1} at a global B = 4 (2 a rank) and "
          f"eval of {len(eval_files)} frames in {t_ranks:.1f} s (spawn, start-up and kernel loads included); "
          f"{all_reduces[0]} all-reduces a rank; after Adam worst |d| {worst:.2e} {bar}, {far} of {total} "
          f"parameters beyond 1e-2 * lr; eval confusion equal to one process's ({int(res.confusion.sum())} points)")
    print(f"{tag} train at a global B = 4, {TIMED_STEPS} steps after a warm-up from the seed: 2 gloo ranks on "
          f"the one card {rate2:.3f} steps/s, one process {rate1:.3f} steps/s ({rate2 / rate1:.2f}x); a step's "
          f"{int(per_step)} all-reduces through gloo, the small ones alone (97 floats each, CUDA tensors via the "
          f"host): {t_ar:.2f} ms")


def round_rank(rank, port, cfg, ranks_root, out_dir, device, route=False):
    """29 (iii), one of two ranks on ``device`` joined by gloo, on phase 12's
    tree and weights: ``run_prob_inference`` over this rank's share of the
    frames (``process_shard``), each map held here against the staged maps
    under ``cfg.processing_root`` (phase 12's), then
    ``run_fused_lidal_round`` over the group in ``ranks_root``.  With
    ``route`` (30 (h)) both on the bf16 route, turned on by the rank itself."""
    import datetime

    import torch
    import torch.distributed as dist

    from lidal_tpu_torch.active import lidal_runner
    from lidal_tpu_torch.data import semantic_kitti as sk
    from lidal_tpu_torch.parallel import mesh
    from lidal_tpu_torch.runtime.paths import Paths
    from lidal_tpu_torch.runtime.prob_inference import run_prob_inference
    from lidal_tpu_torch.runtime.train_loop import init_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=300))
    try:
        group = dist.group.WORLD
        model = init_state(cfg, dev).model.eval()
        randomise_bn(model, SEED + 7)  # phase 12's weights
        files = sk.list_frames(cfg.data_root, cfg.data.train_split)
        frame_index = {sk.frame_id(p): i for i, p in enumerate(files)}
        by_id = {sk.frame_id(p): p for p in files}
        inf_cfg = lidal_runner._prev_cfg(cfg)
        share = mesh.process_shard(len(files), group)
        with bf16_route(route):
            t0 = time.perf_counter()
            maps = run_prob_inference(inf_cfg, model, files[share.start : share.stop],
                                      lambda p: sk.read_frame(p, with_labels=False), sk.frame_id, save=False,
                                      device=dev, first_index=share.start)
            t_inf = time.perf_counter() - t0
            staged = Paths(inf_cfg)
            differ = [name for (seq, name), (prob, pred, _) in maps.items()
                      if not (np.array_equal(prob, np.load(os.path.join(staged.prob_dir(seq), f"{name}.npy")))
                              and np.array_equal(pred, np.load(os.path.join(staged.pred_dir(seq), f"{name}.npy"))))]
            mesh.sync_hosts("inference", group)
            reset_launches()
            t0 = time.perf_counter()
            res = lidal_runner.run_fused_lidal_round(
                dataclasses.replace(cfg, processing_root=ranks_root), model,
                lambda seq, name: sk.read_frame(by_id[(seq, name)], with_labels=False)[:2],
                frame_index=frame_index, device=dev, group=group,
            )
            t_fused = time.perf_counter() - t0
        launches = (read_route_launches(("lookup_sorted", "conv_gather_first", "nn_band")) if route
                    else read_launches(("lookup_sorted", "subm_conv", "nn_band")))
        torch.save({"inferred": sorted(maps), "differ": differ, "t_inf": t_inf, "t_fused": t_fused,
                    "launches": launches, "selection": [np.asarray(x) for x in res]},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def rank_round_phase(cfg, root, dev, selection12, fused_root=None, route=False):
    """29 (iii): phase 12's inference and fused round split over two gloo
    ranks on the card, as ``torchrun`` splits them over cards: every frame
    inferred by one rank, its maps bit-equal to the staged maps under
    ``cfg.processing_root`` (phase 12's); the fused round's selection on both
    ranks, its flags and its saved prob / pred maps (each written by the
    rank that owns the frame) identical to ``selection12`` and to the fused
    round's tree ``fused_root`` (phase 12's); ``nn_band`` launched once a
    frame over the two ranks.  With ``route`` (30 (h)) the ranks on the bf16
    route, held to the route's staged and fused rounds of 30 (f)."""
    import torch
    import torch.multiprocessing as tmp_mp

    from lidal_tpu_torch.active import lidal_runner
    from lidal_tpu_torch.runtime.paths import Paths

    fused12 = fused_root or os.path.join(root, "Processing_fused")  # phase 12's fused tree
    tag, suffix = ("[30h ranks]", "_bf16") if route else ("[29 ranks]", "")
    cfg_r = dataclasses.replace(cfg, processing_root=os.path.join(root, "Processing_ranks" + suffix))
    shutil.copytree(fused12, cfg_r.processing_root)
    prev_r, prev_12 = Paths(lidal_runner._prev_cfg(cfg_r)), Paths(lidal_runner._prev_cfg(
        dataclasses.replace(cfg, processing_root=fused12)))
    for d in (Paths(cfg_r).sv_flag_dir("00"), prev_r.prob_dir("00"), prev_r.pred_dir("00")):
        shutil.rmtree(d)  # the round writes them anew
    out_dir = os.path.join(root, "ranks" + suffix)
    os.makedirs(out_dir)
    torch.cuda.empty_cache()
    rank_dev = str(torch.device("cuda", torch.cuda.current_device())) if dev.type == "cuda" else str(dev)
    t0 = time.perf_counter()
    tmp_mp.start_processes(round_rank, args=(free_port(), cfg, cfg_r.processing_root, out_dir, rank_dev, route),
                           nprocs=2, join=True, start_method="spawn")
    t_ranks = time.perf_counter() - t0
    got = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    inferred = got[0]["inferred"] + got[1]["inferred"]
    require(len(inferred) == ROUND_FRAMES == len(set(inferred)), f"{len(inferred)} frames inferred by the ranks")
    require(not got[0]["differ"] and not got[1]["differ"],
            f"prob / pred of {got[0]['differ'] + got[1]['differ']}: the ranks differ from phase 12's")
    nn_band = got[0]["launches"]["nn_band"] + got[1]["launches"]["nn_band"]
    require(nn_band == ROUND_FRAMES, f"nn_band launched {nn_band} times for {ROUND_FRAMES} frames by two ranks")
    for g in got:
        for a, b in zip(selection12, g["selection"]):
            require(np.array_equal(a, b), "a rank's selection differs from phase 12's")
    for i in range(ROUND_FRAMES):
        name = f"{i:06d}.npy"
        for want, have in ((Paths(dataclasses.replace(cfg, processing_root=fused12)).sv_flag_dir("00"),
                            Paths(cfg_r).sv_flag_dir("00")), (prev_12.prob_dir("00"), prev_r.prob_dir("00")),
                           (prev_12.pred_dir("00"), prev_r.pred_dir("00"))):
            require(np.array_equal(np.load(os.path.join(want, name)), np.load(os.path.join(have, name))),
                    f"{have}/{name} differs from phase 12's")
    t_inf = max(g["t_inf"] for g in got)
    t_fused = max(g["t_fused"] for g in got)
    print(f"{tag} 2 gloo ranks on {dev} in {t_ranks:.1f} s (spawn and start-up included): run_prob_inference "
          f"{ROUND_FRAMES} frames x {cfg.inf_reps} views ({len(got[0]['inferred'])} + {len(got[1]['inferred'])}) in "
          f"{t_inf:.2f} s ({ROUND_FRAMES / t_inf:.3f} frames/s), maps bit-equal to one process's staged round; "
          f"run_fused_lidal_round in {t_fused:.2f} s ({ROUND_FRAMES / t_fused:.3f} frames/s), selection, flags and "
          f"saved maps identical to one process's fused round ({len(selection12.al_added)} + "
          f"{len(selection12.sl_added)} supervoxels); launches rank 0 "
          f"{got[0]['launches']}, rank 1 {got[1]['launches']}")


# ---- 30. the bf16 route (the JAX package's Pallas route on its TPU) ---------------------------------------------

F32_KERNELS = ("subm_conv", "conv_dx_dw", "gather8", "scatter8", "child_sum")  # none may launch on the bf16 route


def bf16_route(on: bool = True):
    """``ops/conv.bf16_route(on)``: within, ``ops/conv.BF16_OPERANDS`` and
    ``ops/cuda_gather8.SCATTER8_BF16`` (the counterparts of the JAX package's
    ``conv.USE_PALLAS`` and ``pallas_gather8.USE_PALLAS_BWD``) set to ``on``;
    both restored after."""
    from lidal_tpu_torch.ops import conv

    return conv.bf16_route(on)


def read_route_launches(expected) -> dict:
    """read_launches after a main path on the bf16 route: the kernels named in
    ``expected`` launched, and no f32 conv, backward, gather8 or scatter8."""
    counts = read_launches(expected)
    leaked = {k: counts[k] for k in F32_KERNELS if counts[k]}
    require(not leaked, f"f32 kernels launched on the bf16 route: {leaked}")
    return counts


def _bf16(x):
    return x.bfloat16().float()


def selection_overlap(a, b) -> float:
    """|A n B| / |A u B| of two arrays of supervoxel ids (0 when both are empty)."""
    x, y = set(np.asarray(a).tolist()), set(np.asarray(b).tolist())
    return len(x & y) / max(1, len(x | y))


def route_forward_phase(model, eb):
    """30 (a): every ``conv_gather_first`` call of one B = 4 eval forward on the
    route (its eval-BN epilogue, K = 27, down and up maps) against its plain
    version: within PROBE_TOL of ``abs-sum * |scale| + |shift|``, no further
    from f64 than F64_FACTOR times the plain version, rows with no real tap
    exactly 0, bit-equal on a rerun.  Per shape and per forward: the wrapper
    (casts to the bf16 table and packed weights included), the kernel alone
    on packed operands, the casts, the plain version, the f32 ``subm_conv``
    kernel on the same arguments, the bound at the bf16 tensor-core rate.
    Returns the record fields of ``subm_conv_bf16``."""
    import torch

    from lidal_tpu_torch.ops import cuda_conv, cuda_conv_bf16 as cb

    captured, calls = {}, {}
    kernel = cb.conv_gather_first

    def recorder(feats, w, nbr, pipelined=False, scale=None, shift=None, relu=False):
        key = (nbr.shape[1], feats.shape[1], w.shape[2], relu, nbr.shape[0], feats.shape[0])
        calls[key] = calls.get(key, 0) + 1
        if key not in captured:
            captured[key] = (feats.clone(), w.clone(), nbr.clone(), scale.clone(), shift.clone(), relu)
        return kernel(feats, w, nbr, pipelined, scale, shift, relu)

    cb.conv_gather_first = recorder
    try:
        with torch.inference_mode(), bf16_route():
            model(eb.feats, eb.plan)
    finally:
        cb.conv_gather_first = kernel
    require(sum(calls.values()) == 42, f"{sum(calls.values())} conv_gather_first calls in one forward, not 42")
    err = 0.0
    total = {"ms": 0.0, "packed": 0.0, "casts": 0.0, "plain": 0.0, "f32": 0.0}
    least = Bound()
    with torch.inference_mode():
        for key in sorted(captured):
            feats, w, nbr, scale, shift, relu = args = captured[key]
            k, cin, cout, _, m, n = key
            c = calls[key]
            got = kernel(feats, w, nbr, scale=scale, shift=shift, relu=relu)
            require(torch.equal(kernel(feats, w, nbr, scale=scale, shift=shift, relu=relu), got),
                    f"conv_gather_first {key}: two runs differ")
            want = cb.conv_gather_first_plain(feats, w, nbr, scale=scale, shift=shift, relu=relu)
            bound = cb.conv_gather_first_plain(feats.abs(), w.abs(), nbr) * scale.abs() + shift.abs()
            ref = cuda_conv.subm_conv_plain(_bf16(feats).double(), _bf16(w).double(), nbr, scale.double(),
                                            shift.double(), relu)
            d = (got - want).abs()
            require(bool(got.isfinite().all()) and bool((d <= PROBE_TOL * bound).all()),
                    f"conv_gather_first {key}: max |kernel - plain| {float(d.max())}")
            e_k, e_p = float((got.double() - ref).abs().max()), float((want.double() - ref).abs().max())
            require(e_k <= F64_FACTOR * e_p + 1e-6 * float(bound.max()),
                    f"conv_gather_first {key}: {e_k:.2e} from f64 against the plain version's {e_p:.2e}")
            empty = ~((nbr >= 0) & (nbr < n)).any(1)
            require(not bool(got[empty].any()), f"conv_gather_first {key}: a row with no real tap is not 0")
            e = float(d.max())
            err = max(err, e)
            del want, bound, ref, d
            table, wt = cb.pack_table(feats), cb.pack_weights(w)
            pairs, row_bytes = bf16_rows_bytes(nbr, n, 2 * table.shape[1])
            b_ms = least.add(row_bytes + nbytes(wt, nbr, scale, shift, got), 2.0 * pairs * cin * cout, PEAK_BF16, calls=c)
            ms = {
                "ms": cuda_ms(lambda: kernel(feats, w, nbr, scale=scale, shift=shift, relu=relu)),
                "packed": cuda_ms(lambda: cb.gather_first_packed(table, wt, nbr, scale=scale, shift=shift, relu=relu)),
                "casts": cuda_ms(lambda: (cb.pack_table(feats), cb.pack_weights(w))),
                "plain": cuda_ms(lambda: cb.conv_gather_first_plain(feats, w, nbr, scale=scale, shift=shift, relu=relu),
                                 reps=3),
                "f32": cuda_ms(lambda: cuda_conv.subm_conv(feats, w, nbr, scale, shift, relu)),
            }
            for name in total:
                total[name] += c * ms[name]
            print(f"[30a forward] K={k} cin={cin} cout={cout} relu={int(relu)} m={m} n={n} x{c}: max|d|={e:.2e}, from f64 "
                  f"{e_k:.1e} (plain {e_p:.1e}), empty rows 0, bit-equal on a rerun; wrapper {ms['ms']:.3f} ms (kernel alone "
                  f"{ms['packed']:.3f}, casts {ms['casts']:.3f}), plain {ms['plain']:.3f} ms, f32 subm_conv {ms['f32']:.3f} "
                  f"ms, bound {b_ms:.3f} ms ({pairs} real pairs)")
            del got, table, wt
    print(f"[30a forward] {len(captured)} shapes, {sum(calls.values())} calls per B = {B} forward, every one within "
          f"{PROBE_TOL} of the abs-sum and {F64_FACTOR}x the plain version's distance from f64; per forward: wrapper "
          f"{total['ms']:.2f} ms (kernel alone {total['packed']:.2f}, casts {total['casts']:.2f}), plain "
          f"{total['plain']:.1f} ms, f32 subm_conv kernel {total['f32']:.2f} ms, bound {least.total:.3f} ms (by {least.by})")
    return {"max_abs_err": err, "ms": total["ms"], "plain_ms": total["plain"], "bound_ms": least.total,
            "bound_by": least.by, "library_ms": None}


def route_backward_phase(state, tb):
    """30 (a): every ``conv_dx_dw_fused`` call of one B = 5 MinkUNet train step on
    the route (the stem's dW alone) against its plain version: dx and dw
    within PROBE_TOL of the abs-sum, no further from f64 than F64_FACTOR times
    the plain version, bit-equal on a rerun; ms per shape beside the f32
    ``conv_dx_dw`` kernel on the same arguments, and on the stem the dW-only
    call beside the dx + dW call.  Returns the record fields of ``conv_dx_dw_bf16``."""
    import torch

    from lidal_tpu_torch.ops import cuda_conv_bf16 as cb, cuda_conv_dxdw, cuda_conv_dxdw_fused as fz
    from lidal_tpu_torch.runtime.train import train_step

    captured, calls = {}, {}
    kernel = fz.conv_dx_dw_fused

    def recorder(src, w2, nbr, f, mode="dx_dw", need_dx=True):
        require(mode == "dx_dw", f"the route's backward asked for mode {mode}")
        key = (nbr.shape[1], src.shape[1], w2.shape[2], f.shape[1], nbr.shape[0], src.shape[0], bool(need_dx))
        calls[key] = calls.get(key, 0) + 1
        if key not in captured:
            captured[key] = (src.clone(), w2.clone(), nbr.clone(), f.clone(), bool(need_dx))
        return kernel(src, w2, nbr, f, mode, need_dx)

    fz.conv_dx_dw_fused = recorder
    try:
        with bf16_route():
            train_step(state, tb)
    finally:
        fz.conv_dx_dw_fused = kernel
    require(sum(calls.values()) == 42, f"{sum(calls.values())} conv_dx_dw_fused calls in one step, not 42")
    require(sum(c for key, c in calls.items() if not key[6]) == 1, "one call a step, the stem's, takes dW alone")
    err = 0.0
    total = {"ms": 0.0, "plain": 0.0, "f32": 0.0}
    least = Bound()
    for key in sorted(captured):
        src, w2, nbr, f, need_dx = captured[key]
        k, c_src, c_dst, c_f, m, n, _ = key
        c = calls[key]
        dx, dw = kernel(src, w2, nbr, f, "dx_dw", need_dx)
        dx2, dw2 = kernel(src, w2, nbr, f, "dx_dw", need_dx)
        require(torch.equal(dw, dw2) and (dx is None if not need_dx else torch.equal(dx, dx2)),
                f"conv_dx_dw_fused {key}: two runs differ")
        want = fz.conv_dx_dw_fused_plain(src, w2, nbr, f, "dx_dw", need_dx)
        bound = fz.conv_dx_dw_fused_plain(src.abs(), w2.abs(), nbr, f.abs(), "dx_dw", need_dx)
        ref = cuda_conv_dxdw.conv_dx_dw_plain(_bf16(src).double(), _bf16(w2).double(), nbr, _bf16(f).double(), need_dx)
        notes = []
        for name, got, p, r, b in zip(("dx", "dw"), (dx, dw), want, ref, bound):
            if got is None:
                continue
            d = (got - p).abs()
            require(bool(got.isfinite().all()) and bool((d <= PROBE_TOL * b).all()),
                    f"conv_dx_dw_fused {key}: {name} max |kernel - plain| {float(d.max())}")
            e_k, e_p = float((got.double() - r).abs().max()), float((p.double() - r).abs().max())
            require(e_k <= F64_FACTOR * e_p + 1e-6 * float(b.max()),
                    f"conv_dx_dw_fused {key}: {name} {e_k:.2e} from f64 against the plain version's {e_p:.2e}")
            err = max(err, float(d.max()))
            notes.append(f"{name} from f64 {e_k:.1e} (plain {e_p:.1e})")
        del want, bound, ref, dx2, dw2
        pairs, row_bytes = bf16_rows_bytes(nbr, n, 2 * c_src)
        b_ms = least.add(row_bytes + nbytes(nbr, dx, dw) + 2 * ((w2.numel() if need_dx else 0) + f.numel()),
                         2.0 * pairs * c_src * ((c_dst if need_dx else 0) + c_f), PEAK_BF16, calls=c)
        del dx, dw
        k_ms = cuda_ms(lambda: kernel(src, w2, nbr, f, "dx_dw", need_dx), reps=3)
        p_ms = cuda_ms(lambda: fz.conv_dx_dw_fused_plain(src, w2, nbr, f, "dx_dw", need_dx), reps=2)
        f_ms = cuda_ms(lambda: cuda_conv_dxdw.conv_dx_dw(src, w2, nbr, f, need_dx), reps=3)
        total["ms"] += c * k_ms
        total["plain"] += c * p_ms
        total["f32"] += c * f_ms
        stem = ""
        if not need_dx:  # what taking dW alone saves on the stem
            both = cuda_ms(lambda: kernel(src, w2, nbr, f, "dx_dw"), reps=3)
            stem = f"; the same call with dx (padded to {fz.padded_channels(c_src, c_dst, c_f)[1]} columns) {both:.3f} ms"
        print(f"[30a backward] K={k} c_src={c_src} c_dst={c_dst} c_f={c_f} m={m} n={n} dx={int(need_dx)} x{c}: "
              f"{', '.join(notes)}, bit-equal across runs; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, f32 conv_dx_dw "
              f"{f_ms:.3f} ms, bound {b_ms:.3f} ms ({pairs} real pairs){stem}")
    print(f"[30a backward] {len(captured)} shapes, {sum(calls.values())} calls per B = {tb.feats.shape[0]} train step, "
          f"within {PROBE_TOL} of the abs-sum and {F64_FACTOR}x the plain version's distance from f64; per step: "
          f"kernel {total['ms']:.2f} ms, plain {total['plain']:.1f} ms, f32 conv_dx_dw kernel {total['f32']:.2f} ms, "
          f"bound {least.total:.3f} ms (by {least.by})")
    return {"max_abs_err": err, "ms": total["ms"], "plain_ms": total["plain"], "bound_ms": least.total,
            "bound_by": least.by, "library_ms": None}


def route_scatter8_phase(state, tb):
    """30 (a): both ``scatter8`` calls of one SPVCNN B = 5 train step on the route
    (``dy`` and ``w8`` rounded to bf16 as the kernel reads them) against the
    plain version: within PROBE_TOL of ``sum |w8| |dy|``, no further from f64
    than F64_FACTOR times the plain version, bit-equal on a rerun and to the f32
    kernel on operands rounded beforehand, allocating what the f32 instance
    does (no bf16 copy of ``dy``); ms beside the plain version, the f32
    instance and ``embedding_bag``'s backward on the same rounded operands.
    Returns the record fields of ``scatter8_bf16``."""
    import torch
    import torch.nn.functional as F

    from lidal_tpu_torch.ops import cuda_gather8
    from lidal_tpu_torch.runtime.train import train_step

    captured = {}
    kernel, plain = cuda_gather8.scatter8, cuda_gather8.scatter8_plain

    def recorder(dy, nbr, w8, n, bf16=False):
        require(bf16, "scatter8 on the bf16 route without bf16 rows")
        captured[(dy.shape[0], n, dy.shape[1])] = (dy.clone(), nbr.clone(), w8.clone(), n)
        return kernel(dy, nbr, w8, n, True)

    cuda_gather8.scatter8 = recorder
    try:
        with bf16_route():
            train_step(state, tb, DROPOUT_SEEDS[: len(tb.feats)])
    finally:
        cuda_gather8.scatter8 = kernel
    require(len(captured) == 2, f"{len(captured)} scatter8 shapes in one train step, not 2")
    err = 0.0
    total = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "f32": 0.0}
    least = Bound()
    for key in sorted(captured):
        dy, nbr, w8, n = captured[key]
        m, _, c = key
        got = kernel(dy, nbr, w8, n, True)
        require(torch.equal(got, kernel(dy, nbr, w8, n, True)), f"scatter8 bf16 {key}: two runs differ")
        require(torch.equal(got, kernel(_bf16(dy), nbr, _bf16(w8), n)),
                f"scatter8 bf16 {key}: differs from the f32 kernel on operands rounded beforehand")
        require(allocations(lambda: kernel(dy, nbr, w8, n, True)) == allocations(lambda: kernel(dy, nbr, w8, n)) == 2,
                f"scatter8 bf16 {key}: the route allocated more than the f32 instance")
        want = plain(dy, nbr, w8, n, True)
        abs_sum = plain(dy.abs(), nbr, w8.abs(), n, True)
        ref = plain(_bf16(dy).double(), nbr, _bf16(w8).double(), n)
        d = (got - want).abs()
        require(bool(got.isfinite().all()) and bool((d <= PROBE_TOL * abs_sum).all()),
                f"scatter8 bf16 {key}: max |kernel - plain| {float(d.max())}")
        e_k, e_p = float((got.double() - ref).abs().max()), float((want.double() - ref).abs().max())
        require(e_k <= F64_FACTOR * e_p + 1e-6 * float(abs_sum.max()),
                f"scatter8 bf16 {key}: {e_k:.2e} from f64 against the plain version's {e_p:.2e}")
        err = max(err, float(d.max()))
        real = (nbr >= 0) & (nbr < n)
        pairs, rows = int(real.sum()), int(real.any(dim=1).sum())
        b_ms = least.add(nbytes(nbr, w8, got) + 4.0 * rows * c, 2.0 * pairs * c)  # the f32 rows of dy it reads
        del want, abs_sum, ref, d
        fx = torch.zeros((n + 1, c), device=dy.device, requires_grad=True)
        bag = F.embedding_bag(nbr, fx, per_sample_weights=_bf16(w8), mode="sum", padding_idx=n)
        dyb = _bf16(dy)
        lib = torch.autograd.grad(bag, fx, dyb, retain_graph=True)[0][:n]
        require(torch.allclose(lib, got, rtol=1e-3, atol=1e-3 * float(got.abs().max())),
                f"scatter8 bf16 {key}: the backward of embedding_bag computes another function")
        ms = {
            "ms": cuda_ms(lambda: kernel(dy, nbr, w8, n, True)),
            "f32": cuda_ms(lambda: kernel(dy, nbr, w8, n)),
            "plain": cuda_ms(lambda: plain(dy, nbr, w8, n, True), reps=3),
            "lib": cuda_ms(lambda: torch.autograd.grad(bag, fx, dyb, retain_graph=True), reps=3),
        }
        del bag, fx, lib
        for name in total:
            total[name] += ms[name]
        print(f"[30a scatter8] m={m} n={n} c={c}: dy and w8 rounded to bf16, within {PROBE_TOL} of sum |w8||dy|, from "
              f"f64 {e_k:.1e} (plain {e_p:.1e}), bit-equal across runs and to the f32 kernel on rounded operands, no "
              f"bf16 copy; kernel {ms['ms']:.3f} ms (the f32 instance {ms['f32']:.3f}), plain {ms['plain']:.3f} ms, "
              f"embedding_bag backward {ms['lib']:.3f} ms, bound {b_ms:.3f} ms ({pairs} real pairs from {rows} rows)")
    print(f"[30a scatter8] 2 calls per train step: kernel {total['ms']:.3f} ms (the f32 instance {total['f32']:.3f}), "
          f"plain {total['plain']:.2f} ms, "
          f"embedding_bag backward {total['lib']:.2f} ms, bound {least.total:.3f} ms (by {least.by})")
    return {"max_abs_err": err, "ms": total["ms"], "plain_ms": total["plain"], "bound_ms": least.total,
            "bound_by": least.by, "library_ms": total["lib"]}


def route_eval_phase(cfg, model, batches, prepare, dev, caps, b=B, n_pts=N_PTS, tag=None):
    """30 (b), and (e) on nuScenes: ``run_eval`` over the timed batches (each
    of ``b`` frames of ``n_pts`` points) on the f32 route and on the bf16
    route in turns (f32, bf16, bf16, f32; each after its warm-up), points/s
    of both, each kernel's launches in the first bf16 run; then one batch's
    logits on the bf16 route against the f32 route's: finite, 0 on invalid
    rows, argmax agreement at least ROUTE_ARGMAX_AGREE, bit-equal on a rerun.
    Returns the launches of that run."""
    import torch

    from lidal_tpu_torch.data.pipeline import forward_batch
    from lidal_tpu_torch.runtime.evaluate import run_eval

    spvcnn = cfg.is_spvcnn
    tag = tag or f"[30b eval {cfg.model_name}]"
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    with bf16_route():
        run_eval(cfg, model, batches[:1], dev, gen)  # warm-up of the route
    rates, launches = {"f32": [], "bf16": []}, None
    for route in ("f32", "bf16", "bf16", "f32"):
        torch.cuda.synchronize()
        first = route == "bf16" and launches is None
        if first:
            reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with bf16_route() if route == "bf16" else contextlib.nullcontext():
            start.record()
            res = run_eval(cfg, model, batches[1:], dev, gen)
            end.record()
            torch.cuda.synchronize()
        if first:
            launches = read_route_launches(("lookup_sorted", "conv_gather_first") +
                                           (("gather8_bf16", "child_sum_bf16") if spvcnn else ()))
        require(res.points == TIMED_BATCHES * b * n_pts, f"points evaluated {res.points}")
        rates[route].append(res.points / (start.elapsed_time(end) / 1e3))
    require(launches["conv_gather_first"] == 42 * TIMED_BATCHES and
            launches["gather8_bf16"] == launches["child_sum_bf16"] == (2 * TIMED_BATCHES if spvcnn else 0),
            f"launches on the route in {TIMED_BATCHES} batches: {launches}")
    eb = prepare(batches[1], SEED, spvcnn)
    with torch.inference_mode():
        f32, _ = forward_batch(model, eb)
        with bf16_route():
            bf, _ = forward_batch(model, eb)
            bf2, _ = forward_batch(model, eb)
    valid0 = eb.plan.levels[0].valid
    require(bool(bf.isfinite().all()) and not bool(bf[~valid0].any()), "logits on the route: non-finite or on invalid rows")
    require(torch.equal(bf, bf2), "the route's logits differ between two runs")
    share = float((bf - f32).abs().max() / f32.abs().max())
    rms = float((bf - f32)[valid0].square().mean().sqrt() / f32[valid0].square().mean().sqrt())
    agree = float((bf.argmax(-1) == f32.argmax(-1))[valid0].float().mean())
    require(agree >= ROUTE_ARGMAX_AGREE, f"argmax agreement of the bf16 and f32 routes {agree}")
    print(f"{tag} run_eval, {TIMED_BATCHES} batches x {b} x {n_pts} points, in turns f32, bf16, bf16, f32: "
          f"f32 {', '.join(f'{r:,.0f}' for r in rates['f32'])} points/s, bf16 {', '.join(f'{r:,.0f}' for r in rates['bf16'])} "
          f"points/s (bf16 / f32 by the means {np.mean(rates['bf16']) / np.mean(rates['f32']):.3f}); launches on the route "
          f"{launches}; logits bf16 vs f32 on one batch: max|d| / max|f32| {share:.3e}, rms {rms:.3e}, argmax agreement "
          f"{agree:.6f} over {int(valid0.sum())} valid voxels (gate {ROUTE_ARGMAX_AGREE}), bit-equal on a rerun")
    return launches


def route_train_phase(cfg_train, root, dev, tag=None):
    """30 (c), and (e) on nuScenes: ``run_train`` (1 + TIMED_STEPS steps from ``init_state``'s seeded
    state, the same batches) on the f32 and the bf16 route in turns (f32,
    bf16, bf16, f32), each from a fresh checkpoint directory: steps/s of
    both, each step's loss on both (the first step's from the same state
    within ROUTE_LOSS_TOL relative), the bf16 runs bit-equal to each other,
    each kernel's launches in the first bf16 run.  Returns those launches."""
    import torch

    from lidal_tpu_torch.runtime.train_loop import run_train

    spvcnn = cfg_train.is_spvcnn
    tag = tag or f"[30c train {cfg_train.model_name}]"
    runs, launches = [], None
    turns = ("f32", "bf16", "bf16", "f32") if not spvcnn else ("bf16", "f32")
    for i, route in enumerate(turns):
        cfg = dataclasses.replace(cfg_train, checkpoint_root=os.path.join(root, f"check_points_30_{cfg_train.model_name}_{i}"))
        times, losses = [], []

        def on_step(step, loss):
            losses.append(float(loss))  # waits for the step
            times.append(time.perf_counter())

        first = route == "bf16" and launches is None
        if first:
            reset_launches()
        with bf16_route() if route == "bf16" else contextlib.nullcontext():
            state = run_train(cfg, max_iter=1 + TIMED_STEPS, log_every=10**9, on_step=on_step, device=dev)
        torch.cuda.synchronize()
        if first:
            launches = read_route_launches(("lookup_sorted", "conv_gather_first", "conv_dx_dw_fused") +
                                           (("gather8_bf16", "child_sum_bf16", "scatter8_bf16") if spvcnn else ()))
        require(state.step == 1 + TIMED_STEPS and all(np.isfinite(losses)), f"{route}: {state.step} steps, losses {losses}")
        runs.append((route, TIMED_STEPS / (times[-1] - times[0]), losses))
        del state
    steps = 1 + TIMED_STEPS
    require(launches["conv_dx_dw_fused"] == 42 * steps and launches["conv_gather_first"] == 42 * steps and
            tuple(launches[k] for k in ("gather8_bf16", "child_sum_bf16", "scatter8_bf16")) ==
            ((2 * steps,) * 3 if spvcnn else (0, 0, 0)),
            f"launches on the route in {steps} steps: {launches}")
    bf = [r for r in runs if r[0] == "bf16"]
    f32 = [r for r in runs if r[0] == "f32"]
    require(all(r[2] == bf[0][2] for r in bf), f"the bf16 runs' losses differ: {[r[2] for r in bf]}")
    first_d = abs(bf[0][2][0] - f32[0][2][0]) / abs(f32[0][2][0])
    require(first_d <= ROUTE_LOSS_TOL, f"the first step's loss on the two routes from one state differs by {first_d:.2e}")
    print(f"{tag} run_train B = {cfg_train.data.batch_size}, {TIMED_STEPS} steps after 1, in turns "
          f"{', '.join(r[0] for r in runs)}: steps/s {', '.join(f'{r[0]} {r[1]:.3f}' for r in runs)} (bf16 / f32 by the "
          f"means {np.mean([r[1] for r in bf]) / np.mean([r[1] for r in f32]):.3f}); losses f32 "
          f"{[round(x, 5) for x in f32[0][2]]}, bf16 {[round(x, 5) for x in bf[0][2]]} (the first step from one state: "
          f"{first_d:.2e} relative, tol {ROUTE_LOSS_TOL}; the bf16 runs bit-equal); launches on the route {launches}")
    return launches


def route_round_phase(cfg, root, dev, selection12, n_sv):
    """30 (d): phase 12's fused MinkUNet LiDAL round (the same weights, frames
    and prepared tree) on the bf16 route, twice: frames/s, the prob maps,
    flags and selection bit-equal between the two runs, both within the
    budget; the selected supervoxels against phase 12's f32 round (counts and
    |A n B| / |A u B|, recorded, not gated).  Returns the launches of the first run."""
    import torch

    from lidal_tpu_torch.active import lidal, lidal_runner
    from lidal_tpu_torch.data import semantic_kitti as sk
    from lidal_tpu_torch.runtime.paths import Paths
    from lidal_tpu_torch.runtime.train_loop import init_state

    model = init_state(cfg, dev).model.eval()
    randomise_bn(model, SEED + 7)  # phase 12's weights
    files = sk.list_frames(cfg.data_root, cfg.data.train_split)
    frame_index = {sk.frame_id(p): i for i, p in enumerate(files)}
    by_id = {sk.frame_id(p): p for p in files}
    fused12 = os.path.join(root, "Processing_fused")  # phase 12's fused tree
    limit = round(lidal.BUDGET_FRAC * cfg.data.train_point_num)
    pnums = []
    select = lidal.select

    def recording_select(*args, **kwargs):
        pnums.append(np.array(args[3]))
        return select(*args, **kwargs)

    runs = []
    lidal.select = recording_select
    try:
        for i in range(2):
            cfg_r = dataclasses.replace(cfg, processing_root=os.path.join(root, f"Processing_bf16_{i}"))
            shutil.copytree(fused12, cfg_r.processing_root)
            prev = Paths(lidal_runner._prev_cfg(cfg_r))
            for d in (Paths(cfg_r).sv_flag_dir("00"), prev.prob_dir("00"), prev.pred_dir("00")):
                shutil.rmtree(d)  # the round writes them anew
            if i == 0:
                reset_launches()
            t0 = time.perf_counter()
            with bf16_route():
                res = lidal_runner.run_fused_lidal_round(
                    cfg_r, model, lambda seq, name: sk.read_frame(by_id[(seq, name)], with_labels=False)[:2],
                    frame_index=frame_index, device=dev,
                )
            seconds = time.perf_counter() - t0
            if i == 0:
                launches = read_route_launches(("lookup_sorted", "conv_gather_first", "nn_band"))
            runs.append((res, seconds, cfg_r))
    finally:
        lidal.select = select
    require(launches["nn_band"] == ROUND_FRAMES and launches["conv_gather_first"] > 0, f"launches {launches}")
    (a, t_a, cfg_a), (b, t_b, cfg_b) = runs
    for x, y in zip(a, b):
        require(np.array_equal(x, y), "the bf16 round's selection differs between two runs")
    pa, pb = Paths(lidal_runner._prev_cfg(cfg_a)), Paths(lidal_runner._prev_cfg(cfg_b))
    for i in range(ROUND_FRAMES):
        name = f"{i:06d}.npy"
        for da, db in ((pa.prob_dir("00"), pb.prob_dir("00")), (pa.pred_dir("00"), pb.pred_dir("00")),
                       (Paths(cfg_a).sv_flag_dir("00"), Paths(cfg_b).sv_flag_dir("00"))):
            require(np.array_equal(np.load(os.path.join(da, name)), np.load(os.path.join(db, name))),
                    f"{name}: the bf16 round's maps or flags differ between two runs")
    require(len(a.sv_flags) == n_sv and len(a.al_added) > 0 and len(a.sl_added) > 0, "the bf16 round selected nothing")
    sv_pnums = pnums[0]
    used = {"bf16": int(sv_pnums[a.al_added].sum()), "f32": int(sv_pnums[selection12.al_added].sum())}
    for route, res in (("bf16", a), ("f32", selection12)):
        for kind in ("al_added", "sl_added"):  # each greedy pass stays within the budget
            require(int(sv_pnums[getattr(res, kind)].sum()) <= limit, f"the {route} round's {kind} exceed the budget")

    print(f"[30d round] run_fused_lidal_round on the bf16 route (phase 12's weights, {ROUND_FRAMES} frames x {cfg.inf_reps} "
          f"views): {t_a:.2f} s, {t_b:.2f} s = {ROUND_FRAMES / t_a:.3f}, {ROUND_FRAMES / t_b:.3f} frames/s; prob / pred "
          f"maps, flags and selection bit-equal across the two runs; launches {launches}")
    print(f"[30d round] selections, bf16 against phase 12's f32 round: labels {len(a.al_added)} against "
          f"{len(selection12.al_added)} supervoxels ({used['bf16']} and {used['f32']} points of a budget of {limit}), "
          f"overlap |A n B| / |A u B| {selection_overlap(a.al_added, selection12.al_added):.4f}; pseudo labels {len(a.sl_added)} "
          f"against {len(selection12.sl_added)}, overlap {selection_overlap(a.sl_added, selection12.sl_added):.4f}")
    for _, _, c in runs:
        shutil.rmtree(c.processing_root, ignore_errors=True)
    del model
    torch.cuda.empty_cache()
    return launches


# ---- 30 (e)-(h). the bf16 route on nuScenes, SPVCNN and staged rounds, three rounds and ranks ------------------


def route_round_tree(cfg, src_root, dst_root, seq, flags_from):
    """A processing tree for one round of ``cfg`` under ``dst_root``: the
    grids and supervoxels of the prepared tree ``src_root`` and, as the
    previous round's flags of ``cfg``'s model, the directory ``flags_from``.
    Returns ``cfg`` on the copy."""
    from lidal_tpu_torch.runtime.paths import Paths

    for part in ("grid", "super_voxel"):
        shutil.copytree(os.path.join(src_root, cfg.dataset_name, part), os.path.join(dst_root, cfg.dataset_name, part))
    cfg_r = dataclasses.replace(cfg, processing_root=dst_root)
    shutil.copytree(flags_from, Paths(cfg_r).sv_flag_dir(seq, r_id=cfg.r_id - 1))
    return cfg_r


def route_lidal_round(cfg, model, files, read_fn, frame_id, dev, staged=False):
    """One LiDAL round of ``cfg`` on the bf16 route over ``files``: staged
    (``run_prob_inference``, then ``run_lidal_round``) or fused
    (``run_fused_lidal_round``).  ``read_fn(file, with_labels=False)`` gives
    (xyz, sig, ...).  Returns (its selection, the arrays the selection saw,
    seconds, each kernel's launches: no f32 kernel, ``nn_band`` once a
    frame)."""
    import torch

    from lidal_tpu_torch.active import lidal, lidal_runner
    from lidal_tpu_torch.runtime.prob_inference import run_prob_inference

    seen = []
    select = lidal.select

    def recording_select(*args, **kwargs):
        seen.append([np.array(a) for a in args[:5]])
        return select(*args, **kwargs)

    by_id = {frame_id(f): f for f in files}
    lidal.select = recording_select
    try:
        reset_launches()
        t0 = time.perf_counter()
        with bf16_route():
            if staged:
                run_prob_inference(lidal_runner._prev_cfg(cfg), model, files, lambda f: read_fn(f, with_labels=False),
                                   frame_id, device=dev)
                res = lidal_runner.run_lidal_round(cfg, device=dev)
            else:
                res = lidal_runner.run_fused_lidal_round(
                    cfg, model, lambda seq, name: read_fn(by_id[(seq, name)], with_labels=False)[:2],
                    frame_index={frame_id(f): i for i, f in enumerate(files)}, device=dev,
                )
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_route_launches(("lookup_sorted", "conv_gather_first", "nn_band") +
                                       (("gather8_bf16", "child_sum_bf16") if cfg.is_spvcnn else ()))
    finally:
        lidal.select = select
    require(launches["nn_band"] == len(files), f"nn_band launched {launches['nn_band']} times for {len(files)} frames")
    require(len(res.al_added) > 0, "the round on the bf16 route selected nothing")
    return res, seen[0], seconds, launches


def require_rounds_equal(cfg_a, res_a, seen_a, cfg_b, res_b, seen_b, seq, names, what):
    """Two rounds' selections, the arrays their selections saw, their flags
    and the prob / pred maps they wrote bit-equal; the prob maps finite."""
    from lidal_tpu_torch.active import lidal_runner
    from lidal_tpu_torch.runtime.paths import Paths

    require(all(np.array_equal(x, y) for x, y in zip(seen_a, seen_b)),
            f"{what}: supervoxel flags, scores, point counts or centres differ")
    require(all(np.array_equal(x, y) for x, y in zip(res_a, res_b)), f"{what}: the selections differ")
    pa, pb = Paths(lidal_runner._prev_cfg(cfg_a)), Paths(lidal_runner._prev_cfg(cfg_b))
    for name in names:
        for da, db in ((pa.prob_dir(seq), pb.prob_dir(seq)), (pa.pred_dir(seq), pb.pred_dir(seq)),
                       (Paths(cfg_a).sv_flag_dir(seq), Paths(cfg_b).sv_flag_dir(seq))):
            a = np.load(os.path.join(da, f"{name}.npy"))
            require(np.array_equal(a, np.load(os.path.join(db, f"{name}.npy"))), f"{what}: {db}/{name}.npy differs")
            require(bool(np.isfinite(a).all()), f"{what}: non-finite values in {da}/{name}.npy")


def nu_route_round_phase(cfg, root, dev, selection27, t27):
    """30 (e), after phase 27: phase 27's fused NU round (its weights, frames
    and prepared tree) on the bf16 route: frames/s beside phase 27's f32
    fused round, and the selected supervoxels against its (counts and
    |A n B| / |A u B|, recorded, not gated).  Returns its launches."""
    import torch

    from lidal_tpu_torch.cli.commands import _dataset_frames
    from lidal_tpu_torch.runtime.paths import Paths
    from lidal_tpu_torch.runtime.train_loop import init_state

    files, read_fn, frame_id = _dataset_frames(cfg, "train")
    model = init_state(cfg, dev).model.eval()
    randomise_bn(model, SEED + 7)  # phase 27's weights
    cfg_r = route_round_tree(cfg, cfg.processing_root, os.path.join(root, "Processing_bf16"), NU_TRAIN_SCENE,
                             Paths(cfg).sv_flag_dir(NU_TRAIN_SCENE, r_id=1))
    res, _, seconds, launches = route_lidal_round(cfg_r, model, files, read_fn, frame_id, dev)
    print(f"[30e round NU Mink] run_fused_lidal_round on the bf16 route ({NU_TRAIN_FRAMES} frames x {cfg.inf_reps} "
          f"views): {seconds:.2f} s = {NU_TRAIN_FRAMES / seconds:.3f} frames/s (phase 27's f32 round "
          f"{NU_TRAIN_FRAMES / t27:.3f}, bf16 / f32 {t27 / seconds:.3f}); labels {len(res.al_added)} against "
          f"{len(selection27.al_added)} supervoxels, overlap {selection_overlap(res.al_added, selection27.al_added):.4f}; "
          f"pseudo labels {len(res.sl_added)} against {len(selection27.sl_added)}, overlap "
          f"{selection_overlap(res.sl_added, selection27.sl_added):.4f}; launches {launches}")
    del model
    torch.cuda.empty_cache()
    return launches


def sk_route_rounds_phase(cfg, root, dev, f32):
    """30 (f), after phase 23: on phase 12's prepared tree (its grids,
    supervoxels and round-1 flags) and weights, the MinkUNet round on the
    bf16 route staged and fused, bit-equal (maps, flags, the supervoxel
    scores and the selection), and phase 18's SPVCNN fused round on the
    route; frames/s beside phases 12 and 18 (``f32``: {"staged", "fused",
    "spvcnn"}: (seconds, selection)), the selections against theirs
    (recorded).  Returns ({path: launches}, the MinkUNet trees and fused
    selection for 30 (h))."""
    import torch

    from lidal_tpu_torch.data import semantic_kitti as sk
    from lidal_tpu_torch.runtime.paths import Paths
    from lidal_tpu_torch.runtime.train_loop import init_state

    src = os.path.join(root, "Processing_fused")  # phase 12's fused tree
    flags1 = Paths(dataclasses.replace(cfg, processing_root=src)).sv_flag_dir("00", r_id=1)
    files = sk.list_frames(cfg.data_root, cfg.data.train_split)
    names = [f"{i:06d}" for i in range(ROUND_FRAMES)]
    runs, launches = {}, {}
    for family in ("Mink", "SPVCNN"):
        cfg_f = dataclasses.replace(cfg, model_name=family)
        model = init_state(cfg_f, dev).model.eval()
        randomise_bn(model, SEED + 7)  # phases 12 and 18's weights
        for mode in (("staged", "fused") if family == "Mink" else ("fused",)):
            cfg_r = route_round_tree(cfg_f, src, os.path.join(root, f"Processing_bf16_{family}_{mode}"), "00", flags1)
            runs[family, mode] = (cfg_r,) + route_lidal_round(cfg_r, model, files, sk.read_frame, sk.frame_id, dev,
                                                              staged=mode == "staged")
            launches[f"round {family} {mode}"] = runs[family, mode][-1]
        del model
        torch.cuda.empty_cache()
    (cfg_s, res_s, seen_s, t_s, _), (cfg_f, res_f, seen_f, t_f, _) = runs["Mink", "staged"], runs["Mink", "fused"]
    require_rounds_equal(cfg_s, res_s, seen_s, cfg_f, res_f, seen_f, "00", names, "staged vs fused on the bf16 route")
    t12s, sel12 = f32["staged"]
    t12f, _ = f32["fused"]
    print(f"[30f round Mink] on the bf16 route (phase 12's weights, {ROUND_FRAMES} frames x {cfg.inf_reps} views): "
          f"staged (run_prob_inference + run_lidal_round) {t_s:.2f} s = {ROUND_FRAMES / t_s:.3f} frames/s (phase 12's f32 "
          f"{ROUND_FRAMES / t12s:.3f}), fused {t_f:.2f} s = {ROUND_FRAMES / t_f:.3f} frames/s (phase 12's f32 "
          f"{ROUND_FRAMES / t12f:.3f}); staged == fused: {ROUND_FRAMES} prob and pred npys, sv_flag files, supervoxel "
          f"scores and the selection bit-equal; labels {len(res_f.al_added)} against phase 12's {len(sel12.al_added)}, "
          f"overlap {selection_overlap(res_f.al_added, sel12.al_added):.4f}; pseudo labels {len(res_f.sl_added)} "
          f"against {len(sel12.sl_added)}, overlap {selection_overlap(res_f.sl_added, sel12.sl_added):.4f}")
    _, res_p, _, t_p, l_p = runs["SPVCNN", "fused"]
    t18, sel18 = f32["spvcnn"]
    print(f"[30f round SPVCNN] run_fused_lidal_round on the bf16 route (phase 18's weights): {t_p:.2f} s = "
          f"{ROUND_FRAMES / t_p:.3f} frames/s (phase 18's f32 {ROUND_FRAMES / t18:.3f}); labels {len(res_p.al_added)} "
          f"against {len(sel18.al_added)}, overlap {selection_overlap(res_p.al_added, sel18.al_added):.4f}; pseudo "
          f"labels {len(res_p.sl_added)} against {len(sel18.sl_added)}, overlap "
          f"{selection_overlap(res_p.sl_added, sel18.sl_added):.4f}; launches {l_p}")
    return launches, {"staged": cfg_s.processing_root, "fused": cfg_f.processing_root, "selection": res_f}


def route_group_phase(cfg_train, cfg_eval, root, dev, batches):
    """30 (h), after 29 (ii): 29 (i) on the bf16 route.  In a world-size-1
    NCCL group: ``run_train`` at B = 5 bit-equal to no group's after 3 steps
    (all-reduces counted), and ``run_eval`` of phase 5's model over its
    batches through the group equal to no group's, both on the route."""
    import torch
    import torch.distributed as dist

    from lidal_tpu_torch.models.minkunet import MinkUNet
    from lidal_tpu_torch.runtime.evaluate import run_eval
    from lidal_tpu_torch.runtime.train_loop import run_train
    from lidal_tpu_torch.utils import profiling

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    group = dist.group.WORLD
    try:
        with bf16_route():
            runs = {}
            for tag, g in (("plain", None), ("group", group)):
                cfg = dataclasses.replace(cfg_train, checkpoint_root=os.path.join(root, f"check_points_30h_{tag}"))
                reset_launches()
                runs[tag] = run_train(cfg, max_iter=3, log_every=10**9, device=dev, group=g).model.state_dict()
                launches = read_route_launches(("lookup_sorted", "conv_gather_first", "conv_dx_dw_fused"))
            n_all_reduces = profiling.counter("all_reduce.calls")
            differ = [k for k, v in runs["plain"].items() if not torch.equal(v, runs["group"][k])]
            require(not differ, f"3 steps on the route through the group differ from 3 without it: {differ[:4]}")
            require(n_all_reduces > 0, "no all-reduce ran in the group's run_train")
            torch.manual_seed(SEED)  # phase 5's model and generator
            model = MinkUNet(num_classes=cfg_eval.data.num_classes).eval()
            randomise_bn(model, SEED + 1)
            model = model.to(dev)
            confs = {}
            for tag, g in (("plain", None), ("group", group)):
                gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
                run_eval(cfg_eval, model, batches[:1], dev, gen, group=g)
                confs[tag] = run_eval(cfg_eval, model, batches[1:], dev, gen, group=g).confusion
        require(np.array_equal(confs["plain"], confs["group"]),
                "run_eval on the route through the group differs from no group's")
        print(f"[30h group] on the bf16 route, a world-size-1 NCCL group: run_train B = {cfg_train.data.batch_size}, "
              f"after 3 steps {len(runs['plain'])} tensors bit-equal with and without the group, {n_all_reduces} "
              f"all-reduces; run_eval of {TIMED_BATCHES} batches x {B} through the group: confusion equal to no "
              f"group's ({int(confs['group'].sum())} points); launches of the group's run_train {launches}")
    finally:
        dist.destroy_process_group()


EXPERIMENT_ROUNDS = 3  # rounds of 30 (g)'s run-experiment
EXPERIMENT_STEPS = 3  # train steps a round there


def experiment_phase(cfg, root, dev):
    """30 (g): ``python -m lidal_tpu_torch.cli run-experiment --rounds 3``,
    as ``cli.main`` in this process, on phase 12's tree (its frames, grids
    and supervoxels; round 0 labels phase 12's round-1 frames, every third),
    EXPERIMENT_STEPS train steps a round, eval on, with ``--bf16_route`` and
    without it: seconds of each, the route run's launches (no f32 kernel)
    and the f32 run's (no bf16 kernel), both switches off after each; per
    round the supervoxels each run labels and pseudo-labels, and their
    overlap |A n B| / |A u B| (recorded, not gated: from round 2 on the two
    runs train on different labels).  The selection budget is 1 % of the
    tree's points, as in phase 12 (``train_point_num`` has no flag:
    ``config.SK_CONFIG`` carries the tree's count for the two commands).
    Returns the route run's launches."""
    from lidal_tpu_torch import config
    from lidal_tpu_torch.cli import __main__ as cli
    from lidal_tpu_torch.ops import conv, cuda_gather8
    from lidal_tpu_torch.runtime.paths import Paths

    src = os.path.join(root, "Processing_fused")  # phase 12's fused tree
    flags1 = Paths(dataclasses.replace(cfg, processing_root=src)).sv_flag_dir("00", r_id=1)
    names = sorted(os.listdir(flags1))
    runs = {}
    saved = config.SK_CONFIG
    config.SK_CONFIG = dataclasses.replace(saved, train_point_num=cfg.data.train_point_num)
    try:
        for route in (True, False):
            tag = "bf16" if route else "f32"
            proc = os.path.join(root, f"Processing_experiment_{tag}")
            for part in ("grid", "super_voxel"):
                shutil.copytree(os.path.join(src, "SK", part), os.path.join(proc, "SK", part))
            p0 = Paths(dataclasses.replace(cfg, processing_root=proc, r_id=0))
            os.makedirs(p0.frame_flag_dir())
            np.save(os.path.join(p0.frame_flag_dir(), "00.npy"), np.arange(ROUND_FRAMES) % 3 == 0)
            shutil.copytree(flags1, p0.sv_flag_dir("00"))
            argv = ["run-experiment", "--rounds", str(EXPERIMENT_ROUNDS), "--dataset_name", "SK", "--model_name",
                    "Mink", "--label_unit", "sv", "--metric_name", "LiDAL", "--data_root", cfg.data_root,
                    "--processing_root", proc, "--checkpoint_root", os.path.join(root, f"check_points_experiment_{tag}"),
                    "--train_seqs", "00", "--val_seqs", "08", "--max_iter", str(EXPERIMENT_STEPS), "--inf_reps",
                    str(cfg.inf_reps), "--batch_size", str(cfg.data.batch_size), "--point_cap", str(cfg.data.point_cap),
                    "--level_caps", ",".join(map(str, cfg.data.level_caps)), "--device", str(dev)]
            argv += ["--bf16_route"] if route else []
            reset_launches()
            t0 = time.perf_counter()
            require(cli.main(argv) == 0, f"run-experiment ({tag}) failed")
            seconds = time.perf_counter() - t0
            require(not conv.BF16_OPERANDS and not cuda_gather8.SCATTER8_BF16, "the route's switches stayed on")
            if route:
                launches = read_route_launches(("lookup_sorted", "conv_gather_first", "conv_dx_dw_fused", "nn_band"))
            else:
                counts = read_launches(("lookup_sorted", "subm_conv", "conv_dx_dw", "nn_band"))
                require(not counts["conv_gather_first"] and not counts["conv_dx_dw_fused"],
                        f"bf16 kernels launched without --bf16_route: {counts}")
            flags = []
            for r in range(EXPERIMENT_ROUNDS + 1):
                d = Paths(dataclasses.replace(cfg, processing_root=proc, r_id=r)).sv_flag_dir("00")
                flags.append(np.concatenate([np.load(os.path.join(d, n)) for n in names]))
            runs[tag] = seconds, flags
    finally:
        config.SK_CONFIG = saved
    lines = []
    for r in range(1, EXPERIMENT_ROUNDS + 1):
        new = {}
        for tag, (_, flags) in runs.items():
            prev, now = flags[r - 1], flags[r]
            require(bool((now[prev == 1] == 1).all()), f"{tag}: round {r} dropped earlier labels")
            new[tag] = (np.flatnonzero((now == 1) & (prev != 1)), np.flatnonzero(now == 2))
            require(len(new[tag][0]) > 0, f"{tag}: round {r} labelled nothing")
        (al_b, sl_b), (al_f, sl_f) = new["bf16"], new["f32"]
        lines.append(f"round {r}: labels {len(al_b)} / {len(al_f)}, overlap {selection_overlap(al_b, al_f):.4f}; "
                     f"pseudo labels {len(sl_b)} / {len(sl_f)}, overlap {selection_overlap(sl_b, sl_f):.4f}")
    print(f"[30g experiment] cli.main run-experiment --rounds {EXPERIMENT_ROUNDS} (max_iter {EXPERIMENT_STEPS}, eval "
          f"on) on phase 12's tree: --bf16_route {runs['bf16'][0]:.1f} s, f32 {runs['f32'][0]:.1f} s; selections "
          f"bf16 / f32 by round: {'; '.join(lines)}; launches on the route {launches}")
    return launches


def main() -> None:
    import torch

    # ---- 1. device ---------------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py drives the port on an NVIDIA GPU")
    from lidal_tpu_torch.config import NU_CONFIG, SK_CONFIG, RunConfig
    from lidal_tpu_torch import kernels_build
    from lidal_tpu_torch.active import lidal
    from lidal_tpu_torch.data.pipeline import prepare_eval_batch, prepare_train_batch
    from lidal_tpu_torch.models.minkunet import MinkUNet
    from lidal_tpu_torch.models.spvcnn import SPVCNN
    from lidal_tpu_torch.prep.grid import prepare_sk_grids
    from lidal_tpu_torch.runtime.train_loop import init_state, nu_seq_frames

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[1 device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off")

    # ---- 2. build ----------------------------------------------------------------
    sources = ("merge_lookup", "subm_conv", "conv_dx_dw", "nn_band", "gather8", "conv_gather_first", "conv_dx_dw_fused",
               "patch_attention")
    t0 = time.perf_counter()
    kernels_build.load_all(sources)
    print(f"[2 build] {len(sources)} sources, one nvcc each, started together: {time.perf_counter() - t0:.1f} s")
    for name in sources:
        seconds, report = kernels_build.BUILD_LOG[name]
        usage = [ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[2 build] {name}.cu: {seconds:.1f} s; ptxas: {' | '.join(usage)}")

    cfg = RunConfig(dataset_name="SK", model_name="Mink")
    caps = SK_CONFIG.level_caps
    rng = np.random.default_rng(SEED)
    batches = [make_batch(rng, SK_CONFIG.point_cap) for _ in range(1 + TIMED_BATCHES)]
    b0 = batches[1]

    def prepare(batch, seed, with_points=False):
        return prepare_eval_batch(
            torch.Generator(device="cpu").manual_seed(seed),
            *(torch.as_tensor(batch[k], device=dev) for k in ("xyz", "sig", "valid")),
            level_caps=caps, with_points=with_points,
        )

    eb = prepare(b0, SEED)
    torch.cuda.synchronize()

    # ---- 3. lookup kernel vs plain ------------------------------------------------
    lookup = lookup_phase(eb)

    # ---- 4. conv kernel vs plain at every shape of the forward ---------------------
    torch.manual_seed(SEED)
    model = MinkUNet(num_classes=SK_CONFIG.num_classes).eval()
    randomise_bn(model, SEED + 1)
    model = model.to(dev)
    conv, real_convs = conv_phase(model, eb)

    # ---- 19, 20. the gather-first bf16 conv kernels ---------------------------------------------
    gather_first = gather_first_phase(real_convs, dev)
    del real_convs
    byte_planes = byte_planes_phase(dev)
    torch.cuda.empty_cache()

    # ---- 31. PTv3's patch attention kernels ---------------------------------------------
    attention = attention_phase(dev)

    # ---- 5, 6. the eval slice and the whole forward -------------------------------------------
    del eb
    launches, conf5 = eval_slice_phase(cfg, model, batches, prepare, dev, caps, "5 slice", "6 forward")
    torch.cuda.empty_cache()

    # ---- 30 (a, b). the bf16 route: MinkUNet's forward convs, eval at B = 4 --------------------------
    route = {}  # each main path's launches on the bf16 route
    eb = prepare(b0, SEED)
    route_fwd = route_forward_phase(model, eb)
    del eb
    route["eval Mink"] = route_eval_phase(cfg, model, batches, prepare, dev, caps)
    del model
    torch.cuda.empty_cache()

    # ---- 14, 16. SPVCNN: the gather8 kernel and the eval slice ------------------------------
    cfg_spv = RunConfig(dataset_name="SK", model_name="SPVCNN")
    torch.manual_seed(SEED)
    spvcnn = SPVCNN(num_classes=SK_CONFIG.num_classes).eval()
    randomise_bn(spvcnn, SEED + 1)
    spvcnn = spvcnn.to(dev)
    eb_s = prepare(b0, SEED, with_points=True)
    gather8, child_sum = gather_work_phase(spvcnn, eb_s)
    del eb_s
    torch.cuda.empty_cache()
    launches_16, _ = eval_slice_phase(cfg_spv, spvcnn, batches, prepare, dev, caps, "16 slice", "16 forward")
    # ---- 30 (a, b). the bf16 route: SPVCNN's gather8, eval at B = 4 ----------------------------------
    eb_s = prepare(b0, SEED, with_points=True)
    route_g8, route_cs = gather_work_phase(spvcnn, eb_s, route=True)
    del eb_s
    route["eval SPVCNN"] = route_eval_phase(cfg_spv, spvcnn, batches, prepare, dev, caps)
    del spvcnn
    torch.cuda.empty_cache()

    # ---- 7-9, 15, 17. training --------------------------------------------------------------
    root = tempfile.mkdtemp(prefix="lidal_sk_")
    try:
        data = dataclasses.replace(SK_CONFIG, train_split=("00",))
        cfg_train = RunConfig(
            dataset_name="SK", model_name="Mink", label_unit="fr", metric_name="full", r_id=1,
            max_iter=1 + TIMED_STEPS, ckpt_every=10**6, seed=SEED,
            data_root=write_sk_tree(root, np.random.default_rng(SEED + 4), 3 * data.batch_size),
            processing_root=os.path.join(root, "Processing_files"),
            checkpoint_root=os.path.join(root, "check_points"), data_override=data,
        )
        train_state = init_state(cfg_train, dev)
        b7 = make_batch(rng, SK_CONFIG.point_cap, data.batch_size)
        tb7 = prepare_train_batch(
            torch.Generator(device="cpu").manual_seed(SEED + 5),
            *(torch.as_tensor(b7[k], device=dev) for k in ("xyz", "sig", "valid", "labels")),
            level_caps=caps,
        )
        dxdw_err, dxdw_ms, dxdw_plain_ms, dxdw_bound, bwd_calls, bwd_counts, bwd_ms = backward_phase(train_state, tb7)
        del train_state, tb7, b7
        torch.cuda.empty_cache()
        # ---- 21, 22. the fused bf16 backward kernel; the probes' entry points ----------------------
        fused = fused_backward_phase(bwd_calls, bwd_counts, bwd_ms, dev)
        del bwd_calls
        torch.cuda.empty_cache()
        probe_launches = probes_phase(dev)
        torch.cuda.empty_cache()
        trained, tb8, train_launches, rate8 = train_slice_phase(cfg_train, dev, caps)
        train_step_parity_phase(trained, tb8)
        del trained, tb8
        torch.cuda.empty_cache()
        # ---- 30 (a, c). the bf16 route: a B = 5 step's backward, MinkUNet's run_train ---------------
        rng30 = np.random.default_rng(SEED + 30)  # the earlier phases' draws stay as they were
        b30 = make_batch(rng30, SK_CONFIG.point_cap, data.batch_size)
        tb30, tb30s = (prepare_train_batch(
            torch.Generator(device="cpu").manual_seed(SEED + 5),
            *(torch.as_tensor(b30[k], device=dev) for k in ("xyz", "sig", "valid", "labels")),
            level_caps=caps, with_points=points,
        ) for points in (False, True))
        route_bwd = route_backward_phase(init_state(cfg_train, dev), tb30)
        del tb30
        torch.cuda.empty_cache()
        route["train Mink"] = route_train_phase(cfg_train, root, dev)
        torch.cuda.empty_cache()
        # ---- 32. PTv3's main paths: run_train and an eval forward ---------------------------------
        ptv3_launches = ptv3_path_phase(cfg_train, prepare(b0, SEED), dev)
        torch.cuda.empty_cache()

        cfg_train_spv = dataclasses.replace(cfg_train, model_name="SPVCNN")
        train_state = init_state(cfg_train_spv, dev)
        b15 = make_batch(rng, SK_CONFIG.point_cap, data.batch_size)
        tb15 = prepare_train_batch(
            torch.Generator(device="cpu").manual_seed(SEED + 5),
            *(torch.as_tensor(b15[k], device=dev) for k in ("xyz", "sig", "valid", "labels")),
            level_caps=caps, with_points=True,
        )
        scatter8 = scatter8_phase(train_state, tb15)
        del train_state, tb15, b15
        torch.cuda.empty_cache()
        trained, tb17, launches_17, _ = train_slice_phase(cfg_train_spv, dev, caps, tag="17 slice")
        train_step_parity_phase(trained, tb17, tag="17 train step")
        del trained, tb17
        torch.cuda.empty_cache()
        # ---- 30 (a, c). the bf16 route: SPVCNN's scatter8, its run_train ----------------------------
        route_s8 = route_scatter8_phase(init_state(cfg_train_spv, dev), tb30s)
        del tb30s, b30
        torch.cuda.empty_cache()
        route["train SPVCNN"] = route_train_phase(cfg_train_spv, root, dev)
        torch.cuda.empty_cache()
        # ---- 29 (i, ii). a world-size-1 NCCL group; two ranks on the card joined by gloo -------------
        group_phase(cfg_train, cfg, root, dev, batches, conf5, rate8)
        gloo_phase(cfg_train, root, dev)
        # ---- 30 (h). the bf16 route in a one-rank NCCL group and over two gloo ranks ----------------
        route_group_phase(cfg_train, cfg, root, dev, batches)
        gloo_phase(cfg_train, root, dev, route=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- 10-13. the LiDAL round -------------------------------------------------------
    root = tempfile.mkdtemp(prefix="lidal_round_")
    try:
        data = dataclasses.replace(
            SK_CONFIG, train_split=("00",), val_split=("08",), train_point_num=ROUND_FRAMES * N_PTS
        )
        cfg_round = RunConfig(
            dataset_name="SK", model_name="Mink", label_unit="sv", metric_name="LiDAL", r_id=2, inf_reps=8,
            ckpt_every=10**6, seed=SEED, data_root=os.path.join(root, "sequences"),
            processing_root=os.path.join(root, "Processing_files"),
            checkpoint_root=os.path.join(root, "check_points"), data_override=data,
        )
        t0 = time.perf_counter()
        n_sv = write_round_tree(root, np.random.default_rng(SEED + 6), cfg_round)
        prepare_sk_grids(cfg_round)
        print(f"[10 grid] a sequence of {ROUND_FRAMES} frames x {N_PTS} points of one static world, {n_sv} supervoxels, "
              f"registered by prepare_sk_grids: {time.perf_counter() - t0:.1f} s")
        grid_phase(cfg_round, dev)
        nn_band = nn_band_phase(cfg_round, dev)
        round_launches, selection12, t12 = lidal_slice_phase(cfg_round, root, dev, n_sv)
        rank_round_phase(cfg_round, root, dev, selection12)
        # ---- 30 (d). the bf16 route: phase 12's fused round ------------------------------------------
        route["round Mink"] = route_round_phase(cfg_round, root, dev, selection12, n_sv)
        active_round_phase(cfg_round, dev)
        launches_18, selection18, t18 = spvcnn_round_phase(cfg_round, dev, n_sv)
        scoring_phase(cfg_round, root, dev)
        # ---- 30 (f, h, g). the route: staged and SPVCNN rounds, the round over two ranks, 3 rounds ------
        launches_f, trees = sk_route_rounds_phase(cfg_round, root, dev, {
            "staged": (t12["staged"], selection12), "fused": (t12["fused"], selection12),
            "spvcnn": (t18, selection18)})
        route.update(launches_f)
        rank_round_phase(dataclasses.replace(cfg_round, processing_root=trees["staged"]), root, dev,
                         trees["selection"], fused_root=trees["fused"], route=True)
        route["experiment"] = experiment_phase(cfg_round, root, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- 24-28. nuScenes: prep, eval, train, the LiDAL round, the checkpoint import -----------
    root = tempfile.mkdtemp(prefix="lidal_nu_")
    try:
        t0 = time.perf_counter()
        nu_root = write_nu_tree(root, np.random.default_rng(SEED + 11))
        print(f"[24 prep] wrote the nuScenes tree in {time.perf_counter() - t0:.1f} s")
        # NU_CONFIG names no train split: the scoring rounds get the scene as the CLI's --train_seqs gives it
        data = dataclasses.replace(NU_CONFIG, train_split=(NU_TRAIN_SCENE,), train_point_num=NU_TRAIN_FRAMES * NU_PTS)
        cfg_nu = RunConfig(
            dataset_name="NU", model_name="Mink", label_unit="sv", metric_name="LiDAL", r_id=2, inf_reps=8,
            ckpt_every=10**6, seed=SEED, nu_root=nu_root, processing_root=os.path.join(root, "Processing_files"),
            checkpoint_root=os.path.join(root, "check_points"), data_override=data,
        )
        n_sv_nu = nu_prep_phase(cfg_nu)
        nu_eval, nu_batch = nu_eval_phase(cfg_nu, dev, route)  # with 30 (e)'s eval on the route
        cfg_nu_train = dataclasses.replace(cfg_nu, label_unit="fr", metric_name="full", r_id=1,
                                           max_iter=1 + TIMED_STEPS)
        trained, _, nu_train, _ = train_slice_phase(cfg_nu_train, dev, NU_CONFIG.level_caps, tag="26 slice",
                                                    n_pts=NU_PTS)
        del trained
        torch.cuda.empty_cache()
        # ---- 30 (e). the bf16 route: NU training at B = 15 ------------------------------------------
        route["NU train Mink"] = route_train_phase(cfg_nu_train, root, dev, tag="[30e train NU Mink]")
        torch.cuda.empty_cache()
        names = [e["token"] for e in nu_seq_frames(cfg_nu)[NU_TRAIN_SCENE]]
        grid_phase(cfg_nu, dev, seq=NU_TRAIN_SCENE, name=names[NU_TRAIN_FRAMES // 2], n_pts=NU_PTS, tag="27 grid")
        nn_band_phase(cfg_nu, dev, seq=NU_TRAIN_SCENE, names=names[: lidal.NEI_NUM + 2], n_pts=NU_PTS,
                      tag="27 nn_band", edge_cases=False)
        nu_round, selection27, t27 = nu_round_phase(cfg_nu, root, dev, n_sv_nu)
        # ---- 30 (e). the bf16 route: phase 27's fused NU round ----------------------------------------
        route["NU round Mink"] = nu_route_round_phase(cfg_nu, root, dev, selection27, t27)
        nu_import_phase(cfg_nu, nu_batch, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # every main path's run, each counted from 0 just before it
    total = {k: sum(run[k] for run in (launches, train_launches, round_launches, launches_16, launches_17, launches_18,
                                       probe_launches, nu_eval["Mink"], nu_eval["SPVCNN"], nu_train, nu_round,
                                       ptv3_launches))
             for k in KERNELS}
    on_route = {k: sum(run[k] for run in route.values()) for k in KERNELS}  # phase 30's main paths

    record = {
        "kernels": [
            {
                "name": "lookup_sorted", "route": "cuda", "source": "lidal_tpu_torch/csrc/merge_lookup.cu",
                "replaces": "lidal_tpu/ops/pallas_merge.py:211", "launches": total["lookup_sorted"], **lookup,
            },
            {
                "name": "subm_conv", "route": "cuda", "source": "lidal_tpu_torch/csrc/subm_conv.cu",
                "replaces": "lidal_tpu/ops/pallas_conv.py:387", "launches": total["subm_conv"], **conv,
            },
            {
                "name": "conv_dx_dw", "route": "cuda", "source": "lidal_tpu_torch/csrc/conv_dx_dw.cu",
                "replaces": "lidal_tpu/ops/pallas_conv.py:299", "launches": total["conv_dx_dw"],
                "max_abs_err": dxdw_err, "ms": dxdw_ms, "plain_ms": dxdw_plain_ms,
                "bound_ms": dxdw_bound.total, "bound_by": dxdw_bound.by, "library_ms": None,
            },
            {
                "name": "nn_band", "route": "cuda", "source": "lidal_tpu_torch/csrc/nn_band.cu",
                "replaces": "lidal_tpu/ops/pallas_nnband.py:158", "launches": total["nn_band"],
                "library_ms": None, **nn_band,
            },
            {
                "name": "gather8", "route": "cuda", "source": "lidal_tpu_torch/csrc/gather8.cu",
                "replaces": "lidal_tpu/ops/pallas_gather8.py:124", "launches": total["gather8"], **gather8,
            },
            {  # the chain of gather8_pallas calls of lidal_tpu/ops/devoxelize.py:_child_sum, in one launch
                "name": "child_sum", "route": "cuda", "source": "lidal_tpu_torch/csrc/gather8.cu",
                "replaces": "lidal_tpu/ops/pallas_gather8.py:124", "launches": total["child_sum"], **child_sum,
            },
            {
                "name": "scatter8", "route": "cuda", "source": "lidal_tpu_torch/csrc/gather8.cu",
                "replaces": "lidal_tpu/ops/pallas_gather8.py:300", "launches": total["scatter8"], **scatter8,
            },
            {
                "name": "conv_gather_first", "route": "cuda", "source": "lidal_tpu_torch/csrc/conv_gather_first.cu",
                "replaces": "tools/probe_conv_v3.py:185", "launches": total["conv_gather_first"], **gather_first,
            },
            {
                "name": "conv_byte_planes", "route": "cuda", "source": "lidal_tpu_torch/csrc/conv_gather_first.cu",
                "replaces": "tools/probe_int8_gather.py:140", "launches": total["conv_byte_planes"], **byte_planes,
            },
            {
                "name": "conv_dx_dw_fused", "route": "cuda", "source": "lidal_tpu_torch/csrc/conv_dx_dw_fused.cu",
                "replaces": "tools/probe_dxdw_features.py:42", "launches": total["conv_dx_dw_fused"], **fused,
            },
            {  # PTv3 has no JAX counterpart: the kernels replace the library's memory-efficient attention
                "name": "patch_attention", "route": "cuda", "source": "lidal_tpu_torch/csrc/patch_attention.cu",
                "replaces": None, "launches": total["attn_fwd"] + total["attn_bwd"], **attention,
            },
            # the bf16 route (phase 30): the JAX package's own route on its TPU, at the model path's shapes
            {
                "name": "subm_conv_bf16", "route": "cuda", "source": "lidal_tpu_torch/csrc/conv_gather_first.cu",
                "replaces": "lidal_tpu/ops/pallas_conv.py:387", "launches": on_route["conv_gather_first"], **route_fwd,
            },
            {
                "name": "conv_dx_dw_bf16", "route": "cuda", "source": "lidal_tpu_torch/csrc/conv_dx_dw_fused.cu",
                "replaces": "lidal_tpu/ops/pallas_conv.py:299", "launches": on_route["conv_dx_dw_fused"], **route_bwd,
            },
            {
                "name": "gather8_bf16", "route": "cuda", "source": "lidal_tpu_torch/csrc/gather8.cu",
                "replaces": "lidal_tpu/ops/pallas_gather8.py:124", "launches": on_route["gather8_bf16"], **route_g8,
            },
            {
                "name": "child_sum_bf16", "route": "cuda", "source": "lidal_tpu_torch/csrc/gather8.cu",
                "replaces": "lidal_tpu/ops/pallas_gather8.py:124", "launches": on_route["child_sum_bf16"], **route_cs,
            },
            {
                "name": "scatter8_bf16", "route": "cuda", "source": "lidal_tpu_torch/csrc/gather8.cu",
                "replaces": "lidal_tpu/ops/pallas_gather8.py:300", "launches": on_route["scatter8_bf16"], **route_s8,
            },
        ]
    }
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
