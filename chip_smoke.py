#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``dcc_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--ptxas] [--out results.json]

Phases, in the order they run (any failure exits non-zero):

1. print the card (``nvidia-smi`` name and power limit, torch / CUDA);
2. build K1's source (``gae``), then the others in a background thread
   (``cuda_build.build``, one ``nvcc`` a source) while the ``TRAIN_RUNS``
   not in ``PROFILED``, the precision phase, the ``DEEP_RUNS`` and the
   ``BLOCKED_RUNS`` (phases 8 and 3) run (a run that needs a
   kernel still building waits for its library alone; their times carry
   the build's load on the host's cores); then print the build's time,
   each tensor-core kernel's and K1's registers and spills (``-Xptxas -v``;
   all of the report with ``--ptxas``), and the SASS check: ``cuobjdump -sass``
   of the built libraries must show HMMA or HGMMA instructions in every
   bf16 tensor-core kernel (``*mma_kernel``: K2, K2b, K3, K4, K3u, K4u, the
   chunked K2, K2b, K3, K4, K3u and K4u, the layer-0 input backward, and
   on the warpgroup tensor cores the dV0 kernel and the layer-0 input
   backward without dx, ``*_wgmma_kernel``)
   and none in any other kernel (no TF32 in the f32 kernels);
   The training runs are the ``TRAIN_RUNS`` through
   ``dcc_tpu_torch.train.main``: 2 iterations each of the bf16 config, the
   recurrent bf16 config and bf16 unfolded with PopArt (each fused path's
   second rollout on parameters packed after an update), and 1 of the
   default f32 config, bf16 with 4 minibatches, recurrent bf16 with 2
   minibatches, recurrent f32, bf16 with the fused loss off and f32 with
   4 update chunks and remat,
   one bf16 iteration per non-Gaussian head (K2 and K2b), one f32
   iteration of each one-card preset as written and one bf16 iteration of
   5uav_dense_conn and 10uav_moving_collision (K2, K3, K4 at their widths;
   the 10-UAV preset's randomized and moving PoIs and collision penalty on
   the card); 1 iteration of separated per-agent f32 policies and 1 each
   in bf16 and recurrent f32 with 2 minibatches, which launch K1 only;
   one iteration of the 20-UAV preset as written but for its envs (256
   of 16,384; bf16, eval 0: K2 on 242- and 4,840-wide rows, K3 15 times,
   K4 15 times with its dV0 kernel 15 times), and the same with the fused
   loss off (K2 541 times, with remat; K2b 60 times staged on the actor's
   rows and 60 chunked on the critic's, each chunked launch followed by the
   layer-0 input backward and dV0), unfolded (K3u 15, K4u chunked 15, the
   layer-0 input backward and dV0 15 each) and recurrent at 64 envs without
   update chunks (K2b 15 staged and 15 chunked, the other two 15 each);
   B3's hidden widths at 16 envs, one bf16 iteration each (512 folded,
   unfolded and with the fused loss off, 100 unfolded, 1,024 with the
   fused loss off, recurrent at 300) and the 20-UAV preset at hidden 512
   (256 envs: K3 on 768,000 x 242 x 512, K4 chunked with dV0 on
   38,400 x 4,840 x 512);
   one bf16 iteration each of 4 UAVs x 300 PoIs at 256 envs
   (``reduced``): folded (K2 150 staged on the actor's rows and 151
   chunked on the critic's, ``fused_mlp_chunked``; K3 and K4 chunked 15
   each, their dV0 15 each), unfolded (K3u and K4u chunked 15 each, the
   layer-0 input backward and dV0 30 each) and with the fused loss off
   (K2 165 + 166, K2b 15 staged and 15 chunked, the other two 15 each);
   2 iterations each of MADDPG with ``maddpg.yaml`` and
   ``maddpg_tuned.yaml`` on coverage and with ``maddpg.yaml`` on ``spread``
   (``--scenario-name spread --num-landmarks 4``), each evaluated at its
   second iteration, which launch no kernel of the port, and of bf16 MAPPO
   on ``spread`` (K1, K2 301, K3 and K4 15 each on 18- and 72-wide rows);
   The precision phase (``check_precision``, ROADMAP A12): (a) the df64
   primitives and the compensated ``_connect_force`` on the card at
   16,384 envs x 4 agents against the same functions on the CPU (at most
   ``DF64_ULPS`` f32 ulps apart), the force in tests/test_compensated.py's
   two regimes against an f64 evaluation of the same f32 positions (below
   ``COMP_TRUTH_REL`` of the force, the plain f32 force ``COMP_GAIN`` times
   worse or more), each call timed; (b) the six golden traces replayed on
   the card in f64 through ``compat.compare`` at tests/test_env_parity.py's
   tolerances (``GOLDEN_TOLS``); (c) an env step's device kernels with the
   df64 force on and off and in f64, then the three connectivity-force
   arms (``PRECISION_RUNS``: the connect variant plain, with
   ``--compensated-forces true`` and with ``--env-dtype float64``) trained
   through ``dcc_tpu_torch.train.main`` at 16 envs (2 iterations) and 1,024
   (1): K1 once an iteration by the launch counts and, at 16 envs, by the
   profiler, every env tensor on the card (``EnvWatch``) and in f64 for
   the f64 arm, the iteration times printed; (d) one deterministic f64-env
   rollout (16 envs, 150 steps) on the card against the CPU from the same
   parameters within ``ROLLOUT_ATOL``;
3. the column-blocked layout (``check_blocked``, ROADMAP B3 rest: hidden
   widths past what a staged, chunked or depth tile holds): the row-tile
   plans (``BLOCKED_PLANS``); the layout bit for bit against the staged
   and depth layouts at ``BLOCKED_BITS`` (512, 800 with a partial last
   column pass, 1,024) on 16-, 32- and 64-row tiles, the default rows and
   the 20-UAV preset's 4,840-wide critic rows; at ``BLOCKED_CHECKS``
   (1,152, 2,048, 4,096) the layout's chunked K2b, K4u and K4 (with the
   layer-0 tail) on 2,400 of those rows, as the preset's runs take them,
   and K2 at 4,096 on the preset's rows and chunked on the 300-PoI swarm's
   6,040-wide ones; each kernel forced into it on the default rows at 16
   envs (K2, K2b, K3 / K4, K3u / K4u, the layer-0 input backward with dx),
   relu under the mask rule (timed) and tanh, K4 and K4u under the
   value-flip rule; every bf16 check with the kernel in f32 (or, on the
   4,840-wide rows, the plain version in f32) outside its bound; at
   ``BLOCKED_TIMED`` the main path's shapes at ``BLOCKED_ENVS`` envs,
   timed; its ``BLOCKED_RUNS`` through the entry point, in phase 2 (2 iterations at
   hidden 2,048 and 256 envs folded, unfolded and with the fused loss off;
   4,096; the 20-UAV preset at 2,048 and at 4,800 unfolded);
4. hold K1 (GAE) against its plain version through ``compute_gae_cuda`` on
   (T, E, 1) tensors, as the main path calls it, at T = 150 and 16, 16,384
   and 16,387 envs, and at (T, E) = (1, 16), (5, 3), (151, 17), (150,
   1,024) (the 20-UAV run's), and at
   (1000, 64), (2000, 16), (600, 16387), where the kernel walks time in
   rounds, with masks whose zero runs cross the kernel's segment and round
   boundaries, one launch a call through ``GAE_ENTRY``; at 16 and 16,384
   envs also its device us per call from ``torch.profiler`` over the timed
   launches (the phase fails where the profiler sees no device time). Then
   hold each kernel K2-K4, K2b and the unfolded K3u / K4u against its plain
   PyTorch version on the card, in f32 and bf16, at the default shapes (16
   envs) and at bench.py's headline 16384 envs (a quarter of that for K3 /
   K4, K3u / K4u and K2b, whose plain versions materialize (rows, 256) f32
   tensors). K2b runs on the recurrent update's rows: T*E*A for the actor
   and for the critic, whose env rows are duplicated per agent. Then the
   same kernels at the one-card presets' widths (``PRESET_CHECKS``: actor /
   critic 58 / 174, 192 / 960, 122 / 1,220) at their 16 envs, at the shapes
   their runs give them, each check printing the row tile its launch took;
   there the bf16 gradient kernels run three trunks (``trunk_variants``:
   the model's, the model's with tanh, and one relu layer on the rows
   themselves). Then the 20-UAV preset's widths
   (``check_wide``: actor 242, team-concat critic 4,840, where bf16 K4, K2b
   and K4u run their chunked layer 0, then the dV0 kernel and, for K2b and
   K4u, the layer-0 input backward): K2 at 16 and 1,024 envs, K3 / K4 at
   16 envs in f32 and bf16 on those trunks and in bf16 at 1,024 envs, the
   main path's shapes (3,072,000 x 242, 153,600 x 4,840), the dV0 kernel
   alone at both in its folded and unfolded (affine) modes, each beside the
   cuBLAS product of the same bf16 operands (``library_ms``), the chunked
   K2b on 2,400 and 38,400 critic rows (an update chunk of the
   fused-loss-off run) and the chunked K4u on 2,400 and 153,600, their f32
   reading the plain version in f32 (the FMA kernels take one-row tiles
   there), and the layer-0 input backward alone on 38,400 rows with and
   without dx and on 153,600 without; dV0 also on 38,400 rows; then the
   layer-0 tail (dV0 in both modes, the layer-0 input backward with and
   without dx, ``layer0_tail``'s two launches) at every shape its kernels
   distinguish (``check_tail``: rows 1 to 20,000 around the flush and the
   steps, d_in 17 to 6,040, hidden 8 to 1,024, x in bf16 and f32). Then
   the many-PoI swarms' widths
   (``check_many_pois``: 4 UAVs x 300 PoIs, actor 1,510, critic 6,040,
   where bf16 K2 takes the critic's rows and K3 / K3u the actor's in their
   chunked layouts): K2 at 16 and 1,024 envs, on the 153,600 critic rows
   of the fused-loss-off update's forward, and at the 20-UAV preset's
   5,840-wide critic rows with 50 PoIs (1,024 envs), the staged and the
   chunked K2 timed side by side at 4,840 wide and at the default widths
   (16,384 envs), K3 / K4 and K3u / K4u
   at 16 envs in f32 and bf16 and in bf16 at 1,024 envs (614,400 x 1,510,
   153,600 x 6,040), K3 / K4 at 4 x 360 PoIs (1,810: the one-relu-layer
   trunk's K3 chunked), and dV0 in both modes and the layer-0 input
   backward on the actor's rows and on the critic's 153,600 x 6,040;
   each row with its kernels' ptxas
   registers and spills. Then ROADMAP B3's hidden widths
   (``check_wide_hidden``: 100, off multiples of 8, 300 and 1,024, in
   column passes of 256): every kernel at 16 envs, f32 and bf16, on the
   three trunks; the chunked layouts at 512; at 512 and 1,024 the main
   path's shapes at 1,024 envs (timed at 512), with ptxas registers and
   spills.
   Biases and
   LN affines are moved off their init values so that every bf16 bias add
   rounds. Each bf16 check also runs the kernel in f32 on the same inputs
   and requires that reading to lie outside the bf16 bound, so the bound
   tells the bf16 rounding points from none at all. bf16 relu trunks run
   under the relu mask rule (``masked_relu``, ROADMAP C3): the kernel
   writes its relu masks, each that differs from the plain version's must
   lie within what a one-bf16-step change of the layer's input moves, and
   the plain version then runs on the kernel's masks. Times: CUDA events
   around a run of 30 back-to-back launches (fewer where they would take
   over ``TIMED_MS``: down to 5, and to 3 past 50 ms a launch), divided
   by the count; K2 is fed parameters
   packed beforehand, as the rollout packs them once per parameter version
   (``MLPBase.packed_params``), while K3 / K4 and K2b pack inside the
   window, as their wrappers do every epoch. The wrapper's host time per
   call (``time.perf_counter`` over as many calls, no synchronisation
   between them) is printed beside it, and for K2 also that of the rollout's call
   through ``MLPBase.forward``;
5. hold the updates of ``UPDATE_CHECKS`` on the card against the same
   update on the CPU (plain versions) from identical parameters,
   trajectory and minibatch permutations: fused f32 (K3 / K4), recurrent
   bf16 (K2 / K2b; its reading also with K2's forward through its plain
   version, ``check_k2_plain_update``), and fused f32 unfolded (K3u / K4u)
   with 2 minibatches and PopArt; one f32 update per non-Gaussian
   action head (discrete, multi_discrete, multi_binary, mixed); and two
   f32 updates of separated per-agent policies (2 minibatches with
   PopArt, and recurrent), with per-agent permutations; each update must
   launch exactly its kernels on the card (the separated ones K1 only);
   then one MADDPG update (``check_maddpg_update``: the tuned YAML's 2 x
   128 networks and 1,024-row batch on the default env, f32, batched
   ``torch`` products, no kernel of the port) from the buffer one
   iteration collected on the card, against the same update on the CPU
   from the same parameters and rows: every parameter tensor of the four
   networks and both losses within ``MADDPG_PARAM_RTOL`` /
   ``MADDPG_LOSS_RTOL`` relative;
6. the runs of ``PROFILED`` (the bf16 config, MADDPG on coverage, the
   20-UAV preset with the fused loss off and the 300-PoI swarm folded);
   then 2 bf16 iterations of ``scripts/run_torch_curve.py`` (the learning
   gate's runner; its file's schema, and K1-K4 as the bf16 path launches
   them); then the default command with render (the default YAMLs, 2
   iterations, ``models_2.gif`` into a temporary directory, which must
   decode to 151 frames of 700 x 700). Print the metrics and phase times,
   and require each run's kernels to
   have launched exactly as often as its path runs them and the others not
   at all, every MAPPO run's K1 to have gone through ``GAE_ENTRY`` and every bf16
   run's K2, K2b, K3, K4, K3u and K4u launches to have gone through the
   tensor-core entry points (the 20-UAV run's K4 through
   ``dcc_critic_grads_chunked_mma`` and ``dcc_dv0_wgmma``). After each
   run of ``PROFILED``, one more iteration under ``torch.profiler``: device time by kernel name, the
   number of device kernels and the device's idle share over the
   iteration;
7. the env axis over ranks (``check_mesh``, ROADMAP A13): a 1-rank NCCL
   mesh in this process, the default bf16 config at 16 envs, 3 iterations,
   bit for bit against the unsharded run; 2 gloo ranks spawned on card 0
   (NCCL puts no two ranks on one device; gloo's collectives take the CUDA
   tensors), 8 envs each, against one process at 16: each rank's rollout
   its rows of the one-process rollout bit for bit (``rows_fingerprint``),
   K1 1, K2 301, K3 15 and K4 15 launches a rank, the update's metrics and
   parameters within the bf16 update's bound (``MESH_PARAM_TOL``,
   ``MESH_RTOL``, ``MESH_ATOL``), the ranks bit-identical; the 20-UAV
   preset at 1,024 envs over the same ranks the same way (K3 and the
   chunked K4 + dV0 on each rank's 512 envs; ``MESH_REDUCED``); MADDPG
   over 2 ranks (the replicated buffer against one process's); 2 NCCL ranks
   on two cards where the machine shows two, else a line that says why
   not; each iteration's time per rank beside one process's;
8. trunks of any depth (``check_deep``): every kernel's row-tile plan at 8,
   9 and 32 layers (the bf16 gradient kernels in their depth layout at 32
   only); K2, K2b, K3 / K4 and K3u / K4u in f32 and bf16 against their
   plain versions at 16 envs at 8, 9 and 32 layers, timed at 9 and 32;
   the chunked K2, K4, K2b and K4u on the 20-UAV preset's 4,840-wide
   critic rows at 9 and 32 layers; its ``DEEP_RUNS`` through the entry
   point, in phase 2 (``--layer-N`` 8 and 31 folded, unfolded and with the fused loss
   off; f32 with the fused kernels forced on at 8 and 9 layers; the 20-UAV
   preset at 9 layers, 256 envs) with their launch counts and entries;
9. print the ``{"kernels": [...]}`` line (``ms``: the CUDA event time of
   every kernel; ``device_ms``: K1's profiler device time, whose wrapper
   takes longer on the host than its kernel on the card, null for the
   others; K4 at the 20-UAV preset's 153,600 x 4,840 rows as
   ``critic_ppo_grads_chunked``, both launches, and its dV0 kernel alone
   as ``critic_ppo_grads_dv0``; the chunked K2b at 38,400 x 4,840 as
   ``fused_mlp_bwd_chunked`` and K4u at 153,600 x 4,840 as
   ``critic_ppo_grads_unfolded_chunked``, their three launches each; the
   layer-0 input backward and dV0's unfolded mode alone; the chunked K2 on
   a rollout step's 1,024 x 6,040 critic rows, ``fused_mlp_chunked``, the
   chunked K3 and K3u on 614,400 x 1,510 actor rows,
   ``actor_ppo_grads_chunked`` (both launches) and
   ``actor_ppo_grads_unfolded_chunked`` (three), and K3's dV0 alone,
   ``actor_ppo_grads_dv0``; the kernels at hidden 512, ``*_h512``, at the
   main path's shapes, ``KERNEL_ROW``; the kernels at 9 and 32 layers,
   ``*_L9`` and ``*_L32``, at 16 envs, their launches those of the deep
   runs; ``library_ms`` for the dV0 rows, null for the others; ``ptxas``: the registers and spills of each
   row's kernels), the card line, and the result.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import threading
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_FP32 = 67e12  # FP32 outside the tensor cores, FLOP/s
PEAK_BF16 = 989e12  # bf16 tensor cores, dense, FLOP/s
BIG_ENVS = 16384  # bench.py's headline env count
# the 20-UAV preset (actor rows 242 wide, team-concat critic rows 4,840) at
# 1,024 of its 16,384 envs: one card, the smoke's time; the many-PoI swarms
# too. The training runs of the wide configurations (the 20-UAV preset, the
# many-PoI swarm, the connectivity-force arms) take RUN_ENVS (1,024 before
# the column-blocked phase took its share of the 1,200 s)
WIDE = "20uav_16k_dist"
WIDE_ENVS = 1024
RUN_ENVS = 256
# the many-PoI swarms, no YAML of their own (``--num-pois``): the default
# env (4 UAVs) with 300 PoIs, actor rows 1,510 wide (past the staged bf16
# K3's 1,472 and K3u's 1,088 columns), critic rows 6,040 (past the staged
# K2's 5,632); with 360 PoIs (actor rows 1,810, past one layer's staged K3,
# 1,760: its one-relu-layer check); and the 20-UAV preset with 50 PoIs,
# critic rows 5,840. Names of ``env_config``: (base preset, PoIs)
POIS = "pois300"
MANY_POIS = {POIS: (None, 300), "pois360": (None, 360), "20uav-pois50": (WIDE, 50)}
# ROADMAP B3's hidden widths: each held at 16 envs (``check_wide_hidden``),
# past one column pass (300, 1,024) and off multiples of 8 (100); the main
# path's shapes at HIDDEN_ENVS envs at 512 and 1,024, timed at ``HIDDEN_ROW``
# only (the {"kernels": [...]} line's rows, names with the suffix ``_h512``;
# 1,024's readings only, for the smoke's time)
HIDDEN_CHECKS = (100, 300, 1024)
HIDDEN_TIMED = (512, 1024)
HIDDEN_ENVS = 1024  # the env count of the HIDDEN_TIMED shapes
# ROADMAP B3 rest, the column-blocked layout (``check_blocked``): each kernel
# in it at these hidden widths at 16 envs; the main path's shapes at
# BLOCKED_TIMED wide and BLOCKED_ENVS envs, timed; the widths of its
# bit-for-bit checks against the staged and depth layouts; the
# {"kernels": [...]} line's rows, names with the suffix ``_blocked_h<H>``
BLOCKED_CHECKS = (1152, 2048, 4096)
BLOCKED_TIMED = 2048
BLOCKED_ENVS = 256
BLOCKED_BITS = (512, 800, 1024)
HIDDEN_ROW = 512
# the trunks' layers the deep phase holds every kernel at (16 envs), and
# those whose bf16 rows it times for the {"kernels": [...]} line
DEEP_LAYERS = (8, 9, 32)
DEEP_TIMED = (9, 32)
# past two layers a bf16 check's limit is the larger of its bound and
# ORDER_FACTOR times the plain version's own spread in another summation
# order (``bf16_limit``): at 32 layers that spread passes the bounds (ROADMAP
# C8), and the kernels read 1.05 to 2.05 times it there; the kernel
# computed in f32 must lie outside the limit, as outside a bound (K2's, the
# bf16 rounding of its output alone, reads 2.4 to 3.5 times the spread
# there, the gradient kernels' 69 times and more)
ORDER_FACTOR = 2.25
# the value-flip rule's allowance (``value_flips``): VALUE_FLIP_FACTOR times
# as many rows as the plain version rounds apart itself in another
# summation order (the kernel 3.2 to 3.6 times as many at 9 and 32 layers)
VALUE_FLIP_FACTOR = 4
DEEP_KERNELS = ("fused_mlp", "fused_mlp_bwd", "actor_ppo_grads", "critic_ppo_grads",
                "actor_ppo_grads_unfolded", "critic_ppo_grads_unfolded")
# K1: the C entry every launch goes through; the (T, E) shapes held against
# the plain version (ragged, T = 1, fewer columns than a warp); the timed ones
GAE_ENTRY = "dcc_gae_seg"
GAE_TIMED = ((150, 16), (150, BIG_ENVS))
# (150, WIDE_ENVS) is the 20-UAV run's; the last three walk time in two
# rounds (T > S * L under gae_plan)
GAE_SHAPES = GAE_TIMED + ((1, 16), (5, 3), (151, 17), (150, BIG_ENVS + 3), (150, WIDE_ENVS),
                          (1000, 64), (2000, 16), (600, BIG_ENVS + 3))
# bf16 bounds on ||kernel - plain|| / ||plain|| per tensor. Kernel and plain
# version round at the same points; summation order flips single bf16
# roundings. The bound sits between those readings and the kernel computed
# in f32 on the same inputs, which every bf16 check also measures.
K2_BF16_REL = 2e-3
PPO_BF16_REL = 4e-3
# K2b: a summation-order difference in the f32 chain can flip the bf16
# rounding of a cotangent element before the next product (measured up to
# 1.2e-3); the kernel computed in f32 reads 6.5e-2 to 7.0e-2.
K2B_BF16_REL = 4e-3
# the dV0 kernel of the chunked K4 and its plain version take the same bf16
# operands: only the f32 summation order differs; the product of the
# unrounded xhat lies about a bf16 step (2^-9 relative) away. The same for
# its affine mode and for the layer-0 input backward (g0 W_0^T and the
# feature norm's backward in f32), whose reading is the product with the
# unrounded W_0
DV0_REL = 1e-4
REPLACES = {
    "gae": "dcc_tpu/ops/pallas_gae.py:56",
    "fused_mlp": "dcc_tpu/ops/fused_mlp.py:319",
    "fused_mlp_bwd": "dcc_tpu/ops/fused_mlp.py:299",
    "actor_ppo_grads": "dcc_tpu/ops/fused_ppo.py:575",
    "critic_ppo_grads": "dcc_tpu/ops/fused_ppo.py:667",
    # the same Pallas programs with folded=False (_actor_kernel, _critic_kernel)
    "actor_ppo_grads_unfolded": "dcc_tpu/ops/fused_ppo.py:290",
    "critic_ppo_grads_unfolded": "dcc_tpu/ops/fused_ppo.py:378",
    # K4 at rows too wide for a staged tile: its chunked kernel, and the
    # second launch, layer 0's weight gradient, which the TPU kernel sums in
    # its own body
    "critic_ppo_grads_chunked": "dcc_tpu/ops/fused_ppo.py:667",
    "critic_ppo_grads_dv0": "dcc_tpu/ops/fused_ppo.py:667",
    # K2b and K4u at those rows: the chunked kernels, and the two launches
    # that finish their layer 0 (the body of _bwd_kernel below layer 0's
    # cotangent: dW0 at :194, g_prev and the feature norm's backward at
    # :208-222; K4u's _critic_kernel runs the same chain)
    "fused_mlp_bwd_chunked": "dcc_tpu/ops/fused_mlp.py:299",
    "critic_ppo_grads_unfolded_chunked": "dcc_tpu/ops/fused_ppo.py:378",
    "layer0_input_bwd": "dcc_tpu/ops/fused_mlp.py:152",
    "dv0_unfolded": "dcc_tpu/ops/fused_mlp.py:152",
    # K2, K3 and K3u at rows too wide for a staged tile (the many-PoI swarm's
    # 6,040-wide critic and 1,510-wide actor rows): the chunked kernels, and
    # K3's second launch, layer 0's weight gradient (dV0)
    "fused_mlp_chunked": "dcc_tpu/ops/fused_mlp.py:319",
    "actor_ppo_grads_chunked": "dcc_tpu/ops/fused_ppo.py:575",
    "actor_ppo_grads_unfolded_chunked": "dcc_tpu/ops/fused_ppo.py:290",
    "actor_ppo_grads_dv0": "dcc_tpu/ops/fused_ppo.py:575",
    # the same kernels at hidden 512 (two column passes a layer): K2, K2b,
    # K3, K4 and K3u / K4u at the default widths, K4's chunked kernel and
    # dV0 at the 20-UAV preset's
    **{f"{k}_h{HIDDEN_ROW}": v for k, v in (
        ("fused_mlp", "dcc_tpu/ops/fused_mlp.py:265"),
        ("fused_mlp_bwd", "dcc_tpu/ops/fused_mlp.py:299"),
        ("actor_ppo_grads", "dcc_tpu/ops/fused_ppo.py:552"),
        ("critic_ppo_grads", "dcc_tpu/ops/fused_ppo.py:644"),
        ("actor_ppo_grads_unfolded", "dcc_tpu/ops/fused_ppo.py:552"),
        ("critic_ppo_grads_unfolded", "dcc_tpu/ops/fused_ppo.py:644"),
        ("critic_ppo_grads_chunked", "dcc_tpu/ops/fused_ppo.py:644"),
        ("critic_ppo_grads_dv0", "dcc_tpu/ops/fused_ppo.py:644"))},
}
SOURCES = {
    "gae": "dcc_tpu_torch/csrc/gae.cu",
    "fused_mlp": "dcc_tpu_torch/csrc/fused_mlp.cu",
    "fused_mlp_bwd": "dcc_tpu_torch/csrc/fused_mlp_bwd.cu",
    "actor_ppo_grads": "dcc_tpu_torch/csrc/fused_ppo.cu",
    "critic_ppo_grads": "dcc_tpu_torch/csrc/fused_ppo.cu",
    "actor_ppo_grads_unfolded": "dcc_tpu_torch/csrc/fused_ppo.cu",
    "critic_ppo_grads_unfolded": "dcc_tpu_torch/csrc/fused_ppo.cu",
    "critic_ppo_grads_chunked": "dcc_tpu_torch/csrc/fused_ppo.cu",
    "critic_ppo_grads_dv0": "dcc_tpu_torch/csrc/layer0_tail.cu",
    "fused_mlp_bwd_chunked": "dcc_tpu_torch/csrc/fused_mlp_bwd.cu",
    "critic_ppo_grads_unfolded_chunked": "dcc_tpu_torch/csrc/fused_ppo.cu",
    "layer0_input_bwd": "dcc_tpu_torch/csrc/layer0_tail.cu",
    "dv0_unfolded": "dcc_tpu_torch/csrc/layer0_tail.cu",
    "fused_mlp_chunked": "dcc_tpu_torch/csrc/fused_mlp.cu",
    "actor_ppo_grads_chunked": "dcc_tpu_torch/csrc/fused_ppo.cu",
    "actor_ppo_grads_unfolded_chunked": "dcc_tpu_torch/csrc/fused_ppo.cu",
    "actor_ppo_grads_dv0": "dcc_tpu_torch/csrc/layer0_tail.cu",
}
SOURCES.update({f"{k}_h{HIDDEN_ROW}": SOURCES[k] for k in (
    "fused_mlp", "fused_mlp_bwd", "actor_ppo_grads", "critic_ppo_grads",
    "actor_ppo_grads_unfolded", "critic_ppo_grads_unfolded", "critic_ppo_grads_chunked",
    "critic_ppo_grads_dv0")})
# the check whose numbers the {"kernels": [...]} line reports for each of
# its names, and the counter of that name's launches: (kernel, envs, preset)
# of the first bf16 check (K1 f32) with no minibatch; (name, 16, None)
# where not listed. The chunked K4 and the dV0 kernel run only at rows too
# wide for a staged K4 tile: the 20-UAV preset's, read at the main path's
# 153,600 rows. The chunked K4 counts under critic_ppo_grads, and its time
# and bound are both launches'; the dV0 row's are its own. So for the
# chunked K2b (the fused-loss-off run's 38,400 critic rows of an update
# chunk) and K4u (153,600 rows, counted under critic_ppo_grads_unfolded):
# time and bound of their three launches; the layer-0 input backward's
# (38,400 rows, no dx) and dV0's unfolded mode (153,600 rows) their own.
# The chunked K2, K3 and K3u at the many-PoI swarm's main path (1,024 envs:
# K2 on 1,024 critic rows of a rollout step, K3 / K3u on 614,400 actor
# rows); the chunked K2 counts under fused_mlp_chunked, K3 and K3u under
# their own names, the time and bound of K3 both launches', K3u's three;
# K3's dV0 alone, actor_ppo_grads_dv0.
# The rows at hidden 512: the main path's shapes at HIDDEN_ENVS envs (K2 on a
# rollout step's 1,024 x 440 critic rows, 614,400 x 110 and 153,600 x 440
# for K3 / K4 and K3u / K4u; K4's chunked kernel and dV0 on the 20-UAV
# preset's 153,600 x 4,840), K2b on the 153,600 x 110 rows of an update
# chunk at HIDDEN_ENVS (its 16-env rows are at HIDDEN_CHECKS only).
# Entries: (kernel, envs, preset[, hidden[, text the row's shape holds]]).
KERNEL_ROW = {"critic_ppo_grads_chunked": ("critic_ppo_grads", WIDE_ENVS, WIDE),
              "critic_ppo_grads_dv0": ("critic_ppo_grads_dv0", WIDE_ENVS, WIDE),
              "fused_mlp_bwd_chunked": ("fused_mlp_bwd_chunked", WIDE_ENVS, WIDE),
              "critic_ppo_grads_unfolded_chunked": ("critic_ppo_grads_unfolded", WIDE_ENVS,
                                                    WIDE),
              "layer0_input_bwd": ("layer0_input_bwd", WIDE_ENVS, WIDE),
              "dv0_unfolded": ("dv0_unfolded", WIDE_ENVS, WIDE),
              "fused_mlp_chunked": ("fused_mlp_chunked", WIDE_ENVS, POIS),
              "actor_ppo_grads_chunked": ("actor_ppo_grads", WIDE_ENVS, POIS),
              "actor_ppo_grads_unfolded_chunked": ("actor_ppo_grads_unfolded", WIDE_ENVS, POIS),
              "actor_ppo_grads_dv0": ("actor_ppo_grads_dv0", WIDE_ENVS, POIS),
              **{f"{k}_h{HIDDEN_ROW}": (k, HIDDEN_ENVS, None, HIDDEN_ROW) for k in (
                  "actor_ppo_grads", "critic_ppo_grads", "actor_ppo_grads_unfolded",
                  "critic_ppo_grads_unfolded")},
              f"fused_mlp_h{HIDDEN_ROW}": ("fused_mlp", HIDDEN_ENVS, None, HIDDEN_ROW,
                                           "d_in=440"),
              f"fused_mlp_bwd_h{HIDDEN_ROW}": ("fused_mlp_bwd", HIDDEN_ENVS // 4, None,
                                               HIDDEN_ROW),
              f"critic_ppo_grads_chunked_h{HIDDEN_ROW}": ("critic_ppo_grads", HIDDEN_ENVS, WIDE,
                                                         HIDDEN_ROW),
              f"critic_ppo_grads_dv0_h{HIDDEN_ROW}": ("critic_ppo_grads_dv0", HIDDEN_ENVS, WIDE,
                                                     HIDDEN_ROW)}
# the deep phase's rows (``check_deep``), names with the suffix _L9 or _L32:
# each bf16 kernel at 16 envs (K2 on the actor's 64 rows, K2b on the
# actor's 9,600, K3 / K3u on 9,600 x 110, K4 / K4u on 2,400 x 440) at 9
# and 32 layers, the same JAX sites as at two
for _L in DEEP_TIMED:
    for _k in DEEP_KERNELS:
        REPLACES[f"{_k}_L{_L}"] = REPLACES[_k]
        SOURCES[f"{_k}_L{_L}"] = SOURCES[_k]
        KERNEL_ROW[f"{_k}_L{_L}"] = (_k, 16, None, 256, f" L={_L}")
# the column-blocked phase's rows (``check_blocked``), names with the suffix
# _blocked_h<H>: each bf16 kernel in the column-blocked layout at 16 envs at
# each of BLOCKED_CHECKS (K2 on the actor's 64 rows, K2b on its 9,600 x 110,
# K3 / K3u on 9,600 x 110, K4 / K4u on 2,400 x 440, the layer-0 input
# backward with dx on 2,400 x 4,840), and _blocked_h<H>_e<envs> at the main
# path's shapes (K2 on a rollout step's critic rows, K2b on the 153,600 x
# 110 rows of an update, K3 / K3u on 153,600 x 110, K4 / K4u on 38,400 x
# 440); the same JAX sites, their blocked sources
BLOCKED_KERNELS = DEEP_KERNELS + ("layer0_input_bwd",)
BLOCKED_SOURCE = {"fused_mlp": "dcc_tpu_torch/csrc/fused_mlp_blocked.cu",
                  "fused_mlp_bwd": "dcc_tpu_torch/csrc/fused_mlp_bwd_blocked.cu",
                  "layer0_input_bwd": "dcc_tpu_torch/csrc/fused_mlp_bwd_blocked.cu"}
for _H in BLOCKED_CHECKS:
    for _k in BLOCKED_KERNELS:
        _name = f"{_k}_blocked_h{_H}"
        REPLACES[_name] = REPLACES[_k]
        SOURCES[_name] = BLOCKED_SOURCE.get(_k, "dcc_tpu_torch/csrc/fused_ppo_blocked.cu")
        KERNEL_ROW[_name] = (f"{_k}_blocked", 16, WIDE if _k == "layer0_input_bwd" else None,
                             _H)
# the layout's chunked K4 and K4u on 2,400 of the 20-UAV preset's
# 4,840-wide critic rows at BLOCKED_TIMED (16 envs; time and bound with
# the layer-0 tail's launches), as the preset's runs launch them
for _k in ("critic_ppo_grads", "critic_ppo_grads_unfolded"):
    _name = f"{_k}_chunked_blocked_h{BLOCKED_TIMED}"
    REPLACES[_name] = REPLACES[_k]
    SOURCES[_name] = "dcc_tpu_torch/csrc/fused_ppo_blocked.cu"
    KERNEL_ROW[_name] = (f"{_k}_blocked", 16, WIDE, BLOCKED_TIMED)
for _k in DEEP_KERNELS:
    _name = f"{_k}_blocked_h{BLOCKED_TIMED}_e{BLOCKED_ENVS}"
    REPLACES[_name] = REPLACES[_k]
    SOURCES[_name] = BLOCKED_SOURCE.get(_k, "dcc_tpu_torch/csrc/fused_ppo_blocked.cu")
    KERNEL_ROW[_name] = (f"{_k}_blocked", BLOCKED_ENVS, None, BLOCKED_TIMED,
                         "d_in=440" if _k == "fused_mlp" else "")
# the training runs of phase 5: (tag, arguments beyond BASE_ARGS, launches
# per iteration of each kernel; every other kernel must not launch)
BASE_ARGS = ["--n-iters", "1", "--save-gifs", "false", "--save-model", "false",
             "--n-eval-rollout-threads", "0", "--seed", "0"]
BF16 = ["--compute-dtype", "bfloat16"]
TWO_ITERS = ["--n-iters", "2"]
RECURRENT = ["--use-recurrent-policy", "true"]
SEPARATED = ["--use-separated-policy", "true"]
HEAD_MODES = ("discrete", "multi_discrete", "multi_binary", "mixed")
BF16_PRESETS = ("5uav_dense_conn", "10uav_moving_collision")


# the many-PoI swarm's runs: the default env with 300 PoIs, one iteration at
# 256 envs; what each cuts of its scale, kept with its results
POIS_ARGS = ["--num-pois", "300", "--n-rollout-threads", str(RUN_ENVS), "--n-iters", "1"]
POIS_REDUCED = {"n_rollout_threads": f"{RUN_ENVS} of bench.py's headline {BIG_ENVS} envs "
                                     f"(one card, the smoke's time)",
                "n_iters": "1 iteration"}


def preset_args(name: str) -> list:
    """The CLI arguments that select a named env preset's YAML."""
    return ["--env-yaml", os.path.join("dcc_tpu_torch", "configs", "env_config",
                                       f"dcc_{name}.yaml")]


def hidden_args(hidden: int) -> list:
    """The CLI arguments of one iteration at the hidden width ``hidden``."""
    return ["--algo-hidden-size", str(hidden), "--n-iters", "1"]


def algo_yaml(name: str) -> list:
    """The CLI arguments that select an algo YAML of the port."""
    return ["--algo-yaml", os.path.join("dcc_tpu_torch", "configs", "algo_config",
                                        f"{name}.yaml")]


# MADDPG's runs evaluate once, at their last iteration
MADDPG_ARGS = ["--n-eval-rollout-threads", "16", "--eval-interval", "2", "--n-iters", "2"]
SPREAD = ["--scenario-name", "spread", "--num-landmarks", "4"]

TRAIN_RUNS = (
    ("f32", [], {"gae": 1}),
    # 2 iterations for each fused path (folded, unfolded and the fused loss
    # off): the second rolls out on parameters packed after an update
    ("bf16", BF16 + TWO_ITERS, {"gae": 1, "fused_mlp": 301, "actor_ppo_grads": 15,
                                "critic_ppo_grads": 15}),
    ("recurrent-bf16", BF16 + RECURRENT + TWO_ITERS,
     {"gae": 1, "fused_mlp": 331, "fused_mlp_bwd": 30}),
    ("recurrent-f32", RECURRENT + ["--n-iters", "1"], {"gae": 1}),
    ("bf16-fused-loss-off", BF16 + ["--fused-loss", "off", "--n-iters", "1"],
     {"gae": 1, "fused_mlp": 331, "fused_mlp_bwd": 30}),
    # the fused minibatch path: K3 / K4 on each gathered quarter of the rows
    ("bf16-nmb4", BF16 + ["--num-mini-batch", "4"],
     {"gae": 1, "fused_mlp": 301, "actor_ppo_grads": 60, "critic_ppo_grads": 60}),
    # the unfolded kernels K3u / K4u, with PopArt's head rescale each epoch
    ("bf16-unfolded-popart", BF16 + TWO_ITERS + ["--fused-fold", "false", "--use-popart",
                                                 "true", "--use-valuenorm", "false"],
     {"gae": 1, "fused_mlp": 301, "actor_ppo_grads_unfolded": 15,
      "critic_ppo_grads_unfolded": 15}),
    # chunk minibatches: K2 and K2b once per network and minibatch
    ("recurrent-bf16-nmb2", BF16 + RECURRENT + ["--num-mini-batch", "2"],
     {"gae": 1, "fused_mlp": 361, "fused_mlp_bwd": 60}),
    # gradient accumulation over 4 row chunks with recomputed forwards
    ("f32-chunks4-remat", ["--update-chunks", "4", "--use-remat", "true", "--n-iters", "1"],
     {"gae": 1}),
    # the non-Gaussian heads in bf16: K2 in the rollout, the update by
    # autograd through K2 and K2b (the fused loss takes the Gaussian only)
    *((f"bf16-{mode}", BF16 + ["--action-mode", mode, "--n-iters", "1"],
       {"gae": 1, "fused_mlp": 331, "fused_mlp_bwd": 30}) for mode in HEAD_MODES),
    # each one-card preset as written (f32: K1 only), and two in bf16, whose
    # K2, K3 and K4 run at actor / critic widths 192 / 960 and 122 / 1,220
    *((f"preset-{name}", preset_args(name) + ["--n-iters", "1"], {"gae": 1})
      for name in ("3uav_small", "5uav_dense_conn", "10uav_moving_collision",
                   "throughput_4096")),
    *((f"preset-{name}-bf16", preset_args(name) + BF16 + ["--n-iters", "1"],
       {"gae": 1, "fused_mlp": 301, "actor_ppo_grads": 15, "critic_ppo_grads": 15})
      for name in BF16_PRESETS),
    # separated per-agent policies: K1 on the (env, agent) columns; the
    # fused trunk and loss take the shared policy only
    ("separated-f32", SEPARATED, {"gae": 1}),
    ("separated-bf16", SEPARATED + BF16 + ["--n-iters", "1"], {"gae": 1}),
    ("separated-recurrent-f32-nmb2", SEPARATED + RECURRENT + ["--num-mini-batch", "2",
                                                              "--n-iters", "1"], {"gae": 1}),
    # the 20-UAV preset as written but for its envs: bf16, K2 on 242- and
    # 4,840-wide rows, K3 on 768,000 x 242, K4 through its chunked layer 0
    # and the dV0 kernel on 38,400 x 4,840; update_chunks 4 and remat take
    # no part in the fused update
    (f"preset-{WIDE}", preset_args(WIDE) + ["--n-rollout-threads", str(RUN_ENVS),
                                            "--n-iters", "1"],
     {"gae": 1, "fused_mlp": 301, "actor_ppo_grads": 15, "critic_ppo_grads": 15,
      "critic_ppo_grads_dv0": 15}),
    # the same with the fused loss off: autograd through K2 and K2b over 4
    # update chunks with remat (the forwards run twice), the actor's
    # 192,000 x 242 rows through the staged K2b, the critic's 9,600 x 4,840
    # through the chunked K2b, the layer-0 input backward and dV0
    (f"preset-{WIDE}-fused-loss-off",
     preset_args(WIDE) + ["--n-rollout-threads", str(RUN_ENVS), "--n-iters", "1",
                          "--fused-loss", "off"],
     {"gae": 1, "fused_mlp": 541, "fused_mlp_bwd": 60, "fused_mlp_bwd_chunked": 60,
      "layer0_input_bwd": 60, "dv0_unfolded": 60}),
    # unfolded: K3u on 768,000 x 242, K4u chunked on 38,400 x 4,840
    (f"preset-{WIDE}-unfolded",
     preset_args(WIDE) + ["--n-rollout-threads", str(RUN_ENVS), "--n-iters", "1",
                          "--fused-fold", "false"],
     {"gae": 1, "fused_mlp": 301, "actor_ppo_grads_unfolded": 15,
      "critic_ppo_grads_unfolded": 15, "layer0_input_bwd": 15, "dv0_unfolded": 15}),
    # the recurrent policy at 64 envs (its critic rows, duplicated per agent,
    # are T*E*A x 4,840: 1.9 GB in bf16), without update chunks, which the
    # recurrent update does not take (JAX refuses them too)
    (f"preset-{WIDE}-recurrent",
     preset_args(WIDE) + ["--n-rollout-threads", "64", "--n-iters", "1",
                          "--use-recurrent-policy", "true", "--update-chunks", "1"],
     {"gae": 1, "fused_mlp": 331, "fused_mlp_bwd": 15, "fused_mlp_bwd_chunked": 15,
      "layer0_input_bwd": 15, "dv0_unfolded": 15}),
    # the many-PoI swarm (4 UAVs, 300 PoIs) in bf16 at 256 envs: K2 on the
    # 1,510-wide actor rows staged (150), on the 6,040-wide critic rows
    # chunked (151); K3 and K4 chunked on 153,600 x 1,510 and 38,400 x
    # 6,040, each with its dV0
    (f"{POIS}-bf16", BF16 + POIS_ARGS,
     {"gae": 1, "fused_mlp": 150, "fused_mlp_chunked": 151, "actor_ppo_grads": 15,
      "critic_ppo_grads": 15, "actor_ppo_grads_dv0": 15, "critic_ppo_grads_dv0": 15}),
    # unfolded: K3u and K4u chunked, each with the layer-0 input backward and
    # dV0 in its affine mode
    (f"{POIS}-bf16-unfolded", BF16 + POIS_ARGS + ["--fused-fold", "false"],
     {"gae": 1, "fused_mlp": 150, "fused_mlp_chunked": 151, "actor_ppo_grads_unfolded": 15,
      "critic_ppo_grads_unfolded": 15, "layer0_input_bwd": 30, "dv0_unfolded": 30}),
    # the fused loss off: autograd through K2 (once more per network and
    # epoch) and K2b, staged on the actor's rows, chunked on the critic's
    (f"{POIS}-bf16-fused-loss-off", BF16 + POIS_ARGS + ["--fused-loss", "off"],
     {"gae": 1, "fused_mlp": 165, "fused_mlp_chunked": 166, "fused_mlp_bwd": 15,
      "fused_mlp_bwd_chunked": 15, "layer0_input_bwd": 15, "dv0_unfolded": 15}),
    # ROADMAP B3's hidden widths, one bf16 iteration each at 16 envs, every
    # kernel in column passes past 256 or zero-padded off multiples of 8:
    # 512 folded (K2, K3, K4), unfolded (K3u, K4u) and with the fused loss off
    # (K2, K2b); 100 unfolded; 1,024 with the fused loss off; recurrent at 300
    ("bf16-h512", BF16 + hidden_args(512),
     {"gae": 1, "fused_mlp": 301, "actor_ppo_grads": 15, "critic_ppo_grads": 15}),
    ("bf16-h512-unfolded", BF16 + hidden_args(512) + ["--fused-fold", "false"],
     {"gae": 1, "fused_mlp": 301, "actor_ppo_grads_unfolded": 15,
      "critic_ppo_grads_unfolded": 15}),
    ("bf16-h512-fused-loss-off", BF16 + hidden_args(512) + ["--fused-loss", "off"],
     {"gae": 1, "fused_mlp": 331, "fused_mlp_bwd": 30}),
    ("bf16-h100-unfolded", BF16 + hidden_args(100) + ["--fused-fold", "false"],
     {"gae": 1, "fused_mlp": 301, "actor_ppo_grads_unfolded": 15,
      "critic_ppo_grads_unfolded": 15}),
    ("bf16-h1024-fused-loss-off", BF16 + hidden_args(1024) + ["--fused-loss", "off"],
     {"gae": 1, "fused_mlp": 331, "fused_mlp_bwd": 30}),
    ("recurrent-bf16-h300", BF16 + RECURRENT + hidden_args(300),
     {"gae": 1, "fused_mlp": 331, "fused_mlp_bwd": 30}),
    # the 20-UAV preset at hidden 512, 256 envs: K3 staged on 768,000 x
    # 242 x 512, K4 chunked with dV0 on 38,400 x 4,840 x 512
    (f"preset-{WIDE}-h512", preset_args(WIDE) + hidden_args(512)
     + ["--n-rollout-threads", str(RUN_ENVS)],
     {"gae": 1, "fused_mlp": 301, "actor_ppo_grads": 15, "critic_ppo_grads": 15,
      "critic_ppo_grads_dv0": 15}),
    # MADDPG (batched torch products over agent-stacked parameters, no
    # kernel of the port) with both YAMLs on coverage and on spread; MAPPO in
    # bf16 on spread (18 / 72-wide rows through K2, K3 and K4)
    ("maddpg", algo_yaml("maddpg") + MADDPG_ARGS, {}),
    ("maddpg-tuned", algo_yaml("maddpg_tuned") + MADDPG_ARGS, {}),
    ("maddpg-spread", algo_yaml("maddpg") + SPREAD + MADDPG_ARGS, {}),
    ("spread-bf16", BF16 + SPREAD, {"gae": 1, "fused_mlp": 301, "actor_ppo_grads": 15,
                                    "critic_ppo_grads": 15}),
)
# the runs of MADDPG and of the spread scenario (scripts/smoke_phase.py maddpg)
SCENARIO_RUNS = ("maddpg", "maddpg-tuned", "maddpg-spread", "spread-bf16")


def depth_args(layer_n: int) -> list:
    """The CLI arguments of one iteration of a trunk of ``layer_n`` + 1
    layers."""
    return ["--layer-N", str(layer_n), "--n-iters", "1"]


# the deep phase's runs (``check_deep``): the main path at 9 layers
# (``--layer-N`` 8, the first depth the CUDA entries used to refuse; every
# bf16 kernel still stages its layers in shared memory) and at 32 (every bf16
# gradient kernel in its depth layout), folded, unfolded and with the fused
# loss off; f32 with the fused kernels forced on at 8 and 9 layers (the f32
# K2b, K3u and K4u read 42 to 45 offsets at 8 layers, past the by-value
# table the entries took before); the 20-UAV preset at 9 layers and 1,024
# envs (the chunked K2 and K4 on its 4,840-wide critic rows)
FORCED = ["--fused-trunk", "on", "--fused-loss", "on"]
FOLDED_LAUNCHES = {"gae": 1, "fused_mlp": 301, "actor_ppo_grads": 15, "critic_ppo_grads": 15}
UNFOLDED_LAUNCHES = {"gae": 1, "fused_mlp": 301, "actor_ppo_grads_unfolded": 15,
                     "critic_ppo_grads_unfolded": 15}
LOSS_OFF_LAUNCHES = {"gae": 1, "fused_mlp": 331, "fused_mlp_bwd": 30}
DEEP_RUNS = (
    *((f"bf16-L{n + 1}", BF16 + depth_args(n), FOLDED_LAUNCHES) for n in (8, 31)),
    *((f"bf16-L{n + 1}-unfolded", BF16 + depth_args(n) + ["--fused-fold", "false"],
       UNFOLDED_LAUNCHES) for n in (8, 31)),
    *((f"bf16-L{n + 1}-fused-loss-off", BF16 + depth_args(n) + ["--fused-loss", "off"],
       LOSS_OFF_LAUNCHES) for n in (8, 31)),
    *((f"f32-L{n + 1}-fused", FORCED + depth_args(n), FOLDED_LAUNCHES) for n in (7, 8)),
    ("f32-L8-fused-unfolded", FORCED + depth_args(7) + ["--fused-fold", "false"],
     UNFOLDED_LAUNCHES),
    *((f"f32-L{n + 1}-fused-loss-off", ["--fused-trunk", "on"] + depth_args(n)
       + ["--fused-loss", "off"], LOSS_OFF_LAUNCHES) for n in (7, 8)),
    (f"preset-{WIDE}-L9", preset_args(WIDE) + ["--n-rollout-threads", str(RUN_ENVS)]
     + depth_args(8), {"gae": 1, "fused_mlp": 301, "actor_ppo_grads": 15,
                       "critic_ppo_grads": 15, "critic_ppo_grads_dv0": 15}),
)
# the column-blocked phase's runs (``check_blocked``): bf16 at hidden
# BLOCKED_TIMED, 2 iterations at BLOCKED_ENVS envs, folded, unfolded and with
# the fused loss off (every gradient kernel in the column-blocked layout, K2
# staged); hidden 4,096, one iteration at 16 envs (K2 too); the 20-UAV
# preset at BLOCKED_TIMED (K3 column-blocked, K4's chunked column-blocked
# kernel and dV0, K2 staged and chunked) and at 4,800 unfolded (K2 and K3u
# column-blocked, K4u chunked column-blocked, the layer-0 input backward's
# column-blocked build, dV0), one iteration at 16 envs each
BLOCKED_ARGS = BF16 + ["--algo-hidden-size", str(BLOCKED_TIMED), "--n-rollout-threads",
                       str(BLOCKED_ENVS), "--n-iters", "2"]
BLOCKED_RUNS = (
    (f"bf16-h{BLOCKED_TIMED}", BLOCKED_ARGS,
     {"gae": 1, "fused_mlp": 301, "actor_ppo_grads_blocked": 15,
      "critic_ppo_grads_blocked": 15}),
    (f"bf16-h{BLOCKED_TIMED}-unfolded", BLOCKED_ARGS + ["--fused-fold", "false"],
     {"gae": 1, "fused_mlp": 301, "actor_ppo_grads_unfolded_blocked": 15,
      "critic_ppo_grads_unfolded_blocked": 15}),
    (f"bf16-h{BLOCKED_TIMED}-fused-loss-off", BLOCKED_ARGS + ["--fused-loss", "off"],
     {"gae": 1, "fused_mlp": 331, "fused_mlp_bwd_blocked": 30}),
    ("bf16-h4096", BF16 + hidden_args(4096),
     {"gae": 1, "fused_mlp_blocked": 301, "actor_ppo_grads_blocked": 15,
      "critic_ppo_grads_blocked": 15}),
    (f"preset-{WIDE}-h{BLOCKED_TIMED}", preset_args(WIDE) + hidden_args(BLOCKED_TIMED)
     + ["--n-rollout-threads", "16"],
     {"gae": 1, "fused_mlp": 150, "fused_mlp_chunked": 151, "actor_ppo_grads_blocked": 15,
      "critic_ppo_grads_blocked": 15, "critic_ppo_grads_dv0": 15}),
    (f"preset-{WIDE}-h4800-unfolded", preset_args(WIDE) + hidden_args(4800)
     + ["--n-rollout-threads", "16", "--fused-fold", "false"],
     {"gae": 1, "fused_mlp_blocked": 301, "actor_ppo_grads_unfolded_blocked": 15,
      "critic_ppo_grads_unfolded_blocked": 15, "layer0_input_bwd_blocked": 15,
      "dv0_unfolded": 15}),
)
# the run whose launches the {"kernels": [...]} line reports for each kernel
MAIN_RUN = {"gae": "bf16", "fused_mlp": "bf16", "actor_ppo_grads": "bf16",
            "critic_ppo_grads": "bf16", "fused_mlp_bwd": "recurrent-bf16",
            "actor_ppo_grads_unfolded": "bf16-unfolded-popart",
            "critic_ppo_grads_unfolded": "bf16-unfolded-popart",
            "critic_ppo_grads_chunked": f"preset-{WIDE}",
            "critic_ppo_grads_dv0": f"preset-{WIDE}",
            "fused_mlp_bwd_chunked": f"preset-{WIDE}-fused-loss-off",
            "critic_ppo_grads_unfolded_chunked": f"preset-{WIDE}-unfolded",
            "layer0_input_bwd": f"preset-{WIDE}-fused-loss-off",
            "dv0_unfolded": f"preset-{WIDE}-fused-loss-off",
            "fused_mlp_chunked": f"{POIS}-bf16", "actor_ppo_grads_chunked": f"{POIS}-bf16",
            "actor_ppo_grads_unfolded_chunked": f"{POIS}-bf16-unfolded",
            "actor_ppo_grads_dv0": f"{POIS}-bf16",
            **{f"{k}_h{HIDDEN_ROW}": f"bf16-h{HIDDEN_ROW}" for k in (
                "fused_mlp", "actor_ppo_grads", "critic_ppo_grads")},
            f"fused_mlp_bwd_h{HIDDEN_ROW}": f"bf16-h{HIDDEN_ROW}-fused-loss-off",
            **{f"{k}_h{HIDDEN_ROW}": f"bf16-h{HIDDEN_ROW}-unfolded" for k in (
                "actor_ppo_grads_unfolded", "critic_ppo_grads_unfolded")},
            f"critic_ppo_grads_chunked_h{HIDDEN_ROW}": f"preset-{WIDE}-h{HIDDEN_ROW}",
            f"critic_ppo_grads_dv0_h{HIDDEN_ROW}": f"preset-{WIDE}-h{HIDDEN_ROW}",
            **{f"{k}_L{L}": f"bf16-L{L}" for L in DEEP_TIMED
               for k in ("fused_mlp", "actor_ppo_grads", "critic_ppo_grads")},
            **{f"fused_mlp_bwd_L{L}": f"bf16-L{L}-fused-loss-off" for L in DEEP_TIMED},
            **{f"{k}_L{L}": f"bf16-L{L}-unfolded" for L in DEEP_TIMED
               for k in ("actor_ppo_grads_unfolded", "critic_ppo_grads_unfolded")},
            **{f"{k}_blocked_h{H}{e}": run for H in BLOCKED_CHECKS
               for e in ("", f"_e{BLOCKED_ENVS}") for k, run in (
                   ("fused_mlp", "bf16-h4096"),
                   ("fused_mlp_bwd", f"bf16-h{BLOCKED_TIMED}-fused-loss-off"),
                   ("actor_ppo_grads", f"bf16-h{BLOCKED_TIMED}"),
                   ("critic_ppo_grads", f"bf16-h{BLOCKED_TIMED}"),
                   ("actor_ppo_grads_unfolded", f"bf16-h{BLOCKED_TIMED}-unfolded"),
                   ("critic_ppo_grads_unfolded", f"bf16-h{BLOCKED_TIMED}-unfolded"),
                   ("layer0_input_bwd", f"preset-{WIDE}-h4800-unfolded"))},
            f"critic_ppo_grads_chunked_blocked_h{BLOCKED_TIMED}": f"preset-{WIDE}-h{BLOCKED_TIMED}",
            f"critic_ppo_grads_unfolded_chunked_blocked_h{BLOCKED_TIMED}":
                f"preset-{WIDE}-h4800-unfolded"}
# the C entry point each bf16 run's kernels must go through (and every
# run's K1, GAE_ENTRY)
_TRUNK_MMA = {"fused_mlp": "dcc_trunk_fwd_mma", "fused_mlp_bwd": "dcc_trunk_bwd_mma"}
# K2b at the 20-UAV preset's widths: staged on the actor's rows, chunked on
# the critic's, with the kernels that finish its layer 0
_WIDE_TRUNK_MMA = {**_TRUNK_MMA, "fused_mlp_bwd_chunked": "dcc_trunk_bwd_chunked_mma",
                   "layer0_input_bwd": "dcc_layer0_input_bwd_wgmma", "dv0_unfolded": "dcc_dv0_wgmma"}
_FOLDED_MMA = {"fused_mlp": "dcc_trunk_fwd_mma", "actor_ppo_grads": "dcc_actor_grads_mma",
               "critic_ppo_grads": "dcc_critic_grads_mma"}
_UNFOLDED_MMA = {"fused_mlp": "dcc_trunk_fwd_mma",
                 "actor_ppo_grads_unfolded": "dcc_actor_grads_unfolded_mma",
                 "critic_ppo_grads_unfolded": "dcc_critic_grads_unfolded_mma"}
MMA_ENTRY = {
    "bf16": _FOLDED_MMA,
    "spread-bf16": _FOLDED_MMA,
    "recurrent-bf16": _TRUNK_MMA,
    "bf16-fused-loss-off": _TRUNK_MMA,
    "bf16-nmb4": _FOLDED_MMA,
    "bf16-unfolded-popart": {"fused_mlp": "dcc_trunk_fwd_mma",
                             "actor_ppo_grads_unfolded": "dcc_actor_grads_unfolded_mma",
                             "critic_ppo_grads_unfolded": "dcc_critic_grads_unfolded_mma"},
    "recurrent-bf16-nmb2": _TRUNK_MMA,
    **{f"bf16-{mode}": _TRUNK_MMA for mode in HEAD_MODES},
    **{f"preset-{name}-bf16": _FOLDED_MMA for name in BF16_PRESETS},
    f"preset-{WIDE}": {**_FOLDED_MMA, "critic_ppo_grads": "dcc_critic_grads_chunked_mma",
                       "critic_ppo_grads_dv0": "dcc_dv0_wgmma"},
    f"preset-{WIDE}-fused-loss-off": _WIDE_TRUNK_MMA,
    f"preset-{WIDE}-unfolded": {
        "fused_mlp": "dcc_trunk_fwd_mma",
        "actor_ppo_grads_unfolded": "dcc_actor_grads_unfolded_mma",
        "critic_ppo_grads_unfolded": "dcc_critic_grads_unfolded_chunked_mma",
        "layer0_input_bwd": "dcc_layer0_input_bwd_wgmma", "dv0_unfolded": "dcc_dv0_wgmma"},
    f"preset-{WIDE}-recurrent": _WIDE_TRUNK_MMA,
    f"{POIS}-bf16": {"fused_mlp": "dcc_trunk_fwd_mma",
                     "fused_mlp_chunked": "dcc_trunk_fwd_chunked_mma",
                     "actor_ppo_grads": "dcc_actor_grads_chunked_mma",
                     "critic_ppo_grads": "dcc_critic_grads_chunked_mma",
                     "actor_ppo_grads_dv0": "dcc_dv0_wgmma", "critic_ppo_grads_dv0": "dcc_dv0_wgmma"},
    f"{POIS}-bf16-unfolded": {
        "fused_mlp": "dcc_trunk_fwd_mma", "fused_mlp_chunked": "dcc_trunk_fwd_chunked_mma",
        "actor_ppo_grads_unfolded": "dcc_actor_grads_unfolded_chunked_mma",
        "critic_ppo_grads_unfolded": "dcc_critic_grads_unfolded_chunked_mma",
        "layer0_input_bwd": "dcc_layer0_input_bwd_wgmma", "dv0_unfolded": "dcc_dv0_wgmma"},
    f"{POIS}-bf16-fused-loss-off": {**_WIDE_TRUNK_MMA,
                                    "fused_mlp_chunked": "dcc_trunk_fwd_chunked_mma"},
    "bf16-h512": _FOLDED_MMA,
    "bf16-h512-unfolded": _UNFOLDED_MMA,
    "bf16-h512-fused-loss-off": _TRUNK_MMA,
    "bf16-h100-unfolded": _UNFOLDED_MMA,
    "bf16-h1024-fused-loss-off": _TRUNK_MMA,
    "recurrent-bf16-h300": _TRUNK_MMA,
    f"preset-{WIDE}-h512": {**_FOLDED_MMA, "critic_ppo_grads": "dcc_critic_grads_chunked_mma",
                            "critic_ppo_grads_dv0": "dcc_dv0_wgmma"},
    # the deep phase's runs; the f32 ones through the FMA entries
    **{f"bf16-L{L}": _FOLDED_MMA for L in DEEP_TIMED},
    **{f"bf16-L{L}-unfolded": _UNFOLDED_MMA for L in DEEP_TIMED},
    **{f"bf16-L{L}-fused-loss-off": _TRUNK_MMA for L in DEEP_TIMED},
    **{f"f32-L{L}-fused": {"fused_mlp": "dcc_trunk_fwd", "actor_ppo_grads": "dcc_actor_grads",
                           "critic_ppo_grads": "dcc_critic_grads"} for L in (8, 9)},
    "f32-L8-fused-unfolded": {"fused_mlp": "dcc_trunk_fwd",
                              "actor_ppo_grads_unfolded": "dcc_actor_grads_unfolded",
                              "critic_ppo_grads_unfolded": "dcc_critic_grads_unfolded"},
    **{f"f32-L{L}-fused-loss-off": {"fused_mlp": "dcc_trunk_fwd",
                                    "fused_mlp_bwd": "dcc_trunk_bwd"} for L in (8, 9)},
    f"preset-{WIDE}-L9": {**_FOLDED_MMA, "critic_ppo_grads": "dcc_critic_grads_chunked_mma",
                          "critic_ppo_grads_dv0": "dcc_dv0_wgmma"},
    # the column-blocked phase's runs (their launches count under *_blocked)
    f"bf16-h{BLOCKED_TIMED}": {"fused_mlp": "dcc_trunk_fwd_mma",
                               "actor_ppo_grads_blocked": "dcc_actor_grads_mma",
                               "critic_ppo_grads_blocked": "dcc_critic_grads_mma"},
    f"bf16-h{BLOCKED_TIMED}-unfolded": {
        "fused_mlp": "dcc_trunk_fwd_mma",
        "actor_ppo_grads_unfolded_blocked": "dcc_actor_grads_unfolded_mma",
        "critic_ppo_grads_unfolded_blocked": "dcc_critic_grads_unfolded_mma"},
    f"bf16-h{BLOCKED_TIMED}-fused-loss-off": {"fused_mlp": "dcc_trunk_fwd_mma",
                                              "fused_mlp_bwd_blocked": "dcc_trunk_bwd_mma"},
    "bf16-h4096": {"fused_mlp_blocked": "dcc_trunk_fwd_mma",
                   "actor_ppo_grads_blocked": "dcc_actor_grads_mma",
                   "critic_ppo_grads_blocked": "dcc_critic_grads_mma"},
    f"preset-{WIDE}-h{BLOCKED_TIMED}": {
        "fused_mlp": "dcc_trunk_fwd_mma", "fused_mlp_chunked": "dcc_trunk_fwd_chunked_mma",
        "actor_ppo_grads_blocked": "dcc_actor_grads_mma",
        "critic_ppo_grads_blocked": "dcc_critic_grads_chunked_mma",
        "critic_ppo_grads_dv0": "dcc_dv0_wgmma"},
    f"preset-{WIDE}-h4800-unfolded": {
        "fused_mlp_blocked": "dcc_trunk_fwd_mma",
        "actor_ppo_grads_unfolded_blocked": "dcc_actor_grads_unfolded_mma",
        "critic_ppo_grads_unfolded_blocked": "dcc_critic_grads_unfolded_chunked_mma",
        "layer0_input_bwd_blocked": "dcc_layer0_input_bwd_mma",
        "dv0_unfolded": "dcc_dv0_wgmma"},
}
# the tensor-core kernels and the libraries whose SASS holds them
MMA_KERNELS = ("trunk_fwd_mma_kernel", "trunk_bwd_mma_kernel", "actor_grads_mma_kernel",
               "critic_grads_mma_kernel", "actor_grads_unfolded_mma_kernel",
               "critic_grads_unfolded_mma_kernel", "critic_grads_chunked_mma_kernel",
               "dv0_wgmma_kernel", "trunk_bwd_chunked_mma_kernel",
               "critic_grads_unfolded_chunked_mma_kernel", "layer0_input_bwd_mma_kernel",
               "layer0_input_bwd_wgmma_kernel",
               "trunk_fwd_chunked_mma_kernel", "actor_grads_chunked_mma_kernel",
               "actor_grads_unfolded_chunked_mma_kernel")
MMA_LIBS = ("fused_mlp", "fused_mlp_bwd", "fused_ppo", "fused_mlp_wide", "fused_mlp_bwd_wide",
            "fused_ppo_wide", "fused_mlp_blocked", "fused_mlp_bwd_blocked", "fused_ppo_blocked",
            "layer0_tail")
WIDE_TAG = " [wide]"  # a kernel of a ``*_wide`` library (its layers in column passes)
BLOCKED_TAG = " [blocked]"  # a kernel of a ``*_blocked`` library (the column-blocked layout)


def lib_tag(lib: str) -> str:
    """The tag of a library's kernel names in the ptxas and SASS reports."""
    return WIDE_TAG if lib.endswith("_wide") else BLOCKED_TAG if lib.endswith("_blocked") else ""
# the runs followed by one profiled iteration
PROFILED = ("bf16", "maddpg", f"preset-{WIDE}-fused-loss-off", f"{POIS}-bf16")
# launches between the two CUDA events of a timing, fewer where they would
# take over TIMED_MS (down to 5, and to 3 for launches past 50 ms)
N_TIMED = 30
TIMED_MS = 25.0
# the value-flip rule's probes in flight at once (``probe_streams``), and
# their streams, made on first use
PROBE_STREAMS = 32
_PROBE_STREAMS: list = []
# the clock of the last row ``record`` kept: each row prints (and keeps as
# ``check_s``) the seconds since the one before, its check and timing
_ROW_CLOCK = [time.perf_counter()]


class SmokeFailure(Exception):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n: int = N_TIMED):
    """Device ms per call: CUDA events around ``n`` back-to-back calls after
    a warm-up call (fewer where they would take over ``TIMED_MS``: down to
    5, and to 3 past 50 ms a call). Returns (ms, calls timed)."""
    import torch

    def window(k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / k

    fn()
    torch.cuda.synchronize()
    one = window(1)
    n = max(3 if one > 50.0 else 5, min(n, int(TIMED_MS / one)))
    return window(n), n


def timed_for(timed, label: str) -> bool:
    """Whether a check of the trunk variant ``label`` is timed: ``timed``
    True or False, or the labels of the variants to time (the others'
    readings only)."""
    return timed if isinstance(timed, bool) else label in timed


def host_us(fn, n: int = N_TIMED) -> float:
    """Host microseconds per call: ``time.perf_counter`` around ``n`` calls
    with no synchronisation between them (the enqueue cost a caller pays)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def compare(name, got, want, max_rel, max_abs=None):
    """Per-tensor max |k - p| and ||k - p|| / ||p||; raises past the bounds,
    on a shape or on a non-finite value. Returns the worst of each and the
    index of the tensor with the worst rel."""
    worst_abs, worst_rel, worst_i = 0.0, 0.0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        if g.shape != w.shape or not bool(g.isfinite().all()):
            raise SmokeFailure(f"{name}[{i}]: shape {tuple(g.shape)} vs {tuple(w.shape)} "
                               f"or non-finite output")
        diff = (g - w).abs()
        a = float(diff.max()) if diff.numel() else 0.0
        r = float(diff.norm() / w.norm().clamp_min(1e-30)) if diff.numel() else 0.0
        worst_abs = max(worst_abs, a)
        if r > worst_rel:
            worst_rel, worst_i = r, i
        if r > max_rel or (max_abs is not None and a > max_abs):
            raise SmokeFailure(f"{name}[{i}]: max_abs {a:.3e} rel {r:.3e} exceeds "
                               f"rel {max_rel} / abs {max_abs}")
    return worst_abs, worst_rel, worst_i


def perturb_(net, gen) -> None:
    """Move every 1-D parameter (biases, LN affines, log_std) off its init
    value (zero biases, unit scales), in place."""
    import torch

    with torch.no_grad():
        for p in net.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen, device=p.device))


def condition_deep_(net, gen) -> None:
    """Redraw the trunk's Dense and LayerNorm biases from N(0, 1), in place:
    the depth checks' trunks (ROADMAP C8). Past a few layers the model's
    initial trunk carries one bf16 rounding difference, the kind two
    summation orders make, into the later layers' outputs and gradients
    (``scripts/depth_spread.py``); biases of the order of the products damp
    it."""
    import torch

    with torch.no_grad():
        for name, p in net.base.named_parameters():
            if name.endswith("bias") and not name.startswith("feature_norm"):
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device))


def f64_products():
    """A ``torch.overrides.TorchFunctionMode`` in which every product of two
    f32 tensors is accumulated in f64, then rounded to f32: the plain
    versions' products in another summation order, the same roundings
    (ROADMAP C8's ``order`` reading). Use it as a context manager."""
    import torch
    from torch.overrides import TorchFunctionMode

    class F64Products(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if (func in (torch.matmul, torch.Tensor.matmul) and len(args) == 2
                    and all(a.dtype == torch.float32 for a in args)):
                return func(args[0].double(), args[1].double(), **kwargs).float()
            return func(*args, **kwargs)

    return F64Products()


def max_rel(got, want) -> float:
    """The largest ||g - w|| / ||w|| over the tensors."""
    return max(float((g.float() - w.float()).norm() / w.float().norm().clamp_min(1e-30))
               for g, w in zip(got, want))


def bf16_limit(name, bound, layer_n: int, kern, plain, flat, want, relu: bool, mask_shape):
    """A bf16 check's limit on ||kernel - plain|| / ||plain||: ``bound`` at
    ``layer_n`` 1; past that the larger of ``bound`` and ``ORDER_FACTOR``
    times how far the plain version moves from ``want`` (its own outputs)
    with its products summed in another order (``f64_products``), on the
    kernel's relu masks where the trunk is relu: the spread that a chain
    this deep gives any two summation orders (ROADMAP C8). Prints both."""
    import torch

    if layer_n == 1:
        return bound
    masks = None
    if relu:
        masks = torch.zeros(mask_shape, dtype=torch.uint8, device="cuda")
        kern(relu_masks=masks)
    with f64_products():
        p64 = flat(plain(masks=masks) if relu else plain())
    spread = max_rel(p64, want)
    limit = max(bound, ORDER_FACTOR * spread)
    print(f"  {name}: the plain version against itself with f64 products reads "
          f"{spread:.3e}; limit {limit:.3e} (bound {bound})", flush=True)
    return limit


def bf16_step(v):
    """The spacing of bf16 numbers at |v| (8 significant bits)."""
    import torch

    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0**-40))) - 7)


def clip_kink_rows(feat, aux, hw, hb, log_std, clip=0.2):
    """(rows,) bool: actor rows whose plain ratio lies within what one bf16
    step of each head output moves it from a clip bound (1 +- clip), where
    a kernel and its plain version may take the other branch of the clipped
    surrogate and the row's whole cotangent with it (tests/test_torch_cuda.py's
    rule, which the deep checks give a zero advantage)."""
    import torch

    from dcc_tpu_torch.ops import fused_mlp as FM, fused_ppo as FP

    mean = FM.dense(feat.float(), hw, hb, True)
    inv_std = torch.exp(-log_std)
    A = hw.shape[1]
    z = (aux[:, :A] - mean) * inv_std
    lp = torch.sum(-0.5 * z * z - log_std - FP.LOG_SQRT_2PI, dim=1)
    log_ratio = lp - aux[:, A]
    slack = torch.sum(z.abs() * inv_std * bf16_step(mean), dim=1)
    return torch.stack([(log_ratio - math.log(1.0 + b)).abs() <= slack
                        for b in (-clip, clip)]).any(dim=0)


def probe_streams(calls, device) -> list:
    """Run each of ``calls`` (a kernel launch through its wrapper, returning
    a tensor it owns) on a stream of its own, ``PROBE_STREAMS`` at a time,
    each stream with its own depth / column-blocked scratch (the wrappers
    take ``ops.cuda_build.deep_scratch``'s one buffer a device, which
    launches in flight at once must not share); returns their results once
    the card is done with them. The probes of ``value_flip_rows`` each run
    one or a few row tiles, so that run one after another they leave the
    card all but idle for most of a check at hidden 4,096."""
    import torch

    from dcc_tpu_torch.ops import cuda_build as cb

    key, main = str(device), torch.cuda.current_stream(device)
    while len(_PROBE_STREAMS) < PROBE_STREAMS:
        _PROBE_STREAMS.append(torch.cuda.Stream(device))
    own = cb._SCRATCH.pop(key, None)
    scratch, out = {}, []
    try:
        for i in range(0, len(calls), PROBE_STREAMS):
            batch = []
            for s, call in zip(_PROBE_STREAMS, calls[i:i + PROBE_STREAMS]):
                s.wait_stream(main)
                cb._SCRATCH.pop(key, None)
                if s in scratch:
                    cb._SCRATCH[key] = scratch[s]
                with torch.cuda.stream(s):
                    batch.append(call())
                if key in cb._SCRATCH:
                    scratch[s] = cb._SCRATCH[key]
            torch.cuda.synchronize(device)
            out += batch
    finally:
        cb._SCRATCH.pop(key, None)
        if own is not None:
            cb._SCRATCH[key] = own
        del scratch
        torch.cuda.empty_cache()
    return out


def value_flip_rows(x, aux, params, hw, hb, n_layers, use_fn, use_relu, masks=None,
                    folded: bool = False) -> dict:
    """{row: (steps, feature gap)} of the rows with valid != 0 whose value
    in bf16 K4u (``folded``: K4, ``params`` its folded [V, u] list and
    ``hw``, ``hb`` its folded head) is not the plain version's
    (tests/test_torch_cuda.py's ``_value_flip_rows``): found by probing the
    kernel with the unclipped squared loss against the plain values,
    weighted so that a row's loss is its squared step count, and bisecting
    (the probes of one level of the bisection at once, ``probe_streams``);
    each must owe its value to features within bf16's epsilon (2^-7) of the
    plain version's in norm, read back from the kernel (dwv of a saturated
    one-sided Huber), else the phase fails. The deep checks give these rows
    valid = 0."""
    import torch

    from dcc_tpu_torch.ops import fused_mlp as FM, fused_ppo as FP

    if folded:
        feat = FP._fwd_folded(x, params, n_layers, use_fn, use_relu, True, masks)[0].float()
    else:
        feat = FM._forward_chain(x, params, n_layers, use_fn, use_relu, True, masks)[0].float()
    v = FM.dense(feat, hw, hb, True)[:, 0]
    kernel = FP.critic_grads_cuda if folded else FP.critic_grads_unfolded_cuda
    step = bf16_step(v)
    norm = torch.tensor([0.0, 1.0], device=x.device)

    # a probe launches the kernel on the probed rows alone: a row's value is
    # its own (each output's products run in one order whatever rows share
    # its tile), and a probe then costs what its rows do
    def launch(rows, ret, valid, huber_delta=None):
        a = torch.stack([v[rows], ret, valid], dim=1)
        return kernel(
            x[rows], a, norm, params, hw, hb, n_layers=n_layers, use_fn=use_fn,
            use_relu=use_relu, bf16=True, clip_param=0.2, huber_delta=huber_delta or 1.0,
            use_huber=huber_delta is not None, use_clipped=False)

    def steps2(rows):
        return launch(rows, v[rows], 2.0 / step[rows] ** 2)[-1][0].clone()

    def features(r):  # dwv = -features
        row = torch.tensor([r], device=x.device)
        return -launch(row, v[row] + 100.0, torch.ones_like(v[row]), huber_delta=1.0)[1][:, 0]

    found, level = {}, [torch.nonzero(aux[:, 2] != 0)[:, 0]]
    while level := [rows for rows in level if len(rows)]:
        s2 = probe_streams([lambda rows=rows: steps2(rows) for rows in level], x.device)
        below = []
        for rows, s in zip(level, s2):
            s = float(s)
            if s == 0.0:
                continue
            if len(rows) == 1:
                found[int(rows[0])] = s**0.5
            else:
                below += [rows[: len(rows) // 2], rows[len(rows) // 2:]]
        level = below
    rows = list(found)
    got = probe_streams([lambda r=r: features(r) for r in rows], x.device)
    for r, f_k in zip(rows, got):
        gap = float((f_k - feat[r]).norm() / feat[r].norm()) * 2**7
        if gap > 1.0:
            raise SmokeFailure(f"K4{'' if folded else 'u'} row {r}: its value is off by "
                               f"{found[r]:.1f} bf16 steps "
                               f"with features {gap:.2f} bf16 epsilons from the plain "
                               f"version's")
        found[r] = (found[r], gap)
    return found


def value_flips(name, x, aux, norm, params, wv, bv, kw, folded: bool = False) -> None:
    """The value-flip rule of a bf16 K4u check past two layers on a
    conditioned trunk (``condition_deep_``, whose values are large enough
    that one bf16 step moves a row's cotangent past the bound): the rows
    whose value the kernel rounds apart from the plain version's
    (``value_flip_rows``, on the kernel's relu masks where the trunk is
    relu) get valid = 0 in ``aux``, in place. More than 3 + rows / 20 of
    them, plus ``VALUE_FLIP_FACTOR`` times as many as the plain version
    rounds apart itself with its products summed in f64 (``f64_products``;
    a chain this deep moves values, ROADMAP C8), fail the check. ``folded``:
    K4's (``params`` its folded [V, u] list, ``wv``, ``bv`` its folded
    head)."""
    import torch

    from dcc_tpu_torch.ops import fused_mlp as FM, fused_ppo as FP

    L, H, rows = kw["n_layers"], wv.shape[0], x.shape[0]
    fn, relu = kw["use_fn"], kw["use_relu"]
    masks = None
    kernel = FP.critic_grads_cuda if folded else FP.critic_grads_unfolded_cuda
    chain = FP._fwd_folded if folded else FM._forward_chain
    if relu:
        masks = torch.zeros((L, rows, H), dtype=torch.uint8, device=x.device)
        kernel(x, aux, norm, params, wv, bv, relu_masks=masks, **kw)
    flips = value_flip_rows(x, aux, params, wv, bv, L, fn, relu, masks, folded)
    values = []
    for order in (contextlib.nullcontext(), f64_products()):
        with order:
            feat = chain(x, params, L, fn, relu, True, masks)[0].float()
            values.append(FM.dense(feat, wv, bv, True)[:, 0])
    own = int(((values[0] != values[1]) & (aux[:, 2] != 0)).sum())
    cap = 3 + rows // 20 + VALUE_FLIP_FACTOR * own
    worst = max((g for _, g in flips.values()), default=0.0)
    print(f"  {name}: {len(flips)} of {rows} rows' values round apart from the plain "
          f"version's (at most {cap}; the plain version with f64 products: {own}), at most "
          f"{max((s for s, _ in flips.values()), default=0.0):.1f} bf16 steps, features at "
          f"most {worst:.3f} bf16 epsilons apart; they get valid = 0", flush=True)
    if len(flips) > cap:
        raise SmokeFailure(f"{name}: {len(flips)} values round apart, more than {cap}")
    aux[list(flips), 2] = 0.0


def env_config(preset=None):
    """The EnvConfig of a named preset (``dcc_tpu_torch.configs.PRESETS``),
    of a many-PoI swarm (``MANY_POIS``), or the default one."""
    from dcc_tpu_torch.configs import load, load_preset
    from dcc_tpu_torch.envs import EnvConfig

    if preset in MANY_POIS:
        base, n_pois = MANY_POIS[preset]
        over = {"num_pois": n_pois}
        return (load(overrides=over) if base is None else load_preset(base, overrides=over))[1]
    return EnvConfig() if preset is None else load_preset(preset)[1]


def f32_reading(name, got, want, bf16_tol):
    """How far the kernel computed in f32 lies from the bf16 plain version;
    raises unless that is outside the bf16 bound."""
    worst = max(float((g.float() - w.float()).norm() / w.float().norm().clamp_min(1e-30))
                for g, w in zip(got, want))
    if worst <= bf16_tol:
        raise SmokeFailure(f"{name}: the f32 kernel is within the bf16 bound "
                           f"({worst:.3e} <= {bf16_tol}); the bound is too loose")
    return worst


def bound(bytes_moved: float, ops: float, peak_ops: float):
    """The least ms the card could take for a function that moves
    ``bytes_moved`` (its inputs read once, its outputs written once) and
    does ``ops`` operations at ``peak_ops``, and which of the two sets it."""
    tb, to = bytes_moved / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def scratch_ms(nbytes: float) -> float:
    """The ms a layout's own scratch traffic (the depth and column-blocked
    layouts' tiles in device memory, ``layout_bytes``) takes at the
    memory rate: the layout's overhead, reported beside the bound and not
    in it (the function does not need it)."""
    return nbytes / PEAK_BYTES * 1e3


def ptxas_report(logs: dict, show: bool) -> dict:
    """Registers and spills of every kernel from the ``-Xptxas -v`` reports,
    by mangled name (``WIDE_TAG`` appended for the ``*_wide`` libraries'
    kernels); prints the tensor-core kernels' and K1's (and the whole report
    with ``show``)."""
    info, fn = {}, None
    for name, text in sorted(logs.items()):
        if show:
            print(f"--- nvcc {name}.cu ---\n{text}")
        tag = lib_tag(name)
        for line in text.splitlines():
            m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)",
                          line)
            if m:
                fn = m.group(1) + tag
                info.setdefault(fn, {})
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and fn:
                info[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                info[fn]["registers"] = int(m.group(1))
    for fn, v in sorted(info.items()):
        if "mma_kernel" in fn or "gae" in fn:
            print(f"  ptxas {fn}: {v}", flush=True)
    return info


def sass_check(built: dict) -> dict:
    """HMMA / HGMMA instructions per kernel function of the K2, K2b and
    K3 / K4 libraries (``cuobjdump -sass``). Raises unless every bf16
    tensor-core kernel is there and holds some, and no other kernel does."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        raise SmokeFailure("cuobjdump not found: the SASS check needs the CUDA toolkit")
    counts = {}
    # every library's disassembly at once
    procs = {lib: subprocess.Popen([tool, "-sass", built[lib]], stdout=subprocess.PIPE,
                                   text=True) for lib in MMA_LIBS}
    for lib, proc in procs.items():
        out, _ = proc.communicate(timeout=300)
        if proc.returncode:
            raise SmokeFailure(f"cuobjdump -sass {built[lib]} failed ({proc.returncode})")
        fn = None
        for line in out.splitlines():
            if "Function :" in line:
                fn = re.search(r"Function : (\S+)", line).group(1) + lib_tag(lib)
                counts[fn] = 0
            elif fn is not None and "MMA" in line and re.search(r"\bH(G)?MMA\b", line):
                counts[fn] += 1
    mma = {f: c for f, c in counts.items() if "mma_kernel" in f}
    for want in MMA_KERNELS:
        if not any(want in f for f in mma):
            raise SmokeFailure(f"SASS check: no {want} in {sorted(counts)}")
    missing = sorted(f for f, c in mma.items() if c == 0)
    stray = sorted(f for f, c in counts.items() if c and f not in mma)
    if missing or stray:
        raise SmokeFailure(f"SASS check: tensor-core kernels without HMMA {missing}, "
                           f"other kernels with HMMA {stray}")
    print(f"  SASS: HMMA instructions per tensor-core kernel {mma}; none in the "
          f"{len(counts) - len(mma)} other kernels of {list(MMA_LIBS)}", flush=True)
    return counts


def device_us(fn, n: int, match: str):
    """Device microseconds per call over ``n`` back-to-back calls under
    torch.profiler: of the kernels whose name holds ``match`` (each such
    kernel's mean record times its records a call, at least one: late in
    the smoke the profiler returns records for fewer calls than ran, and
    the records' sum divided by the calls then read the hidden-512 dV0 and
    chunked K4 at half their time), of all device work (records / calls),
    and the kernel records a call (``launches``) with their names. None
    where the profiler sees no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
    by_name = collections.defaultdict(list)
    for e in dev:
        if match in e.name:
            by_name[e.name].append(e.time_range.elapsed_us())
    kernel = sum(sum(t) / len(t) * max(1, round(len(t) / n)) for t in by_name.values())
    return dict(kernel=kernel, all=sum(e.time_range.elapsed_us() for e in dev) / n,
                launches=sum(len(t) for t in by_name.values()) / n, names=sorted(by_name))


def record(results, kernel, mode, envs, shape, errs, kern, plain, bound_ms, bound_by,
           f32_rel=None, device_match=None, preset=None, library=None, hidden: int = 256,
           timed: bool = True, scratch_ms: float = 0.0, **extra_host):
    """Time the kernel's wrapper and the plain version, print and keep the
    row. ``device_match``: also the profiler's device us per call of the
    kernels whose name holds it. ``preset``: the env preset whose widths the
    check takes (None: the default config). ``library``: one
    PyTorch call that computes the same function, timed as the yardstick
    (``library_ms``; the port never calls it). ``hidden``: the trunk's
    width. ``timed`` False: the check's readings only, no timing (ms None).
    ``scratch_ms``: the layout's own scratch traffic at the memory rate
    (``scratch_ms()``), kept and printed beside the bound. ``extra_host``:
    further callables whose host us per call are printed beside the
    wrapper's."""
    from dcc_tpu_torch.ops.cuda_build import ENTRY, TILE

    err, rel, worst = errs
    if timed:
        (ms, n), (plain_ms, plain_n) = time_ms(kern), time_ms(plain)
        library_ms = time_ms(library)[0] if library is not None else None
        hosts = {"wrapper": host_us(kern, n),
                 **{k: host_us(f, n) for k, f in extra_host.items()}}
        dev_us = device_us(kern, n, device_match) if device_match else None
    else:
        ms = plain_ms = library_ms = dev_us = None
        n = plain_n = 0
        hosts = {}
        if mode == "bf16":  # the entry point and tile read below are this launch's
            kern()
    entry = ENTRY.get(kernel)  # the C entry point of the timed launches
    tile = TILE.get(kernel)  # and their row tile (K2-K4, K2b, K3u / K4u)
    if mode == "bf16" and not entry.endswith("mma"):
        raise SmokeFailure(f"bf16 {kernel} went through {entry}, not its tensor-core entry")
    row = dict(kernel=kernel, mode=mode, envs=envs, shape=shape, preset=preset, hidden=hidden,
               entry=entry, tile=tile, max_abs_err=err, rel_err=rel, worst_tensor=worst, ms=ms,
               n_timed=n,
               plain_ms=plain_ms, plain_n_timed=plain_n, host_us=hosts, device_us=dev_us,
               bound_ms=bound_ms, bound_by=bound_by, scratch_ms=scratch_ms,
               library_ms=library_ms, f32_kernel_rel_err=f32_rel)
    results.append(row)
    extra = "" if f32_rel is None else f" (f32 kernel: rel={f32_rel:.3e})"
    dev = "" if dev_us is None else (f" device us/call: kernel {dev_us['kernel']:.2f}, "
                                     f"all {dev_us['all']:.2f};")
    dev += "" if library_ms is None else f" library={library_ms:.4f} ms;"
    where = "" if preset is None else f" {preset}"
    shape = shape + ("" if tile is None else f" tile={tile}")
    times = (f" kernel={ms:.4f} ms (x{n}) plain={plain_ms:.4f} ms" if timed else " (not timed)")
    now = time.perf_counter()
    row["check_s"], _ROW_CLOCK[0] = now - _ROW_CLOCK[0], now
    print(f"  {kernel:17s} {mode:4s}{where} envs={envs:<6d} {shape:28s} [{entry}] "
          f"max_abs={err:.3e} rel={rel:.3e} [{worst}]{extra}{times} "
          f"bound={bound_ms:.6f} ms ({bound_by})"
          + (f" scratch={scratch_ms:.6f} ms" if scratch_ms else "") + f"{dev}"
          + (" host us/call: " + ", ".join(f"{k} {v:.1f}" for k, v in hosts.items())
             if hosts else "") + f" (+{row['check_s']:.1f} s)", flush=True)
    return row


def gae_inputs(T, envs, gen, plan=None):
    """(T, E, 1) rewards and (T + 1, E, 1) values and masks on the card, as
    ``compute_returns`` passes them. The masks hold random episode ends and,
    in every third column, zero runs across each segment boundary of
    ``plan`` (K1's ``gae_plan``), round boundaries included."""
    import torch

    r = torch.randn((T, envs, 1), generator=gen, device="cuda")
    v = torch.randn((T + 1, envs, 1), generator=gen, device="cuda")
    m = (torch.rand((T + 1, envs, 1), generator=gen, device="cuda") > 0.02).float()
    if plan is not None:
        _, S, L, _ = plan(T, envs)
        for start in segment_starts(T, S, L):
            m[max(start - 1, 1):start + 2, ::3] = 0.0
    return r, v, m


def segment_starts(T: int, S: int, L: int) -> list:
    """First steps of K1's segments inside (0, T): rounds of ``S * L`` steps
    from the end of time, ``S`` segments of ``L`` steps from each round's
    start (the earliest round's may be partly filled or empty)."""
    return sorted({max(t1 - S * L, 0) + s * L for t1 in range(T, 0, -S * L)
                   for s in range(S)} & set(range(1, T)))


def check_gae(results: list, shapes=GAE_SHAPES, entry=GAE_ENTRY):
    """K1 through ``compute_gae_cuda`` on (T, E, 1) tensors, as the main path
    calls it, against ``compute_gae`` at each shape: one launch a call, through
    ``entry`` (None: any). The shapes of ``GAE_TIMED`` are also timed: CUDA
    events, the profiler's device us, the wrapper's host us, the plain
    version."""
    import torch

    from dcc_tpu_torch.ops import LAUNCHES, cuda_gae, reset_launches
    from dcc_tpu_torch.ops.cuda_build import ENTRY
    from dcc_tpu_torch.ops.gae import compute_gae

    gen = torch.Generator(device="cuda").manual_seed(0)
    plan = getattr(cuda_gae, "gae_plan", None)  # a checkout before the segment kernel has none
    for T, envs in shapes:
        r, v, m = gae_inputs(T, envs, gen, plan)
        kern = lambda: cuda_gae.compute_gae_cuda(r, v, m, 0.99, 0.95)
        plain = lambda: compute_gae(r, v, m, 0.99, 0.95)
        reset_launches()
        ka, kr = kern()
        launched = dict(LAUNCHES), ENTRY.get("gae")
        if launched[0] != {"gae": 1} or entry not in (None, launched[1]):
            raise SmokeFailure(f"gae T={T} B={envs}: launches {launched[0]} through "
                               f"{launched[1]}, expected 1 through {entry}")
        pa, pr = plain()
        scale = float(pa.abs().max()) + 1.0
        # f32 with FMA contraction vs separate rounding, segment boundaries
        # re-associated: a few ulps of the running sum; bound 1e-5 of its
        # magnitude
        errs = compare(f"gae T={T} B={envs}", [ka, kr], [pa, pr], 1e-5, 1e-5 * scale)
        shape = f"T={T} B={envs}"
        if (T, envs) in GAE_TIMED:
            # rewards, values and masks rows 1..T read once, adv and ret written
            b, by = bound(4 * envs * (5 * T + 1), 8 * T * envs, PEAK_FP32)
            row = record(results, "gae", "f32", envs, shape, errs, kern, plain, b, by,
                         device_match="gae")
            if row["device_us"] is None or row["device_us"]["kernel"] <= 0:
                raise SmokeFailure(f"gae {shape}: the profiler saw no device time of the "
                                   f"kernel ({row['device_us']})")
        else:
            print(f"  gae               f32  envs={envs:<6d} {shape:28s} [{launched[1]}] "
                  f"max_abs={errs[0]:.3e} rel={errs[1]:.3e}", flush=True)


def k2_bound(x, params, packed, bf16: bool, hidden: int = 256, n_layers: int = 2):
    """K2's bound on the rows ``x`` (``n_layers`` layers of width
    ``hidden``): the bytes of x read once, the output written once and the
    parameters the kernel reads (bf16: the padded bf16 weight copies of
    ``packed`` and the f32 vectors; f32: every parameter), against 2 * rows
    * (d_in * H + (L - 1) * H * H) operations. A layout's own scratch
    traffic is not the function's, so not the bound's (``scratch_ms``)."""
    rows, width = x.shape
    ops = 2 * rows * (width * hidden + (n_layers - 1) * hidden * hidden)
    if bf16:
        weights = 2 * packed.weights.numel() + 4 * sum(p.numel() for p in params if p.dim() == 1)
    else:
        weights = 4 * sum(p.numel() for p in params)
    nbytes = x.numel() * x.element_size() + rows * hidden * (2 if bf16 else 4) + weights
    return bound(nbytes, ops, PEAK_BF16 if bf16 else PEAK_FP32)


def check_trunk_forward(results: list, gen, preset=None, envs_list=(16, BIG_ENVS),
                        update_steps: int = 0, hidden: int = 256, layer_n: int = 1,
                        timed: bool = True, blocked: bool = False, modes=(False, True)):
    """K2: the trunk forward on the actor (E*A, D) and critic (E, A*D) rows
    of the default config (D = 110) or of ``preset``, at each of
    ``envs_list`` envs, in f32 and bf16, on parameters packed beforehand as
    the rollout packs them (once per parameter version,
    MLPBase.packed_params). bf16 rows too wide for a staged tile take the
    chunked K2 (``fused_mlp_chunked``, with its profiler device time). With
    ``update_steps`` T: bf16 only, on the critic's T*E rows stored in bf16,
    as the update's forward with the fused loss off gives them. ``hidden``:
    the networks' hidden width; ``layer_n``: their ``layer_N`` (layer_n + 1
    layers; past two, the bf16 limit is ``bf16_limit``'s and their biases
    ``condition_deep_``); ``timed``: as
    ``record``'s (past two layers, of the bf16 rows only); ``blocked``: the
    bf16 kernel in its column-blocked layout, forced (rows named
    ``*_blocked``)."""
    import torch

    from dcc_tpu_torch.algos.mappo import MAPPO, MAPPOConfig
    from dcc_tpu_torch.ops import fused_mlp as FM, tiles

    dev = torch.device("cuda")
    env = env_config(preset)
    A, D = env.n_agents, env.obs_dim
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    for bf16 in ((True,) if update_steps else modes):
        algo = MAPPO(MAPPOConfig(compute_dtype="bfloat16" if bf16 else "float32",
                                 fused_loss="on", fused_trunk="on", hidden_size=hidden,
                                 layer_n=layer_n), env, device=dev)
        actor, critic = algo.make_networks(seed=1)
        for net in (actor, critic):
            perturb_(net, gen)
            if layer_n != 1:
                condition_deep_(net, gen)
        for envs in envs_list:
            nets = (((critic, update_steps * envs, A * D),) if update_steps
                    else ((actor, envs * A, D), (critic, envs, A * D)))
            for net, rows, width in nets:
                x = randn(rows, width)
                x = x.to(torch.bfloat16) if update_steps else x
                params = [p.detach() for p in net.base.flat_params()]
                L = layer_n + 1
                kw = dict(n_layers=L, use_fn=True, use_relu=True, bf16=bf16)
                packed = net.base.packed_params(dev)
                kern = lambda: FM.trunk_forward_cuda(x, params, packed=packed, **kw,
                                                     _blocked=blocked)
                plain = lambda: FM.trunk_forward_plain(x, params, **kw)

                def rollout_call(net=net, x=x):  # the rollout's path to K2
                    with torch.no_grad():
                        return net.base(x)

                # f32: summation order only; bf16: 1-ulp flips of bf16
                # roundings inside the chain (LN outputs reach |16|, ulp 1/8)
                tol = (K2_BF16_REL, 0.25) if bf16 else (1e-4, 1e-3)
                chunked = bf16 and tiles.plan("fused_mlp", True, width, hidden, L,
                                              blocked=blocked)[0]
                name = ("fused_mlp_chunked" if chunked else "fused_mlp") + (
                    "_blocked" if blocked and bf16 else "")
                want = plain()
                if bf16:
                    tol = (bf16_limit(f"{name} rows={rows} L={L}", tol[0], layer_n,
                                      lambda **m: FM.trunk_forward_cuda(x, params, packed=packed,
                                                                        **kw, **m,
                                                                        _blocked=blocked),
                                      lambda masks=None: FM.trunk_forward_plain(
                                          x, params, **kw, masks=masks),
                                      lambda o: [o], [want], True, (L, rows, hidden)), tol[1])
                errs = compare(name, [kern()], [want], *tol)
                f32_rel = None
                if bf16:
                    f32_out = FM.trunk_forward_cuda(x, params, **{**kw, "bf16": False})
                    f32_rel = f32_reading(name, [f32_out], [want], tol[0])
                b, by = k2_bound(x, params, packed, bf16, hidden, L)
                scratch = blocked_bytes(name, rows, hidden, L) if blocked and bf16 else 0
                shape = (f"rows={rows} d_in={width}" + (" update" if update_steps else "")
                         + _hidden_label(hidden) + _layers_label(L))
                hosts = {} if update_steps else {"MLPBase.forward": rollout_call}
                record(results, name, "bf16" if bf16 else "f32", envs, shape, errs, kern, plain,
                       b, by, f32_rel, preset=preset, scratch_ms=scratch_ms(scratch),
                       device_match=("trunk_fwd_chunked" if chunked else "mma_kernel" if
                                     blocked and bf16 else deep_match(bf16, layer_n)),
                       hidden=hidden, timed=timed and (bf16 or layer_n == 1), **hosts)


def check_k2_layouts(results: list, gen):
    """The staged and the chunked K2 on the same rows, each against the
    plain version at K2's bf16 bounds and timed back to back: whether one
    layout could serve the widths of both. The rows: the 20-UAV preset's
    4,840-wide critic rows of a rollout step at ``WIDE_ENVS`` envs (f32) and
    of the fused-loss-off update's forward (150 x ``WIDE_ENVS``, stored in
    bf16), and the default config's rollout rows at ``BIG_ENVS`` envs (the
    actor's 110 wide, the critic's 440). The chunked layout is forced by
    handing the wrapper ``tiles.plan``'s chunked answer."""
    import torch

    from dcc_tpu_torch.ops import fused_mlp as FM, tiles

    kw = dict(n_layers=2, use_fn=True, use_relu=True, bf16=True)
    plan = tiles.plan

    def chunked_plan(kernel, bf16, *args, **kw):
        if kernel == "fused_mlp":
            return tiles.Plan(True, list(tiles.CHUNKED[(kernel, bf16)]))
        return plan(kernel, bf16, *args, **kw)

    for preset, actor, envs, steps, dtype in (
            (WIDE, False, WIDE_ENVS, 1, torch.float32),
            (WIDE, False, WIDE_ENVS, 150, torch.bfloat16),
            (None, True, BIG_ENVS, 1, torch.float32),
            (None, False, BIG_ENVS, 1, torch.float32)):
        net, params = _wide_net(gen, seed=1, preset=preset, actor=actor)
        packed = net.base.packed_params(torch.device("cuda"))
        env = env_config(preset)
        rows = steps * envs * (env.n_agents if actor else 1)
        width = env.obs_dim if actor else env.share_obs_dim
        x = torch.randn((rows, width), generator=gen, device="cuda").to(dtype)
        plain = lambda: FM.trunk_forward_plain(x, params, **kw)
        staged = lambda: FM.trunk_forward_cuda(x, params, packed=packed, **kw)

        def chunked():
            tiles.plan = chunked_plan
            try:
                return FM.trunk_forward_cuda(x, params, packed=packed, **kw)
            finally:
                tiles.plan = plan

        want = plain()
        b, by = k2_bound(x, params, packed, True)
        for name, fn, match in (("fused_mlp", staged, "trunk_fwd_mma"),
                                ("fused_mlp_chunked", chunked, "trunk_fwd_chunked")):
            errs = compare(name, [fn()], [want], K2_BF16_REL, 0.25)
            record(results, name, "bf16", envs, f"rows={rows} d_in={width} layouts", errs, fn,
                   plain, b, by, preset=preset, device_match=match)


def _shape(rows: int, d_in: int, nmb: int = 1, hidden: int = 256) -> str:
    """A kernel check's shape label; ``nmb``: the rows are one of that many
    minibatches; ``hidden``: the trunk's width, where it is not 256."""
    return f"rows={rows} d_in={d_in}" + (f" nmb={nmb}" if nmb > 1 else "") + _hidden_label(hidden)


def _hidden_label(hidden: int) -> str:
    return "" if hidden == 256 else f" H={hidden}"


def deep_match(bf16: bool, layer_n: int):
    """The profiler's kernel names a timed row of the deep phase reads its
    device us from (its tensor-core kernel's, ``*_mma_kernel``), else
    None."""
    return "mma_kernel" if bf16 and layer_n != 1 else None


def _layers_label(n_layers: int) -> str:
    """A check's shape label of a trunk of other than the default's two
    layers."""
    return "" if n_layers == 2 else f" L={n_layers}"


def deep_bytes(kernel: str, rows: int, width: int, hidden: int, n_layers: int,
               n_head: int = 1) -> int:
    """The device-memory traffic of the bf16 ``kernel``'s depth layout on
    ``rows`` rows (0 where ``ops.tiles.plan`` gives it another layout): each
    layer's saved bf16 tile (pad16(H) + 8 columns) written once in the
    forward, read once when the backward stages it and once more to
    recompute the next layer's operand, beside its rows' LN statistics
    written and read once."""
    from dcc_tpu_torch.ops import tiles

    # (a checkout from before the depth layout plans no ``deep``)
    if not getattr(tiles.plan(kernel, True, width, hidden, n_layers, n_head), "deep", False):
        return 0
    hp = -(-hidden // 16) * 16
    return 3 * 2 * n_layers * rows * (hp + 8) + 2 * 8 * n_layers * rows


def blocked_bytes(kernel: str, rows: int, hidden: int, n_layers: int) -> int:
    """The device-memory traffic of the bf16 ``kernel``'s column-blocked
    layout on ``rows`` rows, each tile as wide as the hidden layer (pad16(H)
    + 8 columns) counted once where it is written and once where it is read:
    K2 a layer's activations and its output (the next layer's input); the
    gradient kernels those two in the forward, then in the backward the
    activations read, the operand recomputed (written, read), the bf16
    cotangent (written, read) and the f32 g_prev stage (written, read); the
    layer-0 input backward keeps none."""
    if kernel.startswith("layer0_input_bwd"):
        return 0
    hp = -(-hidden // 16) * 16 + 8
    per_layer = 8 if kernel.startswith("fused_mlp") and "bwd" not in kernel else 26
    return per_layer * n_layers * rows * hp


def layout_bytes(kernel: str, rows: int, width: int, hidden: int, n_layers: int,
                 n_head: int = 1, blocked: bool = False) -> int:
    """A bf16 check's scratch traffic: ``blocked_bytes`` in the column-blocked
    layout, else ``deep_bytes``."""
    if blocked:
        return blocked_bytes(kernel, rows, hidden, n_layers)
    return deep_bytes(kernel, rows, width, hidden, n_layers, n_head)


def trunk_variants(bf16: bool, preset, hidden: int = 256) -> list:
    """The trunks a gradient kernel's check runs, as (label, relu, n_layers,
    use_fn). The default config's checks and every f32 check run the
    model's trunk (relu, 2 layers, feature norm). In bf16 at a preset's
    widths or a hidden width other than 256, three, each a row of its own:

    - the model's trunk, under the relu mask rule (``masked_relu``, ROADMAP
      C3): the kernel's relu masks may differ from the plain version's only
      within what a one-bf16-step change of the layer's input can move, and
      the plain version runs on the kernel's masks;
    - " tanh": the model's trunk with tanh, no kink;
    - " relu L=1": one relu layer on the rows themselves (no feature norm):
      the relu path at the preset's width (row staging and padding, the
      products over d_in, the d_in x H gradient) with no LN before the kink."""
    if not bf16 or (preset is None and hidden == 256):
        return [("", True, 2, True)]
    return [("", True, 2, True), (" tanh", False, 2, True), (" relu L=1", True, 1, False)]


def masked_relu(name, kern, plain, gap, n_layers: int, rows: int, hidden: int):
    """A bf16 relu trunk's check under the relu mask rule (ROADMAP C3): the
    kernel writes its relu masks (``relu_masks``); every mask that differs
    from the plain version's must lie within what a one-bf16-step change of
    every element of the layer's input can move the pre-activation
    (``gap(masks)``: ``ops.fused_mlp.relu_mask_gap`` or the folded chain's,
    ratio at most 1); the plain version then runs on the kernel's masks, so
    that the comparison holds the rest of the arithmetic. Returns (kernel
    outputs, plain outputs, (masks that differ, worst ratio))."""
    import torch

    masks = torch.zeros((n_layers, rows, hidden), dtype=torch.uint8, device="cuda")
    k = kern(relu_masks=masks)
    n, worst = gap(masks)
    print(f"  {name}: {n} of {masks.numel()} relu masks differ from the plain version's, "
          f"at most {worst:.3f} of the rule's bound", flush=True)
    if worst > 1.0:
        raise SmokeFailure(f"{name}: a relu mask differs from the plain version's at "
                           f"{worst:.3f} of the one-bf16-step bound")
    p = plain(masks=masks)
    del masks
    return k, p, (n, worst)


def check_kernels(results: list, ptxas: dict):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    check_gae(results)  # K1
    check_trunk_forward(results, gen)  # K2
    # K2b on the recurrent update's rows, T*E*A for both networks, on one of
    # the chunk minibatches of the recurrent run with 2 minibatches (T*E*A/2
    # rows), and on the actor's rows at a quarter of the headline envs (the
    # plain version keeps about ten (rows, 256) f32 tensors alive)
    check_trunk_backward(results, gen, cases=((16, 1, "both"), (16, 2, "both"),
                                              (BIG_ENVS // 64, 1, "actor")))
    # K3 / K4 on the T*E*A actor / T*E critic rows, and on one minibatch of
    # the run with 4 minibatches: T*E*A/4 actor rows and as many critic
    # rows, gathered from the env rows duplicated per agent, with the
    # returns normalised outside (norm = [0, 1])
    ppo_envs = BIG_ENVS // 64
    print(f"  K3 / K4 at {ppo_envs} envs (a sixty-fourth of {BIG_ENVS}): their plain versions "
          f"keep about ten (rows, 256) f32 tensors alive, which must fit in device memory",
          flush=True)
    check_ppo(results, gen, cases=((16, 1), (16, 4), (ppo_envs, 1)))
    check_unfolded(results, gen, envs_list=(16, BIG_ENVS // 64))  # K3u, K4u
    check_presets(results)
    check_wide(results)
    check_many_pois(results, ptxas)
    check_wide_hidden(results, ptxas)


def check_trunk_backward(results: list, gen, cases, preset=None, hidden: int = 256,
                         variants=None, layer_n: int = 1, timed: bool = True,
                         blocked: bool = False, modes=(False, True), control: bool = True):
    """K2b, the trunk backward, on T*E*A/nmb rows of the actor (D wide) and,
    where a case says "both", of the critic (A*D wide, its env rows
    duplicated per agent), for each (envs, nmb, which) of ``cases``, in f32
    and bf16, of the default config or ``preset``, at the hidden width
    ``hidden``, on the trunks of ``trunk_variants`` (or ``variants``), of
    networks with ``layer_n`` + 1 layers (past two, their biases
    ``condition_deep_``); ``timed`` and ``blocked`` as
    ``check_trunk_forward``'s (``timed`` may also name the variants to
    time, ``timed_for``); ``control`` False: the bf16 checks without the
    kernel computed in f32 (the column-blocked phase's timed rows at the
    main path's shapes, whose f32 FMA kernels take most of that phase's
    time; each kernel's control is read at 16 envs at every width). The
    bf16 row keeps the depth or column-blocked layout's own traffic
    apart from the bound (``layout_bytes``, ``scratch_ms``)."""
    import torch

    from dcc_tpu_torch.algos.mappo import MAPPO, MAPPOConfig
    from dcc_tpu_torch.ops import fused_mlp as FM

    dev = torch.device("cuda")
    env = env_config(preset)
    T, A, D = 150, env.n_agents, env.obs_dim
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    for bf16 in modes:
        algo = MAPPO(MAPPOConfig(compute_dtype="bfloat16" if bf16 else "float32",
                                 use_recurrent_policy=True, fused_trunk="on",
                                 hidden_size=hidden, layer_n=layer_n), env, device=dev)
        actor, critic = algo.make_networks(seed=4)
        for net in (actor, critic):
            perturb_(net, gen)
            if layer_n != 1:
                condition_deep_(net, gen)
        xdt = torch.bfloat16 if bf16 else torch.float32
        both = ((actor, D), (critic, A * D))
        for envs, nmb, which in cases:
            for net, width in both if which == "both" else both[:1]:
                rows = T * envs * A // nmb
                x = randn(rows, width).to(xdt)
                full = [p.detach() for p in net.base.flat_params()]
                for label, relu, L, fn in variants or trunk_variants(bf16, preset, hidden):
                    params = full if fn else full[2:2 + 4 * L]
                    kw = dict(n_layers=L, use_fn=fn, use_relu=relu, bf16=bf16)
                    # f32: rows within 1e-5 of a relu kink may take either side
                    # in the kernel and in the plain version: they get a zero
                    # cotangent; bf16: the relu mask rule
                    g = randn(rows, hidden)
                    if relu and not bf16:
                        kink = FM.relu_kink_rows(x, params, L, fn, False)
                        g[kink] = 0.0
                        print(f"  K2b f32, {rows} x {width}{label}: {int(kink.sum())} rows next "
                              f"to a relu kink get a zero cotangent", flush=True)
                    g = g.to(xdt)  # the cotangent of the trunk output, in its dtype
                    kern = lambda **m: FM.trunk_backward_cuda(x, params, g, **kw, **m,
                                                              _blocked=blocked)
                    plain = lambda **m: FM.trunk_backward_plain(x, params, g, **kw, **m)
                    if relu and bf16:
                        k, p, _ = masked_relu(
                            f"K2b {rows} x {width}{label}{_hidden_label(hidden)}", kern, plain,
                            lambda m: FM.relu_mask_gap(x, params, L, fn, m), L, rows, hidden)
                    else:
                        k, p = kern(), plain()
                    k, p = [k[0], *k[1]], [p[0], *p[1]]
                    tol = 1e-4
                    if bf16:
                        tol = bf16_limit(f"K2b {rows} x {width}{label}", K2B_BF16_REL, layer_n,
                                         kern, plain, lambda o: [o[0], *o[1]], p, relu,
                                         (L, rows, hidden))
                    errs = compare("fused_mlp_bwd", k, p, tol)
                    f32_rel = None
                    if bf16 and control:
                        k32 = FM.trunk_backward_cuda(x, params, g, **{**kw, "bf16": False})
                        f32_rel = f32_reading("fused_mlp_bwd", [k32[0], *k32[1]], p, tol)
                        del k32
                    # forward recompute, dW and d(input): 3 products of 2 ops a MAC
                    ops = 6 * rows * sum(t.numel() for t in params if t.dim() == 2)
                    # x and g in, dx out; parameters in, their f32 gradients out
                    nbytes = (2 * x.numel() * x.element_size() + g.numel() * g.element_size()
                              + 2 * 4 * sum(t.numel() for t in params))
                    scratch = (layout_bytes("fused_mlp_bwd", rows, width, hidden, L,
                                            blocked=blocked) if bf16 else 0)
                    b, by = bound(nbytes, ops, PEAK_BF16 if bf16 else PEAK_FP32)
                    record(results, "fused_mlp_bwd" + ("_blocked" if blocked and bf16 else ""),
                           "bf16" if bf16 else "f32", envs,
                           _shape(rows, width, nmb, hidden) + label, errs, kern, plain, b, by,
                           f32_rel, preset=preset, hidden=hidden, scratch_ms=scratch_ms(scratch),
                           device_match=("mma_kernel" if blocked and bf16
                                         else deep_match(bf16, layer_n)),
                           timed=timed_for(timed, label) and (bf16 or layer_n == 1))
                    del k, p, g
                del x
                torch.cuda.empty_cache()


def check_ppo(results: list, gen, cases, preset=None, modes=(False, True), hidden: int = 256,
              variants=None, kinds=("actor", "critic"), layer_n: int = 1, timed: bool = True,
              blocked: bool = False, control: bool = True):
    """K3 / K4, the folded PPO loss + gradient kernels, on T*E*A/nmb actor
    rows and T*E critic rows (nmb = 1) or as many critic rows as actor rows,
    gathered from the env rows duplicated per agent (nmb > 1), for each
    (envs, nmb) of ``cases``, in the ``modes`` (bf16 True), of the default
    config or ``preset``, on the trunks of ``trunk_variants``. K4 at rows too
    wide for a staged tile launches its chunked kernel and the dV0 kernel
    (``ops.tiles.plan``); its time is both launches'. ``hidden``: the
    networks' hidden width; ``variants``: the trunks, by default
    ``trunk_variants``'; ``kinds``: the networks checked; ``layer_n``: the
    networks' ``layer_N`` (a trunk past two layers counts as another width
    for the f32 kink rule below; past two layers, their biases
    ``condition_deep_``, and in bf16 the actor's rows at the clip's kink a
    zero advantage, ``clip_kink_rows``); ``timed``, ``blocked`` and
    ``control`` as ``check_trunk_backward``'s. A bf16 row keeps the depth or
    column-blocked layout's own traffic apart from the bound
    (``layout_bytes``, ``scratch_ms``).

    At a preset's widths and hidden widths other than 256 the f32 checks give
    rows with a relu pre-activation within 1e-5 of the kink a zero advantage
    / valid = 0; the bf16 checks of relu trunks run under the relu mask rule
    (``masked_relu``). The column-blocked checks at 16 envs give K4's rows
    whose value the kernel rounds apart valid = 0 (``value_flips``, folded),
    as ``check_unfolded`` does K4u's."""
    import torch

    from dcc_tpu_torch.algos.mappo import MAPPO, MAPPOConfig
    from dcc_tpu_torch.ops import fused_ppo as FP

    dev = torch.device("cuda")
    env = env_config(preset)
    T, A, D, H = 150, env.n_agents, env.obs_dim, hidden
    wide = preset == WIDE or preset in MANY_POIS
    kinky = preset is not None or H != 256 or layer_n != 1  # the f32 kink rule applies
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    flat = lambda o: [*o[0], *o[1:]]  # K3 / K4 outputs as one list of tensors
    n_bytes = lambda o: 4 * sum(t.numel() for t in flat(o))  # f32 gradients
    for bf16 in modes:
        algo = MAPPO(MAPPOConfig(compute_dtype="bfloat16" if bf16 else "float32",
                                 fused_loss="on", fused_trunk="on", hidden_size=hidden,
                                 layer_n=layer_n), env, device=dev)
        actor, critic = algo.make_networks(seed=2)
        for net in (actor, critic):
            perturb_(net, gen)
            if layer_n != 1:
                condition_deep_(net, gen)
        xdt = torch.bfloat16 if bf16 else torch.float32
        mode = "bf16" if bf16 else "f32"
        # f32: summation order of the R-row sums, and the odd row within
        # rounding of a loss kink (clip bound, min / max tie) that takes the
        # other branch; bf16: 1-ulp flips of the bf16 roundings in the
        # forward and of the rounded cotangents
        tol = PPO_BF16_REL if bf16 else 1e-3
        actor_p = [p.detach() for p in actor.base.flat_params()]
        critic_p = [p.detach() for p in critic.base.flat_params()]
        for envs, nmb in cases:
            R = T * envs * A // nmb
            Rv = T * envs if nmb == 1 else R
            obs = randn(R, D).to(xdt)
            act = randn(R, 2) * 0.5
            old_lp = -2.0 + 0.3 * randn(R, 1)
            adv0 = randn(R, 1)
            if nmb == 1:
                cent = obs.reshape(Rv, A * D)
                norm = torch.tensor([0.5, 2.0], device=dev)
            else:
                pick = torch.randperm(T * envs * A, generator=gen, device=dev)[:Rv]
                cent = randn(T * envs, A * D).to(xdt).repeat_interleave(A, 0)[pick]
                norm = torch.tensor([0.0, 1.0], device=dev)
            with torch.no_grad():
                v0 = critic(cent[: min(Rv, 65536)].float())
            vpred = randn(Rv, 1) * float(v0.std() + 0.1)
            ret = vpred + 3.0 * randn(Rv, 1)
            for label, relu, L, fn in variants or trunk_variants(bf16, preset, H):
                if "actor" in kinds:
                    trunk = actor_p if fn else actor_p[2:2 + 4 * L]
                    kp, whf, bhf = FP.fold_trunk(trunk, actor.act_out.weight.detach().t(),
                                                 actor.act_out.bias.detach(), L, fn)
                    adv = adv0.clone()
                    if relu and not bf16 and kinky:
                        # f32 at a preset's widths or another hidden width: rows
                        # within 1e-5 of a relu kink may take either side in the
                        # two summation orders: they get a zero advantage (bf16:
                        # the relu mask rule)
                        kink = FP.relu_kink_rows_folded(obs, kp, L, fn, bf16=False)
                        adv[kink] = 0.0
                        print(f"  actor {mode}, {envs} envs, {_shape(R, D, nmb, H)}{label}: "
                              f"{int(kink.sum())} rows next to a relu kink get a zero advantage",
                              flush=True)
                    ls = actor.log_std.detach()
                    if bf16 and layer_n != 1:  # the clip's kink
                        feat = FP._fwd_folded(obs, kp, L, fn, relu, True)[0]
                        adv[clip_kink_rows(feat, FP.pack_actor_aux(act, old_lp, adv), whf, bhf,
                                           ls)] = 0.0
                    aux_a = FP.pack_actor_aux(act, old_lp, adv)
                    kw = dict(n_layers=L, use_fn=fn, use_relu=relu, bf16=bf16, clip_param=0.2)
                    kern = lambda **m: FP.actor_grads_cuda(obs, aux_a, kp, whf, bhf, ls, **kw, **m,
                                                           _blocked=blocked)
                    plain = lambda **m: FP.actor_grads_plain(obs, aux_a, kp, whf, bhf, ls, **kw,
                                                             **m)
                    if relu and bf16:
                        k, p, _ = masked_relu(
                            f"K3 {envs} envs, {_shape(R, D, nmb, H)}{label}", kern, plain,
                            lambda m: FP.relu_mask_gap_folded(obs, kp, L, fn, m), L, R, H)
                    else:
                        k, p = kern(), plain()
                    limit = tol
                    if bf16:
                        limit = bf16_limit(f"K3 {_shape(R, D, nmb, H)}{label}", tol, layer_n,
                                           kern, plain, flat, flat(p), relu, (L, R, H))
                    errs = compare("actor_ppo_grads", flat(k), flat(p), limit)
                    f32_rel = None
                    if bf16 and control:
                        f32_k = FP.actor_grads_cuda(obs, aux_a, kp, whf, bhf, ls,
                                                    **{**kw, "bf16": False})
                        f32_rel = f32_reading("actor_ppo_grads", flat(f32_k), flat(p), limit)
                        del f32_k
                    # forward, dW and (past layer 0) g_prev: 2 ops a MAC
                    ops = 2 * R * (2 * D * H + 3 * (L - 1) * H * H)
                    # rows and aux in, folded params in, their gradients out
                    nbytes = R * D * (2 if bf16 else 4) + aux_a.numel() * 4 + 2 * n_bytes(k)
                    scratch = layout_bytes("actor_ppo_grads", R, D, H, L, 2, blocked) if bf16 else 0
                    b, by = bound(nbytes, ops, PEAK_BF16 if bf16 else PEAK_FP32)
                    record(results, "actor_ppo_grads" + ("_blocked" if blocked and bf16 else ""),
                           mode, envs, _shape(R, D, nmb, H) + label,
                           errs, kern, plain, b, by, f32_rel, preset=preset,
                           scratch_ms=scratch_ms(scratch),
                           device_match=("mma_kernel" if bf16 and (wide or blocked)
                                         else deep_match(bf16, layer_n)), hidden=H,
                           timed=timed_for(timed, label) and (bf16 or layer_n == 1))
                    del k, p

                if "critic" not in kinds:
                    continue
                trunk = critic_p if fn else critic_p[2:2 + 4 * L]
                kpc, wvf, bvf = FP.fold_trunk(trunk, critic.v_out.weight.detach().t(),
                                              critic.v_out.bias.detach(), L, fn)
                aux_c = FP.pack_critic_aux(vpred, ret)
                if relu and not bf16 and kinky:  # as the actor's: valid = 0
                    kink = FP.relu_kink_rows_folded(cent, kpc, L, fn, bf16=False)
                    aux_c[kink, 2] = 0.0
                    print(f"  critic {mode}, {envs} envs, {_shape(Rv, A * D, nmb, H)}{label}: "
                          f"{int(kink.sum())} rows next to a relu kink get valid = 0",
                          flush=True)
                ckw = dict(n_layers=L, use_fn=fn, use_relu=relu, bf16=bf16, clip_param=0.2,
                           huber_delta=10.0, use_huber=True, use_clipped=True)
                if bf16 and blocked and envs == 16:  # as K4u's (check_unfolded)
                    value_flips(f"K4 {envs} envs{label}", cent, aux_c, norm, kpc, wvf, bvf, ckw,
                                folded=True)
                kern = lambda **m: FP.critic_grads_cuda(cent, aux_c, norm, kpc, wvf, bvf, **ckw,
                                                        **m, _blocked=blocked)
                plain = lambda **m: FP.critic_grads_plain(cent, aux_c, norm, kpc, wvf, bvf,
                                                          **ckw, **m)
                if relu and bf16:
                    k, p, _ = masked_relu(
                        f"K4 {envs} envs, {_shape(Rv, A * D, nmb, H)}{label}", kern, plain,
                        lambda m: FP.relu_mask_gap_folded(cent, kpc, L, fn, m), L, Rv, H)
                else:
                    k, p = kern(), plain()
                limit = tol
                if bf16:
                    limit = bf16_limit(f"K4 {_shape(Rv, A * D, nmb, H)}{label}", tol, layer_n,
                                       kern, plain, flat, flat(p), relu, (L, Rv, H))
                errs = compare("critic_ppo_grads", flat(k), flat(p), limit)
                f32_rel = None
                if bf16 and control:
                    f32_k = FP.critic_grads_cuda(cent, aux_c, norm, kpc, wvf, bvf,
                                                 **{**ckw, "bf16": False})
                    f32_rel = f32_reading("critic_ppo_grads", flat(f32_k), flat(p), limit)
                    del f32_k
                ops = 2 * Rv * (2 * A * D * H + 3 * (L - 1) * H * H)
                nbytes = Rv * A * D * (2 if bf16 else 4) + aux_c.numel() * 4 + 2 * n_bytes(k)
                scratch = (layout_bytes("critic_ppo_grads", Rv, A * D, H, L, 1, blocked)
                           if bf16 else 0)
                b, by = bound(nbytes, ops, PEAK_BF16 if bf16 else PEAK_FP32)
                # at the 20-UAV and many-PoI widths in bf16, the device time
                # of the chunked kernel and the dV0 kernel (their
                # *_mma_kernel names)
                record(results, "critic_ppo_grads" + ("_blocked" if blocked and bf16 else ""),
                       mode, envs,
                       _shape(Rv, A * D, nmb, H) + label, errs, kern, plain, b, by, f32_rel,
                       preset=preset, scratch_ms=scratch_ms(scratch),
                       device_match=("mma_kernel" if bf16 and (wide or blocked)
                                     else deep_match(bf16, layer_n)), hidden=H,
                       timed=timed_for(timed, label) and (bf16 or layer_n == 1))
                del k, p
            del obs, cent
            torch.cuda.empty_cache()


def check_unfolded(results: list, gen, preset=None, envs_list=(16, BIG_ENVS // 4),
                   modes=(False, True), hidden: int = 256, variants=None, layer_n: int = 1,
                   timed: bool = True, blocked: bool = False, control: bool = True):
    """K3u / K4u, the unfolded actor and critic PPO-gradient kernels, on the
    T*E*A actor / T*E critic rows at each of ``envs_list`` envs, in the
    ``modes`` (bf16 True), of the default config or ``preset``, at the hidden
    width ``hidden``, on the trunks of ``trunk_variants``. In bf16 relu trunks
    run under the relu mask rule (``masked_relu``); at a preset's widths and
    hidden widths other than 256 (and past two layers, ``layer_n``) the f32
    checks give rows within 1e-5 of a kink a zero advantage / valid = 0.
    Past two layers (``layer_n``) the networks' biases ``condition_deep_``
    and in bf16 the actor's rows at the clip's kink get a zero advantage
    (``clip_kink_rows``) and the critic's rows whose value the kernel
    rounds apart valid = 0 (``value_flips``, also in the column-blocked
    checks at 16 envs: past hidden 1,024 a value's bf16 step moves its
    row's cotangent past the bound too, as tests/test_torch_cuda.py's K4u
    checks hold at every width). ``timed``, ``blocked`` and ``control`` as
    ``check_trunk_backward``'s; a bf16 row keeps the depth or
    column-blocked layout's own traffic apart from the bound
    (``layout_bytes``, ``scratch_ms``)."""
    import torch

    from dcc_tpu_torch.algos.mappo import MAPPO, MAPPOConfig
    from dcc_tpu_torch.ops import fused_mlp as FM, fused_ppo as FP

    dev = torch.device("cuda")
    env = env_config(preset)
    T, A, D, H = 150, env.n_agents, env.obs_dim, hidden
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    flat = lambda o: [*o[0], *o[1:]]
    n_bytes = lambda o: 4 * sum(t.numel() for t in flat(o))
    dev_match = "mma_kernel" if preset in MANY_POIS else None  # every launch of a chunked K3u
    kinky = preset is not None or H != 256 or layer_n != 1  # the f32 kink rule applies
    for bf16 in modes:
        algo = MAPPO(MAPPOConfig(compute_dtype="bfloat16" if bf16 else "float32",
                                 fused_loss="on", fused_fold=False, hidden_size=hidden,
                                 layer_n=layer_n), env, device=dev)
        actor, critic = algo.make_networks(seed=5)
        for net in (actor, critic):
            perturb_(net, gen)
            if layer_n != 1:
                condition_deep_(net, gen)
        xdt = torch.bfloat16 if bf16 else torch.float32
        mode = "bf16" if bf16 else "f32"
        tol = PPO_BF16_REL if bf16 else 1e-3
        actor_p = [p.detach() for p in actor.base.flat_params()]
        critic_p = [p.detach() for p in critic.base.flat_params()]
        wh, bh = actor.act_out.weight.detach().t(), actor.act_out.bias.detach()
        wv, bv = critic.v_out.weight.detach().t(), critic.v_out.bias.detach()
        ls = actor.log_std.detach()
        norm = torch.tensor([0.5, 2.0], device=dev)
        for envs in envs_list:
            R, Rv = T * envs * A, T * envs
            obs = randn(R, D).to(xdt)
            adv0 = randn(R, 1)
            act, old_lp = randn(R, 2) * 0.5, -2.0 + 0.3 * randn(R, 1)
            cent = obs.reshape(Rv, A * D)
            with torch.no_grad():
                v0 = critic(cent[: min(Rv, 65536)].float())
            vpred = randn(Rv, 1) * float(v0.std() + 0.1)
            ret = vpred + 3.0 * randn(Rv, 1)
            for label, relu, L, fn in variants or trunk_variants(bf16, preset, H):
                params = actor_p if fn else actor_p[2:2 + 4 * L]
                adv = adv0.clone()
                if relu and not bf16 and kinky:
                    kink = FM.relu_kink_rows(obs, params, L, fn, False)
                    adv[kink] = 0.0
                    print(f"  K3u {mode}, {envs} envs{label}: {int(kink.sum())} of {R} rows "
                          f"next to a relu kink get a zero advantage", flush=True)
                if bf16 and layer_n != 1:  # the clip's kink
                    feat = FM._forward_chain(obs, params, L, fn, relu, True)[0]
                    adv[clip_kink_rows(feat, FP.pack_actor_aux(act, old_lp, adv), wh, bh,
                                       ls)] = 0.0
                aux_a = FP.pack_actor_aux(act, old_lp, adv)
                kw = dict(n_layers=L, use_fn=fn, use_relu=relu, bf16=bf16, clip_param=0.2)
                kern = lambda **m: FP.actor_grads_unfolded_cuda(obs, aux_a, params, wh, bh, ls,
                                                                **kw, **m, _blocked=blocked)
                plain = lambda **m: FP.actor_grads_unfolded_plain(obs, aux_a, params, wh, bh, ls,
                                                                  **kw, **m)
                if relu and bf16:
                    k, p, _ = masked_relu(
                        f"K3u {envs} envs, {_shape(R, D, 1, H)}{label}", kern, plain,
                        lambda m: FM.relu_mask_gap(obs, params, L, fn, m), L, R, H)
                else:
                    k, p = kern(), plain()
                limit = tol
                if bf16:
                    limit = bf16_limit(f"K3u {_shape(R, D, 1, H)}{label}", tol, layer_n, kern,
                                       plain, flat, flat(p), relu, (L, R, H))
                errs = compare("actor_ppo_grads_unfolded", flat(k), flat(p), limit)
                f32_rel = None
                if bf16 and control:
                    f32_k = FP.actor_grads_unfolded_cuda(obs, aux_a, params, wh, bh, ls,
                                                         **{**kw, "bf16": False})
                    f32_rel = f32_reading("actor_ppo_grads_unfolded", flat(f32_k), flat(p),
                                          limit)
                    del f32_k
                # forward, dW and g_prev of every layer (layer 0's for the
                # feature norm's gradients): 3 products of 2 ops a MAC
                ops = 6 * R * (D * H + (L - 1) * H * H)
                nbytes = R * D * (2 if bf16 else 4) + aux_a.numel() * 4 + 2 * n_bytes(k)
                scratch = (layout_bytes("actor_ppo_grads_unfolded", R, D, H, L, 2, blocked)
                           if bf16 else 0)
                b, by = bound(nbytes, ops, PEAK_BF16 if bf16 else PEAK_FP32)
                record(results, "actor_ppo_grads_unfolded" + (
                           "_blocked" if blocked and bf16 else ""), mode, envs,
                       _shape(R, D, 1, H) + label, errs, kern, plain, b, by, f32_rel,
                       preset=preset, scratch_ms=scratch_ms(scratch),
                       device_match=(dev_match or ("mma_kernel" if blocked else
                                                   deep_match(bf16, layer_n))) if bf16 else None,
                       hidden=H,
                       timed=timed_for(timed, label) and (bf16 or layer_n == 1))
                del k, p

                cparams = critic_p if fn else critic_p[2:2 + 4 * L]
                aux_c = FP.pack_critic_aux(vpred, ret)
                if relu and not bf16 and kinky:
                    kink = FM.relu_kink_rows(cent, cparams, L, fn, False)
                    aux_c[kink, 2] = 0.0
                    print(f"  K4u {mode}, {envs} envs{label}: {int(kink.sum())} of {Rv} rows "
                          f"next to a relu kink get valid = 0", flush=True)
                ckw = dict(n_layers=L, use_fn=fn, use_relu=relu, bf16=bf16, clip_param=0.2,
                           huber_delta=10.0, use_huber=True, use_clipped=True)
                # the rows whose value it rounds apart; column-blocked, at 16
                # envs, whose 2,400 rows take the 16-row tile that the
                # probe's subsets take
                if bf16 and (layer_n != 1 or (blocked and envs == 16)):
                    value_flips(f"K4u {envs} envs{label}", cent, aux_c, norm, cparams, wv, bv,
                                ckw)
                kern = lambda **m: FP.critic_grads_unfolded_cuda(cent, aux_c, norm, cparams, wv,
                                                                 bv, **ckw, **m,
                                                                 _blocked=blocked)
                plain = lambda **m: FP.critic_grads_unfolded_plain(cent, aux_c, norm, cparams,
                                                                   wv, bv, **ckw, **m)
                if relu and bf16:
                    k, p, _ = masked_relu(
                        f"K4u {envs} envs, {_shape(Rv, A * D, 1, H)}{label}", kern, plain,
                        lambda m: FM.relu_mask_gap(cent, cparams, L, fn, m), L, Rv, H)
                else:
                    k, p = kern(), plain()
                limit = tol
                if bf16:
                    limit = bf16_limit(f"K4u {_shape(Rv, A * D, 1, H)}{label}", tol, layer_n,
                                       kern, plain, flat, flat(p), relu, (L, Rv, H))
                errs = compare("critic_ppo_grads_unfolded", flat(k), flat(p), limit)
                f32_rel = None
                if bf16 and control:
                    f32_k = FP.critic_grads_unfolded_cuda(cent, aux_c, norm, cparams, wv, bv,
                                                          **{**ckw, "bf16": False})
                    f32_rel = f32_reading("critic_ppo_grads_unfolded", flat(f32_k), flat(p),
                                          limit)
                    del f32_k
                ops = 6 * Rv * (A * D * H + (L - 1) * H * H)
                nbytes = Rv * A * D * (2 if bf16 else 4) + aux_c.numel() * 4 + 2 * n_bytes(k)
                scratch = (layout_bytes("critic_ppo_grads_unfolded", Rv, A * D, H, L, 1, blocked)
                           if bf16 else 0)
                b, by = bound(nbytes, ops, PEAK_BF16 if bf16 else PEAK_FP32)
                record(results, "critic_ppo_grads_unfolded" + (
                           "_blocked" if blocked and bf16 else ""), mode, envs,
                       _shape(Rv, A * D, 1, H) + label, errs, kern, plain, b, by, f32_rel,
                       preset=preset, hidden=H, scratch_ms=scratch_ms(scratch),
                       device_match="mma_kernel" if blocked and bf16 else deep_match(bf16, layer_n),
                       timed=timed_for(timed, label) and (bf16 or layer_n == 1))
                del k, p
            del obs, cent
            torch.cuda.empty_cache()


# the one-card presets whose row widths K2-K4, K2b and K3u / K4u are held
# at, at their 16 envs (actor / critic): 58 / 174, 192 / 960, 122 / 1,220;
# throughput_4096's are the default config's 110 / 440
PRESET_CHECKS = ("3uav_small", "5uav_dense_conn", "10uav_moving_collision")


def check_presets(results: list):
    """Every kernel but K1 at the presets' widths, at the shapes their runs
    give it: K2 on E*A actor and E critic rows, K2b on T*E*A rows of each
    width, K3 / K3u on the T*E*A actor rows, K4 / K4u on the T*E critic
    rows, each in f32 and bf16 under the bounds and kink rules of the
    default config's checks, the gradient kernels in bf16 on the trunks of
    ``trunk_variants``. Each preset draws from a generator of its own, so
    that ``scripts/smoke_phase.py presets`` draws the same data."""
    import torch

    for i, preset in enumerate(PRESET_CHECKS):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        env = env_config(preset)
        print(f"  preset {preset}: {env.n_agents} agents, actor rows {env.obs_dim} wide, "
              f"critic rows {env.share_obs_dim} wide", flush=True)
        check_trunk_forward(results, gen, preset, envs_list=(16,))
        check_trunk_backward(results, gen, ((16, 1, "both"),), preset)
        check_ppo(results, gen, ((16, 1),), preset)
        check_unfolded(results, gen, preset, envs_list=(16,))


def check_wide(results: list):
    """The 20-UAV preset's widths (actor 242, critic 4,840; bf16 K4, K4u and
    K2b there through their chunked layer 0, the dV0 kernel and, for K2b
    and K4u, the layer-0 input backward): K2 at 16 and ``WIDE_ENVS`` envs
    (20 x envs actor rows, envs critic rows, as the rollout gives them); K3
    and K4 at 16 envs (48,000 x 242, 2,400 x 4,840) in f32 and bf16, and in
    bf16 at ``WIDE_ENVS`` envs (3,072,000 x 242, 153,600 x 4,840), the main
    path's shapes, on the trunks of ``trunk_variants`` (there the model
    trunk's rows timed, the others' readings only) (the plain K3 keeps
    about ten 3.1 GB f32 tensors alive there); the dV0 kernel in both modes
    against its plain version at both and on 38,400 rows (an update chunk of
    the fused-loss-off run); the chunked K2b on 2,400 and 38,400 critic rows
    (the fused-loss-off run's update chunk), the chunked K4u on 2,400 and
    153,600, and the layer-0 input backward alone on 38,400 rows (with and
    without dx) and 153,600 (without); then the layer-0 tail at every shape
    its kernels distinguish (``check_tail``)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(9)
    print(f"  the {WIDE} preset's widths, at 16 and {WIDE_ENVS} envs", flush=True)
    check_trunk_forward(results, gen, preset=WIDE, envs_list=(16, WIDE_ENVS))
    check_ppo(results, gen, cases=((16, 1),), preset=WIDE)
    # at WIDE_ENVS the model trunk's rows timed, the others' readings only
    check_ppo(results, gen, cases=((WIDE_ENVS, 1),), preset=WIDE, modes=(True,), timed=("",))
    check_dv0(results, gen, envs_list=(16, WIDE_ENVS // 4, WIDE_ENVS))
    check_wide_chunked(results, gen)
    check_layer0(results, gen)
    check_tail(results)


def _wide_net(gen, seed: int, preset=WIDE, actor: bool = False, hidden: int = 256,
              layer_n: int = 1):
    """The bf16 critic (or actor) of ``preset`` (``make_networks(seed)``) at
    the hidden width ``hidden`` and ``layer_n``, its 1-D parameters moved
    off their init values, and the flat trunk list."""
    from dcc_tpu_torch.algos.mappo import MAPPO, MAPPOConfig

    algo = MAPPO(MAPPOConfig(compute_dtype="bfloat16", fused_trunk="on", hidden_size=hidden,
                             layer_n=layer_n), env_config(preset), device="cuda")
    net = algo.make_networks(seed=seed)[0 if actor else 1]
    perturb_(net, gen)
    if layer_n != 1:
        condition_deep_(net, gen)
    return net, [p.detach() for p in net.base.flat_params()]


def check_dv0(results: list, gen, envs_list, preset=WIDE, actor: bool = False,
              hidden: int = 256):
    """The dV0 kernel (``ops.fused_mlp.dv0_cuda``) against its plain version
    on the T*E critic rows of ``preset`` (the 20-UAV preset's 4,840 wide;
    with ``actor`` its T*E*A actor rows), bf16, their feature-norm
    statistics and a bf16 cotangent of layer 0, within ``DV0_REL``, in both
    modes: the folded K4's (K3's) dV0 = bf16(xhat)^T g0
    (``critic_ppo_grads_dv0``, ``actor_ppo_grads_dv0``) and the unfolded
    chain's dW0 = bf16(xhat * fs + fb)^T g0 (``dv0_unfolded``, the feature
    norm's affine of the preset's network); the product of the unrounded
    operand must lie outside the bound. Beside each, the cuBLAS product
    ``torch.matmul(a0^T, g0)`` of the rounded bf16 operand (bf16 out) as the
    yardstick. ``hidden``: the width of layer 0 (g0 zero-padded to 16)."""
    import torch

    from dcc_tpu_torch.ops import fused_mlp as FM

    env = env_config(preset)
    D, H = env.obs_dim * (1 if actor else env.n_agents), hidden
    kind = "actor" if actor else "critic"
    _, cparams = _wide_net(gen, 6, preset, actor, hidden)
    for envs in envs_list:
        R = 150 * envs * (env.n_agents if actor else 1)
        x = torch.randn(R, D, generator=gen, device="cuda").to(torch.bfloat16)
        xstats = FM.input_stats(x, True)
        g0 = _layer0_cotangent(gen, R, H)
        for name, affine in ((f"{kind}_ppo_grads_dv0", None),
                             ("dv0_unfolded", (cparams[0], cparams[1]))):
            unf = affine is not None
            kern = lambda: FM.dv0_cuda(x, xstats, g0, H, affine, unfolded=unf, kind=kind)
            plain = lambda: FM.dv0_plain(x, xstats, g0, H, affine)
            want = plain()
            errs = compare(name, [kern()], [want], DV0_REL)
            a0 = (x.float() - xstats[:, :1]) * xstats[:, 1:]
            if unf:
                a0 = a0 * affine[0] + affine[1]
            f32_rel = f32_reading(name, [a0.t() @ g0[:, :H].float()], [want], DV0_REL)
            a0 = a0.to(torch.bfloat16)
            library = lambda: torch.matmul(a0.t(), g0[:, :H])
            # x, g0 and the statistics (and the affine) in, dV0 out; one
            # product of 2 ops a MAC
            nbytes = (2 * x.numel() + 2 * g0.numel() + 4 * xstats.numel() + 4 * D * H
                      + (8 * D if unf else 0))
            b, by = bound(nbytes, 2 * R * D * H, PEAK_BF16)
            record(results, name, "bf16", envs, _shape(R, D, 1, H), errs, kern, plain, b, by,
                   f32_rel, preset=preset, device_match="dv0_wgmma_kernel", library=library,
                   hidden=H)
            del want, a0
        del x, g0
        torch.cuda.empty_cache()


def check_wide_chunked(results: list, gen, hidden: int = 256, envs_list=(16, WIDE_ENVS),
                       layer_n: int = 1, variants=None, timed: bool = True,
                       blocked: bool = False):
    """The chunked K2b (``trunk_backward_cuda`` on rows too wide to stage: its
    chunked kernel, the layer-0 input backward and dV0, without dx, as the
    update calls it) on 2,400 and 38,400 of the 20-UAV preset's 4,840-wide
    critic rows (T*E at 16 envs; one of the 4 update chunks of T*E at
    ``WIDE_ENVS``), and the chunked K4u (its chunked kernel, the layer-0
    input backward and dV0) on T*E = 2,400 and 153,600, each on the trunks
    of ``trunk_variants`` (relu under the relu mask rule), against the plain version
    within ``K2B_BF16_REL`` / ``PPO_BF16_REL``. The f32 reading here is the
    plain version computed in f32: the FMA kernels take these rows in
    one-row tiles (seconds a call). Each row's time and bound are its three
    launches'; device us: its ``*_mma_kernel`` launches. ``hidden``: the
    network's hidden width; ``envs_list``: of 16 and ``WIDE_ENVS``, the env
    counts whose rows are checked; ``layer_n``: the network's ``layer_N``,
    ``variants`` its trunks (default ``trunk_variants``'); ``timed`` as
    ``check_trunk_forward``'s; past two layers, the bf16 limits are
    ``bf16_limit``'s and K4u's rows whose value it rounds apart get valid =
    0 (``value_flips``). ``blocked``: the column-blocked layout's chunked
    kernels, forced (rows named ``*_blocked``), and the folded K4's too
    (its chunked kernel and dV0, K4's folded parameters), K4 and K4u under
    the value-flip rule (past hidden 1,024 a value's bf16 step moves its
    row's cotangent past the bound, as in ``check_blocked``'s other
    checks)."""
    import torch

    from dcc_tpu_torch.ops import fused_mlp as FM, fused_ppo as FP

    env = env_config(WIDE)
    D, H = env.n_agents * env.obs_dim, hidden
    critic, full = _wide_net(gen, 7, hidden=hidden, layer_n=layer_n)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    wv, bv = critic.v_out.weight.detach().t(), critic.v_out.bias.detach()
    norm = torch.tensor([0.5, 2.0], device="cuda")
    for envs, rows, label in ((16, 150 * 16, ""), (WIDE_ENVS, 150 * WIDE_ENVS // 4,
                                                    " chunk 1/4")):
        if envs not in envs_list:
            continue
        x = randn(rows, D).to(torch.bfloat16)
        for tag, relu, L, fn in variants or trunk_variants(True, WIDE, H):
            params = full if fn else full[2:2 + 4 * L]
            kw = dict(n_layers=L, use_fn=fn, use_relu=relu, bf16=True, need_dx=False)
            g = randn(rows, H)
            kern = lambda **m: FM.trunk_backward_cuda(x, params, g, **kw, **m, _blocked=blocked)
            plain = lambda **m: FM.trunk_backward_plain(x, params, g, **kw, **m)
            if relu:
                k, p, _ = masked_relu(
                    f"chunked K2b {_shape(rows, D)}{label}{tag}", kern, plain,
                    lambda m: FM.relu_mask_gap(x, params, L, fn, m), L, rows, H)
            else:
                k, p = kern(), plain()
            k, p = k[1], p[1]
            tol = bf16_limit(f"chunked K2b {_shape(rows, D)}{tag}", K2B_BF16_REL, layer_n, kern,
                             plain, lambda o: o[1], p, relu, (L, rows, H))
            name = "fused_mlp_bwd_chunked" + ("_blocked" if blocked else "")
            errs = compare(name, k, p, tol)
            f32_rel = f32_reading(name,
                                  FM.trunk_backward_plain(x, params, g,
                                                          **{**kw, "bf16": False})[1], p, tol)
            ops = 6 * rows * sum(t.numel() for t in params if t.dim() == 2)
            nbytes = 2 * x.numel() + 4 * g.numel() + 2 * 4 * sum(t.numel() for t in params)
            b, by = bound(nbytes, ops, PEAK_BF16)
            scratch = layout_bytes("fused_mlp_bwd", rows, D, H, L, blocked=blocked)
            record(results, name, "bf16", envs,
                   _shape(rows, D, 1, H) + label + tag, errs, kern, plain, b, by, f32_rel,
                   preset=WIDE, device_match="mma_kernel", hidden=H, timed=timed,
                   scratch_ms=scratch_ms(scratch))
            del k, p, g
        del x
        torch.cuda.empty_cache()
    flat = lambda o: [*o[0], *o[1:]]
    for envs in envs_list:
        Rv = 150 * envs
        x = randn(Rv, D).to(torch.bfloat16)
        vpred = randn(Rv, 1)
        ret = vpred + 3.0 * randn(Rv, 1)
        for tag, relu, L, fn in variants or trunk_variants(True, WIDE, H):
            params = full if fn else full[2:2 + 4 * L]
            aux = FP.pack_critic_aux(vpred, ret)
            kw = dict(n_layers=L, use_fn=fn, use_relu=relu, bf16=True, clip_param=0.2,
                      huber_delta=10.0, use_huber=True, use_clipped=True)
            if layer_n != 1 or blocked:  # the rows whose value the kernel rounds apart
                value_flips(f"chunked K4u {_shape(Rv, D, 1, H)}{tag}", x, aux, norm, params, wv,
                            bv, kw)
            kern = lambda **m: FP.critic_grads_unfolded_cuda(x, aux, norm, params, wv, bv, **kw,
                                                             **m, _blocked=blocked)
            plain = lambda **m: FP.critic_grads_unfolded_plain(x, aux, norm, params, wv, bv, **kw,
                                                               **m)
            if relu:
                k, p, _ = masked_relu(
                    f"chunked K4u {_shape(Rv, D)}{tag}", kern, plain,
                    lambda m: FM.relu_mask_gap(x, params, L, fn, m), L, Rv, H)
            else:
                k, p = kern(), plain()
            tol = bf16_limit(f"chunked K4u {_shape(Rv, D)}{tag}", PPO_BF16_REL, layer_n, kern,
                             plain, flat, flat(p), relu, (L, Rv, H))
            name = "critic_ppo_grads_unfolded" + ("_blocked" if blocked else "")
            errs = compare(name, flat(k), flat(p), tol)
            f32_rel = f32_reading(
                name,
                flat(FP.critic_grads_unfolded_plain(x, aux, norm, params, wv, bv,
                                                    **{**kw, "bf16": False})), flat(p), tol)
            ops = 6 * Rv * (D * H + (L - 1) * H * H)
            nbytes = 2 * x.numel() + 4 * aux.numel() + 2 * 4 * sum(t.numel() for t in flat(k))
            b, by = bound(nbytes, ops, PEAK_BF16)
            scratch = layout_bytes("critic_ppo_grads_unfolded", Rv, D, H, L, 1, blocked)
            record(results, name, "bf16", envs, _shape(Rv, D, 1, H) + tag,
                   errs, kern, plain, b, by, f32_rel, preset=WIDE,
                   device_match="mma_kernel", hidden=H, timed=timed,
                   scratch_ms=scratch_ms(scratch))
            del k, p
            if not blocked:
                continue
            # the folded K4 on the same rows: its chunked kernel, then dV0
            kpc, wvf, bvf = FP.fold_trunk(params, wv, bv, L, fn)
            aux = FP.pack_critic_aux(vpred, ret)
            value_flips(f"chunked K4 {_shape(Rv, D, 1, H)}{tag}", x, aux, norm, kpc, wvf, bvf,
                        kw, folded=True)
            kern = lambda **m: FP.critic_grads_cuda(x, aux, norm, kpc, wvf, bvf, **kw, **m,
                                                    _blocked=True)
            plain = lambda **m: FP.critic_grads_plain(x, aux, norm, kpc, wvf, bvf, **kw, **m)
            if relu:
                k, p, _ = masked_relu(
                    f"chunked K4 {_shape(Rv, D, 1, H)}{tag}", kern, plain,
                    lambda m: FP.relu_mask_gap_folded(x, kpc, L, fn, m), L, Rv, H)
            else:
                k, p = kern(), plain()
            tol = bf16_limit(f"chunked K4 {_shape(Rv, D)}{tag}", PPO_BF16_REL, layer_n, kern,
                             plain, flat, flat(p), relu, (L, Rv, H))
            errs = compare("critic_ppo_grads_blocked", flat(k), flat(p), tol)
            f32_rel = f32_reading(
                "critic_ppo_grads_blocked",
                flat(FP.critic_grads_plain(x, aux, norm, kpc, wvf, bvf,
                                           **{**kw, "bf16": False})), flat(p), tol)
            ops = 2 * Rv * (2 * D * H + 3 * (L - 1) * H * H)
            nbytes = 2 * x.numel() + 4 * aux.numel() + 2 * 4 * sum(t.numel() for t in flat(k))
            b, by = bound(nbytes, ops, PEAK_BF16)
            scratch = layout_bytes("critic_ppo_grads", Rv, D, H, L, 1, True)
            record(results, "critic_ppo_grads_blocked", "bf16", envs, _shape(Rv, D, 1, H) + tag,
                   errs, kern, plain, b, by, f32_rel, preset=WIDE, device_match="mma_kernel",
                   hidden=H, timed=timed, scratch_ms=scratch_ms(scratch))
            del k, p
        del x
        torch.cuda.empty_cache()


# the layer-0 input backward's cases at the 20-UAV preset's critic width:
# (envs, rows, dx, label)
LAYER0_WIDE = ((WIDE_ENVS, 150 * WIDE_ENVS // 4, False, " chunk 1/4"),
               (WIDE_ENVS, 150 * WIDE_ENVS // 4, True, " chunk 1/4 dx"),
               (WIDE_ENVS, 150 * WIDE_ENVS, False, ""))


def _layer0_cotangent(gen, rows: int, hidden: int):
    """A bf16 cotangent of layer 0 as the chunked kernels write it: (rows,
    pad16(hidden)), the padding zero."""
    import torch

    from dcc_tpu_torch.ops.fused_mlp import pad16

    g0 = torch.zeros((rows, pad16(hidden)), dtype=torch.bfloat16, device="cuda")
    g0[:, :hidden] = 0.1 * torch.randn(rows, hidden, generator=gen, device="cuda")
    return g0


def check_layer0(results: list, gen, preset=WIDE, actor: bool = False, cases=LAYER0_WIDE,
                 hidden: int = 256, blocked: bool = False):
    """The layer-0 input backward of the chunked K2b, K3u and K4u
    (``ops.fused_mlp.layer0_input_bwd_cuda``) alone, against its plain
    version on the same bf16 operands within ``DV0_REL``, on the critic
    rows of ``preset`` (with ``actor``, the actor rows) for each (envs,
    rows, dx, label) of ``cases``: by default on 38,400 of the 20-UAV
    preset's 4,840-wide critic rows (an update chunk of the fused-loss-off
    run) without dx, as the update calls it, and with dx, and on 153,600
    (the unfolded run's) without; the product with the unrounded W_0 must
    lie outside the bound. ``blocked``: its row-tiled kernel's
    column-blocked build, forced (rows ``layer0_input_bwd_blocked``)."""
    import torch

    from dcc_tpu_torch.ops import fused_mlp as FM

    env = env_config(preset)
    D, H = env.obs_dim * (1 if actor else env.n_agents), hidden
    _, cparams = _wide_net(gen, 8, preset, actor, hidden)
    w0, fs = cparams[2], cparams[0]
    w0b = FM.pack_mma_weights([w0], "cuda")[0].view(FM.pad16(D), FM.pad16(H))
    w0f = torch.zeros(FM.pad16(D), FM.pad16(H), device="cuda")
    w0f[:D, :H] = w0  # unrounded, for the f32 reading
    for envs, rows, need_dx, label in cases:
        x = torch.randn(rows, D, generator=gen, device="cuda").to(torch.bfloat16)
        xstats = FM.input_stats(x, True)
        g0 = _layer0_cotangent(gen, rows, H)
        kern = lambda: FM.layer0_input_bwd_cuda(x, xstats, g0, w0b, fs, H, need_dx,
                                                _blocked=blocked)
        plain = lambda: FM.layer0_input_bwd_plain(x, xstats, g0, w0b, fs, H, need_dx)
        keep = lambda o: [t for t in o if t is not None]
        want = keep(plain())
        # g_prev's products (K = pad16(H)) accumulate in f32 on the tensor
        # cores, whose error grows with the sum's length: past 1,024 the
        # bound grows with it
        tol = DV0_REL * max(1.0, FM.pad16(H) / 1024)
        errs = compare("layer0_input_bwd", keep(kern()), want, tol)
        f32_rel = f32_reading("layer0_input_bwd",
                              keep(FM.layer0_input_bwd_plain(x, xstats, g0, w0f, fs, H,
                                                             need_dx)), want, tol)
        # one product g0 W_0^T (2 ops a MAC); x, g0, the statistics, W_0 and
        # fs in, the two column sums (and dx) out
        nbytes = (2 * x.numel() + 2 * g0.numel() + 4 * xstats.numel() + 2 * D * H + 4 * D
                  + 8 * D + (2 * x.numel() if need_dx else 0))
        b, by = bound(nbytes, 2 * rows * D * H, PEAK_BF16)
        record(results, "layer0_input_bwd" + ("_blocked" if blocked else ""), "bf16", envs,
               _shape(rows, D, 1, H) + label, errs, kern, plain, b, by, f32_rel, preset=preset,
               device_match="layer0_input_bwd", hidden=H)
        del x, g0, want
        torch.cuda.empty_cache()


# the layer-0 tail's shapes held against the plain versions (``check_tail``):
# (rows, d_in, hidden, bf16 x). Rows at the dV0 kernel's flush (512) and its
# steps' and splits' edges; d_in 17 (odd: bf16 x by plain loads), 1,000,
# 1,510 (rows not 16-byte aligned), 4,840, 6,040; hidden 8 to 1,024 (the
# dV0 kernel's column passes past 256, the row-tiled layer-0 input
# backward there)
TAIL_SHAPES = ((1, 4840, 256, True), (37, 4840, 256, False), (511, 1510, 256, True),
               (512, 1510, 100, True), (513, 4840, 264, True), (20000, 4840, 256, True),
               (20000, 1510, 512, False), (513, 6040, 1024, True), (333, 1000, 64, False),
               (100, 17, 8, True), (20000, 6040, 100, True), (512, 17, 1024, False),
               (37, 1000, 512, True), (511, 6040, 8, False))


def _tail_operands(gen, rows: int, d_in: int, hidden: int, x_bf16: bool = True):
    """Rows x (bf16 or f32), their statistics, a layer-0 cotangent, the
    feature norm's scale and bias and a bf16 W_0 as the kernels read it."""
    import torch

    from dcc_tpu_torch.ops import fused_mlp as FM

    x = torch.randn(rows, d_in, generator=gen, device="cuda")
    x = x.to(torch.bfloat16) if x_bf16 else x
    fs = 1.0 + 0.1 * torch.randn(d_in, generator=gen, device="cuda")
    fb = 0.1 * torch.randn(d_in, generator=gen, device="cuda")
    w0 = torch.randn(d_in, hidden, generator=gen, device="cuda") * d_in ** -0.5
    w0b = FM.pack_mma_weights([w0], "cuda")[0].view(FM.pad16(d_in), FM.pad16(hidden))
    return x, FM.input_stats(x, True), _layer0_cotangent(gen, rows, hidden), fs, fb, w0b


def check_tail(results: list):
    """The layer-0 tail at every shape its kernels distinguish
    (``TAIL_SHAPES``): dV0 in both modes, the layer-0 input backward with and
    without dx, and ``layer0_tail`` (its two launches: dfs, dfb, dW0 of the
    unfolded chunked chain) against their plain versions within
    ``DV0_REL``, each call's launches counted. Not timed."""
    import torch

    from dcc_tpu_torch.ops import cuda_build as cb
    from dcc_tpu_torch.ops import fused_mlp as FM

    gen = torch.Generator(device="cuda").manual_seed(13)
    t0, worst = time.perf_counter(), 0.0
    for rows, d_in, H, x_bf16 in TAIL_SHAPES:
        x, xstats, g0, fs, fb, w0b = _tail_operands(gen, rows, d_in, H, x_bf16)
        cases = [("critic_ppo_grads_dv0", lambda: [FM.dv0_cuda(x, xstats, g0, H)],
                  lambda: [FM.dv0_plain(x, xstats, g0, H)]),
                 ("dv0_unfolded", lambda: [FM.dv0_cuda(x, xstats, g0, H, (fs, fb), True)],
                  lambda: [FM.dv0_plain(x, xstats, g0, H, (fs, fb))])]
        for dx in (False, True):
            cases.append(("layer0_input_bwd",
                          lambda dx=dx: FM.layer0_input_bwd_cuda(x, xstats, g0, w0b, fs, H, dx),
                          lambda dx=dx: FM.layer0_input_bwd_plain(x, xstats, g0, w0b, fs, H,
                                                                  dx)))
        cases.append(("layer0_tail", lambda: FM.layer0_tail(x, xstats, g0, w0b, fs, fb, H)[1],
                      lambda: FM.layer0_tail(*[t.cpu() for t in (x, xstats, g0, w0b, fs, fb)],
                                             H)[1]))
        for name, kern, plain in cases:
            cb.reset_launches()
            got = [t for t in kern() if t is not None]
            want = {"layer0_tail": {"layer0_input_bwd": 1, "dv0_unfolded": 1}}.get(name,
                                                                                 {name: 1})
            if dict(cb.LAUNCHES) != want:
                raise SmokeFailure(f"{name} at {rows} x {d_in} x {H}: launches "
                                   f"{dict(cb.LAUNCHES)}, expected {want}")
            err = compare(f"{name} {rows}x{d_in}x{H} x_bf16={x_bf16}", got,
                          [t.to("cuda") for t in plain() if t is not None], DV0_REL)
            worst = max(worst, err[1])
        del x, xstats, g0, w0b
    print(f"  layer-0 tail: {len(TAIL_SHAPES)} shapes x 5 calls held within {DV0_REL} "
          f"(worst rel {worst:.3e}) in {time.perf_counter() - t0:.1f} s", flush=True)
    results.append(dict(kernel="layer0_tail_shapes", mode="bf16", shapes=len(TAIL_SHAPES),
                        rel_err=worst))


# the layer-0 tail's timed shapes (``check_tail_timing``): (rows, d_in,
# hidden) of the 20-UAV preset (153,600 critic rows, an update chunk of
# 38,400), 4 UAVs x 300 PoIs (614,400 actor rows, 153,600 critic rows) and
# the 20-UAV preset at hidden 512
TAIL_TIMED = ((153600, 4840, 256), (38400, 4840, 256), (614400, 1510, 256),
              (153600, 6040, 256), (153600, 4840, 512))


def check_tail_timing(results: list):
    """dV0 (folded and affine) and the layer-0 input backward without dx at
    ``TAIL_TIMED`` on bf16 rows: CUDA events, the profiler's device us with
    the launches it matched a call, cuBLAS's product of the bf16 operands
    beside dV0. It calls only ``dv0_cuda`` and ``layer0_input_bwd_cuda``, so
    any checkout with both wrappers runs it (``scripts/smoke_phase.py timing``)."""
    import torch

    from dcc_tpu_torch.ops import fused_mlp as FM

    gen = torch.Generator(device="cuda").manual_seed(17)
    for rows, d_in, H in TAIL_TIMED:
        x, xstats, g0, fs, fb, w0b = _tail_operands(gen, rows, d_in, H)
        a0 = ((x.float() - xstats[:, :1]) * xstats[:, 1:]).to(torch.bfloat16)
        cases = [("dv0 folded", lambda: FM.dv0_cuda(x, xstats, g0, H), "dv0_"),
                 ("dv0 affine", lambda: FM.dv0_cuda(x, xstats, g0, H, (fs, fb), True), "dv0_"),
                 ("cuBLAS a0^T g0", lambda: torch.matmul(a0.t(), g0[:, :H]), "")]
        if FM.pad16(H) <= 256:
            cases.append(("layer0_input_bwd",
                          lambda: FM.layer0_input_bwd_cuda(x, xstats, g0, w0b, fs, H, False),
                          "layer0_input_bwd"))
        for name, fn, match in cases:
            ms, n = time_ms(fn)
            dev = device_us(fn, n, match) if match else None
            results.append(dict(kernel=name, rows=rows, d_in=d_in, hidden=H, ms=ms, n_timed=n,
                                device_us=dev))
            extra = "" if dev is None else (f" device us/call {dev['kernel']:.1f} (all "
                                            f"{dev['all']:.1f}, {dev['launches']:g} launches "
                                            f"{dev['names']})")
            print(f"  {name:18s} {rows} x {d_in} x {H}: {ms:.4f} ms (x{n}){extra}", flush=True)
        del x, xstats, g0, a0, w0b
        torch.cuda.empty_cache()


def check_default_timing(results: list):
    """The bf16 K2, K2b, K3 / K4 and K3u / K4u at the default widths (hidden
    256), timed against their plain versions as ``check_kernels`` times
    them, on the model's trunk with tanh: no relu masks are asked for, so
    the same calls run on any checkout since the unfolded kernels
    (``scripts/smoke_phase.py [--root DIR] timing``)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    tanh = [(" tanh", False, 2, True)]
    check_trunk_forward(results, gen, envs_list=(16, BIG_ENVS))
    check_trunk_backward(results, gen, ((16, 1, "both"), (BIG_ENVS // 4, 1, "actor")),
                         variants=tanh)
    check_ppo(results, gen, ((16, 1), (BIG_ENVS // 4, 1)), modes=(True,), variants=tanh)
    check_unfolded(results, gen, envs_list=(16, BIG_ENVS // 4), modes=(True,), variants=tanh)
    check_tail_timing(results)


def check_wide_hidden(results: list, ptxas: dict):
    """ROADMAP B3's hidden widths (``HIDDEN_CHECKS``: 100, off multiples of
    8; 264 to 1,024, two to four column passes a layer): K2, K2b, K3 / K4 and
    K3u / K4u on the default config's rows at 16 envs, in f32 and bf16, on
    the trunks of ``trunk_variants`` (bf16: the model's relu trunk under
    the relu mask rule, the model's with tanh, one relu layer); the chunked
    layouts at 512 (K4 on the 20-UAV preset's 4,840-wide critic rows, the
    chunked K2b and K4u, dV0 in both modes, the layer-0 input backward with
    dx); then at 512 and 1,024 (``HIDDEN_TIMED``; at 512 timed and with
    the f32 controls, at 1,024 the readings only) every
    kernel at the main path's shapes at ``HIDDEN_ENVS`` envs on the model's
    trunk: K2 on a rollout step's rows, K2b on the 153,600 rows of an
    update chunk, K3 / K4 and K3u / K4u on 614,400 x 110 and 153,600 x 440,
    and at 512 K4's chunked kernel and dV0 on the 20-UAV preset's 153,600 x
    4,840 (the critic only, as at the preset's own env counts). Each row keeps its kernels' ptxas
    registers and spills."""
    import torch

    first, t0 = len(results), time.perf_counter()
    model = [("", True, 2, True)]
    for i, hidden in enumerate(HIDDEN_CHECKS):
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        print(f"  hidden {hidden}, 16 envs", flush=True)
        check_trunk_forward(results, gen, envs_list=(16,), hidden=hidden)
        check_trunk_backward(results, gen, ((16, 1, "both"),), hidden=hidden)
        check_ppo(results, gen, ((16, 1),), hidden=hidden)
        check_unfolded(results, gen, envs_list=(16,), hidden=hidden)
    gen = torch.Generator(device="cuda").manual_seed(210)
    print(f"  hidden {HIDDEN_ROW}: the chunked layouts at the {WIDE} preset's widths, 16 envs",
          flush=True)
    check_ppo(results, gen, ((16, 1),), preset=WIDE, modes=(True,), hidden=HIDDEN_ROW,
              kinds=("critic",))
    check_wide_chunked(results, gen, hidden=HIDDEN_ROW, envs_list=(16,))
    check_dv0(results, gen, (16,), hidden=HIDDEN_ROW)
    check_layer0(results, gen, cases=((16, 2400, True, " dx"),), hidden=HIDDEN_ROW)
    for hidden in HIDDEN_TIMED:
        print(f"  hidden {hidden}, the main path's shapes at {HIDDEN_ENVS} envs", flush=True)
        # past HIDDEN_ROW the readings only, without the f32 FMA controls
        # (one-row tiles; each kernel's is read at 16 envs at 1,024 above)
        timed = hidden == HIDDEN_ROW
        kw = dict(hidden=hidden, variants=model, timed=timed, control=timed)
        check_trunk_forward(results, gen, envs_list=(HIDDEN_ENVS,), hidden=hidden, timed=timed)
        check_trunk_backward(results, gen, ((HIDDEN_ENVS // 4, 1, "both"),), **kw)
        check_ppo(results, gen, ((HIDDEN_ENVS, 1),), modes=(True,), **kw)
        check_unfolded(results, gen, envs_list=(HIDDEN_ENVS,), modes=(True,), **kw)
    check_ppo(results, gen, ((HIDDEN_ENVS, 1),), preset=WIDE, modes=(True,), hidden=HIDDEN_ROW,
              variants=model, kinds=("critic",))
    check_dv0(results, gen, (HIDDEN_ENVS,), hidden=HIDDEN_ROW)
    shown = set()
    for row in results[first:]:
        row["ptxas"] = kernel_ptxas(ptxas, row["entry"], row["hidden"])
        key = (row["entry"], min(row["ptxas"], default=""))
        if row["mode"] == "bf16" and key not in shown:
            shown.add(key)
            print(f"  ptxas behind {row['entry']} (hidden {row['hidden']}): {row['ptxas']}",
                  flush=True)
    print(f"  B3's hidden widths: {len(results) - first} checks in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def kernel_ptxas(ptxas: dict, entry: str, hidden: int = 256, blocked: bool = False) -> dict:
    """The ptxas registers and spills of the CUDA kernel(s) behind a C
    entry point (``dcc_x_mma`` launches ``x_mma_kernel``) at hidden width
    ``hidden`` (past 256 the ``*_wide`` libraries'; ``blocked``, the
    ``*_blocked`` libraries'), by their mangled names."""
    wide = not blocked and (hidden % 2 == 1 or -(-hidden // 16) * 16 > 256)
    return {fn: v for fn, v in ptxas.items()
            if f"{entry[4:]}_kernel" in fn
            and ((fn.endswith(WIDE_TAG) == wide and fn.endswith(BLOCKED_TAG) == blocked)
                 or entry.endswith("_wgmma"))}


def check_many_pois(results: list, ptxas: dict):
    """The many-PoI swarms' widths (``MANY_POIS``), where bf16 K2, K3 and K3u
    run their chunked layer 0: K2 at 16 and ``WIDE_ENVS`` envs of 4 UAVs x
    300 PoIs (actor rows 1,510 staged, critic rows 6,040 chunked), as the
    rollout gives them, on the 153,600 critic rows of the fused-loss-off
    update's forward at ``WIDE_ENVS`` envs, and at ``WIDE_ENVS`` envs of the
    20-UAV preset with 50 PoIs (critic rows 5,840); the staged and the
    chunked K2 side by side at the 20-UAV preset's 4,840 and at the default
    widths (``check_k2_layouts``); K3 / K4 at 16 envs in f32 and bf16, and in bf16
    at ``WIDE_ENVS`` envs (614,400 x 1,510 and 153,600 x 6,040, the main
    path's shapes), on the trunks of ``trunk_variants`` (there the model
    trunk's rows timed), and at 4 x
    360 (1,810 wide) at 16 envs in bf16, whose one-relu-layer trunk takes
    the chunked K3 (one layer's staged tile holds 1,760 columns); K3u / K4u
    at 4 x 300 the same way; the dV0 kernel in both modes on the actor's
    rows at 16 and ``WIDE_ENVS`` envs, and the layer-0 input backward there
    on 614,400 rows without dx, as K3u calls it; both on the critic's
    153,600 x 6,040 (K4's dV0, K4u's tail). Each check's row keeps the
    ptxas registers and spills of its kernels, printed for the chunked
    ones."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(11)
    env = env_config(POIS)
    print(f"  {POIS}: {env.n_agents} agents, {env.n_pois} PoIs, actor rows {env.obs_dim} "
          f"wide, critic rows {env.share_obs_dim} wide, at 16 and {WIDE_ENVS} envs", flush=True)
    first = len(results)
    check_trunk_forward(results, gen, preset=POIS, envs_list=(16, WIDE_ENVS))
    check_trunk_forward(results, gen, preset=POIS, envs_list=(WIDE_ENVS,), update_steps=150)
    check_trunk_forward(results, gen, preset="20uav-pois50", envs_list=(WIDE_ENVS,))
    check_k2_layouts(results, gen)
    check_ppo(results, gen, cases=((16, 1),), preset=POIS)
    check_ppo(results, gen, cases=((WIDE_ENVS, 1),), preset=POIS, modes=(True,), timed=("",))
    check_ppo(results, gen, cases=((16, 1),), preset="pois360", modes=(True,))
    check_unfolded(results, gen, preset=POIS, envs_list=(16,))
    check_unfolded(results, gen, preset=POIS, envs_list=(WIDE_ENVS,), modes=(True,),
                   timed=("",))
    check_dv0(results, gen, (16, WIDE_ENVS), preset=POIS, actor=True)
    check_layer0(results, gen, preset=POIS, actor=True,
                 cases=((WIDE_ENVS, 150 * WIDE_ENVS * env.n_agents, False, ""),))
    check_dv0(results, gen, (WIDE_ENVS,), preset=POIS)
    check_layer0(results, gen, preset=POIS, cases=((WIDE_ENVS, 150 * WIDE_ENVS, False, ""),))
    shown = set()
    for row in results[first:]:
        row["ptxas"] = kernel_ptxas(ptxas, row["entry"])
        if "chunked" in row["entry"] and row["entry"] not in shown:
            shown.add(row["entry"])
            print(f"  ptxas behind {row['entry']}: {row['ptxas']}", flush=True)


# the widths whose kernel outputs ``kernel_bits`` records: (name, rows, row
# width) of each launch, hidden 256, two layers, bf16 (the 20-UAV preset's
# 4,840-wide critic rows take the chunked K2b, K4 and K4u)
BITS_CASES = (("actor", 9600, 110), ("critic", 2400, 440), ("actor", 3000, 242),
              ("critic", 600, 4840))


def kernel_bits(seed: int = 0) -> dict:
    """Every bf16 kernel's outputs at the widths the kernels took before
    their hidden layers ran in column passes (``BITS_CASES``: actor 110,
    critic 440, the 20-UAV preset's 242 / 4,840, hidden 256, the model's
    relu trunk): K2, K2b, K3 / K4 and K3u / K4u (with dV0 and the layer-0
    input backward at 4,840), each call's outputs and its launches' row
    tiles and its time (CUDA events, ``time_ms``), on inputs drawn on the
    CPU from ``seed``. Calls only what every checkout since the unfolded
    kernels has, so two checkouts' outputs can be compared bit for bit
    (``scripts/smoke_phase.py bits``)."""
    import torch

    from dcc_tpu_torch.ops import fused_mlp as FM, fused_ppo as FP
    from dcc_tpu_torch.ops.cuda_build import LAUNCHES, TILE, reset_launches

    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s, scale=1.0: (scale * torch.randn(s, generator=gen)).cuda()
    out = {}
    for kind, rows, d in BITS_CASES:
        params = [1.0 + rnd(d, scale=0.1), rnd(d, scale=0.1)]
        for k in (d, 256):
            params += [rnd(k, 256, scale=k ** -0.5), rnd(256, scale=0.1),
                       1.0 + rnd(256, scale=0.1), rnd(256, scale=0.1)]
        x = rnd(rows, d).bfloat16()
        n_out = 2 if kind == "actor" else 1
        hw, hb = rnd(256, n_out, scale=0.1), rnd(n_out, scale=0.1)
        g = rnd(rows, 256).bfloat16()
        kw = dict(n_layers=2, use_fn=True, use_relu=True, bf16=True)
        if kind == "actor":
            aux = FP.pack_actor_aux(rnd(rows, 2, scale=0.5), -2.0 + rnd(rows, 1, scale=0.3),
                                    rnd(rows, 1))
            ls = torch.tensor([-0.3, 0.2], device="cuda")
            pk = dict(kw, use_feature_norm=True, clip_param=0.2)
            pk.pop("use_fn")
            ppo = lambda fold: FP.actor_ppo_grads_packed(x, aux, params, hw, hb, ls, fold=fold,
                                                         **pk)
        else:
            vpred = rnd(rows, 1)
            aux = FP.pack_critic_aux(vpred, vpred + 3.0 * rnd(rows, 1))
            norm = torch.tensor([0.5, 2.0], device="cuda")
            pk = dict(kw, use_feature_norm=True, clip_param=0.2, huber_delta=10.0,
                      use_huber=True, use_clipped=True)
            pk.pop("use_fn")
            ppo = lambda fold: FP.critic_value_grads_packed(x, aux, norm, params, hw, hb,
                                                            fold=fold, **pk)
        calls = {"fused_mlp": lambda: [FM.trunk_forward_cuda(x, params, **kw)],
                 "fused_mlp_bwd": lambda: (lambda r: [r[0], *r[1]])(
                     FM.trunk_backward_cuda(x, params, g, **kw)),
                 f"{kind}_ppo_grads": lambda: (lambda r: [*r[0], *r[1:]])(ppo(True)),
                 f"{kind}_ppo_grads_unfolded": lambda: (lambda r: [*r[0], *r[1:]])(ppo(False))}
        for name, call in calls.items():
            reset_launches()
            tensors = [t.detach().cpu() for t in call()]
            torch.cuda.synchronize()
            out[f"{name} {rows}x{d}"] = dict(tensors=tensors, launches=dict(LAUNCHES),
                                             tiles=dict(TILE), ms=time_ms(call)[0])
    return out


def compare_bits(got: dict, want: dict) -> list:
    """The differences between two ``kernel_bits`` records: per call, the
    tensors that are not bit for bit equal, and unequal launch counts or
    row tiles; empty where they agree."""
    import torch

    faults = []
    for key in sorted(set(got) | set(want)):
        if key not in got or key not in want:
            faults.append(f"{key}: only in one record")
            continue
        a, b = got[key], want[key]
        raw = lambda t: t.reshape(-1).contiguous().view(torch.uint8)
        for i, (x, y) in enumerate(zip(a["tensors"], b["tensors"])):
            if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(raw(x), raw(y)):
                diff = float((x.float() - y.float()).abs().max()) if x.shape == y.shape else None
                faults.append(f"{key}[{i}]: not bit-identical (max |diff| {diff})")
        if len(a["tensors"]) != len(b["tensors"]):
            faults.append(f"{key}: {len(a['tensors'])} vs {len(b['tensors'])} outputs")
        for what in ("launches", "tiles"):
            if a[what] != b[what]:
                faults.append(f"{key}: {what} {a[what]} vs {b[what]}")
        if "ms" in a and "ms" in b:  # times are readings, not checks
            print(f"  {key}: {a['ms']:.4f} ms against {b['ms']:.4f} ms", flush=True)
    return faults


def check_update_against_cpu(tag, cfg, param_tol, rtol, atol, kernels, env_kw=None):
    """One update on the card vs the plain versions on the CPU, from the
    same parameters and trajectory, on the default env or
    ``EnvConfig(**env_kw)``; ``kernels`` must launch on the card. In bf16
    the same update computed in f32 on the card must land outside
    ``param_tol``. Returns the readings."""
    import torch

    from dcc_tpu_torch.algos.mappo import MAPPO
    from dcc_tpu_torch.envs import EnvConfig
    from dcc_tpu_torch.ops import LAUNCHES, reset_launches

    bf16 = cfg.compute_dtype == "bfloat16"
    devices = ("cpu", "cuda", "cuda-f32") if bf16 else ("cpu", "cuda")
    env = EnvConfig(**(env_kw or {}))
    algos = {d: MAPPO(cfg._replace(compute_dtype="float32") if d == "cuda-f32" else cfg,
                      env, device=d.split("-")[0]) for d in devices}
    states = {d: a.init_state(seed=3) for d, a in algos.items()}
    for d in devices[1:]:
        for dst, src in zip(states[d].policies(), states["cpu"].policies()):
            for net in ("actor", "critic"):
                getattr(dst, net).load_state_dict(getattr(src, net).state_dict())
    # sampled (not deterministic) actions: with actions equal to the mean the
    # first-epoch actor gradient is exactly zero and Adam would normalize
    # rounding noise into full-size steps
    traj = algos["cpu"].rollout(states["cpu"], 4)
    # the same minibatch permutations on every device: of the T*E*A rows,
    # or with separated policies per agent, of its T*E rows or E*T/L chunks
    T, E, A, _ = traj.actions.shape
    g = torch.Generator().manual_seed(7)
    L = cfg.data_chunk_length if cfg.use_recurrent_policy else T
    n = T * E * A if cfg.share_policy else (E * T // L if algos["cpu"].recurrent else T * E)
    draw = lambda: torch.stack([torch.randperm(n, generator=g) for _ in range(cfg.ppo_epoch)])
    perms = draw() if cfg.share_policy else torch.stack([draw() for _ in range(A)])
    metrics = {}
    for d, algo in algos.items():
        tr = type(traj)(*(None if t is None else t.to(algo.device) for t in traj))
        reset_launches()
        adv, ret = algo.compute_returns(states[d], tr)
        metrics[d] = algo.update(states[d], tr, adv, ret, perms=perms).cpu()
        if d == "cuda":
            launched = dict(LAUNCHES)
    if set(launched) != set(kernels):
        raise SmokeFailure(f"{tag} update on the card launched {launched}, expected each of "
                           f"{sorted(kernels)} and no other kernel")

    def param_gap(d):
        return max(float((a - b.cpu()).abs().max())
                   for pc, pd in zip(states["cpu"].policies(), states[d].policies())
                   for net in ("actor", "critic")
                   for a, b in zip(getattr(pc, net).state_dict().values(),
                                   getattr(pd, net).state_dict().values()))

    worst = param_gap("cuda")
    if worst > param_tol or not torch.allclose(metrics["cpu"], metrics["cuda"], rtol=rtol,
                                               atol=atol):
        raise SmokeFailure(f"{tag} GPU update differs from CPU: params {worst:.3e}, metrics "
                           f"{metrics['cpu'].tolist()} vs {metrics['cuda'].tolist()}")
    f32_gap = param_gap("cuda-f32") if bf16 else None
    if f32_gap is not None and f32_gap <= param_tol:
        raise SmokeFailure(f"{tag}: the update computed in f32 is within the bf16 bound "
                           f"({f32_gap:.3e} <= {param_tol}); the bound is too loose")
    extra = "" if f32_gap is None else f" (computed in f32: {f32_gap:.3e})"
    print(f"  {tag} update, GPU vs CPU: max |param diff| {worst:.3e}{extra}, metrics "
          f"{[round(x, 6) for x in metrics['cuda'].tolist()]}", flush=True)
    return dict(param_gap=worst, f32_param_gap=f32_gap, metrics_cpu=metrics["cpu"].tolist(),
                metrics_cuda=metrics["cuda"].tolist())


# the updates held on the card against the CPU: (tag, MAPPOConfig fields
# beyond UPDATE_SMALL, param bound, metrics rtol, metrics atol, kernels that
# must launch on the card[, EnvConfig fields])
UPDATE_SMALL = dict(n_rollout_threads=4, episode_length=8, ppo_epoch=2, n_iters=5,
                    gae_backend="pallas")
UPDATE_CHECKS = (
    # f32 summation order over 128 rows, two Adam steps of lr ~4e-4
    ("fused f32", dict(fused_loss="on"), 1e-5, 1e-3, 1e-5,
     ("gae", "actor_ppo_grads", "critic_ppo_grads")),
    # bf16 rounding flips move Adam's normalized steps of the parameters
    # whose gradient is near 0 (measured 1.06e-4 at hidden 256); metrics:
    # the bounds of tests/test_torch_recurrent.py
    ("recurrent bf16", dict(compute_dtype="bfloat16", use_recurrent_policy=True,
                            data_chunk_length=4, fused_trunk="on"),
     3e-4, 2e-3, 3e-5, ("gae", "fused_mlp", "fused_mlp_bwd")),
    # the fused minibatch path through K3u / K4u with PopArt's head rescale,
    # under the fused f32 bounds
    ("fused f32 unfolded, 2 minibatches, PopArt",
     dict(fused_loss="on", fused_fold=False, num_mini_batch=2, use_popart=True,
          use_valuenorm=False),
     1e-5, 1e-3, 1e-5, ("gae", "actor_ppo_grads_unfolded", "critic_ppo_grads_unfolded")),
    # the non-Gaussian heads: f32 autograd (the fused trunk and loss are off
    # in f32), under the fused f32 bounds
    *((f"f32 {mode}", {}, 1e-5, 1e-3, 1e-5, ("gae",), dict(action_mode=mode))
      for mode in ("discrete", "multi_discrete", "multi_binary", "mixed")),
    # separated per-agent policies: K1 on per-agent values against per-env
    # rewards and masks, under the fused f32 bounds
    ("f32 separated, 2 minibatches, PopArt",
     dict(share_policy=False, num_mini_batch=2, use_popart=True, use_valuenorm=False),
     1e-5, 1e-3, 1e-5, ("gae",)),
    ("f32 separated recurrent",
     dict(share_policy=False, use_recurrent_policy=True, data_chunk_length=4),
     1e-5, 1e-3, 1e-5, ("gae",)),
    # ROADMAP B3's hidden widths in bf16: the fused update at 512 (two column
    # passes a layer) and the unfolded one at 100 (zero-padded to 112); the
    # parameter bound of tests/test_torch_separated_update.py (Adam turns
    # each bf16 rounding that flips a near-zero gradient into a step of the
    # learning rate: 4.6e-4 measured at hidden 300 between the port's plain
    # versions and the JAX package, tests/test_torch_wide_hidden.py)
    ("bf16 fused, hidden 512", dict(compute_dtype="bfloat16", fused_loss="on",
                                    hidden_size=512),
     1e-3, 2e-3, 3e-5, ("gae", "actor_ppo_grads", "critic_ppo_grads")),
    ("bf16 unfolded, hidden 100", dict(compute_dtype="bfloat16", fused_loss="on",
                                       fused_fold=False, hidden_size=100),
     1e-3, 2e-3, 3e-5, ("gae", "actor_ppo_grads_unfolded", "critic_ppo_grads_unfolded")),
)


def check_updates_against_cpu(results: dict, tags=None, drop_kernels=()):
    """The ``UPDATE_CHECKS`` (those named in ``tags``, default all), each
    requiring its kernels but ``drop_kernels`` to launch."""
    from dcc_tpu_torch.algos.mappo import MAPPOConfig

    for tag, kw, param_tol, rtol, atol, kernels, *env_kw in UPDATE_CHECKS:
        if tags is None or tag in tags:
            results[tag] = check_update_against_cpu(
                tag, MAPPOConfig(**UPDATE_SMALL, **kw), param_tol, rtol, atol,
                tuple(k for k in kernels if k not in drop_kernels), *env_kw)


# phase 4's MADDPG update: the tuned YAML's networks (2 x 128) and batch
# (1,024 rows) at the default env's 16 envs, f32. Bound on every parameter
# tensor of the four networks, ||card - CPU|| / ||CPU||: f32 summation order
# through one Adam step (an update itself moves them by about 1e-3 to 1e-2)
MADDPG_PARAM_RTOL = 1e-5
MADDPG_LOSS_RTOL = 1e-5


def check_maddpg_update(results: dict):
    """One ``MADDPG.update_once`` on the card against the same update on
    the CPU: both states from seed 0 (the same networks), the card's buffer
    after one iteration's collection (150 steps, OU noise and warm-up
    actions drawn on the CPU) copied to the CPU, the same rows. Every
    parameter tensor and both losses within their relative bounds."""
    import torch

    from dcc_tpu_torch.algos import MADDPG
    from dcc_tpu_torch.algos.maddpg import MADDPGState, ReplayBuffer
    from dcc_tpu_torch.configs.loader import load, to_maddpg_config

    cfg, env_cfg, _ = load({"seed": 0}, algo_yaml=algo_yaml("maddpg_tuned")[1])
    mcfg = to_maddpg_config(cfg)
    algos = {d: MADDPG(mcfg, env_cfg, device=d) for d in ("cpu", "cuda")}
    states = {d: a.init_state(seed=0) for d, a in algos.items()}
    g = torch.Generator().manual_seed(1)
    T, shape = mcfg.steps_per_iter, states["cuda"].ou_state.shape
    noise = torch.randn((T, *shape), generator=g)
    uniform = torch.rand((T, *shape), generator=g) * 2.0 - 1.0
    t0 = time.perf_counter()
    algos["cuda"].collect(states["cuda"], T, noise.cuda(), uniform.cuda())
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    src, dst = states["cuda"].buffer, states["cpu"].buffer
    for k in ReplayBuffer.TENSORS:
        getattr(dst, k).copy_(getattr(src, k).cpu())
    dst.ptr, dst.size = src.ptr, src.size
    idx = torch.randint(0, src.size, (mcfg.batch_size,), generator=g)
    before = {n: [p.detach().clone() for p in getattr(states["cpu"], n).parameters()]
              for n in MADDPGState.NETS}
    losses = {d: torch.stack(algos[d].update_once(states[d], idx.to(d))).cpu()
              for d in algos}
    gaps, moves = {}, {}
    for n in MADDPGState.NETS:
        named = zip(getattr(states["cpu"], n).named_parameters(),
                    getattr(states["cuda"], n).parameters(), before[n])
        for (name, pc), pg, p0 in named:
            norm = float(pc.detach().norm())
            gaps[f"{n}.{name}"] = float((pg.detach().cpu() - pc.detach()).norm()) / norm
            moves[f"{n}.{name}"] = float((pc.detach() - p0).norm()) / norm
    worst = max(gaps, key=gaps.get)
    loss_gap = float(((losses["cuda"] - losses["cpu"]).abs() / losses["cpu"].abs()).max())
    print(f"  MADDPG update (tuned: 2 x 128, {mcfg.batch_size} rows), card vs CPU: largest "
          f"parameter gap {gaps[worst]:.3e} ({worst}; bound {MADDPG_PARAM_RTOL}), the update "
          f"moved that tensor {moves[worst]:.3e}; losses {losses['cuda'].tolist()} vs "
          f"{losses['cpu'].tolist()} (gap {loss_gap:.3e}); collect of {T} steps on the card "
          f"{collect_s:.3f} s", flush=True)
    if gaps[worst] > MADDPG_PARAM_RTOL or loss_gap > MADDPG_LOSS_RTOL:
        raise SmokeFailure(f"MADDPG update on the card differs from the CPU: {worst} "
                           f"{gaps[worst]:.3e}, losses {loss_gap:.3e}")
    results["maddpg update"] = dict(param_gaps=gaps, param_moves=moves, loss_gap=loss_gap,
                                    losses_cpu=losses["cpu"].tolist(),
                                    losses_cuda=losses["cuda"].tolist(), collect_s=collect_s)


def check_k2_plain_update(results: dict):
    """The recurrent bf16 update again with K2's forward through its bf16
    plain version on the card (``ops.fused_mlp.trunk_forward_plain``) and K2b
    unchanged: how far K2's summation order moves that update's reading."""
    from dcc_tpu_torch.ops import fused_mlp as FM

    kernel = FM.trunk_forward_cuda

    def plain_forward(x, params, n_layers, use_fn=True, use_relu=True, bf16=False,
                      packed=None):
        return FM.trunk_forward_plain(x, params, n_layers, use_fn, use_relu, bf16)

    FM.trunk_forward_cuda = plain_forward  # what FusedTrunk's forward calls
    try:
        k2: dict = {}
        check_updates_against_cpu(k2, ("recurrent bf16",), drop_kernels=("fused_mlp",))
    finally:
        FM.trunk_forward_cuda = kernel
    results["recurrent bf16, K2 plain"] = k2["recurrent bf16"]


def _short(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    m = re.match(r"(?:void )?([\w:]+)", name)
    return m.group(1) if m else name


def profile_iteration(learner, tag: str) -> dict:
    """One training iteration of the ``tag`` run under torch.profiler (CUDA
    activity only: the host's op events, tens of thousands an iteration,
    took longer to collect than the iteration and are not read): device time
    of each kernel by name (a slot reduction is named after the kernel it
    follows) and the device's idle share, 1 - (union of device-busy
    intervals) / (the iteration's wall time, synchronised at its end)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        learner.algo.train_iteration(learner.ts)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    busy, end, prev = 0.0, -math.inf, "?"
    for e in dev:
        name = _short(e.name)
        if name == "reduce_slots_kernel":
            name = f"reduce_slots_kernel after {prev}"
        else:
            prev = name
        by_name[name][0] += e.time_range.elapsed_us()
        by_name[name][1] += 1
        a, b = e.time_range.start, e.time_range.end
        if b > end:
            busy += b - max(a, end)
            end = b
    if not dev:
        print("  profiler: no device events (device time by name not measured)", flush=True)
        return dict(wall_us=wall_us, device_events=0)
    idle = 1.0 - busy / wall_us
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    print(f"  profiler, one {tag} iteration: wall {wall_us / 1e3:.1f} ms (profiled), device "
          f"busy {busy / 1e3:.2f} ms, idle share {idle:.4f}; device time by kernel:",
          flush=True)
    for name, (us, n) in rows[:16]:
        print(f"    {us / 1e3:10.3f} ms {n:6d} calls {us / n:10.2f} us/call  {name}", flush=True)
    print(f"    {len(dev)} device kernels in the iteration", flush=True)
    return dict(wall_us=wall_us, busy_us=busy, idle_share=idle, device_events=len(dev),
                kernels={k: dict(total_us=v[0], calls=v[1]) for k, v in rows})


def train_run(results: dict, tag: str, args: list, per_iter: dict):
    """Train through ``dcc_tpu_torch.train.main(args)``; require finite
    metrics, each kernel's launches to be ``per_iter`` times the iterations
    (the others none) and the entry points of ``GAE_ENTRY`` and
    ``MMA_ENTRY[tag]``. Returns the Learner."""
    import torch

    from dcc_tpu_torch import train
    from dcc_tpu_torch.ops import LAUNCHES, reset_launches
    from dcc_tpu_torch.ops.cuda_build import ENTRY

    print(f"--- train, {tag}: python -m dcc_tpu_torch.train {' '.join(args)}", flush=True)
    reset_launches()
    t0 = time.perf_counter()
    learner = train.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    m = learner.last_metrics
    m = m._asdict() if hasattr(m, "_asdict") else dict(m)  # MAPPO's Metrics, MADDPG's dict
    if not all(math.isfinite(v) for v in m.values()):
        raise SmokeFailure(f"non-finite training metrics ({tag}): {m}")
    results[tag] = dict(metrics=m, launches=counts, wall_s=wall,
                        phases=learner.timer.summary())
    if tag.startswith(POIS):
        results[tag]["reduced"] = POIS_REDUCED
        print(f"  reduced: {POIS_REDUCED}", flush=True)
    print(f"  launches {counts}; wall {wall:.2f} s", flush=True)
    print(f"  phases {json.dumps(results[tag]['phases'])}", flush=True)
    want = {k: n * learner.n_iters for k, n in per_iter.items()}
    if counts != want:
        raise SmokeFailure(f"{tag}: launches {counts}, expected {want}")
    want_entry = {"gae": GAE_ENTRY, **MMA_ENTRY.get(tag, {})} if per_iter else {}
    entries = {k: ENTRY.get(k) for k in want_entry}
    if entries != want_entry:
        raise SmokeFailure(f"{tag}: the kernels went through {entries}, not {want_entry}")
    return learner


def train_runs(results: dict, table=TRAIN_RUNS, profiled: bool = False):
    """The runs of ``table`` ((tag, arguments beyond ``BASE_ARGS``,
    launches an iteration): ``TRAIN_RUNS``, ``DEEP_RUNS``,
    ``BLOCKED_RUNS``) through the entry point (``train_run``): those of
    ``PROFILED``, each followed by its profiled iteration, or, ``profiled``
    False, the others."""
    for tag, extra, per_iter in table:
        if (tag in PROFILED) == profiled:
            learner = train_run(results, tag, BASE_ARGS + extra, per_iter)
            if profiled:
                results[f"profile {tag}"] = profile_iteration(learner, tag)


def in_background(fn, *args, **kw):
    """Start ``fn(*args, **kw)`` in a thread of its own; returns a function
    that waits for it and returns its result or raises its exception."""
    box: dict = {}

    def run():
        try:
            box["out"] = fn(*args, **kw)
        except BaseException as e:  # handed to the caller of join
            box["err"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "err" in box:
            raise box["err"]
        return box["out"]

    return join


CURVE_KERNELS = {"gae": 1, "fused_mlp": 301, "actor_ppo_grads": 15, "critic_ppo_grads": 15}


def curve_run(results: dict, n_iters: int = 2):
    """``scripts/run_torch_curve.py`` (the learning-gate runner) for
    ``n_iters`` bf16 iterations of seed 0, in this process, into a temporary
    directory: its file must hold the schema the gate reads, with an entry
    per iteration in every series, and K1-K4 must have launched as the bf16
    path runs them (``CURVE_KERNELS`` an iteration)."""
    import importlib.util
    import tempfile

    from dcc_tpu_torch.ops import LAUNCHES, reset_launches

    spec = importlib.util.spec_from_file_location(
        "run_torch_curve", os.path.join(ROOT, "scripts", "run_torch_curve.py"))
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    out = tempfile.mkdtemp(prefix="chip_smoke_curve_")
    env = {"DCC_CURVE_DTYPE": "bfloat16", "DCC_CURVE_ITERS": str(n_iters),
           "DCC_CURVE_DEVICE": "cuda"}
    saved = {k: os.environ.get(k) for k in env}
    print(f"--- curve runner: DCC_CURVE_DTYPE=bfloat16 DCC_CURVE_ITERS={n_iters} "
          f"python scripts/run_torch_curve.py 0", flush=True)
    try:
        os.environ.update(env)
        reset_launches()
        t0 = time.perf_counter()
        runner.run_seed(0, out)
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        with open(os.path.join(out, "dcc_tpu_torch_bf16_seed0.json")) as f:
            d = json.load(f)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(out, ignore_errors=True)
    series = ("reward", "coverage_rate", "value_loss", "policy_loss", "dist_entropy", "ratio",
              "iter_time_s")
    if (set(d["series"]) != set(series) or d["n_iters"] != n_iters or "NVIDIA" not in d["system"]
            or any(len(d["series"][k]) != n_iters or not all(map(math.isfinite, d["series"][k]))
                   for k in series)):
        raise SmokeFailure(f"curve runner: unexpected file {d}")
    want = {k: n * n_iters for k, n in CURVE_KERNELS.items()}
    if counts != want:
        raise SmokeFailure(f"curve runner: launches {counts}, expected {want}")
    results["curve-runner-bf16"] = dict(launches=counts, wall_s=wall, system=d["system"],
                                        iter_time_s=d["series"]["iter_time_s"])
    print(f"  launches {counts}; wall {wall:.2f} s; system {d['system']!r}; iteration times "
          f"{d['series']['iter_time_s']} s", flush=True)


def render_run(results: dict):
    """The default command with render: the default YAMLs (f32), 2
    iterations, the GIF of iteration 2 into a temporary directory. K1 is the
    only kernel of the run, once an iteration; models_2.gif must decode to
    T + 1 = 151 frames of 700 x 700."""
    import tempfile

    from PIL import Image

    out = tempfile.mkdtemp(prefix="chip_smoke_render_")
    try:
        args = ["--n-iters", "2", "--render-interval", "2", "--seed", "0",
                "--main-save-path", out]
        learner = train_run(results, "default-render", args, {"gae": 1})
        gif = os.path.join(learner.output_path, "models_2.gif")
        with Image.open(gif) as im:
            frames, size = im.n_frames, im.size
            for i in range(frames):  # every frame decodes
                im.seek(i)
                im.convert("RGB")
        if (frames, size) != (151, (700, 700)):
            raise SmokeFailure(f"models_2.gif holds {frames} frames of {size}, expected 151 "
                               f"of (700, 700)")
        results["default-render"]["gif"] = dict(frames=frames, size=list(size),
                                                bytes=os.path.getsize(gif))
        print(f"  models_2.gif: {frames} frames of {size[0]} x {size[1]}, "
              f"{os.path.getsize(gif)} bytes", flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)


# ---------------------------------------------------------------------------
# precision: the df64 pull force, the float64 env and the golden traces on
# the card (ROADMAP A12)

PRECISION_ENVS = 16384  # the df64 checks' envs, 4 agents each
CONNECT = dict(comm_force_scale=5.0, comm_r_scale=0.95)  # run_dcc_curve.py's connect variant
CONNECT_ARGS = ["--comm-force-scale", "5.0", "--comm-r-scale", "0.95"]
# the learning gate's three connectivity-force arms: (tag, CLI arguments,
# the env's float dtype)
PRECISION_RUNS = (("connect", [], "torch.float32"),
                  ("connect-comp", ["--compensated-forces", "true"], "torch.float32"),
                  ("connect-envf64", ["--env-dtype", "float64"], "torch.float64"))
PRECISION_ENV_COUNTS = (16, RUN_ENVS)
# tests/test_env_parity.py's tolerances: (obs, reward); dones exact, coverage
# and the reset obs 1e-12
GOLDEN_TOLS = {"default_4x20": (1e-10, 1e-8), "connect_4x20": (1e-6, 1e-5),
               "connect_smallact_4x20": (1e-10, 1e-8), "default_5x10": (1e-10, 1e-8),
               "connect_5x10": (1e-10, 1e-8), "default_10x20": (1e-10, 1e-8)}
# the compensated force against an f64 evaluation of the same f32 positions,
# relative to the force's scale (tests/test_compensated.py:137); the plain
# f32 force must read at least COMP_GAIN times worse
COMP_TRUTH_REL = 1.5e-7
COMP_GAIN = 10.0
# the df64 chain on the card against the CPU, in f32 ulps of the result
DF64_ULPS = 1.0
# (d): one deterministic f64-env rollout (the connect variant, 16 envs, 150
# steps) on the card against the CPU from the same parameters, the actor's
# mean layer scaled by ROLLOUT_ACT_SCALE so that the agents move. Only the
# networks' f32 summation orders differ (cuBLAS against the CPU's, no TF32);
# the env's f64 ops round alike. Perturbing every parameter by 1e-6 relative
# (about what a 256-term f32 dot product's order moves) moved the same CPU
# rollout by obs 7.9e-6, actions 9.2e-6, values 3.4e-6, rewards 6.6e-3 and
# coverage 0; the bounds are 10x that, coverage exact.
ROLLOUT_ACT_SCALE = 30.0
ROLLOUT_ATOL = {"obs": 1e-4, "actions": 1e-4, "values": 5e-5, "rewards": 7e-2, "coverage": 0.0}


def regime_positions(case: str, n_envs: int, seed: int):
    """(n_envs, 4, 2) f32 positions in tests/test_compensated.py's force-onset
    regimes: ``isolated``, a tight cluster and one agent just past the
    scaled radius 0.76 (case 1); ``pair``, two tight pairs just past the
    unscaled radius 0.8 (case 2, softplus argument about 40-50)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    gap = rng.uniform(1e-4, 0.01, n_envs)[:, None]
    theta = rng.uniform(0, 2 * np.pi, n_envs)
    u = np.stack([np.cos(theta), np.sin(theta)], -1)
    if case == "isolated":
        pos = rng.uniform(-0.05, 0.05, (n_envs, 4, 2))
        pos[:, 0] = pos[:, 1] + (2.0 * 0.95 * 0.4 + gap) * u
    else:
        pos = np.zeros((n_envs, 4, 2))
        pos[:, 1] = [0.02, 0.0]
        pos[:, 2] = (2.0 * 0.4 + gap) * u
        pos[:, 3] = pos[:, 2] + [0.02, 0.0]
    return pos.astype(np.float32)


def ulps(got, want, hi=None) -> float:
    """Largest |got - want| in f32 ulps of ``hi`` (default ``want``); CPU
    tensors, compared in f64."""
    import torch

    ref = (want if hi is None else hi).float().abs()
    ulp = (torch.nextafter(ref, torch.full_like(ref, math.inf)) - ref).double()
    return float(((got.double() - want.double()).abs() / ulp).max())


def check_df64(results: dict):
    """(a) The df64 primitives and the compensated ``_connect_force`` on the
    card at PRECISION_ENVS x 4 agents: against the same functions on the CPU
    (bit for bit, else within DF64_ULPS), and the force in both regimes
    against an f64 evaluation of the same f32 positions (COMP_TRUTH_REL;
    the plain f32 force COMP_GAIN times worse or more). Times one force
    call each way."""
    import numpy as np
    import torch

    from dcc_tpu_torch.envs import EnvConfig, connectivity
    from dcc_tpu_torch.envs import coverage as cov
    from dcc_tpu_torch.ops import df64

    n = PRECISION_ENVS * 4 * 2
    rng = np.random.default_rng(1)

    def pair(v):
        hi = v.astype(np.float32)
        lo = (v - hi.astype(np.float64)).astype(np.float32)
        return torch.from_numpy(hi), torch.from_numpy(lo)

    x = pair(rng.uniform(-2, 2, n) * 10.0 ** rng.integers(-3, 3, n))
    y = pair(rng.uniform(0.1, 2, n) * np.where(rng.random(n) < 0.5, -1.0, 1.0))
    b = torch.from_numpy(rng.uniform(-3, 3, n).astype(np.float32))
    ya = (y[0].abs(), torch.where(y[0] < 0, -y[1], y[1]))

    def primitives(x, y, b, ya):
        return {"two_sum": df64.two_sum(x[0], y[0]), "two_diff": df64.two_diff(x[0], y[0]),
                "two_prod": df64.two_prod(x[0], y[0]), "add": df64.add(x, y),
                "sub": df64.sub(x, y), "add_f32": df64.add_f32(x, b), "mul": df64.mul(x, y),
                "mul_f32": df64.mul_f32(x, b), "div": df64.div(x, y),
                "div_f32": df64.div_f32(x, y[0]), "sqrt": df64.sqrt(ya)}

    cuda = lambda p: tuple(t.cuda() for t in p)
    value = lambda p: p[0].double() + p[1].double()
    wants = primitives(x, y, b, ya)
    gots = primitives(cuda(x), cuda(y), b.cuda(), cuda(ya))
    prims = {}
    for name, want in wants.items():
        got = tuple(t.cpu() for t in gots[name])
        prims[name] = dict(bitwise=all(torch.equal(g, w) for g, w in zip(got, want)),
                           ulps=ulps(value(got), value(want), hi=want[0]))
    worst = max(p["ulps"] for p in prims.values())
    print(f"  df64 primitives, card against CPU on {n} f32 pairs: bit for bit "
          f"{sorted(k for k, p in prims.items() if p['bitwise'])}; largest gap {worst:.3g} "
          f"f32 ulps (bound {DF64_ULPS})", flush=True)
    if worst > DF64_ULPS:
        raise SmokeFailure(f"df64 primitives on the card: {prims}")
    results["df64_primitives"] = prims

    base = EnvConfig(**CONNECT)
    comp = base._replace(compensated_forces=True)

    def force(cfg, pos):
        dist, _, adj_, _, connect_s = connectivity(cfg, pos)
        return cov._connect_force(cfg, pos, dist, adj_, connect_s), connect_s

    def partners(pos):
        """Each env's partner choices (case 1's nearest agents, case 2's pair)."""
        dist = connectivity(base, pos)[0]
        masked = torch.where(dist < base.comm_r_scale * 2.0 * base.r_comm, 1e5, dist)
        return torch.cat([torch.argmin(dist, 2), torch.argmin(masked.flatten(1), 1)[:, None]], 1)

    for case, seed in (("isolated", 3), ("pair", 4)):
        pos = torch.from_numpy(regime_positions(case, PRECISION_ENVS, seed))
        pos_d = pos.cuda()
        got, _ = force(comp, pos_d)
        want, cs = force(comp, pos)
        gap = ulps(got.cpu(), want)
        plain = force(base, pos_d)[0].cpu().double()
        truth, cs64 = force(base, pos.double())
        scale = truth.abs().amax(dim=(1, 2))
        # the partners are chosen in f32; where f64 breaks a tie (the pair
        # regime's two cross pairs lie equally far apart) the forces differ
        # by design, so those envs are left out
        same = (partners(pos) == partners(pos.double())).all(1)
        keep = ~cs & ~cs64 & (scale >= 1e-6) & same
        err = lambda f: float(((f - truth).abs().amax(dim=(1, 2)) / scale)[keep].max())
        err_c, err_f = err(got.cpu().double()), err(plain)
        comp_ms, _ = time_ms(lambda: force(comp, pos_d))
        plain_ms, _ = time_ms(lambda: force(base, pos_d))
        row = dict(envs=PRECISION_ENVS, forced=int(keep.sum()), ties=int((~same).sum()),
                   card_vs_cpu_ulps=gap, bitwise=bool(torch.equal(got.cpu(), want)),
                   rel_err_comp=err_c, rel_err_f32=err_f, ms_comp=comp_ms, ms_plain=plain_ms)
        results[f"df64_force_{case}"] = row
        print(f"  compensated _connect_force, {case}: {row['forced']} of {PRECISION_ENVS} envs "
              f"forced ({row['ties']} left out: f64 broke a partner tie); card against CPU "
              f"{gap:.3g} f32 ulps (bit for bit: {row['bitwise']}); against the f64 truth "
              f"{err_c:.3e} (bound {COMP_TRUTH_REL}), plain f32 "
              f"{err_f:.3e} ({err_f / max(err_c, 1e-30):.1f}x); one call {comp_ms:.3f} ms "
              f"(plain f32 {plain_ms:.3f} ms)", flush=True)
        if row["forced"] < 100 or gap > DF64_ULPS or err_c >= COMP_TRUTH_REL \
                or err_f < COMP_GAIN * err_c:
            raise SmokeFailure(f"compensated force, {case}: {row}")


def check_golden(results: dict):
    """(b) The six golden traces replayed on the card in f64 through
    ``compat.compare`` at GOLDEN_TOLS."""
    from dcc_tpu_torch.compat import compare, load_golden

    for name, (tol_obs, tol_rew) in GOLDEN_TOLS.items():
        t0 = time.perf_counter()
        err = compare(load_golden(name), device="cuda")
        err["s"] = time.perf_counter() - t0
        results[f"golden {name}"] = err
        print(f"  golden {name} on the card: obs0 {err['obs0']:.3g} obs {err['obs']:.3g} "
              f"(bound {tol_obs}) reward {err['reward']:.3g} (bound {tol_rew}) done "
              f"{err['done']:.3g} coverage {err['coverage']:.3g}; {err['s']:.2f} s", flush=True)
        if (err["obs0"] > 1e-12 or err["obs"] > tol_obs or err["reward"] > tol_rew
                or err["done"] != 0.0 or err["coverage"] > 1e-12):
            raise SmokeFailure(f"golden trace {name} on the card: {err}")


class EnvWatch:
    """Wraps the coverage env's batched reset and step (``envs.vector``,
    where ``make_vec_fns`` finds them) and counts the (device, dtype) of
    every env tensor they take and give, while active and for each trainer
    built while active."""

    def __init__(self):
        self.seen = collections.Counter()

    def note(self, *objs):
        import dataclasses

        for o in objs:
            ts = ([getattr(o, f.name) for f in dataclasses.fields(o)]
                  if dataclasses.is_dataclass(o) else list(o))
            for t in ts:
                self.seen[(t.device.type, str(t.dtype))] += 1

    def __enter__(self):
        from dcc_tpu_torch.envs import vector

        self.saved = vector.reset_batch, vector.step_batch
        reset0, step0 = self.saved

        def reset(*a, **k):
            s = reset0(*a, **k)
            self.note(s)
            return s

        def step(cfg, states, actions, generator=None):
            new, out = step0(cfg, states, actions, generator)
            self.note(states, new, out)
            return new, out

        vector.reset_batch, vector.step_batch = reset, step
        return self

    def __exit__(self, *exc):
        from dcc_tpu_torch.envs import vector

        vector.reset_batch, vector.step_batch = self.saved

    def check(self, tag: str, float_dtype: str):
        """Every env tensor on the card, every float among them in
        ``float_dtype``."""
        floats = {d for _, d in self.seen if "float" in d}
        if not self.seen or {dev for dev, _ in self.seen} != {"cuda"} or floats != {float_dtype}:
            raise SmokeFailure(f"{tag}: env tensors {dict(self.seen)}, expected all on the "
                               f"card, floats in {float_dtype}")


def env_step_kernels(results: dict, envs: int = 16, n: int = 50):
    """Device kernels (the profiler's CUDA events) of one batched env step
    of the connect variant with the df64 force on and off and in f64, and
    the host ms per step over ``n`` steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dcc_tpu_torch.envs import EnvConfig, reset_batch, step_batch

    cases = (("f32", EnvConfig(**CONNECT), torch.float32),
             ("f32, df64 force", EnvConfig(**CONNECT, compensated_forces=True), torch.float32),
             ("f64", EnvConfig(**CONNECT), torch.float64))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, cfg, dtype in cases:
        states = reset_batch(cfg, envs, dtype=dtype, device="cuda")
        actions = torch.rand((envs, cfg.n_agents, 2), generator=gen, device="cuda") * 2 - 1
        states, _ = step_batch(cfg, states, actions)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step_batch(cfg, states, actions)
            torch.cuda.synchronize()
        kernels = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        t0 = time.perf_counter()
        for _ in range(n):
            states, _ = step_batch(cfg, states, actions)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n * 1e3
        results[f"env step {label}"] = dict(envs=envs, device_kernels=kernels, host_ms=ms)
        print(f"  one env step at {envs} envs, {label}: {kernels} device kernels, "
              f"{ms:.3f} ms a step", flush=True)
        if not kernels:
            raise SmokeFailure(f"env step {label}: the profiler saw no device kernel")


def precision_runs(results: dict):
    """(c) The three connectivity-force arms through
    ``dcc_tpu_torch.train.main`` at 16 envs (2 iterations) and at 256 (1):
    K1 once an iteration by the launch counts and, at 16 envs, by the
    profiler; every env tensor on the card in the arm's dtype (f64 for
    ``--env-dtype float64``)."""
    for tag, extra, float_dtype in PRECISION_RUNS:
        for envs in PRECISION_ENV_COUNTS:
            args = BASE_ARGS + CONNECT_ARGS + extra + ["--n-rollout-threads", str(envs)]
            if envs > 16:
                args += ["--n-iters", "1"]
            name = f"{tag}-{envs}"
            with EnvWatch() as watch:
                learner = train_run(results, name, args, {"gae": 1})
            watch.check(name, float_dtype)
            results[name]["env_tensors"] = {f"{d} {t}": c for (d, t), c in watch.seen.items()}
            if envs == 16:
                prof = profile_iteration(learner, name)
                results[f"profile {name}"] = prof
                calls = prof.get("kernels", {}).get("gae_seg_kernel", {}).get("calls")
                if calls != 1:
                    raise SmokeFailure(f"{name}: the profiler saw K1 {calls} times in an "
                                       f"iteration, expected 1")
    print("  iteration times (train phase mean, s): " + ", ".join(
        f"{tag} {envs}: {results[f'{tag}-{envs}']['phases']['train']['mean_s']:.3f}"
        for tag, _, _ in PRECISION_RUNS for envs in PRECISION_ENV_COUNTS), flush=True)


def check_rollout_f64(results: dict):
    """(d) One deterministic rollout of MAPPO on the f64 connect env (16
    envs, 150 steps) on the card and on the CPU from the same parameters,
    held to ROLLOUT_ATOL field by field; the card's env in f64 on the card."""
    import torch

    from dcc_tpu_torch.algos import MAPPO, MAPPOConfig
    from dcc_tpu_torch.envs import EnvConfig

    trajs = {}
    for dev in ("cuda", "cpu"):
        with EnvWatch() as watch:
            algo = MAPPO(MAPPOConfig(env_dtype="float64"), EnvConfig(**CONNECT), device=dev)
            actor, critic = algo.make_networks(0)
            with torch.no_grad():
                actor.act_out.weight.mul_(ROLLOUT_ACT_SCALE)
            trajs[dev] = algo.rollout(algo.init_state(actor=actor, critic=critic), 16,
                                      deterministic=True)
        if dev == "cuda":
            watch.check("f64 rollout", "torch.float64")
    gaps = {f: float((getattr(trajs["cuda"], f).cpu().double()
                      - getattr(trajs["cpu"], f).double()).abs().max()) for f in ROLLOUT_ATOL}
    moved = float(trajs["cpu"].obs[..., 2:4].abs().max())
    results["f64 rollout card vs cpu"] = dict(gaps=gaps, bounds=ROLLOUT_ATOL, moved=moved)
    print(f"  f64 rollout, card against CPU (16 envs, 150 steps; agents up to {moved:.3f} "
          f"from the origin): " + ", ".join(f"{f} {g:.3g} (bound {ROLLOUT_ATOL[f]})"
                                            for f, g in gaps.items()), flush=True)
    if any(g > ROLLOUT_ATOL[f] for f, g in gaps.items()) or moved < 0.1:
        raise SmokeFailure(f"f64 rollout, card against CPU: {gaps}, moved {moved}")


def check_precision(results: dict):
    """The precision phase, (a)-(d) in order, each part's seconds printed."""
    seconds = results.setdefault("seconds", {})
    for name, part in (("df64", check_df64), ("golden", check_golden),
                       ("env step", env_step_kernels), ("training", precision_runs),
                       ("f64 rollout", check_rollout_f64)):
        t0 = time.perf_counter()
        part(results)
        seconds[name] = time.perf_counter() - t0
    print(f"  precision phase seconds: {json.dumps(seconds)}", flush=True)


# ---------------------------------------------------------------------------
# phase 7: the env axis over ranks (dcc_tpu_torch.parallel, ROADMAP A13)
# ---------------------------------------------------------------------------

MESH_ITERS = 3  # iterations of a mesh case: the first held against one process, all timed
# each rank's kernels in the first iteration of the default bf16 config and of
# the 20-UAV preset (the one-process run's, TRAIN_RUNS)
MESH_LAUNCHES = {"default": next(k for t, _, k in TRAIN_RUNS if t == "bf16"),
                 WIDE: next(k for t, _, k in TRAIN_RUNS if t == f"preset-{WIDE}")}
# the bf16 update's bound of check_update_against_cpu (UPDATE_CHECKS' bf16
# fused entries): max |param diff|, metrics rtol / atol
MESH_PARAM_TOL, MESH_RTOL, MESH_ATOL = 1e-3, 2e-3, 3e-5
# the first step's all-reduced gradients against one process's (max |diff| /
# max |one process's|, a tensor at a time): only the f32 summation order of
# the kernels' row sums differs, whose terms cancel (advantages of mean 0;
# 7.0e-5 on the actor's head at 16 envs). A reduction fault (a term counted
# per rank, a rank's own mean or count) moves a gradient by a rank's share
# of it, 1e-2 and more
MESH_GRAD_RTOL = 1e-3
MESH_REDUCED = {"n_rollout_threads": f"{WIDE_ENVS} of the preset's 16,384 envs, over 2 ranks "
                                     f"on one card (the smoke's time)", "n_iters": "1 iteration"}
TRAJ_FIELDS = ("obs", "actions", "log_probs", "values", "rewards", "masks", "coverage")


def rows_fingerprint(x):
    """(T, E) int64 of a (T, E, ...) trajectory field: for each step and
    env, a position-weighted sum of the bit patterns of its entries, so that
    two runs whose fingerprints agree hold the same bits there (up to a hash
    collision)."""
    import torch

    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float64: torch.int64}
    x = x.reshape(x.shape[0], x.shape[1], -1)
    w = torch.arange(1, x.shape[2] + 1, dtype=torch.int64, device=x.device)
    return torch.cat([(chunk.contiguous().view(ints[x.dtype]).long() * w).sum(dim=2)
                      for chunk in x.split(64, dim=1)], dim=1)


def mesh_spec(tag: str, algo: str = "mappo", preset=None, envs: int = 16,
              iters: int = MESH_ITERS) -> dict:
    return dict(tag=tag, algo=algo, preset=preset, envs=envs, iters=iters)


def bf16_fingerprint(t):
    """An int64 of a tensor's bf16 rounding: a position-weighted sum of its
    bit patterns (the kernels' weight copies; equal fingerprints, equal
    copies up to a hash collision)."""
    import torch

    x = t.detach().reshape(-1).to(torch.bfloat16).view(torch.int16).long()
    return (x * torch.arange(1, x.numel() + 1, dtype=torch.int64, device=x.device)).sum()


def mesh_program(spec: dict, mesh, device) -> dict:
    """One mesh case on ``device``, data-parallel over ``mesh`` (None: one
    process): MAPPO in bf16 (the default config, or ``preset``) or MADDPG
    (``maddpg.yaml``) at ``envs`` envs, from seed 0. MAPPO's first
    iteration runs by its parts, recording the launches, the rollout's
    fingerprints, the update's metrics and the parameters after it, the
    first optimizer step's (all-reduced) gradients and parameters, and
    after every step the fingerprints of the parameters' bf16 roundings;
    every iteration is timed to its end on the device."""
    import torch

    from dcc_tpu_torch.algos import make_algo
    from dcc_tpu_torch.algos.maddpg import ReplayBuffer
    from dcc_tpu_torch.configs import load, load_preset
    from dcc_tpu_torch.ops import LAUNCHES, reset_launches

    over = {"n_rollout_threads": spec["envs"], "n_eval_rollout_threads": 0, "seed": 0}
    if spec["algo"] == "maddpg":
        cfg, env_cfg, _ = load(over, algo_yaml=os.path.join(
            ROOT, "dcc_tpu_torch", "configs", "algo_config", "maddpg.yaml"))
    elif spec["preset"]:
        cfg, env_cfg, _ = load_preset(spec["preset"], overrides={**over,
                                                                 "compute_dtype": "bfloat16"})
    else:
        cfg, env_cfg, _ = load({**over, "compute_dtype": "bfloat16"})
    algo = make_algo(cfg, env_cfg, device=device, mesh=mesh)
    ts = algo.init_state(0)
    params = lambda: {f"{net}.{k}": v.detach().cpu().clone()
                      for net in ("actor", "critic") for k, v in
                      getattr(ts, net).state_dict().items()}
    times, out = [], {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return r

    if spec["algo"] == "maddpg":
        out["metrics"] = [timed(lambda: algo.train_iteration(ts)) for _ in range(spec["iters"])]
        n = spec["iters"] * algo.cfg.n_envs * algo.cfg.steps_per_iter
        out["buffer"] = {k: getattr(ts.buffer, k)[:n].cpu() for k in ReplayBuffer.TENSORS}
    else:
        reset_launches()
        phases, collectives, current = {}, collections.Counter(), [None]
        if mesh is not None:
            # the first iteration's collectives by phase, each timed to its end
            all_sum_ = mesh.all_sum_

            def timed_sum(tensors):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                all_sum_(tensors)
                torch.cuda.synchronize()
                collectives[current[0]] += time.perf_counter() - t0

            mesh.all_sum_ = timed_sum

        def phase(name, fn):
            current[0] = name
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            phases[name] = time.perf_counter() - t0
            current[0] = None
            return r

        grads1, step1, bf16_steps, step = {}, {}, [], algo._step

        def traced_step(ts_):
            named = [(f"{net}.{k}", p) for net in ("actor", "critic")
                     for k, p in getattr(ts_, net).named_parameters()]
            if not grads1:
                grads1.update({k: p.grad.detach().float().cpu() for k, p in named})
            norms = step(ts_)
            if not step1:
                step1.update({k: p.detach().cpu().clone() for k, p in named})
            bf16_steps.append(torch.stack([bf16_fingerprint(p) for _, p in named]))
            return norms

        algo._step = traced_step

        def first():
            traj = phase("rollout", lambda: algo.rollout(ts, algo.cfg.n_rollout_threads))
            adv, ret = phase("returns", lambda: algo.compute_returns(ts, traj))
            m = phase("update", lambda: algo.update(ts, traj, adv, ret))
            return traj, torch.cat([algo.episode_metrics(traj, algo.cfg.n_rollout_threads), m])

        traj, m = timed(first)
        algo._step = step
        if mesh is not None:
            mesh.all_sum_ = all_sum_
        out.update(grads1=grads1, step1=step1, bf16_steps=torch.stack(bf16_steps).cpu(),
                   param_keys=list(grads1))
        out.update(launches=dict(LAUNCHES), metrics=m.cpu(), state1=params(), phases=phases,
                   collective_s=collectives["update"],
                   fingerprint={f: rows_fingerprint(getattr(traj, f)).cpu()
                                for f in TRAJ_FIELDS},
                   values=traj.values.cpu(),
                   rows=(0, spec["envs"]) if mesh is None else
                   (mesh.rows(spec["envs"]).start, mesh.rows(spec["envs"]).stop))
        del traj
        for _ in range(spec["iters"] - 1):
            timed(lambda: algo.train_iteration(ts))
    out.update(times=times, state=params(), ranks=1 if mesh is None else mesh.size)
    return out


def _mesh_rank(specs: list, out_dir: str, backend: str, one_card: bool) -> None:
    """One rank of the mesh cases ``specs``, started by
    ``dcc_tpu_torch.parallel.distributed.spawn``: joins the group over
    ``backend`` on card 0 (``one_card``) or on its own, runs each case and
    writes its results to ``out_dir``."""
    import torch

    from dcc_tpu_torch.parallel import distributed, make_mesh

    # the ranks keep this process's host thread count: the networks are
    # initialized on the host, where the orthogonal init's QR rounds by it,
    # and the rollouts are held bit for bit
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(backend=backend)
    try:
        rank = distributed.process_index()
        device = torch.device("cuda", 0 if one_card else distributed.local_rank())
        torch.cuda.set_device(device)
        for spec in specs:
            out = mesh_program(spec, make_mesh(device), device)
            torch.save(out, os.path.join(out_dir, f"{spec['tag']}_{rank}.pt"))
        distributed.barrier("exit")
    finally:
        distributed.shutdown()


def _run_ranks(specs: list, backend: str, one_card: bool, world: int = 2) -> dict:
    """``specs`` on ``world`` spawned ranks; returns {tag: [rank results]}."""
    import tempfile

    import torch

    from dcc_tpu_torch.parallel import distributed

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        distributed.spawn(_mesh_rank, world, (specs, out_dir, backend, one_card))
        return {s["tag"]: [torch.load(os.path.join(out_dir, f"{s['tag']}_{r}.pt"),
                                      weights_only=True) for r in range(world)]
                for s in specs}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _params_gap(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def check_mesh_case(results: dict, tag: str, ref: dict, ranks: list, launches: dict,
                    exact: bool, card: str):
    """Hold a MAPPO mesh case's ranks against the one-process run ``ref``:
    each rank's rollout its rows of ``ref``'s bit for bit (fingerprints),
    ``launches`` on each rank in the first iteration, the update's metrics
    and parameters within the bf16 update's bound (``exact``: bit for bit,
    every iteration), the ranks' parameters bit for bit."""
    import torch

    row = dict(ranks=len(ranks), ref_times=ref["times"],
               rank_times=[r["times"] for r in ranks], card=card)
    for i, r in enumerate(ranks):
        lo, hi = r["rows"]
        for f in TRAJ_FIELDS:
            apart = r["fingerprint"][f] != ref["fingerprint"][f][:, lo:hi]
            if apart.any():
                steps = apart.any(dim=1).nonzero().flatten().tolist()
                gap = float((r["values"] - ref["values"][:, lo:hi]).abs().max())
                raise SmokeFailure(f"mesh {tag}: rank {i}'s rollout {f} differs from the "
                                   f"one-process run's envs {lo}:{hi} at {int(apart.sum())} "
                                   f"(step, env) of {apart.numel()}, first at step {steps[0]} "
                                   f"(values apart by up to {gap:.3e})")
        if r["launches"] != launches:
            raise SmokeFailure(f"mesh {tag}: rank {i} launched {r['launches']}, expected "
                               f"{launches}")
    gap = _params_gap(ranks[0]["state1"], ref["state1"])
    mgap = float((ranks[0]["metrics"] - ref["metrics"]).abs().max())
    # the first step's gradients, before any parameter differs: a reduction
    # fault shows here, where the update's parameters would divide it by lr
    g, g_ref = ranks[0]["grads1"], ref["grads1"]
    grad_rel = {k: float((g[k] - g_ref[k]).abs().max() / g_ref[k].abs().max().clamp_min(1e-30))
                for k in g_ref}
    grad_key = max(grad_rel, key=grad_rel.get)
    # where the update's parameters part: the tensor and entry of the largest
    # gap, that entry's first gradient, the gap after the first step, and the
    # first step after which a bf16 weight copy differs
    s1_gap = _params_gap(ranks[0]["step1"], ref["step1"])
    key_gaps = {k: float((ranks[0]["state1"][k].float() - ref["state1"][k].float()).abs().max())
                for k in ref["state1"]}
    gap_key = max(key_gaps, key=key_gaps.get)
    apart = ranks[0]["bf16_steps"] != ref["bf16_steps"]  # (steps, tensors)
    first_bf16 = int(apart.any(dim=1).nonzero()[0]) + 1 if apart.any() else None
    diff = (ranks[0]["state1"][gap_key].float() - ref["state1"][gap_key].float()).abs()
    at = int(diff.argmax())
    g_at = (float(g_ref[gap_key].reshape(-1)[at]) if gap_key in g_ref else None)
    parting = dict(grad_rel=grad_rel[grad_key], grad_key=grad_key, step1_param_gap=s1_gap,
                   grad_rel_by_tensor=grad_rel,
                   gap_key=gap_key, gap_entry=at, gap_entry_grad1=g_at,
                   gap_key_grad1_max=(float(g_ref[gap_key].abs().max())
                                      if gap_key in g_ref else None),
                   first_bf16_step=first_bf16,
                   bf16_tensors_apart=apart.sum(dim=1).tolist(),
                   tensors=len(ranks[0]["param_keys"]))
    row.update(param_gap=gap, metrics_gap=mgap, parting=parting, launches=ranks[0]["launches"],
               metrics=ranks[0]["metrics"].tolist(), ref_phases=ref["phases"],
               rank_phases=[r["phases"] for r in ranks],
               collective_s=[r["collective_s"] for r in ranks])
    results[tag] = row
    fmt = lambda ts: "/".join(f"{t:.3f}" for t in ts)
    ph = lambda p: ", ".join(f"{k} {v:.4f}" for k, v in p.items())
    print(f"  {tag}: rollouts bit for bit on every rank; launches a rank {ranks[0]['launches']}; "
          f"update vs one process: max |param diff| {gap:.3e}, metrics {mgap:.3e}"
          f"{' (bit for bit)' if exact else ''}", flush=True)
    print(f"    first step's gradients vs one process: {parting['grad_rel']:.3e} of the "
          f"largest entry at most ({parting['grad_key']}); parameters after it "
          f"{s1_gap:.3e}; bf16 weight copies first apart after step "
          f"{parting['first_bf16_step']} (tensors apart a step "
          f"{parting['bf16_tensors_apart']} of {parting['tensors']}); the largest gap in "
          f"{gap_key}[{at}], its first gradient {g_at} (the tensor's largest "
          f"{parting['gap_key_grad1_max']})", flush=True)
    print("    first step's gradients, the most apart: " + ", ".join(
        f"{k} {v:.3e}" for k, v in sorted(grad_rel.items(), key=lambda kv: -kv[1])[:4]),
        flush=True)
    print(f"    iteration s: one process {fmt(ref['times'])}; "
          + "; ".join(f"rank {i} {fmt(r['times'])}" for i, r in enumerate(ranks))
          + f" ({card})", flush=True)
    print(f"    first iteration's phases s: one process {ph(ref['phases'])}; "
          + "; ".join(f"rank {i} {ph(r['phases'])}, of the update in collectives "
                      f"{r['collective_s']:.4f}" for i, r in enumerate(ranks)), flush=True)
    if exact:
        same = (torch.equal(ranks[0]["metrics"], ref["metrics"])
                and all(torch.equal(ranks[0][s][k], ref[s][k])
                        for s in ("state1", "state") for k in ref[s]))
        if not same:
            raise SmokeFailure(f"mesh {tag}: not bit for bit against one process (params "
                               f"{gap:.3e}, metrics {mgap:.3e})")
    elif gap > MESH_PARAM_TOL or not torch.allclose(ranks[0]["metrics"], ref["metrics"],
                                                     rtol=MESH_RTOL, atol=MESH_ATOL):
        raise SmokeFailure(f"mesh {tag}: the update differs from one process's: params "
                           f"{gap:.3e} (bound {MESH_PARAM_TOL}), metrics "
                           f"{ranks[0]['metrics'].tolist()} vs {ref['metrics'].tolist()}")
    for r in ranks[1:]:
        if not (torch.equal(r["metrics"], ranks[0]["metrics"])
                and all(torch.equal(r[s][k], ranks[0][s][k])
                        for s in ("state1", "state") for k in r[s])):
            raise SmokeFailure(f"mesh {tag}: the ranks' parameters or metrics differ")
    if grad_rel[grad_key] > (0.0 if exact else MESH_GRAD_RTOL):
        raise SmokeFailure(f"mesh {tag}: the first step's gradient {grad_key} differs from one "
                           f"process's by {grad_rel[grad_key]:.3e} of its largest entry (bound "
                           f"{0.0 if exact else MESH_GRAD_RTOL})")
    print("    ranks bit-identical; every bound held", flush=True)


def check_maddpg_mesh(results: dict, ref: dict, ranks: list, card: str):
    """MADDPG over the ranks: the replicated buffer within JAX's bound of
    one process's (tests/test_parallel.py:120-127), the ranks' networks bit
    for bit."""
    import torch

    equal = 0
    for k, want in ref["buffer"].items():
        got = ranks[0]["buffer"][k]
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
            raise SmokeFailure(f"mesh maddpg: buffer {k} differs from one process's: "
                               f"{float((got - want).abs().max()):.3e}")
        equal += int(torch.equal(got, want))
        if not torch.equal(got, ranks[1]["buffer"][k]):
            raise SmokeFailure(f"mesh maddpg: the ranks' buffers {k} differ")
    if not all(torch.equal(ranks[0]["state"][k], ranks[1]["state"][k])
               for k in ranks[0]["state"]):
        raise SmokeFailure("mesh maddpg: the ranks' networks differ")
    gap = _params_gap(ranks[0]["state"], ref["state"])
    results["maddpg-gloo-2ranks"] = dict(buffer_fields_bit_for_bit=equal, param_gap=gap,
                                         ref_times=ref["times"],
                                         rank_times=[r["times"] for r in ranks], card=card)
    fmt = lambda ts: "/".join(f"{t:.3f}" for t in ts)
    print(f"  maddpg-gloo-2ranks: buffer within 1e-5 of one process's ({equal} of "
          f"{len(ref['buffer'])} fields bit for bit), ranks bit-identical, networks vs one "
          f"process {gap:.3e}; iteration s: one process {fmt(ref['times'])}; "
          + "; ".join(f"rank {i} {fmt(r['times'])}" for i, r in enumerate(ranks))
          + f" ({card})", flush=True)


def check_mesh(results: dict):
    """Phase 7: (1) a 1-rank NCCL mesh in this process against the
    unsharded run, bit for bit; (2) 2 gloo ranks on card 0 (8 envs each),
    the default bf16 config, against one process at 16 envs; (3) the 20-UAV
    preset at 1,024 envs over the same 2 ranks (``MESH_REDUCED``); (4)
    MADDPG over 2 ranks; (5) 2 NCCL ranks on two cards where the machine
    has them."""
    import torch

    from dcc_tpu_torch.parallel import distributed, make_mesh

    card = card_line()
    dev = torch.device("cuda", 0)
    default = mesh_spec("default")
    wide = mesh_spec(f"{WIDE}", preset=WIDE, envs=WIDE_ENVS, iters=1)
    maddpg = mesh_spec("maddpg", algo="maddpg", iters=1)
    refs = {s["tag"]: mesh_program(s, None, dev) for s in (default, wide, maddpg)}
    for tag, key in (("default", "default"), (WIDE, WIDE)):
        if refs[tag]["launches"] != MESH_LAUNCHES[key]:
            raise SmokeFailure(f"mesh {tag}: one process launched {refs[tag]['launches']}")
    print(f"  one process: default {refs['default']['launches']}", flush=True)

    distributed.initialize(coordinator_address=f"127.0.0.1:{distributed.free_port()}",
                           num_processes=1, process_id=0, backend="nccl")
    try:
        one = mesh_program(default, make_mesh(dev), dev)
    finally:
        distributed.shutdown()
    check_mesh_case(results, "nccl-1rank", refs["default"], [one], MESH_LAUNCHES["default"],
                    True, card)

    torch.cuda.empty_cache()  # the card's memory for the ranks
    gloo = _run_ranks([default, wide, maddpg], "gloo", one_card=True)
    check_mesh_case(results, "gloo-2ranks-cuda0", refs["default"], gloo["default"],
                    MESH_LAUNCHES["default"], False, card)
    check_mesh_case(results, f"gloo-2ranks-{WIDE}", refs[WIDE], gloo[WIDE],
                    MESH_LAUNCHES[WIDE], False, card)
    results[f"gloo-2ranks-{WIDE}"]["reduced"] = MESH_REDUCED
    print(f"    reduced: {MESH_REDUCED}", flush=True)
    check_maddpg_mesh(results, refs["maddpg"], gloo["maddpg"], card)

    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        nccl = _run_ranks([default], "nccl", one_card=False)
        check_mesh_case(results, "nccl-2cards", refs["default"], nccl["default"],
                        MESH_LAUNCHES["default"], False, card)
    else:
        results["nccl-2cards"] = dict(run=False, cards=n_cards)
        print(f"  nccl-2cards: not run: this machine shows {n_cards} card (NCCL puts no two "
              f"ranks on one device); NCCL across cards stays unverified", flush=True)


def deep_kernel_cases(gen, n_layers: int, hidden: int, conditioned: bool, preset=None,
                      envs: int = 16, k2_rows: int = 64):
    """(name, kernel(bf16, **kw) -> tensors, plain(**masks) -> tensors,
    rows) of every kernel of the trunk at ``envs`` envs, relu, ``n_layers``
    layers of width ``hidden`` (``conditioned``: the biases
    ``condition_deep_``): K2 on the actor's first ``k2_rows`` rows, K2b, K3
    and K3u on its 150 * envs * 4 rows (9,600 x 110 at 16 envs), K4 / K4u
    on the critic's 150 * envs (2,400 x 440); with ``preset``, K4, K4u and
    K2b on its critic rows (the 20-UAV preset's: the chunked layouts)."""
    import torch

    from dcc_tpu_torch.algos.mappo import MAPPO, MAPPOConfig
    from dcc_tpu_torch.ops import fused_mlp as FM, fused_ppo as FP

    env = env_config(preset)
    T, A, D, H, L = 150, env.n_agents, env.obs_dim, hidden, n_layers
    algo = MAPPO(MAPPOConfig(compute_dtype="bfloat16", fused_loss="on", fused_trunk="on",
                             hidden_size=H, layer_n=L - 1), env, device="cuda")
    actor, critic = algo.make_networks(seed=2)
    for net in (actor, critic):
        perturb_(net, gen)
        if conditioned:
            condition_deep_(net, gen)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    ap = [p.detach() for p in actor.base.flat_params()]
    cp = [p.detach() for p in critic.base.flat_params()]
    R, Rv = T * envs * A, T * envs
    obs = randn(R, D).bfloat16()
    cent = obs.reshape(Rv, A * D) if preset is None else randn(Rv, A * D).bfloat16()
    flat = lambda o: [*o[0], *o[1:]]
    aux_a = FP.pack_actor_aux(randn(R, 2) * 0.5, -2.0 + 0.3 * randn(R, 1), randn(R, 1))
    vpred = randn(Rv, 1)
    aux_c = FP.pack_critic_aux(vpred, vpred + 3.0 * randn(Rv, 1))
    norm = torch.tensor([0.5, 2.0], device="cuda")
    wh, bh, ls = (actor.act_out.weight.detach().t(), actor.act_out.bias.detach(),
                  actor.log_std.detach())
    wv, bv = critic.v_out.weight.detach().t(), critic.v_out.bias.detach()
    kp, whf, bhf = FP.fold_trunk(ap, wh, bh, L, True)
    kpc, wvf, bvf = FP.fold_trunk(cp, wv, bv, L, True)
    tkw = dict(n_layers=L, use_fn=True, use_relu=True)
    akw = dict(tkw, clip_param=0.2)
    ckw = dict(tkw, clip_param=0.2, huber_delta=10.0, use_huber=True, use_clipped=True)
    x64 = obs[:k2_rows]
    g = randn(R, H).bfloat16()
    gc = randn(Rv, H)
    cases = [
        ("fused_mlp", lambda bf16, **m: [FM.trunk_forward_cuda(x64, ap, bf16=bf16, **tkw, **m)],
         lambda **m: [FM.trunk_forward_plain(x64, ap, bf16=True, **tkw, **m)], x64.shape[0]),
        ("fused_mlp_bwd",
         lambda bf16, **m: (lambda o: [o[0], *o[1]])(
             FM.trunk_backward_cuda(obs, ap, g, bf16=bf16, **tkw, **m)),
         lambda **m: (lambda o: [o[0], *o[1]])(
             FM.trunk_backward_plain(obs, ap, g, bf16=True, **tkw, **m)), R),
        ("actor_ppo_grads",
         lambda bf16, **m: flat(FP.actor_grads_cuda(obs, aux_a, kp, whf, bhf, ls, bf16=bf16,
                                                    **akw, **m)),
         lambda **m: flat(FP.actor_grads_plain(obs, aux_a, kp, whf, bhf, ls, bf16=True, **akw,
                                               **m)), R),
        ("critic_ppo_grads",
         lambda bf16, **m: flat(FP.critic_grads_cuda(cent, aux_c, norm, kpc, wvf, bvf,
                                                     bf16=bf16, **ckw, **m)),
         lambda **m: flat(FP.critic_grads_plain(cent, aux_c, norm, kpc, wvf, bvf, bf16=True,
                                                **ckw, **m)), Rv),
        ("actor_ppo_grads_unfolded",
         lambda bf16, **m: flat(FP.actor_grads_unfolded_cuda(obs, aux_a, ap, wh, bh, ls,
                                                             bf16=bf16, **akw, **m)),
         lambda **m: flat(FP.actor_grads_unfolded_plain(obs, aux_a, ap, wh, bh, ls, bf16=True,
                                                        **akw, **m)), R),
        ("critic_ppo_grads_unfolded",
         lambda bf16, **m: flat(FP.critic_grads_unfolded_cuda(cent, aux_c, norm, cp, wv, bv,
                                                              bf16=bf16, **ckw, **m)),
         lambda **m: flat(FP.critic_grads_unfolded_plain(cent, aux_c, norm, cp, wv, bv,
                                                         bf16=True, **ckw, **m)), Rv),
    ]
    if preset is not None:  # the critic's rows: K4, K4u, the chunked K2b and K2
        xc = cent[:k2_rows]
        cases = [c for c in cases if c[0].startswith("critic")] + [
            ("fused_mlp",
             lambda bf16, **m: [FM.trunk_forward_cuda(xc, cp, bf16=bf16, **tkw, **m)],
             lambda **m: [FM.trunk_forward_plain(xc, cp, bf16=True, **tkw, **m)], xc.shape[0]),
            ("fused_mlp_bwd",
             lambda bf16, **m: FM.trunk_backward_cuda(cent, cp, gc, bf16=bf16, need_dx=False,
                                                      **tkw, **m)[1],
             lambda **m: FM.trunk_backward_plain(cent, cp, gc, bf16=True, need_dx=False, **tkw,
                                                 **m)[1], Rv)]
    return cases


# (layers, hidden width, envs) of the depth layout's bit-for-bit checks: on
# 16-row tiles at 9 layers, hidden 256 and 32 layers, hidden 128; on the
# largest staged tiles (64 rows for K2b, K3 and K3u on 110-wide rows; 32 for
# the rest, K3u at hidden 256 too: the depth layout's tiles at 32 layers and
# hidden 256) at 2 layers, hidden 256 and 7 layers, hidden 128
DEEP_BITS = ((9, 256, 16), (32, 128, 16), (2, 256, 64), (7, 128, 64))


def check_deep_bits(results: list):
    """Each bf16 gradient kernel in its depth layout (the wrappers'
    ``_deep``) against its staged layout on the same rows, tile and inputs,
    bit for bit, relu masks too, at the ``DEEP_BITS`` depths and widths,
    where the staged tiles hold the trunk; K2b, K3, K4, K3u and K4u on the
    default rows, K4, K4u and K2b on the 20-UAV preset's 4,840-wide critic
    rows (the chunked layouts, but K4's staged at hidden 128 and 7 layers).
    The depth layout keeps the staged layout's roundings and summation
    orders, so anything else is a fault. Each row tile of the depth layout
    (16, 32 and 64 rows) must be among those checked."""
    import torch

    from dcc_tpu_torch.ops import cuda_build

    gen = torch.Generator(device="cuda").manual_seed(29)
    seen = set()
    for L, hidden, envs in DEEP_BITS:
        for preset in (None, WIDE):
            for name, kern, _, rows in deep_kernel_cases(gen, L, hidden, True, preset, envs):
                if name == "fused_mlp":
                    continue
                masks = torch.zeros((L, rows, hidden), dtype=torch.uint8, device="cuda")
                staged = kern(True, relu_masks=masks)
                staged_tile = dict(cuda_build.TILE)
                deep_masks = torch.zeros_like(masks)
                deep = kern(True, relu_masks=deep_masks, _deep=True)
                same = (all(torch.equal(a, b) for a, b in zip(deep, staged))
                        and torch.equal(masks, deep_masks)
                        and dict(cuda_build.TILE) == staged_tile)
                tile = staged_tile[name + ("_chunked" if name == "fused_mlp_bwd"
                                           and preset else "")]
                seen.add(tile)
                where = "" if preset is None else f" {preset}"
                results.append(dict(layers=L, hidden=hidden, preset=preset, kernel=name,
                                    rows=rows, tile=tile, bit_identical=same))
                print(f"  bits L={L} H={hidden}{where} {name} {rows} rows (tile {tile}): "
                      f"depth layout {'bit for bit' if same else 'DIFFERS from'} the staged "
                      f"layout", flush=True)
                if not same:
                    raise SmokeFailure(f"{name} at {L} layers, hidden {hidden}{where}: the "
                                       f"depth layout differs from the staged layout")
                del staged, deep, masks, deep_masks
                torch.cuda.empty_cache()
    if seen != {16, 32, 64}:
        raise SmokeFailure(f"the depth layout's bit checks took tiles {sorted(seen)}, not "
                           f"16, 32 and 64")


def check_deep(results: list):
    """The deep phase: trunks of any depth. The row-tile plans (at 32
    layers every bf16 gradient kernel takes its depth layout, not before);
    the depth layout bit for bit against the staged one (``check_deep_bits``);
    every kernel of the trunk, K2, K2b, K3 / K4 and K3u / K4u, in f32 and
    bf16, against its plain version at 16 envs on the model's relu trunk
    with its biases ``condition_deep_`` (ROADMAP C8) at 8, 9 and 32 layers
    (``DEEP_LAYERS``; bf16 under the relu mask rule and the clip-kink and
    value-flip rules, f32 with the rows next to a kink given a zero
    cotangent, advantage or valid flag), each bf16 reading held to
    ``bf16_limit`` (the bound, or where the plain version's own spread in
    another summation order passes it, ``ORDER_FACTOR`` times that
    spread), timed at 9 and 32 (``DEEP_TIMED``, the {"kernels": [...]}
    line's ``_L9`` / ``_L32`` rows). Then the chunked K2, K4, K2b and K4u on
    the 20-UAV preset's 4,840-wide critic rows (2,400 rows) at 9 layers
    (their chunked depth layouts are held bit for bit to the chunked staged
    ones, ``check_deep_bits``). ``DEEP_RUNS`` run through the entry point
    apart (``train_runs``)."""
    import torch

    from dcc_tpu_torch.ops import tiles

    gen = torch.Generator(device="cuda").manual_seed(17)
    plans = ((k, w, n) for k, w, n in (("fused_mlp", 110, 1), ("fused_mlp_bwd", 110, 1),
                                       ("actor_ppo_grads", 110, 2),
                                       ("critic_ppo_grads", 440, 1),
                                       ("actor_ppo_grads_unfolded", 110, 2),
                                       ("critic_ppo_grads_unfolded", 440, 1),
                                       ("critic_ppo_grads", 4840, 1),
                                       ("fused_mlp_bwd", 4840, 1),
                                       ("critic_ppo_grads_unfolded", 4840, 1)))
    for kernel, width, n_head in plans:
        for L in DEEP_LAYERS:
            p = tiles.plan(kernel, True, width, 256, L, n_head)
            print(f"  plan {kernel} {width} wide, {L} layers: chunked {p.chunked}, tiles "
                  f"{p.tiles}, depth layout {p.deep}", flush=True)
            if not p.tiles or p.deep != (L == 32 and kernel != "fused_mlp"):
                raise SmokeFailure(f"{kernel} at {L} layers: plan {p}, depth layout {p.deep}")
    bits: list = []
    check_deep_bits(bits)
    for L in DEEP_LAYERS:
        timed = L in DEEP_TIMED
        v = [(f" L={L}", True, L, True)]
        print(f"  {L} layers (layer_N {L - 1}), 16 envs{', timed' if timed else ''}", flush=True)
        kw = dict(layer_n=L - 1, timed=timed)
        check_trunk_forward(results, gen, envs_list=(16,), **kw)
        check_trunk_backward(results, gen, cases=((16, 1, "both"),), variants=v, **kw)
        check_ppo(results, gen, cases=((16, 1),), variants=v, **kw)
        check_unfolded(results, gen, envs_list=(16,), variants=v, **kw)
    v = [(" L=9", True, 9, True)]
    kw = dict(layer_n=8, timed=False)
    print(f"  the {WIDE} preset's 4,840-wide critic rows, 9 layers", flush=True)
    check_trunk_forward(results, gen, preset=WIDE, envs_list=(16,), **kw)
    check_ppo(results, gen, cases=((16, 1),), preset=WIDE, modes=(True,), variants=v,
              kinds=("critic",), **kw)
    check_wide_chunked(results, gen, envs_list=(16,), variants=v, **kw)


def check_blocked_bits(results: list):
    """Each bf16 kernel in its column-blocked layout (the wrappers'
    ``_blocked``, which keeps the tile and first layer ``ops.tiles.plan``
    gives otherwise) against its staged layout and, for the gradient kernels
    where their depth layout fits the tile, against that (``_deep``) on the
    same rows, tile and inputs, bit for bit, relu masks and row tiles too,
    at the ``BLOCKED_BITS`` hidden widths and two layers, 16 envs: K2 and
    K2b on the actor's 9,600 x 110 rows, K3 / K3u on them, K4 / K4u on the
    critic's 2,400 x 440; K4, K4u, K2b and K2 on the 20-UAV preset's
    4,840-wide critic rows (their chunked layouts; K2's at 1,024); the
    layer-0 input backward with dx on 2,400 of those rows at the
    ``BLOCKED_BITS`` and ``BLOCKED_CHECKS`` widths, where its g0 rows still
    fit a block. The column-blocked layout keeps the staged layout's
    roundings and summation orders, so anything else is a fault. The tiles
    taken must include 16, 32 and 64 rows."""
    import torch

    from dcc_tpu_torch.ops import cuda_build, tiles

    gen = torch.Generator(device="cuda").manual_seed(31)
    seen = set()
    for hidden in BLOCKED_BITS:
        for preset in (None, WIDE):
            env = env_config(preset)
            for name, kern, _, rows in deep_kernel_cases(gen, 2, hidden, False, preset,
                                                         k2_rows=None):
                # the critic's rows (K4, K4u; with the preset, K2b too) or the actor's
                width = env.obs_dim * (env.n_agents if preset or name.startswith("critic")
                                       else 1)
                n_head = 2 if name.startswith("actor") else 1
                runs = {}
                for layout, kw in (("staged", {}), ("blocked", {"_blocked": True}),
                                   ("depth", {"_deep": True})):
                    if layout == "depth":  # where the depth layout fits the staged tile
                        if name == "fused_mlp":
                            continue
                        p = tiles.plan(name, True, width, hidden, 2, n_head)
                        staged_tiles = runs["staged"][2]
                        tile = staged_tiles.get(name, staged_tiles.get(f"{name}_chunked"))
                        if tiles.smem_bytes(name, True, tile, width, hidden, 2, n_head,
                                            p.chunked, deep=True) > tiles.SMEM_MAX:
                            continue
                    masks = torch.zeros((2, rows, hidden), dtype=torch.uint8, device="cuda")
                    cuda_build.TILE.clear()
                    out = kern(True, relu_masks=masks, **kw)
                    runs[layout] = (out, masks, {k.replace("_blocked", ""): v
                                                 for k, v in cuda_build.TILE.items()})
                out, masks, tile_of = runs["blocked"]
                seen.update(tile_of.values())
                for other in ("staged", "depth"):
                    if other not in runs:
                        continue
                    o_out, o_masks, o_tiles = runs[other]
                    same = (all(torch.equal(a, b) for a, b in zip(out, o_out))
                            and torch.equal(masks, o_masks) and tile_of == o_tiles)
                    where = "" if preset is None else f" {preset}"
                    results.append(dict(hidden=hidden, preset=preset, kernel=name, rows=rows,
                                        tiles=tile_of, against=other, bit_identical=same))
                    print(f"  bits H={hidden}{where} {name} {rows} rows (tiles {tile_of}): "
                          f"column-blocked layout {'bit for bit' if same else 'DIFFERS from'} "
                          f"the {other} layout", flush=True)
                    if not same:
                        raise SmokeFailure(f"{name} at hidden {hidden}{where}: the column-"
                                           f"blocked layout differs from the {other} layout")
                del runs
                torch.cuda.empty_cache()
    # the layer-0 input backward with dx, where its g0 rows still fit a block
    from dcc_tpu_torch.ops import fused_mlp as FM

    env = env_config(WIDE)
    D = env.obs_dim * env.n_agents
    for hidden in BLOCKED_BITS + BLOCKED_CHECKS:
        _, cparams = _wide_net(gen, 9, WIDE, False, hidden)
        w0b = FM.pack_mma_weights([cparams[2]], "cuda")[0].view(FM.pad16(D), FM.pad16(hidden))
        x = torch.randn(2400, D, generator=gen, device="cuda").to(torch.bfloat16)
        xstats = FM.input_stats(x, True)
        g0 = _layer0_cotangent(gen, 2400, hidden)
        runs = []
        for kw in ({}, {"_blocked": True}):
            cuda_build.TILE.clear()
            out = FM.layer0_input_bwd_cuda(x, xstats, g0, w0b, cparams[0], hidden, True, **kw)
            runs.append((out, {k.replace("_blocked", ""): v for k, v in cuda_build.TILE.items()}))
        same = (all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
                and runs[0][1] == runs[1][1])
        results.append(dict(hidden=hidden, preset=WIDE, kernel="layer0_input_bwd", rows=2400,
                            tiles=runs[1][1], against="staged", bit_identical=same))
        print(f"  bits H={hidden} {WIDE} layer0_input_bwd dx 2400 rows (tiles {runs[1][1]}): "
              f"column-blocked build {'bit for bit' if same else 'DIFFERS from'} the staged one",
              flush=True)
        if not same:
            raise SmokeFailure(f"layer0_input_bwd at hidden {hidden}: the column-blocked build "
                               f"differs from the staged one")
    if not {16, 32, 64} <= seen:
        raise SmokeFailure(f"the column-blocked layout's bit checks took tiles {sorted(seen)}, "
                           f"not 16, 32 and 64")


# the plans the column-blocked phase requires at BLOCKED_CHECKS: (kernel,
# row width, head width, hidden widths at which it takes the column-blocked
# layout unforced); every other launch keeps its earlier layout
BLOCKED_PLANS = (("fused_mlp", 110, 1, (4096,)), ("fused_mlp", 440, 1, (4096,)),
                 ("fused_mlp", 4840, 1, (4096,)),
                 ("fused_mlp_bwd", 110, 1, BLOCKED_CHECKS),
                 ("fused_mlp_bwd", 440, 1, BLOCKED_CHECKS),
                 ("actor_ppo_grads", 110, 2, BLOCKED_CHECKS),
                 ("critic_ppo_grads", 440, 1, BLOCKED_CHECKS),
                 ("actor_ppo_grads_unfolded", 110, 2, BLOCKED_CHECKS),
                 ("critic_ppo_grads_unfolded", 440, 1, BLOCKED_CHECKS),
                 ("critic_ppo_grads", 4840, 1, BLOCKED_CHECKS),
                 ("critic_ppo_grads_unfolded", 4840, 1, BLOCKED_CHECKS),
                 ("fused_mlp_bwd", 4840, 1, BLOCKED_CHECKS),
                 ("layer0_input_bwd", 4840, 1, ()))


def check_blocked(results: list, ptxas: dict):
    """ROADMAP B3 rest: hidden widths past what a staged, chunked or depth
    tile holds, the column-blocked layout (``csrc/trunk_mma.cuh``'s
    DCC_BLOCKED, the ``*_blocked`` libraries). The row-tile plans
    (``BLOCKED_PLANS``); the layout bit for bit against the staged and depth
    layouts (``check_blocked_bits``); each kernel in it, forced (K2, K2b,
    K3 / K4, K3u / K4u on the default config's rows, the layer-0 input
    backward with dx on 2,400 of the 20-UAV preset's 4,840-wide critic
    rows), against its plain version at ``BLOCKED_CHECKS`` at 16 envs, bf16,
    on the model's relu trunk under the relu mask rule and the model's trunk
    with tanh (``trunk_variants``' first two; K4 and K4u under the
    value-flip rule), the kernel computed in f32 outside the bound, the
    relu rows timed; at ``BLOCKED_TIMED`` the main path's shapes at
    ``BLOCKED_ENVS`` envs on the model's trunk (K2 on a rollout step's rows,
    K2b on the 153,600 rows of an update, K3 / K4 and K3u / K4u on 153,600
    x 110 and 38,400 x 440), timed, the f32 control only for K2 there; each
    row with its kernels' ptxas registers and spills. Before these (after
    the bit checks), the layout's chunked K2b, K4u and K4 on 2,400 of the
    20-UAV preset's 4,840-wide critic rows at ``BLOCKED_CHECKS``, the plan's
    own layout there (``check_wide_chunked``: relu under the mask and
    value-flip rules, the plain version in f32 as the f32 reading, timed at
    ``BLOCKED_TIMED``), and K2 at 4,096 on the preset's rows and, chunked,
    on the 300-PoI swarm's. ``BLOCKED_RUNS`` run through the entry point
    apart (``train_runs``)."""
    import torch

    from dcc_tpu_torch.ops import tiles

    first, t0 = len(results), time.perf_counter()
    for kernel, width, n_head, blocked_at in BLOCKED_PLANS:
        for hidden in BLOCKED_CHECKS:
            p = tiles.plan(kernel, True, width, hidden, 2, n_head)
            print(f"  plan {kernel} {width} wide, hidden {hidden}: chunked {p.chunked}, tiles "
                  f"{p.tiles}, column-blocked {p.blocked}", flush=True)
            # a blocked plan keeps the first layer the row takes at hidden 256
            wide = p.blocked and tiles.plan(kernel, True, width, 256, 2, n_head).chunked
            if not p.tiles or p.blocked != (hidden in blocked_at) or p.blocked and (
                    p.chunked != wide):
                raise SmokeFailure(f"{kernel} at hidden {hidden}: plan {p}")
    bits: list = []
    check_blocked_bits(bits)
    print(f"  bit checks done at {time.perf_counter() - t0:.1f} s", flush=True)
    # the chunked kernels of the layout on the 20-UAV preset's 4,840-wide
    # critic rows, as its runs launch them (the plan's own choice there):
    # K2b, K4u and K4, then the layer-0 tail, on the model's relu trunk
    # under the mask and value-flip rules, timed at BLOCKED_TIMED (the
    # {"kernels": [...]} line's ``*_chunked_blocked_h*``); K2 at 4,096 on the
    # preset's rows and, chunked, on the 300-PoI swarm's 6,040-wide ones
    model = [("", True, 2, True)]
    for i, hidden in enumerate(BLOCKED_CHECKS):
        gen = torch.Generator(device="cuda").manual_seed(320 + i)
        print(f"  hidden {hidden}, the {WIDE} preset's rows at 16 envs, the column-blocked "
              f"layout's chunked kernels (at {time.perf_counter() - t0:.1f} s)", flush=True)
        check_wide_chunked(results, gen, hidden=hidden, envs_list=(16,), variants=model,
                           timed=hidden == BLOCKED_TIMED, blocked=True)
    gen = torch.Generator(device="cuda").manual_seed(330)
    for preset in (WIDE, POIS):
        check_trunk_forward(results, gen, preset=preset, envs_list=(16,), modes=(True,),
                            hidden=BLOCKED_CHECKS[-1], blocked=True)
    # relu (mask rule), timed; tanh, its readings only
    trunks = trunk_variants(True, None, BLOCKED_CHECKS[0])[:2]
    for i, hidden in enumerate(BLOCKED_CHECKS):
        gen = torch.Generator(device="cuda").manual_seed(300 + i)
        print(f"  hidden {hidden}, 16 envs, the column-blocked layout (at "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
        kw = dict(hidden=hidden, blocked=True)
        check_trunk_forward(results, gen, envs_list=(16,), modes=(True,), **kw)
        check_trunk_backward(results, gen, ((16, 1, "both"),), modes=(True,), variants=trunks,
                             timed=("",), **kw)
        check_ppo(results, gen, ((16, 1),), modes=(True,), variants=trunks, timed=("",), **kw)
        check_unfolded(results, gen, envs_list=(16,), modes=(True,), variants=trunks,
                       timed=("",), **kw)
        check_layer0(results, gen, cases=((16, 2400, True, " dx"),), **kw)
    gen = torch.Generator(device="cuda").manual_seed(310)
    kw = dict(hidden=BLOCKED_TIMED, blocked=True, modes=(True,))
    print(f"  hidden {BLOCKED_TIMED}, the main path's shapes at {BLOCKED_ENVS} envs, the "
          f"column-blocked layout (at {time.perf_counter() - t0:.1f} s)", flush=True)
    check_trunk_forward(results, gen, envs_list=(BLOCKED_ENVS,), **kw)
    kw.update(variants=model, control=False)  # the f32 controls: at 16 envs, above
    check_trunk_backward(results, gen, ((BLOCKED_ENVS, 1, "both"),), **kw)
    check_ppo(results, gen, ((BLOCKED_ENVS, 1),), **kw)
    check_unfolded(results, gen, envs_list=(BLOCKED_ENVS,), **kw)
    shown = set()
    for row in results[first:]:
        row["ptxas"] = kernel_ptxas(ptxas, row["entry"], row["hidden"], True)
        key = (row["entry"], min(row["ptxas"], default=""))
        if key not in shown:
            shown.add(key)
            print(f"  ptxas behind {row['entry']} [blocked]: {row['ptxas']}", flush=True)
    print(f"  the column-blocked layout: {len(results) - first} checks in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ptxas", action="store_true",
                    help="print all of nvcc's -Xptxas -v report")
    ap.add_argument("--out", default=None, help="also write all results to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from dcc_tpu_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the dcc_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.chdir(ROOT)

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {card}; {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    at = lambda: f"(at {time.perf_counter() - t0:.0f} s)"
    # K1 first; the other sources build in a background thread while the
    # runs that need no other kernel, or wait for theirs, go on (the
    # libraries load one at a time, each once its source is built)
    k1 = cuda_build.build(verbose=True, names=("gae",))
    join_build = in_background(cuda_build.build, verbose=True)
    print(f"[2] built ['gae'] in {k1['_seconds']:.1f} s; the other kernels build in the "
          f"background {at()}", flush=True)
    runs: dict = {}
    precision: dict = {}
    try:
        print(f"[3] while they build: training through dcc_tpu_torch.train {at()}", flush=True)
        train_runs(runs)
        print(f"[3b] precision: the df64 pull force, the golden traces and the float64 env on "
              f"the card {at()}", flush=True)
        check_precision(precision)
        print(f"[3c] the deep trunks' runs and the runs at hidden {BLOCKED_TIMED}, 4,096 and "
              f"4,800 {at()}", flush=True)
        train_runs(runs, DEEP_RUNS)
        train_runs(runs, BLOCKED_RUNS)
        built = join_build()
    except BaseException:
        cuda_build.stop_builds()
        raise
    built["_ptxas"].update(k1["_ptxas"])
    print(f"[4] built {sorted(k for k in built if not k.startswith('_'))} in "
          f"{built['_seconds']:.1f} s {at()}", flush=True)
    ptxas = ptxas_report(built["_ptxas"], args.ptxas)
    sass = sass_check(built)

    checks: list = []
    print(f"[5] hidden widths past 1,024: the column-blocked layout {at()}", flush=True)
    t_blocked = time.perf_counter()
    check_blocked(checks, ptxas)
    print(f"  column-blocked phase {time.perf_counter() - t_blocked:.1f} s", flush=True)
    print(f"[6] kernels against their plain versions {at()}", flush=True)
    check_kernels(checks, ptxas)
    print(f"[7] updates on the card against the CPU {at()}", flush=True)
    updates: dict = {}
    check_updates_against_cpu(updates)
    check_k2_plain_update(updates)
    check_maddpg_update(updates)
    print(f"[8] the profiled runs, the curve runner and the render {at()}", flush=True)
    train_runs(runs, profiled=True)
    curve_run(runs)
    render_run(runs)
    print(f"[9] the env axis over ranks: a 1-rank NCCL mesh, 2 gloo ranks on card 0, MADDPG "
          f"{at()}", flush=True)
    mesh: dict = {}
    t_mesh = time.perf_counter()
    check_mesh(mesh)
    mesh["seconds"] = time.perf_counter() - t_mesh
    print(f"  mesh phase {mesh['seconds']:.1f} s", flush=True)
    print(f"[10] deep trunks: every kernel at 8, 9 and 32 layers {at()}", flush=True)
    t_deep = time.perf_counter()
    check_deep(checks)
    print(f"  deep phase {time.perf_counter() - t_deep:.1f} s", flush=True)
    print(f"[11] done {at()}", flush=True)

    kernels = []
    for name in REPLACES:
        mode = "f32" if name == "gae" else "bf16"
        kernel, envs, preset, *more = KERNEL_ROW.get(name, (name, 16, None))
        hidden = more[0] if more else 256
        has = more[1] if len(more) > 1 else ""
        row = next(c for c in checks if c["kernel"] == kernel and c["mode"] == mode
                   and c["envs"] == envs and "nmb" not in c["shape"] and c["preset"] == preset
                   and c["hidden"] == hidden and has in c["shape"])
        # K1's wrapper takes longer on the host than its kernel on the card,
        # so its event time is the host's rate: device_ms beside it
        dev = row["device_us"]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=runs[MAIN_RUN[name]]["launches"].get(kernel, 0), hidden=hidden,
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            device_ms=dev["kernel"] / 1e3 if dev else None, plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], scratch_ms=row["scratch_ms"],
            library_ms=row["library_ms"],
            mode=mode, shape=row["shape"], entry=row["entry"],
            host_us=row["host_us"]["wrapper"],
            ptxas=kernel_ptxas(ptxas, row["entry"], hidden, "_blocked" in kernel),
        ))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, kind=kind, torch=torch.__version__,
                           build_s=built["_seconds"], ptxas=ptxas, sass_hmma=sass,
                           checks=checks, updates=updates, train=runs, precision=precision,
                           mesh=mesh, kernels=kernels),
                      f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
