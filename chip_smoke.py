#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the serving path,
first- and second-order MAML meta-training, regional adaptation with the
pipeline, node-sharded / data-parallel meta-training, the LSTM kernel
routes, the two flag-selected LSTM-stack paths (the task-batched meta
step and the unmerged-gates stack), reference-checkpoint interop and the
region fleet (`pipeline --mesh-fleet`), second-order MAML on both
meshes with the task-batched meta step on the dp mesh, the GSPMD dp x
sp meta step with chained meta epochs, the wavefront LSTM, the adaptation
step's unfolded window batch and the task-batched meta step on the dp x sp
mesh.

Run from the root of a checkout:  python3 chip_smoke.py
(`python3 chip_smoke.py --mesh-rank DIR [--vbatch] [-o KEY=VALUE ...]` is
phases 14, 22, 23 and 24's rank process, started by torch.distributed.run.)

Phases (the first failure raises and exits non-zero; each prints its wall
time):
  1. require a CUDA card of compute capability 9.x; print its name and
     power limit;
  2. build the native host pipeline (native/csrc/wf_native.cpp, g++; the
     script fails without it) and the CUDA kernels from ops/csrc/*.cu;
     check that the library
     exports no `wf_gemm` (gemm.cu's retired SIMT GEMM: no path can launch
     it) and that the retired row 2 and row 20 sources are gone; print the
     cluster plans of the backward, forward and tangent LSTM recurrences
     (validate's 1536 rows on 48 clusters of 2 x 32 rows in float32, all
     co-resident), the streamed plans at float32 H 448, 512 and 1024 and
     bfloat16 H 640 and 1024 and the eval forward's at float32 H 320 / 384
     (k_res of K rows resident, shared memory C against Python, clusters at
     once, L2 bytes a step) and ptxas's registers and spills of each
     recurrence instance (none may spill at 32 rows a cluster, no streamed
     instance may spill: 11 forward, 23 + 23 backward);
  3. hold the serving kernels (rows 1-2) against their plain PyTorch
     versions at the reference width (ModelConfig() defaults, the Moscow
     graph: 441 nodes padded to 512; row 2 at validate's [1536, 24, 256]
     and the forecast's [512, 24, 256], each call gated on 4 gemm_nn and 4
     forward recurrence launches), float32 and bfloat16;
  4. write a seeded base checkpoint and drive the serving CLI: `forecast`
     for three regions and `validate --no-plots` for Moscow, at float32 and
     bfloat16; both kernels must have launched, every output must be
     finite, and the Moscow forecast must match the same request on the
     plain route (`--device cpu`);
  5. time the serving kernels, their plain versions and cuDNN / cuBLAS
     yardsticks (row 2 at both shapes by events, CUDA graph replay and
     enqueue, cuDNN's forward by events and graph replay), one `predict`
     call and one whole forecast request;
  5b. hold the native host pipeline's five functions against the numpy
     route on Moscow's region (720 steps x 441 nodes, 5% NaN: kNN edges and
     windows equal, adjacency, NaN fill, stats and z-score within float32
     rounding) and time the forecast request's host stages (graph,
     features) and the whole request with the library on and off, in turns;
  6. hold the training kernels (rows 4-7) against their plain versions at
     the inner step's shapes (one window: 24 slices x 512 nodes, 512 LSTM
     rows), forward and every gradient, float32 and bfloat16, with the same
     dropout masks (rate 0.2) on both sides; time each direction; rows 6
     and 7 also alone, by events and by CUDA graph replay, each gated on
     its launches of the GEMM core (row 6: 2 gemm_nn a layer; row 7: 2
     gemm_nn and 1 gemm_tn a layer); row 4
     alone against its schedule on the plain pieces (h_last, h_all, c_all,
     the gates; masks on and off), gated on 1 gemm_nn and 1 forward
     recurrence launch a layer from one call, by events, by CUDA graph
     replay, by part, the host's time a call, beside cuDNN's forward; row 5
     alone from row 4's residuals by events, CUDA graph replay and part
     (recurrences, input products, the weight gradients' TN products and
     partial sums) beside cuDNN's backward by events and graph replay; before
     this phase (6a) the four LSTM recurrences (backward, forward, row 11's
     tangent, row 10's tangent forward) and row 18 (the forward recurrence
     with float32 h and c, xp holding the bias) alone against their plain
     versions at H 64 / 128 / 256 (clusters of 1, 2, 4 and 8 blocks);
  7. hold the whole-tree clip + SGD kernel (row 8: two kernels chained by
     programmatic dependent launch; row 9: its two kernels with a task
     axis) against its plain version on the reference model's 23
     leaves, one task and a task axis of 4, gradient norms below and above
     clip_norm, and on trees of odd, unaligned leaves (31 x 7, 5, ...);
     two calls bitwise equal, and one call captured in a CUDA graph and
     replayed equal to an eager call; time it (torch.profiler, and the
     host's time to enqueue a call), the plain version and torch's
     clip_grad_norm_ + _foreach_add_; the build phase prints row 8's
     kernels' ptxas registers and fails if they spill;
  7b. hold the second-order kernels (rows 10-11, after rows 4-5 at the same
     point) against the plain R-operator at the inner step's shapes (24
     steps, 512 rows, input 256, 4 layers of 128, masks at rate 0.2; also
     masks off and one layer), float32 and bfloat16, rows 10 and 11 gated
     on their launches a call (row 10: a tangent forward recurrence and a
     gemm_nn a layer from one call; row 11: a tangent recurrence, 2 gemm_nn
     and 4 gemm_tn a layer); time them (both also
     by CUDA graph replay, by part and by the host's time to enqueue a
     call); probe whether
     cuDNN's LSTM takes a forward-mode derivative or a double backward;
  8. the FO meta-gradient of one micro-batch (2 tasks, 15 inner steps each,
     dropout on), kernel route (rows 4-8) against plain route, same
     generator seed; then the same for the SO meta-gradient (fhvp: rows
     4-7 and 10-11 against jvp of the plain loss's gradient);
  9. drive `cli meta-train` at MetaConfig() defaults (the full meta step:
     4 tasks x 90 inner steps, grad-accum 2, the fused inner update): 2
     epochs float32, 1 epoch bfloat16, `--resume` to epoch 3, then 1
     float32 epoch with `meta.fused_inner_update=false`, then `forecast`
     from the meta-trained `ckpt_best`; rows 4-8 must have launched (row 8
     360 times a fused meta step; rows 4 and 5 364 times, each a recurrence
     and a gemm_nn launch a layer, row 5 also two gemm_tn launches a layer;
     row 6 364 times, 2 gemm_nn launches a layer; no call
     on the plain stack),
     every loss must be finite;
  9b. drive `cli meta-train -o meta.second_order=true` at the defaults
     with inner epochs cut to SO_INNER_EPOCHS (1): 1 epoch float32, 1
     epoch bfloat16, `--resume` to epoch 2; rows 10-11 must launch once
     each an inner step, 60 times a meta step (with 4 / 4 and 4 / 8 / 16
     pieces a call) and rows 4-7 too, every loss finite;
  9c. `lstm_kernel=auto` at float32 hidden 448, where no cluster plan holds
     Wh (not even a 16-block one): one train step of the hybrid runs the
     plain stack (rows 4-5 never launch, the plain-route counter moves once;
     loss and gradients equal to `lstm_kernel=xla`'s), `pallas_stack` (rows
     4-5; under `_MERGED_GATES = False` rows 14-15) and `pallas` (rows
     18-19, once a layer) launch their kernels on streamed plans, every
     launch counted as streamed (each entry's counts set to 0 just before
     its step: rows 14-15 and 18-19's main-path launches on the kernels
     line), no plain route, loss and gradients within TOL of `xla`'s; the
     eval forward under `pallas_stack` launches row 2 once, streamed (its
     main-path launch), within TOL of `xla`'s; second order's fused inner
     gradient is the plain loss's (counted once); `cli meta-train -o
     model.lstm_hidden=320` (16-block clusters) trains 1 float32 epoch (its
     inner epochs cut to 1) with 64 launches of rows 4 and 5 and no plain
     route, and `-o model.lstm_hidden=448 -o model.lstm_kernel=pallas_stack`
     the same with 64 streamed launches of rows 4 and 5 (the streamed rows'
     main path) and finite losses;
  9d. every LSTM cluster recurrence on 16-block clusters (`wide_cluster_phase`)
     at float32 H 320 and 384 and bfloat16 H 512, at the inner step's
     shapes: rows 4-5 and 16-17 (V = 2; masks at 0.2 and off), rows 10-11,
     rows 18-19 (xp [24, 512, 4H]), rows 2 and 20 ([512, 24, 256] and
     [1536, 24, 256]; their plan `eval_plan`'s) against their plain versions,
     gated on their launches; each plan's cluster size and
     cudaOccupancyMaxActiveClusters; each row's time by CUDA events beside
     its plain version's, cuDNN's LSTM and its bound; then
     (`streamed_phase`) every LSTM row on streamed plans at float32 H 448,
     512 and 1024 and bfloat16 H 640 and 1024 at the same shapes (rows 4-5
     and 14-15 masks on and off, 18-19, 2 and 20 at [512, 24, 256]) against
     its plain version, gated on its launches and streamed launches, its
     device time by CUDA graph replay (5 replays) beside its plain
     version's, cuDNN's and its bound; and ROADMAP item 13: the eval
     forward at [1536 / 512, 24, 256], float32 H 320 and 384, on the
     cheapest streamed plan, the 16-block plan and the plain stack by
     events in turns (A B C C B A), `auto`'s route (`eval_plan`'s plan) no
     slower than the plain stack and within ITEM13_MARGIN of the fastest;
 10. drive `cli adapt` (Moscow float32 2 epochs, Thailand float32 and Moscow
     bfloat16 1 epoch) from that `ckpt_best`, `validate` the adapted
     Moscow model (with --no-plots, then at its defaults: where matplotlib
     is missing it must raise an ImportError naming --no-plots, where it is
     present both figures must be written; the phase prints which held)
     and `pipeline` Moscow + NewYork; rows 1-2 and 4-7 must
     have launched, every loss and val_mse must be finite; time one
     adaptation train step (batch 2, with a torch.profiler breakdown) and
     one adaptation epoch;
 11. time one inner step (fused and per-leaf update, with a torch.profiler
     breakdown of the fused one) and one meta step, with the meta step's
     peak device memory; the same for one SO inner step (the gradient and
     its Hessian-vector product) and one SO meta step of
     TIMED_INNER_EPOCHS (1) inner epoch;
 12. hold the node-sharded GCN sandwich kernels (rows 12-13) against their
     plain versions at full width (W = 24, N = 512, hid = 256, NL = 512,
     256, 128: the rows 1, 2 and 4 sp ranks hold), with and without a next
     layer and masks (rate 0.2), float32 and bfloat16; row 13 alone from
     g2, g1 and both at NL = 512 and 256, gated on its launches of the GEMM
     core; time each direction, the plain version (cuBLAS
     products, also the library yardstick), row 13 alone (events, CUDA
     graph replay, the host's time a call) and print the bound;
 13. on a 1 x 1 mesh (a NCCL group of one rank in this process): the
     node-sharded FO meta-gradient at dropout 0 against the unsharded kernel
     route (2 tasks x 15 inner steps); one sharded meta step at MetaConfig()
     defaults, the main path of rows 12-13 (4 x 364 launches of each; rows
     4-5 364, row 8 360, as unsharded); the sharded meta step timed against
     the unsharded one in turns (TIMED_INNER_EPOCHS inner epoch each), with a torch.profiler breakdown of one
     sharded inner step; `cli meta-train --mesh` (dp, world 1) for 1 epoch;
 14. two ranks on the one card, joined by gloo (which carries CUDA tensors;
     NCCL refuses two ranks on one card): `two_ranks` has
     torch.distributed.run start
     `cli meta-train --mesh --device cuda:0 -o mesh.spatial_devices=2`
     (one named card: gloo) for 1 float32 epoch, inner epochs cut to 1 of
     RANK_INNER_BATCHES (5) steps, as in every two-rank run;
     each rank must launch rows 12-13 on its 256 rows, both ranks must
     report the same finite losses, and one set of checkpoints must exist;
 15a. hold the pipelined GEMM core (csrc/gemm_nn.cu) against gemm_nn_plain
     at the products rows 3 and 15 give it (row 3's transform and
     aggregation at both shapes; row 15's gate product, two operand pairs
     at a row offset of 512, and its masked input product at [24, 512,
     256], 4 layers of 128), float32 and bfloat16, each at rtol = atol
     and at max|diff| / max|ref| within the dtype's tolerance;
 15. hold the LSTM kernel routes and the single GCN layer against their
     plain versions at full width, float32 and bfloat16, forward and every
     gradient: the per-layer recurrence (rows 18-19) at xp [24, 512, 512],
     wh [128, 512]; the eval stack's row 20 (row 2's schedule, counted on
     its own entry, each call gated on 4 gemm_nn and 4 recurrence
     launches) at [1536, 24, 256] and [512, 24, 256], 4 layers of 128, and
     its train-mode gradients (row 15's schedule) at [512, 24, 256]; one
     GCN layer (row 3) at [24, 512, 256] -> 256 and [72, 512, 24] -> 256;
     time each, its plain version and its library call (row 20 at both
     shapes by events, graph replay and enqueue beside cuDNN's LSTM by
     events and graph replay; row 3: torch.relu(a @ (h @ w) + b) in the
     same dtype, also as device time by CUDA graph replay; row 18 alone by
     events, graph replay and enqueue; row 19 alone against the plain
     recurrence and a float64 dwh, gated on one launch of the TN core
     a call, by events, graph replay, enqueue and
     part, beside cuBLAS on its dwh product alone; rows 18-19: no library
     call, no PyTorch call runs a recurrence alone);
 16. drive those routes through the CLI: `meta-train -o
     model.lstm_kernel=pallas` (1 epoch float32; rows 18 and 19 must launch
     1456 times a meta step, row 19's dwh on the TN core each time, rows 4-5
     never), the FO meta-gradient of one
     micro-batch on that route against the plain route, one inner step on
     it (timed, with a torch.profiler breakdown), `forecast` (float32
     and bfloat16, the Moscow forecast against `--device cpu`) and `validate
     --no-plots` with `-o model.use_pallas_lstm=true` (row 20 launches, row
     2 never), `forecast -o model.lstm_kernel=pallas` (4 launches of row 18
     a predict), `adapt -o model.use_pallas_lstm=true -o
     model.lstm_dropout=0` (1 epoch: row 20 in train mode, forward and
     backward on the card, row 4 never; the first half of its epoch timed
     beside the default route's in turns in this phase), and `forecast -o
     model.lstm_hidden=320` under `lstm_kernel=auto` (row 2) and under
     `use_pallas_lstm` (row 20: its streamed main-path launch), each on
     `eval_plan`'s streamed plan, and at `model.lstm_hidden=448` under both (no cluster holds
     Wh: the plain stack, counted, rows 2, 14 and 20 never), each against
     `--device cpu`; every loss must be finite;
 17. hold the unmerged-gates stack (rows 14-15: the forward's last h and
     residuals, the backward from the same residuals) and the task-batched
     stack (rows 16-17, V = 2 and 4, distinct weights a task; forward and
     every gradient) against their plain versions at the inner step's
     shapes (x [24, 512, 256], 4 layers of 128), masks at rate 0.2 and off,
     float32 and bfloat16, row 14 also without residuals (its eval forward)
     and gated on a gemm_nn and a forward recurrence launch a layer from one
     call; time each, its plain version and cuDNN's LSTM (row 14 by events,
     CUDA graph replay and the host's time to enqueue a call beside cuDNN's
     forward by events and graph replay; once a task for rows 16-17; row
     15 beside cuDNN's backward in the same dtype (by events and by CUDA
     graph replay), its device time by CUDA graph replay, and its time by
     part: gate products, recurrences, input products, the weight gradients'
     TN products and partial sums); rows 16-17 at V = 2 also alone, by events
     and by CUDA graph replay, row 16 also against its schedule on the plain
     pieces (all four outputs), by enqueue and by part, its recurrence plan
     printed, gated on its launches (a gemm_nn and a forward recurrence a
     layer for all tasks from one call), row 17 also
     by part and gated on its launches (a recurrence, a gemm_nn and two
     gemm_tn launches a layer for all tasks); rows 16-17 also at phase
     24's shapes (`tasks_at_path_shapes`): V = 2 tasks of 256 rows (a dp x
     sp rank's NL rows at sp 2) and V = 2 windows of 512 rows sharing one
     set of weights expanded with task stride 0 (the unfolded adaptation
     step), forward and every gradient against the plain version, masks at
     rate 0.2 and off, float32 and bfloat16, the recurrence plans printed;
     print the bounds;
 18. with ops.fused_lstm_stack._VBATCH set in process: the lockstep FO
     meta-gradient of one micro-batch (2 tasks x 15 inner steps, dropout
     on) kernel route vs plain route, same generator seed; `cli meta-train`
     at MetaConfig() defaults for 1 float32 epoch (rows 16 and 17 182
     launches each, row 16 with 4 gemm_nn and 4 forward recurrence launches
     each, row 17 with 4 recurrence, 4 gemm_nn and 8 gemm_tn launches each,
     row 9 180, rows 4-5 and 8 none);
     one lockstep inner step timed with a torch.profiler breakdown; the
     lockstep meta step against the serial one in turns (TIMED_INNER_EPOCHS
     inner epoch each, one untimed run of each first), with the peak
     device memory of each;
 19. with ops.fused_lstm_stack._MERGED_GATES = False: `cli meta-train` for 1
     float32 epoch (rows 14-15 364 launches each, the GEMM core 4 a row-14
     launch, 2 x 4 a row-15 launch and 2 x 4 a row-6 and a row-7 launch,
     its TN products 2 x 4 a row-15 launch, rows 4-5 none),
     `forecast`
     Moscow (row 14, never row 2; against the merged route's forecast), one
     inner step timed and profiled; both flags are restored afterwards;
 20. interop at ModelConfig(): a reference-schema .pt written from seeded
     weights (a torch.nn.LSTM's state dict: split biases, bias_hh nonzero;
     a meta form and an adapted form with Moscow's stats) is imported
     through `python -m weatherforecast_stgcn_maml_tpu_torch
     import-checkpoint`; `forecast` Moscow from it (rows 1-2 must launch)
     against `--device cpu`; one train step of the imported model, kernel
     route (rows 4-7, no plain stack) against the plain route with the same
     masks, every gradient (b_ih and b_hh too) within the float32 gate and
     each layer's two biases given the same gradient; that step under
     utils/profiling.trace_span, whose Chrome trace must hold gemm_nn and
     forward recurrence kernels; `adapt` Moscow 1 epoch from it (rows 4-7,
     no plain stack, finite losses); the adapted form imported with
     `--region Moscow` and `validate --no-plots` (rows 1-2); its
     `export-checkpoint` imported again, bitwise equal; `data-report` (12
     variable rows); `python -m ... info` (names the card);
 21. `pipeline --mesh-fleet --no-plots` over Moscow, NorthSiberia,
     Afghanistan (cold) and NewYork (temperate) at AdaptConfig(), 1 epoch,
     from the imported checkpoint: the log must say fleet-adapted and no
     fallback, every adapted checkpoint `fleet_mesh`, rows 4-7 R launches a
     fleet step, rows 16-17 none, every val_mse finite; at dropout 0 and
     200 windows the fleet against the serial pipeline and, with _VBATCH
     set, the fleet on rows 16-17 (once a zone's fleet step each way, rows
     4-5 never; the forward plans printed) against the default fleet, 1e-5
     relative; one fleet epoch of the three cold regions against their
     three serial epochs in turns (one untimed run of each first), with peak
     device memory, and rows 16-17
     at the fleet's shape against three calls of rows 4-5.
 22. second order and _VBATCH on meshes, at ModelConfig() float32: on a 1 x 1
     dp mesh and a 1 x 1 dp x sp mesh (a NCCL group of one rank), the SO
     fhvp meta-gradient of 2 tasks x 15 inner steps at dropout 0 against
     the unsharded one (max|diff| / max|ref| <= 1e-4; rows 10-11 once each
     an inner step; on dp x sp rows 12-13 once a layer a forward, rows 4-5
     in the inner gradient's forward, the GCN stack never); one SO inner
     step on the dp x sp mesh against the unsharded one in turns, each with
     its device-busy share; `cli meta-train --mesh -o
     meta.second_order=true` 1 epoch of SO_INNER_EPOCHS inner epochs (rows
     10-11 60 times each, finite losses); with _VBATCH set, the lockstep dp-mesh meta-gradient against
     the serial one with dropout on and the same key (1e-5; rows 16-17 16
     times, row 9 15) and `cli meta-train --mesh` 1 epoch (rows 16-17 182
     each, row 9 180, rows 4-5 and 8 none), the flag restored; two gloo
     ranks on the card (phase 14's launcher) with `-o meta.second_order=true
     -o meta.inner_epochs=1`: each rank launches rows 10-11 on its 256 rows
     20 times, both report the same finite losses.
 23. the GSPMD dp x sp step and chained meta epochs, at ModelConfig()
     float32: on a 1 x 1 dp x sp mesh (a NCCL group of one rank) the GSPMD
     meta-gradient of 2 tasks x 15 inner steps at dropout 0.2 against the
     dp mesh's on the same key on the plain routes (max|diff| / max|ref| <=
     1e-5), for stgcn first order, stgcn second order (fhvp) and the hybrid
     under a forced gspmd, each with no launch of rows 4-13; two gloo
     ranks on the card (phase 14's launcher) with `-o model.family=stgcn -o
     meta.inner_epochs=1`: the log names the GSPMD step, both ranks report
     the same finite losses; `cli meta-train -o meta.epochs_per_dispatch=2
     -o meta.num_epochs=3` (chunks of 2 + 1; CLI_INNER_EPOCHS = 1 inner
     epoch) against the same run epoch by
     epoch fed its task indices: losses and final parameters within 1e-6
     relative (bitwise equality printed), rows 4-8 3 x an epoch's
     launches, one metrics fetch a chunk, each run's seconds an epoch
     printed; second order, 2 epochs in one chunk (1 inner epoch): rows
     10-11 once an inner step, one fetch; the two ranks again for 3 epochs
     in chunks of 2.
 24. the wavefront LSTM, the adaptation step's unfolded window batch and
     _VBATCH on the dp x sp shardmap step, at ModelConfig() float32
     (`wavefront_vbatch_phase`): (a) the FO meta-gradient of 2 tasks x 15
     inner steps at dropout 0.2 with `model.lstm_wavefront` against
     `lstm_kernel=xla` on the same masks (max|diff| / max|ref| <= 1e-5; one
     wavefront a forward, no launch of rows 4-5 or 14-20), timed in turns;
     the SO meta-gradient of 1 task (hvp, rof) with `meta.so_wavefront`
     against the layerwise Hessian transposes on the same key (1e-4; one
     wavefront an inner step); `cli meta-train -o model.lstm_wavefront=true`
     1 epoch of 1 inner epoch (finite losses, no LSTM kernel launch); a Moscow forecast from
     its checkpoint on the card against --device cpu (phase 4's gate); (b)
     the adaptation step at AdaptConfig() (2 windows x 512 rows, Moscow's
     data) under _VBATCH with _ROWFOLD off against the folded step on the
     same masks (loss and every gradient 1e-5; rows 16-17 once each, rows
     4-5 never), one train step of each timed in turns, `cli adapt` 1 epoch
     (finite val_mse, rows 16-17's launches printed), the flags restored;
     (c) on a 1 x 1 dp x sp NCCL mesh the lockstep shardmap meta-gradient
     against the serial one, dropout 0.2, the same key (1e-5; rows 16-17
     16 times each, row 9 15, rows 12-13 128, rows 4-5 and 8 none), timed
     in turns; two gloo ranks on the card (phase 14's launcher, `--vbatch`,
     1 inner epoch): each rank launches rows 16-17 12 times and row 9 10
     times on its 256 rows, both report the same finite losses.

The last three lines of stdout are the kernels JSON, the card line as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints it,
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

TOL = {"float32": 1e-5, "bfloat16": 5e-2}  # rtol = atol; gradients: max|diff| / max|ref|
REPEATS = 10
REGIONS = ("Moscow", "NewYork", "Thailand")
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM bfloat16 on the tensor cores, dense
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
TPU_KERNELS = {
    "fused_gcn_stack": "weatherforecast_stgcn_maml_tpu/ops/fused_gcn.py:148",
    "lstm_stack_last_all": "weatherforecast_stgcn_maml_tpu/ops/fused_lstm_stack.py:940",
    "lstm_stack_train": "weatherforecast_stgcn_maml_tpu/ops/fused_lstm_stack.py:618",
    "lstm_stack_train.backward": "weatherforecast_stgcn_maml_tpu/ops/fused_lstm_stack.py:725",
    "gcn_stack_train": "weatherforecast_stgcn_maml_tpu/ops/fused_gcn_train.py:79",
    "gcn_stack_train.backward": "weatherforecast_stgcn_maml_tpu/ops/fused_gcn_train.py:123",
    "clip_sgd_update": "weatherforecast_stgcn_maml_tpu/ops/fused_sgd.py:69",
    "clip_sgd_update.batched": "weatherforecast_stgcn_maml_tpu/ops/fused_sgd.py:112",
    "hvp_stack_fwd": "weatherforecast_stgcn_maml_tpu/ops/fused_lstm_hvp.py:216",
    "hvp_stack_bwd": "weatherforecast_stgcn_maml_tpu/ops/fused_lstm_hvp.py:395",
    "gcn_shard_layer": "weatherforecast_stgcn_maml_tpu/ops/fused_gcn_shard.py:153",
    "gcn_shard_layer.backward": "weatherforecast_stgcn_maml_tpu/ops/fused_gcn_shard.py:179",
    "lstm_recurrence": "weatherforecast_stgcn_maml_tpu/ops/lstm_scan.py:122",
    "lstm_recurrence.backward": "weatherforecast_stgcn_maml_tpu/ops/lstm_scan.py:148",
    "fused_lstm_last_hidden": "weatherforecast_stgcn_maml_tpu/ops/fused_lstm.py:63",
    "fused_gcn_layer": "weatherforecast_stgcn_maml_tpu/ops/fused_gcn.py:37",
    "lstm_stack_split": "weatherforecast_stgcn_maml_tpu/ops/fused_lstm_stack.py:191",
    "lstm_stack_split.backward": "weatherforecast_stgcn_maml_tpu/ops/fused_lstm_stack.py:251",
    "lstm_stack_train_tasks": "weatherforecast_stgcn_maml_tpu/ops/fused_lstm_stack.py:1180",
    "lstm_stack_train_tasks.backward":
        "weatherforecast_stgcn_maml_tpu/ops/fused_lstm_stack.py:1232",
}
# The LSTM rows on streamed plans (past every cluster that holds Wh; the
# streamed phase, 9d): each the STREAM variant of its row's recurrence,
# named after the row.
STREAMED_KERNELS = {
    "lstm_stack_last_all.streamed": "lstm_stack_last_all",
    "lstm_stack_train.streamed": "lstm_stack_train",
    "lstm_stack_train.backward.streamed": "lstm_stack_train.backward",
    "lstm_stack_split.streamed": "lstm_stack_split",
    "lstm_stack_split.backward.streamed": "lstm_stack_split.backward",
    "lstm_recurrence.streamed": "lstm_recurrence",
    "lstm_recurrence.backward.streamed": "lstm_recurrence.backward",
    "fused_lstm_last_hidden.streamed": "fused_lstm_last_hidden",
}
TPU_KERNELS.update({k: TPU_KERNELS[v] for k, v in STREAMED_KERNELS.items()})
STREAMED_AT = "float32 H 448"  # the kernels line's numbers of a streamed row; the rest: "widths"
# The main path whose launches the kernels line gives for a streamed row,
# each entry's counts set to 0 just before it and read just after.
STREAMED_MAIN_PATHS = {
    "lstm_stack_last_all.streamed": "phase 9c: apply_model eval, float32 H 448, "
                                    "lstm_kernel=pallas_stack",
    "lstm_stack_train.streamed": "phase 9c: cli meta-train, float32 H 448, "
                                 "lstm_kernel=pallas_stack, 1 epoch of 1 inner epoch",
    "lstm_stack_split.streamed": "phase 9c: a train step, float32 H 448, "
                                 "lstm_kernel=pallas_stack, _MERGED_GATES=False",
    "lstm_recurrence.streamed": "phase 9c: a train step, float32 H 448, lstm_kernel=pallas",
    "fused_lstm_last_hidden.streamed": "phase 16: cli forecast Moscow, float32 H 320, "
                                       "use_pallas_lstm (eval_plan streams there)",
}
for _name in ("lstm_stack_train", "lstm_stack_split", "lstm_recurrence"):
    STREAMED_MAIN_PATHS[_name + ".backward.streamed"] = STREAMED_MAIN_PATHS[_name + ".streamed"]
CSRC = "weatherforecast_stgcn_maml_tpu_torch/ops/csrc/"
# The kernel's sources, its main one first (the kernels line's "source").
SOURCES = {
    "fused_gcn_stack": [CSRC + "gemm_nn.cu"],
    "lstm_stack_last_all": [CSRC + "lstm_stack_fwd.cu", CSRC + "lstm_scan_fwd.cuh",
                            CSRC + "gemm_nn.cu"],
    "lstm_stack_train": [CSRC + "lstm_stack_fwd.cu", CSRC + "lstm_scan_fwd.cuh",
                         CSRC + "gemm_nn.cu"],
    "lstm_stack_train.backward": [CSRC + "lstm_scan_bwd.cuh", CSRC + "fused_lstm_split.cu",
                                  CSRC + "gemm_nn.cu", CSRC + "gemm.cu"],
    "gcn_stack_train": [CSRC + "gemm_nn.cu"],
    "gcn_stack_train.backward": [CSRC + "gemm_nn.cu", CSRC + "fused_gcn_train.cu",
                                 CSRC + "gemm.cu"],
    "clip_sgd_update": [CSRC + "fused_sgd.cu"],
    "clip_sgd_update.batched": [CSRC + "fused_sgd.cu"],
    "hvp_stack_fwd": [CSRC + "lstm_scan_fwd_tan.cu", CSRC + "lstm_scan_fwd.cuh",
                      CSRC + "gemm_nn.cu"],
    "hvp_stack_bwd": [CSRC + "lstm_scan_tan.cu", CSRC + "lstm_scan_bwd.cuh",
                      CSRC + "gemm_nn.cu", CSRC + "gemm.cu"],
    "gcn_shard_layer": [CSRC + "gemm_nn.cu"],
    "gcn_shard_layer.backward": [CSRC + "gemm_nn.cu", CSRC + "fused_gcn_train.cu",
                                 CSRC + "gemm.cu"],
    "lstm_recurrence": [CSRC + "lstm_stack_fwd.cu", CSRC + "lstm_scan_fwd.cuh"],
    "lstm_recurrence.backward": [CSRC + "lstm_scan.cu", CSRC + "lstm_scan_bwd.cuh",
                                 CSRC + "gemm_nn.cu", CSRC + "gemm.cu"],
    "fused_lstm_last_hidden": [CSRC + "lstm_stack_fwd.cu", CSRC + "lstm_scan_fwd.cuh",
                               CSRC + "gemm_nn.cu"],
    "fused_gcn_layer": [CSRC + "gemm_nn.cu", CSRC + "fused_gcn_train.cu", CSRC + "gemm.cu"],
    "lstm_stack_split": [CSRC + "lstm_stack_fwd.cu", CSRC + "lstm_scan_fwd.cuh",
                         CSRC + "gemm_nn.cu"],
    "lstm_stack_split.backward": [CSRC + "gemm_nn.cu", CSRC + "lstm_scan_bwd.cuh",
                                  CSRC + "fused_lstm_split.cu", CSRC + "gemm.cu"],
    "lstm_stack_train_tasks": [CSRC + "lstm_stack_fwd.cu", CSRC + "lstm_scan_fwd.cuh",
                               CSRC + "gemm_nn.cu"],
    "lstm_stack_train_tasks.backward": [CSRC + "lstm_scan_bwd.cuh", CSRC + "fused_lstm_split.cu",
                                        CSRC + "gemm_nn.cu", CSRC + "gemm.cu"],
}
# A streamed row's sources: its recurrence's header first, then its row's.
SOURCES.update({k: [CSRC + ("lstm_scan_bwd.cuh" if "backward" in k else "lstm_scan_fwd.cuh"),
                    *(f for f in SOURCES[v] if not f.endswith(("fwd.cuh", "bwd.cuh")))]
                for k, v in STREAMED_KERNELS.items()})
# Kernels whose ptxas report the build phase prints by name.
NEW_KERNELS = ("gemm_nn_f32_kernel", "gemm_nn_bf16_kernel", "gemm_tn_f32_kernel",
               "gemm_tn_bf16_kernel", "dz_top_kernel", "transpose_round_kernel",
               "lstm_scan_bwd_kernel", "lstm_scan_fwd_kernel", "lstm_scan_tan_kernel",
               "lstm_scan_fwd_tan_kernel", "round_pad_kernel", "sumsq4_kernel",
               "update4_kernel")
# The cluster recurrences whose instances the build phase lists by source.
RECURRENCE_SOURCES = {"lstm_scan_fwd_kernel": "lstm_stack_fwd.cu",
                      "lstm_scan_tan_kernel": "lstm_scan_tan.cu",
                      "lstm_scan_fwd_tan_kernel": "lstm_scan_fwd_tan.cu"}
MESH_INNER_EPOCHS = 1  # phase 14's cut: 1 inner epoch a task
# The two-rank runs' cut (`two_ranks`: phases 14, 22, 23 and 24): 5 inner
# steps an inner epoch, not 15.
RANK_INNER_BATCHES = 5
# Phase 23's chained meta-train runs and phase 24's wavefront meta-train:
# 1 inner epoch, not 6.
CLI_INNER_EPOCHS = 1
# The meta steps timed in turns in phases 13 and 18 and the SO meta step
# timed in phase 11: 1 inner epoch, not 6.
TIMED_INNER_EPOCHS = 1
SO_INNER_EPOCHS = 1  # the SO meta-train runs' cut (phases 9b and 22): 1 x 15 inner steps a task
HVP_TOL = {"float32": 1e-4, "bfloat16": 5e-2}  # tangents: max|diff| / max|ref|


def log(*args):
    print(*args, flush=True)


def cuda_ms(torch, fn, repeats=REPEATS):
    """Median device time of fn() in ms over `repeats` runs (CUDA events)."""
    fn()
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(torch, fn, repeats=REPEATS):
    """Median wall time of fn() in ms, each run ending in a synchronize."""
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def host_turns_ms(torch, dev, fns: dict, pair: tuple):
    """Two routes' wall times in ms in turns (A B B A), each route run once
    untimed first; returns ({route: [ms, ms]}, {route: peak device memory
    in GiB over its timed runs})."""
    for fn in fns.values():
        fn()
    times, peak = {k: [] for k in pair}, {}
    for name in (*pair, *pair[::-1]):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        fns[name]()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        peak[name] = max(peak.get(name, 0.0), torch.cuda.max_memory_allocated(dev) / 2**30)
    return times, peak


def enqueue_ms(torch, fn, repeats=REPEATS):
    """Median host time of one call of fn() in ms, from its start to its
    return (the card idle before it, no synchronize inside): the host's
    work to prepare and enqueue the call's launches."""
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound_ms(n_bytes, flops, dtype="float32"):
    """The least time the card could take: bytes over the memory rate or
    operations over the card's peak rate for `dtype` ("float32": outside
    the tensor cores; "bfloat16": the tensor cores' dense rate), whichever
    is larger."""
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== phase: {self.name}")

    def __exit__(self, *exc):
        log(f"== phase {self.name}: {time.perf_counter() - self.t0:.1f} s")


def profile_kernels(torch, fn, steps):
    """(rows, wall us, host rows) over `steps` calls of fn() under
    torch.profiler: one row (device us, launches, kernel name) per kernel,
    one (self host us, calls, op name) per host-side op."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows, host = [], []  # device rows: an op's own row repeats its kernels' time
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if str(ev.device_type).endswith("CUDA") and dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
        elif ev.self_cpu_time_total > 0:
            host.append((ev.self_cpu_time_total, ev.count, ev.key))
    return rows, wall_us, host


def device_ms(torch, fn, repeats=REPEATS):
    """The device time of fn() in ms: the sum of its kernels' times
    (torch.profiler), averaged over `repeats` calls. Unlike CUDA events it
    leaves out the device's idle time while the host prepares launches."""
    rows, _, _ = profile_kernels(torch, fn, repeats)
    if not rows:
        raise RuntimeError("the profiler reported no device time")
    return sum(r[0] for r in rows) / repeats / 1e3


def graph_ms(torch, fn, repeats=REPEATS):
    """The device time of fn() in ms without the host's launch work: fn
    captured once in a CUDA graph, its replays timed by CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    ms = cuda_ms(torch, graph.replay, repeats)
    del graph
    return ms


def cudnn_backward_device_ms(torch, out, x, lstm, ct):
    """cuDNN's LSTM backward (the gradient of `out` for x and the weights)
    by CUDA graph replay, a second capture where the first refuses, else
    None (logged; its first captures in a process have refused in float32
    on an H100): a yardstick only."""
    for attempt in (1, 2):
        try:
            return graph_ms(torch, lambda: torch.autograd.grad(
                out, [x, *lstm.parameters()], ct, retain_graph=True))
        except RuntimeError as err:
            log(f"cuDNN's LSTM backward in a CUDA graph refused (capture {attempt}): "
                f"{str(err).splitlines()[0]}")
    return None


def profile_steps(torch, step, what, card, steps=5, host_rows=0):
    """Device time by kernel over `steps` calls of step() (torch.profiler),
    the device's busy share of the wall time, and the `host_rows` host ops
    that took the most host time of their own."""
    rows, wall_us, host = profile_kernels(torch, step, steps)
    busy = sum(r[0] for r in rows)
    if not rows:
        log("profile: the profiler reported no device time")
        return
    log(f"profile of {steps} {what}: wall {wall_us / steps / 1e3:.3f} ms a step, "
        f"device busy {busy / steps / 1e3:.3f} ms a step ({100 * busy / wall_us:.1f}%)  [{card}]")
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        log(f"  {dev_us / steps / 1e3:8.4f} ms a step  {count // steps:4d} launches  "
            f"{100 * dev_us / busy:5.1f}%  {key[:90]}")
    if host_rows:
        log(f"  host: {sum(h[0] for h in host) / steps / 1e3:.3f} ms a step of ops' own time; "
            f"the {host_rows} largest:")
    for cpu_us, count, key in sorted(host, reverse=True)[:host_rows]:
        log(f"  {cpu_us / steps / 1e3:8.4f} ms a step  {count / steps:6.1f} calls  (host)  "
            f"{key[:80]}")


def rel_err(got, ref):
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


def cublas_row7(torch, g, x, a_hat, weights, masks, h_all, keep):
    """Row 7's function in float32 on torch.matmul (its library route): the
    relu / dropout gradient, A_hat^T dz per slice, dW = h_in^T dhw, db, dh =
    dhw W^T (as tools/gcn_rows.py times it)."""
    dh, out = g, []
    for l in reversed(range(len(weights))):
        dz = dh * (h_all[l] > 0)
        if masks is not None and l < masks.shape[0]:
            dz = dz * (masks[l] * (1.0 / keep))
        dhw = torch.matmul(a_hat.t(), dz)
        inp = x if l == 0 else h_all[l - 1]
        out.append(inp.reshape(-1, inp.shape[-1]).t() @ dhw.reshape(-1, dhw.shape[-1]))
        out.append(dz.sum(dim=(0, 1)))
        dh = torch.matmul(dhw, weights[l].t())
    return dh, out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from weatherforecast_stgcn_maml_tpu_torch import cli, native
    from weatherforecast_stgcn_maml_tpu_torch.config import (
        ADAPTATION_REGIONS,
        META_TRAIN_REGIONS,
        AdaptConfig,
        DataConfig,
        ExperimentConfig,
        MetaConfig,
        ModelConfig,
        to_dict,
    )
    from weatherforecast_stgcn_maml_tpu_torch.data.preprocess import pad_nodes, prepare_features
    from weatherforecast_stgcn_maml_tpu_torch.data.synthetic import synthetic_region_for_box
    from weatherforecast_stgcn_maml_tpu_torch.data.windows import (
        WindowSpec,
        contiguous_split,
        gather_batch,
    )
    from weatherforecast_stgcn_maml_tpu_torch.engines.adapt import adapted_ckpt_path
    from weatherforecast_stgcn_maml_tpu_torch.engines.data_source import get_region_data
    from weatherforecast_stgcn_maml_tpu_torch.graph import build_region_graph
    from weatherforecast_stgcn_maml_tpu_torch.models.common import draw_mask
    from weatherforecast_stgcn_maml_tpu_torch.models.gcn import apply_gcn_layer
    from weatherforecast_stgcn_maml_tpu_torch.models.losses import masked_mse
    from weatherforecast_stgcn_maml_tpu_torch.models.hybrid import apply_hybrid_tasks
    from weatherforecast_stgcn_maml_tpu_torch.models.registry import (
        apply_model,
        draw_masks,
        init_model,
        load_params,
    )
    from weatherforecast_stgcn_maml_tpu_torch.ops import cuda_build
    from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn import (
        fused_gcn_layer,
        fused_gcn_stack,
        gcn_stack_plain,
    )
    from weatherforecast_stgcn_maml_tpu_torch.ops import fused_gcn_train as fgt
    from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn_train import (
        gcn_stack_train,
        gcn_stack_train_plain,
    )
    from weatherforecast_stgcn_maml_tpu_torch.ops import fused_gcn_shard as fgs
    from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_hvp as fh
    from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack as fls
    from weatherforecast_stgcn_maml_tpu_torch.ops import lstm_scan
    from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm_stack import (
        lstm_stack_last_all,
        lstm_stack_plain,
        lstm_stack_train,
    )
    from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm import fused_lstm_last_hidden
    from weatherforecast_stgcn_maml_tpu_torch.ops.gemm import (
        gemm_nn,
        gemm_nn_plain,
        gemm_tn,
        gemm_tn_plain,
        sum_splits,
        tn_splits,
    )
    from weatherforecast_stgcn_maml_tpu_torch.ops.lstm_scan import (
        lstm_recurrence,
        lstm_recurrence_plain,
    )
    from weatherforecast_stgcn_maml_tpu_torch.ops.fused_sgd import (
        clip_sgd_update,
        clip_sgd_update_plain,
    )
    from weatherforecast_stgcn_maml_tpu_torch.parallel import distributed
    from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import (
        all_reduce_tensors,
        make_mesh_2d,
        shard_task_batch_2d,
    )
    from weatherforecast_stgcn_maml_tpu_torch.parallel.fleet_mesh import (
        make_fleet_epoch_runner,
        stack_fleet,
    )
    from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_dp import make_parallel_batch_grad
    from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_sp import (
        local_route,
        make_shardmap_batch_grad,
        make_shardmap_meta_step_2d,
    )
    from weatherforecast_stgcn_maml_tpu_torch.parallel.spatial import (
        hybrid_local_forward,
        psum_masked_mse,
    )
    from weatherforecast_stgcn_maml_tpu_torch.engines import meta_train as mt_engine
    from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_gspmd import (
        make_gspmd_batch_grad,
        pinned_configs,
    )
    from weatherforecast_stgcn_maml_tpu_torch.train import maml as maml_mod
    from weatherforecast_stgcn_maml_tpu_torch.train.maml import (
        init_meta_state,
        inner_sgd_update,
        inner_sgd_update_tasks,
        make_meta_step,
        param_grads,
        task_batch_grad,
    )
    from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import (
        adaptation_optimizer,
        clip_global_norm_tree,
        leaf_order,
    )
    from weatherforecast_stgcn_maml_tpu_torch.train.so_fused import (
        make_grad_loss_fused,
        plain_route,
        support_loss,
    )
    from weatherforecast_stgcn_maml_tpu_torch.train.so_grad import make_so_grad
    from weatherforecast_stgcn_maml_tpu_torch.train.supervised import (
        SupervisedState,
        make_epoch_runner,
        make_predict,
        make_train_step,
    )
    from weatherforecast_stgcn_maml_tpu_torch.train.tasks import (
        build_meta_tasks,
        stage_tasks,
        task_at,
    )
    from weatherforecast_stgcn_maml_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        load_meta,
        save_checkpoint,
    )
    from weatherforecast_stgcn_maml_tpu_torch.utils.profiling import trace_span
    from weatherforecast_stgcn_maml_tpu_torch.utils.torch_import import import_torch_checkpoint

    # 1. The card.
    major, minor = torch.cuda.get_device_capability(0)
    if major != 9:
        raise RuntimeError(f"the kernels target sm_90a; this card is sm_{major}{minor}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on: the float32 plain route would not be float32")
    torch.backends.cudnn.allow_tf32 = False  # the cuDNN LSTM yardstick in float32
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 2. Build.
    with Phase("build"):
        t0 = time.perf_counter()
        if not native.build():  # the host pipeline: g++, one source
            raise RuntimeError("no C++ compiler: the native host pipeline did not build")
        log(f"native host pipeline {native._lib._name}: {time.perf_counter() - t0:.2f} s"
            + (f"; g++: {native.build_log.strip()}" if native.build_log.strip() else ""))
        cuda_build.load()
        if cuda_build.build_seconds is None:
            log("kernels loaded from an earlier build of the same sources")
        else:
            log(f"nvcc (one process per source, in parallel) {cuda_build.build_seconds:.1f} s")
        entry = ""
        recurrence = []  # (kernel, source, template arguments, registers)
        spills = []  # (entry, ptxas line) of every recurrence instance that spills
        for line in cuda_build.build_log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            # The kernels rows 1, 3, 5-7, 15, 17 and 19 run on, by name:
            # registers, stack frame and spills; the recurrence's instances
            # a source (dtypes, units a lane, rows a cluster, +db: with the
            # bias partials) one line a source below.
            new = next((entry[entry.index(k):][:48] for k in NEW_KERNELS if k in entry), None)
            kernel = next((k for k in RECURRENCE_SOURCES if new and new.startswith(k)), None)
            if kernel:
                # <TW, UPT, RB> (the forward recurrence: <TW, UPT, RB, STREAM>),
                # mangled as e.g. I13__nv_bfloat16Li4ELi8E(Lb1E).
                if "registers" in line:
                    tw, upt, rb, streamed = re.match(r"I(.*?)Li(\d+)ELi(\d+)E(?:Lb(\d)E)?", entry[
                        entry.index(kernel) + len(kernel):]).groups()
                    regs = line.split("Used")[1].split("registers")[0].strip()
                    recurrence.append((kernel, RECURRENCE_SOURCES[kernel],
                                       f"{'bf16' if 'bfloat16' in tw else 'f32'} {upt} {rb}"
                                       + " +stream" * (streamed == "1"), regs))
                elif "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line:
                    log(f"  ptxas {kernel} SPILLS: {line.strip()} in {entry}")
                    spills.append((entry, line.strip()))
            elif new and new.startswith("lstm_scan_bwd_kernel"):
                if "registers" in line:
                    # <TW, TC, UPT, RB, DB, STREAM>, mangled as e.g.
                    # I13__nv_bfloat16S2_Li4ELi8ELb1ELb0E (DB: "+db", STREAM: "+stream").
                    tw_tc, upt, rb, db, streamed = re.match(
                        r"I(.*?)Li(\d+)ELi(\d+)ELb(\d)ELb(\d)", entry[
                            entry.index("lstm_scan_bwd_kernel") + 20:]).groups()
                    tw_tc = tw_tc.replace("13__nv_bfloat16", "b").replace("S2_", "b")
                    args = "/".join({"f": "f32", "b": "bf16"}[c] for c in tw_tc)
                    source = "fused_lstm_split.cu" if "fused_lstm_split" in entry else "lstm_scan.cu"
                    regs = line.split("Used")[1].split("registers")[0].strip()
                    recurrence.append(("lstm_scan_bwd_kernel", source,
                                       f"{args} {upt} {rb}{' +db' * (db == '1')}"
                                       + " +stream" * (streamed == "1"), regs))
                elif "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line:
                    log(f"  ptxas lstm_scan_bwd_kernel SPILLS: {line.strip()} in {entry}")
                    spills.append((entry, line.strip()))
            elif new and ("registers" in line or "spill" in line):
                log(f"  ptxas {new}: {line.split(':', 1)[-1].strip()}")
                if (new.startswith(("sumsq4_kernel", "update4_kernel")) and "spill" in line
                        and " 0 bytes spill stores, 0 bytes spill loads" not in line):
                    spills.append((entry, line.strip()))
            elif "registers" in line:
                log(f"  ptxas: {line.strip()}")
            elif "spill" in line and " 0 bytes spill" not in line:
                log(f"  ptxas: {line.strip()} in {entry}")
        for kernel, source in sorted({r[:2] for r in recurrence}):
            log(f"  ptxas {kernel} in {source} (weights / c_all dtype, units a lane, rows a "
                f"cluster, +db with the bias partials: registers; no spill unless named "
                f"above): " + ", ".join(f"{args}: {regs}" for k, src, args, regs in recurrence
                                        if (k, src) == (kernel, source)))
        # The forward recurrence's 32-row tile (validate's rows, float32):
        # built at 1 and 2 units a lane in float32, 1 in bfloat16, none
        # spilling.
        wide = [r for r in recurrence if r[0] == "lstm_scan_fwd_kernel" and
                r[2].endswith(" 32")]
        if sorted(r[2] for r in wide if r[1] == "lstm_stack_fwd.cu") != [
                "bf16 1 32", "f32 1 32", "f32 2 32"]:
            raise RuntimeError(f"the forward recurrence's 32-row instances: {wide}")
        if any(re.search(r"lstm_scan_fwd_kernelI.*?Li\d+ELi32E", e) for e, _ in spills):
            raise RuntimeError(f"a 32-row forward recurrence spills: {spills}")
        # The streamed recurrences (past the clusters that hold Wh): the
        # forward at row tiles of 8 and 16, the backward at 2-16 with the
        # bias partials (rows 5 and 15) and without (row 19), every weight
        # column count and dtype but 16 rows at 128 bfloat16 columns (the
        # resident instance there spills, as it did before streaming); none
        # may spill.
        streamed = {src: sorted(r[2] for r in recurrence if r[1] == src and "+stream" in r[2])
                    for src in ("lstm_stack_fwd.cu", "fused_lstm_split.cu", "lstm_scan.cu")}
        log("  streamed recurrence instances: " + json.dumps({k: len(v)
                                                               for k, v in streamed.items()}))
        if [len(v) for v in streamed.values()] != [11, 23, 23]:
            raise RuntimeError(f"the streamed recurrences' instances: {streamed}")
        def streamed_entry(e):  # a STREAM = true instance (the template's last bool)
            m = (re.search(r"lstm_scan_fwd_kernelI.*?Li\d+ELi\d+ELb(\d)E", e)
                 or re.search(r"lstm_scan_bwd_kernelI.*?Li\d+ELi\d+ELb\dELb(\d)E", e))
            return bool(m) and m.group(1) == "1"

        if any(streamed_entry(e) for e, _ in spills):
            raise RuntimeError(f"a streamed recurrence spills: {spills}")
        # Row 8's update holds its chunk's g and p in registers while it
        # waits for the norm: a spill would put them in memory.
        if any("sumsq4_kernel" in e or "update4_kernel" in e for e, _ in spills):
            raise RuntimeError(f"a clip + SGD kernel spills: {spills}")
        # Their shared memory is dynamic (ptxas reports static memory only).
        lib = cuda_build.load()
        # The retired kernels: gemm.cu's SIMT GEMM (row 20's projections were
        # its last caller) and rows 2 and 20's one-chain kernels. No path can
        # launch what the library does not export.
        for name in ("wf_gemm", "wf_lstm_stack_last", "wf_fused_lstm_last"):
            if hasattr(lib, name):
                raise RuntimeError(f"the library still exports {name}")
        for name in ("fused_lstm_stack.cu", "fused_lstm.cu", "lstm_recurrence.cuh"):
            if os.path.exists(os.path.join(os.path.dirname(os.path.abspath(__file__)), CSRC,
                                           name)):
                raise RuntimeError(f"the retired source {name} is still in the tree")
        log("  no wf_gemm, wf_lstm_stack_last or wf_fused_lstm_last exported; their sources "
            "are gone")
        log(f"  dynamic shared memory a block: gemm_nn float32 {lib.wf_gemm_nn_smem(0)} B, "
            f"bfloat16 {lib.wf_gemm_nn_smem(1)} B")
        # The backward recurrence (rows 5, 15, 17, 19): its cluster plan at
        # the main path's rows (512; adaptation 1024, a sharded rank 256, row
        # 17's two tasks of 512) and at the gate's (48 rows, H 64 / 128 /
        # 256), the shared memory a block takes and how many of its clusters
        # the card runs at once.
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for dt in (torch.float32, torch.bfloat16):
            for hidden, rows, nv in ((128, 512, 1), (128, 1024, 1), (128, 256, 1),
                                     (128, 512, 2), (64, 48, 1), (128, 48, 1), (256, 48, 1)):
                cs, hcp, rb, _ = fls.recurrence_plan(hidden, rows, dt.itemsize, sms, nv)
                code = cuda_build.dtype_code(dt)
                smem = lib.wf_lstm_stack_recurrence_smem(code, hcp, rb, hidden)
                if smem != fls.scan_smem(hidden, hcp, rb, dt.itemsize):
                    raise RuntimeError(f"recurrence shared memory: C {smem} B, Python "
                                       f"{fls.scan_smem(hidden, hcp, rb, dt.itemsize)} B")
                active = lib.wf_lstm_stack_recurrence_clusters(code, cs, hcp, rb, hidden)
                if active <= 0:
                    raise RuntimeError(f"the card runs no cluster of the recurrence plan "
                                       f"{(cs, hcp, rb)} at H = {hidden} ({active})")
                clusters = nv * -(-rows // rb)
                log(f"  lstm_scan_bwd {str(dt)[6:]} H = {hidden}, {nv} x R = {rows}: cluster of "
                    f"{cs}, "
                    f"{hcp} weight columns and {rb} rows a cluster, {smem} B a block; "
                    f"{clusters} clusters ({clusters * cs} blocks), at most {active} at once "
                    f"(cudaOccupancyMaxActiveClusters)")
        # The forward recurrence (rows 4, 14, 16 and 18): its plan at the
        # main path's rows (512; adaptation 1024, a sharded rank 256,
        # validate's 1536, row 16's two tasks of 512) and at the gate's.
        for dt in (torch.float32, torch.bfloat16):
            for hidden, rows, nv in ((128, 512, 1), (128, 1024, 1), (128, 256, 1), (128, 1536, 1),
                                     (128, 512, 2), (64, 48, 1), (128, 48, 1), (256, 48, 1)):
                cs, hcp, rb, _ = fls.forward_plan(hidden, rows, dt.itemsize, sms, nv)
                code = cuda_build.dtype_code(dt)
                smem = lib.wf_lstm_stack_forward_smem(code, hcp, rb, hidden)
                if smem != fls.scan_fwd_smem(hidden, hcp, rb, dt.itemsize):
                    raise RuntimeError(f"forward recurrence shared memory: C {smem} B, Python "
                                       f"{fls.scan_fwd_smem(hidden, hcp, rb, dt.itemsize)} B")
                active = lib.wf_lstm_stack_forward_clusters(code, cs, hcp, rb, hidden)
                if active <= 0:
                    raise RuntimeError(f"the card runs no cluster of the forward recurrence plan "
                                       f"{(cs, hcp, rb)} at H = {hidden} ({active})")
                clusters = nv * -(-rows // rb)
                log(f"  lstm_scan_fwd {str(dt)[6:]} H = {hidden}, {nv} x R = {rows}: cluster of "
                    f"{cs}, "
                    f"{hcp} weight columns and {rb} rows a cluster, {smem} B a block; "
                    f"{clusters} clusters ({clusters * cs} blocks), at most {active} at once")
                # Validate's rows (rows 2, 14 and 20): every cluster in one wave.
                if rows == 1536 and clusters > active:
                    raise RuntimeError(f"the forward plan {(cs, hcp, rb)} at 1536 rows takes "
                                       f"{clusters} clusters, {active} co-resident")
        # Row 11's tangent recurrence: its plan at the SO inner step's rows
        # (512; 256 a rank at sp 2) and at the gate's; its shared memory is
        # the backward's.
        for dt in (torch.float32, torch.bfloat16):
            for hidden, rows in ((128, 512), (128, 256), (64, 48), (128, 48), (256, 48)):
                cs, hcp, rb = fh.tangent_plan(hidden, rows, dt.itemsize, sms)
                code = cuda_build.dtype_code(dt)
                active = lib.wf_lstm_tangent_recurrence_clusters(code, cs, hcp, rb, hidden)
                if active <= 0:
                    raise RuntimeError(f"the card runs no cluster of the tangent recurrence plan "
                                       f"{(cs, hcp, rb)} at H = {hidden} ({active})")
                clusters = -(-rows // rb)
                log(f"  lstm_scan_tan {str(dt)[6:]} H = {hidden}, R = {rows}: cluster of {cs}, "
                    f"{hcp} weight columns and {rb} rows a cluster, "
                    f"{fls.scan_smem(hidden, hcp, rb, dt.itemsize)} B a block; {clusters} "
                    f"clusters ({clusters * cs} blocks), at most {active} at once")
        # Row 10's tangent forward recurrence: its plan at the SO inner step's
        # rows (512; 256 a rank at sp 2) and at the gate's; its shared memory
        # is the forward's.
        for dt in (torch.float32, torch.bfloat16):
            for hidden, rows in ((128, 512), (128, 256), (64, 48), (128, 48), (256, 48)):
                cs, hcp, rb = fh.tangent_forward_plan(hidden, rows, dt.itemsize, sms)
                code = cuda_build.dtype_code(dt)
                active = lib.wf_lstm_tangent_forward_clusters(code, cs, hcp, rb, hidden)
                if active <= 0:
                    raise RuntimeError(f"the card runs no cluster of the tangent forward "
                                       f"recurrence plan {(cs, hcp, rb)} at H = {hidden} "
                                       f"({active})")
                clusters = -(-rows // rb)
                log(f"  lstm_scan_fwd_tan {str(dt)[6:]} H = {hidden}, R = {rows}: cluster of "
                    f"{cs}, {hcp} weight columns and {rb} rows a cluster, "
                    f"{fls.scan_fwd_smem(hidden, hcp, rb, dt.itemsize)} B a block; {clusters} "
                    f"clusters ({clusters * cs} blocks), at most {active} at once")
        # The streamed plans (past the clusters that hold Wh, and the eval
        # forward's at float32 H 320 / 384): k_res of K rows resident, the
        # shared memory a block takes (C against Python) and the clusters
        # the card runs at once.
        for dt, hidden, rows, forward in (
                *((getattr(torch, d), h, 512, f) for d, h in STREAM_WIDTHS for f in (True, False)),
                (torch.float32, 320, 1536, None), (torch.float32, 384, 1536, None)):
            e, code = dt.itemsize, cuda_build.dtype_code(dt)
            plan = (fls.eval_plan(hidden, rows, e, sms) if forward is None else
                    (fls.forward_plan if forward else fls.recurrence_plan)(hidden, rows, e, sms))
            cs, hcp, rb, k_res = plan
            fwd = forward is not False
            k_rows = hidden if fwd else 4 * hidden
            smem = (lib.wf_lstm_stack_forward_stream_smem if fwd else
                    lib.wf_lstm_stack_recurrence_stream_smem)(code, hcp, rb, hidden, k_res)
            want = (fls.scan_fwd_stream_smem if fwd else fls.scan_stream_smem)(hidden, hcp, rb, e,
                                                                              k_res)
            active = (lib.wf_lstm_stack_forward_stream_clusters if fwd else
                      lib.wf_lstm_stack_recurrence_stream_clusters)(code, cs, hcp, rb, hidden,
                                                                     k_res)
            if not fls.streams(plan, k_rows) or smem != want or active <= 0:
                raise RuntimeError(f"streamed plan {plan} at {dt} H {hidden}: shared memory C "
                                   f"{smem} B, Python {want} B, {active} clusters at once")
            clusters = -(-rows // rb)
            log(f"  {'eval forward' if forward is None else 'lstm_scan_fwd' if fwd else 'lstm_scan_bwd'}"
                f" streamed {str(dt)[6:]} H = {hidden}, R = {rows}: cluster of {cs}, {hcp} "
                f"weight columns, {rb} rows a cluster, {k_res} of {k_rows} K-rows resident, "
                f"{smem} B a block; {clusters} clusters, at most {active} at once; "
                f"{clusters * cs * (k_rows - k_res) * fls._slice_row_bytes(hcp, e, fwd) / 1e6:.1f}"
                f" MB from L2 a step")

    cfg = ModelConfig()
    boxes = dict((name, box) for box, name in ADAPTATION_REGIONS)
    moscow = synthetic_region_for_box(boxes["Moscow"], num_timesteps=2, seed=0)
    graph = build_region_graph(moscow.lats, moscow.lons, k_neighbors=4)
    n = graph.padded_nodes
    model = init_model(torch.Generator().manual_seed(0), cfg, device=dev)
    a_hat = torch.from_numpy(graph.a_hat).to(dev)
    rng = np.random.default_rng(0)
    enc, lstm = model.encoder.layers, model.lstm.layers
    measured: dict = {}  # name -> dict(max_abs_err, ms, plain_ms, library_ms, bytes, flops)

    def gcn_flops(slices, widths):
        return sum(2 * slices * n * (c * h + n * h) for c, h in widths)

    def lstm_flops(rows, t_len, c_in, hidden, layers):
        return sum(2 * t_len * rows * ((c_in if l == 0 else hidden) + hidden) * 4 * hidden
                   for l in range(layers))

    gcn_widths = [(layer.w.shape[0], layer.w.shape[1]) for layer in enc]
    gcn_w_bytes = 4 * sum(c * h + h for c, h in gcn_widths)
    lstm_w_bytes = 4 * sum(p.numel() for layer in lstm for p in (layer.wx, layer.wh, layer.b))

    # 3. Serving kernels vs plain at the reference width.
    x_gcn = torch.from_numpy(
        rng.standard_normal((3 * cfg.window, n, cfg.in_channels)).astype(np.float32)
    ).to(dev)
    x_lstm = torch.from_numpy(
        rng.standard_normal((3 * n, cfg.window, cfg.hidden_channels)).astype(np.float32)
    ).to(dev)
    def eval_call(entry, x, dt):
        """One call of an eval LSTM entry (row 2 or 20: the eval forward on
        row 14's schedule), gated on its launches: one call, a gemm_nn and a
        forward recurrence a layer (all from one C call), no other
        gemm_nn."""
        def counts():
            return (entry.launches, entry.forward_gemm_nn_launches,
                    entry.forward_recurrence_launches, gemm_nn.launches)

        before = counts()
        out = entry(lstm, x, compute_dtype=dt)
        got = tuple(a - b for a, b in zip(counts(), before))
        want = (1, cfg.lstm_layers, cfg.lstm_layers, cfg.lstm_layers)
        if got != want:
            raise RuntimeError(f"{entry.__name__} launched (calls, its gemm_nn, its recurrences, "
                               f"gemm_nn) {got} a call, not {want}")
        return out

    # Row 2 at validate's 3 windows (1536 rows) and at the forecast's one.
    runs = {
        "fused_gcn_stack": (
            lambda dt: fused_gcn_stack(enc, a_hat, x_gcn, compute_dtype=dt),
            lambda dt: gcn_stack_plain(enc, a_hat, x_gcn, dt),
        ),
        "lstm_stack_last_all": (
            lambda dt: eval_call(lstm_stack_last_all, x_lstm, dt),
            lambda dt: lstm_stack_plain(lstm, x_lstm, dt),
        ),
        "lstm_stack_last_all [512]": (
            lambda dt: eval_call(lstm_stack_last_all, x_lstm[:n], dt),
            lambda dt: lstm_stack_plain(lstm, x_lstm[:n], dt),
        ),
    }
    with Phase("serving kernels vs plain"), torch.inference_mode():
        for name, (kernel, plain) in runs.items():
            for dt_name, tol in TOL.items():
                dt = getattr(torch, dt_name)
                before = gemm_nn.launches
                got = kernel(dt)
                if name == "fused_gcn_stack" and gemm_nn.launches - before != 2 * len(enc):
                    raise RuntimeError(f"row 1 launched gemm_nn {gemm_nn.launches - before} "
                                       f"times, not {2 * len(enc)}")
                ref = plain(dt)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                torch.testing.assert_close(got, ref, rtol=tol, atol=tol)
                log(f"{name} {dt_name}: max_abs_err {err:.3e} (tol {tol})")
                if dt_name == "float32":
                    measured[name] = {"max_abs_err": err}

    # 4. The serving path through the CLI.
    out_root = tempfile.mkdtemp(prefix="chip_smoke_")
    serve_dir = os.path.join(out_root, "serve")
    with Phase("serving CLI"):
        save_checkpoint(
            os.path.join(serve_dir, "meta", "ckpt_best"),
            model.state_dict(),
            {"schema": "wfstgcn-meta-v1", "config": to_dict(ExperimentConfig(model=cfg))},
        )

        def forecast(region, dt_name, out, device="cuda", *extra):
            argv = ["forecast", "--region", region, "--device", device,
                    "-o", f"out_dir={out}", "-o", f"model.compute_dtype={dt_name}", *extra]
            with contextlib.redirect_stdout(io.StringIO()):
                if cli.main(argv) != 0:
                    raise RuntimeError(f"forecast {argv} failed")
            with open(os.path.join(out, "forecasts", f"{region}.json")) as f:
                mean = np.asarray(json.load(f)["mean_forecast"])
            if mean.shape != (cfg.horizon, cfg.num_weather_vars) or not np.isfinite(mean).all():
                raise RuntimeError(f"forecast {region} {dt_name}: bad output {mean.shape}")
            return mean

        def validate(dt_name, *extra):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["validate", "--region", "Moscow", "--no-plots",
                               "-o", f"out_dir={serve_dir}",
                               "-o", f"model.compute_dtype={dt_name}", *extra])
            results = json.loads(buf.getvalue())
            values = [v for k, d in results.items() if isinstance(d, dict) for v in d.values()]
            if rc != 0 or not np.isfinite(values + [results["average_mse"]]).all():
                raise RuntimeError(f"validate {dt_name}: {results}")
            return results

        fused_gcn_stack.launches = fused_gcn_stack.gemm_nn_launches = 0
        lstm_stack_last_all.launches = lstm_stack_last_all.forward_gemm_nn_launches = 0
        lstm_stack_last_all.forward_recurrence_launches = 0
        served = {}
        for dt_name in TOL:
            for region in REGIONS:
                served[(region, dt_name)] = forecast(region, dt_name, serve_dir)
            validate(dt_name)
        launches = {
            "fused_gcn_stack": fused_gcn_stack.launches,
            "lstm_stack_last_all": lstm_stack_last_all.launches,
        }
        log(f"launches on the serving path: {launches}; row 1's gemm_nn launches "
            f"{fused_gcn_stack.gemm_nn_launches}")
        for name, count in launches.items():
            if count == 0:
                raise RuntimeError(f"{name} never launched on the serving path")
        if fused_gcn_stack.gemm_nn_launches != 2 * len(enc) * fused_gcn_stack.launches:
            raise RuntimeError(f"row 1 launched gemm_nn {fused_gcn_stack.gemm_nn_launches} "
                               f"times in {fused_gcn_stack.launches} calls")
        row2 = (lstm_stack_last_all.launches, lstm_stack_last_all.forward_gemm_nn_launches,
                lstm_stack_last_all.forward_recurrence_launches)
        log(f"row 2 on the serving path: {row2[0]} calls, {row2[1]} gemm_nn and {row2[2]} "
            f"forward recurrence launches")
        if row2[1:] != (cfg.lstm_layers * row2[0],) * 2:
            raise RuntimeError(f"row 2 launched (calls, gemm_nn, recurrences) {row2}")

        for dt_name, tol in TOL.items():
            ref = forecast("Moscow", dt_name, serve_dir, device="cpu")
            got = served[("Moscow", dt_name)]
            diff = np.abs(got - ref)
            log(
                f"forecast Moscow {dt_name}: card vs plain route max_abs_err "
                f"{float(diff.max()):.3e}, max_rel_err "
                f"{float((diff / np.maximum(np.abs(ref), 1e-30)).max()):.3e}; gate "
                f"|diff| <= atol + rtol * |ref| with atol {tol}, rtol {tol}: worst "
                f"|diff| - rtol * |ref| {float((diff - tol * np.abs(ref)).max()):.3e}"
            )
            np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)

    # 5. Serving times.
    with Phase("serving times"):
        cudnn = torch.nn.LSTM(cfg.hidden_channels, cfg.lstm_hidden, cfg.lstm_layers,
                              batch_first=True).to(dev)
        with torch.no_grad():
            for l, layer in enumerate(lstm):
                getattr(cudnn, f"weight_ih_l{l}").copy_(layer.wx.t())
                getattr(cudnn, f"weight_hh_l{l}").copy_(layer.wh.t())
                getattr(cudnn, f"bias_ih_l{l}").copy_(layer.b)
                getattr(cudnn, f"bias_hh_l{l}").zero_()
        # Yardstick: cuDNN's LSTM forward for the eval stack (rows 2 and 20)
        # in each dtype at each shape, by events and by graph replay.
        cudnn_bf16 = copy.deepcopy(cudnn).to(torch.bfloat16)
        cudnn_ms = {}
        with torch.inference_mode():
            for rows in (3 * n, n):
                for dt_name, lib in (("float32", cudnn), ("bfloat16", cudnn_bf16)):
                    xr = x_lstm[:rows].to(getattr(torch, dt_name))
                    cudnn_ms[(rows, dt_name)] = (cuda_ms(torch, lambda: lib(xr)),
                                                 graph_ms(torch, lambda: lib(xr)))
                    log(f"torch.nn.LSTM (cuDNN) {dt_name} forward [{rows}, 24, 256]: "
                        f"{cudnn_ms[(rows, dt_name)][0]:.4f} ms, device "
                        f"{cudnn_ms[(rows, dt_name)][1]:.4f} ms (CUDA graph replay)  [{card}]")
        del cudnn_bf16
        with torch.inference_mode():
            for name, (kernel, plain) in runs.items():
                for dt_name in TOL:
                    dt = getattr(torch, dt_name)
                    ms = cuda_ms(torch, lambda: kernel(dt))
                    plain_ms = cuda_ms(torch, lambda: plain(dt))
                    t = {"ms": ms, "plain_ms": plain_ms}
                    if name.startswith("lstm_stack_last_all"):
                        # Row 2: device time alone (CUDA graph replay), the
                        # host's time to enqueue a call, cuDNN beside it.
                        rows = n if name.endswith("[512]") else 3 * n
                        t.update(device_ms=graph_ms(torch, lambda: kernel(dt)),
                                 enqueue_ms=enqueue_ms(torch, lambda: kernel(dt)),
                                 library_ms=cudnn_ms[(rows, dt_name)][0],
                                 library_device_ms=cudnn_ms[(rows, dt_name)][1])
                    log(f"{name} {dt_name}: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
                        + f"  [{card}]")
                    if dt_name == "float32":
                        measured[name].update(t)
                    elif name.startswith("lstm_stack_last_all"):
                        measured[name]["bfloat16"] = t
            measured["fused_gcn_stack"].update(
                flops=gcn_flops(3 * cfg.window, gcn_widths),
                bytes=4 * (x_gcn.numel() + n * n + 3 * cfg.window * n * cfg.hidden_channels)
                + gcn_w_bytes,
            )
            for rows, name in ((3 * n, "lstm_stack_last_all"), (n, "lstm_stack_last_all [512]")):
                measured[name].update(
                    flops=lstm_flops(rows, cfg.window, cfg.hidden_channels, cfg.lstm_hidden,
                                     cfg.lstm_layers),
                    bytes=4 * (rows * cfg.window * cfg.hidden_channels + rows * cfg.lstm_hidden)
                    + lstm_w_bytes,
                )
            at_512 = measured.pop("lstm_stack_last_all [512]")
            at_512["bound_ms"] = bound_ms(at_512["bytes"], at_512["flops"])[0]
            measured["lstm_stack_last_all"]["at_512"] = at_512
            # Row 1 beside its library call in the same dtype: cuBLAS products
            # of the rounded operands layer by layer (bfloat16 on its tensor
            # cores); device times alone by CUDA graph replay (CUDA events
            # around one call also time the host's launch work).
            for dt_name in TOL:
                dt = getattr(torch, dt_name)
                a_c, x_c = a_hat.to(dt), x_gcn.to(dt)
                w_c = [(layer.w.to(dt), layer.b) for layer in enc]

                def library():
                    h = x_c
                    for w, b in w_c:
                        h = torch.relu(a_c @ (h @ w) + b).to(dt)
                    return h

                row1 = {"ms": cuda_ms(torch, lambda: fused_gcn_stack(enc, a_hat, x_gcn,
                                                                      compute_dtype=dt)),
                        "device_ms": graph_ms(torch, lambda: fused_gcn_stack(
                            enc, a_hat, x_gcn, compute_dtype=dt)),
                        "library_ms": cuda_ms(torch, library),
                        "library_device_ms": graph_ms(torch, library)}
                log(f"row 1 {dt_name} [72, 512, 24] -> 4 x 256: kernel {row1['ms']:.4f} ms "
                    f"(device {row1['device_ms']:.4f}); cuBLAS layer by layer {dt_name} "
                    f"{row1['library_ms']:.4f} ms (device {row1['library_device_ms']:.4f})  "
                    f"[{card}]")
                if dt_name == "float32":
                    measured["fused_gcn_stack"].update(
                        device_ms=row1["device_ms"], library_ms=row1["library_ms"],
                        library_device_ms=row1["library_device_ms"])
                else:
                    measured["fused_gcn_stack"]["bfloat16"] = row1
                del a_c, x_c, w_c
            for dt_name in TOL:
                predict = make_predict(ModelConfig(compute_dtype=dt_name))
                for b in (1, 3):
                    x = torch.from_numpy(
                        rng.standard_normal((b, cfg.window, n, cfg.feature_channels)).astype(np.float32)
                    ).to(dev)
                    ms = host_ms(torch, lambda: predict(model, x, a_hat, 2))
                    log(f"predict {dt_name} batch {b}: {ms:.3f} ms  [{card}]")
        for dt_name in TOL:
            ms = host_ms(torch, lambda: forecast("Moscow", dt_name, serve_dir))
            log(f"forecast request Moscow {dt_name}: {ms:.3f} ms  [{card}]")

    # 5b. The native host pipeline against its numpy route, and the forecast
    # request's host stages with it on and off.
    with Phase("native host pipeline"):
        native_phase(torch, card, lambda region, dt_name: forecast(region, dt_name, serve_dir))

    # 6. Training kernels (rows 4-7) vs plain at the inner step's shapes.
    w_len, hid, lh, n_l = cfg.window, cfg.hidden_channels, cfg.lstm_hidden, cfg.lstm_layers
    x_enc = torch.from_numpy(
        rng.standard_normal((w_len, n, cfg.in_channels)).astype(np.float32)).to(dev)
    x_rec = torch.from_numpy(
        rng.standard_normal((n, w_len, hid)).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    gcn_masks = draw_mask(gen, (cfg.gcn_layers - 1, w_len, n, hid), 0.2, dev)
    lstm_masks = draw_mask(gen, (n_l - 1, w_len, n, lh), 0.2, dev)
    enc_params = [p for layer in enc for p in (layer.w, layer.b)]
    lstm_params = [p for layer in lstm for p in (layer.wx, layer.wh, layer.b)]
    train_runs = {
        "gcn_stack_train": (
            lambda x, dt: gcn_stack_train(enc, a_hat, x, masks=gcn_masks, keep=0.8,
                                          compute_dtype=dt),
            lambda x, dt: gcn_stack_train_plain(enc, a_hat, x, gcn_masks, 0.8, dt),
            x_enc, enc_params,
        ),
        "lstm_stack_train": (
            lambda x, dt: lstm_stack_train(lstm, x, masks=lstm_masks, keep=0.8,
                                           compute_dtype=dt),
            lambda x, dt: lstm_stack_plain(lstm, x, dt, lstm_masks, 0.8),
            x_rec, lstm_params,
        ),
    }

    def graph_of(fn, x, dt, params):
        """Forward with autograd on; returns (out, leaves, cotangent)."""
        leaf = x.detach().clone().requires_grad_(True)
        out = fn(leaf, dt)
        ct = torch.from_numpy(
            np.random.default_rng(1).standard_normal(out.shape).astype(np.float32)
        ).to(dev, out.dtype)
        return out, [leaf, *params], ct

    # 6a. The backward recurrence of rows 5, 15 and 19 alone against its
    # plain version, at widths whose plans take clusters of 1, 2, 4 and 8
    # blocks (48 rows, 7 steps), through both C entries: c_all in the compute
    # dtype with the second-order carries (rows 5, 15), c_all float32 (19).
    with Phase("LSTM recurrences (cluster plans) vs plain"), torch.no_grad():
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        seen = set()
        for dt_name, tol in TOL.items():
            dt = getattr(torch, dt_name)
            for hidden in (64, 128, 256):
                draw = np.random.default_rng(hidden)

                def card_array(shape, scale=1.0):
                    return torch.from_numpy((draw.standard_normal(shape) * scale)
                                            .astype(np.float32)).to(dev)

                pre = card_array((7, 48, 4, hidden))
                gates_r = torch.cat([torch.sigmoid(pre[:, :, :2]), torch.tanh(pre[:, :, 2:3]),
                                     torch.sigmoid(pre[:, :, 3:])], dim=2).reshape(7, 48, -1)
                g_r, c_r = card_array((7, 48, hidden)), card_array((7, 48, hidden))
                wh_r = card_array((hidden, 4 * hidden), hidden ** -0.5)
                cs, hcp, rb, _ = fls.recurrence_plan(hidden, 48, dt.itemsize, sms)
                active = cuda_build.load().wf_lstm_stack_recurrence_clusters(
                    cuda_build.dtype_code(dt), cs, hcp, rb, hidden)
                refs = lstm_scan.scan_backward_plain(g_r, gates_r, c_r.to(dt), wh_r, dt,
                                                     carries=True)
                outs = [torch.empty_like(gates_r), torch.empty_like(g_r), torch.empty_like(g_r)]
                fls._recurrence_card(g_r, gates_r, c_r.to(dt), wh_r, dt, *outs)
                outs.append(fls.launch_recurrence(cuda_build.load().wf_lstm_scan_bwd,
                                                  "row 19's recurrence",
                                                  g_r, gates_r, c_r, wh_r, dt,
                                                  torch.empty_like(gates_r)))
                refs = (*refs, lstm_scan.scan_backward_plain(g_r, gates_r, c_r, wh_r, dt))
                torch.cuda.synchronize()
                rels = [rel_err(a, b) for a, b in zip(outs, refs)]
                log(f"recurrence {dt_name} H = {hidden}: cluster of {cs} ({hcp} weight columns, "
                    f"{rb} rows a cluster), at most {active} clusters at once; max|diff|/max|ref| "
                    f"dgates {rels[0]:.2e}, dh {rels[1]:.2e}, dc {rels[2]:.2e}, row 19's entry "
                    f"{rels[3]:.2e} (tol {tol})")
                if max(rels) > tol:
                    raise RuntimeError(f"recurrence {dt_name} H = {hidden}: error {max(rels):.3e}")
                seen.add(cs)
        if seen != {1, 2, 4, 8}:
            raise RuntimeError(f"the recurrence gate reached clusters of {sorted(seen)} only")
        del pre, gates_r, g_r, c_r, wh_r, refs, outs
        # Row 4's forward recurrence alone against its plain version, the same
        # widths (clusters of 1, 2, 4 and 8), with a mask (the next layer's
        # input) and the last h.
        seen = set()
        for dt_name, tol in TOL.items():
            dt = getattr(torch, dt_name)
            for hidden in (64, 128, 256):
                draw = np.random.default_rng(hidden + 1)
                xp_r = card_array((7, 48, 4 * hidden))
                wh_r = card_array((hidden, 4 * hidden), hidden ** -0.5)
                b_r = card_array((4 * hidden,), 0.1)
                m_r = torch.from_numpy((draw.uniform(size=(7, 48, hidden)) >= 0.2)
                                       .astype(np.int8)).to(dev)
                cs, hcp, rb, _ = fls.forward_plan(hidden, 48, dt.itemsize, sms)
                outs = {}
                for route, piece in (("kernel", fls._forward_recurrence_card),
                                     ("plain", fls._forward_recurrence_plain)):
                    res = [xp_r.clone(), *(torch.empty((7, 48, hidden), dtype=dt, device=dev)
                                           for _ in range(3)),
                           torch.empty((48, hidden), device=dev)]
                    piece(res[0], wh_r, b_r, dt, res[1], res[2], mask=m_r, inv_keep=1.25,
                          next_in=res[3], h_last=res[4])
                    outs[route] = res
                torch.cuda.synchronize()
                errs = [float((a.float() - b.float()).abs().max())
                        for a, b in zip(outs["kernel"], outs["plain"])]
                log(f"forward recurrence {dt_name} H = {hidden}: cluster of {cs} ({hcp} weight "
                    f"columns, {rb} rows a cluster); max_abs_err gates {errs[0]:.2e}, h "
                    f"{errs[1]:.2e}, c {errs[2]:.2e}, next input {errs[3]:.2e}, last h "
                    f"{errs[4]:.2e} (tol {tol})")
                if max(errs) > tol:
                    raise RuntimeError(f"forward recurrence {dt_name} H = {hidden}: error "
                                       f"{max(errs):.3e}")
                seen.add(cs)
        if seen != {1, 2, 4, 8}:
            raise RuntimeError(f"the forward recurrence gate reached clusters of {sorted(seen)}")
        del xp_r, wh_r, b_r, m_r, outs
        # Row 11's tangent recurrence alone against its plain version, the
        # same widths (clusters of 1, 2, 4 and 8): tdgates and the bias
        # tangent, from random gates, their tangents, c, tc, dh, dc, g and p.
        seen = set()
        for dt_name, tol in TOL.items():
            dt = getattr(torch, dt_name)
            for hidden in (64, 128, 256):
                draw = np.random.default_rng(hidden + 2)
                pre = card_array((7, 48, 4, hidden))
                gates_r = torch.cat([torch.sigmoid(pre[:, :, :2]), torch.tanh(pre[:, :, 2:3]),
                                     torch.sigmoid(pre[:, :, 3:])], dim=2).reshape(7, 48, -1)
                tgates_r = card_array((7, 48, 4 * hidden), 0.3)
                g_r, p_r = card_array((7, 48, hidden)), card_array((6, 48, hidden))
                c_r, tc_r, dh_r, dc_r = (card_array((7, 48, hidden)).to(dt) if i < 2
                                         else card_array((7, 48, hidden)) for i in range(4))
                wh_r = card_array((hidden, 4 * hidden), hidden ** -0.5)
                cs, hcp, rb = fh.tangent_plan(hidden, 48, dt.itemsize, sms)
                outs = {}
                for route, piece in (("kernel", fh._tangent_recurrence_card),
                                     ("plain", fh._tangent_recurrence_plain)):
                    res = (torch.empty_like(gates_r), torch.empty(4 * hidden, device=dev))
                    piece(g_r, p_r, gates_r, tgates_r, c_r, tc_r, dh_r, dc_r, wh_r, dt, *res)
                    outs[route] = res
                torch.cuda.synchronize()
                rels = [rel_err(a, b) for a, b in zip(outs["kernel"], outs["plain"])]
                log(f"tangent recurrence {dt_name} H = {hidden}: cluster of {cs} ({hcp} weight "
                    f"columns, {rb} rows a cluster); max|diff|/max|ref| tdgates {rels[0]:.2e}, "
                    f"bias tangent {rels[1]:.2e} (tol {tol})")
                if max(rels) > tol:
                    raise RuntimeError(f"tangent recurrence {dt_name} H = {hidden}: error "
                                       f"{max(rels):.3e}")
                seen.add(cs)
        if seen != {1, 2, 4, 8}:
            raise RuntimeError(f"the tangent recurrence gate reached clusters of {sorted(seen)}")
        del pre, gates_r, tgates_r, g_r, p_r, c_r, tc_r, dh_r, dc_r, wh_r, outs
        # Row 10's tangent forward recurrence alone against its plain version,
        # the same widths (clusters of 1, 2, 4 and 8): the gates' tangents, th
        # and tc, below the top layer (a mask, the next layer's [tin | in | h a
        # step back]) and at the top (the last th), from random gates, c, h,
        # the next layer's h, the off-chain products and the bias tangent.
        seen = set()
        for dt_name, tol in TOL.items():
            dt = getattr(torch, dt_name)
            for hidden in (64, 128, 256):
                draw = np.random.default_rng(hidden + 3)
                pre = card_array((7, 48, 4, hidden))
                gates_r = torch.cat([torch.sigmoid(pre[:, :, :2]), torch.tanh(pre[:, :, 2:3]),
                                     torch.sigmoid(pre[:, :, 3:])], dim=2).reshape(7, 48, -1)
                ds_r = card_array((7, 48, 4 * hidden), 0.3)
                c_r, h_r, hn_r = (card_array((7, 48, hidden)).to(dt) for _ in range(3))
                wh_r = card_array((hidden, 4 * hidden), hidden ** -0.5)
                tb_r = card_array((4 * hidden,), 0.1)
                m_r = torch.from_numpy((draw.uniform(size=(7, 48, hidden)) >= 0.2)
                                       .astype(np.int8)).to(dev)
                cs, hcp, rb = fh.tangent_forward_plan(hidden, 48, dt.itemsize, sms)
                rels = []
                for below_top in (True, False):
                    outs = {}
                    for route, piece in (("kernel", fh._tangent_forward_recurrence_card),
                                         ("plain", fh._tangent_forward_recurrence_plain)):
                        res = [ds_r.clone(), *(torch.empty((7, 48, hidden), dtype=dt, device=dev)
                                               for _ in range(2))]
                        if below_top:
                            last = torch.empty((7, 48, 3 * hidden), dtype=dt, device=dev)
                            extra = dict(mask=m_r, inv_keep=1.25, next_in=last)
                        else:
                            last = torch.empty((48, hidden), device=dev)
                            extra = dict(th_last=last)
                        piece(res[0], gates_r, c_r, h_r, hn_r, wh_r, tb_r, dt, res[1], res[2],
                              **extra)
                        outs[route] = (*res, last)
                    torch.cuda.synchronize()
                    rels += [rel_err(a, b) for a, b in zip(outs["kernel"], outs["plain"])]
                log(f"tangent forward recurrence {dt_name} H = {hidden}: cluster of {cs} ({hcp} "
                    f"weight columns, {rb} rows a cluster); max|diff|/max|ref| below the top "
                    f"(tgates, th, tc, [tin | in | h]) {[f'{r:.2e}' for r in rels[:4]]}, at the "
                    f"top (tgates, th, tc, last th) {[f'{r:.2e}' for r in rels[4:]]} (tol {tol})")
                if max(rels) > tol:
                    raise RuntimeError(f"tangent forward recurrence {dt_name} H = {hidden}: "
                                       f"error {max(rels):.3e}")
                seen.add(cs)
        if seen != {1, 2, 4, 8}:
            raise RuntimeError(f"the tangent forward recurrence gate reached clusters of "
                               f"{sorted(seen)}")
        del pre, gates_r, ds_r, c_r, h_r, hn_r, wh_r, tb_r, m_r, outs, res, last
        # Row 18 alone (`scan_forward`: the forward recurrence with the bias
        # in xp, the gates to an array of their own, h and c in float32)
        # against its plain piece, the same widths (clusters of 1, 2, 4, 8).
        seen = set()
        for dt_name, tol in TOL.items():
            dt = getattr(torch, dt_name)
            for hidden in (64, 128, 256):
                draw = np.random.default_rng(hidden + 4)
                xp_r = card_array((7, 48, 4 * hidden))
                wh_r = card_array((hidden, 4 * hidden), hidden ** -0.5)
                got = lstm_scan.scan_forward(xp_r, wh_r, dt, True)
                ref = lstm_scan.scan_forward_plain(xp_r, wh_r, dt, True)
                torch.cuda.synchronize()
                if any(t.dtype != torch.float32 for t in got):
                    raise RuntimeError(f"row 18 {dt_name}: outputs {[t.dtype for t in got]}")
                errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
                cs = fls.forward_plan(hidden, 48, dt.itemsize, sms)[0]
                log(f"row 18's recurrence {dt_name} H = {hidden}: cluster of {cs}; max_abs_err "
                    f"h {errs[0]:.2e}, c {errs[1]:.2e}, gates {errs[2]:.2e} (float32 outputs; "
                    f"tol {tol})")
                if max(errs) > tol:
                    raise RuntimeError(f"row 18 {dt_name} H = {hidden}: error {max(errs):.3e}")
                seen.add(cs)
        if seen != {1, 2, 4, 8}:
            raise RuntimeError(f"the row 18 gate reached clusters of {sorted(seen)}")
        del xp_r, wh_r, got, ref

    def parts_ms(run, forward=False, tangent=False, tangent_forward=False, scan_backward=False):
        """A layer-by-layer LSTM backward's (with `forward`, row 4's or 16's;
        with `tangent`, row 11's; with `tangent_forward`, row 10's; with
        `scan_backward`, row 19's) device time by part: run(pieces) on the
        card's pieces, each piece between two CUDA events; medians of
        REPEATS runs."""
        marks = []

        def timed(fn, part):
            def call(*args, **kwargs):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                marks.append((part(kwargs), start, end))
                return out
            return call

        if forward:
            pieces = fls.ForwardPieces(
                timed(fls.FWD_CARD_PIECES.product, lambda kw: "input products"),
                timed(fls.FWD_CARD_PIECES.recurrence, lambda kw: "recurrences"))
            return time_parts(run, pieces, marks)
        if scan_backward:
            card = lstm_scan.CARD_PIECES
            pieces = lstm_scan.ScanBackwardPieces(
                timed(card.recurrence, lambda kw: "recurrence"),
                timed(card.product_tn, lambda kw: "dwh product"),
                timed(card.sum_splits, lambda kw: "dwh partial sums"))
            return time_parts(run, pieces, marks)
        if tangent_forward:
            pieces = fh.HvpFwdPieces(
                timed(fh.CARD_HVP_FWD_PIECES.product, lambda kw: "input products"),
                timed(fh.CARD_HVP_FWD_PIECES.recurrence, lambda kw: "recurrences"))
            return time_parts(run, pieces, marks)
        if tangent:
            card = fh.CARD_TANGENT_PIECES
            pieces = fh.TangentPieces(
                timed(card.product, lambda kw: "carry products" if "carry" in kw["what"]
                      else "input tangents"),
                timed(card.recurrence, lambda kw: "recurrences"),
                timed(card.product_tn, lambda kw: "weight tangents"),
                timed(card.sum_splits, lambda kw: "weight tangents"))
            return time_parts(run, pieces, marks)
        card_pieces = fls.CARD_PIECES
        pieces = dataclasses.replace(
            card_pieces,
            product=timed(card_pieces.product, lambda kw: "gate products"
                          if kw.get("epilogue") == "gates" else "input products"),
            recurrence=timed(card_pieces.recurrence, lambda kw: "recurrences"),
            product_tn=timed(card_pieces.product_tn, lambda kw: "weight gradients"),
            sum_splits=timed(card_pieces.sum_splits, lambda kw: "partial sums"))
        return time_parts(run, pieces, marks)

    def time_parts(run, pieces, marks):
        runs = []
        with torch.no_grad():
            for i in range(REPEATS + 2):
                marks.clear()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run(pieces)
                end.record()
                torch.cuda.synchronize()
                if i < 2:  # warm-up
                    continue
                part = {"total": start.elapsed_time(end)}
                for name, s, e in marks:
                    part[name] = part.get(name, 0.0) + s.elapsed_time(e)
                if "partial sums" in part:  # the weight gradients' TN products and their sums
                    part["weight-gradient part"] = part["weight gradients"] + part["partial sums"]
                runs.append(part)
        return {k: statistics.median(r[k] for r in runs) for k in runs[0]}

    with Phase("training kernels vs plain"):
        for name, (kernel, plain, x, params) in train_runs.items():
            for dt_name, tol in TOL.items():
                dt = getattr(torch, dt_name)
                outs = {}
                for route, fn in (("kernel", kernel), ("plain", plain)):
                    out, leaves, ct = graph_of(fn, x, dt, params)
                    outs[route] = (out.detach(), torch.autograd.grad(out, leaves, ct))
                torch.cuda.synchronize()
                (got, got_g), (ref, ref_g) = outs["kernel"], outs["plain"]
                fwd_err = float((got.float() - ref.float()).abs().max())
                torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
                rels = [rel_err(g, r) for g, r in zip(got_g, ref_g)]
                bwd_err = max(float((g - r).abs().max()) for g, r in zip(got_g, ref_g))
                log(f"{name} {dt_name} x {list(x.shape)}: forward max_abs_err {fwd_err:.3e} "
                    f"(tol {tol}); gradients max|diff|/max|ref| {max(rels):.3e} (tol {tol}), "
                    f"per input {[f'{r:.1e}' for r in rels]}")
                if max(rels) > tol:
                    raise RuntimeError(f"{name} {dt_name}: gradient error {max(rels):.3e} > {tol}")
                times = {}
                for route, fn in (("kernel", kernel), ("plain", plain)):
                    with torch.no_grad():
                        fwd = cuda_ms(torch, lambda: fn(x, dt))
                    out, leaves, ct = graph_of(fn, x, dt, params)
                    bwd = cuda_ms(torch, lambda: torch.autograd.grad(
                        out, leaves, ct, retain_graph=True))
                    times[route] = (fwd, bwd)
                log(f"{name} {dt_name}: kernel forward {times['kernel'][0]:.4f} ms, backward "
                    f"{times['kernel'][1]:.4f} ms; plain forward {times['plain'][0]:.4f} ms, "
                    f"backward {times['plain'][1]:.4f} ms  [{card}]")
                if dt_name == "float32":
                    measured[name] = {"max_abs_err": fwd_err, "ms": times["kernel"][0],
                                      "plain_ms": times["plain"][0]}
                    measured[name + ".backward"] = {
                        "max_abs_err": bwd_err, "ms": times["kernel"][1],
                        "plain_ms": times["plain"][1]}
                elif name == "lstm_stack_train":
                    measured[name]["bfloat16_ms"] = times["kernel"][0]
                    measured[name + ".backward"]["bfloat16_ms"] = times["kernel"][1]
        # Yardsticks: cuBLAS float32 (the plain GEMM route) for the GCN
        # stack; cuDNN's LSTM, weights copied in, dropout 0, for the LSTM.
        measured["gcn_stack_train"]["library_ms"] = measured["gcn_stack_train"]["plain_ms"]
        measured["gcn_stack_train.backward"]["library_ms"] = (
            measured["gcn_stack_train.backward"]["plain_ms"])
        xr = x_rec.detach().clone().requires_grad_(True)
        with torch.no_grad():
            measured["lstm_stack_train"]["library_ms"] = cuda_ms(torch, lambda: cudnn(xr))
        out = cudnn(xr)[0][:, -1]
        ct = torch.ones_like(out)
        measured["lstm_stack_train.backward"]["library_ms"] = cuda_ms(
            torch, lambda: torch.autograd.grad(out, [xr, *cudnn.parameters()], ct,
                                               retain_graph=True))
        log(f"torch.nn.LSTM (cuDNN) float32 [512, 24, 256]: forward "
            f"{measured['lstm_stack_train']['library_ms']:.4f} ms, backward "
            f"{measured['lstm_stack_train.backward']['library_ms']:.4f} ms  [{card}]")
        del out, ct, xr
        # Row 5 alone, its wrapper from row 4's residuals (masks at rate 0.2):
        # by CUDA events, by CUDA graph replay (device time) and by part;
        # cuDNN's backward in the same dtype beside it.
        x5 = x_rec.transpose(0, 1).contiguous()
        wcat5 = [torch.cat([layer.wx, layer.wh]).detach() for layer in lstm]
        b2d5 = torch.stack([layer.b for layer in lstm]).detach()
        g5 = torch.from_numpy(np.random.default_rng(5).standard_normal((n, lh))
                              .astype(np.float32)).to(dev)
        for dt_name in TOL:
            dt = getattr(torch, dt_name)
            with torch.no_grad():
                _, h5, c5, gates5 = fls.train_forward(x5, lstm_masks, 0.8, dt, b2d5, wcat5)

                def row5():
                    fls.train_backward(g5, x5, h5, c5, gates5, wcat5, lstm_masks, 0.8, dt)

                row = {"call_ms": cuda_ms(torch, row5), "device_ms": graph_ms(torch, row5),
                       "parts_ms": parts_ms(lambda p: fls.merged_backward_schedule(
                           g5, x5, h5, c5, gates5, wcat5, lstm_masks, 0.8, dt, p))}
            lib_lstm = cudnn if dt_name == "float32" else copy.deepcopy(cudnn).to(dt)
            xr = x_rec.detach().to(dt).requires_grad_(True)
            try:
                out = lib_lstm(xr)[0][:, -1]
            except RuntimeError as err:  # a yardstick only: say so and go on
                log(f"torch.nn.LSTM (cuDNN) refused {dt_name}: {err}")
                row["library_ms"] = None
            else:
                ct = torch.ones_like(out)
                row["library_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
                    out, [xr, *lib_lstm.parameters()], ct, retain_graph=True))
                row["library_device_ms"] = cudnn_backward_device_ms(torch, out, xr, lib_lstm, ct)
                del out, ct
            del lib_lstm, xr, h5, c5, gates5
            log(f"row 5 {dt_name} [24, 512, 256] L=4 from row 4's residuals: the call "
                f"{row['call_ms']:.4f} ms, device {row['device_ms']:.4f} ms (CUDA graph replay); "
                f"by part (CUDA events, median of {REPEATS}): " + ", ".join(
                    f"{k} {v:.4f} ms" for k, v in row["parts_ms"].items())
                + f"; cuDNN backward {dt_name} "
                + ("refused" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms")
                + ("" if row.get("library_device_ms") is None
                   else f" (device {row['library_device_ms']:.4f})") + f"  [{card}]")
            if dt_name == "float32":
                measured["lstm_stack_train.backward"].update(
                    device_ms=row["device_ms"], parts_ms=row["parts_ms"], call_ms=row["call_ms"],
                    library_device_ms=row.get("library_device_ms"))
            else:
                row["ms"] = measured["lstm_stack_train.backward"].pop("bfloat16_ms")
                measured["lstm_stack_train.backward"]["bfloat16"] = row
        # Row 4 alone, as the model calls it (x [T, B, C] a view of [B, T, C]):
        # its four outputs against its schedule on the plain pieces (masks at
        # rate 0.2 and off), its launches a call (from one C call: a gemm_nn
        # and a forward recurrence a layer), by CUDA events, by
        # CUDA graph replay, by part (the schedule a launch at a time), the
        # host's time a call; cuDNN's forward in the same dtype beside it.
        x4 = x_rec.transpose(0, 1)
        wcat4 = [torch.cat([layer.wx, layer.wh]).detach() for layer in lstm]
        b2d4 = torch.stack([layer.b for layer in lstm]).detach()
        train4 = lstm_stack_train
        for dt_name, tol in TOL.items():
            dt = getattr(torch, dt_name)
            with torch.no_grad():
                errs = {}
                for m4 in (lstm_masks, None):
                    got4 = fls.train_forward(x4, m4, 0.8, dt, b2d4, wcat4)
                    ref4 = fls.forward_schedule(x4, m4, 0.8, dt, b2d4, wcat4,
                                                fls.FWD_PLAIN_PIECES)
                    torch.cuda.synchronize()
                    for out_name, g, r in zip(("h_last", "h_all", "c_all", "gates"), got4, ref4):
                        torch.testing.assert_close(g.float(), r.float(), rtol=tol, atol=tol,
                                                   msg=f"row 4 {dt_name} {out_name}")
                        errs[(m4 is not None, out_name)] = float((g.float() - r.float()).abs()
                                                                 .max())
                    del got4, ref4
                log(f"row 4 {dt_name} [24, 512, 256] L=4 against its schedule on the plain "
                    f"pieces: max_abs_err " + ", ".join(
                        f"{k[1]}{' masked' if k[0] else ''} {v:.2e}" for k, v in errs.items())
                    + f" (tol {tol})")

                def row4():
                    fls.train_forward(x4, lstm_masks, 0.8, dt, b2d4, wcat4)

                before = (train4.launches, train4.forward_gemm_nn_launches,
                          train4.forward_recurrence_launches, gemm_nn.launches)
                row4()
                core4 = {"calls": train4.launches - before[0],
                         "gemm_nn": train4.forward_gemm_nn_launches - before[1],
                         "recurrences": train4.forward_recurrence_launches - before[2],
                         "gemm_nn (all)": gemm_nn.launches - before[3]}
                want = {"calls": 1, "gemm_nn": n_l, "recurrences": n_l, "gemm_nn (all)": n_l}
                if core4 != want:
                    raise RuntimeError(f"row 4 launched {core4} a call, not {want}")
                row = {"call_ms": cuda_ms(torch, row4), "device_ms": graph_ms(torch, row4),
                       "host_ms": host_ms(torch, row4), "enqueue_ms": enqueue_ms(torch, row4),
                       "parts_ms": parts_ms(lambda p: fls.forward_schedule(
                           x4, lstm_masks, 0.8, dt, b2d4, wcat4, p), forward=True),
                       "core_launches": core4}
            lib_lstm = cudnn if dt_name == "float32" else copy.deepcopy(cudnn).to(dt)
            xr = x_rec.detach().to(dt)
            with torch.no_grad():
                try:
                    row["library_ms"] = cuda_ms(torch, lambda: lib_lstm(xr))
                except RuntimeError as err:  # a yardstick only: say so and go on
                    log(f"torch.nn.LSTM (cuDNN) forward refused {dt_name}: {err}")
                    row["library_ms"] = None
                if row["library_ms"] is not None:
                    try:
                        row["library_device_ms"] = graph_ms(torch, lambda: lib_lstm(xr))
                    except RuntimeError as err:
                        log(f"cuDNN's LSTM forward in a CUDA graph refused: {err}")
            del lib_lstm, xr
            log(f"row 4 {dt_name} [24, 512, 256] L=4, masks 0.2: the call {row['call_ms']:.4f} "
                f"ms, device {row['device_ms']:.4f} ms (CUDA graph replay), host "
                f"{row['host_ms']:.4f} ms to a synchronize, {row['enqueue_ms']:.4f} ms to enqueue; "
                f"by part (CUDA events, median of {REPEATS}): " + ", ".join(
                    f"{k} {v:.4f} ms" for k, v in row["parts_ms"].items())
                + f"; launches a call {core4}; cuDNN forward {dt_name} "
                + ("refused" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms")
                + (f" (device {row['library_device_ms']:.4f})" if "library_device_ms" in row
                   else "") + f"  [{card}]")
            if dt_name == "float32":
                row.pop("library_ms")
                measured["lstm_stack_train"].update(row)
            else:
                row["ms"] = measured["lstm_stack_train"].pop("bfloat16_ms")
                measured["lstm_stack_train"]["bfloat16"] = row
        del x4, wcat4, b2d4
        # Rows 6 and 7 alone, row 7 from row 6's residuals: the call by CUDA
        # events and its device time by CUDA graph replay, beside the cuBLAS
        # route by both (float32: the plain forward; row 7's function written
        # out on torch.matmul, `cublas_row7`); the launches of one backward.
        enc_w = [layer.w.detach() for layer in enc]
        enc_b = [layer.b.detach() for layer in enc]
        for dt_name in TOL:
            dt = getattr(torch, dt_name)
            with torch.no_grad():
                h7 = fgt._forward(x_enc, a_hat, enc_w, enc_b, gcn_masks, 1.25, dt)
                g7 = torch.from_numpy(np.random.default_rng(7).standard_normal(h7[-1].shape)
                                      .astype(np.float32)).to(dev, dt)

                def row6():
                    gcn_stack_train(enc, a_hat, x_enc, masks=gcn_masks, keep=0.8,
                                    compute_dtype=dt)

                def row7():
                    fgt._backward(g7, x_enc, a_hat, enc_w, gcn_masks, h7, 1.25, dt)

                before = (gemm_nn.launches, gemm_tn.launches)
                row6()
                core6 = {"gemm_nn": gemm_nn.launches - before[0],
                         "gemm_tn": gemm_tn.launches - before[1]}
                want = {"gemm_nn": 2 * len(enc), "gemm_tn": 0}
                if core6 != want:
                    raise RuntimeError(f"row 6 launched {core6} a call, not {want}")
                before = (gemm_nn.launches, gemm_tn.launches)
                row7()
                core7 = {"gemm_nn": gemm_nn.launches - before[0],
                         "gemm_tn": gemm_tn.launches - before[1]}
                want = {"gemm_nn": 2 * len(enc), "gemm_tn": len(enc)}
                if core7 != want:
                    raise RuntimeError(f"row 7 launched {core7} a call, not {want}")
                times = {"row 6": (cuda_ms(torch, row6), graph_ms(torch, row6)),
                         "row 7": (cuda_ms(torch, row7), graph_ms(torch, row7))}
                if dt_name == "float32":
                    h7f = [h.float() for h in h7]

                    def lib6():
                        gcn_stack_train_plain(enc, a_hat, x_enc, gcn_masks, 0.8, dt)

                    def lib7():
                        cublas_row7(torch, g7, x_enc, a_hat, enc_w, gcn_masks, h7f, 0.8)

                    times["cuBLAS row 6"] = (cuda_ms(torch, lib6), graph_ms(torch, lib6))
                    times["cuBLAS row 7"] = (cuda_ms(torch, lib7), graph_ms(torch, lib7))
            log(f"rows 6-7 {dt_name} x [24, 512, 24], 4 x 256, masks 0.2 (call by events / "
                f"device by graph replay): " + ", ".join(
                    f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in times.items())
                + f"; row 6 launches a call {core6}, row 7 {core7}  [{card}]")
            if dt_name == "float32":
                measured["gcn_stack_train"].update(
                    call_ms=times["row 6"][0], device_ms=times["row 6"][1],
                    library_call_ms=times["cuBLAS row 6"][0],
                    library_device_ms=times["cuBLAS row 6"][1], core_launches=core6)
                measured["gcn_stack_train.backward"].update(
                    call_ms=times["row 7"][0], device_ms=times["row 7"][1],
                    library_call_ms=times["cuBLAS row 7"][0],
                    library_device_ms=times["cuBLAS row 7"][1], core_launches=core7)
            else:
                measured["gcn_stack_train"]["bfloat16"] = {
                    "call_ms": times["row 6"][0], "device_ms": times["row 6"][1]}
                measured["gcn_stack_train.backward"]["bfloat16"] = {
                    "call_ms": times["row 7"][0], "device_ms": times["row 7"][1]}
            del h7, g7
        e = 4  # float32 residuals
        gcn_io = 4 * (x_enc.numel() + n * n) + gcn_w_bytes + gcn_masks.numel()
        act = cfg.gcn_layers * w_len * n * hid * e
        measured["gcn_stack_train"].update(flops=gcn_flops(w_len, gcn_widths),
                                           bytes=gcn_io + act)
        measured["gcn_stack_train.backward"].update(
            flops=sum(2 * w_len * n * (n * h + 2 * c * h) for c, h in gcn_widths),
            bytes=gcn_io + act + w_len * n * hid * e + 4 * x_enc.numel() + gcn_w_bytes)
        lstm_io = 4 * x_rec.numel() + lstm_w_bytes + lstm_masks.numel()
        res = 2 * n_l * w_len * n * lh * e
        fl = lstm_flops(n, w_len, hid, lh, n_l)
        measured["lstm_stack_train"].update(flops=fl, bytes=lstm_io + res + 4 * n * lh)
        measured["lstm_stack_train.backward"].update(
            flops=2 * fl, bytes=lstm_io + res + 4 * n * lh + 4 * x_rec.numel() + lstm_w_bytes)

    # 6b. The pipelined core's TN variant (row 7's weight gradients) at the
    # main path's shapes (K = 24 x 512 rows, M = 256 and layer 0's 24, N =
    # 256, 48 splits of 256 rows) against its plain version split by split,
    # the split sums against float64, two runs bitwise equal; the relu-grad
    # epilogue's column sums (row 7's db partials) bitwise equal too.
    with Phase("GEMM core TN variant vs plain"), torch.no_grad():
        rows7 = w_len * n
        draw = np.random.default_rng(11)
        for dt_name, tol in TOL.items():
            dt = getattr(torch, dt_name)
            for m_tn in (hid, cfg.in_channels):
                a_tn = torch.from_numpy(draw.standard_normal((rows7, m_tn)).astype(np.float32)
                                        ).to(dev, dt)
                b_tn = torch.from_numpy((draw.standard_normal((rows7, hid)) * rows7 ** -0.5)
                                        .astype(np.float32)).to(dev, dt)
                splits = tn_splits(rows7)
                runs = [gemm_tn(a_tn, b_tn, torch.empty((splits, m_tn, hid), device=dev),
                                compute_dtype=dt) for _ in range(2)]
                ref = gemm_tn_plain(a_tn, b_tn, torch.empty((splits, m_tn, hid), device=dev),
                                    compute_dtype=dt)
                total = torch.empty((1, m_tn * hid), device=dev)
                sum_splits(runs[0].view(splits, 1, -1), total, "TN gate")
                torch.cuda.synchronize()
                bitwise = torch.equal(runs[0], runs[1])
                rels = (rel_err(runs[0], ref),
                        rel_err(total.view(m_tn, hid), a_tn.double().T @ b_tn.double()))
                ms = cuda_ms(torch, lambda: gemm_tn(a_tn, b_tn, runs[1], compute_dtype=dt))
                lib = cuda_ms(torch, lambda: a_tn.T @ b_tn)
                log(f"gemm_tn {dt_name} [{rows7}, {m_tn}]^T [{rows7}, {hid}] in {splits} splits: "
                    f"max|diff|/max|ref| {rels[0]:.2e} by split, {rels[1]:.2e} summed against "
                    f"float64 (tol {tol}); two runs bitwise equal: {bitwise}; {ms:.4f} ms "
                    f"(partials), torch.matmul {lib:.4f} ms  [{card}]")
                if not bitwise or max(rels) > tol:
                    raise RuntimeError(f"gemm_tn {dt_name} M = {m_tn}: error {max(rels):.3e}, "
                                       f"bitwise {bitwise}")
            a_nn = torch.from_numpy(draw.standard_normal((rows7, hid)).astype(np.float32)
                                    ).to(dev, dt)
            w_nn = torch.from_numpy((draw.standard_normal((hid, hid)) * hid ** -0.5)
                                    .astype(np.float32)).to(dev, dt)
            res_nn = torch.from_numpy(draw.standard_normal((rows7, hid)).astype(np.float32)
                                      ).to(dev, dt)
            outs = []
            for product in (gemm_nn, gemm_nn, gemm_nn_plain):
                cs = torch.empty((-(-rows7 // 128), hid), device=dev)
                out = product(a_nn, w_nn, compute_dtype=dt, epilogue="relu_grad",
                              residual=res_nn, mask=gcn_masks[0].reshape(rows7, hid),
                              scale=1.25, colsum=cs, out_dtype=dt)
                outs.append((out, cs))
            torch.cuda.synchronize()
            rel = max(rel_err(outs[0][0], outs[2][0]), rel_err(outs[0][1], outs[2][1]))
            bitwise = torch.equal(outs[0][1], outs[1][1])
            log(f"gemm_nn relu_grad {dt_name} [{rows7}, {hid}] @ [{hid}, {hid}]: "
                f"max|diff|/max|ref| "
                f"{rel:.2e} (tol {tol}), column sums bitwise equal across two runs: {bitwise}")
            if not bitwise or rel > tol:
                raise RuntimeError(f"gemm_nn relu_grad {dt_name}: error {rel:.3e}, "
                                   f"bitwise {bitwise}")
        del a_tn, b_tn, runs, ref, total, a_nn, w_nn, res_nn, outs

    # 7. The whole-tree clip + SGD (rows 8-9) vs plain: the reference
    # model's 23 leaves, one task and a task axis of 4 (task v's parameters
    # scaled by 1 + v / 10), gradients drawn with numpy and scaled to a
    # global norm (per task) of 0.5 and 30 around clip_norm 1.0.
    meta_cfg = MetaConfig()
    leaves = [p.detach() for p in model.parameters()]
    n_params = sum(p.numel() for p in leaves)

    def sgd_inputs(tasks, scale):
        params = leaves if tasks == 1 else [
            torch.stack([p * (1 + 0.1 * v) for v in range(tasks)]) for p in leaves]
        draw = np.random.default_rng(20 + tasks)
        grads = [torch.from_numpy(draw.standard_normal(p.shape).astype(np.float32)).to(dev)
                 for p in params]
        norm = float(torch.sqrt(sum(torch.sum(g * g) for g in grads))) / tasks**0.5
        return params, [g * (scale / norm) for g in grads]

    def hold_sgd(what, params, grads, batched):
        """The kernel against its plain version (1e-5 relative), a second
        call bitwise equal, one call captured in a CUDA graph and replayed
        bitwise equal to an eager call; its max |diff|."""
        def copy(p):  # a copy as far off 16-byte alignment as p
            off = p.storage_offset() % 4
            return torch.empty(p.numel() + off, device=p.device)[off:].view(p.shape).copy_(p)

        got, again, replayed = ([copy(p) for p in params] for _ in range(3))
        clip_sgd_update(got, grads, lr, max_norm, batched=batched)
        clip_sgd_update(again, grads, lr, max_norm, batched=batched)
        ref = [p.clone() for p in params]
        clip_sgd_update_plain(ref, grads, lr, max_norm, batched=batched)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            clip_sgd_update(replayed, grads, lr, max_norm, batched=batched)
        graph.replay()
        torch.cuda.synchronize()
        rel = max(rel_err(a, r) for a, r in zip(got, ref))
        err = max(float((a - r).abs().max()) for a, r in zip(got, ref))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        replay_same = all(torch.equal(a, b) for a, b in zip(got, replayed))
        log(f"{what}: max|diff|/max|ref| {rel:.3e} (tol {TOL['float32']}), max_abs_err "
            f"{err:.3e}; two calls bitwise equal: {same}; graph replay equal: {replay_same}")
        if rel > TOL["float32"] or not same or not replay_same:
            raise RuntimeError(f"{what}: error {rel:.3e}, bitwise {same}, replay {replay_same}")
        del graph
        return err

    with Phase("clip + SGD kernel vs plain"):
        lr, max_norm = meta_cfg.inner_lr, meta_cfg.clip_norm
        # Odd leaves: ragged chunk ends, sizes not a multiple of 4, a base
        # that is not 16-byte aligned (a view one float in), above clip_norm.
        odd_rng = np.random.default_rng(29)
        for tasks in (1, 3):
            base = torch.from_numpy(odd_rng.standard_normal(1 + 3 * 333).astype(np.float32))
            lead = (tasks,) if tasks > 1 else ()
            params = [torch.from_numpy(odd_rng.standard_normal(lead + s).astype(np.float32))
                      for s in ((31, 7), (5,), (3, 1000), (1,), (64, 64))]
            params.append(base.to(dev)[1:].reshape(lead + (-1,)) if tasks > 1
                          else base.to(dev)[1:334])
            params = [p.to(dev) for p in params]
            grads = [torch.from_numpy(odd_rng.standard_normal(p.shape).astype(np.float32) * 3)
                     .to(dev) for p in params]
            hold_sgd(f"clip_sgd_update odd leaves V={tasks}", params, grads, tasks > 1)
        for tasks, name in ((1, "clip_sgd_update"), (4, "clip_sgd_update.batched")):
            batched = tasks > 1
            errs = []
            for scale in (0.5, 30.0):
                params, grads = sgd_inputs(tasks, scale)
                errs.append(hold_sgd(f"{name} V={tasks} grad norm {scale}", params, grads,
                                     batched))
            work = [p.clone() for p in params]  # the last inputs: clipping on
            ms = cuda_ms(torch, lambda: clip_sgd_update(work, grads, lr, max_norm,
                                                        batched=batched))
            plain_ms = cuda_ms(torch, lambda: clip_sgd_update_plain(
                work, grads, lr, max_norm, batched=batched))
            # Yardstick: torch's clip_grad_norm_ per task, then one
            # _foreach_add_ over every leaf (separate tensors per task).
            lib = [[(p[v] if batched else p).clone() for p in params] for v in range(tasks)]
            for v in range(tasks):
                for q, g in zip(lib[v], grads):
                    q.grad = (g[v] if batched else g).clone()
            flat = [q for task in lib for q in task]
            flat_g = [q.grad for q in flat]

            def library():
                for task in lib:
                    torch.nn.utils.clip_grad_norm_(task, max_norm, foreach=True)
                torch._foreach_add_(flat, flat_g, alpha=-lr)

            library_ms = cuda_ms(torch, library)
            log(f"{name} V={tasks} ({tasks * n_params:,} values), CUDA events (the device "
                f"also waits on the host): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"clip_grad_norm_ + _foreach_add_ {library_ms:.4f} ms  [{card}]")
            # The kernels' own device time, for the table: these calls are
            # short enough that the host's launch work shows in the events.
            ms = device_ms(torch, lambda: clip_sgd_update(work, grads, lr, max_norm,
                                                          batched=batched))
            plain_ms = device_ms(torch, lambda: clip_sgd_update_plain(
                work, grads, lr, max_norm, batched=batched))
            library_ms = device_ms(torch, library)
            enq_ms = enqueue_ms(torch, lambda: clip_sgd_update(work, grads, lr, max_norm,
                                                                batched=batched), 200)
            log(f"{name} V={tasks}, device time (torch.profiler): kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, clip_grad_norm_ + _foreach_add_ {library_ms:.4f} ms; "
                f"the host's time to enqueue a kernel call {enq_ms:.4f} ms  [{card}]")
            measured[name] = {
                "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms,
                # Read p and g once, write p once; a square, an add, a
                # multiply and a subtract per value.
                "bytes": 12 * tasks * n_params, "flops": 4 * tasks * n_params,
            }
        del work, lib, flat, flat_g

    # 7b. The second-order kernels (rows 10-11) vs the plain R-operator at
    # the inner step's shapes (n rows, and n / 2: a rank's rows at sp 2):
    # rows 4 + 10, then 5 + 11, at the same point.
    def r_op_inputs(layers, dropout, seed, rows):
        draw = np.random.default_rng(seed)

        def arr(shape, scale=1.0):
            return torch.from_numpy((draw.normal(size=shape) * scale).astype(np.float32)).to(dev)

        ks = [(hid if l == 0 else lh) + lh for l in range(layers)]
        masks = None
        if dropout and layers > 1:
            masks = torch.from_numpy((draw.uniform(size=(layers - 1, w_len, rows, lh)) >= dropout)
                                     .astype(np.int8)).to(dev)
        return dict(
            x=arr((w_len, rows, hid)), tx=arr((w_len, rows, hid)),
            wcat=[arr((k, 4 * lh), 0.1) for k in ks], twcat=[arr((k, 4 * lh), 0.1) for k in ks],
            b2d=arr((layers, 4 * lh), 0.1), tb2d=arr((layers, 4 * lh), 0.1),
            g=arr((rows, lh)), tg=arr((rows, lh)), masks=masks,
            keep=1.0 - dropout if masks is not None else 1.0)

    def r_ops(a, dt, kernels):
        """(primal outputs, tangents, the pieces the timed calls take)."""
        m, keep = a["masks"], a["keep"]
        if not kernels:
            (h_last, h_all, c_all, gates, th_last, th_all, tc_all, tgates) = fh.hvp_fwd_plain(
                a["x"], a["wcat"], a["b2d"], m, keep, dt, a["tx"], a["twcat"], a["tb2d"])
            dx, dw, db, _, _, _, tdx, tdw, tdb = fh.hvp_bwd_plain(
                a["g"], a["x"], h_all, c_all, gates, a["wcat"], m, keep, dt,
                a["tg"], a["tx"], th_all, tc_all, tgates, a["twcat"])
            return ([h_last, h_all, c_all, dx, *dw, db],
                    [th_last, th_all, tc_all, tgates, tdx, *tdw, tdb], None)
        fwd_res = fh.stack_fwd(a["x"], a["wcat"], a["b2d"], m, keep, dt)
        h_last, h_all, c_all, gates = fwd_res
        tfwd = fh.hvp_stack_fwd(a["x"], a["tx"], a["wcat"], a["twcat"], a["b2d"], a["tb2d"],
                                m, keep, dt, res=(h_all, c_all, gates))
        th_last, th_all, tc_all, tgates = tfwd
        dx, dw, db, dgates, dh_all, dc_all = fh.stack_bwd(
            a["g"], a["x"], h_all, c_all, gates, a["wcat"], m, keep, dt)
        bwd_args = (a["g"], a["tg"], a["x"], a["tx"], h_all, th_all, c_all, tc_all, gates,
                    tgates, a["wcat"], a["twcat"], m, keep, dt)
        bwd_res = (dgates, dh_all, dc_all)
        tdx, tdw, tdb = fh.hvp_stack_bwd(*bwd_args, res=bwd_res)
        return ([h_last, h_all, c_all, dx, *dw, db],
                [th_last, th_all, tc_all, tgates, tdx, *tdw, tdb],
                ((h_all, c_all, gates), bwd_args, bwd_res))

    with Phase("second-order kernels vs plain"):
        for layers, dropout, rows in ((n_l, 0.2, n), (n_l, 0.0, n), (1, 0.0, n),
                                      (n_l, 0.2, n // 2), (n_l, 0.0, n // 2)):
            a = r_op_inputs(layers, dropout, 30 + layers, rows)
            for dt_name, tol in TOL.items():
                dt = getattr(torch, dt_name)
                got_p, got_t, pieces = r_ops(a, dt, True)
                ref_p, ref_t, _ = r_ops(a, dt, False)
                torch.cuda.synchronize()
                for i in range(3):  # the forward's outputs: rtol = atol
                    torch.testing.assert_close(got_p[i].float(), ref_p[i].float(),
                                               rtol=tol, atol=tol)
                fwd_err = max(float((g.float() - r.float()).abs().max())
                              for g, r in zip(got_p[:3], ref_p[:3]))
                rels_p = [rel_err(g, r) for g, r in zip(got_p[3:], ref_p[3:])]
                rels_t = [rel_err(g, r) for g, r in zip(got_t, ref_t)]
                abs_errs = [float((g.float() - r.float()).abs().max()) for g, r in zip(got_t, ref_t)]
                t_err = max(abs_errs)
                log(f"rows 10-11 {dt_name} L={layers} dropout {dropout} {rows} rows: forward "
                    f"max_abs_err "
                    f"{fwd_err:.3e} (tol {tol}); backward max|diff|/max|ref| {max(rels_p):.3e} "
                    f"(tol {tol}); tangents max|diff|/max|ref| {max(rels_t):.3e} (tol "
                    f"{HVP_TOL[dt_name]}) per output {[f'{r:.1e}' for r in rels_t]}, "
                    f"max_abs_err {t_err:.3e}")
                if max(rels_p) > tol or max(rels_t) > HVP_TOL[dt_name]:
                    raise RuntimeError(f"rows 10-11 {dt_name} L={layers} {rows} rows: error above "
                                       f"tolerance")
                if layers != n_l or dropout == 0.0 or rows != n:
                    continue
                # The main path's case: time each kernel (its wrapper, from
                # the primal residuals) and the plain R-operator.
                fwd_res, bwd_args, bwd_res = pieces
                m, keep = a["masks"], a["keep"]

                def row10():
                    fh.hvp_stack_fwd(a["x"], a["tx"], a["wcat"], a["twcat"], a["b2d"],
                                     a["tb2d"], m, keep, dt, res=fwd_res)

                def row11():
                    fh.hvp_stack_bwd(*bwd_args, res=bwd_res)

                def plain10():
                    fh.hvp_fwd_plain(a["x"], a["wcat"], a["b2d"], m, keep, dt, a["tx"],
                                     a["twcat"], a["tb2d"])

                h_all, th_all, c_all, tc_all, gates, tgates = bwd_args[4:10]

                def plain11():
                    fh.hvp_bwd_plain(a["g"], a["x"], h_all, c_all, gates, a["wcat"], m, keep,
                                     dt, a["tg"], a["tx"], th_all, tc_all, tgates, a["twcat"])

                # The plain versions loop over 96 stages in Python: 3 runs.
                times = {k: (cuda_ms(torch, f, reps), device_ms(torch, f, reps)) for k, f, reps in
                         (("row10", row10, REPEATS), ("row11", row11, REPEATS),
                          ("plain10", plain10, 3), ("plain11", plain11, 3))}
                log(f"rows 10-11 {dt_name} [24, 512, 256] L=4: CUDA events / device time "
                    f"(torch.profiler), ms: " + ", ".join(
                        f"{k} {e:.4f} / {d:.4f}" for k, (e, d) in times.items()) + f"  [{card}]")
                # Row 11 alone: its launches a call (per layer a tangent
                # recurrence, 2 gemm_nn and 4 gemm_tn), its device time by
                # CUDA graph replay, by part, the
                # host's time to enqueue a call.
                bwd = fh.hvp_stack_bwd
                before = (bwd.launches, bwd.recurrence_launches, bwd.gemm_nn_launches,
                          bwd.gemm_tn_launches, gemm_nn.launches, gemm_tn.launches)
                row11()
                core11 = {"calls": bwd.launches - before[0],
                          "recurrences": bwd.recurrence_launches - before[1],
                          "gemm_nn": bwd.gemm_nn_launches - before[2],
                          "gemm_tn": bwd.gemm_tn_launches - before[3],
                          "gemm_nn (all)": gemm_nn.launches - before[4],
                          "gemm_tn (all)": gemm_tn.launches - before[5]}
                want = {"calls": 1, "recurrences": n_l, "gemm_nn": 2 * n_l, "gemm_tn": 4 * n_l,
                        "gemm_nn (all)": 2 * n_l, "gemm_tn (all)": 4 * n_l}
                if core11 != want:
                    raise RuntimeError(f"row 11 launched {core11} a call, not {want}")
                with torch.no_grad():
                    row = {"call_ms": times["row11"][0], "device_ms": graph_ms(torch, row11),
                           "enqueue_ms": enqueue_ms(torch, row11),
                           "parts_ms": parts_ms(lambda p: fh.hvp_backward_schedule(
                               a["tg"], *bwd_args[2:], bwd_res, p), tangent=True),
                           "core_launches": core11}
                log(f"row 11 {dt_name} [24, 512, 256] L=4, masks 0.2, from rows 4, 10 and 5: the "
                    f"call {row['call_ms']:.4f} ms, device {row['device_ms']:.4f} ms (CUDA graph "
                    f"replay), {row['enqueue_ms']:.4f} ms to enqueue; by part (CUDA events, "
                    f"median of {REPEATS}): " + ", ".join(
                        f"{k} {v:.4f} ms" for k, v in row["parts_ms"].items())
                    + f"; launches a call {core11}  [{card}]")
                # Row 10 alone: its launches a call (per layer a gemm_nn
                # product and a tangent forward recurrence, from one C
                # call), its device time by CUDA graph replay, by
                # part, the host's time to enqueue a call.
                fwd = fh.hvp_stack_fwd
                before = (fwd.launches, fwd.recurrence_launches, fwd.gemm_nn_launches,
                          gemm_nn.launches)
                row10()
                core10 = {"calls": fwd.launches - before[0],
                          "recurrences": fwd.recurrence_launches - before[1],
                          "gemm_nn": fwd.gemm_nn_launches - before[2],
                          "gemm_nn (all)": gemm_nn.launches - before[3]}
                want = {"calls": 1, "recurrences": n_l, "gemm_nn": n_l, "gemm_nn (all)": n_l}
                if core10 != want:
                    raise RuntimeError(f"row 10 launched {core10} a call, not {want}")
                with torch.no_grad():
                    tan_fwd = {"call_ms": times["row10"][0], "device_ms": graph_ms(torch, row10),
                               "enqueue_ms": enqueue_ms(torch, row10),
                               "parts_ms": parts_ms(lambda p: fh.hvp_forward_schedule(
                                   a["x"], a["tx"], a["wcat"], a["twcat"], a["tb2d"], m, keep, dt,
                                   fwd_res, p), tangent_forward=True),
                               "core_launches": core10}
                log(f"row 10 {dt_name} [24, 512, 256] L=4, masks 0.2, from row 4: the call "
                    f"{tan_fwd['call_ms']:.4f} ms, device {tan_fwd['device_ms']:.4f} ms (CUDA "
                    f"graph replay), {tan_fwd['enqueue_ms']:.4f} ms to enqueue; by part (CUDA "
                    f"events, median of {REPEATS}): " + ", ".join(
                        f"{k} {v:.4f} ms" for k, v in tan_fwd["parts_ms"].items())
                    + f"; launches a call {core10}  [{card}]")
                if dt_name == "float32":
                    for name, k, plain, err in (
                            ("hvp_stack_fwd", "row10", "plain10", max(abs_errs[:4])),
                            ("hvp_stack_bwd", "row11", "plain11", max(abs_errs[4:]))):
                        measured[name] = {"max_abs_err": err, "ms": times[k][0],
                                          "plain_ms": times[plain][0], "library_ms": None,
                                          "profiler_ms": times[k][1]}
                    measured["hvp_stack_bwd"].update(
                        {k: v for k, v in row.items() if k != "call_ms"})
                    measured["hvp_stack_fwd"].update(
                        {k: v for k, v in tan_fwd.items() if k != "call_ms"})
                else:
                    row["ms"] = times["row11"][0]
                    row["profiler_ms"] = times["row11"][1]
                    bf16_row11 = row
                    tan_fwd["ms"] = times["row10"][0]
                    tan_fwd["profiler_ms"] = times["row10"][1]
                    bf16_row10 = tan_fwd
        measured["hvp_stack_bwd"]["bfloat16"] = bf16_row11
        measured["hvp_stack_fwd"]["bfloat16"] = bf16_row10
        # Bytes each function must move (inputs read once, outputs written
        # once) and its operations: row 10 the [tangent | primal] operands
        # against [W; tW], 2 dot units; row 11 the same in the backward plus
        # the weight-gradient tangents, 4 dot units.
        res_b = n_l * w_len * n * lh * 4  # one [L, T, B, H] float32 stream
        gate_b = 4 * res_b
        x_b = w_len * n * hid * 4
        fl = lstm_flops(n, w_len, hid, lh, n_l)
        masks_b = (n_l - 1) * w_len * n * lh
        measured["hvp_stack_fwd"].update(
            flops=2 * fl, bytes=2 * x_b + 2 * lstm_w_bytes + masks_b + 2 * res_b + gate_b
            + 2 * res_b + gate_b + n * lh * 4)
        measured["hvp_stack_bwd"].update(
            flops=4 * fl, bytes=2 * n * lh * 4 + 3 * gate_b + 6 * res_b + 2 * x_b + masks_b
            + 2 * lstm_w_bytes + x_b + gate_b + lstm_w_bytes)
        # A library yardstick would be one PyTorch call computing an LSTM
        # tangent: ask cuDNN's LSTM for a forward-mode derivative and for a
        # double backward.
        xr = x_rec.detach().clone().requires_grad_(True)
        probes = {}
        try:
            torch.func.jvp(lambda v: cudnn(v)[0], (xr,), (torch.ones_like(xr),))
            probes["forward-mode (torch.func.jvp)"] = "computed"
        except Exception as e:  # a refusal is the finding, not a failure
            probes["forward-mode (torch.func.jvp)"] = f"refused: {str(e).splitlines()[0][:160]}"
        try:
            out = cudnn(xr)[0].sum()
            (gx,) = torch.autograd.grad(out, xr, create_graph=True)
            torch.autograd.grad(gx.sum(), list(cudnn.parameters()))
            probes["double backward"] = "computed"
        except Exception as e:  # a refusal is the finding, not a failure
            probes["double backward"] = f"refused: {str(e).splitlines()[0][:160]}"
        log(f"cuDNN LSTM (torch.nn.LSTM on the card) second-order probes: {probes}")
        # Free the full-width residuals before the later phases' peak memory reads.
        del a, xr, pieces, got_p, got_t, ref_p, ref_t, fwd_res, bwd_args, bwd_res
        del h_all, th_all, c_all, tc_all, gates, tgates, row10, row11, plain10, plain11

    # Meta-training tasks at the reference width: 4 meta-training regions.
    data_cfg = DataConfig()
    regions = [get_region_data(box, data_cfg.train_years, data_cfg, tag="train",
                               name=f"region{i}")
               for i, box in enumerate(META_TRAIN_REGIONS[:4])]
    tasks = stage_tasks([b.task for b in build_meta_tasks(regions, cfg, meta_cfg, data_cfg)], dev)

    # 8. The FO meta-gradient, kernel route vs plain route.
    with Phase("meta-gradient kernel vs plain"):
        one_epoch = dataclasses.replace(meta_cfg, inner_epochs=1)
        micro = type(tasks)(*(f[:2] for f in tasks))
        for dt_name, tol in TOL.items():
            routes = {  # the plain route: plain stacks, the per-leaf clip + SGD
                "kernel": (ModelConfig(compute_dtype=dt_name), one_epoch),
                "plain": (ModelConfig(compute_dtype=dt_name, use_pallas_gcn=False,
                                      lstm_kernel="xla"),
                          dataclasses.replace(one_epoch, fused_inner_update=False)),
            }
            res = {}
            for route, (mc, mt) in routes.items():
                g = torch.Generator(device=dev).manual_seed(11)
                t0 = time.perf_counter()
                res[route] = task_batch_grad(model, micro, g, mc, mt)
                torch.cuda.synchronize()
                log(f"  {route} route {dt_name}: {time.perf_counter() - t0:.2f} s")
            (loss_k, grad_k), (loss_p, grad_p) = res["kernel"], res["plain"]
            loss_err = float((loss_k - loss_p).abs().max())
            rels = {k: rel_err(grad_k[k], grad_p[k]) for k in grad_k}
            worst = max(rels, key=rels.get)
            log(f"meta-gradient {dt_name}: per-task query losses {loss_k.tolist()} vs "
                f"{loss_p.tolist()} (max diff {loss_err:.3e}); gradient max|diff|/max|ref| "
                f"{rels[worst]:.3e} at {worst} (tol {tol})")
            torch.testing.assert_close(loss_k, loss_p, rtol=tol, atol=tol)
            if rels[worst] > tol:
                raise RuntimeError(f"meta-gradient {dt_name}: {worst} off by {rels[worst]:.3e}")

    # 8b. The SO meta-gradient, kernel route vs plain route: fhvp, the same
    # micro-batch and generator seed; the plain route's Hessian transpose is
    # jvp of the plain loss's gradient.
    with Phase("SO meta-gradient kernel vs plain"):
        so_epoch = dataclasses.replace(one_epoch, second_order=True)
        for dt_name, tol in HVP_TOL.items():
            res = {}
            fh.hvp_stack_fwd.launches = fh.hvp_stack_bwd.launches = 0
            for route, mc in (("kernel", ModelConfig(compute_dtype=dt_name)),
                              ("plain", plain_route(ModelConfig(compute_dtype=dt_name)))):
                g = torch.Generator(device=dev).manual_seed(11)
                t0 = time.perf_counter()
                res[route] = task_batch_grad(model, micro, g, mc, so_epoch)
                torch.cuda.synchronize()
                log(f"  {route} route {dt_name}: {time.perf_counter() - t0:.2f} s")
            steps = 2 * so_epoch.inner_batches
            if (fh.hvp_stack_fwd.launches, fh.hvp_stack_bwd.launches) != (steps, steps):
                raise RuntimeError(f"rows 10-11 launched {fh.hvp_stack_fwd.launches}, "
                                   f"{fh.hvp_stack_bwd.launches} times for {steps} inner steps")
            (loss_k, grad_k), (loss_p, grad_p) = res["kernel"], res["plain"]
            rels = {k: rel_err(grad_k[k], grad_p[k]) for k in grad_k}
            worst = max(rels, key=rels.get)
            log(f"SO meta-gradient {dt_name}: per-task query losses {loss_k.tolist()} vs "
                f"{loss_p.tolist()}; gradient max|diff|/max|ref| {rels[worst]:.3e} at {worst} "
                f"(tol {tol})")
            torch.testing.assert_close(loss_k, loss_p, rtol=TOL[dt_name], atol=TOL[dt_name])
            if rels[worst] > tol:
                raise RuntimeError(f"SO meta-gradient {dt_name}: {worst} off by {rels[worst]:.3e}")
        del res

    # 9. Meta-training through the CLI: the training path's main run.
    meta_dir = os.path.join(out_root, "meta_train")
    with Phase("meta-train CLI"):
        def meta_train(dt_name, epochs, *extra, out=None):
            out = out or dt_name
            argv = ["meta-train", *extra, "-o", f"out_dir={meta_dir}/{out}",
                    "-o", f"model.compute_dtype={dt_name}", "-o", f"meta.num_epochs={epochs}"]
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                if cli.main(argv) != 0:
                    raise RuntimeError(f"meta-train {argv} failed")
            log(f"meta-train {dt_name} {epochs} epochs {' '.join(extra)}: "
                f"{time.perf_counter() - t0:.1f} s; {buf.getvalue().strip()}")
            with open(os.path.join(meta_dir, out, "meta", "meta_log.jsonl")) as f:
                return [json.loads(line) for line in f]

        counters = (gcn_stack_train, lstm_stack_train)
        for fn in counters:
            fn.launches = fn.backward_launches = 0
        lstm_stack_train.backward_recurrence_launches = 0
        lstm_stack_train.backward_gemm_nn_launches = 0
        lstm_stack_train.backward_gemm_tn_launches = 0
        lstm_stack_train.forward_recurrence_launches = 0
        lstm_stack_train.forward_gemm_nn_launches = 0
        lstm_stack_train.plain_routes = 0
        gcn_stack_train.gemm_nn_launches = 0
        clip_sgd_update.launches = clip_sgd_update.batched_launches = 0
        per_step = meta_cfg.meta_batch * meta_cfg.inner_epochs * meta_cfg.inner_batches
        logs = {"float32": meta_train("float32", 2), "bfloat16": meta_train("bfloat16", 1)}
        if clip_sgd_update.launches != 3 * per_step:
            raise RuntimeError(f"clip_sgd_update launched {clip_sgd_update.launches} times in "
                               f"3 meta steps, not {per_step} a step")
        logs["float32"] = meta_train("float32", 3, "--resume")
        logs["per-leaf update"] = meta_train("float32", 1, "-o", "meta.fused_inner_update=false",
                                             out="per_leaf")
        if clip_sgd_update.launches != 4 * per_step:
            raise RuntimeError("the per-leaf inner update launched the clip + SGD kernel")
        train_launches = {}
        for fn in counters:
            train_launches[fn.__name__] = fn.launches
            train_launches[fn.__name__ + ".backward"] = fn.backward_launches
        train_launches["clip_sgd_update"] = clip_sgd_update.launches
        log(f"launches on the meta-training path (5 meta steps, 4 with the fused update): "
            f"{train_launches}")
        for name, count in train_launches.items():
            if count == 0:
                raise RuntimeError(f"{name} never launched on the meta-training path")
        # Row 5: 364 calls a meta step (4 tasks x 90 inner steps + 4 query
        # windows), each a recurrence, a gemm_nn and two gemm_tn launches a
        # layer; no call sent to the plain stack.
        forwards = meta_cfg.meta_batch * (meta_cfg.inner_epochs * meta_cfg.inner_batches + 1)
        row5 = (lstm_stack_train.backward_launches,
                lstm_stack_train.backward_recurrence_launches,
                lstm_stack_train.backward_gemm_nn_launches,
                lstm_stack_train.backward_gemm_tn_launches,
                lstm_stack_train.plain_routes)
        log(f"row 5 in 5 meta steps: {row5[0]} calls, {row5[1]} recurrence launches, "
            f"{row5[2]} gemm_nn launches, {row5[3]} gemm_tn launches; plain routes {row5[4]}")
        if row5 != (5 * forwards, 5 * forwards * n_l, 5 * forwards * n_l,
                    5 * forwards * 2 * n_l, 0):
            raise RuntimeError(f"row 5 launched {row5} in 5 meta steps, not {forwards} calls a "
                               f"step with {n_l} recurrences, {n_l} gemm_nn and {2 * n_l} "
                               f"gemm_tn launches each and no plain route")
        # Row 4: as many calls, each a gemm_nn and a forward recurrence
        # launch a layer.
        row4 = (lstm_stack_train.launches, lstm_stack_train.forward_recurrence_launches,
                lstm_stack_train.forward_gemm_nn_launches)
        log(f"row 4 in 5 meta steps: {row4[0]} calls, {row4[1]} recurrence launches, "
            f"{row4[2]} gemm_nn launches")
        if row4 != (5 * forwards, 5 * forwards * n_l, 5 * forwards * n_l):
            raise RuntimeError(f"row 4 launched {row4} in 5 meta steps, not {forwards} calls a "
                               f"step with {n_l} recurrences and {n_l} gemm_nn launches each")
        # Row 6: as many calls, each 2 gemm_nn launches a layer.
        row6 = (gcn_stack_train.launches, gcn_stack_train.gemm_nn_launches)
        log(f"row 6 in 5 meta steps: {row6[0]} calls, {row6[1]} gemm_nn launches")
        if row6 != (5 * forwards, 5 * forwards * 2 * cfg.gcn_layers):
            raise RuntimeError(f"row 6 launched {row6} in 5 meta steps, not {forwards} calls a "
                               f"step with {2 * cfg.gcn_layers} gemm_nn launches each")
        for name, records in logs.items():
            want = [1, 2, 3] if name == "float32" else [1]
            if [r["epoch"] for r in records] != want:
                raise RuntimeError(f"meta-train {name}: epochs {[r['epoch'] for r in records]}")
            for r in records:
                losses = [r["meta_loss"], *r["per_task_loss"]]
                if not np.isfinite(losses).all():
                    raise RuntimeError(f"meta-train {name}: non-finite loss {r}")
                log(f"  {name} epoch {r['epoch']}: meta_loss {r['meta_loss']:.6f}, tasks "
                    f"{r['task_indices']}, {r['epoch_seconds']:.2f} s  [{card}]")
        for name in ("float32", "bfloat16", "per_leaf"):
            for ckpt in ("ckpt_best", "ckpt_last", "ckpt_final"):
                if not os.path.isdir(os.path.join(meta_dir, name, "meta", ckpt)):
                    raise RuntimeError(f"meta-train {name}: no {ckpt}")
        mean = forecast("Moscow", "float32", os.path.join(meta_dir, "float32"))
        log(f"forecast Moscow from the meta-trained ckpt_best: t2m {mean[:, 2].round(2).tolist()}")

    # 9b. Second-order meta-training through the CLI: the SO path's main run,
    # MetaConfig() defaults (fhvp, 4 tasks x 90 inner steps, grad-accum 2).
    with Phase("SO meta-train CLI"):
        so = ("-o", "meta.second_order=true", "-o", f"meta.inner_epochs={SO_INNER_EPOCHS}")
        so_per_step = meta_cfg.meta_batch * SO_INNER_EPOCHS * meta_cfg.inner_batches
        for fn in counters:
            fn.launches = fn.backward_launches = 0
        fh.hvp_stack_fwd.launches = fh.hvp_stack_bwd.launches = 0
        bwd, fwd = fh.hvp_stack_bwd, fh.hvp_stack_fwd
        bwd.recurrence_launches = bwd.gemm_nn_launches = bwd.gemm_tn_launches = 0
        fwd.recurrence_launches = fwd.gemm_nn_launches = 0
        so_logs = {"float32": meta_train("float32", 1, *so, out="so_float32"),
                   "bfloat16": meta_train("bfloat16", 1, *so, out="so_bfloat16")}
        so_logs["float32"] = meta_train("float32", 2, *so, "--resume", out="so_float32")
        so_launches = {}
        for fn in counters:
            so_launches[fn.__name__] = fn.launches
            so_launches[fn.__name__ + ".backward"] = fn.backward_launches
        so_launches["hvp_stack_fwd"] = fh.hvp_stack_fwd.launches
        so_launches["hvp_stack_bwd"] = fh.hvp_stack_bwd.launches
        for row, fn, piece, each in ((10, fwd, "recurrence", n_l), (10, fwd, "gemm_nn", n_l),
                                     (11, bwd, "recurrence", n_l), (11, bwd, "gemm_nn", 2 * n_l),
                                     (11, bwd, "gemm_tn", 4 * n_l)):
            so_launches[f"row {row} {piece}"] = getattr(fn, f"{piece}_launches")
            if so_launches[f"row {row} {piece}"] != each * fn.launches:
                raise RuntimeError(f"row {row} launched {so_launches[f'row {row} {piece}']} of "
                                   f"its {piece} pieces in {fn.launches} calls, not {each} a "
                                   f"call")
        log(f"launches on the SO meta-training path (3 meta steps): {so_launches}")
        for name in ("hvp_stack_fwd", "hvp_stack_bwd"):
            if so_launches[name] != 3 * so_per_step:
                raise RuntimeError(f"{name} launched {so_launches[name]} times in 3 SO meta "
                                   f"steps, not {so_per_step} a step")
        for name, count in so_launches.items():
            if count == 0:
                raise RuntimeError(f"{name} never launched on the SO meta-training path")
        for name, records in so_logs.items():
            want = [1, 2] if name == "float32" else [1]
            if [r["epoch"] for r in records] != want:
                raise RuntimeError(f"SO meta-train {name}: epochs {[r['epoch'] for r in records]}")
            for r in records:
                if not np.isfinite([r["meta_loss"], *r["per_task_loss"]]).all():
                    raise RuntimeError(f"SO meta-train {name}: non-finite loss {r}")
                log(f"  SO {name} epoch {r['epoch']}: meta_loss {r['meta_loss']:.6f}, tasks "
                    f"{r['task_indices']}, {r['epoch_seconds']:.2f} s  [{card}]")

    # 9c. `lstm_kernel=auto` where no cluster holds Wh (float32 hidden 448,
    # past even a 16-block cluster): the plain stack in place of rows 4-5,
    # as the JAX package's `auto` takes its XLA scan where `stack_supported`
    # fails; the forced routes run their kernels there on streamed plans, as
    # JAX's forced routes bypass `stack_supported`. At hidden 320 a 16-block
    # cluster holds Wh: `cli meta-train` there runs rows 4-5 (the wide phase
    # holds each row there against its plain version), and at 448 under
    # `pallas_stack` rows 4-5 on streamed plans (the streamed phase, 9d).
    with Phase("auto at float32 hidden 448 and 320; forced routes at 448"):
        cfg448 = dataclasses.replace(cfg, lstm_hidden=448)
        state = init_meta_state(torch.Generator().manual_seed(1), cfg448, meta_cfg, device=dev)
        task = task_at(tasks, 0)
        params = list(state.params.parameters())

        def step448(mc):
            g = torch.Generator(device=dev).manual_seed(3)
            loss = masked_mse(apply_model(state.params, task.a_hat, task.support_x[0],
                                          task.koppen, mc, train=True, generator=g),
                              task.support_y[0], task.node_mask)
            return loss.detach(), torch.autograd.grad(loss, params)

        def counts_auto():
            train = lstm_stack_train
            return (train.launches, train.backward_launches, train.plain_routes)

        def counts_streamed(entry):
            return (entry.launches, entry.backward_launches, entry.streamed_launches,
                    entry.backward_streamed_launches)

        before = counts_auto()
        loss448, got = step448(cfg448)
        moved = tuple(a - b for a, b in zip(counts_auto(), before))
        loss_x, ref = step448(dataclasses.replace(cfg448, lstm_kernel="xla"))
        same = bool(loss448 == loss_x) and all(torch.equal(a, b) for a, b in zip(got, ref))
        log(f"train step float32 hidden 448, lstm_kernel=auto: loss {float(loss448):.6f}; rows "
            f"4 / 5 / plain routes {moved}; loss and every gradient equal to the plain "
            f"route's: {same}")
        if moved != (0, 0, 1) or not same or not torch.isfinite(loss448):
            raise RuntimeError(f"auto at float32 hidden 448: launches {moved}, equal to the "
                               f"plain route {same}, loss {float(loss448)}")
        # The forced routes, each entry's counts set to 0 just before its
        # step and read just after: rows 4-5 (one call each way), rows 14-15
        # under `_MERGED_GATES = False` (one call each way) and rows 18-19
        # (one a layer each way), every launch on a streamed plan, no plain
        # route. Rows 14-15 and 18-19's counts are their main-path launches
        # on the kernels line (rows 4-5's: the `meta-train` run below).
        def zero_streamed(entry):
            for attr in ("launches", "backward_launches", "streamed_launches",
                         "backward_streamed_launches"):
                setattr(entry, attr, 0)
            lstm_stack_train.plain_routes = 0

        streamed_main = {}
        for kernel, merged, entry, name, calls in (
                ("pallas_stack", True, lstm_stack_train, "lstm_stack_train", 1),
                ("pallas_stack", False, fls.lstm_stack_split, "lstm_stack_split", 1),
                ("pallas", True, lstm_recurrence, "lstm_recurrence", cfg448.lstm_layers)):
            zero_streamed(entry)
            fls._MERGED_GATES = merged
            try:
                loss_k, got_k = step448(dataclasses.replace(cfg448, lstm_kernel=kernel))
            finally:
                fls._MERGED_GATES = True
            moved = counts_streamed(entry)
            loss_err = abs(float(loss_k - loss_x)) / abs(float(loss_x))
            worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                        for a, b in zip(got_k, ref))
            log(f"train step float32 hidden 448, lstm_kernel={kernel}, _MERGED_GATES={merged}: "
                f"loss {float(loss_k):.6f} (rel {loss_err:.3e} from xla's), gradients "
                f"max|diff|/max|ref| {worst:.3e} (tol {TOL['float32']}); {name} launches "
                f"(forward, backward, streamed forward, streamed backward) {moved}; plain "
                f"routes {lstm_stack_train.plain_routes}")
            if (moved != (calls,) * 4 or lstm_stack_train.plain_routes
                    or loss_err > TOL["float32"] or worst > TOL["float32"]):
                raise RuntimeError(f"lstm_kernel={kernel} (_MERGED_GATES={merged}) at float32 "
                                   f"hidden 448: launches {moved}, loss {loss_err:.3e}, "
                                   f"gradients {worst:.3e}")
            if entry is not lstm_stack_train:
                streamed_main[f"{name}.streamed"] = moved[2]
                streamed_main[f"{name}.backward.streamed"] = moved[3]
        # The eval forward under the forced `pallas_stack` (row 2 on its
        # streamed plan), counted from zero, against the plain route's.
        lstm_stack_last_all.launches = lstm_stack_last_all.streamed_launches = 0
        lstm_stack_train.plain_routes = 0
        with torch.no_grad():
            eval_k, eval_x = (apply_model(state.params, task.a_hat, task.support_x[0],
                                          task.koppen, dataclasses.replace(cfg448, lstm_kernel=k),
                                          train=False) for k in ("pallas_stack", "xla"))
        row2 = (lstm_stack_last_all.launches, lstm_stack_last_all.streamed_launches,
                lstm_stack_train.plain_routes)
        eval_err = float((eval_k - eval_x).abs().max())
        log(f"eval forward float32 hidden 448, lstm_kernel=pallas_stack: row 2 launches / "
            f"streamed / plain routes {row2}; max_abs_err against xla {eval_err:.3e}")
        if row2 != (1, 1, 0):
            raise RuntimeError(f"eval forward at float32 hidden 448 under pallas_stack: {row2}")
        torch.testing.assert_close(eval_k, eval_x, rtol=TOL["float32"], atol=TOL["float32"])
        streamed_main["lstm_stack_last_all.streamed"] = row2[1]
        # Second order's fused inner gradient (fhvp) takes the plain loss's
        # gradient there, as the JAX package's fhvp takes its XLA loss's.
        aux = (task.support_x[0], task.support_y[0], task.a_hat, task.koppen, task.node_mask)
        so_masks = draw_masks(cfg448, torch.Generator(device=dev).manual_seed(4), aux[0])
        q = {k: v.detach() for k, v in state.params.named_parameters()}
        before = lstm_stack_train.plain_routes
        got_so = make_grad_loss_fused(state.params, cfg448)(q, aux, so_masks)
        so_moved = lstm_stack_train.plain_routes - before
        ref_so = torch.func.grad(support_loss(state.params, plain_route(cfg448)))(q, aux,
                                                                                  so_masks)
        same = all(torch.equal(got_so[k], ref_so[k]) for k in q)
        log(f"SO fused inner gradient float32 hidden 448: plain routes {so_moved}; equal to "
            f"the plain loss's gradient: {same}")
        if so_moved != 1 or not same:
            raise RuntimeError(f"SO at float32 hidden 448: plain routes {so_moved}, equal {same}")
        del state, task, params, got, ref, q, got_so, ref_so, got_k, eval_k, eval_x
        # The CLI at the defaults but the width 320 (16-block clusters): 1
        # float32 epoch (one meta step), its depth cut to 1 inner epoch (4 x
        # 15 inner steps and a query a task): rows 4-5 once a forward, no
        # plain route.
        lstm_stack_train.launches = lstm_stack_train.backward_launches = 0
        lstm_stack_train.plain_routes = 0
        records = meta_train("float32", 1, "-o", "model.lstm_hidden=320",
                             "-o", "meta.inner_epochs=1", out="h320")
        h320 = counts_auto()
        calls320 = meta_cfg.meta_batch * (meta_cfg.inner_batches + 1)
        log(f"meta-train -o model.lstm_hidden=320, 1 epoch of 1 inner epoch: rows 4 / 5 / "
            f"plain routes {h320}")
        if h320 != (calls320, calls320, 0) or not all(
                np.isfinite([r["meta_loss"], *r["per_task_loss"]]).all() for r in records):
            raise RuntimeError(f"meta-train at float32 hidden 320: launches {h320}, not "
                               f"({calls320}, {calls320}, 0); logs {records}")
        for r in records:
            log(f"  hidden 320 epoch {r['epoch']}: meta_loss {r['meta_loss']:.6f}, "
                f"{r['epoch_seconds']:.2f} s  [{card}]")
        # The same run at 448 under the forced `pallas_stack`: rows 4-5 on
        # streamed plans once a forward, counted from zero, no plain route.
        for attr in ("launches", "backward_launches", "streamed_launches",
                     "backward_streamed_launches", "plain_routes"):
            setattr(lstm_stack_train, attr, 0)
        records = meta_train("float32", 1, "-o", "model.lstm_hidden=448",
                             "-o", "model.lstm_kernel=pallas_stack",
                             "-o", "meta.inner_epochs=1", out="h448")
        h448 = (*counts_streamed(lstm_stack_train), lstm_stack_train.plain_routes)
        streamed_main.update({"lstm_stack_train.streamed": h448[2],
                              "lstm_stack_train.backward.streamed": h448[3]})
        log(f"meta-train -o model.lstm_hidden=448 -o model.lstm_kernel=pallas_stack, 1 epoch of "
            f"1 inner epoch: rows 4 / 5 / streamed 4 / streamed 5 / plain routes {h448}")
        if h448 != (calls320,) * 4 + (0,) or not all(
                np.isfinite([r["meta_loss"], *r["per_task_loss"]]).all() for r in records):
            raise RuntimeError(f"meta-train at float32 hidden 448 under pallas_stack: launches "
                               f"{h448}, not {(calls320,) * 4 + (0,)}; logs {records}")
        for r in records:
            log(f"  hidden 448 pallas_stack epoch {r['epoch']}: meta_loss {r['meta_loss']:.6f}, "
                f"per task {r['per_task_loss']}, {r['epoch_seconds']:.2f} s  [{card}]")

    # 9d. Every LSTM cluster recurrence on 16-block clusters, against its
    # plain version, at the widths only such a cluster holds Wh at.
    with Phase("16-block clusters"):
        wide = wide_cluster_phase(torch, dev, card)
    # ... and every LSTM row on streamed plans past them, with item 13's
    # three routes of the eval forward at float32 H 320 and 384.
    with Phase("streamed recurrences"):
        streamed = streamed_phase(torch, dev, card)

    # 10. Adaptation and the pipeline through the CLI, from the meta-trained
    # ckpt_best (float32); depth cut to 1-2 epochs, the width is the reference's.
    adapt_dir = os.path.join(meta_dir, "float32")
    with Phase("adapt + pipeline CLI"):
        def run_cli(argv):
            out, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = cli.main(argv)
            if rc != 0:
                raise RuntimeError(f"{argv} exited {rc}:\n{err.getvalue()[-3000:]}")
            return out.getvalue(), err.getvalue(), time.perf_counter() - t0

        for fn in (fused_gcn_stack, lstm_stack_last_all):
            fn.launches = 0
        for fn in counters:
            fn.launches = fn.backward_launches = 0
        for region, dt_name, epochs in (("Moscow", "float32", 2), ("Thailand", "float32", 1),
                                        ("Moscow", "bfloat16", 1)):
            out = adapt_dir if dt_name == "float32" else os.path.join(out_root, "adapt_bf16")
            _, _, secs = run_cli([
                "adapt", "--region", region,
                "--meta-ckpt", os.path.join(adapt_dir, "meta", "ckpt_best"),
                "-o", f"out_dir={out}", "-o", f"model.compute_dtype={dt_name}",
                "-o", f"adapt.epochs={epochs}"])
            side = load_meta(adapted_ckpt_path(out, region, boxes[region]))
            values = [side["val_mse"], *side["epoch_losses"]]
            if len(side["epoch_losses"]) != epochs or not np.isfinite(values).all():
                raise RuntimeError(f"adapt {region} {dt_name}: {values}")
            log(f"adapt {region} {dt_name} {epochs} epochs ({side['climate_zone']}): "
                f"{secs:.1f} s, epoch losses {side['epoch_losses']}, val_mse "
                f"{side['val_mse']:.6f}  [{card}]")
        out, err, _ = run_cli(["validate", "--region", "Moscow", "--no-plots",
                               "-o", f"out_dir={adapt_dir}"])
        results = json.loads(out)
        if "(adapted model)" not in err or not np.isfinite(results["average_mse"]):
            raise RuntimeError(f"validate Moscow did not score the adapted model: {err[-2000:]}")
        log(f"validate Moscow (adapted model): average_mse {results['average_mse']:.6f}")
        # validate at its defaults (plots): without matplotlib it must refuse,
        # naming --no-plots; with it both figures must be written.
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            try:
                run_cli(["validate", "--region", "Moscow", "-o", f"out_dir={adapt_dir}"])
            except ImportError as err:
                if "--no-plots" not in str(err):
                    raise RuntimeError(f"the ImportError does not name --no-plots: {err}")
                log(f"validate Moscow without --no-plots: matplotlib missing here, refused "
                    f"with an ImportError naming --no-plots ({err})")
            else:
                raise RuntimeError("validate without --no-plots ran where matplotlib is missing")
        else:
            run_cli(["validate", "--region", "Moscow", "-o", f"out_dir={adapt_dir}"])
            pngs = [os.path.join(adapt_dir, "validation", f"Moscow_{kind}.png")
                    for kind in ("temperature", "all_variables")]
            if not all(os.path.exists(p) and os.path.getsize(p) > 0 for p in pngs):
                raise RuntimeError(f"validate without --no-plots did not write {pngs}")
            log(f"validate Moscow without --no-plots: matplotlib present here, wrote {pngs}")
        _, err, secs = run_cli(["pipeline", "--regions", "Moscow;NewYork", "--no-plots",
                                "-o", f"out_dir={adapt_dir}", "-o", "adapt.epochs=1"])
        if ("using existing adapted model for Moscow" not in err
                or "[adapt:NewYork] saved" not in err):
            raise RuntimeError(f"pipeline did not reuse Moscow and adapt NewYork: {err[-3000:]}")
        log(f"pipeline Moscow (reused) + NewYork (adapted, 1 epoch): {secs:.1f} s; "
            + "; ".join(line.strip() for line in err.splitlines() if "avg_mse" in line))
        adapt_launches = {fn.__name__: fn.launches for fn in (fused_gcn_stack, lstm_stack_last_all)}
        for fn in counters:
            adapt_launches[fn.__name__] = fn.launches
            adapt_launches[fn.__name__ + ".backward"] = fn.backward_launches
        log(f"launches on the adaptation path: {adapt_launches}")
        for name, count in adapt_launches.items():
            if count == 0:
                raise RuntimeError(f"{name} never launched on the adaptation path")

        # One adaptation train step (batch 2: 48 GCN slices, 1024 LSTM rows)
        # and one epoch, float32, Moscow's data.
        spec = WindowSpec(cfg.window, cfg.horizon)
        moscow_adapt = get_region_data(boxes["Moscow"], data_cfg.adapt_years, data_cfg,
                                       tag="adapt", name="Moscow")
        koppen = max(moscow_adapt.koppen_code, 0)
        feats, _ = prepare_features(moscow_adapt)
        feats = torch.from_numpy(pad_nodes(feats, n)).to(dev)
        node_mask = torch.from_numpy(graph.node_mask).to(dev)
        tx, lr0 = adaptation_optimizer("Moscow")
        adapted = init_model(torch.Generator().manual_seed(4), cfg, device=dev)
        astate = SupervisedState(adapted, tx.init(dict(adapted.named_parameters())))
        train_step = make_train_step(cfg, tx)
        x, y = gather_batch(feats, [100, 101], spec)
        g = torch.Generator(device=dev).manual_seed(5)

        def adapt_step():
            nonlocal astate
            astate, _ = train_step(astate, x, y, a_hat, node_mask, koppen, lr0, g)

        ms = host_ms(torch, adapt_step)
        log(f"adaptation train step float32 (batch 2, forward + backward + clip + Adam): "
            f"{ms:.3f} ms  [{card}]")
        profile_steps(torch, adapt_step, "float32 adaptation train steps (batch 2)", card)
        train_idx, _ = contiguous_split(spec.num_samples(moscow_adapt.num_timesteps), 0.8, 1200)
        batches = (spec.window + train_idx).reshape(-1, 2)
        run_epoch = make_epoch_runner(cfg, tx, spec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        astate, losses = run_epoch(astate, feats, batches, a_hat, node_mask, koppen, lr0, g)
        torch.cuda.synchronize()
        default_epoch_s = time.perf_counter() - t0
        log(f"adaptation epoch float32 ({len(batches)} steps of batch 2): "
            f"{default_epoch_s:.3f} s, mean loss {float(losses.mean()):.6f}  [{card}]")
        del feats, astate, adapted

    # 11. Inner step, meta step, peak memory.
    with Phase("meta-step times"):
        for dt_name in TOL:
            mc = ModelConfig(compute_dtype=dt_name)
            state = init_meta_state(torch.Generator().manual_seed(1), mc, meta_cfg, device=dev)
            task = task_at(tasks, 0)
            named = sorted(state.params.named_parameters(), key=lambda kv: leaf_order(kv[0]))
            params = [p for _, p in named]
            g = torch.Generator(device=dev).manual_seed(2)

            def inner_step(fused):
                loss = masked_mse(apply_model(state.params, task.a_hat, task.support_x[0],
                                              task.koppen, mc, train=True, generator=g),
                                  task.support_y[0], task.node_mask)
                grads = torch.autograd.grad(loss, params)
                with torch.no_grad():
                    if fused:
                        clip_sgd_update(params, grads, meta_cfg.inner_lr, meta_cfg.clip_norm)
                        return
                    clipped, _ = clip_global_norm_tree(
                        dict(zip((k for k, _ in named), grads)), meta_cfg.clip_norm)
                    for k, p in named:
                        p.sub_(meta_cfg.inner_lr * clipped[k])

            for fused in (True, False):
                ms = host_ms(torch, lambda: inner_step(fused))
                log(f"inner step {dt_name} (forward + backward + clip + SGD, one window, "
                    f"{'fused' if fused else 'per-leaf'} update): {ms:.3f} ms  [{card}]")
            if dt_name == "float32":
                profile_steps(torch, lambda: inner_step(True),
                              "float32 inner steps (fused update)", card, host_rows=10)
            for fused in (True, False) if dt_name == "float32" else (True,):
                step = make_meta_step(mc, dataclasses.replace(meta_cfg, fused_inner_update=fused))
                torch.cuda.reset_peak_memory_stats(dev)

                def meta_step():
                    nonlocal state
                    state, _ = step(state, tasks, g)

                ms = host_ms(torch, meta_step, repeats=1)
                peak = torch.cuda.max_memory_allocated(dev) / 2**30
                log(f"meta step {dt_name} (4 tasks x 90 inner steps + query, grad-accum 2, "
                    f"{'fused' if fused else 'per-leaf'} update): {ms:.1f} ms, peak device "
                    f"memory {peak:.2f} GiB  [{card}]")
    # 11b. One SO inner step (the inner gradient, then its Hessian-vector
    # product through a backward with a fixed cotangent) and one SO meta step.
    with Phase("SO step times"):
        mc = ModelConfig()
        so_cfg = dataclasses.replace(meta_cfg, second_order=True)
        state = init_meta_state(torch.Generator().manual_seed(1), mc, so_cfg, device=dev)
        task = task_at(tasks, 0)
        inner_grad = make_so_grad(support_loss(state.params, mc),
                                  support_loss(state.params, plain_route(mc)), "fhvp",
                                  make_grad_loss_fused(state.params, mc))
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in state.params.named_parameters()}
        draw = np.random.default_rng(40)
        ct = [torch.from_numpy(draw.normal(size=v.shape).astype(np.float32)).to(dev)
              for v in p.values()]
        aux = (task.support_x[0], task.support_y[0], task.a_hat, task.koppen, task.node_mask)
        g = torch.Generator(device=dev).manual_seed(2)

        def so_inner_step():
            grads = inner_grad(p, aux, draw_masks(mc, g, aux[0]))
            torch.autograd.grad(list(grads.values()), list(p.values()), ct)

        ms = host_ms(torch, so_inner_step)
        log(f"SO inner step float32 (kernel-route gradient + fhvp Hessian-vector product, "
            f"one window): {ms:.3f} ms  [{card}]")
        profile_steps(torch, so_inner_step, "float32 SO inner steps", card)
        timed_so = dataclasses.replace(so_cfg, inner_epochs=TIMED_INNER_EPOCHS)
        step = make_meta_step(mc, timed_so)
        torch.cuda.reset_peak_memory_stats(dev)

        def so_meta_step():
            nonlocal state
            state, _ = step(state, tasks, g)

        ms = host_ms(torch, so_meta_step, repeats=1)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        log(f"SO meta step float32 (fhvp, 4 tasks x "
            f"{timed_so.inner_epochs * timed_so.inner_batches} inner steps + query, grad-accum "
            f"2): {ms:.1f} ms, peak device memory {peak:.2f} GiB  [{card}]")
    # 12. The node-sharded GCN sandwich (rows 12-13) vs plain at full width:
    # one layer's hw_full [N, W, hid] node-major, this rank's rows of the
    # Moscow adjacency, the model's bias and next weight, masks at rate 0.2.
    def shard_case(nl, has_next, has_mask, dt, seed):
        draw = np.random.default_rng(seed)
        hw = torch.from_numpy(draw.standard_normal((n, w_len, hid)).astype(np.float32))
        mask = None
        if has_mask:
            mask = torch.from_numpy((draw.uniform(size=(nl, w_len, hid)) >= 0.2)
                                    .astype(np.int8)).to(dev)
        a_rows = a_hat[:nl].contiguous()
        w_next = enc[1].w if has_next else None
        leaves = [hw.to(dev, dt), enc[0].b] + ([w_next] if has_next else [])

        def run(fn, xs):
            return fn(xs[0], a_rows, xs[1], xs[2] if has_next else None, mask, 0.8, dt)

        run.a_rows, run.mask = a_rows, mask
        return leaves, run

    def shard_graph(run, fn, leaves):
        xs = [t.detach().clone().requires_grad_(True) for t in leaves]
        out = run(fn, xs)
        out = out if isinstance(out, tuple) else (out,)
        cts = [torch.from_numpy(np.random.default_rng(3 + i).standard_normal(o.shape)
                                .astype(np.float32)).to(dev, o.dtype) for i, o in enumerate(out)]
        return out, xs, cts

    shard_routes = (("kernel", fgs.gcn_shard_layer), ("plain", fgs.shard_layer_plain))
    with Phase("GCN sandwich kernels vs plain"):
        for nl in (n, n // 2, n // 4):
            for has_next in (True, False):
                for has_mask in (True, False):
                    for dt_name, tol in TOL.items():
                        dt = getattr(torch, dt_name)
                        leaves, run = shard_case(nl, has_next, has_mask, dt, 50 + nl)
                        res = {}
                        for route, fn in shard_routes:
                            out, xs, cts = shard_graph(run, fn, leaves)
                            res[route] = ([o.detach() for o in out],
                                          torch.autograd.grad(out, xs, cts))
                        torch.cuda.synchronize()
                        (got, got_g), (ref, ref_g) = res["kernel"], res["plain"]
                        for g, r in zip(got, ref):
                            torch.testing.assert_close(g.float(), r.float(), rtol=tol, atol=tol)
                        fwd_err = max(float((g.float() - r.float()).abs().max())
                                      for g, r in zip(got, ref))
                        rels = [rel_err(g, r) for g, r in zip(got_g, ref_g)]
                        bwd_err = max(float((g.float() - r.float()).abs().max())
                                      for g, r in zip(got_g, ref_g))
                        log(f"rows 12-13 {dt_name} NL={nl} next={has_next} mask={has_mask}: "
                            f"forward max_abs_err {fwd_err:.3e} (tol {tol}); gradients "
                            f"max|diff|/max|ref| {max(rels):.3e} (tol {tol})")
                        if max(rels) > tol:
                            raise RuntimeError(f"rows 12-13 {dt_name} NL={nl}: gradient error "
                                               f"{max(rels):.3e}")
                        if has_next and nl > n // 4:
                            # Row 13 alone from each cotangent and both (the
                            # encoder sends g2 below its top layer, g1 at it),
                            # against its plain statement: the core's launches.
                            with torch.no_grad():
                                h_post, _ = fgs.shard_layer_plain(*leaves[:1], run.a_rows,
                                                                  leaves[1], leaves[2], run.mask,
                                                                  0.8, dt)
                            for cts13 in ("g2", "g1", "both"):
                                g1 = None if cts13 == "g2" else cts[0]
                                g2 = None if cts13 == "g1" else cts[1]
                                args13 = (g1, g2, h_post, run.a_rows, leaves[2], run.mask)
                                before = (gemm_nn.launches, gemm_tn.launches)
                                got13 = fgs.backward_schedule(*args13, 1.25, dt, dt,
                                                              fgt.CARD_PIECES)
                                core13 = (gemm_nn.launches - before[0],
                                          gemm_tn.launches - before[1])
                                ref13 = fgs.shard_bwd_plain(*args13, 0.8, dt, dt)
                                torch.cuda.synchronize()
                                rels13 = [0.0 if cts13 == "g1" and i == 2 and not r.any()
                                          else rel_err(g, r)
                                          for i, (g, r) in enumerate(zip(got13, ref13))]
                                log(f"row 13 {dt_name} NL={nl} mask={has_mask} from {cts13}: "
                                    f"max|diff|/max|ref| {max(rels13):.3e} (tol {tol}); gemm_nn, "
                                    f"gemm_tn launches {core13}")
                                want13 = {"g2": (2, 1), "g1": (1, 0), "both": (2, 1)}
                                if max(rels13) > tol or core13 != want13[cts13]:
                                    raise RuntimeError(f"row 13 {dt_name} NL={nl} from {cts13}: "
                                                       f"error {max(rels13):.3e}, launches "
                                                       f"{core13}")
                                del got13, ref13
                        if not (has_next and has_mask):
                            continue
                        # The main path's layer (a next layer, masks): time it.
                        times = {}
                        for route, fn in shard_routes:
                            with torch.no_grad():
                                fwd = cuda_ms(torch, lambda: run(fn, leaves))
                            out, xs, cts = shard_graph(run, fn, leaves)
                            bwd = cuda_ms(torch, lambda: torch.autograd.grad(
                                out, xs, cts, retain_graph=True))
                            times[route] = (fwd, bwd)
                        # Device times by graph replay (row 13 alone from both
                        # cotangents), the cuBLAS route's too; row 12's launches.
                        a_rows, mask, w_next = run.a_rows, run.mask, leaves[2]
                        with torch.no_grad():
                            h_post, _ = fgs.shard_layer_plain(*leaves[:1], a_rows, leaves[1],
                                                              w_next, mask, 0.8, dt)
                            g1, g2 = cts

                            def row13():
                                fgs.backward_schedule(g1, g2, h_post, a_rows, w_next, mask,
                                                      1.25, dt, dt, fgt.CARD_PIECES)

                            def row13_g2():  # the encoder's layers below the top
                                fgs.backward_schedule(None, g2, h_post, a_rows, w_next, mask,
                                                      1.25, dt, dt, fgt.CARD_PIECES)

                            def lib13():
                                fgs.shard_bwd_plain(g1, g2, h_post, a_rows, w_next, mask, 0.8,
                                                    dt, dt)

                            def lib13_g2():
                                fgs.shard_bwd_plain(None, g2, h_post, a_rows, w_next, mask, 0.8,
                                                    dt, dt)

                            before = gemm_nn.launches
                            run(fgs.gcn_shard_layer, leaves)
                            core12 = {"gemm_nn": gemm_nn.launches - before}
                            if core12 != {"gemm_nn": 2}:
                                raise RuntimeError(f"row 12 launched {core12} a call")
                            dev_ms = {
                                "row 12": graph_ms(torch, lambda: run(fgs.gcn_shard_layer, leaves)),
                                "cuBLAS row 12": graph_ms(
                                    torch, lambda: run(fgs.shard_layer_plain, leaves)),
                                "row 13": graph_ms(torch, row13),
                                "cuBLAS row 13": graph_ms(torch, lib13),
                                "row 13 from g2": graph_ms(torch, row13_g2),
                                "cuBLAS row 13 from g2": graph_ms(torch, lib13_g2)}
                            call13 = {"call_ms": cuda_ms(torch, row13),
                                      "host_ms": host_ms(torch, row13),
                                      "enqueue_ms": enqueue_ms(torch, row13),
                                      "g2 call_ms": cuda_ms(torch, row13_g2),
                                      "g2 enqueue_ms": enqueue_ms(torch, row13_g2),
                                      "library_call_ms": cuda_ms(torch, lib13),
                                      "g2 library_call_ms": cuda_ms(torch, lib13_g2)}
                        log(f"row 13 {dt_name} NL={nl} alone (both cotangents / g2): the call "
                            f"{call13['call_ms']:.4f} / {call13['g2 call_ms']:.4f} ms, host "
                            f"{call13['host_ms']:.4f} ms to a synchronize, "
                            f"{call13['enqueue_ms']:.4f} / {call13['g2 enqueue_ms']:.4f} ms to "
                            f"enqueue; cuBLAS {call13['library_call_ms']:.4f} / "
                            f"{call13['g2 library_call_ms']:.4f} ms  [{card}]")
                        log(f"rows 12-13 {dt_name} NL={nl}: device time by graph replay " +
                            ", ".join(f"{k} {v:.4f} ms" for k, v in dev_ms.items())
                            + f"; row 12 launches a call {core12}  [{card}]")
                        e = 4 if dt_name == "float32" else 2
                        hw_b, act_b = n * w_len * hid * e, nl * w_len * hid * e
                        fixed_b = 4 * nl * n + 4 * hid * hid + nl * w_len * hid
                        flops_f = 2 * nl * n * w_len * hid + 2 * nl * w_len * hid * hid
                        flops_b = 4 * nl * w_len * hid * hid + 2 * n * nl * w_len * hid
                        bytes_f = hw_b + fixed_b + 4 * hid + 2 * act_b
                        bytes_b = 3 * act_b + fixed_b + hw_b + 4 * hid * hid + 4 * hid
                        bf, bb = (bound_ms(bytes_f, flops_f, dt_name)[0],
                                  bound_ms(bytes_b, flops_b, dt_name)[0])
                        log(f"rows 12-13 {dt_name} NL={nl} [N {n}, W {w_len}, hid {hid}]: kernel "
                            f"forward {times['kernel'][0]:.4f} ms, backward "
                            f"{times['kernel'][1]:.4f} ms; plain (cuBLAS) forward "
                            f"{times['plain'][0]:.4f} ms, backward {times['plain'][1]:.4f} ms; "
                            f"bound {bf:.4f} / {bb:.4f} ms ({flops_f / 1e9:.2f} / "
                            f"{flops_b / 1e9:.2f} GFLOP)  [{card}]")
                        if dt_name == "float32" and nl == n:
                            measured["gcn_shard_layer"] = {
                                "max_abs_err": fwd_err, "ms": times["kernel"][0],
                                "plain_ms": times["plain"][0], "library_ms": times["plain"][0],
                                "bytes": bytes_f, "flops": flops_f,
                                "device_ms": dev_ms["row 12"],
                                "library_device_ms": dev_ms["cuBLAS row 12"],
                                "core_launches": core12}
                            measured["gcn_shard_layer.backward"] = {
                                "max_abs_err": bwd_err, "ms": times["kernel"][1],
                                "plain_ms": times["plain"][1], "library_ms": times["plain"][1],
                                "bytes": bytes_b, "flops": flops_b,
                                "device_ms": dev_ms["row 13"],
                                "library_device_ms": dev_ms["cuBLAS row 13"],
                                "call_ms": call13["call_ms"], "host_ms": call13["host_ms"],
                                "enqueue_ms": call13["enqueue_ms"],
                                "library_call_ms": call13["library_call_ms"],
                                "from_g2": {"call_ms": call13["g2 call_ms"],
                                            "device_ms": dev_ms["row 13 from g2"],
                                            "enqueue_ms": call13["g2 enqueue_ms"],
                                            "library_call_ms": call13["g2 library_call_ms"],
                                            "library_device_ms": dev_ms["cuBLAS row 13 from g2"]}}
                        if nl == n // 2 and dt_name == "float32":
                            measured["gcn_shard_layer.backward"]["by_nl"] = {nl: {
                                "device_ms": dev_ms["row 13"], "call_ms": call13["call_ms"],
                                "library_device_ms": dev_ms["cuBLAS row 13"]}}
                        if dt_name == "bfloat16" and nl == n:
                            measured["gcn_shard_layer.backward"]["bfloat16"] = {
                                "device_ms": dev_ms["row 13"], "call_ms": call13["call_ms"],
                                "library_device_ms": dev_ms["cuBLAS row 13"]}
                        if dt_name == "float32" and nl < n:
                            measured["gcn_shard_layer"].setdefault("by_nl", {})[nl] = {
                                "ms": times["kernel"][0], "device_ms": dev_ms["row 12"],
                                "library_ms": times["plain"][0],
                                "library_device_ms": dev_ms["cuBLAS row 12"]}
        del leaves, res, out, xs, cts

    # 13. Node-sharded meta-training on a 1 x 1 mesh: a NCCL group of one rank
    # in this process (the gathers are copies of one rank's rows).
    with Phase("node-sharded meta step (1 x 1 mesh)"):
        created_group = distributed.ensure_process_group("nccl")
        mesh = make_mesh_2d(1, 1, dev)
        nodrop = ModelConfig(gcn_dropout=0.0, lstm_dropout=0.0)
        before = fgs.gcn_shard_layer.launches
        loss_s, grad_s = make_shardmap_batch_grad(nodrop, one_epoch, mesh)(model, micro, None)
        shard_check_launches = fgs.gcn_shard_layer.launches - before
        loss_u, grad_u = task_batch_grad(model, micro, None, nodrop, one_epoch)
        torch.cuda.synchronize()
        rels = {k: rel_err(grad_s[k], grad_u[k]) for k in grad_u}
        worst = max(rels, key=rels.get)
        log(f"sharded (1 x 1) vs unsharded meta-gradient float32, dropout 0, 2 tasks x "
            f"{one_epoch.inner_batches} inner steps: per-task losses {loss_s.tolist()} vs "
            f"{loss_u.tolist()}; gradient max|diff|/max|ref| {rels[worst]:.3e} at {worst} "
            f"(tol {TOL['float32']}); rows 12-13 launched {shard_check_launches} times")
        torch.testing.assert_close(loss_s, loss_u, rtol=TOL["float32"], atol=TOL["float32"])
        if rels[worst] > TOL["float32"]:
            raise RuntimeError(f"sharded meta-gradient: {worst} off by {rels[worst]:.3e}")

        # The main path: one sharded meta step at MetaConfig() defaults.
        state = init_meta_state(torch.Generator().manual_seed(1), cfg, meta_cfg, device=dev)
        sharded_step = make_shardmap_meta_step_2d(cfg, meta_cfg, mesh)
        shard_counters = (fgs.gcn_shard_layer, gcn_stack_train, lstm_stack_train)
        for fn in shard_counters:
            fn.launches = fn.backward_launches = 0
        clip_sgd_update.launches = 0
        state, metrics = sharded_step(state, tasks, (7, 0))
        torch.cuda.synchronize()
        shard_launches = {"gcn_shard_layer": fgs.gcn_shard_layer.launches,
                          "gcn_shard_layer.backward": fgs.gcn_shard_layer.backward_launches,
                          "lstm_stack_train": lstm_stack_train.launches,
                          "lstm_stack_train.backward": lstm_stack_train.backward_launches,
                          "gcn_stack_train": gcn_stack_train.launches,
                          "clip_sgd_update": clip_sgd_update.launches}
        log(f"launches in one sharded meta step: {shard_launches}")
        forwards = meta_cfg.meta_batch * (meta_cfg.inner_epochs * meta_cfg.inner_batches + 1)
        want = {"gcn_shard_layer": cfg.gcn_layers * forwards,
                "gcn_shard_layer.backward": cfg.gcn_layers * forwards,
                "lstm_stack_train": forwards, "lstm_stack_train.backward": forwards,
                "gcn_stack_train": 0, "clip_sgd_update": per_step}
        if shard_launches != want:
            raise RuntimeError(f"sharded meta step launched {shard_launches}, not {want}")
        losses = metrics["per_task_loss"].tolist()
        if not np.isfinite(losses).all():
            raise RuntimeError(f"sharded meta step: non-finite losses {losses}")
        log(f"sharded meta step float32: per-task losses {losses}")

        # Sharded vs unsharded meta step of TIMED_INNER_EPOCHS inner epochs,
        # in turns (U, S, S, U).
        timed_cfg = dataclasses.replace(meta_cfg, inner_epochs=TIMED_INNER_EPOCHS)
        unsharded_step = make_meta_step(cfg, timed_cfg)
        timed_sharded = make_shardmap_meta_step_2d(cfg, timed_cfg, mesh)
        g = torch.Generator(device=dev).manual_seed(2)
        runs = {"unsharded": lambda: unsharded_step(state, tasks, g),
                "sharded": lambda: timed_sharded(state, tasks, (7, 1))}
        step_ms = {k: [] for k in runs}
        for name in ("unsharded", "sharded", "sharded", "unsharded"):
            step_ms[name].append(host_ms(torch, runs[name], repeats=1))
        log(f"meta step float32 ({TIMED_INNER_EPOCHS} inner epoch of "
            f"{meta_cfg.inner_batches} steps a task), host clock, in turns: " + ", ".join(
            f"{k} {v[0]:.1f} / {v[1]:.1f} ms" for k, v in step_ms.items())
            + f"; sharded / unsharded {sum(step_ms['sharded']) / sum(step_ms['unsharded']):.3f}"
            f"  [{card}]")

        t_l = [f[0] for f in shard_task_batch_2d(tasks, mesh)]
        t_l = type(tasks)(*t_l)
        named = sorted(state.params.named_parameters(), key=lambda kv: leaf_order(kv[0]))
        params = [p for _, p in named]

        def sharded_inner_step():
            preds = hybrid_local_forward(state.params, t_l.a_hat, t_l.support_x[0], t_l.koppen,
                                         cfg, mesh.sp_group, train=True, generator=g)
            loss = psum_masked_mse(preds, t_l.support_y[0], t_l.node_mask, mesh.sp_group)
            inner_sgd_update(named, all_reduce_tensors(param_grads(loss, params), mesh.sp_group),
                             meta_cfg)

        ms = host_ms(torch, sharded_inner_step)
        log(f"sharded inner step float32 (1 x 1 mesh, one window, fused update): {ms:.3f} ms  "
            f"[{card}]")
        profile_steps(torch, sharded_inner_step, "float32 sharded inner steps (1 x 1 mesh)", card,
                      host_rows=10)

        mesh_log = meta_train("float32", 1, "--mesh", out="mesh_dp")
        if not np.isfinite([mesh_log[0]["meta_loss"], *mesh_log[0]["per_task_loss"]]).all():
            raise RuntimeError(f"meta-train --mesh: {mesh_log}")
        log(f"meta-train --mesh (dp, world 1) epoch 1: meta_loss {mesh_log[0]['meta_loss']:.6f}, "
            f"tasks {mesh_log[0]['task_indices']}, {mesh_log[0]['epoch_seconds']:.2f} s  [{card}]")
        if created_group:
            torch.distributed.destroy_process_group()
        del state, sharded_step, unsharded_step, runs

    # 14. Two ranks on the one card, joined by gloo, through the CLI
    # (`two_ranks`).
    with Phase("two ranks on one card (gloo, sp 2)"):
        out = os.path.join(out_root, "mesh_sp2")
        os.makedirs(out)
        ranks = two_ranks(out, "-o", f"meta.inner_epochs={MESH_INNER_EPOCHS}")
        forwards = meta_cfg.meta_batch * (MESH_INNER_EPOCHS * RANK_INNER_BATCHES + 1)
        for rec in ranks:
            want = cfg.gcn_layers * forwards
            got = (rec["launches"]["gcn_shard_layer"], rec["launches"]["gcn_shard_layer.backward"])
            if got != (want, want):
                raise RuntimeError(f"rank {rec['rank']} launched rows 12-13 {got}, not {want}")
        with open(os.path.join(out, "meta", "meta_log.jsonl")) as f:
            rec = json.loads(f.readline())
        log(f"two ranks (dp 1 x sp 2, 256 rows each, gloo on one card), epoch 1 "
            f"({MESH_INNER_EPOCHS} inner epochs of {RANK_INNER_BATCHES} steps): meta_loss {rec['meta_loss']:.6f}, tasks "
            f"{rec['task_indices']}, {rec['epoch_seconds']:.2f} s  [{card}]")
    # 15. The LSTM kernel routes (rows 18-20) and the single GCN layer (row
    # 3) vs plain at full width, forward and every gradient.
    def grads_of(fn, inputs, params, seed):
        """(out, gradients of <out, fixed cotangent> w.r.t. inputs + params,
        the graph's pieces for a timed backward)."""
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        ct = torch.from_numpy(np.random.default_rng(seed).standard_normal(out.shape)
                              .astype(np.float32)).to(dev, out.dtype)
        grads = torch.autograd.grad(out, leaves + list(params), ct, retain_graph=True)
        return out.detach(), grads, (out, leaves + list(params), ct)

    def hold(name, runs, inputs, params, dt_name, tol, seed):
        """Kernel vs plain route: forward rtol = atol = tol, gradients
        max|diff| / max|ref| <= tol; -> (forward, gradient) max abs errors
        and each route's graph."""
        res = {route: grads_of(fn, inputs, params, seed) for route, fn in runs}
        torch.cuda.synchronize()
        (got, got_g, got_graph), (ref, ref_g, ref_graph) = res["kernel"], res["plain"]
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
        fwd_err = float((got.float() - ref.float()).abs().max())
        rels = [rel_err(g, r) for g, r in zip(got_g, ref_g)]
        bwd_err = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got_g, ref_g))
        log(f"{name} {dt_name}: forward max_abs_err {fwd_err:.3e} (tol {tol}); gradients "
            f"max|diff|/max|ref| {max(rels):.3e} (tol {tol}), per input "
            f"{[f'{r:.1e}' for r in rels]}")
        if max(rels) > tol:
            raise RuntimeError(f"{name} {dt_name}: gradient error {max(rels):.3e} > {tol}")
        return fwd_err, bwd_err, {"kernel": got_graph, "plain": ref_graph}

    def time_routes(runs, graphs, inputs):
        """{route: (forward ms with autograd on, backward ms)} by CUDA events."""
        times = {}
        for route, fn in runs:
            leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
            fwd = cuda_ms(torch, lambda: fn(*leaves))
            out, xs, ct = graphs[route]
            bwd = cuda_ms(torch, lambda: torch.autograd.grad(out, xs, ct, retain_graph=True))
            times[route] = (fwd, bwd)
        return times

    g4 = 4 * lh
    xp = torch.from_numpy(np.random.default_rng(60).standard_normal((w_len, n, g4))
                          .astype(np.float32)).to(dev)
    wh = lstm[0].wh
    x_gcn24 = torch.from_numpy(np.random.default_rng(62).standard_normal((w_len, n, hid))
                               .astype(np.float32)).to(dev)
    # 15a. The pipelined GEMM core (csrc/gemm_nn.cu) against gemm_nn_plain
    # at the products rows 3 and 15 give it: row 3's feature transform and
    # aggregation at both of its shapes; row 15's gate product (two operand
    # pairs, the second at a row offset of R) and input product (the mask
    # epilogue) at T = 24, R = 512, C = 256, H = 128. Each case is held
    # at rtol = atol = TOL and at max|diff| / max|ref| <= TOL.
    with Phase("GEMM core (gemm_nn) vs plain"), torch.no_grad():
        draw = np.random.default_rng(64)

        def drawn(shape, dtype=torch.float32, scale=1.0):
            return torch.from_numpy((draw.standard_normal(shape) * scale)
                                    .astype(np.float32)).to(dev, dtype)

        steps = w_len * n
        nn_mask = (drawn((steps, lh)) > -0.84).to(torch.int8)  # ~0.8 kept
        for dt_name, tol in TOL.items():
            dt = getattr(torch, dt_name)
            cases = []
            for xg, layer in ((x_gcn24, enc[1]), (x_gcn, enc[0])):
                hw = gemm_nn_plain(xg, layer.w, compute_dtype=dt, out_dtype=dt)
                cases += [
                    (f"row 3 transform {list(xg.shape)} @ {list(layer.w.shape)}", (xg, layer.w),
                     dict(out_dtype=dt)),
                    (f"row 3 aggregation [{n}, {n}] @ {list(hw.shape)}", (a_hat, hw),
                     dict(epilogue="bias_relu", bias=layer.b))]
            for k_in in (hid, lh):  # layer 0's input (x, float32), a layer above's (h)
                a_in = drawn((steps, k_in), torch.float32 if k_in == hid else dt)
                cases.append((
                    f"row 15 gates [{steps}, {k_in}] @ [{k_in}, {g4}] + h_prev "
                    f"[{steps - n}, {lh}] at row {n}",
                    (a_in, drawn((k_in, g4), scale=k_in ** -0.5)),
                    dict(a2=drawn((steps - n, lh), dt), b2=drawn((lh, g4), scale=lh ** -0.5),
                         row_offset=n, epilogue="gates", bias=drawn((g4,), scale=0.1))))
            dg = drawn((steps, g4), scale=0.01)
            cases += [
                (f"row 15 input gradient [{steps}, {g4}] @ [{g4}, {lh}] x mask",
                 (dg, drawn((g4, lh), scale=g4 ** -0.5)),
                 dict(epilogue="mask", mask=nn_mask, scale=1.25)),
                (f"row 15 input gradient [{steps}, {g4}] @ [{g4}, {hid}]",
                 (dg, drawn((g4, hid), scale=g4 ** -0.5)), {})]
            for label, (a_op, b_op), kw in cases:
                got = gemm_nn(a_op, b_op, compute_dtype=dt, **kw)
                ref = gemm_nn_plain(a_op, b_op, compute_dtype=dt, **kw)
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
                # Also relative to the output's own scale: the input products
                # are ~1e-2, below an absolute 5e-2, where a zero or wrong
                # output would pass assert_close alone (a zero one gives 1).
                rel = rel_err(got, ref)
                log(f"gemm_nn {dt_name} {label}: max_abs_err "
                    f"{float((got.float() - ref.float()).abs().max()):.3e}, max|diff|/max|ref| "
                    f"{rel:.3e} (tol {tol}; max|ref| {float(ref.float().abs().max()):.3e})")
                if not rel <= tol:
                    raise RuntimeError(f"gemm_nn {dt_name} {label}: max|diff|/max|ref| "
                                       f"{rel:.3e} > {tol}")
            del cases, dg
        del nn_mask

    with Phase("LSTM routes and GCN layer kernels vs plain"):
        for dt_name, tol in TOL.items():
            dt = getattr(torch, dt_name)
            # Rows 18-19: one layer's recurrence at the inner step's shape.
            runs = (("kernel", lambda a: lstm_recurrence(a, wh, compute_dtype=dt)),
                    ("plain", lambda a: lstm_recurrence_plain(a, wh, dt)))
            fwd_err, bwd_err, graphs = hold(f"rows 18-19 xp {list(xp.shape)}", runs, [xp], [wh],
                                            dt_name, tol, 61)
            times = time_routes(runs, graphs, [xp])
            log(f"rows 18-19 {dt_name} xp [24, 512, 512]: kernel forward {times['kernel'][0]:.4f} "
                f"ms, backward {times['kernel'][1]:.4f} ms; plain forward "
                f"{times['plain'][0]:.4f} ms, backward {times['plain'][1]:.4f} ms  [{card}]")
            # Row 19 alone, its call (one C call) from row 18's residuals:
            # dgates and dwh against the plain recurrence and a float64 dwh of
            # the same rounded operands; its launches a call (the TN core
            # once); by CUDA events, CUDA graph replay, part
            # and the host's time to enqueue it; cuBLAS on its dwh product
            # alone (h_prev^T @ dgates in the compute dtype) beside it.
            with torch.no_grad():
                wh19 = wh.detach()
                h19, c19, gates19 = lstm_scan.scan_forward(xp, wh19, dt, True)
                g19 = torch.from_numpy(np.random.default_rng(65).standard_normal(
                    (w_len, n, lh)).astype(np.float32)).to(dev)
                rec = lstm_recurrence
                before = (rec.backward_launches, rec.backward_gemm_tn_launches, gemm_tn.launches)
                dg19, dwh19 = lstm_scan.scan_backward(g19, h19, c19, gates19, wh19, dt)
                core19 = {"calls": rec.backward_launches - before[0],
                          "gemm_tn": rec.backward_gemm_tn_launches - before[1],
                          "gemm_tn (all)": gemm_tn.launches - before[2]}
                want = {"calls": 1, "gemm_tn": 1, "gemm_tn (all)": 1}
                if core19 != want:
                    raise RuntimeError(f"row 19 launched {core19} a call, not {want}")
                a19 = torch.cat([torch.zeros_like(h19[:1]), h19[:-1]]).reshape(-1, lh).to(dt)
                b19 = dg19.reshape(-1, g4).to(dt)
                rel19 = (rel_err(dg19, lstm_scan.scan_backward_plain(g19, gates19, c19, wh19, dt)),
                         rel_err(dwh19, a19.double().T @ b19.double()))
                log(f"row 19 {dt_name} alone: dgates, dwh max|diff|/max|ref| against the plain "
                    f"recurrence and a float64 dwh {rel19[0]:.2e}, {rel19[1]:.2e} (tol {tol}); "
                    f"launches a call {core19}")
                if max(rel19) > tol:
                    raise RuntimeError(f"row 19 {dt_name}: error {max(rel19):.3e} > {tol}")

                def row19():
                    lstm_scan.scan_backward(g19, h19, c19, gates19, wh19, dt)

                def cublas19():
                    return a19.T @ b19

                row19_t = {"call_ms": cuda_ms(torch, row19), "device_ms": graph_ms(torch, row19),
                           "enqueue_ms": enqueue_ms(torch, row19),
                           "parts_ms": parts_ms(lambda p: lstm_scan.scan_backward_schedule(
                               g19, h19, c19, gates19, wh19, dt, p), scan_backward=True),
                           "core_launches": core19, "dwh_cublas_ms": cuda_ms(torch, cublas19),
                           "dwh_cublas_device_ms": graph_ms(torch, cublas19)}
            log(f"row 19 {dt_name} xp [24, 512, 512]: the call {row19_t['call_ms']:.4f} ms, "
                f"device {row19_t['device_ms']:.4f} ms (CUDA graph replay), "
                f"{row19_t['enqueue_ms']:.4f} ms to enqueue; by part (CUDA events, median of "
                f"{REPEATS}; the rest is the schedule's glue): " + ", ".join(
                    f"{k} {v:.4f} ms" for k, v in row19_t["parts_ms"].items())
                + f"; cuBLAS on its dwh product alone {row19_t['dwh_cublas_ms']:.4f} ms (device "
                f"{row19_t['dwh_cublas_device_ms']:.4f})  [{card}]")
            del h19, c19, gates19, g19, dg19, dwh19, a19, b19
            # Row 18 alone (the training call: its gates kept): by CUDA events,
            # its device time by CUDA graph replay, the host's time to enqueue
            # it.
            with torch.no_grad():
                def row18():
                    lstm_scan.scan_forward(xp, wh.detach(), dt, True)

                row18_t = {"call_ms": cuda_ms(torch, row18), "device_ms": graph_ms(torch, row18),
                           "enqueue_ms": enqueue_ms(torch, row18)}
            log(f"row 18 {dt_name} xp [24, 512, 512]: the call {row18_t['call_ms']:.4f} ms, "
                f"device {row18_t['device_ms']:.4f} ms (CUDA graph replay), "
                f"{row18_t['enqueue_ms']:.4f} ms to enqueue  [{card}]")
            if dt_name == "float32":
                measured["lstm_recurrence"] = {
                    "max_abs_err": fwd_err, "ms": times["kernel"][0],
                    "plain_ms": times["plain"][0], "library_ms": None, **row18_t}
                measured["lstm_recurrence.backward"] = {
                    "max_abs_err": bwd_err, "ms": times["kernel"][1],
                    "plain_ms": times["plain"][1], "library_ms": None, **row19_t}
            else:
                measured["lstm_recurrence"]["bfloat16"] = row18_t
                measured["lstm_recurrence.backward"]["bfloat16"] = row19_t
            del graphs

            # Row 20: the eval stack (row 2's schedule, counted on its own
            # entry), at validate's 3 windows and at 1, each call gated on its
            # launches, by events, graph replay and enqueue beside cuDNN's
            # forward (phase 5) and row 2; its train-mode gradients (row 15's
            # schedule: the adaptation step at dropout 0) at 1 window.
            r20 = {}
            with torch.inference_mode():
                for rows in (3 * n, n):
                    xr = x_lstm[:rows]
                    got = eval_call(fused_lstm_last_hidden, xr, dt)
                    ref = lstm_stack_plain(lstm, xr, dt)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got, ref, rtol=tol, atol=tol)

                    def call20(xr=xr):
                        eval_call(fused_lstm_last_hidden, xr, dt)

                    t = {"max_abs_err": float((got - ref).abs().max()),
                         "ms": cuda_ms(torch, call20), "device_ms": graph_ms(torch, call20),
                         "enqueue_ms": enqueue_ms(torch, call20),
                         "plain_ms": cuda_ms(torch, lambda: lstm_stack_plain(lstm, xr, dt)),
                         "library_ms": cudnn_ms[(rows, dt_name)][0],
                         "library_device_ms": cudnn_ms[(rows, dt_name)][1]}
                    r20[rows] = t
                    log(f"row 20 {dt_name} [{rows}, 24, 256]: " + ", ".join(
                        f"{k} {v:.4g}" if k == "max_abs_err" else f"{k} {v:.4f}"
                        for k, v in t.items()) + f" (tol {tol}; library: cuDNN's forward)  "
                        f"[{card}]")
            row20_fn = fused_lstm_last_hidden
            before = (row20_fn.launches, row20_fn.backward_launches,
                      row20_fn.backward_gemm_tn_launches)
            runs = (("kernel", lambda a: fused_lstm_last_hidden(lstm, a, compute_dtype=dt)),
                    ("plain", lambda a: lstm_stack_plain(lstm, a, dt)))
            _, bwd_err20, graphs = hold(f"row 20 train mode x {[n, w_len, hid]}", runs,
                                        [x_lstm[:n]], lstm_params, dt_name, tol, 63)
            core20 = (row20_fn.launches - before[0], row20_fn.backward_launches - before[1],
                      row20_fn.backward_gemm_tn_launches - before[2])
            if core20 != (1, 1, 2 * n_l):
                raise RuntimeError(f"row 20's train-mode call launched (forwards, backwards, "
                                   f"gemm_tn) {core20}, not (1, 1, {2 * n_l})")
            times20 = time_routes(runs, graphs, [x_lstm[:n]])
            log(f"row 20 train mode {dt_name} [{n}, 24, 256]: forward {times20['kernel'][0]:.4f} "
                f"ms, backward {times20['kernel'][1]:.4f} ms (row 15's schedule); plain "
                f"{times20['plain'][0]:.4f} / {times20['plain'][1]:.4f} ms  [{card}]")
            del graphs
            r20 = {**r20[3 * n], "at_512": r20[n],
                     "train": {"rows": n, "forward_ms": times20["kernel"][0],
                               "backward_ms": times20["kernel"][1],
                               "max_abs_grad_err": bwd_err20}}
            if dt_name == "float32":
                measured["fused_lstm_last_hidden"] = r20
            else:
                measured["fused_lstm_last_hidden"]["bfloat16"] = r20

            # Row 3: one GCN layer, the encoder's layer 1 (256 -> 256) at one
            # window and its layer 0 (24 -> 256) at three.
            for label, layer, xg in (("[24, 512, 256] -> 256", enc[1], x_gcn24),
                                     ("[72, 512, 24] -> 256", enc[0], x_gcn)):
                runs = (("kernel", lambda h: fused_gcn_layer(layer, a_hat, h, compute_dtype=dt)),
                        ("plain", lambda h: torch.relu(
                            apply_gcn_layer(layer, a_hat, h, compute_dtype=dt))))
                fwd_err, bwd_err, graphs = hold(f"row 3 {label}", runs, [xg],
                                                [layer.w, layer.b], dt_name, tol, 64)
                if xg is not x_gcn24:
                    continue
                times = time_routes(runs, graphs, [xg])
                # The library call in the same dtype: cuBLAS products of the
                # rounded operands (bfloat16 on its tensor cores).
                ac, hc, wc = (t.to(dt) for t in (a_hat, xg, layer.w))

                def library():
                    return torch.relu(ac @ (hc @ wc) + layer.b)

                with torch.no_grad():
                    fwd_ms = {route: cuda_ms(torch, lambda: fn(xg)) for route, fn in runs}
                    lib_ms = cuda_ms(torch, library)
                    # Device time alone (CUDA graph replays): CUDA events
                    # around one call also time the host's launch work.
                    dev_ms = graph_ms(torch, lambda: runs[0][1](xg))
                    lib_dev_ms = graph_ms(torch, library)
                log(f"row 3 {dt_name} {label}: kernel forward {fwd_ms['kernel']:.4f} ms "
                    f"({times['kernel'][0]:.4f} with autograd on; device {dev_ms:.4f}), backward "
                    f"{times['kernel'][1]:.4f} ms; plain forward {fwd_ms['plain']:.4f} ms, "
                    f"backward {times['plain'][1]:.4f} ms; torch.relu(a @ (h @ w) + b) {dt_name} "
                    f"{lib_ms:.4f} ms (device {lib_dev_ms:.4f}; device times by CUDA graph "
                    f"replay)  [{card}]")
                row3 = {"max_abs_err": fwd_err, "ms": fwd_ms["kernel"],
                        "plain_ms": fwd_ms["plain"], "library_ms": lib_ms,
                        "device_ms": dev_ms, "library_device_ms": lib_dev_ms}
                if dt_name == "float32":
                    measured["fused_gcn_layer"] = row3
                else:
                    measured["fused_gcn_layer"]["bfloat16"] = row3
                del graphs, ac, hc, wc
        rec_flops = 2 * w_len * n * lh * g4
        rec_io = 4 * (w_len * n * g4 + lh * g4 + 2 * w_len * n * lh)  # xp, wh; h_all, c_all
        measured["lstm_recurrence"].update(flops=rec_flops, bytes=rec_io)
        # g, xp, h_all, c_all, wh in; dxp (= dgates), dwh out.
        measured["lstm_recurrence.backward"].update(
            flops=2 * rec_flops,
            bytes=4 * (w_len * n * lh + w_len * n * g4 + 2 * w_len * n * lh + lh * g4)
            + 4 * (w_len * n * g4 + lh * g4))
        measured["fused_lstm_last_hidden"].update(
            flops=measured["lstm_stack_last_all"]["flops"],
            bytes=measured["lstm_stack_last_all"]["bytes"])
        measured["fused_lstm_last_hidden"]["at_512"]["bound_ms"] = (
            measured["lstm_stack_last_all"]["at_512"]["bound_ms"])
        measured["fused_gcn_layer"].update(
            flops=2 * w_len * (n * hid * hid + n * n * hid),
            bytes=4 * (n * n + 2 * w_len * n * hid + hid * hid + hid))
        del xp, x_gcn24

    # 16. The LSTM routes through the CLI: the main runs of rows 18-20.
    with Phase("LSTM routes through the CLI"):
        for fn in (lstm_recurrence, lstm_stack_train):
            fn.launches = fn.backward_launches = 0
        lstm_recurrence.backward_gemm_tn_launches = 0
        fused_gcn_layer.launches = fused_gcn_layer.backward_launches = 0
        rec_logs = meta_train("float32", 1, "-o", "model.lstm_kernel=pallas", out="recurrence")
        route_launches = {
            "lstm_recurrence": lstm_recurrence.launches,
            "lstm_recurrence.backward": lstm_recurrence.backward_launches,
            "row 19 gemm_tn": lstm_recurrence.backward_gemm_tn_launches,
            "lstm_stack_train": lstm_stack_train.launches,
            "lstm_stack_train.backward": lstm_stack_train.backward_launches,
        }
        log(f"launches in one meta step with lstm_kernel=pallas: {route_launches}")
        forwards = meta_cfg.meta_batch * (meta_cfg.inner_epochs * meta_cfg.inner_batches + 1)
        want = {"lstm_recurrence": cfg.lstm_layers * forwards,
                "lstm_recurrence.backward": cfg.lstm_layers * forwards,
                "row 19 gemm_tn": cfg.lstm_layers * forwards,
                "lstm_stack_train": 0, "lstm_stack_train.backward": 0}
        if route_launches != want:
            raise RuntimeError(f"meta-train -o model.lstm_kernel=pallas launched "
                               f"{route_launches}, not {want}")
        for r in rec_logs:
            if not np.isfinite([r["meta_loss"], *r["per_task_loss"]]).all():
                raise RuntimeError(f"meta-train lstm_kernel=pallas: non-finite loss {r}")
            log(f"  lstm_kernel=pallas epoch {r['epoch']}: meta_loss {r['meta_loss']:.6f}, tasks "
                f"{r['task_indices']}, {r['epoch_seconds']:.2f} s  [{card}]")

        # The FO meta-gradient of one micro-batch on that route vs the plain route.
        for dt_name, tol in TOL.items():
            res = {}
            for route, mc, mt in (
                    ("kernel", ModelConfig(compute_dtype=dt_name, lstm_kernel="pallas"), one_epoch),
                    ("plain", ModelConfig(compute_dtype=dt_name, use_pallas_gcn=False,
                                          lstm_kernel="xla"),
                     dataclasses.replace(one_epoch, fused_inner_update=False))):
                g = torch.Generator(device=dev).manual_seed(11)
                res[route] = task_batch_grad(model, micro, g, mc, mt)
            torch.cuda.synchronize()
            (loss_k, grad_k), (loss_p, grad_p) = res["kernel"], res["plain"]
            rels = {k: rel_err(grad_k[k], grad_p[k]) for k in grad_k}
            worst = max(rels, key=rels.get)
            log(f"meta-gradient lstm_kernel=pallas {dt_name}: per-task query losses "
                f"{loss_k.tolist()} vs {loss_p.tolist()}; gradient max|diff|/max|ref| "
                f"{rels[worst]:.3e} at {worst} (tol {tol})")
            torch.testing.assert_close(loss_k, loss_p, rtol=tol, atol=tol)
            if rels[worst] > tol:
                raise RuntimeError(f"meta-gradient lstm_kernel=pallas {dt_name}: {worst} off by "
                                   f"{rels[worst]:.3e}")
        del res

        # One inner step on that route, timed and profiled (phase 11 times
        # the default route's).
        rec_cfg = ModelConfig(lstm_kernel="pallas")
        state = init_meta_state(torch.Generator().manual_seed(1), rec_cfg, meta_cfg, device=dev)
        task = task_at(tasks, 0)
        params = [p for _, p in sorted(state.params.named_parameters(),
                                       key=lambda kv: leaf_order(kv[0]))]
        g = torch.Generator(device=dev).manual_seed(2)

        def rec_inner_step():
            loss = masked_mse(apply_model(state.params, task.a_hat, task.support_x[0],
                                          task.koppen, rec_cfg, train=True, generator=g),
                              task.support_y[0], task.node_mask)
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                clip_sgd_update(params, grads, meta_cfg.inner_lr, meta_cfg.clip_norm)

        ms = host_ms(torch, rec_inner_step)
        log(f"inner step float32 with lstm_kernel=pallas (one window, fused update): "
            f"{ms:.3f} ms  [{card}]")
        profile_steps(torch, rec_inner_step, "float32 inner steps, lstm_kernel=pallas", card,
                      host_rows=6)
        del state, params

        # Serving with use_pallas_lstm: row 20, never row 2.
        row20 = ("-o", "model.use_pallas_lstm=true")
        fused_lstm_last_hidden.launches = lstm_stack_last_all.launches = 0
        served20 = {dt_name: forecast("Moscow", dt_name, serve_dir, "cuda", *row20)
                    for dt_name in TOL}
        validate("float32", *row20)
        serve20 = {"fused_lstm_last_hidden": fused_lstm_last_hidden.launches,
                   "lstm_stack_last_all": lstm_stack_last_all.launches}
        log(f"launches serving with use_pallas_lstm (2 forecasts, 1 validate): {serve20}")
        if serve20["fused_lstm_last_hidden"] == 0 or serve20["lstm_stack_last_all"] != 0:
            raise RuntimeError(f"use_pallas_lstm serving launched {serve20}")
        route_launches["fused_lstm_last_hidden"] = serve20["fused_lstm_last_hidden"]
        for dt_name, tol in TOL.items():
            ref = forecast("Moscow", dt_name, serve_dir, "cpu", *row20)
            np.testing.assert_allclose(served20[dt_name], ref, rtol=tol, atol=tol)
            log(f"forecast Moscow use_pallas_lstm {dt_name}: card vs plain route max_abs_err "
                f"{float(np.abs(served20[dt_name] - ref).max()):.3e} (tol {tol})")

        # Serving with lstm_kernel=pallas: one predict, a recurrence a layer.
        lstm_recurrence.launches = lstm_stack_last_all.launches = 0
        forecast("Moscow", "float32", serve_dir, "cuda", "-o", "model.lstm_kernel=pallas")
        if (lstm_recurrence.launches, lstm_stack_last_all.launches) != (cfg.lstm_layers, 0):
            raise RuntimeError(f"forecast -o model.lstm_kernel=pallas launched row 18 "
                               f"{lstm_recurrence.launches} times, row 2 "
                               f"{lstm_stack_last_all.launches}")
        log(f"forecast lstm_kernel=pallas: row 18 launched {lstm_recurrence.launches} times "
            f"in one predict")

        # Adaptation with use_pallas_lstm at dropout 0: row 20 in train mode,
        # its backward on row 15's schedule.
        fused_lstm_last_hidden.launches = lstm_stack_train.launches = 0
        fused_lstm_last_hidden.backward_launches = 0
        out = os.path.join(out_root, "adapt_row20")
        _, _, secs = run_cli([
            "adapt", "--region", "Moscow",
            "--meta-ckpt", os.path.join(adapt_dir, "meta", "ckpt_best"),
            "-o", f"out_dir={out}", "-o", "adapt.epochs=1", *row20,
            "-o", "model.lstm_dropout=0"])
        side = load_meta(adapted_ckpt_path(out, "Moscow", boxes["Moscow"]))
        values = [side["val_mse"], *side["epoch_losses"]]
        if not np.isfinite(values).all():
            raise RuntimeError(f"adapt use_pallas_lstm: {values}")
        log(f"adapt Moscow use_pallas_lstm lstm_dropout=0, 1 epoch: {secs:.1f} s, epoch losses "
            f"{side['epoch_losses']}, val_mse {side['val_mse']:.6f}; row 20 launched "
            f"{fused_lstm_last_hidden.launches} times, its backward (row 15's schedule) "
            f"{fused_lstm_last_hidden.backward_launches} ({len(batches)} train steps), row 4 "
            f"{lstm_stack_train.launches}  [{card}]")
        if (fused_lstm_last_hidden.launches < len(batches)
                or fused_lstm_last_hidden.backward_launches < len(batches)
                or lstm_stack_train.launches):
            raise RuntimeError("adapt with use_pallas_lstm did not train through row 20")
        # One adaptation epoch on each route in turns (row 20 at dropout 0,
        # the default route at dropout 0, again in reverse order), Moscow's
        # data, its depth cut to the first half of the epoch's steps,
        # beside phase 10's default epoch (dropout 0.2, every step).
        feats, _ = prepare_features(moscow_adapt)
        feats = torch.from_numpy(pad_nodes(feats, n)).to(dev)
        half = batches[:len(batches) // 2]
        epochs = {"use_pallas_lstm": [], "default": []}
        for route in ("use_pallas_lstm", "default", "default", "use_pallas_lstm"):
            mc = ModelConfig(lstm_dropout=0.0, use_pallas_lstm=route == "use_pallas_lstm")
            adapted = init_model(torch.Generator().manual_seed(4), mc, device=dev)
            astate = SupervisedState(adapted, tx.init(dict(adapted.named_parameters())))
            run_epoch = make_epoch_runner(mc, tx, spec)
            g = torch.Generator(device=dev).manual_seed(5)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            astate, losses = run_epoch(astate, feats, half, a_hat, node_mask, koppen, lr0, g)
            torch.cuda.synchronize()
            epochs[route].append(time.perf_counter() - t0)
            if not torch.isfinite(losses).all():
                raise RuntimeError(f"adaptation epoch on the {route} route: non-finite loss")
        ratio = min(epochs["use_pallas_lstm"]) / min(epochs["default"])
        log(f"adaptation epoch float32 at lstm_dropout=0, its first {len(half)} of "
            f"{len(batches)} steps of batch 2, in turns: use_pallas_lstm "
            f"{epochs['use_pallas_lstm']} s, default route {epochs['default']} s (ratio "
            f"{ratio:.3f}); the default route at dropout 0.2 (phase 10, every step) "
            f"{default_epoch_s:.3f} s  [{card}]")
        del feats, astate, adapted
        route_launches["fused_gcn_layer"] = fused_gcn_layer.launches  # on no path: 0

        # Float32 hidden 320, where a 16-block cluster holds Wh: `forecast`
        # under `lstm_kernel=auto` runs row 2 and under `use_pallas_lstm` row
        # 20, each on `eval_plan`'s streamed plan (the forecast's 512 rows:
        # item 13); at 448, where none does, both run the plain stack
        # (counted), rows 2, 14 and 20 never. Each matches `--device cpu`.
        # Row 20's count at 320 is its main-path launch on the kernels line's
        # streamed entry.
        eval_entries = (lstm_stack_last_all, fls.lstm_stack_split, fused_lstm_last_hidden)
        for hidden in (320, 448):
            wide_cfg = ModelConfig(lstm_hidden=hidden)
            serve_wide = os.path.join(out_root, f"serve{hidden}")
            save_checkpoint(
                os.path.join(serve_wide, "meta", "ckpt_best"),
                init_model(torch.Generator().manual_seed(9), wide_cfg, device=dev).state_dict(),
                {"schema": "wfstgcn-meta-v1",
                 "config": to_dict(ExperimentConfig(model=wide_cfg))},
            )
            width = ("-o", f"model.lstm_hidden={hidden}")
            for label, flags, want in (("auto", (), [1, 0, 0]),
                                       ("use_pallas_lstm", row20, [0, 0, 1])):
                want = want if hidden == 320 else [0, 0, 0]
                for fn in eval_entries:
                    fn.launches = fn.streamed_launches = 0
                lstm_stack_train.plain_routes = 0
                got = forecast("Moscow", "float32", serve_wide, "cuda", *width, *flags)
                counts = ([fn.launches for fn in eval_entries], lstm_stack_train.plain_routes,
                          [fn.streamed_launches for fn in eval_entries])
                ref = forecast("Moscow", "float32", serve_wide, "cpu", *width, *flags)
                err = float(np.abs(got - ref).max())
                log(f"forecast Moscow lstm_hidden={hidden} {label}: rows 2, 14, 20 launched "
                    f"{counts[0]} (on streamed plans {counts[2]}), plain routes {counts[1]}; "
                    f"card vs --device cpu max_abs_err {err:.3e}")
                if (counts[0] != want or counts[2] != want
                        or (counts[1] == 0) != (hidden == 320)):
                    raise RuntimeError(f"forecast lstm_hidden={hidden} {label}: rows 2, 14, 20 "
                                       f"{counts[0]}, streamed {counts[2]} (want {want}), plain "
                                       f"routes {counts[1]}")
                if hidden == 320 and label == "use_pallas_lstm":
                    streamed_main["fused_lstm_last_hidden.streamed"] = counts[2][2]
                np.testing.assert_allclose(got, ref, rtol=TOL["float32"], atol=TOL["float32"])
    # 17. The unmerged-gates stack (rows 14-15) and the task-batched stack
    # (rows 16-17) vs plain at full width: the inner step's LSTM (x [24,
    # 512, 256] time-major, 4 layers of 128), masks at rate 0.2 and off;
    # rows 16-17 at V = 2 (the default micro-batch) and V = 4 with distinct
    # weights a task.
    x_tbc = x_rec.transpose(0, 1)
    g_last = torch.from_numpy(np.random.default_rng(70).standard_normal((n, lh))
                              .astype(np.float32)).to(dev)
    split_w = [t.detach() for t in fls._split_weights(lstm)]

    def task_weights(nv, seed):
        draw = np.random.default_rng(seed)
        bound = 1.0 / lh ** 0.5
        return [torch.from_numpy(draw.uniform(-bound, bound, size=shape).astype(np.float32))
                .to(dev) for shape in ((nv, hid + lh, 4 * lh), (nv, n_l - 1, 2 * lh, 4 * lh),
                                       (nv, n_l, 4 * lh))]

    def tasks_alone(xs, weights, m, keep, dt, tol):
        """Rows 16 and 17 of V tasks alone, row 17 from row 16's residuals:
        row 16's four outputs against its schedule on the plain pieces and
        its launches a call, gated (from one C call: a gemm_nn and a forward
        recurrence a layer for all tasks), its recurrence plan;
        each by events and by graph replay, row 16 also by the host's time to
        enqueue a call and by part; row 17 by part and its launches of a
        call, gated: a recurrence, a gemm_nn and two gemm_tn launches a layer
        for all tasks."""
        nv = xs.shape[0]
        x_v = xs.transpose(1, 2).contiguous()
        g_v = g_last.expand(nv, -1, -1).contiguous()
        tasks = fls.lstm_stack_train_tasks
        with torch.no_grad():
            before = (tasks.launches, tasks.forward_gemm_nn_launches,
                      tasks.forward_recurrence_launches, gemm_nn.launches)
            res = fls.tasks_forward(x_v, m, keep, dt, *weights)
            core16 = {"calls": tasks.launches - before[0],
                      "gemm_nn": tasks.forward_gemm_nn_launches - before[1],
                      "recurrences": tasks.forward_recurrence_launches - before[2],
                      "gemm_nn (all)": gemm_nn.launches - before[3]}
            want = {"calls": 1, "gemm_nn": n_l, "recurrences": n_l, "gemm_nn (all)": n_l}
            if core16 != want:
                raise RuntimeError(f"row 16 launched {core16} a call, not {want}")
            ref = fls.tasks_forward_schedule(x_v, m, keep, dt, *weights, fls.FWD_PLAIN_PIECES)
            torch.cuda.synchronize()
            errs16 = {}
            for out_name, g, r in zip(("h_last", "h_all", "c_all", "gates"), res, ref):
                torch.testing.assert_close(g.float(), r.float(), rtol=tol, atol=tol,
                                           msg=f"row 16 {out_name}")
                errs16[out_name] = float((g.float() - r.float()).abs().max())
            del ref

            def row16():
                fls.tasks_forward(x_v, m, keep, dt, *weights)

            def row17():
                fls.tasks_backward(g_v, x_v, *res[1:], *weights[:2], m, keep, dt)

            before = (tasks.backward_recurrence_launches, tasks.backward_gemm_nn_launches,
                      tasks.backward_gemm_tn_launches)
            row17()
            core = {"recurrence": tasks.backward_recurrence_launches - before[0],
                    "gemm_nn": tasks.backward_gemm_nn_launches - before[1],
                    "gemm_tn": tasks.backward_gemm_tn_launches - before[2]}
            want = {"recurrence": n_l, "gemm_nn": n_l, "gemm_tn": 2 * n_l}
            if core != want:
                raise RuntimeError(f"row 17 launched {core} a call, not {want}")
            out = {"fwd": (cuda_ms(torch, row16), graph_ms(torch, row16)),
                   "fwd_enqueue": enqueue_ms(torch, row16),
                   "fwd_parts": parts_ms(lambda p: fls.tasks_forward_schedule(
                       x_v, m, keep, dt, *weights, p), forward=True),
                   "plan": fls.forward_plan(lh, n, dt.itemsize, fls._sms(dev), nv),
                   "core16": core16, "errs16": errs16,
                   "bwd": (cuda_ms(torch, row17), graph_ms(torch, row17)), "core": core,
                   "parts_ms": parts_ms(lambda p: fls.tasks_backward_schedule(
                       g_v, x_v, *res[1:], *weights[:2], m, keep, dt, p))}
        del res
        return out

    def tasks_route(kernel):
        if kernel:
            return lambda x, w0, wr, b, m, keep, dt: fls.lstm_stack_train_tasks(
                x, w0, wr, b, masks=m, keep=keep, compute_dtype=dt)
        return lambda x, w0, wr, b, m, keep, dt: fls.lstm_stack_tasks_plain(
            x, w0, wr, b, m, keep, dt)

    with Phase("unmerged-gates and task-batched LSTM kernels vs plain"):
        for dropout in (0.2, 0.0):
            m, keep = (lstm_masks, 0.8) if dropout else (None, 1.0)
            for dt_name, tol in TOL.items():
                dt = getattr(torch, dt_name)
                split = fls.lstm_stack_split
                with torch.no_grad():
                    got = fls.split_forward(x_tbc, *split_w, m, keep, dt)
                    ref = fls.split_forward_plain(x_tbc, *split_w, m, keep, dt)
                    # The eval forward (no residuals): its launches a call, a
                    # gemm_nn and a forward recurrence a layer from one C call.
                    before = (split.launches, split.forward_gemm_nn_launches,
                              split.forward_recurrence_launches, gemm_nn.launches)
                    last = fls.split_forward(x_tbc, *split_w, m, keep, dt, residuals=False)
                    core14 = {"calls": split.launches - before[0],
                              "gemm_nn": split.forward_gemm_nn_launches - before[1],
                              "recurrences": split.forward_recurrence_launches - before[2],
                              "gemm_nn (all)": gemm_nn.launches - before[3]}
                    want = {"calls": 1, "gemm_nn": n_l, "recurrences": n_l, "gemm_nn (all)": n_l}
                    if core14 != want or last[1] is not None:
                        raise RuntimeError(f"row 14 launched {core14} a call, not {want}")
                    res = ref[1:]  # both backwards start from the same residuals
                    got_b = fls.split_backward(g_last, x_tbc, *res, *split_w, m, keep, dt)
                    ref_b = fls.split_backward_plain(g_last, x_tbc, *res, *split_w, m, keep, dt)
                torch.cuda.synchronize()
                for a, b in zip(got, ref):
                    torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
                torch.testing.assert_close(last[0], ref[0], rtol=tol, atol=tol)
                fwd_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
                eval_err = float((last[0] - ref[0]).abs().max())
                rels = [rel_err(a, b) for a, b in zip(got_b, ref_b)]
                bwd_err = max(float((a - b).abs().max()) for a, b in zip(got_b, ref_b))
                log(f"rows 14-15 {dt_name} dropout {dropout}: forward (h_last, h_all, c_all) "
                    f"max_abs_err {fwd_err:.3e}, without residuals (h_last) {eval_err:.3e} (tol "
                    f"{tol}; launches a call {core14}); backward (dx, dwx0, dwxr, dwh, db) "
                    f"max|diff|/max|ref| {max(rels):.3e} (tol {tol}), per output "
                    f"{[f'{r:.1e}' for r in rels]}")
                if max(rels) > tol:
                    raise RuntimeError(f"rows 14-15 {dt_name}: gradient error {max(rels):.3e}")
                if not dropout:
                    continue
                with torch.no_grad():  # the main path's case (masks on): time it
                    times = {k: cuda_ms(torch, f, reps) for k, f, reps in (
                        ("row14", lambda: fls.split_forward(x_tbc, *split_w, m, keep, dt),
                         REPEATS),
                        ("row15", lambda: fls.split_backward(g_last, x_tbc, *res, *split_w, m,
                                                             keep, dt), REPEATS),
                        ("plain14", lambda: fls.split_forward_plain(x_tbc, *split_w, m, keep,
                                                                    dt), 3),
                        ("plain15", lambda: fls.split_backward_plain(g_last, x_tbc, *res,
                                                                     *split_w, m, keep, dt), 3))}
                    times["row15 device"] = graph_ms(torch, lambda: fls.split_backward(
                        g_last, x_tbc, *res, *split_w, m, keep, dt))

                    def row14():
                        fls.split_forward(x_tbc, *split_w, m, keep, dt)

                    times["row14 device"] = graph_ms(torch, row14)
                    times["row14 enqueue"] = enqueue_ms(torch, row14)
                # Rows 14 and 15's library calls in the same dtype, beside them:
                # cuDNN's LSTM forward (by events and by CUDA graph replay) and
                # backward at the same shapes (weights copied in).
                lib_lstm = cudnn if dt_name == "float32" else copy.deepcopy(cudnn).to(dt)
                xr = x_rec.detach().to(dt).requires_grad_(True)
                try:
                    with torch.no_grad():
                        times["cuDNN forward"] = cuda_ms(torch, lambda: lib_lstm(xr))
                    out = lib_lstm(xr)[0][:, -1]
                except RuntimeError as err:  # a yardstick only: say so and go on
                    log(f"torch.nn.LSTM (cuDNN) refused {dt_name}: {err}")
                    times["cuDNN forward"] = times["cuDNN backward"] = None
                else:
                    ct = torch.ones_like(out)
                    times["cuDNN backward"] = cuda_ms(torch, lambda: torch.autograd.grad(
                        out, [xr, *lib_lstm.parameters()], ct, retain_graph=True))
                    times["cuDNN backward device"] = cudnn_backward_device_ms(torch, out, xr,
                                                                              lib_lstm, ct)
                    del out, ct
                    try:
                        with torch.no_grad():
                            times["cuDNN forward device"] = graph_ms(torch, lambda: lib_lstm(xr))
                    except RuntimeError as err:  # a yardstick only: say so and go on
                        log(f"cuDNN's LSTM forward in a CUDA graph refused: {err}")
                del lib_lstm, xr
                x_c = x_tbc.contiguous()
                parts = parts_ms(lambda p: fls.split_backward_schedule(
                    g_last, x_c, *res, *split_w, m, keep, dt, p))
                log(f"rows 14-15 {dt_name} [24, 512, 256] L=4, ms: " + ", ".join(
                    f"{k} {v if v is None else f'{v:.4f}'}" for k, v in times.items())
                    + f"  [{card}]")
                log(f"row 15 {dt_name} by part (CUDA events, median of {REPEATS}; the rest is "
                    f"the schedule's glue): " + ", ".join(f"{k} {v:.4f} ms"
                                                          for k, v in parts.items())
                    + f"  [{card}]")
                row = {"max_abs_err": bwd_err, "ms": times["row15"],
                       "plain_ms": times["plain15"], "library_ms": times["cuDNN backward"],
                       "library_device_ms": times.get("cuDNN backward device"),
                       "device_ms": times["row15 device"], "parts_ms": parts}
                row14 = {"ms": times["row14"], "device_ms": times["row14 device"],
                         "enqueue_ms": times["row14 enqueue"],
                         "library_ms": times["cuDNN forward"],
                         "library_device_ms": times.get("cuDNN forward device"),
                         "core_launches": core14}
                if dt_name == "float32":
                    measured["lstm_stack_split"] = {
                        "max_abs_err": max(fwd_err, eval_err), "plain_ms": times["plain14"],
                        **row14}
                    measured["lstm_stack_split.backward"] = row
                else:
                    measured["lstm_stack_split"]["bfloat16"] = row14
                    measured["lstm_stack_split.backward"]["bfloat16"] = row
        del got, ref, res, got_b, ref_b

        for nv in (2, 4):
            xs = torch.from_numpy(np.random.default_rng(80 + nv).standard_normal(
                (nv, n, w_len, hid)).astype(np.float32)).to(dev)
            weights = task_weights(nv, 90 + nv)
            gen = torch.Generator(device=dev).manual_seed(nv)
            for dropout in (0.2, 0.0):
                m = draw_mask(gen, (nv, n_l - 1, w_len, n, lh), dropout, dev) if dropout else None
                keep = 1.0 - dropout
                for dt_name, tol in TOL.items():
                    dt = getattr(torch, dt_name)
                    graphs, outs = {}, {}
                    for route in ("kernel", "plain"):
                        leaves = [t.detach().clone().requires_grad_(True) for t in (xs, *weights)]
                        out = tasks_route(route == "kernel")(*leaves, m, keep, dt)
                        ct = torch.from_numpy(np.random.default_rng(1).standard_normal(
                            out.shape).astype(np.float32)).to(dev)
                        outs[route] = (out.detach(),
                                       torch.autograd.grad(out, leaves, ct, retain_graph=True))
                        graphs[route] = (out, leaves, ct)
                    torch.cuda.synchronize()
                    (got, got_g), (ref, ref_g) = outs["kernel"], outs["plain"]
                    torch.testing.assert_close(got, ref, rtol=tol, atol=tol)
                    fwd_err = float((got - ref).abs().max())
                    rels = [rel_err(a, b) for a, b in zip(got_g, ref_g)]
                    bwd_err = max(float((a - b).abs().max()) for a, b in zip(got_g, ref_g))
                    log(f"rows 16-17 {dt_name} V={nv} dropout {dropout}: forward max_abs_err "
                        f"{fwd_err:.3e} (tol {tol}); gradients (x, wcat0, wcatr, b2d) "
                        f"max|diff|/max|ref| {max(rels):.3e} (tol {tol}), per input "
                        f"{[f'{r:.1e}' for r in rels]}")
                    if max(rels) > tol:
                        raise RuntimeError(f"rows 16-17 {dt_name} V={nv}: gradient error "
                                           f"{max(rels):.3e}")
                    if not dropout:
                        del graphs, outs
                        continue
                    times = {}
                    for route in ("kernel", "plain"):
                        fn = tasks_route(route == "kernel")
                        with torch.no_grad():
                            fwd = cuda_ms(torch, lambda: fn(xs, *weights, m, keep, dt),
                                          REPEATS if route == "kernel" else 3)
                        out, leaves, ct = graphs[route]
                        bwd = cuda_ms(torch, lambda: torch.autograd.grad(
                            out, leaves, ct, retain_graph=True),
                            REPEATS if route == "kernel" else 3)
                        times[route] = (fwd, bwd)
                    del graphs, outs
                    log(f"rows 16-17 {dt_name} V={nv} [{nv} x 512, 24, 256] L=4: kernel forward "
                        f"{times['kernel'][0]:.4f} ms, backward {times['kernel'][1]:.4f} ms; "
                        f"plain forward {times['plain'][0]:.4f} ms, backward "
                        f"{times['plain'][1]:.4f} ms  [{card}]")
                    if nv == 2:  # rows 16-17 alone, from the same residuals
                        alone = tasks_alone(xs, weights, m, keep, dt, tol)
                        cs, hcp, rb, _ = alone["plan"]
                        log(f"row 16 {dt_name} V=2 [2 x 512, 24, 256] L=4 alone against its "
                            f"schedule on the plain pieces: max_abs_err " + ", ".join(
                                f"{k} {v:.2e}" for k, v in alone["errs16"].items())
                            + f" (tol {tol}); launches a call {alone['core16']}; recurrence "
                            f"plan (forward_plan, 2 tasks): cluster of {cs}, {hcp} weight "
                            f"columns, {rb} rows a cluster, {2 * -(-n // rb) * cs} blocks a "
                            f"layer; the call {alone['fwd'][0]:.4f} ms, device "
                            f"{alone['fwd'][1]:.4f} ms (CUDA graph replay), "
                            f"{alone['fwd_enqueue']:.4f} ms to enqueue; by part (CUDA events, "
                            f"median of {REPEATS}): " + ", ".join(
                                f"{k} {v:.4f} ms" for k, v in alone["fwd_parts"].items())
                            + f"  [{card}]")
                        log(f"rows 16-17 {dt_name} V=2 alone (call by events / device by graph "
                            f"replay): row 16 {alone['fwd'][0]:.4f} / {alone['fwd'][1]:.4f} ms, "
                            f"row 17 {alone['bwd'][0]:.4f} / {alone['bwd'][1]:.4f} ms; row 17 "
                            f"by part (CUDA events, median of {REPEATS}): " + ", ".join(
                                f"{k} {v:.4f} ms" for k, v in alone["parts_ms"].items())
                            + f"; row 17 launches a call {alone['core']}  [{card}]")
                    if dt_name != "float32":
                        if nv == 2:
                            measured["lstm_stack_train_tasks"]["bfloat16"] = {
                                "call_ms": alone["fwd"][0], "device_ms": alone["fwd"][1],
                                "enqueue_ms": alone["fwd_enqueue"],
                                "parts_ms": alone["fwd_parts"], "plan": alone["plan"]}
                            measured["lstm_stack_train_tasks.backward"]["bfloat16"] = {
                                "ms": times["kernel"][1], "call_ms": alone["bwd"][0],
                                "device_ms": alone["bwd"][1], "parts_ms": alone["parts_ms"]}
                        continue
                    # Yardstick: cuDNN's LSTM once a task (its weights copied in
                    # from the model's; the time does not depend on them).
                    xr = xs.detach().clone().requires_grad_(True)
                    with torch.no_grad():
                        lib_fwd = cuda_ms(torch, lambda: [cudnn(xr[v]) for v in range(nv)])
                    lib_out = torch.stack([cudnn(xr[v])[0][:, -1] for v in range(nv)])
                    lib_ct = torch.ones_like(lib_out)
                    lib_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
                        lib_out, [xr, *cudnn.parameters()], lib_ct, retain_graph=True))
                    del xr, lib_out, lib_ct
                    log(f"torch.nn.LSTM (cuDNN) float32, once a task x {nv}: forward "
                        f"{lib_fwd:.4f} ms, backward {lib_bwd:.4f} ms  [{card}]")
                    if nv == 2:
                        measured["lstm_stack_train_tasks"] = {
                            "max_abs_err": fwd_err, "ms": times["kernel"][0],
                            "plain_ms": times["plain"][0], "library_ms": lib_fwd,
                            "call_ms": alone["fwd"][0], "device_ms": alone["fwd"][1],
                            "enqueue_ms": alone["fwd_enqueue"], "parts_ms": alone["fwd_parts"],
                            "core_launches": alone["core16"], "plan": alone["plan"]}
                        measured["lstm_stack_train_tasks.backward"] = {
                            "max_abs_err": bwd_err, "ms": times["kernel"][1],
                            "plain_ms": times["plain"][1], "library_ms": lib_bwd,
                            "call_ms": alone["bwd"][0], "device_ms": alone["bwd"][1],
                            "parts_ms": alone["parts_ms"], "core_launches": alone["core"]}
            del xs, weights
        tasks_at_path_shapes(torch, dev, n, w_len, hid, lh, n_l)
        # Rows 14 and 16 do row 4's work (x V for row 16), rows 15 and 17 row
        # 5's (its recomputed forward not counted): the same operations and
        # the same bytes in and out.
        row4, row5 = measured["lstm_stack_train"], measured["lstm_stack_train.backward"]
        measured["lstm_stack_split"].update(flops=row4["flops"], bytes=row4["bytes"])
        measured["lstm_stack_split.backward"].update(flops=row5["flops"], bytes=row5["bytes"])
        measured["lstm_stack_train_tasks"].update(flops=2 * row4["flops"],
                                                  bytes=2 * row4["bytes"])
        measured["lstm_stack_train_tasks.backward"].update(flops=2 * row5["flops"],
                                                           bytes=2 * row5["bytes"])
        for name in ("lstm_stack_split", "lstm_stack_split.backward", "lstm_stack_train_tasks",
                     "lstm_stack_train_tasks.backward"):
            b, by = bound_ms(measured[name]["bytes"], measured[name]["flops"])
            log(f"{name}: bound {b:.4f} ms (by {by}; {measured[name]['flops'] / 1e9:.2f} GFLOP)")
        del x_tbc, g_last

    # 18. The task-batched meta step (`_VBATCH`): the lockstep FO
    # meta-gradient of one micro-batch kernel vs plain route, `meta-train`
    # at the defaults (the main path of rows 16-17 and 9), one lockstep
    # inner step and the lockstep meta step against the serial one.
    def lockstep_counts():
        tasks = fls.lstm_stack_train_tasks
        return {"lstm_stack_train_tasks": tasks.launches,
                "row 16 gemm_nn": tasks.forward_gemm_nn_launches,
                "row 16 recurrence": tasks.forward_recurrence_launches,
                "lstm_stack_train_tasks.backward": tasks.backward_launches,
                "row 17 recurrence": tasks.backward_recurrence_launches,
                "row 17 gemm_nn": tasks.backward_gemm_nn_launches,
                "row 17 gemm_tn": tasks.backward_gemm_tn_launches,
                "clip_sgd_update.batched": clip_sgd_update.batched_launches,
                "clip_sgd_update": clip_sgd_update.launches,
                "lstm_stack_train": lstm_stack_train.launches,
                "lstm_stack_train.backward": lstm_stack_train.backward_launches,
                "gcn_stack_train": gcn_stack_train.launches}

    def zero_counts():
        for fn in (fls.lstm_stack_train_tasks, lstm_stack_train, gcn_stack_train,
                   fls.lstm_stack_split):
            fn.launches = fn.backward_launches = 0
        split = fls.lstm_stack_split
        split.forward_gemm_nn_launches = split.forward_recurrence_launches = 0
        split.backward_gemm_tn_launches = 0
        clip_sgd_update.launches = clip_sgd_update.batched_launches = 0
        lstm_stack_last_all.launches = 0
        gemm_nn.launches = 0
        tasks = fls.lstm_stack_train_tasks
        tasks.backward_recurrence_launches = tasks.backward_gemm_nn_launches = 0
        tasks.backward_gemm_tn_launches = 0
        tasks.forward_gemm_nn_launches = tasks.forward_recurrence_launches = 0

    with Phase("_VBATCH: the lockstep meta step"):
        fls._VBATCH = True
        try:
            for dt_name, tol in TOL.items():
                res = {}
                for route, mc, mt in (
                        ("kernel", ModelConfig(compute_dtype=dt_name), one_epoch),
                        ("plain", ModelConfig(compute_dtype=dt_name, use_pallas_gcn=False,
                                              lstm_kernel="xla"),
                         dataclasses.replace(one_epoch, fused_inner_update=False))):
                    zero_counts()
                    g = torch.Generator(device=dev).manual_seed(11)
                    t0 = time.perf_counter()
                    res[route] = task_batch_grad(model, micro, g, mc, mt)
                    torch.cuda.synchronize()
                    log(f"  lockstep {route} route {dt_name}: {time.perf_counter() - t0:.2f} s; "
                        f"launches {lockstep_counts()}")
                    if route == "kernel":
                        steps = one_epoch.inner_batches
                        want = {"lstm_stack_train_tasks": steps + 1,
                                "row 16 gemm_nn": (steps + 1) * n_l,
                                "row 16 recurrence": (steps + 1) * n_l,
                                "lstm_stack_train_tasks.backward": steps + 1,
                                "row 17 recurrence": (steps + 1) * n_l,
                                "row 17 gemm_nn": (steps + 1) * n_l,
                                "row 17 gemm_tn": 2 * (steps + 1) * n_l,
                                "clip_sgd_update.batched": steps, "clip_sgd_update": 0,
                                "lstm_stack_train": 0, "lstm_stack_train.backward": 0,
                                "gcn_stack_train": 2 * (steps + 1)}
                        if lockstep_counts() != want:
                            raise RuntimeError(f"the lockstep micro-batch launched "
                                               f"{lockstep_counts()}, not {want}")
                (loss_k, grad_k), (loss_p, grad_p) = res["kernel"], res["plain"]
                rels = {k: rel_err(grad_k[k], grad_p[k]) for k in grad_k}
                worst = max(rels, key=rels.get)
                log(f"lockstep meta-gradient {dt_name}: per-task query losses "
                    f"{loss_k.tolist()} vs {loss_p.tolist()}; gradient max|diff|/max|ref| "
                    f"{rels[worst]:.3e} at {worst} (tol {tol})")
                torch.testing.assert_close(loss_k, loss_p, rtol=tol, atol=tol)
                if rels[worst] > tol:
                    raise RuntimeError(f"lockstep meta-gradient {dt_name}: {worst} off by "
                                       f"{rels[worst]:.3e}")
            del res

            # The main path: one meta step at the defaults through the CLI.
            zero_counts()
            vb_logs = meta_train("float32", 1, out="vbatch")
            vbatch_launches = lockstep_counts()
            log(f"launches in one meta step under _VBATCH: {vbatch_launches}")
            forwards = meta_cfg.meta_batch * (meta_cfg.inner_epochs * meta_cfg.inner_batches + 1)
            want = {"lstm_stack_train_tasks": forwards // 2,
                    "row 16 gemm_nn": forwards // 2 * n_l,
                    "row 16 recurrence": forwards // 2 * n_l,
                    "lstm_stack_train_tasks.backward": forwards // 2,
                    "row 17 recurrence": forwards // 2 * n_l,
                    "row 17 gemm_nn": forwards // 2 * n_l,
                    "row 17 gemm_tn": forwards // 2 * 2 * n_l,
                    "clip_sgd_update.batched": per_step // 2, "clip_sgd_update": 0,
                    "lstm_stack_train": 0, "lstm_stack_train.backward": 0,
                    "gcn_stack_train": forwards}
            if vbatch_launches != want:
                raise RuntimeError(f"meta-train under _VBATCH launched {vbatch_launches}, "
                                   f"not {want}")
            for r in vb_logs:
                if not np.isfinite([r["meta_loss"], *r["per_task_loss"]]).all():
                    raise RuntimeError(f"meta-train under _VBATCH: non-finite loss {r}")
                log(f"  _VBATCH epoch {r['epoch']}: meta_loss {r['meta_loss']:.6f}, tasks "
                    f"{r['task_indices']}, {r['epoch_seconds']:.2f} s  [{card}]")

            # One lockstep inner step (2 tasks, one window each), and the
            # lockstep meta step against the serial one, in turns.
            state = init_meta_state(torch.Generator().manual_seed(1), cfg, meta_cfg, device=dev)
            named = sorted(state.params.named_parameters(), key=lambda kv: leaf_order(kv[0]))
            names = [k for k, _ in named]
            fast = [p.detach().unsqueeze(0).repeat(2, *[1] * p.dim()).requires_grad_(True)
                    for _, p in named]
            g = torch.Generator(device=dev).manual_seed(2)

            def lockstep_inner_step():
                x = micro.support_x[:, 0]
                preds = apply_hybrid_tasks(dict(zip(names, fast)), micro.a_hat, x, micro.koppen,
                                           cfg, masks=draw_masks(cfg, g, x))
                loss = sum(masked_mse(preds[v], micro.support_y[v, 0], micro.node_mask[v])
                           for v in range(2))
                inner_sgd_update_tasks(fast, list(torch.autograd.grad(loss, fast)), meta_cfg)

            ms = host_ms(torch, lockstep_inner_step)
            log(f"lockstep inner step float32 (2 tasks, one window each, forward + backward + "
                f"batched clip + SGD): {ms:.3f} ms  [{card}]")
            profile_steps(torch, lockstep_inner_step, "float32 lockstep inner steps (2 tasks)",
                          card, host_rows=8)
            del fast
            step = make_meta_step(cfg, dataclasses.replace(meta_cfg,
                                                           inner_epochs=TIMED_INNER_EPOCHS))

            def run_step(lockstep):
                fls._VBATCH = lockstep
                step(state, tasks, g)

            step_ms, peak = host_turns_ms(torch, dev, {"lockstep": lambda: run_step(True),
                                                       "serial": lambda: run_step(False)},
                                          ("lockstep", "serial"))
            log(f"meta step float32 at the defaults but {TIMED_INNER_EPOCHS} inner epoch, host "
                "clock, in turns: " + ", ".join(
                f"{k} {v[0]:.1f} / {v[1]:.1f} ms" for k, v in step_ms.items())
                + f"; lockstep / serial {sum(step_ms['lockstep']) / sum(step_ms['serial']):.3f}"
                f"; peak device memory lockstep {peak['lockstep']:.3f} GiB, serial "
                f"{peak['serial']:.3f} GiB  [{card}]")
            del state, step
        finally:
            fls._VBATCH = False

    # 19. The unmerged-gates stack (`_MERGED_GATES=False`): one meta step
    # through the CLI (the main path of rows 14-15), `forecast` (row 14 in
    # place of row 2), one inner step timed and profiled.
    with Phase("_MERGED_GATES=False: the unmerged-gates stack"):
        fls._MERGED_GATES = False
        try:
            zero_counts()
            um_logs = meta_train("float32", 1, out="unmerged")
            split_launches = {
                "lstm_stack_split": fls.lstm_stack_split.launches,
                "lstm_stack_split.backward": fls.lstm_stack_split.backward_launches,
                "lstm_stack_train": lstm_stack_train.launches,
                "lstm_stack_train.backward": lstm_stack_train.backward_launches}
            split_launches["row 14 gemm_nn"] = fls.lstm_stack_split.forward_gemm_nn_launches
            split_launches["row 14 recurrence"] = (
                fls.lstm_stack_split.forward_recurrence_launches)
            split_launches["row 15 gemm_tn"] = fls.lstm_stack_split.backward_gemm_tn_launches
            split_launches["gemm_nn"] = gemm_nn.launches
            log(f"launches in one meta step with unmerged gates: {split_launches}")
            forwards = meta_cfg.meta_batch * (meta_cfg.inner_epochs * meta_cfg.inner_batches + 1)
            # Row 14 runs the GEMM core once a layer (its input product) and
            # row 15 twice (its gates and its input gradient); so does row 7,
            # the GCN stack's backward (A_hat^T dz and its input gradient),
            # and row 6, its forward (h W and the aggregation). Row 15's
            # weight gradients are two TN products a layer.
            want = {"lstm_stack_split": forwards, "lstm_stack_split.backward": forwards,
                    "lstm_stack_train": 0, "lstm_stack_train.backward": 0,
                    "row 14 gemm_nn": n_l * forwards, "row 14 recurrence": n_l * forwards,
                    "row 15 gemm_tn": 2 * n_l * forwards,
                    "gemm_nn": (3 * n_l + 4 * cfg.gcn_layers) * forwards}
            if split_launches != want:
                raise RuntimeError(f"meta-train with unmerged gates launched {split_launches}, "
                                   f"not {want}")
            for r in um_logs:
                if not np.isfinite([r["meta_loss"], *r["per_task_loss"]]).all():
                    raise RuntimeError(f"meta-train with unmerged gates: non-finite loss {r}")
                log(f"  unmerged epoch {r['epoch']}: meta_loss {r['meta_loss']:.6f}, tasks "
                    f"{r['task_indices']}, {r['epoch_seconds']:.2f} s  [{card}]")
            zero_counts()
            mean = forecast("Moscow", "float32", serve_dir)
            split = fls.lstm_stack_split
            serve14 = (split.launches, lstm_stack_last_all.launches,
                       split.forward_gemm_nn_launches, split.forward_recurrence_launches)
            err = float(np.abs(mean - served[("Moscow", "float32")]).max())
            log(f"forecast Moscow with unmerged gates: row 14 launched {serve14[0]} times ("
                f"{serve14[2]} gemm_nn, {serve14[3]} recurrences), row 2 {serve14[1]}; against "
                f"the merged route's forecast max_abs_err {err:.3e}")
            if (serve14[0] == 0 or serve14[1] != 0
                    or serve14[2:] != (n_l * serve14[0], n_l * serve14[0])):
                raise RuntimeError(f"forecast with unmerged gates launched rows 14 / 2 "
                                   f"(row 14's pieces) {serve14}")
            np.testing.assert_allclose(mean, served[("Moscow", "float32")],
                                       rtol=TOL["float32"], atol=TOL["float32"])

            state = init_meta_state(torch.Generator().manual_seed(1), cfg, meta_cfg, device=dev)
            task = task_at(tasks, 0)
            params = [p for _, p in sorted(state.params.named_parameters(),
                                           key=lambda kv: leaf_order(kv[0]))]
            g = torch.Generator(device=dev).manual_seed(2)

            def unmerged_inner_step():
                loss = masked_mse(apply_model(state.params, task.a_hat, task.support_x[0],
                                              task.koppen, cfg, train=True, generator=g),
                                  task.support_y[0], task.node_mask)
                grads = torch.autograd.grad(loss, params)
                with torch.no_grad():
                    clip_sgd_update(params, grads, meta_cfg.inner_lr, meta_cfg.clip_norm)

            ms = host_ms(torch, unmerged_inner_step)
            log(f"inner step float32 with unmerged gates (one window, fused update): "
                f"{ms:.3f} ms  [{card}]")
            profile_steps(torch, unmerged_inner_step, "float32 inner steps, unmerged gates",
                          card, host_rows=6)
            del state, params
        finally:
            fls._MERGED_GATES = True
    # 20. Interop: a reference-schema .pt through import-checkpoint (python -m),
    # served, adapted and validated on the card, exported back; data-report,
    # info and trace_span.
    with Phase("interop: import-checkpoint, export-checkpoint, data-report, python -m"):
        interop = os.path.join(out_root, "interop")
        os.makedirs(interop)
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))

        def python_m(*argv):
            proc = subprocess.run(
                [sys.executable, "-m", "weatherforecast_stgcn_maml_tpu_torch", *argv],
                env=env, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"python -m ... {argv} exited {proc.returncode}:\n"
                                   f"{proc.stderr[-3000:]}")
            return proc.stdout

        # A reference checkpoint from seeded weights, keyed as the reference
        # saves it: GCNConv linear weights [out, in], a torch.nn.LSTM's state
        # dict (split biases, bias_hh nonzero), the head, the Koppen table.
        gen = torch.Generator().manual_seed(20)

        def uniform(*shape):
            return (torch.rand(shape, generator=gen) * 2 - 1) / shape[-1] ** 0.5

        hybrid_sd, d_in = {}, cfg.in_channels
        for i in range(1, cfg.gcn_layers + 1):
            hybrid_sd[f"base_stgcn.conv{i}.lin.weight"] = uniform(cfg.hidden_channels, d_in)
            hybrid_sd[f"base_stgcn.conv{i}.bias"] = uniform(cfg.hidden_channels, d_in)[:, 0]
            d_in = cfg.hidden_channels
        out_dim = cfg.num_weather_vars * cfg.horizon
        hybrid_sd["base_stgcn.output_layer.weight"] = uniform(out_dim, cfg.hidden_channels)
        hybrid_sd["base_stgcn.output_layer.bias"] = uniform(out_dim, cfg.hidden_channels)[:, 0]
        torch.manual_seed(20)
        ref_lstm = torch.nn.LSTM(cfg.hidden_channels, cfg.lstm_hidden, cfg.lstm_layers,
                                 batch_first=True)
        hybrid_sd.update({f"lstm.{k}": v.detach().clone()
                          for k, v in ref_lstm.state_dict().items()})
        hybrid_sd["output_layer.weight"] = uniform(out_dim, cfg.lstm_hidden)
        hybrid_sd["output_layer.bias"] = uniform(out_dim, cfg.lstm_hidden)[:, 0]
        moscow_adapt = get_region_data(boxes["Moscow"], data_cfg.adapt_years, data_cfg,
                                       tag="adapt", name="Moscow")
        feats_np, moscow_stats = prepare_features(moscow_adapt)
        ref_ckpt = {
            "hybrid_model_state_dict": hybrid_sd,
            "koppen_embed_state_dict": {"embedding.weight": torch.randn(
                cfg.koppen_classes, cfg.koppen_dim, generator=gen)},
            "config": {"input_channels": cfg.in_channels, "hidden_channels": cfg.hidden_channels,
                       "output_channels": cfg.num_weather_vars, "window_size": cfg.window,
                       "forecast_horizon": cfg.horizon},
            "hybrid_config": {"lstm_hidden_size": cfg.lstm_hidden,
                              "lstm_num_layers": cfg.lstm_layers,
                              "lstm_dropout": cfg.lstm_dropout},
            "model_version": "5.0", "epoch": 40,
        }
        meta_pt, adapted_pt = (os.path.join(interop, f) for f in ("ref_meta.pt", "ref_adapted.pt"))
        torch.save(ref_ckpt, meta_pt)
        torch.save({**ref_ckpt, "region_name": "Moscow", "val_loss": 0.5, "stats": {
            "mean": moscow_stats.mean, "std": moscow_stats.std}}, adapted_pt)
        if not float(hybrid_sd["lstm.bias_hh_l0"].abs().max()) > 0:
            raise RuntimeError("the reference LSTM's bias_hh is zero")

        # import-checkpoint through `python -m <package>`.
        t0 = time.perf_counter()
        text = python_m("import-checkpoint", meta_pt, "-o", f"out_dir={interop}")
        log(f"python -m ... import-checkpoint: {time.perf_counter() - t0:.1f} s; "
            f"{text.splitlines()[0]}")
        meta_ckpt = os.path.join(interop, "meta", "ckpt_best")
        imported_sd, imported_meta = load_checkpoint(meta_ckpt)
        split = sorted(k for k in imported_sd if k.endswith(("b_ih", "b_hh")))
        if len(split) != 2 * cfg.lstm_layers or imported_meta["schema"] != "wfstgcn-meta-v1":
            raise RuntimeError(f"the imported checkpoint: split biases {split}, "
                               f"schema {imported_meta.get('schema')}")

        # forecast from it: rows 1-2 on the card, equal to the plain route's.
        for fn in (fused_gcn_stack, lstm_stack_last_all):
            fn.launches = 0
        got = forecast("Moscow", "float32", interop)
        interop_serving = {"fused_gcn_stack": fused_gcn_stack.launches,
                           "lstm_stack_last_all": lstm_stack_last_all.launches}
        ref = forecast("Moscow", "float32", interop, device="cpu")
        err = float(np.abs(got - ref).max())
        log(f"forecast Moscow from the imported checkpoint: launches {interop_serving}; "
            f"card vs plain route max_abs_err {err:.3e} (tol {TOL['float32']})")
        if 0 in interop_serving.values():
            raise RuntimeError(f"forecast from the imported checkpoint: {interop_serving}")
        np.testing.assert_allclose(got, ref, rtol=TOL["float32"], atol=TOL["float32"])

        # One train step of the imported (split-bias) model, kernel route vs
        # plain route, the same masks: every gradient, b_ih and b_hh too.
        spec = WindowSpec(cfg.window, cfg.horizon)
        feats = torch.from_numpy(pad_nodes(feats_np, n)).to(dev)
        node_mask = torch.from_numpy(graph.node_mask).to(dev)
        koppen = max(moscow_adapt.koppen_code, 0)
        imported = init_model(torch.Generator().manual_seed(0), cfg)
        load_params(imported, imported_sd)
        imported = imported.to(dev)
        names, leaves = zip(*imported.named_parameters())
        x, y = gather_batch(feats, [100, 101], spec)
        masks = draw_masks(cfg, torch.Generator(device=dev).manual_seed(21), x)
        split_grads = {}
        for route, mc in (("kernel", cfg),
                          ("plain", ModelConfig(use_pallas_gcn=False, lstm_kernel="xla"))):
            for fn in (gcn_stack_train, lstm_stack_train):
                fn.launches = fn.backward_launches = 0
            lstm_stack_train.plain_routes = 0
            loss = masked_mse(apply_model(imported, a_hat, x, koppen, mc, train=True,
                                          masks=masks), y, node_mask)
            split_grads[route] = dict(zip(names, torch.autograd.grad(loss, leaves)))
            if route == "kernel":
                counts = (gcn_stack_train.launches, gcn_stack_train.backward_launches,
                          lstm_stack_train.launches, lstm_stack_train.backward_launches,
                          lstm_stack_train.plain_routes)
                if counts != (1, 1, 1, 1, 0):
                    raise RuntimeError(f"the imported model's train step launched rows 6, 7, "
                                       f"4, 5 and the plain stack {counts} times")
        rels = {k: rel_err(split_grads["kernel"][k], split_grads["plain"][k]) for k in names}
        worst = max(rels, key=rels.get)
        bias_rels = {k: f"{v:.2e}" for k, v in rels.items() if k.endswith(("b_ih", "b_hh"))}
        log(f"imported model's train step (split biases), kernel vs plain route: gradient "
            f"max|diff|/max|ref| {rels[worst]:.3e} at {worst} (tol {TOL['float32']}); "
            f"b_ih / b_hh {bias_rels}")
        if rels[worst] > TOL["float32"]:
            raise RuntimeError(f"the imported model's gradient {worst} off by {rels[worst]:.3e}")
        for l in range(cfg.lstm_layers):
            kg = split_grads["kernel"]
            if not torch.equal(kg[f"lstm.layers.{l}.b_ih"], kg[f"lstm.layers.{l}.b_hh"]):
                raise RuntimeError(f"layer {l}: b_ih and b_hh took different gradients")

        # One adaptation step under trace_span: the Chrome trace must hold the
        # GEMM core's and the forward recurrence's kernels.
        tx, lr0 = adaptation_optimizer("Moscow")
        train_step = make_train_step(cfg, tx)
        astate = SupervisedState(imported, tx.init(dict(imported.named_parameters())))
        g = torch.Generator(device=dev).manual_seed(22)
        astate, _ = train_step(astate, x, y, a_hat, node_mask, koppen, lr0, g)
        trace_dir = os.path.join(interop, "trace")
        with trace_span(trace_dir):
            astate, _ = train_step(astate, x, y, a_hat, node_mask, koppen, lr0, g)
        with open(os.path.join(trace_dir, "trace.json")) as f:
            kernels_seen = {e.get("name", "") for e in json.load(f)["traceEvents"]
                            if e.get("cat") == "kernel"}
        hits = {k: sum(k in name for name in kernels_seen)
                for k in ("gemm_nn", "lstm_scan_fwd_kernel")}
        log(f"trace_span of one adaptation step: {len(kernels_seen)} distinct kernels, {hits}")
        if 0 in hits.values():
            raise RuntimeError(f"the trace lacks a kernel: {hits}; {sorted(kernels_seen)[:20]}")
        del astate, imported, split_grads

        # adapt Moscow 1 epoch from the imported checkpoint: rows 4-7, no
        # plain stack, finite losses.
        for fn in (gcn_stack_train, lstm_stack_train):
            fn.launches = fn.backward_launches = 0
        lstm_stack_train.plain_routes = 0
        adapt_out = os.path.join(interop, "adapt_run")
        _, _, secs = run_cli(["adapt", "--region", "Moscow", "--meta-ckpt", meta_ckpt,
                              "-o", f"out_dir={adapt_out}", "-o", "adapt.epochs=1"])
        interop_adapt = {"gcn_stack_train": gcn_stack_train.launches,
                         "gcn_stack_train.backward": gcn_stack_train.backward_launches,
                         "lstm_stack_train": lstm_stack_train.launches,
                         "lstm_stack_train.backward": lstm_stack_train.backward_launches,
                         "plain stack": lstm_stack_train.plain_routes}
        side = load_meta(adapted_ckpt_path(adapt_out, "Moscow", boxes["Moscow"]))
        values = [side["val_mse"], *side["epoch_losses"]]
        log(f"adapt Moscow from the imported checkpoint, 1 epoch: {secs:.1f} s, launches "
            f"{interop_adapt}, epoch loss {side['epoch_losses']}, val_mse "
            f"{side['val_mse']:.6f}  [{card}]")
        if (0 in list(interop_adapt.values())[:4] or interop_adapt["plain stack"]
                or not np.isfinite(values).all()):
            raise RuntimeError(f"adapt from the imported checkpoint: {interop_adapt}, {values}")

        # The adapted form, imported under Moscow's name, validated on the card.
        _, _, _ = run_cli(["import-checkpoint", adapted_pt, "--region", "Moscow",
                           "-o", f"out_dir={interop}"])
        for fn in (fused_gcn_stack, lstm_stack_last_all):
            fn.launches = 0
        out, err, _ = run_cli(["validate", "--region", "Moscow", "--no-plots",
                               "-o", f"out_dir={interop}"])
        interop_validate = {"fused_gcn_stack": fused_gcn_stack.launches,
                            "lstm_stack_last_all": lstm_stack_last_all.launches}
        results = json.loads(out)
        log(f"validate Moscow from the imported adapted checkpoint: average_mse "
            f"{results['average_mse']:.6f}, launches {interop_validate}")
        if ("(adapted model)" not in err or 0 in interop_validate.values()
                or not np.isfinite(results["average_mse"])):
            raise RuntimeError(f"validate of the imported adapted checkpoint: {err[-2000:]}")

        # export-checkpoint it, import the .pt again: the same parameters, bitwise.
        exported_pt = os.path.join(interop, "exported.pt")
        run_cli(["export-checkpoint", "--region", "Moscow", "--out", exported_pt,
                 "-o", f"out_dir={interop}"])
        adapted_sd, _ = load_checkpoint(adapted_ckpt_path(interop, "Moscow", boxes["Moscow"]))
        again, _, again_stats, _ = import_torch_checkpoint(exported_pt)
        if sorted(again) != sorted(adapted_sd) or not all(
                torch.equal(again[k], adapted_sd[k]) for k in again):
            raise RuntimeError("export -> import changed the adapted parameters")
        if not np.array_equal(again_stats.mean, moscow_stats.mean):
            raise RuntimeError("export -> import changed the stats")
        log(f"export-checkpoint -> import: {len(again)} tensors bitwise equal, stats equal")

        report, _, _ = run_cli(["data-report", "--region", "Moscow"])
        rows = [line for line in report.splitlines()[3:] if line.strip()]
        log("data-report Moscow:\n" + report.rstrip())
        if len(rows) != cfg.num_weather_vars:
            raise RuntimeError(f"data-report printed {len(rows)} variable rows")
        info = python_m("info")
        if torch.cuda.get_device_name(0) not in info:
            raise RuntimeError(f"python -m ... info does not name the card: {info[-500:]}")
        log(f"python -m ... info: {info.strip().splitlines()[-2]}")

    # 21. The fleet: `pipeline --mesh-fleet` over three cold regions and a
    # temperate one, from the imported meta checkpoint.
    with Phase("pipeline --mesh-fleet"):
        fleet_regions = ["Moscow", "NorthSiberia", "Afghanistan", "NewYork"]
        groups = {"cold": 3, "temperate": 1}

        def fleet_counts():
            tasks = fls.lstm_stack_train_tasks
            return {"gcn_stack_train": gcn_stack_train.launches,
                    "gcn_stack_train.backward": gcn_stack_train.backward_launches,
                    "lstm_stack_train": lstm_stack_train.launches,
                    "lstm_stack_train.backward": lstm_stack_train.backward_launches,
                    "lstm_stack_train_tasks": tasks.launches,
                    "lstm_stack_train_tasks.backward": tasks.backward_launches,
                    "fused_gcn_stack": fused_gcn_stack.launches,
                    "lstm_stack_last_all": lstm_stack_last_all.launches}

        def zero_fleet_counts():
            for fn in (gcn_stack_train, lstm_stack_train, fls.lstm_stack_train_tasks):
                fn.launches = fn.backward_launches = 0
            fused_gcn_stack.launches = lstm_stack_last_all.launches = 0

        def pipeline(out, *extra, fleet=True):
            if not os.path.exists(os.path.join(out, "meta", "ckpt_best")):
                save_checkpoint(os.path.join(out, "meta", "ckpt_best"), imported_sd,
                                imported_meta)
            _, err, secs = run_cli(["pipeline", "--regions", ";".join(fleet_regions),
                                    "--no-plots", *(["--mesh-fleet"] if fleet else []),
                                    "-o", f"out_dir={out}", "-o", "adapt.epochs=1", *extra])
            sides = {r: load_meta(adapted_ckpt_path(out, r, boxes[r])) for r in fleet_regions}
            return err, secs, sides

        def steps(max_samples=AdaptConfig().max_samples):
            n_win = spec.num_samples(data_cfg.synthetic_timesteps)
            train_idx, _ = contiguous_split(n_win, AdaptConfig().train_fraction, max_samples)
            return -(-len(train_idx) // AdaptConfig().batch_size)

        zero_fleet_counts()
        err, secs, sides = pipeline(os.path.join(out_root, "fleet"))
        main_fleet = fleet_counts()
        nb = steps()
        log(f"pipeline --mesh-fleet {fleet_regions} at AdaptConfig() (1 epoch, {nb} fleet "
            f"steps a zone): {secs:.1f} s; launches {main_fleet}  [{card}]")
        log("  " + "\n  ".join(line for line in err.splitlines() if "fleet" in line
                               or "avg_mse" in line))
        if "fleet-adapted" not in err or "fleet adaptation failed" in err:
            raise RuntimeError(f"the fleet did not run: {err[-3000:]}")
        for r, side in sides.items():
            if side.get("fleet_mesh") is not True or not np.isfinite(
                    [side["val_mse"], *side["epoch_losses"]]).all():
                raise RuntimeError(f"{r}'s adapted checkpoint: {side}")
        want = {k: len(fleet_regions) * nb for k in list(main_fleet)[:4]}
        want.update({"lstm_stack_train_tasks": 0, "lstm_stack_train_tasks.backward": 0})
        if {k: main_fleet[k] for k in want} != want or not (
                main_fleet["fused_gcn_stack"] and main_fleet["lstm_stack_last_all"]):
            raise RuntimeError(f"the fleet launched {main_fleet}, not {want} and rows 1-2")

        # Dropout 0, the windows cut to 200: the fleet against the serial
        # pipeline, then the fleet under _VBATCH against the default fleet.
        cut = ["-o", "model.gcn_dropout=0", "-o", "model.lstm_dropout=0",
               "-o", "adapt.max_samples=200"]
        nb_cut = steps(200)
        runs = {}
        for name, fleet in (("serial", False), ("fleet", True)):
            _, secs, runs[name] = pipeline(os.path.join(out_root, f"cut_{name}"), *cut,
                                           fleet=fleet)
            log(f"pipeline {name} at dropout 0, 200 windows: {secs:.1f} s")
        sides_vb = None
        plans = {r: fls.forward_plan(cfg.lstm_hidden, 2 * n, 4, fls._card_sms(dev), r)
                 for r in (1, 2, 3, 4, 8)}
        log(f"forward recurrence plans (cs, hcp, rb, k_res) at {2 * n} rows a region, float32: "
            f"{plans}")
        fls._VBATCH = True
        try:
            zero_fleet_counts()
            t0 = time.perf_counter()
            _, _, runs["_VBATCH"] = pipeline(os.path.join(out_root, "cut_vbatch"), *cut)
            vb_fleet = fleet_counts()
        finally:
            fls._VBATCH = False
        log(f"pipeline --mesh-fleet under _VBATCH at dropout 0, 200 windows: "
            f"{time.perf_counter() - t0:.1f} s; launches {vb_fleet}")
        want = {"lstm_stack_train": 0, "lstm_stack_train.backward": 0,
                "lstm_stack_train_tasks": len(groups) * nb_cut,
                "lstm_stack_train_tasks.backward": len(groups) * nb_cut,
                "gcn_stack_train": len(fleet_regions) * nb_cut}
        if {k: vb_fleet[k] for k in want} != want:
            raise RuntimeError(f"the fleet under _VBATCH launched {vb_fleet}, not {want}")
        for a, b in (("fleet", "serial"), ("_VBATCH", "fleet")):
            worst = 0.0
            for r in fleet_regions:
                va = np.asarray([runs[a][r]["val_mse"], *runs[a][r]["epoch_losses"]])
                vb = np.asarray([runs[b][r]["val_mse"], *runs[b][r]["epoch_losses"]])
                worst = max(worst, float(np.max(np.abs(va - vb) / np.abs(vb))))
            log(f"{a} vs {b} at dropout 0: largest relative difference of val_mse and the "
                f"epoch loss over {len(fleet_regions)} regions {worst:.3e} (tol {TOL['float32']})")
            if worst > TOL["float32"]:
                raise RuntimeError(f"{a} vs {b}: {worst:.3e}")

        # One fleet epoch of the three cold regions against their three
        # serial epochs (40 steps of batch 2 each), in turns, with peak memory;
        # rows 16-17 at the fleet's shape beside rows 4-5 three times.
        cold = fleet_regions[:3]
        datas = [get_region_data(boxes[r], data_cfg.adapt_years, data_cfg, tag="adapt", name=r)
                 for r in cold]
        fleet_feats = torch.from_numpy(np.stack([pad_nodes(prepare_features(d)[0], n)
                                                 for d in datas])).to(dev)
        template = init_model(torch.Generator().manual_seed(0), cfg)
        load_params(template, imported_sd)
        template = template.to(dev)
        tx, lr0 = adaptation_optimizer("Moscow")
        anchors = (spec.window + np.arange(80)).reshape(40, 2)
        a_hat3 = a_hat.expand(3, n, n).contiguous()
        mask3 = node_mask.expand(3, n).contiguous()
        kop3 = [max(d.koppen_code, 0) for d in datas]
        run_fleet = make_fleet_epoch_runner(cfg, tx, spec, template)
        run_serial = make_epoch_runner(cfg, tx, spec)
        params3, _ = stack_fleet([dict(template.named_parameters())] * 3, None, dev)
        states3 = [tx.init({k: p[v] for k, p in params3.items()}) for v in range(3)]
        lanes = [copy.deepcopy(template) for _ in range(3)]
        serial_states = [SupervisedState(m, tx.init(dict(m.named_parameters()))) for m in lanes]
        gens = [torch.Generator(device=dev).manual_seed(v) for v in range(3)]

        def fleet_epoch():
            run_fleet(params3, states3, fleet_feats, np.stack([anchors] * 3), a_hat3, mask3,
                      kop3, [lr0] * 3, gens)

        def serial_epochs():
            for v in range(3):
                run_serial(serial_states[v], fleet_feats[v], anchors, a_hat, node_mask, kop3[v],
                           lr0, gens[v])

        epoch_ms, fleet_peak = host_turns_ms(
            torch, dev, {"fleet": fleet_epoch, "serial": serial_epochs}, ("fleet", "serial"))
        log("3 cold regions, 40 steps of batch 2 each, host clock, in turns: one fleet epoch "
            f"{epoch_ms['fleet'][0]:.1f} / {epoch_ms['fleet'][1]:.1f} ms, three serial epochs "
            f"{epoch_ms['serial'][0]:.1f} / {epoch_ms['serial'][1]:.1f} ms; peak device memory "
            f"fleet {fleet_peak['fleet']:.3f} GiB, serial {fleet_peak['serial']:.3f} GiB  [{card}]")
        h3 = torch.randn(3, 2 * n, cfg.window, cfg.hidden_channels, device=dev)
        wcat = [torch.cat([l.wx, l.wh]).detach() for l in template.lstm.layers]
        b2d = torch.stack([l.b.detach() for l in template.lstm.layers])
        w0 = wcat[0].expand(3, *wcat[0].shape).contiguous().requires_grad_(True)
        wr = torch.stack(wcat[1:]).expand(3, *torch.stack(wcat[1:]).shape).contiguous()
        b3 = b2d.expand(3, *b2d.shape).contiguous()

        def row16_17():
            out = fls.lstm_stack_train_tasks(h3, w0, wr, b3)
            torch.autograd.grad(out.sum(), w0)

        h1 = h3[0].clone()
        layers = list(template.lstm.layers)

        def rows4_5_three():
            for _ in range(3):
                out = lstm_stack_train(layers, h1)
                torch.autograd.grad(out.sum(), layers[0].wx)

        turns = {"rows 16-17 (V 3)": [], "rows 4-5 x 3": []}
        for name in ("rows 16-17 (V 3)", "rows 4-5 x 3", "rows 4-5 x 3", "rows 16-17 (V 3)"):
            turns[name].append(cuda_ms(torch, row16_17 if name.startswith("rows 16") else
                                       rows4_5_three))
        log(f"forward + backward at the fleet's shape ({2 * n} rows a region, 3 regions), CUDA "
            f"events, in turns: " + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f} ms"
                                               for k, v in turns.items()) + f"  [{card}]")
        del fleet_feats, params3, states3, lanes, serial_states, template, h3, w0

    # 22. Second order on both meshes and _VBATCH on the dp mesh, on 1 x 1
    # meshes (a NCCL group of one rank in this process) and two gloo ranks.
    with Phase("second order and _VBATCH on meshes"):
        t0 = time.perf_counter()
        created_group = distributed.ensure_process_group("nccl")
        dp_mesh = make_mesh_2d(1, 1, dev, axis_names=("dp",))
        grid_mesh = make_mesh_2d(1, 1, dev)
        log(f"  the NCCL group of one and its two meshes: {time.perf_counter() - t0:.1f} s")
        so_nodrop = ModelConfig(gcn_dropout=0.0, lstm_dropout=0.0)
        so_epoch = dataclasses.replace(one_epoch, second_order=True)  # fhvp, 15 inner steps
        steps = 2 * so_epoch.inner_batches
        forwards = 2 * (so_epoch.inner_batches + 1)

        def mesh_so_counts():
            return {"hvp_stack_fwd": fh.hvp_stack_fwd.launches,
                    "hvp_stack_bwd": fh.hvp_stack_bwd.launches,
                    "gcn_shard_layer": fgs.gcn_shard_layer.launches,
                    "gcn_shard_layer.backward": fgs.gcn_shard_layer.backward_launches,
                    "lstm_stack_train": lstm_stack_train.launches,
                    "lstm_stack_train.backward": lstm_stack_train.backward_launches,
                    "gcn_stack_train": gcn_stack_train.launches}

        def zero_mesh_so_counts():
            fh.hvp_stack_fwd.launches = fh.hvp_stack_bwd.launches = 0
            for fn in (fgs.gcn_shard_layer, lstm_stack_train, gcn_stack_train):
                fn.launches = fn.backward_launches = 0

        # (a), (b): the SO fhvp meta-gradient of 2 tasks on each mesh against
        # the unsharded one, dropout 0. Rows 10-11 once each an inner step;
        # on dp x sp rows 12-13 (and 4-5) in the inner gradient's forward,
        # the GCN stack (rows 6-7) never.
        t0 = time.perf_counter()
        ref_loss, ref_grad = task_batch_grad(model, micro, None, so_nodrop, so_epoch)
        torch.cuda.synchronize()
        log(f"  the unsharded SO meta-gradient: {time.perf_counter() - t0:.1f} s")
        for name, mesh_, make in (("dp 1", dp_mesh, make_parallel_batch_grad),
                                  ("dp 1 x sp 1", grid_mesh, make_shardmap_batch_grad)):
            zero_mesh_so_counts()
            t0 = time.perf_counter()
            loss_m, grad_m = make(so_nodrop, so_epoch, mesh_)(model, micro, None)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = mesh_so_counts()
            rels = {k: rel_err(grad_m[k], ref_grad[k]) for k in ref_grad}
            worst = max(rels, key=rels.get)
            log(f"SO fhvp meta-gradient on a {name} mesh vs unsharded, float32, dropout 0, 2 "
                f"tasks x {so_epoch.inner_batches} inner steps: per-task losses "
                f"{loss_m.tolist()} vs {ref_loss.tolist()}; gradient max|diff|/max|ref| "
                f"{rels[worst]:.3e} at {worst} (tol {HVP_TOL['float32']}); {secs:.2f} s; "
                f"launches {counts}")
            torch.testing.assert_close(loss_m, ref_loss, rtol=TOL["float32"],
                                       atol=TOL["float32"])
            if rels[worst] > HVP_TOL["float32"]:
                raise RuntimeError(f"SO meta-gradient on {name}: {worst} off by "
                                   f"{rels[worst]:.3e}")
            if (counts["hvp_stack_fwd"], counts["hvp_stack_bwd"]) != (steps, steps):
                raise RuntimeError(f"SO on {name}: rows 10-11 launched {counts}, not {steps} "
                                   f"each")
            sharded = mesh_ is grid_mesh
            shard = cfg.gcn_layers * forwards if sharded else 0
            if (counts["gcn_shard_layer"], counts["gcn_shard_layer.backward"]) != (shard, shard):
                raise RuntimeError(f"SO on {name}: rows 12-13 launched {counts}, not {shard}")
            if (counts["gcn_stack_train"] == 0) != sharded or min(
                    counts["lstm_stack_train"], counts["lstm_stack_train.backward"]) < forwards:
                raise RuntimeError(f"SO on {name}: the inner gradient's forward launched "
                                   f"{counts}")

        # One SO inner step (the kernel-route gradient and its fhvp Hessian
        # transpose, one window) on the dp x sp mesh against the unsharded
        # one, in turns (U, S, S, U), and each one's device-busy share.
        mc = ModelConfig()
        group = grid_mesh.sp_group
        p = {k: v.detach().clone().requires_grad_(True) for k, v in model.named_parameters()}
        draw = np.random.default_rng(41)
        ct = [torch.from_numpy(draw.normal(size=v.shape).astype(np.float32)).to(dev)
              for v in p.values()]
        task = task_at(tasks, 0)
        aux = (task.support_x[0], task.support_y[0], task.a_hat, task.koppen, task.node_mask)
        t_l = task_at(shard_task_batch_2d(tasks, grid_mesh), 0)
        aux_l = (t_l.support_x[0], t_l.support_y[0], t_l.a_hat, t_l.koppen, t_l.node_mask)
        unsharded_grad = make_so_grad(support_loss(model, mc),
                                      support_loss(model, plain_route(mc)), "fhvp",
                                      make_grad_loss_fused(model, mc))
        rank_route = local_route(group)
        sharded_grad = make_so_grad(
            support_loss(model, mc, rank_route.forward, rank_route.mse),
            support_loss(model, plain_route(mc), rank_route.forward, rank_route.mse), "fhvp",
            rank_route.grad_loss_fused(model, mc))
        g = torch.Generator(device=dev).manual_seed(2)

        def so_step_unsharded():
            grads = unsharded_grad(p, aux, draw_masks(mc, g, aux[0]))
            torch.autograd.grad(list(grads.values()), list(p.values()), ct)

        def so_step_sharded():
            grads = sharded_grad(p, aux_l, rank_route.masks(mc, g, aux_l[0]))
            torch.autograd.grad(rank_route.reduce(list(grads.values())), list(p.values()), ct)

        runs = {"unsharded": so_step_unsharded, "dp 1 x sp 1": so_step_sharded}
        so_ms = {k: [] for k in runs}
        t0 = time.perf_counter()
        for name in ("unsharded", "dp 1 x sp 1", "dp 1 x sp 1", "unsharded"):
            so_ms[name].append(host_ms(torch, runs[name]))
        log("SO inner step float32 (kernel-route gradient + fhvp Hessian transpose, one "
            "window), host clock, in turns: " + ", ".join(
                f"{k} {v[0]:.3f} / {v[1]:.3f} ms" for k, v in so_ms.items())
            + f"; sharded / unsharded {sum(so_ms['dp 1 x sp 1']) / sum(so_ms['unsharded']):.3f}"
            f" ({time.perf_counter() - t0:.1f} s)  [{card}]")
        # Each one's device-busy share, and the sharded step's host ops.
        t0 = time.perf_counter()
        profile_steps(torch, so_step_unsharded, "float32 SO inner steps (unsharded)", card)
        profile_steps(torch, so_step_sharded, "float32 SO inner steps (1 x 1 dp x sp mesh)",
                      card, host_rows=10)
        log(f"  the two profiles: {time.perf_counter() - t0:.1f} s")
        del p, ct, unsharded_grad, sharded_grad

        # (c) The SO main path on a mesh: `cli meta-train --mesh -o
        # meta.second_order=true`, 1 epoch at MetaConfig() cut to
        # SO_INNER_EPOCHS (dp, world 1): rows 10-11 once each an inner step.
        zero_mesh_so_counts()
        so_mesh_log = meta_train("float32", 1, "--mesh", "-o", "meta.second_order=true",
                                 "-o", f"meta.inner_epochs={SO_INNER_EPOCHS}", out="mesh_so")
        so_mesh_launches = mesh_so_counts()
        log(f"launches in one SO meta step on the dp mesh: {so_mesh_launches}")
        if (so_mesh_launches["hvp_stack_fwd"], so_mesh_launches["hvp_stack_bwd"]) != (
                so_per_step, so_per_step):
            raise RuntimeError(f"meta-train --mesh SO launched rows 10-11 {so_mesh_launches}, "
                               f"not {so_per_step} each")
        for r in so_mesh_log:
            if not np.isfinite([r["meta_loss"], *r["per_task_loss"]]).all():
                raise RuntimeError(f"meta-train --mesh SO: non-finite loss {r}")
            log(f"  SO --mesh epoch {r['epoch']}: meta_loss {r['meta_loss']:.6f}, tasks "
                f"{r['task_indices']}, {r['epoch_seconds']:.2f} s  [{card}]")

        # (e) _VBATCH on the dp mesh: the lockstep mesh meta-gradient against
        # the serial mesh meta-gradient, dropout on (rate 0.2), the same key,
        # so the same masks; then the main path through the CLI.
        try:
            vb = {}
            for name, flag in (("lockstep", True), ("serial", False)):
                fls._VBATCH = flag
                zero_counts()
                t0 = time.perf_counter()
                vb[name] = make_parallel_batch_grad(cfg, one_epoch, dp_mesh)(model, micro, (11, 0))
                torch.cuda.synchronize()
                log(f"  {name} dp-mesh meta-gradient: {time.perf_counter() - t0:.1f} s")
                vb[name] += (lockstep_counts(),)
            want = {"lstm_stack_train_tasks": steps // 2 + 1,
                    "lstm_stack_train_tasks.backward": steps // 2 + 1,
                    "clip_sgd_update.batched": steps // 2, "clip_sgd_update": 0,
                    "lstm_stack_train": 0, "lstm_stack_train.backward": 0}
            got = {k: vb["lockstep"][2][k] for k in want}
            if got != want or vb["serial"][2]["lstm_stack_train_tasks"] != 0:
                raise RuntimeError(f"the lockstep mesh meta-gradient launched {got}, not {want} "
                                   f"(serial: {vb['serial'][2]})")
            rels = {k: rel_err(vb["lockstep"][1][k], vb["serial"][1][k]) for k in vb["serial"][1]}
            worst = max(rels, key=rels.get)
            log(f"_VBATCH on the dp mesh: lockstep vs serial meta-gradient float32, dropout on, "
                f"key (11, 0): per-task losses {vb['lockstep'][0].tolist()} vs "
                f"{vb['serial'][0].tolist()}; gradient max|diff|/max|ref| {rels[worst]:.3e} at "
                f"{worst} (tol {TOL['float32']}); lockstep launches {vb['lockstep'][2]}")
            torch.testing.assert_close(vb["lockstep"][0], vb["serial"][0], rtol=TOL["float32"],
                                       atol=TOL["float32"])
            if rels[worst] > TOL["float32"]:
                raise RuntimeError(f"lockstep mesh meta-gradient: {worst} off by "
                                   f"{rels[worst]:.3e}")
            fls._VBATCH = True
            zero_counts()
            vb_mesh_log = meta_train("float32", 1, "--mesh", out="mesh_vbatch")
            vb_mesh_launches = lockstep_counts()
        finally:
            fls._VBATCH = False
        log(f"launches in one meta step under _VBATCH on the dp mesh: {vb_mesh_launches}")
        forwards_step = meta_cfg.meta_batch * (meta_cfg.inner_epochs * meta_cfg.inner_batches + 1)
        want = {"lstm_stack_train_tasks": forwards_step // 2,
                "lstm_stack_train_tasks.backward": forwards_step // 2,
                "clip_sgd_update.batched": per_step // 2, "clip_sgd_update": 0,
                "lstm_stack_train": 0, "lstm_stack_train.backward": 0}
        got = {k: vb_mesh_launches[k] for k in want}
        if got != want:
            raise RuntimeError(f"meta-train --mesh under _VBATCH launched {got}, not {want}")
        for r in vb_mesh_log:
            if not np.isfinite([r["meta_loss"], *r["per_task_loss"]]).all():
                raise RuntimeError(f"meta-train --mesh under _VBATCH: non-finite loss {r}")
            log(f"  _VBATCH --mesh epoch {r['epoch']}: meta_loss {r['meta_loss']:.6f}, tasks "
                f"{r['task_indices']}, {r['epoch_seconds']:.2f} s  [{card}]")
        if created_group:
            torch.distributed.destroy_process_group()

        # (d) Two gloo ranks on the one card (phase 14's launcher), dp 1 x
        # sp 2, second order, 1 inner epoch: each rank launches rows 10-11
        # on its 256 rows once an inner step, rows 12-13 once a forward.
        out = os.path.join(out_root, "mesh_sp2_so")
        os.makedirs(out)
        ranks = two_ranks(out, "-o", "meta.second_order=true", "-o", "meta.inner_epochs=1")
        so_steps = meta_cfg.meta_batch * RANK_INNER_BATCHES
        for rec in ranks:
            got = (rec["launches"]["hvp_stack_fwd"], rec["launches"]["hvp_stack_bwd"],
                   rec["launches"]["gcn_shard_layer"])
            want = (so_steps, so_steps,
                    cfg.gcn_layers * meta_cfg.meta_batch * (RANK_INNER_BATCHES + 1))
            if got != want:
                raise RuntimeError(f"SO rank {rec['rank']} launched rows 10, 11, 12 {got}, not "
                                   f"{want}")
        with open(os.path.join(out, "meta", "meta_log.jsonl")) as f:
            rec = json.loads(f.readline())
        log(f"two ranks SO (dp 1 x sp 2, 256 rows each, gloo on one card), epoch 1 (1 inner "
            f"epoch): meta_loss {rec['meta_loss']:.6f}, tasks {rec['task_indices']}, "
            f"{rec['epoch_seconds']:.2f} s  [{card}]")

    # 23. The GSPMD dp x sp step and chained meta epochs, at ModelConfig()
    # width, float32.
    with Phase("GSPMD dp x sp step and chained meta epochs"):
        def rows_4_13():
            return {"lstm_stack_train": lstm_stack_train.launches,
                    "lstm_stack_train.backward": lstm_stack_train.backward_launches,
                    "gcn_stack_train": gcn_stack_train.launches,
                    "gcn_stack_train.backward": gcn_stack_train.backward_launches,
                    "clip_sgd_update": clip_sgd_update.launches,
                    "clip_sgd_update.batched": clip_sgd_update.batched_launches,
                    "hvp_stack_fwd": fh.hvp_stack_fwd.launches,
                    "hvp_stack_bwd": fh.hvp_stack_bwd.launches,
                    "gcn_shard_layer": fgs.gcn_shard_layer.launches,
                    "gcn_shard_layer.backward": fgs.gcn_shard_layer.backward_launches}

        def zero_rows_4_13():
            for fn in (lstm_stack_train, gcn_stack_train, fgs.gcn_shard_layer):
                fn.launches = fn.backward_launches = 0
            clip_sgd_update.launches = clip_sgd_update.batched_launches = 0
            fh.hvp_stack_fwd.launches = fh.hvp_stack_bwd.launches = 0

        # (a) On a 1 x 1 dp x sp mesh (a NCCL group of one rank): the GSPMD
        # meta-gradient of 2 tasks x 15 inner steps, dropout 0.2, against
        # the dp-mesh step on the same key on the plain routes. The GSPMD
        # step pins the plain routes, so rows 4-13 never launch.
        t0 = time.perf_counter()
        created_group = distributed.ensure_process_group("nccl")
        dp_mesh = make_mesh_2d(1, 1, dev, axis_names=("dp",))
        grid_mesh = make_mesh_2d(1, 1, dev)
        stgcn_cfg = ModelConfig(family="stgcn")
        stgcn_model = init_model(torch.Generator().manual_seed(3), stgcn_cfg, device=dev)
        log(f"  the NCCL group of one, its two meshes and a seeded stgcn model: "
            f"{time.perf_counter() - t0:.1f} s")
        so_one = dataclasses.replace(one_epoch, second_order=True)  # fhvp
        for name, mc, mdl, mt in (("stgcn FO", stgcn_cfg, stgcn_model, one_epoch),
                                  ("stgcn SO fhvp", stgcn_cfg, stgcn_model, so_one),
                                  ("hybrid FO (forced gspmd)", cfg, model, one_epoch)):
            res = {}
            for route in ("gspmd", "dp"):
                zero_rows_4_13()
                t0 = time.perf_counter()
                if route == "gspmd":
                    res[route] = make_gspmd_batch_grad(mc, mt, grid_mesh)(mdl, micro, (23, 0))
                else:
                    res[route] = make_parallel_batch_grad(*pinned_configs(mc, mt), dp_mesh)(
                        mdl, micro, (23, 0))
                torch.cuda.synchronize()
                res[route] += (rows_4_13(), time.perf_counter() - t0)
            (loss_g, grad_g, launches_g, secs_g), (loss_d, grad_d, _, secs_d) = (
                res["gspmd"], res["dp"])
            rels = {k: rel_err(grad_g[k], grad_d[k]) for k in grad_d}
            worst = max(rels, key=rels.get)
            loss_rel = float(((loss_g - loss_d).abs() / loss_d.abs()).max())
            log(f"GSPMD {name} meta-gradient on a 1 x 1 dp x sp mesh vs the dp mesh's, "
                f"float32, dropout 0.2, key (23, 0), 2 tasks x {mt.inner_batches} inner steps: "
                f"per-task losses {loss_g.tolist()} vs {loss_d.tolist()} (max rel "
                f"{loss_rel:.3e}); gradient max|diff|/max|ref| {rels[worst]:.3e} at {worst} "
                f"(tol 1e-5); {secs_g:.2f} s vs {secs_d:.2f} s; rows 4-13 launches "
                f"{launches_g}")
            if loss_rel > 1e-5 or rels[worst] > 1e-5:
                raise RuntimeError(f"GSPMD {name}: losses off by {loss_rel:.3e}, {worst} off "
                                   f"by {rels[worst]:.3e}")
            if any(launches_g.values()):
                raise RuntimeError(f"GSPMD {name} launched kernels of rows 4-13: {launches_g}")
        if created_group:
            torch.distributed.destroy_process_group()
        del stgcn_model, res

        # (b) `cli meta-train --mesh -o model.family=stgcn` on two gloo ranks
        # on the card (phase 14's launcher), 1 epoch, 1 inner epoch: the
        # GSPMD step (mesh.sp_impl=auto), the same finite losses on both.
        gspmd_args = ("-o", "model.family=stgcn", "-o", "meta.inner_epochs=1")
        out = os.path.join(out_root, "mesh_sp2_gspmd")
        os.makedirs(out)
        ranks = two_ranks(out, *gspmd_args)
        if "the GSPMD step" not in ranks[0]["stderr"]:
            raise RuntimeError("two-rank stgcn meta-train did not name the GSPMD step:\n"
                               + ranks[0]["stderr"][-2000:])
        for rec in ranks:
            if any(rec["launches"].values()):
                raise RuntimeError(f"GSPMD rank {rec['rank']} launched {rec['launches']}")
        with open(os.path.join(out, "meta", "meta_log.jsonl")) as f:
            rec = json.loads(f.readline())
        log(f"two ranks, stgcn on the GSPMD step (dp 1 x sp 2, 256 rows each, gloo on one "
            f"card), epoch 1 (1 inner epoch): meta_loss {rec['meta_loss']:.6f}, tasks "
            f"{rec['task_indices']}, {rec['epoch_seconds']:.2f} s  [{card}]")

        # (c) Chained epochs on one device: 3 epochs in chunks of 2 (2 + 1),
        # then epoch by epoch fed the chained run's task indices.
        recorded = []

        class Replay(mt_engine.DifficultySampler):
            def sample(self):
                return np.asarray(recorded.pop(0))

        runs = {}
        for name, k in (("chained", 2), ("unchained", 1)):
            zero_rows_4_13()
            fetches = maml_mod.fetch_metrics.fetches
            sampler = mt_engine.DifficultySampler
            if name == "unchained":
                recorded = [r["task_indices"] for r in runs["chained"]["log"]]
                mt_engine.DifficultySampler = Replay
            try:
                t0 = time.perf_counter()
                log_k = meta_train("float32", 3, "-o", f"meta.epochs_per_dispatch={k}",
                                   "-o", f"meta.inner_epochs={CLI_INNER_EPOCHS}",
                                   out=f"epochs_k{k}")
                secs = time.perf_counter() - t0
            finally:
                mt_engine.DifficultySampler = sampler
            params_k, _ = load_checkpoint(os.path.join(meta_dir, f"epochs_k{k}", "meta",
                                                       "ckpt_final"))
            runs[name] = {"log": log_k, "params": params_k, "launches": rows_4_13(),
                          "fetches": maml_mod.fetch_metrics.fetches - fetches, "seconds": secs}
        chained, unchained = runs["chained"], runs["unchained"]
        if [r["task_indices"] for r in chained["log"]] != [
                r["task_indices"] for r in unchained["log"]]:
            raise RuntimeError("the unchained run was not fed the chained run's indices")
        if [r.get("dispatch_epochs") for r in chained["log"]] != [2, 2, None]:
            raise RuntimeError(f"chained run's chunks: {chained['log']}")
        losses = np.array([[r["meta_loss"], *r["per_task_loss"]] for r in chained["log"]])
        ref_losses = np.array([[r["meta_loss"], *r["per_task_loss"]] for r in unchained["log"]])
        loss_rel = float((np.abs(losses - ref_losses) / np.abs(ref_losses)).max())
        p_rels = {k: rel_err(chained["params"][k], unchained["params"][k])
                  for k in unchained["params"]}
        p_worst = max(p_rels, key=p_rels.get)
        bitwise = bool((losses == ref_losses).all()) and all(
            torch.equal(chained["params"][k], v) for k, v in unchained["params"].items())
        chain_steps = meta_cfg.meta_batch * CLI_INNER_EPOCHS * meta_cfg.inner_batches
        forwards_epoch = chain_steps + meta_cfg.meta_batch
        want = {"lstm_stack_train": 3 * forwards_epoch,
                "lstm_stack_train.backward": 3 * forwards_epoch,
                "gcn_stack_train": 3 * forwards_epoch,
                "gcn_stack_train.backward": 3 * forwards_epoch,
                "clip_sgd_update": 3 * chain_steps}
        got = {k: chained["launches"][k] for k in want}
        log(f"chained meta epochs, float32, 3 epochs: epochs_per_dispatch=2 (chunks 2 + 1) vs "
            f"1 fed the same indices {[r['task_indices'] for r in chained['log']]}: losses "
            f"max rel {loss_rel:.3e}, final parameters max|diff|/max|ref| {p_rels[p_worst]:.3e} "
            f"at {p_worst} (tol 1e-6); bitwise equal: {bitwise}; metric fetches "
            f"{chained['fetches']} vs {unchained['fetches']}; rows 4-8 launches {got} (want "
            f"{want}); unchained launches {runs['unchained']['launches']}")
        for name, run in runs.items():
            log(f"  {name}: seconds an epoch " + ", ".join(
                f"{r['epoch_seconds']:.3f}" for r in run["log"])
                + f"; the whole CLI call {run['seconds']:.1f} s  [{card}]")
        if loss_rel > 1e-6 or p_rels[p_worst] > 1e-6:
            raise RuntimeError(f"chained vs unchained: losses {loss_rel:.3e}, {p_worst} "
                               f"{p_rels[p_worst]:.3e}")
        if got != want:
            raise RuntimeError(f"the chained run launched rows 4-8 {got}, not {want}")
        if (chained["fetches"], unchained["fetches"]) != (2, 3):
            raise RuntimeError(f"metric fetches {chained['fetches']} (2 chunks), "
                               f"{unchained['fetches']} (3 epochs)")

        # Second order chained: 2 epochs in one chunk, 1 inner epoch: rows
        # 10-11 once an inner step of both epochs, one metrics fetch.
        zero_rows_4_13()
        fetches = maml_mod.fetch_metrics.fetches
        so_log = meta_train("float32", 2, "-o", "meta.second_order=true", "-o",
                            "meta.epochs_per_dispatch=2", "-o", "meta.inner_epochs=1",
                            out="epochs_so_k2")
        # Its own name: the kernels line reads phase 9b's `so_launches`.
        chained_so = rows_4_13()
        so_steps = 2 * meta_cfg.meta_batch * meta_cfg.inner_batches
        log(f"chained SO, float32, 2 epochs in one chunk (1 inner epoch): losses "
            f"{[r['meta_loss'] for r in so_log]}, seconds an epoch "
            f"{[round(r['epoch_seconds'], 3) for r in so_log]}; metric fetches "
            f"{maml_mod.fetch_metrics.fetches - fetches}; launches {chained_so}  [{card}]")
        if (chained_so["hvp_stack_fwd"], chained_so["hvp_stack_bwd"]) != (so_steps, so_steps):
            raise RuntimeError(f"chained SO launched rows 10-11 {chained_so}, not {so_steps}")
        if maml_mod.fetch_metrics.fetches - fetches != 1 or not np.isfinite(
                [v for r in so_log for v in (r["meta_loss"], *r["per_task_loss"])]).all():
            raise RuntimeError(f"chained SO: {so_log}")

        # (d) Chained epochs on two ranks: (b) for 3 epochs in chunks of 2.
        out = os.path.join(out_root, "mesh_sp2_gspmd_k2")
        os.makedirs(out)
        ranks = two_ranks(out, *gspmd_args, "-o", "meta.epochs_per_dispatch=2", "-o",
                          "meta.num_epochs=3")
        with open(os.path.join(out, "meta", "meta_log.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        if [r.get("dispatch_epochs") for r in recs] != [2, 2, None]:
            raise RuntimeError(f"two-rank chained run's chunks: {recs}")
        for r in recs:
            if not np.isfinite([r["meta_loss"], *r["per_task_loss"]]).all():
                raise RuntimeError(f"two-rank chained run: non-finite loss {r}")
        log("two ranks, stgcn on the GSPMD step, 3 epochs in chunks of 2: meta_loss "
            + ", ".join(f"{r['meta_loss']:.6f}" for r in recs) + "; seconds an epoch "
            + ", ".join(f"{r['epoch_seconds']:.2f}" for r in recs) + f"  [{card}]")

    # 24. The wavefront LSTM, the adaptation step's unfolded window batch
    # and _VBATCH on the dp x sp shardmap step.
    with Phase("wavefront LSTM, unfolded adaptation batch, _VBATCH on dp x sp"):
        new_paths = wavefront_vbatch_phase(torch, dev, card, out_root)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log("16-block clusters of the recurrences at once (cudaOccupancyMaxActiveClusters): "
        + json.dumps(wide.pop("max_active_clusters_16")) + f"  [{card}]")

    kernels = []
    log("item 13 (eval forward at float32 H 320 / 384): " + json.dumps(streamed.pop("item13"))
        + f"  [{card}]")
    for name in TPU_KERNELS:
        if name in STREAMED_KERNELS:
            rep = streamed[name][STREAMED_AT]
            kernels.append({
                "name": name,
                "route": "cuda",
                "source": SOURCES[name][0],
                "sources": SOURCES[name],
                "replaces": TPU_KERNELS[name],
                "launches": streamed_main[name],
                "launches_on": STREAMED_MAIN_PATHS[name],
                "max_abs_err": rep.get("max_abs_err", rep.get("max_rel_err")),
                "ms": rep["ms"],
                "plain_ms": rep["plain_ms"],
                "bound_ms": rep["bound_ms"],
                "bound_by": rep["bound_by"],
                "library_ms": rep["library_ms"],
                "at": STREAMED_AT,
                "widths": streamed[name],
            })
            continue
        m = measured[name]
        bound, bound_by = bound_ms(m["bytes"], m["flops"])
        count = next(src[name] for src in (launches, train_launches, so_launches,
                                           shard_launches, route_launches, vbatch_launches,
                                           split_launches) if name in src)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name][0],
            "sources": SOURCES[name],
            "replaces": TPU_KERNELS[name],
            "launches": count,
            "max_abs_err": m["max_abs_err"],
            "ms": m["ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": m["library_ms"],
            # Rows 1, 3, 5 and 15: device time alone, rows 5 and 15 by part
            # (row 5 also its call alone), and the bfloat16 run beside its
            # library call.
            **{k: m[k] for k in ("device_ms", "call_ms", "library_device_ms", "parts_ms",
                                 "bfloat16", "library_call_ms", "core_launches", "by_nl",
                                 "host_ms", "enqueue_ms", "from_g2", "profiler_ms", "plan",
                                 "dwh_cublas_ms", "at_512", "train")
               if k in m},
            # Rows 9, 12, 13, 16 and 17 on phase 24's paths.
            **({"new_paths": new_paths[name]} if name in new_paths else {}),
            # The LSTM rows on 16-block clusters (phase 9d).
            **({"wide": wide[name]} if name in wide else {}),
        })
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


def native_phase(torch, card: str, forecast) -> None:
    """The native host pipeline (`weatherforecast_stgcn_maml_tpu_torch.native`,
    built by g++ in the build phase): its five functions against the numpy
    route on Moscow's region (441 nodes; 720 hourly steps, 5% NaNs): the kNN
    edges and the window gather equal, the adjacency, the NaN fill with its
    stats and the z-score within float32 rounding; then the forecast
    request's host stages (the region's graph and features) and the whole
    request (`forecast(...)`, the CLI in process) with the library on and
    off, in turns (on, off, off, on)."""
    import numpy as np

    from weatherforecast_stgcn_maml_tpu_torch import graph, native
    from weatherforecast_stgcn_maml_tpu_torch.config import (
        ADAPTATION_REGIONS,
        NUM_WEATHER_VARS,
        DataConfig,
        ModelConfig,
    )
    from weatherforecast_stgcn_maml_tpu_torch.data import preprocess
    from weatherforecast_stgcn_maml_tpu_torch.data.windows import WindowSpec, gather_batch
    from weatherforecast_stgcn_maml_tpu_torch.engines.data_source import get_region_data

    if not native.available():
        raise RuntimeError("the native host pipeline is off")
    data_cfg, mc = DataConfig(), ModelConfig()
    box = dict((name, b) for b, name in ADAPTATION_REGIONS)["Moscow"]
    region = get_region_data(box, (data_cfg.validate_year,), data_cfg, tag="forecast",
                             name="Moscow", num_timesteps=720)
    weather = region.weather.copy()
    weather[np.random.default_rng(0).random(weather.shape) < 0.05] = np.nan
    nodes = np.ascontiguousarray(weather.reshape(weather.shape[0], -1, NUM_WEATHER_VARS))

    def numpy_route(fn):
        native.set_enabled(False)
        try:
            return fn()
        finally:
            native.set_enabled(True)

    pos = graph.grid_node_positions(region.lats, region.lons)
    edges = native.knn_edges_native(pos, data_cfg.k_neighbors)
    same_edges = np.array_equal(edges, numpy_route(
        lambda: graph.knn_edges(pos, data_cfg.k_neighbors)))
    a_hat = native.normalized_adjacency_native(edges, len(pos), 512)
    a_err = float(np.abs(a_hat - numpy_route(
        lambda: graph.normalized_adjacency(edges, len(pos), 512))).max())
    filled = nodes.copy()
    mean, std = native.nan_fill_stats_native(filled)
    ref_filled = preprocess.fill_nans_with_mean(nodes.copy())
    ref_stats = preprocess.compute_stats(ref_filled)
    fill_err = float(np.abs(filled - ref_filled).max() / np.abs(ref_filled).max())
    stats_err = max(float(np.abs(mean - ref_stats.mean).max() / np.abs(ref_stats.mean).max()),
                    float(np.abs(std - ref_stats.std).max() / np.abs(ref_stats.std).max()))
    z = filled.copy()
    if not native.normalize_native(z, mean, std):
        raise RuntimeError("the native z-score did not run")
    z_err = float(np.abs(z - (filled - mean) / std).max())
    feats = preprocess.prepare_features(region)[0]
    spec = WindowSpec(mc.window, mc.horizon)
    anchors = np.arange(spec.window, spec.window + 64)
    x, y = native.gather_windows_native(feats, anchors, spec.window, spec.horizon,
                                        NUM_WEATHER_VARS)
    rx, ry = gather_batch(torch.from_numpy(feats), anchors, spec)
    same_windows = np.array_equal(x, rx.numpy()) and np.array_equal(y, ry.numpy())
    log(f"native host pipeline on Moscow ({weather.shape[0]} x {len(pos)} x "
        f"{NUM_WEATHER_VARS}, 5% NaN) against the numpy route: kNN edges equal {same_edges}; "
        f"adjacency max_abs_err {a_err:.3e}; NaN fill max|diff|/max|ref| {fill_err:.3e}, "
        f"stats {stats_err:.3e}; z-score max_abs_err {z_err:.3e}; 64 windows equal "
        f"{same_windows}")
    # The stats' gate is the JAX package's own (tests/test_native.py): the
    # numpy route's float32 means of 1e5-sized variables carry ~1e-4 of
    # rounding that the C++ pass, summing in double, does not.
    if not (same_edges and same_windows) or a_err > 1e-6 or fill_err > 1e-6 or (
            stats_err > 5e-4 or z_err > 1e-4):
        raise RuntimeError("the native host pipeline disagrees with the numpy route")

    def stage_ms(fn, repeats=5):
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    serving = get_region_data(box, (data_cfg.validate_year,), data_cfg, tag="forecast",
                              name="Moscow", num_timesteps=max(mc.window + mc.horizon, 64))
    stages = {
        "graph": lambda: graph.build_region_graph(serving.lats, serving.lons,
                                                  k_neighbors=data_cfg.k_neighbors),
        "features": lambda: preprocess.prepare_features(serving),
        "features 720 steps": lambda: preprocess.prepare_features(region),
        "forecast request": lambda: forecast("Moscow", "float32"),
    }
    quiet = contextlib.redirect_stderr(io.StringIO())  # the request's progress lines
    times = {k: {"on": [], "off": []} for k in stages}
    for turn in ("on", "off", "off", "on"):
        native.set_enabled(turn == "on")
        try:
            with quiet:
                for k, fn in stages.items():
                    times[k][turn].append(stage_ms(fn))
        finally:
            native.set_enabled(True)
    for k, t in times.items():
        log(f"  {k}: library on {t['on'][0]:.3f} / {t['on'][1]:.3f} ms, off {t['off'][0]:.3f} / "
            f"{t['off'][1]:.3f} ms (host, median of 5, in turns)  [{card}]")


# The widths past every cluster that holds Wh (the streamed phase, 9d):
# float32 H 448, 512 and 1024, bfloat16 640 and 1024; the kernels line lists
# each row's numbers there under "streamed".
# Item 13's timing: calls a route a turn, and how far auto's route may lie
# above the fastest route's mean of two turns (at the forecast's 512 rows the
# streamed and 16-block plans came within 0.1% in one run, and one route's
# two turns differed by up to 9%: PERF.md §6).
ITEM13_REPEATS = 10
ITEM13_MARGIN = 1.05
STREAM_WIDTHS = (("float32", 448), ("float32", 512), ("float32", 1024), ("bfloat16", 640),
                 ("bfloat16", 1024))
# The widths only a 16-block cluster holds Wh at (the wide phase): float32
# H 320 and 384, bfloat16 512; the kernels line lists each row's numbers
# there under "wide".
WIDE_WIDTHS = (("float32", 320), ("float32", 384), ("bfloat16", 512))


def wide_cluster_phase(torch, dev, card: str) -> dict:
    """Every LSTM cluster recurrence on 16-block clusters (Hopper's
    non-portable size), where no cluster of 8 holds Wh: at float32 H 320 and
    384 and bfloat16 H 512, at the inner step's shapes (x [24, 512, 256], 4
    layers, masks at rate 0.2 and off), rows 4-5 and 16-17 (V = 2) forward
    and every gradient, rows 10-11 (tangents at HVP_TOL), rows 18-19 at xp
    [24, 512, 4H], rows 2 and 20 at [512, 24, 256] and [1536, 24, 256],
    each against its plain version at TOL, gated on its launches; each
    plan's cluster size (16) and the card's cudaOccupancyMaxActiveClusters
    beside `fused_lstm_stack.H100_CLUSTERS_16`; each row's device time (CUDA
    events), the plain version's, cuDNN's LSTM where one computes the same
    function, and the bound. Returns {kernel name: {"<dtype> H <width>":
    numbers}} for the kernels line."""
    import numpy as np

    from weatherforecast_stgcn_maml_tpu_torch.models.common import draw_mask
    from weatherforecast_stgcn_maml_tpu_torch.models.lstm import init_lstm
    from weatherforecast_stgcn_maml_tpu_torch.ops import cuda_build, fused_lstm, lstm_scan
    from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_hvp as fh
    from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack as fls

    lib = cuda_build.load()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    w_len, n, c_in, n_l, keep = 24, 512, 256, 4, 0.8
    found: dict = {}

    def lstm_flops(rows, hidden):
        return sum(2 * w_len * rows * ((c_in if l == 0 else hidden) + hidden) * 4 * hidden
                   for l in range(n_l))

    def record(name, label, dt_name, ms, plain_ms, n_bytes, flops, **extra):
        bound, bound_by = bound_ms(n_bytes, flops, dt_name)
        found.setdefault(name, {})[label] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by, **extra}
        log(f"  {name} {label}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
            f"({bound_by})" + "".join(f", {k} {v}" for k, v in extra.items()) + f"  [{card}]")

    def fwd_bwd(fn, inputs, params, ct):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        return out.detach(), torch.autograd.grad(out, leaves + list(params), ct)

    def check(what, got, ref, got_g, ref_g, tol):
        fwd = float((got.float() - ref.float()).abs().max())
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol, msg=what)
        worst = max(rel_err(a, b) for a, b in zip(got_g, ref_g)) if got_g else 0.0
        if worst > tol:
            raise RuntimeError(f"{what}: gradient max|diff|/max|ref| {worst:.3e} > {tol}")
        return fwd, worst

    for dt_name, hidden in WIDE_WIDTHS:
        dt = getattr(torch, dt_name)
        tol, e = TOL[dt_name], dt.itemsize
        label = f"{dt_name} H {hidden}"
        code = cuda_build.dtype_code(dt)
        g4 = 4 * hidden
        log(f"16-block clusters at {label}:")
        for what, plan, query in (
                ("forward recurrence, 512 rows", fls.forward_plan(hidden, n, e, sms),
                 lib.wf_lstm_stack_forward_clusters),
                ("forward recurrence, 2 x 512 rows", fls.forward_plan(hidden, n, e, sms, 2),
                 lib.wf_lstm_stack_forward_clusters),
                ("forward recurrence, 1536 rows", fls.forward_plan(hidden, 1536, e, sms),
                 lib.wf_lstm_stack_forward_clusters),
                ("backward recurrence, 512 rows", fls.recurrence_plan(hidden, n, e, sms),
                 lib.wf_lstm_stack_recurrence_clusters),
                ("backward recurrence, 2 x 512 rows", fls.recurrence_plan(hidden, n, e, sms, 2),
                 lib.wf_lstm_stack_recurrence_clusters),
                ("tangent forward recurrence, 512 rows", fh.tangent_forward_plan(hidden, n, e, sms),
                 lib.wf_lstm_tangent_forward_clusters),
                ("tangent recurrence, 512 rows", fh.tangent_plan(hidden, n, e, sms),
                 lib.wf_lstm_tangent_recurrence_clusters)):
            cs, hcp, rb = plan[:3]
            active = query(code, cs, hcp, rb, hidden)
            log(f"  {what}: cluster of {cs}, {hcp} weight columns, {rb} rows a cluster; "
                f"cudaOccupancyMaxActiveClusters {active} (the plans assume "
                f"{fls.H100_CLUSTERS_16})  [{card}]")
            if cs != fls.WIDE_CLUSTER or active <= 0:
                raise RuntimeError(f"{what} at {label}: plan {plan}, {active} clusters at once")
        found.setdefault("max_active_clusters_16", {})[label] = active

        lstm = init_lstm(torch.Generator().manual_seed(hidden), c_in, hidden, n_l).to(dev)
        params = [p for layer in lstm.layers for p in (layer.wx, layer.wh, layer.b)]
        w_bytes = 4 * sum(p.numel() for p in params)
        rng = np.random.default_rng(hidden)

        def card_array(*shape, scale=1.0):
            return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

        x = card_array(n, w_len, c_in)  # [B, T, C]: 512 rows of one inner step
        ct = card_array(n, hidden)
        masks = draw_mask(torch.Generator(device=dev).manual_seed(1),
                          (n_l - 1, w_len, n, hidden), 0.2, dev)
        cudnn = torch.nn.LSTM(c_in, hidden, n_l, batch_first=True).to(dev, dt)
        xd = x.to(dt)

        # Rows 4-5: a gemm_nn and a recurrence launch a layer each way.
        train = fls.lstm_stack_train

        def counts():
            return (train.launches, train.backward_launches, train.forward_recurrence_launches,
                    train.forward_gemm_nn_launches, train.backward_recurrence_launches,
                    train.backward_gemm_nn_launches)

        errs45, moved45 = [], []
        for m_label, m in (("masks 0.2", masks), ("masks off", None)):
            k = keep if m is not None else 1.0
            before = counts()
            got, got_g = fwd_bwd(lambda a: train(lstm.layers, a, masks=m, keep=k,
                                                 compute_dtype=dt), [x], params, ct)
            moved = tuple(a - b for a, b in zip(counts(), before))
            ref, ref_g = fwd_bwd(lambda a: fls.lstm_stack_plain(lstm.layers, a, dt, m, k),
                                 [x], params, ct)
            fwd, worst = check(f"rows 4-5 {label} {m_label}", got, ref, got_g, ref_g, tol)
            errs45.append((fwd, worst))
            log(f"  rows 4-5 {m_label}: forward max_abs_err {fwd:.3e}, gradients "
                f"max|diff|/max|ref| {worst:.3e} (tol {tol}); launches {moved}")
            if moved != (1, 1, n_l, n_l, n_l, n_l):
                raise RuntimeError(f"rows 4-5 at {label}: launches {moved}")
            moved45.append(moved)
        xr = x.detach().requires_grad_(True)
        fwd_k = cuda_ms(torch, lambda: train(lstm.layers, xr, masks=masks, keep=keep,
                                             compute_dtype=dt))
        both_k = cuda_ms(torch, lambda: fwd_bwd(lambda a: train(
            lstm.layers, a, masks=masks, keep=keep, compute_dtype=dt), [x], params, ct))
        fwd_p = cuda_ms(torch, lambda: fls.lstm_stack_plain(lstm.layers, xr, dt, masks, keep),
                        repeats=2)
        both_p = cuda_ms(torch, lambda: fwd_bwd(lambda a: fls.lstm_stack_plain(
            lstm.layers, a, dt, masks, keep), [x], params, ct), repeats=2)
        xc = xd.detach().requires_grad_(True)
        fwd_c = cuda_ms(torch, lambda: cudnn(xc)[0])
        both_c = cuda_ms(torch, lambda: torch.autograd.grad(
            cudnn(xc)[0][:, -1], [xc, *cudnn.parameters()], ct.to(dt)))
        io = 4 * x.numel() + w_bytes + masks.numel()
        res = 2 * n_l * w_len * n * hidden * e
        fl = lstm_flops(n, hidden)
        record("lstm_stack_train", label, dt_name, fwd_k, fwd_p, io + res + 4 * n * hidden, fl,
               cudnn_ms=fwd_c, max_abs_err=max(e[0] for e in errs45),
               launches=sum(m[0] for m in moved45))
        record("lstm_stack_train.backward", label, dt_name, both_k - fwd_k, both_p - fwd_p,
               io + res + 4 * n * hidden + 4 * x.numel() + w_bytes, 2 * fl,
               cudnn_ms=both_c - fwd_c, max_rel_err=max(e[1] for e in errs45),
               launches=sum(m[1] for m in moved45))

        # Rows 10-11 after rows 4-5 at the same point.
        xt = x.transpose(0, 1).contiguous()  # [T, B, C]
        wcat = [torch.cat([layer.wx, layer.wh]).detach() for layer in lstm.layers]
        twcat = [card_array(*w.shape, scale=0.1) for w in wcat]
        b2d = torch.stack([layer.b.detach() for layer in lstm.layers])
        tb2d, tx, tg = card_array(n_l, g4, scale=0.1), card_array(*xt.shape), card_array(n, hidden)
        h_last, h_all, c_all, gates = fh.stack_fwd(xt, wcat, b2d, masks, keep, dt)
        before = (fh.hvp_stack_fwd.launches, fh.hvp_stack_bwd.launches)

        def row10():
            return fh.hvp_stack_fwd(xt, tx, wcat, twcat, b2d, tb2d, masks, keep, dt,
                                    res=(h_all, c_all, gates))

        th_last, th_all, tc_all, tgates = row10()
        bwd = fh.stack_bwd(ct, xt, h_all, c_all, gates, wcat, masks, keep, dt)

        def row11():
            return fh.hvp_stack_bwd(ct, tg, xt, tx, h_all, th_all, c_all, tc_all, gates, tgates,
                                    wcat, twcat, masks, keep, dt, res=tuple(bwd[3:6]))

        tdx, tdw, tdb = row11()
        moved = (fh.hvp_stack_fwd.launches - before[0], fh.hvp_stack_bwd.launches - before[1])

        def plain_10():
            return fh.hvp_fwd_plain(xt, wcat, b2d, masks, keep, dt, tx, twcat, tb2d)

        ref_f = plain_10()

        def plain_11():
            return fh.hvp_bwd_plain(ct, xt, *ref_f[1:4], wcat, masks, keep, dt, tg, tx,
                                    *ref_f[5:8], twcat)

        ref_b = plain_11()
        ttol = HVP_TOL[dt_name]
        errs = {"th_last": rel_err(th_last, ref_f[4]), "th_all": rel_err(th_all, ref_f[5]),
                "tc_all": rel_err(tc_all, ref_f[6]), "tgates": rel_err(tgates, ref_f[7]),
                "tdx": rel_err(tdx, ref_b[6]), "tdb": rel_err(tdb, ref_b[8]),
                **{f"tdw{l}": rel_err(a, b) for l, (a, b) in enumerate(zip(tdw, ref_b[7]))}}
        worst = max(errs, key=errs.get)
        log(f"  rows 10-11 masks 0.2: tangents max|diff|/max|ref| {errs[worst]:.3e} at {worst} "
            f"(tol {ttol}); launches {moved}")
        if moved != (1, 1) or errs[worst] > ttol:
            raise RuntimeError(f"rows 10-11 at {label}: launches {moved}, {worst} {errs[worst]}")
        res_b = n_l * w_len * n * hidden * 4
        gate_b, x_b = 4 * res_b, w_len * n * c_in * 4
        masks_b = masks.numel()
        record("hvp_stack_fwd", label, dt_name, cuda_ms(torch, row10),
               cuda_ms(torch, plain_10, repeats=1),
               2 * x_b + 2 * w_bytes + masks_b + 4 * res_b + 2 * gate_b + n * hidden * 4, 2 * fl,
               max_rel_err=max(errs[k] for k in ("th_last", "th_all", "tc_all", "tgates")),
               launches=moved[0])
        record("hvp_stack_bwd", label, dt_name, cuda_ms(torch, row11),
               cuda_ms(torch, plain_11, repeats=1),
               2 * n * hidden * 4 + 4 * gate_b + 6 * res_b + 3 * x_b + masks_b + 3 * w_bytes,
               4 * fl, max_rel_err=max(v for k, v in errs.items() if k.startswith("td")),
               launches=moved[1])
        del bwd, h_all, c_all, gates, th_all, tc_all, tgates, ref_f, ref_b

        # Rows 16-17 at V = 2, each task its own weights.
        tasks = [init_lstm(torch.Generator().manual_seed(hidden + v), c_in, hidden,
                           n_l).to(dev).layers for v in (1, 2)]
        w0 = torch.stack([torch.cat([t[0].wx, t[0].wh]) for t in tasks]).detach()
        wr = torch.stack([torch.stack([torch.cat([t[l].wx, t[l].wh]) for l in range(1, n_l)])
                          for t in tasks]).detach()
        bv = torch.stack([torch.stack([layer.b for layer in t]) for t in tasks]).detach()
        xv = card_array(2, n, w_len, c_in)
        ctv = card_array(2, n, hidden)
        mv = draw_mask(torch.Generator(device=dev).manual_seed(2),
                       (2, n_l - 1, w_len, n, hidden), 0.2, dev)
        fn = fls.lstm_stack_train_tasks
        errs1617, moved1617 = [], []
        for m_label, m in (("masks 0.2", mv), ("masks off", None)):
            k = keep if m is not None else 1.0
            before = (fn.launches, fn.backward_launches)
            got, got_g = fwd_bwd(lambda a, w0, b, wr: fn(a, w0, wr, b, masks=m, keep=k,
                                                         compute_dtype=dt),
                                 [xv, w0, bv, wr], [], ctv)
            moved = (fn.launches - before[0], fn.backward_launches - before[1])
            ref, ref_g = fwd_bwd(lambda a, w0, b, wr: fls.lstm_stack_tasks_plain(
                a, w0, wr, b, m, k, dt), [xv, w0, bv, wr], [], ctv)
            fwd, worst = check(f"rows 16-17 {label} {m_label}", got, ref, got_g, ref_g, tol)
            errs1617.append((fwd, worst))
            log(f"  rows 16-17 V = 2 {m_label}: forward max_abs_err {fwd:.3e}, gradients "
                f"max|diff|/max|ref| {worst:.3e} (tol {tol}); launches {moved}")
            if moved != (1, 1):
                raise RuntimeError(f"rows 16-17 at {label}: launches {moved}")
            moved1617.append(moved)
        leaves = [t.detach().requires_grad_(True) for t in (xv, w0, bv, wr)]
        fwd_k = cuda_ms(torch, lambda: fn(leaves[0], leaves[1], leaves[3], leaves[2], masks=mv,
                                          keep=keep, compute_dtype=dt))
        both_k = cuda_ms(torch, lambda: fwd_bwd(lambda a, w0, b, wr: fn(
            a, w0, wr, b, masks=mv, keep=keep, compute_dtype=dt), [xv, w0, bv, wr], [], ctv))
        fwd_p = cuda_ms(torch, lambda: fls.lstm_stack_tasks_plain(
            leaves[0], leaves[1], leaves[3], leaves[2], mv, keep, dt), repeats=2)
        both_p = cuda_ms(torch, lambda: fwd_bwd(lambda a, w0, b, wr: fls.lstm_stack_tasks_plain(
            a, w0, wr, b, mv, keep, dt), [xv, w0, bv, wr], [], ctv), repeats=2)
        record("lstm_stack_train_tasks", label, dt_name, fwd_k, fwd_p,
               2 * (io + res + 4 * n * hidden), 2 * fl, cudnn_ms=2 * fwd_c,
               max_abs_err=max(e[0] for e in errs1617),
               launches=sum(m[0] for m in moved1617))
        record("lstm_stack_train_tasks.backward", label, dt_name, both_k - fwd_k, both_p - fwd_p,
               2 * (io + res + 4 * n * hidden + 4 * x.numel() + w_bytes), 4 * fl,
               cudnn_ms=2 * (both_c - fwd_c), max_rel_err=max(e[1] for e in errs1617),
               launches=sum(m[1] for m in moved1617))
        del xv, mv, leaves, got, got_g, ref, ref_g

        # Rows 18-19: one layer's recurrence at xp [24, 512, 4H].
        xp = card_array(w_len, n, g4)
        wh = card_array(hidden, g4, scale=hidden ** -0.5).requires_grad_(True)
        cth = card_array(w_len, n, hidden)
        rec = lstm_scan.lstm_recurrence
        before = (rec.launches, rec.backward_launches, rec.backward_gemm_tn_launches)
        got, got_g = fwd_bwd(lambda a: rec(a, wh, compute_dtype=dt), [xp], [wh], cth)
        moved = tuple(a - b for a, b in zip(
            (rec.launches, rec.backward_launches, rec.backward_gemm_tn_launches), before))
        ref, ref_g = fwd_bwd(lambda a: lstm_scan.lstm_recurrence_plain(a, wh, dt), [xp], [wh],
                             cth)
        fwd, worst = check(f"rows 18-19 {label}", got, ref, got_g, ref_g, tol)
        log(f"  rows 18-19: forward max_abs_err {fwd:.3e}, gradients max|diff|/max|ref| "
            f"{worst:.3e} (tol {tol}); launches {moved}")
        if moved != (1, 1, 1):
            raise RuntimeError(f"rows 18-19 at {label}: launches {moved}")
        xpr = xp.detach().requires_grad_(True)
        fwd_k = cuda_ms(torch, lambda: rec(xpr, wh, compute_dtype=dt))
        both_k = cuda_ms(torch, lambda: fwd_bwd(lambda a: rec(a, wh, compute_dtype=dt), [xp],
                                                [wh], cth))
        fwd_p = cuda_ms(torch, lambda: lstm_scan.lstm_recurrence_plain(xpr, wh, dt), repeats=2)
        both_p = cuda_ms(torch, lambda: fwd_bwd(lambda a: lstm_scan.lstm_recurrence_plain(
            a, wh, dt), [xp], [wh], cth), repeats=2)
        rec_flops = 2 * w_len * n * hidden * g4
        rec_io = 4 * (w_len * n * g4 + hidden * g4 + 2 * w_len * n * hidden)
        record("lstm_recurrence", label, dt_name, fwd_k, fwd_p, rec_io, rec_flops,
               max_abs_err=fwd, launches=moved[0])
        record("lstm_recurrence.backward", label, dt_name, both_k - fwd_k, both_p - fwd_p,
               4 * (w_len * n * hidden + w_len * n * g4 + 2 * w_len * n * hidden + hidden * g4)
               + 4 * (w_len * n * g4 + hidden * g4), 2 * rec_flops, max_rel_err=worst,
               launches=moved[1])
        del xp, xpr, wh, got, got_g, ref, ref_g

        # Rows 2 and 20: the eval forward at the forecast's and validate's rows.
        with torch.no_grad():
            for rows in (n, 3 * n):
                xe = card_array(rows, w_len, c_in)
                ref = fls.lstm_stack_plain(lstm.layers, xe, dt)
                plain_ms = cuda_ms(torch, lambda: fls.lstm_stack_plain(lstm.layers, xe, dt),
                                   repeats=2)
                xe_d = xe.to(dt)
                lib_ms = cuda_ms(torch, lambda: cudnn(xe_d)[0])
                for name, entry in (("lstm_stack_last_all", fls.lstm_stack_last_all),
                                    ("fused_lstm_last_hidden", fused_lstm.fused_lstm_last_hidden)):
                    before = entry.launches
                    got = entry(lstm.layers, xe, compute_dtype=dt)
                    moved = entry.launches - before
                    if moved != 1:
                        raise RuntimeError(f"{name} at {label}: {moved} launches")
                    err = float((got - ref).abs().max())
                    torch.testing.assert_close(got, ref, rtol=tol, atol=tol, msg=name)
                    record(name, f"{label}, {rows} rows", dt_name,
                           cuda_ms(torch, lambda: entry(lstm.layers, xe, compute_dtype=dt)),
                           plain_ms, 4 * xe.numel() + w_bytes + 4 * rows * hidden,
                           lstm_flops(rows, hidden), cudnn_ms=lib_ms, max_abs_err=err,
                           launches=moved)
        del lstm, cudnn, x, xd, xr, xc, masks
        torch.cuda.empty_cache()
    return found


def streamed_phase(torch, dev, card: str, repeats: int = 3) -> dict:
    """The LSTM rows on streamed plans (past every cluster that holds Wh:
    a block keeps what fits of its slice in shared memory and streams the
    rest from L2), at float32 H 448, 512 and 1024 and bfloat16 H 640 and
    1024, at the inner step's shapes (x [24, 512, 256], 4 layers): rows 4-5
    and 14-15 (masks at 0.2 and off; forward and every gradient), rows 18-19
    (xp [24, 512, 4H]), rows 2 and 20 ([512, 24, 256]), each against its
    plain version at TOL, gated on its launches and its streamed launches;
    each row's device time by CUDA graph replay (`repeats`; a backward's:
    its forward and backward in one graph less the forward), its plain
    version's and cuDNN's LSTM by events (rows 2, 4 and 14 its forward;
    rows 5 and 15 its backward), the bound, k_res / K and the L2 bytes a
    step of each plan. Then item 13 of ROADMAP: the eval forward at
    validate's [1536, 24, 256] and the forecast's [512, 24, 256], float32 H
    320 and 384: `apply_lstm(kernel="auto")` takes the route
    `eval_planned` names (the kernels on `eval_plan`'s plan, counted on row
    2, or the plain stack, counted as a plain route), equal to the plain
    stack; the streamed plan, the 16-block plan and the plain stack by
    events in turns (A B C C B A, `ITEM13_REPEATS` calls each), the route's
    time no more than the plain stack's and within `ITEM13_MARGIN` of the
    fastest route's. Returns {kernel name: {"<dtype> H <width>": numbers}}
    and {"item13": times}; the launches a row records here are checks, not
    the kernels line's main-path counts (phases 9c and 16)."""
    import numpy as np

    from weatherforecast_stgcn_maml_tpu_torch.models.common import draw_mask
    from weatherforecast_stgcn_maml_tpu_torch.models.lstm import init_lstm
    from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm, lstm_scan
    from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack as fls

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    w_len, n, c_in, n_l, keep = 24, 512, 256, 4, 0.8
    found: dict = {}

    def lstm_flops(rows, hidden):
        return sum(2 * w_len * rows * ((c_in if l == 0 else hidden) + hidden) * 4 * hidden
                   for l in range(n_l))

    def record(name, label, dt_name, ms, plain_ms, n_bytes, flops, launches, **extra):
        bound, bound_by = bound_ms(n_bytes, flops, dt_name)
        found.setdefault(name, {})[label] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "launches": launches, **extra}
        log(f"  {name} {label}: {ms:.4f} ms (graph replay), plain {plain_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({bound_by}), launches {launches}"
            + "".join(f", {k} {v}" for k, v in extra.items()) + f"  [{card}]")

    def moved(entry, before):
        return tuple(a - b for a, b in zip(counts(entry), before))

    def counts(entry):
        return (entry.launches, getattr(entry, "backward_launches", 0), entry.streamed_launches,
                getattr(entry, "backward_streamed_launches", 0))

    def fwd_bwd(fn, inputs, params, ct):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        return out.detach(), torch.autograd.grad(out, leaves + list(params), ct)

    def backward_ms(fn, inputs, params, ct, forward_ms):
        """The backward's device time: the forward and its backward in one
        graph (autograd runs a backward on its forward's stream, so both
        are captured), replayed, less the forward's."""
        return graph_ms(torch, lambda: fwd_bwd(fn, inputs, params, ct), repeats) - forward_ms

    def check(what, got, ref, got_g, ref_g, tol):
        fwd = float((got.float() - ref.float()).abs().max())
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol, msg=what)
        worst = max(rel_err(a, b) for a, b in zip(got_g, ref_g)) if got_g else 0.0
        if worst > tol:
            raise RuntimeError(f"{what}: gradient max|diff|/max|ref| {worst:.3e} > {tol}")
        return fwd, worst

    for dt_name, hidden in STREAM_WIDTHS:
        dt = getattr(torch, dt_name)
        tol, e = TOL[dt_name], dt.itemsize
        label = f"{dt_name} H {hidden}"
        g4 = 4 * hidden
        plans = {}
        for what, fwd, plan in (("forward", True, fls.forward_plan(hidden, n, e, sms)),
                                ("backward", False, fls.recurrence_plan(hidden, n, e, sms))):
            k_rows = hidden if fwd else g4
            if not fls.streams(plan, k_rows):
                raise RuntimeError(f"the {what} plan at {label} does not stream: {plan}")
            plans[what] = {"plan": plan, "k_res_of_k": f"{plan[3]} / {k_rows}",
                           "l2_mb_a_step": -(-n // plan[2]) * plan[0] * (k_rows - plan[3])
                           * fls._slice_row_bytes(plan[1], e, fwd) / 1e6}
        log(f"streamed plans at {label}, 512 rows: {json.dumps(plans)}")
        lstm = init_lstm(torch.Generator().manual_seed(hidden), c_in, hidden, n_l).to(dev)
        params = [p for layer in lstm.layers for p in (layer.wx, layer.wh, layer.b)]
        w_bytes = 4 * sum(p.numel() for p in params)
        rng = np.random.default_rng(hidden)

        def card_array(*shape, scale=1.0):
            return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

        x = card_array(n, w_len, c_in)
        ct = card_array(n, hidden)
        masks = draw_mask(torch.Generator(device=dev).manual_seed(1),
                          (n_l - 1, w_len, n, hidden), 0.2, dev)
        cudnn = torch.nn.LSTM(c_in, hidden, n_l, batch_first=True).to(dev, dt)
        xc = x.to(dt).detach().requires_grad_(True)
        cudnn_fwd = cuda_ms(torch, lambda: cudnn(xc)[0], repeats)
        cudnn_both = cuda_ms(torch, lambda: torch.autograd.grad(
            cudnn(xc)[0][:, -1], [xc, *cudnn.parameters()], ct.to(dt)), repeats)
        io = 4 * x.numel() + w_bytes + masks.numel()
        res = 2 * n_l * w_len * n * hidden * e
        fl = lstm_flops(n, hidden)

        # Rows 4-5 and 14-15: one launch each way, each on streamed plans.
        for name, entry in (("lstm_stack_train", fls.lstm_stack_train),
                            ("lstm_stack_split", fls.lstm_stack_split)):
            errs, launched = [], []
            for m_label, m in (("masks 0.2", masks), ("masks off", None)):
                k = keep if m is not None else 1.0
                before = counts(entry)
                got, got_g = fwd_bwd(lambda a: entry(lstm.layers, a, masks=m, keep=k,
                                                     compute_dtype=dt), [x], params, ct)
                got_moved = moved(entry, before)
                ref, ref_g = fwd_bwd(lambda a: fls.lstm_stack_plain(lstm.layers, a, dt, m, k),
                                     [x], params, ct)
                errs.append(check(f"{name} {label} {m_label}", got, ref, got_g, ref_g, tol))
                log(f"  {name} {m_label}: forward max_abs_err {errs[-1][0]:.3e}, gradients "
                    f"max|diff|/max|ref| {errs[-1][1]:.3e} (tol {tol}); launches (forward, "
                    f"backward, streamed forward, streamed backward) {got_moved}")
                if got_moved != (1, 1, 1, 1):
                    raise RuntimeError(f"{name} at {label}: launches {got_moved}")
                launched.append(got_moved)
            xr = x.detach().requires_grad_(True)
            fwd_k = graph_ms(torch, lambda: entry(lstm.layers, xr, masks=masks, keep=keep,
                                                  compute_dtype=dt), repeats)
            bwd_k = backward_ms(lambda a: entry(lstm.layers, a, masks=masks, keep=keep,
                                                compute_dtype=dt), [x], params, ct, fwd_k)
            fwd_p = cuda_ms(torch, lambda: fls.lstm_stack_plain(lstm.layers, xr, dt, masks, keep),
                            repeats=2)
            both_p = cuda_ms(torch, lambda: fwd_bwd(lambda a: fls.lstm_stack_plain(
                lstm.layers, a, dt, masks, keep), [x], params, ct), repeats=2)
            record(name + ".streamed", label, dt_name, fwd_k, fwd_p,
                   io + res + 4 * n * hidden, fl, sum(m[2] for m in launched),
                   library_ms=cudnn_fwd, max_abs_err=max(v[0] for v in errs),
                   plan=plans["forward"])
            record(name + ".backward.streamed", label, dt_name, bwd_k, both_p - fwd_p,
                   io + res + 4 * n * hidden + 4 * x.numel() + w_bytes, 2 * fl,
                   sum(m[3] for m in launched), library_ms=cudnn_both - cudnn_fwd,
                   max_rel_err=max(v[1] for v in errs), plan=plans["backward"])

        # Rows 18-19: one layer's recurrence at xp [24, 512, 4H].
        xp = card_array(w_len, n, g4)
        wh = card_array(hidden, g4, scale=hidden ** -0.5).requires_grad_(True)
        cth = card_array(w_len, n, hidden)
        rec = lstm_scan.lstm_recurrence
        before = counts(rec)
        got, got_g = fwd_bwd(lambda a: rec(a, wh, compute_dtype=dt), [xp], [wh], cth)
        got_moved = moved(rec, before)
        ref, ref_g = fwd_bwd(lambda a: lstm_scan.lstm_recurrence_plain(a, wh, dt), [xp], [wh],
                             cth)
        fwd, worst = check(f"rows 18-19 {label}", got, ref, got_g, ref_g, tol)
        log(f"  rows 18-19: forward max_abs_err {fwd:.3e}, gradients max|diff|/max|ref| "
            f"{worst:.3e} (tol {tol}); launches {got_moved}")
        if got_moved != (1, 1, 1, 1):
            raise RuntimeError(f"rows 18-19 at {label}: launches {got_moved}")
        xpr = xp.detach().requires_grad_(True)
        fwd_k = graph_ms(torch, lambda: rec(xpr, wh, compute_dtype=dt), repeats)
        bwd_k = backward_ms(lambda a: rec(a, wh, compute_dtype=dt), [xp], [wh], cth, fwd_k)
        fwd_p = cuda_ms(torch, lambda: lstm_scan.lstm_recurrence_plain(xpr, wh, dt), repeats=2)
        both_p = cuda_ms(torch, lambda: fwd_bwd(lambda a: lstm_scan.lstm_recurrence_plain(
            a, wh, dt), [xp], [wh], cth), repeats=2)
        rec_flops = 2 * w_len * n * hidden * g4
        rec_io = 4 * (w_len * n * g4 + hidden * g4 + 2 * w_len * n * hidden)
        record("lstm_recurrence.streamed", label, dt_name, fwd_k, fwd_p, rec_io, rec_flops,
               got_moved[2], library_ms=None, max_abs_err=fwd, plan=plans["forward"])
        record("lstm_recurrence.backward.streamed", label, dt_name, bwd_k, both_p - fwd_p,
               4 * (w_len * n * hidden + w_len * n * g4 + 2 * w_len * n * hidden + hidden * g4)
               + 4 * (w_len * n * g4 + hidden * g4), 2 * rec_flops, got_moved[3],
               library_ms=None, max_rel_err=worst, plan=plans["backward"])
        del xp, xpr, wh, got, got_g, ref, ref_g

        # Rows 2 and 20: the eval forward at the forecast's rows.
        with torch.no_grad():
            ref = fls.lstm_stack_plain(lstm.layers, x, dt)
            plain_ms = cuda_ms(torch, lambda: fls.lstm_stack_plain(lstm.layers, x, dt), repeats=2)
            for name, entry in (("lstm_stack_last_all", fls.lstm_stack_last_all),
                                ("fused_lstm_last_hidden", fused_lstm.fused_lstm_last_hidden)):
                before = counts(entry)
                got = entry(lstm.layers, x, compute_dtype=dt)
                got_moved = moved(entry, before)
                if got_moved[0] != 1 or got_moved[2] != 1:
                    raise RuntimeError(f"{name} at {label}: launches {got_moved}")
                err = float((got - ref).abs().max())
                torch.testing.assert_close(got, ref, rtol=tol, atol=tol, msg=name)
                record(name + ".streamed", label, dt_name,
                       graph_ms(torch, lambda: entry(lstm.layers, x, compute_dtype=dt), repeats),
                       plain_ms, 4 * x.numel() + w_bytes + 4 * n * hidden, fl, got_moved[2],
                       library_ms=cudnn_fwd, max_abs_err=err, plan=plans["forward"])
        del lstm, cudnn, x, xc, masks
        torch.cuda.empty_cache()

    # Item 13: validate's and the forecast's eval forward at float32 H 320
    # and 384: the route `auto` takes (`eval_planned`: the kernels on
    # `eval_plan`'s plan, or the plain stack), the 16-block plan, the
    # cheapest streamed plan and the plain stack, by events in turns.
    from weatherforecast_stgcn_maml_tpu_torch.models.lstm import apply_lstm

    found["item13"] = {}
    for hidden in (320, 384):
        lstm = init_lstm(torch.Generator().manual_seed(hidden), c_in, hidden, n_l).to(dev)
        for rows in (3 * n, n):
            xe = torch.from_numpy(np.random.default_rng(rows).standard_normal(
                (rows, w_len, c_in)).astype(np.float32)).to(dev)
            planned = fls.eval_planned(c_in, hidden, rows, torch.float32, dev)
            stream_plan = fls.stream_plans(hidden, rows, 4, sms, True)[0]
            wide_plan = fls.forward_plan(hidden, rows, 4, sms)
            auto_plan = fls.eval_plan(hidden, rows, 4, sms)
            route = ("plain" if not planned else "streamed" if auto_plan == stream_plan
                     else "wide" if auto_plan == wide_plan else None)
            if route is None:
                raise RuntimeError(f"item 13 at float32 H {hidden}, {rows} rows: eval_plan "
                                   f"{auto_plan} is neither {stream_plan} nor {wide_plan}")
            saved = fls.eval_plan

            def on_plan(plan):
                def run():
                    fls.eval_plan = lambda *a, **k: plan
                    try:
                        return fls.lstm_stack_last_all(lstm.layers, xe)
                    finally:
                        fls.eval_plan = saved
                return run

            def run_plain():
                return fls.lstm_stack_plain(lstm.layers, xe, torch.float32)

            with torch.no_grad():
                ref = run_plain()
                before = (fls.lstm_stack_last_all.launches, fls.lstm_stack_train.plain_routes)
                got = apply_lstm(lstm, xe, kernel="auto")
                took = (fls.lstm_stack_last_all.launches - before[0],
                        fls.lstm_stack_train.plain_routes - before[1])
                if took != ((1, 0) if planned else (0, 1)):
                    raise RuntimeError(f"auto at float32 H {hidden}, {rows} rows (eval_planned "
                                       f"{planned}) took (kernel, plain) {took}")
                torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5, msg="auto")
                routes = {"wide": on_plan(wide_plan), "streamed": on_plan(stream_plan),
                          "plain": run_plain}
                for what in ("wide", "streamed"):
                    torch.testing.assert_close(routes[what](), ref, rtol=1e-5, atol=1e-5,
                                               msg=what)
                times = {k: [] for k in routes}
                for turn in (list(routes), list(routes)[::-1]):
                    for k in turn:
                        times[k].append(cuda_ms(torch, routes[k], ITEM13_REPEATS))
            got = {k: statistics.mean(v) for k, v in times.items()}
            fastest = min(got, key=got.get)
            key = f"float32 H {hidden}, {rows} rows"
            found["item13"][key] = {"eval_planned": planned, "route": route,
                                    "streamed_plan": stream_plan, "wide_plan": wide_plan,
                                    **{f"{k}_ms": v for k, v in got.items()}, "turns": times}
            log(f"  item 13 {key}: auto takes the {route} route (eval_planned {planned}); "
                f"streamed plan {stream_plan} {got['streamed']:.4f} ms, 16-block plan "
                f"{wide_plan} {got['wide']:.4f} ms, plain stack {got['plain']:.4f} ms (events, "
                f"two turns: {json.dumps(times)}); fastest: {fastest}  [{card}]")
            if got[route] > got["plain"] or got[route] > ITEM13_MARGIN * got[fastest]:
                raise RuntimeError(f"item 13 at {key}: auto's route ({route}) "
                                   f"{got[route]:.4f} ms is slower than the plain stack's "
                                   f"{got['plain']:.4f} ms or more than {ITEM13_MARGIN} x the "
                                   f"fastest route's ({fastest}, {got[fastest]:.4f} ms)")
        del lstm
    return found


def tasks_at_path_shapes(torch, dev, rows: int, w_len: int, c_in: int, hidden: int,
                         n_layers: int) -> None:
    """Rows 16-17 (`lstm_stack_train_tasks`) against their plain version at
    the shapes phase 24's paths give them: V = 2 tasks of rows // 2 rows,
    each with its own weights (the dp x sp lockstep at sp 2: a rank's NL
    rows), and V = 2 windows of `rows` rows sharing one set of weights,
    expanded with task stride 0 (the unfolded adaptation step: autograd sums
    their gradients over the windows). The forward and every gradient,
    masks at rate 0.2 and off, float32 and bfloat16, within TOL; each error
    printed with the recurrence plans of that shape."""
    import numpy as np

    from weatherforecast_stgcn_maml_tpu_torch.models.common import draw_mask
    from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack as fls

    nv, bound = 2, 1.0 / hidden ** 0.5
    routes = {"kernel": lambda x, w0, wr, b, m, keep, dt: fls.lstm_stack_train_tasks(
                  x, w0, wr, b, masks=m, keep=keep, compute_dtype=dt),
              "plain": fls.lstm_stack_tasks_plain}
    for r, shared in ((rows // 2, False), (rows, True)):
        draw = np.random.default_rng([r, shared])

        def arr(shape, scale=1.0):
            return torch.from_numpy((scale * draw.uniform(-1.0, 1.0, size=shape))
                                    .astype(np.float32)).to(dev)

        x = arr((nv, r, w_len, c_in))
        weights = [arr((1 if shared else nv, *shape), bound) for shape in (
            (c_in + hidden, 4 * hidden), (n_layers - 1, 2 * hidden, 4 * hidden),
            (n_layers, 4 * hidden))]
        ct = arr((nv, r, hidden))
        gen = torch.Generator(device=dev).manual_seed(r)
        what = (f"V=2 x {r} rows, one set of weights at task stride 0" if shared
                else f"V=2 x {r} rows, weights a task")
        for dropout in (0.2, 0.0):
            m = draw_mask(gen, (nv, n_layers - 1, w_len, r, hidden), dropout, dev) if dropout \
                else None
            for dt_name, tol in TOL.items():
                dt = getattr(torch, dt_name)
                outs = {}
                for name, route in routes.items():
                    leaves = [t.detach().clone().requires_grad_(True) for t in (x, *weights)]
                    ws = leaves[1:]
                    if shared:
                        ws = [w.expand(nv, *w.shape[1:]) for w in ws]
                        if any(w.stride(0) for w in ws):
                            raise RuntimeError("the shared weights are not at task stride 0")
                    out = route(leaves[0], *ws, m, 1.0 - dropout, dt)
                    outs[name] = (out.detach(), torch.autograd.grad(out, leaves, ct))
                (got, got_g), (ref, ref_g) = outs["kernel"], outs["plain"]
                torch.testing.assert_close(got, ref, rtol=tol, atol=tol)
                rels = [rel_err(a, b) for a, b in zip(got_g, ref_g)]
                plans = [plan(hidden, r, dt.itemsize, fls._card_sms(dev), nv)
                         for plan in (fls.forward_plan, fls.recurrence_plan)]
                log(f"rows 16-17 {dt_name} {what}, dropout {dropout}: forward max_abs_err "
                    f"{float((got - ref).abs().max()):.3e} (tol {tol}); gradients (x, wcat0, "
                    f"wcatr, b2d) max|diff|/max|ref| {max(rels):.3e} (tol {tol}), per input "
                    f"{[f'{e:.1e}' for e in rels]}; plans (cs, hcp, rb, k_res): forward {plans[0]}, "
                    f"backward {plans[1]}")
                if max(rels) > tol:
                    raise RuntimeError(f"rows 16-17 {dt_name} {what}: gradient error "
                                       f"{max(rels):.3e}")


def wavefront_vbatch_phase(torch, dev, card: str, out_root: str) -> dict:
    """Phase 24, at ModelConfig() float32: (a) the wavefront LSTM, (b) the
    adaptation step's window batch unfolded under _VBATCH (rows 16-17 with
    shared weights), (c) _VBATCH on the dp x sp shardmap step (rows 16-17,
    12-13 and 9 per rank). Returns the launches of rows 9, 12, 13, 16 and 17
    on paths (b) and (c), each path's counts set to 0 just before it ran."""
    import numpy as np

    from weatherforecast_stgcn_maml_tpu_torch import cli
    from weatherforecast_stgcn_maml_tpu_torch.config import (
        ADAPTATION_REGIONS,
        META_TRAIN_REGIONS,
        DataConfig,
        ExperimentConfig,
        MetaConfig,
        ModelConfig,
        to_dict,
    )
    from weatherforecast_stgcn_maml_tpu_torch.data.preprocess import pad_nodes, prepare_features
    from weatherforecast_stgcn_maml_tpu_torch.data.windows import WindowSpec, gather_batch
    from weatherforecast_stgcn_maml_tpu_torch.engines.data_source import get_region_data
    from weatherforecast_stgcn_maml_tpu_torch.graph import build_region_graph
    from weatherforecast_stgcn_maml_tpu_torch.models import hybrid as hybrid_mod
    from weatherforecast_stgcn_maml_tpu_torch.models.losses import masked_mse
    from weatherforecast_stgcn_maml_tpu_torch.models.registry import (
        apply_model,
        draw_masks,
        init_model,
    )
    from weatherforecast_stgcn_maml_tpu_torch.ops import fused_gcn_shard as fgs
    from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack as fls
    from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn_train import gcn_stack_train
    from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm import fused_lstm_last_hidden
    from weatherforecast_stgcn_maml_tpu_torch.ops.fused_sgd import clip_sgd_update
    from weatherforecast_stgcn_maml_tpu_torch.ops.lstm_scan import lstm_recurrence
    from weatherforecast_stgcn_maml_tpu_torch.parallel import distributed
    from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import make_mesh_2d
    from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_sp import make_shardmap_batch_grad
    from weatherforecast_stgcn_maml_tpu_torch.train.maml import task_batch_grad
    from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import adaptation_optimizer
    from weatherforecast_stgcn_maml_tpu_torch.train.supervised import (
        SupervisedState,
        make_train_step,
    )
    from weatherforecast_stgcn_maml_tpu_torch.train.tasks import build_meta_tasks, stage_tasks
    from weatherforecast_stgcn_maml_tpu_torch.utils.checkpoint import save_checkpoint

    counted = {"lstm_stack_train": fls.lstm_stack_train,
               "lstm_stack_split": fls.lstm_stack_split,
               "lstm_stack_train_tasks": fls.lstm_stack_train_tasks,
               "lstm_recurrence": lstm_recurrence,
               "fused_lstm_last_hidden": fused_lstm_last_hidden,
               "gcn_stack_train": gcn_stack_train,
               "gcn_shard_layer": fgs.gcn_shard_layer}

    def zero():
        for fn in counted.values():
            fn.launches = 0
            if hasattr(fn, "backward_launches"):
                fn.backward_launches = 0
        clip_sgd_update.launches = clip_sgd_update.batched_launches = 0

    def counts():
        out = {}
        for name, fn in counted.items():
            out[name] = fn.launches
            if hasattr(fn, "backward_launches"):
                out[name + ".backward"] = fn.backward_launches
        out["clip_sgd_update"] = clip_sgd_update.launches
        out["clip_sgd_update.batched"] = clip_sgd_update.batched_launches
        return out

    def lstm_kernel_launches(c):
        return {k: v for k, v in c.items()
                if k.startswith(("lstm_stack", "lstm_recurrence", "fused_lstm")) and v}

    wavefront_calls = []
    real_wavefront = hybrid_mod.lstm_wavefront

    def counted_wavefront(*args, **kwargs):
        wavefront_calls.append(1)
        return real_wavefront(*args, **kwargs)

    def run_cli(argv):
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        if rc != 0:
            raise RuntimeError(f"{argv} exited {rc}:\n{err.getvalue()[-3000:]}")
        return out.getvalue(), err.getvalue(), time.perf_counter() - t0

    def gate(what, got, ref, tol):
        (loss_g, grad_g), (loss_r, grad_r) = got, ref
        loss_rel = float(((loss_g - loss_r).abs() / loss_r.abs()).max())
        rels = {k: rel_err(grad_g[k], grad_r[k]) for k in grad_r}
        worst = max(rels, key=rels.get)
        log(f"{what}: per-task losses {[round(v, 6) for v in loss_g.tolist()]} vs "
            f"{[round(v, 6) for v in loss_r.tolist()]} (max rel {loss_rel:.3e}); gradient "
            f"max|diff|/max|ref| {rels[worst]:.3e} at {worst} (tol {tol})")
        if loss_rel > tol or rels[worst] > tol:
            raise RuntimeError(f"{what}: losses {loss_rel:.3e}, {worst} {rels[worst]:.3e}")

    cfg, meta_cfg, data_cfg = ModelConfig(), MetaConfig(), DataConfig()
    one_epoch = dataclasses.replace(meta_cfg, inner_epochs=1)  # 15 inner steps a task
    model = init_model(torch.Generator().manual_seed(0), cfg, device=dev)
    regions = [get_region_data(box, data_cfg.train_years, data_cfg, tag="train",
                               name=f"region{i}") for i, box in enumerate(META_TRAIN_REGIONS[:2])]
    micro = stage_tasks([b.task for b in build_meta_tasks(regions, cfg, meta_cfg, data_cfg)], dev)

    def meta_grad(mc, mt, key=11, tasks=2):
        g = torch.Generator(device=dev).manual_seed(key)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = task_batch_grad(model, type(micro)(*(f[:tasks] for f in micro)), g, mc, mt)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) The wavefront LSTM.
    t_a = time.perf_counter()
    hybrid_mod.lstm_wavefront = counted_wavefront
    try:
        # The FO meta-gradient against the layerwise plain stack on the same
        # masks (one generator seed), in turns (W, L, L, W) after one
        # untimed call of each.
        wf_cfg, layer_cfg = ModelConfig(lstm_wavefront=True), ModelConfig(lstm_kernel="xla")
        res, secs = {}, {"wavefront": [], "layerwise": []}
        for mc in (wf_cfg, layer_cfg):  # untimed: each route's first calls
            meta_grad(mc, one_epoch)
        for name in ("wavefront", "layerwise", "layerwise", "wavefront"):
            zero()
            wavefront_calls.clear()
            res[name], t = meta_grad(wf_cfg if name == "wavefront" else layer_cfg, one_epoch)
            secs[name].append(t)
            if name == "wavefront":
                wf_counts, wf_n = counts(), len(wavefront_calls)
        gate(f"FO meta-gradient, model.lstm_wavefront vs the layerwise stack "
             f"(lstm_kernel=xla), float32, dropout 0.2, 2 tasks x {one_epoch.inner_batches} "
             f"inner steps", res["wavefront"], res["layerwise"], TOL["float32"])
        log(f"  FO meta-gradient host clock in turns (W, L, L, W): wavefront "
            f"{secs['wavefront'][0]:.3f} / {secs['wavefront'][1]:.3f} s, layerwise "
            f"{secs['layerwise'][0]:.3f} / {secs['layerwise'][1]:.3f} s; wavefront / layerwise "
            f"{sum(secs['wavefront']) / sum(secs['layerwise']):.3f}  [{card}]")
        forwards = micro.support_x.shape[0] * (one_epoch.inner_batches + 1)
        log(f"  wavefront calls {wf_n} (want {forwards}); launches {wf_counts}")
        if wf_n != forwards or lstm_kernel_launches(wf_counts):
            raise RuntimeError(f"the wavefront meta-gradient ran {wf_n} wavefronts and the LSTM "
                               f"kernels {lstm_kernel_launches(wf_counts)}")

        # The SO meta-gradient with the wavefront in the hvp / rof Hessian
        # transposes against the layerwise ones, the same key.
        # One task (the phase's cut): its 15 Hessian transposes.
        for impl in ("hvp", "rof"):
            so = dataclasses.replace(one_epoch, second_order=True, so_impl=impl)
            r, t = {}, {}
            for wf in (True, False):
                wavefront_calls.clear()
                r[wf], t[wf] = meta_grad(cfg, dataclasses.replace(so, so_wavefront=wf), tasks=1)
                if wf and len(wavefront_calls) != one_epoch.inner_batches:
                    raise RuntimeError(f"so_wavefront {impl}: {len(wavefront_calls)} wavefronts "
                                       f"for {one_epoch.inner_batches} inner steps")
            gate(f"SO ({impl}) meta-gradient, so_wavefront vs the layerwise Hessian transpose, "
                 f"float32, dropout 0.2, 1 task x {one_epoch.inner_batches} inner steps",
                 r[True], r[False], HVP_TOL["float32"])
            log(f"  SO ({impl}) host clock: so_wavefront {t[True]:.3f} s, layerwise "
                f"{t[False]:.3f} s  [{card}]")
        del res, r

        # The main path: `cli meta-train -o model.lstm_wavefront=true`, one
        # epoch of CLI_INNER_EPOCHS inner epochs; then a Moscow forecast from its checkpoint
        # on the card against --device cpu (phase 4's gate).
        wf_dir = os.path.join(out_root, "wavefront")
        zero()
        wavefront_calls.clear()
        _, _, t = run_cli(["meta-train", "-o", f"out_dir={wf_dir}", "-o", "meta.num_epochs=1",
                           "-o", f"meta.inner_epochs={CLI_INNER_EPOCHS}",
                           "-o", "model.lstm_wavefront=true"])
        with open(os.path.join(wf_dir, "meta", "meta_log.jsonl")) as f:
            rec = json.loads(f.readline())
        c = counts()
        log(f"meta-train -o model.lstm_wavefront=true, 1 epoch: meta_loss "
            f"{rec['meta_loss']:.6f}, per-task {rec['per_task_loss']}, "
            f"{rec['epoch_seconds']:.2f} s an epoch ({t:.1f} s the call); wavefront calls "
            f"{len(wavefront_calls)}; launches {c}  [{card}]")
        if not np.isfinite([rec["meta_loss"], *rec["per_task_loss"]]).all() or (
                lstm_kernel_launches(c) or not wavefront_calls):
            raise RuntimeError(f"meta-train on the wavefront: {rec}, {c}")
        fc = {}
        for device in ("cuda", "cpu"):
            run_cli(["forecast", "--region", "Moscow", "--device", device,
                     "-o", f"out_dir={wf_dir}", "-o", "model.lstm_wavefront=true"])
            with open(os.path.join(wf_dir, "forecasts", "Moscow.json")) as f:
                fc[device] = np.asarray(json.load(f)["mean_forecast"])
        tol = TOL["float32"]
        diff = np.abs(fc["cuda"] - fc["cpu"])
        log(f"forecast Moscow from the wavefront checkpoint, float32: card vs --device cpu "
            f"max_abs_err {float(diff.max()):.3e}; gate |diff| <= atol + rtol * |ref| with "
            f"atol {tol}, rtol {tol}: worst |diff| - rtol * |ref| "
            f"{float((diff - tol * np.abs(fc['cpu'])).max()):.3e}")
        np.testing.assert_allclose(fc["cuda"], fc["cpu"], rtol=tol, atol=tol)
    finally:
        hybrid_mod.lstm_wavefront = real_wavefront
    log(f"  (a) {time.perf_counter() - t_a:.1f} s")

    # (b) The adaptation step (AdaptConfig(): 2 windows x 512 rows) under
    # _VBATCH with _ROWFOLD off, against the folded step on the same masks.
    t_b = time.perf_counter()
    boxes = dict((name, box) for box, name in ADAPTATION_REGIONS)
    moscow = get_region_data(boxes["Moscow"], data_cfg.adapt_years, data_cfg, tag="adapt",
                             name="Moscow")
    graph = build_region_graph(moscow.lats, moscow.lons, k_neighbors=4)
    n = graph.padded_nodes
    a_hat = torch.from_numpy(graph.a_hat).to(dev)
    node_mask = torch.from_numpy(graph.node_mask).to(dev)
    koppen = max(moscow.koppen_code, 0)
    feats, _ = prepare_features(moscow)
    feats = torch.from_numpy(pad_nodes(feats, n)).to(dev)
    x, y = gather_batch(feats, [100, 101], WindowSpec(cfg.window, cfg.horizon))
    masks = draw_masks(cfg, torch.Generator(device=dev).manual_seed(3), x)
    params = list(model.parameters())
    names = [k for k, _ in model.named_parameters()]
    res, route_counts = {}, {}
    fls._VBATCH = True
    try:
        for name, rowfold in (("unfolded", False), ("folded", True)):
            fls._ROWFOLD = rowfold
            zero()
            loss = masked_mse(apply_model(model, a_hat, x, koppen, cfg, train=True, masks=masks),
                              y, node_mask)
            grads = torch.autograd.grad(loss, params)
            res[name] = (loss.detach()[None], dict(zip(names, grads)))
            route_counts[name] = counts()
        log(f"  adaptation step launches: unfolded {route_counts['unfolded']}; folded "
            f"{route_counts['folded']}")
        gate(f"adaptation step (2 windows x {n} rows), _VBATCH unfolded (rows 16-17, shared "
             f"weights) vs folded (rows 4-5), float32, dropout 0.2, the same masks: loss and "
             f"every gradient", res["unfolded"], res["folded"], TOL["float32"])
        u = route_counts["unfolded"]
        if (u["lstm_stack_train_tasks"], u["lstm_stack_train_tasks.backward"],
                u["lstm_stack_train"], u["lstm_stack_train.backward"]) != (1, 1, 0, 0):
            raise RuntimeError(f"the unfolded adaptation step launched {u}")
        adapt_step_launches = u

        # One train step of each route, in turns (U, F, F, U).
        tx, lr0 = adaptation_optimizer("Moscow")
        tmodel = copy.deepcopy(model)
        state = SupervisedState(tmodel, tx.init(dict(tmodel.named_parameters())))
        train_step = make_train_step(cfg, tx)
        g = torch.Generator(device=dev).manual_seed(5)

        def step_on(rowfold):
            def fn():
                nonlocal state
                fls._ROWFOLD = rowfold
                state, _ = train_step(state, x, y, a_hat, node_mask, koppen, lr0, g)
            return fn

        ms = {"unfolded": [], "folded": []}
        for name in ("unfolded", "folded", "folded", "unfolded"):
            ms[name].append(host_ms(torch, step_on(name == "folded")))
        log(f"adaptation train step float32 (2 windows x {n} rows), host clock to a "
            f"synchronize, median of {REPEATS}, in turns (U, F, F, U): unfolded "
            f"{ms['unfolded'][0]:.3f} / {ms['unfolded'][1]:.3f} ms, folded {ms['folded'][0]:.3f} "
            f"/ {ms['folded'][1]:.3f} ms; unfolded / folded "
            f"{sum(ms['unfolded']) / sum(ms['folded']):.3f}  [{card}]")
        del state, tmodel

        # `cli adapt` 1 epoch under the flag, from a seeded meta checkpoint.
        fls._ROWFOLD = False
        adapt_dir = os.path.join(out_root, "vbatch_adapt")
        save_checkpoint(os.path.join(adapt_dir, "meta", "ckpt_best"), model.state_dict(),
                        {"schema": "wfstgcn-meta-v1",
                         "config": to_dict(ExperimentConfig(model=cfg))})
        zero()
        out, _, t = run_cli(["adapt", "--region", "Moscow", "-o", f"out_dir={adapt_dir}",
                             "-o", "adapt.epochs=1"])
        c = counts()
        val_mse = float(out.split("val_mse=")[1].split()[0])
        log(f"adapt Moscow 1 epoch under _VBATCH: val_mse {val_mse:.6f}, {t:.1f} s; rows 16-17 "
            f"{c['lstm_stack_train_tasks']} / {c['lstm_stack_train_tasks.backward']} launches, "
            f"rows 4-5 {c['lstm_stack_train']} / {c['lstm_stack_train.backward']} (1-window "
            f"batches fold); launches {c}  [{card}]")
        if not np.isfinite(val_mse) or c["lstm_stack_train_tasks"] == 0 or (
                c["lstm_stack_train_tasks"] != c["lstm_stack_train_tasks.backward"]):
            raise RuntimeError(f"adapt under _VBATCH: val_mse {val_mse}, launches {c}")
        adapt_cli_launches = c
    finally:
        fls._VBATCH = fls._ROWFOLD = False
    log(f"  (b) {time.perf_counter() - t_b:.1f} s")

    # (c) _VBATCH on the dp x sp shardmap step: on a 1 x 1 NCCL mesh the
    # lockstep meta-gradient against the serial one, dropout 0.2, the same
    # key, in turns (L, S, S, L) after one untimed call of each; then two
    # gloo ranks (sp 2) through the CLI.
    t_c = time.perf_counter()
    created_group = distributed.ensure_process_group("nccl")
    grid = make_mesh_2d(1, 1, dev)
    res, secs, path_counts = {}, {"lockstep": [], "serial": []}, {}
    try:
        # The first two untimed: each route's first calls.
        for name in ("lockstep", "serial", "lockstep", "serial", "serial", "lockstep"):
            fls._VBATCH = name == "lockstep"
            zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[name] = make_shardmap_batch_grad(cfg, one_epoch, grid)(model, micro, (13, 0))
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
            path_counts[name] = counts()
    finally:
        fls._VBATCH = False
    secs = {k: v[1:] for k, v in secs.items()}
    if created_group:
        torch.distributed.destroy_process_group()
    gate(f"_VBATCH on a 1 x 1 dp x sp mesh: lockstep vs serial shardmap meta-gradient, "
         f"float32, dropout 0.2, key (13, 0), 2 tasks x {one_epoch.inner_batches} inner steps",
         res["lockstep"], res["serial"], TOL["float32"])
    log(f"  host clock in turns (L, S, S, L): lockstep {secs['lockstep'][0]:.3f} / "
        f"{secs['lockstep'][1]:.3f} s, serial {secs['serial'][0]:.3f} / {secs['serial'][1]:.3f}"
        f" s; lockstep / serial {sum(secs['lockstep']) / sum(secs['serial']):.3f}  [{card}]")
    lock = path_counts["lockstep"]
    fwd = one_epoch.inner_batches + 1
    want = {"lstm_stack_train_tasks": fwd, "lstm_stack_train_tasks.backward": fwd,
            "clip_sgd_update.batched": one_epoch.inner_batches, "clip_sgd_update": 0,
            "lstm_stack_train": 0, "lstm_stack_train.backward": 0,
            "gcn_shard_layer": cfg.gcn_layers * 2 * fwd,
            "gcn_shard_layer.backward": cfg.gcn_layers * 2 * fwd}
    got = {k: lock[k] for k in want}
    log(f"  lockstep launches {lock}; serial {path_counts['serial']}")
    if got != want:
        raise RuntimeError(f"the dp x sp lockstep meta-gradient launched {got}, not {want}")
    out = os.path.join(out_root, "mesh_sp2_vbatch")
    os.makedirs(out)
    ranks = two_ranks(out, "--vbatch", "-o", "meta.inner_epochs=1")
    per_rank = meta_cfg.meta_batch // 2 * (RANK_INNER_BATCHES + 1)  # 2 micro-batches, V = 2
    for rec in ranks:
        c = rec["launches"]
        got = (c["lstm_stack_train_tasks"], c["lstm_stack_train_tasks.backward"],
               c["clip_sgd_update.batched"], c["lstm_stack_train"], c["clip_sgd_update"])
        want = (per_rank, per_rank, meta_cfg.meta_batch // 2 * RANK_INNER_BATCHES, 0, 0)
        if got != want:
            raise RuntimeError(f"_VBATCH rank {rec['rank']} launched rows 16, 17, 9, 4, 8 {got}, "
                               f"not {want}")
    with open(os.path.join(out, "meta", "meta_log.jsonl")) as f:
        rec = json.loads(f.readline())
    log(f"two ranks under _VBATCH (dp 1 x sp 2, 256 rows each, gloo on one card), 1 inner "
        f"epoch: meta_loss {rec['meta_loss']:.6f}, tasks {rec['task_indices']}, "
        f"{rec['epoch_seconds']:.2f} s an epoch; rows 16-17 {per_rank} launches a rank  "
        f"[{card}]")
    log(f"  (c) {time.perf_counter() - t_c:.1f} s")
    return {name: {"adaptation step (b)": adapt_step_launches.get(key, 0),
                   "adapt CLI epoch (b)": adapt_cli_launches.get(key, 0),
                   "dp x sp lockstep, 2 tasks (c)": lock[key],
                   "two gloo ranks, a rank (c)": ranks[0]["launches"].get(rank_key)}
            for name, key, rank_key in (
                ("clip_sgd_update.batched", "clip_sgd_update.batched", "clip_sgd_update.batched"),
                ("gcn_shard_layer", "gcn_shard_layer", "gcn_shard_layer"),
                ("gcn_shard_layer.backward", "gcn_shard_layer.backward",
                 "gcn_shard_layer.backward"),
                ("lstm_stack_train_tasks", "lstm_stack_train_tasks", "lstm_stack_train_tasks"),
                ("lstm_stack_train_tasks.backward", "lstm_stack_train_tasks.backward",
                 "lstm_stack_train_tasks.backward"))}


def two_ranks(out, *extra):
    """`cli meta-train --mesh` on two ranks (dp 1 x sp 2) on card 0, joined
    by gloo, under torch.distributed.run (`mesh_rank`), with `extra`
    arguments (`--vbatch` first, then overrides) after `-o
    meta.inner_batches=RANK_INNER_BATCHES`; both ranks' records,
    checked: the same finite losses, one set of checkpoints, 512 padded
    nodes (256 a rank)."""
    import numpy as np

    from weatherforecast_stgcn_maml_tpu_torch.parallel import distributed

    args = list(extra)
    at = 1 if args[:1] == ["--vbatch"] else 0
    args[at:at] = ["-o", f"meta.inner_batches={RANK_INNER_BATCHES}"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
         f"--master_port={distributed.free_port()}", os.path.abspath(__file__),
         "--mesh-rank", out, *args],
        capture_output=True, text=True, timeout=900,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"two-rank meta-train exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    for rec in ranks:
        log(f"rank {rec['rank']}: {rec['stdout'].strip()}; {rec['seconds']:.1f} s; "
            f"launches {rec['launches']}")
    losses = [(rec["best_loss"], rec["final_loss"]) for rec in ranks]
    if losses[0] != losses[1] or not np.isfinite(losses).all():
        raise RuntimeError(f"the two ranks' losses differ or are not finite: {losses}")
    meta_files = sorted(os.listdir(os.path.join(out, "meta")))
    if meta_files != ["ckpt_best", "ckpt_final", "ckpt_last", "meta_log.csv",
                      "meta_log.jsonl"]:
        raise RuntimeError(f"two-rank meta-train wrote {meta_files}")
    if "padded nodes=512" not in ranks[0]["stderr"]:
        raise RuntimeError("two-rank meta-train: not 512 padded nodes (256 a rank)")
    return ranks


def mesh_rank(out: str, extra: list[str]) -> int:
    """Phases 14, 22, 23 and 24's rank: `cli meta-train --mesh` on card 0 with
    gloo (dp 1 x sp 2, 1 epoch, the `extra` overrides; a leading `--vbatch`
    sets `ops.fused_lstm_stack._VBATCH`), then this rank's stdout, log,
    launch counts and time into OUT/rank<r>.json."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from weatherforecast_stgcn_maml_tpu_torch import cli
    from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack as fls
    from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn_shard import gcn_shard_layer
    from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm_hvp import (
        hvp_stack_bwd,
        hvp_stack_fwd,
    )
    from weatherforecast_stgcn_maml_tpu_torch.ops.fused_sgd import clip_sgd_update

    if extra[:1] == ["--vbatch"]:
        fls._VBATCH, extra = True, extra[1:]

    argv = ["meta-train", "--mesh", "--device", "cuda:0",
            "-o", "mesh.spatial_devices=2", "-o", "meta.num_epochs=1", "-o", f"out_dir={out}",
            *extra]
    stdout, stderr = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
        rc = cli.main(argv)
    line = stdout.getvalue().strip()
    fields = dict(kv.split("=", 1) for kv in line.split())
    rank = int(fields["rank"])
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "rc": rc, "stdout": line, "stderr": stderr.getvalue(),
                   "best_loss": float(fields["best_loss"]),
                   "final_loss": float(fields["final_loss"]),
                   "seconds": time.perf_counter() - t0,
                   "launches": {"gcn_shard_layer": gcn_shard_layer.launches,
                                "gcn_shard_layer.backward": gcn_shard_layer.backward_launches,
                                "hvp_stack_fwd": hvp_stack_fwd.launches,
                                "hvp_stack_bwd": hvp_stack_bwd.launches,
                                "lstm_stack_train_tasks": fls.lstm_stack_train_tasks.launches,
                                "lstm_stack_train_tasks.backward":
                                    fls.lstm_stack_train_tasks.backward_launches,
                                "lstm_stack_train": fls.lstm_stack_train.launches,
                                "clip_sgd_update.batched": clip_sgd_update.batched_launches,
                                "clip_sgd_update": clip_sgd_update.launches}},
                  f)
    return rc


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
