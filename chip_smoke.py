#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py   # device, kernel, serve, train, pipeline, t5, mamba,
                            # fault, cluster, moe, frames, mixed, gemma2, mesh,
                            # dryrun
    python3 chip_smoke.py --phases mesh  # the stage mesh and ZeRO-1
    python3 chip_smoke.py --phases dryrun  # the dry run against the card
    python3 chip_smoke.py --phases kernel,gemma2  # head dim 256 and gemma2-2b
    python3 chip_smoke.py --phases kernel,train  # the kernels and training
    python3 chip_smoke.py --phases profile       # where the time goes

Phases, each printing its own lines; any failure exits non-zero:

1. device  — the card's name and power limit, and the build of every CUDA
             kernel (K1 in ``flash_fwd.cu``, the fused backward that
             replaces K2 and K3 in ``flash_bwd.cu``, K4 in ``ssd_fwd.cu``
             and its first, serial form, the yardstick, in
             ``ssd_fwd_serial.cu``), one nvcc per source, all started
             together, from the sources in this checkout, with ptxas's
             register and spill lines (each kernel and head dim it is
             instantiated at, D 256 among them) and the dynamic shared
             memory of K1's prefill and decode forms and of the backward at
             every head dim (K1 takes 64-key tiles at D 256, the backward a
             form of its own);
2. kernel  — K1 (``mha_forward``) and the fused backward
             (``mha_backward``: dq, dk and dv in one launch, the work of the
             reference's K2 and K3) against their plain PyTorch versions on
             the card, at the serving and training paths' shapes and on
             small cases (GQA, window, softcap, segmented with padding and
             fully masked rows, a 128-row query tile of pure padding, ragged
             lengths, a non-causal cross shape, the serve's prefill into a
             longer cache) and at the t5 phase's shapes (``t5-enc``: the
             encoder's non-causal self-attention, B 16, T = S 512, 128
             heads; ``t5-cross``: 128 decoder tokens to 512 encoder tokens,
             packed rows whose decoder segments see only their encoder
             segments, both sides padded), at the moe phase's training
             shape (``granite-train``: B 8, T 2048, 24 q and 8 kv heads x
             64, rows as train-segmented's) and the frames phase's
             (``hubert-4k``: B 4, T = S 4096, 16 heads x 80, non-causal,
             one segment; head dim 80 runs zero-padded to 128, and the
             padding's time is printed), and the gemma2 phase's, at head
             dim 256 with 8 q and 4 kv heads and softcap 50
             (``gemma2-train``: B 4, T 2048, the train rows;
             ``d256-causal``: the same without softcap, for SDPA's time;
             ``gemma2-local-8k``: B 2, T = S 8192, window 4096;
             ``gemma2-decode``: B 16, S 8200 at position 8199, window 4096;
             ``padding-tile-d256``: a 128-row query tile of pure padding;
             ``d256-keys-40960``: B 1, 2 q heads and 1 kv head, the last
             256 of 40960 positions, where K1's walk over its key-tile
             statistics goes in two chunks of 512 tiles), and the decode
             steps of the serve paths (``gemma2-serve-decode``: B 8, S 2064
             at position 2063, 8 q / 4 kv heads x 256, softcap 50;
             ``granite-decode``: B 8, S 2064 at 2063, 24 / 8 x 64;
             ``llava-decode``: B 4, S 3400 at 3399, 56 / 8 x 128; and the
             untimed ``gqa7-t16-decode``, 16 query rows of 56 / 8 x 128),
             where every case of K1's decode form (T <= 16) must also
             repeat bit for bit over two more calls and is timed call by
             call on the stream after 1 GiB is written to flush L2, as
             the serve path finds each layer's cache;
             both elementwise and per 64-row tile, where the
             tile check must also fail a planted fault (a dropped key tile);
             the backward must give dq, dk and dv equal to the bit over
             three calls; with times of the kernels (the backward alone and as the whole
             CUDA backward: delta, the zeroed dq accumulator, the kernel and
             dq's cast), the plain versions and
             ``scaled_dot_product_attention``'s forward and backward (a
             yardstick the port never calls) beside the least time the card
             could take; then K4 (``ssd_chunked``) against its plain version
             at the mamba serve's shapes (B 8 at T 2048, 192 and 96) and on
             small cases (groups, T 1, a decay past -60 within a chunk),
             elementwise and per (batch row, head, 64-step chunk) relative
             norm, which must also fail a planted fault (the state reset at
             every chunk boundary), the states it writes at each chunk's
             start against the plain pass over chunks, and two calls equal to the
             bit; it prints how each product rounds its operands, and its
             time beside its first, serial form's (step 0, in turns), its
             bound and the plain version's (no single PyTorch call computes
             the SSD);
3. serve   — ``repro_torch.serve`` at full gpt-paper width, 32 layers,
             random seeded weights: the launch count of K1 must equal
             n_layers x (prefill batches x (1 + decode steps)) and every
             logit must be finite; then the same serve with 2 layers runs
             once with K1 and once with the plain attention, and their
             logits must agree;
4. train   — the plan-ahead runner trains gpt-paper at full width, 8 layers,
             random seeded weights, 4 iterations of bench_e2e's gpt stream:
             K1 must launch 2 x layers x micro-batches times (forward and
             recompute), the backward layers x micro-batches times, and
             every loss and grad norm must be finite; then 2 layers, once
             with the kernels and once with the plain versions, must agree
             on a grad step's loss and every gradient leaf (elementwise and
             by each leaf's relative norm, which must also fail a backward
             planted to return a zero dq) and on 2 iterations' losses; and
             two such 2-iteration runs with the kernels must give equal
             losses, grad norms and parameters to the bit;
5. pipeline — the same runner on the threaded stage pipeline: gpt-paper at
             full width, 8 layers over 4 stages (each on its own CUDA
             stream), 4 iterations of the train phase's stream: K1 must
             launch 3 x layers x micro-batches times (stage forward, the
             stage backward's forward again, the period checkpoint's
             recompute), the backward layers x micro-batches times, every
             loss and grad norm finite; on one plan the pipeline against
             the sequential grad steps (mean loss within 1e-4 relative,
             each gradient leaf within GRAD_REL_TOL); two 2-iteration runs
             at 4 layers equal to the bit;
6. t5      — t5-paper at full width (d_model 1024, 128 heads x 128, d_ff
             65536), 4 encoder + 4 decoder layers over 2 encoder and 2
             decoder stages, 3 iterations of bench_e2e's t5 stream: exact
             launch counts (two attentions per decoder layer), finite
             losses; at 2 + 2 layers, one plan with the kernels and with the
             plain versions patched in must agree on the loss and every
             gradient leaf (which must fail a backward planted to return a
             zero dq), the encoder's gradients must be nonzero, and two
             2-iteration runs must be equal to the bit;
7. mamba   — ``repro_torch.serve`` of mamba2-130m at full width and depth
             (24 layers), random seeded weights, the serve phase's requests:
             K4 must launch 24 x prefill batches times and K1 never, and
             every logit must be finite; then the same serve with 2 layers
             runs once with K4 and once with the plain SSD, and their logits
             must agree;
8. fault   — the fault-tolerant loop: gpt-paper at full width, 2 layers
             over 2 stages (threads on their own CUDA streams), strict plan
             verification, 6 iterations of the train phase's stream: run A
             fault-free, run B with checkpoints every 3 iterations under
             build/ (removed after) and a planner loss, a straggler, a
             state-losing crash in stage 1's backward (restored from step
             3, iterations 3 and 4 replayed) and a crash in stage 0's
             forward (retried in memory); B's last-occurrence losses and
             grad norms, parameters, master, m, v and step must equal A's
             to the bit, its newest checkpoint must reload (CRCs verified)
             equal to its state, and a byte flipped in that checkpoint must
             be refused with the fallback to step 3; prints the free disk,
             each save's seconds (device synchronise, device to host, CRC,
             write), each load's, recovery_s, strict verification's time
             per plan, peak memory and both runs' launches;
9. cluster — the process fault domain (``repro_torch.dist.cluster``): two
             replica processes, each with its own CUDA context, train
             gpt-paper at full width with 2 layers on the one card, one
             stage each, 3 iterations of the train phase's stream,
             gradients over localhost TCP, a checkpoint every 2 under
             build/ (removed after); run A fault-free must equal the
             in-process runner at dp 2 to the bit (losses, grad norms,
             every parameter) with the same launches; run B's coordinator
             gets a real SIGKILL at iteration 2: a verified dead pid, an
             election, a restore, no orphans, and the in-process runner on
             B's plans (dp 2 to the restored step, dp 1 from its
             checkpoint) equal to the bit; prints each iteration's trip of
             the gradients over the wire, each run's wall time and real
             tokens/s beside the in-process runner's, the time from the
             kill to the new epoch's first iteration, each worker's peak
             memory and the workers' launches;
10. moe    — granite-moe-3b-a800m at full width (40 experts x 512, top-8):
             served at full depth (32 layers) with the serve phase's
             requests, K1 launched exactly layers x (batches + batches x
             decode steps) times; trained at 16 layers on the train phase's
             stream, 4 iterations, exact launches, and two 2-iteration runs
             equal to the bit; llama4-scout-17b-a16e (top-1 and a shared
             expert) served at 4 layers, 8 requests, 4 decode steps. Each
             is held at 2 layers to the plain versions on the kernels' own
             routes (recorded in the kernel run and replayed by a patch of
             ``layers.moe_route``, since bf16 noise flips some routes; the
             flips are counted): logits within TOL_BF16, and the first
             iteration's loss and gradient leaves within GRAD_TOL and
             GRAD_REL_TOL, each of which must fail a planted fault, every
             token's second expert dropped;
11. frames — hubert-xlarge at full width and depth (48 layers, 16 heads x
             80): 4 AdamW steps of ``build_grad_step`` on seeded (4, 4096)
             frame batches (spans of 10 masked frames from starts drawn at
             8%, the loss on the masked frames), exact launches of K1 and
             the backward at head dim 80, then the encoder forward
             (prefill) at the same shape; at 2 layers the gradient leaves
             against the plain versions, which must fail a zero dq;
12. mixed  — llava-next-34b at full width, 16 of 60 layers: 4 rows of 2880
             seeded patch embeddings and 512 text tokens prefilled, 8
             greedy decode steps, exact K1 launches, finite logits; at 2
             layers the logits against the plain attention;
13. gemma2 — gemma2-2b at full width (26 layers, d_model 2304, 8 q and 4
             kv heads x 256, a 4096-token window on every other layer,
             softcaps 50 and 30), its attention on the head-dim-256
             kernels: served at full depth with the serve phase's requests
             (K1 launched exactly layers x (batches + batches x decode
             steps) times, logits finite and within the final softcap); at
             2 layers against the plain versions (prefill logits by row
             within LOGIT_REL_TOL, which must fail a planted fault, K1
             reading kv head h mod KV); trained at full depth on the
             train phase's stream for 4 iterations (exact launches), two
             2-layer runs equal to
             the bit, and at 2 layers every gradient leaf against the
             plain versions (GRAD_TOL, GRAD_REL_TOL, which must fail a zero
             dq);
14. mesh   — the mesh backend (``repro_torch.dist.backend.MeshBackend``):
             the pipeline phase's configuration, gpt-paper at full width, 8
             layers over 4 stages, on a stage mesh that repeats the one
             card (``make_stage_mesh(4, devices=["cuda:0"] * 4)``), the
             shift register of ``dist/pipeline.py`` with ZeRO-1 optimizer
             state split over the stages, 4 iterations of the train
             phase's stream through ``PlanAheadRunner(backend="mesh")``:
             3 K1 and 1 backward launch per layer and micro-batch, finite
             losses; on one plan the mesh against the threads backend's
             sequential steps (mean loss within 1e-4 relative, each
             gradient leaf within GRAD_REL_TOL), the plan with its
             injection order reversed giving the same loss to the bit, and
             ``optimizer_step`` on the placed state equal to
             ``adamw_update`` on the whole state to the bit (two steps);
             two 2-iteration runs at 4 layers equal to the bit; prints
             real tokens/s, the mean step, peak memory and ZeRO-1's bytes
             on each stage;
15. dryrun — the dry run (``repro_torch.launch.dryrun``) against the card:
             each case's step traced on the ``meta`` device
             (``_lower_cell`` on a (1, 1) mesh: the predicted peak, FLOPs
             and kernel launches), then the same step functions run on the
             card with seeded weights made there (``measure_cell``): once
             under the ``op_cost`` counter, once timed, its peak
             ``max_memory_allocated`` above what was allocated before.
             Cases: (a) gpt-paper at full width, 8 layers (the train
             cell's cut), one train step at B 8 x T 2048 under the remat
             policies "nothing" and "dots"; (b) gemma2-2b at full depth
             (26 layers, the head-dim-256 kernels), one train step at B 4
             x T 2048; (c) gpt-paper at full depth, a prefill of 8 x 2048
             and one decode step against a 2064-position cache. Each must
             have the predicted peak within DRYRUN_PEAK_TOL of the
             measured one, the meta and CUDA FLOPs equal, the predicted
             launches equal to the counted ones and finite outputs; "dots"
             must peak above "nothing" with the same launches; prints the
             step time and the TFLOP/s it implies, and the ops whose
             kernels allocated more inside themselves than the trace
             models;
16. profile — (not run by default; ``profile-models`` the same for the
             moe, frames and mixed configurations: granite-moe's serve
             windows and a 16-layer training iteration, a hubert-xlarge
             step and encoder forward, llava-next's prefill and decode;
             ``profile-gemma2`` gemma2-2b's serve windows and a training
             iteration at full depth)
             torch.profiler over one full-width prefill
             of 8 x 2048 tokens and its decode steps, of gpt-paper and of
             mamba2-130m, over one training iteration at 8 layers, and over
             one pipelined iteration of gpt-paper (8 layers) and of t5-paper
             (4 + 4 layers), each over 4 stages: device time by kernel, K1,
             the backward and K4 singled out, and the device's idle share.

The third line from the end is the kernels' JSON record, the second the
card's name and power limit, the last the device record. Nothing is
printed as a result without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# bf16 tolerance of the reference's own kernel tests (tests/test_kernels.py:28):
# o and lse are rounded or summed at other points in the two versions.
TOL_BF16 = 2e-2
# ||o - plain|| / ||plain|| per 64-row tile and head, K1 in the kernel
# phase. The elementwise TOL_BF16 cannot fail a tile whose entries are
# under 2e-2, as o's are on long rows (an average of many v rows). The
# limit lies between K1's readings and those of the planted fault, the
# plain forward without each row's last live key tile (PERF.md, section 6).
FWD_REL_TOL = 1e-2
# bf16 gradient tolerance of the reference's kernel-gradient tests
# (GRAD_TOL, tests/test_kernel_grads.py:21)
GRAD_TOL_BF16 = 4e-2
# ||out - plain|| / ||plain||, per 64-row (dq) or 64-key (dk, dv) tile and
# head in the kernel phase, per gradient leaf in the train phase. The
# elementwise GRAD_TOL alone cannot fail a tile whose entries are under
# 4e-2, as those of the late keys of a 2048-token causal row are. The limit
# lies between the kernels' readings and those of the planted faults each
# phase also reads (PERF.md, section 6).
GRAD_REL_TOL = 1e-2
# ||logits - plain|| / ||plain|| per row of a prefill's logits, in the moe
# phase's serve comparisons. At 2 layers one expert in eight dropped moves
# the logits by about 2% of their norm, and TOL_BF16 over max |logit|
# barely sees it; the limit lies between the kernel runs' readings and
# those of that planted fault (PERF.md, section 6).
LOGIT_REL_TOL = 1e-2
# |predicted - measured| / measured peak memory of a dry-run case: the
# trace misses only what a kernel allocates below the dispatcher and the
# caching allocator's rounding (PERF.md, section 6)
DRYRUN_PEAK_TOL = 0.05
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12      # H100 SXM HBM3
# written before each timed decode call: 20 times the 50 MB L2, about 0.3
# ms of the card's time, longer than a call's host path
L2_FLUSH_BYTES = 1 << 30
# the serve and mamba phases: requests, longest prompt, greedy steps
REQUESTS, MAX_PROMPT, DECODE_STEPS = 32, 2048, 16
# K4's bf16 tolerance: the reference's SSD kernel test (tests/test_kernels.py
# :193); y is rounded to bf16 and the chunks differ (64 steps, 128 in the
# plain version)
SSD_TOL_BF16 = 5e-2
# ||y - plain|| / ||plain|| per (batch row, head, 64-step chunk), and per
# (batch row, head) for the final state. y shrinks under strong decay, where
# the elementwise tolerance compares little. The limit lies between K4's
# readings and those of the planted fault (PERF.md, section 6).
SSD_REL_TOL = 1e-2
MAMBA_LAYERS = 24
# the train phase's rows in the kernel phase: one sample per row
TRAIN_ROWS = (2048, 1500, 900, 300)
# the train phase: gpt-paper at full width, depth cut to 8 layers (fp32
# master, m and v beside the bf16 weights and gradients: 20 bytes per
# parameter, 40.5 GB at 8 layers), bench_e2e's gpt stream at max_len 2048
TRAIN_LAYERS, TRAIN_ITERS = 8, 4
TRAIN_STREAM = dict(n_tasks=32, global_tokens=16384, max_len=2048,
                    tail_fraction=0.1, tail_alpha=1.2, seed=0)
# the kernel phase's t5 cases, at the t5 phase's shapes: B 16 rows of 512
# encoder tokens, one sample each, from 512 down to 64 tokens, then padding
T5_ENC_ROWS = (512, 400, 352, 320, 288, 256, 224, 192, 176, 160, 144, 128,
               112, 96, 80, 64)
T5_DEC_LEN = 128
# the pipeline phase: gpt-paper at full width, the train phase's 8 layers
# over 4 stages (2 periods each), the train phase's stream and palette
PIPE_STAGES, PIPE_ITERS = 4, 4
# the t5 phase: t5-paper at full width (DynaPipe Table 1), depth cut to 4
# encoder + 4 decoder layers (1.91 B parameters, 38 GB at 20 bytes a
# parameter; 24 + 24 would need about 220 GB), 4 stages: 2 encoder stages
# then 2 decoder stages; bench_e2e's t5 stream at the model's vocabulary
T5_LAYERS, T5_STAGES, T5_ITERS = 4, 4, 3
T5_STREAM = dict(n_tasks=32, global_tokens=16384, max_len=512, vocab=32128,
                 tail_fraction=0.1, tail_alpha=1.2, encdec_fraction=1.0,
                 seed=0)
T5_PALETTE = dict(min_seq=64, max_seq=512, seq_align=64, max_mbs=16)
# the fault phase: gpt-paper at full width, depth cut to 2 layers (0.816 B
# parameters; a checkpoint of the bf16 params and fp32 master, m and v is
# 14 bytes a parameter, 11.4 GB, against 28.3 GB at 8 layers) over 2
# stages of 1 layer, the train phase's stream and palette; 6 iterations,
# a checkpoint every 3; a lost plan costs the plan timeout
FAULT_LAYERS, FAULT_STAGES, FAULT_ITERS, FAULT_CKPT_EVERY = 2, 2, 6, 3
FAULT_PLAN_TIMEOUT = 3.0
# the cluster phase: gpt-paper at full width, the fault phase's 2 layers
# (two replicas' training state, 11.4 GB each, share the card), one stage
# per replica (the sequential path, as the reference's cluster runs), the
# train phase's stream and palette; 2 replica processes, 3 iterations, a
# checkpoint every 2 and at the end; run B's coordinator is killed at
# iteration 2
CLUSTER_REPLICAS, CLUSTER_ITERS, CLUSTER_CKPT_EVERY, CLUSTER_KILL_AT = \
    2, 3, 2, 2
# a gradient tree of 1.6 GB on the wire and a checkpoint of 11.4 GB hold a
# replica's process for seconds: socket EOF tells a death, and the
# heartbeats' timeout is long, so that a busy replica is never taken for a
# dead one
CLUSTER_TIMEOUTS = dict(heartbeat_timeout_s=60.0, result_timeout_s=600.0,
                        run_timeout_s=900.0)
# the moe phase: granite-moe-3b-a800m at full width (32 layers, d_model
# 1536, 24 q and 8 kv heads x 64, 40 experts x 512 top-8, 3.30 B
# parameters), served at full depth with the serve phase's requests;
# trained with depth cut to 16 layers (1.69 B parameters, 34 GB at 20
# bytes a parameter; 32 layers' 66 GB of state leave too little for the
# MoE buffers and activations) on the train phase's stream (at the model's
# vocabulary), palette and device_mem; llama4-scout-17b-a16e (top-1 and a
# shared expert) with depth cut to 4 of 48 layers (10.9 B parameters, 21.8
# GB in bf16; 48 layers are 216 GB), 8 requests and 4 decode steps; each
# against the plain versions at 2 layers on the kernels' routes
MOE_ARCH, MOE_TRAIN_LAYERS = "granite-moe-3b-a800m", 16
LLAMA4_LAYERS, LLAMA4_REQUESTS, LLAMA4_DECODE_STEPS = 4, 8, 4
# the frames phase: hubert-xlarge at full width and depth (48 layers, 0.95
# B parameters, 19 GB of state), 4 AdamW steps on (4, 4096) frame batches,
# the reference's train_4k length; nothing cut
HUBERT_BATCH, HUBERT_SEQ, HUBERT_STEPS = 4, 4096, 4
# the mixed phase: llava-next-34b at full width with depth cut to 16 of 60
# layers (9.8 B parameters, 19.7 GB; 60 layers are 68.9 GB before
# activations), 4 rows of 2880 patch positions and 512 text tokens, 8
# greedy decode steps
LLAVA_LAYERS, LLAVA_ROWS, LLAVA_TEXT, LLAVA_DECODE_STEPS = 16, 4, 512, 8
# the gemma2 phase: gemma2-2b at full width (arXiv:2408.00118, hf
# google/gemma-2-2b: 26 layers, d_model 2304, 8 q and 4 kv heads x 256,
# d_ff 9216, a 4096-token window on every other layer, attention softcap
# 50, final softcap 30, tied embeddings, 2.61 B parameters), served at full
# depth with the serve phase's requests, and trained at full depth on the
# train phase's stream (at the model's vocabulary), palette and device_mem
# (52 GB of state at 20 bytes a parameter). The kernel phase's D 256 cases
# take its attention's shapes
GEMMA2_ARCH = "gemma2-2b"
GEMMA2_HEADS, GEMMA2_KV_HEADS, GEMMA2_WINDOW, GEMMA2_SOFTCAP = 8, 4, 4096, 50.0
# id -> (name, source, the TPU kernel it replaces, its timed record, its
# other timed records by their key in the kernels line, the paths whose
# launch counts it reports, the first that ran giving `launches`)
KERNELS = {
    "K1": ("mha_forward", "src/repro_torch/kernels/csrc/flash_fwd.cu",
           "src/repro/kernels/flash_attention.py:354", "prefill",
           {"decode": "decode", "causal_2048": "prefill",
            "train_segmented": "train-segmented", "t5_enc": "t5-enc",
            "t5_cross": "t5-cross", "granite_train": "granite-train",
            "hubert_4k": "hubert-4k", "gemma2_train": "gemma2-train",
            "d256_causal": "d256-causal", "gemma2_local_8k": "gemma2-local-8k",
            "gemma2_decode": "gemma2-decode",
            "gemma2_serve_decode": "gemma2-serve-decode",
            "granite_decode": "granite-decode", "llava_decode": "llava-decode",
            "padding_tile_d256": "padding-tile-d256",
            "d256_keys_40960": "d256-keys-40960"},
           ("train", "serve", "mesh")),
    # K2 and K3 are one fused kernel: both rows carry its launches and times
    "K2": ("mha_backward", "src/repro_torch/kernels/csrc/flash_bwd.cu",
           "src/repro/kernels/flash_attention.py:404", "train-segmented",
           {"causal_2048": "causal-2048", "t5_enc": "t5-enc",
            "t5_cross": "t5-cross", "granite_train": "granite-train",
            "hubert_4k": "hubert-4k", "gemma2_train": "gemma2-train",
            "d256_causal": "d256-causal",
            "gemma2_local_8k": "gemma2-local-8k",
            "padding_tile_d256": "padding-tile-d256",
            "d256_keys_40960": "d256-keys-40960"},
           ("train", "serve", "mesh")),
    "K3": ("mha_backward", "src/repro_torch/kernels/csrc/flash_bwd.cu",
           "src/repro/kernels/flash_attention.py:438", "train-segmented",
           {"causal_2048": "causal-2048", "t5_enc": "t5-enc",
            "t5_cross": "t5-cross", "granite_train": "granite-train",
            "hubert_4k": "hubert-4k", "gemma2_train": "gemma2-train",
            "d256_causal": "d256-causal",
            "gemma2_local_8k": "gemma2-local-8k",
            "padding_tile_d256": "padding-tile-d256",
            "d256_keys_40960": "d256-keys-40960"},
           ("train", "serve", "mesh")),
    "K4": ("ssd_chunked", "src/repro_torch/kernels/csrc/ssd_fwd.cu",
           "src/repro/kernels/ssd.py:114", "ssd-serve", {"t_192": "ssd-192"},
           ("mamba",)),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ----------------------------------------------------------------------
# phase 1: device and build
# ----------------------------------------------------------------------
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(f"[device] nvidia-smi: {smi_line}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; device 0: "
          f"{torch.cuda.get_device_name(0)}, "
          f"capability {torch.cuda.get_device_capability(0)}, "
          f"{torch.cuda.device_count()} visible")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build()
    took = time.perf_counter() - t0
    print(f"[device] built {sorted(built) or 'nothing (cached)'} in "
          f"{took:.1f}s with {_build.nvcc()}")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            fn = re.search(r"Compiling entry function '\w*?\d"
                           r"((?:mha|ssd)_[a-z0-9_]+?_kernel)(?:I(\w*?)EE)?",
                           line)
            if fn:   # the kernel and its template arguments, demangled
                args = ", ".join(re.findall(r"L[ib](\d+)E",
                                            (fn.group(2) or "") + "E"))
                print(f"[device]   {name}: {fn.group(1)}"
                      + (f"<{args}>" if args else ""))
            elif "registers" in line or "spill" in line:
                print(f"[device]   {name}:   {line.strip()}")
    from repro_torch.kernels import flash_attention as fa
    smem = _build.library("flash_fwd").mha_fwd_prefill_smem
    print("[device]   flash_fwd: prefill dynamic shared memory (64-key tiles "
          "at D 256) " + ", ".join(f"D {d}: {smem(d)} B" for d in fa.HEAD_DIMS))
    smem = _build.library("flash_fwd").mha_fwd_decode_smem
    print("[device]   flash_fwd: decode dynamic shared memory (one row tile; "
          "the most rows a block takes, 64 or 32 at D 256; before the tile "
          "bits) " + ", ".join(f"D {d}: {smem(d, 16)} B, {smem(d, 64 if d <= 128 else 32)} B"
                               for d in fa.HEAD_DIMS))
    smem = _build.library("flash_bwd").mha_bwd_smem
    print("[device]   flash_bwd: dynamic shared memory (D 256: "
          "mha_bwd_d256_kernel) "
          + ", ".join(f"D {d}: {smem(d)} B" for d in fa.HEAD_DIMS))
    return smi_line


# ----------------------------------------------------------------------
# phase 2: K1 against its plain version
# ----------------------------------------------------------------------
def _cuda_time(torch, fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _case_inputs(torch, gen, *, b, t, s, h, kv, q_pos=None, kv_pos=None,
                 q_seg=None, kv_seg=None, q_scale=1.0, d=128):
    dev = "cuda"
    q = (torch.randn((b, t, h, d), generator=gen, device=dev) * q_scale
         ).to(torch.bfloat16)
    k = torch.randn((b, s, kv, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, s, kv, d), generator=gen, device=dev).to(torch.bfloat16)

    def ints(x, n):
        if x is None:
            x = torch.arange(n, dtype=torch.int32)[None].expand(b, n)
        return torch.as_tensor(x, dtype=torch.int32).to(dev).contiguous()

    qs = None if q_seg is None else ints(q_seg, t)
    ks = None if kv_seg is None else ints(kv_seg, s)
    return q, k, v, ints(q_pos, t), ints(kv_pos, s), qs, ks


def _cold_ms(torch, fn, iters):
    """Each call's time on the stream, CUDA events around it, L2 flushed
    before it by writing L2_FLUSH_BYTES: a flush that outlasts a call's host
    path, so that the call is on the stream before the device reaches it."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    fn()
    torch.cuda.synchronize()
    for a, b in ev:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / iters


def _live_pairs(torch, qpos, kpos, qseg, kseg, causal, window):
    """(B, T, S) mask of the pairs the function needs, as the plain
    version builds it."""
    m = torch.ones((qpos.shape[0], qpos.shape[1], kpos.shape[1]),
                   dtype=torch.bool, device=qpos.device)
    d = qpos[:, :, None].long() - kpos[:, None, :].long()
    if causal:
        m &= d >= 0
        if window > 0:
            m &= d < window
    if qseg is not None:
        m &= (qseg[:, :, None] == kseg[:, None, :]) & (kseg[:, None, :] >= 0)
    return m


def _bound_ms(torch, q, k, qpos, kpos, qseg, kseg, causal, window):
    """Least time for the work these inputs need: FLOPs of the live pairs
    (q k^T and p v, 2 x 2 x D each) over the bf16 peak, against bytes of q,
    o, lse, the int inputs and the k/v rows some query can see over HBM."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    live = _live_pairs(torch, qpos, kpos, qseg, kseg, causal, window)
    pairs = int(live.sum()) * h
    flops = 4.0 * d * pairs
    live_keys = int(live.any(dim=1).sum())            # (b, key) pairs read
    nbytes = (2 * b * t * h * d * 2                   # q in, o out
              + 2 * live_keys * kv * d * 2            # live k and v rows
              + b * h * t * 4                         # lse out
              + (b * t + b * s) * 4 * (2 if qseg is not None else 1))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def _library_fn(torch, q, k, v, qpos, kpos, qseg, kseg, causal, window,
                softcap):
    """(name, call): one PyTorch call computing the same attention, its
    output o as (B, H, T, D). With a softcap, flex_attention (SDPA has
    none); else scaled_dot_product_attention."""
    if softcap is not None:
        return "flex_attention", _flex_fn(torch, q, k, v, qpos, kpos, qseg,
                                          kseg, causal, window, softcap)
    import torch.nn.functional as F
    b, t, h, d = q.shape
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    gqa = {"enable_gqa": True} if h != k.shape[2] else {}
    causal_plain = (causal and window == 0 and qseg is None and t == k.shape[1]
                    and bool((qpos == kpos).all()))
    if causal_plain:
        return "sdpa", lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, **gqa)
    mask = _live_pairs(torch, qpos, kpos, qseg, kseg, causal, window)[:, None]
    if bool(mask.all()):     # every pair live (hubert's one segment)
        return "sdpa", lambda: F.scaled_dot_product_attention(qt, kt, vt, **gqa)
    return "sdpa", lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, **gqa)


_FLEX = []


def _flex_fn(torch, q, k, v, qpos, kpos, qseg, kseg, causal, window, softcap,
             do=None):
    """torch.nn.attention.flex_attention, compiled once, with the softcap as
    its score_mod, the live pairs (causal, window, segments) as its mask_mod
    and block mask (built here, outside the timed call), GQA native and the
    lse returned: the one PyTorch call that computes K1's function with a
    softcap, a yardstick the port never calls. Without `do` the call gives
    o (B, H, T, D); with it, the call is torch.autograd.grad of one retained
    forward and gives (dq, dk, dv) as (B, H, T, D)."""
    from torch.nn.attention import flex_attention as FA
    if not _FLEX:
        _FLEX.append(torch.compile(FA.flex_attention, dynamic=False))
    flex = _FLEX[0]
    b, t, h, d = q.shape

    def mask_mod(bi, hi, qi, ki):
        m = qi >= 0
        if causal:
            m = m & (qpos[bi, qi] >= kpos[bi, ki])
            if window > 0:
                m = m & (qpos[bi, qi] - kpos[bi, ki] < window)
        if qseg is not None:
            m = m & (qseg[bi, qi] == kseg[bi, ki]) & (kseg[bi, ki] >= 0)
        return m

    def score_mod(score, bi, hi, qi, ki):
        return softcap * torch.tanh(score / softcap)

    block_mask = FA.create_block_mask(mask_mod, b, None, t, k.shape[1],
                                      device=q.device)
    lse = ({"return_aux": FA.AuxRequest(lse=True)}
           if hasattr(FA, "AuxRequest") else {"return_lse": True})
    grad = do is not None
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(grad)
                  for x in (q, k, v))

    def call():
        return flex(qt, kt, vt, score_mod=score_mod, block_mask=block_mask,
                    enable_gqa=h != k.shape[2], **lse)[0]
    if not grad:
        return call
    out, dot = call(), do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def _grad_close(out, ref, tol):
    """Max |out - ref|, and whether every element is within tol + tol |ref|:
    the reference's gradient check (``np.testing.assert_allclose`` with
    atol = rtol = GRAD_TOL, tests/test_kernel_grads.py:70)."""
    d = (out.float() - ref.float()).abs()
    return float(d.max()), bool((d <= tol + tol * ref.float().abs()).all())


def _tile_rel(torch, out, ref, tile=64):
    """Worst ||out - ref|| / ||ref|| over tiles of ``tile`` rows of axis 1
    (queries for dq, keys for dk and dv) and each head. A tile where ref
    is zero must be zero in out too (its reading is then 0, else inf)."""
    import torch.nn.functional as F
    b, n, h, d = ref.shape
    pad = -n % tile

    def norms(x):
        x = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.reshape(b, (n + pad) // tile, tile, h, d).square() \
            .sum((2, 4)).sqrt()
    nd, nr = norms(out.float() - ref.float()), norms(ref)
    rel = torch.where(nr > 0, nd / nr.clamp_min(1e-30),
                      torch.where(nd > 0, float("inf"), 0.0))
    return float(rel.max())


def _last_live_key_tile(torch, live, tile=64):
    """(B, S) bool: the keys of each row's last tile that holds a key some
    query sees. Dropping them plants the fault of a kernel that skips or
    mishandles that tile."""
    live_k = live.any(dim=1)
    idx = torch.arange(live_k.shape[1], device=live_k.device)
    last = torch.where(live_k, idx, -1).max(dim=1).values
    return (idx[None] // tile == (last // tile)[:, None]) & (last[:, None] >= 0)


def _dropped_key_segments(torch, qs, ks, live, t, s):
    """Segment ids (q side, kv side) that plant the dropped-key fault in a
    plain version: segment -1 on each row's last live key tile, all else
    as given (zeros where the case has no segments)."""
    b = live.shape[0]
    zeros = lambda n: torch.zeros((b, n), dtype=torch.int32, device="cuda")
    ks_f = (zeros(s) if ks is None else ks).clone()
    ks_f[_last_live_key_tile(torch, live)] = -1
    return (zeros(t) if qs is None else qs), ks_f


def _bwd_bound_ms(torch, q, k, qpos, kpos, qseg, kseg, causal, window):
    """Least time of the fused backward for these inputs: the live pairs'
    FLOPs, 10 D per pair (s, dp, dv, dk, dq: 2 D each), over the bf16 peak,
    against bytes over HBM: q, do and dq of every row, k, v, dk and dv of
    the keys some query can see, lse, delta and the int inputs, each once."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    live = _live_pairs(torch, qpos, kpos, qseg, kseg, causal, window)
    pairs = int(live.sum()) * h
    live_keys = int(live.any(dim=1).sum())
    nbytes = (3 * b * t * h * d * 2                # q, do in; dq out
              + 4 * live_keys * kv * d * 2         # k, v in; dk, dv out
              + 2 * b * h * t * 4                  # lse, delta
              + (b * t + b * s) * 4 * (2 if qseg is not None else 1))
    flops = 10.0 * d * pairs
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, pairs)


def _library_bwd_fn(torch, q, k, v, qpos, kpos, qseg, kseg, causal, window,
                    softcap, do):
    """(name, call): torch.autograd.grad through one retained forward of the
    library call at the same shape (flex_attention with a softcap, else
    scaled_dot_product_attention), giving (dq, dk, dv) as (B, H, T, D): a
    yardstick the port never calls."""
    if softcap is not None:
        return "flex_attention", _flex_fn(torch, q, k, v, qpos, kpos, qseg,
                                          kseg, causal, window, softcap, do)
    import torch.nn.functional as F
    h = q.shape[2]
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    gqa = {"enable_gqa": True} if h != k.shape[2] else {}
    mask = _live_pairs(torch, qpos, kpos, qseg, kseg, causal, window)[:, None]
    if qseg is None and causal and window == 0 and q.shape[1] == k.shape[1]:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, **gqa)
    elif bool(mask.all()):   # every pair live (hubert's one segment)
        out = F.scaled_dot_product_attention(qt, kt, vt, **gqa)
    else:
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, **gqa)
    dot = do.transpose(1, 2)
    return "sdpa", lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True)


def _check_backward(torch, fa, name, args, opts, o, lse, timed):
    """The fused backward against mha_backward_plain on K1's residuals,
    elementwise (GRAD_TOL) and per tile (GRAD_REL_TOL); the per-tile check
    must fail a planted fault, the plain backward without each row's last
    live key tile; two more calls must give dq, dk and dv equal to the bit.
    With `timed`, its times (the kernel alone, and the whole CUDA backward)
    beside its bound, the plain version's and SDPA's."""
    q, k, v, qp, kp, qs, ks = args
    gen = torch.Generator(device="cuda").manual_seed(1)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
    delta = fa.attention_delta(o, do)
    res = (*args, o, lse, do)
    dq, dk, dv = fa.mha_backward_cuda(*res, delta, **opts)
    torch.cuda.synchronize()
    ref = fa.mha_backward_plain(*res, **opts)
    live = _live_pairs(torch, qp, kp, qs, ks, opts["causal"], opts["window"])
    # the planted fault: segment -1 on the dropped keys, lse and delta kept
    t = q.shape[1]
    qs_f, ks_f = _dropped_key_segments(torch, qs, ks, live, t, k.shape[1])
    fault = fa.mha_backward_plain(q, k, v, qp, kp, qs_f, ks_f, o, lse, do,
                                  **opts)
    errs, rels, fault_rels, fault_ok = {}, {}, {}, True
    for g, out, r, f in zip(("dq", "dk", "dv"), (dq, dk, dv), ref, fault):
        check(bool(torch.isfinite(out).all()), f"backward {name}: non-finite {g}")
        errs[g], ok = _grad_close(out, r, GRAD_TOL_BF16)
        check(ok, f"backward {name}: {g} outside GRAD_TOL {GRAD_TOL_BF16} of "
              f"the plain version (max |diff| {errs[g]:.3e})")
        rels[g], fault_rels[g] = _tile_rel(torch, out, r), _tile_rel(torch, f, r)
        fault_ok &= _grad_close(f, r, GRAD_TOL_BF16)[1]
    del fault
    dead_rows = ~live.any(dim=2)                      # (B, T): no visible key
    dead_keys = ~live.any(dim=1)                      # (B, S): seen by no query
    check(bool((dq[dead_rows] == 0).all()), f"backward {name}: dq of rows "
          "with no visible key is not zero")
    check(bool((dk[dead_keys] == 0).all()) and bool((dv[dead_keys] == 0).all()),
          f"backward {name}: dk/dv of keys no query sees are not zero")
    line = (f"[kernel] {name:20s} backward: max|dq-plain| {errs['dq']:.3e} "
            f"max|dk-plain| {errs['dk']:.3e} max|dv-plain| {errs['dv']:.3e} "
            f"(GRAD_TOL {GRAD_TOL_BF16}) rows without a key {int(dead_rows.sum())}"
            f", keys without a query {int(dead_keys.sum())}\n"
            f"[kernel] {name:20s} worst tile ||out-plain||/||plain||: dq "
            f"{rels['dq']:.3e} dk {rels['dk']:.3e} dv {rels['dv']:.3e}; planted "
            f"fault (last live key tile dropped): dq {fault_rels['dq']:.3e} dk "
            f"{fault_rels['dk']:.3e} dv {fault_rels['dv']:.3e}, elementwise "
            f"GRAD_TOL {'passes' if fault_ok else 'fails'} it "
            f"(GRAD_REL_TOL {GRAD_REL_TOL})")
    print(line, flush=True)
    check(max(rels.values()) <= GRAD_REL_TOL, f"backward {name}: a tile's "
          f"relative error exceeds GRAD_REL_TOL {GRAD_REL_TOL}")
    check(max(fault_rels.values()) > GRAD_REL_TOL, f"backward {name}: the "
          "per-tile check does not see the planted fault")
    # repeatable bit for bit: dq's tiles are added in a fixed order
    same = True
    for _ in range(2):
        again = fa.mha_backward_cuda(*res, delta, **opts)
        same &= all(bool(torch.equal(a, b)) for a, b in zip((dq, dk, dv), again))
        del again
    print(f"[kernel] {name:20s} backward: two more calls equal to the bit: "
          f"{'yes' if same else 'NO'}", flush=True)
    check(same, f"backward {name}: dq, dk or dv differ between calls")
    worst = {"K2": (errs["dq"], rels["dq"]),
             "K3": (max(errs["dk"], errs["dv"]), max(rels["dk"], rels["dv"]))}
    if not timed:
        return {}, worst
    iters = 10
    # the kernel alone runs at an instantiated head dim, on the operands
    # the wrapper pads (hubert's 80 to 128) with the scale it passes
    d = q.shape[-1]
    (pq, pk, pv, po, pdo), sm_scale = fa.kernel_operands(q, k, v, o, do)
    kd = pq.shape[-1]
    pad_ms = (_cuda_time(torch, lambda: fa.kernel_operands(q, k, v, o, do),
                         iters) if kd != d else 0.0)
    acc, sem = fa.dq_accumulator(pq)
    dkp, dvp = torch.empty_like(pk), torch.empty_like(pv)
    # a zeroed set of dq counters for each launch, made before the timing
    sems = iter(torch.zeros((iters + 2,) + sem.shape, dtype=torch.int32,
                            device="cuda"))
    ms = _cuda_time(torch, lambda: fa._launch_backward(
        pq, pk, pv, qp, kp, qs, ks, po, lse, pdo, delta, acc, dkp, dvp,
        sm_scale=sm_scale, sem=next(sems), **opts), iters)
    del pq, pk, pv, po, pdo, dkp, dvp
    whole_ms = _cuda_time(torch, lambda: fa.mha_backward(*res, **opts), iters)
    # the whole backward's other parts: delta, the zeroed accumulator, the cast
    delta_ms = _cuda_time(torch, lambda: fa.attention_delta(o, do), iters)
    zeros_ms = _cuda_time(torch, lambda: fa.dq_accumulator(q), iters)
    cast_ms = _cuda_time(torch, lambda: fa.dq_from_accumulator(acc, t), iters)
    del acc, sem, sems
    plain_ms = _cuda_time(torch, lambda: fa.mha_backward_plain(*res, **opts),
                          3, warmup=1)
    # the library call, held to the plain version on the rows and keys
    # some pair reaches. Its output on a row with no visible key is not
    # K1's zero (SDPA's is a mean of v), so do is zero there for it, as a
    # training step's gradient is on padding
    lib_name, lib = _library_bwd_fn(torch, q, k, v, qp, kp, qs, ks,
                                    opts["causal"], opts["window"],
                                    opts["softcap"],
                                    do * ~dead_rows[:, :, None, None])
    lib_err = 0.0
    for g, out, r, sel in zip(("dq", "dk", "dv"), lib(), ref,
                              (~dead_rows, ~dead_keys, ~dead_keys)):
        err, ok = _grad_close(out.transpose(1, 2)[sel], r[sel], GRAD_TOL_BF16)
        check(ok, f"backward {name}: {lib_name}'s {g} outside GRAD_TOL "
              f"{GRAD_TOL_BF16} of the plain version (max |diff| {err:.3e})")
        lib_err = max(lib_err, err)
    library_ms = _cuda_time(torch, lib, iters)
    bound_ms, bound_by, flops, pairs = _bwd_bound_ms(
        torch, q, k, qp, kp, qs, ks, opts["causal"], opts["window"])
    rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library_ms, library=lib_name, library_err=lib_err,
               backward_ms=whole_ms, delta_ms=delta_ms,
               zeros_ms=zeros_ms, cast_ms=cast_ms, live_pairs=pairs,
               covers="dq, dk and dv in one launch: the work of the "
               "reference's K2 and K3; backward_ms adds delta, the zeroed "
               "dq accumulator and counters, and dq's cast",
               repeatable=same)
    if kd != d:
        rec.update(head_dim=d, kernel_head_dim=kd, pad_ms=pad_ms)
    print(f"[kernel] {name:20s} backward kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s over {pairs} live pairs), whole "
          f"CUDA backward {whole_ms:.4f} ms (delta {delta_ms:.4f}, zeroed "
          f"accumulator and counters {zeros_ms:.4f}, dq cast {cast_ms:.4f}); bound "
          f"{bound_ms:.4f} ms by "
          f"{bound_by} ({100 * bound_ms / ms:.1f}% of bound, "
          f"{100 * bound_ms / whole_ms:.1f}% for the whole); plain "
          f"{plain_ms:.4f} ms, {lib_name} {library_ms:.4f} ms (max |d-plain| "
          f"{lib_err:.3e})"
          + (f"; head dim {d} padded to {kd}: the kernel at {kd}, the "
             f"padding of q, k, v, o and do {pad_ms:.4f} ms (in the whole)"
             if kd != d else ""), flush=True)
    return {"K2": rec, "K3": rec}, worst


def _train_rows(lengths, t):
    """One sample per row, right-padded with segment -1; positions restart
    at 0 and are 0 on padding."""
    seg = [[0] * n + [-1] * (t - n) for n in lengths]
    pos = [list(range(n)) + [0] * (t - n) for n in lengths]
    return seg, pos


def _cross_rows(enc_lengths, t_enc, t_dec):
    """Segment ids (decoder side, encoder side) of cross-attention rows:
    row r holds an encoder sample of enc_lengths[r] tokens and a decoder
    sample of a quarter of that (at most t_dec); odd rows split both into
    two samples, segments 0 and 1; the last row is all padding."""
    dec, enc = [], []
    for r, n in enumerate(enc_lengths):
        m = min(t_dec, max(2, n // 4))
        if r == len(enc_lengths) - 1:
            n = m = 0
        if r % 2:
            e = [0] * (n // 2) + [1] * (n - n // 2)
            d = [0] * (m // 2) + [1] * (m - m // 2)
        else:
            e, d = [0] * n, [0] * m
        enc.append(e + [-1] * (t_enc - n))
        dec.append(d + [-1] * (t_dec - m))
    return dec, enc


def phase_kernel(torch):
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)
    B_DEC, S_DEC, POS_DEC = 16, 2056, 1027
    # segmented rows: two samples then padding; the second row has a
    # sample, padding, and query rows whose every key is padding
    seg = [[0] * 100 + [1] * 120 + [-1] * 80, [2] * 50 + [-1] * 250]
    seg_pos = [list(range(100)) + list(range(120)) + [0] * 80,
               list(range(50)) + [0] * 250]
    tr_seg, tr_pos = _train_rows(TRAIN_ROWS, 2048)
    # row 0: a sample of 200 tokens, then padding, so that query rows
    # 256..383 are a 128-row tile of pure padding; row 1: one of 300
    pad_seg, pad_pos = _train_rows((200, 300), 384)
    # the serve's prefill into a cache longer than the prompt: keys past the
    # prompt are masked by position
    cache_kpos = [list(range(216))] * 2
    # the t5 phase's attention: the encoder's self-attention over rows of
    # one sample each, and cross-attention from 128 decoder tokens to them,
    # where odd rows pack two samples (segments 0 and 1 on both sides) and
    # the last row is all padding
    enc_seg, enc_pos = _train_rows(T5_ENC_ROWS, 512)
    x_dec_seg, x_enc_seg = _cross_rows(T5_ENC_ROWS, 512, T5_DEC_LEN)
    # the moe phase's training attention (granite: 24 q and 8 kv heads x
    # 64), rows of one sample each as in train-segmented; the frames
    # phase's (hubert: 16 heads x 80, non-causal, one segment)
    gr_seg, gr_pos = _train_rows(TRAIN_ROWS * 2, 2048)
    hb_seg = [[0] * HUBERT_SEQ] * HUBERT_BATCH
    # the gemma2 phase's attention at head dim 256 (8 q and 4 kv heads,
    # softcap 50): its training rows, a local layer past its 4096-token
    # window (which the 2048-token paths never reach), a decode step at
    # position 8199 with the window in effect, the training rows without
    # softcap for SDPA's time, and a global layer's last 256 queries over
    # 40960 keys, past the 32768 that K1's table of 512 key-tile statistics
    # covers at once at D 256
    gm = dict(h=GEMMA2_HEADS, kv=GEMMA2_KV_HEADS, d=256)
    gm_opts = dict(softcap=GEMMA2_SOFTCAP)
    gm_local = dict(window=GEMMA2_WINDOW, softcap=GEMMA2_SOFTCAP)
    # name, shape, options, K1 timed, backward: None, "check" or the name
    # of its timed record
    cases = [
        ("prefill", dict(b=8, t=2048, s=2048, h=32, kv=32), {}, True,
         "causal-2048"),
        ("decode", dict(b=B_DEC, t=1, s=S_DEC, h=32, kv=32,
                        q_pos=[[POS_DEC]] * B_DEC), {}, True, None),
        ("train-segmented", dict(b=4, t=2048, s=2048, h=32, kv=32,
                                 q_pos=tr_pos, kv_pos=tr_pos, q_seg=tr_seg,
                                 kv_seg=tr_seg), {}, True, "train-segmented"),
        ("prefill-cache", dict(b=2, t=200, s=216, h=4, kv=4,
                               kv_pos=cache_kpos), {}, False, None),
        ("padding-tile", dict(b=2, t=384, s=384, h=4, kv=2, q_pos=pad_pos,
                              kv_pos=pad_pos, q_seg=pad_seg, kv_seg=pad_seg),
         {}, False, None),
        ("gqa", dict(b=2, t=256, s=256, h=8, kv=2), {}, False, "check"),
        ("window", dict(b=2, t=512, s=512, h=4, kv=4), dict(window=128), False,
         "check"),
        ("softcap", dict(b=2, t=256, s=256, h=4, kv=2, q_scale=4.0),
         dict(softcap=3.0), False, "check"),
        ("segmented", dict(b=2, t=300, s=300, h=4, kv=2, q_pos=seg_pos,
                           kv_pos=seg_pos, q_seg=seg, kv_seg=seg), {}, False,
         "check"),
        ("segmented-noncausal", dict(b=2, t=300, s=300, h=4, kv=2, q_seg=seg,
                                     kv_seg=seg), dict(causal=False), False,
         "check"),
        ("ragged-700", dict(b=2, t=700, s=700, h=4, kv=4), {}, False, "check"),
        ("cross-noncausal", dict(b=2, t=130, s=200, h=4, kv=1),
         dict(causal=False), False, "check"),
        ("t5-enc", dict(b=16, t=512, s=512, h=128, kv=128, q_pos=enc_pos,
                        kv_pos=enc_pos, q_seg=enc_seg, kv_seg=enc_seg),
         dict(causal=False), True, "t5-enc"),
        ("t5-cross", dict(b=16, t=T5_DEC_LEN, s=512, h=128, kv=128,
                          q_seg=x_dec_seg, kv_seg=x_enc_seg),
         dict(causal=False), True, "t5-cross"),
        ("granite-train", dict(b=8, t=2048, s=2048, h=24, kv=8, d=64,
                               q_pos=gr_pos, kv_pos=gr_pos, q_seg=gr_seg,
                               kv_seg=gr_seg), {}, True, "granite-train"),
        ("hubert-4k", dict(b=HUBERT_BATCH, t=HUBERT_SEQ, s=HUBERT_SEQ, h=16,
                           kv=16, d=80, q_seg=hb_seg, kv_seg=hb_seg),
         dict(causal=False), True, "hubert-4k"),
        ("gemma2-train", dict(b=4, t=2048, s=2048, q_pos=tr_pos, kv_pos=tr_pos,
                              q_seg=tr_seg, kv_seg=tr_seg, **gm), gm_opts,
         True, "gemma2-train"),
        ("d256-causal", dict(b=4, t=2048, s=2048, q_pos=tr_pos, kv_pos=tr_pos,
                             q_seg=tr_seg, kv_seg=tr_seg, **gm), {}, True,
         "d256-causal"),
        ("gemma2-local-8k", dict(b=2, t=8192, s=8192, **gm), gm_local, True,
         "gemma2-local-8k"),
        ("gemma2-decode", dict(b=B_DEC, t=1, s=8200, q_pos=[[8199]] * B_DEC,
                               **gm), gm_local, True, None),
        # the serve paths' decode steps: gemma2-2b's (its window not in
        # effect), granite-moe's and llava-next's, and 16 query rows of a
        # GQA group of 7 (two row groups of the decode form)
        ("gemma2-serve-decode", dict(b=8, t=1, s=2064, q_pos=[[2063]] * 8,
                                     **gm), gm_local, True, None),
        ("granite-decode", dict(b=8, t=1, s=2064, h=24, kv=8, d=64,
                                q_pos=[[2063]] * 8), {}, True, None),
        ("llava-decode", dict(b=4, t=1, s=3400, h=56, kv=8, d=128,
                              q_pos=[[3399]] * 4), {}, True, None),
        ("gqa7-t16-decode", dict(b=4, t=16, s=3400, h=56, kv=8, d=128,
                                 q_pos=[list(range(3384, 3400))] * 4), {},
         False, None),
        ("padding-tile-d256", dict(b=2, t=384, s=384, h=4, kv=2, d=256,
                                   q_pos=pad_pos, kv_pos=pad_pos, q_seg=pad_seg,
                                   kv_seg=pad_seg), gm_opts, True,
         "padding-tile-d256"),
        ("d256-keys-40960", dict(b=1, t=256, s=40960, h=2, kv=1, d=256,
                                 q_pos=[list(range(40704, 40960))]), gm_opts,
         True, "d256-keys-40960"),
    ]
    # worst |out - plain| and worst tile relative error
    records, worst = {}, {"K1": (0.0, 0.0), "K2": (0.0, 0.0), "K3": (0.0, 0.0)}
    for name, shape, opts, timed, bwd in cases:
        opts = {"causal": True, "window": 0, "softcap": None, **opts}
        q, k, v, qp, kp, qs, ks = _case_inputs(torch, gen, **shape)
        args = (q, k, v, qp, kp, qs, ks)
        o, lse = fa.mha_forward(*args, **opts)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.mha_forward_plain(*args, **opts)
        check(bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all()),
              f"K1 {name}: non-finite output")
        err_o = float((o.float() - o_ref.float()).abs().max())
        seen = lse_ref > -1e29                 # rows with a visible key
        err_l = float((lse - lse_ref)[seen].abs().max()) if seen.any() else 0.0
        check(bool((lse[~seen] <= -1e29).all()),
              f"K1 {name}: fully masked rows lost the -1e30 sentinel")
        check(bool((o[~seen.permute(0, 2, 1)] == 0).all()),
              f"K1 {name}: fully masked rows are not zero")
        # per 64-row tile and head, against the planted fault: the plain
        # forward without each row's last live key tile
        live = _live_pairs(torch, qp, kp, qs, ks, opts["causal"],
                           opts["window"])
        qs_f, ks_f = _dropped_key_segments(torch, qs, ks, live, q.shape[1],
                                           k.shape[1])
        o_fault = fa.mha_forward_plain(q, k, v, qp, kp, qs_f, ks_f, **opts)[0]
        rel, f_rel = _tile_rel(torch, o, o_ref), _tile_rel(torch, o_fault, o_ref)
        f_ok = _grad_close(o_fault, o_ref, TOL_BF16)[1]
        del live, o_fault
        worst["K1"] = (max(worst["K1"][0], err_o, err_l),
                       max(worst["K1"][1], rel))
        line = (f"[kernel] {name:20s} q {tuple(q.shape)} k {tuple(k.shape)} "
                f"max|o-plain| {err_o:.3e} max|lse-plain| {err_l:.3e} "
                f"(tol {TOL_BF16}) masked rows {int((~seen).sum())}; worst "
                f"tile ||o-plain||/||plain|| {rel:.3e}, planted fault (last "
                f"live key tile dropped) {f_rel:.3e}, elementwise TOL "
                f"{'passes' if f_ok else 'fails'} it (FWD_REL_TOL "
                f"{FWD_REL_TOL})")
        check(err_o <= TOL_BF16 and err_l <= TOL_BF16,
              f"K1 {name}: disagrees with its plain version: {line}")
        check(rel <= FWD_REL_TOL, f"K1 {name}: a tile's relative error "
              f"{rel:.3e} exceeds FWD_REL_TOL {FWD_REL_TOL}")
        check(f_rel > FWD_REL_TOL, f"K1 {name}: the per-tile check does not "
              "see the planted fault")
        decode = q.shape[1] <= fa.DECODE_MAX_T
        if decode:   # repeatable bit for bit: every sum in a fixed order
            same = True
            for _ in range(2):
                again = fa.mha_forward(*args, **opts)
                same &= bool(torch.equal(o, again[0])) and bool(
                    torch.equal(lse, again[1]))
                del again
            b_, t_, h_, _ = q.shape
            gh, n_split = fa.decode_plan(b_, t_, h_, k.shape[2], k.shape[1],
                                         fa.kernel_head_dim(q.shape[-1]),
                                         fa.sm_count(q.device))
            line += (f"\n[kernel] {name:20s} decode form: {n_split} splits, "
                     f"{gh} q heads a block; two more calls equal to the "
                     f"bit: {'yes' if same else 'NO'}")
            check(same, f"K1 {name}: the decode form differs between calls")
        if timed:
            iters = 100 if decode else 20
            ms = _cuda_time(torch, lambda: fa.mha_forward(*args, **opts), iters)
            plain_ms = _cuda_time(
                torch, lambda: fa.mha_forward_plain(*args, **opts),
                max(3, iters // 10), warmup=1)
            # the library call, held to the plain version on seen rows
            lib_name, lib = _library_fn(torch, *args, opts["causal"],
                                        opts["window"], opts["softcap"])
            rows = seen.permute(0, 2, 1)
            lib_err = float((lib().transpose(1, 2)[rows].float()
                             - o_ref[rows].float()).abs().max())
            check(lib_err <= TOL_BF16, f"K1 {name}: {lib_name} disagrees with "
                  f"the plain version: max |o-plain| {lib_err:.3e}")
            library_ms = _cuda_time(torch, lib, iters)
            bound_ms, bound_by, flops, nbytes = _bound_ms(
                torch, q, k, qp, kp, qs, ks, opts["causal"], opts["window"])
            records[("K1", name)] = dict(ms=ms, plain_ms=plain_ms,
                                         bound_ms=bound_ms, bound_by=bound_by,
                                         library_ms=library_ms,
                                         library=lib_name,
                                         library_err=lib_err)
            dev_note = ""
            if decode:
                # a call's host path takes longer than the decode form, and
                # a small cache stays in L2 between back-to-back calls, where
                # the serve path finds every layer's cache cold: ms and
                # library_ms are each call's time on the stream after a
                # flush of L2, call_ms and library_call_ms the events over
                # back-to-back calls
                k1_ms = _cold_ms(torch, lambda: fa.mha_forward(*args, **opts),
                                 iters)
                lib_ms = _cold_ms(torch, lib, iters)
                records[("K1", name)].update(
                    ms=k1_ms, library_ms=lib_ms, call_ms=ms,
                    library_call_ms=library_ms, repeatable=same,
                    n_split=n_split, heads_per_block=gh)
                dev_note = (f"\n[kernel] {name:20s} each call after a flush of "
                            f"L2: K1 {k1_ms:.4f} ms, {100 * bound_ms / k1_ms:.1f}% "
                            f"of bound; {lib_name} {lib_ms:.4f} ms")
            d, kd = q.shape[-1], fa.kernel_head_dim(q.shape[-1])
            pad_note = ""
            if kd != d:   # ms covers the padding of q, k, v and o's cut
                pad_ms = _cuda_time(
                    torch, lambda: fa.kernel_operands(q, k, v), iters)
                records[("K1", name)].update(head_dim=d, kernel_head_dim=kd,
                                             pad_ms=pad_ms)
                pad_note = (f"; head dim {d} padded to {kd}, the padding of "
                            f"q, k and v {pad_ms:.4f} ms of it")
            line += (f"\n[kernel] {name:20s} kernel {ms:.4f} ms "
                     f"({flops / ms / 1e9:.1f} TFLOP/s, "
                     f"{nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, "
                     f"{lib_name} {library_ms:.4f} ms (max |o-plain| "
                     f"{lib_err:.3e}), "
                     f"bound {bound_ms:.4f} ms by {bound_by} "
                     f"({100 * bound_ms / ms:.1f}% of bound){pad_note}"
                     f"{dev_note}")
        print(line, flush=True)
        del o_ref, lse_ref
        if bwd is not None:
            recs, errs = _check_backward(torch, fa, name, args, opts, o, lse,
                                         timed=bwd != "check")
            for kname, (err, rel) in errs.items():
                worst[kname] = (max(worst[kname][0], err),
                                max(worst[kname][1], rel))
            for kname, rec in recs.items():
                records[(kname, bwd)] = rec
        torch.cuda.empty_cache()
    return records, worst


def _ssd_inputs(torch, gen, *, b, t, h, p, g, n, a_scale=1.0):
    """x, B and C as strided views of one (B, T, H·P + 2·G·N) bf16 tensor,
    as mamba_fwd hands them to K4 (slices of the conv output); dt =
    softplus(normal) and A = -exp(normal) · a_scale in fp32."""
    u = torch.randn((b, t, h * p + 2 * g * n), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    x = u[..., :h * p].reshape(b, t, h, p)
    B = u[..., h * p:h * p + g * n].reshape(b, t, g, n)
    C = u[..., h * p + g * n:].reshape(b, t, g, n)
    dt = torch.nn.functional.softplus(
        torch.randn((b, t, h), generator=gen, device="cuda"))
    A = -torch.exp(torch.randn((h,), generator=gen, device="cuda")) * a_scale
    return x, dt, A, B, C


# the chunk length at which K4's bound counts FLOPs, whatever chunk K4 takes,
# so that the times of all its forms divide by the same work
SSD_BOUND_CHUNK = 64


def _ssd_bound_ms(x, B):
    """Least time of K4 for these inputs: the chunked algorithm's FLOPs at
    64-step chunks, 2 L (L N + L P + 2 N P) per (batch row, head, chunk of
    L real steps), over the bf16 peak (x, B and C are bf16), against the
    bytes of x and y (bf16), B and C (bf16), dt (fp32), A and the final
    state (fp32), each once, over HBM."""
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    c = SSD_BOUND_CHUNK
    lens = [min(c, t - t0) for t0 in range(0, t, c)]
    flops = float(b * h * sum(2 * L * (L * n + L * p + 2 * n * p)
                              for L in lens))
    nbytes = (2 * b * t * h * p * 2 + 2 * b * t * g * n * 2 + b * t * h * 4
              + h * 4 + b * h * p * n * 4)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def _state_reset_fault(SSD, ref, torch, x, dt, A, B, C):
    """The planted fault: the plain version with the inter-chunk term
    dropped, i.e. the state reset to zero at every boundary of K4's
    64-step chunks."""
    ys, st, chunk = [], None, SSD.CHUNK
    for t0 in range(0, x.shape[1], chunk):
        sl = slice(t0, t0 + chunk)
        y, st = ref.ssd_ref_chunked(x[:, sl], dt[:, sl], A, B[:, sl], C[:, sl])
        ys.append(y)
    return torch.cat(ys, dim=1), st


def _rel_per_head(torch, out, ref):
    """Worst ||out - ref|| / ||ref|| over (batch row, head) of a state."""
    d = (out.float() - ref.float()).flatten(2).norm(dim=2)
    r = ref.float().flatten(2).norm(dim=2)
    return float(torch.where(r > 0, d / r.clamp_min(1e-30),
                             torch.where(d > 0, float("inf"), 0.0)).max())


def _rel_per_chunk_state(torch, out, ref):
    """Worst ||out - ref|| / ||ref|| over (batch row, head, chunk) of K4's
    chunk-start states (B, H, chunks - 1, P, N)."""
    if out.shape[2] == 0:
        return 0.0
    d = (out.float() - ref.float()).flatten(3).norm(dim=3)
    r = ref.float().flatten(3).norm(dim=3)
    return float(torch.where(r > 0, d / r.clamp_min(1e-30),
                             torch.where(d > 0, float("inf"), 0.0)).max())


def phase_kernel_ssd(torch):
    """K4 against its plain version: elementwise (SSD_TOL_BF16) and per
    chunk (SSD_REL_TOL), the planted fault read on every case and required
    to fail the per-chunk check wherever the state carries across chunks;
    the states it writes at each chunk's start against the plain pass over
    chunks (per chunk, SSD_REL_TOL); two calls equal to the bit; at the timed shapes,
    K4 and its first, serial form (step 0) in turns."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as SSD
    print("[kernel] K4 products (fp32 sums throughout): " + "; ".join(
        f"{k}: {v}" for k, v in SSD.PRECISION.items()), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    serve = dict(h=24, p=64, g=1, n=128)          # mamba2-130m's mixer
    # name, shape, timed, whether the planted fault must be seen
    cases = [
        ("ssd-serve", dict(b=8, t=2048, **serve), True, True),
        ("ssd-192", dict(b=8, t=192, **serve), True, True),
        ("ssd-96", dict(b=8, t=96, **serve), False, True),
        ("ssd-groups", dict(b=2, t=300, h=4, p=16, g=2, n=16), False, True),
        ("ssd-T1", dict(b=2, t=1, **serve), False, False),
        ("ssd-strong-decay", dict(b=2, t=300, a_scale=40.0, **serve), False,
         False),
    ]
    records, worst = {}, (0.0, 0.0)
    for name, shape, timed, fault_seen in cases:
        args = _ssd_inputs(torch, gen, **shape)
        x, dt, A, B, C = args
        y, st, starts = SSD._ssd_cuda(*args, chunk_states=True)
        torch.cuda.synchronize()
        y_ref, st_ref = ref.ssd_ref_chunked(*args)
        # the state's recurrence alone, against the plain pass over chunks
        starts_rel = _rel_per_chunk_state(
            torch, starts, ref.ssd_chunk_parallel(*args)[2])
        y2, st2 = SSD.ssd_chunked(*args)
        same = bool(torch.equal(y, y2)) and bool(torch.equal(st, st2))
        del y2, st2, starts
        check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all()),
              f"K4 {name}: non-finite output")
        err_y, ok_y = _grad_close(y, y_ref, SSD_TOL_BF16)
        err_s, ok_s = _grad_close(st, st_ref, SSD_TOL_BF16)
        rel = max(_tile_rel(torch, y, y_ref, tile=SSD.CHUNK),
                  _rel_per_head(torch, st, st_ref))
        y_f, st_f = _state_reset_fault(SSD, ref, torch, *args)
        f_rel = max(_tile_rel(torch, y_f, y_ref, tile=SSD.CHUNK),
                    _rel_per_head(torch, st_f, st_ref))
        f_ok = _grad_close(y_f, y_ref, SSD_TOL_BF16)[1] and \
            _grad_close(st_f, st_ref, SSD_TOL_BF16)[1]
        del y_f, st_f
        worst = (max(worst[0], err_y, err_s), max(worst[1], rel))
        a_min = float((dt * A)[:, :SSD.CHUNK].sum(1).min())
        line = (f"[kernel] {name:20s} x {tuple(x.shape)} B {tuple(B.shape)} "
                f"max|y-plain| {err_y:.3e} (max|y| {float(y_ref.abs().max()):.1f})"
                f" max|state-plain| {err_s:.3e} (tol {SSD_TOL_BF16}, atol = "
                f"rtol); worst chunk/state ||out-plain||/||plain|| "
                f"{rel:.3e}; planted fault (state reset per 64-step chunk) "
                f"{f_rel:.3e}, elementwise tol {'passes' if f_ok else 'fails'}"
                f" it (SSD_REL_TOL {SSD_REL_TOL}); least sum of dt A over a "
                f"first chunk {a_min:.1f}; chunk-start states (hi + lo) "
                f"vs the plain pass, worst per chunk {starts_rel:.3e}; a "
                f"second call equal to the bit: {'yes' if same else 'NO'}")
        print(line, flush=True)
        check(ok_y and ok_s, f"K4 {name}: disagrees with its plain version")
        check(rel <= SSD_REL_TOL, f"K4 {name}: a chunk's relative error "
              f"{rel:.3e} exceeds SSD_REL_TOL {SSD_REL_TOL}")
        check(starts_rel <= SSD_REL_TOL, f"K4 {name}: a chunk-start state's "
              f"relative error {starts_rel:.3e} exceeds SSD_REL_TOL")
        check(same, f"K4 {name}: two calls differ")
        if fault_seen:
            check(f_rel > SSD_REL_TOL, f"K4 {name}: the per-chunk check does "
                  "not see the planted fault")
        if timed:
            # step 0 (the serial form) and K4 in turns: s0, K4, K4, s0
            step0 = lambda: SSD.ssd_serial_cuda(*args)     # noqa: E731
            y0, st0 = step0()
            check(_grad_close(y0, y_ref, SSD_TOL_BF16)[1]
                  and _grad_close(st0, st_ref, SSD_TOL_BF16)[1],
                  f"K4 step 0 {name}: disagrees with the plain version")
            del y0, st0
            turns = [_cuda_time(torch, f, 20)
                     for f in (step0, lambda: SSD.ssd_chunked(*args),
                               lambda: SSD.ssd_chunked(*args), step0)]
            ms, step0_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
            plain_ms = _cuda_time(torch, lambda: ref.ssd_ref_chunked(*args),
                                  3, warmup=1)
            bound_ms, bound_by, flops, nbytes = _ssd_bound_ms(x, B)
            records[("K4", name)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                library="none: no single PyTorch call computes the SSD",
                step0_ms=step0_ms, turns_ms=turns, precision=SSD.PRECISION,
                repeatable=same)
            print(f"[kernel] {name:20s} K4 {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                  f"TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s), step 0 (serial "
                  f"form) {step0_ms:.4f} ms ({step0_ms / ms:.2f}x; turns "
                  f"{', '.join(f'{t:.4f}' for t in turns)}), plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                  f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; "
                  f"{100 * bound_ms / ms:.1f}% of bound)", flush=True)
        del args, x, dt, A, B, C, y, st, y_ref, st_ref
        torch.cuda.empty_cache()
    return records, {"K4": worst}


# ----------------------------------------------------------------------
# phase 3: serve at full width
# ----------------------------------------------------------------------
def _serve(torch, n_layers, *, n_requests, max_prompt, decode_steps, seed,
           arch="gpt-paper", tag="serve"):
    from repro_torch import serve as SV
    from repro_torch.models import model as MD
    cfg = SV.make_config(arch, "full", n_layers)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = MD.init_params(gen, cfg, device="cuda")
    tokens = SV.make_requests(cfg, n_requests, max_prompt)
    res = SV.serve(params, cfg, tokens, max_prompt=max_prompt,
                   decode_steps=decode_steps,
                   log=lambda m: print(f"[{tag}]{m}", flush=True))
    del params
    return cfg, tokens, res


def _compare_serves(torch, a, b, tol):
    """Max |logit difference| over the steps both runs fed the same tokens.
    A row stops being compared after the first step where the greedy
    tokens differ; there the top-2 gap must be within 2 x tol."""
    worst, compared = 0.0, 0
    for la, lb, ta, tb in zip(a.logits, b.logits, a.tokens, b.tokens):
        for row in range(la.shape[1]):
            for step in range(la.shape[0]):
                x, y = la[step, row], lb[step, row]
                d = float((x - y).abs().max())
                worst = max(worst, d / (1.0 + float(y.abs().max())))
                compared += 1
                if ta[row, step] != tb[row, step]:
                    top2 = torch.topk(y, 2).values
                    gap = float(top2[0] - top2[1])
                    check(gap <= 2 * tol, f"greedy tokens differ at row {row} "
                          f"step {step} with a top-2 gap of {gap:.3e}")
                    break
    return worst, compared


def phase_serve(torch, requests, max_prompt, decode_steps):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cfg, tokens, res = _serve(torch, 32, n_requests=requests,
                              max_prompt=max_prompt,
                              decode_steps=decode_steps, seed=0)
    counts = ops.launch_counts()
    launches = counts["mha_forward"]
    took = time.perf_counter() - t0
    import numpy as np
    from repro_torch.serve import report
    lens = np.array([len(t) for t in tokens])
    for line in report(res, lens).splitlines():
        print(f"[serve] {line}")
    nb = len(res.batches)
    expected = cfg.n_layers * (nb + nb * decode_steps)
    print(f"[serve] {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"({cfg.n_params() / 1e9:.2f} B params), {len(tokens)} requests, "
          f"{decode_steps} decode steps in {took:.1f}s incl. init; "
          f"K1 launches {launches} (expected {expected}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    check(launches == expected, f"K1 launched {launches} times, "
          f"expected {expected}")
    finite = all(bool(torch.isfinite(x).all()) for x in res.logits)
    check(finite, "non-finite logits in the 32-layer serve")
    del res
    torch.cuda.empty_cache()

    # the same serve, 2 layers, once with K1 and once with the plain version
    kw = dict(n_requests=requests, max_prompt=max_prompt,
              decode_steps=decode_steps, seed=1)
    _, _, with_k1 = _serve(torch, 2, **kw)
    with mock.patch.object(fa, "_mha_forward_cuda",
                           lambda *a, **o: fa.mha_forward_plain(*a, **o)):
        _, _, with_plain = _serve(torch, 2, **kw)
    err, compared = _compare_serves(torch, with_k1, with_plain, TOL_BF16)
    print(f"[serve] 2 layers, K1 vs plain attention: max |logit diff| / "
          f"(1 + max|logit|) {err:.3e} over {compared} (row, step) logit "
          f"vectors (tol {TOL_BF16})", flush=True)
    check(err <= TOL_BF16, "2-layer serve logits: K1 and plain disagree")
    return counts


# ----------------------------------------------------------------------
# phase 4: train at full width
# ----------------------------------------------------------------------
def _train_setup(torch, n_layers, n_stages=1, arch="gpt-paper"):
    """``arch`` (gpt-paper) at full width and ``n_layers``, its stream at
    the model's vocabulary, cost model and planner config as the train
    phase runs them (the pipeline phase: over ``n_stages``)."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    from repro_torch.core.cost_model import AnalyticCostModel
    from repro_torch.core.planner import PlannerConfig
    from repro_torch.core.shapes import ShapePalette
    from repro_torch.data.streams import MultiTaskStream, StreamConfig
    cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers)
    stream = MultiTaskStream(StreamConfig(vocab=cfg.vocab, **TRAIN_STREAM))
    pal = ShapePalette.build(min_seq=64, max_seq=TRAIN_STREAM["max_len"],
                             seq_align=64, max_mbs=16)
    pcfg = PlannerConfig(
        n_stages=n_stages, d_model=cfg.d_model, palette=pal,
        device_mem=float(torch.cuda.get_device_properties(0).total_memory))
    return cfg, stream, AnalyticCostModel(cfg, n_stages=n_stages), pcfg


def _train(torch, n_layers, iters, seed, params=None, log_every=1,
           n_stages=1, arch="gpt-paper"):
    """The plan-ahead runner on ``arch``; with ``n_stages`` > 1 on the
    threaded stage pipeline."""
    from repro_torch.train.runner import PlanAheadRunner, RunnerConfig
    cfg, stream, cost, pcfg = _train_setup(torch, n_layers, n_stages, arch)
    rcfg = RunnerConfig(n_iters=iters, use_executor=n_stages > 1, seed=seed,
                        log_every=log_every, device="cuda")
    runner = PlanAheadRunner(cfg, cost, pcfg, rcfg, stream, params=params)
    params, history, stats = runner.run()
    check(stats.faults == 0, f"{n_stages}-stage training retried after "
          f"{stats.faults} faults: {stats.recoveries}")
    return cfg, stream, cost, pcfg, params, history, stats


def _plain_attention():
    """Patch the plain versions in for K1 and the backward (CUDA tensors
    only reach them here)."""
    from repro_torch.kernels import flash_attention as fa
    return (mock.patch.object(fa, "_mha_forward_cuda",
                              lambda *a, **o: fa.mha_forward_plain(*a, **o)),
            mock.patch.object(fa, "mha_backward",
                              lambda *a, **o: fa.mha_backward_plain(*a, **o)))


def _leaf_errs(torch, gs, ref):
    """Max |diff|, worst ||diff|| / ||ref|| over the leaves, and whether
    every element is within GRAD_TOL, of two gradients by path."""
    worst_abs, worst_rel, ok = 0.0, 0.0, True
    for k, b in ref.items():
        d = (gs[k] - b).abs()
        ok &= bool((d <= GRAD_TOL_BF16 + GRAD_TOL_BF16 * b.abs()).all())
        worst_abs = max(worst_abs, float(d.max()))
        worst_rel = max(worst_rel, float(torch.linalg.vector_norm(gs[k] - b)
                                         / torch.linalg.vector_norm(b)))
    return worst_abs, worst_rel, ok


def _same_runs(torch, a, b):
    """Two (params, history) runs: losses, grad norms and every parameter
    equal to the bit."""
    from repro_torch.tree import leaves
    (pa, ha), (pb, hb) = a, b
    return ([(h["loss"], h["grad_norm"]) for h in ha]
            == [(h["loss"], h["grad_norm"]) for h in hb]
            and all(bool(torch.equal(x, y))
                    for x, y in zip(leaves(pa), leaves(pb))))


def phase_train(torch):
    import numpy as np
    from repro_torch.core.planner import plan_iteration
    from repro_torch.data.dataset import materialize_micro_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import model as MD
    from repro_torch.train.pipeline_adapter import build_grad_step
    from repro_torch.tree import leaves, tree_map

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cfg, stream, cost, pcfg, params, hist, stats = _train(
        torch, TRAIN_LAYERS, TRAIN_ITERS, seed=0)
    counts = ops.launch_counts()
    took = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params
    torch.cuda.empty_cache()
    for h in hist:
        gb = stream.batch(h["iter"])
        split = [(m.mbs, m.seq) for m in plan_iteration(
            gb.lengths[:, 0], cost, pcfg).replica_plans[0].micro_batches]
        print(f"[train] iter {h['iter']}: {h['time_s'] * 1e3:.1f} ms, loss "
              f"{h['loss']:.4f}, grad norm {h['grad_norm']:.4f}, "
              f"{h['tokens']} real / {h['padded_tokens']} padded tokens, "
              f"{h['tokens'] / h['time_s']:.1f} real tokens/s, "
              f"micro-batches (rows, seq) {split}", flush=True)
    steady = hist[1:]
    tok_s = sum(h["tokens"] for h in steady) / sum(h["time_s"] for h in steady)
    n_micro = sum(h["n_micro"] for h in hist)
    expected = {"mha_forward": 2 * cfg.n_layers * n_micro,
                "mha_backward": cfg.n_layers * n_micro, "ssd_chunked": 0}
    print(f"[train] {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"({cfg.n_params() / 1e9:.2f} B params), {len(hist)} iterations, "
          f"{n_micro} micro-batches in {took:.1f}s incl. init; iterations "
          f"after the first: {tok_s:.1f} real tokens/s, mean step "
          f"{1e3 * sum(h['time_s'] for h in steady) / len(steady):.1f} ms; "
          f"peak memory {peak:.1f} GiB; planning overlap "
          f"{stats.overlap_fraction:.3f}; launches {counts} (expected "
          f"{expected})", flush=True)
    check(counts == expected, f"train launches {counts}, expected {expected}")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
              for h in hist), "non-finite loss or grad norm in training")

    # 2 layers: the grad step's leaves and a 2-iteration run, once with the
    # kernels and once with the plain versions patched in
    cfg2, stream2, cost2, pcfg2 = _train_setup(torch, 2)
    gb = stream2.batch(0)
    mbs = plan_iteration(gb.lengths[:, 0], cost2, pcfg2).replica_plans[0] \
        .micro_batches
    big = max(mbs, key=lambda m: m.mbs * m.seq)
    batch = {k: torch.as_tensor(v).cuda() for k, v in materialize_micro_batch(
        big, gb.tokens, lengths=gb.lengths).items()}
    params0 = MD.init_params(torch.Generator(device="cuda").manual_seed(1),
                             cfg2, device="cuda")
    step = build_grad_step(cfg2)

    def grad_step():       # the loss and the mean-loss gradient leaves
        ls, ws, g = step(params0, batch)
        return float(ls) / float(ws), [x.float() / float(ws) for x in leaves(g)]

    # the kernels' 2-iteration run twice: the trajectories must be equal to
    # the bit
    runs = {}
    for name in ("kernels", "plain", "kernels again"):
        patches = _plain_attention() if name == "plain" else ()
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            loss, g = grad_step() if name != "kernels again" else (None, None)
            p2, h2, _ = _train(torch, 2, 2, seed=1,
                               params=tree_map(lambda x: x.clone(), params0),
                               log_every=0)[4:]
            runs[name] = (loss, g, h2, p2)
    (lk, gk, hk, pk), (lp, gp, hp, _) = runs["kernels"], runs["plain"]
    _, _, hk2, pk2 = runs["kernels again"]
    same = _same_runs(torch, (pk, hk), (pk2, hk2))
    print(f"[train] 2 layers, two 2-iteration runs with the kernels from one "
          f"seed: losses {[h['loss'] for h in hk]} and "
          f"{[h['loss'] for h in hk2]}; losses, grad norms and all "
          f"{len(leaves(pk))} parameter leaves equal to the bit: "
          f"{'yes' if same else 'NO'}", flush=True)
    check(same, "two 2-layer, 2-iteration runs with the kernels from one "
          "seed differ")
    del pk, pk2, runs["kernels again"]

    def leaf_errs(gs):
        """Max |diff|, worst ||diff|| / ||plain|| over the leaves, and
        whether every element is within GRAD_TOL, against the plain run."""
        return _leaf_errs(torch, dict(enumerate(gs)), dict(enumerate(gp)))

    worst_leaf, worst_rel, ok = leaf_errs(gk)
    # planted faults, on the kernel's backward: a dq of zeros, and a
    # backward that drops each row's last live key tile
    real_backward = fa.mha_backward

    def planted(fault):
        def backward(*a, **o):
            dq, dk, dv = real_backward(*a, **o)
            if fault == "dq = 0":
                return torch.zeros_like(dq), dk, dv
            drop = _last_live_key_tile(torch, _live_pairs(
                torch, *a[3:7], o["causal"], o.get("window", 0)))
            return (dq, dk.masked_fill(drop[..., None, None], 0),
                    dv.masked_fill(drop[..., None, None], 0))
        return backward

    faults = {}
    for fault in ("dq = 0", "last live key tile dropped"):
        with mock.patch.object(fa, "mha_backward", planted(fault)):
            faults[fault] = leaf_errs(grad_step()[1])
    losses_k = [lk] + [h["loss"] for h in hk]
    losses_p = [lp] + [h["loss"] for h in hp]
    loss_err = max(abs(a - b) / max(1.0, abs(b))
                   for a, b in zip(losses_k, losses_p))
    print(f"[train] 2 layers, kernels vs plain attention on a micro-batch of "
          f"{big.mbs} x {big.seq}: loss {lk:.6f} vs {lp:.6f}; "
          f"{len(gk)} gradient leaves, max |diff| {worst_leaf:.3e}, worst "
          f"||diff|| / ||plain|| {worst_rel:.3e} (GRAD_TOL {GRAD_TOL_BF16}, "
          f"GRAD_REL_TOL {GRAD_REL_TOL}); 2-iteration losses "
          f"{[round(x, 6) for x in losses_k[1:]]} vs "
          f"{[round(x, 6) for x in losses_p[1:]]}, grad norms "
          f"{[round(h['grad_norm'], 6) for h in hk]} vs "
          f"{[round(h['grad_norm'], 6) for h in hp]}", flush=True)
    for fault, (f_abs, f_rel, f_ok) in faults.items():
        print(f"[train] planted fault ({fault}): max |diff| {f_abs:.3e}, worst "
              f"||diff|| / ||plain|| {f_rel:.3e}, elementwise GRAD_TOL "
              f"{'passes' if f_ok else 'fails'} it", flush=True)
    check(ok, "2-layer gradient leaves: kernels and plain disagree")
    check(worst_rel <= GRAD_REL_TOL, "2-layer gradient leaves: a leaf's "
          f"||diff|| / ||plain|| {worst_rel:.3e} exceeds {GRAD_REL_TOL}")
    check(faults["dq = 0"][1] > GRAD_REL_TOL, "the leaf check does not see "
          "a backward whose dq is zero")
    check(loss_err <= GRAD_TOL_BF16, "2-layer losses: kernels and plain "
          f"disagree ({loss_err:.3e})")
    gn_err = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                 for a, b in zip(hk, hp))
    check(gn_err <= GRAD_TOL_BF16, "2-layer grad norms: kernels and plain "
          f"disagree ({gn_err:.3e})")
    del params0, runs, gk, gp
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------------
# phase 5: the threaded stage pipeline, gpt-paper at full width
# ----------------------------------------------------------------------
def _plan_batches(plan, gb):
    from repro_torch.data.dataset import materialize_micro_batch
    return {m.mb_id: materialize_micro_batch(m, gb.tokens, lengths=gb.lengths)
            for m in plan.micro_batches}


def _executed(torch, backend, plan, params, batches):
    """One plan on ``backend``, and its host time ending in a device
    synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = backend.execute_plan(plan, params=params, batches=batches)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _mean_grads(res):
    """The gradient of the mean loss, leaf by leaf in fp32, by path."""
    from repro_torch.tree import flatten
    return {k: g.float() / res.weight_sum for k, g in flatten(res.grads)}


def _history_lines(tag, hist, split_of):
    for h in hist:
        print(f"[{tag}] iter {h['iter']}: {h['time_s'] * 1e3:.1f} ms, loss "
              f"{h['loss']:.4f}, grad norm {h['grad_norm']:.4f}, "
              f"{h['tokens']} real / {h['padded_tokens']} padded tokens "
              f"(padding efficiency {h['tokens'] / h['padded_tokens']:.3f}), "
              f"{h['tokens'] / h['time_s']:.1f} real tokens/s, micro-batches "
              f"{split_of(h['iter'])}", flush=True)
    steady = hist[1:]
    return (sum(h["tokens"] for h in steady) / sum(h["time_s"] for h in steady),
            sum(h["time_s"] for h in steady) / len(steady))


def phase_pipeline(torch):
    """gpt-paper at full width, 8 layers over 4 stages on the threaded
    executor: launch counts, the pipeline against the sequential steps on
    one plan, and two runs equal to the bit."""
    import numpy as np
    from repro_torch.core.planner import plan_iteration
    from repro_torch.dist.backend import ThreadsBackend
    from repro_torch.kernels import ops
    from repro_torch.models import model as MD

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cfg, stream, cost, pcfg, params, hist, stats = _train(
        torch, TRAIN_LAYERS, PIPE_ITERS, seed=0, n_stages=PIPE_STAGES)
    counts = ops.launch_counts()
    took = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params
    torch.cuda.empty_cache()
    tok_s, step_s = _history_lines("pipeline", hist, lambda it: [
        (m.mbs, m.seq) for m in plan_iteration(
            stream.batch(it).lengths[:, 0], cost, pcfg)
        .replica_plans[0].micro_batches])
    n_micro = sum(h["n_micro"] for h in hist)
    # per layer and micro-batch: the stage forward, the stage backward's
    # forward again, and the period checkpoint's recompute in it; one
    # backward
    expected = {"mha_forward": 3 * cfg.n_layers * n_micro,
                "mha_backward": cfg.n_layers * n_micro, "ssd_chunked": 0}
    print(f"[pipeline] {cfg.name} {cfg.n_layers} layers over {PIPE_STAGES} "
          f"stages ({cfg.n_params() / 1e9:.2f} B params), {len(hist)} "
          f"iterations, {n_micro} micro-batches in {took:.1f}s incl. init; "
          f"iterations after the first: {tok_s:.1f} real tokens/s, mean step "
          f"{1e3 * step_s:.1f} ms; peak memory {peak:.1f} GiB; planning "
          f"overlap {stats.overlap_fraction:.3f}; launches {counts} (expected "
          f"{expected}: 3 K1 and 1 backward per layer and micro-batch)",
          flush=True)
    check(counts == expected, f"pipeline launches {counts}, expected "
          f"{expected}")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
              for h in hist), "non-finite loss or grad norm in the pipeline")

    # one plan: the pipeline against the sequential grad steps
    gb = stream.batch(0)
    plan = plan_iteration(gb.lengths[:, 0], cost, pcfg).replica_plans[0]
    batches = _plan_batches(plan, gb)
    params = MD.init_params(torch.Generator(device="cuda").manual_seed(1), cfg,
                            device="cuda")
    pipe, seq = (ThreadsBackend(cfg, PIPE_STAGES, use_executor=on,
                                device="cuda") for on in (True, False))
    rp, pipe_s = _executed(torch, pipe, plan, params, batches)
    rs, seq_s = _executed(torch, seq, plan, params, batches)
    lp, ls = rp.loss_sum / rp.weight_sum, rs.loss_sum / rs.weight_sum
    gs = _mean_grads(rs)
    del rs
    g_abs, g_rel, _ = _leaf_errs(torch, _mean_grads(rp), gs)
    del rp, gs, params
    torch.cuda.empty_cache()
    print(f"[pipeline] one plan {[(m.mbs, m.seq) for m in plan.micro_batches]}"
          f": pipelined loss {lp:.8f} vs sequential {ls:.8f} (equal to the "
          f"bit: {'yes' if lp == ls else 'no'}); gradient leaves max |diff| "
          f"{g_abs:.3e}, worst ||diff|| / ||sequential|| {g_rel:.3e} "
          f"(GRAD_REL_TOL {GRAD_REL_TOL}); pipelined {1e3 * pipe_s:.1f} ms, "
          f"sequential {1e3 * seq_s:.1f} ms", flush=True)
    check(abs(lp - ls) <= 1e-4 * abs(ls), "pipelined and sequential mean "
          f"losses differ: {lp} vs {ls}")
    check(g_rel <= GRAD_REL_TOL, f"a pipelined gradient leaf's relative "
          f"error {g_rel:.3e} exceeds GRAD_REL_TOL")

    # two 2-iteration runs from one seed, one layer per stage
    runs = [_train(torch, PIPE_STAGES, 2, seed=1, log_every=0,
                   n_stages=PIPE_STAGES)[4:6] for _ in range(2)]
    same = _same_runs(torch, *runs)
    print(f"[pipeline] {PIPE_STAGES} layers, two 2-iteration runs from one "
          f"seed: losses {[h['loss'] for h in runs[0][1]]} and "
          f"{[h['loss'] for h in runs[1][1]]}; losses, grad norms and "
          f"parameters equal to the bit: {'yes' if same else 'NO'}",
          flush=True)
    check(same, "two pipelined runs from one seed differ")
    del runs
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------------
# phase 14: the mesh backend, gpt-paper at full width over a stage mesh
# ----------------------------------------------------------------------
def _stage_mesh():
    from repro_torch.launch.mesh import make_stage_mesh
    return make_stage_mesh(PIPE_STAGES, devices=["cuda:0"] * PIPE_STAGES)


def _mesh_train(torch, n_layers, iters, seed, log_every=1):
    """The plan-ahead runner on the mesh backend: the pipeline phase's
    configuration on a stage mesh that repeats the card. Returns (cfg,
    stream, cost, pcfg, params, history, stats, optimizer state)."""
    from repro_torch.train.runner import PlanAheadRunner, RunnerConfig
    cfg, stream, cost, pcfg = _train_setup(torch, n_layers, PIPE_STAGES)
    rcfg = RunnerConfig(n_iters=iters, backend="mesh", seed=seed,
                        log_every=log_every, device="cuda")
    runner = PlanAheadRunner(cfg, cost, pcfg, rcfg, stream,
                             mesh=_stage_mesh())
    params, history, stats = runner.run()
    check(stats.faults == 0, f"mesh training retried after {stats.faults} "
          f"faults: {stats.recoveries}")
    return cfg, stream, cost, pcfg, params, history, stats, runner.opt_state


def _zero_bytes(opt):
    """Bytes of ZeRO-1 chunks on each stage, and of leaves left whole."""
    from repro_torch.dist.sharding import ZeroShards
    from repro_torch.tree import leaves
    per_stage, whole = {}, 0
    for key in ("master", "m", "v"):
        for x in leaves(opt[key]):
            if isinstance(x, ZeroShards):
                for s, c in enumerate(x.chunks):
                    per_stage[s] = (per_stage.get(s, 0)
                                    + c.numel() * c.element_size())
            else:
                whole += x.numel() * x.element_size()
    return per_stage, whole


def phase_mesh(torch):
    """gpt-paper at full width, 8 layers over a 4-stage mesh on the card:
    launch counts, the mesh against the threads backend's sequential steps
    on one plan, the injection order, ZeRO-1's update, and two runs equal
    to the bit."""
    import dataclasses
    import numpy as np
    from repro_torch.core.planner import plan_iteration
    from repro_torch.dist.backend import MeshBackend, ThreadsBackend
    from repro_torch.dist.pipeline import injection_order
    from repro_torch.kernels import ops
    from repro_torch.models import model as MD
    from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                             init_opt_state)
    from repro_torch.tree import leaves, tree_map

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cfg, stream, cost, pcfg, params, hist, stats, opt = _mesh_train(
        torch, TRAIN_LAYERS, PIPE_ITERS, seed=0)
    counts = ops.launch_counts()
    took = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_stage, whole = _zero_bytes(opt)
    del params, opt
    torch.cuda.empty_cache()
    tok_s, step_s = _history_lines("mesh", hist, lambda it: [
        (m.mbs, m.seq) for m in plan_iteration(
            stream.batch(it).lengths[:, 0], cost, pcfg)
        .replica_plans[0].micro_batches])
    n_micro = sum(h["n_micro"] for h in hist)
    # as the pipeline phase: per layer and real micro-batch the stage
    # forward, the stage backward's forward again and the period
    # checkpoint's recompute in it, and one backward; the ring runs nothing
    # on its warm-up and drain ticks
    expected = {"mha_forward": 3 * cfg.n_layers * n_micro,
                "mha_backward": cfg.n_layers * n_micro, "ssd_chunked": 0}
    print(f"[mesh] {cfg.name} {cfg.n_layers} layers over a {PIPE_STAGES}-"
          f"stage mesh on cuda:0 ({cfg.n_params() / 1e9:.2f} B params), "
          f"{len(hist)} iterations, {n_micro} micro-batches in {took:.1f}s "
          f"incl. init; iterations after the first: {tok_s:.1f} real "
          f"tokens/s, mean step {1e3 * step_s:.1f} ms; peak memory "
          f"{peak:.1f} GiB; ZeRO-1 master, m and v per stage "
          f"{[round(per_stage[s] / 2**30, 3) for s in sorted(per_stage)]} "
          f"GiB, left whole {whole / 2**30:.3f} GiB; planning overlap "
          f"{stats.overlap_fraction:.3f}; launches {counts} (expected "
          f"{expected}: 3 K1 and 1 backward per layer and micro-batch)",
          flush=True)
    check(counts == expected, f"mesh launches {counts}, expected {expected}")
    check(len(per_stage) == PIPE_STAGES and whole == 0,
          f"ZeRO-1 left {whole} bytes whole, stages {sorted(per_stage)}")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
              for h in hist), "non-finite loss or grad norm on the mesh")

    # one plan: the mesh against the threads backend's sequential steps
    gb = stream.batch(0)
    plan = plan_iteration(gb.lengths[:, 0], cost, pcfg).replica_plans[0]
    batches = _plan_batches(plan, gb)
    params = MD.init_params(torch.Generator(device="cuda").manual_seed(1), cfg,
                            device="cuda")
    mesh = MeshBackend(cfg, PIPE_STAGES, mesh=_stage_mesh())
    seq = ThreadsBackend(cfg, PIPE_STAGES, use_executor=False, device="cuda")
    rm, mesh_s = _executed(torch, mesh, plan, params, batches)
    rs, seq_s = _executed(torch, seq, plan, params, batches)
    lm, ls = rm.loss_sum / rm.weight_sum, rs.loss_sum / rs.weight_sum
    gs = _mean_grads(rs)
    del rs
    g_abs, g_rel, _ = _leaf_errs(torch, _mean_grads(rm), gs)
    del gs
    torch.cuda.empty_cache()
    rev = list(reversed(injection_order(plan)))
    plan_r = dataclasses.replace(plan, meta=dict(plan.meta,
                                                 injection_order=rev))
    rr, _ = _executed(torch, mesh, plan_r, params, batches)
    same_order = rr.loss_sum == rm.loss_sum
    del rr
    print(f"[mesh] one plan {[(m.mbs, m.seq) for m in plan.micro_batches]}: "
          f"mesh loss {lm:.8f} vs sequential {ls:.8f} (equal to the bit: "
          f"{'yes' if lm == ls else 'no'}); gradient leaves max |diff| "
          f"{g_abs:.3e}, worst ||diff|| / ||sequential|| {g_rel:.3e} "
          f"(GRAD_REL_TOL {GRAD_REL_TOL}); injection order reversed: loss "
          f"equal to the bit: {'yes' if same_order else 'NO'}; mesh "
          f"{1e3 * mesh_s:.1f} ms, sequential {1e3 * seq_s:.1f} ms",
          flush=True)
    check(abs(lm - ls) <= 1e-4 * abs(ls), "mesh and sequential mean losses "
          f"differ: {lm} vs {ls}")
    check(g_rel <= GRAD_REL_TOL, f"a mesh gradient leaf's relative error "
          f"{g_rel:.3e} exceeds GRAD_REL_TOL")
    check(same_order, "the reversed injection order changed the mesh loss")

    # ZeRO-1: two optimizer steps on the placed state against adamw_update
    # on the whole state, from the plan's gradients
    ocfg = AdamWConfig(lr=3e-4)
    grads = rm.grads
    del rm
    opt = init_opt_state(params, ocfg)
    placed = mesh.place_opt_state(
        tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, opt))
    p_mesh = tree_map(torch.clone, params)
    t_ref = t_zero = 0.0
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt, _ = adamw_update(params, grads, opt, ocfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        p_mesh, placed, _ = mesh.optimizer_step(p_mesh, grads, placed, ocfg)
        torch.cuda.synchronize()
        t_ref += t2 - t1
        t_zero += time.perf_counter() - t2
    same = all(bool(torch.equal(a, b))
               for a, b in zip(leaves(params), leaves(p_mesh)))
    for key in ("master", "m", "v"):
        for a, b in zip(leaves(opt[key]), leaves(placed[key])):
            same &= all(bool(torch.equal(a.narrow(*b.bounds(s)), c))
                        for s, c in enumerate(b.chunks))
    print(f"[mesh] ZeRO-1 optimizer_step on the placed state against "
          f"adamw_update on the whole state, 2 steps: params, master, m and "
          f"v equal to the bit: {'yes' if same else 'NO'}; "
          f"{1e3 * t_zero / 2:.1f} ms a step placed, {1e3 * t_ref / 2:.1f} "
          f"ms whole", flush=True)
    check(same, "ZeRO-1's update differs from adamw_update")
    del params, p_mesh, grads, opt, placed, mesh, seq
    torch.cuda.empty_cache()

    # two 2-iteration runs from one seed, one layer per stage
    runs = [_mesh_train(torch, PIPE_STAGES, 2, seed=1, log_every=0)[4:6]
            for _ in range(2)]
    same = _same_runs(torch, *runs)
    print(f"[mesh] {PIPE_STAGES} layers, two 2-iteration runs from one seed: "
          f"losses {[h['loss'] for h in runs[0][1]]} and "
          f"{[h['loss'] for h in runs[1][1]]}; losses, grad norms and "
          f"parameters equal to the bit: {'yes' if same else 'NO'}",
          flush=True)
    check(same, "two mesh runs from one seed differ")
    del runs
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------------
# phase 6: t5-paper at full width on the encoder-decoder pipeline
# ----------------------------------------------------------------------
def _t5_setup(torch, n_layers):
    import dataclasses
    from repro_torch.configs.base import get_arch
    from repro_torch.core.cost_model import AnalyticCostModel
    from repro_torch.core.planner import PlannerConfig
    from repro_torch.core.shapes import ShapePalette
    from repro_torch.data.streams import MultiTaskStream, StreamConfig
    cfg = dataclasses.replace(get_arch("t5-paper"), n_layers=n_layers)
    pcfg = PlannerConfig(
        n_stages=T5_STAGES, d_model=cfg.d_model,
        palette=ShapePalette.build(**T5_PALETTE),
        device_mem=float(torch.cuda.get_device_properties(0).total_memory))
    return (cfg, MultiTaskStream(StreamConfig(**T5_STREAM)),
            AnalyticCostModel(cfg, n_stages=T5_STAGES), pcfg)


def _t5_train(torch, n_layers, iters, seed, log_every=1):
    from repro_torch.train.runner import PlanAheadRunner, RunnerConfig
    cfg, stream, cost, pcfg = _t5_setup(torch, n_layers)
    rcfg = RunnerConfig(n_iters=iters, seed=seed, log_every=log_every,
                        device="cuda")
    params, history, stats = PlanAheadRunner(cfg, cost, pcfg, rcfg,
                                             stream).run()
    check(stats.faults == 0, f"t5 training retried after {stats.faults} "
          f"faults: {stats.recoveries}")
    return cfg, stream, cost, pcfg, params, history, stats


def phase_t5(torch):
    """t5-paper at full width, 4 + 4 layers over 2 encoder and 2 decoder
    stages: launch counts, then at 2 + 2 layers the kernels against the
    plain attention through the pipeline, and two runs equal to the bit."""
    import dataclasses
    import numpy as np
    from repro_torch.core.planner import plan_iteration
    from repro_torch.dist.backend import ThreadsBackend
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves, tree_map

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cfg, stream, cost, pcfg, params, hist, stats = _t5_train(
        torch, T5_LAYERS, T5_ITERS, seed=0)
    counts = ops.launch_counts()
    took = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(x.numel() for x in leaves(params))
    del params
    torch.cuda.empty_cache()
    tok_s, step_s = _history_lines("t5", hist, lambda it: [
        (m.mbs, *m.seq) for m in plan_iteration(
            stream.batch(it).lengths, cost, pcfg)
        .replica_plans[0].micro_batches])
    n_micro = sum(h["n_micro"] for h in hist)
    # 3 K1 and 1 backward per attention per micro-batch (the stage forward,
    # its forward again in the stage backward, the period checkpoint's
    # recompute): one attention per encoder layer, two per decoder layer
    attn = cfg.n_layers + 2 * cfg.n_layers
    expected = {"mha_forward": 3 * attn * n_micro,
                "mha_backward": attn * n_micro, "ssd_chunked": 0}
    real = sum(h["tokens"] for h in hist)
    padded = sum(h["padded_tokens"] for h in hist)
    print(f"[t5] {cfg.name} {cfg.n_layers} + {cfg.n_layers} layers d_model "
          f"{cfg.d_model} {cfg.n_heads} heads x {cfg.d_head} d_ff {cfg.d_ff} "
          f"({n_params / 1e9:.2f} B params) over {T5_STAGES} stages, "
          f"{len(hist)} iterations, {n_micro} micro-batches in {took:.1f}s "
          f"incl. init; iterations after the first: {tok_s:.1f} real "
          f"tokens/s, mean step {1e3 * step_s:.1f} ms; padding efficiency "
          f"{real / padded:.3f}; peak memory {peak:.1f} GiB; launches "
          f"{counts} (expected {expected})", flush=True)
    check(counts == expected, f"t5 launches {counts}, expected {expected}")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
              for h in hist), "non-finite loss or grad norm in t5 training")

    # 2 + 2 layers: one plan through the pipeline, with the kernels, with
    # the plain versions patched in, with a backward planted to return a
    # zero dq, and in f32 (plain versions, params cast): T5's bf16
    # gradients of either attention lie about 3% from the f32 ones on
    # some leaves (the decoder's first wq and wk), as far from each other,
    # so each leaf is held by how much farther the kernels' gradient lies
    # from the f32 one than the plain version's
    cfg2, stream2, cost2, pcfg2 = _t5_setup(torch, 2)
    gb = stream2.batch(0)
    plan = plan_iteration(gb.lengths, cost2, pcfg2).replica_plans[0]
    batches = _plan_batches(plan, gb)
    params0 = T.init_encdec(torch.Generator(device="cuda").manual_seed(1),
                            cfg2, device="cuda")
    real_backward = fa.mha_backward

    def zero_dq(*a, **o):
        dq, dk, dv = real_backward(*a, **o)
        return torch.zeros_like(dq), dk, dv

    out = {}
    for name in ("kernels", "plain", "dq = 0", "f32"):
        patches = (_plain_attention() if name in ("plain", "f32") else
                   (mock.patch.object(fa, "mha_backward", zero_dq),)
                   if name == "dq = 0" else ())
        cfg_r, params_r = cfg2, params0
        if name == "f32":
            cfg_r = dataclasses.replace(cfg2, dtype="float32")
            params_r = tree_map(lambda x: x.float(), params0)
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            res = _executed(torch, ThreadsBackend(cfg_r, T5_STAGES,
                                                  device="cuda"),
                            plan, params_r, batches)[0]
        out[name] = (res.loss_sum / res.weight_sum, _mean_grads(res))
        del res, params_r
    (lk, gk), (lp, gp), (_, gf), (l32, g32) = (
        out[name] for name in ("kernels", "plain", "dq = 0", "f32"))
    enc_max = max(float(g.abs().max()) for k, g in gk.items()
                  if k[0] == "enc")
    k_abs, k_rel, k_ok = _leaf_errs(torch, gk, gp)
    f_abs, f_rel, f_ok = _leaf_errs(torch, gf, gp)

    def from_f32(gs):
        """||gs - f32|| / ||f32|| by leaf."""
        return {k: float(torch.linalg.vector_norm(gs[k] - b)
                         / torch.linalg.vector_norm(b))
                for k, b in g32.items()}
    k32, p32, f32 = from_f32(gk), from_f32(gp), from_f32(gf)
    # the worst distance from f32 beyond the plain version's, over leaves
    k_exc = max(k32[k] - p32[k] for k in g32)
    f_exc = max(f32[k] - p32[k] for k in g32)
    print(f"[t5] 2 + 2 layers over {T5_STAGES} stages, one plan "
          f"{[(m.mbs, *m.seq) for m in plan.micro_batches]}: loss kernels "
          f"{lk:.6f}, plain {lp:.6f}, f32 {l32:.6f}; {len(gk)} gradient "
          f"leaves, kernels vs plain: max |diff| {k_abs:.3e} (GRAD_TOL "
          f"{GRAD_TOL_BF16}), worst ||diff|| / ||plain|| {k_rel:.3e}; worst "
          f"||out - f32|| / ||f32|| kernels {max(k32.values()):.3e}, plain "
          f"{max(p32.values()):.3e}; worst distance from f32 beyond the "
          f"plain version's {k_exc:.3e} "
          f"(GRAD_REL_TOL {GRAD_REL_TOL}); largest encoder gradient "
          f"{enc_max:.3e}; planted fault (dq = 0): max |diff| {f_abs:.3e}, "
          f"worst ||diff|| / ||plain|| {f_rel:.3e}, beyond the plain "
          f"version's distance from f32 {f_exc:.3e}, elementwise GRAD_TOL "
          f"{'passes' if f_ok else 'fails'} it", flush=True)
    check(k_ok, "t5 gradient leaves: kernels and plain disagree elementwise")
    check(k_exc <= GRAD_REL_TOL, "t5 gradient leaves: the kernels' lie "
          f"{k_exc:.3e} farther from f32 than the plain version's")
    check(f_exc > GRAD_REL_TOL, "the t5 leaf check does not see a backward "
          "whose dq is zero")
    check(abs(lk - lp) <= GRAD_TOL_BF16 * max(1.0, abs(lp)),
          f"t5 losses: kernels and plain disagree ({lk} vs {lp})")
    check(enc_max > 0, "no gradient reached the encoder")
    del out, gk, gp, gf, g32, params0
    torch.cuda.empty_cache()

    # two 2-iteration runs from one seed at 2 + 2 layers
    runs = [_t5_train(torch, 2, 2, seed=1, log_every=0)[4:6]
            for _ in range(2)]
    same = _same_runs(torch, *runs)
    print(f"[t5] 2 + 2 layers, two 2-iteration runs from one seed: losses "
          f"{[h['loss'] for h in runs[0][1]]} and "
          f"{[h['loss'] for h in runs[1][1]]}; losses, grad norms and "
          f"parameters equal to the bit: {'yes' if same else 'NO'}",
          flush=True)
    check(same, "two t5 runs from one seed differ")
    del runs
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------------
# phase 7: serve mamba2-130m at full width and depth
# ----------------------------------------------------------------------
def phase_mamba(torch, requests, max_prompt, decode_steps):
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as SSD
    import numpy as np
    from repro_torch.serve import report

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cfg, tokens, res = _serve(torch, MAMBA_LAYERS, n_requests=requests,
                              max_prompt=max_prompt,
                              decode_steps=decode_steps, seed=0,
                              arch="mamba2-130m", tag="mamba")
    counts = ops.launch_counts()
    took = time.perf_counter() - t0
    lens = np.array([len(t) for t in tokens])
    for line in report(res, lens).splitlines():
        print(f"[mamba] {line}")
    nb = len(res.batches)
    expected = {"mha_forward": 0, "mha_backward": 0,
                "ssd_chunked": cfg.n_layers * nb}
    print(f"[mamba] {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"d_inner {cfg.d_inner} {cfg.ssm_heads} SSD heads x "
          f"{cfg.ssm_headdim}, d_state {cfg.ssm_state} "
          f"({cfg.n_params() / 1e6:.1f} M params), {len(tokens)} requests, "
          f"{decode_steps} decode steps in {took:.1f}s incl. init; launches "
          f"{counts} (expected {expected}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    check(counts == expected, f"mamba serve launches {counts}, expected "
          f"{expected}")
    check(all(bool(torch.isfinite(x).all()) for x in res.logits),
          "non-finite logits in the mamba serve")
    del res
    torch.cuda.empty_cache()

    # the same serve, 2 layers, once with K4 and once with the plain SSD
    kw = dict(n_requests=requests, max_prompt=max_prompt,
              decode_steps=decode_steps, seed=1, arch="mamba2-130m",
              tag="mamba")
    _, _, with_k4 = _serve(torch, 2, **kw)
    with mock.patch.object(SSD, "_ssd_cuda", ref.ssd_ref_chunked):
        _, _, with_plain = _serve(torch, 2, **kw)
    err, compared = _compare_serves(torch, with_k4, with_plain, TOL_BF16)
    print(f"[mamba] 2 layers, K4 vs plain SSD: max |logit diff| / "
          f"(1 + max|logit|) {err:.3e} over {compared} (row, step) logit "
          f"vectors (tol {TOL_BF16})", flush=True)
    check(err <= TOL_BF16, "2-layer mamba serve logits: K4 and plain disagree")
    return counts


# ----------------------------------------------------------------------
# phase 8: the fault-tolerant training loop, gpt-paper at full width
# ----------------------------------------------------------------------
def _fault_run(torch, chaos=None, ckpt_dir="", ckpt_every=0):
    """The runner on the fault configuration, with a straggler monitor on
    a logical clock (one replica: its factors leave the plans alone):
    returns (cfg, params, the optimizer state, history, stats, monitor)."""
    from repro_torch.dist.chaos import LogicalClock
    from repro_torch.dist.fault import StragglerMonitor
    from repro_torch.train.runner import PlanAheadRunner, RunnerConfig
    cfg, stream, cost, pcfg = _train_setup(torch, FAULT_LAYERS, FAULT_STAGES)
    rcfg = RunnerConfig(n_iters=FAULT_ITERS, seed=0, log_every=0,
                        device="cuda", strict_verify=True,
                        ckpt_dir=str(ckpt_dir), ckpt_every=ckpt_every,
                        plan_timeout=FAULT_PLAN_TIMEOUT, retry_backoff_s=0.01)
    monitor = StragglerMonitor(1, heartbeat_timeout=2.0,
                               window=2 * FAULT_ITERS, clock=LogicalClock())
    runner = PlanAheadRunner(cfg, cost, pcfg, rcfg, stream, chaos=chaos,
                             monitor=monitor)
    params, history, stats = runner.run()
    return cfg, params, runner.opt_state, history, stats, monitor


def _flip_a_byte(path: Path) -> None:
    """The planted fault: one data byte of a leaf file inverted."""
    at = path.stat().st_size // 2
    with open(path, "r+b") as fh:
        fh.seek(at)
        b = fh.read(1)
        fh.seek(at)
        fh.write(bytes([b[0] ^ 0xFF]))


def phase_fault(torch, card):
    """gpt-paper at full width, 2 layers over 2 stages with strict plan
    verification: run A fault-free, run B under a planner loss, a
    straggler, a state-losing crash restored from step 3 and a crash
    retried in memory, both 6 iterations from one seed. B must end equal
    to A to the bit (last-occurrence losses and grad norms, every
    parameter, master, m and v, the step); its newest checkpoint must
    reload equal to B's state; a byte flipped in it must be refused, with
    the fallback to the step before. Disk: each save writes 11.4 GB (14
    bytes a parameter), up to two steps are kept (22.8 GB), and the phase
    moves about 60 GB in all (2 saves, the restore, the reload check, the
    corrupt load and its fallback, each load reading its step twice: its
    checksums, then its copy)."""
    import shutil
    import warnings
    from repro_torch.dist import backend as BK
    from repro_torch.dist.chaos import FaultEvent, FaultKind, FaultSchedule
    from repro_torch.kernels import ops
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.tree import flatten, tree_map

    on = f"({card})"
    ckpt_dir = ROOT / "build" / "fault_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    try:
        cfg, _, _, _ = _train_setup(torch, FAULT_LAYERS, FAULT_STAGES)
        est = 14 * cfg.n_params()
        free = shutil.disk_usage(ckpt_dir).free
        print(f"[fault] {cfg.name} {cfg.n_layers} layers over {FAULT_STAGES} "
              f"stages ({cfg.n_params() / 1e9:.3f} B params): a checkpoint "
              f"holds about {est / 1e9:.1f} GB; free disk under build/ "
              f"before the phase {free / 1e9:.1f} GB {on}", flush=True)
        check(free > 2.1 * est, f"the fault phase needs about "
              f"{2.1 * est / 1e9:.1f} GB of disk under build/ (two steps "
              f"kept), {free / 1e9:.1f} GB free")

        verify_s: list = []
        real_reject = BK.reject_bad_plan

        def timed_reject(plan, where):
            t0 = time.perf_counter()
            try:
                real_reject(plan, where)
            finally:
                verify_s.append(time.perf_counter() - t0)

        runs = {}
        chaos = FaultSchedule([
            FaultEvent(1, FaultKind.PLANNER_LOST),
            FaultEvent(2, FaultKind.STRAGGLER, stage=1, delay_s=0.2),
            FaultEvent(4, FaultKind.STAGE_CRASH, stage=1, op="B",
                       state_lost=True),
            FaultEvent(5, FaultKind.STAGE_CRASH, stage=0, op="F")])
        for name in ("A", "B"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            verify_s.clear()
            t0 = time.perf_counter()
            with mock.patch.object(BK, "reject_bad_plan", timed_reject):
                _, params, opt, hist, stats, mon = _fault_run(
                    torch, **(dict(chaos=chaos, ckpt_dir=ckpt_dir,
                                   ckpt_every=FAULT_CKPT_EVERY)
                              if name == "B" else {}))
            runs[name] = dict(
                hist=hist, stats=stats, counts=ops.launch_counts(),
                took=time.perf_counter() - t0, verify=list(verify_s),
                peak=torch.cuda.max_memory_allocated() / 2**30,
                replica_s=mon.mean_iter_time(0))
            if name == "A":
                # A's final state to the host: B runs alone on the card
                state_a = {p: x.cpu() if isinstance(x, torch.Tensor) else x
                           for p, x in flatten({"params": params,
                                                "opt": opt})}
                del params, opt
            else:
                state_b = {"params": params, "opt": opt}
        a, b = runs["A"], runs["B"]
        for name, r in runs.items():
            _history_lines(f"fault {name}", r["hist"],
                           lambda it, h=r["hist"]: next(
                               x["n_micro"] for x in h if x["iter"] == it))
            v = r["verify"]
            print(f"[fault] run {name}: {len(r['hist'])} logged iterations "
                  f"in {r['took']:.1f}s incl. init; strict verification "
                  f"of {len(v)} plans (one an iteration attempt), "
                  f"{1e3 * sum(v) / max(1, len(v)):.2f} ms a plan "
                  f"({1e3 * max(v, default=0):.2f} ms at most); "
                  f"peak memory {r['peak']:.1f} GiB; launches {r['counts']} "
                  f"{on}", flush=True)
            # the monitor's replica times end on a device synchronise: the
            # pipeline's join alone would stop the clock at enqueue time
            it_s = sum(h["time_s"] for h in r["hist"]) / len(r["hist"])
            print(f"[fault] run {name}: the straggler monitor's replica time "
                  f"{r['replica_s']:.4f}s an iteration (closed on a device "
                  f"synchronise), the whole iteration {it_s:.4f}s {on}",
                  flush=True)
            check(r["replica_s"] and 0 < r["replica_s"] <= it_s * 1.5,
                  f"run {name}: monitor replica time {r['replica_s']}")

        # what B recovered from
        sb = b["stats"]
        kinds = [(x["kind"], x["iter"], x.get("restored_step"))
                 for x in sb.recoveries]
        print(f"[fault] B: {sb.faults} faults, recoveries {kinds}, "
              f"recovery_s {sb.recovery_s:.3f} {on}", flush=True)
        check(not chaos.pending(), f"faults never fired: {chaos.pending()}")
        for want in (("planner_resubmit", 1, None),
                     ("checkpoint_restore", 4, FAULT_CKPT_EVERY),
                     ("retry", 5, None)):
            check(want in kinds, f"B's recoveries {kinds} lack {want}")
        for c in sb.checkpoints:
            gb = c["bytes"] / 1e9
            if c["kind"] == "save":
                total = c["sync_s"] + c["d2h_s"] + c["crc_s"] + c["write_s"]
                print(f"[fault] save of step {c['step']}: {gb:.3f} GB in "
                      f"{total:.2f}s ({gb / total:.2f} GB/s): device "
                      f"synchronise {c['sync_s']:.3f}s, device to host "
                      f"{c['d2h_s']:.2f}s, CRC {c['crc_s']:.2f}s, write "
                      f"{c['write_s']:.2f}s {on}", flush=True)
            else:
                print(f"[fault] restore of step {c['step']} in place on the "
                      f"card: {gb:.3f} GB in {c['load_s']:.2f}s "
                      f"({gb / c['load_s']:.2f} GB/s, checksums first) {on}",
                      flush=True)

        # B against A, to the bit
        last_a = {h["iter"]: (h["loss"], h["grad_norm"]) for h in a["hist"]}
        last_b = {h["iter"]: (h["loss"], h["grad_norm"]) for h in b["hist"]}
        flat_b = dict(flatten(state_b))
        same_state = sorted(flat_b) == sorted(state_a) and all(
            bool(torch.equal(x.cpu(), state_a[p]))
            if isinstance(x, torch.Tensor) else x == state_a[p]
            for p, x in flat_b.items())
        print(f"[fault] B's iterations {[h['iter'] for h in b['hist']]}; "
              f"last-occurrence losses and grad norms equal to A's to the "
              f"bit: {'yes' if last_a == last_b else 'NO'}; every parameter, "
              f"master, m and v leaf ({len(flat_b) - 1}) and the step "
              f"({flat_b[('opt', 'step')]}) equal to A's: "
              f"{'yes' if same_state else 'NO'}", flush=True)
        check(last_a == last_b, "B's trajectory differs from A's: "
              f"{last_b} vs {last_a}")
        check(same_state, "B's final state differs from A's")
        del state_a
        n_a = sum(h["n_micro"] for h in a["hist"])
        expected = {"mha_forward": 3 * cfg.n_layers * n_a,
                    "mha_backward": cfg.n_layers * n_a, "ssd_chunked": 0}
        check(a["counts"] == expected, f"A's launches {a['counts']}, "
              f"expected {expected}")
        # B launches at least A's and the replayed iteration 3's
        n3 = next(h["n_micro"] for h in a["hist"] if h["iter"] == 3)
        for k, x in expected.items():
            check(b["counts"][k] >= x + x // n_a * n3,
                  f"B's {k} launches {b['counts'][k]}: fewer than A's {x} "
                  "and the replay's")

        # the newest checkpoint reloads, in place into tensors on the card,
        # equal to B's state; then a planted corrupt byte is refused
        like = tree_map(lambda x: torch.empty_like(x)
                        if isinstance(x, torch.Tensor) else 0, state_b)
        timings: dict = {}
        got, manifest = CKPT.load(ckpt_dir, like, timings=timings)
        gb = timings["bytes"] / 1e9
        same_ckpt = all(bool(torch.equal(x, flat_b[p]))
                        if isinstance(x, torch.Tensor) else x == flat_b[p]
                        for p, x in flatten(got))
        print(f"[fault] reload of step {manifest['step']} (CRCs verified): "
              f"{gb:.3f} GB in {timings['load_s']:.2f}s "
              f"({gb / timings['load_s']:.2f} GB/s); equal to B's final "
              f"state to the bit: {'yes' if same_ckpt else 'NO'} {on}",
              flush=True)
        check(manifest["step"] == FAULT_ITERS and same_ckpt,
              "the newest checkpoint does not hold B's final state")
        leaf = sorted(manifest["leaves"])[-1]
        step_dir = ckpt_dir / f"step_{manifest['step']:08d}"
        _flip_a_byte(step_dir / manifest["leaves"][leaf]["file"])
        try:
            CKPT.load(ckpt_dir, like)
            refused = "no"
        except CKPT.CheckpointCorruptError as e:
            refused = str(e).split(": ", 1)[-1]
        untouched = all(bool(torch.equal(x, flat_b[p]))
                        if isinstance(x, torch.Tensor) else True
                        for p, x in flatten(like))
        timings = {}
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            _, fallback = CKPT.load_latest_valid(ckpt_dir, like, timings)
        print(f"[fault] planted fault, one byte of {leaf} flipped in step "
              f"{manifest['step']}: load refuses it ({refused}); the live "
              f"tree untouched: {'yes' if untouched else 'NO'}; "
              f"load_latest_valid falls back to step {fallback['step']} in "
              f"{timings['load_s']:.2f}s {on}", flush=True)
        check(refused != "no", "a flipped byte in a leaf was not detected")
        check(untouched, "a refused load changed the live tree")
        check(fallback["step"] == FAULT_CKPT_EVERY, "load_latest_valid did "
              f"not fall back to step {FAULT_CKPT_EVERY}")
        del like, got, state_b, flat_b
        torch.cuda.empty_cache()
        return b["counts"]
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


# ----------------------------------------------------------------------
# phase 9: the process fault domain, two replica processes on the card
# ----------------------------------------------------------------------
def _cluster_setup(torch, dp_size, n_iters, ckpt_dir, fault_domain,
                   ckpt_every=CLUSTER_CKPT_EVERY):
    """The cluster phase's configuration: (cfg, stream, cost, pcfg, rcfg).
    The drift tolerance is out of reach: two processes on one card drift,
    and measured speed factors would re-shape plans the in-process oracle
    does not see."""
    import dataclasses
    from repro_torch.train.runner import RunnerConfig
    cfg, stream, cost, pcfg = _train_setup(torch, FAULT_LAYERS, 1)
    pcfg = dataclasses.replace(pcfg, dp_size=dp_size)
    rcfg = RunnerConfig(n_iters=n_iters, use_executor=False, seed=0,
                        log_every=0, device="cuda", ckpt_dir=str(ckpt_dir),
                        ckpt_every=ckpt_every, drift_tolerance=1e9,
                        fault_domain=fault_domain)
    return cfg, stream, cost, pcfg, rcfg


def _last_lines(hist) -> dict:
    """iter -> its last logged line (a replay logs an iteration again)."""
    return {h["iter"]: h for h in hist}


def _host_params(torch, params):
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.cpu(), params)


def phase_cluster(torch, card):
    """gpt-paper at full width, 2 layers, two replica processes sharing
    the card (one CUDA context each, gradients over localhost TCP):
    run A fault-free, run B with its coordinator SIGKILLed at iteration
    2. A must equal the in-process runner (dp 2) to the bit; B must elect
    a new coordinator, restore, and equal the in-process runner on its
    plans (dp 2 up to its restored step, then dp 1 from that step's
    checkpoint) to the bit. Prints each run's time and real tokens/s,
    the gradients' trip over the wire, the time to recover, each worker's
    peak memory and the workers' launches, which it returns."""
    import shutil
    from repro_torch.dist import cluster as CL
    from repro_torch.dist.chaos import FaultEvent, FaultKind, FaultSchedule
    from repro_torch.kernels import ops
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train.runner import PlanAheadRunner
    from repro_torch.tree import flatten

    on = f"({card})"
    t_phase = time.perf_counter()
    root = ROOT / "build" / "cluster"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        cfg, _, _, _, _ = _cluster_setup(torch, 2, 1, "", "thread")
        est = 14 * cfg.n_params()
        free = shutil.disk_usage(root).free
        print(f"[cluster] {cfg.name} {cfg.n_layers} layers "
              f"({cfg.n_params() / 1e9:.3f} B params), {CLUSTER_REPLICAS} "
              f"replica processes on one card, {CLUSTER_ITERS} iterations, a "
              f"checkpoint every {CLUSTER_CKPT_EVERY} (about {est / 1e9:.1f} "
              f"GB each; free disk under build/ {free / 1e9:.1f} GB); "
              f"ClusterConfig {CLUSTER_TIMEOUTS} {on}", flush=True)
        check(free > 2.1 * est, f"the cluster phase needs about "
              f"{2.1 * est / 1e9:.1f} GB of disk under build/ (two steps "
              f"kept), {free / 1e9:.1f} GB free")

        runs = {}
        chaos = FaultSchedule([FaultEvent(CLUSTER_KILL_AT,
                                          FaultKind.KILL_PROCESS,
                                          target="coordinator")])
        for name in ("A", "B"):
            rundir = root / name
            cfg, stream, cost, pcfg, rcfg = _cluster_setup(
                torch, CLUSTER_REPLICAS, CLUSTER_ITERS, rundir / "ckpt",
                "process")
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            params, hist, stats = CL.run_process_cluster(
                cfg, cost, pcfg, rcfg, stream,
                chaos=chaos if name == "B" else None,
                ccfg=CL.ClusterConfig(n_replicas=CLUSTER_REPLICAS,
                                      rundir=str(rundir), **CLUSTER_TIMEOUTS))
            took = time.perf_counter() - t0
            events = CL._read_jsonl(rundir / CL.EVENTS_FILE)
            cl = stats.cluster
            check(cl["completed"], f"run {name} did not complete: "
                  + CL._tail_logs(rundir, CLUSTER_REPLICAS))
            check(params is not None, f"run {name} left no checkpoint")
            runs[name] = dict(params=_host_params(torch, params), hist=hist,
                              cl=cl, events=events, took=took)
            del params
            shutil.rmtree(rundir, ignore_errors=True)
            check(not cl["orphans"] and not cl["tmp_dirs_left"],
                  f"run {name}: orphans {cl['orphans']}, tmp dirs "
                  f"{cl['tmp_dirs_left']}")

        # the in-process oracle, after the workers exited: dp 2 over the
        # same plans, its checkpoint at step 2
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        cfg, stream, cost, pcfg, rcfg = _cluster_setup(
            torch, CLUSTER_REPLICAS, CLUSTER_ITERS, root / "oracle",
            "thread")
        t0 = time.perf_counter()
        params, ohist, ostats = PlanAheadRunner(cfg, cost, pcfg, rcfg,
                                                stream).run()
        otook = time.perf_counter() - t0
        ocounts = ops.launch_counts()
        oparams = _host_params(torch, params)
        del params

        def same(params_a, params_b):
            return all(bool(torch.equal(x, y)) for (_, x), (_, y) in zip(
                flatten(params_a), flatten(params_b)))

        def loss_norms(hist):
            return {i: (h["loss"], h["grad_norm"])
                    for i, h in _last_lines(hist).items()}

        def steady(hist, exclude_save):
            lines = [h for i, h in sorted(_last_lines(hist).items()) if i]
            secs = sum(h["time_s"] - (h.get("save_s", 0.0)
                                      if exclude_save else 0.0)
                       for h in lines)
            return sum(h["tokens"] for h in lines) / secs

        a, b = runs["A"], runs["B"]
        for name, r in runs.items():
            for i, h in sorted(_last_lines(r["hist"]).items()):
                w = h["wire"]
                print(f"[cluster] {name} iter {i} (epoch {h['epoch']}, dp "
                      f"{h['dp_size']}): {h['time_s']:.3f}s (save "
                      f"{h['save_s']:.3f}s), loss {h['loss']:.4f}, grad norm "
                      f"{h['grad_norm']:.4f}, {h['n_micro']} micro-batches; "
                      f"wire: {w['bytes'] / 1e9:.3f} GB of replica "
                      f"gradients, device to host into the frame "
                      f"{w['to_bytes_s']:.3f}s, socket {w['socket_s']:.3f}s, "
                      f"decode and merge {w['merge_s']:.3f}s, broadcast of "
                      f"{w['bcast_bytes'] / 1e9:.3f} GB {w['bcast_s']:.3f}s, "
                      f"host to device {w['h2d_s']:.3f}s {on}", flush=True)
            peaks = {rk: wk["peak_bytes"] / 2**30
                     for rk, wk in r["cl"]["workers"].items()}
            print(f"[cluster] run {name}: {r['took']:.1f}s wall (spawn, "
                  f"init, {len(r['hist'])} logged iterations, saves and the "
                  f"final load); real tokens/s after the first iteration "
                  f"{steady(r['hist'], False):.1f} with the saves, "
                  f"{steady(r['hist'], True):.1f} without; workers' peak "
                  f"memory {', '.join(f'rank {k} {v:.1f} GiB' for k, v in sorted(peaks.items()))}; "
                  f"workers' launches {r['cl']['launches']} {on}",
                  flush=True)
        print(f"[cluster] in-process runner (dp 2, one process): {otook:.1f}s "
              f"wall; real tokens/s after the first iteration "
              f"{steady(ohist, False):.1f}; launches {ocounts} {on}",
              flush=True)

        # A against the in-process runner, to the bit
        check([e["kind"] for e in a["events"] if e["kind"] in (
            "membership", "replica_lost", "election")] ==
            ["election", "membership"],
            f"run A changed membership after the bootstrap: {a['events']}")
        same_a = (loss_norms(a["hist"]) == loss_norms(ohist)
                  and same(a["params"], oparams))
        n_a = sum(h["n_micro"] for h in _last_lines(a["hist"]).values())
        expected = {"mha_forward": 2 * cfg.n_layers * n_a,
                    "mha_backward": cfg.n_layers * n_a, "ssd_chunked": 0}
        print(f"[cluster] A against the in-process runner: losses, grad "
              f"norms and every parameter equal to the bit: "
              f"{'yes' if same_a else 'NO'}; workers' launches "
              f"{a['cl']['launches']}, expected {expected}", flush=True)
        check(same_a, "run A differs from the in-process runner: "
              f"{loss_norms(a['hist'])} vs {loss_norms(ohist)}")
        check(a["cl"]["launches"] == expected == ocounts,
              f"run A's workers launched {a['cl']['launches']}, the "
              f"in-process runner {ocounts}, expected {expected}")

        # B: the kill, the election, the restore, and its oracle
        cl = b["cl"]
        check(not chaos.pending(), f"the kill never fired: {chaos.pending()}")
        kill = cl["kills"][0] if cl["kills"] else {}
        check(len(cl["kills"]) == 1 and kill["verified_dead"],
              f"run B's kill left no verified dead pid: {cl['kills']}")
        check(cl["elections"] >= 1 and cl["final_alive"] == [1],
              f"run B: elections {cl['elections']}, final alive "
              f"{cl['final_alive']}")
        resume = [e["resume"] for e in b["events"]
                  if e["kind"] == "restore" and e["epoch"] > 0]
        last_b = _last_lines(b["hist"])
        k = min((i for i, h in last_b.items() if h["dp_size"] == 1),
                default=CLUSTER_ITERS)
        first = min((h for h in b["hist"] if h["t"] > kill["t"]),
                    key=lambda h: h["t"])
        print(f"[cluster] B: coordinator pid {kill['pid']} killed at "
              f"iteration {kill['at_iteration']}, verified dead; "
              f"{cl['elections']} election(s), restored step {resume}, "
              f"final alive {cl['final_alive']}; from the kill to the new "
              f"epoch's first history line {first['t'] - kill['t']:.2f}s, "
              f"the line's own save {first['save_s']:.2f}s of it {on}",
              flush=True)
        check(resume and resume[-1] == k, f"run B restored {resume} but "
              f"turned to dp 1 at iteration {k}")
        check(k == 0 or k in CKPT.all_steps(root / "oracle"),
              f"no in-process checkpoint at step {k}")
        for step in CKPT.all_steps(root / "oracle"):
            if step > k:
                shutil.rmtree(root / "oracle" / f"step_{step:08d}")
        ops.reset_launch_counts()
        cfg, stream, cost, pcfg, rcfg = _cluster_setup(
            torch, 1, CLUSTER_ITERS - k, root / "oracle" if k else "",
            "thread", ckpt_every=0)
        params, ohist1, _ = PlanAheadRunner(cfg, cost, pcfg, rcfg,
                                            stream).run()
        oparams_b = _host_params(torch, params)
        del params
        want = {i: v for i, v in loss_norms(ohist).items() if i < k}
        want.update(loss_norms(ohist1))
        same_b = (loss_norms(b["hist"]) == want
                  and same(b["params"], oparams_b))
        n_b = sum(h["n_micro"] for h in last_b.values())
        print(f"[cluster] B against the in-process runner (dp 2 to step "
              f"{k}, then dp 1 from its checkpoint): losses, grad norms and "
              f"every parameter equal to the bit: "
              f"{'yes' if same_b else 'NO'}; workers' launches "
              f"{cl['launches']} (at least {2 * cfg.n_layers * n_b} K1 and "
              f"{cfg.n_layers * n_b} backward)", flush=True)
        check(same_b, "run B differs from its in-process oracle: "
              f"{loss_norms(b['hist'])} vs {want}")
        check(cl["launches"]["mha_forward"] >= 2 * cfg.n_layers * n_b
              and cl["launches"]["mha_backward"] >= cfg.n_layers * n_b,
              f"run B's workers launched {cl['launches']}")
        counts = {key: a["cl"]["launches"][key] + cl["launches"][key]
                  for key in a["cl"]["launches"]}
        print(f"[cluster] phase {time.perf_counter() - t_phase:.1f}s; "
              f"launches over both runs' workers {counts} {on}", flush=True)
        del runs, a, b, oparams, oparams_b
        torch.cuda.empty_cache()
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ----------------------------------------------------------------------
# phase 10: MoE, granite-moe served at full width and depth and trained at
# 16 layers, llama4-scout served at 4 layers
# ----------------------------------------------------------------------
def _route_recorder():
    """A patch of the port's router that records each call's top-k
    experts, in call order (the forward's layers, then each period's
    recompute in the backward): ``(routes, patch)``."""
    from repro_torch.models import layers as L
    routes, real = [], L.moe_route

    def record(xf, router, cfg):
        out = real(xf, router, cfg)
        routes.append(out[2].clone())
        return out
    return routes, mock.patch.object(L, "moe_route", record)


def _route_replayer(torch, routes, drop_second=False):
    """A patch of the port's router that computes its own probabilities but
    takes the recorded experts (call by call), their weights renormalised
    from its own probabilities; ``flips`` counts the tokens whose own top-k
    set differs. ``drop_second`` plants a fault: each token's second
    expert weighs 0."""
    from repro_torch.models import layers as L
    it, real = iter(routes), L.moe_route
    flips = {"tokens": 0, "flipped": 0}

    def replay(xf, router, cfg):
        probs, _, own = real(xf, router, cfg)
        top_i = next(it)
        flips["tokens"] += top_i.shape[0]
        flips["flipped"] += int((own.sort(-1).values
                                 != top_i.sort(-1).values).any(-1).sum())
        top_p = probs.gather(1, top_i)
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
        if drop_second:
            top_p = top_p * (torch.arange(top_p.shape[1], device=top_p.device)
                             != 1)
        return probs, top_p, top_i
    return flips, mock.patch.object(L, "moe_route", replay)


def _prefill_rel(torch, a, b):
    """Worst ||a - b|| / ||b|| over the rows of the prefills' logits, which
    both runs computed from the same tokens."""
    return max(float((torch.linalg.vector_norm(la[0] - lb[0], dim=-1)
                      / torch.linalg.vector_norm(lb[0], dim=-1)).max())
               for la, lb in zip(a.logits, b.logits))


def _serve_against_plain(torch, arch, n_layers, kw, tag, fault=True):
    """The serve at ``n_layers`` with the kernels, recording the routes, and
    again with the plain versions replaying them: the logits within
    TOL_BF16, and each prefill row's logits within LOGIT_REL_TOL by norm;
    with ``fault``, a replay without each token's second expert must fail
    the latter."""
    routes, record = _route_recorder()
    with record:
        _, _, with_k = _serve(torch, n_layers, arch=arch, tag=tag, **kw)
    runs = {}
    for name in ("plain",) + (("fault",) if fault else ()):
        flips, replay = _route_replayer(torch, routes,
                                        drop_second=name == "fault")
        with contextlib.ExitStack() as stack:
            for p in (*_plain_attention(), replay):
                stack.enter_context(p)
            runs[name] = (_serve(torch, n_layers, arch=arch, tag=tag,
                                 **kw)[2], flips)
    err, compared = _compare_serves(torch, with_k, runs["plain"][0], TOL_BF16)
    rel = _prefill_rel(torch, with_k, runs["plain"][0])
    flips = runs["plain"][1]
    line = (f"[{tag}] {n_layers} layers, kernels vs plain versions on the "
            f"kernels' routes: max |logit diff| / (1 + max|logit|) {err:.3e} "
            f"over {compared} (row, step) logit vectors (tol {TOL_BF16}); "
            f"worst prefill row ||diff|| / ||plain|| {rel:.3e} (LOGIT_REL_TOL "
            f"{LOGIT_REL_TOL}); the plain run's own routes differ for "
            f"{flips['flipped']} of {flips['tokens']} token routings")
    if fault:
        f_rel = _prefill_rel(torch, runs["fault"][0], runs["plain"][0])
        line += (f"; planted fault (each token's second expert dropped): "
                 f"worst prefill row {f_rel:.3e}")
    print(line, flush=True)
    check(err <= TOL_BF16 and rel <= LOGIT_REL_TOL, f"{n_layers}-layer "
          f"{arch} serve logits: kernels and plain versions disagree")
    if fault:
        check(f_rel > LOGIT_REL_TOL, f"the {arch} serve comparison does not "
              "see a router that drops each token's second expert")


def _serve_line(tag, cfg, res, tokens, took, counts, expected, extra=""):
    import numpy as np
    from repro_torch.serve import report
    lens = np.array([len(t) for t in tokens])
    for line in report(res, lens).splitlines():
        print(f"[{tag}] {line}")
    print(f"[{tag}] {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"({cfg.n_params() / 1e9:.2f} B params){extra}, {len(tokens)} "
          f"requests in {took:.1f}s incl. init; launches {counts} (expected "
          f"{expected}); peak memory {_peak_gib():.1f} GiB", flush=True)


def _peak_gib():
    import torch
    return torch.cuda.max_memory_allocated() / 2**30


def phase_moe(torch, requests, max_prompt, decode_steps):
    """granite-moe at full width: served at full depth (every logit finite,
    K1 launched layers x (batches + batches x decode steps) times), trained
    at MOE_TRAIN_LAYERS layers (exact launches, two runs equal to the bit),
    and at 2 layers against the plain versions on the kernels' routes;
    llama4-scout at LLAMA4_LAYERS layers served and compared the same way."""
    import numpy as np
    from repro_torch.core.planner import plan_iteration
    from repro_torch.data.dataset import materialize_micro_batch
    from repro_torch.kernels import ops
    from repro_torch.models import model as MD
    from repro_torch.train.pipeline_adapter import build_grad_step
    from repro_torch.tree import leaves

    print(f"[moe] cuts: {MOE_ARCH} served at full width and depth; trained "
          f"at depth 32 -> {MOE_TRAIN_LAYERS} layers; llama4-scout-17b-a16e "
          f"served at depth 48 -> {LLAMA4_LAYERS} layers; comparisons with "
          "the plain versions at 2 layers", flush=True)
    counts = {}
    # (a) the serve at full depth; garbage of earlier phases (tensors held
    # by the fault phase's tracebacks) is collected first, so that the peak
    # memory readings are this phase's
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cfg, tokens, res = _serve(torch, 32, n_requests=requests,
                              max_prompt=max_prompt, decode_steps=decode_steps,
                              seed=0, arch=MOE_ARCH, tag="moe")
    counts["serve"] = ops.launch_counts()
    nb = len(res.batches)
    expected = {"mha_forward": cfg.n_layers * (nb + nb * decode_steps),
                "mha_backward": 0, "ssd_chunked": 0}
    _serve_line("moe", cfg, res, tokens, time.perf_counter() - t0,
                counts["serve"], expected,
                f", {cfg.n_experts} experts x {cfg.d_ff_expert} top-"
                f"{cfg.top_k}, {decode_steps} decode steps")
    check(counts["serve"] == expected, f"{MOE_ARCH} serve launches "
          f"{counts['serve']}, expected {expected}")
    check(all(bool(torch.isfinite(x).all()) for x in res.logits),
          f"non-finite logits in the {MOE_ARCH} serve")
    del res
    torch.cuda.empty_cache()
    _serve_against_plain(torch, MOE_ARCH, 2, dict(
        n_requests=requests, max_prompt=max_prompt,
        decode_steps=decode_steps, seed=1), "moe")

    # (b) training at MOE_TRAIN_LAYERS layers on the sequential runner
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cfg, stream, cost, pcfg, params, hist, stats = _train(
        torch, MOE_TRAIN_LAYERS, TRAIN_ITERS, seed=0, arch=MOE_ARCH)
    counts["moe-train"] = ops.launch_counts()
    took = time.perf_counter() - t0
    peak = _peak_gib()
    del params
    torch.cuda.empty_cache()
    tok_s, step_s = _history_lines("moe", hist, lambda it: [
        (m.mbs, m.seq) for m in plan_iteration(
            stream.batch(it).lengths[:, 0], cost, pcfg)
        .replica_plans[0].micro_batches])
    n_micro = sum(h["n_micro"] for h in hist)
    expected = {"mha_forward": 2 * cfg.n_layers * n_micro,
                "mha_backward": cfg.n_layers * n_micro, "ssd_chunked": 0}
    print(f"[moe] {cfg.name} trained at {cfg.n_layers} layers "
          f"({cfg.n_params() / 1e9:.2f} B params), {len(hist)} iterations, "
          f"{n_micro} micro-batches in {took:.1f}s incl. init; iterations "
          f"after the first: {tok_s:.1f} real tokens/s, mean step "
          f"{1e3 * step_s:.1f} ms; peak memory {peak:.1f} GiB; planning "
          f"overlap {stats.overlap_fraction:.3f}; launches "
          f"{counts['moe-train']} (expected {expected})", flush=True)
    check(counts["moe-train"] == expected, f"{MOE_ARCH} train launches "
          f"{counts['moe-train']}, expected {expected}")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
              for h in hist), f"non-finite loss or grad norm in {MOE_ARCH} "
          "training")
    runs = [_train(torch, MOE_TRAIN_LAYERS, 2, seed=1, log_every=0,
                   arch=MOE_ARCH)[4:6] for _ in range(2)]
    same = _same_runs(torch, *runs)
    print(f"[moe] {MOE_TRAIN_LAYERS} layers, two 2-iteration runs from one "
          f"seed: losses {[h['loss'] for h in runs[0][1]]} and "
          f"{[h['loss'] for h in runs[1][1]]}; losses, grad norms and all "
          f"{len(leaves(runs[0][0]))} parameter leaves equal to the bit: "
          f"{'yes' if same else 'NO'}", flush=True)
    check(same, f"two {MOE_ARCH} training runs from one seed differ")
    del runs
    torch.cuda.empty_cache()

    # the first iteration's largest micro-batch at 2 layers: the grad step
    # with the kernels, recording the routes, and with the plain versions
    # on them (and a planted fault: each token's second expert dropped)
    cfg2, stream2, cost2, pcfg2 = _train_setup(torch, 2, arch=MOE_ARCH)
    gb = stream2.batch(0)
    big = max(plan_iteration(gb.lengths[:, 0], cost2, pcfg2).replica_plans[0]
              .micro_batches, key=lambda m: m.mbs * m.seq)
    batch = {k: torch.as_tensor(v).cuda() for k, v in materialize_micro_batch(
        big, gb.tokens, lengths=gb.lengths).items()}
    params0 = MD.init_params(torch.Generator(device="cuda").manual_seed(1),
                             cfg2, device="cuda")
    step = build_grad_step(cfg2)

    def grad_step():
        ls, ws, g = step(params0, batch)
        return float(ls) / float(ws), {i: x.float() / float(ws)
                                       for i, x in enumerate(leaves(g))}
    routes, record = _route_recorder()
    with record:
        lk, gk = grad_step()
    out = {}
    for name in ("plain", "fault"):
        flips, replay = _route_replayer(torch, routes,
                                        drop_second=name == "fault")
        with contextlib.ExitStack() as stack:
            for p in (*_plain_attention(), replay):
                stack.enter_context(p)
            out[name] = grad_step() + (flips,)
    (lp, gp, flips), (lf, gf, _) = out["plain"], out["fault"]
    g_abs, g_rel, ok = _leaf_errs(torch, gk, gp)
    f_abs, f_rel, f_ok = _leaf_errs(torch, gf, gp)
    loss_err = abs(lk - lp) / max(1.0, abs(lp))
    print(f"[moe] 2 layers, kernels vs plain versions on the kernels' routes, "
          f"a micro-batch of {big.mbs} x {big.seq}: loss {lk:.6f} vs "
          f"{lp:.6f}; {len(gk)} gradient leaves, max |diff| {g_abs:.3e}, worst "
          f"||diff|| / ||plain|| {g_rel:.3e} (GRAD_TOL {GRAD_TOL_BF16}, "
          f"GRAD_REL_TOL {GRAD_REL_TOL}); the plain run's own routes differ "
          f"for {flips['flipped']} of {flips['tokens']} token routings; "
          f"planted fault (each token's second expert dropped): loss "
          f"{lf:.6f}, worst ||diff|| / ||plain|| {f_rel:.3e}, elementwise "
          f"GRAD_TOL {'passes' if f_ok else 'fails'} it", flush=True)
    check(ok and g_rel <= GRAD_REL_TOL, "2-layer MoE gradient leaves: "
          "kernels and plain versions disagree")
    check(loss_err <= GRAD_TOL_BF16, "2-layer MoE losses: kernels and plain "
          f"versions disagree ({loss_err:.3e})")
    check(f_rel > GRAD_REL_TOL, "the MoE gradient check does not see a "
          "router that drops each token's second expert")
    del params0, gk, gp, gf, routes, out
    torch.cuda.empty_cache()

    # (c) llama4-scout: top-1 and a shared expert
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cfg, tokens, res = _serve(torch, LLAMA4_LAYERS,
                              n_requests=LLAMA4_REQUESTS,
                              max_prompt=max_prompt,
                              decode_steps=LLAMA4_DECODE_STEPS, seed=0,
                              arch="llama4-scout-17b-a16e", tag="moe")
    counts["llama4-serve"] = ops.launch_counts()
    nb = len(res.batches)
    expected = {"mha_forward": cfg.n_layers * (nb + nb * LLAMA4_DECODE_STEPS),
                "mha_backward": 0, "ssd_chunked": 0}
    _serve_line("moe", cfg, res, tokens, time.perf_counter() - t0,
                counts["llama4-serve"], expected,
                f", {cfg.n_experts} experts x {cfg.d_ff_expert} top-"
                f"{cfg.top_k} + {cfg.n_shared_experts} shared, "
                f"{LLAMA4_DECODE_STEPS} decode steps")
    check(counts["llama4-serve"] == expected, f"llama4 serve launches "
          f"{counts['llama4-serve']}, expected {expected}")
    check(all(bool(torch.isfinite(x).all()) for x in res.logits),
          "non-finite logits in the llama4 serve")
    del res
    torch.cuda.empty_cache()
    _serve_against_plain(torch, "llama4-scout-17b-a16e", 2, dict(
        n_requests=LLAMA4_REQUESTS, max_prompt=max_prompt,
        decode_steps=LLAMA4_DECODE_STEPS, seed=1), "moe", fault=False)
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------------
# phase 11: frames, hubert-xlarge trained at full width and depth
# ----------------------------------------------------------------------
def _frame_batch(torch, cfg, b, s, seed):
    """One seeded train batch as ``launch/dryrun.py::batch_specs`` lays it
    out: frames (B, S, d_model) bf16, the mask (spans of 10 frames from
    starts drawn at 8%, HuBERT's masking), labels in [0, vocab), loss
    weights on the masked frames, positions and zero segment ids."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    starts = torch.rand((b, s), generator=g, device="cuda") < 0.08
    cs = torch.cumsum(starts.int(), dim=1)
    mask = (cs - torch.nn.functional.pad(cs, (10, 0))[:, :s]) > 0
    return {
        "frames": torch.randn((b, s, cfg.d_model), generator=g,
                              device="cuda").to(torch.bfloat16),
        "mask": mask,
        "labels": torch.randint(0, cfg.vocab, (b, s), generator=g,
                                device="cuda", dtype=torch.int32),
        "loss_weights": mask.float(),
        "positions": torch.arange(s, dtype=torch.int32, device="cuda")[None]
        .expand(b, s).contiguous(),
        "segment_ids": torch.zeros((b, s), dtype=torch.int32, device="cuda"),
    }


def _dense_grads_against_plain(torch, cfg, params, batch, tag):
    """The grad step with the kernels and with the plain versions on one
    batch: the loss and every gradient leaf (GRAD_TOL, GRAD_REL_TOL), and
    the leaf check must fail a backward planted to return a zero dq."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train.pipeline_adapter import build_grad_step
    from repro_torch.tree import leaves
    step = build_grad_step(cfg)

    def grad_step():
        ls, ws, g = step(params, batch)
        return float(ls) / float(ws), {i: x.float() / float(ws)
                                       for i, x in enumerate(leaves(g))}
    lk, gk = grad_step()
    with contextlib.ExitStack() as stack:
        for p in _plain_attention():
            stack.enter_context(p)
        lp, gp = grad_step()
    real_backward = fa.mha_backward

    def zero_dq(*a, **o):
        dq, dk, dv = real_backward(*a, **o)
        return torch.zeros_like(dq), dk, dv
    with mock.patch.object(fa, "mha_backward", zero_dq):
        _, gf = grad_step()
    g_abs, g_rel, ok = _leaf_errs(torch, gk, gp)
    f_rel = _leaf_errs(torch, gf, gp)[1]
    loss_err = abs(lk - lp) / max(1.0, abs(lp))
    print(f"[{tag}] {cfg.n_layers} layers, kernels vs plain versions: loss "
          f"{lk:.6f} vs {lp:.6f}; {len(gk)} gradient leaves, max |diff| "
          f"{g_abs:.3e}, worst ||diff|| / ||plain|| {g_rel:.3e} (GRAD_TOL "
          f"{GRAD_TOL_BF16}, GRAD_REL_TOL {GRAD_REL_TOL}); planted fault "
          f"(dq = 0): worst ||diff|| / ||plain|| {f_rel:.3e}", flush=True)
    check(ok and g_rel <= GRAD_REL_TOL, f"{cfg.name} gradient leaves: "
          "kernels and plain versions disagree")
    check(loss_err <= GRAD_TOL_BF16, f"{cfg.name} losses: kernels and plain "
          f"versions disagree ({loss_err:.3e})")
    check(f_rel > GRAD_REL_TOL, f"the {cfg.name} gradient check does not see "
          "a backward whose dq is zero")


def _hubert_train_state(torch, cfg):
    """hubert's seeded weights, AdamW state and grad step:
    ``(params, opt, opt_cfg, step)``."""
    from repro_torch.models import model as MD
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.pipeline_adapter import build_grad_step
    params = MD.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, device="cuda")
    opt_cfg = AdamWConfig(lr=3e-4)
    return params, init_opt_state(params, opt_cfg), opt_cfg, \
        build_grad_step(cfg)


def _hubert_step(step, params, opt, opt_cfg, batch):
    """One AdamW step on ``batch``, the loss weighted by its masked frames:
    ``(params, opt, loss, grad norm, masked frames)``."""
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.runner import scale_
    ls, ws, grads = step(params, batch)
    w = float(ws)
    scale_(grads, 1.0 / max(w, 1.0))
    params, opt, m = adamw_update(params, grads, opt, opt_cfg)
    return params, opt, float(ls) / max(w, 1.0), float(m["grad_norm"]), int(w)


def phase_frames(torch):
    """hubert-xlarge at full width and depth: HUBERT_STEPS AdamW steps of
    ``build_grad_step`` on (HUBERT_BATCH, HUBERT_SEQ) frame batches, then
    the encoder forward (prefill) at the same shape; exact launches of K1
    and the backward at head dim 80; at 2 layers against the plain
    versions."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import model as MD

    cfg = get_arch("hubert-xlarge")
    print(f"[frames] {cfg.name} at full width and depth ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads x "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, {cfg.act}, non-causal); nothing "
          "cut", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params, opt, opt_cfg, step = _hubert_train_state(torch, cfg)
    hist = []
    for it in range(HUBERT_STEPS):
        batch = _frame_batch(torch, cfg, HUBERT_BATCH, HUBERT_SEQ, seed=it)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt, loss, gn, w = _hubert_step(step, params, opt, opt_cfg,
                                                batch)
        torch.cuda.synchronize()
        hist.append((time.perf_counter() - t1, loss, gn, w))
        print(f"[frames] step {it}: {1e3 * hist[-1][0]:.1f} ms, loss "
              f"{loss:.4f}, grad norm {gn:.4f}, {w} masked frames of "
              f"{HUBERT_BATCH * HUBERT_SEQ}, "
              f"{HUBERT_BATCH * HUBERT_SEQ / hist[-1][0]:.1f} frames/s",
              flush=True)
    counts = ops.launch_counts()
    steady = [h[0] for h in hist[1:]]
    step_s = sum(steady) / len(steady)
    L = cfg.n_layers
    expected = {"mha_forward": 2 * L * HUBERT_STEPS,
                "mha_backward": L * HUBERT_STEPS, "ssd_chunked": 0}
    print(f"[frames] {cfg.n_params() / 1e9:.3f} B params, {HUBERT_STEPS} "
          f"steps in {time.perf_counter() - t0:.1f}s incl. init; steps after "
          f"the first: {HUBERT_BATCH * HUBERT_SEQ / step_s:.1f} frames/s, "
          f"mean step {1e3 * step_s:.1f} ms; peak memory {_peak_gib():.1f} "
          f"GiB; launches {counts} (expected {expected})", flush=True)
    check(counts == expected, f"hubert train launches {counts}, expected "
          f"{expected}")
    check(all(np.isfinite(h[1]) and np.isfinite(h[2]) for h in hist),
          "non-finite loss or grad norm in hubert training")
    del opt
    torch.cuda.empty_cache()

    # the encoder forward at the same shape: prefill of an encoder-only model
    batch = _frame_batch(torch, cfg, HUBERT_BATCH, HUBERT_SEQ, seed=99)
    ops.reset_launch_counts()
    with torch.inference_mode():
        MD.prefill(params, batch, cfg)           # warm
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, cache = MD.prefill(params, batch, cfg)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t1
    prefill_counts = ops.launch_counts()
    print(f"[frames] prefill (the encoder forward) of {HUBERT_BATCH} x "
          f"{HUBERT_SEQ} frames: {1e3 * pre_s:.1f} ms, "
          f"{HUBERT_BATCH * HUBERT_SEQ / pre_s:.1f} frames/s; launches "
          f"{prefill_counts} (two prefills)", flush=True)
    check(cache is None and bool(torch.isfinite(logits).all()),
          "hubert prefill: a cache or non-finite logits")
    check(prefill_counts["mha_forward"] == 2 * L, "hubert prefill launched "
          f"K1 {prefill_counts['mha_forward']} times, expected {2 * L}")
    counts = {k: counts[k] + prefill_counts[k] for k in counts}
    del params, logits, batch
    torch.cuda.empty_cache()

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = MD.init_params(torch.Generator(device="cuda").manual_seed(1),
                            cfg2, device="cuda")
    _dense_grads_against_plain(torch, cfg2, params, _frame_batch(
        torch, cfg2, HUBERT_BATCH, HUBERT_SEQ, seed=7), "frames")
    del params
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------------
# phase 12: mixed, llava-next-34b prefilled and decoded at full width
# ----------------------------------------------------------------------
def _greedy(torch, logits):
    return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)


def _greedy_decode(torch, params, cfg, nxt, cache, start, steps):
    """``steps`` greedy decode steps of the batch ``nxt`` (B, 1) from
    position ``start``: ``(logits per step, tokens per step, cache)``."""
    from repro_torch.models import model as MD
    b = nxt.shape[0]
    steps_logits, steps_tokens = [], []
    for i in range(steps):
        logits, cache = MD.decode(params, {
            "tokens": nxt, "cache": cache, "cache_pos": start + i,
            "positions": torch.full((b, 1), start + i, dtype=torch.int32,
                                    device="cuda")}, cfg)
        nxt = _greedy(torch, logits)
        steps_logits.append(logits)
        steps_tokens.append(nxt)
    return steps_logits, steps_tokens, cache


def _llava_setup(torch, n_layers, seed):
    """llava at full width and ``n_layers`` with weights from ``seed``, and
    a batch of LLAVA_ROWS rows of seeded patches and LLAVA_TEXT text
    tokens: ``(cfg, params, batch)``."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    from repro_torch.models import model as MD
    cfg = dataclasses.replace(get_arch("llava-next-34b"), n_layers=n_layers)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = MD.init_params(gen, cfg, device="cuda")
    b, p, t = LLAVA_ROWS, cfg.n_patches, LLAVA_TEXT
    g = torch.Generator(device="cuda").manual_seed(1000 + seed)
    batch = {
        "patches": torch.randn((b, p, cfg.d_model), generator=g,
                               device="cuda").to(torch.bfloat16),
        "tokens": torch.randint(0, cfg.vocab, (b, t), generator=g,
                                device="cuda", dtype=torch.int32),
        "positions": torch.arange(p + t, dtype=torch.int32, device="cuda")
        [None].expand(b, p + t).contiguous()}
    return cfg, params, batch


def _llava_prefill(params, batch, cfg):
    """The prompt (patches and text) into a cache with room for
    LLAVA_DECODE_STEPS: ``(last logits, cache)``."""
    from repro_torch.models import model as MD
    n = batch["positions"].shape[1]
    return MD.prefill(params, batch, cfg, cache_len=n + LLAVA_DECODE_STEPS)


def _mixed_serve(torch, n_layers, seed):
    """llava at full width and ``n_layers`` (:func:`_llava_setup`): the
    prompt prefilled, then LLAVA_DECODE_STEPS greedy steps. Returns a
    record with ``logits`` and ``tokens`` laid out as
    ``repro_torch.serve``'s."""
    import types
    cfg, params, batch = _llava_setup(torch, n_layers, seed)
    n = batch["positions"].shape[1]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = _llava_prefill(params, batch, cfg)
        nxt = _greedy(torch, logits)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        steps_logits, steps_tokens, cache = _greedy_decode(
            torch, params, cfg, nxt, cache, n, LLAVA_DECODE_STEPS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    steps_logits, steps_tokens = [logits] + steps_logits, [nxt] + steps_tokens
    del params, cache
    return cfg, types.SimpleNamespace(
        logits=[torch.stack(steps_logits)],
        tokens=[torch.cat(steps_tokens, dim=1).cpu().numpy()],
        prefill_s=t1 - t0, decode_s=t2 - t1)


def phase_mixed(torch):
    """llava-next-34b at full width and LLAVA_LAYERS layers: prefill of
    patches and text, greedy decode; exact K1 launches, finite logits; at
    2 layers against the plain attention."""
    from repro_torch.kernels import ops
    print(f"[mixed] cuts: llava-next-34b at full width, depth 60 -> "
          f"{LLAVA_LAYERS} layers", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cfg, res = _mixed_serve(torch, LLAVA_LAYERS, seed=0)
    counts = ops.launch_counts()
    expected = {"mha_forward": cfg.n_layers * (1 + LLAVA_DECODE_STEPS),
                "mha_backward": 0, "ssd_chunked": 0}
    b, p, t = LLAVA_ROWS, cfg.n_patches, LLAVA_TEXT
    print(f"[mixed] {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"({cfg.n_params() / 1e9:.2f} B params): prefill of {b} rows of "
          f"{p} patches + {t} text tokens in {res.prefill_s:.3f}s = "
          f"{b * (p + t) / res.prefill_s:.1f} tok/s; {LLAVA_DECODE_STEPS} "
          f"decode steps in {res.decode_s:.3f}s = "
          f"{b * LLAVA_DECODE_STEPS / res.decode_s:.1f} tok/s; "
          f"{time.perf_counter() - t0:.1f}s incl. init; launches {counts} "
          f"(expected {expected}); peak memory {_peak_gib():.1f} GiB",
          flush=True)
    check(counts == expected, f"llava launches {counts}, expected {expected}")
    check(all(bool(torch.isfinite(x).all()) for x in res.logits),
          "non-finite logits in the llava serve")
    del res
    torch.cuda.empty_cache()
    _, with_k1 = _mixed_serve(torch, 2, seed=1)
    with contextlib.ExitStack() as stack:
        for patch in _plain_attention():
            stack.enter_context(patch)
        _, with_plain = _mixed_serve(torch, 2, seed=1)
    err, compared = _compare_serves(torch, with_k1, with_plain, TOL_BF16)
    print(f"[mixed] 2 layers, K1 vs plain attention: max |logit diff| / "
          f"(1 + max|logit|) {err:.3e} over {compared} (row, step) logit "
          f"vectors (tol {TOL_BF16})", flush=True)
    check(err <= TOL_BF16, "2-layer llava logits: K1 and plain disagree")
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------------
# phase 13: gemma2, gemma2-2b served and trained at full width (head dim 256)
# ----------------------------------------------------------------------
def _gqa_fault(torch):
    """A patch of K1 by a planted fault on the plain forward: every q head
    h reads kv head h mod KV in place of h / group, an indexing fault of
    GQA."""
    from repro_torch.kernels import flash_attention as fa

    def forward(q, k, v, *a, **o):
        idx = torch.arange(q.shape[2], device=k.device) % k.shape[2]
        return fa.mha_forward_plain(q, k[:, :, idx], v[:, :, idx], *a, **o)
    return mock.patch.object(fa, "_mha_forward_cuda", forward)


def phase_gemma2(torch, requests, max_prompt, decode_steps):
    """gemma2-2b at full width, its attention on the D 256 kernels: served
    at full depth (K1 launched layers x (batches + batches x decode steps)
    times, every logit finite and within the final softcap), at 2 layers
    against the plain versions (prefill logits within LOGIT_REL_TOL, which
    must fail a planted GQA fault); trained at full depth on the
    sequential runner (exact launches),
    two 2-layer runs equal to the bit, and at 2 layers each gradient leaf
    against the plain versions (which must fail a zero dq)."""
    import numpy as np
    from repro_torch.configs.base import get_arch
    from repro_torch.core.planner import plan_iteration
    from repro_torch.data.dataset import materialize_micro_batch
    from repro_torch.kernels import ops
    from repro_torch.models import model as MD
    from repro_torch.tree import leaves

    cfg = get_arch(GEMMA2_ARCH)
    print(f"[gemma2] {cfg.name} at full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} q and {cfg.n_kv_heads} kv heads x "
          f"{cfg.d_head}, window {cfg.window} on every other layer, softcaps "
          f"{cfg.attn_softcap} and {cfg.final_softcap}); served and trained "
          "at full depth; comparisons with the plain versions at 2 layers", flush=True)
    counts = {}
    # (a) the serve at full depth
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cfg, tokens, res = _serve(torch, cfg.n_layers, n_requests=requests,
                              max_prompt=max_prompt, decode_steps=decode_steps,
                              seed=0, arch=GEMMA2_ARCH, tag="gemma2")
    counts["serve"] = ops.launch_counts()
    nb = len(res.batches)
    expected = {"mha_forward": cfg.n_layers * (nb + nb * decode_steps),
                "mha_backward": 0, "ssd_chunked": 0}
    top = max(float(x.abs().max()) for x in res.logits)
    _serve_line("gemma2", cfg, res, tokens, time.perf_counter() - t0,
                counts["serve"], expected, f", {decode_steps} decode steps, "
                f"max |logit| {top:.4f} (final softcap {cfg.final_softcap})")
    check(counts["serve"] == expected, f"{GEMMA2_ARCH} serve launches "
          f"{counts['serve']}, expected {expected}")
    check(all(bool(torch.isfinite(x).all()) for x in res.logits),
          f"non-finite logits in the {GEMMA2_ARCH} serve")
    check(top <= cfg.final_softcap, f"{GEMMA2_ARCH} logits past the final "
          f"softcap: {top}")
    del res
    torch.cuda.empty_cache()

    # the serve at 2 layers with the kernels, the plain versions and a
    # planted fault in K1's place
    kw = dict(n_requests=requests, max_prompt=max_prompt,
              decode_steps=decode_steps, seed=1)
    runs = {}
    for name, patches in (("kernels", ()), ("plain", _plain_attention()),
                          ("fault", (_gqa_fault(torch),))):
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            runs[name] = _serve(torch, 2, arch=GEMMA2_ARCH, tag="gemma2",
                                **kw)[2]
    err, compared = _compare_serves(torch, runs["kernels"], runs["plain"],
                                    TOL_BF16)
    rel, f_rel = (_prefill_rel(torch, runs[n], runs["plain"])
                  for n in ("kernels", "fault"))
    print(f"[gemma2] 2 layers, kernels vs plain versions: max |logit diff| / "
          f"(1 + max|logit|) {err:.3e} over {compared} (row, step) logit "
          f"vectors (tol {TOL_BF16}); worst prefill row ||diff|| / ||plain|| "
          f"{rel:.3e} (LOGIT_REL_TOL {LOGIT_REL_TOL}); planted fault (kv head "
          f"h mod KV): worst prefill row {f_rel:.3e}", flush=True)
    check(err <= TOL_BF16 and rel <= LOGIT_REL_TOL, f"2-layer {GEMMA2_ARCH} "
          "serve logits: kernels and plain versions disagree")
    check(f_rel > LOGIT_REL_TOL, f"the {GEMMA2_ARCH} serve comparison does "
          "not see K1 reading the wrong kv head")
    del runs
    torch.cuda.empty_cache()

    # (b) training at full depth on the sequential runner
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cfg, stream, cost, pcfg, params, hist, stats = _train(
        torch, cfg.n_layers, TRAIN_ITERS, seed=0, arch=GEMMA2_ARCH)
    counts["train"] = ops.launch_counts()
    took = time.perf_counter() - t0
    peak = _peak_gib()
    del params
    torch.cuda.empty_cache()
    tok_s, step_s = _history_lines("gemma2", hist, lambda it: [
        (m.mbs, m.seq) for m in plan_iteration(
            stream.batch(it).lengths[:, 0], cost, pcfg)
        .replica_plans[0].micro_batches])
    n_micro = sum(h["n_micro"] for h in hist)
    expected = {"mha_forward": 2 * cfg.n_layers * n_micro,
                "mha_backward": cfg.n_layers * n_micro, "ssd_chunked": 0}
    print(f"[gemma2] {cfg.name} trained at {cfg.n_layers} layers "
          f"({cfg.n_params() / 1e9:.2f} B params), {len(hist)} iterations, "
          f"{n_micro} micro-batches in {took:.1f}s incl. init; iterations "
          f"after the first: {tok_s:.1f} real tokens/s, mean step "
          f"{1e3 * step_s:.1f} ms; peak memory {peak:.1f} GiB; planning "
          f"overlap {stats.overlap_fraction:.3f}; launches {counts['train']} "
          f"(expected {expected})", flush=True)
    check(counts["train"] == expected, f"{GEMMA2_ARCH} train launches "
          f"{counts['train']}, expected {expected}")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
              for h in hist), f"non-finite loss or grad norm in {GEMMA2_ARCH} "
          "training")
    runs = [_train(torch, 2, 2, seed=1, log_every=0, arch=GEMMA2_ARCH)[4:6]
            for _ in range(2)]
    same = _same_runs(torch, *runs)
    print(f"[gemma2] 2 layers, two 2-iteration runs from one seed: losses "
          f"{[h['loss'] for h in runs[0][1]]} and "
          f"{[h['loss'] for h in runs[1][1]]}; losses, grad norms and all "
          f"{len(leaves(runs[0][0]))} parameter leaves equal to the bit: "
          f"{'yes' if same else 'NO'}", flush=True)
    check(same, f"two {GEMMA2_ARCH} training runs from one seed differ")
    del runs
    torch.cuda.empty_cache()

    # the first iteration's largest micro-batch at 2 layers: every gradient
    # leaf with the kernels against the plain versions
    cfg2, stream2, cost2, pcfg2 = _train_setup(torch, 2, arch=GEMMA2_ARCH)
    gb = stream2.batch(0)
    big = max(plan_iteration(gb.lengths[:, 0], cost2, pcfg2).replica_plans[0]
              .micro_batches, key=lambda m: m.mbs * m.seq)
    batch = {k: torch.as_tensor(v).cuda() for k, v in materialize_micro_batch(
        big, gb.tokens, lengths=gb.lengths).items()}
    params = MD.init_params(torch.Generator(device="cuda").manual_seed(1),
                            cfg2, device="cuda")
    print(f"[gemma2] gradients against the plain versions on a micro-batch of "
          f"{big.mbs} x {big.seq}", flush=True)
    _dense_grads_against_plain(torch, cfg2, params, batch, "gemma2")
    del params, batch
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------------
# phase 14: profiles (not run by default)
# ----------------------------------------------------------------------
# K1's forms are mha_fwd_prefill_kernel and mha_fwd_decode_kernel; the
# backward's mha_bwd_kernel and mha_bwd_d256_kernel
KERNEL_SYMBOLS = {"K1": "mha_fwd_", "K2/K3": "mha_bwd_",
                  "K4": "ssd_fwd_kernel"}
# device kernels by kind, first match wins: cuBLAS GEMMs (nvjet, cutlass),
# the port's own, elementwise, reductions, copies
KINDS = (("gemm", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
         ("K1-K4", tuple(KERNEL_SYMBOLS.values())),
         ("elementwise", ("elementwise",)), ("reduce", ("reduce",)),
         ("copy", ("copy", "Cat")))


def _profile_window(torch, name, fn):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share of the window's host time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(getattr(e, "self_device_time_total", 0) / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[0] for r in rows)
    check(busy > 0, f"profile {name}: no device time recorded")
    ours = []
    for kid, sym in KERNEL_SYMBOLS.items():
        ms = sum(r[0] for r in rows if sym in r[2])
        n = sum(r[1] for r in rows if sym in r[2])
        if n:
            ours.append(f"{kid} {ms:.1f} ms ({100 * ms / busy:.1f}% of device "
                        f"time, {n} launches)")
    print(f"[profile] {name}: host {wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f}%, idle {100 - 100 * busy / wall_ms:.1f}%)"
          f", {'; '.join(ours)}")
    by_kind = dict.fromkeys([k for k, _ in KINDS] + ["other"], 0.0)
    for ms, _, key in rows:
        kind = next((k for k, pats in KINDS if any(p in key for p in pats)),
                    "other")
        by_kind[kind] += ms
    print("[profile]   by kind: " + ", ".join(
        f"{k} {ms:.1f} ms ({100 * ms / busy:.1f}%)" for k, ms in by_kind.items()))
    for ms, n, key in sorted(rows, reverse=True)[:10]:
        print(f"[profile]   {ms:9.2f} ms {100 * ms / busy:5.1f}% x{n:<5d} "
              f"{key[:90]}")


def phase_profile_serve(torch, max_prompt, decode_steps, arch="gpt-paper",
                        n_layers=32):
    """Where the time goes in the full-width serve: one prefill of the
    largest batch (8 x max_prompt) and its decode steps, after a warm-up."""
    from repro_torch import serve as SV
    from repro_torch.models import model as MD
    cfg = SV.make_config(arch, "full", n_layers)
    params = MD.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                            device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, s = 8, max_prompt
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device="cuda", dtype=torch.int32),
             "positions": torch.arange(s, dtype=torch.int32, device="cuda")
             [None].expand(b, s).contiguous()}
    state = {}

    def prefill():
        logits, state["cache"] = MD.prefill(params, batch, cfg,
                                            cache_len=s + decode_steps)
        state["nxt"] = _greedy(torch, logits)

    def decode():
        *_, state["cache"] = _greedy_decode(torch, params, cfg, state["nxt"],
                                            state["cache"], s, decode_steps)

    with torch.inference_mode():
        prefill()
        decode()          # warm-up of both
        _profile_window(torch, f"{arch} prefill {b}x{s}", prefill)
        _profile_window(torch, f"{arch} decode {decode_steps} steps of {b}",
                        decode)
    del params
    torch.cuda.empty_cache()


def phase_profile_train(torch, arch="gpt-paper", n_layers=TRAIN_LAYERS,
                        adamw=True):
    """Where the time goes in one full-width training iteration (the train
    phase's first batch), after a warm-up iteration; with ``adamw``, in the
    optimizer step alone too."""
    torch.cuda.empty_cache()
    from repro_torch.core.planner import plan_iteration
    from repro_torch.data.dataset import materialize_micro_batch
    from repro_torch.dist.backend import ThreadsBackend
    from repro_torch.models import model as MD
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.runner import scale_
    cfg, stream, cost, pcfg = _train_setup(torch, n_layers, arch=arch)
    gb = stream.batch(0)
    plan = plan_iteration(gb.lengths[:, 0], cost, pcfg).replica_plans[0]
    batches = {m.mb_id: materialize_micro_batch(m, gb.tokens, lengths=gb.lengths)
               for m in plan.micro_batches}
    params = MD.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                            device="cuda")
    ocfg = AdamWConfig(lr=3e-4)
    opt = init_opt_state(params, ocfg)
    backend = ThreadsBackend(cfg, 1, use_executor=False, device="cuda")

    def iteration():
        res = backend.execute_plan(plan, params=params, batches=batches)
        scale_(res.grads, 1.0 / max(res.weight_sum, 1.0))
        backend.optimizer_step(params, res.grads, opt, ocfg)

    iteration()       # warm-up
    _profile_window(torch, f"{arch} train iteration, {n_layers} layers, "
                    f"{[(m.mbs, m.seq) for m in plan.micro_batches]}",
                    iteration)
    if adamw:
        grads = backend.execute_plan(plan, params=params,
                                     batches=batches).grads
        _profile_window(torch, "AdamW step alone",
                        lambda: backend.optimizer_step(params, grads, opt,
                                                       ocfg))
        del grads
    del params, opt
    torch.cuda.empty_cache()


def phase_profile_frames(torch):
    """Where the time goes in one hubert-xlarge step at full width and
    depth (grad step and AdamW) and in its encoder forward, after a
    warm-up."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import model as MD
    torch.cuda.empty_cache()
    cfg = get_arch("hubert-xlarge")
    params, opt, ocfg, step = _hubert_train_state(torch, cfg)
    batch = _frame_batch(torch, cfg, HUBERT_BATCH, HUBERT_SEQ, seed=0)

    def train_step():   # AdamW updates params and opt in place
        _hubert_step(step, params, opt, ocfg, batch)

    def encode():
        with torch.inference_mode():
            MD.prefill(params, batch, cfg)
    train_step()
    encode()          # warm-up of both
    _profile_window(torch, f"hubert-xlarge step, {HUBERT_BATCH}x{HUBERT_SEQ} "
                    "frames", train_step)
    _profile_window(torch, f"hubert-xlarge encoder forward, {HUBERT_BATCH}x"
                    f"{HUBERT_SEQ} frames", encode)
    del params, opt
    torch.cuda.empty_cache()


def phase_profile_mixed(torch):
    """Where the time goes in llava-next's prefill of patches and text and
    its decode steps (LLAVA_LAYERS layers), after a warm-up."""
    torch.cuda.empty_cache()
    cfg, params, batch = _llava_setup(torch, LLAVA_LAYERS, seed=0)
    b, p, t = LLAVA_ROWS, cfg.n_patches, LLAVA_TEXT
    state = {}

    def prefill():
        logits, state["cache"] = _llava_prefill(params, batch, cfg)
        state["nxt"] = _greedy(torch, logits)

    def decode():
        *_, state["cache"] = _greedy_decode(torch, params, cfg, state["nxt"],
                                            state["cache"], p + t,
                                            LLAVA_DECODE_STEPS)

    with torch.inference_mode():
        prefill()
        decode()          # warm-up of both
        _profile_window(torch, f"llava-next-34b prefill {b}x({p}+{t})",
                        prefill)
        _profile_window(torch, f"llava-next-34b decode {LLAVA_DECODE_STEPS} "
                        f"steps of {b}", decode)
    del params, state
    torch.cuda.empty_cache()


def phase_profile_pipeline(torch):
    """Where the time goes in one pipelined iteration (the stage pipeline,
    the gradient merge and AdamW), after a warm-up iteration: gpt-paper
    with 8 layers and t5-paper with 4 + 4 layers, each over 4 stages, on
    their phases' first batches. Device time is summed over the stage
    streams, so it can exceed the host time where stages overlap."""
    from repro_torch.core.planner import plan_iteration
    from repro_torch.dist.backend import ThreadsBackend
    from repro_torch.models import model as MD
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.runner import scale_
    cases = (("gpt-paper, 8 layers", lambda: _train_setup(
                  torch, TRAIN_LAYERS, PIPE_STAGES), MD.init_params,
              lambda gb: gb.lengths[:, 0]),
             ("t5-paper, 4 + 4 layers", lambda: _t5_setup(torch, T5_LAYERS),
              T.init_encdec, lambda gb: gb.lengths))
    for name, setup, init, lengths in cases:
        torch.cuda.empty_cache()
        cfg, stream, cost, pcfg = setup()
        gb = stream.batch(0)
        plan = plan_iteration(lengths(gb), cost, pcfg).replica_plans[0]
        batches = _plan_batches(plan, gb)
        params = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                      device="cuda")
        ocfg = AdamWConfig(lr=3e-4)
        opt = init_opt_state(params, ocfg)
        backend = ThreadsBackend(cfg, pcfg.n_stages, device="cuda")

        def iteration():
            res = backend.execute_plan(plan, params=params, batches=batches)
            scale_(res.grads, 1.0 / max(res.weight_sum, 1.0))
            backend.optimizer_step(params, res.grads, opt, ocfg)

        iteration()       # warm-up
        split = [(m.mbs, m.seq) for m in plan.micro_batches]
        _profile_window(torch, f"pipelined iteration, {name} over "
                        f"{pcfg.n_stages} stages, {split}", iteration)
        del params, opt, backend
    torch.cuda.empty_cache()


# the dryrun phase's cases: (tag, arch, layers, kind, seq, batch, policy)
DRYRUN_CASES = (
    ("a-nothing", "gpt-paper", 8, "train", 2048, 8, "nothing"),
    ("a-dots", "gpt-paper", 8, "train", 2048, 8, "dots"),
    ("b", "gemma2-2b", 26, "train", 2048, 4, "nothing"),
    ("c-prefill", "gpt-paper", 32, "prefill", 2048, 8, "nothing"),
    ("c-decode", "gpt-paper", 32, "decode", 2064, 8, "nothing"),
)


def phase_dryrun(torch):
    """The dry run's predictions against the card: per case the meta
    trace, then the card's run of the same step (see the module
    docstring). Returns the kernels' launch counts over the cases' counted
    runs."""
    import dataclasses
    from repro_torch.configs.base import ShapeSpec, get_arch
    from repro_torch.launch import dryrun as D
    from repro_torch.train.optimizer import AdamWConfig
    gc.collect()
    torch.cuda.empty_cache()
    mesh, opt_cfg = D.parse_mesh("1x1"), AdamWConfig()
    totals: dict = {}
    peaks = {}
    for tag, arch, layers, kind, seq, batch, policy in DRYRUN_CASES:
        cfg = dataclasses.replace(get_arch(arch), n_layers=layers,
                                  remat_policy=policy)
        shape = ShapeSpec(f"{kind}_{seq}", kind, seq, batch)
        t0 = time.perf_counter()
        pred = D._lower_cell(cfg, shape, mesh, opt_cfg)
        t_trace = time.perf_counter() - t0
        got = D.measure_cell(cfg, shape, device="cuda", seed=0,
                             opt_cfg=opt_cfg)
        took = time.perf_counter() - t0
        for name, n in got["counted"].items():
            totals[name] = totals.get(name, 0) + n
        err = (pred.peak_bytes - got["peak_bytes"]) / got["peak_bytes"]
        tflops = got["flops"] / (got["step_ms"] * 1e-3) / 1e12
        peaks[tag] = got["peak_bytes"]
        hidden = sorted(((n, op) for op, n in got["hidden"].items()
                         if n >= 1 << 26), reverse=True)[:6]
        print(f"[dryrun] {tag}: {arch} {layers} layers {kind} B {batch} x "
              f"{seq}, remat {policy}: peak predicted "
              f"{pred.peak_bytes / 2**30:.3f} GiB (arguments "
              f"{(pred.argument_bytes + pred.unread_argument_bytes) / 2**30:.3f}"
              f"), measured {got['peak_bytes'] / 2**30:.3f} GiB "
              f"({100 * err:+.2f}%); FLOPs meta {pred.summary.flops:.6e}, "
              f"card {got['flops']:.6e} (padded "
              f"{pred.summary.padded_flops:.3e}); launches predicted "
              f"{pred.summary.launches}, charged on the card "
              f"{got['launches']}, counted {got['counted']}; step "
              f"{got['step_ms']:.1f} ms, {tflops:.1f} TFLOP/s; trace "
              f"{t_trace:.1f}s, case {took:.1f}s", flush=True)
        print(f"[dryrun] {tag}: made and freed inside an op, 64 MiB or more "
              f"(largest): " + (", ".join(f"{op} {n / 2**20:.0f} MiB"
                                          for n, op in hidden) or "none"),
              flush=True)
        check(got["finite"], f"dryrun {tag}: outputs not finite")
        check(abs(err) <= DRYRUN_PEAK_TOL,
              f"dryrun {tag}: predicted peak {pred.peak_bytes} against "
              f"{got['peak_bytes']} measured ({100 * err:+.2f}%)")
        check(pred.summary.flops == got["flops"],
              f"dryrun {tag}: meta FLOPs {pred.summary.flops} against "
              f"{got['flops']} on the card")
        check(pred.summary.launches == got["launches"] == got["counted"],
              f"dryrun {tag}: launches predicted {pred.summary.launches}, "
              f"charged {got['launches']}, counted {got['counted']}")
        gc.collect()
        torch.cuda.empty_cache()
    check(peaks["a-dots"] > peaks["a-nothing"],
          f"dryrun: dots peaked at {peaks['a-dots']}, not above nothing's "
          f"{peaks['a-nothing']}")
    return {"mha_forward": totals.get("mha_forward", 0),
            "mha_backward": totals.get("mha_backward", 0),
            "ssd_chunked": totals.get("ssd_chunked", 0)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="device,kernel,serve,train,pipeline,t5,mamba,"
                    "fault,cluster,moe,frames,mixed,gemma2,mesh,dryrun",
                    help="comma-separated: kernel, serve, train, pipeline, "
                    "t5, mamba, fault, cluster, moe, frames, mixed, gemma2, "
                    "mesh, dryrun, profile, "
                    "profile-models, profile-gemma2 (the device phase always "
                    "runs)")
    args = ap.parse_args()
    phases = args.phases.split(",")

    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        fail(f"the port is not in this checkout ({ROOT / 'src'})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    smi_line = phase_device(torch)
    records, worst, paths = {}, {}, {}
    if "kernel" in phases:
        records, worst = phase_kernel(torch)
        ssd_records, ssd_worst = phase_kernel_ssd(torch)
        records.update(ssd_records)
        worst.update(ssd_worst)
    # each path's launch counts, read right after it ran from counts of 0
    if "serve" in phases:
        paths["serve"] = phase_serve(torch, REQUESTS, MAX_PROMPT, DECODE_STEPS)
    if "train" in phases:
        paths["train"] = phase_train(torch)
    if "pipeline" in phases:
        paths["pipeline"] = phase_pipeline(torch)
    if "t5" in phases:
        paths["t5"] = phase_t5(torch)
    if "mamba" in phases:
        paths["mamba"] = phase_mamba(torch, REQUESTS, MAX_PROMPT, DECODE_STEPS)
    if "fault" in phases:
        paths["fault"] = phase_fault(torch, smi_line)
    if "cluster" in phases:
        paths["cluster"] = phase_cluster(torch, smi_line)
    if "moe" in phases:
        moe = phase_moe(torch, REQUESTS, MAX_PROMPT, DECODE_STEPS)
        paths.update({"moe-serve": moe["serve"], "moe-train": moe["moe-train"],
                      "llama4-serve": moe["llama4-serve"]})
    if "frames" in phases:
        paths["frames"] = phase_frames(torch)
    if "mixed" in phases:
        paths["mixed"] = phase_mixed(torch)
    if "gemma2" in phases:
        gemma2 = phase_gemma2(torch, REQUESTS, MAX_PROMPT, DECODE_STEPS)
        paths.update({"gemma2-serve": gemma2["serve"],
                      "gemma2-train": gemma2["train"]})
    if "mesh" in phases:
        paths["mesh"] = phase_mesh(torch)
    if "dryrun" in phases:
        paths["dryrun"] = phase_dryrun(torch)
    if "profile" in phases:
        phase_profile_serve(torch, MAX_PROMPT, DECODE_STEPS)
        phase_profile_serve(torch, MAX_PROMPT, DECODE_STEPS,
                            arch="mamba2-130m", n_layers=MAMBA_LAYERS)
        phase_profile_train(torch)
        phase_profile_pipeline(torch)
    if "profile-models" in phases:
        phase_profile_serve(torch, MAX_PROMPT, DECODE_STEPS, arch=MOE_ARCH)
        phase_profile_train(torch, arch=MOE_ARCH, n_layers=MOE_TRAIN_LAYERS,
                            adamw=False)
        phase_profile_frames(torch)
        phase_profile_mixed(torch)
    if "profile-gemma2" in phases:
        from repro_torch.configs.base import get_arch
        depth = get_arch(GEMMA2_ARCH).n_layers
        phase_profile_serve(torch, MAX_PROMPT, DECODE_STEPS, arch=GEMMA2_ARCH,
                            n_layers=depth)
        phase_profile_train(torch, arch=GEMMA2_ARCH, n_layers=depth,
                            adamw=False)
    kernels = []
    for kid, (name, source, replaces, main_case, other_cases,
              kpaths) in KERNELS.items():
        rec = records.get((kid, main_case), {})
        err, rel = worst.get(kid, (None, None))
        others = {key: records.get((kid, case))
                  for key, case in other_cases.items()}
        kernels.append({
            "name": f"{kid} {name}", "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": next((paths[p][name] for p in kpaths if p in paths),
                             None),
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": err, "max_err": err, "max_tile_rel_err": rel,
            "ms": rec.get("ms"), "plain_ms": rec.get("plain_ms"),
            "bound_ms": rec.get("bound_ms"), "bound_by": rec.get("bound_by"),
            "library_ms": rec.get("library_ms"),
            **{k: x for k, x in rec.items() if k not in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            **others,
        })
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
