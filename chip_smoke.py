#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

1. Build: every CUDA kernel of the path, from the sources in the checkout
   (one nvcc per source, in parallel); prints the card and the build time,
   and, where the toolkit has cuobjdump, the counts of HGMMA (wgmma),
   UTMALDG (TMA load), LDGSTS (cp.async) and SYNCS (mbarrier)
   instructions in the SASS of the flash kernel and of its backward
   kernels (fails if cuobjdump ran and found no HGMMA in either).
2. Kernels: each kernel against its plain PyTorch version on the card, at
   the path's shapes (a 40 000-slot segment, dense n=40 000, scatter
   k=65 536 with duplicates and saturating values; the fused fold at
   R=8 x n=262 144; sat_add, quantize and dequantize over a 25 MiB fp32
   gradient bucket, n=6 553 600; sat_add_batch at B=16 x n=40 000), with
   sentinels and saturating lanes; exact for ints and masks, bitwise for
   fp32. Times each one (CUPTI, where the profiler kept every launch of
   the timed calls, else CUDA events) and its bound; fails on any time
   below its bound, which no card reaches. Kernels 9-10 (the int8 pack) are
   only timed here; phase k checks them. The two scatters (sparse_addto,
   fused_scatter) are timed a second time with nothing to flag (no
   saturating value, no sentinel register), the common case on the path,
   each case also per call with host dispatch (CUDA events); and both are
   held bitwise against their plain versions on either side of the
   cluster lane's limits (40 000, 262 144 and the largest slot count it
   takes; one slot past it; the largest k it takes and one past), each
   launch counted on the lane its size takes. Prints the limits, the
   resident clusters, and ``index_add_`` of the same int32 stream as a
   yardstick of an unsaturated scatter (not the same function). Kernel 1
   over several runs (the multi-segment transmit) is held bitwise against
   its plain version at phase b's shape (7 runs, 262 144 values), at
   unaligned starts and past one launch's run table, each in one launch
   per table; at phase b's shape it is timed beside the same work as 7
   single-run launches (CUPTI, and per call with the stream's host copies,
   CUDA events). Kernel 3 over several runs (the multi-segment reply) is
   held bitwise against its plain version at the same layouts, with and
   without the raw registers, in one launch per table; at phase b's shape
   it is timed with and without raw beside the same work as 7 single-run
   launches (CUPTI), and ``SwitchMemory.read_f32`` of one such reply is
   timed by this route against the ``get`` route it replaces, with and
   without ``need_raw`` (CUDA events a call, the two bitwise equal).
   Kernel 6b is held at B = 2, 3, 16, 17 x n = 40 000 and
   40 001 with a sentinel mid-fold, and timed on phase h's updates.
3. Path, phases a-e: the typed INC RPC round trip through ``IncRuntime()``
   on the default device, at the paper's switch geometry (32 x 40 000
   int32), two workers over four rounds of five services; replies checked
   against a numpy fixed-point oracle, and replies and register state
   held bitwise against the same run with ``device="cpu"``. Phase b (7
   segments) must launch fused_addto once a transmit and fused_read once
   a reply, as phase a (one segment) does.
4. Path, phase f: ``Agg[FPArray](device=True, local_accum=8)`` on a
   262 144-slot partition, two workers of 16 calls each, through the fused
   fold; replies and register state bitwise equal to the CPU run.
5. Path, phase g: the SyncAgtr aggregation (``core/inc_agg.py``) of the
   25 MiB bucket, 1% of its lanes overflowing at precision 8, in all four
   modes with 1 and 4 streams, on an NCCL mesh of one rank; bitwise equal
   to the same calls on a gloo group on the CPU.
6. Path, phase h: the three clear policies at n=40 000, 16 ``addto`` calls
   and one ``addto_batch`` of 16 with saturating lanes; bitwise equal to
   the CPU.
7. Path, phase i: serving qwen2.5-3b at full width and depth (36 layers,
   random weights from a seed): ``serve`` prefills 4 prompts of 2 048
   tokens through the flash kernel and decodes 32 tokens, with its
   telemetry on the card's ``IncRuntime``. ``serve`` runs the prefill and
   decode programs of ``steps.build_serve_step`` on a one-rank world
   (NCCL on the card, gloo for the CPU runs), as every serve phase (l-q,
   u2) does. Checks: 36 flash launches per
   prefill and telemetry pushes through sparse_addto; 4 x 32 decode tokens
   counted by the telemetry; the same run with the plain attention
   (``flash=False``, the same weights, the tokens fed) within 6e-2 of its
   logits (max|d| / max|ref|; the two lanes drift 3.0e-2 apart at 36
   reduced layers on the CPU); a 2-layer full-width run (S=256, B=2) on
   the card within 2e-2 of the same run on the CPU. Flash attention joins
   the kernel check at the prefill's shape (B=4, H=16, KV=2, S=2 048,
   D=128), gemma3's window of 1 024, a ragged S and recurrentgemma-9b's
   local layer (B=1, H=16, KV=1, S=4 096, D=256, window 2 048), and the
   shapes of phases l and m (item 10), within
   atol 2e-2, rtol 5e-2 of its plain version (bf16: the kernel rounds p
   to bf16 before p.V, the plain version keeps fp32); each case is timed
   beside ``scaled_dot_product_attention`` on the same tensors, with its
   TFLOP/s and share of the bound; at the prefill's shape also with its
   lse store (the train lane's forward). Kernel 11's lse and its backward
   kernels (``csrc/flash_attn_bwd.cu``: delta, dK/dV, dQ) are held
   against their plain version (``ref.flash_bwd``, fp32 on the kernels'
   inputs) at phase z's shape (B=2, H=16, KV=2, S=1 024, D=128),
   gemma3-27b's local layers (1, 32, 16, 2 048, 128, window 1 024),
   whisper-medium's decoder (2, 16, 16, 448, 64), recurrentgemma-9b's
   local layer (1, 16, 1, 4 096, 256, window 2 048), at D = 32 and
   phi4-mini-3.8b's (1, 24, 8, 2 048, 128; dK/dV's cluster of 3): dq, dk
   and dv within 1.5e-2 of max|plain| (``FLASH_BWD_TOL``, set from the
   CPU emulation of the kernels' bf16 roundings before their first run),
   each kernel's two calls bitwise equal; each timed beside its plain
   version and the backward of ``scaled_dot_product_attention`` (held to
   the whole gradient's floor, ``flash_bwd_work``, as library_bound_ms).

8. Path, phase j: training qwen2.5-3b at full width and depth (36 layers,
   random weights from a seed, uniform tokens) through ``train_loop``:
   three steps of B=2 x S=1 024 in ``netrpc`` (precision 8: every
   gradient leaf through quantize, sat_add and dequantize) and three in
   ``fp32-ring``, from the same state, with the train telemetry on the
   card's ``IncRuntime``. Checks: finite losses, step 0's within
   [ln(vocab) - 0.5, ln(vocab) + 1.5] (on uniform tokens an untrained
   model's expected loss is at least ln(vocab); the tied embedding puts
   it above); the two modes' losses within 1e-3 (relative) at each step;
   one quantize, sat_add and dequantize launch per scattered leaf and
   step, no flash launch (``flash=False``, the default, is the plain
   attention); telemetry pushes through sparse_addto and one commit a
   step. Prints the warm step time, tokens/s and peak memory (the card's
   busy share of one step and its stages: phase z's profile, on the
   flash lane). Then one ``netrpc``
   step at 1 full-width layer (B=2, S=256) on the card and on the CPU
   from the same params and optimizer state: loss within 1e-3 and gnorm
   within 1e-2 (relative); AdamW's m and v, per leaf, within 3e-2
   (||card - CPU|| / ||CPU||, 1.4e-2 measured, on the v of the k bias:
   they are the aggregated gradient and its square, so a wrong quantize
   or dequantize of any leaf shows); and the updated fp32 masters within
   2.5 lr of each other, at most 2% of them more than lr/100 apart (one
   AdamW step moves an element by about lr, so a gradient whose sign
   differs between the devices moves it about 2 lr apart).
9. Path, phase k: the int8 wire format's entry points ``ops.pack_int8``
   and ``ops.unpack_int8`` (kernels 9-10) on the 25 MiB bucket and on a
   ragged stream that pads, on the card, bitwise equal to the same calls
   on the CPU (the plain versions) and within half an int8 step of the
   input. The kernel phase times both on the bucket, unpack also beside
   ``q * scale[:, None]``.
10. Path, phases l and m: serving gemma3-27b (62 layers: 52 sliding-window
   layers of window 1 024 and 10 global ones, H = 32, KV = 16, D = 128;
   27.008 B parameters) on 4 prompts of 2 048 tokens, and
   recurrentgemma-9b (38 layers: 26 RG-LRU and 12 local MQA layers of
   D = 256 and window 2 048; 8.579 B parameters) on 2 prompts of 4 096
   tokens, each at full width and depth with random weights from a seed
   and 32 greedy decode steps, as phase i does (phase j's memory freed
   first). Checks: one flash launch a prefill for each layer that takes
   the kernel at its prompt (62 and 12: a local layer takes it when the
   prompt is longer than its window), telemetry pushes through
   sparse_addto and every decode token counted; the flash lane against
   the plain one (``attn_local``, the band of two window-sized chunks),
   teacher forced, within the arch's tolerance (``SERVES``: twice the
   drift of the two lanes at the reduced width and full depth on the
   CPU); and the first 2 (gemma3: two local layers; 6 before phase v
   came, with its first global one) and 3 (recurrentgemma: two RG-LRU
   layers and a local one) layers at
   full width on the card against the CPU within 2e-2, at a prompt just
   past the window (1 040 and 2 064 tokens, B = 1), so the band, the
   ring pack and the kernel's window run. Kernel 11 joins the kernel
   check at both phases' shapes, (4, 32, 16, 2 048, 128, window 1 024)
   and (2, 16, 1, 4 096, 256, window 2 048). Each phase prints its
   prefill seconds, decode tokens/s, peak memory and the card's busy
   share of a profiled prefill and decode step.
11. Path, phases n and o: serving moonshot-v1-16b-a3b (48 ``moe`` layers:
   global attention at H = KV = 16, D = 128, then 64 experts of d_ff
   1 408 with top-6; 27.722 B parameters, 3.639 B active) on 4 prompts of
   2 048 tokens, and mamba2-780m (48 ``ssd`` layers: 48 SSM heads of 64,
   state 128; 0.780 B parameters) on 4 prompts of 4 096 tokens (16 SSD
   chunks), each at full width and depth with random weights from a seed
   and 32 greedy decode steps, as phases l and m. Checks: 48 and 0 flash
   launches a prefill, telemetry through sparse_addto, every decode
   token counted; for n the flash lane against the plain one within
   6e-2, and 4 layers (1 x 512 tokens, 4 decode steps) on the card
   against the CPU within 2e-2, each second run teacher forced in its
   tokens and in its routing (the first run's expert ids, its own gates:
   a near tie between the 6th and 7th expert flips under bf16 rounding,
   and the script prints the share of (token, layer) pairs and of
   prefill tokens whose own top-6 differed); for o all 48 layers (1 x
   512 tokens, 2 chunks, 4 decode steps) on the card against the CPU
   within 0.3 (``O_CUT_TOL``: a deep random SSD stack amplifies
   rounding). Kernel 11 joins the kernel check at n's prefill shape (4,
   16, 16, 2 048, 128).
12. Path, phases p and q: serving whisper-medium (an encoder of 24
   ``bidir`` layers over 1 500 stub frames, dense non-causal attention,
   and a decoder of 24 ``selfcross`` layers: causal self-attention at H =
   KV = 16, D = 64, then cross-attention to the encoder's output, then a
   GELU MLP; 0.758 B parameters) on 4 prompts of 416 tokens (416 + 32 =
   448, its decoder's context) at full width and depth, and
   llama-3.2-vision-90b (d_model 8 192, 64 heads and 8 KV heads of 128,
   d_ff 28 672) at full width cut to 10 layers, two repeats of its unit
   of 4 ``global`` layers and a ``cross`` layer (attention to 1 024 stub
   patches through ``mproj``), on 4 prompts of 2 048 tokens, each cross
   layer's gate set to 0.5 (it starts at 0, where the layer adds none of
   its attention); 32 greedy decode steps each. Checks: 24 and 8 flash
   launches a prefill, telemetry through sparse_addto, every decode token
   counted; the flash lane against the plain one, teacher forced, within
   the arch's tolerance; for p the whole model (1 x 64 tokens, the 1 500
   frames, 4 decode steps) and for q one unit of 5 layers (1 x 256
   tokens, 4 decode steps) on the card against the CPU within its
   ``cut_tol``. p prints the encoder's share of its prefill. Kernel 11
   joins the kernel check at both prefill shapes, (4, 16, 16, 416, 64)
   and (4, 64, 8, 2 048, 128).
13. Path, phase r: the switch daemon over a real wire, at the paper's
   geometry (32 x 40 000 int32 on the card). r1: a ``SwitchServer`` whose
   register file lives on the card, behind a seeded ``FaultProxy`` that
   drops 5% of the data frames and duplicates and reorders 2.5%; the
   traffic of phases a-d (e's key-by-key window eviction would cost a
   round trip a key) from the two workers of one ``IncRuntime`` whose
   switch is a ``RemoteSwitchMemory`` on one flow, then a second flow
   straight to the daemon that reads the whole register file back.
   Checks: every reply against the fixed-point oracle and bitwise equal
   to the same traffic in process on the CPU, the daemon's registers
   bitwise equal to that run's; the daemon launched sparse_addto (kernel
   4, from its handler threads) and nothing launched any other kernel; no
   handler raised, no flow degraded or fell back, no effect applied
   twice. Prints each phase's round latency (p50, p99) over the wire
   beside the same traffic in process on the card, the proxy's frames,
   each flow's retransmits and reconnects, and the daemon's stats. r2:
   ``python -m repro_torch.launch.elastic --wire-quorum --wire-loss
   0.05`` as a process at the same geometry (a daemon and two worker
   processes on the card, each worker adding 262 144 int32 a step for 24
   steps, the daemon SIGTERM'd and respawned from its spool mid-run):
   exits 0 with every vote and gradient exact, every step committed, no
   effect applied twice, and some worker reconnected (the restart landed
   in the traffic).

14. Path, phase s: the paper's applications, ``repro_torch.examples``,
   through their ``main`` on the card. s1: mapreduce (two mappers reduce
   a corpus in-network), monitoring (200 zipf probe bursts into a 512-slot
   partition through the async runtime, with its shipped drain policy,
   obs and tracing on), paxos (50 ballots, CntFwd vote counting on two
   channels) and train_telemetry (32 metric pushes folded 4 at a time),
   then the same four on the CPU. Checks: each example's own asserts; the
   card's runs equal the CPU's (the reduced dict and top 5; the counts,
   hot flows, capacity, 201 drained calls and 200 probes; one commit a
   ballot and 50 learner messages; the sums, mid-run read and 32 folds,
   ``inc_local_folds_total == local_folds - flushes``); monitoring's hit
   ratio, batches and triggers and train_telemetry's flushes equal where
   neither run cut a batch by time (the drain's ``max_delay`` ties them to
   the host's speed), else each keeps the example's invariants; the card's
   runs launched sparse_addto and no plain version. Prints monitoring's
   triggers and hit ratio, paxos's proposals/s and commit p50/p99 on the
   card and on the CPU, and train_telemetry's folds and flushes. s2:
   train_mini at full size (8 layers, d_model 512, vocab 8 192: 28 326 400
   parameters; B = 16 x S = 128 bigram tokens) for 280 steps in netrpc and
   in xla-psum (``--compare``). Checks: in each mode the last loss at
   least ``MINI_FALL`` below the first and above the chain's entropy
   floor; the final losses within ``MINI_GAP`` of each other; one
   quantize, sat_add and dequantize launch per scattered leaf and netrpc
   step. Prints each mode's median warm step.
15. Path, phase t: the fsdp mode of the train step on the card
   (``train_loop(mode="fsdp")``): qwen2.5-3b at full width and all 36
   layers, netrpc (precision 8), on a ``(data=1, model=1)`` mesh (the
   machine has one card: the several-rank paths run on gloo in the
   tests), phase j's B = 2 x S = 1 024 uniform tokens and 3 steps. The
   params are stored scattered (whole, at one rank) and gathered layer by
   layer inside each layer's checkpoint; each gather's backward is the
   INC reduce-scatter, so every stacked scattered leaf launches quantize,
   sat_add and dequantize once a layer and microbatch, and every other
   scattered leaf once a microbatch. Checks: phase j's oracle; each
   step's loss within ``FSDP_TOL`` (2e-3, the reference's
   fsdp-vs-zero1 bound, ``tests/multidevice/md_train_equiv.py:52``) of
   phase j's zero1 netrpc loss on the same seed and batches; the three
   launch counts equal that reckoning; then one fsdp netrpc step at 1
   full-width layer (B = 2, S = 256) on the card and on the CPU, held as
   phase j's. Prints the warm step, one step's stage times (CUDA events)
   and the peak device memory, beside the card's name and power limit.

16. Path, phase u: the serve step's sequence-sharded decode and q8
   gather on the card. u1: qwen2.5-3b at full width and depth, 1 prompt
   of 2 048 tokens, then 8 greedy decode steps with ``seq_axes`` set to
   a one-rank NCCL mesh's data axes (the partial-softmax combine's pmax
   and two psums run over one rank) and the same 8 steps from a copy of
   the cache without: logits and caches bitwise equal. u2: phase q's
   model and shapes in fsdp with ``q8=True`` (every layer's params and
   the non-stacked leaves through ``all_gather_dim_q8`` at each call),
   fed q's tokens: prints max|q8 - plain| / max|plain| of the logits
   against q's run, the top-1 agreement, prefill seconds, decode tokens/s
   and peak memory, and fails if the logits are q's bit for bit; then
   q's first 2 layers (both global; 1 x 256 tokens, 1 decode step) with
   q8 on the card against the CPU within q's ``cut_tol``. One card is one rank: the
   combine and the gathers over several ranks run on gloo in the tests.
17. Path, phase v: tensor parallelism. qwen2.5-3b at full width (d_model
   2 048, 16 query heads, 2 KV heads, d_ff 11 008, vocab 152 064 padded)
   and 2 layers: the prefill program on 2 x 256 tokens, 2 teacher-forced
   decode steps and one netrpc train step (B=2 x S=256), on the card at
   one rank, while 4 spawned gloo ranks do the same work on the host's
   CPU over a (1, 4) mesh (each rank 4 query heads and the one KV head
   they read, a quarter of the ff dim and of the vocab). Checks: 2 flash
   launches; the logits of every step within phase i's card-vs-CPU
   tolerance; loss, gnorm, the masters' update and m and v within phase
   j's. One card is one rank: the card runs the one-rank path, and the
   tensor-parallel ranks' kernel shapes are in the flash check.
18. Path, phase w: tensor parallelism of the other block types, phase v's
   machinery over a (1, 2) mesh of 2 gloo ranks on the host's CPU against
   the card at one rank, each model at full width: whisper-medium with 1
   ``bidir`` encoder layer over the 1 500 stub frames and 1 ``selfcross``
   decoder layer, mamba2-780m at 2 ``ssd`` layers (each with one netrpc
   train step at B=2 x S=128), and recurrentgemma-9b's first 3 layers
   (``rglru``, ``rglru``, ``local``; serve only, its decode program 2 048
   positions long so the local ring holds its window); the prefill
   program on 2 x 128 tokens and 2 teacher-forced decode steps. Checks:
   1 flash launch (whisper's selfcross prefill), the logits and the step
   within phase v's tolerances; prints its seconds against its budget
   of 120 s from the spawn of the CPU ranks.
19. Phase x (run after j): the dry run (``launch/dryrun.py``'s
   ``count_program``) in a child process on a fake world of one rank:
   ``roofline.analysis``'s counter over phase i's prefill program and
   phase j's netrpc train step, on the meta device at their shapes.
   Checks: kernel 11's records a prefill equal i's launches (36), kernels
   7/6/8's a step j's launches over its 3 steps (14 each), the dry run's
   peak within 15% of i's and j's ``max_memory_allocated``, and 30 s.
   Prints the FLOPs, HBM bytes, roofline time and peak beside the
   measured seconds and peak, the roofline share (the larger of the
   compute and memory terms over the measured seconds) and the card's
   ``total_memory``.
20. Path, phase y (after w): training beyond qwen2.5-3b, through
   ``train_loop`` in each arch's own mode (``rules.mode_for``) on uniform
   tokens. whisper-medium at full width and depth (24 ``bidir`` encoder
   layers over 1 500 stub frames, not checkpointed, and 24 ``selfcross``
   decoder layers; B = 2 x S = 448) and mamba2-780m (48 ``ssd`` layers;
   B = 2 x S = 1 024, 4 SSD chunks): 3 steps in netrpc and 3 in
   fp32-ring from the same state; then one netrpc step at full width of
   gemma3-27b's first 2 layers (``local``, window 1 024, at 1 x 2 048),
   recurrentgemma-9b's first 3 (``rglru``, ``rglru``, ``local``; 1 x
   2 048) and moonshot-v1-16b-a3b's first 2 ``moe`` layers (2 x 1 024).
   Checks: j's oracle with each model's step-0 window (``Y_STEP0``; j's
   for the deep stacks), netrpc against fp32-ring within 1e-3, one
   quantize, sat_add and dequantize launch a scattered leaf and step, no
   flash launch, telemetry through sparse_addto. The blind check of
   moonshot-v1-16b-a3b's window: its cut drawn from a second seed
   (``Y_BLIND_SEED``), step 0's loss held to ``Y_STEP0`` as written, seed
   0's forward held to the loss Y_CUT's run read. Then one netrpc step of
   each family's reduced config (mamba2-780m, gemma3-27b,
   recurrentgemma-9b, moonshot-v1-16b-a3b, llama-3.2-vision-90b in fsdp
   with its cross gates at 0.5, whisper-medium) on the card and on the
   CPU from the same state, held as j's 1-layer step, moonshot's CPU
   routing teacher forced to the card's. Prints each model's layers,
   d_model, B x S, seconds, losses, warm step, tokens/s, peak memory,
   scattered leaves and launches, and the phase's seconds against its
   budget of 180 s.
21. Path, phase z (after x): phase j's netrpc run through the flash
   kernels, ``train_loop(flash=True)`` (the reference's train step under
   ``REPRO_FLASH_ATTN=1``): qwen2.5-3b at full width and all 36 layers,
   B = 2 x S = 1 024 uniform tokens, j's seed, 3 steps, every layer's
   causal attention through kernel 11 (with its lse) and the three
   backward kernels inside each layer's checkpoint. Checks: j's oracle;
   each step's loss within ``Z_LOSS_RTOL`` (5e-3, relative) of j's
   netrpc loss; step 0's gnorm within ``Z_GNORM_RTOL`` (3e-3) of j's and
   the Adam first moment m of every attention leaf after the run within
   ``Z_M_RTOL`` (0.2, relative norm) of j's, the checks of the backward
   (a zeroed or negated dK, a zeroed dQ or dV fails both at the reduced
   width on the CPU); launches 72 of kernel 11 and 36 of each backward
   kernel a step, kernels 7/6/8 once a scattered leaf and step; the peak
   device memory within 15% of the dry run's for the same step
   (``dryrun_start(z=True)``, a child process started in phase x). Prints
   the warm step, tokens/s and peak beside j's and the dry run's; then
   the profile of one step (the card's busy share, the top kernels and
   the flash kernels, the device time of its three stages), which phase
   j ran on the plain lane before phase z came.

Launch counts are set to 0 just before each path run on the card and read
just after it; every kernel must have launched in the path. The two
scatters also record the lane and the k of each launch: every path launch
must take the cluster lane. After the path, both are timed again at the
median k of their path launches, in both cases.

Prints the card's name and power limit beside the kernel times and
before the last line, one JSON line of kernel results, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, at the first failure or when no CUDA device is present.
"""
import contextlib
import copy
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the H100's peak terms and kernel 11's work, as the dry run counts them
from repro_torch.roofline import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.roofline import PEAK_FLOPS as BF16_FLOPS  # noqa: E402
from repro_torch.roofline import flash_work  # noqa: E402
from repro_torch.roofline.flash_model import flashed_layers  # noqa: E402
SEG = 40_000                   # slots per register segment (paper §6.1)
SCATTER_K = 65_536
PRECISION = 8
WORKERS, ROUNDS = 2, 4
# (label, partition slots, gradient length, device-resident, service)
PHASES = (("a_dense_one_segment", 40_000, 40_000, True, "grad"),
          ("b_dense_seven_segments", 262_144, 262_144, True, "grad"),
          ("c_quickstart_cntfwd", 65_536, 65_536, True, "quickstart"),
          ("d_host_lane", 262_144, 262_144, False, "grad"),
          ("e_spill_regrant", 32_768, 65_536, True, "grad"))
LOCAL_ACCUM, LA_SLOTS, LA_CALLS = 8, 262_144, 16     # phase f
# phase r: phases a-d over the wire (e's key-by-key end_window would cost
# a round trip a key), through a proxy that drops WIRE_LOSS of the data
# frames and duplicates and reorders half as many; then the --wire-quorum
# demo as processes at the same geometry, each worker adding a gradient
# of phase b's length a step for WIRE_STEPS steps (at the demo's 6 the
# workers on the card finished before the daemon's SIGTERM landed: no
# reconnect, no op in flight across the restart)
WIRE_LABELS = tuple(p[0] for p in PHASES[:4])
WIRE_LOSS, WIRE_GRAD_SLOTS, WIRE_STEPS = 0.05, 262_144, 24
BUCKET = 6_553_600     # 25 MiB fp32: PyTorch DDP's default bucket_cap_mb
FOLD_ROUNDS, BATCH_ROWS = 8, 16
MODES = ("xla-psum", "fp32-ring", "netrpc", "netrpc-opt")
ARCH = "qwen2.5-3b"     # phases i and j
# phase o's card vs CPU of mamba2-780m: a deep random SSD stack amplifies
# rounding (at the reduced width, the SSD chunk alone changed from 256 to
# 128, the same math in another fp32 order, moves the 48-layer logits by
# 0.14 to 0.28), so the tolerance is twice the largest drift that change
# makes on an H100 at full width and all 48 layers, ``cut_drift``: 0.087,
# 0.069 and 0.152 over three weight draws (the card against the CPU:
# 0.073, 0.079 and 0.129); the cut holds 8 of the 48 layers, whose drift
# is smaller
O_CUT_TOL = 3e-1
# card vs CPU, the other serve phases' cuts; whisper-medium's 48 layers
# hold it too (0.0128 and 0.0111 over two draws on an H100, where the
# plain attention against the flash kernel on the card alone moves them
# 0.0120: ``cut_drift('p')``)
CPU_TOL = 2e-2
# whisper-medium and llama-3.2-vision-90b (10 layers, gates 0.5): the flash
# vs plain lane drift at the reduced width and the phase's depth on the
# CPU (``lane_drift``, three draws) was 1.1e-2 to 1.4e-2 and 2.1e-2 to
# 3.5e-2; each tolerance is twice the largest
P_LANES_TOL = 3e-2
Q_LANES_TOL = 7e-2
# the serve phases at full width and depth: prompt x batch, greedy decode
# steps, the flash vs plain lane tolerance at full depth (max|d| / max|ref|
# of the logits over the steps, teacher forced: about twice the drift of
# the two lanes at the reduced width and the model's full depth on the
# CPU, at the same batch, 32 decode steps and a prompt of twice the
# window, three weight draws: qwen2.5-3b 3.0e-2 (2.7e-2 to 3.5e-2 in a
# later run), gemma3-27b 3.4e-2 to 4.4e-2, recurrentgemma-9b 2.9e-2 to
# 4.2e-2; moonshot-v1-16b-a3b 2.5e-2 to 2.7e-2 with the plain lane's
# routing teacher forced to the flash lane's, ``forced_run``: unforced,
# bf16 rounding flips near ties between experts, and the two lanes then
# differ by 0.21 to 0.24 at the reduced width and for more than 99% of
# the prompt tokens in some layer on the card at full width),
# and the cut that runs on the card and on the CPU (layers, prompt, batch,
# decode steps; each holds every leaf kind of its model's layers, and a
# decode step: on the CPU each one streams every weight of the cut): for
# i two layers at 64 tokens; for l one local layer and for m the first
# three (rglru, rglru, local), each at a prompt just past the window, so
# the band, the ring pack and the kernel's window run; for n two layers;
# for o 8 layers at two SSD chunks; for p two decoder and two encoder
# layers (``cut_enc``) over the full 1 500 frames; for q one pattern unit
# at 64 tokens; and the cut's tolerance. mamba2-780m has no
# attention, so no lane tolerance. ``layers`` cuts a phase's own depth
# (llama-3.2-vision-90b's 100 layers hold 88 B parameters, more than one
# card: 10 are two repeats of its unit) and ``gate`` sets every cross
# layer's gate after the draw (it starts at 0, where tanh(0) adds none of
# the layer's attention)
SERVES = {
    "i": dict(arch=ARCH, prompt=2048, decode=32, batch=4, lanes_tol=6e-2,
              cut=2, cut_prompt=64, cut_batch=2, cut_decode=2,
              cut_tol=CPU_TOL),
    "l": dict(arch="gemma3-27b", prompt=2048, decode=32, batch=4,
              lanes_tol=9e-2, cut=1, cut_prompt=1040, cut_batch=1,
              cut_decode=1, cut_tol=CPU_TOL),
    "m": dict(arch="recurrentgemma-9b", prompt=4096, decode=32, batch=2,
              lanes_tol=9e-2, cut=3, cut_prompt=2064, cut_batch=1,
              cut_decode=1, cut_tol=CPU_TOL),
    "n": dict(arch="moonshot-v1-16b-a3b", prompt=2048, decode=32, batch=4,
              lanes_tol=6e-2, cut=2, cut_prompt=512, cut_batch=1,
              cut_decode=1, cut_tol=CPU_TOL),
    "o": dict(arch="mamba2-780m", prompt=4096, decode=32, batch=4,
              lanes_tol=None, cut=8, cut_prompt=512, cut_batch=1,
              cut_decode=1, cut_tol=O_CUT_TOL),
    "p": dict(arch="whisper-medium", prompt=416, decode=32, batch=4,
              lanes_tol=P_LANES_TOL, cut=2, cut_enc=2, cut_prompt=64,
              cut_batch=1, cut_decode=1, cut_tol=CPU_TOL),
    "q": dict(arch="llama-3.2-vision-90b", layers=10, gate=0.5, prompt=2048,
              decode=32, batch=4, lanes_tol=Q_LANES_TOL, cut=5,
              cut_prompt=64, cut_batch=1, cut_decode=1, cut_tol=CPU_TOL),
}
# phase u1: qwen2.5-3b at full width and depth, one prompt, then U1_STEPS
# decode steps with the cache's positions sharded over the one-rank mesh's
# data axes (the partial-softmax combine's pmax and psums over NCCL) and
# the same steps without
U1_PROMPT, U1_STEPS = 2048, 8
# phase u2: phase q's model and shapes in fsdp with the int8 gather (q8),
# fed q's tokens; the card against the CPU at q's tolerance and q's cut
# prompt, the first U2_CUT layers (a global one; 5, q's cut, before phase
# v came) and U2_CUT_DECODE decode steps: on the CPU every
# call quantizes every parameter of the cut (2.9 B at 1 layer, most of
# them the embedding and the lm_head), so the cut keeps to one decode step
U2_CUT, U2_CUT_DECODE = 1, 1
KEEP_SERVED = ("q",)
SERVED: dict = {}      # phase q's tokens and logits, for phase u2
# phases v and w: tensor parallelism. Each case is a model at full width cut
# to ``layers`` (whisper's encoder to ``enc_layers``): a prefill of batch x
# prompt tokens, ``decode`` teacher-forced decode steps of a decode program
# whose cache holds ``total`` positions (a local layer's ring holds its
# window once the program's length reaches it: recurrentgemma-9b's 2 048)
# and, where ``seq`` is set, one netrpc train step (batch x seq), on the
# card at one rank and
# on the host's CPU over the gloo ranks of a (1, ranks) mesh, held within
# phase i's (logits) and phase j's (the step) card-vs-CPU tolerances.
# v: qwen2.5-3b over 4 ranks (4 query heads and 1 KV head a rank, the
# mixed case); w: over 2 ranks, whisper-medium (a bidir encoder layer and
# a selfcross decoder layer over the 1 500 stub frames), mamba2-780m (two
# ssd layers) and recurrentgemma-9b's first three layers (rglru, rglru,
# local; serve only: its AdamW state at full width would not fit the CPU
# ranks' budget)
TP_CASE = ("arch", "layers", "enc_layers", "batch", "prompt", "decode",
           "total", "seq")
V_CASES = ((ARCH, 1, None, 1, 64, 2, 66, 64),)
W_CASES = (("whisper-medium", 1, 1, 1, 64, 2, 66, 64),
           ("mamba2-780m", 2, None, 2, 128, 2, 130, 128),
           ("recurrentgemma-9b", 3, None, 1, 64, 2, 2048, None))
V_MODEL, W_MODEL = 4, 2
V_TIMEOUT = 300        # the CPU ranks' limit, seconds
W_BUDGET = 120         # phase w's seconds from the spawn of its CPU ranks
# phase s: the runtime examples of s1, and s2's train_mini: its steps, the
# fall of the loss over them (first - last, each mode), the bound on the
# netrpc - xla-psum final-loss gap (set before the first run on the card).
# 280 steps (300 before the cut that pays for phase y's blind check and
# the sixth flash backward check shape: 0.27 s a step)
S_EXAMPLES = ("mapreduce", "monitoring", "paxos", "train_telemetry")
MINI_STEPS, MINI_FALL, MINI_GAP = 280, 1.0, 5e-2
# phase j: train at full width; the card-vs-CPU step (j's and t's) at 1
# layer (2 before phase v came) and TRAIN_SMALL_SEQ tokens a row: its CPU
# time is mostly the per-parameter work of the 311 M-parameter embedding,
# not the tokens
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 36, 1024, 2, 3
# phase t: fsdp against phase j's zero1 netrpc losses, absolute, each step
# (md_train_equiv.py's fsdp-vs-zero1 bound)
FSDP_TOL = 2e-3
TRAIN_J: dict = {}     # phase j's netrpc losses (phases t and z), step-0
#                        gnorm and attention leaves' m on the host (phase z)
# phase x: the dry run of i's prefill program and j's train step on the
# meta device, against i's and j's measured seconds, peaks and launches
# (kernel 11 a prefill, kernels 7/6/8 a step); the peaks within X_PEAK_RTOL
MEASURED: dict = {}
X_PEAK_RTOL, X_BUDGET = 0.15, 30.0
DRY_Z: dict = {}       # phase z's dry run child, started by phase x
TRAIN_SMALL_LAYERS, TRAIN_SMALL_SEQ, TRAIN_CPU_STEP = 1, 64, 5
# step 0's loss within [ln(vocab) - STEP0_BELOW, ln(vocab) + STEP0_ABOVE]
STEP0_BELOW, STEP0_ABOVE = 0.5, 1.5
# phase y: training beyond qwen2.5-3b on the card, through ``train_loop``
# in the arch's own mode (``rules.mode_for``), uniform tokens. Y_FULL at
# full width and depth, Y_STEPS steps in netrpc and in fp32-ring from the
# same state: whisper-medium (24 ``bidir`` encoder layers over the 1 500
# stub frames, not checkpointed, as in the reference; 24 ``selfcross``
# decoder layers) at B=2 x S=448, its decoder's context, and mamba2-780m
# (48 ``ssd`` layers) at B=2 x S=1 024, 4 SSD chunks. Y_CUT at full width
# and cut depth, one netrpc step: gemma3-27b's first 2 layers (both
# ``local``, window 1 024 < S), recurrentgemma-9b's first 3 (``rglru``,
# ``rglru``, ``local``) and moonshot-v1-16b-a3b's first 2 ``moe`` layers
# (the sort dispatch's backward and the aux loss). (arch, layers or None
# for all, B, S)
Y_FULL = (("whisper-medium", None, 2, 448), ("mamba2-780m", None, 2, 1024))
Y_CUT = (("gemma3-27b", 2, 1, 2048), ("recurrentgemma-9b", 3, 1, 2048),
         ("moonshot-v1-16b-a3b", 2, 2, 1024))
Y_STEPS = 3
# step 0's loss of each Y_CUT run, [low, high]. At init every logit but
# the input token's own is about N(0, 1) (unit-RMS final norm, embedding
# rows of unit norm), so on uniform targets the loss is about
# ln(e^a + (V - 1) e^0.5), a = sqrt(d_model) cos, cos the share of the
# input token's own embedding left in the last layer's output (a tied
# embedding). ``step0_loss`` measures cos at the reduced width with the
# cut's layers, window, vocab, experts and shape (it barely moves with the
# width: the layers' outputs are near orthogonal to the embedding) and
# predicts the loss at full width, three draws: gemma3-27b 55.303, 55.999,
# 55.493; recurrentgemma-9b 32.300, 31.874, 30.264; moonshot-v1-16b-a3b
# 41.538, 41.592, 41.589. The five step-0 losses the card measured before
# (PR 34's phases v, j and w: qwen2.5-3b at 1 layer 37.282 and 37.372 and
# at 36 layers 12.485, whisper-medium at 1 + 1 layers 20.493, mamba2-780m
# at 2 layers 22.609) lay within 0.25 of their draws' range. Each window
# is the range widened by 1.5 on each side. gemma3-27b's and
# recurrentgemma-9b's were set before their first run on the card (which
# gave 55.799 and 32.618); moonshot-v1-16b-a3b's was NOT: its first
# window, [35.9, 39.2], came from a prediction that took the reduced
# config's 4 experts and top-2 (37.479 to 37.651), the card gave 41.792,
# and the prediction with the model's 64 experts and top-6 (a gated sum of
# 6 adds less to the residual than one of 2), made after that reading,
# gives the window below. Y_FULL's deep stacks keep cos near 0.13 (a < 5):
# about 0.5 above ln(vocab) (whisper-medium 11.357, mamba2-780m 11.331, as
# j's 12.485 at 36 layers), inside j's window of ln(vocab) - 0.5 to + 1.5
Y_STEP0 = {"gemma3-27b": (53.8, 57.5), "recurrentgemma-9b": (28.7, 33.8),
           "moonshot-v1-16b-a3b": (40.0, 43.1)}
# the blind check of moonshot-v1-16b-a3b's window, set after the card read
# the draw of seed 0 (Y_CUT's, 41.792): its cut (arch, layers, B, S) drawn
# from Y_BLIND_SEED, step 0's loss (the train step's forward on
# ``train_loop``'s first batch, before any update) held to Y_STEP0's window
# as written (``step0_loss``'s prediction for this draw is in PERF.md)
Y_BLIND = next(c for c in Y_CUT if c[0] == "moonshot-v1-16b-a3b")
Y_BLIND_SEED = 1
Y_READ: dict = {}      # arch -> step 0's loss of its Y_CUT run, as read
# then one netrpc step of each family's reduced config (its pattern unit
# once, ``ArchConfig.reduced``) in its own mode on the card and on the CPU,
# held as j's step: B=TRAIN_BATCH x S=Y_PAIR_SEQ, twice the reduced window
# (the band narrower than S); llama-3.2-vision-90b's cross gate set to
# Y_GATE (0, as drawn, adds none of the layer's attention and passes no
# gradient to it); moonshot's CPU routing teacher forced to the card's
Y_PAIRS = ("mamba2-780m", "gemma3-27b", "recurrentgemma-9b",
           "moonshot-v1-16b-a3b", "llama-3.2-vision-90b", "whisper-medium")
Y_PAIR_SEQ, Y_GATE = 64, 0.5
Y_BUDGET = 180         # phase y's seconds
MODES_TOL = 1e-3       # netrpc vs fp32-ring loss, relative, each step
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 1e-3, 1e-2     # card vs CPU
MASTER_FLIP_FRAC = 0.02   # card vs CPU masters more than lr/100 apart
MV_RTOL = 3e-2         # card vs CPU m and v, per leaf, relative norm
RAGGED = BUCKET - 1000    # phase k: a stream that pads to whole tiles
SEED = 0
PROFILE_TRIES = 3      # profiles of one timing before it falls back to events
FLASH_ATOL, FLASH_RTOL = 2e-2, 5e-2
# (B, H, KV, S, D, window): qwen2.5-3b's prefill (phase i), gemma3's window
# at qwen's heads, ragged S, recurrentgemma-9b's local layer at B = 1, and
# the shapes of phases l and m: gemma3-27b's local layers (H = 32, KV = 16)
# and recurrentgemma-9b's (MQA, D = 256) at their prompts, phase n's
# moonshot-v1-16b-a3b prefill (H = KV = 16), phase p's whisper-medium
# decoder (H = KV = 16 at D = 64, S = 416) and phase q's
# llama-3.2-vision-90b global layers (H = 64, KV = 8); then a
# tensor-parallel rank's shapes: qwen2.5-3b's prefill at model 2 (8 query
# heads, 1 KV head) and at model 4 (4 query heads and the one KV head they
# read), phase l's local layers at model 2 and phase n's prefill at model 2;
# then at model 2 phase p's whisper-medium decoder (8 heads), phase q's
# llama-3.2-vision-90b global layers (32 query heads, 4 KV heads) and
# phase m's recurrentgemma-9b local layers (8 query heads reading its one
# KV head, whole)
FLASH_CHECKS = ((4, 16, 2, 2048, 128, None), (4, 16, 2, 2048, 128, 1024),
                (2, 16, 2, 1000, 128, None), (1, 16, 1, 4096, 256, 2048),
                (4, 32, 16, 2048, 128, 1024), (2, 16, 1, 4096, 256, 2048),
                (4, 16, 16, 2048, 128, None), (4, 16, 16, 416, 64, None),
                (4, 64, 8, 2048, 128, None), (4, 8, 1, 2048, 128, None),
                (4, 4, 1, 2048, 128, None), (4, 16, 8, 2048, 128, 1024),
                (4, 8, 8, 2048, 128, None), (4, 8, 8, 416, 64, None),
                (4, 32, 4, 2048, 128, None), (2, 8, 1, 4096, 256, 2048))
# the backward kernels (csrc/flash_attn_bwd.cu) against their plain version
# (``ref.flash_bwd``: fp32 math on the kernels' bf16 inputs, lse and delta),
# (B, H, KV, S, D, window): phase z's train shape (j's: qwen2.5-3b, B=2 x
# S=1 024), gemma3-27b's local layers, whisper-medium's decoder,
# recurrentgemma-9b's local layer, one at D = 32 (the reduced configs'
# head dim) and phi4-mini-3.8b's (a group of 3 query heads: a cluster of 3
# in dK/dV, rows split 22, 22, 20). Each of dq, dk and dv within
# FLASH_BWD_TOL of max|plain|: the
# kernels round P and dS to bf16 before the products that take them and
# store bf16, which ``ref.flash_bwd(round_to=bf16)`` emulates on the CPU
# 2.6e-3 to 4.3e-3 from the fp32 gradient at these shapes
# (tests/test_torch_flash_train.py); 1.5e-2 was written before the kernels'
# first run on the card. delta (fp32 sums of D products in another order)
# within FLASH_DELTA_RTOL of max|plain|, kernel 11's lse (base 2) within
# FLASH_LSE_ATOL. Each is timed beside the backward of
# scaled_dot_product_attention (dq, dk and dv in one call, the yardstick;
# a window as a boolean mask) and its plain version
FLASH_BWD_CHECKS = ((2, 16, 2, 1024, 128, None),
                    (1, 32, 16, 2048, 128, 1024),
                    (2, 16, 16, 448, 64, None),
                    (1, 16, 1, 4096, 256, 2048),
                    (2, 16, 2, 1024, 32, None),
                    (1, 24, 8, 2048, 128, None))
FLASH_BWD_TOL, FLASH_DELTA_RTOL, FLASH_LSE_ATOL = 1.5e-2, 1e-4, 1e-3
BWD_KERNELS = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")
# phase z: phase j's train step through kernel 11 and its backward kernels
# (``train_loop(flash=True)``). Each step's loss within Z_LOSS_RTOL
# (relative) of j's netrpc loss at the same step, written before the first
# run on the card: at the reduced width and j's full depth, shape and seed
# on the CPU the two lanes' losses differ by 2.7e-6, 1.5e-4 and 1.5e-4
# (the plain attention against the plain version of the flash lane); on
# the card the kernels also round P (forward and backward) and dS to bf16,
# so about 30 times that, 5 times j's netrpc-vs-fp32-ring MODES_TOL
Z_LOSS_RTOL = 5e-3
# and the backward, which the loss cannot see at this scale (j's losses move
# by 6.4e-3 relative over the three steps): step 0's gnorm within
# Z_GNORM_RTOL (relative) of j's, from the same state and tokens, and the
# Adam first moment m of every attention leaf after the run within Z_M_RTOL
# (||z - j|| / ||j||) of j's. Both written before their first run on the
# card, from tests/test_torch_flash_train.py
# (``test_phase_z_windows_hold_the_kernels_and_fail_a_fault``): at the
# reduced width, j's depth, batch and seed (S cut to 256) the kernels'
# emulated roundings give 6.1e-4 and 4.5e-2, a zeroed or negated dK, a
# zeroed dQ or a zeroed dV 1.6e-2 to 0.34 and 1.0 to 1.9
Z_GNORM_RTOL, Z_M_RTOL = 3e-3, 0.2
REPLACES = {
    "fused_addto": "src/repro/kernels/fused_gpv.py:67",
    "fused_scatter": "src/repro/kernels/fused_gpv.py:113",
    "fused_read": "src/repro/kernels/fused_gpv.py:189",
    "sparse_addto": "src/repro/kernels/sparse_addto.py:38",
    "fused_fold": "src/repro/kernels/fused_gpv.py:153",
    "sat_add": "src/repro/kernels/inc_agg.py:45",
    "sat_add_batch": "src/repro/kernels/ops.py:125",
    "quantize": "src/repro/kernels/quantize.py:34",
    "dequantize": "src/repro/kernels/dequantize.py:30",
    "flash_attention": "src/repro/kernels/flash_attn.py:95",
    # no TPU kernel: the gradient the reference's train step takes under
    # REPRO_FLASH_ATTN=1, JAX's autodiff of its chunked oracle
    "flash_bwd_delta": "src/repro/kernels/flash_attn.py:145",
    "flash_bwd_dkdv": "src/repro/kernels/flash_attn.py:145",
    "flash_bwd_dq": "src/repro/kernels/flash_attn.py:145",
    "pack_int8": "src/repro/kernels/pack_int8.py:28",
    "unpack_int8": "src/repro/kernels/pack_int8.py:54",
}
SOURCE = {
    "fused_addto": "src/repro_torch/kernels/csrc/fused_gpv.cu",
    "fused_scatter": "src/repro_torch/kernels/csrc/fused_gpv.cu",
    "fused_read": "src/repro_torch/kernels/csrc/fused_gpv.cu",
    "sparse_addto": "src/repro_torch/kernels/csrc/sparse_addto.cu",
    "fused_fold": "src/repro_torch/kernels/csrc/fused_gpv.cu",
    "sat_add": "src/repro_torch/kernels/csrc/inc_agg.cu",
    "sat_add_batch": "src/repro_torch/kernels/csrc/inc_agg.cu",
    "quantize": "src/repro_torch/kernels/csrc/quantize.cu",
    "dequantize": "src/repro_torch/kernels/csrc/dequantize.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attn.cu",
    "flash_bwd_delta": "src/repro_torch/kernels/csrc/flash_attn_bwd.cu",
    "flash_bwd_dkdv": "src/repro_torch/kernels/csrc/flash_attn_bwd.cu",
    "flash_bwd_dq": "src/repro_torch/kernels/csrc/flash_attn_bwd.cu",
    "pack_int8": "src/repro_torch/kernels/csrc/pack_int8.cu",
    "unpack_int8": "src/repro_torch/kernels/csrc/pack_int8.cu",
}


# the lane and the k of every scatter launch of the path (counted runs)
PATH_KS = {"sparse_addto": [], "fused_scatter": []}
PATH_LANES = {"sparse_addto": {}, "fused_scatter": {}}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# -- timing -------------------------------------------------------------------

def device_ms(torch, fn, reset, iters: int, match: str = "inc_k_",
              launches: int | None = 1) -> tuple[float, str]:
    """Mean device time of ``fn`` per call: the CUDA time of the kernels
    whose names hold ``match`` (this package's INC kernels by default;
    "" takes every kernel), ``device_ms_parts`` of the one call."""
    return device_ms_parts(torch, {"call": (fn, match, launches)}, iters,
                           reset)["call"]


def device_ms_parts(torch, parts: dict, iters: int,
                    reset=lambda: None) -> dict:
    """Mean device time a call of each of ``parts`` (label -> (fn, match,
    launches)) under the profiler: each iteration runs ``reset`` and a
    part's fn, for every part in turn (several parts share one profile,
    whose set-up costs time); a kernel counts for the first part whose
    match its name holds, "" taking what no other part's match takes. A
    part's time is kept where the profile kept every launch: ``launches``
    matched kernels a call (None: the same unknown number a call, so a
    whole multiple of ``iters``). Events with no device time (the
    runtime's API calls) are not launches. The parts a profile did not
    keep whole are profiled again, PROFILE_TRIES times in all; then CUDA
    events around each call time them instead, and the timer says why.
    Returns {label: (ms, timer)}."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        for fn, _, _ in parts.values():
            reset()
            fn()
    torch.cuda.synchronize()
    out, todo, kept = {}, dict(parts), {}
    shared = " (one profile)" if len(parts) > 1 else ""
    for attempt in range(PROFILE_TRIES):
        named = [(k, m) for k, (_, m, _) in todo.items() if m]
        rest = [k for k, (_, m, _) in todo.items() if not m]
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    for fn, _, _ in todo.values():
                        reset()
                        fn()
                torch.cuda.synchronize()
        except RuntimeError as e:     # a profiler without CUPTI: use events
            print(f"profiler unavailable ({e}); timing with CUDA events",
                  flush=True)
            return {**out, **{k: (event_ms(torch, fn, reset, iters),
                                  "events")
                              for k, (fn, _, _) in todo.items()}}
        us, seen = dict.fromkeys(todo, 0.0), dict.fromkeys(todo, 0)
        keys = {k: {} for k in todo}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total",
                        getattr(ev, "cuda_time_total", 0.0))
            label = next((k for k, m in named if m in ev.key),
                         rest[0] if rest else None)
            if t > 0 and label is not None:
                us[label] += t
                seen[label] += ev.count
                keys[label][ev.key[:48]] = ev.count
        for k, (_, _, launches) in list(todo.items()):
            want = iters * launches if launches is not None else None
            if us[k] > 0 and (seen[k] == want if want is not None
                              else seen[k] % iters == 0):
                out[k] = (us[k] / iters / 1e3, "cupti" + (
                    f" (try {attempt + 1})" if attempt else "") + shared)
                del todo[k]
            else:
                kept[k] = (f"cupti kept {seen[k]} of " + (
                    str(want) if want is not None
                    else f"a multiple of {iters}"), keys[k])
        if not todo:
            return out
    for k, (fn, _, _) in todo.items():
        print(f"device_ms {k}: {kept[k][0]} in {PROFILE_TRIES} tries (last: "
              f"{kept[k][1]}); timing with CUDA events", flush=True)
        out[k] = (event_ms(torch, fn, reset, iters), f"events ({kept[k][0]})")
    return out


def check_bounds(kernels) -> None:
    """Fails on any time of ``kernels`` below its bound: a row's key X_ms
    is held to P + "bound_ms" for the longest prefix P of X that has one
    (the row's own ``bound_ms`` at the end). No card beats its bound, so
    such a time means the timer failed."""
    for row in kernels:
        for key, ms in row.items():
            if ms is None or key.endswith("bound_ms") or not (
                    key == "ms" or key.endswith("_ms")):
                continue
            parts = key.split("_")
            bound = next(b for b in ("_".join(parts[:i] + ["bound_ms"])
                                     for i in range(len(parts) - 1, -1, -1))
                         if b in row)
            if ms < row[bound]:
                fail(f"kernel {row['name']}: {key}={ms:.6f} is below "
                     f"{bound}={row[bound]:.6f} ({row.get('timer')}): the "
                     f"timer failed")
    print("kernel times: none below its bound", flush=True)


def loop_ms(torch, fn, iters: int) -> float:
    """CUDA events around ``iters`` back-to-back calls, per call."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def event_ms(torch, fn, reset, iters: int) -> float:
    """Median of CUDA-event times around single calls (host dispatch
    included); ``reset`` runs outside the timed window."""
    times = []
    for i in range(iters + 2):
        reset()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        if i >= 2:
            times.append(s.elapsed_time(e))
    return statistics.median(times)


# -- phase 2: kernels against their plain versions ----------------------------

def kernel_inputs(rng):
    """Segment registers, a dense fp32 stream and a k=65 536 scatter at
    the path's shapes: gradient-sized values, hot duplicate slots, a few
    sentinels and saturating updates."""
    regs = rng.randint(-10 ** 7, 10 ** 7, SEG).astype(np.int32)
    regs[rng.choice(SEG, 8, replace=False)] = [2 ** 31 - 1, -(2 ** 31 - 1),
                                               2 ** 31 - 2, -(2 ** 31 - 2),
                                               -2 ** 31, 0, 2 ** 30, -2 ** 30]
    dense = (rng.randn(SEG) * 0.05).astype(np.float32)
    dense[:4] = [2.0 ** 31 / 1e8, -2.0 ** 31 / 1e8, 0.5e-8, 1.5e-8]
    idx = rng.randint(0, SEG, SCATTER_K).astype(np.int32)
    idx[:8192] = rng.randint(0, 256, 8192)                 # hot duplicates
    ivals = rng.randint(-10 ** 6, 10 ** 6, SCATTER_K).astype(np.int32)
    sat = rng.choice(SCATTER_K, 512, replace=False)
    ivals[sat] = 2 ** 30                                   # saturating
    fvals = (rng.randn(SCATTER_K) * 0.05).astype(np.float32)
    fvals[sat] = 12.0                                      # 1.2e9 each
    return regs, dense, idx, ivals, fvals


def int_stream(rng, shape):
    """int32 values of gradient size, with both sentinels, the SAT edges,
    -2**31 and half-range values that overflow when two meet."""
    q = rng.randint(-10 ** 7, 10 ** 7, shape).astype(np.int64)
    flat = q.reshape(-1)
    edges = [2 ** 31 - 1, -(2 ** 31 - 1), 2 ** 31 - 2, -(2 ** 31 - 2),
             -2 ** 31, 2 ** 30 + 1, -(2 ** 30 + 1)]
    pos = rng.choice(flat.size, 1024, replace=False)
    flat[pos] = rng.choice(edges, len(pos))
    return q.astype(np.int32)


def bucket(rng, n=BUCKET) -> np.ndarray:
    """A gradient bucket: N(0, 0.05^2) fp32 with 1% of its lanes at +-30.0
    (3e9 at precision 8, past the int32 range), and a few halfway cases."""
    g = (rng.randn(n) * 0.05).astype(np.float32)
    lanes = rng.choice(n, n // 100, replace=False)
    g[lanes] = rng.choice(np.float32([-30.0, 30.0]), len(lanes))
    g[:4] = np.float32([0.5e-8, 1.5e-8, -2.5e-8, 2.0 ** 31 / 1e8])
    return g


def stream_cases(torch, dev, rng) -> dict:
    """Kernels 5-8 and sat_add_batch at the path's shapes: (kernel, plain,
    bytes moved)."""
    from repro_torch.kernels import dequantize, fused_gpv, inc_agg, quantize
    scale = 10 ** PRECISION
    n_fold = LA_SLOTS
    fstack = (rng.randn(FOLD_ROUNDS, n_fold) * 0.05).astype(np.float32)
    fstack[:, :256] = 15.0                        # 1.5e9 a round: saturates
    fstack[3, 256:264] = 2.0 ** 31 / 1e8          # a sentinel mid-fold
    fstack = torch.from_numpy(fstack).to(dev)
    x = torch.from_numpy(bucket(rng)).to(dev)
    a = torch.from_numpy(int_stream(rng, BUCKET)).to(dev)
    b = torch.from_numpy(int_stream(rng, BUCKET)).to(dev)
    q = torch.from_numpy(int_stream(rng, BUCKET)).to(dev)
    acc = torch.from_numpy(int_stream(rng, SEG)).to(dev)
    qs = torch.from_numpy(int_stream(rng, (BATCH_ROWS, SEG))).to(dev)
    return {
        "fused_fold": (lambda: fused_gpv.fused_fold(fstack, scale),
                       lambda: fused_gpv.fused_fold_plain(fstack, scale),
                       (4 * FOLD_ROUNDS + 4) * n_fold),
        "sat_add": (lambda: inc_agg.sat_add(a, b),
                    lambda: inc_agg.sat_add_plain(a, b), 12 * BUCKET),
        "sat_add_batch": (lambda: inc_agg.sat_add_batch(acc, qs),
                          lambda: inc_agg.sat_add_batch_plain(acc, qs),
                          (4 * BATCH_ROWS + 8) * SEG),
        "quantize": (lambda: quantize.quantize(x, scale),
                     lambda: quantize.quantize_plain(x, scale), 8 * BUCKET),
        "dequantize": (lambda: dequantize.dequantize(q, scale),
                       lambda: dequantize.dequantize_plain(q, scale),
                       9 * BUCKET),
    }


def check_kernels(torch, smi: str) -> list[dict]:
    from repro_torch.kernels import fused_gpv, sparse_addto
    dev = torch.device("cuda")
    rng = np.random.RandomState(1234)
    regs_np, dense_np, idx_np, ivals_np, fvals_np = kernel_inputs(rng)
    regs0 = torch.from_numpy(regs_np).to(dev)
    dense = torch.from_numpy(dense_np).to(dev)
    idx = torch.from_numpy(idx_np).to(dev)
    ivals = torch.from_numpy(ivals_np).to(dev)
    fvals = torch.from_numpy(fvals_np).to(dev)
    scale = 10 ** PRECISION
    regs = regs0.clone()

    def reset():
        regs.copy_(regs0)

    def same_int(name, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            fail(f"{name}: {bad} registers differ from the plain version")

    cases = {
        "fused_addto": (lambda: fused_gpv.fused_addto(regs, 0, dense, scale),
                        lambda: fused_gpv.fused_addto_plain(regs, 0, dense,
                                                            scale),
                        12 * SEG),
        "fused_scatter": (lambda: fused_gpv.fused_scatter(regs, idx, fvals,
                                                          scale),
                          lambda: fused_gpv.fused_scatter_plain(
                              regs, idx, fvals, scale), None),
        "fused_read": (lambda: fused_gpv.fused_read(regs, 0, SEG, scale),
                       lambda: fused_gpv.fused_read_plain(regs, 0, SEG,
                                                          scale),
                       9 * SEG),
        "sparse_addto": (lambda: sparse_addto.sparse_addto(regs, idx, ivals),
                         lambda: sparse_addto.sparse_addto_plain(
                             regs, idx, ivals), None),
    }
    cases = {k: (*v, reset) for k, v in cases.items()}
    cases.update({k: (*v, lambda: None)
                  for k, v in stream_cases(torch, dev, rng).items()})
    out = []
    for name, (kernel, plain, nbytes, reset_fn) in cases.items():
        reset_fn()
        got = kernel()
        got = tuple(t.clone() for t in got) if isinstance(got, tuple) \
            else got.clone()
        reset_fn()
        want = plain()
        if isinstance(got, tuple):        # (fp32 values, bool mask)
            same_int(name, got[0].view(torch.int32),
                     want[0].view(torch.int32))
            same_int(name + " mask", got[1], want[1])
            err = float((got[0] - want[0]).abs().max())
        else:
            same_int(name, got, want)
            err = float((got.long() - want.long()).abs().max())
        ms, timer = device_ms(torch, kernel, reset_fn, 50)
        plain_ms = event_ms(torch, plain, reset_fn, 5)
        nbytes = nbytes if nbytes is not None else scatter_bytes(idx_np,
                                                                 SCATTER_K)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"kernel {name} on {smi}: ok vs plain, ms={ms:.6f} ({timer}) "
              f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f}", flush=True)
        out.append({"name": name, "route": "cuda", "source": SOURCE[name],
                    "replaces": REPLACES[name], "launches": 0,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": "bytes",
                    "library_ms": None, "timer": timer})
    inputs = (regs_np, idx_np, ivals_np, fvals_np)
    for row in out:
        if row["name"] in SCATTERS:
            t = time_scatter(torch, row["name"], *inputs, SCATTER_K)
            row.update(event_ms=t["event_ms"], common_ms=t["common_ms"],
                       common_event_ms=t["common_event_ms"])
    scatter_yardstick(torch, *common_inputs(*inputs))
    check_scatter_lanes(torch)
    rows = {row["name"]: row for row in out}
    rows["fused_addto"].update(check_addto_runs(torch, smi))
    rows["fused_read"].update(check_read_runs(torch, smi))
    rows["sat_add_batch"].update(check_sat_add_batch(torch, smi))
    return out


# -- phase 2, kernels 2 and 4: the ordered scatter ----------------------------

SCATTERS = ("sparse_addto", "fused_scatter")
# kernel launches of one scatter call on each lane (scatter.cuh)
LANE_LAUNCHES = {"cluster": 1, "large": 5}


def scatter_bytes(idx_np, k) -> int:
    """Bytes the first k updates of a scatter must move: idx and values
    read once, each slot they touch read and written once."""
    return k * 8 + len(np.unique(idx_np[:k])) * 8


def common_inputs(regs_np, idx_np, ivals_np, fvals_np):
    """``kernel_inputs``' scatter with nothing to flag, as on the path: the
    512 saturating values and the 8 sentinel registers replaced by
    ordinary ones, so every slot is safe and pass 3 never runs."""
    rng = np.random.RandomState(4321)
    regs_np, ivals_np, fvals_np = (regs_np.copy(), ivals_np.copy(),
                                   fvals_np.copy())
    hot = np.abs(regs_np.astype(np.int64)) > 10 ** 7
    regs_np[hot] = rng.randint(-10 ** 7, 10 ** 7, int(hot.sum()))
    sat = ivals_np == 2 ** 30
    ivals_np[sat] = rng.randint(-10 ** 6, 10 ** 6, int(sat.sum()))
    fvals_np[sat] = (rng.randn(int(sat.sum())) * 0.05).astype(np.float32)
    return regs_np, idx_np, ivals_np, fvals_np


def scatter_fns(torch, name, regs_np, idx_np, ivals_np, fvals_np, k):
    """(kernel, plain, reset) of scatter ``name`` on the first k updates,
    on the card; both update the same registers, reset restores them."""
    from repro_torch.kernels import fused_gpv, sparse_addto
    dev = torch.device("cuda")
    regs0 = torch.from_numpy(regs_np).to(dev)
    idx = torch.from_numpy(idx_np[:k]).to(dev)
    vals = torch.from_numpy((ivals_np if name == "sparse_addto"
                             else fvals_np)[:k]).to(dev)
    regs = regs0.clone()
    scale = 10 ** PRECISION

    def kernel():
        if name == "sparse_addto":
            return sparse_addto.sparse_addto(regs, idx, vals)
        return fused_gpv.fused_scatter(regs, idx, vals, scale)

    def plain():
        if name == "sparse_addto":
            return sparse_addto.sparse_addto_plain(regs, idx, vals)
        return fused_gpv.fused_scatter_plain(regs, idx, vals, scale)

    return kernel, plain, lambda: regs.copy_(regs0)


def scatter_same(torch, what, kernel, plain, reset) -> None:
    """The kernel's registers bitwise equal to the plain version's."""
    reset()
    got = kernel().clone()
    reset()
    want = plain()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"{what}: {int((got != want).sum())} registers differ from the "
             f"plain version")


def time_scatter(torch, name, regs_np, idx_np, ivals_np, fvals_np,
                 k) -> dict:
    """Scatter ``name`` on the first k updates, on the saturating inputs
    and in the common case: each held bitwise against the plain version,
    then timed (CUPTI, mean of 50) and per call with host dispatch (CUDA
    events, median of 20)."""
    out = {}
    for case, inputs in (("", (regs_np, idx_np, ivals_np, fvals_np)),
                         ("common_", common_inputs(regs_np, idx_np,
                                                   ivals_np, fvals_np))):
        kernel, plain, reset = scatter_fns(torch, name, *inputs, k)
        what = f"{name} k={k} {'common case' if case else 'saturating'}"
        scatter_same(torch, what, kernel, plain, reset)
        ms, timer = device_ms(torch, kernel, reset, 50)
        ev = event_ms(torch, kernel, reset, 20)
        print(f"kernel {what}: ok vs plain, ms={ms:.6f} ({timer}), "
              f"event_ms={ev:.6f} a call", flush=True)
        out[case + "ms"], out[case + "event_ms"] = ms, ev
    return out


def scatter_yardstick(torch, regs_np, idx_np, ivals_np, fvals_np) -> None:
    """``index_add_`` of the same int32 stream into the same registers: a
    plain wrapping scatter-add, no saturation and no order, timed as a
    yardstick of an unsaturated scatter on this card (not the same
    function, so no row's library_ms)."""
    dev = torch.device("cuda")
    regs0 = torch.from_numpy(regs_np).to(dev)
    idx = torch.from_numpy(idx_np).to(dev)
    vals = torch.from_numpy(ivals_np).to(dev)
    regs = regs0.clone()
    ms, timer = device_ms(torch, lambda: regs.index_add_(0, idx, vals),
                          lambda: regs.copy_(regs0), 50, match="index",
                          launches=None)
    print(f"yardstick index_add_ (int32, {len(regs_np)} slots, k="
          f"{len(idx_np)}, no saturation): ms={ms:.6f} ({timer})",
          flush=True)


def lane_inputs(n, k, seed):
    """A scatter of k updates into n slots shaped like ``kernel_inputs``:
    hot duplicate slots, sentinel registers and saturating values."""
    rng = np.random.RandomState(seed)
    regs = rng.randint(-10 ** 7, 10 ** 7, n).astype(np.int32)
    regs[rng.choice(n, 8, replace=False)] = [2 ** 31 - 1, -(2 ** 31 - 1),
                                             2 ** 31 - 2, -(2 ** 31 - 2),
                                             -2 ** 31, 0, 2 ** 30, -2 ** 30]
    idx = rng.randint(0, n, k).astype(np.int32)
    idx[:k // 8] = rng.randint(0, 256, k // 8)
    ivals = rng.randint(-10 ** 6, 10 ** 6, k).astype(np.int32)
    fvals = (rng.randn(k) * 0.05).astype(np.float32)
    sat = rng.choice(k, min(k, 512), replace=False)
    ivals[sat] = 2 ** 30
    fvals[sat] = 12.0
    return regs, idx, ivals, fvals


def check_scatter_lanes(torch) -> None:
    """Both scatters bitwise against their plain versions on either side
    of the cluster lane's limits, each launch counted on the lane its
    size takes; the two sides of the k limit are timed."""
    from repro_torch.kernels import ops, sparse_addto
    lim = sparse_addto.cluster_limits()
    resident = sparse_addto.resident_clusters(torch.device("cuda"))
    print(f"scatter lanes: the cluster lane takes n_slots <= "
          f"INC_CLUSTER_MAX_SLOTS = {lim['max_slots']} and k <= "
          f"INC_CLUSTER_MAX_K = {lim['max_k']}: one launch of "
          f"{lim['clusters']} clusters of {lim['ctas']} CTAs x "
          f"{lim['threads']} threads, at most {lim['smem_bytes']} bytes of "
          f"dynamic shared memory a CTA; {resident} clusters resident at "
          f"once; past either limit the large lane (five launches, global "
          f"scratch)", flush=True)
    cases = ((SEG, SCATTER_K), (262_144, SCATTER_K),
             (lim["max_slots"], SCATTER_K), (lim["max_slots"] + 1, SCATTER_K),
             (SEG, lim["max_k"]), (SEG, lim["max_k"] + 1))
    for i, (n, k) in enumerate(cases):
        lane = sparse_addto.scatter_lane(n, k)
        inputs = lane_inputs(n, k, 100 + i)
        for name in SCATTERS:
            kernel, plain, reset = scatter_fns(torch, name, *inputs, k)
            before = ops.lane_counts()[name][lane]
            what = f"{name} n_slots={n} k={k} ({lane} lane)"
            scatter_same(torch, what, kernel, plain, reset)
            if ops.lane_counts()[name][lane] != before + 1:
                fail(f"{what}: the launch was not counted on its lane")
            timed = ""
            if n == SEG and k >= lim["max_k"]:
                ms, timer = device_ms(torch, kernel, reset, 20,
                                      launches=LANE_LAUNCHES[lane])
                bound_ms = scatter_bytes(inputs[1], k) \
                    / HBM_BYTES_PER_S * 1e3
                timed = f", ms={ms:.6f} ({timer}) bound_ms={bound_ms:.6f}"
                if ms < bound_ms:
                    fail(f"{what}: ms below bound_ms: the timer failed")
            print(f"kernel {what}: ok vs plain{timed}", flush=True)


# -- phase 2, kernels 1 and 6b: one launch a transmit, the batched fold -----

# (first slot, slots) of each run of a multi-segment transmit: phase b's
# (262 144 values over 7 segments), unaligned starts and lengths, and more
# runs than one launch table holds
RUN_CHECKS = (("phase_b", ((0, SEG),) * 6 + ((0, 262_144 - 6 * SEG),)),
              ("unaligned_starts", ((17, 39_983), (3, 20_000), (1, 1),
                                    (39_999, 1), (5, 30_027), (12_345, 27_655),
                                    (7, 39_993))),
              ("past_run_table", tuple((r % 7, 997) for r in range(41))))
# (rows, n) of the batched fold: the clear policies' n and one more, row
# counts on both sides of the kernel's batch of 16 loads
BATCH_CHECKS = tuple((b, n) for b in (2, 3, 16, 17) for n in (SEG, SEG + 1))


def runs_inputs(torch, layout, seed):
    """(registers a run on the card, the fp32 stream the runs read in
    order as numpy, (run, start, foff, n) a run): gradient-sized values,
    sentinel registers and values that saturate at precision 8."""
    rng = np.random.RandomState(seed)
    regs = rng.randint(-10 ** 7, 10 ** 7, (len(layout), SEG)).astype(np.int32)
    regs[0, :8] = [2 ** 31 - 1, -(2 ** 31 - 1), 2 ** 31 - 2, -(2 ** 31 - 2),
                   -2 ** 31, 0, 2 ** 30, -2 ** 30]
    n = sum(k for _, k in layout)
    f = (rng.randn(n) * 0.05).astype(np.float32)
    f[rng.choice(n, 8, replace=False)] = [2.0 ** 31 / 1e8, -2.0 ** 31 / 1e8,
                                          0.5e-8, 1.5e-8, 12.0, -12.0, 30.0,
                                          -30.0]
    offs = np.cumsum((0,) + tuple(k for _, k in layout[:-1]))
    regs0 = [torch.from_numpy(r).to("cuda") for r in regs]
    return regs0, f, [(i, a, int(o), k)
                      for i, ((a, k), o) in enumerate(zip(layout, offs))]


def check_addto_runs(torch, smi: str) -> dict:
    """Kernel 1 over several runs (``ops.device_addto_dense_runs``, the
    multi-segment transmit) bitwise against the plain version, in one
    launch per run table; at phase b's shape timed against the same work
    as one ``fused_addto`` launch a run (CUPTI, and per call with the host
    stream's copies, CUDA events), beside the single-run call."""
    from repro_torch.kernels import fused_gpv, ops
    scale = 10 ** PRECISION
    out = {}
    for seed, (name, layout) in enumerate(RUN_CHECKS):
        regs0, f, spec = runs_inputs(torch, layout, 200 + seed)
        regs = [r.clone() for r in regs0]
        fd = torch.from_numpy(f).to("cuda")
        runs = [(regs[i], a, o, n) for i, a, o, n in spec]

        def reset():
            for r, r0 in zip(regs, regs0):
                r.copy_(r0)

        reset()
        ops.reset_counts()
        ops.device_addto_dense_runs(runs, f, scale)
        torch.cuda.synchronize()
        launches = ops.launch_counts()["fused_addto"]
        got = [r.clone() for r in regs]
        reset()
        fused_gpv.fused_addto_runs_plain(runs, fd, scale)
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got, regs)):
            if not torch.equal(g, w):
                fail(f"fused_addto runs {name}: run {i}: "
                     f"{int((g != w).sum())} registers differ from the plain "
                     f"version")
        tables = -(-len(layout) // fused_gpv.MAX_RUNS)
        if launches != tables:
            fail(f"fused_addto runs {name}: {launches} launches for "
                 f"{len(layout)} runs, not {tables}")
        print(f"kernel fused_addto runs {name} ({len(layout)} runs, "
              f"{len(f)} values): ok vs plain in {launches} launches",
              flush=True)
        if name != "phase_b":
            continue
        ms, timer = device_ms(
            torch, lambda: fused_gpv.fused_addto_runs(runs, fd, scale),
            reset, 50)
        singles_ms, _ = device_ms(
            torch, lambda: [fused_gpv.fused_addto(r, a, fd[o:o + n], scale)
                            for r, a, o, n in runs], reset, 50,
            launches=len(runs))
        ev = event_ms(torch, lambda: ops.device_addto_dense_runs(
            runs, f, scale), reset, 20)
        singles_ev = event_ms(torch, lambda: [
            ops.device_addto_dense(r, a, f[o:o + n], scale)
            for r, a, o, n in runs], reset, 20)
        single_ev = event_ms(torch, lambda: ops.device_addto_dense(
            regs[0], 0, f[:SEG], scale), reset, 20)
        plain_ms = event_ms(torch, lambda: fused_gpv.fused_addto_runs_plain(
            runs, fd, scale), reset, 5)
        bound_ms = 12 * len(f) / HBM_BYTES_PER_S * 1e3
        print(f"kernel fused_addto runs phase_b on {smi}: ms={ms:.6f} "
              f"({timer}) in one launch, {singles_ms:.6f} as {len(runs)} "
              f"fused_addto launches; event_ms={ev:.6f} a call with one copy "
              f"of the stream ({singles_ev:.6f} as {len(runs)} calls and "
              f"copies; one run of {SEG}: {single_ev:.6f}); "
              f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f}", flush=True)
        out.update(phase_b_ms=ms, phase_b_as_single_launches_ms=singles_ms,
                   phase_b_event_ms=ev,
                   phase_b_as_single_launches_event_ms=singles_ev,
                   single_run_event_ms=single_ev, phase_b_plain_ms=plain_ms,
                   phase_b_bound_ms=bound_ms)
    return out


def read_runs_same(torch, what, got, want, want_raw) -> None:
    """``fused_read_runs``' (values, mask, raw) bitwise equal to the plain
    version's."""
    torch.cuda.synchronize()
    for part, g, w in zip(("values", "mask", "raw"), got, want):
        if part == "raw" and not want_raw:
            if g is not None:
                fail(f"{what}: raw registers nobody asked for")
            continue
        if part == "values":
            g, w = g.view(torch.int32), w.view(torch.int32)
        if not torch.equal(g, w):
            fail(f"{what}: {int((g != w).sum())} {part} differ from the "
                 f"plain version")


def check_read_runs(torch, smi: str) -> dict:
    """Kernel 3 over several runs (``ops.device_read_dense_runs``, the
    multi-segment reply) bitwise against the plain version at RUN_CHECKS'
    layouts, with and without the raw registers, in one launch per run
    table. At phase b's shape: timed (CUPTI) with raw, as the path calls
    it, and without, beside the same work as one ``fused_read`` launch a
    run; and ``SwitchMemory.read_f32`` of one 262 144-value reply over 7
    device segments by this route against the ``get`` route it replaces
    (``get``, the host dequantize, the copy to the card), CUDA events a
    call, with and without ``need_raw``, the two bitwise equal."""
    from repro_torch.core.inc_map import SwitchMemory
    from repro_torch.kernels import fused_gpv, ops
    scale = 10 ** PRECISION
    out = {}
    for seed, (name, layout) in enumerate(RUN_CHECKS):
        regs, _, spec = runs_inputs(torch, layout, 400 + seed)
        m = sum(n for _, n in layout)
        runs = [(regs[i], a, o, n) for i, a, o, n in spec]
        for r, a, _, n in runs:             # a sentinel at each run's ends
            r[a], r[a + n - 1] = 2 ** 31 - 1, -(2 ** 31 - 1)
        tables = -(-len(layout) // fused_gpv.MAX_RUNS)
        for want_raw in (False, True):
            what = f"fused_read runs {name} ({len(layout)} runs, {m} " \
                f"values{', raw' if want_raw else ''})"
            ops.reset_counts()
            got = ops.device_read_dense_runs(runs, m, scale, want_raw)
            torch.cuda.synchronize()
            launches = ops.launch_counts()["fused_read"]
            want = fused_gpv.fused_read_runs_plain(runs, m, scale, want_raw)
            read_runs_same(torch, what, got, want, want_raw)
            if launches != tables:
                fail(f"{what}: {launches} launches, not {tables}")
            print(f"kernel {what}: ok vs plain in {launches} launches",
                  flush=True)
        if name != "phase_b":
            continue
        ms, timer = device_ms(torch, lambda: fused_gpv.fused_read_runs(
            runs, m, scale, want_raw=True), lambda: None, 50)
        no_raw_ms, _ = device_ms(torch, lambda: fused_gpv.fused_read_runs(
            runs, m, scale), lambda: None, 50)
        singles_ms, _ = device_ms(
            torch, lambda: [fused_gpv.fused_read(r, a, n, scale)
                            for r, a, _, n in runs], lambda: None, 50,
            launches=len(runs))
        plain_ms = event_ms(torch, lambda: fused_gpv.fused_read_runs_plain(
            runs, m, scale, True), lambda: None, 5)
        out.update(phase_b_ms=ms, phase_b_no_raw_ms=no_raw_ms,
                   phase_b_no_raw_as_single_launches_ms=singles_ms,
                   phase_b_plain_ms=plain_ms,
                   phase_b_bound_ms=13 * m / HBM_BYTES_PER_S * 1e3,
                   phase_b_no_raw_bound_ms=9 * m / HBM_BYTES_PER_S * 1e3)
        sw = SwitchMemory(8, SEG, device="cuda")
        if not sw.reserve(1, m, device=True):
            fail("fused_read runs: no room for phase b's partition")
        for seg, r in zip(sw.segments, regs):
            seg.regs.copy_(r)
        phys = np.arange(m)
        inv = np.float32(1.0) / np.float32(scale)

        def get_route(need_raw):
            raw = sw.get(phys)
            vals = torch.from_numpy(raw.astype(np.float32) * inv).to("cuda")
            return vals, (raw if need_raw else None)

        for need_raw in (True, False):
            v, r = sw.read_f32(phys, scale, need_raw=need_raw)
            wv, wr = get_route(need_raw)
            if not torch.equal(v.view(torch.int32), wv.view(torch.int32)) \
                    or (need_raw and not np.array_equal(r, wr)):
                fail("SwitchMemory.read_f32 over 7 segments differs from "
                     "the get route")
            key = "phase_b_" if need_raw else "phase_b_no_raw_"
            out[key + "read_f32_event_ms"] = event_ms(
                torch, lambda: sw.read_f32(phys, scale, need_raw=need_raw),
                lambda: None, 20)
            out[key + "get_route_event_ms"] = event_ms(
                torch, lambda: get_route(need_raw), lambda: None, 20)
        host = {}
        for what, fn in (("_locate", lambda: sw._locate(phys)),
                         ("_read_runs", lambda: sw._read_runs(
                             *sw._locate(phys)))):
            took = []
            for _ in range(20):
                t0 = time.perf_counter()
                fn()
                took.append((time.perf_counter() - t0) * 1e3)
            host[what] = statistics.median(took)
        print(f"SwitchMemory.read_f32 over 7 segments, its host index math "
              f"(host clock, median of 20): _locate {host['_locate']:.6f} "
              f"ms, _locate + _read_runs {host['_read_runs']:.6f} ms",
              flush=True)
        print(f"kernel fused_read runs phase_b on {smi}: ms={ms:.6f} "
              f"({timer}) in one launch with raw, {no_raw_ms:.6f} without, "
              f"{singles_ms:.6f} as {len(runs)} fused_read launches; "
              f"plain_ms={plain_ms:.6f} bound_ms="
              f"{out['phase_b_bound_ms']:.6f} (without raw "
              f"{out['phase_b_no_raw_bound_ms']:.6f}); SwitchMemory.read_f32 "
              f"of one reply, event_ms a call: need_raw "
              f"{out['phase_b_read_f32_event_ms']:.6f} (get route "
              f"{out['phase_b_get_route_event_ms']:.6f}), without "
              f"{out['phase_b_no_raw_read_f32_event_ms']:.6f} (get route "
              f"{out['phase_b_no_raw_get_route_event_ms']:.6f})", flush=True)
    return out


def check_sat_add_batch(torch, smi: str) -> dict:
    """Kernel 6b at BATCH_CHECKS bitwise against the plain version, with
    saturating lanes and both sentinels mid-fold; timed on phase h's
    updates (CUPTI)."""
    from repro_torch.kernels import inc_agg
    for i, (b, n) in enumerate(BATCH_CHECKS):
        rng = np.random.RandomState(300 + i)
        qs = int_stream(rng, (b, n))
        qs[:, :64] = 2 ** 29                     # saturates at the 4th row
        qs[b // 2, 64:72] = [2 ** 31 - 1, -(2 ** 31 - 1)] * 4
        acc = torch.from_numpy(int_stream(rng, n)).to("cuda")
        qs = torch.from_numpy(qs).to("cuda")
        got = inc_agg.sat_add_batch(acc, qs)
        want = inc_agg.sat_add_batch_plain(acc, qs)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"sat_add_batch B={b} n={n}: {int((got != want).sum())} "
                 f"lanes differ from the plain version")
        print(f"kernel sat_add_batch B={b} n={n}: ok vs plain", flush=True)
    rng = np.random.RandomState(8)                # drive_clear_policies'
    qs = rng.randint(-10 ** 6, 10 ** 6, (BATCH_ROWS, SEG)).astype(np.int32)
    qs[:, :64] = 2 ** 29
    qs[5, 64:72] = [2 ** 31 - 1, -(2 ** 31 - 1)] * 4
    qs = torch.from_numpy(qs).to("cuda")
    acc = torch.zeros(SEG, dtype=torch.int32, device="cuda")
    ms, timer = device_ms(torch, lambda: inc_agg.sat_add_batch(acc, qs),
                          lambda: None, 50)
    print(f"kernel sat_add_batch B={BATCH_ROWS} n={SEG} on phase h's "
          f"updates on {smi}: ms={ms:.6f} ({timer})", flush=True)
    return {"phase_h_inputs_ms": ms}


def report_path_scatters(torch, kernels) -> None:
    """The k of each scatter's path launches (min, median, max) and their
    lanes; fails unless every one took the cluster lane; then times each
    scatter at its median k (the first k updates of ``kernel_inputs``), in
    both cases, into its row of ``kernels``."""
    regs_np, _, idx_np, ivals_np, fvals_np = kernel_inputs(
        np.random.RandomState(1234))
    for name in SCATTERS:
        ks = sorted(PATH_KS[name])
        lanes = PATH_LANES[name]
        if not ks:
            fail(f"the path launched no {name}")
        median = ks[(len(ks) - 1) // 2]
        print(f"path {name}: {len(ks)} launches, k min {ks[0]}, median "
              f"{median}, max {ks[-1]}; lanes {lanes}", flush=True)
        if lanes.get("large", 0):
            fail(f"{lanes['large']} path launches of {name} took the large "
                 f"lane")
        k = min(median, SCATTER_K)
        t = time_scatter(torch, name, regs_np, idx_np, ivals_np, fvals_np, k)
        row = next(r for r in kernels if r["name"] == name)
        row["median_k"] = median
        row["median_k_bound_ms"] = scatter_bytes(idx_np, k) \
            / HBM_BYTES_PER_S * 1e3
        row.update({f"median_k_{key}": v for key, v in t.items()})
    print("path scatters: every launch took the cluster lane", flush=True)


# -- phase 2, kernel 11: flash attention --------------------------------------

def flash_inputs(torch, b, h, kv, s, d, seed):
    """bf16 q (B,S,H,D), k and v (B,S,KV,D) on the card, N(0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(b, s, n, d, device="cuda", generator=g)
                 .bfloat16() for n in (h, kv, kv))


def check_flash(torch) -> dict:
    """Kernel 11 against its plain version at FLASH_CHECKS, each case then
    timed beside PyTorch's scaled_dot_product_attention (the yardstick;
    the port never calls it; a window goes to it as a boolean mask) and
    the plain version."""
    from repro_torch.kernels import flash_attn
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for i, (b, h, kv, s, d, window) in enumerate(FLASH_CHECKS):
        case = (b, h, kv, s, d, window)
        q, k, v = flash_inputs(torch, b, h, kv, s, d, i)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if window is not None:
            pos = torch.arange(s, device="cuda")
            gap = pos[:, None] - pos[None, :]
            mask = (gap >= 0) & (gap < window)

        def kernel():
            return flash_attn.flash_attention(q, k, v, causal=True,
                                              window=window)

        def plain():
            return flash_attn.flash_attention_plain(q, k, v, causal=True,
                                                    window=window)

        def library():
            if mask is None:
                return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
            return sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)

        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got.float()).all() \
                or not torch.allclose(got.float(), want.float(),
                                      atol=FLASH_ATOL, rtol=FLASH_RTOL):
            fail(f"flash_attention (B,H,KV,S,D,window)={case} disagrees "
                 f"with its plain version")
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(library().transpose(1, 2).float(),
                              want.float(), atol=FLASH_ATOL,
                              rtol=FLASH_RTOL):
            fail(f"scaled_dot_product_attention {case} disagrees with the "
                 f"plain version")
        del got, want
        timed = device_ms_parts(torch, {
            "kernel": (kernel, "flash_k_", 1),
            "library": (library, "", None)}, 20)
        (ms, timer), (library_ms, _) = timed["kernel"], timed["library"]
        plain_ms = event_ms(torch, plain, lambda: None, 5)
        flops, nbytes = flash_work(*case)
        bound_ms = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        bound_by = "operations" if flops / BF16_FLOPS \
            > nbytes / HBM_BYTES_PER_S else "bytes"
        print(f"kernel flash_attention (B,H,KV,S,D,window)={case}: ok vs "
              f"plain (atol {FLASH_ATOL}, rtol {FLASH_RTOL}), max_abs_err="
              f"{err:.6f}; ms={ms:.6f} ({timer}), "
              f"{flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.4f} of "
              f"bound_ms={bound_ms:.6f} ({bound_by}: {flops / 1e9:.2f} "
              f"GFLOP, {nbytes / 1e6:.1f} MB); library_ms={library_ms:.6f} "
              f"({flops / library_ms / 1e9:.1f} TFLOP/s); plain_ms="
              f"{plain_ms:.6f}", flush=True)
        if min(ms, library_ms, plain_ms) < bound_ms:
            fail(f"flash_attention {case}: a time below bound_ms: the timer "
                 f"failed")
        if i == 0:                  # the prefill's shape: the JSON row
            # the train lane's forward: the same kernel storing its lse
            lse_ms, lse_timer = device_ms(
                torch, lambda: flash_attn._forward(q, k, v, True, window,
                                                   True), lambda: None, 20,
                match="flash_k_")
            print(f"kernel flash_attention {case}: plain_ms={plain_ms:.6f}; "
                  f"back-to-back events: kernel "
                  f"{loop_ms(torch, kernel, 20):.6f} ms, library "
                  f"{loop_ms(torch, library, 20):.6f} ms; with the lse "
                  f"store (the train lane) lse_ms={lse_ms:.6f} "
                  f"({lse_timer})", flush=True)
            row = {"name": "flash_attention", "route": "cuda",
                   "source": SOURCE["flash_attention"],
                   "replaces": REPLACES["flash_attention"], "launches": 0,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms, "timer": timer,
                   "lse_ms": lse_ms}
    return row


def check_flash_bwd(torch) -> list[dict]:
    """The backward kernels (a)-(c) and kernel 11's lse against their
    plain versions at FLASH_BWD_CHECKS, each kernel's output twice
    bitwise equal (the checkpoint's recompute relies on it); each case
    timed (CUPTI) beside its plain version and the backward of
    scaled_dot_product_attention on the same tensors. The rows of the
    first case (phase z's shape) go into the kernels' JSON line."""
    from repro_torch.kernels import flash_attn, ref
    from repro_torch.roofline.flash_model import bwd_kernel_work, \
        flash_bwd_work
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for i, case in enumerate(FLASH_BWD_CHECKS):
        b, h, kv, s, d, window = case
        q, k, v = flash_inputs(torch, b, h, kv, s, d, 100 + i)
        do = flash_inputs(torch, b, h, h, s, d, 200 + i)[0]
        o, lse = flash_attn._forward(q, k, v, True, window, True)
        _, want_lse = ref.flash_attention_lse(*flash_attn._bhsd(q, k, v),
                                              True, window)
        lse_err = float((lse - want_lse).abs().max())
        if not lse_err <= FLASH_LSE_ATOL:
            fail(f"flash_attention's lse {case}: {lse_err} from its plain "
                 f"version (atol {FLASH_LSE_ATOL})")
        del want_lse
        calls = {
            "flash_bwd_delta": lambda: (flash_attn.flash_bwd_delta(o, do),),
            "flash_bwd_dkdv": lambda: flash_attn.flash_bwd_dkdv(
                q, k, v, do, lse, delta, True, window),
            "flash_bwd_dq": lambda: (flash_attn.flash_bwd_dq(
                q, k, v, do, lse, delta, True, window),)}
        delta = calls["flash_bwd_delta"]()[0]
        plain_delta = lambda: (do.float() * o.float()).sum(-1).transpose(  # noqa: E731
            1, 2).contiguous()
        plain_bwd = lambda: ref.flash_bwd(  # noqa: E731
            *flash_attn._bhsd(q.float(), k.float(), v.float(), do.float()),
            lse, delta, True, window)
        want_dq, want_dk, want_dv = (t.transpose(1, 2)
                                     for t in plain_bwd())
        wants = {"flash_bwd_delta": (plain_delta(),),
                 "flash_bwd_dkdv": (want_dk, want_dv),
                 "flash_bwd_dq": (want_dq,)}
        errs = {}
        for name, call in calls.items():
            got, again = call(), call()
            torch.cuda.synchronize()
            tol = FLASH_DELTA_RTOL if name == "flash_bwd_delta" \
                else FLASH_BWD_TOL
            err = 0.0
            for g, a, w in zip(got, again, wants[name]):
                if g.shape != w.shape or not torch.isfinite(g.float()).all():
                    fail(f"{name} {case}: shape {tuple(g.shape)} or a "
                         f"non-finite value")
                if not torch.equal(g, a):
                    fail(f"{name} {case}: two calls differ (not "
                         f"deterministic)")
                e = float((g.float() - w.float()).abs().max())
                if not e <= tol * float(w.float().abs().max()):
                    fail(f"{name} {case}: max|kernel - plain| {e} > {tol} "
                         f"max|plain| {float(w.abs().max())}")
                err = max(err, e)
            errs[name] = err
        del wants, want_dq, want_dk, want_dv
        # the yardstick: SDPA's backward alone (its forward run once)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        mask = None
        if window is not None:
            pos = torch.arange(s, device="cuda")
            gap = pos[:, None] - pos[None, :]
            mask = (gap >= 0) & (gap < window)
        out = sdpa(qt, kt, vt, is_causal=mask is None, attn_mask=mask,
                   enable_gqa=True)
        dot = do.transpose(1, 2)

        def library():
            torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
        timed = device_ms_parts(torch, dict(
            {name: (call, name.replace("flash_bwd_", "flash_k_bwd_"), 1)
             for name, call in calls.items()},
            library=(library, "", None)), 20)
        library_ms = timed["library"][0]
        # SDPA's backward is the whole gradient: its floor is that of the
        # five products, not of one kernel
        lib_flops, lib_bytes = flash_bwd_work(b, h, kv, s, d, window)
        library_bound_ms = max(lib_flops / BF16_FLOPS,
                               lib_bytes / HBM_BYTES_PER_S) * 1e3
        plain_ms = {"flash_bwd_delta": event_ms(torch, plain_delta,
                                                lambda: None, 5)}
        plain_ms["flash_bwd_dkdv"] = plain_ms["flash_bwd_dq"] = event_ms(
            torch, plain_bwd, lambda: None, 3)
        total = 0.0
        for name in calls:
            ms, timer = timed[name]
            total += ms
            flops, nbytes = bwd_kernel_work(name, b, h, kv, s, d, window)
            op_ms, byte_ms = flops / BF16_FLOPS * 1e3, \
                nbytes / HBM_BYTES_PER_S * 1e3
            bound_ms = max(op_ms, byte_ms)
            bound_by = "operations" if op_ms > byte_ms else "bytes"
            print(f"kernel {name} (B,H,KV,S,D,window)={case}: ok vs plain "
                  f"(max|d| <= {FLASH_DELTA_RTOL if 'delta' in name else FLASH_BWD_TOL}"
                  f" max|plain|, deterministic), max_abs_err="
                  f"{errs[name]:.6f}; ms={ms:.6f} ({timer}), "
                  f"{flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.4f} of "
                  f"bound_ms={bound_ms:.6f} ({bound_by}: "
                  f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB); "
                  f"plain_ms={plain_ms[name]:.6f}; library_ms (SDPA's "
                  f"whole backward)={library_ms:.6f}, "
                  f"{library_bound_ms / library_ms:.4f} of the whole "
                  f"gradient's bound {library_bound_ms:.6f}", flush=True)
            if min(ms, plain_ms[name]) < bound_ms \
                    or library_ms < library_bound_ms:
                fail(f"{name} {case}: a time below bound_ms: the timer "
                     f"failed")
            if i == 0:
                rows.append({"name": name, "route": "cuda",
                             "source": SOURCE[name],
                             "replaces": REPLACES[name], "launches": 0,
                             "max_abs_err": errs[name], "ms": ms,
                             "plain_ms": plain_ms[name],
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "library_ms": library_ms,
                             "library_bound_ms": library_bound_ms,
                             "library": "scaled_dot_product_attention's "
                                        "backward (dq, dk and dv)",
                             "timer": timer})
        print(f"kernel flash backward {case}: the three kernels "
              f"{total:.6f} ms against SDPA's backward {library_ms:.6f} ms; "
              f"lse max|d| {lse_err:.2e}", flush=True)
        del q, k, v, do, o, lse, delta, out, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def sass_counts(build) -> dict:
    """Counts of HGMMA (wgmma), UTMALDG (TMA loads), LDGSTS (cp.async) and
    SYNCS (mbarrier) instructions in the SASS of kernel 11's library and
    of its backward kernels', where the toolkit has cuobjdump; fails only
    if it ran and found no HGMMA in one of them."""
    tool = Path(build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        print("cuobjdump not found: the flash SASS is not counted",
              flush=True)
        return {}
    out = {}
    for lib in ("flash_attn", "flash_attn_bwd"):
        run = subprocess.run([str(tool), "-sass", str(build.lib_path(lib))],
                             capture_output=True, text=True)
        if run.returncode != 0:
            print(f"cuobjdump failed ({run.returncode}): the {lib} SASS is "
                  f"not counted", flush=True)
            continue
        counts = {op: len(re.findall(rf"\b{op}\b", run.stdout))
                  for op in ("HGMMA", "UTMALDG", "LDGSTS", "SYNCS")}
        print(f"{lib} SASS: " + ", ".join(f"{k} {v}"
                                          for k, v in counts.items()),
              flush=True)
        if counts["HGMMA"] == 0:
            fail(f"the {lib} library holds no HGMMA (wgmma) instruction")
        out[lib] = counts
    return out


# -- phase 2, kernels 9-10: the int8 pack and unpack --------------------------

def check_int8(torch) -> list[dict]:
    """Kernels 9-10 timed on the bucket (51 200 rows, no padding) beside
    their plain versions; unpack also beside ``q * scale[:, None]``, one
    PyTorch call (int8 times fp32 promotes to one fp32 elementwise
    kernel), which must equal the plain version bitwise. Pack has no such
    call: no one PyTorch call takes a per-row amax, divides, rounds and
    clamps. Phase k holds both kernels bitwise against their plain
    versions and fills in ``max_abs_err``."""
    from repro_torch.kernels import pack_int8 as pk
    from repro_torch.kernels.constants import LANES
    dev = torch.device("cuda")
    x = torch.from_numpy(bucket(np.random.RandomState(9))).to(dev)
    tiles = x.reshape(-1, LANES)
    rows = tiles.shape[0]
    q, s = pk.pack_int8_plain(tiles)

    def library():
        return torch.mul(q, s.unsqueeze(1))

    if not torch.equal(library().view(torch.int32),
                       pk.unpack_int8_plain(q, s).view(torch.int32)):
        fail("q * scale[:, None] differs from the plain unpack")
    nbytes = 5 * BUCKET + 4 * rows          # fp32 in, int8 + scales out
    # the bucket's 33 MB fit the 50 MB L2: write 64 MiB between launches
    # so that each one reads its input from device memory, as a caller
    # whose gradients were written long before would
    flush = torch.empty(2 ** 24, dtype=torch.int32, device=dev)
    out = []
    for name, kernel, plain, lib in (
            ("pack_int8", lambda: pk.pack_int8(tiles),
             lambda: pk.pack_int8_plain(tiles), None),
            ("unpack_int8", lambda: pk.unpack_int8(q, s),
             lambda: pk.unpack_int8_plain(q, s), library)):
        ms, timer = device_ms(torch, kernel, lambda: flush.fill_(1), 50)
        warm, _ = device_ms(torch, kernel, lambda: None, 50)
        plain_ms = event_ms(torch, plain, lambda: flush.fill_(1), 5)
        library_ms = lib_timer = None
        if lib is not None:
            library_ms, lib_timer = device_ms(
                torch, lib, lambda: flush.fill_(1), 50, match="MulFunctor",
                launches=None)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"kernel {name}: ms={ms:.6f} ({timer}, L2 flushed; "
              f"{warm:.6f} with the bucket in L2) plain_ms={plain_ms:.6f} "
              f"library_ms={library_ms} ({lib_timer}, L2 flushed) "
              f"bound_ms={bound_ms:.6f}", flush=True)
        out.append({"name": name, "route": "cuda", "source": SOURCE[name],
                    "replaces": REPLACES[name], "launches": 0,
                    "max_abs_err": None, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "bytes", "library_ms": library_ms,
                    "timer": timer})
    return out


# -- phase 3: the main path ---------------------------------------------------

def services(inc):
    from repro_torch.quickstart import Gradient as Quickstart
    made = {}

    def grad(app, device):
        @inc.service(app=app, drain=inc.DrainPolicy(
            max_batch=WORKERS, max_delay=60.0, eager_window=False))
        class Grad:
            @inc.rpc(request_msg="NewGrad", reply_msg="AgtrGrad")
            def Update(self, tensor: inc.Agg[inc.FPArray](
                    precision=PRECISION, clear="copy", device=device)
                    ) -> {"tensor": inc.Get[inc.FPArray]}: ...
        return Grad

    for label, _, _, device, kind in PHASES:
        made[label] = (Quickstart if kind == "quickstart"
                       else grad(f"grad-{label}", device))
    return made


def gradients(label: str, n: int) -> np.ndarray:
    """(ROUNDS, WORKERS, n) fp32 gradients from a seed; the spill phase's
    are sparse (exact zeros), so clear write-backs skew the LRU counts and
    force re-grants of non-contiguous slots."""
    rng = np.random.RandomState(sum(map(ord, label)))
    g = (rng.randn(ROUNDS, WORKERS, n) * 0.05).astype(np.float32)
    if label.startswith("e_"):
        g[rng.rand(ROUNDS, WORKERS, n) < 0.5] = 0.0
    return g


def oracle(g: np.ndarray, kind: str, device_lane: bool) -> list:
    """Expected replies: the fixed-point contributions the switch holds
    at each Get, dequantized as the lane does it (fp32 reciprocal on the
    device lane, ``raw / scale`` in float64 on the host lane)."""
    scale = 10 ** PRECISION
    q = np.rint(g * np.float32(scale)).astype(np.int64)

    def deq(raw):
        if device_lane:
            return raw.astype(np.float32) * (np.float32(1.0)
                                             / np.float32(scale))
        return raw / scale

    want = []
    for r in range(ROUNDS):
        if kind == "quickstart":      # CntFwd: only the quorum call replies
            want += [None, deq(q[r, 0] + q[r, 1])]
        else:                         # clear="copy": each call's own part
            want += [deq(q[r, w]) for w in range(WORKERS)]
    return want


def same(a, b) -> bool:
    """Both absent, or arrays of one dtype and shape, finite and equal
    bit for bit."""
    if a is None or b is None:
        return a is None and b is None
    return (a.dtype == b.dtype and a.shape == b.shape
            and bool(np.isfinite(a).all()) and a.tobytes() == b.tobytes())


def runtime(inc, device, seg_slots, switch=None):
    """``IncRuntime`` on ``device`` at the paper's geometry, or with
    smaller segments for a CPU rehearsal; ``switch(device, seg_slots)``,
    when given, makes its register file (phase r: a ``RemoteSwitchMemory``
    whose registers live in the switch daemon)."""
    from repro_torch.core.channel import Controller
    from repro_torch.core.inc_map import SwitchMemory
    if switch is not None:
        return inc.IncRuntime(controller=Controller(
            switch=switch(device, seg_slots)))
    if seg_slots == SEG:
        return inc.IncRuntime(device=device)
    return inc.IncRuntime(controller=Controller(
        switch=SwitchMemory(32, seg_slots, device=device)))


def drive_path(device, *, seg_slots=SEG, scale_down=1, switch=None,
               labels=None):
    """Phases a-e (or those of ``labels``) through the port's public entry
    points on ``device``, the register file made by ``switch`` when given
    (``runtime``); returns (replies, switch state_dict, launches, seconds,
    round seconds), the last four per phase; on the CPU the launches are
    the plain calls that stand in for them. A round's seconds run from
    its first call to its last reply."""
    import repro_torch.api as inc
    from repro_torch.kernels import ops
    count = ops.plain_counts if device == "cpu" else ops.launch_counts
    svcs = services(inc)
    rt = runtime(inc, device, seg_slots, switch)
    replies, launches, seconds, rounds = {}, {}, {}, {}
    try:
        for label, slots, n, dev_lane, kind in PHASES:
            if labels is not None and label not in labels:
                continue
            slots, n = slots // scale_down, n // scale_down
            before = count()
            t0 = time.perf_counter()
            stubs = [rt.make_stub(svcs[label], n_slots=slots)
                     for _ in range(WORKERS)]
            g = gradients(label, n)
            got = []
            rounds[label] = []
            for r in range(ROUNDS):
                tr = time.perf_counter()
                futs = [s.Update(tensor=g[r, w]) for w, s in enumerate(stubs)]
                for f in futs:
                    rep = f.result(timeout=600)
                    t = rep.get("tensor")
                    got.append(None if t is None else
                               t.cpu().numpy() if hasattr(t, "cpu") else t)
                rounds[label].append(time.perf_counter() - tr)
            seconds[label] = time.perf_counter() - t0
            want = oracle(g, kind, dev_lane)
            for i, (a, b) in enumerate(zip(got, want)):
                if not same(a, b):
                    fail(f"{label}: reply {i} on {device} disagrees with the "
                         f"fixed-point oracle")
            replies[label] = got
            after = count()
            launches[label] = {k: after[k] - before[k] for k in after}
        state = rt.controller.switch.state_dict()
    finally:
        rt.close()
    return replies, state, launches, seconds, rounds


def once_a_call(per_phase, verb: str) -> None:
    """Phases a and b make the same transmits and replies (2 workers,
    ROUNDS rounds), a in one segment and b over 7: fails unless b takes
    fused_addto once a transmit and fused_read once a reply, as a does."""
    for name, call in (("fused_addto", "transmit"), ("fused_read", "reply")):
        a = per_phase["a_dense_one_segment"][name]
        b = per_phase["b_dense_seven_segments"][name]
        if a == 0 or b != a:
            fail(f"phase b {verb} {name} {b} times for the {a} of phase a: "
                 f"not once a {call}")
        print(f"path: {name} {verb} once a {call}, {a} times in phase a "
              f"(one segment) and {b} in phase b (7 segments)", flush=True)


def same_state(torch, state, ref_state, what: str) -> None:
    if state["partitions"] != ref_state["partitions"]:
        fail(f"{what}: partition tables differ between card and CPU")
    for s, (a, b) in enumerate(zip(state["regs"], ref_state["regs"])):
        if not torch.equal(a, b):
            fail(f"{what}: segment {s} registers differ between card and "
                 f"CPU")


def counted(torch, run, what: str, needs: tuple) -> tuple:
    """``run()`` on the card with every launch count set to 0 just before
    and read just after; fails unless each kernel of ``needs`` launched."""
    from repro_torch.kernels import ops
    ops.reset_counts()
    t0 = time.perf_counter()
    result = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    for name, ks in ops.launch_ks().items():
        PATH_KS[name] += ks
    for name, lanes in ops.lane_counts().items():
        for lane, c in lanes.items():
            PATH_LANES[name][lane] = PATH_LANES[name].get(lane, 0) + c
    for name in needs:
        if counts[name] == 0:
            fail(f"{what} never launched {name}")
    return result, counts, secs


def check_path(torch) -> dict:
    (replies, state, per_phase, secs, _), counts, card_s = counted(
        torch, lambda: drive_path(None), "the path (phases a-e)",
        ("fused_addto", "fused_read", "sparse_addto", "fused_scatter"))
    for label, c in per_phase.items():
        print(f"path {label}: {secs[label]:.3f} s for {ROUNDS} rounds of "
              f"{WORKERS} calls, launches {c}", flush=True)
    print(f"path on the card: {card_s:.3f} s, launches {counts}", flush=True)
    once_a_call(per_phase, "launched")
    t0 = time.perf_counter()
    ref_replies, ref_state, *_ = drive_path("cpu")
    print(f"path on the CPU (reference): {time.perf_counter() - t0:.3f} s",
          flush=True)
    for label in replies:
        for i, (a, b) in enumerate(zip(replies[label], ref_replies[label])):
            if not same(a, b):
                fail(f"{label}: reply {i} differs between card and CPU")
    same_state(torch, state, ref_state, "phases a-e")
    print("path: replies and registers bitwise equal to the CPU run",
          flush=True)
    return counts


# -- phase f: local_accum on the card -----------------------------------------

def drive_local_accum(device, *, seg_slots=SEG, scale_down=1):
    """Two workers, LA_CALLS calls each, of a gradient service that folds
    LOCAL_ACCUM calls into one switch update; returns (the gradients,
    (LA_CALLS, WORKERS, n) in issue order, the replies per call in issue
    order, the switch state_dict)."""
    import repro_torch.api as inc

    @inc.service(app="grad-local-accum", drain=inc.DrainPolicy(
        max_batch=WORKERS, max_delay=60.0, eager_window=False))
    class Grad:
        @inc.rpc(request_msg="NewGrad", reply_msg="AgtrGrad")
        def Update(self, tensor: inc.Agg[inc.FPArray](
                precision=PRECISION, clear="copy", device=True,
                local_accum=LOCAL_ACCUM)
                ) -> {"tensor": inc.Get[inc.FPArray]}: ...

    n = LA_SLOTS // scale_down
    rng = np.random.RandomState(6)
    g = (rng.randn(LA_CALLS, WORKERS, n) * 0.05).astype(np.float32)
    rt = runtime(inc, device, seg_slots)
    try:
        stubs = [rt.make_stub(Grad, n_slots=n) for _ in range(WORKERS)]
        # issue every call before reading any reply: a read would flush a
        # partial fold
        futs = [s.Update(tensor=g[c, w]) for c in range(LA_CALLS)
                for w, s in enumerate(stubs)]
        replies = []
        for f in futs:
            t = f.result(timeout=600)["tensor"]
            replies.append(t.cpu().numpy() if hasattr(t, "cpu")
                           else np.asarray(t))
        state = rt.controller.switch.state_dict()
    finally:
        rt.close()
    return g, replies, state


def local_accum_oracle(g, replies) -> None:
    """The channel folds every LOCAL_ACCUM consecutive calls, whichever
    worker made them, and with clear="copy" each call of a cohort gets
    the cohort's sum, within the fixed-point step of each round."""
    issued = g.reshape(-1, g.shape[-1]).astype(np.float64)   # issue order
    for i, rep in enumerate(replies):
        lo = i - i % LOCAL_ACCUM
        want = issued[lo:lo + LOCAL_ACCUM].sum(0)
        if rep.shape != want.shape or not np.all(np.isfinite(rep)) \
                or not np.all(np.abs(rep - want)
                              <= LOCAL_ACCUM * 0.5e-8 + 1e-7):
            fail(f"f_local_accum: reply {i} is not its cohort's sum")


def check_local_accum(torch) -> dict:
    (g, replies, state), counts, secs = counted(
        torch, lambda: drive_local_accum(None),
        "phase f (local_accum)", ("fused_fold",))
    print(f"path f_local_accum: {secs:.3f} s for {LA_CALLS} calls from each "
          f"of {WORKERS} workers, launches {counts}", flush=True)
    t0 = time.perf_counter()
    _, ref_replies, ref_state = drive_local_accum("cpu")
    print(f"path f_local_accum on the CPU (reference): "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    for i, (a, b) in enumerate(zip(replies, ref_replies)):
        if not same(a, b):
            fail(f"f_local_accum: reply {i} differs between card and CPU")
    same_state(torch, state, ref_state, "phase f")
    local_accum_oracle(g, replies)
    print("path f_local_accum: replies and registers bitwise equal to the "
          "CPU run; each reply is its cohort's sum", flush=True)
    return counts


# -- phase g: the SyncAgtr aggregation ----------------------------------------

def drive_syncagtr(torch, axes, device, g_np) -> tuple[dict, dict]:
    """all_reduce, and reduce_scatter then all_gather, in every mode with
    1 and 4 streams; returns (results as numpy, host seconds per mode and
    stream count, the device's work included, the copies out excluded)."""
    from repro_torch.core import inc_agg
    g = torch.from_numpy(g_np).to(device)
    out, secs = {}, {}
    for mode in MODES:
        for ns in (1, 4):
            cfg = inc_agg.IncAggConfig(mode=mode, precision=PRECISION,
                                       n_streams=ns)
            t0 = time.perf_counter()
            ar, mask = inc_agg.all_reduce(g, axes, cfg)
            chunk = inc_agg.reduce_scatter(g, axes, cfg)
            ag = inc_agg.all_gather(chunk, axes, cfg)
            if g.is_cuda:
                torch.cuda.synchronize()
            secs[f"{mode}|{ns}"] = time.perf_counter() - t0
            for what, t in (("ar", ar), ("mask", mask), ("rs", chunk),
                            ("ag", ag)):
                if t is not None:
                    out[f"{mode}|{ns}|{what}"] = t.cpu().numpy()
    return out, secs


def syncagtr_oracle(g, got) -> int:
    """One rank: every mode returns the bucket (netrpc-opt within its
    int8 grid); netrpc flags exactly the lanes whose fp32 product rounds
    past the int32 range and repairs them to the input. Returns the
    number of overflowed lanes."""
    y = np.rint(g * np.float32(10 ** PRECISION))
    ovf = (y >= 2.0 ** 31) | (y < -2.0 ** 31)
    for ns in (1, 4):
        for mode in ("xla-psum", "fp32-ring"):
            for what in ("ar", "ag"):
                if got[f"{mode}|{ns}|{what}"].tobytes() != g.tobytes():
                    fail(f"g_syncagtr: {mode} {what} of one rank is not "
                         f"its input")
        mask = got[f"netrpc|{ns}|mask"]
        ar = got[f"netrpc|{ns}|ar"]
        if not np.array_equal(mask, ovf) or not np.array_equal(
                ar[mask], g[mask]) or not np.all(
                np.abs(ar - g) <= 0.5e-8 + 1e-7 * np.abs(g)):
            fail("g_syncagtr: netrpc all_reduce of one rank is wrong")
        amax = np.abs(g).reshape(-1, 128).max(1).repeat(128)
        if not np.all(np.abs(got[f"netrpc-opt|{ns}|ar"] - g)
                      <= amax / 127 * 0.5001):
            fail("g_syncagtr: netrpc-opt is off its int8 grid")
    return int(ovf.sum())


def check_syncagtr(torch) -> dict:
    import torch.distributed as dist

    from repro_torch import compat
    store = ROOT / "build" / "chip_smoke" / "store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        card = compat.make_mesh((1,), ("data",)).axes_of(("data",))
        cpu = compat.make_mesh((1,), ("data",),
                               device="cpu").axes_of(("data",))
        g = bucket(np.random.RandomState(7))
        (got, per_mode), counts, secs = counted(
            torch, lambda: drive_syncagtr(torch, card, "cuda", g),
            "phase g (SyncAgtr)", ("quantize", "sat_add", "dequantize"))
        print(f"path g_syncagtr: {secs:.3f} s for {len(MODES)} modes x "
              f"(1, 4) streams x (all_reduce, reduce_scatter + all_gather) "
              f"of {BUCKET} fp32, launches {counts}", flush=True)
        t0 = time.perf_counter()
        want, ref_per_mode = drive_syncagtr(torch, cpu, "cpu", g)
        print(f"path g_syncagtr on the CPU (gloo, reference): "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        print("path g_syncagtr seconds per mode|streams, card (CPU): "
              + ", ".join(f"{k} {v:.4f} ({ref_per_mode[k]:.4f})"
                          for k, v in per_mode.items()), flush=True)
    finally:
        dist.destroy_process_group()
    if got.keys() != want.keys():
        fail("g_syncagtr: the card and the CPU returned different results")
    for k in got:
        if got[k].tobytes() != want[k].tobytes():
            fail(f"g_syncagtr: {k} differs between card and CPU")
    n_ovf = syncagtr_oracle(g, got)
    print(f"path g_syncagtr: bitwise equal to the CPU run; {n_ovf} "
          f"overflowed lanes flagged and repaired", flush=True)
    print("path g_syncagtr: one card, one rank: the ring runs no hop (its "
          "sat_add is add(zeros, own)); the multi-rank hops are held on the "
          "CPU (gloo, world sizes 2 and 4) against the JAX ring in "
          "tests/test_torch_syncagtr.py; NCCL across ranks needs more than "
          "one card and is not run here", flush=True)
    return counts


# -- phase h: the clear policies ----------------------------------------------

def drive_clear_policies(torch, device, n=SEG) -> dict:
    """Each policy: 16 addto calls, a read, one addto_batch of the same 16,
    a read; int32 updates with saturating lanes and sentinels."""
    from repro_torch.core.clear_policy import POLICIES, make_clear_policy
    rng = np.random.RandomState(8)
    qs = rng.randint(-10 ** 6, 10 ** 6, (BATCH_ROWS, n)).astype(np.int32)
    qs[:, :64] = 2 ** 29                          # saturates at the 4th add
    qs[5, 64:72] = [2 ** 31 - 1, -(2 ** 31 - 1)] * 4
    qs_dev = [torch.from_numpy(q).to(device) for q in qs]
    out = {}
    for policy in POLICIES:
        pol = make_clear_policy(policy, n, device=device)
        for q in qs_dev:
            pol.addto(q)
        out[f"{policy}|addto"] = pol.read_and_clear().cpu().numpy()
        pol.addto_batch(qs_dev)
        out[f"{policy}|batch"] = pol.read_and_clear().cpu().numpy()
        state = pol.state_dict()
        for k, v in state.items():
            out[f"{policy}|state|{k}"] = np.asarray(
                v if k != "stats" else list(v.values()))
    return out


def clear_policy_oracle(got) -> None:
    """copy and shadow start both reads from a cleared accumulator, so
    one addto_batch of the 16 updates reads like the 16 addto calls."""
    for policy in ("copy", "shadow"):
        if got[f"{policy}|addto"].tobytes() != \
                got[f"{policy}|batch"].tobytes():
            fail(f"h_clear_policies: {policy} addto_batch != 16 addto")


def check_clear_policies(torch) -> dict:
    got, counts, secs = counted(
        torch, lambda: drive_clear_policies(torch, "cuda"),
        "phase h (clear policies)", ("sat_add", "sat_add_batch"))
    print(f"path h_clear_policies: {secs:.3f} s, launches {counts}",
          flush=True)
    want = drive_clear_policies(torch, "cpu")
    for k in want:
        if got[k].tobytes() != want[k].tobytes():
            fail(f"h_clear_policies: {k} differs between card and CPU")
    clear_policy_oracle(got)
    print("path h_clear_policies: bitwise equal to the CPU run", flush=True)
    return counts


# -- phases i, l and m: serving at full width and depth -----------------------

def serve_run(device, params, flash, shape: dict, feed=None,
              q8: bool = False) -> dict:
    """``serve`` on ``device`` with ``params`` (its programs from
    ``build_serve_step``, on a one-rank world); ``shape`` holds arch,
    prompt_len, decode_n, batch and the depth cut (reduced, layers);
    ``q8`` the fsdp gather in int8."""
    from repro_torch.launch.serve import serve
    return serve(device=device, params=params, flash=flash, feed=feed,
                 q8=q8, **shape)


def flash_layers(cfg, prompt: int) -> int:
    """The layers whose prefill takes the flash kernel at ``prompt``
    tokens: every global, moe and selfcross layer (its self-attention),
    and a local one when the prompt is longer than its window (the
    reference's routing); never a cross layer or the encoder."""
    return sum(flashed_layers(cfg, prompt))


def moe_layers(cfg) -> int:
    return sum(n * pat.count("moe") for pat, n in cfg.pattern_groups)


def set_gates(params, cfg, gate) -> str:
    """Every cross layer's gate set to ``gate`` (None: left as drawn, 0);
    returns what it did, for the log."""
    if gate is None:
        return ""
    n = 0
    for gi, (pat, r) in enumerate(cfg.pattern_groups):
        for i, bt in enumerate(pat):
            if bt == "cross":
                params["groups"][gi][f"s{i}"]["gate"].fill_(gate)
                n += r
    return (f"; the gate of each of its {n} cross layers set to {gate} "
            f"(tanh {np.tanh(gate):.4f})")


@contextlib.contextmanager
def routes_into(calls: list):
    """While open, every ``ffn.route`` call appends its expert ids (T, k),
    each token's ascending, to ``calls``: a serve run's prefill appends
    one a moe layer, then each decode step one a layer."""
    from repro_torch.models import ffn
    route = ffn.route

    def recorded(*args, **kwargs):
        out = route(*args, **kwargs)
        calls.append(out[2])
        return out
    ffn.route = recorded
    try:
        yield calls
    finally:
        ffn.route = route


@contextlib.contextmanager
def routes_forced(calls: list, flips: list):
    """While open, ``ffn.route`` hands back, call by call, the expert ids
    that ``calls`` recorded (``routes_into``), with this run's own
    probabilities and gates for them, and appends to ``flips`` the
    tokens (T,) whose own top-k would have taken other experts: the
    routing teacher forced, as a serve run's tokens are by ``feed``."""
    from repro_torch.models import ffn
    route = ffn.route
    forced = iter(calls)

    def replay(router, xf, top_k):
        probs, _, own = route(router, xf, top_k)
        ids = next(forced).to(own.device)
        flips.append((own != ids).any(-1))
        gates = probs.gather(-1, ids)
        return probs, gates / gates.sum(-1, keepdim=True), ids
    ffn.route = replay
    try:
        yield
    finally:
        ffn.route = route
    if len(flips) != len(calls):
        fail(f"{len(flips)} routes forced of the {len(calls)} recorded")


def lanes_err(a: dict, b: dict, vocab: int) -> float:
    """max over the steps of max|a - b| / max|b|, on the logits of the
    real vocab (the padded columns are -1e30 in both)."""
    la = a["logits"][..., :vocab].float().cpu()
    lb = b["logits"][..., :vocab].float().cpu()
    return max(float((la[t] - lb[t]).abs().max() / lb[t].abs().max())
               for t in range(lb.shape[0]))


def serve_oracle(run: dict, shape: dict, vocab: int, what: str) -> None:
    """Finite logits of every step, tokens of the real vocab (never a
    padded column), and the telemetry counted every decoded token."""
    b, n = shape["batch"], shape["decode_n"]
    if tuple(run["tokens"].shape) != (b, n + 1) \
            or not bool(run["logits"].float().isfinite().all()):
        fail(f"{what}: tokens or logits of the wrong shape, or not finite")
    if int(run["tokens"].max()) >= vocab:
        fail(f"{what}: argmax landed on a padded vocab column")
    got = run["inc_telemetry"]["metrics"].get("decode_tokens")
    if got != b * n:
        fail(f"{what}: the telemetry counted {got} decode tokens, not "
             f"{b * n}")


def busy_share(torch, fn, steps: int = 1) -> tuple[float, float, list]:
    """One ``fn()`` under the profiler: (wall seconds per step, the share
    of the wall time the card ran kernels, the five kernels with the most
    device time as (name, ms), then the flash kernel if it ran and is not
    among them). One stream, so kernel times do not overlap."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [(ev.key, getattr(ev, "device_time_total",
                            getattr(ev, "cuda_time_total", 0.0)))
           for ev in prof.key_averages()]
    busy_us = sum(us for _, us in evs)
    top = sorted(evs, key=lambda e: -e[1])[:5]
    top += [e for e in evs if "flash_k_" in e[0] and e not in top]
    return wall / steps, busy_us / 1e6 / wall, \
        [(k[:60], round(us / 1e3, 3)) for k, us in top]


def profile_serve(torch, params, cfg, sp: dict, label: str) -> None:
    """Where the time of a serve phase goes: one flash prefill and four
    decode steps of the same shapes, each under the profiler, on warm
    weights."""
    from repro_torch.launch.serve import grow_cache
    from repro_torch.data import pipeline
    from repro_torch.models import api
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, batch=sp["batch"],
                               seq_len=sp["prompt"] - 1, kind="uniform")
    inputs = pipeline.shard_batch(pipeline.add_modality_stubs(
        pipeline.make_batch(dcfg, 0), cfg, sp["batch"]), "cuda")
    state = {}

    def prefill():
        state["logits"], cache = api.prefill(params, cfg, inputs, flash=True)
        state["cache"] = grow_cache(cache, cfg, sp["batch"],
                                    sp["prompt"] + sp["decode"])

    def decode():
        tok = state["logits"].argmax(-1)
        for i in range(4):
            logits, _ = api.decode_step(params, cfg, tok, sp["prompt"] + i,
                                        state["cache"])
            tok = logits.argmax(-1)

    for name, fn, steps in (("prefill", prefill, 1), ("decode", decode, 4)):
        wall, share, top = busy_share(torch, fn, steps)
        print(f"path {label} profile, {name}: {wall * 1e3:.3f} ms a step "
              f"(wall, profiler on), card busy {share:.4f} of it; top "
              f"kernels (ms): {top}", flush=True)
    if cfg.is_encdec:
        enc_ms = event_ms(torch, lambda: api.encode(params, cfg,
                                                    inputs["frames"]),
                          lambda: None, 3)
        pre_ms = event_ms(torch, prefill, lambda: None, 3)
        print(f"path {label}: the encoder takes {enc_ms:.3f} ms of a "
              f"{pre_ms:.3f} ms prefill, {enc_ms / pre_ms:.4f} (CUDA events, "
              f"median of 3, profiler off)", flush=True)


def forced_run(torch, cfg, routes: list, run) -> tuple:
    """``run()`` with its routing teacher forced to ``routes`` (another
    run's ``routes_into`` list; ``routes_forced``) where the model has moe
    layers: a near tie between two experts' probabilities flips under
    bf16 rounding, and a flipped token's logits move far more than the
    rounding does. Returns (the run, what the forcing overrode, for the
    log)."""
    layers = moe_layers(cfg)
    if not layers:
        return run(), ""
    flips = []
    with routes_forced(routes, flips):
        out = run()
    prefill = torch.stack(flips[:layers]).cpu()           # (layers, tokens)
    return out, (f"; routing teacher forced: the second run's own top-"
                 f"{cfg.top_k} differed for "
                 f"{float(prefill.float().mean()):.6f} of the (prefill "
                 f"token, layer) pairs, "
                 f"{float(prefill.any(0).float().mean()):.6f} of the "
                 f"prefill tokens in some layer")


def lanes_check(a: dict, b: dict, cfg, tol: float, what: str,
                forced: str = "") -> str:
    """Fails unless run ``a``'s logits are within ``tol`` of run ``b``'s
    (``lanes_err``); returns the comparison, for the log."""
    err = lanes_err(a, b, cfg.vocab)
    got = f"max|d|/max|ref| {err:.6f} (tolerance {tol}){forced}"
    if err > tol:
        fail(f"{what}: {got}")
    return got


def cut_of(sp: dict) -> tuple:
    """A serve phase's cut: its config (``cut`` layers, and ``cut_enc``
    encoder layers where given) and its ``serve_run`` shape."""
    from dataclasses import replace

    from repro_torch.launch.serve import model_config
    cfg = model_config(sp["arch"], layers=sp["cut"])
    if sp.get("cut_enc"):
        cfg = replace(cfg, enc_layers=sp["cut_enc"])
    return cfg, dict(arch=cfg, prompt_len=sp["cut_prompt"],
                     decode_n=sp["cut_decode"], batch=sp["cut_batch"])


def check_serve(torch, smi: str, phase: str) -> dict:
    """A serve phase (i, l, m, n, o, p or q of SERVES) on the card, with its
    comparisons: the flash launches a prefill, the flash lane against the
    plain one at full depth (where the arch has attention), and a cut
    depth on the card against the CPU; with moe layers, each second run's
    routing teacher forced to the first's (``forced_run``)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import model_config
    from repro_torch.models import api
    sp = SERVES[phase]
    label = f"{phase}_serve"
    cfg = model_config(sp["arch"], layers=sp.get("layers"))
    shape = dict(arch=sp["arch"], prompt_len=sp["prompt"],
                 decode_n=sp["decode"], batch=sp["batch"],
                 layers=sp.get("layers"))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = api.init_params(SEED, cfg, device="cuda")
    gates = set_gates(params, cfg, sp.get("gate"))
    torch.cuda.synchronize()
    active = api.count_params(cfg, active_only=True) / 1e9
    enc = f" (and {cfg.enc_layers} encoder layers)" if cfg.is_encdec else ""
    print(f"path {label}: {sp['arch']}, {cfg.n_layers} layers{enc}, d_model "
          f"{cfg.d_model}, {api.count_params(cfg) / 1e9:.3f} B parameters "
          f"({active:.3f} B active; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB) drawn on "
          f"the card in {time.perf_counter() - t0:.3f} s{gates}", flush=True)
    want = flash_layers(cfg, sp["prompt"])
    routes = []
    torch.cuda.reset_peak_memory_stats()
    with routes_into(routes):
        run, counts, secs = counted(
            torch, lambda: serve_run(None, params, True, shape),
            f"phase {phase} (serve)",
            ("flash_attention", "sparse_addto") if want else
            ("sparse_addto",))
    peak = torch.cuda.max_memory_allocated()
    if counts["flash_attention"] != want:
        fail(f"phase {phase}: {counts['flash_attention']} flash launches in "
             f"one prefill, not the {want} of its {cfg.n_layers} layers "
             f"that take the kernel at {sp['prompt']} tokens")
    serve_oracle(run, shape, cfg.vocab, f"phase {phase}")
    print(f"path {label}: {secs:.3f} s; prefill {sp['prompt']} tokens x"
          f"{sp['batch']}: {run['prefill_s']:.6f} s; decode {sp['decode']} "
          f"steps: {run['decode_s']:.6f} s, "
          f"{sp['batch'] * sp['decode'] / run['decode_s']:.3f} tokens/s; "
          f"peak device memory {peak / 2 ** 30:.3f} GiB; launches {counts}",
          flush=True)
    print(f"path {label} card: {smi}", flush=True)
    if phase == "i":
        MEASURED["i"] = {"s": run["prefill_s"], "peak": peak,
                         "launches": {"flash_attention":
                                      counts["flash_attention"]}}
    if phase in KEEP_SERVED:
        SERVED[phase] = {"tokens": run["tokens"].cpu(),
                         "logits": run["logits"].cpu()}
    profile_serve(torch, params, cfg, sp, label)
    if sp["lanes_tol"] is not None:
        plain, forced = forced_run(
            torch, cfg, routes, lambda: serve_run(
                None, params, False, shape, feed=run["tokens"][:, :-1]))
        got = lanes_check(run, plain, cfg, sp["lanes_tol"],
                          f"phase {phase}: the flash and plain lanes", forced)
        print(f"path {label}: flash vs plain attention on the card, teacher "
              f"forced: {got}", flush=True)
        del plain
    del params, run, routes
    torch.cuda.empty_cache()
    small_cfg, small = cut_of(sp)
    # drawn on the card (a CPU draw of billions of values takes minutes),
    # the same weights copied to the CPU
    p_card = api.init_params(SEED, small_cfg, device="cuda")
    set_gates(p_card, small_cfg, sp.get("gate"))
    p_cpu = api.map_tree(lambda t: t.cpu(), p_card)
    routes = []
    ops.reset_counts()
    with routes_into(routes):
        card = serve_run(None, p_card, True, small)
    got = ops.launch_counts()["flash_attention"]
    want = flash_layers(small_cfg, sp["cut_prompt"])
    if got != want:
        fail(f"phase {phase}: {got} flash launches at {sp['cut']} layers, "
             f"not {want}")
    t0 = time.perf_counter()
    cpu, forced = forced_run(
        torch, small_cfg, routes, lambda: serve_run(
            "cpu", p_cpu, True, small, feed=card["tokens"][:, :-1]))
    serve_oracle(card, small, small_cfg.vocab, f"phase {phase} "
                 f"({sp['cut']} layers)")
    got = lanes_check(card, cpu, small_cfg, sp["cut_tol"],
                      f"phase {phase}: {sp['cut']} layers on the card "
                      f"against the CPU", forced)
    enc = f" (and {small_cfg.enc_layers} encoder layers)" \
        if small_cfg.is_encdec else ""
    print(f"path {label}: {sp['cut']} layers{enc} at full width, S="
          f"{sp['cut_prompt']}, B={sp['cut_batch']}: card vs CPU ("
          f"{time.perf_counter() - t0:.3f} s) {got}", flush=True)
    del p_card, p_cpu, card, cpu, routes
    torch.cuda.empty_cache()
    return counts


# -- phase j: training qwen2.5-3b ---------------------------------------------

def train_run(mode: str, *, arch=ARCH, device=None, layers=TRAIN_LAYERS,
              seq=TRAIN_SEQ, batch=TRAIN_BATCH, reduced=False,
              shard="zero1", steps=TRAIN_STEPS, flash=False) -> dict:
    """``train_loop`` of ``arch`` for ``steps`` steps on uniform tokens
    (random weights from the loop's seed, 0), in ``mode`` (the inc mode)
    and the ``shard`` mode (zero1 or fsdp; None: the arch's own);
    ``flash``: the attention through kernel 11 and its backward
    kernels."""
    from repro_torch.launch.train import train_loop
    return train_loop(arch=arch, inc_mode=mode, steps_n=steps,
                      seq=seq, batch=batch, reduced=reduced,
                      precision=PRECISION, data_kind="uniform", log_every=1,
                      device=device, layers=layers, mode=shard, flash=flash)


def scattered_leaves(cfg) -> int:
    """Leaves the train step reduce-scatters (one quantize, sat_add and
    dequantize each in netrpc) on one rank."""
    from repro_torch.launch import steps
    from repro_torch.models import api
    dims = steps.scatter_dims_tree(api.param_shapes(cfg), 1, 1)
    return sum(d >= 0 for d in dims.values())


def gathered_leaves(cfg) -> int:
    """Gathers of one fsdp microbatch on one rank, each one quantize,
    sat_add and dequantize launch in its backward (netrpc): a stacked
    scattered leaf once a layer of its stack, any other scattered leaf
    once."""
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.sharding import rules
    shapes = dict(api.named_leaves(api.param_shapes(cfg)))
    dims = steps.scatter_dims_tree(api.param_shapes(cfg), 1, 1)
    return sum((shapes[n].shape[0] if rules._is_stacked(n) else 1)
               for n, d in dims.items() if d >= 0)


def train_oracle(run: dict, vocab: int, what: str, steps=TRAIN_STEPS,
                 window=None) -> tuple:
    """Every one of ``steps`` steps ran with a finite loss; step 0's lies
    within ``window`` (a cut's own, Y_STEP0; returned), by default
    [ln(vocab) - STEP0_BELOW, ln(vocab) + STEP0_ABOVE]: on uniform targets
    the expected loss of any logits is lse - mean >= ln(vocab), so a
    sample of thousands of tokens lands above the lower end; the random
    tied embedding puts it above ln(vocab) (each position's own token
    gets a logit near sqrt(d_model), diluted by depth: 12.485 at 36
    full-width layers on the card), and a forward that goes wrong or
    diverges lands far above the upper end. The telemetry counted and
    committed every step."""
    losses = run["losses"]
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        fail(f"{what}: losses {losses}")
    low, high = window or (np.log(vocab) - STEP0_BELOW,
                           np.log(vocab) + STEP0_ABOVE)
    if not low <= losses[0] <= high:
        fail(f"{what}: step 0's loss {losses[0]:.4f} lies outside "
             f"[{low:.4f}, {high:.4f}] (ln({vocab}) = {np.log(vocab):.4f})")
    inc = run["inc_telemetry"]
    if inc["commits"] != steps or inc["metrics"].get("steps") != steps:
        fail(f"{what}: telemetry committed {inc['commits']} and counted "
             f"{inc['metrics'].get('steps')} of {steps} steps")
    return low, high


def modes_oracle(a: dict, b: dict, what: str) -> float:
    """netrpc and fp32-ring from the same state: the same loss at each
    step within MODES_TOL; returns the largest relative difference."""
    err = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"]))
    if err > MODES_TOL:
        fail(f"{what}: netrpc and fp32-ring losses differ by {err:.2e} "
             f"> {MODES_TOL} ({a['losses']} vs {b['losses']})")
    return err


def step_pair(torch, mesh_card, mesh_cpu, shard: str | None = "zero1",
              cfg=None, phase: str | None = None, seq=TRAIN_SMALL_SEQ,
              gate=None, device="cuda") -> None:
    """One netrpc step of ``cfg`` (by default ARCH at TRAIN_SMALL_LAYERS
    full-width layers) on the card and on the CPU from the same params,
    optimizer state and tokens (with the model's stub frames or patches),
    in the ``shard`` mode (None: the arch's own; one rank: the state is
    whole in both). ``gate`` sets every cross layer's gate first. Where
    the model has moe layers the CPU's routing is teacher forced to the
    card's (``routes_forced``, each layer's forward and its checkpoint's
    recompute): a near tie between two experts flips under bf16 rounding.
    ``device`` stands for the card (the rehearsal passes the CPU)."""
    import copy as _copy

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.inc_agg import IncAggConfig
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.launch.serve import model_config
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import rules
    cfg = cfg or model_config(ARCH, layers=TRAIN_SMALL_LAYERS)
    mode = shard or rules.mode_for(cfg.name)
    phase = phase or ("j" if mode == "zero1" else "t")
    shape = ShapeConfig(f"{phase}_small", seq, TRAIN_BATCH, "train")
    kw = dict(inc=IncAggConfig(mode="netrpc", precision=PRECISION),
              opt_cfg=AdamWConfig(warmup_steps=5, total_steps=100),
              n_micro=1, mode=mode)
    p_cpu = api.init_params(SEED, cfg, device="cpu")
    set_gates(p_cpu, cfg, gate)
    o_cpu = steps.init_opt(p_cpu)
    p_card = _copy.deepcopy(p_cpu).to(device)
    o_card = {k: _copy.deepcopy(v).to(device) for k, v in o_cpu.items()}
    batch = pipeline.add_modality_stubs(pipeline.make_batch(
        pipeline.DataConfig(vocab=cfg.vocab, batch=TRAIN_BATCH, seq_len=seq,
                            seed=SEED, kind="uniform"), TRAIN_CPU_STEP),
        cfg, TRAIN_BATCH)
    card = steps.build_train_step(cfg, shape, mesh_card, device=device,
                                  **kw)
    cpu = steps.build_train_step(cfg, shape, mesh_cpu, device="cpu", **kw)
    routes, flips = [], []
    with routes_into(routes):
        _, o_card, m_card = card.fn(p_card, o_card, batch, TRAIN_CPU_STEP)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (routes_forced(routes, flips) if moe_layers(cfg)
          else contextlib.nullcontext()):
        _, o_cpu, m_cpu = cpu.fn(p_cpu, o_cpu, batch, TRAIN_CPU_STEP)
    cpu_s = time.perf_counter() - t0
    forced = "" if not flips else (
        f"; the CPU's routing teacher forced to the card's: its own top-"
        f"{cfg.top_k} differed for {sum(int(f.sum()) for f in flips)} of "
        f"{sum(f.numel() for f in flips)} (token, call) routes over "
        f"{len(flips)} calls of route (each moe layer's forward and "
        f"recompute)")
    lr = float(m_cpu["lr"])
    if float(m_card["lr"]) != lr:
        fail(f"phase {phase}: the card's learning rate is not the CPU's")
    loss_err = abs(float(m_card["loss"]) / float(m_cpu["loss"]) - 1)
    gnorm_err = abs(float(m_card["gnorm"]) / float(m_cpu["gnorm"]) - 1)
    d = torch.cat([(a.cpu() - b).abs().reshape(-1) for (_, a), (_, b) in
                   zip(api.named_leaves(o_card["master"]),
                       api.named_leaves(o_cpu["master"]))])
    far = float((d > lr / 100).float().mean())
    # after a step from zero m and v, m = (1 - b1) g and v = (1 - b2) g^2
    # of each leaf's aggregated gradient: they carry the magnitudes that
    # one step's master update (about lr sign(g)) does not
    mv_err, mv_worst = 0.0, ""
    for k in ("m", "v"):
        for (name, a), (_, b) in zip(api.named_leaves(o_card[k]),
                                     api.named_leaves(o_cpu[k])):
            e = float(torch.linalg.vector_norm((a.cpu() - b).double())
                      / torch.linalg.vector_norm(b.double()))
            if not e <= mv_err:
                mv_err, mv_worst = e, f"{k} {name}"
    width = ("full width" if cfg.d_model == model_config(cfg.name).d_model
             else f"the reduced width (d_model {cfg.d_model})")
    print(f"path {phase}_train: {cfg.name}, {cfg.n_layers} layers at "
          f"{width}, S={seq}, B={TRAIN_BATCH}, one {mode} netrpc step, "
          f"card vs CPU "
          f"({cpu_s:.3f} s on the CPU): loss {float(m_card['loss']):.6f} vs "
          f"{float(m_cpu['loss']):.6f} (rel {loss_err:.2e}, tolerance "
          f"{TRAIN_LOSS_RTOL}), gnorm rel {gnorm_err:.2e} (tolerance "
          f"{TRAIN_GNORM_RTOL}); masters: max|d| {float(d.max()) / lr:.4f} "
          f"lr (tolerance 2.5), {far:.6f} of {d.numel()} more than lr/100 "
          f"apart (tolerance {MASTER_FLIP_FRAC}); m and v: worst leaf "
          f"{mv_worst}, ||card - CPU|| / ||CPU|| {mv_err:.3e} (tolerance "
          f"{MV_RTOL}){forced}", flush=True)
    if not (loss_err <= TRAIN_LOSS_RTOL and gnorm_err <= TRAIN_GNORM_RTOL
            and float(d.max()) <= 2.5 * lr and far <= MASTER_FLIP_FRAC
            and mv_err <= MV_RTOL):
        fail(f"phase {phase}: the card's train step of {cfg.name} differs "
             f"from the CPU's")


def profile_train(torch, run: dict, mesh, flash: bool, label: str) -> None:
    """Two more netrpc steps of phase j's shape on the trained state, the
    attention on the ``flash`` lane: one under the profiler (the card's
    busy share, the top kernels and the flash kernels), one with the stage
    clock (the stream's ms per stage of launch/steps.py, CUDA events)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.inc_agg import IncAggConfig
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.launch.serve import model_config
    from repro_torch.optim.adamw import AdamWConfig
    cfg = model_config(ARCH, layers=TRAIN_LAYERS)
    prog = steps.build_train_step(
        cfg, ShapeConfig("j", TRAIN_SEQ, TRAIN_BATCH, "train"), mesh,
        inc=IncAggConfig(mode="netrpc", precision=PRECISION),
        opt_cfg=AdamWConfig(warmup_steps=5, total_steps=TRAIN_STEPS),
        n_micro=1, flash=flash, device="cuda")
    batch = pipeline.shard_batch(pipeline.make_batch(pipeline.DataConfig(
        vocab=cfg.vocab, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=SEED,
        kind="uniform"), TRAIN_STEPS), "cuda")

    def step():
        prog.fn(run["params"], run["opt"], batch, TRAIN_STEPS)
    wall, share, top = busy_share(torch, step)
    print(f"path {label} profile, one netrpc step: {wall * 1e3:.3f} ms "
          f"(wall, profiler on), card busy {share:.4f} of it; top kernels "
          f"and the flash kernels (ms): {top}", flush=True)
    step()
    stages = prog.meta["clock"].ms()
    print(f"path {label}, one netrpc step by stage (ms of the card's stream "
          "between CUDA events, profiler off): " + ", ".join(
              f"{k} {v:.3f}" for k, v in stages.items())
          + f"; total {sum(stages.values()):.3f}", flush=True)


def check_train(torch, smi: str) -> dict:
    """Phase j on the card: both modes at full width and the
    TRAIN_SMALL_LAYERS-layer step against the CPU (phase z profiles a
    step)."""
    from repro_torch import compat
    from repro_torch.launch.serve import model_config
    from repro_torch.launch.mesh import one_rank_group
    cfg = model_config(ARCH, layers=TRAIN_LAYERS)
    leaves = scattered_leaves(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with one_rank_group(torch.device("cuda")):
        mesh = compat.make_mesh((1, 1), ("data", "model"))
        run, counts, secs = counted(
            torch, lambda: train_run("netrpc"),
            "phase j (train, netrpc)",
            ("quantize", "sat_add", "dequantize", "sparse_addto"))
        peak = torch.cuda.max_memory_allocated()
        train_oracle(run, cfg.vocab, "phase j (netrpc)")
        for name in ("quantize", "sat_add", "dequantize"):
            if counts[name] != leaves * TRAIN_STEPS:
                fail(f"phase j: {counts[name]} {name} launches, not one per "
                     f"scattered leaf ({leaves}) and step")
        if counts["flash_attention"]:
            fail("phase j: the train step launched the flash kernel")
        warm = statistics.mean(run["step_s"][1:])
        print(f"path j_train: {ARCH}, {run['n_layers']} of "
              f"{model_config(ARCH).n_layers} layers, d_model {cfg.d_model}, "
              f"B={TRAIN_BATCH} x S={TRAIN_SEQ}, netrpc (precision "
              f"{PRECISION}): {secs:.3f} s for {TRAIN_STEPS} steps; losses "
              f"{run['losses']}; step seconds {run['step_s']}; warm step "
              f"{warm:.6f} s, {TRAIN_BATCH * TRAIN_SEQ / warm:.3f} tokens/s; "
              f"peak device memory {peak / 2 ** 30:.3f} GiB; {leaves} "
              f"scattered leaves; launches {counts}", flush=True)
        print(f"path j_train card: {smi}", flush=True)
        MEASURED["j"] = {"s": warm, "peak": peak, "launches": {
            n: counts[n] // TRAIN_STEPS
            for n in ("quantize", "sat_add", "dequantize")}}
        netrpc_losses = {"losses": run["losses"]}
        TRAIN_J["losses"] = list(run["losses"])
        TRAIN_J["gnorm0"] = run["gnorms"][0]
        TRAIN_J["m_attn"] = attn_moments(run)
        del run
        torch.cuda.empty_cache()
        ring, ring_counts, ring_s = counted(
            torch, lambda: train_run("fp32-ring"),
            "phase j (train, fp32-ring)", ("sparse_addto",))
        train_oracle(ring, cfg.vocab, "phase j (fp32-ring)")
        err = modes_oracle(netrpc_losses, ring, "phase j")
        print(f"path j_train: fp32-ring {ring_s:.3f} s, losses "
              f"{ring['losses']}, step seconds {ring['step_s']}; netrpc vs "
              f"fp32-ring max relative loss difference {err:.2e} "
              f"(tolerance {MODES_TOL}); launches {ring_counts}", flush=True)
        del ring
        torch.cuda.empty_cache()
        step_pair(torch, mesh, compat.make_mesh((1, 1), ("data", "model"),
                                                device="cpu"))
    return {k: counts[k] + ring_counts[k] for k in counts}


# -- phase x: the dry run of phases i and j -----------------------------------

def dryrun_programs(reduced: bool = False, y: bool = False,
                    z: bool = False) -> None:
    """Phase x's child process: a fake world of one rank, and the counter
    of ``roofline.analysis`` over phase i's prefill program (flash) and
    phase j's netrpc train step, at their shapes on the meta device
    (``reduced``: the rehearsal's 2-layer reduced qwen2.5-3b at 2 x 64);
    ``y``: phase y's Y_FULL netrpc train steps instead, at theirs (the
    prediction of their peaks); ``z``: phase z's, j's step with
    ``flash=True`` (at the reduced size with ``reduced``). Prints one
    JSON line: each program's summary."""
    from repro_torch import compat
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.inc_agg import IncAggConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import model_config
    from repro_torch.optim.adamw import AdamWConfig
    sp = SERVES["i"]
    train = dict(inc=IncAggConfig(mode="netrpc", precision=PRECISION),
                 opt_cfg=AdamWConfig(warmup_steps=5, total_steps=TRAIN_STEPS),
                 n_micro=1)
    if y:
        progs = {arch: (model_config(arch, layers=layers),
                        ShapeConfig(f"y_{arch}", seq, batch, "train"), train)
                 for arch, layers, batch, seq in Y_FULL}
    elif z:
        cfg = model_config(ARCH, reduced=reduced,
                           layers=2 if reduced else TRAIN_LAYERS)
        shape = ShapeConfig("x_z", 64, 2, "train") if reduced \
            else ShapeConfig("x_z", TRAIN_SEQ, TRAIN_BATCH, "train")
        progs = {"z": (cfg, shape, dict(train, flash=True))}
    elif reduced:
        cfg = model_config(ARCH, reduced=True, layers=2)
        progs = {"i": (cfg, ShapeConfig("x_i", 64, 2, "prefill"),
                       dict(flash=True)),
                 "j": (cfg, ShapeConfig("x_j", 64, 2, "train"), train)}
    else:
        cfg = model_config(ARCH, layers=TRAIN_LAYERS)
        progs = {"i": (cfg, ShapeConfig("x_i", sp["prompt"], sp["batch"],
                                        "prefill"), dict(flash=True)),
                 "j": (cfg, ShapeConfig("x_j", TRAIN_SEQ, TRAIN_BATCH,
                                        "train"), train)}
    dryrun.fake_world(1)
    mesh = compat.make_mesh((1, 1), ("data", "model"), device="meta")
    out = {}
    for label, (cfg, shape, kw) in progs.items():
        _, roof, secs = dryrun.count_program(cfg, shape, mesh, **kw)
        out[label] = dict(roof.summary(), trace_s=secs)
    print(json.dumps(out), flush=True)


def dryrun_start(reduced: bool = False, y: bool = False,
                 z: bool = False) -> subprocess.Popen:
    """``dryrun_programs`` started in a child process (a fake world of its
    own, beside this process's NCCL groups); ``dryrun_result`` reads
    it."""
    code = ("import chip_smoke as c; "
            f"c.dryrun_programs(reduced={reduced!r}, y={y!r}, z={z!r})")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def dryrun_result(proc: subprocess.Popen, what: str) -> dict:
    """The summaries a ``dryrun_start`` child printed; fails if it did."""
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"{what}: the dry run passed 600 s")
    if proc.returncode != 0:
        fail(f"{what}: the dry run failed:\n{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def dryrun_run(reduced: bool = False, y: bool = False) -> dict:
    """``dryrun_programs`` in a child process: its summaries. With ``y``
    (``python3 -c "import chip_smoke as c; c.dryrun_run(y=True)"``) it
    prints each Y_FULL step's peak too."""
    got = dryrun_result(dryrun_start(reduced, y), "phase x")
    if y:
        for arch, d in got.items():
            print(f"dry run of phase y's {arch} netrpc step: peak "
                  f"{d['peak_bytes'] / 2 ** 30:.3f} GiB, FLOPs "
                  f"{d['flops_per_dev']:.6e}, HBM bytes "
                  f"{d['hbm_bytes_per_dev']:.6e}, compute {d['compute_s']:.6f}"
                  f" s, memory {d['memory_s']:.6f} s ({d['trace_s']:.3f} s on "
                  f"the host)", flush=True)
    return got


def check_phase_x(torch, smi: str) -> dict:
    """Phase x: the dry run's counts of phase i's prefill and j's train
    step against what i and j measured on the card: kernel 11's records
    a prefill and kernels 7/6/8's a step equal to their launches, the peak
    within X_PEAK_RTOL of ``max_memory_allocated``; prints the FLOPs, HBM
    bytes, roofline time and the roofline share of the measured time."""
    t0 = time.perf_counter()
    # phase z's dry run, in a child of its own beside this one's: read in z
    DRY_Z["proc"] = dryrun_start(z=True)
    dry = dryrun_run()
    total = torch.cuda.get_device_properties(0).total_memory
    for label, what in (("i", "prefill"), ("j", "warm train step")):
        d, m = dry[label], MEASURED[label]
        roof_s = max(d["compute_s"], d["memory_s"], d["collective_s"])
        records = {k: d["kernels"].get(k, {}).get("launches", 0)
                   for k in m["launches"]}
        peak_err = d["peak_bytes"] / m["peak"] - 1
        print(f"path x_dryrun {label}: {what} on the meta device "
              f"({d['trace_s']:.3f} s on the host, {d['n_ops']} ops): FLOPs "
              f"{d['flops_per_dev']:.6e}, HBM bytes "
              f"{d['hbm_bytes_per_dev']:.6e}, compute {d['compute_s']:.6f} "
              f"s, memory {d['memory_s']:.6f} s, roofline {roof_s:.6f} s "
              f"({d['dominant']}), peak {d['peak_bytes'] / 2 ** 30:.3f} GiB; "
              f"measured on the card {m['s']:.6f} s, peak "
              f"{m['peak'] / 2 ** 30:.3f} GiB (max_memory_allocated; dry "
              f"run {peak_err:+.4f}, tolerance {X_PEAK_RTOL}); roofline "
              f"share {roof_s / m['s']:.4f}; kernel records {records}, "
              f"launches {m['launches']}", flush=True)
        if records != m["launches"]:
            fail(f"phase x: the dry run of {label} recorded {records} "
                 f"kernel launches, the card launched {m['launches']}")
        if not abs(peak_err) <= X_PEAK_RTOL:
            fail(f"phase x: the dry run's peak of {label} is {peak_err:+.4f} "
                 f"from the card's")
    secs = time.perf_counter() - t0
    print(f"path x_dryrun: {secs:.3f} s (budget {X_BUDGET}); the card's "
          f"total_memory {total} bytes; card: {smi}", flush=True)
    if secs > X_BUDGET:
        fail(f"phase x took {secs:.3f} s, past its {X_BUDGET} s")
    return {}


# -- phase z: phase j's train step through the flash kernels ------------------

def attn_moments(run: dict) -> dict:
    """The Adam first moment m of every attention leaf of a train run's
    optimizer state, on the host."""
    from repro_torch.models import api
    return {n: t.detach().float().cpu()
            for n, t in api.named_leaves(run["opt"]["m"]) if ".attn." in n}


def z_oracle(run: dict, j: dict, what: str) -> tuple[float, float, tuple]:
    """Each step's loss within Z_LOSS_RTOL (relative) of phase j's netrpc
    loss at the same step, step 0's gnorm within Z_GNORM_RTOL of j's and
    each attention leaf's m within Z_M_RTOL (relative norm) of j's;
    returns the largest loss difference, the gnorm's and (the leaf, its
    m difference) of the worst leaf."""
    err = max(abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                   j["losses"]))
    if not err <= Z_LOSS_RTOL:
        fail(f"{what}: losses {run['losses']} differ from phase j's "
             f"{j['losses']} by {err:.2e} > {Z_LOSS_RTOL} (relative)")
    g_err = abs(run["gnorms"][0] / j["gnorm0"] - 1)
    if not g_err <= Z_GNORM_RTOL:
        fail(f"{what}: step 0's gnorm {run['gnorms'][0]} differs from "
             f"phase j's {j['gnorm0']} by {g_err:.2e} > {Z_GNORM_RTOL} "
             f"(relative)")
    mine = attn_moments(run)
    if set(mine) != set(j["m_attn"]) or not mine:
        fail(f"{what}: attention leaves {sorted(mine)} against phase j's "
             f"{sorted(j['m_attn'])}")
    m_err = max(((float((mine[n] - w).norm() / w.norm()), n)
                 for n, w in j["m_attn"].items()),
                key=lambda e: (not np.isfinite(e[0]), e[0]))
    if not m_err[0] <= Z_M_RTOL:
        fail(f"{what}: leaf {m_err[1]}'s m is {m_err[0]:.3e} from phase "
             f"j's (relative norm) > {Z_M_RTOL}")
    return err, g_err, m_err


def z_launches(counts: dict, layers: int, leaves: int, steps: int,
               what: str) -> None:
    """Kernel 11 twice a flashed layer and step (the forward and the
    checkpoint's recompute), each backward kernel once, and kernels 7/6/8
    once a scattered leaf and step."""
    want = {"flash_attention": 2 * layers * steps}
    want.update({n: layers * steps for n in BWD_KERNELS})
    want.update({n: leaves * steps
                 for n in ("quantize", "sat_add", "dequantize")})
    got = {n: counts[n] for n in want}
    if got != want:
        fail(f"{what}: launches {got}, not {want}")


def check_phase_z(torch, smi: str) -> dict:
    """Phase z: phase j's netrpc run with ``flash=True`` (the reference's
    REPRO_FLASH_ATTN=1 train path): j's oracle, ``z_oracle`` against j's
    run, the launches as ``z_launches`` reckons; the peak
    against j's and against the dry run's prediction for the same step
    (computed in a child process that phase x starts), within
    X_PEAK_RTOL; then the
    profile of one step (phase j's, moved here to pay for the phase)."""
    from repro_torch import compat
    from repro_torch.launch.mesh import one_rank_group
    from repro_torch.launch.serve import model_config
    from repro_torch.roofline.flash_model import flashed_layers
    cfg = model_config(ARCH, layers=TRAIN_LAYERS)
    leaves = scattered_leaves(cfg)
    layers = sum(flashed_layers(cfg, TRAIN_SEQ))
    dry = DRY_Z.pop("proc", None) or dryrun_start(z=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with one_rank_group(torch.device("cuda")):
        mesh = compat.make_mesh((1, 1), ("data", "model"))
        run, counts, secs = counted(
            torch, lambda: train_run("netrpc", flash=True),
            "phase z (train through the flash kernels, netrpc)",
            ("flash_attention",) + BWD_KERNELS
            + ("quantize", "sat_add", "dequantize", "sparse_addto"))
        peak = torch.cuda.max_memory_allocated()
        train_oracle(run, cfg.vocab, "phase z (netrpc, flash)")
        err, g_err, (m_err, m_leaf) = z_oracle(run, TRAIN_J, "phase z")
        TRAIN_J.pop("m_attn")
        z_launches(counts, layers, leaves, TRAIN_STEPS, "phase z")
        warm = statistics.mean(run["step_s"][1:])
        d = dryrun_result(dry, "phase z")["z"]
        peak_err = d["peak_bytes"] / peak - 1
        j = MEASURED["j"]
        print(f"path z_train_flash: {ARCH}, {run['n_layers']} layers "
              f"({layers} through kernel 11 and its backward kernels), "
              f"d_model {cfg.d_model}, B={TRAIN_BATCH} x S={TRAIN_SEQ}, "
              f"netrpc (precision {PRECISION}): {secs:.3f} s for "
              f"{TRAIN_STEPS} steps; losses {run['losses']} (phase j's "
              f"{TRAIN_J['losses']}: max relative difference {err:.2e}, "
              f"window {Z_LOSS_RTOL}); step 0's gnorm {run['gnorms'][0]} "
              f"(phase j's {TRAIN_J['gnorm0']}: relative difference "
              f"{g_err:.2e}, window {Z_GNORM_RTOL}); attention leaves' m: "
              f"worst {m_leaf}, {m_err:.3e} from j's (window {Z_M_RTOL}); "
              f"step seconds {run['step_s']}; warm "
              f"step {warm:.6f} s, {TRAIN_BATCH * TRAIN_SEQ / warm:.3f} "
              f"tokens/s (phase j's plain lane {j['s']:.6f} s, "
              f"{TRAIN_BATCH * TRAIN_SEQ / j['s']:.3f} tokens/s); peak "
              f"device memory {peak / 2 ** 30:.3f} GiB (phase j's "
              f"{j['peak'] / 2 ** 30:.3f}; the dry run's prediction "
              f"{d['peak_bytes'] / 2 ** 30:.3f}, {peak_err:+.4f}, tolerance "
              f"{X_PEAK_RTOL}; its compute {d['compute_s']:.6f} s, memory "
              f"{d['memory_s']:.6f} s, flash records "
              f"{ {k: v['launches'] for k, v in d['kernels'].items() if 'flash' in k} }); "
              f"{leaves} scattered leaves; launches {counts}; card: {smi}",
              flush=True)
        if not abs(peak_err) <= X_PEAK_RTOL:
            fail(f"phase z: the dry run's peak is {peak_err:+.4f} from the "
                 f"card's")
        profile_train(torch, run, mesh, True, "z_train_flash")
        del run
        torch.cuda.empty_cache()
    return counts


# -- phase t: the fsdp mode of the train step ---------------------------------

def fsdp_oracle(run: dict, zero1: list, what: str) -> float:
    """Each step's fsdp loss within FSDP_TOL of zero1's on the same seed
    and batches; returns the largest difference."""
    err = max(abs(a - b) for a, b in zip(run["losses"], zero1))
    if len(run["losses"]) != len(zero1) or not err <= FSDP_TOL:
        fail(f"{what}: fsdp losses {run['losses']} and zero1's {zero1} "
             f"differ by {err:.2e} > {FSDP_TOL}")
    return err


def fsdp_stages(torch, run: dict, mesh) -> dict:
    """Two more fsdp netrpc steps on the trained state: one under the
    profiler (the card's busy share and top kernels), one with the stage
    clock (ms of the card's stream between CUDA events)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.inc_agg import IncAggConfig
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.launch.serve import model_config
    from repro_torch.optim.adamw import AdamWConfig
    cfg = model_config(ARCH, layers=TRAIN_LAYERS)
    prog = steps.build_train_step(
        cfg, ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH, "train"), mesh,
        inc=IncAggConfig(mode="netrpc", precision=PRECISION),
        opt_cfg=AdamWConfig(warmup_steps=5, total_steps=TRAIN_STEPS),
        n_micro=1, mode="fsdp", device="cuda")
    batch = pipeline.shard_batch(pipeline.make_batch(pipeline.DataConfig(
        vocab=cfg.vocab, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=SEED,
        kind="uniform"), TRAIN_STEPS), "cuda")
    def step():
        prog.fn(run["params"], run["opt"], batch, TRAIN_STEPS)
    wall, share, top = busy_share(torch, step)
    print(f"path t_fsdp profile, one fsdp netrpc step: {wall * 1e3:.3f} ms "
          f"(wall, profiler on), card busy {share:.4f} of it; top kernels "
          f"(ms): {top}", flush=True)
    step()
    return prog.meta["clock"].ms()


def check_fsdp(torch, smi: str) -> dict:
    """Phase t on the card: fsdp at full width against phase j's zero1,
    its gathers' launches, one step's stages, the TRAIN_SMALL_LAYERS-layer
    step against the CPU."""
    from repro_torch import compat
    from repro_torch.launch.serve import model_config
    from repro_torch.launch.mesh import one_rank_group
    if "losses" not in TRAIN_J:
        fail("phase t needs phase j's zero1 losses: run phase j first")
    cfg = model_config(ARCH, layers=TRAIN_LAYERS)
    gathers = gathered_leaves(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with one_rank_group(torch.device("cuda")):
        mesh = compat.make_mesh((1, 1), ("data", "model"))
        run, counts, secs = counted(
            torch, lambda: train_run("netrpc", shard="fsdp"),
            "phase t (train, fsdp)",
            ("quantize", "sat_add", "dequantize", "sparse_addto"))
        peak = torch.cuda.max_memory_allocated()
        train_oracle(run, cfg.vocab, "phase t (fsdp)")
        err = fsdp_oracle(run, TRAIN_J["losses"], "phase t")
        for name in ("quantize", "sat_add", "dequantize"):
            if counts[name] != gathers * TRAIN_STEPS:
                fail(f"phase t: {counts[name]} {name} launches, not one per "
                     f"gather ({gathers} a step) and step")
        if counts["flash_attention"]:
            fail("phase t: the train step launched the flash kernel")
        warm = statistics.mean(run["step_s"][1:])
        print(f"path t_fsdp: {ARCH}, {run['n_layers']} layers, d_model "
              f"{cfg.d_model}, B={TRAIN_BATCH} x S={TRAIN_SEQ}, fsdp netrpc "
              f"(precision {PRECISION}) on a (data=1, model=1) mesh: "
              f"{secs:.3f} s for {TRAIN_STEPS} steps; losses {run['losses']}"
              f" vs zero1's {TRAIN_J['losses']} (max |d| {err:.2e}, "
              f"tolerance {FSDP_TOL}); step seconds {run['step_s']}; warm "
              f"step {warm:.6f} s, {TRAIN_BATCH * TRAIN_SEQ / warm:.3f} "
              f"tokens/s; peak device memory {peak / 2 ** 30:.3f} GiB; "
              f"{gathers} gathers a step; launches {counts}", flush=True)
        stages = fsdp_stages(torch, run, mesh)
        print("path t_fsdp, one fsdp netrpc step by stage (ms of the card's "
              "stream between CUDA events): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in stages.items())
              + f"; total {sum(stages.values()):.3f}", flush=True)
        print(f"path t_fsdp card: {smi}", flush=True)
        del run
        torch.cuda.empty_cache()
        step_pair(torch, mesh, compat.make_mesh((1, 1), ("data", "model"),
                                                device="cpu"), shard="fsdp")
    return counts


# -- phase u: the serve step's sequence-sharded combine and q8 gather ---------

def seq_combine_run(torch, params, cfg, tokens, seq_axes, steps: int):
    """One prefill of ``tokens`` (1, S), then ``steps`` greedy decode steps
    with ``seq_axes`` (the cache's positions cut over them; over one rank
    the whole cache, through the combine's pmax and psums), and the same
    steps from a copy of the cache without: ({"seq", "whole": (logits
    (steps, 1, V), seconds)}, {"seq", "whole": the cache after})."""
    from repro_torch.launch.serve import grow_cache
    from repro_torch.models import api
    dev = tokens.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    s = tokens.shape[1]
    logits, cache = api.prefill(params, cfg, {"tokens": tokens}, flash=True)
    cache = grow_cache(cache, cfg, 1, s + steps)
    caches = {"seq": cache, "whole": tuple(
        {k: {n: t.clone() for n, t in e.items()} for k, e in g.items()}
        for g in cache)}
    out, feed = {}, [logits.argmax(-1)]
    for name, axes in (("seq", seq_axes), ("whole", None)):
        sync()
        t0 = time.perf_counter()
        every = []
        for i in range(steps):
            lg, _ = api.decode_step(params, cfg, feed[i], s + i, caches[name],
                                    seq_axes=axes)
            every.append(lg)
            if axes is not None:
                feed.append(lg.argmax(-1))
        sync()
        out[name] = (torch.stack(every), time.perf_counter() - t0)
    return out, caches


def seq_combine_oracle(torch, out: dict, caches: dict, what: str) -> None:
    same_cache = all(torch.equal(a, b)
                     for ga, gb in zip(caches["seq"], caches["whole"])
                     for k in ga for a, b in zip(ga[k].values(),
                                                 gb[k].values()))
    if not torch.equal(out["seq"][0], out["whole"][0]) or not same_cache:
        fail(f"{what}: the sequence-sharded decode's logits or cache differ "
             f"from the whole cache's")


def check_seq_combine(torch, smi: str) -> dict:
    """u1: qwen2.5-3b's decode steps with ``seq_axes`` (a one-rank NCCL
    mesh's data axes: the combine's pmax and two psums run, over one
    rank) and without, from one prefill's cache: the logits and the
    caches bitwise equal."""
    from repro_torch.data import pipeline
    from repro_torch.launch.mesh import make_host_mesh, one_rank_group
    from repro_torch.launch.serve import model_config
    from repro_torch.models import api
    cfg = model_config(ARCH)
    torch.cuda.empty_cache()
    params = api.init_params(SEED, cfg, device="cuda")
    tokens = pipeline.make_batch(pipeline.DataConfig(
        vocab=cfg.vocab, batch=1, seq_len=U1_PROMPT - 1, kind="uniform"),
        0)["tokens"].cuda()
    with one_rank_group(torch.device("cuda")):
        seq_axes = make_host_mesh(model=1).axes_of(("data",))
        (out, caches), counts, secs = counted(
            torch, lambda: seq_combine_run(torch, params, cfg, tokens,
                                           seq_axes, U1_STEPS),
            "phase u1 (decode, sequence-sharded at one rank)",
            ("flash_attention",))
    seq_combine_oracle(torch, out, caches, "phase u1")
    print(f"path u1_seq_combine: {ARCH}, {cfg.n_layers} layers, 1 x "
          f"{U1_PROMPT} tokens, {U1_STEPS} decode steps with seq_axes over "
          f"the one-rank NCCL mesh ({out['seq'][1]:.6f} s) and without ("
          f"{out['whole'][1]:.6f} s): logits and caches bitwise equal; "
          f"{secs:.3f} s; launches {counts}", flush=True)
    del params, caches, out
    torch.cuda.empty_cache()
    return counts


def check_q8_serve(torch, smi: str) -> dict:
    """u2: phase q's model and shapes in fsdp with the int8 gather, fed
    q's tokens: its logits against q's (the plain gather, at one rank the
    leaves themselves), then q's cut on the card against the CPU, both
    q8."""
    from repro_torch.launch.serve import model_config
    from repro_torch.models import api
    sp = SERVES["q"]
    if "q" not in SERVED:
        fail("phase u2 needs phase q's run: run phase q first")
    plain = SERVED.pop("q")
    cfg = model_config(sp["arch"], layers=sp["layers"])
    shape = dict(arch=sp["arch"], prompt_len=sp["prompt"],
                 decode_n=sp["decode"], batch=sp["batch"],
                 layers=sp["layers"])
    torch.cuda.empty_cache()
    params = api.init_params(SEED, cfg, device="cuda")
    set_gates(params, cfg, sp["gate"])
    torch.cuda.reset_peak_memory_stats()
    run, counts, secs = counted(
        torch, lambda: serve_run(None, params, True, shape, q8=True,
                                 feed=plain["tokens"][:, :-1]),
        "phase u2 (serve, q8)", ("flash_attention", "sparse_addto"))
    peak = torch.cuda.max_memory_allocated()
    serve_oracle(run, shape, cfg.vocab, "phase u2")
    if torch.equal(run["logits"].cpu(), plain["logits"]):
        fail("phase u2: the q8 gather left q's logits as they were")
    err = lanes_err(run, plain, cfg.vocab)
    top1 = float((run["logits"][..., :cfg.vocab].argmax(-1).cpu()
                  == plain["logits"][..., :cfg.vocab].argmax(-1))
                 .float().mean())
    print(f"path u2_q8_serve: {sp['arch']}, {cfg.n_layers} layers, fsdp "
          f"with the q8 gather, fed phase q's tokens: {secs:.3f} s; prefill "
          f"{sp['prompt']} tokens x{sp['batch']}: {run['prefill_s']:.6f} s; "
          f"decode {sp['decode']} steps: {run['decode_s']:.6f} s, "
          f"{sp['batch'] * sp['decode'] / run['decode_s']:.3f} tokens/s; "
          f"peak device memory {peak / 2 ** 30:.3f} GiB; against q's plain "
          f"gather: max|q8 - plain|/max|plain| {err:.6f}, top-1 agreement "
          f"{top1:.6f} of {run['tokens'].numel()}; launches {counts}",
          flush=True)
    print(f"path u2_q8_serve card: {smi}", flush=True)
    del params, run, plain
    torch.cuda.empty_cache()
    small_cfg = model_config(sp["arch"], layers=U2_CUT)
    small = dict(arch=sp["arch"], prompt_len=sp["cut_prompt"],
                 decode_n=U2_CUT_DECODE, batch=sp["cut_batch"],
                 layers=U2_CUT)
    p_card = api.init_params(SEED, small_cfg, device="cuda")
    set_gates(p_card, small_cfg, sp["gate"])
    p_cpu = api.map_tree(lambda t: t.cpu(), p_card)
    card = serve_run(None, p_card, True, small, q8=True)
    t0 = time.perf_counter()
    cpu = serve_run("cpu", p_cpu, True, small, q8=True,
                    feed=card["tokens"][:, :-1])
    serve_oracle(card, small, small_cfg.vocab, f"phase u2 ({U2_CUT} "
                 f"layers)")
    got = lanes_check(card, cpu, small_cfg, sp["cut_tol"],
                      f"phase u2: {U2_CUT} layers, q8, on the card "
                      f"against the CPU")
    print(f"path u2_q8_serve: {U2_CUT} layers at full width, S="
          f"{sp['cut_prompt']}, B={sp['cut_batch']}, {U2_CUT_DECODE} decode "
          f"steps, q8: card vs CPU ({time.perf_counter() - t0:.3f} s: the "
          f"CPU's prefill {cpu['prefill_s']:.3f} s, decode "
          f"{cpu['decode_s']:.3f} s) {got}", flush=True)
    del p_card, p_cpu, card, cpu
    torch.cuda.empty_cache()
    return counts


# -- phases v and w: tensor parallelism ---------------------------------------

def tp_case(case: tuple) -> dict:
    return dict(zip(TP_CASE, case))


def tp_config(case: dict, reduced: bool):
    """The case's model: at full width (the reduced width when
    ``reduced``), cut to its layers (whisper's encoder to its
    ``enc_layers``)."""
    from dataclasses import replace

    from repro_torch.launch.serve import model_config
    cfg = model_config(case["arch"], reduced=reduced, layers=case["layers"])
    if case["enc_layers"] is not None:
        cfg = replace(cfg, enc_layers=case["enc_layers"])
    return cfg


def tp_work(torch, cfg, mesh, device, params, tokens, batch, case) -> dict:
    """One tensor-parallel case's work on ``mesh``, this process one rank:
    the prefill and decode programs over ``params`` (the full tree; the
    rank keeps its cut), the decode teacher forced with ``tokens``
    (with the frames or patches of the arch), then, where the case trains,
    one netrpc train step on ``batch`` from ``params`` and a fresh
    optimizer state (the params are updated in place). Returns the logits
    of every step, the step's metrics and the rank's shards of m, v and the
    masters' update, with their specs, and the seconds of the serve and
    train parts (and the train step's stages, ms)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.inc_agg import IncAggConfig
    from repro_torch.launch import steps
    from repro_torch.launch.serve import grow_cache
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig
    b, prompt, total = case["batch"], case["prompt"], case["total"]
    t0 = time.perf_counter()

    def serve_prog(kind, s):
        return steps.build_serve_step(cfg, ShapeConfig(kind, s, b, kind),
                                      mesh, flash=True, device=device)
    pf, dec = serve_prog("prefill", prompt), serve_prog("decode", total)
    mine = api.shard_tree(params, pf.meta["param_specs"], mesh)
    logits, cache = pf.fn(mine, {**tokens, "tokens":
                                 tokens["tokens"][:, :prompt]})
    cache = grow_cache(cache, cfg, b // dec.meta["n_dp"], total)
    every = [logits]
    for i in range(case["decode"]):
        logits, cache = dec.fn(mine, tokens["tokens"][:, prompt + i],
                               prompt + i, cache)
        every.append(logits)
    out = {"logits": torch.stack(every).float().cpu()}
    del cache, every, logits
    t1 = time.perf_counter()
    out["seconds"] = {"serve": t1 - t0}
    if batch is None:
        return out
    prog = steps.build_train_step(
        cfg, ShapeConfig("v", case["seq"], b, "train"), mesh,
        inc=IncAggConfig(mode="netrpc", precision=PRECISION),
        opt_cfg=AdamWConfig(warmup_steps=5, total_steps=100), n_micro=1,
        device=device)
    opt = steps.init_opt(params, prog.meta["opt_specs"], mesh)
    before = {n: t.clone() for n, t in api.named_leaves(opt["master"])}
    _, opt, m = prog.fn(mine, opt, batch, TRAIN_CPU_STEP)
    out["metrics"] = {k: float(v) for k, v in m.items()}
    out["seconds"].update(train=time.perf_counter() - t1, **{
        f"{k} ms": v for k, v in prog.meta["clock"].ms().items()})
    out["state"] = {n: {"m": a, "v": b, "update": c - before[n]}
                    for (n, a), (_, b), (_, c) in zip(
                        api.named_leaves(opt["m"]), api.named_leaves(opt["v"]),
                        api.named_leaves(opt["master"]))}
    out["specs"] = prog.meta["opt_specs"]
    return out


def tp_inputs(cfg, case: dict):
    """A case's weights (drawn on the CPU from SEED), teacher-forced
    tokens (batch, prompt + decode) with the arch's stub frames or patches,
    and train batch (None where the case does not train)."""
    from repro_torch.data import pipeline
    from repro_torch.models import api
    b = case["batch"]
    params = api.init_params(SEED, cfg, device="cpu")
    tokens = pipeline.add_modality_stubs(pipeline.make_batch(
        pipeline.DataConfig(vocab=cfg.vocab, batch=b,
                            seq_len=case["prompt"] + case["decode"] - 1,
                            seed=SEED, kind="uniform"), 0), cfg, b)
    batch = None if case["seq"] is None else pipeline.add_modality_stubs(
        pipeline.make_batch(pipeline.DataConfig(
            vocab=cfg.vocab, batch=b, seq_len=case["seq"], seed=SEED,
            kind="uniform"), TRAIN_CPU_STEP), cfg, b)
    return params, tokens, batch


def _model_dim(spec) -> int | None:
    """The dim of a leaf that ``spec`` cuts over "model", or None."""
    from repro_torch.sharding import rules
    dims = [d for d, e in enumerate(spec)
            if "model" in rules._entry_axes(e)]
    return dims[0] if dims else None


def tp_rank(rank: int, world: int, out_dir: str, reduced: bool,
            cases: tuple) -> None:
    """One CPU rank of a (1, world) gloo mesh, each of ``cases`` in turn:
    saves its shards of the state (bf16; a leaf whole over "model" only
    from rank 0) and, rank 0, the logits, the metrics, the specs and the
    seconds, to ``out_dir``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from datetime import timedelta
    torch.set_num_threads(max(1, 8 // world))
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=V_TIMEOUT))
    try:
        mesh = make_host_mesh(model=world, device="cpu")
        for i, case in enumerate(map(tp_case, cases)):
            t0 = time.perf_counter()
            cfg = tp_config(case, reduced)
            params, tokens, batch = tp_inputs(cfg, case)
            draw = time.perf_counter() - t0
            out = tp_work(torch, cfg, mesh, "cpu", params, tokens, batch,
                          case)
            del params
            t0 = time.perf_counter()
            specs = {n: tuple(sp) for n, sp in out.pop("specs", {}).items()}
            state = {n: {k: t.bfloat16() for k, t in leaves.items()}
                     for n, leaves in out.pop("state", {}).items()
                     if rank == 0 or _model_dim(specs[n]) is not None}
            torch.save(state, f"{out_dir}/cpu-{i}-{rank}.pt")
            if rank == 0:
                out["seconds"].update(draw=draw,
                                      save=time.perf_counter() - t0)
                torch.save({**out, "specs": specs}, f"{out_dir}/cpu-{i}.pt")
    finally:
        dist.destroy_process_group()


def tp_compare(torch, card: dict, cpu: dict, shards: list, vocab: int,
               what: str) -> str:
    """Phase i's logits tolerance and phase j's step tolerances, the card
    (one rank) against the CPU ranks (``shards``: each rank's state): the
    logits of every step and, where the case trains, loss and gnorm, the
    masters' update (max|d| <= 2.5 lr, at most MASTER_FLIP_FRAC more than
    lr/100 apart) and m and v per leaf."""
    la, lb = card["logits"][..., :vocab], cpu["logits"][..., :vocab]
    if la.shape != lb.shape or not bool(la.isfinite().all()):
        fail(f"{what}: logits of the wrong shape or not finite")
    err = max(float((la[t] - lb[t]).abs().max() / lb[t].abs().max())
              for t in range(lb.shape[0]))
    got = f"logits max|d|/max|ref| {err:.6f} (tolerance {CPU_TOL})"
    if "metrics" not in card:
        if err > CPU_TOL:
            fail(f"{what}: {got}")
        return got
    mc, mp = card["metrics"], cpu["metrics"]
    lr = mp["lr"]
    loss_err = abs(mc["loss"] / mp["loss"] - 1)
    gnorm_err = abs(mc["gnorm"] / mp["gnorm"] - 1)
    d_max, n_far, n_all = 0.0, 0, 0
    mv_err, mv_worst = 0.0, ""
    for n, whole in card["state"].items():
        # on the card's device: the CPU ranks' shards go to it
        dev = whole["m"].device
        dim = _model_dim(cpu["specs"][n])
        cuts = [s[n] for s in shards] if dim is not None else [shards[0][n]]
        sq = {"m": [0.0, 0.0], "v": [0.0, 0.0]}
        for r, cut in enumerate(cuts):
            def mine(t):
                if dim is None:
                    return t.float()
                c = t.shape[dim] // len(cuts)
                return t.narrow(dim, r * c, c).float()
            d = (mine(whole["update"]) - cut["update"].to(dev).float()).abs()
            d_max = max(d_max, float(d.max()))
            n_far += int((d > lr / 100).sum())
            n_all += d.numel()
            for k in ("m", "v"):
                b = cut[k].to(dev).float()
                sq[k][0] += float(torch.linalg.vector_norm(mine(whole[k]) - b)
                                  ) ** 2
                sq[k][1] += float(torch.linalg.vector_norm(b)) ** 2
        for k, (num, den) in sq.items():
            e = (num / den) ** 0.5 if den else float(num > 0)
            if not e <= mv_err:
                mv_err, mv_worst = e, f"{k} {n}"
    far = n_far / n_all
    got += (f"; loss {mc['loss']:.6f} vs {mp['loss']:.6f} (rel "
            f"{loss_err:.2e}, tolerance {TRAIN_LOSS_RTOL}), gnorm rel "
            f"{gnorm_err:.2e} (tolerance {TRAIN_GNORM_RTOL}); masters' "
            f"update: max|d| {d_max / lr:.4f} lr (tolerance 2.5), "
            f"{far:.6f} of {n_all} more than lr/100 apart (tolerance "
            f"{MASTER_FLIP_FRAC}); m and v: worst leaf {mv_worst}, "
            f"||card - CPU|| / ||CPU|| {mv_err:.3e} (tolerance {MV_RTOL})")
    if mc["lr"] != lr or err > CPU_TOL or loss_err > TRAIN_LOSS_RTOL \
            or gnorm_err > TRAIN_GNORM_RTOL or d_max > 2.5 * lr \
            or far > MASTER_FLIP_FRAC or not mv_err <= MV_RTOL:
        fail(f"{what}: {got}")
    return got


def tp_pair(torch, device, reduced: bool, counted_run, cases: tuple,
            world: int, label: str) -> tuple:
    """A tensor-parallel phase's two runs: ``device`` at one rank (all of
    ``cases`` through one ``counted_run(run)``, which returns (result,
    counts)) while ``world`` spawned gloo ranks do the same work on the
    CPU; returns (for each case, the one-rank run and the CPU ranks'
    (rank 0's outputs, each rank's state)), counts, the CPU ranks'
    seconds from their spawn)."""
    import shutil

    import torch.multiprocessing as mp

    from repro_torch import compat
    from repro_torch.launch.mesh import one_rank_group
    from repro_torch.models import api
    out = ROOT / "build" / "chip_smoke" / f"phase_{label}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    ctx = mp.start_processes(tp_rank, args=(world, str(out), reduced, cases),
                             nprocs=world, join=False, start_method="spawn")
    dev = torch.device(device)

    def run():
        ones = []
        mesh = compat.make_mesh((1, 1), ("data", "model"), device=device)
        for case in map(tp_case, cases):
            cfg = tp_config(case, reduced)
            params, tokens, batch = tp_inputs(cfg, case)
            params = api.map_tree(lambda t: t.to(dev), params)
            tokens = {k: v.to(dev) for k, v in tokens.items()}
            ones.append(tp_work(torch, cfg, mesh, device, params, tokens,
                                batch, case))
            del params
        return ones
    try:
        with one_rank_group(dev):
            ones, counts = counted_run(run)
        deadline = t0 + V_TIMEOUT
        while not ctx.join(timeout=1):
            if time.perf_counter() > deadline:
                fail(f"phase {label}: the CPU ranks still ran after "
                     f"{V_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    cpu_s = time.perf_counter() - t0
    pairs = []
    for i, one in enumerate(ones):
        cpu = torch.load(out / f"cpu-{i}.pt")
        shards = [torch.load(out / f"cpu-{i}-{r}.pt", mmap=True)
                  for r in range(world)]
        pairs.append((one, (cpu, shards)))
    shutil.rmtree(out, ignore_errors=True)
    return pairs, counts, cpu_s


def check_tp_phase(torch, smi: str, label: str, cases: tuple, world: int,
                   flash_launches: int) -> dict:
    """Phase v or w: each case at full width, one rank on the card against
    ``world`` tensor-parallel gloo ranks on the CPU: the prefill and
    decode programs' logits and, where it trains, one netrpc train step;
    the card's flash launches must be ``flash_launches``."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    secs = {}
    trains = any(tp_case(c)["seq"] is not None for c in cases)

    def on_card(run):
        result, counts, secs["card"] = counted(
            torch, run, f"phase {label} (serve and train at one rank)",
            ("flash_attention",) + (("quantize", "sat_add", "dequantize")
                                    if trains else ()))
        return result, counts
    pairs, counts, cpu_s = tp_pair(torch, "cuda", False, on_card, cases,
                                   world, label)
    if counts["flash_attention"] != flash_launches:
        fail(f"phase {label}: {counts['flash_attention']} flash launches, "
             f"not {flash_launches}: one a layer of the prefill that takes "
             f"the kernel")
    for (card, (cpu, shards)), case in zip(pairs, map(tp_case, cases)):
        cfg = tp_config(case, False)
        t1 = time.perf_counter()
        got = tp_compare(torch, card, cpu, shards, cfg.vocab,
                         f"phase {label} {case['arch']}: one rank on the "
                         f"card against the tensor-parallel CPU ranks")
        train = "" if case["seq"] is None else (
            f", one netrpc train step at B={case['batch']} x "
            f"S={case['seq']}")
        enc = "" if case["enc_layers"] is None else \
            f" and {case['enc_layers']} encoder layer(s)"
        print(f"path {label}_tensor_parallel {case['arch']}: "
              f"{case['layers']} layers{enc} at full width (d_model "
              f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV "
              f"heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_padded}), prefill "
              f"{case['batch']} x {case['prompt']} tokens, {case['decode']} "
              f"decode steps{train}: the card at one rank (serve "
              + ", ".join(f"{k} {v:.3f}" for k, v in card["seconds"].items())
              + f") against {world} gloo ranks of a (1, {world}) mesh on "
              f"the host's CPU (rank 0: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in cpu["seconds"].items())
              + f"; the comparison {time.perf_counter() - t1:.3f} s): {got}",
              flush=True)
    print(f"path {label}_tensor_parallel: the card's run {secs['card']:.3f} "
          f"s, the CPU ranks {cpu_s:.3f} s from their spawn; "
          f"{time.perf_counter() - t0:.3f} s; launches {counts}", flush=True)
    print(f"path {label}_tensor_parallel card: {smi}", flush=True)
    del pairs
    torch.cuda.empty_cache()
    return counts


def check_phase_v(torch, smi: str) -> dict:
    """Phase v: qwen2.5-3b at full width over a (1, V_MODEL) mesh."""
    return check_tp_phase(torch, smi, "v", V_CASES, V_MODEL,
                          V_CASES[0][1])


def check_phase_w(torch, smi: str) -> dict:
    """Phase w: whisper-medium, mamba2-780m and recurrentgemma-9b at full
    width over a (1, W_MODEL) mesh; the flash kernel runs in whisper's
    selfcross prefill (its bidir encoder and cross-attention, mamba's
    ssd layers and recurrentgemma's local layer at a prompt inside its
    window take none)."""
    t0 = time.perf_counter()
    counts = check_tp_phase(torch, smi, "w", W_CASES, W_MODEL, 1)
    secs = time.perf_counter() - t0
    print(f"path w_tensor_parallel: {secs:.3f} s of the phase's budget of "
          f"{W_BUDGET} s", flush=True)
    return counts


def check_phase_u(torch, smi: str) -> dict:
    counts = check_seq_combine(torch, smi)
    for name, c in check_q8_serve(torch, smi).items():
        counts[name] = counts.get(name, 0) + c
    return counts


# -- phase y: training beyond qwen2.5-3b --------------------------------------

def y_train(torch, smi: str, arch: str, layers, batch: int, seq: int,
            steps: int, ring: bool) -> dict:
    """One model of phase y on the card through ``train_loop`` in the
    arch's own mode: ``steps`` netrpc steps (``train_oracle`` with the
    arch's step-0 window, one quantize, sat_add and dequantize launch a
    scattered leaf and step, no flash launch) and, where ``ring``, as
    many fp32-ring steps from the same state (``modes_oracle``). Returns
    the launches."""
    from repro_torch.launch.serve import model_config
    from repro_torch.sharding import rules
    cfg = model_config(arch, layers=layers)
    leaves = scattered_leaves(cfg)
    kw = dict(arch=arch, layers=layers, seq=seq, batch=batch, shard=None,
              steps=steps)
    what = f"phase y ({arch}, netrpc)"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run, counts, secs = counted(
        torch, lambda: train_run("netrpc", **kw), what,
        ("quantize", "sat_add", "dequantize", "sparse_addto"))
    peak = torch.cuda.max_memory_allocated()
    window = train_oracle(run, cfg.vocab, what, steps, Y_STEP0.get(arch))
    Y_READ[arch] = run["losses"][0]
    for name in ("quantize", "sat_add", "dequantize"):
        if counts[name] != leaves * steps:
            fail(f"{what}: {counts[name]} {name} launches, not one per "
                 f"scattered leaf ({leaves}) and step")
    if counts["flash_attention"]:
        fail(f"{what}: the train step launched the flash kernel")
    warm = statistics.mean(run["step_s"][1:] or run["step_s"])
    enc = (f" + {cfg.enc_layers} encoder layers over {cfg.frontend_tokens} "
           f"stub frames" if cfg.is_encdec else "")
    print(f"path y_train: {arch}, {cfg.n_layers} of "
          f"{model_config(arch).n_layers} layers{enc}, d_model "
          f"{cfg.d_model}, {rules.mode_for(arch)}, B={batch} x S={seq}, "
          f"netrpc (precision {PRECISION}): {secs:.3f} s for {steps} steps; "
          f"losses {run['losses']} (step 0's window [{window[0]:.4f}, "
          f"{window[1]:.4f}]); step seconds {run['step_s']}; "
          f"{'warm step' if steps > 1 else 'one step, cold'} {warm:.6f} s, "
          f"{batch * seq / warm:.3f} tokens/s; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB; {leaves} scattered leaves; launches "
          f"{counts}; card: {smi}", flush=True)
    netrpc = {"losses": run["losses"]}
    del run
    torch.cuda.empty_cache()
    if not ring:
        return counts
    what = f"phase y ({arch}, fp32-ring)"
    ring_run, ring_counts, ring_s = counted(
        torch, lambda: train_run("fp32-ring", **kw), what, ("sparse_addto",))
    train_oracle(ring_run, cfg.vocab, what, steps, window)
    err = modes_oracle(netrpc, ring_run, f"phase y ({arch})")
    print(f"path y_train: {arch} fp32-ring {ring_s:.3f} s, losses "
          f"{ring_run['losses']}, step seconds {ring_run['step_s']}; netrpc "
          f"vs fp32-ring max relative loss difference {err:.2e} (tolerance "
          f"{MODES_TOL}); launches {ring_counts}", flush=True)
    del ring_run
    torch.cuda.empty_cache()
    return {k: counts[k] + ring_counts[k] for k in counts}


def y_blind(torch, smi: str, device: str = "cuda",
            reduced: bool = False) -> float:
    """Step 0's loss of Y_BLIND's cut drawn from Y_BLIND_SEED (not the
    seed Y_CUT's run draws), at full width on the card held to Y_STEP0's
    window: the loss ``train_loop``'s first step computes, from its first
    batch, before any update. ``reduced``: the rehearsal's reduced width
    on the CPU, held only to a finite loss."""
    from repro_torch.data import pipeline
    from repro_torch.launch.serve import model_config
    from repro_torch.models import api
    arch, layers, batch, seq = Y_BLIND
    cfg = model_config(arch, reduced, None if reduced else layers)
    t0 = time.perf_counter()
    first = pipeline.shard_batch(pipeline.add_modality_stubs(
        pipeline.make_batch(pipeline.DataConfig(
            vocab=cfg.vocab, batch=batch, seq_len=seq, kind="uniform"), 0),
        cfg, batch), device)
    losses = {}
    for seed in (0, Y_BLIND_SEED):
        params = api.init_params(seed, cfg, device=device)
        with torch.no_grad():
            losses[seed] = float(api.train_loss(params, cfg, first,
                                                remat=False)[0])
        del params
    if device == "cuda":
        torch.cuda.empty_cache()
    what = (f"phase y's blind check ({arch}, {cfg.n_layers} layers, seed "
            f"{Y_BLIND_SEED}, B={batch} x S={seq})")
    loss = losses[Y_BLIND_SEED]
    # seed 0's forward is the step Y_CUT's run took: the same reading
    read = Y_READ.get(arch)
    if read is None and not reduced:
        fail(f"{what}: phase y's run of {arch} left no reading to hold "
             f"seed 0's forward to")
    if read is not None and not abs(losses[0] - read) <= 1e-3 * read:
        fail(f"{what}: seed 0's forward gives {losses[0]:.6f}, not the "
             f"{read:.6f} of phase y's run")
    low, high = (-np.inf, np.inf) if reduced else Y_STEP0[arch]
    if not (np.isfinite(loss) and low <= loss <= high):
        fail(f"{what}: step 0's loss {loss:.4f} lies outside Y_STEP0's "
             f"[{low}, {high}]")
    print(f"path y_blind: {what}: step 0's loss {loss:.6f} within "
          f"[{low}, {high}]" + ("" if reduced else
                                " (Y_STEP0, written before this draw was "
                                "read)")
          + f"; seed 0's forward {losses[0]:.6f} (phase y's run "
          f"{read}); {time.perf_counter() - t0:.3f} s; card: {smi}",
          flush=True)
    return loss


def check_phase_y(torch, smi: str) -> dict:
    """Phase y: Y_FULL at full width and depth in netrpc and fp32-ring,
    Y_CUT's one netrpc step at full width, then each family's reduced
    step on the card against the CPU (Y_PAIRS, ``step_pair``)."""
    from repro_torch import compat
    from repro_torch.launch.mesh import one_rank_group
    from repro_torch.launch.serve import model_config
    t0 = time.perf_counter()
    counts = {}
    with one_rank_group(torch.device("cuda")):
        for cases, steps, ring in ((Y_FULL, Y_STEPS, True),
                                   (Y_CUT, 1, False)):
            for arch, layers, batch, seq in cases:
                got = y_train(torch, smi, arch, layers, batch, seq, steps,
                              ring)
                for name, c in got.items():
                    counts[name] = counts.get(name, 0) + c
        y_blind(torch, smi)
        t1 = time.perf_counter()
        mesh = compat.make_mesh((1, 1), ("data", "model"))
        mesh_cpu = compat.make_mesh((1, 1), ("data", "model"), device="cpu")
        for arch in Y_PAIRS:
            step_pair(torch, mesh, mesh_cpu, shard=None,
                      cfg=model_config(arch, reduced=True), phase="y",
                      seq=Y_PAIR_SEQ, gate=Y_GATE)
    secs = time.perf_counter() - t0
    print(f"path y_train: {secs:.3f} s of the phase's budget of {Y_BUDGET} "
          f"s ({time.perf_counter() - t1:.3f} s the reduced steps card vs "
          f"CPU); card: {smi}", flush=True)
    return counts


# -- phase k: the int8 wire format --------------------------------------------

def drive_int8_wire(torch, device) -> dict:
    """ops.pack_int8 -> ops.unpack_int8 of the bucket and of a ragged
    stream on ``device``; returns the results as numpy."""
    from repro_torch.kernels import ops
    out = {}
    for n in (BUCKET, RAGGED):
        x = torch.from_numpy(bucket(np.random.RandomState(10), n)).to(device)
        q, s = ops.pack_int8(x)
        y = ops.unpack_int8(q, s, n)
        out.update({f"{n}|q": q.cpu().numpy(), f"{n}|s": s.cpu().numpy(),
                    f"{n}|y": y.cpu().numpy()})
    return out


def int8_wire_oracle(got: dict) -> None:
    """Whole 256 x 128 tiles, and every element within half an int8 step
    of its input (amax / 254, with an ulp of slack)."""
    for n in (BUCKET, RAGGED):
        x = bucket(np.random.RandomState(10), n)
        q, y = got[f"{n}|q"], got[f"{n}|y"]
        if q.shape != (-(-n // (256 * 128)) * 256, 128) or y.shape != (n,):
            fail(f"k_int8_wire: shapes {q.shape}, {y.shape} for n={n}")
        amax = np.abs(np.pad(x, (0, (-n) % 128))).reshape(-1, 128).max(1)
        if not np.all(np.abs(y - x) <= np.repeat(amax / 254.0 * (1 + 1e-5),
                                                 128)[:n]):
            fail(f"k_int8_wire: the round trip of n={n} is off its grid")


def check_int8_wire(torch, kernels: list) -> dict:
    """Phase k on the card against the same calls on the CPU, where
    ``ops`` takes the plain versions: kernels 9-10 bitwise against their
    plain versions on the same inputs. Their ``max_abs_err`` in
    ``kernels`` is this run's card-vs-CPU difference."""
    got, counts, secs = counted(
        torch, lambda: drive_int8_wire(torch, "cuda"),
        "phase k (int8 wire)", ("pack_int8", "unpack_int8"))
    want = drive_int8_wire(torch, "cpu")
    for k in want:
        if got[k].tobytes() != want[k].tobytes():
            fail(f"k_int8_wire: {k} differs between card and CPU")
    int8_wire_oracle(got)
    err = {"pack_int8": 0.0, "unpack_int8": 0.0}
    for k in want:
        name = "unpack_int8" if k.endswith("|y") else "pack_int8"
        d = np.abs(got[k].astype(np.float64) - want[k].astype(np.float64))
        err[name] = max(err[name], float(d.max()))
    for k in kernels:
        if k["name"] in err:
            k["max_abs_err"] = err[k["name"]]
    print(f"path k_int8_wire: ops.pack_int8 -> ops.unpack_int8 of n="
          f"{BUCKET} and n={RAGGED}: {secs:.3f} s, bitwise equal to the CPU "
          f"run (the plain versions), within half an int8 step; launches "
          f"{counts}", flush=True)
    return counts


# -- phase r: the switch daemon over a real wire ------------------------------

def drive_wire(device, *, seg_slots=SEG, scale_down=1) -> tuple:
    """Phases a-d (``WIRE_LABELS``) through the port's entry points with
    the register file in a switch daemon: a ``SwitchServer`` whose
    segments live on ``device``, behind a ``FaultProxy`` that drops
    ``WIRE_LOSS`` of the data frames and duplicates and reorders half as
    many, reached by the runtime's ``RemoteSwitchMemory`` on its own flow.
    A second flow, straight to the daemon, reads the whole register file
    back. Returns (replies, the daemon's state_dict, launches, seconds,
    round seconds, the wire's story: each flow's report, the proxy's
    frames and the daemon's stats). Fails if the daemon recorded an error
    or a flow degraded onto its local fallback plane."""
    from repro_torch.net import (FaultProxy, FaultSpec, RemoteSwitchMemory,
                                 SwitchServer, WireTransport)
    srv = SwitchServer(n_segments=32, seg_slots=seg_slots,
                       track_effects=True, device=device).start()
    px = FaultProxy(srv.address, FaultSpec(
        seed=SEED + 25, loss=WIRE_LOSS, dup=WIRE_LOSS / 2,
        reorder=WIRE_LOSS / 2)).start()
    flows = []

    # a round takes about a second over this wire: a flow that hears
    # nothing for a minute degrades (and the phase fails on it)
    def flow(addr, flow_id, dev, slots):
        t = WireTransport(addr, flow_id=flow_id, w_max=8, rto_base=0.05,
                          call_timeout=120.0, unreachable_after=60.0)
        flows.append(RemoteSwitchMemory(t, 32, slots, device=dev))
        return flows[-1]

    try:
        replies, _, launches, secs, rounds = drive_path(
            device, seg_slots=seg_slots, scale_down=scale_down,
            switch=lambda dev, slots: flow(px.address, 1, dev, slots),
            labels=WIRE_LABELS)
        check = flow(srv.address, 2, device, seg_slots)
        regs = check.get(np.arange(32 * seg_slots, dtype=np.int64))
        dupes = check.transport.ctrl("stats")["duplicate_effects"]
        reports = [m.report() for m in flows]
    finally:
        for m in flows:
            m.transport.close()
        px.stop()
        srv.stop()
        if srv.error is not None:     # the cause of whatever failed here
            fail(f"phase r: the daemon's handler raised:\n{srv.error}")
    # a flow that degraded served its ops from the client's local plane,
    # not from the daemon on the card: such a run must not pass
    for rep in reports:
        if rep["degraded"] or rep["fallback_active"] \
                or rep["fallback_activations"]:
            fail(f"phase r: flow {rep['flow']} degraded onto its local "
                 f"fallback plane: {rep}")
    if dupes:
        fail(f"phase r: double-applied effects {dupes}")
    state = srv.switch.state_dict()
    if not np.array_equal(regs, np.concatenate(
            [r.cpu().numpy() for r in state["regs"]])):
        fail("phase r: the register file read over the wire differs from "
             "the daemon's")
    return replies, state, launches, secs, rounds, {
        "flows": reports, "proxy": px.stats.snapshot(),
        "daemon": dict(srv.stats),
        "on": str(srv.switch.segments[0].regs.device)}


def wire_quorum_run(device: str, *extra: str) -> dict:
    """``python -m repro_torch.launch.elastic --wire-quorum --wire-loss
    WIRE_LOSS`` as a process (its daemon and two workers on ``device``):
    fails unless it exits 0 with every vote and gradient element exact,
    every step committed and no effect applied twice, across the daemon's
    SIGTERM and respawn, and some worker reconnected (the restart landed
    in the traffic). Returns its numbers and seconds."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.elastic", "--wire-quorum",
         "--wire-loss", str(WIRE_LOSS), "--device", device, *extra],
        env=env, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    line = next((ln for ln in p.stdout.splitlines()
                 if ln.startswith("wire quorum:")), None)
    if p.returncode != 0 or line is None:
        fail(f"phase r2: --wire-quorum exited {p.returncode}:\n"
             f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    if "exact=True/True" not in line or "dupes={}" not in line \
            or "switch daemon restarted mid-run" not in p.stdout:
        fail(f"phase r2: {line}")
    reconnects = json.loads(re.search(r"reconnects=(\[[^]]*\])",
                                      line).group(1))
    if not any(reconnects):
        fail(f"phase r2: no worker reconnected, so the restart landed "
             f"after the traffic: {line}")
    return {"line": line, "seconds": secs}


def percentiles(xs) -> str:
    return (f"p50 {np.percentile(xs, 50) * 1e3:.3f} ms, "
            f"p99 {np.percentile(xs, 99) * 1e3:.3f} ms")


def check_wire(torch, smi: str) -> dict:
    """Phase r. r1: phases a-d over the wire to a daemon whose register
    file lives on the card, every reply and the final register file
    bitwise equal to the same traffic in process on the CPU, kernel 4
    launched by the daemon's handler threads; each round's wall latency
    beside the same traffic in process on the card. r2: the
    ``--wire-quorum`` demo as processes at the paper's geometry."""
    (replies, state, per_phase, secs, rounds, story), counts, wire_s = \
        counted(torch, lambda: drive_wire(None), "phase r1 (the wire)",
                ("sparse_addto",))
    if not story["on"].startswith("cuda"):
        fail(f"phase r1: the daemon's registers are on {story['on']}")
    others = {k: c for k, c in counts.items() if k != "sparse_addto" and c}
    if others:
        fail(f"phase r1: the wire run launched {others}: the daemon's "
             f"partitions are host-flavoured (kernel 4 only) and the "
             f"client launches nothing")
    ref_replies, ref_state, *_ = drive_path("cpu", labels=WIRE_LABELS)
    for label in replies:
        for i, (a, b) in enumerate(zip(replies[label], ref_replies[label])):
            if not same(a, b):
                fail(f"phase r1 {label}: reply {i} differs between the "
                     f"wire and the CPU run")
    same_state(torch, state, ref_state, "phase r1 (the daemon)")
    _, _, _, _, local = drive_path(None, labels=WIRE_LABELS)
    for label in WIRE_LABELS:
        print(f"path r1 {label} on {smi}: {ROUNDS} rounds over the wire "
              f"{percentiles(rounds[label])}; in process on the card "
              f"{percentiles(local[label])}", flush=True)
    every = [x for v in rounds.values() for x in v]
    every_local = [x for v in local.values() for x in v]
    flows = story["flows"]
    print(f"path r1 on {smi}: {len(every)} rounds in {wire_s:.3f} s over "
          f"the wire, {percentiles(every)}; in process on the card "
          f"{percentiles(every_local)}; proxy {story['proxy']}; "
          f"retransmits {[f['retx'] for f in flows]}, reconnects "
          f"{[f['reconnects'] for f in flows]}, acks "
          f"{[f['acks'] for f in flows]}; daemon {story['daemon']}; "
          f"sparse_addto launched by the daemon {counts['sparse_addto']}",
          flush=True)
    print("path r1: replies and the daemon's registers (on the card) "
          "bitwise equal to the CPU run; no flow degraded, no handler "
          "raised", flush=True)
    r2 = wire_quorum_run("cuda", "--wire-segments", "32", "--wire-slots",
                         str(SEG), "--grad-slots", str(WIRE_GRAD_SLOTS),
                         "--wire-steps", str(WIRE_STEPS))
    print(f"path r2 on {smi}: {r2['seconds']:.3f} s, {r2['line']}",
          flush=True)
    return counts


# -- phase s: the paper's applications ----------------------------------------

def example(name: str):
    import importlib
    return importlib.import_module(f"repro_torch.examples.{name}")


def examples_same(name: str, a: dict, b: dict, what: str) -> None:
    """Two runs of a runtime example agree by ``repro_torch.examples.hold``
    (the rule the CPU tests hold the port to the reference by)."""
    from repro_torch.examples import hold
    try:
        hold(name, a, b)
    except AssertionError as e:
        fail(f"{what}: {e}")


def check_examples(torch, smi: str) -> dict:
    """Phase s1: the four runtime examples on the card, then on the CPU;
    each pair held by ``examples_same``."""
    from repro_torch.kernels import ops
    card, counts, card_s = counted(
        torch, lambda: {n: example(n).main() for n in S_EXAMPLES},
        "phase s1 (the examples)", ("sparse_addto",))
    plain = {k: c for k, c in ops.plain_counts().items() if c}
    if plain:
        fail(f"phase s1: the card's runs took the plain version of {plain}")
    t0 = time.perf_counter()
    cpu = {n: example(n).main(device="cpu") for n in S_EXAMPLES}
    cpu_s = time.perf_counter() - t0
    for n in S_EXAMPLES:
        examples_same(n, card[n], cpu[n], "phase s1")
    for where, r in (("card", card), ("CPU", cpu)):
        mon, pax, tel = r["monitoring"], r["paxos"], r["train_telemetry"]
        print(f"path s1 monitoring on the {where} ({smi}): "
              f"{len(mon['counts'])} flows in {mon['capacity']} slots, cache "
              f"hit ratio {mon['cache_hit_ratio']}, {mon['drained_calls']} "
              f"calls in {mon['drained_batches']} batches, triggers "
              f"{mon['drains']}, submit->resolve p50 "
              f"{mon['latency_p50_us']} us, p99 {mon['latency_p99_us']} us",
              flush=True)
        print(f"path s1 paxos on the {where} ({smi}): "
              f"{len(pax['commits'])} ballots, {pax['proposals_per_s']} "
              f"proposals/s, commit p50 {pax['commit_p50_s'] * 1e6:.3f} us, "
              f"p99 {pax['commit_p99_s'] * 1e6:.3f} us; the learner saw "
              f"{pax['learned']} messages", flush=True)
        print(f"path s1 train_telemetry on the {where} ({smi}): "
              f"{tel['local_folds']} folds, {tel['flushes']} flushes, "
              f"traffic reduction {tel['traffic_reduction']}, triggers "
              f"{tel['drains']}", flush=True)
    print(f"path s1 on {smi}: {card_s:.3f} s on the card, {cpu_s:.3f} s on "
          f"the CPU; launches {counts}", flush=True)
    print("path s1: mapreduce, monitoring, paxos and train_telemetry on the "
          "card equal their CPU runs", flush=True)
    return counts


def mini_oracle(losses: list, floor: float, what: str) -> None:
    if len(losses) != MINI_STEPS or not np.all(np.isfinite(losses)) \
            or losses[0] - losses[-1] < MINI_FALL or losses[-1] <= floor:
        fail(f"{what}: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
             f"{len(losses)} steps (must fall by {MINI_FALL} and stay above "
             f"the entropy floor {floor:.4f})")


def check_train_mini(torch, smi: str) -> dict:
    """Phase s2: train_mini at full size in netrpc and xla-psum."""
    from repro_torch.examples import train_mini
    torch.cuda.empty_cache()
    out, counts, secs = counted(
        torch, lambda: train_mini.main(["--steps", str(MINI_STEPS),
                                        "--compare"]),
        "phase s2 (train_mini)",
        ("quantize", "sat_add", "dequantize", "sparse_addto"))
    leaves = scattered_leaves(train_mini.hundred_m_config())
    for name in ("quantize", "sat_add", "dequantize"):
        if counts[name] != leaves * MINI_STEPS:
            fail(f"phase s2: {counts[name]} {name} launches, not one per "
                 f"scattered leaf ({leaves}) and netrpc step")
    floor = out["entropy_floor"]
    for mode, run in (("netrpc", out), ("xla-psum", out["compare"])):
        mini_oracle(run["losses"], floor, f"phase s2 ({mode})")
        print(f"path s2 train_mini {mode} on {smi}: {out['params']} "
              f"parameters, B=16 x S=128, {MINI_STEPS} steps; loss "
              f"{run['losses'][0]} -> {run['losses'][-1]} (entropy floor "
              f"{floor}); median warm step "
              f"{statistics.median(run['step_s'][1:]):.6f} s", flush=True)
    if not out["gap"] <= MINI_GAP:
        fail(f"phase s2: netrpc - xla-psum final loss gap {out['gap']} > "
             f"{MINI_GAP}")
    print(f"path s2 train_mini on {smi}: {secs:.3f} s for both runs; netrpc "
          f"- xla-psum final loss gap {out['gap']} (bound {MINI_GAP}); "
          f"{leaves} scattered leaves; launches {counts}", flush=True)
    return counts


def check_phase_s(torch, smi: str) -> dict:
    s1 = check_examples(torch, smi)
    s2 = check_train_mini(torch, smi)
    return {k: s1[k] + s2[k] for k in s1}


def rehearse(scale_down: int = 64) -> None:
    """Every path phase on the CPU at 1/scale_down of its size, with the
    plain versions: a rehearsal of the script's control flow and its
    oracles without the card (it times nothing and compares no card
    run)."""
    import torch
    import torch.distributed as dist

    from repro_torch import compat
    from repro_torch.launch.mesh import make_host_mesh, one_rank_group
    seg = SEG // scale_down
    once_a_call(drive_path("cpu", seg_slots=seg, scale_down=scale_down)[2],
                "took the plain version of")
    g, replies, _ = drive_local_accum("cpu", seg_slots=seg,
                                      scale_down=scale_down)
    local_accum_oracle(g, replies)
    store = ROOT / "build" / "chip_smoke" / "rehearsal-store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        axes = compat.make_mesh((1,), ("data",),
                                device="cpu").axes_of(("data",))
        g = bucket(np.random.RandomState(7), BUCKET // scale_down)
        syncagtr_oracle(g, drive_syncagtr(torch, axes, "cpu", g)[0])
    finally:
        dist.destroy_process_group()
    clear_policy_oracle(drive_clear_policies(torch, "cpu", seg))
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import model_config
    from repro_torch.models import api
    # the serve phases at the reduced width: i at 2 layers, l to q at
    # their pattern's reduced depth (8, 5, 1, 1, 1 and 5 layers) and at the
    # cut, each prompt twice the reduced window
    for phase, sp in SERVES.items():
        for layers in ((2,) if phase == "i" else (None, sp["cut"])):
            cfg = model_config(sp["arch"], reduced=True, layers=layers)
            shape = dict(arch=sp["arch"], prompt_len=64, decode_n=4,
                         batch=2, reduced=True, layers=layers)
            params = api.init_params(SEED, cfg, device="cpu")
            set_gates(params, cfg, sp.get("gate"))
            ops.reset_counts()
            routes = []
            with routes_into(routes):
                run = serve_run("cpu", params, True, shape)
            if ops.plain_counts()["flash_attention"] != flash_layers(cfg, 64):
                fail(f"rehearsal of phase {phase}: the flash lane did not "
                     f"run once a layer that takes it")
            if len(routes) != moe_layers(cfg) * 5:
                fail(f"rehearsal of phase {phase}: not one route a moe "
                     f"layer, prefill and each decode step")
            serve_oracle(run, shape, cfg.vocab, f"rehearsal of phase {phase}")
            if sp["lanes_tol"] is None:
                continue
            plain, forced = forced_run(
                torch, cfg, routes, lambda: serve_run(
                    "cpu", params, False, shape, feed=run["tokens"][:, :-1]))
            print(f"rehearsal of phase {phase}, {cfg.n_layers} layers: " +
                  lanes_check(run, plain, cfg, sp["lanes_tol"],
                              f"rehearsal of phase {phase}", forced),
                  flush=True)
    small = dict(device="cpu", reduced=True, layers=2, seq=64)
    ops.reset_counts()
    netrpc = train_run("netrpc", **small)
    cfg = model_config(ARCH, reduced=True, layers=2)
    train_oracle(netrpc, cfg.vocab, "rehearsal of phase j")
    if ops.plain_counts()["quantize"] != scattered_leaves(cfg) * TRAIN_STEPS:
        fail("rehearsal: not one quantize per scattered leaf and step")
    modes_oracle(netrpc, train_run("fp32-ring", **small),
                 "rehearsal of phase j")
    ops.reset_counts()
    fsdp_oracle(train_run("netrpc", shard="fsdp", **small),
                netrpc["losses"], "rehearsal of phase t")
    if ops.plain_counts()["quantize"] != gathered_leaves(cfg) * TRAIN_STEPS:
        fail("rehearsal: not one quantize per fsdp gather and step")
    # phase z: j's reduced run through the flash lane (the plain version
    # and its autograd on the CPU), and its dry run's records
    ops.reset_counts()
    flash_run = train_run("netrpc", flash=True, **small)
    train_oracle(flash_run, cfg.vocab, "rehearsal of phase z")
    err, g_err, m_err = z_oracle(
        flash_run, {"losses": netrpc["losses"],
                    "gnorm0": netrpc["gnorms"][0],
                    "m_attn": attn_moments(netrpc)}, "rehearsal of phase z")
    print(f"rehearsal of phase z: losses {flash_run['losses']} against j's "
          f"{netrpc['losses']}: {err:.2e}; step 0's gnorm {g_err:.2e}; "
          f"worst attention leaf's m {m_err[1]} {m_err[0]:.2e}", flush=True)
    if ops.plain_counts()["flash_attention"] != 2 * 2 * TRAIN_STEPS:
        fail("rehearsal of phase z: not two flash calls a layer and step")
    dry_z = dryrun_result(dryrun_start(reduced=True, z=True),
                          "rehearsal of phase z")["z"]
    z_launches({k: v["launches"] for k, v in dry_z["kernels"].items()}, 2,
               scattered_leaves(cfg), 1, "rehearsal of phase z's dry run")
    # phase x: the dry run of the reduced i and j against their plain
    # calls on the CPU
    dry = dryrun_run(reduced=True)
    want = {"i": {"flash_attention": flash_layers(cfg, 64)},
            "j": {k: scattered_leaves(cfg)
                  for k in ("quantize", "sat_add", "dequantize")}}
    for label, w in want.items():
        got = {k: dry[label]["kernels"].get(k, {}).get("launches", 0)
               for k in w}
        if got != w:
            fail(f"rehearsal of phase x: {label} recorded {got}, not {w}")
    print(f"rehearsal of phase x: records {want}", flush=True)
    int8_wire_oracle(drive_int8_wire(torch, "cpu"))
    ops.reset_counts()
    replies, state, _, _, _, story = drive_wire("cpu", seg_slots=seg,
                                                scale_down=scale_down)
    print(f"rehearsal of phase r1: plain calls {ops.plain_counts()}, "
          f"proxy {story['proxy']}, daemon {story['daemon']}", flush=True)
    ref_replies, ref_state, *_ = drive_path(
        "cpu", seg_slots=seg, scale_down=scale_down, labels=WIRE_LABELS)
    for label in replies:
        for i, (a, b) in enumerate(zip(replies[label], ref_replies[label])):
            if not same(a, b):
                fail(f"rehearsal of phase r1 {label}: reply {i} differs "
                     f"from the in-process run")
    same_state(torch, state, ref_state, "rehearsal of phase r1")
    print(f"rehearsal of phase r2: "
          f"{wire_quorum_run('cpu', '--wire-steps', str(WIRE_STEPS))}")
    runs = [{n: example(n).main(device="cpu") for n in S_EXAMPLES}
            for _ in range(2)]
    for n in S_EXAMPLES:
        examples_same(n, runs[0][n], runs[1][n], "rehearsal of phase s1")
    from repro_torch.examples import train_mini
    mini = train_mini.main(["--steps", "3", "--layers", "1", "--compare"],
                           device="cpu")
    if not mini["gap"] <= MINI_GAP:
        fail(f"rehearsal of phase s2: gap {mini['gap']}")
    # phase u: u1 at the reduced width over a one-rank gloo mesh; u2's q8
    # serve of q's reduced shape against the plain gather's
    cfg = model_config(ARCH, reduced=True, layers=2)
    with one_rank_group(torch.device("cpu")):
        seq_axes = make_host_mesh(model=1, device="cpu").axes_of(("data",))
        tokens = torch.randint(0, cfg.vocab, (1, 64),
                               generator=torch.Generator().manual_seed(SEED))
        seq_combine_oracle(torch, *seq_combine_run(
            torch, api.init_params(SEED, cfg, device="cpu"), cfg, tokens,
            seq_axes, 4), "rehearsal of phase u1")
    sp = SERVES["q"]
    cfg = model_config(sp["arch"], reduced=True)
    shape = dict(arch=sp["arch"], prompt_len=64, decode_n=4, batch=2,
                 reduced=True)
    params = api.init_params(SEED, cfg, device="cpu")
    set_gates(params, cfg, sp["gate"])
    plain = serve_run("cpu", params, True, shape)
    q8 = serve_run("cpu", params, True, shape, q8=True,
                   feed=plain["tokens"][:, :-1])
    serve_oracle(q8, shape, cfg.vocab, "rehearsal of phase u2")
    if torch.equal(q8["logits"], plain["logits"]):
        fail("rehearsal of phase u2: the q8 gather changed nothing")
    print(f"rehearsal of phase u2: q8 vs plain "
          f"{lanes_err(q8, plain, cfg.vocab):.6f}", flush=True)
    # phases v and w at the reduced width: one CPU rank against the ranks
    for label, cases, world in (("v", V_CASES, V_MODEL),
                                ("w", W_CASES, W_MODEL)):
        pairs, _, cpu_s = tp_pair(torch, "cpu", True,
                                  lambda run: (run(), {}), cases, world,
                                  label)
        for (one, (cpu, shards)), case in zip(pairs, map(tp_case, cases)):
            print(f"rehearsal of phase {label} {case['arch']} ({cpu_s:.3f} "
                  f"s): " + tp_compare(
                      torch, one, cpu, shards,
                      tp_config(case, True).vocab,
                      f"rehearsal of phase {label}"), flush=True)
    rehearse_y()
    print("rehearsal: phases a-z ran on the CPU and met their oracles")


def rehearse_y() -> None:
    """Phase y at the reduced width on the CPU (~40 s; part of
    ``rehearse``): Y_FULL's and Y_CUT's archs through train_loop in
    their own mode, netrpc and for Y_FULL fp32-ring (at j's window: the
    reduced width's), then each family's reduced step through step_pair,
    on the CPU twice."""
    import torch

    from repro_torch import compat
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import one_rank_group
    from repro_torch.launch.serve import model_config
    for cases, steps, ring in ((Y_FULL, Y_STEPS, True), (Y_CUT, 1, False)):
        for arch, *_ in cases:
            cfg = model_config(arch, reduced=True)
            kw = dict(arch=arch, device="cpu", reduced=True, layers=None,
                      seq=64, batch=2, shard=None, steps=steps)
            what = f"rehearsal of phase y ({arch})"
            ops.reset_counts()
            run = train_run("netrpc", **kw)
            train_oracle(run, cfg.vocab, what, steps)
            if ops.plain_counts()["quantize"] != \
                    scattered_leaves(cfg) * steps:
                fail(f"{what}: not one quantize per scattered leaf and step")
            if ring:
                modes_oracle(run, train_run("fp32-ring", **kw), what)
            print(f"{what}: losses {run['losses']}", flush=True)
    y_blind(torch, "cpu", device="cpu", reduced=True)
    with one_rank_group(torch.device("cpu")):
        mesh = compat.make_mesh((1, 1), ("data", "model"), device="cpu")
        for arch in Y_PAIRS:
            step_pair(torch, mesh, mesh, shard=None,
                      cfg=model_config(arch, reduced=True), phase="y",
                      seq=Y_PAIR_SEQ, gate=Y_GATE, device="cpu")


def lane_drift(draws: int = 3) -> None:
    """The drift behind ``SERVES``' lane tolerances, on the CPU: each serve
    phase's arch that has attention, at the reduced width and the phase's
    full depth (whisper's encoder too), its gates set as the phase sets
    them, the flash lane against the plain one teacher forced, at the
    phase's batch, 32 decode steps and a prompt of twice the reduced
    window, for ``draws`` weight draws (some minutes)."""
    from dataclasses import replace

    import torch

    from repro_torch.launch.serve import model_config
    from repro_torch.models import api
    for phase, sp in SERVES.items():
        if sp["lanes_tol"] is None:
            continue
        full = model_config(sp["arch"], layers=sp.get("layers"))
        cfg = replace(model_config(sp["arch"], reduced=True),
                      pattern_groups=full.pattern_groups,
                      n_layers=full.n_layers, enc_layers=full.enc_layers)
        errs = []
        for seed in range(draws):
            params = api.init_params(seed, cfg, device="cpu")
            set_gates(params, cfg, sp.get("gate"))
            kw = dict(arch=cfg, prompt_len=2 * cfg.window, decode_n=32,
                      batch=sp["batch"])
            routes = []
            with routes_into(routes):
                a = serve_run("cpu", params, True, kw)
            b, forced = forced_run(torch, cfg, routes, lambda: serve_run(
                "cpu", params, False, kw, feed=a["tokens"][:, :-1]))
            errs.append(lanes_err(a, b, cfg.vocab))
            if forced:
                print(f"lane drift, phase {phase}, draw {seed}: "
                      f"{errs[-1]:.6f}{forced}", flush=True)
        print(f"lane drift, phase {phase}: {sp['arch']} at the reduced width "
              f"and {cfg.n_layers} layers: " + ", ".join(
                  f"{e:.6f}" for e in errs) + f" (tolerance "
              f"{sp['lanes_tol']})", flush=True)


def step0_loss(draws: int = 3) -> None:
    """The prediction behind Y_STEP0, on the CPU (~3 min): for each run
    (arch, layers, encoder layers, B, S), the model at the reduced width
    with the run's pattern, window, vocab, stub frames and experts (n and
    top-k: the moe output's share of the residual falls as the gated
    sum's k grows), on the run's
    uniform tokens, for ``draws`` weight draws. cos is the mean over the
    tokens of the input token's own logit over |h| |e| (h the normed last
    output, e its embedding row); at full width that logit is about
    sqrt(d_model) cos + N(0, 1 - cos^2) and every other about N(0, 1), so
    step 0's loss is about E ln(e^a + (V - 1) e^0.5). First the cuts whose
    step 0 the card measured in PR 34 (phases v, j and w: qwen2.5-3b at 1
    layer, 1 x 64 and 2 x 64 tokens, 37.282 and 37.372; at 36 layers, 2 x
    1 024, 12.485; whisper-medium 1 + 1 layers at 1 x 64, 20.493;
    mamba2-780m 2 layers at 2 x 128, 22.609), then phase y's."""
    from dataclasses import replace

    import torch

    from repro_torch.data import pipeline
    from repro_torch.launch.serve import model_config
    from repro_torch.models import api
    runs = [(ARCH, 1, None, 1, 64), (ARCH, 1, None, 2, 64),
            (ARCH, TRAIN_LAYERS, None, TRAIN_BATCH, TRAIN_SEQ),
            ("whisper-medium", 1, 1, 1, 64), ("mamba2-780m", 2, None, 2, 128)]
    runs += [(a, n, None, b, s) for a, n, b, s in Y_FULL + Y_CUT]
    noise = np.random.RandomState(SEED).randn(100_000)
    with torch.no_grad():
        for arch, layers, enc, b, s in runs:
            full = model_config(arch, layers=layers)
            full = replace(full, enc_layers=enc or full.enc_layers)
            cfg = replace(model_config(arch, reduced=True),
                          pattern_groups=full.pattern_groups,
                          n_layers=full.n_layers, enc_layers=full.enc_layers,
                          frontend_tokens=full.frontend_tokens,
                          window=full.window, vocab=full.vocab,
                          n_experts=full.n_experts, top_k=full.top_k)
            batch = pipeline.add_modality_stubs(pipeline.make_batch(
                pipeline.DataConfig(vocab=cfg.vocab, batch=b, seq_len=s,
                                    kind="uniform"), 0), cfg, b)
            toks = batch["tokens"][:, :-1].long()
            got = []
            for seed in range(draws):
                params = api.init_params(seed, cfg, device="cpu")
                logits, _ = api.forward(params, cfg, {**batch, "tokens": toks},
                                        remat=False)
                own = logits.float().gather(-1, toks[..., None])[..., 0]
                rows = params["embed"].float()[toks].norm(dim=-1)
                cos = float((own / (cfg.d_model ** 0.5 * rows)).mean())
                a = cos * full.d_model ** 0.5 + noise * (1 - cos ** 2) ** 0.5
                got.append((cos, float(np.mean(np.logaddexp(
                    a, np.log(full.vocab - 1) + 0.5)))))
            print(f"step 0, {arch} at {full.n_layers} layers"
                  + (f" + {full.enc_layers} encoder" if full.is_encdec else "")
                  + f", B={b} x S={s}: cos " + ", ".join(
                      f"{c:.4f}" for c, _ in got) + "; predicted loss at "
                  f"full width " + ", ".join(f"{p:.3f}" for _, p in got)
                  + f" (ln(vocab) {np.log(full.vocab):.4f})", flush=True)


@contextlib.contextmanager
def ssd_chunk(size: int):
    """``mamba2_train``'s SSD chunk while open (256 otherwise): the same
    function, summed in another fp32 order."""
    from repro_torch.models import ssm
    kw = ssm.mamba2_train.__kwdefaults__
    old, kw["chunk"] = kw["chunk"], size
    try:
        yield
    finally:
        kw["chunk"] = old


def cut_drift(phase: str = "o", draws: int = 3) -> None:
    """The drift behind a phase's ``cut_tol`` (o's), on the card: the
    phase's cut at full width for ``draws`` weight draws, rounding alone
    on the card (without attention the SSD chunk 256 against 128, else
    the plain attention against the flash kernel) and the card against
    the CPU, teacher forced."""
    import torch

    from repro_torch.launch.serve import model_config
    from repro_torch.models import api
    sp = SERVES[phase]
    cfg, small = cut_of(sp)
    for seed in range(draws):
        p_card = api.init_params(seed, cfg, device="cuda")
        set_gates(p_card, cfg, sp.get("gate"))
        card = serve_run(None, p_card, True, small)
        feed = card["tokens"][:, :-1]
        if sp["lanes_tol"] is None:
            what = "chunk 128 vs 256"
            with ssd_chunk(128):
                other = serve_run(None, p_card, True, small, feed=feed)
        else:
            what = "plain vs flash attention"
            other = serve_run(None, p_card, False, small, feed=feed)
        cpu = serve_run("cpu", api.map_tree(lambda t: t.cpu(), p_card), True,
                        small, feed=feed.cpu())
        print(f"cut drift, phase {phase}, draw {seed}: {sp['cut']} layers, "
              f"S={sp['cut_prompt']}: {what} on the card "
              f"{lanes_err(other, card, cfg.vocab):.6f}; card vs CPU "
              f"{lanes_err(card, cpu, cfg.vocab):.6f}", flush=True)
        del p_card
        torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build()
    each = ", ".join(f"{k} {v:.1f} s" for k, v in built.items())
    print(f"build: {time.perf_counter() - t0:.1f} s ({each or 'cached'})",
          flush=True)
    phase_s = {"build": time.perf_counter() - t0}
    sass_counts(build)
    t0 = time.perf_counter()
    kernels = (check_kernels(torch, smi) + [check_flash(torch)]
               + check_flash_bwd(torch) + check_int8(torch))
    phase_s["kernels"] = time.perf_counter() - t0
    counts = {}
    for label, check in (("a-e", check_path), ("f", check_local_accum),
                         ("g", check_syncagtr), ("h", check_clear_policies),
                         ("i", lambda t: check_serve(t, smi, "i")),
                         ("j", lambda t: check_train(t, smi)),
                         ("x", lambda t: check_phase_x(t, smi)),
                         ("z", lambda t: check_phase_z(t, smi)),
                         ("k", lambda t: check_int8_wire(t, kernels)),
                         ("l", lambda t: check_serve(t, smi, "l")),
                         ("m", lambda t: check_serve(t, smi, "m")),
                         ("n", lambda t: check_serve(t, smi, "n")),
                         ("o", lambda t: check_serve(t, smi, "o")),
                         ("p", lambda t: check_serve(t, smi, "p")),
                         ("q", lambda t: check_serve(t, smi, "q")),
                         ("r", lambda t: check_wire(t, smi)),
                         ("s", lambda t: check_phase_s(t, smi)),
                         ("t", lambda t: check_fsdp(t, smi)),
                         ("u", lambda t: check_phase_u(t, smi)),
                         ("v", lambda t: check_phase_v(t, smi)),
                         ("w", lambda t: check_phase_w(t, smi)),
                         ("y", lambda t: check_phase_y(t, smi))):
        t0 = time.perf_counter()
        for name, c in check(torch).items():
            counts[name] = counts.get(name, 0) + c
        phase_s[label] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report_path_scatters(torch, kernels)
    phase_s["scatters at the path's k"] = time.perf_counter() - t0
    check_bounds(kernels)
    for k in kernels:
        k["launches"] = counts[k["name"]]
        print(f"kernel {k['name']} on {smi}: ms={k['ms']:.6f} "
              f"plain_ms={k['plain_ms']:.6f} bound_ms={k['bound_ms']:.6f} "
              f"launches={k['launches']}", flush=True)
    print("phase seconds: " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in phase_s.items()),
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
