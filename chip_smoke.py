#!/usr/bin/env python3
"""On-card smoke run of ``repro_torch``, the PyTorch/CUDA port, on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one JSON line each; any failed check raises, so the run exits non-zero:

1. ``env``: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and the seconds the kernels took to build from
   ``src/repro_torch/kernels/*/csrc`` (nvcc, one process per source).
2. ``kernel_check``: every CUDA kernel against its plain PyTorch version on the
   card, at the main paths' full-width shapes: ``pim_gemv`` bit-exact, each
   call counted once, and every path of the kernel hit (tensor-core tiles at
   one K split and at eight, batch groups, zeros read past a ragged N and K,
   the plain kernel for an odd K and for an unaligned x; each case names its
   path); the paged attention kernels (llama3-8b), the contiguous attention kernel
   (llama3-8b, G 4 / hd 128, and zamba2-7b, G 1 / hd 112) and the SSD scan
   (zamba2-7b's H 112, P 64, N 64, chunk 256, also against the model's own
   ``ssd_chunked``, at three times the log decays, and at N 128, two column
   tiles, against the plain version) within the f32
   tolerances below; the single-pass kernels (paged and contiguous), the split
   pair and the scan must also give each lane of a batch the same bits as that
   lane computed alone. B1, the B2 pair and B4 also over fp8 e4m3 K/V (the
   JAX package's ``kv_dtype="float8_e4m3fn"``) at llama3-8b's and zamba2-7b's
   shapes, lanes alone too. The scan is a scores kernel per (lane, 32-step
   sub-chunk) and a walk per (head, 64 state rows, lane) with its products on
   the tensor cores as three TF32 products each; its bound is its bytes, and
   its line also gives the earlier f32-core bound and the model's own scan
   (``chunked_torch_ms``). ``kernel_time`` lines give
   each kernel's time beside its bound, its plain version's time and one
   PyTorch library call's time (a yardstick the port never calls), the split
   pair's (stage 1 + merge) time, B1 over fp8 pages beside its byte bound
   (half of bf16's), and the paged kernels' and B4's times at the
   serves' own regimes (short fills in 37-block tables; zamba2's Lmax).
   ``host_cost`` lines give what one attention call costs the host at the
   serves' shapes, alone and over one decode step.
3. ``serve``: full-width llama3-8b (bf16, W8A8 ``quantized_decode``, random
   weights from a seeded generator) serves ragged greedy requests through
   ``ServingModel.prepare(...).engine(mode=...).serve(requests)`` in BLOCKED,
   HBCEM and LBIM with ``decode_kv_splits=1``, in LBIM once more with
   ``decode_kv_splits=4``, and in LBIM through a contiguous pool
   (``cache_pool(paged=False)``). Every request must finish, the pool's
   invariants must hold, and greedy tokens must be identical across the three
   paged modes. The launch counts are set to 0 just before each serve and read
   just after it; they must equal what that serve's schedule implies (per
   one-token forward 7 ``pim_gemv`` and one attention call per attention
   layer: paged single pass at 1 split, split and merge at 4, the contiguous
   kernel for the contiguous pool, and no other kernel). ``priced`` lines
   then price each serve's own ``ScheduleEvent``s with the port's pimsim
   (``replay_events`` for pimsim's LLaMA-7B on the CD-PIM design of the
   paper's Jetson and iPhone devices, and the same requests'
   ``wave_baseline_events`` at 4 slots): ``total_s``, ``decode_busy_s``,
   ``prefill_busy_s``, ``overlap_saved_s``, ``stall_s`` and ``idle_steps``
   are simulated seconds of that LPDDR5-PIM edge device model, not of the
   card; ``replay_host_ms`` is the host time of the replay. The JAX suite's
   event contracts must hold on the card's events: continuous HBCEM and
   LBIM decode busy time below the wave's, LBIM ``total_s`` at most
   BLOCKED's with ``overlap_saved_s`` >= 0 (a failure writes the events to
   ``chiprun_out/`` and fails the run). Every serve of the run is captured
   (``core.interleave.StepGraphs``): each step program runs as a CUDA graph
   from its key's second call, and a serve in which any other step ran
   eagerly fails; each serve line adds ``captured``, ``graphs``,
   ``captures``, ``replays``, ``eager_steps``, ``capture_s`` and
   ``graph_pool_GB``. The ``graphs`` phase follows the three paged serves:
   HBCEM and LBIM each against its eager twin under ``interleave.eager()``
   (``graphs_ab`` lines: greedy tokens, every step's plan and the launch
   counts equal; both serves' decode-step ms and tokens/s), then one
   ``lbim_overlap`` line: an LBIM serve traced with torch.profiler after its
   graphs are captured, over its fused steps the decode branch's and the
   prefill branch's device ms (a kernel's branch is its stream), the ms in
   which kernels of both ran at once and the steps' span; the captured
   serve's busy share beside the eager one's; and each fused step's device
   ms (CUDA events) beside its two halves', each captured and timed alone
   over the same inputs.
4. ``zamba2``: full-width zamba2-7b at 45 of its 81 Mamba2 layers
   (``ZAMBA2_LAYERS``; one shared attention + MLP block applied 7 times, after
   every 6 layers, then 3 layers without it; bf16, W8A8) serves ragged greedy
   requests in BLOCKED, HBCEM and LBIM with the same checks: identical tokens
   across modes, exactly 7 x 7 ``pim_gemv`` and 7 contiguous attention
   launches per one-token forward. The SSD scan kernel is not on this path, as in the JAX
   package (the model scans with ``ssd_chunked``): the kernel phase launches it.
5. ``spec``: full-width llama3-8b (bf16, W8A8, paged, 4 slots) serves one
   request set of 4 (prompts of 32-96 tokens, 16-24 new tokens; two greedy,
   two sampled at temperature 0.8, top-k 50, top-p 0.95 with fixed seeds)
   without and with speculative decoding (self-draft: the same
   ``ServingModel`` drafts, ``SpecConfig(k=3)``) in HBCEM and in LBIM. Each
   spec serve's tokens must equal the non-spec serve's in the same mode (the
   reference's bit-identity contract: verify runs the same ``(slots, 1)``
   program), the greedy lanes must accept draft tokens, both pools must pass
   ``check_invariants()``, and the launch counts must be exactly what the
   schedule implies: per verify position and per plain one-token forward the
   target's 7 x 32 ``pim_gemv`` and 32 paged single-pass attention calls; per
   single-token draft feed (each chained candidate, and a catch-up of one
   token) the draft's 7 x 32 ``pim_gemv`` and 32 contiguous attention calls
   on its batch-1 lane. The draft's feeds replay the engine's graphs on the
   draft decoder's persistent working lane: a spec serve fails unless its
   draft keys (``draft_graph_keys``, one per catch-up length, the chained
   feed sharing length 1's) are at most its distinct catch-up lengths and
   1, and fewer than its draft feeds. The pool's sampling runs as the
   engine's captured sampling program. Lines give decode-step ms, round ms,
   tokens/s, the spec report and the draft's working-lane MB; ``priced``
   lines price the four serves' events self-drafted (``draft_model=None``).
6. ``traffic``: full-width llama3-8b at 4 of its 32 layers
   (``TRAFFIC_LAYERS``; bf16, W8A8, paged 8-token pages,
   4 slots, 64-token admission chunks) serves a seeded 16-request Poisson
   trace (``serve.traffic.generate``: 0.25 arrivals a step, prompts of
   32-256 tokens, 8-48 new, priorities 0, 0, 1) four times: (a) HBCEM, every
   request finished, at least one preemption, streamed tokens equal to the
   final ones; (b) the SLO-aware policy with 3-step TTFT deadlines on every
   fourth request, one request cancelling itself from its stream and a plan
   of one ``alloc_fail`` and one ``slow_step``: timeouts, one cancellation,
   two injected faults; (c) (a) with self-draft speculation (the number of
   requests whose tokens equal (a)'s is printed: bf16 may flip them); (d)
   HBCEM with an injected ``pim_gemv`` ``kernel_exc``: exactly that step's
   participants fail, every other request finishes, one kernel fault and no
   fallback. Every serve must leave its pools audited empty, launch exactly
   what its events imply, and (but (d)) report no failure, kernel fault or
   failed attempt: the one-rung ladder on the card must not hide a real
   kernel error. The kernel checks hold B1 at these serves' own tables (37
   blocks, 38 with the spec slack) and B4 at the spec draft's Lmax 300
   without softcap, at the trace's fills, each lane alone too; the traffic
   engines refuse pools of any other shape. ``priced`` lines give (a)-(d)
   through ``serve.traffic.priced_latency`` (TTFT/TPOT p50 and p95 in
   simulated seconds, SLO attainment against benchmarks/traffic.py's
   targets: 1.10 x (a)'s priced TTFT p95 and 1.50 x its TPOT p95 per
   device; the self-draft priced as LLaMA-1B); the replay's idle steps must
   be the engine's and the same events priced twice must give equal dicts.
   Then ``python -m repro_torch.launch.serve`` in-process at smoke size with
   ``--arrival-rate``, ``--mode-policy auto`` and ``--faults 1``; its health
   line must account for the plan.
7. ``dense``: the rest of the dense family at full width, each model's
   weights freed before the next is made (``memory`` lines give the card's
   free memory before each init): (a) yi-9b (24 of its 48 layers,
   ``YI_LAYERS``, G 8, W8A8, paged) in
   HBCEM and LBIM and (b) codeqwen1.5-7b (G 1 MHA with q/k/v biases, W8A8,
   paged) in HBCEM, each over the llama3-8b serve's 8 requests; then
   gemma2-27b in bf16 (54.46 GB of weights: its W8A8 images beside the bf16
   copies would not fit one card with its KV) over 4 requests, one of a
   4,200-token prompt and 24 new tokens, so every local layer's 4,096-token
   window binds (start > 0) from the first decode, and three of 32-256
   tokens with 16-32 new; ``max_len`` 4,232, 256-token admission chunks,
   HBCEM: (c) on the paged pool (8-token pages, no prefix reuse; the line
   counts the B1 launches with a lane at start > 0) and (d) on the ring pool
   (``windowed_kv_cache``: 4,096-slot rings for the 23 local layers, full
   lanes for the 23 global ones, solo-prefill admission; the line counts the
   B4 launches over rings and over lanes, which must be equal, and the
   requests whose tokens equal (c)'s: bf16 may flip some). Launches exact,
   health clean, as every serve. The kernel checks hold B1/B2/B4 and B3 at
   these serves' shapes (``check_dense_kernels``); ``kernel_time`` lines give
   B1 at (c)'s window-bound shape and B4 over (d)'s rings.
8. ``moe``: the MoE family at full width, W8A8 (q/k/v/o as B3 GEMVs; the
   stacked expert tables stay float, as in the JAX package), paged 8-token
   pages, each model freed before the next: (a) olmoe-1b-7b (16 layers, 64
   experts, top-8) over the 8 requests of the llama3-8b serve, 64-token
   admission chunks, no prefix reuse, in BLOCKED, HBCEM and LBIM, in HBCEM
   at 4 KV splits, and in HBCEM with prefix reuse (8-token chunks); (b)
   phi3.5-moe (16 experts, top-2) at 16 of its 32 layers (all 32 in bf16
   exceed the card) in HBCEM and LBIM. Launches exact (4 ``pim_gemv`` and
   one attention call per layer and one-token forward), health clean;
   tokens are not held equal across modes (the admission quantum changes
   which picks drop, in the JAX engine too), the lines count the requests
   that agree. A ``moe_route`` line per model runs the port's router and
   keep rule on the first HBCEM chunk's and decode step's MoE inputs and
   counts the picks kept and dropped per layer. The kernel checks hold B1/B2
   and B3 at both models' serve shapes.
9. ``families``: the last serving families at full width and depth, each
   model freed before the next: (a) rwkv6-1.6b (24 RWKV6 blocks, bf16; W8A8
   is off for the attention-free ``ssm`` family, as in the JAX package) over
   the llama3-8b serve's 8 requests in BLOCKED, HBCEM and LBIM on its
   contiguous recurrent-state pool: tokens equal across modes and no
   launch of any kernel of the port; (b) internvl2-2b (W8A8, paged 8-token
   pages, no image: the engine passes none, as the JAX engine) over the same
   requests in HBCEM and LBIM and in HBCEM at 4 KV splits, then the
   model-level image-prefix ``prefill`` of 4 lanes (256 seeded patch
   embeddings and prompts of 24-64 tokens) and 16 greedy ``decode_step``s
   over its contiguous lanes (B4 at G 2 / hd 128); (c) seamless-m4t-large-v2
   at model level (W8A8 decoder; encoder and cross attention float):
   ``prefill`` of 4 lanes over 500 seeded frames and one BOS token, then 32
   greedy steps (B4 at G 1 / hd 64, B3 at (1024, 1024), (8192, 1024) and
   (1024, 8192)). Launches exact, health clean; ``family_decode`` lines give
   the model-level runs' step ms, tokens/s and step bound. The kernel checks
   hold B1/B2 at internvl2-2b's tables, B4 at both model-level runs' lanes,
   B3 bit-exact at every shape (``check_family_kernels``).
10. ``train``: the training path (``repro_torch.train``; no kernel of the
   port may launch, as the JAX training path reaches no ``pallas_call``):
   (a) internvl2-2b at full width and depth (bf16, per-layer ``remat`` from
   its config, seeded weights, AdamW) takes 4 in-place steps over
   ``SyntheticLM`` batches of B 8 x S 1024 through a
   ``train_step.TrainGraphs`` (the first eager, the second captured, then
   replays), then one whose batch adds 256 seeded patch embeddings (a key
   of its own, eager); each ``train_step`` line gives a finite loss and
   grad norm, how the step ran, step ms (ending in a sync), tokens/s,
   ``mfu`` (6 x params x positions over the step's seconds and the bf16
   dense peak) and peak allocated memory, a ``train_graphs`` line the
   captures, replays, capture s and graph pool GB. (b) ``train_parity`` lines: llama3-8b, olmoe-1b-7b,
   zamba2-7b and rwkv6-1.6b at f32 smoke, the same seeded weights and batch
   on the card and on the CPU: loss within rtol 1e-4, every gradient leaf
   within rtol 1e-4 and an atol of 1e-5 of its max, one AdamW step. (c)
   ``examples/train_100m.py``'s ~125 M llama, B 8 x S 256 through
   ``train.loop.run`` (which replays its captured step on its own
   tensors): 60 steps whose loss must fall, then a run stopped at
   step 30 and resumed from its checkpoint (a temporary directory, removed)
   to step 60, whose params must equal the uninterrupted run's within
   ``tests/test_train.py``'s tolerance (``train_resume`` line). (d) The same
   llama's first 4 steps captured and then eager from the same weights:
   losses, grad norms, params and moments equal bit for bit
   (``train_capture_ab`` line: replay and eager step ms). The phase
   runs in a world-size-1 NCCL process group started on a ``HashStore`` (no
   network port) with a (1, 1) ``("data", "model")`` mesh, and adds the
   ``dist`` lines: after (a), ``quantize_grad``/``dequantize_grad`` over
   every leaf of the full-width gradients of (a)'s last batch (every error
   within half its row's scale, int8 bytes a quarter of f32's, error
   feedback over 4 steps within 1 % of the gradient in norm, the pass's
   device ms by CUDA events) and the same batch's loss with
   ``seq_parallel=True``, equal bit for bit; in (c), the newest checkpoint
   restored under ``param_shardings``/``opt_state_shardings`` as DTensors,
   every leaf's ``full_tensor()`` and one ``loss_fn`` on the gathered params
   equal to the plain restore's bit for bit.
11. ``cost``: the launch tooling (``repro_torch.launch``) on the card. B3
   through ``quant.w8a8_linear`` on CUDA tensors, bit for bit its plain
   version, at (256 -> 512) and llama3-8b's (4,096 -> 14,336) at B 4, and
   ``quant_error`` on the card under 0.02. Then the llama3-8b ``decode_32k``
   rank cell: one data group's share of the (data=16, model=16) mesh at full
   width and depth (the port has no tensor-parallel form), 8 of the shape's
   128 lanes of 32,768 slots filled with seeded bf16 K/V
   (``launch.hillclimb.rank_cell``), every lane full, no
   prefill, float linears (the config's ``quantized_decode`` is off): B4 held
   at this shape against its plain version on layer 0 and lane by lane, and
   timed there (``kernel_time`` lines: bf16 over the 32 layers' lanes beside
   its plain version and SDPA, fp8 e4m3 over four layers' lanes); the
   step's ``launch.costrun.CostCounter`` count on the card, which must equal
   the same cell's count on ``meta``; then a warm-up and 10 timed steps
   (``launch.hillclimb.time_steps``), exactly 32 B4 launches each, then the
   same step through ``core.interleave``'s captured decode program
   (``launch.hillclimb.captured_step``: a first eager call, a capture, 10
   timed replays; 736 B4 launches in all, added to the kernels line). The
   ``rank_cell``
   line gives the step's median ms, peak memory, the count, its three
   roofline terms at the H100's rates and ``roofline_share`` (memory term
   over the step). Then the ``partitioned`` step (the partitioned program,
   ``models.model.decode_step``/``prefill`` with ``mesh=``): (b) B4 over
   windows of KV heads of the cell's lanes (``k[:, 3:4]`` with its whole
   query group, ``k[:, 2:4]`` with half of each), held to its plain version
   with no window-sized allocation, and timed over the one-head window of
   each layer (``kernel_time`` "rank window"); (c) the partitioned rank
   cell, rank 0 of (data 16, model 16) on a ``fake`` group: 1/16 of the
   weights, the same lanes, B4 over its one-head window; its card counts
   (``CostCounter``, ``CollectiveCounter``) equal ``meta``'s, then as many
   eager and captured steps as the cell above, 32 B4 launches each (a
   ``rank_cell`` line with ``"partitioned": true``); (a) two spawned
   processes on the one card in a ``gloo`` group, mesh (data 1, model 2),
   run llama3-8b at full width cut to 4 layers in f32 (seed 0): a prefill of
   4 seeded 64-token prompts into 256-slot lanes and 8 greedy steps, their
   gathered logits, tokens and caches held to the unsharded program on the
   card and each rank's collective count to ``meta``'s (the ``partitioned``
   line); every B4 launch of (c) and (a) is added to the kernels line.
12. A ``profile`` line per model (device time by kernel group, busy share), a
   ``phase_s`` line per phase of the full run (its wall seconds), a
   ``kernels`` line (launches summed over the serves), the ``nvidia-smi``
   line, and last ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits with code 2 and prints no result.

    python3 chip_smoke.py --ab

builds the kernels and prints only the ``host_cost`` lines and one LBIM
serve line per configuration and pool (llama3-8b paged and contiguous,
zamba2-7b), with the serves' checks. Run from two checkouts in turn
(A, B, B, A) on one machine, it compares their host side.

    python3 chip_smoke.py --attn

builds the kernels and prints only the fp8 attention check and the attention
``kernel_time`` lines (B1, B2 stage 1, the merge and the pair; B4), to compare
builds of the attention kernels in one call.

    python3 chip_smoke.py --ssd

builds the kernels and prints only the SSD scan's ``kernel_time`` and
``kernel_check`` lines (B5), to compare builds of the scan in one call.

    python3 chip_smoke.py --graphs

serves every served family in every mode at the default run's depths (the
serve, zamba2, dense, MoE and families phases' engine serves; no spec,
traffic or profile), each captured and then under ``interleave.eager()``:
one ``graphs_ab`` line per serve, tokens, plans and launches equal.

    python3 chip_smoke.py --gemv
    python3 chip_smoke.py --spec
    python3 chip_smoke.py --traffic
    python3 chip_smoke.py --dense
    python3 chip_smoke.py --moe
    python3 chip_smoke.py --families
    python3 chip_smoke.py --train
    python3 chip_smoke.py --dist
    python3 chip_smoke.py --cost

print only ``pim_gemv``'s ``kernel_time`` lines (llama3-8b's layer at B 1, 4,
8, then every serve shape at B 1 to 8 beside ``torch._int_mm``) and its
``kernel_check`` lines (B3; also at every serve shape),
only the spec phase's lines (each spec serve followed by its eager-rollout
twin, the draft decoder without the engine's graphs: every round's drafts,
every event's acceptance and emitted tokens, the tokens and the launches
equal; ``spec_rollout_ab`` lines give the round ms both ways beside the
plain step ms), only the traffic phase's and the CLI's, only
the dense phase's, only the MoE phase's or only the families phase's (each
with its kernel checks and times), only the training phase's (no kernel
check: the phase launches none; (a) runs again under ``interleave.eager()``,
its losses and grad norms equal to the captured run's: ``train_steps_ab``),
or only the ``dist`` checks (on internvl2-2b
with seeded weights over the training phase's last batch, and on a
checkpoint of the ~125 M llama written by two steps of ``train.loop.run``)
followed by the partitioned train step's two gloo ranks
(``train.train_step.train_step_`` with ``mesh=``: llama3-8b at full width
cut to 2 layers, f32, ``remat`` on, seed 0, a seeded global batch of 4 x
256 tokens at ``accum`` 2, two steps, on meshes (data 1, model 2) and
(data 2, model 1), ``launch.partitioned.train_run``: rank 0 first runs the
unsharded step on the card from the same params and batch; every rank's
loss, ``grad_norm`` and ``lr`` are held to it, its params and moments
gathered back with ``dist.sharding.full_tree`` too, its collective count to
``meta``'s; no kernel launches: ``partitioned_train`` lines, with the wall
time and each rank's peak memory; about 2.5 minutes, most of it gloo moving
the (2, 1) mesh's f32 gradients and params through host memory, which is
why it is not in the default run),
or the cost phase (11), then the partitioned ``train_4k`` rank cell (rank 0
of (data 16, model 16) on a ``fake`` group, ``launch.hillclimb.rank_cell``:
1/16 of llama3-8b's bf16 weights, its 1/256 ZeRO-1 slice of the moments, its
16 rows of 4,096 tokens at ``accum`` 4, ``remat`` on; its ``CostCounter``
and ``CollectiveCounter`` counts on the card equal ``meta``'s, its step
eager and captured (``train.train_step.TrainGraphs``), peak memory, ``mfu``
and the count's roofline terms: a ``rank_cell`` line with ``"shape":
"train_4k"``), then ``launch.hillclimb`` on the rank cell with fp8
e4m3 K/V against bf16 (each counted on ``meta`` and timed on the card), then
the 40-cell dry run and cost count on ``meta`` with the roofline table at the
H100's rates (``cost_cell`` lines; about 15 minutes of host time, most of it
rwkv6's per-token scan, no card; the dense archs' ``train_4k`` collectives
counted from the partitioned train step).

    python3 chip_smoke.py --partitioned

runs the partitioned program of gemma2-27b, internvl2-2b and
seamless-m4t-large-v2 (tied head and softcaps, GSPMD's padded vocab, the
image prefix, the encoder and cross K/V under ``mesh=``): (a) two gloo ranks
on the card, each arch at full width cut to 2 layers (seamless 2 + 2), f32:
a prefill and 8 greedy steps on (data 1, model 2), logits, tokens and caches
held to the unsharded program on the card, counts to ``meta``
(``partitioned`` lines); two train steps on (1, 2) and (2, 1) (gemma2-27b on
(1, 2) alone: two f32 ranks of its (2, 1) overfill the card) held to the
unsharded step rank 0 runs (``partitioned_train`` lines); (b) B4 at
gemma2-27b's rank launch (2 query heads over KV head 0, 32,768 slots,
softcap 50.0), a local and a global layer, checked and timed beside SDPA;
(c) the ``decode_32k`` rank of (16, 16) on a ``fake`` group for each arch
(gemma2-27b at 4 of its 8 lanes), card counts equal to ``meta``'s, eager and
captured steps, exact B4 launches (``rank_cell`` lines); (d) gemma2-27b's
``train_4k`` rank as ``--cost`` runs llama3-8b's. It ends with a
``kernels`` line of B4's row at (b)'s global launch and the ``ok`` line.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit) and
# the kernels' work formulas live in the package (launch.roofline, kernels.work)
from repro_torch.kernels import work  # noqa: E402
from repro_torch.launch.roofline import (HBM_BW as HBM_BYTES_PER_S,  # noqa: E402
                                         PEAK_F32_FLOPS, PEAK_FLOPS as PEAK_BF16_FLOPS,
                                         PEAK_INT8_OPS, PEAK_TF32_FLOPS, bound)

TF32_PIECES = 3                 # the SSD kernel's products: lo*hi + hi*lo + hi*hi
L2_BYTES = 50 * 2**20

# attention tolerance: kernel and plain version both accumulate in f32, but the
# kernel rescales its running sums tile by tile (online softmax), merges the
# partials of its warps and blocks, and so adds the products in another order:
# the two differ by a few f32 ulps per tile
ATTN_RTOL, ATTN_ATOL = 1e-4, 1e-5
# SSD scan tolerance: f32 on both sides; the chunked kernel sums each output's
# terms in another order than the sequential recurrence and takes exp of
# cumulative log decays where the recurrence multiplies the step decays
SSD_RTOL, SSD_ATOL = 1e-4, 1e-4

GEMV_LAYER = [  # (N, K, launches per layer) of llama3-8b's seven decode GEMVs
    (4096, 4096, 2),     # wq, wo
    (1024, 4096, 2),     # wk, wv
    (14336, 4096, 2),    # w_gate, w_up
    (4096, 14336, 1),    # w_down
]
GEMV_RAGGED = (3001, 4100)   # N odd, K % 16 != 0: the plain kernel
# past the llama3-8b shapes, as the Pallas op takes any B and K: gemma2-27b's
# w_down (K 36,864) at B 8 and in batch groups (B 16, 17), batch groups of the
# serve shapes (B 9, 16, 17), a tile past N and a K tile past K (zeros read
# past both edges), K splits at narrow N, and an odd K in batch groups
GEMV_WIDE = ((4096, 36864, 8), (4096, 36864, 16), (4096, 36864, 17), (4096, 4096, 9),
             (4096, 4096, 16), (14336, 4096, 17), (1024, 4096, 9), (1000, 4112, 5),
             (512, 4096, 3), (1024, 1024, 8), (3001, 4100, 16))
SLOTS = 4


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def phase_clock(name: str):
    """Emit the wall seconds the block took: where the run's time budget goes."""
    t0 = time.perf_counter()
    yield
    emit({"phase": "phase_s", "name": name, "s": time.perf_counter() - t0})


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def copies_for(nbytes: int) -> int:
    """Distinct input sets to cycle through so repeated launches find L2 cold."""
    return max(2, min(16, math.ceil(4 * L2_BYTES / max(nbytes, 1))))


def cuda_ms(fns, iters: int) -> float:
    """Device milliseconds per call, cycling ``fns`` (each over its own inputs).

    The calls are captured into one CUDA graph and the replay is timed with
    CUDA events, so the host's cost of launching from Python (more than many
    of these kernels take on the card) is not counted. A call that torch
    cannot capture raises: no number here is ever an eager launch loop."""
    for f in fns[:2]:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# ---------------------------------------------------------------------------
# pim_gemv
# ---------------------------------------------------------------------------


def gemv_inputs(n, k, b, gen, dev):
    w = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
    x = torch.randint(-127, 128, (b, k), generator=gen, device=dev, dtype=torch.int8)
    ws = torch.rand((n,), generator=gen, device=dev) * 0.01 + 0.005
    xs = torch.rand((b,), generator=gen, device=dev) * 0.1 + 0.05
    return w, x, ws, xs


def gemv_bound(n, k, b) -> tuple[float, str]:
    return bound(*work.gemv_work(n, k, b), PEAK_INT8_OPS)


def library_ms(name: str, fns, iters: int):
    """Time of the PyTorch library yardstick, or None where torch refuses it."""
    try:
        return cuda_ms(fns, iters)
    except RuntimeError as e:
        emit({"phase": "library_unavailable", "kernel": name, "error": str(e)[:300]})
        return None


def gemv_path(n, k, b, vec=True) -> str:
    """How B3 cuts the call: tensor-core tiles with their K splits and batch
    groups, or the plain kernel (``pim_gemv.plan``)."""
    from repro_torch.kernels.pim_gemv.pim_gemv import plan

    p = plan(n, k, b, vec)
    if not p["tensor_cores"]:
        return f"plain, {p['groups']} group(s)"
    return (f"tensor cores, {p['row_tiles']} tiles x {p['splits']} split(s) x "
            f"{p['groups']} group(s)")


def gemv_exact(n, k, b, gen, dev, unaligned: bool = False) -> str:
    """One B3 call bit-exact against the plain version and counted once; its
    path. ``unaligned``: x one byte off a 16-byte boundary."""
    from repro_torch.kernels.pim_gemv.pim_gemv import pim_gemv
    from repro_torch.kernels.pim_gemv.ref import pim_gemv_ref

    w, x, ws, xs = gemv_inputs(n, k, b, gen, dev)
    if unaligned:
        x = torch.empty(b * k + 1, dtype=torch.int8, device=dev)[1:].view(b, k).copy_(x)
    before = pim_gemv.launches
    out, ref = pim_gemv(w, x, ws, xs), pim_gemv_ref(w, x, ws, xs)
    torch.cuda.synchronize()
    if pim_gemv.launches != before + 1:
        raise AssertionError(f"pim_gemv ({n},{k}) B={b}: {pim_gemv.launches - before} "
                             f"launches counted for one call")
    if not torch.equal(out, ref):
        raise AssertionError(f"pim_gemv ({n},{k}) B={b} is not bit-exact: max |err| "
                             f"{float((out - ref).abs().max())}")
    return gemv_path(n, k, b, vec=not unaligned and k % 16 == 0)


def check_pim_gemv(gen, dev) -> dict:
    """B3 bit-exact at llama3-8b's shapes and a ragged one at B 1, 4, 8, past
    them (``GEMV_WIDE``) and with an unaligned x; every path of the kernel
    (one K split and several, batch groups, the plain kernel) must be hit."""
    cases = []
    for n, k in [(n, k) for n, k, _ in GEMV_LAYER] + [GEMV_RAGGED]:
        for b in (1, 4, 8):
            cases.append([n, k, b, gemv_exact(n, k, b, gen, dev)])
    for n, k, b in GEMV_WIDE:
        cases.append([n, k, b, gemv_exact(n, k, b, gen, dev)])
    for n, k, b in ((4096, 4096, 4), (1024, 4096, 8)):
        cases.append([n, k, b, "unaligned x: " + gemv_exact(n, k, b, gen, dev, True)])
    paths = " | ".join(c[3] for c in cases)
    for want in ("x 1 split(s)", "x 8 split(s)", "x 3 group(s)", "plain"):
        if want not in paths:
            raise AssertionError(f"pim_gemv checks hit no '{want}' path: {paths}")
    emit({"phase": "kernel_check", "kernel": "pim_gemv", "exact": True, "cases": cases,
          "max_abs_err": 0.0})
    return {"max_abs_err": 0.0}


def time_pim_gemv(gen, dev) -> dict:
    """Per-shape times, and the sum over one layer's seven GEMVs at B=SLOTS."""
    from repro_torch.kernels.pim_gemv.pim_gemv import pim_gemv
    from repro_torch.kernels.pim_gemv.ref import pim_gemv_ref

    layer = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
             "bound_by": "bytes"}
    for n, k, per_layer in GEMV_LAYER:
        for b in (1, SLOTS, 8):
            sets = [gemv_inputs(n, k, b, gen, dev) for _ in range(copies_for(n * k))]
            ms = cuda_ms([lambda s=s: pim_gemv(*s) for s in sets], 60)
            plain = cuda_ms([lambda s=s: pim_gemv_ref(*s) for s in sets[:2]], 6)
            # library yardstick: int8 x int8 -> int32 GEMM (cuBLAS via torch._int_mm;
            # M padded to 32 rows, which it requires), without the scale epilogue
            xpad = [torch.zeros((32, k), dtype=torch.int8, device=dev) for _ in sets]
            for xp, s in zip(xpad, sets):
                xp[:b] = s[1]
            lib = library_ms("pim_gemv", [lambda xp=xp, s=s: torch._int_mm(xp, s[0].t())
                                          for xp, s in zip(xpad, sets)], 60)
            bnd, by = gemv_bound(n, k, b)
            emit({"phase": "kernel_time", "kernel": "pim_gemv", "n": n, "k": k, "b": b,
                  "path": gemv_path(n, k, b), "ms": ms, "plain_ms": plain,
                  "library_ms": lib, "bound_ms": bnd, "bound_by": by,
                  "weight_GBps": n * k / ms / 1e6, "roofline_share": bnd / ms})
            if b == SLOTS:
                layer["ms"] += per_layer * ms
                layer["plain_ms"] += per_layer * plain
                layer["bound_ms"] += per_layer * bnd
                if by != "bytes":
                    layer["bound_by"] = by
                layer["library_ms"] = (None if lib is None or layer["library_ms"] is None
                                       else layer["library_ms"] + per_layer * lib)
            del sets, xpad
    return layer


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

ATTN_B, ATTN_HKV, ATTN_G, ATTN_HD = 4, 8, 4, 128   # llama3-8b decode, 4 slots
ATTN_NB = 256                                        # 2048-token lanes
ATTN_END = [2048, 777, 0, 300]    # full, ragged, empty, short (splits left dead)
ATTN_START = [0, 0, 0, 100]       # a lane with start > 0
SERVE_TABLE_BLOCKS, SERVE_END = 37, [48, 47, 46, 45]   # the serve's tables, short fills


def attn_inputs(gen, dev, bsz=8, nb=None, copies=1, g=ATTN_G, hd=ATTN_HD, hkv=ATTN_HKV):
    b = ATTN_B
    nb = ATTN_NB if nb is None else nb
    p = b * nb + 1                   # page 0 stays the unused dummy, as in the pool
    q = torch.randn((b, hkv, g, hd), generator=gen, device=dev).to(torch.bfloat16)
    table = (torch.randperm(b * nb, generator=gen, device=dev) + 1).reshape(b, nb)
    pools = []
    for _ in range(copies):
        kp = (torch.randn((p, hkv, hd, bsz), generator=gen, device=dev) * 0.3
              ).to(torch.bfloat16)
        vp = (torch.randn((p, hkv, bsz, hd), generator=gen, device=dev) * 0.3
              ).to(torch.bfloat16)
        pools.append((kp, vp))
    scale = hd ** -0.5
    lim = nb * bsz
    end = torch.tensor([min(e, lim) for e in ATTN_END], dtype=torch.int32, device=dev)
    start = torch.tensor(ATTN_START, dtype=torch.int32, device=dev)
    return q, pools, table.to(torch.int32), end, start, scale


def live_tokens(end, start) -> int:
    return int((end - start).clamp_min(0).sum())


def attn_bound(end, start, n_out_bytes: int, hkv=ATTN_HKV, g=ATTN_G,
               hd=ATTN_HD, kv_bytes: int = 2) -> tuple[float, str]:
    """The live tokens' work (``kernels.work.attn_work``) over the card's
    peaks; q in bf16."""
    return bound(*work.attn_work(live_tokens(end, start), int(end.numel()), hkv, g, hd,
                                 n_out_bytes, kv_bytes=kv_bytes), PEAK_BF16_FLOPS)


def _allclose(name, out, ref) -> float:
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    if not torch.allclose(out, ref, rtol=ATTN_RTOL, atol=ATTN_ATOL):
        raise AssertionError(f"{name}: max |err| {err} outside rtol={ATTN_RTOL} "
                             f"atol={ATTN_ATOL}")
    return err


def check_batch_invariant(name, fn, out, b: int) -> None:
    """``fn(i)`` computes lanes ``i`` (a slice) alone; each lane of the batch
    output ``out`` must have the same bits as that lane computed with B = 1."""
    for i in range(b):
        alone = fn(slice(i, i + 1))
        torch.cuda.synchronize()
        if not torch.equal(alone, out[i:i + 1]):
            err = float((alone - out[i:i + 1]).abs().max())
            raise AssertionError(f"{name}: lane {i} alone differs from the batch "
                                 f"(max |diff| {err}); a lane must not depend on the batch")


def check_attention(gen, dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    errs = {"decode_attention_paged": 0.0, "decode_attention_paged_split": 0.0,
            "merge_splits": 0.0}
    # (page size, blocks per lane, softcap, G, hd): the main path's shape, large
    # pages, a softcap, the kernel's wide instantiation (G > 4, hd > 128), and
    # the paged llama3-8b serve's own 37-block tables
    cases = ((8, ATTN_NB, None, ATTN_G, ATTN_HD), (64, 32, None, ATTN_G, ATTN_HD),
             (8, 64, 30.0, ATTN_G, ATTN_HD), (8, 64, None, 6, 256),
             (8, SERVE_TABLE_BLOCKS, None, ATTN_G, ATTN_HD))
    for bsz, nb, cap, g, hd in cases:
        q, pools, table, end, start, scale = attn_inputs(gen, dev, bsz=bsz, nb=nb, g=g, hd=hd)
        kp, vp = pools[0]
        out = da.decode_attention_paged(q, kp, vp, table, end, start, scale=scale,
                                        softcap=cap)
        want = ref.decode_attention_paged_ref(q, kp, vp, table, end, scale, cap,
                                              start=start)
        torch.cuda.synchronize()
        errs["decode_attention_paged"] = max(
            errs["decode_attention_paged"],
            _allclose(f"decode_attention_paged bsz={bsz}", out, want))
        if not bool((out[2] == 0).all()):
            raise AssertionError("empty range (end=0) must give exact zeros")
        if (bsz, nb, cap, g, hd) == cases[0]:   # the main path's shape
            check_batch_invariant(
                "decode_attention_paged",
                lambda i: da.decode_attention_paged(q[i], kp, vp, table[i], end[i], start[i],
                                                    scale=scale), out, ATTN_B)
            check_batch_invariant(
                "decode_attention_paged_split, 4 splits",
                lambda i: da.decode_attention_paged_split(q[i], kp, vp, table[i], end[i],
                                                          start[i], num_splits=4, scale=scale),
                da.decode_attention_paged_split(q, kp, vp, table, end, start, num_splits=4,
                                                scale=scale), ATTN_B)
        for s in (2, 4, 8):
            acc, m, l = da.split_partials(q, kp, vp, table, end, start, num_splits=s,
                                          scale=scale, softcap=cap)
            racc, rm, rl = ref.split_partials_ref(q, kp, vp, table, end, s, scale, cap,
                                                  start=start)
            torch.cuda.synchronize()
            e = max(_allclose(f"split acc S={s}", acc, racc),
                    _allclose(f"split m S={s}", m, rm),
                    _allclose(f"split l S={s}", l, rl))
            errs["decode_attention_paged_split"] = max(
                errs["decode_attention_paged_split"], e)
            dead = rl == 0
            if not (bool((m[dead] == ref.NEG_INF).all())
                    and bool((acc[dead] == 0).all())):
                raise AssertionError(f"dead split S={s} is not the identity partial")
            if not bool(dead.any()):
                raise AssertionError(f"S={s}: the fills were meant to leave splits dead")
            merged = da.merge_splits(acc, m, l)
            errs["merge_splits"] = max(
                errs["merge_splits"],
                _allclose(f"merge_splits S={s}", merged, ref.merge_splits(acc, m, l)))
            _allclose(f"split vs single pass S={s}", merged, want)
            if not bool((merged[2] == 0).all()):
                raise AssertionError("all-dead lane must merge to zeros, not NaN")
    # the spec serve's verify launches: its own tables (max_len plus the spec
    # slack; one chunk, no merge) at the fills its lanes reach
    sreqs = spec_requests(get_config("llama3-8b").vocab_size)
    nb = spec_table_blocks(sreqs)
    q, pools, table, _, _, scale = attn_inputs(gen, dev, nb=nb)
    kp, vp = pools[0]
    spec_cases = []
    for when, fills in serve_fills(sreqs).items():
        end = torch.tensor(fills, dtype=torch.int32, device=dev)
        start = torch.zeros_like(end)
        out = da.decode_attention_paged(q, kp, vp, table, end, start, scale=scale)
        want = ref.decode_attention_paged_ref(q, kp, vp, table, end, scale, None, start=start)
        torch.cuda.synchronize()
        errs["decode_attention_paged"] = max(
            errs["decode_attention_paged"],
            _allclose(f"decode_attention_paged spec serve {when}", out, want))
        check_batch_invariant(
            f"decode_attention_paged spec serve {when}",
            lambda i: da.decode_attention_paged(q[i], kp, vp, table[i], end[i], start[i],
                                                scale=scale), out, ATTN_B)
        spec_cases.append([8, nb, None, ATTN_G, ATTN_HD, "batch invariant", fills])
    # the traffic serves' launches: their tables without (a, b, d) and with
    # (c, verify) the spec slack, at the trace's fills (lanes past 256 tokens
    # take two chunks and the merge)
    treqs = traffic_trace(get_config("llama3-8b").vocab_size).to_requests()
    traffic_cases = []
    for spec in (False, True):
        nb = traffic_table_blocks(treqs, spec)
        q, pools, table, _, _, scale = attn_inputs(gen, dev, nb=nb)
        kp, vp = pools[0]
        for when, fills in traffic_fills(treqs).items():
            end = torch.tensor(fills, dtype=torch.int32, device=dev)
            start = torch.zeros_like(end)
            out = da.decode_attention_paged(q, kp, vp, table, end, start, scale=scale)
            want = ref.decode_attention_paged_ref(q, kp, vp, table, end, scale, None,
                                                  start=start)
            torch.cuda.synchronize()
            errs["decode_attention_paged"] = max(
                errs["decode_attention_paged"],
                _allclose(f"decode_attention_paged traffic {nb} blocks {when}", out, want))
            check_batch_invariant(
                f"decode_attention_paged traffic {nb} blocks {when}",
                lambda i: da.decode_attention_paged(q[i], kp, vp, table[i], end[i], start[i],
                                                    scale=scale), out, ATTN_B)
            traffic_cases.append([8, nb, None, ATTN_G, ATTN_HD, "batch invariant", fills])
    emit({"phase": "kernel_check", "kernel": "decode_attention_paged (+split, merge)",
          "q": [ATTN_B, ATTN_HKV, ATTN_G, ATTN_HD], "pages": "bf16",
          "end": ATTN_END, "start": ATTN_START, "cases": [list(c) for c in cases],
          "spec_serve_cases": spec_cases, "traffic_serve_cases": traffic_cases,
          "splits": [2, 4, 8],
          "batch_invariant": [list(cases[0]), list(cases[0]) + ["4 splits"]],
          "rtol": ATTN_RTOL, "atol": ATTN_ATOL, "max_abs_err": errs})
    return errs


F8 = torch.float8_e4m3fn


def check_fp8_attention(gen, dev) -> dict:
    """B1, the B2 pair (4 splits: stage 1's partials and the merge) and B4
    over fp8 e4m3 K/V at llama3-8b's G 4 / hd 128 (q bf16, as the serves give
    it; 2048-token lanes of 8 chunks, a ragged lane, an empty one, a start > 0,
    dead splits) and B4 at zamba2-7b's G 1 / hd 112, against the plain versions
    (both widen e4m3 to f32 exactly), each lane alone too. Returns the largest
    |err| per kernel."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    errs = dict.fromkeys(("decode_attention", "decode_attention_paged",
                          "decode_attention_paged_split", "merge_splits"), 0.0)

    def note(name, err):
        errs[name] = max(errs[name], err)

    q, pools, table, end, start, scale = attn_inputs(gen, dev)
    kp, vp = (t.to(F8) for t in pools[0])
    out = da.decode_attention_paged(q, kp, vp, table, end, start, scale=scale)
    want = ref.decode_attention_paged_ref(q, kp, vp, table, end, scale, start=start)
    torch.cuda.synchronize()
    note("decode_attention_paged", _allclose("fp8 decode_attention_paged", out, want))
    acc, m, l = da.split_partials(q, kp, vp, table, end, start, num_splits=4, scale=scale)
    racc, rm, rl = ref.split_partials_ref(q, kp, vp, table, end, 4, scale, start=start)
    merged = da.merge_splits(acc, m, l)
    torch.cuda.synchronize()
    note("decode_attention_paged_split",
         max(_allclose(f"fp8 split {w}", a, r) for w, a, r in
             (("acc", acc, racc), ("m", m, rm), ("l", l, rl))))
    note("merge_splits", _allclose("fp8 split + merge", merged, want))
    dead = rl == 0
    if not (bool(dead.any()) and bool((m[dead] == ref.NEG_INF).all())
            and not bool(acc[dead].any())):
        raise AssertionError("fp8 splits: the dead splits are not the identity partial")
    if bool(out[2].any()) or bool(merged[2].any()):
        raise AssertionError("fp8: an empty range must give exact zeros")
    check_batch_invariant("fp8 decode_attention_paged", lambda i: da.decode_attention_paged(
        q[i], kp, vp, table[i], end[i], start[i], scale=scale), out, ATTN_B)
    check_batch_invariant("fp8 decode_attention_paged_split, 4 splits",
                          lambda i: da.decode_attention_paged_split(
                              q[i], kp, vp, table[i], end[i], start[i], num_splits=4,
                              scale=scale), merged, ATTN_B)
    cases = [["B1 + B2 pair", list(q.shape), "pages of 8", ATTN_NB, "batch invariant"]]
    for name, hkv, g, hd in CONTIG_SHAPES:
        q, lanes, end, start, scale = contig_inputs(gen, dev, hkv, g, hd)
        k, v = (t.to(F8) for t in lanes[0])
        out = da.decode_attention(q, k, v, end, start, scale=scale)
        want = ref.decode_attention_ref(q, k, v, end, scale, start=start)
        torch.cuda.synchronize()
        note("decode_attention", _allclose(f"fp8 decode_attention {name}", out, want))
        if bool(out[2].any()):
            raise AssertionError("fp8: an empty range must give exact zeros")
        check_batch_invariant(f"fp8 decode_attention {name}", lambda i: da.decode_attention(
            q[i], k[i], v[i], end[i], start[i], scale=scale), out, ATTN_B)
        cases.append(["B4", name, list(q.shape), CONTIG_LMAX, "batch invariant"])
    emit({"phase": "kernel_check", "kernel": "decode attention, fp8 e4m3 K/V", "cases": cases,
          "end": ATTN_END, "start": ATTN_START, "splits": 4, "rtol": ATTN_RTOL,
          "atol": ATTN_ATOL, "max_abs_err": errs})
    return errs


def sdpa_calls(q, pools, table, end, start, scale) -> list:
    """The library yardstick of paged attention: SDPA over lanes materialized
    from the pages and expanded to the query heads beforehand (boolean
    live-range mask), one call per pool copy (at most two). That preparation
    is not timed, and the port never calls SDPA."""
    from repro_torch.kernels.decode_attention import ref

    b, hkv, g, hd = q.shape
    lmax = table.shape[1] * pools[0][0].shape[-1]
    idx = torch.arange(lmax, device=q.device)
    mask = ((idx[None, :] >= start[:, None]) & (idx[None, :] < end[:, None]))[:, None, None, :]
    qh = q.reshape(b, hkv * g, 1, hd)
    calls = []
    for kp, vp in pools[:2]:
        k, v = ref.materialize_pages(kp, vp, table)
        k = k.transpose(-1, -2).repeat_interleave(g, dim=1).contiguous()
        v = v.repeat_interleave(g, dim=1).contiguous()
        calls.append(lambda k=k, v=v: F.scaled_dot_product_attention(
            qh, k, v, attn_mask=mask, scale=scale))
    return calls


def time_attention(gen, dev) -> dict:
    """B1, B2 stage 1 and the merge at the kernel-bench shape (256-block
    tables), one line each; B2's pair (stage 1 + merge, the function the
    4-split serve calls) there and at the paged serve's own regime, beside B1
    at that regime."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    b, hkv, g, hd = ATTN_B, ATTN_HKV, ATTN_G, ATTN_HD
    pool_bytes = (b * ATTN_NB + 1) * hkv * hd * 8 * 2 * 2     # K and V pages, bf16
    q, pools, table, end, start, scale = attn_inputs(gen, dev, copies=copies_for(pool_bytes))
    out_bytes = b * hkv * g * hd * 4
    s = 4
    res = {}

    # the closures read q, pools, table, end and start when called, so they
    # follow the rebinding to the serve regime below
    def single(kp, vp):
        return da.decode_attention_paged(q, kp, vp, table, end, start, scale=scale)

    def single_ref(kp, vp):
        return ref.decode_attention_paged_ref(q, kp, vp, table, end, scale, start=start)

    def split1(kp, vp):
        return da.split_partials(q, kp, vp, table, end, start, num_splits=s, scale=scale)

    def split1_ref(kp, vp):
        return ref.split_partials_ref(q, kp, vp, table, end, s, scale, start=start)

    def pair(kp, vp):
        return da.decode_attention_paged_split(q, kp, vp, table, end, start, num_splits=s,
                                               scale=scale)

    def pair_ref(kp, vp):
        return ref.decode_attention_paged_split_ref(q, kp, vp, table, end, s, scale,
                                                    start=start)

    def line(kernel, splits, fn, fn_ref, lib, n_out_bytes=out_bytes, **note) -> dict:
        bnd, by = attn_bound(end, start, n_out_bytes)
        ms = cuda_ms([lambda p=p: fn(*p) for p in pools], 100)
        row = {"ms": ms, "plain_ms": cuda_ms([lambda p=p: fn_ref(*p) for p in pools[:2]], 10),
               "library_ms": lib, **note, "bound_ms": bnd, "bound_by": by}
        emit({"phase": "kernel_time", "kernel": kernel, "splits": splits,
              "table_blocks": table.shape[1], "live_tokens": live_tokens(end, start), **row,
              "roofline_share": bnd / ms})
        return row

    sdpa = library_ms("decode_attention_paged",
                      sdpa_calls(q, pools, table, end, start, scale), 100)
    res["decode_attention_paged"] = line("decode_attention_paged", 1, single, single_ref,
                                         sdpa)
    _, n_real = ref.realized_splits(ATTN_NB, s)
    part_bytes = b * hkv * n_real * g * (hd + 2) * 4
    # stage 1 and the merge together compute the function SDPA computes on
    # these inputs: the stage-1 row carries the same SDPA yardstick
    res["decode_attention_paged_split"] = line(
        "decode_attention_paged_split", s, split1, split1_ref, sdpa, part_bytes,
        library_note="SDPA, against stage 1 + merge together")
    parts = [split1(*p) for p in pools[:8]]
    bnd, by = bound(*work.merge_work(b, hkv, n_real, g, hd), PEAK_BF16_FLOPS)
    ms = cuda_ms([lambda pt=pt: da.merge_splits(*pt) for pt in parts], 200)
    res["merge_splits"] = {
        "ms": ms, "plain_ms": cuda_ms([lambda pt=pt: ref.merge_splits(*pt) for pt in parts], 50),
        "library_ms": None, "bound_ms": bnd, "bound_by": by}
    emit({"phase": "kernel_time", "kernel": "merge_splits", "splits": s,
          "table_blocks": ATTN_NB, "live_tokens": live_tokens(end, start), **res["merge_splits"],
          "roofline_share": bnd / ms})
    line("decode_attention_paged_split + merge_splits", s, pair, pair_ref, sdpa)
    del parts

    # B1 over the same pages in fp8 e4m3: half the K/V bytes of bf16
    f8_pools = [(kp.to(F8), vp.to(F8)) for kp, vp in pools]
    bnd, by = attn_bound(end, start, out_bytes, kv_bytes=1)
    ms = cuda_ms([lambda p=p: single(*p) for p in f8_pools], 100)
    emit({"phase": "kernel_time", "kernel": "decode_attention_paged", "kv": "fp8 e4m3",
          "splits": 1, "table_blocks": table.shape[1], "live_tokens": live_tokens(end, start),
          "ms": ms, "bf16_ms": res["decode_attention_paged"]["ms"],
          "plain_ms": cuda_ms([lambda p=p: single_ref(*p) for p in f8_pools[:2]], 10),
          "library_ms": None, "bound_ms": bnd, "bound_by": by, "roofline_share": bnd / ms})
    del f8_pools

    # the serve's own regime: block tables as wide as its max_len (296 tokens)
    # holding under 50 tokens a lane, as in the profiled decode-heavy serve
    nb = SERVE_TABLE_BLOCKS
    q, pools, table, _, _, scale = attn_inputs(
        gen, dev, nb=nb, copies=copies_for((b * nb + 1) * hkv * hd * 8 * 2 * 2))
    end = torch.tensor(SERVE_END, dtype=torch.int32, device=dev)
    start = torch.zeros_like(end)
    sdpa = library_ms("decode_attention_paged",
                      sdpa_calls(q, pools, table, end, start, scale), 100)
    line("decode_attention_paged", 1, single, single_ref, sdpa)
    line("decode_attention_paged_split + merge_splits", s, pair, pair_ref, sdpa)
    return res


# ---------------------------------------------------------------------------
# contiguous decode attention (B4)
# ---------------------------------------------------------------------------

CONTIG_LMAX = 2048
# (name, Hkv, G, hd): llama3-8b through the contiguous pool, zamba2-7b's
# shared block (32 kv heads of 112, one query head each)
CONTIG_SHAPES = (("llama3-8b", 8, 4, 128), ("zamba2-7b", 32, 1, 112))


def contig_inputs(gen, dev, hkv, g, hd, lmax=None, copies=1):
    b = ATTN_B
    lmax = CONTIG_LMAX if lmax is None else lmax
    q = torch.randn((b, hkv, g, hd), generator=gen, device=dev).to(torch.bfloat16)
    lanes = []
    for _ in range(copies):
        k = (torch.randn((b, hkv, hd, lmax), generator=gen, device=dev) * 0.3
             ).to(torch.bfloat16)
        v = (torch.randn((b, hkv, lmax, hd), generator=gen, device=dev) * 0.3
             ).to(torch.bfloat16)
        lanes.append((k, v))
    end = torch.tensor([min(e, lmax) for e in ATTN_END], dtype=torch.int32, device=dev)
    start = torch.tensor(ATTN_START, dtype=torch.int32, device=dev)
    return q, lanes, end, start, hd ** -0.5


def serve_fills(reqs) -> dict[str, list[int]]:
    """Lane fills of a serve's first four requests: half way through their
    decode, and at their last decode step."""
    return {"half way": [len(r.prompt) + r.max_new_tokens // 2 for r in reqs[:ATTN_B]],
            "last step": [len(r.prompt) + r.max_new_tokens - 1 for r in reqs[:ATTN_B]]}


def check_contig_attention(gen, dev) -> float:
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    def check(what, q, k, v, end, start, scale, cap, invariant):
        out = da.decode_attention(q, k, v, end, start, scale=scale, softcap=cap)
        want = ref.decode_attention_ref(q, k, v, end, scale, cap, start=start)
        torch.cuda.synchronize()
        err = _allclose(f"decode_attention {what}", out, want)
        if not bool((out[end <= start] == 0).all()):
            raise AssertionError("empty range (end <= start) must give exact zeros")
        if invariant:
            check_batch_invariant(
                f"decode_attention {what}",
                lambda i: da.decode_attention(q[i], k[i], v[i], end[i], start[i],
                                              scale=scale, softcap=cap), out, ATTN_B)
        return err

    worst = 0.0
    cases = []
    # per shape: the kernel-bench lanes (8 chunks), Lmax 296 (the contiguous
    # llama3-8b serve's, two chunks on the tensor cores) with a softcap, and a
    # ragged Lmax 300 (not a multiple of 8: the CUDA-core walk over plain loads)
    for name, hkv, g, hd in CONTIG_SHAPES:
        for lmax, cap in ((CONTIG_LMAX, None), (296, 30.0), (300, 30.0)):
            q, lanes, end, start, scale = contig_inputs(gen, dev, hkv, g, hd, lmax)
            if not bool((end == 0).any()):
                raise AssertionError("the fills were meant to leave a lane empty")
            invariant = lmax == CONTIG_LMAX and cap is None    # the main paths' shapes
            worst = max(worst, check(f"{name} lmax={lmax}", q, *lanes[0], end, start,
                                     scale, cap, invariant))
            cases.append([name, hkv, g, hd, lmax, cap, "batch invariant" if invariant else ""])
    # the zamba2 serve's own launch: its Lmax (one chunk, tensor cores, no merge)
    # at the fills its first four requests reach
    _, hkv, g, hd = CONTIG_SHAPES[1]
    reqs = zamba2_requests(get_config("zamba2-7b").vocab_size)
    lmax = serve_max_len(reqs)
    q, lanes, _, _, scale = contig_inputs(gen, dev, hkv, g, hd, lmax)
    for when, fills in serve_fills(reqs).items():
        end = torch.tensor(fills, dtype=torch.int32, device=dev)
        worst = max(worst, check(f"zamba2-7b serve lmax={lmax} {when}", q, *lanes[0], end,
                                 torch.zeros_like(end), scale, None, True))
        cases.append(["zamba2-7b serve", hkv, g, hd, lmax, None, "batch invariant", fills])
    # the spec serve's draft: llama3-8b's shape on lanes of the draft pool's Lmax
    # (one chunk, no merge), each lane alone as the draft runs it (batch 1)
    _, hkv, g, hd = CONTIG_SHAPES[0]
    sreqs = spec_requests(get_config("llama3-8b").vocab_size)
    lmax = spec_draft_lmax(sreqs)
    q, lanes, _, _, scale = contig_inputs(gen, dev, hkv, g, hd, lmax)
    for when, fills in serve_fills(sreqs).items():
        end = torch.tensor(fills, dtype=torch.int32, device=dev)
        worst = max(worst, check(f"llama3-8b spec draft lmax={lmax} {when}", q, *lanes[0],
                                 end, torch.zeros_like(end), scale, None, True))
        cases.append(["llama3-8b spec draft", hkv, g, hd, lmax, None, "batch invariant",
                      fills])
    # the traffic spec serve's draft (c): its Lmax (two chunks and the merge
    # past 256 tokens, the CUDA-core walk: 300 is not a multiple of 8), no
    # softcap, at the trace's fills, each lane alone as the draft runs it
    treqs = traffic_trace(get_config("llama3-8b").vocab_size).to_requests()
    lmax = traffic_draft_lmax(treqs)
    q, lanes, _, _, scale = contig_inputs(gen, dev, hkv, g, hd, lmax)
    for when, fills in traffic_fills(treqs).items():
        end = torch.tensor(fills, dtype=torch.int32, device=dev)
        worst = max(worst, check(f"llama3-8b traffic draft lmax={lmax} {when}", q,
                                 *lanes[0], end, torch.zeros_like(end), scale, None, True))
        cases.append(["llama3-8b traffic draft", hkv, g, hd, lmax, None, "batch invariant",
                      fills])
    emit({"phase": "kernel_check", "kernel": "decode_attention (contiguous)", "batch": ATTN_B,
          "cases": cases, "end": ATTN_END, "start": ATTN_START, "cache": "bf16",
          "rtol": ATTN_RTOL, "atol": ATTN_ATOL, "max_abs_err": worst})
    return worst


def time_contig_attention(gen, dev) -> dict:
    """Both shapes at 2048-token lanes; the kernels line takes zamba2's, the
    shape the hybrid serve launches most."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    rows = {}
    for name, hkv, g, hd in CONTIG_SHAPES:
        lane_bytes = ATTN_B * hkv * hd * CONTIG_LMAX * 2 * 2
        q, lanes, end, start, scale = contig_inputs(gen, dev, hkv, g, hd,
                                                    copies=copies_for(lane_bytes))
        idx = torch.arange(CONTIG_LMAX, device=dev)
        mask = ((idx[None, :] >= start[:, None]) & (idx[None, :] < end[:, None]))[:, None, None]
        qh = q.reshape(ATTN_B, hkv * g, 1, hd)
        sdpa_lanes = [(k.transpose(-1, -2).repeat_interleave(g, dim=1).contiguous(),
                       v.repeat_interleave(g, dim=1).contiguous()) for k, v in lanes[:2]]
        bnd, by = attn_bound(end, start, ATTN_B * hkv * g * hd * 4, hkv=hkv, g=g, hd=hd)
        row = {
            "ms": cuda_ms([lambda kv=kv: da.decode_attention(q, *kv, end, start, scale=scale)
                           for kv in lanes], 100),
            "plain_ms": cuda_ms([lambda kv=kv: ref.decode_attention_ref(
                q, *kv, end, scale, start=start) for kv in lanes[:2]], 10),
            "library_ms": library_ms("decode_attention", [
                lambda kv=kv: F.scaled_dot_product_attention(qh, *kv, attn_mask=mask,
                                                             scale=scale)
                for kv in sdpa_lanes], 100),
            "bound_ms": bnd, "bound_by": by}
        emit({"phase": "kernel_time", "kernel": "decode_attention", "shape": name,
              "q": [ATTN_B, hkv, g, hd], "lmax": CONTIG_LMAX,
              "live_tokens": live_tokens(end, start), **row,
              "roofline_share": row["bound_ms"] / row["ms"]})
        rows[name] = row
        # the same lanes in fp8 e4m3: half the K/V bytes
        f8_lanes = [(k.to(F8), v.to(F8)) for k, v in lanes]
        bnd, by = attn_bound(end, start, ATTN_B * hkv * g * hd * 4, hkv=hkv, g=g, hd=hd,
                             kv_bytes=1)
        ms = cuda_ms([lambda kv=kv: da.decode_attention(q, *kv, end, start, scale=scale)
                      for kv in f8_lanes], 100)
        emit({"phase": "kernel_time", "kernel": "decode_attention", "shape": name,
              "kv": "fp8 e4m3", "q": [ATTN_B, hkv, g, hd], "lmax": CONTIG_LMAX,
              "live_tokens": live_tokens(end, start), "ms": ms, "bf16_ms": row["ms"],
              "plain_ms": cuda_ms([lambda kv=kv: ref.decode_attention_ref(
                  q, *kv, end, scale, start=start) for kv in f8_lanes[:2]], 10),
              "library_ms": None, "bound_ms": bnd, "bound_by": by,
              "roofline_share": bnd / ms})
        del lanes, sdpa_lanes, f8_lanes

    # the zamba2 serve's own regime: lanes as long as its max_len, each
    # request half way through its decode, as the serve launches the kernel
    from repro_torch.configs import get_config

    _, hkv, g, hd = CONTIG_SHAPES[1]
    reqs = zamba2_requests(get_config("zamba2-7b").vocab_size)
    lmax = serve_max_len(reqs)
    fills = serve_fills(reqs)["half way"]
    q, lanes, _, _, scale = contig_inputs(
        gen, dev, hkv, g, hd, lmax, copies=copies_for(ATTN_B * hkv * hd * lmax * 2 * 2))
    end = torch.tensor(fills, dtype=torch.int32, device=dev)
    start = torch.zeros_like(end)
    bnd, by = attn_bound(end, start, ATTN_B * hkv * g * hd * 4, hkv=hkv, g=g, hd=hd)
    ms = cuda_ms([lambda kv=kv: da.decode_attention(q, *kv, end, start, scale=scale)
                  for kv in lanes], 100)
    emit({"phase": "kernel_time", "kernel": "decode_attention", "shape": "zamba2-7b serve",
          "q": [ATTN_B, hkv, g, hd], "lmax": lmax, "end": fills,
          "live_tokens": live_tokens(end, start), "ms": ms,
          "plain_ms": cuda_ms([lambda kv=kv: ref.decode_attention_ref(
              q, *kv, end, scale, start=start) for kv in lanes[:2]], 10),
          "bound_ms": bnd, "bound_by": by, "roofline_share": bnd / ms})
    return rows["zamba2-7b"]


# ---------------------------------------------------------------------------
# SSD chunked scan (B5)
# ---------------------------------------------------------------------------

SSD_H, SSD_P, SSD_N, SSD_Q = 112, 64, 64, 256   # zamba2-7b: d_inner 7168 / 64, chunk 256
SSD_T = 2048
SSD_STRONG = 3.0     # the strong-decay case: log decays three times the test's
SSD_WIDE = (2, 512, 128)   # (B, T, N): a state of two 64-column tiles


def ssd_inputs(gen, dev, b, t, decay=1.0, n=SSD_N):
    """Scan operands at zamba2's widths (``n`` state columns), drawn as the
    JAX package's own scan test draws them (tests/test_kernels.py): log
    decays -|N(0, 1)| * 0.3 (times ``decay``)."""
    x = torch.randn((b, t, SSD_H, SSD_P), generator=gen, device=dev) * 0.5
    a = -torch.randn((b, t, SSD_H), generator=gen, device=dev).abs() * (0.3 * decay)
    bm = torch.randn((b, t, n), generator=gen, device=dev) * 0.5
    cm = torch.randn((b, t, n), generator=gen, device=dev) * 0.5
    s0 = torch.randn((b, SSD_H, SSD_P, n), generator=gen, device=dev) * 0.1
    return x, a, bm, cm, s0


def ssd_work(b, t) -> dict:
    """Work of one scan. ``bytes``: each input read once, y and the final
    state written once. The operations, two ways: the recurrence (the
    definition, ``ssd_scan_ref``) takes 5*P*N flops per step and head (decay,
    outer-product update, output) on the f32 CUDA cores; the chunked products
    at the kernel's sub-chunk (scores shared by the heads) take
    ``kernels.work.ssd_chunked_flops``, run as three TF32 products on the tensor cores
    (``tensor_flops``). The operations' least time is the faster of the two;
    ``bound_f32_cores_ms`` keeps the bound earlier runs reported (the fewer
    flops of the recurrence and the 256-chunk algorithm, all at the f32 rate)."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    sub = getattr(ss, "SUB_CHUNK", 32)
    nbytes, recurrence = work.ssd_work(b, t, SSD_H, SSD_P, SSD_N)
    chunked = work.ssd_chunked_flops(b, t, sub, SSD_H, SSD_P, SSD_N, shared_scores=True)
    tensor = TF32_PIECES * chunked
    ops, peak, ops_by = min((tensor, PEAK_TF32_FLOPS, "tensor cores, TF32 x3"),
                            (recurrence, PEAK_F32_FLOPS, "f32 cores, recurrence"),
                            key=lambda o: o[0] / o[1])
    bnd, by = bound(nbytes, ops, peak)
    old = min(recurrence, work.ssd_chunked_flops(b, t, min(SSD_Q, t), SSD_H, SSD_P, SSD_N,
                                                 shared_scores=False))
    return {"bytes": nbytes, "recurrence_flops": recurrence, "sub_chunk": sub,
            "chunked_flops": chunked, "tensor_flops": tensor, "ops_by": ops_by,
            "ops_ms": 1e3 * ops / peak, "bound_ms": bnd, "bound_by": by,
            "bound_f32_cores_ms": bound(nbytes, old, PEAK_F32_FLOPS)[0]}


def check_ssd_scan(gen, dev) -> float:
    """The kernel against the sequential recurrence (the definition) and the
    model's ``ssd_chunked``. A T that is not a multiple of the chunk is padded
    to it on the kernel's path (zero-decay steps), while ``ssd_chunked`` scans
    such a T as ONE chunk (ssm.py's fallback), whose f32 exp of cumulative log
    decays over a thousand steps loses digits of its own; so the ragged case
    holds the kernel against ``ssd_chunked`` over the padded sequence. The
    strong-decay case (log decays three times the test's, a step of -2.7 at
    three sigma) loses digits the same way at chunk 256, where cumulative log
    decays reach some -180, so it holds the kernel against ``ssd_chunked``
    over the kernel's own 32-step chunks. Each line that is not held reports
    its distance from the recurrence beside. Every comparison also reports its
    largest share of the tolerance, |err| / (atol + rtol |want|). Each lane of
    the B = 4 batch must have the same bits computed alone."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ss
    from repro_torch.kernels.ssd_scan.ops import pad_to_chunk, ssd_scan_op
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models.ssm import ssd_chunked

    sub = getattr(ss, "SUB_CHUNK", 32)
    worst = 0.0
    errs = {}
    cases = ((1, SSD_T, 1.0, SSD_Q), (4, SSD_T, 1.0, SSD_Q), (2, 1000, 1.0, SSD_Q),
             (2, SSD_T, SSD_STRONG, sub))     # 1000 % 256 != 0: the pad path
    for b, t, decay, q_model in cases:
        x, a, bm, cm, s0 = ssd_inputs(gen, dev, b, t, decay)
        y, s = ssd_scan_op(x, a, bm, cm, s0, chunk=SSD_Q)
        yr, sr = ssd_scan_ref(x, a, bm, cm, s0)
        yc, sc = ssd_chunked(*pad_to_chunk(x, a, bm, cm, q_model), q_model, s0)
        yc = yc[:, :t]
        torch.cuda.synchronize()
        tag = f"B={b} T={t}" + (f" decay x{decay:g}" if decay != 1.0 else "")
        for what, got, want in (("y vs ssd_scan_ref", y, yr), ("state vs ssd_scan_ref", s, sr),
                                (f"y vs ssd_chunked at chunk {q_model}", y, yc),
                                (f"state vs ssd_chunked at chunk {q_model}", s, sc)):
            diff = (got - want).abs()
            err = float(diff.max())
            share = float((diff / (SSD_ATOL + SSD_RTOL * want.abs())).max())
            worst = max(worst, err)
            errs[f"{tag} {what}"] = [err, share]
            if not torch.allclose(got, want, rtol=SSD_RTOL, atol=SSD_ATOL):
                raise AssertionError(f"ssd_scan {tag} {what}: max |err| {err} outside "
                                     f"rtol={SSD_RTOL} atol={SSD_ATOL}")
        if t % SSD_Q or q_model != SSD_Q:
            y1, _ = ssd_chunked(x, a, bm, cm, SSD_Q, s0)    # the model's own chunking
            how = "one-chunk fallback" if t % SSD_Q else f"at chunk {SSD_Q}"
            errs[f"{tag} ssd_chunked {how} vs ssd_scan_ref (not held)"] = \
                float((y1 - yr).abs().max())
            del y1
        if b == SLOTS:
            for k, out in ((0, y), (1, s)):
                check_batch_invariant(
                    f"ssd_scan {'y' if k == 0 else 'state'}",
                    lambda i, k=k: ssd_scan_op(x[i], a[i], bm[i], cm[i], s0[i],
                                               chunk=SSD_Q)[k], out, b)
        del x, a, bm, cm, s0, y, s, yr, sr, yc, sc
    # any N, as the Pallas kernel takes it: N 128 is two 64-column tiles
    b, t, n = SSD_WIDE
    x, a, bm, cm, s0 = ssd_inputs(gen, dev, b, t, n=n)
    y, s = ssd_scan_op(x, a, bm, cm, s0, chunk=SSD_Q)
    yr, sr = ssd_scan_ref(x, a, bm, cm, s0)
    torch.cuda.synchronize()
    for what, got, want in (("y", y, yr), ("state", s, sr)):
        diff = (got - want).abs()
        err = float(diff.max())
        worst = max(worst, err)
        errs[f"B={b} T={t} N={n} {what} vs ssd_scan_ref"] = [
            err, float((diff / (SSD_ATOL + SSD_RTOL * want.abs())).max())]
        if not torch.allclose(got, want, rtol=SSD_RTOL, atol=SSD_ATOL):
            raise AssertionError(f"ssd_scan N={n} {what}: max |err| {err} outside "
                                 f"rtol={SSD_RTOL} atol={SSD_ATOL}")
    del x, a, bm, cm, s0, y, s, yr, sr
    emit({"phase": "kernel_check", "kernel": "ssd_scan", "h": SSD_H, "p": SSD_P, "n": SSD_N,
          "chunk": SSD_Q, "cases": [list(c) for c in cases], "wide_n_case": list(SSD_WIDE),
          "against": ["ssd_scan_ref", "ssd_chunked"], "rtol": SSD_RTOL, "atol": SSD_ATOL,
          "batch_invariant": True, "max_abs_err": worst, "errors": errs})
    return worst


def time_ssd_scan(gen, dev) -> dict:
    """B5 at zamba2's scan (B = 4, T 2048): the kernel, its plain version, and
    the model's own scan ``ssd_chunked`` (f32 einsums at chunk 256; what
    zamba2 runs, not a library call) as ``chunked_torch_ms``."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ss
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models.ssm import ssd_chunked

    b = SLOTS
    work = ssd_work(b, SSD_T)
    sets = [ssd_inputs(gen, dev, b, SSD_T) for _ in range(copies_for(work["bytes"]))]
    row = {"ms": cuda_ms([lambda st=st: ss.ssd_scan(*st, chunk=SSD_Q) for st in sets], 20),
           "plain_ms": cuda_ms([lambda st=st: ssd_scan_ref(*st) for st in sets[:2]], 2),
           "chunked_torch_ms": cuda_ms(
               [lambda st=st: ssd_chunked(*st[:4], SSD_Q, st[4]) for st in sets[:2]], 2),
           "library_ms": None,
           "library_note": "no single PyTorch call computes the SSD scan; chunked_torch_ms "
                           "is the model's own scan, not a library call",
           "bound_ms": work["bound_ms"], "bound_by": work["bound_by"]}
    occupancy = getattr(ss, "blocks_per_sm", None)
    emit({"phase": "kernel_time", "kernel": "ssd_scan", "b": b, "t": SSD_T, "h": SSD_H,
          "p": SSD_P, "n": SSD_N, "chunk": SSD_Q, **work, **row,
          "roofline_share": work["bound_ms"] / row["ms"],
          "share_of_f32_cores_bound": work["bound_f32_cores_ms"] / row["ms"],
          "tensor_TFLOPs": work["tensor_flops"] / row["ms"] / 1e9,
          "HBM_TBs": work["bytes"] / row["ms"] / 1e9,
          "walk_blocks_per_sm": occupancy() if occupancy else None})
    return row


# ---------------------------------------------------------------------------
# host cost of the attention wrappers
# ---------------------------------------------------------------------------


def host_us(fn, n: int = 400) -> dict:
    """Host time of one call: the wall clock around it, with the launch queue
    drained before each call so that none waits for room in the queue."""
    for _ in range(20):
        fn()
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        fn()
        ts.append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    ts.sort()
    return {"us_median": ts[n // 2] / 1e3, "us_p10": ts[n // 10] / 1e3}


def host_cost(gen, dev) -> None:
    """``host_cost`` lines: what one attention call costs the host (Python
    wrapper, checks, allocations, tensor-map encoding, launches) at the serves'
    own shapes, and that cost over one decode step's calls (32 attention layers
    for llama3-8b, 13 shared-block applications for zamba2-7b). In an A/B of
    two trees, the calls whose code did not change are the control."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention as da

    nb = SERVE_TABLE_BLOCKS
    q, pools, table, _, _, scale = attn_inputs(gen, dev, nb=nb)
    kp, vp = pools[0]
    end = torch.tensor(SERVE_END, dtype=torch.int32, device=dev)
    start = torch.zeros_like(end)
    _, lanes, _, _, _ = contig_inputs(gen, dev, ATTN_HKV, ATTN_G, ATTN_HD, nb * 8)
    _, hkv, g, hd = CONTIG_SHAPES[1]
    reqs = zamba2_requests(get_config("zamba2-7b").vocab_size)
    zq, zlanes, _, _, zscale = contig_inputs(gen, dev, hkv, g, hd, serve_max_len(reqs))
    zend = torch.tensor(serve_fills(reqs)["half way"], dtype=torch.int32, device=dev)
    calls = {
        "decode_attention_paged, llama3-8b paged serve": (32, lambda: da.decode_attention_paged(
            q, kp, vp, table, end, start, scale=scale)),
        "decode_attention, llama3-8b contiguous serve": (32, lambda: da.decode_attention(
            q, *lanes[0], end, start, scale=scale)),
        "decode_attention, zamba2-7b serve": (13, lambda: da.decode_attention(
            zq, *zlanes[0], zend, torch.zeros_like(zend), scale=zscale)),
        "split_partials + merge_splits, 4 splits, llama3-8b paged serve": (
            32, lambda: da.decode_attention_paged_split(q, kp, vp, table, end, start,
                                                        num_splits=4, scale=scale)),
    }
    for name, (per_step, fn) in calls.items():
        r = host_us(fn)
        emit({"phase": "host_cost", "call": name, **r, "calls_per_decode_step": per_step,
              "us_per_decode_step": per_step * r["us_median"]})


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


def make_requests(vocab: int, seed: int = 0, n: int = 8, lens=(24, 320), budgets=(8, 49),
                  shared_prefix: bool = True):
    from repro_torch.serve.api import GenerationRequest

    rng = np.random.default_rng(seed)
    lens = rng.integers(lens[0], lens[1], size=n)
    budgets = rng.integers(budgets[0], budgets[1], size=n)
    if shared_prefix:
        lens[[0, 5]] = np.maximum(lens[[0, 5]], 96)
    prompts = [rng.integers(1, vocab, size=int(k)).tolist() for k in lens]
    if shared_prefix:
        prompts[5][:64] = prompts[0][:64]   # a shared 64-token (8-block) prefix
    return [GenerationRequest(prompt=p, max_new_tokens=int(m))
            for p, m in zip(prompts, budgets)]


def zamba2_requests(vocab: int) -> list:
    return make_requests(vocab, seed=1, n=6, lens=(32, 120), budgets=(8, 25),
                         shared_prefix=False)


def serve_max_len(reqs) -> int:
    return max(len(r.prompt) + r.max_new_tokens for r in reqs)


def decode_gemvs(cfg) -> int:
    """W8A8 GEMVs of one attention layer's one-token forward: q/k/v/o and the
    MLP's gate/up/down; a MoE layer's experts stay float (stacked 3-D tables,
    as in the JAX package), so it runs the four attention projections only."""
    return 4 if cfg.n_experts else 7


def attention_layers(cfg) -> int:
    """Attention layers of one forward, each one decode-attention call and, under
    W8A8, ``decode_gemvs`` GEMVs: zamba2's shared-block applications, none for
    rwkv6 (attention-free, its projections plain matmuls: it launches no kernel
    of the port, as the JAX package reaches no Pallas kernel there), every
    layer of the others (the audio decoder's)."""
    from repro_torch.models.model import _hybrid_groups

    if cfg.family == "ssm":
        return 0
    return _hybrid_groups(cfg) if cfg.family == "hybrid" else cfg.n_layers


def expected_launches(eng, cfg) -> dict[str, int]:
    """Launches one serve must make. Every forward of one token per lane (each
    decode step, each verify position of a spec round, and an admission chunk
    of a single token) runs the decode GEMVs (``decode_gemvs``) and one
    attention call per attention layer (llama3-8b's 32 layers; zamba2-7b's 13
    applications of its shared block): the contiguous kernel for a contiguous
    pool; for a paged pool the single-pass kernel, or the split kernel and the merge when
    ``decode_kv_splits`` (clamped to the block table's width) is above 1.
    A spec serve's draft rollouts add, per round's event, each chained
    candidate (``spec_draft_steps``) and each catch-up of one token
    (``spec_catchup_decodes``): a single-token forward of the draft on its
    batch-1 contiguous lane (the GEMVs and the contiguous kernel; nothing for
    an rwkv6 draft, ``attention_layers``); a longer
    catch-up, the lane resync prefill, longer
    chunks and the batch admission (never one token here: every prompt is
    longer) take GEMMs and dense attention and launch none of the port's
    kernels. Nothing launches the SSD scan, which no model path runs. Failed
    steps are left out: here each failed at an injected fault, which fires
    before any launch (a serve without one must fail no step)."""
    from repro_torch.kernels import launch_counts

    events = [e for e in eng.events if not e.failed]
    one_tok = eng.pool.policy.chunkable   # a ring pool prefills even one token whole
    fwd = sum((e.verify_tokens // e.decode_batch if e.plan.spec else int(e.plan.decode))
              + int(one_tok and e.prefill_tokens == 1) for e in events)
    n = attention_layers(cfg) * fwd
    want = {k: 0 for k in launch_counts()}
    want["pim_gemv"] = decode_gemvs(cfg) * n if cfg.quantized_decode else 0
    if not eng.pool.paged:
        want["decode_attention"] = n
    elif min(cfg.decode_kv_splits, eng.pool.table_blocks) > 1:
        want["decode_attention_paged_split"] = want["merge_splits"] = n
    else:
        want["decode_attention_paged"] = n
    if eng.spec_dec is not None:
        dcfg = eng.spec_dec.draft_cfg
        d_fwd = sum(e.spec_draft_steps + e.spec_catchup_decodes for e in events)
        d_attn = attention_layers(dcfg)
        want["pim_gemv"] += 7 * d_attn * d_fwd if dcfg.quantized_decode else 0
        want["decode_attention"] += d_attn * d_fwd
    return want


def decode_weight_bytes(sm) -> int:
    """Weight bytes one decode step must read: int8 images (and scales) of
    the W8A8 projections, every other weight in its own type, the hybrid's
    shared block once per application, rwkv6's input norm, the audio
    decoder's layers (of its cross attention only the q/o weights: its memory
    K/V were projected at prefill; the encoder not at all), and the lm_head.
    Embedding rows (one per lane) are left out."""
    from repro_torch.core.quant import PreparedLinear
    from repro_torch.models.model import _hybrid_groups

    def nbytes(tree) -> int:
        if isinstance(tree, PreparedLinear):
            return tree.w_q.numel() + 4 * tree.w_scale.numel()
        if isinstance(tree, torch.Tensor):
            return tree.numel() * tree.element_size()
        if isinstance(tree, dict):
            tree = list(tree.values())
        return sum(nbytes(v) for v in tree)

    cfg, dp = sm.cfg, sm.decode_params
    rest = nbytes(dp["final_norm"]) + nbytes(dp["embed"] if cfg.tie_embeddings
                                              else dp["lm_head"])
    if cfg.family == "hybrid":
        return (nbytes(dp["mamba_layers"]) + _hybrid_groups(cfg) * nbytes(dp["shared_attn"])
                + rest)
    if cfg.family == "ssm":
        return nbytes(dp["layers"]) + nbytes(dp["ln_in"]) + rest
    if cfg.family == "audio":
        return sum(nbytes(v) - nbytes([v["cross_attn"]["wk"], v["cross_attn"]["wv"]])
                   for v in dp["dec_layers"]) + rest
    return nbytes(dp["layers"]) + rest


def serve_setup_line(sm, reqs, t0) -> dict:
    cfg = sm.cfg
    wbytes = decode_weight_bytes(sm)
    return {"phase": "serve_setup", "arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": cfg.dtype,
            "quantized_decode": cfg.quantized_decode,
            "windowed_kv_cache": cfg.windowed_kv_cache,
            "max_len": sm.max_len, "slots": SLOTS,
            "prompt_lens": [len(r.prompt) for r in reqs],
            "max_new_tokens": [r.max_new_tokens for r in reqs],
            "setup_s": time.perf_counter() - t0,
            "gpu_mem_GB": torch.cuda.memory_allocated() / 1e9,
            "free_GB": torch.cuda.mem_get_info()[0] / 1e9,
            "decode_weight_GB": wbytes / 1e9,
            "decode_step_bound_ms": 1e3 * wbytes / HBM_BYTES_PER_S}


# ``--graphs``: every serve_run serve is followed by its eager twin
# (``graphs_ab``); the default run holds only llama3-8b's to it (graphs_phase)
GRAPHS_AB = False


def graph_stats(eng) -> dict:
    """The engine's captured step programs (``core.interleave.StepGraphs``)
    for a serve line: graphs held, captures, replays, steps run eagerly (each
    key's first call; every step under ``interleave.eager()``), samplings run
    eagerly over a step's eager logits (``unheld``), host seconds spent
    capturing and the graphs' pool bytes."""
    from repro_torch.core import interleave

    st = eng.graphs.stats()
    return {"captured": interleave.capture_enabled() and eng.graphs.device.type == "cuda",
            "graphs": st["graphs"],
            "captures": st["captures"], "replays": st["replays"],
            "eager_steps": st["eager_steps"], "unheld": st["unheld"],
            "capture_s": st["capture_s"], "graph_pool_GB": st["pool_bytes"] / 1e9}


def check_captured(eng, what: str) -> None:
    """A captured serve ran eagerly only each key's first call, and sampled
    eagerly (with no key) only after a step key's first call."""
    from repro_torch.core import interleave

    st = eng.graphs.stats()
    if eng.graphs.device.type != "cuda" or not interleave.capture_enabled():
        return
    if st["eager_steps"] != st["keys"]:
        raise AssertionError(f"{what}: {st['eager_steps']} steps ran eagerly, but only the "
                             f"first call of each of {st['keys']} keys may: {st}")
    progs = eng.graphs.programs()
    steps = sum(n for p, n in progs.items() if p not in ("sample", "greedy_sample"))
    if st["unheld"] > steps:
        raise AssertionError(f"{what}: {st['unheld']} samplings ran over eager logits, more "
                             f"than the {steps} step keys' first calls: {progs}")


def serve_engine(sm, mode, *, paged: bool = True):
    """The engine a serve_run serve uses: the artifact's (prefix reuse, 8-token
    chunks), or with ``paged=False`` one over a contiguous pool."""
    from repro_torch.serve.engine import Engine

    if paged:
        return sm.engine(mode=mode, slots=SLOTS)
    pool = sm.cache_pool(slots=SLOTS, prefix_cache=False, paged=False)
    return Engine(sm.cfg, sm.params, max_len=sm.max_len, slots=SLOTS, mode=mode,
                  serving=sm, prefix_cache=False, pool=pool)


def graphs_ab(sm, mode, reqs, captured_tokens, captured_events, captured_line, *,
              paged: bool = True, make_engine=None) -> dict:
    """The eager twin of a captured serve: the same requests on a like engine
    (``make_engine()``, else :func:`serve_engine`) under
    ``interleave.eager()``. Greedy tokens, every step's plan and the launch
    counts must equal the captured serve's; the ``graphs_ab`` line gives both
    serves' decode-step ms and tokens/s."""
    from repro_torch.core import interleave

    events: list = []
    with interleave.eager():
        tokens, line = serve_run(sm, mode, reqs, paged=paged, events=events,
                                 make_engine=make_engine)
    out = {"phase": "graphs_ab", "arch": sm.cfg.name, "mode": mode.value,
           "pool": line["pool"], "kv_splits": sm.cfg.decode_kv_splits,
           "tokens_equal": tokens == captured_tokens,
           "plans_equal": [e.plan for e in events] == [e.plan for e in captured_events],
           "launches_equal": line["launches"] == captured_line["launches"],
           "captured_decode_step_ms": captured_line["decode_step_ms_median"],
           "eager_decode_step_ms": line["decode_step_ms_median"],
           "captured_tokens_per_s": captured_line["tokens_per_s"],
           "eager_tokens_per_s": line["tokens_per_s"],
           "captured_wall_s": captured_line["wall_s"], "eager_wall_s": line["wall_s"],
           "eager_steps": line["eager_steps"], "steps": line["steps"]}
    emit(out)
    if not (out["tokens_equal"] and out["plans_equal"] and out["launches_equal"]):
        raise AssertionError(f"{sm.cfg.name} {mode.value}: the captured serve differs from "
                             f"its eager twin: {out}")
    return out


def serve_run(sm, mode, reqs, *, paged: bool = True, events: list | None = None,
              make_engine=None) -> tuple[list, dict]:
    """One serve, with the launch counts of this serve alone (set to 0 just
    before it, read just after) held to what its schedule implies, and a
    clean health report. A pool with prefix reuse must reuse the shared
    prefix; ``paged=False`` serves through a contiguous pool without prefix
    reuse; ``make_engine()`` builds the engine instead (and ``--graphs``'
    eager twin another); ``events``, where given, receives the serve's
    ``ScheduleEvent``s (for pricing). A captured serve (the default) must run
    only each key's first call eagerly."""
    from repro_torch.core import interleave
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.serve.api import FINISH_EOS, FINISH_LENGTH, RequestState

    eng = make_engine() if make_engine is not None else serve_engine(sm, mode, paged=paged)
    if eng.pool.paged != (paged and eng.pool.policy.prefix_capable):
        raise AssertionError(f"{sm.cfg.name}: pool paged={eng.pool.paged}")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = eng.serve(reqs)     # nan_guard: a non-finite logit raises KernelFault
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    for i, r in enumerate(results):
        if r.state is not RequestState.FINISHED or r.finish_reason not in (
                FINISH_LENGTH, FINISH_EOS):
            raise AssertionError(f"request {i}: {r.state} {r.finish_reason} {r.error}")
        if len(r.tokens) != reqs[i].max_new_tokens:
            raise AssertionError(f"request {i}: {len(r.tokens)} tokens, budget "
                                 f"{reqs[i].max_new_tokens}")
    bad = eng.pool.check_invariants()
    if bad:
        raise AssertionError(f"pool invariants: {bad}")
    rep = eng.schedule_report()
    if eng.pool.prefix_cache and rep["reused_prefix_tokens"] <= 0:
        raise AssertionError("the shared prefix was not reused")
    check_clean(f"{sm.cfg.name} {mode.value}", eng, eng.health())
    check_captured(eng, f"{sm.cfg.name} {mode.value}")
    want = expected_launches(eng, sm.cfg)
    if counts != want:
        raise AssertionError(f"{sm.cfg.name} {mode.value} splits={sm.cfg.decode_kv_splits} "
                             f"paged={eng.pool.paged}: launches {counts}, the schedule "
                             f"implies {want}")
    decode = [e.step_s for e in eng.events if e.plan.decode and not e.plan.prefill_chunk]
    ntok = sum(len(r.tokens) for r in results)
    line = {"phase": "serve", "arch": sm.cfg.name, "mode": mode.value,
            "pool": ("paged" if eng.pool.paged else
                     "ring + contiguous" if not eng.pool.policy.chunkable else "contiguous"),
            "chunk": eng.chunk,
            "kv_splits": sm.cfg.decode_kv_splits,
            "requests": len(reqs), "tokens": ntok, "wall_s": wall,
            "tokens_per_s": ntok / wall, "decode_step_ms_median": 1e3 * statistics.median(decode),
            "pure_decode_steps": len(decode), "steps": rep["steps"],
            "fused_steps": rep["fused_steps"], "prefill_tokens": rep["prefill_tokens"],
            "reused_prefix_tokens": rep["reused_prefix_tokens"],
            "gpu_mem_GB": torch.cuda.memory_allocated() / 1e9, "launches": counts,
            **graph_stats(eng)}
    if events is None and GRAPHS_AB:
        events = []
    if events is not None:
        events.extend(eng.events)
    del eng
    tokens = [r.tokens for r in results]
    if GRAPHS_AB and interleave.capture_enabled():
        graphs_ab(sm, mode, reqs, tokens, events, line, paged=paged,
                  make_engine=make_engine)
    return tokens, line


def add_launches(total: dict, line: dict) -> None:
    for k, v in line["launches"].items():
        total[k] = total.get(k, 0) + v


def check_launched(total: dict, names, what: str) -> None:
    missing = [k for k in names if total.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {what} path: {missing}")


def modes_agree(tokens: dict, what: str) -> list:
    from repro_torch.core.pim_modes import Mode

    ref_toks = tokens[Mode.BLOCKED]
    for mode in (Mode.HBCEM, Mode.LBIM):
        if tokens[mode] != ref_toks:
            diff = [i for i, (a, b) in enumerate(zip(ref_toks, tokens[mode])) if a != b]
            raise AssertionError(f"{what}: greedy tokens differ between BLOCKED and "
                                 f"{mode.value} in requests {diff}")
    return ref_toks


# ---------------------------------------------------------------------------
# pricing: the serves' own ScheduleEvents through the port's pimsim, the
# paper's timing model of an LPDDR5-PIM edge device (HBCEM/LBIM). Its seconds
# are that model's, simulated: no number of a ``priced`` line is a time of the
# card but ``replay_host_ms``, the host time of the replay itself.

PRICE_MODEL = "llama-7b"       # pimsim's LLaMA-7B prices the llama3-8b serves
PRICE_DRAFT = "llama-1b"       # the traffic phase's self-draft, priced as benchmarks/traffic.py
PRICE_DEVICES = ("jetson-agx-orin-64gb", "iphone-15-pro")
PRICE_DESIGN = "cd-pim"
SIMULATED = ("simulated seconds of pimsim's LPDDR5-PIM edge device model (the paper's), "
             "not of the card")
PRICED_KEYS = ("total_s", "decode_busy_s", "prefill_busy_s", "overlap_saved_s", "stall_s",
               "idle_steps")


def replay(events, dev_name: str):
    """The events priced by ``pimsim.replay_events`` on ``dev_name``, a spec
    round's rollout on the target's model (and the host ms the replay took)."""
    from repro_torch import pimsim

    t0 = time.perf_counter()
    rep = pimsim.replay_events(events, pimsim.MODELS[PRICE_MODEL], pimsim.DEVICES[dev_name],
                               pimsim.DESIGNS[PRICE_DESIGN])
    return rep, (time.perf_counter() - t0) * 1e3


def priced_line(what: str, events, dev_name: str, replay_json: dict, host_ms: float,
                **extra) -> None:
    emit({"phase": "priced", "serve": what, "model": PRICE_MODEL, "device_model": dev_name,
          "design": PRICE_DESIGN, "units": SIMULATED, "events": len(events),
          **{k: replay_json[k] for k in PRICED_KEYS}, "replay_host_ms": host_ms, **extra})


def dump_events(events: dict[str, list]) -> list[str]:
    """Each named serve's events as JSON under ``chiprun_out/``, to price with
    both packages on the CPU."""
    import dataclasses

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    paths = []
    for name, evs in events.items():
        path = out / f"priced_events_{name.replace(' ', '_')}.json"
        path.write_text(json.dumps([dataclasses.asdict(e) for e in evs], default=str))
        paths.append(str(path.relative_to(ROOT)))
    return paths


def pricing_contract(ok: bool, what: str, events: dict[str, list]) -> None:
    """A pricing contract of the JAX suite, held on the card's own events; a
    failure writes the serves' events out and raises."""
    if not ok:
        raise AssertionError(f"pricing contract failed on the card's events: {what}; "
                             f"events in {dump_events(events)}")


def price_serves(reqs, events: dict[str, list]) -> None:
    """The serve phase's five serves and the same requests' wave baseline at
    SLOTS slots (``wave_baseline_events``), priced on both devices, with the
    JAX suite's contracts on the card's events: continuous HBCEM and LBIM
    decode busy time below the wave's (``test_continuous_batching.py:69``),
    LBIM no slower than BLOCKED with a non-negative overlap (:126)."""
    from repro_torch.serve.engine import wave_baseline_events, wave_baseline_report

    lens, news = [len(r.prompt) for r in reqs], [r.max_new_tokens for r in reqs]
    wave_events = wave_baseline_events(lens, news, SLOTS)
    wave_steps = wave_baseline_report(lens, news, SLOTS)
    for dev_name in PRICE_DEVICES:
        reps = {}
        for name, evs in {**events, "wave baseline": wave_events}.items():
            rep, ms = replay(evs, dev_name)
            decode = [e for e in evs if e.plan.decode]
            priced_line(name, evs, dev_name, rep.to_json(), ms, decode_steps=len(decode),
                        decode_slot_steps=sum(e.decode_batch for e in decode),
                        **({"wave_report": wave_steps} if name == "wave baseline" else {}))
            reps[name] = rep
        wave = reps["wave baseline"]
        for mode in ("hbcem", "lbim"):
            pricing_contract(reps[mode].decode_busy_s < wave.decode_busy_s,
                             f"{mode} decode_busy_s {reps[mode].decode_busy_s} is not below the "
                             f"wave baseline's {wave.decode_busy_s} on {dev_name}",
                             {mode: events[mode], "wave baseline": wave_events})
        lb, bl = reps["lbim"], reps["blocked"]
        pricing_contract(lb.total_s <= bl.total_s + 1e-9 and lb.overlap_saved_s >= 0.0,
                         f"LBIM total_s {lb.total_s} (overlap {lb.overlap_saved_s}) against "
                         f"BLOCKED {bl.total_s} on {dev_name}",
                         {"lbim": events["lbim"], "blocked": events["blocked"]})


def price_spec(events: dict[str, list]) -> None:
    """The spec phase's four serves priced on both devices, self-drafted
    (``draft_model=None``: the rollout priced on the target's model)."""
    for dev_name in PRICE_DEVICES:
        for name, evs in events.items():
            rep, ms = replay(evs, dev_name)
            priced_line(f"spec {name}", evs, dev_name, rep.to_json(), ms, draft_model=None,
                        spec_rounds=rep.spec_rounds, spec_accepted=rep.spec_accepted,
                        spec_saved_s=rep.spec_saved_s)


def price_traffic(runs: dict[str, tuple]) -> None:
    """The traffic serves through ``serve.traffic.priced_latency`` on both
    devices, with benchmarks/traffic.py's SLO targets (1.10 x the HBCEM serve
    (a)'s priced TTFT p95, 1.50 x its TPOT p95, per device) and its draft
    pricing (the self-draft's rollout as LLaMA-1B), and the JAX suite's
    contracts on the card's events: the replay's idle steps are the engine's
    (``test_traffic.py:187``), the same events priced twice give equal dicts
    (:150-153)."""
    from repro_torch import pimsim
    from repro_torch.serve.traffic import priced_latency

    price = dict(model=pimsim.MODELS[PRICE_MODEL], design=pimsim.DESIGNS[PRICE_DESIGN],
                 draft_model=pimsim.MODELS[PRICE_DRAFT])
    for dev_name in PRICE_DEVICES:
        dev = pimsim.DEVICES[dev_name]
        base = priced_latency(runs["a"][0].events, runs["a"][1], dev=dev, **price)
        slo = {"ttft_slo_s": 1.10 * base["ttft_s"]["p95"],
               "tpot_slo_s": 1.50 * base["tpot_s"]["p95"]}
        for name, (eng, res) in runs.items():
            t0 = time.perf_counter()
            p = priced_latency(eng.events, res, dev=dev, **price, **slo)
            ms = (time.perf_counter() - t0) * 1e3
            again = priced_latency(list(eng.events), res, dev=dev, **price, **slo)
            idle = eng.schedule_report()["idle_steps"]
            pricing_contract(p == again and p["idle_steps"] == idle,
                             f"traffic {name} on {dev_name}: priced twice equal {p == again}, "
                             f"idle steps {p['idle_steps']} against the engine's {idle}",
                             {f"traffic {name}": eng.events})
            priced_line(f"traffic {name}", eng.events, dev_name, p["replay"], ms,
                        draft_model=PRICE_DRAFT,
                        **{f"{k}_{q}": p[k].get(q) for k in ("ttft_s", "tpot_s")
                           for q in ("p50", "p95")},
                        slo=p["slo"], engine_idle_steps=idle)


def serve_phase(dev) -> dict:
    """llama3-8b: paged in the three modes, paged with 4 KV splits, and the
    contiguous pool in LBIM; then the spec and traffic phases on the same
    weights."""
    from repro_torch.configs import get_config
    from repro_torch.core.pim_modes import Mode
    from repro_torch.models.model import init_params
    from repro_torch.serve.serving_model import ServingModel

    cfg = get_config("llama3-8b").replace(quantized_decode=True)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    reqs = make_requests(cfg.vocab_size)
    max_len = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    max_len = -(-max_len // 8) * 8
    sm = ServingModel.prepare(cfg, params, max_len=max_len, slots=SLOTS, device=dev)
    torch.cuda.synchronize()
    emit(serve_setup_line(sm, reqs, t0))

    total: dict[str, int] = {}
    tokens = {}
    events: dict[str, list] = {}
    lines = {}
    for mode in (Mode.BLOCKED, Mode.HBCEM, Mode.LBIM):
        tokens[mode], lines[mode] = serve_run(sm, mode, reqs,
                                              events=events.setdefault(mode.value, []))
        emit(lines[mode])
        add_launches(total, lines[mode])
    ref_toks = modes_agree(tokens, cfg.name)
    if not GRAPHS_AB:      # --graphs held every serve to its eager twin already
        with phase_clock("graphs_phase"):
            graphs_phase(sm, reqs, tokens, events, lines)

    contig_toks, line = serve_run(sm, Mode.LBIM, reqs, paged=False,
                                  events=events.setdefault("lbim contiguous", []))
    line["requests_equal_to_paged_lbim"] = sum(
        a == b for a, b in zip(tokens[Mode.LBIM], contig_toks))
    emit(line)
    add_launches(total, line)
    del sm
    sm4 = ServingModel.prepare(cfg.replace(decode_kv_splits=4), params, max_len=max_len,
                               slots=SLOTS, device=dev)
    split_toks, line = serve_run(sm4, Mode.LBIM, reqs,
                                 events=events.setdefault("lbim splits 4", []))
    line["requests_equal_to_single_pass"] = sum(a == b for a, b in zip(ref_toks, split_toks))
    emit(line)
    add_launches(total, line)
    emit({"phase": "serve_launches", "arch": cfg.name, "runs": 5, **total})
    price_serves(reqs, events)
    check_launched(total, ("pim_gemv", "decode_attention", "decode_attention_paged",
                           "decode_attention_paged_split", "merge_splits"), cfg.name)
    del sm4
    if GRAPHS_AB:      # --graphs: the serves' A/B only
        return total
    sm = ServingModel.prepare(cfg, params, max_len=max_len, slots=SLOTS, device=dev)
    profile_decode(sm, Mode.HBCEM, reqs)
    del sm
    torch.cuda.empty_cache()
    with phase_clock("spec_phase"):
        for k, v in spec_phase(dev, cfg, params).items():
            total[k] = total.get(k, 0) + v
    torch.cuda.empty_cache()
    with phase_clock("traffic_phase"):
        for k, v in traffic_phase(dev, *cut_depth(cfg, params, TRAFFIC_LAYERS)).items():
            total[k] = total.get(k, 0) + v
    return total


# depth of llama3-8b in the traffic phase, of zamba2-7b and of yi-9b in the
# dense phase: their serves are host-bound (the step's time grows with the
# layers, not with what the phases check), and at full depth the whole run
# outgrew its 700 s budget once the families phase was added (PERF.md §6).
# zamba2-7b's 45 keep its shape: 7 shared-block applications after every 6
# Mamba2 layers, then 3 layers without one, as 13 and 3 at 81
TRAFFIC_LAYERS, YI_LAYERS, ZAMBA2_LAYERS = 4, 24, 45


def cut_depth(cfg, params, n_layers: int):
    """``cfg`` and ``params`` at their first ``n_layers`` layers, or all of a
    shallower model's (the weights shared, not copied)."""
    n = min(n_layers, cfg.n_layers)
    return cfg.replace(n_layers=n), {**params, "layers": params["layers"][:n]}


def zamba2_phase(dev) -> dict:
    """zamba2-7b at full width and ``ZAMBA2_LAYERS`` of its 81 layers: ragged
    greedy requests in the three modes."""
    from repro_torch.configs import get_config
    from repro_torch.core.pim_modes import Mode
    from repro_torch.models.model import init_params
    from repro_torch.serve.serving_model import ServingModel

    cfg = get_config("zamba2-7b").replace(quantized_decode=True, n_layers=ZAMBA2_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    reqs = zamba2_requests(cfg.vocab_size)
    max_len = serve_max_len(reqs)
    sm = ServingModel.prepare(cfg, params, max_len=max_len, slots=SLOTS, device=dev)
    torch.cuda.synchronize()
    emit(serve_setup_line(sm, reqs, t0))
    total: dict[str, int] = {}
    tokens = {}
    for mode in (Mode.BLOCKED, Mode.HBCEM, Mode.LBIM):
        tokens[mode], line = serve_run(sm, mode, reqs)
        emit(line)
        add_launches(total, line)
    modes_agree(tokens, cfg.name)
    emit({"phase": "serve_launches", "arch": cfg.name, "runs": 3, **total})
    check_launched(total, ("pim_gemv", "decode_attention"), cfg.name)
    profile_decode(sm, Mode.HBCEM, reqs)
    return total


# ---------------------------------------------------------------------------
# the rest of the dense family: yi-9b, codeqwen1.5-7b, gemma2-27b
# ---------------------------------------------------------------------------

GEMMA2_MAX_LEN = 4232      # 529 8-token blocks: room for the 4,200 + 24 request
GEMMA2_CHUNK = 256         # admission chunk: the 4,200-token prompt in 17 sub-steps
GEMMA2_LONG = (4200, 24)   # the request whose local windows bind from its first decode
DENSE_GEMV = {   # distinct (N, K) of each config's seven decode GEMVs
    "yi-9b": ((4096, 4096), (512, 4096), (11008, 4096), (4096, 11008)),
    "codeqwen1.5-7b": ((4096, 4096), (13440, 4096), (4096, 13440)),
}


def gemma2_requests(vocab: int) -> list:
    """Four greedy requests: a 4,200-token prompt with 24 new tokens, so every
    local layer's 4,096-token window starts past 0 from the first decode, and
    three prompts of 32-256 tokens with 16-32 new."""
    from repro_torch.serve.api import GenerationRequest

    rng = np.random.default_rng(2)
    lens = [GEMMA2_LONG[0], *rng.integers(32, 257, size=3)]
    news = [GEMMA2_LONG[1], *rng.integers(16, 33, size=3)]
    return [GenerationRequest(prompt=rng.integers(1, vocab, size=int(n)).tolist(),
                              max_new_tokens=int(m)) for n, m in zip(lens, news)]


def window_start(end: torch.Tensor, window: int) -> torch.Tensor:
    """A local layer's live-range start, as ``attention._live_start`` gives it."""
    return (end - window).clamp_min(0).to(torch.int32)


def check_gemv_exact(shapes: dict, gen, dev) -> list:
    """B3 bit-exact at each config's (N, K) at B = SLOTS; the cases checked."""
    return [["pim_gemv", arch, n, k, SLOTS, "bit-exact", gemv_exact(n, k, SLOTS, gen, dev)]
            for arch, nks in shapes.items() for n, k in nks]


def check_paged_case(errs, what, q, kp, vp, table, end, start, scale, cap, splits) -> None:
    """B1 against its plain version and lane by lane; with ``splits``, B2's
    stage 1, the merge and the pair too. Raises outside the tolerance; keeps
    the largest |err| per kernel in ``errs``."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    out = da.decode_attention_paged(q, kp, vp, table, end, start, scale=scale, softcap=cap)
    want = ref.decode_attention_paged_ref(q, kp, vp, table, end, scale, cap, start=start)
    torch.cuda.synchronize()
    errs["decode_attention_paged"] = max(errs["decode_attention_paged"],
                                         _allclose(f"B1 {what}", out, want))
    check_batch_invariant(f"B1 {what}", lambda i: da.decode_attention_paged(
        q[i], kp, vp, table[i], end[i], start[i], scale=scale, softcap=cap), out, ATTN_B)
    if not splits:
        return
    acc, m, l = da.split_partials(q, kp, vp, table, end, start, num_splits=splits,
                                  scale=scale, softcap=cap)
    racc, rm, rl = ref.split_partials_ref(q, kp, vp, table, end, splits, scale, cap,
                                          start=start)
    merged = da.merge_splits(acc, m, l)
    torch.cuda.synchronize()
    errs["decode_attention_paged_split"] = max(
        errs["decode_attention_paged_split"], _allclose(f"B2 acc {what}", acc, racc),
        _allclose(f"B2 m {what}", m, rm), _allclose(f"B2 l {what}", l, rl))
    errs["merge_splits"] = max(errs["merge_splits"], _allclose(
        f"merge {what}", merged, ref.merge_splits(acc, m, l)))
    _allclose(f"B2 pair vs B1 {what}", merged, want)
    check_batch_invariant(f"B2 pair {what}", lambda i: da.decode_attention_paged_split(
        q[i], kp, vp, table[i], end[i], start[i], num_splits=splits, scale=scale,
        softcap=cap), da.decode_attention_paged_split(
            q, kp, vp, table, end, start, num_splits=splits, scale=scale, softcap=cap),
        ATTN_B)


def check_serve_tables(archs, splits: int, gen, dev, errs) -> list:
    """B1 (and, with ``splits``, B2) at each config's q (B, Hkv, G, hd) over the
    block tables of its serve of ``make_requests`` (8-token pages), at that
    serve's fills; the cases checked."""
    from repro_torch.configs import get_config

    cases = []
    for arch in archs:
        cfg = get_config(arch)
        reqs = make_requests(cfg.vocab_size)
        nb = -(-serve_max_len(reqs) // 8)
        q, pools, table, _, _, scale = attn_inputs(gen, dev, nb=nb, g=cfg.q_per_kv,
                                                   hd=cfg.head_dim, hkv=cfg.n_kv_heads)
        for when, fills in serve_fills(reqs).items():
            end = torch.tensor(fills, dtype=torch.int32, device=dev)
            check_paged_case(errs, f"{arch} {when}", q, *pools[0], table, end,
                             torch.zeros_like(end), scale, None, splits)
            cases.append(["B1" + (f" + B2 ({splits} splits)" if splits else ""), arch,
                          list(q.shape), nb, None, fills, "batch invariant"])
        del pools
    return cases


def check_dense_kernels(gen, dev) -> dict:
    """The kernels at the dense serves' own shapes against their plain
    versions: B3 bit-exact at yi-9b's and codeqwen's (N, K) at B 4; B1 at
    yi-9b's q (4, 4, 8, 128) and codeqwen's (4, 32, 1, 128) over their
    serves' 37-block tables; B1, B2 (4 splits: stage 1, the merge and the
    pair) at gemma2-27b's q (4, 16, 2, 128), softcap 50, scale 144^-0.5 over
    529-block tables at serve (c)'s fills, with the local layers' window
    starts and from 0 (global); B4 over serve (d)'s 4,096-slot rings (end
    ``min(fill, 4096)``) and 4,232-token global lanes, softcap 50. The
    single-pass and pair launches also lane by lane (bit-equal to the batch).
    Returns the largest |err| per kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    errs = dict.fromkeys(("pim_gemv", "decode_attention", "decode_attention_paged",
                          "decode_attention_paged_split", "merge_splits"), 0.0)
    cases = check_gemv_exact(DENSE_GEMV, gen, dev)
    cases += check_serve_tables(("yi-9b", "codeqwen1.5-7b"), 0, gen, dev, errs)

    cfg = get_config("gemma2-27b")
    reqs = gemma2_requests(cfg.vocab_size)
    hkv, g, hd, w = cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim, cfg.sliding_window
    scale, cap = cfg.attn_scale_override, cfg.attn_softcap
    nb = GEMMA2_MAX_LEN // 8
    q, pools, table, _, _, _ = attn_inputs(gen, dev, nb=nb, g=g, hd=hd, hkv=hkv)
    for when, fills in serve_fills(reqs).items():
        end = torch.tensor(fills, dtype=torch.int32, device=dev)
        for layer, start in (("local", window_start(end, w)), ("global", torch.zeros_like(end))):
            check_paged_case(errs, f"gemma2-27b {layer} {when}", q, *pools[0], table, end,
                             start, scale, cap, 4)
            cases.append(["B1 + B2 (4 splits)", "gemma2-27b", list(q.shape), nb, cap, fills,
                          start.tolist(), "batch invariant"])
    del pools
    for lmax, what in ((w, "rings"), (GEMMA2_MAX_LEN, "global lanes")):
        q, lanes, _, _, _ = contig_inputs(gen, dev, hkv, g, hd, lmax)
        k, v = lanes[0]
        for when, fills in serve_fills(reqs).items():
            end = torch.tensor([min(f, lmax) for f in fills], dtype=torch.int32, device=dev)
            start = torch.zeros_like(end)
            out = da.decode_attention(q, k, v, end, start, scale=scale, softcap=cap)
            want = ref.decode_attention_ref(q, k, v, end, scale, cap, start=start)
            torch.cuda.synchronize()
            errs["decode_attention"] = max(errs["decode_attention"], _allclose(
                f"B4 gemma2-27b {what} {when}", out, want))
            check_batch_invariant(f"B4 gemma2-27b {what} {when}", lambda i: da.decode_attention(
                q[i], k[i], v[i], end[i], start[i], scale=scale, softcap=cap), out, ATTN_B)
            cases.append(["B4", f"gemma2-27b {what}", list(q.shape), lmax, cap,
                          end.tolist(), "batch invariant"])
        del lanes
    emit({"phase": "kernel_check", "kernel": "dense family shapes", "cases": cases,
          "rtol": ATTN_RTOL, "atol": ATTN_ATOL, "max_abs_err": errs})
    return errs


def time_dense_attention(gen, dev) -> None:
    """``kernel_time`` lines at gemma2-27b's serve shapes: B1 over (c)'s
    529-block tables with the local layers' window starts, each request half
    way through its decode; B4 over (d)'s 4,096-slot rings at the same fills;
    each beside its bound, its plain version and SDPA."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    cfg = get_config("gemma2-27b")
    hkv, g, hd, w = cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim, cfg.sliding_window
    scale, cap = cfg.attn_scale_override, cfg.attn_softcap
    b = ATTN_B
    fills = serve_fills(gemma2_requests(cfg.vocab_size))["half way"]
    out_bytes = b * hkv * g * hd * 4
    nb = GEMMA2_MAX_LEN // 8
    q, pools, table, _, _, _ = attn_inputs(
        gen, dev, nb=nb, g=g, hd=hd, hkv=hkv,
        copies=copies_for((b * nb + 1) * hkv * hd * 8 * 2 * 2))
    end = torch.tensor(fills, dtype=torch.int32, device=dev)
    start = window_start(end, w)
    bnd, by = attn_bound(end, start, out_bytes, hkv=hkv, g=g, hd=hd)
    ms = cuda_ms([lambda p=p: da.decode_attention_paged(q, *p, table, end, start, scale=scale,
                                                       softcap=cap) for p in pools], 100)
    plain = cuda_ms([lambda p=p: ref.decode_attention_paged_ref(q, *p, table, end, scale, cap,
                                                               start=start)
                     for p in pools[:2]], 10)
    # SDPA takes no softcap: its time is for the uncapped function (a lower yardstick)
    lib = library_ms("decode_attention_paged", sdpa_calls(q, pools, table, end, start, scale),
                     100)
    emit({"phase": "kernel_time", "kernel": "decode_attention_paged",
          "shape": "gemma2-27b serve (c), local layer", "q": list(q.shape),
          "table_blocks": nb, "end": fills, "start": start.tolist(), "softcap": cap,
          "live_tokens": live_tokens(end, start), "ms": ms, "plain_ms": plain,
          "library_ms": lib, "library_note": "SDPA without the softcap", "bound_ms": bnd,
          "bound_by": by, "roofline_share": bnd / ms})
    del pools
    q, lanes, _, _, _ = contig_inputs(gen, dev, hkv, g, hd, w,
                                      copies=copies_for(b * hkv * hd * w * 2 * 2))
    end = torch.tensor([min(f, w) for f in fills], dtype=torch.int32, device=dev)
    start = torch.zeros_like(end)
    bnd, by = attn_bound(end, start, out_bytes, hkv=hkv, g=g, hd=hd)
    idx = torch.arange(w, device=dev)
    mask = (idx[None, :] < end[:, None])[:, None, None]
    qh = q.reshape(b, hkv * g, 1, hd)
    sdpa_lanes = [(k.transpose(-1, -2).repeat_interleave(g, dim=1).contiguous(),
                   v.repeat_interleave(g, dim=1).contiguous()) for k, v in lanes[:2]]
    ms = cuda_ms([lambda kv=kv: da.decode_attention(q, *kv, end, start, scale=scale,
                                                    softcap=cap) for kv in lanes], 100)
    emit({"phase": "kernel_time", "kernel": "decode_attention",
          "shape": "gemma2-27b serve (d), 4,096-slot rings", "q": list(q.shape), "lmax": w,
          "end": end.tolist(), "softcap": cap, "live_tokens": live_tokens(end, start),
          "ms": ms, "plain_ms": cuda_ms([lambda kv=kv: ref.decode_attention_ref(
              q, *kv, end, scale, cap, start=start) for kv in lanes[:2]], 10),
          "library_ms": library_ms("decode_attention", [
              lambda kv=kv: F.scaled_dot_product_attention(qh, *kv, attn_mask=mask,
                                                           scale=scale)
              for kv in sdpa_lanes], 100),
          "library_note": "SDPA without the softcap", "bound_ms": bnd, "bound_by": by,
          "roofline_share": bnd / ms})


class AttentionCalls:
    """Counts, while it is entered, what the serve's attention calls are given
    (the launch counters count launches; this counts their live ranges): the
    paged single-pass calls that have a lane at start > 0 and the contiguous
    calls by Lmax (one of ``lmaxes``). Both are device-side counters, added
    to by kernels of the step itself, so a captured step's replays count too
    (and no count syncs)."""

    def __init__(self, dev, lmaxes=()):
        self.dev = dev
        self.lmaxes = tuple(lmaxes)

    @property
    def contig_lmax(self) -> dict[int, int]:
        return {lmax: int(n) for lmax, n in self._contig_n.items()}

    def __enter__(self):
        from repro_torch.core import dispatch

        self._dispatch = dispatch
        self._paged, self._contig = dispatch.decode_attention_paged_op, dispatch.decode_attention_op
        self.windowed = torch.zeros((), dtype=torch.int64, device=self.dev)
        self._contig_n = {lmax: torch.zeros((), dtype=torch.int64, device=self.dev)
                          for lmax in self.lmaxes}

        def paged(*a, start=None, **kw):
            if start is not None:
                self.windowed += (start > 0).any()
            return self._paged(*a, start=start, **kw)

        def contig(q, k_cache, *a, **kw):
            self._contig_n[int(k_cache.shape[-1])] += 1
            return self._contig(q, k_cache, *a, **kw)

        dispatch.decode_attention_paged_op, dispatch.decode_attention_op = paged, contig
        return self

    def __exit__(self, *exc):
        self._dispatch.decode_attention_paged_op = self._paged
        self._dispatch.decode_attention_op = self._contig
        return False


def free_card(what: str) -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    emit({"phase": "memory", "before": what, "free_GB": free / 1e9, "total_GB": total / 1e9})


def dense_phase(dev) -> dict:
    """(a) yi-9b (W8A8, paged) in HBCEM and LBIM and (b) codeqwen1.5-7b
    (W8A8, paged) in HBCEM, each over ``make_requests``' 8 requests; then
    gemma2-27b in bf16 over ``gemma2_requests``' 4, admission chunks of 256
    tokens, HBCEM: (c) on the paged pool (8-token pages, no prefix reuse) and
    (d) on the ring pool (``windowed_kv_cache``: 4,096-slot rings for the 23
    local layers, full lanes for the 23 global ones); a profile of (c)'s
    decode. Each model's weights are freed before the next is made."""
    from repro_torch.configs import get_config
    from repro_torch.core.pim_modes import Mode
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.serving_model import ServingModel

    total: dict[str, int] = {}
    for arch, layers, modes in (("yi-9b", YI_LAYERS, (Mode.HBCEM, Mode.LBIM)),
                                ("codeqwen1.5-7b", None, (Mode.HBCEM,))):
        cfg = get_config(arch).replace(quantized_decode=True)
        if layers is not None:
            cfg = cfg.replace(n_layers=layers)
        free_card(f"{arch} init")
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        reqs = make_requests(cfg.vocab_size)
        sm = ServingModel.prepare(cfg, params, max_len=-(-serve_max_len(reqs) // 8) * 8,
                                  slots=SLOTS, device=dev)
        torch.cuda.synchronize()
        emit(serve_setup_line(sm, reqs, t0))
        for mode in modes:
            _, line = serve_run(sm, mode, reqs)
            emit(line)
            add_launches(total, line)
        del sm, params

    cfg = get_config("gemma2-27b")
    free_card("gemma2-27b init")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    reqs = gemma2_requests(cfg.vocab_size)
    tokens = {}
    for ring in (False, True):
        sm = ServingModel.prepare(cfg.replace(windowed_kv_cache=ring), params,
                                  max_len=GEMMA2_MAX_LEN, slots=SLOTS, device=dev)

        def make(sm=sm):
            return Engine(sm.cfg, sm.params, max_len=sm.max_len, slots=SLOTS,
                          mode=Mode.HBCEM, chunk=GEMMA2_CHUNK, serving=sm,
                          prefix_cache=False,
                          pool=sm.cache_pool(slots=SLOTS, prefix_cache=False, block_size=8))

        torch.cuda.synchronize()
        emit(serve_setup_line(sm, reqs, t0))
        with AttentionCalls(dev, (cfg.sliding_window, GEMMA2_MAX_LEN)) as calls:
            tokens[ring], line = serve_run(sm, Mode.HBCEM, reqs, paged=not ring,
                                           make_engine=make)
        # --graphs: the counters also saw the eager twin, a serve of the same steps
        serves = 2 if GRAPHS_AB else 1
        if ring:
            # 23 ring launches and 23 global-lane launches per one-token forward
            rings, lanes = (calls.contig_lmax[n] // serves
                            for n in (cfg.sliding_window, GEMMA2_MAX_LEN))
            if not (rings == lanes == line["launches"]["decode_attention"] // 2 > 0):
                raise AssertionError(f"gemma2-27b ring: B4 over rings {rings}, over lanes "
                                     f"{lanes}, launches {line['launches']}")
            line["b4_launches_over_rings"], line["b4_launches_over_lanes"] = rings, lanes
            line["requests_equal_to_paged"] = sum(
                a == b for a, b in zip(tokens[False], tokens[True]))
        else:
            line["b1_launches_with_start_gt_0"] = int(calls.windowed) // serves
            if not 0 < line["b1_launches_with_start_gt_0"] <= \
                    line["launches"]["decode_attention_paged"] // 2:
                raise AssertionError(f"gemma2-27b paged: {line['b1_launches_with_start_gt_0']}"
                                     f" B1 launches with start > 0 of {line['launches']}")
        emit(line)
        add_launches(total, line)
        if not ring:
            profile_decode(sm, Mode.HBCEM, reqs)
        del sm
        free_card(f"gemma2-27b {'end' if ring else 'ring pool'}")
        t0 = time.perf_counter()
    del params
    emit({"phase": "serve_launches", "what": "dense family (yi-9b, codeqwen1.5-7b, "
          "gemma2-27b paged and ring)", "runs": 5, **total})
    check_launched(total, ("pim_gemv", "decode_attention", "decode_attention_paged"),
                   "dense family")
    return total


# ---------------------------------------------------------------------------
# the MoE family: olmoe-1b-7b, phi3.5-moe
# ---------------------------------------------------------------------------

OLMOE, PHI35 = "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"
# phi3.5-moe runs 16 of its 32 layers: all 32 in bf16 are 83.7 GB of weights
# against the 85.0 GB the card reports, before the CUDA context, the int8
# images and the KV
PHI35_LAYERS = 16
MOE_SPLITS = 4
# admission chunk of the serves without prefix reuse (over 8-token pages): a
# 64-token chunk has olmoe's capacity 10 (top-8 of 64 experts, factor 1.25)
# and phi3.5's 10 (top-2 of 16), so its picks can drop; the prefix-reuse
# serve keeps the engine's chunk of 8, its page size
MOE_CHUNK = 64
MOE_GEMV = {   # distinct (N, K) of each config's four decode GEMVs (q/k/v/o)
    OLMOE: ((2048, 2048),),
    PHI35: ((4096, 4096), (1024, 4096)),
}


def check_moe_kernels(gen, dev) -> dict:
    """The kernels at the MoE serves' own shapes against their plain
    versions: B3 bit-exact at olmoe's (2048, 2048) and phi3.5's (4096, 4096)
    and (1024, 4096) at B 4; B1 and B2 (4 splits: stage 1, the merge and the
    pair) at olmoe's q (4, 16, 1, 128) and phi3.5's (4, 8, 4, 128) over their
    serves' 37-block tables at the serves' fills, also lane by lane. Returns
    the largest |err| per kernel."""
    errs = dict.fromkeys(("pim_gemv", "decode_attention", "decode_attention_paged",
                          "decode_attention_paged_split", "merge_splits"), 0.0)
    cases = check_gemv_exact(MOE_GEMV, gen, dev)
    cases += check_serve_tables((OLMOE, PHI35), MOE_SPLITS, gen, dev, errs)
    emit({"phase": "kernel_check", "kernel": "MoE family shapes", "cases": cases,
          "rtol": ATTN_RTOL, "atol": ATTN_ATOL, "max_abs_err": errs})
    return errs


def time_moe_kernels(gen, dev) -> None:
    """``kernel_time`` lines at the MoE serves' shapes: B1 over each serve's
    37-block tables with its first four requests half way through their
    decode, beside its bound, its plain version and SDPA, and at olmoe's
    shape the B2 pair at 4 splits (stage 1 + merge, what its 4-split serve
    launches) against the same bound and SDPA; B3 at each (N, K) at B 4
    (``time_gemv_shapes``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    for arch in (OLMOE, PHI35):
        cfg = get_config(arch)
        hkv, g, hd, b = cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim, ATTN_B
        reqs = make_requests(cfg.vocab_size)
        nb = -(-serve_max_len(reqs) // 8)
        fills = serve_fills(reqs)["half way"]
        q, pools, table, _, _, scale = attn_inputs(
            gen, dev, nb=nb, g=g, hd=hd, hkv=hkv,
            copies=copies_for((b * nb + 1) * hkv * hd * 8 * 2 * 2))
        end = torch.tensor(fills, dtype=torch.int32, device=dev)
        start = torch.zeros_like(end)
        bnd, by = attn_bound(end, start, b * hkv * g * hd * 4, hkv=hkv, g=g, hd=hd)
        sdpa = library_ms("decode_attention_paged",
                          sdpa_calls(q, pools, table, end, start, scale), 100)
        ms = cuda_ms([lambda p=p: da.decode_attention_paged(q, *p, table, end, start,
                                                           scale=scale) for p in pools], 100)
        emit({"phase": "kernel_time", "kernel": "decode_attention_paged",
              "shape": f"{arch} serve", "q": list(q.shape), "table_blocks": nb, "end": fills,
              "live_tokens": live_tokens(end, start), "ms": ms,
              "plain_ms": cuda_ms([lambda p=p: ref.decode_attention_paged_ref(
                  q, *p, table, end, scale, start=start) for p in pools[:2]], 10),
              "library_ms": sdpa, "bound_ms": bnd, "bound_by": by, "roofline_share": bnd / ms})
        if arch == OLMOE:
            ms = cuda_ms([lambda p=p: da.decode_attention_paged_split(
                q, *p, table, end, start, num_splits=MOE_SPLITS, scale=scale)
                for p in pools], 100)
            emit({"phase": "kernel_time", "kernel": "decode_attention_paged_split + "
                  "merge_splits", "shape": f"{arch} serve", "splits": MOE_SPLITS,
                  "q": list(q.shape), "table_blocks": nb, "end": fills,
                  "live_tokens": live_tokens(end, start), "ms": ms,
                  "plain_ms": cuda_ms([lambda p=p: ref.decode_attention_paged_split_ref(
                      q, *p, table, end, MOE_SPLITS, scale, start=start)
                      for p in pools[:2]], 10),
                  "library_ms": sdpa, "bound_ms": bnd, "bound_by": by,
                  "roofline_share": bnd / ms})
        del pools
    time_gemv_shapes(MOE_GEMV, gen, dev)


class MoeRoute:
    """While entered, keeps each layer's MoE input of the serve's first
    admission chunk (one forward of B 1, T > 1) and of its first decode step
    (B = SLOTS lanes, free lanes included); :meth:`line` then runs the port's
    router and keep rule on them and counts the picks kept and dropped."""

    def __enter__(self):
        from repro_torch.models import moe

        self._moe, self._einsum = moe, moe.moe_einsum
        self.chunk, self.decode = [], []

        def record(p, x, cfg):
            b, t = x.shape[0], x.shape[1]
            if b == 1 and t > 1 and len(self.chunk) < cfg.n_layers:
                self.chunk.append((p, x.detach().clone()))
            elif t == 1 and b == SLOTS and len(self.decode) < cfg.n_layers:
                self.decode.append((p, x.detach().clone()))
            return self._einsum(p, x, cfg)

        moe.moe_einsum = record
        return self

    def __exit__(self, *exc):
        self._moe.moe_einsum = self._einsum
        return False

    def line(self, cfg, mode) -> dict:
        moe = self._moe
        out = {"phase": "moe_route", "arch": cfg.name, "mode": mode.value,
               "capacity_factor": cfg.moe_capacity_factor, "top_k": cfg.top_k,
               "n_experts": cfg.n_experts}
        for what, calls in (("chunk", self.chunk), ("decode", self.decode)):
            if len(calls) != cfg.n_layers:
                raise AssertionError(f"moe_route: {len(calls)} {what} layers recorded")
            kept, dropped = [], []
            for p, x in calls:
                x2d = x.reshape(-1, x.shape[-1])
                n_groups, sg, cap = moe.capacity(x2d.shape[0], cfg)
                _, idx, _ = moe._router(p, x2d, cfg)
                _, keep = moe.keep_rule(idx.reshape(n_groups, sg, cfg.top_k),
                                        cfg.n_experts, cap)
                kept.append(int(keep.sum()))
                dropped.append(int((~keep).sum()))
            out[what] = {"tokens": int(calls[0][1].shape[0] * calls[0][1].shape[1]),
                         "capacity": cap, "kept_per_layer": kept,
                         "dropped_per_layer": dropped, "dropped_total": sum(dropped)}
        self.chunk, self.decode = [], []    # the layers' params go with the model
        return out


def moe_phase(dev) -> dict:
    """(a) olmoe-1b-7b at full width and depth (W8A8, paged 8-token pages, no
    prefix reuse, 64-token admission chunks) over ``make_requests``' 8
    requests in BLOCKED, HBCEM and LBIM, in HBCEM at 4 KV splits, and in
    HBCEM once more with prefix reuse (8-token chunks); the HBCEM serve's
    ``moe_route`` line; a profile of its decode. (b) phi3.5-moe at full width
    and 16 of its 32 layers (W8A8, paged, 64-token chunks) in HBCEM and LBIM.
    Tokens are not held equal across modes: a mode's admission quantum sets
    how many tokens share a chunk's forward, and with it which picks drop, in
    the JAX engine as here; the lines count the requests that agree. Each
    model's weights are freed before the next is made."""
    from contextlib import nullcontext

    from repro_torch.configs import get_config
    from repro_torch.core.pim_modes import Mode
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.serving_model import ServingModel

    total: dict[str, int] = {}

    def serve(sm, mode, reqs, prefix_cache=False):
        def make():
            if prefix_cache:
                return sm.engine(mode=mode, slots=SLOTS)
            return Engine(sm.cfg, sm.params, max_len=sm.max_len, slots=SLOTS, mode=mode,
                          chunk=MOE_CHUNK, serving=sm, prefix_cache=False,
                          pool=sm.cache_pool(slots=SLOTS, prefix_cache=False, block_size=8))

        toks, line = serve_run(sm, mode, reqs, make_engine=make)
        line["prefix_cache"] = prefix_cache
        add_launches(total, line)
        return toks, line

    for arch, layers, modes in ((OLMOE, None, (Mode.BLOCKED, Mode.HBCEM, Mode.LBIM)),
                                (PHI35, PHI35_LAYERS, (Mode.HBCEM, Mode.LBIM))):
        cfg = get_config(arch).replace(quantized_decode=True)
        if layers is not None:
            cfg = cfg.replace(n_layers=layers)
        free_card(f"{arch} init")
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        reqs = make_requests(cfg.vocab_size)
        max_len = -(-serve_max_len(reqs) // 8) * 8
        sm = ServingModel.prepare(cfg, params, max_len=max_len, slots=SLOTS, device=dev)
        torch.cuda.synchronize()
        emit(serve_setup_line(sm, reqs, t0))
        tokens = {}
        for mode in modes:
            route = MoeRoute() if mode is Mode.HBCEM else nullcontext()
            with route:
                tokens[mode], line = serve(sm, mode, reqs)
            line["requests_equal_to_first_mode"] = sum(
                a == b for a, b in zip(tokens[modes[0]], tokens[mode]))
            emit(line)
            if mode is Mode.HBCEM:
                emit(route.line(cfg, mode))
        if arch == OLMOE:
            sm_split = ServingModel.prepare(cfg.replace(decode_kv_splits=MOE_SPLITS), params,
                                            max_len=max_len, slots=SLOTS, device=dev)
            toks, line = serve(sm_split, Mode.HBCEM, reqs)
            line["requests_equal_to_single_pass"] = sum(
                a == b for a, b in zip(tokens[Mode.HBCEM], toks))
            emit(line)
            del sm_split
            toks, line = serve(sm, Mode.HBCEM, reqs, prefix_cache=True)
            line["requests_equal_to_no_reuse"] = sum(
                a == b for a, b in zip(tokens[Mode.HBCEM], toks))
            emit(line)
            profile_decode(sm, Mode.HBCEM, reqs)
        del sm, params
    free_card("MoE end")
    emit({"phase": "serve_launches", "what": f"MoE family ({OLMOE} full depth, {PHI35} "
          f"{PHI35_LAYERS} layers)", "runs": 7, **total})
    check_launched(total, ("pim_gemv", "decode_attention_paged",
                           "decode_attention_paged_split", "merge_splits"), "MoE family")
    return total


# ---------------------------------------------------------------------------
# the last serving families: rwkv6-1.6b, internvl2-2b, seamless-m4t-large-v2
# ---------------------------------------------------------------------------

RWKV6, INTERNVL2, SEAMLESS = "rwkv6-1.6b", "internvl2-2b", "seamless-m4t-large-v2"
FAMILY_SPLITS = 4
# internvl2-2b's model-level run: an image-prefix prefill of 4 lanes (256 stub
# patch embeddings, N(0, 0.02), before prompts of 24-64 tokens), then greedy steps
VLM_LANES, VLM_PROMPTS, VLM_STEPS = 4, (24, 64), 16
# seamless-m4t-large-v2's: an encoder pass over 500 stub frames a lane (about
# 10 s of speech at a 20 ms frame stride) and one BOS token, then greedy steps
AUDIO_LANES, AUDIO_FRAMES, AUDIO_STEPS, AUDIO_BOS = 4, 500, 32, 1
FAMILY_GEMV = {   # distinct (N, K) of each W8A8 config's seven decode GEMVs
    INTERNVL2: ((2048, 2048), (1024, 2048), (8192, 2048), (2048, 8192)),
    SEAMLESS: ((1024, 1024), (8192, 1024), (1024, 8192)),
}


def round8(n: int) -> int:
    return -(-n // 8) * 8


def vlm_prompt_lens() -> list[int]:
    return np.random.default_rng(3).integers(VLM_PROMPTS[0], VLM_PROMPTS[1] + 1,
                                             size=VLM_LANES).tolist()


def vlm_lmax(cfg) -> int:
    """Lanes of the image-prefix run: prefix + the longest prompt + the steps."""
    return round8(cfg.n_prefix_tokens + max(vlm_prompt_lens()) + VLM_STEPS)


def audio_lmax() -> int:
    return round8(1 + AUDIO_STEPS)


def family_fills(cfg) -> dict[str, list[int]]:
    """Each lane's fill (``end``) at the first and the last decode step of the
    model-level run of ``cfg`` (internvl2-2b or seamless-m4t-large-v2)."""
    if cfg.family == "vlm":
        base = [cfg.n_prefix_tokens + n for n in vlm_prompt_lens()]
        steps = VLM_STEPS
    else:
        base, steps = [1] * AUDIO_LANES, AUDIO_STEPS
    return {"first step": [b + 1 for b in base], "half way": [b + steps // 2 for b in base],
            "last step": [b + steps for b in base]}


def family_b4_shapes():
    """(what, Hkv, G, hd, Lmax, fills) of the model-level runs' B4 launches."""
    from repro_torch.configs import get_config

    out = []
    for arch, lmax in ((INTERNVL2, vlm_lmax(get_config(INTERNVL2))), (SEAMLESS, audio_lmax())):
        cfg = get_config(arch)
        out.append((arch, cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim, lmax, family_fills(cfg)))
    return out


def check_family_kernels(gen, dev) -> dict:
    """The kernels at this phase's own shapes against their plain versions: B3
    bit-exact at internvl2-2b's and seamless's (N, K) at B 4; B1 and B2 (4
    splits: stage 1, the merge and the pair) at internvl2-2b's q (4, 8, 2, 128)
    over its serve's 37-block tables at the serve's fills; B4 over the
    image-prefix lanes (G 2 / hd 128) and seamless's self-KV lanes (G 1 /
    hd 64) at their first and last steps' fills. The single-pass and pair
    launches lane by lane too. Returns the largest |err| per kernel."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    errs = dict.fromkeys(("pim_gemv", "decode_attention", "decode_attention_paged",
                          "decode_attention_paged_split", "merge_splits"), 0.0)
    cases = check_gemv_exact(FAMILY_GEMV, gen, dev)
    cases += check_serve_tables((INTERNVL2,), FAMILY_SPLITS, gen, dev, errs)
    for arch, hkv, g, hd, lmax, fills in family_b4_shapes():
        q, lanes, _, _, scale = contig_inputs(gen, dev, hkv, g, hd, lmax)
        k, v = lanes[0]
        for when in ("first step", "last step"):
            end = torch.tensor(fills[when], dtype=torch.int32, device=dev)
            start = torch.zeros_like(end)
            out = da.decode_attention(q, k, v, end, start, scale=scale)
            want = ref.decode_attention_ref(q, k, v, end, scale, start=start)
            torch.cuda.synchronize()
            errs["decode_attention"] = max(errs["decode_attention"], _allclose(
                f"B4 {arch} {when}", out, want))
            check_batch_invariant(f"B4 {arch} {when}", lambda i: da.decode_attention(
                q[i], k[i], v[i], end[i], start[i], scale=scale), out, ATTN_B)
            cases.append(["B4", arch, list(q.shape), lmax, None, fills[when],
                          "batch invariant"])
        del lanes
    emit({"phase": "kernel_check", "kernel": "rwkv6 / vlm / audio family shapes",
          "cases": cases, "rtol": ATTN_RTOL, "atol": ATTN_ATOL, "max_abs_err": errs})
    return errs


def time_gemv_shapes(shapes: dict, gen, dev, batches=(SLOTS,)) -> None:
    """B3 at each config's (N, K) at each of ``batches``, beside its bound, its
    plain version and ``torch._int_mm`` (which takes at least 17 rows: x is
    padded to 32)."""
    from repro_torch.kernels.pim_gemv.pim_gemv import pim_gemv
    from repro_torch.kernels.pim_gemv.ref import pim_gemv_ref

    for arch, nks in shapes.items():
        for n, k in nks:
            sets = [gemv_inputs(n, k, max(batches), gen, dev) for _ in range(copies_for(n * k))]
            xpad = [torch.zeros((32, k), dtype=torch.int8, device=dev) for _ in sets]
            for b in batches:
                for xp, st in zip(xpad, sets):
                    xp[:b] = st[1][:b]
                bsets = [(w, x[:b], ws, xs[:b]) for w, x, ws, xs in sets]
                ms = cuda_ms([lambda st=st: pim_gemv(*st) for st in bsets], 60)
                lib = library_ms("pim_gemv", [lambda xp=xp, st=st: torch._int_mm(xp, st[0].t())
                                              for xp, st in zip(xpad, bsets)], 60)
                bnd, by = gemv_bound(n, k, b)
                emit({"phase": "kernel_time", "kernel": "pim_gemv", "shape": f"{arch} serve",
                      "n": n, "k": k, "b": b, "path": gemv_path(n, k, b), "ms": ms,
                      "plain_ms": cuda_ms([lambda st=st: pim_gemv_ref(*st)
                                           for st in bsets[:2]], 6),
                      "library_ms": lib, "bound_ms": bnd, "bound_by": by,
                      "roofline_share": bnd / ms})
            del sets, xpad


def time_family_kernels(gen, dev) -> None:
    """``kernel_time`` lines at this phase's shapes: B1 over internvl2-2b's
    serve tables (its first four requests half way through their decode); B4
    over the image-prefix lanes and seamless's self-KV lanes half way through
    their model-level decode; each beside its bound, its plain version and
    SDPA; and B3 at every (N, K) (``time_gemv_shapes``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    b = ATTN_B
    cfg = get_config(INTERNVL2)
    hkv, g, hd = cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
    reqs = make_requests(cfg.vocab_size)
    nb = -(-serve_max_len(reqs) // 8)
    fills = serve_fills(reqs)["half way"]
    q, pools, table, _, _, scale = attn_inputs(
        gen, dev, nb=nb, g=g, hd=hd, hkv=hkv, copies=copies_for((b * nb + 1) * hkv * hd * 32))
    end = torch.tensor(fills, dtype=torch.int32, device=dev)
    start = torch.zeros_like(end)
    bnd, by = attn_bound(end, start, b * hkv * g * hd * 4, hkv=hkv, g=g, hd=hd)
    ms = cuda_ms([lambda p=p: da.decode_attention_paged(q, *p, table, end, start,
                                                       scale=scale) for p in pools], 100)
    emit({"phase": "kernel_time", "kernel": "decode_attention_paged",
          "shape": f"{INTERNVL2} serve", "q": list(q.shape), "table_blocks": nb, "end": fills,
          "live_tokens": live_tokens(end, start), "ms": ms,
          "plain_ms": cuda_ms([lambda p=p: ref.decode_attention_paged_ref(
              q, *p, table, end, scale, start=start) for p in pools[:2]], 10),
          "library_ms": library_ms("decode_attention_paged",
                                   sdpa_calls(q, pools, table, end, start, scale), 100),
          "bound_ms": bnd, "bound_by": by, "roofline_share": bnd / ms})
    del pools
    for arch, hkv, g, hd, lmax, ffills in family_b4_shapes():
        q, lanes, _, _, scale = contig_inputs(gen, dev, hkv, g, hd, lmax,
                                              copies=copies_for(b * hkv * hd * lmax * 4))
        end = torch.tensor(ffills["half way"], dtype=torch.int32, device=dev)
        start = torch.zeros_like(end)
        bnd, by = attn_bound(end, start, b * hkv * g * hd * 4, hkv=hkv, g=g, hd=hd)
        idx = torch.arange(lmax, device=dev)
        mask = (idx[None, :] < end[:, None])[:, None, None]
        qh = q.reshape(b, hkv * g, 1, hd)
        sdpa_lanes = [(k.transpose(-1, -2).repeat_interleave(g, dim=1).contiguous(),
                       v.repeat_interleave(g, dim=1).contiguous()) for k, v in lanes[:2]]
        ms = cuda_ms([lambda kv=kv: da.decode_attention(q, *kv, end, start, scale=scale)
                      for kv in lanes], 100)
        emit({"phase": "kernel_time", "kernel": "decode_attention",
              "shape": f"{arch} model-level decode", "q": list(q.shape), "lmax": lmax,
              "end": end.tolist(), "live_tokens": live_tokens(end, start), "ms": ms,
              "plain_ms": cuda_ms([lambda kv=kv: ref.decode_attention_ref(
                  q, *kv, end, scale, start=start) for kv in lanes[:2]], 10),
              "library_ms": library_ms("decode_attention", [
                  lambda kv=kv: F.scaled_dot_product_attention(qh, *kv, attn_mask=mask,
                                                               scale=scale)
                  for kv in sdpa_lanes], 100),
              "bound_ms": bnd, "bound_by": by, "roofline_share": bnd / ms})
        del lanes, sdpa_lanes
    time_gemv_shapes(FAMILY_GEMV, gen, dev)


def model_decode(sm, logits, cache, steps: int, what: str, cache_bytes: int, t_prefill: float,
                 total: dict) -> dict:
    """``steps`` greedy ``decode_step``s of ``sm``'s decode tree from a
    prefilled contiguous cache, each timed to its tokens on the host (the
    engine's step ends the same way). Launch counts are set to 0 just before
    and read just after: per step, every decoder layer's B4 and its 7 B3
    GEMVs, nothing else. Logits must stay finite, of shape (B, 1, V)."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import model as M

    cfg = sm.cfg
    b = logits.shape[0]
    tok = logits.argmax(-1)
    torch.cuda.synchronize()
    reset_launches()
    step_ms, out = [], [tok.cpu()]
    t0 = time.perf_counter()
    for _ in range(steps):
        ts = time.perf_counter()
        logits, cache = M.decode_step(sm.decode_params, cache, tok, cfg)
        tok = logits.argmax(-1)
        out.append(tok.cpu())               # the step's tokens on the host
        step_ms.append(1e3 * (time.perf_counter() - ts))
        if tuple(logits.shape) != (b, 1, cfg.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{cfg.name} {what}: logits {tuple(logits.shape)} "
                                 f"not finite or not (B, 1, V)")
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n = attention_layers(cfg) * steps
    want = {k: 0 for k in counts}
    want["decode_attention"] = n
    want["pim_gemv"] = decode_gemvs(cfg) * n if cfg.quantized_decode else 0
    if counts != want:
        raise AssertionError(f"{cfg.name} {what}: launches {counts}, {steps} steps imply "
                             f"{want}")
    add_launches(total, {"launches": counts})
    wbytes = decode_weight_bytes(sm)
    toks = torch.cat(out, dim=1)
    return {"phase": "family_decode", "arch": cfg.name, "what": what, "lanes": b,
            "steps": steps, "prefill_s": t_prefill, "wall_s": wall,
            "tokens_per_s": b * steps / wall,
            "decode_step_ms_median": statistics.median(step_ms),
            "decode_weight_GB": wbytes / 1e9, "cache_read_GB": cache_bytes / 1e9,
            "decode_step_bound_ms": 1e3 * (wbytes + cache_bytes) / HBM_BYTES_PER_S,
            "distinct_tokens": int(toks.unique().numel()), "first_lane_tokens": toks[0].tolist(),
            "gpu_mem_GB": torch.cuda.memory_allocated() / 1e9, "launches": counts}


def families_phase(dev) -> dict:
    """(a) rwkv6-1.6b at full width and depth (bf16; W8A8 is off for the
    ``ssm`` family, as in the JAX package) over ``make_requests``' 8 requests
    in BLOCKED, HBCEM and LBIM on its contiguous recurrent-state pool: tokens
    equal across modes, zero launches of every kernel (attention-free, plain
    matmuls), a profile. (b) internvl2-2b (W8A8, paged 8-token pages) over the
    same 8 requests in HBCEM and LBIM and in HBCEM at 4 KV splits (served
    requests carry no image, as in the JAX engine), a profile; then the
    model-level image-prefix ``prefill`` of 4 lanes (256 patch embeddings and
    prompts of 24-64 tokens) and 16 greedy steps over its contiguous lanes
    (B4 at G 2 / hd 128). (c) seamless-m4t-large-v2 (W8A8 decoder; encoder and
    cross attention float) at model level: ``prefill`` of 4 lanes over 500
    frames and one BOS token, then 32 greedy steps (B4 at G 1 / hd 64 over
    the self-KV lanes, B3 at its three shapes). Each model is freed before
    the next is made."""
    from repro_torch.configs import get_config
    from repro_torch.core.pim_modes import Mode
    from repro_torch.models import model as M
    from repro_torch.models.model import init_params
    from repro_torch.serve.serving_model import ServingModel

    total: dict[str, int] = {}
    # (a) rwkv6-1.6b
    cfg = get_config(RWKV6)
    free_card(f"{RWKV6} init")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    reqs = make_requests(cfg.vocab_size)
    sm = ServingModel.prepare(cfg, params, max_len=serve_max_len(reqs), slots=SLOTS,
                              device=dev)
    torch.cuda.synchronize()
    if sm.prequantized:
        raise AssertionError("rwkv6 must not be pre-quantized")
    emit(serve_setup_line(sm, reqs, t0))
    tokens = {}
    for mode in (Mode.BLOCKED, Mode.HBCEM, Mode.LBIM):
        tokens[mode], line = serve_run(sm, mode, reqs)
        emit(line)
        add_launches(total, line)
    modes_agree(tokens, cfg.name)
    profile_decode(sm, Mode.HBCEM, reqs)
    del sm, params

    # (b) internvl2-2b
    cfg = get_config(INTERNVL2).replace(quantized_decode=True)
    free_card(f"{INTERNVL2} init")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    reqs = make_requests(cfg.vocab_size)
    max_len = round8(serve_max_len(reqs))
    sm = ServingModel.prepare(cfg, params, max_len=max_len, slots=SLOTS, device=dev)
    torch.cuda.synchronize()
    emit(serve_setup_line(sm, reqs, t0))
    tokens = {}
    for mode in (Mode.HBCEM, Mode.LBIM):
        tokens[mode], line = serve_run(sm, mode, reqs)
        line["requests_equal_to_hbcem"] = sum(
            a == b for a, b in zip(tokens[Mode.HBCEM], tokens[mode]))
        emit(line)
        add_launches(total, line)
    sm4 = ServingModel.prepare(cfg.replace(decode_kv_splits=FAMILY_SPLITS), params,
                               max_len=max_len, slots=SLOTS, device=dev)
    toks, line = serve_run(sm4, Mode.HBCEM, reqs)
    line["requests_equal_to_single_pass"] = sum(
        a == b for a, b in zip(tokens[Mode.HBCEM], toks))
    emit(line)
    add_launches(total, line)
    del sm4
    profile_decode(sm, Mode.HBCEM, reqs)
    lens = vlm_prompt_lens()
    lmax = vlm_lmax(cfg)
    gen = torch.Generator(device=dev).manual_seed(7)
    prefix = (torch.randn((VLM_LANES, cfg.n_prefix_tokens, cfg.d_model), generator=gen,
                          device=dev) * 0.02).to(torch.bfloat16)
    toks = torch.randint(1, cfg.vocab_size, (VLM_LANES, max(lens)), generator=gen, device=dev)
    for i, n in enumerate(lens):
        toks[i, n:] = 0                      # right-padded, as the engine pads a group
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = M.prefill(sm.params, toks, cfg, lmax, seq_lens=seq_lens,
                              prefix_embeds=prefix)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    cache["pos"] = seq_lens + cfg.n_prefix_tokens    # each lane decodes from its own end
    last = family_fills(cfg)["last step"]
    kv_bytes = sum(last) * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    line = model_decode(sm, logits, cache, VLM_STEPS, f"image-prefix prefill "
                        f"({cfg.n_prefix_tokens} patch embeddings, prompts {lens}), "
                        f"contiguous lanes of {lmax}", kv_bytes, t_prefill, total)
    line["n_prefix_tokens"], line["prompt_lens"] = cfg.n_prefix_tokens, lens
    emit(line)
    del sm, params, cache, prefix

    # (c) seamless-m4t-large-v2
    cfg = get_config(SEAMLESS).replace(quantized_decode=True)
    free_card(f"{SEAMLESS} init")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    lmax = audio_lmax()
    sm = ServingModel.prepare(cfg, params, max_len=lmax, slots=AUDIO_LANES, device=dev)
    torch.cuda.synchronize()
    emit({"phase": "serve_setup", "arch": cfg.name, "n_layers": cfg.n_layers,
          "n_encoder_layers": cfg.n_encoder_layers, "d_model": cfg.d_model,
          "dtype": cfg.dtype, "quantized_decode": cfg.quantized_decode, "max_len": lmax,
          "lanes": AUDIO_LANES, "src_frames": AUDIO_FRAMES,
          "setup_s": time.perf_counter() - t0,
          "gpu_mem_GB": torch.cuda.memory_allocated() / 1e9,
          "free_GB": torch.cuda.mem_get_info()[0] / 1e9})
    gen = torch.Generator(device=dev).manual_seed(8)
    frames = torch.randn((AUDIO_LANES, AUDIO_FRAMES, cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)
    bos = torch.full((AUDIO_LANES, 1), AUDIO_BOS, dtype=torch.long, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = M.prefill(sm.params, bos, cfg, lmax, src_frames=frames)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    cache["pos"] = torch.ones((AUDIO_LANES,), dtype=torch.int32, device=dev)
    memory_bytes = cache["cross_k"].numel() * cache["cross_k"].element_size() * 2
    line = model_decode(sm, logits, cache, AUDIO_STEPS,
                        f"encoder over {AUDIO_FRAMES} frames, one BOS token, self-KV lanes "
                        f"of {lmax}", memory_bytes, t_prefill, total)
    line["src_frames"] = AUDIO_FRAMES
    emit(line)
    del sm, params, cache, frames
    free_card("families end")
    emit({"phase": "serve_launches", "what": f"rwkv6 / vlm / audio families ({RWKV6} 3 "
          f"serves, {INTERNVL2} 3 serves and a model-level decode, {SEAMLESS} a "
          f"model-level decode)", "runs": 8, **total})
    check_launched(total, ("pim_gemv", "decode_attention", "decode_attention_paged",
                           "decode_attention_paged_split", "merge_splits"), "families")
    return total


SPEC_K = 3
SPEC_SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
# accepted over proposed draft tokens on the greedy lanes, summed: every sound
# run read 26/32 (0.81; a bf16 draft rounds otherwise than verify). A fault on
# the draft path (a wrong kernel branch, a stale anchor, an off-by-one
# catch-up) leaves the tokens equal and only cuts acceptance.
SPEC_GREEDY_ACCEPT_FLOOR = 0.7


def spec_requests(vocab: int) -> list:
    """Four requests, prompts of 32-96 tokens and 16-24 new tokens; requests 1
    and 3 sample (fixed seeds), 0 and 2 are greedy, so greedy and sampled
    lanes share every batch."""
    from repro_torch.serve.api import GenerationRequest, SamplingParams

    rng = np.random.default_rng(2)
    lens = rng.integers(32, 97, size=SLOTS)
    budgets = rng.integers(16, 25, size=SLOTS)
    out = []
    for i in range(SLOTS):
        sp = SamplingParams(**SPEC_SAMPLED, seed=100 + i) if i % 2 else SamplingParams()
        out.append(GenerationRequest(prompt=rng.integers(1, vocab, size=int(lens[i])).tolist(),
                                     max_new_tokens=int(budgets[i]), sampling=sp))
    return out


def spec_table_blocks(reqs) -> int:
    """Block-table width of the spec serve's paged pool (8-token pages)."""
    return -(-(serve_max_len(reqs) + SPEC_K) // 8)


def spec_draft_lmax(reqs) -> int:
    """Lane length of the spec serve's contiguous draft pool."""
    return serve_max_len(reqs) + SPEC_K + 1


def spec_serve(sm, mode, reqs, spec: bool, events: list | None = None, *,
               eager_rollout: bool = False, rounds: list | None = None) -> tuple[list, dict]:
    """One serve of ``reqs`` with or without self-draft speculation; launch
    counts of this serve alone held to what its schedule events imply; both
    pools audited. ``events``, where given, receives the serve's events;
    ``rounds`` each rollout's (slot, drafts). A captured spec serve's draft
    feeds replay the engine's graphs: their keys (one per catch-up length,
    the chained feed sharing length 1's) must stay at most the distinct
    catch-up lengths and 1, and more feeds must run than there are keys.
    ``eager_rollout`` runs the draft's feeds op by op instead (the twin of
    ``--spec``: the draft decoder without the engine's graphs)."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.serve.api import RequestState
    from repro_torch.serve.spec import SpecConfig

    eng = sm.engine(mode=mode, slots=SLOTS,
                    spec=SpecConfig(draft=sm, k=SPEC_K) if spec else None)
    if eager_rollout:
        eng.spec_dec.graphs = None
    if rounds is not None:
        rollout = eng.spec_dec.rollout

        def recorded(si, k, cfg):
            drafts = rollout(si, k, cfg)
            rounds.append((si, drafts))
            return drafts

        eng.spec_dec.rollout = recorded
    if spec and (eng.pool.table_blocks != spec_table_blocks(reqs)
                 or eng.spec_dec.pool.max_len != spec_draft_lmax(reqs)):
        raise AssertionError(
            f"spec pools ({eng.pool.table_blocks} blocks, draft Lmax "
            f"{eng.spec_dec.pool.max_len}) are not the shapes kernel_check held "
            f"({spec_table_blocks(reqs)}, {spec_draft_lmax(reqs)})")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    for i, r in enumerate(results):
        if r.state is not RequestState.FINISHED or len(r.tokens) != reqs[i].max_new_tokens:
            raise AssertionError(f"spec={spec} request {i}: {r.state} {r.finish_reason} "
                                 f"{len(r.tokens)} tokens {r.error}")
    pools = [eng.pool] + ([eng.spec_dec.pool] if spec else [])
    for pool in pools:
        bad = pool.check_invariants()
        if bad or pool.occupancy().slots_used:
            raise AssertionError(f"spec={spec} {mode.value}: pool invariants {bad}, "
                                 f"{pool.occupancy().slots_used} lanes left")
    want = expected_launches(eng, sm.cfg)
    if counts != want:
        raise AssertionError(f"spec={spec} {mode.value}: launches {counts}, the schedule "
                             f"implies {want}")
    rep = eng.schedule_report()
    decode = [e.step_s for e in eng.events if e.plan.decode and not e.plan.prefill_chunk]
    spec_rounds = [e.step_s for e in eng.events if e.plan.spec]
    ntok = sum(len(r.tokens) for r in results)
    line = {"phase": "spec_serve", "arch": sm.cfg.name, "mode": mode.value,
            "spec_k": SPEC_K if spec else 0, "requests": len(reqs), "tokens": ntok,
            "wall_s": wall, "tokens_per_s": ntok / wall,
            "decode_step_ms_median": 1e3 * statistics.median(decode),
            "round_ms_median": (1e3 * statistics.median(spec_rounds) if spec_rounds
                                else None),
            "pure_decode_steps": len(decode), "steps": rep["steps"],
            "spec": rep["spec"], "rollouts": sum(e.spec_rollouts for e in eng.events),
            "single_token_catchups": sum(e.spec_catchup_decodes for e in eng.events),
            "accepted_by_request": [r.spec_accepted for r in results],
            "proposed_by_request": [r.spec_proposed for r in results],
            "launches": counts, **graph_stats(eng)}
    check_captured(eng, f"spec {sm.cfg.name} {mode.value}")
    if spec:
        sd = eng.spec_dec
        line["draft_feeds"] = line["rollouts"] + rep["spec"]["draft_steps"]
        line["draft_graph_keys"] = sd.graph_keys()
        line["catchup_lengths"] = sorted(sd.catchup_lengths)
        line["eager_rollout"] = eager_rollout
        line["draft_lane_MB"] = sum(t.nbytes for t in sd._work.values()) / 1e6
        line["draft_anchors"] = len(sd._anchors)
        if line["captured"] and not eager_rollout and not (
                0 < line["draft_graph_keys"] <= len(sd.catchup_lengths | {1})
                < line["draft_feeds"]):
            raise AssertionError(
                f"spec {mode.value}: {line['draft_graph_keys']} draft keys over "
                f"{line['draft_feeds']} feeds and catch-up lengths "
                f"{line['catchup_lengths']}: the draft feeds do not replay")
    if events is not None:
        events.extend(eng.events)
    return [r.tokens for r in results], line


def spec_phase(dev, cfg, params, ab: bool = False) -> dict:
    """llama3-8b (bf16, W8A8, paged, SLOTS lanes) with and without self-draft
    speculation in HBCEM and LBIM: spec tokens equal non-spec tokens per mode,
    the greedy lanes accept draft tokens above a floor, exact launch counts,
    the draft feeds replayed. With ``ab`` (``--spec``) each mode's spec serve
    is followed by its eager-rollout twin (``spec_rollout_ab`` lines)."""
    from repro_torch.core.pim_modes import Mode
    from repro_torch.serve.serving_model import ServingModel

    reqs = spec_requests(cfg.vocab_size)
    sm = ServingModel.prepare(cfg, params, max_len=serve_max_len(reqs), slots=SLOTS,
                              device=dev)
    total: dict[str, int] = {}
    events: dict[str, list] = {}
    for mode in (Mode.HBCEM, Mode.LBIM):
        plain, plain_line = spec_serve(sm, mode, reqs, spec=False,
                                       events=events.setdefault(mode.value, []))
        emit(plain_line)
        add_launches(total, plain_line)
        rounds: list = []
        spec_events = events.setdefault(f"{mode.value} spec", [])
        toks, line = spec_serve(sm, mode, reqs, spec=True, events=spec_events, rounds=rounds)
        if toks != plain:
            diff = [i for i, (a, b) in enumerate(zip(plain, toks)) if a != b]
            raise AssertionError(f"spec {mode.value}: tokens differ from the non-spec serve "
                                 f"in requests {diff}")
        greedy = [i for i, r in enumerate(reqs) if r.sampling.temperature == 0]
        accepted = sum(line["accepted_by_request"][i] for i in greedy)
        proposed = sum(line["proposed_by_request"][i] for i in greedy)
        line["greedy_acceptance"] = accepted / proposed if proposed else 0.0
        if (not all(line["accepted_by_request"][i] > 0 for i in greedy)
                or line["greedy_acceptance"] < SPEC_GREEDY_ACCEPT_FLOOR):
            raise AssertionError(
                f"spec {mode.value}: greedy lanes accepted {accepted} of {proposed} draft "
                f"tokens ({line['accepted_by_request']}), under the floor "
                f"{SPEC_GREEDY_ACCEPT_FLOOR} or none on a lane")
        line["tokens_equal_non_spec"] = True
        emit(line)
        add_launches(total, line)
        if ab:
            spec_rollout_ab(sm, mode, reqs, toks, spec_events, rounds, line, plain_line)
    emit({"phase": "serve_launches", "arch": cfg.name, "what": "spec phase", "runs": 4,
          **total})
    price_spec(events)
    check_launched(total, ("pim_gemv", "decode_attention", "decode_attention_paged"),
                   f"{cfg.name} spec")
    del sm
    return total


def spec_rollout_ab(sm, mode, reqs, tokens, events, rounds, line, plain_line) -> None:
    """``--spec``: a captured spec serve against its eager-rollout twin (the
    same serve with the draft's feeds op by op, the target's steps still
    captured). Every round's drafts, every event's plan, acceptance and
    emitted tokens, the final tokens and the launch counts must equal; the
    ``spec_rollout_ab`` line gives the round ms both ways beside the plain
    step ms."""
    twin_events: list = []
    twin_rounds: list = []
    twin_toks, twin = spec_serve(sm, mode, reqs, spec=True, events=twin_events,
                                 eager_rollout=True, rounds=twin_rounds)
    emit(twin)

    def per_event(evs):
        return [(e.plan, e.spec_drafted, e.spec_accepted, e.emitted_tokens) for e in evs]

    out = {"phase": "spec_rollout_ab", "arch": sm.cfg.name, "mode": mode.value,
           "spec_k": SPEC_K, "rounds": len(rounds),
           "drafts_equal": rounds == twin_rounds,
           "events_equal": per_event(events) == per_event(twin_events),
           "tokens_equal": twin_toks == tokens,
           "launches_equal": twin["launches"] == line["launches"],
           "captured_round_ms": line["round_ms_median"],
           "eager_rollout_round_ms": twin["round_ms_median"],
           "plain_step_ms": plain_line["decode_step_ms_median"],
           "captured_tokens_per_s": line["tokens_per_s"],
           "eager_rollout_tokens_per_s": twin["tokens_per_s"],
           "plain_tokens_per_s": plain_line["tokens_per_s"],
           "draft_graph_keys": line["draft_graph_keys"], "draft_feeds": line["draft_feeds"]}
    emit(out)
    if not all(out[k] for k in ("drafts_equal", "events_equal", "tokens_equal",
                                "launches_equal")):
        raise AssertionError(f"spec {mode.value}: the captured draft feeds differ from the "
                             f"eager rollout: {out}")


# the traffic phase: llama3-8b at full width under a seeded Poisson arrival
# trace (as `python -m repro_torch.launch.serve --arrival-rate` generates one)
TRAFFIC = dict(n_requests=16, seed=0, process="poisson", rate=0.25, prompt_len=(32, 256),
               max_new=(8, 48), priorities=(0, 0, 1))
# the admission quantum: at 8 tokens a step this trace is admission-bound
# (lanes never all busy, so nothing is ever preempted); at 64 the lanes fill
# and a priority-1 admission preempts. Pages stay 8 tokens: the prefix cache
# (which ties pages to the chunk) is off, the trace's prompts share nothing.
TRAFFIC_CHUNK = 64
TRAFFIC_TTFT_DEADLINE = 3    # steps from arrival, on every fourth request of serve (b)
TRAFFIC_CANCEL = (5, 3)      # serve (b): request 5 cancels itself after its 3rd token
TRAFFIC_PLAN_B = (("alloc_fail", 6), ("slow_step", 12, 2))   # (kind, step[, penalty])
CLI_FAULT_SEED = 1           # the CLI run's --faults seed


def traffic_trace(vocab: int):
    from repro_torch.serve import traffic

    return traffic.generate(traffic.TrafficConfig(vocab=vocab, **TRAFFIC))


def traffic_max_len(reqs) -> int:
    """The traffic serves' max_len: the trace's longest request, in whole pages."""
    return -(-serve_max_len(reqs) // 8) * 8


def traffic_table_blocks(reqs, spec: bool) -> int:
    """Block-table width of a traffic serve's paged pool (8-token pages; the
    spec serve's lanes carry the 3-token verify slack)."""
    return -(-(traffic_max_len(reqs) + (SPEC_K if spec else 0)) // 8)


def traffic_draft_lmax(reqs) -> int:
    """Lane length of the traffic spec serve's contiguous draft pool."""
    return traffic_max_len(reqs) + SPEC_K + 1


def traffic_fills(reqs) -> dict[str, list[int]]:
    """Lane fills the traffic serves reach: the trace's first four requests
    and its four longest, half way and at their last decode step."""
    longest = sorted(reqs, key=lambda r: -(len(r.prompt) + r.max_new_tokens))
    return {f"{who} {when}": fills
            for who, rs in (("first four", reqs), ("longest four", longest))
            for when, fills in serve_fills(rs).items()}


def traffic_engine(sm, reqs, *, spec: bool = False, **kw):
    """An engine of the traffic phase: SLOTS lanes, ``TRAFFIC_CHUNK``-token
    admission chunks over a paged pool of 8-token pages without prefix
    reuse; ``kw`` goes to the Engine (mode, step_policy, fault_plan). Its
    pools must have the shapes the kernel checks held for ``reqs``."""
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.spec import SpecConfig

    pool = sm.cache_pool(slots=SLOTS, prefix_cache=False, block_size=8,
                         spec_slack=SPEC_K if spec else 0)
    eng = Engine(sm.cfg, sm.params, max_len=sm.max_len, slots=SLOTS, chunk=TRAFFIC_CHUNK,
                 serving=sm, prefix_cache=False, pool=pool,
                 spec=SpecConfig(draft=sm, k=SPEC_K) if spec else None, **kw)
    blocks, lmax = eng.pool.table_blocks, eng.spec_dec.pool.max_len if spec else None
    if (blocks != traffic_table_blocks(reqs, spec)
            or (spec and lmax != traffic_draft_lmax(reqs))):
        raise AssertionError(
            f"traffic pools ({blocks} blocks, draft Lmax {lmax}) are not the shapes "
            f"kernel_check held ({traffic_table_blocks(reqs, spec)}, "
            f"{traffic_draft_lmax(reqs) if spec else None})")
    return eng


def traffic_serve(eng, name: str, reqs) -> tuple[list, dict, dict]:
    """One serve of the trace's requests on ``eng``: launch counts of this
    serve alone held to what its events imply, the pools audited
    empty, and the line with the latency summary on the engine-step clock and
    the health counters."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.serve.api import TERMINAL_STATES

    spec = eng.spec_dec is not None
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if not all(r.state in TERMINAL_STATES for r in results):
        raise AssertionError(f"traffic {name}: a request is not terminal")
    for pool in [eng.pool] + ([eng.spec_dec.pool] if spec else []):
        bad = pool.check_invariants()
        occ = pool.occupancy()
        if bad or occ.slots_used or occ.prefix_pins:
            raise AssertionError(f"traffic {name}: pool invariants {bad}, {occ.slots_used} "
                                 f"lanes and {occ.prefix_pins} prefix pins left")
    want = expected_launches(eng, eng.cfg)
    if counts != want:
        raise AssertionError(f"traffic {name}: launches {counts}, the events imply {want}")
    rep = eng.schedule_report()
    h = eng.health()
    lat = rep["latency"]
    ntok = sum(len(r.tokens) for r in results)
    line = {"phase": "traffic_serve", "serve": name, "arch": eng.cfg.name,
            "policy": eng.step_policy.name if eng.step_policy is not None else eng.mode.value,
            "spec_k": SPEC_K if spec else 0, "requests": len(reqs), "tokens": ntok,
            "wall_s": wall, "tokens_per_s": ntok / wall, "steps": rep["steps"],
            "idle_steps": rep["idle_steps"], "mode_steps": rep["mode_steps"],
            **{f"{k}_p{p}": lat[k].get(f"p{p}")
               for k in ("ttft_steps", "tpot_steps", "queue_wait_steps") for p in (50, 99)},
            "states": lat["states"], "slo": lat.get("slo"), **h["counters"],
            "ladder": {op: {k: c[k] for k in ("backend", "kernel_faults", "fallbacks")}
                       for op, c in h["ladder"].items()},
            "failed_steps": [e.plan.label for e in eng.events if e.failed],
            "spec": rep["spec"] if spec else None, "launches": counts, **graph_stats(eng)}
    check_captured(eng, f"traffic {name}")
    return results, line, h


def check_clean(name: str, eng, h: dict) -> None:
    """A serve without an injected kernel fault must not hide a real one: no
    failure, no kernel fault and no failed attempt."""
    c = h["counters"]
    faults = sum(v["kernel_faults"] + v["nan_trips"] for v in h["ladder"].values())
    if faults or c["failures"] or c["retried_steps"]:
        raise AssertionError(f"serve {name}: health not clean ({eng.last_step_error}): {h}")


def run_cli(dev) -> dict:
    """``repro_torch.launch.serve.main`` in-process on the card at smoke size
    with arrivals, the SLO-aware policy and a seeded fault plan; its health
    line must account for every fired fault (on the card a kernel is live, so
    each fired ``kernel_exc`` fails one step) and its occupancy line must read
    an empty pool."""
    import ast
    import contextlib
    import io
    import re

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch import serve as cli
    from repro_torch.serve.faults import FaultPlan

    argv = ["--arch", "llama3-8b", "--smoke", "--device", "cuda", "--quantized-decode",
            "--requests", "8", "--prompt-len", "24", "--max-new", "12", "--slots", str(SLOTS),
            "--arrival-rate", "0.3", "--mode-policy", "auto", "--faults", str(CLI_FAULT_SEED)]
    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    out = buf.getvalue()
    print(out, file=sys.stderr)
    m = re.search(r"^health: degraded=(True|False) counters=(\{.*\})$", out, re.M)
    occ = re.search(r"^occupancy: slots (\d+)/\d+ pages \d+/\d+ prefix_pins=(\d+)$", out, re.M)
    lad = re.search(r"^ladder: (\{.*\}) fault_plan: (\{.*\})$", out, re.M)
    if rc != 0 or not (m and occ and lad):
        raise AssertionError(f"CLI: rc {rc}, health/occupancy/ladder lines missing:\n{out}")
    counters, ladder = ast.literal_eval(m.group(2)), ast.literal_eval(lad.group(1))
    plan = ast.literal_eval(lad.group(2))
    kernel = sum(f["fired"] for f in plan["faults"] if f["kind"] == "kernel_exc")
    want_plan = FaultPlan.seeded(CLI_FAULT_SEED).to_json()
    if ([(f["kind"], f["step"], f["op"]) for f in plan["faults"]]
            != [(f["kind"], f["step"], f["op"]) for f in want_plan["faults"]]):
        raise AssertionError(f"CLI: fault plan {plan} is not FaultPlan.seeded's")
    if (counters["injected_faults"] != plan["fired"]
            or counters["failures"] != kernel or kernel < 1
            or sum(v["kernel_faults"] for v in ladder.values()) != kernel
            or any(v["backend"] != "kernel" or v["fallbacks"] for v in ladder.values())
            or occ.group(1) != "0" or occ.group(2) != "0"):
        raise AssertionError(f"CLI: health does not account for the plan:\n{out}")
    line = {"phase": "cli", "argv": " ".join(argv), "wall_s": wall, **counters,
            "kernel_faults_fired": kernel, "launches": counts,
            "latency_line": re.search(r"^latency \(steps\).*$", out, re.M).group(0)}
    emit(line)
    return counts


def traffic_phase(dev, cfg, params) -> dict:
    """llama3-8b (bf16, W8A8, paged 8-token pages, SLOTS lanes) under the
    seeded arrival trace: (a) HBCEM, no faults; (b) the SLO-aware policy with
    tight TTFT deadlines, a cancel from a request's own stream and a plan of
    one alloc failure and one slow step; (c) (a) with self-draft speculation;
    (d) HBCEM with an injected ``pim_gemv`` kernel fault at a step with
    running lanes. Then the CLI at smoke size."""
    import dataclasses

    from repro_torch.core.pim_modes import Mode, SloAwarePolicy
    from repro_torch.serve.api import RequestState
    from repro_torch.serve.faults import Fault, FaultPlan
    from repro_torch.serve.serving_model import ServingModel

    trace = traffic_trace(cfg.vocab_size)
    reqs = trace.to_requests()
    max_len = traffic_max_len(reqs)
    sm = ServingModel.prepare(cfg, params, max_len=max_len, slots=SLOTS, device=dev)
    emit({"phase": "traffic_setup", "arch": cfg.name, "trace": TRAFFIC, "max_len": max_len,
          "chunk": TRAFFIC_CHUNK, "page_tokens": 8, "slots": SLOTS,
          "arrivals": [r.arrival_step for r in reqs],
          "prompt_lens": [len(r.prompt) for r in reqs],
          "max_new_tokens": [r.max_new_tokens for r in reqs],
          "priorities": [r.priority for r in reqs]})
    total: dict[str, int] = {}

    def finished_budgets(name, res):
        if not all(r.state is RequestState.FINISHED and len(r.tokens) == q.max_new_tokens
                   for r, q in zip(res, reqs)):
            raise AssertionError(f"traffic {name}: a request did not finish its budget")

    # (a) HBCEM pin, no faults; the stream shows emitted tokens are never retracted
    streamed: dict[int, list] = {i: [] for i in range(len(reqs))}
    eng_a = traffic_engine(sm, reqs, mode=Mode.HBCEM)
    res_a, line, h = traffic_serve(
        eng_a, "a", [dataclasses.replace(r, on_token=streamed[i].append)
                     for i, r in enumerate(reqs)])
    check_clean("traffic a", eng_a, h)
    finished_budgets("a", res_a)
    if h["counters"]["preemptions"] < 1:
        raise AssertionError("traffic a: no preemption")
    if any(streamed[i] != r.tokens for i, r in enumerate(res_a)):
        raise AssertionError("traffic a: a resumed request lost or re-emitted tokens")
    line["preempted_requests"] = sum(1 for r in res_a if r.preemptions)
    emit(line)
    add_launches(total, line)

    # (b) auto, tight TTFT deadlines on every fourth request, a cancel from a
    # request's own stream, one alloc failure and one slow step
    eng_b = traffic_engine(sm, reqs, step_policy=SloAwarePolicy(), fault_plan=FaultPlan(
        faults=[Fault(f[0], f[1], penalty=f[2] if len(f) > 2 else 0) for f in TRAFFIC_PLAN_B]))
    who, after = TRAFFIC_CANCEL
    seen: list = []

    def canceller(tok):
        seen.append(tok)
        if len(seen) == after:
            eng_b.cancel(who)
    reqs_b = [dataclasses.replace(r, ttft_deadline=TRAFFIC_TTFT_DEADLINE if i % 4 == 3
                                  else None, on_token=canceller if i == who else None)
              for i, r in enumerate(reqs)]
    res_b, line, h = traffic_serve(eng_b, "b", reqs_b)
    check_clean("traffic b", eng_b, h)
    c = h["counters"]
    if (c["timeouts"] < 1 or c["cancellations"] != 1 or c["injected_faults"] != 2
            or eng_b.fault_plan.pending() or res_b[who].state is not RequestState.CANCELLED
            or len(res_b[who].tokens) < after):
        raise AssertionError(f"traffic b: counters {c}, plan {eng_b.fault_plan.to_json()}, "
                             f"request {who} {res_b[who].state}")
    if any(r.state is RequestState.TIMED_OUT and reqs_b[i].ttft_deadline is None
           for i, r in enumerate(res_b)):
        raise AssertionError("traffic b: a request without a deadline timed out")
    emit(line)
    add_launches(total, line)

    # (c) (a)'s traffic with self-draft speculation
    eng_c = traffic_engine(sm, reqs, mode=Mode.HBCEM, spec=True)
    res_c, line, h = traffic_serve(eng_c, "c", reqs)
    check_clean("traffic c", eng_c, h)
    finished_budgets("c", res_c)
    line["requests_equal_to_a"] = sum(r.tokens == q.tokens for r, q in zip(res_c, res_a))
    emit(line)
    add_launches(total, line)

    # (d) a pim_gemv kernel fault at the clock of (a)'s 10th step with two or
    # more lanes decoding: the schedule is (a)'s up to it
    steps = [e.clock for e in eng_a.events if e.plan.decode and e.decode_batch >= 2]
    eng_d = traffic_engine(sm, reqs, mode=Mode.HBCEM, fault_plan=FaultPlan(
        faults=[Fault("kernel_exc", steps[9], op="pim_gemv")]))
    res_d, line, h = traffic_serve(eng_d, "d", reqs)
    failed = [i for i, r in enumerate(res_d) if r.state is RequestState.FAILED]
    ev = [e for e in eng_d.events if e.failed]
    lad = h["ladder"]
    if (eng_d.fault_plan.fired() != 1 or len(ev) != 1 or ev[0].clock != steps[9]
            or len(failed) != ev[0].decode_batch + bool(ev[0].plan.prefill_chunk)
            or ev[0].decode_batch < 1
            or lad["pim_gemv"]["kernel_faults"] != 1 or h["counters"]["failures"] != 1
            or any(v["fallbacks"] for v in lad.values())
            or not all(res_d[i].error for i in failed)
            or eng_d.last_step_error != "KernelFault: kernel fault in 'pim_gemv'"
            or not all(r.state is RequestState.FINISHED and len(r.tokens) == reqs[i].max_new_tokens
                       for i, r in enumerate(res_d) if i not in failed)):
        raise AssertionError(f"traffic d: {h}, failed requests {failed}, failed steps {ev}")
    line["step_error"] = eng_d.last_step_error
    line["fault_step"] = steps[9]
    line["failed_requests"] = failed
    emit(line)
    add_launches(total, line)
    price_traffic({"a": (eng_a, res_a), "b": (eng_b, res_b), "c": (eng_c, res_c),
                   "d": (eng_d, res_d)})
    del sm
    for k, v in run_cli(dev).items():
        total[k] = total.get(k, 0) + v
    emit({"phase": "serve_launches", "arch": cfg.name, "what": "traffic phase and CLI",
          "runs": 5, **total})
    check_launched(total, ("pim_gemv", "decode_attention", "decode_attention_paged"),
                   f"{cfg.name} traffic")
    return total


def serve_ab(dev) -> None:
    """``--ab``: one LBIM serve of each configuration and pool (llama3-8b paged
    and contiguous, zamba2-7b), each after a short warm-up serve, with the
    same checks as the full run. Run in two checkouts in turn on one machine,
    it compares their host side."""
    from repro_torch.configs import get_config
    from repro_torch.core.pim_modes import Mode
    from repro_torch.models.model import init_params
    from repro_torch.serve.api import GenerationRequest
    from repro_torch.serve.serving_model import ServingModel

    for arch in ("llama3-8b", "zamba2-7b"):
        cfg = get_config(arch).replace(quantized_decode=True)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        dense = cfg.family == "dense"
        reqs = make_requests(cfg.vocab_size) if dense else zamba2_requests(cfg.vocab_size)
        max_len = max(len(r.prompt) + r.max_new_tokens for r in reqs)
        max_len = -(-max_len // 8) * 8 if dense else max_len    # as the full run sizes them
        sm = ServingModel.prepare(cfg, params, max_len=max_len, slots=SLOTS, device=dev)
        short = [GenerationRequest(prompt=r.prompt[:32], max_new_tokens=16)
                 for r in reqs[:SLOTS]]
        for paged in (True, False) if dense else (True,):
            sm.engine(mode=Mode.LBIM, slots=SLOTS, prefix_cache=False).serve(short)
            _, line = serve_run(sm, Mode.LBIM, reqs, paged=paged)
            emit(line)
        del sm, params
        torch.cuda.empty_cache()


_GEMM = "GEMM (prefill, lm_head, float decode products: bf16 projections, MoE experts)"
KERNEL_GROUPS = (   # kernel-name fragment -> what it computes on the serve path
    ("pim_gemv", "pim_gemv (W8A8 decode GEMVs)"),
    ("contig_decode", "contiguous decode attention"),
    ("paged_decode", "paged decode attention"),
    ("gemm", _GEMM), ("gemv", _GEMM), ("nvjet", _GEMM), ("cutlass", _GEMM),
    ("index", "page scatter / gather / embedding"),
    ("scatter", "page scatter / gather / embedding"),
    ("gather", "page scatter / gather / embedding"),
    ("reduce", "reductions (norms, argmax, quantizer amax)"),
)


def profile_decode(sm, mode, reqs) -> None:
    """Device time by kernel over a decode-heavy serve (the first SLOTS
    requests cut to 32-token prompts and 16 new tokens: one batch admission,
    then 15 full-batch decode steps), traced with torch.profiler (CUDA
    activity only, which keeps the trace small). The busy share divides the
    kernel time by the same serve's wall time measured untraced first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.api import GenerationRequest

    if GRAPHS_AB:
        return
    short = [GenerationRequest(prompt=r.prompt[:32], max_new_tokens=16) for r in reqs[:SLOTS]]
    eng = sm.engine(mode=mode, slots=SLOTS, prefix_cache=False)   # same schedule each serve
    eng.serve(short)            # warm: allocator, cuBLAS handles, every step's graph
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.serve(short)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    decode = [e.step_s for e in eng.events if e.plan.decode and not e.plan.prefill_chunk]
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.serve(short)
        torch.cuda.synchronize()
    traced_wall = time.perf_counter() - t0
    by_kernel = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us / 1e3
    total = sum(by_kernel.values())
    if total <= 0:
        emit({"phase": "profile", "arch": sm.cfg.name, "mode": mode.value,
              "device_time": "not measured",
              "why": "torch.profiler recorded no device time",
              "wall_ms_untraced": 1e3 * wall_s})
        return
    groups: dict[str, float] = {}
    for name, ms in by_kernel.items():
        low = name.lower()
        group = next((g for frag, g in KERNEL_GROUPS if frag in low),
                     "elementwise and other")
        groups[group] = groups.get(group, 0.0) + ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": "profile", "arch": sm.cfg.name, "mode": mode.value, "requests": len(short),
          "prompt_tokens": 32, "new_tokens": 16, "pure_decode_steps": len(decode),
          "decode_step_ms_median": 1e3 * statistics.median(decode),
          "kernel_ms_total": total,
          "wall_ms_untraced": 1e3 * wall_s, "wall_ms_traced": 1e3 * traced_wall,
          "device_busy_share": total / (1e3 * wall_s),
          "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
          "top_kernels_ms": {k[:80]: v for k, v in top}, **graph_stats(eng)})


def trace_events(prof) -> list:
    """The trace's events (Kineto's JSON: kernels with their stream and the
    correlation id of the launch that issued them), through a temporary file
    that is removed."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())["traceEvents"]


def concurrency(kernels) -> dict:
    """Over one graph replay's kernels ``(start_us, end_us, stream, name)``:
    its span, each stream's busy time, the time in which kernels of two
    streams ran at once, and the time in which any two kernels did (the
    latter also counts a programmatic dependent launch's prologue beside its
    predecessor on one stream), all in ms. One sweep over the kernels' ends
    and starts (an end before a start at the same instant)."""
    edges = sorted([(k[0], 1, k[2]) for k in kernels] + [(k[1], -1, k[2]) for k in kernels])
    active: dict = {}
    busy = {k[2]: 0.0 for k in kernels}
    both = any2 = 0.0
    live, prev = 0, None
    for t, step, stream in edges:
        if prev is not None and t > prev:
            on = [st for st, n in active.items() if n > 0]
            for st in on:
                busy[st] += t - prev
            both += (t - prev) if len(on) > 1 else 0.0
            any2 += (t - prev) if live > 1 else 0.0
        active[stream] = active.get(stream, 0) + step
        live += step
        prev = t
    span = (edges[-1][0] - edges[0][0]) if edges else 0.0
    return {"span_ms": span / 1e3, "busy_ms": {st: v / 1e3 for st, v in busy.items()},
            "both_streams_ms": both / 1e3, "any_two_ms": any2 / 1e3}


DECODE_KERNELS = ("pim_gemv", "paged_decode", "contig_decode")


def trace_kernel_ms(events: list) -> float:
    """Device ms of every kernel in a trace's events."""
    return sum(e["dur"] for e in events if e.get("cat") == "kernel") / 1e3


def fused_branches(events: list, programs: list) -> dict:
    """The fused steps' branches in a traced captured serve: the graph
    launches (``cudaGraphLaunch``) in time order are the serve's replays in
    ``StepGraphs.trace`` order; a fused replay's kernels are those its
    launch's correlation id issued. The decode branch is the stream that runs
    the port's kernels, the prefill branch the other."""
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                       and "cudaGraphLaunch" in e.get("name", "")), key=lambda e: e["ts"])
    if len(launches) != len(programs):
        return {"not_measured": f"{len(launches)} graph launches in the trace against "
                                f"{len(programs)} replays"}
    by_corr: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            a = e.get("args", {})
            by_corr.setdefault(a.get("correlation"), []).append(
                (e["ts"], e["ts"] + e["dur"], a.get("stream"), e["name"]))
    fused = [by_corr.get(e.get("args", {}).get("correlation"), [])
             for e, prog in zip(launches, programs) if prog == "fused"]
    if not fused or not all(fused):
        return {"not_measured": "no kernels correlated with the fused graph launches"}
    out = {"fused_steps": len(fused), "span_ms": 0.0, "decode_branch_ms": 0.0,
           "prefill_branch_ms": 0.0, "both_branches_ms": 0.0, "any_two_kernels_ms": 0.0,
           "streams_per_step": sorted({len({k[2] for k in ks}) for ks in fused})}
    for ks in fused:
        c = concurrency(ks)
        dec = {k[2] for k in ks if any(f in k[3] for f in DECODE_KERNELS)}
        out["span_ms"] += c["span_ms"]
        out["both_branches_ms"] += c["both_streams_ms"]
        out["any_two_kernels_ms"] += c["any_two_ms"]
        for st, ms in c["busy_ms"].items():
            out["decode_branch_ms" if st in dec else "prefill_branch_ms"] += ms
    return out


def halves_graphs(device):
    """A ``StepGraphs`` that runs each fused step's two halves alone first,
    each captured (the decode graph; the chunk's sub-chunk graphs), over the
    same inputs, then the fused step, with CUDA events around all three. The
    fills are set back after each half and the halves' launches taken back
    out of the counters: the halves write the K/V the fused step writes again
    (llama3-8b's caches are pages and fills only), so the serve's tokens and
    launches stay the fused serve's. ``samples`` keeps the events of the
    steps in which all three replayed (no first call, no capture)."""
    from repro_torch.core import interleave
    from repro_torch.kernels import add_launches, launch_counts

    class HalvesGraphs(interleave.StepGraphs):
        def __init__(self, dev):
            super().__init__(dev)
            self.samples: list = []

        def fused_step(self, params, dec_cache, dec_tokens, pre_cache, pre_tokens, cfg, *,
                       sub_chunk=None):
            fills = (dec_cache["pos"].clone(), pre_cache["pos"].clone())
            before, st0 = launch_counts(), self.stats()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            self.decode_only_step(params, dec_cache, dec_tokens, cfg)
            ev[1].record()
            dec_cache["pos"].copy_(fills[0])
            ev[2].record()
            self.prefill_chunk_step(params, pre_cache, pre_tokens, cfg, sub_chunk=sub_chunk)
            ev[3].record()
            pre_cache["pos"].copy_(fills[1])
            after = launch_counts()
            add_launches({k: before[k] - after[k] for k in after})
            ev[4].record()
            out = super().fused_step(params, dec_cache, dec_tokens, pre_cache, pre_tokens,
                                     cfg, sub_chunk=sub_chunk)
            ev[5].record()
            st1 = self.stats()
            if st1["captures"] == st0["captures"] and st1["eager_steps"] == st0["eager_steps"]:
                self.samples.append(ev)
            return out

    return HalvesGraphs(device)


def graphs_phase(sm, reqs, tokens: dict, events: dict, lines: dict) -> None:
    """The captured step programs on llama3-8b at full width (the serve
    phase's artifact and requests, paged). (1) HBCEM and LBIM, captured in the
    serve phase, each against its eager twin (``graphs_ab``: equal tokens,
    plans and launches). (2) LBIM's two branches: ``lbim_overlap``."""
    from repro_torch.core.pim_modes import Mode

    ab = {}
    for mode in (Mode.HBCEM, Mode.LBIM):
        ab[mode] = graphs_ab(sm, mode, reqs, tokens[mode], events[mode.value], lines[mode])
    lbim_overlap(sm, reqs, ab[Mode.LBIM])


def lbim_overlap(sm, reqs, ab: dict) -> None:
    """One ``lbim_overlap`` line. (a) An LBIM engine without prefix reuse
    (the same schedule every serve) serves the requests once (every key
    captured), once untraced (its wall) and once traced with torch.profiler:
    over its fused steps, the decode branch's and the prefill branch's device
    ms, the ms in which kernels of both ran at once and the steps' span
    (``fused_branches``); its busy share (kernel ms over the untraced wall)
    beside the eager serve's (one traced eager serve, over the eager twin's
    untraced wall). (b) The same serve on ``halves_graphs``: each fused
    step's device ms beside its halves' timed alone, each captured; its
    tokens and launches must be the fused serve's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import interleave
    from repro_torch.core.pim_modes import Mode

    eng = sm.engine(mode=Mode.LBIM, slots=SLOTS, prefix_cache=False)
    eng.serve(reqs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lbim_tokens = [r.tokens for r in eng.serve(reqs)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng.graphs.trace = []
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.serve(reqs)
        torch.cuda.synchronize()
    traced = time.perf_counter() - t0
    t0 = time.perf_counter()
    events = trace_events(prof)
    branches = fused_branches(events, eng.graphs.trace)
    captured_ms = trace_kernel_ms(events)
    analysis_s = time.perf_counter() - t0
    stats = graph_stats(eng)
    del eng, prof, events
    t0 = time.perf_counter()
    with interleave.eager():
        eng = sm.engine(mode=Mode.LBIM, slots=SLOTS)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.serve(reqs)
            torch.cuda.synchronize()
        eager_ms = trace_kernel_ms(trace_events(prof))
    del eng, prof
    eager_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    holder = {}

    def make():
        holder["eng"] = eng = sm.engine(mode=Mode.LBIM, slots=SLOTS, prefix_cache=False)
        eng.graphs = halves_graphs(sm.device)
        return eng

    toks, line = serve_run(sm, Mode.LBIM, reqs, make_engine=make)
    if toks != lbim_tokens:
        raise AssertionError("the LBIM serve with its halves timed alone gave other tokens")
    torch.cuda.synchronize()
    samples = holder.pop("eng").graphs.samples
    alone = [(e[0].elapsed_time(e[1]), e[2].elapsed_time(e[3]), e[4].elapsed_time(e[5]))
             for e in samples]
    emit({"phase": "lbim_overlap", "arch": sm.cfg.name, "gpu": nvidia_smi(),
          "requests": len(reqs), "captured_wall_s": wall, "traced_wall_s": traced,
          "trace_analysis_s": analysis_s, "eager_trace_s": eager_s,
          "halves_serve_s": time.perf_counter() - t0, **branches,
          "captured_kernel_ms": captured_ms, "captured_busy_share": captured_ms / (1e3 * wall),
          "eager_kernel_ms": eager_ms, "eager_wall_s": ab["eager_wall_s"],
          "eager_busy_share": eager_ms / (1e3 * ab["eager_wall_s"]),
          "timed_fused_steps": len(alone),
          "fused_ms_median": statistics.median(a[2] for a in alone) if alone else None,
          "decode_alone_ms_median": statistics.median(a[0] for a in alone) if alone else None,
          "prefill_alone_ms_median": statistics.median(a[1] for a in alone) if alone else None,
          "fused_ms_sum": sum(a[2] for a in alone),
          "halves_alone_ms_sum": sum(a[0] + a[1] for a in alone),
          "graph_stats": stats, "halves_serve_launches": line["launches"]})


# ---------------------------------------------------------------------------
# training: the full-sequence forward, autograd, AdamW, checkpoints
# ---------------------------------------------------------------------------

TRAIN_ARCH = "internvl2-2b"
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
TRAIN_STEPS = 4              # text-only steps, then one step with the image prefix
PARITY_ARCHS = ("llama3-8b", "olmoe-1b-7b", "zamba2-7b", "rwkv6-1.6b")
# the CPU parity tests' batch shape: at S 64 zamba2's f32 gradients stray from
# f64 by more than the tolerance on the CPU itself (PERF.md, Findings)
PARITY_BATCH, PARITY_SEQ = 2, 16
# examples/train_100m.py's ~100M llama (on the llama3-8b smoke config's dtypes)
LLAMA_100M = dict(name="llama-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                  d_head=64, d_ff=2048, vocab_size=32000, q_chunk=256, remat=False)
RESUME_BATCH, RESUME_SEQ = 8, 256
RESUME_STEPS, RESUME_STOP = 60, 30
RESUME_RTOL, RESUME_ATOL = 2e-2, 1e-3   # tests/test_train.py's crash-resume tolerance
AB_STEPS = 4                 # train_capture_ab: a warm-up, a capture, two replays


def n_params(params) -> int:
    from repro_torch.train.optimizer import tree_leaves

    return sum(t.numel() for t in tree_leaves(params))


def train_steps(dev, mesh=None, captured: bool = True) -> list:
    """(a) internvl2-2b at full width and depth (bf16, ``remat`` from its
    config, seeded weights): ``TRAIN_STEPS`` steps over ``SyntheticLM``
    batches of B 8 x S 1024, then one whose batch adds 256 seeded patch
    embeddings, each the in-place step through a ``train_step.TrainGraphs``:
    the first eager (the warm-up), the second captured and replayed, the
    rest replays; the prefix step, a key of its own seen once, eager.
    ``captured=False`` runs every step eagerly (``interleave.eager()``). Each
    step ends in a sync; its line gives loss, grad norm, step ms, tokens/s,
    mfu (6 x params x positions through the stack over the step's seconds
    and ``PEAK_BF16_FLOPS``, the recompute not counted) and the peak of
    allocated memory since the phase began; a ``train_graphs`` line the
    graphs' counters, capture s and pool GB. With a ``mesh`` (the ``dist``
    group's), ``dist_grads`` then runs on the last step's batch. Returns the
    steps' (loss, grad norm)."""
    from repro_torch.configs import get_config
    from repro_torch.core import interleave
    from repro_torch.models.model import init_params
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import TrainGraphs

    cfg = get_config(TRAIN_ARCH)
    free_card(f"{TRAIN_ARCH} training")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt_state = init_opt_state(params)
    torch.cuda.synchronize()
    n = n_params(params)
    emit({"phase": "train_setup", "arch": cfg.name, "layers": cfg.n_layers, "d": cfg.d_model,
          "params": n, "remat": cfg.remat, "dtype": cfg.dtype,
          "state_GB": torch.cuda.memory_allocated() / 1e9,
          "setup_s": time.perf_counter() - t0})
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH))
    opt = AdamWConfig()
    gen = torch.Generator(device=dev).manual_seed(7)
    graphs = TrainGraphs(dev)
    out = []
    with contextlib.ExitStack() as stack:
        if not captured:
            stack.enter_context(interleave.eager())
        for step in range(TRAIN_STEPS + 1):
            batch, prefix = train_batch(cfg, data, step, gen, dev)
            before = graphs.stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = graphs.step(params, opt_state, batch, cfg, opt, 1)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            after = graphs.stats()
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise AssertionError(f"{cfg.name} step {step}: loss {loss}, grad norm {gnorm}")
            out.append((loss, gnorm))
            positions = TRAIN_BATCH * (TRAIN_SEQ + prefix)
            emit({"phase": "train_step", "arch": cfg.name, "step": step, "batch": TRAIN_BATCH,
                  "seq": TRAIN_SEQ, "prefix": prefix, "loss": loss, "grad_norm": gnorm,
                  "how": ("captured" if after["captures"] > before["captures"] else
                          "replay" if after["replays"] > before["replays"] else "eager"),
                  "step_ms": dt * 1e3, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / dt,
                  "mfu": 6 * n * positions / dt / PEAK_BF16_FLOPS,
                  "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
    st = graphs.stats()
    emit({"phase": "train_graphs", "arch": cfg.name, "captured": captured,
          "graphs": st["graphs"], "keys": st["keys"], "captures": st["captures"],
          "replays": st["replays"], "eager_steps": st["eager_steps"],
          "capture_s": st["capture_s"], "graph_pool_GB": st["pool_bytes"] / 1e9,
          "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
    want = ((1, TRAIN_STEPS - 1, 2) if captured and dev.type == "cuda"
            else (0, 0, TRAIN_STEPS + 1))
    if (st["captures"], st["replays"], st["eager_steps"]) != want:
        raise AssertionError(f"{cfg.name}: train graphs {st}, expected (captures, replays, "
                             f"eager steps) {want}")
    del graphs, opt_state
    if mesh is not None:
        dist_grads(cfg, params, batch)
    del params
    return out


def train_capture_ab(dev) -> None:
    """The ~125 M llama of ``examples/train_100m.py`` (B 8 x S 256): four
    in-place steps through a ``TrainGraphs``, captured, then the same steps
    from the same weights under ``interleave.eager()``; losses, grad norms
    and every params and moments leaf must equal bit for bit
    (``train_capture_ab`` line: step ms both ways, capture s, pool GB)."""
    from repro_torch.configs import get_config
    from repro_torch.core import interleave
    from repro_torch.models.model import init_params
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state, tree_leaves
    from repro_torch.train.train_step import TrainGraphs

    cfg = get_config("llama3-8b", smoke=True).replace(**LLAMA_100M)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=RESUME_SEQ,
                                  global_batch=RESUME_BATCH))
    opt = AdamWConfig(lr=6e-4, warmup_steps=2, total_steps=AB_STEPS)

    def run(captured: bool):
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        state = init_opt_state(params)
        graphs = TrainGraphs(dev)
        metrics, ms = [], []
        with contextlib.ExitStack() as stack:
            if not captured:
                stack.enter_context(interleave.eager())
            for step in range(AB_STEPS):
                batch = {k: torch.from_numpy(v) for k, v in data.batch_at(step).items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = graphs.step(params, state, batch, cfg, opt)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
        leaves = [t.cpu() for t in tree_leaves(params) + [state.step] + tree_leaves(state.m)
                  + tree_leaves(state.v)]
        return metrics, ms, leaves, graphs.stats()

    cap, cap_ms, cap_leaves, st = run(True)
    eag, eag_ms, eag_leaves, _ = run(False)
    out = {"phase": "train_capture_ab", "arch": cfg.name,
           "params": sum(t.numel() for t in cap_leaves) // 3,
           "batch": RESUME_BATCH, "seq": RESUME_SEQ, "steps": AB_STEPS,
           "losses_equal": [m[0] for m in cap] == [m[0] for m in eag],
           "grad_norms_equal": [m[1] for m in cap] == [m[1] for m in eag],
           "leaves_equal": all(torch.equal(a, b) for a, b in zip(cap_leaves, eag_leaves)),
           "losses": [m[0] for m in cap],
           "captured_replay_ms": cap_ms[2:], "eager_step_ms": eag_ms[1:],
           "capture_step_ms": cap_ms[1], "capture_s": st["capture_s"],
           "graph_pool_GB": st["pool_bytes"] / 1e9, "replays": st["replays"]}
    emit(out)
    if not (out["losses_equal"] and out["grad_norms_equal"] and out["leaves_equal"]):
        raise AssertionError(f"{cfg.name}: the captured train step differs from the eager "
                             f"one: {out}")


def train_batch(cfg, data, step: int, gen, dev) -> tuple[dict, int]:
    """``SyntheticLM``'s batch ``step`` on the card; the step after the last
    text-only one adds ``n_prefix_tokens`` seeded patch embeddings. Returns
    the batch and its prefix length."""
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(step).items()}
    prefix = 0
    if step == TRAIN_STEPS:
        prefix = cfg.n_prefix_tokens
        batch["prefix_embeds"] = 0.02 * torch.randn(
            (TRAIN_BATCH, prefix, cfg.d_model), generator=gen, device=dev)
    return batch, prefix


def train_parity(dev) -> None:
    """(b) For each of ``PARITY_ARCHS`` at f32 smoke, the same seeded
    weights and ``SyntheticLM`` batch (B 2 x S 16) on the card and on the CPU: the loss within rtol
    1e-4, every gradient leaf within rtol 1e-4 and an atol of 1e-5 of its
    max |g|, and one AdamW step over the card's gradients against the CPU's
    step over the same gradients (rtol 1e-5)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import (AdamWConfig, adamw_update, init_opt_state,
                                             tree_leaves, tree_map)
    from repro_torch.train.train_step import value_and_grad

    for arch in PARITY_ARCHS:
        cfg = get_config(arch, smoke=True).replace(dtype="float32", param_dtype="float32")
        cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        card = tree_map(lambda t: t.to(dev), cpu)
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=PARITY_SEQ,
                                      global_batch=PARITY_BATCH))
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
        loss_d, grads_d = value_and_grad(card, {k: v.to(dev) for k, v in batch.items()}, cfg)
        loss_c, grads_c = value_and_grad(cpu, batch, cfg)
        if not math.isclose(float(loss_d), float(loss_c), rel_tol=1e-4):
            raise AssertionError(f"{arch}: loss {float(loss_d)} on the card, "
                                 f"{float(loss_c)} on the CPU")
        worst = 0.0
        for gd, gc in zip(tree_leaves(grads_d), tree_leaves(grads_c)):
            gd = gd.cpu()
            tol = 1e-4 * gc.abs() + 1e-5 * float(gc.abs().max())
            if not bool(((gd - gc).abs() <= tol).all()):
                raise AssertionError(f"{arch}: a gradient leaf {tuple(gc.shape)} differs by "
                                     f"{float((gd - gc).abs().max())}")
            worst = max(worst, float((gd - gc).abs().max()))
        opt = AdamWConfig(warmup_steps=1, total_steps=10)
        new_d, _, _ = adamw_update(card, grads_d, init_opt_state(card), opt)
        new_c, _, _ = adamw_update(cpu, tree_map(lambda t: t.cpu(), grads_d),
                                   init_opt_state(cpu), opt)
        step_err = max(float((pd.cpu() - pc).abs().max())
                       for pd, pc in zip(tree_leaves(new_d), tree_leaves(new_c)))
        for pd, pc in zip(tree_leaves(new_d), tree_leaves(new_c)):
            if not torch.allclose(pd.cpu(), pc, rtol=1e-5, atol=1e-7):
                raise AssertionError(f"{arch}: the AdamW step differs by {step_err}")
        emit({"phase": "train_parity", "arch": cfg.name, "loss_card": float(loss_d),
              "loss_cpu": float(loss_c), "grad_max_abs_err": worst,
              "adamw_max_abs_err": step_err, "leaves": len(tree_leaves(grads_c))})


def train_resume(dev, mesh=None) -> None:
    """(c) ``examples/train_100m.py``'s ~100M llama, B 8 x S 256 through
    ``train.loop.run``: ``RESUME_STEPS`` steps uninterrupted, whose loss must
    fall (the example's own assertion); then a run stopped at
    ``RESUME_STOP`` (its checkpoint written) and a second run that resumes
    from it to ``RESUME_STEPS``; its params must equal the uninterrupted
    run's within ``tests/test_train.py``'s tolerance. The checkpoints go to
    a temporary directory the phase removes; with a ``mesh``, ``dist_restore``
    reads the newest of them first."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.train.data import DataConfig
    from repro_torch.train.loop import TrainConfig, run
    from repro_torch.train.optimizer import AdamWConfig, tree_leaves

    cfg = get_config("llama3-8b", smoke=True).replace(**LLAMA_100M)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=RESUME_SEQ, global_batch=RESUME_BATCH)
    opt = AdamWConfig(lr=6e-4, warmup_steps=RESUME_STEPS // 20 + 1, total_steps=RESUME_STEPS)
    quiet = dict(log=lambda *a: None, device=dev)
    t0 = time.perf_counter()
    p_full, _, hist = run(cfg, dc, TrainConfig(steps=RESUME_STEPS, log_every=0, opt=opt),
                          **quiet)
    full_s = time.perf_counter() - t0
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"{cfg.name}: loss {hist[0]['loss']} -> {hist[-1]['loss']}")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        run(cfg, dc, TrainConfig(steps=RESUME_STOP, ckpt_dir=ckpt, ckpt_every=RESUME_STEPS,
                                 log_every=0, opt=opt), **quiet)
        stop_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        p_res, _, hist_res = run(cfg, dc, TrainConfig(steps=RESUME_STEPS, ckpt_dir=ckpt,
                                                      ckpt_every=RESUME_STEPS + 1, log_every=0,
                                                      opt=opt), **quiet)
        resume_s = time.perf_counter() - t0
        ckpt_GB = sum(f.stat().st_size for f in Path(ckpt).rglob("*") if f.is_file()) / 1e9
        if mesh is not None:
            dist_restore(dev, mesh, ckpt, cfg, dc)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if hist_res[0]["step"] != RESUME_STOP:
        raise AssertionError(f"the resumed run began at step {hist_res[0]['step']}")
    err = 0.0
    for a, b in zip(tree_leaves(p_full), tree_leaves(p_res)):
        a, b = a.float(), b.float()
        err = max(err, float((a - b).abs().max()))
        if not torch.allclose(a, b, rtol=RESUME_RTOL, atol=RESUME_ATOL):
            raise AssertionError(f"{cfg.name}: resumed params differ by {err}")
    dts = sorted(h["dt"] for h in hist[1:])
    emit({"phase": "train_resume", "arch": cfg.name, "params": n_params(p_full),
          "batch": RESUME_BATCH, "seq": RESUME_SEQ, "steps": RESUME_STEPS,
          "loss_first": hist[0]["loss"], "loss_last": hist[-1]["loss"],
          "step_ms_median": 1e3 * statistics.median(dts), "run_s": full_s,
          "stop_run_s": stop_s, "resume_run_s": resume_s, "ckpt_dir_GB": ckpt_GB,
          "resumed_at": hist_res[0]["step"], "params_max_abs_diff": err})


def train_phase(dev, ab: bool = False) -> dict:
    """(a) ``train_steps`` (captured), (b) ``train_parity``, (c)
    ``train_resume`` (the loop replays its captured step), (d)
    ``train_capture_ab``, with the ``dist`` checks inside (a) and (c) on a
    world-size-1 NCCL group; no kernel of the port may launch (the JAX
    training path reaches no ``pallas_call``). With ``ab`` (``--train``)
    (a) runs again eagerly, its losses and grad norms equal to the captured
    run's bit for bit. Returns the (zero) launch counts."""
    from repro_torch.kernels import launch_counts, reset_launches

    reset_launches()
    with dist_group(dev) as mesh:
        captured = train_steps(dev, mesh)
        if ab:
            eager = train_steps(dev, captured=False)
            emit({"phase": "train_steps_ab", "arch": TRAIN_ARCH, "steps": len(captured),
                  "equal": captured == eager})
            if captured != eager:
                raise AssertionError(f"{TRAIN_ARCH}: captured (loss, grad norm) {captured}, "
                                     f"eager {eager}")
        train_parity(dev)
        train_resume(dev, mesh)
        train_capture_ab(dev)
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the training path launched kernels: {counts}")
    return counts


# ---------------------------------------------------------------------------
# dist/ on one rank: a world-size-1 NCCL group and a (1, 1) ("data", "model")
# mesh; the sharding rules, the int8 gradient compression and seq_parallel


DIST_EF_STEPS = 4            # error-feedback steps over the real gradients
DIST_EF_RTOL = 0.01          # tests/test_collectives.py:23's bound on the mean's error
# |dequantize(quantize(g)) - g| <= scale / 2 in exact arithmetic; the f32
# quotient, round and product add a few ulps of |g| <= 127 scale
DIST_ERR_OVER_SCALE = 0.5 + 2.0**-14


@contextlib.contextmanager
def dist_group(dev):
    """A world-size-1 NCCL process group on a ``HashStore`` (no network port)
    and its (1, 1) ``("data", "model")`` mesh; the group is destroyed on
    exit."""
    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_mesh

    tdist.init_process_group("nccl", store=tdist.HashStore(), rank=0, world_size=1,
                             device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        yield make_mesh((1, 1), ("data", "model"), device=dev)
    finally:
        tdist.destroy_process_group()


def dist_grads(cfg, params, batch) -> None:
    """(b) ``quantize_grad``/``dequantize_grad`` over every leaf of the real
    full-width gradients of ``batch`` (one ``value_and_grad``): every element's
    error within half its row's scale, the int8 bytes a quarter of the f32
    bytes, and ``tests/test_collectives.py:23``'s error feedback over
    ``DIST_EF_STEPS`` steps (the mean of the dequantized sums within
    ``DIST_EF_RTOL`` of the gradient, in norm over all leaves); the quantize
    pass timed on the card with CUDA events. (c) The same loss with
    ``seq_parallel=True`` (the identity on one rank), bit for bit."""
    from repro_torch.dist.collectives import dequantize_grad, quantize_grad
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_step import value_and_grad

    loss, grads = value_and_grad(params, batch, cfg)
    leaves = tree_leaves(grads)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    qs = [quantize_grad(g) for g in leaves]
    end.record()
    torch.cuda.synchronize()
    pass_ms = start.elapsed_time(end)
    elems = sum(g.numel() for g in leaves)
    in_bytes = sum(g.numel() * g.element_size() for g in leaves)
    q_bytes = sum(q.numel() * q.element_size() for q, _ in qs)
    s_bytes = sum(sc.numel() * sc.element_size() for _, sc in qs)
    worst = 0.0
    for g, (q, sc) in zip(leaves, qs):
        if q.dtype != torch.int8 or 4 * q.numel() * q.element_size() != g.numel() * 4:
            raise AssertionError(f"a {tuple(g.shape)} leaf quantized to {q.dtype} {q.shape}")
        ratio = float(((dequantize_grad(q, sc) - g.float()).abs() / sc).max())
        worst = max(worst, ratio)
    if worst > DIST_ERR_OVER_SCALE:
        raise AssertionError(f"quantize_grad: an error of {worst} scales")
    num = den = 0.0
    for g in leaves:
        gf = g.float()
        err, total = torch.zeros_like(gf), torch.zeros_like(gf)
        for _ in range(DIST_EF_STEPS):
            corrected = gf + err
            deq = dequantize_grad(*quantize_grad(corrected))
            err = corrected - deq
            total += deq
        num += float(((total / DIST_EF_STEPS - gf) ** 2).sum())
        den += float((gf * gf).sum())
    ef_rel = math.sqrt(num / den)
    if not ef_rel < DIST_EF_RTOL:
        raise AssertionError(f"error feedback over {DIST_EF_STEPS} steps: rel {ef_rel}")
    emit({"phase": "dist", "check": "quantize_grad", "arch": cfg.name,
          "grad_leaves": len(qs), "elements": elems, "grad_bytes": in_bytes,
          "f32_bytes": elems * 4, "int8_bytes": q_bytes, "scale_bytes": s_bytes,
          "pass_device_ms": pass_ms,
          "pass_bound_ms": 1e3 * (in_bytes + q_bytes + s_bytes) / HBM_BYTES_PER_S,
          "max_err_over_scale": worst, "ef_steps": DIST_EF_STEPS, "ef_rel_err": ef_rel})
    del grads, leaves, qs
    loss_sp, grads_sp = value_and_grad(params, batch, cfg.replace(seq_parallel=True))
    del grads_sp
    same = bool(torch.equal(loss_sp, loss))
    emit({"phase": "dist", "check": "seq_parallel", "arch": cfg.name, "loss": float(loss),
          "loss_seq_parallel": float(loss_sp), "equal_bits": same})
    if not same:
        raise AssertionError(f"seq_parallel changed the loss: {float(loss_sp)} against "
                             f"{float(loss)}")


def dist_restore(dev, mesh, ckpt: str, cfg, dc) -> None:
    """(a) The newest checkpoint in ``ckpt`` restored plainly and under the
    mesh's shardings (``param_shardings``, ``opt_state_shardings``: every
    stacked array distributed as a DTensor, the layer lists its slices):
    every leaf's ``full_tensor()`` equal to the plain restore's bit for bit,
    and ``loss_fn`` on the restored params, gathered with ``full_tensor()``,
    equal to the plain params' loss bit for bit. (The port's model code has
    no tensor-parallel form: DTensor's propagation through it stops at a
    view that flattens a sharded head dim, so the loss runs on the gathered
    params.)"""
    from repro_torch.dist.sharding import opt_state_shardings, param_shardings
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.train import checkpoint
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import init_opt_state, tree_leaves, tree_map

    step = checkpoint.latest_step(ckpt)
    like = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt_like = init_opt_state(like)
    t0 = time.perf_counter()
    p1, o1, _ = checkpoint.restore(ckpt, step, like, opt_like)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    psh, osh = param_shardings(like, mesh), opt_state_shardings(opt_like, mesh)
    t0 = time.perf_counter()
    p2, o2, _ = checkpoint.restore(ckpt, step, like, opt_like, shardings=psh, opt_shardings=osh)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    plain = tree_leaves(p1) + tree_leaves(o1.m) + tree_leaves(o1.v) + [o1.step]
    sharded = tree_leaves(p2) + tree_leaves(o2.m) + tree_leaves(o2.v) + [o2.step]
    for a, b in zip(plain, sharded):
        full = b.full_tensor()
        if full.dtype != a.dtype or not torch.equal(full, a):
            raise AssertionError(f"sharded restore: a {tuple(a.shape)} leaf differs")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(dc).batch_at(0).items()}
    with torch.no_grad():
        loss = loss_fn(p1, batch, cfg)
        t0 = time.perf_counter()
        loss_sh = loss_fn(tree_map(lambda t: t.full_tensor(), p2), batch, cfg)
        torch.cuda.synchronize()
        loss_sh_s = time.perf_counter() - t0
    same = bool(torch.equal(loss_sh, loss))
    w = p2["layers"][0]["mlp"]["w_gate"]
    emit({"phase": "dist", "check": "sharded_restore", "arch": cfg.name, "step": step,
          "mesh": "(1, 1) data x model, nccl world 1", "leaves": len(plain),
          "w_gate_placements": str(w.placements),
          "w_down_moment_spec": str(osh.m["layers"]["mlp"]["w_down"].spec),
          "restore_plain_s": plain_s, "restore_sharded_s": sharded_s, "loss": float(loss),
          "loss_sharded": float(loss_sh), "loss_sharded_s": loss_sh_s, "equal_bits": same})
    if not same:
        raise AssertionError(f"sharded restore: loss {float(loss_sh)} against {float(loss)}")


def dist_phase(dev) -> None:
    """``--dist``: the dist checks alone. (b) and (c) on internvl2-2b at full
    width with seeded weights over the train phase's last batch; (a) on a
    checkpoint of the ~125 M llama written by two steps of ``train.loop.run``."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.model import init_params
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.loop import TrainConfig, run
    from repro_torch.train.optimizer import AdamWConfig

    reset_launches()
    with dist_group(dev) as mesh:
        cfg = get_config(TRAIN_ARCH)
        free_card(f"{TRAIN_ARCH} dist checks")
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH))
        gen = torch.Generator(device=dev).manual_seed(7)
        batch, _ = train_batch(cfg, data, TRAIN_STEPS, gen, dev)
        dist_grads(cfg, params, batch)
        del params, batch
        torch.cuda.empty_cache()
        cfg = get_config("llama3-8b", smoke=True).replace(**LLAMA_100M)
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=RESUME_SEQ, global_batch=RESUME_BATCH)
        ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            run(cfg, dc, TrainConfig(steps=2, ckpt_dir=ckpt, ckpt_every=RESUME_STEPS, log_every=0,
                                     opt=AdamWConfig(warmup_steps=1, total_steps=2)),
                log=lambda *a: None, device=dev)
            dist_restore(dev, mesh, ckpt, cfg, dc)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
    if any(launch_counts().values()):
        raise AssertionError(f"the dist checks launched kernels: {launch_counts()}")


# ---------------------------------------------------------------------------
# the launch tooling's cost count and the llama3-8b decode_32k rank cell
# ---------------------------------------------------------------------------

RANK_ARCH, RANK_SHAPE = "llama3-8b", "decode_32k"
RANK_STEPS = 10
# ((K, N), B): tests/test_kernels.py's W8A8 case, and llama3-8b's w_up at 4 slots
W8A8_SHAPES = (((256, 512), 4), ((4096, 14336), SLOTS))
QUANT_ERROR_MAX = 0.02  # tests/test_kernels.py's bound on W8A8's relative error


def check_w8a8(gen, dev) -> None:
    """B3 through ``quant.w8a8_linear`` on the card, bit for bit its plain
    version (``use_kernel=False``) on the same operands; ``quant_error`` on the
    card under :data:`QUANT_ERROR_MAX`."""
    from repro_torch.core import quant
    from repro_torch.kernels import launch_counts

    cases = []
    for (k, n), b in W8A8_SHAPES:
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        x = torch.randn((b, k), generator=gen, device=dev)
        ql = quant.quantize_weight(w)
        before = launch_counts()["pim_gemv"]
        y = quant.w8a8_linear(ql, x)
        want = quant.w8a8_linear(ql, x, use_kernel=False)
        torch.cuda.synchronize()
        if launch_counts()["pim_gemv"] != before + 1 or not torch.equal(y, want):
            raise AssertionError(f"w8a8_linear ({k} -> {n}) x B {b}: the kernel's result "
                                 f"differs from its plain version or it did not launch once")
        err = quant.quant_error(w, x, device=dev)
        if not err < QUANT_ERROR_MAX:
            raise AssertionError(f"quant_error {err} at ({k} -> {n}) is not below "
                                 f"{QUANT_ERROR_MAX}")
        cases.append({"k": k, "n": n, "b": b, "bit_exact": True, "quant_error": err})
    emit({"phase": "kernel_check", "kernel": "pim_gemv via quant.w8a8_linear", "cases": cases})


def check_rank_attention(cfg, cache, gen, dev) -> float:
    """B4 at the rank cell's shape (layer 0's lanes, Lmax 32,768 in 128
    chunks) against its plain version, and each lane alone against the batch."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    k, v = cache["k"][0], cache["v"][0]
    b, hkv, hd, lmax = k.shape
    q = torch.randn((b, hkv, cfg.q_per_kv, hd), generator=gen, device=dev).to(torch.bfloat16)
    end = torch.full((b,), lmax, dtype=torch.int32, device=dev)
    scale = hd ** -0.5
    out = da.decode_attention(q, k, v, end, scale=scale)
    want = ref.decode_attention_ref(q, k, v, end, scale)
    torch.cuda.synchronize()
    err = _allclose(f"decode_attention rank cell lmax={lmax}", out, want)
    check_batch_invariant(f"decode_attention rank cell lmax={lmax}",
                          lambda i: da.decode_attention(q[i], k[i], v[i], end[i], scale=scale),
                          out, b)
    emit({"phase": "kernel_check", "kernel": "decode_attention (contiguous)",
          "cases": [[RANK_ARCH, hkv, cfg.q_per_kv, hd, lmax, None, "batch invariant",
                     [lmax] * b]], "cache": "bf16", "rtol": ATTN_RTOL, "atol": ATTN_ATOL,
          "max_abs_err": err})
    return err


def time_rank_attention(cfg, cache, dev) -> None:
    """B4 at the rank cell's shape, cycling the 32 layers' lanes (1.07 GB
    each): the kernel, its plain version, SDPA (GQA, K made row-wise) and B4
    over four layers' lanes in fp8 e4m3."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    gen = torch.Generator(device=dev).manual_seed(25)
    k_all, v_all = cache["k"], cache["v"]
    _, b, hkv, hd, lmax = k_all.shape
    g = cfg.q_per_kv
    q = torch.randn((b, hkv, g, hd), generator=gen, device=dev).to(torch.bfloat16)
    end = torch.full((b,), lmax, dtype=torch.int32, device=dev)
    start = torch.zeros_like(end)
    scale = hd ** -0.5
    out_bytes = b * hkv * g * hd * 4
    lanes = list(zip(k_all, v_all))
    bnd, by = attn_bound(end, start, out_bytes, hkv=hkv, g=g, hd=hd)
    qh = q.reshape(b, hkv * g, 1, hd)
    sdpa = [(k.transpose(-1, -2).contiguous(), v) for k, v in lanes[:2]]
    row = {"ms": cuda_ms([lambda kv=kv: da.decode_attention(q, *kv, end, scale=scale)
                          for kv in lanes], len(lanes)),
           "plain_ms": cuda_ms([lambda kv=kv: ref.decode_attention_ref(q, *kv, end, scale)
                                for kv in lanes[:2]], 2),
           "library_ms": library_ms("decode_attention", [
               lambda kv=kv: F.scaled_dot_product_attention(qh, *kv, scale=scale,
                                                            enable_gqa=True)
               for kv in sdpa], 8),
           "bound_ms": bnd, "bound_by": by}
    del sdpa
    emit({"phase": "kernel_time", "kernel": "decode_attention", "shape": "rank cell",
          "q": [b, hkv, g, hd], "lmax": lmax, "live_tokens": live_tokens(end, start), **row,
          "roofline_share": bnd / row["ms"]})
    f8 = [(k.to(F8), v.to(F8)) for k, v in lanes[:4]]
    bnd, by = attn_bound(end, start, out_bytes, hkv=hkv, g=g, hd=hd, kv_bytes=1)
    ms = cuda_ms([lambda kv=kv: da.decode_attention(q, *kv, end, scale=scale) for kv in f8],
                 16)
    emit({"phase": "kernel_time", "kernel": "decode_attention", "shape": "rank cell",
          "kv": "fp8 e4m3", "q": [b, hkv, g, hd], "lmax": lmax,
          "live_tokens": live_tokens(end, start), "ms": ms, "bf16_ms": row["ms"],
          "plain_ms": cuda_ms([lambda kv=kv: ref.decode_attention_ref(q, *kv, end, scale)
                               for kv in f8[:2]], 2),
          "library_ms": None, "bound_ms": bnd, "bound_by": by, "roofline_share": bnd / ms})


# ---------------------------------------------------------------------------
# the partitioned program (models.model.decode_step/prefill with mesh=)
# ---------------------------------------------------------------------------

# the archs of --partitioned; the default run drives llama3-8b (RANK_ARCH)
PART_ARCHS = ("gemma2-27b", "internvl2-2b", "seamless-m4t-large-v2")
# (a): full width, f32, depth cut: llama3-8b's decode ranks 4 of its 32 layers,
# every other run PTRAIN_LAYERS (gemma2's local + global pair; seamless as many
# encoder layers); PART_LANES rows of PART_PROMPT tokens (internvl2-2b behind
# its 256-token image prefix; seamless a one-token decoder input over PART_SRC
# frames) into lanes of PART_LMAX slots (the prefix, the prompt and the steps),
# then PART_STEPS greedy steps
PART_LAYERS = 4
PART_LANES, PART_LMAX, PART_PROMPT, PART_SRC, PART_STEPS = 4, 512, 64, 256, 8
PART_MESH = (1, 2)     # (data, model): two gloo ranks on the one card
# the ranks' row-parallel products add their halves in another order than
# the unsharded program's: f32 rounding, a few ulps of the logits' scale
PART_RTOL, PART_ATOL = 1e-4, 1e-4
# (c): gemma2-27b's rank holds 8 lanes of 12.35 GB (46 layers x 16 KV heads x
# 32,768 slots x 128, K and V, bf16) beside 3.40 GB of weights: the card runs
# 4 of them, and meta counts 4
RANK_CELL_LANES = {"gemma2-27b": 4}
GEMMA2_LOCAL = 4096   # gemma2-27b's sliding window: a local layer's live range


def part_cfg(arch: str, layers: int):
    """``arch`` at full width, f32, cut to ``layers`` layers (the audio
    encoder too)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch).replace(n_layers=layers, dtype="float32", param_dtype="float32")
    return cfg.replace(n_encoder_layers=layers) if cfg.family == "audio" else cfg


def part_inputs(cfg, rng, rows: int, seq: int, train: bool = False) -> dict:
    """A seeded global batch (numpy) of ``rows`` rows: ``seq`` tokens
    (audio's decoder input one token, unless ``train``), with ``labels`` for
    ``train``; a vlm's image prefix (N(0, 0.02²), the embeddings' scale) or
    audio's frames (N(0, 1); ``seq`` of them in the train step,
    :data:`PART_SRC` in the prefill)."""
    n = seq if train or cfg.family != "audio" else 1
    out = {"tokens": rng.integers(1, cfg.vocab_size, (rows, n))}
    if train:
        out["labels"] = rng.integers(0, cfg.vocab_size, (rows, n))
    if cfg.family == "vlm":
        out["prefix_embeds"] = (rng.standard_normal((rows, cfg.n_prefix_tokens, cfg.d_model))
                                * 0.02).astype(np.float32)
    if cfg.family == "audio":
        frames = seq if train else PART_SRC
        out["src_frames"] = rng.standard_normal((rows, frames, cfg.d_model)).astype(np.float32)
    return out


def rank_window(cfg) -> tuple[int, int, int]:
    """The partitioned rank cell's B4 launch, as the program sets it: rank
    0 of (data 16, model 16) holds ``hq`` query heads and reads the KV heads
    ``[j0, j1)`` (``models.attention.kv_window``); llama3-8b: 2 query heads,
    half of KV head 0's group of 4; gemma2-27b: 2 query heads, KV head 0's
    whole group. Returns (j0, j1, hq)."""
    from repro_torch.dist.collectives import TensorParallel
    from repro_torch.launch.mesh import production_mesh_for_counting
    from repro_torch.models.attention import kv_window

    with production_mesh_for_counting() as mesh:
        tp = TensorParallel(mesh)
        hq = cfg.n_heads // tp.size
        return (*kv_window(cfg, hq, tp), hq)


def live_range(cfg, k, window: int | None):
    """(end, start, scale, softcap) of B4 over full lanes ``k`` (B, Hkv,
    hd, Lmax): a local layer's live range ``[Lmax - window, Lmax)``, or all
    of it; ``cfg``'s scale and softcap."""
    b, _, hd, lmax = k.shape
    end = torch.full((b,), lmax, dtype=torch.int32, device=k.device)
    start = end - (window or lmax)
    return end, start, cfg.attn_scale_override or hd ** -0.5, cfg.attn_softcap


def check_window_attention(cfg, cache, gen, dev, window: int | None = None) -> float:
    """(b) B4 over a window of KV heads of the rank cell's lanes (layer 0,
    every lane full, live range :func:`live_range`): the partitioned rank
    cell's own launch (:func:`rank_window`; ``k[:, 0:1]`` under 2 query
    heads), one head with its whole query group (``k[:, 3:4]``) and two
    heads with half a group each, each against the plain version over the
    same window at the B4 tolerance. The window is read in place: the call
    may not raise the peak allocated memory by an eighth of the window's
    bytes."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    k, v = cache["k"][0], cache["v"][0]
    b, _, hd, lmax = k.shape
    end, start, scale, cap = live_range(cfg, k, window)
    r0, r1, hq = rank_window(cfg)
    cases, err = [], 0.0
    for j0, j1, g in ((r0, r1, hq // (r1 - r0)), (3, 4, cfg.q_per_kv),
                      (2, 4, max(cfg.q_per_kv // 2, 1))):
        kw, vw = k[:, j0:j1], v[:, j0:j1]
        q = torch.randn((b, j1 - j0, g, hd), generator=gen, device=dev).to(torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = da.decode_attention(q, kw, vw, end, start, scale=scale, softcap=cap)
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated() - base
        nbytes = 2 * kw.numel() * kw.element_size()
        if rise >= nbytes // 8:
            raise AssertionError(f"B4 over the window [{j0}, {j1}) raised the peak memory by "
                                 f"{rise} B against a {nbytes} B window: a copy")
        name = f"decode_attention {cfg.name} window [{j0}, {j1}) G {g} lmax={lmax}"
        err = max(err, _allclose(name, out, ref.decode_attention_ref(q, kw, vw, end, scale, cap,
                                                                     start=start)))
        cases.append([cfg.name, [j0, j1], g, hd, lmax, b, rise, nbytes])
    emit({"phase": "kernel_check", "kernel": "decode_attention (head window)",
          "cases": cases, "case_keys": ["arch", "heads", "g", "hd", "lmax", "lanes",
                                        "peak_rise_B", "window_B"],
          "live": [lmax - (window or lmax), lmax], "softcap": cap, "scale": scale,
          "cache": "bf16", "rtol": ATTN_RTOL, "atol": ATTN_ATOL, "max_abs_err": err})
    return err


def time_window_attention(cfg, cache, dev, window: int | None = None) -> dict:
    """B4 at the partitioned rank cell's own launch (:func:`rank_window`:
    its query heads over its KV-head window) over each layer's lanes, every
    lane full, live range :func:`live_range`: the kernel cycling over every
    layer's window; its plain version and SDPA (GQA, the live range's K made
    row-wise, no softcap) each cycling over as many layers' windows as keep
    their reads out of L2 (:func:`copies_for`, at most every layer), so
    that no number is served from L2. Emits a ``kernel_time`` line and
    returns its row."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    gen = torch.Generator(device=dev).manual_seed(27)
    j0, j1, hq = rank_window(cfg)
    wins = [(k[:, j0:j1], v[:, j0:j1]) for k, v in zip(cache["k"], cache["v"])]
    k0 = wins[0][0]
    b, hkv, hd, lmax = k0.shape
    g = hq // hkv
    end, start, scale, cap = live_range(cfg, k0, window)
    lo = lmax - (window or lmax)
    n = min(len(wins), copies_for(2 * b * hkv * (lmax - lo) * hd * k0.element_size()))
    q = torch.randn((b, hkv, g, hd), generator=gen, device=dev).to(torch.bfloat16)
    bnd, by = attn_bound(end, start, b * hq * hd * 4, hkv=hkv, g=g, hd=hd)
    qh = q.reshape(b, hq, 1, hd)
    sdpa = [(k[..., lo:].transpose(-1, -2).contiguous(), v[:, :, lo:]) for k, v in wins[:n]]
    row = {"ms": cuda_ms([lambda kv=kv: da.decode_attention(q, *kv, end, start, scale=scale,
                                                             softcap=cap)
                          for kv in wins], len(wins)),
           "plain_ms": cuda_ms([lambda kv=kv: ref.decode_attention_ref(q, *kv, end, scale, cap,
                                                                       start=start)
                                for kv in wins[:n]], n),
           "library_ms": library_ms("decode_attention", [
               lambda kv=kv: F.scaled_dot_product_attention(qh, *kv, scale=scale,
                                                            enable_gqa=True)
               for kv in sdpa], max(8, n)),
           "bound_ms": bnd, "bound_by": by}
    del sdpa
    emit({"phase": "kernel_time", "kernel": "decode_attention", "shape": "rank window",
          "arch": cfg.name, "q": [b, hkv, g, hd], "lmax": lmax, "window": [j0, j1],
          "live": [lo, lmax], "live_tokens": live_tokens(end, start), "softcap": cap,
          "library": "SDPA, no softcap", "b4_layers": len(wins), "plain_sdpa_layers": n,
          **row, "roofline_share": bnd / row["ms"], "gpu": nvidia_smi()})
    return row


def partitioned_rank_cell(cfg, dev, lanes: int | None = None, with_cache=None) -> int:
    """(c) The partitioned ``decode_32k`` rank of ``cfg``: rank 0 of (data
    16, model 16) on a ``fake`` group
    (``launch.mesh.production_mesh_for_counting``), full width and depth,
    built by ``launch.hillclimb.rank_cell(mesh=)``: 1/16 of the weights,
    ``lanes`` of every KV head (default the cell's 8), B4 over its KV-head
    window. Its ``CostCounter`` and ``CollectiveCounter`` counts on the card
    must equal ``meta``'s at the same lanes (``hillclimb.partitioned_count``);
    ``with_cache(cfg, cache)`` then runs over the cell's lanes; then
    :data:`RANK_STEPS` steps eager after a warm-up and captured
    (``hillclimb.captured_step``), exactly (layers) x (2 :data:`RANK_STEPS`
    + 3) B4 launches (the fake collectives move nothing, so the step is the
    rank's compute). Returns its B4 launches."""
    from repro_torch.dist.collectives import CollectiveCounter
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch import costrun, hillclimb
    from repro_torch.launch.mesh import production_mesh_for_counting

    lanes = lanes or hillclimb.rank_batch(RANK_SHAPE)
    j0, j1, _ = rank_window(cfg)
    free_card(f"the partitioned rank cell of {cfg.name}")
    with production_mesh_for_counting() as mesh:
        params, step, cache = hillclimb.rank_cell(cfg, RANK_SHAPE, dev, mesh=mesh, lanes=lanes)
        cache_gb = sum(t.numel() * t.element_size() for k, t in cache.items()
                       if k != "pos") / 1e9
        with CollectiveCounter() as coll:
            card = costrun.count(step)
        card["collectives"] = coll.totals()
        card["collective_calls"] = card["collectives"].pop("_counts")
        meta = hillclimb.partitioned_count(cfg, RANK_SHAPE, lanes=lanes)
        if card != meta:
            raise AssertionError(f"{cfg.name}: the partitioned rank cell counts differently "
                                 f"on the card and on meta: {card} != {meta}")
        if with_cache is not None:
            with_cache(cfg, cache)
        reset_launches()
        timed = hillclimb.time_steps(step, RANK_STEPS)
        captured = hillclimb.time_steps(hillclimb.captured_step(cfg, params, cache, mesh),
                                        RANK_STEPS, warmup=2)
        counts = launch_counts()
        del params, step, cache
    steps = 2 * RANK_STEPS + 3
    if counts != {**{k: 0 for k in counts}, "decode_attention": cfg.n_layers * steps}:
        raise AssertionError(f"{cfg.name}: the partitioned rank cell's steps launched "
                             f"{counts}, not {cfg.n_layers} x {steps} decode_attention")
    t = hillclimb.terms(meta)
    emit({"phase": "rank_cell", "partitioned": True, "arch": cfg.name, "shape": RANK_SHAPE,
          "mesh": {"data": 16, "model": 16}, "rank": 0, "batch": lanes,
          "kv_heads_read": j1 - j0, "cache_GB": cache_gb, "gpu": nvidia_smi(),
          "step_ms": timed["step_ms"], "steps_ms": timed["steps_ms"],
          "peak_GB": timed["peak_gb"], "captured_step_ms": captured["step_ms"],
          "captured_steps_ms": captured["steps_ms"], "captured_peak_GB": captured["peak_gb"],
          "captured_roofline_share": 1e3 * t["t_memory_s"] / captured["step_ms"],
          "roofline_share": 1e3 * t["t_memory_s"] / timed["step_ms"],
          "launches": counts, "count_card": card, "count_meta_equal": True,
          "t_compute_ms": 1e3 * t["t_compute_s"], "t_memory_ms": 1e3 * t["t_memory_s"],
          "t_collective_ms": 1e3 * t["t_collective_s"]})
    free_card(f"after the partitioned rank cell of {cfg.name}")
    return counts["decode_attention"]


def partitioned_ranks(dev, archs=(RANK_ARCH,)) -> int:
    """(a) Two processes on the one card in a ``gloo`` group on a ``file://``
    store (``launch.mesh.spawn``), mesh :data:`PART_MESH`, run the
    partitioned program (``launch.partitioned.rank_run``) of each of
    ``archs`` at full width (:func:`part_cfg`: llama3-8b
    :data:`PART_LAYERS` layers, the others :data:`PTRAIN_LAYERS`), f32
    params from seed 0, a prefill of :func:`part_inputs` into lanes of
    :data:`PART_LMAX` slots, then :data:`PART_STEPS` greedy steps. Their
    logits (a vocab that 2 divides gathered by the ranks' coordinates;
    internvl2-2b's 92,553 and seamless's 256,206 come gathered from every
    rank, GSPMD's padded vocab), greedy tokens and caches (audio's cross
    K/V too) are held to the unsharded program on the card (the same seed)
    at :data:`PART_RTOL`/:data:`PART_ATOL`, each rank's
    ``CollectiveCounter`` count to the ``meta`` count of the same drive over
    a ``fake`` group, its launches to (layers) x :data:`PART_STEPS` B4. A
    rank that fails fails the run. Returns the ranks' B4 launches."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import partitioned
    from repro_torch.models.model import init_params

    rng = np.random.default_rng(27)
    jobs = [(cfg, 0, part_inputs(cfg, rng, PART_LANES, PART_PROMPT))
            for cfg in (part_cfg(a, PART_LAYERS if a == RANK_ARCH else PTRAIN_LAYERS)
                        for a in archs)]
    free_card("the partitioned ranks")
    t0 = time.perf_counter()
    ranks = mesh_lib.spawn(partitioned.rank_run, math.prod(PART_MESH), jobs, [PART_MESH],
                           PART_LMAX, PART_STEPS, dev.type)
    wall = time.perf_counter() - t0
    launches = 0
    for ji, (cfg, _, inputs) in enumerate(jobs):
        arch = cfg.name
        runs = sorted((r[ji][0] for r in ranks), key=lambda r: r["coords"]["model"])
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        batch = partitioned.batch_on(inputs, dev)
        with torch.no_grad():
            logits, tokens, cache = partitioned.generate(params, batch.pop("tokens"), cfg,
                                                         PART_LMAX, PART_STEPS, **batch)
        err = 0.0
        for j, w in enumerate(logits):
            w = w.float().cpu()
            parts = [torch.from_numpy(r["logits"][j]) for r in runs]
            gathered = parts[0].shape[-1] == cfg.vocab_size
            for got in (parts if gathered else [torch.cat(parts, dim=-1)]):
                err = max(err, float((got - w).abs().max()))
                if not torch.allclose(got, w, rtol=PART_RTOL, atol=PART_ATOL):
                    raise AssertionError(f"{arch}: partitioned logits of step {j}: max |err| "
                                         f"{err} outside rtol={PART_RTOL} atol={PART_ATOL}")
        cache_err = 0.0
        for r in runs:
            if not np.array_equal(r["tokens"], tokens.cpu().numpy()):
                raise AssertionError(f"{arch} rank {r['coords']}: greedy tokens "
                                     f"{r['tokens'].tolist()} != the unsharded program's "
                                     f"{tokens.tolist()}")
            for key in (k for k in cache if k != "pos"):
                want = cache[key].float().cpu().numpy()
                cache_err = max(cache_err, float(np.abs(r[key] - want).max()))
                if not np.allclose(r[key], want, rtol=PART_RTOL, atol=PART_ATOL):
                    raise AssertionError(f"{arch} rank {r['coords']}: its {key} differs from "
                                         f"the unsharded program's by {cache_err}")
        del params, logits, cache
        prompt = inputs["tokens"].shape[1]
        extra = {k: v.shape for k, v in inputs.items() if k != "tokens"}
        meta = partitioned.count_run(cfg, PART_MESH, PART_LANES, prompt, PART_LMAX,
                                     PART_STEPS, extra)
        want = {**{k: 0 for k in runs[0]["launches"]},
                "decode_attention": cfg.n_layers * PART_STEPS}
        for r in runs:
            if r["collectives"] != meta:
                raise AssertionError(f"{arch} rank {r['coords']} counted {r['collectives']}, "
                                     f"meta {meta}")
            if r["launches"] != want:
                raise AssertionError(f"{arch} rank {r['coords']} launched {r['launches']}, "
                                     f"not {cfg.n_layers} x {PART_STEPS} decode_attention")
        launches += len(runs) * want["decode_attention"]
        emit({"phase": "partitioned", "arch": arch, "layers": cfg.n_layers,
              "encoder_layers": cfg.n_encoder_layers if cfg.family == "audio" else None,
              "dtype": "float32", "mesh": dict(zip(partitioned.AXES, PART_MESH)),
              "backend": "gloo (one card)", "lanes": PART_LANES, "lmax": PART_LMAX,
              "prompt": prompt, "inputs": {k: list(v) for k, v in extra.items()},
              "steps": PART_STEPS, "vocab": cfg.vocab_size,
              "logits_gathered": cfg.vocab_size % PART_MESH[1] != 0, "tokens_equal": True,
              "logits_max_abs_err": err, "cache_max_abs_err": cache_err,
              "rtol": PART_RTOL, "atol": PART_ATOL, "collectives": meta,
              "collectives_meta_equal": True,
              "launches": len(runs) * want["decode_attention"], "wall_s": wall,
              "gpu": nvidia_smi()})
        free_card(f"after the partitioned ranks' check of {arch}")
    return launches


# ---------------------------------------------------------------------------
# the partitioned train step (train.train_step.train_step with mesh=)
# ---------------------------------------------------------------------------

PTRAIN_LAYERS = 2               # (a): full width, 2 layers, f32
PTRAIN_BATCH, PTRAIN_SEQ, PTRAIN_ACCUM, PTRAIN_STEPS = 4, 256, 2, 2
PTRAIN_MESHES = ((1, 2), (2, 1))   # (data, model): two gloo ranks on the one card
# gemma2-27b's 2 f32 layers hold 9.3 GB of params, and on (2, 1) each rank
# holds the whole tree beside its moments and gradient sums (llama3-8b's
# ranks of --dist peak at 5.6x their params): two such ranks overfill the
# one card, so gemma2 trains on (1, 2) alone there (its (2, 1) mesh runs in
# the CPU tests)
PTRAIN_MESHES_OF = {"gemma2-27b": ((1, 2),)}
# the ranks' products and reductions add in another order than the unsharded
# step's: f32 rounding of the metrics, and of each leaf against its max |x|
PTRAIN_RTOL = 1e-4
TRAIN_CELL_SHAPE = "train_4k"
TRAIN_CELL_STEPS = 3


def partitioned_train_ranks(dev, archs=(RANK_ARCH,)) -> None:
    """(a) of the train step: for each of ``archs``, two processes on the
    one card in a ``gloo`` group (``launch.mesh.spawn``) run
    ``launch.partitioned.train_run`` at full width cut to
    :data:`PTRAIN_LAYERS` layers (:func:`part_cfg`), f32 params from seed 0,
    ``remat`` on as the full configs set it, a seeded global batch of
    :data:`PTRAIN_BATCH` x :data:`PTRAIN_SEQ` tokens (:func:`part_inputs`:
    with a vlm's prefix or audio's frames) at :data:`PTRAIN_ACCUM`
    microbatches, :data:`PTRAIN_STEPS` steps, on each mesh of
    :data:`PTRAIN_MESHES` (:data:`PTRAIN_MESHES_OF`). Rank 0 first runs the
    unsharded in-place step on the card from the same params and batch:
    every rank's metrics are held to it, and so are the params and moments
    gathered back with ``dist.sharding.full_tree`` (each leaf's max |err|
    over its max |x|); each rank's ``CollectiveCounter`` count to
    ``count_train_run``'s ``meta`` count; no kernel launches. A rank that
    fails fails the run. A ``partitioned_train`` line an arch and mesh."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import partitioned

    rng = np.random.default_rng(28)
    for arch in archs:
        cfg = part_cfg(arch, PTRAIN_LAYERS)
        batch = part_inputs(cfg, rng, PTRAIN_BATCH, PTRAIN_SEQ, train=True)
        meshes = PTRAIN_MESHES_OF.get(arch, PTRAIN_MESHES)
        extra = {k: v.shape for k, v in batch.items() if k not in ("tokens", "labels")}
        free_card(f"the partitioned train ranks of {arch}")
        t0 = time.perf_counter()
        ranks = mesh_lib.spawn(partitioned.train_run, 2, [(cfg, 0, batch)], list(meshes),
                               PTRAIN_STEPS, PTRAIN_ACCUM, dev.type, reference=True)
        wall = time.perf_counter() - t0
        for mi, shape in enumerate(meshes):
            runs = [r[0][mi] for r in ranks]
            want = runs[0]["metrics_ref"]
            meta = partitioned.count_train_run(cfg, shape, PTRAIN_BATCH, PTRAIN_SEQ,
                                               PTRAIN_STEPS, PTRAIN_ACCUM, extra)
            metric_err = 0.0
            for r in runs:
                for got, ref in zip(r["metrics"], want):
                    for k in ("loss", "grad_norm", "lr"):
                        rel = abs(got[k] - ref[k]) / abs(ref[k])
                        metric_err = max(metric_err, rel)
                        if rel > PTRAIN_RTOL:
                            raise AssertionError(f"{arch} rank {r['coords']} on {shape}: {k} "
                                                 f"{got[k]} against the unsharded {ref[k]}")
                if r["collectives"] != meta:
                    raise AssertionError(f"{arch} rank {r['coords']} on {shape} counted "
                                         f"{r['collectives']}, meta {meta}")
                if any(r["launches"].values()):
                    raise AssertionError(f"{arch} rank {r['coords']} launched {r['launches']}")
            errors = runs[0]["errors"]
            for name, e in errors.items():
                if e["max_err_over_max"] > PTRAIN_RTOL:
                    raise AssertionError(f"{arch} on {shape}: the gathered {name} differ from "
                                         f"the unsharded step's by {e}")
            emit({"phase": "partitioned_train", "arch": arch, "layers": cfg.n_layers,
                  "dtype": "float32", "remat": cfg.remat,
                  "mesh": dict(zip(partitioned.AXES, shape)), "backend": "gloo (one card)",
                  "batch": PTRAIN_BATCH, "seq": PTRAIN_SEQ,
                  "inputs": {k: list(v) for k, v in extra.items()},
                  "accum": PTRAIN_ACCUM, "steps": PTRAIN_STEPS, "metrics": runs[0]["metrics"],
                  "metrics_unsharded": want, "metrics_max_rel_err": metric_err,
                  "errors": errors, "rtol": PTRAIN_RTOL, "collectives": meta,
                  "collectives_meta_equal": True, "launches": 0,
                  "rank_wall_s": [r["wall_s"] for r in runs],
                  "rank_check_s": [r["check_s"] for r in runs],
                  "rank_peak_GB": [r["peak_gb"] for r in runs],
                  "param_bytes": [r["param_bytes"] for r in runs],
                  "moment_bytes": [r["moment_bytes"] for r in runs],
                  "wall_s": wall, "gpu": nvidia_smi()})


def partitioned_train_cell(dev, arch: str = RANK_ARCH) -> None:
    """(c) of the train step, ``--cost`` only (``--partitioned`` runs it for
    gemma2-27b): the partitioned ``train_4k`` rank, rank 0 of (data 16,
    model 16) on a ``fake`` group (``launch.hillclimb.rank_cell(...,
    mesh=)``): 1/16 of ``arch``'s bf16 weights, its 1/256 ZeRO-1 slice of
    the moments, its 16 rows of 4,096 seeded tokens at the dry run's
    ``accum`` 4, ``remat`` on. Its
    ``CostCounter`` and ``CollectiveCounter`` counts on the card must equal
    ``meta``'s (``hillclimb.partitioned_count``); then :data:`TRAIN_CELL_STEPS`
    in-place steps eager after a warm-up and as many captured
    (``hillclimb.captured_train_step``: a first eager call, a capture, then
    replays), none launching a kernel. The fake collectives move nothing, so
    the step is the rank's compute; its outputs are not checked (the values
    of a fake reduction are whatever the buffer held). ``mfu`` = 6 x the
    rank's params x its 65,536 positions over the step and 989 TFLOP/s."""
    from repro_torch.configs import get_config
    from repro_torch.dist.collectives import CollectiveCounter
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch import costrun, dryrun, hillclimb, roofline
    from repro_torch.launch.mesh import production_mesh_for_counting

    cfg = get_config(arch)
    free_card(f"the partitioned train rank cell of {arch}")
    with production_mesh_for_counting() as mesh:
        params, step, state = hillclimb.rank_cell(cfg, TRAIN_CELL_SHAPE, dev, mesh=mesh)
        t0 = time.perf_counter()
        with CollectiveCounter() as coll:
            card = costrun.count(step)
        count_s = time.perf_counter() - t0
        card["collectives"] = coll.totals()
        card["collective_calls"] = card["collectives"].pop("_counts")
        meta = hillclimb.partitioned_count(cfg, TRAIN_CELL_SHAPE)
        if card != meta:
            raise AssertionError(f"the partitioned train rank cell counts differently on the "
                                 f"card and on meta: {card} != {meta}")
        reset_launches()
        timed = hillclimb.time_steps(step, TRAIN_CELL_STEPS)
        captured_step = hillclimb.captured_train_step(cfg, params, state, step.batch, mesh)
        captured = hillclimb.time_steps(captured_step, TRAIN_CELL_STEPS, warmup=2)
        graphs = captured_step.graphs.stats()
        counts = launch_counts()
        n = n_params(params)
        positions = step.batch["tokens"].numel()
        del params, step, state, captured_step
    if any(counts.values()):
        raise AssertionError(f"the partitioned train rank cell launched {counts}")
    t = hillclimb.terms(meta)

    def mfu(ms):
        return 6 * n * positions / (ms / 1e3) / roofline.PEAK_FLOPS

    emit({"phase": "rank_cell", "partitioned": True, "arch": arch,
          "shape": TRAIN_CELL_SHAPE, "mesh": {"data": 16, "model": 16}, "rank": 0,
          "rows": hillclimb.rank_batch(TRAIN_CELL_SHAPE), "positions": positions,
          "accum": dryrun.TRAIN_ACCUM, "remat": cfg.remat, "rank_params": n,
          "gpu": nvidia_smi(), "step_ms": timed["step_ms"], "steps_ms": timed["steps_ms"],
          "peak_GB": timed["peak_gb"], "captured_step_ms": captured["step_ms"],
          "captured_steps_ms": captured["steps_ms"], "captured_peak_GB": captured["peak_gb"],
          "graphs": graphs, "mfu": mfu(timed["step_ms"]),
          "captured_mfu": mfu(captured["step_ms"]), "launches": counts,
          "count_card": card, "count_meta_equal": True, "count_card_s": count_s,
          "t_compute_ms": 1e3 * t["t_compute_s"], "t_memory_ms": 1e3 * t["t_memory_s"],
          "t_collective_ms": 1e3 * t["t_collective_s"],
          "compute_share": 1e3 * t["t_compute_s"] / captured["step_ms"],
          "memory_share": 1e3 * t["t_memory_s"] / captured["step_ms"]})
    free_card("after the partitioned train rank cell")


def partitioned_phase(dev) -> dict:
    """``--partitioned``, for each arch of :data:`PART_ARCHS`: (a)
    :func:`partitioned_ranks` and :func:`partitioned_train_ranks`; (c) the
    ``decode_32k`` rank cells (:func:`partitioned_rank_cell`, gemma2-27b at
    :data:`RANK_CELL_LANES`), gemma2-27b's running (b) over its lanes: B4 at
    its rank launch, softcap 50.0, a local layer's live range
    (:data:`GEMMA2_LOCAL`) and a global one's, checked
    (:func:`check_window_attention`) and timed
    (:func:`time_window_attention`); (d) gemma2-27b's ``train_4k`` rank
    (:func:`partitioned_train_cell`). Returns B4's ``kernels`` row (the
    global launch's figures)."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device=dev).manual_seed(29)
    with phase_clock("partitioned_ranks"):
        launches = partitioned_ranks(dev, PART_ARCHS)
    with phase_clock("partitioned_train_ranks"):
        partitioned_train_ranks(dev, PART_ARCHS)
    b4 = {}

    def gemma2_b4(cfg, cache):
        for name, window in (("local", GEMMA2_LOCAL), ("global", None)):
            err = check_window_attention(cfg, cache, gen, dev, window)
            b4[name] = {**time_window_attention(cfg, cache, dev, window), "max_abs_err": err}

    with phase_clock("partitioned_rank_cells"):
        for arch in PART_ARCHS:
            launches += partitioned_rank_cell(get_config(arch), dev, RANK_CELL_LANES.get(arch),
                                              gemma2_b4 if arch == "gemma2-27b" else None)
    with phase_clock("partitioned_train_cell gemma2-27b"):
        partitioned_train_cell(dev, "gemma2-27b")
    row = b4["global"]
    src, replaces = KERNELS["decode_attention"]
    return {"name": "decode_attention", "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "work": f"gemma2-27b's partitioned rank launch: 2 query heads over KV head 0, "
                    f"{RANK_CELL_LANES['gemma2-27b']} lanes of 32,768 slots, a global layer, "
                    f"softcap 50.0 (library_ms: SDPA, no softcap); launches: the two gloo "
                    f"ranks' {PART_STEPS} steps of {PTRAIN_LAYERS} layers a rank for each of "
                    f"the three archs and the decode_32k rank cells' {2 * RANK_STEPS + 3} "
                    f"steps of 46, 24 and 24 layers"}


def cost_phase(dev) -> dict:
    """B3 through ``w8a8_linear``; then the rank cell
    (``launch.hillclimb.rank_cell``, as the hillclimb builds and fills it): B4
    checked at its shape and timed there (``time_rank_attention``), its
    ``CostCounter`` count on the card, which must equal the ``meta`` count of
    the same cell, its step's median ms over :data:`RANK_STEPS` steps after a
    warm-up (``launch.hillclimb.time_steps``; every launch counted, the
    warm-up's too), peak memory, and the meta count's roofline terms at the
    card's rates. Then the ``partitioned`` step: (b) B4 over head windows of
    the cell's lanes (``check_window_attention``, ``time_window_attention``),
    (c) the partitioned rank cell (``partitioned_rank_cell``) and (a) two
    gloo ranks on the card (``partitioned_ranks``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch import costrun, hillclimb

    gen = torch.Generator(device=dev).manual_seed(24)
    check_w8a8(gen, dev)
    free_card("the rank cell")
    cfg = get_config(RANK_ARCH)
    batch = hillclimb.rank_batch(RANK_SHAPE)
    params, step, cache = hillclimb.rank_cell(cfg, RANK_SHAPE, dev)
    err = check_rank_attention(cfg, cache, gen, dev)
    time_rank_attention(cfg, cache, dev)
    card = costrun.count(step)
    meta = costrun.count(costrun.build_cell(cfg, RANK_SHAPE, batch=batch))
    if card != meta:
        raise AssertionError(f"the rank cell counts differently on the card and on meta: "
                             f"{card} != {meta}")
    reset_launches()
    timed = hillclimb.time_steps(step, RANK_STEPS)
    # the same step through interleave's captured decode program: its first
    # call eager, its second captured, then replays timed
    captured = hillclimb.time_steps(hillclimb.captured_step(cfg, params, cache), RANK_STEPS,
                                    warmup=2)
    counts = launch_counts()
    layers = attention_layers(cfg)
    steps = 2 * RANK_STEPS + 3
    if counts != {**{k: 0 for k in counts}, "decode_attention": layers * steps}:
        raise AssertionError(f"the rank cell's steps launched {counts}, not "
                             f"{layers} x {steps} decode_attention")
    t = hillclimb.terms(meta)
    emit({"phase": "rank_cell", "arch": RANK_ARCH, "shape": RANK_SHAPE, "batch": batch,
          "lmax": cache["k"].shape[-1], "kv": str(cache["k"].dtype), "gpu": nvidia_smi(),
          "step_ms": timed["step_ms"], "steps_ms": timed["steps_ms"],
          "peak_GB": timed["peak_gb"], "captured_step_ms": captured["step_ms"],
          "captured_steps_ms": captured["steps_ms"], "captured_peak_GB": captured["peak_gb"],
          "captured_roofline_share": 1e3 * t["t_memory_s"] / captured["step_ms"],
          "launches": counts, "count_card": card, "count_meta_equal": True,
          "t_compute_ms": 1e3 * t["t_compute_s"], "t_memory_ms": 1e3 * t["t_memory_s"],
          "t_collective_ms": 1e3 * t["t_collective_s"],
          "roofline_share": 1e3 * t["t_memory_s"] / timed["step_ms"], "b4_max_abs_err": err})
    check_window_attention(cfg, cache, gen, dev)
    time_window_attention(cfg, cache, dev)
    del params, step, cache
    free_card("after the rank cell")
    b4 = counts["decode_attention"] + partitioned_rank_cell(cfg, dev)
    return {"decode_attention": b4 + partitioned_ranks(dev)}


def cost_sweep() -> None:
    """The 40-cell dry run and cost count on ``meta`` (no card), and the
    roofline table at the H100's rates."""
    from repro_torch.configs import SHAPES, list_archs
    from repro_torch.launch import costrun, dryrun, roofline

    costs, drs = {}, {}
    for arch in list_archs():
        for shape in SHAPES:
            drs[f"{arch}|{shape}|pod"] = dryrun.run_cell(arch, shape, False)
            costs[f"{arch}|{shape}"] = costrun.run_cell(arch, shape)
            emit({"phase": "cost_cell", "cell": f"{arch}|{shape}",
                  "status": costs[f"{arch}|{shape}"]["status"],
                  "dryrun": {k: drs[f"{arch}|{shape}|pod"].get(k)
                             for k in ("status", "memory", "cost", "collectives")},
                  "cost": {k: costs[f"{arch}|{shape}"].get(k)
                           for k in ("flops", "bytes", "transcendentals", "kernels")}})
    print(roofline.fmt_table(roofline.analyze(costs, drs)), flush=True)


def cost_hillclimb(dev) -> None:
    """``launch.hillclimb`` on the rank cell: bf16 K/V against fp8 e4m3 (the
    JAX package's ``kv_dtype="float8_e4m3fn"``), each counted and timed on the
    card (B4's fp8 lanes)."""
    from repro_torch.launch import hillclimb

    free_card("the hillclimb")
    rows = {}
    for name, change in (("bf16", None), ("fp8", {"kv_dtype": "float8_e4m3fn"})):
        rows[name] = hillclimb.measure(RANK_ARCH, RANK_SHAPE, change, "cuda")
        emit({"phase": "hillclimb", "kv": name, "gpu": nvidia_smi(), **rows[name]})
    dom = max(("t_compute_s", "t_memory_s", "t_collective_s"), key=lambda k: rows["bf16"][k])
    emit({"phase": "hillclimb_verdict", "dominant_term": dom,
          "delta_dominant": rows["fp8"][dom] / rows["bf16"][dom] - 1,
          "rank_cell_memory_ms": [1e3 * rows[k]["rank_cell"]["t_memory_s"] for k in rows],
          "card_step_ms": [rows[k]["card"]["step_ms"] for k in rows]})


# ---------------------------------------------------------------------------


KERNELS = {   # name -> (source, TPU kernel it replaces)
    "pim_gemv": ("src/repro_torch/kernels/pim_gemv/csrc/pim_gemv.cu",
                 "src/repro/kernels/pim_gemv/pim_gemv.py:55"),
    "decode_attention": (
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention_paged.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:102"),
    "decode_attention_paged": (
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention_paged.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:165"),
    "decode_attention_paged_split": (
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention_paged.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:309"),
    "merge_splits": (
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention_paged.cu",
        "src/repro/kernels/decode_attention/ref.py:72"),
    "ssd_scan": ("src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/ssd_scan.py:63"),
}


def main(argv: list[str]) -> int:
    if argv not in ([], ["--ab"], ["--attn"], ["--ssd"], ["--gemv"], ["--spec"],
                    ["--traffic"], ["--dense"], ["--moe"], ["--families"], ["--train"],
                    ["--dist"], ["--cost"], ["--graphs"], ["--partitioned"]):
        print(f"usage: {sys.argv[0]} [--ab | --attn | --ssd | --gemv | --spec | --traffic "
              f"| --dense | --moe | --families | --train | --dist | --cost | --graphs "
              f"| --partitioned]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    build_s = _build.build_all()
    ptxas = (_build.BUILD_DIR / "ptxas.log")
    print(ptxas.read_text() if ptxas.exists() else "", file=sys.stderr)
    emit({"phase": "env", "gpu": smi, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s})

    gen = torch.Generator(device=dev).manual_seed(1234)
    if argv == ["--attn"]:
        check_fp8_attention(gen, dev)
        time_attention(gen, dev)
        time_contig_attention(gen, dev)
        return 0
    if argv == ["--ssd"]:      # timed first, so a build that fails its check still has a time
        time_ssd_scan(gen, dev)
        check_ssd_scan(gen, dev)
        return 0
    if argv == ["--gemv"]:     # timed first, as --ssd
        time_pim_gemv(gen, dev)
        for shapes in ({"llama3-8b": [(n, k) for n, k, _ in GEMV_LAYER]}, DENSE_GEMV, MOE_GEMV,
                       FAMILY_GEMV):   # every serve shape at B 1 to 8
            time_gemv_shapes(shapes, gen, dev, batches=range(1, 9))
        check_pim_gemv(gen, dev)
        for shapes in (DENSE_GEMV, MOE_GEMV, FAMILY_GEMV):
            emit({"phase": "kernel_check", "kernel": "pim_gemv serve shapes",
                  "cases": check_gemv_exact(shapes, gen, dev)})
        return 0
    if argv in (["--spec"], ["--traffic"]):
        from repro_torch.configs import get_config
        from repro_torch.models.model import init_params

        cfg = get_config("llama3-8b").replace(quantized_decode=True)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        if argv == ["--spec"]:
            with phase_clock("spec_phase"):
                spec_phase(dev, cfg, params, ab=True)
        else:   # the full run's weights (the head is drawn after every layer), cut
            traffic_phase(dev, *cut_depth(cfg, params, TRAFFIC_LAYERS))
        return 0
    if argv == ["--ab"]:
        host_cost(gen, dev)
        serve_ab(dev)
        return 0
    if argv == ["--dense"]:
        check_dense_kernels(gen, dev)
        time_dense_attention(gen, dev)
        dense_phase(dev)
        return 0
    if argv == ["--moe"]:
        check_moe_kernels(gen, dev)
        time_moe_kernels(gen, dev)
        moe_phase(dev)
        return 0
    if argv == ["--families"]:
        check_family_kernels(gen, dev)
        time_family_kernels(gen, dev)
        families_phase(dev)
        return 0
    if argv == ["--train"]:
        with phase_clock("train_phase"):
            train_phase(dev, ab=True)
        return 0
    if argv == ["--dist"]:
        with phase_clock("dist_phase"):
            dist_phase(dev)
        with phase_clock("partitioned_train_ranks"):
            partitioned_train_ranks(dev)
        return 0
    if argv == ["--graphs"]:
        global GRAPHS_AB
        GRAPHS_AB = True
        for phase in (serve_phase, zamba2_phase, dense_phase, moe_phase, families_phase):
            torch.cuda.empty_cache()
            with phase_clock(phase.__name__):
                phase(dev)
        return 0
    if argv == ["--partitioned"]:
        emit({"kernels": [partitioned_phase(dev)]})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if argv == ["--cost"]:
        with phase_clock("cost_phase"):
            cost_phase(dev)
        with phase_clock("partitioned_train_cell"):
            partitioned_train_cell(dev)
        with phase_clock("cost_hillclimb"):
            cost_hillclimb(dev)
        with phase_clock("cost_sweep"):
            cost_sweep()
        return 0
    with phase_clock("kernel checks"):
        errs = {"pim_gemv": check_pim_gemv(gen, dev)["max_abs_err"],
                **check_attention(gen, dev),
                "decode_attention": check_contig_attention(gen, dev),
                "ssd_scan": check_ssd_scan(gen, dev)}
        for check in (check_fp8_attention, check_dense_kernels, check_moe_kernels,
                      check_family_kernels):
            for k, v in check(gen, dev).items():
                errs[k] = max(errs[k], v)
    with phase_clock("kernel times"):
        times = {"pim_gemv": time_pim_gemv(gen, dev), **time_attention(gen, dev),
                 "decode_attention": time_contig_attention(gen, dev),
                 "ssd_scan": time_ssd_scan(gen, dev)}
        time_dense_attention(gen, dev)
        time_moe_kernels(gen, dev)
        time_family_kernels(gen, dev)
        host_cost(gen, dev)

    counts: dict[str, int] = {}
    for phase in (serve_phase, zamba2_phase, dense_phase, moe_phase, families_phase,
                  train_phase, cost_phase):
        torch.cuda.empty_cache()
        with phase_clock(phase.__name__):   # serve_phase's includes spec and traffic
            for k, v in phase(dev).items():
                counts[k] = counts.get(k, 0) + v

    work = {"pim_gemv": f"the 7 decode GEMVs of one llama3-8b layer at B={SLOTS}; launches "
                        f"include the spec serves (draft and verify), the W8A8 dense "
                        f"serves (yi-9b, codeqwen1.5-7b, internvl2-2b), the W8A8 MoE "
                        f"serves (olmoe-1b-7b, phi3.5-moe: q/k/v/o only) and the "
                        f"model-level decodes (internvl2-2b, seamless-m4t-large-v2)",
            "decode_attention": f"one zamba2-7b shared-block layer, q ({ATTN_B},32,1,112), "
                                f"bf16 lanes of {CONTIG_LMAX}, end {ATTN_END}, "
                                f"start {ATTN_START}; launches include the llama3-8b "
                                f"decode_32k rank cell's steps of 32 at Lmax 32,768 "
                                f"(a warm-up and {RANK_STEPS} eager; a first call, a "
                                f"capture and {RANK_STEPS} captured), the partitioned "
                                f"rank cell's as many steps of 32 over its one-head "
                                f"windows, and the two gloo ranks' {PART_STEPS} steps of "
                                f"{PART_LAYERS} each (the partitioned program)",
            "decode_attention_paged": "one layer, q (4,8,4,128), bf16 pages of 8 tokens, "
                                      f"end {ATTN_END}, start {ATTN_START}",
            "decode_attention_paged_split": "as above, 4 splits (stage 1); library_ms is "
                                            "SDPA against stage 1 + merge together",
            "merge_splits": "as above, 4 splits (stage 2)",
            "ssd_scan": f"zamba2-7b's scan, B={SLOTS}, T={SSD_T}, H={SSD_H}, P={SSD_P}, "
                        f"N={SSD_N}, chunk {SSD_Q}, f32; on no model path (as in the JAX "
                        f"package), so 0 launches there; bound_ms from the bytes, above "
                        f"the chunked products at the kernel's sub-chunk as three TF32 "
                        f"products on the tensor cores; no PyTorch library call computes "
                        f"it (the model's own ssd_chunked is timed as chunked_torch_ms)"}
    rows = []
    for name, (src, replaces) in KERNELS.items():
        t = times[name]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": counts[name], "max_abs_err": errs[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "work": work[name]})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
