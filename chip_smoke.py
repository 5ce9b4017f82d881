#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MLego once on one GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card.  It
imports only ``repro_torch`` (from ``src/``), never JAX or ``repro``.
Phases, each of which fails the run if anything in it fails:

1. build  — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (first use builds them; the build time is printed);
2. kernels — call every kernel of the paths on the card at the main
   paths' shapes and at edge shapes, hold each against its plain PyTorch
   version at the stated tolerance, and time the kernel, the plain
   version and (where one exists) a single PyTorch call computing the
   same function, beside the least time the card could take.  The merge
   is held in its (n, K, V) form and in its parts form (n separate
   tensors, n = 1, 8 and 129: weights by value, and a pointer table on
   the device above 128 parts), five repeat calls giving the same bits.
   The batch merge of the paths (``merge_topics_parts_segments``: R
   separate parts in segments, by one pointer table) is held at K = 100,
   counts [1, 3, 8, 2] at V = 8,192 and [1, 32, 7, 129] at V = 141,043,
   equal bit for bit to the stacked ragged kernel and over five calls,
   and timed at V = 141,043.
   The sparse E-step runs on ``doc_term_csr(x)`` and is held against the
   dense plain version at D = 2,048 and 1,000 (both timed, with the
   conversion timed apart), an edge shape and two shapes whose documents
   overflow a CTA's row budget; five repeat calls give the same bits.  Both
   attention kernels are held and timed in bf16 (tensor cores: the SASS
   of every bf16 instance must contain HMMA or HGMMA, and five repeat
   calls must give the same bits) and in f32 (CUDA cores).  The Gibbs
   samplers' plain versions add the conditional in the kernels' warp-scan
   order, so every draw and count must be equal, and the counts must be
   conserved: the blocked sweep (one warp a document) on a 1,000-document
   window, on the same window with each block's documents interleaved and
   on an edge shape; the exact scan on a 1,000-document gap, on a stream of
   repeated words whose documents recur out of order and on an edge shape;
   five repeat calls give the same bits.  Each sweep's longest chain and
   its ns per chain step are printed, and one whole ``cgs_fit_blocked`` and
   one ``cgs_fit`` of a 1,000-document window are timed beside the sum of
   their sweep kernels' times.  The sLSTM scan is held on each of its
   three routes (``scan_plan``: a decode step, a thread block cluster
   per head, the cooperative kernel for an f32 R of 512), each timed at
   the served shape and giving the same bits on five calls; the route,
   cluster size and max active clusters of each case and each route's
   latency floor (its step with almost no work) are printed;
3. main path — at the default ``LDAConfig`` widths (K = 100, V = 8192)
   build 32 window models with ``train_range`` on the ``"device"``
   backend, answer a covered ``submit`` (merge only), a ``submit`` with
   half-window edges (gaps trained by the E-step kernel) and a
   ``submit_many`` of four specs (one ragged launch); every kernel's
   launch count must grow, no report may fall back, β must be finite
   with rows summing to 1, and the covered β and the four batch answers
   must match the ``"host"`` backend over the same store at 1e-5;
4. routes — a gap query on the ``"host"`` backend and a gap replayed on
   it after an injected device loss must both launch the E-step kernel;
5. the ``"gs"`` path — the same corpus and widths with collapsed Gibbs
   and the DSGS prior: 16 windows by ``train_range`` and the gaps of a
   ``submit`` with half-window edges train with the blocked sweep kernel,
   a covered ``submit`` and a ``submit_many`` merge, and a ``"host"`` gap
   query and a replay on ``"host"`` after an injected device loss train
   with the exact-scan kernel; the same checks as phase 3, and the
   covered β must fit the corpus better than uniform topics;
6. serve — the LM serving path at qwen3-1.7b's full width (28 layers,
   d_model 2,048, 16 query and 8 KV heads of 128, vocab 152,064 padded,
   bf16, random weights from ``torch.Generator`` seed 0): one batch of 4
   prompts of 2,048 tokens (``make_batch``) through
   ``repro_torch.launch.serve.generate`` with a 2,112-position cache and
   64 greedy decode steps; exactly 28 flash launches for the prefill and
   28 decode launches per step, finite logits, tokens in the padded
   vocabulary, and, with the same weights in float32, decode_step after a
   2,048-token prefill must equal a 2,049-token prefill at 2e-3;
7. xlstm — the xLSTM serving path at xlstm-1.3b's full width (48 layers:
   42 mLSTM and 6 sLSTM, d_model 2,048, 4 heads of 512, vocab 50,304
   padded, tied embeddings, bf16, random weights from ``torch.Generator``
   seed 0): the same batch shape through ``generate`` with 64 greedy
   steps; exactly 6 sLSTM kernel launches for the prefill (cluster
   route) and 6 per step (step route), finite logits, tokens in the padded vocabulary, peak memory
   allocated at most 10 GB, and, in float32, decode_step after a
   256-token prefill must equal a 257-token prefill at 2e-3;
8. service — ``MLegoService`` (``backend="device"``, two workers a pool,
   a 5 ms coalescing window up to 16 wide) over [0, 24,000) of phase 3's
   corpus and config: 16 ``"vb"`` and 4 ``"gs"`` windows by
   ``train_range``; four tenants submit 8 specs each from four threads at
   once (covered ranges, half-window edges, ``"gs"`` ranges, and a repeat
   of the first tenant's covered ranges); every answer comes from
   ``"device"`` with finite β whose rows sum to 1, a window fuses (width
   >= 2, a ragged launch), another tenant's repeat of a spec answered
   alone rides the shared plan cache, and a covered β equals a
   ``"host"`` session's over the service's store at 1e-5.  Then
   streaming ingest of [24,000, 32,000) in 4 batches (8 slices of 1,000,
   ``build_errors == 0``, at least one compaction under a byte budget,
   the E-step kernel launched, the range answered with no training), a
   speculator that pre-trains a hot gapped range on the card and is hit,
   a ``profile=True`` session whose covered merge shows its
   ``mlego.merge_topics`` range in a ``torch.profiler`` capture and its
   ``kernel_hbm_bytes`` (row 1's bound bytes), and an injected device
   loss answered by ``"host"`` that trips the device breaker.
   ``close()`` must join every thread within 300 s;
9. sharded — ``ShardedDeviceBackend`` (``backend="device_sharded"``) over
   the window models of phases 3 and 5: on ``local_mesh_env()`` (one
   shard on one card) a covered ``submit`` of [0, 8,000), a gapped one of
   [8,500, 12,500) (trained on the E-step kernel and the blocked sweep)
   and a ``submit_many`` of parts [4, 2, 8, 1], both kinds, covered and
   batched β held to the ``"device"`` backend's at 1e-9 + 1e-5·|want|;
   the same queries on a (1, 4) grid of the card (2,048 columns a slice)
   held to the one-shard answers, each merge adding 4 to its kernel's
   counter and 1 to ``device_launches``, five repeats giving the same
   bits; a byte budget of two models, under which the 4-slice cache
   counts each model whole (its slices share the one card) and holds
   what the ``"device"`` backend holds; an injected device loss answered
   by ``"device"``, a second by ``"host"``; the elastic repartition onto
   4 workers (each worker's model against its merge on the card) and a
   quarantined window retrained on the E-step kernel; both merge kernels
   held to their plain versions on the path's slices (the 4 slice lists
   of [0, 8,000), the 4 slice lists of the batch at counts [4, 2, 8,
   1]) at ``MERGE_TOL``;
   ``vb_fit_sharded`` on a (2, 2) grid against ``vb_fit`` on the E-step
   kernel from one λ0 (2e-4 + 2e-4·|want| after one iteration, the
   difference after 10 printed, and after 10 each of the float32 fits —
   the kernel's, the (1, 1) and the (2, 2) grid's — within 3x the
   fits' spread from ``vb_fit``'s loop in float64 on the host); the walls of the covered ``submit`` and
   ``submit_many`` at 1 shard and 4 slices, and the normaliser's share of
   the merge wall;
10. families — ``families_phase``: the serving paths of the other
   families through ``generate``, random weights from ``torch.Generator``
   seed 0 drawn and cast layer by layer, one model at a time (each freed
   before the next; the memory the earlier phases hold is printed):
   recurrentgemma-9b at full width (38 layers: 26 ``"rec"``, 12
   ``"local"``; d_model 4,096, 16 query heads on one KV head of 256, d_ff
   12,288, vocab 256,000, window 2,048, bf16), 2 prompts of 4,096 tokens
   and 64 greedy steps: exactly 12 flash launches a prefill and none of
   either kernel a step, peak memory allocated at most 24 GB over the
   weights' draw and cast and over the whole path (each checked), and, in
   float32 over its first 3 layers (rec, rec, local), decode_step after
   a 2,100-token prefill equal to a 2,101-token prefill at 2e-3 (the
   window and the ring cache crossed); llava-next-34b at 8 of its 60
   layers (d_model 7,168, 56/8 heads of 128, d_ff 20,480, vocab 64,000,
   untied, bf16), 2 prompts of 4,096 tokens whose first 2,880 positions
   are patch embeddings, 64 steps: 8 flash launches a prefill and 8
   decode launches a step, and other patch embeddings move the logits;
   whisper-tiny at full width (4 encoder and 4 decoder layers, d_model
   384, 6 heads of 64, LayerNorm, GELU, vocab 51,865 padded), a batch of
   4 with 1,536 frames each, 384-token prompts, 64 steps in a
   448-position cache: 8 flash launches a prefill (4 bidirectional, 4
   causal) and 4 decode launches a step, and the float32 check at a
   384-token prompt; finite logits and tokens in the padded vocabulary
   for each.  Then the flash kernel at the four prefill shapes the phase
   gave it: recurrentgemma's ``"local"`` layers (B = 2, S = 4,096, H = 16,
   KVH = 1, hd = 256, window 2,048), llava's layers (B = 2, S = 4,096,
   H = 56, KVH = 8, hd = 128, causal), whisper's encoder (B = 4,
   S = 1,536, H = 6, KVH = 6, hd = 64, bidirectional) and its decoder
   (B = 4, S = 384, H = 6, KVH = 6, hd = 64, causal); and the decode
   kernel at llava's and whisper's decode shapes; each held in bf16
   against its plain version, five repeat calls giving the same bits,
   and timed beside its bound and SDPA (with the boolean causal or band
   mask);
11. moe — ``moe_phase``: the MoE serving path through ``generate``, one
   model at a time, each cut only in depth to 8 layers (neither fits one
   card whole), random weights from ``torch.Generator`` seed 0 cast as
   they are drawn: qwen3-moe-235b-a22b (d_model 4,096, 64/4 heads of
   128, qk-norm, 128 experts top-8 of d_ff 1,536, vocab 152,064 padded)
   and llama4-scout-17b-a16e (d_model 5,120, 40/8 heads of 128, 16
   experts top-1 of d_ff 8,192 plus a shared expert, vocab 202,240
   padded), bf16, capacity factor 1.25; 2 prompts of 4,096 tokens, a
   4,160-position cache, 64 greedy steps: 8 flash launches a prefill and
   8 decode launches a step, finite logits, tokens in the padded
   vocabulary, peak memory allocated at most 56 GB over the draw and
   cast and over the whole path (each checked), and, in float32 over 2
   layers at capacity factor n_experts / top-k (nothing drops), decode_step
   after a 256-token prefill equal to a 257-token prefill at 2e-3.
   Printed: the decode step's byte bound by the experts its routes
   touched, one layer's prefill split into attention and the MoE FFN
   (CUDA events), and the share of the first layer's (token, choice)
   pairs past capacity.  The kernel checks after phase 10 also hold and
   time the flash kernel at both models' prefill shapes and the decode
   kernel at both decode shapes.

12. train — ``train_phase``: LM training, which launches no kernel of the
   port (the JAX package's training runs its jnp flash math and the
   sLSTM's ``lax.scan``, and has no backward kernel): (a) qwen3-1.7b at
   its published widths (28 layers, d_model 2,048, 16/8 heads of 128,
   vocab 151,936, tied), random weights from seed 0, float32 masters and
   bf16 compute, AdamW (lr 1e-3, warmup 2), remat per layer, through
   ``Trainer.fit`` for 6 steps on one fixed batch of 2 × 4,096 tokens;
   every loss finite, the last below the first, the parameters moved,
   the peak memory allocated at most 70 GB; printed: seconds a step
   (median of steps 2–6), tokens/s, the operations a step and their
   bound at 989 TFLOP/s, the peak, and one layer's forward and backward
   split into attention and the rest (CUDA events); (b) the reduced
   config in bf16, 6 steps against 4, a checkpoint, a new ``Trainer``'s
   restore and 2 more: every parameter and optimizer leaf the same bits;
   (c) the reduced float32 configs of six families, ``Model.loss`` and
   every gradient on the card (TF32 off) against the CPU at 1e-5 (loss)
   and 1e-4 of each leaf's largest magnitude; (d) the flash, decode,
   sLSTM and merge wrappers raise on CUDA inputs that require grad and
   run under ``torch.no_grad()``.  Every kernel's counter reads 0 after
   (a) (``launches_by_path["train"]``).

13. grid — the several-device paths on grids that name the card several
   times (costs, not a speed-up), each run inside the phase that holds
   its model's weights, so nothing is drawn twice: (a) in phase 6,
   qwen3-1.7b at full width on a (1, 4) grid, 2 × 4,096 tokens (S_loc =
   1,024): the prefill through the ring on the flash kernel (cell r runs
   r + 1 steps with q_offset = (r − blk)·S_loc and the lse), 64 greedy
   steps through the split-K decode over the cache shards (4 decode
   launches a layer a step), against one device at the same batch
   (``grid_serve``; the decode step is weight-stationary: each cell
   multiplies by its own pieces of the weights, and its ms a step are
   printed beside one device's); (e) there too, its 28 layers as 4 stages
   of 7 on a ("stage",) × 4 grid, 4 microbatches, against the layers in
   order (``grid_pipeline``); (b) in phase 7, xlstm-1.3b: the mLSTM prefix
   and the sLSTM carry chain (4 scan launches a prefill, 4 a decode
   step: each ``model`` rank steps its block of the heads); (c) in phase 10, recurrentgemma-9b: the ``"local"`` window ring
   (3 of 4 steps, flash at G = 16, hd = 256) and the RG-LRU prefix; (d)
   in phase 11, qwen3-moe-235b-a22b at 8 layers: 32 experts a cell and the
   all_to_all of capacity blocks; (f) after phase 12 frees its state,
   training at qwen3-1.7b's widths and 8 of its layers on a (2, 2) grid
   (data 2 × sequence 2), 3 steps, against the one-device ``Trainer`` on
   the same weights and batch (``grid_train``), the update's share of a
   step printed; then the update on the pieces alone, float32 at 2
   layers, 3 steps of AdamW and of Adafactor on the same gradients as one
   device's update: the joined masters and state within ``GRID_TOL`` of
   one device's (``grid_update_f32``).  In bf16 each prints the
   prefill logits' largest difference and the share of greedy tokens that
   agree (random weights leave near-ties); the hard checks are float32 at
   the same widths and 2 layers (xlstm one "m" and one "s", recurrentgemma
   one "rec" and one "local"; whisper-tiny whole, in phase 10, also on
   (1, 2) grids, where its 6 heads split over ``model``): the grid's
   logits (prefill and 4 decode steps, on (1, 4) grids of the train and
   of the serve profile, whose row-parallel products add partial sums
   over ``model``), the loss and
   every gradient within ``GRID_TOL`` of one device's, relative to the
   largest magnitude, and the grid's greedy tokens one device's.  Every grid run's peak
   memory allocated is at most ``GRID_PEAK_RATIO`` × one device's (and
   within the phase's own limit).  The grid path's launches are summed
   over (a)–(f), each run's counters zeroed just before it and read just
   after (``launches_by_path["grid"]``).  The kernels section holds and
   times the flash kernel at the ring-step shapes (q_offset 0 to
   3·S_loc; the window's 0 to 2·S_loc), the decode kernel on the shard
   that holds pos and on an empty one, and the sLSTM scan at a chain
   cell's shape, each against its plain version, five calls giving the
   same bits;
14. examples — the four torch example scripts (``examples/*_torch.py``)
   run in this process through their ``main`` on the card, as a user runs
   them (``--device``), at their own sizes: quickstart (a 12 x 400 LDA),
   interactive_analysis (16 x 600: range queries, a union predicate, an
   Alg. 4 batch, recovery and repartition), serve_lm for xlstm-1.3b and
   qwen3-1.7b (reduced configs, 4 x 32-token prompts, 24 greedy steps)
   and train_lm (smollm-360m reduced, 60 steps, a restart, 10 more).
   Each script's wall time and launches are printed.  The two MLego
   scripts run first on the CPU at session seeds 0 and 1: on the card
   every planning fact must equal the seed-0 CPU run's and every held-out
   lpp must lie within ``EXAMPLE_LPP_SPREADS`` x the two seeds' spread of
   the interval they span.  ``vb_estep`` must launch in both MLego
   scripts, ``slstm_scan`` in the xlstm serve run, ``flash_attention``
   and ``decode_attention`` in the qwen3 one.
15. dryrun — ``dryrun_phase``: ``launch/dryrun.py``'s predictions for
   qwen3-1.7b at full width, each held against the same step run on the
   card under the same ``launch.cost.OpCounter``: (a) phase 12's training
   step (2 × 4,096 tokens, AdamW, remat) dry-run on the "card" grid of
   fake cards: its argument bytes equal the bytes of that step's
   parameters, AdamW state, batch and step counter on the card; its peak
   within ``DRY_PEAK_TOL`` of phase 12's peak memory allocated (less what
   the earlier phases held), and its allocations above the arguments
   within ``DRY_PEAK_TOL`` of the same step's on the card
   (``make_train_step`` on a (1, 1) grid of the card); its FLOPs equal to
   the count on the card; its roofline terms printed beside phase 12's
   seconds a step; (b) phase 6's prefill (4 × 2,048 tokens) and one decode
   step against a 2,112-position cache: 28 shape-only flash (decode)
   launches, as many as the kernel's counter shows for the same prefill
   (step) on the card, their FLOPs and bytes 28 times the kernel's
   ``cost(...)`` (the function the bound column calls), the step's FLOPs
   equal to the count on the card; (c) qwen3-1.7b's decode_32k on the
   "node" grid (eight fake cards): its record written under
   ``experiments/dryrun_torch/``, its collective counts nonzero, a card's
   link bytes and FLOPs printed, and no weight leaf all-gathered but the
   head's feature dim (``dryrun.stray_decode_gathers``: the step is
   weight-stationary); (d) phase
   13 (f)'s training step (8 layers, 2 × 4,096 tokens) on "node": each
   card's argument, output and peak bytes printed, card 0's output bytes
   each other card's plus the 20 of the step counter and the 4 metrics
   (the update runs on the pieces: no card holds a whole leaf).

The launch counts reported for a kernel are those of the paths that run
it (phases 3–4 for the ``"vb"`` path, phase 5 for the ``"gs"`` path,
phase 6 for the serve path, phase 7 for the ``"xlstm"`` path, phase 8
for the ``"service"`` path, phase 9 for the ``"sharded"`` path, phase
10 for the ``"hybrid"``, ``"vlm"`` and ``"audio"`` paths, phase 11 for
the ``"moe"`` path, both models' counts summed, phase 12 for the
``"train"`` path, 0 for every kernel, phase 13 for the ``"grid"`` path,
its runs' counts summed, phase 14 for the ``"examples"`` path, its
scripts' counts summed, phase 15 for the ``"dryrun"`` path: the real
prefill and decode step it holds its predictions against),
each counter set to 0 just before its path and read just after:
``launches_by_path`` holds each path's count and ``launches`` their sum
(the merges run on both paths).  The batched merge is on neither path
(it is the ragged merge's retired parity reference) and reports 0.  The
E-step counts two launches a call (iterations, then sstats); the (V, K)
transpose of eeβ it makes first is a PyTorch copy, timed with the call.

The second-to-last line of output is the kernel table as JSON, the line
before it the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero and
prints no result line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the card's published peaks (H100 SXM data sheet): HBM bytes/s and the
# dense bf16 tensor-core rate, the denominators of the step bounds below
# (each kernel's bound is its package's cost(...).bound_ms(), against
# the same peaks in repro_torch.kernels.common)
PEAK_BYTES_S = 3.35e12
PEAK_BF16_TC_FLOPS = 989e12

MERGE_TOL = 1e-5
BETA_RTOL, BETA_ATOL = 1e-5, 1e-9   # phase 9's β against another backend
ESTEP_TOL = 2e-4
SERVE_B, SERVE_PROMPT, SERVE_CACHE, SERVE_STEPS = 4, 2048, 2112, 64
XL_B, XL_S, XL_H, XL_HD = 4, 2048, 4, 512   # the xLSTM path's sLSTM shape
XL_CHECK_PROMPT = 256      # prompt of the xLSTM float32 consistency check
XL_PEAK_GB = 10.0          # peak memory the xLSTM serve path may allocate
CONSISTENCY_TOL = 2e-3
TRAIN_BUDGET_S = 300.0     # seconds the main path may spend in VB training
N_WINDOWS = 32
GS_TRAIN_BUDGET_S = 120.0  # seconds the gs path may spend in train_range
GS_WINDOWS = 16
# the three families of phase 10 at full width: (arch, depth or None,
# batch, prompt tokens, greedy steps, cache positions, float32 check
# prompt and depth or None)
FAMILIES = {
    "hybrid": dict(arch="recurrentgemma-9b", n_layers=None, b=2,
                   prompt=4096, steps=64, cache=4160, check=(2100, 3)),
    "vlm": dict(arch="llava-next-34b", n_layers=8, b=2, prompt=4096,
                steps=64, cache=4160, check=None),
    "audio": dict(arch="whisper-tiny", n_layers=None, b=4, prompt=384,
                  steps=64, cache=448, check=(384, None)),
}
HYBRID_PEAK_GB = 24.0      # peak memory the hybrid path may allocate
# phase 11: the MoE serving path, each model at its published widths cut
# to MOE_LAYERS layers (neither fits one card whole), one at a time
MOE_ARCHS = ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e")
MOE_LAYERS, MOE_B, MOE_PROMPT, MOE_STEPS, MOE_CACHE = 8, 2, 4096, 64, 4160
MOE_CHECK_PROMPT, MOE_CHECK_LAYERS = 256, 2   # the float32 handoff check
MOE_PEAK_GB = 56.0         # peak memory the MoE path may allocate
# phase 12: LM training, qwen3-1.7b at its published widths, nothing cut
# but the batch (train_4k's sequence length, its global batch of 256 cut
# to TRAIN_B for one card)
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS = "qwen3-1.7b", 2, 4096, 6
TRAIN_PEAK_GB = 70.0       # peak memory training may allocate
TRAIN_FAMILIES = ("qwen3-1.7b", "xlstm-1.3b", "recurrentgemma-9b",
                  "llava-next-34b", "whisper-tiny", "qwen3-moe-235b-a22b")
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-5, 1e-4   # float32 card against CPU
# phase 13: the grid paths on grids that name the card several times
GRID_B, GRID_PROMPT, GRID_STEPS, GRID_CACHE = 2, 4096, 64, 4160
GRID_CHECK_S, GRID_CHECK_LAYERS = 1024, 2   # the float32 checks' widths
GRID_TOL = 1e-4            # float32 grid against one device, of the max
GRID_PEAK_RATIO = 1.25     # a grid run's peak against one device's
GRID_TRAIN_LAYERS, GRID_TRAIN_STEPS = 8, 3
T_START = time.perf_counter()


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def tensor_core_instructions(lib_path: Path) -> dict:
    """{kernel function: count of HMMA/HGMMA instructions} in the SASS of
    the built library (``cuobjdump -sass``)."""
    import shutil
    from torch.utils.cpp_extension import CUDA_HOME
    tool = shutil.which("cuobjdump") or str(Path(CUDA_HOME or "/usr/local/cuda")
                                            / "bin" / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    return counts


def service_phase(corpus, cfg, device, unit: float, card: str) -> dict:
    """Phase 8: the multi-tenant query service on ``device``.

    ``corpus`` spans [0, 32·unit); the service starts over [0, 24·unit)
    and ingests the rest.  Every check that needs no launch counter
    raises here; the counters' deltas are returned (with the counts of
    the whole phase, read after ``close()``) for the caller to hold.
    """
    import contextlib
    import functools
    import threading

    import numpy as np
    import torch

    from repro_torch.api import Interval, MLegoSession, QuerySpec
    from repro_torch.api.backend import make_backend
    from repro_torch.ingest import CompactionPolicy
    from repro_torch.kernels.gibbs_sweep import ops as gibbs_ops
    from repro_torch.kernels.merge_topics import ops as merge_ops
    from repro_torch.kernels.vb_estep import ops as estep_ops
    from repro_torch.serve import OPEN, MLegoService
    from repro_torch.testing.faults import FaultRule, injected

    timeout = 300.0
    k, v = cfg.n_topics, cfg.vocab_size

    def iv(lo, hi):
        return Interval(lo * unit, hi * unit)

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"[service] {msg}")

    def check_beta(r, what):
        check(r.beta.shape == (k, v) and np.isfinite(r.beta).all(),
              f"{what}: beta is not finite ({k}, {v})")
        err = float(np.abs(r.beta.sum(1) - 1.0).max())
        check(err <= 1e-5, f"{what}: beta rows sum to 1 +- {err}")

    class TrainLog:
        """Wraps a device backend's trainers.  Recording, it keeps each
        training's documents, generator seed and result, from whatever
        thread trains; replaying (``recorded`` given), it trains with the
        seed recorded for the same documents, which must have been
        trained exactly once."""

        def __init__(self, backend, recorded=None):
            self.recorded = recorded
            self.runs = {}
            self.lock = threading.Lock()
            self.inner = backend.trainer
            backend.trainer = self.trainer

        @staticmethod
        def key(kind, sub):
            return (kind, sub.n_docs, sub.n_tokens, float(sub.attr[0]),
                    float(sub.attr[-1]))

        def snapshot(self):
            with self.lock:
                return {key: list(runs) for key, runs in self.runs.items()}

        def trainer(self, kind):
            fn = self.inner(kind)

            # wraps: the executor reads the trainer's signature
            @functools.wraps(fn)
            def train(sub, cfg_, gen, **kw):
                key = self.key(kind, sub)
                if self.recorded is not None:
                    runs = self.recorded.get(key, [])
                    check(len(runs) == 1, f"the replay trains {key}, which "
                          f"the service trained {len(runs)} times")
                    gen = torch.Generator(device=gen.device).manual_seed(
                        runs[0][0])
                theta = fn(sub, cfg_, gen, **kw)
                with self.lock:
                    self.runs.setdefault(key, []).append(
                        (gen.initial_seed(), theta))
                return theta
            return train

    counters = [report_counters()[k] for k in (
        "merge_topics", "merge_topics_ragged", "merge_topics_batch",
        "vb_estep", "gibbs_sweep", "cgs_sweep_exact")]
    for mod, name in counters:
        setattr(mod, name, 0)
    grew = {}
    elsewhere = {}

    @contextlib.contextmanager
    def not_the_service(what):
        """Launches of a session that is not the service (a replay, the
        profiled session) go to ``elsewhere[what]`` and back out of the
        service path's counts; no service thread launches meanwhile."""
        before = [getattr(mod, name) for mod, name in counters]
        try:
            yield
        finally:
            seen = elsewhere.setdefault(what, {})
            for (mod, name), b in zip(counters, before):
                if getattr(mod, name) != b:
                    seen[name] = seen.get(name, 0) + getattr(mod, name) - b
                setattr(mod, name, b)

    # 1. the service and its capital
    t0 = time.perf_counter()
    svc = MLegoService(corpus.subset(0.0, 24 * unit), cfg, backend="device",
                       device=device, window_s=0.005, max_width=16,
                       workers_per_pool=2)
    trained = TrainLog(svc.backend)
    for i in range(16):
        m = svc.train_range(i * unit, (i + 1) * unit)
        check(m is not None and m.n_docs > 0, f"vb window {i} is empty")
    for i in range(4):
        m = svc.train_range(i * unit, (i + 1) * unit, kind="gs")
        check(m is not None and m.kind == "gs", f"gs window {i} missing")
    log(f"[service] train_range: 16 vb + 4 gs windows of {unit:g} units in "
        f"{time.perf_counter() - t0:.2f} s, {len(svc.store)} models; on "
        f"{card}")

    # 2. four tenants submitting at once, 8 specs each
    covered = [iv(0, 8), iv(0, 4), iv(4, 8), iv(8, 16), iv(0, 16), iv(2, 6),
               iv(12, 16), iv(0, 1)]
    edged = [iv(8.5, 12.5), iv(0.5, 3.5), iv(1.5, 7.5), iv(10.5, 14.5),
             iv(4.5, 9.5), iv(12.5, 15.5), iv(2.5, 5.5), iv(6.5, 13.5)]
    gs_ranges = [iv(0, 4), iv(0.5, 4.5), iv(0, 2), iv(2, 4), iv(1, 3),
                 iv(0, 1), iv(3, 4), iv(1, 4)]
    plans = {
        "ana": [QuerySpec(sigma=s) for s in covered],
        "bob": [QuerySpec(sigma=s, materialize="volatile") for s in edged],
        "cy": [QuerySpec(sigma=s, kind="gs", materialize="volatile")
               for s in gs_ranges],
        "dan": [QuerySpec(sigma=s) for s in covered],   # repeats ana's
    }
    futures = {t: [] for t in plans}
    latency = {t: [] for t in plans}
    start = threading.Barrier(len(plans))

    def client(tenant):
        start.wait(timeout=timeout)
        for spec in plans[tenant]:
            t_sub = time.perf_counter()
            fut = svc.submit(spec, tenant=tenant)
            fut.add_done_callback(
                lambda _f, t=t_sub, lat=latency[tenant]:
                lat.append(time.perf_counter() - t))
            futures[tenant].append(fut)

    threads = [threading.Thread(target=client, args=(t,), daemon=True)
               for t in plans]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=timeout)
        check(not th.is_alive(), f"client {th.name} did not finish")
    reports = {t: [f.result(timeout=timeout) for f in fs]
               for t, fs in futures.items()}
    t_burst = time.perf_counter() - t0
    rep = svc.report()
    for t, reps in reports.items():
        check(len(reps) == len(plans[t]), f"{t}: answers missing")
        for r in reps:
            check(r.backend == "device" and r.fallback_from is None,
                  f"{t}: answered by {r.backend} (from {r.fallback_from})")
        log(f"[service] tenant {t}: {len(reps)} answers, latency p50 "
            f"{np.percentile(latency[t], 50) * 1e3:.1f} ms, p95 "
            f"{np.percentile(latency[t], 95) * 1e3:.1f} ms (host clock, "
            f"submit to answer), {sum(r.plan_cached for r in reps)} plans "
            f"cached, {sum(r.n_trained_tokens for r in reps)} trained "
            f"tokens; on {card}")
    for r in reports["ana"] + reports["dan"]:
        check(r.n_trained_tokens == 0, "a covered spec trained tokens")
        check_beta(r, "covered")
    for r in reports["bob"] + reports["cy"]:
        check_beta(r, "gapped")
    check(any(r.n_trained_tokens > 0 for r in reports["bob"]),
          "no half-window spec trained a gap")
    check(rep.errors == 0 and rep.queries == 32,
          f"{rep.errors} errors in {rep.queries} answers")
    check(rep.max_coalesce_width >= 2, "no window fused")
    grew["burst_ragged"] = merge_ops.merge_topics_ragged_launches
    log(f"[service] burst: 32 answers in {t_burst:.2f} s; {rep.groups} "
        f"groups, coalesce width mean {rep.mean_coalesce_width:.2f} max "
        f"{rep.max_coalesce_width}; plan cache {rep.plan_cache_hits} hits "
        f"{rep.plan_cache_misses} misses; on {card}")
    # a fused group plans as one batch; a spec that drains alone plans on
    # its own, and another tenant's repeat of it reuses that plan
    alone = [svc.submit(QuerySpec(sigma=covered[0]), tenant=t).result(
        timeout=timeout) for t in ("ana", "dan")]
    check(not alone[0].plan_cached and alone[1].plan_cached,
          "dan's repeat of ana's spec did not ride the shared plan cache")
    host = MLegoSession(svc.corpus, cfg, store=svc.store, backend="host",
                        device=device)
    want = host.submit(QuerySpec(sigma=covered[0]))
    got = reports["ana"][0]
    diff = float(np.abs(want.beta - got.beta).max())
    check(want.model_ids == got.model_ids and np.allclose(
        got.beta, want.beta, rtol=1e-5, atol=1e-5),
        f"service beta differs from a host session's by {diff}")
    log(f"[service] covered beta against a host session over the service's "
        f"store: max abs diff {diff:.3g} (tol 1e-5)")
    # one gapped answer of each kind, trained by the pool's workers beside
    # each other, against the same spec answered on this thread by a
    # device session over the same store, each gap trained with the seed
    # the service trained it with
    replay_backend = make_backend("device", device=device)
    TrainLog(replay_backend, recorded=trained.snapshot())
    replay = MLegoSession(svc.corpus, cfg, store=svc.store,
                          backend=replay_backend, device=device)
    for tenant, tol in (("bob", ESTEP_TOL), ("cy", 0.0)):
        i = next(i for i, r in enumerate(reports[tenant])
                 if r.n_trained_tokens > 0)
        got, spec = reports[tenant][i], plans[tenant][i]
        with not_the_service("replay"):
            want = replay.submit(spec)
        check(want.model_ids == got.model_ids
              and want.n_trained_tokens == got.n_trained_tokens,
              f"{tenant}: the replay planned {want.model_ids}, "
              f"{want.n_trained_tokens} tokens; the service "
              f"{got.model_ids}, {got.n_trained_tokens}")
        diff = float(np.abs(want.beta - got.beta).max())
        check(diff <= tol, f"{tenant}: the gapped answer differs from its "
              f"one-thread replay by {diff} (tol {tol})")
        log(f"[service] {tenant}'s gapped {spec.kind or svc.kind!r} answer "
            f"({got.n_trained_tokens} trained tokens) against its one-thread "
            f"replay with the service's seeds: max abs diff {diff:.3g} "
            f"(tol {tol:g})")

    # 3. streaming ingest of [24, 32)·unit with compaction
    per_model = k * v * 4
    budget = (len(svc.store.models("vb")) + 8 - 4) * per_model
    before = estep_ops.launches
    pipe = svc.attach_ingest(slice_width=unit, start=24 * unit,
                             compaction=CompactionPolicy(max_bytes=budget))
    t0 = time.perf_counter()
    for b in range(4):
        svc.ingest(corpus.subset((24 + 2 * b) * unit, (26 + 2 * b) * unit))
    check(pipe.flush(timeout=timeout), "the ingest builder did not drain")
    pipe.close()
    t_ingest = time.perf_counter() - t0
    grew["ingest_estep"] = estep_ops.launches - before
    ing = pipe.report()
    check(ing.slices_built == 8 and ing.build_errors == 0,
          f"{ing.slices_built} slices built, {ing.build_errors} errors")
    check(ing.compactions >= 1, "the byte budget compacted nothing")
    fresh = svc.submit(QuerySpec(sigma=iv(24, 32)), tenant="ana").result(
        timeout=timeout)
    check(fresh.n_trained_tokens == 0 and fresh.backend == "device",
          f"the ingested range trained {fresh.n_trained_tokens} tokens")
    check_beta(fresh, "ingested")
    # the first slice, built by the builder thread while batches were
    # still appended, against the same fit on this thread with its seed
    lo = 24 * unit
    sub = pipe.corpus.subset(lo, lo + unit)
    runs = trained.snapshot().get(TrainLog.key("vb", sub), [])
    check(len(runs) == 1, f"slice [{lo:g}, {lo + unit:g}) was trained "
          f"{len(runs)} times")
    seed, built = runs[0]
    with not_the_service("replay"):
        again = svc.backend.trainer("vb")(
            sub, cfg, torch.Generator(device=device).manual_seed(seed))
    stored = [m for m in svc.store.models("vb")
              if (m.o.lo, m.o.hi) == (lo, lo + unit)]
    diff = float(np.abs(again["lam"] - built["lam"]).max())
    scale = float(np.abs(built["lam"]).max())
    check(diff <= ESTEP_TOL * (1.0 + scale),
          f"slice theta differs from its one-thread refit by {diff}")
    check(all(np.array_equal(m.theta["lam"], built["lam"]) for m in stored),
          "the stored slice is not the one the builder trained")
    log(f"[service] slice [{lo:g}, {lo + unit:g}) ({sub.n_docs} docs) against "
        f"its one-thread refit with the builder's seed: max abs diff "
        f"{diff:.3g} of max |lam| {scale:.3g} (tol {ESTEP_TOL:g}·(1 + max "
        f"|lam|)); {len(stored)} stored copy, the same bits")
    log(f"[service] ingest: {ing.batches} batches, {ing.docs} docs, "
        f"{ing.slices_built} slices in {t_ingest:.2f} s (append to last "
        f"slice built), freshness lag mean {ing.freshness_lag_s_mean:.3f} s "
        f"max {ing.freshness_lag_s_max:.3f} s, {ing.compactions} "
        f"compactions, {ing.evictions} evictions under a "
        f"{budget / 1e6:.1f} MB budget; on {card}")

    # 4. speculation: a hot gapped range pre-trained, then a hit
    hot = QuerySpec(sigma=iv(15.5, 16.5), alpha=0.5, materialize="volatile")
    first = [svc.submit(hot, tenant="eve").result(timeout=timeout)
             for _ in range(2)]
    check(all(r.n_trained_tokens > 0 for r in first),
          "the hot range has no gap to speculate on")
    spec_tr = svc.attach_speculator(min_count=2, window_s=60.0, margin=0.0,
                                    start=False)
    before = estep_ops.launches
    t0 = time.perf_counter()
    n_spec = spec_tr.scan_once()
    t_spec = time.perf_counter() - t0
    grew["speculation_estep"] = estep_ops.launches - before
    check(n_spec >= 1, "the speculator trained no gap")
    again = svc.submit(hot, tenant="eve").result(timeout=timeout)
    sp = svc.report().speculation
    check(sp.hits >= 1, "the hot range's next answer missed the "
          "speculated capital")
    log(f"[service] speculation: {sp.trained} gaps, {sp.trained_tokens} "
        f"tokens pre-trained in {t_spec:.2f} s; the next answer trained "
        f"{again.n_trained_tokens} tokens (before: "
        f"{first[0].n_trained_tokens}), {sp.hits} hits; on {card}")

    # 5. profiling: the merge's range in a torch.profiler capture, its
    # kernel.launch span carrying the bound's bytes
    psess = MLegoSession(svc.corpus, cfg, store=svc.store, backend="device",
                         device=device, profile=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with not_the_service("profile"), \
            torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        prep = psess.submit(QuerySpec(sigma=covered[0], alpha=1.0))
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    names = {e.name for e in prof.events()}
    check("mlego.merge_topics" in names,
          "no mlego.merge_topics range in the profile")
    n = len(prep.model_ids)
    spans = [s for s in psess.tracer.spans(trace_id=prep.trace,
                                           name="kernel.launch")
             if s.attrs.get("op") == "merge_topics"]
    want_bytes = 4.0 * (n * k * v + n + k * v)
    check(spans and spans[0].attrs.get("kernel_hbm_bytes") == want_bytes,
          f"kernel.launch span bytes {spans and spans[0].attrs} != "
          f"{want_bytes}")
    # the capture's device activity (kernels and copies; the mlego.*
    # ranges projected onto the device timeline are spans, not work)
    # against the query's wall: a new session's first merge uploads its
    # parts
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    ranges = [e for e in on_card if e.name.startswith("mlego.")
              or getattr(e, "is_user_annotation", False)]
    work = [e for e in on_card if all(e is not r for r in ranges)]

    def span_us(events, word=""):
        return sum(e.time_range.elapsed_us() for e in events
                   if word in e.name)
    busy_us = span_us(work)
    cuda = int(torch.device(device).type == "cuda")
    check(elsewhere["profile"] == ({"merge_topics_launches": 1} if cuda
                                   else {}),
          f"the profiled submit launched {elsewhere['profile']}")
    log(f"[service] profile: mlego.merge_topics range found; kernel.launch "
        f"span kernel_hbm_bytes {want_bytes:.0f} for n = {n} parts, "
        f"kernel_flops {spans[0].attrs['kernel_flops']:.0f}; the profiled "
        f"submit {t_prof * 1e3:.2f} ms wall, device busy {busy_us:.1f} us "
        f"in {len(work)} kernels and copies (idle share "
        f"{1.0 - busy_us * 1e-6 / t_prof:.3f}): copies "
        f"{span_us(work, 'Memcpy'):.1f} us, merge kernel "
        f"{span_us(work, 'merge'):.1f} us; the mlego.* ranges span "
        f"{span_us(ranges):.1f} us of the device timeline; on {card}")

    # 6. device loss: the answer comes from "host", the breaker trips
    with injected(FaultRule("backend.merge.device", kind="device_lost",
                            max_failures=1)):
        lost = svc.submit(QuerySpec(sigma=covered[0]), tenant="ana").result(
            timeout=timeout)
    check((lost.backend, lost.fallback_from) == ("host", "device"),
          f"device loss answered by {lost.backend} (from "
          f"{lost.fallback_from})")
    check_beta(lost, "fallback")
    br = svc.report().breaker.get("device")
    check(br is not None and br.state == OPEN and br.opens >= 1,
          f"the device breaker did not trip: {br}")
    log(f"[service] device loss: answered by host (fallback from device), "
        f"device breaker {br.state} after {br.opens} open; covered answer "
        f"{lost.total_s * 1e3:.1f} ms on {card}")

    # 7. close joins every thread
    final = svc.report()
    closer = threading.Thread(target=svc.close, daemon=True)
    closer.start()
    closer.join(timeout=timeout)
    alive = [t.name for p in svc._pools_snapshot() for t in p.threads
             if t.is_alive()]
    check(not closer.is_alive() and not alive,
          f"close() left threads running: {alive}")
    launches = read_counts(("merge_topics", "merge_topics_ragged",
                            "vb_estep", "gibbs_sweep"))
    log(f"[service] kernel launches on the service path: {launches}; "
        f"exact scan {gibbs_ops.cgs_sweep_exact_launches}, batched merge "
        f"{merge_ops.merge_topics_batch_launches}; step deltas {grew}; "
        f"left out, launched by the replays and the profiled session: "
        f"{elsewhere}")
    return dict(launches=launches, grew=grew,
                queries=final.queries, groups=final.groups,
                mean_width=final.mean_coalesce_width,
                max_width=final.max_coalesce_width)


def sharded_phase(corpus, cfg, gcfg, vb_store, gs_store, device,
                  unit: float, card: str) -> dict:
    """Phase 9: the vocab-sharded backend (``"device_sharded"``) on
    ``device``.

    Its store holds the window models of ``vb_store`` and ``gs_store``
    (phases 3 and 5: [i·unit, (i+1)·unit)), not the gap models those
    phases persisted, so its gapped queries train.  The ``"device"``
    answers it is held to are taken first; the launch counters are then
    zeroed and the sharded path driven.  Its count (returned under
    ``launches``) adds up the launches of the sharded sessions' queries
    and of their elastic retraining; the launches of the checks between
    them (the budget case, the device-loss chain, the card merges the
    elastic models are held to) are left out.  The merge kernels held
    against their plain versions on the slices the path gave them, the
    comparison of ``vb_fit_sharded`` with the E-step kernel's fit and
    the normaliser's timing come after, uncounted.  β is held at
    ``BETA_RTOL``·|want| + ``BETA_ATOL``: a typical β is 1/V ≈ 1.2e-4,
    so an absolute 1e-5 would pass a kernel a few percent off.
    """
    import numpy as np
    import torch

    from repro_torch.api import (DeviceBackend, Interval, MLegoSession,
                                 QuerySpec, ShardedDeviceBackend)
    from repro_torch.core.lda import topics_from_vb
    from repro_torch.core.merge import device_merge_params
    from repro_torch.core.store import ModelStore
    from repro_torch.core.vb import (_exp_dirichlet_expectation, vb_estep,
                                     vb_fit, vb_fit_sharded)
    from repro_torch.data.corpus import doc_term_matrix
    from repro_torch.distributed.elastic import (
        apply_repartition, plan_repartition, recover_quarantined)
    from repro_torch.distributed.merge_collective import (
        merge_topics_sharded, padded_vocab)
    from repro_torch.distributed.sharding import MeshEnv, local_mesh_env
    from repro_torch.kernels.gibbs_sweep import ops as gibbs_ops
    from repro_torch.kernels.merge_topics import ops as merge_ops
    from repro_torch.kernels.merge_topics.ops import (
        merge_topics_ref, merge_topics_segments_ref)
    from repro_torch.kernels.vb_estep import ops as estep_ops
    from repro_torch.testing.faults import FaultRule, injected

    t_phase = time.perf_counter()
    kinds = {"vb": cfg, "gs": gcfg}
    # the counters count CUDA launches: a rehearsal on the CPU sees none
    per_slice = 1 if device.type == "cuda" else 0
    k, v = cfg.n_topics, cfg.vocab_size

    def iv(lo, hi):
        return Interval(lo * unit, hi * unit)

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"[sharded] {msg}")

    def wait():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    beta_rel = [0.0]     # the largest relative β difference of the phase

    def close(got, want, what, rtol=BETA_RTOL, atol=BETA_ATOL):
        """Max abs diff; raises unless within atol + rtol·|want|."""
        diff = float(np.abs(got - want).max())
        rel = float((np.abs(got - want) / np.abs(want)).max())
        if rtol == BETA_RTOL:
            beta_rel[0] = max(beta_rel[0], rel)
        check(np.allclose(got, want, rtol=rtol, atol=atol),
              f"{what}: max abs diff {diff:.3g}, max rel {rel:.3g}, over "
              f"{atol} + {rtol}·|want|")
        return diff

    def check_report(r, what, backend="device_sharded", fallback=None):
        check((r.backend, r.fallback_from) == (backend, fallback),
              f"{what} answered by {r.backend} (fallback from "
              f"{r.fallback_from}), expected {backend} ({fallback})")
        check(r.beta.shape == (k, v) and np.isfinite(r.beta).all(),
              f"{what}: beta is not finite ({k}, {v})")
        err = float(np.abs(r.beta.sum(1) - 1.0).max())
        check(err <= 1e-5, f"{what}: beta rows sum to 1 +- {err}")

    store = ModelStore()
    for src, kind in ((vb_store, "vb"), (gs_store, "gs")):
        for m in src.models(kind):
            if m.o.hi - m.o.lo == unit and m.o.lo % unit == 0:
                store.add(m.o, m.n_docs, m.n_tokens, m.kind, m.theta)
    n_vb = len(store.models("vb"))
    covered = QuerySpec(sigma=iv(0, 8))
    gapped = QuerySpec(sigma=iv(8.5, 12.5))
    spans = {"vb": ((0, 4), (4, 6), (16, 24), (24, 25)),
             "gs": ((0, 4), (4, 6), (0, 8), (2, 3))}
    specs = {kind: [QuerySpec(sigma=iv(a, b)) for a, b in ab]
             for kind, ab in spans.items()}

    # the answers of the "device" backend, and its budget case: the 8
    # parts of [0, 8·unit) under a byte cap of 8 slices of 4, two whole
    # models
    single = DeviceBackend(device=device)
    ref = {}
    for kind, c in kinds.items():
        s = MLegoSession(corpus, c, kind=kind, store=store, backend=single,
                         device=device)
        ref[kind] = (s.submit(covered), s.submit_many(specs[kind]))
    parts8 = sorted((m for m in store.models("vb") if m.o.hi <= 8 * unit),
                    key=lambda m: m.o.lo)
    check(len(parts8) == 8, f"[0, 8 unit) holds {len(parts8)} windows")
    max_bytes = 8 * k * (padded_vocab(v, 4) // 4) * 4
    check(max_bytes < 8 * k * v * 4, "the budget would hold 8 whole models")
    capped = DeviceBackend(max_bytes=max_bytes, device=device)
    want8 = capped.merge(parts8, "vb", cfg)
    check(capped.cache.evictions > 0,
          f"the device backend kept 8 models under {max_bytes} B")

    counters = {k_: report_counters()[k_] for k_ in (
        "merge_topics", "merge_topics_ragged", "vb_estep", "gibbs_sweep")}

    def snap():
        return {k_: getattr(mod, name) for k_, (mod, name) in
                counters.items()}

    def count_since(s0):
        for k_, n in snap().items():
            launches[k_] += n - s0[k_]

    for mod, name in counters.values():
        setattr(mod, name, 0)
    launches = dict.fromkeys(counters, 0)
    s0 = snap()

    # 1. one shard per card (local_mesh_env: 1 shard on one card)
    env1 = local_mesh_env(device)
    walls = {}
    one = {}
    for kind, c in kinds.items():
        s = MLegoSession(corpus, c, kind=kind, store=store,
                         backend="device_sharded", device=device)
        check(s.backend.shards == env1.tp_size,
              f"{s.backend.shards} shards on a {env1.tp_size}-card mesh")
        t0 = time.perf_counter()
        rc = s.submit(covered)
        walls[f"{kind} covered submit, 1 shard, first"] = \
            (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        s.submit(covered)
        walls[f"{kind} covered submit, 1 shard, repeat"] = \
            (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        rg = s.submit(gapped)
        walls[f"{kind} gapped submit, 1 shard"] = \
            (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        rb = s.submit_many(specs[kind])
        walls[f"{kind} submit_many, 1 shard, first"] = \
            (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        s.submit_many(specs[kind])
        walls[f"{kind} submit_many, 1 shard, repeat"] = \
            (time.perf_counter() - t0) * 1e3
        check(rg.n_trained_tokens > 0, f"{kind} gapped query trained nothing")
        check([r.n_merged for r in rb] == [r.n_merged for r in ref[kind][1]],
              f"{kind} batch merged {[r.n_merged for r in rb]} parts")
        for r, what in ((rc, "covered"), (rg, "gapped"), *[
                (r, f"batch[{i}]") for i, r in enumerate(rb)]):
            check_report(r, f"{kind} {what}, 1 shard")
        d_cov = close(rc.beta, ref[kind][0].beta, f"{kind} covered vs device")
        d_many = max(close(r.beta, w.beta, f"{kind} batch vs device")
                     for r, w in zip(rb, ref[kind][1]))
        log(f"[sharded] {kind}, 1 shard: covered {len(rc.model_ids)} parts, "
            f"gapped {rg.n_trained_tokens} trained tokens, batch parts "
            f"{[r.n_merged for r in rb]}; beta vs the device backend: "
            f"covered {d_cov:.3g}, batch {d_many:.3g} (tol {BETA_ATOL} + "
            f"{BETA_RTOL}·|want|)")
        one[kind] = (rc, rg, rb)

    # 2. four slices of one card: the same queries
    env4 = MeshEnv([[device] * 4])
    b4 = ShardedDeviceBackend(env=env4, device=device)
    for kind, c in kinds.items():
        s = MLegoSession(corpus, c, kind=kind, store=store, backend=b4,
                         device=device)
        n0, l0 = merge_ops.merge_topics_launches, b4.stats.device_launches
        rc = s.submit(covered)
        check((merge_ops.merge_topics_launches - n0,
               b4.stats.device_launches - l0) == (4 * per_slice, 1),
              f"{kind} covered merge on 4 slices: "
              f"{merge_ops.merge_topics_launches - n0} kernel launches, "
              f"{b4.stats.device_launches - l0} device launches")
        t0 = time.perf_counter()
        s.submit(covered)
        walls[f"{kind} covered submit, 4 slices, repeat"] = \
            (time.perf_counter() - t0) * 1e3
        rg = s.submit(gapped)
        n0, l0 = (merge_ops.merge_topics_ragged_launches,
                  b4.stats.device_launches)
        t0 = time.perf_counter()
        rb = s.submit_many(specs[kind])
        walls[f"{kind} submit_many, 4 slices, first"] = \
            (time.perf_counter() - t0) * 1e3
        check((merge_ops.merge_topics_ragged_launches - n0,
               b4.stats.device_launches - l0) == (4 * per_slice, 1),
              f"{kind} ragged merge on 4 slices: "
              f"{merge_ops.merge_topics_ragged_launches - n0} kernel "
              f"launches, {b4.stats.device_launches - l0} device launches")
        for r, what in ((rc, "covered"), (rg, "gapped"), *[
                (r, f"batch[{i}]") for i, r in enumerate(rb)]):
            check_report(r, f"{kind} {what}, 4 slices")
        rc1, rg1, rb1 = one[kind]
        d_cov = close(rc.beta, rc1.beta, f"{kind} covered, 4 slices vs 1")
        d_many = max(close(r.beta, w.beta, f"{kind} batch, 4 slices vs 1")
                     for r, w in zip(rb, rb1))
        # the one-shard gapped answer persisted its gap models: merging
        # the same windows and those models gives the same beta
        same_gap = rg.n_trained_tokens == 0 and set(rg.model_ids) == \
            set(rg1.model_ids) | {m.model_id for m in rg1.materialized}
        if same_gap:
            close(rg.beta, rg1.beta, f"{kind} gapped, 4 slices vs 1")
        reps = [s.submit(covered).beta for _ in range(5)]
        check(all(np.array_equal(r, reps[0]) for r in reps),
              f"{kind}: 5 covered answers on 4 slices differ in their bits")
        t0 = time.perf_counter()
        s.submit_many(specs[kind])
        walls[f"{kind} submit_many, 4 slices, repeat"] = \
            (time.perf_counter() - t0) * 1e3
        log(f"[sharded] {kind}, 4 slices of {padded_vocab(v, 4) // 4} "
            f"columns: beta vs 1 shard: covered {d_cov:.3g}, batch "
            f"{d_many:.3g}; gapped "
            f"{'the same parts, held' if same_gap else 'other parts'}"
            f"; {4 * per_slice} merge launches and 1 device launch a "
            f"merge; 5 repeats give the same bits")

    count_since(s0)

    # 3. budget: the 4 slices of a model all lie on this one card, so the
    # cache counts each model at its whole padded bytes and holds as many
    # as fit whole, as the "device" backend does.  This shows the
    # accounting only: a per-device budget holds more models only on
    # distinct cards
    bb = ShardedDeviceBackend(max_bytes=max_bytes, env=env4, device=device)
    d8 = close(bb.merge(parts8, "vb", cfg), want8, "budget merge vs device")
    whole = k * padded_vocab(v, 4) * 4
    fit = min(8, max_bytes // whole)
    got = (len(bb.cache), bb.cache.evictions, bb.cache.resident_bytes)
    check(got == (fit, 8 - fit, fit * whole)
          and bb.cache.resident_bytes <= max_bytes,
          f"sharded cache (resident, evictions, bytes) {got}, expected "
          f"{(fit, 8 - fit, fit * whole)} under {max_bytes} B")
    log(f"[sharded] budget {max_bytes} B on one card: a model's 4 slices "
        f"count {whole} B (the whole model), so the sharded cache holds "
        f"{len(bb.cache)} of 8 parts with {bb.cache.evictions} evictions "
        f"({bb.cache.resident_bytes} B); the device backend "
        f"{len(capped.cache)} with {capped.cache.evictions}; this shows the "
        f"accounting, not a larger budget; beta diff {d8:.3g}")

    # 4. device loss: sharded -> device -> host
    sl = MLegoSession(corpus, cfg, store=store, backend="device_sharded",
                      device=device)
    with injected(FaultRule("backend.merge.device_sharded",
                            kind="device_lost", max_failures=1)):
        lost1 = sl.submit(covered)
    with injected(FaultRule("backend.merge", kind="device_lost",
                            max_failures=2)):
        lost2 = sl.submit(covered)
    check_report(lost1, "first loss", "device", "device_sharded")
    check_report(lost2, "second loss", "host", "device_sharded")
    for r in (lost1, lost2):
        close(r.beta, ref["vb"][0].beta, f"{r.backend} fallback answer")
    log("[sharded] device loss: answered by device, then by host (both "
        f"fallback from device_sharded), beta at {BETA_ATOL} + "
        f"{BETA_RTOL}·|want|")

    # 5. elastic: re-bin the store onto 4 workers, then retrain a
    # quarantined window through a session on the card
    se = MLegoSession(corpus, cfg, store=store, backend=b4, device=device)
    trained = []

    def train_fn(lo, hi):
        m = se.train_range(lo, hi)
        trained.append(m)
        return m

    parts = plan_repartition(store, iv(0, 32), 4)
    s0 = snap()
    out = apply_repartition(parts, store, cfg, train_fn)
    count_since(s0)
    check(set(out) == {p.worker for p in parts}, "a worker got no model")
    d_el = 0.0
    for p in parts:
        models = [store.get(mid) for mid in p.model_ids] + \
            [m for m in trained if m is not None and p.span.contains(m.o)]
        d_el = max(d_el, close(b4.merge(models, "vb", cfg),
                               topics_from_vb(out[p.worker].theta["lam"]),
                               f"worker {p.worker}'s merged model"))
    lost = next(m for m in store.models("vb") if m.o.lo == 20 * unit)
    store.quarantine(lost.model_id, reason="device loss")
    e0, s0 = estep_ops.launches, snap()
    fresh = recover_quarantined(store, se.train_range)
    count_since(s0)
    check([m.o for m in fresh] == [lost.o] and not store.quarantined
          and estep_ops.launches - e0 >= per_slice,
          f"recovery retrained {[str(m.o) for m in fresh]} with "
          f"{estep_ops.launches - e0} E-step launches, ledger "
          f"{store.quarantined}")
    log(f"[sharded] elastic: {n_vb} vb windows onto 4 workers "
        f"({[len(p.model_ids) for p in parts]} models, {len(trained)} "
        f"retrained), each worker's model vs its card merge {d_el:.3g}; "
        f"quarantined {lost.o} retrained with {estep_ops.launches - e0} "
        f"E-step launches, ledger empty")

    log(f"[sharded] beta against the other backends and shard counts: max "
        f"relative difference {beta_rel[0]:.3g} (tol {BETA_ATOL} + "
        f"{BETA_RTOL}·|want|)")
    log(f"[sharded] kernel launches on the sharded path (its sessions' "
        f"queries and elastic retraining): {launches}")

    # 6. the merge kernels on the slices the path gave them, against
    # their plain versions (uncounted): each of the 4 slice lists of
    # [0, 8·unit), and each slice list of the batch
    kernel_errs = {"merge_topics": 0.0, "merge_topics_ragged": 0.0}

    def hold(got, want, what):
        err = (got - want).abs()
        bad = err > MERGE_TOL + MERGE_TOL * want.abs()
        check(not bool(bad.any()) and bool(torch.isfinite(got).all()),
              f"{what}: kernel disagrees with its plain version, max abs "
              f"err {float(err.max()):.3g}, {int(bad.sum())} elements over "
              f"{MERGE_TOL} + {MERGE_TOL}·|want|")
        return float(err.max())

    for kind, c in kinds.items():
        stat_key, bias, base, _ = device_merge_params(kind, c)
        windows = sorted((m for m in store.models(kind)
                          if m.o.hi - m.o.lo == unit),
                         key=lambda m: m.o.lo)
        by_spec = [[m for m in windows if iv(a, b).contains(m.o)]
                   for a, b in spans[kind]]
        counts = [len(ps) for ps in by_spec]
        eight = [b4.cache.get(m, stat_key) for m in windows[:8]]
        batch = [b4.cache.get(m, stat_key) for ps in by_spec for m in ps]
        for s in range(4):
            sl_ = [e[s] for e in eight]
            w_ = torch.ones(len(sl_), dtype=torch.float32, device=device)
            kernel_errs["merge_topics"] = max(
                kernel_errs["merge_topics"],
                hold(merge_ops.merge_topics_parts(sl_, [1.0] * len(sl_),
                                                  bias=bias, base=base),
                     merge_topics_ref(torch.stack(sl_), w_, bias, base),
                     f"{kind} merge_topics_parts, slice {s}"))
            rows = [e[s] for e in batch]
            w_ = torch.ones(len(rows), dtype=torch.float32, device=device)
            kernel_errs["merge_topics_ragged"] = max(
                kernel_errs["merge_topics_ragged"],
                hold(merge_ops.merge_topics_parts_segments(
                    rows, counts, bias=bias, base=base),
                     merge_topics_segments_ref(torch.stack(rows), w_,
                                               counts, bias, base),
                     f"{kind} merge_topics_parts_segments, slice {s}"))
        log(f"[sharded] {kind}: merge_topics_parts on the 4 slice lists of "
            f"{len(eight)} parts, {tuple(eight[0][0].shape)} each, and "
            f"merge_topics_parts_segments on the 4 slice lists at counts "
            f"{counts}, against their plain versions: max abs err "
            f"{kernel_errs['merge_topics']:.3g} / "
            f"{kernel_errs['merge_topics_ragged']:.3g} (tol {MERGE_TOL} + "
            f"{MERGE_TOL}·|want|)")

    # 7. vb_fit_sharded on a (2, 2) grid against vb_fit on the E-step
    # kernel, from one lam0 (uncounted: a comparison)
    d = min(1000, corpus.n_docs)
    x = doc_term_matrix(corpus, 0, d)
    lam0 = np.random.default_rng(0).gamma(100.0, 0.01, (k, v)).astype(
        np.float32)
    env22 = MeshEnv([[device] * 2] * 2)
    gen = torch.Generator(device=device)
    diffs, fits10 = {}, {}
    for iters in (1, 10):
        c = dataclasses.replace(cfg, max_iters=iters)
        t0 = time.perf_counter()
        got = vb_fit_sharded(x, gen, c, env22, lam0=lam0)
        wait()
        t_sh = time.perf_counter() - t0
        want = vb_fit(x, gen, c, use_kernel=True, lam0=lam0).cpu().numpy()
        # the same fit on a (1, 1) grid: how far the sums' order alone
        # moves the iteration
        one_cell = vb_fit_sharded(x, gen, c, MeshEnv([[device]]),
                                  lam0=lam0).cpu().numpy()
        got = got.cpu().numpy()
        if iters == 10:
            fits10 = {"vb_fit (E-step kernel)": want, "(1, 1) grid": one_cell,
                      "(2, 2) grid": got}
        diffs[iters] = dict(
            abs=float(np.abs(got - want).max()),
            rel=float((np.abs(got - want) / np.abs(want)).max()),
            of_max=float(np.abs(got - want).max() / np.abs(want).max()),
            grids=float(np.abs(got - one_cell).max()), s=t_sh)
        if iters == 1:
            close(got, want, "vb_fit_sharded vs the E-step kernel's fit",
                  rtol=2e-4, atol=2e-4)
    for iters, dd in diffs.items():
        log(f"[sharded] vb_fit_sharded on a (2, 2) grid, {d} documents, "
            f"K={k}, V={v}, {iters} iteration(s): vs vb_fit on the E-step "
            f"kernel max abs {dd['abs']:.3g} (max rel {dd['rel']:.3g}, "
            f"{dd['of_max']:.3g} of max |lambda|), vs the (1, 1) grid max "
            f"abs {dd['grids']:.3g}; {dd['s']:.2f} s on {card}"
            + (" (held at 2e-4 + 2e-4·|want|)" if iters == 1 else ""))
    # the 10-iteration fits against vb_fit's loop in float64 on the plain
    # E-step (on the host: the plain E-step takes CPU tensors only; ~10 s):
    # rounding puts each float32 fit about as far from it as the float32
    # fits lie from each other (within 3x), where a fault would put one
    # fit alone far off
    t0 = time.perf_counter()
    x64 = torch.as_tensor(x, dtype=torch.float64)
    lam64 = torch.as_tensor(lam0, dtype=torch.float64)
    gamma64 = torch.ones((d, k), dtype=torch.float64)
    for _ in range(10):
        _, ss64 = vb_estep(x64, _exp_dirichlet_expectation(lam64), gamma64,
                           cfg.alpha, cfg.e_step_iters)
        lam64 = cfg.eta + ss64
    lam64 = lam64.cpu().numpy()
    to64 = {name: float(np.abs(f - lam64).max()) for name, f in fits10.items()}
    spread = max(float(np.abs(f - g).max()) for f in fits10.values()
                 for g in fits10.values())
    rounding = all(spread / 3 <= dist <= 3 * spread for dist in to64.values())
    diffs["float64"] = dict(to64=to64, spread=spread, rounding=rounding)
    log(f"[sharded] the 10-iteration float32 fits against vb_fit in float64 "
        f"(max |lambda| {float(np.abs(lam64).max()):.4g}): max abs "
        + ", ".join(f"{name} {dist:.4g}" for name, dist in to64.items())
        + f"; the float32 fits' largest spread {spread:.4g}; largest "
        f"distance / spread {max(to64.values()) / spread:.3f}, smallest "
        f"{min(to64.values()) / spread:.3f}: "
        + ("within 3x, rounding" if rounding else "NOT within 3x")
        + f"; the float64 fit {time.perf_counter() - t0:.1f} s on the host")
    if not rounding:
        raise AssertionError(f"a 10-iteration float32 fit lies outside 3x "
                             f"the fits' spread {spread:.4g} from the float64"
                             f" fit: {to64}")

    # 8. the normaliser's share of the sharded merge's wall: the merge of
    # the 8 cached parts on 4 slices against its 4 kernel launches alone
    stat_key, bias, base, _ = device_merge_params("vb", cfg)
    entries = [b4.cache.get(m, stat_key) for m in parts8]
    slices = [[e[s] for e in entries] for s in range(4)]
    w = [1.0] * 8

    def whole():
        merge_topics_sharded(slices, w, env4, bias=bias, base=base,
                             num_offset=0.0, v_true=v)

    def kernels():
        for sl_ in slices:
            merge_ops.merge_topics_parts(sl_, w, bias=bias, base=base)

    def wall_ms(fn, n=50):
        for _ in range(3):
            fn()
        wait()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        wait()
        return (time.perf_counter() - t0) * 1e3 / n

    t_whole = min(wall_ms(whole) for _ in range(3))
    t_kern = min(wall_ms(kernels) for _ in range(3))
    share = (t_whole - t_kern) / t_whole
    for name, ms in walls.items():
        log(f"[sharded] wall {name}: {ms:.2f} ms on {card}")
    log(f"[sharded] merge of 8 parts on 4 slices: {t_whole:.4f} ms a call "
        f"(host clock, synchronised, best of 3 x 50), its 4 kernel launches "
        f"alone {t_kern:.4f} ms; normaliser (mask, row sums, cross-slice "
        f"sum, division) {share * 100:.1f}% of the merge wall on {card}")
    seconds = time.perf_counter() - t_phase
    log(f"[sharded] phase ran {seconds:.1f} s")
    return dict(launches=launches, walls=walls, normaliser_share=share,
                fit_diffs=diffs, kernel_errs=kernel_errs, seconds=seconds)


def rec_split(model, params, tokens, device) -> dict:
    """Where a ``"rec"`` layer's prefill time goes, in ms (synchronised
    host clock, mean of 3 calls after one warm-up): the whole layer (a
    one-layer model's ``prefill`` over the first layer, with the embedding
    and the last position's logits), its ``rglru_seq`` (conv4, the float32
    gates, the scan) and the doubling scan alone, at the prompt's shape."""
    import torch

    from repro_torch.models import recurrent as rec
    from repro_torch.models.model import build_model

    one = build_model(dataclasses.replace(model.cfg, n_layers=1))
    p = params["layers"][0]
    p1 = {"embed": params["embed"], "final_norm": params["final_norm"],
          "layers": [p]}
    tokens = tokens.to(device)
    b, s = tokens.shape
    gen = torch.Generator(device=device).manual_seed(2)
    xin = torch.randn((b, s, model.cfg.d_model), generator=gen,
                      device=device).to(model.dtype)
    a = torch.rand((b, s, model.cfg.d_model), generator=gen, device=device)
    gated = torch.randn((b, s, model.cfg.d_model), generator=gen,
                        device=device)

    def ms(fn):
        with torch.inference_mode():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 3 * 1e3

    return dict(
        rec_layer_ms=ms(lambda: one.prefill(p1, {"tokens": tokens})),
        rglru_ms=ms(lambda: rec.rglru_seq(
            xin, p["w_rg"], p["b_rg"], p["w_ig"], p["b_ig"], p["conv_w"],
            p["conv_b"], p["lam"])),
        scan_ms=ms(lambda: rec.linear_scan(a, gated)))


def handoff_diff(cfg32, prompt: int, cache_len: int, device):
    """The JAX package's consistency check (``tests/test_arch_smoke.py``)
    on the card: ``cfg32``'s model (float32) drawn from ``torch.Generator``
    seed 0, ``decode_step`` after a ``prompt``-token prefill against a
    one-longer prefill, 2 sequences of ``make_batch``.  Returns (max abs
    difference, max abs logit, whether they agree at
    ``CONSISTENCY_TOL`` with finite logits)."""
    import torch

    from repro_torch.data.lm import make_batch
    from repro_torch.models.model import build_model

    m32 = build_model(cfg32)
    p32 = m32.init(torch.Generator(device=device).manual_seed(0))
    full = make_batch(cfg32, 2, prompt + 1, 0, 1, device=device)
    full.pop("labels")
    head = {k: (v[:, :prompt] if k == "tokens" else v)
            for k, v in full.items()}
    with torch.inference_mode():
        _, caches = m32.prefill(p32, head, cache_len=cache_len)
        lg_dec, _ = m32.decode_step(p32, caches, full["tokens"][:, prompt:],
                                    prompt)
        lg_full, _ = m32.prefill(p32, full, cache_len=cache_len)
    ok = bool(torch.isfinite(lg_full).all()) and torch.allclose(
        lg_dec, lg_full, rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)
    return (float((lg_dec - lg_full).abs().max()),
            float(lg_full.abs().max()), ok)


def families_phase(device, card: str, grid_acc: dict, grid_out: dict
                   ) -> dict:
    """Phase 10: the serving paths of the hybrid (recurrentgemma-9b), the
    VLM (llava-next-34b at 8 of its 60 layers) and the encoder–decoder
    (whisper-tiny) on the card ``device``, one model at a time, at the
    sizes of ``FAMILIES``.

    Each model's weights are drawn from ``torch.Generator`` seed 0 and
    cast layer by layer (``Model.init(cast=True)``: only one layer's
    float32 masters exist at a time); one short ``generate`` warms up,
    then the flash and decode counters are zeroed, the batch of
    ``make_batch`` goes through ``generate`` and the counters are read
    (returned under ``launches``, by path).  Checks: the launch counts
    (a prefill launches the flash kernel once per attention layer; a
    decode step launches the decode kernel once per ``"attn"`` layer, and
    nothing for ``"local"``, ``"rec"`` or cross attention), finite logits,
    tokens in the padded vocabulary, the hybrid's peak memory allocated
    at most ``HYBRID_PEAK_GB`` (the peak counter is reset before the
    draw and read twice: after the draw and cast, and after the timed
    ``generate``), the VLM's logits moved by its patch embeddings, and, in
    float32 for the hybrid (its first 3 layers: rec, rec, local) and the
    encoder–decoder, ``decode_step`` after a prompt equal to a one-longer
    prefill at ``CONSISTENCY_TOL``.  For the hybrid also phase 13 (c):
    ``grid_serve`` on a (1, 4) grid (the ``"local"`` ring: 3 of 4 steps at
    window 2,048; the RG-LRU prefix) into ``grid_acc`` / ``grid_out``,
    and ``grid_f32`` at 2 layers (rec, local) and a 4,096-token prompt.
    """
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.lm import make_batch
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import attention as attn
    from repro_torch.models.model import build_model

    out = {"launches": {}, "runs": {}}

    def check(ok, path, msg):
        if not ok:
            raise AssertionError(f"[{path}] {msg}")

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9

    for path, sz in FAMILIES.items():
        t_model = time.perf_counter()
        cfg = get_arch(sz["arch"])
        if sz["n_layers"]:
            log(f"[{path}] reduced: n_layers {cfg.n_layers} → "
                f"{sz['n_layers']} (one card's time and memory)")
            cfg = dataclasses.replace(cfg, n_layers=sz["n_layers"])
        model = build_model(cfg)
        kinds = model.kinds
        n_attn = kinds.count("attn")
        n_flash = n_attn + kinds.count("local") + cfg.n_encoder_layers
        held = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            cast=True)
        torch.cuda.synchronize()
        init_peak = peak_gb()
        log(f"[{path}] {cfg.name}: {model.param_count(params) / 1e9:.3f} B "
            f"parameters ({cfg.n_layers} layers "
            + ", ".join(f"{kinds.count(k)} {k!r}" for k in sorted(set(kinds)))
            + (f" + {cfg.n_encoder_layers} encoder" if cfg.n_encoder_layers
               else "")
            + f"; d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
            f"heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}"
            + (f", window {cfg.window}" if cfg.window else "")
            + f"), {cfg.dtype}; init + cast {time.perf_counter() - t0:.1f} s,"
            f" peak memory allocated {init_peak:.2f} GB; {held:.2f} GB held "
            f"by the earlier phases")
        b, s, steps, cache = sz["b"], sz["prompt"], sz["steps"], sz["cache"]
        batch = make_batch(cfg, b, s, 0, 0)
        batch.pop("labels")
        # a short warm-up through the same entry point, not counted
        generate(model, params, batch, steps=2, cache_len=cache)
        torch.cuda.synchronize()
        flash_ops.flash_attention_launches = 0
        decode_ops.decode_attention_launches = 0
        stats = {}
        toks = generate(model, params, batch, steps=steps, cache_len=cache,
                        stats=stats)
        got = {"flash_attention": flash_ops.flash_attention_launches,
               "decode_attention": decode_ops.decode_attention_launches}
        peak = peak_gb()
        n_gen = b * steps
        run = dict(prefill_s=stats["prefill_s"],
                   decode_ms=stats["decode_s"] / steps * 1e3,
                   decode_tok_s=n_gen / stats["decode_s"],
                   e2e_tok_s=n_gen / (stats["prefill_s"] + stats["decode_s"]),
                   init_peak_gb=init_peak, peak_gb=peak, held_gb=held)
        log(f"[{path}] generate B={b} prompt={s} cache_len={cache} "
            f"steps={steps}: prefill {run['prefill_s']:.4f} s, decode "
            f"{stats['decode_s']:.4f} s = {run['decode_ms']:.3f} ms per "
            f"step, {run['decode_tok_s']:.1f} generated tokens/s in decode, "
            f"{run['e2e_tok_s']:.1f} end to end; peak memory allocated "
            f"{peak:.2f} GB from the draw on ({held:.2f} GB of it held by "
            f"the earlier phases); on {card}")
        log(f"[{path}] kernel launches on the {path} path: {got}")
        want = {"flash_attention": n_flash,
                "decode_attention": n_attn * steps}
        check(got == want, path, f"launches {got}, expected {want}")
        check(stats["logits_finite"], path, "logits are not finite")
        check(toks.shape == (b, steps) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.padded_vocab, path,
              f"generated tokens {tuple(toks.shape)} outside "
              f"[0, {cfg.padded_vocab})")
        if path == "hybrid":
            for what, gb in (("the draw and cast", init_peak),
                             ("the whole path", peak)):
                check(gb <= HYBRID_PEAK_GB, path,
                      f"{what} allocated {gb:.2f} GB at its peak, more than "
                      f"{HYBRID_PEAK_GB} GB")
        log(f"[{path}] sample: {toks[0, :16].tolist()}")
        if "patch_embeds" in batch:
            # the patch embeddings reach the logits
            with torch.inference_mode():
                dev_batch = {k: v.to(device) for k, v in batch.items()}
                lg, _ = model.prefill(params, dev_batch)
                dev_batch["patch_embeds"] = torch.randn(
                    dev_batch["patch_embeds"].shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(1)
                ).mul_(0.02)
                lg2, _ = model.prefill(params, dev_batch)
            moved = float((lg - lg2).abs().max())
            check(moved > 1e-3, path, f"other patch embeddings moved the "
                  f"logits by {moved:.3g}")
            log(f"[{path}] other patch embeddings move the last logits by "
                f"up to {moved:.3g} (of {float(lg.abs().max()):.3g})")
            del lg, lg2, dev_batch
        if path == "hybrid":
            run.update(rec_split(model, params, batch["tokens"], device))
            log(f"[{path}] one \"rec\" layer's prefill (B={b}, S={s}): "
                f"{run['rec_layer_ms']:.3f} ms, of it rglru_seq (conv4, the "
                f"float32 gates, the scan) {run['rglru_ms']:.3f} ms and the "
                f"doubling scan alone {run['scan_ms']:.3f} ms "
                f"({run['scan_ms'] / run['rec_layer_ms']:.1%}); on {card}")
        out["launches"][path] = {k: n for k, n in got.items() if want[k]}
        out["runs"][path] = run
        del batch, toks
        torch.cuda.empty_cache()
        if path == "hybrid":
            # the "local" ring: cell r runs min(r + 1, ring_steps) steps
            n_ring = sum(min(r + 1, attn.ring_steps(4, s // 4, cfg.window))
                         for r in range(4))
            gbatch = make_batch(cfg, GRID_B, GRID_PROMPT, 0, 0)
            gbatch.pop("labels")
            grid_out[cfg.name] = grid_serve(
                cfg.name, model, params, gbatch, device, card, grid_acc,
                {"flash_attention": kinds.count("local") * n_ring,
                 "decode_attention": 0, "slstm_scan": 0})
            check(grid_out[cfg.name]["grid_peak"] <= HYBRID_PEAK_GB, path,
                  f"the grid allocated {grid_out[cfg.name]['grid_peak']:.2f}"
                  f" GB at its peak, more than {HYBRID_PEAK_GB} GB")
            del gbatch
        del params
        torch.cuda.empty_cache()
        if sz["check"]:
            # the same draw in float32: decode_step after the prompt must
            # give the logits of a one-longer prefill (the JAX package's
            # consistency check, tests/test_arch_smoke.py, at its 2e-3)
            cs, depth = sz["check"]
            c32 = dataclasses.replace(cfg, dtype="float32",
                                      n_layers=depth or cfg.n_layers)
            diff, scale, ok = handoff_diff(c32, cs, cache, device)
            torch.cuda.empty_cache()
            check(ok, path, f"float32 decode_step differs from prefill by "
                  f"{diff} (tol {CONSISTENCY_TOL})")
            log(f"[{path}] float32, {c32.n_layers} layers "
                f"{c32.layer_kinds()} at full width: decode_step(prefill("
                f"{cs})) vs prefill({cs + 1}) max abs diff {diff:.3g} over "
                f"logits up to {scale:.3g} (tol {CONSISTENCY_TOL})")
        if path == "hybrid":
            grid_f32(cfg.name, dataclasses.replace(
                cfg, dtype="float32", n_layers=2,
                block_pattern=("rec", "local")), device, s=GRID_PROMPT)
        if path == "audio":
            # whisper-tiny whole, its 6 heads: on the (1, 4) grid every
            # rank runs all of them; on (1, 2) each runs its 3 (the
            # head-split cross attention of the decode step)
            grid_f32(cfg.name, dataclasses.replace(cfg, dtype="float32"),
                     device, s=sz["prompt"], tps=(4, 2))
        log(f"[{path}] ran {time.perf_counter() - t_model:.1f} s")
    return out


def event_ms(fn, reps: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls after one
    warm-up, between two CUDA events."""
    import torch

    with torch.inference_mode():
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def moe_split(model, params, tokens, device) -> dict:
    """Where an MoE layer's prefill time goes (CUDA events, mean of 3
    calls after a warm-up) at the prompt's shape: the whole first layer
    (a one-layer model's ``prefill``, with the embedding and the last
    position's logits), its attention half (norm, q/k/v with qk-norm and
    RoPE, the flash kernel, the output projection) and its FFN
    (``Model._ffn``: route, dispatch, expert products, combine, and the
    shared expert), of which the router alone and the three expert
    products alone (on a capacity buffer of the layer's shape).  Also the
    share of (token, choice) pairs past capacity in that layer, from the
    port's ``_route`` and ``capacity_positions`` on the layer's own
    input."""
    import torch

    from repro_torch.models import attention as attn
    from repro_torch.models import moe
    from repro_torch.models.layers import norm_apply
    from repro_torch.models.model import _attn_qkv, build_model

    cfg = model.cfg
    one = build_model(dataclasses.replace(cfg, n_layers=1))
    p = params["layers"][0]
    p1 = {k: v for k, v in params.items() if k != "layers"}
    p1["layers"] = [p]
    tokens = tokens.to(device)
    b, s = tokens.shape
    positions = torch.arange(s, device=device)

    def attention(x):
        q, k, v = _attn_qkv(cfg, p["attn"], norm_apply(cfg, x, p["norm1"]),
                            positions)
        o = attn.flash_attention_local(q, k, v, causal=True)
        return x + o.reshape(b, s, cfg.q_dim) @ p["attn"]["wo"]

    with torch.inference_mode():
        x = model._embed(params, tokens)
        h2 = norm_apply(cfg, attention(x), p["norm2"])
        t, d = b * s, cfg.d_model
        _, ids, _ = moe._route(h2.reshape(t, d).float(), p["moe"]["router"],
                               cfg.moe_top_k)
        cap = moe.capacity(cfg, t)
        pos = moe.capacity_positions(ids.reshape(-1), cfg.n_experts)
        dropped = float((pos >= cap).float().mean())
        buf = torch.randn((cfg.n_experts, cap, d), device=device,
                          generator=torch.Generator(device=device)
                          .manual_seed(3)).to(model.dtype)
    w = p["moe"]
    out = dict(
        moe_layer_ms=event_ms(lambda: one.prefill(p1, {"tokens": tokens})),
        moe_attn_ms=event_ms(lambda: attention(x)),
        moe_ffn_ms=event_ms(lambda: model._ffn(p, h2, False)),
        moe_route_ms=event_ms(lambda: moe._route(
            h2.reshape(t, d).float(), w["router"], cfg.moe_top_k)),
        moe_experts_ms=event_ms(lambda: moe._expert_ffn(
            cfg, buf, w["expert_w_gate"], w["expert_w_up"],
            w["expert_w_down"])),
        drop_share=dropped, capacity=cap, pairs=t * cfg.moe_top_k)
    del x, h2, buf
    return out


def moe_phase(device, card: str, grid_acc: dict, grid_out: dict) -> dict:
    """Phase 11: the MoE serving path on the card ``device``: each of
    ``MOE_ARCHS`` at its published widths, cut to ``MOE_LAYERS`` layers,
    one model at a time (each freed before the next).

    Each model's weights are drawn from ``torch.Generator`` seed 0 and
    cast as drawn (``Model.init(cast=True)``: one expert tensor's float32
    master at a time); one short ``generate`` warms up, then the flash and
    decode counters are zeroed, ``MOE_B`` prompts of ``MOE_PROMPT`` tokens
    from ``make_batch`` go through ``generate`` (``MOE_STEPS`` greedy
    steps, a ``MOE_CACHE``-position cache) and the counters are read
    (summed over both models under ``launches``).  While it runs, the
    expert ids of every decode step's ``_route`` are recorded (a wrapper
    that keeps a reference to them, nothing more) for the step's byte
    bound by the routes taken.  Checks: a flash launch per layer per
    prefill and a decode launch per layer per step, finite logits, tokens
    in the padded vocabulary, peak memory allocated at most
    ``MOE_PEAK_GB`` over the draw and cast and over the path (each
    checked), and, in float32 at ``MOE_CHECK_LAYERS`` layers with
    capacity_factor = n_experts / moe_top_k, ``decode_step`` after a
    ``MOE_CHECK_PROMPT``-token prompt equal to a one-longer prefill at
    ``CONSISTENCY_TOL``.  Printed: prefill seconds, decode ms per step,
    tokens/s, the byte bound, ``moe_split`` and the drop share.  For
    qwen3-moe-235b-a22b also phase 13 (d): ``grid_serve`` on a (1, 4)
    grid (32 experts a cell, the ``all_to_all`` of capacity blocks; its
    peak also at most ``MOE_PEAK_GB``) into ``grid_acc`` / ``grid_out``,
    and ``grid_f32`` at 2 layers with no drops.
    """
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.lm import make_batch
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import moe
    from repro_torch.models.model import build_model

    out = {"launches": {"flash_attention": 0, "decode_attention": 0},
           "runs": {}}
    t_phase = time.perf_counter()

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"[moe] {msg}")

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9

    def n_bytes(tree):
        if isinstance(tree, dict):
            return sum(n_bytes(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(n_bytes(v) for v in tree)
        return tree.numel() * tree.element_size()

    for arch in MOE_ARCHS:
        t_model = time.perf_counter()
        cfg = get_arch(arch)
        log(f"[moe] {arch} reduced: n_layers {cfg.n_layers} → {MOE_LAYERS} "
            f"(one card's memory: the whole model does not fit)")
        cfg = dataclasses.replace(cfg, n_layers=MOE_LAYERS)
        model = build_model(cfg)
        held = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            cast=True)
        torch.cuda.synchronize()
        init_peak = peak_gb()
        log(f"[moe] {cfg.name}: {model.param_count(params) / 1e9:.3f} B "
            f"parameters ({cfg.n_layers} layers; d_model {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}"
            f"{', qk-norm' if cfg.qk_norm else ''}, {cfg.n_experts} experts "
            f"top-{cfg.moe_top_k} of d_ff {cfg.d_ff_expert}"
            + (f" + {cfg.n_shared_experts} shared" if cfg.n_shared_experts
               else "")
            + f", capacity factor {cfg.capacity_factor}, vocab "
            f"{cfg.padded_vocab}), {cfg.dtype}; init + cast "
            f"{time.perf_counter() - t0:.1f} s, peak memory allocated "
            f"{init_peak:.2f} GB; {held:.2f} GB held by the earlier phases")
        b, s, steps = MOE_B, MOE_PROMPT, MOE_STEPS
        batch = make_batch(cfg, b, s, 0, 0)
        batch.pop("labels")
        # a short warm-up through the same entry point, not counted
        generate(model, params, batch, steps=2, cache_len=MOE_CACHE)
        torch.cuda.synchronize()
        routes = []
        real_route = moe._route

        def recording_route(x, router_w, top_k):
            got = real_route(x, router_w, top_k)
            if x.shape[0] == b:                    # a decode step's
                routes.append(got[1])
            return got

        flash_ops.flash_attention_launches = 0
        decode_ops.decode_attention_launches = 0
        stats = {}
        moe._route = recording_route
        try:
            toks = generate(model, params, batch, steps=steps,
                            cache_len=MOE_CACHE, stats=stats)
        finally:
            moe._route = real_route
        got = {"flash_attention": flash_ops.flash_attention_launches,
               "decode_attention": decode_ops.decode_attention_launches}
        peak = peak_gb()
        n_gen = b * steps
        run = dict(prefill_s=stats["prefill_s"],
                   decode_ms=stats["decode_s"] / steps * 1e3,
                   decode_tok_s=n_gen / stats["decode_s"],
                   e2e_tok_s=n_gen / (stats["prefill_s"] + stats["decode_s"]),
                   init_peak_gb=init_peak, peak_gb=peak, held_gb=held)
        # the decode step's byte bound by the routes taken: each layer's
        # distinct experts (3·d·f weights each), every other weight of the
        # layers and the unembedding once, B embedding rows, the live
        # K/V cache (the mean position) and the new K/V
        check(len(routes) == MOE_LAYERS * steps,
              f"recorded {len(routes)} decode routes, expected "
              f"{MOE_LAYERS * steps}")
        ids = torch.stack(routes).reshape(len(routes), -1)
        distinct = torch.zeros((len(routes), cfg.n_experts),
                               device=ids.device).scatter_(1, ids, 1.0).sum(1)
        elt = params["embed"].element_size()
        expert_b = 3 * cfg.d_model * cfg.d_ff_expert * elt
        other_b = n_bytes(params["layers"]) - \
            cfg.n_experts * expert_b * MOE_LAYERS
        mean_pos = s + (steps - 1) / 2
        kv_b = MOE_LAYERS * 2 * b * (mean_pos + 1) * cfg.n_kv_heads * \
            cfg.hd * elt
        step_b = (float(distinct.sum()) / steps * expert_b + other_b
                  + n_bytes(params.get("unembed", params["embed"])) + kv_b
                  + b * cfg.d_model * elt)
        run.update(distinct_experts=float(distinct.mean()),
                   decode_bound_gb=step_b / 1e9,
                   decode_bound_ms=step_b / PEAK_BYTES_S * 1e3,
                   decode_gather_gb=b * cfg.moe_top_k * expert_b
                   * MOE_LAYERS / 1e9)
        del routes, ids, distinct
        log(f"[moe] {arch} generate B={b} prompt={s} cache_len={MOE_CACHE} "
            f"steps={steps}: prefill {run['prefill_s']:.4f} s, decode "
            f"{stats['decode_s']:.4f} s = {run['decode_ms']:.3f} ms per "
            f"step, {run['decode_tok_s']:.1f} generated tokens/s in decode, "
            f"{run['e2e_tok_s']:.1f} end to end; peak memory allocated "
            f"{peak:.2f} GB from the draw on ({held:.2f} GB of it held by "
            f"the earlier phases); on {card}")
        log(f"[moe] {arch} decode step: {run['distinct_experts']:.2f} "
            f"distinct experts a layer (of {cfg.n_experts}; B·k = "
            f"{b * cfg.moe_top_k} pairs), byte bound by the routes taken "
            f"{run['decode_bound_gb']:.3f} GB = {run['decode_bound_ms']:.3f}"
            f" ms at {PEAK_BYTES_S / 1e12} TB/s; the per-pair weight gather "
            f"copies {run['decode_gather_gb']:.3f} GB a step on top")
        log(f"[moe] kernel launches on the moe path ({arch}): {got}")
        want = {"flash_attention": MOE_LAYERS,
                "decode_attention": MOE_LAYERS * steps}
        check(got == want, f"{arch}: launches {got}, expected {want}")
        check(stats["logits_finite"], f"{arch}: logits are not finite")
        check(toks.shape == (b, steps) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.padded_vocab,
              f"{arch}: generated tokens {tuple(toks.shape)} outside "
              f"[0, {cfg.padded_vocab})")
        for what, gb in (("the draw and cast", init_peak),
                         ("the whole path", peak)):
            check(gb <= MOE_PEAK_GB, f"{arch}: {what} allocated {gb:.2f} GB "
                  f"at its peak, more than {MOE_PEAK_GB} GB")
        log(f"[moe] {arch} sample: {toks[0, :16].tolist()}")
        for k, n in got.items():
            out["launches"][k] += n
        run.update(moe_split(model, params, batch["tokens"], device))
        log(f"[moe] {arch} one layer's prefill (B={b}, S={s}): "
            f"{run['moe_layer_ms']:.3f} ms; attention (norm, q/k/v, flash, "
            f"out projection) {run['moe_attn_ms']:.3f} ms; MoE FFN (route, "
            f"dispatch, expert products, combine"
            f"{', shared expert' if cfg.n_shared_experts else ''}) "
            f"{run['moe_ffn_ms']:.3f} ms, of it the router "
            f"{run['moe_route_ms']:.3f} ms and the expert products "
            f"{run['moe_experts_ms']:.3f} ms; {run['drop_share']:.2%} of "
            f"the first layer's {run['pairs']} (token, choice) pairs past "
            f"capacity {run['capacity']}; on {card}")
        out["runs"][arch] = run
        del batch, toks
        torch.cuda.empty_cache()
        if arch == "qwen3-moe-235b-a22b":
            gbatch = make_batch(cfg, GRID_B, GRID_PROMPT, 0, 0)
            gbatch.pop("labels")
            grid_out[arch] = grid_serve(
                arch, model, params, gbatch, device, card, grid_acc,
                {"flash_attention": MOE_LAYERS * sum(range(1, 5)),
                 "decode_attention": MOE_LAYERS * 4 * GRID_STEPS,
                 "slstm_scan": 0})
            check(grid_out[arch]["grid_peak"] <= MOE_PEAK_GB,
                  f"{arch}: the grid allocated "
                  f"{grid_out[arch]['grid_peak']:.2f} GB at its peak, more "
                  f"than {MOE_PEAK_GB} GB")
            del gbatch
        del params
        torch.cuda.empty_cache()
        # the same draw in float32 at a capacity where no pair can drop:
        # decode_step after the prompt must give the logits of a one-longer
        # prefill (the JAX package's check, tests/test_arch_smoke.py, at
        # its 2e-3).  At the config's capacity factor the prefill drops
        # pairs by how many tokens share its batch and decode drops none,
        # so the two differ by design, in JAX as here
        c32 = dataclasses.replace(
            cfg, dtype="float32", n_layers=MOE_CHECK_LAYERS,
            capacity_factor=cfg.n_experts / cfg.moe_top_k)
        cs = MOE_CHECK_PROMPT
        diff, scale, ok = handoff_diff(c32, cs, MOE_CACHE, device)
        torch.cuda.empty_cache()
        check(ok, f"{arch}: float32 decode_step differs from prefill by "
              f"{diff} (tol {CONSISTENCY_TOL})")
        run["handoff_diff"] = diff
        log(f"[moe] {arch} float32, {c32.n_layers} layers at full width, "
            f"capacity factor {c32.capacity_factor} (no drops): "
            f"decode_step(prefill({cs})) vs prefill({cs + 1}) max abs diff "
            f"{diff:.3g} over logits up to {scale:.3g} (tol "
            f"{CONSISTENCY_TOL})")
        if arch == "qwen3-moe-235b-a22b":
            grid_f32(arch, c32, device, s=MOE_CHECK_PROMPT)
        left = torch.cuda.memory_allocated() / 1e9
        check(left <= held + 0.1, f"{arch}: {left:.2f} GB still allocated "
              f"after the model was freed ({held:.2f} GB before it)")
        log(f"[moe] {arch} ran {time.perf_counter() - t_model:.1f} s")
    log(f"[moe] phase ran {time.perf_counter() - t_phase:.1f} s, the script "
        f"{time.perf_counter() - T_START:.0f} s so far")
    return out


def kernel_counters() -> list:
    """(module, name) of every kernel launch counter of the port."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.gibbs_sweep import ops as gibbs_ops
    from repro_torch.kernels.merge_topics import ops as merge_ops
    from repro_torch.kernels.slstm_scan import ops as slstm_ops
    from repro_torch.kernels.vb_estep import ops as estep_ops
    return [(mod, n) for mod in (merge_ops, estep_ops, gibbs_ops, flash_ops,
                                 decode_ops, slstm_ops)
            for n in sorted(vars(mod)) if n.endswith("launches")
            and isinstance(getattr(mod, n), int)]


def report_counters() -> dict:
    """{kernel name of the report: (module, counter name)}, derived from
    ``kernel_counters()``: ``<name>_launches``, or the E-step module's bare
    ``launches``; the sLSTM scan's per-route counts are not kernels."""
    from repro_torch.kernels.slstm_scan import ops as slstm_ops
    routes = {f"slstm_{r}_launches" for r in slstm_ops.ROUTES}
    return {(n[:-len("_launches")] if n != "launches"
             else mod.__name__.split(".")[-2]): (mod, n)
            for mod, n in kernel_counters() if n not in routes}


def read_counts(names) -> dict:
    """{kernel name of the report: its launch counter now}."""
    counters = report_counters()
    return {k: getattr(*counters[k]) for k in names}


def train_split(model, params, x, positions) -> dict:
    """One layer's forward and backward in training form at x's shape,
    split by CUDA events (mean of 3 after a warm-up): the attention half
    (norm, q/k/v, ``ring_attention``, out projection) and the rest (norm,
    MLP)."""
    import torch

    from repro_torch.models import attention as attn
    from repro_torch.models.layers import mlp_apply, norm_apply
    from repro_torch.models.model import _attn_qkv
    cfg = model.cfg
    p = params
    b, s, _ = x.shape

    def attn_half(x):
        h = norm_apply(cfg, x, p["norm1"])
        q, k, v = _attn_qkv(cfg, p["attn"], h, positions)
        o = attn.ring_attention(q, k, v, causal=True)
        return x + o.reshape(b, s, cfg.q_dim) @ p["attn"]["wo"]

    def mlp_half(x):
        return x + mlp_apply(cfg, p["mlp"], norm_apply(cfg, x, p["norm2"]))

    def fwd_bwd(fn):
        def run():
            xi = x.detach().requires_grad_()
            out = fn(xi)
            out.backward(torch.ones_like(out))
        return run

    def ev(fn, reps=3):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    for leaf in (v for d in (p["attn"], p["mlp"]) for v in d.values()):
        leaf.requires_grad_()
    out = dict(train_attn_ms=ev(fwd_bwd(attn_half)),
               train_mlp_ms=ev(fwd_bwd(mlp_half)))
    with torch.no_grad():
        out["train_attn_fwd_ms"] = ev(lambda: attn_half(x))
    for leaf in (v for d in (p["attn"], p["mlp"]) for v in d.values()):
        leaf.requires_grad_(False)
        leaf.grad = None
    return out


def train_phase(device, card: str) -> dict:
    """Phase 12: LM training on the card ``device`` (see the module
    docstring, phase 12 (a)–(d)).  Returns the numbers it printed and the
    kernel counters read after (a), every one of them zeroed just
    before."""
    import itertools
    import statistics
    import tempfile

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.lm import batch_stream, make_batch
    from repro_torch.models.model import build_model
    from repro_torch.train import OptimizerConfig, Trainer
    from repro_torch.train.optim import leaves, unflatten

    t_phase = time.perf_counter()

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"[train] {msg}")

    # -- (a) full width ---------------------------------------------------------
    cfg = get_arch(TRAIN_ARCH)
    model = build_model(cfg)
    opt = OptimizerConfig(name="adamw", lr=1e-3, warmup_steps=2)
    trainer = Trainer(model, opt, remat=True, seed=0, device=device)
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    probes = []

    def start():
        # no reference to the first state outlives this call: fit's loop
        # then holds two states at a time (the step's input and output)
        st = trainer.init_state()
        probes.extend([st.params["embed"][:8].clone(),
                       st.params["layers"][0]["attn"]["wq"][:8].clone(),
                       st.params["layers"][-1]["norm2"]["scale"].clone(),
                       model.param_count(st.params)])
        return st

    batch = make_batch(cfg, TRAIN_B, TRAIN_S, 0, 0, device)
    log(f"[train] {cfg.name}: {cfg.param_count() / 1e9:.3f} B parameters "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.padded_vocab}, tied {cfg.tie_embeddings}), {cfg.dtype} "
        f"compute, float32 masters, AdamW; batch {TRAIN_B} x {TRAIN_S} "
        f"(train_4k's global batch of 256 cut to {TRAIN_B} for one card)")
    real_step = trainer._step_fn
    stamps, metrics = [], []

    def timed_step(*args):
        out = real_step(*args)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        metrics.append(out[3])
        return out

    trainer._step_fn = timed_step
    counters = kernel_counters()
    for mod, n in counters:
        setattr(mod, n, 0)
    stamps.append(time.perf_counter())
    state = trainer.fit(start(), itertools.repeat(batch), TRAIN_STEPS,
                        log_every=0)
    n_params = probes.pop()
    launches = {f"{mod.__name__.split('.')[-2]}.{n}": getattr(mod, n)
                for mod, n in counters}
    trainer._step_fn = real_step
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    med = statistics.median(step_s[1:])
    tokens = TRAIN_B * TRAIN_S
    # operations a step: 6·N·T for the forward and backward products
    # (the tied embedding counted once, as the head), 2·N·T for the
    # second forward of every layer (remat) and of the head (its chunks
    # are recomputed), and JAX's attention math: 4·B·H·S²·hd a forward
    # over every chunk, masked or not, run five times (forward, remat,
    # each chunk's recompute, two for the backward's four products)
    attn_ops = 5 * 4 * TRAIN_B * cfg.n_heads * TRAIN_S ** 2 * cfg.hd \
        * cfg.n_layers
    ops = 8 * n_params * tokens + attn_ops
    bound_s = ops / PEAK_BF16_TC_FLOPS
    moved = [not torch.equal(a, b) for a, b in zip(probes, [
        state.params["embed"][:8], state.params["layers"][0]["attn"]["wq"][:8],
        state.params["layers"][-1]["norm2"]["scale"]])]
    log(f"[train] losses {[round(x, 6) for x in losses]}; grad norms "
        f"{[round(x, 4) for x in gnorms]}; step seconds "
        f"{[round(x, 4) for x in step_s]}")
    log(f"[train] {cfg.name} step (median of steps 2-{TRAIN_STEPS}): "
        f"{med:.4f} s, {tokens / med:.1f} tokens/s; {ops:.4g} operations a "
        f"step ({attn_ops:.4g} of them attention), bound "
        f"{bound_s:.4f} s at {PEAK_BF16_TC_FLOPS / 1e12:.0f} TFLOP/s "
        f"({bound_s / med:.1%} of it); peak memory allocated {peak:.2f} GB "
        f"({held:.2f} GB held by the earlier phases); on {card}")
    log(f"[train] kernel launches on the train path: {launches}")
    check(all(x == x and abs(x) != float("inf") for x in losses),
          f"a loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(all(moved), f"parameters did not move: {moved}")
    check(peak <= TRAIN_PEAK_GB, f"training allocated {peak:.2f} GB at its "
          f"peak, more than {TRAIN_PEAK_GB} GB")
    check(int(state.step) == TRAIN_STEPS, f"step {int(state.step)}")
    check(not any(launches.values()), f"training launched {launches}")
    out = dict(train_step_s=med, train_tok_s=tokens / med, train_ops=ops,
               train_bound_s=bound_s, train_peak_gb=peak, train_held_gb=held,
               losses=losses, step_s=step_s, launches=launches)
    positions = torch.arange(TRAIN_S, device=device)
    with torch.no_grad():
        layer0 = model.cast_params(state.params)["layers"][0]
        x = torch.randn((TRAIN_B, TRAIN_S, cfg.d_model), device=device,
                        generator=torch.Generator(device=device).manual_seed(1)
                        ).to(model.dtype)
    del state, batch, probes, metrics
    torch.cuda.empty_cache()
    out.update(train_split(model, layer0, x, positions))
    share = out["train_attn_ms"] / (out["train_attn_ms"] + out["train_mlp_ms"])
    log(f"[train] one layer's forward + backward (B={TRAIN_B}, S={TRAIN_S}): "
        f"attention (norm, q/k/v, ring_attention, out projection) "
        f"{out['train_attn_ms']:.3f} ms (its forward alone "
        f"{out['train_attn_fwd_ms']:.3f} ms), the rest (norm, MLP) "
        f"{out['train_mlp_ms']:.3f} ms: attention {share:.1%}; x "
        f"{cfg.n_layers} layers = {(out['train_attn_ms'] + out['train_mlp_ms']) * cfg.n_layers / 1e3:.3f} s "
        f"(remat adds a forward); on {card}")
    out["train_attn_share"] = share
    del layer0, x, trainer, model
    torch.cuda.empty_cache()

    # -- (b) restart, bit for bit ----------------------------------------------
    rcfg = dataclasses.replace(get_arch(TRAIN_ARCH).reduced(),
                               dtype="bfloat16")
    rmodel = build_model(rcfg)

    def stream(start=0):
        return batch_stream(rcfg, 2, 64, seed=0, start_cursor=start,
                            device=device)

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = Trainer(rmodel, opt, device=device)
        ref = t0.fit(t0.init_state(), stream(), 6, log_every=0)
        t1 = Trainer(rmodel, opt, ckpt_dir=tmp, save_every=4, device=device)
        t1.fit(t1.init_state(), stream(), 4, log_every=0)
        t2 = Trainer(rmodel, opt, ckpt_dir=tmp, save_every=100,
                     device=device)
        got = t2.restore_or_init()
        check(int(got.step) == 4, f"restored step {int(got.step)}")
        got = t2.fit(got, stream(got.data_cursor), 2, log_every=0)
    pairs = list(zip(leaves(ref.params) + leaves(ref.opt_state),
                     leaves(got.params) + leaves(got.opt_state)))
    same = sum(torch.equal(a, b) for a, b in pairs)
    log(f"[train] {rcfg.name} in bf16: 6 steps against 4 + checkpoint + "
        f"restore + 2: {same} of {len(pairs)} parameter and optimizer "
        f"leaves the same bits")
    check(same == len(pairs), f"restart differs in {len(pairs) - same} "
          f"leaves")

    # -- (c) float32: the card against the CPU --------------------------------
    diffs = {}
    for arch in TRAIN_FAMILIES:
        fcfg = get_arch(arch).reduced()
        fmodel = build_model(fcfg)
        params = fmodel.init(torch.Generator().manual_seed(0))
        fbatch = make_batch(fcfg, 2, 64, 0, 0)
        res = {}
        for dev in ("cpu", device):
            flat = [x.to(dev).requires_grad_() for x in leaves(params)]
            loss, _ = fmodel.loss(unflatten(params, flat),
                                  {k: v.to(dev) for k, v in fbatch.items()})
            res[str(dev)] = (float(loss.detach()), [g.cpu() for g in
                                           torch.autograd.grad(loss, flat)])
        (l_c, g_c), (l_d, g_d) = res["cpu"], res[str(device)]
        rel = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
                  for a, b in zip(g_d, g_c))
        diffs[arch] = (abs(l_d - l_c), rel)
        log(f"[train] {fcfg.name} float32: loss card {l_d:.7f} CPU "
            f"{l_c:.7f} (|diff| {abs(l_d - l_c):.3g}, tol {TRAIN_LOSS_TOL}); "
            f"gradients: max |diff| / leaf max {rel:.3g} over "
            f"{len(g_c)} leaves (tol {TRAIN_GRAD_TOL})")
        check(abs(l_d - l_c) <= TRAIN_LOSS_TOL * max(1.0, abs(l_c)),
              f"{arch}: loss on the card {l_d} against {l_c}")
        check(rel <= TRAIN_GRAD_TOL, f"{arch}: gradients differ by {rel} "
              f"of a leaf's largest magnitude")
    out["handoff"] = diffs

    # -- (d) the kernel wrappers refuse tensors that require grad --------------
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.merge_topics import ops as merge_ops
    from repro_torch.kernels.slstm_scan import ops as slstm_ops
    from repro_torch.kernels.slstm_scan.ref import zero_state
    gen = torch.Generator(device=device).manual_seed(2)

    def rnd(shape, dt=torch.float32):
        return torch.randn(shape, device=device, generator=gen).to(dt)

    bf = torch.bfloat16
    calls = {
        "flash_attention": lambda rg: flash_ops.flash_attention(
            rnd((1, 64, 4, 64), bf).requires_grad_(rg), rnd((1, 64, 2, 64), bf),
            rnd((1, 64, 2, 64), bf)),
        "decode_attention": lambda rg: decode_ops.decode_attention(
            rnd((1, 1, 4, 64), bf).requires_grad_(rg),
            rnd((1, 64, 2, 64), bf), rnd((1, 64, 2, 64), bf), 10),
        "slstm_scan": lambda rg: slstm_ops.slstm_scan(
            rnd((1, 8, 4, 2, 16)).requires_grad_(rg), rnd((2, 16, 64)) * 0.25,
            *zero_state(1, 2, 16, device))[0],
        "merge_topics_parts": lambda rg: merge_ops.merge_topics_parts(
            [rnd((8, 64)).abs().requires_grad_(rg), rnd((8, 64)).abs()],
            [1.0, 2.0], bias=0.1, base=0.1),
    }
    for kname, call in calls.items():
        try:
            call(True)
        except ValueError as e:
            check("ring_attention" in str(e), f"{kname}: {e}")
        else:
            raise AssertionError(f"[train] {kname} took an input that "
                                 f"requires grad")
        with torch.no_grad():
            y = call(True)
        check(not y.requires_grad and bool(torch.isfinite(y.float()).all()),
              f"{kname} under no_grad")
        check(bool(torch.isfinite(call(False).float()).all()),
              f"{kname} on inputs that need no grad")
    torch.cuda.synchronize()
    log(f"[train] {sorted(calls)} raise ValueError on CUDA inputs that "
        f"require grad, and run under torch.no_grad() and on inputs that "
        f"need none")
    log(f"[train] phase ran {time.perf_counter() - t_phase:.1f} s, the script "
        f"{time.perf_counter() - T_START:.0f} s so far")
    return out


# ---------------------------------------------------------------------------
# phase 13: the grid
# ---------------------------------------------------------------------------

def grid_env(device, shape, axis_names=("data", "model")):
    """A grid that names ``device`` at every cell: (1, 4), (2, 2), or
    ("stage",) x n."""
    from repro_torch.distributed.sharding import MeshEnv
    if len(shape) == 1:
        return MeshEnv((device,) * shape[0], axis_names=axis_names)
    return MeshEnv([[device] * shape[1]] * shape[0])


GRID_KERNELS = ("flash_attention", "decode_attention", "slstm_scan")


def grid_zero() -> None:
    """Every counter of the kernels the grid paths launch set to 0."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.slstm_scan import ops as slstm_ops
    flash_ops.flash_attention_launches = 0
    decode_ops.decode_attention_launches = 0
    slstm_ops.slstm_scan_launches = 0
    for route in slstm_ops.ROUTES:
        setattr(slstm_ops, f"slstm_{route}_launches", 0)


def grid_read(acc: dict) -> dict:
    """The counters now, added into ``acc`` (the grid path's sums)."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.slstm_scan import ops as slstm_ops
    got = {"flash_attention": flash_ops.flash_attention_launches,
           "decode_attention": decode_ops.decode_attention_launches,
           "slstm_scan": slstm_ops.slstm_scan_launches}
    for k, n in got.items():
        acc[k] = acc.get(k, 0) + n
    return got


def rel_diff(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / max(float(want.float().abs().max()), 1e-30))


def grid_serve(tag: str, model, params, batch, device, card: str,
               acc: dict, want: dict) -> dict:
    """Phase 13 (a)–(d): one model's serving path through ``generate`` on
    one device, then on a (1, 4) grid of the same card (the sequence over
    four cells: S_loc = prompt / 4), ``GRID_STEPS`` greedy steps in a
    ``GRID_CACHE``-position cache, each from a reset peak.  The grid's
    launches (counters zeroed just before its ``generate``, read just
    after) are added to ``acc`` and must equal ``want``.  In bf16 only
    printed: the largest difference of the prefill's last logits and
    the share of greedy tokens that agree (random weights leave near-ties).
    Checked: finite logits, tokens in the vocabulary, the grid's peak at
    most ``GRID_PEAK_RATIO`` times one device's."""
    import torch

    from repro_torch.launch.serve import generate

    env = grid_env(device, (1, 4))
    cfg = model.cfg
    dev_batch = {k: v.to(device) for k, v in batch.items()}
    with torch.inference_mode():
        lg1, c = model.prefill(params, dev_batch, cache_len=GRID_CACHE)
        del c
        lg2, c = model.prefill(params, dev_batch, cache_len=GRID_CACHE,
                               env=env)
        del c
    diff, scale = float((lg1 - lg2).abs().max()), float(lg1.abs().max())
    del lg1, lg2
    torch.cuda.empty_cache()
    runs = {}
    for name, e in (("one device", None), ("grid (1, 4)", env)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if e is not None:
            grid_zero()
        stats = {}
        toks = generate(model, params, batch, steps=GRID_STEPS,
                        cache_len=GRID_CACHE, stats=stats, env=e)
        got = grid_read(acc) if e is not None else None
        runs[name] = dict(toks=toks, stats=stats, got=got,
                          peak=torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.empty_cache()
    one, grid = runs["one device"], runs["grid (1, 4)"]
    agree = float((one["toks"] == grid["toks"]).float().mean())
    b = batch["tokens"].shape[0]
    for name, r in runs.items():
        st = r["stats"]
        log(f"[grid] {tag} {name}: B={b} prompt={batch['tokens'].shape[1]} "
            f"cache_len={GRID_CACHE} steps={GRID_STEPS}: prefill "
            f"{st['prefill_s']:.4f} s, decode {st['decode_s']:.4f} s = "
            f"{st['decode_s'] / GRID_STEPS * 1e3:.3f} ms per step; peak "
            f"memory allocated {r['peak']:.2f} GB; on {card}")
    log(f"[grid] {tag} bf16: prefill logits max abs diff {diff:.4g} over "
        f"logits up to {scale:.4g}; greedy tokens agree {agree:.1%}; grid "
        f"launches {grid['got']}")
    one_ms, grid_ms = (r["stats"]["decode_s"] / GRID_STEPS * 1e3
                       for r in (one, grid))
    log(f"[grid] {tag}: the weight-stationary grid decode step (each of the "
        f"4 cells multiplies by its own pieces of the weights) "
        f"{grid_ms:.3f} ms against one device's {one_ms:.3f} ms "
        f"({grid_ms / one_ms:.2f}x); on {card}")
    if grid["got"] != want:
        raise AssertionError(f"[grid] {tag}: launches {grid['got']}, "
                             f"expected {want}")
    for name, r in runs.items():
        if not r["stats"]["logits_finite"]:
            raise AssertionError(f"[grid] {tag} {name}: logits not finite")
        t = r["toks"]
        if t.shape != (b, GRID_STEPS) or int(t.min()) < 0 or \
                int(t.max()) >= cfg.padded_vocab:
            raise AssertionError(f"[grid] {tag} {name}: tokens outside "
                                 f"[0, {cfg.padded_vocab})")
    if grid["peak"] > GRID_PEAK_RATIO * one["peak"]:
        raise AssertionError(f"[grid] {tag}: the grid's peak "
                             f"{grid['peak']:.2f} GB is over "
                             f"{GRID_PEAK_RATIO} x one device's "
                             f"{one['peak']:.2f} GB")
    return dict(diff=diff, scale=scale, agree=agree, one_peak=one["peak"],
                grid_peak=grid["peak"],
                one_prefill_s=one["stats"]["prefill_s"],
                grid_prefill_s=grid["stats"]["prefill_s"],
                one_decode_ms=one_ms, grid_decode_ms=grid_ms)


def grid_f32(tag: str, cfg32, device, s: int = GRID_CHECK_S,
             tps: tuple = (4,)) -> float:
    """Phase 13's hard check of a serving path: ``cfg32`` (float32, the
    same widths at 2 layers) drawn from seed 0, 2 prompts of ``s`` tokens
    prefilled and 4 greedy steps decoded on one device and on a (1, n)
    grid of the card for each n of ``tps``, in the train profile (each
    weight cut on its output
    dim: column-parallel products) and in the serve profile (``wo``,
    ``w_down`` and ``proj_in`` cut on their contraction dim: row-parallel
    products, partials added over ``model``), the weights cut into their
    pieces once before the prefill; every logit within ``GRID_TOL`` of one
    device's, relative to the largest magnitude, and the grid's greedy
    token of every step one device's.  Returns the largest."""
    import torch

    from repro_torch.data.lm import make_batch
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.model import build_model

    model = build_model(cfg32)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    batch = make_batch(cfg32, 2, s, 0, 0, device=device)
    batch.pop("labels")
    worst = 0.0
    for tp, profile in ((tp, pr) for tp in tps for pr in ("train", "serve")):
        env = sh.MeshEnv([[device] * tp], profile=profile)
        cut = sh.pieces(params, env)
        errs, same = [], True
        with torch.inference_mode():
            l1, c1 = model.prefill(params, batch, cache_len=s + 8)
            l2, c2 = model.prefill(cut, batch, cache_len=s + 8, env=env)
            errs.append(rel_diff(l2, l1))
            for step in range(5):
                tok = l1[:, -1].argmax(-1)[:, None].to(torch.int32)
                same = same and torch.equal(
                    tok, l2[:, -1].argmax(-1)[:, None].to(torch.int32))
                if step == 4:
                    break
                l1, c1 = model.decode_step(params, c1, tok, s + step)
                l2, c2 = model.decode_step(cut, c2, tok, s + step, env=env)
                errs.append(rel_diff(l2, l1))
        if not same:
            raise AssertionError(f"[grid] {tag}: float32 {profile}-profile "
                                 f"grid greedy tokens differ from one "
                                 f"device's")
        log(f"[grid] {tag} float32, {cfg32.n_layers} layers "
            f"{list(cfg32.layer_kinds())} at full width, B=2 prompt={s}: "
            f"the (1, {tp}) {profile}-profile grid's prefill and 4 decode "
            f"steps' logits within {max(errs):.3g} of one device's, of the "
            f"largest (tol {GRID_TOL}); greedy tokens equal")
        if not max(errs) <= GRID_TOL:
            raise AssertionError(f"[grid] {tag}: float32 {profile}-profile "
                                 f"grid logits differ by {max(errs):.3g} of "
                                 f"the largest (tol {GRID_TOL})")
        worst = max(worst, max(errs))
        del cut, c1, c2, l1, l2
    del model, params, batch
    torch.cuda.empty_cache()
    return worst


def grid_pipeline(model, params, device, card: str, acc: dict) -> dict:
    """Phase 13 (e): qwen3-1.7b's layers as 4 stages of n / 4 on a
    ("stage",) x 4 grid of the card, ``n_micro`` = 4, through
    ``pipeline_apply`` against the layers applied in order (prefill-form
    layers: the flash kernel, RoPE at positions 0..S-1), on the embedded
    tokens of 4 prompts of 1,024; bf16 printed.  Then the hard check:
    float32, 2 layers as 2 stages of 1 on ("stage",) x 2, within
    ``GRID_TOL``."""
    import torch

    from repro_torch.data.lm import make_batch
    from repro_torch.distributed.pipeline import (pipeline_apply,
                                                  pipeline_bubble)
    from repro_torch.models import attention as attn
    from repro_torch.models.model import build_model

    def run(model, params, env, n_stages, s, acc):
        layers = params["layers"]
        per = len(layers) // n_stages
        stages = [layers[i * per:(i + 1) * per] for i in range(n_stages)]
        tokens = make_batch(model.cfg, 4, s, 0, 2, device=device)["tokens"]
        positions = torch.arange(s, device=device)

        def layer_fn(ps, h):
            for p in ps:
                h = model._attn_layer(
                    p, h, positions, lambda q, k, v: attn.flash_attention_local(
                        q, k, v, causal=True))[0]
            return h

        with torch.inference_mode():
            x = model._embed(params, tokens)
            want = layer_fn(layers, x)
            grid_zero()
            t0 = time.perf_counter()
            got = pipeline_apply(layer_fn, stages, x, env=env, axis="stage",
                                 n_micro=4)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = grid_read(acc)
        return rel_diff(got, want), counts, secs

    cfg = model.cfg
    env = grid_env(device, (4,), ("stage",))
    diff, counts, secs = run(model, params, env, 4, 1024, acc)
    log(f"[grid] pipeline {cfg.name}: {cfg.n_layers} layers as 4 stages of "
        f"{cfg.n_layers // 4}, n_micro 4 (bubble {pipeline_bubble(4, 4):.3f})"
        f", B=4 S=1024 bf16: {secs:.3f} s; against the layers in order max "
        f"diff {diff:.3g} of the largest; launches {counts}; on {card}")
    if counts["flash_attention"] != cfg.n_layers * 4:
        raise AssertionError(f"[grid] the pipeline launched the flash kernel "
                             f"{counts['flash_attention']} times, expected "
                             f"{cfg.n_layers * 4}")
    c32 = dataclasses.replace(cfg, dtype="float32",
                              n_layers=GRID_CHECK_LAYERS)
    m32 = build_model(c32)
    p32 = m32.init(torch.Generator(device=device).manual_seed(0))
    env2 = grid_env(device, (2,), ("stage",))
    diff32, _, _ = run(m32, p32, env2, 2, 512, {})   # a check, uncounted
    log(f"[grid] pipeline float32, {c32.n_layers} layers as 2 stages of 1: "
        f"within {diff32:.3g} of the layers in order (tol {GRID_TOL})")
    if not diff32 <= GRID_TOL:
        raise AssertionError(f"[grid] float32 pipeline differs by {diff32:.3g}"
                             f" of the largest (tol {GRID_TOL})")
    del m32, p32
    torch.cuda.empty_cache()
    return dict(diff=diff, diff32=diff32, secs=secs)


def grid_train(device, card: str) -> dict:
    """Phase 13 (f): training on a (2, 2) grid of the card (data 2 x
    sequence 2) after phase 12 has freed its state: qwen3-1.7b's widths at
    ``GRID_TRAIN_LAYERS`` of its 28 layers, AdamW (lr 1e-3, warmup 2),
    ``GRID_TRAIN_STEPS`` steps on one batch of 2 x 4,096 tokens, against
    the one-device ``Trainer`` on the same weights (seed 0) and batch: the
    masters and the optimizer state rest as pieces by
    ``infer_param_specs``.  bf16: the losses and the largest parameter
    difference printed; the grid's peak at most ``GRID_PEAK_RATIO`` x one
    device's and at most ``TRAIN_PEAK_GB``.  Hard check: float32 at 2
    layers, ``Model.loss`` and every gradient on the grid within
    ``GRID_TOL`` of one device's (each leaf against its largest); and the
    update on the pieces (``grid_update_f32``).  Prints each run's
    seconds a step and the update's share of it."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.lm import make_batch
    from repro_torch.models.model import build_model
    from repro_torch.train import OptimizerConfig, Trainer
    from repro_torch.train.optim import build_optimizer, leaves, unflatten
    from repro_torch.train.trainer import join_tree

    cfg = dataclasses.replace(get_arch(TRAIN_ARCH),
                              n_layers=GRID_TRAIN_LAYERS)
    model = build_model(cfg)
    opt = OptimizerConfig(name="adamw", lr=1e-3, warmup_steps=2)
    batch = make_batch(cfg, TRAIN_B, TRAIN_S, 0, 0, device=device)
    env = grid_env(device, (2, 2))
    runs = {}
    for name, e in (("one device", None), ("grid (2, 2)", env)):
        # the first checkpointed step of a process leaves its frames, and
        # the state they hold, in a reference cycle (torch._dynamo's lazy
        # import keeps them) that only the collector frees: without this
        # the grid's peak would count the one-device run's state
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(model, opt, seed=0, device=device, env=e)
        state = tr.init_state()
        losses = []
        t0 = time.perf_counter()
        for _ in range(GRID_TRAIN_STEPS):
            params, opt_state, step, m = tr._step_fn(
                state.params, state.opt_state, state.step, batch)
            state = dataclasses.replace(state, params=params,
                                        opt_state=opt_state, step=step)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / GRID_TRAIN_STEPS
        peak = torch.cuda.max_memory_allocated() / 1e9
        # the update alone, on the masters' tree in the gradients' place
        # (the same layout and dtype; the time does not read the values)
        update = build_optimizer(opt, model.jax_stacks(state.params),
                                 env=e)[1]
        t0 = time.perf_counter()
        update(state.params, state.opt_state, state.params, state.step)
        torch.cuda.synchronize()
        upd_s = time.perf_counter() - t0
        whole = state.params if e is None else join_tree(state.params, e)
        runs[name] = dict(losses=losses, s_step=secs, update_s=upd_s,
                          peak=peak,
                          params=[t.detach().clone() for t in leaves(whole)])
        del tr, state, params, opt_state, whole
        torch.cuda.empty_cache()
    one, grid = runs["one device"], runs["grid (2, 2)"]
    pdiff = max(float((a - b).abs().max())
                for a, b in zip(one["params"], grid["params"]))
    for name, r in runs.items():
        log(f"[grid] train {cfg.name} at {cfg.n_layers} layers, {name}: "
            f"B={TRAIN_B} S={TRAIN_S}, {GRID_TRAIN_STEPS} steps, "
            f"{r['s_step']:.3f} s a step (the update {r['update_s']:.4f} s, "
            f"{r['update_s'] / r['s_step']:.1%} of it), losses "
            f"{[round(x, 4) for x in r['losses']]}, peak memory allocated "
            f"{r['peak']:.2f} GB; on {card}")
    log(f"[grid] train bf16: after {GRID_TRAIN_STEPS} steps the grid's "
        f"masters lie within {pdiff:.3g} of one device's")
    for name, r in runs.items():
        if not all(abs(x) < float("inf") for x in r["losses"]):
            raise AssertionError(f"[grid] train {name}: a loss is not finite")
    if grid["peak"] > min(GRID_PEAK_RATIO * one["peak"], TRAIN_PEAK_GB):
        raise AssertionError(f"[grid] train: the grid's peak "
                             f"{grid['peak']:.2f} GB is over "
                             f"{GRID_PEAK_RATIO} x one device's "
                             f"{one['peak']:.2f} GB or {TRAIN_PEAK_GB} GB")
    summary = {k: {f: r[f] for f in ("s_step", "update_s", "peak")}
               for k, r in runs.items()}
    del runs, one, grid
    torch.cuda.empty_cache()

    c32 = dataclasses.replace(cfg, dtype="float32",
                              n_layers=GRID_CHECK_LAYERS)
    m32 = build_model(c32)
    p32 = m32.init(torch.Generator(device=device).manual_seed(0))
    full = make_batch(c32, 2, GRID_CHECK_S, 0, 0, device=device)
    got = []
    for e in (None, env):
        ps = [t.clone().requires_grad_() for t in leaves(p32)]
        loss, _ = m32.loss(unflatten(p32, ps), full, env=e)
        got.append((float(loss.detach()), torch.autograd.grad(loss, ps)))
    (l1, g1), (l2, g2) = got
    gerr = max(rel_diff(b, a) for a, b in zip(g1, g2))
    lerr = abs(l2 - l1) / abs(l1)
    log(f"[grid] train float32, {c32.n_layers} layers, B=2 S={GRID_CHECK_S}"
        f" on the (2, 2) grid: loss {l2:.6f} against {l1:.6f} (rel "
        f"{lerr:.3g}), every gradient within {gerr:.3g} of its largest "
        f"(tol {GRID_TOL})")
    if not (lerr <= GRID_TOL and gerr <= GRID_TOL):
        raise AssertionError(f"[grid] float32 training on the grid differs: "
                             f"loss {lerr:.3g}, gradients {gerr:.3g}")
    del m32, p32, got, g1, g2
    torch.cuda.empty_cache()
    upd = grid_update_f32(c32, env, device, card)
    return dict(pdiff=pdiff, gerr=gerr, lerr=lerr, update_f32=upd,
                runs=summary)


def grid_update_f32(c32, env, device, card: str) -> dict:
    """Phase 13 (f)'s hard check of the update on pieces, float32 at
    ``GRID_CHECK_LAYERS`` layers of qwen3-1.7b's widths: ``GRID_TRAIN_STEPS``
    steps of AdamW and of Adafactor (lr 1e-3, warmup 2) from the same
    masters, each step's gradient taken on one device (B=2,
    S=``GRID_CHECK_S``) and given to both the one-device update on whole
    leaves and the grid's update on the (2, 2) grid's pieces
    (``build_optimizer(..., env=)``): the joined masters and optimizer
    state within ``GRID_TOL`` of one device's, each leaf against its
    largest, and the gradient norms too.  (The same gradients keep the
    grid's reordered forward out of it: that is the gradient check's.)"""
    import torch

    from repro_torch.data.lm import make_batch
    from repro_torch.models.model import build_model
    from repro_torch.train import OptimizerConfig, build_optimizer
    from repro_torch.train.optim import leaves, tree_map, unflatten
    from repro_torch.train.trainer import join_tree, shard_tree

    m32 = build_model(c32)
    full = make_batch(c32, 2, GRID_CHECK_S, 0, 0, device=device)
    out = {}
    for name in ("adamw", "adafactor"):
        opt = OptimizerConfig(name=name, lr=1e-3, warmup_steps=2)
        init = build_optimizer(opt)[0]
        p1 = m32.init(torch.Generator(device=device).manual_seed(0))
        s1 = init(p1)
        p2 = shard_tree(tree_map(torch.clone, p1), env)
        s2 = shard_tree(init(p1), env)
        stacks = m32.jax_stacks(p1)
        one = build_optimizer(opt, stacks)[1]
        grid = build_optimizer(opt, stacks, env=env)[1]
        secs = {"one": 0.0, "grid": 0.0}
        gns = []
        for i in range(GRID_TRAIN_STEPS):
            ps = [t.clone().requires_grad_() for t in leaves(p1)]
            loss, _ = m32.loss(unflatten(p1, ps), full)
            g = unflatten(p1, list(torch.autograd.grad(loss, ps)))
            del loss, ps
            gp = shard_tree(tree_map(torch.clone, g), env)
            step = torch.tensor(i, dtype=torch.int32, device=device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p1, s1, gn1 = one(g, s1, p1, step)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            p2, s2, gn2 = grid(gp, s2, p2, step)
            torch.cuda.synchronize()
            secs["one"] += t1 - t0
            secs["grid"] += time.perf_counter() - t1
            gns.append((float(gn1), float(gn2)))
            del g, gp
        got = leaves(join_tree(p2, env)) + leaves(join_tree(s2, env))
        want = leaves(p1) + leaves(s1)
        if len(got) != len(want) or any(a.shape != b.shape
                                         for a, b in zip(want, got)):
            raise AssertionError(f"[grid] {name}: the joined state's leaves "
                                 f"differ from one device's")
        err = max(rel_diff(b, a) for a, b in zip(want, got))
        gerr = max(abs(b - a) / a for a, b in gns)
        log(f"[grid] update on pieces, float32, {c32.n_layers} layers, "
            f"{name}, {GRID_TRAIN_STEPS} steps on the same gradients: "
            f"masters and state within {err:.3g} of one device's, each leaf "
            f"of its largest; grad_norm within {gerr:.3g} (tol {GRID_TOL}); "
            f"the update {secs['one'] / GRID_TRAIN_STEPS:.4f} s on one "
            f"device, {secs['grid'] / GRID_TRAIN_STEPS:.4f} s on the "
            f"(2, 2) grid's pieces; on {card}")
        if not (err <= GRID_TOL and gerr <= GRID_TOL):
            raise AssertionError(f"[grid] the {name} update on pieces "
                                 f"differs: state {err:.3g}, grad_norm "
                                 f"{gerr:.3g} (tol {GRID_TOL})")
        out[name] = dict(err=err, gerr=gerr,
                         one_s=secs["one"] / GRID_TRAIN_STEPS,
                         grid_s=secs["grid"] / GRID_TRAIN_STEPS)
        del p1, s1, p2, s2, got, want
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 14: the example scripts
# ---------------------------------------------------------------------------

# (label, script under examples/, arguments, kernels it must launch)
EXAMPLES = (
    ("quickstart", "quickstart_torch.py", [], ("vb_estep",)),
    ("interactive", "interactive_analysis_torch.py", [], ("vb_estep",)),
    ("serve xlstm-1.3b", "serve_lm_torch.py", ["--arch", "xlstm-1.3b"],
     ("slstm_scan",)),
    ("serve qwen3-1.7b", "serve_lm_torch.py", ["--arch", "qwen3-1.7b"],
     ("flash_attention", "decode_attention")),
    ("train", "train_lm_torch.py", [], ()),
)
EXAMPLE_LPP_SPREADS = 3.0   # a card lpp's room: 3x the CPU seeds' spread
# the wrapper the examples reach for each kernel: (package under
# repro_torch.kernels, function); the E-step's dense wrapper calls
# vb_estep_csr, which launches
EXAMPLE_WRAPPERS = {"vb_estep": ("vb_estep", "vb_estep_csr"),
                    "flash_attention": ("flash_attention", "flash_attention"),
                    "decode_attention": ("decode_attention",
                                         "decode_attention"),
                    "slstm_scan": ("slstm_scan", "slstm_scan")}


def copy_inputs(x):
    """A call's argument with its tensors cloned (a dataclass such as the
    E-step's CSR field by field), so that what the caller later writes in
    place (a decode cache) does not change it."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: copy_inputs(getattr(
            x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(copy_inputs(v) for v in x)
    return x


def input_key(kname: str, args: dict) -> tuple:
    """(key, size) of a wrapper's call: calls of one key are one row of
    the kernel checks, and the call of the largest size is kept.  The
    E-step's key is (K, V) and n_iters and its size the documents D (one
    fit a window); the others' key is every tensor's shape and dtype and
    every other argument but the decode position, their size 0 (the first
    call is kept)."""
    import torch
    if kname == "vb_estep":
        return ((tuple(args["exp_elog_beta"].shape), args["n_iters"]),
                args["gamma0"].shape[0])
    return tuple((n, tuple(v.shape), str(v.dtype))
                 if isinstance(v, torch.Tensor) else (n, v)
                 for n, v in args.items() if n != "pos"), 0


def recording(kname: str, fn, label: list, captured: dict):
    """``fn`` that also keeps, in ``captured[(kname, label[0], key)]``, a
    copy of its inputs (``input_key``) before it runs them."""
    import functools
    import inspect
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        key, size = input_key(kname, bound.arguments)
        slot = (kname, label[0], key)
        if slot not in captured or size > captured[slot][0]:
            captured[slot] = (size, {n: copy_inputs(v) for n, v in
                                     bound.arguments.items()})
        return fn(*args, **kwargs)
    return wrapper


def load_example(script: str, seed: int = 0):
    """A fresh module of ``examples/<script>``; with ``seed`` its
    ``MLegoSession`` opens sessions at that seed."""
    import functools
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{Path(script).stem}_{seed}", ROOT / "examples" / script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if seed:
        mod.MLegoSession = functools.partial(mod.MLegoSession, seed=seed)
    return mod


def example_split(facts: dict) -> tuple:
    """(planning facts, held-out lpps) of an MLego script's ``main``: the
    lpps pulled out in the order the script printed them, the rest (model
    ids, tokens, parts, store, Alg. 4's totals, gaps, spans) left."""
    lpps = []

    def strip(x):
        if isinstance(x, dict):
            if "lpp" in x:
                lpps.append(x["lpp"])
            return {k: strip(v) for k, v in x.items()
                    if k not in ("lpp", "device")}
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x
    return strip(facts), lpps


def examples_phase(device, card: str) -> dict:
    """Phase 14: the four torch example scripts' ``main`` run in this
    process on the card, as a user runs them (``--device``), each with
    every kernel counter zeroed just before and read just after; each
    script's wall time and launches are printed.  The two MLego scripts run
    first on the CPU at session seeds 0 and 1 (the kernels' plain
    versions): on the card every planning fact must equal the seed-0 CPU
    run's, and every held-out lpp must lie within ``EXAMPLE_LPP_SPREADS``
    x the two CPU seeds' spread of the interval they span (the card draws
    other random numbers than the CPU).  The serve scripts run first on
    the CPU too (their weights and prompts are drawn there): the card's
    tokens must equal the CPU's, and be finite of the shape asked for.
    The train script: finite losses, the restart's step and cursor.  While
    the scripts run on the card, the wrappers of ``EXAMPLE_WRAPPERS`` keep
    a copy of one call's inputs at each shape (``recording``).  Returns
    the launches summed over the scripts, each script's wall time and
    launches, and those inputs by (kernel, script, key)."""
    import contextlib
    import importlib
    import io

    import numpy as np
    import torch

    t_phase = time.perf_counter()

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"[examples] {msg}")

    cpu = {}
    for label, script, argv, _ in EXAMPLES[:4]:
        t0 = time.perf_counter()
        runs = []
        for seed in ((0,) if label.startswith("serve") else (0, 1)):
            with contextlib.redirect_stdout(io.StringIO()):
                runs.append(load_example(script, seed).main(
                    argv + ["--device", "cpu"]))
        if label.startswith("serve"):
            cpu[label] = runs[0]["tokens"]
            log(f"[examples] {label} on the CPU "
                f"({time.perf_counter() - t0:.1f} s)")
            continue
        runs = [example_split(f) for f in runs]
        check(runs[0][0] == runs[1][0],
              f"{label}: the CPU's two seeds planned differently")
        cpu[label] = runs
        log(f"[examples] {label} on the CPU, seeds 0 and 1 "
            f"({time.perf_counter() - t0:.1f} s): lpp "
            f"{[round(x, 4) for x in runs[0][1]]} and "
            f"{[round(x, 4) for x in runs[1][1]]}")

    counters = report_counters()
    total = dict.fromkeys(counters, 0)
    out = {}
    # the wrappers keep a copy of one call's inputs at each shape, for the
    # kernel checks after the phase
    captured, current = {}, [None]
    wrapped = []
    for kname, (pkg, fn_name) in EXAMPLE_WRAPPERS.items():
        mod = importlib.import_module(f"repro_torch.kernels.{pkg}.ops")
        fn = getattr(mod, fn_name)
        wrapped.append((mod, fn_name, fn))
        setattr(mod, fn_name, recording(kname, fn, current, captured))
    torch.cuda.empty_cache()
    try:
        for label, script, argv, kernels in EXAMPLES:
            mod = load_example(script)
            current[0] = label
            log(f"[examples] {label}: examples/{script} "
                f"{' '.join(argv + ['--device', str(device)])}")
            for m, n in kernel_counters():
                setattr(m, n, 0)
            t0 = time.perf_counter()
            facts = mod.main(argv + ["--device", str(device)])
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            got = {k: getattr(m, n) for k, (m, n) in counters.items()}
            for k, n in got.items():
                total[k] += n
            launched = {k: n for k, n in got.items() if n}
            extra = ""
            if "slstm_scan" in kernels:
                from repro_torch.kernels.slstm_scan import ops as slstm_ops
                extra = ", sLSTM routes " + str(
                    {r: getattr(slstm_ops, f"slstm_{r}_launches")
                     for r in slstm_ops.ROUTES})
            log(f"[examples] {label}: {wall:.2f} s wall, launches "
                f"{launched}{extra}; on {card}")
            for k in kernels:
                check(got[k] > 0, f"{label} never launched {k}")
                check(any(c[:2] == (k, label) for c in captured),
                      f"{label}: no call of {k} was recorded")
            check(facts["device"] == str(device), f"{label} ran on "
                  f"{facts['device']}")
            if label.startswith("serve"):
                check(facts["tokens_shape"] == [4, 24]
                      and facts["logits_finite"]
                      and all(0 <= t < facts["padded_vocab"]
                              for row in facts["tokens"] for t in row),
                      f"{label}: tokens {facts['tokens_shape']}, finite "
                      f"{facts['logits_finite']}")
                check(facts["tokens"] == cpu[label],
                      f"{label}: the card's tokens {facts['tokens']} differ "
                      f"from the CPU's {cpu[label]}")
                log(f"[examples] {label}: the card's {facts['tokens_shape']}"
                    f" tokens equal the CPU's")
            elif label in cpu:
                plan, lpps = example_split(facts)
                (plan0, lpp0), (_, lpp1) = cpu[label]
                check(plan == plan0, f"{label}: the card's plan facts {plan}"
                      f" differ from the CPU's {plan0}")
                for g, a, b in zip(lpps, lpp0, lpp1):
                    room = EXAMPLE_LPP_SPREADS * abs(a - b)
                    check(min(a, b) - room <= g <= max(a, b) + room,
                          f"{label}: lpp {g} outside [{min(a, b)}, "
                          f"{max(a, b)}] +- {room}")
                check(len(lpps) == len(lpp0), f"{label}: lpp count")
                log(f"[examples] {label}: plan facts equal the CPU's; lpp "
                    f"{[round(x, 4) for x in lpps]} within "
                    f"{EXAMPLE_LPP_SPREADS}x the CPU seeds' spread")
            else:
                check(all(np.isfinite(x) for _, x in facts["losses"])
                      and (facts["resumed_step"], facts["resumed_cursor"],
                           facts["final_step"]) == (60, 60, 70),
                      f"{label}: losses {facts['losses']}, resumed at "
                      f"{facts['resumed_step']} (cursor "
                      f"{facts['resumed_cursor']}), ended at "
                      f"{facts['final_step']}")
            out[label] = dict(wall_s=wall, launches=launched)
            del mod, facts
    finally:
        for mod, fn_name, fn in wrapped:
            setattr(mod, fn_name, fn)
    torch.cuda.empty_cache()
    log(f"[examples] phase 14 ran {time.perf_counter() - t_phase:.1f} s; "
        f"launches {total}; on {card}")
    return dict(launches=total, runs=out,
                captured={k: a for k, (_, a) in captured.items()})

# ---------------------------------------------------------------------------
# phase 15: the dry run held against the card
# ---------------------------------------------------------------------------

DRY_PEAK_TOL = 0.10        # predicted peak against phase 12's, relative
DRY_OUT = ROOT / "experiments" / "dryrun_torch"


def node_train_bytes(cfg) -> dict:
    """Phase 15 (d): phase 13 (f)'s training step (``cfg`` at
    ``GRID_TRAIN_LAYERS`` layers, ``TRAIN_B`` x ``TRAIN_S`` tokens) dry-run
    on the "node" grid: each card's argument, output and peak bytes
    printed; fails unless card 0's output bytes are each other card's plus
    the step counter's and the 4 metrics' 20."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_env

    gcfg = dataclasses.replace(cfg, n_layers=GRID_TRAIN_LAYERS)
    rec = dryrun.run_cell(gcfg, ShapeConfig("grid_train", TRAIN_S, TRAIN_B,
                                            "train"), make_env("node"),
                          "node")
    by = rec["bytes_per_device"]
    arg, res, peak = (by["argument_by_device"], by["output_by_device"],
                      by["peak_by_device"])

    def gb(xs):
        return [round(x / 1e9, 4) for x in xs]

    log(f"[dryrun] (d) {cfg.name} at {gcfg.n_layers} layers, train B="
        f"{TRAIN_B} S={TRAIN_S}, {rec['optimizer']}, on 'node' (dry run "
        f"{rec['trace_s']:.1f} s): card 0 against cards 1-7, GB: argument "
        f"{gb(arg[:1])} / {gb(arg[1:])}; output {gb(res[:1])} / "
        f"{gb(res[1:])} (card 0 {res[0] - max(res[1:])} bytes more); peak "
        f"{gb(peak[:1])} / {gb(peak[1:])} ({peak[0] / max(peak[1:]):.4f} x "
        f"the busiest other)")
    if not all(res[0] == r + 20 for r in res[1:]):
        raise AssertionError(
            f"[dryrun] grid training on the node: card 0's output bytes "
            f"{res[0]} are not each other card's {res[1:]} plus the step and "
            f"4 metrics (20)")
    return dict(argument=arg, output=res, peak=peak, trace_s=rec["trace_s"])


def dryrun_phase(device, card: str, train_out: dict) -> dict:
    """Phase 15: ``launch/dryrun.py``'s predictions for qwen3-1.7b at full
    width, each held against the same step run on the card under the same
    ``OpCounter`` (module docstring).  Returns the numbers it printed and
    the kernel launches of its real runs, every counter zeroed just
    before them."""
    import torch

    from repro_torch.configs import get_arch, get_shape
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.lm import make_batch
    from repro_torch.distributed.sharding import MeshEnv
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.cost import OpCounter, storage_bytes
    from repro_torch.launch.mesh import make_env
    from repro_torch.models.model import build_model
    from repro_torch.train.optim import build_optimizer
    from repro_torch.train.trainer import make_train_step, shard_tree

    t_phase = time.perf_counter()

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"[dryrun] {msg}")

    cfg = get_arch(TRAIN_ARCH)
    model = build_model(cfg)
    fake_card = make_env("card")
    env = MeshEnv(((device,),))          # the same (1, 1) grid, real
    bf16 = torch.bfloat16
    out = {}

    # -- (a) phase 12's step -------------------------------------------------
    shape = ShapeConfig("phase12_train", TRAIN_S, TRAIN_B, "train")
    rec = dryrun.run_cell(cfg, shape, fake_card, "card")
    params = model.init(torch.Generator(device=device).manual_seed(0))
    opt_cfg = specs.pick_optimizer(params)
    state = build_optimizer(opt_cfg)[0](params)
    state_bytes = sum(storage_bytes((params, state)).values())
    batch = make_batch(cfg, TRAIN_B, TRAIN_S, 0, 0, device)
    args = [shard_tree(params, env), shard_tree(state, env),
            torch.zeros((), dtype=torch.int32, device=device),
            specs.shard_batch(batch, env)]
    del params, state, batch
    step_fn = make_train_step(model, opt_cfg, remat=True, env=env)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    with OpCounter() as c:
        real_arg = c.track(args)[device]
        new = step_fn(*args[:3], specs.join_batch(args.pop(), env))
        torch.cuda.synchronize()
    # the step's own allocations at its peak, above its arguments (held)
    real_temp = torch.cuda.max_memory_allocated() / 1e9 - held
    del new, args
    torch.cuda.empty_cache()
    pred, meas = rec["bytes_per_device"], train_out
    meas_peak = meas["train_peak_gb"] - meas["train_held_gb"]
    roof, step_s = rec["roofline"], meas["train_step_s"]
    log(f"[dryrun] (a) {cfg.name} train step B={TRAIN_B} S={TRAIN_S} on "
        f"'card' (dry run {rec['trace_s']:.1f} s): argument "
        f"{pred['argument'] / 1e9:.4f} GB predicted, {real_arg / 1e9:.4f} "
        f"GB on the card (parameters and AdamW state {state_bytes / 1e9:.4f}"
        f" GB, the batch and the step); peak {pred['peak'] / 1e9:.2f} GB "
        f"predicted, phase 12 {meas_peak:.2f} GB ({meas['train_peak_gb']:.2f}"
        f" less {meas['train_held_gb']:.2f} held); above the arguments "
        f"{pred['temp'] / 1e9:.2f} GB predicted, {real_temp:.2f} GB for "
        f"this step on the card; FLOPs {rec['op_analysis']['flops']:.6g} "
        f"predicted, {c.devices[device].flops:.6g} counted on the card")
    log(f"[dryrun] (a) roofline of the step: compute "
        f"{roof['compute_s']:.4f} s, memory {roof['memory_s']:.4f} s "
        f"(kernelized {roof['memory_kernelized_s']:.4f} s), link "
        f"{roof['collective_s']:.4f} s, dominant {roof['dominant']}; phase "
        f"12's step {step_s:.4f} s is {roof['compute_s'] / step_s:.1%} "
        f"compute bound, {roof['memory_s'] / step_s:.1%} memory bound; on "
        f"{card}")
    check(pred["argument"] == real_arg, f"argument {pred['argument']} "
          f"predicted, {real_arg} on the card")
    check(real_arg == state_bytes + 2 * TRAIN_B * TRAIN_S * 4 + 4,
          f"argument {real_arg} is not the state's {state_bytes} bytes, "
          f"the batch and the step")
    check(abs(pred["peak"] / 1e9 / meas_peak - 1) <= DRY_PEAK_TOL,
          f"peak {pred['peak'] / 1e9:.2f} GB predicted, {meas_peak:.2f} GB "
          f"measured by phase 12 (tolerance {DRY_PEAK_TOL:.0%})")
    check(abs(pred["temp"] / 1e9 / real_temp - 1) <= DRY_PEAK_TOL,
          f"{pred['temp'] / 1e9:.2f} GB above the arguments predicted, "
          f"{real_temp:.2f} GB on the card (tolerance {DRY_PEAK_TOL:.0%})")
    check(rec["op_analysis"]["flops"] == c.devices[device].flops,
          f"FLOPs {rec['op_analysis']['flops']} predicted, "
          f"{c.devices[device].flops} counted on the card")
    out["train"] = dict(pred_peak_gb=pred["peak"] / 1e9,
                        meas_peak_gb=meas_peak,
                        pred_temp_gb=pred["temp"] / 1e9,
                        step_temp_gb=real_temp,
                        argument=real_arg,
                        flops=rec["op_analysis"]["flops"], roofline=roof,
                        step_s=step_s)

    # -- (b) phase 6's prefill and one decode step ---------------------------
    p_shape = ShapeConfig("phase6_prefill", SERVE_PROMPT, SERVE_B, "prefill")
    d_shape = ShapeConfig("phase6_decode", SERVE_CACHE, SERVE_B, "decode")
    recs = {"prefill": dryrun.run_cell(cfg, p_shape, fake_card, "card"),
            "decode": dryrun.run_cell(cfg, d_shape, fake_card, "card")}
    params = shard_tree(model.init(torch.Generator(device=device)
                                   .manual_seed(0), cast=True), env)
    tokens = make_batch(cfg, SERVE_B, SERVE_PROMPT, 0, 0, device)["tokens"]
    caches = model.init_cache(SERVE_B, SERVE_CACHE, env=env)
    counters = kernel_counters()
    for mod, n in counters:
        setattr(mod, n, 0)
    counted, launched = {}, {}
    with torch.no_grad():
        with OpCounter() as cp:
            model.prefill(params, {"tokens": tokens}, env=env)
        launched["prefill"] = read_counts(GRID_KERNELS)
        with OpCounter() as cd:
            model.decode_step(params, caches, tokens[:, -1:],
                              torch.tensor(SERVE_PROMPT, dtype=torch.int32,
                                           device=device), env=env)
        torch.cuda.synchronize()
    counted = {"prefill": cp.devices[device], "decode": cd.devices[device]}
    totals = read_counts(GRID_KERNELS)
    launched["decode"] = {k: totals[k] - launched["prefill"][k]
                          for k in totals}
    del params, tokens, caches
    torch.cuda.empty_cache()
    # the grid's ring step and split-K shard return the lse (float32 out)
    want = {"prefill": ("flash_attention", flash_ops.cost(
                SERVE_B, SERVE_PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                bf16, return_lse=True)),
            "decode": ("decode_attention", decode_ops.cost(
                SERVE_B, SERVE_CACHE, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                bf16, SERVE_CACHE - 1, return_lse=True))}
    for mode, r in recs.items():
        kname, cost = want[mode]
        op, real = r["op_analysis"], counted[mode]
        n = op["kernel_launches"].get(kname, 0)
        log(f"[dryrun] (b) {cfg.name} {mode} B={SERVE_B} S="
            f"{p_shape.seq_len if mode == 'prefill' else d_shape.seq_len} on "
            f"'card': {kname} {n} shape-only launches predicted, "
            f"{launched[mode][kname]} launched on the card; the kernel's "
            f"FLOPs {op['kernel_flops'].get(kname, 0):.6g} and bytes "
            f"{op['kernel_bytes'].get(kname, 0):.6g} = {n} x cost(...) "
            f"({cost.flops:.6g}, {cost.n_bytes:.6g}); step FLOPs "
            f"{op['flops']:.6g} predicted, {real.flops:.6g} counted on the "
            f"card; peak {r['bytes_per_device']['peak'] / 1e9:.3f} GB, "
            f"roofline {r['roofline']['dominant']} "
            f"(compute {r['roofline']['compute_s'] * 1e3:.3f} ms, memory "
            f"{r['roofline']['memory_s'] * 1e3:.3f} ms)")
        check(n == cfg.n_layers == launched[mode][kname],
              f"{mode}: {n} shape-only {kname} launches, "
              f"{launched[mode][kname]} on the card, {cfg.n_layers} layers")
        check(op["kernel_flops"][kname] == n * cost.flops
              and op["kernel_bytes"][kname] == n * cost.n_bytes,
              f"{mode}: {kname} counted at {op['kernel_flops'][kname]} FLOPs"
              f" and {op['kernel_bytes'][kname]} bytes, not {n} x its cost")
        check(op["flops"] == real.flops, f"{mode}: FLOPs {op['flops']} "
              f"predicted, {real.flops} counted on the card")
        out[mode] = dict(launches=n, flops=op["flops"],
                         peak_gb=r["bytes_per_device"]["peak"] / 1e9,
                         roofline=r["roofline"])

    # -- (c) decode_32k on the node ------------------------------------------
    DRY_OUT.mkdir(parents=True, exist_ok=True)
    rec = dryrun.run_cell(cfg, get_shape("decode_32k"), make_env("node"),
                          "node")
    path = DRY_OUT / f"{cfg.name}__decode_32k__node.json"
    path.write_text(json.dumps(rec, indent=1))
    op = rec["op_analysis"]
    coll = op["collective_counts"]
    stray = dryrun.stray_decode_gathers(rec)
    log(f"[dryrun] (c) {cfg.name} decode_32k on 'node' (dry run "
        f"{rec['trace_s']:.1f} s): peak "
        f"{rec['bytes_per_device']['peak'] / 1e9:.2f} GB a card (fits "
        f"{rec['fits']}), collectives {coll}, link "
        f"{op['collective_wire_bytes']:.6g} bytes a card "
        f"({op['collective_wire_bytes'] / 1e9:.4f} GB), FLOPs "
        f"{op['flops']:.6g} a card, roofline {rec['roofline']['dominant']} "
        f"(compute {rec['roofline']['compute_s'] * 1e3:.4f} ms, memory "
        f"{rec['roofline']['memory_s'] * 1e3:.4f} ms, link "
        f"{rec['roofline']['collective_s'] * 1e3:.4f} ms); weight leaves "
        f"gathered {rec['weight_gathers']}; written to "
        f"{path.relative_to(ROOT)}")
    check(path.exists() and sum(coll.values()) > 0,
          f"decode_32k on the node: collectives {coll}")
    check(not stray, f"decode_32k on the node: the decode step all-gathers "
          f"weight leaves {stray} (weight-stationary: none but the head's "
          f"feature dim)")
    out["node_decode"] = dict(peak_gb=rec["bytes_per_device"]["peak"] / 1e9,
                              collective_counts=coll, fits=rec["fits"],
                              wire_bytes=op["collective_wire_bytes"],
                              flops=op["flops"])

    # -- (d) phase 13 (f)'s training step on the node ------------------------
    out["node_train"] = node_train_bytes(cfg)
    out["launches"] = read_counts(report_counters())
    log(f"[dryrun] phase 15 ran {time.perf_counter() - t_phase:.1f} s, the "
        f"script {time.perf_counter() - T_START:.0f} s so far")
    return out


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "check needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.api import Interval, MLegoSession, QuerySpec
    from repro_torch.configs.lda_default import LDAConfig
    from repro_torch.core.lda import log_predictive_probability
    from repro_torch.data.corpus import doc_term_matrix, make_corpus
    from repro_torch.kernels import common
    from repro_torch.core.gibbs import (
        blocked_layout, cgs_fit, cgs_fit_blocked)
    from repro_torch.kernels.gibbs_sweep import ops as gibbs_ops
    from repro_torch.kernels.gibbs_sweep.ref import (
        cgs_sweep_exact_ref, gibbs_sweep_ref)
    from repro_torch.kernels.merge_topics import ops as merge_ops
    from repro_torch.kernels.merge_topics.ref import (
        merge_topics_batched_ref, merge_topics_ref, merge_topics_segments_ref)
    from repro_torch.kernels.vb_estep import ops as estep_ops
    from repro_torch.kernels.vb_estep.ref import (
        vb_estep_csr_ref, vb_estep_ref)
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.slstm_scan import ops as slstm_ops
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref, zero_state

    card = card_line()
    dev = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    common.load_library()
    log(f"[build] {common.library_path().name} ready in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in common.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("[build]", line.strip())

    # -- 2. kernels against their plain versions ---------------------------
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    # stream memory for ~50 ms before the first timing: the card idled
    # through the build, and the first kernel timed on its cold clocks
    # read about twice its time
    for _ in range(600):
        flush.zero_()
    torch.cuda.synchronize()

    def time_ms(fn, reps: int, read_flush: bool = False) -> float:
        """Mean device time of one call, L2 flushed before each (by
        writing 256 MB).  All calls are queued behind a sleep, so the
        events bracket the kernels and not the host's launch overhead.
        ``read_flush`` reads the 256 MB instead, leaving no dirty lines
        in L2 (a diagnostic: every row's time is the writing flush's)."""
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda._sleep(20_000_000)
        for a, b in ev:
            if read_flush:
                flush.sum()
            else:
                flush.zero_()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in ev) / reps

    def close(got, want, tol, rtol=None) -> float:
        """Max abs error of ``got``; raises unless every element is within
        tol + rtol·|want| (rtol = tol unless given)."""
        rtol = tol if rtol is None else rtol
        err = (got - want).abs()
        bad = err > tol + rtol * want.abs()
        if bool(bad.any()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(
                f"kernel disagrees with its plain version: max abs err "
                f"{float(err.max()):.3g}, {int(bad.sum())} elements over "
                f"{tol} + {rtol}·|want|")
        return float(err.max())

    rng = np.random.default_rng(0)
    cfg0 = LDAConfig()
    report = {}

    # merge_topics: the (n, K, V) form and the parts form (n separate
    # tensors through the kernel's pointer table: by value up to 128, a
    # device table above), each held at 1e-5 and repeated bit for bit
    errs = []
    for n, k, v in [(8, 100, 8192), (1, 6, 150)]:
        st = torch.tensor(rng.gamma(1.0, 1.0, (n, k, v)), dtype=torch.float32,
                          device=dev)
        w = torch.tensor(rng.uniform(0.2, 2.0, n), dtype=torch.float32,
                         device=dev)
        eta = 0.01
        got = merge_ops.merge_topics(st, w, bias=eta, base=eta)
        errs.append(close(got, merge_topics_ref(st, w, eta, eta), MERGE_TOL))
        log(f"[kernels] merge_topics n={n} K={k} V={v}: max abs err "
            f"{errs[-1]:.3g} (tol {MERGE_TOL})")
        if (n, k, v) == (8, 100, 8192):
            s2 = st.view(n, -1).t()
            c = torch.tensor([eta * (1.0 - float(w.sum()))], device=dev)
            ms = time_ms(lambda: merge_ops.merge_topics(st, w, eta, eta), 20)
            plain = time_ms(lambda: merge_topics_ref(st, w, eta, eta), 20)
            lib = time_ms(lambda: torch.addmv(c, s2, w), 20)
            parts8 = list(st.unbind(0))
            ms_parts = time_ms(lambda: merge_ops.merge_topics_parts(
                parts8, [1.0] * n, eta, eta), 20)
            # the kernel the single merge used to run (the batched entry
            # point at b = 1), and both after a reading flush
            ms_b1 = time_ms(lambda: merge_ops.merge_topics_batch(
                st[None], w[None], eta, eta), 20)
            ms_read = time_ms(lambda: merge_ops.merge_topics(
                st, w, eta, eta), 20, read_flush=True)
            ms_b1_read = time_ms(lambda: merge_ops.merge_topics_batch(
                st[None], w[None], eta, eta), 20, read_flush=True)
            b_ms, b_by = merge_ops.cost(n, k, v).bound_ms()
            log(f"[kernels] merge_topics n=8: {ms:.4f} ms "
                f"({4 * (n + 1) * k * v / (ms * 1e-3) / 1e12:.2f} TB/s), "
                f"addmv {lib:.4f} ms, parts form with unit weights by value "
                f"{ms_parts:.4f} ms, the batched kernel at b = 1 "
                f"{ms_b1:.4f} ms; after a reading flush {ms_read:.4f} ms "
                f"({4 * (n + 1) * k * v / (ms_read * 1e-3) / 1e12:.2f} "
                f"TB/s), b = 1 {ms_b1_read:.4f} ms; bound {b_ms:.4f} ms "
                f"({b_by})")
    gen_m = torch.Generator(device=dev).manual_seed(0)
    for n in (1, 8, 129):
        k, v = 100, 8192
        parts = [torch.rand((k, v), generator=gen_m, device=dev) * 2.0
                 for _ in range(n)]
        w_host = [float(x) for x in rng.uniform(0.2, 2.0, n)]
        got = merge_ops.merge_topics_parts(parts, w_host, 0.01, 0.01)
        want = merge_topics_ref(torch.stack(parts),
                                torch.tensor(w_host, device=dev), 0.01, 0.01)
        errs.append(close(got, want, MERGE_TOL))
        for _ in range(5):
            if not torch.equal(merge_ops.merge_topics_parts(
                    parts, w_host, 0.01, 0.01), got):
                raise AssertionError("merge_topics_parts gives other bits "
                                     "on a repeat call")
        log(f"[kernels] merge_topics_parts n={n} K={k} V={v} (weights by "
            f"value{', pointer table on the device' if n > merge_ops.MAX_PARAM_PARTS else ''}): "
            f"max abs err {errs[-1]:.3g} (tol {MERGE_TOL}); same bits over 5 "
            f"calls")
        del parts, want
    report["merge_topics"] = dict(
        name="merge_topics", route="cuda",
        source="src/repro_torch/kernels/csrc/merge_topics.cu",
        replaces="src/repro/kernels/merge_topics/merge_topics.py:37",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib, ms_parts_unit_weights=ms_parts,
        ms_batched_b1=ms_b1, ms_after_reading_flush=ms_read,
        ms_batched_b1_after_reading_flush=ms_b1_read)

    # merge_topics_ragged: the batch merge of the main path, by pointer
    # table (merge_topics_parts_segments: R separate (K, V) parts, one
    # result a segment), at the main path's width and at PubMed's
    # vocabulary with a segment above 128 parts; held at 1e-5, equal bit
    # for bit to the stacked kernel (its parity reference) and over
    # repeat calls, and timed at V = 141,043
    errs = []
    gen_r = torch.Generator(device=dev).manual_seed(1)
    for counts, k, v in [([1, 3, 8, 2], 100, 8192),
                         ([1, 32, 7, 129], 100, 141_043)]:
        r = sum(counts)
        parts = [torch.rand((k, v), generator=gen_r, device=dev) * 2.0
                 for _ in range(r)]
        w_host = rng.uniform(0.2, 2.0, r).astype(np.float32)
        w = torch.tensor(w_host, device=dev)
        eta = 0.01
        got = merge_ops.merge_topics_parts_segments(parts, counts, w_host,
                                                    eta, eta)
        st = torch.stack(parts)
        errs.append(close(got, merge_topics_segments_ref(st, w, counts, eta,
                                                         eta), MERGE_TOL))
        if not torch.equal(merge_ops.merge_topics_segments(
                st, w, counts, eta, eta), got):
            raise AssertionError("merge_topics_parts_segments gives other "
                                 "bits than the stacked ragged kernel")
        for _ in range(5):
            if not torch.equal(merge_ops.merge_topics_parts_segments(
                    parts, counts, w_host, eta, eta), got):
                raise AssertionError("merge_topics_parts_segments gives "
                                     "other bits on a repeat call")
        log(f"[kernels] merge_topics_parts_segments counts={counts} K={k} "
            f"V={v}: max abs err {errs[-1]:.3g} (tol {MERGE_TOL}); the "
            f"stacked kernel's bits; same bits over 5 calls")
        if v == 141_043:
            seg = np.repeat(np.arange(len(counts)), counts)
            a_np = np.zeros((len(counts), r), np.float32)
            a_np[seg, np.arange(r)] = w_host
            a_mat = torch.tensor(a_np, device=dev)
            c = (eta - eta * a_mat.sum(1, keepdim=True)).contiguous()
            s2 = st.view(r, -1)
            table = merge_ops.parts_table(parts, counts, w_host)
            ms = time_ms(lambda: merge_ops.merge_topics_parts_segments(
                parts, counts, bias=eta, base=eta, table=table), 20)
            ms_stacked = time_ms(lambda: merge_ops.merge_topics_segments(
                st, w, counts, eta, eta), 20)
            plain = time_ms(lambda: merge_topics_segments_ref(
                st, w, counts, eta, eta), 20)
            lib = time_ms(lambda: torch.addmm(c, a_mat, s2), 20)
            b_ms, b_by = merge_ops.segments_cost(counts, k, v).bound_ms()
            log(f"[kernels] merge_topics_parts_segments counts={counts} "
                f"V={v}: {ms:.4f} ms by pointer table, {ms_stacked:.4f} ms "
                f"over a stack, bound {b_ms:.4f} ms ({b_by})")
            del a_mat, c, s2, table
        del parts, st, got
    torch.cuda.empty_cache()
    report["merge_topics_ragged"] = dict(
        name="merge_topics_ragged", route="cuda",
        source="src/repro_torch/kernels/csrc/merge_topics.cu",
        replaces="src/repro/kernels/merge_topics/merge_topics.py:112",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib, ms_stacked=ms_stacked)

    # vb_estep: the CSR kernel on doc_term_csr(x) of real doc-term blocks
    # at the main path's widths, held against the dense plain version;
    # then the edge shape, and shapes whose documents overflow the row
    # budget of a CTA (their rows stream in chunks every iteration)
    errs = []
    t_estep_s = None
    estep = {}

    def estep_case(x, eeb, iters, label):
        d, k = x.shape[0], eeb.shape[0]
        g0 = torch.ones((d, k), dtype=torch.float32, device=dev)
        csr = estep_ops.doc_term_csr(x)
        g1, s1 = estep_ops.vb_estep_csr(csr, eeb, g0, 0.5, iters)
        g2, s2 = vb_estep_ref(x, eeb, g0, 0.5, iters)
        errs.append(max(close(g1, g2, ESTEP_TOL), close(s1, s2, ESTEP_TOL)))
        rows, _ = estep_ops.estep_plan(k, csr.max_row)
        log(f"[kernels] vb_estep {label} D={d} K={k} V={x.shape[1]} "
            f"n_iters={iters}: max abs err {errs[-1]:.3g} (tol {ESTEP_TOL}); "
            f"nnz {csr.nnz}, longest document {csr.max_row} nonzeros, "
            f"row budget {rows}"
            + (" (longer documents stream in chunks)"
               if rows < csr.max_row else ""))
        return csr, g0, g1, s1, rows

    def corpus_block(d, k, v, mean_len, seed):
        corpus_d, beta_true = make_corpus(d, v, k, mean_doc_len=mean_len,
                                          seed=seed)
        x = torch.tensor(doc_term_matrix(corpus_d), device=dev)
        eeb = torch.tensor(beta_true + 1e-4, dtype=torch.float32, device=dev)
        return x, (eeb / eeb.sum(1, keepdim=True)).contiguous()

    for d, k, v, iters in [(2048, 100, 8192, 20), (1000, 100, 8192, 20),
                           (135, 6, 150, 20)]:
        x, eeb = corpus_block(d, k, v, 60, 1)
        csr, g0, g1, s1, _ = estep_case(x, eeb, iters, "corpus")
        if d == 2048:
            for _ in range(5):
                g3, s3 = estep_ops.vb_estep_csr(csr, eeb, g0, 0.5, iters)
                if not (torch.equal(g3, g1) and torch.equal(s3, s1)):
                    raise AssertionError("vb_estep gives other bits on a "
                                         "repeat call")
            log("[kernels] vb_estep D=2048: same bits over 5 calls")
        if k != 100:
            continue
        nnz = csr.nnz
        ms = time_ms(lambda: estep_ops.vb_estep_csr(csr, eeb, g0, 0.5,
                                                    iters), 10)
        conv = time_ms(lambda: estep_ops.doc_term_csr(x), 5)
        plain = time_ms(lambda: vb_estep_csr_ref(csr, eeb, g0, 0.5, iters),
                        3)
        dense_plain = time_ms(lambda: vb_estep_ref(x, eeb, g0, 0.5, iters),
                              3)
        # bytes: the CSR (indptr, indices, values, rows, col_ptr, perm),
        # eeb and gamma0 read once; gamma and sstats written once.
        # operations this x needs: phinorm and the gamma product at the
        # nonzeros (4·K flops each, plus the division), the digamma/exp
        # update of every gamma entry (~62 ops), the final multiply by eeb
        c = estep_ops.cost(d, k, v, nnz, iters)
        n_ops = c.ops[0][0]
        b_ms, b_by = c.bound_ms()
        estep[d] = dict(ms=ms, plain_ms=plain, dense_plain_ms=dense_plain,
                        conversion_ms=conv, nnz=nnz, bound_ms=b_ms,
                        bound_by=b_by)
        log(f"[kernels] vb_estep D={d}: {ms:.4f} ms, "
            f"{n_ops / (ms * 1e-3) / 1e12:.3f} TFLOP/s at the nonzeros "
            f"({nnz} of {d * v}, {100.0 * nnz / (d * v):.2f}%); bound "
            f"{b_ms:.4f} ms ({b_by}); conversion (doc_term_csr, once per "
            f"fit) {conv:.4f} ms; plain CSR {plain:.3f} ms, plain dense "
            f"{dense_plain:.3f} ms")
    t_estep_s = estep[2048]["ms"] * 1e-3
    # documents longer than the row budget: K = 256 at 40% nonzeros, and
    # a corpus of ~1,000-token documents at the main path's widths
    x = torch.tensor(rng.poisson(0.5, (17, 300)), dtype=torch.float32,
                     device=dev)
    eeb = torch.tensor(rng.gamma(1.0, 1.0, (256, 300)), dtype=torch.float32,
                       device=dev)
    eeb = (eeb / eeb.sum(1, keepdim=True)).contiguous()
    csr, *_, rows = estep_case(x, eeb, 8, "poisson")
    overflow = [rows < csr.max_row]
    x, eeb = corpus_block(64, 100, 8192, 1000, 4)
    csr, *_, rows = estep_case(x, eeb, 20, "long documents")
    overflow.append(rows < csr.max_row)
    if not all(overflow):
        raise AssertionError("an overflow shape fit the row budget: the "
                             "chunked path was not run")
    report["vb_estep"] = dict(
        name="vb_estep", route="cuda",
        source="src/repro_torch/kernels/csrc/vb_estep.cu",
        replaces="src/repro/kernels/vb_estep/vb_estep.py:76",
        max_abs_err=max(errs), library_ms=None,
        **{key: estep[2048][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "dense_plain_ms",
            "conversion_ms", "nnz")},
        at_d1000={key: estep[1000][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "conversion_ms",
            "nnz")})
    del x, eeb, csr
    # merge_topics_batch (b merges of n rows in one launch)
    errs = []
    for b, n, k, v in [(4, 8, 100, 8192), (3, 2, 6, 150)]:
        st = torch.tensor(rng.gamma(1.0, 1.0, (b, n, k, v)),
                          dtype=torch.float32, device=dev)
        w = torch.tensor(rng.uniform(0.2, 2.0, (b, n)), dtype=torch.float32,
                         device=dev)
        for bias in (0.0, 0.01):               # the gs and the vb merge
            got = merge_ops.merge_topics_batch(st, w, bias, bias)
            errs.append(close(got, merge_topics_batched_ref(st, w, bias, bias),
                              MERGE_TOL))
        log(f"[kernels] merge_topics_batch b={b} n={n} K={k} V={v}: max abs "
            f"err {max(errs[-2:]):.3g} (tol {MERGE_TOL})")
        if (b, n) == (4, 8):
            # bias = base = 0 (the gs merge): one einsum is the same function
            ms = time_ms(lambda: merge_ops.merge_topics_batch(st, w), 20)
            plain = time_ms(lambda: merge_topics_batched_ref(st, w), 20)
            lib = time_ms(lambda: torch.einsum("bn,bnkv->bkv", w, st), 20)
            b_ms, b_by = merge_ops.batch_cost(b, n, k, v).bound_ms()
    report["merge_topics_batch"] = dict(
        name="merge_topics_batch", route="cuda",
        source="src/repro_torch/kernels/csrc/merge_topics.cu",
        replaces="src/repro/kernels/merge_topics/merge_topics.py:66",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib)

    # gibbs_sweep: one blocked sweep of a 1,000-document window at the
    # main path's widths (one warp a document: the longest document is the
    # chain), the same window with each block's slots shuffled (documents
    # interleaved), then an edge shape (K = 6, a ragged last block)
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = []
    t_sweep_s = None

    def same_bits_5(fn, args, what):
        first = fn(*args)
        for _ in range(4):
            if not all(torch.equal(a, b) for a, b in zip(fn(*args), first)):
                raise AssertionError(f"{what}: 5 calls gave different bits")

    for label, n_docs, k, v, mean_len, bd in [
            ("main", 1000, 100, 8192, 60, 64),
            ("interleaved", 1000, 100, 8192, 60, 64),
            ("edge", 90, 6, 150, 12, 16)]:
        win, _ = make_corpus(n_docs, v, k, mean_doc_len=mean_len, seed=2)
        words, ldoc, mask = (torch.tensor(a, device=dev) for a in
                             blocked_layout(win.tokens, win.doc_ids,
                                            win.n_docs, bd))
        nb, t = words.shape
        if label == "interleaved":
            # shuffle each block's real slots: a document's tokens scatter
            # over its block (the kernel takes any ldoc order)
            for i in range(nb):
                n_real = int(mask[i].sum())
                perm = torch.randperm(n_real, generator=gen, device=dev)
                words[i, :n_real] = words[i, :n_real][perm]
                ldoc[i, :n_real] = ldoc[i, :n_real][perm]
        z = torch.randint(0, k, (nb, t), generator=gen, device=dev,
                          dtype=torch.int32)
        u = torch.rand((nb, t), generator=gen, device=dev)
        nkd = torch.zeros((nb, bd, k), device=dev)
        blk = torch.arange(nb, device=dev)[:, None].expand(nb, t)
        nkd.index_put_((blk.reshape(-1), ldoc.reshape(-1).long(),
                        z.reshape(-1).long()), mask.reshape(-1),
                       accumulate=True)
        nkv = torch.zeros((k, v), device=dev)
        nkv.index_put_((z.reshape(-1).long(), words.reshape(-1).long()),
                       mask.reshape(-1), accumulate=True)
        glob = torch.tensor(rng.integers(0, 4, (k, v)), dtype=torch.float32,
                            device=dev)             # a store's summed counts
        prior = nkv + glob + cfg0.eta
        prior_k = nkv.sum(1) + glob.sum(1) + v * cfg0.eta
        idx = gibbs_ops.doc_index(ldoc, mask, bd)   # once per fit
        args = (words, ldoc, mask, u, z, nkd, prior, prior_k, cfg0.alpha,
                idx)
        z1, nkd1, nkv1 = gibbs_ops.gibbs_sweep(*args)
        z2, nkd2, nkv2 = gibbs_sweep_ref(*args[:-1])
        torch.cuda.synchronize()
        bad = int((z1 != z2).sum())
        real = int(mask.sum())
        doc_len = torch.zeros((nb, bd), device=dev)
        doc_len.index_put_((blk.reshape(-1), ldoc.reshape(-1).long()),
                           mask.reshape(-1), accumulate=True)
        if float(nkv1.sum()) != real or not torch.equal(nkd1.sum(2),
                                                        doc_len):
            raise AssertionError("gibbs_sweep lost or invented tokens")
        if bad or not (torch.equal(nkd1, nkd2) and torch.equal(nkv1, nkv2)):
            raise AssertionError(f"gibbs_sweep ({label}): {bad} of {real} "
                                 f"draws differ from the plain version")
        same_bits_5(gibbs_ops.gibbs_sweep, args, f"gibbs_sweep ({label})")
        errs.append(float((nkv1 - nkv2).abs().max()))
        chain = int((idx[0][1:] - idx[0][:-1]).max())
        log(f"[kernels] gibbs_sweep {label} docs={n_docs} K={k} V={v} "
            f"BD={bd} blocks={nb} T_max={t} longest chain={chain} tokens: "
            f"{bad} of {real} draws differ from the plain version (tol 0), "
            f"counts conserved, 5 calls the same bits")
        if label == "main":
            ms = time_ms(lambda: gibbs_ops.gibbs_sweep(*args), 20)
            per_call = time_ms(lambda: gibbs_ops.gibbs_sweep(*args[:-1]), 5)
            idx_ms = time_ms(lambda: gibbs_ops.doc_index(ldoc, mask, bd), 5)
            plain = time_ms(lambda: gibbs_sweep_ref(*args[:-1]), 1)
            t_sweep_s = ms * 1e-3
            log(f"[kernels] gibbs_sweep: {ms:.4f} ms a sweep with the fit's "
                f"index, {ms * 1e6 / chain:.0f} ns per chain step "
                f"({chain} steps); {per_call:.4f} ms building the index "
                f"per call (doc_index alone {idx_ms:.4f} ms)")
            # bytes: the (B, T) inputs, n_kd in and out, the snapshot,
            # z out and n_kv out once; operations: ~8 per topic per token
            b_ms, b_by = gibbs_ops.cost(nb, t, bd, k, v, real).bound_ms()
            fit_win = win
    report["gibbs_sweep"] = dict(
        name="gibbs_sweep", route="cuda",
        source="src/repro_torch/kernels/csrc/gibbs_sweep.cu",
        replaces="src/repro/kernels/gibbs_sweep/gibbs_sweep.py:88",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)

    # cgs_sweep_exact: one sweep of the exact scan over a 1,000-document
    # gap at the main path's widths (~58,000 tokens, the shape of the gs
    # path's host gaps), a stream of repeated words whose documents come
    # back (unsorted), and the edge shape
    errs = []
    t_token_s = None
    for label, n_docs, k, v, mean_len in [
            ("main", 1000, 100, 8192, 60),
            ("repeated words, revisited docs", 60, 100, 8192, 50),
            ("edge", 40, 6, 150, 12)]:
        part, _ = make_corpus(n_docs, v, k, mean_doc_len=mean_len, seed=3)
        toks = torch.tensor(part.tokens, device=dev)
        docs = torch.tensor(part.doc_ids, device=dev)
        if label.startswith("repeated"):
            # runs of one word, and the stream cut in blocks of 7 tokens
            # taken in a shuffled order, so documents recur out of order
            toks = toks[torch.arange(toks.shape[0], device=dev) // 3 * 3]
            order = torch.randperm((toks.shape[0] + 6) // 7, generator=gen,
                                   device=dev)
            pos = (order[:, None] * 7 + torch.arange(7, device=dev)).reshape(-1)
            pos = pos[pos < toks.shape[0]]
            toks, docs = toks[pos].contiguous(), docs[pos].contiguous()
            if not bool((docs[1:] < docs[:-1]).any()):
                raise AssertionError("the revisiting stream is sorted")
        t = toks.shape[0]
        z = torch.randint(0, k, (t,), generator=gen, device=dev,
                          dtype=torch.int32)
        u = torch.rand((t,), generator=gen, device=dev)
        ones = torch.ones(t, device=dev)
        nkd = torch.zeros((part.n_docs, k), device=dev)
        nkd.index_put_((docs.long(), z.long()), ones, accumulate=True)
        nkv = torch.zeros((k, v), device=dev)
        nkv.index_put_((z.long(), toks.long()), ones, accumulate=True)
        glob = torch.tensor(rng.integers(0, 4, (k, v)), dtype=torch.float32,
                            device=dev)
        args = (toks, docs, u, z, nkd, nkv, nkv.sum(1), glob, glob.sum(1),
                cfg0.alpha, cfg0.eta)
        # the fit's entry point: n_kv and the prior in (V, K)
        args_t = (toks, docs, u, z, nkd, nkv.t().contiguous(), nkv.sum(1),
                  glob.t().contiguous(), glob.sum(1), cfg0.alpha, cfg0.eta)
        z1, nkd1, nkv1, nk1 = gibbs_ops.cgs_sweep_exact(*args)
        # the plain version at this size is ~30 small launches a token,
        # tens of seconds: its one comparison call is also its timing
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        ev[0].record()
        z2, nkd2, nkv2, nk2 = cgs_sweep_exact_ref(*args)
        ev[1].record()
        torch.cuda.synchronize()
        bad = int((z1 != z2).sum())
        if float(nkv1.sum()) != t or not torch.equal(nkd1.sum(1), nkd.sum(1)) \
                or not torch.equal(nk1, nkv1.sum(1)):
            raise AssertionError("cgs_sweep_exact lost or invented tokens")
        if bad or not (torch.equal(nkd1, nkd2) and torch.equal(nkv1, nkv2)
                       and torch.equal(nk1, nk2)):
            raise AssertionError(f"cgs_sweep_exact ({label}): {bad} of {t} "
                                 f"draws differ from the plain version")
        zt, nkdt, nkvt, nkt = gibbs_ops.cgs_sweep_exact_t(*args_t)
        if not (torch.equal(zt, z1) and torch.equal(nkdt, nkd1)
                and torch.equal(nkvt.t(), nkv1) and torch.equal(nkt, nk1)):
            raise AssertionError("cgs_sweep_exact_t disagrees with "
                                 "cgs_sweep_exact")
        same_bits_5(gibbs_ops.cgs_sweep_exact_t, args_t,
                    f"cgs_sweep_exact ({label})")
        errs.append(float((nkv1 - nkv2).abs().max()))
        log(f"[kernels] cgs_sweep_exact {label} docs={n_docs} K={k} V={v} "
            f"T={t} (the chain): {bad} of {t} draws differ from the plain "
            f"version (tol 0), counts conserved, 5 calls the same bits")
        if label == "main":
            ms = time_ms(lambda: gibbs_ops.cgs_sweep_exact_t(*args_t), 5)
            public = time_ms(lambda: gibbs_ops.cgs_sweep_exact(*args), 3)
            plain = ev[0].elapsed_time(ev[1])
            t_token_s = ms * 1e-3 / t
            log(f"[kernels] cgs_sweep_exact: {ms:.3f} ms a sweep in the "
                f"fit's (V, K) layout, {ms * 1e6 / t:.0f} ns per chain step "
                f"({t} steps); {public:.3f} ms through the (K, V) entry "
                f"point (two transposes)")
            b_ms, b_by = gibbs_ops.exact_cost(t, part.n_docs, k,
                                              v).bound_ms()
            fit_part = part
    report["cgs_sweep_exact"] = dict(
        name="cgs_sweep_exact", route="cuda",
        source="src/repro_torch/kernels/csrc/gibbs_sweep.cu",
        replaces="src/repro/core/gibbs.py:34",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)

    # whole fits of a 1,000-document window, wall (host clock after a
    # synchronise) beside the sum of their kernel times: the host's share
    fcfg = LDAConfig()
    fgen = torch.Generator(device=dev).manual_seed(1)
    for fit, fdata, per_sweep in (
            (cgs_fit_blocked, fit_win, report["gibbs_sweep"]["ms"]),
            (cgs_fit, fit_part, report["cgs_sweep_exact"]["ms"])):
        fit(fdata.tokens, fdata.doc_ids, fcfg, fgen, sweeps=2)   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fit(fdata.tokens, fdata.doc_ids, fcfg, fgen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if float(out.sum()) != fdata.n_tokens:
            raise AssertionError(f"{fit.__name__} lost or invented tokens")
        kern = fcfg.gibbs_sweeps * per_sweep
        log(f"[kernels] {fit.__name__} of a 1,000-document window "
            f"({fdata.n_tokens} tokens, {fcfg.gibbs_sweeps} sweeps): "
            f"{wall:.2f} ms wall, {kern:.2f} ms of sweep kernels "
            f"({fcfg.gibbs_sweeps} x {per_sweep:.4f}), host share "
            f"{(wall - kern) / wall:.1%}")

    # flash_attention and decode_attention run on the tensor cores in bf16
    # (mma.sync): the SASS of every bf16 instance must hold HMMA or HGMMA
    tc_sass = tensor_core_instructions(common.library_path())
    for kname, ops in (("flash_fwd_bf16", flash_ops),
                       ("decode_partial_bf16", decode_ops)):
        found = {fn: n for fn, n in tc_sass.items() if kname in fn}
        if len(found) != len(ops.HEAD_DIMS) or min(found.values()) == 0:
            raise AssertionError(f"{kname}: tensor-core instructions per "
                                 f"instance {found}")
        log(f"[kernels] {kname}: {len(found)} instances, HMMA/HGMMA per "
            f"instance {sorted(found.values())}")
    sass_hmma = {k: sum(n for fn, n in tc_sass.items() if k in fn)
                 for k in ("flash_fwd_bf16", "decode_partial_bf16")}

    # flash_attention: the serve path's prefill shape (qwen3-1.7b heads,
    # causal) on both instances, bf16 (tensor cores, the served dtype) and
    # f32 (CUDA cores), each timed, then an edge (ragged S, window, f32).
    # Both instances are held to the plain version run in float32 on the
    # same inputs, at (atol, rtol): the JAX kernel tests' 1e-5 in f32; in
    # bf16 a limit with headroom over what rounding p and the output to
    # bf16 costs, tight enough that a KV tile or split skipped for the
    # late rows, whose outputs are ~0.05, fails it
    # (tests/test_torch_attention.py); "atol used" is the atol this run's
    # result needs at that rtol, the headroom's reading.
    import torch.nn.functional as F
    attn_tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (5e-3, 1e-2)}

    def attn_close(got, want, dt):
        atol, rtol = attn_tol[dt]
        err = close(got.float(), want, atol, rtol)
        used = float(((got.float() - want).abs() - rtol * want.abs()).max())
        return err, f"max abs err {err:.3g}, atol used {used:.3g} of {atol} " \
                    f"at rtol {rtol}"

    dt_name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    errs = []
    inst = {}
    for b, s, h, kvh, hd, window, dt in [
            (SERVE_B, SERVE_PROMPT, 16, 8, 128, 0, torch.bfloat16),
            (SERVE_B, SERVE_PROMPT, 16, 8, 128, 0, torch.float32),
            (1, 200, 4, 2, 128, 50, torch.float32)]:
        q, k, v = (torch.tensor(rng.normal(size=(b, s, n, hd)),
                                dtype=torch.float32, device=dev).to(dt)
                   for n in (h, kvh, kvh))
        got = flash_ops.flash_attention(q, k, v, causal=True, window=window)
        want = flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=True, window=window)
        err, msg = attn_close(got, want, dt)
        errs.append(err)
        log(f"[kernels] flash_attention B={b} S={s} H={h} KVH={kvh} hd={hd} "
            f"window={window} {dt}: {msg}")
        del want
        if s == SERVE_PROMPT:
            if dt == torch.bfloat16:
                for _ in range(5):
                    if not torch.equal(flash_ops.flash_attention(q, k, v),
                                       got):
                        raise AssertionError("bf16 flash_attention gives "
                                             "other bits on a repeat call")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            ms = time_ms(lambda: flash_ops.flash_attention(q, k, v), 10)
            plain = time_ms(lambda: flash_attention_ref(q, k, v), 3)
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 10)
            # flash_ops.cost: q, k, v read once, out written once; the
            # causal pairs this call has, 4·hd flops each (QK and PV),
            # at the bf16 tensor-core peak (bf16) or the fp32 peak (f32:
            # TF32 would not keep the tolerance)
            c = flash_ops.cost(b, s, h, kvh, hd, dt)
            n_bytes, n_ops = c.n_bytes, c.flops
            b_ms, b_by = c.bound_ms()
            inst[dt] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib)
            log(f"[kernels] flash_attention {dt}: {ms:.4f} ms, "
                f"{n_ops / 1e9:.2f} GFLOP, "
                f"{n_ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
                f"{n_bytes / (ms * 1e-3) / 1e12:.3f} TB/s; bound {b_ms:.4f} "
                f"ms ({b_by}); plain {plain:.3f} ms; SDPA {lib:.4f} ms"
                + ("; same bits over 5 calls" if dt == torch.bfloat16
                   else ""))
    report["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:85",
        max_abs_err=max(errs), **inst[torch.bfloat16],
        instances={dt_name[d]: v for d, v in inst.items()},
        sass_hmma=sass_hmma["flash_fwd_bf16"])

    # decode_attention: the serve path's decode shape at pos 2,100 of a
    # 2,112-position cache in bf16 (tensor cores) and again in f32 (CUDA
    # cores; 11 splits, so f32 at 1e-5 holds the split-K combine), each
    # timed, then one sequence (B = 1) at qwen3's heads and at gemma-2b's
    # MQA (the split plan adapts to B·KVH: each also timed with the plan of
    # the served B·KVH = 32), then windows (f32): at pos 0 (one live key)
    # and at pos 300 (64 keys across two splits)
    errs = []
    inst = {}
    single = {}
    for b, s, h, kvh, hd, pos, window, dt in [
            (SERVE_B, SERVE_CACHE, 16, 8, 128, 2100, 0, torch.bfloat16),
            (SERVE_B, SERVE_CACHE, 16, 8, 128, 2100, 0, torch.float32),
            (1, SERVE_CACHE, 16, 8, 128, 2100, 0, torch.bfloat16),
            (1, SERVE_CACHE, 8, 1, 256, 2100, 0, torch.bfloat16),
            (1, 512, 4, 2, 128, 0, 64, torch.float32),
            (1, 512, 4, 2, 128, 300, 64, torch.float32)]:
        q = torch.tensor(rng.normal(size=(b, 1, h, hd)), dtype=torch.float32,
                         device=dev).to(dt)
        kc, vc = (torch.tensor(rng.normal(size=(b, s, kvh, hd)),
                               dtype=torch.float32, device=dev).to(dt)
                  for _ in range(2))
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        got = decode_ops.decode_attention(q, kc, vc, p, window=window)
        want = decode_attention_ref(q.float(), kc.float(), vc.float(), pos,
                                    window=window)
        err, msg = attn_close(got, want, dt)
        errs.append(err)
        n_split, chunk = decode_ops.split_plan(s, b * kvh)
        log(f"[kernels] decode_attention B={b} S={s} H={h} KVH={kvh} "
            f"hd={hd} pos={pos} window={window} {dt} ({n_split} splits of "
            f"{chunk}): {msg}")
        if pos != 2100:
            continue
        if dt == torch.bfloat16:
            for _ in range(5):
                if not torch.equal(decode_ops.decode_attention(q, kc, vc, p),
                                   got):
                    raise AssertionError("bf16 decode_attention gives other "
                                         "bits on a repeat call")
        qt = q.transpose(1, 2)
        kt, vt = (x[:, :pos + 1].transpose(1, 2) for x in (kc, vc))
        ms = time_ms(lambda: decode_ops.decode_attention(q, kc, vc, p), 20)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True), 20)
        # decode_ops.cost: the pos + 1 live cache rows of k and v, q,
        # out; 4·hd flops per (head, live key)
        c = decode_ops.cost(b, s, h, kvh, hd, dt, pos)
        n_bytes, n_ops = c.n_bytes, c.flops
        b_ms, b_by = c.bound_ms()
        rate = (f"{n_bytes / 1e6:.1f} MB, "
                f"{n_bytes / (ms * 1e-3) / 1e12:.3f} TB/s, "
                f"{n_ops / (ms * 1e-3) / 1e12:.3f} TFLOP/s; bound {b_ms:.4f} "
                f"ms ({b_by}); SDPA {lib:.4f} ms")
        if b == 1:
            plan = decode_ops.split_plan
            decode_ops.split_plan = lambda s_, _: plan(s_, SERVE_B * 8)
            try:
                served_plan = time_ms(
                    lambda: decode_ops.decode_attention(q, kc, vc, p), 20)
            finally:
                decode_ops.split_plan = plan
            single[f"B=1 H={h} KVH={kvh} hd={hd}"] = dict(
                ms=ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                ms_served_plan=served_plan)
            log(f"[kernels] decode_attention B=1 H={h} KVH={kvh} hd={hd} "
                f"{dt}: {ms:.4f} ms, {rate}; with the served B·KVH's plan "
                f"({'%d splits of %d' % plan(s, SERVE_B * 8)}) "
                f"{served_plan:.4f} ms")
            continue
        plain = time_ms(lambda: decode_attention_ref(q, kc, vc, pos), 20)
        inst[dt] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                        library_ms=lib)
        log(f"[kernels] decode_attention {dt}: {ms:.4f} ms, {rate}; plain "
            f"{plain:.4f} ms"
            + ("; same bits over 5 calls" if dt == torch.bfloat16 else ""))
    report["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/decode_attention.py:71",
        max_abs_err=max(errs), **inst[torch.bfloat16],
        instances={dt_name[d]: v for d, v in inst.items()},
        single_sequence=single, sass_hmma=sass_hmma["decode_partial_bf16"])

    # slstm_scan: the JAX kernel tests' shapes (f32 R: the cooperative
    # route, 1e-5), an odd shape in f32 and bf16 R and decode steps (S = 1,
    # the step route, with the served bf16 xpre and R among them, and
    # phase 13's grid step on one head, a "model" rank's block, in bf16
    # and f32) from a nonzero state (1e-5), the cluster route's batch chunks and groups
    # (B = 9) and 16 heads in waves, then the served shape (xlstm-1.3b:
    # B = 4, S = 2,048, H = 4,
    # hd = 512) with the model's bf16 R (cluster route) and with an f32 R
    # (cooperative route) (1e-4: 2,048 dependent steps), and in the
    # model's own dtypes (bf16 xpre and R; h comes back in bf16 and is
    # held to one bf16 rounding, 2^-7, the final state to 1e-4)
    def slstm_inputs(b, s, h, hd, x_dt, r_dt, nonzero):
        xpre = (torch.tensor(rng.normal(size=(b, s, 4, h, hd)),
                             dtype=torch.float32, device=dev) * 0.5).to(x_dt)
        r = (torch.tensor(rng.normal(size=(h, hd, 4 * hd)),
                          dtype=torch.float32, device=dev)
             * hd ** -0.5).to(r_dt)
        if not nonzero:
            return xpre, r, zero_state(b, h, hd, dev)
        st = [torch.tensor(a, dtype=torch.float32, device=dev) for a in (
            rng.normal(size=(b, h, hd)), rng.uniform(0.5, 2.0, (b, h, hd)),
            rng.normal(size=(b, h, hd)) * 0.5, rng.normal(size=(b, h, hd)))]
        return xpre, r, tuple(st)

    def slstm_plan(b, s, h, hd, r_dt):
        p = slstm_ops.scan_plan(b, s, h, hd, r_dt)
        return (f"{p.route} route, {p.ctas} CTAs a head of {p.units} units"
                + (f", {p.rows} rows a cluster x {p.groups}, {p.smem} B of "
                   f"shared memory" if p.route == "cluster" else ""))

    f32, bf16 = torch.float32, torch.bfloat16
    errs = []
    for b, s, h, hd, x_dt, r_dt, nonzero, tol in [
            (2, 32, 2, 16, f32, f32, False, 1e-5),
            (4, 64, 4, 32, f32, f32, False, 1e-5),
            (1, 48, 3, 8, f32, f32, False, 1e-5),
            (1, 33, 3, 8, f32, f32, True, 1e-5),
            (1, 33, 3, 8, f32, bf16, True, 1e-5),
            (XL_B, 1, XL_H, XL_HD, f32, bf16, True, 1e-5),
            (XL_B, 1, XL_H, XL_HD, bf16, bf16, True, 1e-5),
            (8, 1, XL_H, XL_HD, f32, f32, True, 1e-5),
            # phase 13's grid step: each "model" rank's one head
            (GRID_B, 1, 1, XL_HD, bf16, bf16, True, 1e-5),
            (GRID_B, 1, 1, XL_HD, f32, f32, True, 1e-5),
            (9, 64, XL_H, XL_HD, f32, bf16, True, 1e-5),
            (1, 64, 16, XL_HD, f32, bf16, True, 1e-5),
            (XL_B, XL_S, XL_H, XL_HD, f32, bf16, False, 1e-4),
            (XL_B, XL_S, XL_H, XL_HD, f32, f32, False, 1e-4),
            (XL_B, XL_S, XL_H, XL_HD, bf16, bf16, False, 1e-4)]:
        xpre, r, st = slstm_inputs(b, s, h, hd, x_dt, r_dt, nonzero)
        got, got_st = slstm_ops.slstm_scan(xpre, r, *st)
        want, want_st = slstm_scan_ref(xpre, r, *st)
        h_tol = tol if x_dt == f32 else 2.0 ** -7
        err_h = close(got.float(), want.float(), h_tol)
        err_st = max(close(g, w, tol) for g, w in zip(got_st, want_st))
        errs.append(max(err_h, err_st))
        log(f"[kernels] slstm_scan B={b} S={s} H={h} hd={hd} xpre {x_dt} R "
            f"{r_dt}{' from a nonzero state' if nonzero else ''} "
            f"({slstm_plan(b, s, h, hd, r_dt)}): max abs err h {err_h:.3g} "
            f"(tol {h_tol:.3g}), final state {err_st:.3g} (tol {tol})")
        del want, want_st

    def slstm_bound(b, s, h, hd, x_dt, r_dt):
        # slstm_ops.cost: xpre and R read once, h_out written once, the
        # state read and written once; the h·R products (at a third of
        # the tensor-core peak with bf16 R, three exact bf16 pieces; at
        # the fp32 peak with f32 R) and ~20 f32 operations per unit
        return slstm_ops.cost(b, s, h, hd, x_dt, r_dt).bound_ms()

    # the timed calls, one a route: the served prefill call in the model's
    # dtypes (cluster), a decode step (step) and the prefill call with an
    # f32 R (cooperative); each bitwise repeatable over five calls
    inst = {}
    for route, s, x_dt, r_dt, nonzero, reps, plain_reps in [
            ("cluster", XL_S, bf16, bf16, False, 10, 1),
            ("step", 1, bf16, bf16, True, 20, 20),
            ("coop", XL_S, f32, f32, False, 5, 1)]:
        if slstm_ops.scan_plan(XL_B, s, XL_H, XL_HD, r_dt).route != route:
            raise AssertionError(f"slstm_scan: the {route} shape planned "
                                 f"{slstm_plan(XL_B, s, XL_H, XL_HD, r_dt)}")
        xpre, r, st = slstm_inputs(XL_B, s, XL_H, XL_HD, x_dt, r_dt, nonzero)
        first = slstm_ops.slstm_scan(xpre, r, *st)
        for _ in range(5):
            again = slstm_ops.slstm_scan(xpre, r, *st)
            if not (torch.equal(again[0], first[0]) and all(
                    torch.equal(a, g) for a, g in zip(again[1], first[1]))):
                raise AssertionError(f"slstm_scan {route} route: two calls "
                                     f"gave different bits")
        ms = time_ms(lambda: slstm_ops.slstm_scan(xpre, r, *st), reps)
        plain = time_ms(lambda: slstm_scan_ref(xpre, r, *st), plain_reps)
        b_ms, b_by = slstm_bound(XL_B, s, XL_H, XL_HD, xpre.dtype, r.dtype)
        inst[route] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                           bound_by=b_by, library_ms=None)
        log(f"[kernels] slstm_scan {route} route, B={XL_B} S={s} H={XL_H} "
            f"hd={XL_HD} xpre {x_dt} R {r_dt}: {ms:.4f} ms"
            + (f" = {ms / s * 1e3:.3f} us per dependent step" if s > 1
               else "")
            + f"; bound {b_ms:.4f} ms ({b_by}); plain {plain:.4f} ms; same "
            f"bits over 5 calls")
        del xpre, r, st, first, again
    # each route's step with almost no work, S = 2,048 (the step route:
    # one call): one CTA (B = 1, H = 1, hd = 16), one head of 16 CTAs
    # (cluster, hd = 512 bf16) or 32 CTAs (cooperative, hd = 512 f32) at
    # B = 1
    floors = {}
    for label, s, hd, r_dt in [("cluster, one CTA", XL_S, 16, bf16),
                               ("cluster, one head of 16 CTAs", XL_S,
                                XL_HD, bf16),
                               ("coop, one head of 32 CTAs", XL_S, XL_HD,
                                f32),
                               ("step, one CTA", 1, 16, bf16)]:
        xf, rf, stf = slstm_inputs(1, s, 1, hd, r_dt, r_dt, False)
        floors[label] = time_ms(
            lambda: slstm_ops.slstm_scan(xf, rf, *stf), 5 if s > 1 else 20)
        log(f"[kernels] slstm_scan latency floor ({label}, "
            f"{slstm_plan(1, s, 1, hd, r_dt)}): {floors[label]:.4f} ms"
            + (f" = {floors[label] / s * 1e3:.3f} us a step" if s > 1
               else " a call"))
        del xf, rf, stf
    occupancy = {f"{k[0]} P={k[1]} rows={k[3]} smem={k[4]}": n
                 for k, n in slstm_ops.cluster_occupancy.items()}
    log(f"[kernels] slstm_scan max active clusters "
        f"(cudaOccupancyMaxActiveClusters, queried once per configuration): "
        f"{occupancy}")
    report["slstm_scan"] = dict(
        name="slstm_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/slstm_scan.cu",
        replaces="src/repro/kernels/slstm_scan/slstm_scan.py:82",
        max_abs_err=max(errs), **inst["cluster"], instances=inst,
        floors_ms=floors, max_active_clusters=occupancy)

    for rep in report.values():
        log(f"[kernels] {rep['name']}: kernel {rep['ms']:.4f} ms, plain "
            f"{rep['plain_ms']:.4f} ms, library {rep['library_ms']} ms, "
            f"bound {rep['bound_ms']:.4f} ms ({rep['bound_by']}) on {card}")
    del flush
    torch.cuda.empty_cache()

    # -- 3. the main path ---------------------------------------------------
    cfg = LDAConfig()
    n_trains = N_WINDOWS + 2           # windows, plus two half-window gaps
    iters = min(cfg.max_iters,
                max(5, int(TRAIN_BUDGET_S / (n_trains * t_estep_s))))
    if iters < cfg.max_iters:
        log(f"[main] cut: max_iters {cfg.max_iters} -> {iters} (E-step "
            f"{t_estep_s * 1e3:.1f} ms at D=2048, {TRAIN_BUDGET_S:.0f} s "
            f"training budget)")
        cfg = dataclasses.replace(cfg, max_iters=iters)
    else:
        log(f"[main] no cut: max_iters stays {cfg.max_iters} (E-step "
            f"{t_estep_s * 1e3:.1f} ms at D=2048 fits the "
            f"{TRAIN_BUDGET_S:.0f} s training budget); widths and corpus "
            f"size are never cut")
    log(f"[main] LDAConfig K={cfg.n_topics} V={cfg.vocab_size} "
        f"max_iters={cfg.max_iters} e_step_iters={cfg.e_step_iters}")
    t0 = time.perf_counter()
    corpus, beta_true = make_corpus(32_000, cfg.vocab_size, cfg.n_topics,
                                    mean_doc_len=60, seed=0)
    log(f"[main] corpus: {corpus.n_docs} docs, {corpus.n_tokens} tokens in "
        f"{time.perf_counter() - t0:.1f} s (host)")

    session = MLegoSession(corpus, cfg, backend="device", device="cuda")
    merge_ops.merge_topics_launches = 0
    merge_ops.merge_topics_ragged_launches = 0
    estep_ops.launches = 0

    t0 = time.perf_counter()
    for i in range(N_WINDOWS):
        m = session.train_range(i * 1000.0, (i + 1) * 1000.0)
        if m is None or m.n_docs == 0:
            raise AssertionError(f"window {i} holds no documents")
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    resident = session.backend.cache.resident_bytes
    log(f"[main] train_range x{N_WINDOWS}: {t_train:.1f} s, "
        f"{len(session.store)} models, {resident / 1e6:.1f} MB resident")

    covered = QuerySpec(sigma=Interval(0.0, 8000.0))
    t0 = time.perf_counter()
    rep_cov = session.submit(covered)
    log(f"[main] submit covered [0, 8000): {len(rep_cov.model_ids)} parts, "
        f"{rep_cov.n_trained_tokens} trained tokens, "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, merge "
        f"{rep_cov.merge_device_ms:.2f} ms")
    t0 = time.perf_counter()
    rep_gap = session.submit(QuerySpec(sigma=Interval(8500.0, 12500.0)))
    log(f"[main] submit with gaps [8500, 12500): {rep_gap.n_merged} parts, "
        f"{rep_gap.n_trained_tokens} trained tokens, "
        f"{(time.perf_counter() - t0):.2f} s")
    specs = [QuerySpec(sigma=Interval(0.0, 4000.0)),
             QuerySpec(sigma=Interval(4000.0, 6000.0)),
             QuerySpec(sigma=Interval(16000.0, 24000.0)),
             QuerySpec(sigma=Interval(24000.0, 25000.0))]
    t0 = time.perf_counter()
    batch = session.submit_many(specs)
    log(f"[main] submit_many parts={[r.n_merged for r in batch]}: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, merge "
        f"{batch.merge_device_ms:.2f} ms, pad rows {batch.pad_rows}")
    torch.cuda.synchronize()
    launches = read_counts(("merge_topics", "merge_topics_ragged",
                            "vb_estep"))
    log(f"[main] kernel launches on the main path: {launches}")
    for kname, count in launches.items():
        if count <= 0:
            raise AssertionError(f"main path never launched {kname}")
        report[kname]["launches"] = count
        report[kname]["launches_by_path"] = {"vb": count}

    if rep_gap.n_trained_tokens <= 0:
        raise AssertionError("the gap query trained no tokens")
    if len([r for r in batch]) != len(specs) or \
            len({r.n_merged for r in batch}) < 3:
        raise AssertionError("submit_many did not merge ragged part counts")
    for r in [rep_cov, rep_gap, *batch]:
        if r.backend != "device" or r.fallback_from is not None:
            raise AssertionError(f"report answered by {r.backend} "
                                 f"(fallback from {r.fallback_from})")
        if r.beta.shape != (cfg.n_topics, cfg.vocab_size) \
                or not np.isfinite(r.beta).all():
            raise AssertionError("beta is not finite (K, V)")
        row_err = float(np.abs(r.beta.sum(1) - 1.0).max())
        if row_err > 1e-5:
            raise AssertionError(f"beta rows sum to 1 +- {row_err}")

    host = MLegoSession(corpus, cfg, store=session.store, backend="host",
                        device="cuda")
    rep_host = host.submit(covered)
    if rep_host.model_ids != rep_cov.model_ids:
        raise AssertionError("host and device planned different parts")
    diff = float(np.abs(rep_host.beta - rep_cov.beta).max())
    if not np.allclose(rep_cov.beta, rep_host.beta, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"device beta differs from host by {diff}")
    log(f"[main] covered beta: device vs host max abs diff {diff:.3g} "
        f"(tol 1e-5)")
    # the batch's answers, merged by pointer table, against the host's
    # merges of the same parts
    batch_diff = 0.0
    for r, r_host in zip(batch, host.submit_many(specs)):
        if r_host.model_ids != r.model_ids:
            raise AssertionError("host and device planned different parts "
                                 "for a submit_many spec")
        batch_diff = max(batch_diff, float(np.abs(r_host.beta - r.beta).max()))
        if not np.allclose(r.beta, r_host.beta, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"device submit_many beta differs from "
                                 f"host by {batch_diff}")
    log(f"[main] submit_many betas: device vs host max abs diff "
        f"{batch_diff:.3g} (tol 1e-5)")

    # in-sample fit of the covered answer against the generating topics
    x_in = doc_term_matrix(corpus, 0, 300).astype(np.float64)
    lpp = log_predictive_probability(rep_cov.beta, x_in, cfg.alpha)
    lpp_true = log_predictive_probability(beta_true, x_in, cfg.alpha)
    lpp_flat = log_predictive_probability(
        np.full_like(rep_cov.beta, 1.0 / cfg.vocab_size), x_in, cfg.alpha)
    log(f"[main] per-token log predictive (300 docs of [0, 8000)): merged "
        f"{lpp:.4f}, generating topics {lpp_true:.4f}, uniform "
        f"{lpp_flat:.4f}")
    if not lpp > lpp_flat:
        raise AssertionError("merged topics fit no better than uniform")

    # -- 4. the other gap routes on the card --------------------------------
    # the "host" backend's trainer, and a replay on it after the device
    # backend lost its device, must run the E-step kernel too
    from repro_torch.testing.faults import FaultRule, injected
    before = estep_ops.launches
    rep = host.submit(QuerySpec(sigma=Interval(20500.0, 21500.0)))
    host_launches = estep_ops.launches - before
    if rep.n_trained_tokens <= 0 or host_launches <= 0:
        raise AssertionError(f"host gap route launched the E-step kernel "
                             f"{host_launches} times")
    replay = MLegoSession(corpus, cfg, store=session.store, backend="device",
                          device="cuda")
    before = estep_ops.launches
    with injected(FaultRule("backend.train_gap.device", kind="device_lost",
                            max_failures=1)):
        rep2 = replay.submit(QuerySpec(sigma=Interval(28500.0, 29500.0)))
    replay_launches = estep_ops.launches - before
    if (rep2.backend, rep2.fallback_from) != ("host", "device") \
            or replay_launches <= 0:
        raise AssertionError(
            f"device-lost replay answered by {rep2.backend} (from "
            f"{rep2.fallback_from}) with {replay_launches} E-step launches")
    for r in (rep, rep2):
        if not np.isfinite(r.beta).all():
            raise AssertionError("beta of a host-trained gap is not finite")
    log(f"[routes] host gap query: {rep.n_trained_tokens} trained tokens, "
        f"{host_launches} E-step launches; device-lost replay on host: "
        f"{rep2.n_trained_tokens} trained tokens, {replay_launches} E-step "
        f"launches")

    # -- 5. the "gs" path ---------------------------------------------------
    # the same corpus and widths; collapsed Gibbs with the DSGS prior.
    # Gaps on "device" train with the blocked sweep, on "host" (and in a
    # replay after device loss) with the exact scan.
    gcfg = LDAConfig()
    n_gs = GS_WINDOWS
    # a window is gibbs_sweeps blocked sweeps at the phase-2 shape; cut
    # windows (never widths) if that rate would overrun the budget
    est = gcfg.gibbs_sweeps * t_sweep_s
    if n_gs * est > GS_TRAIN_BUDGET_S:
        n_gs = max(4, int(GS_TRAIN_BUDGET_S / est))
        log(f"[gs] cut: {GS_WINDOWS} -> {n_gs} windows ({est:.2f} s per "
            f"window at the measured blocked-sweep rate)")
    else:
        log(f"[gs] no cut: {n_gs} windows at ~{est:.2f} s each (blocked "
            f"sweep {t_sweep_s * 1e3:.2f} ms); an exact-scan gap of 60,000 "
            f"tokens ~{gcfg.gibbs_sweeps * 60_000 * t_token_s:.1f} s "
            f"({t_token_s * 1e6:.2f} us per token)")
    gs = MLegoSession(corpus, gcfg, kind="gs", backend="device",
                      device="cuda")
    for counter in ("merge_topics_launches", "merge_topics_ragged_launches",
                    "merge_topics_batch_launches"):
        setattr(merge_ops, counter, 0)
    gibbs_ops.gibbs_sweep_launches = 0
    gibbs_ops.cgs_sweep_exact_launches = 0

    t0 = time.perf_counter()
    for i in range(n_gs):
        m = gs.train_range(i * 1000.0, (i + 1) * 1000.0)
        if m is None or m.kind != "gs" or \
                float(m.theta["delta_nkv"].sum()) != m.n_tokens:
            raise AssertionError(f"gs window {i} did not conserve its tokens")
    torch.cuda.synchronize()
    log(f"[gs] train_range x{n_gs}: {time.perf_counter() - t0:.1f} s, "
        f"train_device_ms {gs.backend.stats.train_device_ms:.0f} over "
        f"{gs.backend.stats.gap_device_trains} fits")
    t0 = time.perf_counter()
    g_cov = gs.submit(covered)
    log(f"[gs] submit covered [0, 8000): {len(g_cov.model_ids)} parts, "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, merge "
        f"{g_cov.merge_device_ms:.2f} ms")
    t0 = time.perf_counter()
    g_gap = gs.submit(QuerySpec(sigma=Interval(8500.0, 12500.0)))
    log(f"[gs] submit with gaps [8500, 12500): {g_gap.n_merged} parts, "
        f"{g_gap.n_trained_tokens} trained tokens, "
        f"{time.perf_counter() - t0:.2f} s, train_device_ms "
        f"{g_gap.train_device_ms:.0f}")
    g_specs = [QuerySpec(sigma=Interval(0.0, 4000.0)),
               QuerySpec(sigma=Interval(4000.0, 6000.0)),
               QuerySpec(sigma=Interval(0.0, 8000.0)),
               QuerySpec(sigma=Interval(2000.0, 3000.0))]
    t0 = time.perf_counter()
    g_batch = gs.submit_many(g_specs)
    log(f"[gs] submit_many parts={[r.n_merged for r in g_batch]}: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, merge "
        f"{g_batch.merge_device_ms:.2f} ms, pad rows {g_batch.pad_rows}")
    if g_gap.n_trained_tokens <= 0:
        raise AssertionError("the gs gap query trained no tokens")
    if len({r.n_merged for r in g_batch}) < 3:
        raise AssertionError("gs submit_many did not merge ragged part "
                             "counts")
    blocked_launches = gibbs_ops.gibbs_sweep_launches

    # the "host" backend trains an untrained range with the exact scan;
    # a device-lost replay on "host" does too
    g_host = MLegoSession(corpus, gcfg, kind="gs", store=gs.store,
                          backend="host", device="cuda")
    t0 = time.perf_counter()
    g_hrep = g_host.submit(QuerySpec(sigma=Interval(20500.0, 21500.0)))
    t_host = time.perf_counter() - t0
    host_exact = gibbs_ops.cgs_sweep_exact_launches
    g_replay = MLegoSession(corpus, gcfg, kind="gs", store=gs.store,
                            backend="device", device="cuda")
    t0 = time.perf_counter()
    with injected(FaultRule("backend.train_gap.device", kind="device_lost",
                            max_failures=1)):
        g_rrep = g_replay.submit(QuerySpec(sigma=Interval(28500.0, 29500.0)))
    t_replay = time.perf_counter() - t0
    torch.cuda.synchronize()
    g_launches = {
        "gibbs_sweep": gibbs_ops.gibbs_sweep_launches,
        "cgs_sweep_exact": gibbs_ops.cgs_sweep_exact_launches,
        "merge_topics": merge_ops.merge_topics_launches,
        "merge_topics_ragged": merge_ops.merge_topics_ragged_launches}
    log(f"[gs] host gap query [20500, 21500): {g_hrep.n_trained_tokens} "
        f"trained tokens, {host_exact} exact-scan launches, {t_host:.2f} s; "
        f"device-lost replay [28500, 29500) on {g_rrep.backend}: "
        f"{g_rrep.n_trained_tokens} trained tokens, "
        f"{g_launches['cgs_sweep_exact'] - host_exact} exact-scan launches, "
        f"{t_replay:.2f} s")
    log(f"[gs] kernel launches on the gs path: {g_launches}")
    for kname, count in g_launches.items():
        if count <= 0:
            raise AssertionError(f"gs path never launched {kname}")
    if blocked_launches != gibbs_ops.gibbs_sweep_launches:
        raise AssertionError("a host-trained gs gap launched the blocked "
                             "sweep")
    if host_exact <= 0 or g_launches["cgs_sweep_exact"] <= host_exact:
        raise AssertionError("a host-trained gs gap did not launch the "
                             "exact scan")
    for kname, count in g_launches.items():
        by_path = report[kname].setdefault("launches_by_path", {})
        by_path["gs"] = count
        report[kname]["launches"] = sum(by_path.values())
    # the batched merge is the ragged path's retired parity reference:
    # no entry point of either path reaches it
    report["merge_topics_batch"]["launches"] = \
        merge_ops.merge_topics_batch_launches

    expect = [(g_cov, "device", None), (g_gap, "device", None),
              *[(r, "device", None) for r in g_batch],
              (g_hrep, "host", None), (g_rrep, "host", "device")]
    for r, backend, fallback in expect:
        if (r.backend, r.fallback_from) != (backend, fallback):
            raise AssertionError(f"gs report answered by {r.backend} "
                                 f"(fallback from {r.fallback_from}), "
                                 f"expected {backend} ({fallback})")
        if r.beta.shape != (gcfg.n_topics, gcfg.vocab_size) \
                or not np.isfinite(r.beta).all():
            raise AssertionError("gs beta is not finite (K, V)")
        row_err = float(np.abs(r.beta.sum(1) - 1.0).max())
        if row_err > 1e-5:
            raise AssertionError(f"gs beta rows sum to 1 +- {row_err}")
    if g_hrep.n_trained_tokens <= 0 or g_rrep.n_trained_tokens <= 0:
        raise AssertionError("a host gs gap trained no tokens")
    g_hcov = g_host.submit(covered)
    diff = float(np.abs(g_hcov.beta - g_cov.beta).max())
    if g_hcov.model_ids != g_cov.model_ids or not np.allclose(
            g_cov.beta, g_hcov.beta, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"gs device beta differs from host by {diff}")
    lpp = log_predictive_probability(g_cov.beta, x_in, gcfg.alpha)
    log(f"[gs] covered beta: device vs host max abs diff {diff:.3g} (tol "
        f"1e-5); per-token log predictive merged {lpp:.4f}, uniform "
        f"{lpp_flat:.4f}")
    if not lpp > lpp_flat:
        raise AssertionError("merged gs topics fit no better than uniform")

    # -- 6. the LM serving path at qwen3-1.7b full width ---------------------
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import make_batch
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model
    lcfg = get_arch("qwen3-1.7b")
    model = build_model(lcfg)
    t0 = time.perf_counter()
    masters = model.init(torch.Generator(device=dev).manual_seed(0))
    params = model.cast_params(masters)
    torch.cuda.synchronize()
    log(f"[serve] {lcfg.name}: {model.param_count(params) / 1e9:.3f} B "
        f"parameters ({lcfg.n_layers} layers, d_model {lcfg.d_model}, "
        f"{lcfg.n_heads}/{lcfg.n_kv_heads} heads of {lcfg.hd}, vocab "
        f"{lcfg.padded_vocab}), {lcfg.dtype}; init + cast "
        f"{time.perf_counter() - t0:.1f} s")
    batch = make_batch(lcfg, SERVE_B, SERVE_PROMPT, 0, 0)
    batch.pop("labels")
    # a short warm-up through the same entry point (cuBLAS heuristics,
    # allocator), not counted
    generate(model, params, batch, steps=2, cache_len=SERVE_CACHE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_ops.flash_attention_launches = 0
    decode_ops.decode_attention_launches = 0
    stats = {}
    toks = generate(model, params, batch, steps=SERVE_STEPS,
                    cache_len=SERVE_CACHE, stats=stats)
    s_launches = {"flash_attention": flash_ops.flash_attention_launches,
                  "decode_attention": decode_ops.decode_attention_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_gen = SERVE_B * SERVE_STEPS
    log(f"[serve] generate B={SERVE_B} prompt={SERVE_PROMPT} "
        f"cache_len={SERVE_CACHE} steps={SERVE_STEPS}: prefill "
        f"{stats['prefill_s']:.4f} s, decode {stats['decode_s']:.4f} s = "
        f"{stats['decode_s'] / SERVE_STEPS * 1e3:.3f} ms per step, "
        f"{n_gen / stats['decode_s']:.1f} generated tokens/s in decode, "
        f"{n_gen / (stats['prefill_s'] + stats['decode_s']):.1f} "
        f"end to end; peak memory allocated {peak_gb:.2f} GB")
    log(f"[serve] kernel launches on the serve path: {s_launches}")
    if s_launches["flash_attention"] != lcfg.n_layers:
        raise AssertionError(f"prefill launched the flash kernel "
                             f"{s_launches['flash_attention']} times, "
                             f"expected {lcfg.n_layers}")
    if s_launches["decode_attention"] != lcfg.n_layers * SERVE_STEPS:
        raise AssertionError(f"decode launched the decode kernel "
                             f"{s_launches['decode_attention']} times, "
                             f"expected {lcfg.n_layers * SERVE_STEPS}")
    if not stats["logits_finite"]:
        raise AssertionError("serve logits are not finite")
    if toks.shape != (SERVE_B, SERVE_STEPS) or int(toks.min()) < 0 or \
            int(toks.max()) >= lcfg.padded_vocab:
        raise AssertionError(f"generated tokens {tuple(toks.shape)} outside "
                             f"[0, {lcfg.padded_vocab})")
    log(f"[serve] sample: {toks[0, :16].tolist()}")
    for kname, count in s_launches.items():
        report[kname]["launches_by_path"] = {"serve": count}
        report[kname]["launches"] = count
    del batch, toks
    torch.cuda.empty_cache()

    # -- 13 (a), (e): the same weights on a (1, 4) grid and as a pipeline ----
    # the grid path's counts: each grid run's counters zeroed just before
    # it and read just after, summed over (a)-(f)
    grid_acc = {k: 0 for k in GRID_KERNELS}
    grid_out = {}
    t_grid = time.perf_counter()
    gbatch = make_batch(lcfg, GRID_B, GRID_PROMPT, 0, 0)
    gbatch.pop("labels")
    ring = sum(range(1, 5))           # cell r runs r + 1 causal ring steps
    grid_out["qwen3-1.7b"] = grid_serve(
        "qwen3-1.7b", model, params, gbatch, dev, card, grid_acc,
        {"flash_attention": lcfg.n_layers * ring,
         "decode_attention": lcfg.n_layers * 4 * GRID_STEPS,
         "slstm_scan": 0})
    grid_out["pipeline"] = grid_pipeline(model, params, dev, card, grid_acc)
    del params, gbatch
    torch.cuda.empty_cache()
    grid_s = time.perf_counter() - t_grid

    # the same weights in float32: decode_step after the served 2,048-token
    # prefill must give the logits of a 2,049-token prefill (the JAX
    # package's consistency check, tests/test_arch_smoke.py, at its 2e-3)
    model32 = build_model(dataclasses.replace(lcfg, dtype="float32"))
    p32 = model32.cast_params(masters)
    t = make_batch(lcfg, 2, SERVE_PROMPT + 1, 0, 1, device=dev)["tokens"]
    with torch.inference_mode():
        _, caches = model32.prefill(p32, {"tokens": t[:, :SERVE_PROMPT]},
                                    cache_len=SERVE_CACHE)
        lg_dec, _ = model32.decode_step(p32, caches, t[:, SERVE_PROMPT:],
                                        SERVE_PROMPT)
        lg_full, _ = model32.prefill(p32, {"tokens": t})
    diff = float((lg_dec - lg_full).abs().max())
    scale = float(lg_full.abs().max())
    if not torch.allclose(lg_dec, lg_full, rtol=CONSISTENCY_TOL,
                          atol=CONSISTENCY_TOL):
        raise AssertionError(f"float32 decode_step differs from prefill by "
                             f"{diff} (tol {CONSISTENCY_TOL})")
    log(f"[serve] float32 full width: decode_step(prefill({SERVE_PROMPT}))"
        f" vs prefill({SERVE_PROMPT + 1}) max abs diff {diff:.3g} over logits up to "
        f"{scale:.3g} (tol {CONSISTENCY_TOL})")
    del masters, p32, caches
    torch.cuda.empty_cache()
    t_grid = time.perf_counter()
    grid_f32("qwen3-1.7b", dataclasses.replace(
        lcfg, dtype="float32", n_layers=GRID_CHECK_LAYERS), dev)
    grid_s += time.perf_counter() - t_grid

    # -- 7. the xLSTM serving path at xlstm-1.3b full width -------------------
    xcfg = get_arch("xlstm-1.3b")
    xmodel = build_model(xcfg)
    n_s = xmodel.kinds.count("s")
    held_gb = torch.cuda.memory_allocated() / 1e9   # by the earlier phases
    t0 = time.perf_counter()
    masters = xmodel.init(torch.Generator(device=dev).manual_seed(0))
    params = xmodel.cast_params(masters)
    torch.cuda.synchronize()
    log(f"[xlstm] {xcfg.name}: {xmodel.param_count(params) / 1e9:.3f} B "
        f"parameters ({xcfg.n_layers} layers: {xmodel.kinds.count('m')} "
        f"mLSTM, {n_s} sLSTM; d_model {xcfg.d_model}, {xcfg.n_heads} heads "
        f"of {xcfg.d_model // xcfg.n_heads}, vocab {xcfg.padded_vocab}), "
        f"{xcfg.dtype}; init + cast {time.perf_counter() - t0:.1f} s")
    batch = make_batch(xcfg, SERVE_B, SERVE_PROMPT, 0, 0)
    batch.pop("labels")
    # a short warm-up through the same entry point, not counted
    generate(xmodel, params, batch, steps=2, cache_len=SERVE_CACHE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    slstm_ops.slstm_scan_launches = 0
    for route in slstm_ops.ROUTES:
        setattr(slstm_ops, f"slstm_{route}_launches", 0)
    stats = {}
    toks = generate(xmodel, params, batch, steps=SERVE_STEPS,
                    cache_len=SERVE_CACHE, stats=stats)
    x_launches = slstm_ops.slstm_scan_launches
    x_routes = {route: getattr(slstm_ops, f"slstm_{route}_launches")
                for route in slstm_ops.ROUTES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[xlstm] generate B={SERVE_B} prompt={SERVE_PROMPT} "
        f"steps={SERVE_STEPS}: prefill {stats['prefill_s']:.4f} s, decode "
        f"{stats['decode_s']:.4f} s = "
        f"{stats['decode_s'] / SERVE_STEPS * 1e3:.3f} ms per step, "
        f"{n_gen / stats['decode_s']:.1f} generated tokens/s in decode, "
        f"{n_gen / (stats['prefill_s'] + stats['decode_s']):.1f} end to "
        f"end; peak memory allocated {peak_gb:.2f} GB ({held_gb:.2f} GB "
        f"of it held by the earlier phases); on {card}")
    log(f"[xlstm] sLSTM kernel launches on the xlstm path: {x_launches} "
        f"({n_s} a prefill + {n_s} x {SERVE_STEPS} decode steps), by route "
        f"{x_routes}")
    want_routes = {"step": n_s * SERVE_STEPS, "cluster": n_s, "coop": 0}
    if x_launches != n_s * (1 + SERVE_STEPS) or x_routes != want_routes:
        raise AssertionError(f"the xlstm path launched the sLSTM kernels "
                             f"{x_launches} times, by route {x_routes}; "
                             f"expected {n_s * (1 + SERVE_STEPS)}, "
                             f"{want_routes}")
    if not stats["logits_finite"]:
        raise AssertionError("xlstm logits are not finite")
    if toks.shape != (SERVE_B, SERVE_STEPS) or int(toks.min()) < 0 or \
            int(toks.max()) >= xcfg.padded_vocab:
        raise AssertionError(f"generated tokens {tuple(toks.shape)} outside "
                             f"[0, {xcfg.padded_vocab})")
    if peak_gb > XL_PEAK_GB:
        raise AssertionError(f"the xlstm path allocated {peak_gb:.2f} GB, "
                             f"more than {XL_PEAK_GB} GB")
    log(f"[xlstm] sample: {toks[0, :16].tolist()}")
    report["slstm_scan"]["launches_by_path"] = {"xlstm": x_launches}
    report["slstm_scan"]["launches"] = x_launches
    for route, n in x_routes.items():
        report["slstm_scan"]["instances"][route]["launches"] = n
    del batch, toks
    torch.cuda.empty_cache()
    # -- 13 (b): the mLSTM prefix and the sLSTM carry chain on a (1, 4) grid
    t_grid = time.perf_counter()
    gbatch = make_batch(xcfg, GRID_B, GRID_PROMPT, 0, 0)
    gbatch.pop("labels")
    # the chain: 4 scan launches a prefill (one a cell, in order); a decode
    # step: 4 (each "model" rank steps its block of the heads)
    grid_out["xlstm-1.3b"] = grid_serve(
        "xlstm-1.3b", xmodel, params, gbatch, dev, card, grid_acc,
        {"flash_attention": 0, "decode_attention": 0,
         "slstm_scan": n_s * 4 * (1 + GRID_STEPS)})
    del params, gbatch
    torch.cuda.empty_cache()
    grid_s += time.perf_counter() - t_grid

    # the same weights in float32: decode_step after a 256-token prefill
    # must give the logits of a 257-token prefill (2e-3, as above)
    x32 = build_model(dataclasses.replace(xcfg, dtype="float32"))
    p32 = x32.cast_params(masters)
    t = make_batch(xcfg, 2, XL_CHECK_PROMPT + 1, 0, 1, device=dev)["tokens"]
    with torch.inference_mode():
        _, caches = x32.prefill(p32, {"tokens": t[:, :XL_CHECK_PROMPT]})
        lg_dec, _ = x32.decode_step(p32, caches, t[:, XL_CHECK_PROMPT:],
                                    XL_CHECK_PROMPT)
        lg_full, _ = x32.prefill(p32, {"tokens": t})
    diff = float((lg_dec - lg_full).abs().max())
    scale = float(lg_full.abs().max())
    if not bool(torch.isfinite(lg_full).all()) or not torch.allclose(
            lg_dec, lg_full, rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL):
        raise AssertionError(f"xlstm float32 decode_step differs from "
                             f"prefill by {diff} (tol {CONSISTENCY_TOL})")
    log(f"[xlstm] float32 full width: decode_step(prefill("
        f"{XL_CHECK_PROMPT})) vs prefill({XL_CHECK_PROMPT + 1}) max abs diff "
        f"{diff:.3g} over logits up to {scale:.3g} (tol {CONSISTENCY_TOL})")
    del masters, p32, caches
    torch.cuda.empty_cache()
    t_grid = time.perf_counter()
    grid_f32("xlstm-1.3b", dataclasses.replace(
        xcfg, dtype="float32", n_layers=2, block_pattern=("m", "s")), dev)
    grid_s += time.perf_counter() - t_grid

    # -- 8. the multi-tenant query service ----------------------------------
    # phase 3's corpus and config; the service's counts are zeroed inside
    # and read after its close()
    svc_out = service_phase(corpus, cfg, dev, 1000.0, card)
    for step, count in svc_out["grew"].items():
        if count <= 0:
            raise AssertionError(f"service step {step} launched no kernel")
    for kname, count in svc_out["launches"].items():
        if count <= 0:
            raise AssertionError(f"service path never launched {kname}")
        by_path = report[kname].setdefault("launches_by_path", {})
        by_path["service"] = count
        report[kname]["launches"] = sum(by_path.values())
    log(f"[service] {svc_out['queries']} answers in {svc_out['groups']} "
        f"groups (coalesce width mean {svc_out['mean_width']:.2f}, max "
        f"{svc_out['max_width']})")

    # -- 9. the vocab-sharded backend ---------------------------------------
    # phase 3's and phase 5's window models; the counts are zeroed inside,
    # after the "device" answers it is held to
    sh_out = sharded_phase(corpus, cfg, gcfg, session.store, gs.store, dev,
                           1000.0, card)
    for kname, count in sh_out["launches"].items():
        if count <= 0:
            raise AssertionError(f"sharded path never launched {kname}")
        by_path = report[kname].setdefault("launches_by_path", {})
        by_path["sharded"] = count
        report[kname]["launches"] = sum(by_path.values())
    # the merge kernels' errors on the sharded path's slices join the
    # kernels section's
    for kname, err in sh_out["kernel_errs"].items():
        report[kname]["max_abs_err"] = max(report[kname]["max_abs_err"], err)

    # -- 10. the other families' serving paths ------------------------------
    # each path's counts are zeroed inside, just before its generate
    fam_out = families_phase(dev, card, grid_acc, grid_out)
    for path, counts in fam_out["launches"].items():
        for kname, count in counts.items():
            if count <= 0:
                raise AssertionError(f"{path} path never launched {kname}")
            by_path = report[kname].setdefault("launches_by_path", {})
            by_path[path] = count
            report[kname]["launches"] = sum(by_path.values())

    # -- 11. the MoE serving path -------------------------------------------
    # each model's counts are zeroed inside, just before its generate, and
    # summed over the two models
    moe_out = moe_phase(dev, card, grid_acc, grid_out)
    for kname, count in moe_out["launches"].items():
        if count <= 0:
            raise AssertionError(f"moe path never launched {kname}")
        by_path = report[kname].setdefault("launches_by_path", {})
        by_path["moe"] = count
        report[kname]["launches"] = sum(by_path.values())

    # -- 12. LM training: no kernel on its path ------------------------------
    # every counter zeroed inside, just before Trainer.fit
    train_out = train_phase(dev, card)
    for kname in report:
        report[kname].setdefault("launches_by_path", {})["train"] = 0

    # -- 13 (f): training on a (2, 2) grid, then the grid path's counts ------
    t_grid = time.perf_counter()
    grid_out["train"] = grid_train(dev, card)
    grid_s += time.perf_counter() - t_grid
    for kname in GRID_KERNELS:
        if grid_acc[kname] <= 0:
            raise AssertionError(f"the grid path never launched {kname}")
    for kname in report:
        by_path = report[kname].setdefault("launches_by_path", {})
        by_path["grid"] = grid_acc.get(kname, 0)
        report[kname]["launches"] = sum(by_path.values())
    log(f"[grid] phase 13: launches on the grid path {grid_acc}; its runs "
        f"took {grid_s:.1f} s in all (the families' and the MoE grid runs "
        f"are timed within their phases)")

    # -- 14. the example scripts --------------------------------------------
    # every counter zeroed inside, just before each script's main
    ex_out = examples_phase(dev, card)
    for kname in report:
        by_path = report[kname].setdefault("launches_by_path", {})
        by_path["examples"] = ex_out["launches"][kname]
        report[kname]["launches"] = sum(by_path.values())

    # the attention kernels at the shapes phases 10 and 11 gave them, held
    # against their plain versions and timed (uncounted) in bf16, five
    # repeat calls giving the same bits (the SASS check of phase 2 covers
    # every bf16 instance, hd 64 and 256 among them): the flash kernel at
    # each of the four prefill shapes of phase 10 — recurrentgemma-9b's
    # "local" layers (16 query heads on one KV head of 256, window 2,048:
    # a CTA holds 64 / 16 = 4 query positions), llava-next-34b's layers
    # (56 query heads on 8 KV heads of 128: G = 7 leaves 1 of a CTA's 64
    # rows idle), whisper-tiny's bidirectional encoder and its causal
    # decoder — and at phase 11's two (qwen3-moe-235b-a22b: 64 query heads
    # on 4 KV heads of 128, G = 16, 4 query positions a CTA;
    # llama4-scout-17b-a16e: 40 on 8, G = 5); the decode kernel at
    # llava-next-34b's and whisper-tiny's decoder steps and at phase 11's
    # (G·hd = 2,048, the most the decode kernel holds, and 640).  The
    # library figure is SDPA, with the boolean band mask for the window
    # time_ms's L2 flush again (freed after phase 2)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    shapes = {"flash_attention": {}, "decode_attention": {}}
    for label, b, s, h, kvh, hd, causal, window in [
            ("hybrid local", 2, 4096, 16, 1, 256, True, 2048),
            ("vlm prefill", 2, 4096, 56, 8, 128, True, 0),
            ("audio encoder", 4, 1536, 6, 6, 64, False, 0),
            ("audio decoder", 4, 384, 6, 6, 64, True, 0),
            ("moe qwen3-moe prefill", 2, 4096, 64, 4, 128, True, 0),
            ("moe llama4-scout prefill", 2, 4096, 40, 8, 128, True, 0)]:
        q, k, v = (torch.tensor(rng.normal(size=(b, s, n, hd)),
                                dtype=torch.float32, device=dev).to(
                                    torch.bfloat16)
                   for n in (h, kvh, kvh))
        got = flash_ops.flash_attention(q, k, v, causal=causal,
                                        window=window)
        want = flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
        err, msg = attn_close(got, want, torch.bfloat16)
        del want
        for _ in range(5):
            if not torch.equal(flash_ops.flash_attention(
                    q, k, v, causal=causal, window=window), got):
                raise AssertionError(f"flash_attention ({label}) gives "
                                     "other bits on a repeat call")
        pos = torch.arange(s, device=dev)
        dd = pos[:, None] - pos[None, :]
        mask = None
        if causal:
            mask = (dd >= 0) & ((dd < window) if window else True)
        # the (query, key) pairs the mask keeps: 4·hd flops each
        pairs = (int(mask.sum()) if mask is not None else s * s)
        del pos, dd
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = time_ms(lambda: flash_ops.flash_attention(
            q, k, v, causal=causal, window=window), 10)
        plain = time_ms(lambda: flash_attention_ref(
            q, k, v, causal=causal, window=window), 3)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), 10)
        c = flash_ops.cost(b, s, h, kvh, hd, torch.bfloat16, causal=causal,
                           window=window)
        n_ops = c.flops
        b_ms, b_by = c.bound_ms()
        shapes["flash_attention"][label] = dict(
            shape=f"B={b} S={s} H={h} KVH={kvh} hd={hd} causal={causal} "
                  f"window={window} bf16", max_abs_err=err, ms=ms,
            plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        log(f"[kernels] flash_attention ({label}) B={b} S={s} H={h} "
            f"KVH={kvh} hd={hd} causal={causal} window={window} bf16: {msg}; "
            f"{ms:.4f} ms, {n_ops / 1e9:.2f} GFLOP, "
            f"{n_ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s; bound {b_ms:.4f} ms "
            f"({b_by}); plain {plain:.3f} ms; SDPA {lib:.4f} ms; same bits "
            f"over 5 calls; on {card}")
        del q, k, v, qt, kt, vt, got, mask
    for label, b, s, h, kvh, hd, pos in [
            ("vlm decode", 2, 4160, 56, 8, 128, 4150),
            ("audio decode", 4, 448, 6, 6, 64, 447),
            ("moe qwen3-moe decode", 2, 4160, 64, 4, 128, 4150),
            ("moe llama4-scout decode", 2, 4160, 40, 8, 128, 4150)]:
        q = torch.tensor(rng.normal(size=(b, 1, h, hd)), dtype=torch.float32,
                         device=dev).to(torch.bfloat16)
        kc, vc = (torch.tensor(rng.normal(size=(b, s, kvh, hd)),
                               dtype=torch.float32, device=dev).to(
                                   torch.bfloat16) for _ in range(2))
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        got = decode_ops.decode_attention(q, kc, vc, p)
        want = decode_attention_ref(q.float(), kc.float(), vc.float(), pos)
        err, msg = attn_close(got, want, torch.bfloat16)
        for _ in range(5):
            if not torch.equal(decode_ops.decode_attention(q, kc, vc, p),
                               got):
                raise AssertionError(f"decode_attention ({label}) gives "
                                     "other bits on a repeat call")
        qt = q.transpose(1, 2)
        kt, vt = (x[:, :pos + 1].transpose(1, 2) for x in (kc, vc))
        ms = time_ms(lambda: decode_ops.decode_attention(q, kc, vc, p), 20)
        plain = time_ms(lambda: decode_attention_ref(q, kc, vc, pos), 20)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True), 20)
        c = decode_ops.cost(b, s, h, kvh, hd, torch.bfloat16, pos)
        n_bytes = c.n_bytes
        b_ms, b_by = c.bound_ms()
        n_split, chunk = decode_ops.split_plan(s, b * kvh)
        shapes["decode_attention"][label] = dict(
            shape=f"B={b} S={s} pos={pos} H={h} KVH={kvh} hd={hd} bf16",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib)
        log(f"[kernels] decode_attention ({label}) B={b} S={s} pos={pos} "
            f"H={h} KVH={kvh} hd={hd} bf16 ({n_split} splits of {chunk}): "
            f"{msg}; {ms:.4f} ms, {n_bytes / (ms * 1e-3) / 1e12:.3f} TB/s; "
            f"bound {b_ms:.4f} ms ({b_by}); plain {plain:.4f} ms; SDPA "
            f"{lib:.4f} ms; same bits over 5 calls; on {card}")
        del q, kc, vc, qt, kt, vt, got, want
    # phase 13's extensions at the shapes the grid paths gave them, held
    # against their plain versions (the output and the lse), five repeat
    # calls giving the same bits, timed (uncounted) beside their bound and
    # SDPA with the step's mask: the flash kernel at qwen3-1.7b's ring step
    # (S_loc = 1,024 of 4,096: q_offset 0, S_loc, 2 S_loc, 3 S_loc) and
    # recurrentgemma-9b's "local" steps (window 2,048: 0, S_loc, 2 S_loc);
    # the decode kernel on qwen3-1.7b's cache shard (1,040 of the 4,160
    # positions) that holds pos, on one past pos (empty: pos - start < 0)
    # and on qwen3-moe-235b-a22b's shard that holds pos
    for label, b, s, h, kvh, hd, window, off in [
            ("ring step q_offset=0", 2, 1024, 16, 8, 128, 0, 0),
            ("ring step q_offset=1024", 2, 1024, 16, 8, 128, 0, 1024),
            ("ring step q_offset=2048", 2, 1024, 16, 8, 128, 0, 2048),
            ("ring step q_offset=3072", 2, 1024, 16, 8, 128, 0, 3072),
            ("local ring step q_offset=0", 2, 1024, 16, 1, 256, 2048, 0),
            ("local ring step q_offset=1024", 2, 1024, 16, 1, 256, 2048,
             1024),
            ("local ring step q_offset=2048", 2, 1024, 16, 1, 256, 2048,
             2048)]:
        q, k, v = (torch.tensor(rng.normal(size=(b, s, n, hd)),
                                dtype=torch.float32, device=dev).to(
                                    torch.bfloat16)
                   for n in (h, kvh, kvh))

        def step():
            return flash_ops.flash_attention(q, k, v, causal=True,
                                             window=window, q_offset=off,
                                             return_lse=True)

        got, lse = step()
        want, wlse = flash_attention_ref(q.float(), k.float(), v.float(),
                                         causal=True, window=window,
                                         q_offset=off, return_lse=True)
        err, msg = attn_close(got, want, torch.bfloat16)
        seen = torch.isfinite(wlse)
        if not torch.equal(torch.isfinite(lse), seen):
            raise AssertionError(f"flash_attention ({label}): rows that see "
                                 "no key differ from the plain version's")
        lse_err = close(lse[seen], wlse[seen], 1e-3, 1e-4)
        del want, wlse
        for _ in range(5):
            again = step()
            if not (torch.equal(again[0], got) and torch.equal(again[1],
                                                               lse)):
                raise AssertionError(f"flash_attention ({label}) gives "
                                     "other bits on a repeat call")
        del again
        pos = torch.arange(s, device=dev)
        dd = (pos + off)[:, None] - pos[None, :]
        mask = (dd >= 0) & ((dd < window) if window else True)
        pairs = int(mask.sum())
        del pos, dd
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = time_ms(step, 10)
        plain = time_ms(lambda: flash_attention_ref(
            q, k, v, causal=True, window=window, q_offset=off,
            return_lse=True), 3)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), 10)
        b_ms, b_by = flash_ops.cost(
            b, s, h, kvh, hd, torch.bfloat16, window=window, q_offset=off,
            return_lse=True).bound_ms()
        shapes["flash_attention"][label] = dict(
            shape=f"B={b} S={s} H={h} KVH={kvh} hd={hd} causal=True "
                  f"window={window} q_offset={off} lse, bf16 in, f32 out",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib)
        log(f"[kernels] flash_attention ({label}) B={b} S={s} H={h} "
            f"KVH={kvh} hd={hd} window={window}: {msg}, lse max abs err "
            f"{lse_err:.3g}; {ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}); "
            f"plain {plain:.3f} ms; SDPA {lib:.4f} ms; same bits over 5 "
            f"calls; on {card}")
        del q, k, v, qt, kt, vt, got, lse, mask
    for label, b, s, h, kvh, hd, pos in [
            ("shard holding pos", 2, 1040, 16, 8, 128, 1030),
            ("empty shard", 2, 1040, 16, 8, 128, -1050),
            ("moe shard holding pos", 2, 1040, 64, 4, 128, 1030)]:
        q = torch.tensor(rng.normal(size=(b, 1, h, hd)), dtype=torch.float32,
                         device=dev).to(torch.bfloat16)
        kc, vc = (torch.tensor(rng.normal(size=(b, s, kvh, hd)),
                               dtype=torch.float32, device=dev).to(
                                   torch.bfloat16) for _ in range(2))
        p = torch.tensor(pos, dtype=torch.int32, device=dev)

        def shard():
            return decode_ops.decode_attention(q, kc, vc, p, return_lse=True)

        got, lse = shard()
        want, wlse = decode_attention_ref(q.float(), kc.float(), vc.float(),
                                          pos, return_lse=True)
        if bool(torch.isnan(got).any()) or bool(torch.isnan(lse).any()):
            raise AssertionError(f"decode_attention ({label}) gives NaN")
        err, msg = attn_close(got, want, torch.bfloat16)
        seen = torch.isfinite(wlse)
        if not torch.equal(torch.isfinite(lse), seen):
            raise AssertionError(f"decode_attention ({label}): its lse is "
                                 "-inf where the plain version's is not")
        lse_err = close(lse[seen], wlse[seen], 1e-3, 1e-4) \
            if bool(seen.any()) else 0.0
        for _ in range(5):
            again = shard()
            if not (torch.equal(again[0], got) and torch.equal(again[1],
                                                               lse)):
                raise AssertionError(f"decode_attention ({label}) gives "
                                     "other bits on a repeat call")
        live = max(0, min(pos, s - 1) + 1)
        ms = time_ms(shard, 20)
        plain = time_ms(lambda: decode_attention_ref(
            q, kc, vc, pos, return_lse=True), 20)
        lib = None
        if live:
            qt = q.transpose(1, 2)
            kt, vt = (x[:, :live].transpose(1, 2) for x in (kc, vc))
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True), 20)
            del qt, kt, vt
        b_ms, b_by = decode_ops.cost(b, s, h, kvh, hd, torch.bfloat16, pos,
                                     return_lse=True).bound_ms()
        shapes["decode_attention"][label] = dict(
            shape=f"B={b} S={s} pos={pos} H={h} KVH={kvh} hd={hd} lse, bf16 "
                  f"in, f32 out", max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        log(f"[kernels] decode_attention ({label}) B={b} S={s} pos={pos} "
            f"H={h} KVH={kvh} hd={hd}: {msg}, lse max abs err {lse_err:.3g}; "
            f"{ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}); plain {plain:.4f} "
            f"ms; SDPA {'-' if lib is None else f'{lib:.4f}'} ms; same bits "
            f"over 5 calls; on {card}")
        del q, kc, vc, got, lse, want, wlse
    # the sLSTM scan at one cell of phase 13 (b)'s carry chain (B = 2,
    # S_loc = 1,024 of 4,096, the model's bf16 xpre and R: the cluster
    # route) from a carried (nonzero) state, as cells 1-3 run it
    xpre, r, st = slstm_inputs(GRID_B, GRID_PROMPT // 4, XL_H, XL_HD, bf16,
                               bf16, True)
    got, got_st = slstm_ops.slstm_scan(xpre, r, *st)
    want, want_st = slstm_scan_ref(xpre, r, *st)
    err = max([close(got.float(), want.float(), 2.0 ** -7)]
              + [close(g, w, 1e-4) for g, w in zip(got_st, want_st)])
    for _ in range(5):
        again = slstm_ops.slstm_scan(xpre, r, *st)
        if not (torch.equal(again[0], got) and all(
                torch.equal(x, y) for x, y in zip(again[1], got_st))):
            raise AssertionError("slstm_scan (grid chain cell) gives other "
                                 "bits on a repeat call")
    ms = time_ms(lambda: slstm_ops.slstm_scan(xpre, r, *st), 10)
    plain = time_ms(lambda: slstm_scan_ref(xpre, r, *st), 1)
    b_ms, b_by = slstm_bound(GRID_B, GRID_PROMPT // 4, XL_H, XL_HD, bf16,
                             bf16)
    shapes["slstm_scan"] = {"grid chain cell": dict(
        shape=f"B={GRID_B} S={GRID_PROMPT // 4} H={XL_H} hd={XL_HD} bf16 "
              f"xpre and R, from a carried state ("
              f"{slstm_plan(GRID_B, GRID_PROMPT // 4, XL_H, XL_HD, bf16)})",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None)}
    log(f"[kernels] slstm_scan (grid chain cell) B={GRID_B} "
        f"S={GRID_PROMPT // 4} H={XL_H} hd={XL_HD} bf16 from a carried "
        f"state: max abs err {err:.3g}; {ms:.4f} ms; bound {b_ms:.4f} ms "
        f"({b_by}); plain {plain:.3f} ms; same bits over 5 calls; on {card}")
    del xpre, r, st, got, got_st, want, want_st, again
    # phase 14's kernels at the inputs the examples gave them (a copy of
    # one call at each shape, for the E-step the largest window at each
    # (K, V)), held against their plain versions at their usual tolerances
    # and timed (uncounted): vb_estep at both MLego scripts' widths, flash
    # and decode at the reduced qwen3-1.7b's (float32, hd = 16), the sLSTM
    # scan's cooperative (the prompt) and step (a decode step) routes at
    # the reduced xlstm-1.3b's; SDPA the library figure for attention
    shapes["vb_estep"] = {}

    def outs(x):
        return x if isinstance(x, tuple) else (x,)

    for (kname, label, _), a in ex_out["captured"].items():
        lib_fn, extra = None, ""
        if kname == "vb_estep":
            csr, eeb, g0 = a["csr"], a["exp_elog_beta"], a["gamma0"]
            alpha, iters = a["alpha"], a["n_iters"]
            (d, v), k, nnz = csr.shape, eeb.shape[0], csr.nnz

            def run():
                return estep_ops.vb_estep_csr(csr, eeb, g0, alpha, iters)

            def plain_fn():
                return vb_estep_csr_ref(csr, eeb, g0, alpha, iters)
            got, want = run(), plain_fn()
            err = max(close(x, y, ESTEP_TOL) for x, y in zip(got, want))
            msg = f"max abs err {err:.3g} (tol {ESTEP_TOL})"
            b_ms, b_by = estep_ops.cost(d, k, v, nnz, iters).bound_ms()
            shape = f"D={d} K={k} V={v} n_iters={iters} nnz={nnz}"
        elif kname == "slstm_scan":
            xpre, r = a["xpre"], a["r_mat"]
            st = tuple(a[n] for n in ("c0", "n0", "h0", "m0"))
            b, s, _, h, hd = xpre.shape

            def run():
                return slstm_ops.slstm_scan(xpre, r, *st)

            def plain_fn():
                return slstm_scan_ref(xpre, r, *st)
            (got, got_st), (want, want_st) = run(), plain_fn()
            tol = 1e-5 if s <= 64 else 1e-4
            h_tol = tol if xpre.dtype == f32 else 2.0 ** -7
            err = max([close(got.float(), want.float(), h_tol)]
                      + [close(g, w, tol) for g, w in zip(got_st, want_st)])
            msg = f"max abs err {err:.3g} (tol h {h_tol:.3g}, state {tol})"
            b_ms, b_by = slstm_bound(b, s, h, hd, xpre.dtype, r.dtype)
            shape = (f"B={b} S={s} H={h} hd={hd} xpre {dt_name[xpre.dtype]}"
                     f" R {dt_name[r.dtype]} "
                     f"({slstm_plan(b, s, h, hd, r.dtype)})")
        else:
            q, kc, vc = (a[n] for n in (("q", "k", "v") if kname ==
                                        "flash_attention" else
                                        ("q", "k_cache", "v_cache")))
            b, s, h, hd = (q.shape[0], kc.shape[1], q.shape[2], q.shape[3])
            kvh, window = kc.shape[2], a["window"]
            qt = q.transpose(1, 2)
            if kname == "flash_attention":
                kw = {n: a[n] for n in ("causal", "window", "q_offset",
                                        "return_lse")}

                def run():
                    return flash_ops.flash_attention(q, kc, vc, **kw)

                def plain_fn():
                    return flash_attention_ref(q, kc, vc, **kw)
                pos = torch.arange(s, device=dev)
                dd = (pos + kw["q_offset"])[:, None] - pos[None, :]
                mask = None
                if kw["causal"]:
                    mask = (dd >= 0) & ((dd < window) if window else True)
                pairs = int(mask.sum()) if mask is not None else s * s
                kt, vt = (x.transpose(1, 2) for x in (kc, vc))
                c = flash_ops.cost(b, s, h, kvh, hd, q.dtype, **kw)
                shape = (f"B={b} S={s} H={h} KVH={kvh} hd={hd} causal="
                         f"{kw['causal']} window={window} q_offset="
                         f"{kw['q_offset']} {dt_name[q.dtype]}")
            else:
                p = int(a["pos"])
                lo = max(0, p - window + 1) if window else 0
                live = max(0, min(p, s - 1) + 1 - lo)
                kw = {n: a[n] for n in ("window", "return_lse")}

                def run():
                    return decode_ops.decode_attention(q, kc, vc, a["pos"],
                                                       **kw)

                def plain_fn():
                    return decode_attention_ref(q, kc, vc, p, **kw)
                mask = None
                pairs = live
                kt, vt = (x[:, lo:lo + live].transpose(1, 2)
                          for x in (kc, vc))
                c = decode_ops.cost(b, s, h, kvh, hd, q.dtype, p, **kw)
                shape = (f"B={b} S={s} pos={p} H={h} KVH={kvh} hd={hd} "
                         f"window={window} {dt_name[q.dtype]}")
            got, want = outs(run()), outs(plain_fn())
            err, msg = attn_close(got[0], want[0], q.dtype)
            if len(got) > 1:
                seen = torch.isfinite(want[1])
                close(got[1][seen], want[1][seen], 1e-3, 1e-4)
            b_ms, b_by = c.bound_ms()
            if pairs:
                def lib_fn():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, enable_gqa=True)
        ms = time_ms(run, 20)
        plain = time_ms(plain_fn, 5)
        lib = time_ms(lib_fn, 20) if lib_fn is not None else None
        shapes[kname][f"example {label}: {shape}"] = dict(
            shape=shape, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        log(f"[kernels] {kname} (example {label}) {shape}: {msg}; "
            f"{ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}); plain {plain:.4f} "
            f"ms; library {'-' if lib is None else f'{lib:.4f}'} ms; on "
            f"{card}")
    del ex_out
    for kname, rows in shapes.items():
        report[kname]["shapes"] = rows
        report[kname]["max_abs_err"] = max(
            [report[kname]["max_abs_err"]]
            + [r["max_abs_err"] for r in rows.values()])
    del flush
    torch.cuda.empty_cache()

    # -- 15. the dry run held against the card --------------------------------
    # every counter zeroed inside, just before its real prefill and decode
    dry_out = dryrun_phase(dev, card, train_out)
    for kname in report:
        by_path = report[kname].setdefault("launches_by_path", {})
        by_path["dryrun"] = dry_out["launches"][kname]
        report[kname]["launches"] = sum(by_path.values())
    log(f"[done] chip_smoke ran {time.perf_counter() - T_START:.0f} s")

    log(card)
    log(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
