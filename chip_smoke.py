#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or raises (any failure exits non-zero and
prints no result):

1. device: fail without CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` does;
2. build: compile the CUDA kernels of ``gtn_applications_tpu_torch/ops/csrc``
   with nvcc (one process per source, in parallel) and, beside them, the
   native graph compiler (``make -C native``), and print the times;
3. gather kernels against their plain versions at x [32, 250, 80],
   idx [32, 89] with -1 padding, at a wide S = 4096 with many
   duplicates and at ASG's force-aligned shape (x [32, 250, 80], 44
   targets a sample): the forward bitwise, the backward run twice and
   bitwise equal to itself (no atomics), within 1e-5 of its plain version,
   its route and tile (``gathers.gather_bwd_plan``) those the library's
   own plan gives;
4. CTC kernels, which read the log-probabilities by label (the gather
   moved into their emission copies), against their plain versions
   (``gather_channels_plain`` then the plain recursions) at the bench headline
   (B=32, T=250, L=44, N=80; the backward's route "block", 3 warps a
   sample), on the headline with an infeasible sample (22 labels in 11
   frames), at L=11 (S=23, the backward's route "warp") and at wider
   shapes (``CTC_WIDE``: S=241 at B=8, T=300, and S=401 at B=8, T=500, 8
   and 13 warps a sample): alpha and score within atol 1e-3 + rtol
   1e-5, grad within 1e-5, each case's routes logged (the forward's
   ``alpha_plan``: one warp at S=23, 3, 8 and 13 warps wider; the
   backward's ``grad_plan``), and alpha, score and grad bitwise equal to the
   kernels fed the gathered emissions with identity labels (the parent's
   composition, gather then the kernels), the sum by label of the grad
   (``gather_bwd``) within 1e-5 of its plain version; the headline's loss
   and logit gradients against F.ctc_loss (same 1/len-then-mean
   reduction) within 1e-3;
   4b. the CTC pair's chunk route (``ctc_score_chunked``: #1 and #2 in
   their chunk mode, a chunk of frames a call from a carried alpha and
   beta, #4 once) at B=8, T=9,728 with targets of 18 labels (S=37, the
   long recipe's widest: both kernels' block routes) and of 15 (S=31: the
   backward's warp route), and at B=32, T=8,192, S=401 (the block rings),
   each at chunks of 128 and 256, the lengths ragged with a sample of one
   frame, one ending on the first call's last frame, one on a later
   call's, one inside the first chunk and an empty target: fwd+bwd of the
   score against the plain chunk route on the card, scores within 1e-5
   relative, d lp entry by entry within 1e-5 of |p| plus the median
   nonzero |p|; against the whole-T plain versions in float64, the scores
   within 1e-5 relative and d lp no farther from them than the whole-T
   kernel route's on the same inputs (or within 1e-5); launches a call
   exactly 2 nc of #1, nc of #2 and one of #4; fwd+bwd of both routes
   (CUDA events, median of 30), their launches and peak memory, on lines
   that name the card;
5. the dense backtrace kernel against its plain walk at the ASG bench
   headline (B=32, T=250, C=80, backpointers of the ASG Viterbi scan), at
   B=8, T=1000 (a table past shared memory, walked through the same ring
   of chunks) and at odd C (B=8, T=250, C=81: odd samples start
   misaligned): paths bitwise equal, each case's chunk plan logged;
6. the dense-scan kernels against their plain versions at the STC bench
   headline (B=32, T=250, L=30, N=80, so S=96) and at S=304 (B=8, T=128,
   L=100), on STC tables and on a dense random case of the same shape in
   which every state is live and z stays far from the floor, on the S=304
   tables with a hub of in-degree 150-250 a sample, on the headline's
   tables with half of the arcs' weights 85-100 nats down (which states
   underflow is decided by the shift), and on bench.py's
   word decompositions at the 1k inventory (B=32, T=100, 15 pieces,
   S=376); the S=304 and hub cases with every state accepting, so that
   their backward meets live states; each case logs its real arcs,
   degrees and routes, and how many of its sums the FLT_MIN gate declares
   dead (positive with denormal terms kept, below FLT_MIN with them
   flushed, as JAX's devices flush them; the underflow case must have
   some): the live sets equal, the trajectory within atol 1e-3 + rtol
   1e-5 on live states, dem (with dadj and without) and dadj entry by
   entry within 1e-5 (|p| + the median nonzero |p|);
7. the factored-scan kernels against their plain versions on the bigram
   Transducer's lattices: the bench ngram-2 headline (B=32, T=250, L=44,
   N=80, blank none, so S=96), ``configs/iamdb/ngram_ctc.json``'s IAM width
   (79 graphemes and an optional blank, no repeats, S=136), the forced
   blank (S=136), a random case with every state live and z far from the
   floor (S=96, 9,216 arcs a sample), the same at S=160 (B=8, T=64), whose
   arcs fit in no block's shared memory, an IAM-like line of L=100 (B=8,
   T=128, S=304) whose emission rows stream through a ring, the headline
   with each label's weights from most sources 85-110 nats below its
   shift (which states underflow is decided by the TPU's per-label shift)
   and a batch of 5; each case logs its real arcs, largest in- and
   out-degree, the routes that carried them (registers, shared or
   global; emission rows staged or in the ring) and the sums the FLT_MIN
   gate declares dead (the underflow case must have some): the live sets
   equal, the
   trajectory within atol 1e-3 + rtol 1e-5 on live states, dem, dadj,
   dwsel and dws entry by entry within 1e-5 (|p| + the median nonzero
   |p|), with dadj and without;
8. the whole-scan Viterbi kernel against its plain versions, the scan
   alone and the decode (the scan and its walk in one launch, held to
   ``viterbi_backtrace_plain`` on the plain scan's slots), at the decode
   headline (B=32, T=250, C=80 on the ngram-2 decode table with random
   weights: 82 states, 6,480 arcs, D=81; lengths 200-250) by each of the
   scan's routes (arcs in registers, staged in shared memory, read from
   global memory) and each walk beside it (the walk words in shared
   memory, or in a global scratch walked by chunks), on the bigram table
   over 160 labels (B=8; D=161, S=162: 25,760 arcs staged in shared
   memory), over 240 labels (B=4; 57,840 arcs, past shared memory: read
   from global memory), on the headline table over T=720 frames (B=8:
   the walk words fit only in the global scratch), on a skewed random
   table with an infeasible sample, and on the headline table with
   integer weights and emissions (exact ties required), also with two
   arcs a lane so that every state is a hub of two warp chunks (ties
   across them required): slots and labels bitwise equal, final alphas
   and scores within 1e-6; each case logs its routes;
9. the sparse kernels (seg_lse on each round of a table's start closure,
   the whole sparse scan on the table) against their plain versions run
   in float64, at bench.py's loaded backoff-LM protocol (its normaliser,
   S=1,004, A=6,618, E=1,183, and its composed union tables; B=32, T=100,
   N=1,001), on the backoff paths' per-sample trigram and 4-gram tables
   (T=300; the 4-gram normaliser's backward state, 250 KB, lives in global
   scratch at one block a sample), on an all-live random table, on STC's
   depth-0 union table and on a table past shared memory; the whole-scan
   pair at its batch's cluster size (the most blocks a sample, of 1, 2, 4
   and 8, with B k blocks on the card) and, on the 1kwp normaliser, the
   4-gram normaliser, the table past shared memory and a batch of 5, at
   every cluster size (one that does not fit must raise at launch):
   values within atol 1e-3 + rtol 1e-5 on live states
   (the scan's trajectory: within 80 nats of the frame's best), the
   cotangents (dalpha, dcontrib; dem, dw, deps, dalpha0) entry by entry
   within 1e-5 (|p| + the median nonzero |p|); seg_lse also on a
   synthetic step past every lane schedule of its kernels (B=32, S=3,000:
   hubs of 4,500 and 400 in-arcs and of 4,300 and 700 out-arcs, empty
   destinations, dead sources, endpoints outside [0, S)) with src/dst, w
   and em each shared or per sample (em also absent), and with every
   state dead; each seg_lse kernel runs twice and must agree with itself
   bitwise;
10. the backoff factorings (``ops/factored.py``; no kernel of ours: loops
   of PyTorch products and elementwise ops a frame), each held to the
   composed route (the sparse kernels) on the card, the loss within
   5e-4 max(1, |loss|) and every gradient entry within 5e-4 + 1e-3 |g|:
   (a) the trigram main path's first batch (the loader's, logits of its
   TDS2d at the seeded initial weights, N(0, 0.3) transitions) through
   the dense variant (``GTN_TRANSDUCER_FACTORED=on``: none of our kernels
   launched) against ``off`` (composed), the factored loss on the card
   against the CPU within 1e-4 relative; (b) bench.py's 1kwp protocol
   (B=32, T=100, N=1,001, S_c=1,004) through the dst variant's three
   tiers, exp-linear with the low-rank closure, exp-linear with the dense
   closure (``GTN_FACTORED_VJP=auto``) and the staged form (``off``),
   against ``off``; (c) the destination-factored decode on a 200-token
   bigram (S_c * N > 2^15; B=8, T=100) against the composed decode
   (``viterbi_batch``), labels equal, and on the 1kwp LM, the card's
   decode of the batch against the CPU's on 4 samples, labels equal and
   scores within 1e-4 relative.  It prints, each line with the card's
   name and power limit, the trigram train step under off and on (host
   clock, median of 20, and of 3 under on, whose step takes seconds) and
   its peak memory, the loss fwd+bwd of each route (CUDA events, median of
   10 and 2 for the trigram, 30 for the 1kwp's composed route and 10 for
   its dst tiers), the kernels one call
   launches (torch.profiler) and its peak memory, and the 1kwp decode of
   one batch;
11. seg_max, the per-step decode's tropical step, against its plain
   version: on the epsilon-removed decode table of the unpruned grapheme
   4-gram over the long-line texts (S=1,058, A=35,455, a hub of in-degree
   1,057, C=12; shared, by label, B=32, alpha with NEG states), on a
   per-sample random table, on fields of mixed batch dims, on integer
   inputs with exact ties (at the hub too) and on a table with padding arcs
   and dead destinations: values bitwise, winning arcs exactly; then
   seg_max_scan, the whole tropical scan and its backtrace in one launch,
   against its plain version (T seg_max steps and the walk) on that table
   (B=32, T=300, ragged lengths, one infeasible sample), on a batch of 5
   and on the table with integer weights and emissions (T=100, exact ties
   at the hub required), at every cluster size (one that does not fit
   must raise at launch): backarcs, final alpha and labels bitwise, scores
   within 1e-6; and the routed decode (``viterbi_batch``: one seg_max_scan
   launch) at B=32, T=300 on the card against the CPU route: labels
   bitwise, scores within 1e-6;
12. seventeen main paths, CTC, ASG, STC, the Transducer and the Transducer
   with a loaded backoff LM, the grapheme trigram and the 4-gram, CTC on
   the RNN and TDS encoders and on TDS2d computing in bf16, long-sequence
   CTC (``configs/synthetic/long_ctx_assoc.json`` as shipped: "assoc",
   chunk 256, 4,096-9,728 frames, whose emission gather runs the gather
   pair; and under "auto", which routes it to the chunked CTC kernels),
   the speech recipe's TDS (``configs/librispeech/tds.json``'s model and
   criterion on synthetic tones through the mel spectrogram), and CTC
   over wordpieces: ``configs/iamdb/word_pieces.json`` (TDS2d, batch 32,
   100 pieces) on the synthetic lines and ``convtrans.json`` as shipped
   (``TDS2dTransducer``: TDS2d, the WFST convolution ``ConvTransduce1D``
   over 200 pieces, kernel 7, stride 4, TDS2d; batch 8, 1,000 pieces) on
   the long lines (its convolution takes the direct route there: the
   inner pieces have at most 4 graphemes, S = 9, so the widest batch's
   emissions are 61.3 M entries, under the V-chunk threshold of 64 M);
   the word-decomposition Transducer (no transitions, blank optional, no
   repeats, ``prepend_wordsep``: each line's lattice marginalises over its
   decompositions into 1,000 pieces, N = 1,001 outputs, scored by the
   dense scan) as ``configs/iamdb/word_decomps.json`` ships it (TDS2d
   4/16/32/64 channels at a time stride of 16, batch 32) on the long
   lines (256-608 frames for at most 19 graphemes a line, so no line is
   too short for its targets; S = 56-80) and as
   ``configs/librispeech/word_decomps.json`` ships it (TDS 4/8/16 channels
   x 5 blocks over 80 mel bins, batch 32) on synthetic tones, both over
   ``convtrans``'s 1,000-piece tokens (the inventory keeps every single
   grapheme, so every line decomposes; a line too short for its pieces
   would make the loss infinite, which the finite-loss check refuses);
   and ``configs/iamdb/tds2d_words.json`` (CTC on tds2d.json's TDS2d,
   strides [2, 1] in its last two groups, batch 128, lr 0.5,
   max_grad_norm 10) on the synthetic lines, which keep ``use_words`` as
   a flag and have no word images: its 64 lines make one batch an epoch,
   and its timed step takes the config's 128 (the lines twice); the WSJ
   twins of the speech configs run only in the CPU tests;
   their token and lexicon files, which the repository does
   not hold, trained first by the port's ``scripts/wordpiece.py`` on
   6,000 synthetic lines and written by ``make_wordpieces.save_pieces``:
   ``train.train`` of the port for ``EPOCHS`` (1 epoch, 2 for the
   recipe paths and ctc_long_assoc; 64 synthetic samples, batch 32: 2
   steps an epoch plus validation) with the model and criterion sections of
   configs/iamdb/tds2d.json, tds2d_asg.json, tds2d_stc.json, ngram_ctc.json,
   pruned_ngram_ctc.json, rnn.json, tds.json, tds2d.json, word_pieces.json
   and convtrans.json unchanged
   (the backoff paths on the long-line corpus, their transitions the
   grapheme trigram of the recipe's settings and the unpruned 4-gram,
   built into build/), but for ``CONFIG_EDITS`` (rnn.json, which has no
   ``optim.step_size``, takes the other IAM configs' 100; the bf16 path
   adds ``"dtype": "bfloat16"``; their other data keys as shipped), then
   ``test.run_test`` on
   the checkpoint (the long paths read their config's own 8 samples a
   split); the launch counters are zeroed just before each path
   and read just after: each kernel of the path must have launched once
   per train step (backward kernels) or once per train step and per
   evaluation batch (forward kernels and the decode's, which every batch
   reaches), the backoff paths' sparse kernels exactly as often as their
   tables' closure depths say, their decode's kernel exactly once per
   decoded batch (the trigram's whole-scan Viterbi, the 4-gram's
   seg_max_scan; seg_max never), the word decompositions' dense pair and
   ctc_words' CTC kernels exactly once a step and a batch, and no kernel
   of another path at all;
13. the trainer's first batch of each path through its trained model: for
   CTC the logits on the card against the CPU within 1e-3; the loss and
   the logit gradient (and ASG's and the Transducer's transitions
   gradient) on the card against the CPU on the same logits (CTC 1e-4 and
   1e-6, or the logit gradient within the CPU's own float32 error against
   its plain recursion in float64 where that is larger; the others 1e-4
   and 1e-5; the backoff paths against the CPU in
   float64, loss 1e-4, gradients 1e-3 of their largest entry, the 4-gram
   on the batch's first 8 samples and 96 frames); the path's kernels
   against their plain versions on the inputs the train step and the
   decode give them, at the tolerances of phases 3-9 and 11; and the 4-gram's
   decode of the first validation batch on the card (one seg_max_scan
   launch) against the CPU route, labels exactly; the bf16 path's first
   batch through its trained model in bf16 and in fp32 at the same
   weights: logits fp32, their max |d| within 0.3 (JAX's own gap at this
   width, ``BF16_LOGITS_TOL``) and the CTC loss's relative gap within 1e-2,
   printed with the card's name and power limit; the wordpiece paths as
   CTC's (convtrans's logits through the whole model), and convtrans's
   ``ConvTransduce1D`` on its first encoder's output on the card against
   the CPU, by the route the batch takes and by the V-chunked one: scores
   within 1e-5 + 1e-5 |s|, the input's gradient for a seeded cotangent
   within 1e-5 + 1e-4 |g| (each 1e-5, or the CPU's own float32 error
   against the layer in float64 where that is larger), and the two routes
   on the card within 1e-5 + 1e-5 |s| and 1e-5 + 1e-4 |g| of each other;
   ctc_words as CTC's; the word decompositions: loss and logit gradient
   on the card against the CPU (1e-4, 1e-5) and the dense pair on the
   batch's em_state and adj, the backward within 1e-5 or, where larger,
   twice the float32 plain version's own error on dem against float64
   (over T = 576 frames each float32 backward lies ~1e-5 from float64);
14. times: CUDA-event medians of 30 runs after warm-up at the phase 4-9 and 11
   headline shapes for each kernel, its plain version and the one
   PyTorch call that computes it where there is one (F.ctc_loss for the
   CTC pair, torch.gather and scatter_add_ for the gather pair; the
   sparse kernels also on the 1kwp composed tables and the main paths'
   trigram and 4-gram tables, seg_lse on the first round of each table's
   start closure, with the whole step, wrapper included, forward and
   forward and backward, and the kernels it launches by torch.profiler;
   the seg_lse forward also by its other route, alpha, w and em staged in
   shared memory or gathered, and without its statistics), the
   host-clock median of 10 full train
   steps of each path (after 3, or 2 for ``SLOW_STEP_PATHS``, whose steps take
   most of a second; a line each with the card's name and power
   limit) and of 5 decodes of the 4-gram path's first batch
   (and seg_max_scan alone, there and at phase 11's T=300 case),
   the CTC pair also at ``CTC_WIDE`` (with chain bounds) and the
   backward's kernels a call (torch.profiler), the CTC Function
   (``ctc_score_kernel``, wrapper included) forward and forward and
   backward from the log-probabilities beside F.ctc_loss, with its kernels
   a call (torch.profiler), the forward also as the gather and ``ctc_alpha``
   on the gathered emissions (two launches), the gather backward also at
   the wide and ASG shapes, the gather forward also at ASG's, and an empty
   kernel (``launch_probe``: the launch floor), the dense backtrace also
   at B=8, T=1000 and at odd C (chain bounds of T-1 walk frames), the
   whole-scan Viterbi's scan alone and its decode
   in turns (the walk's share is their difference) with the kernels a
   decode (torch.profiler),
   the latency of one frame of the CTC recursion's dependent chain
   (``ctc_chain_probe``), of one frame of the walks of the decode and the
   dense backtrace (``backtrace_chain_probe``: a dependent shared load of
   a word and its unpacking) and of one phase of the sparse scans' chain
   (``sparse_scan_probe``: a load from another block's shared memory and
   a cluster barrier, at the 1kwp normaliser's and at the decode's batch
   and cluster size) and of one frame of the whole-scan Viterbi's chain
   (``viterbi_chain_probe``: a dependent shared-memory load and a block
   barrier, at the headline's batch and block size) for those kernels'
   chain bounds, ``seg_max_scan`` on the Viterbi headline's table as a
   yardstick for the whole-scan Viterbi, and of one frame of the factored
   scans' chain (``factored_chain_probe``: a dependent shared-memory load,
   one expf and one logf and a block barrier, at the kernels' block size)
   for their chain bound, with the kernels one call of the factored pair
   launches (torch.profiler) and their bound recounted by real arcs
   (``factored_work``, the dense-row count beside it); the dense pair at
   the STC headline, S=304 and the word decompositions, with dadj and
   without, its kernels a call, its bound by real arcs (``dense_work``,
   the O(S^2) count of PRs 2-10 beside it) and its chain bound (the probe
   at the forward's and the chain's block sizes); and the device
   time and kernel launches (torch.profiler) of the Transducer's
   ``dense_ngram_norm`` forward and backward at its main path's batch
   shape; and ``ConvTransduce1D``'s forward and forward+backward on the
   convtrans train step's batch (CUDA events, median of 10) by the route
   that batch takes and by the other, with the taken route's share of
   the step, on a line with the card's name and power limit; for the
   three recipe paths (``recipe_costs``) the host's ``prepare`` of the
   batch (first call and warm median of 10), the train step's peak
   memory, and for the word decompositions the einsum before the dense
   scan (``ops/factored.py``, TF32 off; forward and forward+backward
   against its bound) and the dense pair at the batch's shapes; the
   chain bound of a one-step kernel (seg_lse's pair, seg_max) is an empty
   launch (``launch_probe``).

15. distributed (``phase_distributed``, after the main paths, the kernels
   built before any spawn): ``dryrun.dryrun_multichip(2)``, two gloo ranks
   sharing the card (NCCL refuses two ranks on one device), each leg
   (ctc, asg, stc, transducer_ngram, transducer_plain, tds2d_transducer,
   the loaded backoff LM, the seq-parallel assoc CTC on a 1 x 2 grid)
   against its one-process step on the card, loss within 1e-5 relative,
   each rank's parameters after the step and the seq leg's gradient
   within rtol 1e-4 / atol 1e-5; the ctc path's
   model at tds2d.json's widths (dropout 0) on a global batch of 32, two
   ranks of 16, 3 steps, against one process on the same batches in the
   ranks' row blocks (losses 1e-5 relative, every parameter rtol 1e-4 /
   atol 1e-5; cuDNN deterministic) and on the whole batch (step 1 only:
   later steps amplify the rounding of other convolution shapes), the
   host-clock step times and the gradient reduction's share, on a line
   with the card's name and power limit; NCCL collectives in a world of
   one, then one epoch of the ctc path through ``train.main``'s
   rendezvous flags over NCCL, its history equal to the plain run's;
   both examples at their shipped epochs, their final validation CER.
   The ranks' and runs' kernel launches join the ``kernels`` line's.
   ``python3 chip_smoke.py --only distributed`` runs phases 1, 2 and 15
   alone and prints no result line.
16. sequence parallelism (``phase_seq_parallel``, after phase 15): leg (a)
   ``configs/synthetic/long_ctx_assoc.json`` as shipped (``seq_parallel``
   4, "assoc" CTC, chunk 256, T = 8,192-9,216) through ``train.train`` on
   four gloo ranks sharing the card, each holding a quarter of the frames
   through TDS2d and composing its own CTC operators, against one
   process: every epoch's losses, error rates and the parameters after
   the last step; leg (b) ``configs/iamdb/tds2d.json``'s full-width model
   (dropout 0, CTC "auto") on a 1 x 2 grid, 3 steps on the distributed
   phase's batches padded to a width that 8 divides, the logits gathered
   along time for the CTC kernels, against one process (step 1's loss and
   update distance tightly, the later steps to float32 rounding's bound).
   Each leg's rank step and one process's (host clock), the halo,
   statistics, gather and gradient collectives a step and the peak
   ``max_memory_allocated`` a rank and in one process, on lines with the
   card's name and power limit.  The ranks' and runs' launches join the
   ``kernels`` line's.  ``python3 chip_smoke.py --only seq`` runs phases 1,
   2 and 16 alone and prints no result line.
17. JAX's route switches (``phase_routes``, after phase 16), each on a
   path's first batch (at the path's seeded initial weights) against the
   default route on the card: STC under ``GTN_STC_DENSE=off`` (its sparse
   tier: one whole sparse scan forward and backward) against the dense
   route (loss 1e-4, logit gradient 1e-5), the sparse pair held on its
   table; the grapheme trigram under ``GTN_SPARSE_SCAN=step`` (the gather
   pair, then each frame a seg_lse launch and one a closure round,
   forward and backward, counted exactly) against the whole scan (loss
   within 1e-4 and each gradient within 1e-3 of its largest entry, or the
   CPU's own float32 error against float64 where larger), seg_lse held
   on two frames of each table (its backward within 1e-5 entrywise, or
   the float32 plain version's own error where larger); its decode under
   ``GTN_VITERBI_SCAN=step`` (T seg_max launches and the walk) against
   the whole-scan Viterbi, labels equal, and seg_max bitwise against its
   plain version on every frame; each route's fwd+bwd or decode on the
   host clock.  Their launches join the ``kernels`` line's.  ``python3
   chip_smoke.py --only routes`` runs phases 1, 2 and 17 alone and prints
   no result line.

Each phase prints its seconds on a line of its own (``phase NAME: S s``).
Output: the nvidia-smi line, a ``{"timing": ...}`` line, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
"""

import contextlib
import functools
import json
import math
import statistics
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 (non-tensor) op/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations per live state and frame: lse3 (3 max, 3 sub, 3 exp,
# 2 add, floor max, log, add) plus the emission add; the backward adds the
# posterior (add, sub, min, exp, mul) and eb = em + beta
ALPHA_OPS = 15
GRAD_OPS = 21
# fp32 operations per state and frame of the dense scan besides its S x S
# products: forward max, sub, exp, log, floor, two adds and the masks; the
# backward also the dz division and the g product
DENSE_FWD_OPS = 8
DENSE_BWD_OPS = 10

B, T, L, N = 32, 250, 44, 80
BLANK = N - 1


def log(msg):
    print(msg, flush=True)


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gpu_median_ms(torch, fn, runs=30, warmup=5):
    """Median device time of ``fn`` over ``runs`` calls.  A spin kernel
    keeps the device busy while the host queues all the calls between
    their event pairs, so a call's time is its device time, not the host's
    launch overhead, unless the host queues slower than the spin lasts."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(runs)
    ]
    torch.cuda._sleep(200_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def phase_device(torch):
    from gtn_applications_tpu_torch import utils

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no GPU")
    card = utils.card_name_and_power_limit()
    log(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


def phase_build():
    """nvcc for the kernels and make for the native graph compiler (which
    the Transducer's host compilation calls), side by side."""
    import threading

    from gtn_applications_tpu_torch.ops import _build
    from gtn_applications_tpu_torch.wfst import native

    native_s, failure = [], []

    def build_native():
        t0 = time.perf_counter()
        try:
            native.load_library()
        except Exception as exc:  # re-raised below, in this thread
            failure.append(exc)
        native_s.append(time.perf_counter() - t0)

    worker = threading.Thread(target=build_native)
    worker.start()
    _build.load_library("gather")
    worker.join()
    if failure:
        raise failure[0]
    log(f"build: {_build.build_seconds:.1f} s (nvcc, {len(_build.SOURCES)} sources), "
        f"native graph compiler {native_s[0]:.1f} s")
    return _build.build_seconds


def _gather_case(torch, dev, b, t, c, s, seed, targets=False):
    """x [b, t, c], idx [b, s] and g [b, t, s]: CTC-like indices (every even
    column one channel, a tenth -1) or, with ``targets``, ASG's force-aligned
    ones (targets over all c channels, padded with 0, no -1)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, t, c)).astype(np.float32)).to(dev)
    idx = rng.integers(0, c, (b, s)).astype(np.int32)
    if not targets:
        idx[:, 0::2] = c - 1  # every even column repeats one channel, as blanks do
        idx[rng.random((b, s)) < 0.1] = -1
    g = rng.random((b, t, s)).astype(np.float32)
    g /= g.sum(-1, keepdims=True)  # rows sum to 1, as CTC posteriors do
    return x, torch.from_numpy(idx).to(dev), torch.from_numpy(g).to(dev)


def merge_errs(errs, more):
    for key, value in more.items():
        errs[key] = max(errs.get(key, 0.0), value)
    return errs


def hold_gather_kernels(torch, x, idx, g, what):
    """Both gather kernels against their plain versions: the forward
    bitwise, the backward within 1e-5 and, run twice, bitwise equal to
    itself; its route and tile those of the library's own plan."""
    from gtn_applications_tpu_torch.ops import gathers

    C = x.shape[2]
    gathers.check_indices(idx, C)
    out = gathers.gather_fwd_cuda(x, idx)
    dx = gathers.gather_bwd_cuda(g, idx, C)
    dx_again = gathers.gather_bwd_cuda(g, idx, C)
    torch.cuda.synchronize()
    ref = gathers.gather_channels_plain(x, idx)
    err = hold_gather_bwd(torch, g, idx, C, dx, dx_again, what)
    if not torch.equal(out, ref):
        raise AssertionError(f"gather fwd differs from plain at {what}")
    log(f"gather {what}: fwd bitwise equal, bwd max|d| {err:.3g}")
    return {"gather_fwd": float((out - ref).abs().max()), "gather_bwd": err}


def hold_gather_bwd(torch, g, idx, C, dx, dx_again, what):
    """The gather backward's two results ``dx`` and ``dx_again`` on (g, idx)
    bitwise equal, within 1e-5 of its plain version; its plan the
    library's.  Returns the error."""
    from gtn_applications_tpu_torch.ops import gathers

    S = g.shape[2]
    plan = gathers.gather_bwd_plan(S, C)
    if gathers.gather_bwd_kernel_plan(S, C) != plan:
        raise AssertionError(f"gather bwd: the library's plan at S={S}, C={C} is "
                             f"{gathers.gather_bwd_kernel_plan(S, C)}, not {plan}")
    if not torch.equal(dx, dx_again):
        raise AssertionError(f"gather bwd differs from itself run to run at {what}")
    err = float((dx - gathers.gather_channels_bwd_plain(g, idx, C)).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"gather bwd max|d|={err} > 1e-5 at {what}")
    log(f"gather bwd {what}: bitwise equal run to run, route {plan[0]}, {plan[1]} frames "
        f"a tile, {plan[2]} rank warps, {plan[3]} shared bytes a block")
    return err


def emissions(torch, lp, labels):
    """em [B, T, S] = lp at each state's label, 0 where the label lies
    outside [0, C) (the kernels' rule), by the plain gather."""
    from gtn_applications_tpu_torch.ops import gathers

    C = lp.shape[2]
    return gathers.gather_channels_plain(
        lp, torch.where((labels >= 0) & (labels < C), labels, -1)).contiguous()


def identity_labels(torch, em):
    """Labels [B, S] int32 that read em [B, T, S] as it is (C = S)."""
    B, _, S = em.shape
    return torch.arange(S, dtype=torch.int32, device=em.device).expand(B, S).contiguous()


def hold_ctc_kernels(torch, lp, labels, start, accept, skip, il, g, what):
    """Both CTC kernels, reading lp by label, against their plain versions
    on the gathered emissions: alpha and score within atol 1e-3 + rtol
    1e-5, the gradient within 1e-5; alpha, score and gradient bitwise equal
    to the kernels fed the gathered emissions with identity labels (the
    parent's composition, the gather then the kernels); the gradient's sum
    by label (``gather_bwd``) held as ``hold_gather_bwd`` holds it.  Logs
    the routes (``lattice_pallas.alpha_plan``, ``grad_plan``) and the
    infeasible samples.  Returns the errors and the kernel's gradient."""
    from gtn_applications_tpu_torch.ops import gathers
    from gtn_applications_tpu_torch.ops import lattice_pallas as lp_mod
    from gtn_applications_tpu_torch.ops.semiring import DEAD, NEG

    em = emissions(torch, lp, labels)
    ident = identity_labels(torch, em)
    a_k = lp_mod.ctc_alpha_cuda(lp, labels, start, skip, il)
    a_c = lp_mod.ctc_alpha_cuda(em, ident, start, skip, il)
    a_p = lp_mod.ctc_alpha_plain(em, start, skip, il)
    torch.testing.assert_close(a_k, a_p, atol=1e-3, rtol=1e-5)
    alpha_err = float((a_k - a_p).abs()[a_p > DEAD].max())
    s_k = lp_mod._final_score(a_k[:, -1], accept)
    s_p = lp_mod._final_score(a_p[:, -1], accept)
    torch.testing.assert_close(s_k, s_p, atol=1e-3, rtol=1e-5)
    gr_k = lp_mod.ctc_grad_cuda(lp, labels, a_k, accept, skip, il, s_k, g)
    gr_c = lp_mod.ctc_grad_cuda(em, ident, a_c, accept, skip, il,
                                lp_mod._final_score(a_c[:, -1], accept), g)
    gr_p = lp_mod.ctc_grad_plain(em, a_p, accept, skip, il, s_p, g)
    C = lp.shape[2]
    dlp = gathers.gather_bwd_cuda(gr_k, labels, C)
    dlp_again = gathers.gather_bwd_cuda(gr_k, labels, C)
    torch.cuda.synchronize()
    if not (torch.equal(a_k, a_c) and torch.equal(gr_k, gr_c)):
        raise AssertionError(f"ctc {what}: the kernels reading lp by label differ from the "
                             "kernels on the gathered emissions")
    grad_err = float((gr_k - gr_p).abs().max())
    if not grad_err <= 1e-5:
        raise AssertionError(f"ctc grad max|d|={grad_err} > 1e-5 at {what}")
    clean = torch.where((labels >= 0) & (labels < C), labels, -1)
    bwd_err = hold_gather_bwd(torch, gr_k, clean, C, dlp, dlp_again, what)
    route, k, warps, ring = lp_mod.grad_plan(em.shape[2])
    f_route, f_k, f_warps, f_ring = lp_mod.alpha_plan(em.shape[2])
    log(f"ctc {what}: alpha max|d| (live states) {alpha_err:.3g}, score max|d| "
        f"{float((s_k - s_p).abs().max()):.3g}, grad max|d| {grad_err:.3g}; alpha and grad "
        f"bitwise those of the gathered composition; dlp max|d| {bwd_err:.3g} (forward route "
        f"{f_route}, K={f_k}, {f_warps} warps a sample, a ring of {f_ring} frames; backward "
        f"route {route}, K={k}, {warps} warps a sample, a ring of {ring} frames; "
        f"{int((s_p <= NEG / 2).sum())} infeasible samples)")
    return {"ctc_alpha": alpha_err, "ctc_grad": grad_err, "gather_bwd": bwd_err}, gr_k


# the gather pair's cases (B, T, C, S, targets): the CTC headline, a wide S
# with many duplicates and ASG's force-aligned shape (targets of L labels
# over its C = N channels)
GATHER_CASES = ((B, T, N, 2 * L + 1, False), (8, T, N, 4096, False), (B, T, N, L, True))


def phase_gather(torch, dev):
    errs = {}
    for *shape, targets in GATHER_CASES:
        x, idx, g = _gather_case(torch, dev, *shape, seed=shape[-1], targets=targets)
        merge_errs(errs, hold_gather_kernels(torch, x, idx, g, tuple(shape)))
    return errs


def headline_inputs(torch, dev, seed=0, b=B, t=T, l=L, infeasible=False):
    """Logits [b, t, N], targets [b, l] with repeated labels (some skips
    disallowed), target lengths over 1..l and input lengths over
    0.8 t..t; ``infeasible``: sample 2's l // 2 labels in l // 4 frames,
    which no path covers (its score is NEG)."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, t, N).astype(np.float32)
    tl = rng.randint(1, l + 1, size=b)
    tl[0], tl[1] = l, 1
    if infeasible:
        tl[2] = l // 2
    targets = np.zeros((b, l), np.int64)
    for i in range(b):
        x = rng.randint(0, N - 1, size=tl[i])
        x[1::4] = x[0::4][: len(x[1::4])]
        targets[i, : tl[i]] = x
    il = rng.randint(t * 4 // 5, t + 1, size=b)
    il[0] = t
    if infeasible:
        il[2] = l // 4
    to = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    return (to(logits, torch.float32), to(targets, torch.int64),
            to(tl, torch.int32), to(il, torch.int32))


def ctc_kernel_inputs(torch, logits, targets, tl, blank=BLANK):
    """The CTC kernels' inputs: log-probabilities [B, T, N], the states'
    labels [B, S] int32, start, accept and skip [B, S]."""
    from gtn_applications_tpu_torch.ops import lattice

    lp = torch.log_softmax(logits, dim=2).contiguous()
    labels, skip_ok = lattice.ctc_state_tables(targets, blank)
    labels = labels.to(torch.int32).contiguous()
    start, accept = lattice.ctc_start_accept(tl, labels.shape[1])
    return lp, labels, start.contiguous(), accept.contiguous(), \
        skip_ok.to(torch.float32).contiguous()


# the CTC backward's wider cases: (B, T, L), S = 2 L + 1 = 241 and 401
# (route "block", 8 and 13 warps a sample); targets of 11 labels, S = 23,
# take its warp route
CTC_WIDE = ((8, 300, 120), (8, 500, 200))
CTC_NARROW_L = 11


def ctc_case(torch, dev, b=B, t=T, l=L, seed=0, infeasible=False):
    """The CTC kernels' inputs (lp, labels, start, accept, skip, input
    lengths, g) from ``headline_inputs``; g is d(mean of -score / len) /
    d score."""
    logits, targets, tl, il = headline_inputs(torch, dev, seed, b, t, l, infeasible)
    return (*ctc_kernel_inputs(torch, logits, targets, tl), il,
            -1.0 / (b * tl.to(torch.float32)))


def phase_ctc(torch, dev):
    from gtn_applications_tpu_torch.ops import lattice

    logits, targets, tl, il = headline_inputs(torch, dev)
    lp, labels, start, accept, skip = ctc_kernel_inputs(torch, logits, targets, tl)
    g = -1.0 / (B * tl.to(torch.float32))  # d(mean of -score/len) / d score
    errs, _ = hold_ctc_kernels(torch, lp, labels, start, accept, skip, il, g,
                               (B, T, L, N))
    # an infeasible sample (its gradient is the kernels' alone: F.ctc_loss
    # gives inf there), the backward's warp route (S = 23) and wider shapes
    merge_errs(errs, hold_ctc_kernels(torch, *ctc_case(torch, dev, seed=1, infeasible=True),
                                      (B, T, L, N, "infeasible"))[0])
    merge_errs(errs, hold_ctc_kernels(torch, *ctc_case(torch, dev, l=CTC_NARROW_L, seed=4),
                                      (B, T, CTC_NARROW_L, N))[0])
    for i, (b, t, l) in enumerate(CTC_WIDE):
        merge_errs(errs, hold_ctc_kernels(torch, *ctc_case(torch, dev, b, t, l, seed=2 + i),
                                          (b, t, l, N))[0])

    # value sanity: the port's loss and logit gradients against F.ctc_loss
    x = logits.clone().requires_grad_(True)
    loss = lattice.ctc_loss(torch.log_softmax(x, 2), targets, tl, BLANK,
                            "mean", il)
    (gx,) = torch.autograd.grad(loss, x)
    y = logits.clone().requires_grad_(True)
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(y, 2).transpose(0, 1), targets, il, tl, blank=BLANK,
        reduction="mean", zero_infinity=False,
    )
    (gy,) = torch.autograd.grad(ref, y)
    d_loss = abs(float(loss.detach()) - float(ref.detach()))
    d_grad = float((gx - gy).abs().max())
    log(f"ctc loss {float(loss.detach()):.6f} vs F.ctc_loss {float(ref.detach()):.6f}: "
        f"|d| {d_loss:.3g}, logit grad max|d| {d_grad:.3g}")
    if not (d_loss <= 1e-3 and d_grad <= 1e-3):
        raise AssertionError("CTC loss disagrees with F.ctc_loss")
    return dict(errs, f_ctc_loss_abs_diff=d_loss, f_ctc_grad_max_abs_diff=d_grad)


# the chunk route's cases (B, T, L): the long recipe's widest target (L =
# 18, S = 37: two warps a sample, both kernels' block routes), L = 15 (S =
# 31: one warp, the backward's warp route) and S = 401 (13 warps and the
# block rings); each at every chunk of CTC_CHUNKS
CTC_LONG = ((8, 9728, 18), (8, 9728, 15), (32, 8192, 200))
CTC_CHUNKS = (128, 256)


def ctc_long_case(torch, dev, b, t, l, chunk, seed):
    """``headline_inputs`` at (b, t, l) with the chunk split's edge cases:
    sample 1 one frame (one label), sample 2 ending on the first call's
    last frame (1 + chunk), sample 3 on a later call's (1 + 3 chunk),
    sample 4 an empty target, sample 5 ending inside the first chunk."""
    logits, targets, tl, il = headline_inputs(torch, dev, seed, b, t, l)
    il[1], il[2], il[3], il[5] = 1, 1 + chunk, 1 + 3 * chunk, chunk // 2
    tl[2], tl[3], tl[5] = min(l, chunk // 4), min(l, chunk // 2), min(l, chunk // 8)
    tl[4] = 0
    targets[4] = 0
    return logits, targets, tl, il


def ctc_fwd_bwd(torch, fn, lp, g):
    """(score, d lp) of one forward and backward of ``fn`` from lp, the
    cotangent g [B] on the score."""
    x = lp.detach().requires_grad_(True)
    score = fn(x)
    (dlp,) = torch.autograd.grad(score, x, g)
    return score.detach(), dlp


def host_and_device_ms(torch, fn, runs=10):
    """(host-clock median ms of one call of ``fn`` ending in a synchronise,
    device ms a call: the CUDA kernels' own time by torch.profiler over
    ``runs`` calls).  Where the first is well above the second the call
    waits on the host, its launches and wrappers, not on the card."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    host = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
             for e in prof.key_averages() if str(e.device_type).endswith("CUDA"))
    return statistics.median(host), us / runs / 1e3


@contextlib.contextmanager
def plain_route():
    """Inside it the kernels' Functions take their plain versions on CUDA
    tensors too (``_build.on_cuda`` answers False): the plain reference of
    a whole route, run on the card with the card's own exp and log."""
    from gtn_applications_tpu_torch.ops import _build

    on_cuda = _build.on_cuda
    _build.on_cuda = lambda *tensors: False
    try:
        yield
    finally:
        _build.on_cuda = on_cuda


def ctc_exact(torch, lp, labels, start, accept, skip, il, g):
    """(score, d lp) of the whole-T plain versions in float64 on the card:
    the reference both float32 routes are measured against at long T,
    where the whole-T route's posterior exp(alpha + beta - score) carries
    the rounding of float32 alpha and beta of |score| ~ 10^4."""
    from gtn_applications_tpu_torch.ops import gathers
    from gtn_applications_tpu_torch.ops import lattice_pallas as lp_mod

    x = lp.double()
    em = gathers.gather_channels_plain(x, labels)
    alpha = lp_mod.ctc_alpha_plain(em, start.double(), skip, il)
    score = lp_mod._final_score(alpha[:, -1], accept.double())
    grad = lp_mod.ctc_grad_plain(em, alpha, accept.double(), skip, il, score, g.double())
    return score, gathers.gather_channels_bwd_plain(grad, labels, lp.shape[2])


def phase_ctc_chunked(torch, dev, card):
    """The CTC pair's chunk route (``ctc_score_chunked``: #1 and #2 a chunk
    at a time from a carried alpha and beta, #4 once) at ``CTC_LONG`` and
    ``CTC_CHUNKS`` against the plain chunk route (the same Function on the
    card under ``plain_route``): scores within 1e-5 relative, d lp entry
    by entry within 1e-5 of |p| plus the median nonzero |p|; and, with the
    whole-T kernel route on the same inputs, against the whole-T plain
    versions in float64 (``ctc_exact``): scores within 1e-5 relative, d lp
    no farther from float64's (the same entrywise error) than the whole-T
    route's, or within 1e-5; the launches a call exactly 2 nc of #1, nc of #2 and one of
    #4; each route's fwd+bwd (CUDA events, median of 30; host clock and the
    kernels' own device time, ``host_and_device_ms``) and peak memory."""
    from gtn_applications_tpu_torch.ops import _build
    from gtn_applications_tpu_torch.ops import lattice_pallas as lp_mod

    errs = {"ctc_alpha": 0.0, "ctc_grad": 0.0}
    rows = []
    for i, (b, t, l) in enumerate(CTC_LONG):
        for chunk in CTC_CHUNKS:
            logits, targets, tl, il = ctc_long_case(torch, dev, b, t, l, chunk, seed=30 + i)
            lp, labels, start, accept, skip = ctc_kernel_inputs(torch, logits, targets, tl)
            g = -1.0 / (b * tl.to(torch.float32).clamp(min=1))
            args = (labels, start, accept, skip, il)
            chunked = lambda x, c=chunk, a=args: lp_mod.ctc_score_chunked(x, *a, chunk=c)  # noqa: E731
            full = lambda x, a=args: lp_mod.ctc_score_kernel(x, *a)  # noqa: E731
            _build.reset_launches()
            (s_c, d_c), peak_c = with_peak(torch, lambda: ctc_fwd_bwd(torch, chunked, lp, g))
            launches = {k: v for k, v in _build.LAUNCHES.items() if v}
            nc = len(lp_mod.chunk_spans(t, chunk))
            if launches != {"ctc_alpha": 2 * nc, "ctc_grad": nc, "gather_bwd": 1}:
                raise AssertionError(f"ctc chunk route {(b, t, l, chunk)}: launches {launches}, "
                                     f"expected {2 * nc}, {nc} and 1")
            with plain_route():
                s_p, d_p = ctc_fwd_bwd(torch, chunked, lp, g)
            # the whole-T route on the same inputs (the lengths follow the chunk)
            _build.reset_launches()
            (s_w, d_w), peak_w = with_peak(torch, lambda: ctc_fwd_bwd(torch, full, lp, g))
            whole_launches = {k: v for k, v in _build.LAUNCHES.items() if v}
            whole_ms = gpu_median_ms(torch, lambda: ctc_fwd_bwd(torch, full, lp, g))
            s_x, d_x = ctc_exact(torch, lp, labels, start, accept, skip, il, g)
            rel = lambda s, r: float(((s.double() - r.double()).abs()  # noqa: E731
                                      / r.double().abs().clamp(min=1e-30)).max())
            s_err, d_err = rel(s_c, s_p), entrywise_err(torch, d_c, d_p)
            if not (s_err <= 1e-5 and d_err <= 1e-5):
                raise AssertionError(
                    f"ctc chunk route {(b, t, l, chunk)} against the plain chunk route: score "
                    f"relative {s_err:.3g}, d lp entrywise {d_err:.3g} (bounds 1e-5)")
            exact = {"chunk": (rel(s_c, s_x), entrywise_err(torch, d_c.double(), d_x)),
                     "whole": (rel(s_w, s_x), entrywise_err(torch, d_w.double(), d_x))}
            if not (exact["chunk"][0] <= 1e-5
                    and exact["chunk"][1] <= max(exact["whole"][1], 1e-5)):
                raise AssertionError(
                    f"ctc chunk route {(b, t, l, chunk)} against float64: score relative "
                    f"{exact['chunk'][0]:.3g} (bound 1e-5), d lp entrywise "
                    f"{exact['chunk'][1]:.3g} (bound: the whole-T route's "
                    f"{exact['whole'][1]:.3g}, or 1e-5)")
            errs["ctc_alpha"] = max(errs["ctc_alpha"], s_err)
            errs["ctc_grad"] = max(errs["ctc_grad"], d_err)
            ms = gpu_median_ms(torch, lambda: ctc_fwd_bwd(torch, chunked, lp, g))
            host_ms, device_ms = host_and_device_ms(torch, lambda: ctc_fwd_bwd(torch, chunked, lp, g))
            whole_host_ms, whole_device_ms = host_and_device_ms(
                torch, lambda: ctc_fwd_bwd(torch, full, lp, g))
            S = labels.shape[1]
            row = {"B": b, "T": t, "S": S, "chunk": chunk, "calls": nc,
                   "alpha_route": lp_mod.alpha_plan(S), "grad_route": lp_mod.grad_plan(S),
                   "fwd_bwd_ms": ms, "whole_fwd_bwd_ms": whole_ms,
                   "host_ms": host_ms, "device_ms": device_ms,
                   "whole_host_ms": whole_host_ms, "whole_device_ms": whole_device_ms,
                   "launches": launches, "whole_launches": whole_launches,
                   "peak_bytes": peak_c, "whole_peak_bytes": peak_w,
                   "score_rel_err_plain": s_err, "dlp_entrywise_err_plain": d_err,
                   "score_rel_err_f64": exact["chunk"][0],
                   "dlp_entrywise_err_f64": exact["chunk"][1],
                   "whole_score_rel_err_f64": exact["whole"][0],
                   "whole_dlp_entrywise_err_f64": exact["whole"][1]}
            rows.append(row)
            log(f"[{card}] ctc chunk route B={b} T={t} S={S} chunk={chunk} ({nc} calls; "
                f"forward {row['alpha_route']}, backward {row['grad_route']}): fwd+bwd "
                f"{ms:.4f} ms against the whole-T route's {whole_ms:.4f} ms (CUDA events, "
                f"median of 30; host clock {host_ms:.4f} against {whole_host_ms:.4f} ms, the "
                f"kernels' device time {device_ms:.4f} against {whole_device_ms:.4f} ms); "
                f"launches a call {launches} against {whole_launches}; peak "
                f"{peak_c / 2**20:.1f} MiB against {peak_w / 2**20:.1f} MiB; against the plain "
                f"chunk route score relative {s_err:.3g}, d lp entrywise {d_err:.3g}; against "
                f"float64 score relative {exact['chunk'][0]:.3g}, d lp entrywise "
                f"{exact['chunk'][1]:.3g} (the whole-T route's {exact['whole'][0]:.3g}, "
                f"{exact['whole'][1]:.3g})")
    return errs, rows


# ASG / STC bench headlines (bench.py): C = 80 channels for ASG (no
# replabels, no garbage); STC targets of L = 30 tokens out of 80, so
# S = 3L + 2 = 92 states bucketed to 96; S = 304 is an IAM-like line
# (L = 100), over T = 128 frames: every path through 100 tokens needs at
# least 100 frames, so at fewer the score is NEG and the backward all zero
ASG_C = 80
STC_L = 30
WIDE_STC = (8, 128, 100)  # B, T, L: S = 304


def ragged_lengths(rng, b, t):
    il = rng.randint(t * 4 // 5, t + 1, size=b)
    il[0] = t
    return il


def hold_dense_bt(torch, bp, last, what):
    """The backtrace kernel against its plain walk: paths bitwise equal."""
    from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp

    path_k = vsp.dense_backtrace_cuda(bp, last)
    path_p = vsp.dense_backtrace_plain(bp, last)
    torch.cuda.synchronize()
    if not torch.equal(path_k, path_p):
        raise AssertionError(f"dense_backtrace differs from its plain walk at {what}")
    frames, ring, chunks = vsp.dense_bt_plan(bp.shape[1] + 1, bp.shape[2])
    log(f"dense_bt {what}: paths bitwise equal (chunks of {frames} frames, a ring of {ring}, "
        f"{chunks} chunks a sample)")
    return {"dense_bt": 0.0}


def asg_headline_inputs(torch, dev, b=B, t=T, c=ASG_C, seed=1):
    """Outputs [b, t, c], transitions [c + 1, c] and input lengths; and
    the backpointers and last states of their ASG Viterbi scan."""
    from gtn_applications_tpu_torch.ops import lattice

    rng = np.random.RandomState(seed)
    out = torch.as_tensor(rng.randn(b, t, c).astype(np.float32), device=dev)
    trans = torch.as_tensor((rng.randn(c + 1, c) * 0.5).astype(np.float32),
                            device=dev)
    il = torch.as_tensor(ragged_lengths(rng, b, t), dtype=torch.int32, device=dev)
    bp, last, _ = lattice.asg_viterbi_backpointers(out, trans, il)
    return bp.contiguous(), last.contiguous()


# the dense backtrace's long and odd-C cases: B, T, C (odd C: (T-1) C is
# odd, so every odd sample starts misaligned)
DENSE_BT_MORE = ((8, 1000, ASG_C), (8, T, ASG_C + 1))


def phase_dense_bt(torch, dev):
    errs = {}
    for shape in ((B, T, ASG_C),) + DENSE_BT_MORE:
        bp, last = asg_headline_inputs(torch, dev, *shape)
        merge_errs(errs, hold_dense_bt(torch, bp, last, shape))
    return errs


def dense_scan_inputs(torch, crit, logits, prepared):
    """The dense scan's inputs as STC.loss builds them: em_state [B, T, S],
    adj [B, S, S], start, has_lab and accept [B, S]."""
    em = crit.star_channels(torch.log_softmax(logits, dim=2), prepared["select"])
    d = prepared["dense"]
    adj = d["adj0"] + math.exp(prepared["log_penalty"]) * d["adj_star"]
    em_state = torch.einsum("btn,bsn->bts", em, d["lab_oh"])
    has_lab = (d["lab_oh"].sum(-1) > 0).to(torch.float32)
    return (em_state.contiguous(), adj.contiguous(), d["start"].contiguous(),
            has_lab.contiguous(), d["accept"])


def stc_headline_inputs(torch, dev, b=B, t=T, length=STC_L, n=N, seed=2):
    from gtn_applications_tpu_torch.criterions import STC
    from gtn_applications_tpu_torch.train import to_device

    rng = np.random.RandomState(seed)
    crit = STC(0, p0=1.0, plast=0.1, thalf=100, reduction="mean", shift_targets=1)
    logits = torch.as_tensor(rng.randn(b, t, n + 1).astype(np.float32), device=dev)
    prepared = to_device(
        crit.prepare([rng.randint(0, n, size=length).tolist() for _ in range(b)]),
        dev)
    il = torch.as_tensor(ragged_lengths(rng, b, t), dtype=torch.int32, device=dev)
    return dense_scan_inputs(torch, crit, logits, prepared) + (il,)


def score_cotangent(torch, alpha, accept):
    """d sum(logsumexp(alpha + accept)) / d alpha: the cotangent the STC
    score gives the final alpha."""
    from gtn_applications_tpu_torch.ops.semiring import logsumexp

    a = alpha.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(logsumexp(a + accept, dim=1).sum(), a)
    return g.contiguous()


def dense_random_inputs(torch, dev, b, t, s, seed=3):
    """A dense-scan case in which every state is live on every frame and
    z stays far from the 1e-37 floor: every adjacency entry is at least
    0.05 / S, every state starts (start 0) and holds mass (has_lab 1), and
    the shifted e has a largest entry of 1 each frame, so z >= 0.05 / S.
    Emissions N(-4, 1), accept 0, input lengths over 4t/5..t."""
    rng = np.random.RandomState(seed)
    to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    em = to((rng.randn(b, t, s) - 4).astype(np.float32))
    adj = to((rng.uniform(0.05, 1.0, (b, s, s)) / s).astype(np.float32))
    zeros = torch.zeros(b, s, device=dev)
    il = to(ragged_lengths(rng, b, t).astype(np.int32))
    return em, adj, zeros, torch.ones(b, s, device=dev), zeros, il


def entrywise_err(torch, k, p):
    """Largest |k - p| / (|p| + m) over the entries, m the median of the
    nonzero |p|: each entry is held to its own size, and an entry near zero
    to the typical one (so no large entry sets the scale of the others)."""
    a = p.abs().double()
    nz = a[a > 0]
    m = float(nz.median()) if nz.numel() else 1.0
    return float(((k - p).abs().double() / (a + m)).max())


def _gated(raw, z):
    """Sums that are positive with denormal terms kept (``raw``) and below
    FLT_MIN with them flushed (``z``, the recursion's): dead since the
    gate, alive before it (lifted by the 1e-37 floor of the log)."""
    from gtn_applications_tpu_torch.ops import dense_scan_pallas as dsp

    return (raw > 0) & (z < dsp._TINY)


def dense_subnormal_sums(torch, traj, adj, start, has_lab, il):
    """How many (b, t, u) sums of the plain dense recursion on ``traj``, on
    applied frames of labelled states, the FLT_MIN gate declares dead:
    positive with denormal terms kept, below FLT_MIN with them flushed, as
    JAX's devices flush them."""
    from gtn_applications_tpu_torch.ops import dense_scan_pallas as dsp
    from gtn_applications_tpu_torch.ops.semiring import NEG

    prev = torch.cat([traj[:, :1], traj[:, :-1]], dim=1)  # frame t reads t - 1
    x = prev - prev.amax(dim=2, keepdim=True).clamp(min=NEG)
    e, raw = dsp._exp(x), torch.exp(x)
    e[:, 0] = raw[:, 0] = dsp._start_e(start)
    # z[b, t, u] = sum_s adj[u, s] e[t, s]
    z, raw = (torch.bmm(v, adj.transpose(1, 2)) for v in (e, raw))
    t = torch.arange(traj.shape[1], device=traj.device)
    applied = (t[None, :] < il[:, None].long()) | (t[None, :] == 0)
    hit = _gated(raw, z) & (has_lab[:, None, :] > 0) & applied[:, :, None]
    return int(hit.sum())


def hold_dense_scan_kernels(torch, em_state, adj, start, has_lab, accept, il, what,
                            all_live=False, underflow=False, floor32=False):
    """Both dense-scan kernels against their plain versions on the same
    inputs: the trajectory within atol 1e-3 + rtol 1e-5 on live states;
    dem and dadj entry by entry, |k - p| <= 1e-5 (|p| + median nonzero
    |p|); the backward without dadj gives the same dem.  With ``all_live``
    every state of every frame must be live; with ``underflow`` the FLT_MIN
    gate must declare some sums dead (``dense_subnormal_sums``).  With
    ``floor32`` the bound is 1e-5 or, where larger, twice the float32
    plain version's own entrywise error on dem against the plain version
    in float64 (from the same float32 trajectory): over hundreds of frames
    the backward's chain rounds once a frame, each float32 version lies
    ~1e-5 from float64 at T = 576, and a kernel as accurate as the plain
    version lies within twice that of it.  (dadj is not compared with
    float64: there the FLT_MIN gate decides some sums on either side of
    it, alike in both float32 versions.)"""
    from gtn_applications_tpu_torch.ops import dense_scan_pallas as dsp
    from gtn_applications_tpu_torch.ops.semiring import DEAD

    tr_k = dsp.dense_scan_fwd_cuda(em_state, adj, start, has_lab, il)
    tr_p = dsp.dense_scan_fwd_plain(em_state, adj, start, has_lab, il)
    subnormal = dense_subnormal_sums(torch, tr_p, adj, start, has_lab, il)
    if underflow and not subnormal:
        raise AssertionError(f"dense_scan: no sum below FLT_MIN in the underflow case {what}")
    live = tr_p > DEAD
    if not torch.equal(tr_k > DEAD, live):
        raise AssertionError(f"dense_scan_fwd: live states differ at {what}")
    if all_live and not bool(live.all()):
        raise AssertionError(f"dense_scan_fwd: dead states in the all-live case {what}")
    torch.testing.assert_close(tr_k[live], tr_p[live], atol=1e-3, rtol=1e-5)
    fwd_err = float((tr_k[live] - tr_p[live]).abs().max())
    g = score_cotangent(torch, tr_p[:, -1], accept)
    dem_k, dadj_k = dsp.dense_scan_bwd_cuda(tr_p, adj, start, has_lab, il, g)
    dem_p, dadj_p = dsp.dense_scan_bwd_plain(tr_p, adj, start, has_lab, il, g)
    dem_only, none = dsp.dense_scan_bwd_cuda(tr_p, adj, start, has_lab, il, g,
                                            need_dadj=False)
    tol = 1e-5
    if floor32:
        dem64, _ = dsp.dense_scan_bwd_plain(
            *(x.double() for x in (tr_p, adj, start, has_lab)), il, g.double(),
            need_dadj=False)
        own = entrywise_err(torch, dem_p, dem64)
        tol = max(tol, 2 * own)
        log(f"dense_scan_bwd dem at {what}: against float64, the float32 plain version's "
            f"entrywise error {own:.3g}, the kernel's {entrywise_err(torch, dem_k, dem64):.3g}; "
            f"bound {tol:.3g}")
    torch.cuda.synchronize()
    errs, rels = {}, {}
    for name, k, p in (("dem", dem_k, dem_p), ("dadj", dadj_k, dadj_p),
                       ("dem without dadj", dem_only, dem_p)):
        # dadj of a pair with no arc can reach fp32's range (dz = g / z
        # with z at the 1e-37 floor): both versions must agree on which
        # entries overflow, and are compared on the rest
        finite = torch.isfinite(p)
        if not torch.equal(torch.isfinite(k), finite):
            raise AssertionError(f"dense_scan_bwd {name}: non-finite entries "
                                 f"differ at {what}")
        k, p = k[finite], p[finite]
        rels[name] = entrywise_err(torch, k, p)
        if not rels[name] <= tol:
            raise AssertionError(f"dense_scan_bwd {name}: entrywise error "
                                 f"{rels[name]} > {tol:.3g} at {what}")
        errs[name] = float((k - p).abs().max())
    if none is not None:
        raise AssertionError("dense_scan_bwd returned dadj without need_dadj")
    log(f"dense_scan {what}: traj max|d| (live states) {fwd_err:.3g}, entrywise "
        f"error dem {rels['dem']:.3g}, dadj {rels['dadj']:.3g} (dadj max|d| "
        f"{errs['dadj']:.3g}, largest {float(dadj_p.abs().max()):.3g}); sums below "
        f"FLT_MIN, dead: {subnormal} of {live.numel()}")
    return {"dense_scan_fwd": fwd_err,
            "dense_scan_bwd": max(errs["dem"], errs["dadj"]),
            "dense_scan_bwd_rel": max(rels.values())}


def dense_hub_inputs(torch, dev, b=WIDE_STC[0], t=WIDE_STC[1], length=WIDE_STC[2], seed=15,
                     degree=(150, 251)):
    """The S = 304 STC lattices with a hub: one labelled state a sample
    takes arcs (weights exp(N(0, 1))) from 150-250 (``degree``) random
    states, past the 32 kCap arcs a group's lanes hold in registers.
    Every state accepts (``accept_every_state``)."""
    inputs = list(stc_headline_inputs(torch, dev, b, t, length, seed=seed))
    rng = np.random.RandomState(seed)
    adj, has_lab = inputs[1].clone(), inputs[3]
    S = adj.shape[1]
    for i in range(b):
        hub = int(torch.nonzero(has_lab[i] > 0)[S // 3])
        srcs = torch.as_tensor(rng.choice(S, size=rng.randint(*degree), replace=False),
                               device=dev)
        adj[i, hub, srcs] = torch.as_tensor(np.exp(rng.randn(srcs.numel())).astype(np.float32),
                                            device=dev)
    inputs[1] = adj.contiguous()
    return accept_every_state(torch, inputs)


def accept_every_state(torch, inputs):
    """``inputs`` with every state accepting, so that the backward meets
    each state still live at the end: on the 100-label STC lattices of 128
    frames no accepting state is live then (the states that lag 88 nats
    behind the frame's best die, as on JAX's devices), and the cotangent
    would be 0."""
    inputs = list(inputs)
    inputs[4] = torch.zeros_like(inputs[4])
    return tuple(inputs)


def dense_underflow_inputs(torch, dev, b=B, t=T, length=STC_L, seed=16):
    """The STC headline's lattices with half of the arcs' weights 85-100
    nats down (adj times exp(-U(85, 100))): a destination whose arcs are
    all so scaled sums terms that are denormal or zero after the shift, so
    which states live is decided by it; emissions N(0, 0.1).  Every state
    accepts, so the backward meets every state still live at the end."""
    inputs = list(stc_headline_inputs(torch, dev, b, t, length, seed=seed))
    rng = np.random.RandomState(seed)
    adj = inputs[1].cpu().numpy().astype(np.float64)
    scale = np.where(rng.rand(*adj.shape) < 0.5, np.exp(-rng.uniform(85.0, 100.0, adj.shape)),
                     1.0)
    inputs[1] = torch.as_tensor((adj * scale).astype(np.float32), device=dev)
    em = (rng.randn(*inputs[0].shape) * 0.1).astype(np.float32)
    inputs[0] = torch.as_tensor(em, device=dev) * inputs[3][:, None, :]
    inputs[4] = torch.zeros_like(inputs[4])  # every state accepts
    return tuple(inputs)


WORD_PIECES = ROOT / "benchmarks" / "word_pieces_scores_1000.tsv"
WORD_T, WORD_PIECES_N = 100, 15  # bench.py's word-decomposition protocol


def word_decomp_inputs(torch, dev, b=B, t=WORD_T, pieces=WORD_PIECES_N, seed=0):
    """The dense scan's inputs at bench.py's word-decomposition protocol
    (``bench_word_decomps_tpu``): the 1k-wordpiece inventory, targets of
    ``pieces`` random pieces spelled in graphemes, the transitions-free
    Transducer (blank optional, no repeats) and its ``prepare``, random
    N(0, 1) logits over the 1,001 channels, log_softmax as its loss takes
    them, every frame live."""
    import random

    from gtn_applications_tpu_torch.criterions import Transducer
    from gtn_applications_tpu_torch.train import to_device

    with open(WORD_PIECES) as fid:
        tokens = sorted(line.rstrip("\n").split("\t")[0] for line in fid)
    g2i = {c: i for i, c in enumerate(sorted({c for tok in tokens for c in tok}))}
    pick = random.Random(seed)
    targets = [[g2i[c] for _ in range(pieces) for c in pick.choice(tokens)] for _ in range(b)]
    crit = Transducer(tokens, g2i, blank="optional", allow_repeats=False, reduction="mean")
    f = to_device(crit.prepare(targets), dev)["factored"]
    rng = np.random.RandomState(seed)
    logits = torch.as_tensor(rng.randn(b, t, len(tokens) + 1).astype(np.float32), device=dev)
    em_state = torch.einsum("btn,bsn->bts", torch.log_softmax(logits, dim=2), f["lab_oh"])
    has_lab = (f["lab_oh"].sum(-1) > 0).to(torch.float32)
    il = torch.full((b,), t, dtype=torch.int32, device=dev)
    return (em_state.contiguous(), f["adj_exp"].contiguous(), f["start"].contiguous(),
            has_lab.contiguous(), f["accept"], il)


def dense_routes(torch, adj, has_lab, il):
    """What the dense kernels do with a case (``dense_plan``): its real
    arcs a sample, largest in- and out-degree, the forward's rounds, warps,
    routes and emission rows, and the chain's group width, warps and
    routes."""
    from gtn_applications_tpu_torch.ops import dense_scan_pallas as dsp

    plans = dsp.dense_plan(adj, has_lab, il)
    pick = lambda key: sorted({str(p[key]) for p in plans})  # noqa: E731
    span = lambda key: [min(p[key] for p in plans), max(p[key] for p in plans)]  # noqa: E731
    return {"arcs": span("arcs"), "labelled": span("labelled"),
            "max_in_degree": max(p["max_in_degree"] for p in plans),
            "max_out_degree": max(p["max_out_degree"] for p in plans),
            "rounds": span("rounds"), "warps": span("warps"), "route": pick("route"),
            "rows": pick("rows"), "chain_group": pick("chain_group"),
            "chain_warps": span("chain_warps"), "chain_route": pick("chain_route")}


def dense_cases(torch, dev):
    """(inputs, what, all_live) of the dense kernels' checks: the STC
    headline and S = 304, each also with every state live, the hub, the
    underflow and the word decompositions."""
    cases = []
    for b, t, length in [(B, T, STC_L), WIDE_STC]:
        inputs = stc_headline_inputs(torch, dev, b, t, length)
        if (b, t, length) == WIDE_STC:
            inputs = accept_every_state(torch, inputs)
        what = (b, t, inputs[0].shape[2])
        cases.append((inputs, what, False))
        # the same shape with every state live and z far from the floor
        cases.append((dense_random_inputs(torch, dev, *what), ("all live",) + what, True))
    hub = dense_hub_inputs(torch, dev)
    cases.append((hub, ("hub",) + tuple(hub[0].shape), False))
    under = dense_underflow_inputs(torch, dev)
    cases.append((under, ("underflow",) + tuple(under[0].shape), False))
    words = word_decomp_inputs(torch, dev)
    cases.append((words, ("word decompositions",) + tuple(words[0].shape), False))
    return cases


def phase_dense_scan(torch, dev):
    errs = {}
    for inputs, what, all_live in dense_cases(torch, dev):
        log(f"dense_scan {what}: {json.dumps(dense_routes(torch, inputs[1], inputs[3], inputs[5]))}")
        merge_errs(errs, hold_dense_scan_kernels(torch, *inputs, what, all_live=all_live,
                                                 underflow=what[0] == "underflow"))
    return errs


# The bigram Transducer's lattices: bench.py's ngram-2 protocol (L = 44
# tokens out of N = 80, no blank: S = 96), ngram_ctc.json at the IAM
# width (79 graphemes and an optional blank, no repeats: S = 136) and the
# forced-blank topology (a blank between tokens: S = 136)
NGRAM_CASES = {"ngram2": dict(n=N, blank="none"),
               "iam": dict(n=N - 1, blank="optional"),
               "forced": dict(n=N, blank="forced")}


def transducer_criterion(n, blank):
    from gtn_applications_tpu_torch.criterions import Transducer

    return Transducer([(i,) for i in range(n)], {i: i for i in range(n)}, ngram=2,
                      blank=blank, allow_repeats=blank != "optional",
                      reduction="mean")


def factored_inputs(torch, crit, logits, prepared, params):
    """The factored scan's inputs as Transducer.loss builds them:
    em_state [B, T, S], adj, wsel and lab_oh, ws_state, start, and the
    accept row the final alpha meets (accept + we_state)."""
    from gtn_applications_tpu_torch.ops import factored

    f = prepared["factored"]
    ws, W, we, _ = factored.ngram_rows(params["transitions"], 2, crit.num_channels)
    lab = f["lab_oh"]
    em_state = torch.einsum("btn,bsn->bts", logits, lab)
    wsel = torch.einsum("bsn,nl->bsl", lab, W)
    ws_state = torch.einsum("n,bsn->bs", ws, lab)
    acc = f["accept"] + torch.einsum("n,bsn->bs", we, lab)
    return tuple(x.detach().contiguous() for x in (
        em_state, f["adj_exp"], wsel, lab, ws_state, f["start"], acc))


def factored_headline_inputs(torch, dev, b=B, t=T, length=L, n=N, blank="none",
                             seed=4):
    """Random logits, random transitions (N(0, 0.3)) and targets of
    ``length`` tokens through a bigram Transducer; input lengths over
    4t/5..t."""
    from gtn_applications_tpu_torch.train import to_device

    rng = np.random.RandomState(seed)
    crit = transducer_criterion(n, blank)
    C = crit.num_channels
    logits = torch.as_tensor(rng.randn(b, t, C).astype(np.float32), device=dev)
    params = {"transitions": torch.as_tensor(
        (rng.randn(crit.num_transition_arcs) * 0.3).astype(np.float32), device=dev)}
    prepared = to_device(
        crit.prepare([rng.randint(0, n, size=length).tolist() for _ in range(b)]), dev)
    il = torch.as_tensor(ragged_lengths(rng, b, t), dtype=torch.int32, device=dev)
    return factored_inputs(torch, crit, logits, prepared, params) + (il,)


def factored_random_inputs(torch, dev, b, t, s, n, seed=5):
    """A factored-scan case in which every state is live on every frame and
    z stays far from the floor: every state starts and has a random label,
    every adjacency entry is at least 0.05 / S, and the shifted exp of the
    best source is 1, so z >= 0.05 / S.  Emissions N(-4, 1), wsel and
    ws_state N(0, 0.3), accept 0, input lengths over 4t/5..t."""
    rng = np.random.RandomState(seed)
    to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    lab = np.zeros((b, s, n), np.float32)
    lab[np.arange(b)[:, None], np.arange(s)[None, :], rng.randint(0, n, (b, s))] = 1.0
    zeros = torch.zeros(b, s, device=dev)
    return (to((rng.randn(b, t, s) - 4).astype(np.float32)),
            to((rng.uniform(0.05, 1.0, (b, s, s)) / s).astype(np.float32)),
            to((rng.randn(b, s, n) * 0.3).astype(np.float32)), to(lab),
            to((rng.randn(b, s) * 0.3).astype(np.float32)), zeros, zeros,
            to(ragged_lengths(rng, b, t).astype(np.int32)))


def hold_entrywise(torch, name, k, p, what, tol=1e-5):
    """``entrywise_err`` of k against p on the entries p keeps finite (both
    must overflow alike), raising past ``tol``; returns (rel, max abs)."""
    finite = torch.isfinite(p)
    if not torch.equal(torch.isfinite(k), finite):
        raise AssertionError(f"{name}: non-finite entries differ at {what}")
    k, p = k[finite], p[finite]
    rel = entrywise_err(torch, k, p)
    if not rel <= tol:
        raise AssertionError(f"{name}: entrywise error {rel} > {tol:.3g} at {what}")
    return rel, float((k - p).abs().max()) if p.numel() else 0.0


def factored_subnormal_sums(torch, traj, adj, wsel, lab, start, il):
    """How many (b, t, u) sums of the plain factored recursion on ``traj``
    (u's column, its in-label's), on applied frames of labelled states, the
    FLT_MIN gate declares dead (``dense_subnormal_sums``)."""
    from gtn_applications_tpu_torch.ops import dense_scan_pallas as dsp
    from gtn_applications_tpu_torch.ops.semiring import NEG

    has = lab.sum(-1) > 0
    z = dsp._bmv(adj, dsp._start_e(start))
    count = int((_gated(z, z) & has).sum())
    for t in range(1, traj.shape[1]):
        v = traj[:, t - 1, :, None] + wsel
        x = v - v.amax(dim=1, keepdim=True).clamp(min=NEG)
        # the one-hot picks column l_u
        z, raw = ((torch.bmm(adj, e) * lab).sum(-1) for e in (dsp._exp(x), torch.exp(x)))
        count += int((_gated(raw, z) & has & (t < il)[:, None]).sum())
    return count


def hold_factored_scan_kernels(torch, em_state, adj, wsel, lab, ws_state, start,
                               accept, il, what, all_live=False, underflow=False):
    """Both factored-scan kernels against their plain versions on the same
    inputs: the trajectory within atol 1e-3 + rtol 1e-5 on live states;
    dem, dadj, dwsel and dws entry by entry, |k - p| <= 1e-5 (|p| + median
    nonzero |p|); the backward without dadj gives the same rest.  With
    ``all_live`` every state of every frame must be live; with
    ``underflow`` the FLT_MIN gate must declare some sums dead."""
    from gtn_applications_tpu_torch.ops import dense_scan_pallas as dsp
    from gtn_applications_tpu_torch.ops.semiring import DEAD

    tr_k = dsp.factored_scan_fwd_cuda(em_state, adj, wsel, lab, ws_state, start, il)
    tr_p = dsp.factored_scan_fwd_plain(em_state, adj, wsel, lab, ws_state, start, il)
    subnormal = factored_subnormal_sums(torch, tr_p, adj, wsel, lab, start, il)
    if underflow and not subnormal:
        raise AssertionError(f"factored_scan: no sum below FLT_MIN in the underflow "
                             f"case {what}")
    live = tr_p > DEAD
    if not torch.equal(tr_k > DEAD, live):
        raise AssertionError(f"factored_scan_fwd: live states differ at {what}")
    if all_live and not bool(live.all()):
        raise AssertionError(f"factored_scan_fwd: dead states in the all-live case {what}")
    torch.testing.assert_close(tr_k[live], tr_p[live], atol=1e-3, rtol=1e-5)
    fwd_err = float((tr_k[live] - tr_p[live]).abs().max())
    g = score_cotangent(torch, tr_p[:, -1], accept)
    args = (tr_p, adj, wsel, lab, start, il, g)
    out_k = dsp.factored_scan_bwd_cuda(*args)
    out_p = dsp.factored_scan_bwd_plain(*args)
    no_dadj = dsp.factored_scan_bwd_cuda(*args, need_dadj=False)
    torch.cuda.synchronize()
    if no_dadj[1] is not None:
        raise AssertionError("factored_scan_bwd returned dadj without need_dadj")
    rels, errs = {}, {}
    names = ("dem", "dadj", "dwsel", "dws")
    for name, k, p in zip(names, out_k, out_p):
        rels[name], errs[name] = hold_entrywise(torch, name, k, p, what)
    for name, k, p in zip(names, no_dadj, out_p):
        if k is not None:
            rels[name + " without dadj"], _ = hold_entrywise(
                torch, name + " without dadj", k, p, what)
    log(f"factored_scan {what}: traj max|d| (live states) {fwd_err:.3g}, entrywise "
        f"error dem {rels['dem']:.3g}, dadj {rels['dadj']:.3g}, dwsel "
        f"{rels['dwsel']:.3g}, dws {rels['dws']:.3g} (dwsel max|d| "
        f"{errs['dwsel']:.3g}, largest {float(out_p[2].abs().max()):.3g}); sums below "
        f"FLT_MIN, dead: {subnormal} of {live.numel()}")
    return {"factored_scan_fwd": fwd_err,
            "factored_scan_bwd": max(errs.values()),
            "factored_scan_bwd_rel": max(rels.values())}


def factored_underflow_inputs(torch, dev, b=B, t=T, seed=13):
    """The ngram-2 headline's lattices with each label's weights from most
    sources 85-110 nats below the few (60 %) that lead it, and emissions
    N(0, 0.1): after the TPU's per-label shift their exps are denormal or
    zero, so which states live is decided by that shift.  Every state
    accepts, so the backward meets every state still live at the end."""
    inputs = list(factored_headline_inputs(torch, dev, b, t, seed=seed))
    rng = np.random.RandomState(seed)
    shape = tuple(inputs[2].shape)
    lead = rng.rand(*shape) < 0.6
    wsel = np.where(lead, 0.0, -rng.uniform(85.0, 110.0, shape)).astype(np.float32)
    inputs[2] = torch.as_tensor(wsel, device=dev)
    em = (rng.randn(*inputs[0].shape) * 0.1).astype(np.float32)
    inputs[0] = torch.as_tensor(em, device=dev) * (inputs[3].sum(-1) > 0)[:, None, :]
    inputs[6] = torch.zeros_like(inputs[6])  # every state accepts: the cotangent
    return tuple(inputs)                     # reaches each live final state


def factored_routes(torch, adj, lab, il, n):
    """What the factored kernels do with a case (``factored_plan``): its
    real arcs a sample, largest in- and out-degree, the forward's routes
    and emission rows, and the chain's routes and group width."""
    from gtn_applications_tpu_torch.ops import dense_scan_pallas as dsp

    plans = dsp.factored_plan(adj, dsp.label_index(lab), il, n)
    arcs = [p["arcs"] for p in plans]
    pick = lambda key: sorted({str(p[key]) for p in plans})  # noqa: E731
    return {"arcs": [min(arcs), max(arcs)],
            "max_in_degree": max(p["max_in_degree"] for p in plans),
            "max_out_degree": max(p["max_out_degree"] for p in plans),
            "route": pick("route"), "rows": pick("rows"),
            "chain_route": pick("chain_route"), "chain_group": pick("chain_group")}


def phase_factored_scan(torch, dev):
    errs = {}
    cases = []
    for case, kw in NGRAM_CASES.items():
        inputs = factored_headline_inputs(torch, dev, **kw)
        cases.append((inputs, (case, B, T, inputs[0].shape[2], kw["n"]), False))
    s = cases[0][0][0].shape[2]
    cases.append((factored_random_inputs(torch, dev, B, T, s, N),
                  ("all live", B, T, s, N), True))
    # every state live at S = 160: its arcs (25,600 a sample) fit in no
    # block's shared memory, so both kernels read them from global memory
    cases.append((factored_random_inputs(torch, dev, 8, 64, 160, N),
                  ("all live, global", 8, 64, 160, N), True))
    # an IAM-like line of L = 100 (S = 304): the emission rows stream
    # through the ring, the label columns through shared memory
    wide = factored_headline_inputs(torch, dev, *WIDE_STC, **NGRAM_CASES["iam"])
    cases.append((wide, ("S = 304",) + WIDE_STC[:2] + (wide[0].shape[2], N), False))
    # the TPU's per-label shift decides which states underflow
    cases.append((factored_underflow_inputs(torch, dev), ("underflow", B, T, s, N), False))
    # a batch of 5
    five = factored_headline_inputs(torch, dev, b=5, seed=14)
    cases.append((five, ("batch of 5", 5, T, s, N), False))
    for inputs, what, all_live in cases:
        routes = factored_routes(torch, inputs[1], inputs[3], inputs[7], inputs[2].shape[2])
        log(f"factored_scan {what}: {json.dumps(routes)}")
        merge_errs(errs, hold_factored_scan_kernels(torch, *inputs, what, all_live=all_live,
                                                    underflow=what[0] == "underflow"))
    return errs


def viterbi_headline_inputs(torch, dev, b=B, t=T, n=N, seed=6, integer=False,
                            with_table=False):
    """Logits [b, t, n] and the decode plan of the ngram-2 transition graph
    over n labels with N(0, 0.5) weights (n + 2 states, n + n^2 arcs,
    D = n + 1), as Transducer.viterbi builds it; lengths over 4t/5..t.
    With ``integer``, weights and logits are integers in [-1, 1], so that
    contributions tie exactly; ``with_table`` also returns the decode
    table (CPU tensors)."""
    from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp
    from gtn_applications_tpu_torch.wfst import compile as wcompile

    rng = np.random.RandomState(seed)
    crit = transducer_criterion(n, "none")
    w = (rng.randint(-1, 2, crit.num_transition_arcs) if integer
         else rng.randn(crit.num_transition_arcs) * 0.5).astype(np.float32)
    table = wcompile.apply_decode_weights(
        wcompile.build_decode_template(crit.transitions), w)
    plan = vsp.build_plan(table)
    x = rng.randint(-1, 2, (b, t, n)) if integer else rng.randn(b, t, n)
    em = torch.as_tensor(x.astype(np.float32), device=dev)
    il = torch.as_tensor(ragged_lengths(rng, b, t), dtype=torch.int32, device=dev)
    return (em,) + plan.to(dev) + (il,) + ((table,) if with_table else ())


def viterbi_skewed_inputs(torch, dev, b=B, t=T, s=40, a=400, c=N, seed=7):
    """A random table whose in-degree is skewed (a quarter of the random
    arcs enter state 0: D about 2.5 times the mean in-degree) over a chain
    0 -> s-1; no arc runs from 0 to s-1, so sample 1, of length 1, has no
    accepting path."""
    from gtn_applications_tpu_torch.ops import sparse
    from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp
    from gtn_applications_tpu_torch.ops.semiring import NEG

    rng = np.random.RandomState(seed)
    src, dst = list(range(s - 1)), list(range(1, s))
    while len(src) < a:
        u = int(rng.randint(0, s))
        v = 0 if rng.rand() < 0.25 else int(rng.randint(0, s))
        if (u, v) != (0, s - 1):
            src.append(u)
            dst.append(v)
    start = np.full((s,), NEG, np.float32)
    start[0] = 0.0
    accept = np.full((s,), NEG, np.float32)
    accept[s - 1] = 0.0
    as_t = lambda x, dt: torch.from_numpy(np.asarray(x, dt))  # noqa: E731
    z = torch.zeros(0, dtype=torch.int32)
    table = sparse.ArcTable(
        as_t(src, np.int32), as_t(dst, np.int32),
        as_t(rng.randint(0, c, len(src)), np.int32),
        as_t(rng.randn(len(src)) * 0.5, np.float32), as_t(start, np.float32),
        as_t(accept, np.float32), z, z, torch.zeros(0), eps_depth=0)
    plan = vsp.build_plan(table)
    em = torch.as_tensor(rng.randn(b, t, c).astype(np.float32), device=dev)
    il = ragged_lengths(rng, b, t)
    il[1] = 1
    return (em,) + plan.to(dev) + (torch.as_tensor(il, dtype=torch.int32, device=dev),)


def viterbi_ties(torch, em, src_b, lab_b, w_b, start, il, span=None):
    """(states tied, tied across chunks) over the live frames of the plain
    scan: states above NEG whose maximum several slots attain, and those
    whose tied slots lie in different chunks of ``span`` slots (a hub's
    warps)."""
    from gtn_applications_tpu_torch.ops.semiring import NEG

    alpha = start[None].expand(em.shape[0], -1)
    src, lab = src_b.long(), lab_b.long()
    ties = across = 0
    for t in range(int(il.max())):
        contrib = (alpha[:, src] + w_b) + em[:, t][:, lab]
        best = contrib.max(dim=1, keepdim=True).values
        hit = (contrib == best) & (best > NEG) & (t < il)[:, None, None]
        many = hit.sum(dim=1) > 1
        ties += int(many.sum())
        if span:
            d = torch.arange(src.shape[0], device=em.device)[None, :, None] // span
            lo = torch.where(hit, d, src.shape[0]).min(dim=1).values
            hi = torch.where(hit, d, -1).max(dim=1).values
            across += int((many & (lo != hi)).sum())
        alpha = torch.where((t < il)[:, None], torch.clamp(best[:, 0], min=NEG), alpha)
    return ties, across


def hold_viterbi_kernels(torch, em, src_b, lab_b, w_b, start, accept, il, what,
                         routes=(None,), cap=None, packed=None, need_ties=False,
                         walks=(None,)):
    """The whole-scan Viterbi kernel against its plain versions on the
    same inputs: the scan alone by each of ``routes`` (None: its own
    choice), and the decode (the scan and its walk in one launch) by each
    of those routes that has room for a walk, with each of ``walks`` that
    fits beside it (None: its own choice): slots and labels bitwise equal,
    final alphas and scores within 1e-6 (labels and scores against
    ``viterbi_backtrace_plain`` on the plain scan's slots).  ``packed``:
    default the buckets packed with ``cap`` arcs a lane at most;
    ``need_ties``: the plain scan must meet exact ties (and, with hubs,
    ties across a hub's chunks)."""
    from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp
    from gtn_applications_tpu_torch.ops.semiring import NEG

    if packed is None:
        packed = vsp.pack_buckets(src_b, lab_b, w_b, cap).to(em.device)
    S, T, C = start.shape[0], em.shape[1], em.shape[2]
    slots_p, final_p = vsp.viterbi_scan_fwd_plain(em, src_b, lab_b, w_b, start, il)
    lab_p, score_p = vsp.viterbi_backtrace_plain(slots_p, final_p, accept, src_b, lab_b)

    def hold(outs, where):
        torch.cuda.synchronize()
        if not torch.equal(outs[0], slots_p):
            raise AssertionError(f"viterbi_scan_fwd: slots differ from plain at {what}, {where}")
        err = float((outs[1] - final_p).abs().max())
        if not err <= 1e-6:
            raise AssertionError(f"viterbi_scan_fwd: final alpha max|d| {err} at {what}, {where}")
        if len(outs) == 2:
            return err, 0.0
        if not torch.equal(outs[2], lab_p):
            raise AssertionError(f"viterbi_backtrace: labels differ from plain at {what}, {where}")
        bt = float((outs[3] - score_p).abs().max())
        if not bt <= 1e-6:
            raise AssertionError(f"viterbi_backtrace: score max|d| {bt} at {what}, {where}")
        return err, bt

    fwd_err = bt_err = 0.0
    taken, decoded = [], []
    for route in routes:
        taken.append(route or vsp.scan_route(packed, S, C))
        fwd_err = max(fwd_err, hold(vsp.viterbi_scan_fwd_cuda(
            em, src_b, lab_b, w_b, start, il, packed=packed, route=route),
            f"route {taken[-1]}")[0])
        r = route or vsp.scan_route(packed, S, C, vsp.WALKS[-1], T)
        if not vsp.route_fits(packed, S, C, r, vsp.WALKS[-1], T):
            continue  # no room for a walk beside this route
        for walk in walks:
            w = walk or vsp.walk_route(packed, S, T, C, r)
            if not vsp.route_fits(packed, S, C, r, w, T):
                continue
            errs = hold(vsp.viterbi_scan_fwd_cuda(em, src_b, lab_b, w_b, start, il,
                                                  packed=packed, route=route, accept=accept,
                                                  walk=walk), f"decode {r}, walk {w}")
            fwd_err, bt_err = max(fwd_err, errs[0]), max(bt_err, errs[1])
            decoded.append(f"{r}/walk {w}")
    if not decoded:
        raise AssertionError(f"viterbi: no decode route fits {what}")
    ties = ""
    if need_ties:
        span = vsp.WARP * packed.cap if packed.hubs else None
        tied, across = viterbi_ties(torch, em, src_b, lab_b, w_b, start, il, span)
        if not tied or (span and not across):
            raise AssertionError(f"viterbi: no exact ties (across a hub's chunks) in {what}")
        ties = f", {tied} tied states ({across} across a hub's chunks)"
    infeasible = int((score_p <= NEG / 2).sum())
    rows = vsp.scan_rows(packed, S, T, C, taken[0])
    log(f"viterbi {what}: scan route {'/'.join(taken)}, decode {', '.join(decoded)} (cap "
        f"{packed.cap}, {packed.slots} slots, {packed.hubs} hubs, {packed.A} arcs, {rows} "
        f"emission rows a block for the scan alone): slots and labels bitwise equal, final "
        f"max|d| {fwd_err:.3g}, score max|d| {bt_err:.3g}, {infeasible} infeasible "
        f"samples{ties}")
    return {"viterbi_scan_fwd": fwd_err, "viterbi_backtrace": bt_err}


# a decode whose walk words do not fit in shared memory (walk "chunked"):
# the headline table over B, T frames
VITERBI_LONG = (8, 720)


def phase_viterbi(torch, dev):
    from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp
    from gtn_applications_tpu_torch.ops.semiring import NEG

    head = viterbi_headline_inputs(torch, dev)
    errs = hold_viterbi_kernels(torch, *head, ("ngram-2 decode", B, T, N),
                                routes=vsp.ROUTES, walks=vsp.WALKS)
    # bigrams over 2N and 3N labels: 25,760 arcs staged in shared memory,
    # and 57,840 past it, read from global memory
    for n, b, route in ((2 * N, 8, "shared"), (3 * N, 4, "global")):
        inputs = viterbi_headline_inputs(torch, dev, b=b, n=n)
        packed = vsp.pack_buckets(*inputs[1:4]).to(dev)
        if vsp.scan_route(packed, n + 2, n) != route:
            raise AssertionError(f"viterbi: the bigram over {n} labels does not take "
                                 f"route {route}")
        merge_errs(errs, hold_viterbi_kernels(torch, *inputs, (route, b, T, n),
                                              packed=packed))
    b, t = VITERBI_LONG
    inputs = viterbi_headline_inputs(torch, dev, b=b, t=t)
    packed = vsp.pack_buckets(*inputs[1:4]).to(dev)
    S = inputs[4].shape[0]
    if vsp.walk_route(packed, S, t, N, vsp.scan_route(packed, S, N, "chunked", t)) != "chunked":
        raise AssertionError(f"viterbi: the decode over {t} frames does not take walk chunked")
    merge_errs(errs, hold_viterbi_kernels(torch, *inputs, ("walk chunked", b, t, N),
                                          packed=packed))
    em, src_b, lab_b, w_b, start, accept, il = viterbi_skewed_inputs(torch, dev)
    merge_errs(errs, hold_viterbi_kernels(torch, em, src_b, lab_b, w_b, start,
                                          accept, il, ("skewed", B, T, N), walks=vsp.WALKS))
    _, _, labels, score = vsp.viterbi_scan_fwd_cuda(em, src_b, lab_b, w_b, start, il,
                                                    accept=accept)
    if not (float(score[1]) <= NEG / 2 and bool((labels[1] == -1).all())):
        raise AssertionError("viterbi: the infeasible sample did not decode empty")
    ties = viterbi_headline_inputs(torch, dev, seed=8, integer=True)
    merge_errs(errs, hold_viterbi_kernels(torch, *ties, ("integer ties", B, T, N),
                                          routes=vsp.ROUTES, need_ties=True,
                                          walks=vsp.WALKS))
    # two arcs a lane: every state of in-degree 81 is a hub of two warp chunks
    merge_errs(errs, hold_viterbi_kernels(torch, *ties, ("integer ties, hubs", B, T, N),
                                          cap=2, need_ties=True, walks=vsp.WALKS))
    return errs


# The sparse tier at the loaded backoff-LM protocol of bench.py: a pruned
# bigram with optional blank and self-loops over 1,000 wordpieces (N = 1,001
# channels), B = 32, T = 100, targets of L = 15
LM_B, LM_T, LM_L, LM_TOKENS = 32, 100, 15, 1000
# a random table past shared memory: B, T, C, S, A, E
WIDE_SPARSE = (8, 64, 100, 1024, 18000, 1024)


def backoff_lm_criterion(ntok=LM_TOKENS):
    """bench.py's ``_backoff_lm_protocol`` graph and Transducer, built with
    the port's copy of build_transitions (the same corpus from the same
    seed)."""
    import random

    from gtn_applications_tpu_torch.criterions import Transducer
    from gtn_applications_tpu_torch.scripts.build_transitions import build_from_lines

    rng = random.Random(0)
    lines = [[str(min(ntok - 1, int(rng.paretovariate(1.1)) - 1))
              for _ in range(rng.randint(5, 20))] for _ in range(4000)]
    order = list(range(ntok))
    rng.shuffle(order)
    lines += [[str(i) for i in order[k:k + 10]] for k in range(0, ntok, 10)]
    g = build_from_lines(lines, [str(i) for i in range(ntok)], [0, 0], "optional",
                         self_loops=True)
    return Transducer([(i,) for i in range(ntok)], {i: i for i in range(ntok)},
                      transitions=g, blank="optional", reduction="mean")


def transducer_tables(torch, dev, crit, prepared, params):
    """The composed ("score") and normaliser ("norm") tables as
    Transducer.loss weights them, on the card."""
    from gtn_applications_tpu_torch.train import to_device

    prep = to_device(prepared, dev)
    score = crit._apply_params(prep["table"], prep["widx"], prep["eps_widx"], params)
    return {"score": score, "norm": crit._apply_params(*crit._norm_table_on(dev), params)}


def backoff_lm_batch(torch, dev, seed=0):
    """bench.py's inputs [B, T, N + 1] and targets for the protocol, random
    N(0, 0.3) transition weights, input lengths over 4T/5..T; returns
    (criterion, em, lens, targets, params)."""
    crit = backoff_lm_criterion()
    rng = np.random.RandomState(seed)
    em = torch.as_tensor(rng.randn(LM_B, LM_T, LM_TOKENS + 1).astype(np.float32),
                         device=dev)
    targets = [rng.randint(0, LM_TOKENS, size=LM_L).tolist() for _ in range(LM_B)]
    params = torch.as_tensor((rng.randn(crit.num_transition_arcs) * 0.3)
                             .astype(np.float32), device=dev)
    lens = torch.as_tensor(ragged_lengths(rng, LM_B, LM_T), dtype=torch.int32,
                           device=dev)
    return crit, em, lens, targets, params


def backoff_lm_inputs(torch, dev, seed=0):
    """``backoff_lm_batch``'s (criterion, em, lens) and its composed tables."""
    crit, em, lens, targets, params = backoff_lm_batch(torch, dev, seed)
    return crit, em, lens, transducer_tables(torch, dev, crit, crit.prepare(targets),
                                             params)


def _layered_eps(rng, s, e):
    """Epsilon arcs from the top half of the states to the second quarter
    and from there to the first: a closure of depth 2."""
    half, quarter = s // 2, s // 4
    top = e // 2
    src = np.concatenate([rng.randint(half, s, top), rng.randint(quarter, half, e - top)])
    dst = np.concatenate([rng.randint(quarter, half, top), rng.randint(0, quarter, e - top)])
    return src, dst


def random_sparse_table(torch, dev, b, t, c, s, a, e, seed=9):
    """A shared random table in which every state is live on every frame:
    every state starts (start 0) and has an in-arc from state 0 (whose
    self-loop keeps it live), the rest of the arcs random, weights N(0,
    0.5), layered epsilon arcs of depth 2; emissions N(-4, 1), accept 0,
    input lengths over 4t/5..t."""
    from gtn_applications_tpu_torch.ops import sparse

    rng = np.random.RandomState(seed)
    src = np.concatenate([np.zeros(s, np.int64), rng.randint(0, s, a - s)])
    dst = np.concatenate([np.arange(s), rng.randint(0, s, a - s)])
    esrc, edst = _layered_eps(rng, s, e)
    to = lambda x, dt: torch.as_tensor(np.asarray(x), dtype=dt, device=dev)  # noqa: E731
    table = sparse.ArcTable(
        to(src, torch.int32), to(dst, torch.int32), to(rng.randint(0, c, a), torch.int32),
        to(rng.randn(a) * 0.5, torch.float32), torch.zeros(s, device=dev),
        torch.zeros(s, device=dev), to(esrc, torch.int32), to(edst, torch.int32),
        to(rng.randn(e) * 0.5, torch.float32), eps_depth=2)
    em = to(rng.randn(b, t, c) - 4, torch.float32)
    return em, table, to(ragged_lengths(rng, b, t), torch.int32)


def _as2d(x):
    return x[None] if x.dim() == 1 else x


def sparse_fields(table):
    """(src, dst, label, weight, eps_src, eps_dst, eps_weight) 2-D,
    start and accept 2-D, and the depth the kernels run."""
    fields = [_as2d(getattr(table, f)).contiguous() for f in (
        "src", "dst", "label", "weight", "eps_src", "eps_dst", "eps_weight")]
    depth = table.eps_depth if fields[4].shape[-1] else 0
    return fields, _as2d(table.start), _as2d(table.accept), depth


def hold_live(torch, name, k, p, what, all_live=False, floor=None):
    """k against p within atol 1e-3 + rtol 1e-5 on the states p keeps live
    (both must agree on which) and, with ``floor``, above it: returns the
    max abs error there."""
    from gtn_applications_tpu_torch.ops.semiring import DEAD

    live = p > DEAD
    if not torch.equal(k > DEAD, live):
        raise AssertionError(f"{name}: live states differ at {what}")
    if all_live and not bool(live.all()):
        raise AssertionError(f"{name}: dead states in the all-live case {what}")
    if floor is not None:
        live = live & (p > floor)
    torch.testing.assert_close(k[live], p[live], atol=1e-3, rtol=1e-5)
    return float((k[live] - p[live]).abs().max()) if bool(live.any()) else 0.0


def hold_cluster_refused(torch, em, alpha0, lens, plan, w, ew, depth, k, fit):
    """A scan whose cluster of k blocks does not fit on the card (``fit``:
    clusters that fit, forward and backward) must raise at launch."""
    from gtn_applications_tpu_torch.ops import sparse_scan_pallas as ssp

    B, T, S = em.shape[0], em.shape[1], alpha0.shape[1]
    calls = [lambda: ssp.sparse_scan_fwd_cuda(em, alpha0, lens, plan, w, ew, depth,
                                              cluster=k),
             lambda: ssp.sparse_scan_bwd_cuda(
                 em, torch.zeros(B, T + 1, S, device=em.device), lens, plan, w, ew, depth,
                 torch.zeros(B, S, device=em.device), cluster=k)]
    for n, call in zip(fit, calls):
        if n:
            continue
        try:
            call()
        except RuntimeError:
            continue
        raise AssertionError(f"sparse_scan: a cluster of {k} that does not fit launched")


def hold_seglse(torch, alpha, src, dst, w, em, idx, g, what, floor32=False):
    """The seg_lse pair on one step against its plain versions in float64:
    values within atol 1e-3 + rtol 1e-5 on live states, dalpha and
    dcontrib entry by entry within 1e-5 (|p| + the median nonzero |p|);
    with ``floor32``, within the float32 plain version's own entrywise
    error against float64 where that is larger (a step of the per-frame
    scan, whose alpha of hundreds of nats rounds each exponent's argument
    by ~1e-5 in float32, as every float32 route does).
    Each kernel runs twice and must agree with itself bitwise, the
    forward also by its other route (alpha, w and em staged in shared
    memory or gathered from device memory, where both fit) and without its
    statistics, the backward without dcontrib.  em may be None.  Returns (errors,
    the plain forward in float64)."""
    from gtn_applications_tpu_torch.ops import _build
    from gtn_applications_tpu_torch.ops import seglse_pallas as slp

    S, A = alpha.shape[1], w.shape[1]
    routes = [r for r in (False, True)
              if not r or 4 * slp.stage_words(S, A, em) <= _build.MAX_SMEM]
    fwd = slp.seg_lse_fwd_cuda(alpha, w, em, idx, stats=True)
    again = [slp.seg_lse_fwd_cuda(alpha, w, em, idx, stats=True, staged=r) for r in routes]
    bare = slp.seg_lse_fwd_cuda(alpha, w, em, idx)
    if not (all(torch.equal(x, y) for o in again for x, y in zip(fwd, o))
            and torch.equal(bare, fwd[0])):
        raise AssertionError(f"seg_lse_fwd: two runs differ at {what}")
    out_k, m_k, z_k = fwd
    a64, w64 = alpha.double(), w.double()
    em64 = 0.0 if em is None else em.double()
    out_p = slp.seg_lse_fwd_plain(a64, src, dst, w64, em64)
    errs = {"seg_lse_fwd": hold_live(torch, "seg_lse_fwd", out_k.double(), out_p, what)}
    bwd = slp.seg_lse_bwd_cuda(alpha, w, em, idx, m_k, z_k, g)
    again = slp.seg_lse_bwd_cuda(alpha, w, em, idx, m_k, z_k, g)
    da_only, none = slp.seg_lse_bwd_cuda(alpha, w, em, idx, m_k, z_k, g, need_dcontrib=False)
    if not (all(torch.equal(x, y) for x, y in zip(bwd, again))
            and torch.equal(da_only, bwd[0]) and none is None):
        raise AssertionError(f"seg_lse_bwd: two runs differ at {what}")
    da_p, dc_p = slp.seg_lse_bwd_plain(a64, src, dst, w64, em64, g.double())
    floors = (slp.seg_lse_bwd_plain(alpha, src, dst, w, 0.0 if em is None else em, g)
              if floor32 else (None, None))
    errs["seg_lse_bwd"] = errs["seg_lse_bwd_rel"] = 0.0
    for name, k, p, f in (("dalpha", bwd[0], da_p, floors[0]),
                          ("dcontrib", bwd[1], dc_p, floors[1])):
        tol = 1e-5 if f is None else max(1e-5, entrywise_err(torch, f.double(), p))
        if tol > 1e-5:
            log(f"seg_lse_bwd {name} at {what}: bound {tol:.3g}, the float32 plain "
                "version's own error against float64")
        rel, err = hold_entrywise(torch, f"seg_lse_bwd {name}", k, p, what, tol)
        errs["seg_lse_bwd_rel"] = max(errs["seg_lse_bwd_rel"], rel)
        errs["seg_lse_bwd"] = max(errs["seg_lse_bwd"], err)
    return errs, out_p


def seglse_case(torch, dev, layout, b=B, s=3000, dead=False, seed=20):
    """One seg_lse step past every lane schedule of its kernels.  Each
    structure row has a destination hub of 4,500 in-arcs (past the 2,048 a
    block holds in registers) and one of 400, a source hub of 4,300
    out-arcs and one of 700, 40 % of the states without in-arcs and the
    rest 1-256, a tenth of the states dead (NEG in alpha) and one
    destination reached only from them, 32 arcs with a source and 32 with
    a destination outside [0, S); rows are padded to one length with
    arcs of -1 endpoints.  ``layout``: src/dst, w and em each "s" (shared)
    or "b" (per sample), em also "n" (absent); ``dead``: every state of
    alpha NEG.  Returns alpha [b, s], src, dst, w, em (or None), g [b, s]."""
    from gtn_applications_tpu_torch.ops.semiring import NEG

    rng = np.random.RandomState(seed)
    dead_states = rng.choice(np.arange(16, s), s // 10, replace=False)
    hubs = {"dst": (3, s // 2 + 7), "src": (9, 11)}

    def structure(r):
        g = np.random.RandomState(seed + 1 + r)
        cls = g.choice(4, size=s, p=[0.7, 0.15, 0.1, 0.05])
        deg = np.where(g.rand(s) < 0.6, g.randint(np.array([1, 9, 33, 65])[cls],
                                                  np.array([9, 33, 65, 257])[cls]), 0)
        deg[list(hubs["dst"])] = (4500, 400)
        deg[13] = 3  # reached only from dead states
        dst = np.repeat(np.arange(s), deg)
        src = g.randint(0, s, dst.size)
        perm = g.permutation(dst.size)
        src[perm[:4300]], src[perm[4300:5000]] = hubs["src"]
        src[dst == 13] = dead_states[:3]
        src = np.concatenate([src, g.choice([-1, s], 32), g.randint(0, s, 32)])
        dst = np.concatenate([dst, g.randint(0, s, 32), g.choice([-1, s + 3], 32)])
        return src, dst

    rows = {"s": 1, "b": b, "n": 0}
    pairs = [structure(r) for r in range(rows[layout[0]])]
    A = max(x[0].size for x in pairs)
    pad = lambda x: np.concatenate([x, np.full(A - x.size, -1)])  # noqa: E731
    src = np.stack([pad(x[0]) for x in pairs])
    dst = np.stack([pad(x[1]) for x in pairs])
    alpha = (rng.randn(b, s) * 3).astype(np.float32)
    alpha[:, dead_states] = NEG
    if dead:
        alpha[:] = NEG
    to = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt, device=dev)  # noqa: E731
    w = to(rng.randn(rows[layout[1]], A) * 0.5)
    em = to(rng.randn(rows[layout[2]], A)) if layout[2] != "n" else None
    g = to(rng.rand(b, s))
    return to(alpha), to(src, torch.int32), to(dst, torch.int32), w, em, g


SEGLSE_LAYOUTS = [a + b + c for a in "sb" for b in "sb" for c in "sbn"]


def phase_seglse(torch, dev):
    """The seg_lse pair on the synthetic hub case (``seglse_case``) in every
    layout of src/dst, w and em, and with every state dead."""
    from gtn_applications_tpu_torch.ops import seglse_pallas as slp

    errs = {}
    for layout, dead in [(x, False) for x in SEGLSE_LAYOUTS] + [("bbb", True)]:
        alpha, src, dst, w, em, g = seglse_case(torch, dev, layout, dead=dead)
        idx = slp.arc_index(src, dst, alpha.shape[1])
        din = torch.diff(idx.dptr.long(), dim=1)
        dout = torch.diff(idx.sptr.long(), dim=1)
        step_errs, out_p = hold_seglse(torch, alpha, src, dst, w, em, idx, g,
                                       ("hub case", layout, "dead" if dead else "live"))
        if dead and bool((out_p > -5e29).any()):
            raise AssertionError("seg_lse: a live state in the all-dead case")
        merge_errs(errs, step_errs)
        log(f"seg_lse hub case {layout}{' all dead' if dead else ''}: B={alpha.shape[0]} "
            f"S={alpha.shape[1]} A={src.shape[1]}, in-degree max {int(din.max())}, "
            f"out-degree max {int(dout.max())}, empty destinations "
            f"{float((din == 0).double().mean()):.3f}; fwd max|d| "
            f"{step_errs['seg_lse_fwd']:.3g}, bwd entrywise {step_errs['seg_lse_bwd_rel']:.3g}")
    return errs


def hold_sparse_kernels(torch, em, table, lens, what, all_live=False,
                        past_smem=False, clusters=None):
    """The seg_lse pair on each step of the table's start closure and the
    whole-scan pair on the table, kernels against their plain versions on
    the same inputs, the plain versions evaluated in float64: values within
    atol 1e-3 + rtol 1e-5 on live states (the scan's trajectory: on those
    within 80 nats of the frame's largest), the cotangents (dalpha and
    dcontrib; dem, dw, deps, dalpha0) entry by entry within 1e-5 (|p| +
    the median nonzero |p|).  float64, because the plain versions' sums
    (``scatter_add`` over up to 1,000 arcs into one state, in no fixed
    order) are the less accurate side in float32: at the 1kwp normaliser
    their backward is 1.25e-5 from float64 entry by entry, the kernel's
    1.5e-6.  The scan pair runs at each cluster size of ``clusters``
    (default: the one its batch launches with); a size whose cluster does
    not fit on the card must raise at launch.  ``past_smem``: at one block
    a sample, the scan's tables must be read from global memory."""
    from gtn_applications_tpu_torch.ops import seglse_pallas as slp
    from gtn_applications_tpu_torch.ops import sparse_scan_pallas as ssp
    from gtn_applications_tpu_torch.ops.semiring import logaddexp

    (src, dst, label, w, esrc, edst, ew), start, accept, depth = sparse_fields(table)
    B, T, C = em.shape
    S = start.shape[-1]
    f64 = lambda *xs: [x.double() for x in xs]  # noqa: E731
    errs, rels = {"seg_lse_fwd": 0.0, "seg_lse_bwd": 0.0}, {}
    alpha0 = start.expand(B, S).contiguous()
    rng = np.random.RandomState(10)
    if depth:
        idx = slp.arc_index(esrc, edst, S)
        acc = cur = alpha0
        for d in range(depth):
            g = torch.as_tensor(rng.rand(B, S).astype(np.float32), device=em.device)
            step_errs, out_p = hold_seglse(torch, cur, esrc, edst, ew, None, idx, g,
                                           (what, f"closure round {d + 1}"))
            merge_errs(errs, step_errs)
            rels["seg_lse"] = max(rels.get("seg_lse", 0.0), step_errs["seg_lse_bwd_rel"])
            cur = out_p.float()
            acc = logaddexp(acc, cur)
        alpha0 = acc.contiguous()
    plan = ssp.scan_plan(src, dst, label, esrc, edst, S, C)
    A, E = src.shape[1], esrc.shape[1]
    if past_smem and any(ssp.scan_route(ssp.plan_schedule(plan, 1).sizes, S, C, depth, bwd)[1]
                         for bwd in (False, True)):
        raise AssertionError(f"sparse_scan: the tables of {what} fit in shared memory")
    em64, a64, w64, ew64 = f64(em, alpha0, w, ew)
    tr_p, sh_p = ssp.sparse_scan_fwd_plain(em64, a64, lens, plan, w64, ew64, depth)
    errs["sparse_scan_fwd"] = errs["sparse_scan_bwd"] = 0.0
    routes = []
    for k in clusters or [ssp.choose_cluster(plan, B, depth, em.device)]:
        sizes = ssp.plan_schedule(plan, k).sizes
        fit = [ssp.max_active_clusters(plan, depth, bwd, k, em.device) for bwd in (False, True)]
        if not min(fit):
            hold_cluster_refused(torch, em, alpha0, lens, plan, w, ew, depth, k, fit)
            routes.append(f"k={k}: does not fit, its launch raised")
            continue
        tr_k, sh_k = ssp.sparse_scan_fwd_cuda(em, alpha0, lens, plan, w, ew, depth, cluster=k)
        # the trajectory is relative to each frame's largest alpha: states
        # more than 80 nats below it carry no probability (exp underflows;
        # the TPU kernel flushes them to NEG), and over ~600 frames their
        # float32 values drift by more than the tolerance, so they are
        # compared only for liveness
        errs["sparse_scan_fwd"] = max(errs["sparse_scan_fwd"], hold_live(
            torch, "sparse_scan_fwd", tr_k.double(), tr_p, (what, k), all_live, floor=-80.0))
        torch.testing.assert_close(sh_k.double(), sh_p, atol=1e-3, rtol=1e-5)
        # the backward from the same float32 trajectory, the kernel's
        g = score_cotangent(torch, tr_k[:, -1], accept)
        out_k = ssp.sparse_scan_bwd_cuda(em, tr_k, lens, plan, w, ew, depth, g, cluster=k)
        out_p = ssp.sparse_scan_bwd_plain(em64, tr_k.double(), lens, plan, w64, ew64,
                                          depth, g.double())
        torch.cuda.synchronize()
        for name, kv, pv in zip(("dem", "dw", "deps", "dalpha0"), out_k, out_p):
            if pv.numel():
                rel, err = hold_entrywise(torch, f"sparse_scan_bwd {name}", kv, pv, (what, k))
                rels[name] = max(rels.get(name, 0.0), rel)
                errs["sparse_scan_bwd"] = max(errs["sparse_scan_bwd"], err)
        routes.append("k={}: {}/{} clusters fit (fwd/bwd), fwd tables in shared memory {}, "
                      "bwd state {} and tables {}".format(
                          k, *fit, ssp.scan_route(sizes, S, C, depth, False)[1],
                          *ssp.scan_route(sizes, S, C, depth, True)))
    log(f"sparse {what}: S={S} A={A} E={E} depth={depth} "
        f"layout src/w/eps {src.shape[0]}/{w.shape[0]}/{ew.shape[0]}; "
        + "; ".join(routes) + f"; seg_lse fwd max|d| {errs['seg_lse_fwd']:.3g}, scan traj "
        f"max|d| (live states) {errs['sparse_scan_fwd']:.3g}, entrywise errors "
        + ", ".join(f"{k} {v:.3g}" for k, v in rels.items()))
    errs["seg_lse_bwd_rel"] = rels.get("seg_lse", 0.0)
    errs["sparse_scan_bwd_rel"] = max(
        [v for k, v in rels.items() if not k.startswith("seg")], default=0.0)
    return errs


def stc_sparse_inputs(torch, dev, b=B, t=T, length=STC_L, n=N, seed=2):
    """STC's sparse tier at the STC headline (a union table of depth 0):
    the star channels of random logits and the penalised table, with the
    dense gate shut."""
    import dataclasses

    from gtn_applications_tpu_torch.criterions import STC
    from gtn_applications_tpu_torch.criterions import stc as stc_mod
    from gtn_applications_tpu_torch.train import to_device

    rng = np.random.RandomState(seed)
    crit = STC(0, p0=1.0, plast=0.1, thalf=100, reduction="mean", shift_targets=1)
    gate = stc_mod._DENSE_MAX_WORKSET
    stc_mod._DENSE_MAX_WORKSET = 0
    try:
        prepared = to_device(crit.prepare(
            [rng.randint(0, n, size=length).tolist() for _ in range(b)]), dev)
    finally:
        stc_mod._DENSE_MAX_WORKSET = gate
    logits = torch.as_tensor(rng.randn(b, t, n + 1).astype(np.float32), device=dev)
    em = crit.star_channels(torch.log_softmax(logits, 2), prepared["select"])
    table = prepared["table"]
    table = dataclasses.replace(
        table, weight=table.weight + prepared["star_mask"] * prepared["log_penalty"])
    il = torch.as_tensor(ragged_lengths(rng, b, t), dtype=torch.int32, device=dev)
    return em.contiguous(), table, il


def backoff_main_inputs(torch, dev, t=300, seed=11, path="transducer_backoff"):
    """A backoff path's tables: the pruned_ngram_ctc.json criterion over
    the path's grapheme LM, on the first 32 targets of the long-line train
    split, random logits [32, t, 12] and N(0, 0.3) transitions."""
    from gtn_applications_tpu_torch import utils
    from gtn_applications_tpu_torch.datasets import synthetic_long

    config = main_path_config(path)
    pre = synthetic_long.Preprocessor(None, num_features=config["data"]["num_features"])
    crit, n_out = utils.load_criterion("transducer", pre, config["criterion"])
    ds = synthetic_long.Dataset(None, pre, split="train")
    targets = [ds[i][1] for i in range(32)]
    rng = np.random.RandomState(seed)
    params = torch.as_tensor((rng.randn(crit.num_transition_arcs) * 0.3)
                             .astype(np.float32), device=dev)
    em = torch.as_tensor(rng.randn(32, t, n_out).astype(np.float32), device=dev)
    lens = torch.as_tensor(ragged_lengths(rng, 32, t), dtype=torch.int32, device=dev)
    return crit, em, lens, transducer_tables(torch, dev, crit, crit.prepare(targets),
                                             params)


def phase_sparse(torch, dev):
    """The sparse kernels at each case; the scan pair at every cluster
    size on the 1kwp normaliser, the 4-gram normaliser, the table past
    shared memory and a batch of 5 (not a multiple of the cluster)."""
    from gtn_applications_tpu_torch.ops.sparse_scan_pallas import CLUSTER_SIZES

    errs = {}
    crit, em, lens, tables = backoff_lm_inputs(torch, dev)
    if tables["score"].src.dim() != 1 or tables["norm"].src.dim() != 1:
        raise AssertionError("the 1kwp protocol's tables are not shared / union")
    for key in ("norm", "score"):
        merge_errs(errs, hold_sparse_kernels(
            torch, em, tables[key], lens, ("1kwp " + key, LM_B, LM_T),
            clusters=CLUSTER_SIZES if key == "norm" else None))
    merge_errs(errs, hold_sparse_kernels(torch, em[:5].contiguous(), tables["norm"],
                                         lens[:5].contiguous(), ("1kwp norm", 5, LM_T),
                                         clusters=CLUSTER_SIZES))
    for lm, path in (("trigram", "transducer_backoff"), ("4-gram", "transducer_backoff_4gram")):
        _, em3, lens3, tables3 = backoff_main_inputs(torch, dev, path=path)
        for key in ("norm", "score"):
            merge_errs(errs, hold_sparse_kernels(
                torch, em3, tables3[key], lens3, (f"{lm} {key}",) + tuple(em3.shape[:2]),
                clusters=CLUSTER_SIZES if (lm, key) == ("4-gram", "norm") else None))
    em_r, table_r, lens_r = random_sparse_table(torch, dev, B, T, N, 64, 1024, 128)
    merge_errs(errs, hold_sparse_kernels(torch, em_r, table_r, lens_r,
                                         ("all live", B, T, 64), all_live=True))
    em_s, table_s, lens_s = stc_sparse_inputs(torch, dev)
    if table_s.src.dim() != 1 or table_s.eps_depth != 0:
        raise AssertionError("the STC sparse table is not a depth-0 union table")
    merge_errs(errs, hold_sparse_kernels(torch, em_s, table_s, lens_s,
                                         ("stc union depth 0", B, T)))
    em_w, table_w, lens_w = random_sparse_table(torch, dev, *WIDE_SPARSE)
    merge_errs(errs, hold_sparse_kernels(torch, em_w, table_w, lens_w,
                                         ("past shared memory",) + WIDE_SPARSE,
                                         past_smem=True, clusters=CLUSTER_SIZES))
    return merge_errs(errs, phase_seglse(torch, dev))


# The backoff factorings (ops/factored.py, GTN_TRANSDUCER_FACTORED=on): no
# kernel of ours, loops of PyTorch products and elementwise ops a frame;
# held to the composed route (the sparse kernels) at the bounds of JAX's
# tests/test_factored.py, scaled to the loss
FACTORED_LOSS_TOL = 5e-4       # |d loss| <= tol max(1, |loss|)
FACTORED_GRAD_TOL = (5e-4, 1e-3)  # |d g| <= atol + rtol |g| entry by entry
HUGE_LM_TOKENS = 200           # the decode check's bigram: S_c * N > 2^15
DECODE_B, DECODE_T = 8, 100


@contextlib.contextmanager
def factored_route(impl, vjp="auto"):
    """``GTN_TRANSDUCER_FACTORED`` and ``GTN_FACTORED_VJP`` set in process."""
    from gtn_applications_tpu_torch.criterions import transducer as td
    from gtn_applications_tpu_torch.ops import factored

    saved = td._FACTORED_IMPL, factored._VJP_IMPL
    td._FACTORED_IMPL, factored._VJP_IMPL = impl, vjp
    try:
        yield
    finally:
        td._FACTORED_IMPL, factored._VJP_IMPL = saved


def route_loss(torch, crit, logits, targets, params, impl, vjp="auto", lens=None,
               grads=True):
    """A function of no arguments that returns the criterion's loss (and its
    gradients in the logits and the transitions) through the route, the
    batch prepared once on the logits' device."""
    from gtn_applications_tpu_torch.train import to_device

    with factored_route(impl, vjp):
        prepared = to_device(crit.prepare(targets), logits.device)
    if ("factored" in prepared) != (impl == "on"):
        raise AssertionError(f"route {impl}: prepare gave {sorted(prepared)}")
    x = logits.detach().clone().requires_grad_(grads)
    p = params.detach().clone().requires_grad_(grads)

    def run():
        with factored_route(impl, vjp):
            loss = crit.loss({"transitions": p}, x, prepared, lens)
            if not grads:
                return (loss.detach(),)
            return (loss.detach(),) + torch.autograd.grad(loss, [x, p])

    return run


def hold_route(torch, card, what, ref, got):
    """The loss and gradients of a factored route against the composed
    route's: the loss within FACTORED_LOSS_TOL max(1, |loss|), each
    gradient entry within FACTORED_GRAD_TOL.  Returns the differences."""
    loss, loss_ref = float(got[0]), float(ref[0])
    d_loss = abs(loss - loss_ref)
    out = {"loss": loss, "loss_abs_diff": d_loss}
    ok = d_loss <= FACTORED_LOSS_TOL * max(1.0, abs(loss_ref))
    for name, g, r in zip(("logit", "transitions"), got[1:], ref[1:]):
        d = (g - r).abs()
        out[f"{name}_grad_max_abs_diff"] = float(d.max())
        out[f"{name}_grad_excess"] = float((d - FACTORED_GRAD_TOL[0]
                                            - FACTORED_GRAD_TOL[1] * r.abs()).max())
        ok = ok and out[f"{name}_grad_excess"] <= 0.0
    log(f"[{card}] {what}: loss {loss:.6f} against composed {loss_ref:.6f} "
        f"(|d| {d_loss:.3g}), logit grad max|d| {out['logit_grad_max_abs_diff']:.3g}, "
        f"transitions grad max|d| {out['transitions_grad_max_abs_diff']:.3g}")
    if not ok:
        raise AssertionError(f"{what}: the factored route and the composed one disagree")
    return out


def launches_a_call(torch, fn):
    """CUDA kernels one call of ``fn`` (run before) launches: torch.profiler
    over one call, after a marker kernel (``kernel_counts``'s), tracing the
    device only (the host's events of a quarter of a million launches take
    minutes to gather), or the host too where that sees no kernel."""
    from torch.profiler import ProfilerActivity, profile

    for activities in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and "spin_kernel" not in e.key)
        if n:
            return n
    raise AssertionError("torch.profiler saw no kernel")


def with_peak(torch, fn):
    """(fn(), peak device bytes allocated during the call above what was
    allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def route_costs(torch, fn, runs=30, warmup=5):
    """CUDA-event median ms of ``fn`` and the kernels one call launches."""
    return {"ms": gpu_median_ms(torch, fn, runs=runs, warmup=warmup),
            "launches": launches_a_call(torch, fn)}


def huge_lm_criterion(ntok=HUGE_LM_TOKENS):
    """A pruned bigram with blanks and self-loops over ``ntok`` tokens
    (S_c * N > 2^15: the destination-factored decode's regime), as
    ``tests/test_torch_transducer_backoff.py`` builds it."""
    from gtn_applications_tpu_torch.criterions import Transducer
    from gtn_applications_tpu_torch.scripts.build_transitions import build_from_lines

    rng = np.random.RandomState(3)
    lines = [[str(i) for i in rng.randint(0, ntok, 12)] for _ in range(400)]
    g = build_from_lines(lines, [str(i) for i in range(ntok)], [0, 0], "optional",
                         self_loops=True)
    return Transducer([(i,) for i in range(ntok)], {i: i for i in range(ntok)},
                      transitions=g, blank="optional", reduction="mean")


def factored_trigram_check(torch, dev, card):
    """(a) the trigram main path's first batch (the loader's, logits of the
    path's TDS2d at its seeded initial weights, N(0, 0.3) transitions):
    the dense variant (on) against the composed route (off, the sparse
    kernels) on the card, the factored loss on the card against the CPU,
    each route's fwd+bwd cost, and the path's train step under each."""
    from gtn_applications_tpu_torch import train as train_mod
    from gtn_applications_tpu_torch import utils
    from gtn_applications_tpu_torch.ops import _build

    config = main_path_config("transducer_backoff")
    dataset, pre, crit, model, _ = train_mod.load_experiment(
        config, generator=torch.Generator().manual_seed(config["seed"]))
    model.to(dev)
    loader = utils.data_loader(dataset.Dataset(None, pre, split="train", augment=True),
                               config, seed=config["seed"])
    inputs, _, targets = next(iter(loader))
    with torch.no_grad():
        logits = model(torch.from_numpy(inputs).to(dev))
    params = torch.as_tensor((np.random.RandomState(21).randn(crit.num_transition_arcs)
                              * 0.3).astype(np.float32), device=dev)
    if not crit._factored_backoff or crit._factored_backoff_dst:
        raise AssertionError("the trigram is not the dense variant's")
    out = {"shape": list(logits.shape)}
    results, fns, peaks = {}, {}, {}
    for impl in ("off", "on"):
        fns[impl] = route_loss(torch, crit, logits, targets, params, impl)
        before = dict(_build.LAUNCHES)
        results[impl], peaks[impl] = with_peak(torch, fns[impl])
        ours = {k: n - before[k] for k, n in _build.LAUNCHES.items() if n != before[k]}
        out[f"{impl}_our_kernels"] = ours
        if bool(ours) != (impl == "off"):
            raise AssertionError(f"trigram route {impl} launched our kernels {ours}")
    out["on_vs_off"] = hold_route(torch, card, f"trigram first batch {out['shape']} dense "
                                  "variant", results["off"], results["on"])
    cpu = route_loss(torch, crit, logits.cpu(), targets, params.cpu(), "on", grads=False)()
    rel = abs(float(results["on"][0]) - float(cpu[0])) / max(1.0, abs(float(cpu[0])))
    out["card_vs_cpu_loss_rel_diff"] = rel
    log(f"[{card}] trigram dense variant loss card vs cpu: rel |d| {rel:.3g}")
    if not rel <= 1e-4:
        raise AssertionError("the dense variant's loss: card and CPU disagree")
    # the dense variant's call takes seconds (a quarter of a million
    # launches): its medians are of fewer runs, which keeps the smoke
    # inside its time limit
    reps = {"off": dict(fwd_bwd=(10, 5), step=(20, 5)), "on": dict(fwd_bwd=(2, 1), step=(3, 1))}
    for impl in ("off", "on"):
        out[f"{impl}_fwd_bwd"] = dict(route_costs(torch, fns[impl], *reps[impl]["fwd_bwd"]),
                                      peak_bytes=peaks[impl])
    for impl in ("off", "on"):
        with factored_route(impl):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms, _ = time_train_step(torch, dev, model, config, *reps[impl]["step"])
            out[f"{impl}_train_step_ms"] = ms
            out[f"{impl}_train_step_peak_bytes"] = torch.cuda.max_memory_allocated()
    for impl in ("off", "on"):
        c = out[impl + "_fwd_bwd"]
        log(f"[{card}] trigram route {impl}: train step {out[impl + '_train_step_ms']:.2f} ms "
            f"(host, median of {reps[impl]['step'][0]}), peak "
            f"{out[impl + '_train_step_peak_bytes'] / 2**30:.3f} GiB; loss fwd+bwd "
            f"{c['ms']:.3f} ms (CUDA events, median of {reps[impl]['fwd_bwd'][0]}), "
            f"{c['launches']} launches, peak {c['peak_bytes'] / 2**20:.1f} MiB")
    return out


def factored_1kwp_check(torch, dev, card):
    """(b) bench.py's 1kwp protocol (B=32, T=100, N=1,001, S_c=1,004)
    through the dst variant's three tiers (exp-linear with the low-rank
    closure, exp-linear with the dense one, the staged form) against the
    composed route on the same batch, and each one's fwd+bwd cost."""
    crit, em, lens, targets, params = backoff_lm_batch(torch, dev)
    if crit._factored_backoff or not crit._factored_backoff_dst or crit._eps_lr_struct is None:
        raise AssertionError("the 1kwp LM is not the dst variant's with a low-rank closure")
    out = {"S_c": int(crit._norm_table.start.shape[0]),
           "lowrank_K": int(crit._eps_lr_struct[2].shape[0])}
    ref_fn = route_loss(torch, crit, em, targets, params, "off", lens=lens)
    ref, peak = with_peak(torch, ref_fn)
    out["composed"] = dict(route_costs(torch, ref_fn), peak_bytes=peak)
    struct = crit._eps_lr_struct
    for tier, vjp, lowrank in (("exp_lowrank", "auto", True), ("exp_dense", "auto", False),
                               ("staged", "off", False)):
        crit._eps_lr_struct = struct if lowrank else None
        try:
            fn = route_loss(torch, crit, em, targets, params, "on", vjp, lens=lens)
            got, peak = with_peak(torch, fn)
            out[tier] = hold_route(torch, card, f"1kwp {tier}", ref, got)
            # a tier's call takes 0.3-0.5 s: a median of 10 keeps the
            # smoke inside its time limit
            out[tier].update(route_costs(torch, fn, runs=10, warmup=2), peak_bytes=peak)
        finally:
            crit._eps_lr_struct = struct
    for tier in ("composed", "exp_lowrank", "exp_dense", "staged"):
        c = out[tier]
        log(f"[{card}] 1kwp loss fwd+bwd {tier}: {c['ms']:.3f} ms (CUDA events, median of "
            f"{30 if tier == 'composed' else 10}), {c['launches']} launches, "
            f"peak {c['peak_bytes'] / 2**20:.1f} MiB")
    return out


def factored_decode_check(torch, dev, card):
    """(c) the destination-factored decode: on a 200-token bigram against
    the composed decode (``viterbi_batch``, forced through
    ``_DECODE_FACTORED_MIN_ARCS``) on the card, labels equal; on the 1kwp
    LM, the card's decode of the batch against the CPU's on its first 4
    samples, labels equal, scores within 1e-4 relative; its cost."""
    from gtn_applications_tpu_torch.criterions import transducer as td
    from gtn_applications_tpu_torch.ops import factored

    out = {}
    crit = huge_lm_criterion()
    S_c, n = int(crit._norm_table.start.shape[0]), crit.num_channels
    if not (crit._factored_backoff_dst and S_c * n > td._DECODE_FACTORED_MIN_ARCS):
        raise AssertionError("the 200-token bigram is not the factored decode's")
    rng = np.random.RandomState(23)
    x = torch.as_tensor((rng.randn(DECODE_B, DECODE_T, n) * 3).astype(np.float32), device=dev)
    lens = torch.as_tensor(ragged_lengths(rng, DECODE_B, DECODE_T), dtype=torch.int32,
                           device=dev)
    params = {"transitions": torch.as_tensor(
        (rng.randn(crit.num_transition_arcs) * 0.5).astype(np.float32), device=dev)}
    labels = crit.viterbi_dispatch(x, params, lens)[0]
    saved = td._DECODE_FACTORED_MIN_ARCS
    td._DECODE_FACTORED_MIN_ARCS = 1 << 60
    try:
        composed = crit.viterbi_dispatch(x, params, lens)[0]
    finally:
        td._DECODE_FACTORED_MIN_ARCS = saved
    out["huge_lm"] = {"S_c": S_c, "N": n, "shape": [DECODE_B, DECODE_T],
                      "labels_differ": int((labels.long() != composed.long()).sum())}
    log(f"[{card}] decode, {HUGE_LM_TOKENS}-token bigram (S_c {S_c}, N {n}) "
        f"[{DECODE_B}, {DECODE_T}]: factored against composed, "
        f"{out['huge_lm']['labels_differ']} labels differ")
    if out["huge_lm"]["labels_differ"]:
        raise AssertionError("the factored decode and the composed one disagree")

    crit, em, lens, _, params = backoff_lm_batch(torch, dev)
    p = {"transitions": params}
    if crit._norm_table.start.shape[0] * crit.num_channels <= td._DECODE_FACTORED_MIN_ARCS:
        raise AssertionError("the 1kwp LM is not the factored decode's")
    mats = crit._decode_matrices_dst(p, dev)
    lab_k, score_k = factored.backoff_dst_viterbi(em, *mats, lens)
    cpu = torch.device("cpu")
    lab_c, score_c = factored.backoff_dst_viterbi(
        em[:4].cpu(), *crit._decode_matrices_dst({"transitions": params.cpu()}, cpu),
        lens[:4].cpu())
    rel = float(((score_k[:4].cpu() - score_c).abs() / score_c.abs().clamp(min=1.0)).max())
    same = torch.equal(lab_k[:4].cpu(), lab_c)
    out["1kwp"] = {"shape": list(em.shape), "cpu_labels_equal": same,
                   "cpu_score_rel_diff": rel}

    def decode():
        return crit.viterbi_dispatch(em, p, lens)

    _, peak = with_peak(torch, decode)
    out["1kwp"].update(route_costs(torch, decode, runs=10), peak_bytes=peak)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    out["1kwp"]["host_ms"] = statistics.median(host)
    c = out["1kwp"]
    log(f"[{card}] decode, 1kwp [{LM_B}, {LM_T}, {crit.num_channels}]: card vs cpu (4 "
        f"samples) labels equal {same}, score rel |d| {rel:.3g}; {c['ms']:.3f} ms (CUDA "
        f"events, median of 10), host {c['host_ms']:.3f} ms (median of 5), "
        f"{c['launches']} launches, peak {c['peak_bytes'] / 2**20:.1f} MiB")
    if not (same and rel <= 1e-4):
        raise AssertionError("the 1kwp decode: card and CPU disagree")
    return out


def phase_backoff_factored(torch, dev, card):
    """The backoff factorings on the card: checks (a), (b) and (c)."""
    out = {}
    for name, check in (("trigram", factored_trigram_check), ("1kwp", factored_1kwp_check),
                        ("decode", factored_decode_check)):
        t0 = time.perf_counter()
        out[name] = check(torch, dev, card)
        out[name]["seconds"] = time.perf_counter() - t0
        log(f"backoff factorings, {name}: {out[name]['seconds']:.1f} s")
    return out


# The backoff paths' transition graphs: the grapheme LM of the recipe's
# builder (optional blank) over the long-line train texts, one order per
# count threshold: the IAM recipe's pruned trigram, and an unpruned 4-gram
# whose epsilon-removed decode table (S = 1,058, A = 35,455, a hub state of
# in-degree 1,057) the whole-scan Viterbi's bucket plan refuses, so that
# its decode runs the per-step seg_max
LM_PRUNE = {"transducer_backoff": (0, 5, 10), "transducer_backoff_4gram": (0, 0, 0, 0)}
STEP_T = 300  # frames of the decode's checks at the 4-gram table
TIES_T = 100  # frames of the integer (tied) case


@functools.lru_cache(maxsize=None)
def lm_transitions(prune):
    """The grapheme LM of ``prune`` built into build/chip_smoke with the
    port's builder; returns its path."""
    from gtn_applications_tpu_torch.profile_step import long_corpus_lm

    return long_corpus_lm(WORK / f"transitions_{len(prune)}gram.bin", prune)


@functools.lru_cache(maxsize=1)
def fourgram_template():
    """(transition graph, decode template) of the 4-gram path."""
    from gtn_applications_tpu_torch.wfst import compile as wcompile
    from gtn_applications_tpu_torch.wfst import graph as wgraph

    g = wgraph.load(lm_transitions(LM_PRUNE["transducer_backoff_4gram"]))
    return g, wcompile.build_decode_template(g)


def fourgram_decode_table(seed, integer=False):
    """The 4-gram's tropical decode table (CPU tensors) under random
    transition weights, N(0, 0.5) or, with ``integer``, integers in
    [-2, 2] (so that contributions tie exactly); and its channel count."""
    from gtn_applications_tpu_torch.wfst import compile as wcompile

    g, tmpl = fourgram_template()
    rng = np.random.RandomState(seed)
    w = rng.randint(-2, 3, g.num_arcs()) if integer else rng.randn(g.num_arcs()) * 0.5
    table = wcompile.apply_decode_weights(tmpl, w.astype(np.float32))
    return table, int(table.label.max()) + 1


def segmax_cases(torch, dev, b=B, seed=12):
    """(what, alpha, src, dst, w, em, label) of seg_max's five checks: the
    4-gram decode table (shared fields, emissions by label), a per-sample
    random table (emissions per arc), fields of mixed batch dims, the
    4-gram table with integer alpha, weights and emissions (exact ties),
    and a table with padding arcs (-1 endpoints, NEG weight), arcs whose
    source is -1, and destinations that no arc enters.  A tenth of the
    alpha entries are NEG."""
    from gtn_applications_tpu_torch.ops.semiring import NEG

    rng = np.random.RandomState(seed)

    def to(x, dt=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    def alpha(s, integer=False):
        a = (rng.randint(-3, 4, (b, s)) if integer else rng.randn(b, s) * 3).astype(np.float32)
        a[rng.rand(b, s) < 0.1] = NEG
        return to(a)

    def row(x):  # a shared table field [1, A] on the device
        return x[None].to(dev).contiguous()

    cases = []
    for what, integer in (("4-gram decode table", False), ("4-gram integer ties", True)):
        t, C = fourgram_decode_table(13, integer)
        em = rng.randint(-2, 3, (b, C)) if integer else rng.randn(b, C)
        cases.append(((what, b) + tuple(t.src.shape) + (C,), alpha(t.start.shape[0], integer),
                      row(t.src), row(t.dst), row(t.weight), to(em), row(t.label)))
    S, A, C = 512, 8192, 16
    ints = lambda lo, hi, shape: to(rng.randint(lo, hi, shape), torch.int32)  # noqa: E731
    cases.append((("per sample", b, S, A), alpha(S), ints(0, S, (b, A)), ints(0, S, (b, A)),
                  to(rng.randn(b, A) * 0.5), to(rng.randn(b, A)), None))
    cases.append((("mixed batch dims", b, S, A, C), alpha(S), ints(0, S, (1, A)),
                  ints(0, S, (b, A)), to(rng.randn(1, A) * 0.5), to(rng.randn(b, C)),
                  ints(-1, C + 2, (b, A))))
    src, dst = rng.randint(0, S, A), rng.randint(0, S // 2, A)  # [S/2, S) dead
    w = rng.randn(A) * 0.5
    pad = rng.rand(A) < 0.1
    src[pad], dst[pad], w[pad] = -1, -1, NEG
    src[rng.rand(A) < 0.05] = -1
    cases.append((("padding and dead states", b, S, A, C), alpha(S),
                  to(src[None], torch.int32), to(dst[None], torch.int32), to(w[None]),
                  to(rng.randn(b, C)), ints(0, C, (1, A))))
    return cases


def hold_segmax_kernel(torch, alpha, src, dst, w, em, label, what, need_ties=False):
    """seg_max's kernel against its plain version on the same inputs:
    values bitwise equal, winning arcs exactly.  With ``need_ties``, some
    state, the hub (the state of most in-arcs) among them, must have its
    maximum attained by several arcs."""
    from gtn_applications_tpu_torch.ops import segmax_pallas as smp
    from gtn_applications_tpu_torch.ops.seglse_pallas import arc_index, take
    from gtn_applications_tpu_torch.ops.semiring import NEG

    S = alpha.shape[1]
    idx = (arc_index(src, dst, S) if label is None
           else arc_index(src, dst, S, label, em.shape[1]))
    new_k, arc_k = smp.seg_max_cuda(alpha, take(w, idx.order),
                                    em if label is not None else take(em, idx.order), idx)
    new_p, arc_p = smp.seg_max_plain(alpha, src, dst, w, em, label)
    torch.cuda.synchronize()
    if not torch.equal(new_k, new_p):
        raise AssertionError(f"seg_max: values differ from plain at {what}")
    if not torch.equal(arc_k, arc_p):
        raise AssertionError(f"seg_max: winning arcs differ from plain at {what}")
    # the arcs that attain their state's maximum, counted by state
    keys, c = smp._arc_fields(alpha, src, dst, w, em, label)
    best = torch.cat([new_p, new_p[:, :1]], 1).gather(1, keys)
    won = (keys < S) & (c > NEG) & (c == best)
    hits = torch.zeros(keys.shape[0], S + 1, device=keys.device).scatter_add_(
        1, keys, won.float())[:, :S]
    hub = int(torch.bincount(keys[keys < S], minlength=S).argmax())
    ties, hub_ties = int((hits > 1).sum()), int((hits[:, hub] > 1).sum())
    if need_ties and not (ties and hub_ties):
        raise AssertionError(f"seg_max: no exact ties (at the hub) in {what}")
    log(f"seg_max {what}: values bitwise equal, winning arcs equal; "
        f"{int((arc_p < smp.BIG).sum())} of {arc_p.numel()} states won, {ties} tied "
        f"({hub_ties} at the hub state {hub})")
    return {"seg_max": float((new_k - new_p).abs().max())}


def segmax_scan_inputs(torch, dev, b=B, t=STEP_T, seed=14, integer=False):
    """(em [b, t, C], lens [b], table) of the decode at the 4-gram table:
    emissions N(0, 1) (with ``integer``: integers in [-2, 2], and the
    table's weights too, so that contributions tie exactly), lengths over
    4t/5..t; sample 1 meets an all-NEG frame at t/3, so no path accepts
    it.  The table on the CPU, em and lens on ``dev``."""
    from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp
    from gtn_applications_tpu_torch.ops.semiring import NEG

    table, C = fourgram_decode_table(seed, integer)
    if vsp.build_plan(table) is not None:
        raise AssertionError("the whole-scan plan takes the 4-gram decode table")
    rng = np.random.RandomState(seed)
    em = (rng.randint(-2, 3, (b, t, C)) if integer else rng.randn(b, t, C)).astype(np.float32)
    em[1 % b, t // 3] = NEG
    lens = ragged_lengths(rng, b, t).astype(np.int32)
    return (torch.from_numpy(em).to(dev), torch.from_numpy(lens).to(dev), table)


def scan_ties(torch, em, table, lens, final):
    """(states tied, tied at the hub) over every live frame of the plain
    scan: states whose maximum several arcs attain, and among them the
    hub (the state of most in-arcs); ``final`` must be its final alpha."""
    from gtn_applications_tpu_torch.ops import segmax_pallas as smp
    from gtn_applications_tpu_torch.ops.semiring import NEG

    dev = em.device
    fields = [smp._as2d(getattr(table, f)).to(dev) for f in ("src", "dst", "weight", "label")]
    S = table.start.shape[-1]
    B, T, _ = em.shape
    alpha = table.start.to(dev).expand(B, S).contiguous()
    ties = hub_ties = 0
    hub = int(torch.bincount(table.dst.long(), minlength=S).argmax())
    for t in range(T):
        new, _ = smp.seg_max_plain(alpha, fields[0], fields[1], fields[2], em[:, t],
                                   fields[3])
        keys, c = smp._arc_fields(alpha, fields[0], fields[1], fields[2], em[:, t],
                                  fields[3])
        best = torch.cat([new, new[:, :1]], 1).gather(1, keys)
        won = (keys < S) & (c > NEG) & (c == best)
        hits = torch.zeros(B, S + 1, device=dev).scatter_add_(1, keys, won.float())[:, :S]
        live = (t < lens)[:, None]
        ties += int(((hits > 1) & live).sum())
        hub_ties += int(((hits[:, hub] > 1) & live[:, 0]).sum())
        alpha = torch.where(live, new, alpha)
    if not torch.equal(alpha, final):
        raise AssertionError("scan_ties: the replay's final alpha differs from the scan's")
    return ties, hub_ties


def hold_segmax_scan(torch, em, lens, table, what, clusters=None, need_ties=False):
    """``seg_max_scan`` (the scan and its backtrace in one launch) against
    its plain version (``seg_max_scan_plain`` and ``seg_max_backtrace_plain``
    on the same tensors): backarcs, final alpha and labels bitwise, scores
    within 1e-6, at each cluster size of ``clusters`` (default: the one its
    batch launches with); a size whose clusters do not fit on the card must
    raise at launch.  With ``need_ties``, some state, the hub among them,
    must have its maximum attained by several arcs at some frame.  Returns
    the largest difference of final alpha and score."""
    from gtn_applications_tpu_torch.ops import segmax_pallas as smp
    from gtn_applications_tpu_torch.ops import sparse_scan_pallas as ssp
    from gtn_applications_tpu_torch.ops.seglse_pallas import take
    from gtn_applications_tpu_torch.ops.semiring import NEG

    dev = em.device
    tab = table.to(dev)
    back_p, final_p = smp.seg_max_scan_plain(em, tab, lens)
    labels_p, score_p = smp.seg_max_backtrace_plain(back_p, final_p, tab)
    plan = smp.decode_plan(table, em.shape[2], dev)
    w_s = take(smp._as2d(tab.weight), plan.main.order)
    args = (em, w_s, tab.start.contiguous(), tab.accept.contiguous(), lens, plan)
    err, routes = 0.0, []
    for k in clusters or [smp.choose_cluster(plan, em.shape[0], dev)]:
        if not smp.max_active_clusters(plan, k, dev):
            try:
                smp.seg_max_scan_cuda(*args, cluster=k)
            except RuntimeError:
                routes.append(f"k={k}: does not fit, its launch raised")
                continue
            raise AssertionError(f"seg_max_scan: a cluster of {k} that does not fit launched")
        back_k, final_k, labels_k, score_k = smp.seg_max_scan_cuda(*args, cluster=k)
        torch.cuda.synchronize()
        for name, kv, pv in (("backarcs", back_k, back_p), ("final alpha", final_k, final_p),
                             ("labels", labels_k, labels_p)):
            if not torch.equal(kv, pv):
                raise AssertionError(f"seg_max_scan: {name} differ from plain at {what}, k={k}")
        d_score = float((score_k - score_p).abs().max())
        if not d_score <= 1e-6:
            raise AssertionError(f"seg_max_scan: score max|d| {d_score} at {what}, k={k}")
        err = max(err, d_score)
        sizes = ssp.plan_schedule(plan, k).sizes
        routes.append(f"k={k}: {smp.max_active_clusters(plan, k, dev)} clusters fit, tables "
                      f"in shared memory {smp.decode_route(sizes, plan.S, plan.C)}")
    ties = ""
    if need_ties:
        n_ties, n_hub = scan_ties(torch, em, tab, lens, final_p)
        if not (n_ties and n_hub):
            raise AssertionError(f"seg_max_scan: no exact ties (at the hub) in {what}")
        ties = f", {n_ties} states tied over the frames ({n_hub} at the hub)"
    log(f"seg_max_scan {what}: backarcs, final alpha and labels bitwise equal, score "
        f"max|d| {err:.3g}; {int((score_p <= NEG / 2).sum())} infeasible samples"
        f"{ties}; " + "; ".join(routes))
    return {"seg_max_scan": err}


def hold_step_decode(torch, dev, b=B, t=STEP_T, seed=14):
    """The decode at the 4-gram table through ``viterbi_batch`` on the card
    (one ``seg_max_scan`` launch, nothing per frame) against its CPU route
    on the same inputs (``segmax_scan_inputs``): labels bitwise, scores
    within 1e-6.  Returns the score error."""
    from gtn_applications_tpu_torch.ops import _build, sparse
    from gtn_applications_tpu_torch.ops.semiring import NEG

    em, lens, table = segmax_scan_inputs(torch, "cpu", b, t, seed)
    before = dict(_build.LAUNCHES)
    lab_k, score_k = sparse.viterbi_batch(em.to(dev), table, lens.to(dev))
    launched = {key: n - before[key] for key, n in _build.LAUNCHES.items() if n != before[key]}
    if launched != {"seg_max_scan": 1}:
        raise AssertionError(f"step decode: launched {launched}, not one seg_max_scan")
    lab_p, score_p = sparse.viterbi_batch(em, table, lens)
    if not torch.equal(lab_k.cpu(), lab_p):
        raise AssertionError("step decode: labels differ between the card and the CPU")
    err = float((score_k.cpu() - score_p).abs().max())
    if not err <= 1e-6:
        raise AssertionError(f"step decode: score max|d| {err}")
    if not (float(score_p[1]) <= NEG / 2 and bool((lab_p[1] == -1).all())):
        raise AssertionError("step decode: the infeasible sample did not decode empty")
    log(f"step decode (4-gram, B={b}, T={t}, S={table.start.shape[0]}, "
        f"A={table.src.shape[0]}): one seg_max_scan launch, labels bitwise equal card vs "
        f"cpu, score max|d| {err:.3g}, {int((score_p <= NEG / 2).sum())} infeasible samples")
    return err


def phase_segmax(torch, dev):
    """seg_max's five checks; seg_max_scan at every cluster size on the
    4-gram decode (B=32, T=300), a batch of 5 and the integer table with
    ties at the hub; the routed decode card against CPU."""
    from gtn_applications_tpu_torch.ops.sparse_scan_pallas import CLUSTER_SIZES

    errs = {}
    for i, (what, *inputs) in enumerate(segmax_cases(torch, dev)):
        merge_errs(errs, hold_segmax_kernel(torch, *inputs, what, need_ties=i == 1))
    em, lens, table = segmax_scan_inputs(torch, dev)
    merge_errs(errs, hold_segmax_scan(torch, em, lens, table, ("4-gram", B, STEP_T),
                                      clusters=CLUSTER_SIZES))
    merge_errs(errs, hold_segmax_scan(torch, em[:5].contiguous(), lens[:5].contiguous(), table,
                                      ("4-gram", 5, STEP_T), clusters=CLUSTER_SIZES))
    em_i, lens_i, table_i = segmax_scan_inputs(torch, dev, t=TIES_T, seed=15, integer=True)
    merge_errs(errs, hold_segmax_scan(torch, em_i, lens_i, table_i,
                                      ("4-gram integer ties", B, TIES_T),
                                      clusters=CLUSTER_SIZES, need_ties=True))
    errs["step_decode_score"] = hold_step_decode(torch, dev)
    return errs


# path -> (config file, under configs/iamdb/ unless it names its folder;
# its forward kernels (and decode), its backward kernels)
PATHS = {
    "ctc": ("tds2d.json", ("ctc_alpha",), ("gather_bwd", "ctc_grad")),
    "asg": ("tds2d_asg.json", ("gather_fwd", "dense_bt"), ("gather_bwd",)),
    "stc": ("tds2d_stc.json", ("dense_scan_fwd",), ("dense_scan_bwd",)),
    "transducer": ("ngram_ctc.json",
                   ("factored_scan_fwd", "viterbi_scan_fwd", "viterbi_backtrace"),
                   ("factored_scan_bwd",)),
    "transducer_backoff": ("pruned_ngram_ctc.json",
                           ("seg_lse_fwd", "sparse_scan_fwd", "viterbi_scan_fwd",
                            "viterbi_backtrace"),
                           ("seg_lse_bwd", "sparse_scan_bwd")),
    "transducer_backoff_4gram": ("pruned_ngram_ctc.json",
                                 ("seg_lse_fwd", "sparse_scan_fwd", "seg_max_scan"),
                                 ("seg_lse_bwd", "sparse_scan_bwd")),
    # the IAM recipes' other encoders, and TDS2d computing in bf16, with CTC
    "ctc_rnn": ("rnn.json", ("ctc_alpha",), ("gather_bwd", "ctc_grad")),
    "ctc_tds": ("tds.json", ("ctc_alpha",), ("gather_bwd", "ctc_grad")),
    "ctc_bf16": ("tds2d.json", ("ctc_alpha",), ("gather_bwd", "ctc_grad")),
    # long-sequence CTC, the hermetic recipe as shipped ("assoc", chunk 256:
    # plain torch but for its emission gather, which goes through the gather
    # pair as JAX's goes through its Pallas gather on the TPU) and under
    # "auto", which routes its 4,096-9,728 frames to the chunked CTC kernels
    "ctc_long_assoc": ("synthetic/long_ctx_assoc.json", ("gather_fwd",), ("gather_bwd",)),
    "ctc_long": ("synthetic/long_ctx_assoc.json", ("ctc_alpha",), ("gather_bwd", "ctc_grad")),
    # the speech recipe's TDS (4/8/16 channels x 5 blocks over 80 mel bins)
    "ctc_speech": ("librispeech/tds.json", ("ctc_alpha",), ("gather_bwd", "ctc_grad")),
    # CTC over wordpieces: TDS2d over 100 pieces, and TDS2dTransducer (TDS2d,
    # the WFST convolution over 200 pieces, TDS2d) over 1,000
    "ctc_wordpieces": ("word_pieces.json", ("ctc_alpha",), ("gather_bwd", "ctc_grad")),
    "convtrans": ("convtrans.json", ("ctc_alpha",), ("gather_bwd", "ctc_grad")),
    # the word-decomposition Transducer (1,000 pieces, no transitions: each
    # line's lattice marginalises over its pieces' decompositions of the
    # graphemes, scored by the dense scan) on TDS2d at a time stride of 16
    # over IAM-length lines, and on the speech recipe's TDS; and the IAM
    # word recipe's TDS2d (tds2d.json's strides, batch 128) with CTC
    "transducer_wordpieces": ("word_decomps.json", ("dense_scan_fwd",), ("dense_scan_bwd",)),
    "transducer_speech": ("librispeech/word_decomps.json", ("dense_scan_fwd",),
                          ("dense_scan_bwd",)),
    "ctc_words": ("tds2d_words.json", ("ctc_alpha",), ("gather_bwd", "ctc_grad")),
}
# the paths whose kernels launch exactly once per train step (backward
# kernels) or once per train step and evaluation batch (forward kernels):
# the word decompositions decode by the frames' argmax (no transitions),
# and every ctc_words batch lies under 4,096 frames
EXACT_LAUNCH_PATHS = ("transducer_wordpieces", "transducer_speech", "ctc_words")
# the paths whose step recipe_costs takes apart
RECIPE_PATHS = ("transducer_wordpieces", "transducer_speech", "ctc_words")
# a path's epochs: the recipe paths 2, ctc_long_assoc 2 (the seq phase
# trains it as shipped); the others 1, which no check of theirs needs a
# second for, to keep the smoke inside its time
EPOCHS = dict.fromkeys(RECIPE_PATHS + ("ctc_long_assoc",), 2)
# the paths whose lines run past 4,096 frames, where "auto" takes the chunk
# route: their CTC launches are counted exactly (chunked_ctc_expected_launches)
CHUNKED_PATHS = ("ctc_long",)
# the long-line corpus for the time stride of 16 of pruned_ngram_ctc.json;
# synthetic tones for the speech recipe, whose 1k-wordpiece token files are
# not in the repository (a hermetic config's own data stays as shipped)
DATASETS = {"transducer_backoff": "synthetic_long",
            "transducer_backoff_4gram": "synthetic_long",
            "ctc_speech": "synthetic_audio",
            "convtrans": "synthetic_long",
            "transducer_wordpieces": "synthetic_long",
            "transducer_speech": "synthetic_audio"}
# the wordpiece paths' inventories, whose token and lexicon files the
# configs name but the repository does not hold: path -> (pieces of the
# CTC inventory, pieces of the inner one of the model's WFST convolution).
# ``wordpiece_inventories`` trains them with the port's unigram trainer on
# WP_SENTENCES lines of the synthetic corpus (make_wordpieces' --text_file
# use; 6,000 lines hold 1,000 pieces, 2,000 only 999) and writes them with
# ``make_wordpieces.save_pieces``
WORDPIECES = {"ctc_wordpieces": (100, None), "convtrans": (1000, 200),
              "transducer_wordpieces": (1000, None), "transducer_speech": (1000, None)}
WP_SENTENCES, WP_SEED = 6000, 7
# what a path adds to its config: rnn.json has no optim.step_size, which the
# trainer reads (as JAX's does), so it takes the other IAM configs' 100;
# ctc_bf16 is tds2d.json with bf16 encoder compute
CONFIG_EDITS = {"ctc_rnn": {"optim": {"step_size": 100}},
                "ctc_bf16": {"model": {"dtype": "bfloat16"}},
                "ctc_long": {"criterion": {"impl": "auto"}}}
# the bf16 model's first-batch logits against the fp32 model's at the same
# weights: JAX's bound at a narrow width (tests/test_models.py,
# test_tds2d_bf16_compute) is 0.15, and JAX's own gap at tds2d.json's width
# is 0.26-0.29 (Flax TDS2d, two init seeds, 16 synthetic lines, jitted and
# op by op, on the CPU), so the bound here is 0.3; and the CTC loss's
# relative gap, the CPU test's bound
BF16_LOGITS_TOL = 0.3
BF16_LOSS_TOL = 0.01
SPLITS = {"train": 64, "validation": 16, "test": 16}  # synthetic split sizes
AUDIO_SPLITS = {"train": 48, "validation": 12, "test": 12}  # synthetic_audio's


def split_sizes(config):
    """The samples of each split a path's run reads: its dataset's, cut to
    the config's ``data.num_samples``."""
    sizes = AUDIO_SPLITS if config["data"]["dataset"] == "synthetic_audio" else SPLITS
    cap = config["data"].get("num_samples")
    return {k: min(v, cap) if cap else v for k, v in sizes.items()}


def wordpiece_file(kind, n):
    """The ``word_pieces_{kind}_{n}.txt`` file of ``wordpiece_inventories``."""
    return WORK / "wordpieces" / f"word_pieces_{kind}_{n}.txt"


def wordpiece_inventories():
    """The token and lexicon files of every inventory ``WORDPIECES`` names,
    trained by ``scripts.wordpiece.train_unigram`` on WP_SENTENCES lines of
    the synthetic corpus and written by ``make_wordpieces.save_pieces``,
    their vocabulary the words of the synthetic and synthetic_long
    splits.  Each inner inventory's pieces must fit the convolution's
    kernel (``ConvTransduce1D`` raises otherwise).  Returns the seconds."""
    from gtn_applications_tpu_torch import datasets
    from gtn_applications_tpu_torch.scripts import make_wordpieces, wordpiece

    t0 = time.perf_counter()
    (WORK / "wordpieces").mkdir(parents=True, exist_ok=True)
    pre = datasets.synthetic.Preprocessor(None, num_features=8)
    vocab = sorted({word for module in (datasets.synthetic, datasets.synthetic_long)
                    for split in SPLITS
                    for text in module.Dataset(None, pre, split=split).texts
                    for word in text.split("▁")})
    text = datasets.synthetic._make_corpus(WP_SENTENCES, WP_SEED)
    sizes = sorted({n for path_sizes in WORDPIECES.values() for n in path_sizes if n})
    for n in sizes:
        model = wordpiece.train_unigram(text, n)
        if len(model.log_probs) != n:
            raise AssertionError(f"the corpus holds {len(model.log_probs)} pieces, not {n}")
        make_wordpieces.save_pieces(model, n, str(WORK / "wordpieces" / "word_pieces"), vocab)
    seconds = time.perf_counter() - t0
    log(f"wordpiece inventories {sizes} over {WP_SENTENCES} lines, lexicon of "
        f"{len(vocab)} words: {seconds:.1f} s")
    return seconds


def path_preprocessor(data, config):
    """The path's preprocessor as ``train.load_experiment`` builds it: with
    the config's wordpiece tokens and lexicon where it names them."""
    return data.Preprocessor(None, num_features=config["data"]["num_features"],
                             tokens_path=config["data"].get("tokens"),
                             lexicon_path=config["data"].get("lexicon"))


def main_path_config(path):
    """The config's model and criterion sections unchanged (the backoff
    paths' transitions: the grapheme LM of ``LM_PRUNE``; the wordpiece
    paths' token and lexicon files, where the config names them: those of
    ``wordpiece_inventories``) but for ``CONFIG_EDITS``; synthetic data (a
    hermetic config's own, as shipped), its other data keys as shipped
    (``prepend_wordsep``; ``use_words``, which the synthetic lines keep as
    a flag, having no word images), ``EPOCHS`` epochs."""
    name = PATHS[path][0]
    with open(ROOT / "configs" / (name if "/" in name else f"iamdb/{name}")) as fid:
        base = json.load(fid)
    if "transitions" in base.get("criterion", {}):
        base["criterion"] = dict(base["criterion"],
                                 transitions=str(lm_transitions(LM_PRUNE[path])))
    edits = CONFIG_EDITS.get(path, {})
    data = {k: v for k, v in base["data"].items()
            if k not in ("data_path", "tokens", "lexicon")}
    data.update(dataset=DATASETS.get(path, "synthetic"),
                num_features=base["data"]["num_features"] if path in DATASETS else 64)
    if base["data"]["dataset"].startswith("synthetic"):
        data = {k: v for k, v in base["data"].items() if k != "data_path"}
    model = dict(base["model"], **edits.get("model", {}))
    if path in WORDPIECES:
        outer, inner = WORDPIECES[path]
        data.update({key: str(wordpiece_file(kind, outer))
                     for key, kind in (("tokens", "tokens"), ("lexicon", "lex"))
                     if key in base["data"]})
        if inner:
            model["tokens"] = str(wordpiece_file("tokens", inner))
    config = {
        "seed": 0,
        "data": data,
        "model_type": base["model_type"],
        "model": model,
        "criterion_type": base.get("criterion_type", "ctc"),
        "optim": dict(base["optim"], epochs=EPOCHS.get(path, 1), **edits.get("optim", {})),
    }
    if "criterion" in base or "criterion" in edits:
        config["criterion"] = dict(base.get("criterion", {}), **edits.get("criterion", {}))
    return config


def phase_main_path(torch, dev, path, config):
    from gtn_applications_tpu_torch import test as test_mod
    from gtn_applications_tpu_torch import train as train_mod
    from gtn_applications_tpu_torch.ops import _build

    work = WORK / path
    work.mkdir(parents=True, exist_ok=True)
    cfg = work / "config.json"
    cfg.write_text(json.dumps(config))
    args = train_mod.parse_args(["--config", str(cfg), "--checkpoint_path", str(work)])
    targs = test_mod.parse_args(
        ["--config", str(cfg), "--checkpoint_path", str(work), "--split", "test"]
    )

    _build.reset_launches()
    t0 = time.perf_counter()
    model, history = train_mod.train(args)
    meters = test_mod.run_test(targs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)

    epochs, batch = config["optim"]["epochs"], config["optim"]["batch_size"]
    sizes = split_sizes(config)
    steps = epochs * -(-sizes["train"] // batch)
    evals = epochs * -(-sizes["validation"] // batch) + -(-sizes["test"] // batch)
    for h in history:
        for key in ("train_loss", "val_loss", "val_cer", "val_wer"):
            if not math.isfinite(h[key]):
                raise AssertionError(f"{path} epoch {h['epoch']}: {key} = {h[key]}")
    if not (meters.num_samples == sizes["test"] and meters.num_tokens > 0
            and math.isfinite(meters.avg_loss) and math.isfinite(meters.cer)
            and math.isfinite(meters.wer)):
        raise AssertionError(f"{path} test split: {meters}")
    _, fwd, bwd = PATHS[path]
    exact = path in EXACT_LAUNCH_PATHS
    for name in set(launches) | set(fwd) | set(bwd):
        n = launches.get(name, 0)
        need = steps + evals if name in fwd else steps if name in bwd else 0
        if (n != need) if exact or not need else n < need:
            raise AssertionError(
                f"{path}: kernel {name} launched {n} times, expected "
                + (f"{'' if exact else '>= '}{need}" if need else "none (not on this path)"))
    if config.get("criterion", {}).get("impl") == "auto" and path in CHUNKED_PATHS:
        expected = chunked_ctc_expected_launches(torch, model, config)
        got = {name: launches.get(name, 0) for name in expected}
        if got != expected:
            raise AssertionError(f"{path}: CTC kernels launched {got}, expected {expected}")
    if path in LM_PRUNE:
        expected = backoff_expected_launches(config, steps, evals)
        for name, n in expected.items():
            if launches[name] != n:
                raise AssertionError(f"{path}: kernel {name} launched {launches[name]} "
                                     f"times, expected {n}")
    log(f"main path {path}: {seconds:.1f} s, history {json.dumps(history)}, "
        f"test loss {meters.avg_loss:.4f} CER {meters.cer:.2f} WER {meters.wer:.2f}, "
        f"launches {json.dumps(launches)}")
    return {"model": model, "launches": launches, "history": history,
            "seconds": seconds, "steps": steps, "evals": evals,
            "test": {"loss": meters.avg_loss, "cer": meters.cer, "wer": meters.wer}}


def chunked_ctc_expected_launches(torch, model, config):
    """The CTC kernels' launches on a path whose criterion takes "auto" over
    long lines: a batch of T frames (the model's output on it) past 4,096
    goes the chunk route, nc = len(chunk_spans(T, chunk)) calls, and a
    train step launches 2 nc of #1 (the forward and the backward's
    recompute), nc of #2 and one #4, an evaluation batch nc of #1; a batch
    of at most 4,096 frames one of each.  The batches are the trainer's
    and the test's (an epoch only permutes their order, and synthetic data
    has no augmentation that changes a width)."""
    from gtn_applications_tpu_torch import datasets, utils
    from gtn_applications_tpu_torch.ops import lattice
    from gtn_applications_tpu_torch.ops import lattice_pallas as lp_mod

    data = getattr(datasets, config["data"]["dataset"])
    pre = path_preprocessor(data, config)
    chunk = config["criterion"].get("chunk") or lattice._CHUNK
    dev = next(model.parameters()).device

    def calls(split):
        ds = data.Dataset(None, pre, split=split, augment=split == "train")
        out = []
        for inputs, _, _ in utils.data_loader(ds, config, seed=config["seed"]):
            with torch.no_grad():
                t = model(torch.as_tensor(inputs, dtype=torch.float32, device=dev)).shape[1]
            out.append(len(lp_mod.chunk_spans(t, chunk)) if t > lattice._MAX_WHOLE_T else 0)
        return out

    epochs = config["optim"]["epochs"]
    train, evals = calls("train"), calls("validation") * epochs + calls("test")
    return {"ctc_alpha": epochs * sum(2 * nc or 1 for nc in train)
            + sum(nc or 1 for nc in evals),
            "ctc_grad": epochs * sum(nc or 1 for nc in train),
            "gather_bwd": epochs * len(train)}


def backoff_expected_launches(config, steps, evals):
    """The kernels' launches on a backoff path: per loss two whole sparse
    scans (the composed tables and the normaliser) and one seg_lse per
    round of each table's start closure (its eps_depth, 0 without epsilon
    arcs); the backward kernels once per train step; the decode of every
    batch (each train step's and each evaluation batch's) one whole-scan
    Viterbi where its bucket plan takes the decode table, else one
    seg_max_scan; seg_max (the single step) never.  Closure depths are
    read from ``prepare`` of the sampler's fixed batches (an epoch only
    permutes their order)."""
    import torch

    from gtn_applications_tpu_torch import datasets, utils
    from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp

    data = getattr(datasets, config["data"]["dataset"])
    pre = path_preprocessor(data, config)
    crit, _ = utils.load_criterion(config["criterion_type"], pre, config["criterion"])
    depth = lambda t: t.eps_depth if t.eps_src.shape[-1] else 0  # noqa: E731
    norm = depth(crit._norm_table)
    rounds = {}
    for split in SPLITS:
        ds = data.Dataset(None, pre, split=split)
        batches = utils.BatchSortedSampler(ds, config["optim"]["batch_size"]).batches
        rounds[split] = sum(depth(crit.prepare([ds[i][1] for i in b])["table"]) + norm
                            for b in batches)
    epochs = config["optim"]["epochs"]
    expected = {"sparse_scan_fwd": 2 * (steps + evals), "sparse_scan_bwd": 2 * steps,
                "seg_lse_fwd": epochs * (rounds["train"] + rounds["validation"])
                + rounds["test"],
                "seg_lse_bwd": epochs * rounds["train"], "seg_max": 0}
    table = crit._decode_table({"transitions": torch.zeros(crit.num_transition_arcs)})
    whole = vsp.build_plan(table) is not None
    expected.update(seg_max_scan=0 if whole else steps + evals,
                    viterbi_scan_fwd=steps + evals if whole else 0,
                    viterbi_backtrace=steps + evals if whole else 0)
    return expected


def first_batch(torch, config, path, split="train", n=None):
    """The trainer's first batch of ``split`` (its first ``n`` samples),
    its criterion (with the trained parameters of the path's checkpoint)
    and its prepared targets."""
    from gtn_applications_tpu_torch import datasets, utils

    data = getattr(datasets, config["data"]["dataset"])
    pre = path_preprocessor(data, config)
    dataset = data.Dataset(None, pre, split=split, augment=split == "train")
    loader = utils.data_loader(dataset, config, seed=config["seed"])
    inputs, _, targets = next(iter(loader))
    crit, _ = utils.load_criterion(config["criterion_type"], pre,
                                   config.get("criterion", {}))
    state = utils.load_checkpoint(str(WORK / path), load_last=True)
    crit.params = state["criterion"]
    return inputs[:n], crit, crit.prepare(targets[:n])


def card_vs_cpu(torch, dev, crit, logits, prepared, tol_loss, tol_grad, path, exact=None):
    """The criterion's loss and gradients (logits, and its parameters) on
    the card against the CPU on the same logits.  With ``exact`` (a
    function of the logits giving the loss in float64), the logit gradient
    is held within tol_grad or, where that is larger, within the CPU's own
    float32 error against float64: at a CTC path's T of 512 frames and
    1,001 classes, float32 itself is ~1e-6 off (the CPU's route 4.9e-7 to
    8.4e-6 over eight trained models, ``repeat_convtrans_checks``, the
    card's within 1.3x of it), so two float32 routes agree only to about
    that."""
    from gtn_applications_tpu_torch.train import to_device

    def loss_and_grads(device):
        x = logits.detach().to(device).clone().requires_grad_(True)
        params = {k: v.detach().to(device).clone().requires_grad_(True)
                  for k, v in crit.params.items()}
        loss = crit.loss(params, x, to_device(prepared, device))
        grads = torch.autograd.grad(loss, [x] + list(params.values()))
        return float(loss.detach()), [g.cpu() for g in grads]

    loss_g, grads_g = loss_and_grads(dev)
    loss_c, grads_c = loss_and_grads(torch.device("cpu"))
    d_loss = abs(loss_g - loss_c)
    d_grads = [float((a - b).abs().max()) for a, b in zip(grads_g, grads_c)]
    names = ["logit"] + list(crit.params)
    tols = [tol_grad] * len(names)
    more, note = {}, ""
    if exact is not None:
        x = logits.detach().cpu().double().requires_grad_(True)
        loss_x = exact(x)
        (grad_x,) = torch.autograd.grad(loss_x, [x])
        loss_x = float(loss_x.detach())
        err_c = float((grads_c[0].double() - grad_x).abs().max())
        err_g = float((grads_g[0].double() - grad_x).abs().max())
        tols[0] = max(tol_grad, err_c)
        note = (f" (bound {tols[0]:.3g}: against float64, the CPU's logit grad max|d| "
                f"{err_c:.3g}, the card's {err_g:.3g}; loss the CPU's "
                f"{abs(loss_c - loss_x):.3g}, the card's {abs(loss_g - loss_x):.3g})")
        more = {f"{path}_cpu_vs_cpu64_logit_grad_max_abs_diff": err_c,
                f"{path}_card_vs_cpu64_logit_grad_max_abs_diff": err_g}
    log(f"main batch {path} {list(logits.shape)}: loss {loss_g:.6f} card vs cpu "
        f"|d| {d_loss:.3g}, "
        + ", ".join(f"{n} grad max|d| {d:.3g}" for n, d in zip(names, d_grads)) + note)
    if not (d_loss <= tol_loss and all(d <= t for d, t in zip(d_grads, tols))):
        raise AssertionError(f"{path}: the card and the CPU disagree on the main batch")
    return {f"{path}_card_vs_cpu_loss_abs_diff": d_loss, **more,
            **{f"{path}_card_vs_cpu_{n}_grad_max_abs_diff": d
               for n, d in zip(names, d_grads)}}


def ctc_loss_exact(torch, crit, prepared, logits):
    """The CTC criterion's loss on CPU logits in float64: the plain
    recursion (impl "scan"), which keeps the dtype (the kernel Function
    computes in float32)."""
    from gtn_applications_tpu_torch.ops import lattice

    targets, lengths = prepared
    return lattice.ctc_loss(torch.log_softmax(logits, 2), targets.cpu(), lengths.cpu(),
                            crit.blank, "mean", None, "scan")


def phase_main_batch(torch, dev, model, config, path="ctc"):
    """A CTC trainer's first batch through the trained model: the model
    on the card against the CPU, the CTC loss and logit gradient on the
    card against the CPU on the same logits, and the four kernels against
    their plain versions on the inputs the train step gives them (no input
    lengths, as the config sets none: every frame is live).  The results'
    keys name the path, but for ``ctc``."""
    import copy

    inputs, crit, prepared = first_batch(torch, config, path)
    cpu_model = copy.deepcopy(model).cpu()
    with torch.no_grad():
        logits = model(torch.from_numpy(inputs).to(dev))
        d_out = float((logits.cpu() - cpu_model(torch.from_numpy(inputs))).abs().max())
    log(f"main batch {path}: card vs cpu logits max|d| {d_out:.3g}")
    if not d_out <= 1e-3:
        raise AssertionError(f"{path}: the card and the CPU disagree on the logits")
    diffs = card_vs_cpu(torch, dev, crit, logits, prepared, 1e-4, 1e-6, path,
                        exact=functools.partial(ctc_loss_exact, torch, crit, prepared))

    tgts, tl = (p.to(dev) for p in prepared)
    lp, labels, start, accept, skip = ctc_kernel_inputs(torch, logits, tgts, tl, crit.blank)
    bsz, frames = logits.shape[:2]
    il = torch.full((bsz,), frames, dtype=torch.int32, device=dev)
    g = -1.0 / (bsz * tl.to(torch.float32).clamp(min=1))
    what = (bsz, frames, tgts.shape[1], logits.shape[2])
    errs, grad = hold_ctc_kernels(torch, lp, labels, start, accept, skip, il, g, what)
    merge_errs(errs, hold_gather_kernels(torch, lp, labels, grad, what))
    prefix = "" if path == "ctc" else f"{path}_"
    return errs, dict(diffs, **{f"{prefix}card_vs_cpu_logits_max_abs_diff": d_out,
                                f"{prefix}main_batch_shape": list(what)})


# ConvTransduce1D on the card against the CPU on the same input: scores
# within CONV_ATOL + CONV_RTOL |s|, the input's gradient entry by entry
# within CONV_GRAD_ATOL + CONV_GRAD_RTOL |g| (the CPU tests' bound against
# JAX): a K-step recursion of logsumexps, whose exp and log differ by an
# ulp or two between the card and the CPU
CONV_ATOL, CONV_RTOL = 1e-5, 1e-5
CONV_GRAD_ATOL, CONV_GRAD_RTOL = 1e-5, 1e-4


def conv_route(conv, x):
    """The route ``conv_transduce_scores`` takes for ``conv`` on input x
    [B, T, C]: "chunked" past its threshold with more than 128 entries."""
    from gtn_applications_tpu_torch.ops import convkernel

    W = (x.shape[1] - 1) // conv.stride + 1
    return convkernel.route(x.shape[0], W, conv.kernel_size, *conv.tables.label.shape)


@contextlib.contextmanager
def conv_route_forced(route):
    """``conv_transduce_scores`` forced to ``route``: its threshold set to
    infinity ("direct") or 0 ("chunked")."""
    from gtn_applications_tpu_torch.ops import convkernel

    threshold = convkernel._CHUNK_THRESHOLD
    convkernel._CHUNK_THRESHOLD = float("inf") if route == "direct" else 0
    try:
        yield
    finally:
        convkernel._CHUNK_THRESHOLD = threshold


def phase_main_batch_convtrans(torch, dev, model, config):
    """The convtrans path's first batch: phase_main_batch's checks (the
    whole model's logits card against CPU, the CTC loss and gradient, the
    CTC kernels against their plain versions), then the model's
    ConvTransduce1D on the card against the CPU on the same input (its
    first encoder's output on the card), ``hold_conv_card_vs_cpu``."""
    errs, diffs = phase_main_batch(torch, dev, model, config, "convtrans")
    inputs, _, _ = first_batch(torch, config, "convtrans")
    with torch.no_grad():
        x = model.tds1(torch.from_numpy(inputs).to(dev))
    return errs, dict(diffs, **hold_conv_card_vs_cpu(torch, dev, model.conv, x))


def hold_conv_card_vs_cpu(torch, dev, conv, x):
    """ConvTransduce1D ``conv`` on the card against the CPU on the same
    input x (on the card), by the route x takes and by the other: its
    scores and the gradient of its input for a seeded cotangent, each
    within the CONV_* bounds or, where that is larger, within the CPU's
    own float32 error against the layer in float64 on the CPU (the
    gradient sums ~400 terms an entry, so a small entry's absolute error
    is float32's summation floor: the CPU's 1.2e-6 to 5.1e-6 past 1e-4 |g|
    over eight trained models, ``repeat_convtrans_checks``); the two
    routes on the card agree to the CONV_* bounds."""
    import copy

    cpu_conv = copy.deepcopy(conv).cpu()
    exact_conv = copy.deepcopy(conv).cpu().double()

    def scores_and_grad(layer, device, dtype=torch.float32):
        xi = x.detach().to(device, dtype).requires_grad_(True)
        out = layer(xi)
        cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
        out.backward(cot.to(device, dtype))
        return out.detach().cpu().double(), xi.grad.cpu().double()

    def excess(got, ref, rtol):
        return float(((got - ref).abs() - rtol * ref.abs()).max())

    taken = conv_route(conv, x)
    out_x, grad_x = scores_and_grad(exact_conv, torch.device("cpu"), torch.float64)
    card, diffs = {}, {}
    for route in (taken, "chunked" if taken == "direct" else "direct"):
        with conv_route_forced(route):
            card[route] = scores_and_grad(conv, dev)
            out_c, grad_c = scores_and_grad(cpu_conv, torch.device("cpu"))
        out_g, grad_g = card[route]
        d_out, d_grad = excess(out_g, out_c, CONV_RTOL), excess(grad_g, grad_c, CONV_GRAD_RTOL)
        f_out, f_grad = excess(out_c, out_x, CONV_RTOL), excess(grad_c, grad_x, CONV_GRAD_RTOL)
        b_out, b_grad = max(CONV_ATOL, f_out), max(CONV_GRAD_ATOL, f_grad)
        log(f"main batch convtrans: ConvTransduce1D {list(x.shape)} -> {list(out_g.shape)}, "
            f"route {route}{' (the batch takes it)' if route == taken else ''}, card vs "
            f"cpu: scores |d| - {CONV_RTOL:g}|s| max {d_out:.3g} (bound {b_out:.3g}), "
            f"input grad |d| - {CONV_GRAD_RTOL:g}|g| max {d_grad:.3g} (bound {b_grad:.3g}); "
            f"against float64 the CPU's {f_out:.3g} and {f_grad:.3g}, the card's "
            f"{excess(out_g, out_x, CONV_RTOL):.3g} and "
            f"{excess(grad_g, grad_x, CONV_GRAD_RTOL):.3g}")
        if not (d_out <= b_out and d_grad <= b_grad
                and torch.isfinite(out_g).all() and torch.isfinite(grad_g).all()):
            raise AssertionError(f"convtrans: the card and the CPU disagree on "
                                 f"ConvTransduce1D's {route} route")
        diffs[f"convtrans_conv_{route}_card_vs_cpu_excess"] = d_out
        diffs[f"convtrans_conv_{route}_grad_card_vs_cpu_excess"] = d_grad
        diffs[f"convtrans_conv_{route}_cpu_vs_cpu64_excess"] = [f_out, f_grad]
    d_out = excess(card["chunked"][0], card["direct"][0], CONV_RTOL)
    d_grad = excess(card["chunked"][1], card["direct"][1], CONV_GRAD_RTOL)
    log(f"main batch convtrans: ConvTransduce1D on the card, chunked vs direct: scores "
        f"{d_out:.3g}, input grad {d_grad:.3g} (bounds {CONV_ATOL:g}, {CONV_GRAD_ATOL:g})")
    if not (d_out <= CONV_ATOL and d_grad <= CONV_GRAD_ATOL):
        raise AssertionError("convtrans: ConvTransduce1D's routes disagree on the card")
    return dict(diffs, convtrans_conv_routes_excess=[d_out, d_grad],
                convtrans_conv_shape=list(card[taken][0].shape),
                convtrans_conv_route=taken)


def convtrans_times(torch, dev, model, config, step_ms):
    """ConvTransduce1D's forward and forward+backward (CUDA events, median
    of 10) on its first encoder's output for ``time_train_step``'s batch,
    by the route that batch takes and by the other one, and the share of
    the path's train step (``step_ms``) the taken route's fwd+bwd is."""
    from gtn_applications_tpu_torch import datasets, utils

    data = getattr(datasets, config["data"]["dataset"])
    ds = data.Dataset(None, path_preprocessor(data, config), split="train")
    inputs, _, _ = utils.padding_collate(
        [ds[i] for i in range(config["optim"]["batch_size"])])
    with torch.no_grad():
        x = model.tds1(torch.from_numpy(inputs).to(dev))
        cot = torch.randn_like(model.conv(x))
    route = conv_route(model.conv, x)

    def fwd():
        return model.conv(x.detach().requires_grad_(True))

    def fwd_bwd():
        fwd().backward(cot)

    out = {}
    for name in (route, "chunked" if route == "direct" else "direct"):
        with conv_route_forced(name):
            out[f"{name}_fwd_ms"] = gpu_median_ms(torch, fwd, runs=10, warmup=2)
            out[f"{name}_fwd_bwd_ms"] = gpu_median_ms(torch, fwd_bwd, runs=10, warmup=2)
    out.update(route=route, shape=list(x.shape), train_step_ms=step_ms,
               share=out[f"{route}_fwd_bwd_ms"] / step_ms)
    return out


def phase_main_batch_asg(torch, dev, model, config):
    """The ASG trainer's first batch: loss, logit and transitions gradients
    on the card against the CPU, and the backtrace kernel on the decode's
    backpointers; the gather kernels on the force-aligned emissions."""
    from gtn_applications_tpu_torch.ops import lattice

    inputs, crit, prepared = first_batch(torch, config, "asg")
    with torch.no_grad():
        logits = model(torch.from_numpy(inputs).to(dev))
    diffs = card_vs_cpu(torch, dev, crit, logits, prepared, 1e-4, 1e-5, "asg")
    trans = crit.params["transitions"].to(dev)
    bp, last, _ = lattice.asg_viterbi_backpointers(logits, trans)
    what = tuple(logits.shape)
    errs = hold_dense_bt(torch, bp.contiguous(), last.contiguous(), what)
    targets = prepared[0].to(dev).to(torch.int32).contiguous()
    g = torch.rand(logits.shape[0], logits.shape[1], targets.shape[1], device=dev)
    merge_errs(errs, hold_gather_kernels(torch, logits.contiguous(), targets, g, what))
    return errs, dict(diffs, asg_main_batch_shape=list(what))


def phase_main_batch_stc(torch, dev, model, config):
    """The STC trainer's first batch: loss and logit gradient on the card
    against the CPU, and both dense-scan kernels on its inputs."""
    from gtn_applications_tpu_torch.train import to_device

    inputs, crit, prepared = first_batch(torch, config, "stc")
    with torch.no_grad():
        logits = model(torch.from_numpy(inputs).to(dev))
    diffs = card_vs_cpu(torch, dev, crit, logits, prepared, 1e-4, 1e-5, "stc")
    scan_inputs = dense_scan_inputs(torch, crit, logits, to_device(prepared, dev))
    bsz, frames = logits.shape[:2]
    il = torch.full((bsz,), frames, dtype=torch.int32, device=dev)
    what = (bsz, frames, scan_inputs[0].shape[2])
    errs = hold_dense_scan_kernels(torch, *scan_inputs, il, what)
    return errs, dict(diffs, stc_main_batch_shape=list(what))


def word_decomp_scan_inputs(torch, logits, prepared):
    """The dense scan's inputs as the transitions-free Transducer's loss
    builds them: em_state [B, T, S] (log_softmax of the logits contracted
    with each state's in-label, ``ops/factored.py``'s einsum), adj [B, S,
    S], start, has_lab and accept [B, S]."""
    f = prepared["factored"]
    em = torch.log_softmax(logits, dim=2)
    em_state = torch.einsum("btn,bsn->bts", em, f["lab_oh"])
    has_lab = (f["lab_oh"].sum(-1) > 0).to(torch.float32)
    return (em_state.contiguous(), f["adj_exp"].contiguous(), f["start"].contiguous(),
            has_lab.contiguous(), f["accept"])


def phase_main_batch_word_decomps(torch, dev, model, config, path):
    """A word-decomposition Transducer trainer's first batch: loss and logit
    gradient on the card against the CPU (1e-4, 1e-5), and both dense-scan
    kernels on the inputs its loss gives them (``floor32``: at T = 576
    each float32 backward lies ~1e-5 from float64)."""
    from gtn_applications_tpu_torch.train import to_device

    inputs, crit, prepared = first_batch(torch, config, path)
    if "factored" not in prepared or crit.transitions is not None:
        raise AssertionError(f"{path}: the batch is not the dense scan's ({sorted(prepared)})")
    with torch.no_grad():
        logits = model(torch.from_numpy(inputs).to(dev))
    diffs = card_vs_cpu(torch, dev, crit, logits, prepared, 1e-4, 1e-5, path)
    scan_inputs = word_decomp_scan_inputs(torch, logits, to_device(prepared, dev))
    bsz, frames = logits.shape[:2]
    il = torch.full((bsz,), frames, dtype=torch.int32, device=dev)
    what = (path, bsz, frames, scan_inputs[0].shape[2], logits.shape[2])
    errs = hold_dense_scan_kernels(torch, *scan_inputs, il, what, floor32=True)
    return errs, dict(diffs, **{f"{path}_main_batch_shape": list(what[1:]),
                                f"{path}_max_target": int(prepared["target_lengths"].max())})


def recipe_costs(torch, dev, card, path, model, config):
    """What a recipe path's train step is made of, on the first train batch
    at the config's batch: ``prepare`` of the batch (host clock; the first
    call on a new criterion, which compiles each line's lattice, and the
    median of 10 on a warm cache), the train step's peak memory, and for
    the word decompositions the einsum before the dense scan
    (``ops/factored.py``, TF32 off: forward and forward+backward, CUDA
    events, median of 30, against its bound: the three tensors once, 2 B T
    S N operations) and the dense pair at the batch's shapes with its
    bound by real arcs (``dense_bounds``)."""
    from gtn_applications_tpu_torch import datasets, utils
    from gtn_applications_tpu_torch import train as train_mod
    from gtn_applications_tpu_torch.ops import dense_scan_pallas as dsp

    data = getattr(datasets, config["data"]["dataset"])
    pre = path_preprocessor(data, config)
    ds = data.Dataset(None, pre, split="train")
    optim = config["optim"]
    inputs, _, tgts = utils.padding_collate(
        [ds[i % len(ds)] for i in range(optim["batch_size"])])
    crit, _ = utils.load_criterion(config["criterion_type"], pre, config.get("criterion", {}))
    t0 = time.perf_counter()
    prepared = crit.prepare(tgts)
    out = {"prepare_cold_ms": (time.perf_counter() - t0) * 1e3}
    warm = []
    for _ in range(10):
        t0 = time.perf_counter()
        crit.prepare(tgts)
        warm.append((time.perf_counter() - t0) * 1e3)
    out["prepare_ms"] = statistics.median(warm)
    train_mod.criterion_to_device(crit, dev)
    x = torch.from_numpy(inputs).to(dev)
    step = train_mod.make_train_step(model, crit, optim["learning_rate"],
                                     optim.get("crit_learning_rate", optim["learning_rate"]),
                                     optim.get("max_grad_norm"))
    gen = torch.Generator(device=dev).manual_seed(0)
    on_dev = train_mod.to_device(prepared, dev)
    step(x, on_dev, gen, 1.0)
    _, out["step_peak_bytes"] = with_peak(torch, lambda: step(x, on_dev, gen, 1.0))
    out["batch"] = list(inputs.shape)
    line = (f"[{card}] {path} batch {out['batch']}: prepare {out['prepare_ms']:.3f} ms "
            f"(median of 10; first call {out['prepare_cold_ms']:.1f} ms), train step peak "
            f"{out['step_peak_bytes'] / 2**20:.1f} MiB")
    if "factored" in prepared:
        with torch.no_grad():
            logits = model(x)
        em = torch.log_softmax(logits, dim=2)
        lab_oh = on_dev["factored"]["lab_oh"]
        b, t, n = em.shape
        S = lab_oh.shape[1]
        em_req = em.detach().clone().requires_grad_(True)
        g = torch.randn(b, t, S, device=dev)

        def fwd():
            return torch.einsum("btn,bsn->bts", em, lab_oh)

        def fwd_bwd():
            y = torch.einsum("btn,bsn->bts", em_req, lab_oh)
            return torch.autograd.grad(y, em_req, g)

        out["einsum_fwd_ms"] = gpu_median_ms(torch, fwd)
        out["einsum_fwd_bwd_ms"] = gpu_median_ms(torch, fwd_bwd)
        out["einsum_bound_ms"], out["einsum_bound_by"] = bound_ms(
            (b * t * n + b * S * n + b * t * S) * 4, 2 * b * t * S * n)
        out["einsum_tf32"] = bool(torch.backends.cuda.matmul.allow_tf32)
        em_s, adj, st, has, acc = word_decomp_scan_inputs(torch, logits, on_dev)
        il = torch.full((b,), t, dtype=torch.int32, device=dev)
        traj = dsp.dense_scan_fwd_cuda(em_s, adj, st, has, il)
        gf = score_cotangent(torch, traj[:, -1], acc)
        out["dense_scan_fwd_ms"] = gpu_median_ms(
            torch, lambda: dsp.dense_scan_fwd_cuda(em_s, adj, st, has, il))
        out["dense_scan_bwd_ms"] = gpu_median_ms(torch, lambda: dsp.dense_scan_bwd_cuda(
            traj, adj, st, has, il, gf, need_dadj=False))
        forms = dense_bounds(em_s, adj, has, il)
        out["dense_scan_fwd_bound"], out["dense_scan_bwd_bound"] = forms["fwd"], forms["bwd"]
        out["dense_S"], out["dense_routes"] = S, dense_routes(torch, adj, has, il)
        line += (f"; einsum [{b}, {t}, {n}] x [{b}, {S}, {n}] fwd {out['einsum_fwd_ms']:.4f} "
                 f"ms, fwd+bwd {out['einsum_fwd_bwd_ms']:.4f} ms (bound "
                 f"{out['einsum_bound_ms']:.4f} ms by {out['einsum_bound_by']}, TF32 "
                 f"{out['einsum_tf32']}); dense pair S={S}: fwd {out['dense_scan_fwd_ms']:.4f} "
                 f"ms (bound {forms['fwd'][0]:.5f}), bwd {out['dense_scan_bwd_ms']:.4f} ms "
                 f"(bound {forms['bwd'][0]:.5f}) (CUDA events, median of 30)")
    log(line)
    return out


def phase_main_batch_transducer(torch, dev, model, config):
    """The Transducer trainer's first batch: loss, logit and transitions
    gradients on the card against the CPU; both factored-scan kernels on
    the inputs its loss gives them, and the whole-scan Viterbi (the scan
    alone and the decode) on its decode's plan."""
    from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp
    from gtn_applications_tpu_torch.train import to_device

    inputs, crit, prepared = first_batch(torch, config, "transducer")
    with torch.no_grad():
        logits = model(torch.from_numpy(inputs).to(dev))
    diffs = card_vs_cpu(torch, dev, crit, logits, prepared, 1e-4, 1e-5, "transducer")
    params = {k: v.to(dev) for k, v in crit.params.items()}
    scan_inputs = factored_inputs(torch, crit, logits, to_device(prepared, dev), params)
    bsz, frames = logits.shape[:2]
    il = torch.full((bsz,), frames, dtype=torch.int32, device=dev)
    what = (bsz, frames, scan_inputs[0].shape[2], crit.num_channels)
    errs = hold_factored_scan_kernels(torch, *scan_inputs, il, what)
    plan = vsp.build_plan(crit._decode_table(params))
    merge_errs(errs, hold_viterbi_kernels(torch, logits.contiguous(), *plan.to(dev),
                                          il, ("decode",) + what,
                                          packed=plan.packed(dev)))
    return errs, dict(diffs, transducer_main_batch_shape=list(what),
                      transducer_decode_plan=[plan.D, plan.S])


def card_vs_cpu64(torch, dev, crit, logits, prepared, path):
    """The criterion's loss and gradients (logits and its parameters) on
    the card, in float32, against the CPU's plain route in float64 on the
    same logits and parameters: the loss within 1e-4, each gradient within
    1e-3 of its largest entry.  float64 on the CPU because at this path's T
    of ~600 frames of raw logits the scores reach ~4,000, where the CPU's
    float32 route itself is ~1e-3 off in the loss.  1e-3, not 1e-5: the
    card's float32 forward trajectory carries its rounding over those ~600
    frames into the posteriors (the backward itself runs in float64); the
    logit gradient measured 9.7e-6 to 6.0e-5 of its largest entry across
    runs, whose trained models (and so logits) differ through cuDNN's
    nondeterministic weight gradients.  Each gradient is a difference of
    the normaliser's and the composed lattice's posteriors, so its small
    entries are cancellations: the entry-by-entry rule is the kernels' (in
    hold_sparse_kernels), not the criterion's."""
    from gtn_applications_tpu_torch.train import to_device

    def loss_and_grads(device, dtype):
        x = logits.detach().to(device, dtype).clone().requires_grad_(True)
        params = {k: v.detach().to(device, dtype).clone().requires_grad_(True)
                  for k, v in crit.params.items()}
        loss = crit.loss(params, x, to_device(prepared, device))
        grads = torch.autograd.grad(loss, [x] + list(params.values()))
        return float(loss.detach()), [g.cpu() for g in grads]

    loss_g, grads_g = loss_and_grads(dev, torch.float32)
    loss_c, grads_c = loss_and_grads(torch.device("cpu"), torch.float64)
    d_loss = abs(loss_g - loss_c)
    names = ["logit"] + list(crit.params)
    rels = [float((a.double() - b).abs().max() / b.abs().max())
            for a, b in zip(grads_g, grads_c)]
    log(f"main batch {path} {list(logits.shape)}: loss {loss_g:.6f} card vs cpu (float64) "
        f"|d| {d_loss:.3g}, "
        + ", ".join(f"{n} grad max|d| / max|p| {r:.3g}" for n, r in zip(names, rels)))
    if not (d_loss <= 1e-4 and all(r <= 1e-3 for r in rels)):
        raise AssertionError(f"{path}: the card and the CPU disagree on the main batch")
    return {f"{path}_card_vs_cpu64_loss_abs_diff": d_loss,
            **{f"{path}_card_vs_cpu64_{n}_grad_rel_err": r for n, r in zip(names, rels)}}


def phase_main_batch_backoff(torch, dev, model, config):
    """The backoff Transducer trainer's first batch: loss, logit and
    transitions gradients on the card against the CPU (float64); the sparse
    kernels on the tables and logits of its loss, and the whole-scan
    Viterbi (the scan alone and the decode) on its decode's plan."""
    from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp

    path = "transducer_backoff"
    inputs, crit, prepared = first_batch(torch, config, path)
    with torch.no_grad():
        logits = model(torch.from_numpy(inputs).to(dev))
    diffs = card_vs_cpu64(torch, dev, crit, logits, prepared, path)
    params = crit.params["transitions"].to(dev)
    tables = transducer_tables(torch, dev, crit, prepared, params)
    bsz, frames = logits.shape[:2]
    il = torch.full((bsz,), frames, dtype=torch.int32, device=dev)
    errs = {}
    for key in ("score", "norm"):
        merge_errs(errs, hold_sparse_kernels(torch, logits.contiguous(), tables[key], il,
                                             ("main batch " + key, bsz, frames)))
    plan = vsp.build_plan(crit._decode_table({"transitions": params}))
    what = (bsz, frames, crit.num_channels)
    merge_errs(errs, hold_viterbi_kernels(torch, logits.contiguous(), *plan.to(dev),
                                          il, ("backoff decode",) + what,
                                          packed=plan.packed(dev)))
    shapes = {key: [int(tables[key].start.shape[-1]), int(tables[key].src.shape[-1]),
                    int(tables[key].eps_src.shape[-1]), tables[key].eps_depth]
              for key in tables}
    return errs, dict(diffs, transducer_backoff_main_batch_shape=list(what),
                      transducer_backoff_tables_S_A_E_depth=shapes,
                      transducer_backoff_decode_plan=[plan.D, plan.S])


def phase_main_batch_backoff_4gram(torch, dev, model, config):
    """The 4-gram backoff trainer's first batch: loss, logit and
    transitions gradients on the card against the CPU (float64) on its
    first 8 samples and 96 frames (the CPU's float64 plain route through
    the 4-gram's normaliser, S=1,058 and closure depth 4, takes minutes on
    the whole batch); the sparse kernels on the whole batch's tables and
    logits; the decode of the first validation batch on the card (one
    seg_max_scan launch) against the CPU route, labels exactly, scores
    within 1e-6; and seg_max_scan against its plain version on the whole
    batch's decode."""
    from gtn_applications_tpu_torch.ops import _build, sparse
    from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp

    path = "transducer_backoff_4gram"
    inputs, crit, prepared = first_batch(torch, config, path)
    cut, _, cut_prepared = first_batch(torch, config, path, n=8)
    with torch.no_grad():
        logits = model(torch.from_numpy(inputs).to(dev))
        cut_logits = model(torch.from_numpy(cut).to(dev))[:, :96]
    diffs = card_vs_cpu64(torch, dev, crit, cut_logits, cut_prepared, path)
    params = crit.params["transitions"].to(dev)
    tables = transducer_tables(torch, dev, crit, prepared, params)
    bsz, frames = logits.shape[:2]
    il = torch.full((bsz,), frames, dtype=torch.int32, device=dev)
    errs = {}
    for key in ("score", "norm"):
        merge_errs(errs, hold_sparse_kernels(torch, logits.contiguous(), tables[key], il,
                                             ("4-gram main batch " + key, bsz, frames)))

    val_inputs, _, _ = first_batch(torch, config, path, split="validation")
    with torch.no_grad():
        val_logits = model(torch.from_numpy(val_inputs).to(dev))
    table = crit._decode_table(crit.params)
    if vsp.build_plan(table) is not None:
        raise AssertionError(f"{path}: the whole-scan plan takes the decode table")
    before = dict(_build.LAUNCHES)
    lab_k, score_k = sparse.viterbi_batch(val_logits, table, plans=crit._decode_plans)
    launched = {key: n - before[key] for key, n in _build.LAUNCHES.items() if n != before[key]}
    lab_p, score_p = sparse.viterbi_batch(val_logits.cpu(), table)
    if launched != {"seg_max_scan": 1}:
        raise AssertionError(f"{path}: the decode launched {launched}, not one seg_max_scan")
    if not torch.equal(lab_k.cpu(), lab_p):
        raise AssertionError(f"{path}: the decode's labels differ between the card and the CPU")
    d_score = float((score_k.cpu() - score_p).abs().max())
    if not d_score <= 1e-6:
        raise AssertionError(f"{path}: decode score max|d| {d_score}")
    log(f"4-gram decode of the first validation batch {list(val_logits.shape)}: labels equal "
        f"card vs cpu, score max|d| {d_score:.3g}, one seg_max_scan launch")
    # the kernel against its plain version on the train batch's decode
    merge_errs(errs, hold_segmax_scan(torch, logits.contiguous(), il, table,
                                      ("4-gram main batch decode", bsz, frames)))
    shapes = {key: [int(tables[key].start.shape[-1]), int(tables[key].src.shape[-1]),
                    int(tables[key].eps_src.shape[-1]), tables[key].eps_depth]
              for key in tables}
    return errs, dict(diffs, transducer_backoff_4gram_main_batch_shape=[bsz, frames],
                      transducer_backoff_4gram_cpu64_shape=list(cut_logits.shape),
                      transducer_backoff_4gram_tables_S_A_E_depth=shapes,
                      transducer_backoff_4gram_val_decode_shape=list(val_logits.shape),
                      transducer_backoff_4gram_val_decode_score_abs_diff=d_score)


def phase_bf16_gap(torch, dev, model, config, card):
    """The ctc_bf16 path's first train batch through its trained model, in
    bf16 and, at the same weights, in fp32: the logits fp32 either way,
    their max |d| within BF16_LOGITS_TOL and the CTC loss's relative gap
    within BF16_LOSS_TOL."""
    import copy

    from gtn_applications_tpu_torch.train import to_device

    inputs, crit, prepared = first_batch(torch, config, "ctc_bf16")
    model32 = copy.deepcopy(model)
    model32.dtype = torch.float32
    x, prepared = torch.from_numpy(inputs).to(dev), to_device(prepared, dev)
    with torch.no_grad():
        out16, out32 = model(x), model32(x)
        l16, l32 = (float(crit.loss(crit.params, o, prepared)) for o in (out16, out32))
    d_out = float((out16 - out32).abs().max())
    gap = abs(l16 - l32) / abs(l32)
    log(f"[{card}] main batch ctc_bf16 {list(out16.shape)}: bf16 against fp32 at the "
        f"same weights: logits max|d| {d_out:.4g} (bound {BF16_LOGITS_TOL}), loss "
        f"{l16:.6f} against {l32:.6f}, relative gap {gap:.4g} (bound {BF16_LOSS_TOL})")
    if out16.dtype != torch.float32:
        raise AssertionError(f"ctc_bf16: logits are {out16.dtype}, not float32")
    if not (d_out < BF16_LOGITS_TOL and gap < BF16_LOSS_TOL):
        raise AssertionError("ctc_bf16: bf16 compute strays from fp32 past its bound")
    return {"ctc_bf16_logits_max_abs_diff": d_out, "ctc_bf16_loss_rel_gap": gap,
            "ctc_bf16_loss": l16, "ctc_bf16_loss_fp32": l32}


# the paths whose train step takes most of a second: medians of 10 steps
# after 2, which keeps the smoke inside its time limit
SLOW_STEP_PATHS = ("transducer_backoff", "transducer_backoff_4gram", "ctc_long_assoc",
                   "transducer_wordpieces")


def step_runs(path):
    """(runs, warmup) of ``path``'s train-step median (of 10, which keeps
    the smoke inside its time limit)."""
    return (10, 2) if path in SLOW_STEP_PATHS else (10, 3)


def time_train_step(torch, dev, model, config, runs=20, warmup=5):
    """Host-clock median ms of ``runs`` full train steps (after
    ``warmup``) on the first batch of the train split, without
    augmentation."""
    from gtn_applications_tpu_torch import datasets, utils
    from gtn_applications_tpu_torch import train as train_mod

    data = getattr(datasets, config["data"]["dataset"])
    pre = path_preprocessor(data, config)
    ds = data.Dataset(None, pre, split="train")
    optim = config["optim"]
    # the config's batch (ctc_words' 128 takes the split's 64 lines twice)
    inputs, _, tgts = utils.padding_collate(
        [ds[i % len(ds)] for i in range(optim["batch_size"])])
    crit, _ = utils.load_criterion(config["criterion_type"], pre,
                                   config.get("criterion", {}))
    train_mod.criterion_to_device(crit, dev)
    x = torch.from_numpy(inputs).to(dev)
    step = train_mod.make_train_step(
        model, crit, optim["learning_rate"],
        optim.get("crit_learning_rate", optim["learning_rate"]),
        optim.get("max_grad_norm"),
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    step_ms = []
    for i in range(warmup + runs):
        prepared = train_mod.to_device(crit.prepare(tgts), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(x, prepared, gen, 1.0)
        torch.cuda.synchronize()
        if i >= warmup:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(step_ms), list(inputs.shape)


def scan_work(il, S, per_state, per_pair):
    """fp32 operations of the dense scan over the live frames of this
    run's inputs as PRs 2-10 counted them (kept for the log): per frame
    ``per_pair`` per (u, s) pair of the S x S products and ``per_state``
    per state."""
    frames = int(il.clamp(min=1).sum())
    return frames * (per_pair * S * S + per_state * S)


def dense_work(adj, has_lab, il, forward, with_dadj=False):
    """fp32 operations the dense scan needs over the live frames of this
    run's inputs, by what the function needs.  Per live frame and sample,
    with S states, S_l of them labelled and A real arcs into the labelled
    states: the shift (a max a state: S), each arc's term (sub, exp, mul,
    add: 4 A) and 6 per labelled state (log, floor, two adds, compare,
    select); the backward recomputes the shift and the sums with their
    reciprocals (S + 4 A + 2 S_l), and adds the chain's 3 an arc (two
    muls, an add), 3 a source (sub, exp, mul) and 3 per labelled state
    (dem's compare and select, dz's mul); the dense dadj (sub, exp, mul,
    add per labelled state and s: 4 S_l S) only ``with_dadj``."""
    S = adj.shape[1]
    has = has_lab > 0
    s_lab = has.sum(1).double()
    arcs = ((adj != 0) & has[:, :, None]).sum((1, 2)).double()
    frames = il.clamp(min=1).double()
    if forward:
        per = S + 4 * arcs + 6 * s_lab
    else:
        per = (S + 4 * arcs + 2 * s_lab) + 3 * arcs + 3 * S + 3 * s_lab
        if with_dadj:
            per = per + 4 * s_lab * S
    return float((frames * per).sum())


def dense_bounds(em_state, adj, has_lab, il):
    """{form: (ms, by)} of the dense pair on these inputs: the forward,
    the backward without dadj (the main paths') and with it.  Bytes: each
    input once (em or traj on the live frames only), each output once;
    operations: ``dense_work``."""
    b, t, S = em_state.shape
    live = int(il.clamp(min=1).sum()) * S * 4
    mat, vec = b * S * S * 4, b * S * 4
    rows = live + mat + b * 4 + b * t * S * 4
    return {
        "fwd": bound_ms(rows + 2 * vec, dense_work(adj, has_lab, il, True)),
        "bwd": bound_ms(rows + 3 * vec, dense_work(adj, has_lab, il, False)),
        "bwd_with_dadj": bound_ms(rows + 3 * vec + mat,
                                  dense_work(adj, has_lab, il, False, with_dadj=True)),
    }


def factored_work(adj, lab_oh, il, forward, with_dadj=False):
    """fp32 operations the factored scan needs over the live frames of
    this run's inputs, by what the function needs.  Per live frame and
    sample, with S states, S_l of them labelled, N_l labels in use and A
    real arcs into the labelled states: the per-label shift (an add and a
    max per label in use and state: 2 N_l S), each arc's term (add, sub,
    exp, mul, add: 5 A) and 6 per labelled state (log, floor, adds,
    selects); the backward recomputes the shift and the sums, and adds the
    chain's and dwsel's 9 an arc (exp, add, sub, division, compare, two
    muls and two adds) and 2 per labelled state; the dense dadj (5 per
    labelled state and s: S_l S) only ``with_dadj``."""
    S = lab_oh.shape[1]
    has = lab_oh.sum(-1) > 0
    s_lab = has.sum(1).double()
    n_lab = (lab_oh.sum(1) > 0).sum(1).double()
    arcs = ((adj != 0) & has[:, :, None]).sum((1, 2)).double()
    frames = il.clamp(min=1).double()
    per = 2 * n_lab * S + 5 * arcs + 6 * s_lab
    if not forward:
        per = per + 9 * arcs + 2 * s_lab + (5 * s_lab * S if with_dadj else 0)
    return float((frames * per).sum())


def factored_work_dense(lab_oh, il, forward):
    """The count PRs 3-8 used (kept for the log): z = adj[u, :] . E[:, l_u]
    over all S for each labelled state (2 S), E over the labels in use
    (4 N_l S) and 6 per labelled state; the backward also adj^T dz over
    each label's states (2 S_l S), dv, its sum into dwsel and g (3 N_l S)
    and the dz division."""
    S = lab_oh.shape[1]
    s_lab = (lab_oh.sum(-1) > 0).sum(1).double()
    n_lab = (lab_oh.sum(1) > 0).sum(1).double()
    frames = il.clamp(min=1).double()
    if forward:
        per = 2 * s_lab * S + 4 * n_lab * S + 6 * s_lab
    else:
        per = 4 * s_lab * S + 7 * n_lab * S + 8 * s_lab
    return float((frames * per).sum())


def factored_chain_frame_us(torch, b, dev, threads=None):
    """One frame of the factored scans' chain without arcs (a dependent
    shared-memory load, one expf and one logf, and a block barrier, at the
    kernels' block size or ``threads``), in us: the probe's time for 2n
    frames less its time for n, over n (the launch cancels)."""
    from gtn_applications_tpu_torch.ops import dense_scan_pallas as dsp

    threads = threads or 32 * dsp.FACT_WARPS
    n = 4096
    t_n = gpu_median_ms(torch, lambda: dsp.chain_probe(b, threads, n, dev), runs=20)
    t_2n = gpu_median_ms(torch, lambda: dsp.chain_probe(b, threads, 2 * n, dev), runs=20)
    return (t_2n - t_n) / n * 1e3


def kernel_launches(torch, fn, match):
    """CUDA kernels whose name holds ``match`` (or one of its strings)
    that one call of ``fn`` launches (torch.profiler)."""
    match = (match,) if isinstance(match, str) else match
    return sum(n for k, n in kernel_counts(torch, fn).items() if any(m in k for m in match))


# the names of each pair's kernels (the dadj pass serves both)
FACTORED_KERNELS = ("factored", "scan_dadj")
DENSE_KERNELS = ("dense", "scan_dadj")


def norm_cost(torch, dev, b, t, n):
    """Device ms (CUDA events) and kernel launches (torch.profiler) of one
    ``dense_ngram_norm`` forward and backward, a loop of small PyTorch
    operations, at the Transducer path's batch shape."""
    from torch.profiler import ProfilerActivity, profile

    from gtn_applications_tpu_torch.ops import factored

    rng = np.random.RandomState(8)
    em = torch.as_tensor(rng.randn(b, t, n).astype(np.float32), device=dev)
    params = torch.as_tensor((rng.randn(2 * n + n * n + 1) * 0.3).astype(np.float32),
                             device=dev)
    em.requires_grad_(True)
    params.requires_grad_(True)

    def run():
        ws, W, we, we0 = factored.ngram_rows(params, 2, n)
        norm = factored.dense_ngram_norm(em, ws, W, we, None, we0)
        torch.autograd.grad(norm.sum(), (em, params))

    ms = gpu_median_ms(torch, run, runs=20)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA"))
    return ms, launches


def scan_bound(em, table, lens, backward):
    """The whole scan's least time on this run's inputs: the em rows of
    the live frames, the tables (each field once) and alpha0 read, the
    trajectory written (the backward: the trajectory's live rows and g
    read, dem, dw, deps and dalpha0 written); fp32 operations per live
    frame 7 an arc (two adds, max, sub, exp, sum, mask), 4 a state, and
    per closure round 5 an epsilon arc and 14 a state (its lse and the
    logaddexp); the backward adds the replay's 9 an arc, 7 an epsilon arc
    and 8 a state a round, and 2 a state."""
    (src, dst, label, w, esrc, edst, ew), start, _, depth = sparse_fields(table)
    B, T, C = em.shape
    S, A = start.shape[-1], src.shape[1]
    E = esrc.shape[1] if depth else 0
    frames = int(lens.clamp(min=0, max=T).sum())
    tables = 4 * A * sum(x.shape[0] for x in (src, dst, label, w))
    if depth:
        tables += 4 * E * sum(x.shape[0] for x in (esrc, edst, ew))
    per_frame = 7 * A + 4 * S + depth * (5 * E + 14 * S)
    if not backward:
        return bound_ms(frames * C * 4 + tables + B * S * 4 + B * 4 + B * (T + 1) * S * 4,
                        frames * per_frame)
    return bound_ms(frames * (C + S) * 4 + tables + 2 * B * S * 4 + B * 4
                    + B * T * C * 4 + B * (A + E) * 4,
                    frames * (per_frame + 9 * A + 2 * S + depth * (7 * E + 8 * S)))


def seg_lse_bound(B, S, fields, backward):
    """One seg_lse over arcs ``fields`` (src, dst, w and em where there is
    one): alpha and the fields read once, new written (the backward: g
    read too, dalpha and dcontrib written); 7 fp32 operations an arc and 4
    a state (the backward as the function needs it from alpha alone,
    recomputing the shifts and sums, which the kernel reads from its
    forward instead: 13 an arc and 2 a state)."""
    A = fields[0].shape[-1]
    arcs = 4 * A * sum(x.shape[0] for x in fields)
    if not backward:
        return bound_ms(2 * B * S * 4 + arcs, B * (7 * A + 4 * S))
    return bound_ms(3 * B * S * 4 + arcs + B * A * 4, B * (13 * A + 2 * S))


def kernel_counts(torch, fn, calls=3, sessions=3):
    """{name: launches a call} of the CUDA kernels ``fn`` launches
    (torch.profiler, ``calls`` calls a session after a warm-up call).
    The profiler has been seen to miss the first kernel of a session, so
    each session starts with a marker kernel (``torch.cuda._sleep``'s
    spin kernel, left out of the counts), and each name takes its largest
    count over ``sessions`` sessions; a count that is not a whole number a
    call is kept as the fraction."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = {}
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if str(e.device_type).endswith("CUDA") and "spin_kernel" not in e.key:
                counts[e.key] = max(counts.get(e.key, 0), e.count)
    return {k: n // calls if n % calls == 0 else n / calls for k, n in counts.items()}


def seglse_step_cost(torch, alpha, src, dst, w, idx, g):
    """The whole ``seg_lse`` step as the closure runs it (wrapper
    included; the epsilon weights and, past the first round, alpha need
    gradients): CUDA-event medians of the forward and of forward and
    backward, and the kernels each launches (torch.profiler)."""
    from gtn_applications_tpu_torch.ops import seglse_pallas as slp

    a_req = alpha.detach().clone().requires_grad_(True)
    w_req = w.detach().clone().requires_grad_(True)

    def fwd():
        return slp.seg_lse(a_req, src, dst, w_req, None, idx)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (a_req, w_req), g)

    kernels_fwd = kernel_counts(torch, fwd)
    kernels_all = kernel_counts(torch, fwd_bwd)
    kernels_bwd = {k: n - kernels_fwd.get(k, 0) for k, n in kernels_all.items()
                   if n - kernels_fwd.get(k, 0)}
    return {"seg_lse_step_fwd_ms": gpu_median_ms(torch, fwd),
            "seg_lse_step_fwd_bwd_ms": gpu_median_ms(torch, fwd_bwd),
            "seg_lse_step_fwd_kernels": kernels_fwd,
            "seg_lse_step_bwd_kernels": kernels_bwd}


def sparse_times(torch, dev):
    """CUDA-event medians of the sparse kernels and their plain versions
    at the 1kwp protocol's normaliser (the first round of its start
    closure for seg_lse), the kernels alone at its composed tables and at
    the backoff paths' trigram and 4-gram tables; and their bounds."""
    from gtn_applications_tpu_torch.ops import seglse_pallas as slp
    from gtn_applications_tpu_torch.ops import sparse_scan_pallas as ssp
    from gtn_applications_tpu_torch.ops.semiring import logaddexp

    t, bounds = {}, {}
    _, em, lens, tables = backoff_lm_inputs(torch, dev)
    _, em3, lens3, tables3 = backoff_main_inputs(torch, dev)
    _, em4, lens4, tables4 = backoff_main_inputs(torch, dev, path="transducer_backoff_4gram")
    cases = [("", em, lens, tables["norm"]), ("_1kwp_score", em, lens, tables["score"]),
             ("_trigram_norm", em3, lens3, tables3["norm"]),
             ("_trigram_score", em3, lens3, tables3["score"]),
             ("_4gram_norm", em4, lens4, tables4["norm"]),
             ("_4gram_score", em4, lens4, tables4["score"])]
    for key, e, il, table in cases:
        (src, dst, label, w, esrc, edst, ew), start, accept, depth = sparse_fields(table)
        Bk, S = e.shape[0], start.shape[-1]
        alpha0 = start.expand(Bk, S).contiguous()
        if depth:
            # the first round of the table's start closure, as the loss runs it
            idx = slp.arc_index(esrc, edst, S)
            g = torch.rand(Bk, S, device=dev)
            _, m, z = slp.seg_lse_fwd_cuda(alpha0, ew, None, idx, stats=True)
            t["seg_lse_fwd" + key] = gpu_median_ms(
                torch, lambda: slp.seg_lse_fwd_cuda(alpha0, ew, None, idx, stats=True))
            t["seg_lse_bwd" + key] = gpu_median_ms(
                torch, lambda: slp.seg_lse_bwd_cuda(alpha0, ew, None, idx, m, z, g))
            t.update({name + key: v for name, v in seglse_step_cost(
                torch, alpha0, esrc, edst, ew, idx, g).items()})
            arcs = (esrc, edst, ew)
            t["seg_lse_shape" + key] = [Bk, S, int(esrc.shape[-1])] + [
                int(torch.diff(p.long(), dim=1).max()) for p in (idx.dptr, idx.sptr)]
            if key == "":
                t["seg_lse_fwd_no_stats"] = gpu_median_ms(
                    torch, lambda: slp.seg_lse_fwd_cuda(alpha0, ew, None, idx))
                # the route the wrapper takes (vectors staged in shared memory
                # where they fit) and the other
                staged = slp.stage_words(S, esrc.shape[-1], None) <= slp.STAGE_WORDS
                t["seg_lse_fwd_staged"] = staged
                t["seg_lse_fwd_other_route"] = gpu_median_ms(
                    torch, lambda: slp.seg_lse_fwd_cuda(alpha0, ew, None, idx, stats=True,
                                                        staged=not staged))
                t["seg_lse_bwd_no_dcontrib"] = gpu_median_ms(torch, lambda: slp.seg_lse_bwd_cuda(
                    alpha0, ew, None, idx, m, z, g, need_dcontrib=False))
                t["seg_lse_fwd_plain"] = gpu_median_ms(
                    torch, lambda: slp.seg_lse_fwd_plain(alpha0, esrc, edst, ew, 0.0))
                t["seg_lse_bwd_plain"] = gpu_median_ms(
                    torch, lambda: slp.seg_lse_bwd_plain(alpha0, esrc, edst, ew, 0.0, g))
                bounds["seg_lse_fwd"] = seg_lse_bound(Bk, S, arcs, False)
                bounds["seg_lse_bwd"] = seg_lse_bound(Bk, S, arcs, True)
            else:
                for name, bwd in (("seg_lse_fwd", False), ("seg_lse_bwd", True)):
                    t[name + key + "_bound"] = seg_lse_bound(Bk, S, arcs, bwd)
        acc = cur = alpha0
        for _ in range(depth):
            cur = slp.seg_lse_fwd_plain(cur, esrc, edst, ew, torch.zeros_like(ew))
            acc = logaddexp(acc, cur)
        alpha0 = acc.contiguous()
        plan = ssp.scan_plan(src, dst, label, esrc, edst, S, e.shape[2])
        if key == "":
            headline_plan, headline_depth = plan, depth
        traj, _ = ssp.sparse_scan_fwd_cuda(e, alpha0, il, plan, w, ew, depth)
        gf = score_cotangent(torch, traj[:, -1], accept)
        t["sparse_scan_fwd" + key] = gpu_median_ms(
            torch, lambda: ssp.sparse_scan_fwd_cuda(e, alpha0, il, plan, w, ew, depth))
        t["sparse_scan_bwd" + key] = gpu_median_ms(
            torch, lambda: ssp.sparse_scan_bwd_cuda(e, traj, il, plan, w, ew, depth, gf))
        if key == "":
            t["sparse_scan_fwd_plain"] = gpu_median_ms(
                torch, lambda: ssp.sparse_scan_fwd_plain(e, alpha0, il, plan, w, ew, depth),
                runs=10)
            t["sparse_scan_bwd_plain"] = gpu_median_ms(
                torch, lambda: ssp.sparse_scan_bwd_plain(e, traj, il, plan, w, ew, depth,
                                                         gf), runs=10)
            bounds["sparse_scan_fwd"] = scan_bound(e, table, il, False)
            bounds["sparse_scan_bwd"] = scan_bound(e, table, il, True)
        else:
            t["sparse_scan_fwd" + key + "_bound"] = scan_bound(e, table, il, False)
            t["sparse_scan_bwd" + key + "_bound"] = scan_bound(e, table, il, True)
    # one phase of the scans' chain (a dependent load from the next block's
    # shared memory and a cluster barrier), at the headline's B and k: the
    # probe's time for 2n phases less its time for n, over n; a frame is
    # 1 + depth phases forward and 2 depth + 1 backward
    Bh = em.shape[0]
    k = ssp.choose_cluster(headline_plan, Bh, headline_depth, dev)
    n = 4096
    t_n = gpu_median_ms(torch, lambda: ssp.chain_probe(Bh, k, n, dev), runs=20)
    t_2n = gpu_median_ms(torch, lambda: ssp.chain_probe(Bh, k, 2 * n, dev), runs=20)
    t["sparse_chain_phase_us"] = (t_2n - t_n) / n * 1e3
    t["sparse_chain_cluster"] = k
    chain = {}
    for key, e, il, table in cases:
        depth = table.eps_depth if table.eps_src.shape[-1] else 0
        frames = int(il.clamp(max=e.shape[1]).max())
        for name, phases in (("sparse_scan_fwd", 1 + depth),
                             ("sparse_scan_bwd", 2 * depth + 1)):
            ms = frames * phases * t["sparse_chain_phase_us"] * 1e-3
            if key == "":
                chain[name] = ms
            else:
                t[name + key + "_chain"] = ms
    # per case: S, A, E, eps_depth and the emissions' shape
    t["sparse_shapes"] = {
        key or "_1kwp_norm": [int(table.start.shape[-1]), int(table.src.shape[-1]),
                              int(table.eps_src.shape[-1]), table.eps_depth,
                              list(e.shape)]
        for key, e, _, table in cases}
    return t, bounds, chain


def segmax_bound(alpha, src, dst, w, em, label):
    """One seg_max on this run's inputs: alpha, the arc fields (each row
    once) and the emissions read, the values and winning arcs written; 3
    fp32 operations (two adds and a compare) per sample and arc with valid
    endpoints."""
    B, S = alpha.shape
    fields = [x for x in (src, dst, w, label) if x is not None]
    A = max(x.shape[-1] for x in fields)
    ok = ((src >= 0) & (src < S)).expand(B, A) & ((dst >= 0) & (dst < S)).expand(B, A)
    n_bytes = 3 * B * S * 4 + sum(x.numel() * 4 for x in fields) + em.numel() * 4
    return bound_ms(n_bytes, 3 * int(ok.sum()))


def segmax_scan_bound(em, lens, table):
    """One seg_max_scan on this run's inputs: the emission rows of the live
    frames, the table (src, dst, label, weight, start, accept: each once)
    and the lengths read; backarcs, final alpha, labels and scores written;
    3 fp32 operations (two adds and a compare) per live frame, sample and
    arc with a valid source.  The walk's dependent loads are not counted."""
    B, T, C = em.shape
    S, A = table.start.shape[0], table.src.shape[0]
    frames = int(lens.clamp(min=0, max=T).sum())
    arcs = int((table.src >= 0).sum())
    n_bytes = (frames * C * 4 + 4 * A * 4 + 2 * S * 4 + B * 4
               + B * T * S * 4 + B * S * 4 + B * T * 4 + B * 4)
    return bound_ms(n_bytes, 3 * frames * arcs)


def segmax_times(torch, dev, model, config):
    """CUDA-event medians of seg_max and its plain version at the 4-gram
    headline, and of seg_max_scan (the scan and its backtrace) at the
    4-gram decode of phase 11 (B=32, T=300) with its plain version and at
    the 4-gram path's first train batch; their bounds and chain bounds
    (live frames of the longest sample x one phase of ``sparse_scan_probe``
    at the decode's batch and cluster size); and the host-clock median of 5
    decodes of that batch through ``viterbi_batch`` (after one warm-up)."""
    from gtn_applications_tpu_torch.ops import segmax_pallas as smp
    from gtn_applications_tpu_torch.ops import sparse
    from gtn_applications_tpu_torch.ops import sparse_scan_pallas as ssp
    from gtn_applications_tpu_torch.ops.seglse_pallas import arc_index, take

    _, alpha, src, dst, w, em, label = segmax_cases(torch, dev)[0]
    idx = arc_index(src, dst, alpha.shape[1], label, em.shape[1])
    w_s = take(w, idx.order)
    t = {"seg_max": gpu_median_ms(torch, lambda: smp.seg_max_cuda(alpha, w_s, em, idx)),
         "seg_max_plain": gpu_median_ms(
             torch, lambda: smp.seg_max_plain(alpha, src, dst, w, em, label))}
    bounds = {"seg_max": segmax_bound(alpha, src, dst, w, em, label)}

    path = "transducer_backoff_4gram"
    inputs, crit, _ = first_batch(torch, config, path)
    with torch.no_grad():
        logits = model(torch.from_numpy(inputs).to(dev))
    table = crit._decode_table(crit.params)
    main_lens = torch.full(logits.shape[:1], logits.shape[1], dtype=torch.int32, device=dev)
    chain, phase_us = {}, {}
    for key, (e, il, tab) in (("", segmax_scan_inputs(torch, dev)),
                              ("_main_batch", (logits.contiguous(), main_lens, table))):
        plan = smp.decode_plan(tab, e.shape[2], dev)
        tab_d = tab.to(dev)
        args = (e, take(smp._as2d(tab_d.weight), plan.main.order), tab_d.start.contiguous(),
                tab_d.accept.contiguous(), il, plan)
        name = "seg_max_scan" + key
        t[name] = gpu_median_ms(torch, lambda: smp.seg_max_scan_cuda(*args))
        k = smp.choose_cluster(plan, e.shape[0], dev)
        if k not in phase_us:
            n = 4096
            t_n = gpu_median_ms(torch, lambda: ssp.chain_probe(e.shape[0], k, n, dev), runs=20)
            t_2n = gpu_median_ms(torch, lambda: ssp.chain_probe(e.shape[0], k, 2 * n, dev),
                                 runs=20)
            phase_us[k] = (t_2n - t_n) / n * 1e3
        frames = int(il.clamp(max=e.shape[1]).max())
        chain_ms = frames * phase_us[k] * 1e-3
        b_ms, b_by = segmax_scan_bound(e, il.cpu(), tab)
        if key:
            t[name + "_bound"] = [b_ms, b_by]
            t[name + "_chain"] = chain_ms
        else:
            bounds[name] = (b_ms, b_by)
            chain[name] = chain_ms
            t["seg_max_scan_plain"] = gpu_median_ms(
                torch, lambda: smp.seg_max_backtrace_plain(
                    *smp.seg_max_scan_plain(e, tab_d, il), tab_d), runs=5, warmup=1)
        t[name + "_per_frame_us"] = t[name] / frames * 1e3
        t[name + "_cluster"] = k
        t[name + "_shape"] = list(e.shape)
    t["decode_chain_phase_us"] = phase_us

    ms = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sparse.viterbi_batch(logits, table, plans=crit._decode_plans)
        torch.cuda.synchronize()
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
    t[f"decode_batch_{path}"] = statistics.median(ms)
    t[f"decode_batch_{path}_shape"] = list(logits.shape)
    return t, bounds, chain


def ctc_chain_frame_us(torch, dev, lp=None):
    """One frame of the CTC recursions' dependent chain (``ctc_chain_probe``:
    a warp, 3 states a lane, lse3 and the emission, neighbours by shuffle)
    on 96 entries of the log-probabilities ``lp`` (default the headline's),
    in us: the probe's time for 2n frames less its time for n, over n (the
    launch cancels)."""
    from gtn_applications_tpu_torch.ops import _build

    if lp is None:
        lp = torch.log_softmax(headline_inputs(torch, dev)[0], dim=2)
    lib = _build.load_library("ctc")
    n = 4096
    pem = lp[0, 0, torch.arange(96, device=dev) % N].contiguous()
    pout = torch.empty_like(pem)
    stream = _build.stream_handle(pem)

    def run_probe(frames):
        err = lib.ctc_chain_probe(pem.data_ptr(), pout.data_ptr(), frames, stream)
        _build.check(lib, err, "ctc_chain_probe")

    t_n = gpu_median_ms(torch, lambda: run_probe(n), runs=20)
    t_2n = gpu_median_ms(torch, lambda: run_probe(2 * n), runs=20)
    return (t_2n - t_n) / n * 1e3


def viterbi_scan_bound(em, lens, w_b):
    """One whole-scan Viterbi on this run's inputs: the emission rows of the
    live frames, the [D, S] plan (source, label, weight), start and the
    lengths read; slots and final alpha written; two adds and a compare
    per live frame, sample and real arc (the plan's slots above NEG: the
    empty ones need no work)."""
    B, T, C = em.shape
    D, S = w_b.shape
    frames = int(lens.clamp(min=0, max=T).sum())
    arcs = int((w_b > -5e29).sum())
    n_bytes = (frames * C * 4 + 3 * D * S * 4 + S * 4 + B * 4
               + B * T * S * 4 + B * S * 4)
    return bound_ms(n_bytes, 3 * frames * arcs)


def viterbi_chain_frame_us(torch, b, threads, dev):
    """One frame of the whole-scan Viterbi's chain without arcs (a
    dependent shared-memory load and a block barrier), in us: the probe's
    time for 2n frames less its time for n, over n (the launch cancels)."""
    from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp

    n = 4096
    t_n = gpu_median_ms(torch, lambda: vsp.chain_probe(b, threads, n, dev), runs=20)
    t_2n = gpu_median_ms(torch, lambda: vsp.chain_probe(b, threads, 2 * n, dev), runs=20)
    return (t_2n - t_n) / n * 1e3


def viterbi_yardstick_ms(torch, em, lens, table):
    """``seg_max_scan`` (the sparse tier's decode: scan and backtrace in
    one launch) on a whole-scan Viterbi's table and inputs, CUDA-event
    median: a yardstick for the whole-scan Viterbi, not a route of it."""
    from gtn_applications_tpu_torch.ops import segmax_pallas as smp
    from gtn_applications_tpu_torch.ops.seglse_pallas import take

    dev = em.device
    plan = smp.decode_plan(table, em.shape[2], dev)
    tab = table.to(dev)
    args = (em, take(smp._as2d(tab.weight), plan.main.order), tab.start.contiguous(),
            tab.accept.contiguous(), lens, plan)
    return gpu_median_ms(torch, lambda: smp.seg_max_scan_cuda(*args))


def factored_times(torch, dev):
    """Times, bounds and chain bounds of the factored scan pair at the
    bigram Transducer's lattices (``NGRAM_CASES``, B=32, T=250): the
    kernels (the backward without dadj, the main path's, and with it), the
    plain versions at the headline, the routes, the kernels one call
    launches, and the chain probe's frame."""
    from gtn_applications_tpu_torch.ops import dense_scan_pallas as dsp

    t, bounds = {}, {}
    # the factored scan at the ngram-2 headline, at the IAM width and on the
    # forced-blank lattices; the main path's backward needs no dadj (the
    # adjacency is data)
    facts = {}
    for case, kw in NGRAM_CASES.items():
        em_f, adj_f, wsel, lab, ws_f, st_f, acc_f, fil = factored_headline_inputs(
            torch, dev, **kw)
        traj = dsp.factored_scan_fwd_cuda(em_f, adj_f, wsel, lab, ws_f, st_f, fil)
        gf = score_cotangent(torch, traj[:, -1], acc_f)
        key = {"ngram2": "", "iam": "_iam", "forced": "_forced"}[case]
        facts[key] = (adj_f, lab, fil)
        fwd = lambda: dsp.factored_scan_fwd_cuda(  # noqa: E731
            em_f, adj_f, wsel, lab, ws_f, st_f, fil)
        bwd = lambda: dsp.factored_scan_bwd_cuda(  # noqa: E731
            traj, adj_f, wsel, lab, st_f, fil, gf, need_dadj=False)
        bwd_dadj = lambda: dsp.factored_scan_bwd_cuda(  # noqa: E731
            traj, adj_f, wsel, lab, st_f, fil, gf)
        t["factored_scan_fwd" + key] = gpu_median_ms(torch, fwd)
        t["factored_scan_bwd" + key] = gpu_median_ms(torch, bwd)
        t["factored_scan_bwd_with_dadj" + key] = gpu_median_ms(torch, bwd_dadj)
        t["factored_routes" + key] = factored_routes(torch, adj_f, lab, fil, wsel.shape[2])
        if key == "":
            t["factored_scan_fwd_plain"] = gpu_median_ms(
                torch, lambda: dsp.factored_scan_fwd_plain(em_f, adj_f, wsel, lab, ws_f,
                                                           st_f, fil), runs=20)
            t["factored_scan_bwd_plain"] = gpu_median_ms(
                torch, lambda: dsp.factored_scan_bwd_plain(traj, adj_f, wsel, lab, st_f,
                                                           fil, gf, need_dadj=False),
                runs=20)
            # the kernels one call launches: the forward 1, the backward 2
            # (statistics, chain), 3 with dadj
            t["factored_kernel_launches"] = {
                name: kernel_launches(torch, fn, FACTORED_KERNELS)
                for name, fn in (("fwd", fwd), ("bwd", bwd), ("bwd_with_dadj", bwd_dadj))}
    t["factored_chain_frame_us"] = factored_chain_frame_us(torch, B, dev)

    # the factored scan: its inputs and outputs once, live frames only, and
    # the work the function needs on these inputs (factored_work: the
    # shifts and the real arcs), not the TPU kernel's [S, S] x [S, N]
    # product; the count of PRs 3-8 (dense rows) is kept in the log
    for key, (f_adj, f_lab, f_il) in facts.items():
        f_b, S_f, N_f = f_lab.shape
        f_live = int(f_il.clamp(min=1).sum()) * S_f * 4
        f_mats = f_b * S_f * S_f * 4 + 2 * f_b * S_f * N_f * 4
        ins = f_live + f_mats + 2 * f_b * S_f * 4 + f_b * 4
        outs = f_b * T * S_f * 4
        bounds["factored_scan_fwd" + key] = bound_ms(
            ins + outs, factored_work(f_adj, f_lab, f_il, True))
        bwd_bytes = ins + outs + f_b * S_f * N_f * 4 + f_b * S_f * 4
        bounds["factored_scan_bwd" + key] = bound_ms(
            bwd_bytes, factored_work(f_adj, f_lab, f_il, False))
        bounds["factored_scan_bwd_with_dadj" + key] = bound_ms(
            bwd_bytes + f_b * S_f * S_f * 4,
            factored_work(f_adj, f_lab, f_il, False, with_dadj=True))
        t["factored_work_ops" + key] = {
            "fwd": factored_work(f_adj, f_lab, f_il, True),
            "bwd": factored_work(f_adj, f_lab, f_il, False),
            "fwd_dense_count": factored_work_dense(f_lab, f_il, True),
            "bwd_dense_count": factored_work_dense(f_lab, f_il, False)}
        t["factored_bounds" + key] = {
            name: bounds[name + key] for name in (
                "factored_scan_fwd", "factored_scan_bwd", "factored_scan_bwd_with_dadj")}
    # the forward's frames each need the last (the longest sample's
    # frames); the backward's chain takes one fewer
    f_max = int(facts[""][2].max())
    chain = {"factored_scan_fwd": f_max * t["factored_chain_frame_us"] * 1e-3,
             "factored_scan_bwd": (f_max - 1) * t["factored_chain_frame_us"] * 1e-3}
    t["factored_S"] = {key or "_ngram2": f[1].shape[1] for key, f in facts.items()}
    return t, bounds, chain


def dense_time_cases(torch, dev):
    """(key, inputs) of the dense pair's timed shapes: the STC headline
    (B=32, T=250, S=96), S = 304 (B=8, T=128) and the word decompositions
    at the 1k inventory (B=32, T=100, S=376)."""
    return [("", stc_headline_inputs(torch, dev)),
            ("_s304", stc_headline_inputs(torch, dev, *WIDE_STC)),
            ("_words", word_decomp_inputs(torch, dev))]


def dense_chain_bounds(torch, dev, routes, b, max_len):
    """The dense pair's chain bounds on a case: the longest sample's
    frames x one frame of ``factored_chain_probe`` at the forward's block
    (its frame warps), and its frames less one x one at the chain's (its
    source warps and the side warp); and the two frames in us."""
    fwd = factored_chain_frame_us(torch, b, dev, 32 * routes["warps"][1])
    chain = factored_chain_frame_us(torch, b, dev, 32 * (routes["chain_warps"][1] + 1))
    return ({"dense_scan_fwd": max_len * fwd * 1e-3,
             "dense_scan_bwd": (max_len - 1) * chain * 1e-3},
            {"fwd": fwd, "chain": chain})


def dense_times(torch, dev):
    """Times, bounds and chain bounds of the dense scan pair at
    ``dense_time_cases``: the kernels (the backward without dadj, the main
    paths' form, and with it), the plain versions at the headline, the
    routes, the kernels one call launches, the work by real arcs beside
    the O(S^2) count of PRs 2-10, and the chain probe's frames."""
    from gtn_applications_tpu_torch.ops import dense_scan_pallas as dsp

    t, bounds, chain = {}, {}, {}
    for key, (em_s, adj, st, lab, acc, sil) in dense_time_cases(torch, dev):
        traj = dsp.dense_scan_fwd_cuda(em_s, adj, st, lab, sil)
        gf = score_cotangent(torch, traj[:, -1], acc)
        fwd = lambda: dsp.dense_scan_fwd_cuda(em_s, adj, st, lab, sil)  # noqa: E731
        bwd = lambda: dsp.dense_scan_bwd_cuda(  # noqa: E731
            traj, adj, st, lab, sil, gf, need_dadj=False)
        bwd_dadj = lambda: dsp.dense_scan_bwd_cuda(traj, adj, st, lab, sil, gf)  # noqa: E731
        t["dense_scan_fwd" + key] = gpu_median_ms(torch, fwd)
        t["dense_scan_bwd" + key] = gpu_median_ms(torch, bwd)
        t["dense_scan_bwd_with_dadj" + key] = gpu_median_ms(torch, bwd_dadj)
        routes = dense_routes(torch, adj, lab, sil)
        t["dense_routes" + key] = routes
        b, _, S = em_s.shape
        t["dense_work_ops" + key] = {
            "fwd": dense_work(adj, lab, sil, True), "bwd": dense_work(adj, lab, sil, False),
            "bwd_with_dadj": dense_work(adj, lab, sil, False, with_dadj=True),
            "fwd_dense_count": scan_work(sil, S, DENSE_FWD_OPS, 2),
            "bwd_dense_count": scan_work(sil, S, DENSE_BWD_OPS, 6)}
        forms = dense_bounds(em_s, adj, lab, sil)
        t["dense_bounds" + key] = forms
        bounds["dense_scan_fwd" + key] = forms["fwd"]
        bounds["dense_scan_bwd" + key] = forms["bwd"]
        bounds["dense_scan_bwd_with_dadj" + key] = forms["bwd_with_dadj"]
        more, frame_us = dense_chain_bounds(torch, dev, routes, b, int(sil.max()))
        chain.update({name + key: ms for name, ms in more.items()})
        t["dense_chain_frame_us" + key] = frame_us
        t["dense_S" + key] = S
        if key == "":
            t["dense_scan_fwd_plain"] = gpu_median_ms(
                torch, lambda: dsp.dense_scan_fwd_plain(em_s, adj, st, lab, sil), runs=20)
            t["dense_scan_bwd_plain"] = gpu_median_ms(
                torch, lambda: dsp.dense_scan_bwd_plain(traj, adj, st, lab, sil, gf,
                                                        need_dadj=False), runs=20)
            # the kernels one call launches: the forward 1, the backward 2
            # (statistics, chain), 3 with dadj
            t["dense_kernel_launches"] = {
                name: kernel_launches(torch, fn, DENSE_KERNELS)
                for name, fn in (("fwd", fwd), ("bwd", bwd), ("bwd_with_dadj", bwd_dadj))}
    return t, bounds, chain


def phase_times(torch, dev, paths):
    from gtn_applications_tpu_torch.ops import gathers, lattice
    from gtn_applications_tpu_torch.ops import lattice_pallas as lp_mod
    from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp

    F = torch.nn.functional
    logits, targets, tl, il = headline_inputs(torch, dev)
    lp, labels, start, accept, skip = ctc_kernel_inputs(torch, logits, targets, tl)
    em = emissions(torch, lp, labels)
    ident = identity_labels(torch, em)
    S = em.shape[2]
    alpha = lp_mod.ctc_alpha_cuda(lp, labels, start, skip, il)
    score = lp_mod._final_score(alpha[:, -1], accept)
    g = -1.0 / (B * tl.to(torch.float32))
    grad = lp_mod.ctc_grad_cuda(lp, labels, alpha, accept, skip, il, score, g)

    t = {}
    # an empty kernel: the launch floor of every kernel here
    t["launch_probe"] = gpu_median_ms(torch, lambda: gathers.launch_probe(dev))
    t["gather_fwd"] = gpu_median_ms(torch, lambda: gathers.gather_fwd_cuda(lp, labels))
    t["gather_fwd_plain"] = gpu_median_ms(
        torch, lambda: gathers.gather_channels_plain(lp, labels))
    t["gather_bwd"] = gpu_median_ms(
        torch, lambda: gathers.gather_bwd_cuda(grad, labels, N))
    t["gather_bwd_plain"] = gpu_median_ms(
        torch, lambda: gathers.gather_channels_bwd_plain(grad, labels, N))
    # the one PyTorch call that computes each (timed only; the port never
    # calls them): torch.gather, and scatter_add_ into zeros, at the
    # channel index (-1 padding read as channel 0: the same work)
    full = labels.long().clamp(min=0)[:, None, :].expand(B, T, labels.shape[1])
    t["torch_gather"] = gpu_median_ms(torch, lambda: torch.gather(lp, 2, full))
    t["torch_scatter_add"] = gpu_median_ms(
        torch, lambda: torch.zeros_like(lp).scatter_add_(2, full, grad))
    t["gather_bwd_plan"] = gathers.gather_bwd_plan(S, N)
    # the gather backward at the wide and ASG cases, the forward at ASG's
    # (its caller there is the force-aligned score)
    more, gather_bounds = {}, {}
    for b_, t_, c_, s_, targets_ in GATHER_CASES[1:]:
        x_m, idx_m, g_m = _gather_case(torch, dev, b_, t_, c_, s_, seed=s_, targets=targets_)
        full_m = idx_m.long().clamp(min=0)[:, None, :].expand(b_, t_, s_)
        key = f"{'asg' if targets_ else 'wide'}_S{s_}"
        more[key] = {
            "shape": [b_, t_, c_, s_], "plan": gathers.gather_bwd_plan(s_, c_),
            "ms": gpu_median_ms(torch, lambda a=(g_m, idx_m, c_): gathers.gather_bwd_cuda(*a)),
            "plain_ms": gpu_median_ms(
                torch, lambda a=(g_m, idx_m, c_): gathers.gather_channels_bwd_plain(*a)),
            "library_ms": gpu_median_ms(
                torch, lambda a=(x_m, full_m, g_m): torch.zeros_like(a[0]).scatter_add_(
                    2, a[1], a[2]))}
        more[key]["bound_ms"], _ = bound_ms(
            g_m.numel() * 4 + idx_m.numel() * 4 + x_m.numel() * 4, g_m.numel())
        if targets_:
            t["gather_fwd_asg"] = {
                "shape": [b_, t_, c_, s_],
                "ms": gpu_median_ms(torch, lambda a=(x_m, idx_m): gathers.gather_fwd_cuda(*a)),
                "library_ms": gpu_median_ms(
                    torch, lambda a=(x_m, full_m): torch.gather(a[0], 2, a[1])),
                "bound_ms": bound_ms(x_m.numel() * 4 + idx_m.numel() * 4 + g_m.numel() * 4,
                                     0)[0]}
    t["gather_bwd_more"] = more
    t["ctc_alpha"] = gpu_median_ms(
        torch, lambda: lp_mod.ctc_alpha_cuda(lp, labels, start, skip, il))
    # its plain version: the plain gather, then the plain recursion
    t["ctc_alpha_plain"] = gpu_median_ms(
        torch, lambda: lp_mod.ctc_alpha_plain(gathers.gather_channels_plain(lp, labels), start,
                                              skip, il), runs=20)
    # the forward as the parent composed it: the gather, then the kernel on
    # the gathered emissions (identity labels), two launches
    t["ctc_alpha_gather_then_alpha"] = gpu_median_ms(
        torch, lambda: lp_mod.ctc_alpha_cuda(gathers.gather_fwd_cuda(lp, labels), ident, start,
                                             skip, il))
    t["ctc_grad"] = gpu_median_ms(
        torch, lambda: lp_mod.ctc_grad_cuda(lp, labels, alpha, accept, skip, il, score, g))
    t["ctc_grad_plain"] = gpu_median_ms(
        torch, lambda: lp_mod.ctc_grad_plain(gathers.gather_channels_plain(lp, labels), alpha,
                                             accept, skip, il, score, g), runs=20)
    t["ctc_grad_route"] = lp_mod.grad_plan(S)
    t["ctc_alpha_route"] = lp_mod.alpha_plan(S)
    # the pair at its wider shapes (S = 241 and 401, route "block")
    wide, wide_a = {}, {}
    for i, (b, tt, l) in enumerate(CTC_WIDE):
        lp_w, lab_w, st_w, acc_w, skip_w, il_w, g_w = ctc_case(torch, dev, b, tt, l, seed=2 + i)
        S_w = lab_w.shape[1]
        alpha_w = lp_mod.ctc_alpha_cuda(lp_w, lab_w, st_w, skip_w, il_w)
        args = (lp_w, lab_w, alpha_w, acc_w, skip_w, il_w,
                lp_mod._final_score(alpha_w[:, -1], acc_w), g_w)
        em_w = emissions(torch, lp_w, lab_w)
        p_args = (em_w,) + args[2:]
        a_args = (lp_w, lab_w, st_w, skip_w, il_w)
        wide[f"S{S_w}"] = {
            "shape": [b, tt, S_w], "max_len": int(il_w.max()),
            "route": lp_mod.grad_plan(S_w),
            "ms": gpu_median_ms(torch, lambda a=args: lp_mod.ctc_grad_cuda(*a)),
            "plain_ms": gpu_median_ms(torch, lambda a=p_args: lp_mod.ctc_grad_plain(*a),
                                      runs=10)}
        wide_a[f"S{S_w}"] = {
            "shape": [b, tt, S_w], "max_len": int(il_w.max()),
            "route": lp_mod.alpha_plan(S_w),
            "ms": gpu_median_ms(torch, lambda a=a_args: lp_mod.ctc_alpha_cuda(*a)),
            "plain_ms": gpu_median_ms(
                torch, lambda a=(em_w, st_w, skip_w, il_w): lp_mod.ctc_alpha_plain(*a),
                runs=10)}
    t["ctc_grad_wide"] = wide
    t["ctc_alpha_wide"] = wide_a
    # the kernels one CTC backward launches (torch.profiler)
    t["ctc_grad_kernel_launches"] = kernel_launches(
        torch, lambda: lp_mod.ctc_grad_cuda(lp, labels, alpha, accept, skip, il, score, g),
        "ctc_grad")

    # F.ctc_loss copies its length tensors to the host; lengths already on
    # the host keep that copy from synchronising the device on every call
    lp_tbc = lp.transpose(0, 1)
    il_host, tl_host = il.cpu(), tl.cpu()
    t["f_ctc_loss_fwd"] = gpu_median_ms(torch, lambda: F.ctc_loss(
        lp_tbc, targets, il_host, tl_host, blank=BLANK, reduction="mean"))
    lp_req = lp.detach().clone().requires_grad_(True)

    def f_ctc_fwd_bwd():
        loss = F.ctc_loss(lp_req.transpose(0, 1), targets, il_host, tl_host,
                          blank=BLANK, reduction="mean")
        torch.autograd.grad(loss, lp_req)

    t["f_ctc_loss_fwd_bwd"] = gpu_median_ms(torch, f_ctc_fwd_bwd)
    t["port_ctc_loss_fwd"] = gpu_median_ms(torch, lambda: lattice.ctc_loss(
        lp, targets, tl, BLANK, "mean", il))

    def port_fwd_bwd():
        loss = lattice.ctc_loss(lp_req, targets, tl, BLANK, "mean", il)
        torch.autograd.grad(loss, lp_req)

    t["port_ctc_loss_fwd_bwd"] = gpu_median_ms(torch, port_fwd_bwd)
    # the CTC Function itself from the log-probabilities (wrapper included;
    # the state tables made once, as F.ctc_loss takes its targets ready)

    def function_fwd():
        return lp_mod.ctc_score_kernel(lp, labels, start, accept, skip, il)

    def function_fwd_bwd():
        score_f = lp_mod.ctc_score_kernel(lp_req, labels, start, accept, skip, il)
        torch.autograd.grad(score_f, lp_req, g)

    t["ctc_function_fwd"] = gpu_median_ms(torch, function_fwd)
    t["ctc_function_fwd_bwd"] = gpu_median_ms(torch, function_fwd_bwd)
    t["ctc_function_kernel_launches"] = {
        "fwd": kernel_launches(torch, function_fwd, ("ctc_", "gather_")),
        "fwd_bwd": kernel_launches(torch, function_fwd_bwd, ("ctc_", "gather_"))}

    # the backtrace at the ASG headline
    bp, last = asg_headline_inputs(torch, dev)
    t["dense_bt"] = gpu_median_ms(torch, lambda: vsp.dense_backtrace_cuda(bp, last))
    t["dense_bt_plain"] = gpu_median_ms(
        torch, lambda: vsp.dense_backtrace_plain(bp, last), runs=20)
    t["dense_bt_plan"] = vsp.dense_bt_plan(T, ASG_C)
    # and at its long and odd-C cases
    more = {}
    for shape in DENSE_BT_MORE:
        bp_m, last_m = asg_headline_inputs(torch, dev, *shape)
        more["x".join(map(str, shape))] = {
            "shape": list(shape), "plan": vsp.dense_bt_plan(shape[1], shape[2]),
            "ms": gpu_median_ms(torch, lambda a=(bp_m, last_m): vsp.dense_backtrace_cuda(*a)),
            "plain_ms": gpu_median_ms(
                torch, lambda a=(bp_m, last_m): vsp.dense_backtrace_plain(*a), runs=10)}
    t["dense_bt_more"] = more

    # the whole-scan Viterbi at the decode headline: the scan alone and the
    # decode (scan and walk in one launch) in turns, scan, decode, decode,
    # scan; the walk's share is their difference; seg_max_scan on its table
    # as a yardstick (not a route of this table's decode)
    em_v, src_b, lab_b, w_b, st_v, acc_v, vil, v_table = viterbi_headline_inputs(
        torch, dev, with_table=True)
    packed = vsp.pack_buckets(src_b, lab_b, w_b).to(dev)
    S_v = st_v.shape[0]
    runs = {"scan": lambda: vsp.viterbi_scan_fwd_cuda(em_v, src_b, lab_b, w_b, st_v, vil,
                                                      packed=packed),
            "decode": lambda: vsp.viterbi_scan_fwd_cuda(em_v, src_b, lab_b, w_b, st_v, vil,
                                                        packed=packed, accept=acc_v)}
    slots, final = runs["scan"]()
    turns = {}
    for who in ("scan", "decode", "decode", "scan"):
        turns.setdefault(who, []).append(gpu_median_ms(torch, runs[who]))
    t["viterbi_turns_ms"] = turns
    t["viterbi_scan_fwd"] = statistics.mean(turns["scan"])
    t["viterbi_decode"] = statistics.mean(turns["decode"])
    t["viterbi_backtrace"] = t["viterbi_decode"] - t["viterbi_scan_fwd"]
    t["viterbi_scan_fwd_route"] = vsp.scan_route(packed, S_v, N)
    decode_route = vsp.scan_route(packed, S_v, N, "chunked", T)
    decode_walk = vsp.walk_route(packed, S_v, T, N, decode_route)
    t["viterbi_decode_route_walk_rows"] = [
        decode_route, decode_walk, vsp.scan_rows(packed, S_v, T, N, decode_route, decode_walk)]
    t["viterbi_scan_fwd_cap_slots_arcs"] = [packed.cap, packed.slots, packed.A]
    t["viterbi_yardstick_seg_max_scan"] = viterbi_yardstick_ms(torch, em_v, vil, v_table)
    t["viterbi_scan_fwd_plain"] = gpu_median_ms(
        torch, lambda: vsp.viterbi_scan_fwd_plain(em_v, src_b, lab_b, w_b, st_v, vil),
        runs=20)
    t["viterbi_backtrace_plain"] = gpu_median_ms(
        torch, lambda: vsp.viterbi_backtrace_plain(slots, final, acc_v, src_b, lab_b),
        runs=20)
    # the kernels one decode launches (torch.profiler): scan and walk in one
    plan_v = vsp.build_plan(v_table)
    t["viterbi_decode_kernel_launches"] = kernel_launches(
        torch, lambda: vsp.viterbi_scan(em_v, plan_v, vil), "viterbi")

    # one full train step of each path at its main path's shape
    for path, info in paths.items():
        t[f"train_step_{path}"], t[f"train_step_{path}_shape"] = time_train_step(
            torch, dev, info["model"], main_path_config(path), *step_runs(path))

    # one frame of the recursion's dependent chain
    t["chain_frame_us"] = ctc_chain_frame_us(torch, dev, lp)
    n = 4096
    # one frame of the whole-scan Viterbi's chain, at its headline launch
    v_threads = vsp.WARP * min(packed.slots, vsp.MAX_WARPS)
    t["viterbi_chain_frame_us"] = viterbi_chain_frame_us(torch, B, v_threads, dev)
    # one frame of the walk's chain (a dependent shared load of a word and
    # its unpacking), for the decode's walk and the dense backtrace
    t_n = gpu_median_ms(torch, lambda: vsp.walk_probe(B, n, dev), runs=20)
    t_2n = gpu_median_ms(torch, lambda: vsp.walk_probe(B, 2 * n, dev), runs=20)
    t["walk_frame_us"] = (t_2n - t_n) / n * 1e3

    # bounds from this run's inputs: live frames only where the kernel
    # skips the frozen tail
    live_states = int(il.clamp(max=T).sum()) * S
    state_bytes = B * S * 4
    # the CTC kernels read lp by label: each live frame's entries at the
    # sample's distinct labels, and the labels once
    lp_by_label = sum(int(il[b].clamp(max=T)) * int(torch.unique(labels[b]).numel())
                      for b in range(B)) * 4 + labels.numel() * 4
    bounds = {
        "gather_fwd": bound_ms(lp.numel() * 4 + labels.numel() * 4 + B * T * S * 4, 0),
        "gather_bwd": bound_ms(grad.numel() * 4 + labels.numel() * 4 + lp.numel() * 4,
                               grad.numel()),
        "ctc_alpha": bound_ms(lp_by_label + 2 * state_bytes + B * 4 + B * T * S * 4,
                              (live_states - B * S) * ALPHA_OPS),
        "ctc_grad": bound_ms(lp_by_label + live_states * 4 + 2 * state_bytes + 3 * B * 4
                             + B * T * S * 4, live_states * GRAD_OPS),
        # the walk reads one entry of each of a sample's T-1 frames, a
        # scattered load that moves at least one 32-byte sector; last read
        # and the path written once; no arithmetic
        "dense_bt": bound_ms(bp.shape[0] * bp.shape[1] * 32 + last.numel() * 4
                             + B * T * 4, 0),
    }
    # the Viterbi scan: viterbi_scan_bound.  The backtrace: per live
    # frame one dependent load (the frame's backpointer) of at least one
    # 32 B sector; final, accept in; labels, score out
    D_v = src_b.shape[0]
    v_frames = int(vil.sum())
    bounds["viterbi_scan_fwd"] = viterbi_scan_bound(em_v, vil, w_b)
    bounds["viterbi_backtrace"] = bound_ms(
        v_frames * 32 + B * S_v * 4 + S_v * 4 + B * T * 4 + B * 4, 0)

    # both recursions take max(len) - 1 dependent frames (the forward from
    # frame 1, the backward down to frame 1); no design with this
    # arithmetic can take less
    chain = {name: (int(il.max()) - 1) * t["chain_frame_us"] * 1e-3
             for name in ("ctc_alpha", "ctc_grad")}
    # the scan's frames each need the last: the longest sample's frames;
    # the walks: the longest sample's live frames (the decode) and the
    # T - 1 frames of the dense backtrace, a probe frame each
    chain["viterbi_scan_fwd"] = int(vil.max()) * t["viterbi_chain_frame_us"] * 1e-3
    chain["viterbi_backtrace"] = int(vil.max()) * t["walk_frame_us"] * 1e-3
    chain["dense_bt"] = (bp.shape[1]) * t["walk_frame_us"] * 1e-3
    for row in list(t["ctc_grad_wide"].values()) + list(t["ctc_alpha_wide"].values()):
        row["chain_bound_ms"] = (row["max_len"] - 1) * t["chain_frame_us"] * 1e-3
    for row in t["dense_bt_more"].values():
        row["chain_bound_ms"] = (row["shape"][1] - 1) * t["walk_frame_us"] * 1e-3
    t["shape"] = {"B": B, "T": T, "L": L, "N": N, "S": S,
                  "asg_C": ASG_C, "stc_L": STC_L,

                  "decode_D": D_v, "decode_S": S_v, "decode_A": packed.A}
    return t, bounds, chain


# the distributed phase: ranks of the dry run and of the full-width data-
# parallel check (gloo ranks sharing the card: NCCL refuses two ranks on one
# device), the full-width check's global batch and steps.  Its reference is
# one process on the same batches that computes each global batch's
# gradient in the ranks' row blocks and sums them (the ranks' arithmetic,
# cuDNN deterministic on both sides): losses as the dry run's legs, the
# parameters after the last step as tests/test_fused_steps_mesh.py's
# tolerances.  One process on the whole batch of 32 is held after the first
# step only, from equal parameters: at lr 0.1 the trajectory amplifies
# float32 rounding (a run on the same rows in another order lands ~5% of
# the update's norm away after three steps on the CPU), so later steps are
# logged beside it
DIST_RANKS = 2
DP_BATCH, DP_STEPS = 32, 3
DP_LOSS_RTOL = 1e-5
DP_PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
REDUCE_RUNS = 5


def dp_config():
    """The ctc path's config (``configs/iamdb/tds2d.json``'s model at full
    width on the synthetic corpus) with dropout 0: each rank draws its own
    dropout masks, which no one-process run reproduces."""
    config = main_path_config("ctc")
    config["model"] = dict(config["model"], dropout=0.0)
    config["optim"] = dict(config["optim"], batch_size=DP_BATCH)
    return config


def dp_batches(config):
    """DP_STEPS global batches of the trainer's loader (its epochs in
    order): [(inputs numpy, targets), ...]."""
    from gtn_applications_tpu_torch import datasets, utils

    data = getattr(datasets, config["data"]["dataset"])
    pre = path_preprocessor(data, config)
    loader = utils.data_loader(data.Dataset(None, pre, split="train", augment=True),
                               config, seed=config["seed"])
    out = []
    while len(out) < DP_STEPS:
        out += [(inputs, targets) for inputs, _, targets in loader]
    return out[:DP_STEPS]


def block_step(torch, model, crit, lr, max_grad_norm, blocks):
    """The train step of ``train.make_train_step`` over a global batch in
    ``blocks`` row blocks computed in turn by one process: each block's
    loss times its rows differentiated, the gradients summed and divided
    by the rows, as the ranks' all-reduce does; then the clip and SGD."""
    from gtn_applications_tpu_torch import train as train_mod

    params = list(model.parameters()) + list(crit.params.values())

    def step(x, prepared_blocks, generator, lr_scale):
        for p in params:
            p.grad = None
        n, weighted = x.shape[0], 0.0
        for rows, prepared in zip(torch.arange(n).chunk(blocks), prepared_blocks):
            out = model(x[rows], train=True, generator=generator)
            loss = crit.loss(crit.params, out, prepared)
            (loss * len(rows)).backward()
            weighted = weighted + loss.detach() * len(rows)
        grads = [p.grad / n for p in params]
        train_mod.clip_global_norm(grads, max_grad_norm)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(lr * lr_scale * g)
        return weighted / n

    return step


def dp_steps(torch, dev, config, batches, mesh=None, blocks=None):
    """DP_STEPS train steps of the ctc path's model from seed 0 on
    ``batches``: this rank's rows of each on a ``mesh`` (and its time shard
    where the mesh has a ``'seq'`` axis), else all of them (in ``blocks``
    row blocks with ``block_step``).  Returns the losses,
    the parameters after the first step and after the last (numpy), the
    host-clock ms of each step (ending in a device sync), the kernel
    launches of the steps and, on a mesh, the host-clock median ms of the
    gradient reduction alone."""
    from gtn_applications_tpu_torch import train as train_mod
    from gtn_applications_tpu_torch.ops import _build
    from gtn_applications_tpu_torch.parallel import mesh as pmesh

    _, pre, crit, model, _ = train_mod.load_experiment(
        config, torch.Generator().manual_seed(config["seed"]))
    model.to(dev)
    train_mod.criterion_to_device(crit, dev)
    optim = config["optim"]
    lr, max_norm = optim["learning_rate"], optim["max_grad_norm"]
    group = mesh.group("data") if mesh is not None else None
    seq_group = mesh.group("seq") if mesh is not None else None
    if blocks:
        step = block_step(torch, model, crit, lr, max_norm, blocks)
    else:
        step = train_mod.make_train_step(model, crit, lr, lr, max_norm, group, seq_group)
    gen = torch.Generator(device=dev).manual_seed(1)
    losses, step_ms = [], []
    _build.reset_launches()
    for inputs, targets in batches:
        rows = np.arange(len(targets))
        if mesh is not None:
            inputs, rows = pmesh.shard_batch(inputs, mesh), pmesh.shard_batch(rows, mesh)
        x, axis = torch.as_tensor(inputs), None
        if seq_group is not None:
            x, axis = train_mod.shard_time(x, mesh, 2, model)
            if axis is None:
                raise AssertionError(f"width {inputs.shape[2]} kept whole on the seq grid")
        x = x.to(dev)
        if blocks:
            prepared = [train_mod.to_device(crit.prepare([targets[i] for i in r]), dev)
                        for r in np.array_split(rows, blocks)]
        else:
            prepared = train_mod.to_device(crit.prepare([targets[i] for i in rows]), dev)
        sync(torch, dev)
        t0 = time.perf_counter()
        loss = step(x, prepared, gen, 1.0) if blocks else step(x, prepared, gen, 1.0,
                                                                 None, axis)
        sync(torch, dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss[0] if isinstance(loss, tuple) else loss))
        if len(losses) == 1:
            first = {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}
    launches = dict(_build.LAUNCHES)
    reduce_ms = None
    if group is not None and seq_group is None:
        grads = [p.detach().clone() for p in model.parameters()]
        times = []
        for _ in range(REDUCE_RUNS):
            sync(torch, dev)
            t0 = time.perf_counter()
            train_mod.reduce_gradients(grads, torch.ones((), device=dev), 16, group)
            sync(torch, dev)
            times.append((time.perf_counter() - t0) * 1e3)
        reduce_ms = statistics.median(times)
    params = {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}
    return {"losses": losses, "params": params, "first": first, "step_ms": step_ms,
            "launches": launches, "reduce_ms": reduce_ms,
            "n_params": sum(p.numel() for p in model.parameters())}


def update_distance(params, ref, init):
    """||params - ref|| over every parameter, as a share of ||ref - init||
    (the run's whole update)."""
    num = sum(float(np.sum((params[k] - v) ** 2)) for k, v in ref.items())
    den = sum(float(np.sum((v - init[k]) ** 2)) for k, v in ref.items())
    return (num / den) ** 0.5


def dp_rank(rank, n, device, config, batches):
    """A rank of the full-width data-parallel check (``dp_steps`` on its
    rows), cuDNN deterministic."""
    import torch

    from gtn_applications_tpu_torch.parallel import mesh as pmesh

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    return dp_steps(torch, dev, config, batches, pmesh.make_mesh())


def _hold_losses(got, want, what, steps):
    for i in steps:
        if abs(got[i] - want[i]) > DP_LOSS_RTOL * abs(want[i]):
            raise AssertionError(f"{what}, step {i + 1}: loss {got[i]} against {want[i]} "
                                 f"(rtol {DP_LOSS_RTOL})")


def _hold_params(got, want, what):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=f"{what}: {k}", **DP_PARAM_TOL)
    return max(float(np.abs(got[k] - v).max()) for k, v in want.items())


def hold_dp(ranks, blocked, whole, init):
    """Each rank against the one process computing the ranks' row blocks
    (every step's loss, the parameters after the last step) and against
    the one process on the whole batch (the first step's loss and the
    parameters after it; the later steps' distance is returned, not
    held)."""
    errs = {"blocked_param_max_abs_err": 0.0, "whole_first_param_max_abs_err": 0.0}
    for rank, r in enumerate(ranks):
        _hold_losses(r["losses"], blocked["losses"], f"rank {rank} against one process "
                     "in row blocks", range(DP_STEPS))
        errs["blocked_param_max_abs_err"] = max(
            errs["blocked_param_max_abs_err"],
            _hold_params(r["params"], blocked["params"], f"rank {rank}, one process in blocks"))
        _hold_losses(r["losses"], whole["losses"], f"rank {rank} against one process", [0])
        errs["whole_first_param_max_abs_err"] = max(
            errs["whole_first_param_max_abs_err"],
            _hold_params(r["first"], whole["first"], f"rank {rank} after step 1, one process"))
    errs["blocked_loss_rel_err"] = max(abs(a - b) / abs(b) for r in ranks
                                       for a, b in zip(r["losses"], blocked["losses"]))
    errs["whole_loss_rel_err"] = [max(abs(r["losses"][i] - whole["losses"][i])
                                      / abs(whole["losses"][i]) for r in ranks)
                                  for i in range(DP_STEPS)]
    errs["whole_update_distance"] = max(update_distance(r["params"], whole["params"], init)
                                        for r in ranks)
    errs["blocked_whole_update_distance"] = update_distance(blocked["params"],
                                                            whole["params"], init)
    return errs


def nccl_probe(torch, dev):
    """A process group of one over NCCL (its communicator is made at the
    first collective, which a world of one's train step never calls): the
    mesh helpers' all-reduce, gather and broadcast of CUDA tensors and
    ``Meters.sync`` through it."""
    import torch.distributed as dist

    from gtn_applications_tpu_torch import utils
    from gtn_applications_tpu_torch.parallel import mesh as pmesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{pmesh.free_port()}",
                            world_size=1, rank=0)
    try:
        x = torch.arange(6.0, device=dev)
        got = (pmesh.all_reduce(x), pmesh.all_gather(x)[0], pmesh.broadcast(x))
        meters = utils.Meters(loss=1.5, num_samples=3, num_tokens=7)
        meters.sync()
    finally:
        dist.destroy_process_group()
    if not all(torch.equal(g, x) for g in got) or (meters.loss, meters.num_tokens) != (1.5, 7):
        raise AssertionError(f"NCCL collectives of a world of one: {got}, {meters}")


def world_of_one_nccl(torch, dev, card, work):
    """One epoch of the ctc path through ``train.main``'s rendezvous flags
    (``--world_size 1 --coordinator_address``), a process group of one
    over NCCL, against the plain run of the same config; cuDNN
    deterministic in both, so the histories are equal.  Returns the kernel
    launches of the NCCL run."""
    from gtn_applications_tpu_torch import train as train_mod
    from gtn_applications_tpu_torch.ops import _build
    from gtn_applications_tpu_torch.parallel import mesh as pmesh

    nccl_probe(torch, dev)
    config = main_path_config("ctc")
    config["optim"] = dict(config["optim"], epochs=1)
    work.mkdir(parents=True, exist_ok=True)
    cfg = work / "config.json"
    cfg.write_text(json.dumps(config))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _, plain = train_mod.train(train_mod.parse_args(
            ["--config", str(cfg), "--checkpoint_path", str(work / "plain")]))
        _build.reset_launches()
        t0 = time.perf_counter()
        _, nccl = train_mod.main(
            ["--config", str(cfg), "--checkpoint_path", str(work / "nccl"), "--world_size",
             "1", "--coordinator_address", f"127.0.0.1:{pmesh.free_port()}",
             "--process_id", "0"])
        seconds = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if torch.distributed.is_initialized():
        raise AssertionError("train.main left its process group initialised")
    if nccl != plain:
        raise AssertionError(f"NCCL world of one: history {nccl}, plain run {plain}")
    log(f"[{card}] NCCL world of one (train.main rendezvous, ctc path, 1 epoch): "
        f"{seconds:.1f} s, history equal to the plain run's: {json.dumps(nccl)}")
    return launches, seconds


def run_examples(torch, dev, card, work):
    """Both examples on the card at their shipped epochs; their final
    validation CER and kernel launches."""
    from gtn_applications_tpu_torch.examples import marginalized_transducer, quickstart
    from gtn_applications_tpu_torch.ops import _build

    out, launches = {}, {}
    for name, run in (("quickstart", lambda d: quickstart.main(["--workdir", d])[0]),
                      ("marginalized_transducer",
                       lambda d: marginalized_transducer.main(["--workdir", d]))):
        (work / name).mkdir(parents=True, exist_ok=True)
        _build.reset_launches()
        t0 = time.perf_counter()
        history = run(str(work / name))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        for k, v in _build.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + v
        final = history[-1]
        if not all(math.isfinite(final[k]) for k in ("train_loss", "val_loss", "val_cer")):
            raise AssertionError(f"example {name}: {final}")
        out[name] = {"epochs": len(history), "val_cer": final["val_cer"],
                     "val_loss": final["val_loss"], "seconds": seconds}
        log(f"[{card}] example {name}: {len(history)} epochs in {seconds:.1f} s, final "
            f"validation CER {final['val_cer']:.2f}, loss {final['val_loss']:.4f}")
    return out, launches


def add_launches(total, more):
    for k, v in more.items():
        total[k] = total.get(k, 0) + v
    return total


def phase_distributed(torch, dev, card, device="cuda"):
    """The multi-process paths, the kernels built before any spawn:
    ``dryrun_multichip(2)`` (gloo ranks on ``device``) against each leg's
    one-process step on the same device (losses, parameters after the
    step; the seq leg's loss and gradient
    against the one-process assoc form); the ctc path's full-width model
    on a global batch of 32, two ranks of 16, for 3 steps against one
    process on the same batches (``hold_dp``: in the ranks' row blocks,
    every loss and parameter; on the whole batch, the first step), with
    the host-clock step times and the gradient reduction's share; a
    world of one over NCCL through ``train.py``'s rendezvous; both
    examples.  Returns (timing, kernel launches of the ranks and runs)."""
    from gtn_applications_tpu_torch import dryrun
    from gtn_applications_tpu_torch.parallel import mesh as pmesh

    t_phase = time.perf_counter()
    launches = {}
    results, refs = dryrun.dryrun_multichip(DIST_RANKS, device, "gloo", check=True,
                                            prefix=f"[{card}] ")
    leg_errs = {name: abs(results[0][name]["loss"] - refs[name]["loss"])
                / abs(refs[name]["loss"]) for name in refs}
    leg_param_errs = {name: max(float(np.abs(r[name]["params"][k] - ref).max())
                                for r in results for k, ref in refs[name]["params"].items())
                      for name in refs if name != dryrun.SEQ_LEG}
    seq_grad_err = float(np.abs(dryrun.assemble_seq_grad(results, DIST_RANKS)
                                - refs[dryrun.SEQ_LEG]["grad"]).max())
    for r in results:
        add_launches(launches, r["launches"])
    log(f"[{card}] dryrun_multichip({DIST_RANKS}) against one process on the card: loss "
        f"relative errors {json.dumps(leg_errs)}, parameters after the step max |d| "
        f"{json.dumps(leg_param_errs)}, seq leg gradient max |d| {seq_grad_err:.3g}")

    config = dp_config()
    batches = dp_batches(config)
    rank_device = f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda" else "cpu"
    t0 = time.perf_counter()
    ranks = pmesh.spawn(dp_rank, DIST_RANKS, args=(rank_device, config, batches),
                        backend="gloo", timeout=600)
    spawn_s = time.perf_counter() - t0
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        blocked = dp_steps(torch, dev, config, batches, blocks=DIST_RANKS)
        whole = dp_steps(torch, dev, config, batches)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    from gtn_applications_tpu_torch import train as train_mod

    init_model = train_mod.load_experiment(
        config, torch.Generator().manual_seed(config["seed"]))[3]
    init = {k: v.numpy() for k, v in init_model.state_dict().items()}
    errs = hold_dp(ranks, blocked, whole, init)
    for r in ranks:
        add_launches(launches, r["launches"])
    # the first step of each run builds its plans and algorithms: the later
    # steps' mean is the step time
    rank_ms = statistics.mean(statistics.mean(r["step_ms"][1:]) for r in ranks)
    one_ms = statistics.mean(whole["step_ms"][1:])
    reduce_ms = statistics.mean(r["reduce_ms"] for r in ranks)
    log(f"[{card}] full-width ctc step, {DIST_RANKS} gloo ranks of {DP_BATCH // DIST_RANKS} "
        f"on one card: {rank_ms:.2f} ms (host clock, steps 2-{DP_STEPS}), gradient "
        f"reduction ({whole['n_params']:,} parameters, gloo) {reduce_ms:.2f} "
        f"ms, {100 * reduce_ms / rank_ms:.1f}% of the step; one process of {DP_BATCH}: "
        f"{one_ms:.2f} ms (cuDNN deterministic on both); losses {ranks[0]['losses']}, one "
        f"process {whole['losses']}, in row blocks {blocked['losses']}; errors "
        f"{json.dumps(errs)}; spawn and steps {spawn_s:.1f} s")

    nccl_launches, nccl_s = world_of_one_nccl(torch, dev, card, WORK / "dist_nccl")
    add_launches(launches, nccl_launches)
    examples, example_launches = run_examples(torch, dev, card, WORK / "examples")
    add_launches(launches, example_launches)
    seconds = time.perf_counter() - t_phase
    log(f"[{card}] distributed phase: {seconds:.1f} s, launches {json.dumps(launches)}")
    timing = {"dryrun_loss_rel_err": leg_errs, "dryrun_param_max_abs_err": leg_param_errs,
              "dryrun_seq_grad_max_abs_err": seq_grad_err,
              "dp_rank_step_ms": rank_ms, "dp_one_process_step_ms": one_ms,
              "dp_reduce_ms": reduce_ms, "dp_reduce_share": reduce_ms / rank_ms,
              "dp_errors": errs,
              "dp_step_ms": {"ranks": [r["step_ms"] for r in ranks], "one": whole["step_ms"],
                             "blocks": blocked["step_ms"]},
              "nccl_world_of_one_s": nccl_s, "examples": examples,
              "distributed_s": seconds, "distributed_launches": launches}
    return timing, launches


# Phase 16, the sequence-parallel train step.  Leg (a): the hermetic
# long-context recipe as shipped (``seq_parallel`` 4, "assoc" CTC, chunk
# 256, 8 lines of 8,192-9,216 frames, 2 epochs) through ``train.train`` on
# SEQ_RANKS_A gloo ranks sharing the card, against one process: every
# epoch's losses within DP_LOSS_RTOL, the parameters after the last step
# within DP_PARAM_TOL, the error rates within SEQ_RATE_TOL points (a greedy
# decode of ~70,000 frames at random weights may flip a near tie of two
# logits 1e-6 apart).  Leg (b): the ctc path's full-width model (dropout 0,
# CTC "auto") on a 1 x SEQ_RANKS_B grid, DP_STEPS steps on the distributed
# phase's batches padded to a width that 8 divides, against one process:
# step 1's loss within DP_LOSS_RTOL and its update distance (the ranks'
# parameters from one process's, over one process's update) within
# SEQ_FIRST_TOL; the later steps' losses and the last update distance
# within SEQ_LATER_TOL.  Time shards move float32 rounding into the
# cotangents of every layer (halos, statistics), which the network
# amplifies.  On the chip machine's CPU (``scripts/seq_rounding.py
# --device cpu``, these batches) the two ranks lay 1.08e-7, 1.37e-6 and
# 1.71e-2 (losses, relative) and 2.47e-3 and 0.686 (update distance after
# steps 1 and 3) from one process; the first step's bound and the later
# losses' are 10x that, the last update distance's 1.0, under the sqrt(2)
# of two unrelated updates of one norm
SEQ_RANKS_A, SEQ_RANKS_B = 4, 2
SEQ_WIDTH_MULTIPLE = 8
SEQ_FIRST_TOL = 2.5e-2
SEQ_LATER_TOL = {"loss_rel": 0.17, "update_distance": 1.0}
SEQ_RATE_TOL = 1.0
SEQ_STEP_RUNS = 3


@contextlib.contextmanager
def timed_collectives(torch, dev):
    """Host-clock ms of the sequence-parallel collectives while inside:
    the halo exchanges, the statistics' all-reduces and the gathers along
    time (forward and backward), and the gradient reduction, each bracketed
    by device syncs.  Yields the dict it fills."""
    from gtn_applications_tpu_torch import train as train_mod
    from gtn_applications_tpu_torch.parallel import mesh as pmesh

    times = {"halo_ms": 0.0, "stats_ms": 0.0, "gather_ms": 0.0, "reduce_ms": 0.0}

    def timed(fn, key):
        def run(*args):
            sync(torch, dev)
            t0 = time.perf_counter()
            out = fn(*args)
            sync(torch, dev)
            times[key] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    saved = []
    for cls, key in ((pmesh._HaloExchange, "halo_ms"), (pmesh._AllReduceSum, "stats_ms"),
                     (pmesh._GatherOwnGrad, "gather_ms")):
        for name in ("forward", "backward"):
            saved.append((cls, name, cls.__dict__[name]))
            setattr(cls, name, staticmethod(timed(getattr(cls, name), key)))
    saved.append((train_mod, "reduce_gradients", train_mod.reduce_gradients))
    train_mod.reduce_gradients = timed(train_mod.reduce_gradients, "reduce_ms")
    try:
        yield times
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def seq_step_costs(torch, dev, config, inputs, targets, mesh=None):
    """A train step of the config's model (seed weights) on ``inputs``, on
    this rank's time shard over ``mesh`` (whole in one process): the
    host-clock median ms of SEQ_STEP_RUNS steps after a warm-up, the
    collectives' ms of one more step (``timed_collectives``), and the peak
    ``max_memory_allocated`` MiB over them above what the process held
    before them (the model, the batch and, in the whole smoke, the earlier
    phases' tensors)."""
    from gtn_applications_tpu_torch import train as train_mod

    _, _, crit, model, _ = train_mod.load_experiment(
        config, torch.Generator().manual_seed(config["seed"]))
    model.to(dev)
    train_mod.criterion_to_device(crit, dev)
    optim = config["optim"]
    groups = (mesh.group("data"), mesh.group("seq")) if mesh is not None else (None, None)
    step = train_mod.make_train_step(model, crit, optim["learning_rate"],
                                     optim["learning_rate"], optim["max_grad_norm"], *groups)
    x, axis = torch.as_tensor(inputs), None
    if mesh is not None:
        x, axis = train_mod.shard_time(x, mesh, 2, model)
        if axis is None:
            raise AssertionError(f"width {inputs.shape[2]} kept whole on the seq grid")
    x = x.to(dev)
    prepared = train_mod.to_device(crit.prepare(targets), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    times = []
    for k in range(SEQ_STEP_RUNS + 1):
        sync(torch, dev)
        t0 = time.perf_counter()
        step(x, prepared, gen, 1.0, None, axis)
        sync(torch, dev)
        times.append((time.perf_counter() - t0) * 1e3)
    with timed_collectives(torch, dev) as collectives:
        step(x, prepared, gen, 1.0, None, axis)
    peak = ((torch.cuda.max_memory_allocated(dev) - held) / 2**20 if dev.type == "cuda"
            else None)
    return dict(collectives, step_ms=statistics.median(times[1:]), peak_mib=peak,
                shard=list(x.shape))


def seq_rank_device(device):
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    return torch, dev


def first_train_batch(config):
    """The first batch of the trainer's loader: (inputs numpy, targets)."""
    from gtn_applications_tpu_torch import datasets, utils

    data = getattr(datasets, config["data"]["dataset"])
    pre = path_preprocessor(data, config)
    loader = utils.data_loader(data.Dataset(None, pre, split="train", augment=True),
                               config, seed=config["seed"])
    inputs, _, targets = next(iter(loader))
    return inputs, targets


def seq_recipe_rank(rank, n, device, cfg, work):
    """Leg (a) on a rank: ``train.train`` of the config file (its grid
    from ``optim.seq_parallel``), its history, final parameters and kernel
    launches, then ``seq_step_costs`` on its first batch."""
    from gtn_applications_tpu_torch import train as train_mod
    from gtn_applications_tpu_torch.ops import _build
    from gtn_applications_tpu_torch.parallel import mesh as pmesh

    torch, dev = seq_rank_device(device)
    argv = ["--config", cfg, "--checkpoint_path", f"{work}/rank{rank}"]
    _build.reset_launches()
    model, history = train_mod.train(train_mod.parse_args(
        argv + (["--disable_cuda"] if dev.type == "cpu" else [])))
    launches = dict(_build.LAUNCHES)
    config = json.loads(Path(cfg).read_text())
    costs = seq_step_costs(torch, dev, config, *first_train_batch(config),
                           pmesh.make_mesh(config["optim"]["seq_parallel"]))
    return {"history": history, "launches": launches, "costs": costs,
            "params": {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}}


def seq_dp_rank(rank, n, device, config, batches):
    """Leg (b) on a rank: ``dp_steps`` on its time shards of a 1 x n grid,
    then ``seq_step_costs`` on the first batch."""
    from gtn_applications_tpu_torch.parallel import mesh as pmesh

    torch, dev = seq_rank_device(device)
    mesh = pmesh.make_mesh(n)
    out = dp_steps(torch, dev, config, batches, mesh)
    out["costs"] = seq_step_costs(torch, dev, config, *batches[0], mesh)
    return out


def pad_width(inputs, multiple):
    """``inputs`` [B, H, W] zero-padded along W to a multiple of
    ``multiple``."""
    pad = -inputs.shape[2] % multiple
    return np.pad(inputs, ((0, 0), (0, 0), (0, pad))) if pad else inputs


def _rel(a, b):
    return abs(a - b) / abs(b)


def seq_leg_recipe(torch, dev, card, device):
    """Leg (a): ``long_ctx_assoc.json`` as shipped on SEQ_RANKS_A ranks
    against one process (cuDNN deterministic on both): every epoch's
    losses, the error rates, the parameters after the last step."""
    from gtn_applications_tpu_torch import train as train_mod
    from gtn_applications_tpu_torch.ops import _build
    from gtn_applications_tpu_torch.parallel import mesh as pmesh

    config = main_path_config("ctc_long_assoc")
    if config["optim"].get("seq_parallel") != SEQ_RANKS_A:
        raise AssertionError(f"long_ctx_assoc.json: seq_parallel {config['optim']}")
    work = WORK / "seq_recipe"
    work.mkdir(parents=True, exist_ok=True)
    cfg = work / "config.json"
    cfg.write_text(json.dumps(config))
    t0 = time.perf_counter()
    ranks = pmesh.spawn(seq_recipe_rank, SEQ_RANKS_A,
                        args=(device, str(cfg), str(work)), backend="gloo", timeout=900)
    spawn_s = time.perf_counter() - t0
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _build.reset_launches()
        model, history = train_mod.train(train_mod.parse_args(
            ["--config", str(cfg), "--checkpoint_path", str(work / "one")]
            + (["--disable_cuda"] if dev.type == "cpu" else [])))
        launches = dict(_build.LAUNCHES)
        one = seq_step_costs(torch, dev, config, *first_train_batch(config))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    params = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    errs = {"loss_rel": 0.0, "rate_abs": 0.0, "param_max_abs": 0.0}
    failures = []
    for rank, r in enumerate(ranks):
        if len(r["history"]) != len(history):
            failures.append(f"rank {rank}: {len(r['history'])} epochs")
        for got, want in zip(r["history"], history):
            for key in ("train_loss", "val_loss", "train_cer", "val_cer", "val_wer"):
                loss = key.endswith("loss")
                err = _rel(got[key], want[key]) if loss else abs(got[key] - want[key])
                errs["loss_rel" if loss else "rate_abs"] = max(
                    errs["loss_rel" if loss else "rate_abs"], err)
                if err > (DP_LOSS_RTOL if loss else SEQ_RATE_TOL):
                    failures.append(f"rank {rank} epoch {got['epoch']}: {key} {got[key]} "
                                    f"against {want[key]}")
        for k, v in params.items():
            d = np.abs(r["params"][k] - v)
            errs["param_max_abs"] = max(errs["param_max_abs"], float(d.max()))
            if (d > DP_PARAM_TOL["atol"] + DP_PARAM_TOL["rtol"] * np.abs(v)).any():
                failures.append(f"rank {rank}: parameter {k}, max |d| {float(d.max()):.3g}")
        add_launches(launches, r["launches"])
    costs = [r["costs"] for r in ranks]
    log(f"[{card}] seq leg (a) long_ctx_assoc.json, {SEQ_RANKS_A} gloo ranks on one card "
        f"(time shard {costs[0]['shard']}): step {statistics.mean(c['step_ms'] for c in costs):.2f}"
        f" ms a rank against one process's {one['step_ms']:.2f} ms (host clock, median of "
        f"{SEQ_STEP_RUNS}); collectives a step: halo {statistics.mean(c['halo_ms'] for c in costs):.2f}"
        f" ms, statistics {statistics.mean(c['stats_ms'] for c in costs):.2f} ms, gathers "
        f"{statistics.mean(c['gather_ms'] for c in costs):.2f} ms, gradient reduction "
        f"{statistics.mean(c['reduce_ms'] for c in costs):.2f} ms; peak memory "
        f"{max(c['peak_mib'] or 0 for c in costs):.1f} MiB a rank against "
        f"{one['peak_mib'] or 0:.1f} MiB; history against one process's (errors "
        f"{json.dumps(errs)}): {json.dumps(ranks[0]['history'])}; spawn {spawn_s:.1f} s")
    if failures:
        raise AssertionError("leg (a) against one process: " + "; ".join(failures))
    return {"ranks": costs, "one": one, "errors": errs, "history": ranks[0]["history"],
            "spawn_s": spawn_s}, launches


def seq_leg_full_width(torch, dev, card, device):
    """Leg (b): the ctc path's full-width model on a 1 x SEQ_RANKS_B grid
    against one process on the same padded batches (cuDNN deterministic):
    step 1's loss at DP_LOSS_RTOL and update distance at SEQ_FIRST_TOL, the
    later steps' losses and the last update distance at SEQ_LATER_TOL."""
    from gtn_applications_tpu_torch import train as train_mod
    from gtn_applications_tpu_torch.parallel import mesh as pmesh

    config = dp_config()
    batches = [(pad_width(x, SEQ_WIDTH_MULTIPLE), t) for x, t in dp_batches(config)]
    t0 = time.perf_counter()
    ranks = pmesh.spawn(seq_dp_rank, SEQ_RANKS_B, args=(device, config, batches),
                        backend="gloo", timeout=600)
    spawn_s = time.perf_counter() - t0
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        whole = dp_steps(torch, dev, config, batches)
        one = seq_step_costs(torch, dev, config, *batches[0])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    init = {k: v.numpy() for k, v in train_mod.load_experiment(
        config, torch.Generator().manual_seed(config["seed"]))[3].state_dict().items()}
    launches = dict(whole["launches"])
    for r in ranks:
        add_launches(launches, r["launches"])
    errs = {"loss_rel": [max(_rel(r["losses"][i], whole["losses"][i]) for r in ranks)
                         for i in range(DP_STEPS)],
            "first_update_distance": max(update_distance(r["first"], whole["first"], init)
                                         for r in ranks),
            "update_distance": max(update_distance(r["params"], whole["params"], init)
                                   for r in ranks),
            "first_param_max_abs": max(float(np.abs(r["first"][k] - v).max())
                                       for r in ranks for k, v in whole["first"].items())}
    failures = []
    if errs["loss_rel"][0] > DP_LOSS_RTOL or errs["first_update_distance"] > SEQ_FIRST_TOL:
        failures.append(f"step 1 beyond loss {DP_LOSS_RTOL}, update {SEQ_FIRST_TOL}")
    if (max(errs["loss_rel"][1:]) > SEQ_LATER_TOL["loss_rel"]
            or errs["update_distance"] > SEQ_LATER_TOL["update_distance"]):
        failures.append(f"steps 2-{DP_STEPS} beyond {SEQ_LATER_TOL}")
    costs = [r["costs"] for r in ranks]
    log(f"[{card}] seq leg (b) tds2d.json full width, {SEQ_RANKS_B} gloo ranks on one card "
        f"(time shard {costs[0]['shard']} of width {batches[0][0].shape[2]}): step "
        f"{statistics.mean(c['step_ms'] for c in costs):.2f} ms a rank against one process's "
        f"{one['step_ms']:.2f} ms (host clock, median of {SEQ_STEP_RUNS}); collectives a step: "
        f"halo {statistics.mean(c['halo_ms'] for c in costs):.2f} ms, statistics "
        f"{statistics.mean(c['stats_ms'] for c in costs):.2f} ms, gathers "
        f"{statistics.mean(c['gather_ms'] for c in costs):.2f} ms, gradient reduction "
        f"{statistics.mean(c['reduce_ms'] for c in costs):.2f} ms; peak memory "
        f"{max(c['peak_mib'] or 0 for c in costs):.1f} MiB a rank against "
        f"{one['peak_mib'] or 0:.1f} MiB; losses {ranks[0]['losses']}, one process "
        f"{whole['losses']}; errors {json.dumps(errs)}; spawn {spawn_s:.1f} s")
    if failures:
        raise AssertionError(f"leg (b) against one process: {failures}: {errs}")
    return {"ranks": costs, "one": one, "errors": errs, "spawn_s": spawn_s}, launches


def phase_seq_parallel(torch, dev, card, device="cuda"):
    """The sequence-parallel train step on gloo ranks sharing the card,
    both legs against one process.  Returns (timing, kernel launches of the
    ranks and the one-process runs)."""
    t0 = time.perf_counter()
    rank_device = f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda" else "cpu"
    try:
        recipe, launches = seq_leg_recipe(torch, dev, card, rank_device)
    except AssertionError as exc:  # leg (b) still runs and logs its numbers
        recipe, launches = exc, {}
    full, more = seq_leg_full_width(torch, dev, card, rank_device)
    if isinstance(recipe, AssertionError):
        raise recipe
    add_launches(launches, more)
    seconds = time.perf_counter() - t0
    log(f"[{card}] sequence-parallel phase: {seconds:.1f} s, launches {json.dumps(launches)}")
    return {"seq_recipe": recipe, "seq_full_width": full, "seq_parallel_s": seconds,
            "seq_parallel_launches": launches}, launches


# JAX's route switches on the card (phase 17): each switched route on the
# batch of a path against the default route on the same inputs
@contextlib.contextmanager
def switched(module, name, value):
    """``module.name`` set to ``value`` (a route switch) inside."""
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def route_batch(torch, dev, path):
    """The loader's first train batch of ``path`` through the path's model
    at its seeded initial weights, in eval mode: (criterion in eval mode,
    logits on the card, targets, the criterion's parameters on the card:
    N(0, 0.3) transitions where it has any)."""
    from gtn_applications_tpu_torch import train as train_mod
    from gtn_applications_tpu_torch import utils

    config = main_path_config(path)
    dataset, pre, crit, model, _ = train_mod.load_experiment(
        config, generator=torch.Generator().manual_seed(config["seed"]))
    model.to(dev).eval()
    loader = utils.data_loader(dataset.Dataset(None, pre, split="train"), config,
                               seed=config["seed"])
    inputs, _, targets = next(iter(loader))
    with torch.no_grad():
        logits = model(torch.from_numpy(inputs).to(dev))
    crit.eval()
    params = {}
    if getattr(crit, "num_transition_arcs", 0):
        params["transitions"] = torch.as_tensor(
            (np.random.RandomState(21).randn(crit.num_transition_arcs) * 0.3)
            .astype(np.float32), device=dev)
    return crit, logits, targets, params


def host_ms(torch, fn, runs=5, warmup=1):
    """Host-clock median ms of ``runs`` calls of ``fn``, each ending in a
    synchronise (after ``warmup``)."""
    ms = []
    for i in range(warmup + runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def route_run(torch, crit, logits, prepared, params, launched):
    """(loss, [logit gradient, then the parameters']) of one loss and
    backward; the kernels it launched are added to ``launched``."""
    from gtn_applications_tpu_torch.ops import _build

    x = logits.detach().clone().requires_grad_(True)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    before = dict(_build.LAUNCHES)
    loss = crit.loss(p, x, prepared)
    grads = torch.autograd.grad(loss, [x] + list(p.values()))
    torch.cuda.synchronize()
    add_launches(launched, {k: n - before[k] for k, n in _build.LAUNCHES.items()})
    return loss.detach().double().cpu(), [g.double().cpu() for g in grads]


def only_launched(launched, want, what):
    """Raise unless the route launched exactly the kernels of ``want``
    (name -> count, or None for at least one)."""
    got = {k: n for k, n in launched.items() if n}
    want = {k: n for k, n in want.items() if n != 0}
    if set(got) != set(want) or any(n is not None and got[k] != n for k, n in want.items()):
        raise AssertionError(f"{what} launched {got}, expected {want}")


def route_stc(torch, dev, card):
    """STC's first batch under ``GTN_STC_DENSE=off`` (the sparse tier: one
    whole sparse scan forward and backward, its union table of depth 0)
    against the dense route (one dense-scan forward and backward): the loss
    and logit gradient at card_vs_cpu's bounds (1e-4, 1e-5); then the
    sparse kernels against their plain versions on that table."""
    import dataclasses

    from gtn_applications_tpu_torch.criterions import stc as stc_mod
    from gtn_applications_tpu_torch.train import to_device

    crit, logits, targets, params = route_batch(torch, dev, "stc")
    dense = to_device(crit.prepare(targets), dev)
    with switched(stc_mod, "_DENSE_IMPL", "off"):
        sparse_prep = to_device(crit.prepare(targets), dev)
    if "dense" not in dense or "dense" in sparse_prep:
        raise AssertionError("stc: GTN_STC_DENSE does not choose the tier")
    ref_launch, got_launch = {}, {}
    ref = route_run(torch, crit, logits, dense, params, ref_launch)
    got = route_run(torch, crit, logits, sparse_prep, params, got_launch)
    only_launched(ref_launch, {"dense_scan_fwd": 1, "dense_scan_bwd": 1}, "stc dense route")
    only_launched(got_launch, {"sparse_scan_fwd": 1, "sparse_scan_bwd": 1},
                  "stc under GTN_STC_DENSE=off")
    d_loss = float((got[0] - ref[0]).abs())
    d_grad = float((got[1][0] - ref[1][0]).abs().max())
    log(f"[{card}] route GTN_STC_DENSE=off, stc first batch {list(logits.shape)}: loss "
        f"{float(got[0]):.6f} against the dense route's |d| {d_loss:.3g}, logit grad "
        f"max|d| {d_grad:.3g}; launches {got_launch}")
    if not (d_loss <= 1e-4 and d_grad <= 1e-5):
        raise AssertionError("stc: the sparse tier and the dense route disagree")
    em = crit.star_channels(torch.log_softmax(logits, 2), sparse_prep["select"])
    table = sparse_prep["table"]
    table = dataclasses.replace(
        table, weight=table.weight + sparse_prep["star_mask"] * sparse_prep["log_penalty"])
    bsz, frames = logits.shape[:2]
    il = torch.full((bsz,), frames, dtype=torch.int32, device=dev)
    errs = hold_sparse_kernels(torch, em.contiguous(), table, il,
                               ("route stc sparse tier", bsz, frames))
    ms = {name: host_ms(torch, lambda p=prep: route_run(torch, crit, logits, p, params, {}))
          for name, prep in (("dense", dense), ("sparse", sparse_prep))}
    log(f"[{card}] stc first batch loss fwd+bwd (host clock, median of 5): dense route "
        f"{ms['dense']:.3f} ms, GTN_STC_DENSE=off {ms['sparse']:.3f} ms")
    return errs, got_launch, {"stc_loss_abs_diff": d_loss, "stc_logit_grad_max_abs_diff": d_grad,
                              "stc_shape": list(logits.shape),
                              "stc_fwd_bwd_ms": ms}


def rel_errs(got, ref):
    """(|d loss|, each gradient's max|d| over its largest |entry|)."""
    return (float((got[0] - ref[0]).abs()),
            [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got[1], ref[1])])


def step_alphas(torch, em, table, frames):
    """The per-step scan's alpha [B, S] before each frame of ``frames``
    (ascending) on ``table`` over em [B, T, C], advanced by the kernels
    (seg_lse a step and its closure) without gradients, every frame live;
    with the arcs' emissions [B, T, A]."""
    from gtn_applications_tpu_torch.ops import seglse_pallas as slp
    from gtn_applications_tpu_torch.ops.semiring import gather_channels, logaddexp

    (src, dst, label, w, esrc, edst, ew), start, _, depth = sparse_fields(table)
    B, S = em.shape[0], start.shape[-1]
    em_arc = gather_channels(em, label.expand(B, label.shape[-1]).contiguous())
    idx, eidx = slp.arc_index(src, dst, S), slp.arc_index(esrc, edst, S) if depth else None

    def closure(alpha):
        acc = cur = alpha
        for _ in range(depth):
            cur = slp.seg_lse(cur, esrc, edst, ew, None, eidx)
            acc = logaddexp(acc, cur)
        return acc

    out, alpha = {}, closure(start.expand(B, S)).contiguous()
    with torch.no_grad():
        for t in range(max(frames) + 1):
            if t in frames:
                out[t] = alpha
            alpha = closure(slp.seg_lse(alpha, src, dst, w, em_arc[:, t].contiguous(), idx))
    return out, em_arc, idx


def route_trigram(torch, dev, card):
    """The trigram path's first batch (its composed tables and grapheme
    trigram, N(0, 0.3) transitions) under ``GTN_SPARSE_SCAN=step`` (each
    frame a seg_lse and its closure, the gather pair around: no whole
    scan) against the whole scan: the loss within 1e-4 and each gradient
    within 1e-3 of its largest entry (card_vs_cpu64's bounds; the step
    route carries its state a frame at a time in float32, as the CPU's
    float32 route does, the whole scan in float64).  Then the decode under
    ``GTN_VITERBI_SCAN=step`` (a seg_max launch a frame and the walk)
    against the whole-scan Viterbi's: labels equal, scores within 1e-6 of
    their size; seg_lse held against its plain versions on two frames of
    each table, seg_max on every frame of the decode."""
    from gtn_applications_tpu_torch.ops import _build
    from gtn_applications_tpu_torch.ops import sparse as sparse_mod
    from gtn_applications_tpu_torch.ops import segmax_pallas as smp
    from gtn_applications_tpu_torch.ops.seglse_pallas import arc_index, take
    from gtn_applications_tpu_torch.train import to_device

    crit, logits, targets, params = route_batch(torch, dev, "transducer_backoff")
    prepared = crit.prepare(targets)
    on_dev = to_device(prepared, dev)
    launched, whole_launch = {}, {}
    whole = route_run(torch, crit, logits, on_dev, params, whole_launch)
    with switched(sparse_mod, "_SCAN_IMPL", "step"):
        step = route_run(torch, crit, logits, on_dev, params, launched)
    # a table of closure depth d: d seg_lse for its start, then the step
    # route's 1 + d a frame, or one whole scan
    tables = transducer_tables(torch, dev, crit, prepared, params["transitions"])
    depths = [sparse_fields(t)[3] for t in tables.values()]
    bsz, frames = logits.shape[:2]
    starts = sum(depths)
    steps = starts + sum(frames * (1 + d) for d in depths)
    only_launched(whole_launch, dict(sparse_scan_fwd=2, sparse_scan_bwd=2, seg_lse_fwd=starts,
                                     seg_lse_bwd=starts), "trigram whole scan")
    only_launched(launched, dict(gather_fwd=2, gather_bwd=2, seg_lse_fwd=steps,
                                 seg_lse_bwd=steps), "trigram under GTN_SPARSE_SCAN=step")
    d_loss, d_grads = rel_errs(step, whole)
    out = {"shape": list(logits.shape), "step_vs_whole_loss_abs_diff": d_loss,
           "step_vs_whole_grad_rel_errs": d_grads}
    log(f"[{card}] route GTN_SPARSE_SCAN=step, trigram first batch {out['shape']}: loss "
        f"{float(step[0]):.6f} against the whole scan's |d| {d_loss:.3g} (bound 1e-4), "
        f"logit and transitions grads max|d| / max|p| {d_grads[0]:.3g}, {d_grads[1]:.3g} "
        f"(bound 1e-3); launches {launched}")
    if not (d_loss <= 1e-4 and all(d <= 1e-3 for d in d_grads)):
        raise AssertionError("trigram: the step route and the whole scan disagree")

    # seg_lse on two frames of each table, kernels against plain versions
    errs = {}
    rng = np.random.RandomState(22)
    for key, table in tables.items():
        (src, dst, _, w, _, _, _), start, _, _ = sparse_fields(table)
        alphas, em_arc, idx = step_alphas(torch, logits.contiguous(), table,
                                          (0, frames // 2))
        for t, alpha in alphas.items():
            g = torch.as_tensor(rng.rand(bsz, alpha.shape[1]).astype(np.float32), device=dev)
            step_errs, _ = hold_seglse(torch, alpha, src, dst, w, em_arc[:, t].contiguous(),
                                       idx, g, ("route step trigram", key, "frame", t),
                                       floor32=True)
            merge_errs(errs, step_errs)

    # the decode: the whole-scan Viterbi, then seg_max a frame
    table = crit._decode_table({"transitions": params["transitions"].cpu()})
    il = torch.full((bsz,), frames, dtype=torch.int32, device=dev)
    vit_launch = {}
    before = dict(_build.LAUNCHES)
    lab_w, score_w = sparse_mod.viterbi_batch(logits, table, il)
    torch.cuda.synchronize()
    add_launches(vit_launch, {k: n - before[k] for k, n in _build.LAUNCHES.items()})
    only_launched(vit_launch, {"viterbi_scan_fwd": 1, "viterbi_backtrace": 1},
                  "trigram decode (whole)")
    step_launch = {}
    before = dict(_build.LAUNCHES)
    with switched(sparse_mod, "_VIT_IMPL", "step"):
        lab_s, score_s = sparse_mod.viterbi_batch(logits, table, il)
    torch.cuda.synchronize()
    add_launches(step_launch, {k: n - before[k] for k, n in _build.LAUNCHES.items()})
    only_launched(step_launch, {"seg_max": frames}, "trigram decode under GTN_VITERBI_SCAN=step")
    add_launches(launched, step_launch)
    d_score = float(((score_s - score_w).abs() / score_w.abs().clamp(min=1.0)).max())
    if not torch.equal(lab_s, lab_w) or not d_score <= 1e-6:
        raise AssertionError(f"trigram decode: the step route differs from the whole-scan "
                             f"Viterbi (labels equal {torch.equal(lab_s, lab_w)}, score "
                             f"relative |d| {d_score:.3g})")
    # seg_max on every frame of that decode, kernel against plain, bitwise
    src, dst, label = (t.to(dev)[None] for t in (table.src, table.dst, table.label))
    w = table.weight.to(dev)[None].float()
    S, C = table.start.shape[0], logits.shape[2]
    idx = arc_index(src, dst, S, label, C)
    w_s = take(w, idx.order)
    alpha = table.start.to(dev).float().expand(bsz, S).contiguous()
    for t in range(frames):
        row = logits[:, t]
        new_k, arc_k = smp.seg_max_cuda(alpha, w_s, row, idx)
        new_p, arc_p = smp.seg_max_plain(alpha, src, dst, w, row, label)
        if not (torch.equal(new_k, new_p) and torch.equal(arc_k, arc_p)):
            raise AssertionError(f"seg_max: the kernel differs from plain at decode frame {t}")
        alpha = new_k
    errs["seg_max"] = 0.0
    log(f"[{card}] route GTN_VITERBI_SCAN=step, trigram decode {[bsz, frames, C]}: labels "
        f"equal to the whole-scan Viterbi's, score relative max|d| {d_score:.3g}, "
        f"{step_launch} launches; seg_max bitwise equal to plain on all {frames} frames")
    out.update(decode_score_rel_diff=d_score, decode_shape=[bsz, frames, C])
    # each route's loss fwd+bwd and decode (host clock, median of 3, each
    # route warm from its check above)
    runs = dict(runs=3, warmup=0)
    out["fwd_bwd_ms"] = {"whole": host_ms(
        torch, lambda: route_run(torch, crit, logits, on_dev, params, {}), **runs)}
    with switched(sparse_mod, "_SCAN_IMPL", "step"):
        out["fwd_bwd_ms"]["step"] = host_ms(
            torch, lambda: route_run(torch, crit, logits, on_dev, params, {}), **runs)
    out["decode_ms"] = {"whole": host_ms(
        torch, lambda: sparse_mod.viterbi_batch(logits, table, il), **runs)}
    with switched(sparse_mod, "_VIT_IMPL", "step"):
        out["decode_ms"]["step"] = host_ms(
            torch, lambda: sparse_mod.viterbi_batch(logits, table, il), **runs)
    log(f"[{card}] trigram first batch (host clock, median of 3): loss fwd+bwd whole scan "
        f"{out['fwd_bwd_ms']['whole']:.3f} ms, GTN_SPARSE_SCAN=step "
        f"{out['fwd_bwd_ms']['step']:.3f} ms; decode whole-scan Viterbi "
        f"{out['decode_ms']['whole']:.3f} ms, GTN_VITERBI_SCAN=step "
        f"{out['decode_ms']['step']:.3f} ms")
    return errs, launched, out


def phase_routes(torch, dev, card):
    """JAX's route switches on the card: STC under GTN_STC_DENSE=off, the
    trigram under GTN_SPARSE_SCAN=step and its decode under
    GTN_VITERBI_SCAN=step, each against the default route.  Returns
    (errors, the switched routes' launches, timing)."""
    t0 = time.perf_counter()
    errs, launched, stc = route_stc(torch, dev, card)
    more_errs, more_launched, trigram = route_trigram(torch, dev, card)
    merge_errs(errs, more_errs)
    add_launches(launched, more_launched)
    return errs, launched, {"routes_stc": stc, "routes_trigram": trigram,
                            "routes_s": time.perf_counter() - t0}


KERNELS = [
    ("gather_fwd", "gtn_applications_tpu_torch/ops/csrc/gather.cu",
     "gtn_applications_tpu/ops/gathers.py:30", "torch_gather"),
    ("gather_bwd", "gtn_applications_tpu_torch/ops/csrc/gather.cu",
     "gtn_applications_tpu/ops/gathers.py:44", "torch_scatter_add"),
    ("ctc_alpha", "gtn_applications_tpu_torch/ops/csrc/ctc.cu",
     "gtn_applications_tpu/ops/lattice_pallas.py:57", "f_ctc_loss_fwd"),
    ("ctc_grad", "gtn_applications_tpu_torch/ops/csrc/ctc.cu",
     "gtn_applications_tpu/ops/lattice_pallas.py:79", "f_ctc_loss_fwd_bwd"),
    ("dense_bt", "gtn_applications_tpu_torch/ops/csrc/viterbi.cu",
     "gtn_applications_tpu/ops/viterbi_scan_pallas.py:239", None),
    ("dense_scan_fwd", "gtn_applications_tpu_torch/ops/csrc/dense_scan.cu",
     "gtn_applications_tpu/ops/dense_scan_pallas.py:90", None),
    ("dense_scan_bwd", "gtn_applications_tpu_torch/ops/csrc/dense_scan.cu",
     "gtn_applications_tpu/ops/dense_scan_pallas.py:119", None),
    ("viterbi_scan_fwd", "gtn_applications_tpu_torch/ops/csrc/viterbi.cu",
     "gtn_applications_tpu/ops/viterbi_scan_pallas.py:153", None),
    ("viterbi_backtrace", "gtn_applications_tpu_torch/ops/csrc/viterbi.cu",
     "gtn_applications_tpu/ops/viterbi_scan_pallas.py:191", None),
    ("factored_scan_fwd", "gtn_applications_tpu_torch/ops/csrc/dense_scan.cu",
     "gtn_applications_tpu/ops/dense_scan_pallas.py:276", None),
    ("factored_scan_bwd", "gtn_applications_tpu_torch/ops/csrc/dense_scan.cu",
     "gtn_applications_tpu/ops/dense_scan_pallas.py:308", None),
    ("seg_lse_fwd", "gtn_applications_tpu_torch/ops/csrc/sparse_scan.cu",
     "gtn_applications_tpu/ops/seglse_pallas.py:69", None),
    ("seg_lse_bwd", "gtn_applications_tpu_torch/ops/csrc/sparse_scan.cu",
     "gtn_applications_tpu/ops/seglse_pallas.py:97", None),
    ("sparse_scan_fwd", "gtn_applications_tpu_torch/ops/csrc/sparse_scan.cu",
     "gtn_applications_tpu/ops/sparse_scan_pallas.py:265", None),
    ("sparse_scan_bwd", "gtn_applications_tpu_torch/ops/csrc/sparse_scan.cu",
     "gtn_applications_tpu/ops/sparse_scan_pallas.py:312", None),
    ("seg_max", "gtn_applications_tpu_torch/ops/csrc/sparse_scan.cu",
     "gtn_applications_tpu/ops/segmax_pallas.py:41", None),
    ("seg_max_scan", "gtn_applications_tpu_torch/ops/csrc/sparse_scan.cu",
     "gtn_applications_tpu/ops/segmax_pallas.py:41", None),
]


# the seconds of each phase, each also printed on a line of its own
PHASE_S = {}


def timed(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its seconds printed and kept in PHASE_S."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    PHASE_S[name] = time.perf_counter() - t0
    log(f"phase {name}: {PHASE_S[name]:.1f} s")
    return out


# the first-batch checks of the main paths (phase 13), in order
MAIN_BATCH_CHECKS = {
    "ctc": phase_main_batch, "asg": phase_main_batch_asg, "stc": phase_main_batch_stc,
    "transducer": phase_main_batch_transducer,
    "transducer_backoff": phase_main_batch_backoff,
    "transducer_backoff_4gram": phase_main_batch_backoff_4gram,
    "ctc_wordpieces": functools.partial(phase_main_batch, path="ctc_wordpieces"),
    "convtrans": phase_main_batch_convtrans,
    "transducer_wordpieces": functools.partial(phase_main_batch_word_decomps,
                                               path="transducer_wordpieces"),
    "transducer_speech": functools.partial(phase_main_batch_word_decomps,
                                           path="transducer_speech"),
    "ctc_words": functools.partial(phase_main_batch, path="ctc_words"),
}


def main_paths(torch, dev, names):
    """Phases 12 and 13 for the paths ``names``: each path's run, then each
    one's first-batch check.  Returns (paths, errors, differences)."""
    paths = {path: timed(f"main_path_{path}", phase_main_path, torch, dev, path,
                         main_path_config(path)) for path in names}
    errs, diffs = {}, {}
    for path, check in MAIN_BATCH_CHECKS.items():
        if path in paths:
            main_errs, more = timed(f"main_batch_{path}", check, torch, dev,
                                    paths[path]["model"], main_path_config(path))
            merge_errs(errs, main_errs)
            diffs.update(more)
    return paths, errs, diffs


def recipe_times(torch, dev, card, paths):
    """``recipe_costs`` of the recipe paths."""
    return {f"recipe_{path}": recipe_costs(torch, dev, card, path, paths[path]["model"],
                                           main_path_config(path))
            for path in RECIPE_PATHS}


def run(device="cuda", only=None):
    """Every phase; with ``only`` one of "distributed", "seq" or "routes",
    the device, the build and that phase alone (a quicker check of it,
    which prints no result line)."""
    import torch

    import gtn_applications_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = timed("device", phase_device, torch)
    dev = torch.device(device)
    build_s = timed("build", phase_build)
    if only in ("distributed", "seq", "routes"):
        phase, at = {"distributed": (phase_distributed, 0), "seq": (phase_seq_parallel, 0),
                     "routes": (phase_routes, 2)}[only]
        timing = timed(only, phase, torch, dev, card)[at]
        print(json.dumps({"timing": dict(timing, build_s=build_s, phase_s=PHASE_S)}))
        return
    if only is not None:
        raise ValueError(f"unknown phase {only!r}")
    errs = timed("gather", phase_gather, torch, dev)
    errs.update(timed("ctc", phase_ctc, torch, dev))
    chunk_errs, chunk_rows = timed("ctc_chunked", phase_ctc_chunked, torch, dev, card)
    merge_errs(errs, timed("dense_bt", phase_dense_bt, torch, dev))
    merge_errs(errs, timed("dense_scan", phase_dense_scan, torch, dev))
    merge_errs(errs, timed("factored_scan", phase_factored_scan, torch, dev))
    merge_errs(errs, timed("viterbi", phase_viterbi, torch, dev))
    merge_errs(errs, timed("sparse", phase_sparse, torch, dev))
    backoff_factored = timed("backoff_factored", phase_backoff_factored, torch, dev, card)
    merge_errs(errs, timed("segmax", phase_segmax, torch, dev))
    wordpiece_s = timed("wordpieces", wordpiece_inventories)
    paths, main_errs, diffs = main_paths(torch, dev, PATHS)
    merge_errs(errs, main_errs)
    diffs.update(timed("bf16_gap", phase_bf16_gap, torch, dev, paths["ctc_bf16"]["model"],
                       main_path_config("ctc_bf16"), card))
    times, bounds, chain = timed("times", phase_times, torch, dev, paths)
    times.update(timed("recipe_times", recipe_times, torch, dev, card, paths))
    for path in PATHS:
        log(f"[{card}] train step {path}: {times[f'train_step_{path}']:.2f} ms (host clock, "
            f"median of {step_runs(path)[0]}), batch {times[f'train_step_{path}_shape']}")
    for name, fn in (("dense_times", dense_times), ("factored_times", factored_times),
                     ("sparse_times", sparse_times)):
        more = timed(name, fn, torch, dev)
        times.update(more[0])
        bounds.update(more[1])
        chain.update(more[2])
    more_times, more_bounds, more_chain = timed(
        "segmax_times", segmax_times, torch, dev, paths["transducer_backoff_4gram"]["model"],
        main_path_config("transducer_backoff_4gram"))
    times.update(more_times)
    bounds.update(more_bounds)
    chain.update(more_chain)
    conv = convtrans_times(torch, dev, paths["convtrans"]["model"],
                           main_path_config("convtrans"), times["train_step_convtrans"])
    times["convtrans_conv"] = conv
    log(f"[{card}] ConvTransduce1D of the convtrans step's batch ({conv['route']}, input "
        f"{conv['shape']}): fwd {conv[conv['route'] + '_fwd_ms']:.3f} ms, fwd+bwd "
        f"{conv[conv['route'] + '_fwd_bwd_ms']:.3f} ms (CUDA events, median of 10), "
        f"{100 * conv['share']:.1f}% of the train step's {conv['train_step_ms']:.2f} ms; "
        + ", ".join(f"{k} {v:.3f}" for k, v in conv.items() if k.endswith("_ms")
                    and not k.startswith(conv["route"]) and k != "train_step_ms"))
    b, frames, _, n = diffs["transducer_main_batch_shape"]
    times["dense_ngram_norm_fwd_bwd"], times["dense_ngram_norm_launches"] = norm_cost(
        torch, dev, b, frames, n)
    # a one-step kernel's dependent chain is one frame: no launch of it can
    # take less than an empty kernel's (``launch_probe``)
    for name in ("seg_lse_fwd", "seg_lse_bwd", "seg_max"):
        chain[name] = times["launch_probe"]
    dist_timing, dist_launches = timed("distributed", phase_distributed, torch, dev, card)
    times.update(dist_timing)
    seq_timing, seq_launches = timed("seq_parallel", phase_seq_parallel, torch, dev, card)
    times.update(seq_timing)
    route_errs, route_launches, route_timing = timed("routes", phase_routes, torch, dev, card)
    merge_errs(errs, route_errs)
    times.update(route_timing)

    launches = {name: sum(p["launches"][name] for p in paths.values())
                + dist_launches.get(name, 0) + seq_launches.get(name, 0)
                + route_launches.get(name, 0) for name, *_ in KERNELS}
    timing = dict(times, card=card, build_s=build_s, wordpiece_s=wordpiece_s, **diffs,
                  phase_s=PHASE_S,
                  backoff_factored=backoff_factored,
                  f_ctc_loss_abs_diff=errs["f_ctc_loss_abs_diff"],
                  f_ctc_grad_max_abs_diff=errs["f_ctc_grad_max_abs_diff"],
                  step_decode_score_abs_diff=errs["step_decode_score"])
    for path, info in paths.items():
        timing[f"main_path_{path}_s"] = info["seconds"]
        timing[f"main_path_{path}_launches"] = info["launches"]
        timing[f"main_path_{path}_steps"] = info["steps"]
        timing[f"main_path_{path}_eval_batches"] = info["evals"]
        timing[f"main_path_{path}_test"] = info["test"]
    kernels = []
    for name, source, replaces, library in KERNELS:
        b_ms, b_by = bounds[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": times[name],
            "plain_ms": times[f"{name}_plain"], "bound_ms": b_ms,
            "bound_by": b_by, "chain_bound_ms": chain.get(name),
            "library_ms": times[library] if library else None,
        })
        # dadj's entries reach 1e38, so its absolute error says little: the
        # entrywise error of hold_dense_scan_kernels (and of
        # hold_factored_scan_kernels) is the one checked
        if f"{name}_rel" in errs:
            kernels[-1]["max_rel_err"] = errs[f"{name}_rel"]
    # the sparse tier's decode on the whole-scan Viterbi's headline table, a
    # yardstick for it (not a route of that table); the decode's whole
    # launch beside the walk's share; the CTC pair's wider routes, the dense
    # backtrace's long and odd-C cases
    row = {k["name"]: k for k in kernels}
    row["viterbi_scan_fwd"]["seg_max_scan_ms"] = times["viterbi_yardstick_seg_max_scan"]
    row["viterbi_backtrace"]["decode_ms"] = times["viterbi_decode"]
    row["ctc_grad"]["wide"] = times["ctc_grad_wide"]
    row["ctc_alpha"]["wide"] = times["ctc_alpha_wide"]
    # the launch floor (an empty kernel) beside the gathers; the CTC
    # forward as the gather and ctc_alpha, two launches; the gather
    # backward at its wide and ASG cases, the forward at ASG's
    for name in ("gather_fwd", "gather_bwd"):
        row[name]["launch_floor_ms"] = times["launch_probe"]
    row["gather_bwd"]["plan"] = times["gather_bwd_plan"]
    row["gather_bwd"]["more"] = times["gather_bwd_more"]
    row["gather_fwd"]["asg"] = times["gather_fwd_asg"]
    row["ctc_alpha"]["gather_then_alpha_ms"] = times["ctc_alpha_gather_then_alpha"]
    # the pair's chunk route (fwd+bwd of the score, both kernels and #4) at
    # the long shapes, with its launches a call and peak memory beside the
    # whole-T route's; its largest errors against the plain chunk route
    for name in ("ctc_alpha", "ctc_grad"):
        row[name]["chunked"] = chunk_rows
        row[name]["chunked_max_err"] = chunk_errs[name]
    row["dense_bt"]["more"] = times["dense_bt_more"]
    print(json.dumps({"timing": timing}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    try:
        if argv[:1] == ["--only"]:
            run(only=argv[1])
        else:
            run()
    except Exception:  # report which phase failed, exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
