#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. probe   — the card's name and power limit, torch / CUDA / nvcc /
             triton versions;
2. build   — compiles the hand-written kernels (``src/repro_torch/csrc``,
             one nvcc per source, in parallel) and reports the seconds;
3. kernels — runs ``rank_update`` (SYRK / SYR2K bodies, epilogue
             variants, every tile size), ``sym_stream`` (SYMM) and
             ``slstm_scan`` (the sLSTM recurrence) on the card at the
             serving paths' shapes and holds each against its plain
             PyTorch version on the same inputs, with the tolerance
             printed beside the error (and a 1xTF32 emulation that must
             miss it); times the kernel, the plain version and, where
             one exists, one PyTorch call computing the same function
             (``torch.matmul``; none for the sLSTM recurrence), and the
             embedding and Gram update also inside a CUDA graph (device
             time without the host).  ``slstm_scan`` runs f32 and bf16
             gates in the mixer's quad layout and in other views, its
             edges (S = 1, S below the ring's lookahead, S not a
             multiple of the step group, ragged d, n0 in (0, 1)) and a
             long single prefill, every case also in a CUDA graph,
             beside its byte bound and an issue bound read from the
             SASS of its step loop; the symmetric kernels also at
             jamba's d = 4096, granite's 6144 and deepseek-v3's 7168
             (Gram update, NS T², NS seed, NS product, embedding) and at
             the mesh trainer's ``--track-gram`` block, a (2048, 25088)
             SYRK;
4. serve   — serves stablelm-1.6b at full width (24 layers, d_model
             2048, vocab 100352; random weights from a seed) with the
             whitening cache on, and asserts that every request
             completes, every embedding is finite, a factor was
             refreshed and both symmetric kernels launched;
5. xlstm   — serves xlstm-350m at full width (24 layers, d_model 1024,
             vocab 50304, 6 sLSTM layers; random weights from a seed)
             the same way, and asserts that ``slstm_scan`` launched
             exactly 6 times per model forward the server ran, always
             on the mixer's bf16 quad views and never through its plain
             version, and both symmetric kernels launched; then times
             one prefill per block kind (host clock, a sync after every
             block);
6. check   — reduced stablelm and xlstm models on the card against the
             same weights on the CPU, and the full-width Newton–Schulz
             whitening on the kernels against the eigh oracle, then
             timed alone at d = 2048 and 1024;
7. train   — ``rank_update`` (SYRK, with and without the accumulate
             epilogue) and ``sym_stream`` at every shape the Muon step
             gives them against their plain versions, each matrix of a
             stack bit for bit against its own launch, timed against k
             launches, the plain version and ``torch.bmm``; autodiff through ``blas.syrk`` /
             ``syr2k`` / ``symm`` (every fill) on the kernels against the
             dense IEEE route; one Muon NS of a (24, 2048, 5632) momentum
             on the kernels against the plain versions, and one of each
             leaf shape of the model, timed (where the optimizer's time
             goes); then trains stablelm-1.6b at full width (24 layers,
             d_model 2048, d_ff 5632, vocab 100352; random bf16 init from
             seed 0; 8 x 256 tokens a step) for 4 Muon steps and 2 AdamW
             steps, printing the losses, the split of each step,
             tokens/s, peak memory, the kernels' launches a step and the
             captured routes, and asserting that every NS SYRK / SYMM
             with n1 >= 256 ran on the kernels, one launch per blas call;
8. mesh    — the paper's parallel schedules behind ``blas.syrk`` /
             ``syr2k`` / ``symm(mesh=...)`` at the stablelm-1.6b MLP leaf
             Muon grams (n1 = 2048, n2 = 5632), P ranks as processes of
             one gloo group all on this card, the wire host-staged: 1d
             and ring at P = 4, 2d at P = 6, 3d and 3d-limited (under an
             ``M=`` budget the planner turns into it) at P = 12, each
             route pinned with ``blas.pinned(Route(...))``; each case
             against a dense f32 ``torch.matmul`` oracle on rank 0
             (relative error <= 2e-5), with its schedule's words a rank
             by collective kind, the words that replicate its result
             apart, the planner's predicted words, the lower
             bound and ms (CUDA events on rank 0, mean over a >= 25 ms
             window of >= 3 calls); one single-device blas call of each
             op timed beside them; the planner's own pick at each P;
             then Muon's
             ``orthogonalize_1d`` of a (24, 2048, 5632) stack on P = 4
             (its column shards gathered for the check) against the
             single-device ``orthogonalize_reference`` on the card
             (2e-3).  The mesh path launches none of the three
             kernels; its launch counts are printed and must read 0.
             One launch of 12 ranks runs it all (``gloo_rank``): P = 12
             on every rank, 6 and 4 on its first ranks (the others wait
             at a barrier), and on its first 4 also phase 11's and 12's
             gloo cases, which those phases check;
9. ckpt    — checkpoints and resume: trains stablelm-1.6b at its
             published widths, 2 layers deep, with Muon and
             ``--track-gram`` in a temp dir (its free space printed
             first; the depth, never the widths, cut further only if
             three checkpoints would not fit), run A
             3 steps with ``--ckpt-every 2 --ckpt-keep 2`` (its step-3
             checkpoint set aside), run B ``--steps 3`` on the same dir,
             which resumes from step 2; asserts that B resumed with 0
             mismatches from ``verify_restored``, that B's loss is A's
             step 2 bit for bit, that every leaf of B's step-3
             checkpoint has A's crc apart from the packed Grams (bf16
             words, within 1e-2), and that both runs launched
             ``rank_update`` and ``sym_stream``; prints the bytes, the
             blocking save's, the async snapshot's, the restore's and
             ``verify_restored``'s seconds, and deletes the dir;
10. warm   — the serving cache's save and warm start: serves
             stablelm-1.6b at full width (the phase 4 traffic over 2
             tenants) with ``--save-cache``, then again from
             ``--warm-start``; asserts that both keys were restored, on
             the card, their bf16 EMA words bit-equal to the files, that
             the tokens of both serves are identical, and that the warm
             serve ran every refresh's Newton–Schulz chain on
             ``rank_update`` / ``sym_stream`` (never ``slstm_scan``);
             saves 3 keys of (2048, 64) features from a synchronous
             cache and warm-starts a fresh one, each warm factor
             bit-equal to the live one; serves once more under a
             persistent ``serve:refresh`` fault (tokens identical,
             failures counted, the breaker naming both keys) and saves
             that cache under 2 ``ckpt:fsync`` and 1 ``ckpt:rename``
             transient faults (committed, 0 mismatches); prints the
             bytes on disk, the save's, the warm start's and the warm
             refreshes' seconds, and both serves' tokens/s and TTFT;
11. faults — ABFT and restart: ``checked_syrk`` / ``checked_syr2k`` /
             ``checked_symm`` on the local route at the stablelm-1.6b
             MLP leaf's Muon Gram shape (2048, 5632; a packed S at 2048
             for SYMM), f32 from a seed: each must run on the kernel
             route and launch ``rank_update`` / ``sym_stream``, detect
             nothing when clean (the largest honest residual printed as
             a fraction of its threshold, < 1), detect a bitflip and a
             nan on band 0 and retry once to an output bit-equal to the
             clean one, raise ``AbftError`` under a persistent fault,
             and (SYRK / SYR2K) rebuild from the clean output at c = 2
             bit-equal; the unchecked call, the check alone and the
             checked call timed with CUDA events.  Then
             ``checked_syrk`` on the 1d route on 4 gloo ranks sharing
             the card, a bitflip on rank 3's band: detected with
             primary 3, bit-equal on every rank, a retry's words twice
             the schedule's.  Then the uninterrupted single-device run at
             stablelm-1.6b's published widths and 2 layers (``muon-syrk``,
             ``--track-gram``, phase 7's traffic, 2 steps; its Grams read
             from its last checkpoint), and ``run_recovery`` of the same
             run in a temp dir (its free space printed first): phase 1
             killed by ``train:step`` before step 1 after step 1's
             checkpoint committed, phase 2 resumed from step 1 with 0
             mismatches, completed, every loss of both phases the
             uninterrupted run's bit for bit, both phases launching the
             symmetric kernels; prints each phase's, the restore's and
             the verify's seconds.  That ``run_recovery`` waits on its
             trainer subprocesses on a thread, beside phase 14's;
12. compress — int8 gradient compression with error feedback: (a)
             trains stablelm-1.6b at full width with Muon and
             ``--compress-grads`` 4 steps on phase 7's traffic, asserting
             the kernel routes and launches as phase 7 does and step 0's
             loss phase 7's bit for bit (init, batch and loss precede any
             update), printing steps 1-3 beside phase 7's, ``compress_s``
             a step and peak memory; (b) quantizes and dequantizes the
             (24, 2048, 5632) MLP stack, f32 from a seed, on the card and
             on the host, bit-equal, timed with CUDA events beside its
             byte bound (and one ``ErrorFeedbackInt8.compress`` of it);
             (c) a resume with the EF state at the published widths, 2
             layers deep (run A 4 steps saving at 2, run B from 2): B's
             losses A's bit for bit, 0 mismatches, every leaf's crc
             equal, the manifest's ``ef`` leaves, the bytes and seconds;
             (d) ``compressed_allreduce`` of a (2048, 5632) matrix and
             ``compressed_allreduce_sym`` of a symmetric 2048² one, each
             rank its own (seed = rank), on 4 gloo ranks sharing the
             card: rank 0's result bit-equal to a numpy oracle and within
             the reference test's atol of the exact mean, the same on
             every rank, the bytes a rank the byte model's exactly
             (17,571,840 and 3,196,440, against 69,206,016 for the f32
             ``all_reduce``), ms on rank 0, no kernel launch (run in
             phase 8's launch);
13. meshtrain — ``train --devices 4`` (gloo ranks sharing the card,
             the wire host-staged) with ``muon-syrk`` on phase 7's
             traffic, 2 steps, stablelm-1.6b at its published widths
             cut to 2 layers, on (data 2, model 2) at ``--max-model 2``
             (tensor- and data-parallel), its losses within 1e-4 of
             phase 11's uninterrupted single-device run at that depth a
             step (step 0: init, batch and loss before any update); the
             (data 1, model 4) run is phase 14's phase 1.  It asserts
             that
             every rank's losses are identical, that every rank's
             optimizer words a step are the closed form of its leaves
             (the 1D schedule, or a gather where ``_use_1d`` declines),
             and that every rank launched ``rank_update`` /
             ``sym_stream`` 5 / 10 times a step for each gathered stack
             (its NS chain); prints the
             Muon path of each leaf, s per step and its split (loss +
             backward, reduce, clip, optimizer), words and bytes a rank
             by phase and kind, and each rank's peak memory.  The
             kernels line's ``train mesh`` launches are the mesh ranks'
             alone.  One launch of 4 ranks runs this, phase 16's and
             phase 21's mesh training (``mesh_trains``), the trainer's
             own summary made of each run's ranks;
14. elastic — ``run_recovery`` with ``--devices 4 --devices-after 2
             --max-model 4`` of ``muon-syrk`` with ``--track-gram`` at
             stablelm-1.6b's published widths and 2 layers, phase 7's
             traffic, gloo ranks sharing the card: phase 1 on (data 1,
             model 4) killed before step 1 after its step-1 checkpoint
             (every leaf gathered to rank 0, which writes) committed,
             phase 2 on (data 1, model 2) from that checkpoint (each
             rank its block, each Gram its slice), 0 mismatches,
             completed; every rank's losses identical, every loss within
             1e-4 of phase 11's
             single-device run's, the Grams of phase 2's last
             checkpoint within 1e-2 (bf16 words) of its; every rank's
             optimizer words a step the NS closed form plus the Grams'
             reduce-scatter (embed and unembed, (1 - 1/P)·Lp each);
             ``rank_update`` (the Grams and the gathered stacks' NS) and
             ``sym_stream`` launched on every rank of both phases, in
             the counts the paths give; prints each phase's seconds, the
             restore's, the verify's, the words of each phase (the
             checkpoint's gathers apart) and the checkpoint's bytes.
             Phase 11 (c)'s run goes on beside it: the two share the
             card and the host's cores, so each one's seconds are its
             own wall time with the other running;
15. xlstmtrain — trains xlstm-350m: first the sLSTM kernels of
             training at the train path's (8, 256, 1024) bf16 quads, at
             f32 gates, with ties f == i at t = 0 (and final-state
             gradients, without which no gradient reaches the
             stabiliser), with n_t = 1, at a ragged shape: the stash
             variant of ``slstm_scan`` bit for bit today's launch in y
             and the final state, its stash within the state tolerance
             of the plain version's, and ``slstm_scan_bwd`` within
             ``SLSTM_GRAD_TOL`` of autograd of the plain version (and
             missing it against a stabiliser that gives a tie wholly to
             f + m), the first two cases timed beside their byte bounds;
             then xlstm-350m at its published widths (24 layers, d_model
             1024, 4 heads, vocab 50304; random bf16 init from seed 0;
             phase 7's traffic) 4 ``muon-syrk`` and 2 AdamW steps:
             finite losses, step 0's loss the same under both, every
             sLSTM forward on the stash kernel and backward on
             ``slstm_scan_bwd`` (12 and 6 launches a step: the
             per-period remat runs the forward twice), no plain scan
             on the card, Muon's NS SYRK / SYMM with n1 >= 256 on
             ``rank_update`` / ``sym_stream``;
16. xlstmmesh — ``train --devices 4 --max-model 4 --optimizer
             muon-syrk`` of xlstm-350m at its published widths cut to 8
             layers (6 mLSTM, 2 sLSTM), phase 7's traffic, 2 steps, on
             (data 1, model 4): one head and 256 sLSTM channels a rank,
             each rank's ``slstm_scan`` (stash) and ``slstm_scan_bwd``
             on its own (8, 256, 256) quads; every rank's losses
             identical and within 1e-4 of the uninterrupted
             single-device run at that depth (run first); the plain
             scans raise on a CUDA tensor in every process; every
             rank's Muon words a step the closed form (embed, unembed
             and ``wx`` on the 1D schedule, the other stacks gathered)
             and its launches a step the paths' count (``slstm_scan`` 4,
             ``slstm_scan_bwd`` 2, ``rank_update`` 5 and ``sym_stream``
             10 a gathered stack of n1 >= 256); prints each rank's step
             time, peak memory, and words and bytes by phase and kind
             (its ranks ran in phase 13's launch);
17. jamba — serves jamba-v0.1-52b at full width (d_model 4096, 16
             experts top-2, vocab 65536; random bf16 weights from seed
             0) cut to one period of its pattern, 8 of its 32 layers (7
             Mamba, 1 attention; 4 dense and 4 MoE MLPs: all 32 do not
             fit 80 GB), phase 4's traffic with the whitening cache at d
             4096: every request completed, every embedding finite,
             ``rank_update`` / ``sym_stream`` launched exactly their
             closed forms in admits and refreshes (warm-up 6 / 4, one
             Gram update an admit, one embedding a factor hit, 30 / 61 a
             refresh), no sLSTM kernel, peak memory under the card's;
             host seconds by block kind per prefill bucket and a decode
             step; the NS factor (30 steps) and an embedding at d 4096
             on the kernels against their plain versions on the same
             card inputs and against the same iteration in f64; one full-width Mamba layer (prefill 64:
             sequential, 128: chunked, then a decode step) and one MoE
             layer (T = 64) against the same module on the CPU, within
             5e-2 of the CPU's scale;
18. dense — serves gemma3-12b (all 48 layers, d_model 3840, vocab
             262144), gemma2-9b (d_model 3584, vocab 256000),
             granite-20b (6144, 49152) and pixtral-12b (5120, 131072,
             text tokens as the reference's server) at their published
             widths, the last three 8 layers deep (``DENSE_LAYERS``),
             random bf16 weights from seed 0, phase 4's traffic with the
             whitening cache at each d_model,
             each model freed before the next is drawn: every request
             completed, every embedding finite, the symmetric kernels'
             launches phase 17's closed forms, no sLSTM kernel, peak
             memory under the card's; musicgen-large at full width on
             frames (a prefill of 4 x 128, 16 decode steps) through
             ``Model``; one full-width block of each kind against the
             CPU within 5e-2 (a gemma3 local layer at a 1040-token
             prefill, past its 1024 window, and a decode step; a gemma2
             global layer with its softcap; a granite MQA + LayerNorm +
             ``gelu_mlp`` layer; a musicgen layer on frames); the
             streamed SDPA against the dense one on the card; the NS
             factor and an embedding at each served d_model (3584, 3840,
             5120, 6144) as phase 17 checks them at 4096.  Phase 3
             times the symmetric kernels at granite's d = 6144;
19. deepseek — serves deepseek-v3-671b (d_model 7168, MLA with q_lora
             1536 and kv_lora 512, 256 experts top-8 and 1 shared, vocab
             129280) cut to its 3 dense prefix layers and one MoE layer
             with the MTP block's weights (4 of 61 layers), and
             deepseek-v2-236b (5120, 160 experts top-6 and 2 shared,
             vocab 102400) cut to its dense layer and one MoE layer,
             random bf16 weights from seed 0, phase 4's traffic with the
             whitening cache at each d_model, each freed before the next
             is drawn: every request completed, every embedding finite,
             the symmetric kernels' launches phase 17's closed forms, no
             NS fallback, peak memory under the card's, the published
             widths; host seconds by block kind; the NS factor and an
             embedding at d 7168 against the plain kernels and the f64
             iteration; one full-width v3 MLA layer (a prefill of 64
             into the latent cache, a decode step) against the CPU
             within 5e-2.  Phase 3 times the symmetric kernels at
             d = 7168;
20. shapes — the shape cells (``configs/shapes.py``) run for real at
             full width through the port's own steps, the batch cut by
             ``input_specs``' scale: stablelm-1.6b prefill_32k (one
             sequence of 32767 tokens into an s_max 32768 cache: the
             streamed SDPA at length), decode_32k (that cache copied
             into 4 rows, one step at position 32767, the mean of 3) and
             train_4k (the trainer, 1 x 4096 tokens, 2 AdamW steps);
             xlstm-350m prefill_32k (32768 tokens: the chunkwise mLSTM,
             ``slstm_scan`` on (1, 32768, 1024) bf16 quads, 6 launches,
             no plain scan) and long_500k (decode steps from that
             prefill's state).  Each row prints its measured seconds
             (host clock around synced work), peak memory, its step's
             op count on the meta device (``analysis/op_cost.py``: flops
             by dtype, eager bytes; counted by two child processes
             started after phase 1, while the card runs the other
             phases) and the H100 roofline's terms, and asserts that the
             measured fraction, bound / measured, is at most 1.  Also:
             the streamed SDPA against the dense one on layer 0's real q
             / k / v at 32768 keys (``SDPA_TOL``), and that sLSTM
             layer's gates through ``slstm_scan`` against its plain
             version on the card, both timed;
21. densetrain — trains the dense families at their published widths:
             one Muon NS (5 steps, beside phase 8) at each Gram width
             they add (3584, 3840, 5120, 6144 at the embeddings' vocab
             and the MLP's d_ff, 4096 at pixtral's attention) on the
             kernels
             against the same iteration in f64 (``NS_TOL``; the first
             Gram ``TOL_F32``), and ``rank_update`` / ``sym_stream`` at
             the gemma3 and pixtral embeddings' and granite's MLP stack's
             NS shapes against their plain versions, timed beside one
             PyTorch call and the bound; then gemma2-9b (2 layers: one
             local / global pair), gemma3-12b (6: one 5 + 1 period),
             granite-20b (2) and pixtral-12b (4) through ``train`` and
             musicgen-large (all 48) on frames through ``make_train_step``,
             random bf16 weights from seed 0, 2 x 256 tokens, a warm-up
             and 2 timed steps, ``muon-syrk`` on gemma3 and granite and
             AdamW on the others: finite losses, the launches the closed
             form of the leaf shapes (5 ``rank_update`` and 10
             ``sym_stream`` a matrix leaf of short side >= 256 a step),
             every NS SYRK / SYMM with n1 >= 256 on the kernels, s a
             step and its split, tokens/s, peak memory under the
             card's; gemma2's first loss against the same weights on the
             CPU (``MUON_TOL`` + ``MUON_TOL``·|cpu|); and gemma2-9b at 2
             layers on (data 2, model 2) with ``fsdp_params``, AdamW, 2
             steps, run in phase 13's launch: every rank's losses
             identical, step 0 within 1e-4 of the one-card run's, each
             rank's all-gather and reduce-scatter words a step in the
             loss + backward the closed form of its blocks;
22. jambatrain — trains jamba-v0.1-52b at its published widths: one
             Muon NS (5 steps, beside phase 8) of a (16, 4096, 14336)
             expert stack on the kernels against the f64 iteration
             (``NS_TOL``; the
             first Gram ``TOL_F32``), and ``rank_update`` /
             ``sym_stream`` at the expert stacks' NS shapes (the Gram,
             sym(Y)·X and S·S of (16, 4096, 14336)) against the products
             in f64, timed beside their plain versions, ``torch.bmm``
             and the bound; one MoE layer (16 experts, top-2, 512
             tokens, a window overflowing) whose input, router and
             expert gradients through ``moe.CapacityExperts`` must be
             autograd's of the plain capacity form within 4 bf16 ulps
             (outputs bit-equal; beside phase 8); then layers 2-3 of its
             period (Mamba +
             dense MLP, attention + MoE MLP; 3.68e9 parameters) through
             the trainer's ``_run`` with ``muon-syrk``, random bf16
             weights from seed 0, 2 x 256 tokens (the capacity form), a
             warm-up and 1 timed step: finite losses, the launches the
             closed form, every NS SYRK / SYMM with n1 >= 256 on the
             kernels, s a step and its split, tokens/s, peak memory
             under 79.18 GiB; the peak of one loss + backward under the
             "names" and the "full" remat policy, gradients bit-equal;
             the first loss against the same weights on the CPU
             (``MUON_TOL`` + ``MUON_TOL``·|cpu|); and the same layers
             on (data 1, model 2), 2 gloo ranks sharing the card, AdamW,
             a warm-up and 1 timed step (run beside phase 2, the build,
             while the card is empty: "train mesh" on the ``[done]``
             line): every rank's losses identical, step 0 within 1e-4 of
             the one-card run's, each rank's loss + backward words the
             tensor-parallel closed form, no symmetric-kernel launch, s
             a step and its split, tokens/s, each rank's peak and the
             seconds from the release; the closed forms of Muon's routes
             and ZeRO-3 at this width printed beside;
23. deepseektrain — trains deepseek-v3-671b at its published widths:
             its first 2 of 3 dense prefix blocks (MLA with q_lora), no
             MoE layer and the MTP block (3.60e9 parameters, no periods)
             through the trainer's ``_run`` with ``muon-syrk``, random
             bf16 weights from seed 0, 2 x 256 tokens, a warm-up and 2
             timed steps: finite losses, the launches the closed form,
             every NS SYRK / SYMM with n1 >= 256 on the kernels, s a step
             and its split, tokens/s, peak memory; then, while the first
             loss is recomputed from the same weights on the CPU on a
             thread (``MUON_TOL`` + ``MUON_TOL``·|cpu|), ``rank_update``
             / ``sym_stream`` at every NS shape the cut adds against the
             products in f64, timed, and one deepseek-v2 MoE layer at
             full width (160 experts, 2 shared, top-6, d 5120; 512
             tokens, a window overflowing) whose input, router, expert
             and shared-expert gradients
             through ``moe.CapacityExperts`` must be autograd's of the
             plain capacity form within 4 bf16 ulps; one Muon NS of the
             (7168, 129280) embedding and of a (7168, 18432) MLP leaf on
             the kernels against the f64 iteration (``NS_TOL``), beside
             phase 8; and the same cut on (data 1, model 2) by phase
             22's ranks after jamba's part, beside the build, held as
             phase 22's (its words MLA's latent all-gathers and
             reduce-scatters beside the all-reduces,
             ``deepseek_tp_closed_form``).

The seconds of each phase are printed on the ``[done]`` line.  The
checks of phases 21-23 that time nothing on the card (the Muon NS
against the f64 iteration at their new widths, phase 22's MoE
gradients) run on a thread beside phase 8's gloo launch, whose ranks
hold little of the card ("early checks"); the CPU's first loss of
phases 21-23 runs on a thread beside that phase's kernel rows.  Phases
11 (c) and 14 wait on trainer subprocesses of their own; they run on
threads, side by side, after phase 13, while the main thread runs phase
9 and phase 12 (c) (``compress_resume``): those four share the card,
the host's cores and the disk, so each one's seconds are its wall time
beside the others, and they sum to more than the window they fill.
The line before the last is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense TF32
#: tensor-core FLOP/s, and FP32 FLOP/s outside the tensor cores.  The
#: symmetric kernels reach f32 accuracy with three TF32 products per
#: product (3xTF32), so their least time is max(bytes / HBM rate,
#: 3 · flops / TF32 rate); ``ffma_bound_ms`` keeps the FFMA-only bound
#: (flops / FP32 rate) of the earlier rows beside it.
PEAK_BYTES_S = 3.35e12
PEAK_TF32_FLOP_S = 495e12
PEAK_FP32_FLOP_S = 67e12
DEVICE = "cuda"
TOL_F32 = 2e-5      # max |kernel − plain| / max(1, max |plain|), f32 out
TOL_BF16 = 1e-2     # the same for a bf16 output (2^-8 relative rounding)

#: the sLSTM kernel's tolerances are the reference kernel test's
#: (tests/test_slstm_kernel.py): |got − want| ≤ tol·(1 + |want|)
SLSTM_Y_TOL = 2e-5
SLSTM_STATE_TOL = 2e-4
#: f32 operations per (b, t, channel) step of the sLSTM recurrence: adds,
#: subtractions, maxima, multiplies and divisions (an FMA counts 2), and
#: the three exp and one tanh counted once each
SLSTM_OPS_PER_STEP = 20

REPLACES = {
    "rank_update": "src/repro/kernels/trigrid.py:151",
    "sym_stream": "src/repro/kernels/trigrid.py:224",
    "slstm_scan": "src/repro/kernels/slstm.py:59",
    # no pallas_call: the reference differentiates its jnp mixer here
    "slstm_scan_bwd": "src/repro/models/ssm.py:437",
}
SOURCES = {
    "rank_update": "src/repro_torch/csrc/rank_update.cu",
    "sym_stream": "src/repro_torch/csrc/sym_stream.cu",
    "slstm_scan": "src/repro_torch/csrc/slstm_scan.cu",
    "slstm_scan_bwd": "src/repro_torch/csrc/slstm_scan.cu",
}


def log(*a):
    print(*a, flush=True)


def smi(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


# --------------------------------------------------------------------------
# phase 1: probe
# --------------------------------------------------------------------------
def probe(torch):
    """The card's name and power limit, and its highest SM clock in MHz
    (the issue rate of the sLSTM kernel's bound)."""
    card = smi()
    clock = float(smi("clocks.max.sm").split()[0])
    log(f"[probe] gpu: {card}, max SM clock {clock:.0f} MHz")
    log(f"[probe] python {sys.version.split()[0]}  torch {torch.__version__}"
        f"  cuda {torch.version.cuda}  device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from repro_torch.kernels import native
    nv = subprocess.run([native.nvcc_path(), "--version"],
                        capture_output=True, text=True).stdout.strip()
    log(f"[probe] nvcc: {nv.splitlines()[-1] if nv else 'missing'}")
    try:
        import triton
        log(f"[probe] triton {triton.__version__}")
    except ImportError:
        log("[probe] triton not importable")
    return card, clock


# --------------------------------------------------------------------------
# phase 2: build
# --------------------------------------------------------------------------
def build() -> float:
    from repro_torch.kernels import native
    from repro_torch.models.model import preload_remat
    t0 = time.perf_counter()
    preload = preload_remat()       # while nvcc runs, not in phase 7
    native.load()
    secs = time.perf_counter() - t0
    preload.join()
    log(f"[build] {len(native.SOURCES)} sources, built "
        f"{native.BUILD_INFO['built']} in {secs:.2f} s into "
        f"{native.build_dir()}")
    for ln in str(native.BUILD_INFO["ptxas"]).splitlines():
        if "registers" in ln or "spill" in ln and " 0 bytes" not in ln:
            log("[build]   " + ln.strip())
    return secs


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------
def cuda_ms(torch, fn, window_ms: float = 25.0, warmup: int = 3) -> float:
    """Mean device ms per call over a window of at least ``window_ms``
    (at least 10 calls), so that a short kernel is timed over enough
    launches for the clocks to settle.  A call that fills the window
    alone (a plain version's Python loop over S) is timed over 2 calls
    after one warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed(reps):
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    fn()                                  # first call: lazy set-up
    if timed(1) >= window_ms:
        return timed(2)
    est = timed(warmup)
    return timed(max(10, int(window_ms / max(est, 1e-3)) + 1))


def graph_ms(torch, fn, reps: int = 50) -> float:
    """Device ms per call with the host out of the way: ``reps`` calls
    captured in one CUDA graph, replayed and timed with events.  For a
    call whose back-to-back rate (``cuda_ms``) is set by its host cost."""
    fn()                                  # lazy set-up outside the graph
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(torch, graph.replay) / reps


def bound_ms(nbytes: float, flops: float, tensor: bool = True):
    """(least ms, what bounds it) for moving ``nbytes`` through HBM and
    doing ``flops`` f32-accurate operations: on the tensor cores in
    3xTF32 (``tensor``), else in FP32 FFMA."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = (3 * flops / PEAK_TF32_FLOP_S if tensor else
             flops / PEAK_FP32_FLOP_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def compare(torch, name, got, want, out_dtype, nans=False):
    """got within the tolerance of want, and finite; with ``nans``, NaN
    exactly where want has NaN (somewhere) and within it elsewhere."""
    got, want = got.float(), want.float()
    where_nan = torch.isnan(want)
    nan_ok = bool(torch.equal(torch.isnan(got), where_nan))
    if nans:
        nan_ok = nan_ok and bool(where_nan.any())
        got, want = got[~where_nan], want[~where_nan]
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    tol = TOL_BF16 if out_dtype == torch.bfloat16 else TOL_F32
    ok = err / scale <= tol and bool(torch.isfinite(got).all()) and nan_ok
    log(f"[kernels] {name:44s} max_abs_err {err:.3e} (rel {err / scale:.2e}"
        f" <= {tol:.0e}){' NaN where plain has' if nans else ''} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"kernel {name} disagrees with its plain version")
    return err


def kernel_phase(torch, card_clock_mhz):
    from repro_torch.core.packing import TriTiles, pack_tril_tiles
    from repro_torch.kernels import trigrid

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    f32, bf16 = torch.float32, torch.bfloat16
    cases = {"rank_update": [], "sym_stream": [], "slstm_scan": [],
             "slstm_scan_bwd": []}

    def timing(row, kernel, plain, library, nbytes, flops, tensor=True):
        row["ms"] = cuda_ms(torch, kernel)
        row["plain_ms"] = cuda_ms(torch, plain)
        row["library_ms"] = cuda_ms(torch, library)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, tensor)
        log(f"[kernels]   ms {row['ms']:.4f}  plain {row['plain_ms']:.4f}"
            f"  library {row['library_ms']:.4f}  bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']}; FFMA "
            f"{row['ffma_bound_ms']:.4f})")

    def rank_case(label, body, a, b=None, bm=128, ep=None, c0=None,
                  timed=False, main=False):
        ep = ep or trigrid.Epilogue()
        got = trigrid.rank_update(body, a, b, bm=bm, epilogue=ep, c0=c0)
        want = trigrid._rank_update_plain(body, a, b, bm, ep, c0)
        err = compare(torch, f"rank_update {label}", got, want,
                      ep.out_dtype)
        n1, n2 = a.shape
        m = 1 if body == "syrk" else 2
        T = (n1 // bm) * (n1 // bm + 1) // 2
        out_b = T * bm * bm * (2 if ep.out_dtype == bf16 else 4)
        nbytes = m * n1 * n2 * 4 + out_b + (out_b if c0 is not None else 0)
        flops = m * n1 * (n1 + 1) * n2        # useful half, 2 flops / FMA
        row = {"case": label, "max_abs_err": err, "main": main,
               "bound_ms": bound_ms(nbytes, flops)[0],
               "ffma_bound_ms": bound_ms(nbytes, flops, False)[0]}
        if timed:
            lib = (lambda: a @ a.T) if body == "syrk" else \
                (lambda: torch.addmm(a @ b.T, b, a.T))
            timing(row, lambda: trigrid.rank_update(
                body, a, b, bm=bm, epilogue=ep, c0=c0),
                lambda: trigrid._rank_update_plain(body, a, b, bm, ep, c0),
                lib, nbytes, flops)
        cases["rank_update"].append(row)

    def symm_case(label, tiles, b, bm, ds=1.0, out_dtype=f32, dense=None,
                  timed=False, main=False):
        got = trigrid.sym_stream(tiles, b, bm=bm, out_dtype=out_dtype,
                                 diag_scale=ds)
        nt = b.shape[0] // bm
        want = trigrid._sym_stream_plain(tiles, b, nt, ds, out_dtype)
        err = compare(torch, f"sym_stream {label}", got, want, out_dtype)
        n1, n2 = b.shape
        nbytes = tiles.numel() * 4 + n1 * n2 * 4 + n1 * n2 * (
            2 if out_dtype == bf16 else 4)
        flops = 2 * n1 * n1 * n2
        # n2 <= 8 runs the FFMA matrix-vector kernel, wider B 3xTF32
        tensor = n2 > trigrid.NARROW_MAX_N2
        row = {"case": label, "max_abs_err": err, "main": main,
               "bound_ms": bound_ms(nbytes, flops, tensor)[0],
               "ffma_bound_ms": bound_ms(nbytes, flops, False)[0]}
        if timed:
            timing(row, lambda: trigrid.sym_stream(
                tiles, b, bm=bm, out_dtype=out_dtype, diag_scale=ds),
                lambda: trigrid._sym_stream_plain(tiles, b, nt, ds,
                                                  out_dtype),
                lambda: dense @ b, nbytes, flops, tensor)
        cases["sym_stream"].append(row)
        return got

    d = 2048
    # Gram updates: feats (2048, bucket) for every prefill bucket
    for bucket in (16, 32, 64, 128, 256):
        rank_case(f"syrk packed 2048x{bucket}", "syrk", randn(d, bucket),
                  timed=bucket == 64)
    gram = cases["rank_update"][2]
    a_g = randn(d, 64)
    gram["device_ms"] = graph_ms(torch, lambda: trigrid.rank_update(
        "syrk", a_g, bm=128))
    gram["library_device_ms"] = graph_ms(torch, lambda: a_g @ a_g.T)
    log(f"[kernels]   in a CUDA graph (device time, no host): ms "
        f"{gram['device_ms']:.4f}  library {gram['library_device_ms']:.4f}")
    # Newton–Schulz T² (fill="full") and the SYR2K body
    t = randn(d, d) / d ** 0.5
    rank_case("syrk full 2048x2048 (NS T^2)", "syrk", t, timed=True,
              main=True)
    rank_case("syr2k 2048x2048", "syr2k", t, randn(d, d) / d ** 0.5,
              timed=True)
    # xlstm's refresh at d = 1024: 64-blocks
    t1 = randn(1024, 1024) / 1024 ** 0.5
    rank_case("syrk full 1024x1024 (xlstm NS T^2)", "syrk", t1, timed=True)
    rank_case("syrk packed 1024x64 (xlstm Gram)", "syrk", randn(1024, 64),
              timed=True)
    # jamba's refresh and Gram update at d = 4096 (32 tiles of 128)
    t4 = randn(4096, 4096) / 4096 ** 0.5
    rank_case("syrk packed 4096x64 (jamba Gram)", "syrk", randn(4096, 64),
              timed=True)
    rank_case("syrk full 4096x4096 (jamba NS T^2)", "syrk", t4, timed=True)
    # the mesh trainer's --track-gram: a rank's local SYRK of its block
    rank_case("syrk packed 2048x25088 (mesh --track-gram block)", "syrk",
              randn(2048, 25088), timed=True)
    # epilogue variants: alpha, beta·C0, diag_scale, bf16 out, every bm
    a64, b64 = randn(d, 64), randn(d, 64)
    c0 = randn(136, 128, 128)
    rank_case("syrk alpha 0.5 beta 2 c0", "syrk", a64, ep=trigrid.Epilogue(
        alpha=0.5, beta=2.0, accumulate=True), c0=c0)
    rank_case("syr2k diag_scale 0.5", "syr2k", a64, b64,
              ep=trigrid.Epilogue(diag_scale=0.5))
    rank_case("syr2k diag_scale 2 bf16 out", "syr2k", a64, b64,
              ep=trigrid.Epilogue(diag_scale=2.0, out_dtype=bf16))
    rank_case("syrk bf16 out beta c0", "syrk", a64, ep=trigrid.Epilogue(
        beta=1.0, accumulate=True, out_dtype=bf16), c0=c0)
    c0_nan = randn(36, 128, 128)
    up = torch.triu(torch.ones(128, 128, device=dev, dtype=torch.bool), 1)
    diag_t = torch.arange(8, device=dev) * (torch.arange(8, device=dev) + 3)
    c0_nan[diag_t // 2] = torch.where(up, float("nan"), c0_nan[diag_t // 2])
    rank_case("syrk 1024x64 beta c0, NaN in C0's upper halves", "syrk",
              randn(1024, 64), ep=trigrid.Epilogue(
                  beta=0.5, accumulate=True), c0=c0_nan)
    for bm in (8, 16, 32, 64):
        n = 16 * bm
        rank_case(f"syrk {n}x40 bm {bm} ragged k", "syrk", randn(n, 40),
                  bm=bm)
        rank_case(f"syr2k {n}x24 bm {bm}", "syr2k", randn(n, 24),
                  randn(n, 24), bm=bm)
    rank_case("syrk 160x37 bm 32 (4 B copies, ragged blocks)", "syrk",
              randn(160, 37), bm=32)
    rank_case("syr2k 1024x37 bm 128 (4 B copies)", "syr2k",
              randn(1024, 37), randn(1024, 37))

    # SYMM: NS seed (Gram TriTiles bm 32 times I), NS products (bm 128),
    # the embedding (n2 = 1, unpadded as the serve calls it, and padded to
    # 128), poison
    g = randn(d, d)
    g = (g + g.T) / 2
    gt = TriTiles.from_tril(g, 32).tiles.contiguous()
    eye = torch.eye(d, device=dev)
    symm_case("TriTiles bm 32 x I (NS seed)", gt, eye, 32, dense=g,
              timed=True)
    x = randn(d, d) / d ** 0.5
    xt = pack_tril_tiles(x, 128).contiguous()
    xs = torch.tril(x) + torch.tril(x, -1).T
    y = randn(d, d)
    got_ns = symm_case("dense 2048^2 x 2048^2 (NS)", xt, y, 128, dense=xs,
                       timed=True, main=True)
    tf32_case(torch, got_ns, xs, y)
    p = torch.zeros(d, 128, device=dev)
    p[:, 0] = randn(d)
    symm_case("2048^2 x (2048, 1) padded to 128", xt, p, 128, dense=xs,
              timed=True)
    p1 = p[:, :1].contiguous()
    symm_case("2048^2 x (2048, 1) unpadded (embedding)", xt, p1, 128,
              dense=xs, timed=True)
    emb = cases["sym_stream"][-1]
    emb["device_ms"] = graph_ms(torch, lambda: trigrid.sym_stream(
        xt, p1, bm=128))
    emb["library_device_ms"] = graph_ms(torch, lambda: xs @ p1)
    log(f"[kernels]   in a CUDA graph (device time, no host): ms "
        f"{emb['device_ms']:.4f}  library {emb['library_device_ms']:.4f}")
    symm_case("diag_scale 2 bf16 out", xt, randn(d, 96), 128, ds=2.0,
              out_dtype=bf16)
    for bm in (8, 16, 64):
        n = 16 * bm
        a = randn(n, n)
        symm_case(f"{n}^2 x {n}x72 bm {bm}", pack_tril_tiles(
            a, bm).contiguous(), randn(n, 72), bm,
            ds=2.0 if bm == 8 else 1.0)
    # xlstm's refresh at d = 1024
    g1 = randn(1024, 1024)
    g1 = (g1 + g1.T) / 2
    symm_case("1024 TriTiles bm 32 x I (xlstm NS seed)", TriTiles.from_tril(
        g1, 32).tiles.contiguous(), torch.eye(1024, device=dev), 32,
        dense=g1, timed=True)
    x1s = torch.tril(t1) + torch.tril(t1, -1).T
    symm_case("dense 1024^2 x 1024^2 (xlstm NS)", pack_tril_tiles(
        t1, 128).contiguous(), randn(1024, 1024), 128, dense=x1s,
        timed=True)
    # jamba's refresh and embedding at d = 4096
    g4 = randn(4096, 4096)
    g4 = (g4 + g4.T) / 2
    symm_case("4096 TriTiles bm 32 x I (jamba NS seed)", TriTiles.from_tril(
        g4, 32).tiles.contiguous(), torch.eye(4096, device=dev), 32,
        dense=g4, timed=True)
    del g4
    x4t = pack_tril_tiles(t4, 128).contiguous()
    x4s = torch.tril(t4) + torch.tril(t4, -1).T
    symm_case("dense 4096^2 x 4096^2 (jamba NS)", x4t, randn(4096, 4096),
              128, dense=x4s, timed=True)
    p4 = randn(4096, 1)
    symm_case("4096^2 x (4096, 1) unpadded (jamba embedding)", x4t, p4, 128,
              dense=x4s, timed=True)
    emb4 = cases["sym_stream"][-1]
    emb4["device_ms"] = graph_ms(torch, lambda: trigrid.sym_stream(
        x4t, p4, bm=128))
    emb4["library_device_ms"] = graph_ms(torch, lambda: x4s @ p4)
    log(f"[kernels]   in a CUDA graph (device time, no host): ms "
        f"{emb4['device_ms']:.4f}  library {emb4['library_device_ms']:.4f}")
    del t4, x4t, x4s
    # granite's refresh, Gram update and embedding at d = 6144 (48 tiles
    # of 128, 1176 packed; the NS seed's 192 x 192 bm-32 tiles)
    t6 = randn(6144, 6144) / 6144 ** 0.5
    rank_case("syrk packed 6144x64 (granite Gram)", "syrk", randn(6144, 64),
              timed=True)
    rank_case("syrk full 6144x6144 (granite NS T^2)", "syrk", t6,
              timed=True)
    g6 = randn(6144, 6144)
    g6 = (g6 + g6.T) / 2
    symm_case("6144 TriTiles bm 32 x I (granite NS seed)",
              TriTiles.from_tril(g6, 32).tiles.contiguous(),
              torch.eye(6144, device=dev), 32, dense=g6, timed=True)
    del g6
    x6t = pack_tril_tiles(t6, 128).contiguous()
    x6s = torch.tril(t6) + torch.tril(t6, -1).T
    symm_case("dense 6144^2 x 6144^2 (granite NS)", x6t, randn(6144, 6144),
              128, dense=x6s, timed=True)
    p6 = randn(6144, 1)
    symm_case("6144^2 x (6144, 1) unpadded (granite embedding)", x6t, p6,
              128, dense=x6s, timed=True)
    emb6 = cases["sym_stream"][-1]
    emb6["device_ms"] = graph_ms(torch, lambda: trigrid.sym_stream(
        x6t, p6, bm=128))
    emb6["library_device_ms"] = graph_ms(torch, lambda: x6s @ p6)
    log(f"[kernels]   in a CUDA graph (device time, no host): ms "
        f"{emb6['device_ms']:.4f}  library {emb6['library_device_ms']:.4f}")
    del t6, x6t, x6s
    # deepseek-v3's refresh, Gram update and embedding at d = 7168 (56
    # tiles of 128, 1596 packed; the NS seed's 224 x 224 bm-32 tiles)
    t7 = randn(7168, 7168) / 7168 ** 0.5
    rank_case("syrk packed 7168x64 (deepseek-v3 Gram)", "syrk",
              randn(7168, 64), timed=True)
    rank_case("syrk full 7168x7168 (deepseek-v3 NS T^2)", "syrk", t7,
              timed=True)
    g7 = randn(7168, 7168)
    g7 = (g7 + g7.T) / 2
    symm_case("7168 TriTiles bm 32 x I (deepseek-v3 NS seed)",
              TriTiles.from_tril(g7, 32).tiles.contiguous(),
              torch.eye(7168, device=dev), 32, dense=g7, timed=True)
    del g7
    x7t = pack_tril_tiles(t7, 128).contiguous()
    x7s = torch.tril(t7) + torch.tril(t7, -1).T
    symm_case("dense 7168^2 x 7168^2 (deepseek-v3 NS)", x7t,
              randn(7168, 7168), 128, dense=x7s, timed=True)
    p7 = randn(7168, 1)
    symm_case("7168^2 x (7168, 1) unpadded (deepseek-v3 embedding)", x7t,
              p7, 128, dense=x7s, timed=True)
    emb7 = cases["sym_stream"][-1]
    emb7["device_ms"] = graph_ms(torch, lambda: trigrid.sym_stream(
        x7t, p7, bm=128))
    emb7["library_device_ms"] = graph_ms(torch, lambda: x7s @ p7)
    log(f"[kernels]   in a CUDA graph (device time, no host): ms "
        f"{emb7['device_ms']:.4f}  library {emb7['library_device_ms']:.4f}")
    del t7, x7t, x7s
    # ragged shapes: rows past a 128-block, 4 B copies, narrow widths
    a160 = randn(160, 160)
    t160 = pack_tril_tiles(a160, 32).contiguous()
    symm_case("160^2 x 160x50 bm 32 (4 B copies)", t160, randn(160, 50), 32)
    for bm, n2 in ((8, 3), (32, 8), (128, 2), (16, 5)):
        n = 16 * bm if bm < 128 else 1024
        symm_case(f"{n}^2 x {n}x{n2} bm {bm} (matrix-vector)",
                  pack_tril_tiles(randn(n, n), bm).contiguous(),
                  randn(n, n2), bm, ds=0.5 if n2 == 5 else 1.0)
    # poison: the upper halves of diagonal tiles never reach the output
    clean = TriTiles.from_tril(randn(512, 512), 32).tiles.contiguous()
    poisoned = clean.clone()
    ii = torch.arange(16, device=dev)
    up = torch.triu(torch.ones(32, 32, device=dev, dtype=torch.bool), 1)
    diag = poisoned[ii * (ii + 3) // 2]
    poisoned[ii * (ii + 3) // 2] = torch.where(up, float("nan"), diag)
    for n2 in (64, 1):
        bb = randn(512, n2)
        got = trigrid.sym_stream(poisoned, bb, bm=32)
        want = trigrid._sym_stream_plain(clean, bb, 16, 1.0, f32)
        compare(torch, f"sym_stream poison (NaN upper halves), n2 {n2}",
                got, want, f32)
    nan_cases(torch, dev, t, x, y)

    slstm_cases(torch, randn, cases["slstm_scan"], card_clock_mhz)
    torch.cuda.synchronize()
    return cases


def nan_cases(torch, dev, t, x, y):
    """A NaN in a live element of an operand reaches the output where the
    plain version puts it, through every symmetric kernel at the NS
    shapes: 0/0 made on the card and a NaN with every bit set (bits the
    TF32 rounding must not carry into a number) in A, the latter in B."""
    from repro_torch.core.packing import pack_tril_tiles
    from repro_torch.kernels import trigrid
    zero = torch.zeros((), device=dev)
    nan_a = zero / zero
    nan_b = torch.tensor(-1, dtype=torch.int32, device=dev).view(
        torch.float32)
    log(f"[kernels] NaN cases: 0/0 on the card has bits "
        f"{int(nan_a.view(torch.int32)) & 0xFFFFFFFF:#010x}, B's NaN "
        f"{int(nan_b.view(torch.int32)) & 0xFFFFFFFF:#010x}")
    ta, tb = t.clone(), t.clone().T.contiguous()
    ta[1000, 77] = nan_a
    ta[600, 1999] = nan_b
    tb[300, 1500] = nan_b
    ep = trigrid.Epilogue()
    for body, b in (("syrk", None), ("syr2k", tb)):
        got = trigrid.rank_update(body, ta, b, bm=128, epilogue=ep)
        want = trigrid._rank_update_plain(body, ta, b, 128, ep, None)
        compare(torch, f"rank_update {body} 2048^2, NaN in a live element",
                got, want, torch.float32, nans=True)
    # A: an off-diagonal tile and the lower half of a diagonal tile
    xa = x.clone()
    xa[1000, 300] = nan_a
    xa[130, 129] = nan_b
    yb = y.clone()
    yb[5, 77] = nan_b
    for bm, b in ((128, yb), (32, yb), (128, yb[:, :1].contiguous())):
        tiles = pack_tril_tiles(xa, bm).contiguous()
        got = trigrid.sym_stream(tiles, b, bm=bm)
        want = trigrid._sym_stream_plain(tiles, b, 2048 // bm, 1.0,
                                         torch.float32)
        where = "A and B" if bool(torch.isnan(b).any()) else "A"
        compare(torch, f"sym_stream bm {bm} n2 {b.shape[1]}, NaN in {where}",
                got, want, torch.float32, nans=True)


def tf32_case(torch, got, dense, b):
    """The tolerance has teeth: at the NS shape one TF32 product
    (emulated, ``trigrid.matmul_tf32(passes=1)``) misses ``TOL_F32``
    against the IEEE f32 product, while the kernel (3xTF32) and its
    emulation meet it.  No global TF32 flag is touched."""
    from repro_torch.kernels import trigrid
    want = dense @ b
    scale = max(1.0, float(want.abs().max()))

    def rel(x):
        return float((x - want).abs().max()) / scale
    one, three, kern = rel(trigrid.matmul_tf32(dense, b, 1)), \
        rel(trigrid.matmul_tf32(dense, b, 3)), rel(got)
    ok = one > TOL_F32 and three <= TOL_F32 and kern <= TOL_F32
    log(f"[kernels] 1xTF32 emulation rel {one:.2e} (> {TOL_F32:.0e}), "
        f"3xTF32 emulation {three:.2e}, kernel {kern:.2e} (<= "
        f"{TOL_F32:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the 1xTF32 tolerance case failed")


def slstm_close(torch, name, got, want, tol):
    """max |got − want| and whether |got − want| ≤ tol·(1 + |want|)
    everywhere (relative and absolute, as ``assert_allclose``)."""
    diff = (got - want).abs()
    ok = bool((diff <= tol * (1 + want.abs())).all()) and \
        bool(torch.isfinite(got).all())
    err = float(diff.max())
    log(f"[kernels] {name:60s} max_abs_err {err:.3e} (<= {tol:.0e}·(1+|x|))"
        f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"kernel {name} disagrees with its plain version")
    return err


def resource_usage(lib: str) -> dict:
    """{kernel: (registers, static shared bytes, local bytes)} from
    ``cuobjdump -res-usage`` of a built library (local memory holds any
    spills)."""
    from pathlib import Path
    from repro_torch.kernels import native
    tool = str(Path(native.nvcc_path()).parent / "cuobjdump")
    text = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                          text=True, check=True).stdout
    table, name = {}, None
    for ln in text.splitlines():
        ln = ln.strip()
        if ln.startswith("Function "):
            name = ln[len("Function "):].rstrip(":")
        elif ln.startswith("REG:") and name:
            f = dict(kv.split(":", 1) for kv in ln.split() if ":" in kv)
            table[name] = (int(f["REG"]), int(f.get("SHARED", 0)),
                           int(f.get("LOCAL", 0)))
            name = None
    return table


def sass_loop_sizes(lib: str) -> dict:
    """{kernel: instructions in its longest innermost loop} from
    ``cuobjdump -sass`` of a built library: a loop is a branch back to a
    lower address, innermost if no other loop lies inside it, and its
    size counts every instruction between target and branch (both sides
    of any branch inside; subroutines called from it excluded)."""
    from pathlib import Path
    from repro_torch.kernels import native
    tool = str(Path(native.nvcc_path()).parent / "cuobjdump")
    return loop_sizes(subprocess.run([tool, "-sass", lib],
                                     capture_output=True, text=True,
                                     check=True).stdout)


def loop_sizes(text: str) -> dict:
    """``sass_loop_sizes`` of cuobjdump's text."""
    sizes, fn, labels, branches, pending = {}, None, {}, [], []

    def close():
        if fn:
            loops = {(labels.get(t, t), a) for a, t in branches
                     if isinstance(labels.get(t, t), int) and
                     labels.get(t, t) <= a}
            inner = [(a - t) // 16 + 1 for t, a in loops
                     if not any(o != (t, a) and t <= o[0] and o[1] <= a
                                for o in loops)]
            sizes[fn] = max(inner, default=0)
    for ln in text.splitlines():
        ln = ln.strip()
        if ln.startswith("Function :"):
            close()
            fn, labels, branches, pending = ln.split(":", 1)[1].strip(), \
                {}, [], []
        elif ln.startswith(".L") and ln.endswith(":"):
            pending.append(ln[:-1])
        elif ln.startswith("/*") and "*/" in ln and fn:
            head = ln[2:ln.index("*/")]
            try:
                addr = int(head, 16)
            except ValueError:
                continue
            for lab in pending:
                labels[lab] = addr
            pending = []
            body = ln[ln.index("*/") + 2:].split(";")[0]
            if re.search(r"\bBRA\b", body):    # target: the last operand
                tgt = body.split("BRA", 1)[1].split(",")[-1]
                lab = re.search(r"\((\.L\w+)\)", tgt)
                num = re.search(r"0x[0-9a-fA-F]+", tgt)
                if lab or num:
                    branches.append((addr, lab.group(1) if lab else
                                     int(num.group(0), 16)))
    close()
    return sizes


#: steps in one iteration of the kernel's step loop (kGroup)
SLSTM_GROUP = 8


def slstm_issue(card_clock_mhz):
    """Instructions per step of the kernel (quad layout, f32 and bf16
    gates) from the SASS of its loop body, and the ms a B·S·d scan needs
    to issue them: instructions a step × steps / 32 lanes / (132 SMs × 4
    schedulers × clock)."""
    from repro_torch.kernels import native
    sizes = sass_loop_sizes(str(native._lib_path("slstm_scan.cu")))
    for k, v in sizes.items():
        if "slstm_kernel" in k:
            log(f"[kernels] SASS {k[-24:]}: longest innermost loop {v} "
                f"instructions")
    per_step = {}
    for tag, key in (("F32", "f32"), ("BF16", "bf16")):
        found = [v for k, v in sizes.items() if "slstm_kernel" in k and
                 re.search(rf"{len(tag)}{tag}E?Lb1ELb0E", k)]
        if len(found) != 1 or not found[0]:
            raise SystemExit(f"no step loop of the {key} quad kernel in "
                             f"the SASS: {sizes}")
        per_step[key] = found[0] / SLSTM_GROUP
    log(f"[kernels] slstm_scan, SASS of the step loop: "
        f"{per_step} instructions a step (step loop / {SLSTM_GROUP}; "
        f"issue at {card_clock_mhz} MHz)")
    rate = 132 * 4 * card_clock_mhz * 1e6          # warp instructions / s

    def issue_ms(dtype, steps):
        return per_step[dtype] * steps / 32 / rate * 1e3
    return per_step, issue_ms


#: (B, S, d, gate dtype, layout, state, label).  "quad": the four views of
#: one (B, S, d, 4) tensor, as the serving mixer hands them; "separate":
#: four contiguous tensors; "gate-major": views of a (B, S, 4, d) tensor.
#: The kernel runs 8 steps at a time and its ring 24 steps ahead.
SLSTM_CASES = (
    (1, 64, 1024, "bf16", "quad", "cold", "prefill bucket 64"),
    (1, 256, 1024, "bf16", "quad", "cold", "prefill bucket 256"),
    (4, 1, 1024, "bf16", "quad", "warm", "decode, 4 slots (S = 1)"),
    (16, 4096, 1024, "bf16", "quad", "warm", "reference traffic shape"),
    (1, 64, 1024, "f32", "quad", "cold", "prefill bucket 64"),
    (4, 1, 1024, "f32", "quad", "warm", "decode, 4 slots"),
    (2, 96, 256, "f32", "quad", "warm", "S not a power of two"),
    (16, 4096, 1024, "f32", "quad", "warm", "reference traffic shape"),
    (2, 96, 256, "f32", "separate", "warm", "general path"),
    (2, 96, 256, "bf16", "gate-major", "warm", "general path"),
    (2, 5, 256, "bf16", "quad", "warm", "S below the ring's lookahead"),
    (2, 99, 200, "bf16", "quad", "warm", "S not a multiple of 8, ragged d"),
    (2, 100, 256, "f32", "quad", "n0<1", "n0 in (0, 1)"),
    (2, 100, 256, "f32", "separate", "n0<1", "n0 in (0, 1), general path"),
    (1, 4096, 1024, "bf16", "quad", "warm", "long single prefill"),
)
SLSTM_MAIN = 0          # the serve's prefill: the kernels line's row


def slstm_cases(torch, randn, rows, card_clock_mhz):
    """``slstm_scan`` against its plain version (on the f32 upcast of the
    same gates), input/forget gates scaled by 2.5 as in the reference
    kernel test; each case timed back to back, inside a CUDA graph
    (device time) and as the plain version."""
    from repro_torch.kernels import native, slstm
    ring = native.load()["repro_slstm_ring_bytes"]
    usage = resource_usage(str(native._lib_path("slstm_scan.cu")))
    if sum("slstm_kernel" in k for k in usage) != 6 or \
            sum("slstm_bwd_kernel" in k for k in usage) != 2:
        raise SystemExit("not the 6 slstm_scan and 2 slstm_scan_bwd "
                         f"kernels' resources: {usage}")
    for k, (regs, smem, local) in usage.items():
        if "slstm_kernel" in k or "slstm_bwd_kernel" in k:
            dyn = ring(int("BF16" in k)) if "Lb1E" in k else 0
            log(f"[build] {k}: {regs} registers, {smem} B static smem "
                f"(+ {dyn} B ring), {local} B local (spills)")
    _, issue_ms = slstm_issue(card_clock_mhz)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    scale = torch.tensor([1.0, 2.5, 2.5, 1.0], device=DEVICE)
    for i, (b, s, d, dt, layout, kind, label) in enumerate(SLSTM_CASES):
        pre = (randn(b, s, d, 4) * scale).to(dtypes[dt])
        if layout == "quad":
            gates = pre.unbind(-1)
        elif layout == "separate":
            gates = [g.contiguous() for g in pre.unbind(-1)]
        else:
            gates = pre.permute(0, 1, 3, 2).contiguous().unbind(2)
        if kind == "cold":
            st = (torch.zeros(b, d, device=DEVICE),
                  torch.ones(b, d, device=DEVICE),
                  torch.zeros(b, d, device=DEVICE))
        elif kind == "warm":
            st = (randn(b, d), 1.0 + randn(b, d).abs(), randn(b, d))
        else:
            st = (0.3 * randn(b, d), 0.05 + 0.9 * torch.rand(
                b, d, device=DEVICE), randn(b, d))

        def run(gates=gates, st=st):
            return slstm.slstm_scan(*gates, *st)
        f32_gates = [g.float() for g in gates]
        name = f"slstm_scan ({b}, {s}, {d}) {dt} {layout} {label}"
        assert (slstm._quad_base(gates) is not None) == (layout == "quad")
        got = run()
        want = slstm._slstm_scan_plain(*f32_gates, *st)
        err = slstm_close(torch, name + " y", got[0], want[0], SLSTM_Y_TOL)
        err_s = max(slstm_close(torch, f"{name} {k}1", g, w,
                                SLSTM_STATE_TOL)
                    for k, g, w in zip("cnm", got[1:], want[1:]))
        del want
        steps = b * s * d
        nbytes = steps * (4 * pre.element_size() + 4) + 6 * b * d * 4
        bound, by = bound_ms(nbytes, SLSTM_OPS_PER_STEP * steps,
                             tensor=False)
        row = {"case": f"({b}, {s}, {d}) {dt} {layout} {label}",
               "main": i == SLSTM_MAIN, "dtype": dt, "layout": layout,
               "max_abs_err": err,
               "max_abs_err_state": err_s, "bound_ms": bound,
               "bound_by": by, "ffma_bound_ms": bound,
               "issue_bound_ms": issue_ms(dt, steps), "library_ms": None,
               "ms": cuda_ms(torch, run),
               "device_ms": graph_ms(torch, run,
                                     reps=10 if steps > 1e7 else 50),
               "plain_ms": cuda_ms(torch, lambda: slstm._slstm_scan_plain(
                   *f32_gates, *st))}
        log(f"[kernels]   ms {row['ms']:.4f}  device "
            f"{row['device_ms']:.4f}  plain {row['plain_ms']:.4f}  library "
            f"none  bound {bound:.4f} ({by})  issue bound "
            f"{row['issue_bound_ms']:.4f}")
        rows.append(row)


# --------------------------------------------------------------------------
# phases 4-5: serve at full width with the whitening cache
# --------------------------------------------------------------------------
def run_serve(torch, arch, tenants=1, label="", warm_start=None,
              save_cache=None, cfg=None):
    """Serve 8 requests of 8–47 prompt tokens on 4 slots (s_max 256, 16
    new tokens, ``tenants`` tenants, whitening cache with refresh stride
    2, optionally warm-started from / saved to a dir; ``cfg`` in place
    of the published config, e.g. cut in depth); the launch counts are
    set to 0 just before and read just after."""
    from repro_torch.kernels import counts
    from repro_torch.launch.serve import serve
    args = argparse.Namespace(
        arch=arch, smoke=False, device=DEVICE, requests=8,
        slots=4, s_max=256, max_new=16, prompt_lo=8, prompt_hi=48,
        tenants=tenants, whiten="cache", refresh_stride=2,
        warm_start=warm_start, save_cache=save_cache, no_eos=True, seed=0)
    counts.reset_launch_counts()
    out = serve(args, cfg=cfg)
    launches = counts.launch_counts()
    tag = f"[{arch}{label}]"
    log(f"{tag} {out['arch']} layers {out['layers']} d_model "
        f"{out['d_model']} vocab {out['vocab']} on {out['device']}")
    log(f"{tag} completed {out['completed']}/{out['requests']}  tokens/s "
        f"{out['tokens_per_s']:.2f}  ttft (embedding included) mean "
        f"{out['mean_ttft_s']:.4f} p50 {out['p50_ttft_s']:.4f} s p99 "
        f"{out['p99_ttft_s']:.4f} s  latency mean {out['mean_latency_s']:.4f}"
        f" s  startup {out['startup_s']:.2f} s")
    log(f"{tag} host s (each ends in a sync): serve {out['serve_s']:.4f}"
        f"  prefill {out['prefill_s']:.4f}  embed {out['embed_s']:.4f}"
        f"  decode {out['decode_s']:.4f} over {out['decode_steps']} steps")
    log(f"{tag} refreshes {out['cache']['refreshes']} (s: "
        f"{[round(s, 4) for s in out['refresh_s']]})  ns_fallbacks "
        f"{out['cache']['ns_fallbacks']}  forwards {out['model_forwards']}"
        f" ({out['warmup_forwards']} warm-up)  launches {launches}, of "
        f"which after warm-up {out['kernel_launches']}")
    assert out["completed"] == out["requests"], out
    assert out["embeddings_finite"], "non-finite embedding"
    assert out["cache"]["factors_ready"] >= 1 and \
        out["cache"]["refreshes"] >= 1, out["cache"]
    assert out["cache"]["failed_refreshes"] == 0, out["cache"]
    assert launches["rank_update"] > 0 and launches["sym_stream"] > 0, \
        launches
    return out, launches


def serve_phase(torch):
    out, launches = run_serve(torch, "stablelm-1.6b")
    assert (out["layers"], out["d_model"], out["vocab"]) == (24, 2048,
                                                             100352)
    assert launches["slstm_scan"] == 0, launches
    return out, launches


def xlstm_phase(torch):
    from repro_torch.configs import get_config
    cfg = get_config("xlstm-350m")
    n_slstm = sum(cfg.pattern[i % cfg.period].mixer == "slstm"
                  for i in range(cfg.n_layers))
    from repro_torch.kernels import slstm
    from repro_torch.models import ssm
    seen = set()
    scan, plain = ssm.slstm_scan, slstm._slstm_scan_plain

    def spy(*args, **kw):            # the gates the mixer hands the kernel
        seen.add((str(args[0].dtype), slstm._quad_base(args[:4])
                  is not None))
        return scan(*args, **kw)

    def guard(*args):
        assert not args[0].is_cuda, "a CUDA tensor reached the plain scan"
        return plain(*args)
    ssm.slstm_scan, slstm._slstm_scan_plain = spy, guard
    try:
        out, launches = run_serve(torch, "xlstm-350m")
    finally:
        ssm.slstm_scan, slstm._slstm_scan_plain = scan, plain
    log(f"[xlstm] slstm_scan gates (dtype, quad views): {sorted(seen)}")
    assert seen == {("torch.bfloat16", True)}, seen
    assert (out["layers"], out["d_model"], out["vocab"]) == (24, 1024,
                                                             50304)
    assert n_slstm == 6
    # every forward (ladder warm-ups, admits, decode steps) ran every
    # sLSTM layer on the kernel, once
    assert launches["slstm_scan"] == n_slstm * out["model_forwards"], \
        (launches, out["model_forwards"])
    assert out["kernel_launches"]["slstm_scan"] == n_slstm * (
        out["model_forwards"] - out["warmup_forwards"]), out
    log(f"[xlstm] slstm_scan launches {launches['slstm_scan']} = "
        f"{n_slstm} x {out['model_forwards']} forwards")
    out["prefill_split"] = prefill_split(torch, cfg, "[xlstm]")
    return out, launches


def prefill_split(torch, cfg, tag):
    """Host seconds by block kind (the mixer, and the MLP where there is
    one: "mamba+moe") in one full-width prefill per bucket and one
    4-slot decode step, with a sync after every block (so the split,
    not the sum, is the point)."""
    from repro_torch.models.model import init_model
    model = init_model(cfg, seed=0, device=DEVICE)
    split = {}

    def timed(fn):
        by_kind, t0 = {}, [0.0]    # blocks run one after another

        def pre(_m, _a):
            torch.cuda.synchronize()
            t0[0] = time.perf_counter()

        def post(blk, _a, _o):
            torch.cuda.synchronize()
            kind = blk.spec.mixer if blk.spec.mlp == "none" else \
                f"{blk.spec.mixer}+{blk.spec.mlp}"
            by_kind[kind] = by_kind.get(kind, 0.0) + \
                time.perf_counter() - t0[0]
        handles = []
        for blk in model.blocks:
            handles += [blk.register_forward_pre_hook(pre),
                        blk.register_forward_hook(post)]
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total = time.perf_counter() - start
        for h in handles:
            h.remove()
        return {"total_s": total, **{f"{k}_s": v for k, v in
                                     by_kind.items()}}

    for bucket in (16, 64, 128, 256):
        toks = torch.ones((1, bucket), dtype=torch.long, device=DEVICE)
        model.prefill(toks, 256)                       # warm
        split[f"prefill {bucket}"] = timed(lambda: model.prefill(toks, 256))
    cache = model.init_cache(4, 256)
    tok = torch.ones((4, 1), dtype=torch.long, device=DEVICE)
    model.decode_step(tok, tok, cache)
    split["decode 4 slots"] = timed(lambda: model.decode_step(tok, tok,
                                                              cache))
    for k, v in split.items():
        log(f"{tag} {k}: " + "  ".join(f"{n} {x:.4f}" for n, x in
                                       v.items()))
    del model
    torch.cuda.empty_cache()
    return split


# --------------------------------------------------------------------------
# phase 6: the port on the card against references
# --------------------------------------------------------------------------
def check_phase(torch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_model
    from repro_torch.optim.gram import packed_gram, whitening_from_packed
    from repro_torch.kernels import counts

    # reduced model: same weights on the card and on the CPU
    cfg = get_smoke_config("stablelm-1.6b")
    m_cpu = init_model(cfg, seed=0, device="cpu")
    m_gpu = init_model(cfg, seed=1, device=DEVICE)
    m_gpu.load_state_dict(m_cpu.state_dict())
    toks = torch.randint(1, cfg.vocab, (2, 24),
                         generator=torch.Generator().manual_seed(0))
    lc, _, hc = m_cpu.prefill(toks, 32, return_hidden=True)
    lg, _, hg = m_gpu.prefill(toks.to(DEVICE), 32, return_hidden=True)
    err = float((lg.cpu() - lc).abs().max())
    log(f"[check] smoke prefill logits card vs cpu: max_abs_err {err:.3e}"
        f" (<= 5e-2, bf16 activations)")
    assert lg.shape == (2, 1, cfg.vocab) and bool(torch.isfinite(lg).all())
    assert err <= 5e-2, err

    # full-width NS whitening on the kernels vs the eigh oracle
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x = torch.randn(2048, 4096, generator=gen, device=DEVICE)
    before = counts.launch_counts()
    g = packed_gram(x)
    w = whitening_from_packed(g, 2048, eps=1e-3, method="ns")
    after = counts.launch_counts()
    alone = {}
    for d in (2048, 1024):        # one refresh's NS alone, nothing beside
        gd = packed_gram(x[:d])
        whitening_from_packed(gd, d, eps=1e-3, method="ns")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whitening_from_packed(gd, d, eps=1e-3, method="ns")
        torch.cuda.synchronize()
        alone[d] = time.perf_counter() - t0
    log(f"[check] NS whitening alone (host s, ends in a sync): d=2048 "
        f"{alone[2048]:.4f}  d=1024 {alone[1024]:.4f}")
    we = whitening_from_packed(g, 2048, eps=1e-3, method="eigh")
    rel = float(torch.linalg.norm(w - we) / torch.linalg.norm(we))
    log(f"[check] NS whitening d=2048 vs eigh: rel {rel:.3e} (<= 1e-3); "
        f"launches {before} -> {after}")
    assert rel <= 1e-3, rel
    assert after["rank_update"] > before["rank_update"] and \
        after["sym_stream"] > before["sym_stream"]
    xlstm_check(torch)


def xlstm_check(torch):
    """The xlstm smoke model (three mLSTM blocks and one sLSTM block at
    d_model 64: a ragged 128-channel block for the kernel) on the card
    against the same weights on the CPU: prefill and 4 decode steps."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import counts
    from repro_torch.models.model import init_model

    cfg = get_smoke_config("xlstm-350m")
    m_cpu = init_model(cfg, seed=0, device="cpu")
    m_gpu = init_model(cfg, seed=1, device=DEVICE)
    m_gpu.load_state_dict(m_cpu.state_dict())
    toks = torch.randint(1, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    before = counts.launch_counts()["slstm_scan"]
    lc, cc, hc = m_cpu.prefill(toks, 64, return_hidden=True)
    lg, cg, hg = m_gpu.prefill(toks.to(DEVICE), 64, return_hidden=True)
    errs = [float((lg.cpu() - lc).abs().max())]
    h_err = float((hg.cpu().float() - hc.float()).abs().max())
    nxt = lc[:, -1].argmax(-1)[:, None]
    for k in range(4):
        pos = torch.full((2, 1), 40 + k)
        lc, cc = m_cpu.decode_step(nxt, pos, cc)
        lg, cg = m_gpu.decode_step(nxt.to(DEVICE), pos.to(DEVICE), cg)
        errs.append(float((lg.cpu() - lc).abs().max()))
        assert bool(torch.isfinite(lg).all())
        nxt = lc[:, -1].argmax(-1)[:, None]
    launched = counts.launch_counts()["slstm_scan"] - before
    log(f"[check] xlstm smoke card vs cpu: logits max_abs_err prefill "
        f"{errs[0]:.3e}, decode {[f'{e:.3e}' for e in errs[1:]]} "
        f"(<= 5e-2), hidden {h_err:.3e} (<= 6.25e-2); slstm_scan "
        f"launches {launched} (1 sLSTM layer x 5 forwards)")
    assert lg.shape == (2, 1, cfg.vocab)
    assert max(errs) <= 5e-2 and h_err <= 6.25e-2, (errs, h_err)
    assert launched == 5, launched


# --------------------------------------------------------------------------
# phase 7: train stablelm-1.6b at full width with Muon on the kernels
# --------------------------------------------------------------------------
#: the Muon NS check's bound: the reference's own (tests/test_optim.py,
#: 1D NS against the reference NS), |got − want| ≤ 2e-3 + 2e-3·|want|
MUON_TOL = 2e-3


#: (k, n2, accumulate epilogue cases) of the stacked checks: k = 4 with
#: and without the epilogue, the train path's own k = 24 stacks (the 24
#: layers' (2048, 2048) and (2048, 5632) leaves), and k = 1 at the
#: short side of the (100352, 2048) embeddings, which NS takes unbatched
BATCHED_CASES = ((4, 2048, (False, True)), (4, 5632, (False, True)),
                 (24, 2048, (False,)), (24, 5632, (False,)),
                 (1, 100352, (False,)))


def batched_cases(torch, cases):
    """``rank_update`` (SYRK) and ``sym_stream`` at every shape the Muon
    step gives them (``BATCHED_CASES``): each against its plain version
    on the same inputs within ``TOL_F32``, each matrix of a stack bit for
    bit against its own unbatched launch, one launch a call, and timed
    against k unbatched launches, the plain version and one ``torch.bmm``
    (``torch.matmul`` for k = 1) in IEEE f32."""
    from repro_torch.core.packing import pack_tril_tiles
    from repro_torch.kernels import trigrid
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(7)
    d = 2048

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def checked_row(name, label, k, got, plain, singles, run, library,
                    nbytes, flops):
        want = plain()
        err = compare(torch, f"{name} {label}", got, want, torch.float32)
        del want
        row = {"case": label, "max_abs_err": err, "main": False,
               "batch": k}
        if k > 1:
            same = all(torch.equal(got[i], singles(i)) for i in range(k))
            log(f"[train]   each matrix bit-equal to its unbatched launch: "
                f"{same}")
            if not same:
                raise SystemExit(f"{name} {label}: a batched matrix differs"
                                 " from its unbatched launch")
            row["bit_equal_unbatched"] = same
        before = getattr(trigrid, name).launches
        run()
        assert getattr(trigrid, name).launches == before + 1
        row["ms"] = cuda_ms(torch, run)
        if k > 1:
            row["unbatched_ms"] = cuda_ms(
                torch, lambda: [singles(i) for i in range(k)])
        row["plain_ms"] = cuda_ms(torch, plain)
        row["library_ms"] = cuda_ms(torch, library)
        row["library"] = "torch.bmm" if k > 1 else "torch.matmul"
        row["ffma_bound_ms"] = bound_ms(nbytes, flops, False)[0]
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
        log(f"[train]   ms {row['ms']:.4f} (k = {k})"
            + (f"  {k} unbatched {row['unbatched_ms']:.4f}" if k > 1
               else "")
            + f"  plain {row['plain_ms']:.4f}"
            + f"  {row['library']} {row['library_ms']:.4f}  bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']})")
        cases[name].append(row)

    for k, n2, accs in BATCHED_CASES:
        lead = (k,) if k > 1 else ()
        shape = str(lead + (d, n2)).replace(",)", ")")
        kind = "batched" if k > 1 else "unbatched"
        mm = torch.bmm if k > 1 else torch.matmul
        a = randn(*lead, d, n2) / n2 ** 0.5
        T = (d // 128) * (d // 128 + 1) // 2
        out_b = k * T * 128 * 128 * 4
        flops = k * d * (d + 1) * n2
        for acc in accs:
            c0 = randn(*lead, T, 128, 128) if acc else None
            ep = trigrid.Epilogue(beta=1.0, accumulate=True) if acc else \
                trigrid.Epilogue()

            def run(a=a, ep=ep, c0=c0):
                return trigrid.rank_update("syrk", a, bm=128, epilogue=ep,
                                           c0=c0)

            def single(i, a=a, ep=ep, c0=c0):
                return trigrid.rank_update(
                    "syrk", a[i], bm=128, epilogue=ep,
                    c0=None if c0 is None else c0[i])
            checked_row(
                "rank_update", f"syrk {shape} {kind}"
                + (" beta c0" if acc else ""), k, run(),
                lambda a=a, ep=ep, c0=c0: trigrid._rank_update_plain(
                    "syrk", a, None, 128, ep, c0),
                single, run, lambda a=a: mm(a, a.mT),
                k * d * n2 * 4 + out_b * (2 if acc else 1), flops)
        # the NS products: S·S (n2 = d) and sym(Y)·X (n2 > d)
        s = randn(*lead, d, d) / d ** 0.5
        tiles = pack_tril_tiles(s, 128).contiguous()
        sym = torch.tril(s) + torch.tril(s, -1).mT
        del s
        b = randn(*lead, d, n2)

        def srun(tiles=tiles, b=b):
            return trigrid.sym_stream(tiles, b, bm=128)

        def ssingle(i, tiles=tiles, b=b):
            return trigrid.sym_stream(tiles[i], b[i], bm=128)
        checked_row(
            "sym_stream", f"{str(lead + (d, d)).replace(',)', ')')} x "
            f"{shape} {kind}", k, srun(),
            lambda tiles=tiles, b=b: trigrid._sym_stream_plain(
                tiles, b, d // 128, 1.0, torch.float32),
            ssingle, srun, lambda sym=sym, b=b: mm(sym, b),
            tiles.numel() * 4 + 2 * k * d * n2 * 4, 2 * k * d * d * n2)
        del a, tiles, sym, b
        torch.cuda.empty_cache()


def autodiff_check(torch):
    """``torch.autograd.grad`` through ``blas.syrk`` / ``syr2k`` / ``symm``
    at n1 = 2048, n2 = 512 on the kernel route, every fill, against the
    same on the dense IEEE route.  The loss is linear in the output
    (⟨C, W⟩), so the backward ops' kernels alone make the difference."""
    from repro_torch import blas
    from repro_torch.blas.routing import Route
    from repro_torch.kernels import counts
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    n1, n2 = 2048, 512

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE)
    a, b = randn(n1, n2) / n2 ** 0.5, randn(n1, n2) / n2 ** 0.5
    s = randn(n1, n1) / n1 ** 0.5
    worst = 0.0
    for op in ("syrk", "syr2k", "symm"):
        for fill in (("tril", "full", "packed") if op != "symm" else
                     ("dense", "tritiles")):
            def run(dense, op=op, fill=fill):
                xs = [t.clone().requires_grad_(True) for t in
                      ((a,) if op == "syrk" else (a, b) if op == "syr2k"
                       else (s, b))]
                oracle = Route(op, "dense", "the dense IEEE oracle", n1, n2)
                with blas.pinned(oracle if dense else None):
                    if op == "syrk":
                        c = blas.syrk(xs[0], fill=fill)
                    elif op == "syr2k":
                        c = blas.syr2k(xs[0], xs[1], fill=fill)
                    else:
                        sa = xs[0] if fill == "dense" else \
                            blas.TriTiles.from_tril(xs[0], 128)
                        c = blas.symm(sa, xs[1])
                w = torch.randn(c.shape, generator=torch.Generator(
                    device=DEVICE).manual_seed(5), device=DEVICE)
                return torch.autograd.grad((c * w).sum(), xs)
            before = counts.launch_counts()
            got = run(False)
            after = counts.launch_counts()
            want = run(True)
            errs = [float((g - r).abs().max()) / max(1.0, float(
                r.abs().max())) for g, r in zip(got, want)]
            ok = max(errs) <= TOL_F32 and all(
                bool(torch.isfinite(g).all()) for g in got)
            launched = {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}
            log(f"[train] autodiff {op} {fill:8s} kernel vs dense IEEE: rel "
                f"{max(errs):.2e} (<= {TOL_F32:.0e}), kernel launches "
                f"{launched} {'ok' if ok else 'FAIL'}")
            if not ok or not launched:
                raise SystemExit(f"autodiff of {op} ({fill}) on the card "
                                 "disagrees with the dense route")
            worst = max(worst, max(errs))
    return worst


def plain_symmetric_kernels(torch):
    """Swap the symmetric kernels' wrappers for their plain versions on
    the card; returns the function that swaps them back."""
    from repro_torch.kernels import trigrid
    rank, sym = trigrid.rank_update, trigrid.sym_stream

    def rank_plain(body, a, b=None, *, bm, epilogue=None, c0=None):
        return trigrid._rank_update_plain(body, a, b, bm,
                                          epilogue or trigrid.Epilogue(), c0)

    def sym_plain(a_tiles, b, *, bm, out_dtype=torch.float32,
                  diag_scale=1.0):
        return trigrid._sym_stream_plain(a_tiles, b, b.shape[-2] // bm,
                                         diag_scale, out_dtype)
    trigrid.rank_update, trigrid.sym_stream = rank_plain, sym_plain

    def restore():
        trigrid.rank_update, trigrid.sym_stream = rank, sym
    return restore


def muon_check(torch):
    """One Muon orthogonalisation of a (24, 2048, 5632) momentum (5 NS
    steps) on the kernels against the same on their plain versions (the
    wrappers swapped for the plain functions on the card)."""
    from repro_torch.kernels import counts
    from repro_torch.optim.muon import orthogonalize_reference
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    m = torch.randn(24, 2048, 5632, generator=gen, device=DEVICE)
    before = counts.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = orthogonalize_reference(m, steps=5)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    after = counts.launch_counts()
    restore = plain_symmetric_kernels(torch)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = orthogonalize_reference(m, steps=5)
        torch.cuda.synchronize()
        plain_secs = time.perf_counter() - t0
    finally:
        restore()
    diff = (got - want).abs()
    err = float(diff.max())
    ok = bool((diff <= MUON_TOL + MUON_TOL * want.abs()).all()) and \
        bool(torch.isfinite(got).all())
    launched = {k: after[k] - before[k] for k in after}
    log(f"[train] Muon NS (24, 2048, 5632), 5 steps, kernels vs plain: "
        f"max_abs_err {err:.3e} (<= {MUON_TOL:.0e} + {MUON_TOL:.0e}|x|), "
        f"max |x| {float(want.abs().max()):.3f}; host s {secs:.4f} (plain "
        f"{plain_secs:.4f}); launches {launched} {'ok' if ok else 'FAIL'}")
    assert launched["rank_update"] == 5 and launched["sym_stream"] == 10, \
        launched
    if not ok:
        raise SystemExit("Muon NS on the kernels disagrees with the plain "
                         "versions")
    return {"max_abs_err": err, "s": secs, "plain_s": plain_secs}


def muon_split(torch):
    """Where a Muon step's optimizer time goes: one orthogonalisation (5
    NS steps, kernels) of each distinct leaf shape of stablelm-1.6b's
    tree, host clock around work that ends in a sync, times the leaves
    of that shape."""
    from repro_torch.optim.muon import orthogonalize_reference
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    leaves = (((24, 2048, 2048), 4, "attention wq wk wv wo"),
              ((24, 2048, 5632), 2, "mlp wi wg"),
              ((24, 5632, 2048), 1, "mlp wo"),
              ((100352, 2048), 1, "embed"), ((2048, 100352), 1, "unembed"),
              ((24, 2048), 4, "norm scales and biases (dense route)"))
    rows, total = [], 0.0
    for shape, count, what in leaves:
        m = torch.randn(shape, generator=gen, device=DEVICE)
        orthogonalize_reference(m)                      # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orthogonalize_reference(m)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        total += secs * count
        rows.append({"shape": list(shape), "leaves": count, "what": what,
                     "s_each": secs})
        log(f"[train] Muon NS {str(shape):18s} x {count} ({what}): "
            f"{secs:.4f} s each")
        del m
    log(f"[train] Muon NS, all matrix leaves: {total:.4f} s a step")
    torch.cuda.empty_cache()
    return {"leaves": rows, "total_s": total}


def run_train(torch, optimizer, steps, compress=False,
              arch="stablelm-1.6b"):
    """``arch`` (stablelm-1.6b, or xlstm-350m in phase 15) at its
    published widths (nothing cut), random bf16 init from seed 0, global
    batch 8 x 256 tokens; the launch counts set to 0 just before and
    read just after (inside ``train``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_argparser, train
    args = build_argparser().parse_args([
        "--arch", arch, "--full", "--device", DEVICE,
        "--optimizer", optimizer, "--steps", str(steps),
        "--global-batch", "8", "--seq-len", "256", "--loss-chunk", "256",
        "--seed", "0", "--log-every", "1"]
        + (["--compress-grads"] if compress else []))
    out = train(args)
    tag = f"[train {optimizer}{' compressed' if compress else ''}]"
    log(f"{tag} {out['arch']} layers {out['layers']} d_model "
        f"{out['d_model']} d_ff {out['d_ff']} vocab {out['vocab']} params "
        f"{out['params']} on {out['device']}")
    log(f"{tag} losses {[round(x, 4) for x in out['losses']]}")
    for i, (t, sp) in enumerate(zip(out["step_s"], out["split_s"])):
        log(f"{tag} step {i}{' (warm-up)' if i == 0 else ''}: "
            f"{t:.4f} s = loss+backward {sp['loss_backward_s']:.4f} + clip "
            f"{sp['clip_s']:.4f} + compress {sp['compress_s']:.4f} + "
            f"optimizer {sp['opt_s']:.4f}")
    launches = out["kernel_launches"]
    per_step = {k: v / steps for k, v in launches.items()}
    log(f"{tag} tokens/s {out['tokens_per_s']:.1f} (after warm-up); peak "
        f"memory {out['peak_memory_bytes'] / 2**30:.2f} GiB; launches "
        f"{launches} ({per_step} a step)")
    cfg = get_config(arch)
    assert (out["layers"], out["d_model"], out["d_ff"], out["vocab"]) == \
        (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab), out
    assert all(map(math.isfinite, out["losses"])), out["losses"]
    return out, launches


def assert_kernel_routes(out, launches, tag, slstm=(0, 0)):
    """Every NS SYRK / SYMM with n1 >= 256 of a Muon run took the kernel
    route, one launch per blas call, stacks included; ``slstm_scan`` and
    ``slstm_scan_bwd`` launched ``slstm`` times."""
    routes = out["routes"]                 # [op, n1, n2, path, batched, n]
    big = [r for r in routes if r[1] >= 256]
    log(f"{tag} routes (op, n1, n2, path, batched): calls over the "
        "run: " + "; ".join(f"{tuple(r[:5])}: {r[5]}" for r in routes))
    assert big and all(r[3] == "kernel" for r in big), routes
    n_syrk = sum(r[5] for r in big if r[0] == "syrk")
    n_symm = sum(r[5] for r in big if r[0] == "symm")
    assert launches["rank_update"] == n_syrk and \
        launches["sym_stream"] == n_symm, (launches, n_syrk, n_symm)
    assert launches["rank_update"] > 0 and launches["sym_stream"] > 0
    assert (launches["slstm_scan"], launches["slstm_scan_bwd"]) == slstm, \
        launches


def train_phase(torch, cases):
    batched_cases(torch, cases)
    grad_err = autodiff_check(torch)
    muon = muon_check(torch)
    muon["split"] = muon_split(torch)
    torch.cuda.empty_cache()
    out, launches = run_train(torch, "muon", 4)
    assert_kernel_routes(out, launches, "[train muon]")
    torch.cuda.empty_cache()
    adamw, _ = run_train(torch, "adamw", 2)
    torch.cuda.empty_cache()
    return {"muon": {k: v for k, v in out.items() if k != "routes"},
            "adamw": {k: v for k, v in adamw.items() if k != "routes"},
            "autodiff_rel_err": grad_err, "muon_ns": muon}, launches


# --------------------------------------------------------------------------
# phase 8: the mesh schedules on a gloo group, all ranks on this card
# --------------------------------------------------------------------------
MESH_N1, MESH_N2 = 2048, 5632
MESH_TOL = 2e-5
#: the §IX budget (f32 words a device) under which the planner turns
#: this shape on 12 ranks into the streamed 3d-limited schedule
MESH_M = 500_000
#: (P, route name, path, choice kwargs); 3d-limited is planned, not pinned
MESH_ROUTES = ((4, "1d", {}), (4, "ring", {}), (6, "2d", {"c": 2}),
               (12, "3d", {"c": 2, "p2": 2}), (12, "3d-limited", None))
#: the ranks of the gloo launch phases 8, 11 and 12 share (the largest P)
MESH_WORLD = 12


def _mesh_choice(path, P, kw):
    from repro_torch.core.dispatch import AlgoChoice
    if path == "ring":
        return AlgoChoice("ring", 3, P, p1=P, p2=1)
    if path == "1d":
        return AlgoChoice("1d", 1, P, p1=1, p2=P)
    c = kw["c"]
    return AlgoChoice(path, 3, P, c=c, p1=c * (c + 1), p2=kw.get("p2", 1))


def _mesh_ms(torch, dist, fn, comm):
    """Mean ms a call over a >= 25 ms window of at least 3 calls, CUDA
    events on rank 0 of ``comm``; every rank of it runs the same number
    of calls (the collectives pair up), agreed on by an all-reduce over
    its group of the first call's time outside the counted
    collectives."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    est = torch.tensor([time.perf_counter() - t0])
    dist.all_reduce(est, op=dist.ReduceOp.MAX, group=comm.group)
    reps = max(3, math.ceil(0.025 / max(float(est), 1e-6)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps if comm.index == 0 else None


def _mesh_predicted(route, op, n1, n2):
    from repro_torch.core.dispatch import (predicted_words_1d,
                                           predicted_words_2d,
                                           predicted_words_3d, ring_nb)
    m, ch, P = (1 if op == "syrk" else 2), route.choice, route.P
    if route.path == "1d":
        return predicted_words_1d(n1, P)
    if route.path == "ring":
        return m * (P // 2) * ring_nb(n1, P) * n2
    if route.path == "2d":
        return predicted_words_2d(n1, n2, m, ch.c)
    return predicted_words_3d(n1, n2, m, ch.c, ch.p2)


def mesh_rank(mesh, cases, muon=False):
    """One rank of the mesh phase: every (route, op) case, then (rank 0
    of 4) Muon's orthogonalize_1d against the single-device chain."""
    import torch
    import torch.distributed as dist
    from repro_torch import blas
    from repro_torch.blas.routing import Route
    from repro_torch.core.lower_bounds import memory_independent_lower_bound
    from repro_torch.core.packing import pack_tril
    from repro_torch.distributed import collectives
    from repro_torch.kernels import counts
    P, rank, dev = mesh.shape["x"], mesh.rank, mesh.device
    gen = torch.Generator(device=dev).manual_seed(7)
    n1, n2 = MESH_N1, MESH_N2
    a = torch.randn(n1, n2, generator=gen, device=dev)
    b = torch.randn(n1, n2, generator=gen, device=dev)
    s = torch.randn(n1, n1, generator=gen, device=dev)
    out = {"cases": [], "picks": {}}
    for op in ("syrk", "syr2k", "symm"):
        r = blas.plan_route(op, n1, n2, device=dev, mesh=mesh)
        out["picks"][op] = r.describe()
    launched = {}
    for name, path, kw in cases:
        if kw is None:                 # planned under the budget
            route = blas.plan_route("syrk", n1, n2, device=dev, mesh=mesh,
                                    M=MESH_M)
            assert route.path == path, route.describe()
        else:
            route = Route("syrk", path, "pinned by chip_smoke", n1, n2,
                          P=P, axis="x", choice=_mesh_choice(path, P, kw))
        for op in ("syrk", "syr2k", "symm"):
            def call():
                if op == "syrk":
                    return blas.syrk(a, fill="packed", mesh=mesh)
                if op == "syr2k":
                    return blas.syr2k(a, b, fill="packed", mesh=mesh)
                return blas.symm(s, b, mesh=mesh)
            with blas.pinned(route):
                assert blas.plan_route(op, n1, n2, device=dev,
                                       mesh=mesh).path == path
                counts.reset_launch_counts()
                collectives.reset_word_counts()
                got = call()
                torch.cuda.synchronize()
                words = collectives.word_counts()
                launches = counts.launch_counts()
                ms = _mesh_ms(torch, dist, call, mesh.comm("x"))
            for k, v in launches.items():
                launched[k] = launched.get(k, 0) + v
            row = {"P": P, "route": name, "op": op, "words": words,
                   "predicted": _mesh_predicted(route, op, n1, n2),
                   "lower_bound": memory_independent_lower_bound(
                       n1, n2, P, 1 if op == "syrk" else 2).bound,
                   "ms": ms, "describe": route.describe()}
            if rank == 0:
                if op == "symm":
                    sym = torch.tril(s) + torch.tril(s, -1).T
                    want = sym @ b
                else:
                    g = a @ (a if op == "syrk" else b).T
                    want = pack_tril(g if op == "syrk" else g + g.T)
                err = float((got - want).abs().max())
                row["rel_err"] = err / float(want.abs().max())
                row["finite"] = bool(torch.isfinite(got).all())
                if not (row["rel_err"] <= MESH_TOL and row["finite"]):
                    raise SystemExit(f"mesh {name} {op} P={P}: rel err "
                                     f"{row['rel_err']:.3e} > {MESH_TOL}")
            del got
            out["cases"].append(row)
    out["launches"] = launched
    if muon:
        out["muon"] = _mesh_muon(torch, mesh, counts, collectives)
    return out


def _mesh_muon(torch, mesh, counts, collectives):
    """orthogonalize_1d of a (24, 2048, 5632) stack on this mesh against
    the single-device orthogonalize_reference (on the kernels) on rank
    0, at 2e-3."""
    from repro_torch.core.onedim import gather_columns
    from repro_torch.optim.muon import (orthogonalize_1d,
                                        orthogonalize_reference)
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(11)
    g = torch.randn(24, 2048, 5632, generator=gen, device=dev)
    counts.reset_launch_counts()
    collectives.reset_word_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shard = orthogonalize_1d(g, mesh, "x", steps=5)
    torch.cuda.synchronize()
    res = {"s": time.perf_counter() - t0,
           "words": collectives.word_counts(),
           "launches": counts.launch_counts()}
    # the result stays column-sharded; gathered here only for the check
    got = gather_columns(shard, mesh.comm("x"))
    if mesh.rank == 0:
        want = orthogonalize_reference(g, steps=5)
        diff = (got - want).abs()
        res["max_abs_err"] = float(diff.max())
        res["ok"] = bool((diff <= MUON_TOL + MUON_TOL * want.abs()).all()) \
            and bool(torch.isfinite(got).all())
        if not res["ok"]:
            raise SystemExit("orthogonalize_1d disagrees with the single-"
                             "device orthogonalize_reference")
    return res


def _first_ranks(mesh, P):
    """Ranks 0..P-1 of ``mesh``'s gloo world as a one-axis mesh "x" of
    P ranks (no 3d grids: P = 4 and 6 have none), None on the other
    ranks.  Collective: every rank of the world calls it."""
    import torch.distributed as dist
    from repro_torch.distributed.mesh import Comm, Mesh
    ranks = tuple(range(P))
    group = dist.new_group(list(ranks), backend=mesh.backend)
    if mesh.rank >= P:
        return None
    staged = mesh.comm("x").staged
    return Mesh({"x": P}, rank=mesh.rank,
                groups={"x": Comm("x", P, mesh.rank, ranks, group, staged)},
                backend=mesh.backend, device=mesh.device)


def gloo_rank(mesh, cases):
    """One rank of the gloo launch that phases 8, 11 (b) and 12 (d)
    share (one process start for all of them): ``MESH_WORLD`` ranks on
    this card; the P = 12 mesh cases on every rank, the P = 6 ones on
    ranks 0-5, then on ranks 0-3 the P = 4 ones with Muon's
    ``orthogonalize_1d``, phase 11's ABFT case and phase 12's compressed
    all-reduces; the ranks outside a step wait at a barrier.  Returns
    this rank's results by step."""
    import torch.distributed as dist
    out = {"mesh 12": mesh_rank(mesh, cases[12])}
    for P in (6, 4):
        sub = _first_ranks(mesh, P)
        if sub is not None:
            out[f"mesh {P}"] = mesh_rank(sub, cases[P], muon=P == 4)
            if P == 4:
                out["abft"] = abft_mesh_rank(sub)
                out["compress"] = compress_rank(sub)
        dist.barrier()
    return out


def mesh_phase(torch, beside=None):
    """Phase 8: the single-device blas calls, then the shared gloo launch
    (``gloo_rank``); its mesh cases checked and printed here, its ABFT
    and compression results returned for phases 11 and 12.  ``beside``
    starts work on a thread of this process while the launch runs (its
    ranks hold little of the card and wait mostly on the host) and
    returns its join; the join's result is returned under
    ``"beside"``."""
    from repro_torch import blas
    from repro_torch.distributed.launch import run_ranks
    card = torch.cuda.get_device_name(0)
    # one single-device blas call of each op at the same shape (kernels)
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    a = torch.randn(MESH_N1, MESH_N2, generator=gen, device=DEVICE)
    b = torch.randn(MESH_N1, MESH_N2, generator=gen, device=DEVICE)
    s = torch.randn(MESH_N1, MESH_N1, generator=gen, device=DEVICE)
    single = {"syrk": cuda_ms(torch, lambda: blas.syrk(a, fill="packed")),
              "syr2k": cuda_ms(torch, lambda: blas.syr2k(a, b,
                                                         fill="packed")),
              "symm": cuda_ms(torch, lambda: blas.symm(s, b))}
    del a, b, s
    torch.cuda.empty_cache()
    log(f"[mesh] single-device blas at ({MESH_N1}, {MESH_N2}), kernels: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in single.items()))
    cases = {P: [(name, name, kw) for P_, name, kw in MESH_ROUTES
                 if P_ == P] for P in (4, 6, 12)}
    log(f"[mesh] gloo, host-staged wire, one launch of {MESH_WORLD} ranks "
        f"on one {card}: P = 12, then 6 and 4 on its first ranks, with "
        "phase 11's ABFT and phase 12's compressed all-reduces on 4")
    t0 = time.perf_counter()
    join = beside() if beside is not None else None
    every = run_ranks("chip_smoke:gloo_rank", MESH_WORLD, backend="gloo",
                      device="cuda:0", paths=[ROOT], timeout=700,
                      kwargs={"cases": cases})
    wall = time.perf_counter() - t0
    done = join() if join is not None else None
    log(f"[mesh] the shared launch: {wall:.1f} s (process start included)")
    rows, picks, launched, muon = [], {}, {}, None
    for P in (4, 6, 12):
        res = [r[f"mesh {P}"] for r in every if f"mesh {P}" in r]
        assert len(res) == P, (P, len(res))
        picks[P] = res[0]["picks"]
        for op, d in picks[P].items():
            log(f"[mesh]   planner's own pick, P={P}: {d}")
        for i, row in enumerate(res[0]["cases"]):
            for r in res[1:]:
                assert r["cases"][i]["words"] == row["words"], (
                    "ranks moved different words", row, r["cases"][i])
            sched = {k: v for k, v in row["words"].items()
                     if k != "replicate"}
            log(f"[mesh]   {row['route']:10s} {row['op']:5s} P={P}: rel err "
                f"{row['rel_err']:.2e} (<= {MESH_TOL:.0e}); schedule words a "
                f"rank {sched} = {sum(sched.values())}, replication "
                f"{row['words'].get('replicate', 0)}; predicted "
                f"{row['predicted']:.6g}; lower bound "
                f"{row['lower_bound']:.6g}; {row['ms']:.3f} ms")
            rows.append(row)
        for r in res:
            for k, v in r["launches"].items():
                launched[k] = launched.get(k, 0) + v
        if P == 4:
            muon = res[0]["muon"]
            log(f"[mesh] Muon orthogonalize_1d (24, 2048, 5632), P=4, 5 NS "
                f"steps vs single-device orthogonalize_reference: "
                f"max_abs_err {muon['max_abs_err']:.3e} (<= {MUON_TOL:.0e} + "
                f"{MUON_TOL:.0e}|x|); words a rank {muon['words']}; host s "
                f"{muon['s']:.3f}; mesh launches {muon['launches']}")
            for r in res:
                for k, v in r["muon"]["launches"].items():
                    launched[k] = launched.get(k, 0) + v
    log(f"[mesh] kernel launches on the mesh path (every rank): {launched}")
    assert all(v == 0 for v in launched.values()), launched
    shared = {k: [r[k] for r in every[:4]] for k in ("abft", "compress")}
    return {"cases": rows, "single_device_ms": single, "picks": picks,
            "muon_1d": muon, "launch_s": wall, "beside": done}, launched, \
        shared


# --------------------------------------------------------------------------
# phase 9: checkpoints and resume of the full-width Muon trainer
# --------------------------------------------------------------------------
#: Muon's packed Grams resume from bf16-narrowed words (the reference
#: checkpoint test's bound on such words)
GRAM_TOL = 1e-2


def _ckpt_estimate(cfg, layers: int) -> int:
    """Bytes of one checkpoint at ``layers``: bf16 parameters and their
    f32 momentum (attention, MLP, embedding and head; norms and the
    packed Grams are a rounding error)."""
    d = cfg.d_model
    n = layers * (4 * d * d + 3 * d * cfg.d_ff) + 2 * cfg.vocab * d
    return n * (2 + 4)


def _gram_bits(path: str):
    """The bf16 words of a packed leaf file, as int16."""
    import numpy as np
    import torch
    return torch.from_numpy(np.load(path).view(np.int16))


def _gram_words(path: str):
    import torch
    return _gram_bits(path).view(torch.bfloat16).float()


#: phase 9's depth: the published widths, 2 of the 24 layers (the
#: embeddings, 2.47 GB of the checkpoint's bytes, are whole); 4 until
#: phase 17 needed the time
CKPT_LAYERS = 2


def ckpt_phase(torch):
    """Run A trains stablelm-1.6b (published widths, ``CKPT_LAYERS``
    layers) with Muon and the packed Gram 3 steps, saving every 2
    (async) and at the end (blocking); its step-3 checkpoint is set
    aside.  Run B, on the same
    dir, resumes from step 2 and writes step 3 again.  B's losses must
    equal A's step 2 and every leaf of B's step 3 A's (crc), the Grams
    (bf16 words) within GRAM_TOL."""
    import gc
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_argparser, train
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(root).free
        cfg = get_config("stablelm-1.6b")
        layers = CKPT_LAYERS
        log(f"[ckpt] free space at {root}: {free} bytes; one checkpoint "
            f"~{_ckpt_estimate(cfg, layers)} bytes at {layers} layers")
        while layers > 1 and 3 * _ckpt_estimate(cfg, layers) > free:
            layers -= 1
        if layers != CKPT_LAYERS:
            log(f"[ckpt] depth cut to {layers} of {CKPT_LAYERS} layers "
                "(widths kept) so that three checkpoints fit")
        d = os.path.join(root, "ckpt")
        argv = ["--arch", "stablelm-1.6b", "--full", "--device", DEVICE,
                "--optimizer", "muon", "--track-gram", "--steps", "3",
                "--ckpt-dir", d, "--ckpt-every", "2", "--ckpt-keep", "2",
                "--global-batch", "8", "--seq-len", "256",
                "--loss-chunk", "256", "--seed", "0", "--log-every", "1"]
        if layers != cfg.n_layers:
            argv += ["--layers", str(layers)]
        runs = {}
        for name in ("A", "B"):
            runs[name] = train(build_argparser().parse_args(argv))
            gc.collect()
            torch.cuda.empty_cache()
            if name == "A":
                os.rename(os.path.join(d, "step_00000003"),
                          os.path.join(root, "A_step_00000003"))
        a, b = runs["A"], runs["B"]
        for name, r in runs.items():
            log(f"[ckpt {name}] layers {r['layers']} d_model {r['d_model']} "
                f"d_ff {r['d_ff']} vocab {r['vocab']}: steps "
                f"{r['start_step']}..{r['start_step'] + r['steps'] - 1}, "
                f"losses {r['losses']}, resumed {r['resumed']}, "
                f"launches {r['kernel_launches']}, times {r['ckpt_s']}")
        assert (a["d_model"], a["d_ff"], a["vocab"]) == \
            (cfg.d_model, cfg.d_ff, cfg.vocab), a
        assert not a["resumed"] and len(a["losses"]) == 3, a
        assert b["resumed"] and b["start_step"] == 2, b
        vr = b["restore_verified"]
        log(f"[ckpt B] restore verified: {vr['checked']} leaves "
            f"({vr['packed']} packed), {len(vr['mismatches'])} mismatches")
        assert vr["mismatches"] == [], vr
        diff = max(abs(x - y) for x, y in zip(a["losses"][2:], b["losses"]))
        bit_equal = a["losses"][2:] == b["losses"]
        log(f"[ckpt] B's losses {b['losses']} vs A's step 2 "
            f"{a['losses'][2:]}: bit-equal {bit_equal}, largest "
            f"difference {diff}")
        assert bit_equal, (a["losses"], b["losses"])
        with open(os.path.join(root, "A_step_00000003",
                               "manifest.json")) as f:
            ma = json.load(f)["leaves"]
        with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
            mb = json.load(f)["leaves"]
        assert sorted(ma) == sorted(mb), (sorted(ma), sorted(mb))
        grams = [k for k in ma if k.startswith("opt__.gram__")
                 and "packed" in ma[k]]
        differ = [k for k in ma if ma[k]["crc"] != mb[k]["crc"]
                  and k not in grams]
        log(f"[ckpt] step 3, B against A: {len(ma)} leaves, crc differs "
            f"in {differ} apart from the {len(grams)} packed Grams")
        assert differ == [], differ
        gram_err = 0.0
        for k in grams:
            ga = _gram_words(os.path.join(root, "A_step_00000003",
                                          k + ".npy"))
            gb = _gram_words(os.path.join(d, "step_00000003", k + ".npy"))
            gram_err = max(gram_err, float((ga - gb).abs().max()
                                           / ga.abs().max()))
        log(f"[ckpt] packed Grams, B against A: largest relative "
            f"difference {gram_err} (tolerance {GRAM_TOL})")
        assert grams and gram_err <= GRAM_TOL, (grams, gram_err)
        for r in (a, b):
            n = r["kernel_launches"]
            assert n["rank_update"] > 0 and n["sym_stream"] > 0, n
        nbytes = b["ckpt_bytes"]
        assert nbytes == a["ckpt_bytes"] == sum(m["bytes"]
                                                for m in mb.values())
        times = {"async_snapshot_s": a["ckpt_s"]["snapshot_s"],
                 "blocking_save_s": [a["ckpt_s"]["save_s"],
                                     b["ckpt_s"]["save_s"]],
                 "restore_s": b["ckpt_s"]["restore_s"],
                 "verify_s": b["ckpt_s"]["verify_s"]}
        log(f"[ckpt] checkpoint {nbytes} bytes ({len(mb)} leaves); "
            f"{json.dumps(times)}")
        launches = {k: a["kernel_launches"].get(k, 0)
                    + b["kernel_launches"].get(k, 0)
                    for k in set(a["kernel_launches"])
                    | set(b["kernel_launches"])}
        return {"layers": layers, "free_bytes": free, "ckpt_bytes": nbytes,
                "leaves": len(mb), "losses_A": a["losses"],
                "losses_B": b["losses"], "bit_equal": bit_equal,
                "gram_rel_err": gram_err, **times}, launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 10: the serving cache's save and warm start at full width
# --------------------------------------------------------------------------
#: Newton–Schulz launches of one whitening refresh: a SYRK (T²) an
#: iteration, two SYMMs (X·T, T²·M) an iteration and one for the seed
NS_ITERS = 30


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, files in os.walk(path) for f in files)


def _state_by_key(cache):
    return {(t, a, layer): v for (t, a), mon in cache._monitors.items()
            for layer, v in mon._state.items()}


def warm_phase(torch):
    """Serve stablelm-1.6b (published widths, 2 tenants) saving the
    whitening cache, serve it again warm-started from the save, check
    save -> warm start bit-exact in-process at d = 2048, then serve under
    persistent refresh faults and save under transient I/O faults."""
    import gc
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core.packing import PackedTriangle, tril_size
    from repro_torch.distributed import faults
    from repro_torch.distributed.checkpoint import (read_manifest,
                                                    restore_checkpoint,
                                                    verify_restored)
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.serving_cache import ServingGramCache
    from repro_torch.models.model import init_model
    arch, tenants = "stablelm-1.6b", 2
    root = tempfile.mkdtemp(prefix="chip_smoke_warm_")
    made, restored = [], []
    real_requests, real_warm = (serve_mod.synthetic_requests,
                                ServingGramCache.warm_start)

    def requests_spy(*a, **k):          # the requests serve() makes
        made.append(real_requests(*a, **k))
        return made[-1]

    def warm_spy(self, *a, **k):        # the state just restored
        n = real_warm(self, *a, **k)
        restored.append({k_: v.clone() for k_, v in
                         _state_by_key(self).items()})
        return n
    serve_mod.synthetic_requests = requests_spy
    ServingGramCache.warm_start = warm_spy
    try:
        # 1. save
        ck = os.path.join(root, "cache")
        cold, _ = run_serve(torch, arch, tenants, " save", save_cache=ck)
        cold_toks = [tuple(r.generated) for r in made[-1]]
        entries = read_manifest(ck)["extra"]["serving_cache"]["entries"]
        step_dir = os.path.join(ck, "step_00000000")
        disk = _dir_bytes(step_dir)
        gc.collect()
        torch.cuda.empty_cache()
        # 2. warm
        warm, launches = run_serve(torch, arch, tenants, " warm",
                                   warm_start=ck)
        warm_toks = [tuple(r.generated) for r in made[-1]]
        gc.collect()
        torch.cuda.empty_cache()
        wc, cc = warm["cache"], cold["cache"]
        log(f"[warm] saved {len(entries)} keys, {disk} bytes on disk; "
            f"factor_cold / factor_hits: cold serve {cc['factor_cold']} / "
            f"{cc['factor_hits']}, warm serve {wc['factor_cold']} / "
            f"{wc['factor_hits']}")
        assert (cold["layers"], cold["d_model"], cold["vocab"]) == (
            24, 2048, 100352), cold
        assert len(entries) == tenants and cc["keys"] == tenants, entries
        assert wc["warm_loaded"] == len(entries), wc
        [state] = restored
        for e in entries:
            got = state[(e["tenant"], e["arch"], e["layer"])]
            assert got.is_cuda and got.dtype == torch.bfloat16, got
            want = _gram_bits(os.path.join(step_dir, e["leaf"] + ".npy"))
            assert torch.equal(got.view(torch.int16).cpu(), want), e
        log(f"[warm] restored EMA words ({len(entries)} keys, on "
            f"{DEVICE}) bit-equal to the files")
        same = warm_toks == cold_toks
        log(f"[warm] tokens warm vs cold identical: {same}")
        assert same
        assert launches["slstm_scan"] == 0, launches
        # every refresh (the warm start's included) ran its NS chain on
        # the kernels, every update its Gram on rank_update
        assert launches["rank_update"] >= NS_ITERS * wc["refreshes"] + \
            wc["updates"], (launches, wc)
        assert launches["sym_stream"] >= (2 * NS_ITERS + 1) * \
            wc["refreshes"], (launches, wc)

        # 3. parity at d = 2048, in-process
        d = 2048
        keys = [("tA", "final"), ("tB", "final"), ("tA", "mid")]
        live = ServingGramCache(refresh_stride=1, synchronous=True)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        for tenant, layer in keys:
            live.update(tenant, arch, layer, torch.randn(
                d, 64, generator=gen, device=DEVICE))
        pdir = os.path.join(root, "parity")
        live.save(pdir, step=0)
        again = ServingGramCache(refresh_stride=1, synchronous=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = again.warm_start(pdir, device=DEVICE)
        torch.cuda.synchronize()
        ready_s = time.perf_counter() - t0
        assert n == len(keys) and again.snapshot_stats()[
            "factors_ready"] == len(keys), again.snapshot_stats()
        for tenant, layer in keys:
            a = live.factor(tenant, arch, layer)
            b = again.factor(tenant, arch, layer)
            assert b.is_cuda and torch.equal(a, b), (tenant, layer)
        log(f"[warm] d = {d}: {n} keys saved and warm-started, each warm "
            f"factor bit-equal to the live one; warm start until every "
            f"factor ready {ready_s:.4f} s")

        # 4. chaos: persistent refresh faults, then transient I/O faults
        cfg = get_config(arch)
        model = init_model(cfg, seed=0, device=DEVICE)
        chaos = ServingGramCache(refresh_stride=1, refresh_retries=0,
                                 breaker_threshold=2)
        srv = serve_mod.Server(cfg, model, slots=4, s_max=256, max_new=16,
                               eos_id=-1, whiten="cache", gram_cache=chaos,
                               device=DEVICE)
        srv.warm_up()
        reqs = real_requests(8, cfg.vocab, 0, lo=8, hi=48, tenants=tenants)
        try:
            with faults.inject(faults.FaultSpec(
                    site="serve:refresh", kind="error", times=0)) as inj:
                serve_mod.run(srv, reqs, 8 * 16)
                chaos.drain()
        finally:
            chaos.close()
        st = chaos.snapshot_stats()
        chaos_toks = [tuple(r.generated) for r in reqs]
        stale = sorted(f"tenant{i}/{cfg.name}/final"
                       for i in range(tenants))
        log(f"[warm chaos] {len(inj.events)} injected refresh faults; "
            f"failed_refreshes {st['failed_refreshes']} of "
            f"{st['refreshes']}, stale {st['stale']}, tokens identical to "
            f"the fault-free serve: {chaos_toks == cold_toks}")
        assert all(r.done_t is not None for r in reqs)
        assert chaos_toks == cold_toks
        assert st["failed_refreshes"] >= 1 and st["stale"] == stale, st
        fdir = os.path.join(root, "io_faults")
        with faults.inject(
                faults.FaultSpec(site="ckpt:fsync", kind="error", times=2),
                faults.FaultSpec(site="ckpt:rename", kind="error",
                                 times=1)) as inj:
            chaos.save(fdir, step=0)
        fe = read_manifest(fdir)["extra"]["serving_cache"]["entries"]
        like = {e["leaf"]: PackedTriangle(torch.zeros(
            tril_size(e["d"]), dtype=torch.bfloat16, device=DEVICE),
            e["d"]) for e in fe}
        _, back = restore_checkpoint(fdir, like)
        vr = verify_restored(fdir, back)
        live_state = _state_by_key(chaos)
        exact = all(torch.equal(back[e["leaf"]].vec.view(torch.int16),
                                live_state[(e["tenant"], e["arch"],
                                            e["layer"])].view(torch.int16))
                    for e in fe)
        log(f"[warm chaos] save under {[e.site for e in inj.events]}: "
            f"committed, {vr['checked']} leaves verified, "
            f"{len(vr['mismatches'])} mismatches, words bit-equal {exact}")
        assert len(inj.events) == 3 and len(fe) == tenants
        assert vr["mismatches"] == [] and vr["checked"] == tenants and exact
        del srv, model
        gc.collect()
        torch.cuda.empty_cache()

        # 5. what it cost
        out = {"keys": len(entries), "bytes_on_disk": disk,
               "save_cache_s": cold["save_cache_s"],
               "warm_start_s": warm["warm_start_s"],
               "warm_start_until_ready_s_d2048": ready_s,
               "refresh_s_warm": warm["refresh_s"],
               "factor_cold_hits": {"cold": [cc["factor_cold"],
                                             cc["factor_hits"]],
                                    "warm": [wc["factor_cold"],
                                             wc["factor_hits"]]},
               **{f"{k}_{name}": r[k] for name, r in (("cold", cold),
                                                      ("warm", warm))
                  for k in ("tokens_per_s", "mean_ttft_s", "p50_ttft_s",
                            "p99_ttft_s")},
               "chaos_failed_refreshes": st["failed_refreshes"]}
        log(f"[warm] bytes on disk {disk}; save_cache_s "
            f"{out['save_cache_s']:.4f}  warm_start_s "
            f"{out['warm_start_s']:.4f}  warm start until ready (d = {d}, "
            f"{len(keys)} keys) {ready_s:.4f}  refresh s (warm serve) "
            f"{[round(x, 4) for x in warm['refresh_s']]}")
        for name, r in (("cold", cold), ("warm", warm)):
            log(f"[warm] {name} serve: tokens/s {r['tokens_per_s']:.2f}  "
                f"ttft mean {r['mean_ttft_s']:.4f} p50 "
                f"{r['p50_ttft_s']:.4f} p99 {r['p99_ttft_s']:.4f} s")
        return out, launches
    finally:
        serve_mod.synthetic_requests = real_requests
        ServingGramCache.warm_start = real_warm
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 11: ABFT-checked SYRK / SYR2K / SYMM, and the kill -> resume run
# --------------------------------------------------------------------------
#: the stablelm-1.6b MLP leaf's Muon Gram shape
ABFT_N1, ABFT_N2 = 2048, 5632
#: the kernel each checked op's local route must launch
ABFT_KERNEL = {"syrk": "rank_update", "syr2k": "rank_update",
               "symm": "sym_stream"}


def abft_local(torch, n1=ABFT_N1, n2=ABFT_N2, device=DEVICE):
    """checked_syrk / syr2k / symm on the local route at (n1, n2), f32
    from a seed: a clean call (its routes, launches and largest honest
    residual as a fraction of its threshold), a bitflip and a nan on
    band 0 (the local route's one band), a persistent nan, a rebuild
    from the clean output at c = 2, and the ms of the unchecked call,
    of the check alone and of the checked call."""
    from repro_torch.blas.routing import capture_routes
    from repro_torch.core.packing import pack_tril
    from repro_torch.distributed import faults
    from repro_torch.distributed import resilience as res
    from repro_torch.kernels import counts
    gen = torch.Generator(device=device).manual_seed(23)
    a = torch.randn(n1, n2, generator=gen, device=device)
    b = torch.randn(n1, n2, generator=gen, device=device)
    s = pack_tril(torch.randn(n1, n1, generator=gen, device=device))
    checks = {"syrk": res._check_syrk, "syr2k": res._check_syr2k,
              "symm": res._check_symm}
    rows = {}
    for op, ops in (("syrk", (a,)), ("syr2k", (a, b)), ("symm", (s, b))):
        fn = getattr(res, f"checked_{op}")
        row = rows[op] = {}
        counts.reset_launch_counts()
        with capture_routes() as routes:
            clean, rep = fn(*ops)
        row["launches"] = counts.launch_counts()
        row["paths"] = sorted({r.path for r in routes})
        row["clean"] = (rep.detected, rep.attempts, rep.action)
        resid, thr = res.checksum_residuals(op, *ops, out=clean)
        row["residual_fraction"] = float((resid / thr).max())
        row["faults"] = {}
        for kind in ("bitflip", "nan"):
            with faults.inject(faults.FaultSpec(
                    site=f"collective:{op}", kind=kind, device=0),
                    seed=5) as inj:
                got, rep = fn(*ops, backoff=0.0)
            row["faults"][kind] = {
                "events": len(inj.events), "detected": rep.detected,
                "primary": rep.primary, "action": rep.action,
                "attempts": rep.attempts,
                "bit_equal": bool(torch.equal(got, clean))}
        with faults.inject(faults.FaultSpec(
                site=f"collective:{op}", kind="nan", device=0, times=0)):
            try:
                fn(*ops, retries=1, backoff=0.0)
                row["persistent"] = "not raised"
            except res.AbftError as e:
                row["persistent"] = f"AbftError after {e.report.attempts}"
        if op != "symm":
            with faults.inject(faults.FaultSpec(
                    site=f"collective:{op}", kind="bitflip", device=0),
                    seed=5):
                got, rep = fn(*ops, reference=clean, c=2)
            row["rebuild"] = {"action": rep.action, "devices": rep.devices,
                              "attempts": rep.attempts,
                              "bit_equal": bool(torch.equal(got, clean))}
        if device != "cpu":
            run = res.route_runner(op, "local")
            chk = checks[op](n1, res._default_rtol(n1, n2, torch.float32),
                             res.DEFAULT_ATOL)
            row["kernel_ms"] = cuda_ms(torch, lambda: run(*ops))
            # the check as the checked call runs it: flags, then the
            # flagged rows' indices to the host
            row["check_ms"] = cuda_ms(
                torch, lambda: torch.nonzero(chk(*ops, clean)).cpu())
            row["checked_ms"] = cuda_ms(torch, lambda: fn(*ops))
        del clean
    return rows


def abft_mesh_rank(mesh):
    """One rank of the mesh case: checked_syrk on the 1d route at
    (ABFT_N1, ABFT_N2), clean and under a bitflip on band 3, with the
    words of each call; rank 0 holds the clean result to a dense
    torch.matmul oracle."""
    import torch
    from repro_torch.core.packing import pack_tril
    from repro_torch.distributed import collectives, faults
    from repro_torch.distributed import resilience as res
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(29)
    a = torch.randn(ABFT_N1, ABFT_N2, generator=gen, device=dev)
    collectives.reset_word_counts()
    clean, rep0 = res.checked_syrk(a, route="1d", mesh=mesh)
    words = collectives.word_counts()
    collectives.reset_word_counts()
    with faults.inject(faults.FaultSpec(site="collective:syrk",
                                        kind="bitflip", device=3),
                       seed=3) as inj:
        got, rep = res.checked_syrk(a, route="1d", mesh=mesh, backoff=0.0)
    out = {"clean_detected": rep0.detected, "words": words,
           "retry_words": collectives.word_counts(),
           "events": len(inj.events), "detected": rep.detected,
           "primary": rep.primary, "action": rep.action,
           "attempts": rep.attempts, "bad_rows": rep.bad_rows,
           "bit_equal": bool(torch.equal(got, clean))}
    if mesh.rank == 0:
        want = pack_tril(a @ a.T)
        out["rel_err"] = float((clean - want).abs().max()
                               / want.abs().max())
    return out


def abft_phase(torch, ranks):
    """Phase 11 (a) and (b): the checked calls on the kernels, then the
    mesh case's ``ranks``: 4 gloo ranks sharing the card, run in phase
    8's launch (``gloo_rank``)."""
    rows = abft_local(torch)
    launches = {}
    for op, row in rows.items():
        log(f"[abft] {op} local ({ABFT_N1}, {ABFT_N2}): routes "
            f"{row['paths']}, launches {row['launches']}; clean "
            f"{row['clean']}; largest honest residual "
            f"{row['residual_fraction']:.3e} of its threshold; faults "
            f"{row['faults']}; persistent: {row['persistent']}; rebuild "
            f"{row.get('rebuild')}; ms: kernel call {row['kernel_ms']:.4f}, "
            f"check alone {row['check_ms']:.4f}, checked call "
            f"{row['checked_ms']:.4f}")
        assert row["paths"] == ["kernel"], row["paths"]
        assert row["launches"][ABFT_KERNEL[op]] > 0, row["launches"]
        assert row["clean"] == (False, 1, "none"), row["clean"]
        assert row["residual_fraction"] < 1.0, row["residual_fraction"]
        for kind, f in row["faults"].items():
            assert f == {"events": 1, "detected": True, "primary": 0,
                         "action": "retry", "attempts": 2,
                         "bit_equal": True}, (op, kind, f)
        assert row["persistent"] == "AbftError after 2", row["persistent"]
        if op != "symm":
            rb = row["rebuild"]
            assert rb["action"] == "rebuild" and rb["devices"] \
                and rb["attempts"] == 1 and rb["bit_equal"], rb
        for k, v in row["launches"].items():
            launches[k] = launches.get(k, 0) + v
    card = torch.cuda.get_device_name(0)
    log(f"[abft] mesh: checked_syrk, 1d, 4 gloo ranks on one {card} "
        "(phase 8's launch)")
    for r, m in enumerate(ranks):
        log(f"[abft] mesh rank {r}: {m}")
        assert not m["clean_detected"] and m["events"] == 1, m
        assert m["detected"] and m["primary"] == 3 and m["attempts"] == 2 \
            and m["action"] == "retry" and m["bit_equal"], m
        assert m["retry_words"] == {k: 2 * v for k, v in
                                    m["words"].items()}, m
    assert ranks[0]["rel_err"] <= MESH_TOL, ranks[0]["rel_err"]
    return {"local": rows, "mesh": ranks}, launches


#: the depth of the kill -> resume runs (phases 11 (c) and 14) and of
#: phase 13 (b): stablelm-1.6b's published widths, 2 of its 24 layers
RESUME_LAYERS = 2
#: their steps, the kill before step 1, the checkpoint at step 1
RESUME_STEPS, RESUME_KILL, RESUME_EVERY = 2, 1, 1


def _train_argv(optimizer, steps, layers=0, arch="stablelm-1.6b"):
    """The train flags of phase 7's traffic (8 x 256 tokens, seed 0) at
    ``arch``'s published widths."""
    argv = ["--arch", arch, "--full", "--optimizer", optimizer,
            "--steps", str(steps), "--global-batch", "8", "--seq-len",
            "256", "--loss-chunk", "256", "--seed", "0", "--data-seed",
            "0", "--log-every", "1"]
    return argv + (["--layers", str(layers)] if layers else [])


def _packed_grams(d: str):
    """{key: bf16 words as f32} of the packed Gram leaves of the newest
    checkpoint in ``d``."""
    from repro_torch.distributed import read_manifest
    m = read_manifest(d)
    step = os.path.join(d, f"step_{m['step']:08d}")
    return {k: _gram_words(os.path.join(step, k + ".npy"))
            for k, v in m["leaves"].items() if "packed" in v}


def single_resume_depth(torch):
    """The uninterrupted single-device run at ``RESUME_LAYERS``:
    ``muon-syrk`` with ``--track-gram`` on phase 7's traffic,
    ``RESUME_STEPS`` steps, its one checkpoint (the last step) read for
    its packed Grams and deleted.  Phases 11 (c), 13 (b) and 14 hold
    their runs to it (on one device ``muon`` and ``muon-syrk`` run the
    same chain)."""
    import gc
    import shutil
    import tempfile

    from repro_torch.launch.train import build_argparser, train
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_single_")
    try:
        argv = _train_argv("muon-syrk", RESUME_STEPS, RESUME_LAYERS) + [
            "--device", DEVICE, "--track-gram", "--ckpt-dir", root,
            "--ckpt-every", "0"]
        t0 = time.perf_counter()
        out = train(build_argparser().parse_args(argv))
        out["wall_s"] = time.perf_counter() - t0
        out["grams"] = _packed_grams(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[single] {out['arch']} {out['layers']} layers, d_model "
        f"{out['d_model']} d_ff {out['d_ff']} vocab {out['vocab']}, "
        f"muon-syrk + Grams, one device: losses {out['losses']}, launches "
        f"{out['kernel_launches']}, {out['wall_s']:.1f} s (its checkpoint "
        "included)")
    assert len(out["grams"]) == 2, sorted(out["grams"])
    return out


def recovery_phase(torch, single):
    """Phase 11 (c): ``run_recovery`` at stablelm-1.6b's published widths
    and ``RESUME_LAYERS`` layers with ``muon-syrk`` and ``--track-gram``,
    phase 7's traffic: phase 1 killed before step ``RESUME_KILL``,
    phase 2 resumed from that step.  Both phases' losses must be the
    uninterrupted single-device run's at that depth, bit for bit."""
    import gc
    import shutil
    import tempfile

    from repro_torch.launch.recovery import run_recovery
    gc.collect()
    torch.cuda.empty_cache()          # the phases' processes need the card
    root = tempfile.mkdtemp(prefix="chip_smoke_recovery_")
    try:
        free = shutil.disk_usage(root).free
        log(f"[recovery] free space at {root}: {free} bytes")
        t0 = time.perf_counter()
        out = run_recovery(
            os.path.join(root, "ckpt"), devices=1, devices_after=1,
            steps=RESUME_STEPS, kill_step=RESUME_KILL,
            ckpt_every=RESUME_EVERY, global_batch=8, seq_len=256,
            layers=RESUME_LAYERS, optimizer="muon-syrk", track_gram=True,
            timeout=500, device=DEVICE,
            extra_args=["--full", "--loss-chunk", "256"])
        total = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    p1, p2 = out["phases"]
    summary = {k: v for k, v in out.items() if k != "phases"}
    log(f"[recovery] {json.dumps(summary)}")
    log(f"[recovery] phase 1: {p1['s']:.1f} s, losses {p1.get('losses')}, "
        f"launches {p1.get('kernel_launches')}")
    log(f"[recovery] phase 2: {p2['s']:.1f} s, losses {p2.get('losses')}, "
        f"launches {p2.get('kernel_launches')}, checkpoint s "
        f"{p2.get('ckpt_s')}")
    assert out["killed"] and out["kill_step"] == RESUME_KILL, out
    assert len(p1["losses"]) == RESUME_KILL, p1
    assert out["resumed_step"] == RESUME_EVERY, out
    assert out["mismatches"] == 0, out
    assert out["completed"] and out["final"]["resumed"], out
    want = single["losses"]
    got = p1["losses"] + p2["losses"]
    log(f"[recovery] losses {got} vs the uninterrupted single-device run's "
        f"{want}: bit-equal {got == want}")
    assert got == want, (got, want)
    launches = {}
    for p in (p1, p2):
        n = p["kernel_launches"]
        assert n["rank_update"] > 0 and n["sym_stream"] > 0, n
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
    times = {"phase1_s": p1["s"], "phase2_s": p2["s"], "total_s": total,
             "restore_s": p2["ckpt_s"]["restore_s"],
             "verify_s": p2["ckpt_s"]["verify_s"],
             "save_s": p2["ckpt_s"].get("save_s")}
    log(f"[recovery] {json.dumps(times)}")
    return {"free_bytes": free, "layers": RESUME_LAYERS,
            "verified_leaves": out["verified_leaves"],
            "losses_phase1": p1["losses"], "losses_phase2": p2["losses"],
            "single_losses": want, **times}, launches


# --------------------------------------------------------------------------
# phase 12: int8 gradient compression with error feedback
# --------------------------------------------------------------------------
#: stablelm-1.6b's largest gradient leaf, the MLP Muon stack; one matrix
#: of it is the DP wire's leaf in (d), beside a symmetric 2048² one
COMPRESS_LEAF = (24, 2048, 5632)
COMPRESS_RANKS = 4
COMPRESS_BLOCK = 256
#: (c)'s depth; the widths are the published ones
COMPRESS_LAYERS = 2


def compress_train(torch, muon7):
    """(a) Muon with ``--compress-grads`` at full width, phase 7's
    traffic, 4 steps: the kernel routes, step 0's loss phase 7's bit for
    bit (init, batch and loss come before any update)."""
    out, launches = run_train(torch, "muon", 4, compress=True)
    tag = "[compress train]"
    assert_kernel_routes(out, launches, tag)
    assert out["compress_grads"], out
    want = muon7["losses"]
    log(f"{tag} step 0 loss {out['losses'][0]!r}, phase 7's "
        f"{want[0]!r}: bit-equal {out['losses'][0] == want[0]}")
    assert out["losses"][0] == want[0], (out["losses"], want)
    for i in range(1, len(out["losses"])):
        log(f"{tag} step {i}: loss {out['losses'][i]:.6f}, phase 7's "
            f"(uncompressed) {want[i]:.6f}")
    ef_bytes = 4 * out["params"]
    log(f"{tag} compress_s a step {out['compress_s']}; peak memory "
        f"{out['peak_memory_bytes']} bytes "
        f"({out['peak_memory_bytes'] / 2**30:.2f} GiB; phase 7's "
        f"{muon7['peak_memory_bytes'] / 2**30:.2f}); EF state {ef_bytes} "
        "bytes")
    keep = ("losses", "step_s", "split_s", "compress_s", "tokens_per_s",
            "peak_memory_bytes", "kernel_launches", "params")
    return dict({k: out[k] for k in keep}, ef_bytes=ef_bytes), launches


def compress_quantizer(torch):
    """(b) quantize / dequantize of the largest leaf, f32 from a seed,
    on the card and on the host: bit-equal; the card's timed."""
    from repro_torch.distributed.compression import (ErrorFeedbackInt8,
                                                     dequantize_int8,
                                                     quantize_int8)
    x = torch.randn(COMPRESS_LEAF, generator=torch.Generator()
                    .manual_seed(12))
    xd = x.to(DEVICE)
    q, s = quantize_int8(xd, COMPRESS_BLOCK)
    d = dequantize_int8(q, s, xd.shape)
    qh, sh = quantize_int8(x, COMPRESS_BLOCK)
    dh = dequantize_int8(qh, sh, x.shape)
    same = {"q": bool(torch.equal(q.cpu(), qh)),
            "scale": bool(torch.equal(s.cpu(), sh)),
            "dequantized": bool(torch.equal(d.cpu(), dh))}
    rel = float((dh - x).abs().max() / x.abs().max())
    del x, qh, sh, dh, d
    n = xd.numel()
    nb = n // COMPRESS_BLOCK
    row = {"shape": list(COMPRESS_LEAF), "bit_equal": same,
           "rel_err": rel,
           "quantize_ms": cuda_ms(torch, lambda: quantize_int8(
               xd, COMPRESS_BLOCK)),
           "dequantize_ms": cuda_ms(torch, lambda: dequantize_int8(
               q, s, xd.shape)),
           # each input read once, each output written once
           "quantize_bound_ms": bound_ms(4 * n + n + 4 * nb, 0)[0],
           "dequantize_bound_ms": bound_ms(n + 4 * nb + 4 * n, 0)[0]}
    comp = ErrorFeedbackInt8(COMPRESS_BLOCK)
    state = comp.init({"w": xd})
    row["ef_compress_ms"] = cuda_ms(torch, lambda: comp.compress(
        {"w": xd}, state))
    row["ef_compress_bound_ms"] = bound_ms(4 * n + 4 * n + 4 * n + 4 * n,
                                           0)[0]
    del xd, q, s, state
    torch.cuda.empty_cache()
    log(f"[compress quantizer] {COMPRESS_LEAF} f32, block "
        f"{COMPRESS_BLOCK}: card vs host bit-equal {same}; max |x - "
        f"dequantized| / max |x| {rel:.3e}; ms (bound): quantize "
        f"{row['quantize_ms']:.4f} ({row['quantize_bound_ms']:.4f}), "
        f"dequantize {row['dequantize_ms']:.4f} "
        f"({row['dequantize_bound_ms']:.4f}), ErrorFeedbackInt8.compress "
        f"{row['ef_compress_ms']:.4f} ({row['ef_compress_bound_ms']:.4f})")
    assert all(same.values()), same
    assert rel <= 1 / 127, rel
    return row


def compress_resume(torch):
    """(c) Muon with ``--compress-grads`` at the published widths and
    COMPRESS_LAYERS deep: run A 4 steps saving at 2 (its step-4
    checkpoint set aside), run B resumed from 2: B's losses A's steps
    2-3 bit for bit, 0 mismatches, every leaf of B's step 4 A's crc, the
    manifest holding the EF leaves."""
    import gc
    import shutil
    import tempfile

    from repro_torch.launch.train import build_argparser, train
    root = tempfile.mkdtemp(prefix="chip_smoke_compress_")
    try:
        log(f"[compress resume] free space at {root}: "
            f"{shutil.disk_usage(root).free} bytes")
        d = os.path.join(root, "ckpt")
        argv = ["--arch", "stablelm-1.6b", "--full", "--device", DEVICE,
                "--layers", str(COMPRESS_LAYERS), "--optimizer", "muon",
                "--compress-grads", "--steps", "4", "--ckpt-dir", d,
                "--ckpt-every", "2", "--ckpt-keep", "2",
                "--global-batch", "8", "--seq-len", "256",
                "--loss-chunk", "256", "--seed", "0", "--log-every", "1"]
        runs = {}
        for name in ("A", "B"):
            runs[name] = train(build_argparser().parse_args(argv))
            gc.collect()
            torch.cuda.empty_cache()
            if name == "A":
                os.rename(os.path.join(d, "step_00000004"),
                          os.path.join(root, "A_step_00000004"))
        a, b = runs["A"], runs["B"]
        assert (a["layers"], a["d_model"], a["d_ff"], a["vocab"]) == \
            (COMPRESS_LAYERS, 2048, 5632, 100352), a
        assert not a["resumed"] and b["resumed"] and b["start_step"] == 2
        vr = b["restore_verified"]
        bit_equal = b["losses"] == a["losses"][2:]
        log(f"[compress resume] A's losses {a['losses']}, B's "
            f"{b['losses']}: bit-equal {bit_equal}; restore verified "
            f"{vr['checked']} leaves, {len(vr['mismatches'])} mismatches")
        assert bit_equal and vr["mismatches"] == [], (a["losses"],
                                                      b["losses"], vr)
        with open(os.path.join(root, "A_step_00000004",
                               "manifest.json")) as f:
            ma = json.load(f)["leaves"]
        with open(os.path.join(d, "step_00000004", "manifest.json")) as f:
            mb = json.load(f)["leaves"]
        ef = sorted(k for k in mb if k.startswith("ef"))
        params = sorted(k for k in mb if k.startswith("params"))
        differ = [k for k in ma if ma[k]["crc"] != mb.get(k, {}).get("crc")]
        log(f"[compress resume] step 4, B against A: {len(mb)} leaves "
            f"({len(ef)} ef, {len(params)} params), crc differs in "
            f"{differ}")
        assert sorted(ma) == sorted(mb) and differ == [], differ
        assert ef and len(ef) == len(params), (ef, params)
        nbytes = b["ckpt_bytes"]
        times = {"async_snapshot_s": a["ckpt_s"]["snapshot_s"],
                 "blocking_save_s": [a["ckpt_s"]["save_s"],
                                     b["ckpt_s"]["save_s"]],
                 "restore_s": b["ckpt_s"]["restore_s"],
                 "verify_s": b["ckpt_s"]["verify_s"]}
        log(f"[compress resume] checkpoint {nbytes} bytes "
            f"({sum(mb[k]['bytes'] for k in ef)} of them EF); "
            f"{json.dumps(times)}")
        return {"layers": COMPRESS_LAYERS, "ckpt_bytes": nbytes,
                "leaves": len(mb), "ef_leaves": len(ef),
                "losses_A": a["losses"], "losses_B": b["losses"],
                "compress_s_A": a["compress_s"], **times}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _compress_input(torch, kind, rank, device):
    """Rank ``rank``'s leaf in (d): an MLP matrix, or a symmetric
    2048² one ((a + aᵀ)/2, exactly symmetric)."""
    gen = torch.Generator(device=device).manual_seed(rank)
    if kind == "dense":
        return torch.randn(COMPRESS_LEAF[1:], generator=gen, device=device)
    a = torch.randn(2048, 2048, generator=gen, device=device)
    return (a + a.T) / 2


def compress_rank(mesh):
    """One rank of (d): compressed_allreduce of its own MLP matrix,
    compressed_allreduce_sym of its own symmetric leaf, and the f32
    all_reduce of the matrix; each one's words and bytes, its ms on
    rank 0 and a crc of its result."""
    import zlib

    import torch
    import torch.distributed as dist
    from repro_torch.distributed import collectives
    from repro_torch.distributed.compression import (
        compressed_allreduce, compressed_allreduce_sym)
    from repro_torch.kernels import counts
    comm, rank, dev = mesh.comm("x"), mesh.rank, mesh.device
    x = _compress_input(torch, "dense", rank, dev)
    s = _compress_input(torch, "sym", rank, dev)
    calls = {"dense": lambda: compressed_allreduce(x, comm, COMPRESS_BLOCK),
             "sym": lambda: compressed_allreduce_sym(s, comm,
                                                     COMPRESS_BLOCK),
             "all_reduce": lambda: collectives.all_reduce(x, comm)}
    counts.reset_launch_counts()
    out = {}
    for name, call in calls.items():
        collectives.reset_word_counts()
        y = call()
        torch.cuda.synchronize()
        row = {"words": collectives.word_counts(),
               "bytes": collectives.byte_counts()}
        host = y.cpu().numpy()
        row["crc"] = zlib.crc32(host.tobytes())
        if name == "sym":
            row["symmetric"] = bool(torch.equal(y, y.T))
        if rank == 0 and name != "all_reduce":
            row["y"] = host
        del y
        row["ms"] = _mesh_ms(torch, dist, call, comm)
        out[name] = row
    out["launches"] = counts.launch_counts()
    return out


def _np_quant(np, x, block):
    blocks = x.reshape(-1, block)
    scale = np.maximum(np.abs(blocks).max(axis=1, keepdims=True)
                       / np.float32(127.0), np.float32(1e-12))
    q = np.clip(np.round(blocks / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def _np_allreduce(np, xs, block):
    """The numpy oracle of compressed_allreduce for lengths that
    ``block·P`` divides: each rank's blocks quantized, stripe j summed
    over the ranks as a left fold in rank order, / P, requantized."""
    P, n = len(xs), xs[0].size
    assert n % (block * P) == 0, (n, block, P)
    qs = [_np_quant(np, x.reshape(-1), block) for x in xs]
    stripe = n // block // P
    parts = []
    for j in range(P):
        rows = slice(j * stripe, (j + 1) * stripe)
        acc = qs[0][0][rows].astype(np.float32) * qs[0][1][rows]
        for q, sc in qs[1:]:
            acc = acc + q[rows].astype(np.float32) * sc[rows]
        q2, s2 = _np_quant(np, acc / np.float32(P), block)
        parts.append(q2.astype(np.float32) * s2)
    return np.concatenate(parts).reshape(xs[0].shape)


def compress_collectives(torch, ranks):
    """(d) the compressed all-reduces on COMPRESS_RANKS gloo ranks sharing
    the card (``ranks``: run in phase 8's launch, ``gloo_rank``), each
    with its own leaf: rank 0's result bit-equal to the numpy oracle and
    within the reference test's atol of the exact mean, every rank's the
    same, the bytes a rank the byte model's exactly."""
    import numpy as np

    from repro_torch.distributed.compression import wire_bytes_per_device
    P = COMPRESS_RANKS
    assert len(ranks) == P, len(ranks)
    card = torch.cuda.get_device_name(0)
    log(f"[compress wire] gloo, host-staged, {P} ranks on one {card} "
        "(phase 8's launch)")
    n = COMPRESS_LEAF[1] * COMPRESS_LEAF[2]
    want_bytes = {
        "dense": wire_bytes_per_device(n, P, compressed=True,
                                       block=COMPRESS_BLOCK),
        "sym": wire_bytes_per_device(2048 * 2048, P, compressed=True,
                                     block=COMPRESS_BLOCK, sym_n=2048),
        "all_reduce": wire_bytes_per_device(n, P, compressed=False)}
    assert want_bytes == {"dense": 17_571_840, "sym": 3_196_440,
                          "all_reduce": 69_206_016}, want_bytes
    xs = {k: [_compress_input(torch, k, r, DEVICE).cpu().numpy()
              for r in range(P)] for k in ("dense", "sym")}
    tril = np.tril_indices(2048)
    packed = _np_allreduce(np, [x[tril] for x in xs["sym"]], COMPRESS_BLOCK)
    sym = np.zeros((2048, 2048), np.float32)
    sym[tril] = packed
    oracle = {"dense": _np_allreduce(np, xs["dense"], COMPRESS_BLOCK),
              "sym": np.where(np.eye(2048, dtype=bool), sym, sym + sym.T)}
    rows = {}
    for name in ("dense", "sym", "all_reduce"):
        per_rank = [r[name] for r in ranks]
        got_bytes = [sum(r["bytes"].values()) for r in per_rank]
        row = {"bytes_a_rank": got_bytes, "byte_model": want_bytes[name],
               "words_a_rank": per_rank[0]["words"],
               "bytes_by_kind": per_rank[0]["bytes"],
               "ms_rank0": per_rank[0]["ms"],
               "same_on_every_rank": len({r["crc"] for r in per_rank}) == 1}
        if name != "all_reduce":
            y = per_rank[0]["y"]
            mean = sum(xs[name]) / np.float32(P)
            row["bit_equal_oracle"] = bool(np.array_equal(y, oracle[name]))
            row["err_vs_mean"] = float(np.abs(y - mean).max()
                                       / np.abs(mean).max())
            row["tol"] = 1 / 50 if name == "dense" else 1 / 30
        if name == "sym":
            row["symmetric"] = all(r["symmetric"] for r in per_rank)
        rows[name] = row
        log(f"[compress wire] {name}: bytes a rank {got_bytes} (model "
            f"{want_bytes[name]:.0f}) {row['bytes_by_kind']}, words "
            f"{row['words_a_rank']}; {row['ms_rank0']:.3f} ms on rank 0; "
            + ", ".join(f"{k} {row[k]}" for k in
                        ("bit_equal_oracle", "err_vs_mean", "tol",
                         "symmetric", "same_on_every_rank") if k in row))
        assert got_bytes == [want_bytes[name]] * P, (name, got_bytes)
        assert row["same_on_every_rank"], name
        if name != "all_reduce":
            assert row["bit_equal_oracle"], name
            assert row["err_vs_mean"] <= row["tol"], row
        if name == "sym":
            assert row["symmetric"], row
    launched = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launched[k] = launched.get(k, 0) + v
    log(f"[compress wire] kernel launches on every rank {launched}")
    assert all(v == 0 for v in launched.values()), launched
    return dict(rows, ranks=P)


def compress_phase(torch, train_out, wire_ranks):
    """Phase 12: (a) compressed Muon at full width, (b) the quantizer
    card vs host, (d) the compressed all-reduces on gloo ranks sharing
    the card (``wire_ranks``, from phase 8's launch); (c),
    :func:`compress_resume`, runs beside phase 14 (``run_phases``)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train, launches = compress_train(torch, train_out["muon"])
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    quant = compress_quantizer(torch)
    t2 = time.perf_counter()
    wire = compress_collectives(torch, wire_ranks)
    t3 = time.perf_counter()
    seconds = {"train_s": t1 - t0, "quantizer_s": t2 - t1,
               "wire_s": t3 - t2}
    log(f"[compress] phase seconds {json.dumps(seconds)}")
    return {"train": train, "quantizer": quant, "wire": wire,
            **seconds}, launches


# --------------------------------------------------------------------------
# phase 13: train --devices N on a (data, model) mesh of gloo ranks
# --------------------------------------------------------------------------
MESHTRAIN_STEPS = RESUME_STEPS
#: losses a step against the single-device trainer's: the ranks sum
#: bf16 products and gradients in another order (on the card 1.1e-5 at
#: most; ``tests/test_torch_train_mesh.py`` holds the CPU runs to 5e-4)
MESHTRAIN_RTOL = 1e-4


def _leaves(cfg):
    """{path: whole stacked shape} of the model's parameter tree (a model
    on the meta device: shapes, no weights)."""
    import torch

    from repro_torch.models.model import Model
    return Model(cfg, torch.Generator(),
                 torch.device("meta")).stacked_shapes()


def _ns_closed_form(cfg, data, P, steps=5):
    """A rank's Muon words a step on a (data, P) mesh, by kind, from the
    shapes alone, and the path each matrix leaf takes: the 1D schedule
    where the split is on the long side and Thm 9 case 1 holds (a packed
    reduce-scatter and all-gather of the short side's padded triangle a
    NS step, one all-reduce of the norms), else one gather of the block
    ((P - 1) blocks); a replicated leaf moves nothing."""
    from repro_torch.core.dispatch import choose_algorithm
    from repro_torch.core.packing import tril_size
    from repro_torch.models.sharding import param_specs
    shapes = _leaves(cfg)
    specs = param_specs(cfg, shapes, {"data": data, "model": P})
    total, paths = {}, {}
    for k, shape in shapes.items():
        if len(shape) < 2 or min(shape[-2:]) < 8:
            continue                               # signSGD, no NS
        spec = specs[k]
        if P == 1 or all(a is None for a in spec):
            paths["/".join(k)] = "replicated chain"
            continue
        rows, cols = shape[-2:]
        lead = math.prod(shape[:-2])
        m, n = min(rows, cols), max(rows, cols)
        long_split = (spec[-1] is not None and rows <= cols) or \
            (spec[-2] is not None and rows >= cols)
        if long_split and choose_algorithm(m, n, P, m=1).case == 1:
            lp = lead * (-(-tril_size(m) // P) * P)
            words = {"reduce_scatter": steps * (lp * (P - 1) // P),
                     "all_gather": steps * (lp // P * (P - 1)),
                     "all_reduce": 2 * lead * (P - 1) // P}
            paths["/".join(k)] = "1d"
        else:
            words = {"all_gather": math.prod(shape) // P * (P - 1)}
            paths["/".join(k)] = "gather"
        for kind, w in words.items():
            total[kind] = total.get(kind, 0) + w
    return total, paths


def _mesh_train_args(devices, max_model, layers, arch):
    """The flags of ``train --devices N`` (gloo ranks sharing this card)
    on phase 7's traffic with ``muon-syrk`` at ``layers`` layers."""
    from repro_torch.launch.train import build_argparser
    return build_argparser().parse_args(
        _train_argv("muon-syrk", MESHTRAIN_STEPS, layers, arch) + [
            "--device", DEVICE, "--devices", str(devices),
            "--max-model", str(max_model)])


def mesh_trains_rank(mesh_x, flags_list):
    """One rank of the launch that phases 13 and 16 share (one process
    start for both): ``launch.train.train_rank``, what ``train --devices
    N`` runs on each rank, for each flag set in turn, with this rank's
    plain sLSTM scans guarded."""
    import gc

    import torch
    from repro_torch.launch.train import train_rank
    guard_plain_scans()
    out = []
    for flags in flags_list:
        out.append(train_rank(mesh_x, flags))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_trains(torch):
    """Phase 13's stablelm run on (data 2, model 2), phase 16's xlstm
    run on (data 1, model 4) and phase 21's gemma2 run on (data 2,
    model 2) with ``fsdp_params``, in one launch of 4 gloo ranks
    (``mesh_trains_rank``): {arch: (its args, the flags launched, every
    rank's result)}, and the launch's seconds."""
    import gc

    from repro_torch.distributed.launch import run_ranks
    gc.collect()
    torch.cuda.empty_cache()
    make = {"stablelm-1.6b": lambda: _mesh_train_args(
                4, 2, RESUME_LAYERS, "stablelm-1.6b"),
            "xlstm-350m": lambda: _mesh_train_args(
                XLSTM_MESH_DEVICES, XLSTM_MESH_MAX_MODEL, XLSTM_MESH_LAYERS,
                "xlstm-350m"),
            DENSEMESH_ARCH: _densemesh_args}
    runs = {arch: args() for arch, args in make.items()}
    flags = [dict(vars(a)) for a in runs.values()]
    t0 = time.perf_counter()
    every = run_ranks("chip_smoke:mesh_trains_rank", 4, backend="gloo",
                      device=DEVICE, paths=[ROOT], timeout=3000,
                      kwargs={"flags_list": flags})
    wall = time.perf_counter() - t0
    log(f"[meshtrain] one launch of 4 gloo ranks for {', '.join(runs)}: "
        f"{wall:.1f} s (process start included)")
    return {arch: (args, flags[i], [r[i] for r in every])
            for i, (arch, args) in enumerate(runs.items())}, wall


def run_mesh_train(torch, run, wall):
    """``train(args)`` of a ``mesh_trains`` run: the launcher's own
    summary of the ranks' results, ``wall`` the shared launch's
    seconds."""
    from repro_torch.launch import train as ttrain
    args, flags, ranks = run
    real = ttrain.run_ranks

    def launched(target, world, **kw):
        # what train() would launch is what was launched
        assert target == "repro_torch.launch.train:train_rank", target
        assert world == len(ranks) and kw["kwargs"]["flags"] == flags
        return ranks
    ttrain.run_ranks = launched
    try:
        out = ttrain.train(args)
    finally:
        ttrain.run_ranks = real
    out["wall_s"] = wall
    return out


def _n_slstm(cfg) -> int:
    return sum(cfg.pattern[i % cfg.period].mixer == "slstm"
               for i in range(cfg.n_layers))


def meshtrain_check(tag, out, want, cfg, data, P):
    """Every rank's losses identical and within ``MESHTRAIN_RTOL`` of
    ``want`` a step, the optimizer's words a rank a step the closed
    form, every rank's launches a step the paths' count: the gathered
    stacks' NS chain (n1 >= 256: the kernels) ``rank_update`` 5 and
    ``sym_stream`` 10 a stack, the 1D leaves none; the sLSTM layers'
    stash forward twice (the remat) and backward once, on the rank's own
    channels; prints the split, words, bytes and peaks."""
    assert out["mesh"] == {"data": data, "model": P}, out["mesh"]
    ranks = out["ranks"]
    losses = out["losses"]
    assert len(losses) == MESHTRAIN_STEPS and all(map(math.isfinite,
                                                      losses)), losses
    for i, r in enumerate(ranks):
        assert r["losses"] == losses, (f"rank {i} disagrees", r["losses"],
                                       losses)
    log(f"{tag} {cfg.name} {cfg.n_layers} layers, mesh (data {data}, model "
        f"{P}), {len(ranks)} gloo ranks on one card, muon-syrk; losses "
        f"{losses} vs the single-device trainer's {want}")
    for i, (got, ref) in enumerate(zip(losses, want)):
        rel = abs(got - ref) / abs(ref)
        log(f"{tag} step {i}: rel {rel:.3e} (<= {MESHTRAIN_RTOL:.0e})")
        assert rel <= MESHTRAIN_RTOL, (i, got, ref)
    predicted, paths = _ns_closed_form(cfg, data, P)
    shapes = _leaves(cfg)
    stacks = sum(v == "gather" and min(shapes[tuple(k.split("/"))][-2:])
                 >= 256 for k, v in paths.items())
    steps, n_slstm = MESHTRAIN_STEPS, _n_slstm(cfg)
    want_launches = {"rank_update": steps * 5 * stacks,
                     "sym_stream": steps * 10 * stacks,
                     "slstm_scan": steps * 2 * n_slstm,
                     "slstm_scan_bwd": steps * n_slstm}
    log(f"{tag} Muon path per matrix leaf: {json.dumps(paths)}")
    log(f"{tag} Muon words a rank a step, closed form: {predicted}")
    log(f"{tag} launches a rank over {steps} steps, from the paths "
        f"({stacks} gathered stacks, {n_slstm} sLSTM layers): "
        f"{want_launches}")
    for i, r in enumerate(ranks):
        for s, step in enumerate(r["words"]):
            assert step["opt"] == predicted, (i, s, step["opt"], predicted)
    r0 = ranks[0]
    for s, (t, sp) in enumerate(zip(r0["step_s"], r0["split_s"])):
        log(f"{tag} step {s}{' (warm-up)' if s == 0 else ''}: {t:.4f} s = "
            f"loss+backward {sp['loss_backward_s']:.4f} + reduce "
            f"{sp['reduce_s']:.4f} + clip {sp['clip_s']:.4f} + optimizer "
            f"{sp['opt_s']:.4f} (rank 0)")
    for phase in ("loss_backward", "reduce", "clip", "opt"):
        log(f"{tag} rank 0 a step, {phase}: words "
            f"{r0['words'][-1][phase]}, bytes {r0['bytes'][-1][phase]}")
    for i, r in enumerate(ranks):
        log(f"{tag} rank {i}: s per step {r['step_s']}; words the last "
            f"step by phase {r['words'][-1]}, bytes {r['bytes'][-1]}; "
            f"words over the run {_kinds(r['words'])}, bytes "
            f"{_kinds(r['bytes'])}; peak memory "
            f"{r['peak_memory_bytes'] / 2**30:.2f} GiB; launches "
            f"{r['kernel_launches']}")
        assert r["kernel_launches"] == want_launches, (
            i, r["kernel_launches"], want_launches)
    launches = {}
    for r in ranks:
        for k, v in r["kernel_launches"].items():
            launches[k] = launches.get(k, 0) + v
    log(f"{tag} wall {out['wall_s']:.1f} s (the launch phases 13 and 16 "
        "share: rank processes' start, init and build included)")
    return {"mesh": out["mesh"], "losses": losses, "want": want,
            "paths": paths, "ns_words": predicted,
            "launches_a_rank": want_launches,
            "step_s": [r["step_s"] for r in ranks],
            "split_s": r0["split_s"],
            "words": _kinds(r0["words"]), "bytes": _kinds(r0["bytes"]),
            "peak_memory_bytes": [r["peak_memory_bytes"] for r in ranks],
            "launches": [r["kernel_launches"] for r in ranks],
            "wall_s": out["wall_s"]}, launches


def _kinds(per_step):
    total = {}
    for phases in per_step:
        for kinds in phases.values():
            for k, v in kinds.items():
                total[k] = total.get(k, 0) + v
    return total


def meshtrain_phase(torch, single):
    """Phase 13: stablelm-1.6b at its published widths, cut to
    ``RESUME_LAYERS`` layers, on (data 2, model 2), held to the
    uninterrupted single-device run at that depth (phase 11's).  Its
    (data 1, model 4) run is phase 14's phase 1: the same path at that
    depth, with the Grams and a checkpoint.  The launch also runs phase
    16's xlstm and phase 21's gemma2 mesh training (``mesh_trains``),
    returned for them."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("stablelm-1.6b"),
                              n_layers=RESUME_LAYERS)
    t0 = time.perf_counter()
    runs, wall = mesh_trains(torch)
    b = run_mesh_train(torch, runs["stablelm-1.6b"], wall)
    rb, launches = meshtrain_check("[meshtrain b]", b,
                                   single["losses"][:MESHTRAIN_STEPS],
                                   cfg, 2, 2)
    seconds = {"b_s": time.perf_counter() - t0, "launch_s": wall}
    log(f"[meshtrain] phase seconds {json.dumps(seconds)}")
    return {"b": rb, **seconds}, launches, runs["xlstm-350m"], \
        runs[DENSEMESH_ARCH]


# --------------------------------------------------------------------------
# phase 14: elastic kill -> resume on another device count
# --------------------------------------------------------------------------
ELASTIC_DEVICES, ELASTIC_AFTER, ELASTIC_MAX_MODEL = 4, 2, 4


def _gram_rs_words(cfg, P):
    """A rank's words a step of the Grams' reduce-scatter on (1, P):
    (1 - 1/P)·Lp for embed and for unembed, each split over 'model'
    along its width, Lp = n(n+1)/2 padded to a multiple of P."""
    from repro_torch.core.packing import padded_tril_size
    lp = padded_tril_size(cfg.d_model, P)
    return 2 * (lp * (P - 1) // P)


def elastic_phase(torch, single):
    """Phase 14: ``run_recovery`` of ``muon-syrk`` with ``--track-gram``
    at stablelm-1.6b's published widths and ``RESUME_LAYERS`` layers,
    phase 7's traffic: phase 1 on ``ELASTIC_DEVICES`` gloo ranks sharing
    the card, (data 1, model 4), killed by ``train:step`` before step
    ``RESUME_KILL`` after its step-2 checkpoint committed; phase 2
    resumed on ``ELASTIC_AFTER`` ranks, (data 1, model 2).  0
    mismatches; every loss within ``MESHTRAIN_RTOL`` of the single-device
    run's; the Grams of the last checkpoint within ``GRAM_TOL`` of its;
    every rank's optimizer words a step the NS closed form plus the
    Grams' reduce-scatter; the symmetric kernels launched on every rank
    of both phases, ``rank_update`` once a NS step a gathered stack plus
    once a step for each Gram."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.distributed import checkpoint_bytes
    from repro_torch.launch.recovery import run_recovery
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("stablelm-1.6b"),
                              n_layers=RESUME_LAYERS)
    root = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        d = os.path.join(root, "ckpt")
        t0 = time.perf_counter()
        out = run_recovery(
            d, devices=ELASTIC_DEVICES, devices_after=ELASTIC_AFTER,
            max_model=ELASTIC_MAX_MODEL, steps=RESUME_STEPS,
            kill_step=RESUME_KILL, ckpt_every=RESUME_EVERY, global_batch=8,
            seq_len=256, layers=RESUME_LAYERS, optimizer="muon-syrk",
            track_gram=True, timeout=600,
            extra_args=["--full", "--loss-chunk", "256"])
        total = time.perf_counter() - t0
        grams = _packed_grams(d)
        nbytes = checkpoint_bytes(d)["total"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    p1, p2 = out["phases"]
    summary = {k: v for k, v in out.items() if k not in ("phases", "final")}
    log(f"[elastic] {json.dumps(summary)}; phase 2's mesh "
        f"{out['final']['mesh']}")
    assert out["killed"] and out["kill_step"] == RESUME_KILL, out
    assert out["resumed_step"] == RESUME_EVERY and out["mismatches"] == 0
    assert out["completed"] and out["final"]["resumed"], out
    assert out["final"]["mesh"] == {"data": 1, "model": ELASTIC_AFTER}
    for p in (p1, p2):
        assert all(r == p["losses"] for r in p["ranks"]["losses"]), \
            p["ranks"]["losses"]
    got, want = p1["losses"] + p2["losses"], single["losses"]
    log(f"[elastic] losses {got} vs the single-device run's {want}")
    assert len(got) == len(want) == RESUME_STEPS, (got, want)
    for i, (x, y) in enumerate(zip(got, want)):
        rel = abs(x - y) / abs(y)
        log(f"[elastic] step {i}: rel {rel:.3e} (<= {MESHTRAIN_RTOL:.0e})")
        assert rel <= MESHTRAIN_RTOL, (i, x, y)
    assert sorted(grams) == sorted(single["grams"]), sorted(grams)
    gram_err = max(float((grams[k] - g).abs().max() / g.abs().max())
                   for k, g in single["grams"].items())
    log(f"[elastic] packed Grams after phase 2 (gathered, bf16 words) vs "
        f"the single-device run's: largest relative difference {gram_err} "
        f"(tolerance {GRAM_TOL})")
    assert gram_err <= GRAM_TOL, gram_err
    launches, words, gathered = {}, {}, {}
    for p, P, steps in ((p1, ELASTIC_MAX_MODEL, RESUME_KILL),
                        (p2, ELASTIC_AFTER, RESUME_STEPS - RESUME_EVERY)):
        ns, paths = _ns_closed_form(cfg, 1, P)
        gram = _gram_rs_words(cfg, P)
        want_opt = dict(ns, reduce_scatter=ns.get("reduce_scatter", 0)
                        + gram)
        log(f"[elastic] (1, {P}): Muon paths {json.dumps(paths)}; words a "
            f"rank a step: NS {ns}, the Grams' reduce-scatter {gram}")
        log(f"[elastic] (1, {P}) rank 0: words a step by phase "
            f"{p['words'][-1]}; checkpoint words over the phase, by rank "
            f"{p['ranks']['ckpt_words']}")
        for s, step in enumerate(p["words"]):
            assert step["opt"] == want_opt, (P, s, step["opt"], want_opt)
        words[f"1x{P}"] = {"opt": p["words"][-1]["opt"],
                           "gram_reduce_scatter": gram,
                           "ckpt": p["ranks"]["ckpt_words"]}
        gathered[P] = (steps, sum(v == "gather" for v in paths.values()))
    for p, P in ((p1, ELASTIC_MAX_MODEL), (p2, ELASTIC_AFTER)):
        steps, stacks = gathered[P]
        for r, n in enumerate(p["ranks"]["kernel_launches"]):
            log(f"[elastic] (1, {P}) rank {r}: launches {n}")
            assert n["rank_update"] == steps * (5 * stacks + 2), (P, r, n)
            assert n["sym_stream"] == steps * 10 * stacks, (P, r, n)
            assert n["slstm_scan"] == 0, n
            for k, v in n.items():
                launches[k] = launches.get(k, 0) + v
    times = {"phase1_s": p1["s"], "phase2_s": p2["s"], "total_s": total,
             "restore_s": p2["ckpt_s"]["restore_s"],
             "verify_s": p2["ckpt_s"]["verify_s"],
             "save_s": p2["ckpt_s"].get("save_s"),
             "phase1_snapshot_s": p1["ckpt_s"]["snapshot_s"]}
    log(f"[elastic] checkpoint {nbytes} bytes; {json.dumps(times)}")
    return {"layers": RESUME_LAYERS, "ckpt_bytes": nbytes,
            "verified_leaves": out["verified_leaves"],
            "losses_phase1": p1["losses"], "losses_phase2": p2["losses"],
            "single_losses": want, "gram_rel_err": gram_err,
            "words": words, **times}, launches


# --------------------------------------------------------------------------
# phase 15: train xlstm-350m at full width: the sLSTM's stash forward and
# its backward kernel
# --------------------------------------------------------------------------
#: ``slstm_scan_bwd`` against autograd of the plain version on the same
#: inputs: |got − want| ≤ tol·(1 + |want|) for the f32 results; d(pre) in
#: bf16 may also round the other way from a nearly equal f32 value, one
#: bf16 ulp: + 2^-7·|want| there
SLSTM_GRAD_TOL = 1e-4
#: f32 operations per (b, t, channel) step of the backward (adds,
#: multiplies, divisions, compares; the three exp and the tanh once each)
SLSTM_BWD_OPS_PER_STEP = 45
#: (B, S, d, gate dtype, case, label): the first is the train path's
#: (8 x 256 tokens, d 1024, bf16 quads, the state from zero, no gradient
#: of the final state).  "ties": f == i at t = 0 on every channel (m0 =
#: 0, so m_0 = max(f, i) is a tie), with gradients of the final state:
#: y, c and n do not depend on the stabiliser m, so only m1's gradient
#: reaches a tie; "n1": n_t = 1 exactly on the first 6 steps; "warm": a
#: carried state and gradients of the final state
SLSTM_BWD_CASES = (
    (8, 256, 1024, "bf16", "cold", "the train path"),
    (8, 256, 1024, "f32", "cold", "f32 gates"),
    (8, 256, 256, "bf16", "cold", "a (1, 4) mesh rank's channels"),
    (8, 256, 1024, "bf16", "ties", "f == i at t = 0"),
    (8, 256, 1024, "f32", "ties", "f == i at t = 0"),
    (2, 40, 256, "f32", "n1", "n_t = 1 on the first steps"),
    (2, 99, 200, "bf16", "warm", "S not a multiple of 8, ragged d, "
     "final-state gradients"),
)
XLSTM_MUON_STEPS, XLSTM_ADAMW_STEPS = 4, 2


def _scan_autograd(torch, pre, state, gy, fin, tie_to_a=False):
    """autograd of the plain scan on the f32 upcast of ``pre``: (d(pre)
    in pre's dtype, dc0, dn0, dm0).  ``tie_to_a``: a stabiliser that
    gives a tie's gradient wholly to f + m (``torch.where(a >= i, ...)``),
    the convention the kernel must not follow."""
    from repro_torch.kernels import slstm
    leaf = pre.detach().clone().requires_grad_(True)
    st = [x.detach().clone().requires_grad_(True) for x in state]
    if tie_to_a:
        q = leaf.float()
        c, n, m = st
        ys = []
        for t in range(q.shape[1]):
            z, i, f, o = q[:, t].unbind(-1)
            a = f + m
            m_new = torch.where(a >= i, a, i)
            e_i, e_f = torch.exp(i - m_new), torch.exp(a - m_new)
            c = e_f * c + e_i * torch.tanh(z)
            n = e_f * n + e_i
            ys.append(torch.sigmoid(o) * c / torch.maximum(
                n, n.new_ones(())))
            m = m_new
        y = torch.stack(ys, dim=1)
    else:
        y, c, n, m = slstm._slstm_scan_plain(*leaf.float().unbind(-1), *st)
    loss = (y * gy).sum()
    if fin is not None:
        loss = loss + sum((x * g).sum() for x, g in zip((c, n, m), fin))
    return torch.autograd.grad(loss, [leaf, *st])


def _grad_errs(torch, got, want):
    """(max |Δ| over the four results, whether each is within
    ``SLSTM_GRAD_TOL`` — with one more bf16 rounding for a bf16 d(pre) —
    and finite)."""
    worst, ok = 0.0, True
    for g, w in zip(got, want):
        g, wf = g.float(), w.float()
        diff = (g - wf).abs()
        lim = SLSTM_GRAD_TOL * (1 + wf.abs())
        if w.dtype == torch.bfloat16:
            lim = lim + 2.0 ** -7 * wf.abs()
        ok = ok and bool((diff <= lim).all()) and \
            bool(torch.isfinite(g).all())
        worst = max(worst, float(diff.max()))
    return worst, ok


def slstm_bwd_cases(torch, cases):
    """The stash forward and ``slstm_scan_bwd`` on the card
    (``SLSTM_BWD_CASES``): the stash variant's y and final state bit for
    bit today's launch, its stash within the state tolerance of the plain
    version's; the backward against autograd of the plain version within
    ``SLSTM_GRAD_TOL`` (and, in a tie case, missing it against a
    stabiliser that gives the tie wholly to f + m); the train path's case,
    the f32 one and a (1, 4) mesh rank's (d = 256) timed (back to back,
    in a CUDA graph, the plain versions) beside their byte bounds."""
    from repro_torch.kernels import native, slstm
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(17)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    scale = torch.tensor([1.0, 2.5, 2.5, 1.0], device=dev)
    usage = resource_usage(str(native._lib_path("slstm_scan.cu")))
    for i, (b, s, d, dt, kind, label) in enumerate(SLSTM_BWD_CASES):
        pre = randn(b, s, d, 4) * scale
        if kind == "ties":
            pre[:, 0, :, 2] = pre[:, 0, :, 1]
        if kind == "n1":
            pre[:, :6, :, 1] = -30.0
            pre[:, :6, :, 2] = pre[:, :6, :, 2].abs()
        pre = pre.to(dtypes[dt])
        if kind == "warm":
            state = (randn(b, d), 1.0 + randn(b, d).abs(), randn(b, d))
        else:
            state = (torch.zeros(b, d, device=dev),
                     torch.ones(b, d, device=dev),
                     torch.zeros(b, d, device=dev))
        fin = [randn(b, d) for _ in range(3)] \
            if kind in ("warm", "ties") else None
        gy = randn(b, s, d)
        gates = pre.unbind(-1)
        name = f"({b}, {s}, {d}) {dt} {kind}: {label}"
        today = slstm.slstm_scan(*gates, *state)
        y, c1, n1, m1, stash = slstm.slstm_scan(*gates, *state, stash=True)
        same = all(torch.equal(a, x) for a, x in zip(today, (y, c1, n1,
                                                               m1)))
        log(f"[xlstm-train] slstm_scan {name}: stash variant's y and state "
            f"bit-equal to today's launch: {same}")
        if not same:
            raise SystemExit("the stash variant of slstm_scan changed y")
        want_stash = slstm._slstm_scan_plain(
            *[g.float() for g in gates], *state, stash=True)[4]
        stash_err = slstm_close(torch, f"slstm_scan stash {name}", stash,
                                want_stash, SLSTM_STATE_TOL)
        if kind == "n1":
            assert bool((stash[1][:, :6] == 1.0).all())
        got = slstm.slstm_scan_bwd(pre, stash, *state, gy,
                                   *(fin or (None,) * 3))
        want = _scan_autograd(torch, pre, state, gy, fin)
        err, ok = _grad_errs(torch, got, want)
        log(f"[xlstm-train] slstm_scan_bwd {name}: max_abs_err {err:.3e} "
            f"(<= {SLSTM_GRAD_TOL:.0e}·(1+|x|), + 2^-7·|x| in bf16) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"slstm_scan_bwd {name} disagrees with "
                             "autograd of its plain version")
        if kind == "ties":
            _, missed = _grad_errs(torch, got, _scan_autograd(
                torch, pre, state, gy, fin, tie_to_a=True))
            log(f"[xlstm-train]   against a tie given wholly to f + m: "
                f"within the tolerance {missed} (must be False)")
            if missed:
                raise SystemExit("the tie case does not tell the "
                                 "conventions apart")
        row = {"case": name, "main": i == 0, "dtype": dt,
               "max_abs_err": err, "library_ms": None}
        if i < 3:
            steps, e = b * s * d, pre.element_size()
            f32_gates = [g.float() for g in gates]

            def bwd():
                return slstm.slstm_scan_bwd(pre, stash, *state, gy)

            def bwd_plain():
                return slstm._slstm_scan_bwd_plain(pre, stash, *state, gy)

            def fwd():
                return slstm.slstm_scan(*gates, *state, stash=True)

            def fwd_plain():
                return slstm._slstm_scan_plain(*f32_gates, *state,
                                               stash=True)
            row.update(ms=cuda_ms(torch, bwd), device_ms=graph_ms(
                torch, bwd), plain_ms=cuda_ms(torch, bwd_plain, warmup=1))
            # a step: the quad read and written, 3 stashed words, gy
            nbytes = steps * (2 * 4 * e + 3 * 4 + 4) + 6 * b * d * 4
            row["bound_ms"], row["bound_by"] = bound_ms(
                nbytes, SLSTM_BWD_OPS_PER_STEP * steps, tensor=False)
            row["ffma_bound_ms"] = row["bound_ms"]
            fwd = {"case": f"{name}, stash (training's forward)",
                   "main": False, "dtype": dt, "layout": "quad",
                   "max_abs_err": stash_err, "library_ms": None,
                   "ms": cuda_ms(torch, fwd),
                   "device_ms": graph_ms(torch, fwd),
                   "plain_ms": cuda_ms(torch, fwd_plain, warmup=1)}
            # a step: the quad, y and 3 stashed words
            fb = steps * (4 * e + 4 + 3 * 4) + 6 * b * d * 4
            fwd["bound_ms"], fwd["bound_by"] = bound_ms(
                fb, SLSTM_OPS_PER_STEP * steps, tensor=False)
            fwd["ffma_bound_ms"] = fwd["bound_ms"]
            for tag, r in (("slstm_scan stash", fwd),
                           ("slstm_scan_bwd", row)):
                log(f"[xlstm-train]   {tag}: ms {r['ms']:.4f}  device "
                    f"{r['device_ms']:.4f}  plain {r['plain_ms']:.4f}  "
                    f"library none  bound {r['bound_ms']:.4f} "
                    f"({r['bound_by']})")
            cases["slstm_scan"].append(fwd)
        cases["slstm_scan_bwd"].append(row)
        del pre, stash, got, want
    for k, (regs, smem, local) in usage.items():
        if "slstm_bwd_kernel" in k:
            log(f"[build] {k}: {regs} registers, {smem} B static smem, "
                f"{local} B local (spills)")
    torch.cuda.empty_cache()


#: the plain scans before ``guard_plain_scans`` wrapped them (phase 20
#: times the plain version on the card beside the kernel)
UNGUARDED = {}


def guard_plain_scans() -> None:
    """Make the plain sLSTM scans (forward and backward) of this process
    raise when a CUDA tensor reaches them (the wrappers never fall back:
    this shows it on the path)."""
    from repro_torch.kernels import slstm
    UNGUARDED.setdefault("scan", slstm._slstm_scan_plain)
    UNGUARDED.setdefault("bwd", slstm._slstm_scan_bwd_plain)

    def guard(fn):
        def on_host_only(*args, **kw):
            assert not args[0].is_cuda, "a CUDA tensor reached a plain scan"
            return fn(*args, **kw)
        return on_host_only
    slstm._slstm_scan_plain = guard(slstm._slstm_scan_plain)
    slstm._slstm_scan_bwd_plain = guard(slstm._slstm_scan_bwd_plain)


def xlstm_train_phase(torch, cases):
    """Phase 15: the kernel cases, then xlstm-350m at its published
    widths (24 layers, 6 of them sLSTM) on phase 7's traffic,
    ``muon-syrk`` then AdamW: finite losses, step 0's the same under
    both (init, batch and loss precede any update); each step's sLSTM
    forward on the stash kernel (the per-period remat runs it twice) and
    its backward on ``slstm_scan_bwd``, never a plain version on the
    card; Muon's NS on the symmetric kernels."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import slstm
    slstm_bwd_cases(torch, cases)
    cfg = get_config("xlstm-350m")
    n_slstm = _n_slstm(cfg)
    plain, bwd_plain = slstm._slstm_scan_plain, slstm._slstm_scan_bwd_plain
    out, launches = {}, {}
    guard_plain_scans()
    try:
        for opt, steps in (("muon-syrk", XLSTM_MUON_STEPS),
                           ("adamw", XLSTM_ADAMW_STEPS)):
            torch.cuda.empty_cache()
            out[opt], launches[opt] = run_train(torch, opt, steps,
                                                arch="xlstm-350m")
            want = (2 * n_slstm * steps, n_slstm * steps)
            log(f"[train {opt}] slstm_scan (stash) / slstm_scan_bwd "
                f"launches {launches[opt]['slstm_scan']} / "
                f"{launches[opt]['slstm_scan_bwd']} = (2, 1) x {n_slstm} "
                f"sLSTM layers x {steps} steps")
            if opt == "adamw":
                assert (launches[opt]["slstm_scan"],
                        launches[opt]["slstm_scan_bwd"]) == want, launches
                assert launches[opt]["rank_update"] == 0 and \
                    launches[opt]["sym_stream"] == 0, launches
            else:
                assert_kernel_routes(out[opt], launches[opt],
                                     f"[train {opt}]", slstm=want)
    finally:
        slstm._slstm_scan_plain, slstm._slstm_scan_bwd_plain = \
            plain, bwd_plain
    l0 = [out[o]["losses"][0] for o in out]
    log(f"[xlstm-train] step 0 loss under muon-syrk and adamw: {l0}, "
        f"bit-equal {l0[0] == l0[1]}")
    assert l0[0] == l0[1], l0
    total = {k: sum(n[k] for n in launches.values())
             for k in launches["adamw"]}
    keep = ("losses", "step_s", "split_s", "tokens_per_s",
            "peak_memory_bytes", "kernel_launches", "params")
    torch.cuda.empty_cache()
    return {o: {k: out[o][k] for k in keep} for o in out}, total


# --------------------------------------------------------------------------
# phase 16: train xlstm-350m on a (data, model) mesh
# --------------------------------------------------------------------------
#: two periods: 6 mLSTM and 2 sLSTM layers
XLSTM_MESH_LAYERS = 8
XLSTM_MESH_DEVICES = XLSTM_MESH_MAX_MODEL = 4


def xlstm_mesh_phase(torch, run, wall):
    """Phase 16: ``train --devices 4 --max-model 4 --optimizer
    muon-syrk`` of xlstm-350m at its published widths (d_model 1024, 4
    heads, vocab 50304) cut to ``XLSTM_MESH_LAYERS`` layers, phase 7's
    traffic, on (data 1, model 4): one head and 256 sLSTM channels a
    rank, the ranks' ``train_rank`` with the plain scans guarded (``run``:
    its flags and ranks' results from phase 13's launch, ``wall`` that
    launch's seconds).  Held to the uninterrupted single-device run at
    that depth (run here, guarded too), the launches a rank from the
    paths (``meshtrain_check``)."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import slstm
    from repro_torch.launch import train as ttrain
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("xlstm-350m"),
                              n_layers=XLSTM_MESH_LAYERS)
    plain, bwd_plain = slstm._slstm_scan_plain, slstm._slstm_scan_bwd_plain
    guard_plain_scans()
    try:
        t0 = time.perf_counter()
        single = ttrain.train(ttrain.build_argparser().parse_args(
            _train_argv("muon-syrk", MESHTRAIN_STEPS, XLSTM_MESH_LAYERS,
                        "xlstm-350m") + ["--device", DEVICE]))
        t1 = time.perf_counter()
        n = _n_slstm(cfg)
        log(f"[xlstm-mesh single] {single['arch']} {single['layers']} "
            f"layers, one device: losses {single['losses']}, launches "
            f"{single['kernel_launches']}, {t1 - t0:.1f} s")
        assert_kernel_routes(single, single["kernel_launches"],
                             "[xlstm-mesh single]",
                             slstm=(2 * n * MESHTRAIN_STEPS,
                                    n * MESHTRAIN_STEPS))
        out = run_mesh_train(torch, run, wall)
    finally:
        slstm._slstm_scan_plain, slstm._slstm_scan_bwd_plain = \
            plain, bwd_plain
    res, launches = meshtrain_check("[xlstm-mesh]", out, single["losses"],
                                    cfg, 1, XLSTM_MESH_MAX_MODEL)
    seconds = {"single_s": t1 - t0, "mesh_s": time.perf_counter() - t1}
    log(f"[xlstm-mesh] phase seconds {json.dumps(seconds)}")
    return {"mesh": res, "single_launches": single["kernel_launches"],
            **seconds}, launches, single["kernel_launches"]


# --------------------------------------------------------------------------
# phase 17: serve jamba-v0.1-52b at full width, one period deep
# --------------------------------------------------------------------------
#: one period of jamba's 8-block pattern (7 Mamba, 1 attention; 4 dense,
#: 4 MoE MLPs): all 32 layers (~103 GB in bf16) do not fit the card
JAMBA_LAYERS = 8
#: card vs CPU: max |card - cpu| / max(1, max |cpu|), as the other models
JAMBA_TOL = 5e-2
#: NS factor on the kernels vs on their plain versions, relative
#: Frobenius (phase 6's NS-vs-eigh bound)
NS_TOL = 1e-3
#: the serve's warm-up: one Gram update per ladder bucket and a 1-step NS
#: (rank_update); one embedding and the 1-step NS's seed and 2 products
#: (sym_stream).  A refresh: ``NS_ITERS`` steps of 1 SYRK and 2 SYMMs,
#: and the seed.
WARMUP_LAUNCHES = {"rank_update": 5 + 1, "sym_stream": 1 + 3}


def serve_closed_form(cache_stats) -> dict:
    """The symmetric kernels' launches in a serve with the whitening
    cache (warm-up included), from its cache's counters: one Gram update
    an admit, one embedding a factor hit, ``NS_ITERS`` SYRKs and
    1 + 2·``NS_ITERS`` SYMMs a refresh; no sLSTM kernel."""
    c = cache_stats
    return {"rank_update": WARMUP_LAUNCHES["rank_update"] + c["updates"]
            + NS_ITERS * c["refreshes"],
            "sym_stream": WARMUP_LAUNCHES["sym_stream"] + c["factor_hits"]
            + (1 + 2 * NS_ITERS) * c["refreshes"],
            "slstm_scan": 0, "slstm_scan_bwd": 0}


def card_vs_cpu(torch, tag, got, want, phase="jamba"):
    """max |card - cpu| / max(1, max |cpu|) within ``JAMBA_TOL``."""
    got, want = got.float().cpu(), want.float()
    err = float((got - want).abs().max())
    rel = err / max(1.0, float(want.abs().max()))
    ok = rel <= JAMBA_TOL and bool(torch.isfinite(got).all())
    log(f"[{phase}] {tag}: max_abs_err {err:.3e} (rel {rel:.2e} <= "
        f"{JAMBA_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{phase} {tag}: the card disagrees with the CPU")
    return rel


def ns_f64(torch, packed, d, eps):
    """The coupled NS iteration of ``whitening_from_packed`` (NS_ITERS
    steps) in f64 on dense ``torch.matmul``: the oracle both routes'
    f32 factors are read against."""
    from repro_torch.core.packing import unpack_tril
    from repro_torch.optim.gram import packed_add_diag, packed_fro_norm
    p = packed_add_diag(packed.float(), d, eps).double()
    c = float(packed_fro_norm(p, d))
    m = unpack_tril(p / c, d, diag=True, symmetric=True)
    eye = torch.eye(d, dtype=torch.float64, device=m.device)
    x = eye
    for _ in range(NS_ITERS):
        t = 0.5 * (3.0 * eye - m)
        x = x @ t
        m = (t @ t) @ m
        x, m = 0.5 * (x + x.T), 0.5 * (m + m.T)
    return x / c ** 0.5


def ns_check(torch, d, phase):
    """The NS factor at ``d`` (the cache's refresh: 30 coupled NS steps)
    and one embedding with it, on the kernels and on their plain
    versions, same card inputs: a full-rank Gram of (d, 2d) f32
    features, eps 1e-3.  Phases 17 and 18 hold each served d_model so,
    since the serve itself checks only launches and finiteness.

    The factors of the two routes agree within ``NS_TOL``; the kernels'
    factor and its embedding agree with the same iteration in f64
    within ``NS_TOL`` and ``TOL_F32``; the embedding kernel agrees with
    its plain version on the same factor within ``TOL_F32``.  The plain
    route's own f32 drift from the f64 iteration, which can pass
    ``TOL_F32`` in the embedding (``tools/ns_drift.py`` measures it), is
    printed, not bounded: it is the plain route's error, not the
    kernels'."""
    from repro_torch import blas
    from repro_torch.kernels import counts
    from repro_torch.optim.gram import packed_gram, whitening_from_packed
    gen = torch.Generator(device=DEVICE).manual_seed(29)
    x = torch.randn(d, 2 * d, generator=gen, device=DEVICE)
    pooled = x[:, :64].mean(dim=1)
    before = counts.launch_counts()
    g = packed_gram(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = whitening_from_packed(g, d, eps=1e-3, method="ns", iters=NS_ITERS)
    torch.cuda.synchronize()
    ns_s = time.perf_counter() - t0
    emb = blas.symm(w, pooled[:, None])[:, 0]
    torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in counts.launch_counts().items()}
    restore = plain_symmetric_kernels(torch)
    try:
        gp = packed_gram(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wp = whitening_from_packed(gp, d, eps=1e-3, method="ns",
                                   iters=NS_ITERS)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        embp = blas.symm(wp, pooled[:, None])[:, 0]
        emb_same = blas.symm(w, pooled[:, None])[:, 0]
    finally:
        restore()
    w64 = ns_f64(torch, g, d, 1e-3)
    emb64 = (w64 @ pooled.double()[:, None])[:, 0]

    def rel_fro(a, b):
        return float((a.double() - b).norm() / b.double().norm())

    def rel_max(a, b):
        return float((a.double() - b).abs().max()) / max(
            1.0, float(b.abs().max()))
    rel, rel64, plain_rel64 = rel_fro(w, wp), rel_fro(w, w64), \
        rel_fro(wp, w64)
    err, err64 = rel_max(emb, emb_same), rel_max(emb, emb64)
    own, plain64 = rel_max(emb, embp), rel_max(embp, emb64)
    log(f"[{phase}] NS factor d={d} ({NS_ITERS} steps) kernels vs plain: "
        f"rel {rel:.3e} (<= {NS_TOL:.0e}); vs the f64 iteration: kernels "
        f"{rel64:.3e} (<= {NS_TOL:.0e}), plain {plain_rel64:.3e}; "
        f"embedding {d}^2 x ({d}, 1), same factor: max_abs_err {err:.3e} "
        f"(<= {TOL_F32:.0e}); vs f64: kernels {err64:.3e} (<= "
        f"{TOL_F32:.0e}), plain {plain64:.3e}; each route's own factor "
        f"{own:.3e}; host s {ns_s:.4f} (plain {plain_s:.4f}); launches "
        f"{launched}")
    assert launched["rank_update"] == 1 + NS_ITERS and \
        launched["sym_stream"] == 1 + 2 * NS_ITERS + 1, launched
    if not (rel <= NS_TOL and rel64 <= NS_TOL and err <= TOL_F32
            and err64 <= TOL_F32 and bool(torch.isfinite(w).all())):
        raise SystemExit(f"{phase}: the NS factor / embedding at d {d} on "
                         "the kernels disagrees with the plain versions or "
                         "the f64 iteration")
    return {"ns_rel": rel, "ns_rel_f64": rel64, "ns_plain_rel_f64":
            plain_rel64, "embedding_max_abs_err": err,
            "embedding_err_f64": err64, "embedding_plain_err_f64": plain64,
            "embedding_own_factor_err": own, "ns_s": ns_s,
            "ns_plain_s": plain_s}


def jamba_layers(torch, cfg):
    """One full-width Mamba layer (a prefill of 64 tokens: the
    sequential scan; of 128: the chunked one; then one decode step from
    the 128-token state) and one full-width MoE layer at T = 64 (the
    dropless grouped form), random bf16 weights drawn on the card and
    copied to the CPU, the same bf16 input on both."""
    import copy

    from repro_torch.models.common import BlockSpec
    from repro_torch.models.moe import MoE
    from repro_torch.models.ssm import Mamba, mamba_state_init
    dev, cpu = torch.device(DEVICE), torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(31)
    hgen = torch.Generator().manual_seed(31)
    spec = BlockSpec(mixer="mamba")
    out, secs = {}, {}
    with torch.no_grad():
        mg = Mamba(cfg, gen, dev)
        mc = copy.deepcopy(mg).to(cpu)
        x = torch.randn(1, 129, cfg.d_model, generator=hgen).to(
            torch.bfloat16)
        for s in (64, 128):
            stg = mamba_state_init(cfg, 1, dev)
            stc = mamba_state_init(cfg, 1, cpu)
            yg, _ = mg(spec, x[:, :s].to(dev), None, stg)
            t0 = time.perf_counter()
            yc, _ = mc(spec, x[:, :s], None, stc)
            secs[f"mamba_{s}_cpu_s"] = time.perf_counter() - t0
            out[f"mamba prefill {s}"] = card_vs_cpu(
                torch, f"Mamba d {cfg.d_model} prefill {s} "
                f"({'chunked' if s > 64 else 'sequential'}) y", yg, yc)
            out[f"mamba prefill {s} ssm"] = card_vs_cpu(
                torch, f"Mamba prefill {s} ssm state", stg["ssm"],
                stc["ssm"])
        yg, _ = mg(spec, x[:, 128:].to(dev), None, stg)
        yc, _ = mc(spec, x[:, 128:], None, stc)
        out["mamba decode"] = card_vs_cpu(torch, "Mamba decode step y", yg,
                                          yc)
        out["mamba decode ssm"] = card_vs_cpu(
            torch, "Mamba decode step ssm state", stg["ssm"], stc["ssm"])
        del mg, mc
        mo = MoE(cfg, gen, dev)
        moc = copy.deepcopy(mo).to(cpu)
        x = torch.randn(1, 64, cfg.d_model, generator=hgen).to(
            torch.bfloat16)
        yg = mo(x.to(dev))
        t0 = time.perf_counter()
        yc = moc(x)
        secs["moe_64_cpu_s"] = time.perf_counter() - t0
        out["moe 64"] = card_vs_cpu(
            torch, f"MoE d {cfg.d_model}, {cfg.moe.n_experts} experts "
            f"top-{cfg.moe.top_k}, T = 64 (grouped, dropless)", yg, yc)
        del mo, moc
    torch.cuda.empty_cache()
    log(f"[jamba] layer checks' CPU seconds {json.dumps(secs)}")
    return {"rel_err": out, **secs}


def jamba_phase(torch):
    """Phase 17: serve jamba-v0.1-52b at full width (d_model 4096, 16
    experts top-2, vocab 65536) cut to one period (``JAMBA_LAYERS``),
    random bf16 weights from seed 0, phase 4's traffic with the
    whitening cache: every request completed, every embedding finite,
    ``rank_update`` / ``sym_stream`` launched in their closed forms in
    admits and refreshes, no sLSTM kernel; peak memory under the card's;
    host seconds by block kind; the NS factor and an embedding at d
    4096 on the kernels against their plain versions; one Mamba and one
    MoE layer against the CPU."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"),
                              n_layers=JAMBA_LAYERS)
    seconds = {}
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out, launches = run_serve(torch, "jamba-v0.1-52b", cfg=cfg)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    seconds["serve_s"] = time.perf_counter() - t0
    c = out["cache"]
    want = serve_closed_form(c)
    log(f"[jamba] {out['layers']} layers ({cfg.pattern[0].mixer} x 7, "
        f"attn x 1; {cfg.moe.n_experts} experts top-{cfg.moe.top_k}), "
        f"d_model {out['d_model']}, vocab {out['vocab']}; launches "
        f"{launches}, closed form {want} (updates {c['updates']}, "
        f"refreshes {c['refreshes']}, factor hits {c['factor_hits']}); "
        f"peak memory {peak / 2**30:.2f} GiB of {total / 2**30:.2f}")
    assert (out["layers"], out["d_model"], out["vocab"]) == (8, 4096, 65536)
    assert (cfg.moe.n_experts, cfg.moe.top_k) == (16, 2)
    assert c["ns_fallbacks"] == 0, c
    assert launches == want, (launches, want)
    assert peak < total, (peak, total)
    out["peak_memory_bytes"] = peak
    t1 = time.perf_counter()
    out["prefill_split"] = prefill_split(torch, cfg, "[jamba]")
    t2 = time.perf_counter()
    out["ns_check"] = ns_check(torch, 4096, "jamba")
    t3 = time.perf_counter()
    out["layers_check"] = jamba_layers(torch, cfg)
    seconds.update(split_s=t2 - t1, ns_check_s=t3 - t2,
                   layers_check_s=time.perf_counter() - t3)
    log(f"[jamba] phase seconds {json.dumps(seconds)}")
    out["seconds"] = seconds
    return out, launches


# --------------------------------------------------------------------------
# phase 18: serve the dense families at full width
# --------------------------------------------------------------------------
#: the token families the server serves (pixtral on text tokens, as the
#: reference's server), each at its published widths: gemma3-12b at its
#: published depth, the others cut to 8 layers (gemma2 4 periods of its
#: local / global pair) to keep the smoke near its time aim; all four
#: fit the card at full depth (PERF.md §4)
DENSE_LAYERS = {"gemma3-12b": 48, "gemma2-9b": 8, "granite-20b": 8,
                "pixtral-12b": 8}
DENSE_WIDTHS = {"gemma3-12b": (3840, 262144), "gemma2-9b": (3584, 256000),
                "granite-20b": (6144, 49152), "pixtral-12b": (5120, 131072)}
#: musicgen-large's frames: a 4-sequence prefill of 128 frames, then
#: decode steps of one frame each
MUSICGEN_STEPS = 16
#: the streamed SDPA against the dense one on the card, both f32: the
#: CPU tests' bound, of max(1, the output's scale)
SDPA_TOL = 2e-5


def dense_serve(torch, arch):
    """One family served as phase 4 serves stablelm, with the whitening
    cache at its d_model: every request completed, embeddings finite,
    the kernels' launches the closed form, peak memory under the
    card's."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(arch),
                              n_layers=DENSE_LAYERS[arch])
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out, launches = run_serve(torch, arch, cfg=cfg)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    c = out["cache"]
    want = serve_closed_form(c)
    steps = out["decode_steps"]
    log(f"[dense] {arch}: {out['layers']} layers, d_model {out['d_model']},"
        f" vocab {out['vocab']}; launches {launches}, closed form {want} "
        f"(updates {c['updates']}, refreshes {c['refreshes']}, factor hits "
        f"{c['factor_hits']}); decode {1e3 * out['decode_s'] / steps:.1f} "
        f"ms a step; peak memory {peak / 2**30:.2f} GiB of "
        f"{total / 2**30:.2f}")
    assert (out["d_model"], out["vocab"]) == DENSE_WIDTHS[arch], out
    assert out["layers"] == DENSE_LAYERS[arch], out
    assert c["ns_fallbacks"] == 0, c
    assert launches == want, (launches, want)
    assert peak < total, (peak, total)
    keep = ("layers", "d_model", "vocab", "completed", "tokens_per_s",
            "mean_ttft_s", "p50_ttft_s", "p99_ttft_s", "serve_s",
            "startup_s", "prefill_s", "embed_s", "decode_s", "decode_steps",
            "refresh_s")
    row = {k: out[k] for k in keep}
    row.update(peak_memory_bytes=peak, seconds=time.perf_counter() - t0,
               ms_per_decode_step=1e3 * out["decode_s"] / steps,
               refreshes=c["refreshes"])
    return row, launches


def musicgen_frames(torch):
    """musicgen-large at full width and depth (48 layers, d_model 2048)
    on frames: a prefill of 4 x 128 frames, then ``MUSICGEN_STEPS``
    decode steps of a frame each, through ``Model`` (the server takes
    tokens only): finite logits of the codebook's width, host seconds
    (each ends in a sync), and the kernels' launches (the frame path
    runs no whitening: none)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import counts
    from repro_torch.models.model import init_model
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("musicgen-large")
    torch.cuda.reset_peak_memory_stats()
    model = init_model(cfg, seed=0, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(18)
    frames = torch.randn(4, 128 + MUSICGEN_STEPS, cfg.d_model,
                         generator=gen, device=DEVICE).to(torch.bfloat16)
    model.prefill(None, 256, embeds=frames[:, :16])         # warm
    counts.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache, hidden = model.prefill(None, 256, True,
                                          embeds=frames[:, :128])
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    assert logits.shape == (4, 1, cfg.vocab) and model.embed is None
    finite = bool(torch.isfinite(logits).all()) and \
        bool(torch.isfinite(hidden).all())
    t0 = time.perf_counter()
    for k in range(MUSICGEN_STEPS):
        pos = torch.full((4, 1), 128 + k, device=DEVICE)
        logits, cache = model.decode_step(
            None, pos, cache, embeds=frames[:, 128 + k:129 + k])
        finite &= bool(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = counts.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[dense] musicgen-large {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}, frames: prefill 4 x 128 "
        f"{prefill_s:.4f} s, {MUSICGEN_STEPS} decode steps "
        f"{decode_s:.4f} s ({1e3 * decode_s / MUSICGEN_STEPS:.1f} ms a "
        f"step); logits finite {finite}; launches {launches}; peak "
        f"{peak / 2**30:.2f} GiB")
    assert finite and logits.shape == (4, 1, cfg.vocab)
    del model, cache
    return {"layers": cfg.n_layers, "d_model": cfg.d_model,
            "prefill_s": prefill_s, "decode_s": decode_s,
            "ms_per_decode_step": 1e3 * decode_s / MUSICGEN_STEPS,
            "peak_memory_bytes": peak}, launches


def dense_blocks(torch):
    """One block of each kind at full width (a model cut to one layer),
    random bf16 weights drawn on the card and copied to the CPU, the
    same bf16 input on both, with a KV cache: a gemma3 local layer
    (window 1024) at a prefill of 1040 tokens, so the window binds,
    then a decode step; a gemma2 global layer (attention softcap 50),
    a granite layer (MQA, LayerNorm, ``gelu_mlp``) and a musicgen layer
    on frames, each a prefill of 64 and a decode step."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models.model import Block
    dev, cpu = torch.device(DEVICE), torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(32)
    hgen = torch.Generator().manual_seed(32)
    cases = (("gemma3-12b", 0, 1040), ("gemma2-9b", 1, 64),
             ("granite-20b", 0, 64), ("musicgen-large", 0, 64))
    out, secs = {}, {}
    with torch.no_grad():
        for arch, i, s in cases:
            cfg = get_config(arch)
            spec = cfg.pattern[i]
            blk = Block(cfg, spec, gen, dev)
            blk_c = copy.deepcopy(blk).to(cpu)
            x = torch.randn(1, s + 1, cfg.d_model, generator=hgen).to(
                torch.bfloat16)
            pos = torch.arange(s + 1)[None]
            cg = blk.init_cache(1, s + 1, dev)
            cc = blk_c.init_cache(1, s + 1, cpu)
            tag = f"{arch} layer {i} (window {spec.local_window})"
            yg, _ = blk(x[:, :s].to(dev), pos[:, :s].to(dev), cg)
            t0 = time.perf_counter()
            yc, _ = blk_c(x[:, :s], pos[:, :s], cc)
            secs[f"{arch}_prefill_{s}_cpu_s"] = time.perf_counter() - t0
            out[f"{arch} prefill {s}"] = card_vs_cpu(
                torch, f"{tag} prefill {s}", yg, yc, "dense")
            out[f"{arch} prefill {s} k"] = card_vs_cpu(
                torch, f"{tag} cached k", cg["k"], cc["k"], "dense")
            yg, _ = blk(x[:, s:].to(dev), pos[:, s:].to(dev), cg)
            yc, _ = blk_c(x[:, s:], pos[:, s:], cc)
            out[f"{arch} decode"] = card_vs_cpu(
                torch, f"{tag} decode step at {s}", yg, yc, "dense")
            del blk, blk_c, cg, cc
    torch.cuda.empty_cache()
    log(f"[dense] block checks' CPU seconds {json.dumps(secs)}")
    return {"rel_err": out, **secs}


def sdpa_stream_check(torch):
    """``_sdpa_streamed`` against the dense ``_sdpa`` on the card at
    gemma3's heads (16 over 8 KV heads, head_dim 256), a 2048-token
    query over 4096 keys in 1024-blocks, window 1024, softcap 50, f32:
    the error within ``SDPA_TOL`` of the output's scale; both timed."""
    from repro_torch.models.attention import (_attn_mask, _sdpa,
                                              _sdpa_streamed)
    gen = torch.Generator(device=DEVICE).manual_seed(33)
    b, sq, sk, h, hkv, d = 1, 2048, 4096, 16, 8, 256
    q = torch.randn(b, sq, h, d, generator=gen, device=DEVICE)
    k = torch.randn(b, sk, hkv, d, generator=gen, device=DEVICE)
    v = torch.randn(b, sk, hkv, d, generator=gen, device=DEVICE)
    q_pos = torch.arange(sk - sq, sk, device=DEVICE)[None]
    k_pos = torch.arange(sk, device=DEVICE)[None]
    mask = _attn_mask(q_pos, k_pos, 1024)

    def streamed():
        return _sdpa_streamed(q, k, v, q_pos, k_pos, 1024, None, 50.0,
                              d ** -0.5, block=1024)

    def dense():
        return _sdpa(q, k, v, mask, 50.0, d ** -0.5)
    with torch.no_grad():
        got, want = streamed(), dense()
        err = float((got - want).abs().max())
        rel = err / max(1.0, float(want.abs().max()))
        ms, dense_ms = cuda_ms(torch, streamed), cuda_ms(torch, dense)
    log(f"[dense] _sdpa_streamed vs _sdpa, ({b}, {sq}) x ({b}, {sk}), "
        f"{h} / {hkv} heads of {d}, window 1024: max_abs_err {err:.3e} "
        f"(rel {rel:.2e} <= {SDPA_TOL:.0e}); ms {ms:.4f} (dense "
        f"{dense_ms:.4f})")
    assert rel <= SDPA_TOL and bool(torch.isfinite(got).all()), rel
    return {"rel_err": rel, "ms": ms, "dense_ms": dense_ms}


def dense_phase(torch):
    """Phase 18: gemma3-12b, gemma2-9b, granite-20b and pixtral-12b
    served at full width (``DENSE_LAYERS``) with the whitening cache,
    each freed before the next is drawn; musicgen-large's frames
    prefilled and decoded at full width; one block of each kind card vs
    CPU; the streamed SDPA against the dense one on the card; the NS
    factor and an embedding at each served d_model, kernels against
    their plain versions."""
    import gc
    rows, launches, seconds = {}, {}, {}
    for arch in DENSE_LAYERS:
        rows[arch], launches[arch] = dense_serve(torch, arch)
        seconds[f"{arch}_s"] = rows[arch]["seconds"]
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    rows["ns_check"] = {d: ns_check(torch, d, "dense") for d in
                        sorted({w[0] for w in DENSE_WIDTHS.values()})}
    seconds["ns_check_s"] = time.perf_counter() - t
    t0 = time.perf_counter()
    rows["musicgen-large"], launches["musicgen-large"] = \
        musicgen_frames(torch)
    t1 = time.perf_counter()
    rows["blocks_check"] = dense_blocks(torch)
    t2 = time.perf_counter()
    rows["sdpa_check"] = sdpa_stream_check(torch)
    seconds.update(musicgen_s=t1 - t0, blocks_check_s=t2 - t1,
                   sdpa_check_s=time.perf_counter() - t2)
    log(f"[dense] phase seconds {json.dumps(seconds)}")
    rows["seconds"] = seconds
    return rows, launches


# --------------------------------------------------------------------------
# phase 19: serve deepseek-v3-671b and deepseek-v2-236b at full width
# --------------------------------------------------------------------------
#: each at its published widths, cut in depth to its dense prefix and one
#: MoE period: v3 its 3 dense layers, 1 MoE layer (256 experts) and the
#: MTP block's weights (15.69 B parameters, 31.4 GB in bf16); v2 its
#: dense layer and 1 MoE layer (160 experts; 5.36 B, 10.7 GB).  All 61 /
#: 60 layers do not fit 80 GB, nor would a second v3 MoE layer's 22.5 GB
#: beside its 15 GB f32 draw at init
DEEPSEEK_LAYERS = {"deepseek-v3-671b": 4, "deepseek-v2-236b": 2}
#: the published (d_model, vocab, experts, top-k, shared experts)
DEEPSEEK_WIDTHS = {"deepseek-v3-671b": (7168, 129280, 256, 8, 1),
                   "deepseek-v2-236b": (5120, 102400, 160, 6, 2)}
#: the MLA layer card vs CPU: a prefill of this many tokens into the
#: latent cache, then a decode step from it
MLA_CHECK_TOKENS = 64


def deepseek_serve(torch, arch):
    """One deepseek config served as phase 4 serves stablelm, with the
    whitening cache at its d_model: every request completed, embeddings
    finite, the kernels' launches the closed form, no NS fallback, peak
    memory under the card's, the published widths; then host seconds
    by block kind (``prefill_split``)."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(arch),
                              n_layers=DEEPSEEK_LAYERS[arch])
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out, launches = run_serve(torch, arch, cfg=cfg)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    c = out["cache"]
    want = serve_closed_form(c)
    steps = out["decode_steps"]
    mo = cfg.moe
    log(f"[deepseek] {arch}: {out['layers']} layers ({len(cfg.prefix)} "
        f"dense, {cfg.n_periods} MoE{', the MTP block' if cfg.mtp else ''}"
        f"), d_model {out['d_model']}, vocab {out['vocab']}, "
        f"{mo.n_experts} experts top-{mo.top_k}, {mo.n_shared} shared; "
        f"launches {launches}, closed form {want} (updates "
        f"{c['updates']}, refreshes {c['refreshes']}, factor hits "
        f"{c['factor_hits']}); decode {1e3 * out['decode_s'] / steps:.1f} "
        f"ms a step; peak memory {peak / 2**30:.2f} GiB of "
        f"{total / 2**30:.2f}")
    assert (out["layers"], out["d_model"], out["vocab"], mo.n_experts,
            mo.top_k, mo.n_shared) == (DEEPSEEK_LAYERS[arch],) + \
        DEEPSEEK_WIDTHS[arch], out
    assert c["ns_fallbacks"] == 0, c
    assert launches == want, (launches, want)
    assert peak < total, (peak, total)
    keep = ("layers", "d_model", "vocab", "completed", "tokens_per_s",
            "mean_ttft_s", "p50_ttft_s", "p99_ttft_s", "serve_s",
            "startup_s", "prefill_s", "embed_s", "decode_s", "decode_steps",
            "refresh_s")
    row = {k: out[k] for k in keep}
    row.update(peak_memory_bytes=peak, serve_wall_s=time.perf_counter() - t0,
               ms_per_decode_step=1e3 * out["decode_s"] / steps,
               refreshes=c["refreshes"])
    del out
    gc.collect()
    torch.cuda.empty_cache()
    row["prefill_split"] = prefill_split(torch, cfg, f"[deepseek {arch}]")
    row["seconds"] = time.perf_counter() - t0
    return row, launches


def mla_layer_check(torch):
    """One full-width deepseek-v3 prefix layer (MLA: 128 heads, q_lora
    1536, kv_lora 512, rope 64; the dense MLP of 18432), random bf16
    weights drawn on the card and copied to the CPU, the same bf16 input
    on both: a prefill of ``MLA_CHECK_TOKENS`` tokens into a latent cache
    twice as long, then a decode step from it (the mask reading only the
    filled rows); the outputs and the cache's ``ckv`` / ``kr`` rows
    within ``JAMBA_TOL``.  No MoE layer is copied to the host: one v3
    expert stack is 7.5 GB, and the MoE code is the one phase 17 holds."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models.model import Block
    dev, cpu = torch.device(DEVICE), torch.device("cpu")
    cfg = get_config("deepseek-v3-671b")
    gen = torch.Generator(device=dev).manual_seed(34)
    hgen = torch.Generator().manual_seed(34)
    s, out = MLA_CHECK_TOKENS, {}
    with torch.no_grad():
        blk = Block(cfg, cfg.prefix[0], gen, dev)
        blk_c = copy.deepcopy(blk).to(cpu)
        x = torch.randn(1, s + 1, cfg.d_model, generator=hgen).to(
            torch.bfloat16)
        pos = torch.arange(s + 1)[None]
        cg, cc = blk.init_cache(1, 2 * s, dev), blk_c.init_cache(1, 2 * s,
                                                                  cpu)
        tag = f"deepseek-v3 MLA layer, d {cfg.d_model}"
        yg, _ = blk(x[:, :s].to(dev), pos[:, :s].to(dev), cg)
        t0 = time.perf_counter()
        yc, _ = blk_c(x[:, :s], pos[:, :s], cc)
        cpu_s = time.perf_counter() - t0
        out["prefill"] = card_vs_cpu(torch, f"{tag} prefill {s}", yg, yc,
                                     "deepseek")
        for k in ("ckv", "kr"):
            out[k] = card_vs_cpu(torch, f"{tag} cached {k}", cg[k], cc[k],
                                 "deepseek")
        yg, _ = blk(x[:, s:].to(dev), pos[:, s:].to(dev), cg)
        yc, _ = blk_c(x[:, s:], pos[:, s:], cc)
        out["decode"] = card_vs_cpu(torch, f"{tag} decode step at {s}", yg,
                                    yc, "deepseek")
        del blk, blk_c, cg, cc
    torch.cuda.empty_cache()
    log(f"[deepseek] MLA layer check's CPU prefill {cpu_s:.2f} s")
    return {"rel_err": out, "cpu_prefill_s": cpu_s}


def deepseek_phase(torch):
    """Phase 19: deepseek-v3-671b and deepseek-v2-236b served at full
    width (``DEEPSEEK_LAYERS``) with the whitening cache, each freed
    before the next is drawn; the NS factor and an embedding at v3's d
    7168 against the plain kernels and the f64 iteration (v2's 5120 is
    phase 18's); one full-width MLA layer card vs CPU."""
    import gc
    rows, launches, seconds = {}, {}, {}
    for arch in DEEPSEEK_LAYERS:
        rows[arch], launches[arch] = deepseek_serve(torch, arch)
        seconds[f"{arch}_s"] = rows[arch]["seconds"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows["ns_check"] = ns_check(torch, 7168, "deepseek")
    t1 = time.perf_counter()
    rows["mla_check"] = mla_layer_check(torch)
    seconds.update(ns_check_s=t1 - t0,
                   mla_check_s=time.perf_counter() - t1)
    log(f"[deepseek] phase seconds {json.dumps(seconds)}")
    rows["seconds"] = seconds
    return rows, launches


# --------------------------------------------------------------------------
# phase 20: the shape cells at full width on the card
# --------------------------------------------------------------------------
#: (row, arch, cell, scale): each cell through the port's own steps at
#: its config's published widths and depth, the batch cut by
#: ``input_specs``' scale
SHAPE_ROWS = (("stablelm-1.6b prefill_32k", "stablelm_1_6b", "prefill_32k", 32),
              ("stablelm-1.6b decode_32k", "stablelm_1_6b", "decode_32k", 32),
              ("xlstm-350m prefill_32k", "xlstm_350m", "prefill_32k", 32),
              ("xlstm-350m long_500k", "xlstm_350m", "long_500k", 1),
              ("stablelm-1.6b train_4k", "stablelm_1_6b", "train_4k", 256))
#: stablelm's prefill is one token short of its cell, so that the
#: decode_32k step at position 32767 writes into the same s_max 32768
#: cache (copied into the decode cell's 4 rows)
SHAPE_PREFILL_TOKENS = 32767
SHAPE_S_MAX = 32768
#: timed decode steps after one warm-up
SHAPE_DECODE_REPS = 3
#: the dry run's default loss chunk (``launch/dryrun.py``), which the
#: train_4k row's trainer takes so that the card runs the counted step
SHAPE_LOSS_CHUNK = 512


def count_shape_row(name: str) -> dict:
    """op_cost of a phase-20 row's step at its scale on the meta device
    (no card: ``launch/dryrun.py``'s ``count_cell``; stablelm's prefill
    at ``SHAPE_PREFILL_TOKENS``), with its H100 roofline."""
    import torch
    from repro_torch.analysis.op_cost import OpCounter
    from repro_torch.analysis.roofline import build_roofline
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.model import Model
    [(_, arch, cell, scale)] = [r for r in SHAPE_ROWS if r[0] == name]
    cfg = get_config(arch)
    t0 = time.perf_counter()
    if name == "stablelm-1.6b prefill_32k":
        meta = torch.device("meta")
        model = Model(cfg, torch.Generator(), meta)
        tokens = torch.empty((1, SHAPE_PREFILL_TOKENS), dtype=torch.int32,
                             device=meta)
        with OpCounter() as c:
            make_prefill_step(model, SHAPE_S_MAX)(tokens)
        cost = c.cost
    else:
        cost = dryrun.count_cell(cfg, cell, scale=scale,
                                 loss_chunk=SHAPE_LOSS_CHUNK)[0]
    roof = build_roofline(cost, 1)
    return {"row": name, "count_s": time.perf_counter() - t0,
            **cost.summary(), "compute_s": roof.compute_s,
            "memory_s": roof.memory_s, "collective_s": roof.collective_s,
            "dominant": roof.dominant, "bound_s": roof.bound_s,
            "top_bytes": cost.top_ops(6)}


def count_shape_rows(out: str, names) -> None:
    """The child process's work: ``count_shape_row`` of each row, one
    JSON line each, into ``out``."""
    with open(out, "w") as f:
        for name in names:
            f.write(json.dumps(count_shape_row(name)) + "\n")


def start_shape_counts(tmp: str):
    """Count phase 20's rows on the meta device in two child processes
    (the xlstm prefill's 256 mLSTM chunks × 18 layers alone, the rest in
    the other), at a lower priority, while the card runs the earlier
    phases: [(process, output path)]."""
    groups = ([SHAPE_ROWS[2][0]], [r[0] for r in SHAPE_ROWS
                                   if r[0] != SHAPE_ROWS[2][0]])
    procs = []
    for i, names in enumerate(groups):
        out = os.path.join(tmp, f"shape_counts_{i}.jsonl")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--count-shapes",
             out, *names], preexec_fn=lambda: os.nice(10)), out))
    return procs


def read_shape_counts(procs, timeout: float = 600.0) -> dict:
    counts = {}
    for proc, out in procs:
        try:
            rc = proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if rc != 0:
            raise SystemExit(f"[shapes] counting child exited {rc}")
        for line in open(out):
            rec = json.loads(line)
            counts[rec["row"]] = rec
    return counts


def _synced_s(torch, fn):
    """(host seconds of ``fn()`` between two syncs, its result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _shape_row(torch, name, seconds, clock, count, peak=None) -> dict:
    """A row's record: the measured seconds beside its count and the
    H100 roofline; the measured fraction bound / measured must be ≤ 1
    (a bound faster than the card's time means a wrong count)."""
    peak = torch.cuda.max_memory_allocated() if peak is None else peak
    frac = count["bound_s"] / seconds
    row = {"row": name, "measured_s": seconds, "clock": clock,
           "peak_bytes": peak, "flops_by_dtype": count["flops_by_dtype"],
           "dot_flops_by_dtype": count["dot_flops_by_dtype"],
           "eager_bytes": count["eager_bytes"],
           "compute_s": count["compute_s"], "memory_s": count["memory_s"],
           "collective_s": count["collective_s"],
           "dominant": count["dominant"], "bound_s": count["bound_s"],
           "measured_fraction": frac, "ops": count["ops"],
           "count_s": count["count_s"]}
    log(f"[shapes] {name}: measured {seconds:.4f} s ({clock}), peak "
        f"{peak / 2**30:.2f} GiB; op_cost flops by dtype "
        + json.dumps({k: f"{v:.4e}" for k, v in
                      count["flops_by_dtype"].items()})
        + f", eager bytes {count['eager_bytes']:.4e} ({count['ops']} ops; "
        f"most bytes {[k for k, _ in count['top_bytes']]}); H100 roofline "
        f"compute {count['compute_s']:.4f} s, memory "
        f"{count['memory_s']:.4f} s, collective {count['collective_s']:.1f}"
        f" s, dominant {count['dominant']}; measured fraction "
        f"{frac:.4f} (<= 1)")
    assert frac <= 1.0, (name, frac)
    return row


def _stablelm_sdpa_check(torch, model, cfg, tokens, cache):
    """The streamed SDPA at length against the dense one: layer 0's real
    q of the prompt's last 1024 positions (recomputed from the
    embedding, upcast to f32) over its cached bf16 k / v at 32768 keys,
    the dense mask (1024 × 32768, the f32 logits ~4.3 GB)."""
    from repro_torch.models.attention import (_attn_mask, _sdpa,
                                              _sdpa_streamed)
    from repro_torch.models.common import apply_norm, apply_rope
    blk, nq = model.blocks[0], 1024
    q_pos = torch.arange(SHAPE_PREFILL_TOKENS - nq, SHAPE_PREFILL_TOKENS,
                         device=DEVICE)[None]
    k_pos = torch.arange(SHAPE_S_MAX, device=DEVICE)[None]
    valid = k_pos <= SHAPE_PREFILL_TOKENS - 1
    with torch.no_grad():
        h = apply_norm(cfg, blk.norm1, model._embed(tokens[:, -nq:]))
        q = (h @ blk.mixer.wq).reshape(1, nq, cfg.n_heads, cfg.hd)
        # the bf16 q upcast: both return q's dtype, and an f32 output
        # shows their difference rather than a bf16 rounding of it
        q = apply_rope(q, q_pos, cfg.rope_theta, cfg.rope_fraction).float()
        k, v = cache[0]["k"], cache[0]["v"]
        scale = cfg.hd ** -0.5
        t0 = time.perf_counter()
        got = _sdpa_streamed(q, k, v, q_pos, k_pos, 0, valid, 0.0, scale)
        mask = _attn_mask(q_pos, k_pos, 0, valid)
        want = _sdpa(q, k, v, mask, 0.0, scale)
        err = float((got.float() - want.float()).abs().max())
        rel = err / max(1.0, float(want.float().abs().max()))
        secs = time.perf_counter() - t0
    log(f"[shapes] _sdpa_streamed vs _sdpa at length: layer 0's q of "
        f"positions {SHAPE_PREFILL_TOKENS - nq}..{SHAPE_PREFILL_TOKENS - 1}"
        f" over {SHAPE_S_MAX} keys (1024-key blocks), {cfg.n_heads} heads "
        f"of {cfg.hd}: max_abs_err {err:.3e} (rel {rel:.2e} <= "
        f"{SDPA_TOL:.0e}); {secs:.2f} s")
    assert rel <= SDPA_TOL and bool(torch.isfinite(got).all()), rel
    return {"max_abs_err": err, "rel_err": rel}


def shapes_stablelm(torch, counts) -> tuple:
    """stablelm-1.6b at full width: the prefill_32k row (one sequence of
    ``SHAPE_PREFILL_TOKENS`` into an s_max 32768 cache, the streamed
    SDPA), the streamed-vs-dense check, the decode_32k row (the cache
    copied into 4 rows, one step at position 32767), then the train_4k
    row through the trainer (1 × 4096 tokens, 2 AdamW steps)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.counts import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.launch.train import build_argparser, train
    from repro_torch.models.model import init_model
    cfg = get_config("stablelm_1_6b")
    rows, launches = {}, {}
    model = init_model(cfg, seed=0)
    gen = torch.Generator(device=DEVICE).manual_seed(20)
    tokens = torch.randint(0, cfg.vocab, (1, SHAPE_PREFILL_TOKENS),
                           generator=gen, device=DEVICE, dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    name = SHAPE_ROWS[0][0]
    secs, (logits, cache) = _synced_s(
        torch, lambda: make_prefill_step(model, SHAPE_S_MAX)(tokens))
    launches[name] = launch_counts()
    assert tuple(logits.shape) == (1, 1, cfg.vocab) and \
        bool(torch.isfinite(logits).all())
    rows[name] = _shape_row(torch, name, secs, "host clock, synced",
                            counts[name])
    rows["sdpa_check"] = _stablelm_sdpa_check(torch, model, cfg, tokens,
                                              cache)
    name = SHAPE_ROWS[1][0]
    b = 4
    cache = [{k: v.expand(b, *v.shape[1:]).contiguous() for k, v in
              c.items()} for c in cache]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = make_decode_step(model)
    token = torch.randint(0, cfg.vocab, (b, 1), generator=gen,
                          device=DEVICE, dtype=torch.int32)
    pos = torch.full((b, 1), SHAPE_S_MAX - 1, dtype=torch.int32,
                     device=DEVICE)
    reset_launch_counts()
    nxt, logits, cache = step(token, pos, cache)             # warm-up
    secs, _ = _synced_s(torch, lambda: [step(token, pos, cache)
                                        for _ in range(SHAPE_DECODE_REPS)])
    launches[name] = launch_counts()
    assert tuple(nxt.shape) == (b, 1) and bool(torch.isfinite(logits).all())
    rows[name] = _shape_row(torch, name, secs / SHAPE_DECODE_REPS,
                            f"host clock, synced, mean of "
                            f"{SHAPE_DECODE_REPS} steps", counts[name])
    del model, cache, logits, step
    torch.cuda.empty_cache()
    name = SHAPE_ROWS[4][0]
    out = train(build_argparser().parse_args([
        "--arch", "stablelm-1.6b", "--full", "--device", DEVICE,
        "--optimizer", "adamw", "--steps", "2", "--global-batch", "1",
        "--seq-len", "4096", "--loss-chunk", str(SHAPE_LOSS_CHUNK),
        "--seed", "0", "--log-every", "1"]))
    launches[name] = out["kernel_launches"]
    log(f"[shapes] {name}: losses {out['losses']}, step s {out['step_s']}")
    assert len(out["losses"]) == 2 and all(map(math.isfinite,
                                               out["losses"]))
    rows[name] = _shape_row(torch, name, out["step_s"][1],
                            "host clock, synced, step 1 (after warm-up)",
                            counts[name], peak=out["peak_memory_bytes"])
    torch.cuda.empty_cache()
    return rows, launches


def shapes_xlstm(torch, counts, cases) -> tuple:
    """xlstm-350m at full width: the prefill_32k row (one sequence of
    32768 tokens: the chunkwise mLSTM, ``slstm_scan`` on (1, 32768,
    1024) bf16 quads, 6 launches, no plain scan), that sLSTM layer's
    gates through the kernel against the plain version (timed, a row of
    the kernels line), then the long_500k row: decode steps from that
    prefill's state."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.kernels import slstm
    from repro_torch.kernels.counts import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import ssm
    from repro_torch.models.model import init_model
    cfg = get_config("xlstm_350m")
    n_slstm = sum(b.mixer == "slstm" for b in cfg.pattern) * cfg.n_periods
    rows, launches, seen = {}, {}, []
    model = init_model(cfg, seed=0)
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    s = SHAPES["prefill_32k"].seq_len
    tokens = torch.randint(0, cfg.vocab, (1, s), generator=gen,
                           device=DEVICE, dtype=torch.int32)
    scan = ssm.slstm_scan

    def first_gates(*args, **kw):       # the first sLSTM layer's inputs
        if not seen:
            seen.append(args)
        return scan(*args, **kw)
    ssm.slstm_scan = first_gates
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    name = SHAPE_ROWS[2][0]
    try:
        secs, (logits, cache) = _synced_s(
            torch, lambda: make_prefill_step(model, s)(tokens))
    finally:
        ssm.slstm_scan = scan
    launches[name] = launch_counts()
    assert launches[name]["slstm_scan"] == n_slstm, launches[name]
    assert bool(torch.isfinite(logits).all())
    rows[name] = _shape_row(torch, name, secs, "host clock, synced",
                            counts[name])
    gates, st = seen[0][:4], seen[0][4:]
    assert slstm._quad_base(gates) is not None and \
        gates[0].dtype == torch.bfloat16 and \
        tuple(gates[0].shape) == (1, s, cfg.d_model)
    plain = UNGUARDED.get("scan", slstm._slstm_scan_plain)
    got = slstm.slstm_scan(*gates, *st)
    f32 = slstm._upcast(gates)
    plain_s, want = _synced_s(torch, lambda: plain(*f32, *st))
    label = f"slstm_scan (1, {s}, {cfg.d_model}) bf16 quad prefill_32k"
    err = slstm_close(torch, label + " y", got[0], want[0], SLSTM_Y_TOL)
    err_s = max(slstm_close(torch, f"{label} {k}1", g, w, SLSTM_STATE_TOL)
                for k, g, w in zip("cnm", got[1:], want[1:]))
    del want, f32
    flops, nbytes = slstm.scan_cost(1, s, cfg.d_model, 2)
    bound, by = bound_ms(nbytes, flops, tensor=False)
    row = {"case": f"(1, {s}, {cfg.d_model}) bf16 quad prefill_32k",
           "main": False, "dtype": "bf16", "layout": "quad",
           "max_abs_err": err, "max_abs_err_state": err_s,
           "bound_ms": bound, "bound_by": by, "ffma_bound_ms": bound,
           "library_ms": None,
           "ms": cuda_ms(torch, lambda: slstm.slstm_scan(*gates, *st)),
           "plain_ms": plain_s * 1e3}
    log(f"[shapes]   ms {row['ms']:.4f}  plain {row['plain_ms']:.1f} (one "
        f"call)  library none  bound {bound:.4f} ({by})")
    cases["slstm_scan"].append(row)
    name = SHAPE_ROWS[3][0]
    torch.cuda.reset_peak_memory_stats()
    step = make_decode_step(model)
    token = torch.randint(0, cfg.vocab, (1, 1), generator=gen,
                          device=DEVICE, dtype=torch.int32)
    pos = torch.full((1, 1), SHAPES["long_500k"].seq_len - 1,
                     dtype=torch.int32, device=DEVICE)
    reset_launch_counts()
    step(token, pos, cache)                                  # warm-up
    secs, outs = _synced_s(torch, lambda: [step(token, pos, cache)
                                           for _ in range(SHAPE_DECODE_REPS)])
    launches[name] = launch_counts()
    assert launches[name]["slstm_scan"] == n_slstm * (SHAPE_DECODE_REPS + 1)
    assert all(bool(torch.isfinite(o[1]).all()) for o in outs)
    rows[name] = _shape_row(torch, name, secs / SHAPE_DECODE_REPS,
                            f"host clock, synced, mean of "
                            f"{SHAPE_DECODE_REPS} steps", counts[name])
    del model, cache, gates, st, got
    torch.cuda.empty_cache()
    return rows, launches


def shapes_phase(torch, procs, cases):
    """Phase 20: the shape cells run for real at full width, each beside
    its op count on meta (counted by the child processes started with
    the smoke) and the H100 roofline."""
    counts = read_shape_counts(procs)
    rows, launches = shapes_stablelm(torch, counts)
    xrows, xlaunches = shapes_xlstm(torch, counts, cases)
    rows.update(xrows)
    launches.update(xlaunches)
    return rows, launches


# --------------------------------------------------------------------------
# phase 21: train the dense families at full width, one card and a mesh
# --------------------------------------------------------------------------
#: each family on one card at its published widths: (layers, optimizer).
#: The depth is cut to whole periods of the pattern (gemma2's local /
#: global pair, gemma3's 5 local + 1 global), never the width; pixtral
#: and musicgen as deep as keeps a step's peak well under the card's 80
#: GB at the trainer's ~22 (Muon) to ~30 (AdamW) bytes a parameter
#: (PERF.md §5: musicgen whole), granite at 2 layers (its (2, 6144,
#: 24576) MLP stacks: the smoke's time, not its memory).  Muon on the
#: widest Grams (gemma3's 262144 x 3840 embeddings, granite's 6144 x
#: 24576 MLP), AdamW on the others to keep the phase short
DENSETRAIN = {"gemma2-9b": (2, "adamw"), "gemma3-12b": (6, "muon-syrk"),
              "granite-20b": (2, "muon-syrk"), "pixtral-12b": (4, "adamw"),
              "musicgen-large": (48, "adamw")}
#: a warm-up step and 2 timed, 2 x 256 tokens (frames for musicgen)
DENSETRAIN_STEPS, DENSETRAIN_BATCH = 3, 2
#: the Muon NS Gram widths these runs add (2048 is phase 7's, 1024
#: phase 15's), each at the long sides it meets there: an embedding's
#: vocab, the MLP's d_ff, pixtral's 4096-wide attention projections
MUON_WIDTHS = ((3584, 256000), (3584, 14336), (3840, 262144),
               (3840, 15360), (5120, 131072), (5120, 14336), (6144, 49152),
               (6144, 24576), (4096, 5120))
#: gemma2-9b on (data 2, model 2) with fsdp_params, one period, AdamW,
#: in the launch phases 13 and 16 share.  ``init_model(mesh=)`` draws the
#: whole model on every rank before it shards (ROADMAP A, limitations):
#: 4 ranks x 4.5 GB of bf16 weights (and a leaf's f32 draw) at once
DENSEMESH_ARCH, DENSEMESH_LAYERS, DENSEMESH_STEPS = "gemma2-9b", 2, 2


#: the symmetric kernels timed at the training shapes phase 21 adds:
#: (label, stack, n1, n2), the NS Gram (SYRK) and sym(Y)·X (SYMM) of
#: each; the launches a step are the run's (5 NS steps a leaf)
DENSE_KERNEL_SHAPES = (("gemma3-12b embedding", 1, 3840, 262144),
                       ("pixtral-12b embedding", 1, 5120, 131072),
                       ("granite-20b MLP stack", 6, 6144, 24576))
#: each product ``dense_kernel_rows`` can time: its kernel and its case
NS_PRODUCTS = {"syrk": ("rank_update", "NS Gram, SYRK {shape}"),
               "symm": ("sym_stream", "NS sym(Y)·X, {n1}² x {shape}"),
               "ss": ("sym_stream", "NS S·S, {n1}² x {shape}")}


def dense_kernel_rows(torch, cases, shapes=DENSE_KERNEL_SHAPES,
                      products=("syrk", "symm"), tag="[densetrain]"):
    """``rank_update`` (the NS Gram, SYRK) and ``sym_stream`` (sym(Y)·X;
    with n2 = n1 it is the NS's S·S, "ss") at ``shapes``, each of
    ``products`` held to the same product in f64
    within ``TOL_F32`` (max error over max(1, max |f64|)), as phases 17
    and 18 hold the NS factor: at K up to 262144 the plain f32 version's
    own rounding is of that order, so its distance to the kernel and to
    f64 is printed, not bounded (``ns_check``).  Each is timed (CUDA
    events) beside the plain version, one PyTorch call (``torch.matmul``
    / ``torch.bmm``) and the bound; rows added to ``cases`` (not the
    kernels line's main rows)."""
    from repro_torch.core.packing import pack_tril_tiles
    from repro_torch.kernels import trigrid
    gen = torch.Generator(device=DEVICE).manual_seed(37)

    def rel(x, ref):
        err = float((x.double() - ref).abs().max())
        return err, err / max(1.0, float(ref.abs().max()))

    for label, k, n1, n2 in shapes:
        lead = (k,) if k > 1 else ()
        mm = torch.bmm if k > 1 else torch.matmul
        shape = str(lead + (n1, n2)).replace(",)", ")")
        T = (n1 // 128) * (n1 // 128 + 1) // 2
        a = torch.randn(*lead, n1, n2, generator=gen, device=DEVICE) \
            / n2 ** 0.5
        s = torch.randn(*lead, n1, n1, generator=gen, device=DEVICE) \
            / n1 ** 0.5
        tiles = pack_tril_tiles(s, 128).contiguous()
        sym = torch.tril(s) + torch.tril(s, -1).mT
        del s
        runs = (
            ("syrk", lambda: trigrid.rank_update("syrk", a, bm=128),
             lambda: trigrid._rank_update_plain("syrk", a, None, 128,
                                                trigrid.Epilogue(), None),
             lambda: pack_tril_tiles(torch.tril(
                 a.double() @ a.double().mT), 128),
             lambda: mm(a, a.mT), k * n1 * n2 * 4 + k * T * 128 * 128 * 4,
             k * n1 * (n1 + 1) * n2),
            ("ss" if n2 == n1 else "symm",
             lambda: trigrid.sym_stream(tiles, a, bm=128),
             lambda: trigrid._sym_stream_plain(tiles, a, n1 // 128, 1.0,
                                               torch.float32),
             lambda: sym.double() @ a.double(),
             lambda: mm(sym, a), tiles.numel() * 4 + 2 * k * n1 * n2 * 4,
             2 * k * n1 * n1 * n2))
        for op, run, plain, exact, library, nbytes, flops in runs:
            if op not in products:
                continue
            name, fmt = NS_PRODUCTS[op]
            case = f"{label} " + fmt.format(shape=shape, n1=n1)
            got, want = run(), exact()
            err, err_rel = rel(got, want)
            ours = plain()
            plain_rel = rel(ours, want)[1]
            vs_plain = rel(got, ours.double())[1]
            del ours, want
            ok = err_rel <= TOL_F32 and bool(torch.isfinite(got).all())
            del got
            log(f"[kernels] {name} {case}: vs f64 max_abs_err {err:.3e} "
                f"(rel {err_rel:.2e} <= {TOL_F32:.0e}); the plain f32 "
                f"version vs f64 {plain_rel:.2e}, the kernel vs it "
                f"{vs_plain:.2e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"kernel {name} {case} disagrees with the "
                                 "product in f64")
            row = {"case": case, "max_abs_err": err, "vs": "f64",
                   "plain_rel_err_f64": plain_rel,
                   "rel_err_vs_plain": vs_plain, "main": False, "batch": k,
                   "ms": cuda_ms(torch, run), "plain_ms": cuda_ms(torch, plain),
                   "library_ms": cuda_ms(torch, library),
                   "library": "torch.bmm" if k > 1 else "torch.matmul",
                   "ffma_bound_ms": bound_ms(nbytes, flops, False)[0]}
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
            log(f"{tag}   {name} {case}: ms {row['ms']:.4f}  plain "
                f"{row['plain_ms']:.4f}  {row['library']} "
                f"{row['library_ms']:.4f}  bound {row['bound_ms']:.4f} "
                f"({row['bound_by']})")
            cases.setdefault(name, []).append(row)
            torch.cuda.empty_cache()
        del a, tiles, sym
        torch.cuda.empty_cache()


def _dense_argv(arch, layers, optimizer, steps):
    """The train flags of phase 21: ``arch`` at its published widths cut
    to ``layers``, 2 x 256 tokens a step, seed 0."""
    return ["--arch", arch, "--full", "--layers", str(layers),
            "--optimizer", optimizer, "--steps", str(steps),
            "--global-batch", str(DENSETRAIN_BATCH), "--seq-len", "256",
            "--loss-chunk", "256", "--seed", "0", "--data-seed", "0",
            "--log-every", "1"]


def _densemesh_args():
    from repro_torch.launch.train import build_argparser
    return build_argparser().parse_args(
        _dense_argv(DENSEMESH_ARCH, DENSEMESH_LAYERS, "adamw",
                    DENSEMESH_STEPS) + ["--device", DEVICE, "--devices", "4",
                                        "--max-model", "2"])


def muon_launches(cfg, steps) -> dict:
    """A single-device Muon run's kernel launches from the leaf shapes:
    each matrix leaf (a stack in one call) whose short side is at least
    256 (the kernel route) runs 5 NS steps of one SYRK (``rank_update``)
    and two SYMMs (``sym_stream``) a step."""
    n = sum(len(s) >= 2 and min(s[-2:]) >= 256
            for s in _leaves(cfg).values())
    return {"rank_update": 5 * n * steps, "sym_stream": 10 * n * steps,
            "slstm_scan": 0, "slstm_scan_bwd": 0}


def fsdp_closed_form(cfg, data, P) -> dict:
    """A rank's loss + backward words a step over 'data' under
    ``fsdp_params``, from the shapes and specs alone: each block split
    over 'data' all-gathered (D - 1 times the block) twice for a layer's
    weights (the forward and the per-period recompute) and once for
    embed and unembed, and its gradient reduce-scattered once."""
    from repro_torch.models.sharding import axis_size, param_specs
    shapes = _leaves(cfg)
    sizes = {"data": data, "model": P}
    specs = param_specs(cfg, shapes, sizes)
    ag = rs = 0
    for k, shape in shapes.items():
        if data == 1 or "data" not in specs[k]:
            continue
        block = math.prod(shape) // math.prod(
            axis_size(sizes, a) for a in specs[k] if a is not None)
        ag += (data - 1) * block * (2 if k[0] == "periods" else 1)
        rs += (data - 1) * block
    return {"all_gather": ag, "reduce_scatter": rs}


def muon_f64_check(torch, n1, n2, stack=(), tag="[densetrain]"):
    """One Muon orthogonalisation (5 NS steps) of an (n1, n2) f32
    momentum (a ``stack`` of them: one launch a product) from a seed on
    the kernels, against the same iteration in f64 on ``torch.matmul``:
    the result within ``NS_TOL`` (relative Frobenius, over the stack)
    and the first Gram (one ``rank_update`` SYRK) within ``TOL_F32``
    (max error over max(1, max |f64|)); 5 / 10 launches."""
    from repro_torch import blas
    from repro_torch.kernels import counts
    from repro_torch.optim.muon import NS_COEFFS, orthogonalize_reference
    gen = torch.Generator(device=DEVICE).manual_seed(n1 + n2)
    m = torch.randn(*stack, n1, n2, generator=gen, device=DEVICE)
    before = counts.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = orthogonalize_reference(m, steps=5)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = {k: n - before[k] for k, n in counts.launch_counts().items()}
    x32 = m / (torch.linalg.vector_norm(m, dim=(-2, -1), keepdim=True)
               + 1e-7)
    gram = blas.syrk(x32, fill="full")
    del m
    a, b, c = NS_COEFFS
    x = x32.double()
    del x32
    gram64 = x @ x.mT
    gram_err = float((gram.double() - gram64).abs().max()) / max(
        1.0, float(gram64.abs().max()))
    del gram
    for i in range(5):
        s = gram64 if i == 0 else x @ x.mT
        x = a * x + (b * s + c * (s @ s)) @ x
        del s
        gram64 = None
    rel = float((got.double() - x).norm() / x.norm())
    del x, got
    torch.cuda.empty_cache()
    ok = rel <= NS_TOL and gram_err <= TOL_F32
    shape = tuple(stack) + (n1, n2)
    log(f"{tag} Muon NS {shape}, 5 steps on the kernels vs the "
        f"f64 iteration: rel {rel:.3e} (<= {NS_TOL:.0e}); first Gram "
        f"{gram_err:.3e} (<= {TOL_F32:.0e}); host s {secs:.4f}; launches "
        f"{launched} {'ok' if ok else 'FAIL'}")
    assert launched["rank_update"] == 5 and launched["sym_stream"] == 10, \
        launched
    if not ok:
        raise SystemExit(f"Muon NS at {shape} on the kernels disagrees "
                         "with the f64 iteration")
    return {"shape": list(shape), "rel_f64": rel, "gram_err_f64": gram_err,
            "s": secs}


def _dense_report(torch, tag, cfg, out, launches, want):
    """Print one family's run (s a step and its split, tokens/s, peak
    against the card's memory, launches against ``want``) and check it:
    finite losses, the launches, the peak under the card's."""
    total = torch.cuda.get_device_properties(0).total_memory
    losses, peak = out["losses"], out["peak_memory_bytes"]
    log(f"{tag} {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {out['params']} parameters, "
        f"{out['optimizer']}: losses {losses}")
    for i, (t, sp) in enumerate(zip(out["step_s"], out["split_s"])):
        log(f"{tag} step {i}{' (warm-up)' if i == 0 else ''}: {t:.4f} s = "
            f"loss+backward {sp['loss_backward_s']:.4f} + clip "
            f"{sp['clip_s']:.4f} + optimizer {sp['opt_s']:.4f}")
    log(f"{tag} tokens/s {out['tokens_per_s']:.1f} (after the warm-up); "
        f"peak memory {peak / 2**30:.2f} GiB of {total / 2**30:.2f}; "
        f"launches {launches}, closed form {want}")
    assert all(map(math.isfinite, losses)), losses
    assert {k: launches[k] for k in want} == want, (launches, want)
    assert peak < total, (peak, total)
    return {"layers": cfg.n_layers, "optimizer": out["optimizer"],
            "params": out["params"], "losses": losses,
            "step_s": out["step_s"], "split_s": out["split_s"],
            "tokens_per_s": out["tokens_per_s"], "peak_memory_bytes": peak,
            "launches": launches}


def dense_train(torch, arch, layers, optimizer):
    """``train`` of a token family at full width, ``layers`` deep, on
    the card; gemma2's initial weights are also kept on the host for
    the card-vs-CPU loss."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch import train as ttrain
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    kept, init = {}, ttrain.init_model

    def keep(cfg, seed, device, **kw):
        model = init(cfg, seed=seed, device=device, **kw)
        if arch == DENSEMESH_ARCH:
            kept.update({k: v.detach().to("cpu", copy=True)
                         for k, v in model.state_dict().items()})
        return model

    ttrain.init_model = keep
    try:
        out = ttrain.train(ttrain.build_argparser().parse_args(
            _dense_argv(arch, layers, optimizer, DENSETRAIN_STEPS)
            + ["--device", DEVICE]))
    finally:
        ttrain.init_model = init
    launches = out["kernel_launches"]
    want = muon_launches(cfg, DENSETRAIN_STEPS) \
        if optimizer.startswith("muon") else \
        {k: 0 for k in ("rank_update", "sym_stream", "slstm_scan",
                        "slstm_scan_bwd")}
    tag = f"[densetrain {arch}]"
    if optimizer.startswith("muon"):
        assert_kernel_routes(out, launches, tag)
    row = _dense_report(torch, tag, cfg, out, launches, want)
    return row, launches, kept


def dense_cpu_loss(torch, cfg, state, card_loss, tag="[densetrain]"):
    """The first loss of the card's run, from the same initial weights on
    the CPU (no grad): within phase 7's ``MUON_TOL`` form,
    |card - cpu| <= MUON_TOL + MUON_TOL·|cpu|."""
    from repro_torch.data import DataConfig, make_train_iterator
    from repro_torch.models.model import Model, lm_loss
    cpu = torch.device("cpu")
    model = Model(cfg, torch.Generator(), torch.device("meta"))
    model.load_state_dict(state, assign=True)
    model.device = cpu
    it = make_train_iterator(DataConfig(
        seq_len=256, global_batch=DENSETRAIN_BATCH, vocab_size=cfg.vocab,
        seed=0), device="cpu")
    try:
        batch = next(it)
    finally:
        it.close()
    t0 = time.perf_counter()
    with torch.no_grad():
        want = float(lm_loss(model, batch, chunk=256, remat=False))
    err = abs(card_loss - want)
    ok = err <= MUON_TOL + MUON_TOL * abs(want)
    log(f"{tag} {cfg.name} {cfg.n_layers} layers, first loss card "
        f"{card_loss:.6f} vs cpu {want:.6f}: |diff| {err:.3e} (<= "
        f"{MUON_TOL:.0e} + {MUON_TOL:.0e}|cpu|), cpu s "
        f"{time.perf_counter() - t0:.1f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the dense first loss on the card disagrees with "
                         "the CPU's")
    return {"card": card_loss, "cpu": want, "abs_err": err}


def musicgen_train(torch, layers, optimizer):
    """musicgen-large at full width, ``layers`` deep, on frames through
    ``make_train_step`` (the trainer, as the reference's, feeds tokens
    and refuses it): the batches of ``make_train_iterator(frontend=
    "embeddings")``, timed as the trainer times its steps."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_train_iterator
    from repro_torch.kernels import counts
    from repro_torch.launch.steps import (init_opt_state, make_optimizer,
                                          make_train_step)
    from repro_torch.models.model import init_model
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("musicgen-large"), n_layers=layers)
    model = init_model(cfg, seed=0, device=DEVICE)
    opt = make_optimizer(cfg, optimizer)
    step = make_train_step(model, opt, loss_chunk=256)
    state = init_opt_state(model, opt)
    it = make_train_iterator(DataConfig(
        seq_len=256, global_batch=DENSETRAIN_BATCH, vocab_size=cfg.vocab,
        seed=0), frontend="embeddings", d_model=cfg.d_model, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    counts.reset_launch_counts()
    losses, step_s, split = [], [], []
    try:
        for _ in range(DENSETRAIN_STEPS):
            batch = next(it)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - t0)
            split.append({k: metrics[k] for k in
                          ("loss_backward_s", "clip_s", "opt_s")})
    finally:
        it.close()
    launches = counts.launch_counts()
    timed = step_s[1:]
    out = {"losses": losses, "step_s": step_s, "split_s": split,
           "optimizer": optimizer,
           "params": sum(p.numel() for p in model.parameters()),
           "tokens_per_s": DENSETRAIN_BATCH * 256 * len(timed) / sum(timed),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del model, state, step, opt
    want = {k: 0 for k in launches}
    row = _dense_report(torch, "[densetrain musicgen-large frames]", cfg,
                        out, launches, want)
    return row, launches


def densemesh_check(torch, run, wall, single_losses):
    """gemma2-9b on (data 2, model 2) with ``fsdp_params`` (phase 13's
    launch): every rank's losses identical, step 0's within
    ``MESHTRAIN_RTOL`` of the one-card run's, each rank's loss +
    backward all-gather and reduce-scatter words a step the closed
    form; prints the split, words and bytes by phase, and the peaks."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(DENSEMESH_ARCH),
                              n_layers=DENSEMESH_LAYERS)
    out = run_mesh_train(torch, run, wall)
    assert out["mesh"] == {"data": 2, "model": 2}, out["mesh"]
    ranks, losses = out["ranks"], out["losses"]
    assert len(losses) == DENSEMESH_STEPS and \
        all(map(math.isfinite, losses)), losses
    for i, r in enumerate(ranks):
        assert r["losses"] == losses, (f"rank {i} disagrees", r["losses"])
    rel = abs(losses[0] - single_losses[0]) / abs(single_losses[0])
    want = fsdp_closed_form(cfg, 2, 2)
    tag = "[densetrain mesh]"
    log(f"{tag} {cfg.name} {cfg.n_layers} layers, (data 2, model 2), "
        f"fsdp_params, adamw, 4 gloo ranks on one card: losses {losses}; "
        f"step 0 vs one card {single_losses[0]}: rel {rel:.3e} (<= "
        f"{MESHTRAIN_RTOL:.0e}); FSDP words a rank a step, closed form "
        f"{want}")
    assert rel <= MESHTRAIN_RTOL, (losses[0], single_losses[0])
    for i, r in enumerate(ranks):
        for s, step in enumerate(r["words"]):
            got = {k: step["loss_backward"].get(k, 0) for k in want}
            assert got == want, (i, s, got, want)
        log(f"{tag} rank {i}: s per step {r['step_s']}; words the last step "
            f"by phase {r['words'][-1]}, bytes {r['bytes'][-1]}; peak memory"
            f" {r['peak_memory_bytes'] / 2**30:.2f} GiB; launches "
            f"{r['kernel_launches']}")
    r0 = ranks[0]
    for s, (t, sp) in enumerate(zip(r0["step_s"], r0["split_s"])):
        log(f"{tag} step {s}{' (warm-up)' if s == 0 else ''}: {t:.4f} s = "
            f"loss+backward {sp['loss_backward_s']:.4f} + reduce "
            f"{sp['reduce_s']:.4f} + clip {sp['clip_s']:.4f} + optimizer "
            f"{sp['opt_s']:.4f} (rank 0)")
    launches = {}
    for r in ranks:
        for k, v in r["kernel_launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"losses": losses, "rel_step0": rel, "fsdp_words": want,
            "step_s": [r["step_s"] for r in ranks], "split_s": r0["split_s"],
            "words": _kinds(r0["words"]), "bytes": _kinds(r0["bytes"]),
            "peak_memory_bytes": [r["peak_memory_bytes"] for r in ranks],
            "wall_s": out["wall_s"]}, launches


def densetrain_phase(torch, mesh_run, wall, cases, early):
    """Phase 21: each dense family trained at full width on the card
    (``DENSETRAIN``, gemma2 first); gemma2's first loss against the
    CPU's, on a thread beside the symmetric kernels at the new training
    shapes against their plain versions, timed (rows added to
    ``cases``); gemma2 on (data 2, model 2) with ``fsdp_params``
    (``mesh_run``: its flags and ranks' results from phase 13's launch,
    ``wall`` that launch's seconds) against the one-card run.  The Muon
    NS at every new Gram width against the f64 iteration ran beside
    phase 8's launch (``early_checks``; ``early`` its results)."""
    import dataclasses

    from repro_torch.configs import get_config
    seconds = {"ns_s (beside phase 8)": early["ns_s"]}
    rows, launches = {}, {}
    cpu = None
    for arch, (layers, optimizer) in DENSETRAIN.items():
        t1 = time.perf_counter()
        if arch == "musicgen-large":
            rows[arch], launches[arch] = musicgen_train(torch, layers,
                                                        optimizer)
        else:
            rows[arch], launches[arch], kept = dense_train(
                torch, arch, layers, optimizer)
        seconds[arch] = time.perf_counter() - t1
        if arch == DENSEMESH_ARCH:
            # its CPU loss (host cores) beside the kernel rows (the card)
            cfg = dataclasses.replace(get_config(DENSEMESH_ARCH),
                                      n_layers=DENSEMESH_LAYERS)
            cpu = in_background(seconds, "cpu_s", dense_cpu_loss, torch,
                                cfg, kept, rows[arch]["losses"][0])
            del kept
            t1 = time.perf_counter()
            dense_kernel_rows(torch, cases)
            seconds["kernels_s"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            cpu = cpu()
            seconds["cpu_wait_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    mesh, mlaunches = densemesh_check(torch, mesh_run, wall,
                                      rows[DENSEMESH_ARCH]["losses"])
    seconds["mesh_s"] = time.perf_counter() - t1
    log(f"[densetrain] phase seconds {json.dumps(seconds)}")
    return {"muon_ns": early["muon_ns"], "runs": rows, "cpu_loss": cpu,
            "mesh": mesh, **seconds}, launches, mlaunches


# --------------------------------------------------------------------------
# phase 22: train jamba-v0.1-52b at full width on one card
# --------------------------------------------------------------------------
#: layers 2-3 of jamba's period, (Mamba + dense MLP, attention + MoE
#: MLP): every block kind of the pattern at its published width (d_model
#: 4096, 16 experts of d_ff 14336, vocab 65536), ~3.7e9 parameters; one
#: period (8 layers, ~1.3e10) does not fit the card under Muon's ~22
#: bytes a parameter
JAMBATRAIN_LAYERS = slice(2, 4)
#: a warm-up step and 1 timed (a second timed step would cost what the
#: mesh part takes), 2 x 256 tokens: 512 tokens a layer, above
#: ``moe.GATHER_MAX_TOKENS``, so the MoE runs the capacity form
JAMBATRAIN_STEPS, JAMBATRAIN_BATCH = 2, 2
#: the NS products of the (1, 16, 4096, 14336) expert stacks (wi, wg,
#: and wo on its short side): the Gram and sym(Y)·X, and S·S at 4096
JAMBA_KERNEL_SHAPES = (("jamba expert stack", 16, 4096, 14336),
                       ("jamba expert stack", 16, 4096, 4096))
#: one full-width MoE layer's gradients, ``CapacityExperts`` against
#: autograd of the plain capacity forward: T tokens (> 256: capacity),
#: a router skewed toward expert 0, so that its window drops rows
JAMBA_MOE_TOKENS = 512
#: bf16 ulps of a gradient's largest entry (tests/test_torch_jamba.py)
JAMBA_GRAD_ULPS = 4


def _jamba_train_cfg():
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config("jamba-v0.1-52b")
    pattern = cfg.pattern[JAMBATRAIN_LAYERS]
    return dataclasses.replace(cfg, n_layers=len(pattern), pattern=pattern)


def _plain_capacity(torch, moe, layer, cfg, xf):
    """The capacity form with autograd through each expert's products
    and the windows' assembly (no ``CapacityExperts``), plus the shared
    experts where the config has them: the oracle of its backward."""
    mo = cfg.moe
    t, d = xf.shape
    k, e = mo.top_k, mo.n_experts
    topg, tope = moe._route(layer.router, xf, k)
    act = moe.act_fn(cfg.act)
    _, inv, token_idx, group_sizes = moe._sort_by_expert(tope, e)
    xs = xf[token_idx]
    cap = moe._capacity(t * k, e)
    sizes = group_sizes.tolist()
    offsets = [sum(sizes[:i]) for i in range(e)]
    rows = []
    for i, (o, n) in enumerate(zip(offsets, sizes)):
        n = min(n, cap)
        y = moe._expert_mm(act, xs[o:o + n], layer.wi[i], layer.wg[i],
                           layer.wo[i]).float()
        rows.append(torch.nn.functional.pad(y, (0, 0, 0, cap - n)))
    windows = torch.cat(rows + [xf.new_zeros((1, d), dtype=torch.float32)])
    idx = moe._window_index(torch.tensor(offsets, device=xf.device), t * k,
                            e, cap)
    y = windows[idx[inv]].reshape(t, k, d)
    dropped = int((idx >= e * cap).sum())
    out = torch.einsum("tkd,tk->td", y, topg.to(y.dtype)).to(xf.dtype)
    if mo.n_shared:
        out = out + layer.shared(xf)
    return out, dropped


def moe_layer_grads(torch, cfg, tag="[jambatrain]"):
    """One MoE layer of ``cfg`` at full width (jamba's: 16 experts of
    (4096, 14336), top-2; deepseek-v2's: 160 of (5120, 1536), top-6, and
    2 shared), ``JAMBA_MOE_TOKENS`` tokens with a mean that, against a
    router column raised for expert 0, sends every token's first choice
    there: its window of ``_capacity`` rows drops the rest.  The
    gradients of the input, the router, the three expert stacks and the
    shared experts' weights through ``CapacityExperts`` against autograd
    of ``_plain_capacity``, the same cotangent: each within
    ``JAMBA_GRAD_ULPS`` bf16 ulps of its largest entry; the outputs
    bit-equal; both timed."""
    from repro_torch.models import moe
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(43)
    layer = moe.MoE(cfg, gen, dev)
    t, d = JAMBA_MOE_TOKENS, cfg.d_model
    with torch.no_grad():           # expert 0's logit ~ +10 a token
        layer.router[:, 0] += 20.0 / d
    x = (torch.randn(t, d, generator=gen, device=dev) + 0.5).to(
        torch.bfloat16)
    g = torch.randn(t, d, generator=gen, device=dev)
    names = ("x", "router", "wi", "wg", "wo") + (
        ("shared.wi", "shared.wg", "shared.wo") if cfg.moe.n_shared else ())
    grads, outs, secs = {}, {}, {}
    # each form twice, the second timed (the first meets cold kernels)
    for how in ("function", "plain") * 2:
        grads.pop(how, None)
        layer.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if how == "function":
            y = moe.moe_local(cfg, layer, xi, impl="capacity")
        else:
            y, dropped = _plain_capacity(torch, moe, layer, cfg, xi)
        (y.float() * g).sum().backward()
        torch.cuda.synchronize()
        secs[how] = time.perf_counter() - t0
        outs[how] = y.detach()
        grads[how] = [xi.grad] + [layer.get_parameter(n).grad
                                  for n in names[1:]]
    errs = {}
    for n, got, want in zip(names, grads["function"], grads["plain"]):
        err = float((got.float() - want.float()).abs().max())
        bound = JAMBA_GRAD_ULPS * 2.0 ** -8 * float(want.float().abs().max())
        errs[n] = (err, bound)
        ok = err <= bound and bool(torch.isfinite(got).all())
        log(f"{tag} MoE d {d}, {cfg.moe.n_experts} experts "
            f"({cfg.moe.n_shared} shared), T = {t}, {dropped} of "
            f"{t * cfg.moe.top_k} pairs dropped: d{n} {tuple(got.shape)} "
            f"CapacityExperts vs autograd of the plain capacity form: "
            f"max_abs_err {err:.3e} (bound {bound:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{cfg.name} MoE d{n}: the capacity backward "
                             "disagrees with autograd of the plain form")
    same = bool(torch.equal(outs["function"], outs["plain"]))
    log(f"{tag} MoE outputs bit-equal {same}; forward + backward s "
        f"(warm): CapacityExperts {secs['function']:.4f}, plain "
        f"{secs['plain']:.4f}")
    assert same and dropped > 0
    del layer, grads, outs
    torch.cuda.empty_cache()
    return {"tokens": t, "dropped_pairs": dropped,
            "errors": {n: {"max_abs_err": e, "bound": b}
                       for n, (e, b) in errs.items()}, "s": secs}


def jamba_remat_peaks(torch, model, cfg, batch):
    """One loss + backward of the trained model on ``batch`` under each
    remat policy, "names" (jamba's) and "full": the peak memory of each
    and their gradients bit for bit."""
    import dataclasses

    from repro_torch.models.model import lm_loss
    peaks, grads = {}, {}
    for policy in ("names", "full"):
        model.cfg = dataclasses.replace(cfg, remat_policy=policy)
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        lm_loss(model, batch, chunk=256).backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        peaks[policy] = {"peak_bytes": peak, "above_start_bytes": peak - base}
        grads[policy] = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
    model.cfg = cfg
    same = all(torch.equal(grads["names"][n], grads["full"][n])
               for n in grads["names"])
    text = "; ".join(
        f"{k} {v['above_start_bytes'] / 2**30:.2f} GiB above the "
        f"{(v['peak_bytes'] - v['above_start_bytes']) / 2**30:.2f} held "
        "at its start" for k, v in peaks.items())
    log(f"[jambatrain] loss + backward peak under each remat policy: {text}"
        f" (\"full\" second, \"names\"' gradients held); gradients "
        f"bit-equal {same}")
    assert same
    return peaks


def jambatrain_phase(torch, cases, early, mesh_part):
    """Phase 22: jamba's layers 2-3 (``_jamba_train_cfg``) trained
    through the trainer's ``_run`` with ``muon-syrk``, random bf16
    weights from seed 0, 2 x 256 tokens, a warm-up and 1 timed step:
    finite losses, the launches the closed form, every NS SYRK / SYMM
    with n1 >= 256 on the kernels, s a step and its split, peak memory
    under the card's; the peaks of a loss + backward under "names" and
    "full" with their gradients bit-equal; the first loss against the
    same weights on the CPU, on a thread beside ``rank_update`` /
    ``sym_stream`` at the expert stacks' NS shapes against their plain
    versions and f64, timed (rows added to ``cases``).  The mesh part
    (``mesh_part``: the jamba part's ranks and seconds, run beside the
    build, ``train_mesh_parts``), the same layers on (data 1, model 2),
    is held to the one-card step 0 (``mesh_part_check``).  The NS of a
    (16, 4096, 14336) expert stack against the f64 iteration and one
    MoE layer's gradients through ``CapacityExperts`` against autograd
    of the plain capacity form ran beside phase 8's launch
    (``early_checks``; ``early`` their results)."""
    import gc

    from repro_torch.launch import train as ttrain
    gc.collect()
    torch.cuda.empty_cache()
    cfg = _jamba_train_cfg()
    seconds = {f"{k} (beside phase 8)": early[k]
               for k in ("ns_s", "moe_grads_s")}
    t0 = time.perf_counter()
    kept, init = {}, ttrain.init_model

    def keep(cfg, seed, device, **kw):
        model = init(cfg, seed=seed, device=device, **kw)
        kept["cpu"] = {k: v.detach().to("cpu", copy=True)
                       for k, v in model.state_dict().items()}
        kept["model"] = model
        return model

    args = ttrain.build_argparser().parse_args(
        _dense_argv("jamba-v0.1-52b", cfg.n_layers, "muon-syrk",
                    JAMBATRAIN_STEPS) + ["--device", DEVICE])
    ttrain.init_model = keep
    try:
        out = ttrain._run(args, cfg, torch.device(DEVICE))
    finally:
        ttrain.init_model = init
    seconds["train_s"] = time.perf_counter() - t0
    launches = out["kernel_launches"]
    want = muon_launches(cfg, JAMBATRAIN_STEPS)
    tag = "[jambatrain]"
    assert_kernel_routes(out, launches, tag)
    row = _dense_report(torch, tag, cfg, out, launches, want)
    from repro_torch.data import DataConfig, make_train_iterator
    it = make_train_iterator(DataConfig(
        seq_len=256, global_batch=JAMBATRAIN_BATCH, vocab_size=cfg.vocab,
        seed=0), device=DEVICE)
    try:
        batch = next(it)
    finally:
        it.close()
    t0 = time.perf_counter()
    row["remat_peaks"] = jamba_remat_peaks(torch, kept.pop("model"), cfg,
                                           batch)
    seconds["remat_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    # the CPU's first loss (host cores) beside the kernel rows (the card)
    cpu = in_background(seconds, "cpu_s", dense_cpu_loss, torch, cfg,
                        kept.pop("cpu"), out["losses"][0], tag)
    t0 = time.perf_counter()
    dense_kernel_rows(torch, cases, JAMBA_KERNEL_SHAPES[:1], ("syrk", "symm"),
                      tag)
    dense_kernel_rows(torch, cases, JAMBA_KERNEL_SHAPES[1:], ("ss",), tag)
    seconds["kernels_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = cpu()
    seconds["cpu_wait_s"] = time.perf_counter() - t0
    mesh, mlaunches = mesh_part_check(torch, "jamba", *mesh_part,
                                      out["losses"][0])
    log(f"{tag} phase seconds {json.dumps(seconds)}")
    return {"muon_ns": early["muon_ns"], "moe_grads": early["moe_grads"],
            "run": row, "cpu_loss": cpu, "mesh": mesh, **seconds}, \
        launches, mlaunches


#: the train phases' mesh parts: each phase's cut on (data 1, model 2), 2
#: gloo ranks sharing the card (each draws the whole model, ~7.4 GB, then
#: keeps its blocks), AdamW, the phase's 2 x 256 tokens, a warm-up and 1
#: timed step: jamba's layers 2-3 for phase 22, deepseek-v3's first 2
#: prefix blocks and its MTP block for phase 23, one launch for both, run
#: beside the build (``train_mesh_parts``)
MESHPART_DEVICES, MESHPART_MAX_MODEL, MESHPART_STEPS = 2, 2, 2
#: step 0's loss against the one-card run's, relative (phase 13's
#: ``MESHTRAIN_RTOL``; the CPU tests' top-2 gap on (1, 2) was 1.9e-5,
#: tests/test_torch_jamba_mesh.py)
MESHPART_RTOL = 1e-4
#: the mesh parts in the order their ranks run them
MESHPARTS = ("jamba", "deepseek")


def _meshpart_args(part):
    from repro_torch.launch.train import build_argparser
    arch, layers = {"jamba": ("jamba-v0.1-52b", 2),
                    "deepseek": ("deepseek-v3-671b",
                                 DEEPSEEKTRAIN_PREFIX)}[part]
    return build_argparser().parse_args(
        _dense_argv(arch, layers, "adamw", MESHPART_STEPS) + [
            "--device", DEVICE, "--devices", str(MESHPART_DEVICES),
            "--max-model", str(MESHPART_MAX_MODEL)])


def _meshpart_cfg(part):
    return {"jamba": _jamba_train_cfg,
            "deepseek": _deepseek_train_cfg}[part]()


def mesh_part_rank(mesh_x, flags, go):
    """One rank of the train phases' mesh launch: once the file ``go``
    says "go", for each of ``MESHPARTS`` in turn, ``launch.train._run``
    of the part's cut (``flags[part]``) on the planned (data 1, model 2)
    mesh, what ``train_rank`` runs for a config the flags name; each
    part's result is written to ``go + ".<part>.<rank>"`` for the main
    process to read while the ranks go on, and its model and optimizer
    are freed before the next part.  The ranks start early (their
    imports, the group and the remat preload) and touch the card's
    memory only once released; anything but "go" ends them."""
    import argparse
    import gc
    import pickle

    import torch
    from repro_torch.distributed import plan_mesh
    from repro_torch.launch import train as ttrain
    from repro_torch.models.model import preload_remat
    mesh = plan_mesh(max_model=MESHPART_MAX_MODEL, device=mesh_x.device)
    preload_remat().join()
    t0 = time.perf_counter()
    while not os.path.exists(go):
        time.sleep(0.05)
    waited = time.perf_counter() - t0
    with open(go) as f:
        if f.read() != "go":
            return None
    for part in MESHPARTS:
        args = argparse.Namespace(**flags[part])
        t0 = time.perf_counter()
        drawn, init = {}, ttrain.init_model

        def keep(cfg, seed, device, **kw):
            model = init(cfg, seed=seed, device=device, **kw)
            drawn["peak_bytes"] = torch.cuda.max_memory_allocated(device)
            drawn["s"] = time.perf_counter() - t0
            return model

        torch.cuda.reset_peak_memory_stats(mesh.device)
        ttrain.init_model = keep
        try:
            out = ttrain._run(args, _meshpart_cfg(part), mesh.device,
                              mesh=mesh, say=lambda line: None)
        finally:
            ttrain.init_model = init
        keys = ("losses", "words", "bytes", "step_s", "split_s",
                "kernel_launches", "peak_memory_bytes", "params", "mesh",
                "tokens_per_s")
        res = {**{k: out[k] for k in keys}, "waited_s": waited,
               "run_s": time.perf_counter() - t0, "draw": drawn}
        del out
        gc.collect()
        torch.cuda.empty_cache()
        res["held_after_bytes"] = torch.cuda.memory_reserved(mesh.device)
        path = f"{go}.{part}.{mesh.rank}"
        with open(path + ".tmp", "wb") as f:
            pickle.dump(res, f)
        os.replace(path + ".tmp", path)
        waited = 0.0
    return "done"


class TrainMesh:
    """The train phases' mesh launch, started on a thread, its ranks
    waiting; ``release`` lets them run every part, ``results(part)``
    waits for that part's results and returns them with the seconds
    from the release; ``stop`` lets them end (before the release, at
    once) and joins the launch."""

    def __init__(self, phase_s):
        import tempfile
        from repro_torch.distributed.launch import run_ranks
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_trainmesh_")
        self.go = os.path.join(self.dir, "go")
        self.args = {part: _meshpart_args(part) for part in MESHPARTS}
        self.t0 = None
        self.join = in_background(
            phase_s, "train mesh launch", lambda: run_ranks(
                "chip_smoke:mesh_part_rank", MESHPART_DEVICES,
                backend="gloo", device=DEVICE, paths=[ROOT], timeout=1200,
                kwargs={"flags": {p: dict(vars(a))
                                  for p, a in self.args.items()},
                        "go": self.go}))

    def _signal(self, word):
        if not os.path.exists(self.go):
            with open(self.go + ".tmp", "w") as f:
                f.write(word)
            os.replace(self.go + ".tmp", self.go)

    def release(self):
        self._signal("go")
        self.t0 = time.perf_counter()

    def results(self, part):
        import pickle
        paths = [f"{self.go}.{part}.{r}" for r in range(MESHPART_DEVICES)]
        while not all(map(os.path.exists, paths)):
            if not self.join.alive():
                self.join()             # the launch's failure, raised
                raise SystemExit(f"the mesh launch ended before its "
                                 f"{part} part")
            time.sleep(0.05)
        wall = time.perf_counter() - self.t0
        ranks = []
        for path in paths:
            with open(path, "rb") as f:
                ranks.append(pickle.load(f))
        return ranks, wall

    def stop(self):
        import shutil
        if not os.path.isdir(self.dir):         # stopped already
            return
        self._signal("stop")
        try:
            self.join()
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)


def train_mesh_parts(torch, tmesh):
    """Every mesh part's results (``TrainMesh.results``), the launch
    then stopped, so that its ranks have left the card before phase 3
    times the kernels."""
    try:
        return {part: tmesh.results(part) for part in MESHPARTS}
    finally:
        tmesh.stop()


def _ar_words(n, P):
    """The words of one all-reduce of n elements over P ranks, as
    ``collectives.all_reduce`` counts them."""
    return 2 * n * (P - 1) // P


def _loss_tp_words(cfg, tokens, P, seq, chunk) -> int:
    """The vocab-parallel loss's all-reduce words, chunk by chunk, of
    each head (next-token, and the MTP block's t+2 with ``cfg.mtp``):
    its max, sum of exponentials and label logit forward and in the
    chunk's recompute, its input's gradient backward."""
    n = max(seq // chunk, 1)
    per = tokens // seq * (seq // n)
    heads = 2 if cfg.mtp else 1
    return heads * n * (2 * 3 * _ar_words(per, P)
                        + _ar_words(per * cfg.d_model, P))


def jamba_tp_closed_form(cfg, tokens, P, seq, chunk) -> int:
    """A rank's loss + backward all-reduce words a step on (data 1,
    model P), ``tokens`` a step (tests/test_torch_jamba_mesh.py holds
    the same count on gloo CPU ranks): the vocab-parallel embed rows; in
    each block the mixer's and the MLP's exit sums forward (Mamba also
    its x_proj sum), their ``copy_to_group`` gradients backward (the
    block's input, Mamba's projection and three per-channel vectors, the
    MoE's router); each forward sum again in the per-period recompute
    but for the period's last exit (the non-reentrant checkpoint stops
    at the last tensor the backward needs); the vocab-parallel loss
    (:func:`_loss_tp_words`)."""
    def ar(n):
        return _ar_words(n, P)
    d, T = cfg.d_model, tokens
    di = cfg.mamba_expand * d
    R = max(d // 16, 1) + 2 * cfg.mamba_d_state
    words = ar(T * d)
    for _ in range(cfg.n_periods):
        fwd, bwd = [], []
        for spec in cfg.pattern:
            if spec.mixer == "mamba":
                fwd += [ar(T * R), ar(T * d)]
                bwd += [ar(T * d), ar(T * R)] + [ar(di)] * 3
            else:
                fwd += [ar(T * d)]
                bwd += [ar(T * d)]
            fwd += [ar(T * d)]
            bwd += [ar(T * d)]
            if spec.mlp == "moe":
                bwd += [ar(d * cfg.moe.n_experts)]
        words += 2 * sum(fwd) - fwd[-1] + sum(bwd)
    return words + _loss_tp_words(cfg, tokens, P, seq, chunk)


def deepseek_tp_closed_form(cfg, tokens, P, seq, chunk) -> dict:
    """A rank's loss + backward words a step by kind on (data 1, model
    P) for a deepseek config (MLA in every block), ``tokens`` a step
    (tests/test_torch_deepseek_mesh.py holds it on gloo CPU ranks, the
    card's cut included).  In every block: the MLA latents (q's
    ``q_lora`` columns where the config has them, ``ckv``'s ``kv_lora``,
    the rope key's ``rope_head_dim``) each all-gathered forward from its
    rank's 1/P and its gradient reduce-scattered backward; the ``wo``
    and MLP exit sums forward, the block input's and the MLP input's
    ``copy_to_group`` gradients backward (an MoE MLP also its router's).
    The prefix blocks and the MTP block run once; a period's forward
    collectives run again in its recompute, but for its last exit sum
    (as :func:`jamba_tp_closed_form`).  Beside them the vocab-parallel
    embed rows and loss of both heads (:func:`_loss_tp_words`)."""
    def ar(n):
        return _ar_words(n, P)
    d, T, m = cfg.d_model, tokens, cfg.mla
    widths = [w for w in (m.q_lora, m.kv_lora, m.rope_head_dim) if w]
    gather = sum(T * w // P * (P - 1) for w in widths)
    scatter = sum(T * w * (P - 1) // P for w in widths)

    def sums(spec):
        bwd = [ar(T * d), ar(T * d)]
        if spec.mlp == "moe":
            bwd.append(ar(d * cfg.moe.n_experts))
        return [ar(T * d), ar(T * d)], bwd

    from repro_torch.models.model import MTP_SPEC
    once = list(cfg.prefix) + [MTP_SPEC] * bool(cfg.mtp)
    words = {"all_reduce": ar(T * d), "all_gather": gather * len(once),
             "reduce_scatter": scatter * len(once)}
    for spec in once:
        fwd, bwd = sums(spec)
        words["all_reduce"] += sum(fwd) + sum(bwd)
    for _ in range(cfg.n_periods):
        fwd, bwd = [], []
        for spec in cfg.pattern:
            f, b = sums(spec)
            fwd, bwd = fwd + f, bwd + b
        words["all_reduce"] += 2 * sum(fwd) - fwd[-1] + sum(bwd)
        words["all_gather"] += 2 * gather * len(cfg.pattern)
        words["reduce_scatter"] += scatter * len(cfg.pattern)
    words["all_reduce"] += _loss_tp_words(cfg, tokens, P, seq, chunk)
    return words


def mesh_words_forecast(cfg) -> dict:
    """Closed forms, from the shapes and specs alone, of what the mesh
    would move at full width under Muon and ZeRO-3 (ROADMAP B10, B11):
    each matrix leaf's Muon route on (data 1, model 2)
    (``Muon.shard_route`` on its ``fsdp_params`` spec: every split leaf
    names 'data', so all are gathered) and its words a rank a step,
    beside the 1D schedule's words where the spec without 'data' would
    take it; and ZeRO-3's loss + backward words a rank a step on
    (data 2, model 2) (``fsdp_closed_form``)."""
    from repro_torch.core.packing import tril_size
    from repro_torch.distributed.mesh import planning_mesh
    from repro_torch.models.sharding import param_specs
    from repro_torch.optim.muon import Muon
    shapes = _leaves(cfg)
    mesh = planning_mesh({"data": 1, "model": 2})
    specs = param_specs(cfg, shapes, mesh)
    opt = Muon(mode="syrk-1d", mesh=mesh, specs=specs)
    rows, P = {}, 2
    for k, shape in shapes.items():
        if len(shape) < 2 or min(shape[-2:]) < 8:
            continue
        spec = specs[k]
        local = tuple(n // (P if a == "model" else 1)
                      for n, a in zip(shape, spec))
        route = opt.shard_route(local, spec)
        whole = math.prod(shape)
        words = whole // P * (P - 1) if route == "gathered" else 0
        bare = tuple(None if a == "data" else a for a in spec)
        alt = opt.shard_route(local, bare)
        one_d = None
        if alt in ("1d", "1d-rows"):
            m = min(shape[-2:])
            lead = math.prod(shape[:-2])
            lp = lead * (-(-tril_size(m) // P) * P)
            one_d = 5 * (lp * (P - 1) // P + lp // P * (P - 1)) \
                + 2 * lead * (P - 1) // P
        rows["/".join(k)] = {"route": route, "words": words,
                             "without_data": alt, "words_1d": one_d}
    return {"muon_1x2": rows,
            "muon_1x2_total": sum(r["words"] for r in rows.values()),
            "zero3_2x2": fsdp_closed_form(cfg, 2, 2)}


def mesh_part_check(torch, part, ranks, wall, card_step0):
    """A train phase's mesh part against its one-card run: every rank's
    losses identical, step 0 within ``MESHPART_RTOL`` of the one-card
    step 0 (same weights, same batch), each rank's loss + backward words
    a step the tensor-parallel closed form (no other kind: 'data' is 1),
    no symmetric-kernel launch (AdamW); prints s a step and its split,
    tokens/s, each rank's peak (and what it held while drawing) and the
    seconds from the release to the last rank's result.  The parts ran
    beside the build, while this process held nothing of the card
    (``train_mesh_parts``)."""
    cfg = _meshpart_cfg(part)
    args = _meshpart_args(part)
    tag = f"[{part}train mesh]"
    losses = ranks[0]["losses"]
    assert ranks[0]["mesh"] == {"data": 1, "model": MESHPART_MAX_MODEL}
    assert len(losses) == MESHPART_STEPS and \
        all(map(math.isfinite, losses)), losses
    for i, r in enumerate(ranks):
        assert r["losses"] == losses, (f"rank {i} disagrees", r["losses"])
    rel = abs(losses[0] - card_step0) / abs(card_step0)
    tokens = args.global_batch * args.seq_len
    if part == "jamba":
        want = {"all_reduce": jamba_tp_closed_form(
            cfg, tokens, MESHPART_MAX_MODEL, args.seq_len, args.loss_chunk)}
        what = "layers 2-3"
    else:
        want = deepseek_tp_closed_form(cfg, tokens, MESHPART_MAX_MODEL,
                                       args.seq_len, args.loss_chunk)
        what = f"prefix 0-{cfg.n_layers - 1} + MTP"
    log(f"{tag} {cfg.name} {what}, {ranks[0]['params']} parameters, "
        f"(data 1, model {MESHPART_MAX_MODEL}), adamw, "
        f"{MESHPART_DEVICES} gloo ranks on one card: losses {losses}; "
        f"step 0 vs one card {card_step0}: rel {rel:.3e} (<= "
        f"{MESHPART_RTOL:.0e}); tensor-parallel words a rank a step, "
        f"closed form {want}")
    assert rel <= MESHPART_RTOL, (losses[0], card_step0)
    launches = {}
    for i, r in enumerate(ranks):
        for s, step in enumerate(r["words"]):
            assert step["loss_backward"] == want, (i, s, step, want)
        assert not r["kernel_launches"]["rank_update"] and \
            not r["kernel_launches"]["sym_stream"], r["kernel_launches"]
        for k, v in r["kernel_launches"].items():
            launches[k] = launches.get(k, 0) + v
        log(f"{tag} rank {i}: waited {r['waited_s']:.1f} s for the card, "
            f"drew and sharded in {r['draw']['s']:.2f} s (peak "
            f"{r['draw']['peak_bytes'] / 2**30:.2f} GiB), ran in "
            f"{r['run_s']:.2f} s; s per step {r['step_s']}; peak memory "
            f"{r['peak_memory_bytes'] / 2**30:.2f} GiB; held "
            f"{r['held_after_bytes'] / 2**30:.2f} GiB after it; words the "
            f"last step by phase {r['words'][-1]}, bytes {r['bytes'][-1]}; "
            f"launches {r['kernel_launches']}")
    r0 = ranks[0]
    for s, (t, sp) in enumerate(zip(r0["step_s"], r0["split_s"])):
        log(f"{tag} step {s}{' (warm-up)' if s == 0 else ''}: {t:.4f} s = "
            f"loss+backward {sp['loss_backward_s']:.4f} + reduce "
            f"{sp['reduce_s']:.4f} + clip {sp['clip_s']:.4f} + optimizer "
            f"{sp['opt_s']:.4f} (rank 0)")
    log(f"{tag} tokens/s {r0['tokens_per_s']:.1f} (after the warm-up); "
        f"seconds from the release (with the build) to the last rank's "
        f"result: {wall:.1f}")
    forecast = mesh_words_forecast(cfg)
    if part == "deepseek":       # the full cut's latents on (2, 2) too
        forecast["tp_2x2"] = deepseek_tp_closed_form(
            cfg, tokens // 2, 2, args.seq_len, args.loss_chunk)
    log(f"{tag} closed forms at this width, not run (ROADMAP B10, B11): "
        f"{json.dumps(forecast)}")
    return {"losses": losses, "rel_step0": rel, "tp_words": want,
            "step_s": [r["step_s"] for r in ranks], "split_s": r0["split_s"],
            "tokens_per_s": r0["tokens_per_s"],
            "peak_memory_bytes": [r["peak_memory_bytes"] for r in ranks],
            "draw_peak_bytes": [r["draw"]["peak_bytes"] for r in ranks],
            "waited_s": [r["waited_s"] for r in ranks],
            "run_s": [r["run_s"] for r in ranks], "release_s": wall,
            "closed_forms": forecast}, launches


def early_checks(torch):
    """The checks of phases 21-23 that use the card but time nothing of
    it, run beside phase 8's gloo launch (``mesh_phase``'s ``beside``):
    the Muon NS at phase 21's new Gram widths (``MUON_WIDTHS``), of a
    (16, 4096, 14336) expert stack and of deepseek-v3's (7168, 129280)
    embedding and (7168, 18432) MLP leaf against the f64 iteration, and
    one jamba MoE layer's gradients through ``CapacityExperts`` against
    autograd of the plain capacity form (their host seconds, beside the
    launch, are not the kernels' times).  Returns each phase's results
    and seconds."""
    cfg = _jamba_train_cfg()
    assert [(b.mixer, b.mlp) for b in cfg.pattern] == [
        ("mamba", "dense"), ("attn", "moe")], cfg.pattern
    assert (cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert,
            cfg.vocab, cfg.remat_policy) == (4096, 16, 14336, 65536,
                                             "names")
    t0 = time.perf_counter()
    dense = {"muon_ns": [muon_f64_check(torch, n1, n2)
                         for n1, n2 in MUON_WIDTHS]}
    dense["ns_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    jamba = {"muon_ns": muon_f64_check(torch, 4096, 14336, stack=(16,),
                                       tag="[jambatrain]")}
    jamba["ns_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    jamba["moe_grads"] = moe_layer_grads(torch, cfg)
    jamba["moe_grads_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    deepseek = {"muon_ns": [muon_f64_check(torch, 7168, n2,
                                           tag="[deepseektrain]")
                            for n2 in (129280, 18432)]}
    deepseek["ns_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return {"densetrain": dense, "jambatrain": jamba,
            "deepseektrain": deepseek}


# --------------------------------------------------------------------------
# phase 23: train deepseek-v3-671b at full width on one card
# --------------------------------------------------------------------------
#: deepseek-v3 cut to its first 2 of 3 dense prefix blocks, none of its 58
#: MoE layers (no periods) and the MTP block: MLA with q_lora, the prefix
#: blocks and the MTP term at d_model 7168, vocab 129280, ~3.60e9
#: parameters.  All 3 prefix blocks (~4.19e9) fit only with ~2 GiB to
#: spare under Muon's ~19 bytes a parameter, and any cut with an MoE
#: layer (the prefix and one: ~1.57e10) not at all
DEEPSEEKTRAIN_PREFIX = 2
#: a warm-up step and 2 timed, 2 x 256 tokens
DEEPSEEKTRAIN_STEPS = 3
#: the Muon NS shapes the cut adds (label, stack, n1, n2): the Gram and
#: sym(Y)·X of each; S·S at 7168 is phase 3's deepseek NS product
DEEPSEEK_KERNEL_SHAPES = (("deepseek-v3 embedding", 1, 7168, 129280),
                          ("deepseek-v3 MLP wi / wg / wo", 1, 7168, 18432),
                          ("deepseek-v3 MLA wo", 1, 7168, 16384),
                          ("deepseek-v3 MLA w_uq", 1, 1536, 24576),
                          ("deepseek-v3 MLA w_dq", 1, 1536, 7168),
                          ("deepseek-v3 MLA w_uk / w_uv", 1, 512, 16384),
                          ("deepseek-v3 MLA w_dkv", 1, 512, 7168))
DEEPSEEK_SS_SHAPES = (("deepseek-v3 MLA", 1, 1536, 1536),
                      ("deepseek-v3 MLA", 1, 512, 512))
#: the MoE layer whose backward runs at full width: deepseek-v2's (160
#: experts of (5120, 1536), 2 shared, top-6: ~7.6 GB of weights, ~23 GB
#: with both forms' gradients); deepseek-v3's (256 of (7168, 2048),
#: 1.13e10 parameters) would need ~68 GB for the same check
DEEPSEEK_MOE_ARCH = "deepseek-v2-236b"


def _deepseek_train_cfg():
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v3-671b")
    prefix = cfg.prefix[:DEEPSEEKTRAIN_PREFIX]
    cfg = dataclasses.replace(cfg, n_layers=len(prefix), prefix=prefix)
    assert (cfg.n_periods, cfg.mtp, cfg.attn_kind, cfg.mla.q_lora,
            cfg.d_model, cfg.d_ff, cfg.vocab) == (0, True, "mla", 1536, 7168,
                                                  18432, 129280), cfg
    # 29 Muon matrices on the kernels: 9 a block (2 prefix, the MTP
    # block; w_kr's short side, 64, routes dense), embed and unembed
    assert muon_launches(cfg, 1)["rank_update"] == 29 * 5
    return cfg


def deepseektrain_phase(torch, cases, early, mesh_part):
    """Phase 23: deepseek-v3's first 2 prefix blocks and its MTP block
    (``_deepseek_train_cfg``) trained through the trainer's ``_run`` with
    ``muon-syrk``, random bf16 weights from seed 0, 2 x 256 tokens, a
    warm-up and 2 timed steps: finite, falling losses, the launches the
    closed form, every NS SYRK / SYMM with n1 >= 256 on the kernels, s a
    step and its split, peak memory under the card's.  Then, while the
    first loss is recomputed from the same weights on the CPU on a
    thread, ``rank_update`` / ``sym_stream`` at the cut's NS shapes
    against f64, timed (rows added to ``cases``), and one deepseek-v2
    MoE layer's gradients (shared experts included) through
    ``CapacityExperts`` against autograd of the plain capacity form.
    The NS of the embedding and of an MLP leaf against the f64
    iteration ran beside phase 8's launch (``early_checks``; ``early``
    their results).  The mesh part (``mesh_part``: the deepseek part's
    ranks and seconds, run by phase 22's ranks beside the build after
    jamba's part, ``train_mesh_parts``), the same cut on (data 1, model
    2), is held to the one-card step 0 (``mesh_part_check``)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch import train as ttrain
    gc.collect()
    torch.cuda.empty_cache()
    cfg = _deepseek_train_cfg()
    tag = "[deepseektrain]"
    seconds = {"ns_s (beside phase 8)": early["ns_s"]}
    t0 = time.perf_counter()
    kept, init = {}, ttrain.init_model

    def keep(cfg, seed, device, **kw):
        model = init(cfg, seed=seed, device=device, **kw)
        kept["cpu"] = {k: v.detach().to("cpu", copy=True)
                       for k, v in model.state_dict().items()}
        return model

    args = ttrain.build_argparser().parse_args(
        _dense_argv("deepseek-v3-671b", cfg.n_layers, "muon-syrk",
                    DEEPSEEKTRAIN_STEPS) + ["--device", DEVICE])
    ttrain.init_model = keep
    try:
        out = ttrain._run(args, cfg, torch.device(DEVICE))
    finally:
        ttrain.init_model = init
    seconds["train_s"] = time.perf_counter() - t0
    launches = out["kernel_launches"]
    want = muon_launches(cfg, DEEPSEEKTRAIN_STEPS)
    assert_kernel_routes(out, launches, tag)
    row = _dense_report(torch, tag, cfg, out, launches, want)
    assert out["losses"][-1] < out["losses"][0], out["losses"]
    gc.collect()
    torch.cuda.empty_cache()
    # the CPU's first loss (host cores) beside the card's checks below
    cpu = in_background(seconds, "cpu_s", dense_cpu_loss, torch, cfg,
                        kept.pop("cpu"), out["losses"][0], tag)
    t0 = time.perf_counter()
    dense_kernel_rows(torch, cases, DEEPSEEK_KERNEL_SHAPES, ("syrk", "symm"),
                      tag)
    dense_kernel_rows(torch, cases, DEEPSEEK_SS_SHAPES, ("ss",), tag)
    seconds["kernels_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    moe_check = moe_layer_grads(torch, get_config(DEEPSEEK_MOE_ARCH), tag)
    seconds["moe_grads_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_loss = cpu()
    seconds["cpu_wait_s"] = time.perf_counter() - t0
    mesh, mlaunches = mesh_part_check(torch, "deepseek", *mesh_part,
                                      out["losses"][0])
    log(f"{tag} phase seconds {json.dumps(seconds)}")
    return {"muon_ns": early["muon_ns"], "moe_grads": moe_check, "run": row,
            "cpu_loss": cpu_loss, "mesh": mesh, **seconds}, launches, \
        mlaunches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import ieee_f32
    ieee_f32()
    t_start = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            phase_s[name] = round(time.perf_counter() - t0, 1)

    card, clock = timed("probe", probe, torch)
    import shutil
    import tempfile
    count_dir = tempfile.mkdtemp(prefix="chip_smoke_counts_")
    counters = start_shape_counts(count_dir)
    try:
        return run_phases(torch, timed, phase_s, t_start, card, clock,
                          counters)
    finally:
        for proc, _ in counters:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(count_dir, ignore_errors=True)


def in_background(phase_s, name, fn, *a):
    """Start ``fn(*a)`` on a thread, for a phase that only waits on
    processes of its own; its seconds go to ``phase_s[name]``.  Returns
    the join: ``fn``'s result, or its exception raised here (its
    ``alive()`` is whether the thread still runs)."""
    import threading
    box = {}

    def run():
        t0 = time.perf_counter()
        try:
            box["out"] = fn(*a)
        except BaseException as e:      # SystemExit of a failed check too
            box["error"] = e
        finally:
            phase_s[name] = round(time.perf_counter() - t0, 1)

    th = threading.Thread(target=run, name=name, daemon=True)
    th.start()

    def join():
        th.join()
        if "error" in box:
            raise box["error"]
        return box["out"]
    join.alive = th.is_alive
    return join


def run_phases(torch, timed, phase_s, t_start, card, clock, counters) -> int:
    """Phases 2-23 and the closing lines (``main`` starts phase 20's
    counting children first and stops them last)."""
    # the mesh parts of phases 22 and 23 (2 gloo ranks of ~31 GiB each)
    # run beside the build, while this process holds nothing of the card
    # (by phase 22 it pins ~11.6 GiB, and the ranks did not fit beside
    # it), and end before phase 3 times the kernels
    tmesh = TrainMesh(phase_s)
    try:
        free, total = torch.cuda.mem_get_info()
        log(f"[train mesh] released with this process holding "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; the "
            f"card {free / 2**30:.2f} of {total / 2**30:.2f} GiB free")
        tmesh.release()
        build_s = timed("build", build)
    except BaseException:
        tmesh.stop()
        raise
    parts = timed("train mesh", train_mesh_parts, torch, tmesh)
    cases = timed("kernels", kernel_phase, torch, clock)
    _, launches = timed("serve", serve_phase, torch)
    xout, xlaunches = timed("xlstm", xlstm_phase, torch)
    timed("check", check_phase, torch)
    tout, tlaunches = timed("train", train_phase, torch, cases)
    mout, mlaunches, gloo = timed(
        "mesh", mesh_phase, torch,
        lambda: in_background(phase_s, "early checks", early_checks, torch))
    early = mout.pop("beside")
    wout, wlaunches = timed("warm", warm_phase, torch)
    aout, alaunches = timed("faults", abft_phase, torch, gloo["abft"])
    single = timed("single", single_resume_depth, torch)
    pout, plaunches = timed("compress", compress_phase, torch, tout,
                            gloo["compress"])
    eout, elaunches, xrun, grun = timed("meshtrain", meshtrain_phase,
                                        torch, single)
    # phases 11 (c) and 14 each wait on their own trainer subprocesses
    # (one device; 4, then 2 gloo ranks): they run on threads, side by
    # side, while this thread runs the in-process resumes of phases 9
    # and 12 (c)
    recovery = in_background(phase_s, "recovery", recovery_phase, torch,
                             single)
    elastic = in_background(phase_s, "elastic", elastic_phase, torch,
                            single)
    cout, claunches = timed("ckpt", ckpt_phase, torch)
    pout["resume"] = timed("compress_resume", compress_resume, torch)
    lout, llaunches = elastic()
    rout, rlaunches = recovery()
    xtout, xtlaunches = timed("xlstmtrain", xlstm_train_phase, torch,
                              cases)
    xmout, xmlaunches, xslaunches = timed("xlstmmesh", xlstm_mesh_phase,
                                          torch, xrun, eout["launch_s"])
    jout, jlaunches = timed("jamba", jamba_phase, torch)
    dout, dlaunches = timed("dense", dense_phase, torch)
    sout, slaunches = timed("deepseek", deepseek_phase, torch)
    hout, hlaunches = timed("shapes", shapes_phase, torch, counters, cases)
    tdout, tdlaunches, tdmesh = timed(
        "densetrain", densetrain_phase, torch, grun, eout["launch_s"],
        cases, early["densetrain"])
    jtout, jtlaunches, jtmesh = timed(
        "jambatrain", jambatrain_phase, torch, cases, early["jambatrain"],
        parts["jamba"])
    dtout, dtlaunches, dtmesh = timed(
        "deepseektrain", deepseektrain_phase, torch, cases,
        early["deepseektrain"], parts["deepseek"])
    log(f"[done] build {build_s:.2f} s, total "
        f"{time.perf_counter() - t_start:.1f} s; by phase "
        f"{json.dumps(phase_s)}")
    log(json.dumps({"xlstm_serve": {k: v for k, v in xout.items()
                                    if k not in ("cache",)}}))
    log(json.dumps({"train": tout}))
    log(json.dumps({"mesh": mout}))
    log(json.dumps({"ckpt": cout}))
    log(json.dumps({"warm": wout}))
    log(json.dumps({"abft": aout}))
    log(json.dumps({"recovery": rout}))
    log(json.dumps({"compress": pout}))
    log(json.dumps({"meshtrain": eout}))
    log(json.dumps({"elastic": lout}))
    log(json.dumps({"xlstm_train": xtout}))
    log(json.dumps({"xlstm_mesh": xmout}))
    log(json.dumps({"jamba_serve": {k: v for k, v in jout.items()
                                    if k not in ("cache",)}}))
    log(json.dumps({"dense": dout}))
    log(json.dumps({"deepseek": sout}))
    log(json.dumps({"shapes": hout}))
    log(json.dumps({"densetrain": tdout}))
    log(json.dumps({"jambatrain": jtout}))
    log(json.dumps({"deepseektrain": dtout}))

    kernels = []
    for name, rows in cases.items():
        [main_row] = [r for r in rows if r["main"]]
        by_path = {"stablelm-1.6b": launches[name],
                   "xlstm-350m": xlaunches[name],
                   "train stablelm-1.6b muon": tlaunches[name],
                   "mesh": mlaunches.get(name, 0),
                   "train resume stablelm-1.6b muon": claunches.get(name, 0),
                   "serve warm stablelm-1.6b": wlaunches[name],
                   "abft local": alaunches.get(name, 0),
                   "kill/resume stablelm-1.6b muon": rlaunches.get(name,
                                                                   0),
                   "train compressed stablelm-1.6b muon": plaunches[name],
                   "train mesh stablelm-1.6b muon-syrk": elaunches[name],
                   "elastic kill/resume stablelm-1.6b muon-syrk":
                   llaunches.get(name, 0),
                   "train xlstm-350m muon-syrk + adamw": xtlaunches[name],
                   "train xlstm-350m 8 layers muon-syrk (mesh oracle)":
                   xslaunches[name],
                   "train mesh xlstm-350m muon-syrk": xmlaunches[name],
                   "jamba-v0.1-52b 8 layers": jlaunches[name],
                   **{f"{arch} {n} layers": dlaunches[arch][name]
                      for arch, n in DENSE_LAYERS.items()},
                   "musicgen-large 48 layers, frames (no whitening)":
                   dlaunches["musicgen-large"][name],
                   **{f"{arch} {n} layers": slaunches[arch][name]
                      for arch, n in DEEPSEEK_LAYERS.items()},
                   **{f"shapes {row}": hlaunches[row][name]
                      for row in hlaunches},
                   **{f"train {arch} {n} layers {opt}"
                      + (", frames" if arch == "musicgen-large" else ""):
                      tdlaunches[arch][name]
                      for arch, (n, opt) in DENSETRAIN.items()},
                   f"train mesh {DENSEMESH_ARCH} {DENSEMESH_LAYERS} layers "
                   "adamw fsdp_params": tdmesh.get(name, 0),
                   "train jamba-v0.1-52b layers 2-3 muon-syrk":
                   jtlaunches[name],
                   "train mesh jamba-v0.1-52b layers 2-3 adamw":
                   jtmesh.get(name, 0),
                   "train deepseek-v3-671b prefix 0-1 + MTP muon-syrk":
                   dtlaunches[name],
                   "train mesh deepseek-v3-671b prefix 0-1 + MTP adamw":
                   dtmesh.get(name, 0)}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "ffma_bound_ms": main_row["ffma_bound_ms"],
            "library_ms": main_row["library_ms"],
            "shape": main_row["case"], "cases": rows})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--count-shapes"]:    # phase 20's counting child
        count_shape_rows(sys.argv[2], sys.argv[3:])
        sys.exit(0)
    sys.exit(main())
