#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. card: name and power limit, toolkit and torch versions;
2. build: compiles ``src/repro_torch/csrc/*.cu`` for sm_90a, one ``nvcc``
   per source, all at once, and prints ``ptxas -v``'s registers, shared
   memory and spills per kernel;
3. stream: the paper-calibrated query log (``SynthConfig``, the port's
   copy of ``repro.querylog.synth``) with its counts scaled by ``SCALE``:
   96 topics, 62% of requests topical, per-topic cores and Zipf(1.05)
   tails, a no-topic pool with 35% fresh singletons, daily topic bursts.
   The training prefix's statistics (``VecStats``, as the serving CLI
   plans) pick the 2**21 static keys and size the topic partitions; the
   requests after it are served.  The served topical share must match the
   config's.  Phases 3-6 use the generator's ground-truth topics;
4. warm: a 2**22-entry STD cache (f_s = 0.5, f_t = 0.4, W = 8, V = 8)
   behind a ``Broker`` on the card replays the training prefix's last
   ``N_WARM`` batches, so the LRU layers start warm (the paper's
   train-warm / test-measure protocol);
5. serve: the served requests in batches of 4096 through the one-call
   path; every served value must equal the backend's, with one
   ``one_call`` dispatch and one serve-kernel launch per batch, and the
   set-associative layers must answer at least ``MIN_SET_ASSOC_SHARE`` of
   the requests.  Then the same batches through ``fused_one_call=False``
   (the probe/commit kernel) from the same warm state: hit masks and values
   must be identical.  A profiled window splits a batch's time into
   device and host work;
6. cpu: the first batches on a ``Broker(device="cpu")`` (the plain
   versions) from the same warm state; hit masks, values and the flushed
   state words must be identical to the card's;
   broker: the whole single-card broker at the same size.  A
   ``ServingSpec`` (``CacheSpec.from_strategy("STDv_LRU", 2**22, f_s=0.5,
   f_t=0.4)``, W 8, V 8) compiles through ``Broker.from_spec`` to the
   cache ``plan_cache`` plans (config and static keys checked) and its
   JSON round-trips.  The broker takes the warm state and a tracker fed
   the warm batches' topics; ``rebalance(force=True)`` re-splits the topic
   layer by the tracked popularity and migrates every live entry in one
   ``probe_and_commit`` launch (checked), whose new state (``ks``,
   ``value``, ``clock``) must equal, bit for bit, that of an
   ``engine="host"`` broker's numpy rebalance of the same state.  Prints
   the live entries, the migration batch's segments, deepest segment and
   pads, ``rebalance()``'s host-clock split (``extract_live``, planning,
   commit) and the launch's device time (CUDA events, replayed on the
   pre-migration words, L2 flushed) beside its byte bound, and again
   without the bucket's pad tail.  Both brokers then serve the 64
   measured batches (hit masks, values and every ``BrokerStats`` counter
   equal; the hit rate split by layer beside the serve phase's),
   invalidate 4096 served ids (counts and states equal), an unfused
   (``fused=False``) broker serves 8 batches from the one-call broker's
   state (hits and values equal, its commits launching the kernel), and
   a checkpoint (``save`` under ``build/``, removed after) restores into a
   fresh ``from_spec`` broker that serves 8 batches as the broker that
   never restarted; a flipped byte in ``arrays.npz`` must raise and
   ``latest_verified_step`` skip it.  Save and restore seconds and the
   checkpoint's size are printed;
   cluster: the sharded ``Cluster`` at the same size, every shard on
   ``cuda:0``, each step held to an ``engine="host"`` cluster on the CPU
   (the numpy host engine) in the same state.  ``Cluster.from_spec`` at
   shards=1 with the warm state serves the 64 measured batches as a bare
   ``Broker.from_spec`` does (values, hits, every counter, state); the
   warmed shard migrates into 4 shards on hash routing (``reshard``: one
   ``probe_and_commit`` launch per new shard, counted, each timed with CUDA
   events beside its byte bound; ``reshard()``'s host-clock split into
   extract, plan and commit), every shard's state bit-equal to the host
   engine's, and the 64 batches are served again on both (odd batches with
   a pool of 4 shard threads in place of the one-card default, serial
   dispatch: ms/batch serial and threaded); the same on
   topic routing, each topic's partition on shard tau mod 4; the batches
   through ``serve_async`` with 8 in flight (fused shard calls); a profiled
   window gives the idle share at 4 shards; ``run_open_loop`` with Poisson
   arrivals at 0.7x the batch policy's capacity over the batches'
   requests, shard 2 crashing halfway through the virtual time and
   recovering from a checkpoint cut before the stream (under ``build/``,
   removed): availability 1.0, the episode's health events and counters
   equal to the host engine's; then the serving CLI in process, ``main``
   on the card with ``CLI_REQUESTS`` requests: closed loop (topic routing,
   4 shards, ``--pipeline 8``: the log, LDA through ``topic_score``,
   gemma-2b's smoke-config back end) and open loop with shard 2 crashing
   halfway, both returning 0;
   analysis: the paper's hit-rate engine (``repro_torch.core``).  On the
   default ``SynthConfig`` stream (2M requests, its first 70% training,
   keys unseen in training without a topic) each of the six strategies at
   ``PAPER_N`` entries: the card's reuse-distance hits (``analyze`` on
   ``cuda``) must equal the host's exact simulation (``simulate`` of
   ``CacheSpec.to_exact``) and the reference's count; Bélády's bound must
   equal the reference's, and the gap reductions are printed.  The card's
   reuse distances on the x100 stream's first ``RD_CPU_POSITIONS`` must
   equal the CPU's (another sort) and, on the first
   ``RD_ORACLE_POSITIONS``, the Fenwick oracle's.  Then every strategy of
   ``X100_STRATEGIES`` on the whole x100 stream at ``ENTRIES`` (topics
   masked likewise): each distance below its position within its
   partition, the per-partition histograms monotone and ending at the
   counted repeats, the hits at the layout's capacities equal to the
   histograms read there; prints the hit rate split into static, topic
   and dynamic hits, the seconds per ``analyze`` (host clock,
   synchronised) and its peak device memory, STDv_LRU's exact-LRU hit
   rate on the served requests beside the serve phase's set-associative
   one, and one LRU of every size to ``ENTRIES`` from one pass;
7. topics: the paper's topic pipeline on the card, as the serving CLI
   starts up.  ``generate`` draws the same log with its clicked documents
   (V = 4096 words); its keys must equal the served stream's.
   ``run_pipeline`` fits MAP-EM LDA (K = 96) on 20,000 training documents
   and classifies every train-seen query through the ``topic_score``
   kernel, one launch per chunk of 8192 documents; the topical request
   share and the purity against the generator's topics are printed.  A
   cache planned from the LDA statistics is warmed and serves the same
   measured batches with the LDA topics (every value equal to the
   backend's, one serve launch per batch), beside the ground-truth run's
   hit rates, each split into static, topic and dynamic hits.  On a small log the card's pipeline must equal the CPU's
   (topic-word distributions within rtol 1e-6, topics identical but for
   near-ties);
8. lm: the LM back end the serving CLI puts behind the cache, gemma-2b at
   its full published width (18 layers, d 2048, 8 query heads over one KV
   head of 256, d_ff 16384, 256,000 words, bf16; 2.51B parameters drawn on
   the card from a seeded generator), at the registry's decode_32k shape
   with its 32768 positions and the batch cut from 128 to 64 (the bf16 KV
   cache of 128 would not fit 80 GB beside the weights).  64 seeded
   prompts of 32704 tokens are prefilled one per call through the plain
   chunked attention (its score products on TF32 tensor cores, set here);
   64 greedy decode steps then run through the ``decode_attention`` kernel,
   18 launches a step (checked), and the first steps again, teacher-forced
   by the kernel path's tokens, with the plain decode attention: every
   layer's call there is also run through the kernel on the same inputs and
   held to the decode tolerance below, the logits must agree within
   ``LM_LOGIT_RTOL`` of the row's largest logit and the greedy tokens but
   for near-ties.  A control step with every attention output zeroed says
   whether that logit check can see the attention at all (at the
   reference's init it cannot: the residual stream is ~45, the attention
   ~0.01).  Prints the prefill time, ms per decode step on the host clock
   and the device's idle share over a profiled window.  Then the LM back end (the serving
   CLI's miss handler) answers one batch of the serve phase's misses, its
   ids held to forward's top-k.  The LM's weights and KV cache are then
   released (the peak memory is printed).  Then the windowed dense LMs,
   each at full published width and freed before the next: gemma2-27b (46
   layers, 23 of them local with a window of 4096, 32 query heads over 16
   KV heads of 128, both softcaps; 15.5B bf16 parameters) at batch
   ``LM_WIDE``'s 2 and glm4-9b (40 layers, 32 query heads over 2 KV heads;
   9.4B) at 8, at decode_32k's 32768 positions with the KV cache drawn from
   the seeded generator and filled to all but the last ``LM_WIDE_STEPS``:
   that many greedy steps through the kernel (one launch a layer a step,
   checked), gemma2-27b's again through the ``decode_window_slice`` lever
   (teacher-forced by the full read's tokens: logits within
   ``LM_LOGIT_RTOL``, the greedy tokens but for near-ties), the first
   steps with the plain attention with every layer call also through the
   kernel (one bf16 ulp), ms per step and the idle share, and the kernel on
   layer 0's real call: gemma2-27b's window slice beside its full read with
   the window, its byte bound and ``scaled_dot_product_attention``'s time
   (over the window's keys, without the softcap SDPA lacks), glm4-9b's
   beside its bound and SDPA's.  Then the MoE LMs (phase lm/moe), each at
   full published width with its depth cut (``LM_MOE``) and freed before
   the next: llama4-scout (8 of 48 layers: d 5120, 40 query heads over 8
   KV heads of 128, 16 experts top-1 of d_ff 8192 plus an 8192 shared
   expert, 202,048 words; 19.7B bf16 parameters) and arctic (2 of 35
   layers: d 7168, 56 over 8 heads, 128 experts top-2 of d_ff 4864 plus a
   4864 dense residual; 27.7B), each at batch 16 over decode_32k's 32768
   positions (the KV cache drawn from the generator), the parameter count
   held to ``param_count()`` at that depth: ``LM_MOE_STEPS`` greedy steps
   through the kernel (one launch a layer a step, checked), every layer
   call of the first steps with the plain attention also through the
   kernel (one bf16 ulp), ms per step, the idle share and the kernel on
   layer 0's call beside its bound, plain and SDPA; layer 0's MoE call of
   step 0 against a float64 router (expert choices equal but for near-ties
   of the f32 logits) and a float64 evaluation of its routed experts
   within the bf16 path's rounding chain (``moe_float64``), the slots its
   capacity dropped, and the same call through ``impl="ragged"`` and at a
   roomy capacity factor held to the float64 evaluation without drops;
   llama4-scout's prefill of one ``LM_MOE_PREFILL``-token prompt; then
   llama4-scout at train_4k's width cut to ``LM_MOE_TRAIN_LAYERS`` layer
   (one sequence of 4096, remat, Adafactor; ms per step, MFU, peak, idle
   share), both archs' smoke configs trained on the card and on the CPU
   (losses within ``TRAIN_SMOKE_RTOL``), and the serving CLI with
   llama4-scout's smoke config behind the cache, on the card (its back
   end's CUDA graph replays counted) and on the CPU: both return 0 with
   the same hit-rate line;
   mesh (after lm/moe): ``repro_torch.launch.steps.build_step`` on a mesh
   of one rank (``make_smoke_mesh``: an nccl world of one on a
   ``HashStore``), every input placed as DTensors by the bundle's
   shardings: gemma-2b's decode_32k at full width (batch cut to 64) and
   llama4-scout's (8 layers, batch 16, the shard-local MoE with
   ``moe_batch_axes=("data",)``, tp "model", no FSDP axis), ``MESH_STEPS``
   greedy steps each after a warm-up step, ``decode_attention``'s launches
   counted (one a layer a step), the logits held to the ``mesh=None`` step
   on the same parameters, cache and tokens (bit-equal, else within
   ``decode_close``); gemma-2b's train_4k step (batch TRAIN_BATCH) with
   ``opts={"act_seq_axis": "model"}`` and without from the same weights:
   the losses and sampled updated parameters bit-equal; two-tower's
   serve_bulk (262,144) at full width, two ``embedding_bag`` launches,
   the scores bit-equal to the ``mesh=None`` serve; PNA's full_graph_sm
   step with ``dist_edges`` (``forward_dist``) and without, the losses
   within ``GNN_LOSS_RTOL``.  Beside them, from the phase's start, the
   dry-run of all 40 cells on both production meshes runs in a subprocess
   on the host (``python -m repro_torch.launch.dryrun --all --both-meshes``,
   ``DRYRUN_TIMEOUT``; a fake process group of 256 or 512 ranks, every
   tensor on meta): every cell ok, the largest per-device argument bytes
   and the cells over 80 GB printed;
9. train: training on the card (``repro_torch.launch.steps.build_lm_step``
   and ``build_recsys_step``'s train kinds, AdamW).  gemma-2b at full
   published width at train_4k (seq_len 4096, remat, 2.51B bf16 parameters
   from a seeded generator, f32 moments), the global batch cut from 256 to
   ``TRAIN_BATCH``: first, cut to ``TRAIN_REMAT_LAYERS`` layers, the
   gradients with remat equal to those without, bit for bit, under
   deterministic algorithms (the cost of those printed); then
   ``TRAIN_STEPS`` steps on ``SyntheticLM``: each loss finite, step 0's
   equal to a no-grad ``forward`` + ``cross_entropy`` bit for bit, and
   step 0's AdamW update of sampled entries of ``TRAIN_ADAMW_LEAVES``
   within one bf16 ulp of the formula in float64 on the host; ms per step
   (host clock, synchronised, median after the first), tokens/s, the MFU
   (``model_flops`` over the H100's 989.4 bf16 TFLOP/s), the peak memory
   and a profiled two-step window (device busy, idle share, the top device
   ops).  gemma-2b's smoke config in f32 trained ``TRAIN_SMOKE_STEPS``
   steps on the card and on the CPU from the same weights: the losses
   within ``TRAIN_SMOKE_RTOL``, the last five at least 0.1 below the first
   five.  The training CLI (``python -m repro_torch.launch.train --device
   cuda``) three times as ``tests/test_fault_tolerance.py`` runs it:
   uninterrupted, killed at step 30 (exit 42, latest checkpoint 20), and
   resumed from 20; the step-59 parameters bit-equal.  Two-tower at full
   width (3.07B f32 parameters) at train_batch cut to ``TT_TRAIN_BATCH``:
   its first step through the ``embedding_bag`` kernel and the same step
   with ``use_kernel=False`` from the same state give equal losses and
   updated parameters bit for bit (deterministic algorithms); then
   ``TT_TRAIN_STEPS`` steps through the kernel, two launches a step
   (counted), ms per step.  SASRec, DIN and MIND at full width and
   train_batch 65,536: two steps each, the losses finite, the second
   step's ms printed;
10. recsys: two-tower retrieval at its full published width (8M x 256 user
   and 4M x 256 item tables, towers 1024-512-256, f32; 3.07B parameters,
   12.3 GB, drawn on the card from a seeded generator), its serve_p99
   (batch 512), serve_bulk (262,144) and retrieval_cand (1 user against
   1,000,000 candidates) steps on seeded ids, each run RECSYS_STEPS times
   after a first run, every run's output equal to the first's.  Each step
   makes two ``embedding_bag`` kernel launches (the user and item bags,
   counted); the first run's bags must equal the plain version bit for bit
   and each step its ``use_kernel=False`` path.  Prints ms per step on the
   host clock and the device's idle share (profiled).  Then a small
   two-tower on the card against the CPU (RECSYS_RTOL, RECSYS_ATOL),
   ``embedding_bag`` against its plain version bit for bit on edge cases
   (bf16 tables, all-pad bags, a bag of one, repeated ids, the last row,
   D in {18, 50, 64, 256}, B = 1, bags of 40 ids), timed on the serve_bulk
   user bag and the retrieval_cand item bag with CUDA events (L2 flushed)
   beside its byte bound, the plain version and
   ``torch.nn.functional.embedding_bag``; and SASRec, DIN and MIND at their
   full published widths (2M x 50, 10M x 18 and 4M x 64 f32 tables from the
   phase's seeded generator), one serve_p99 step each (ms and a checksum),
   then serve_bulk (262,144) and retrieval_cand (1 x 1,000,000; DIN's in
   ``din_chunk_rows`` chunks, 3 x 262,144 and a tail of 213,568) through
   ``build_recsys_step``: a warm-up run and RECSYS_SCALE_STEPS timed runs
   each equal to the first bit for bit, the peak memory, a profiled window
   (device busy, idle share, the top ops); the first and last
   RECSYS_SAMPLE rows (DIN's retrieval: from both ends of every chunk)
   against the same function with the parameters in float64
   (RECSYS_F64_RTOL, RECSYS_F64_ATOL; the same rows with TF32 products
   must miss that bound); DIN's first chunk equal bit for bit
   to the serve function on its 262,144 materialised pairs, SASRec's and
   MIND's first candidates to it within the float64 bound; finite scores;
   gnn: PNA at its full config (4 layers, width 75, d_in 1433, 64
   classes, f32) through ``build_gnn_step``: the molecule serve step on
   batches of 128 padded molecules (logits held to the CPU's), then
   full_graph_sm (``GNN_TRAIN_STEPS`` AdamW steps, step 0 held to the CPU's
   from the same weights and batch), minibatch_lg (the sampler's block of
   fanouts 15 and 10 from 1024 seeds of the 114.6M-edge graph, padded to
   the shape's bound) and ogb_products cut by ``OGB_FRACTION``; each loss
   finite and falling; ms per call, MFU against the f32 rate, peak memory,
   the host's batch time and the idle share;
11. kernels: each cache kernel against its plain PyTorch version on the
   card, tolerance 0 (integer state), on the serving path's own batch (the
   inputs of the second served batch's launch, captured), on a batch spread
   uniformly over the sets, on an edge-case batch (deep same-set
   conflicts, duplicates, pad keys, epochs at and above 2**31), on a batch
   with one segment of ``DEEP_DEPTH`` requests, on a batch all in one set,
   on a depth sweep (one segment of each of ``SWEEP_DEPTHS``, two runs of
   static hits) and on the deep and one-set batches at each of
   ``SWEEP_WAYS`` (``commit_cases``); for each it prints the deepest
   segment's depth and mix (static, pad, admitted, not admitted) and both
   kernels' device time (CUDA events, state restored and L2 flushed before
   every launch).  On the serving batch also the byte bound and the plain
   version's time, and once the device time of an empty launch of the
   commit kernels' grid.
   ``topic_score`` against its plain version on the
   pipeline's first classification chunk (captured) and on edge cases
   (all-zero rows, K = 1, K = 500, ragged B and V, exact ties): scores
   within rtol 1e-4, ``top`` exact or within a near-tie, confidences within
   rtol 1e-4 of the plain softmax of the kernel's scores; timed
   beside its bound (the chunk's non-zero counts are counted: the bytes of
   the dense counts read once, or 2 * nnz * K operations, with the dense
   product's figure printed beside it), the plain version and
   ``torch.matmul`` (the product alone); then held and timed on a fully
   dense chunk of the same shape beside ``torch.matmul``.
   ``decode_attention`` against its plain version (2e-6 in f32;
   in bf16 one bf16 ulp plus 1e-5 of the largest output, ``decode_close``)
   on the decode path's own last call (one layer's full cache), in bf16
   and cast to f32, gemma2-27b's and glm4-9b's decode geometries at S =
   32768, the sweep of tests/test_kernels.py, cur = 0, S off every tile and
   the partial-fill poison case, each error printed beside the output's
   RMS; timed on the path's call beside its byte
   bound, the plain version and ``scaled_dot_product_attention``.

The last three lines are one JSON object ``{"kernels": [...]}`` (each
cache kernel's ``launches`` summed over the serve, broker and cluster
phases, ``topic_score``'s over the topics and cluster phases,
``embedding_bag``'s over the train and recsys phases, ``decode_attention``'s
over gemma-2b's, the windowed LMs', the MoE LMs' and phase mesh's decode
runs (``embedding_bag``'s also over phase mesh's serve), each counted
from 0 just before its path; ``probe_and_commit``'s row also carries the
migration launch's times and the hash reshard's), the
card's name and power limit as ``nvidia-smi`` gives them, and
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM device-memory rate and f32 rate outside the tensor cores
#: (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
SEED = 0
B = 4096
WAYS = 8
VDIM = 8
ENTRIES = 1 << 22
#: SynthConfig's request and query counts times SCALE (as the benchmarks'
#: ``scale`` does): 200M requests, so the 2**22-entry cache is ~11% of the
#: training prefix's distinct queries, the top of the paper's 0.7%-11%
#: range of cache sizes (benchmarks/common.py)
SCALE = 100
N_WARM = 4096
N_BATCHES = 64
N_CPU_BATCHES = 8
N_PROFILE = 9
#: the kernels phase's deep case: a segment of this many requests to one
#: set (the depth at which the first commit kernel took 410 us)
DEEP_DEPTH = 355
#: the commit kernels' time against depth: one segment of each depth among
#: the batch's short ones (``uniform``'s deepest is ~4), at W = 8
SWEEP_DEPTHS = (8, 32, 33, 80, 1024)
#: the widths at which the deep and one-set cases run again
SWEEP_WAYS = (4, 16, 32)
#: the served topical share may differ from the config's by this much
#: (binomial sd over the served requests is ~0.0009)
TOPICAL_TOL = 0.01
#: share of served requests the topic and dynamic layers must answer: the
#: stream must exercise them (a static-lookup-only stream answers ~0.0003)
MIN_SET_ASSOC_SHARE = 0.005
#: the topic pipeline's settings: the benchmarks' ``--lda`` rows fit LDA on
#: 20,000 documents (benchmarks/common.py), 30 EM iterations (the default)
LDA_SUBSAMPLE = 20_000
LDA_ITERS = 30
#: topic_score against its plain version: scores within this relative
#: tolerance (tests/test_kernels.py's), top exact unless the top two plain
#: scores lie within it, conf within it of the plain epilogue (softmax) on
#: the kernel's own scores.  (conf is a softmax of score differences: at
#: |scores| ~ 3400 two f32 summation orders differ by ~1e-3, and conf by up
#: to ~1e-3 relative, so it is held to the epilogue, and its difference to
#: the plain version's is printed.)
TOPIC_RTOL = 1e-4
#: phase lm: gemma-2b at the registry's decode_32k shape with its sequence
#: length kept and the batch cut from 128 to 64: a bf16 KV cache of 128 x
#: 32768 is 77.3 GB, which with the 5.0 GB of weights does not fit the 80 GB
#: card; 64 needs 38.7 GB.  The prompts fill all but the last LM_STEPS slots.
LM_BATCH = 64
LM_SEQ = 32768
LM_STEPS = 64
LM_PROMPT = LM_SEQ - LM_STEPS
LM_PREFILL_BATCH = 1
LM_PLAIN_STEPS = 4
LM_PROFILE = 4
#: kernel against plain decode logits, relative to the row's largest logit,
#: and the top-two gap (same measure) within which the greedy tokens may
#: differ.  The model is bf16: each layer's attention output is rounded to 8
#: significant bits after the two paths sum S = 32768 terms in different
#: orders; a one-ulp difference there can move later bf16 roundings by an
#: ulp, through 18 layers, and the logits themselves are bf16 products
#: (an ulp is 2**-8 to 2**-7 of a logit).  2**-6 is two to four ulps of the
#: row's largest logit.
LM_LOGIT_RTOL = 2.0**-6
#: phase lm, the windowed dense LMs: gemma2-27b (local/global layers,
#: window 4096, Hkv 16, G 2) and glm4-9b (Hkv 2, G 16) at full published
#: width at decode_32k's 32768 positions, the batch cut from 128 to this:
#: gemma2-27b's bf16 KV cache is 12.35 GB a sequence beside 31.0 GB of
#: weights (two sequences: 55.7 GB), glm4-9b's 1.34 GB beside 18.8 GB.  The
#: KV cache is drawn from the seeded generator (random weights read random
#: keys; phase lm's gemma-2b prefills its cache) and filled to
#: LM_SEQ - LM_WIDE_STEPS, then LM_WIDE_STEPS greedy decode steps
LM_WIDE = (("gemma2-27b", 2), ("glm4-9b", 8))
#: their parameters: the registry's analytic count, plus the final norm,
#: gemma2-27b's post-attention and post-MLP norms (2 x 4608 a layer) and
#: glm4-9b's q/k/v biases ((32 + 2 x 2) x 128 a layer)
LM_WIDE_PARAMS = {"gemma2-27b": 15_506_145_792, "glm4-9b": 9_399_951_360}
LM_WIDE_STEPS = 16
LM_WIDE_PLAIN_STEPS = 2
LM_WIDE_PROFILE = 2
#: at these random inits the logits follow the attention closely (with
#: every attention output zeroed gemma2-27b's move by ~0.9 of the row's
#: largest |logit|, glm4-9b's by ~0.08; gemma-2b's by 0.004), so one-ulp
#: roundings of the attention move them by 0.03-0.06, between the kernel
#: and the plain path as between the lever and the full read (this
#: script's lm lines on an H100 80GB HBM3 at 700 W).  The kernel is held
#: layer by layer (decode_close), the lever's window slice to the
#: kernel's full read with the window on the same inputs within two bf16
#: ulps (LM_WIDE_LEVER_RTOL, each is one from the f32 result) plus
#: DECODE_BF16_ATOL of the largest output; the lever's logits within
#: LM_WIDE_SPREAD times the kernel-to-plain spread (the zeroed-attention
#: control is printed beside it)
LM_WIDE_LEVER_RTOL = 2.0**-6
LM_WIDE_SPREAD = 2.0
#: phase lm/moe: the MoE LMs at full published width with their depth cut
#: (neither fits one card: llama4-scout's 48 layers are ~215 GB of bf16
#: weights, arctic's 35 ~954 GB), each at decode_32k's 32768 positions
#: with the batch cut from 128: (arch, layers, batch).  llama4-scout at 8
#: layers is 39.4 GB of weights and its KV cache 1.07 GB a sequence;
#: arctic at 2 layers 55.4 GB and 0.27 GB a sequence
LM_MOE = (("llama4-scout-17b-a16e", 8, 16), ("arctic-480b", 2, 16))
#: their parameters at that depth: the registry's analytic count plus the
#: final norm
LM_MOE_PARAMS = {"llama4-scout-17b-a16e": 19_685_785_600 + 5120,
                 "arctic-480b": 27_681_124_352 + 7168}
LM_MOE_STEPS = 16
#: the MoE check's rounding chain (moe_float64): a sum of n independent
#: roundings held to this many times its root-sum-square.  The max over a
#: call's ~10^5 outputs of a normal sum is ~4.4 of its sd, and a rounding's
#: sd is 0.29 of its bound, so the errors should reach ~0.2-0.3 of the
#: bound (0.32 in a CPU trial of one expert at llama4-scout's width)
MOE_LAMBDA = 6.0
LM_MOE_PLAIN_STEPS = 2
LM_MOE_PROFILE = 2
#: llama4-scout's prefill: one prompt of this many tokens (prefill_32k's
#: 32 x 32768 cut)
LM_MOE_PREFILL = 8192
#: llama4-scout's train step at train_4k's width: one sequence of 4096,
#: remat, Adafactor; its depth cut to this.  Adafactor keeps ~6 f32
#: temporaries of a leaf alive, and a layer's stacked expert ``wi`` is 5.4 GB
#: in f32 a layer, so two layers (12.9 GB of bf16 weights, as many
#: gradients, ~64 GB of temporaries) would not fit 80 GB
LM_MOE_TRAIN_LAYERS = 1
LM_MOE_TRAIN_STEPS = 3
#: both archs' smoke configs (f32): this many train steps on the card and on
#: the CPU from the same weights, the losses within TRAIN_SMOKE_RTOL
LM_MOE_SMOKE_STEPS = 3
#: the serving CLI with an MoE back end, on the card and on the CPU
#: phase mesh: greedy decode steps of each LM through build_step; the
#: dry-run's cells (40 on each production mesh) and its time limit, from its
#: start at the phase's start
MESH_STEPS = 4
DRYRUN_CELLS = 80
DRYRUN_TIMEOUT = 240
LM_MOE_CLI = ("--arch", "llama4-scout-17b-a16e", "--requests", "20000", "--entries", "1024")
#: phase gnn: PNA at its full config (4 layers, width 75, d_in 1433, 64
#: classes, f32) on its four shapes.  molecule (serve) timed over
#: GNN_SERVE_RUNS batches of 128; full_graph_sm GNN_TRAIN_STEPS AdamW steps;
#: minibatch_lg (the full block) and ogb_products GNN_BIG_STEPS each.
GNN_SERVE_RUNS = 20
GNN_TRAIN_STEPS = 8
GNN_BIG_STEPS = 3
GNN_PROFILE = 2
#: ogb_products' nodes and edges both times this (its average degree kept):
#: a step's peak memory grows with the graph: 66.029 GB at 1/6 on an H100
#: 80GB HBM3 at 700 W, ~3 GB of it earlier phases' live tensors, so ~380 GB
#: at full size; 1/5 would need ~79 of the card's 80
OGB_FRACTION = 1 / 6
#: the card against the CPU on the same inputs (f32 on both; the card's
#: index_add sums with atomics, in no fixed order): full_graph_sm's step 0
#: loss within GNN_LOSS_RTOL and every parameter after its AdamW update
#: within GNN_PARAM_ATOL (the first step moves an entry by about lr / 100
#: times the sign of its gradient: an entry whose gradient is rounding noise
#: may move the other way, 6e-6 apart); molecule logits within
#: GNN_LOGIT_ATOL_REL of the largest (a node's std of k copies of one
#: message is the square root of a rounding error, tests/test_torch_gnn.py)
GNN_LOSS_RTOL = 1e-5
GNN_PARAM_ATOL = 1e-5
GNN_LOGIT_ATOL_REL = 1e-3
#: decode_attention against its plain version.  f32: tests/test_kernels.py's
#: 2e-6.  bf16: the two compute in f32 and differ there only by their
#: summation orders, so their bf16 outputs differ by at most one ulp, 2**-7
#: of the plain output, and near zero by the f32 difference itself, well
#: under 1e-5 of the largest output.  (At S = 32768 the outputs are ~0.01,
#: so test_kernels' fixed 3e-2 would pass a kernel that dropped a chunk.)
DECODE_F32_TOL = 2e-6
DECODE_BF16_RTOL = 2.0**-7
DECODE_BF16_ATOL = 1e-5
#: phase recsys: two-tower at the registry's full config (8M x 256 user and
#: 4M x 256 item tables, towers 1024-512-256, f32): the tables' 3,072,000,000
#: parameters and each tower's 919,296
RECSYS_PARAMS = 3_073_838_592
#: two-tower's steps and how often each is timed after its first run
RECSYS_STEPS = (("serve_p99", 20), ("serve_bulk", 5), ("retrieval_cand", 5))
RECSYS_PROFILE = 3
#: SASRec's, DIN's and MIND's bulk and retrieval steps: timed runs after
#: the warm-up, and the profiled window
RECSYS_SCALE_STEPS = (("serve_bulk", 3), ("retrieval_cand", 3))
RECSYS_SCALE_PROFILE = 2
#: their float64 check: RECSYS_SAMPLE rows from each end (DIN's retrieval:
#: half of it from each end of every chunk), each score within
#: RECSYS_F64_RTOL of the sample's largest float64 score plus
#: RECSYS_F64_ATOL.  The float64 run casts the parameters; the functions'
#: own ``.float()`` (attention logits, MIND's squash and similarities) keep
#: those steps in f32 there too.  A control holds the bound below
#: lower-precision error: the same rows in f32 with TF32 products must
#: miss it
RECSYS_SAMPLE = 256
RECSYS_F64_RTOL, RECSYS_F64_ATOL = 1e-5, 1e-7
#: the card's steps against the CPU's at a small width: the CPU tests' f32
#: tolerance (the GEMMs sum in other orders)
RECSYS_RTOL, RECSYS_ATOL = 1e-5, 1e-6
#: phase train: gemma-2b at train_4k's sequence length with the global batch
#: cut from 256 to 2: bf16 weights and gradients are 5.0 GB each, the f32
#: AdamW moments 20.1 GB, the f32 logits of 2 x 4096 tokens over 256,000
#: words 8.4 GB and their gradient as much again; batch 4 would not fit 80 GB
TRAIN_BATCH = 2
TRAIN_SEQ = 4096
TRAIN_STEPS = 8
TRAIN_PROFILE = 2
#: the remat check's depth (full width): gradients with remat == without
TRAIN_REMAT_LAYERS = 2
#: the AdamW check: entries sampled from each of these leaves, held to the
#: float64 formula (parameters within one bf16 ulp; moments within a few
#: f32 roundings of the f64 ones: no cancellation at step 0, m and v start at 0)
TRAIN_SAMPLE = 4096
TRAIN_ADAMW_LEAVES = {
    "embed": lambda t: t["embed"],
    "layers/attn/q": lambda t: t["layers"]["attn"]["q"],
    "layers/mlp/wo": lambda t: t["layers"]["mlp"]["wo"],
    "layers/pre_attn_norm/scale": lambda t: t["layers"]["pre_attn_norm"]["scale"],
    "final_norm/scale": lambda t: t["final_norm"]["scale"],
}
TRAIN_MOMENT_RTOL = 1e-6
#: H100 SXM bf16 dense tensor-core rate (NVIDIA data sheet), for the MFU
BF16_FLOP_PER_S = 989.4e12
#: the card against the CPU: gemma-2b's smoke config (f32) trained this
#: many AdamW steps on each; every loss within this relative tolerance (f32
#: on both, sums in other orders: the CPU tests see the two packages' f32
#: parameters 1e-7 apart after 19 steps)
TRAIN_SMOKE_STEPS = 30
TRAIN_SMOKE_RTOL = 1e-4
#: the training CLI's kill-and-resume run (tests/test_fault_tolerance.py's)
TRAIN_CLI = ("--arch", "gemma-2b", "--steps", "60", "--seq-len", "32", "--batch", "4",
             "--ckpt-every", "20")
#: two-tower's train_batch cut from 65,536 to 32,768: its (B, B) f32
#: in-batch logits are 17.2 GB at 65,536, and their few live copies do not
#: fit beside the 49.2 GB of parameters, gradients and moments
TT_TRAIN_BATCH = 32768
TT_TRAIN_STEPS = 3
#: phase cluster's in-process CLI runs: the log's requests (half of them
#: served) and the cache's entries
CLI_REQUESTS = 2_000_000
CLI_ENTRIES = 65536
#: phase analysis: the paper's comparison on the default SynthConfig stream
#: (2M requests, its own seed, the first 70% training, keys unseen in
#: training without a topic) at N entries.  Per strategy: (f_s, f_t, f_ts)
#: and the hit count that repro.core's hit_rate and simulate both give on
#: it, and Bélády's at N (belady_hits, count_from = the training prefix)
PAPER_N = 32768
PAPER_STRATEGIES = {
    "SDC": ((0.5, 0.0, None), 445515),
    "STDf_LRU": ((0.5, 0.4, None), 450133),
    "STDv_LRU": ((0.5, 0.4, None), 452194),
    "STDv_SDC_C1": ((0.5, 0.4, 0.5), 426237),
    "STDv_SDC_C2": ((0.5, 0.4, 0.5), 454690),
    "Tv_SDC": ((0.5, 0.4, 0.5), 361180),
}
PAPER_BELADY = 480651
#: the card's reuse distances against the CPU's (a different sort) and
#: against the Fenwick oracle, on prefixes of the x100 stream
RD_CPU_POSITIONS = 1 << 22
HIST_CAP = 1 << 12  # the capacities whose histograms the card and the CPU compare
RD_ORACLE_POSITIONS = 1 << 17
#: the strategies analysed on the whole x100 stream at ENTRIES
X100_STRATEGIES = tuple(PAPER_STRATEGIES)


def decode_close(got, want):
    """``(ok, max abs err, largest err / bound, RMS of want)`` of a
    decode_attention output against the plain one, at the tolerance of its
    dtype (DECODE_*)."""
    if want.dtype == torch.float32:
        rtol, atol = DECODE_F32_TOL, DECODE_F32_TOL
    else:
        rtol, atol = DECODE_BF16_RTOL, DECODE_BF16_ATOL * float(want.float().abs().max())
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
    return (bool((err <= bound).all()), float(err.max()), float((err / bound).max()),
            float(want.pow(2).mean().sqrt()))


@contextlib.contextmanager
def patched(module, attr: str, fn):
    """``module.attr`` is ``fn`` within the block."""
    orig = getattr(module, attr)
    setattr(module, attr, fn)
    try:
        yield orig
    finally:
        setattr(module, attr, orig)


@contextlib.contextmanager
def tf32():
    """f32 matrix products on the TF32 tensor cores within the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# -- phases 3-6: the stream and serving through the broker ---------------------


def make_stream(seed: int):
    """``(cfg, keys, true_topic, n_train)``: the scaled SynthConfig stream;
    the requests after its training prefix ``keys[:n_train]`` are served."""
    from repro_torch.querylog import SynthConfig, generate_stream

    base = SynthConfig()
    cfg = SynthConfig(
        n_requests=base.n_requests * SCALE,
        n_topical_queries=base.n_topical_queries * SCALE,
        n_notopic_queries=base.n_notopic_queries * SCALE,
        seed=seed,
    )
    keys, true_topic = generate_stream(cfg)
    return cfg, keys, true_topic, len(keys) - (N_BATCHES + N_PROFILE) * B


def backend(q: np.ndarray) -> np.ndarray:
    """Deterministic stand-in for the search back end: (n, V) doc ids."""
    q = np.asarray(q, np.int64)
    return ((q[:, None] * 2654435761 + np.arange(VDIM)[None, :] * 40503) % 1000003).astype(np.int32)


def plan_cache(stats):
    """The cache's layout from the training prefix's ``VecStats``, as the
    serving CLI plans it: topic partitions sized by distinct training
    queries per topic, the most frequent training queries static.  Returns
    ``(cfg, static ids, distinct training ids)``."""
    from repro_torch.serving import DeviceCacheConfig

    cfg = DeviceCacheConfig.build(
        ENTRIES, f_s=0.5, f_t=0.4, topic_distinct=stats.topic_distinct,
        ways=WAYS, value_dim=VDIM,
    )
    seen = stats.train_freq > 0
    static = np.flatnonzero((stats.freq_rank < cfg.static_entries) & seen)
    return cfg, static, int(seen.sum())


def make_cache(device, cfg, static):
    from repro_torch.serving import STDDeviceCache, splitmix64

    return STDDeviceCache(cfg, static_hashes=splitmix64(static),
                          static_values=backend(static), device=device)


def make_broker(cache, key_topic, device, **kw):
    from repro_torch.serving import Broker, BucketSpec

    topic_of = lambda q: key_topic[np.asarray(q, np.int64)]  # noqa: E731
    return Broker(cache, [backend], topic_of, microbatch=B, bucket=BucketSpec(),
                  device=device, **kw)


def serve_stream(broker, batches):
    """Serve ``batches`` in order; returns hit masks, values and each
    ``serve`` call's host-clock seconds (the call returns after its device
    work: the reply is copied back to the host)."""
    hits, vals, secs = [], [], []
    for q in batches:
        t0 = time.perf_counter()
        v, h = broker.serve(q)
        secs.append(time.perf_counter() - t0)
        check(np.array_equal(v, backend(q)), "a served value differs from the backend's")
        hits.append(h)
        vals.append(v)
    return hits, vals, secs


def layer_split(batches, hits, key_topic, static, stats) -> str:
    """The hit rate split by layer: static keys always hit the static
    layer; any other hit is in the query's topic partition when it carries
    a topic, else in the dynamic partition.  Checked against the broker's
    counters."""
    q, h = np.concatenate(batches), np.concatenate(hits)
    in_static = np.isin(q, static)
    topical = key_topic[q] >= 0
    n_static = int((h & in_static).sum())
    n_topic = int((h & ~in_static & topical).sum())
    n_dyn = int((h & ~in_static & ~topical).sum())
    check(n_static == stats.static_hits and n_topic + n_dyn == stats.topic_hits
          and len(q) == stats.requests, "the layer split disagrees with the broker's counters")
    return (f"hit rate {(n_static + n_topic + n_dyn) / len(q):.6f} (static {n_static / len(q):.6f}, "
            f"topic {n_topic / len(q):.6f}, dynamic {n_dyn / len(q):.6f})")


def layer_line(stats) -> str:
    n = max(stats.requests, 1)
    return (f"hit rate {stats.hit_rate:.6f} (static {stats.static_hits / n:.6f}, "
            f"set-associative {stats.topic_hits / n:.6f} of requests)")


def phase_warm(broker, train):
    """Replay the training prefix's last ``N_WARM`` batches; returns the
    flushed warm state as numpy words."""
    from repro_torch.serving import BrokerStats, state_to_numpy

    tail = train[len(train) - N_WARM * B :]
    t0 = time.perf_counter()
    for i in range(N_WARM):
        q = tail[i * B : (i + 1) * B]
        v, _ = broker.serve(q)
        check(np.array_equal(v, backend(q)), "a warm-up value differs from the backend's")
    broker.flush()
    torch.cuda.synchronize()
    print(f"warm: {N_WARM} training batches x {B} on the card in "
          f"{time.perf_counter() - t0:.3f} s, {layer_line(broker.stats)}")
    broker.stats = BrokerStats()
    return state_to_numpy(broker.state)


class Capture:
    """Within the block, the positional inputs of one call of
    ``module.attr`` (the ``index``-th, from 0; every call's, in ``each``,
    for ``index=None``), taken before the call, the tensors cloned: the
    cache kernels update ``ks`` and ``value`` in place, and a decode step
    the KV cache."""

    def __init__(self, module, attr: str, index=None):
        self.ops, self.attr, self.index = module, attr, index
        self.calls, self.args, self.each = 0, None, []

    def __enter__(self):
        orig = self.orig = getattr(self.ops, self.attr)

        def shim(*args, **kwargs):
            if self.index is None or self.calls == self.index:
                self.args = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
                if self.index is None:
                    self.each.append(self.args)
            self.calls += 1
            return orig(*args, **kwargs)

        setattr(self.ops, self.attr, shim)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.attr, self.orig)


class MissRecorder:
    """A back end that answers as ``fn`` and keeps the ids of its
    ``index``-th call (from 0)."""

    def __init__(self, fn, index: int):
        self.fn, self.index, self.calls, self.ids = fn, index, 0, None

    def __call__(self, q):
        if self.calls == self.index:
            self.ids = np.array(q, copy=True)
        self.calls += 1
        return self.fn(q)


def phase_serve(device, cache, true_topic, first, warm, serve):
    from repro_torch.kernels.cache_ops import kernel as pac
    from repro_torch.kernels.cache_ops import ops
    from repro_torch.kernels.cache_ops import serve_kernel as srv
    from repro_torch.serving import state_from_numpy, state_to_numpy

    batches = [serve[i : i + B] for i in range(0, N_BATCHES * B, B)]
    extra = [serve[i : i + B] for i in range(N_BATCHES * B, len(serve), B)]
    out = {}
    for name, one_call in (("one_call", True), ("legacy", False)):
        if one_call:
            broker = first
            # the ids the broker sends its back end on one batch's misses: phase lm
            recorder = broker.backends[0] = MissRecorder(backend, index=1)
        else:
            broker = make_broker(cache, true_topic, device, fused_one_call=False)
            broker.state = state_from_numpy(warm, device)
        broker.warmup([B])
        wrapper = "_serve_fused" if one_call else "_probe_and_commit"
        broker.dispatch_counts.clear()
        srv.launches = 0
        pac.launches = 0
        torch.cuda.synchronize()
        with Capture(ops, wrapper, 1) as cap:
            hits, vals, secs = serve_stream(broker, batches[:N_CPU_BATCHES])
        snap = None
        if one_call:  # the card's state for the CPU comparison
            broker.flush()
            snap = state_to_numpy(broker.state)
        h2, v2, s2 = serve_stream(broker, batches[N_CPU_BATCHES:])
        launches = {"serve_fused": srv.launches, "probe_and_commit": pac.launches}
        if one_call:
            broker.backends[0] = backend
        counts = dict(broker.dispatch_counts)
        secs = np.asarray(secs + s2)
        n_req = sum(len(q) for q in batches)
        print(f"serve/{name}: {len(batches)} batches x {B}, {layer_line(broker.stats)}, "
              f"{n_req / secs.sum():.1f} requests/s, ms/batch mean {secs.mean() * 1e3:.3f} "
              f"median {np.median(secs) * 1e3:.3f} (host clock, inside Broker.serve), "
              f"dispatches {counts}, kernel launches {launches}")
        out[name] = dict(hits=hits + h2, vals=vals + v2, launches=launches, counts=counts,
                         snap=snap, broker=broker, batches=batches, secs=secs,
                         stats=dataclasses.replace(broker.stats), args=cap.args,
                         miss_ids=recorder.ids if one_call else None)
    one, legacy = out["one_call"], out["legacy"]
    nb = len(batches)
    check(one["counts"].get("one_call") == nb, "one one_call dispatch per batch")
    check(one["launches"]["serve_fused"] == nb, "one serve_fused launch per batch")
    check(one["launches"]["probe_and_commit"] == 0, "the one-call path runs no probe_and_commit")
    check(legacy["launches"]["probe_and_commit"] > 0, "the legacy path launched probe_and_commit")
    check(legacy["launches"]["serve_fused"] == 0, "the legacy path runs no serve_fused")
    for i in range(nb):
        check(np.array_equal(one["hits"][i], legacy["hits"][i]), f"hit masks differ at batch {i}")
        check(np.array_equal(one["vals"][i], legacy["vals"][i]), f"values differ at batch {i}")
    print("serve/legacy: hit masks and values identical to the one-call path")
    share = one["stats"].topic_hits / one["stats"].requests
    check(share >= MIN_SET_ASSOC_SHARE,
          f"the set-associative layers answered {share:.6f} of requests "
          f"(< {MIN_SET_ASSOC_SHARE}): the stream does not exercise them")
    profile_window(one["broker"], extra, float(np.median(one["secs"])))
    for r in out.values():
        r["broker"].close()
    return out


class Kernels(list):
    """``device_kernels``' result: the profiler's device kernels by name
    (``key_averages``), and ``busy_us``, the union of the kernels' spans on
    the device, so that kernels that overlap count once (a programmatic
    dependent launch, as the decode attention's merge, runs beside the
    kernel it waits for; its span starts with that kernel's)."""

    busy_us = 0.0


def device_kernels(warm, run, what: str) -> Kernels:
    """The device kernels the torch profiler recorded while ``run()`` ran,
    after ``warm()`` ran in a first session (it starts the tracer).

    CUDA events bracket ``run()`` inside the same session.  The profiler
    drops a window's records now and then (a short window's activity
    buffer not yet complete when the session stops; the pause before the
    stop makes that rarer): then the window's span on those events stands
    in as one entry, an upper bound on the busy time, and a line says so.
    Fails when neither saw device time."""
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        warm()
        torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=acts) as prof:
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        time.sleep(0.05)
    cuda = torch.autograd.DeviceType.CUDA
    kern = Kernels(e for e in prof.key_averages()
                   if e.device_type == cuda and e.device_time_total > 0)
    if kern:
        busy, last = 0.0, float("-inf")
        for a, b in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                           if e.device_type == cuda):
            busy += max(0.0, b - max(a, last))
            last = max(last, b)
        kern.busy_us = busy or sum(e.device_time_total for e in kern)
        return kern
    span_us = start.elapsed_time(end) * 1e3
    check(span_us > 0, f"neither the profiler nor CUDA events saw device time for {what}")
    print(f"profile: the profiler recorded no device time for {what}; its busy time below is "
          f"the window's span on CUDA events ({span_us:.1f} us), an upper bound, with no "
          f"per-kernel split")
    kern = Kernels([SimpleNamespace(key="window span (CUDA events)", device_time_total=span_us,
                                    count=0)])
    kern.busy_us = span_us
    return kern


def profile_window(broker, batches, batch_s: float):
    """Where a served batch's time goes: device time by kernel (torch
    profiler) against the unprofiled median batch time, and the host's
    busiest functions (cProfile)."""
    import cProfile
    import io
    import pstats

    def rest():
        for q in batches[1:]:
            broker.serve(q)

    n = len(batches) - 1
    kern = device_kernels(lambda: broker.serve(batches[0]), rest, "the served batches")
    busy = kern.busy_us / n / 1e6  # s per batch
    top = sorted(kern, key=lambda e: -e.device_time_total)[:8]
    names = "; ".join(f"{e.key[:70]} {e.device_time_total / n:.1f}us x{e.count / n:.1f}"
                      for e in top)
    print(f"serve/profile: device busy {busy * 1e3:.4f} ms/batch over {n} batches, "
          f"{sum(e.count for e in kern) / n:.1f} device ops/batch, idle share "
          f"{1 - busy / batch_s:.4f} of the unprofiled median {batch_s * 1e3:.3f} ms; "
          f"per batch: {names}")
    pr = cProfile.Profile()
    pr.enable()
    for q in batches:
        broker.serve(q)
    pr.disable()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(14)
    for line in buf.getvalue().splitlines():
        if line.strip() and ("{" in line or ".py" in line) and "ncalls" not in line:
            print(f"serve/host-profile: {line.strip()}")


def phase_cpu(cfg, static, true_topic, warm, served):
    from repro_torch.serving import state_from_numpy, state_to_numpy

    batches = served["one_call"]["batches"][:N_CPU_BATCHES]
    broker = make_broker(make_cache("cpu", cfg, static), true_topic, "cpu")
    broker.state = state_from_numpy(warm, "cpu")
    t0 = time.perf_counter()
    hits, vals, _ = serve_stream(broker, batches)
    broker.flush()
    for i in range(N_CPU_BATCHES):
        check(np.array_equal(hits[i], served["one_call"]["hits"][i]), f"cpu hit mask differs at batch {i}")
        check(np.array_equal(vals[i], served["one_call"]["vals"][i]), f"cpu values differ at batch {i}")
    snap = served["one_call"]["snap"]
    mine = state_to_numpy(broker.state)
    for k in snap:
        check(np.array_equal(snap[k], mine[k]), f"cpu state {k} differs from the card's")
    broker.close()
    print(f"cpu: {N_CPU_BATCHES} batches on the plain versions from the warm state identical "
          f"to the card (hit masks, values, flushed state words), {time.perf_counter() - t0:.3f} s")


# -- phase broker: the whole single-card broker ----------------------------------


def stats_equal(a, b) -> bool:
    """Every ``BrokerStats`` counter (and the tracker's counts) equal."""
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    return da.keys() == db.keys() and all(np.array_equal(da[k], db[k]) for k in da)


def same_state(a, b, what: str) -> None:
    from repro_torch.serving import state_to_numpy

    x, y = state_to_numpy(a), state_to_numpy(b)
    for k in x:
        check(np.array_equal(x[k], y[k]), f"{what}: state {k} differs")


def serve_both(card, host, batches):
    """Serve ``batches`` on both brokers; hit masks and values must agree.
    Returns the card's hit masks and host-clock seconds per broker."""
    hits, secs = [], {"card": 0.0, "host": 0.0}
    for q in batches:
        out = []
        for name, b in (("card", card), ("host", host)):
            t0 = time.perf_counter()
            out.append(b.serve(q))
            secs[name] += time.perf_counter() - t0
        (v0, h0), (v1, h1) = out
        check(np.array_equal(v0, backend(q)), "a served value differs from the backend's")
        check(np.array_equal(h0, h1) and np.array_equal(v0, v1),
              "the card's broker and the host engine's serve differently")
        hits.append(h0)
    return hits, secs


def tamper(step_dir: str) -> None:
    """Flip one byte of the packed words in ``arrays.npz`` and rewrite the
    archive (it stays readable: only the manifest's crc32 can tell)."""
    path = os.path.join(step_dir, "arrays.npz")
    with np.load(path) as data:
        arrays = {k: np.array(data[k]) for k in data.files}
    arrays["cache/ks"].reshape(-1).view(np.uint8)[12345] ^= 0xFF
    np.savez(path + ".tmp.npz", **arrays)
    os.replace(path + ".tmp.npz", path)


def migration_depth(common) -> int:
    """The deepest segment of a planned batch counting only its real
    (non-pad) requests."""
    order, _, seg_len, _, h_hi, h_lo = (x.cpu().numpy() for x in common[:6])
    lens = seg_len[seg_len > 0]
    pad = ((h_hi == -1) & (h_lo == -1))[order]
    seg_of = np.repeat(np.arange(len(lens)), lens)
    return int(np.bincount(seg_of[~pad], minlength=len(lens)).max())


def without_pads(common, n_real: int):
    """A planned commit batch's real requests (the first ``n_real``, the
    bucket's pads cut off), planned anew: the same launch's work without
    its pad tail."""
    from repro_torch.kernels.cache_ops import plan_segments

    order, leader, seg_len, seg_set, *fields = common
    req = fields[:6]  # h_hi, h_lo, admit, static_hit, epochs, min_epoch
    lens = seg_len[seg_len > 0].to(torch.int64)
    req_set = torch.empty_like(order)
    req_set[order.to(torch.int64)] = torch.repeat_interleave(seg_set[: len(lens)], lens)
    plan = plan_segments(req_set[:n_real].contiguous())
    return (plan[0], *plan[2:], *(t[:n_real].contiguous() for t in req), fields[6])


@contextlib.contextmanager
def migration_split(index=None):
    """Within the block, the host-clock seconds of every
    ``STDDeviceCache.extract_live`` and ``commit_vectorized`` call (each
    synchronised) summed in ``secs``, and the inputs of the
    ``probe_and_commit`` launches captured (``Capture``'s ``index``)."""
    from repro_torch.kernels.cache_ops import ops
    from repro_torch.serving import STDDeviceCache

    secs = {"extract_live": 0.0, "commit": 0.0}

    def timed(name, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t
            return out
        return run

    with patched(STDDeviceCache, "extract_live", timed("extract_live", STDDeviceCache.extract_live)), \
            patched(STDDeviceCache, "commit_vectorized",
                    timed("commit", STDDeviceCache.commit_vectorized)), \
            Capture(ops, "_probe_and_commit", index) as cap:
        yield secs, cap


def phase_broker(device, stats, ccfg, static, true_topic, train, warm, serve, served):
    """The whole single-card broker, built from a ``ServingSpec`` at the
    serve phase's size: a live rebalance of the warmed cache (one
    ``probe_and_commit`` launch, held to the numpy host engine), serving
    after it, key invalidation, the unfused path and a checkpoint."""
    from repro_torch.core.spec import CacheSpec
    from repro_torch.kernels.cache_ops import kernel as pac
    from repro_torch.kernels.cache_ops import serve_kernel as srv
    from repro_torch.serving import (Broker, BucketSpec, RebalanceSpec, ServingSpec,
                                     state_from_numpy)
    from repro_torch.train import checkpoint as ckpt_lib

    batches = served["one_call"]["batches"]
    extra = [serve[i : i + B] for i in range(N_BATCHES * B, len(serve), B)]
    # 1. the spec compiles to the serve phase's cache; scheduled rebalance
    # checks never fire here (rebalance(force=True) runs the migration)
    spec = ServingSpec(
        cache=CacheSpec.from_strategy("STDv_LRU", ENTRIES, f_s=0.5, f_t=0.4),
        ways=WAYS, value_dim=VDIM, microbatch=B, bucket=BucketSpec(),
        rebalance=RebalanceSpec(every=1 << 30),
    )
    check(ServingSpec.from_json(spec.to_json()) == spec, "ServingSpec JSON round trip")

    def build(dev, **kw):
        return Broker.from_spec(dataclasses.replace(spec, **kw), stats, [backend],
                                value_fn=backend, device=dev)

    t0 = time.perf_counter()
    card = build(device)
    build_s = time.perf_counter() - t0
    check(card.cache.cfg == ccfg, "the spec's DeviceCacheConfig differs from plan_cache's")
    check(np.array_equal(np.sort(spec.cache.device_static_keys(stats)), np.sort(static)),
          "the spec's static keys differ from plan_cache's")
    host = build("cpu", engine="host")
    print(f"broker/spec: ServingSpec(STDv_LRU, n={ENTRIES}, f_s 0.5, f_t 0.4, W {WAYS}, V "
          f"{VDIM}) -> Broker.from_spec in {build_s:.3f} s; DeviceCacheConfig and "
          f"{len(static)} static keys equal to plan_cache's; JSON round-trips")

    # 2. a live rebalance of the warmed cache, the tracker fed the warm batches
    tail = train[len(train) - N_WARM * B :]
    for i in range(N_WARM):
        card.tracker.observe(true_topic[tail[i * B : (i + 1) * B]])
    host.tracker.load(card.tracker.counts)
    card.state = state_from_numpy(warm, device)
    host.state = state_from_numpy(warm, "cpu")
    live = int((warm["ks"][:, :WAYS] != 0).sum())
    pac.launches = srv.launches = 0
    old_cfg = card.cache.cfg
    with migration_split(0) as (secs, cap):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moved = card.rebalance(force=True)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    mig_launches = pac.launches
    check(moved and card.cache.cfg != old_cfg, "the tracked popularity re-split the topic layer")
    check(mig_launches == 1, f"the migration is one probe_and_commit launch ({mig_launches})")
    t0 = time.perf_counter()
    check(host.rebalance(force=True), "the host engine's broker rebalanced")
    host_s = time.perf_counter() - t0
    check(card.cache.cfg == host.cache.cfg, "both brokers moved to the same allocation")
    same_state(card.state, host.state, "the migration (card kernel vs numpy host engine)")
    pks, *pcommon = cap.args
    seg_len = pcommon[2]
    n_pad = int(len(seg_len)) - live
    shrunk = sum(1 for t, c in card.cache.cfg.topic_entries.items() if c < old_cfg.topic_entries[t])
    flush = torch.empty(1 << 26, dtype=torch.int32, device=device)  # 256 MiB > L2
    ks_t = pks.clone()
    mig_ms = time_device(lambda: pac.probe_and_commit(ks_t, *pcommon), 10, flush,
                         lambda: ks_t.copy_(pks))
    mig_bound = kernel_bytes(pks, pcommon) / HBM_BYTES_PER_S * 1e3
    real = without_pads(pcommon, live)
    nopad_ms = time_device(lambda: pac.probe_and_commit(ks_t, *real), 10, flush,
                           lambda: ks_t.copy_(pks))
    nopad_bound = kernel_bytes(pks, real) / HBM_BYTES_PER_S * 1e3
    ks_t.copy_(pks)
    pac.probe_and_commit(ks_t, *real)  # the same words without the pads
    check(torch.equal(ks_t, card.state["ks"]), "the migration without its pad tail lands alike")
    del flush
    print(f"broker/rebalance: {live} live entries before, migrated {card.stats.migrated} "
          f"into the new layout ({shrunk} of {len(old_cfg.topic_entries)} topic partitions "
          f"shrunk); migration batch B={len(seg_len)} ({n_pad} pads, the bucket's tail, all in "
          f"one set), segments={int((seg_len > 0).sum())}, {deepest_mix(pcommon)}, deepest "
          f"without pads {migration_depth(pcommon)}; "
          f"rebalance() {total:.6f} s on the host clock: extract_live "
          f"{secs['extract_live']:.6f}, planning {total - secs['extract_live'] - secs['commit']:.6f}, "
          f"commit {secs['commit']:.6f}; the migration's probe_and_commit launch "
          f"{mig_ms:.6f} ms (CUDA events, L2 flushed, pre-migration words restored), byte "
          f"bound {mig_bound:.6f} ms; the same {live} migrants without the pad tail "
          f"{nopad_ms:.6f} ms (bound {nopad_bound:.6f}); the host engine's rebalance "
          f"{host_s:.3f} s; state (ks, value, clock) bit-equal to the numpy host engine's")

    # 3. serving after the rebalance, the card against the host engine
    srv.launches = 0
    hits, secs_b = serve_both(card, host, batches)
    check(stats_equal(card.stats, host.stats), "BrokerStats differ after serving")
    serve_launches = srv.launches
    check(serve_launches == len(batches), "one serve_fused launch per batch after the rebalance")
    one = served["one_call"]
    print(f"broker/serve: {len(batches)} batches x {B} after the rebalance, "
          f"{layer_split(batches, hits, true_topic, static, card.stats)}; before it: "
          f"{layer_split(batches, one['hits'], true_topic, static, one['stats'])}; hit masks, "
          f"values and every BrokerStats counter equal to the host engine's; "
          f"{secs_b['card'] / len(batches) * 1e3:.3f} ms/batch on the card broker, "
          f"{secs_b['host'] / len(batches) * 1e3:.3f} on the host engine (host clock)")

    # 4. key invalidation of 4096 served ids
    keys = batches[-1]
    n_card, n_host = card.invalidate(keys=keys), host.invalidate(keys=keys)
    check(n_card == n_host > 0, f"invalidate zeroed {n_card} slots on the card, {n_host} on the host")
    same_state(card.state, host.state, "after invalidate(keys=...)")
    print(f"broker/invalidate: {len(keys)} served ids zeroed {n_card} resident slots on both "
          f"brokers; states equal")
    host.close()

    # 5. the unfused path from the same state as the one-call broker
    unf = Broker(card.cache, [backend], card.topic_of, fused=False, bucket=BucketSpec(),
                 microbatch=B, device=device)
    card.flush()
    unf.state = Broker._own_state(card.state)
    pac.launches = 0
    srv.launches = 0
    for q in extra[:8]:
        v0, h0 = card.serve(q)
        v1, h1 = unf.serve(q)
        check(np.array_equal(h0, h1) and np.array_equal(v0, v1),
              "the unfused path serves differently from the one-call path")
    unf_launches = pac.launches
    check(unf_launches > 0 and unf.dispatch_counts.get("commit", 0) > 0,
          "the unfused path's commits launched probe_and_commit")
    print(f"broker/unfused: {len(extra[:8])} batches with fused=False equal to the one-call "
          f"path (hits, values); {unf.dispatch_counts.get('commit')} commits, "
          f"{unf_launches} probe_and_commit launches")
    unf.close()
    serve_launches += srv.launches

    # 6. a checkpoint, restored into a fresh broker built from the spec
    tmp = tempfile.mkdtemp(prefix="ckpt_", dir=ROOT / "build")
    try:
        t0 = time.perf_counter()
        step_dir = card.save(tmp, 1)
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
        fresh = build(device)
        t0 = time.perf_counter()
        check(fresh.restore(tmp) == 1, "restored step 1")
        restore_s = time.perf_counter() - t0
        check(fresh.cache.cfg == card.cache.cfg, "the restore kept the rebalanced layout")
        check(stats_equal(fresh.stats, card.stats), "the restore brought the stats back")
        srv.launches = 0
        for q in batches[:8]:
            v0, h0 = card.serve(q)
            v1, h1 = fresh.serve(q)
            check(np.array_equal(h0, h1) and np.array_equal(v0, v1),
                  "the restored broker serves differently")
        serve_launches += srv.launches
        card.flush()
        fresh.flush()
        same_state(card.state, fresh.state, "after the restore and 8 batches")
        card.save(tmp, 2)
        tamper(os.path.join(tmp, "step_0000000002"))
        try:
            fresh.restore(tmp, step=2)
            check(False, "a flipped byte in arrays.npz must raise")
        except ValueError as e:
            check("checksum" in str(e), f"the corrupt restore raised {e}")
        check(ckpt_lib.latest_verified_step(tmp) == 1, "latest_verified_step skips the corrupt step")
        fresh.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"broker/checkpoint: save {save_s:.3f} s, restore {restore_s:.3f} s (into a fresh "
          f"from_spec broker), {size / 1e6:.3f} MB; the restored broker served 8 batches as the "
          f"one that never restarted (hits, values, state); a flipped byte in arrays.npz "
          f"raised ValueError and latest_verified_step fell back to step 1")
    card.close()
    launches = {"serve_fused": serve_launches, "probe_and_commit": mig_launches + unf_launches}
    print(f"broker/launches: {launches}")
    return dict(launches=launches, migration_ms=mig_ms, migration_bound_ms=mig_bound,
                migration_nopad_ms=nopad_ms)


# -- phase cluster: the sharded cluster, the open-loop harness and the CLI ------


def cluster_states_equal(card, host, what: str) -> None:
    """Every shard's flushed state words equal between two clusters."""
    card.flush()
    host.flush()
    check(len(card.brokers) == len(host.brokers), f"{what}: shard counts differ")
    for i, (a, b) in enumerate(zip(card.brokers, host.brokers)):
        check(a.cache.cfg == b.cache.cfg, f"{what}: shard {i}'s layouts differ")
        same_state(a.state, b.state, f"{what}, shard {i}")


def cluster_stats_equal(card, host, what: str) -> None:
    check(stats_equal(card.stats, host.stats), f"{what}: the aggregate BrokerStats differ")
    for i, (a, b) in enumerate(zip(card.shard_stats, host.shard_stats)):
        check(stats_equal(a, b), f"{what}: shard {i}'s BrokerStats differ")


def serve_clusters(card, host, batches, threads=None):
    """Serve ``batches`` on both clusters (hit masks and values equal, the
    values the backend's); returns the card's host-clock seconds per batch,
    split into serial and threaded dispatch when ``threads`` (a thread pool)
    serves every other batch's shards in place of the card cluster's
    serial default."""
    secs = {"threaded": [], "serial": []}
    for i, q in enumerate(batches):
        threaded = threads is not None and i % 2 == 1
        pool = card._pool
        if threaded:
            card._pool = threads
        t0 = time.perf_counter()
        v0, h0 = card.serve(q)
        secs["threaded" if threaded else "serial"].append(time.perf_counter() - t0)
        card._pool = pool
        v1, h1 = host.serve(q)
        check(np.array_equal(v0, backend(q)), "a cluster's value differs from the backend's")
        check(np.array_equal(h0, h1) and np.array_equal(v0, v1),
              "the card's cluster and the host engine's serve differently")
    return secs


def reshard_both(card, host, n: int, flush, what: str):
    """Reshard both clusters to ``n`` shards: the card's through one
    ``probe_and_commit`` launch per new shard (checked, each timed with CUDA
    events beside its byte bound), the host engine's with numpy; every new
    shard's state must be bit-equal.  Returns the card's reshard seconds
    split, its migration launches and the per-launch (ms, bound ms)."""
    from repro_torch.kernels.cache_ops import kernel as pac

    live = sum(int((b.state["ks"][:, :WAYS] != 0).sum()) for b in card.brokers)
    before = pac.launches
    with migration_split() as (secs, cap):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card.reshard(n)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    launches = pac.launches - before
    check(launches == n == len(cap.each),
          f"{what}: one probe_and_commit launch per new shard ({launches} for {n})")
    t0 = time.perf_counter()
    host.reshard(n)
    host_s = time.perf_counter() - t0
    cluster_states_equal(card, host, f"{what} (card kernels vs numpy host engine)")
    migrated = [b.stats.migrated for b in card.brokers]
    check(migrated == [b.stats.migrated for b in host.brokers] and sum(migrated) == live,
          f"{what}: every live entry migrated ({sum(migrated)} of {live})")
    times = []
    for pks, *pcommon in cap.each:  # replays for timing: not the path's launches
        ks_t = pks.clone()
        ms = time_device(lambda: pac.probe_and_commit(ks_t, *pcommon), 5, flush,
                         lambda: ks_t.copy_(pks))
        times.append((ms, kernel_bytes(pks, pcommon) / HBM_BYTES_PER_S * 1e3, len(pcommon[0])))
    pac.launches = before + launches
    plan = total - secs["extract_live"] - secs["commit"]
    launch_txt = "; ".join(f"B={b} {ms:.6f} ms (bound {bd:.6f})" for ms, bd, b in times)
    print(f"cluster/{what}: {live} live entries into {n} shards (migrated {migrated}); "
          f"reshard() {total:.6f} s on the host clock: extract {secs['extract_live']:.6f}, plan "
          f"{plan:.6f}, commit {secs['commit']:.6f}; the host engine's {host_s:.3f} s; "
          f"probe_and_commit launches (CUDA events, L2 flushed): {launch_txt}; every shard's "
          f"state bit-equal to the numpy host engine's")
    return dict(total=total, extract=secs["extract_live"], plan=plan, commit=secs["commit"],
                launches=launches, times=times)


def serve_async_both(card, host, batches, depth: int = 8):
    """The batches through ``serve_async``, ``depth`` in flight, on both
    clusters: values the backend's, hit masks equal.  Returns the card's
    host-clock seconds."""
    secs = 0.0
    for g in range(0, len(batches), depth):
        grp = batches[g : g + depth]
        t0 = time.perf_counter()
        outs = [f.result() for f in [card.serve_async(q) for q in grp]]
        secs += time.perf_counter() - t0
        mine = [f.result() for f in [host.serve_async(q) for q in grp]]
        for q, (v0, h0), (v1, h1) in zip(grp, outs, mine):
            check(np.array_equal(v0, backend(q)), "an async value differs from the backend's")
            check(np.array_equal(h0, h1) and np.array_equal(v0, v1),
                  "the card's and the host engine's async serves differ")
    return secs


def open_loop_episode(cluster, workload, policy, crash_s: float, ckpt: str):
    """``run_open_loop`` with shard 2 crashing at virtual time ``crash_s``;
    the checkpoint cut before the stream is where it recovers from.
    Returns the result and the episode's health record."""
    from repro_torch.loadgen import FaultInjectSpec, run_open_loop

    cluster.save(ckpt, step=0)
    cluster.inject_shard_faults(2, FaultInjectSpec(crash_at_s=crash_s))
    t0 = time.perf_counter()
    res = run_open_loop(workload, cluster, policy, collect=True)
    wall = time.perf_counter() - t0
    served = ~np.isnan(res.queue_s)
    ok = np.all(res.values[served] == backend(workload.keys[served]), axis=1)
    health = cluster.shard_health
    record = (tuple(health[2].events), [dataclasses.astuple(h.counters) for h in health],
              [h.state for h in health])
    return res, float(ok.mean()), record, wall


def phase_cluster(device, stats, true_topic, warm, serve, served):
    """The sharded cluster at the serve phase's size (one card: every shard
    on cuda:0), each step held to the numpy host engine's cluster on the CPU;
    then the open-loop harness with a shard crash and the CLI itself."""
    from repro_torch.core.spec import CacheSpec
    from repro_torch.kernels.cache_ops import kernel as pac
    from repro_torch.kernels.cache_ops import serve_kernel as srv
    from repro_torch.kernels.topic_score import kernel as tsk
    from repro_torch.launch.serve import main as serve_cli
    from repro_torch.loadgen import ArrivalSpec, stamp_arrivals
    from repro_torch.serving import (Broker, BucketSpec, Cluster, DispatchSpec, ResilienceSpec,
                                     ServingSpec, state_from_numpy, state_to_numpy)

    batches = served["one_call"]["batches"]
    extra = [serve[i : i + B] for i in range(N_BATCHES * B, len(serve), B)]
    srv.launches = pac.launches = tsk.launches = 0
    spec = ServingSpec(
        cache=CacheSpec.from_strategy("STDv_LRU", ENTRIES, f_s=0.5, f_t=0.4),
        ways=WAYS, value_dim=VDIM, microbatch=B, bucket=BucketSpec(),
        dispatch=DispatchSpec(max_fuse=8, fuse_requests=2 * B),
        # behaviour-neutral until a fault is injected (no timeout)
        resilience=ResilienceSpec(probe_interval_s=0.005),
    )

    def build(dev, **kw):
        return Cluster.from_spec(dataclasses.replace(spec, **kw), stats, [backend],
                                 value_fn=backend, device=dev)

    # 1. shards=1 against a bare Broker.from_spec, both from the warm state
    t0 = time.perf_counter()
    one = build(device, shards=1)
    build_s = time.perf_counter() - t0
    bare = Broker.from_spec(spec, stats, [backend], value_fn=backend, device=device)
    check(one.brokers[0].cache.cfg == bare.cache.cfg, "shards=1 compiles the bare broker's cache")
    one.brokers[0].state = state_from_numpy(warm, device)
    bare.state = state_from_numpy(warm, device)
    secs1 = []
    for q in batches:
        t0 = time.perf_counter()
        v1, h1 = one.serve(q)
        secs1.append(time.perf_counter() - t0)
        v0, h0 = bare.serve(q)
        check(np.array_equal(v1, backend(q)) and np.array_equal(v0, v1) and np.array_equal(h0, h1),
              "the shards=1 cluster serves differently from the bare broker")
    check(stats_equal(one.stats, bare.stats), "shards=1: BrokerStats differ from the bare broker's")
    one.flush()
    bare.flush()
    same_state(one.brokers[0].state, bare.state, "shards=1 against the bare broker")
    bare.close()
    snap = state_to_numpy(one.brokers[0].state)
    snap_stats = dataclasses.replace(one.brokers[0].stats)
    print(f"cluster/shards1: Cluster.from_spec in {build_s:.3f} s; {len(batches)} batches x {B} "
          f"from the warm state equal to a bare Broker.from_spec (values, hits, every "
          f"BrokerStats counter, state), {layer_line(one.stats)}; "
          f"{np.median(secs1) * 1e3:.3f} ms/batch median on the host clock")

    def twin(routing):
        """A shards=1 host-engine cluster on the CPU in ``one``'s state."""
        host = build("cpu", shards=1, engine="host", routing=routing)
        host.brokers[0].state = state_from_numpy(snap, "cpu")
        host.brokers[0].stats = dataclasses.replace(snap_stats)
        return host

    flush = torch.empty(1 << 26, dtype=torch.int32, device=device)  # 256 MiB > L2
    # 2. elastic reshard 1 -> 4 on hash routing, then the 64 batches again
    host = twin("hash")
    rs_hash = reshard_both(one, host, 4, flush, "reshard/hash")
    card = one
    check(card._pool is None, "shards on one card dispatch serially by default")
    check(all(b.device == torch.device("cuda", 0) for b in card.brokers),
          "every shard's cache on cuda:0 (one card)")
    with ThreadPoolExecutor(max_workers=4) as threads:
        secs4 = serve_clusters(card, host, batches, threads)
    cluster_stats_equal(card, host, "hash shards=4")
    cluster_states_equal(card, host, "hash shards=4 after serving")
    print(f"cluster/hash4: {len(batches)} batches on 4 shards equal to the host engine's "
          f"(values, hits, aggregate and per-shard stats, states), {layer_line(card.stats)}; "
          f"ms/batch median on the host clock: serial (the default) "
          f"{np.median(secs4['serial']) * 1e3:.3f}, threaded (every other batch, a pool of 4) "
          f"{np.median(secs4['threaded']) * 1e3:.3f} (shards=1: {np.median(secs1) * 1e3:.3f})")

    # 3. the same on topic routing: every topic's partition on shard tau mod 4
    t_card = build(device, shards=1, routing="topic")
    t_card.brokers[0].state = state_from_numpy(snap, device)
    t_card.brokers[0].stats = dataclasses.replace(snap_stats)
    t_host = twin("topic")
    rs_topic = reshard_both(t_card, t_host, 4, flush, "reshard/topic")
    owned = [set(b.cache.cfg.topic_entries) for b in t_card.brokers]
    check(all(t % 4 == i for i, o in enumerate(owned) for t in o)
          and sum(len(o) for o in owned) == len(set().union(*owned)),
          "topic routing: each topic's partition on one shard, tau mod 4")
    serve_clusters(t_card, t_host, batches)
    cluster_stats_equal(t_card, t_host, "topic shards=4")
    cluster_states_equal(t_card, t_host, "topic shards=4 after serving")
    print(f"cluster/topic4: shards disjoint (topics per shard {[len(o) for o in owned]}); "
          f"{len(batches)} batches equal to the host engine's, {layer_line(t_card.stats)}")
    t_card.close()
    t_host.close()

    # 4. pipelined async dispatch, 8 batches in flight, fused shard calls
    calls0 = sum(b.dispatch_counts.get("one_call", 0) for b in card.brokers)
    async_s = serve_async_both(card, host, batches)
    calls = sum(b.dispatch_counts.get("one_call", 0) for b in card.brokers) - calls0
    cluster_stats_equal(card, host, "serve_async")
    cluster_states_equal(card, host, "serve_async")
    print(f"cluster/async: {len(batches)} batches through serve_async, 8 in flight, in {calls} "
          f"fused shard calls (sync: {4 * len(batches)}); values the backend's, state and stats "
          f"equal to the host engine's; {async_s / len(batches) * 1e3:.3f} ms/batch on the "
          f"host clock")

    # the device's idle share at shards 4 (serial), over the extra batches
    kern = device_kernels(lambda: card.serve(extra[0]),
                          lambda: [card.serve(q) for q in extra[1:]], "the 4-shard cluster")
    busy = kern.busy_us / (len(extra) - 1) / 1e6
    med = float(np.median(secs4["serial"]))
    print(f"cluster/profile: device busy {busy * 1e3:.4f} ms/batch over {len(extra) - 1} "
          f"batches on 4 shards, idle share {1 - busy / med:.4f} of the serial median "
          f"{med * 1e3:.3f} ms")
    for q in extra:  # the host twin catches up on the profiled batches
        host.serve(q)
    cluster_states_equal(card, host, "after the profiled batches")

    # 5. open loop, Poisson at 0.7x capacity, shard 2 crashing halfway
    policy = spec.compiled_batch_policy()
    rate = 0.7 * policy.capacity_rps()
    workload = stamp_arrivals(np.concatenate(batches), ArrivalSpec(rate=rate, seed=SEED))
    crash_s = workload.duration_s / 2
    tmp = tempfile.mkdtemp(prefix="cluster_ckpt_", dir=ROOT / "build")
    try:
        res, avail, rec, wall = open_loop_episode(card, workload, policy, crash_s,
                                                  os.path.join(tmp, "card"))
        res_h, avail_h, rec_h, _ = open_loop_episode(host, workload, policy, crash_s,
                                                     os.path.join(tmp, "host"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rep, rep_h = res.report(), res_h.report()
    check(avail == avail_h == 1.0, f"open-loop availability {avail} (host engine {avail_h})")
    check(rec == rec_h, "the crash episode's health events and counters differ from the host "
          "engine's under the same virtual clock")
    check(np.array_equal(res.hit, res_h.hit) and np.array_equal(res.values, res_h.values),
          "the open loop served differently on the card")
    check((rep.served, rep.shed, rep.deferred) == (rep_h.served, rep_h.shed, rep_h.deferred),
          "the open loop's accounting differs")
    cluster_stats_equal(card, host, "after the open loop")
    c2 = card.shard_health[2].counters
    check(c2.recoveries == 1 and card.stats.degraded > 0,
          "shard 2 crashed, served degraded and recovered once")
    spans = card.shard_health[2].down_spans()
    recovery_s = max((b - a for a, b in spans if b is not None), default=float("nan"))
    s = card.stats
    print(f"cluster/open-loop: Poisson at {rate:.0f} req/s (0.7 x capacity "
          f"{policy.capacity_rps():.0f}), {len(workload)} requests over {workload.duration_s:.6f} "
          f"virtual s, shard 2 crashing at {crash_s:.6f}: served {rep.served}, shed {rep.shed}, "
          f"deferred {rep.deferred}, {len(res.plan.batches)} batches, hit rate {rep.hit_rate:.6f}; "
          f"latency ms p50 {rep.p50_ms:.3f} p99 {rep.p99_ms:.3f} p99.9 {rep.p999_ms:.3f} "
          f"(queueing p99 {rep.queue_p99_ms:.3f}); availability {avail:.4f}, degraded "
          f"{s.degraded}, retried {s.retried}, failed_over {s.failed_over}, recoveries "
          f"{c2.recoveries}, recovery_s {recovery_s:.6f}; the episode's events and counters equal "
          f"to the host engine's; {wall:.3f} s wall")
    card.close()
    host.close()
    del flush

    # 6. the CLI in process on the card: closed loop, then open loop with a crash
    # the CLI's test stream is the second half of its log; its open loop
    # offers 0.7 x the capacity of the same batch policy (max_batch = B)
    n_test = CLI_REQUESTS - int(CLI_REQUESTS * 0.5)
    t_crash = 0.5 * n_test / rate
    argv = ["--requests", str(CLI_REQUESTS), "--entries", str(CLI_ENTRIES), "--batch", str(B),
            "--shards", "4"]
    runs = (("closed", argv + ["--routing", "topic", "--pipeline", "8"]),
            ("open", argv + ["--open-loop", "--fault-shard", f"2@{t_crash:.6f}",
                             "--min-availability", "1.0"]))
    for name, args in runs:
        t0 = time.perf_counter()
        rc = serve_cli(args)
        print(f"cluster/cli-{name}: main({' '.join(args)}) returned {rc} in "
              f"{time.perf_counter() - t0:.3f} s")
        check(rc == 0, f"the CLI's {name}-loop run returned {rc}")
    launches = {"serve_fused": srv.launches, "probe_and_commit": pac.launches,
                "topic_score": tsk.launches}
    check(all(launches.values()), f"phase cluster launched every kernel of its path: {launches}")
    print(f"cluster/launches: {launches}")
    return dict(launches=launches, reshard_hash=rs_hash, reshard_topic=rs_topic)


# -- phase analysis: the paper's hit-rate engine -----------------------------------


def mask_unseen(key_topic, keys, n_train):
    """The topics with every key unseen in training set to ``NO_TOPIC``:
    the exact and the vectorized engines agree only then (the exact one
    knows topics only of training keys)."""
    from repro_torch.core import NO_TOPIC

    topic = np.array(key_topic, copy=True)
    topic[np.bincount(keys[:n_train], minlength=len(topic)) == 0] = NO_TOPIC
    return topic


def masked_stats(vstats, topic):
    """``VecStats.from_log`` of the log with ``mask_unseen``'s topics, from
    the unmasked stats: only unseen keys changed, so every rank stays and
    the topics that no training key carries drop out."""
    return dataclasses.replace(vstats, key_topic=topic, topic_distinct={
        t: c for t, c in vstats.topic_distinct.items() if c > 0})


def paper_spec(name: str, n: int):
    from repro_torch.core import CacheSpec

    (f_s, f_t, f_ts), _ = PAPER_STRATEGIES[name]
    return CacheSpec.from_strategy(name, n, f_s=f_s, f_t=f_t, f_ts=f_ts)


def paper_comparison(device):
    """The six strategies on the default SynthConfig stream: the card's
    reuse-distance hits, the host's exact simulation and the reference's
    counts all equal; Bélády's bound beside them."""
    from repro_torch.core import (TrainStats, VecLog, VecStats, analyze, belady_hits, hit_rate,
                                  simulate)
    from repro_torch.querylog import SynthConfig, generate_stream

    keys, true_topic = generate_stream(SynthConfig())
    n_train = int(0.7 * len(keys))
    train, test = keys[:n_train].tolist(), keys[n_train:].tolist()
    topic = mask_unseen(true_topic, keys, n_train)
    log = VecLog(keys, n_train, topic)
    vst = VecStats.from_log(log)
    shortcut = masked_stats(VecStats.from_log(VecLog(keys, n_train, true_topic)), topic)
    check(all(np.array_equal(getattr(vst, f.name), getattr(shortcut, f.name))
              if isinstance(getattr(vst, f.name), np.ndarray)
              else getattr(vst, f.name) == getattr(shortcut, f.name)
              for f in dataclasses.fields(vst)), "masked_stats equals VecStats.from_log")
    tstats = TrainStats.from_stream(train, {k: int(t) for k, t in enumerate(topic) if t >= 0})
    n_test = len(test)
    hits = {}
    for name, (_, want) in PAPER_STRATEGIES.items():
        spec = paper_spec(name, PAPER_N)
        layout = spec.to_layout(vst)
        t0 = time.perf_counter()
        ana = analyze(log, layout, device=device)
        card = ana.hits(layout.capacity)
        rate = hit_rate(log, layout, analysis=ana)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        exact = simulate(spec.to_exact(tstats), test, warm_keys=train).hits
        t_exact = time.perf_counter() - t0
        print(f"analysis/paper: {name} N={PAPER_N}: card {card} hits ({rate:.6f}) in "
              f"{t_card:.3f} s, exact simulation {exact} in {t_exact:.3f} s, reference {want}")
        check(card == exact == want, f"{name}: card {card}, exact {exact}, reference {want}")
        hits[name] = card
    t0 = time.perf_counter()
    opt = belady_hits(keys, PAPER_N, count_from=n_train)
    print(f"analysis/paper: Bélády N={PAPER_N}: {opt} hits ({opt / n_test:.6f}) in "
          f"{time.perf_counter() - t0:.3f} s, reference {PAPER_BELADY}")
    check(opt == PAPER_BELADY, f"Bélády {opt} hits, reference {PAPER_BELADY}")
    sdc = hits["SDC"]
    for name in ("STDf_LRU", "STDv_LRU", "STDv_SDC_C2"):
        gain = hits[name] - sdc
        print(f"analysis/paper: {name} over SDC {gain / n_test:+.6f}, gap reduction "
              f"(STD - SDC) / (Bélády - SDC) {gain / (opt - sdc):.4f}")


def rd_against_cpu_and_oracle(device, keys):
    """The card's reuse distances on prefixes of the x100 stream against the
    CPU's (``torch.sort`` there is another implementation) and the Fenwick
    oracle's."""
    from repro_torch.core.fast import partitioned_prev
    from repro_torch.core.torch_sim import reuse_distances, reuse_distances_py

    head = torch.from_numpy(keys[:RD_CPU_POSITIONS]).to(device)
    _, prev = partitioned_prev(head, torch.zeros_like(head))  # one partition
    prev = prev.cpu().numpy()
    t0 = time.perf_counter()
    card = reuse_distances(prev, device)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = reuse_distances(prev, "cpu")
    t_cpu = time.perf_counter() - t0
    check(np.array_equal(card, cpu), "the card's reuse distances equal the CPU's")
    few = prev[:RD_ORACLE_POSITIONS]
    t0 = time.perf_counter()
    oracle = reuse_distances_py(few)
    t_py = time.perf_counter() - t0
    check(np.array_equal(reuse_distances(few, device), oracle),
          "the card's reuse distances equal the Fenwick oracle's")
    check(np.array_equal(card[:RD_ORACLE_POSITIONS], oracle), "a prefix's distances are its own")
    print(f"analysis/rd: {len(prev)} positions ({int((card >= 0).sum())} repeats) equal on the "
          f"card ({t_card:.3f} s with the copies) and the CPU ({t_cpu:.3f} s); the first "
          f"{len(few)} equal the Fenwick oracle's ({t_py:.3f} s)")


def analysis_against_cpu(device, log, layout):
    """``analyze`` on the card against the CPU (another sort's
    implementation) on the first ``RD_CPU_POSITIONS`` of the x100 stream,
    70% of them warm-up, under a layout of many partitions: the densified
    partition ids (``DYNAMIC_PART`` is 10**9), the chained sorts and the
    scatter back to stream positions, integer for integer."""
    from repro_torch.core import ALWAYS_HIT, NO_CACHE, VecLog, analyze

    n = RD_CPU_POSITIONS
    head = VecLog(log.keys[:n], int(0.7 * n), log.key_topic)
    t0 = time.perf_counter()
    card = analyze(head, layout, device=device)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = analyze(head, layout, device="cpu")
    t_cpu = time.perf_counter() - t0
    check(torch.equal(card.part_pos.cpu(), cpu.part_pos), "the card routes as the CPU does")
    check(torch.equal(card.rd.cpu(), cpu.rd), "the card's partitioned distances equal the CPU's")
    hits = card.hits(layout.capacity)
    check(hits == cpu.hits(layout.capacity), "the card's hits equal the CPU's")
    hist_card, hist_cpu = card.hit_histograms(HIST_CAP), cpu.hit_histograms(HIST_CAP)
    check(hist_card.keys() == hist_cpu.keys()
          and all(np.array_equal(hist_card[p], hist_cpu[p]) for p in hist_cpu),
          "the card's histograms equal the CPU's")
    parts = torch.unique(cpu.part_pos)
    n_parts = int(((parts != ALWAYS_HIT) & (parts != NO_CACHE)).sum())
    print(f"analysis/x100: analyze on the first {n} positions, {n_parts} LRU partitions, equal "
          f"on the card ({t_card:.3f} s with the copies) and the CPU ({t_cpu:.3f} s): routes, "
          f"distances, {hits} hits, histograms to {HIST_CAP}")


def check_trace(ana, layout, max_cap: int):
    """Cheap invariants at full size: each distance below the position
    within its partition, the histograms monotone and ending at the counted
    repeats below ``max_cap``, ``hits`` at the layout's capacities equal to
    the histograms read there.  Returns ``(static, topic, dynamic)`` hits."""
    from repro_torch.core import ALWAYS_HIT, DYNAMIC_PART, NO_CACHE

    live = torch.nonzero((ana.part_pos != ALWAYS_HIT) & (ana.part_pos != NO_CACHE)).squeeze(1)
    part = ana.part_pos[live]
    order = torch.sort(part, stable=True).indices
    part = part[order]
    within = torch.empty_like(order)
    within[order] = torch.arange(len(order), device=order.device) - torch.searchsorted(part, part)
    rd = ana.rd[live]
    check(bool((rd < within).all()),
          "every reuse distance is below its position within its partition")
    del live, part, order, within, rd
    hist = ana.hit_histograms(max_cap)
    sel = ana.count_mask & (ana.rd >= 0) & (ana.rd < max_cap)
    parts, counts = torch.unique(ana.part_pos[sel], return_counts=True)
    below = dict(zip(parts.tolist(), counts.tolist()))
    for p, h in hist.items():
        check(bool(np.all(h[1:] >= h[:-1])) and h[0] == 0, f"partition {p}'s histogram is monotone")
        check(int(h[-1]) == below.get(p, 0), f"partition {p}'s histogram ends at its repeats")
    static = ana.static_hits()
    per = {p: int(hist[p][min(c, max_cap)]) if p in hist else 0
           for p, c in layout.capacity.items()}
    check(ana.hits(layout.capacity) == static + sum(per.values()),
          "hits at the layout's capacities equal the histograms read there")
    dyn = per.get(DYNAMIC_PART, 0)
    return static, sum(per.values()) - dyn, dyn


def phase_analysis(device, keys, true_topic, n_train, vstats, served):
    """The paper's hit-rate engine: the comparison of the six strategies on
    the 2M-request stream held to the exact simulator and the reference,
    the card's reuse distances held to the CPU's and the oracle's, then
    every strategy and one LRU of every size analysed on the x100 stream
    at the serving cache's size."""
    from repro_torch.core import VecLog, analyze, lru_hits_all_sizes

    t0 = time.perf_counter()
    paper_comparison(device)
    print(f"analysis/paper: {time.perf_counter() - t0:.3f} s")
    rd_against_cpu_and_oracle(device, keys)

    topic = mask_unseen(true_topic, keys, n_train)
    log = VecLog(keys, n_train, topic)
    stats = masked_stats(vstats, topic)
    n_test = len(keys) - n_train
    n_served = N_BATCHES * B
    served_mask = torch.zeros(len(keys), dtype=torch.bool, device=device)
    served_mask[n_train : n_train + n_served] = True
    peak = 0
    for name in X100_STRATEGIES:
        t0 = time.perf_counter()
        layout = paper_spec(name, ENTRIES).to_layout(stats)
        t_layout = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ana = analyze(log, layout, device=device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        mem = torch.cuda.max_memory_allocated()
        peak = max(peak, mem)
        t0 = time.perf_counter()
        static, topical, dyn = check_trace(ana, layout, ENTRIES)
        hits = static + topical + dyn
        print(f"analysis/x100: {name} N={ENTRIES}: hit rate {hits / n_test:.6f} (static "
              f"{static / n_test:.6f}, topic {topical / n_test:.6f}, dynamic {dyn / n_test:.6f}) "
              f"over {n_test} requests; analyze {secs:.3f} s on the card (host clock, "
              f"synchronised), peak {mem / 1e9:.3f} GB; layout {t_layout:.3f} s on the host, "
              f"checks {time.perf_counter() - t0:.3f} s")
        if name == "STDv_SDC_C2":
            analysis_against_cpu(device, log, layout)
        if name == "STDv_LRU":
            exact = dataclasses.replace(ana, count_mask=served_mask).hits(layout.capacity)
            print(f"analysis/x100: STDv_LRU on the {n_served} served requests: exact LRU layers "
                  f"{exact / n_served:.6f}, the serve phase's set-associative cache "
                  f"{served['one_call']['stats'].hit_rate:.6f} (planned with the unmasked "
                  f"topics, warmed by the last {N_WARM} training batches)")
        del ana
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lru = lru_hits_all_sizes(log, ENTRIES, device=device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    mem = torch.cuda.max_memory_allocated()
    peak = max(peak, mem)
    check(len(lru) == ENTRIES + 1 and lru[0] == 0 and bool(np.all(np.diff(lru) >= 0)),
          "an LRU's hits are monotone in its size")
    sizes = [ENTRIES >> k for k in (12, 8, 4, 2, 0)]
    print(f"analysis/x100: one LRU of every size to {ENTRIES} from one pass in {secs:.3f} s, "
          f"peak {mem / 1e9:.3f} GB: hit rate "
          + ", ".join(f"{n} {lru[n] / n_test:.6f}" for n in sizes))
    del served_mask
    torch.cuda.empty_cache()
    print(f"analysis/memory: peak {peak / 1e9:.3f} GB allocated in an analysis")
    return dict(peak=peak)


# -- phase 7: the topic pipeline --------------------------------------------------


def train_frac_for(n: int, n_train: int) -> float:
    """The ``train_frac`` whose ``int(n * frac)`` split is ``n_train``."""
    frac = n_train / n
    while int(n * frac) < n_train:
        frac = float(np.nextafter(frac, 1.0))
    while int(n * frac) > n_train:
        frac = float(np.nextafter(frac, 0.0))
    check(int(n * frac) == n_train, "a train_frac that splits at the served stream")
    return frac


def purity(key_topic, true_topic, k_lda: int, k_true: int):
    """Per LDA topic, the share of its classified queries whose true topic
    is the topic's majority; returns ``(overall share, per-topic shares)``."""
    sel = key_topic >= 0
    pair = np.bincount(key_topic[sel] * k_true + np.maximum(true_topic[sel], 0),
                       minlength=k_lda * k_true).reshape(k_lda, k_true)
    size = pair.sum(1)
    per = pair.max(1)[size > 0] / size[size > 0]
    return float(pair.max(1).sum() / max(size.sum(), 1)), per


def small_pipeline_check(device) -> None:
    """On a small log the card's pipeline (EM with atomics, the kernel)
    must equal the CPU's (the plain versions): phi within rtol 1e-6, and
    the same topic for every query but those whose two best CPU scores
    lie within ``TOPIC_RTOL``."""
    from repro_torch.querylog import SynthConfig, generate
    from repro_torch.topics import run_pipeline

    cfg = SynthConfig(n_requests=200_000, n_topical_queries=15_000, n_notopic_queries=6_000,
                      n_topics=32, vocab_size=1024, n_buckets=256, seed=SEED + 1)
    runs = {}
    for dev in (device, "cpu"):
        log = generate(cfg, device=dev)
        runs[str(dev)] = run_pipeline(log, lda_iters=LDA_ITERS, lda_subsample=3_000,
                                      seed=SEED, device=dev)
    gpu, cpu = runs[str(device)], runs["cpu"]
    phi_g, phi_c = gpu.model.phi.cpu().double(), cpu.model.phi.double()
    rel = float(((phi_g - phi_c).abs() / phi_c.abs()).max())
    kt_g, kt_c = gpu.assignment.key_topic, cpu.assignment.key_topic
    differ = np.flatnonzero(kt_g != kt_c)
    print(f"topics/small: card vs cpu on a {cfg.n_requests}-request log (K={cfg.n_topics}, "
          f"V={cfg.vocab_size}): phi max rel diff {rel:.3e}, key_topic differs on "
          f"{len(differ)}/{len(kt_c)} queries, topical fraction "
          f"{gpu.topical_request_fraction:.6f} / {cpu.topical_request_fraction:.6f}")
    check(rel <= 1e-6, "the card's EM phi is not within rtol 1e-6 of the CPU's")
    if len(differ):  # allowed only where the CPU's top two scores nearly tie
        from repro_torch.topics import BagOfWords, infer_scores

        check(bool(np.all((kt_g[differ] >= 0) & (kt_c[differ] >= 0))),
              "the card and the CPU classify different queries")
        bow = BagOfWords.from_docs([log.doc(q) for q in differ], cfg.vocab_size, device="cpu")
        sc = infer_scores(cpu.model, bow).numpy()
        i = np.arange(len(differ))
        gap = np.abs(sc[i, kt_g[differ]] - sc[i, kt_c[differ]])
        check(bool(np.all(gap <= TOPIC_RTOL * np.abs(sc[i, kt_c[differ]]))),
              "the card's topics differ from the CPU's beyond near-ties")


def phase_topics(device, cfg, keys, true_topic, n_train, served, static_truth):
    """The serving CLI's start-up path on the card: log -> LDA -> topics ->
    plan -> serve with the LDA topics."""
    from repro_torch.kernels.cache_ops import serve_kernel as srv
    from repro_torch.kernels.topic_score import kernel as tsk
    from repro_torch.kernels.topic_score import ops as ts_ops
    from repro_torch.querylog import generate
    from repro_torch.topics import lda, run_pipeline

    t0 = time.perf_counter()
    log = generate(cfg, device=device)
    gen_s = time.perf_counter() - t0
    check(np.array_equal(log.keys, keys), "generate's keys differ from the served stream's")
    check(np.array_equal(log.true_topic, true_topic), "generate's topics differ from the stream's")
    print(f"topics/generate: {log.n_docs} clicked documents, {len(log.doc_tokens)} tokens, "
          f"V={cfg.vocab_size}; keys identical to the served stream's; {gen_s:.3f} s")

    tsk.launches = 0
    with Capture(ts_ops, "topic_score_op", 0) as cap:
        pipe = run_pipeline(log, train_frac=train_frac_for(len(keys), n_train),
                            lda_iters=LDA_ITERS, lda_subsample=LDA_SUBSAMPLE, seed=SEED,
                            device=device)
    launches = tsk.launches
    check(pipe.log.n_train == n_train, "the pipeline splits at the served stream")
    kt = pipe.assignment.key_topic
    classified = pipe.stats.train_freq[log.doc_qid] > 0
    n_cls = int(classified.sum())
    check(launches == -(-n_cls // lda.CHUNK_ROWS),
          f"one topic_score launch per chunk of {lda.CHUNK_ROWS} classified documents "
          f"({launches} launches for {n_cls})")
    check(np.array_equal(np.flatnonzero(kt >= 0), log.doc_qid[classified]),
          "exactly the train-seen clicked queries carry a topic")
    check(kt.max() < cfg.n_topics, "topics lie in [0, K)")
    sec = pipe.seconds
    share, per = purity(kt, true_topic, cfg.n_topics, cfg.n_topics)
    print(f"topics/pipeline: EM on {LDA_SUBSAMPLE} documents x {LDA_ITERS} iterations (K="
          f"{cfg.n_topics}, V={cfg.vocab_size}) {sec['lda']:.3f} s; classified {n_cls} queries "
          f"in {sec['classify']:.3f} s ({n_cls / sec['classify']:.1f} queries/s, "
          f"{launches} topic_score launches); statistics {sec['stats']:.3f} s; topical "
          f"request fraction {pipe.topical_request_fraction:.6f} (paper: 0.65 AOL, 0.58 MSN; "
          f"ground truth {float(np.mean(true_topic[keys[n_train:]] >= 0)):.6f}); purity "
          f"{share:.6f} of classified queries (per LDA topic: min {per.min():.6f}, median "
          f"{np.median(per):.6f}, {int((per >= 0.9).sum())}/{len(per)} topics >= 0.9)")

    t0 = time.perf_counter()
    ccfg, static, n_distinct = plan_cache(pipe.stats)
    cache = make_cache(device, ccfg, static)
    broker = make_broker(cache, kt, device)
    print(f"topics/cache: {cache.n_sets} sets x {WAYS} ways + {len(static)} static keys, "
          f"{cache.k} topic partitions from the LDA statistics; planned in "
          f"{time.perf_counter() - t0:.3f} s")
    phase_warm(broker, keys[:n_train])
    batches = served["one_call"]["batches"]
    broker.warmup([B])
    broker.dispatch_counts.clear()
    srv.launches = 0
    torch.cuda.synchronize()
    hits, _, secs = serve_stream(broker, batches)
    n_launch, counts = srv.launches, dict(broker.dispatch_counts)
    check(counts.get("one_call") == len(batches), "one one_call dispatch per LDA-served batch")
    check(n_launch == len(batches), "one serve_fused launch per LDA-served batch")
    one = served["one_call"]
    truth = layer_split(batches, one["hits"], true_topic, static_truth, one["stats"])
    print(f"topics/serve: {len(batches)} batches x {B} with the LDA topics, "
          f"{layer_split(batches, hits, kt, static, broker.stats)}; ground-truth topics: "
          f"{truth}; every value equal to the backend's; serve_fused launches {n_launch}; "
          f"ms/batch median {np.median(secs) * 1e3:.3f} (host clock)")
    broker.close()
    small_pipeline_check(device)
    return dict(launches=launches, args=cap.args, n_classified=n_cls)


# -- phase 8: the LM behind the cache --------------------------------------------


def lm_profile(params, cache, cfg, tokens, step_s: float, start: int = LM_PROMPT,
               n: int = LM_PROFILE) -> str:
    """Device busy time per decode step (torch profiler) over ``n`` steps
    from the fill level ``start``, against the unprofiled host-clock step."""
    from repro_torch.models import transformer as tf

    cache["len"].fill_(start)
    state = {"cache": cache}

    def steps(first, last):
        for t in range(first, last):
            state["cache"] = tf.decode_step(params, state["cache"], tokens[t], cfg)[1]

    kern = device_kernels(lambda: steps(0, 1), lambda: steps(1, n + 1), "the decode steps")
    busy = kern.busy_us / n / 1e3  # ms per step
    top = sorted(kern, key=lambda e: -e.device_time_total)[:6]
    names = "; ".join(f"{e.key[:60]} {e.device_time_total / n / 1e3:.3f}ms "
                      f"x{e.count / n:.1f}" for e in top)
    ops = sum(e.count for e in kern) / n
    return (f"device busy {busy:.3f} ms/step over {n} steps, {ops:.1f} device ops/step, idle share "
            f"{1 - busy / (step_s * 1e3):.4f} of the unprofiled {step_s * 1e3:.3f} ms; per step: "
            f"{names}")


def plain_comparison():
    """``(compare, tally)``: ``compare`` stands in for a decode layer's
    ``decode_attention_op`` call, runs the plain version and returns it,
    after running the kernel on the same inputs and holding it to the
    plain output (``decode_close``); on a window-slice call it also holds
    the kernel's slice to the kernel's full read with the window
    (LM_WIDE_LEVER_RTOL).  ``tally`` keeps the calls compared, whether all
    held, the largest error and ratio, the smallest RMS, and the lever's
    calls, whether they held and their largest ratio to the bound."""
    from repro_torch.kernels.decode_attention import decode_attention_op as op

    tally = dict(n=0, ok=True, err=0.0, ratio=0.0, rms=float("inf"), lever=0, lever_ok=True,
                 lever_ratio=0.0)

    def compare(q, k, v, cur, *rest, use_kernel=True, **kw):
        want = op(q, k, v, cur, *rest, use_kernel=False, **kw)
        got = op(q, k, v, cur, *rest, **kw)
        ok, err, ratio, rms = decode_close(got, want)
        tally.update(n=tally["n"] + 1, ok=tally["ok"] and ok, err=max(tally["err"], err),
                     ratio=max(tally["ratio"], ratio), rms=min(tally["rms"], rms))
        if kw.get("window_slice") is not None:
            full = op(q, k, v, cur, *rest[:2], kw["window_slice"]).float()
            diff = (got.float() - full).abs()
            bound = (LM_WIDE_LEVER_RTOL * full.abs()
                     + DECODE_BF16_ATOL * float(full.abs().max()))
            tally.update(lever=tally["lever"] + 1,
                         lever_ok=tally["lever_ok"] and bool((diff <= bound).all()),
                         lever_ratio=max(tally["lever_ratio"], float((diff / bound).max())))
        return want

    return compare, tally


def phase_lm(device, miss_ids):
    """gemma-2b at full published width behind the cache: prefill, greedy
    decode through the decode_attention kernel, the same steps with the
    plain attention, and the LM back end on one batch of the serve phase's
    misses."""
    from repro_torch.configs import gemma_2b
    from repro_torch.kernels.decode_attention import kernel as dak
    from repro_torch.launch.serve import lm_backend, query_tokens, top_k_ids
    from repro_torch.models import transformer as tf

    torch.cuda.empty_cache()
    cfg = gemma_2b.CONFIG
    dec = gemma_2b.SHAPES["decode_32k"].dims
    check(dec["seq_len"] == LM_SEQ, "decode_32k keeps its sequence length")
    t0 = time.perf_counter()
    params = tf.init_params(torch.Generator(device=device).manual_seed(SEED), cfg)
    n_params = sum(p.numel() for p in params.parameters())
    # the analytic count leaves out the final norm's scale
    check(n_params == cfg.param_count() + cfg.d_model, "gemma-2b's parameter count")
    cache = tf.init_cache(cfg, LM_BATCH, LM_SEQ, device=device)
    torch.cuda.synchronize()
    kv_gb = 2 * cache["k"].numel() * cache["k"].element_size() / 1e9
    print(f"lm/model: gemma-2b (configs/registry.py) at full width: {cfg.n_layers} layers, "
          f"d {cfg.d_model}, {cfg.n_heads} query heads over {cfg.n_kv_heads} KV head, head_dim "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocabulary {cfg.vocab_size}, {cfg.dtype}; "
          f"{n_params} parameters ({n_params * 2 / 1e9:.3f} GB) from a seeded generator on the "
          f"card; KV cache {LM_BATCH} x {LM_SEQ} ({kv_gb:.3f} GB; decode_32k's batch "
          f"{dec['global_batch']} would need {kv_gb * dec['global_batch'] / LM_BATCH:.3f} GB); "
          f"set up in {time.perf_counter() - t0:.3f} s")

    prompts = np.random.default_rng(SEED + 13).integers(
        0, cfg.vocab_size, size=(LM_BATCH, LM_PROMPT), dtype=np.int64)
    first = torch.empty((LM_BATCH, cfg.vocab_size), dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the prompts' f32 attention scores of bf16 operands on the TF32 tensor
    # cores: the products are exact there, the sums are not IEEE f32 (as an
    # XLA bf16 dot with f32 accumulation is not); the rest of the run keeps
    # IEEE f32, the yardstick of the kernels' checks
    with tf32():
        for i in range(0, LM_BATCH, LM_PREFILL_BATCH):
            tok = torch.from_numpy(prompts[i : i + LM_PREFILL_BATCH]).to(device)
            logits, pc = tf.prefill(params, tok, cfg, max_len=LM_SEQ)
            first[i : i + LM_PREFILL_BATCH] = logits
            cache["k"][:, i : i + LM_PREFILL_BATCH] = pc["k"]
            cache["v"][:, i : i + LM_PREFILL_BATCH] = pc["v"]
            del pc
    cache["len"].fill_(LM_PROMPT)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    check(bool(torch.isfinite(first).all()), "prefill logits are finite")
    print(f"lm/prefill: {LM_BATCH} prompts x {LM_PROMPT} tokens, {LM_PREFILL_BATCH} per call, "
          f"plain chunked attention (q_chunk {cfg.q_chunk}, TF32 score products): {pre_s:.3f} s, "
          f"{LM_BATCH * LM_PROMPT / pre_s:.1f} tokens/s")

    # greedy decode through the kernel; the counts read only this run
    nxt = first.argmax(dim=-1, keepdim=True)
    tokens, kept = [nxt], []
    dak.launches = 0
    # the last step's last layer: its K/V (one layer's full cache) are cloned
    with Capture(tf, "decode_attention_op", LM_STEPS * cfg.n_layers - 1) as cap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(LM_STEPS):
            logits, cache = tf.decode_step(params, cache, tokens[t], cfg)
            if t < LM_PLAIN_STEPS:
                kept.append(logits)
            tokens.append(logits.argmax(dim=-1, keepdim=True))
        enqueue_s = (time.perf_counter() - t0) / LM_STEPS  # the host's share
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / LM_STEPS
    launches = dak.launches
    check(launches == cfg.n_layers * LM_STEPS,
          f"decode_attention launches {launches} == {cfg.n_layers} layers x {LM_STEPS} steps")
    check(int(cache["len"]) == LM_SEQ, "the cache is full after the decode steps")
    check(all(bool(torch.isfinite(x).all()) for x in kept), "decode logits are finite")
    print(f"lm/decode: {LM_STEPS} greedy steps x batch {LM_BATCH} from {LM_PROMPT} to {LM_SEQ} "
          f"cached positions: {step_s * 1e3:.3f} ms/step (host clock, synchronised at the end; "
          f"the host had enqueued them at {enqueue_s * 1e3:.3f} ms/step), "
          f"{LM_BATCH / step_s:.1f} tokens/s; decode_attention launches {launches}")

    # the same steps, teacher-forced by the kernel path's tokens, with the
    # plain decode attention; the slots past a step's position are masked,
    # so the cache the kernel run filled serves as the prefilled one.  Each
    # layer's plain call is also run through the kernel on the same inputs
    # (comparison launches, counted apart from the path's)

    compare, layers = plain_comparison()
    cache["len"].fill_(LM_PROMPT)
    worst, worst_rel, flips, near, peak = 0.0, 0.0, 0, 0, 0.0
    with patched(tf, "decode_attention_op", compare):
        for t in range(LM_PLAIN_STEPS):
            logits, cache = tf.decode_step(params, cache, tokens[t], cfg, use_kernel=False)
            scale = logits.abs().amax(dim=-1, keepdim=True)
            diff = (logits - kept[t]).abs()
            worst = max(worst, float(diff.max()))
            worst_rel = max(worst_rel, float((diff / scale).max()))
            peak = max(peak, float(scale.max()))
            differ = torch.nonzero(logits.argmax(dim=-1) != tokens[t + 1][:, 0])[:, 0]
            flips += len(differ)
            if len(differ):
                top2 = logits[differ].topk(2, dim=-1).values
                near += int(((top2[:, 0] - top2[:, 1]) <= LM_LOGIT_RTOL * scale[differ, 0]).sum())
    check(layers["n"] == cfg.n_layers * LM_PLAIN_STEPS, "every plain layer call was compared")
    check(dak.launches == launches + layers["n"],
          "the plain path launched no kernel beyond its comparisons")
    print(f"lm/plain: {LM_PLAIN_STEPS} teacher-forced steps with the plain decode attention: "
          f"each of their {layers['n']} layer calls through the kernel on the same inputs: max "
          f"abs err {layers['err']:.3e}, {layers['ratio']:.4f} of the bound (one bf16 ulp + "
          f"{DECODE_BF16_ATOL} of the largest output; smallest output RMS {layers['rms']:.3e}); "
          f"logits max abs diff {worst:.6f}, {worst_rel:.6f} of the row's largest |logit| "
          f"(tolerance {LM_LOGIT_RTOL}; largest |logit| {peak:.3f}); greedy tokens differ on "
          f"{flips} of {LM_PLAIN_STEPS * LM_BATCH}, {near} of them where the plain top two lie "
          f"within the tolerance")
    check(layers["ok"], f"decode_attention != plain on the decode path's layer calls "
          f"({layers['ratio']:.4f} of the bound)")
    check(worst_rel <= LM_LOGIT_RTOL, f"kernel and plain decode logits differ by {worst_rel}")
    check(near == flips, "the greedy tokens differ beyond near-ties")

    # the control: step 0 with every layer's attention output zeroed.  Where
    # this too stays within LM_LOGIT_RTOL, the logit check cannot see the
    # attention and only the layer comparison above holds the kernel
    cache["len"].fill_(LM_PROMPT)
    with patched(tf, "decode_attention_op", lambda q, *a, **kw: torch.zeros_like(q)):
        ctrl = tf.decode_step(params, cache, tokens[0], cfg)[0]
    ctrl_rel = float(((ctrl - kept[0]).abs() / kept[0].abs().amax(dim=-1, keepdim=True)).max())
    ctrl_flips = int((ctrl.argmax(dim=-1) != tokens[1][:, 0]).sum())
    print(f"lm/control: step 0 with every attention output zeroed moves the logits by "
          f"{ctrl_rel:.6f} of the row's largest |logit| and changes {ctrl_flips} of "
          f"{LM_BATCH} greedy tokens: the logit check {'can' if ctrl_rel > LM_LOGIT_RTOL else 'cannot'}"
          f" see the attention (tolerance {LM_LOGIT_RTOL})")
    profile_line = lm_profile(params, cache, cfg, tokens, step_s)
    print(f"lm/profile: {profile_line}")

    # the back end the cache calls on a miss
    check(miss_ids is not None and len(miss_ids) > 0, "captured a batch of back-end misses")
    backend_lm = lm_backend(params, cfg, value_dim=VDIM, device=device)
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = backend_lm(miss_ids)
        secs.append(time.perf_counter() - t0)
    check(ids.shape == (len(miss_ids), VDIM) and ids.dtype == np.int32, "back-end ids' layout")
    check(bool(((ids >= 0) & (ids < cfg.vocab_size)).all()), "back-end ids are words")
    check(all(len(set(r)) == VDIM for r in ids.tolist()), "back-end ids are distinct per query")
    # the reference's own way on a few queries: forward's logits at the last
    # position.  Its (16, 8, V) product rounds to bf16 apart from the back
    # end's (16, V) one, so a logit may move by an ulp and reorder near-ties:
    # rank by rank, the chosen ids must score within an ulp in forward's logits
    few = torch.from_numpy(query_tokens(miss_ids[:16], cfg.vocab_size)).to(device)
    full = tf.forward(params, few, cfg)[0][:, -1]
    want = top_k_ids(full, VDIM)
    got = torch.from_numpy(ids[:16]).to(device).long()
    s_got, s_want = full.gather(1, got), full.gather(1, want)
    check(bool(((s_got - s_want).abs() <= 2.0**-7 * s_want.abs()).all()),
          "the back end's ids score as forward's top-k on 16 queries")
    same = int((got == want).all(dim=1).sum())
    print(f"lm/backend: {len(miss_ids)} missed query ids (one batch of the serve phase) -> "
          f"{VDIM} doc ids each through gemma-2b: {secs[1] * 1e3:.3f} ms per miss batch "
          f"(first call {secs[0] * 1e3:.3f} ms); on 16 of them the ids equal forward's top-k "
          f"on {same} rows, the rest within an ulp of their scores")
    return dict(params=params, cache=cache, cfg=cfg, launches=launches, args=cap.args,
                step_s=step_s)


def wide_decode(params, cache, cfg, first, start: int, n: int, forced=None, use_kernel=True):
    """``n`` greedy decode steps from the fill level ``start``, from the
    token ``first`` or teacher-forced by ``forced``: ``(logits of each
    step, the tokens, s per step)`` on the host clock, synchronised."""
    from repro_torch.models import transformer as tf

    cache["len"].fill_(start)
    tokens, kept = [first], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(n):
        logits, cache = tf.decode_step(params, cache, (forced or tokens)[t], cfg,
                                       use_kernel=use_kernel)
        kept.append(logits)
        tokens.append(logits.argmax(dim=-1, keepdim=True))
    torch.cuda.synchronize()
    return kept, tokens, (time.perf_counter() - t0) / n


def logits_apart(got, want):
    """``(largest difference relative to the row's largest |logit|, greedy
    tokens that differ, how many of them where want's top two lie within
    LM_LOGIT_RTOL)`` over steps."""
    worst, flips, near = 0.0, 0, 0
    for g, w in zip(got, want):
        scale = w.abs().amax(dim=-1, keepdim=True)
        worst = max(worst, float(((g - w).abs() / scale).max()))
        differ = torch.nonzero(g.argmax(dim=-1) != w.argmax(dim=-1))[:, 0]
        flips += len(differ)
        if len(differ):
            top2 = w[differ].topk(2, dim=-1).values
            near += int(((top2[:, 0] - top2[:, 1]) <= LM_LOGIT_RTOL * scale[differ, 0]).sum())
    return worst, flips, near


def wide_lm(device, name: str, batch: int, flush) -> dict:
    """One windowed dense LM at full published width: greedy decode through
    the decode_attention kernel (with gemma2-27b's local layers also through
    the decode_window_slice lever), every layer call of the first steps held
    to the plain version, the lever's logits to the full read's; ms per
    step, the idle share, and the kernel's time on a layer's real call."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.decode_attention import kernel as dak
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain
    from repro_torch.models import transformer as tf

    arch = get_arch(name)
    cfg = arch.config
    dec = arch.shape("decode_32k").dims
    check(dec["seq_len"] == LM_SEQ, "decode_32k keeps its length")
    gen = torch.Generator(device=device).manual_seed(SEED + 51)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(gen, cfg)
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == LM_WIDE_PARAMS[name], f"{name}'s parameter count {n_params}")
    cache = tf.init_cache(cfg, batch, LM_SEQ, device=device)
    cache["k"].normal_(generator=gen)
    cache["v"].normal_(generator=gen)
    first = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen, device=device)
    torch.cuda.synchronize()
    kv_gb = 2 * cache["k"].numel() * cache["k"].element_size() / 1e9
    local = int(cfg.layer_is_local().sum())
    print(f"lm/{name}/model: at full width (configs/registry.py): {cfg.n_layers} layers "
          f"({local} local, window {cfg.window}), d {cfg.d_model}, {cfg.n_heads} query heads "
          f"over {cfg.n_kv_heads} KV heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocabulary "
          f"{cfg.vocab_size}, {cfg.dtype}; {n_params} parameters ({n_params * 2 / 1e9:.3f} GB) "
          f"from a seeded generator on the card; KV cache {batch} x {LM_SEQ} ({kv_gb:.3f} GB, "
          f"drawn from the generator; decode_32k's batch {dec['global_batch']} would need "
          f"{kv_gb * dec['global_batch'] / batch:.3f} GB); set up in "
          f"{time.perf_counter() - t0:.3f} s")
    start = LM_SEQ - LM_WIDE_STEPS

    # the main path: greedy decode through the kernel, the counts from 0
    dak.launches = 0
    full, tokens, full_s = wide_decode(params, cache, cfg, first, start, LM_WIDE_STEPS)
    launches = dak.launches
    check(launches == cfg.n_layers * LM_WIDE_STEPS,
          f"{name}: decode_attention launches {launches} == {cfg.n_layers} x {LM_WIDE_STEPS}")
    check(all(bool(torch.isfinite(x).all()) for x in full), f"{name}: logits are finite")
    out = dict(launches=launches)
    line = (f"lm/{name}/decode: {LM_WIDE_STEPS} greedy steps x batch {batch} from {start} to "
            f"{LM_SEQ} cached positions: {full_s * 1e3:.3f} ms/step (host clock, "
            f"synchronised), {batch / full_s:.1f} tokens/s; decode_attention launches "
            f"{launches}")
    run_cfg, path = cfg, full
    if local:  # the same steps through the lever, teacher-forced by the full read's tokens
        run_cfg = dataclasses.replace(cfg, decode_window_slice=True)
        dak.launches = 0
        with Capture(tf, "decode_attention_op", 0) as cap:  # layer 0 (local) of step 0
            path, _, lever_s = wide_decode(params, cache, run_cfg, first, start,
                                           LM_WIDE_STEPS, forced=tokens)
        out["launches"] += dak.launches
        check(dak.launches == cfg.n_layers * LM_WIDE_STEPS,
              f"{name}: decode_attention launches with the lever {dak.launches}")
        line += (f"; with decode_window_slice {lever_s * 1e3:.3f} ms/step, "
                 f"{batch / lever_s:.1f} tokens/s, launches {dak.launches}")
    else:
        with Capture(tf, "decode_attention_op", 0) as cap:
            wide_decode(params, cache, cfg, first, start, 1)
    print(line)

    # the first steps again with the plain decode attention, each layer call
    # also through the kernel on the same inputs (and, with the lever,
    # through the kernel's full read)
    compare, tally = plain_comparison()
    with patched(tf, "decode_attention_op", compare):
        plain, _, _ = wide_decode(params, cache, run_cfg, first, start, LM_WIDE_PLAIN_STEPS,
                                  forced=tokens, use_kernel=False)
    check(tally["n"] == cfg.n_layers * LM_WIDE_PLAIN_STEPS, f"{name}: every layer compared")
    check(tally["lever"] == (local * LM_WIDE_PLAIN_STEPS), f"{name}: every local layer's "
          f"window slice held to the full read")
    spread = logits_apart(plain, path)
    with patched(tf, "decode_attention_op", lambda q, *a, **kw: torch.zeros_like(q)):
        ctrl = wide_decode(params, cache, cfg, first, start, 1, forced=tokens)[0]
    ctrl = logits_apart(ctrl, full)[0]
    lever_line = ""
    if local:
        apart = logits_apart(path, full)
        lever_line = (f"; the window slice within {tally['lever_ratio']:.4f} of its bound from "
                      f"the kernel's full read with the window on each of the {tally['lever']} "
                      f"local layer calls; over the {LM_WIDE_STEPS} steps the lever's logits "
                      f"{apart[0]:.6f} of the row's largest |logit| from the full read's, greedy "
                      f"tokens differ on {apart[1]} of {LM_WIDE_STEPS * batch}")
    print(f"lm/{name}/plain: {LM_WIDE_PLAIN_STEPS} teacher-forced steps with the plain decode "
          f"attention{' and the lever' if local else ''}: each of their {tally['n']} layer "
          f"calls through the kernel on the same inputs: max abs err {tally['err']:.3e}, "
          f"{tally['ratio']:.4f} of the bound (one bf16 ulp + {DECODE_BF16_ATOL} of the "
          f"largest output; smallest output RMS {tally['rms']:.3e}); logits {spread[0]:.6f} of "
          f"the row's largest |logit| from the kernel path's, greedy tokens differ on "
          f"{spread[1]}{lever_line}; control: every attention output zeroed moves step 0's "
          f"logits by {ctrl:.6f} ({ctrl / max(spread[0], 1e-30):.1f}x that spread)")
    check(tally["ok"], f"{name}: decode_attention != plain on a layer call "
          f"({tally['ratio']:.4f} of the bound)")
    check(tally["lever_ok"], f"{name}: the window slice != the full read on a layer call "
          f"({tally['lever_ratio']:.4f} of the bound)")
    if local:
        check(apart[0] <= LM_WIDE_SPREAD * max(spread[0], LM_LOGIT_RTOL),
              f"{name}: the lever's logits differ from the full read's by {apart[0]}, beyond "
              f"{LM_WIDE_SPREAD}x the kernel-to-plain spread {spread[0]}")
    print(f"lm/{name}/profile: " + lm_profile(params, cache, run_cfg, tokens, (
        lever_s if local else full_s), start=start, n=LM_WIDE_PROFILE))

    # the kernel on layer 0's real call (step 0), beside its byte bound
    q, k, v, cur, scale, cap_, win = cap.args
    noop = lambda: None  # noqa: E731
    if local:
        w = cfg.window
        nb = decode_bytes(q, k, int(cur), w)
        out.update(
            slice_ms=time_device(lambda: dak.decode_attention(q, k, v, cur, scale, cap_, None, w),
                                 20, flush, noop),
            full_ms=time_device(lambda: dak.decode_attention(q, k, v, cur, scale, cap_, w), 20,
                                flush, noop),
            plain_ms=time_host(lambda: decode_attention_plain(q, k, v, cur, scale, cap_, None, w),
                               5, flush, noop))
        kind = (f"window slice {out['slice_ms']:.6f} ms, the full read with the window "
                f"{out['full_ms']:.6f} ms, plain (slice) {out['plain_ms']:.6f} ms")
    else:
        nb = decode_bytes(q, k, int(cur), win)
        out.update(full_ms=time_device(lambda: dak.decode_attention(q, k, v, cur, scale, cap_, win),
                                       20, flush, noop),
                   plain_ms=time_host(lambda: decode_attention_plain(q, k, v, cur, scale, cap_,
                                                                     win), 5, flush, noop))
        kind = f"{out['full_ms']:.6f} ms, plain {out['plain_ms']:.6f} ms"
    out["bound_ms"] = nb / HBM_BYTES_PER_S * 1e3
    out["library_ms"], n_keys, lib_err = library_decode_ms(q, k, v, cur, scale,
                                                           cfg.window if local else win, flush)
    b_, hkv, g, d = q.shape
    print(f"lm/{name}/kernel: layer 0's call (B={b_} Hkv={hkv} G={g} d={d} S={k.shape[1]} "
          f"cur={int(cur)}, {q.dtype}): device {kind} (L2 flushed); byte bound "
          f"{out['bound_ms']:.6f} ms ({nb / 1e9:.6f} GB); scaled_dot_product_attention "
          f"(enable_gqa, the {n_keys} kept keys copied out before timing"
          f"{', no softcap' if cap_ else ''}; max abs diff to plain "
          f"{lib_err:.3e}) {out['library_ms']:.6f} ms; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB allocated in this model's run")
    out.update(step_ms=full_s * 1e3, lever_ms=lever_s * 1e3 if local else None)
    del params, cache, cap, q, k, v
    return out


def phase_lm_windowed(device):
    """gemma2-27b and glm4-9b at full width, each after the previous one is
    freed (``wide_lm``)."""
    flush = torch.empty(1 << 26, dtype=torch.int32, device=device)  # 256 MiB > L2
    out = {}
    for name, batch in LM_WIDE:
        out[name] = wide_lm(device, name, batch, flush)
        gc.collect()
        torch.cuda.empty_cache()
    del flush
    return out


def moe_kept(experts, cfg):
    """``(kept (T, k) bool, capacity)``: which slots of an MoE call the
    capacity implementation keeps (the reference's
    ``_capacity_grouped_ffn``: a slot counts when it lies in its own
    expert's window of ``cap`` slots, the window starting at its group's
    start clamped to ``T*k - cap``)."""
    from repro_torch.models import transformer as tf

    flat = experts.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    pos = torch.empty_like(order)
    pos[order] = torch.arange(len(order), device=order.device)
    sizes = tf._group_sizes(flat, cfg.moe.n_experts)
    tk = len(flat)
    cap = tf._capacity(cfg.moe, tk, cfg.moe.n_experts)
    start = (torch.cumsum(sizes, 0) - sizes).clamp(max=tk - cap)
    return (pos - start[flat] < cap).reshape(experts.shape), cap


def moe_float64(x, moe_p, experts, weights, kept, cfg):
    """The routed experts of an MoE call in float64 on the card: ``(out,
    bound)``, out (T, D) the sum over the kept slots of weight times the
    expert's FFN of the token, and bound the first-order rounding chain of
    the bf16 path per element (u = 2**-9, a bf16 rounding):

    * gate and up, ``h = x @ wi``: rounded to bf16, u |h|, after an f32 sum
      of D products;
    * ``p = silu(gate) * up``: the activation (|silu'| <= 1.1) and the
      product each add u of their value;
    * ``y = p @ wo``: the F errors of p, independent roundings, sum to at
      most MOE_LAMBDA times their root-sum-square (probabilistic rounding
      analysis), plus y's own rounding u |y|; each f32 sum of n products
      adds MOE_LAMBDA sqrt(n) 2**-24 of its terms' root-sum-square;
    * the weight's and the weighted product's roundings add 2u |w y|, the
      sum over the k choices u |out|."""
    f, d = cfg.moe.d_ff, cfg.d_model
    u, lam = 2.0**-9, MOE_LAMBDA
    x64 = x.double()
    out = torch.zeros_like(x64)
    err = torch.zeros_like(x64)
    for e in torch.unique(experts).tolist():
        tok, j = torch.nonzero((experts == e) & kept, as_tuple=True)
        if not len(tok):
            continue
        wi = moe_p["wi"][e].double().reshape(-1, 2 * f)
        wo = moe_p["wo"][e].double()
        xs = x64[tok]
        h = xs @ wi
        dh = u * h.abs() + lam * d**0.5 * 2.0**-24 * ((xs * xs) @ (wi * wi)).sqrt()
        g, up, dg, dup = h[:, :f], h[:, f:], dh[:, :f], dh[:, f:]
        a = torch.nn.functional.silu(g)
        pr = a * up
        dp = up.abs() * (1.1 * dg + u * a.abs()) + a.abs() * dup + u * pr.abs()
        y = pr @ wo
        dy = (lam * ((dp * dp) @ (wo * wo)).sqrt() + u * y.abs()
              + lam * f**0.5 * 2.0**-24 * ((pr * pr) @ (wo * wo)).sqrt())
        w = weights[tok, j].double()[:, None]
        out.index_add_(0, tok, w * y)
        err.index_add_(0, tok, w.abs() * (dy + 2 * u * y.abs()))
    return out, err + u * out.abs()


@contextlib.contextmanager
def f32_reductions():
    """bf16 matrix products accumulate in f32 within the block (cuBLAS may
    otherwise reduce split sums in bf16): the rounding chain's premise."""
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev


def moe_check(moe_args, cfg) -> dict:
    """Layer 0's MoE call of the first decode step: its expert choices
    against a float64 router on the card, its output against the float64
    evaluation of the experts it routed to (``moe_float64``), the slots the
    capacity dropped, and the same call through ``impl="ragged"`` and the
    capacity path at a roomy capacity factor (no drops), each held to the
    float64 evaluation of every slot."""
    from repro_torch.models import transformer as tf

    moe_p, x, _ = moe_args
    m = cfg.moe
    probs, weights, experts = tf._route(x, moe_p["router"], cfg)
    logits32 = x.float() @ moe_p["router"].float()
    logits64 = x.double() @ moe_p["router"].double()
    ref_experts = tf.top_k_ids(logits64, m.top_k)
    # a choice may differ from float64's only where f32's rounding of the
    # logits can reorder them: a float64 gap within twice f32's largest error
    err32 = float((logits32.double() - logits64).abs().max())
    ours = logits64.gather(1, experts)
    theirs = logits64.gather(1, ref_experts)
    differ = experts != ref_experts
    near = differ & ((ours - theirs).abs() <= 2 * err32)
    check(bool((differ == near).all()), "MoE expert choices differ from the float64 router's "
          "beyond f32's rounding of the logits")
    kept, cap = moe_kept(experts, cfg)
    with f32_reductions():
        out, _ = tf._moe_ffn(moe_p, x, cfg)
    out64, bound = moe_float64(x, moe_p, experts, weights, kept, cfg)
    ratio = float(((out.double() - out64).abs() / (bound + 1e-30)).max())
    check(ratio <= 1.0, f"the MoE call is {ratio} of its rounding bound from float64")
    every = torch.ones_like(kept)
    all64, all_bound = moe_float64(x, moe_p, experts, weights, every, cfg)
    roomy_cf = float(m.n_experts)  # the window holds every slot
    res = {}
    for label, run_m in (("ragged", dataclasses.replace(m, impl="ragged")),
                         ("capacity, roomy", dataclasses.replace(m, capacity_factor=roomy_cf))):
        with f32_reductions():
            got, _ = tf._moe_ffn(moe_p, x, dataclasses.replace(cfg, moe=run_m))
        res[label] = float(((got.double() - all64).abs() / (all_bound + 1e-30)).max())
        check(res[label] <= 1.0, f"the MoE call through {label} is {res[label]} of its bound")
    roomy_kept, _ = moe_kept(experts, dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=roomy_cf)))
    check(bool(roomy_kept.all()), "the roomy capacity drops nothing")
    dropped = int((~kept).sum())
    print(f"  layer 0's MoE call (T={x.shape[0]}, E={m.n_experts}, top-{m.top_k}, capacity "
          f"{cap} of {experts.numel()} slots): expert choices equal the float64 router's on "
          f"{int((~differ).sum())} of {experts.numel()} ({int(near.sum())} near-ties, f32 logits "
          f"within {err32:.3e}); {dropped} of {experts.numel()} slots dropped by the capacity; "
          f"output within {ratio:.4f} of its rounding bound from the float64 evaluation of its "
          f"routed experts (largest |out| {float(out64.abs().max()):.4e}); impl=\"ragged\" "
          f"{res['ragged']:.4f} and the capacity path at capacity factor {roomy_cf:g} "
          f"{res['capacity, roomy']:.4f} of the bound from float64 with no drops")
    return dict(dropped=dropped, slots=experts.numel(), ratio=ratio, ragged=res["ragged"])


def moe_decode(device, name: str, layers: int, batch: int, flush) -> dict:
    """One MoE LM at full width cut to ``layers``: greedy decode through the
    decode_attention kernel, every layer call of the first steps held to
    the plain version, layer 0's MoE call checked (``moe_check``), ms per
    step and the idle share, the kernel's time on layer 0's call; for
    llama4-scout a prefill."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.decode_attention import kernel as dak
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain
    from repro_torch.models import transformer as tf

    arch = get_arch(name)
    full = arch.config
    cfg = dataclasses.replace(full, n_layers=layers)
    m = cfg.moe
    dec = arch.shape("decode_32k").dims
    gen = torch.Generator(device=device).manual_seed(SEED + 61)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(gen, cfg)
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == cfg.param_count() + cfg.d_model == LM_MOE_PARAMS[name],
          f"{name}'s parameter count {n_params} at {layers} layers")
    cache = tf.init_cache(cfg, batch, LM_SEQ, device=device)
    cache["k"].normal_(generator=gen)
    cache["v"].normal_(generator=gen)
    first = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    kv_gb = 2 * cache["k"].numel() * cache["k"].element_size() / 1e9
    print(f"lm/{name}/model: at full width (configs/registry.py), depth {full.n_layers} cut to "
          f"{layers} layers: d {cfg.d_model}, {cfg.n_heads} query heads over {cfg.n_kv_heads} KV "
          f"heads of {cfg.head_dim}, {m.n_experts} experts top-{m.top_k} of d_ff {m.d_ff} plus "
          f"a dense {m.dense_residual_ff}, vocabulary {cfg.vocab_size}, {cfg.dtype}; {n_params} "
          f"parameters ({n_params * 2 / 1e9:.3f} GB; {full.param_count()} at full depth, "
          f"{full.param_count() * 2 / 1e9:.1f} GB) from a seeded generator on the card; KV "
          f"cache {batch} x {LM_SEQ} ({kv_gb:.3f} GB, drawn from the generator; decode_32k's "
          f"batch {dec['global_batch']}); set up in {setup_s:.3f} s")
    start = LM_SEQ - LM_MOE_STEPS

    # the main path: greedy decode through the kernel, the counts from 0
    dak.launches = 0
    with Capture(tf, "_moe_ffn", 0) as moe_cap, Capture(tf, "decode_attention_op", 0) as cap:
        path, tokens, step_s = wide_decode(params, cache, cfg, first, start, LM_MOE_STEPS)
    launches = dak.launches
    check(launches == layers * LM_MOE_STEPS,
          f"{name}: decode_attention launches {launches} == {layers} x {LM_MOE_STEPS}")
    check(all(bool(torch.isfinite(x).all()) for x in path), f"{name}: logits are finite")
    # the capacity path reads every expert's weights a step
    expert_gb = layers * 3 * m.n_experts * cfg.d_model * m.d_ff * 2 / 1e9
    print(f"lm/{name}/decode: {LM_MOE_STEPS} greedy steps x batch {batch} from {start} to "
          f"{LM_SEQ} cached positions: {step_s * 1e3:.3f} ms/step (host clock, synchronised), "
          f"{batch / step_s:.1f} tokens/s; decode_attention launches {launches}; the experts' "
          f"{expert_gb:.3f} GB read a step take >= {expert_gb / HBM_BYTES_PER_S * 1e12:.3f} ms "
          f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    moe = moe_check(moe_cap.args, cfg)

    compare, tally = plain_comparison()
    with patched(tf, "decode_attention_op", compare):
        plain, _, _ = wide_decode(params, cache, cfg, first, start, LM_MOE_PLAIN_STEPS,
                                  forced=tokens, use_kernel=False)
    check(tally["n"] == layers * LM_MOE_PLAIN_STEPS, f"{name}: every layer call compared")
    spread = logits_apart(plain, path)
    print(f"lm/{name}/plain: {LM_MOE_PLAIN_STEPS} teacher-forced steps with the plain decode "
          f"attention: each of their {tally['n']} layer calls through the kernel on the same "
          f"inputs: max abs err {tally['err']:.3e}, {tally['ratio']:.4f} of the bound (one bf16 "
          f"ulp + {DECODE_BF16_ATOL} of the largest output; smallest output RMS "
          f"{tally['rms']:.3e}); logits {spread[0]:.6f} of the row's largest |logit| from the "
          f"kernel path's (a one-ulp change of an attention output can move a token to another "
          f"expert), greedy tokens differ on {spread[1]} of {LM_MOE_PLAIN_STEPS * batch}")
    check(tally["ok"], f"{name}: decode_attention != plain on a layer call "
          f"({tally['ratio']:.4f} of the bound)")
    print(f"lm/{name}/profile: " + lm_profile(params, cache, cfg, tokens, step_s, start=start,
                                               n=LM_MOE_PROFILE))

    # the kernel on layer 0's real call (step 0), beside its bound and the library
    q, k, v, cur, scale, cap_, win = cap.args
    noop = lambda: None  # noqa: E731
    nb = decode_bytes(q, k, int(cur), win)
    out = dict(launches=launches, step_ms=step_s * 1e3, bound_ms=nb / HBM_BYTES_PER_S * 1e3,
               moe=moe,
               ms=time_device(lambda: dak.decode_attention(q, k, v, cur, scale, cap_, win), 20,
                              flush, noop),
               plain_ms=time_host(lambda: decode_attention_plain(q, k, v, cur, scale, cap_, win),
                                  5, flush, noop))
    out["library_ms"], n_keys, lib_err = library_decode_ms(q, k, v, cur, scale, win, flush)
    b_, hkv, g, d = q.shape
    print(f"lm/{name}/kernel: layer 0's call (B={b_} Hkv={hkv} G={g} d={d} S={k.shape[1]} "
          f"cur={int(cur)}, {q.dtype}): device {out['ms']:.6f} ms (L2 flushed), plain "
          f"{out['plain_ms']:.6f} ms, scaled_dot_product_attention (enable_gqa, {n_keys} keys "
          f"copied out before timing; max abs diff to plain {lib_err:.3e}) "
          f"{out['library_ms']:.6f} ms; byte bound {out['bound_ms']:.6f} ms "
          f"({nb / 1e9:.6f} GB)")
    del cap, q, k, v, moe_cap

    if name == "llama4-scout-17b-a16e":  # one long prompt
        tok = torch.from_numpy(np.random.default_rng(SEED + 62).integers(
            0, cfg.vocab_size, size=(1, LM_MOE_PREFILL), dtype=np.int64)).to(device)
        with torch.no_grad(), tf32():
            tf.prefill(params, tok[:, :1024], cfg)  # the first call sets up the kernels
            (logits, pc), pre_s = timed(lambda: tf.prefill(params, tok, cfg))
        check(bool(torch.isfinite(logits).all()) and int(pc["len"]) == LM_MOE_PREFILL,
              f"{name}: prefill logits finite, the cache filled")
        print(f"lm/{name}/prefill: 1 prompt x {LM_MOE_PREFILL} tokens (prefill_32k's "
              f"{arch.shape('prefill_32k').dims['global_batch']} x "
              f"{arch.shape('prefill_32k').dims['seq_len']} cut), plain chunked attention "
              f"(TF32 score products), the capacity MoE: {pre_s:.3f} s, "
              f"{LM_MOE_PREFILL / pre_s:.1f} tokens/s")
        out["prefill_tok_s"] = LM_MOE_PREFILL / pre_s
        del pc, logits
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"lm/{name}/memory: peak {out['peak_gb']:.3f} GB allocated in this model's run")
    del params, cache
    return out


def moe_train(device) -> dict:
    """llama4-scout at train_4k's width, cut to LM_MOE_TRAIN_LAYERS layers:
    build_lm_step's train step (remat, Adafactor) on one sequence of 4096,
    LM_MOE_TRAIN_STEPS steps; ms per step, MFU, peak, idle share."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_lm_step
    from repro_torch.models import transformer as tf
    from repro_torch.train import SyntheticLM

    arch = get_arch("llama4-scout-17b-a16e")
    arch = dataclasses.replace(arch, config=dataclasses.replace(
        arch.config, n_layers=LM_MOE_TRAIN_LAYERS))
    shape = arch.shape("train_4k")
    step = build_lm_step(arch, shape)
    cfg = step.cfg
    check(step.seq_len == TRAIN_SEQ and cfg.remat and step.optimizer == "adafactor",
          "llama4-scout train_4k: seq_len 4096, remat, Adafactor")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(torch.Generator(device=device).manual_seed(SEED + 63), cfg)
    opt = step.init_opt_state(params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, 1, seed=SEED + 2)
    tokens = [torch.from_numpy(data.batch(i)["tokens"]).to(device)
              for i in range(LM_MOE_TRAIN_STEPS)]
    secs, losses = [], []
    for i in range(LM_MOE_TRAIN_STEPS):
        (_, opt, res), s = timed(lambda: step.fn(params, opt, {"tokens": tokens[i]}))
        secs.append(s)
        losses.append(float(res["loss"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)), f"llama4-scout's training losses are finite: {losses}")
    med = float(np.median(secs[1:]))
    flops = 6.0 * cfg.active_param_count() * TRAIN_SEQ
    kern = device_kernels(lambda: step.fn(params, opt, {"tokens": tokens[0]}),
                          lambda: step.fn(params, opt, {"tokens": tokens[1]}),
                          "llama4-scout's train step")
    busy = kern.busy_us / 1e3
    n_params = sum(p.numel() for p in params.parameters())
    print(f"lm/llama4-scout-17b-a16e/train: train_4k at full width cut to "
          f"{LM_MOE_TRAIN_LAYERS} layer ({n_params} parameters, Adafactor, remat), one "
          f"sequence of {TRAIN_SEQ} (global batch {shape.dims['global_batch']} cut): set up in "
          f"{setup_s:.3f} s; losses {' '.join(f'{x:.6f}' for x in losses)}; ms/step median "
          f"{med * 1e3:.3f} over steps 1-{LM_MOE_TRAIN_STEPS - 1} (step 0 {secs[0] * 1e3:.3f}; "
          f"host clock, synchronised), {TRAIN_SEQ / med:.1f} tokens/s, MFU "
          f"{flops / med / BF16_FLOP_PER_S:.4f} (6 x {cfg.active_param_count()} active "
          f"parameters x {TRAIN_SEQ} tokens over {BF16_FLOP_PER_S / 1e12:.1f} TFLOP/s); peak "
          f"{peak:.3f} GB; device busy {busy:.3f} ms of a profiled step, idle share "
          f"{1 - busy / (med * 1e3):.4f}; by kind: {kernel_kinds(kern, 1)}")
    del params, opt
    return dict(ms=med * 1e3, mfu=flops / med / BF16_FLOP_PER_S, peak=peak)


def moe_smoke_against_cpu(device) -> None:
    """Both MoE archs' smoke configs (f32): build_lm_step's train step
    (Adafactor), LM_MOE_SMOKE_STEPS steps on the card and on the CPU from
    the same weights and batches, the losses within TRAIN_SMOKE_RTOL."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_lm_step
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import tree_map
    from repro_torch.train import SyntheticLM

    for name, _, _ in LM_MOE:
        arch = get_arch(name)
        step = build_lm_step(arch, arch.shape("train_4k"), smoke=True)
        cfg = step.cfg
        data = SyntheticLM(cfg.vocab_size, step.seq_len, step.batch, seed=SEED + 3)
        host = tf.init_params(torch.Generator().manual_seed(SEED), cfg)
        card = tf.ParamTree(tree_map(lambda t: t.detach().to(device, copy=True), host))
        runs = {}
        for where, params, dev in (("card", card, device), ("cpu", host, torch.device("cpu"))):
            state = step.init_opt_state(params)
            runs[where] = [float(step.fn(params, state, {"tokens": torch.from_numpy(
                data.batch(i)["tokens"]).to(dev)})[2]["loss"]) for i in range(LM_MOE_SMOKE_STEPS)]
        a, b = np.asarray(runs["card"]), np.asarray(runs["cpu"])
        rel = float((np.abs(a - b) / np.abs(b)).max())
        check(np.isfinite(a).all() and rel <= TRAIN_SMOKE_RTOL,
              f"{name}: card and CPU losses differ by {rel} relative")
        print(f"lm/{name}/card-vs-cpu: smoke config (f32, {cfg.moe.n_experts} experts top-"
              f"{cfg.moe.top_k}), {LM_MOE_SMOKE_STEPS} Adafactor steps of build_lm_step from "
              f"the same weights: losses {' '.join(f'{x:.6f}' for x in a)} on the card, max "
              f"relative difference to the CPU's {rel:.3e} (tolerance {TRAIN_SMOKE_RTOL})")


def moe_cli(device) -> None:
    """The serving CLI with llama4-scout's smoke config behind the cache, in
    process on the card (its back end replaying CUDA graphs, counted) and
    on the CPU: both return 0 and print the same hit-rate line."""
    import io

    from repro_torch.launch import serve

    replays = [0]

    class Counted:
        def __init__(self, graph):
            self.graph = graph

        def replay(self):
            replays[0] += 1
            self.graph.replay()

    def capture(*a, **kw):
        return {rows: (Counted(g), t, ids) for rows, (g, t, ids) in orig(*a, **kw).items()}

    lines = {}
    for where, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with patched(serve, "_capture_scores", capture) as orig, \
                contextlib.redirect_stdout(buf):
            rc = serve.main(list(LM_MOE_CLI) + extra)
        secs = time.perf_counter() - t0
        hit = [ln for ln in buf.getvalue().splitlines() if ln.startswith("hit_rate=")]
        check(rc == 0 and len(hit) == 1, f"the CLI with an MoE back end on the {where} "
              f"returned {rc}")
        lines[where] = hit[0]
        print(f"lm/moe/cli-{where}: main({' '.join(LM_MOE_CLI + tuple(extra))}) returned {rc} in "
              f"{secs:.3f} s: {hit[0]}" + (f"; {replays[0]} CUDA graph replays of the back end"
                                         if where == "card" else ""))
        if where == "card":
            check(replays[0] > 0, "the card's CLI served its misses through the CUDA graphs")
    check(lines["card"] == lines["cpu"], "the CLI's hit-rate line differs between card and CPU")


def phase_lm_moe(device):
    """The MoE LMs at full width with their depth cut: llama4-scout and
    arctic each decoded (``moe_decode``) after the previous is freed,
    llama4-scout trained, both smoke configs trained against the CPU, and
    the CLI with an MoE back end."""
    flush = torch.empty(1 << 26, dtype=torch.int32, device=device)  # 256 MiB > L2
    out = {}
    for name, layers, batch in LM_MOE:
        out[name] = moe_decode(device, name, layers, batch, flush)
        gc.collect()
        torch.cuda.empty_cache()
    del flush
    out["train"] = moe_train(device)
    gc.collect()
    torch.cuda.empty_cache()
    moe_smoke_against_cpu(device)
    moe_cli(device)
    return out


# -- phase 8b: the mesh: build_step on a mesh of one rank, and the dry-run ---------


def mesh_world(device):
    """A world of one (``nccl`` on a ``HashStore``) and its (1, 1) mesh."""
    from repro_torch.launch.mesh import make_smoke_mesh

    mesh = make_smoke_mesh(device=device)
    check(torch.distributed.get_backend() == "nccl" and mesh.size() == 1,
          "phase mesh: an nccl world of one")
    return mesh


def start_dryrun():
    """The dry-run of every cell on both production meshes, in a subprocess
    on the CPU (its fake process group must not share a process with
    NCCL), in a session of its own (its worker processes are killed with
    it), its log and JSON under build/ (removed after the phase reads them)."""
    out = ROOT / "build" / "dryrun" / "dryrun.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    log = open(out.with_suffix(".log"), "w")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--both-meshes", "--quiet",
         "--json", str(out)], cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True)
    log.close()
    return proc, out, time.perf_counter()


def stop_dryrun(proc) -> None:
    """Kill the dry-run's whole session and reap it."""
    import signal

    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def finish_dryrun(proc, out, t0) -> dict:
    """Wait for the dry-run (DRYRUN_TIMEOUT after its start), check every
    cell, print the largest per-device argument bytes and the cells over
    80 GB."""
    try:
        proc.wait(timeout=max(DRYRUN_TIMEOUT - (time.perf_counter() - t0), 1))
    except subprocess.TimeoutExpired:
        stop_dryrun(proc)
        raise RuntimeError(f"chip_smoke: the dry-run did not finish in {DRYRUN_TIMEOUT} s")
    secs = time.perf_counter() - t0
    log = out.with_suffix(".log").read_text()
    check(proc.returncode == 0, f"the dry-run failed (exit {proc.returncode}): {log[-3000:]}")
    cells = json.loads(out.read_text())
    ok = [c for c in cells if c["status"].startswith("ok")]
    check(len(cells) == DRYRUN_CELLS and len(ok) == len(cells),
          f"dry-run: {len(ok)}/{len(cells)} cells ok, {DRYRUN_CELLS} expected")
    ran = sum("roofline" in c for c in cells)
    big = max(cells, key=lambda c: c["memory"]["argument_bytes_per_device"])
    over = [f"{c['arch']}:{c['shape']}@{c['mesh']}" for c in cells if c["memory"]["over_80gb"]]
    print(f"dryrun: {len(ok)}/{len(cells)} cells ok ({ran} ran on meta DTensors, the rest "
          f"placed with the reason in their status), in {secs:.3f} s on the host; largest "
          f"argument bytes per device {big['memory']['argument_gb_per_device']} GB "
          f"({big['arch']}:{big['shape']} on {big['mesh']}); cells over 80 GB: "
          f"{over or 'none'}")
    shutil.rmtree(out.parent, ignore_errors=True)
    return dict(seconds=secs, ok=len(ok), cells=len(cells), max_gb=big["memory"][
        "argument_gb_per_device"], over=over)


def mesh_decode(device, mesh, arch, batch: int, steps: int, what: str) -> dict:
    """``arch``'s decode_32k at full width (its depth as given), batch cut to
    ``batch``: ``steps`` greedy steps of ``build_step``'s bundle on the mesh
    (decode_attention launches counted from 0), then the same steps through
    the ``mesh=None`` step on the same parameters, cache and tokens; the
    logits bit-equal or within ``decode_close``."""
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.kernels.decode_attention import kernel as dak
    from repro_torch.launch.steps import build_step
    from repro_torch.models import transformer as tf

    cfg = arch.config
    shape = ShapeSpec("decode_32k", "decode", {"seq_len": LM_SEQ, "global_batch": batch})
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 71)
    params = tf.init_params(gen, cfg)
    cache = tf.init_cache(cfg, batch, LM_SEQ, device=device)
    cache["k"].normal_(generator=gen)
    cache["v"].normal_(generator=gen)
    start = LM_SEQ - steps
    cache["len"].fill_(start)
    first = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen, device=device,
                          dtype=torch.int32)
    bundle = build_step(arch, shape, mesh)
    plain = build_step(arch, shape, None)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    step = bundle.jitted()
    # one untimed step warms the path (a process's first DTensor call imports
    # and registers seconds of machinery); it writes slot `start` as step 0 will
    _, warm_s = timed(lambda: step(params, cache, first))
    tokens, got = [first], []
    dak.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, out = step(params, cache, tokens[-1])
        got.append(logits.to_local())
        cache["len"] = out["len"].to_local()
        tokens.append(got[-1].argmax(dim=-1, keepdim=True).to(torch.int32))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    launches = dak.launches
    check(launches == cfg.n_layers * steps,
          f"mesh/{what}: decode_attention launches {launches} == {cfg.n_layers} x {steps}")
    cache["len"] = torch.full((), start, dtype=torch.int32, device=device)
    worst, equal, want = 0.0, True, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps):
        logits, cache = plain.fn(params, cache, tokens[t])
        want.append(logits)
    torch.cuda.synchronize()
    plain_s = (time.perf_counter() - t0) / steps
    for t in range(steps):
        equal = equal and torch.equal(got[t], want[t])
        ok, err, ratio, _ = decode_close(got[t], want[t])
        check(ok, f"mesh/{what}: step {t}'s logits {err} apart from the mesh=None step's")
        worst = max(worst, err)
    print(f"mesh/{what}: decode_32k through build_step on the (1, 1) mesh at full width "
          f"({cfg.n_layers} layers, batch {batch} x {LM_SEQ}, cache drawn from a seed), "
          f"{steps} greedy steps after a warm-up step ({warm_s:.3f} s): {step_s * 1e3:.3f} "
          f"ms/step against {plain_s * 1e3:.3f} through the mesh=None step (host clock, "
          f"synchronised), decode_attention launches {launches}; logits against the mesh=None "
          f"step on the same parameters, cache and tokens: "
          f"{'bit-equal' if equal else 'within decode_close'} (max abs {worst:.3e}); set up "
          f"in {setup_s:.3f} s")
    return dict(launches=launches, equal=equal, ms=step_s * 1e3, plain_ms=plain_s * 1e3)


def mesh_train(device, mesh) -> dict:
    """gemma-2b train_4k at full width, batch cut to TRAIN_BATCH: one step of
    the bundle with ``act_seq_axis="model"`` and one without, each from the
    same weights and fresh AdamW moments, deterministic: the losses and a
    sample of the updated parameters equal."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_step
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import tree_map
    from repro_torch.train import SyntheticLM, init_opt_state

    arch = get_arch("gemma-2b")
    shape = arch.shape("train_4k")
    params = tf.init_params(torch.Generator(device=device).manual_seed(SEED + 73),
                            arch.config).tree()
    # the second step starts from these too (a copy even when params live on the CPU)
    start = tree_map(lambda t: t.detach().to("cpu", copy=True), params)
    data = SyntheticLM(arch.config.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    batch = {"tokens": torch.from_numpy(data.batch(0)["tokens"]).to(device)}
    rng = np.random.default_rng(SEED + 47)
    idx = {name: torch.from_numpy(rng.integers(0, leaf(params).numel(), TRAIN_SAMPLE))
           for name, leaf in TRAIN_ADAMW_LEAVES.items()}
    out = {}
    for name, opts in (("act_seq_axis", {"act_seq_axis": "model"}), ("plain", None)):
        if name == "plain":
            tree_map(lambda t, s: t.detach().copy_(s), params, start)
        bundle = build_step(arch, shape, mesh, opts=opts)
        with deterministic():
            res, secs = timed(lambda: bundle.jitted()(params, init_opt_state(params), batch))
        out[name] = (float(res[2]["loss"]), {k: leaf(params).detach().reshape(-1)[idx[k]].cpu()
                                             for k, leaf in TRAIN_ADAMW_LEAVES.items()}, secs)
        del res  # the moments
        gc.collect()
        torch.cuda.empty_cache()
        print(f"mesh/train/{name}: one step in {secs:.3f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
    (l_seq, s_seq, t_seq), (l_plain, s_plain, t_plain) = out["act_seq_axis"], out["plain"]
    check(l_seq == l_plain and all(torch.equal(s_seq[k], s_plain[k]) for k in s_seq),
          f"mesh/train: act_seq_axis's step != the plain step (loss {l_seq} against {l_plain})")
    print(f"mesh/train: gemma-2b train_4k at full width through build_step, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, one AdamW step with opts act_seq_axis='model' "
          f"({t_seq:.3f} s) and one without ({t_plain:.3f} s) from the same weights: loss "
          f"{l_seq:.6f} both, {TRAIN_SAMPLE} sampled entries of {len(s_seq)} leaves bit-equal")
    return dict(loss=l_seq)


def mesh_two_tower(device, mesh) -> dict:
    """two-tower serve_bulk at full width through build_step on the mesh
    (embedding_bag launches counted from 0), held to the mesh=None serve."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.embedding_bag import kernel as ebk
    from repro_torch.launch.steps import build_step, recsys_fns
    from repro_torch.models import recsys

    arch = get_arch("two-tower-retrieval")
    shape = arch.shape("serve_bulk")
    gen = torch.Generator(device=device).manual_seed(SEED + 79)
    params = recsys.init_two_tower(gen, arch.config)
    batch = recsys_fns(arch, arch.config)[2](shape.dims["batch"], gen)
    bundle = build_step(arch, shape, mesh)
    ebk.launches = 0
    (scores, secs) = timed(lambda: bundle.jitted()(params, batch))
    launches = ebk.launches
    scores = scores.to_local()
    want = build_step(arch, shape, None).jitted()(params, batch)
    check(launches == 2, f"mesh/two-tower: embedding_bag launches {launches} == 2")
    check(torch.equal(scores, want) and bool(torch.isfinite(scores).all()),
          "mesh/two-tower: serve_bulk's scores != the mesh=None serve's")
    print(f"mesh/two-tower: serve_bulk (batch {shape.dims['batch']}) at full width through "
          f"build_step on the mesh in {secs * 1e3:.3f} ms (host clock, synchronised, first "
          f"call), embedding_bag launches {launches}; scores bit-equal to the mesh=None serve")
    return dict(launches=launches)


def mesh_gnn(device, mesh) -> dict:
    """PNA full_graph_sm: one train step with ``dist_edges`` (forward_dist on
    the mesh) and one without, from the same weights: the losses within
    GNN_LOSS_RTOL (f32)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_step, gnn_batch
    from repro_torch.models import gnn
    from repro_torch.models.common import tree_map
    from repro_torch.train import init_opt_state

    arch = get_arch("pna")
    shape = arch.shape("full_graph_sm")
    gen = torch.Generator(device=device).manual_seed(SEED + 83)
    params = gnn.init_params(gen, arch.config)
    batch = {k: v.to(device) for k, v in gnn_batch(arch, shape, gen).items()}
    losses = {}
    for name, opts in (("dist_edges", {"dist_edges": True}), ("plain", None)):
        p = tree_map(lambda t: t.clone(), params)
        _, _, res = build_step(arch, shape, mesh, opts=opts).jitted()(p, init_opt_state(p), batch)
        losses[name] = float(res["loss"])
    rel = abs(losses["dist_edges"] - losses["plain"]) / abs(losses["plain"])
    check(np.isfinite(losses["plain"]) and rel <= GNN_LOSS_RTOL,
          f"mesh/pna: dist_edges' loss {losses['dist_edges']} against {losses['plain']}")
    print(f"mesh/pna: full_graph_sm train through build_step with dist_edges (forward_dist, "
          f"one node shard) and without: losses {losses['dist_edges']:.7f} and "
          f"{losses['plain']:.7f} ({rel:.2e} apart, within {GNN_LOSS_RTOL})")
    return losses


def phase_mesh(device):
    """``build_step`` on a mesh of one rank (an nccl world of one): gemma-2b
    and llama4-scout decode (the shard-local MoE) held to the mesh=None
    path, gemma-2b's act_seq_axis train step, two-tower's serve_bulk and
    PNA's dist_edges step held to the steps without them; the dry-run of
    every cell on both production meshes runs beside them on the host."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    dry = start_dryrun()
    out = {}
    try:
        mesh = mesh_world(device)
        items = (
            ("gemma-2b", lambda: mesh_decode(device, mesh, get_arch("gemma-2b"), LM_BATCH,
                                             MESH_STEPS, "gemma-2b")),
            ("llama4-scout-17b-a16e", lambda: mesh_decode(
                device, mesh, dataclasses.replace(get_arch("llama4-scout-17b-a16e"), config=(
                    dataclasses.replace(get_arch("llama4-scout-17b-a16e").config,
                                        n_layers=LM_MOE[0][1]))),
                LM_MOE[0][2], MESH_STEPS, "llama4-scout-17b-a16e")),
            ("train", lambda: mesh_train(device, mesh)),
            ("two-tower", lambda: mesh_two_tower(device, mesh)),
            ("pna", lambda: mesh_gnn(device, mesh)),
        )
        for name, fn in items:
            t = time.perf_counter()
            out[name] = fn()
            print(f"mesh/{name}: {time.perf_counter() - t:.3f} s")
            gc.collect()
            torch.cuda.empty_cache()
    except BaseException:
        stop_dryrun(dry[0])
        raise
    finally:
        tf.set_moe_mesh(None)
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    t = time.perf_counter()
    out["dryrun"] = finish_dryrun(*dry)
    print(f"mesh/dryrun: waited {time.perf_counter() - t:.3f} s")
    return out


# -- phase 9: training: gemma-2b at full width, the CLI, the recsys losses -----


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` within the block (the
    cuBLAS workspace is set for it at the script's start)."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


def timed(fn):
    """``(fn(), seconds)`` on the host clock, synchronised before and after."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


#: device kernels by kind, for a training step's breakdown (the first
#: pattern that matches a kernel's name; cuBLAS names its f32 SIMT GEMMs
#: ``*f32f32*`` or ``*sgemm*``)
KERNEL_KINDS = (
    ("f32 GEMM", re.compile(r"f32f32|sgemm")),
    ("other GEMM", re.compile(r"gemm|nvjet|xmma", re.I)),
    ("copy/memset", re.compile(r"Memcpy|Memset|copy", re.I)),
    ("elementwise", re.compile(r"elementwise", re.I)),
    ("reduction", re.compile(r"reduce|softmax|norm", re.I)),
)


def kernel_kinds(kern, n: int) -> str:
    """Device ms per step by KERNEL_KINDS (the rest as "other") and each
    kind's share of the busy time, over ``n`` profiled steps."""
    total = sum(e.device_time_total for e in kern)
    by = {}
    for e in kern:
        kind = next((k for k, rx in KERNEL_KINDS if rx.search(e.key)), "other")
        by[kind] = by.get(kind, 0.0) + e.device_time_total
    return "; ".join(f"{k} {v / n / 1e3:.3f} ms ({v / total:.4f})"
                     for k, v in sorted(by.items(), key=lambda kv: -kv[1]))


def split_step(loss_fn, params, opt, batch, cfg, **kw):
    """One more train step in its two halves, each synchronised: ms for the
    loss and gradients, ms for the AdamW update."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.train import AdamWConfig, apply_updates

    (_, grads), s_grad = timed(lambda: value_and_grad(loss_fn)(params, batch, cfg, **kw))
    _, s_opt = timed(lambda: apply_updates(params, grads, opt, AdamWConfig()))
    return s_grad * 1e3, s_opt * 1e3


def adamw_sample(params, opt, idx):
    """Float64 host copies of the sampled entries of each named leaf of the
    parameters and both moments."""
    return {name: tuple(t.detach().reshape(-1)[idx[name]].double().cpu()
                        for t in (leaf(params.tree()), leaf(opt.mu), leaf(opt.nu)))
            for name, leaf in TRAIN_ADAMW_LEAVES.items()}


def check_adamw(before, after, grads, idx, step: int, cfg) -> str:
    """Each sampled parameter within one bf16 ulp of the reference's AdamW
    formula evaluated in float64 from the step's inputs (the clipped
    gradients), the moments within TRAIN_MOMENT_RTOL."""
    lr = cfg.lr * min(1.0, (step + 1) / max(cfg.warmup_steps, 1))
    b1c, b2c = 1.0 - cfg.b1 ** (step + 1), 1.0 - cfg.b2 ** (step + 1)
    worst_p, worst_m = 0.0, 0.0
    for name, leaf in TRAIN_ADAMW_LEAVES.items():
        p, m, v = before[name]
        p2, m2, v2 = after[name]
        g = leaf(grads).detach().reshape(-1)[idx[name]].double().cpu()
        m_ref = cfg.b1 * m + (1 - cfg.b1) * g
        v_ref = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m_ref / b1c) / ((v_ref / b2c).sqrt() + cfg.eps) + cfg.weight_decay * p
        p_ref = p - lr * delta
        ulp = torch.finfo(torch.bfloat16).eps * 2.0 ** torch.floor(torch.log2(
            p_ref.abs().clamp(min=torch.finfo(torch.bfloat16).tiny)))
        err_p = float(((p2 - p_ref).abs() / ulp).max())
        err_m = max(float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
                    for a, b in ((m2, m_ref), (v2, v_ref)))
        check(err_p <= 1.0, f"AdamW on {name}: {err_p} bf16 ulps from the float64 formula")
        check(err_m <= TRAIN_MOMENT_RTOL, f"AdamW moments on {name}: relative error {err_m}")
        worst_p, worst_m = max(worst_p, err_p), max(worst_m, err_m)
    return (f"{sum(len(i) for i in idx.values())} sampled entries of "
            f"{', '.join(TRAIN_ADAMW_LEAVES)}: parameters within {worst_p:.3f} bf16 ulp of "
            f"the float64 formula, moments within {worst_m:.3e} relative")


def remat_check(device, cfg, tokens):
    """Gradients with remat and without, bit for bit, at full width with
    TRAIN_REMAT_LAYERS layers, under deterministic algorithms; and what the
    deterministic algorithms cost there (ms per loss + gradients)."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import tree_leaves

    cut = dataclasses.replace(cfg, n_layers=TRAIN_REMAT_LAYERS)
    params = tf.init_params(torch.Generator(device=device).manual_seed(SEED + 41), cut)
    vg = value_and_grad(tf.loss_fn)
    batch = {"tokens": tokens}
    out, ms = {}, {}
    with deterministic():
        for remat in (True, False):
            out[remat] = vg(params, batch, dataclasses.replace(cut, remat=remat))
        ms["deterministic"] = timed(lambda: vg(params, batch, cut))[1] * 1e3
    vg(params, batch, cut)
    ms["default"] = timed(lambda: vg(params, batch, cut))[1] * 1e3
    (l1, g1), (l0, g0) = out[True], out[False]
    check(torch.equal(l1, l0), "the loss with remat != without")
    leaves = list(zip(tree_leaves(g1), tree_leaves(g0)))
    check(all(torch.equal(a, b) for a, b in leaves), "gradients with remat != without")
    n = sum(a.numel() for a, _ in leaves)
    print(f"train/remat: gemma-2b at full width cut to {TRAIN_REMAT_LAYERS} layers, batch "
          f"{tokens.shape[0]} x {tokens.shape[1]}: loss {float(l1):.6f} and all {n} gradient "
          f"entries ({len(leaves)} leaves) with remat equal to those without, bit for bit "
          f"(deterministic algorithms); loss + gradients {ms['default']:.3f} ms by default, "
          f"{ms['deterministic']:.3f} ms deterministic")
    return ms


def gemma_train(device):
    """gemma-2b at full published width through build_lm_step's train step
    (remat, AdamW), TRAIN_STEPS steps on SyntheticLM."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_lm_step, value_and_grad
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import cross_entropy, tree_map
    from repro_torch.train import AdamWConfig, SyntheticLM, apply_updates

    arch = get_arch("gemma-2b")
    shape = arch.shape("train_4k")
    step = build_lm_step(arch, shape)
    cfg = step.cfg
    check(step.seq_len == TRAIN_SEQ and cfg.remat and step.optimizer == "adamw",
          "train_4k: seq_len 4096, remat, AdamW")
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    tokens = [torch.from_numpy(data.batch(i)["tokens"]).to(device) for i in range(TRAIN_STEPS)]
    det_ms = remat_check(device, cfg, tokens[0])
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(torch.Generator(device=device).manual_seed(SEED), cfg)
    opt = step.init_opt_state(params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == cfg.param_count() + cfg.d_model, "gemma-2b's parameter count")
    flops = 6.0 * cfg.active_param_count() * TRAIN_BATCH * TRAIN_SEQ
    check(step.model_flops == 6.0 * cfg.active_param_count() * shape.dims["global_batch"]
          * TRAIN_SEQ, "train_4k's model_flops")
    print(f"train/model: gemma-2b at full width ({n_params} {cfg.dtype} parameters, AdamW "
          f"moments in f32, remat {cfg.remat}), train_4k: seq_len {TRAIN_SEQ}, global batch "
          f"{shape.dims['global_batch']} cut to {TRAIN_BATCH}; set up in "
          f"{time.perf_counter() - t0:.3f} s")

    # step 0's loss without gradients, for the first-loss check
    with torch.no_grad():
        logits = tf.forward(params, tokens[0], cfg)[0]
        want0 = cross_entropy(logits[:, :-1], tokens[0][:, 1:])
        del logits
    # step 0 from the train step's pieces, sampling the AdamW update
    rng = np.random.default_rng(SEED + 43)
    idx = {name: torch.from_numpy(rng.integers(0, leaf(params.tree()).numel(), TRAIN_SAMPLE))
           for name, leaf in TRAIN_ADAMW_LEAVES.items()}
    before = adamw_sample(params, opt, idx)
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss0, grads = value_and_grad(tf.loss_fn)(params, {"tokens": tokens[0]}, cfg)
    apply_updates(params, grads, opt, AdamWConfig())
    torch.cuda.synchronize()
    secs = [time.perf_counter() - t]
    adamw_line = check_adamw(before, adamw_sample(params, opt, idx), grads, idx, 0,
                             AdamWConfig())
    del grads
    losses = [loss0]
    for i in range(1, TRAIN_STEPS):
        (_, opt, out), s = timed(lambda: step.fn(params, opt, {"tokens": tokens[i]}))
        secs.append(s)
        losses.append(out["loss"])
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"gemma-2b training losses are finite: {losses}")
    check(float(loss0) == float(want0) and torch.equal(loss0, want0),
          f"step 0's loss {float(loss0)} != the no-grad forward's {float(want0)}")
    med = float(np.median(secs[1:]))
    print(f"train/gemma-2b: losses {' '.join(f'{x:.6f}' for x in losses)}; step 0's equal to a "
          f"no-grad forward + cross_entropy bit for bit")
    print(f"train/gemma-2b: ms/step median {med * 1e3:.3f} over steps 1-{TRAIN_STEPS - 1} "
          f"(host clock, synchronised; step 0 {secs[0] * 1e3:.3f}), "
          f"{TRAIN_BATCH * TRAIN_SEQ / med:.1f} tokens/s, model_flops {flops:.4e} a step, MFU "
          f"{flops / med / BF16_FLOP_PER_S:.4f} of {BF16_FLOP_PER_S / 1e12:.1f} TFLOP/s (H100 "
          f"SXM bf16 dense); peak {peak / 1e9:.3f} GB allocated")
    print(f"train/adamw: step 0, {adamw_line}")

    kern = device_kernels(
        lambda: step.fn(params, opt, {"tokens": tokens[0]}),
        lambda: [step.fn(params, opt, {"tokens": tokens[i]}) for i in range(TRAIN_PROFILE)],
        "the gemma-2b train steps")
    busy = kern.busy_us / TRAIN_PROFILE / 1e3  # ms per step
    top = sorted(kern, key=lambda e: -e.device_time_total)[:8]
    names = "; ".join(f"{e.key[:70]} {e.device_time_total / TRAIN_PROFILE / 1e3:.3f}ms "
                      f"x{e.count / TRAIN_PROFILE:.0f}" for e in top)
    print(f"train/profile: device busy {busy:.3f} ms/step over {TRAIN_PROFILE} steps, "
          f"{sum(e.count for e in kern) / TRAIN_PROFILE:.0f} device ops/step, idle share "
          f"{1 - busy / (med * 1e3):.4f} of the unprofiled {med * 1e3:.3f} ms; by kind: "
          f"{kernel_kinds(kern, TRAIN_PROFILE)}; top: {names}")
    ms_grad, ms_opt = split_step(tf.loss_fn, params, opt, {"tokens": tokens[0]}, cfg)
    print(f"train/split: one more step in halves: loss + gradients (forward, remat, backward) "
          f"{ms_grad:.3f} ms, AdamW {ms_opt:.3f} ms ({ms_opt / (ms_grad + ms_opt):.4f} of "
          f"the two)")
    del params, opt, tokens
    return dict(ms=med * 1e3, mfu=flops / med / BF16_FLOP_PER_S, peak=peak, det=det_ms)


def smoke_against_cpu(device):
    """gemma-2b's smoke config in f32, TRAIN_SMOKE_STEPS AdamW steps on the
    card and on the CPU from the same weights and batches."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import _train_step
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import tree_map
    from repro_torch.train import AdamWConfig, SyntheticLM, apply_updates, init_opt_state

    cfg = get_arch("gemma-2b").smoke_config
    check(cfg.dtype == torch.float32, "gemma-2b's smoke config is f32")
    data = SyntheticLM(cfg.vocab_size, 32, 8, seed=SEED + 1)
    host = tf.init_params(torch.Generator().manual_seed(SEED), cfg)
    card = tf.ParamTree(tree_map(lambda t: t.detach().to(device, copy=True), host))
    runs = {}
    for name, params, dev in (("card", card, device), ("cpu", host, torch.device("cpu"))):
        state = init_opt_state(params)
        step = _train_step(tf.loss_fn, cfg, apply_updates, AdamWConfig(lr=3e-3, warmup_steps=5))
        runs[name] = [float(step(params, state, {"tokens": torch.from_numpy(
            data.batch(i)["tokens"]).to(dev)})[2]["loss"]) for i in range(TRAIN_SMOKE_STEPS)]
    a, b = np.asarray(runs["card"]), np.asarray(runs["cpu"])
    rel = float((np.abs(a - b) / np.abs(b)).max())
    drop = float(a[:5].mean() - a[-5:].mean())
    check(np.isfinite(a).all() and rel <= TRAIN_SMOKE_RTOL,
          f"card and CPU losses differ by {rel} relative")
    check(drop >= 0.1, f"the card's loss fell by {drop}, not 0.1")
    print(f"train/card-vs-cpu: gemma-2b smoke config (f32), {TRAIN_SMOKE_STEPS} AdamW steps "
          f"from the same weights: losses {a[0]:.6f} -> {a[-1]:.6f} on the card, "
          f"{b[0]:.6f} -> {b[-1]:.6f} on the CPU, max relative difference {rel:.3e} "
          f"(tolerance {TRAIN_SMOKE_RTOL}); last five average {drop:.4f} below the first five")


def cli_kill_and_resume() -> None:
    """The training CLI on the card, three subprocesses: uninterrupted,
    killed at step 30, resumed; the step-59 parameters bit-equal."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    tmp = tempfile.mkdtemp(prefix="train_ckpt_", dir=ROOT / "build")
    try:
        def run(ckpt, extra, rc):
            t = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--device", "cuda",
                 *TRAIN_CLI, "--ckpt-dir", ckpt, *extra],
                capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
            check(p.returncode == rc, f"train CLI {extra} exited {p.returncode}, not {rc}: "
                  f"{p.stdout[-2000:]} {p.stderr[-4000:]}")
            return p.stdout, time.perf_counter() - t

        d1, d2 = os.path.join(tmp, "full"), os.path.join(tmp, "split")
        # the uninterrupted and the killed run side by side: each is mostly
        # process start-up, and each process is deterministic on its own
        with ThreadPoolExecutor(2) as pool:
            first = pool.submit(run, d1, [], 0)
            out2, s2 = run(d2, ["--kill-at", "30"], 42)
            out1, s1 = first.result()
        from repro_torch.train import checkpoint as ck

        check(ck.latest_step(d2) == 20, f"the killed run's latest step {ck.latest_step(d2)}")
        check("simulating node failure at step 30" in out2, "the kill line")
        out3, s3 = run(d2, ["--resume"], 0)
        check("resumed from step 20" in out3, "resumed from step 20")
        with np.load(os.path.join(d1, f"step_{59:010d}", "arrays.npz")) as a, \
                np.load(os.path.join(d2, f"step_{59:010d}", "arrays.npz")) as b:
            check(sorted(a.files) == sorted(b.files), "the two runs' checkpoint keys")
            keys = [k for k in a.files if k.startswith("params/")]
            check(all(np.array_equal(a[k], b[k]) for k in keys),
                  "the resumed run's step-59 parameters != the uninterrupted run's")
        last = [line for line in out1.splitlines() if line.startswith("step ")][-1]
        print(f"train/cli: python -m repro_torch.launch.train --device cuda {' '.join(TRAIN_CLI)}:"
              f" uninterrupted {s1:.3f} s ('{last}') beside the run killed at 30 (exit 42, "
              f"latest step 20) {s2:.3f} s, then resumed from 20 {s3:.3f} s; the step-59 "
              f"parameters ({len(keys)} leaves) equal bit for bit")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def two_tower_train(device):
    """Two-tower at full width: one step through the kernel and the same step
    with use_kernel=False from the same (initial) state, bit for bit, under
    deterministic algorithms; then TT_TRAIN_STEPS AdamW steps through the
    embedding_bag kernel (the main path, counted)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.kernels.embedding_bag import kernel as ebk
    from repro_torch.launch.steps import build_recsys_step
    from repro_torch.models import recsys
    from repro_torch.models.common import tree_leaves

    arch = get_arch("two-tower-retrieval")
    full = arch.shape("train_batch").dims["batch"]
    gen = torch.Generator(device=device).manual_seed(SEED + 47)
    torch.cuda.reset_peak_memory_stats()
    params = recsys.init_two_tower(gen, arch.config)
    check(recsys.param_count(params) == RECSYS_PARAMS, "two-tower's parameter count")
    step = build_recsys_step(arch, ShapeSpec("train_batch", "train", {"batch": TT_TRAIN_BATCH}),
                             params, gen, device)

    # the first step from the initial state through the kernel and the plain
    # version (the moments start at 0, so only the parameters are saved)
    leaves = tree_leaves(params)
    moments = [step.opt_state.step, *tree_leaves(step.opt_state.mu),
               *tree_leaves(step.opt_state.nu)]
    t = time.perf_counter()
    saved = [p.detach().to("cpu", copy=True) for p in leaves]
    with deterministic():
        (_, _, o1), s1 = timed(lambda: step.fn(step.batch))
        got = [p.detach().to("cpu", copy=True) for p in leaves]
        with torch.no_grad():
            for p, h in zip(leaves, saved):
                p.copy_(h)
            for m in moments:
                m.zero_()
        before = ebk.launches
        (_, _, o0), s0 = timed(lambda: step.fn(step.batch, use_kernel=False))
        check(ebk.launches == before, "the plain step launched no kernel")
    check(torch.equal(o1["loss"], o0["loss"]),
          f"two-tower's loss through the kernel {float(o1['loss'])} != plain {float(o0['loss'])}")
    check(all(torch.equal(p.detach(), h.to(device)) for p, h in zip(leaves, got)),
          "two-tower's updated parameters through the kernel != plain")
    print(f"train/two-tower: the first step through the kernel ({s1 * 1e3:.3f} ms) and the same "
          f"step from the same state with use_kernel=False ({s0 * 1e3:.3f} ms), deterministic "
          f"algorithms: loss {float(o1['loss']):.6f} and all {sum(p.numel() for p in leaves)} "
          f"updated parameters equal bit for bit (parameters saved to and restored from the "
          f"host; the comparison took {time.perf_counter() - t:.3f} s)")
    del saved, got

    # the main path: the counts from 0
    ebk.launches = 0
    losses, secs = [], []
    for _ in range(TT_TRAIN_STEPS):
        (_, _, out), s = timed(lambda: step.fn(step.batch))
        losses.append(float(out["loss"]))
        secs.append(s)
    launches = ebk.launches
    peak = torch.cuda.max_memory_allocated()
    check(launches == 2 * TT_TRAIN_STEPS,
          f"embedding_bag launches {launches} == 2 bags x {TT_TRAIN_STEPS} train steps")
    check(all(np.isfinite(losses)), f"two-tower losses are finite: {losses}")
    med = float(np.median(secs[1:])) * 1e3
    ms_grad, ms_opt = split_step(recsys.two_tower_loss, params, step.opt_state, step.batch,
                                 arch.config)
    flush = torch.empty(1 << 26, dtype=torch.int32, device=device)  # 256 MiB > L2
    bag = time_embedding_bag("two-tower train user bag", params["user_table"],
                             step.batch["user_feats"], flush)
    del flush
    print(f"train/two-tower: full width ({RECSYS_PARAMS} f32 parameters), train_batch "
          f"{full} cut to {TT_TRAIN_BATCH}, AdamW, steps 2-{TT_TRAIN_STEPS + 1}: losses "
          f"{' '.join(f'{x:.6f}' for x in losses)}; ms/step "
          f"{' '.join(f'{s * 1e3:.3f}' for s in secs)} (median after the first {med:.3f}, host "
          f"clock, synchronised); embedding_bag launches {launches} (2 a step); peak "
          f"{peak / 1e9:.3f} GB allocated; one more step in halves: loss + gradients "
          f"{ms_grad:.3f} ms, AdamW {ms_opt:.3f} ms ({ms_opt / (ms_grad + ms_opt):.4f})")
    del params, step, leaves, moments
    return launches, bag


def recsys_train_others(device):
    """SASRec, DIN and MIND at full published width, train_batch: two AdamW
    steps each, the second timed."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import RECSYS_INIT, build_recsys_step
    from repro_torch.models import recsys

    gen = torch.Generator(device=device).manual_seed(SEED + 53)
    for name in ("sasrec", "din", "mind"):
        arch = get_arch(name)
        params = RECSYS_INIT[name](gen, arch.config)
        step = build_recsys_step(arch, arch.shape("train_batch"), params, gen, device)
        (_, _, o1), s1 = timed(lambda: step.fn(step.batch))
        (_, _, o2), s2 = timed(lambda: step.fn(step.batch))
        losses = (float(o1["loss"]), float(o2["loss"]))
        check(all(np.isfinite(losses)), f"{name}: train losses are finite: {losses}")
        print(f"train/{name}: full width ({recsys.param_count(params)} parameters), train_batch "
              f"{arch.shape('train_batch').dims['batch']}, AdamW: losses {losses[0]:.6f} "
              f"{losses[1]:.6f}; ms/step {s2 * 1e3:.3f} (second step; first {s1 * 1e3:.3f}, "
              f"host clock, synchronised)")
        del params, step
        torch.cuda.empty_cache()


def phase_train(device):
    """Training on the card: gemma-2b at full width, the card against the
    CPU, the training CLI's kill and resume, and the recsys losses, two-tower
    through the embedding_bag kernel."""
    torch.cuda.empty_cache()
    gemma = gemma_train(device)
    gc.collect()
    torch.cuda.empty_cache()
    smoke_against_cpu(device)
    cli_kill_and_resume()
    launches, bag = two_tower_train(device)
    gc.collect()
    torch.cuda.empty_cache()
    recsys_train_others(device)
    return dict(gemma, launches=launches, bag=bag)


# -- phase 10: recsys serving, two-tower through the embedding_bag kernel -------


def recsys_small_check(device) -> None:
    """Two-tower at its smoke config widened to the full embedding (256,
    towers 64-32): the card's serve and retrieval steps (through the kernel)
    against the CPU's (the plain versions), same weights and batches."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_recsys_step
    from repro_torch.models import recsys

    arch = get_arch("two-tower-retrieval")
    arch = dataclasses.replace(arch, smoke_config=dataclasses.replace(
        arch.smoke_config, embed_dim=256, tower_dims=(64, 32)))
    params = recsys.init_two_tower(torch.Generator().manual_seed(SEED), arch.smoke_config)
    worst = 0.0
    for name in ("serve_p99", "retrieval_cand"):
        got, want = (build_recsys_step(arch, arch.shape(name), p,
                                       torch.Generator().manual_seed(SEED + 1), dev, smoke=True)
                     for p, dev in ((recsys.params_from_numpy(params, device), device),
                                    (params, "cpu")))
        a, b = got.fn(got.batch).cpu(), want.fn(want.batch)
        check(torch.allclose(a, b, rtol=RECSYS_RTOL, atol=RECSYS_ATOL),
              f"two-tower {name} on the card differs from the CPU's")
        worst = max(worst, float((a - b).abs().max()))
    print(f"recsys/small: two-tower (embed 256, towers 64-32) serve and retrieval on the card "
          f"within rtol {RECSYS_RTOL}, atol {RECSYS_ATOL} of the CPU's (max abs diff {worst:.3e})")


def bag_edge_cases(device, user_table):
    """``(label, table, bags)``: bf16 tables, all-pad bags, a bag of one,
    repeated ids, the last row, D in {18, 50, 64, 256}, B = 1, bags longer
    than a warp's 32 ids; and bags of those kinds on the served user table."""
    rng = np.random.default_rng(SEED + 33)
    cases = []
    for d in (18, 50, 64, 256):
        for dtype in (torch.float32, torch.bfloat16):
            v = 1000
            table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)).to(dtype)
            bags = rng.integers(-1, v, size=(64, 8))
            bags[0], bags[1, 1:], bags[2], bags[3, ::2] = -1, -1, 7, v - 1
            cases.append((f"D={d} {dtype}", table.to(device), torch.from_numpy(bags)))
    table = torch.from_numpy(rng.normal(size=(300, 256)).astype(np.float32)).to(device)
    cases.append(("B=1", table, torch.tensor([[5, -1, 299, 5]])))
    cases.append(("L=40", table, torch.from_numpy(rng.integers(-1, 300, size=(50, 40)))))
    v = user_table.shape[0]
    bags = rng.integers(0, v, size=(64, 8))
    bags[0], bags[1, 1:], bags[2], bags[3, ::2], bags[4, :3] = -1, -1, v - 1, v - 1, 12345
    cases.append(("served user table", user_table, torch.from_numpy(bags)))
    return [(label, t, b.to(device=device, dtype=torch.int32)) for label, t, b in cases]


def bag_bytes(table, bags) -> int:
    """Bytes the bag must move: each distinct valid row once, the ids, and
    the output."""
    rows = int(torch.unique(bags[bags >= 0]).numel())
    d, es = table.shape[1], table.element_size()
    return rows * d * es + bags.numel() * bags.element_size() + bags.shape[0] * d * es


def time_embedding_bag(label, table, bags, flush):
    """The kernel on one captured bag, timed beside its byte bound, the plain
    version and ``torch.nn.functional.embedding_bag`` (the flat ids and
    offsets made before timing)."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import embedding_bag_plain
    from repro_torch.kernels.embedding_bag import kernel as ebk

    valid = bags >= 0
    flat = bags[valid].long()
    offsets = torch.cumsum(valid.sum(1), 0) - valid.sum(1)
    lib = lambda: F.embedding_bag(flat, table, offsets, mode="mean")  # noqa: E731
    lib_err = float((lib() - embedding_bag_plain(table, bags, "mean")).abs().max())
    noop = lambda: None  # noqa: E731
    nb = bag_bytes(table, bags)
    row = dict(
        ms=time_device(lambda: ebk.embedding_bag(table, bags, "mean"), 50, flush, noop),
        plain_ms=time_host(lambda: embedding_bag_plain(table, bags, "mean"), 10, flush, noop),
        library_ms=time_device(lib, 50, flush, noop),
        bound_ms=nb / HBM_BYTES_PER_S * 1e3,
    )
    print(f"kernels/embedding_bag/{label}: B={bags.shape[0]} L={bags.shape[1]} over "
          f"{table.shape[0]} x {table.shape[1]} {table.dtype}, {int(valid.sum())} valid ids: "
          f"device {row['ms']:.6f} ms/launch (L2 flushed), {nb / row['ms'] / 1e6:.1f} GB/s; plain "
          f"{row['plain_ms']:.6f} ms; F.embedding_bag (mean, flat ids and offsets; max abs diff "
          f"to plain {lib_err:.3e}) {row['library_ms']:.6f} ms; byte bound {row['bound_ms']:.6f} "
          f"ms ({nb / 1e9:.6f} GB: distinct rows, ids, output)")
    return row


def check_embedding_bag(device, calls, user_table):
    """embedding_bag against its plain version, bit for bit, on the steps'
    captured bags and on edge cases; times it on the serve_bulk user bag and
    the retrieval_cand item bag."""
    from repro_torch.kernels.embedding_bag import embedding_bag_plain
    from repro_torch.kernels.embedding_bag import kernel as ebk

    flush = torch.empty(1 << 26, dtype=torch.int32, device=device)  # 256 MiB > L2
    for label, table, bags in bag_edge_cases(device, user_table):
        for mode in ("sum", "mean"):
            got = ebk.embedding_bag(table, bags, mode)
            check(torch.equal(got, embedding_bag_plain(table, bags, mode)),
                  f"embedding_bag != plain on the {label} case ({mode})")
        print(f"kernels/embedding_bag/{label}: sum and mean equal to plain bit for bit (B="
              f"{bags.shape[0]} L={bags.shape[1]} D={table.shape[1]}, all-pad bags "
              f"{int((bags < 0).all(1).sum())})")
    rows = {label: time_embedding_bag(label, table, bags, flush)
            for label, table, bags in (("serve_bulk user bag", *calls["serve_bulk"][0][:2]),
                                       ("retrieval_cand item bag", *calls["retrieval_cand"][1][:2]))}
    del flush
    row = dict(rows["serve_bulk user bag"], max_abs_err=0.0)
    row["retrieval"] = rows["retrieval_cand item bag"]
    return row


def f64_close(got, want) -> tuple:
    """``(ok, worst error, bound)``: each score within RECSYS_F64_RTOL of the
    largest float64 score of the sample plus RECSYS_F64_ATOL."""
    err = float((got.double() - want).abs().max())
    bound = RECSYS_F64_RTOL * float(want.abs().max()) + RECSYS_F64_ATOL
    return err <= bound, err, bound


def recsys_samples(name: str, shape: str, n: int, rows: int) -> torch.Tensor:
    """The rows the float64 check evaluates: the first and last
    RECSYS_SAMPLE of serve_bulk and of SASRec's and MIND's retrievals; the
    first and last half of RECSYS_SAMPLE of each of DIN's retrieval chunks
    of ``rows``, the ragged tail's included."""
    k = RECSYS_SAMPLE
    if name == "din" and shape == "retrieval_cand":
        k //= 2
        starts = range(0, n, rows)
        return torch.cat([torch.cat([torch.arange(lo, lo + k), torch.arange(hi - k, hi)])
                          for lo, hi in ((lo, min(lo + rows, n)) for lo in starts)])
    return torch.cat([torch.arange(k), torch.arange(n - k, n)])


def recsys_sub_batch(name: str, shape: str, batch, idx):
    """The rows ``idx`` of a serve batch, or the query against the
    candidates ``idx`` of a retrieval batch."""
    if shape == "serve_bulk":
        return {k: v[idx] for k, v in batch.items()}
    if name == "din":
        return {"hist": batch["hist"], "cands": batch["cands"][idx]}
    return {"seq": batch["seq"], "candidates": batch["candidates"][:, idx]}


def serve_against_retrieval(name: str, serve_fn, params, batch, out, rows: int) -> str:
    """The retrieval's scores against ``serve_fn`` on the same (history,
    candidate) pairs: DIN's first chunk bit for bit (the same shapes as
    serve_bulk's), SASRec's and MIND's first RECSYS_SAMPLE candidates within
    the float64 check's bound (serve scores one candidate a row, another
    product)."""
    if name == "din":
        pairs = {"hist": batch["hist"].expand(rows, -1).contiguous(),
                 "target": batch["cands"][:rows]}
        got = serve_fn(params, pairs)
        err = float((got - out[:rows]).abs().max())
        check(torch.equal(got, out[:rows]),
              f"din: serve on the first chunk's {rows} pairs != the retrieval's "
              f"(max abs diff {err:.3e})")
        return f"serve on the first chunk's {rows} pairs equal bit for bit"
    k = RECSYS_SAMPLE
    seq = batch["seq"].expand(k, -1).contiguous()
    got = serve_fn(params, {"seq": seq, "candidates": batch["candidates"][0, :k, None]})
    ok, err, bound = f64_close(got, out[:k].double())
    check(ok, f"{name}: serve on {k} candidates differs from the retrieval's by {err:.3e} "
              f"(bound {bound:.3e})")
    return f"serve on {k} candidates within {err:.3e} (bound {bound:.3e})"


def recsys_at_scale(device, arch, params, gen) -> float:
    """``arch``'s serve_bulk and retrieval_cand steps at full width: a
    warm-up run, RECSYS_SCALE_STEPS timed runs each equal to the first bit
    for bit, the peak memory, a profiled window; the sampled rows against
    the same function in float64, the retrieval against the serve function,
    shapes and finiteness.  Returns the peak bytes allocated since the last
    reset before the call or in any step (each step resets the peak)."""
    from repro_torch.launch.steps import build_recsys_step, din_chunk_rows, recsys_fns
    from repro_torch.models.common import tree_map

    name, cfg = arch.name, arch.config
    serve_fn, retr_fn, _, _ = recsys_fns(arch, cfg)
    rows = din_chunk_rows(cfg) if name == "din" else 0
    most = torch.cuda.max_memory_allocated()
    for shape, reps in RECSYS_SCALE_STEPS:
        step = build_recsys_step(arch, arch.shape(shape), params, gen, device)
        dims = arch.shape(shape).dims
        n = dims["batch"] if shape == "serve_bulk" else dims["n_candidates"]
        torch.cuda.synchronize()
        most = max(most, torch.cuda.max_memory_allocated())
        base = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        first, t = timed(lambda: step.fn(step.batch))
        secs = []
        for _ in range(reps):
            out, sec = timed(lambda: step.fn(step.batch))
            secs.append(sec)
            check(torch.equal(out, first), f"{name} {shape}: a run differs from the first")
        peak = torch.cuda.max_memory_allocated() / 1e9
        most = max(most, torch.cuda.max_memory_allocated())
        check(first.shape == (n,) and bool(torch.isfinite(first).all()),
              f"{name} {shape}: {n} finite scores")
        kern = device_kernels(lambda: step.fn(step.batch),
                              lambda: [step.fn(step.batch) for _ in range(RECSYS_SCALE_PROFILE)],
                              f"{name}'s {shape} steps")
        busy = kern.busy_us / RECSYS_SCALE_PROFILE / 1e3
        med = float(np.median(secs)) * 1e3
        top = "; ".join(f"{e.key[:40]} {e.device_time_total / RECSYS_SCALE_PROFILE / 1e3:.3f}ms"
                        for e in sorted(kern, key=lambda e: -e.device_time_total)[:4])

        idx = recsys_samples(name, shape, n, rows).to(device)
        p64 = tree_map(lambda p: p.double() if p.is_floating_point() else p, params)
        fn = serve_fn if shape == "serve_bulk" else retr_fn
        sub = recsys_sub_batch(name, shape, step.batch, idx)
        want = fn(p64, sub)
        del p64
        ok, err, bound = f64_close(first[idx], want)
        check(ok, f"{name} {shape}: {err:.3e} from float64 on the sampled rows (bound "
                  f"{bound:.3e})")
        with tf32():
            _, low_err, _ = f64_close(fn(params, sub), want)
        check(low_err > bound, f"{name} {shape}: the TF32 control is within the float64 "
                               f"bound ({low_err:.3e} <= {bound:.3e})")
        line = (f"float64 on {idx.numel()} sampled rows: worst {err:.3e} (bound {bound:.3e}; "
                f"the TF32 control {low_err:.3e})")
        if shape == "retrieval_cand":
            line += "; " + serve_against_retrieval(name, serve_fn, params, step.batch, first,
                                                   rows)
        chunks = f"{-(-n // rows)} chunks of {rows} rows, " if rows and n > rows else ""
        print(f"recsys/{name}/{shape}: {n} scores, {chunks}ms/step median {med:.3f} mean "
              f"{np.mean(secs) * 1e3:.3f} over {reps} runs after a warm-up of {t * 1e3:.3f} ms "
              f"(host clock, synchronised), each equal to the first bit for bit; device busy "
              f"{busy:.3f} ms/step, idle share {1 - busy / med:.4f}; peak {peak - base:.3f} GB of its "
              f"own ({peak:.3f} with the {base:.3f} allocated before the step); {line}; "
              f"finite; per step: {top}")
        del step, first, out, want, sub
        torch.cuda.empty_cache()
    return max(most, torch.cuda.max_memory_allocated())


def phase_recsys(device):
    """Two-tower retrieval at full published width on the card: its serve
    and retrieval steps through the embedding_bag kernel, each bag held to
    the plain version bit for bit, each step to its plain path; then the
    kernel's checks and times, and SASRec, DIN and MIND at serve_p99,
    serve_bulk and retrieval_cand (:func:`recsys_at_scale`)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.embedding_bag import embedding_bag_plain
    from repro_torch.kernels.embedding_bag import kernel as ebk
    from repro_torch.launch.steps import RECSYS_INIT, build_recsys_step
    from repro_torch.models import recsys

    start_gb = torch.cuda.memory_allocated() / 1e9
    arch = get_arch("two-tower-retrieval")
    cfg = arch.config
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = recsys.init_two_tower(gen, cfg)
    torch.cuda.synchronize()
    n_params = recsys.param_count(params)
    check(n_params == RECSYS_PARAMS, f"two-tower's parameter count {n_params}")
    print(f"recsys/model: two-tower-retrieval (configs/registry.py) at full width: user table "
          f"{cfg.n_users} x {cfg.embed_dim}, item table {cfg.n_items} x {cfg.embed_dim}, towers "
          f"{'-'.join(map(str, cfg.tower_dims))}, {cfg.dtype}; {n_params} parameters "
          f"({n_params * 4 / 1e9:.3f} GB) from a seeded generator on the card in "
          f"{time.perf_counter() - t0:.3f} s")
    steps = {name: build_recsys_step(arch, arch.shape(name), params, gen, device)
             for name, _ in RECSYS_STEPS}

    # the main path: every run of the three steps, the counts from 0; the
    # first run's bag calls are kept (references: nothing is cloned)
    calls = {name: [] for name in steps}
    current = None

    def record(table, bags, mode="sum"):
        out = orig(table, bags, mode)
        if len(calls[current]) < 2:
            calls[current].append((table, bags, mode, out))
        return out

    first, secs = {}, {}
    ebk.launches = 0
    with patched(ebk, "embedding_bag", record) as orig:
        for name, reps in RECSYS_STEPS:
            current = name
            step = steps[name]
            first[name] = step.fn(step.batch)
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = step.fn(step.batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
                check(torch.equal(out, first[name]), f"{name}: a run differs from the first")
            secs[name] = np.asarray(times)
    launches = ebk.launches
    n_runs = sum(1 + reps for _, reps in RECSYS_STEPS)
    check(launches == 2 * n_runs, f"embedding_bag launches {launches} == 2 bags x {n_runs} steps")

    for name, _ in RECSYS_STEPS:
        step, out = steps[name], first[name]
        check(len(calls[name]) == 2, f"{name}: two embedding_bag calls a step")
        for which, (table, bags, mode, got) in zip(("user", "item"), calls[name]):
            check(torch.equal(got, embedding_bag_plain(table, bags, mode)),
                  f"{name}: the {which} bag != plain")
        before = ebk.launches
        plain = step.fn(step.batch, use_kernel=False)
        check(ebk.launches == before, "the plain path launched no kernel")
        check(torch.equal(out, plain), f"{name}: the step != its plain path")
        check(bool(torch.isfinite(out).all()) and bool((out.abs() <= 1 + 1e-5).all()),
              f"{name}: scores are cosines")
        bag_line = "; ".join(
            f"{w} bag {tuple(b.shape)} with {int((b >= 0).sum())} ids over {t.shape[0]} rows"
            for w, (t, b, _, _) in zip(("user", "item"), calls[name]))
        kern = device_kernels(lambda: step.fn(step.batch),
                              lambda: [step.fn(step.batch) for _ in range(RECSYS_PROFILE)],
                              f"the {name} steps")
        busy = kern.busy_us / RECSYS_PROFILE / 1e3  # ms per step
        med = float(np.median(secs[name])) * 1e3
        top = "; ".join(f"{e.key[:50]} {e.device_time_total / RECSYS_PROFILE / 1e3:.3f}ms"
                        for e in sorted(kern, key=lambda e: -e.device_time_total)[:4])
        print(f"recsys/{name}: {out.shape[0]} scores, ms/step median {med:.3f} mean "
              f"{secs[name].mean() * 1e3:.3f} over {len(secs[name])} runs (host clock, "
              f"synchronised); device busy {busy:.3f} ms/step, idle share {1 - busy / med:.4f}; "
              f"{bag_line}; each bag equal to plain bit for bit, the step equal to its plain path; "
              f"per step: {top}")
    print(f"recsys/launches: embedding_bag {launches} over {n_runs} steps (2 a step)")
    recsys_small_check(device)
    row = check_embedding_bag(device, calls, params["user_table"])
    del calls, steps, step, first, params, out, plain, table, bags, got
    torch.cuda.empty_cache()
    print(f"memory: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated after releasing "
          f"two-tower ({start_gb:.3f} at the phase's start)")

    # the other three archs at full published width: serve_p99, then
    # serve_bulk and retrieval_cand
    peak = 0
    for name in ("sasrec", "din", "mind"):
        arch = get_arch(name)
        t0 = time.perf_counter()
        params = RECSYS_INIT[name](gen, arch.config)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        step = build_recsys_step(arch, arch.shape("serve_p99"), params, gen, device)
        step.fn(step.batch)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step.fn(step.batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        check(out.shape == (arch.shape("serve_p99").dims["batch"],)
              and bool(torch.isfinite(out).all()), f"{name}: serve_p99 scores are finite")
        print(f"recsys/{name}: serve_p99 at full width ({arch.config.n_items} x "
              f"{arch.config.embed_dim} table, {recsys.param_count(params)} parameters, set up "
              f"in {setup:.3f} s): {ms:.3f} ms/step (host clock, synchronised, second run); "
              f"checksum {float(out.double().sum()):.6f}")
        del step, out
        peak = max(peak, recsys_at_scale(device, arch, params, gen))
        del params
        torch.cuda.empty_cache()
    return dict(launches=launches, row=row, peak=peak)


def gnn_profile(step, label: str, med_s: float, n: int = GNN_PROFILE) -> str:
    """Device busy time per call over ``n`` calls (torch profiler) against
    the unprofiled median: the idle share, and the top device ops."""
    kern = device_kernels(lambda: step.fn(step.batch),
                          lambda: [step.fn(step.batch) for _ in range(n)], f"the {label} steps")
    busy = kern.busy_us / n / 1e3
    top = "; ".join(f"{e.key[:50]} {e.device_time_total / n / 1e3:.3f}ms"
                    for e in sorted(kern, key=lambda e: -e.device_time_total)[:4])
    return (f"device busy {busy:.3f} ms/call, idle share {1 - busy / (med_s * 1e3):.4f}; "
            f"top: {top}")


def gnn_train(device, arch, shape, gen, steps: int, against_cpu: bool = False) -> dict:
    """One PNA train shape on the card through ``build_gnn_step`` (fresh
    seeded weights, AdamW): ``steps`` steps, each loss finite, the last
    below the first.  With ``against_cpu``, step 0 runs on the CPU too,
    from the same weights and batch: the loss within GNN_LOSS_RTOL, every
    parameter after the update within GNN_PARAM_ATOL."""
    from repro_torch.launch.steps import build_gnn_step
    from repro_torch.models import gnn
    from repro_torch.models.common import tree_leaves, tree_map

    torch.cuda.reset_peak_memory_stats()
    params = gnn.init_params(gen, arch.config)
    before = tree_map(lambda t: t.detach().cpu().clone(), params)
    t0 = time.perf_counter()
    step = build_gnn_step(arch, shape, params, gen, device)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    losses, secs = [], []
    for i in range(steps):
        (_, _, out), sec = timed(lambda: step.fn(step.batch))
        losses.append(float(out["loss"]))
        secs.append(sec)
        if i == 0 and against_cpu:
            card0 = [t.detach().cpu().clone() for t in tree_leaves(params)]
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"pna {shape.name}: losses are finite: {losses}")
    check(losses[-1] < losses[0], f"pna {shape.name}: the loss falls: {losses}")
    out = dict(step=step, losses=losses, med=float(np.median(secs[1:])), first_s=secs[0],
               peak=peak, host_s=host_s)
    if against_cpu:
        cpu = build_gnn_step(arch, shape, before, torch.Generator().manual_seed(SEED), "cpu")
        loss_cpu = float(cpu.fn({k: v.cpu() for k, v in step.batch.items()})[2]["loss"])
        param_err = max(float((a - b.detach()).abs().max())
                        for a, b in zip(card0, tree_leaves(before)))
        rel = abs(losses[0] - loss_cpu) / abs(loss_cpu)
        check(rel <= GNN_LOSS_RTOL and param_err <= GNN_PARAM_ATOL,
              f"pna {shape.name}: step 0 on the card != on the CPU (loss {losses[0]} against "
              f"{loss_cpu}, parameters {param_err} apart)")
        out.update(cpu_loss=loss_cpu, cpu_rel=rel, cpu_param_err=param_err)
    return out


def phase_gnn(device):
    """PNA at its full config on the card: the molecule serve step and the
    three train shapes (``build_gnn_step``); ms per call, MFU against the
    f32 rate, peak memory and the idle share of each."""
    import dataclasses as dc

    from repro_torch.configs import pna
    from repro_torch.launch.steps import build_gnn_step
    from repro_torch.models import gnn
    from repro_torch.models.common import tree_leaves, tree_map

    arch, cfg = pna.ARCH, pna.CONFIG
    gen = torch.Generator(device=device).manual_seed(SEED + 41)
    params = gnn.init_params(gen, cfg)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"gnn/model: pna (configs/registry.py) at full width: {cfg.n_layers} layers, width "
          f"{cfg.d_hidden}, d_in {cfg.d_in}, {cfg.n_classes} classes, {cfg.dtype}; {n_params} "
          f"parameters from a seeded generator on the card; f32 products in IEEE f32 (no TF32)")

    # molecule: the serve step, batches of 128 padded molecules
    torch.cuda.reset_peak_memory_stats()
    shape = arch.shape("molecule")
    t0 = time.perf_counter()
    step = build_gnn_step(arch, shape, params, gen, device)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    b = step.batch["x"].shape[0]
    first = step.fn(step.batch)
    check(first.shape == (b, cfg.n_classes) and bool(torch.isfinite(first).all()),
          "pna molecule: logits are finite")
    secs = [timed(lambda: step.fn(step.batch))[1] for _ in range(GNN_SERVE_RUNS)]
    med = float(np.median(secs))
    cpu_params = tree_map(lambda t: t.detach().cpu(), params)
    want = gnn.forward_batched(cpu_params, *(step.batch[k].cpu() for k in
                                             ("x", "edge_index", "node_mask")), cfg)
    err = float((first.cpu() - want).abs().max())
    check(err <= GNN_LOGIT_ATOL_REL * float(want.abs().max()),
          f"pna molecule: the card's logits are {err} from the CPU's")
    real = int(step.batch["node_mask"].sum())
    print(f"gnn/molecule: {b} molecules of <= {shape.dims['n_nodes']} atoms ({real} real) and "
          f"<= {shape.dims['n_edges']} bonds (batch drawn in {host_s:.3f} s): {med * 1e3:.3f} "
          f"ms/batch median over {GNN_SERVE_RUNS} (host clock, synchronised), "
          f"{b / med:.1f} molecules/s, MFU {step.model_flops / med / F32_FLOP_PER_S:.6f} of "
          f"{F32_FLOP_PER_S / 1e12:.0f} TFLOP/s (f32); logits {err:.3e} from the CPU's "
          f"(tolerance {GNN_LOGIT_ATOL_REL} of the largest, {float(want.abs().max()):.3f}); "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB; "
          + gnn_profile(step, "molecule", med))
    out = {"molecule": dict(ms=med * 1e3)}
    del step, params, first

    cut = arch.shape("ogb_products")
    cut = dc.replace(cut, dims=dict(cut.dims, n_nodes=int(cut.dims["n_nodes"] * OGB_FRACTION),
                                    n_edges=int(cut.dims["n_edges"] * OGB_FRACTION)))
    for shape, steps in ((arch.shape("full_graph_sm"), GNN_TRAIN_STEPS),
                         (arch.shape("minibatch_lg"), GNN_BIG_STEPS), (cut, GNN_BIG_STEPS)):
        r = gnn_train(device, arch, shape, gen, steps, against_cpu=shape.name == "full_graph_sm")
        st = r["step"]
        n, e = st.batch["x"].shape[0], st.batch["edge_index"].shape[1]
        real_e = int((st.batch["edge_index"][1] < n).sum())
        labelled = int(st.batch["label_mask"].sum())
        mfu = st.model_flops / r["med"] / F32_FLOP_PER_S
        line = (f"gnn/{shape.name}: {n} nodes and {e} edges padded ({real_e} real edges, "
                f"{labelled} labelled nodes; graph and batch built in {r['host_s']:.3f} s, the "
                f"host's share); losses {' '.join(f'{x:.6f}' for x in r['losses'])}; ms/step "
                f"median {r['med'] * 1e3:.3f} over steps 1-{steps - 1} (host clock, "
                f"synchronised; step 0 {r['first_s'] * 1e3:.3f}), model_flops "
                f"{st.model_flops:.4e} a step, MFU {mfu:.6f} of {F32_FLOP_PER_S / 1e12:.0f} "
                f"TFLOP/s (f32); peak {r['peak'] / 1e9:.3f} GB allocated")
        if "cpu_loss" in r:
            line += (f"; step 0 on the CPU from the same weights and batch: loss "
                     f"{r['cpu_loss']:.6f} ({r['cpu_rel']:.3e} relative), parameters after "
                     f"AdamW {r['cpu_param_err']:.3e} apart")
        print(line)
        print(f"gnn/{shape.name}/profile: " + gnn_profile(st, shape.name, r["med"]))
        out[shape.name] = dict(ms=r["med"] * 1e3, mfu=mfu, peak=r["peak"], n=n, e=e)
        del r, st
        gc.collect()
        torch.cuda.empty_cache()
    return out


# -- phase 11: kernels against their plain versions -----------------------------


def _words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def kernel_case(seed: int, s: int, b: int, kind: str, depth: int = DEEP_DEPTH, w: int = WAYS,
                static_run: bool = False):
    """Host arrays of one synthetic serve step: a warm packed state, a
    request batch and the previous batch's fill plan.

    ``uniform`` hashes requests over all ``s`` sets, 60% of them to
    resident keys, with some duplicates, a padded tail, static hits and a
    mix of fresh and stale entries, epochs above 2**31.  ``edge`` crowds
    the batch into 64 sets (deep conflicts), interleaves pads and
    duplicates, puts epochs on both sides of 2**31 with floors saturated at
    2**32 - 1, and makes the fill plan collide.  ``deep`` is ``edge``'s
    epochs on ``uniform``'s spread with ``depth`` requests sent to one
    set (a head query repeating: Zipf over the set's resident keys and
    three times as many new ones, pads, static hits and non-admitted
    misses among them); ``one_set`` sends the whole batch to that set (a
    topic partition of one set).  ``static_run`` makes every request to
    that set a static hit (a serving batch's head query).
    """
    rng = np.random.default_rng(seed)
    v = VDIM
    edge = kind == "edge"
    e0 = (1 << 31) + 1000 if kind == "uniform" else (1 << 31) - 2
    key_hi, key_lo = _words(rng, (s, w)), _words(rng, (s, w))
    key_hi[rng.random((s, w)) < 0.1] = 0  # empty ways
    stamp = rng.integers(0, 1 << 30, size=(s, w)).astype(np.int32)
    epoch = (e0 + rng.integers(-4, 5, size=(s, w))).astype(np.uint32)
    ks = np.concatenate([key_hi, key_lo, stamp.view(np.uint32), epoch], 1)
    value = rng.integers(0, 1 << 31, size=(s * w, v)).astype(np.int32)
    n_sets = 64 if edge else s
    set_idx = rng.integers(0, n_sets, size=b).astype(np.int32)
    h_hi, h_lo = _words(rng, b), _words(rng, b)
    res = rng.random(b) < 0.6
    way = rng.integers(0, w, size=b)
    h_hi[res] = key_hi[set_idx[res], way[res]]
    h_lo[res] = key_lo[set_idx[res], way[res]]
    dup = rng.integers(0, b, size=b // (4 if edge else 10))
    tail = np.arange(b - len(dup), b)
    h_hi[tail], h_lo[tail], set_idx[tail] = h_hi[dup], h_lo[dup], set_idx[dup]
    pads = np.arange(0, b, 13) if edge else np.arange(b - 96, b)
    h_hi[pads] = h_lo[pads] = 0xFFFFFFFF
    admit = rng.random(b) < (1.0 if kind == "uniform" else 0.7)
    static_hit = rng.random(b) < 0.3
    epochs = np.full(b, e0 + 6, np.uint32)
    min_epoch = (e0 + rng.integers(-6, 6, size=b)).astype(np.uint32)
    if edge:
        min_epoch[rng.random(b) < 0.1] = 0xFFFFFFFF
    if kind in ("deep", "one_set"):
        run = (np.sort(rng.choice(b, depth, replace=False)) if kind == "deep"
               else np.arange(b))
        hot = int(rng.integers(0, s))
        set_idx[run] = hot
        pool_hi = np.concatenate([key_hi[hot], _words(rng, 3 * w)])
        pool_lo = np.concatenate([key_lo[hot], _words(rng, 3 * w)])
        pick = np.minimum(rng.zipf(1.3, size=len(run)) - 1, 4 * w - 1)
        h_hi[run], h_lo[run] = pool_hi[pick], pool_lo[pick]
        h_hi[run[::29]] = h_lo[run[::29]] = 0xFFFFFFFF
        if static_run:
            static_hit[set_idx == hot] = True
    n_fill = b // 2
    f_set = rng.integers(0, n_sets, size=n_fill).astype(np.int32)
    f_way = rng.integers(0, w, size=n_fill).astype(np.int32)
    f_vals = rng.integers(0, 1 << 31, size=(n_fill, v)).astype(np.int32)
    return dict(
        ks=ks, value=value, set_idx=set_idx, h_hi=h_hi, h_lo=h_lo, admit=admit,
        static_hit=static_hit, epochs=epochs, min_epoch=min_epoch,
        clock=np.int32(1 << 30), f_set=f_set, f_way=f_way, f_vals=f_vals,
    )


def kernel_args(case, device):
    """A synthetic case as the serve wrapper's arguments on ``device``:
    ``(ks, value, f_slot, f_vals, *common)``, where ``common`` is also the
    tail of the probe/commit wrapper's arguments after ``ks``."""
    from repro_torch.kernels.cache_ops import fill_winner_slots, plan_segments
    from repro_torch.serving.device_cache import to_device_words

    t = {k: to_device_words(np.asarray(a), device) if np.asarray(a).dtype != bool
         else torch.from_numpy(a).to(device) for k, a in case.items()}
    s, w4 = t["ks"].shape
    w = w4 // 4
    order, _, leader, seg_len, seg_set = plan_segments(t["set_idx"])
    f_slot = fill_winner_slots(
        s * w, w, t["f_set"], torch.ones_like(t["f_set"], dtype=torch.bool), t["f_way"]
    )
    return (t["ks"], t["value"], f_slot, t["f_vals"], order, leader, seg_len, seg_set,
            t["h_hi"], t["h_lo"], t["admit"], t["static_hit"], t["epochs"],
            t["min_epoch"], t["clock"])


def kernel_bytes(ks, common, value=None, f_slot=None, pre_way=None) -> int:
    """Bytes the function must move for this batch: each input read once,
    each output written once.  That is the rows of the sets the batch
    touches (read and written back), the request fields and segment plan,
    and the per-request outputs; for the serve kernel (``value``,
    ``f_slot`` and the probed ways ``pre_way`` given) also the fill plan,
    the filled slots, each distinct gathered value row and the served
    rows."""
    order, leader, seg_len, seg_set = (x.cpu().numpy().astype(np.int64) for x in common[:4])
    s, w4 = ks.shape
    b = len(order)
    real = seg_len > 0
    n_seg = int(real.sum())
    n_rows = int((real & (seg_set < s)).sum())
    total = b * (4 + 4 + 1 + 1 + 4 + 4 + 4)  # h_hi, h_lo, admit, static, epochs, minep, order
    total += b * 4 + n_seg * 8 + 4  # seg_len per thread, leader + set per segment, clock
    total += 2 * n_rows * w4 * 4  # rows read and written back
    total += b * (1 + 4 + 1 + 4 + 1 + 4)  # per-request outputs
    if value is None:
        return total
    nslots, v = value.shape
    fs = f_slot.cpu().numpy()
    n_fill = int(((fs >= 0) & (fs < nslots)).sum())
    total += len(fs) * 4 + 2 * n_fill * v * 4  # slots; values read and written
    # each request's set, from its segment: sorted positions leader..+len
    lens = seg_len[real]
    sorted_pos = np.repeat(leader[real] - np.cumsum(lens) + lens, lens) + np.arange(lens.sum())
    req_set = np.empty(b, np.int64)
    req_set[order[sorted_pos]] = np.repeat(seg_set[real], lens)
    rows = np.minimum(req_set, s - 1) * (w4 // 4) + pre_way.cpu().numpy()
    return total + len(np.unique(rows)) * v * 4 + b * v * 4


def time_device(fn, n: int, flush, restore) -> float:
    """Mean device time of ``fn`` (ms): the launches are queued behind a
    spin kernel so the host never starves the card; before each launch the
    state is restored and the L2 flushed (a serving batch finds its sets
    cold), outside the timed span."""
    restore()
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
    torch.cuda._sleep(200_000_000)
    for start, end in events:
        restore()
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in events]))


def time_host(fn, n: int, flush, restore) -> float:
    """Mean time of ``fn`` from its first enqueue to its last kernel's end
    (ms), host work included: for the plain versions, which synchronise."""
    total = 0.0
    for i in range(n + 1):
        restore()
        flush.zero_()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i:  # the first call warms up
            total += start.elapsed_time(end)
    return total / n


def _max_err(a, b) -> int:
    err = 0
    for x, y in zip(a, b):
        check(x.shape == y.shape and x.dtype == y.dtype, "kernel/plain output layout")
        if x.numel():
            err = max(err, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
    return err


def topic_score_cases(device, real):
    """``(label, counts, log_phi_t)``: the pipeline's captured chunk, then
    edge cases -- all-zero rows, K = 1, K = 500, B and V off every tile,
    and exact ties (two identical topic columns)."""
    rng = np.random.default_rng(SEED + 7)
    cases = [("real", *real)]
    for b, v, k in ((1000, 4097, 96), (37, 129, 1), (301, 1000, 500)):
        counts = rng.poisson(0.02, size=(b, v)).astype(np.float32)
        counts[:: 50] = 0  # all-zero rows
        lpt = np.ascontiguousarray(
            np.log(rng.dirichlet(np.full(v, 0.1), size=k).T + 1e-12).astype(np.float32))
        if k > 1:  # two identical topics, the likeliest for every word: every row ties
            lpt[:, 3 % k] = lpt[:, min(7, k - 1)] = lpt.max(axis=1)
        cases.append((f"edge B={b} V={v} K={k}", torch.from_numpy(counts).to(device),
                      torch.from_numpy(lpt).to(device)))
    return cases


def topic_close(label, got, want, counts):
    """Holds topic_score's outputs to the plain version's (TOPIC_RTOL; top
    exact beyond near-ties, conf to the plain epilogue on the kernel's own
    scores), prints the case and returns its max abs error."""
    s_k, t_k, c_k = got
    s_p, t_p, c_p = want
    check(torch.allclose(s_k, s_p, rtol=TOPIC_RTOL, atol=0.0),
          f"topic_score scores != plain on the {label} batch")
    own = torch.softmax(s_k, dim=-1).gather(1, t_k.long()[:, None])[:, 0]
    check(torch.allclose(c_k, own, rtol=TOPIC_RTOL, atol=0.0),
          f"topic_score conf != the plain epilogue on its scores on the {label} batch")
    conf_rel = float(((c_k - c_p).abs() / c_p).max())
    differ = torch.nonzero(t_k != t_p)[:, 0]
    s_at_k = s_p[differ, t_k[differ].long()]
    s_at_p = s_p[differ, t_p[differ].long()]
    check(bool(((s_at_k - s_at_p).abs() <= TOPIC_RTOL * s_at_p.abs()).all()),
          f"topic_score top != plain beyond near-ties on the {label} batch")
    err = max(float((s_k - s_p).abs().max()), float((c_k - c_p).abs().max()))
    b, k = s_p.shape
    top2 = s_k.topk(min(2, k), dim=1).values
    ties = int((top2[:, 0] == top2[:, -1]).sum()) if k > 1 else 0
    print(f"kernels/topic_score/{label}: within rtol {TOPIC_RTOL} of plain (B={b} "
          f"V={counts.shape[1]} K={k}, zero rows {int((counts.sum(1) == 0).sum())}, rows "
          f"with an exact tie for the top {ties}, top differs on {len(differ)} near-tied "
          f"rows, max abs err {err:.3e}, conf max rel diff to plain {conf_rel:.3e})")
    return err


def check_topic_score(device, topics, flush):
    """topic_score against its plain version on the card; times it on the
    pipeline's own chunk beside its bound (the bytes of the dense counts
    read once, or 2 * nnz * K operations: the kernel skips zero counts),
    and on a fully dense chunk of the same shape beside torch.matmul."""
    from repro_torch.kernels.topic_score import kernel as tsk
    from repro_torch.kernels.topic_score.ref import topic_score_plain

    check(topics["args"] is not None, "captured the pipeline's first topic_score call")
    row = dict(max_abs_err=0.0)
    for label, counts, lpt in topic_score_cases(device, topics["args"]):
        got = tsk.topic_score(counts, lpt)
        want = topic_score_plain(counts, lpt)
        torch.cuda.synchronize()
        row["max_abs_err"] = max(row["max_abs_err"], topic_close(label, got, want, counts))
    counts, lpt = topics["args"]
    b, v = counts.shape
    k = lpt.shape[1]
    nnz = int((counts != 0).sum())
    n = 50
    noop = lambda: None  # noqa: E731
    flops = 2.0 * nnz * k
    dense_flops = 2.0 * b * v * k
    nbytes = 4.0 * (b * v + v * k + b * k + 2 * b)
    row.update(
        ms=time_device(lambda: tsk.topic_score(counts, lpt), n, flush, noop),
        plain_ms=time_host(lambda: topic_score_plain(counts, lpt), 20, flush, noop),
        library_ms=time_device(lambda: torch.matmul(counts, lpt), n, flush, noop),
        bound_ms=max(flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if flops / F32_FLOP_PER_S >= nbytes / HBM_BYTES_PER_S else "bytes",
    )
    print(f"kernels/topic_score/real: nnz {nnz} of {b * v} counts (density {nnz / (b * v):.6f}); "
          f"device {row['ms']:.6f} ms/launch (L2 flushed), {nbytes / row['ms'] / 1e6:.1f} GB/s; "
          f"plain {row['plain_ms']:.6f} ms; torch.matmul (the product alone, no TF32) "
          f"{row['library_ms']:.6f} ms; bound {row['bound_ms']:.6f} ms by {row['bound_by']} "
          f"({nbytes / 1e6:.3f} MB at {HBM_BYTES_PER_S / 1e12} TB/s; {flops / 1e9:.6f} GFLOP "
          f"over the non-zero counts, {flops / F32_FLOP_PER_S * 1e3:.6f} ms at "
          f"{F32_FLOP_PER_S / 1e12:.0f} TFLOP/s); the dense-product figure {dense_flops / 1e9:.3f} "
          f"GFLOP, {dense_flops / F32_FLOP_PER_S * 1e3:.6f} ms")
    # the trade's cost on record: every count of a chunk of the real shape non-zero
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    dense = torch.randint(1, 4, (b, v), generator=gen, device=device).to(torch.float32)
    err = topic_close("dense", tsk.topic_score(dense, lpt), topic_score_plain(dense, lpt), dense)
    row["max_abs_err"] = max(row["max_abs_err"], err)
    dense_ms = time_device(lambda: tsk.topic_score(dense, lpt), 10, flush, noop)
    dense_lib = time_device(lambda: torch.matmul(dense, lpt), 10, flush, noop)
    print(f"kernels/topic_score/dense: B={b} V={v} K={k}, every count non-zero: device "
          f"{dense_ms:.6f} ms/launch (L2 flushed); torch.matmul {dense_lib:.6f} ms; the dense "
          f"product's operation bound {dense_flops / F32_FLOP_PER_S * 1e3:.6f} ms")
    del dense
    return row


def decode_cases(device, real):
    """``(label, q, k, v, cur, scale, softcap, window)``: the decode path's
    captured call (one layer's real cache at the decode shape), gemma2-27b's,
    glm4-9b's, llama4-scout's and arctic's decode geometries on seeded data
    at S = 32768, the sweep of tests/test_kernels.py in f32 and bf16, cur =
    0, and S off every tile."""
    gen = torch.Generator(device=device).manual_seed(SEED + 21)

    def draw(b, hkv, g, d, s, dtype):
        return tuple(torch.randn(shape, generator=gen, device=device).to(dtype)
                     for shape in ((b, hkv, g, d), (b, s, hkv, d), (b, s, hkv, d)))

    def cur(c):
        return torch.tensor(c, dtype=torch.int32, device=device)

    q, k, v, c, scale, cap, win = real
    cases = [("gemma-2b decode, layer 17's cache", q, k, v, c, scale, cap, win),
             ("gemma-2b decode, layer 17's cache in f32", q.float(), k.float(), v.float(), c,
              scale, cap, win)]
    g27 = draw(8, 16, 2, 128, LM_SEQ, torch.bfloat16)
    cases.append(("gemma2-27b geometry B=8", *g27, cur(LM_SEQ - 100), 144**-0.5, 50.0, 4096))
    glm = draw(16, 2, 16, 128, LM_SEQ, torch.bfloat16)
    cases.append(("glm4-9b geometry B=16", *glm, cur(LM_SEQ - 1001), 128**-0.5, None, None))
    for name, g in (("llama4-scout", 5), ("arctic", 7)):
        moe = draw(16, 8, g, 128, LM_SEQ, torch.bfloat16)
        cases.append((f"{name} geometry B=16", *moe, cur(LM_SEQ - LM_MOE_STEPS), 128**-0.5,
                       None, None))
    rng = np.random.default_rng(SEED + 22)
    for b, hkv, g, d, s, cap_, win_ in ((2, 2, 4, 64, 256, None, None),
                                         (1, 1, 8, 128, 1024, 50.0, 300),
                                         (3, 4, 1, 128, 777, None, None),
                                         (2, 1, 4, 256, 100, 30.0, 64),
                                         (1, 2, 2, 64, 513, None, 128)):
        arrays = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)
                  for shape in ((b, hkv, g, d), (b, s, hkv, d), (b, s, hkv, d))]
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((f"sweep B={b} Hkv={hkv} G={g} d={d} S={s} {dtype}",
                          *(a.to(dtype) for a in arrays), cur(s - 7), d**-0.5, cap_, win_))
    for dtype in (torch.float32, torch.bfloat16):
        off = draw(2, 2, 4, 128, 1017, dtype)
        cases.append((f"cur=0 S=1017 {dtype}", *off, cur(0), 128**-0.5, None, None))
        cases.append((f"S=1017 off every tile, window {dtype}", *off, cur(1016), 128**-0.5,
                      30.0, 100))
    return cases


def decode_bytes(q, k, cur: int, window) -> int:
    """Bytes decode attention must move: the K and V rows the mask keeps,
    q, and the output."""
    s = k.shape[1]
    lo = max(0, cur - window + 1) if window else 0
    n = max(0, min(cur, s - 1) - lo + 1)
    b, _, hkv, d = k.shape
    return 2 * b * n * hkv * d * k.element_size() + 2 * q.numel() * q.element_size()


def check_decode_attention(device, lm, flush):
    """decode_attention against its plain version on the card; times it on
    the decode path's own call beside its byte bound, the plain version and
    scaled_dot_product_attention."""
    from repro_torch.kernels.decode_attention import kernel as dak
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain

    check(lm["args"] is not None, "captured the decode path's last decode_attention call")
    row = dict(max_abs_err=0.0, geometries={})
    for label, q, k, v, cur, scale, cap, win in decode_cases(device, lm["args"]):
        got = dak.decode_attention(q, k, v, cur, scale, cap, win)
        want = decode_attention_plain(q, k, v, cur, scale, cap, win)
        ok, err, ratio, rms = decode_close(got, want)
        check(ok, f"decode_attention != plain on {label} (max abs err {err}, {ratio} of the "
                  f"bound)")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        line = (f"kernels/decode_attention/{label}: max abs err {err:.3e}, {ratio:.4f} of the "
                f"bound, output RMS {rms:.3e}")
        if k.shape[1] == LM_SEQ:
            nb = decode_bytes(q, k, int(cur), win)
            geo = dict(bound_ms=nb / HBM_BYTES_PER_S * 1e3)
            geo["ms"] = time_device(lambda: dak.decode_attention(q, k, v, cur, scale, cap, win),
                                    20, flush, lambda: None)
            line += (f"; device {geo['ms']:.6f} ms (L2 flushed), {nb / geo['ms'] / 1e6:.1f} GB/s, "
                     f"byte bound {geo['bound_ms']:.6f} ms")
            if k.shape[2] > 1 and q.dtype == torch.bfloat16:
                geo["library_ms"], n_keys, lib_err = library_decode_ms(q, k, v, cur, scale, win,
                                                                       flush)
                line += (f"; scaled_dot_product_attention (enable_gqa, {n_keys} keys copied out "
                         f"before timing{', no softcap' if cap else ''}; max abs diff to plain "
                         f"{lib_err:.3e}) {geo['library_ms']:.6f} ms, the kernel "
                         f"{geo['ms'] / geo['library_ms']:.3f}x it")
            row["geometries"][label] = geo
        print(line)
        del got, want
    # slots past cur holding NaN (what a box copy ending past cur would
    # bring in): the bf16 output bit for bit as without them, Hkv 1 and 8
    for hkv, g, d in ((1, 8, 256), (8, 5, 128)):
        gen = torch.Generator(device=device).manual_seed(SEED + 24)
        q, k, v = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
                   for shape in ((2, hkv, g, d), (2, 4099, hkv, d), (2, 4099, hkv, d)))
        for c in (0, 1000, 2047, 3000):
            cur = torch.tensor(c, dtype=torch.int32, device=device)
            o1 = dak.decode_attention(q, k, v, cur, d**-0.5)
            k2, v2 = k.clone(), v.clone()
            k2[:, c + 1:], v2[:, c + 1:] = float("nan"), float("nan")
            check(torch.equal(o1, dak.decode_attention(q, k2, v2, cur, d**-0.5)),
                  f"NaN past cur_len = {c} changed decode_attention's output (Hkv {hkv})")
        print(f"kernels/decode_attention/NaN past the fill: Hkv {hkv} G {g} d {d}, cur 0, 1000, "
              f"2047, 3000: bit for bit as without the NaN")
        del q, k, v, k2, v2
    # the poison case of tests/test_kernels.py: the slots past cur do not count
    q, k, v = (torch.from_numpy(np.random.default_rng(SEED + 23).normal(size=shape)
                                .astype(np.float32)).to(device)
               for shape in ((1, 1, 2, 64), (1, 512, 1, 64), (1, 512, 1, 64)))
    c = torch.tensor(100, dtype=torch.int32, device=device)
    o1 = dak.decode_attention(q, k, v, c, 0.125)
    k[:, 101:], v[:, 101:] = 1e9, -1e9
    check(torch.equal(o1, dak.decode_attention(q, k, v, c, 0.125)),
          "poisoning the slots past cur_len changed decode_attention's output")
    print("kernels/decode_attention/partial fill: the slots past cur_len do not count")

    q, k, v, cur, scale, cap, win = lm["args"]
    b, hkv, g, d = q.shape
    noop = lambda: None  # noqa: E731
    nb = decode_bytes(q, k, int(cur), win)
    lib_ms, n_valid, lib_err = library_decode_ms(q, k, v, cur, scale, win, flush)
    row.update(
        ms=time_device(lambda: dak.decode_attention(q, k, v, cur, scale, cap, win), 50, flush, noop),
        plain_ms=time_host(lambda: decode_attention_plain(q, k, v, cur, scale, cap, win), 10,
                           flush, noop),
        library_ms=lib_ms,
        bound_ms=nb / HBM_BYTES_PER_S * 1e3,
    )
    print(f"kernels/decode_attention/real: B={b} Hkv={hkv} G={g} d={d} S={k.shape[1]} cur="
          f"{int(cur)} {q.dtype}: device {row['ms']:.6f} ms/launch (L2 flushed), "
          f"{nb / row['ms'] / 1e6:.1f} GB/s; plain {row['plain_ms']:.6f} ms; "
          f"scaled_dot_product_attention (enable_gqa, K/V copied to (B, Hkv, {n_valid}, d) "
          f"before timing; max abs diff to plain {lib_err:.3e}) {row['library_ms']:.6f} ms; byte "
          f"bound {row['bound_ms']:.6f} ms ({nb / 1e9:.6f} GB)")
    return row


def library_decode_ms(q, k, v, cur, scale, window, flush):
    """The library's call for a decode_attention call: ``(ms,
    keys, max abs diff to the plain version without a softcap)`` of
    ``scaled_dot_product_attention`` with ``enable_gqa`` (query head kv * G
    + g, as the kernel's).  The keys the mask keeps (the filled slots, of
    the window where there is one) are copied to (B, Hkv, keys, d) before
    timing, which stands for the mask.  SDPA has no logit softcap: on a
    softcapped call it computes the function without it."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ref import decode_attention_plain

    c = int(cur)
    hi = min(c, k.shape[1] - 1) + 1
    lo = max(0, c - window + 1) if window else 0
    b, hkv, g, d = q.shape
    qs = q.reshape(b, hkv * g, 1, d)
    ks = k[:, lo:hi].permute(0, 2, 1, 3).contiguous()
    vs = v[:, lo:hi].permute(0, 2, 1, 3).contiguous()
    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=scale, enable_gqa=True)  # noqa: E731
    err = float((lib().reshape(q.shape).float()
                 - decode_attention_plain(q, k, v, cur, scale, None, window).float()).abs().max())
    return time_device(lib, 50, flush, lambda: None), hi - lo, err


def deepest_mix(common) -> str:
    """The deepest segment of a planned batch: its depth and its requests
    by kind (pads, static hits, admitted and not admitted requests)."""
    order, leader, seg_len, _, h_hi, h_lo, admit, static_hit = (
        x.cpu().numpy() for x in common[:8])
    s = int(seg_len.argmax())
    pos = order[leader[s] : leader[s] + seg_len[s]]
    pad = (h_hi[pos] == -1) & (h_lo[pos] == -1)
    stat = static_hit[pos] & ~pad
    adm = admit[pos] & ~pad & ~stat
    return (f"deepest segment {len(pos)}: static {int(stat.sum())}, pad {int(pad.sum())}, "
            f"admitted {int(adm.sum())}, not admitted {int((~pad & ~stat & ~adm).sum())}")


def empty_launch_ms(device, flush) -> float:
    """Device time of one launch of the commit kernels' grid for a batch of
    B that does nothing, on the current stream: the floor no launch of that
    shape beats."""
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.library("cache_ops").cache_ops_empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run():
        check(fn(B, torch.cuda.current_stream(device).cuda_stream) == 0, "empty launch")

    return time_device(run, 100, flush, lambda: None)


def commit_cases(device):
    """The commit kernels' synthetic cases on ``device``, one at a time:
    ``(label, serve args, probe args)``.  ``uniform``, ``edge``, ``deep``
    and ``one_set`` at W = 8, the depth sweep (``SWEEP_DEPTHS``, and 80 and
    ``DEEP_DEPTH`` with every request to the deep set a static hit), and
    ``deep`` and ``one_set`` again at each of ``SWEEP_WAYS``."""
    seeds = {kind: SEED + i for i, kind in enumerate(("uniform", "edge", "deep", "one_set"))}
    specs = [(kind, kind, {}) for kind in seeds]
    specs += [(f"deep {d}", "deep", dict(depth=d)) for d in SWEEP_DEPTHS]
    specs += [(f"deep {d} static", "deep", dict(depth=d, static_run=True))
              for d in (80, DEEP_DEPTH)]
    for w in SWEEP_WAYS:
        specs += [(f"{kind} W={w}", kind, dict(w=w)) for kind in ("deep", "one_set")]
    for label, kind, kw in specs:
        args = kernel_args(kernel_case(seeds[kind], 1 << 18, B, kind, **kw), device)
        yield label, args, (args[0], *args[4:])


def check_commit_kernels(cases, flush) -> dict:
    """Hold ``serve_fused`` and ``probe_and_commit`` to their plain versions
    bit for bit on each ``(label, serve args, probe args)`` case, print its
    shape and deepest segment, and time both kernels (CUDA events, state
    restored and L2 flushed before every launch).  The ``stream`` case (the
    serving path's own batch) also gets the byte bound, the plain version's
    time and the wrapper's host work.  Returns the kernels line's rows of
    the two kernels."""
    from repro_torch.kernels.cache_ops import kernel as pac
    from repro_torch.kernels.cache_ops import ref
    from repro_torch.kernels.cache_ops import serve_kernel as srv

    rows = {name: dict(max_abs_err=0) for name in ("serve_fused", "probe_and_commit")}
    for label, sargs, pargs in cases:
        ks, val, f_slot, f_vals, *common = sargs
        # serve_fused: kernel vs plain on identical clones
        ks_k, val_k, ks_p, val_p = ks.clone(), val.clone(), ks.clone(), val.clone()
        got = srv.serve_fused(ks_k, val_k, f_slot, f_vals, *common)
        want_srv = ref.serve_fused_plain(ks_p, val_p, f_slot, f_vals, *common)
        torch.cuda.synchronize()
        err = _max_err((ks_k, val_k, *got), (ks_p, val_p, *want_srv))
        check(err == 0, f"serve_fused kernel != plain on the {label} batch (max err {err})")
        rows["serve_fused"]["max_abs_err"] = max(rows["serve_fused"]["max_abs_err"], err)
        # probe_and_commit
        pks, *pcommon = pargs
        ks_k, ks_p = pks.clone(), pks.clone()
        got = pac.probe_and_commit(ks_k, *pcommon)
        want = ref.probe_and_commit_plain(ks_p, *pcommon)
        torch.cuda.synchronize()
        err = _max_err((ks_k, *got), (ks_p, *want))
        check(err == 0, f"probe_and_commit kernel != plain on the {label} batch (max err {err})")
        rows["probe_and_commit"]["max_abs_err"] = max(rows["probe_and_commit"]["max_abs_err"], err)
        seg_len = common[2]
        print(f"kernels/{label}: equal to plain (B={len(seg_len)} S={ks.shape[0]} "
              f"W={ks.shape[1] // 4} V={val.shape[1]}, segments={int((seg_len > 0).sum())} "
              f"depth={int(seg_len.max())}, fill slots={int((f_slot < val.shape[0]).sum())}); "
              f"{deepest_mix(common)}")
        n = 100
        ks_t, val_t, pks_t = ks.clone(), val.clone(), pks.clone()

        def restore_srv():
            ks_t.copy_(ks)
            val_t.copy_(val)

        def restore_pac():
            pks_t.copy_(pks)

        run_srv = lambda: srv.serve_fused(ks_t, val_t, f_slot, f_vals, *common)  # noqa: E731
        run_pac = lambda: pac.probe_and_commit(pks_t, *pcommon)  # noqa: E731
        if label != "stream":
            times = {name: time_device(fn, n, flush, restore)
                     for name, fn, restore in (("serve_fused", run_srv, restore_srv),
                                               ("probe_and_commit", run_pac, restore_pac))}
            print(f"kernels/{label}: depth {int(seg_len.max())}, device ms/launch (L2 flushed): "
                  + ", ".join(f"{k} {t:.6f}" for k, t in times.items()))
            continue
        rows["serve_fused"].update(
            ms=time_device(run_srv, n, flush, restore_srv),
            plain_ms=time_host(
                lambda: ref.serve_fused_plain(ks_t, val_t, f_slot, f_vals, *common), 20,
                flush, restore_srv),
            bound_ms=kernel_bytes(ks, common, val, f_slot, want_srv[2]) / HBM_BYTES_PER_S * 1e3,
            wrapper_ms=time_host(run_srv, n, flush, restore_srv),
        )
        rows["probe_and_commit"].update(
            ms=time_device(run_pac, n, flush, restore_pac),
            plain_ms=time_host(lambda: ref.probe_and_commit_plain(pks_t, *pcommon), 20,
                               flush, restore_pac),
            bound_ms=kernel_bytes(pks, pcommon) / HBM_BYTES_PER_S * 1e3,
            wrapper_ms=time_host(run_pac, n, flush, restore_pac),
        )
    return rows


def phase_kernels(device, served, topics, lm):
    flush = torch.empty(1 << 26, dtype=torch.int32, device=device)  # 256 MiB > L2
    stream_srv = served["one_call"]["args"]
    stream_pac = served["legacy"]["args"]
    check(stream_srv is not None and stream_pac is not None, "captured the serving batch's launches")
    rows = check_commit_kernels(
        itertools.chain([("stream", stream_srv, stream_pac)], commit_cases(device)), flush)
    for name, r in rows.items():
        print(f"kernels/{name}/stream: device {r['ms']:.6f} ms/launch (L2 flushed), with the "
              f"wrapper's host work {r['wrapper_ms']:.6f} ms, plain {r['plain_ms']:.6f} ms, "
              f"byte bound {r['bound_ms']:.6f} ms")
    print(f"kernels/empty launch: device {empty_launch_ms(device, flush):.6f} ms (the commit "
          f"kernels' grid for B={B}, no work; L2 flushed)")
    rows["topic_score"] = check_topic_score(device, topics, flush)
    rows["decode_attention"] = check_decode_attention(device, lm, flush)
    del flush
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card",
              file=sys.stderr)
        return 1
    from repro_torch.core.fast import VecLog, VecStats
    from repro_torch.kernels import _build

    # cuBLAS's workspace for the deterministic comparisons (phase train), set
    # before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # the f32 products stay IEEE f32: the kernel's yardstick too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    device = torch.device("cuda")
    print(f"card: {card}; torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"python {sys.version.split()[0]}")
    t_run = t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} for sm_90a in {time.perf_counter() - t0:.3f} s")
    for name, (_, report) in libs.items():
        if not report:
            print(f"ptxas/{name}: library reused from build/kernels, no report")
        for line in report.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"ptxas/{name}: {line.strip()}")

    t0 = time.perf_counter()
    cfg, keys, true_topic, n_train = make_stream(SEED)
    train, serve = keys[:n_train], keys[n_train:]
    share = float(np.mean(true_topic[serve] >= 0))
    print(f"stream: SynthConfig x{SCALE} (seed {SEED}): {len(train)} training + {len(serve)} "
          f"served requests over {len(true_topic)} query ids, served topical share "
          f"{share:.6f} (config {cfg.topical_fraction}), generated in "
          f"{time.perf_counter() - t0:.3f} s")
    check(abs(share - cfg.topical_fraction) <= TOPICAL_TOL,
          f"served topical share {share:.6f} is not the config's {cfg.topical_fraction}")
    t0 = time.perf_counter()
    vstats = VecStats.from_log(VecLog(keys, n_train, true_topic))
    ccfg, static, n_distinct = plan_cache(vstats)
    cache = make_cache(device, ccfg, static)
    print(f"cache: {ccfg.total_entries} entries = {cache.n_sets} sets x {WAYS} ways + "
          f"{len(static)} static keys, {cache.k} topic partitions; "
          f"{ccfg.total_entries / n_distinct:.6f} of the training prefix's {n_distinct} "
          f"distinct queries; planned in {time.perf_counter() - t0:.3f} s")

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase/{name}: {time.perf_counter() - t:.3f} s")
        return out

    first = make_broker(cache, true_topic, device)
    warm = phase("warm", phase_warm, first, train)
    served = phase("serve", phase_serve, device, cache, true_topic, first, warm, serve)
    phase("cpu", phase_cpu, ccfg, static, true_topic, warm, served)
    brk = phase("broker", phase_broker, device, vstats, ccfg, static, true_topic, train, warm,
                serve, served)
    cl = phase("cluster", phase_cluster, device, vstats, true_topic, warm, serve, served)
    # the analysis resets the peak to measure its own: keep the run's for the line after lm
    early_peak = torch.cuda.max_memory_allocated()
    ana = phase("analysis", phase_analysis, device, keys, true_topic, n_train, vstats, served)
    early_peak = max(early_peak, ana["peak"])
    del vstats
    topics = phase("topics", phase_topics, device, cfg, keys, true_topic, n_train, served,
                   static)
    lm = phase("lm", phase_lm, device, served["one_call"]["miss_ids"])
    # release the LM's weights and KV cache; the kernels phase needs only the
    # decode path's captured call
    lm = {k: lm[k] for k in ("launches", "args")}
    gc.collect()
    torch.cuda.empty_cache()
    print(f"memory: peak {max(early_peak, torch.cuda.max_memory_allocated()) / 1e9:.3f} GB "
          f"allocated through phase lm's gemma-2b; {torch.cuda.memory_allocated() / 1e9:.3f} GB "
          f"after releasing it")
    wide = phase("lm/windowed", phase_lm_windowed, device)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    moe = phase("lm/moe", phase_lm_moe, device)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = phase("mesh", phase_mesh, device)
    print(f"memory: peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB allocated in phase "
          f"mesh")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train = phase("train", phase_train, device)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = phase("recsys", phase_recsys, device)
    print(f"memory: peak {max(rec['peak'], torch.cuda.max_memory_allocated()) / 1e9:.3f} GB "
          f"allocated in phase recsys")
    gc.collect()
    torch.cuda.empty_cache()
    phase("gnn", phase_gnn, device)
    rows = phase("kernels", phase_kernels, device, served, topics, lm)
    lm_launches = lm["launches"]
    del lm

    kernels = []
    # each kernel's launches come from the run of the path that uses it
    # (the serve phase's path and the broker phase's, each counted from 0)
    for name, path, replaces in (
        ("serve_fused", "one_call", "src/repro/kernels/cache_ops/serve_kernel.py:203"),
        ("probe_and_commit", "legacy", "src/repro/kernels/cache_ops/kernel.py:215"),
    ):
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source="src/repro_torch/csrc/cache_ops.cu",
            replaces=replaces,
            launches=(served[path]["launches"][name] + brk["launches"][name]
                      + cl["launches"][name]),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by="bytes", library_ms=None,
        ))
    kernels[-1].update(migration_ms=brk["migration_ms"],
                       migration_bound_ms=brk["migration_bound_ms"],
                       migration_nopad_ms=brk["migration_nopad_ms"],
                       reshard_ms=[t[0] for t in cl["reshard_hash"]["times"]],
                       reshard_bound_ms=[t[1] for t in cl["reshard_hash"]["times"]])
    r = rows["topic_score"]
    kernels.append(dict(
        name="topic_score", route="cuda", source="src/repro_torch/csrc/topic_score.cu",
        replaces="src/repro/kernels/topic_score/kernel.py:51",
        launches=topics["launches"] + cl["launches"]["topic_score"],
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
    ))
    r = rows["decode_attention"]
    g27, glm = wide["gemma2-27b"], wide["glm4-9b"]
    l4, arc = moe["llama4-scout-17b-a16e"], moe["arctic-480b"]
    kernels.append(dict(
        name="decode_attention", route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:90",
        launches=lm_launches + g27["launches"] + glm["launches"] + l4["launches"]
        + arc["launches"] + mesh["gemma-2b"]["launches"]
        + mesh["llama4-scout-17b-a16e"]["launches"],
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by="bytes", library_ms=r["library_ms"],
        # the other LMs' paths (phases lm/windowed and lm/moe): gemma2-27b's
        # local layer 0 through the window slice and the full read, glm4-9b's,
        # llama4-scout's and arctic's layer 0
        launches_by_path={"gemma-2b": lm_launches, "gemma2-27b": g27["launches"],
                          "glm4-9b": glm["launches"], "llama4-scout-17b-a16e": l4["launches"],
                          "arctic-480b": arc["launches"],
                          "mesh/gemma-2b": mesh["gemma-2b"]["launches"],
                          "mesh/llama4-scout-17b-a16e": mesh["llama4-scout-17b-a16e"]["launches"]},
        gemma2_27b_slice_ms=g27["slice_ms"], gemma2_27b_full_ms=g27["full_ms"],
        gemma2_27b_plain_ms=g27["plain_ms"], gemma2_27b_bound_ms=g27["bound_ms"],
        gemma2_27b_library_ms=g27["library_ms"],
        glm4_9b_ms=glm["full_ms"], glm4_9b_plain_ms=glm["plain_ms"],
        glm4_9b_bound_ms=glm["bound_ms"], glm4_9b_library_ms=glm["library_ms"],
        llama4_scout_ms=l4["ms"], llama4_scout_plain_ms=l4["plain_ms"],
        llama4_scout_bound_ms=l4["bound_ms"], llama4_scout_library_ms=l4["library_ms"],
        arctic_ms=arc["ms"], arctic_plain_ms=arc["plain_ms"],
        arctic_bound_ms=arc["bound_ms"], arctic_library_ms=arc["library_ms"],
        # the kernels phase's geometries on seeded data
        geometries=r["geometries"],
    ))
    r = rec["row"]  # the serve_bulk user bag
    kernels.append(dict(
        name="embedding_bag", route="cuda", source="src/repro_torch/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag/kernel.py:37",
        launches=rec["launches"] + train["launches"] + mesh["two-tower"]["launches"],
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by="bytes", library_ms=r["library_ms"],
        launches_by_path={"recsys": rec["launches"], "train": train["launches"],
                          "mesh/two-tower": mesh["two-tower"]["launches"]},
    ))
    print(f"run: {time.perf_counter() - t_run:.3f} s after the card check")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
