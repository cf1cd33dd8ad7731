"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py [--seed 0]

Runs from the root of a checkout and builds everything it needs (the CUDA
kernels under seqrec_tpu_torch/csrc/, with nvcc for sm_90a, one nvcc per
source, all at once). Each phase prints one JSON line:

  a. device   the card's name and power limit (nvidia-smi);
  b. build    compile the kernels from the checkout's sources, timed, with
              ptxas's registers and spills of every spilling kernel and of
              every instantiation of the newest designs (WATCH);
  c. kernels  each kernel against its plain PyTorch version at the serving
              shapes (gather: from a [3418, D] f32 table into bf16 and f32,
              at D=64 and 128, at serving's [64, 200] ids, training's
              [128, 200] and the 256 negatives, with planted out-of-range
              ids, bit-exact, beside F.embedding then .to(dtype); GRU:
              B=64, T=200, D=H=128 in f32
              and bf16, and against torch.nn.GRU as a second oracle, and
              also at the training shape B=128 and at the fit loop's
              D=H=64; the bf16 forward's input
              projection kernel (twice bit for bit, beside torch.addmm(...,
              out_dtype=torch.float32): bf16 in, f32 out) and the f32 one's,
              which the f32 GRU forward runs, the f32 one also at the
              training paths' M=25,600 with N=384 and N=512, each beside
              torch.addmm f32), with kernel, plain, library and bound times
              and each kernel's design (wgmma, mma.sync, cluster,
              fma, simt or cuda-core);
  d. serve    `recommend` on the ML-1M GRU4Rec configuration
              (configs/ml1m_gru4rec.json, seeded random weights) for a few
              hundred Zipf-distributed histories, batch 64, k=10: once with
              the kernels (use_pallas=true; launch counters reset just
              before and read just after) and once with the plain versions,
              which must agree; a batch's encode, scores and top-k step by
              CUDA events, and its encode on the device alone (behind a
              ~30 ms sleep: `encode_device_ms`);
  e. train_kernels  the training path's kernels against their plain
              versions at its shapes (B=128, T=200, D=H=128, S=256, the
              [3418, 128] table): the gather's scatter-add backward with
              planted out-of-range ids, deterministic (two runs equal bit
              for bit, and equal to plain_ordered, its order in plain
              tensor code), its device operations a call counted by
              torch.profiler (at most 2), and again on ids padded as
              training pads them (about half on row 0) beside index_add_,
              there also on a bf16 cotangent (bit for bit its f32
              widening's result);
              the GRU reverse recurrence (d_xp, dh0) and the
              weight gradients through autograd, bf16 and f32; the
              sampled-softmax head's NLL and its loss and gradients, bf16
              and f32, the device time of its backward (a plain
              recompute), and the f32 head at beauty's step (N=6,400,
              S=256, H=256); the GRU reverse and the head also at the fit
              loop's D=H=64; with kernel, plain, library and bound times
              and each kernel's design and launch config (mma.sync,
              cluster, simt-stream or sorted-chunks);
  f. train    `Trainer.train_step_multi` on the same configuration at full
              width: Zipf histories of 5..200 items packed into [8, 128, 202]
              int16 wire groups, six groups through the kernels (counters
              reset just before and read just after) and one through the
              plain versions; step-1 loss and gradient norm of the two
              agree, every loss is finite, the last group's mean loss is
              below the first's, and each kernel launches its expected
              number of times per step (none in the plain run); examples/s,
              step ms and a device-time split of a step by CUDA events;
              one step's gradients and one K=8 group, each run twice from
              one state on one batch group, equal bit for bit (every
              gradient, parameter and optimizer-state leaf); the device
              launches a step also with the lookups as a gather then a cast
              (before the gather wrote the compute dtype);
  f2. fit     `Trainer(cfg).fit()` at bench.py's configuration (GRU4Rec,
              B=128, T=200, D=H=64, 3,417 synthetic items, sampled softmax
              over 256 log-uniform negatives, dropout 0, bf16): 104 steps
              through the native loader and the prefetcher (prefetch depth
              2), steps_per_call 8 and 1 alternated (8, 1, 1, 8); every
              logged loss finite and the last below the first, each kernel's
              launches a step as expected, one full-protocol eval with
              finite metrics (recall@10 within 0.02 of the plain versions'
              on the same weights), the four runs' final parameters equal
              bit for bit; examples/s and step ms from the logger's lines,
              the eval's seconds, and from a profiled short fit the device
              time, launches and top kernels a step and the idle share;
              then a 40-step fit with train.profile_dir (a temporary
              directory) and profile_steps (8, 24): one Chrome trace whose
              groups are exactly the window's three (their labels), naming
              each hand-written kernel of the path, its launches a step equal
              to the counters', its device operations a step beside the
              profiled fit's;
  g. tower_kernels  the SASRec and LSTM towers' kernels against their plain
              versions at the training shapes, bf16 and f32: causal
              attention at [128, 200, 1, 64] (also against
              F.scaled_dot_product_attention, its library yardstick, and
              timed beside it at serving's [64, 200, 1, 64], whose bits
              equal the batch's first 64 rows); the LSTM forward at B=128,
              T=200, D=H=128 (also against torch.nn.LSTM, and timed beside
              nn.LSTM in f32, also at serving's B=64), its bf16 and f32
              input projections (the f32 one also against f64); the LSTM
              reverse recurrence (dz, dh0, dc0) and the weight gradients
              through autograd; with kernel, plain, library and bound times
              and each kernel's design;
  h. serve    phase d on configs/ml1m_sasrec.json and configs/ml1m_lstm.json,
              with the same histories;
  i. train    phase f on both, three groups through the kernels and one
              through the plain versions each (SASRec's 1,000-step warmup
              is set to 0 so that 24 steps run at the peak rate);
  j. session_kernels  the reset variants of the GRU and LSTM scans and of
              their reverse recurrences (session-parallel training) against
              their plain versions, bf16 and f32, at B=256, T=50, D=H=100
              (rsc15_gru4rec, GRU) and B=128, T=200, D=H=128 (GRU and LSTM),
              with a session start about every 6 positions and a dirty
              carry: an all-zero reset plane gives the no-reset kernels'
              bits, a reset at t=0 makes the output independent of h0 (and
              c0) and the h0 (and c0) gradient zero, and gradients through
              autograd match; with kernel, plain and bound times;
  k. train_session  `Trainer.train_step_multi` with the carry across
              windows on configs/rsc15_gru4rec.json, unchanged (bf16,
              D=H=100, B=256, T=50, BPR-max over 2,048 uniform negatives),
              fed [256, 50] windows of a session-parallel stream over
              synthetic sessions with RSC15's shapes (37,483 items, 100,000
              sessions of 2..12 clicks), packed into int32 session wires: 3
              groups through the kernels, 1 through the plain versions, the
              checks of phase f plus the step-1 carry, peak device memory
              that does not grow from the first group to the last, and the
              windows that fell back to the dict path; then the same on
              configs/ml1m_lstm.json with data.session_parallel=true
              (synthetic ML-1M-shaped sessions of 5..200 items), 2 groups;
  l. the f32 paths: model.compute_dtype=float32 on a shipped config (no
              config file of its own): serve on configs/ml1m_gru4rec.json,
              configs/ml1m_sasrec.json and configs/ml1m_lstm.json as phase d
              (the f32 GRU and LSTM forwards: their f32 input projections
              and cluster recurrences; the f32 causal attention), scores
              within the f32 limit of the plain path; train on
              configs/ml1m_lstm.json (the f32 LSTM forward and the cluster
              reverse recurrence), configs/ml1m_gru4rec.json and
              configs/ml1m_sasrec.json (warmup 0, as phase i), as phase f
              with two groups, step-1 loss and gradient norm within 1e-4
              relative of the plain run; on gru4rec f32 also phase f's
              bit-for-bit check of two runs;
  n. sparse   the sparse row-wise embedding step through `Trainer(cfg).fit()`:
              configs/synthetic10m_singlechip.json unchanged but for
              num_steps=48 and a temporary out_dir and data_dir (10,000,001 x
              128 f32 table, 100,000 synthetic users, B=256, T=50, 512
              log-uniform negatives, adagrad, clip 5, K=8, bf16), from a state
              drawn once (its seconds: the table in row blocks), and the same
              fit through the plain versions from a clone of that state (the
              step updates the table in place): every group's loss finite,
              step 1 and each group's mean loss and largest gradient norm
              within phase f's bf16 limits of the plain fit's (the loss is
              flat over these 48 steps: how far the tower and the 1,024 most
              drawn rows moved is reported), each kernel's launches a step
              (the gather once more: it fetches the sub-table), peak device
              memory under the table and its accumulator plus 2 GB (no [V, D]
              gradient, one table), table rows changed at most steps x
              budget; ex/s and step ms by CUDA events between groups, the
              device time and idle share of a step, the device times of the
              unique set and remaps, the sub-table fetch, the scatter-add into
              the sub-table (beside index_add_) and the row update, and each
              step's distinct ids (replayed after the run); then
              configs/rsc15_10m.json on one card (mesh.model_axis=1,
              mesh.shard_embeddings=false, checkpoint_every=0: the
              session-parallel sparse step, capped at 16,384 unique ids with
              the sentinel row, dropout 0.1, 2,048 negatives) with the same
              checks, a finite carry and the ids past the cap a step; after
              each, the GRU forward (and its input projection), the GRU
              reverse recurrence (their reset variants on rsc15_10m, with a
              carried-in state) and the head at that path's own shapes (B=256,
              T=50, H=128; N=12,800 with S=512 and 2,048), bf16, against their
              plain versions at phases c, e and j's limits; then at
              configs/ml1m_gru4rec.json's table in f32 the sparse step against
              the dense one, sgd and adagrad, a K=8 group: every parameter
              within 1e-5 relative;
  o. checkpoint  configs/ml1m_gru4rec.json as shipped but checkpoint_every=16
              and 48 steps (synthetic ML-1M-shaped data): a straight fit against
              one killed at step 24 and resumed, every parameter and optimizer
              leaf equal bit for bit, the saves' bytes and seconds; the `eval`
              subcommand's metrics equal `Trainer.evaluate`'s and `recommend
              --ckpt` the top-k of `recommend` on the in-memory state; then the
              same resume check on configs/rsc15_gru4rec.json (session-parallel:
              the stream's snapshot, the carry) and on the sparse step at
              ML-1M's catalog (lazy adam's row state);
  p. sharded  p1: one K=8 group of configs/ml1m_gru4rec.json (dropout 0)
              through the mesh trainer over an NCCL process group of one
              rank, every parameter and optimizer leaf bit for bit the group
              with no process group; p2: two ranks of this script
              (--p2-rank) sharing cuda:0 over gloo (NCCL refuses two ranks
              on one device; every collective is staged through host
              memory, so p2's collective times say nothing of NCCL): the
              dense sharded ML-1M step (model_axis=2, f32, adagrad) and an
              f32 K=8 group of configs/synthetic10m_sharded.json, both at
              lr 0.05, each held against one rank on the global batch (1e-5
              of each leaf's largest value), each also reading a planted
              fault (shard 1's row update skipped) that must exceed 1e-5,
              then configs/ml100k_gru.json with mesh.model_axis=2 and
              mesh.shard_embeddings (the vocab-parallel full softmax over
              848-row shards of the table and its output bias, buckets
              [50, 100, 200] on one global stream, synthetic data of
              ML-100K's shape): an f32 K=8 group (adagrad, dropout 0) at lr
              0.05 against one rank on the global batch (1e-5), with its
              planted fault (shard 1's table and bias rows as before the
              group), then a 48-step bf16 fit as shipped (dropout 0.1,
              adam): finite global losses alike on both ranks, the last
              group's below the first's, launches a step, ex/s, step,
              device and collective ms, peak memory, and the full-protocol
              sharded eval; then 48-step fits of
              configs/synthetic10m_sharded.json and configs/rsc15_10m.json
              as shipped (model_axis=2, 5,000,004-row shards): finite global
              losses alike on both ranks, each kernel's launches a step,
              peak memory under the shard and its row state plus 2 GB, shard
              rows changed at most steps x budget, ex/s, step, device and
              collective ms a step; p3: the gather's and the scatter-add's
              shard-window variants bit for bit against their plain versions
              at the sharded fetch's and the dense sharded step's shapes,
              timed beside the library call and the bound. The same p2 work
              over NCCL, a card a rank: torchrun --nproc_per_node=N
              chip_smoke.py --sharded-ranks DIR, then chip_smoke.py
              --sharded-check DIR (one JSON line);
  q. remat    SASRec block rematerialization on configs/ml1m_sasrec.json
              at full width (B=128, T=200, D=64, 2 blocks, dropout 0.2,
              warmup 0 as phase i), bf16 and f32: one K=8 group with
              model.remat=true and one without from one state on one batch
              group, every first-step gradient, parameter and optimizer leaf
              and the metrics bit for bit; the attention kernel's launches a
              step (twice a block with remat: the backward replays the
              forward); peak device memory and step ms each way, four timed
              groups each, alternated;
  r. reshard  resharding on restore, checkpoints written by two ranks of
              this script (--r-rank) sharing cuda:0 over gloo, read by this
              one process at 1 x 1: r1 configs/ml1m_gru4rec.json at full
              width (bf16) with mesh.model_axis=2 and mesh.shard_embeddings,
              24 steps and a checkpoint, restored with the table padded
              alike (3,424 rows at model axis 1 and 2): every leaf the two
              ranks' parts put together, bit for bit; the `eval` subcommand
              in f32 on it within 1e-5 relative of the two ranks' f32 eval;
              `recommend --ckpt` of it answering the 320 requests; 24 more
              steps resumed from it through the kernels (finite losses, the
              last group's below the first's, each kernel's launches); r2
              the same config with the tables whole written at 2 x 1,
              restored bit for bit, one K=8 group from it; r3 a
              configs/rsc15_gru4rec.json (session-parallel) checkpoint of
              the two ranks refused, the ValueError naming the carry and
              both global shapes; each restore's seconds, bytes read and
              host peak resident set;
  s. benchmark  the `benchmark` subcommand and its runner
              (seqrec_tpu_torch/benchmarks/), each line beside the card's
              name and power limit: s1 `benchmark` at bench.py's
              configuration (the port's `bench_config`, written to a
              temporary config file), chains of 96 and 288 steps after 5
              warmup steps: exactly the runner's keys, backend cuda, a
              finite step time, `reliable`, and each kernel's launches a
              step over the timed chains (counters zeroed just before them,
              read just after) as the training path expects; s2
              `run_pipeline_alternating` of that configuration, Trainer.fit
              end to end, K=8 against K=1 (96 / 288 steps, 5 reps, settle
              on), the launches over all of it, beside phase f2's logger
              ex/s; s3 configs/beauty_gru.json (2 GRU layers, D=H=256,
              buckets 10/20/50, tied embeddings, S=256, dropout 0.2, bf16):
              its bf16 GRU forward, projection, reverse and head against
              their plain versions at its step (B=128, T=50, D=H=256, S=256;
              each kernel's own limit, in the kernels line as
              `at_beauty_gru`, the GRU's cluster layouts also as entries of
              their own), those layouts' edges (B=64 and 3, T=10 and 20,
              H=200, the reset variant with h_in in f32 on the keep path;
              each output twice, bit for bit), serving beauty_gru (batch
              64, k=10) through the kernels against the plain path with
              phase d's checks, step 1 through the kernels against the plain
              versions (1e-5 / 5e-3 relative) and two planted faults (units
              128..255 of the GRU's output, or of its gate gradients, zeroed
              for a step) that those limits must fail, then `benchmark`
              (48 / 144 steps); s4
              `benchmark` on configs/rsc15_gru4rec.json (48 / 144) and on
              configs/synthetic10m_singlechip.json (32 / 96): one
              `init_state`, a clone a chain, peak device memory under two
              states (table and accumulator) plus 2 GB, the seed state's
              table and accumulator unchanged (fingerprints);
  t. widths   (run after l, before n) the published widths, whose rows
              are not 16-byte multiples: SASRec as published (configs/ml1m_sasrec.json with
              model.embed_dim=50: d = 50, 2 blocks, 1 head, T = 200) and
              GRU4Rec's 100 units under configs/ml1m_gru4rec.json's sampled
              softmax (model.embed_dim=100). The gather from a [3418, 50]
              f32 table at [128, 200] and [64, 200] ids into bf16 and f32
              (bit for bit, NaN rows), its scatter-add at D = 50 (the
              float-unit path, f32 and bf16 cotangents), the attention on the
              block's qkv slices at [128, 200, 1, 50] (SDPA beside it, with
              the backend it takes), the head at N = 25,600, S = 256, H = 50
              in both dtypes and H = 100 in bf16, each at its phase's limit
              with kernel, plain, library and bound times; SASRec d = 50
              served (as phase h) and trained (as phases i and l, three
              groups) in bf16 and f32; GRU4Rec D = H = 100 trained, two K = 8
              groups (as phase f);
  u. wide     (run after t, before n) above H = 256: the GRU's grid-persistent
              layouts (forward and reverse, both variants, bf16 and f32) and
              the head's K split against their plain versions, each launched
              twice bit for bit, at the JAX package's wide GRU4Rec
              (benchmarks/shapes.py's gru4rec_D512_B256_T200_S512: B=256,
              T=200, D=H=512, the head at N=51,200, S=512; nn.GRU and h @
              neg.T beside them) and at rsc15's reset shape with GRU4Rec's
              1,000 units (B=256, T=50), the f32 forward's step plan and
              its input projection timed alone (`_grid_f32_split`); the wide
              demo, built by the port's
              bench_config (100,000 items, 512 sampled negatives), served as
              phase d and trained, two K=8 groups in bf16 and in f32, as
              phase f; GRU4Rec-1000 (configs/rsc15_gru4rec.json with
              model.embed_dim=1000) trained session-parallel with the carry,
              two K=8 groups, as phase k; the `train` subcommand on it (16
              steps over 10,000 synthetic sessions, then its full eval);
  v. wide_lstm (run after u, before n) the LSTM's grid-persistent layouts
              (forward and reverse, both variants, bf16 and f32) against
              their plain versions, each launched twice bit for bit, as
              phase g's checks (nn.LSTM beside them, the gradients through
              autograd), at the wide LSTM's step (the JAX package's
              benchmarks/scan_ab.py wide_lstm_D512 in a whole model: B=256,
              T=200, D=H=512) and at ml1m_lstm's reset shape at that width
              (B=128, T=200), the f32 forward's step plan and its input
              projection timed alone; the wide LSTM (benchmarks/shapes.py:70-72's
              arguments through the port's bench_config, model.cell_type
              "lstm": 100,000 items, 512 sampled negatives) served as phase
              d and trained, two K=8 groups in bf16 and in f32, as phase f;
              configs/ml1m_lstm.json session-parallel at model.embed_dim=512
              trained with the carry, two K=8 groups, as phase k; and the
              wide SASRec (benchmarks/shapes.py:65-68's
              sasrec_2xD256_B256_T200_S512 through bench_config) served and
              trained the same way in bf16 and f32;
  w. all_widths (run after v, before n) every width the JAX package takes:
              the attention's Dh-cluster layout (Dh = 257 and 1,000, and
              one SASRec head of d = 512 at B=256; its descriptor control,
              which must fail) and Dh-sliced layout (Dh = 2,304 at B=8,
              and one call of it counted as its path), the scans' padded route
              (D = 50, H = 50 at B=128, T=200 and 102) and stepped layout
              (each grid limit + 4 and 2,302, every variant; D = H = 2,304 at
              B=256, T=200) and the head's streamed layout (each limit + 1;
              N=51,200, S=512, H=2,304) against their plain versions, each
              twice bit for bit, as phases c, e, g and j check them (SDPA,
              nn.GRU / nn.LSTM and cuDNN's backward, h @ neg.T beside them);
              the stepped scans' bf16 step GEMM alone at w3's steps (the GRU's
              and the LSTM's, forward and reverse) against its plain version
              and torch.matmul in f32, twice bit for bit (torch.matmul in
              bf16 beside it); the bf16 input projection alone at rsc15's
              D = 100, d = 52, the wide towers' D = 512 and w3's 2,304, the
              GRU's N = 3H and the LSTM's 4H (XPROJ_SHAPES), against its
              plain version and torch.addmm(..., out_dtype=torch.float32),
              twice bit for bit;
              then served as phase d and trained as phases f and k in bf16
              and f32: w1 benchmarks/shapes.py:65-68's SASRec at
              embed_dim=512 (2 blocks of one head), two K=4 groups; w2
              configs/ml1m_gru4rec.json and configs/ml1m_lstm.json at
              model.embed_dim=50 (the LSTM trained session-parallel), two K=8
              groups; w3 benchmarks/shapes.py:70-72's wide demo at
              embed_dim=2,304, the GRU and the LSTM cell, two groups of
              W3_K steps at W3_LR; each section's and run's seconds;
  m. the kernels line: {"kernels": [{name, route, source, replaces,
              launches, max_abs_err, ms, plain_ms, bound_ms, bound_by,
              library_ms, design, dtype}, ...]} (the scatter-add also
              with deterministic and launches_per_call): the fourteen bf16 kernels
              (each bf16 RNN forward is two: its input projection and the
              scan; the gather into bf16, its scatter-add on a bf16
              cotangent) and the ten f32 kernels the f32 paths run (each f32
              RNN forward is two as well), `launches` counted on a training
              path (GRU4Rec's for the gather, scatter-add and head, the
              session paths' for the reset variants, the f32 paths' for the
              f32 kernels; the counts of every path beside it, the fit
              loop's, the profile_dir fit's, the sparse fits', p2 rank 0's
              ml100k fit's, phase q's, phase r's and phase s's included), the two
              shard-window variants, their launches counted on p2's rank 0,
              and the GRU's two cluster layouts (Hp > 128, `gru_scan_wide`,
              `gru_backward_wide`), their launches counted on s3's chains;
              the gather, scatter-add, attention and head entries also
              `at_published_widths` (phase t: their d = 50 / H = 100 times,
              bound, plain and library, and launches a step on that path);
              the GRU's grid layouts and the head's K split in bf16 and f32
              (`gru_scan_grid`, `gru_backward_grid`, `softmax_head_ksplit`,
              each also `_f32`; phase u), their launches counted on the wide
              demo's bf16 and f32 training paths, the GRU's also
              `at_rsc15_h1000_reset`; the LSTM's grid layouts in bf16 and
              f32 (`lstm_scan_grid`, `lstm_backward_grid`, each also `_f32`;
              phase v), their launches counted on the wide LSTM's bf16 and
              f32 training paths, each also `at_ml1m_lstm_h512_reset` (the
              f32 forwards of both phases also their `grid_plan`,
              `input_projection_ms` and `recurrence_ms`); phase
              w's layouts in bf16 and f32 (`causal_attention_cluster`,
              `causal_attention_sliced` (its launches on its one-call path),
              `gru_scan_padded`, `gru_backward_padded`, `lstm_scan_padded`,
              `lstm_backward_padded`, `gru_scan_stepped`,
              `gru_backward_stepped`, `lstm_scan_stepped`,
              `lstm_backward_stepped`, `softmax_head_streamed`, each also
              `_f32`), at w1's, w2's or w3's step, their launches counted on
              that path's training run; the stepped scans' bf16 step GEMM
              (`step_gemm`, forward; `step_gemm_reverse`; both on wgmma)
              at w3's GRU step, its launches (one a step of each bf16
              stepped scan) counted on w3's GRU training path; the bf16
              input projections' entries (`gru_xproj`, `lstm_xproj`) also
              `at_shapes`: phase w's XPROJ_SHAPES, each with its plan.

Before it a line {"phase": "run", "seconds", "all_widths_seconds"}; then
the raw nvidia-smi name/power-limit line, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises: the script exits non-zero without the ok line. It
exits non-zero too when CUDA is not available; there is no CPU path.

Times come from CUDA events: each rep first queues a ~1 ms device sleep, so
the events bracket the device's work and not the host's launch latency (the
plain scans, thousands of small launches, stay host-bound and are timed as
they run).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from seqrec_tpu_torch import cli, ops
from seqrec_tpu_torch.benchmarks import throughput
from seqrec_tpu_torch.benchmarks.throughput import bench_config
from seqrec_tpu_torch.config import RunConfig
from seqrec_tpu_torch.data import native
from seqrec_tpu_torch.data.batching import make_session_stream
from seqrec_tpu_torch.data.dataset import load_dataset, synthetic_dataset
from seqrec_tpu_torch.data.negative import log_uniform_log_prob, sample_log_uniform
from seqrec_tpu_torch.data.prefetch import StagedBatch
from seqrec_tpu_torch.eval import infer
from seqrec_tpu_torch.eval.harness import evaluate
from seqrec_tpu_torch.models import build_model
from seqrec_tpu_torch.models.convert import flax_to_state_dict, random_params
from seqrec_tpu_torch.models.model import SAMPLED_LOSSES, SeqRecModel
from seqrec_tpu_torch.ops import _build, reference
from seqrec_tpu_torch.ops.cuda import attention as k_attn
from seqrec_tpu_torch.ops.cuda import gather as k_gather
from seqrec_tpu_torch.ops.cuda import gru as k_gru
from seqrec_tpu_torch.ops.cuda import head as k_head
from seqrec_tpu_torch.ops.cuda import lstm as k_lstm
from seqrec_tpu_torch.runtime.mesh import init_distributed, make_mesh, shutdown
from seqrec_tpu_torch.train import sparse_embed
from seqrec_tpu_torch.train.state import TrainState, clone_state
from seqrec_tpu_torch.train.trainer import Trainer

CONFIGS = {"gru4rec": "configs/ml1m_gru4rec.json", "sasrec": "configs/ml1m_sasrec.json",
           "lstm": "configs/ml1m_lstm.json", "rsc15_gru4rec": "configs/rsc15_gru4rec.json",
           "beauty_gru": "configs/beauty_gru.json"}
VOCAB = 3418  # ML-1M: 3,417 items + the pad row (bench.py's catalog)
# Synthetic sessions with each session path's shapes (synthetic_dataset's
# arguments). RSC15: the catalog after the GRU4Rec paper's filtering (Hidasi
# et al., ICLR 2016, Table 1), sessions as configs/rsc15_10m.json synthesizes
# them; ML-1M: its catalog and users, histories of 5..200 as phases d-i.
SESSION_DATA = {"rsc15_gru4rec": dict(num_users=100_000, num_items=37_483, min_len=2,
                                      max_len=12),
                "lstm": dict(num_users=6_040, num_items=VOCAB - 1, min_len=5, max_len=200)}
B, K = 64, 10  # serving batch (the CLI default) and top-k
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense; f32 w/o tensor cores
REPS = 21
# The gather's shapes (phase c): serving's [64, 200] ids, training's
# [128, 200] and the 256 negatives, at the fit loop's D=64 and at D=128.
GATHER_WIDTHS = (64, 128)
FIT_D = 64  # the fit loop's width: bench.py's GRU4Rec, D=H=64
GATHER_SHAPES = ((64, 200), (128, 200), (256,))

# Tolerances, each with its reason.
GRU_F32_TOL = 1e-5  # same f32 math, another summation order
GRU_CUDNN_F32_TOL = 1e-4  # cuDNN's own GEMM order, TF32 off
GRU_BF16_TOL = 3e-2  # plain rounds every gate op to bf16, the kernel only h
XPROJ_TOL = 1e-5  # exact bf16 products summed in f32 on both sides, another order
# The bf16 projection above D = 256 (the wide towers' 512, w3's 2,304 products a
# sum): 1e-5 of the largest value, the step GEMM's forward rule (STEP_GEMM_TOL[1]).
XPROJ_WIDE_REL_TOL = 1e-5
# Serve: bf16 scores through two numerics of the tower (kernel vs plain):
# GRU 1e-2 (CPU emulation: 1e-3); SASRec 5e-2 (the plain attention rounds
# its scores to bf16, through two blocks and LayerNorms); LSTM 5e-2 (the
# plain scan also rounds its cell state to bf16 each step, over 200 steps).
# The wide GRU4Rec (phase u): 512-term score dots, beauty_gru's 1e-2 at D =
# 256 times sqrt(512 / 256), rounded up.
# The wide LSTM (phase v): the wide GRU4Rec's 512-term limit. The wide
# SASRec (phase v): ml1m_sasrec's 5e-2 at d = 64 times sqrt(256 / 64).
SCORE_TOL = {"gru4rec": 1e-2, "sasrec": 5e-2, "lstm": 5e-2, "beauty_gru": 1e-2,
             "gru4rec_wide": 2e-2, "lstm_wide": 2e-2, "sasrec_wide": 1e-1}
# f32 serving: the same f32 math through the tower in another summation
# order (the GRU forward's f32 limit is 1e-5), then a 128-term score dot.
F32_SCORE_TOL = 1e-4
F32 = "model.compute_dtype=float32"  # the override of the f32 paths
# Training path (B=128, T=200, S=256).
TRAIN_B, TRAIN_T, NUM_NEG = 128, 200, 256
HEAD_TOL = 1e-4  # nll ~6: f32 sums of 128 products and 257 exps in another order
HEAD_LOSS_BF16_TOL = 1e-2  # relative: the plain loss rounds its logits to bf16
GRU_BWD_TOL = 1e-4  # relative to the largest value: f32 carry over 200 steps, another order
GRU_BWD_BF16_W_TOL = 2 ** -7  # relative: weight grads rounded to bf16 on both sides
STEP1_LOSS_TOL = 2e-2  # relative, kernels vs plain: bf16 compute, two tower numerics
STEP1_NORM_TOL = 5e-2  # relative, the same, through the backward
STEP1_F32_TOL = 1e-4  # relative, f32 paths: the same f32 math in another summation order
# The towers' kernels (phase g).
ATTN_F32_TOL = 2e-5  # an online softmax: the same f32 math summed in another order
ATTN_BF16_TOL = 5e-2  # the plain version rounds its scores to bf16, the kernel keeps f32
ATTN_BF16_EXACT_TOL = 2e-2  # vs f32 math on the same bf16 inputs: p and o rounded to bf16
ATTN_LIB_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # SDPA: its own order and rounding
LSTM_F32_TOL = 1e-5  # same f32 math, another summation order
LSTM_CUDNN_F32_TOL = 1e-4  # cuDNN's own GEMM order, TF32 off
LSTM_BF16_TOL = 5e-2  # the plain version rounds every gate op and c to bf16, the kernel only h
LSTM_BWD_TOL = 1e-4  # relative to the largest value: f32 carries over 200 steps
# Session paths (phases j, k).
CARRY_TOL = {"gru": GRU_BF16_TOL, "lstm": LSTM_BF16_TOL}  # step-1 carry, bf16 kernels vs plain
# Peak device memory, last group vs first, relative: the caching allocator
# hands out whole cached blocks (up to 1 MB over a request) in another
# pattern from group to group (2.6% on the LSTM session path, H100); a carry
# that kept its graph would add K steps of saved activations, several times
# the first group's peak.
MEM_GROWTH_TOL = 0.1
RESET_EVERY = 6  # a session start about every 6 positions (rsc15 averages ~5 clicks)
NO_RESET_LIBRARY = "none: cuDNN's RNNs take no reset mask"


class CheckFailed(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = REPS, sleep_cycles: int = 2_000_000):
    """Median, min and max ms of `fn` over `reps` runs, by CUDA events, each
    run behind a device sleep (~1 ms by default) so its launches queue up
    first."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ts.append(start.elapsed_time(end))
    ts.sort()
    return {"median": ts[len(ts) // 2], "min": ts[0], "max": ts[-1], "reps": reps}


def bound(bytes_moved: float, flops: float, dtype) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def zipf_items(rng: np.random.Generator, n: int, ranked: bool = False,
               vocab: int = VOCAB) -> np.ndarray:
    """Item ids 1..vocab-1 with Zipf(1.0) popularity over a random ranking,
    or, `ranked`, with id = popularity rank (as the data prep assigns ids,
    and as the log-uniform negative sampler assumes)."""
    ranks = np.arange(1, vocab)
    p = 1.0 / ranks
    p /= p.sum()
    order = ranks if ranked else rng.permutation(ranks)
    return order[rng.choice(vocab - 1, size=n, p=p)]


def _orthogonal_rows(rng: np.random.Generator, G: int, H: int) -> torch.Tensor:
    """[H, G H] f32 on the CPU with orthonormal rows: the QR of G H x H
    normal draws, signs by R's diagonal. Past H = 1,024 (widths no phase
    before w draws) the QR runs on the card in f64: the host's takes ~5 s
    at 2,304."""
    a = rng.normal(size=(G * H, H))
    if H <= 1024:
        q, r = np.linalg.qr(a)
        return torch.from_numpy((q * np.sign(np.diag(r))).T.astype(np.float32))
    q, r = torch.linalg.qr(torch.from_numpy(a).cuda())
    return (q * torch.sign(torch.diagonal(r))).T.float().cpu()


def gru_weights(rng: np.random.Generator, D: int, H: int):
    """w_x [D, 3H] Glorot-uniform, w_h [H, 3H] orthogonal rows, biases
    N(0, 0.1): f32 on the CPU."""
    lim = np.sqrt(6.0 / (D + 3 * H))
    w_x = torch.from_numpy(rng.uniform(-lim, lim, size=(D, 3 * H)).astype(np.float32))
    w_h = _orthogonal_rows(rng, 3, H)
    b_x = torch.from_numpy(rng.normal(scale=0.1, size=3 * H).astype(np.float32))
    b_h = torch.from_numpy(rng.normal(scale=0.1, size=3 * H).astype(np.float32))
    return w_x, w_h, b_x, b_h


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest difference over the largest magnitude of `b`."""
    return max_err(a, b) / max(b.float().abs().max().item(), 1e-30)


def phase_device() -> tuple:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi, name


# The bf16 Dh-cluster attention's descriptor control (kernel_probes_attention.cu,
# never in the package): compiled beside the package's sources in phase_build,
# loaded and run in phase w, where it must fail its check (loaded there, not
# while another phase's torch.profiler may trace: a run that loaded it from
# the build's thread found phase e's trace empty).
_ATTN_CONTROL: dict = {}


def _build_attention_control() -> None:
    try:
        import kernel_probes

        _ATTN_CONTROL["path"] = kernel_probes.probe_build(kernel_probes.ATTENTION_CONTROL)[0]
    except Exception as e:  # reported where phase w reads it
        _ATTN_CONTROL["error"] = f"{type(e).__name__}: {e}"


def phase_build() -> None:
    t0 = time.perf_counter()
    control = threading.Thread(target=_build_attention_control, daemon=True)
    control.start()
    _ATTN_CONTROL["thread"] = control
    logs = _build.build()
    for name in _build.SOURCES:
        _build.load(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": sorted(logs), "ptxas": ptxas_summary(logs)})


def _kernel_name(demangled: str) -> str:
    """`void ns::kernel<(int)8, (bool)0>(float const*, ...)` without its
    return type and parameter list."""
    name, depth = demangled.removeprefix("void "), 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i]
    return name


# Kernels whose registers and spills the build phase always reports,
# spilling or not: the newest designs, every instantiation (the f32 head,
# the deterministic scatter-add's two kernels, the f32 projection's SIMT
# GEMM and the f32 FMA GEMM of the wide f32 projections and the stepped
# layouts; the sliced attention, the stepped
# layouts' gate kernels and the bf16 head's K split with its streamed
# variant; the stepped layouts' step GEMM and the bf16 input projection,
# both on wgmma; the attention's cluster layout).
WATCH = ("head_f32_kernel", "scatter_partials_kernel", "scatter_combine_kernel",
         "xproj_f32_kernel", "fma_gemm_kernel", "attention_sliced", "gru_step", "lstm_step",
         "head_mma_ksplit_kernel", "step_gemm_wgmma_kernel", "xproj_wgmma_kernel",
         "attention_cluster")


def _demangled(kernels: dict) -> dict:
    """{mangled: record} -> {demangled: record} (cu++filt where the toolkit
    has it)."""
    filt = Path(_build.find_nvcc()).parent / "cu++filt"
    if not kernels or not filt.exists():
        return kernels
    names = subprocess.run([str(filt)], input="\n".join(kernels), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    return {_kernel_name(d): k for d, k in zip(names, kernels.values())}


def ptxas_summary(logs) -> dict:
    """Per source, from nvcc's `-Xptxas -v` log: its kernels, the most
    registers one uses, each kernel that spills with its registers and spill
    bytes, and the same record of every instantiation of the WATCH kernels
    (names demangled by cu++filt where the toolkit has it)."""
    out = {}
    for src, log in logs.items():
        kernels, name = {}, None
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                name = entry.group(1)
                kernels[name] = {"registers": 0, "stack": 0, "spill_stores": 0,
                                 "spill_loads": 0}
            elif name is not None:
                spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                  r"(\d+) bytes spill loads", line)
                used = re.search(r"Used (\d+) registers", line)
                if spill:
                    kernels[name].update(stack=int(spill.group(1)),
                                         spill_stores=int(spill.group(2)),
                                         spill_loads=int(spill.group(3)))
                elif used:
                    kernels[name]["registers"] = int(used.group(1))
        spills = {n: k for n, k in kernels.items() if k["spill_stores"] or k["spill_loads"]}
        watched = {n: k for n, k in kernels.items() if any(w in n for w in WATCH)}
        out[src] = {"kernels": len(kernels),
                    "max_registers": max((k["registers"] for k in kernels.values()), default=0),
                    "spills": _demangled(spills), "new_designs": _demangled(watched)}
    return out


def _dname(dtype) -> str:
    return str(dtype).split(".")[-1]


def _gru_forward_check(dev, x32, weights, h32, dtype, reset=None, twice: bool = False,
                       reps: int = REPS) -> dict:
    """The GRU forward kernel against its plain version in `dtype`. Without
    `reset`, also against torch.nn.GRU (the library yardstick). With a [B, T]
    `reset` plane, the reset variant: also bit-exact against the no-reset
    kernel on an all-zero plane, and blind to h0 with a reset at t=0.
    `twice`: a second launch gives the same bits."""
    B, T, D = x32.shape
    H = h32.shape[-1]
    name = f"gru {_dname(dtype)} {B}x{T}x{D}" + ("" if reset is None else " reset")
    x, h0 = x32.to(dtype), h32.to(dtype)
    args = (x, h0, *weights)
    ys, h_last = k_gru.gru_scan(*args, reset_mask=reset)
    torch.cuda.synchronize()
    if twice:
        check(torch.equal(ys, k_gru.gru_scan(*args, reset_mask=reset)[0]),
              f"{name}: two launches differ")
    ys_plain, _ = k_gru.plain(*args, reset_mask=reset)
    tol = GRU_F32_TOL if dtype == torch.float32 else GRU_BF16_TOL
    err = max_err(ys, ys_plain)
    check(bool(torch.isfinite(ys).all()), f"{name}: non-finite output")
    check(torch.equal(h_last, ys[:, -1]), f"{name}: h_last is not ys[:, -1]")
    check(err <= tol, f"{name}: kernel vs plain max abs err {err} > {tol}")
    es = x.element_size()
    r_bytes = (B * T * D + B * H + (D + H) * 3 * H + B * T * H) * es + 2 * 3 * H * 4
    launch = k_gru.padded_launch_config(B, T, D, H, dtype)
    rec = {"shape": {"B": B, "T": T, "D": D, "H": H, "dtype": _dname(dtype)},
           "launch": launch, "design": launch["design"],
           "max_abs_err": err, "tolerance": tol, **({"twice_bit_for_bit": True} if twice else {})}
    if reset is None:
        w_x, w_h, b_x, b_h = weights
        lib = torch.nn.GRU(D, H, batch_first=True, device=dev, dtype=dtype)
        with torch.no_grad():
            lib.weight_ih_l0.copy_(w_x.T)
            lib.weight_hh_l0.copy_(w_h.T)
            lib.bias_ih_l0.copy_(b_x)
            lib.bias_hh_l0.copy_(b_h)
            ys_lib, _ = lib(x, h0[None])
            lib_ms = time_ms(lambda: lib(x, h0[None]), reps=reps)
        lib_err = max_err(ys, ys_lib)
        lib_tol = GRU_CUDNN_F32_TOL if dtype == torch.float32 else GRU_BF16_TOL
        check(lib_err <= lib_tol, f"{name}: kernel vs torch.nn.GRU max abs err {lib_err} > "
                                  f"{lib_tol}")
        rec.update(max_abs_err_vs_nn_gru=lib_err, tolerance_vs_nn_gru=lib_tol,
                   library_ms=lib_ms)
    else:
        r_bytes += B * T * 4  # the keep plane
        check(torch.equal(k_gru.gru_scan(*args, reset_mask=torch.zeros_like(reset))[0],
                          k_gru.gru_scan(*args)[0]),
              f"{name}: an all-zero reset plane is not the no-reset kernel's bits")
        at0 = reset.clone()
        at0[:, 0] = 1.0
        check(torch.equal(k_gru.gru_scan(*args, reset_mask=at0)[0],
                          k_gru.gru_scan(x, -h0, *weights, reset_mask=at0)[0]),
              f"{name}: with a reset at t=0 the output depends on h0")
        rec.update(resets=int(reset.sum().item()), zero_plane_bit_exact=True,
                   reset_at_t0_ignores_h0=True, library_ms=None, library=NO_RESET_LIBRARY)
    r_flops = 2 * B * T * (D + H) * 3 * H
    r_bound, r_by = bound(r_bytes, r_flops, dtype)
    rec.update({
        "kernel_ms": time_ms(lambda: k_gru.gru_scan(*args, reset_mask=reset), reps=reps),
        "plain_ms": time_ms(lambda: k_gru.plain(*args, reset_mask=reset), reps=5),
        "bound_ms": r_bound, "bound_by": r_by, "bytes": int(r_bytes),
        "flops": int(r_flops), "serial_steps": T,
    })
    return rec


def _gather_key(D: int, shape: tuple, dtype) -> str:
    return f"{_dname(dtype)}_D{D}_{'x'.join(map(str, shape))}"


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _gather_check(rng, dev, D: int, shape: tuple, dtype) -> dict:
    """The gather from a [VOCAB, D] f32 table at Zipf ids of `shape` into
    `dtype`, five of them planted out of range: bit for bit against the
    plain version with `dtype` (the NaN rows' words included) and equal,
    NaN for NaN, to the plain gather cast with `.to(dtype)`; with kernel,
    plain, library (F.embedding, then .to(dtype): two calls, on the
    in-range copy of the ids) and bound times. The bound counts the
    distinct rows read once in f32, the ids, and the output in `dtype`."""
    table = torch.from_numpy(rng.normal(scale=D ** -0.5, size=(VOCAB, D))
                             .astype(np.float32)).to(dev)
    n = int(np.prod(shape))
    ids_np = zipf_items(rng, n).astype(np.int32)
    ids_ok = torch.from_numpy(ids_np.reshape(shape).copy()).to(dev)
    ids_np[:5] = [-1, -VOCAB, VOCAB, -VOCAB - 1, 10 ** 6]
    ids = torch.from_numpy(ids_np.reshape(shape)).to(dev)
    name = f"gather {_gather_key(D, shape, dtype)}"
    got = k_gather.embedding_gather(table, ids, dtype=dtype)
    torch.cuda.synchronize()
    check(got.dtype == dtype and tuple(got.shape) == (*shape, D), f"{name}: {got.dtype}")
    check(torch.equal(_bits(got), _bits(k_gather.plain(table, ids, dtype=dtype))),
          f"{name}: not bit-exact against its plain version")
    cast = k_gather.plain(table, ids).to(dtype)
    check(bool(((got == cast) | (torch.isnan(got) & torch.isnan(cast))).all()),
          f"{name}: not the plain gather cast with .to")
    flat = got.reshape(n, D)
    check(bool(torch.isnan(flat[2:5]).all()) and not bool(torch.isnan(flat[:2]).any()),
          f"{name}: planted ids do not wrap / NaN as jnp.take does")
    valid = ids_np[(ids_np >= -VOCAB) & (ids_np < VOCAB)] % VOCAB
    g_bytes = np.unique(valid).size * D * 4 + n * 4 + n * D * (2 if dtype == torch.bfloat16 else 4)
    g_bound, g_by = bound(g_bytes, 0, torch.float32)
    return {
        "shape": {"table": [VOCAB, D], "table_dtype": "float32", "ids": list(shape),
                  "dtype": _dname(dtype)},
        "design": "4-rows-in-flight", "max_abs_err": 0.0, "bit_exact": True,
        "kernel_ms": time_ms(lambda: k_gather.embedding_gather(table, ids, dtype=dtype)),
        "plain_ms": time_ms(lambda: k_gather.plain(table, ids, dtype=dtype)),
        "library_ms": time_ms(lambda: torch.nn.functional.embedding(ids_ok, table).to(dtype)),
        "library": "F.embedding, then .to(dtype)",
        "bound_ms": g_bound, "bound_by": g_by, "bytes": int(g_bytes),
    }


def phase_kernels(rng: np.random.Generator, dev) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    D = H = 128
    T = 200
    out = {}

    # --- gather ------------------------------------------------------------
    # Into the compute dtype, at serving's [64, 200] ids, training's
    # [128, 200] and the 256 negatives, D=64 (the fit loop's) and D=128.
    out["gather"] = {}
    for D_ in GATHER_WIDTHS:
        for shape in GATHER_SHAPES:
            for dtype in (torch.bfloat16, torch.float32):
                rec = _gather_check(rng, dev, D_, shape, dtype)
                out["gather"][_gather_key(D_, shape, dtype)] = rec
    table = torch.from_numpy(
        rng.normal(scale=D ** -0.5, size=(VOCAB, D)).astype(np.float32)).to(dev)
    ids_ok = torch.from_numpy(zipf_items(rng, B * T).reshape(B, T).astype(np.int32)).to(dev)

    # --- GRU scan ------------------------------------------------------------
    weights = [w.to(dev) for w in gru_weights(rng, D, H)]
    x32 = k_gather.plain(table, ids_ok)  # the embeddings serving feeds in
    h32 = torch.zeros(B, H, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        out[f"gru_scan_{_dname(dtype)}"] = _gru_forward_check(dev, x32, weights, h32, dtype)
    # The training path's shape (B=128): the same checks and times.
    ids_t = torch.from_numpy(zipf_items(rng, TRAIN_B * T).reshape(TRAIN_B, T)
                             .astype(np.int32)).to(dev)
    x32_t = k_gather.plain(table, ids_t)
    for dtype in (torch.float32, torch.bfloat16):
        out[f"gru_scan_{_dname(dtype)}_B{TRAIN_B}"] = _gru_forward_check(
            dev, x32_t, weights, torch.zeros(TRAIN_B, H, device=dev), dtype)
    # The fit loop's width (bench.py's D=H=64) at the training shape.
    table64 = torch.from_numpy(rng.normal(scale=FIT_D ** -0.5, size=(VOCAB, FIT_D))
                               .astype(np.float32)).to(dev)
    x32_64 = k_gather.plain(table64, ids_t)
    weights64 = [w.to(dev) for w in gru_weights(rng, FIT_D, FIT_D)]
    for dtype in (torch.float32, torch.bfloat16):
        out[f"gru_scan_{_dname(dtype)}_B{TRAIN_B}_D{FIT_D}"] = _gru_forward_check(
            dev, x32_64, weights64, torch.zeros(TRAIN_B, FIT_D, device=dev), dtype)
    out["gru_xproj"] = _xproj_check(k_gru, k_gru.gru_input_projection, x32, weights[0],
                                    weights[2])
    out["xproj_f32"] = _xproj_check(k_gru, k_gru.gru_input_projection, x32, weights[0],
                                    weights[2], torch.float32)
    # The f32 projection at the training paths' shapes too: gru4rec f32's
    # (M = 25,600, N = 384) and lstm f32's (N = 4H = 512).
    out["xproj_f32_B128"] = _xproj_check(k_gru, k_gru.gru_input_projection, x32_t, weights[0],
                                         weights[2], torch.float32)
    w_x4, _, b4 = (w.to(dev) for w in lstm_weights(rng, D, H))
    out["xproj_f32_B128_N512"] = _xproj_check(k_lstm, k_lstm.lstm_input_projection, x32_t,
                                              w_x4, b4, torch.float32)
    emit({"phase": "kernels", **out})
    return out


def _xproj_check(module, project, x32, w_x, b_x, dtype=torch.bfloat16, reps: int = REPS,
                 twice: bool = True) -> dict:
    """A forward's input projection kernel (`project`: x @ W_x + b_x into
    f32, all steps at once) against its module's plain version and the one
    PyTorch call that computes the same function: the bf16 GEMM (the GRU's
    and the LSTM's launch the same one, `k_gru.xproj_config`'s plan) on bf16
    values against torch.addmm(b_x, x, W_x, out_dtype=torch.float32) (bf16
    in, f32 sums and out), or the f32 one against torch.addmm in f32 (TF32
    off), also held against the product in f64. Within XPROJ_TOL absolute
    at D <= 256, XPROJ_WIDE_REL_TOL of the largest value above; `twice`: a
    second launch gives the same bits. The library call is also the
    yardstick (`library_ms`)."""
    B, T, D = x32.shape
    N = w_x.shape[1]
    name = f"{project.__name__} {_dname(dtype)} B={B} T={T} D={D} N={N}"
    x, wx = x32.to(dtype), w_x.to(dtype)
    got = project(x, wx, b_x)
    torch.cuda.synchronize()
    check(got.shape == (B, T, N) and got.dtype == torch.float32,
          f"{name}: {tuple(got.shape)} {got.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    if twice:
        check(torch.equal(got, project(x, wx, b_x)), f"{name}: two launches differ")
    want = module.plain_input_projection(x, wx, b_x)
    x2, xf, wf = x.reshape(B * T, D), x.float().reshape(B * T, D), wx.float()
    if dtype == torch.bfloat16:
        library = lambda: torch.addmm(b_x, x2, wx, out_dtype=torch.float32)  # noqa: E731
        lib_name = "torch.addmm(b, x, w_x, out_dtype=torch.float32): bf16 in, f32 sums and out"
    else:
        library = lambda: torch.addmm(b_x, xf, wf)  # noqa: E731
        lib_name = "torch.addmm f32 (TF32 off)"
    wide = dtype == torch.bfloat16 and D > 256
    scale = want.abs().max().item()
    tol = XPROJ_WIDE_REL_TOL * scale if wide else XPROJ_TOL
    err = max_err(got, want)
    errs = {"vs_plain": err, "vs_library": max_err(got, library().reshape(B, T, N))}
    for k, e in errs.items():
        check(e <= tol, f"{name}: kernel {k} max abs err {e} > {tol}")
    if dtype == torch.float32:
        f64 = (xf.double() @ wf.double() + b_x.double()).reshape(B, T, N)
        errs["vs_f64"] = max_err(got, f64)
        check(errs["vs_f64"] <= XPROJ_TOL,
              f"{name}: kernel vs f64 max abs err {errs['vs_f64']} > {XPROJ_TOL}")
    es = x.element_size()
    p_bytes = (B * T * D + D * N) * es + N * 4 + B * T * N * 4
    p_flops = 2 * B * T * D * N
    p_bound, p_by = bound(p_bytes, p_flops, dtype)
    bf16 = dtype == torch.bfloat16
    # The plan of the shape the kernel runs: the wrappers pad D and N to multiples of 4.
    plan = (k_gru.xproj_config if bf16 else k_gru.xproj_f32_config)(
        B * T, k_gru.padded_width(D), k_gru.padded_width(N))
    return {
        "shape": {"M": B * T, "D": D, "N": N, "dtype": _dname(dtype), "out": "float32"},
        "design": "wgmma" if bf16 else plan["design"],
        "plan": plan,
        "max_abs_err": err, "errors": errs,
        "tolerance": tol, "tolerance_rule": ("1e-5 of the largest value" if wide else
                                             "1e-5 absolute"),
        **({"twice_bit_for_bit": True} if twice else {}),
        "kernel_ms": time_ms(lambda: project(x, wx, b_x), reps=reps),
        "plain_ms": time_ms(lambda: module.plain_input_projection(x, wx, b_x), reps=reps),
        "library_ms": time_ms(library, reps=reps), "library": lib_name,
        "bound_ms": p_bound, "bound_by": p_by, "bytes": int(p_bytes), "flops": int(p_flops),
    }


def _agree(a: dict, b: dict, tol: float) -> tuple:
    """Plain-run recs `b` vs kernel-run recs `a` for one request: scores
    within `tol` position by position, and ids equal wherever the score gap
    exceeds it (a differing id must be a near-tie in both runs)."""
    sa, sb = np.asarray(a["scores"]), np.asarray(b["scores"])
    diff = float(np.abs(sa - sb).max())
    mismatched = 0
    pos_b = {item: j for j, item in enumerate(b["items"])}
    for j, item in enumerate(a["items"]):
        if item == b["items"][j]:
            continue
        mismatched += 1
        if item in pos_b:
            near = abs(sa[j] - sb[pos_b[item]]) <= 2 * tol
        else:
            near = sa[j] <= sb[-1] + 2 * tol
        check(near, f"serve: item {item} at rank {j} differs beyond the tolerance")
    return diff, mismatched


def make_requests(rng: np.random.Generator, max_len: int, n_requests: int = 320,
                  vocab: int = VOCAB) -> list:
    """Zipf-distributed histories of 5..max_len items, one per user."""
    lengths = rng.integers(5, max_len + 1, size=n_requests)
    return [{"user": i, "history": zipf_items(rng, n, vocab=vocab).tolist()}
            for i, n in enumerate(lengths)]


def expected_launches(cfg: RunConfig, training: bool) -> dict:
    """Launches of each kernel per served batch or per training step on the
    path `cfg` describes: one gather per batch (inputs); per step three with
    a sampled loss (inputs, positives, negatives) or one (full softmax),
    each with its scatter-add, and the head kernel only for the sampled
    softmax (BPR-max and the other ranking losses are plain tensor code);
    the tower's kernel once per layer or block (a bf16 GRU or LSTM forward
    with its input projection, an f32 one with the f32 one), and its
    backward per layer, the reset variants on a session-parallel path; a
    bf16 GRU above Hp = 128 counts each again as its cluster layout, and a
    GRU or LSTM of either dtype above H = 256 as its grid layout, up to the
    grid's limit, and past it as the stepped layout; a layer whose D or H is
    not a multiple of 4 counts again as the padded route (its forward; its
    reverse where H is not); a stepped layer launches its dtype's step GEMM
    (bf16 wgmma, f32 FMA) once a step, T a forward and T a reverse;
    attention wider than 256 a head
    counts again as the cluster layout, past 2,048 as the sliced layout; a
    sampled-softmax head wider than 256 counts again as the K split, and
    past its resident rows' limit as the streamed layout."""
    m = cfg.model
    dtype = getattr(torch, m.compute_dtype)
    want = dict.fromkeys(COUNTERS, 0)
    if m.arch == "sasrec":
        want["causal_attention"] = m.num_layers
        dh = m.embed_dim // m.num_heads
        want["causal_attention_cluster"] = m.num_layers * int(
            k_attn.MAX_HEAD_DIM < dh <= k_attn.MAX_CLUSTER_HEAD_DIM)
        want["causal_attention_sliced"] = m.num_layers * int(dh > k_attn.MAX_CLUSTER_HEAD_DIM)
    else:
        variant = "_reset" if training and cfg.data.session_parallel else ""
        want[f"{m.cell_type}_scan{variant}"] = m.num_layers
        if m.compute_dtype == "bfloat16":  # the bf16 forward's input projection
            want[f"{m.cell_type}_xproj"] = m.num_layers
        else:  # the f32 forward's
            want["xproj_f32" if m.cell_type == "gru" else "lstm_xproj_f32"] = m.num_layers
        if training:
            want[f"{m.cell_type}_backward{variant}"] = m.num_layers
        if (m.cell_type == "gru" and m.compute_dtype == "bfloat16"
                and k_gru.WH_REG_LIMIT < 16 * -(-m.hidden // 16) <= k_gru.MAX_HIDDEN):
            want["gru_scan_wide"] = m.num_layers  # the cluster layouts
            want["gru_backward_wide"] = m.num_layers if training else 0
        mod = k_gru if m.cell_type == "gru" else k_lstm
        if m.hidden > mod.MAX_HIDDEN:  # the grid layouts, or past their limit the stepped one
            layout = "grid" if k_gru.padded_width(m.hidden) <= mod.grid_max_hidden(dtype) \
                else "stepped"
            want[f"{m.cell_type}_scan_{layout}"] = m.num_layers
            want[f"{m.cell_type}_backward_{layout}"] = m.num_layers if training else 0
            if layout == "stepped":  # a step GEMM a step
                d = cfg.data
                T = d.max_len if not training or d.session_parallel else max(
                    d.buckets or (d.max_len,))
                gemm = "step_gemm" if m.compute_dtype == "bfloat16" else "step_gemm_f32"
                want[gemm] = m.num_layers * T
                want[f"{gemm}_reverse"] = m.num_layers * T if training else 0
        widths = [m.embed_dim] + [m.hidden] * (m.num_layers - 1)  # each layer's D
        want[f"{m.cell_type}_scan_padded"] = sum(D % 4 != 0 or m.hidden % 4 != 0
                                                 for D in widths)
        want[f"{m.cell_type}_backward_padded"] = m.num_layers * int(
            training and m.hidden % 4 != 0)
    if training:
        lookups = 3 if m.loss in SAMPLED_LOSSES else 1
        head = int(m.loss == "sampled_softmax")
        resident = m.hidden <= k_head.max_hidden(dtype)
        want.update(gather=lookups, gather_backward=lookups, softmax_head=head,
                    softmax_head_ksplit=head * int(k_head.MMA_MAX_H < m.hidden and resident),
                    softmax_head_streamed=head * int(not resident))
    else:
        want["gather"] = 1
    return want


_DRAWN: dict = {}  # the last weights drawn by `drawn_params` and what they were drawn for


def drawn_params(model, seed: int) -> dict:
    """`flax_to_state_dict(random_params(model, seed))` (what init_state
    draws, bit for bit, on one process), kept for the next call on a model
    of the same parameter shapes and seed: a wide table's draw takes
    seconds on the host."""
    key = (seed, tuple((k, tuple(p.shape)) for k, p in model.named_parameters()))
    if _DRAWN.get("key") != key:
        _DRAWN.clear()
        _DRAWN.update(key=key, state=flax_to_state_dict(random_params(model, seed)))
    return _DRAWN["state"]


def phase_serve(dev, seed: int, path: str, requests: list, overrides=(),
                vocab: int = VOCAB, reps: int = REPS) -> dict:
    """`overrides`: config changes for this run, named in its result (the
    f32 path: F32). `vocab`: the catalog's rows (ML-1M's by default)."""
    config = CONFIGS[path]
    cfg = RunConfig.load(config).apply_overrides(list(overrides))
    check(cfg.model.use_pallas, f"{config} must enable the kernels")
    tol = SCORE_TOL[path] if cfg.model.compute_dtype == "bfloat16" else F32_SCORE_TOL
    models = {}
    for use_pallas in (True, False):
        mcfg = cfg.apply_overrides([f"model.use_pallas={str(use_pallas).lower()}"]).model
        m = build_model(mcfg, vocab, device=dev)
        models[use_pallas] = m
    state = drawn_params(models[True], seed)
    for m in models.values():
        m.load_state_dict(state)
        m.eval()
    max_len = cfg.data.max_len
    n_requests = len(requests)
    batches = [requests[i:i + B] for i in range(0, n_requests, B)]

    def serve(model):
        recs, times = [], []
        for batch in batches:
            t0 = time.perf_counter()
            recs += list(infer.recommend(model, batch, k=K, batch_size=B, max_len=max_len))
            times.append((time.perf_counter() - t0) * 1e3)
        return recs, times

    for m in models.values():  # warm caches and the allocator
        list(infer.recommend(m, batches[0], k=K, batch_size=B, max_len=max_len))
    torch.cuda.synchronize()

    zero_counters()
    recs, times = serve(models[True])
    launches = read_counters()
    plain_recs, plain_times = serve(models[False])
    plain_launches = {k: v - launches[k] for k, v in read_counters().items()}

    n_b = len(batches)
    want = {k: v * n_b for k, v in expected_launches(cfg, training=False).items()}
    check(launches == want, f"serve {path}: kernel launches {launches}, expected {want} "
                            f"over {n_b} batches")
    check(all(v == 0 for v in plain_launches.values()),
          f"serve {path}: the plain run launched kernels {plain_launches}")
    check(len(recs) == len(plain_recs) == n_requests, "serve: lost requests")
    max_diff, mismatched = 0.0, 0
    for req, a, b in zip(requests, recs, plain_recs):
        check(a["user"] == req["user"] and b["user"] == req["user"], "serve: order changed")
        for rec in (a, b):
            items = rec["items"]
            check(len(items) == K and len(set(items)) == K, "serve: not k distinct items")
            check(all(0 < i < vocab for i in items), "serve: pad or unknown item")
            check(not set(items) & set(req["history"]), "serve: recommended a seen item")
            s = np.asarray(rec["scores"])
            check(bool(np.isfinite(s).all()) and bool((np.diff(s) <= 0).all()),
                  "serve: scores not finite and descending")
        diff, mis = _agree(a, b, tol)
        check(diff <= tol, f"serve {path}: score diff {diff} > {tol}")
        max_diff, mismatched = max(max_diff, diff), mismatched + mis

    # Where one batch's time goes on the kernel path (after the counted run).
    first = batches[0]
    t0 = time.perf_counter()
    packed = infer._pack([r["history"] for r in first], [r["user"] for r in first], B, max_len)
    pack_ms = (time.perf_counter() - t0) * 1e3
    inputs, mask, users = (torch.from_numpy(a).to(dev) for a in packed)
    fetch_k = min(K + max_len, vocab - 1)
    m = models[True]
    with torch.inference_mode():
        step = {
            "encode_ms": time_ms(lambda: m.encode(inputs, mask), reps=reps)["median"],
            # Behind a ~30 ms sleep, so that the events bracket the device's
            # work even where the host takes longer than ~1 ms to queue the
            # launches (SASRec's encode): the device alone.
            "encode_device_ms": time_ms(lambda: m.encode(inputs, mask),
                                        sleep_cycles=50_000_000, reps=reps)["median"],
            "scores_ms": time_ms(lambda: m.scores(inputs, mask), reps=reps)["median"],
            "topk_step_ms": time_ms(
                lambda: infer.topk_step(m, inputs, mask, users, fetch_k), reps=reps)["median"],
        }
    breakdown = {
        "pack_host_ms": pack_ms, **step,
        # H2D and D2H copies, the sync, history exclusion and Python.
        "rest_host_ms": float(np.median(times)) - pack_ms - step["topk_step_ms"],
    }

    result = {
        "phase": "serve", "config": config, "overrides": list(overrides),
        "compute_dtype": cfg.model.compute_dtype, "vocab": vocab, "requests": n_requests,
        "batch_size": B, "k": K, "batches": n_b,
        "requests_per_s": n_requests / (sum(times) / 1e3),
        "batch_ms_median": float(np.median(times)), "batch_ms_min": min(times),
        "batch_ms_max": max(times),
        "plain_requests_per_s": n_requests / (sum(plain_times) / 1e3),
        "plain_batch_ms_median": float(np.median(plain_times)),
        "launches": launches, "plain_launches": plain_launches,
        "max_score_diff_vs_plain": max_diff, "score_tolerance": tol,
        "rank_swaps_within_tolerance": mismatched,
        "batch_breakdown": breakdown,
    }
    emit(result)
    return result


def _device_ops(fn) -> list:
    """The device operations (kernels, copies, memsets) that one call of
    `fn` runs, by torch.profiler: [name, ...]."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages() for _ in range(e.count)
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]


def _scatter_add_check(rng, dev, table, count_ops: bool = True) -> dict:
    """The deterministic scatter-add at the training shape: Zipf(1.0) ids
    with planted out-of-range ones, two runs bit for bit equal, equal to
    `plain_ordered` (its order in plain tensor code) bit for bit, and within
    the f32 summation bound of the plain version (`index_put_`); with
    `count_ops`, its device operations a call counted by the profiler (at
    most 2); the same on ids padded as the training path pads them (rows of
    5..TRAIN_T positions, the rest on the padding row 0: about half), timed
    beside index_add_."""
    D = table.shape[1]
    N = TRAIN_B * TRAIN_T
    ids_np = zipf_items(rng, N).astype(np.int32)
    ids_ok = torch.from_numpy(ids_np.copy()).to(dev)
    ids_np[:5] = np.array([-1, -VOCAB, VOCAB, -VOCAB - 1, 10 ** 6], np.int32)
    ids = torch.from_numpy(ids_np).to(dev)
    g = torch.from_numpy(rng.normal(scale=1e-2, size=(N, D)).astype(np.float32)).to(dev)
    got = k_gather.embedding_scatter_add(g, ids, VOCAB)
    again = k_gather.embedding_scatter_add(g, ids, VOCAB)
    torch.cuda.synchronize()
    plan = k_gather.check_scatter_add_launchable(g, ids, VOCAB)
    check(torch.equal(got, again), "scatter-add: two runs on the same inputs differ")
    check(torch.equal(got, k_gather.plain_ordered(g, ids, VOCAB, plan["chunk"])),
          "scatter-add kernel is not bit-exact against plain_ordered (its order)")
    want = k_gather.plain_backward(g, ids, VOCAB)
    err = max_err(got, want)
    # index_put_ adds each row's terms in another order: the classic bound
    # for n terms is n * 2^-24 * sum |terms|.
    valid = ids_np[(ids_np >= -VOCAB) & (ids_np < VOCAB)] % VOCAB
    n_max = int(np.bincount(valid, minlength=VOCAB).max())
    tol = n_max * 2.0 ** -24 * k_gather.plain_backward(g.abs(), ids, VOCAB).max().item()
    check(err <= tol, f"scatter-add kernel vs plain max abs err {err} > {tol}")
    ops = (_device_ops(lambda: k_gather.embedding_scatter_add(g, ids, VOCAB))
           if count_ops else None)
    check(ops is None or 0 < len(ops) <= 2, f"scatter-add: {len(ops or ())} device operations "
                                            f"a call (at most 2): {ops}")
    # The training path's padding: each row's positions past its length on row 0.
    pad_np = zipf_items(rng, N).reshape(TRAIN_B, TRAIN_T)
    pad_np[np.arange(TRAIN_T)[None, :] >= rng.integers(5, TRAIN_T + 1, size=(TRAIN_B, 1))] = 0
    pad_np = pad_np.reshape(-1)
    pad_ids = torch.from_numpy(pad_np).to(dev)
    got_pad = k_gather.embedding_scatter_add(g, pad_ids, VOCAB)
    torch.cuda.synchronize()
    check(torch.equal(got_pad, k_gather.embedding_scatter_add(g, pad_ids, VOCAB)),
          "scatter-add: two runs on padded ids differ")
    check(torch.equal(got_pad, k_gather.plain_ordered(g, pad_ids, VOCAB, plan["chunk"])),
          "scatter-add kernel is not bit-exact against plain_ordered on padded ids")
    s_bytes = N * D * 4 + N * 4 + VOCAB * D * 4
    s_bound, s_by = bound(s_bytes, 0, torch.float32)
    ids_long = ids_ok.long()
    # A bf16 cotangent (the bf16 paths' gather output's), on the padded ids
    # as training pads them: widened by the kernel's loads, so bit for bit
    # the call on its f32 widening and plain_ordered on it.
    g16 = g.bfloat16()
    got16 = k_gather.embedding_scatter_add(g16, pad_ids, VOCAB)
    torch.cuda.synchronize()
    check(torch.equal(got16, k_gather.embedding_scatter_add(g16, pad_ids, VOCAB)),
          "scatter-add: two runs on a bf16 cotangent differ")
    check(torch.equal(got16, k_gather.embedding_scatter_add(g16.float(), pad_ids, VOCAB)),
          "scatter-add: a bf16 cotangent is not its f32 widening's bits")
    check(torch.equal(got16, k_gather.plain_ordered(g16.float(), pad_ids, VOCAB,
                                                    plan["chunk"])),
          "scatter-add: a bf16 cotangent is not plain_ordered's bits")
    ops16 = (_device_ops(lambda: k_gather.embedding_scatter_add(g16, pad_ids, VOCAB))
             if count_ops else None)
    check(ops16 is None or 0 < len(ops16) <= 2,
          f"scatter-add bf16: {len(ops16 or ())} device operations a call: {ops16}")
    s16_bytes = N * D * 2 + N * 4 + VOCAB * D * 4
    s16_bound, s16_by = bound(s16_bytes, 0, torch.float32)
    return {
        "shape": {"table": [VOCAB, D], "ids": [TRAIN_B, TRAIN_T], "dtype": "float32"},
        "design": "sorted-chunks", "deterministic": True, "bit_exact_twice": True,
        "bit_exact_vs_plain_ordered": True, "plan": plan,
        "launches_per_call": None if ops is None else len(ops), "device_ops_per_call": ops,
        "max_abs_err": err, "tolerance": tol, "max_ids_per_row": n_max,
        "kernel_ms": time_ms(lambda: k_gather.embedding_scatter_add(g, ids, VOCAB)),
        "plain_ms": time_ms(lambda: k_gather.plain_backward(g, ids, VOCAB)),
        # index_add_ errors on out-of-range ids: timed on the in-range copy.
        "library_ms": time_ms(lambda: torch.zeros(VOCAB, D, device=dev)
                              .index_add_(0, ids_long, g)),
        "bound_ms": s_bound, "bound_by": s_by, "bytes": int(s_bytes),
        "bf16_cotangent": {
            "shape": {"table": [VOCAB, D], "ids": [TRAIN_B, TRAIN_T], "g_dtype": "bfloat16",
                      "padded": True},
            "design": "sorted-chunks", "deterministic": True, "bit_exact_twice": True,
            "bit_exact_vs_f32_widening": True, "bit_exact_vs_plain_ordered": True,
            "launches_per_call": None if ops16 is None else len(ops16),
            "device_ops_per_call": ops16,
            "max_abs_err": 0.0,
            "kernel_ms": time_ms(lambda: k_gather.embedding_scatter_add(g16, pad_ids, VOCAB)),
            "widen_then_kernel_ms": time_ms(
                lambda: k_gather.embedding_scatter_add(g16.float(), pad_ids, VOCAB)),
            "plain_ms": time_ms(lambda: k_gather.plain_backward(g16, pad_ids, VOCAB)),
            "library_ms": time_ms(lambda: torch.zeros(VOCAB, D, device=dev)
                                  .index_add_(0, pad_ids, g16.float())),
            "library": "index_add_ on the f32 widening (it takes no bf16 source into f32)",
            "bound_ms": s16_bound, "bound_by": s16_by, "bytes": int(s16_bytes),
        },
        "padded": {
            "padding_share": float(np.mean(pad_np == 0)),
            "max_ids_per_row": int(np.bincount(pad_np, minlength=VOCAB).max()),
            "bit_exact_twice": True, "bit_exact_vs_plain_ordered": True,
            "kernel_ms": time_ms(lambda: k_gather.embedding_scatter_add(g, pad_ids, VOCAB)),
            "library_ms": time_ms(lambda: torch.zeros(VOCAB, D, device=dev)
                                  .index_add_(0, pad_ids, g)),
        },
    }


def _state(rng, dev, B: int, H: int) -> torch.Tensor:
    """[B, H] f32 N(0, 0.5): a carried-in recurrent state."""
    return torch.from_numpy(rng.normal(scale=0.5, size=(B, H)).astype(np.float32)).to(dev)


def _leaf_grads(scan, leaves, rest, reset, g):
    """Gradients of sum(ys * g) w.r.t. `leaves`, through `scan`."""
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    ys = scan(*leaves, *rest, reset_mask=reset)[0]
    ys.backward(g)
    return [t.grad for t in leaves]


def _gru_backward_checks(rng, dev, x32, reset=None,
                         dtypes=(torch.bfloat16, torch.float32), twice: bool = False,
                         H: Optional[int] = None, reps: int = REPS) -> dict:
    """The GRU reverse recurrence against its plain version in `dtypes`, on
    the projections of a kernel forward (the bf16 kernel recomputes the
    gates from them), and the whole backward through autograd
    (forward and backward kernels). Without `reset` (h0 = 0), also the cuDNN
    yardstick. With a [B, T] `reset` plane (and a random h0), the keep
    variant: also bit-exact against the no-keep kernel on an all-ones plane,
    and dh0 = 0 under a reset at t=0. `twice`: a second launch gives the
    same bits. `H`: the hidden width (D by default)."""
    B, T, D = x32.shape
    H = D if H is None else H
    w_x, w_h, b_x, b_h = (w.to(dev) for w in gru_weights(rng, D, H))
    g32 = torch.from_numpy(rng.normal(scale=1e-2, size=(B, T, H)).astype(np.float32)).to(dev)
    h32 = torch.zeros(B, H, device=dev) if reset is None else _state(rng, dev, B, H)
    out = {}
    for dtype in dtypes:
        name = f"gru backward {_dname(dtype)} {B}x{T}x{H}" + ("" if reset is None else " keep")
        x, g, h0 = x32.to(dtype), g32.to(dtype), h32.to(dtype)
        wx_c, wh_c = w_x.to(dtype), w_h.to(dtype)
        with torch.no_grad():
            ys, _ = k_gru.gru_scan(x, h0, wx_c, wh_c, b_x, b_h, reset_mask=reset)
            x_proj = torch.matmul(x.float(), wx_c.float()) + b_x
            h_in, keep, h_proj = reference.gru_bwd_project(x_proj, ys, h0, wh_c, b_h, reset)
        planes = (x_proj, h_proj, h_in, g, wh_c)
        got_b = k_gru.gru_backward(*planes, keep)
        torch.cuda.synchronize()
        if twice:
            check(all(torch.equal(a, b) for a, b in zip(got_b, k_gru.gru_backward(*planes, keep))),
                  f"{name}: two launches differ")
        want_b = k_gru.plain_backward(*planes, keep)
        errs = {k: rel_err(a, b) for k, a, b in zip(("d_xp", "dh0", "dn_r"), got_b, want_b)}
        for k, e in errs.items():
            check(e <= GRU_BWD_TOL, f"{name}: {k} kernel vs plain relative err {e} > "
                                    f"{GRU_BWD_TOL}")
        if keep is not None:
            check(all(torch.equal(a, b) for a, b in zip(
                k_gru.gru_backward(*planes, torch.ones_like(keep)), k_gru.gru_backward(*planes))),
                f"{name}: an all-ones keep plane is not the no-keep kernel's bits")
            keep0 = keep.clone()
            keep0[:, 0] = 0.0
            check(not bool(k_gru.gru_backward(*planes, keep0)[1].any()),
                  f"{name}: dh0 is not 0 with a reset at t=0")
        got = _leaf_grads(k_gru.gru_scan, (x, h0, w_x, w_h), (b_x, b_h), reset, g)
        if dtype == torch.bfloat16:
            # Against reference.gru_bwd_math (the plain reverse loop), every
            # gradient rounded to bf16 as the autograd path does.
            want_dxp, want_dh0, want_dwh, _ = reference.gru_bwd_math(
                x_proj, ys, h0, wh_c, b_h, g, reset)
            want = [t.to(dtype) for t in (
                torch.matmul(want_dxp, wx_c.float().T), want_dh0,
                torch.einsum("btd,btk->dk", x.float(), want_dxp), want_dwh)]
            w_tol = GRU_BWD_BF16_W_TOL
        else:
            # Against autograd through the plain scan's own torch ops.
            want = _leaf_grads(k_gru.plain, (x, h0, w_x, w_h), (b_x, b_h), reset, g)
            w_tol = GRU_BWD_TOL
        w_errs = {k: rel_err(a, b) for k, a, b in zip(("d_x", "dh0", "dW_x", "dW_h"), got, want)}
        for k, e in w_errs.items():
            check(e <= w_tol, f"{name}: {k} through autograd relative err {e} > {w_tol}")
        # bf16 weights: the tensor-core design, h_in in its own dtype (x's, or
        # f32 with a keep plane) and g_ys in bf16; f32 weights: CUDA cores, f32.
        # In: the two projections, h_in, g_ys, W_h (and keep); out: d_xp,
        # dn_r, dh0.
        launch = k_gru.padded_backward_launch_config(B, T, H, wh_c.dtype, h_in_dtype=h_in.dtype)
        mma = wh_c.dtype == torch.bfloat16  # the tensor cores: mma.sync, or wgmma (stepped)
        hs, gs, ws = h_in.element_size(), 2 if mma else 4, wh_c.element_size()
        b_bytes = (2 * B * T * 3 * H * 4 + B * T * H * (hs + gs) + 3 * H * H * ws
                   + B * T * 3 * H * 4 + B * T * H * 4 + B * H * 4
                   + (0 if keep is None else B * T * 4))
        b_flops = 2 * B * T * 3 * H * H
        if mma:
            # d_hproj goes to the tensor cores as bf16 terms: their products.
            b_bound, b_by = bound(b_bytes, launch["d_terms"] * b_flops, torch.bfloat16)
        else:
            b_bound, b_by = bound(b_bytes, b_flops, torch.float32)
        out[_dname(dtype)] = {
            "shape": {"B": B, "T": T, "H": H, "dtype": _dname(dtype),
                      "h_in_dtype": _dname(h_in.dtype)},
            "launch": launch, "design": launch["design"],
            **({"twice_bit_for_bit": True} if twice else {}),
            "rel_err": errs, "tolerance": GRU_BWD_TOL,
            "autograd_rel_err": w_errs, "autograd_tolerance": w_tol,
            "max_abs_err": max(max_err(a, b) for a, b in zip(got_b, want_b)),
            "kernel_ms": time_ms(lambda: k_gru.gru_backward(*planes, keep), reps=reps),
            "plain_ms": time_ms(lambda: k_gru.plain_backward(*planes, keep), reps=5),
            "bound_ms": b_bound, "bound_by": b_by, "bytes": int(b_bytes),
            "flops": int(b_flops), "serial_steps": T,
        }
        if keep is not None:
            out[_dname(dtype)].update(ones_plane_bit_exact=True, dh0_zero_with_reset_at_t0=True,
                                      library_ms=None, library=NO_RESET_LIBRARY)
    if reset is not None:
        return out
    # Library yardstick: cuDNN's GRU backward in each record's dtype (TF32
    # off), timed as (forward + backward) - forward. The port never calls it.
    for dname, rec in out.items():
        dtype = getattr(torch, dname)
        lib = torch.nn.GRU(D, H, batch_first=True, device=dev, dtype=dtype)
        with torch.no_grad():
            lib.weight_ih_l0.copy_(w_x.T)
            lib.weight_hh_l0.copy_(w_h.T)
            lib.bias_ih_l0.copy_(b_x)
            lib.bias_hh_l0.copy_(b_h)
        xg = x32.to(dtype).detach().clone().requires_grad_(True)
        h0f = torch.zeros(1, B, H, device=dev, dtype=dtype)
        gd = g32.to(dtype)
        fb = time_ms(lambda: lib(xg, h0f)[0].backward(gd), reps=reps)
        fw = time_ms(lambda: lib(xg, h0f)[0], reps=reps)
        rec["library_ms"] = {"median": fb["median"] - fw["median"], "fwd_bwd": fb, "fwd": fw,
                             "what": f"torch.nn.GRU {dname} (cuDNN), backward = fwd+bwd - fwd"}
    return out


def _head_inputs(rng, dev, table, N: int, S: int):
    """Zipf targets, S log-uniform negatives (two planted accidental hits
    beside the natural ones), their logQ, tanh'd h and the table's rows."""
    targets = torch.from_numpy(zipf_items(rng, N).astype(np.int32)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(2 ** 31)))
    neg_ids, nlq = sample_log_uniform(gen, S, VOCAB)
    neg_ids[:2] = targets[:2]
    nlq = log_uniform_log_prob(neg_ids, VOCAB)
    plq = log_uniform_log_prob(targets, VOCAB)
    h32 = torch.tanh(torch.from_numpy(rng.normal(size=(N, table.shape[1]))
                                      .astype(np.float32))).to(dev)
    return h32, table[targets.long()], table[neg_ids.long()], targets, neg_ids, plq, nlq


def _head_bound(N: int, S: int, D: int, dtype) -> tuple:
    es = 2 if dtype == torch.bfloat16 else 4
    h_bytes = (2 * N * D + S * D) * es + N * 4 * 3 + S * 4 * 2
    return (*bound(h_bytes, 2 * N * S * D + 2 * N * D, dtype), h_bytes)


def _head_checks(rng, dev, table, beauty: bool = True, N: int = TRAIN_B * TRAIN_T,
                 S: int = NUM_NEG, dtypes=(torch.bfloat16, torch.float32),
                 twice: bool = False, reps: int = REPS) -> dict:
    D = table.shape[1]
    h32, pos32, neg32, targets, neg_ids, plq, nlq = _head_inputs(rng, dev, table, N, S)
    w = torch.ones(N, device=dev)
    hits = int((neg_ids[None, :] == targets[:, None]).sum())
    out = {}
    for dtype in dtypes:
        name = str(dtype).split(".")[-1]
        label = f"head {name} N={N} S={S}"
        args = (h32.to(dtype), pos32.to(dtype), neg32.to(dtype), targets, neg_ids, plq, nlq)
        got = k_head.sampled_softmax_nll(*args)
        torch.cuda.synchronize()
        if twice:
            check(torch.equal(got, k_head.sampled_softmax_nll(*args)),
                  f"{label}: two launches differ")
        want = k_head.plain(*args)
        err = max_err(got, want)
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite nll")
        check(err <= HEAD_TOL, f"{label}: kernel vs plain max abs err {err} > {HEAD_TOL}")
        # Loss and gradients, kernel forward + recompute backward, against
        # autograd through the plain loss (the JAX package's XLA formula).
        res = []
        for fn in (k_head.sampled_softmax_loss, reference.sampled_softmax_loss):
            leaves = [a.detach().clone().requires_grad_(True) for a in args[:3]]
            loss, _ = fn(*leaves, targets, neg_ids, w, pos_log_q=plq, neg_log_q=nlq)
            loss.backward()
            res.append([loss.detach()] + [a.grad for a in leaves])
        tol = HEAD_LOSS_BF16_TOL if dtype == torch.bfloat16 else GRU_BWD_TOL
        loss_rel = abs(res[0][0].item() - res[1][0].item()) / abs(res[1][0].item())
        grad_rel = {k: rel_err(a, b) for k, a, b in zip(("dh", "dpos", "dneg"),
                                                        res[0][1:], res[1][1:])}
        check(loss_rel <= tol, f"{label}: loss relative err {loss_rel} > {tol}")
        for k, e in grad_rel.items():
            check(e <= 2 * tol, f"{label}: {k} relative err {e} > {2 * tol}")
        h_bound, h_by, h_bytes = _head_bound(N, S, D, dtype)
        hb, nb = args[0], args[2]
        launch = k_head.launch_config(N, S, D, dtype)
        g = torch.ones(N, device=dev)
        out[name] = {
            "shape": {"N": N, "S": S, "H": D, "dtype": name, "accidental_hits": hits},
            "launch": launch, "design": launch["design"],
            **({"twice_bit_for_bit": True} if twice else {}),
            "max_abs_err": err, "tolerance": HEAD_TOL,
            # The backward, the JAX package's recompute in plain tensor code
            # (no kernel here or there): its device time beside the forward's.
            "backward_recompute_ms": time_ms(
                lambda: reference.sampled_softmax_nll_bwd(g, *args), reps=reps),
            "loss_rel_err": loss_rel, "grad_rel_err": grad_rel, "loss_tolerance": tol,
            "kernel_ms": time_ms(lambda: k_head.sampled_softmax_nll(*args), reps=reps),
            "plain_ms": time_ms(lambda: k_head.plain(*args), reps=reps),
            # No single PyTorch call computes this function; h @ neg.T alone
            # (in this dtype; f32 with TF32 off) is the yardstick of its GEMM.
            "library_ms": None,
            "partial_yardstick_matmul_ms": time_ms(lambda: hb @ nb.T, reps=reps),
            "bound_ms": h_bound, "bound_by": h_by, "bytes": int(h_bytes),
            "flops": int(2 * N * S * D + 2 * N * D),
        }
        out[name]["kernel_over_matmul"] = (out[name]["kernel_ms"]["median"]
                                           / out[name]["partial_yardstick_matmul_ms"]["median"])
    if not beauty:
        return out
    # The f32 head at beauty's and steam's step (configs/beauty_gru.json:
    # B=128, T=50, D=H=256, 256 negatives), which the first f32 design
    # refused.
    Nb, Sb, Db = TRAIN_B * 50, NUM_NEG, 256
    wide = torch.from_numpy(rng.normal(scale=Db ** -0.5, size=(VOCAB, Db))
                            .astype(np.float32)).to(dev)
    args = _head_inputs(rng, dev, wide, Nb, Sb)
    got = k_head.sampled_softmax_nll(*args)
    torch.cuda.synchronize()
    err = max_err(got, k_head.plain(*args))
    check(bool(torch.isfinite(got).all()), "head float32 beauty: non-finite nll")
    check(err <= HEAD_TOL, f"head float32 beauty: kernel vs plain max abs err {err} > "
                           f"{HEAD_TOL}")
    b_bound, b_by, b_bytes = _head_bound(Nb, Sb, Db, torch.float32)
    launch = k_head.launch_config(Nb, Sb, Db, torch.float32)
    hb, nb = args[0], args[2]
    out["float32_beauty"] = {
        "shape": {"N": Nb, "S": Sb, "H": Db, "dtype": "float32"},
        "launch": launch, "design": launch["design"], "max_abs_err": err,
        "tolerance": HEAD_TOL,
        "kernel_ms": time_ms(lambda: k_head.sampled_softmax_nll(*args), reps=reps),
        "plain_ms": time_ms(lambda: k_head.plain(*args), reps=reps),
        "partial_yardstick_matmul_ms": time_ms(lambda: hb @ nb.T, reps=reps),
        "bound_ms": b_bound, "bound_by": b_by, "bytes": int(b_bytes),
    }
    return out


def phase_train_kernels(rng: np.random.Generator, dev) -> dict:
    D = 128
    table = torch.from_numpy(
        rng.normal(scale=D ** -0.5, size=(VOCAB, D)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(zipf_items(rng, TRAIN_B * TRAIN_T).astype(np.int32)).to(dev)
    x32 = k_gather.plain(table, ids.reshape(TRAIN_B, TRAIN_T))
    # The fit loop's width (D=H=64): the GRU reverse recurrence and the head.
    table64 = torch.from_numpy(rng.normal(scale=FIT_D ** -0.5, size=(VOCAB, FIT_D))
                               .astype(np.float32)).to(dev)
    x32_64 = k_gather.plain(table64, ids.reshape(TRAIN_B, TRAIN_T))
    out = {"gather_backward": _scatter_add_check(rng, dev, table),
           "gru_backward": _gru_backward_checks(rng, dev, x32),
           "softmax_head": _head_checks(rng, dev, table),
           f"gru_backward_D{FIT_D}": _gru_backward_checks(rng, dev, x32_64),
           f"softmax_head_D{FIT_D}": _head_checks(rng, dev, table64, beauty=False)}
    emit({"phase": "train_kernels", **out})
    return out


def _sdpa_backend(q, k, v) -> str:
    """The backend F.scaled_dot_product_attention picks for these [B, N, T,
    Dh] inputs, causal, with no mask and no dropout (torch's own choice
    function)."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, None, 0.0, True)).name


def _attention_checks(rng, dev, Dh: int = 64, sliced: bool = False, Bq: int = TRAIN_B,
                      twice: bool = False, reps: int = REPS) -> dict:
    """Causal attention at SASRec's training shape (ml1m_sasrec: B=128,
    T=200, one head of Dh=64): q, k, v of unit scale, as a LayerNorm'd
    input through the qkv projection gives them. `sliced`: q, k and v are
    the SASRec block's slices of one [B, T, 3, 1, Dh] projection (rows 3 Dh
    apart), read in place as the model's path reads them. `Bq`: the batch
    (at least B); `twice`: a second launch gives the same bits. Where SDPA
    takes its math backend in bf16 (past its fused kernels' head dims), it
    rounds its scores to bf16 as the plain version does, and is held to the
    plain version's limit."""
    T, N = TRAIN_T, 1
    if sliced:
        proj = torch.from_numpy(rng.normal(size=(Bq, T, 3, N, Dh)).astype(np.float32)).to(dev)
    else:
        qkv32 = [torch.from_numpy(rng.normal(size=(Bq, T, N, Dh)).astype(np.float32)).to(dev)
                 for _ in range(3)]
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = _dname(dtype)
        if sliced:
            q, k, v = proj.to(dtype).unbind(2)
            check(k_attn._kernel_view(q).data_ptr() == q.data_ptr(),
                  f"attention {name} Dh={Dh}: the projection's slices are not read in place")
        else:
            q, k, v = (t.to(dtype) for t in qkv32)
        got = k_attn.causal_attention(q, k, v)
        torch.cuda.synchronize()
        if twice:
            check(torch.equal(got, k_attn.causal_attention(q, k, v)),
                  f"attention {name} Dh={Dh}: two launches differ")
        want = k_attn.plain(q, k, v)
        err = max_err(got, want)
        check(bool(torch.isfinite(got).all()), f"attention {name}: non-finite output")
        tol = ATTN_F32_TOL if dtype == torch.float32 else ATTN_BF16_TOL
        check(err <= tol, f"attention {name}: kernel vs plain max abs err {err} > {tol}")
        errs = {"vs_plain": err}
        if dtype == torch.bfloat16:
            exact = max_err(got, k_attn.plain(q.float(), k.float(), v.float()))
            check(exact <= ATTN_BF16_EXACT_TOL,
                  f"attention bf16: kernel vs f32 math max abs err {exact} > "
                  f"{ATTN_BF16_EXACT_TOL}")
            errs["vs_f32_math_on_bf16_inputs"] = exact
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))  # [B, N, T, Dh]

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        lib_err = max_err(got, sdpa().transpose(1, 2))
        backend = _sdpa_backend(qt, kt, vt)
        lib_tol = (ATTN_BF16_TOL if dtype == torch.bfloat16 and backend == "MATH"
                   else ATTN_LIB_TOL[dtype])
        check(lib_err <= lib_tol,
              f"attention {name}: kernel vs SDPA ({backend}) max abs err {lib_err} > {lib_tol}")
        errs["vs_sdpa"] = lib_err
        es = q.element_size()
        a_bytes = 4 * Bq * T * N * Dh * es  # q, k, v read, o written
        a_flops = 2 * Dh * T * (T + 1) * Bq * N  # q.k and p.v over the causal half
        a_bound, a_by = bound(a_bytes, a_flops, dtype)
        # Serving's batch (B=64): the first half of the same inputs.
        q64, k64, v64 = (t[:B] for t in (q, k, v))
        qt64, kt64, vt64 = (t[:B] for t in (qt, kt, vt))
        b64_bound = bound(a_bytes / 2, a_flops / 2, dtype)
        check(torch.equal(k_attn.causal_attention(q64, k64, v64), got[:B]),
              f"attention {name}: the first {B} rows alone differ from the batch's")
        launch = k_attn.launch_config(Bq, T, N, Dh, dtype, k_attn.operand_align(q, k, v))
        out[name] = {
            "shape": {"B": Bq, "T": T, "N": N, "Dh": Dh, "dtype": name,
                      "qkv_slices": sliced},
            "launch": launch, "design": launch["design"],
            **({"twice_bit_for_bit": True} if twice else {}),
            "max_abs_err": err, "errors": errs, "tolerance": tol,
            "kernel_ms": time_ms(lambda: k_attn.causal_attention(q, k, v), reps=reps),
            "plain_ms": time_ms(lambda: k_attn.plain(q, k, v), reps=reps),
            "library_ms": time_ms(sdpa, reps=reps), "library_backend": backend,
            "library_tolerance": lib_tol,
            "bound_ms": a_bound, "bound_by": a_by, "bytes": int(a_bytes),
            "flops": int(a_flops),
            f"B{B}": {
                "same_bits_as_the_batch": True,
                "kernel_ms": time_ms(lambda: k_attn.causal_attention(q64, k64, v64), reps=reps),
                "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt64, kt64, vt64, is_causal=True), reps=reps),
                "bound_ms": b64_bound[0], "bound_by": b64_bound[1]},
        }
    return out


def lstm_weights(rng: np.random.Generator, D: int, H: int):
    """w_x [D, 4H] Glorot-uniform, w_h [H, 4H] orthogonal rows, b N(0, 0.1)
    with the forget block +1: f32 on the CPU."""
    lim = np.sqrt(6.0 / (D + 4 * H))
    w_x = torch.from_numpy(rng.uniform(-lim, lim, size=(D, 4 * H)).astype(np.float32))
    w_h = _orthogonal_rows(rng, 4, H)
    b = rng.normal(scale=0.1, size=4 * H)
    b[H:2 * H] += 1.0
    return w_x, w_h, torch.from_numpy(b.astype(np.float32))


def _nn_lstm(w_x, w_h, b, dtype, dev):
    """torch.nn.LSTM with the same weights (same i|f|g|o order, transposed,
    b_hh = 0): the library yardstick and a second oracle."""
    D, H4 = w_x.shape
    lib = torch.nn.LSTM(D, H4 // 4, batch_first=True, device=dev, dtype=dtype)
    with torch.no_grad():
        lib.weight_ih_l0.copy_(w_x.T)
        lib.weight_hh_l0.copy_(w_h.T)
        lib.bias_ih_l0.copy_(b)
        lib.bias_hh_l0.zero_()
    return lib


def _lstm_cells(x, h0, c0, w_x, w_h, b, keep):
    """The forward kernel's ys and f32 cell plane c_1..c_T from one launch
    that writes the plane, at any H and D: through the padded route's
    operands where the wrapper pads them, sliced back."""
    H = h0.shape[-1]
    x_, (h0_, c0_), w_x_, w_h_, (b_,) = k_gru.pad_scan_operands(x, [h0, c0], w_x, w_h, [b])
    ys, _, cs = k_lstm._forward_kernel(x_, h0_, c0_, w_x_, w_h_, b_, True, keep)
    return ys[..., :H], cs[..., :H]


def _lstm_checks(rng, dev, x32, reset=None, twice: bool = False,
                 H: Optional[int] = None, dtypes=(torch.bfloat16, torch.float32),
                 reps: int = REPS) -> dict:
    """The LSTM forward and its reverse recurrence against their plain
    versions, bf16 and f32, fed the embeddings of Zipf ids, and the whole
    backward through autograd (`twice`: a second launch of each gives the
    same bits). Without `reset` (h0 = c0 = 0), also against
    torch.nn.LSTM and its cuDNN times, each forward also beside nn.LSTM in
    f32 and at serving's batch (the first B rows, the batch's bits), and
    its input projection. With a [B, T] `reset` plane (and a
    random h0, c0), the reset variants: also bit-exact against the no-reset
    kernels on an all-zero plane (all-ones keep), blind to h0 and c0 with a
    reset at t=0, and dh0 = dc0 = 0 then. `H`: the hidden width (D by
    default). `reps`: time_ms's runs."""
    Bl, T, D = x32.shape
    H = D if H is None else H
    w_x, w_h, b = (w.to(dev) for w in lstm_weights(rng, D, H))
    g32 = torch.from_numpy(rng.normal(scale=1e-2, size=(Bl, T, H)).astype(np.float32)).to(dev)
    dcl = torch.from_numpy(rng.normal(scale=1e-2, size=(Bl, H)).astype(np.float32)).to(dev)
    if reset is None:
        h32 = c32 = torch.zeros(Bl, H, device=dev)
    else:
        h32, c32 = _state(rng, dev, Bl, H), _state(rng, dev, Bl, H)
    fwd, bwd, xproj = {}, {}, {}
    for dtype in dtypes:
        name = f"lstm {_dname(dtype)} {Bl}x{T}x{D}" + ("" if reset is None else " reset")
        x, h0, c0 = x32.to(dtype), h32.to(dtype), c32.to(dtype)
        args = (x, h0, c0, w_x, w_h, b)
        ys, (h_last, c_last) = k_lstm.lstm_scan(*args, reset_mask=reset)
        torch.cuda.synchronize()
        if twice:
            again = k_lstm.lstm_scan(*args, reset_mask=reset)
            check(torch.equal(ys, again[0]) and torch.equal(c_last, again[1][1]),
                  f"{name}: two launches differ")
        ys_p, (_, c_p) = k_lstm.plain(*args, reset_mask=reset)
        tol = LSTM_F32_TOL if dtype == torch.float32 else LSTM_BF16_TOL
        err, c_err = max_err(ys, ys_p), max_err(c_last, c_p)
        check(bool(torch.isfinite(ys).all()), f"{name}: non-finite output")
        check(torch.equal(h_last, ys[:, -1]), f"{name}: h_last is not ys[:, -1]")
        check(err <= tol and c_err <= tol,
              f"{name}: kernel vs plain max abs err {err} (ys), {c_err} (c_last) > {tol}")
        es = x.element_size()

        def f_bytes_of(rows):  # x, h0, c0, the weights, ys, b, c_T
            return ((rows * T * D + 2 * rows * H + (D + H) * 4 * H + rows * T * H) * es
                    + 4 * H * 4 + rows * H * 4)

        f_bytes = f_bytes_of(Bl)
        launch = k_lstm.padded_launch_config(Bl, T, D, H, dtype)
        rec = {"shape": {"B": Bl, "T": T, "D": D, "H": H, "dtype": _dname(dtype)},
               "launch": launch, "design": launch["design"],
               "max_abs_err": max(err, c_err), "tolerance": tol,
               **({"twice_bit_for_bit": True} if twice else {})}
        if reset is None:
            lib = _nn_lstm(w_x, w_h, b, dtype, dev)
            with torch.no_grad():
                ys_lib, _ = lib(x, (h0[None], c0[None]))
                lib_ms = time_ms(lambda: lib(x, (h0[None], c0[None])), reps=reps)
            lib_err = max_err(ys, ys_lib)
            lib_tol = LSTM_CUDNN_F32_TOL if dtype == torch.float32 else LSTM_BF16_TOL
            check(lib_err <= lib_tol,
                  f"{name}: kernel vs torch.nn.LSTM max abs err {lib_err} > {lib_tol}")
            rec.update(max_abs_err_vs_nn_lstm=lib_err, tolerance_vs_nn_lstm=lib_tol,
                       library_ms=lib_ms)
        if reset is None:
            # The aim's yardstick, nn.LSTM in f32 on the same values, and
            # serving's batch (B=64): the first half of the same inputs.
            f32 = dtype == torch.float32
            lib32 = lib if f32 else _nn_lstm(w_x, w_h, b, torch.float32, dev)
            xf, hf, cf = x.float(), h0.float()[None], c0.float()[None]
            x64, h64, c64 = x[:B], h0[:B], c0[:B]
            check(torch.equal(k_lstm.lstm_scan(x64, h64, c64, w_x, w_h, b)[0], ys[:B]),
                  f"{name}: the first {B} rows alone differ from the batch's")
            with torch.no_grad():
                rec["nn_lstm_f32_ms"] = lib_ms if f32 else time_ms(lambda: lib32(xf, (hf, cf)),
                                                                   reps=reps)
                b64_lib = time_ms(lambda: lib32(xf[:B], (hf[:, :B], cf[:, :B])), reps=reps)
            b64_bound = bound(f_bytes_of(B), 2 * B * T * (D + H) * 4 * H, dtype)
            rec[f"B{B}"] = {
                "same_bits_as_the_batch": True,
                "kernel_ms": time_ms(lambda: k_lstm.lstm_scan(x64, h64, c64, w_x, w_h, b),
                                     reps=reps),
                "nn_lstm_f32_ms": b64_lib,
                "bound_ms": b64_bound[0], "bound_by": b64_bound[1]}
            xproj[_dname(dtype)] = _xproj_check(k_lstm, k_lstm.lstm_input_projection, x32,
                                                w_x, b, dtype, reps=reps)
        elif reset is not None:
            f_bytes += Bl * T * 4  # the keep plane
            zero = k_lstm.lstm_scan(*args, reset_mask=torch.zeros_like(reset))
            base = k_lstm.lstm_scan(*args)
            check(torch.equal(zero[0], base[0]) and torch.equal(zero[1][1], base[1][1]),
                  f"{name}: an all-zero reset plane is not the no-reset kernel's bits")
            at0 = reset.clone()
            at0[:, 0] = 1.0
            a = k_lstm.lstm_scan(*args, reset_mask=at0)
            o = k_lstm.lstm_scan(x, -h0, -c0, *args[3:], reset_mask=at0)
            check(torch.equal(a[0], o[0]) and torch.equal(a[1][1], o[1][1]),
                  f"{name}: with a reset at t=0 the output depends on h0, c0")
            rec.update(resets=int(reset.sum().item()), zero_plane_bit_exact=True,
                       reset_at_t0_ignores_h0_c0=True, library_ms=None,
                       library=NO_RESET_LIBRARY)
        f_flops = 2 * Bl * T * (D + H) * 4 * H
        f_bound, f_by = bound(f_bytes, f_flops, dtype)
        rec.update({
            "kernel_ms": time_ms(lambda: k_lstm.lstm_scan(*args, reset_mask=reset), reps=reps),
            "plain_ms": time_ms(lambda: k_lstm.plain(*args, reset_mask=reset), reps=5),
            "bound_ms": f_bound, "bound_by": f_by, "bytes": int(f_bytes),
            "flops": int(f_flops), "serial_steps": T,
        })
        fwd[_dname(dtype)] = rec

        # The reverse recurrence on the planes of this forward.
        name = f"lstm backward {_dname(dtype)} {Bl}x{T}x{H}" + ("" if reset is None else " keep")
        wx_c, wh_c = w_x.to(dtype), w_h.to(dtype)
        with torch.no_grad():
            ys_k, cs = _lstm_cells(x, h0, c0, wx_c, wh_c, b, None if reset is None else 1.0 - reset)
            x_proj = torch.matmul(x.float(), wx_c.float()) + b
            _, keep, *planes = reference.lstm_bwd_hoist(x_proj, ys_k, cs, h0, c0, wh_c, reset)
        check(torch.equal(ys_k, ys), f"{name}: the cell-plane run changed ys")
        g = g32.to(dtype)
        bargs = (*planes, g, wh_c, keep, dcl)
        dz, dh0, dc0 = k_lstm.lstm_backward(*bargs)
        torch.cuda.synchronize()
        if twice:
            check(all(torch.equal(u, v) for u, v in zip((dz, dh0, dc0),
                                                        k_lstm.lstm_backward(*bargs))),
                  f"{name}: two launches differ")
        want = k_lstm.plain_backward(*bargs)
        errs = {k: rel_err(u, v) for k, u, v in zip(("dz", "dh0", "dc0"), (dz, dh0, dc0), want)}
        for k, e in errs.items():
            check(e <= LSTM_BWD_TOL, f"{name}: {k} kernel vs plain relative err {e} > "
                                     f"{LSTM_BWD_TOL}")
        if keep is not None:
            ones = k_lstm.lstm_backward(*planes, g, wh_c, torch.ones_like(keep), dcl)
            check(all(torch.equal(u, v) for u, v in zip(
                ones, k_lstm.lstm_backward(*planes, g, wh_c, None, dcl))),
                f"{name}: an all-ones keep plane is not the no-keep kernel's bits")
            keep0 = keep.clone()
            keep0[:, 0] = 0.0
            _, dh0_at0, dc0_at0 = k_lstm.lstm_backward(*planes, g, wh_c, keep0, dcl)
            check(not bool(dh0_at0.any()) and not bool(dc0_at0.any()),
                  f"{name}: dh0, dc0 are not 0 with a reset at t=0")
        got = _leaf_grads(k_lstm.lstm_scan, (x, h0, c0, w_x, w_h), (b,), reset, g)
        if dtype == torch.bfloat16:
            # Against reference.lstm_bwd_math (the plain reverse loop), every
            # gradient rounded to bf16 as the autograd path does.
            want_dxp, want_dh0, want_dc0, want_dwh, _ = reference.lstm_bwd_math(
                x_proj, ys_k, cs, h0, c0, wh_c, g, reset)
            want_g = [t.to(dtype) for t in (
                torch.matmul(want_dxp, wx_c.float().T), want_dh0, want_dc0,
                torch.einsum("btd,btk->dk", x.float(), want_dxp), want_dwh)]
            w_tol = GRU_BWD_BF16_W_TOL
        else:
            # Against autograd through the plain scan's own torch ops.
            want_g = _leaf_grads(k_lstm.plain, (x, h0, c0, w_x, w_h), (b,), reset, g)
            w_tol = LSTM_BWD_TOL
        w_errs = {k: rel_err(u, v) for k, u, v in zip(
            ("d_x", "dh0", "dc0", "dW_x", "dW_h"), got, want_g)}
        for k, e in w_errs.items():
            check(e <= w_tol, f"{name}: {k} through autograd relative err {e} > {w_tol}")
        b_bytes = (6 * Bl * T * H * 4 + Bl * T * H * es + 4 * H * H * es + Bl * H * 4
                   + Bl * T * 4 * H * 4 + 2 * Bl * H * 4 + (0 if keep is None else Bl * T * 4))
        b_flops = 2 * Bl * T * 4 * H * H
        b_launch = k_lstm.padded_backward_launch_config(Bl, T, H, dtype)
        if dtype == torch.bfloat16:
            # dz goes to the tensor cores as bf16 terms: their products.
            b_bound, b_by = bound(b_bytes, b_launch["dz_terms"] * b_flops, torch.bfloat16)
        else:
            b_bound, b_by = bound(b_bytes, b_flops, torch.float32)
        bwd[_dname(dtype)] = {
            "shape": {"B": Bl, "T": T, "H": H, "dtype": _dname(dtype)},
            "launch": b_launch, "design": b_launch["design"],
            "rel_err": errs, "tolerance": LSTM_BWD_TOL,
            "autograd_rel_err": w_errs, "autograd_tolerance": w_tol,
            **({"twice_bit_for_bit": True} if twice else {}),
            "max_abs_err": max(max_err(u, v) for u, v in zip((dz, dh0, dc0), want)),
            "kernel_ms": time_ms(lambda: k_lstm.lstm_backward(*bargs), reps=reps),
            "plain_ms": time_ms(lambda: k_lstm.plain_backward(*bargs), reps=5),
            "bound_ms": b_bound, "bound_by": b_by, "bytes": int(b_bytes),
            "flops": int(b_flops), "serial_steps": T,
        }
        if keep is not None:
            bwd[_dname(dtype)].update(ones_plane_bit_exact=True,
                                      dh0_dc0_zero_with_reset_at_t0=True,
                                      library_ms=None, library=NO_RESET_LIBRARY)
    if reset is not None:
        return {"lstm_scan": fwd, "lstm_backward": bwd}
    out = {"lstm_scan": fwd, "lstm_backward": bwd, "lstm_xproj": xproj.get("bfloat16"),
           "lstm_xproj_f32": xproj.get("float32")}
    # Library yardstick: cuDNN's LSTM backward in each record's dtype (TF32
    # off), timed as (forward + backward) - forward. The port never calls it.
    for dname, rec in bwd.items():
        dtype = getattr(torch, dname)
        lib = _nn_lstm(w_x, w_h, b, dtype, dev)
        xg = x32.to(dtype).detach().clone().requires_grad_(True)
        state0 = (torch.zeros(1, Bl, H, device=dev, dtype=dtype),
                  torch.zeros(1, Bl, H, device=dev, dtype=dtype))
        gd = g32.to(dtype)
        fb = time_ms(lambda: lib(xg, state0)[0].backward(gd), reps=reps)
        fw = time_ms(lambda: lib(xg, state0)[0], reps=reps)
        rec["library_ms"] = {"median": fb["median"] - fw["median"], "fwd_bwd": fb, "fwd": fw,
                             "what": f"torch.nn.LSTM {dname} (cuDNN), backward = fwd+bwd - fwd"}
    return out


def phase_tower_kernels(rng: np.random.Generator, dev) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    D = 128
    table = torch.from_numpy(
        rng.normal(scale=D ** -0.5, size=(VOCAB, D)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(zipf_items(rng, TRAIN_B * TRAIN_T).astype(np.int32)).to(dev)
    x32 = k_gather.plain(table, ids.reshape(TRAIN_B, TRAIN_T))
    out = {"causal_attention": _attention_checks(rng, dev), **_lstm_checks(rng, dev, x32)}
    emit({"phase": "tower_kernels", **out})
    return out


def _reset_plane(rng, B: int, T: int, dev) -> torch.Tensor:
    """[B, T] f32: a session start about every RESET_EVERY positions."""
    return torch.from_numpy((rng.random((B, T)) < 1 / RESET_EVERY).astype(np.float32)).to(dev)


def _zipf_embeddings(rng, dev, B: int, T: int, D: int) -> torch.Tensor:
    """[B, T, D] f32: rows of a random [VOCAB, D] table at Zipf ids."""
    table = torch.from_numpy(rng.normal(scale=D ** -0.5, size=(VOCAB, D)).astype(np.float32))
    ids = torch.from_numpy(zipf_items(rng, B * T).astype(np.int64))
    return table[ids].reshape(B, T, D).to(dev)


def phase_session_kernels(rng: np.random.Generator, dev) -> dict:
    """The four reset variants at the session paths' shapes: the GRU at
    rsc15_gru4rec's (B=256, T=50, D=H=100) and both cells at B=128, T=200,
    D=H=128 (ml1m_lstm's with session_parallel), through the same checks as
    their no-reset kernels, with a reset plane and a carried-in state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {k: {} for k in ("gru_scan_reset", "gru_backward_reset", "lstm_scan_reset",
                           "lstm_backward_reset")}
    for key, (B_, T_, D_) in (("rsc15", (256, 50, 100)), ("ml1m", (TRAIN_B, TRAIN_T, 128))):
        x32 = _zipf_embeddings(rng, dev, B_, T_, D_)
        reset = _reset_plane(rng, B_, T_, dev)
        weights = [w.to(dev) for w in gru_weights(rng, D_, D_)]
        h32 = _state(rng, dev, B_, D_)
        out["gru_scan_reset"][key] = {
            _dname(dt): _gru_forward_check(dev, x32, weights, h32, dt, reset)
            for dt in (torch.bfloat16, torch.float32)}
        out["gru_backward_reset"][key] = _gru_backward_checks(rng, dev, x32, reset)
    x32 = _zipf_embeddings(rng, dev, TRAIN_B, TRAIN_T, 128)
    lstm = _lstm_checks(rng, dev, x32, _reset_plane(rng, TRAIN_B, TRAIN_T, dev))
    out["lstm_scan_reset"]["ml1m"] = lstm["lstm_scan"]
    out["lstm_backward_reset"]["ml1m"] = lstm["lstm_backward"]
    emit({"phase": "session_kernels", **out})
    return out


# Each kernel's launch counter: (wrapper, attribute). The reset variants
# count apart from their no-reset counterparts, on the same wrappers; the
# bf16 GRU's cluster layouts (Hp > 128) count again, either variant, in
# `wide_launches`, the GRU's and the LSTM's grid layouts (H > 256, either
# dtype) in `grid_launches`, and the head's K split (H > 256) in
# `ksplit_launches`.
COUNTERS = {
    "gather": (k_gather.embedding_gather, "launches"),
    "gather_backward": (k_gather.embedding_scatter_add, "launches"),
    "gru_scan": (k_gru.gru_scan, "launches"),
    "gru_xproj": (k_gru.gru_input_projection, "launches"),
    "gru_backward": (k_gru.gru_backward, "launches"),
    "softmax_head": (k_head.sampled_softmax_nll, "launches"),
    "causal_attention": (k_attn.causal_attention, "launches"),
    "lstm_scan": (k_lstm.lstm_scan, "launches"),
    "lstm_xproj": (k_lstm.lstm_input_projection, "launches"),
    "lstm_backward": (k_lstm.lstm_backward, "launches"),
    "gru_scan_reset": (k_gru.gru_scan, "reset_launches"),
    "gru_backward_reset": (k_gru.gru_backward, "reset_launches"),
    "lstm_scan_reset": (k_lstm.lstm_scan, "reset_launches"),
    "lstm_backward_reset": (k_lstm.lstm_backward, "reset_launches"),
    "xproj_f32": (k_gru.gru_input_projection, "f32_launches"),
    "lstm_xproj_f32": (k_lstm.lstm_input_projection, "f32_launches"),
    "gather_window": (k_gather.embedding_gather_window, "launches"),
    "gather_backward_window": (k_gather.embedding_scatter_add_window, "launches"),
    "gru_scan_wide": (k_gru.gru_scan, "wide_launches"),
    "gru_backward_wide": (k_gru.gru_backward, "wide_launches"),
    "gru_scan_grid": (k_gru.gru_scan, "grid_launches"),
    "gru_backward_grid": (k_gru.gru_backward, "grid_launches"),
    "softmax_head_ksplit": (k_head.sampled_softmax_nll, "ksplit_launches"),
    "lstm_scan_grid": (k_lstm.lstm_scan, "grid_launches"),
    "lstm_backward_grid": (k_lstm.lstm_backward, "grid_launches"),
    # Every width (phase w): the attention's Dh-cluster and Dh-sliced layouts, the scans'
    # stepped layout past the grid's limit and padded route at H or D % 4,
    # the head's streamed layout past its resident rows' limit.
    "causal_attention_cluster": (k_attn.causal_attention, "cluster_launches"),
    "causal_attention_sliced": (k_attn.causal_attention, "sliced_launches"),
    "gru_scan_stepped": (k_gru.gru_scan, "stepped_launches"),
    "gru_backward_stepped": (k_gru.gru_backward, "stepped_launches"),
    "lstm_scan_stepped": (k_lstm.lstm_scan, "stepped_launches"),
    "lstm_backward_stepped": (k_lstm.lstm_backward, "stepped_launches"),
    "gru_scan_padded": (k_gru.gru_scan, "padded_launches"),
    "gru_backward_padded": (k_gru.gru_backward, "padded_launches"),
    "lstm_scan_padded": (k_lstm.lstm_scan, "padded_launches"),
    "lstm_backward_padded": (k_lstm.lstm_backward, "padded_launches"),
    "softmax_head_streamed": (k_head.sampled_softmax_nll, "streamed_launches"),
    # The stepped scans' step GEMM, one launch a step: forward, reverse; bf16
    # (wgmma), f32 (FMAs).
    "step_gemm": (k_gru.step_gemm, "launches"),
    "step_gemm_reverse": (k_gru.step_gemm, "reverse_launches"),
    "step_gemm_f32": (k_gru.step_gemm_f32, "launches"),
    "step_gemm_f32_reverse": (k_gru.step_gemm_f32, "reverse_launches"),
}


def read_counters() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in COUNTERS.items()}


def zero_counters() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


class PhaseTimedTrainer(Trainer):
    """A Trainer that records a CUDA event at the start of a step's forward
    and at the end of its forward, backward and update."""

    events: list = []

    def _mark(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append(e)

    def forward(self, *args, **kwargs):
        self._mark()
        out = super().forward(*args, **kwargs)
        self._mark()
        return out

    def backward(self, *args, **kwargs):
        out = super().backward(*args, **kwargs)
        self._mark()
        return out

    def update(self, *args, **kwargs):
        out = super().update(*args, **kwargs)
        self._mark()
        return out


def profile_steps(tr: Trainer, state, batches: list, top: int = 15) -> dict:
    """torch.profiler over len(batches) steps: device time and launches per
    step, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    n = len(batches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            state, _ = tr.train_step(state, batch)
        torch.cuda.synchronize()
    # Device-side events only (kernels, copies, memsets): a CPU op's entry
    # repeats the device time of the kernels it launched.
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    check(bool(rows), "profile: the profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    return {
        "steps": n,
        "device_ms_per_step": sum(r[1] for r in rows) / 1e3 / n,
        "device_launches_per_step": sum(r[2] for r in rows) / n,
        "top": [{"name": k[:90], "ms_per_step": t / 1e3 / n, "calls_per_step": c / n}
                for k, t, c in rows[:top]],
    }, state


class _Catalog:
    """A dataset's sizes alone: `vocab` rows (ML-1M's catalog by default)."""

    num_users = 0

    def __init__(self, vocab: int = VOCAB):
        self.vocab_size = vocab


def _train_wires(rng, trainer, groups: int, K: int, B: int, T: int,
                 vocab: int = VOCAB) -> list:
    """`groups` [K, B, T+2] wire groups of Zipf histories (ids ranked by
    popularity), 5..T positions a row."""
    wires = []
    for _ in range(groups * K):
        inputs = np.zeros((B, T), np.int32)
        targets = np.zeros((B, T), np.int32)
        for r, n in enumerate(rng.integers(5, T + 1, size=B)):
            seq = zipf_items(rng, n + 1, ranked=True, vocab=vocab)
            inputs[r, :n], targets[r, :n] = seq[:-1], seq[1:]
        wire = trainer.pack_train_batch({"inputs": inputs, "targets": targets,
                                         "mask": (targets != 0).astype(np.float32)})
        check(wire is not None, "train: a canonical batch did not pack")
        wires.append(wire)
    return list(np.stack(wires).reshape(groups, K, B, T + 2))


def _session_groups(trainer, ds, seed: int, groups: int, K: int, B: int, T: int):
    """`groups` groups of K consecutive [B, T] windows of a session-parallel
    stream over `ds`, packed into session wires: a group is a [K, B, T+E+W]
    array, or a list when a window ships as a dict (more session ends than
    the wire has slots). Returns (groups, windows that fell back to dicts)."""
    stream = make_session_stream(ds, batch_size=B, window=T, seed=seed)
    out, fallbacks = [], 0
    for _ in range(groups):
        group = []
        for _ in range(K):
            window = next(stream)[1]
            wire = trainer.pack_batch(window)
            fallbacks += wire is None
            group.append(window if wire is None else wire)
        packed = all(isinstance(b, np.ndarray) for b in group)
        out.append(np.stack(group) if packed else group)
    return out, fallbacks


def _on_device(batch, dev):
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(batch).to(dev)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _leaves(carry) -> list:
    if isinstance(carry, torch.Tensor):
        return [carry]
    return [x for c in carry for x in _leaves(c)]


def _opt_leaves(opt_state: dict) -> dict:
    """{name: tensor} of the optimizer state's tensors (Adam's mu and nu,
    Adagrad's sums of squares)."""
    return {f"{kind}/{k}": v for kind, tree in opt_state.items() if isinstance(tree, dict)
            for k, v in tree.items()}


def _reproducibility_check(tr: Trainer, state, group) -> dict:
    """One step's gradients twice, then two K-step groups from clones of one
    state (the sparse step updates its tables in place) on one batch group: every gradient, parameter and optimizer-state
    leaf equal bit for bit. The embedding table's gradient comes from the
    scatter-add alone. Names the leaves that differ, if any."""
    grads = []
    for _ in range(2):
        params = {k: v.detach().clone().requires_grad_(True) for k, v in state.params.items()}
        loss = tr.forward(state, params, tr._device_batch(group[0]))[0]
        grads.append(tr.backward(loss, params))
    grad_diff = [k for k in grads[0] if not torch.equal(grads[0][k], grads[1][k])]
    embedding = [k for k in grads[0] if "embedding" in k]
    check(embedding and not set(embedding) & set(grad_diff),
          f"reproducible: the embedding gradient differs between two runs ({grad_diff})")
    ends = [tr.train_step_multi(clone_state(state), group)[0] for _ in range(2)]
    a, b = ends
    leaves = {**{f"params/{k}": (v, b.params[k]) for k, v in a.params.items()},
              **{k: (v, _opt_leaves(b.opt_state)[k]) for k, v in _opt_leaves(a.opt_state).items()}}
    differ = [k for k, (u, v) in leaves.items() if not torch.equal(u, v)]
    check(not grad_diff, f"reproducible: step-1 gradients differ between two runs: {grad_diff}")
    check(not differ, f"reproducible: after {len(group)} steps these leaves differ: {differ}")
    return {"steps": len(group), "gradient_leaves": len(grads[0]),
            "embedding_gradients": embedding, "state_leaves_compared": len(leaves),
            "leaves": sorted(leaves), "bitwise_equal": True}


def _lookup_then_cast(self, table, ids, sharded=False):
    """SeqRecModel._lookup (of a model whose tables are whole) as it was
    before the gather wrote the compute dtype: a gather in the table's
    dtype, then a cast (a second launch, and its gradient a third)."""
    return ops.embedding_gather(table, ids, use_pallas=self.use_pallas).to(self.compute_dtype)


def phase_train(rng: np.random.Generator, dev, seed: int, path: str, groups: int,
                overrides=(), reproducible: bool = False, cast_launches: bool = False,
                vocab: int = VOCAB, shared_draw: bool = False) -> dict:
    """`overrides`: config changes for this run, each named in its result.
    `reproducible`: also run one K-step group twice from one state on one
    batch group and require equal bits (_reproducibility_check).
    `cast_launches`: also profile the steps with the lookups as they were
    before the gather wrote the compute dtype (gather, then cast), for the
    device launches a step before and after.
    A session-parallel configuration trains on windows of synthetic
    sessions with its path's shapes (SESSION_DATA), carrying the recurrent
    state from window to window; any other on Zipf histories over `vocab`
    rows (ML-1M's catalog by default). `shared_draw`: the initial state's
    parameters from `drawn_params` (the same bits as init_state's, kept
    between runs of one model)."""
    config = CONFIGS[path]
    cfg = RunConfig.load(config).apply_overrides(list(overrides))
    check(cfg.model.use_pallas, f"{config} must enable the kernels")
    session = cfg.data.session_parallel
    K, B = cfg.train.steps_per_call, cfg.data.batch_size
    T = cfg.data.max_len if session else max(cfg.data.buckets or (cfg.data.max_len,))
    t0 = time.perf_counter()
    ds = synthetic_dataset(**SESSION_DATA[path], seed=seed) if session else _Catalog(vocab)
    trainers = {}
    for use_pallas in (True, False):
        c = cfg.apply_overrides([f"model.use_pallas={str(use_pallas).lower()}"])
        trainers[use_pallas] = PhaseTimedTrainer(c, ds, device=dev)
    fallbacks = 0
    if session:
        batches, fallbacks = _session_groups(trainers[True], ds, seed, groups, K, B, T)
        T_, E, W = trainers[True]._session_wire_cols
        width = T_ + E + W
    else:
        batches = _train_wires(rng, trainers[True], groups, K, B, T, vocab)
        width = T + 2
    data_s = time.perf_counter() - t0
    wire_dtype = np.dtype(trainers[True]._wire_dtype)
    for group in batches:
        for b in group:
            check(not isinstance(b, np.ndarray) or (b.dtype == wire_dtype
                                                     and b.shape == (B, width)),
                  f"train {path}: wire {b.dtype} {b.shape}, expected {wire_dtype} "
                  f"{(B, width)}")

    # Step 1 through the kernels and through the plain versions: same state,
    # batch and generators. (Also warms the kernel path up.) The state is
    # drawn once (init_state(seed), the same for both trainers) and cloned
    # for every run from it: a wide table's draw takes seconds on the host.
    if shared_draw:
        state0 = trainers[True]._state(
            {k: v.to(dev) for k, v in drawn_params(trainers[True].model, seed).items()}, seed, dev)
    else:
        state0 = trainers[True].init_state(seed)
    step1, carry1 = {}, {}
    for use_pallas, tr in trainers.items():
        s1, m = tr.train_step(clone_state(state0), batches[0][0])
        step1[use_pallas] = {k: float(v) for k, v in m.items()}
        carry1[use_pallas] = s1.carry
    a, b = step1[True], step1[False]
    loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    norm_rel = abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
    bf16 = cfg.model.compute_dtype == "bfloat16"
    loss_tol, norm_tol = (STEP1_LOSS_TOL, STEP1_NORM_TOL) if bf16 else (STEP1_F32_TOL,) * 2
    check(loss_rel <= loss_tol,
          f"train {path}: step-1 loss {a['loss']} (kernels) vs {b['loss']} (plain)")
    check(norm_rel <= norm_tol,
          f"train {path}: step-1 grad_norm {a['grad_norm']} (kernels) vs {b['grad_norm']} (plain)")
    check(a["tokens"] == b["tokens"], f"train {path}: step-1 token counts differ")
    carry_err = None
    if session:
        ka, kb = _leaves(carry1[True]), _leaves(carry1[False])
        carry_err = max(max_err(u, v) for u, v in zip(ka, kb))
        tol = CARRY_TOL[cfg.model.cell_type]
        check(all(bool(torch.isfinite(u).all()) for u in ka), f"train {path}: non-finite carry")
        check(carry_err <= tol, f"train {path}: step-1 carry, kernels vs plain, max abs err "
                                f"{carry_err} > {tol}")
    torch.cuda.synchronize()

    # The counted run: `groups` groups of K steps through the kernels.
    tr = trainers[True]
    zero_counters()
    state = clone_state(state0)
    times, group_metrics, peaks = [], [], []
    for gi in range(groups):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = tr.train_step_multi(state, batches[gi])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        group_metrics.append({k: float(v) for k, v in m.items()})
        peaks.append(torch.cuda.max_memory_allocated())
    launches = read_counters()
    steps = groups * K
    repro = _reproducibility_check(tr, clone_state(state0), batches[0]) if reproducible else None

    # One group through the plain versions: no kernel may launch.
    before = read_counters()
    t0 = time.perf_counter()
    _, pm = trainers[False].train_step_multi(clone_state(state0), batches[0])
    del state0
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    plain_launches = {k: v - before[k] for k, v in read_counters().items()}
    plain_group = {k: float(v) for k, v in pm.items()}

    for gm in group_metrics:
        check(np.isfinite(gm["loss"]) and np.isfinite(gm["grad_norm"]),
              f"train {path}: non-finite metrics {gm}")
        check(gm["nonfinite"] == 0.0, f"train {path}: a step flagged non-finite {gm}")
    check(group_metrics[-1]["loss"] < group_metrics[0]["loss"],
          f"train {path}: loss did not fall ({group_metrics[0]['loss']} -> "
          f"{group_metrics[-1]['loss']})")
    want = {k: v * steps for k, v in expected_launches(cfg, training=True).items()}
    check(launches == want, f"train {path}: kernel launches {launches}, expected {want}")
    check(all(v == 0 for v in plain_launches.values()),
          f"train {path}: the plain run launched kernels {plain_launches}")
    check(abs(plain_group["loss"] - group_metrics[0]["loss"])
          <= STEP1_LOSS_TOL * abs(plain_group["loss"]),
          f"train {path}: group-1 mean loss {group_metrics[0]['loss']} (kernels) vs "
          f"{plain_group['loss']} (plain)")
    if session:
        # A carry that kept its graph would keep every earlier step's.
        check(peaks[-1] <= peaks[0] * (1 + MEM_GROWTH_TOL),
              f"train {path}: peak device memory grew from group 1 to group {groups}: "
              f"{peaks}")
        check(all(u.grad_fn is None and not u.requires_grad for u in _leaves(state.carry)),
              f"train {path}: the carry holds a graph")

    # Device time of a step, split by CUDA events: each step (its batch
    # already on the device) is queued behind a device sleep so the events
    # bracket the device's work, not the host's launch latency. Median over
    # the steps of one group.
    splits = []
    last = [_on_device(b, dev) for b in batches[-1]]
    for batch in last:
        tr.events.clear()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        state, _ = tr.train_step(state, batch)
        torch.cuda.synchronize()
        e = tr.events
        splits.append({"forward": e[0].elapsed_time(e[1]),
                       "backward": e[1].elapsed_time(e[2]),
                       "optimizer": e[2].elapsed_time(e[3]),
                       "total": e[0].elapsed_time(e[3])})
    split = {k: float(np.median([s[k] for s in splits])) for k in splits[0]}
    prof, state = profile_steps(tr, state, last[:4])
    if cast_launches:
        real = SeqRecModel._lookup
        SeqRecModel._lookup = _lookup_then_cast
        try:
            prof_cast, state = profile_steps(tr, state, last[:4])
        finally:
            SeqRecModel._lookup = real
        prof["gather_then_cast"] = {
            k: prof_cast[k] for k in ("device_ms_per_step", "device_launches_per_step")}
        prof["launches_saved_per_step"] = (prof_cast["device_launches_per_step"]
                                           - prof["device_launches_per_step"])
    step_ms = float(np.median(times)) / K
    result = {
        "phase": "train_session" if session else "train", "config": config,
        "overrides": list(overrides), "vocab": ds.vocab_size,
        "batch_size": B, "seq_len": T, "loss": cfg.model.loss,
        "compute_dtype": cfg.model.compute_dtype,
        "num_negatives": cfg.model.num_negatives, "steps_per_call": K, "groups": groups,
        "wire": {"dtype": str(wire_dtype), "shape": [K, B, width]},
        "data_seconds": data_s,
        "examples_per_s": steps * B / (sum(times) / 1e3),
        "positions_per_s": steps * B * T / (sum(times) / 1e3),
        "step_ms_median": step_ms,
        "group_ms": times,
        "plain_group_ms": plain_ms, "plain_examples_per_s": K * B / (plain_ms / 1e3),
        "device_step_ms": split, "device_idle_share": 1.0 - split["total"] / step_ms,
        "profile": prof,
        "step1": {"kernels": a, "plain": b, "loss_rel_err": loss_rel,
                  "grad_norm_rel_err": norm_rel, "loss_tolerance": loss_tol,
                  "grad_norm_tolerance": norm_tol},
        "group_metrics": group_metrics, "plain_group_metrics": plain_group,
        "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
        "plain_launches": plain_launches, "peak_memory_bytes": int(max(peaks)),
        "peak_memory_bytes_by_group": [int(p) for p in peaks],
    }
    if repro is not None:
        result["reproducible"] = repro
    if session:
        result.update({
            "data": {"synthetic_dataset": SESSION_DATA[path], "seed": seed,
                     "sessions": ds.num_users},
            "windows": steps, "dict_fallback_windows": fallbacks,
            "step1_carry_max_abs_err": carry_err,
            "carry_tolerance": CARRY_TOL[cfg.model.cell_type],
        })
    emit(result)
    return result


FIT_STEPS = 104  # 13 groups of 8
FIT_RUNS = (8, 1, 1, 8)  # steps_per_call of each run, alternated
FIT_RECALL_TOL = 0.02  # recall@10, kernels vs plain on the same weights: bf16 scores' near-ties


def s_bench_config(use_pallas: bool = True) -> RunConfig:
    """bench.py's headline configuration (bench.py:67-81), built by the
    port's own `bench_config`: GRU4Rec, B=128, T=200, D=H=64, 3,417 items,
    sampled softmax over 256 log-uniform negatives, dropout 0, bf16; the
    native loader, prefetch depth 2 (the defaults)."""
    return bench_config("gru4rec", batch_size=TRAIN_B, max_len=TRAIN_T, embed_dim=FIT_D,
                        num_items=VOCAB - 1, loss="sampled_softmax", num_negatives=NUM_NEG,
                        use_pallas=use_pallas)


def fit_config(steps_per_call: int, out_dir: str, use_pallas: bool = True) -> RunConfig:
    """bench.py's configuration (s_bench_config) for phase f2's fits:
    FIT_STEPS steps, a log line every 8, one full-protocol eval at the last
    step, checkpoints off."""
    cfg = s_bench_config(use_pallas)
    t = cfg.train
    t.steps_per_call, t.num_steps, t.log_every = steps_per_call, FIT_STEPS, 8
    t.eval_every, t.checkpoint_every, t.out_dir = FIT_STEPS, 0, out_dir
    return cfg


class _FitProbe:
    """Wraps a Trainer's put_batch and evaluate: the thread and the kind of
    each staged batch, and the launches, seconds and metrics of each eval."""

    def __init__(self, tr: Trainer):
        self.staged, self.evals = [], []
        put, ev = tr.put_batch, tr.evaluate

        def put_batch(batch):
            staged = put(batch)
            self.staged.append((threading.current_thread().name,
                                isinstance(staged, StagedBatch)))
            return staged

        def evaluate_(state, split="val"):
            before = read_counters()
            t0 = time.perf_counter()
            metrics = ev(state, split)
            torch.cuda.synchronize()
            self.evals.append({"seconds": time.perf_counter() - t0, "metrics": metrics,
                               "launches": {k: v - before[k]
                                            for k, v in read_counters().items()}})
            return metrics

        tr.put_batch, tr.evaluate = put_batch, evaluate_


def _fit_run(dev, ds, K: int, out_dir: Path) -> tuple:
    """One `Trainer(cfg).fit()` at fit_config(K): its checks and record,
    and its final state."""
    cfg = fit_config(K, str(out_dir))
    tr = Trainer(cfg, ds, device=dev)
    probe = _FitProbe(tr)
    zero_counters()
    t0 = time.perf_counter()
    state, last_eval = tr.fit()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counters()
    eval_launches = probe.evals[-1]["launches"] if probe.evals else {}
    train_launches = {k: v - eval_launches.get(k, 0) for k, v in launches.items()}
    lines = [json.loads(x) for x in (out_dir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in lines if r["tag"] == "train"]
    data = [r for r in lines if r["tag"] == "data"][0]
    name = f"fit K={K}"
    check(state.step == FIT_STEPS, f"{name}: stopped at step {state.step}")
    check(tr.data_engine == "native" and data["engine"] == "native",
          f"{name}: the native loader was not used ({tr.data_engine}: "
          f"{native.build_error()})")
    check(bool(probe.staged) and all(t == "seqrec-device-prefetch" and st
                                     for t, st in probe.staged),
          f"{name}: batches were not staged by the prefetcher's thread "
          f"through pinned memory: {set(probe.staged)}")
    check(len(train) == FIT_STEPS // 8 and all(np.isfinite(r["loss"]) for r in train),
          f"{name}: logged losses {[r['loss'] for r in train]}")
    check(train[-1]["loss"] < train[0]["loss"],
          f"{name}: loss did not fall ({train[0]['loss']} -> {train[-1]['loss']})")
    want = {k: v * FIT_STEPS for k, v in expected_launches(cfg, training=True).items()}
    check(train_launches == want, f"{name}: kernel launches {train_launches}, expected {want}")
    check(len(probe.evals) == 1 and last_eval == probe.evals[0]["metrics"],
          f"{name}: {len(probe.evals)} evals")
    check(last_eval["count"] > 0 and all(np.isfinite(v) for v in last_eval.values()),
          f"{name}: eval metrics {last_eval}")
    eps = [r["examples_per_s"] for r in train[1:]]  # the first window holds the warm-up
    return {
        "steps_per_call": K, "wall_s": wall_s, "data_engine": tr.data_engine,
        "staged_batches": len(probe.staged), "prefetch_to_device": cfg.data.prefetch_to_device,
        "examples_per_s_median": float(np.median(eps)),
        "examples_per_s_min": min(eps), "examples_per_s_max": max(eps),
        "step_ms_median": 1e3 * TRAIN_B / float(np.median(eps)),
        "losses": [r["loss"] for r in train],
        "launches": train_launches, "launches_per_step": {k: v / FIT_STEPS
                                                          for k, v in train_launches.items()},
        "eval": {"seconds": probe.evals[0]["seconds"], "metrics": last_eval,
                 "launches": eval_launches},
    }, tr, state


def _fit_profile(dev, ds, out_dir: Path, steps: int = 16, top: int = 15) -> dict:
    """torch.profiler over a short fit (K=8, no eval): device time and
    launches a step and the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    cfg = fit_config(8, str(out_dir))
    cfg.train.num_steps, cfg.train.eval_every = steps, 0
    tr = Trainer(cfg, ds, device=dev)
    tr.fit()  # warm: the allocator and the loader
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.fit()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    check(bool(rows), "fit profile: the profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    return {"steps": steps,
            "device_ms_per_step": sum(r[1] for r in rows) / 1e3 / steps,
            "device_launches_per_step": sum(r[2] for r in rows) / steps,
            "top": [{"name": k[:90], "ms_per_step": t / 1e3 / steps, "calls_per_step": c / steps}
                    for k, t, c in rows[:top]]}


def phase_fit(dev) -> dict:
    """`Trainer(cfg).fit()` at bench.py's configuration (fit_config): runs
    of K=8 and K=1 alternated (FIT_RUNS), each through the native loader
    and the prefetcher, its loss falling, each kernel launching its
    expected count a step, one full-protocol eval; the first run's final
    state also evaluated through the plain versions (recall@10 within
    FIT_RECALL_TOL); every run's final parameters equal bit for bit (K=8
    groups are K eager steps, and the step is deterministic); a profiled
    short fit for the device time, launches and idle share of a step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_fit_"))
    try:
        ds = throughput.default_dataset(fit_config(8, ""))
        runs, finals = [], []
        for i, K in enumerate(FIT_RUNS):
            rec, tr, state = _fit_run(dev, ds, K, root / f"run{i}")
            runs.append(rec)
            finals.append(state)
            if i == 0:
                plain = Trainer(fit_config(K, "", use_pallas=False), ds, device=dev)
                before = read_counters()
                plain_eval = evaluate(plain.model, state.params, ds, plain.cfg.eval,
                                      split="val", max_len=plain.cfg.data.max_len)
                check(read_counters() == before, "fit: the plain eval launched kernels")
                diff = abs(plain_eval["recall@10"] - rec["eval"]["metrics"]["recall@10"])
                check(diff <= FIT_RECALL_TOL,
                      f"fit: recall@10 {rec['eval']['metrics']['recall@10']} (kernels) vs "
                      f"{plain_eval['recall@10']} (plain)")
                rec["eval"]["plain_metrics"] = plain_eval
        differ = [k for k in finals[0].params
                  if not all(torch.equal(f.params[k], finals[0].params[k]) for f in finals)]
        check(not differ, f"fit: final parameters differ between runs: {differ}")
        prof = _fit_profile(dev, ds, root / "profile")
        traced = _fit_trace(dev, ds, root / "trace", prof)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    by_k = {K: [r for r in runs if r["steps_per_call"] == K] for K in set(FIT_RUNS)}
    summary = {f"K{K}": {"examples_per_s": [r["examples_per_s_median"] for r in rs],
                         "step_ms": [r["step_ms_median"] for r in rs]}
               for K, rs in sorted(by_k.items())}
    k8_step = float(np.median(summary["K8"]["step_ms"]))
    result = {
        "phase": "fit", "config": "bench.py's GRU4Rec (fit_config)", "vocab": ds.vocab_size,
        "users": ds.num_users, "batch_size": TRAIN_B, "seq_len": 200, "embed_dim": FIT_D,
        "num_negatives": 256, "compute_dtype": "bfloat16", "steps": FIT_STEPS,
        "runs": runs, "summary": summary, "final_params_bitwise_equal_across_runs": True,
        "launches": runs[0]["launches"], "profile": prof,
        "device_idle_share": 1.0 - prof["device_ms_per_step"] / k8_step,
        "eval_seconds": runs[0]["eval"]["seconds"], "profile_dir_fit": traced,
    }
    emit(result)
    return result


# The profile_dir fit (phase f2): a trace from the group holding step 8 to
# the one holding step 24 (three groups of 8) in a 40-step fit.
TRACE_WINDOW, TRACE_FIT_STEPS = (8, 24), 40
# The hand-written kernels' function names (csrc/*.cu, *.cuh), as a trace
# names them inside their demangled signatures.
HANDWRITTEN = ("gather_rows_kernel", "scatter_partials_kernel", "scatter_combine_kernel",
               "xproj_wgmma_kernel", "xproj_f32_kernel", "fma_gemm_kernel",
               "gru_forward_mma_kernel",
               "gru_forward_cluster_kernel", "gru_backward_mma_kernel",
               "gru_backward_cluster_kernel", "lstm_forward_mma_kernel",
               "lstm_forward_cluster_kernel", "lstm_backward_mma_kernel",
               "lstm_backward_cluster_kernel", "head_mma_kernel", "head_f32_kernel",
               "attention_mma_kernel", "attention_f32_kernel")
# Each of them on a bf16 GRU4Rec path, and the counter that counts its
# launches (the scatter-add's two kernels: one each a call).
TRACE_COUNTERS = {"gather_rows_kernel": "gather", "scatter_partials_kernel": "gather_backward",
                  "scatter_combine_kernel": "gather_backward",
                  "xproj_wgmma_kernel": "gru_xproj",
                  "gru_forward_mma_kernel": "gru_scan", "gru_backward_mma_kernel": "gru_backward",
                  "head_mma_kernel": "softmax_head"}


def _handwritten(name: str) -> Optional[str]:
    for h in HANDWRITTEN:
        if re.search(rf"(?<![A-Za-z0-9_]){h}(?![A-Za-z0-9_])", name):
            return h
    return None


def _fit_trace(dev, ds, out_dir: Path, prof: dict) -> dict:
    """`Trainer.fit` at fit_config(8) for TRACE_FIT_STEPS steps with
    train.profile_dir and profile_steps=TRACE_WINDOW: one Chrome trace in
    the directory, its groups exactly the window's (three of 8 steps, by
    their labels), naming each hand-written kernel of the path; its launches
    a step, each against the counters over the fit, and all its device
    operations a step beside `prof` (f2's own profiled fit)."""
    cfg = fit_config(8, str(out_dir / "run"))
    cfg.train.num_steps, cfg.train.eval_every = TRACE_FIT_STEPS, 0
    cfg.train.profile_dir, cfg.train.profile_steps = str(out_dir / "trace"), TRACE_WINDOW
    tr = Trainer(cfg, ds, device=dev)
    zero_counters()
    t0 = time.perf_counter()
    state, _ = tr.fit()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counters()
    trace = tr.profile_trace
    check(trace is not None and os.listdir(out_dir / "trace") == [os.path.basename(trace)],
          f"fit trace: {trace}, {os.listdir(out_dir / 'trace')}")
    events = json.loads(Path(trace).read_text())["traceEvents"]
    lo = TRACE_WINDOW[0] - TRACE_WINDOW[0] % 8
    hi = TRACE_WINDOW[1] - TRACE_WINDOW[1] % 8 + 8
    want_groups = [f"seqrec_group[{a},{a + 8})" for a in range(lo, hi, 8)]
    groups = sorted({e["name"] for e in events
                     if e.get("ph") == "X" and e.get("name", "").startswith("seqrec_group[")})
    check(groups == sorted(want_groups), f"fit trace: groups {groups}, expected {want_groups}")
    steps = hi - lo
    by_kernel = {}
    device_ops = 0
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            device_ops += 1
        if e.get("cat") == "kernel":
            h = _handwritten(e.get("name", ""))
            if h is not None:
                by_kernel[h] = by_kernel.get(h, 0) + 1
    per_step = {k: v / steps for k, v in sorted(by_kernel.items())}
    counted = {k: launches[c] / TRACE_FIT_STEPS for k, c in TRACE_COUNTERS.items()}
    check(set(per_step) == set(TRACE_COUNTERS),
          f"fit trace: hand-written kernels {sorted(per_step)}, expected {sorted(TRACE_COUNTERS)}")
    check(per_step == counted, f"fit trace: launches a step {per_step} vs the counters {counted}")
    return {"profile_dir": "a temporary directory", "profile_steps": list(TRACE_WINDOW),
            "trace_file": os.path.basename(trace), "trace_bytes": os.path.getsize(trace),
            "steps": TRACE_FIT_STEPS, "wall_s": wall_s, "groups": groups,
            "handwritten_launches_per_step": per_step, "counters_per_step": counted,
            "device_operations_per_step": device_ops / steps,
            "f2_profile_device_launches_per_step": prof["device_launches_per_step"],
            "final_step": state.step}


SPARSE_STEPS = 48  # six groups of 8
SPARSE_MEM_SLACK = 2e9  # bytes over the table and its accumulator: no [V, D] gradient
SPARSE_DENSE_TOL = 1e-5  # sparse vs dense, f32: the JAX package's rtol for the same check
FP_BLOCK_ROWS = 1 << 20  # rows a block of the table's fingerprint
HOT_ROWS = 1024  # the most drawn rows: synthetic ids are Zipf ranks (id 1 the most drawn)


def expected_sparse_launches(cfg: RunConfig) -> dict:
    """A sparse step's launches: the dense step's, plus one gather a sparse
    table (it fetches the step's sub-table); the three lookups read the
    sub-table, and only their scatter-adds run (into the sub-table)."""
    want = expected_launches(cfg, training=True)
    want["gather"] += 1 if cfg.model.tie_embeddings else 2
    return want


class _GroupProbe:
    """Wraps a Trainer's steps as `fit` calls them: each call's metrics
    (device tensors, read after the run), its steps and a CUDA event after
    it. `close()` gives the Trainer its own methods back."""

    def __init__(self, tr: Trainer):
        self.tr = tr
        self.metrics, self.steps, self.events = [], [], []
        inside = [False]
        multi, single = tr.train_step_multi, tr.train_step

        def record(out, k):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(e)
            self.metrics.append(out[1])
            self.steps.append(k)
            return out

        def multi_(state, wires):
            inside[0] = True
            try:
                return record(multi(state, wires), len(wires))
            finally:
                inside[0] = False

        def single_(state, batch):
            out = single(state, batch)
            return out if inside[0] else record(out, 1)

        tr.train_step_multi, tr.train_step = multi_, single_

    def close(self) -> None:
        del self.tr.train_step_multi, self.tr.train_step  # the class's methods again

    def read(self) -> dict:
        torch.cuda.synchronize()
        ms = [self.events[i - 1].elapsed_time(self.events[i]) / self.steps[i]
              for i in range(2, len(self.events))]  # the first interval holds the warm-up
        return {"metrics": [{k: float(v) for k, v in m.items()} for m in self.metrics],
                "step_ms": ms}


def _fingerprint(table: torch.Tensor) -> torch.Tensor:
    """[V, 2] int64 sums of each row's bit patterns (plain and weighted by
    column): a row whose bits change changes its fingerprint. In blocks,
    so that no [V, D] int64 temporary exists."""
    w = torch.arange(1, table.shape[1] + 1, device=table.device, dtype=torch.int64)
    out = torch.empty((table.shape[0], 2), dtype=torch.int64, device=table.device)
    for r0 in range(0, table.shape[0], FP_BLOCK_ROWS):
        bits = table[r0:r0 + FP_BLOCK_ROWS].view(torch.int32).to(torch.int64)
        out[r0:r0 + FP_BLOCK_ROWS, 0] = bits.sum(1)
        out[r0:r0 + FP_BLOCK_ROWS, 1] = (bits * w).sum(1)
    return out


def _first_batches(tr: Trainer, n: int) -> list:
    """The first `n` batches `fit` will take (a fresh stream from batch 0),
    as wires (a dict where a window does not pack)."""
    it = tr.train_iterator()
    try:
        out = []
        for _ in range(n):
            batch = next(it)[1]
            wire = tr.pack_batch(batch)
            out.append(batch if wire is None else wire)
        return out
    finally:
        if hasattr(it, "close"):
            it.close()


def _distinct_ids(tr: Trainer, state, steps: int) -> list:
    """The distinct ids (inputs, targets and negatives) of each of a fit's
    first `steps` steps, replayed after the run, so that nothing of it runs
    inside the timed fit: the same batches from a fresh stream, the same
    negatives (their generator is a function of the seed and the step)."""
    out = []
    for i, wire in enumerate(_first_batches(tr, steps)):
        batch = tr._device_batch(wire)
        gen = tr._generators(dataclasses.replace(state, step=i))[0]
        inputs = batch["inputs"]
        ids = torch.cat([inputs.reshape(-1), batch["targets"].reshape(-1),
                         tr.sample_negatives(gen)[0].to(inputs.dtype)])
        s = torch.sort(ids).values
        out.append(1 + (s[1:] != s[:-1]).sum())
    return [int(d) for d in out]


def _sparse_kernel_checks(rng, dev, cfg: RunConfig) -> dict:
    """The tower's and the head's kernels at the sparse path's own shapes
    (the gather's and the scatter-add's: `_sparse_bookkeeping`), in its
    compute dtype, against their plain versions at phases c, e and j's
    limits: the GRU forward (and its input projection) and reverse
    recurrence at B x T x H, with a reset plane and a carried-in state
    where the path is session-parallel, and the head at N = B*T rows and
    the config's S negatives."""
    m = cfg.model
    B, T, D, H = cfg.data.batch_size, cfg.data.max_len, m.embed_dim, m.hidden
    check(m.arch == "gru4rec" and D == H and m.loss == "sampled_softmax",
          f"sparse kernels: {m.arch} D={D} H={H} {m.loss}")
    dtype = getattr(torch, m.compute_dtype)
    x32 = _zipf_embeddings(rng, dev, B, T, D)
    weights = [w.to(dev) for w in gru_weights(rng, D, H)]
    reset, h32 = None, torch.zeros(B, H, device=dev)
    if cfg.data.session_parallel:
        reset, h32 = _reset_plane(rng, B, T, dev), _state(rng, dev, B, H)
    table = torch.from_numpy(rng.normal(scale=D ** -0.5, size=(VOCAB, D))
                             .astype(np.float32)).to(dev)
    return {
        "gru_scan": _gru_forward_check(dev, x32, weights, h32, dtype, reset),
        "gru_xproj": _xproj_check(k_gru, k_gru.gru_input_projection, x32, weights[0],
                                  weights[2], dtype),
        "gru_backward": _gru_backward_checks(rng, dev, x32, reset, dtypes=(dtype,))[
            _dname(dtype)],
        "softmax_head": _head_checks(rng, dev, table, beauty=False, N=B * T,
                                     S=m.num_negatives, dtypes=(dtype,))[_dname(dtype)],
    }


def _sparse_bookkeeping(tr: Trainer, state, wire) -> dict:
    """Device times of the sparse step's parts at this run's shapes, on one
    of its batches (after the run: the row update adds zeros): the unique
    set and the remaps, the gather's sub-table fetch from the [V, D] table,
    the lookups' scatter-add into the [K(+1), D] sub-table (beside
    index_add_), and the row update of the table and its state."""
    cfg = tr.cfg
    batch = tr._device_batch(wire)
    neg_ids = tr.sample_negatives(tr._generators(state)[0])[0]
    inputs, targets = batch["inputs"], batch["targets"]
    ids = torch.cat([inputs.reshape(-1), targets.reshape(-1), neg_ids.to(inputs.dtype)])
    table = state.params["item_embedding"]
    cap = cfg.train.sparse_unique_budget
    budget = sparse_embed.unique_budget(ids.numel(), table.shape[0])
    budget = min(budget, cap) if cap else budget
    remap = sparse_embed.remap_capped if cap else sparse_embed.remap
    uids = sparse_embed.collect_unique(ids, budget)
    rows = budget + (1 if cap else 0)
    D = table.shape[1]

    def bookkeeping():
        u = sparse_embed.collect_unique(ids, budget)
        return remap(u, inputs), remap(u, targets), remap(u, neg_ids)

    pos = remap(uids, inputs).reshape(-1)
    g = torch.randn((pos.numel(), D), device=table.device).to(tr.model.compute_dtype)
    got = k_gather.embedding_scatter_add(g, pos, rows)
    want = torch.zeros((rows, D), device=table.device).index_add_(0, pos.long(), g.float())
    err = max_err(got, want)
    check(err <= 1e-5 * max(want.abs().max().item(), 1.0),
          f"sparse: scatter-add into the sub-table, max abs err {err}")
    fetched = k_gather.embedding_gather(table, uids)
    check(torch.equal(fetched, table[uids.long()]), "sparse: the sub-table fetch is not exact")
    zeros = torch.zeros((budget, D), device=table.device)
    row_opt = state.embed_opt["item_embedding"]
    sb = bound(pos.numel() * (D * g.element_size() + 4) + rows * D * 4, 0, torch.float32)
    fb = bound(budget * (4 + 2 * D * 4), 0, torch.float32)
    return {
        "budget": budget, "sub_table_rows": rows, "distinct_ids": int(
            sparse_embed._first_occurrence_mask(uids).sum()),
        "unique_and_remap_ms": time_ms(bookkeeping)["median"],
        "row_update_ms": time_ms(lambda: sparse_embed.row_update(
            cfg.train.optimizer, 0.0, table, row_opt, uids, zeros, state.step))["median"],
        "fetch": {"kernel_ms": time_ms(lambda: k_gather.embedding_gather(table, uids))["median"],
                  "library_ms": time_ms(lambda: table[uids.long()])["median"],
                  "bound_ms": fb[0], "bound_by": fb[1]},
        "scatter_add": {
            "ids": pos.numel(), "rows": rows, "cotangent_dtype": _dname(g.dtype),
            "max_abs_err": err, "plan": k_gather.scatter_add_plan(pos.numel(), rows, D),
            "kernel_ms": time_ms(lambda: k_gather.embedding_scatter_add(g, pos, rows))["median"],
            "library_ms": time_ms(lambda: torch.zeros((rows, D), device=table.device)
                                  .index_add_(0, pos.long(), g.float()))["median"],
            "bound_ms": sb[0], "bound_by": sb[1]},
    }


def _moved(new: torch.Tensor, old: torch.Tensor) -> float:
    """|new - old| relative to |old| (Frobenius), or absolute where old is 0
    (the biases start at 0)."""
    d, n = float((new - old).norm()), float(old.norm())
    return d / n if n > 0 else d


def _sparse_run(dev, rng, seed: int, config: str, root: Path, overrides=()) -> dict:
    """`Trainer(cfg).fit()` on `config` (the sparse step) for SPARSE_STEPS
    steps from a state drawn once, and the same fit through the plain
    versions from a clone of that state (the step updates the tables in
    place): every group's loss finite; step 1, and each group's mean loss
    and largest gradient norm, within phase f's bf16 limits of the plain
    run's (the loss is flat at these configs over 48 steps, so a falling
    loss would decide nothing; how far the tower and the most drawn rows
    moved is reported); each kernel's launches a step; peak device memory
    under the table and its row state plus SPARSE_MEM_SLACK (no [V, D]
    gradient, one table); table rows changed at most steps x budget; ex/s
    and step ms (CUDA events between groups), the device time and idle
    share of a step (torch.profiler), the init seconds, the bookkeeping's
    device times, each step's distinct ids (replayed after the run) and
    those past a cap, and the tower's and the head's kernels at this
    path's shapes."""
    cfg = RunConfig.load(config).apply_overrides([
        f"train.num_steps={SPARSE_STEPS}", f"train.out_dir={root / 'run'}",
        f"data.data_dir={root / 'data'}", *overrides])
    check(cfg.train.sparse_embedding_update and cfg.model.use_pallas,
          f"{config}: the sparse step through the kernels")
    name = " ".join([config, *overrides])
    t0 = time.perf_counter()
    tr = Trainer(cfg, device=dev)
    data_s = time.perf_counter() - t0
    plain = Trainer(cfg.apply_overrides(["model.use_pallas=false",
                                         f"train.out_dir={root / 'plain'}"]), tr.ds, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = tr.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    table = state.params["item_embedding"]
    table_bytes = table.numel() * table.element_size()
    state_bytes = table_bytes + sum(t.numel() * t.element_size()
                                    for t in state.embed_opt["item_embedding"].values())

    # Step 1 from one state, through the kernels and through the plain
    # versions (each on a clone).
    group = _first_batches(tr, tr._steps_per_call())
    step1 = {}
    for use_pallas, t in ((True, tr), (False, plain)):
        m = t.train_step(clone_state(state), group[0])[1]  # the clone goes with the new state
        step1[use_pallas] = {k: float(v) for k, v in m.items()}
    a, b = step1[True], step1[False]
    loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    norm_rel = abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
    check(loss_rel <= STEP1_LOSS_TOL and norm_rel <= STEP1_NORM_TOL,
          f"{name}: step-1 loss / grad_norm {a} (kernels) vs {b} (plain)")
    # The whole fit through the plain versions, from a clone.
    probe = _GroupProbe(plain)
    before = read_counters()
    t0 = time.perf_counter()
    plain_end, _ = plain.fit(clone_state(state))
    torch.cuda.synchronize()
    plain_fit_s = time.perf_counter() - t0
    probe.close()
    check(read_counters() == before, f"{name}: the plain fit launched kernels")
    plain_run = probe.read()
    del plain_end

    tables = plain._sparse_table_names()
    tower0 = {k: v.clone() for k, v in state.params.items() if k not in tables}
    hot0 = table[1:1 + HOT_ROWS].clone()
    fp0 = _fingerprint(table)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # the state, the fingerprint, the copies
    probe = _GroupProbe(tr)
    zero_counters()
    t0 = time.perf_counter()
    state, _ = tr.fit(state)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = read_counters()
    probe.close()
    run = probe.read()
    table = state.params["item_embedding"]
    changed = int((_fingerprint(table) != fp0).any(1).sum())
    moved = {"tower": {k: _moved(state.params[k], v) for k, v in tower0.items()},
             f"rows_1_to_{HOT_ROWS}": _moved(table[1:1 + HOT_ROWS], hot0)}
    del fp0, tower0, hot0

    losses = [m["loss"] for m in run["metrics"]]
    steps = sum(probe.steps)
    K, B = cfg.train.steps_per_call, cfg.data.batch_size
    budget = sparse_embed.unique_budget(
        B * cfg.data.max_len * 2 + cfg.model.num_negatives, table.shape[0])
    if cfg.train.sparse_unique_budget:
        budget = min(budget, cfg.train.sparse_unique_budget)
    check(state.step == SPARSE_STEPS == steps, f"{name}: stopped at step {state.step}")
    check(all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and not m["nonfinite"]
              for m in run["metrics"]), f"{name}: non-finite metrics {run['metrics']}")
    check(len(run["metrics"]) == len(plain_run["metrics"]),
          f"{name}: {len(run['metrics'])} groups vs {len(plain_run['metrics'])} (plain)")
    group_rel = [{k: abs(x[k] - y[k]) / abs(y[k]) for k in ("loss", "grad_norm")}
                 for x, y in zip(run["metrics"], plain_run["metrics"])]
    check(all(g["loss"] <= STEP1_LOSS_TOL and g["grad_norm"] <= STEP1_NORM_TOL
              for g in group_rel),
          f"{name}: group loss / grad_norm vs the plain fit's, relative {group_rel}")
    want = {k: v * steps for k, v in expected_sparse_launches(cfg).items()}
    check(launches == want, f"{name}: kernel launches {launches}, expected {want}")
    check(peak < state_bytes + SPARSE_MEM_SLACK,
          f"{name}: peak device memory {peak} >= {state_bytes} + {SPARSE_MEM_SLACK} "
          f"({resident} allocated when the fit started)")
    check(0 < changed <= steps * budget,
          f"{name}: {changed} table rows changed, bound {steps} x {budget}")
    if cfg.data.session_parallel:
        check(all(bool(torch.isfinite(c).all()) for c in _leaves(state.carry)),
              f"{name}: non-finite carry")
    step_ms = float(np.median(run["step_ms"]))
    distinct = _distinct_ids(tr, state, steps)
    prof, state = profile_steps(tr, state, [group[i] for i in range(4)])
    parts = _sparse_bookkeeping(tr, state, group[0])
    result = {
        "config": config, "overrides": list(overrides), "vocab": tr.ds.vocab_size,
        "users": tr.ds.num_users, "table": list(table.shape), "optimizer": cfg.train.optimizer,
        "batch_size": B, "seq_len": cfg.data.max_len, "num_negatives": cfg.model.num_negatives,
        "compute_dtype": cfg.model.compute_dtype, "steps_per_call": K, "steps": steps,
        "unique_budget": budget, "data_engine": tr.data_engine,
        "data_seconds": data_s, "init_seconds": init_s, "fit_seconds": fit_s,
        "losses": losses, "plain_losses": [m["loss"] for m in plain_run["metrics"]],
        "group_rel_err_vs_plain": group_rel, "plain_fit_seconds": plain_fit_s,
        "step1": {"kernels": a, "plain": b, "loss_rel_err": loss_rel,
                  "grad_norm_rel_err": norm_rel},
        "moved": moved,
        "step_ms_median": step_ms, "step_ms": run["step_ms"],
        "examples_per_s": B / (step_ms / 1e3),
        "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
        "peak_memory_bytes": peak, "table_and_row_state_bytes": state_bytes,
        "allocated_at_fit_start_bytes": resident,
        "peak_memory_limit_bytes": state_bytes + SPARSE_MEM_SLACK,
        "table_rows_changed": changed, "table_rows_changed_bound": steps * budget,
        "profile": prof, "device_idle_share": 1.0 - prof["device_ms_per_step"] / step_ms,
        "bookkeeping": parts, "distinct_ids_per_step": distinct,
    }
    cap = cfg.train.sparse_unique_budget
    if cap:
        over = [max(0, d - cap) for d in distinct]
        result["overflowed_ids_per_step"] = {"mean": float(np.mean(over)), "max": max(over),
                                             "min": min(over)}
    del state, tr, plain
    torch.cuda.empty_cache()
    result["kernels"] = _sparse_kernel_checks(rng, dev, cfg)
    return result


def _sparse_against_dense(dev, rng, seed: int) -> dict:
    """configs/ml1m_gru4rec.json in f32, one K=8 group of Zipf histories:
    the sparse step against the dense step from one state, for sgd and
    adagrad (where the two are the same update), every parameter within
    SPARSE_DENSE_TOL relative to its largest value; adagrad's row state
    against the dense accumulator's rows too."""
    out = {}
    for opt in ("sgd", "adagrad"):
        base = RunConfig.load(CONFIGS["gru4rec"]).apply_overrides(
            [F32, f"train.optimizer={opt}"])
        trs = {sp: Trainer(base.apply_overrides([f"train.sparse_embedding_update={sp}"]),
                           _Catalog(), device=dev) for sp in ("false", "true")}
        K, B, T = base.train.steps_per_call, base.data.batch_size, base.data.max_len
        group = _train_wires(rng, trs["false"], 1, K, B, T)[0]
        ends = {}
        for sp, tr in trs.items():
            zero_counters()
            ends[sp], m = tr.train_step_multi(tr.init_state(seed), group)
            check(np.isfinite(float(m["loss"])), f"sparse vs dense {opt}: non-finite loss")
            want = {k: v * K for k, v in (expected_sparse_launches(tr.cfg) if sp == "true"
                                          else expected_launches(tr.cfg, True)).items()}
            check(read_counters() == want, f"sparse vs dense {opt} ({sp}): launches "
                                           f"{read_counters()}, expected {want}")
        errs = {k: rel_err(ends["true"].params[k], ends["false"].params[k])
                for k in ends["false"].params}
        if opt == "adagrad":
            errs["row_state/item_embedding"] = rel_err(
                ends["true"].embed_opt["item_embedding"]["acc"],
                ends["false"].opt_state["sum_of_squares"]["item_embedding"])
        bad = {k: e for k, e in errs.items() if e > SPARSE_DENSE_TOL}
        check(not bad, f"sparse vs dense {opt}: {bad} > {SPARSE_DENSE_TOL}")
        out[opt] = {"steps": K, "rel_err": errs, "tolerance": SPARSE_DENSE_TOL}
    return out


def phase_sparse(dev, seed: int) -> dict:
    """n. The sparse step, one card: configs/synthetic10m_singlechip.json
    unchanged but for num_steps and a temporary out_dir and data_dir, and
    configs/rsc15_10m.json on one card (mesh.model_axis=1,
    mesh.shard_embeddings=false; its sharding waits for multi-GPU) with
    checkpoint_every=0 (its end-of-run save would write the 10 GB state),
    each through `Trainer(cfg).fit()`; then the sparse step against the
    dense one at ML-1M's table in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_sparse_"))
    rng = np.random.default_rng(seed)
    try:
        runs = {"synthetic10m": _sparse_run(dev, rng, seed,
                                            "configs/synthetic10m_singlechip.json",
                                            root / "s10m"),
                "rsc15_10m": _sparse_run(dev, rng, seed, "configs/rsc15_10m.json",
                                         root / "rsc15",
                                         overrides=["mesh.model_axis=1",
                                                    "mesh.shard_embeddings=false",
                                                    "train.checkpoint_every=0"])}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    result = {"phase": "sparse", "runs": runs,
              "sparse_vs_dense": _sparse_against_dense(dev, rng, seed)}
    emit(result)
    return result


REMAT_TURNS = 4  # timed K=8 groups each way, alternated (off, on, off, on, ...)


def _remat_group(cfg: RunConfig, dev, seed: int, group) -> dict:
    """One configuration's K=8 group from the seed's state on `group`: the
    first step's gradients, the group's end state and metrics and its
    launches; then REMAT_TURNS timed groups from the same state, each with
    its peak device memory."""
    tr = Trainer(cfg, _Catalog(), device=dev)
    state = tr.init_state(seed)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in state.params.items()}
    loss = tr.forward(state, params, tr._device_batch(group[0]))[0]
    grads = {k: g.detach() for k, g in tr.backward(loss, params).items()}
    del params, loss
    zero_counters()
    end, m = tr.train_step_multi(state, group)
    torch.cuda.synchronize()
    return {"trainer": tr, "state": state, "grads": grads, "end": end,
            "metrics": {k: float(v) for k, v in m.items()}, "launches": read_counters()}


def _remat_time(run: dict, group) -> tuple:
    """(ms a step, peak device memory over the group) of one K=8 group."""
    tr, state = run["trainer"], run["state"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr.train_step_multi(state, group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(group), torch.cuda.max_memory_allocated()


def phase_remat(rng: np.random.Generator, dev, seed: int) -> dict:
    """q. SASRec block rematerialization: configs/ml1m_sasrec.json at full
    width (B=128, T=200, D=64, 2 blocks, dropout 0.2 as shipped, warmup 0
    as phase i), bf16 and f32, one K=8 group with model.remat=true and one
    with false from one state on one batch group: every gradient of the
    first step, every parameter and optimizer leaf and the group's metrics
    equal bit for bit (dropout is on: the replay draws the forward's masks);
    the attention kernel's launches a step (remat: twice a block, the
    forward again in the backward's replay; the other kernels as without);
    the peak device memory and the step ms each way (REMAT_TURNS groups
    each, alternated)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for dtype in ("bfloat16", "float32"):
        base = RunConfig.load(CONFIGS["sasrec"]).apply_overrides(
            ["train.warmup_steps=0", f"model.compute_dtype={dtype}"])
        K, B, T = base.train.steps_per_call, base.data.batch_size, base.data.max_len
        check(base.model.dropout_rate == 0.2, "remat: the shipped dropout changed")
        group = [_on_device(w, dev) for w in _train_wires(rng, Trainer(base, _Catalog(),
                                                                       device=dev), 1, K, B, T)[0]]
        runs = {remat: _remat_group(base.apply_overrides([f"model.remat={str(remat).lower()}"]),
                                    dev, seed, group) for remat in (False, True)}
        a, b = runs[False], runs[True]
        differ = [f"grad/{k}" for k in a["grads"] if not torch.equal(a["grads"][k], b["grads"][k])]
        differ += [f"params/{k}" for k in a["end"].params
                   if not torch.equal(a["end"].params[k], b["end"].params[k])]
        oa, ob = _opt_leaves(a["end"].opt_state), _opt_leaves(b["end"].opt_state)
        differ += [f"opt/{k}" for k in oa if not torch.equal(oa[k], ob[k])]
        check(not differ, f"remat {dtype}: these leaves differ from the group without remat: "
                          f"{differ}")
        check(a["metrics"] == b["metrics"], f"remat {dtype}: metrics {b['metrics']} vs "
                                            f"{a['metrics']}")
        for remat, run in runs.items():
            want = {k: v * K for k, v in expected_launches(run["trainer"].cfg,
                                                           training=True).items()}
            want["causal_attention"] *= 1 + remat
            check(run["launches"] == want, f"remat={remat} {dtype}: launches "
                                           f"{run['launches']}, expected {want}")
        turns = {False: [], True: []}
        for _ in range(REMAT_TURNS):
            for remat in (False, True):
                turns[remat].append(_remat_time(runs[remat], group))
        rec = {}
        for remat, ts in turns.items():
            rec["remat" if remat else "no_remat"] = {
                "step_ms": [t[0] for t in ts],
                "step_ms_median": float(np.median([t[0] for t in ts])),
                "peak_memory_bytes": [t[1] for t in ts],
                "launches_per_step": {k: v / K for k, v in runs[remat]["launches"].items()
                                      if v}}
        off, on = rec["no_remat"], rec["remat"]
        rec.update({
            "bit_equal_leaves": len(a["grads"]) + len(a["end"].params) + len(oa),
            "loss": a["metrics"]["loss"],
            "peak_memory_saved_bytes": max(off["peak_memory_bytes"]) - max(on["peak_memory_bytes"]),
            "peak_memory_ratio": max(on["peak_memory_bytes"]) / max(off["peak_memory_bytes"]),
            "step_ms_ratio": on["step_ms_median"] / off["step_ms_median"]})
        out[dtype] = rec
        del runs, group
        torch.cuda.empty_cache()
    result = {"phase": "remat", "config": CONFIGS["sasrec"], "overrides": ["train.warmup_steps=0"],
              "batch_size": TRAIN_B, "seq_len": TRAIN_T, "steps": 8, **out}
    emit(result)
    return result


P_RANKS = 2  # phase p2's ranks, both on cuda:0 over gloo
P_STEPS = 48  # each p2 fit: six groups of 8
P_TOL = 1e-5  # f32, the ranks against one rank: the JAX package's sharded rtol
# The group checks' learning rate: at the configs' 1e-3 (adagrad, accumulators
# from 0.1) a K=8 group moves a row ~2e-5 of its norm, inside P_TOL; at 0.05 a
# skipped or misplaced shard update reads far past it (each check reads one).
P2_LR = "train.learning_rate=0.05"
P_RANK_TIMEOUT_S = 420  # the two ranks take ~100 s on an H100
P_COLLECTIVE_TIMEOUT_S = 300  # a collective a peer never joins fails, it does not hang


def expected_sharded_launches(cfg: RunConfig, sparse: bool) -> dict:
    """Launches a step on one rank of a row-sharded path (model axis 2).
    Sparse: the sparse step's, its sub-table fetched by the window gather
    instead of the gather. Dense: the inputs' and the positives' lookups
    are each a window gather and the dedup inverse's gather, with a window
    scatter-add and the inverse's scatter-add backward; the negatives' a
    window gather and a window scatter-add. The full softmax looks up the
    inputs alone (its loss is the vocab-parallel matmuls)."""
    if sparse:
        want = expected_launches(cfg, training=True)
        want["gather_window"] = 1 if cfg.model.tie_embeddings else 2
        return want
    want = expected_launches(cfg, training=True)
    if cfg.model.loss in SAMPLED_LOSSES:
        want.update(gather=2, gather_backward=2, gather_window=3, gather_backward_window=3)
    else:  # the full softmax: the inputs' lookup only (the loss is matmuls)
        want.update(gather=1, gather_backward=1, gather_window=1, gather_backward_window=1)
    return want


def _p1_nccl(dev, seed: int, root: Path) -> dict:
    """p1. NCCL at world size 1: one K=8 group of configs/ml1m_gru4rec.json
    (dropout 0) through the mesh trainer over a process group of one rank,
    every parameter and optimizer leaf equal bit for bit to the same group
    with no process group."""
    cfg = RunConfig.load(CONFIGS["gru4rec"]).apply_overrides(["model.dropout_rate=0.0"])
    K, B, T = cfg.train.steps_per_call, cfg.data.batch_size, cfg.data.max_len
    plain_tr = Trainer(cfg, _Catalog(), device=dev)
    group = _train_wires(np.random.default_rng(seed + 11), plain_tr, 1, K, B, T)[0]
    want, wm = plain_tr.train_step_multi(plain_tr.init_state(seed), group)
    init_distributed(f"file://{root / 'nccl_store'}", 1, 0, backend="nccl", device=dev)
    try:
        mesh = make_mesh(1)
        check(mesh.distributed and mesh.backend == "nccl", f"p1: {mesh}")
        tr = Trainer(cfg, _Catalog(), device=dev, mesh=mesh)
        zero_counters()
        got, gm = tr.train_step_multi(tr.init_state(seed), group)
        torch.cuda.synchronize()
        launches = read_counters()
        stats = dict(mesh.stats)
    finally:
        shutdown()
    got_opt = _opt_leaves(got.opt_state)
    leaves = {**{f"params/{k}": (got.params[k], v) for k, v in want.params.items()},
              **{f"opt/{k}": (got_opt[k], v) for k, v in _opt_leaves(want.opt_state).items()}}
    differ = [k for k, (a, b) in leaves.items() if not torch.equal(a, b)]
    check(not differ, f"p1: the NCCL world-1 group differs from the one without a process "
                      f"group at {differ}")
    check(float(gm["loss"]) == float(wm["loss"]), f"p1: loss {gm['loss']} vs {wm['loss']}")
    want_l = {k: v * K for k, v in expected_launches(cfg, training=True).items()}
    check(launches == want_l, f"p1: launches {launches}, expected {want_l}")
    return {"config": CONFIGS["gru4rec"], "overrides": ["model.dropout_rate=0.0"],
            "backend": "nccl", "world": 1, "steps": K, "leaves_bit_equal": len(leaves),
            "loss": float(gm["loss"]), "collectives": stats}


def _p2_sparse_cfg(config: str, root: Path, rank: int, overrides=()) -> RunConfig:
    name = Path(config).stem
    return RunConfig.load(config).apply_overrides([
        f"train.num_steps={P_STEPS}", f"train.out_dir={root / 'run' / name / str(rank)}",
        f"data.data_dir={root / 'data' / name}", "train.checkpoint_every=0", *overrides])


def _cpu_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    return tree


def _p2_dense(dev, mesh, seed: int, root: Path) -> dict:
    """The dense sharded step: configs/ml1m_gru4rec.json with
    mesh.model_axis=2 and mesh.shard_embeddings (its 3,424-row padded table
    split in two), f32, adagrad, dropout 0, one K=8 group; this rank's rows
    of a global [8, 256, 202] group. Saves its state for the parent's
    one-rank check."""
    rank = mesh.rank
    cfg = RunConfig.load(CONFIGS["gru4rec"]).apply_overrides(P2_DENSE)
    tr = Trainer(cfg, _Catalog(), device=dev, mesh=mesh)
    K, B, T = cfg.train.steps_per_call, cfg.data.batch_size, cfg.data.max_len
    group = _train_wires(np.random.default_rng(seed + 12), tr, 1, K, mesh.size * B, T)[0]
    state = tr.init_state(seed)
    mesh.stats.update(calls=0, bytes=0, seconds=0.0)
    zero_counters()
    end, m = tr.train_step_multi(state, group[:, rank * B:(rank + 1) * B])
    torch.cuda.synchronize()
    launches = read_counters()
    want = {k: v * K for k, v in expected_sharded_launches(cfg, sparse=False).items()}
    check(launches == want, f"p2 dense rank {rank}: launches {launches}, expected {want}")
    torch.save({"params": _cpu_tree(end.params), "opt": _cpu_tree(_opt_leaves(end.opt_state)),
                "loss": float(m["loss"])}, root / f"dense.rank{rank}.pt")
    if rank == 0:
        np.save(root / "dense_group.npy", group)
    return {"launches": launches, "loss": float(m["loss"]), "collectives": dict(mesh.stats)}


def _global_distinct(tr: Trainer, mesh, state, batches: list) -> list:
    """Each step's distinct ids over the global batch (the ranks' inputs and
    targets all-gathered, and the step's negatives), replayed after the run."""
    out = []
    for i, wire in enumerate(batches):
        batch = tr._device_batch(wire)
        local = torch.cat([batch["inputs"].reshape(-1), batch["targets"].reshape(-1)])
        gen = tr._generators(dataclasses.replace(state, step=i))[0]
        ids = torch.cat([mesh.all_gather(local), tr.sample_negatives(gen)[0].to(local.dtype)])
        out.append(int(torch.unique(ids).numel()))
    return out


def _p2_f32_group(cfg: RunConfig, ds, dev, mesh, state, root: Path) -> dict:
    """The f32 check's ranks' side: one K=8 group of this rank's first
    batches in f32 at P2_LR from `state` (updated in place); saves the
    wires, the rows of this rank's shard that the group's global ids touch
    and their accumulator, before and after, and the tower before and
    after."""
    rank = mesh.rank
    tr = Trainer(cfg.apply_overrides([F32, P2_LR]), ds, device=dev, mesh=mesh)
    K = cfg.train.steps_per_call
    wires = np.stack(_first_batches(tr, K))
    ids = []
    for i, w in enumerate(wires):
        b = tr._device_batch(w)
        local = torch.cat([b["inputs"].reshape(-1), b["targets"].reshape(-1)])
        gen = tr._generators(dataclasses.replace(state, step=i))[0]
        ids += [mesh.all_gather(local), tr.sample_negatives(gen)[0].to(local.dtype)]
    table = state.params["item_embedding"]
    rows = table.shape[0]
    row0 = mesh.axis_index("model") * rows  # this shard's first row
    touched = torch.unique(torch.cat(ids)).long()
    mine = touched[(touched >= row0) & (touched < row0 + rows)]
    tables = tr._sparse_table_names()
    before = {"rows": table[mine - row0].cpu(),
              "acc": state.embed_opt["item_embedding"]["acc"][mine - row0].cpu(),
              "tower": _cpu_tree({k: v for k, v in state.params.items() if k not in tables})}
    end, m = tr.train_step_multi(state, wires)
    torch.cuda.synchronize()
    torch.save({"wires": wires, "ids": mine.cpu(), "before": before,
                "rows": table[mine - row0].cpu(),
                "acc": end.embed_opt["item_embedding"]["acc"][mine - row0].cpu(),
                "tower": _cpu_tree({k: v for k, v in end.params.items() if k not in tables}),
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "vocab_size": int(ds.vocab_size), "num_users": int(ds.num_users)},
               root / f"f32.rank{rank}.pt")
    return {"touched_rows": int(mine.numel()), "loss": float(m["loss"])}


def _p2_sparse(dev, mesh, seed: int, root: Path, config: str, f32_check: bool = False) -> dict:
    """One sharded config through `Trainer.fit` on this rank for P_STEPS
    steps (the dataset the parent prepared): the init seconds (this rank
    draws the whole table's stream and keeps its shard), the f32 group
    first where asked (the fit then starts from the state it left, its step
    counter at 0), then the bf16 fit with the launch counters and the
    collectives' stats zeroed just before it: every group's loss and
    gradient norm finite, each kernel's launches a step, peak memory under
    the shard and its row state plus SPARSE_MEM_SLACK, shard rows changed
    at most steps x the global budget; ex/s (global) and step ms by CUDA
    events between groups, device ms a step (torch.profiler over 4 steps),
    the collectives' ms a step (host clock, synchronized: under gloo each
    one is staged through host memory)."""
    rank = mesh.rank
    cfg = _p2_sparse_cfg(config, root, rank)
    name = f"{config} (rank {rank})"
    t0 = time.perf_counter()
    ds = load_dataset(cfg.data)
    tr = Trainer(cfg, ds, device=dev, mesh=mesh)
    data_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = tr.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    result = {"config": config, "rank": rank, "data_seconds": data_s, "init_seconds": init_s}
    if f32_check:
        result["f32_group"] = _p2_f32_group(cfg, ds, dev, mesh, state, root)
        state = dataclasses.replace(state, step=0)
    table = state.params["item_embedding"]
    state_bytes = table.numel() * table.element_size() + sum(
        t.numel() * t.element_size() for t in state.embed_opt["item_embedding"].values())
    fp0 = _fingerprint(table)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    probe = _GroupProbe(tr)
    mesh.stats.update(calls=0, bytes=0, seconds=0.0)
    zero_counters()
    t0 = time.perf_counter()
    state, _ = tr.fit(state)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = read_counters()
    collectives = dict(mesh.stats)
    probe.close()
    run = probe.read()
    steps = sum(probe.steps)
    changed = int((_fingerprint(table) != fp0).any(1).sum())
    del fp0
    K, B, T = cfg.train.steps_per_call, cfg.data.batch_size, cfg.data.max_len
    budget = sparse_embed.unique_budget(mesh.size * B * T * 2 + cfg.model.num_negatives,
                                        tr.model.table_size)
    if cfg.train.sparse_unique_budget:
        budget = min(budget, cfg.train.sparse_unique_budget)
    check(state.step == P_STEPS == steps, f"{name}: stopped at step {state.step}")
    check(all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and not m["nonfinite"]
              for m in run["metrics"]), f"{name}: non-finite metrics {run['metrics']}")
    want = {k: v * steps for k, v in expected_sharded_launches(cfg, sparse=True).items()}
    check(launches == want, f"{name}: kernel launches {launches}, expected {want}")
    check(peak < state_bytes + SPARSE_MEM_SLACK,
          f"{name}: peak device memory {peak} >= {state_bytes} + {SPARSE_MEM_SLACK}")
    # At most steps x budget; none at all is possible on a shard whose ids
    # all lie past a binding cap (the cap keeps the smallest ids), so the
    # summary wants rows changed on the model group as a whole.
    check(changed <= steps * budget,
          f"{name}: {changed} shard rows changed, bound {steps} x {budget}")
    if cfg.data.session_parallel:
        check(all(bool(torch.isfinite(c).all()) for c in _leaves(state.carry)),
              f"{name}: non-finite carry")
    step_ms = float(np.median(run["step_ms"]))
    batches = _first_batches(tr, K)
    distinct = _global_distinct(tr, mesh, state, batches)
    prof, state = profile_steps(tr, state, batches[:4])
    result.update({
        "world": mesh.size, "mesh": dict(mesh.shape), "backend": mesh.backend,
        "shard": list(table.shape), "table_rows": tr.model.table_size,
        "batch_size_per_rank": B, "global_batch": tr.global_batch, "seq_len": T,
        "num_negatives": cfg.model.num_negatives, "compute_dtype": cfg.model.compute_dtype,
        "steps": steps, "unique_budget": budget, "data_engine": tr.data_engine,
        "fit_seconds": fit_s, "losses": [m["loss"] for m in run["metrics"]],
        "grad_norms": [m["grad_norm"] for m in run["metrics"]],
        "step_ms_median": step_ms, "step_ms": run["step_ms"],
        "examples_per_s_global": tr.global_batch / (step_ms / 1e3),
        "device_ms_per_step": prof["device_ms_per_step"], "profile": prof,
        "collectives": collectives, "collective_ms_per_step": collectives["seconds"] * 1e3 / steps,
        "collective_calls_per_step": collectives["calls"] / steps,
        "collective_bytes_per_step": collectives["bytes"] / steps,
        "launches": launches, "peak_memory_bytes": peak, "shard_and_row_state_bytes": state_bytes,
        "allocated_at_fit_start_bytes": resident,
        "peak_memory_limit_bytes": state_bytes + SPARSE_MEM_SLACK,
        "shard_rows_changed": changed, "shard_rows_changed_bound": steps * budget,
        "global_distinct_ids_first_steps": distinct,
    })
    if cfg.train.sparse_unique_budget:
        result["overflowed_ids_first_steps"] = [max(0, d - budget) for d in distinct]
    del state, tr
    torch.cuda.empty_cache()
    return result


P2_DENSE = [F32, "train.optimizer=adagrad", P2_LR, "model.dropout_rate=0.0",
            "mesh.model_axis=2", "mesh.shard_embeddings=true"]
P2_CONFIGS = ("configs/synthetic10m_sharded.json", "configs/rsc15_10m.json")
# configs/ml100k_gru.json (the full softmax, buckets [50, 100, 200]) sharded
# as shipped but for the mesh, on synthetic data of ML-100K's shape: 1,682
# items, 943 users with histories of 20..201 (ML-100K's users rate >= 20
# items, ~106 on average).
ML100K = "configs/ml100k_gru.json"
ML100K_SETS = ["mesh.model_axis=2", "mesh.shard_embeddings=true", "data.dataset=synthetic",
               "data.synthetic_num_items=1682", "data.synthetic_num_users=943",
               "data.synthetic_min_len=20", "data.synthetic_max_len=201",
               "train.eval_every=0"]
# Its f32 group check: adagrad (as P2_DENSE: adam's m / sqrt(v) turns the
# rounding of a near-zero gradient into a whole step), dropout 0 (rank 1
# draws its own masks), at P2_LR.
ML100K_CHECK = [F32, "train.optimizer=adagrad", P2_LR, "model.dropout_rate=0.0"]


def _p2_ml100k_cfg(root: Path, rank: int, overrides=()) -> RunConfig:
    return _p2_sparse_cfg(ML100K, root, rank, [*ML100K_SETS, *overrides])


def _p2_ml100k(dev, mesh, seed: int, root: Path) -> dict:
    """configs/ml100k_gru.json sharded on this rank: the vocab-parallel full
    softmax with its output bias shard, the bucketed stream of one process
    (every rank the same bucket), the window gather and scatter-add.
    First the f32 K=8 group check (ML100K_CHECK) from the seed's state on
    the stream's first K batches: saves this rank's wires, buckets, state
    before and after for the parent's one-rank check. Then the bf16 fit as
    shipped (adam, dropout 0.1) for P_STEPS steps with the counters and the
    collectives' stats zeroed just before it: every group's global loss
    finite, the last group's below the first, each kernel's launches a step;
    ex/s and step ms by CUDA events between groups, device ms a step
    (torch.profiler over 4 steps), collective ms a step, peak memory; then
    the full-protocol eval, sharded."""
    rank = mesh.rank
    cfg = _p2_ml100k_cfg(root, rank)
    ds = load_dataset(cfg.data)
    c32 = cfg.apply_overrides(ML100K_CHECK)
    tr = Trainer(c32, ds, device=dev, mesh=mesh)
    check(tr.model.sharded and tr._global_stream(),
          f"ml100k rank {rank}: not sharded on one global stream")
    K = c32.train.steps_per_call
    it = tr.train_iterator()
    try:
        first = [next(it) for _ in range(K)]
    finally:
        it.close()
    wires = [tr.pack_batch(b) for _, b in first]
    state = tr.init_state()
    before = {"params": _cpu_tree(state.params), "opt": _cpu_tree(_opt_leaves(state.opt_state))}
    end, m = tr.train_step_multi(state, wires)
    torch.cuda.synchronize()
    torch.save({"wires": wires, "buckets": [int(b) for b, _ in first], "before": before,
                "params": _cpu_tree(end.params), "opt": _cpu_tree(_opt_leaves(end.opt_state)),
                "loss": float(m["loss"]), "vocab_size": int(ds.vocab_size),
                "num_users": int(ds.num_users)}, root / f"ml100k.rank{rank}.pt")
    del tr, state, end

    tr = Trainer(cfg, ds, device=dev, mesh=mesh)
    state = tr.init_state()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    probe = _GroupProbe(tr)
    mesh.stats.update(calls=0, bytes=0, seconds=0.0)
    zero_counters()
    t0 = time.perf_counter()
    state, _ = tr.fit(state)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = read_counters()
    collectives = dict(mesh.stats)
    probe.close()
    run = probe.read()
    steps = sum(probe.steps)
    name = f"{ML100K} sharded (rank {rank})"
    losses = [m["loss"] for m in run["metrics"]]
    check(state.step == P_STEPS == steps, f"{name}: stopped at step {state.step}")
    check(all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and not m["nonfinite"]
              for m in run["metrics"]), f"{name}: non-finite metrics {run['metrics']}")
    check(losses[-1] < losses[0], f"{name}: loss did not fall ({losses[0]} -> {losses[-1]})")
    want = {k: v * steps for k, v in expected_sharded_launches(cfg, sparse=False).items()}
    check(launches == want, f"{name}: kernel launches {launches}, expected {want}")
    t0 = time.perf_counter()
    metrics = tr.evaluate(state, split="test")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    check(metrics["count"] > 0 and all(np.isfinite(v) for v in metrics.values()),
          f"{name}: eval metrics {metrics}")
    step_ms = float(np.median(run["step_ms"]))
    prof, state = profile_steps(tr, state, _first_batches(tr, 4))
    result = {
        "config": ML100K, "overrides": ML100K_SETS, "rank": rank, "world": mesh.size,
        "mesh": dict(mesh.shape), "backend": mesh.backend,
        "table_rows": tr.model.table_size, "shard": list(state.params["item_embedding"].shape),
        "output_bias_shard": list(state.params["output_bias"].shape),
        "batch_size_per_rank": cfg.data.batch_size, "global_batch": tr.global_batch,
        "buckets": list(cfg.data.buckets), "data_engine": tr.data_engine,
        "group_steps": probe.steps,
        "steps": steps, "fit_seconds": fit_s, "losses": losses,
        "grad_norms": [m["grad_norm"] for m in run["metrics"]],
        "step_ms_median": step_ms, "step_ms": run["step_ms"],
        "examples_per_s_global": tr.global_batch / (step_ms / 1e3),
        "device_ms_per_step": prof["device_ms_per_step"], "profile": prof,
        "collectives": collectives, "collective_ms_per_step": collectives["seconds"] * 1e3 / steps,
        "collective_calls_per_step": collectives["calls"] / steps,
        "collective_bytes_per_step": collectives["bytes"] / steps,
        "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
        "peak_memory_bytes": peak, "allocated_at_fit_start_bytes": resident,
        "eval_test": metrics, "eval_seconds": eval_s,
        "f32_group": {"buckets": [int(b) for b, _ in first], "loss": float(m["loss"])},
    }
    del state, tr
    torch.cuda.empty_cache()
    return result


def p2_rank(rank: Optional[int], root: Path, seed: int) -> int:
    """One rank of phase p2: with `rank` (`--p2-rank`), a process of its own
    on cuda:0, joined to the other over gloo (NCCL refuses two ranks on one
    device); without (`--sharded-ranks`, under torchrun), torchrun's rank on
    cuda:LOCAL_RANK over NCCL, as many ranks as torchrun starts."""
    timeout = datetime.timedelta(seconds=P_COLLECTIVE_TIMEOUT_S)
    if rank is None:
        dev = init_distributed(timeout=timeout)
    else:
        dev = init_distributed(f"file://{root / 'store'}", P_RANKS, rank, backend="gloo",
                               device="cuda:0", timeout=timeout)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        mesh = make_mesh(2, timed=True)
        rank = mesh.rank
        t0 = time.perf_counter()
        if rank == 0:  # prepared once, read by every rank
            for config in P2_CONFIGS:
                load_dataset(_p2_sparse_cfg(config, root, 0).data)
            load_dataset(_p2_ml100k_cfg(root, 0).data)
        mesh.barrier()
        out = {"rank": rank, "mesh": dict(mesh.shape), "backend": mesh.backend,
               "device": str(dev), "data_seconds": time.perf_counter() - t0,
               "dense_ml1m": _p2_dense(dev, mesh, seed, root),
               "ml100k": _p2_ml100k(dev, mesh, seed, root)}
        out["synthetic10m"] = _p2_sparse(dev, mesh, seed, root, P2_CONFIGS[0], f32_check=True)
        out["rsc15_10m"] = _p2_sparse(dev, mesh, seed, root, P2_CONFIGS[1])
        (root / f"rank{rank}.json").write_text(json.dumps(out))
        mesh.barrier()
    except BaseException:
        # A failed rank leaves at once: a process-group teardown would wait
        # for the peers, which wait in their next collective for this rank.
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    shutdown()
    return 0


def _spawn_ranks(root: Path, seed: int, role: str = "p2", world: int = P_RANKS) -> list:
    """Run a phase's ranks (this script with --<role>-rank: p2's or r's)
    and wait for all; kills all and raises, with their logs' tails, if one
    fails or outlives P_RANK_TIMEOUT_S."""
    procs, logs = [], []
    for r in range(world):
        log = open(root / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), f"--{role}-rank", str(r),
             f"--{role}-dir", str(root), "--seed", str(seed)],
            stdout=log, stderr=subprocess.STDOUT, cwd=Path.cwd()))
    deadline = time.monotonic() + P_RANK_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break  # one failed: the other would wait for it forever
            time.sleep(1.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    if any(p.returncode != 0 for p in procs):
        tails = {r: (root / f"rank{r}.log").read_text()[-3000:] for r in range(world)}
        raise CheckFailed(f"{role}: ranks exited {[p.returncode for p in procs]}: {tails}")
    return [json.loads((root / f"rank{r}.json").read_text()) for r in range(world)]


def _rel_err_np(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max() / max(float(b.abs().max()), 1e-30))


def _same_on_ranks(ranks: list, get, what: str, model_axis: int = 0) -> None:
    """Replicas hold the same bits: every rank (model_axis 0), or the
    ranks of each model index."""
    for r, rec in enumerate(ranks):
        ref = ranks[r % model_axis] if model_axis else ranks[0]
        check(torch.equal(get(rec), get(ref)), f"{what}: rank {r} differs from its replica")


def _p2_check_dense(dev, seed: int, root: Path, world: int = P_RANKS) -> dict:
    """The dense sharded group against one rank: the same config at model
    axis 1 (shard_embeddings pads the table to the same 3,424 rows, so the
    same seed draws the same state), the global batch, on the global group.
    The table is the model group's shards in order (ranks 0 and 1). The
    planted fault: shard 1's rows and accumulator left as they were before
    the group (its update skipped), read the same way; it must exceed P_TOL,
    or the check could not see such a fault."""
    cfg = RunConfig.load(CONFIGS["gru4rec"]).apply_overrides(
        [*P2_DENSE[:-2], "mesh.model_axis=1", "mesh.shard_embeddings=true",
         f"data.batch_size={world * RunConfig.load(CONFIGS['gru4rec']).data.batch_size}"])
    tr = Trainer(cfg, _Catalog(), device=dev)
    start = tr.init_state(seed)
    before = {"item_embedding": start.params["item_embedding"].cpu().clone(),
              **{f"opt/{k}": v.cpu().clone() for k, v in _opt_leaves(start.opt_state).items()
                 if k.endswith("item_embedding")}}  # cloned: the step may update in place
    want, m = tr.train_step_multi(start, np.load(root / "dense_group.npy"))
    ranks = [torch.load(root / f"dense.rank{r}.pt") for r in range(world)]
    errs, fault = {}, {}
    for k, v in want.params.items():
        sharded = k == "item_embedding"
        _same_on_ranks(ranks, lambda r: r["params"][k], f"p2 dense {k}", 2 if sharded else 0)
        got = torch.cat([r["params"][k] for r in ranks[:2]]) if sharded else ranks[0]["params"][k]
        errs[k] = _rel_err_np(got, v.cpu())
        if sharded:
            rows = ranks[0]["params"][k].shape[0]
            fault[k] = _rel_err_np(torch.cat([ranks[0]["params"][k], before[k][rows:]]), v.cpu())
    for k, v in _opt_leaves(want.opt_state).items():
        sharded = k.endswith("item_embedding")
        got = torch.cat([r["opt"][k] for r in ranks[:2]]) if sharded else ranks[0]["opt"][k]
        errs[f"opt/{k}"] = _rel_err_np(got, v.cpu())
        if sharded:
            rows = ranks[0]["opt"][k].shape[0]
            fault[f"opt/{k}"] = _rel_err_np(
                torch.cat([ranks[0]["opt"][k], before[f"opt/{k}"][rows:]]), v.cpu())
    bad = {k: e for k, e in errs.items() if e > P_TOL}
    check(not bad, f"p2 dense: the ranks vs one rank {bad} > {P_TOL}")
    loss_rel = abs(ranks[0]["loss"] - float(m["loss"])) / abs(float(m["loss"]))
    check(loss_rel <= P_TOL, f"p2 dense: loss {ranks[0]['loss']} vs {float(m['loss'])}")
    check(max(fault.values()) > P_TOL,
          f"p2 dense: shard 1's update skipped reads {fault}, within {P_TOL}: unseen")
    return {"rel_err": errs, "loss_rel_err": loss_rel, "tolerance": P_TOL,
            "planted_fault_rel_err": fault}


def _p2_check_f32(dev, root: Path, world: int = P_RANKS) -> dict:
    """The f32 sparse group against one rank: configs/synthetic10m_sharded.json
    in f32 at model axis 1, batch 512, on the ranks' wires side by side (the
    global batch), from a state holding the rows the group touches (their
    values before it, from the ranks) and the ranks' tower: the touched rows,
    their accumulator and the tower after it, within P_TOL of each leaf's
    largest value. The rows it does not touch, it does not read. The planted
    fault, shard 1's touched rows and accumulator as before the group (its
    update skipped), must read past P_TOL."""
    cfg = RunConfig.load(P2_CONFIGS[0]).apply_overrides(
        [F32, P2_LR, "mesh.model_axis=1", "mesh.shard_embeddings=false",
         f"data.batch_size={world * RunConfig.load(P2_CONFIGS[0]).data.batch_size}"])
    ranks = [torch.load(root / f"f32.rank{r}.pt", weights_only=False) for r in range(world)]
    for k in ranks[0]["tower"]:
        _same_on_ranks(ranks, lambda r: r["tower"][k], f"p2 f32 {k}")

    class _DS:
        vocab_size, num_users = ranks[0]["vocab_size"], ranks[0]["num_users"]

    tr = Trainer(cfg, _DS(), device=dev)
    D = cfg.model.embed_dim
    shards = ranks[:2]  # the model group of data index 0 (its replicas: the same rows)
    for key in ("ids", "rows", "acc"):
        _same_on_ranks(ranks, lambda x: x[key], f"p2 f32 {key}", 2)
    ids = torch.cat([r["ids"] for r in shards]).to(dev)
    table = torch.zeros((_DS.vocab_size, D), dtype=torch.float32, device=dev)
    table[ids] = torch.cat([r["before"]["rows"] for r in shards]).to(dev)
    params = {**{k: v.to(dev) for k, v in ranks[0]["before"]["tower"].items()},
              "item_embedding": table}
    state = tr._state(params, cfg.train.seed, dev)
    wires = np.concatenate([r["wires"] for r in ranks], axis=1)
    end, m = tr.train_step_multi(state, wires)
    want_rows, want_acc = table[ids].cpu(), end.embed_opt["item_embedding"]["acc"][ids].cpu()
    errs = {"item_embedding[touched]": _rel_err_np(
                torch.cat([r["rows"] for r in shards]), want_rows),
            "acc[touched]": _rel_err_np(torch.cat([r["acc"] for r in shards]), want_acc)}
    fault = {"item_embedding[touched]": _rel_err_np(
                 torch.cat([shards[0]["rows"], shards[1]["before"]["rows"]]), want_rows),
             "acc[touched]": _rel_err_np(
                 torch.cat([shards[0]["acc"], shards[1]["before"]["acc"]]), want_acc)}
    for k, v in ranks[0]["tower"].items():
        errs[k] = _rel_err_np(v, end.params[k].cpu())
    loss_rel = abs(ranks[0]["loss"] - float(m["loss"])) / abs(float(m["loss"]))
    errs["loss"] = loss_rel
    bad = {k: e for k, e in errs.items() if e > P_TOL}
    check(not bad, f"p2 f32: the ranks vs one rank {bad} > {P_TOL}")
    check(max(fault.values()) > P_TOL,
          f"p2 f32: shard 1's update skipped reads {fault}, within {P_TOL}: unseen")
    out = {"touched_rows": int(ids.numel()), "rel_err": errs, "tolerance": P_TOL,
           "planted_fault_rel_err": fault, "shard1_touched_rows": int(shards[1]["ids"].numel()),
           "global_batch": int(wires.shape[1])}
    del table, state, end, tr
    torch.cuda.empty_cache()
    return out


def _p2_check_ml100k(dev, root: Path, world: int = P_RANKS) -> dict:
    """The ml100k f32 group against one rank: the same config unsharded at
    model axis 1 (its table unpadded: 1,683 rows), the global batch (the
    ranks' wires side by side: every rank held the same bucket), from the
    ranks' starting state (the shards side by side, cut to the true vocab:
    the padded rows are never read and take no gradient, their logits at
    -1e30). Every leaf within P_TOL of its largest value, the table and the
    output bias assembled from the model group's shards. The planted fault:
    shard 1's table and bias rows, and their accumulators, as before the
    group; it must read past P_TOL."""
    ranks = [torch.load(root / f"ml100k.rank{r}.pt", weights_only=False) for r in range(world)]
    for r in ranks[1:]:
        check(r["buckets"] == ranks[0]["buckets"],
              f"p2 ml100k: rank buckets {r['buckets']} vs {ranks[0]['buckets']}")
    nv = ranks[0]["vocab_size"]
    cfg = RunConfig.load(ML100K).apply_overrides(
        [*ML100K_SETS[2:], *ML100K_CHECK, "mesh.model_axis=1", "mesh.shard_embeddings=false",
         f"data.batch_size={world * RunConfig.load(ML100K).data.batch_size}"])

    class _DS:
        vocab_size, num_users = nv, ranks[0]["num_users"]

    tr = Trainer(cfg, _DS(), device=dev)

    def sharded(k: str) -> bool:
        return k.endswith("item_embedding") or k.endswith("output_bias")

    def whole(key: str, k: str, when: str = "after") -> torch.Tensor:
        """Leaf `k` of `key` ('params' / 'opt') before or after the group,
        the model group's shards side by side (cut to the true vocab) when
        it is sharded."""
        part = [r["before"] if when == "before" else r for r in ranks[:2]]
        return torch.cat([p[key][k] for p in part])[:nv] if sharded(k) else part[0][key][k]

    params = {k: whole("params", k, "before").to(dev) for k in ranks[0]["before"]["params"]}
    state = tr._state(params, cfg.train.seed, dev)
    start_opt = _opt_leaves(state.opt_state)
    for k in ranks[0]["before"]["opt"]:  # the ranks started where this starts
        check(torch.equal(whole("opt", k, "before"), start_opt[k].cpu()),
              f"p2 ml100k: starting optimizer leaf {k} differs")
    wires = [np.concatenate([r["wires"][i] for r in ranks]) for i in range(len(ranks[0]["wires"]))]
    end, m = tr.train_step_multi(state, wires)
    errs, fault = {}, {}
    for key, want in (("params", end.params), ("opt", _opt_leaves(end.opt_state))):
        for k, v in want.items():
            _same_on_ranks(ranks, lambda r: r[key][k], f"p2 ml100k {key}/{k}",
                           2 if sharded(k) else 0)
            errs[f"{key}/{k}"] = _rel_err_np(whole(key, k), v.cpu())
            if sharded(k):
                planted = torch.cat([ranks[0][key][k], ranks[1]["before"][key][k]])[:nv]
                fault[f"{key}/{k}"] = _rel_err_np(planted, v.cpu())
    loss_rel = abs(ranks[0]["loss"] - float(m["loss"])) / abs(float(m["loss"]))
    errs["loss"] = loss_rel
    bad = {k: e for k, e in errs.items() if e > P_TOL}
    check(not bad, f"p2 ml100k: the ranks vs one rank {bad} > {P_TOL}")
    check(max(fault.values()) > P_TOL,
          f"p2 ml100k: shard 1's update skipped reads {fault}, within {P_TOL}: unseen")
    out = {"rel_err": errs, "tolerance": P_TOL, "planted_fault_rel_err": fault,
           "buckets": ranks[0]["buckets"], "global_batch": int(wires[0].shape[0]),
           "vocab": nv, "table_rows_sharded": int(ranks[0]["params"]["item_embedding"].shape[0])
           * 2}
    del state, end, tr
    torch.cuda.empty_cache()
    return out


def _window_gather_check(rng, dev, rows: int, n: int, D: int, dtype) -> dict:
    """p3. The window gather at the sharded fetch's shape: n ids over the
    whole table of 2 x rows rows into the second shard (rows [rows, 2 rows),
    as rank 1 holds it), about half of them off the window: bit for bit
    against its plain version; kernel, plain (torch.where(owned,
    shard[clamp], 0)), library (F.embedding of the clamped local ids, then
    torch.where) and bound times. The bound counts the distinct owned rows
    read once in f32, the ids, and the output in `dtype`."""
    shard = torch.randn((rows, D), device=dev)
    ids = torch.from_numpy(rng.integers(0, 2 * rows, size=n).astype(np.int32)).to(dev)
    row0 = rows
    got = k_gather.embedding_gather_window(shard, ids, row0, dtype=dtype)
    want = reference.embedding_gather_window(shard, ids, row0, dtype=dtype)
    torch.cuda.synchronize()
    check(torch.equal(_bits(got), _bits(want)), f"gather window {_dname(dtype)}: not bit-exact")
    local, owned = reference.window_ids(ids, row0, rows)
    clamped = local.clamp(0, rows - 1)
    zero = torch.zeros((), dtype=dtype, device=dev)
    owned_rows = int(torch.unique(local[owned]).numel())
    b = bound(owned_rows * D * 4 + n * 4 + n * D * torch.tensor([], dtype=dtype).element_size(),
              0, torch.float32)
    return {
        "shape": {"shard": [rows, D], "row0": row0, "ids": n, "owned_ids": int(owned.sum()),
                  "dtype": _dname(dtype)},
        "design": "4-rows-in-flight, shard window", "max_abs_err": 0.0, "bit_exact": True,
        "kernel_ms": time_ms(lambda: k_gather.embedding_gather_window(shard, ids, row0,
                                                                      dtype=dtype)),
        "plain_ms": time_ms(lambda: reference.embedding_gather_window(shard, ids, row0,
                                                                      dtype=dtype)),
        "library_ms": time_ms(lambda: torch.where(
            owned[:, None], torch.nn.functional.embedding(clamped, shard).to(dtype), zero)),
        "library": "F.embedding of the clamped local ids, .to(dtype), then torch.where",
        "bound_ms": b[0], "bound_by": b[1],
    }


def _window_scatter_check(rng, dev, rows: int, n: int, D: int) -> dict:
    """p3. The window scatter-add at the dense sharded step's shape: the
    all-gathered cotangent of 2 x 128 x 200 Zipf ids (ML-1M's catalog) into
    the second half of its 3,424-row table: bit for bit against the plain
    ordered version, two runs bit for bit; kernel, plain, library
    (index_add_ of the owned rows, selected outside the timing) and bound
    times. The bound counts g and the ids read once and the shard written."""
    ids = torch.from_numpy(zipf_items(rng, n).astype(np.int32)).to(dev)
    g = torch.randn((n, D), device=dev)
    row0 = rows
    got = k_gather.embedding_scatter_add_window(g, ids, row0, rows)
    again = k_gather.embedding_scatter_add_window(g, ids, row0, rows)
    plan = k_gather.scatter_add_plan(n, rows, D)
    want = k_gather.plain_ordered_window(g, ids, row0, rows, plan["chunk"])
    torch.cuda.synchronize()
    check(torch.equal(got, again), "scatter-add window: two runs differ")
    check(torch.equal(got, want), f"scatter-add window: not bit-exact against plain_ordered, "
                                  f"max abs err {max_err(got, want)}")
    local, owned = reference.window_ids(ids, row0, rows)
    l_own, g_own = local[owned], g[owned]
    b = bound(n * D * 4 + n * 4 + rows * D * 4, 0, torch.float32)
    return {
        "shape": {"shard": [rows, D], "row0": row0, "ids": n, "owned_ids": int(owned.sum()),
                  "cotangent_dtype": "float32"},
        "design": "sorted-chunks, shard window", "max_abs_err": 0.0, "bit_exact": True,
        "deterministic": True, "launches_per_call": plan["launches"], "plan": plan,
        "kernel_ms": time_ms(lambda: k_gather.embedding_scatter_add_window(g, ids, row0, rows)),
        "plain_ms": time_ms(lambda: reference.embedding_scatter_add_window(g, ids, row0, rows)),
        "library_ms": time_ms(lambda: torch.zeros((rows, D), device=dev)
                              .index_add_(0, l_own, g_own)),
        "library": "index_add_ of the owned rows",
        "bound_ms": b[0], "bound_by": b[1],
    }


def phase_sharded(dev, seed: int) -> dict:
    """p. Multi-rank execution on the one card: p1 NCCL at world size 1;
    p2 two ranks sharing cuda:0 over gloo (the dense sharded step at ML-1M,
    configs/synthetic10m_sharded.json with its f32 check, and
    configs/rsc15_10m.json, both as shipped at model_axis=2 but for
    P_STEPS steps and temporary directories); p3 the window kernels against
    their plain versions. Under gloo every collective is staged through
    host memory: p2's collective times say nothing of NVLink or NCCL."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_"))
    rng = np.random.default_rng(seed + 14)
    try:
        p1 = _p1_nccl(dev, seed, root)
        t0 = time.perf_counter()
        ranks = _spawn_ranks(root, seed)
        ranks_s = time.perf_counter() - t0
        p2 = sharded_summary(dev, seed, root, ranks)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n_fetch = P_RANKS * 256 * 50 * 2 + 512  # synthetic10m_sharded's global ids a step
    p3 = {"gather_window": {
              _dname(dt): _window_gather_check(rng, dev, 10_000_008 // P_RANKS, n_fetch, 128, dt)
              for dt in (torch.float32, torch.bfloat16)},
          "gather_backward_window": _window_scatter_check(rng, dev, 3424 // P_RANKS,
                                                          P_RANKS * TRAIN_B * TRAIN_T, 128)}
    result = {"phase": "sharded",
              "note": "p2's two ranks share one card over gloo, every collective staged through "
                      "host memory: its collective times say nothing of NVLink or NCCL",
              "p1_nccl_world1": p1, "p2_ranks_seconds": ranks_s,
              "p2_gloo_two_ranks_one_card": ranks, **p2, "p3": p3}
    emit(result)
    return result


def sharded_summary(dev, seed: int, root: Path, ranks: list) -> dict:
    """The one-process checks of p2's ranks (`ranks`: their records, by
    rank; their files under `root`): the global loss and gradient norm of
    every group alike on every rank, the dense group and the f32 sparse
    group against one rank on the global batch."""
    for path in ("synthetic10m", "rsc15_10m"):
        for r in ranks[1:]:
            check(r[path]["losses"] == ranks[0][path]["losses"]
                  and r[path]["grad_norms"] == ranks[0][path]["grad_norms"],
                  f"p2 {path}: rank {r['rank']} logs other global losses than rank 0")
        changed = sum(r[path]["shard_rows_changed"] for r in ranks[:2])
        check(changed > 0, f"p2 {path}: no row of the table changed")
    for r in ranks[1:]:
        check(r["ml100k"]["losses"] == ranks[0]["ml100k"]["losses"]
              and r["ml100k"]["grad_norms"] == ranks[0]["ml100k"]["grad_norms"]
              and r["ml100k"]["eval_test"] == ranks[0]["ml100k"]["eval_test"],
              f"p2 ml100k: rank {r['rank']} logs other global losses or metrics than rank 0")
    world = len(ranks)
    return {"p2_dense_vs_one_rank": _p2_check_dense(dev, seed, root, world),
            "p2_f32_vs_one_rank": _p2_check_f32(dev, root, world),
            "p2_ml100k_vs_one_rank": _p2_check_ml100k(dev, root, world)}


CKPT_STEPS, CKPT_EVERY, CKPT_FAIL_AFTER = 48, 16, 24


def _state_tensors(state) -> dict:
    out = {f"params/{k}": v for k, v in state.params.items()}
    out.update({f"opt/{k}": v for k, v in _opt_leaves(state.opt_state).items()})
    for name, tree in (state.embed_opt or {}).items():
        out.update({f"embed_opt/{name}/{k}": v for k, v in tree.items()})
    if state.carry is not None:
        out.update({f"carry/{i}": c for i, c in enumerate(_leaves(state.carry))})
    return out


def _resume_check(dev, name: str, config: str, root: Path, overrides) -> tuple:
    """A straight CKPT_STEPS-step fit against one killed at CKPT_FAIL_AFTER
    and resumed (checkpoint_every=CKPT_EVERY): every state leaf equal bit
    for bit. Returns (record, the resumed trainer, its final state)."""
    def fit(out: str, *extra):
        cfg = RunConfig.load(config).apply_overrides([
            f"train.num_steps={CKPT_STEPS}", f"train.checkpoint_every={CKPT_EVERY}",
            f"train.out_dir={root / out}", f"data.data_dir={root / 'data'}",
            *overrides, *extra])
        tr = Trainer(cfg, device=dev)
        t0 = time.perf_counter()
        state, _ = tr.fit()
        torch.cuda.synchronize()
        return tr, state, time.perf_counter() - t0

    tr_s, straight, straight_s = fit("straight")
    tr_k, killed, killed_s = fit("resumed", f"train.fail_after_step={CKPT_FAIL_AFTER}")
    tr_r, resumed, resumed_s = fit("resumed", "train.resume=true")
    # The killed run stops at the first group boundary at or past the step.
    check(killed.step >= CKPT_FAIL_AFTER and resumed.step == straight.step == CKPT_STEPS,
          f"resume {name}: steps {killed.step}, {resumed.step}, {straight.step}")
    a, b = _state_tensors(straight), _state_tensors(resumed)
    check(sorted(a) == sorted(b), f"resume {name}: state leaves {sorted(a)} vs {sorted(b)}")
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    check(not differ, f"resume {name}: these leaves differ from the straight run: {differ}")
    check(straight.opt_state["count"] == resumed.opt_state["count"],
          f"resume {name}: optimizer counts differ")
    saves = tr_k.ckpt.saves + tr_r.ckpt.saves
    return {
        "config": config, "overrides": list(overrides), "steps": CKPT_STEPS,
        "checkpoint_every": CKPT_EVERY, "fail_after_step": CKPT_FAIL_AFTER,
        "killed_at_step": killed.step,
        "data_engine": tr_r.data_engine, "leaves_compared": len(a), "bitwise_equal": True,
        "killed_saved_steps": [s["step"] for s in tr_k.ckpt.saves],
        "resumed_saved_steps": [s["step"] for s in tr_r.ckpt.saves],
        "save_bytes": saves[-1]["bytes"],
        "save_host_copy_s": [s["host_copy_s"] for s in saves],
        "save_write_s": [s.get("write_s") for s in saves],
        "fit_seconds": {"straight": straight_s, "killed": killed_s, "resumed": resumed_s},
    }, tr_r, resumed


def _cli_lines(argv) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        check(cli.main(argv) == 0, f"cli {argv[0]} failed")
    return [json.loads(x) for x in out.getvalue().splitlines() if x.strip()]


def phase_checkpoint(dev, seed: int, requests: list) -> dict:
    """o. Checkpoint and resume through `Trainer(cfg).fit()`:
    configs/ml1m_gru4rec.json as shipped but checkpoint_every=16 and 48 steps
    (K=8: saves at 16, 24 where it is killed, then 32 and 48), on synthetic
    ML-1M-shaped data; then configs/rsc15_gru4rec.json (session-parallel:
    the stream's snapshot and its engine) and the sparse step at ML-1M's
    catalog. Each: a killed and resumed run equal to a straight one bit for
    bit. On the first, the `eval` subcommand's metrics equal
    `Trainer.evaluate`'s and `recommend --ckpt` the top-k of `recommend` on
    the in-memory state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    ml1m = ["data.dataset=synthetic", f"data.synthetic_num_items={VOCAB - 1}",
            "data.synthetic_num_users=6040", "data.synthetic_min_len=20",
            "data.synthetic_max_len=201"]
    rsc = SESSION_DATA["rsc15_gru4rec"]
    rsc15 = ["data.dataset=synthetic", f"data.synthetic_num_items={rsc['num_items']}",
             f"data.synthetic_num_users={rsc['num_users']}",
             f"data.synthetic_min_len={rsc['min_len']}",
             f"data.synthetic_max_len={rsc['max_len']}"]
    try:
        runs = {}
        runs["gru4rec"], tr, state = _resume_check(dev, "gru4rec", CONFIGS["gru4rec"],
                                                   root / "gru4rec", ml1m)
        run_cfg = str(Path(tr.cfg.train.out_dir) / "config.json")
        t0 = time.perf_counter()
        ev = _cli_lines(["eval", "--config", run_cfg, "--split", "test",
                         "--device", str(dev)])[-1]
        eval_s = time.perf_counter() - t0
        want = tr.evaluate(state, split="test")
        check(ev == {"step": CKPT_STEPS, "split": "test", **want},
              f"checkpoint: eval subcommand {ev} vs Trainer.evaluate {want}")
        src = root / "requests.jsonl"
        src.write_text("".join(json.dumps(r) + "\n" for r in requests))
        got = _cli_lines(["recommend", "--config", run_cfg, "--input", str(src),
                          "--device", str(dev)])
        model = build_model(tr.cfg.model, tr.ds.vocab_size, device=dev)
        model.load_state_dict(state.params)
        model.eval()
        want = json.loads(json.dumps(list(infer.recommend(
            model, requests, k=10, max_len=tr.cfg.data.max_len))))
        check(got == want, "checkpoint: recommend --ckpt differs from recommend on the "
                           "in-memory state")
        runs["gru4rec"]["cli"] = {"eval": ev, "eval_seconds": eval_s, "eval_equal": True,
                                  "recommend_requests": len(requests), "recommend_equal": True}
        runs["rsc15_gru4rec"] = _resume_check(dev, "rsc15_gru4rec", CONFIGS["rsc15_gru4rec"],
                                              root / "rsc15", rsc15)[0]
        runs["gru4rec_sparse"] = _resume_check(dev, "gru4rec sparse", CONFIGS["gru4rec"],
                                               root / "sparse",
                                               ml1m + ["train.sparse_embedding_update=true"])[0]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    result = {"phase": "checkpoint", "runs": runs}
    emit(result)
    return result


# ---- r. resharding on restore ------------------------------------------------

R_RANKS = 2  # phase r's writer ranks, both on cuda:0 over gloo (as p2)
R_STEPS = 24  # the 2-rank fit, and the resumed one-process fit after it
R_GROUP_STEPS = 8  # r2 and r3's writer fits: one K=8 group
R_EVAL_TOL = 1e-5  # f32 metric sums over two ranks against one process (as p2's eval)
RSS_SAMPLE_S = 0.0005  # the resident set's sampling period during a restore
ML1M_DATA = ["data.dataset=synthetic", f"data.synthetic_num_items={VOCAB - 1}",
             "data.synthetic_num_users=6040", "data.synthetic_min_len=20",
             "data.synthetic_max_len=201"]
RSC15_DATA = ["data.dataset=synthetic"] + [
    f"data.synthetic_{k}={v}" for k, v in SESSION_DATA["rsc15_gru4rec"].items()]
R1_SETS = ["mesh.model_axis=2", "mesh.shard_embeddings=true"]  # the writer's mesh: 1 x 2
R1_ONE = ["mesh.model_axis=1", "mesh.shard_embeddings=true"]  # the reader's: 1 x 1
R2_SETS = ["mesh.model_axis=1", "mesh.shard_embeddings=false"]  # 2 x 1 writes, 1 x 1 reads


def _r_cfg(run: str, root: Path, *sets) -> RunConfig:
    """Phase r's run `run` under `root`: r1 and r2 configs/ml1m_gru4rec.json
    on synthetic ML-1M-shaped data, r3 configs/rsc15_gru4rec.json on
    synthetic RSC15-shaped sessions, eval off, a log line a group."""
    config, data = ((CONFIGS["rsc15_gru4rec"], RSC15_DATA) if run == "r3"
                    else (CONFIGS["gru4rec"], ML1M_DATA))
    return RunConfig.load(config).apply_overrides([
        *data, f"data.data_dir={root / 'data' / Path(config).stem}",
        f"train.out_dir={root / run}", "train.eval_every=0", "train.log_every=8", *sets])


def r_rank(rank: int, root: Path, seed: int) -> int:
    """One of phase r's writer ranks (`--r-rank`), on cuda:0 over gloo: r1
    the 2-rank sharded fit (1 x 2, R_STEPS steps, a checkpoint at the end)
    and that checkpoint's full-protocol eval in f32 on the two ranks; r2 a
    K=8 group at 2 x 1 with the tables whole; r3 a K=8 group of the
    session-parallel rsc15_gru4rec at 2 x 1. Writes rank<r>.json."""
    timeout = datetime.timedelta(seconds=P_COLLECTIVE_TIMEOUT_S)
    dev = init_distributed(f"file://{root / 'store'}", R_RANKS, rank, backend="gloo",
                           device="cuda:0", timeout=timeout)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sharded, whole = make_mesh(2), make_mesh(1)
        if rank == 0:  # prepared once, read by every rank
            load_dataset(_r_cfg("r1", root).data)
            load_dataset(_r_cfg("r3", root).data)
        sharded.barrier()
        out = {"rank": rank}
        cfg = _r_cfg("r1", root, *R1_SETS, f"train.num_steps={R_STEPS}",
                     f"train.checkpoint_every={R_STEPS}")
        tr = Trainer(cfg, device=dev, mesh=sharded)
        t0 = time.perf_counter()
        state, _ = tr.fit()
        torch.cuda.synchronize()
        out["r1_fit_seconds"] = time.perf_counter() - t0
        out["r1_shard_rows"] = int(state.params["item_embedding"].shape[0])
        del state, tr
        tr = Trainer(cfg.apply_overrides([F32]), device=dev, mesh=sharded)
        state = tr.checkpoint_manager(str(root / "r1" / "ckpt")).restore(
            tr.abstract_state(), device=dev)[0]
        out["r1_eval_f32"] = tr.evaluate(state, split="test")
        del state, tr
        for run, sets in (("r2", R2_SETS), ("r3", ())):
            cfg = _r_cfg(run, root, *sets, f"train.num_steps={R_GROUP_STEPS}",
                         f"train.checkpoint_every={R_GROUP_STEPS}")
            tr = Trainer(cfg, device=dev, mesh=whole)
            state, _ = tr.fit()
            out[f"{run}_step"] = int(state.step)
            del state, tr
        torch.cuda.empty_cache()
        (root / f"rank{rank}.json").write_text(json.dumps(out))
        sharded.barrier()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    shutdown()
    return 0


def _host_rss_bytes() -> int:
    """This process's resident set now (/proc/self/status VmRSS)."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) * 1024
    return -1


class _RssPeak:
    """The largest resident set sampled every RSS_SAMPLE_S while the block
    runs (the card's machine has no VmHWM to reset), with the one before."""

    def __enter__(self):
        self.before = self.peak = _host_rss_bytes()
        self._stop = threading.Event()

        def sample():
            while not self._stop.is_set():
                self.peak = max(self.peak, _host_rss_bytes())
                self._stop.wait(RSS_SAMPLE_S)

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _host_rss_bytes())
        return False


def _timed_restore(tr: Trainer, ckpt: Path, dev) -> tuple:
    """`restore` of the newest checkpoint under `ckpt` into `tr`'s state:
    the state, and its seconds, bytes read, the host's resident set before
    it and its sampled peak during it."""
    mgr = tr.checkpoint_manager(str(ckpt))
    abstract = tr.abstract_state()
    with _RssPeak() as rss:
        t0 = time.perf_counter()
        state, step, pos, _ = mgr.restore(abstract, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    rec = mgr.restores[-1]
    return state, {"step": step, "data_position": pos, "seconds": seconds,
                   "bytes_read": rec["bytes_read"], "leaves": rec["leaves"],
                   "writer_mesh": rec["writer_mesh"], "host_rss_before_bytes": rss.before,
                   "host_rss_peak_bytes": rss.peak,
                   "host_rss_peak_above_before_bytes": rss.peak - rss.before,
                   "rss_sample_s": RSS_SAMPLE_S}


def _rank_parts(step_dir: Path, world: int) -> list:
    """Each writer rank's part of a checkpoint, by `_state_tensors`'s keys."""
    out = []
    for r in range(world):
        rest = torch.load(step_dir / f"state.rank{r}.pt", weights_only=True)
        out.append(_state_tensors(TrainState(
            step=0, params=torch.load(step_dir / f"params.rank{r}.pt", weights_only=True),
            opt_state=rest["opt_state"], rng_seed=0, carry=rest["carry"],
            embed_opt=rest["embed_opt"])))
    return out


def _bitwise_restored(name: str, state, parts: list, sharded: set) -> int:
    """Every leaf of the restored `state` equal bit for bit to the writer
    ranks' parts put together (a row-sharded leaf: the model ranks' rows in
    order; any other: rank 0's, alike on every rank). Returns the count."""
    got = {k: v.cpu() for k, v in _state_tensors(state).items()}
    check(sorted(got) == sorted(parts[0]), f"{name}: leaves {sorted(got)} vs {sorted(parts[0])}")
    for k, v in got.items():
        owner = k.rsplit("/", 1)[-1] if not k.startswith("embed_opt/") else k.split("/")[1]
        if owner in sharded:
            want = torch.cat([p[k] for p in parts])
        else:
            for p in parts[1:]:
                check(torch.equal(p[k], parts[0][k]), f"{name}: {k} differs between ranks")
            want = parts[0][k]
        check(want.dtype == v.dtype and torch.equal(want, v),
              f"{name}: {k} is not the writer's bit for bit")
    return len(got)


def _logged(out_dir: Path, since_step: int) -> list:
    """The train lines of `out_dir`/metrics.jsonl past `since_step`."""
    lines = [json.loads(x) for x in (out_dir / "metrics.jsonl").read_text().splitlines()]
    return [x for x in lines if x["tag"] == "train" and x["step"] >= since_step]


def phase_reshard(dev, seed: int, requests: list) -> dict:
    """r. Resharding on restore: checkpoints written by two ranks sharing
    cuda:0 over gloo (`--r-rank`), read by this one process on the 1 x 1
    mesh. r1: configs/ml1m_gru4rec.json at full width with
    mesh.model_axis=2 and mesh.shard_embeddings (1,712-row shards of the
    3,424-row padded table), R_STEPS steps in bf16, a checkpoint at the end,
    restored at 1 x 1 (padded alike): every leaf the two ranks' parts put
    together, bit for bit; the `eval` subcommand in f32 on it against the
    two ranks' f32 eval (R_EVAL_TOL relative); `recommend --ckpt` of it for
    the 320 requests; then R_STEPS more steps resumed from it through the
    kernels (counters zeroed just before, read just after): finite losses,
    the last group's below the first's, each kernel's launches. r2: the
    same config with the tables whole written at 2 x 1, restored bit for
    bit, one K=8 group from it. r3: configs/rsc15_gru4rec.json
    (session-parallel) written at 2 x 1: restored by one process, the
    ValueError naming the carry and both global shapes. Each restore's
    seconds, bytes read and host resident set (before, sampled peak)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_reshard_"))
    rng = np.random.default_rng(seed + 16)
    phase_t0 = time.perf_counter()
    try:
        t0 = time.perf_counter()
        ranks = _spawn_ranks(root, seed, role="r", world=R_RANKS)
        ranks_s = time.perf_counter() - t0
        # r1: the 1 x 2 checkpoint at 1 x 1, resumed for R_STEPS more steps.
        cfg = _r_cfg("r1", root, *R1_ONE, f"train.num_steps={2 * R_STEPS}",
                     f"train.checkpoint_every={R_STEPS}", "train.resume=true")
        tr = Trainer(cfg, device=dev)
        ckpt = root / "r1" / "ckpt"
        check(json.loads((ckpt / str(R_STEPS) / "meta.json").read_text())["mesh"] == {
            "data": 1, "model": 2}, "r1: the checkpoint is not the 1 x 2 mesh's")
        state, r1_restore = _timed_restore(tr, ckpt, dev)
        check(r1_restore["step"] == R_STEPS and state.params["item_embedding"].shape[0] ==
              tr.model.table_size == 2 * ranks[0]["r1_shard_rows"],
              f"r1: restored step {r1_restore['step']}, table "
              f"{tuple(state.params['item_embedding'].shape)}")
        leaves = _bitwise_restored("r1", state, _rank_parts(ckpt / str(R_STEPS), R_RANKS),
                                   {"item_embedding"})
        del state
        run_cfg = str(root / "r1" / "config.json")  # the writer's, model_axis 2
        t0 = time.perf_counter()
        ev = _cli_lines(["eval", "--config", run_cfg, "--set", "mesh.model_axis=1",
                         "--set", F32, "--split", "test", "--device", str(dev)])[-1]
        eval_s = time.perf_counter() - t0
        want = ranks[0]["r1_eval_f32"]
        check(ranks[1]["r1_eval_f32"] == want, "r1: the two ranks' evals differ")
        check(ev.pop("step") == R_STEPS and ev.pop("split") == "test" and sorted(ev) ==
              sorted(want), f"r1: eval subcommand {ev}")
        eval_err = max(abs(ev[k] - v) / max(abs(v), 1e-12) for k, v in want.items())
        check(eval_err <= R_EVAL_TOL and want["count"] > 0,
              f"r1: eval at 1 x 1 {ev} vs the two ranks' {want} ({eval_err:.3g} relative)")
        src = root / "requests.jsonl"
        src.write_text("".join(json.dumps(r) + "\n" for r in requests))
        t0 = time.perf_counter()
        recs = _cli_lines(["recommend", "--config", run_cfg, "--set", "mesh.model_axis=1",
                           "--ckpt", str(ckpt), "--input", str(src), "--device", str(dev)])
        rec_s = time.perf_counter() - t0
        check(len(recs) == len(requests) and all(
            len(r["items"]) == K and np.isfinite(r["scores"]).all() for r in recs),
            f"r1: recommend --ckpt answered {len(recs)} of {len(requests)}")
        probe = _GroupProbe(tr)
        zero_counters()
        t0 = time.perf_counter()
        state, _ = tr.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = read_counters()
        probe.close()
        run = probe.read()
        steps = sum(probe.steps)
        losses = [m["loss"] for m in run["metrics"]]
        check(state.step == 2 * R_STEPS and steps == R_STEPS,
              f"r1: the resumed fit stopped at {state.step} after {steps} steps")
        check(all(np.isfinite(m["loss"]) and not m["nonfinite"] for m in run["metrics"]),
              f"r1: non-finite metrics {run['metrics']}")
        # A group is K=8 steps; bucket changes split fit's calls into single
        # steps, so each group's loss is the mean over its steps' calls.
        per_step = np.repeat(losses, probe.steps)
        groups = per_step.reshape(-1, cfg.train.steps_per_call).mean(axis=1)
        check(groups[-1] < groups[0], f"r1: the group loss did not fall ({groups.tolist()})")
        want_l = {k: v * steps for k, v in expected_launches(cfg, training=True).items()}
        check(launches == want_l, f"r1: kernel launches {launches}, expected {want_l}")
        logged = _logged(root / "r1", R_STEPS)
        del state, tr
        torch.cuda.empty_cache()
        # r2: tables whole, written at 2 x 1, read at 1 x 1; one K=8 group.
        cfg = _r_cfg("r2", root, *R2_SETS)
        tr = Trainer(cfg, device=dev)
        state, r2_restore = _timed_restore(tr, root / "r2" / "ckpt", dev)
        r2_leaves = _bitwise_restored(
            "r2", state, _rank_parts(root / "r2" / "ckpt" / str(R_GROUP_STEPS), R_RANKS), set())
        group = _on_device(_train_wires(rng, tr, 1, 8, TRAIN_B, TRAIN_T)[0], dev)
        zero_counters()
        state, m = tr.train_step_multi(state, group)
        torch.cuda.synchronize()
        r2_launches = read_counters()
        check(np.isfinite(float(m["loss"])) and state.step == R_GROUP_STEPS + 8,
              f"r2: group from the restored state: loss {float(m['loss'])}, step {state.step}")
        want_l = {k: v * 8 for k, v in expected_launches(cfg, training=True).items()}
        check(r2_launches == want_l, f"r2: kernel launches {r2_launches}, expected {want_l}")
        del state, tr
        # r3: the session carry of two ranks refused by one process.
        tr = Trainer(_r_cfg("r3", root), device=dev)
        B, H = tr.cfg.data.batch_size, tr.cfg.model.hidden
        msg = None
        try:
            tr.checkpoint_manager(str(root / "r3" / "ckpt")).restore(tr.abstract_state(), dev)
        except ValueError as e:
            msg = str(e)
        shapes = f"/carry/0 ({R_RANKS * B}, {H}) bfloat16 vs ({B}, {H}) bfloat16"
        check(msg is not None and shapes in msg and "mesh of 2 x 1" in msg,
              f"r3: the restore did not refuse the carry as '{shapes}': {msg}")
        del tr
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    result = {
        "phase": "reshard",
        "note": "the writers are two ranks sharing cuda:0 over gloo; every restore is by this "
                "one process at 1 x 1, its bytes read and host peak on the card's host",
        "seconds": time.perf_counter() - phase_t0, "ranks_seconds": ranks_s, "ranks": ranks,
        "r1": {"config": CONFIGS["gru4rec"], "writer": R1_SETS, "reader": R1_ONE,
               "restore": r1_restore, "leaves_bit_equal": leaves,
               "eval_f32_1x1": ev, "eval_f32_two_ranks": want, "eval_rel_err": eval_err,
               "eval_seconds": eval_s, "recommend_requests": len(recs),
               "recommend_seconds": rec_s, "resumed_steps": steps, "resumed_fit_seconds": fit_s,
               "losses": losses, "group_losses": groups.tolist(),
               "step_ms_median": float(np.median(run["step_ms"])),
               "examples_per_s": [x["examples_per_s"] for x in logged],
               "launches": launches},
        "r2": {"config": CONFIGS["gru4rec"], "writer": R2_SETS, "restore": r2_restore,
               "leaves_bit_equal": r2_leaves, "group_loss": float(m["loss"]),
               "launches": r2_launches},
        "r3": {"config": CONFIGS["rsc15_gru4rec"], "refused": msg},
    }
    emit(result)
    return result


# ---------------------------------------------------------------------------
# s. The `benchmark` subcommand and its runner
# ---------------------------------------------------------------------------

S_STEPS = 96  # s1 and s2's chains: 96 and 288 steps (12 and 36 groups of 8)
S_WARMUP = 5
S_PIPE_REPS = 5  # s2's alternated reps (run_pipeline_alternating's default)
# s3 and s4's chains, shorter: each config's own step rate makes the long
# chain outlast the short one by well over 0.05 s.
S_SHORT_STEPS = {"beauty_gru": 48, "rsc15_gru4rec": 48, "synthetic10m_singlechip": 32}
# configs/beauty_gru.json's step: B=128, its longest bucket T=50, D=H=256.
BEAUTY_T, BEAUTY_D = 50, 256
# s3's edges of the bf16 GRU cluster layouts (Hp > 128), (B, T, H, reset):
# serving's batch, a ragged cluster, beauty's short buckets, a width that
# pads (200 -> 208, units and k to 256) and, at beauty's width, the reset
# variant, whose reverse takes h_in in f32 on the keep path.
WIDE_EDGES = ((64, 50, 256, False), (3, 50, 256, False), (128, 10, 256, False),
              (128, 20, 256, False), (128, 50, 200, False), (128, 50, 256, True))
# s3's step 1, kernels vs plain at beauty's width (relative). At init the
# sampled-softmax loss sits near its uniform value whatever the tower
# gives, so its gap is ~1e-7 (2.3e-7 read, H100); the gradient norm's
# ~1e-3 (7.1e-4 read). Both well under phase f's limits, which a fault in
# the units past 128 could pass; s3's planted faults show these catch it.
S3_STEP1_LOSS_TOL = 1e-5
S3_STEP1_NORM_TOL = 5e-3
# The key set of the runner's line (the JAX runner's, benchmarks/throughput.py).
S_KEYS = ("backend", "chain_long_s", "chain_short_s", "examples_per_s",
          "examples_per_s_per_chip", "global_batch", "host_load_1m", "num_devices",
          "reliable", "seq_len", "slopes_ms", "spread_ms", "spread_pct", "step_time_ms",
          "steps", "warmup_s")


class _ChainCounter:
    """Wraps the runner's `chain_slope_ms`: the counters are zeroed just
    before the timed chains and read just after, with the steps they ran
    (each rep: a seed step and n_short steps, a seed step and n_long)."""

    def __init__(self):
        self.launches, self.steps = None, 0
        self._real = throughput.chain_slope_ms

    def __enter__(self):
        def counted(step, seed, n_short=50, n_long=150, reps=4):
            zero_counters()
            out = self._real(step, seed, n_short=n_short, n_long=n_long, reps=reps)
            self.launches = read_counters()
            self.steps = reps * (n_short + 1 + n_long + 1)
            return out

        throughput.chain_slope_ms = counted
        return self

    def __exit__(self, *exc):
        throughput.chain_slope_ms = self._real


def _s_benchmark(name: str, config: str, steps: int, want_per_step: dict, card: str,
                 sets=()) -> dict:
    """`python -m seqrec_tpu_torch benchmark --config config --steps steps
    --warmup S_WARMUP` in this process: one line of exactly S_KEYS on the
    card, a finite positive step time, `reliable`, and each kernel's
    launches a step of the timed chains equal to `want_per_step`."""
    argv = ["benchmark", "--config", config, "--steps", str(steps),
            "--warmup", str(S_WARMUP), *[a for s in sets for a in ("--set", s)]]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _ChainCounter() as chains:
        lines = _cli_lines(argv)
    wall_s = time.perf_counter() - t0
    check(len(lines) == 1, f"benchmark {name}: {len(lines)} lines printed")
    res = lines[0]
    check(tuple(sorted(res)) == S_KEYS, f"benchmark {name}: keys {sorted(res)}")
    check(res["backend"] == "cuda", f"benchmark {name}: backend {res['backend']}")
    ms = res["step_time_ms"]
    check(bool(np.isfinite(ms)) and ms > 0 and res["reliable"],
          f"benchmark {name}: step_time_ms {ms}, reliable {res['reliable']}, "
          f"slopes {res['slopes_ms']}")
    check(res["examples_per_s"] == res["global_batch"] / (ms / 1e3)
          and res["num_devices"] == 1, f"benchmark {name}: {res}")
    want = {k: v * chains.steps for k, v in want_per_step.items()}
    check(chains.launches == want,
          f"benchmark {name}: launches over the timed chains {chains.launches}, expected {want}")
    return {"card": card, "config": config, "sets": list(sets), "argv": argv, "result": res,
            "wall_s": wall_s, "chain_steps": chains.steps, "launches": chains.launches,
            "launches_per_step": {k: v / chains.steps for k, v in chains.launches.items()},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _beauty_kernel_checks(rng, dev) -> dict:
    """s3's kernels in bf16 at configs/beauty_gru.json's step (B=128, its
    longest bucket T=50, D=H=256, S=256 over N=B*T rows), where the GRU
    forward and reverse take their cluster layouts (Hp > 128: W_h split
    between the CTAs of a thread block cluster) and the head pads H to 256:
    each against its plain version with its own tolerance, as phases c and
    e hold them at D=H=128 and 64. Layer 2 takes layer 1's [B, T, 256]
    output, the same shapes."""
    B, T, D = TRAIN_B, BEAUTY_T, BEAUTY_D
    table = torch.from_numpy(rng.normal(scale=D ** -0.5, size=(VOCAB, D))
                             .astype(np.float32)).to(dev)
    ids = torch.from_numpy(zipf_items(rng, B * T).reshape(B, T).astype(np.int32)).to(dev)
    x32 = k_gather.plain(table, ids)
    weights = [w.to(dev) for w in gru_weights(rng, D, D)]
    bf16 = torch.bfloat16
    return {
        "gru_scan": _gru_forward_check(dev, x32, weights, torch.zeros(B, D, device=dev), bf16),
        "gru_xproj": _xproj_check(k_gru, k_gru.gru_input_projection, x32, weights[0],
                                  weights[2]),
        "gru_backward": _gru_backward_checks(rng, dev, x32, dtypes=(bf16,))["bfloat16"],
        "softmax_head": _head_checks(rng, dev, table, beauty=False, N=B * T,
                                     dtypes=(bf16,))["bfloat16"],
    }


def _wide_edge_checks(rng, dev) -> dict:
    """The bf16 GRU cluster layouts at WIDE_EDGES: the forward against its
    plain version (GRU_BF16_TOL), then the reverse recurrence on that
    forward's projections, h_in as the backward hands it over (bf16, or f32
    scaled by keep on the reset variant's keep path), against its plain
    version (GRU_BWD_TOL relative); each output of each kernel twice, bit
    for bit."""
    bf16 = torch.bfloat16
    out = {}
    for B, T, H, reset in WIDE_EDGES:
        name = f"gru wide B{B} T{T} H{H}" + (" reset" if reset else "")
        x32 = _zipf_embeddings(rng, dev, B, T, H)
        w_x, w_h, b_x, b_h = (w.to(dev) for w in gru_weights(rng, H, H))
        plane = _reset_plane(rng, B, T, dev) if reset else None
        x, h0, wx, wh = x32.to(bf16), _state(rng, dev, B, H).to(bf16), w_x.to(bf16), w_h.to(bf16)
        fargs = (x, h0, wx, wh, b_x, b_h)
        launch = k_gru.launch_config(B, T, H, H, bf16)
        check(launch.get("layout") == "cluster", f"{name}: not the cluster layout: {launch}")
        ys = k_gru.gru_scan(*fargs, reset_mask=plane)[0]
        check(torch.equal(ys, k_gru.gru_scan(*fargs, reset_mask=plane)[0]),
              f"{name}: two forward launches differ")
        f_err = max_err(ys, k_gru.plain(*fargs, reset_mask=plane)[0])
        check(bool(torch.isfinite(ys).all()) and f_err <= GRU_BF16_TOL,
              f"{name}: forward max abs err {f_err} > {GRU_BF16_TOL}")
        with torch.no_grad():
            x_proj = torch.matmul(x.float(), wx.float()) + b_x
            h_in, keep, h_proj = reference.gru_bwd_project(x_proj, ys, h0, wh, b_h, plane)
        g = torch.from_numpy(rng.normal(scale=1e-2, size=(B, T, H)).astype(np.float32)).to(
            dev, bf16)
        planes = (x_proj, h_proj, h_in, g, wh, keep)
        got = k_gru.gru_backward(*planes)
        check(all(torch.equal(a, b) for a, b in zip(got, k_gru.gru_backward(*planes))),
              f"{name}: two reverse launches differ")
        b_errs = {k: rel_err(a, b) for k, a, b in zip(("d_xp", "dh0", "dn_r"), got,
                                                      k_gru.plain_backward(*planes))}
        check(max(b_errs.values()) <= GRU_BWD_TOL,
              f"{name}: reverse relative errs {b_errs} > {GRU_BWD_TOL}")
        out[name.replace(" ", "_")] = {
            "shape": {"B": B, "T": T, "D": H, "H": H, "reset": reset},
            "cluster_size": launch["cluster_size"], "grid": launch["grid"],
            "h_in_dtype": _dname(h_in.dtype), "forward_max_abs_err": f_err,
            "forward_tolerance": GRU_BF16_TOL, "backward_rel_err": b_errs,
            "backward_tolerance": GRU_BWD_TOL, "twice_bit_for_bit": True,
            "forward_ms": time_ms(lambda: k_gru.gru_scan(*fargs, reset_mask=plane))["median"],
            "backward_ms": time_ms(lambda: k_gru.gru_backward(*planes))["median"]}
    return out


def _upper_units_zeroed(t: torch.Tensor, groups: int) -> torch.Tensor:
    """`t` [..., groups * H] with units H/2.. of each of its `groups` gate
    blocks zeroed: what a kernel that dropped the units past 128 would
    hand back at H = 256."""
    v = t.view(*t.shape[:-1], groups, -1)
    v[..., v.shape[-1] // 2:] = 0
    return t


def _step1_faults() -> dict:
    """Planted faults for s3's step 1, each a patch of the GRU wrapper
    module for one step: the forward's output or the reverse's gate
    gradients (d_xp, dn_r) with their upper half of units zeroed."""
    real_fwd, real_bwd = k_gru._forward_kernel, k_gru.gru_backward

    def fwd(*args, **kw):
        return _upper_units_zeroed(real_fwd(*args, **kw), 1)

    def bwd(*args, **kw):
        d_xp, dh0, dn_r = real_bwd(*args, **kw)
        return _upper_units_zeroed(d_xp, 3), dh0, _upper_units_zeroed(dn_r, 1)

    # The wrapper counts its launches under the module's name while it
    # stands in: the planted runs add nothing to the real counters.
    bwd.launches = bwd.reset_launches = bwd.wide_launches = 0

    return {"gru_forward_upper_units_zeroed": ("_forward_kernel", fwd),
            "gru_backward_upper_units_zeroed": ("gru_backward", bwd)}


def _s_step1(dev, seed: int, cfg: RunConfig, name: str) -> dict:
    """One step from one state through the kernels and one through the
    plain versions, on the runner's first staged batch: loss and gradient
    norm within S3_STEP1_*_TOL; no kernel launch in the plain one. Then the
    same step through the kernels under each planted fault
    (`_step1_faults`): the limits must fail every one."""
    ds = throughput.default_dataset(cfg)
    tr = Trainer(cfg, ds, device=dev)
    plain = Trainer(cfg.apply_overrides(["model.use_pallas=false"]), ds, device=dev)
    batch = throughput.stage_batches(tr, 1)[0]
    step1 = {}
    for use_pallas, t in ((True, tr), (False, plain)):
        before = read_counters()
        m = t.train_step(t.init_state(seed), batch)[1]
        step1[use_pallas] = {k: float(v) for k, v in m.items()}
        moved = {k: v - before[k] for k, v in read_counters().items() if v != before[k]}
        check(bool(moved) == use_pallas,
              f"{name}: step 1 {'through the kernels' if use_pallas else 'plain'} "
              f"launched {moved}")
    a, b = step1[True], step1[False]

    def gaps(m: dict) -> tuple:
        return (abs(m["loss"] - b["loss"]) / abs(b["loss"]),
                abs(m["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"]))

    loss_rel, norm_rel = gaps(a)
    check(np.isfinite(a["loss"]) and loss_rel <= S3_STEP1_LOSS_TOL
          and norm_rel <= S3_STEP1_NORM_TOL,
          f"{name}: step-1 loss / grad_norm {a} (kernels) vs {b} (plain)")
    faults = {}
    for fault, (attr, patched) in _step1_faults().items():
        real = getattr(k_gru, attr)
        setattr(k_gru, attr, patched)
        try:
            m = {k: float(v) for k, v in tr.train_step(tr.init_state(seed), batch)[1].items()}
        finally:
            setattr(k_gru, attr, real)
        f_loss, f_norm = gaps(m)
        faults[fault] = {"loss_rel": f_loss, "grad_norm_rel": f_norm,
                         "caught": f_loss > S3_STEP1_LOSS_TOL or f_norm > S3_STEP1_NORM_TOL}
        check(faults[fault]["caught"],
              f"{name}: planted fault {fault} passes the step-1 limits: {faults[fault]}")
    return {"kernels": a, "plain": b, "loss_rel": loss_rel, "grad_norm_rel": norm_rel,
            "loss_tolerance": S3_STEP1_LOSS_TOL, "grad_norm_tolerance": S3_STEP1_NORM_TOL,
            "planted_faults": faults}


def _s_pipeline(dev, fit: dict, card: str) -> dict:
    """s2: `run_pipeline_alternating` at bench.py's configuration, K=8
    against K=1 (Trainer.fit end to end, S_STEPS-step chains, S_PIPE_REPS
    reps, settle on), the counters over all of it; the logger lines of
    each fit call are kept off this script's output."""
    cfgs = {}
    for K in (8, 1):
        cfgs[f"K{K}"] = s_bench_config()
        cfgs[f"K{K}"].train.steps_per_call = K
    zero_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        both = throughput.run_pipeline_alternating(cfgs, steps=S_STEPS, warmup=S_WARMUP,
                                                   reps=S_PIPE_REPS, settle=True, device=dev)
    wall_s = time.perf_counter() - t0
    launches = read_counters()
    steps = len(cfgs) * (S_WARMUP + S_STEPS + S_PIPE_REPS * 4 * S_STEPS)
    want = {k: v * steps for k, v in expected_launches(cfgs["K8"], training=True).items()}
    check(launches == want, f"benchmark s2: launches {launches}, expected {want}")
    for name, res in both.items():
        check(tuple(sorted(res)) == tuple(sorted(S_KEYS + ("loader", "prefetch_depth",
                                                           "settle_s"))),
              f"benchmark s2 {name}: keys {sorted(res)}")
        check(res["backend"] == "cuda" and res["loader"] == "native"
              and bool(np.isfinite(res["step_time_ms"])) and res["reliable"],
              f"benchmark s2 {name}: {res}")
    return {"card": card, "config": "bench.py's GRU4Rec (s_bench_config)", "wall_s": wall_s,
            "K8": both["K8"], "K1": both["K1"], "fit_steps_run": steps, "launches": launches,
            "k8_over_k1_step_ms": both["K8"]["step_time_ms"] / both["K1"]["step_time_ms"],
            "f2_logger_examples_per_s": fit["summary"]}


def phase_benchmark(rng: np.random.Generator, dev, seed: int, card: str, fit: dict) -> dict:
    """s. The `benchmark` subcommand and its runner on the card. s1: the
    subcommand at bench.py's configuration (a temporary config file written
    from the port's `bench_config`), S_STEPS / 3 x S_STEPS-step chains:
    the runner's key set, `backend` cuda, a finite step time, `reliable`,
    and each kernel's launches a step of the timed chains as the training
    path expects (`expected_launches`). s2: `run_pipeline_alternating` of
    the same config, K=8 against K=1 (`_s_pipeline`), beside phase f2's
    logger ex/s. s3: configs/beauty_gru.json (2 GRU layers, D=H=256, buckets
    10/20/50, tied embeddings, S=256, dropout 0.2, bf16): each of its
    kernels against its plain version at its step's shape
    (`_beauty_kernel_checks`), the GRU cluster layouts' edges
    (`_wide_edge_checks`), serving (batch 64, k=10, histories of 5..50 over
    ML-1M's 3,417 items, not Beauty's 12,101) through the kernels against
    the plain path (phase d's checks and limits), step 1 through the kernels
    against the plain versions (S3_STEP1_*_TOL, and planted faults that
    those limits must catch), then the subcommand. s4: the subcommand on configs/rsc15_gru4rec.json
    (session-parallel, BPR-max over 2,048) and on
    configs/synthetic10m_singlechip.json (the sparse step over a
    10,000,001-row table): one `init_state` and a clone a chain, peak device
    memory under two states (table and accumulator) plus 2 GB, and the seed
    state's table and accumulator unchanged by the run (fingerprints)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_benchmark_"))
    out = {"phase": "benchmark", "card": card}
    try:
        bench_file = root / "bench.json"
        bench_file.write_text(s_bench_config().to_json())
        out["s1"] = _s_benchmark("s1 bench.py's config", str(bench_file), S_STEPS,
                                 expected_launches(s_bench_config(), training=True), card)
        emit({"phase": "benchmark_s1", **out["s1"]})
        out["s2"] = _s_pipeline(dev, fit, card)
        emit({"phase": "benchmark_s2", **out["s2"]})

        beauty = "configs/beauty_gru.json"
        cfg = RunConfig.load(beauty)
        kernels = _beauty_kernel_checks(rng, dev)
        emit({"phase": "benchmark_s3_kernels", "card": card, **kernels})
        edges = _wide_edge_checks(rng, dev)
        emit({"phase": "benchmark_s3_wide_edges", "card": card, **edges})
        serve = phase_serve(dev, seed, "beauty_gru", make_requests(rng, cfg.data.max_len))
        step1 = _s_step1(dev, seed, cfg, "s3 beauty_gru")
        out["s3"] = {**_s_benchmark("s3 beauty_gru", beauty, S_SHORT_STEPS["beauty_gru"],
                                    expected_launches(cfg, training=True), card),
                     "step1": step1, "kernels": kernels, "wide_edges": edges, "serve": serve}
        emit({"phase": "benchmark_s3", **out["s3"]})

        rsc15 = CONFIGS["rsc15_gru4rec"]
        out["s4_rsc15_gru4rec"] = _s_benchmark(
            "s4 rsc15_gru4rec", rsc15, S_SHORT_STEPS["rsc15_gru4rec"],
            expected_launches(RunConfig.load(rsc15), training=True), card)
        emit({"phase": "benchmark_s4_rsc15_gru4rec", **out["s4_rsc15_gru4rec"]})

        big = "configs/synthetic10m_singlechip.json"
        cfg = RunConfig.load(big)
        seeds = []
        real_init = Trainer.init_state

        def init_state(self, seed=None):
            t0 = time.perf_counter()
            state = real_init(self, seed)
            torch.cuda.synchronize()
            opt = state.embed_opt["item_embedding"]
            seeds.append({"state": state, "init_s": time.perf_counter() - t0,
                          "table_fp": _fingerprint(state.params["item_embedding"]),
                          "opt_fp": {k: _fingerprint(v) for k, v in opt.items()}})
            return state

        Trainer.init_state = init_state
        try:
            run = _s_benchmark("s4 synthetic10m_singlechip", big,
                               S_SHORT_STEPS["synthetic10m_singlechip"],
                               expected_sparse_launches(cfg), card)
        finally:
            Trainer.init_state = real_init
        check(len(seeds) == 1, f"s4 synthetic10m: init_state ran {len(seeds)} times")
        seed0 = seeds.pop()
        state = seed0.pop("state")
        table = state.params["item_embedding"]
        opt = state.embed_opt["item_embedding"]
        state_bytes = sum(t.numel() * t.element_size() for t in (table, *opt.values()))
        limit_gb = (2 * state_bytes + SPARSE_MEM_SLACK) / 1e9
        check(run["peak_gb"] < limit_gb,
              f"s4 synthetic10m: peak {run['peak_gb']:.3f} GB >= {limit_gb:.3f}")
        unchanged = (torch.equal(_fingerprint(table), seed0["table_fp"])
                     and all(torch.equal(_fingerprint(v), seed0["opt_fp"][k])
                             for k, v in opt.items()))
        check(unchanged, "s4 synthetic10m: the seed state's table or accumulator changed")
        out["s4_synthetic10m_singlechip"] = {
            **run, "init_s": seed0["init_s"], "state_gb": state_bytes / 1e9,
            "peak_limit_gb": limit_gb, "seed_state_unchanged": True}
        del state, table, opt, seed0
        emit({"phase": "benchmark_s4_synthetic10m_singlechip",
              **out["s4_synthetic10m_singlechip"]})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - phase_t0
    emit({"phase": "benchmark", "seconds": out["seconds"],
          "examples_per_s": {k: v["result"]["examples_per_s"] for k, v in out.items()
                             if isinstance(v, dict) and "result" in v}})
    return out


# Phase t: the published widths. SASRec as published (Kang & McAuley, ICDM
# 2018: d = 50, 2 blocks, 1 head, n = 200) is configs/ml1m_sasrec.json with
# its d set to 50; GRU4Rec's 100 units (configs/rsc15_gru4rec.json's width)
# under configs/ml1m_gru4rec.json's sampled softmax.
D50, D100 = 50, 100
D50_SET, D100_SET = f"model.embed_dim={D50}", f"model.embed_dim={D100}"


def _widths_kernel_checks(rng, dev) -> dict:
    """The slice's kernels at SASRec d = 50's shapes, and the head at
    GRU4Rec's H = 100: the gather from a [3418, 50] f32 table at training's
    [128, 200] and serving's [64, 200] ids into bf16 and f32 (bit for bit,
    NaN rows), its scatter-add at D = 50 (the float-unit path; f32 and bf16
    cotangents), the attention on the block's qkv slices at [128, 200, 1,
    50] in both dtypes, the head at N = 25,600, S = 256, H = 50 in both and
    H = 100 in bf16; each at its phase's limit, with kernel, plain, library
    and bound times (medians of 21 CUDA-event runs)."""
    out = {"gather": {}}
    for shape in ((TRAIN_B, TRAIN_T), (B, TRAIN_T)):
        for dtype in (torch.bfloat16, torch.float32):
            rec = _gather_check(rng, dev, D50, shape, dtype)
            rec["launch"] = k_gather.launch_config(D50, torch.float32, dtype)
            out["gather"][_gather_key(D50, shape, dtype)] = rec
    table = torch.from_numpy(rng.normal(scale=D50 ** -0.5, size=(VOCAB, D50))
                             .astype(np.float32)).to(dev)
    # The profiler's count of its device operations is phase e's (the
    # launches do not depend on D): after phase f2's scheduled profiler
    # (train.profile_dir) it recorded none for one call's window on an H100,
    # where phase t run alone counted 2.
    out["gather_backward"] = _scatter_add_check(rng, dev, table, count_ops=False)
    check(out["gather_backward"]["plan"]["unit"] == "float",
          f"scatter-add D={D50}: plan {out['gather_backward']['plan']}")
    out["causal_attention"] = _attention_checks(rng, dev, Dh=D50, sliced=True)
    out["softmax_head"] = _head_checks(rng, dev, table, beauty=False)
    table100 = torch.from_numpy(rng.normal(scale=D100 ** -0.5, size=(VOCAB, D100))
                                .astype(np.float32)).to(dev)
    out[f"softmax_head_H{D100}"] = _head_checks(rng, dev, table100, beauty=False,
                                                dtypes=(torch.bfloat16,))
    return out


def phase_widths(rng: np.random.Generator, dev, seed: int, card: str,
                 requests: list) -> dict:
    """t. The published widths through the normal entry points: the
    kernels at their shapes (`_widths_kernel_checks`); SASRec d = 50 served
    (phase h: 320 requests, batch 64, k = 10, within SCORE_TOL of the plain
    path in bf16, F32_SCORE_TOL in f32) and trained (phases i and l: three
    K = 8 groups, warmup 0, step 1 within phase f's limits of the plain
    versions, the loss falls, each kernel's launches a step as expected) in
    bf16 and f32; one K = 8 group and a second of GRU4Rec at D = H = 100
    under the sampled softmax (bf16), with the same checks."""
    phase_t0 = time.perf_counter()
    kernels = _widths_kernel_checks(rng, dev)
    emit({"phase": "widths_kernels", "card": card, **kernels})
    serve = {"sasrec_d50": phase_serve(dev, seed, "sasrec", requests, overrides=[D50_SET]),
             "sasrec_d50_f32": phase_serve(dev, seed, "sasrec", requests,
                                           overrides=[D50_SET, F32])}
    train = {"sasrec_d50": phase_train(rng, dev, seed, "sasrec", groups=3,
                                       overrides=[D50_SET, "train.warmup_steps=0"]),
             "sasrec_d50_f32": phase_train(rng, dev, seed, "sasrec", groups=3,
                                           overrides=[D50_SET, F32, "train.warmup_steps=0"]),
             "gru4rec_d100": phase_train(rng, dev, seed, "gru4rec", groups=2,
                                         overrides=[D100_SET])}
    seconds = time.perf_counter() - phase_t0
    emit({"phase": "widths", "card": card, "seconds": seconds,
          "serve": {k: {"requests_per_s": v["requests_per_s"],
                        "max_score_diff_vs_plain": v["max_score_diff_vs_plain"],
                        "score_tolerance": v["score_tolerance"], "launches": v["launches"]}
                    for k, v in serve.items()},
          "train": {k: {"examples_per_s": v["examples_per_s"],
                        "step_ms_median": v["step_ms_median"], "step1": v["step1"],
                        "launches_per_step": v["launches_per_step"]}
                    for k, v in train.items()}})
    return {"kernels": kernels, "serve": serve, "train": train, "seconds": seconds}


def _widths_entries(widths: dict) -> dict:
    """{kernels-line name: [records]}: each kernel's numbers at the
    published widths, with its launches a step on that width's training
    path."""
    k, train = widths["kernels"], widths["train"]
    g = k["gather"]

    def rec(r, path, counter, what):
        return {"at": what, "shape": r["shape"], "launch": r.get("launch"),
                "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"]["median"],
                "plain_ms": r["plain_ms"]["median"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": _median(r.get("library_ms")),
                "library": r.get("library", r.get("library_backend")),
                "partial_yardstick_matmul_ms": _median(r.get("partial_yardstick_matmul_ms")),
                "launches_per_step": train[path]["launches_per_step"][counter],
                "launches_counted_on": " ".join(["train", train[path]["config"],
                                                 *train[path]["overrides"]])}

    bf, f32 = torch.bfloat16, torch.float32
    sas = f"sasrec d={D50}"
    return {
        "gather": [rec(g[_gather_key(D50, (TRAIN_B, TRAIN_T), bf)], "sasrec_d50", "gather", sas)],
        "gather_f32": [rec(g[_gather_key(D50, (TRAIN_B, TRAIN_T), f32)], "sasrec_d50_f32",
                           "gather", sas)],
        "gather_backward": [rec(k["gather_backward"]["bf16_cotangent"], "sasrec_d50",
                                "gather_backward", sas)],
        "gather_backward_f32": [rec(k["gather_backward"], "sasrec_d50_f32", "gather_backward",
                                    sas)],
        "causal_attention": [rec(k["causal_attention"]["bfloat16"], "sasrec_d50",
                                 "causal_attention", sas)],
        "causal_attention_f32": [rec(k["causal_attention"]["float32"], "sasrec_d50_f32",
                                     "causal_attention", sas)],
        "softmax_head": [rec(k["softmax_head"]["bfloat16"], "sasrec_d50", "softmax_head", sas),
                         rec(k[f"softmax_head_H{D100}"]["bfloat16"], "gru4rec_d100",
                             "softmax_head", f"gru4rec D=H={D100}")],
        "softmax_head_f32": [rec(k["softmax_head"]["float32"], "sasrec_d50_f32",
                                 "softmax_head", sas)],
    }


# Phase u: above H = 256, the GRU's grid layouts and the head's K split.
# The JAX package's wide GRU4Rec (benchmarks/shapes.py:70-72,
# gru4rec_D512_B256_T200_S512), built by the port's own bench_config:
WIDE_D, WIDE_B, WIDE_T, WIDE_ITEMS, WIDE_NEG = 512, 256, 200, 100_000, 512
# GRU4Rec with its paper's 1,000 hidden units (Hidasi et al., ICLR 2016,
# Table 3): configs/rsc15_gru4rec.json at model.embed_dim=1000.
H1000 = 1000
H1000_SET = f"model.embed_dim={H1000}"
# The CLI's run on GRU4Rec-1000: RSC15's session shapes, 10,000 sessions
# (not 100,000: its closing full eval scores every session's test click).
U_CLI_SETS = [H1000_SET, "data.dataset=synthetic", "data.synthetic_num_users=10000",
              *[f"data.synthetic_{k}={v}" for k, v in SESSION_DATA["rsc15_gru4rec"].items()
                if k != "num_users"],
              "train.num_steps=16", "train.log_every=8", "train.eval_every=0",
              "train.checkpoint_every=0"]


def wide_config() -> RunConfig:
    """The wide GRU4Rec as benchmarks/shapes.py:70-72 builds it, through the
    port's bench_config: GRU4Rec, B=256, T=200, D=H=512, 100,000 items,
    sampled softmax over 512 negatives, dropout 0, bf16; K=8 steps a call."""
    cfg = bench_config("gru4rec", batch_size=WIDE_B, max_len=WIDE_T, embed_dim=WIDE_D,
                       num_items=WIDE_ITEMS, loss="sampled_softmax", num_negatives=WIDE_NEG)
    cfg.train.steps_per_call = 8
    return cfg


def _grid_f32_split(rec: dict, project, gates: int, reps: int = REPS) -> None:
    """An f32 grid forward's record (`_gru_forward_check`, `_lstm_checks`)
    gains its step product's plan (`grid_plan`: gru.grid_f32_plan at its
    launch's row group and K, checked to be what the launch holds) and its
    input projection timed alone at its shape (`project`, the cell's input
    projection, on values of that shape: `input_projection_ms`), and the
    median difference, the recurrence (`recurrence_ms`), so that the
    kernel's time splits in two."""
    launch, shape = rec["launch"], rec["shape"]
    check(launch["layout"] == "grid", f"f32 grid forward {shape}: not the grid layout {launch}")
    plan = k_gru.grid_f32_plan(launch["rows_per_group"], launch["k_padded"], gates)
    check({k: launch.get(k) for k in plan} == plan,
          f"f32 grid forward {shape}: its launch {launch} is not the step plan {plan}")
    B, T, D, H = shape["B"], shape["T"], shape["D"], shape["H"]
    g = torch.Generator(device="cuda").manual_seed(B + T + D + H)
    x = torch.randn(B, T, D, device="cuda", generator=g)
    w = torch.randn(D, gates * H, device="cuda", generator=g) * D ** -0.5
    b = torch.zeros(gates * H, device="cuda")
    proj = time_ms(lambda: project(x, w, b), reps=reps)
    rec.update(grid_plan=plan, input_projection_ms=proj,
               recurrence_ms=rec["kernel_ms"]["median"] - proj["median"])


def _wide_kernel_checks(rng, dev) -> dict:
    """The grid layouts and the head's K split against their plain versions
    in bf16 and f32, each launched twice with the same bits: at the wide
    demo's step (B=256, T=200, D=H=512; the head at N=51,200, S=512) the GRU
    forward (nn.GRU beside it), its reverse recurrence and the gradients
    through autograd (cuDNN's backward beside it) and the head (h @ neg.T
    beside it); at rsc15's reset shape with 1,000 units (B=256, T=50) the
    reset variants of both scans, with a carried-in state. Each at its
    phase's limit (c, e, j), with kernel, plain, library and bound times."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtypes = (torch.bfloat16, torch.float32)
    x32 = _zipf_embeddings(rng, dev, WIDE_B, WIDE_T, WIDE_D)
    weights = [w.to(dev) for w in gru_weights(rng, WIDE_D, WIDE_D)]
    h0 = torch.zeros(WIDE_B, WIDE_D, device=dev)
    table = torch.from_numpy(rng.normal(scale=WIDE_D ** -0.5, size=(VOCAB, WIDE_D))
                             .astype(np.float32)).to(dev)
    wide = {"gru_scan": {_dname(dt): _gru_forward_check(dev, x32, weights, h0, dt, twice=True)
                         for dt in dtypes},
            "gru_backward": _gru_backward_checks(rng, dev, x32, twice=True),
            "softmax_head": _head_checks(rng, dev, table, beauty=False, N=WIDE_B * WIDE_T,
                                         S=WIDE_NEG, twice=True)}
    del x32, table
    x32 = _zipf_embeddings(rng, dev, 256, 50, H1000)
    reset = _reset_plane(rng, 256, 50, dev)
    weights = [w.to(dev) for w in gru_weights(rng, H1000, H1000)]
    h32 = _state(rng, dev, 256, H1000)
    rsc15 = {"gru_scan_reset": {_dname(dt): _gru_forward_check(dev, x32, weights, h32, dt, reset,
                                                               twice=True) for dt in dtypes},
             "gru_backward_reset": _gru_backward_checks(rng, dev, x32, reset, twice=True)}
    for rec in [*wide["gru_scan"].values(), *wide["gru_backward"].values(),
                *rsc15["gru_scan_reset"].values(), *rsc15["gru_backward_reset"].values()]:
        check(rec["launch"]["layout"] == "grid", f"phase u: not the grid layout: {rec['launch']}")
    for rec in (wide["gru_scan"]["float32"], rsc15["gru_scan_reset"]["float32"]):
        _grid_f32_split(rec, k_gru.gru_input_projection, 3)
    for rec in wide["softmax_head"].values():
        check(rec["launch"]["layout"] == "k-split", f"phase u: not the K split: {rec['launch']}")
    return {"wide_demo": wide, f"rsc15_h{H1000}": rsc15}


def _wide_cli() -> dict:
    """`python -m seqrec_tpu_torch train --config configs/rsc15_gru4rec.json
    --set model.embed_dim=1000 ...` in this process (U_CLI_SETS: synthetic
    sessions of RSC15's shapes, 16 steps, two K = 8 groups): every logged
    loss finite, the closing full eval's metrics finite, the grid layouts'
    reverse launched once a step and their forward at least once (the eval
    encodes with it too)."""
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["train", "--config", CONFIGS["rsc15_gru4rec"],
                *[a for x in U_CLI_SETS + [f"data.data_dir={tmp}/data", f"train.out_dir={tmp}/run"]
                  for a in ("--set", x)]]
        zero_counters()
        t0 = time.perf_counter()
        lines = _cli_lines(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counters()
    logged = [x for x in lines if "loss" in x]
    final = lines[-1].get("final_test")
    check(bool(logged) and all(np.isfinite(x["loss"]) for x in logged),
          f"cli train {H1000_SET}: logged lines {logged}")
    check(isinstance(final, dict) and all(np.isfinite(v) for v in final.values()),
          f"cli train {H1000_SET}: final line {lines[-1]}")
    check(launches["gru_backward_grid"] == launches["gru_backward_reset"] == 16
          and launches["gru_scan_grid"] >= 16,
          f"cli train {H1000_SET}: launches {launches}")
    return {"argv": [a.replace(tmp, "<tmp>") for a in argv], "seconds": seconds,
            "logged": logged, "final_test": final, "launches": launches}


def phase_wide(rng: np.random.Generator, dev, seed: int, card: str) -> dict:
    """u. Above H = 256 through the normal entry points: the kernels at the
    two paths' shapes (`_wide_kernel_checks`); the wide GRU4Rec (wide_config,
    written to a temporary config file) served (phase d: 320 Zipf histories
    of 5..200 over its 100,000 items, batch 64, k = 10, within
    SCORE_TOL["gru4rec_wide"] of the plain path) and trained, two K = 8
    groups in bf16 and in f32 (phase f's checks: step 1 within its limits of
    the plain versions, the loss falls, each kernel's launches a step as
    expected, the grid layouts' and the K split's included); GRU4Rec-1000
    (configs/rsc15_gru4rec.json, model.embed_dim=1000) trained
    session-parallel, two K = 8 groups with the carry (phase k's checks);
    and the `train` subcommand on it (`_wide_cli`)."""
    phase_t0 = time.perf_counter()
    kernels = _wide_kernel_checks(rng, dev)
    emit({"phase": "wide_kernels", "card": card, **kernels})
    vocab = WIDE_ITEMS + 1
    with tempfile.TemporaryDirectory() as tmp:
        CONFIGS["gru4rec_wide"] = str(Path(tmp) / "gru4rec_wide.json")
        Path(CONFIGS["gru4rec_wide"]).write_text(wide_config().to_json())
        requests = make_requests(rng, WIDE_T, vocab=vocab)
        serve = {"gru4rec_wide": phase_serve(dev, seed, "gru4rec_wide", requests, vocab=vocab)}
        train = {"gru4rec_wide": phase_train(rng, dev, seed, "gru4rec_wide", groups=2,
                                             vocab=vocab),
                 "gru4rec_wide_f32": phase_train(rng, dev, seed, "gru4rec_wide", groups=2,
                                                 overrides=[F32], vocab=vocab)}
    wide_source = ("benchmarks/throughput.py::bench_config(gru4rec, B=256, T=200, D=512, "
                   "100,000 items, sampled_softmax, 512 negatives)")
    for run in (*serve.values(), *train.values()):
        run["config"] = wide_source
    train[f"rsc15_gru4rec_h{H1000}"] = phase_train(rng, dev, seed, "rsc15_gru4rec", groups=2,
                                                   overrides=[H1000_SET])
    cli_run = _wide_cli()
    seconds = time.perf_counter() - phase_t0
    emit({"phase": "wide", "card": card, "seconds": seconds, "cli": cli_run,
          "serve": {k: {"requests_per_s": v["requests_per_s"],
                        "batch_ms_median": v["batch_ms_median"],
                        "encode_device_ms": v["batch_breakdown"]["encode_device_ms"],
                        "max_score_diff_vs_plain": v["max_score_diff_vs_plain"],
                        "score_tolerance": v["score_tolerance"], "launches": v["launches"]}
                    for k, v in serve.items()},
          "train": {k: {"examples_per_s": v["examples_per_s"],
                        "step_ms_median": v["step_ms_median"],
                        "device_step_ms": v["device_step_ms"],
                        "device_idle_share": v["device_idle_share"], "step1": v["step1"],
                        "group_losses": [g["loss"] for g in v["group_metrics"]],
                        "peak_memory_bytes": v["peak_memory_bytes"],
                        "launches_per_step": v["launches_per_step"]}
                    for k, v in train.items()}})
    return {"kernels": kernels, "serve": serve, "train": train, "cli": cli_run,
            "seconds": seconds}


def _split_keys(rec: dict) -> dict:
    """An f32 grid forward's plan and time split (`_grid_f32_split`), for
    the kernels line; nothing for another record."""
    return {k: _median(rec[k]) if k == "input_projection_ms" else rec[k]
            for k in ("grid_plan", "input_projection_ms", "recurrence_ms") if k in rec}


def _wide_entries(wide: dict) -> list:
    """The kernels line's entries of the new layouts: the bf16 ones with
    their launches on the wide demo's bf16 training path, the f32 ones on
    its f32 path, each also at rsc15's reset shape with 1,000 units (the GRU)
    and with its launches on every path of phase u."""
    k, train, serve, cli_run = wide["kernels"], wide["train"], wide["serve"], wide["cli"]
    rsc15 = k[f"rsc15_h{H1000}"]
    out = []
    for kname, counter, source, replaces, recs, at_h1000 in (
            ("gru_scan_grid", "gru_scan_grid", "gru.cu", "gru.py:177",
             k["wide_demo"]["gru_scan"], rsc15["gru_scan_reset"]),
            ("gru_backward_grid", "gru_backward_grid", "gru.cu", "gru.py:190",
             k["wide_demo"]["gru_backward"], rsc15["gru_backward_reset"]),
            ("softmax_head_ksplit", "softmax_head_ksplit", "softmax_head.cu",
             "softmax_head.py:115", k["wide_demo"]["softmax_head"], None)):
        for dtype, path, suffix in (("bfloat16", "gru4rec_wide", ""),
                                    ("float32", "gru4rec_wide_f32", "_f32")):
            rec = recs[dtype]
            extra = _split_keys(rec)
            if at_h1000 is not None:
                r = at_h1000[dtype]
                extra["at_rsc15_h1000_reset"] = {
                    "shape": r["shape"], "launch": r["launch"], "max_abs_err": r["max_abs_err"],
                    "ms": r["kernel_ms"]["median"], "plain_ms": r["plain_ms"]["median"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": _median(r.get("library_ms")),
                    "library": r.get("library"), **_split_keys(r)}
            out.append(_kernel_entry(
                kname + suffix, "seqrec_tpu_torch/csrc/" + source,
                "seqrec_tpu/ops/pallas/" + replaces, train[path]["launches"][counter], rec,
                dtype=dtype, layout=rec["launch"]["layout"], shape=rec["shape"],
                launches_counted_on=f"train {train[path]['config']} "
                                    + " ".join(train[path]["overrides"]),
                launches_by_path={**{f"train_{p}": r["launches"][counter]
                                     for p, r in train.items()},
                                  **{f"serve_{p}": r["launches"][counter]
                                     for p, r in serve.items()},
                                  f"cli_train_rsc15_h{H1000}": cli_run["launches"][counter]},
                **extra))
    return out


# Phase v: above H = 256, the LSTM's grid layouts. The wide LSTM: the JAX
# package's wide_lstm_D512 scan (benchmarks/scan_ab.py:49) in a whole model,
# benchmarks/shapes.py:70-72's arguments (WIDE_*) through the port's
# bench_config with model.cell_type "lstm". Path (ii): configs/ml1m_lstm.json
# session-parallel at model.embed_dim=512 (B=128, T=200, two residual layers).
LSTM_WIDE_SESSION = ["data.session_parallel=true", f"model.embed_dim={WIDE_D}"]
# The wide SASRec: benchmarks/shapes.py:65-68, sasrec_2xD256_B256_T200_S512.
SASREC_WIDE_D = 256


def wide_lstm_config() -> RunConfig:
    """The wide LSTM: wide_config() with model.cell_type "lstm" (one layer,
    B=256, T=200, D=H=512, 100,000 items, 512 sampled negatives, dropout 0,
    bf16; K=8 steps a call)."""
    cfg = wide_config()
    cfg.model.cell_type = "lstm"
    return cfg


def wide_sasrec_config() -> RunConfig:
    """benchmarks/shapes.py:65-68's wide SASRec through the port's
    bench_config: 2 blocks of d = 256, B=256, T=200, 100,000 items, 512
    sampled negatives, dropout 0, bf16; K=8 steps a call."""
    cfg = bench_config("sasrec", batch_size=WIDE_B, max_len=WIDE_T, embed_dim=SASREC_WIDE_D,
                       num_layers=2, num_items=WIDE_ITEMS, loss="sampled_softmax",
                       num_negatives=WIDE_NEG)
    cfg.train.steps_per_call = 8
    return cfg


def _wide_lstm_kernel_checks(rng, dev) -> dict:
    """The LSTM's grid layouts against their plain versions in bf16 and f32
    (phase g's `_lstm_checks`: the forward beside nn.LSTM, the reverse
    recurrence beside cuDNN's backward, the gradients through autograd),
    each launched twice with the same bits: at the wide LSTM's step (B=256,
    T=200, D=H=512) and, the reset variants with a carried-in state, at path
    (ii)'s shape (B=128, T=200, D=H=512)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x32 = _zipf_embeddings(rng, dev, WIDE_B, WIDE_T, WIDE_D)
    wide = _lstm_checks(rng, dev, x32, twice=True)
    del x32
    x32 = _zipf_embeddings(rng, dev, TRAIN_B, TRAIN_T, WIDE_D)
    reset = _lstm_checks(rng, dev, x32, _reset_plane(rng, TRAIN_B, TRAIN_T, dev), twice=True)
    for rec in [*wide["lstm_scan"].values(), *wide["lstm_backward"].values(),
                *reset["lstm_scan"].values(), *reset["lstm_backward"].values()]:
        check(rec["launch"]["layout"] == "grid", f"phase v: not the grid layout: {rec['launch']}")
    for rec in (wide["lstm_scan"]["float32"], reset["lstm_scan"]["float32"]):
        _grid_f32_split(rec, k_lstm.lstm_input_projection, 4)
    return {"wide_lstm": wide, f"ml1m_lstm_h{WIDE_D}_reset": reset}


def phase_wide_lstm(rng: np.random.Generator, dev, seed: int, card: str) -> dict:
    """v. The LSTM above H = 256 through the normal entry points: the
    kernels at the two paths' shapes (`_wide_lstm_kernel_checks`); the wide
    LSTM (wide_lstm_config, written to a temporary config file) served
    (phase d: 320 Zipf histories of 5..200 over its 100,000 items, batch 64,
    k = 10, within SCORE_TOL["lstm_wide"] of the plain path in bf16,
    F32_SCORE_TOL in f32) and trained, two K = 8 groups in bf16 and in f32
    (phase f's checks: step 1 within its limits of the plain versions, the
    loss falls, each kernel's launches a step as expected, the grid
    layouts' and the K split's included); configs/ml1m_lstm.json
    session-parallel at model.embed_dim=512, two K = 8 groups with the carry
    (phase k's checks); and the wide SASRec (wide_sasrec_config), which
    needs no new kernel, served and trained the same way in bf16 and f32."""
    phase_t0 = time.perf_counter()
    kernels = _wide_lstm_kernel_checks(rng, dev)
    emit({"phase": "wide_lstm_kernels", "card": card, **kernels})
    vocab = WIDE_ITEMS + 1
    serve, train = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for path, cfg in (("lstm_wide", wide_lstm_config()),
                          ("sasrec_wide", wide_sasrec_config())):
            CONFIGS[path] = str(Path(tmp) / f"{path}.json")
            Path(CONFIGS[path]).write_text(cfg.to_json())
        requests = make_requests(rng, WIDE_T, vocab=vocab)
        for path in ("lstm_wide", "sasrec_wide"):
            for suffix, overrides in (("", []), ("_f32", [F32])):
                serve[path + suffix] = phase_serve(dev, seed, path, requests, overrides=overrides,
                                                   vocab=vocab)
                train[path + suffix] = phase_train(rng, dev, seed, path, groups=2,
                                                   overrides=overrides, vocab=vocab)
    sources = {"lstm_wide": "benchmarks/throughput.py::bench_config(gru4rec, B=256, T=200, "
                            "D=512, 100,000 items, sampled_softmax, 512 negatives), "
                            "model.cell_type=lstm",
               "sasrec_wide": "benchmarks/throughput.py::bench_config(sasrec, B=256, T=200, "
                              "D=256, 2 blocks, 100,000 items, sampled_softmax, 512 negatives)"}
    for runs in (serve, train):
        for key, run in runs.items():
            run["config"] = sources[key.removesuffix("_f32")]
    train[f"ml1m_lstm_session_h{WIDE_D}"] = phase_train(rng, dev, seed, "lstm", groups=2,
                                                         overrides=LSTM_WIDE_SESSION)
    seconds = time.perf_counter() - phase_t0
    emit({"phase": "wide_lstm", "card": card, "seconds": seconds,
          "serve": {k: {"requests_per_s": v["requests_per_s"],
                        "batch_ms_median": v["batch_ms_median"],
                        "encode_device_ms": v["batch_breakdown"]["encode_device_ms"],
                        "max_score_diff_vs_plain": v["max_score_diff_vs_plain"],
                        "score_tolerance": v["score_tolerance"], "launches": v["launches"]}
                    for k, v in serve.items()},
          "train": {k: {"examples_per_s": v["examples_per_s"],
                        "step_ms_median": v["step_ms_median"],
                        "device_step_ms": v["device_step_ms"],
                        "device_idle_share": v["device_idle_share"], "step1": v["step1"],
                        "group_losses": [g["loss"] for g in v["group_metrics"]],
                        "peak_memory_bytes": v["peak_memory_bytes"],
                        "launches_per_step": v["launches_per_step"]}
                    for k, v in train.items()}})
    return {"kernels": kernels, "serve": serve, "train": train, "seconds": seconds}


def _wide_lstm_entries(wide: dict) -> list:
    """The kernels line's entries of the LSTM's grid layouts: the bf16 ones
    with their launches on the wide LSTM's bf16 training path, the f32 ones
    on its f32 path, each also at path (ii)'s reset shape and with its
    launches on every path of phase v."""
    k, train, serve = wide["kernels"], wide["train"], wide["serve"]
    at_reset = k[f"ml1m_lstm_h{WIDE_D}_reset"]
    out = []
    for kname, key, replaces in (("lstm_scan_grid", "lstm_scan", "lstm.py:153"),
                                 ("lstm_backward_grid", "lstm_backward", "lstm.py:209")):
        for dtype, path, suffix in (("bfloat16", "lstm_wide", ""),
                                    ("float32", "lstm_wide_f32", "_f32")):
            rec, r = k["wide_lstm"][key][dtype], at_reset[key][dtype]
            out.append(_kernel_entry(
                kname + suffix, "seqrec_tpu_torch/csrc/lstm.cu",
                "seqrec_tpu/ops/pallas/" + replaces, train[path]["launches"][kname], rec,
                dtype=dtype, layout=rec["launch"]["layout"], shape=rec["shape"],
                launches_counted_on=f"train {train[path]['config']} "
                                    + " ".join(train[path]["overrides"]),
                launches_by_path={**{f"train_{p}": t["launches"][kname] for p, t in train.items()},
                                  **{f"serve_{p}": v["launches"][kname] for p, v in serve.items()}},
                **_split_keys(rec),
                **{f"at_ml1m_lstm_h{WIDE_D}_reset": {
                    "shape": r["shape"], "launch": r["launch"], "max_abs_err": r["max_abs_err"],
                    "ms": r["kernel_ms"]["median"], "plain_ms": r["plain_ms"]["median"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": _median(r.get("library_ms")), "library": r.get("library"),
                    **_split_keys(r)}}))
    return out


# Phase w: every width the JAX package takes. (w1) One SASRec head of
# d = 512: benchmarks/shapes.py:65-68's wide SASRec at embed_dim=512 (2
# blocks, num_heads 1, B=256, T=200); (w2) d = 50 in the RNN towers:
# configs/ml1m_gru4rec.json and configs/ml1m_lstm.json at model.embed_dim=50,
# the LSTM also session-parallel; (w3) past every grid limit:
# benchmarks/shapes.py:70-72's wide demo at embed_dim=2,304, the GRU cell and
# the LSTM cell.
W_SASREC_D = 512
# Past the cluster layout's 2,048: the Dh-sliced attention's check and path
# (one head of 2,304, w3's width, at a small batch).
W_SLICED_D, W_SLICED_B = 2304, 8
W_WIDE_D = 2304
W_PAD_WIDTHS = (50, 102)  # the padded route's H at D = 50
W_STEP_EDGE = 2302  # past every grid limit and not a multiple of 4
W_REPS = 7  # time_ms's reps in phase w (REPS elsewhere): cuDNN at 2,304 takes ~0.4 s a call
# The step GEMM alone against its plain version and torch.matmul in f32,
# relative to the largest value, by terms: the same exact bf16 products
# summed in f32 in another order, K (forward, up to 2,304) or 2 K (the
# reverse's hi and lo, up to 2 x 9,216) of them; in one partial plane the
# reverse's differed by up to 2.2e-5 on an H100 (kernel_probes.py step_gemm).
STEP_GEMM_TOL = {1: 1e-5, 2: 5e-5}
W_REQUESTS = 128  # w1's and w3's served requests: two batches of 64
W_SERVE_B = 64  # the served batch of w1 and w3
W3_K = 2  # steps a group on the w3 paths (two groups): the step takes ~10^2 ms
# w3's learning rate: Adam's default 1e-3 scaled by 512 / 2,304. Adam moves
# every coordinate by about lr a step, so a logit (a 2,304-term dot of item
# rows of std 2,304^-1/2 and h) moves ~4.5x as far as at the wide demo's
# 512. At 1e-3 the GRU cell's loss jumps at step 4 through the plain versions
# as through the kernels, in bf16 and f32 (lr_curves.py, which runs both).
W3_LR = 1e-3 * 512 / W_WIDE_D
# Serve: the wide SASRec's 5e-2 at d = 64 times sqrt(512 / 64), rounded up;
# the wide demo's 1e-2 at D = 256 times sqrt(2,304 / 256) (2,304-term dots).
SCORE_TOL.update({"sasrec_d512": 1.5e-1, "gru4rec_w2304": 3e-2, "lstm_w2304": 3e-2})
W_LSTM_SESSION = ["data.session_parallel=true", D50_SET]


def w_sasrec_config() -> RunConfig:
    """w1: benchmarks/shapes.py:65-68's SASRec through bench_config at
    embed_dim=512: 2 blocks of one head of d = 512, B=256, T=200, 100,000
    items, 512 sampled negatives, dropout 0, bf16; K=4 steps a call."""
    cfg = bench_config("sasrec", batch_size=WIDE_B, max_len=WIDE_T, embed_dim=W_SASREC_D,
                       num_layers=2, num_items=WIDE_ITEMS, loss="sampled_softmax",
                       num_negatives=WIDE_NEG)
    cfg.train.steps_per_call = 4
    return cfg


def w_wide_config(cell: str) -> RunConfig:
    """w3: the wide demo (wide_config) at embed_dim=2,304 with `cell`;
    W3_K steps a call at W3_LR."""
    cfg = wide_config()
    cfg.model.embed_dim = W_WIDE_D
    cfg.model.cell_type = cell
    cfg.train.steps_per_call = W3_K
    cfg.train.learning_rate = W3_LR
    return cfg


def _records(obj):
    """Every kernel check's record (a dict with a "launch") under `obj`."""
    if isinstance(obj, dict):
        if "launch" in obj:
            yield obj
        else:
            for v in obj.values():
                yield from _records(v)


def _step_gemm_check(rng, dev, B: int, H: int, G: int, terms: int, reps: int) -> dict:
    """The stepped scans' bf16 step GEMM alone (`k_gru.step_gemm`: its
    partial planes) at one step, forward (terms 1: h [B, H] @ W_h [H, G H])
    or reverse (2: the cotangent's hi and lo terms [B, 2 G H] on W_h as
    stored), against its plain version (`plain_step_gemm`, the same split)
    and, summed in split order, torch.matmul in f32 on the same bf16 values
    (reverse: (hi + lo) @ W_h^T, exact in f32), each within STEP_GEMM_TOL
    (by terms) of the largest value; twice bit for bit. The library yardstick is one
    torch.matmul in bf16 on the same operands (bf16 out; the reverse on
    W_h^T stacked twice, built outside the timing). The bound: a and W_h
    read once and the product [B, N] f32 written once (the function's
    output; the partial planes, `workspace_bytes`, are the design's
    traffic, reported apart), 2 B K N terms operations."""
    K, N = (G * H, H) if terms == 2 else (H, G * H)
    w = torch.from_numpy(rng.normal(scale=H ** -0.5, size=(H, G * H)).astype(np.float32))
    w = w.to(dev, torch.bfloat16)
    if terms == 2:
        d = torch.from_numpy(rng.normal(scale=1e-2, size=(B, K)).astype(np.float32)).to(dev)
        hi = d.bfloat16()
        lo = (d - hi.float()).bfloat16()
        a = torch.cat([hi, lo], dim=1)
        want = (hi.float() + lo.float()) @ w.float().T
        stacked = torch.cat([w.T, w.T]).contiguous()
        library = lambda: a @ stacked  # noqa: E731
    else:
        a = torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32)).to(dev, torch.bfloat16)
        want = a.float() @ w.float()
        library = lambda: a @ w  # noqa: E731
    name = f"step gemm {'reverse' if terms == 2 else 'forward'} B={B} K={K} N={N}"
    counter = "launches" if terms == 1 else "reverse_launches"
    before = getattr(k_gru.step_gemm, counter)
    got, again = k_gru.step_gemm(a, w, terms), k_gru.step_gemm(a, w, terms)
    torch.cuda.synchronize()
    check(getattr(k_gru.step_gemm, counter) == before + 2, f"{name}: launches not counted")
    cfg = k_gru.step_gemm_config(B, K, N, terms)
    check(tuple(got.shape) == (cfg["splits"], B, N), f"{name}: {tuple(got.shape)}")
    check(torch.equal(got, again), f"{name}: two launches differ")
    plain = k_gru.plain_step_gemm(a, w, terms)
    err, err_mm = rel_err(got, plain), rel_err(k_gru.step_product(got), want)
    tol = STEP_GEMM_TOL[terms]
    check(err <= tol and err_mm <= tol,
          f"{name}: relative error {err} vs plain, {err_mm} vs matmul > {tol}")
    flops = 2 * B * K * N * terms
    nbytes = a.numel() * 2 + w.numel() * 2 + B * N * 4
    b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
    return {"shape": {"B": B, "H": H, "gates": G, "M": B, "K": K, "N": N, "terms": terms,
                      "dtype": "bfloat16"},
            "design": cfg["design"], "launch": cfg, "max_abs_err": max_err(got, plain),
            "relative_error": {"vs_plain": err, "vs_matmul_f32": err_mm},
            "tolerance": tol, "twice_bitwise": True,
            "kernel_ms": time_ms(lambda: k_gru.step_gemm(a, w, terms), reps=reps),
            "plain_ms": time_ms(lambda: k_gru.plain_step_gemm(a, w, terms), reps=reps),
            "library_ms": time_ms(library, reps=reps),
            "library": "torch.matmul bf16 (bf16 out)" + (" on [hi | lo] and [W_h^T; W_h^T]"
                                                        if terms == 2 else ""),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": int(nbytes), "flops": int(flops),
            "workspace_bytes": int(got.numel() * 4)}


# The f32 step GEMM alone against its plain version (the same split) and
# the f64 product, relative to the largest value: the same f32 products
# summed by FMA in another order than torch.matmul's, K of them (up to
# 9,216).
STEP_GEMM_F32_TOL = 1e-5


def _step_gemm_f32_check(rng, dev, B: int, H: int, G: int, reverse: bool, reps: int) -> dict:
    """The stepped scans' f32 step GEMM alone (`k_gru.step_gemm_f32`, csrc/
    fma_gemm.cuh: its partial planes) at one step, forward (h [B, H] @ W_h
    [H, G H]) or reverse (the cotangent [B, G H] @ W_h^T, the copy the
    reverse multiplies), against its plain version (`plain_step_gemm_f32`,
    the same split) and, summed in split order, the product in f64, each
    within STEP_GEMM_F32_TOL of the largest value; twice bit for bit;
    counted by `.launches`. The library yardstick is torch.mm in f32 (TF32
    off) on the same operands. The bound: a and w read once and the
    product [B, N] f32 written once (the partial planes, `workspace_bytes`,
    are the design's traffic, reported apart), 2 B K N operations at the
    f32 peak."""
    K, N = (G * H, H) if reverse else (H, G * H)
    w_h = torch.from_numpy(rng.normal(scale=H ** -0.5, size=(H, G * H)).astype(np.float32))
    w = (w_h.T if reverse else w_h).contiguous().to(dev)
    scale = 1e-2 if reverse else 1.0
    a = torch.from_numpy(rng.normal(scale=scale, size=(B, K)).astype(np.float32)).to(dev)
    name = f"f32 step gemm {'reverse' if reverse else 'forward'} B={B} K={K} N={N}"
    before = k_gru.step_gemm_f32.launches
    got, again = k_gru.step_gemm_f32(a, w), k_gru.step_gemm_f32(a, w)
    torch.cuda.synchronize()
    check(k_gru.step_gemm_f32.launches == before + 2, f"{name}: launches not counted")
    cfg = k_gru.step_gemm_f32_config(B, K, N)
    check(tuple(got.shape) == (cfg["splits"], B, N), f"{name}: {tuple(got.shape)}")
    check(torch.equal(got, again), f"{name}: two launches differ")
    plain = k_gru.plain_step_gemm_f32(a, w)
    want = (a.double() @ w.double()).float()
    err, err_f64 = rel_err(got, plain), rel_err(k_gru.step_product(got), want)
    check(err <= STEP_GEMM_F32_TOL and err_f64 <= STEP_GEMM_F32_TOL,
          f"{name}: relative error {err} vs plain, {err_f64} vs f64 > {STEP_GEMM_F32_TOL}")
    flops = 2 * B * K * N
    nbytes = (a.numel() + w.numel() + B * N) * 4
    b_ms, b_by = bound(nbytes, flops, torch.float32)
    return {"shape": {"B": B, "H": H, "gates": G, "M": B, "K": K, "N": N,
                      "direction": "reverse" if reverse else "forward", "dtype": "float32"},
            "design": cfg["design"], "launch": cfg, "max_abs_err": max_err(got, plain),
            "relative_error": {"vs_plain": err, "vs_f64": err_f64},
            "tolerance": STEP_GEMM_F32_TOL, "twice_bitwise": True,
            "kernel_ms": time_ms(lambda: k_gru.step_gemm_f32(a, w), reps=reps),
            "plain_ms": time_ms(lambda: k_gru.plain_step_gemm_f32(a, w), reps=reps),
            "library_ms": time_ms(lambda: torch.mm(a, w), reps=reps),
            "library": "torch.mm f32 (TF32 off)",
            "bound_ms": b_ms, "bound_by": b_by, "bytes": int(nbytes), "flops": int(flops),
            "workspace_bytes": int(got.numel() * 4)}


# The bf16 input projection's shapes beside the narrow ones (phases c and g):
# rsc15's (B = 256, T = 50, D = H = 100: 200-byte rows, cp.async), w2's
# d = 50 padded to 52 (B = 128, T = 200: 104-byte rows), the wide towers'
# D = H = 512 and w3's 2,304 (B = 256, T = 200); the GRU's N = 3H and the
# LSTM's 4H each.
XPROJ_SHAPES = {"rsc15": (256, 50, D100), "d52": (TRAIN_B, TRAIN_T, D50 + 2),
                "wide": (WIDE_B, WIDE_T, WIDE_D), "w3": (WIDE_B, WIDE_T, W_WIDE_D)}


def _xproj_shape_checks(rng, dev) -> dict:
    """The bf16 input projection alone at XPROJ_SHAPES (`_xproj_check`:
    against its plain version and torch.addmm(..., out_dtype=torch.float32),
    twice bit for bit), on Zipf embeddings and Glorot-uniform W_x (as
    gru_weights and lstm_weights draw it), biases N(0, 0.1)."""
    out = {}
    for label, (Bx, Tx, Dx) in XPROJ_SHAPES.items():
        x32 = _zipf_embeddings(rng, dev, Bx, Tx, Dx)
        for cell, G, module, project in (("gru", 3, k_gru, k_gru.gru_input_projection),
                                         ("lstm", 4, k_lstm, k_lstm.lstm_input_projection)):
            lim = np.sqrt(6.0 / (Dx + G * Dx))
            w_x = torch.from_numpy(rng.uniform(-lim, lim, size=(Dx, G * Dx))
                                   .astype(np.float32)).to(dev)
            b = torch.from_numpy(rng.normal(scale=0.1, size=G * Dx).astype(np.float32)).to(dev)
            out[f"{cell}_{label}"] = _xproj_check(module, project, x32, w_x, b, reps=W_REPS)
            del w_x, b
        del x32
        torch.cuda.empty_cache()
    return out


def _sliced_attention_path(rng, dev) -> dict:
    """The Dh-sliced layout's own path since the cluster layout took Dh up
    to 2,048: one causal_attention call at W_SLICED_D (B = W_SLICED_B,
    T = 200, one head, q, k and v slices of one projection) in each dtype,
    the counters zeroed just before and read just after."""
    proj = torch.from_numpy(rng.normal(size=(W_SLICED_B, TRAIN_T, 3, 1, W_SLICED_D))
                            .astype(np.float32)).to(dev)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = proj.to(dtype).unbind(2)
        zero_counters()
        got = k_attn.causal_attention(q, k, v)
        torch.cuda.synchronize()
        launches = read_counters()
        check(bool(torch.isfinite(got).all()), "phase w: sliced path: non-finite output")
        check(launches["causal_attention_sliced"] == 1 and launches["causal_attention"] == 1
              and launches["causal_attention_cluster"] == 0,
              f"phase w: sliced path launches {launches}")
        out[_dname(dtype)] = {"launches": launches}
    return out


def _attention_control_check(rng, dev) -> dict:
    """The bf16 Dh-cluster attention with every wgmma descriptor's byte
    offsets exchanged (kernel_probes_attention.cu, built in phase_build) at
    w1's step: it must miss the plain version by more than the limit the
    package's kernel meets on the same inputs."""
    import kernel_probes

    _ATTN_CONTROL["thread"].join()
    check("error" not in _ATTN_CONTROL,
          f"phase w: descriptor control: {_ATTN_CONTROL.get('error')}")
    proj = torch.from_numpy(rng.normal(size=(WIDE_B, TRAIN_T, 3, 1, W_SASREC_D))
                            .astype(np.float32)).to(dev, torch.bfloat16)
    q, k, v = proj.unbind(2)
    cfg = k_attn.launch_config(WIDE_B, TRAIN_T, 1, W_SASREC_D, torch.bfloat16,
                               k_attn.operand_align(q, k, v))
    want = k_attn.plain(q, k, v)
    kernel_err = max_err(k_attn.causal_attention(q, k, v), want)
    lib = kernel_probes.attention_control_lib(_ATTN_CONTROL["path"])
    got = kernel_probes.attention_control(lib, q, k, v)
    torch.cuda.synchronize()
    control_err = max_err(got, want)
    control_err = float("inf") if control_err != control_err else control_err
    check(kernel_err <= ATTN_BF16_TOL, f"phase w: attention at w1 {kernel_err}")
    check(control_err > ATTN_BF16_TOL,
          f"phase w: the swapped-offset control passed ({control_err} <= {ATTN_BF16_TOL})")
    return {"route": cfg["route"], "kernel_max_abs_err": kernel_err,
            "control_max_abs_err": control_err, "tolerance": ATTN_BF16_TOL,
            "control_fails": True}


def _all_widths_kernel_checks(rng, dev) -> dict:
    """Each new layout against its plain version, both dtypes, every
    variant, each output launched twice with the same bits (phase c, e, g
    and j's checks, their libraries beside them): the Dh-cluster attention
    at Dh = 257 and 1,000 (B = 32) and at w1's step (B = 256, Dh = 512),
    beside its descriptor control at w1's step, which must fail; the
    Dh-sliced attention at Dh = 2,304 (B = 8), and its one-call path; the
    padded scans at D = 50 and H = 50 (w2's step: B = 128, T = 200) and 102
    (B = 64, T = 50), forward and reverse, with and without a reset plane;
    the stepped scans at each grid limit + 4 and at 2,302 (B = 16, T = 20,
    D = 64), every variant, and at w3's step (B = 256, T = 200, D = H =
    2,304) without a reset; the streamed head at each limit + 1 (N = 4,096)
    and at w3's (N = 51,200, S = 512, H = 2,304)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtypes = (torch.bfloat16, torch.float32)
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name], t0 = time.perf_counter() - t0, time.perf_counter()

    out = {"seconds": seconds,
           "attention": {f"Dh{Dh}": _attention_checks(rng, dev, Dh=Dh, sliced=True, Bq=Bq,
                                                       twice=True, reps=W_REPS)
                         for Dh, Bq in ((257, 32), (1000, 32), (W_SASREC_D, WIDE_B),
                                        (W_SLICED_D, W_SLICED_B))}}
    for key, recs in out["attention"].items():
        want = "dh-sliced" if key == f"Dh{W_SLICED_D}" else "dh-cluster"
        for r in _records(recs):
            check(r["launch"]["layout"] == want, f"phase w: {key} not {want}: {r['launch']}")
    out["attention_sliced_path"] = _sliced_attention_path(rng, dev)
    out["attention_control"] = _attention_control_check(rng, dev)
    lap("attention")

    padded = {}
    for H, (Bp, Tp) in zip(W_PAD_WIDTHS, ((TRAIN_B, TRAIN_T), (B, 50))):
        x32 = _zipf_embeddings(rng, dev, Bp, Tp, D50)
        weights = [w.to(dev) for w in gru_weights(rng, D50, H)]
        reset = _reset_plane(rng, Bp, Tp, dev)
        h32 = _state(rng, dev, Bp, H)
        padded[f"H{H}"] = {
            "gru_scan": {_dname(dt): _gru_forward_check(dev, x32, weights, torch.zeros_like(h32),
                                                        dt, twice=True, reps=W_REPS)
                         for dt in dtypes},
            "gru_scan_reset": {_dname(dt): _gru_forward_check(dev, x32, weights, h32, dt, reset,
                                                              twice=True, reps=W_REPS)
                               for dt in dtypes},
            "gru_backward": _gru_backward_checks(rng, dev, x32, twice=True, H=H, reps=W_REPS),
            "gru_backward_reset": _gru_backward_checks(rng, dev, x32, reset, twice=True, H=H,
                                                       reps=W_REPS),
            "lstm": _lstm_checks(rng, dev, x32, twice=True, H=H, reps=W_REPS),
            "lstm_reset": _lstm_checks(rng, dev, x32, reset, twice=True, H=H, reps=W_REPS)}
    out["padded"] = padded
    for r in _records(padded):
        check(r["launch"].get("route") == "padded", f"phase w: not padded: {r['launch']}")
    lap("padded")

    # The stepped layouts' edges: each dtype's grid limit + 4, and 2,302.
    stepped = {}
    x32 = _zipf_embeddings(rng, dev, 16, 20, 64)
    reset = _reset_plane(rng, 16, 20, dev)
    for dt in dtypes:
        for H in (k_gru.grid_max_hidden(dt) + 4, W_STEP_EDGE):
            weights = [w.to(dev) for w in gru_weights(rng, 64, H)]
            h32 = _state(rng, dev, 16, H)
            stepped[f"gru_{_dname(dt)}_H{H}"] = {
                "gru_scan": _gru_forward_check(dev, x32, weights, torch.zeros_like(h32), dt,
                                               twice=True, reps=W_REPS),
                "gru_scan_reset": _gru_forward_check(dev, x32, weights, h32, dt, reset,
                                                     twice=True, reps=W_REPS),
                "gru_backward": _gru_backward_checks(rng, dev, x32, dtypes=(dt,), twice=True,
                                                     H=H, reps=W_REPS),
                "gru_backward_reset": _gru_backward_checks(rng, dev, x32, reset, dtypes=(dt,),
                                                           twice=True, H=H, reps=W_REPS)}
    for H, dts in ((k_lstm.grid_max_hidden(torch.float32) + 4, (torch.float32,)),
                   (k_lstm.grid_max_hidden(torch.bfloat16) + 4, (torch.bfloat16,)),
                   (W_STEP_EDGE, dtypes)):
        stepped[f"lstm_H{H}"] = {
            "lstm": _lstm_checks(rng, dev, x32, twice=True, H=H, dtypes=dts, reps=W_REPS),
            "lstm_reset": _lstm_checks(rng, dev, x32, reset, twice=True, H=H, dtypes=dts,
                                       reps=W_REPS)}
    lap("stepped_edges")
    # At w3's step, without a reset (nn.GRU / nn.LSTM and cuDNN's backward beside them).
    x32 = _zipf_embeddings(rng, dev, WIDE_B, WIDE_T, W_WIDE_D)
    weights = [w.to(dev) for w in gru_weights(rng, W_WIDE_D, W_WIDE_D)]
    h0 = torch.zeros(WIDE_B, W_WIDE_D, device=dev)
    at_w3 = {"gru_scan": {_dname(dt): _gru_forward_check(dev, x32, weights, h0, dt, twice=True,
                                                         reps=W_REPS)
                          for dt in dtypes},
             "gru_backward": _gru_backward_checks(rng, dev, x32, twice=True, reps=W_REPS)}
    del weights
    at_w3["lstm"] = _lstm_checks(rng, dev, x32, twice=True, reps=W_REPS)
    del x32
    stepped["w3"] = at_w3
    out["stepped"] = stepped
    lap("stepped_at_w3")
    # The step GEMM alone at w3's steps (the GRU's and the LSTM's).
    out["step_gemm"] = {f"{cell}_{way}": _step_gemm_check(rng, dev, WIDE_B, W_WIDE_D, G, terms,
                                                           W_REPS)
                        for cell, G in (("gru", 3), ("lstm", 4))
                        for way, terms in (("forward", 1), ("reverse", 2))}
    # The f32 one at w3's training batch both ways, and forward at its
    # serving batch (B = 64: the SIMT kernel, the same split).
    out["step_gemm_f32"] = {f"{cell}_{way}": _step_gemm_f32_check(rng, dev, WIDE_B, W_WIDE_D, G,
                                                                   way == "reverse", W_REPS)
                            for cell, G in (("gru", 3), ("lstm", 4))
                            for way in ("forward", "reverse")}
    for cell, G in (("gru", 3), ("lstm", 4)):
        out["step_gemm_f32"][f"{cell}_forward_B{W_SERVE_B}"] = _step_gemm_f32_check(
            rng, dev, W_SERVE_B, W_WIDE_D, G, False, W_REPS)
    lap("step_gemm")
    out["xproj"] = _xproj_shape_checks(rng, dev)
    lap("xproj")
    for name, recs in stepped.items():
        for key, rec in recs.items():
            mod = k_lstm if key.startswith("lstm") else k_gru
            for r in _records(rec):
                dt, H = getattr(torch, r["shape"]["dtype"]), r["shape"]["H"]
                want = "grid" if k_gru.padded_width(H) <= mod.grid_max_hidden(dt) else "stepped"
                check(r["launch"]["layout"] == want,
                      f"phase w {name} {key}: not the {want} layout: {r['launch']}")

    heads = {}
    for dt in dtypes:
        H = k_head.max_hidden(dt) + 1
        table = torch.from_numpy(rng.normal(scale=H ** -0.5, size=(VOCAB, H))
                                 .astype(np.float32)).to(dev)
        heads[f"{_dname(dt)}_H{H}"] = _head_checks(rng, dev, table, beauty=False, N=4096,
                                                   S=WIDE_NEG, dtypes=(dt,), twice=True,
                                                   reps=W_REPS)
    table = torch.from_numpy(rng.normal(scale=W_WIDE_D ** -0.5, size=(VOCAB, W_WIDE_D))
                             .astype(np.float32)).to(dev)
    heads["w3"] = _head_checks(rng, dev, table, beauty=False, N=WIDE_B * WIDE_T, S=WIDE_NEG,
                               twice=True, reps=W_REPS)
    del table
    out["streamed_head"] = heads
    for r in _records(heads):
        check(r["launch"]["layout"] == "streamed", f"phase w: not streamed: {r['launch']}")
    lap("streamed_head")
    return out


def phase_all_widths(rng: np.random.Generator, dev, seed: int, card: str) -> dict:
    """w. Every width through the normal entry points: the new layouts at
    their edges and at the paths' steps (`_all_widths_kernel_checks`); then
    w1, w2 and w3 (see W_SASREC_D), each served (phase d: Zipf histories,
    W_REQUESTS of them on w1 and w3, 320 on w2, batch 64, k = 10, within
    SCORE_TOL of the plain path in bf16, F32_SCORE_TOL in f32) and trained
    (phase f's and k's checks: step 1 within the plain path's limits, the
    loss falls, every kernel's launches a step as expected, the new
    layouts' counters included) in bf16 and f32: w1 two K = 4 groups, w2
    two K = 8 groups (the LSTM session-parallel with the carry), w3 two
    groups of W3_K steps. Every time_ms in the phase takes W_REPS reps."""
    phase_t0 = time.perf_counter()
    kernels = _all_widths_kernel_checks(rng, dev)
    kernels_s = time.perf_counter() - phase_t0
    emit({"phase": "all_widths_kernels", "card": card, "seconds": kernels_s, **kernels})
    vocab = WIDE_ITEMS + 1
    serve, train = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for path, cfg in (("sasrec_d512", w_sasrec_config()),
                          ("gru4rec_w2304", w_wide_config("gru")),
                          ("lstm_w2304", w_wide_config("lstm"))):
            CONFIGS[path] = str(Path(tmp) / f"{path}.json")
            Path(CONFIGS[path]).write_text(cfg.to_json())
        requests = make_requests(rng, WIDE_T, n_requests=W_REQUESTS, vocab=vocab)
        for path in ("sasrec_d512", "gru4rec_w2304", "lstm_w2304"):
            dtypes = (("", []), ("_f32", [F32]))
            for suffix, overrides in dtypes:  # one weight draw for both
                t0 = time.perf_counter()
                serve[path + suffix] = phase_serve(dev, seed, path, requests, overrides=overrides,
                                                   vocab=vocab, reps=W_REPS)
                serve[path + suffix]["seconds"] = time.perf_counter() - t0
            for suffix, overrides in dtypes:
                t0 = time.perf_counter()
                train[path + suffix] = phase_train(rng, dev, seed, path, groups=2,
                                                   overrides=overrides, vocab=vocab,
                                                   shared_draw=True)
                train[path + suffix]["seconds"] = time.perf_counter() - t0
    _DRAWN.clear()
    sources = {"sasrec_d512": "benchmarks/throughput.py::bench_config(sasrec, B=256, T=200, "
                              "D=512, 2 blocks, 1 head, 100,000 items, sampled_softmax, "
                              "512 negatives)",
               "gru4rec_w2304": "benchmarks/throughput.py::bench_config(gru4rec, B=256, T=200, "
                                "D=2304, 100,000 items, sampled_softmax, 512 negatives)",
               "lstm_w2304": "benchmarks/throughput.py::bench_config(gru4rec, B=256, T=200, "
                             "D=2304, 100,000 items, sampled_softmax, 512 negatives), "
                             "model.cell_type=lstm"}
    for runs in (serve, train):
        for key, run in runs.items():
            run["config"] = sources[key.removesuffix("_f32")]
    requests = make_requests(rng, RunConfig.load(CONFIGS["gru4rec"]).data.max_len)
    runs = [(serve, f"{path}_d50{suffix}", phase_serve, (dev, seed, path, requests),
             sets + extra) for path, sets in (("gru4rec", [D50_SET]), ("lstm", [D50_SET]))
            for suffix, extra in (("", []), ("_f32", [F32]))]
    runs += [(train, f"{name}{suffix}", phase_train, (rng, dev, seed, path), sets + extra)
             for name, path, sets in (("gru4rec_d50", "gru4rec", [D50_SET]),
                                      ("lstm_session_d50", "lstm", W_LSTM_SESSION))
             for suffix, extra in (("", []), ("_f32", [F32]))]
    for into, name, run, args, overrides in runs:
        t0 = time.perf_counter()
        kw = {"groups": 2} if run is phase_train else {"reps": W_REPS}
        into[name] = run(*args, overrides=overrides, **kw)
        into[name]["seconds"] = time.perf_counter() - t0
    seconds = time.perf_counter() - phase_t0
    emit({"phase": "all_widths", "card": card, "seconds": seconds, "kernels_seconds": kernels_s,
          "serve": {k: {"requests_per_s": v["requests_per_s"],
                        "batch_ms_median": v["batch_ms_median"],
                        "encode_device_ms": v["batch_breakdown"]["encode_device_ms"],
                        "max_score_diff_vs_plain": v["max_score_diff_vs_plain"],
                        "score_tolerance": v["score_tolerance"], "launches": v["launches"],
                        "seconds": v.get("seconds")}
                    for k, v in serve.items()},
          "train": {k: {"examples_per_s": v["examples_per_s"],
                        "step_ms_median": v["step_ms_median"],
                        "device_step_ms": v["device_step_ms"],
                        "device_idle_share": v["device_idle_share"], "step1": v["step1"],
                        "group_losses": [g["loss"] for g in v["group_metrics"]],
                        "peak_memory_bytes": v["peak_memory_bytes"],
                        "launches_per_step": v["launches_per_step"],
                        "seconds": v.get("seconds")}
                    for k, v in train.items()}})
    return {"kernels": kernels, "serve": serve, "train": train, "seconds": seconds}


def _all_widths_entries(w: dict) -> list:
    """The kernels line's entries of phase w's layouts, bf16 and f32: the
    Dh-cluster attention (at w1's step, its launches on w1's training path),
    the Dh-sliced attention (at Dh = 2,304, its launches on its own one-call
    path),
    the padded route's scans (at w2's step, on w2's GRU4Rec path), the
    stepped scans (at w3's step, on w3's paths) and the streamed head (at
    w3's step, on w3's GRU4Rec path); each with its launches on every path
    of phase w."""
    k, train, serve = w["kernels"], w["train"], w["serve"]
    pad, w3 = k["padded"][f"H{D50}"], k["stepped"]["w3"]
    out = []
    sliced_path = k["attention_sliced_path"]
    for dtype, suffix in (("bfloat16", ""), ("float32", "_f32")):
        rec = k["attention"][f"Dh{W_SLICED_D}"][dtype]
        out.append(_kernel_entry(
            "causal_attention_sliced" + suffix, "seqrec_tpu_torch/csrc/attention.cu",
            "seqrec_tpu/ops/pallas/attention.py:98",
            sliced_path[dtype]["launches"]["causal_attention_sliced"], rec, dtype=dtype,
            layout=rec["launch"]["layout"], shape=rec["shape"],
            launches_counted_on=f"phase w: one causal_attention call at Dh={W_SLICED_D}, "
                                f"B={W_SLICED_B}, T={TRAIN_T} (no shipped path is this wide)",
            launches_by_path={**{f"train_{q}": t["launches"]["causal_attention_sliced"]
                                 for q, t in train.items()},
                              **{f"serve_{q}": v["launches"]["causal_attention_sliced"]
                                 for q, v in serve.items()}}))
    for kname, counter, source, replaces, recs, path in (
            ("causal_attention_cluster", "causal_attention_cluster", "attention.cu",
             "attention.py:98", k["attention"][f"Dh{W_SASREC_D}"], "sasrec_d512"),
            ("gru_scan_padded", "gru_scan_padded", "gru.cu", "gru.py:177", pad["gru_scan"],
             "gru4rec_d50"),
            ("gru_backward_padded", "gru_backward_padded", "gru.cu", "gru.py:190",
             pad["gru_backward"], "gru4rec_d50"),
            ("lstm_scan_padded", "lstm_scan_padded", "lstm.cu", "lstm.py:153",
             pad["lstm"]["lstm_scan"], "lstm_session_d50"),
            ("lstm_backward_padded", "lstm_backward_padded", "lstm.cu", "lstm.py:209",
             pad["lstm"]["lstm_backward"], "lstm_session_d50"),
            ("gru_scan_stepped", "gru_scan_stepped", "gru.cu", "gru.py:177", w3["gru_scan"],
             "gru4rec_w2304"),
            ("gru_backward_stepped", "gru_backward_stepped", "gru.cu", "gru.py:190",
             w3["gru_backward"], "gru4rec_w2304"),
            ("lstm_scan_stepped", "lstm_scan_stepped", "lstm.cu", "lstm.py:153",
             w3["lstm"]["lstm_scan"], "lstm_w2304"),
            ("lstm_backward_stepped", "lstm_backward_stepped", "lstm.cu", "lstm.py:209",
             w3["lstm"]["lstm_backward"], "lstm_w2304"),
            ("softmax_head_streamed", "softmax_head_streamed", "softmax_head.cu",
             "softmax_head.py:115", k["streamed_head"]["w3"], "gru4rec_w2304")):
        for dtype, suffix in (("bfloat16", ""), ("float32", "_f32")):
            rec = recs[dtype]
            p = path + suffix
            out.append(_kernel_entry(
                kname + suffix, "seqrec_tpu_torch/csrc/" + source,
                "seqrec_tpu/ops/pallas/" + replaces, train[p]["launches"][counter], rec,
                dtype=dtype, layout=rec["launch"].get("layout", rec["launch"].get("route")),
                shape=rec["shape"],
                launches_counted_on=f"train {train[p]['config']} "
                                    + " ".join(train[p]["overrides"]),
                launches_by_path={**{f"train_{q}": t["launches"][counter]
                                     for q, t in train.items()},
                                  **{f"serve_{q}": v["launches"][counter]
                                     for q, v in serve.items()}}))
    # The stepped scans' bf16 step GEMM at w3's GRU step, forward and reverse.
    for kname, way, replaces in (("step_gemm", "forward", "gru.py:177"),
                                 ("step_gemm_reverse", "reverse", "gru.py:190")):
        rec = k["step_gemm"][f"gru_{way}"]
        p = "gru4rec_w2304"
        out.append(_kernel_entry(
            kname, "seqrec_tpu_torch/csrc/step_gemm.cuh", "seqrec_tpu/ops/pallas/" + replaces,
            train[p]["launches"][kname], rec, dtype="bfloat16", layout="stepped",
            shape=rec["shape"], launch=rec["launch"],
            at_w3_lstm={key: k["step_gemm"][f"lstm_{way}"][key] for key in
                        ("shape", "max_abs_err")} | {
                "ms": k["step_gemm"][f"lstm_{way}"]["kernel_ms"]["median"],
                "library_ms": k["step_gemm"][f"lstm_{way}"]["library_ms"]["median"],
                "bound_ms": k["step_gemm"][f"lstm_{way}"]["bound_ms"]},
            launches_counted_on=f"train {train[p]['config']} " + " ".join(train[p]["overrides"]),
            launches_by_path={**{f"train_{q}": t["launches"][kname] for q, t in train.items()},
                              **{f"serve_{q}": v["launches"][kname] for q, v in serve.items()}}))
    # The stepped scans' f32 step GEMM (the FMA GEMM of the f32 projections)
    # at w3's GRU step, forward and reverse.
    for kname, way, replaces in (("step_gemm_f32", "forward", "gru.py:177"),
                                 ("step_gemm_f32_reverse", "reverse", "gru.py:190")):
        rec = k["step_gemm_f32"][f"gru_{way}"]
        p = "gru4rec_w2304_f32"
        lstm = k["step_gemm_f32"][f"lstm_{way}"]
        served = {f"at_serving_batch_{cell}": {key: r[key] for key in ("shape", "design",
                                                                        "max_abs_err")} | {
            "ms": r["kernel_ms"]["median"], "plain_ms": r["plain_ms"]["median"],
            "library_ms": r["library_ms"]["median"], "bound_ms": r["bound_ms"]}
            for cell in ("gru", "lstm") if way == "forward"
            for r in (k["step_gemm_f32"][f"{cell}_forward_B{W_SERVE_B}"],)}
        out.append(_kernel_entry(
            kname, "seqrec_tpu_torch/csrc/fma_gemm.cuh", "seqrec_tpu/ops/pallas/" + replaces,
            train[p]["launches"][kname], rec, dtype="float32", layout="stepped",
            shape=rec["shape"], launch=rec["launch"],
            at_w3_lstm={key: lstm[key] for key in ("shape", "max_abs_err")} | {
                "ms": lstm["kernel_ms"]["median"], "library_ms": lstm["library_ms"]["median"],
                "bound_ms": lstm["bound_ms"]}, **served,
            launches_counted_on=f"train {train[p]['config']} " + " ".join(train[p]["overrides"]),
            launches_by_path={**{f"train_{q}": t["launches"][kname] for q, t in train.items()},
                              **{f"serve_{q}": v["launches"][kname] for q, v in serve.items()}}))
    return out


def _median(ms) -> Optional[float]:
    return None if ms is None else ms["median"]


def _kernel_entry(name, source, replaces, launches, rec, plain_key="plain_ms", **extra):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"]["median"], "plain_ms": rec[plain_key]["median"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": _median(rec["library_ms"]),
            "design": rec.get("design", "cuda-core"),
            **{k: rec[k] for k in ("deterministic", "launches_per_call") if k in rec}, **extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--p2-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--p2-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--r-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--r-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--sharded-ranks", metavar="DIR", default=None,
                    help="under torchrun: each rank does phase p2's work over NCCL on its "
                         "own card, writing into DIR")
    ap.add_argument("--sharded-check", metavar="DIR", default=None,
                    help="after --sharded-ranks: the one-rank checks of DIR, one JSON line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    if args.p2_rank is not None:  # one of phase p2's ranks, started by phase_sharded
        return p2_rank(args.p2_rank, Path(args.p2_dir), args.seed)
    if args.r_rank is not None:  # one of phase r's writer ranks, started by phase_reshard
        return r_rank(args.r_rank, Path(args.r_dir), args.seed)
    if args.sharded_ranks:
        Path(args.sharded_ranks).mkdir(parents=True, exist_ok=True)
        return p2_rank(None, Path(args.sharded_ranks), args.seed)
    if args.sharded_check:
        root = Path(args.sharded_check)
        ranks = [json.loads(p.read_text()) for p in
                 sorted(root.glob("rank*.json"), key=lambda p: int(p.stem[4:]))]
        check(bool(ranks), f"--sharded-check: no rank*.json under {root}")
        torch.backends.cuda.matmul.allow_tf32 = False
        emit({"phase": "sharded_ranks", "world": len(ranks), "ranks": ranks,
              **sharded_summary(torch.device("cuda", 0), args.seed, root, ranks)})
        return 0
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    run_t0 = time.perf_counter()

    smi, name = phase_device()
    phase_build()
    kern = phase_kernels(rng, dev)
    requests = make_requests(rng, RunConfig.load(CONFIGS["gru4rec"]).data.max_len)
    serve = {"gru4rec": phase_serve(dev, args.seed, "gru4rec", requests)}
    tkern = phase_train_kernels(rng, dev)
    train = {"gru4rec": phase_train(rng, dev, args.seed, "gru4rec", groups=6,
                                    reproducible=True, cast_launches=True)}
    fit = phase_fit(dev)
    towers = phase_tower_kernels(rng, dev)
    for path in ("sasrec", "lstm"):
        serve[path] = phase_serve(dev, args.seed, path, requests)
    train["sasrec"] = phase_train(rng, dev, args.seed, "sasrec", groups=3,
                                  overrides=["train.warmup_steps=0"])
    train["lstm"] = phase_train(rng, dev, args.seed, "lstm", groups=3)
    skern = phase_session_kernels(rng, dev)
    train["rsc15_gru4rec_session"] = phase_train(rng, dev, args.seed, "rsc15_gru4rec", groups=3)
    train["lstm_session"] = phase_train(rng, dev, args.seed, "lstm", groups=2,
                                        overrides=["data.session_parallel=true"])
    for path in ("gru4rec", "sasrec", "lstm"):
        serve[f"{path}_f32"] = phase_serve(dev, args.seed, path, requests, overrides=[F32])
    train["lstm_f32"] = phase_train(rng, dev, args.seed, "lstm", groups=2, overrides=[F32])
    train["gru4rec_f32"] = phase_train(rng, dev, args.seed, "gru4rec", groups=2,
                                       overrides=[F32], reproducible=True)
    train["sasrec_f32"] = phase_train(rng, dev, args.seed, "sasrec", groups=2,
                                      overrides=[F32, "train.warmup_steps=0"])
    widths = phase_widths(rng, dev, args.seed, smi, requests)  # t, beside h, i and l
    serve.update(widths["serve"])
    train.update(widths["train"])
    wide = phase_wide(rng, dev, args.seed, smi)  # u, above H = 256
    serve.update(wide["serve"])
    train.update(wide["train"])
    wide_lstm = phase_wide_lstm(rng, dev, args.seed, smi)  # v, the LSTM above H = 256
    serve.update(wide_lstm["serve"])
    train.update(wide_lstm["train"])
    all_widths = phase_all_widths(rng, dev, args.seed, smi)  # w, every width
    serve.update(all_widths["serve"])
    train.update(all_widths["train"])
    sparse = phase_sparse(dev, args.seed)
    phase_checkpoint(dev, args.seed, requests)
    sharded = phase_sharded(dev, args.seed)
    remat = phase_remat(rng, dev, args.seed)
    reshard = phase_reshard(dev, args.seed, requests)
    bench = phase_benchmark(rng, dev, args.seed, smi, fit)

    p2_rank0 = sharded["p2_gloo_two_ranks_one_card"][0]

    def counts(kernel):
        return {"fit_bench_gru4rec": fit["launches"][kernel],
                "fit_bench_gru4rec_profile_dir": fit["profile_dir_fit"]["counters_per_step"].get(
                    next((h for h, c in TRACE_COUNTERS.items() if c == kernel), ""), 0.0)
                * TRACE_FIT_STEPS,
                **{f"{kind}_{path}": runs[path]["launches"][kernel]
                   for kind, runs in (("train", train), ("serve", serve)) for path in runs},
                **{f"fit_sparse_{path}": run["launches"][kernel]
                   for path, run in sparse["runs"].items()},
                "p2_rank0_fit_ml100k_sharded": p2_rank0["ml100k"]["launches"][kernel],
                **{f"train_remat_{dtype}_{way}": remat[dtype][way]["launches_per_step"].get(
                    kernel, 0.0) * 8 for dtype in ("bfloat16", "float32")
                   for way in ("no_remat", "remat")},
                "fit_reshard_r1_resumed_1x1": reshard["r1"]["launches"][kernel],
                "train_reshard_r2_group_1x1": reshard["r2"]["launches"][kernel],
                **{f"benchmark_{k}": v["launches"][kernel] for k, v in bench.items()
                   if isinstance(v, dict) and "launches" in v}}

    gather = kern["gather"]

    # name, source, the TPU kernel it replaces, its phase record and dtype,
    # the training path whose count is `launches`, and (where the name is
    # not) its counter.
    table = [
        # The gather at the training shape into bf16 (the bf16 paths' lookups).
        ("gather", "gather.cu", "gather.py:86", gather[_gather_key(128, (TRAIN_B, TRAIN_T),
                                                                   torch.bfloat16)],
         "bfloat16", "gru4rec"),
        # Its backward on the bf16 cotangent of those paths, padded ids.
        ("gather_backward", "gather.cu", "gather.py:106",
         tkern["gather_backward"]["bf16_cotangent"], "bfloat16", "gru4rec"),
        ("gru_scan", "gru.cu", "gru.py:177", kern["gru_scan_bfloat16"], "bfloat16", "gru4rec"),
        # The part of _gru_step_body's step that does not depend on h.
        ("gru_xproj", "rnn.cuh", "gru.py:110", kern["gru_xproj"], "bfloat16", "gru4rec"),
        ("gru_backward", "gru.cu", "gru.py:190", tkern["gru_backward"]["bfloat16"],
         "bfloat16", "gru4rec"),
        ("softmax_head", "softmax_head.cu", "softmax_head.py:115",
         tkern["softmax_head"]["bfloat16"], "bfloat16", "gru4rec"),
        ("causal_attention", "attention.cu", "attention.py:98",
         towers["causal_attention"]["bfloat16"], "bfloat16", "sasrec"),
        ("lstm_scan", "lstm.cu", "lstm.py:153", towers["lstm_scan"]["bfloat16"], "bfloat16",
         "lstm"),
        # The part of _lstm_step_body's step that does not depend on h.
        ("lstm_xproj", "rnn.cuh", "lstm.py:89", towers["lstm_xproj"], "bfloat16", "lstm"),
        ("lstm_backward", "lstm.cu", "lstm.py:209", towers["lstm_backward"]["bfloat16"],
         "bfloat16", "lstm"),
        ("gru_scan_reset", "gru.cu", "gru.py:135", skern["gru_scan_reset"]["rsc15"]["bfloat16"],
         "bfloat16", "rsc15_gru4rec_session"),
        ("gru_backward_reset", "gru.cu", "gru.py:255",
         skern["gru_backward_reset"]["rsc15"]["bfloat16"], "bfloat16", "rsc15_gru4rec_session"),
        ("lstm_scan_reset", "lstm.cu", "lstm.py:112",
         skern["lstm_scan_reset"]["ml1m"]["bfloat16"], "bfloat16", "lstm_session"),
        ("lstm_backward_reset", "lstm.cu", "lstm.py:265",
         skern["lstm_backward_reset"]["ml1m"]["bfloat16"], "bfloat16", "lstm_session"),
        # The f32 kernels of the f32 paths.
        ("gather_f32", "gather.cu", "gather.py:86",
         gather[_gather_key(128, (TRAIN_B, TRAIN_T), torch.float32)], "float32", "gru4rec_f32",
         "gather"),
        ("gather_backward_f32", "gather.cu", "gather.py:106", tkern["gather_backward"],
         "float32", "gru4rec_f32", "gather_backward"),
        ("gru_scan_f32", "gru.cu", "gru.py:177", kern["gru_scan_float32"], "float32",
         "gru4rec_f32", "gru_scan"),
        ("xproj_f32", "rnn.cuh", "gru.py:110", kern["xproj_f32"], "float32", "gru4rec_f32"),
        ("gru_backward_f32", "gru.cu", "gru.py:190", tkern["gru_backward"]["float32"],
         "float32", "gru4rec_f32", "gru_backward"),
        ("softmax_head_f32", "softmax_head.cu", "softmax_head.py:115",
         tkern["softmax_head"]["float32"], "float32", "gru4rec_f32", "softmax_head"),
        ("lstm_scan_f32", "lstm.cu", "lstm.py:153", towers["lstm_scan"]["float32"], "float32",
         "lstm_f32", "lstm_scan"),
        ("lstm_xproj_f32", "rnn.cuh", "lstm.py:89", towers["lstm_xproj_f32"], "float32",
         "lstm_f32"),
        ("causal_attention_f32", "attention.cu", "attention.py:98",
         towers["causal_attention"]["float32"], "float32", "sasrec_f32", "causal_attention"),
        ("lstm_backward_f32", "lstm.cu", "lstm.py:209", towers["lstm_backward"]["float32"],
         "float32", "lstm_f32", "lstm_backward"),
    ]
    kernels = [
        _kernel_entry(kname, "seqrec_tpu_torch/csrc/" + source,
                      "seqrec_tpu/ops/pallas/" + replaces,
                      train[path]["launches"][counter[0] if counter else kname], rec,
                      dtype=dtype,
                      launches_counted_on=" ".join(["train", train[path]["config"],
                                                    *train[path]["overrides"]]),
                      launches_by_path=counts(counter[0] if counter else kname))
        for kname, source, replaces, rec, dtype, path, *counter in table]
    # The bf16 kernels of s3 also at configs/beauty_gru.json's step.
    for entry in kernels:
        rec = bench["s3"]["kernels"].get(entry["name"])
        if rec is not None:
            entry["at_beauty_gru"] = {
                "shape": rec["shape"], "max_abs_err": rec["max_abs_err"],
                "tolerance": rec["tolerance"], "ms": rec["kernel_ms"]["median"],
                "plain_ms": rec["plain_ms"]["median"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": _median(rec["library_ms"])}
    # The slice's kernels at the published widths (phase t).
    at_widths = _widths_entries(widths)
    for entry in kernels:
        if entry["name"] in at_widths:
            entry["at_published_widths"] = at_widths[entry["name"]]
    # The GRU's cluster layouts (Hp > 128), at beauty_gru's step: their own
    # counters' launches over s3's timed chains (2 a step), and one a layer
    # a served batch.
    s3 = bench["s3"]
    for kname, counter, replaces, rec in (
            ("gru_scan_wide", "gru_scan_wide", "gru.py:177", s3["kernels"]["gru_scan"]),
            ("gru_backward_wide", "gru_backward_wide", "gru.py:190",
             s3["kernels"]["gru_backward"])):
        kernels.append(_kernel_entry(
            kname, "seqrec_tpu_torch/csrc/gru.cu", "seqrec_tpu/ops/pallas/" + replaces,
            s3["launches"][counter], rec, dtype="bfloat16", layout="cluster",
            cluster_size=rec["launch"]["cluster_size"], shape=rec["shape"],
            launches_counted_on=f"benchmark s3 {CONFIGS['beauty_gru']} (its timed chains)",
            launches_by_path={"benchmark_s3": s3["launches"][counter],
                              "serve_beauty_gru": s3["serve"]["launches"][counter]}))
    # The shard-window variants (phase p): launches on p2's rank 0, the
    # window gather's on the sharded sparse fit, the window scatter-add's on
    # the dense sharded group (the sparse step's sub-table needs none).
    rank0 = p2_rank0
    by_path = lambda k: {f"p2_rank0_{p}": rank0[p]["launches"][k]  # noqa: E731
                         for p in ("dense_ml1m", "ml100k", "synthetic10m", "rsc15_10m")}
    for kname, replaces, rec, path, on in (
            ("gather_window", "gather.py:86", sharded["p3"]["gather_window"]["float32"],
             "synthetic10m", f"p2 rank 0 fit {P2_CONFIGS[0]}"),
            ("gather_backward_window", "gather.py:106", sharded["p3"]["gather_backward_window"],
             "dense_ml1m", f"p2 rank 0 group {CONFIGS['gru4rec']} {' '.join(P2_DENSE)}")):
        kernels.append(_kernel_entry(kname, "seqrec_tpu_torch/csrc/gather.cu",
                                     "seqrec_tpu/ops/pallas/" + replaces,
                                     rank0[path]["launches"][kname], rec, dtype="float32",
                                     launches_counted_on=on, launches_by_path=by_path(kname)))
    # The GRU's grid layouts and the head's K split (H > 256, phase u).
    kernels += _wide_entries(wide)
    # The LSTM's grid layouts (H > 256, phase v).
    kernels += _wide_lstm_entries(wide_lstm)
    # Every width (phase w): the sliced attention, the padded and stepped
    # scans, the streamed head.
    kernels += _all_widths_entries(all_widths)
    # The bf16 input projection at phase w's shapes beside its narrow entry.
    for entry in kernels:
        if entry["name"] in ("gru_xproj", "lstm_xproj"):
            entry["at_shapes"] = {
                label: {"shape": r["shape"], "plan": r["plan"], "max_abs_err": r["max_abs_err"],
                        "tolerance": r["tolerance"], "ms": r["kernel_ms"]["median"],
                        "plain_ms": r["plain_ms"]["median"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]["median"],
                        "twice_bit_for_bit": r["twice_bit_for_bit"]}
                for label, r in all_widths["kernels"]["xproj"].items()
                if label.startswith(entry["name"][:-5])}
    emit({"phase": "run", "seconds": time.perf_counter() - run_t0,
          "all_widths_seconds": all_widths["seconds"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
