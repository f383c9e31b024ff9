"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing loudly (traceback, non-zero exit, no result line):

1. device: card name, torch and CUDA versions, nvidia-smi name and power
   limit;
2. build: compiles the seven kernel libraries from this checkout at once,
   one nvcc each: csrc/drmsd_fwd.cu (K1a), csrc/drmsd_train.cu (K1b, K1c),
   csrc/drmsd_variants.cu (K4a, K4b, K4c), csrc/sidechain.cu (K2a, K2b),
   csrc/attention.cu (K3a and the flash backward, float32 and bf16
   instances), csrc/kabsch.cu (K5) and csrc/adam.cu (K6); prints each
   bf16 kernel's registers and spill bytes for every head dimension from
   the build's ptxas -v, and fails on a spill at D = 64;
3. kernels against their plain PyTorch versions on the card.
   dRMSD (K1a, K1b, K1c), ~70% of atoms valid and one protein all masked,
   at B=8 x N = 600, 768, 3584, 7000 and at the training step's B=16 x
   N = 768, 3584, then on the training step's structured masks (each
   residue's real slots, 2% missing, padded tails, one protein all masked)
   at B=16 and 8 x N = 3584, and (checked, not timed) on the backbone
   masks of ladder config 5's path at B = 4, 32, 96 and 128 x N = 1500
   (its train step, the eval level, the --max-batch bench and the probe's
   frontier): equal pair counts, |d dRMSD| <= 1e-4 A, K1b's S
   equal to K1a's bit for bit, gradients (K1b: dS/da, K1c: dS/db) within
   1e-4 * max(1, max|g|), zero statistic and gradient for the all-masked
   protein, the same bits on a second call.
   Sidechain build (K2a, K2b: backbone, angles and sequence in, each block
   looking up the packed force-field table itself) at (B, L) = (8, 256),
   (16, 256), (8, 500), (3, 37), (1, 1), (5, 1) with int64 ids, all 20
   amino acids and padding in the batch, and at (3, 45) with int32 ids
   holding every type of the table and ids outside it, on full-range and
   on physical angles, the outputs handed out NaN-filled by the allocator:
   dead slots exactly zero; everything finite, padded rows and their
   gradients included; the kernel's
   distance from a float64 plain build at most twice the fp32 plain
   build's plus 1e-5 A (on full-range angles nearly collinear frames
   amplify any rounding); on physical angles the kernel within 1e-4 A of
   the float64 build, and of the fp32 plain build up to that one's own
   distance from it;
   the gradients of sum(sin(0.3 crd)) with respect to backbone and angles
   within 1e-4 * max(1, max|g|) of autograd through plain; the same bits
   on a second call.
   Median times of kernel and plain over 25 runs (CUDA events), and each
   kernel's bound: the largest of its bytes (inputs read once, outputs
   written once) over 3.35 TB/s, its operations on this run's data over
   67 TFLOP/s (fp32 outside the tensor cores) and its special-function
   operations (rsqrt, sqrt, exp) over 132 SMs x 16 a clock x 1.98 GHz. At
   the shape of its row in the kernel table each kernel also gets a
   device-only time: the device time of what one wrapper call launches,
   from a torch.profiler trace, beside the event time, which holds the
   wrapper's host work too (K1 also at B=8 x N = 7000 and on the
   structured masks).
   Then the kernel variants of the bench tool (K4a one square root a pair,
   K4b and K4c the norm + cross-term form on the tensor cores, TF32 split
   in two) at the same (B, N) cases and on the structured masks at B=16
   and 8 x N = 3584 (with a protein of one valid atom), each call after a
   NaN-poisoning of the allocator, against their plain versions and
   against K1a / K1b: pair counts equal, exact zeros for the proteins
   without a pair, the same bits on a second call, |d dRMSD| <= 1e-4 A, K4c's
   dS/da within 1e-4 * max(1, max|g|); on the tool's own inputs
   (a ~ N(0, 30), b = a + N(0, 1)) S of K1a, K4a and K4b against a float64
   run of the plain version, within 1e-5 relative at n = 700 and 1e-4 at
   B=8 x N = 3584 and 7000; times, bounds (the matrix products' operations
   over 495 TFLOP/s TF32 are the third term) and device-only times at both
   bench shapes; then the tool itself through its ``main`` (parity, then
   the bench: cur / sqrt1 / mxu forward, cur / mxu gradient), with the
   launches of that run asserted.
   The superposition RMSD (K5) through tools/bench_kabsch.py's ``main``
   at the scoring step's B=32 x N = 7000 and 1500 (random walks and
   their noisy rotated copies, 2% of the atoms missing): within 1e-6
   relative of the tensor path run in float64 on the same inputs, and of
   the float32 tensor path up to that one's own gap; one launch and no
   stream synchronisation a call (the tensor path: its SVD's two); times
   by CUDA events, device-only times and the bound (bytes over 3.35 TB/s).
   The optimizer's update (K6) on the flagship's parameters (conv-enc
   d_model 512 x 6 layers, 28.1 M in 105 tensors), seeded weights and
   gradients that engage the clip, Adam with weight decay and the Noam
   step: three updates through ``Optimizer.update`` on the kernel and on
   the foreach chain (impl "torch", fed the kernel's float64 norm), every
   parameter and both moments within 2 ulp or 1e-6 relative; two launches
   an update and no stream synchronisation; then
   tools/bench_adam.py's ``bench_set`` on the same set: both paths' times
   by CUDA events, device-only times and the bound (32 bytes a parameter
   over 3.35 TB/s);
4. goldens on the card: NeRF coordinates (tests/golden/coords.npz,
   realistic_coords.npz) <= 1e-3 A, and the conv-enc model forward
   (tests/golden/model_parity_conv-enc.npz) <= 2e-5 with TF32 off; then
   each of the four model goldens (enc-only, conv-enc, conv-enc-noemb,
   enc-dec) through the reference-checkpoint route: its flax params as a
   reference state_dict (the port's key map,
   models/torch_import.py::reference_names) loaded by
   ``state_dict_to_port`` into a model on the card, forward <= 2e-5;
5. the eval slice at the flagship width, conv-enc|21,11,3|1,1,1 (d_model
   512, d_ff 2048, 8 heads, 6 layers), B=8 x L=256, random seeded weights:
   ``Trainer.eval_epoch`` over 2 batches in three arms, interleaved: every
   kernel on, the dRMSD kernels and K5 on with the plain sidechain build,
   and all plain (the RMSD by the tensor path); metrics finite and equal
   to the all-plain arm's within 1e-4 (dRMSD family, RMSD; with the plain
   sidechain build the RMSD within 5e-6 relative: K5 against the tensor
   path on the same coordinates) and 1e-6 (MSE); ms per eval step and
   residues/s of each arm; per step K1a launched twice, K2a and K5 once,
   K2b never;
6. the training slice at the same width (combined loss, Adam, Noam,
   coupled weight decay, clip 1.0, dropout 0.1), residue-budget batches of
   15 proteins of length 255-256 padded to B=16 x L=256:
   ``Trainer.train_epoch`` over 9 steps in the same three arms, the
   all-plain arm's optimizer on the foreach chain (impl "torch"); finite
   losses; per step K1b and K6 launched twice, K2a and K2b once, K1a and
   K1c never (K6 twice a train step in every later phase that trains:
   the clip's norm pass and the update); ms per step and residues/s from
   interleaved epochs; and at dropout 0 from identical weights, one
   step's loss (within 1e-4 relative) and every parameter's gradient
   (within 1e-3 of its largest entry) of the all-kernels path against the
   all-plain path. Phases 5
   and 6 run the trainers' default data path, the device store (each
   timed phase prints the path it ran), and also count each arm's device
   operations and device time per step (a batch gathered from the store,
   then the step) with torch.profiler, and the stream synchronisations of
   one such step with torch.cuda.set_sync_debug_mode("warn"), with the
   lines that make them: none in a train step, none in an eval step that
   runs K5 (two, both in the SVD, in the all-plain arm's);
7. the training CLI at the same width: a synthetic dataset (train, two
   validation splits, test; lengths 255-256) written with torch.save, then
   ``training.cli.main`` for two epochs into a temporary run directory:
   finite epoch metrics for train and each validation split, test
   evaluated, checkpoints/best with its sidecar, the .train CSV with its
   rows, config.json, and the kernels launched as often as the steps say;
   the checkpoint restored bit for bit; then ``main`` again with -e 3 on
   the same directory, which must resume from 'best' at epoch 2 and
   finish. Prints ms per train step and residues/s of the second epoch.
   The checkpoint's cost: ``Trainer._save_checkpoint`` and the restore in
   ``maybe_restore`` after one train step, at the flagship and at ladder
   config 5 (d_model 1024 x L 500), timed, with the file's bytes, the
   restored state equal to the saved one bit for bit;
8. flash attention (K3a forward; the backward, dQ, dK and dV in one launch)
   against its plain version on the card, on the model's head-split views,
   at (B, H, L, D) = (8, 8, 256, 64), (16, 8, 256, 64), (8, 8, 500, 64),
   (3, 2, 37, 16), (1, 1, 1, 16), ragged valid lengths and one batch row
   with no valid key: every row within 2e-5 of plain (fp32 sums in another
   order; TF32 off), everything finite, dQ, dK and dV within
   1e-4 * max(1, max|g|) of autograd through plain, of the backward's plain
   version on the same inputs and of a float64 plain run, the same bits on
   a second call. Median times over 25 runs of each kernel, of plain, and
   of torch.nn.functional.scaled_dot_product_attention with the same
   boolean mask (forward, and autograd's one backward), a yardstick that
   the port never calls, and at the table's shapes the device-only time of
   each kernel and of that call; each kernel's bound from this run's valid
   keys;
9. predict at the flagship width: one CLI epoch with --attention_impl flash
   (every eval step launches K3a 6 times, the dropout-0.1 train steps
   never), the output head then set to seeded random weights so that the
   trunk reaches the angles, then ``predict.main`` on that run directory
   for 16 proteins at --batch 8: K3a launched 6 x 2 times, K2a twice,
   well-formed *_pred.pdb / *_true.pdb pairs; against a second predict
   with attention_impl xla the models' sin/cos on real residues within 2e-5
   (the model-forward gate, the binding one) and the parsed coordinates
   within 2e-2 A (under random weights atan2 and the chain's lever arms
   magnify the angle error; 1e-3 A does not hold at L=256); ms per batch
   and residues/s of both, from interleaved timed batches;
10. flash training at the same width: -do 0 --attention_impl flash, per
   step K3a 6, the flash backward 6, K1b 2, K2a 1, K2b 1; ms per step of
   both arms, interleaved; one step from identical weights against the
   materialised branch, loss within 1e-4 relative.
   Under the MSE loss every parameter's gradient within 1e-3 of its largest
   entry, the hidden units whose ReLU differs between the arms left out (the
   arms' activations differ by fp32 rounding, and a unit that flips for one
   residue moves its row of a gradient by ~1e-2), and within 2e-3 of its L2
   norm with nothing left out. Under the combined loss, whose gradient is
   ill-conditioned in the predicted sin/cos under random weights, the limit
   comes from a float64 run of the same step: the flash arm's gradient no
   farther from it than twice the xla arm's plus 1e-3 (L2), and the arms
   within 2e-2 (entries) and 1e-2 (L2) of each other;
11. the encoder-decoder family at full width (d_model 512, d_ff 2048, 8
   heads, 6 + 6 layers, combined loss, Adam, Noam, dropout 0.1, teacher
   forcing) through the CLI, twice: two epochs of 9 steps with one
   validation split and test, without and with structure logging. Per
   train step K1b launched twice, K2a and K2b once, per eval step K1a
   twice and K2a once, K2a once more per logged structure, K3 never; the
   checkpoint restored bit for bit; ``predict.main`` on the run for 16
   proteins (teacher-forced on the true angles, as the JAX package
   predicts). Prints ms per train step beside the conv-enc CLI step of
   phase 7, and a profiler count of one step. The enc-dec step's host
   time: conv-enc and enc-dec flagship epochs interleaved, each with its
   wall ms, device operations, device ms and loop-profile phases a step
   and the five costliest Python sites of one step (cProfile). Scheduled
   sampling, every fed-back decoder pass recomputed in the backward: at
   L = 32 (both fractions 0.5) four train steps with backward, whose
   decoder passes must be those the sampling generator's seed gives (a
   seed chosen for three teacher-forced steps, then one sampled with 14
   predictions fed back), and ``predict()``; at the reference's lengths
   (-fctf 0 -fsstf 0.5) one teacher-forced and two sampled steps at B=8 x
   L=256 and one sampled step at B=2 x L=500, each with its passes, ms,
   peak ``max_memory_allocated`` beside the prediction, stream
   synchronisations (none beyond the teacher-forced step's) and, at
   L = 256, device operations and device ms (from a traced teacher-forced
   step and a traced sampled step of few passes), then ``predict()`` at
   L = 256;
12. structure logging, inside phase 11's second CLI run
   (--log_structure_step 2 --log_val_struct_step 4): for every logged step
   <step>_pred.pdb, <step>_pred.glb and <step>_scene.glb, and true.pdb and
   true.glb, under structures/train and structures/V10, each parsed (PDB
   atoms finite, the .glb container valid); ms per train step with logging
   on beside logging off. Then ``tools/bench_logging.py`` on the flagship
   conv-enc loop: logging at the default cadences (10, 50) against off,
   epochs interleaved, ms, device operations, device ms and loop-profile
   phases a step, and no stream synchronisation on the train loop in
   either arm (the worker's own copies to the host apart);
13. the training loop's data paths at the flagship width (B=16 x L=256
   training, B=8 x L=256 eval): every batch of one train epoch and one eval
   epoch gathered from the device store equals collate(...).to(device) bit
   for bit; a synchronising copy made on another thread is counted (the
   prefetch thread's place); then train and eval epochs with the store
   (--device_data true), with prefetched host batches (false) and with the
   synchronous host path the port ran before (the step copies each field
   from pageable memory), interleaved: ms per step, device operations,
   device ms and the idle share per step, and the stream synchronisations
   of a step and of an epoch with their lines; none in the store path's
   train step or epoch, at most two in its eval step; one step with the
   store and one with host batches from identical weights at dropout 0,
   losses within 1e-6 relative;
14. the repo's own chains, examples/dev_data (NaN angles, missing atoms),
   through the CLI at full width for two epochs with --device_data true and
   false: finite epoch metrics, the CSV's columns, checkpoints, the
   kernels launched as often as the steps say, first-epoch losses of the
   two runs within 1e-4 relative;
15. -adbs True through the CLI at L=256 with the store on: the probe must
   meet a real torch.cuda.OutOfMemoryError, prints its answer, its seconds
   and what it caught, then one epoch trains at the answer; one epoch with
   --profile_dir, whose Chrome trace must parse and hold the epoch's CPU
   operations (its count of device kernel events is printed, and a trace
   without any is named as the profiler's known empty-trace fault); one
   epoch under PTT_LOOP_PROFILE=1, whose spans must hold every phase
   (the report is printed from them), the --profile_dir epoch's spans.json
   each span a range of its trace;
16. bf16 (--compute_dtype bfloat16). Right after phase 8, K3a-bf16 and the
   bf16 backward (csrc/attention.cu's bf16 instances: wgmma products, TMA
   staging) against their plain versions on phase 8's cases and at D = 32
   and 128, then at every D in {16, 32, 64, 128} and L in {1, 70, 130, 256,
   500} with a masked first key tile, the outputs handed out NaN-filled by
   the allocator: O, dQ, dK and dV of the kernel and of the plain version
   each within 1e-2 of the largest entry of an fp32 run on the same bf16
   values, and within that of each other (at one key, where dQ and dK are
   zero and every version returns a rounding residue, of the cancelled
   term's); everything finite, the same bits twice; at the first seven
   cases times beside plain and the library's bf16 call, device-only times,
   the bound at two bytes an element and 989 TFLOP/s. At the end, the
   flagship in bf16: train epochs of 5 steps (dropout 0.1, the store)
   interleaved with fp32 ones, ms per step, device operations and device
   ms; float32 parameters that move; flash training
   at dropout 0 with K3a-bf16 and the bf16 backward launched 6 times each a
   step; one MSE step of bf16 flash, bf16 materialised and fp32 from the
   same weights, the two bf16 arms held within twice the materialised
   arm's distance from fp32 plus 1e-2; one CLI epoch with --compute_dtype
   bfloat16 --attention_impl flash (K3a-bf16 6 times an eval step) and
   predict.main on its run (K3a-bf16 12 times, K2a twice, 32 PDB files);
17. wandb and the dataset tools. (a) The CLI at the flagship width for two
   epochs on the device store with --use_wandb True and a recording wandb
   module in sys.modules (the card's machine has neither the package nor
   a network): the logged keys and the summaries are those of
   ``expected_wandb_keys``, which tests/test_torch_wandb.py holds equal to
   the JAX package's; one train row and one pair of angle histograms a
   step; each epoch one finite histogram of every parameter and of its
   gradient; the launches of the steps plus the gradient probe's (K1b
   twice, K2a and K2b once an epoch). Then train epochs with wandb on and
   off, interleaved: ms a step, device operations and device ms a step,
   no stream synchronisation in an epoch with wandb on; the probe alone
   (its launches, ms, device operations, device ms) and watch_params'
   host time. (b) Synthetic proteins built on the card, written as PDB
   files (a structure cache, CASP targets) with ProteinNet text naming
   them; scripts.proteinnet_to_dataset (no fetch) builds the dataset:
   measured angles within 1e-5 rad^2 per angle (MSE) of those that built
   the files; one CLI epoch on it; scripts.dataset_item_to_pdb --rebuild
   of its longest item on the card, K2a once: within 1e-3 A of a float64
   plain build of the same angles, and within 5e-2 A of the true structure
   (the files' three decimals move the measured angles by ~1e-3 rad); the
   rebuilt file holds the rebuild; scripts.export_embeddings_to_tsv on the
   CLI run writes the model's embedding table and its labels.
18. multi-GPU (parallel/), on the one card. The CLI at the flagship width
   (B = 15 real proteins in 16 rows, L = 256, dropout 0, one epoch of two
   train steps, valid-10 and test) runs as separate rank processes of this
   script (``--rank-child``), each reporting its kernel launches: (i) under
   ``python -m torch.distributed.run --nproc_per_node 1`` with
   PTT_DISTRIBUTED=1, an NCCL group of one rank, so the gradient and metric
   reductions and the checkpoint policy's broadcast are NCCL calls on the
   card; (ii) two ranks on cuda:0 through the PTT_* triple, where the
   backend is gloo (NCCL refuses two ranks on one card), once under
   ``--mesh_shape 2`` (8 and 7 real proteins a rank) and once under
   ``--mesh_shape 1 2 --mesh_axes data model --attention_impl flash``
   (Megatron tensor parallelism, K3a and the flash backward on each rank's
   4 heads). Each rank must print its backend and launch K1b, K2a and K2b
   (and K3a and the flash backward under flash), as many times as the
   other rank of its run; the CSV numbers of every train step and eval
   epoch must equal those of a single-process run in this process within
   rtol 2e-4 (TF32 off). A failing or late rank fails the phase. The wall
   times are printed for information only: ranks sharing one card measure
   nothing about scaling, and NCCL across separate cards is not exercised.
   After phase 16 one line gives, for information, the MFU of phase 6's
   fp32 and phase 16's bf16 flagship train steps (training/flops.py's
   count) against the card's bf16 dense peak, by wall and by device time;
19. the scale-data tools (tools/{gen_scale_data,oracle_floor,
   stress_pipeline,gen_dev_data}.py), each step with its seconds.
   (a) gen_scale_data at the JAX tool's defaults (300 / 40 / 40 chains of
   50-250 residues, seed 20260819) on the card, K2a once a chunk: every
   chain's coordinates within 1e-3 A of a float64 plain build of the same
   angles, and sequences and angles equal to a --device cpu run's. (b)
   oracle_floor at its defaults on the card (K2a and K1a once): each
   chain's dRMSD within 1e-3 A of the plain CPU path's, and mean, median,
   min and max within 0.01 A of the JAX tool's 27.59 / 24.76 / 11.66 /
   54.00. (c) stress_pipeline at 1,000 and 4,000 training chains (the
   generator a subprocess on the card, the store on the card): a line for
   every stage, plan and collate counting the same proteins, each stage at
   4x the chains within 8x the time plus 1 s. (d) the training CLI on (a)'s
   set with the recipe of the JAX package's run c4 (conv-enc, d_model 256,
   6 layers, the combined loss, Adam + Noam; -b 4 -nws 1000) for 12
   epochs: valid-70 angle RMSE at the last epoch at most 0.30 and at most
   0.6 of epoch 0's, the valid-70 dRMSD beside (b)'s floor, K1a, K1b, K2a
   and K2b launched as the steps say. (e) gen_dev_data on the card against
   examples/dev_data: the same ids, sequences and helix lists, coordinates
   within 1e-3 A (+1e-6) between the PDB files' three-decimal values,
   per-angle MSE at most 1e-5 rad^2 with NaN where the fixture has NaN.
20. the config ladder, the trace tools, the attention bench's levels and
   the analysis scripts (tools/{bench_ladder,trace_ladder,analyze_trace,
   bench_attention}.py, scripts/). (a) bench_ladder's five configurations
   in fp32 at their own batches (up to conv-enc d_model 1024 x L 500 with
   lndrmsd and the backbone term, B=4) and config 5 in bf16, 30 steps
   each: a finite loss, the MFU, positive device ms, the card; K1b, K2a
   and K2b launched a step as the loss's code path calls them (none for
   mse; K1b twice for drmsd and combined, once for the backbone term
   alone). (b) config 5's --probe-only in its subprocess: MAXB and the
   batch 0.8x of it on the collate lattice. (c) trace_ladder of configs 4
   and 5 and analyze_trace --by source of each: every hand kernel the
   trace's steps launched under its own category, at most 5% of the
   device time in the catch-all "other", nearly every device event linked
   to the operation that launched it. (d) bench_attention's op level (head dims
   64, 128, 128; forward within 2e-5 on valid rows, gradients within
   1e-4 * max(1, max|g|)) and eval level (d_model 1024 x L 500 at B = 4
   and 32, the packed metrics of xla and flash within 2e-2). (e) the six
   scripts on phase 14's runs, examples/dev_data and phase 9's
   predictions.
21. the reference-checkpoint import and the bench. (a) A reference-style
   .chkpt (``model_state_dict`` under the reference's names, with a
   positional-encoding buffer no port module owns) of the flagship
   conv-enc from seeded weights, loaded by ``load_reference_checkpoint``
   into a fresh model on the card: the parameters and the forward on a
   B=8 x L=256 batch equal the source model's bit for bit. (b) The bench's
   three modes (``protein_transformer_tpu_torch/bench.py``: the headline
   train step at B=8 x L=256, the trainer loop, the eval step at d_model
   1024 x L 500) at full width, BENCH_STEPS=30, each in a process of its
   own (``--bench-child``): the JSON line with a finite positive value,
   the card named on stderr, and K1a, K1b, K2a and K2b launched as the
   steps say (the trainer loop's K2a once more for each logged
   structure). (c) tools/bench_protocol.py at --runs 2 in raw mode, fresh
   processes of ``python -m protein_transformer_tpu_torch.bench``: no
   failed attempt, a warm run 1, the median and the spread.

It prints the time the run took, then the kernel table as one JSON line,
and as its last line {"ok": true, "device": {...}}. It needs one CUDA
device and no network.
"""
from __future__ import annotations

import collections
import contextlib
import csv
import gc
import io
import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from protein_transformer_tpu_torch import bench, predict, tracing
from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.data.dataset import (
    VALID_SPLITS, DataModule, collate, load_dataset)
from protein_transformer_tpu_torch.data.device_store import plan_batch
from protein_transformer_tpu_torch.data.synthetic import (
    OUT_OF_TABLE_IDS, atom_mask_case, make_dataset, random_angles,
    sidechain_case, with_every_type)
from protein_transformer_tpu_torch.device import cuda_device
from protein_transformer_tpu_torch.models.conv_encoder import (
    ConvEncoderOnlyTransformer)
from protein_transformer_tpu_torch.models.enc_dec import Transformer
from protein_transformer_tpu_torch.models.encoder_only import (
    EncoderOnlyTransformer)
from protein_transformer_tpu_torch.models.factory import make_model
from protein_transformer_tpu_torch.models.flax_import import (
    flax_names, flax_to_state_dict, load_flax_params, params_from_flat_keys)
from protein_transformer_tpu_torch.models.torch_import import (
    load_reference_checkpoint, reference_names, state_dict_to_port)
from protein_transformer_tpu_torch.ops import _build
from protein_transformer_tpu_torch.ops import adam as AD
from protein_transformer_tpu_torch.ops import attention as A
from protein_transformer_tpu_torch.ops import drmsd as D
from protein_transformer_tpu_torch.ops import drmsd_variants as V
from protein_transformer_tpu_torch.ops import kabsch as K
from protein_transformer_tpu_torch.ops import sidechain as S
from protein_transformer_tpu_torch.protein import geometry as G
from protein_transformer_tpu_torch.protein.constants import (
    NUM_PREDICTED_COORDS)
from protein_transformer_tpu_torch.protein.geometry import (
    build_coords_batch, inverse_trig_transform)
from protein_transformer_tpu_torch.protein.measure import pdb_to_record
from protein_transformer_tpu_torch.protein.pdb import (
    PdbWriter, parse_pdb_atoms)
from protein_transformer_tpu_torch.protein.vocab import STD_AAS, VOCAB
from protein_transformer_tpu_torch.scripts import (
    analyze, compute_dataset_angle_means, create_development_datasets,
    dataset_item_to_pdb, downsample_dataset, export_embeddings_to_tsv,
    group_predictions, plot, proteinnet_to_dataset)
from protein_transformer_tpu_torch.tools import (
    analyze_trace, bench_adam, bench_attention, bench_drmsd_kernel,
    bench_kabsch, bench_ladder, bench_logging, bench_protocol, gen_dev_data,
    gen_scale_data, oracle_floor, stress_pipeline, trace_ladder)
from protein_transformer_tpu_torch.tools.bench_geometry import (
    sync_count, sync_sites)
from protein_transformer_tpu_torch.training import (
    batch_probe, cli, flops, optim)
from protein_transformer_tpu_torch.training import wandb_logging as W
from protein_transformer_tpu_torch.training.checkpoint import (
    CheckpointManager)
from protein_transformer_tpu_torch.training.trainer import (
    METRIC_KEYS, LoopProfiler, Trainer)
from protein_transformer_tpu_torch.utils import SPANS_FILE, TRACE_FILE

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
DEV_DATA = os.path.join(ROOT, "examples", "dev_data")
LIBRARIES = ("drmsd_fwd", "drmsd_train", "drmsd_variants", "sidechain",
             "attention", "kabsch", "adam")
# (B, N): the sizes of the TPU kernel's tests, then the training step's
# full-atom (14 x 256) and backbone (3 x 256) sweeps at B=16
KERNEL_CASES = ((8, 600), (8, 768), (8, 3584), (8, 7000), (16, 768),
                (16, 3584))
EVAL_CASE = (8, 3584)    # the eval step's full-atom sweep
TRAIN_CASE = (16, 3584)  # the train step's full-atom sweep
# device-only times of K1 at the table's shapes and at the longest proteins
K1_DEVICE_CASES = (EVAL_CASE, TRAIN_CASE, (8, 7000))
# (B, N, masks) of K1 on the later phases' paths, checked only: ladder
# config 5's backbone term (3 x 500 atoms) at the train step's B=4, the eval
# level's B=4 and 32, the --max-batch bench's B=96 and the probe's frontier
# B=128 (phase 20 and PERF.md); then the bench's eval mode, whose ln-dRMSD
# without the backbone loss sweeps all 14 x 500 atoms at B=4 (phase 21)
PATH_K1_CASES = ((4, 1500, "backbone"), (32, 1500, "backbone"),
                 (96, 1500, "backbone"), (128, 1500, "backbone"),
                 (4, 7000, "structured"))
# (B, L) of the sidechain kernels: the eval and train steps' batches, the
# longest proteins, the small sizes of the TPU kernel's tests and rows of
# one residue; rows of L = 37 and 500 start inside the kernels' blocks of 32
# and 30 residues; then the bench's eval mode (B=4 x L=500) and a logged
# structure of its trainer loop (one protein of L=256). Then a batch with
# every type of the table and ids outside it.
SIDECHAIN_CASES = ((8, 256), (16, 256), (8, 500), (3, 37), (1, 1), (5, 1),
                   (4, 500), (1, 256))
SIDECHAIN_TRAIN_CASE = (16, 256)
SIDECHAIN_TYPES_CASE = (3, 45)
# (B, H, L, D) of the attention kernels: predict's batches, the training
# step's, the longest proteins, and two small sizes
ATTENTION_CASES = ((8, 8, 256, 64), (16, 8, 256, 64), (8, 8, 500, 64),
                   (3, 2, 37, 16), (1, 1, 1, 16))
ATTENTION_PREDICT_CASE = (8, 8, 256, 64)
ATTENTION_TRAIN_CASE = (16, 8, 256, 64)
# (B, N) of the variant bench's first shape, L=256: the K4 rows' case
VARIANT_CASE = (8, 3584)
FLASH_TRAIN_REPEAT = 4   # 16 proteins x 4 / (8 x 500 residues) -> 5 steps
TIMED_RUNS = bench_drmsd_kernel.TIMED_RUNS
TRAIN_REPEAT = 8         # 16 proteins x 8 / (8 x 500 residues) -> 9 steps
MODEL = "conv-enc|21,11,3|1,1,1"
# stream synchronisations an eval step may make on the store path: none,
# the RMSD's Kabsch superposition being one kernel (ops/kabsch.py); the run
# prints the lines of any it finds
EVAL_SYNCS = 0
# arm -> (drmsd_impl, sidechain_impl, the optimizer's impl); drmsd_impl also
# picks the eval step's superposition RMSD: K5 in the "all" and "drmsd"
# arms, the tensor path with its SVD in the "plain" arm, whose optimizer is
# the foreach chain
ARMS = {"all": ("cuda", "cuda", "auto"), "drmsd": ("cuda", "torch", "auto"),
        "plain": ("torch", "torch", "torch")}

# The card's peaks for the bounds: HBM bytes/s, fp32 FLOP/s outside the
# tensor cores and dense TF32 FLOP/s inside them (NVIDIA's H100 SXM data
# sheet), and special-function operations a second (rsqrt, sqrt, exp): 16 a
# clock on each of the 132 SMs, at the 1.98 GHz that 67 TFLOP/s implies (132
# SMs x 128 lanes x 2 x 1.98 GHz).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_SPECIAL_PER_S = 132 * 16 * 1.98e9
# fp32 operations per valid pair i < j. K1a: per distance 3 subtractions, 5
# for the squared norm, max, rsqrt, a product (11), twice; the difference and
# its squared accumulation (3). K1b adds coef = 2 delta / Da (2), coef * diff
# (3) and the two accumulations per component (6). K1c needs both distances
# and their difference (23), then the same 11 on b's differences.
FLOPS_PER_PAIR = {"drmsd_fwd": 25, "drmsd_fwd_grad": 36, "drmsd_grad_b": 34}
# special-function operations per valid pair (K3: per weighted (query, key)
# pair): K1's two rsqrt; K4a and K4b one square root (the pair term's), K4c
# a square root and an rsqrt; one expf per pair in the forward (P) and in
# the backward (the recomputed P).
SPECIAL_PER_PAIR = {"drmsd_fwd": 2, "drmsd_fwd_grad": 2, "drmsd_grad_b": 2,
                    "drmsd_fwd_sqrt1": 1, "drmsd_fwd_mxu": 1,
                    "drmsd_grad_a_mxu": 2, "flash_attn_fwd": 1,
                    "flash_attn_bwd": 1}
# The variants, per valid pair: (fp32 operations outside the tensor cores,
# operations of the matrix products as mathematics has them, 2 x 3 per
# 3-deep or 3-wide product entry, not the padded or split ones). K4a: two
# squared distances in difference form (3 subtractions, 5 for the norm, max:
# 9 each), their sum and product, the root, its doubling and the
# subtraction (5), the accumulation (1). K4b: per squared distance the two
# norms' sum, the doubled cross term's subtraction and the max (4), then the
# same 6; the two cross terms are products (12). K4c: the two squared
# distances (8), sqrt, rsqrt, their product, 1 - x and the doubling (5), the
# row and the column sum (2); the two cross terms and coef x for the row and
# for the column atom (12 + 12).
VARIANT_FLOPS_PER_PAIR = {"drmsd_fwd_sqrt1": (24, 0),
                          "drmsd_fwd_mxu": (14, 12),
                          "drmsd_grad_a_mxu": (15, 24)}
# fp32 operations per live sidechain slot. K2a: the torsion's offset (1),
# two differences (6), three normalisations (11 each), two cross products
# (18), two sincos and four products (8), the placement (18). K2b recomputes
# the frame and the offsets (66) and adds three normalisation cotangents (24
# each), four cross products (36), the torsion cotangent (13), the
# accumulations (~30) and the sum into the angle's column (1).
FLOPS_PER_SLOT = {"sidechain_fwd": 84, "sidechain_bwd": 218}
# bytes per residue besides its id, each input read once and each output
# written once: K2a reads bb 48 and angles 48 (the anchor is a neighbour's
# bb) and writes 168; K2b reads the built points and their cotangent (336)
# and the angles (48), and writes the cotangents of bb and angles (96). Both
# read the packed force-field table once (``sidechain_bytes``).
SIDECHAIN_BYTES = {"sidechain_fwd": 48 + 48 + 168,
                   "sidechain_bwd": 336 + 48 + 96}
# operations per (query, key) pair that carries weight, in units of the head
# dimension D: (fp32 on the CUDA cores, products on the tensor cores as
# mathematics has them, not the split ones). K3a: S = Q K^T and P V on the
# tensor cores (2 D each). The backward: S, dP = dO V^T, dV, dK and dQ on
# the tensor cores (2 D each), counted once though each of its two roles
# recomputes S and dP. The exp, the maxima and the sums per pair are left
# out (~10 against 256 at D=64).
ATTENTION_FLOPS_PER_PAIR = {"flash_attn_fwd": (0, 4),
                            "flash_attn_bwd": (0, 10)}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# median ms of fn() over TIMED_RUNS runs, one CUDA event pair a run
cuda_ms = bench_drmsd_kernel.event_ms


def bound(n_bytes: float, flops: float, tensor_flops: float = 0.0,
          special: float = 0.0,
          tensor_peak: float = PEAK_TF32_FLOPS) -> tuple[float, str]:
    """(ms, "bytes" | "operations" | "special functions"): the least time
    the card could take to move n_bytes, do flops fp32 operations outside
    the tensor cores, tensor_flops operations inside them at tensor_peak
    (TF32 unless given) and special special-function operations, and which
    of the three it is."""
    times = {"bytes": n_bytes / PEAK_BYTES_PER_S,
             "operations": max(flops / PEAK_FP32_FLOPS,
                               tensor_flops / tensor_peak),
             "special functions": special / PEAK_SPECIAL_PER_S}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


# device ms of everything one fn() call puts on the device, and the
# profiler's device-side records of some calls
device_ms = bench_drmsd_kernel.device_ms
device_records = bench_drmsd_kernel.device_records


def attention_bound(name: str, shape, pairs: int, with_stats: bool = False,
                    elem: int = 4) -> tuple[float, str]:
    """``bound`` of a flash kernel at (B, H, L, D) = ``shape`` for
    ``pairs`` weighted (query, key) pairs, on tensors of ``elem`` bytes an
    element (4: the float32 instance, whose products count at the TF32
    rate; 2: the bf16 instance, at the bf16 rate, one product a pair-term
    where the fp32 instance takes three). Bytes: each (B, H, L, D) tensor
    and each (B, H, L) float32 statistic read or written once, and the
    mask. K3a reads q, k, v and writes O, and m and l ``with_stats``; the
    backward reads q, k, v, dO, O, m and l and writes dQ, dK and dV."""
    bsz, heads, length, dim = shape
    tensor = elem * bsz * heads * length * dim
    stats = 4 * bsz * heads * length
    n_bytes = {"flash_attn_fwd": 4 * tensor + (2 * stats if with_stats
                                               else 0),
               "flash_attn_bwd": 8 * tensor + 2 * stats}[name] \
        + bsz * length
    fp32_d, tensor_d = ATTENTION_FLOPS_PER_PAIR[name]
    return bound(n_bytes, fp32_d * dim * pairs, tensor_d * dim * pairs,
                 special=SPECIAL_PER_PAIR[name] * pairs,
                 tensor_peak=PEAK_BF16_FLOPS if elem == 2
                 else PEAK_TF32_FLOPS)


def profile_steps(fn, steps: int = 3) -> tuple[float, float]:
    """(device operations per call, device ms per call) of fn() from a
    torch.profiler trace of ``steps`` calls: every kernel, copy and memset
    the device ran."""
    on_device = device_records(fn, steps)
    return (sum(e.count for e in on_device) / steps,
            sum(e.self_device_time_total for e in on_device) / 1e3 / steps)


def device_only(times: dict) -> str:
    """'; device-only ms: name x, ...' for the kernels that have one."""
    if not any(t is not None for t in times.values()):
        return ""
    return "; device-only ms: " + ", ".join(
        f"{name} {t:.4f}" for name, t in times.items() if t is not None)


def phase_device():
    dev = cuda_device()
    card = bench_drmsd_kernel.card_label()
    print(f"[device] {torch.cuda.get_device_name(dev)}; torch "
          f"{torch.__version__}; CUDA {torch.version.cuda}")
    print(card)
    return dev, card


def kernel_resources(log: str, kernels) -> dict:
    """{(kernel, D): (registers, spill store bytes, spill load bytes)} of
    each instance of ``kernels`` (templated on D) in a ptxas -v log."""
    out = {}
    for entry in log.split("Compiling entry function")[1:]:
        name = re.search("(" + "|".join(kernels) + r")ILi(\d+)E", entry)
        if name is None:
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        out[name[1], int(name[2])] = (int(regs[1]), int(spills[1]),
                                      int(spills[2]))
    return out


def phase_build():
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        libs = list(pool.map(_build.build, LIBRARIES))
    for name in LIBRARIES:
        _build.load(name)
    print(f"[build] {', '.join(LIBRARIES)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s ("
          + ", ".join(os.path.relpath(lib, ROOT) for lib in libs) + ")")
    resources = kernel_resources(_build.ptxas_log("attention"), BF16_KERNELS)
    require(sorted(resources) == sorted(
        (kernel, dim) for kernel in BF16_KERNELS for dim in A.HEAD_DIMS),
        f"ptxas reports every bf16 kernel at every D ({sorted(resources)})")
    for (kernel, dim), (regs, stores, loads) in sorted(resources.items()):
        print(f"[build] {kernel}<{dim}>: {regs} registers, {stores} bytes "
              f"spill stores, {loads} bytes spill loads (ptxas -v)")
    require(all(stores == loads == 0 for (_, dim), (_, stores, loads)
                in resources.items() if dim == 64),
            "no bf16 kernel spills at D = 64")
    return resources


def drmsd_from(s, c):
    return torch.sqrt(torch.clamp(s / c.clamp(min=1).to(s.dtype), min=1e-30))


def grad_err(got, want, what):
    """max |got - want|, held to 1e-4 * max(1, max|want|)."""
    err = float((got - want).abs().max())
    bound = 1e-4 * max(1.0, float(want.abs().max()))
    require(err <= bound, f"{what}: gradient error {err:.3e} <= {bound:.3e}")
    return err


def k1_inputs(dev, rng, bsz, n, masks="random"):
    """a, b ~ N(0, 10) of (B, N, 3) and a (B, N) mask: ~70% of atoms valid
    at random ("random"), the training step's full-atom masks
    ("structured": ``atom_mask_case``: residues' real slots, 2% missing,
    padded tails) or its backbone masks ("backbone": the N, CA and C slots
    of the full-atom masks of N / 3 residues, as ``losses.per_protein_drmsd``
    takes them); the last protein all masked either way."""
    a, b = (torch.from_numpy(rng.normal(0, 10, (bsz, n, 3)).astype(
        np.float32)).to(dev) for _ in range(2))
    if masks == "random":
        m = torch.from_numpy(rng.random((bsz, n)) < 0.7).to(dev)
        m[-1] = False  # an all-masked protein
    elif masks == "structured":
        m = torch.from_numpy(atom_mask_case(rng, bsz, n)).to(dev)
    else:
        res = n // 3
        full = atom_mask_case(rng, bsz, res * NUM_PREDICTED_COORDS)
        m = torch.from_numpy(np.ascontiguousarray(
            full.reshape(bsz, res, NUM_PREDICTED_COORDS)[:, :, :3]
            .reshape(bsz, n))).to(dev)
    return a, b, m


def k1_check(a, b, m, where):
    """K1a, K1b and K1c against their plain versions on one input, each
    called twice; returns (|d dRMSD| in A, |d dS/da|, |d dS/db|, C, plain
    dS/da)."""
    fs, fc = D.drmsd_stats_cuda(a, b, m)
    gs, gc, ga = D.drmsd_stats_grad_cuda(a, b, m)
    gb = D.drmsd_grad_b_cuda(a, b, m)
    ps, pc = D.drmsd_stats_torch(a, b, m)
    _, _, pga = D.drmsd_stats_grad_torch(a, b, m)
    pgb = D.drmsd_grad_b_torch(a, b, m)
    torch.cuda.synchronize()
    require(torch.isfinite(fs).all().item(), f"K1a values finite, {where}")
    require(torch.equal(fc, pc) and torch.equal(gc, pc),
            f"pair counts equal, {where}")
    require(torch.equal(gs, fs), f"K1b's S has K1a's bits, {where}")
    require(int(fc[-1]) == 0 and float(fs[-1]) == 0.0
            and not ga[-1].any() and not gb[-1].any(),
            f"all-masked protein gives zero S, C and gradients, {where}")
    err = float((drmsd_from(fs, fc) - drmsd_from(ps, pc)).abs().max())
    require(err <= 1e-4, f"|d dRMSD| {err:.3e} <= 1e-4 A, {where}")
    ga_err = grad_err(ga, pga, f"K1b dS/da, {where}")
    gb_err = grad_err(gb, pgb, f"K1c dS/db, {where}")
    gs2, _, ga2 = D.drmsd_stats_grad_cuda(a, b, m)
    require(torch.equal(gs2, gs) and torch.equal(ga2, ga)
            and torch.equal(D.drmsd_grad_b_cuda(a, b, m), gb)
            and torch.equal(D.drmsd_stats_cuda(a, b, m)[0], fs),
            f"a second call gives the same bits, {where}")
    return err, ga_err, gb_err, fc, pga


def kernel_case(dev, card, rng, bsz, n, structured=False):
    """All three dRMSD kernels against their plain versions on one (B, N)
    case (``k1_inputs``: random masks, or with ``structured`` the training
    step's). Returns {kernel: (max abs error, kernel ms, plain ms, bound
    ms, what bounds it, device ms or None)}."""
    a, b, m = k1_inputs(dev, rng, bsz, n,
                        "structured" if structured else "random")
    where = f"B={bsz} N={n}" + (" structured masks" if structured else "")
    err, ga_err, gb_err, fc, pga = k1_check(a, b, m, where)
    # bytes: a, b and the mask read once; S and C, or a gradient, written
    pairs = int(fc.sum())
    read = bsz * n * 25
    written = {"drmsd_fwd": bsz * 12, "drmsd_fwd_grad": bsz * (12 + n * 12),
               "drmsd_grad_b": bsz * n * 12}
    bounds = {k: bound(read + w, FLOPS_PER_PAIR[k] * pairs,
                       special=SPECIAL_PER_PAIR[k] * pairs)
              for k, w in written.items()}
    calls = {"drmsd_fwd": (err, D.drmsd_stats_cuda, D.drmsd_stats_torch),
             "drmsd_fwd_grad": (ga_err, D.drmsd_stats_grad_cuda,
                                D.drmsd_stats_grad_torch),
             "drmsd_grad_b": (gb_err, D.drmsd_grad_b_cuda,
                              D.drmsd_grad_b_torch)}
    # device-only time at the shapes of the kernels' table rows, and at the
    # longest proteins
    in_table = structured or (bsz, n) in K1_DEVICE_CASES
    out = {k: (e, cuda_ms(lambda: kernel(a, b, m)),
               cuda_ms(lambda: plain(a, b, m)), *bounds[k],
               device_ms(lambda: kernel(a, b, m)) if in_table else None)
           for k, (e, kernel, plain) in calls.items()}
    scale = float(pga.abs().max())
    print(f"[kernel] {where}: counts equal, K1b S == K1a S (bits), "
          f"|d dRMSD| {err:.3e} A, |d dS/da| {ga_err:.3e} (max|g| "
          f"{scale:.3e}), |d dS/db| {gb_err:.3e}; kernel vs plain ms: "
          + ", ".join(f"{k} {v[1]:.4f} vs {v[2]:.4f}"
                      for k, v in out.items())
          + f"; {pairs} valid pairs, bounds in ms: "
          + ", ".join(f"{k} {v[3]:.5f} by {v[4]}" for k, v in out.items())
          + device_only({k: v[5] for k, v in out.items()})
          + f" (median of {TIMED_RUNS}; {card})")
    return out


def path_kernel_cases(dev, card) -> dict:
    """K1a, K1b and K1c against their plain versions, checked only, at the
    (B, N) and on the masks that the later phases' paths give them
    (PATH_K1_CASES); returns {kernel: max abs error}."""
    rng = np.random.default_rng(5)
    errs = {}
    for bsz, n, masks in PATH_K1_CASES:
        a, b, m = k1_inputs(dev, rng, bsz, n, masks)
        where = f"B={bsz} N={n} {masks} masks"
        err, ga_err, gb_err, fc, pga = k1_check(a, b, m, where)
        for name, e in (("drmsd_fwd", err), ("drmsd_fwd_grad", ga_err),
                        ("drmsd_grad_b", gb_err)):
            errs[name] = max(errs.get(name, 0.0), e)
        print(f"[kernel] {where} (a later phase's path): counts equal "
              f"({int(fc.sum())} valid pairs), K1b S == K1a S (bits), same "
              f"bits twice, |d dRMSD| {err:.3e} A, |d dS/da| {ga_err:.3e} "
              f"(max|g| {float(pga.abs().max()):.3e}), |d dS/db| "
              f"{gb_err:.3e} ({card})")
        del a, b, m, pga
    return errs


def phase_kernel(dev, card):
    """Returns ({case: kernel_case(...)} on the random masks, the same at
    the table's two shapes on the structured masks, {kernel: max abs error}
    at the later phases' shapes)."""
    rng = np.random.default_rng(0)
    random = {case: kernel_case(dev, card, rng, *case)
              for case in KERNEL_CASES}
    structured = {case: kernel_case(dev, card, rng, *case, structured=True)
                  for case in (TRAIN_CASE, EVAL_CASE)}
    return random, structured, path_kernel_cases(dev, card)


VARIANT_STATS = {
    "drmsd_fwd_sqrt1": (V.drmsd_stats_sqrt1_cuda, V.drmsd_stats_sqrt1_torch),
    "drmsd_fwd_mxu": (V.drmsd_stats_mxu_cuda, V.drmsd_stats_mxu_torch)}


def variant_case(dev, rng, bsz, n, structured=False):
    """K4a, K4b and K4c on one (B, N) case, against their plain versions
    and against K1a / K1b: ~70% of atoms valid at random, or with
    ``structured`` the training step's masks (``atom_mask_case``) with one
    protein of a single valid atom; the last protein all masked either way.
    Each kernel call follows a NaN-poisoning of the allocator, so that a
    partial a block fails to write shows. Returns {kernel: max abs error}
    (dRMSD in A for the statistics, the gradient's entries for K4c)."""
    a, b = (torch.from_numpy(rng.normal(0, 10, (bsz, n, 3)).astype(
        np.float32)).to(dev) for _ in range(2))
    if structured:
        m = torch.from_numpy(atom_mask_case(rng, bsz, n)).to(dev)
        m[0] = False
        m[0, n // 2] = True  # one valid atom: no pair
    else:
        m = torch.from_numpy(rng.random((bsz, n)) < 0.7).to(dev)
        m[-1] = False  # an all-masked protein
    where = f"B={bsz} N={n}" + (" structured masks" if structured else "")
    cur_s, cur_c = D.drmsd_stats_cuda(a, b, m)
    cur_g = D.drmsd_stats_grad_cuda(a, b, m)[2]
    empty = [-1, 0] if structured else [-1]
    errs = {}
    for name, (kernel, plain) in VARIANT_STATS.items():
        poison_allocator(dev)
        s, c = kernel(a, b, m)
        ps, pc = plain(a, b, m)
        torch.cuda.synchronize()
        require(torch.equal(c, pc) and torch.equal(c, cur_c),
                f"{name}: pair counts equal to plain's and K1a's, {where}")
        require(not c[empty].any() and not s[empty].any(),
                f"{name}: proteins without a pair give exact zeros, {where}")
        poison_allocator(dev)
        require(torch.equal(kernel(a, b, m)[0], s),
                f"{name}: a second call gives the same bits, {where}")
        errs[name] = max(
            float((drmsd_from(s, c) - drmsd_from(ref, c)).abs().max())
            for ref in (ps, cur_s))
        require(errs[name] <= 1e-4, f"{name}: |d dRMSD| {errs[name]:.3e} <= "
                                    f"1e-4 A of plain and of K1a, {where}")
    poison_allocator(dev)
    g = V.drmsd_grad_a_mxu_cuda(a, b, m)
    pg = V.drmsd_grad_a_mxu_torch(a, b, m)
    torch.cuda.synchronize()
    require(not g[empty].any().item(),
            f"K4c: proteins without a pair give a zero gradient, {where}")
    require(torch.equal(V.drmsd_grad_a_mxu_cuda(a, b, m), g),
            f"K4c: a second call gives the same bits, {where}")
    errs["drmsd_grad_a_mxu"] = max(
        grad_err(g, pg, f"K4c dS/da against plain, {where}"),
        grad_err(g, cur_g, f"K4c dS/da against K1b, {where}"))
    print(f"[variants] {where}: counts equal, zeros without a pair, same "
          f"bits twice; |d dRMSD| K4a "
          f"{errs['drmsd_fwd_sqrt1']:.3e} A, K4b {errs['drmsd_fwd_mxu']:.3e} "
          f"A; |d dS/da| K4c {errs['drmsd_grad_a_mxu']:.3e} (max|g| "
          f"{float(pg.abs().max()):.3e}), each against plain and K1")
    return errs


def variant_accuracy(dev):
    """S of K1a, K4a and K4b against a float64 run of the plain version, on
    the bench tool's own inputs: its parity protein (gate 1e-5 relative) and
    its two bench shapes (gate 1e-4)."""
    for shape, masked, gate in (((700,), 0.2, 1e-5), ((8, 3584), 0.1, 1e-4),
                                ((8, 7000), 0.1, 1e-4)):
        a, b, m = bench_drmsd_kernel.case(dev, shape, masked)
        exact = D.drmsd_stats_torch(a.double(), b.double(), m)[0]
        rel = {}
        for name, fn in (("K1a", D.drmsd_stats_cuda),
                         ("K4a", V.drmsd_stats_sqrt1_cuda),
                         ("K4b", V.drmsd_stats_mxu_cuda),
                         ("K1a plain", D.drmsd_stats_torch),
                         ("K4a plain", V.drmsd_stats_sqrt1_torch),
                         ("K4b plain", V.drmsd_stats_mxu_torch)):
            s = fn(a, b, m)[0].double()
            rel[name] = float(((s - exact).abs() / exact.abs()).max())
        print(f"[variants] S against float64, a ~ N(0, 30), b = a + N(0, 1), "
              f"shape {shape}: relative error "
              + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
              + f" (gate {gate} for the kernels)")
        for name in ("K1a", "K4a", "K4b"):
            require(rel[name] <= gate, f"{name}: S within {gate} relative of "
                                       f"float64 at shape {shape} "
                                       f"({rel[name]:.2e})")


def variant_times(dev, card, shape):
    """{kernel: (kernel ms, plain ms, bound ms, what bounds it, device ms)}
    of the three variants, and K1a's and K1b's kernel and device ms beside
    them, on the bench's inputs at ``shape`` = (B, N)."""
    a, b, m = bench_drmsd_kernel.case(dev, shape, masked=0.1)
    bsz, n = shape
    pairs = int(D.drmsd_stats_cuda(a, b, m)[1].sum())
    read = bsz * n * 25
    written = {"drmsd_fwd_sqrt1": bsz * 12, "drmsd_fwd_mxu": bsz * 12,
               "drmsd_grad_a_mxu": bsz * n * 12}
    calls = {**VARIANT_STATS,
             "drmsd_grad_a_mxu": (V.drmsd_grad_a_mxu_cuda,
                                  V.drmsd_grad_a_mxu_torch)}
    out = {}
    for name, (kernel, plain) in calls.items():
        flops, tensor_flops = VARIANT_FLOPS_PER_PAIR[name]
        out[name] = (cuda_ms(lambda: kernel(a, b, m)),
                     cuda_ms(lambda: plain(a, b, m)),
                     *bound(read + written[name], flops * pairs,
                            tensor_flops * pairs,
                            SPECIAL_PER_PAIR[name] * pairs),
                     device_ms(lambda: kernel(a, b, m)))
    cur = {name: (cuda_ms(lambda: fn(a, b, m)),
                  device_ms(lambda: fn(a, b, m)))
           for name, fn in (("drmsd_fwd", D.drmsd_stats_cuda),
                            ("drmsd_fwd_grad", D.drmsd_stats_grad_cuda))}
    print(f"[variants] B={bsz} N={n}, {pairs} valid pairs: kernel ms (device "
          f"only) vs plain ms, bound: "
          + ", ".join(f"{name} {v[0]:.4f} ({v[4]:.4f}) vs {v[1]:.4f}, "
                      f"{v[2]:.5f} by {v[3]} ({v[2] / v[4]:.0%} of it on "
                      f"the device)" for name, v in out.items())
          + "; beside them "
          + ", ".join(f"{name} {v[0]:.4f} ({v[1]:.4f})"
                      for name, v in cur.items())
          + f" (median of {TIMED_RUNS}; {card})")
    return out


def phase_variants(dev, card):
    """The kernel variants K4a, K4b, K4c, then the bench tool through its
    ``main``. Returns ({kernel: (kernel ms, plain ms, bound ms, bound by,
    device ms)} at VARIANT_CASE, {kernel: max abs error}, the launches of the
    tool's run)."""
    rng = np.random.default_rng(3)
    errs = {}
    for case, structured in ([(case, False) for case in KERNEL_CASES]
                             + [(TRAIN_CASE, True), (EVAL_CASE, True)]):
        for name, err in variant_case(dev, rng, *case,
                                      structured=structured).items():
            errs[name] = max(errs.get(name, 0.0), err)
    variant_accuracy(dev)
    table = variant_times(dev, card, VARIANT_CASE)
    variant_times(dev, card, (8, 7000))

    reset_launches()
    out = bench_drmsd_kernel.main(["--parity"])
    launches = read_launches()
    # per shape 3 warm-up and TIMED_RUNS timed calls, then 1 + 5 traced ones,
    # and 5 more for each trace the profiler returned without device records
    nominal = len(bench_drmsd_kernel.SHAPES) * (
        3 + bench_drmsd_kernel.TIMED_RUNS + 6)
    calls = {counter: bench_drmsd_kernel.CALLS[name] for counter, name in (
        ("drmsd_fwd", "cur"), ("drmsd_fwd_grad", "grad cur"),
        ("drmsd_fwd_sqrt1", "sqrt1"), ("drmsd_fwd_mxu", "mxu"),
        ("drmsd_grad_a_mxu", "grad mxu"))}
    require(all(n >= nominal and (n - nominal) % 5 == 0
                for n in calls.values()),
            f"the bench tool called each kernel {nominal} times, or 5 more "
            f"for each trace taken again: {calls}")
    expected = launched(**{counter: 1 + n for counter, n in calls.items()})
    require(launches == expected,
            f"bench tool launches {launches}: expected {expected} (parity "
            f"once, then 3 warm-up, {bench_drmsd_kernel.TIMED_RUNS} timed "
            f"and 6 traced calls at each of "
            f"{len(bench_drmsd_kernel.SHAPES)} shapes, and 5 for each trace "
            f"taken again: {calls})")
    require(set(out) == {"parity", "bench"}
            and set(out["bench"]) == set(bench_drmsd_kernel.SHAPES),
            "the bench tool ran its parity check and both shapes")
    for (length, bsz), t in out["bench"].items():
        ratios = {name: " / ".join(f"{x / ref:.2f}x"
                                   for x, ref in zip(t[name], t[cur]))
                  for name, cur in (("fwd sqrt1", "fwd cur"),
                                    ("fwd mxu", "fwd cur"),
                                    ("bwd mxu", "bwd cur"))}
        print(f"[variants] the bench's answer at L={length} B={bsz}, times "
              f"against cur's by events / on the device: fwd sqrt1 "
              f"{ratios['fwd sqrt1']}, fwd mxu {ratios['fwd mxu']} (K1a: "
              f"{t['fwd cur'][0]:.4f} / {t['fwd cur'][1]:.4f} ms); bwd mxu "
              f"{ratios['bwd mxu']} (K1b, which also gives S and C: "
              f"{t['bwd cur'][0]:.4f} / {t['bwd cur'][1]:.4f} ms) ({card})")
    return table, errs, launches


def sidechain_grads(inputs, impl):
    """The build through ``impl`` from fresh leaves of the backbone and the
    angles; returns (coordinates, their gradients of sum(sin(0.3 crd)))."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs[:2]]
    crd = S.build_sidechains(*leaves, inputs[2], impl=impl)
    grads = torch.autograd.grad(torch.sin(0.3 * crd).sum(), leaves)
    return crd.detach(), grads


def poison_allocator(dev, dtype=torch.float32):
    """Leave NaNs where the caching allocator hands out the next blocks, so
    that an output entry a kernel fails to write shows: 256 MB of ``dtype``
    NaNs (bf16 ones read as NaN in a float32 or a bf16 output)."""
    elem = torch.finfo(dtype).bits // 8
    torch.full(((256 << 20) // elem,), float("nan"), device=dev, dtype=dtype)
    torch.cuda.synchronize()


def sidechain_case_check(dev, rng, bsz, length, physical, every_type=False):
    """K2a and K2b against the plain version on one (B, L) case; returns
    (the inputs, max forward error, max gradient error). The ids are int64
    as the training batches hold them, int32 in the case of every type."""
    ang, ids = sidechain_case(rng, bsz, length, physical)
    where = (f"B={bsz} L={length} "
             f"{'physical' if physical else 'full-range'} angles")
    if bsz * length >= 60:
        # every row but the first ends in padding (id 20), so a batch of
        # one protein has none
        require(set(range(21 if bsz > 1 else 20))
                <= set(ids.ravel().tolist()),
                f"all 20 amino acids{' and padding' * (bsz > 1)} in the "
                f"batch, {where}")
    if every_type:
        ids = with_every_type(rng, ids)
        where += ", every type of the table and ids outside it"
        require(set(range(S.N_TYPES)) | set(OUT_OF_TABLE_IDS)
                <= set(ids.ravel().tolist()), f"every id, {where}")
    ang = torch.from_numpy(ang).to(dev)
    ids = torch.from_numpy(ids).to(dev)
    if not every_type:
        ids = ids.long()
    with torch.no_grad():
        bb = G.build_backbone(ang)
    inputs = (bb, ang, ids)
    want, p_grads = sidechain_grads(inputs, "torch")
    poison_allocator(dev)
    got, k_grads = sidechain_grads(inputs, "cuda")
    torch.cuda.synchronize()
    require(torch.isfinite(got).all().item()
            and all(torch.isfinite(g).all().item() for g in k_grads),
            f"values and gradients finite, padded rows included, every entry "
            f"written, {where}")
    n_sc = S.sidechain_inputs(bb, ang, ids)[4]
    dead = torch.arange(S.MAX_SC_ATOMS, device=dev) >= n_sc[..., None]
    require(not got[:, :, 4:][dead].any().item()
            and torch.equal(got[:, :, :4], bb),
            f"dead slots exactly zero and the backbone passed through, "
            f"{where}")
    # The plain build in float64 on the same inputs is the yardstick: at
    # coordinates of hundreds of A one fp32 rounding is ~1e-5 A, and the fp32
    # plain build itself strays by several of them over its ten slots.
    err = float((got - want).abs().max())
    with torch.no_grad():
        exact = S.build_sidechains_torch(bb.double(), ang.double(), ids)
    k_far = float((got - exact).abs().max())
    p_far = float((want - exact).abs().max())
    require(k_far <= 2 * p_far + 1e-5,
            f"kernel {k_far:.3e} A from a float64 build, plain {p_far:.3e} "
            f"A: within twice plus 1e-5 A, {where}")
    if physical:
        require(k_far <= 1e-4 and err <= 1e-4 + p_far,
                f"kernel within 1e-4 A of the float64 build ({k_far:.3e}) "
                f"and of the fp32 plain build up to that one's own distance "
                f"({err:.3e} <= 1e-4 + {p_far:.3e}), {where}")
    g_err = max(grad_err(k, p, f"K2b d/d{name}, {where}") for name, k, p in
                zip(("bb", "angles"), k_grads, p_grads))
    poison_allocator(dev)
    got2, k_grads2 = sidechain_grads(inputs, "cuda")
    require(torch.equal(got2, got)
            and all(torch.equal(a, b) for a, b in zip(k_grads2, k_grads)),
            f"a second call gives the same bits, {where}")
    print(f"[kernel] sidechain {where}: |d coordinate| {err:.3e} A vs plain, "
          f"from a float64 plain build kernel {k_far:.3e} A and plain "
          f"{p_far:.3e} A, |d gradient| {g_err:.3e} (max|g| "
          f"{max(float(g.abs().max()) for g in p_grads):.3e}), dead slots "
          f"zero, same bits twice")
    return inputs, err, g_err


def sidechain_bytes(name, ids):
    """What K2a or K2b must move for these ids: ``SIDECHAIN_BYTES`` and the
    id a residue, and the packed table once."""
    table = S.ff_table(ids.device)
    return ((SIDECHAIN_BYTES[name] + ids.element_size()) * ids.numel()
            + table.numel() * table.element_size())


def sidechain_times(inputs, card):
    """{kernel: (kernel ms, plain ms, bound ms, what bounds it, device ms or
    None)} on one case's inputs, and the forward + backward pair through
    autograd."""
    bb, ang, ids = inputs
    leaves = [t.detach().clone().requires_grad_() for t in (bb, ang)]

    def fwd(impl):
        with torch.no_grad():
            return S.build_sidechains(bb, ang, ids, impl=impl)

    def fwd_bwd(impl):
        crd = S.build_sidechains(*leaves, ids, impl=impl)
        return torch.autograd.grad(crd, leaves, g_out)

    built = fwd("cuda")
    g_out = torch.randn_like(built)
    plain_graph = S.build_sidechains(*leaves, ids, impl="torch")
    n_res = ids.numel()
    live = int(S.sidechain_inputs(bb, ang, ids)[4].clamp(
        max=S.MAX_SC_ATOMS).sum())
    times = {
        "sidechain_fwd": (cuda_ms(lambda: fwd("cuda")),
                          cuda_ms(lambda: fwd("torch"))),
        "sidechain_bwd": (
            cuda_ms(lambda: S.sidechain_bwd_cuda(built, ang, ids, g_out)),
            cuda_ms(lambda: torch.autograd.grad(plain_graph, leaves, g_out,
                                                retain_graph=True)))}
    shape = tuple(ids.shape)
    dev_ms = dict.fromkeys(times)
    if shape == SIDECHAIN_TRAIN_CASE:
        dev_ms = {"sidechain_fwd": device_ms(lambda: fwd("cuda")),
                  "sidechain_bwd": device_ms(lambda: S.sidechain_bwd_cuda(
                      built, ang, ids, g_out))}
    out = {k: (*v, *bound(sidechain_bytes(k, ids),
                          FLOPS_PER_SLOT[k] * live), dev_ms[k])
           for k, v in times.items()}
    pair = (cuda_ms(lambda: fwd_bwd("cuda")), cuda_ms(lambda: fwd_bwd("torch")))
    print(f"[kernel] sidechain B={shape[0]} L={shape[1]}: kernel vs plain "
          f"ms: K2a {out['sidechain_fwd'][0]:.4f} vs "
          f"{out['sidechain_fwd'][1]:.4f}, K2b {out['sidechain_bwd'][0]:.4f} "
          f"vs {out['sidechain_bwd'][1]:.4f}, forward + backward through "
          f"autograd {pair[0]:.4f} vs {pair[1]:.4f}; {live} live slots in "
          f"{n_res} residues, bounds in ms: "
          + ", ".join(f"{k} {v[2]:.5f} by {v[3]}" for k, v in out.items())
          + device_only({k: v[4] for k, v in out.items()})
          + f" (median of {TIMED_RUNS}; {card})")
    return out


def phase_sidechain_kernel(dev, card):
    """Returns ({case: {kernel: (kernel ms, plain ms, bound ms, bound by,
    device ms or None)}}, {kernel: max abs error against plain}); the
    forward error is that on physical angles."""
    rng = np.random.default_rng(1)
    table, errs = {}, {"sidechain_fwd": 0.0, "sidechain_bwd": 0.0}
    for case in (*((c, False) for c in SIDECHAIN_CASES),
                 (SIDECHAIN_TYPES_CASE, True)):
        (bsz, length), every_type = case
        _, _, g_full = sidechain_case_check(dev, rng, bsz, length,
                                            physical=False,
                                            every_type=every_type)
        inputs, err, g_phys = sidechain_case_check(dev, rng, bsz, length,
                                                   physical=True,
                                                   every_type=every_type)
        errs["sidechain_fwd"] = max(errs["sidechain_fwd"], err)
        # a lone residue is anchored on its own C: a degenerate frame whose
        # gradients are ~1e23, held to the relative gate above only
        if length > 1:
            errs["sidechain_bwd"] = max(errs["sidechain_bwd"], g_full,
                                        g_phys)
        if not every_type:
            table[(bsz, length)] = sidechain_times(inputs, card)
    return table, errs


# K5 against the tensor path run in float64 on the same card inputs: the
# largest relative gap over bench_kabsch's two shapes, and K5's against the
# float32 tensor path, at most K5_REL_TOL plus that path's own gap
K5_REL_TOL = 1e-6
# bench_kabsch's shape of the K5 row: the scoring step's full-atom batch
K5_CASE = "32x7000"


def phase_kabsch_kernel(card) -> dict:
    """K5 through bench_kabsch's ``main``: at the scoring step's B = 32 x
    N = 7,000 and 1,500, within K5_REL_TOL of float64, one launch and no
    stream synchronisation a call, against the tensor path's two
    synchronisations. Returns the tool's results."""
    out = bench_kabsch.main()
    for shape in (f"{b}x{n}" for b, n in bench_kabsch.SHAPES):
        k5, plain = out[shape]["cuda"], out[shape]["torch"]
        require(k5["gap_fp64"]["rel"] <= K5_REL_TOL,
                f"K5 at {shape}: {k5['gap_fp64']['rel']:.3e} relative from "
                f"the float64 tensor path, at most {K5_REL_TOL}")
        require(k5["gap_plain"]["rel"]
                <= K5_REL_TOL + plain["gap_fp64"]["rel"],
                f"K5 at {shape}: {k5['gap_plain']['rel']:.3e} relative from "
                f"the float32 tensor path, whose own gap to float64 is "
                f"{plain['gap_fp64']['rel']:.3e}")
        require(k5["launches"] == 1 and plain["launches"] == 0
                and k5["syncs"] == 0,
                f"K5 at {shape}: one launch and no synchronisation a call, "
                f"none on the tensor path: {k5}, {plain}")
        print(f"[kernel] K5 B x N = {shape}: {k5['gap_fp64']['rel']:.2e} "
              f"relative from float64 (tensor path in float32 "
              f"{plain['gap_fp64']['rel']:.2e}); {k5['ms']:.4f} ms "
              f"({k5['device_ms']:.4f} on the device) vs plain "
              f"{plain['ms']:.4f} ({plain['device_ms']:.4f}, "
              f"{plain['device_ops']:.0f} operations, {plain['syncs']} "
              f"synchronisations); bound {out[shape]['bound_ms']:.5f} ms by "
              f"{out[shape]['bound_by']} ({card})")
    return out


# K6 against the foreach chain fed the kernel's float64 norm, every entry of
# the parameters and both moments after K6_UPDATES updates: within K6_ULP
# ulp of float32 or K6_REL_TOL relative (tests/test_torch_adam.py's limit)
K6_ULP, K6_REL_TOL = 2, 1e-6
K6_UPDATES = 3


def k6_float64_norm(grads, sliced=None):
    """The global norm as K6 takes it: the float64 sum of the squares, its
    root rounded to float32 (one rank: no gradient is a slice)."""
    return torch.sqrt(sum(g.double().square().sum() for g in grads)).float()


def k6_updates(impl, params, grads_seq):
    """Updates of a copy of ``params`` through ``Optimizer.update`` on the
    path ``impl``, Adam with decay, the clip at 1.0 and the Noam step, one
    a gradient list of ``grads_seq``; the foreach chain takes the norm as
    K6 does. Returns (the parameters and both moments, K6's launches)."""
    named = {k: v.clone() for k, v in params.items()}
    tx = optim.Optimizer("adam", optim.noam_schedule(512, 4000), True, 1.0,
                         impl=impl)
    if impl == "torch":
        tx.global_norm = k6_float64_norm
    state = tx.init(named)
    before = AD.adam_update_cuda.launches
    for grads in grads_seq:
        state = tx.update(named, [g.clone() for g in grads], state)
    return ([*named.values(), *state.mu, *state.nu],
            AD.adam_update_cuda.launches - before)


def phase_adam_kernel(dev, card) -> dict:
    """K6 on the flagship's parameters against the foreach chain, then both
    timed by bench_adam's ``bench_set``. Returns the tool's row with the
    largest gaps."""
    cfg = TrainConfig(model=MODEL, d_model=512, d_ff=2048, n_heads=8,
                      n_layers=6).finalize()
    shapes = bench_adam.shapes(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {f"p{i}": 0.02 * torch.randn(s, device=dev, generator=gen)
              for i, s in enumerate(shapes)}
    grads_seq = [[1e-3 * torch.randn(s, device=dev, generator=gen)
                  for s in shapes] for _ in range(K6_UPDATES)]
    norm = float(k6_float64_norm(grads_seq[0]))
    require(norm > 1.0, f"the gradients engage the clip: norm {norm}")
    got, launches = k6_updates("cuda", params, grads_seq)
    want, plain_launches = k6_updates("torch", params, grads_seq)
    require(launches == ADAM_LAUNCHES * K6_UPDATES and plain_launches == 0,
            f"K6 launched {launches} times in {K6_UPDATES} updates (expected "
            f"{ADAM_LAUNCHES * K6_UPDATES}), the foreach chain "
            f"{plain_launches} (expected 0)")
    bad, gap_abs, gap_rel = 0, 0.0, 0.0
    for a, b in zip(got, want):
        b64 = b.double()
        gap = (a.double() - b64).abs()
        ulp = (torch.nextafter(b.abs(), torch.full_like(b, math.inf))
               - b.abs()).double()
        bad += int(((gap > K6_ULP * ulp)
                    & (gap > K6_REL_TOL * b64.abs())).sum())
        gap_abs = max(gap_abs, float(gap.max()))
        gap_rel = max(gap_rel, float(torch.where(
            b64 != 0, gap / b64.abs(), gap).max()))
    require(bad == 0, f"K6 against the foreach chain after {K6_UPDATES} "
                      f"updates: {bad} entries farther than {K6_ULP} ulp and "
                      f"{K6_REL_TOL} relative (largest gap {gap_abs:.3e}, "
                      f"{gap_rel:.3e} relative)")
    named = dict(params)
    tx = optim.Optimizer("adam", 1e-3, True, 1.0)
    state = tx.update(named, grads_seq[0], tx.init(named))
    sites = sync_sites(lambda: tx.update(named, grads_seq[1], state))
    require(not sites, f"a K6 update synchronises the stream: {where(sites)}")
    row = bench_adam.bench_set("flagship", cfg, dev)
    k6, plain = row["cuda"], row["torch"]
    require(k6["launches"] == ADAM_LAUNCHES and plain["launches"] == 0,
            f"bench_adam: K6 {k6['launches']} launches an update, the "
            f"foreach chain {plain['launches']}")
    print(f"[kernel] K6 on the flagship's {row['params']} parameters "
          f"({row['tensors']} tensors): within {K6_ULP} ulp or {K6_REL_TOL} "
          f"relative of the foreach chain after {K6_UPDATES} updates "
          f"(largest gap {gap_abs:.3e}, {gap_rel:.3e} relative), "
          f"{ADAM_LAUNCHES} launches and no synchronisation an update; "
          f"{k6['ms']:.4f} ms ({k6['device_ms']:.4f} on the device, "
          f"{k6['device_ops']:.0f} operations) vs the foreach chain "
          f"{plain['ms']:.4f} ({plain['device_ms']:.4f}, "
          f"{plain['device_ops']:.0f} operations); bound "
          f"{row['bound_ms']:.5f} ms by bytes ({bench_adam.BYTES_PER_PARAM} "
          f"B a parameter over 3.35 TB/s), {100 * k6['share_of_peak']:.1f}% "
          f"of it ({card})")
    return {**row, "max_abs_err": gap_abs, "max_rel_err": gap_rel}


def phase_goldens(dev):
    for name in ("coords.npz", "realistic_coords.npz"):
        z = np.load(os.path.join(GOLDEN, name))
        with torch.no_grad():
            crd = build_coords_batch(
                torch.from_numpy(z["ang"])[None].to(dev),
                torch.from_numpy(z["ids"])[None].to(dev))[0].cpu().numpy()
        err = float(np.abs(crd - z["crd"]).max())
        require(err <= 1e-3, f"{name}: coordinate error {err:.3e} <= 1e-3 A")
        print(f"[golden] {name}: max coordinate error {err:.3e} A")
    z = np.load(os.path.join(GOLDEN, "model_parity_conv-enc.npz"))
    model = golden_model("conv-enc").to(dev)
    load_flax_params(model, params_from_flat_keys(z))
    err = golden_forward_error("conv-enc", model, z, dev)
    print(f"[golden] model_parity_conv-enc.npz: max error {err:.3e}")
    for name in GOLDEN_MODELS:
        z = np.load(os.path.join(GOLDEN, f"model_parity_{name}.npz"))
        model = golden_model(name)
        # the golden's flax params as a reference checkpoint's state_dict:
        # the port's layouts are the reference's, keyed by the port's map
        names = reference_names(model)
        ref = {names[k]: v for k, v in flax_to_state_dict(
            params_from_flat_keys(z), model).items()}
        model = state_dict_to_port(ref, golden_model(name).to(dev))
        err = golden_forward_error(name, model, z, dev)
        print(f"[golden] model_parity_{name}.npz through the reference "
              f"checkpoint route (models/torch_import.py): max error "
              f"{err:.3e}")


# the frozen goldens' models (tests/test_torch_models.py,
# tests/test_torch_enc_dec.py): B=2 x L=12, d_model 32, d_ff 64, 2 heads,
# 2 layers, the angle means of seed 1
GOLDEN_SIZES = dict(n_heads=2, d_model=32, d_ff=64, max_len=12,
                    vocab_size=22, pad_id=VOCAB.pad_id)
GOLDEN_MODELS = {
    "enc-only": lambda am: EncoderOnlyTransformer(
        n_layers=2, angle_means=am, **GOLDEN_SIZES),
    "conv-enc": lambda am: ConvEncoderOnlyTransformer(
        n_layers=2, angle_means=am, conv_kernel_sizes=(5, 3),
        conv_dim_reductions=(2.0, 2.0), **GOLDEN_SIZES),
    "conv-enc-noemb": lambda am: ConvEncoderOnlyTransformer(
        n_layers=2, angle_means=am, conv_kernel_sizes=(3,),
        conv_dim_reductions=(0.5,), use_tanh_out=False, use_embedding=False,
        **GOLDEN_SIZES),
    "enc-dec": lambda am: Transformer(
        n_enc_layers=2, n_dec_layers=2, angle_means=am, **GOLDEN_SIZES),
}


def golden_model(name: str):
    """A fresh model of a golden's family and sizes, on the CPU."""
    am = np.random.default_rng(1).uniform(-0.5, 0.5, 24).astype(np.float32)
    return GOLDEN_MODELS[name](am)


def golden_forward_error(name: str, model, z, dev) -> float:
    """Max |forward - expected| of a golden; fails beyond 2e-5 (rtol
    1e-4), with TF32 off."""
    ids = torch.from_numpy(z["ids"]).to(dev)
    with torch.no_grad():
        if name == "enc-dec":
            out = model.eval()(ids.long(), torch.from_numpy(z["ang"]).to(dev))
        else:
            out = model.eval()(ids)
    out = out.cpu().numpy()
    err = float(np.abs(out - z["expected"]).max())
    require(np.allclose(out, z["expected"], atol=2e-5, rtol=1e-4),
            f"{name} golden forward within 2e-5 (max error {err:.3e})")
    return err


def flagship(arm: str, out_dir: str, **kw) -> TrainConfig:
    """The flagship width's config for one arm; ``kw`` overrides the
    defaults below (structure logging off: these phases time the step
    itself)."""
    drmsd_impl, sidechain_impl, _ = ARMS[arm]
    settings = {"model": MODEL, "loss": "combined", "bucket_sizes": (256,),
                "batch_size": 8, "name": arm, "log_structure_step": 0,
                "log_val_struct_step": 0, **kw}
    return TrainConfig(d_model=512, d_ff=2048, n_heads=8, n_layers=6,
                       drmsd_impl=drmsd_impl, sidechain_impl=sidechain_impl,
                       out_dir=out_dir, **settings)


def arm_trainer(arm: str, out_dir: str, dev, data, **kw) -> Trainer:
    """A trainer of ``flagship(arm, out_dir, **kw)`` whose optimizer takes
    the arm's path."""
    tr = Trainer(flagship(arm, out_dir, **kw), device=dev, data=data)
    tr.tx.impl = ARMS[arm][2]
    return tr


def random_weights(trainer, dev):
    """Seeded fresh weights with a non-zero output head, so the trunk
    reaches the outputs."""
    gen = torch.Generator().manual_seed(0)
    params = trainer.init_params(gen)
    w = params["head.output_projection.weight"]
    params["head.output_projection.weight"] = (
        0.02 * torch.randn(w.shape, generator=gen)).to(dev)
    return params


# kernel -> (its wrapper, the wrapper's counter of that kernel's launches):
# the flash wrappers count their float32 and their bf16 instance apart
COUNTERS = {"drmsd_fwd": (D.drmsd_stats_cuda, "launches"),
            "drmsd_fwd_grad": (D.drmsd_stats_grad_cuda, "launches"),
            "drmsd_grad_b": (D.drmsd_grad_b_cuda, "launches"),
            "sidechain_fwd": (S.sidechain_fwd_cuda, "launches"),
            "sidechain_bwd": (S.sidechain_bwd_cuda, "launches"),
            "flash_attn_fwd": (A.flash_attn_fwd_cuda, "launches"),
            "flash_attn_bwd": (A.flash_attn_bwd_cuda, "launches"),
            "flash_attn_fwd_bf16": (A.flash_attn_fwd_cuda, "launches_bf16"),
            "flash_attn_bwd_bf16": (A.flash_attn_bwd_cuda, "launches_bf16"),
            "drmsd_fwd_sqrt1": (V.drmsd_stats_sqrt1_cuda, "launches"),
            "drmsd_fwd_mxu": (V.drmsd_stats_mxu_cuda, "launches"),
            "drmsd_grad_a_mxu": (V.drmsd_grad_a_mxu_cuda, "launches"),
            "kabsch_rmsd": (K.kabsch_rmsd_cuda, "launches"),
            "adam_update": (AD.adam_update_cuda, "launches")}
# K6 launches an update: every run here clips (at 1.0), so the norm pass and
# the update, for a model of fewer tensors than one launch's table holds
ADAM_LAUNCHES = 2


def reset_launches() -> None:
    for fn, counter in COUNTERS.values():
        setattr(fn, counter, 0)


def read_launches() -> dict:
    return {name: getattr(fn, counter)
            for name, (fn, counter) in COUNTERS.items()}


def launched(**counts) -> dict:
    """The launch counts expected of a run: ``counts``, every other kernel
    zero."""
    return {**dict.fromkeys(COUNTERS, 0), **counts}


def stored_batch(trainer, split: str, idx):
    """The device batch of rows ``idx`` of a split, gathered from the
    trainer's store as its data stream gathers it."""
    if split == "train":
        split_obj, store = trainer.dm.train, trainer.train_store
    else:
        split_obj, store = (trainer.dm.eval_splits[split],
                            trainer._eval_store(split))
    return store.batch(plan_batch(split_obj, idx, trainer.cfg.bucket_sizes,
                                  trainer.dm.max_seq_len))


def where(sites) -> str:
    """The lines of ``sync_sites``, those of this checkout relative to it."""
    if not sites:
        return "none"
    return ", ".join(os.path.relpath(s, ROOT) if s.startswith(ROOT)
                     else s for s in sites)


def timed_epoch(trainer, params, split):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = dict(trainer.eval_epoch(params, split))
    torch.cuda.synchronize()
    return metrics, time.perf_counter() - t0


def phase_slice(dev, card, out_dir):
    split = "test"
    data = make_dataset(n_train=8, n_eval=16, min_len=255, max_len=256,
                        seed=0, device=dev)
    trainers = {arm: arm_trainer(arm, out_dir, dev, data) for arm in ARMS}
    params = random_weights(trainers["all"], dev)
    n_batches = sum(1 for _ in trainers["all"].dm.eval_index_batches(split))
    n_res = int(trainers["all"].dm.eval_splits[split].lens.sum())
    require(n_batches >= 2, "at least 2 eval batches")

    for tr in trainers.values():  # warm-up, every arm
        timed_epoch(tr, params, split)
    reset_launches()
    got, seconds = timed_epoch(trainers["all"], params, split)
    launches = read_launches()
    require(launches == launched(drmsd_fwd=2 * n_batches,
                                 sidechain_fwd=n_batches,
                                 kabsch_rmsd=n_batches),
            f"eval launches {launches}: expected per step K1a twice, K2a "
            f"and K5 once for {n_batches} steps, no other kernel")
    times = {arm: [] for arm in ARMS}
    times["all"].append(seconds)
    metrics = {"all": got}
    for arm in ("drmsd", "plain", "plain", "drmsd", "all", "all", "drmsd",
                "plain"):
        metrics[arm], seconds = timed_epoch(trainers[arm], params, split)
        times[arm].append(seconds)

    keys = ("drmsd-full", "lndrmsd-full", "drmsd-bb", "lndrmsd-bb",
            "mse-full", "mse-bb", "mse-sc", "rmsd-full", "combined-full")
    for arm in ("all", "drmsd"):
        for key in keys:
            g = metrics[arm][f"epoch-{key}"]
            p = metrics["plain"][f"epoch-{key}"]
            # combined = 0.5 ln-dRMSD / 0.02 + 0.5 MSE / 0.01: 25x the ln
            # gate. With the plain sidechain build the coordinates are the
            # plain arm's own, and the RMSD differs only by K5 (float64
            # inside) against the tensor path's float32 sums and SVD, which
            # read ~4e-7 of the value from float64 in phase 3.
            tol = {"mse": 1e-6, "combined": 2.5e-3,
                   "rmsd": 1e-4 if arm == "all" else 5e-6 * abs(p)}.get(
                       key.split("-")[0], 1e-4)
            require(np.isfinite(g) and np.isfinite(p), f"{key} finite")
            require(abs(g - p) <= tol, f"{key}: {arm} arm {g} vs plain {p} "
                                       f"within {tol}")
    require(got["epoch-drmsd-full"] > 0, "dRMSD is positive")
    print("[slice] metrics (all kernels): " + json.dumps(
        {k: got[f"epoch-{k}"] for k in keys}))
    cfg = trainers["all"].cfg
    steps = {arm: 1e3 * statistics.median(t) / n_batches
             for arm, t in times.items()}
    idx = next(trainers["all"].dm.eval_index_batches(split))
    for arm, tr in trainers.items():
        def step(tr=tr):  # the store path's step: the gather and the step
            tr.eval_step(params, stored_batch(tr, split, idx))
        n_ops, dev_ms = profile_steps(step)
        sites = sync_sites(step)
        require(arm == "plain" or len(sites) <= EVAL_SYNCS,
                f"eval step with K5, {arm} arm, on the store path: "
                f"{len(sites)} stream synchronisations ({where(sites)}), at "
                f"most {EVAL_SYNCS}")
        print(f"[profile] eval step, {arm}, {data_path(tr)}: {n_ops:.0f} "
              f"device operations, {len(sites)} stream synchronisations "
              f"({where(sites)}) and {dev_ms:.2f} ms of device time per "
              f"step (the gather included); idle share "
              f"{1 - dev_ms / steps[arm]:.2f} of the {steps[arm]:.2f} ms "
              f"step timed above ({card})")
    print(f"[slice] {MODEL}, d_model {cfg.d_model} x {cfg.n_layers} layers, "
          f"{n_batches} batches of B=8 x L=256, ms/step (res/s): "
          + ", ".join(f"{label} {steps[arm]:.2f} "
                      f"({1e3 * n_res / (steps[arm] * n_batches):.0f})"
                      for arm, label in (("all", "all kernels"),
                                         ("drmsd", "dRMSD and K5 kernels"),
                                         ("plain", "all plain")))
          + f", medians of 3 epochs each, interleaved, data path "
          f"{data_path(trainers['all'])}; launches in the "
          f"counted epoch {json.dumps(launches)} ({card})")
    return launches


TRAIN_EPOCH = Trainer.train_epoch  # phase 7 wraps the method to time it


def train_epoch_timed(trainer, state, logger=None):
    """One training epoch; returns (state, seconds, steps, residues)."""
    rng = np.random.default_rng(trainer.cfg.seed + state.step)
    batches = list(trainer.dm.train_index_batches(rng))
    n_res = int(sum(np.minimum(trainer.dm.train.lens[idx],
                               trainer.dm.max_seq_len).sum()
                    for idx in batches))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = TRAIN_EPOCH(trainer, state, logger)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    m = trainer.metrics["train"]
    for key in ("combined-full", "drmsd-full", "lndrmsd-full", "mse-full"):
        require(np.isfinite(m[f"epoch-{key}"]) and m[f"epoch-{key}"] > 0,
                f"train epoch-{key} finite and positive")
    return state, seconds, len(batches), n_res


def data_path(trainer) -> str:
    """The data path a trainer's epochs run."""
    return ("device store" if trainer.train_store is not None
            else "prefetched host batches")


class TimedEpochs(list):
    """(seconds, steps, residues) of each timed epoch; ``paths``: the data
    path each ran."""

    def __init__(self):
        super().__init__()
        self.paths = []


@contextlib.contextmanager
def timed_train_epochs():
    """Time every ``Trainer.train_epoch`` that runs inside the block (the
    CLI's trainers among them) from the outside; yields the TimedEpochs that
    get one (seconds, steps, residues) per epoch."""
    epochs = TimedEpochs()

    def timed(self, state, logger=None):
        state, seconds, n, n_res = train_epoch_timed(self, state, logger)
        epochs.append((seconds, n, n_res))
        epochs.paths.append(data_path(self))
        return state

    Trainer.train_epoch = timed
    try:
        yield epochs
    finally:
        Trainer.train_epoch = TRAIN_EPOCH


def one_step(dev, data, params, out_dir, arm="all", double=False, **kw):
    """One training step's loss and gradients at dropout 0 from ``params``,
    on the first training batch, in float64 throughout when ``double``.
    Returns (loss, {parameter: gradient}, {feed-forward layer: which hidden
    units each real residue's ReLU lets through}, the loss's name)."""
    tr = arm_trainer(arm, out_dir, dev, data, dropout=0.0, max_seq_len=256,
                     **kw)
    dtype = torch.float64 if double else torch.float32
    tr.model.to(dtype)
    leaves = {k: v.detach().to(dev, dtype).clone().requires_grad_()
              for k, v in params.items()}
    idx = next(tr.dm.train_index_batches(np.random.default_rng(0)))
    batch = collate(tr.dm.train, idx, tr.cfg.bucket_sizes,
                    tr.dm.max_seq_len).to(dev)
    batch.ang, batch.crd = batch.ang.to(dtype), batch.crd.to(dtype)
    real = batch.seq != tr.cfg.pad_id
    passed = {}
    hooks = [module.register_forward_hook(
        lambda _m, _in, out, name=name: passed.update({name: out[real] > 0}))
        for name, module in tr.model.named_modules()
        if name.endswith(".ff.w_1")]
    loss, _, grads = tr.loss_and_grads(leaves, batch)
    for hook in hooks:
        hook.remove()
    require(len(passed) == tr.cfg.n_layers, "a ReLU pattern of every layer")
    return (float(loss.detach()), dict(zip(leaves, grads)), passed,
            tr.cfg.loss)


def flipped_units(passed_a, passed_b):
    """{feed-forward layer: (d_ff,) bool}: the hidden units whose ReLU is
    open for some real residue in one step and shut in the other."""
    return {name: (passed_a[name] != passed_b[name]).any(0)
            for name in passed_a}


def gradient_distances(grads, ref_grads, flipped=None):
    """{parameter: (largest entry of the difference over the reference's
    largest entry, L2 norm of the difference over the reference's L2 norm)}.
    Both denominators are at least 1e-3 of the largest over all parameters:
    the attention key bias has an exact gradient of zero, and only fp32
    noise. With ``flipped`` (see ``flipped_units``) the entry-wise distance
    leaves out what belongs to those hidden units: their rows of w_1, their
    entries of its bias and their columns of w_2."""
    top = max(float(g.abs().max()) for g in ref_grads.values())
    out = {}
    for name, ref in ref_grads.items():
        require(torch.isfinite(grads[name]).all().item(),
                f"{name} gradient finite")
        diff = (grads[name].to(ref.dtype) - ref)
        off = float(diff.norm()) / max(float(ref.norm()), 1e-3 * top)
        layer, in_ff, leaf = name.rpartition(".ff.")
        if flipped is not None and in_ff:
            units = flipped[layer + ".ff.w_1"]
            diff = diff.clone()
            if leaf == "w_2.weight":
                diff[:, units] = 0
            elif leaf.startswith("w_1."):
                diff[units] = 0
        out[name] = (float(diff.abs().max())
                     / max(float(ref.abs().max()), 1e-3 * top), off)
    return out


def hold_steps(first, second, labels, entry_tol, norm_tol=None,
               loss_tol=1e-4):
    """Hold one step (see ``one_step``) against another: the loss within
    loss_tol relative, each parameter's gradient within entry_tol of the
    second's largest entry and, where norm_tol is given, within norm_tol of
    its L2 norm. The entry-wise gate leaves out the hidden units whose ReLU
    differs between the two steps (none where the two run the same model
    code); the norm gate leaves out nothing."""
    (k_loss, k_grads, k_passed, loss_name), (p_loss, p_grads, p_passed, _) \
        = first, second
    require(np.isfinite(k_loss) and abs(k_loss - p_loss)
            <= loss_tol * abs(p_loss),
            f"one-step loss: {labels[0]} {k_loss} vs {labels[1]} {p_loss} "
            f"within {loss_tol} relative")
    flipped = flipped_units(k_passed, p_passed)
    n_flipped = sum(int(units.sum()) for units in flipped.values())
    dist = gradient_distances(k_grads, p_grads, flipped)
    worst, at = max((d[0], name) for name, d in dist.items())
    worst_norm, at_norm = max((d[1], name) for name, d in dist.items())
    print(f"[train] one step at dropout 0, same weights, {loss_name} loss: "
          f"{labels[0]} {k_loss:.6f} vs {labels[1]} {p_loss:.6f}; worst "
          f"gradient error {worst:.3e} of the parameter's largest entry "
          f"({at}; gate {entry_tol}, without the {n_flipped} hidden units "
          f"whose ReLU differs), {worst_norm:.3e} of its L2 norm ({at_norm}; "
          f"gate {norm_tol})")
    require(worst <= entry_tol, f"{at} gradient: {worst:.3e} of its largest "
                                f"entry <= {entry_tol}")
    require(norm_tol is None or worst_norm <= norm_tol,
            f"{at_norm} gradient: {worst_norm:.3e} of its L2 norm <= "
            f"{norm_tol}")


def phase_train(dev, card, out_dir):
    """The flagship training slice in three arms. Returns the launches of
    the counted epoch and (config, batch shape, ms and device ms a step)
    of the every-kernel arm."""
    data = make_dataset(n_train=16, n_eval=2, min_len=255, max_len=256,
                        seed=0, device=dev)
    kw = dict(optimizer="adam", lr_scheduling="noam", max_seq_len=256,
              repeat_train=TRAIN_REPEAT)
    trainers = {arm: arm_trainer(arm, out_dir, dev, data, **kw)
                for arm in ARMS}
    params = random_weights(trainers["all"], dev)
    states = {arm: tr.state_from(params) for arm, tr in trainers.items()}
    for arm, tr in trainers.items():  # warm-up epoch, every arm
        states[arm] = train_epoch_timed(tr, states[arm])[0]

    reset_launches()
    states["all"], seconds, steps, n_res = train_epoch_timed(
        trainers["all"], states["all"])
    launches = read_launches()
    require(steps >= 8, f"{steps} training steps, expected at least 8")
    require(launches == launched(drmsd_fwd_grad=2 * steps,
                                 sidechain_fwd=steps, sidechain_bwd=steps,
                                 adam_update=ADAM_LAUNCHES * steps),
            f"training launches {launches}: expected per step K1b and K6 "
            f"twice, K2a and K2b once for {steps} steps, K1a and K1c none")
    times = {arm: [] for arm in ARMS}
    rates = {arm: [] for arm in ARMS}
    times["all"].append(seconds / steps)
    rates["all"].append(n_res / seconds)
    for arm in ("drmsd", "plain", "plain", "drmsd", "all", "all", "drmsd",
                "plain"):
        states[arm], sec, n, res = train_epoch_timed(trainers[arm],
                                                     states[arm])
        times[arm].append(sec / n)
        rates[arm].append(res / sec)
    batch_shape = next(trainers["all"].dm.train_batches(
        np.random.default_rng(0))).seq.shape
    m = trainers["all"].metrics["train"]
    print("[train] last epoch (all kernels): " + json.dumps(
        {k: m[f"epoch-{k}"] for k in ("combined-full", "drmsd-full",
                                      "lndrmsd-full", "mse-full")}))
    cfg = trainers["all"].cfg
    idx = next(trainers["all"].dm.train_index_batches(
        np.random.default_rng(0)))
    step_ms = {}
    for arm, tr in trainers.items():
        def step(arm=arm, tr=tr):  # the store path's: gather, then step
            states[arm] = tr.train_step(
                states[arm], stored_batch(tr, "train", idx))[0]
        n_ops, dev_ms = profile_steps(step)
        step_ms[arm] = (1e3 * statistics.median(times[arm]), dev_ms)
        sites = sync_sites(step)
        require(arm != "all" or not sites,
                f"train step with every kernel on the store path: "
                f"{len(sites)} stream synchronisations ({where(sites)}), "
                "expected none")
        ms = 1e3 * statistics.median(times[arm])
        print(f"[profile] train step, {arm}, {data_path(tr)}: {n_ops:.0f} "
              f"device operations, {len(sites)} stream synchronisations "
              f"({where(sites)}) and {dev_ms:.2f} ms of device time per step "
              f"(the gather included); idle share {1 - dev_ms / ms:.2f} of "
              f"the {ms:.2f} ms step timed above ({card})")
    print(f"[train] {MODEL}, d_model {cfg.d_model} x {cfg.n_layers} layers, "
          f"{steps} steps per epoch of B={batch_shape[0]} x "
          f"L={batch_shape[1]}, ms/step (res/s): "
          + ", ".join(f"{label} {1e3 * statistics.median(times[arm]):.2f} "
                      f"({statistics.median(rates[arm]):.0f})"
                      for arm, label in (("all", "all kernels"),
                                         ("drmsd", "dRMSD kernels only"),
                                         ("plain", "all plain")))
          + f", medians of 3 epochs each, interleaved, data path "
          f"{data_path(trainers['all'])}; launches in the "
          f"counted epoch {json.dumps(launches)} ({card})")
    # at dropout 0 from identical weights: every kernel against all plain
    hold_steps(one_step(dev, data, params, out_dir, name="ab-all"),
               one_step(dev, data, params, out_dir, "plain", name="ab-plain"),
               ("all kernels", "all plain"), entry_tol=1e-3)
    return launches, (cfg, tuple(batch_shape), *step_ms["all"])


def run_cli(argv):
    """``cli.main(argv)`` with its standard output echoed and returned."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    print(buf.getvalue(), end="")
    return buf.getvalue()


def check_restore(argv, best, dev, steps_per_epoch) -> int:
    """What a run resuming with ``argv`` restores from the checkpoint file
    ``best`` equals it bit for bit; returns the checkpoint's epoch.
    steps_per_epoch: the train steps of each epoch of the run so far."""
    with open(best + ".meta.json") as f:
        saved_epoch = json.load(f)["epoch"]
    saved = torch.load(best, weights_only=True, map_location=dev)
    tr = Trainer(cli.config_from_args(argv), device=dev)
    restored = tr.maybe_restore(
        tr.init_state(torch.Generator().manual_seed(1)))
    require(restored.step == saved["step"]
            == sum(steps_per_epoch[:saved_epoch + 1])
            and tr.start_epoch == saved_epoch + 1,
            "the restored step and epoch are the checkpoint's")
    require(all(torch.equal(restored.params[k], saved["params"][k])
                for k in restored.params)
            and all(torch.equal(mu, saved["opt_state"]["mu"][k])
                    and torch.equal(nu, saved["opt_state"]["nu"][k])
                    for k, mu, nu in zip(restored.params,
                                         restored.opt_state.mu,
                                         restored.opt_state.nu)),
            "restored parameters and optimizer moments equal the "
            "checkpoint's bit for bit")
    return saved_epoch


def phase_cli(dev, card, out_dir):
    """The training CLI for two epochs and a resumed third, then the
    checkpoint's cost. Returns the launches of the first run."""
    data = make_dataset(n_train=16, n_eval=8, min_len=255, max_len=256,
                        seed=0, device=dev)
    valid = ("valid-10", "valid-90")
    for split in [k for k in data if k.startswith("valid-")]:
        if split not in valid:
            del data[split]
    data_path = os.path.join(out_dir, "synthetic.pt")
    torch.save(data, data_path)
    argv = ["--data", data_path, "--name", "cli", "--out_dir", out_dir,
            "-m", MODEL, "-dm", "512", "-dih", "2048", "-nh", "8", "-nl", "6",
            "-do", "0.1", "-l", "combined", "-opt", "adam",
            "--lr_scheduling", "noam", "-b", "8", "--repeat_train",
            str(TRAIN_REPEAT), "--cluster", "True", "--log_structure_step",
            "0", "-lvs", "0"]
    cfg = cli.config_from_args(argv)
    dm = DataModule(data, cfg)
    steps = len(list(dm.train_index_batches(np.random.default_rng(0))))
    eval_steps = {s: len(list(dm.eval_index_batches(s)))
                  for s in dm.eval_splits}
    require(set(eval_steps) == {*valid, "test"}, "two validation splits "
                                                 "and test")

    with timed_train_epochs() as epochs:
        reset_launches()
        out = run_cli(argv + ["-e", "2"])
        launches = read_launches()
    n_eval = 2 * sum(eval_steps[s] for s in valid) + eval_steps["test"]
    expected = launched(drmsd_fwd=2 * n_eval, drmsd_fwd_grad=2 * 2 * steps,
                        sidechain_fwd=2 * steps + n_eval,
                        sidechain_bwd=2 * steps, kabsch_rmsd=n_eval,
                        adam_update=ADAM_LAUNCHES * 2 * steps)
    require(launches == expected,
            f"CLI launches {launches}: expected {expected} for 2 epochs of "
            f"{steps} train steps and {n_eval} eval steps")
    require("[ Epoch 0 ]" in out and "[ Epoch 1 ]" in out
            and "(Test)" in out, "two epochs and the test split ran")

    run_dir = os.path.join(out_dir, "cli")
    best = os.path.join(run_dir, "checkpoints", "best")
    for path in (best, best + ".meta.json",
                 os.path.join(run_dir, "config.json")):
        require(os.path.isfile(path), f"{os.path.relpath(path, out_dir)} "
                                      "written")
    with open(os.path.join(run_dir, "cli.train")) as f:
        rows = list(csv.DictReader(f))
    epoch_rows = {r["mode"]: r for r in rows if r["granularity"] == "epoch"}
    require(set(epoch_rows) == {"train", *valid, "test"},
            f"epoch rows of train, {valid} and test in the CSV")
    for mode, r in epoch_rows.items():
        require(all(np.isfinite(float(r[k])) and float(r[k]) > 0
                    for k in ("drmsd", "ln_drmsd", "rmse", "combined")),
                f"finite epoch metrics for {mode}: {r}")
    n_batch_rows = sum(r["granularity"] == "batch" for r in rows)
    require(n_batch_rows == 2 * steps and len(rows) == 2 * steps + 7,
            f"{len(rows)} CSV rows, {n_batch_rows} of them train batches")

    saved_epoch = check_restore(argv + ["-e", "3"], best, dev,
                                [n for _, n, _ in epochs])

    out = run_cli(argv + ["-e", "3"])
    first = saved_epoch + 1
    require(f"[Info] Resumed from 'best' at epoch {first}." in out,
            "the second run says it resumed from 'best'")
    require(f"[ Epoch {first} ]" in out and "[ Epoch 0 ]" not in out
            and "[ Epoch 2 ]" in out and "(Test)" in out,
            f"the resumed run starts at epoch {first} and finishes")
    seconds, n, n_res = epochs[1]
    print(f"[cli] {MODEL}, d_model 512 x 6 layers: 2 epochs of {steps} train "
          f"steps and {n_eval} eval steps, then resumed from 'best' (epoch "
          f"{saved_epoch}) for a third; second epoch {1e3 * seconds / n:.2f} "
          f"ms/train step, {n_res / seconds:.0f} res/s, data path "
          f"{epochs.paths[1]}; launches of the first run "
          f"{json.dumps(launches)} ({card})")
    checkpoint_cost(dev, card, out_dir, data, 1e3 * seconds / n)
    return launches


def checkpoint_cost(dev, card, out_dir, data, step_ms) -> dict:
    """Seconds and bytes of ``Trainer._save_checkpoint`` (parameters and
    Adam moments, full tensors, one file) and of the restore in
    ``maybe_restore``, each after one train step, at the flagship (on
    phase 7's data) and at ladder config 5 (conv-enc d_model 1024 x L 500,
    B=4): the restored state equal to the saved one bit for bit. The train
    loop waits for the whole write: ``train()`` saves between epochs, after
    the evaluation, synchronously."""
    out = {}
    for label, cfg, bsz in (
            ("flagship", flagship("all", out_dir, name="ckpt-flagship",
                                  optimizer="adam", lr_scheduling="noam",
                                  max_seq_len=256), 8),
            ("ladder config 5", bench_ladder.ladder_config(
                5, 4, out_dir, name="ckpt-ladder5"), 4)):
        cases = data if label == "flagship" else make_dataset(
            n_train=bsz, n_eval=1, min_len=cfg.max_seq_len - 1,
            max_len=cfg.max_seq_len, seed=3, device=dev)
        tr = Trainer(cfg, device=dev, data=cases)
        state = tr.init_state(torch.Generator().manual_seed(0))
        state = tr.train_step(state, bench_ladder.ladder_batch(tr, bsz))[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            tr._save_checkpoint(state, 0, 1.0, [1.0])
        save_s = time.perf_counter() - t0
        path = os.path.join(tr.out_dir, "checkpoints", "best")
        n_bytes = os.path.getsize(path)
        again = Trainer(cfg, device=dev, data=cases)
        fresh = again.init_state(torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            restored = again.maybe_restore(fresh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in state.params.values())
        require(restored.step == state.step == 1 and all(
            torch.equal(restored.params[k], v)
            for k, v in state.params.items()) and all(
            torch.equal(a, b) for a, b in zip(restored.opt_state.mu
                                              + restored.opt_state.nu,
                                              state.opt_state.mu
                                              + state.opt_state.nu)),
                f"{label}: the restored state is the saved one bit for bit")
        out[label] = {"bytes": n_bytes, "save_s": save_s, "load_s": load_s}
        print(f"[checkpoint] {label} ({cfg.model}, d_model {cfg.d_model}, "
              f"{n_params:,} parameters): {n_bytes / 1e6:.1f} MB written in "
              f"{save_s:.3f} s ({n_bytes / 1e9 / save_s:.2f} GB/s), restored "
              f"in {load_s:.3f} s; the train loop waits for the write "
              f"(synchronous, between epochs, at most once an epoch)"
              + (f": {1e3 * save_s / step_ms:.0f} flagship train steps of "
                 f"phase 7" if label == "flagship" else "") + f" ({card})")
        del tr, again, state, restored, fresh
        gc.collect()
        torch.cuda.empty_cache()
    return out


def head_split(rng, dev, shape, gains=(1.0, 1.0, 1.0), dtype=torch.float32):
    """Normal tensors of standard deviation ``gains`` as the model makes q,
    k and v: (B, H, L, D) views of (B, L, H * D) memory, in ``dtype``."""
    bsz, heads, length, dim = shape
    return [torch.from_numpy(rng.normal(0, gain, (bsz, length, heads * dim))
                             .astype(np.float32)).to(dev, dtype)
            .reshape(bsz, length, heads, dim).transpose(1, 2)
            for gain in gains]


def attention_grads(q, k, v, valid, d_out, scale, impl):
    """O through ``impl`` from fresh leaves, and its gradients for the
    cotangent d_out."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = A.flash_self_attention(*leaves, valid, sm_scale=scale, impl=impl)
    return out.detach(), torch.autograd.grad(out, leaves, d_out)


def attention_timings(q, k, v, valid, d_out, scale, bwd_args, shape,
                      n_valid, elem=4):
    """({kernel: (kernel ms, plain ms, bound ms, what bounds it, library
    ms, device ms or None, library device ms or None)}, weighted pairs) of
    K3a and the backward on one case, the instance of q's dtype (``elem``
    bytes an element; the bf16 rows are named with "_bf16"): each kernel's
    wrapper as its main path calls it, the plain version (autograd through
    it for the backward) and the library call with the same boolean mask
    (its forward, and autograd's one backward through it), by CUDA events;
    at the table's shapes also on the device alone; each bound from this
    run's valid keys."""
    bsz, heads, length, dim = shape
    suffix = "_bf16" if elem == 2 else ""
    fwd, bwd = "flash_attn_fwd" + suffix, "flash_attn_bwd" + suffix
    sdpa = torch.nn.functional.scaled_dot_product_attention
    key_mask = valid[:, None, None, :]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    plain_out = A.flash_self_attention_torch(*leaves, valid, sm_scale=scale)
    lib_out = sdpa(*leaves, attn_mask=key_mask, scale=scale)

    def no_grad(fn):
        def run():
            with torch.no_grad():
                return fn()
        return run

    def backward(out):
        return lambda: torch.autograd.grad(out, leaves, d_out,
                                           retain_graph=True)

    # the forward as its main path calls it: with the row statistics where
    # a gradient follows (the training step's shape), else without
    with_stats = shape == ATTENTION_TRAIN_CASE

    def forward():
        return A.flash_attn_fwd_cuda(q, k, v, valid, scale,
                                     with_stats=with_stats)

    library_forward = no_grad(lambda: sdpa(q, k, v, attn_mask=key_mask,
                                           scale=scale))
    times = {
        fwd: (cuda_ms(forward),
              cuda_ms(no_grad(lambda: A.flash_self_attention_torch(
                  q, k, v, valid, sm_scale=scale))),
              cuda_ms(library_forward)),
        bwd: (cuda_ms(lambda: A.flash_attn_bwd_cuda(*bwd_args)),
              cuda_ms(backward(plain_out)),
              cuda_ms(backward(lib_out)))}
    # what this run's data needs: every query row of a batch row weighs its
    # valid keys, or all L keys where there is none
    keys = np.where(n_valid > 0, n_valid, length)
    pairs = heads * length * int(keys.sum())
    dev_ms = lib_dev_ms = dict.fromkeys(times)
    if shape in (ATTENTION_PREDICT_CASE, ATTENTION_TRAIN_CASE):
        dev_ms = {fwd: device_ms(forward),
                  bwd: device_ms(lambda: A.flash_attn_bwd_cuda(*bwd_args))}
        lib_dev_ms = {fwd: device_ms(library_forward),
                      bwd: device_ms(backward(lib_out))}
    return {name: (t[0], t[1],
                   *attention_bound(name.removesuffix(suffix), shape, pairs,
                                    with_stats, elem),
                   t[2], dev_ms[name], lib_dev_ms[name])
            for name, t in times.items()}, pairs


def attention_case(dev, card, rng, shape):
    """K3a and the backward against the plain version on one (B, H, L, D)
    case; returns {kernel: (max abs error, kernel ms, plain ms, bound ms,
    what bounds it, library ms, device ms or None, library device ms or
    None)}."""
    bsz, heads, length, dim = shape
    where = f"B={bsz} H={heads} L={length} D={dim}"
    # q three times wider than k: scores of standard deviation 3, a softmax
    # with a few keys carrying most of the weight, as a trained layer's
    q, k, v = head_split(rng, dev, shape, gains=(3.0, 1.0, 1.0))
    d_out = head_split(rng, dev, shape)[0]
    n_valid = rng.integers(1, length + 1, bsz)
    n_valid[0] = length
    if bsz > 1:
        n_valid[-1] = 0  # a batch row with no valid key, as collate pads
    valid = torch.from_numpy(
        np.arange(length)[None, :] < n_valid[:, None]).to(dev)
    scale = 1.0 / math.sqrt(dim)

    got, k_grads = attention_grads(q, k, v, valid, d_out, scale, "cuda")
    want, p_grads = attention_grads(q, k, v, valid, d_out, scale, "torch")
    _, f64_grads = attention_grads(q.double(), k.double(), v.double(), valid,
                                   d_out.double(), scale, "torch")
    _, m, l = A.flash_attn_fwd_cuda(q, k, v, valid, scale, with_stats=True)
    bwd_args = (q, k, v, valid, d_out, got, m, l, scale)
    b_grads = A.flash_attn_bwd_cuda(*bwd_args)
    b_plain = A.flash_attn_bwd_torch(*bwd_args)
    torch.cuda.synchronize()
    require(torch.isfinite(got).all().item()
            and all(torch.isfinite(g).all().item()
                    for g in (*k_grads, *b_grads)),
            f"values and gradients finite, the all-pad row included, {where}")
    err = float((got - want).abs().max())
    require(err <= 2e-5, f"K3a within 2e-5 of plain on every row "
                         f"({err:.3e}), {where}")
    g_errs = [grad_err(g, p, f"K3 d/d{name} against autograd through plain, "
                             f"{where}")
              for name, g, p in zip("qkv", k_grads, p_grads)]
    b_errs = [grad_err(g, p, f"backward d/d{name} against its plain version, "
                             f"{where}")
              for name, g, p in zip("qkv", b_grads, b_plain)]
    f64_errs = [grad_err(g.double(), p, f"K3 d/d{name} against float64 "
                                        f"plain, {where}")
                for name, g, p in zip("qkv", k_grads, f64_grads)]
    got2, k_grads2 = attention_grads(q, k, v, valid, d_out, scale, "cuda")
    with torch.no_grad():
        got3 = A.flash_self_attention(q, k, v, valid, sm_scale=scale)
    b_grads2 = A.flash_attn_bwd_cuda(*bwd_args)
    require(torch.equal(got2, got) and torch.equal(got3, got)
            and all(torch.equal(a, b) for a, b in zip(k_grads2, k_grads))
            and all(torch.equal(a, b) for a, b in zip(b_grads2, b_grads)),
            f"a second call gives the same bits, {where}")

    timings, pairs = attention_timings(q, k, v, valid, d_out, scale,
                                       bwd_args, shape, n_valid)
    pair = [cuda_ms(lambda: attention_grads(q, k, v, valid, d_out, scale,
                                            impl)) for impl in ("cuda",
                                                                "torch")]
    errs = {"flash_attn_fwd": err, "flash_attn_bwd": max(b_errs)}
    out = {name: (errs[name], *t) for name, t in timings.items()}
    print(f"[kernel] attention {where}: |d O| {err:.3e}, |d dQ| "
          f"{g_errs[0]:.3e}, |d dK| {g_errs[1]:.3e}, |d dV| {g_errs[2]:.3e} "
          f"(max|g| {max(float(g.abs().max()) for g in p_grads):.3e}); the "
          f"backward against its plain version on the same inputs "
          + ", ".join(f"{e:.3e}" for e in b_errs)
          + ", and from a float64 plain run "
          + ", ".join(f"{e:.3e}" for e in f64_errs)
          + " (dQ, dK, dV); all finite, same bits twice; kernel vs plain vs "
          "library ms: "
          + ", ".join(f"{name} {v[1]:.4f} vs {v[2]:.4f} vs {v[5]:.4f}"
                      for name, v in out.items())
          + f"; forward + backward through autograd {pair[0]:.4f} vs plain "
          f"{pair[1]:.4f}; {pairs} weighted pairs, bounds in ms: "
          + ", ".join(f"{name} {v[3]:.5f} by {v[4]}"
                      for name, v in out.items())
          + device_only({name: v[6] for name, v in out.items()})
          + ("; the library call's device-only ms: " + ", ".join(
              f"{name} {v[7]:.4f}" for name, v in out.items())
             if out["flash_attn_fwd"][7] is not None else "")
          + f" (median of {TIMED_RUNS}; {card})")
    return out


def phase_attention_kernel(dev, card):
    rng = np.random.default_rng(2)
    return {case: attention_case(dev, card, rng, case)
            for case in ATTENTION_CASES}


def timed_predict_batches(run_dirs, data, dev):
    """({label: (ms per batch, residues/s)}, max |d sin/cos| between the
    two models on real residues): predict's inference (model in eval mode,
    then the all-atom build) on the test split's batches of 8, medians of 5
    passes per run directory, interleaved."""
    loaded = {label: predict.load_run(run_dir, "best", dev)
              for label, run_dir in run_dirs.items()}
    cfg = next(iter(loaded.values()))[0]
    dm = DataModule(data, cfg)
    batches = [b.to(dev) for b in dm.eval_batches("test")]
    n_res = sum(b.n_res for b in batches)
    first, second = (model for _, model in loaded.values())
    with torch.inference_mode():
        gap = max(float((first(b.seq) - second(b.seq))[b.seq != cfg.pad_id]
                        .abs().max()) for b in batches)
    times = {label: [] for label in loaded}
    for label in [*loaded] * 2 + [*loaded][::-1] * 4:
        model = loaded[label][1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            for b in batches:
                build_coords_batch(inverse_trig_transform(model(b.seq)),
                                   b.seq)
        torch.cuda.synchronize()
        times[label].append(time.perf_counter() - t0)
    # the first pass of each label is its warm-up
    out = {}
    for label, t in times.items():
        sec = statistics.median(t[1:])
        out[label] = (1e3 * sec / len(batches), n_res / sec)
    return out, gap


def phase_predict(dev, card, out_dir):
    """One CLI epoch with flash attention, then predict from its run."""
    data = make_dataset(n_train=16, n_eval=16, min_len=255, max_len=256,
                        seed=1, device=dev)
    for split in [k for k in data if k.startswith("valid-")]:
        if split != "valid-10":
            del data[split]
    data_path = os.path.join(out_dir, "predict_data.pt")
    torch.save(data, data_path)
    argv = ["--data", data_path, "--name", "flash", "--out_dir", out_dir,
            "-m", MODEL, "-dm", "512", "-dih", "2048", "-nh", "8", "-nl", "6",
            "-do", "0.1", "-l", "combined", "-opt", "adam",
            "--lr_scheduling", "noam", "-b", "8", "--cluster", "True",
            "--log_structure_step", "0", "-lvs", "0", "--attention_impl",
            "flash", "-e", "1"]
    cfg = cli.config_from_args(argv)
    dm = DataModule(data, cfg)
    steps = len(list(dm.train_index_batches(np.random.default_rng(0))))
    n_eval = sum(len(list(dm.eval_index_batches(s))) for s in dm.eval_splits)
    reset_launches()
    run_cli(argv)
    launches = read_launches()
    expected = launched(drmsd_fwd=2 * n_eval, drmsd_fwd_grad=2 * steps,
                        sidechain_fwd=steps + n_eval, sidechain_bwd=steps,
                        flash_attn_fwd=6 * n_eval, kabsch_rmsd=n_eval,
                        adam_update=ADAM_LAUNCHES * steps)
    require(launches == expected,
            f"flash CLI launches {launches}: expected {expected} ({steps} "
            f"train steps at dropout 0.1, which keep the materialised "
            f"attention, and {n_eval} eval steps of 6 K3a launches and one "
            f"K5)")
    run_dir = os.path.join(out_dir, "flash")
    with open(os.path.join(run_dir, "config.json")) as f:
        saved = json.load(f)
    require(saved["config"]["attention_impl"] == "flash",
            "config.json keeps attention_impl flash")

    # seeded random output head: the trained head is still ~zero after two
    # warm-up steps, and would hide the trunk from the predicted angles
    ckpt = CheckpointManager(os.path.join(run_dir, "checkpoints"))
    arrays, meta = ckpt.restore_raw("best")
    w = arrays["params"]["head.output_projection.weight"]
    arrays["params"]["head.output_projection.weight"] = 0.02 * torch.randn(
        w.shape, generator=torch.Generator().manual_seed(0))
    ckpt.save("best", arrays, meta)
    xla_dir = os.path.join(out_dir, "flash-as-xla")
    os.makedirs(xla_dir)
    os.symlink(os.path.join(run_dir, "checkpoints"),
               os.path.join(xla_dir, "checkpoints"))
    saved["config"]["attention_impl"] = "xla"
    with open(os.path.join(xla_dir, "config.json"), "w") as f:
        json.dump(saved, f)

    def run_predict(which_dir, out):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            paths = predict.main([which_dir, "--data", data_path, "--split",
                                  "test", "--n", "16", "--batch", "8",
                                  "--out", out])
        require(buf.getvalue().split() == paths, "predict prints its paths")
        return paths

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paths = run_predict(run_dir, os.path.join(out_dir, "preds_flash"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    predict_launches = read_launches()
    require(predict_launches == launched(flash_attn_fwd=12, sidechain_fwd=2),
            f"predict launches {predict_launches}: expected K3a 6 x 2 and "
            "K2a twice, no other kernel")
    reset_launches()
    xla_paths = run_predict(xla_dir, os.path.join(out_dir, "preds_xla"))
    require(read_launches() == launched(sidechain_fwd=2),
            "predict with attention_impl xla launches K2a twice and no K3")

    test = data["test"]
    require(len(paths) == 32 and [os.path.basename(p) for p in paths]
            == [os.path.basename(p) for p in xla_paths],
            "16 pred/true pairs, the same names from both runs")
    worst, n_atoms = 0.0, 0
    for flash_path, xla_path in zip(paths, xla_paths):
        names, _, res_nums, xyz = parse_pdb_atoms(flash_path)
        x_names, _, x_nums, x_xyz = parse_pdb_atoms(xla_path)
        protein = test["ids"].index(
            os.path.basename(flash_path).rsplit("_", 1)[0])
        require(len(names) > 4 * len(test["seq"][protein]) - 1
                and res_nums[-1] == len(test["seq"][protein])
                and np.isfinite(xyz).all(),
                f"{os.path.basename(flash_path)} is well formed")
        require((names, res_nums) == (x_names, x_nums),
                "the same atoms from both runs")
        if flash_path.endswith("_true.pdb"):
            require(np.array_equal(xyz, x_xyz), "true files equal")
            continue
        worst = max(worst, float(np.abs(xyz - x_xyz).max()))
        n_atoms += len(names)
    # The tight gate is on what the models emit: the repo's model-forward
    # bound, 2e-5 on the sin/cos of real residues. Coordinates follow it only
    # loosely under random weights: atan2 of a (cos, sin) pair of norm r
    # magnifies an error by 1 / r, and the chain carries an angle error over
    # lever arms of hundreds of A at L=256: 5e-3 A was read on an H100 where
    # the sin/cos differed by 2.3e-6, and the gate leaves four times that.
    rates, gap = timed_predict_batches({"flash": run_dir, "xla": xla_dir},
                                       data, dev)
    require(gap <= 2e-5, f"predicted sin/cos, flash vs xla, on real "
                         f"residues: {gap:.3e} <= 2e-5")
    require(worst <= 2e-2,
            f"pred coordinates, flash vs xla: {worst:.3e} A <= 2e-2 A")
    print(f"[predict] {MODEL}, d_model 512 x 6 layers: 16 proteins in 2 "
          f"batches of B=8 x L=256 -> 32 PDB files ({n_atoms} predicted "
          f"atoms), flash vs xla: sin/cos within {gap:.3e}, coordinates "
          f"within {worst:.1e} A; "
          f"predict.main {seconds:.2f} s with the checkpoint load and the "
          f"files; inference ms/batch (res/s): "
          + ", ".join(f"{label} {ms:.2f} ({rate:.0f})"
                      for label, (ms, rate) in rates.items())
          + f", medians of 5 passes, interleaved; launches of predict "
          f"{json.dumps(predict_launches)}, of the CLI epoch "
          f"{json.dumps(launches)} ({card})")
    return predict_launches


def phase_flash_train(dev, card, out_dir):
    """Training with flash attention at dropout 0 against the materialised
    branch."""
    data = make_dataset(n_train=16, n_eval=2, min_len=255, max_len=256,
                        seed=0, device=dev)
    kw = dict(optimizer="adam", lr_scheduling="noam", max_seq_len=256,
              repeat_train=FLASH_TRAIN_REPEAT, dropout=0.0)
    trainers = {impl: Trainer(flagship("all", out_dir, name=f"train-{impl}",
                                       attention_impl=impl, **kw),
                              device=dev, data=data)
                for impl in ("flash", "xla")}
    params = random_weights(trainers["flash"], dev)
    states = {impl: tr.state_from(params) for impl, tr in trainers.items()}
    for impl, tr in trainers.items():  # warm-up epoch, both arms
        states[impl] = train_epoch_timed(tr, states[impl])[0]
    reset_launches()
    states["flash"], seconds, steps, _ = train_epoch_timed(
        trainers["flash"], states["flash"])
    launches = read_launches()
    expected = launched(drmsd_fwd_grad=2 * steps, sidechain_fwd=steps,
                        sidechain_bwd=steps, flash_attn_fwd=6 * steps,
                        flash_attn_bwd=6 * steps,
                        adam_update=ADAM_LAUNCHES * steps)
    require(steps >= 4 and launches == expected,
            f"flash training launches {launches}: expected {expected} for "
            f"{steps} steps")
    times = {"flash": [seconds / steps], "xla": []}
    for impl in ("xla", "xla", "flash", "flash", "xla"):
        states[impl], sec, n, _ = train_epoch_timed(trainers[impl],
                                                    states[impl])
        times[impl].append(sec / n)
    print(f"[flash-train] {MODEL}, d_model 512 x 6 layers, dropout 0, "
          f"{steps} steps per epoch of B=16 x L=256, ms/step: "
          + ", ".join(f"{impl} {1e3 * statistics.median(t):.2f}"
                      for impl, t in times.items())
          + f", medians of 3 epochs each, interleaved, data path "
          f"{data_path(trainers['flash'])}; launches in the counted epoch "
          f"{json.dumps(launches)} ({card})")
    # One step from identical weights, flash against the materialised
    # branch. The arms' activations differ by fp32 rounding (their sin/cos by
    # ~2e-6), and two things between the attention layers magnify that: a
    # ReLU unit that is open for a residue in one arm and shut in the other
    # moves that unit's row of the feed-forward weight's gradient by ~1e-2
    # of its largest entry, and under random weights the combined loss's
    # gradient is ill-conditioned in the sin/cos (atan2 of pairs of small
    # norm, then the chain's lever arms). So:
    # - under the MSE loss, whose gradient reaches the parameters through
    #   the same six attention backward passes and is well conditioned, each
    #   gradient within 1e-3 of its largest entry once the units whose ReLU
    #   differs (read from the two forward passes) are left out, and within
    #   2e-3 of its L2 norm with nothing left out;
    # - under the combined loss the limit comes from a float64 run of the
    #   same step (all plain, materialised attention), not from the two fp32
    #   arms' distance from each other: each gradient of the flash arm is no
    #   farther from the float64 one than twice the xla arm's own distance
    #   plus 1e-3 (L2), and the two arms within 2e-2 (entries) and 1e-2 (L2)
    #   of each other.
    # Read on an H100 (700 W): three units flipped; MSE 3.0e-4 (entries) and
    # 5.7e-4 (L2); combined 9.5e-3 and 5.8e-3 between the arms, 3.3e-3
    # (flash) and 2.5e-3 (xla) from float64.
    labels = ("flash attention", "materialised attention")
    for loss, entry_tol, norm_tol in (("mse", 1e-3, 2e-3),
                                      ("combined", 2e-2, 1e-2)):
        flash, xla, exact = (
            one_step(dev, data, params, out_dir, arm, double,
                     attention_impl=impl, name=f"ab-{impl}-{arm}", loss=loss)
            for impl, arm, double in (("flash", "all", False),
                                      ("xla", "all", False),
                                      ("xla", "plain", True)))
        hold_steps(flash, xla, labels, entry_tol, norm_tol)
        far = {label: gradient_distances(step[1], exact[1])
               for label, step in zip(labels, (flash, xla))}
        worst = {label: max((d[1], name) for name, d in dist.items())
                 for label, dist in far.items()}
        print(f"[flash-train] {loss} loss, L2 distance of the gradients "
              f"from a float64 run of the step (loss {exact[0]:.9f}), worst "
              f"parameter: "
              + ", ".join(f"{label} {d:.3e} ({name})"
                          for label, (d, name) in worst.items()))
        for name, (_, d_flash) in far[labels[0]].items():
            limit = 2 * far[labels[1]][name][1] + 1e-3
            require(d_flash <= limit,
                    f"{name} gradient under the {loss} loss: flash is "
                    f"{d_flash:.3e} (L2) from float64, limit {limit:.3e}")
    return launches


ENC_DEC_ARGS = ["-m", "enc-dec", "-dm", "512", "-dih", "2048", "-nh", "8",
                "-nl", "6", "-do", "0.1", "-l", "combined", "-opt", "adam",
                "--lr_scheduling", "noam", "-b", "8", "--repeat_train",
                str(TRAIN_REPEAT), "--cluster", "True", "--save_pngs",
                "False", "-e", "2"]
# cadences of the structure-logging arm: train structures, validation ones
LOG_EVERY, LOG_VAL_EVERY = 2, 4


def check_glb(path: str) -> None:
    """The .glb container of ``path``: header, length, a JSON chunk that
    parses and a binary chunk of the length it declares."""
    with open(path, "rb") as f:
        blob = f.read()
    magic, version, total, json_len, json_type = np.frombuffer(
        blob[:20], "<u4")
    gltf = json.loads(blob[20:20 + json_len])
    bin_len, bin_type = np.frombuffer(blob[20 + json_len:28 + json_len],
                                      "<u4")
    require((magic, version, total, json_type, bin_type)
            == (0x46546C67, 2, len(blob), 0x4E4F534A, 0x004E4942)
            and bin_len == gltf["buffers"][0]["byteLength"]
            == len(blob) - 28 - json_len
            and gltf["accessors"][0]["count"] > 0,
            f"{os.path.basename(path)} is a valid .glb with atoms in it")


def check_structure_files(run_dir, total_steps, lengths) -> int:
    """The files structure logging must have written for ``total_steps``
    train steps at the cadences above, each parsed; returns their number."""
    n_files = 0
    for name, every in (("train", LOG_EVERY), ("V10", LOG_VAL_EVERY)):
        sub = os.path.join(run_dir, "structures", name)
        logged = range(0, total_steps, every)
        want = {"true.pdb", "true.glb"} | {
            f"{s:05d}_{kind}" for s in logged
            for kind in ("pred.pdb", "pred.glb", "scene.glb")}
        got = set(os.listdir(sub))
        require(got == want, f"structures/{name} holds {sorted(got)}; "
                             f"expected {sorted(want)}")
        for f in sorted(want):
            path = os.path.join(sub, f)
            if f.endswith(".glb"):
                check_glb(path)
                continue
            names, _, res_nums, xyz = parse_pdb_atoms(path)
            require(len(names) > 4 * min(lengths) - 1
                    and res_nums[-1] in lengths and np.isfinite(xyz).all(),
                    f"structures/{name}/{f} is a well-formed PDB file of "
                    f"{lengths} residues")
        n_files += len(want)
    return n_files


# a seed whose sampling stream (training/trainer.py::stream_seed) draws
# three teacher-forced steps, then a sampled one with 14 predictions fed back
ENC_DEC_SAMPLING_SEED = 11_736


def enc_dec_sampling(dev, card, out_dir):
    """Scheduled sampling (both fractions 0.5) and ``predict()`` at full
    width and L = 32: four train steps with backward, of which the seed
    below draws the fourth as the sampled path, whose fed-back passes the
    backward recomputes (one more decoder call each). The reference's
    lengths: ``enc_dec_sampling_full``."""
    data = make_dataset(n_train=16, n_eval=2, min_len=31, max_len=32, seed=4,
                        device=dev)
    tr = Trainer(flagship("all", out_dir, model="enc-dec",
                          name="encdec-sampled", optimizer="adam",
                          lr_scheduling="noam", max_seq_len=32,
                          bucket_sizes=(32,), batch_size=1,
                          fraction_complete_tf=0.5,
                          fraction_subseq_tf=0.5, seed=ENC_DEC_SAMPLING_SEED),
                 device=dev, data=data)
    params = tr.init_params(torch.Generator().manual_seed(0))
    w = params["output_projection.weight"]
    params["output_projection.weight"] = (0.02 * torch.randn(
        w.shape, generator=torch.Generator().manual_seed(1))).to(dev)
    state = tr.state_from(params)
    batch = next(tr.dm.train_batches(np.random.default_rng(0)))
    length = batch.seq.shape[1]
    # what the trainer's sampling generator will draw, step by step
    replay = torch.Generator().manual_seed(
        tr.sampling_generator.initial_seed())
    want_passes = []
    for _ in range(4):
        if float(torch.rand(1, generator=replay)) < 0.5:
            want_passes.append(1)
        else:
            draws = torch.rand(length, generator=replay)
            want_passes.append(1 + int((draws[1:] > 0.5).sum()))
    passes = []
    hook = tr.model.decoder.register_forward_hook(
        lambda *_: passes.__setitem__(-1, passes[-1] + 1))
    times, losses = [], []
    for _ in range(4):
        passes.append(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = tr.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(out[0]))
    hook.remove()
    # each fed-back pass runs again in the backward
    require(passes == [2 * n - 1 for n in want_passes]
            and max(passes) > 1 and min(passes) == 1,
            f"decoder calls per step {passes}: expected "
            f"{[2 * n - 1 for n in want_passes]} (passes {want_passes}, the "
            "fed-back ones recomputed), teacher-forced and sampled steps "
            "both")
    passes = want_passes
    require(all(np.isfinite(x) and x > 0 for x in losses),
            f"finite losses through the sampled path: {losses}")

    tr.model.load_state_dict({k: v.detach() for k, v in state.params.items()})
    seq = batch.to(dev).seq
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tr.model.predict(seq)
    torch.cuda.synchronize()
    predict_ms = 1e3 * (time.perf_counter() - t0)
    with torch.no_grad():
        forced = tr.model.eval().forward_tf(seq, batch.to(dev).ang)
    require(out.shape == (*seq.shape, 24) and torch.isfinite(out).all().item()
            and float(out.abs().max()) <= 1.0,
            "predict() gives finite sin/cos of the expected shape")
    first = float((out[:, 0] - forced[:, 0]).abs().max())
    require(first <= 1e-5, f"predict()'s first position, which sees only the "
                           f"start row, is teacher forcing's ({first:.2e})")
    print(f"[enc-dec] scheduled sampling at d_model 512 x 6 + 6 layers, "
          f"B={seq.shape[0]} x L={length}, fractions 0.5 / 0.5: decoder "
          f"passes per train step {passes}, ms per step "
          + ", ".join(f"{t:.1f}" for t in times)
          + f" (the first with its warm-up), losses "
          + ", ".join(f"{x:.3f}" for x in losses)
          + f"; predict() ({length} decoder passes) {predict_ms:.1f} ms "
          f"({card})")


# the sampled path at the reference's lengths, full width, -fctf 0 -fsstf
# 0.5: (B, L, sampled steps); at L = 256 a teacher-forced step first
SAMPLED_FULL = ((8, 256, 2), (2, 500, 1))
SAMPLED_SEED = 19
# -fsstf of the short sampled step traced for the operations of a pass
SHORT_FRACTION = 0.95
# the peak max_memory_allocated that PERF.md predicts for a sampled step:
# the encoder, one decoder pass (~1.35 GB at B=8 x L=256) and the
# parameters, moments and gradients
PREDICTED_PEAK_GB = {256: 3.0, 500: 2.2}


def enc_dec_sampling_full(dev, card, out_dir) -> tuple:
    """Scheduled sampling at the reference's lengths and full width (d_model
    512, d_ff 2048, 8 heads, 6 + 6 layers, dropout 0.1, combined loss),
    ``fraction_complete_tf`` 0 and ``fraction_subseq_tf`` 0.5, every
    fed-back pass recomputed in the backward: at B=8 x L=256 one
    teacher-forced step and two sampled steps with backward, then a
    teacher-forced step and a sampled one at -fsstf 0.95 traced for the
    device operations and device ms of a step and of a fed-back pass, and
    ``predict()``; at B=2 x L=500 one sampled step. Each step's decoder
    passes must be those the sampling generator's replayed draws give, its
    loss finite, its stream synchronisations no more than the
    teacher-forced step's; prints passes, ms, peak ``max_memory_allocated``
    beside the prediction, and synchronisations a step. Returns (the
    steps' rows, the kernel launches of all the steps)."""
    rows, tf_syncs, n_steps = [], None, 0
    datasets = {length: make_dataset(n_train=bsz, n_eval=1,
                                     min_len=length - 1, max_len=length,
                                     seed=5, device=dev)
                for bsz, length, _ in SAMPLED_FULL}
    reset_launches()  # making the datasets ran K2a
    for bsz, length, n_sampled in SAMPLED_FULL:
        data = datasets[length]
        tr = Trainer(flagship("all", out_dir, model="enc-dec",
                              name=f"encdec-sampled-{length}",
                              optimizer="adam", lr_scheduling="noam",
                              max_seq_len=length, bucket_sizes=(length,),
                              batch_size=bsz, fraction_complete_tf=0.0,
                              fraction_subseq_tf=0.5, seed=SAMPLED_SEED),
                     device=dev, data=data)
        params = tr.init_params(torch.Generator().manual_seed(0))
        w = params["output_projection.weight"]
        params["output_projection.weight"] = (0.02 * torch.randn(
            w.shape, generator=torch.Generator().manual_seed(1))).to(dev)
        state = tr.state_from(params)
        batch = bench_ladder.ladder_batch(tr, bsz)
        model = tr.model
        replay = torch.Generator().manual_seed(
            tr.sampling_generator.initial_seed())
        calls = [0]
        hook = model.decoder.register_forward_hook(
            lambda *_: calls.__setitem__(0, calls[0] + 1))
        box = {"state": state}

        def step(kind):
            nonlocal n_steps
            model.fraction_complete_tf = (1.0 if kind == "teacher-forced"
                                          else 0.0)
            box["state"], box["out"] = tr.train_step(box["state"], batch)
            n_steps += 1

        def want_passes(kind, fraction=0.5) -> int:
            if kind == "teacher-forced":
                return 1
            torch.rand(1, generator=replay)  # forward's first draw
            draws = torch.rand(length, generator=replay)
            return 1 + int((draws[1:] > fraction).sum())

        kinds = (["teacher-forced"] if length == 256 else []) + (
            ["sampled"] * n_sampled)
        try:
            for kind in kinds:
                want = want_passes(kind)
                calls[0] = 0
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                before = torch.cuda.memory_allocated(dev)
                t0 = time.perf_counter()
                sites = sync_sites(lambda: step(kind))
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                peak = torch.cuda.max_memory_allocated(dev)
                loss = float(box["out"][0])
                require(calls[0] == 2 * want - 1,
                        f"B={bsz} x L={length}, {kind} step: {calls[0]} "
                        f"decoder calls, expected {2 * want - 1} ({want} "
                        "passes as the sampling generator draws them, the "
                        "fed-back ones recomputed once)")
                require(math.isfinite(loss) and loss > 0,
                        f"B={bsz} x L={length}, {kind} step: loss {loss}")
                if kind == "teacher-forced":
                    tf_syncs = len(sites)
                require(len(sites) <= tf_syncs,
                        f"B={bsz} x L={length}, {kind} step: {len(sites)} "
                        f"stream synchronisations ({where(sites)}), the "
                        f"teacher-forced step {tf_syncs}")
                rows.append({"B": bsz, "L": length, "kind": kind,
                             "passes": want, "ms": ms,
                             "peak_gb": peak / 1e9,
                             "before_gb": before / 1e9,
                             "syncs": len(sites), "loss": loss})
            if length == 256:
                # a sampled step is ~1,500 device operations a fed-back
                # pass, ~2 x 10^5 in all, whose trace takes ~50 s to read:
                # trace the teacher-forced step and a sampled one with few
                # fed-back passes, and count the steps above from them
                traced = {}
                for kind, fraction in (("teacher-forced", 0.5),
                                       ("sampled", SHORT_FRACTION)):
                    model.fraction_subseq_tf = fraction
                    want = want_passes(kind, fraction)
                    calls[0] = 0
                    traced[kind] = (want, *bench_logging.device_activity(
                        lambda: step(kind)))
                    require(calls[0] == 2 * want - 1,
                            f"traced {kind} step: {calls[0]} decoder calls, "
                            f"expected {2 * want - 1}")
                model.fraction_subseq_tf = 0.5
                (_, tf_ops, tf_ms), (short, s_ops, s_ms) = (
                    traced["teacher-forced"], traced["sampled"])
                if tf_ops is not None and s_ops is not None and short > 1:
                    pass_ops = (s_ops - tf_ops) / (short - 1)
                    pass_ms = (s_ms - tf_ms) / (short - 1)
                    for r in rows:
                        r["device_ops"] = tf_ops + (r["passes"] - 1) * pass_ops
                        r["device_ms"] = tf_ms + (r["passes"] - 1) * pass_ms
                    print(f"[enc-dec] traced at B={bsz} x L={length}: the "
                          f"teacher-forced step {tf_ops} device operations "
                          f"and {tf_ms:.1f} device ms, a sampled step of "
                          f"{short} passes (-fsstf {SHORT_FRACTION}) {s_ops} "
                          f"and {s_ms:.1f}: {pass_ops:.1f} device operations "
                          f"and {pass_ms:.2f} device ms a fed-back pass "
                          f"({card})")
                else:
                    print("[enc-dec] a trace without device records: the "
                          "steps' device operations not measured")
        finally:
            hook.remove()
        if length == 256:
            tr.model.load_state_dict({k: v.detach()
                                      for k, v in box["state"].params.items()})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tr.model.predict(batch.seq)
            torch.cuda.synchronize()
            predict_ms = 1e3 * (time.perf_counter() - t0)
            with torch.no_grad():
                forced = tr.model.eval().forward_tf(batch.seq, batch.ang)
            require(out.shape == (*batch.seq.shape, 24)
                    and torch.isfinite(out).all().item()
                    and float(out.abs().max()) <= 1.0,
                    "predict() at L = 256 gives finite sin/cos of the "
                    "expected shape")
            first = float((out[:, 0] - forced[:, 0]).abs().max())
            require(first <= 1e-5, f"predict()'s first position at L = 256 "
                                   f"is teacher forcing's ({first:.2e})")
        for r in (r for r in rows if r["L"] == length):
            ops = ("" if r.get("device_ops") is None else
                   f", {r['device_ops']:.0f} device operations and "
                   f"{r['device_ms']:.1f} device ms (from the traced steps)")
            print(f"[enc-dec] {r['kind']} step at d_model 512 x 6 + 6 "
                  f"layers, B={bsz} x L={length}, -fctf "
                  f"{1 if r['kind'] == 'teacher-forced' else 0} -fsstf 0.5: "
                  f"{r['passes']} decoder passes, {r['ms']:.1f} ms, peak "
                  f"max_memory_allocated {r['peak_gb']:.3f} GB, "
                  f"{r['peak_gb'] - r['before_gb']:.3f} GB above the "
                  f"{r['before_gb']:.3f} GB held before the step (predicted "
                  f"~{PREDICTED_PEAK_GB[length]} GB for a sampled step, "
                  "parameters and moments included), "
                  f"{r['syncs']} stream synchronisations{ops}; loss "
                  f"{r['loss']:.4f} ({card})")
        if length == 256:
            print(f"[enc-dec] predict() at B={bsz} x L={length} ({length} "
                  f"decoder passes): {predict_ms:.1f} ms ({card})")
        del tr, box, model
        gc.collect()
        torch.cuda.empty_cache()
    launches = read_launches()
    expected = launched(drmsd_fwd_grad=2 * n_steps, sidechain_fwd=n_steps,
                        sidechain_bwd=n_steps,
                        adam_update=ADAM_LAUNCHES * n_steps)
    require(launches == expected,
            f"sampled enc-dec launches {launches}: expected {expected} for "
            f"{n_steps} train steps (K1b and K6 twice, K2a and K2b once a "
            f"step)")
    return rows, launches


def enc_dec_host_time(dev, card, out_dir, data) -> dict:
    """The conv-enc and the enc-dec flagship train steps (d_model 512, 6
    and 6 + 6 layers, combined loss, dropout 0.1, Adam, Noam, teacher
    forcing) on one dataset, epochs of ``Trainer.train_epoch`` interleaved
    (conv-enc, enc-dec, enc-dec, conv-enc) under PTT_LOOP_PROFILE=1: wall
    ms a step and the loop's phases; device operations and device ms a
    step from a trace of three steps; the five costliest Python sites of
    one step of each under cProfile."""
    trainers = {name: Trainer(flagship("all", out_dir, model=model,
                                       name=f"host-{name}", optimizer="adam",
                                       lr_scheduling="noam",
                                       repeat_train=TRAIN_REPEAT),
                              device=dev, data=data)
                for name, model in (("conv-enc", MODEL),
                                    ("enc-dec", "enc-dec"))}
    states = {name: tr.init_state(torch.Generator().manual_seed(0))
              for name, tr in trainers.items()}
    wall = {name: [] for name in trainers}
    phases = {name: [] for name in trainers}
    for name in ("conv-enc", "enc-dec", "enc-dec", "conv-enc"):
        states[name], seconds, steps, ph = bench_logging.epoch(
            trainers[name], states[name])
        wall[name].append(1e3 * seconds / steps)
        phases[name].append(ph)
    out = {}
    for name, tr in trainers.items():
        batch = next(tr.dm.train_batches(np.random.default_rng(0))).to(dev)

        def step(tr=tr, name=name):
            states[name] = tr.train_step(states[name], batch)[0]

        n_ops, dev_ms = profile_steps(step)

        def synced_step():
            step()
            torch.cuda.synchronize()

        synced_step()
        # the host's own work: no wait for the device in it
        sites = bench_logging.costliest_sites(step)
        torch.cuda.synchronize()
        out[name] = {"ms": statistics.median(wall[name]),
                     "ms_each": wall[name], "device_ops": n_ops,
                     "device_ms": dev_ms, "phases": phases[name][-1],
                     "sites": sites}
        print(f"[enc-dec host] {name}: {out[name]['ms']:.2f} ms a train "
              f"step (epochs " + ", ".join(f"{t:.2f}" for t in wall[name])
              + f"), {n_ops:.0f} device operations, {dev_ms:.2f} device ms; "
              "loop profile ms a step: " + ", ".join(
                  f"{k} {v:.2f}" for k, v in phases[name][-1].items())
              + "; costliest Python sites of one step (own ms, calls): "
              + "; ".join(f"{s} {t:.2f} ms x {n:.0f}" for s, t, n in sites)
              + f" ({card})")
    ce, ed = out["conv-enc"], out["enc-dec"]
    print(f"[enc-dec host] enc-dec / conv-enc: wall {ed['ms'] / ce['ms']:.2f}"
          f"x, device operations {ed['device_ops'] / ce['device_ops']:.2f}x, "
          f"device ms {ed['device_ms'] / ce['device_ms']:.2f}x; host ms an "
          f"operation {ed['ms'] / ed['device_ops'] * 1e3:.1f} us against "
          f"{ce['ms'] / ce['device_ops'] * 1e3:.1f} us ({card})")
    return out


def phase_enc_dec(dev, card, out_dir):
    """The encoder-decoder family through the CLI and predict at full width,
    without and with structure logging; structure logging's cost on the
    flagship loop; the enc-dec step's host time beside the conv-enc
    step's; its sampled paths at L = 32 and at the reference's lengths.
    Returns the launches of the CLI run that logs structures and of the
    sampled steps at full length."""
    data = make_dataset(n_train=16, n_eval=16, min_len=255, max_len=256,
                        seed=2, device=dev)
    for split in [k for k in data if k.startswith("valid-")]:
        if split != "valid-10":
            del data[split]
    data_path = os.path.join(out_dir, "encdec_data.pt")
    torch.save(data, data_path)
    base = ["--data", data_path, "--out_dir", out_dir, *ENC_DEC_ARGS]
    arms = {"off": ["--name", "encdec-off", "--log_structure_step", "0",
                    "-lvs", "0"],
            "on": ["--name", "encdec-on", "--log_structure_step",
                   str(LOG_EVERY), "--log_val_struct_step",
                   str(LOG_VAL_EVERY)]}
    dm = DataModule(data, cli.config_from_args(base))
    eval_steps = {s: len(list(dm.eval_index_batches(s)))
                  for s in dm.eval_splits}
    require(set(eval_steps) == {"valid-10", "test"},
            "one validation split and test")
    n_eval = 2 * eval_steps["valid-10"] + eval_steps["test"]
    step_ms, launches = {}, {}
    for arm, flags in arms.items():
        with timed_train_epochs() as epochs:
            reset_launches()
            out = run_cli(base + flags)
            launches[arm] = read_launches()
        steps = [n for _, n, _ in epochs]
        total = sum(steps)
        n_logged = 0 if arm == "off" else (
            len(range(0, total, LOG_EVERY))
            + len(range(0, total, LOG_VAL_EVERY)))
        expected = launched(drmsd_fwd=2 * n_eval, drmsd_fwd_grad=2 * total,
                            sidechain_fwd=total + n_eval + n_logged,
                            sidechain_bwd=total, kabsch_rmsd=n_eval,
                            adam_update=ADAM_LAUNCHES * total)
        require(len(steps) == 2 and min(steps) >= 4
                and launches[arm] == expected,
                f"enc-dec CLI launches, logging {arm}: {launches[arm]}; "
                f"expected {expected} for epochs of {steps} train steps "
                f"(K1b and K6 twice, K2a and K2b once a step), {n_eval} eval "
                f"steps (K1a twice, K2a and K5 once) and {n_logged} logged "
                f"structures "
                "(K2a once each), no K3")
        require("[ Epoch 1 ]" in out and "(Valid-10)" in out
                and "(Test)" in out, "two epochs, validation and test ran")
        step_ms[arm] = 1e3 * epochs[1][0] / epochs[1][1]

    run_dir = os.path.join(out_dir, "encdec-on")
    n_files = check_structure_files(run_dir, total, (255, 256))
    best = os.path.join(run_dir, "checkpoints", "best")
    check_restore(base + arms["on"], best, dev, steps)

    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        paths = predict.main([run_dir, "--data", data_path, "--split", "test",
                              "--n", "16", "--batch", "8", "--out",
                              os.path.join(out_dir, "preds_encdec")])
    predict_launches = read_launches()
    require(predict_launches == launched(sidechain_fwd=2),
            f"enc-dec predict launches {predict_launches}: expected K2a "
            "twice and no other kernel")
    require(len(paths) == 32, "16 pred/true pairs")
    for path in paths:
        names, _, res_nums, xyz = parse_pdb_atoms(path)
        require(len(names) > 4 * 255 - 1 and np.isfinite(xyz).all(),
                f"{os.path.basename(path)} is well formed")

    host = enc_dec_host_time(dev, card, out_dir, data)["enc-dec"]
    print(f"[enc-dec] d_model 512 x 6 + 6 layers, combined loss, dropout "
          f"0.1, teacher forcing, epochs of {steps} train steps of B=16 x "
          f"L=256 and {n_eval} eval steps through the CLI "
          f"({epochs.paths[-1]}): {step_ms['off']:.2f} ms/train step "
          f"(second epoch); {host['device_ops']:.0f} device operations and "
          f"{host['device_ms']:.2f} ms of device time per step, idle share "
          f"{1 - host['device_ms'] / host['ms']:.2f} (beside the conv-enc "
          f"step: [enc-dec host]); restored bit for bit; predict wrote "
          f"{len(paths)} PDB files; launches {json.dumps(launches['off'])} "
          f"({card})")
    print(f"[structure-log] --log_structure_step {LOG_EVERY} "
          f"--log_val_struct_step {LOG_VAL_EVERY}, one validation split: "
          f"{n_files} files (pred.pdb, pred.glb, scene.glb per logged step; "
          f"true.pdb, true.glb) exist and parse; train loop "
          f"{step_ms['on']:.2f} ms/step with logging on beside "
          f"{step_ms['off']:.2f} with it off (second epochs; launches with "
          f"logging {json.dumps(launches['on'])}) ({card})")
    logging_cost(dev, card)
    enc_dec_sampling(dev, card, out_dir)
    _, sampled_launches = enc_dec_sampling_full(dev, card, out_dir)
    return launches["on"], sampled_launches


def logging_cost(dev, card) -> dict:
    """Structure logging at the default cadences (10 and 50) against off,
    on the flagship conv-enc loop (``tools/bench_logging.py``: epochs of 27
    steps interleaved off, on, on, off): ms, device operations and device
    ms a step, the loop profile's phases, and no stream synchronisation on
    the train loop with logging on (the worker's copies to the host
    apart)."""
    results = bench_logging.run(dev, repeat=25)
    for arm in ("off", "on"):
        loop = results[arm]["loop_syncs"]
        require(not loop, f"structure logging {arm}: {len(loop)} stream "
                          f"synchronisations on the train loop ({where(loop)})")
    require(results["on"]["files"] > 0 and results["off"]["files"] == 0,
            "the logging arm wrote structures, the other none")
    return results


# the data paths of phase 13: the device store, prefetched host batches, and
# the synchronous host path that the port ran before the store
DATA_PATHS = {"store": "true", "prefetch": "false", "sync": "false"}
DATA_PATH_LABELS = {"store": "device store",
                    "prefetch": "prefetched host batches",
                    "sync": "synchronous host batches"}
# the spans of every training epoch, which LoopProfiler reports as phases
LOOP_PHASES = ("train.batch", "train.step", "train.forward",
               "train.backward", "train.optimizer", "train.fetch",
               "train.watchdog", "train.flush")
# the probe's dataset: more proteins than the probed batch takes, so that
# the epoch after the probe trains batches of the probed size
PROBE_PROTEINS = 1536


def synchronous_host_stream(batches):
    """The host path before the store and the prefetch thread: the step gets
    the host batch, and its ``Batch.to`` copies each field from pageable
    memory and waits."""
    return ((batch, batch) for batch in batches)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.device == b.device
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def check_store_batches(tr, dev, split, index_iter) -> int:
    """Every batch of ``index_iter`` from the trainer's store equals
    ``collate(...).to(dev)`` bit for bit, all six fields; returns their
    number."""
    split_obj = tr.dm.train if split == "train" else tr.dm.eval_splits[split]
    n = 0
    for idx in index_iter:
        got = stored_batch(tr, split, idx)
        want = collate(split_obj, idx, tr.cfg.bucket_sizes,
                       tr.dm.max_seq_len).to(dev)
        require(got.n_res == want.n_res and all(
            same_bits(getattr(got, f), getattr(want, f))
            for f in ("seq", "ang", "ang_mask", "crd", "crd_mask",
                      "protein_mask")),
                f"{split} batch {n} from the store equals its collated copy "
                "bit for bit")
        n += 1
    return n


def path_batch(path, tr, split, idx):
    """The device batch of rows ``idx`` as a data path hands it to a step
    (the synchronous path hands the host batch, which the step copies)."""
    if path == "store":
        return stored_batch(tr, split, idx)
    split_obj = tr.dm.train if split == "train" else tr.dm.eval_splits[split]
    host = collate(split_obj, idx, tr.cfg.bucket_sizes, tr.dm.max_seq_len)
    return next(iter(tr._host_stream(iter([host]))))[1]


def phase_data_path(dev, card, out_dir):
    """The training loop's three data paths at the flagship width: the
    store's batches against collate, then train and eval epochs of each,
    interleaved, with their device operations, device time and stream
    synchronisations, and one step of the store against one of host
    batches at dropout 0."""
    split = "test"
    data = make_dataset(n_train=16, n_eval=16, min_len=255, max_len=256,
                        seed=3, device=dev)
    kw = dict(optimizer="adam", lr_scheduling="noam", max_seq_len=256,
              repeat_train=TRAIN_REPEAT)
    trainers = {path: Trainer(flagship("all", out_dir, name=f"data-{path}",
                                       device_data=flag, **kw),
                              device=dev, data=data)
                for path, flag in DATA_PATHS.items()}
    trainers["sync"]._host_stream = synchronous_host_stream
    require([data_path(tr) for tr in trainers.values()]
            == ["device store"] + ["prefetched host batches"] * 2,
            "--device_data true builds the store, false does not")
    store_tr = trainers["store"]
    n_train = check_store_batches(store_tr, dev, "train",
                                  store_tr.dm.train_index_batches(
                                      np.random.default_rng(0)))
    n_eval = check_store_batches(store_tr, dev, split,
                                 store_tr.dm.eval_index_batches(split))
    print(f"[data-path] the store's batches equal collate(...).to(device) "
          f"bit for bit: {n_train} train batches of one epoch, {n_eval} "
          f"eval batches of {split}")

    # a synchronisation made on another thread (the prefetch thread's
    # place) is counted as well
    def elsewhere():
        t = threading.Thread(target=lambda: torch.ones(256).to(dev))
        t.start()
        t.join()

    on_thread = sync_count(elsewhere)
    require(on_thread >= 1, "a synchronising copy on another thread is "
                            f"counted ({on_thread})")

    params = random_weights(store_tr, dev)
    states = {path: tr.state_from(params) for path, tr in trainers.items()}
    for path, tr in trainers.items():  # warm-up epochs, every path
        states[path] = train_epoch_timed(tr, states[path])[0]
        timed_epoch(tr, params, split)
    times = {path: [] for path in DATA_PATHS}
    eval_times = {path: [] for path in DATA_PATHS}
    for path in ("store", "prefetch", "sync", "sync", "prefetch", "store",
                 "store", "sync", "prefetch"):
        states[path], sec, steps, _ = train_epoch_timed(trainers[path],
                                                        states[path])
        times[path].append(1e3 * sec / steps)
        eval_times[path].append(
            1e3 * timed_epoch(trainers[path], params, split)[1] / n_eval)

    train_idx = next(store_tr.dm.train_index_batches(
        np.random.default_rng(0)))
    eval_idx = next(store_tr.dm.eval_index_batches(split))
    shapes = [tuple(stored_batch(store_tr, s, idx).seq.shape)
              for s, idx in (("train", train_idx), (split, eval_idx))]
    report = {}
    for path, tr in trainers.items():
        def train_epoch(path=path, tr=tr):
            states[path] = TRAIN_EPOCH(tr, states[path])

        def train_step(path=path, tr=tr):
            states[path] = tr.train_step(
                states[path], path_batch(path, tr, "train", train_idx))[0]

        def eval_step(path=path, tr=tr):
            tr.eval_step(params, path_batch(path, tr, split, eval_idx))

        t_ops, t_dev = profile_steps(train_epoch, steps=1)
        e_ops, e_dev = profile_steps(
            lambda tr=tr: tr.eval_epoch(params, split), steps=1)
        r = {"train_ms": statistics.median(times[path]),
             "train_device_ops": t_ops / steps,
             "train_device_ms": t_dev / steps,
             "train_step_syncs": sync_sites(train_step),
             "train_epoch_syncs": sync_count(train_epoch),
             "eval_ms": statistics.median(eval_times[path]),
             "eval_device_ops": e_ops / n_eval,
             "eval_device_ms": e_dev / n_eval,
             "eval_step_syncs": sync_sites(eval_step),
             "eval_epoch_syncs": sync_count(
                 lambda tr=tr: tr.eval_epoch(params, split))}
        report[path] = r
        print(f"[data-path] {DATA_PATH_LABELS[path]}: train step "
              f"{r['train_ms']:.2f} ms, {r['train_device_ops']:.0f} device "
              f"operations, {r['train_device_ms']:.2f} device ms (idle share "
              f"{1 - r['train_device_ms'] / r['train_ms']:.2f}), "
              f"{len(r['train_step_syncs'])} stream synchronisations a step "
              f"({where(r['train_step_syncs'])}), {r['train_epoch_syncs']} in "
              f"an epoch of {steps} steps; eval step {r['eval_ms']:.2f} ms, "
              f"{r['eval_device_ops']:.0f} device operations, "
              f"{r['eval_device_ms']:.2f} device ms (idle share "
              f"{1 - r['eval_device_ms'] / r['eval_ms']:.2f}), "
              f"{len(r['eval_step_syncs'])} synchronisations a step "
              f"({where(r['eval_step_syncs'])}), {r['eval_epoch_syncs']} in an "
              f"epoch of {n_eval} steps; medians of 3 epochs, interleaved "
              f"with the other paths; B x L = {shapes[0]} training, "
              f"{shapes[1]} eval ({card})")
    store = report["store"]
    require(not store["train_step_syncs"] and not store["train_epoch_syncs"],
            "the store path's train step and epoch make no stream "
            f"synchronisation ({where(store['train_step_syncs'])}; "
            f"{store['train_epoch_syncs']} in the epoch)")
    require(len(store["eval_step_syncs"]) <= EVAL_SYNCS,
            f"the store path's eval step makes at most {EVAL_SYNCS} stream "
            f"synchronisations ({where(store['eval_step_syncs'])})")

    # one step from identical weights at dropout 0, store against host
    # batches (prefetched): the batches are equal, and so must the losses be
    losses = {}
    for path in ("store", "prefetch"):
        tr = Trainer(flagship("all", out_dir, name=f"data-ab-{path}",
                              device_data=DATA_PATHS[path], dropout=0.0,
                              **kw), device=dev, data=data)
        out = tr.train_step(tr.state_from(params),
                            path_batch(path, tr, "train", train_idx))[1]
        losses[path] = float(out[0])
    gap = abs(losses["store"] - losses["prefetch"]) / abs(losses["prefetch"])
    require(np.isfinite(losses["store"]) and gap <= 1e-6,
            f"one step at dropout 0: loss with the store {losses['store']} "
            f"vs host batches {losses['prefetch']} within 1e-6 relative")
    print(f"[data-path] one step at dropout 0 from identical weights: loss "
          f"{losses['store']:.9f} with the store, {losses['prefetch']:.9f} "
          f"with host batches ({gap:.1e} relative); a synchronising copy on "
          f"another thread counted {on_thread} time(s) ({card})")
    return report


def csv_rows(path):
    with open(path) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def phase_dev_data(dev, card, out_dir):
    """The CLI on the repo's own chains, examples/dev_data (NaN angles,
    missing atoms), at full width for two epochs, with the store and
    without it."""
    base = ["--data", DEV_DATA, "--out_dir", out_dir, "-m", MODEL, "-dm",
            "512", "-dih", "2048", "-nh", "8", "-nl", "6", "-do", "0.1",
            "-l", "combined", "-opt", "adam", "--lr_scheduling", "noam",
            "-b", "2", "--repeat_train", "4", "--cluster", "True",
            "--log_structure_step", "0", "-lvs", "0", "-e", "2"]
    data = load_dataset(DEV_DATA)
    dm = DataModule(data, cli.config_from_args(base))
    require(set(dm.eval_splits) == {"valid-70", "test"},
            "dev data: valid-70 and test")
    n_eval = (2 * len(list(dm.eval_index_batches("valid-70")))
              + len(list(dm.eval_index_batches("test"))))
    masked = [float(1 - np.isfinite(np.concatenate(data["train"][k])).mean())
              for k in ("ang", "crd")]
    runs = {}
    for flag in ("true", "false"):
        with timed_train_epochs() as epochs:
            reset_launches()
            run_cli(base + ["--name", f"dev-{flag}", "--device_data", flag])
            launches = read_launches()
        steps = [n for _, n, _ in epochs]
        total = sum(steps)
        expected = launched(drmsd_fwd=2 * n_eval, drmsd_fwd_grad=2 * total,
                            sidechain_fwd=total + n_eval,
                            sidechain_bwd=total, kabsch_rmsd=n_eval,
                            adam_update=ADAM_LAUNCHES * total)
        require(len(steps) == 2 and min(steps) >= 2
                and launches == expected,
                f"dev data CLI launches, --device_data {flag}: {launches}; "
                f"expected {expected} for epochs of {steps} train steps (K1b "
                f"and K6 twice, K2a and K2b once a step) and {n_eval} eval "
                "steps (K1a twice, K2a and K5 once)")
        want_path = "device store" if flag == "true" else \
            "prefetched host batches"
        require(epochs.paths == [want_path] * 2,
                f"--device_data {flag} trains on the {want_path}")
        run_dir = os.path.join(out_dir, f"dev-{flag}")
        for path in ("checkpoints/best", "checkpoints/best.meta.json",
                     "config.json"):
            require(os.path.isfile(os.path.join(run_dir, path)),
                    f"dev-{flag}/{path} written")
        header, rows = csv_rows(os.path.join(run_dir, f"dev-{flag}.train"))
        epoch_rows = {r["mode"]: r for r in rows
                      if r["granularity"] == "epoch"}
        require(set(epoch_rows) == {"train", "valid-70", "test"},
                f"epoch rows of train, valid-70 and test ({flag})")
        for mode, r in epoch_rows.items():
            require(all(np.isfinite(float(r[k])) and float(r[k]) > 0
                        for k in ("drmsd", "ln_drmsd", "rmse", "combined")),
                    f"finite epoch metrics for {mode} ({flag}): {r}")
        runs[flag] = (header, rows, steps, epochs, launches)
    header, rows, steps, epochs, launches = runs["true"]
    require(header == runs["false"][0], "the same CSV columns")
    # the first epoch: its train batches and its train epoch row
    first = [r for r in rows if r["mode"] == "train"][:steps[0] + 1]
    other = [r for r in runs["false"][1] if r["mode"] == "train"][
        :steps[0] + 1]
    worst = 0.0
    for a, b in zip(first, other):
        for k in ("drmsd", "ln_drmsd", "rmse", "combined"):
            rel = abs(float(a[k]) - float(b[k])) / abs(float(b[k]))
            worst = max(worst, rel)
    require(len(first) == len(other) == steps[0] + 1 and worst <= 1e-4,
            f"first-epoch losses with and without the store within 1e-4 "
            f"relative ({worst:.2e})")
    ms = {flag: 1e3 * r[3][1][0] / r[3][1][1] for flag, r in runs.items()}
    print(f"[dev-data] examples/dev_data ({len(data['train']['seq'])} train "
          f"chains, {masked[0]:.1%} of angle entries and {masked[1]:.1%} of "
          f"atom coordinates missing), {MODEL} at d_model 512 x 6 layers, "
          f"2 epochs of {steps} train steps and {n_eval} eval steps through "
          f"the CLI with --device_data true and false: first-epoch losses "
          f"within {worst:.2e} relative; second epoch {ms['true']:.2f} "
          f"ms/train step with the store, {ms['false']:.2f} with prefetched "
          f"host batches; launches {json.dumps(launches)} ({card})")


def phase_tools(dev, card, out_dir):
    """The batch-size probe through the CLI up to real out-of-memory
    errors, then a profiler trace and the loop profile of one epoch each."""
    data = make_dataset(n_train=PROBE_PROTEINS, n_eval=1, min_len=255,
                        max_len=256, seed=4, device=dev)
    data_path = os.path.join(out_dir, "probe_data.pt")
    torch.save(data, data_path)
    argv = ["--data", data_path, "--out_dir", out_dir, "-m", MODEL, "-dm",
            "512", "-dih", "2048", "-nh", "8", "-nl", "6", "-do", "0.1",
            "-l", "combined", "-opt", "adam", "--lr_scheduling", "noam",
            "--train_only", "--cluster", "True", "--log_structure_step", "0",
            "-lvs", "0", "-e", "1"]
    # what the probe caught, by type and first line (never the exception:
    # its traceback holds the tried tensors), and how long it took
    caught, probe_seconds = [], []
    is_oom, probe = batch_probe._is_oom, batch_probe.probe_trainer_batch_size

    def recording_is_oom(e):
        caught.append((type(e).__name__, str(e).splitlines()[0][:120]))
        return is_oom(e)

    def timed_probe(trainer, **kw):
        t0 = time.perf_counter()
        b = probe(trainer, **kw)
        probe_seconds.append(time.perf_counter() - t0)
        return b

    batch_probe._is_oom = recording_is_oom
    batch_probe.probe_trainer_batch_size = timed_probe
    try:
        with timed_train_epochs() as epochs:
            # descending order: a batch is --batch_size rows, the probed
            # shape (the binned sampler's residue budget is batch_size x 500
            # residues, ~2x the rows at L=256)
            out = run_cli(argv + ["--name", "probe", "-adbs", "True",
                                  "--batching_order", "descending"])
    finally:
        batch_probe._is_oom = is_oom
        batch_probe.probe_trainer_batch_size = probe
    answer = int(out.split("automatically determined batch size:")[1]
                 .split()[0])
    require(any(name == "OutOfMemoryError" for name, _ in caught),
            f"the probe reached a real OutOfMemoryError ({caught})")
    seconds, steps, n_res = epochs[0]
    rows = min(answer, PROBE_PROTEINS)
    require(epochs.paths == ["device store"] and steps
            == -(-PROBE_PROTEINS // answer),
            f"one epoch at batch {answer} on the store ({steps} steps)")
    print(f"[probe] -adbs True through the CLI at {MODEL}, d_model 512 x 6 "
          f"layers, L=256: batch {answer} (0.8 of the frontier) in "
          f"{probe_seconds[0]:.1f} s; errors caught: "
          + "; ".join(sorted({f"{n}: {m}" for n, m in caught}))
          + f"; then one epoch of {steps} steps, the first of {rows} "
          f"proteins, in {seconds:.2f} s ({n_res / seconds:.0f} res/s) on "
          f"the device store ({card})")
    gc.collect()
    torch.cuda.empty_cache()

    small = make_dataset(n_train=16, n_eval=1, min_len=255, max_len=256,
                         seed=5, device=dev)
    small_path = os.path.join(out_dir, "tools_data.pt")
    torch.save(small, small_path)
    argv = [a if a != data_path else small_path for a in argv] + [
        "--repeat_train", str(TRAIN_REPEAT), "-b", "8"]
    trace_dir = os.path.join(out_dir, "trace")
    run_cli(argv + ["--name", "profiled", "--profile_dir", trace_dir])
    with open(os.path.join(trace_dir, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    cpu_ops = [e for e in events if e.get("cat") == "cpu_op"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = {e.get("name") for e in cpu_ops}
    require("aten::index" in names and "aten::convolution" in names,
            "the trace holds the epoch's CPU operations (the store's "
            "gather, the convolutions)")
    with open(os.path.join(trace_dir, SPANS_FILE)) as f:
        spans = json.load(f)
    ranges = collections.Counter(e.get("name") for e in events
                                 if e.get("cat") == "user_annotation")
    steps = spans["count"].get("train.step", 0)
    require(steps > 0 and all(ranges[k] == n
                              for k, n in spans["count"].items()),
            f"{SPANS_FILE} holds the epoch's spans, each a range of the "
            f"trace ({spans['count']} against {dict(ranges)})")
    print(f"[profile-dir] --profile_dir: {TRACE_FILE} "
          f"({os.path.getsize(os.path.join(trace_dir, TRACE_FILE))} bytes) "
          f"parses: {len(cpu_ops)} CPU operations, {len(kernels)} device "
          f"kernel events"
          + ("" if kernels else " (none: the profiler's known empty-trace "
             "fault)") + f"; {SPANS_FILE}: {steps} train.step spans, every "
          f"span a range of the trace ({card})")

    sessions = []
    train_epoch = Trainer.train_epoch

    def recording(self, *args, **kwargs):
        out = train_epoch(self, *args, **kwargs)
        sessions.append(tracing.last_session())
        return out

    os.environ[tracing.SWITCH] = "1"
    Trainer.train_epoch = recording
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            run_cli(argv + ["--name", "loop-profiled"])
    finally:
        Trainer.train_epoch = train_epoch
        del os.environ[tracing.SWITCH]
    session = sessions[-1]
    missing = [p for p in LOOP_PHASES if p not in session["count"]]
    require(not missing, f"PTT_LOOP_PROFILE=1 records every span of the "
            f"training epoch (missing {missing})")
    report = LoopProfiler.of(session).report(
        session["total_ms"]["train.epoch"] / 1e3)
    print(f"[loop-profile] PTT_LOOP_PROFILE=1, one epoch through the CLI "
          f"({card}):\n{report}")


# the bf16 instances' kernels, as ptxas names their templates
BF16_KERNELS = ("flash_attn_fwd_bf16_kernel", "flash_attn_bwd_bf16_kernel")
# (B, H, L, D) of the bf16 instances: phase 8's cases and the two head
# dimensions that those leave out, timed; then, checked only, every head
# dimension at lengths that end inside a tile of 64 and of 32 keys (1, 70,
# 130, 500) or on one (256), with row 1's first 64 keys masked (half its
# keys at L <= 64) and a valid key after them.
# tests/test_torch_bf16.py::test_bf16_kernels_match_plain_on_card holds the
# same cases.
BF16_TIMED_CASES = ATTENTION_CASES + ((2, 3, 130, 32), (2, 2, 70, 128))
BF16_ATTENTION_CASES = BF16_TIMED_CASES + tuple(
    (4, 2, length, dim) for dim in (16, 32, 64, 128)
    for length in (1, 70, 130, 256, 500))
# A bf16 result against a reference on the same bf16-valued inputs, over the
# reference's largest entry: bf16 keeps 8 bits of mantissa (2^-9 = 2e-3
# relative a rounding), and O and each gradient take a few roundings (the
# inputs' products are exact; P, dS and the output are rounded).
BF16_TOL = 1e-2
BF16 = torch.bfloat16


def bf16_err(got, want, like=None) -> float:
    """max |got - want| over the largest |want| (or of ``like``)."""
    want = want.float()
    like = want if like is None else like
    return (float((got.float() - want).abs().max())
            / max(float(like.abs().max()), 1e-30))


def attention_bf16_case(dev, card, rng, shape):
    """K3a-bf16 and the bf16 backward against their plain versions and an
    fp32 run on the same bf16 values, at one (B, H, L, D); returns
    {kernel: (error, kernel ms, plain ms, bound ms, what bounds it, library
    ms, device ms or None, library device ms or None)}, or {kernel:
    (error,)} for a case outside BF16_TIMED_CASES."""
    bsz, heads, length, dim = shape
    where = f"bf16 B={bsz} H={heads} L={length} D={dim}"
    q, k, v = head_split(rng, dev, shape, gains=(3.0, 1.0, 1.0), dtype=BF16)
    d_out = head_split(rng, dev, shape, dtype=BF16)[0]
    n_valid = rng.integers(1, length + 1, bsz)
    n_valid[0] = length
    if bsz > 1:
        n_valid[-1] = 0  # a batch row with no valid key, as collate pads
    keys = np.arange(length)
    valid = keys[None, :] < n_valid[:, None]
    timed = shape in BF16_TIMED_CASES
    if not timed:
        # a key tile without a valid key before the first valid one
        hole = 64 if length > 64 else length // 2
        valid[1] = (keys >= hole) & (keys <= rng.integers(hole, length))
    valid = torch.from_numpy(valid).to(dev)
    scale = 1.0 / math.sqrt(dim)

    poison_allocator(dev, BF16)
    got, k_grads = attention_grads(q, k, v, valid, d_out, scale, "cuda")
    want, p_grads = attention_grads(q, k, v, valid, d_out, scale, "torch")
    # the fp32 function on the same (bf16-valued) inputs
    ref, r_grads = attention_grads(q.float(), k.float(), v.float(), valid,
                                   d_out.float(), scale, "torch")
    poison_allocator(dev, BF16)
    out, m, l = A.flash_attn_fwd_cuda(q, k, v, valid, scale, with_stats=True)
    bwd_args = (q, k, v, valid, d_out, out, m, l, scale)
    poison_allocator(dev, BF16)
    b_grads = A.flash_attn_bwd_cuda(*bwd_args)
    b_plain = A.flash_attn_bwd_torch(*bwd_args)
    torch.cuda.synchronize()
    require(got.dtype == out.dtype == BF16 and all(
        g.dtype == BF16 for g in (*k_grads, *b_grads)),
        f"bf16 outputs and gradients, {where}")
    require(torch.isfinite(got).all().item() and torch.equal(got, out)
            and all(torch.isfinite(g).all().item()
                    for g in (*k_grads, *b_grads)),
            f"values and gradients finite, the all-pad row included, {where}")
    # the kernel table's error: kernel against plain, absolute
    abs_errs = {"flash_attn_fwd_bf16": float((got.float() - want.float())
                                             .abs().max()),
                "flash_attn_bwd_bf16": max(
                    float((b.float() - p.float()).abs().max())
                    for b, p in zip(b_grads, b_plain))}
    errs = {"O": (bf16_err(got, ref), bf16_err(want, ref),
                  bf16_err(got, want))}
    # at one key P = 1, so dS = P (dP - delta) and with it dQ and dK are
    # zero, and every version returns the rounding residue of dP - delta
    # (the plain ones too): there the largest entry has no scale, and in
    # the untimed cases at L = 1 the residue is held to that of the
    # cancelled term, scale dP K (dQ) or scale dP Q (dK); the timed (1, 1,
    # 1, 16) keeps the largest entry, which its residues meet
    d_p = (d_out.float() * v.float()).sum(-1, keepdim=True)
    likes = ({"q": scale * d_p * k.float(), "k": scale * d_p * q.float()}
             if length == 1 and not timed else {})
    for name, g, b, p, r in zip("qkv", k_grads, b_grads, b_plain, r_grads):
        like = likes.get(name)
        errs["d" + name.upper()] = (
            max(bf16_err(g, r, like), bf16_err(b, r, like)),
            bf16_err(p, r, like), bf16_err(b, p, like))
    for what, (kernel, plain, apart) in errs.items():
        require(max(kernel, plain, apart) <= BF16_TOL,
                f"{what}: kernel {kernel:.3e} and plain {plain:.3e} from the "
                f"fp32 run, {apart:.3e} apart, of its largest entry, within "
                f"{BF16_TOL}, {where}")
    got2, k_grads2 = attention_grads(q, k, v, valid, d_out, scale, "cuda")
    b_grads2 = A.flash_attn_bwd_cuda(*bwd_args)
    require(torch.equal(got2, got)
            and all(torch.equal(a, b) for a, b in zip(k_grads2, k_grads))
            and all(torch.equal(a, b) for a, b in zip(b_grads2, b_grads)),
            f"a second call gives the same bits, {where}")

    accuracy = (f"[bf16] attention {where}: of the largest entry, kernel / "
                "plain from the fp32 run on the same values, kernel from "
                "plain: " + ", ".join(f"{what} {e[0]:.2e} / {e[1]:.2e}, "
                                      f"{e[2]:.2e}"
                                      for what, e in errs.items())
                + f" (gate {BF16_TOL}); all finite, same bits twice")
    if not timed:
        print(accuracy + f" ({card})")
        return {name: (err,) for name, err in abs_errs.items()}
    timings, pairs = attention_timings(q, k, v, valid, d_out, scale,
                                       bwd_args, shape, n_valid, elem=2)
    out = {name: (abs_errs[name], *t) for name, t in timings.items()}
    print(accuracy + "; kernel vs "
          "plain vs library (bf16 sdpa) ms: "
          + ", ".join(f"{name} {v[1]:.4f} vs {v[2]:.4f} vs {v[5]:.4f}"
                      for name, v in out.items())
          + f"; {pairs} weighted pairs, bounds in ms: "
          + ", ".join(f"{name} {v[3]:.5f} by {v[4]}"
                      for name, v in out.items())
          + "".join(f"; {name} device-only {v[6]:.4f} ms ({v[3] / v[6]:.2f}"
                    f" of its bound), library {v[7]:.4f}"
                    for name, v in out.items() if v[6] is not None)
          + f" (median of {TIMED_RUNS}; {card})")
    return out


def phase_bf16_kernels(dev, card):
    rng = np.random.default_rng(12)
    return {case: attention_bf16_case(dev, card, rng, case)
            for case in BF16_ATTENTION_CASES}


def params_moved(before, after) -> bool:
    """Every parameter still float32, and every one that the loss reaches
    moved (the attention key bias has a gradient of exactly zero)."""
    return all(after[k].dtype == torch.float32 for k in after) and all(
        not torch.equal(before[k], after[k].detach())
        for k in after if not k.endswith("attn.wk.bias"))


def phase_bf16(dev, card, out_dir):
    """--compute_dtype bfloat16 at the flagship width: train steps beside
    fp32 ones, flash training at dropout 0 against the bf16 materialised
    branch, then a CLI epoch with flash attention and predict from its run.
    Returns the launches of the flash training epoch and of predict, and
    (config, ms and device ms a step) of the bf16 train step."""
    data = make_dataset(n_train=16, n_eval=16, min_len=255, max_len=256,
                        seed=1, device=dev)
    for split in [k for k in data if k.startswith("valid-")]:
        if split != "valid-10":
            del data[split]
    kw = dict(optimizer="adam", lr_scheduling="noam", max_seq_len=256,
              repeat_train=FLASH_TRAIN_REPEAT)
    trainers = {dtype: Trainer(flagship("all", out_dir, name=f"bf16-{dtype}",
                                        compute_dtype=dtype, **kw),
                               device=dev, data=data)
                for dtype in ("bfloat16", "float32")}
    params = random_weights(trainers["bfloat16"], dev)
    states = {dtype: tr.state_from(params) for dtype, tr in trainers.items()}
    for dtype, tr in trainers.items():  # warm-up epoch, both
        states[dtype] = train_epoch_timed(tr, states[dtype])[0]
    before = {k: v.detach().clone() for k, v in states["bfloat16"].params
              .items()}
    reset_launches()
    states["bfloat16"], seconds, steps, _ = train_epoch_timed(
        trainers["bfloat16"], states["bfloat16"])
    launches = read_launches()
    require(launches == launched(drmsd_fwd_grad=2 * steps,
                                 sidechain_fwd=steps, sidechain_bwd=steps,
                                 adam_update=ADAM_LAUNCHES * steps),
            f"bf16 training launches {launches} for {steps} steps at "
            "dropout 0.1 (materialised attention)")
    require(params_moved(before, states["bfloat16"].params),
            "bf16 training keeps float32 parameters and moves them")
    times = {"bfloat16": [seconds / steps], "float32": []}
    for dtype in ("float32", "float32", "bfloat16", "bfloat16", "float32"):
        states[dtype], sec, n, _ = train_epoch_timed(trainers[dtype],
                                                     states[dtype])
        times[dtype].append(sec / n)
    idx = next(trainers["bfloat16"].dm.train_index_batches(
        np.random.default_rng(0)))
    profiles = {}
    for dtype, tr in trainers.items():
        def step(dtype=dtype, tr=tr):
            states[dtype] = tr.train_step(
                states[dtype], stored_batch(tr, "train", idx))[0]
        profiles[dtype] = profile_steps(step)
    bf16_step = (trainers["bfloat16"].cfg,
                 1e3 * statistics.median(times["bfloat16"]),
                 profiles["bfloat16"][1])
    print(f"[bf16] train step, {MODEL}, d_model 512 x 6 layers, dropout "
          f"0.1, {steps} steps of B=16 x L=256 an epoch, {data_path(trainers['bfloat16'])}"
          f": ms/step "
          + ", ".join(f"{dtype} {1e3 * statistics.median(t):.2f} "
                      f"({profiles[dtype][0]:.0f} device operations, "
                      f"{profiles[dtype][1]:.2f} device ms a step)"
                      for dtype, t in times.items())
          + f", medians of 3 epochs, interleaved; launches "
          f"{json.dumps(launches)} ({card})")

    # flash training at dropout 0: the bf16 backward instance counted
    flash = Trainer(flagship("all", out_dir, name="bf16-flash",
                             compute_dtype="bfloat16", attention_impl="flash",
                             **{**kw, "dropout": 0.0}), device=dev, data=data)
    state = train_epoch_timed(flash, flash.state_from(params))[0]
    reset_launches()
    state, seconds, steps, _ = train_epoch_timed(flash, state)
    flash_launches = read_launches()
    expected = launched(drmsd_fwd_grad=2 * steps, sidechain_fwd=steps,
                        sidechain_bwd=steps, flash_attn_fwd_bf16=6 * steps,
                        flash_attn_bwd_bf16=6 * steps,
                        adam_update=ADAM_LAUNCHES * steps)
    require(flash_launches == expected,
            f"bf16 flash training launches {flash_launches}: expected "
            f"{expected}")
    print(f"[bf16] flash training at dropout 0: {steps} steps, "
          f"{1e3 * seconds / steps:.2f} ms/step; launches "
          f"{json.dumps(flash_launches)} ({card})")
    # One MSE step from identical weights: flash against the materialised
    # branch, both bf16, and each against the fp32 step. The two bf16 arms
    # round P (unnormalised in the kernel, normalised in the branch) and
    # sum in other orders: each is its own bf16 approximation of the fp32
    # step, and bf16 moves a gradient by several per cent of its norm (read
    # on the CPU at small width: up to 9e-2 in L2, 0.2 of the largest entry,
    # the embedding's). So the limits come from the materialised branch's
    # own distance from fp32, as phase 10's combined-loss gates come from
    # float64: the two bf16 arms within twice its worst distance plus 1e-2
    # (entries and L2, the loss likewise relative plus 1e-4), and every
    # gradient of the flash arm no farther from fp32 than twice the
    # materialised arm's plus 1e-2 (L2).
    labels = ("bf16 flash", "bf16 materialised")
    flash_step, xla_step, fp32_step = (
        one_step(dev, data, params, out_dir, "all", attention_impl=impl,
                 compute_dtype=dtype, name=f"ab-{impl}-{dtype}", loss="mse")
        for impl, dtype in (("flash", "bfloat16"), ("xla", "bfloat16"),
                            ("xla", "float32")))
    far = {label: gradient_distances(step[1], fp32_step[1])
           for label, step in zip(labels, (flash_step, xla_step))}
    own = far[labels[1]].values()
    hold_steps(flash_step, xla_step, labels,
               entry_tol=2 * max(d[0] for d in own) + 1e-2,
               norm_tol=2 * max(d[1] for d in own) + 1e-2,
               loss_tol=2 * abs(xla_step[0] - fp32_step[0])
               / abs(xla_step[0]) + 1e-4)
    for name, (_, d_flash) in far[labels[0]].items():
        limit = 2 * far[labels[1]][name][1] + 1e-2
        require(d_flash <= limit,
                f"{name} gradient: bf16 flash {d_flash:.3e} (L2) from the "
                f"fp32 step, limit {limit:.3e}")
    print("[bf16] MSE step, distance of the gradients from the fp32 step "
          "(largest entry, L2; worst parameter): "
          + ", ".join(f"{label} {max(d[0] for d in dist.values()):.3e}, "
                      f"{d:.3e} ({name})" for label, dist, (d, name) in (
                          (label, dist, max((d[1], name)
                                            for name, d in dist.items()))
                          for label, dist in far.items()))
          + f"; losses {flash_step[0]:.6f} / {xla_step[0]:.6f} / fp32 "
          f"{fp32_step[0]:.6f} ({card})")

    # the CLI: one epoch with flash attention, then predict from its run
    data_file = os.path.join(out_dir, "bf16_data.pt")
    torch.save(data, data_file)
    argv = ["--data", data_file, "--name", "bf16", "--out_dir", out_dir,
            "-m", MODEL, "-dm", "512", "-dih", "2048", "-nh", "8", "-nl", "6",
            "-do", "0.1", "-l", "combined", "-opt", "adam",
            "--lr_scheduling", "noam", "-b", "8", "--cluster", "True",
            "--log_structure_step", "0", "-lvs", "0", "--attention_impl",
            "flash", "--compute_dtype", "bfloat16", "-e", "1"]
    cfg = cli.config_from_args(argv)
    dm = DataModule(data, cfg)
    steps = len(list(dm.train_index_batches(np.random.default_rng(0))))
    n_eval = sum(len(list(dm.eval_index_batches(s))) for s in dm.eval_splits)
    reset_launches()
    run_cli(argv)
    cli_launches = read_launches()
    expected = launched(drmsd_fwd=2 * n_eval, drmsd_fwd_grad=2 * steps,
                        sidechain_fwd=steps + n_eval, sidechain_bwd=steps,
                        flash_attn_fwd_bf16=6 * n_eval, kabsch_rmsd=n_eval,
                        adam_update=ADAM_LAUNCHES * steps)
    require(cli_launches == expected,
            f"bf16 CLI launches {cli_launches}: expected {expected}")
    run_dir = os.path.join(out_dir, "bf16")
    with open(os.path.join(run_dir, "config.json")) as f:
        require(json.load(f)["config"]["compute_dtype"] == "bfloat16",
                "config.json keeps compute_dtype bfloat16")
    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        paths = predict.main([run_dir, "--data", data_file, "--split",
                              "test", "--n", "16", "--batch", "8", "--out",
                              os.path.join(out_dir, "preds_bf16")])
    seconds = time.perf_counter() - t0
    predict_launches = read_launches()
    require(predict_launches == launched(flash_attn_fwd_bf16=12,
                                         sidechain_fwd=2),
            f"bf16 predict launches {predict_launches}: expected K3a-bf16 "
            "6 x 2 and K2a twice")
    require(len(paths) == 32, "16 pred/true pairs")
    for path in paths:
        _, _, res_nums, xyz = parse_pdb_atoms(path)
        require(len(res_nums) > 0 and np.isfinite(xyz).all(),
                f"{os.path.basename(path)} is well formed")
    print(f"[bf16] CLI epoch ({steps} train steps, {n_eval} eval steps of "
          f"B=8 x L=256) and predict.main for 16 proteins in "
          f"{seconds:.2f} s, 32 PDB files; launches of the CLI "
          f"{json.dumps(cli_launches)}, of predict "
          f"{json.dumps(predict_launches)} ({card})")
    return flash_launches, predict_launches, bf16_step


# ---------------------------------------------------------------- phase 17

# The names training/wandb_logging.py logs and the summaries it writes;
# tests/test_torch_wandb.py holds ``expected_wandb_keys`` of a CLI run equal
# to what the JAX package's wandb_logging gives for that run.
WANDB_TRAIN_BATCH = (
    "Train Batch RMSE", "Train Batch DRMSD", "Train Batch ln-DRMSD",
    "Train Batch Combined Loss", "Train Batch Speed", "Batch size",
    "Train Batch DRMSD Backbone", "Train Batch ln-DRMSD Backbone",
    "Train Batch RMSE Backbone", "Train Batch RMSE Sidechain",
    "Learning Rate")
WANDB_ANGLE_HISTOGRAMS = ("Predicted Angles (sin cos)",
                          "Predicted Angles (radians)")
WANDB_EPOCH = ("RMSE", "RMSD", "DRMSD", "ln-DRMSD", "Combined Loss",
               "ln-DRMSD Backbone", "DRMSD Backbone", "RMSE Backbone",
               "RMSE Sidechain")
WANDB_VALID_AVG = ("RMSE", "RMSD", "DRMSD", "ln-DRMSD", "Combined Loss")
WANDB_FINAL_EPOCH = ("drmsd", "mse", "rmsd", "comb", "speed")
WANDB_STRUCTURE = ("mol", "3d", "scene", "align_rmsd")


def expected_wandb_keys(modes, flax_paths, modifiers, structures=()):
    """(logged keys, summary keys) of a training run with --use_wandb True
    that evaluates ``modes`` (train, the validation splits it has, test),
    has parameters at ``flax_paths``, writes the checkpoints ``modifiers``
    and logs structures under the names ``structures``."""
    valid = [m for m in modes if m.startswith("valid")]
    logged = {*WANDB_TRAIN_BATCH, *WANDB_ANGLE_HISTOGRAMS}
    logged |= {f"{kind}/params/{path}" for kind in ("parameters",
                                                     "gradients")
               for path in flax_paths}
    logged |= {f"{mode.title()} Epoch {k}" for mode in modes
               if mode != "train" for k in WANDB_EPOCH}
    if valid:
        logged |= {f"Valid-Avg Epoch {k}" for k in WANDB_VALID_AVG}
    logged |= {f"{name}_{k}" for name in structures for k in WANDB_STRUCTURE}
    summary = {"stopped_training_early", "max_batch_size",
               "avg_training_speed"}
    if valid:
        summary.add("avg_evaluation_speed")
    summary |= {f"{m}_validation_{k}" for m in modifiers
                for k in ("loss", "epoch")}
    summary |= {f"final_epoch_{mode}_{k}" for mode in modes
                for k in WANDB_FINAL_EPOCH}
    return logged, summary


class RecordingRun:
    """A wandb run that keeps what it is given."""

    def __init__(self, **init):
        self.init, self.summary, self.logged, self.saved = init, {}, [], []
        self.finished = False
        self.config = types.SimpleNamespace(update=lambda *a, **kw: None)

    def log(self, payload, commit=True):
        self.logged.append(payload)

    def save(self, path, base_path=None, policy=None):
        self.saved.append(path)

    def finish(self):
        self.finished = True

    def keys(self) -> set:
        return {k for payload in self.logged for k in payload}


class Recorded:
    """wandb's Histogram, Molecule, Object3D and Image: what they were
    given (a file is read at once, as wandb reads it)."""

    def __init__(self, data=None, np_histogram=None, **kw):
        self.data = data.read() if hasattr(data, "read") else data
        self.np_histogram = np_histogram


@contextlib.contextmanager
def recording_wandb():
    """A ``wandb`` module that records (the card's machine has neither the
    package nor a network) in ``sys.modules`` while the block runs; yields
    the runs its ``init`` makes."""
    runs = []
    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: runs.append(RecordingRun(**kw)) or runs[-1]
    for name in ("Histogram", "Molecule", "Object3D", "Image"):
        setattr(fake, name, type(name, (Recorded,), {}))
    before = sys.modules.get("wandb")
    sys.modules["wandb"] = fake
    try:
        yield runs
    finally:
        if before is None:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = before


@contextlib.contextmanager
def made_trainers():
    """Yields the list of the Trainers made inside the block."""
    made, init = [], Trainer.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    Trainer.__init__ = keep
    try:
        yield made
    finally:
        Trainer.__init__ = init


def check_histograms(payload, model, prefix) -> None:
    """One finite histogram of every parameter's numel under ``prefix``."""
    params = dict(model.named_parameters())
    for name, path in flax_names(model).items():
        counts, edges = payload[f"{prefix}/params/{path}"].np_histogram
        require(np.isfinite(edges).all()
                and counts.sum() == params[name].numel(),
                f"{prefix} histogram of {path}: finite, every entry counted")


def phase_wandb(dev, card, out_dir):
    """--use_wandb True at the flagship width through the CLI on the device
    store, with a recording wandb module; then a train epoch with wandb on
    and off, interleaved, and the gradient probe alone. Returns the probe's
    launches."""
    data = make_dataset(n_train=16, n_eval=8, min_len=255, max_len=256,
                        seed=6, device=dev)
    for split in [k for k in data if k.startswith("valid-")]:
        if split != "valid-10":
            del data[split]
    data_file = os.path.join(out_dir, "wandb_data.pt")
    torch.save(data, data_file)
    argv = ["--data", data_file, "--name", "wandb", "--out_dir", out_dir,
            "-m", MODEL, "-dm", "512", "-dih", "2048", "-nh", "8", "-nl", "6",
            "-do", "0.1", "-l", "combined", "-opt", "adam",
            "--lr_scheduling", "noam", "-b", "8", "--repeat_train",
            str(TRAIN_REPEAT), "--cluster", "True", "--use_wandb", "True",
            "--log_structure_step", "1000", "-lvs", "0", "-e", "2"]
    dm = DataModule(data, cli.config_from_args(argv))
    n_eval = 2 * len(list(dm.eval_index_batches("valid-10"))) + len(
        list(dm.eval_index_batches("test")))
    with recording_wandb() as runs, made_trainers() as made, \
            timed_train_epochs() as epochs:
        reset_launches()
        run_cli(argv)
        launches = read_launches()
    (run,), (tr,) = runs, made
    steps = sum(n for _, n, _ in epochs)
    # every step's launches, the probe's (K1b twice, K2a and K2b once, as a
    # train step) at the end of each of the 2 epochs, the eval steps', and
    # K2a once for the structure logged at step 0; K6 only in the steps (the
    # probe updates nothing)
    expected = launched(drmsd_fwd=2 * n_eval,
                        drmsd_fwd_grad=2 * (steps + 2),
                        sidechain_fwd=steps + 2 + n_eval + 1,
                        sidechain_bwd=steps + 2, kabsch_rmsd=n_eval,
                        adam_update=ADAM_LAUNCHES * steps)
    require(epochs.paths == ["device store"] * 2 and launches == expected,
            f"wandb CLI launches {launches}: expected {expected} for "
            f"{steps} train steps on the store, 2 probes and {n_eval} eval "
            "steps")
    names = flax_names(tr.model)
    modes = ["train", "valid-10", "test"]
    want_logged, want_summary = expected_wandb_keys(
        modes, names.values(), ["best"], structures=["train"])
    require(run.keys() == want_logged,
            f"the logged keys: missing {sorted(want_logged - run.keys())}, "
            f"extra {sorted(run.keys() - want_logged)}")
    require(set(run.summary) == want_summary,
            f"the summary keys: missing "
            f"{sorted(want_summary - set(run.summary))}, extra "
            f"{sorted(set(run.summary) - want_summary)}")
    rows = [p for p in run.logged if "Train Batch RMSE" in p]
    angles = [p for p in run.logged if WANDB_ANGLE_HISTOGRAMS[0] in p]
    hists = [p for p in run.logged
             if any(k.startswith("parameters/") for k in p)]
    require(len(rows) == len(angles) == steps and len(hists) == 2,
            f"{len(rows)} train rows and {len(angles)} angle histograms for "
            f"{steps} steps; {len(hists)} histogram payloads for 2 epochs")
    for payload in hists:
        require(len(payload) == 2 * len(names), "one parameter and one "
                "gradient histogram per parameter")
        for prefix in ("parameters", "gradients"):
            check_histograms(payload, tr.model, prefix)
    require(run.finished and run.init["project"] == "protein-transformer-tpu"
            and os.path.isfile(os.path.join(out_dir, "wandb", "MODEL.txt")),
            "the run was opened, finished, and MODEL.txt written")

    # a train epoch with wandb on and off, interleaved, on the store
    kw = dict(optimizer="adam", lr_scheduling="noam", max_seq_len=256,
              repeat_train=TRAIN_REPEAT)
    trainers = {flag: Trainer(flagship("all", out_dir, name=f"wandb-{flag}",
                                       use_wandb=flag == "on", **kw),
                              device=dev, data=data)
                for flag in ("on", "off")}
    trainers["on"].wandb_run = on_run = RecordingRun()
    params = random_weights(trainers["on"], dev)
    states = {flag: tr.state_from(params) for flag, tr in trainers.items()}
    with recording_wandb():
        for flag, tr in trainers.items():  # warm-up epochs
            states[flag] = train_epoch_timed(tr, states[flag])[0]
        times = {"on": [], "off": []}
        for flag in ("on", "off", "off", "on", "on", "off"):
            states[flag], sec, n, _ = train_epoch_timed(trainers[flag],
                                                        states[flag])
            times[flag].append(1e3 * sec / n)
        report = {}
        for flag, tr in trainers.items():
            def epoch(flag=flag, tr=tr):
                states[flag] = TRAIN_EPOCH(tr, states[flag])
            ops, dev_ms = profile_steps(epoch, steps=1)
            report[flag] = (statistics.median(times[flag]), ops / n,
                            dev_ms / n, sync_sites(epoch))
        n_rows = sum("Train Batch RMSE" in p for p in on_run.logged)
        require(n_rows == sum(WANDB_ANGLE_HISTOGRAMS[0] in p
                            for p in on_run.logged) > 0,
                "each step on the cadence logs its row and its histograms")
        on = trainers["on"]
        reset_launches()
        grads = on._probe_gradients(states["on"])
        probe_launches = read_launches()
        require(probe_launches == launched(drmsd_fwd_grad=2, sidechain_fwd=1,
                                           sidechain_bwd=1),
                f"the probe's launches {probe_launches}: K1b twice, K2a and "
                "K2b once, as a train step")
        require(all(torch.isfinite(g).all() for g in grads.values())
                and sum(bool(g.any()) for g in grads.values())
                > len(grads) // 2, "the probe's gradients are finite")
        probe_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            on._probe_gradients(states["on"])
            torch.cuda.synchronize()
            probe_ms.append(1e3 * (time.perf_counter() - t0))
        probe_ops, probe_dev_ms = profile_steps(
            lambda: on._probe_gradients(states["on"]))
        t0 = time.perf_counter()
        W.watch_params(on_run, on.model, states["on"].params, grads)
        watch_ms = 1e3 * (time.perf_counter() - t0)
    require(not report["on"][3],
            f"a train epoch with wandb on, on the store, makes no stream "
            f"synchronisation ({where(report['on'][3])})")
    print(f"[wandb] CLI with --use_wandb True, {MODEL}, d_model 512 x 6 "
          f"layers, 2 epochs of {steps // 2} steps on the device store: "
          f"{len(run.keys())} keys logged and {len(run.summary)} summaries, "
          f"the expected ones; {len(hists)} x {len(names)} parameter and "
          f"gradient histograms, finite; launches {json.dumps(launches)} "
          f"({card})")
    print(f"[wandb] train step, medians of 3 epochs of {n} steps, "
          f"interleaved: wandb on {report['on'][0]:.2f} ms "
          f"({report['on'][1]:.0f} device operations, {report['on'][2]:.2f} "
          f"device ms, {len(report['on'][3])} synchronisations an epoch), "
          f"off {report['off'][0]:.2f} ms ({report['off'][1]:.0f}, "
          f"{report['off'][2]:.2f}, {len(report['off'][3])}); the gradient "
          f"probe, once an epoch: {statistics.median(probe_ms):.2f} ms, "
          f"{probe_ops:.0f} device operations, {probe_dev_ms:.2f} device "
          f"ms, launches {json.dumps(probe_launches)}; watch_params "
          f"{watch_ms:.1f} ms on the host ({card})")
    return probe_launches


# the lengths of phase 17's synthetic ProteinNet entries, by split: the
# training file's (chain A of <pdbid>.pdb in the structure cache), the
# validation file's (its 30% bucket) and the testing file's (the CASP
# targets directory)
DATA_TOOL_LENGTHS = {"train": (256, 200, 150, 120, 90, 64, 255, 180),
                     "valid-30": (128, 240), "test": (100, 230)}
# the largest per-angle MSE (rad^2) of the measured angles against those
# that built the files
ANGLE_MSE = 1e-5
# rebuilt coordinates: the card's build against a float64 plain one of the
# same angles (the coordinate gate); and against the true structure, where the PDB files' three
# decimals decide: their rounding moves the measured angles by ~1e-3 rad,
# which the chain's lever arms carry to ~1e-2 A at L = 256 (to ~2e-2 A at
# L = 500), so 1e-3 A cannot hold there
REBUILD_KERNEL_TOL = 1e-3
REBUILD_TRUE_TOL = 5e-2


def phase_data_tools(dev, card, out_dir):
    """The dataset tools on synthetic proteins: PDB files and ProteinNet
    text, the dataset built from them, one CLI epoch on it, the rebuild of
    an item on the card, the embedding export. Returns the rebuild's
    launches."""
    rng = np.random.default_rng(17)
    root = os.path.join(out_dir, "proteinnet")
    raw, cache, targets = (os.path.join(root, d)
                           for d in ("raw", "cache", "targets"))
    for d in (raw, cache, targets):
        os.makedirs(d)
    truth, records = {}, {"train": [], "valid-30": [], "test": []}
    for split, lengths in DATA_TOOL_LENGTHS.items():
        for i, length in enumerate(lengths):
            seq = "".join(rng.choice(list(STD_AAS), size=length))
            ang = random_angles(rng, length)
            ids = torch.tensor([VOCAB[c] for c in seq], device=dev)
            with torch.no_grad():
                crd = G.build_coords(torch.from_numpy(ang).to(dev),
                                     ids).cpu().numpy()
            pdbid = f"{len(truth)}syn"
            pnid = {"train": f"{pdbid.upper()}_1_A",
                    "valid-30": f"30#{pdbid.upper()}_1_A",
                    "test": f"TBM#T9{len(truth):03d}"}[split]
            path = (os.path.join(targets, f"T9{len(truth):03d}.pdb")
                    if split == "test" else os.path.join(cache,
                                                         f"{pdbid}.pdb"))
            PdbWriter(crd, seq, chain="A").save_pdb(path)
            truth[pnid] = (seq, ang, crd)
            records[split].append(f"[ID]\n{pnid}\n[PRIMARY]\n{seq}\n"
                                  f"[MASK]\n{'+' * length}\n")
    for split, name in (("train", "training_30"), ("valid-30", "validation"),
                        ("test", "testing")):
        with open(os.path.join(raw, name), "w") as f:
            f.write("\n".join(records[split]) + "\n")
    data_file = os.path.join(root, "dataset.pt")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        data = proteinnet_to_dataset.main([raw, cache, data_file,
                                           "--targets", targets])
    build_s = time.perf_counter() - t0
    require(buf.getvalue().startswith("0 preprocessing failures"),
            f"the dataset builds without failures: {buf.getvalue()}")
    diffs = []  # (residues, 12) wrapped differences, NaN where unmeasured
    for split, lengths in DATA_TOOL_LENGTHS.items():
        require(sorted(len(s) for s in data[split]["seq"])
                == sorted(lengths), f"every {split} protein built")
        for pnid, seq, sincos in zip(data[split]["ids"], data[split]["seq"],
                                     data[split]["ang"]):
            want_seq, ang, _ = truth[pnid]
            require(seq == want_seq, f"{pnid}: its sequence")
            got = np.arctan2(sincos[:, 1::2], sincos[:, 0::2])
            diffs.append(np.angle(np.exp(1j * (got - ang))))
    diffs = np.concatenate(diffs)
    measured = np.isfinite(diffs).sum(0)
    require(measured[:6].min() > 0 and measured[6] > 0,
            f"every backbone angle and chi 1 measured: {measured}")
    per_angle = [float(np.mean(d[np.isfinite(d)] ** 2))
                 for d in diffs.T if np.isfinite(d).any()]
    worst = max(per_angle)
    require(worst <= ANGLE_MSE, f"measured angles: per-angle MSE {worst:.2e} "
                                f"rad^2, at most {ANGLE_MSE}")

    # one CLI epoch at the flagship width on the built dataset
    argv = ["--data", data_file, "--name", "pn", "--out_dir", out_dir,
            "-m", MODEL, "-dm", "512", "-dih", "2048", "-nh", "8", "-nl", "6",
            "-do", "0.1", "-l", "combined", "-opt", "adam",
            "--lr_scheduling", "noam", "-b", "4", "--repeat_train", "2",
            "--cluster", "True", "--log_structure_step", "0", "-lvs", "0",
            "-e", "1"]
    with timed_train_epochs() as epochs:
        run_cli(argv)
    run_dir = os.path.join(out_dir, "pn")
    _, rows = csv_rows(os.path.join(run_dir, "pn.train"))
    epoch_rows = {r["mode"]: r for r in rows if r["granularity"] == "epoch"}
    require(set(epoch_rows) == {"train", "valid-30", "test"} and all(
        np.isfinite(float(r[k])) for r in epoch_rows.values()
        for k in ("drmsd", "rmse", "combined")),
            f"finite epoch metrics of train, valid-30 and test: {epoch_rows}")

    # the rebuild of the longest training item, on the card
    item = int(np.argmax([len(s) for s in data["train"]["seq"]]))
    pnid, seq = data["train"]["ids"][item], data["train"]["seq"][item]
    reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        paths = dataset_item_to_pdb.main([
            data_file, "--split", "train", "--idx", str(item), "--rebuild",
            "--out", os.path.join(root, f"{pnid}_true.pdb")])
    rebuild_launches = read_launches()
    require(rebuild_launches == launched(sidechain_fwd=1),
            f"--rebuild launches K2a once: {rebuild_launches}")
    sincos = data["train"]["ang"][item]
    on_card = dataset_item_to_pdb.rebuild_coords(sincos, seq, dev)
    # the same angles built in float64 by the plain version on the host
    plain = G.build_coords(
        inverse_trig_transform(torch.from_numpy(np.nan_to_num(sincos))
                               .double()),
        torch.tensor([VOCAB[c] for c in seq]), "torch").numpy()
    true_crd = np.asarray(data["train"]["crd"][item]).reshape(on_card.shape)
    real = np.isfinite(true_crd[..., 0])
    # every atom but the last residue's O, whose psi no residue follows
    carried = real.copy()
    carried[-1, 3] = False
    _, written = pdb_to_record(paths[1])
    kernel_err = float(np.linalg.norm(on_card - plain, axis=-1)[real].max())
    true_err = float(np.linalg.norm(on_card - truth[pnid][2],
                                    axis=-1)[carried].max())
    file_err = float(np.abs(written - on_card)[real].max())
    require(kernel_err <= REBUILD_KERNEL_TOL,
            f"rebuilt on the card vs float64 plain: {kernel_err:.2e} A")
    require(true_err <= REBUILD_TRUE_TOL,
            f"rebuilt vs the true structure: {true_err:.2e} A")
    require(file_err <= 5.1e-4, f"the rebuilt PDB file holds the rebuild "
                                f"({file_err:.1e} A)")

    with contextlib.redirect_stdout(io.StringIO()):
        vec_path, lab_path = export_embeddings_to_tsv.main(
            [run_dir, "--out", os.path.join(root, "embeddings")])
    vectors = np.loadtxt(vec_path, delimiter="\t")
    _, model = predict.load_run(run_dir, device=dev)
    table = model.state_dict()["embeddings.embed.weight"].cpu().numpy()
    with open(lab_path) as f:
        labels = f.read().split("\n")[:-1]
    require(vectors.shape == table.shape and np.abs(vectors - table).max()
            <= 5.1e-7 and labels == [VOCAB.int2char(i)
                                     for i in range(len(table))],
            f"vectors.tsv {vectors.shape} holds the embedding table "
            f"{table.shape}; labels.tsv its letters")
    seconds, n, _ = epochs[0]
    print(f"[data-tools] {len(truth)} synthetic proteins (L = "
          f"{min(min(v) for v in DATA_TOOL_LENGTHS.values())}-"
          f"{max(max(v) for v in DATA_TOOL_LENGTHS.values())}) as PDB files "
          f"and ProteinNet text -> scripts.proteinnet_to_dataset (no fetch) "
          f"in {build_s:.2f} s: measured angles within {worst:.2e} rad^2 "
          f"(per-angle MSE); one CLI epoch on it, {n} steps in {seconds:.2f} "
          f"s; scripts.dataset_item_to_pdb --rebuild of {pnid} (L = "
          f"{len(seq)}) on the card, K2a once: {kernel_err:.1e} A from a "
          f"float64 plain build of the same angles, {true_err:.1e} A from "
          f"the true "
          f"structure; scripts.export_embeddings_to_tsv: {vectors.shape} "
          f"table ({card})")
    return rebuild_launches


# ---------------------------------------------------------------- phase 18

# the flagship CLI run of every rank process: 30 proteins of L = 255-256 in
# two batches of 15 (16 rows), dropout 0 so that every mesh computes the
# single-process numbers
MULTI_GPU_ARGS = ["-m", MODEL, "-dm", "512", "-dih", "2048", "-nh", "8",
                  "-nl", "6", "-do", "0", "-l", "combined", "-opt", "adam",
                  "--lr_scheduling", "noam", "-b", "15", "--batching_order",
                  "descending", "-e", "1", "--cluster", "True",
                  "--log_structure_step", "0", "-lvs", "0"]
# (name, backend, ranks, extra flags): the runs of phase 18
MULTI_GPU_RUNS = (
    ("nccl-1", "nccl", 1, ["--mesh_shape", "-1"]),
    ("dp-2", "gloo", 2, ["--mesh_shape", "2"]),
    ("tp-2", "gloo", 2, ["--mesh_shape", "1", "2", "--mesh_axes", "data",
                         "model", "--attention_impl", "flash"]))
MULTI_GPU_KERNELS = ("drmsd_fwd_grad", "sidechain_fwd", "sidechain_bwd",
                     "adam_update")
MULTI_GPU_FLASH = ("flash_attn_fwd", "flash_attn_bwd")
RANK_TIMEOUT = 300   # seconds a run's ranks may take, start-up included
CSV_METRICS = ("drmsd", "ln_drmsd", "rmse", "rmsd", "combined")


def rank_child(out_dir: str, argv: list) -> int:
    """One rank process of phase 18, started as ``chip_smoke.py
    --rank-child DIR <CLI flags>`` with a multi-process environment: the
    CLI with TF32 off, then this rank's kernel launches into
    DIR/launches.rank<r>.json."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ.get("RANK", os.environ.get("PTT_PROCESS_ID", "0")))
    reset_launches()
    cli.main(argv)
    with open(os.path.join(out_dir, f"launches.rank{rank}.json"), "w") as f:
        json.dump(read_launches(), f)
    return 0


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_ranks(name: str, n: int, out_dir: str, argv: list) -> list:
    """The processes of one run: under torch.distributed.run with
    PTT_DISTRIBUTED=1 for one rank, through the PTT_* triple for more."""
    port = free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("PTT_")}
    child = [os.path.abspath(__file__), "--rank-child", out_dir, *argv]
    if n == 1:
        cmds = [[sys.executable, "-m", "torch.distributed.run", "--nnodes",
                 "1", "--nproc_per_node", "1", "--master_addr", "127.0.0.1",
                 "--master_port", str(port), *child]]
        envs = [dict(env, PTT_DISTRIBUTED="1")]
    else:
        cmds = [[sys.executable, *child]] * n
        envs = [dict(env, PTT_COORDINATOR=f"127.0.0.1:{port}",
                     PTT_NUM_PROCESSES=str(n), PTT_PROCESS_ID=str(r))
                for r in range(n)]
    return [subprocess.Popen(cmd, cwd=ROOT, env=e, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for cmd, e in zip(cmds, envs)]


def finish_ranks(procs: list, name: str) -> list:
    """The ranks' outputs; a rank that fails or outlives RANK_TIMEOUT fails
    the phase (and every process of the run is stopped)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        require(False, f"run {name}: a rank did not finish within "
                       f"{RANK_TIMEOUT} s")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f"run {name}: rank {rank} exited with "
                                   f"{p.returncode}:\n{out[-4000:]}")
    return outs


def csv_numbers(path: str):
    """(mode, granularity) of each CSV row, and its metric columns."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return ([(r["mode"], r["granularity"]) for r in rows],
            np.array([[float(r[k]) for k in CSV_METRICS] for r in rows]))


def phase_multi_gpu(dev, card, out_dir):
    """Phase 18; returns each kernel's launches over every rank of every
    run."""
    data = make_dataset(n_train=30, n_eval=8, min_len=255, max_len=256,
                        seed=0, device=dev)
    for split in [k for k in data if k.startswith("valid-")]:
        if split != "valid-10":
            del data[split]
    data_path = os.path.join(out_dir, "multi_gpu.pt")
    torch.save(data, data_path)
    base = ["--data", data_path, "--out_dir", out_dir, *MULTI_GPU_ARGS]
    walls = {}
    for impl in ("xla", "flash"):
        t0 = time.perf_counter()
        run_cli(base + ["--name", f"one-{impl}", "--attention_impl", impl])
        walls[f"one-{impl}"] = time.perf_counter() - t0
    total = dict.fromkeys(COUNTERS, 0)
    for name, backend, n, flags in MULTI_GPU_RUNS:
        run_dir = os.path.join(out_dir, name)
        os.makedirs(run_dir)
        t0 = time.perf_counter()
        outs = finish_ranks(start_ranks(name, n, run_dir,
                                        base + ["--name", name, *flags]),
                            name)
        walls[name] = time.perf_counter() - t0
        for rank, out in enumerate(outs):
            require(f"rank {rank} of {n} on cuda:0: backend {backend}" in out,
                    f"run {name}: rank {rank} chose the {backend} backend on "
                    f"cuda:0:\n{out[-2000:]}")
        counts = []
        for rank in range(n):
            with open(os.path.join(run_dir, f"launches.rank{rank}.json")) as f:
                counts.append(json.load(f))
        flash = "flash" in flags
        needed = MULTI_GPU_KERNELS + (MULTI_GPU_FLASH if flash else ())
        require(all(c[k] > 0 for c in counts for k in needed)
                and all(c == counts[0] for c in counts),
                f"run {name}: every rank launched {needed}, each as often "
                f"as the others: {counts}")
        for c in counts:
            for k, v in c.items():
                total[k] += v
        ref = "one-flash" if flash else "one-xla"
        labels, got = csv_numbers(os.path.join(out_dir, name,
                                               f"{name}.train"))
        want_labels, want = csv_numbers(os.path.join(out_dir, ref,
                                                     f"{ref}.train"))
        require(labels == want_labels
                and labels.count(("train", "batch")) == 2,
                f"run {name}: the CSV rows of two train steps and the eval "
                f"epochs, as the single-process run's: {labels}")
        gap = float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                            1e-30)))
        require(np.allclose(got, want, rtol=2e-4, atol=1e-6),
                f"run {name}: CSV numbers within rtol 2e-4 of {ref}'s "
                f"(largest relative gap {gap:.2e})")
        print(f"[multi-gpu] {name}: {n} rank(s), backend {backend}, "
              f"{' '.join(flags)}: CSV numbers within {gap:.2e} of the "
              f"single-process run's; launches a rank "
              f"{json.dumps({k: counts[0][k] for k in needed})}; "
              f"{walls[name]:.1f} s wall with start-up ({card})")
    print(f"[multi-gpu] single-process runs in this process: "
          f"{walls['one-xla']:.1f} s (xla), {walls['one-flash']:.1f} s "
          f"(flash), for information: ranks sharing one card measure "
          f"nothing about scaling ({card})")
    return total


# Phase 19: the scale-data tools at the JAX tools' defaults. The generated
# splits (name, chains, id prefix) at 50-250 residues, and the seed.
SCALE_SPLITS = (("train", 300, "TRN"), ("valid-70", 40, "VAL"),
                ("test", 40, "TST"))
SCALE_LENGTHS = (50, 250)
SCALE_SEED = 20260819
# the JAX tools/oracle_floor.py's line at its defaults (n 20, L 150, the
# seed above) on the CPU: mean, median, min, max (A)
ORACLE_FLOOR = (27.59, 24.76, 11.66, 54.00)
FLOOR_TOL = 0.01
ORACLE_CHAINS, ORACLE_LENGTH = 20, 150
# the card's coordinates against a float64 plain build of the same angles
SCALE_COORD_TOL = 1e-3
# stress_pipeline's training chains; at 4x the chains a stage may take 8x
# the time plus 1 s (linear work takes 4x; an O(n^2) stage ~16x)
STRESS_SIZES = (1000, 4000)
STRESS_STAGES = ("gen", "load", "split", "store", "plan", "collate")
# The recipe of the JAX package's convergence run c4 (STATUS.md: conv-enc,
# d_model 256, 6 layers, the combined loss, Adam + Noam), with the flags it
# did not record chosen once here and kept (PERF.md): 4 x 500 residues a
# batch, 1,000 warm-up steps; structure logging off.
CONVERGENCE_ARGS = ["-m", "conv-enc", "-dm", "256", "-nl", "6",
                    "-l", "combined", "-opt", "adam", "--lr_scheduling",
                    "noam", "-b", "4", "-nws", "1000", "--cluster", "True",
                    "--log_structure_step", "0", "-lvs", "0"]
CONVERGENCE_EPOCHS = 12
# valid-70 angle RMSE after the last epoch: at most this, and at most this
# share of epoch 0's (c4: 0.545 -> ~0.16 by epoch 11)
CONVERGENCE_RMSE = 0.30
CONVERGENCE_SHARE = 0.6
# gen_dev_data against examples/dev_data: the PDB files' third decimal may
# round the other way (1e-3 exactly); per-angle MSE as in phase 17
DEV_COORD_TOL = 1e-3 + 1e-6


def tool_lines(main, argv):
    """(the lines ``main(argv)`` prints, echoed; what it returns)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    print(buf.getvalue(), end="")
    return buf.getvalue().splitlines(), out


def scale_reference(dev) -> dict:
    """{chain id: (14 L, 3) coordinates} of the default set, drawn again
    and built in float64 by the plain path on the card."""
    rng = np.random.default_rng(SCALE_SEED)
    rotamers = gen_scale_data._aa_rotamers(rng)
    want = {}
    for _, n, prefix in SCALE_SPLITS:
        lengths, _, ids, angs = gen_scale_data.draw_split(
            rng, n, *SCALE_LENGTHS, rotamers)
        width = int(lengths.max())
        ids_pad = np.full((n, width), VOCAB.pad_id, np.int64)
        ang_pad = np.zeros((n, width, 12))
        for i, (seq_ids, ang) in enumerate(zip(ids, angs)):
            ids_pad[i, :len(seq_ids)] = seq_ids
            ang_pad[i, :len(seq_ids)] = ang
        with torch.no_grad():
            crd = build_coords_batch(torch.from_numpy(ang_pad).to(dev),
                                     torch.from_numpy(ids_pad).to(dev),
                                     sidechain_impl="torch").cpu().numpy()
        for i, length in enumerate(lengths):
            want[f"{prefix}{i:04d}_1_A"] = crd[i, :length].reshape(-1, 3)
    return want


def scale_generate(dev, card, out_dir):
    """(a): the generator on the card against a float64 plain build and
    against its own CPU run. Returns the card's dataset directory and its
    launches."""
    on_card, on_cpu = (os.path.join(out_dir, f"scale-{d}")
                       for d in ("cuda", "cpu"))
    reset_launches()
    t0 = time.perf_counter()
    tool_lines(gen_scale_data.main, ["--out", on_card])
    seconds = time.perf_counter() - t0
    launches = read_launches()
    require(launches == launched(sidechain_fwd=len(SCALE_SPLITS)),
            f"gen_scale_data launches {launches}: K2a once a chunk")
    t0 = time.perf_counter()
    tool_lines(gen_scale_data.main, ["--out", on_cpu, "--device", "cpu"])
    cpu_seconds = time.perf_counter() - t0
    got, cpu = load_dataset(on_card), load_dataset(on_cpu)
    want = scale_reference(dev)
    worst = 0.0
    for split, n, _ in SCALE_SPLITS:
        g, c = got[split], cpu[split]
        require(len(g["ids"]) == n and g["ids"] == c["ids"]
                and g["seq"] == c["seq"]
                and all(np.array_equal(a, b)
                        for a, b in zip(g["ang"], c["ang"])),
                f"{split}: the card's ids, sequences and angles are the "
                "CPU run's")
        for pid, crd in zip(g["ids"], g["crd"]):
            require(crd.shape == want[pid].shape, f"{pid}: its atoms")
            worst = max(worst, float(np.abs(crd - want[pid]).max()))
    require(worst <= SCALE_COORD_TOL,
            f"gen_scale_data on the card: coordinates {worst:.2e} A from a "
            f"float64 plain build, at most {SCALE_COORD_TOL}")
    n_res = sum(len(s) for split, _, _ in SCALE_SPLITS
                for s in got[split]["seq"])
    print(f"[scale-data] (a) gen_scale_data at the JAX defaults "
          f"({'/'.join(str(n) for _, n, _ in SCALE_SPLITS)} chains, "
          f"{n_res} residues): {seconds:.1f} s on the card, {cpu_seconds:.1f}"
          f" s with --device cpu; the same ids, sequences and angles; "
          f"coordinates within {worst:.2e} A of a float64 plain build; "
          f"launches {json.dumps(launches)} ({card})")
    return on_card, launches


def scale_oracle(dev, card):
    """(b): the oracle floor at its defaults on the card against the
    plain CPU path and the JAX tool's line. Returns (its mean, launches)."""
    reset_launches()
    t0 = time.perf_counter()
    lines, vals = tool_lines(oracle_floor.main, [])
    seconds = time.perf_counter() - t0
    launches = read_launches()
    require(launches == launched(drmsd_fwd=1, sidechain_fwd=1),
            f"oracle_floor launches {launches}: K2a and K1a once")
    plain = oracle_floor.floor_values(ORACLE_CHAINS, ORACLE_LENGTH,
                                      SCALE_SEED, torch.device("cpu"))
    apart = float(np.abs(vals - plain).max())
    require(apart <= 1e-3, f"oracle_floor: each chain's dRMSD within 1e-3 "
                           f"A of the plain CPU path's ({apart:.2e})")
    stats = (np.mean(vals), np.median(vals), np.min(vals), np.max(vals))
    require(all(abs(a - b) <= FLOOR_TOL for a, b in zip(stats, ORACLE_FLOOR))
            and lines == [oracle_floor.summary_line(vals, ORACLE_CHAINS,
                                                    ORACLE_LENGTH)],
            f"oracle_floor: {stats} within {FLOOR_TOL} A of the JAX tool's "
            f"{ORACLE_FLOOR}")
    print(f"[scale-data] (b) oracle_floor at its defaults: mean "
          f"{stats[0]:.4f}, median {stats[1]:.4f}, min {stats[2]:.4f}, max "
          f"{stats[3]:.4f} A (the JAX tool: {ORACLE_FLOOR}); each chain "
          f"within {apart:.2e} A of the plain CPU path; {seconds:.2f} s; "
          f"launches {json.dumps(launches)} ({card})")
    return float(stats[0]), launches


def scale_stress(card, out_dir):
    """(c): stress_pipeline at two sizes, 4x apart, on the card."""
    rows = {}
    for n in STRESS_SIZES:
        lines, _ = tool_lines(stress_pipeline.main, [
            "--n_train", str(n), "--out", os.path.join(out_dir,
                                                       f"stress-{n}")])
        got = [json.loads(ln) for ln in lines if ln.startswith("{")]
        require([r["stage"] for r in got] == list(STRESS_STAGES),
                f"stress_pipeline at {n}: a line for every stage")
        rows[n] = {r["stage"]: r for r in got}
        plan, coll = rows[n]["plan"], rows[n]["collate"]
        require(rows[n]["split"]["n_train"] == n
                and plan["batches"] == coll["batches"] > 0
                and plan["proteins"] == coll["proteins"] > 0,
                f"stress_pipeline at {n}: plan and collate count every "
                f"protein the sampler draws ({plan}, {coll})")
    small, big = (rows[n] for n in STRESS_SIZES)
    ratio = STRESS_SIZES[1] // STRESS_SIZES[0]
    for name in STRESS_STAGES:
        a, b = small[name]["seconds"], big[name]["seconds"]
        require(b <= 2 * ratio * a + 1.0,
                f"stress stage {name}: {b} s at {STRESS_SIZES[1]} chains "
                f"against {a} s at {STRESS_SIZES[0]}, at most "
                f"{2 * ratio}x + 1 s")
    print(f"[scale-data] (c) stress_pipeline s a stage at "
          f"{STRESS_SIZES[0]} / {STRESS_SIZES[1]} training chains: "
          + ", ".join(f"{name} {small[name]['seconds']} / "
                      f"{big[name]['seconds']}" for name in STRESS_STAGES)
          + f"; store {big['store']['store_nbytes']} bytes at "
          f"{STRESS_SIZES[1]} ({card})")


def scale_convergence(dev, card, data_dir, out_dir, floor):
    """(d): c4's recipe through the CLI on (a)'s set for 12 epochs."""
    argv = ["--data", data_dir, "--name", "scale", "--out_dir", out_dir,
            *CONVERGENCE_ARGS, "-e", str(CONVERGENCE_EPOCHS)]
    dm = DataModule(load_dataset(data_dir), cli.config_from_args(argv))
    eval_steps = {s: len(list(dm.eval_index_batches(s)))
                  for s in dm.eval_splits}
    require(set(eval_steps) == {"valid-70", "test"}, "valid-70 and test")
    reset_launches()
    t0 = time.perf_counter()
    with timed_train_epochs() as epochs:
        run_cli(argv)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    steps = sum(n for _, n, _ in epochs)
    n_eval = CONVERGENCE_EPOCHS * eval_steps["valid-70"] + eval_steps["test"]
    expected = launched(drmsd_fwd=2 * n_eval, drmsd_fwd_grad=2 * steps,
                        sidechain_fwd=steps + n_eval, sidechain_bwd=steps,
                        kabsch_rmsd=n_eval,
                        adam_update=ADAM_LAUNCHES * steps)
    require(len(epochs) == CONVERGENCE_EPOCHS and launches == expected,
            f"convergence launches {launches}: expected {expected} for "
            f"{len(epochs)} epochs of {steps} train steps in all and "
            f"{n_eval} eval steps (K1a, K1b, K2a, K2b, K5 and K6 each "
            f"launched)")
    _, rows = csv_rows(os.path.join(out_dir, "scale", "scale.train"))
    by_mode = {mode: [r for r in rows if r["mode"] == mode
                      and r["granularity"] == "epoch"]
               for mode in ("train", "valid-70")}
    require(all(len(v) == CONVERGENCE_EPOCHS for v in by_mode.values()),
            "an epoch row of train and valid-70 every epoch")
    rmse = [float(r["rmse"]) for r in by_mode["valid-70"]]
    drmsd = [float(r["drmsd"]) for r in by_mode["valid-70"]]
    train_rmse = [float(r["rmse"]) for r in by_mode["train"]]
    print("[scale-data] (d) epoch: train RMSE, valid-70 RMSE, valid-70 "
          "dRMSD (A): " + "; ".join(
              f"{e}: {t:.4f}, {v:.4f}, {d:.2f}"
              for e, (t, v, d) in enumerate(zip(train_rmse, rmse, drmsd))))
    require(np.isfinite(rmse + drmsd + train_rmse).all()
            and rmse[-1] <= CONVERGENCE_RMSE
            and rmse[-1] <= CONVERGENCE_SHARE * rmse[0],
            f"convergence: valid-70 angle RMSE {rmse[0]:.4f} -> "
            f"{rmse[-1]:.4f} after {CONVERGENCE_EPOCHS} epochs; at most "
            f"{CONVERGENCE_RMSE} and {CONVERGENCE_SHARE} of epoch 0's")
    print(f"[scale-data] (d) c4's recipe ({' '.join(CONVERGENCE_ARGS)}) for "
          f"{CONVERGENCE_EPOCHS} epochs, {steps} train steps: valid-70 RMSE "
          f"{rmse[0]:.4f} -> {rmse[-1]:.4f} (c4: 0.545 -> ~0.16 by epoch "
          f"11), valid-70 dRMSD {drmsd[0]:.2f} -> {drmsd[-1]:.2f} A (best "
          f"{min(drmsd):.2f}) beside the oracle floor's mean "
          f"{floor:.2f} A; {seconds:.1f} s; launches {json.dumps(launches)}"
          f" ({card})")
    return launches


def scale_dev_data(card, out_dir):
    """(e): gen_dev_data on the card against examples/dev_data."""
    where = os.path.join(out_dir, "dev-data")
    reset_launches()
    t0 = time.perf_counter()
    tool_lines(gen_dev_data.main, ["--out", where])
    seconds = time.perf_counter() - t0
    launches = read_launches()
    require(launches == launched(sidechain_fwd=16),
            f"gen_dev_data launches {launches}: K2a once a chain")
    err = gen_dev_data.diff_from(DEV_DATA, where)
    require(err["max_coord_err"] <= DEV_COORD_TOL
            and err["max_angle_mse"] <= ANGLE_MSE,
            f"gen_dev_data on the card against examples/dev_data: {err}; "
            f"coordinates within {DEV_COORD_TOL} A, per-angle MSE at most "
            f"{ANGLE_MSE}")
    print(f"[scale-data] (e) gen_dev_data on the card: the same ids, "
          f"sequences, helix lists and missing entries as examples/dev_data"
          f"; coordinates within {err['max_coord_err']:.2e} A, per-angle MSE"
          f" {err['max_angle_mse']:.2e} rad^2; {seconds:.2f} s; launches "
          f"{json.dumps(launches)} ({card})")
    return launches


def phase_scale_data(dev, card, out_dir):
    """Phase 19: the four scale-data tools on the card and a convergence
    run on the generated set. Returns the launches of the whole phase."""
    t0 = time.perf_counter()
    data_dir, gen = scale_generate(dev, card, out_dir)
    floor, oracle = scale_oracle(dev, card)
    scale_stress(card, out_dir)
    train = scale_convergence(dev, card, data_dir, out_dir, floor)
    dev_data = scale_dev_data(card, out_dir)
    parts = (gen, oracle, train, dev_data)
    print(f"[scale-data] phase 19 in {time.perf_counter() - t0:.1f} s "
          f"({card})")
    return {k: sum(p[k] for p in parts) for k in COUNTERS}


# ---------------------------------------------------------------- phase 20
LADDER_STEPS = 30
# the ladder runs of (a): (config, dtype)
LADDER_RUNS = tuple((idx, "float32") for idx in sorted(bench_ladder.LADDER)
                    ) + ((5, "bfloat16"),)
LADDER_TRACED = (4, 5)
TRACE_STEPS = 3
# the share of device events that must link to the operation that launched
# them, and the most of the device time that may fall in analyze_trace's
# catch-all "other" (each event falls in exactly one category, so the
# categories sum to the device total by construction)
LINKED_SHARE = 0.99
OTHER_SHARE = 0.05
# bench_attention's op level: the flash gates of PERF.md section 2; the eval
# level's packed metrics (A: dRMSD, RMSD; the angle losses) xla vs flash:
# phase 9's coordinate tolerance
OP_FWD_TOL = 2e-5
OP_GRAD_TOL = 1e-4
EVAL_METRICS_TOL = 2e-2
# the levels' paired windows, shorter than the tool's (20 calls, six
# repeats): its eval level takes ~2 minutes at B = 32
ATTENTION_WINDOW = dict(calls=5, repeats=3)


def ladder_launches(spec) -> dict:
    """K1b, K2a, K2b and K6 launches a train step of a ladder entry, as its
    loss's code path calls them: K6's two (the entries clip at 1.0) under
    every loss; for a dRMSD-family loss also one sidechain build and its
    backward, and K1b over the backbone and over all atoms, or over the
    backbone alone under --backbone_loss."""
    if spec["loss"] == "mse":
        return launched(adam_update=ADAM_LAUNCHES)
    return launched(drmsd_fwd_grad=1 if spec["backbone_loss"] else 2,
                    sidechain_fwd=1, sidechain_bwd=1,
                    adam_update=ADAM_LAUNCHES)


def ladder_runs(dev, card) -> dict:
    """(a): every ladder entry through bench_ladder.bench_config; returns
    the launches of all the runs."""
    total = launched()
    for idx, dtype in LADDER_RUNS:
        reset_launches()
        line = bench_ladder.bench_config(idx, LADDER_STEPS, dtype, device=dev)
        launches = read_launches()
        per_step = ladder_launches(bench_ladder.LADDER[idx])
        require(launches == {k: v * line["steps_run"]
                             for k, v in per_step.items()},
                f"ladder config {idx} ({dtype}): launches {launches} over "
                f"{line['steps_run']} steps, expected {per_step} a step")
        # the MFU key as the JAX tool rounds it (config 1's is 0.0)
        require(np.isfinite(line["loss_value"]) and line["mfu"] is not None
                and line["device_ms"] > 0 and line["card"] == card,
                f"ladder config {idx} ({dtype}): a finite loss, the MFU, "
                f"device ms and the card: {line}")
        a_step = {k: v for k, v in per_step.items() if v}
        print(f"[ladder] {json.dumps({**line, 'launches_a_step': a_step})}")
        for k, v in launches.items():
            total[k] += v
    return total


def ladder_probe(card) -> None:
    """(b): config 5's frontier, probed in its subprocess."""
    t0 = time.perf_counter()
    maxb, b = bench_ladder.probe_batch(5, "float32", 1)
    seconds = time.perf_counter() - t0
    require(b >= 1 and b <= 0.8 * maxb, f"probe: MAXB={maxb}, batch {b}")
    print(f"[ladder] config 5 (fp32) --probe-only in its subprocess: "
          f"MAXB={maxb} proteins of L=500, 0.8x on the collate lattice -> "
          f"B={b}; {seconds:.1f} s ({card})")


def ladder_traces(dev, card, out_dir) -> dict:
    """(c): trace_ladder of configs 4 and 5, analyze_trace --by source of
    each; returns the launches of the traced runs."""
    total = launched()
    for idx in LADDER_TRACED:
        logdir = os.path.join(out_dir, f"trace-ladder-{idx}")
        reset_launches()
        lines, _ = tool_lines(trace_ladder.main, [
            "--config", str(idx), "--dtype", "float32", "--steps",
            str(TRACE_STEPS), "--logdir", logdir])
        launches = read_launches()
        traces = sum(ln.startswith("the trace of") for ln in lines) + 1
        _, res = tool_lines(analyze_trace.main, [
            logdir, "--by", "source", "--steps", str(TRACE_STEPS)])
        cats = res["categories"]
        per_step = ladder_launches(bench_ladder.LADDER[idx])
        for name, n in per_step.items():
            # K6 is filed by its launch site, under "optimizer"
            if not n or name == "adam_update":
                continue
            cat = next(c for c, _ in analyze_trace.HAND_KERNELS
                       if c.endswith(" " + name))
            require(cats[cat]["count"] == n,
                    f"trace of config {idx}: {cat} {cats[cat]['count']} "
                    f"device events a step, launched {n} a step")
        if per_step["drmsd_fwd_grad"]:
            require(cats["k1_epilogue_kernel"]["count"]
                    == per_step["drmsd_fwd_grad"],
                    f"trace of config {idx}: one K1 epilogue a K1b call")
        require(cats["other"]["ms"] <= OTHER_SHARE * res["total_ms"]
                and res["linked_share"] >= LINKED_SHARE,
                f"trace of config {idx}: {cats['other']['ms']:.4f} of "
                f"{res['total_ms']:.4f} device ms in 'other' (at most "
                f"{OTHER_SHARE}); {res['linked_share']} of the events linked")
        print(f"[ladder] trace of config {idx} (fp32, {TRACE_STEPS} steps, "
              f"{traces} trace(s) taken): {res['total_ms']:.3f} device ms a "
              f"step in {res['device_events']:.0f} events, idle share "
              f"{res['idle_share']:.4f}; by category " + json.dumps(
                  {c: round(r["ms"], 4) for c, r in cats.items()
                   if r["count"]}) + f" ({card})")
        for k, v in launches.items():
            total[k] += v
    return total


def attention_levels(dev, card) -> dict:
    """(d): bench_attention's op and eval levels; returns their
    launches."""
    reset_launches()
    for row in bench_attention.bench_op(dev, **ATTENTION_WINDOW):
        gate = OP_GRAD_TOL * max(1.0, row["grad_max_abs"])
        require(row["fwd_max_abs_diff"] <= OP_FWD_TOL
                and row["grad_max_abs_diff"] <= gate,
                f"op level {row}: forward within {OP_FWD_TOL} on valid rows,"
                f" gradients within {gate:.3e}")
        print(f"[attention-op] {json.dumps({**row, 'card': card})}")
    op = read_launches()
    require(op["flash_attn_fwd"] > 0 and op["flash_attn_bwd"] > 0,
            f"the op level launched K3a and the flash backward: {op}")
    reset_launches()
    for b in bench_attention.EVAL_BATCHES:
        res = bench_attention.bench_eval_step(dev, b, **ATTENTION_WINDOW)
        require(res["metrics_max_abs_diff"] <= EVAL_METRICS_TOL
                and all(np.isfinite(v)
                        for v in res["metrics_flash"].values()),
                f"eval level at B={b}: packed metrics of xla and flash "
                f"within {EVAL_METRICS_TOL}: {res}")
        print(f"[attention-eval] {json.dumps({**res, 'card': card})}")
    ev = read_launches()
    require(ev["flash_attn_fwd"] > 0 and ev["drmsd_fwd"] > 0
            and ev["sidechain_fwd"] > 0,
            f"the eval level launched K3a, K1a and K2a: {ev}")
    return {k: op[k] + ev[k] for k in COUNTERS}


def ladder_scripts(card, out_dir) -> None:
    """(e): the six scripts on examples/dev_data, phase 14's runs and
    phase 9's predictions."""
    data = load_dataset(DEV_DATA)
    means_path = os.path.join(out_dir, "dev_means.npy")
    tool_lines(compute_dataset_angle_means.main, [DEV_DATA, means_path])
    want = np.nanmean(np.concatenate(
        [np.asarray(a, np.float32) for a in data["train"]["ang"]]), axis=0)
    require(np.array_equal(np.load(means_path), want),
            "compute_dataset_angle_means: the nanmean of the train angles")
    small = os.path.join(out_dir, "dev_small")
    tool_lines(downsample_dataset.main, [DEV_DATA, small, "--n", "2"])
    got = load_dataset(small)
    require(all(len(got[s]["ids"]) == min(2, len(data[s]["ids"]))
                and set(got[s]["ids"]) <= set(data[s]["ids"])
                for s in data if isinstance(data[s], dict) and "seq" in data[s]),
            "downsample_dataset: two items of each split")
    ids_file = os.path.join(out_dir, "dev_ids.txt")
    wanted = data["train"]["ids"][:2]
    with open(ids_file, "w") as f:
        f.write("\n".join(wanted) + "\n")
    dev_dir = os.path.join(out_dir, "dev_dev")
    tool_lines(create_development_datasets.main, [DEV_DATA, ids_file,
                                                   dev_dir])
    got = load_dataset(dev_dir)
    require(got["train"]["ids"] == got["test"]["ids"] == wanted,
            "create_development_datasets: the two ids in every split")
    lines, results = tool_lines(group_predictions.main, [
        os.path.join(out_dir, "preds_flash"), "--out",
        os.path.join(out_dir, "grouped")])
    require(len(results) == 16 and lines[-1].startswith("16 pairs"),
            f"group_predictions: phase 9's 16 pairs ({lines[-1]})")
    runs = [os.path.join(out_dir, f"dev-{flag}") for flag in ("true",
                                                              "false")]
    lines, _ = tool_lines(analyze.main, [*runs, "--mode", "valid-70"])
    require(len(lines) == 3, "analyze: a header and a line a run")
    lines, code = tool_lines(plot.main, [
        os.path.join(runs[0], "dev-true.train"), "--metric", "rmse",
        "--out", os.path.join(out_dir, "dev.png")])
    require(code == 0 and lines, "plot: a figure or a text summary")
    print(f"[ladder] the six scripts on examples/dev_data, phase 14's runs "
          f"and phase 9's predictions: RMSD of the 16 pairs from "
          f"{results[0][1]:.2f} to {results[-1][1]:.2f} A ({card})")


def phase_ladder(dev, card, out_dir) -> dict:
    """Phase 20; returns the launches of its ladder runs, traces and
    attention levels."""
    t0 = time.perf_counter()
    parts = [ladder_runs(dev, card)]
    ladder_probe(card)
    parts.append(ladder_traces(dev, card, out_dir))
    parts.append(attention_levels(dev, card))
    ladder_scripts(card, out_dir)
    print(f"[ladder] phase 20 in {time.perf_counter() - t0:.1f} s ({card})")
    return {k: sum(p[k] for p in parts) for k in COUNTERS}


BENCH_STEPS = 30
BENCH_MODES = ("raw", "trainer", "eval")
BENCH_TIMEOUT = 300  # seconds a bench process may take, start-up included
# the reference's positional-encoding buffer: a checkpoint entry that no
# module of the port owns, which the import must pass over
REFERENCE_PE = "encoder.pos_enc.pe"


def reference_checkpoint(dev, card, out_dir) -> None:
    """(a): a reference-style .chkpt of the flagship from seeded weights
    into a fresh model on the card; the same forward bits on a flagship
    batch."""
    cfg = flagship("all", out_dir)
    am = np.random.default_rng(0).uniform(-0.5, 0.5, 24).astype(np.float32)
    source = make_model(cfg, am)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in source.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    names = reference_names(source)
    sd = {names[k]: v.detach().clone() for k, v in source.named_parameters()}
    sd[REFERENCE_PE] = torch.zeros(1, cfg.max_seq_len, cfg.d_model)
    path = os.path.join(out_dir, "flagship.chkpt")
    t0 = time.perf_counter()
    torch.save({"model_state_dict": sd, "optimizer_state_dict": {},
                "epoch": 0}, path)
    fresh = load_reference_checkpoint(path, make_model(cfg, am).to(dev))
    seconds = time.perf_counter() - t0
    source = source.to(dev).eval()
    require(all(torch.equal(a, b) for a, b in zip(
        source.parameters(), fresh.parameters())),
            "the loaded parameters are the checkpoint's, bit for bit")
    data = make_dataset(n_train=8, n_eval=2, min_len=255, max_len=256,
                        seed=0)
    batch = collate(DataModule(data, cfg).train, np.arange(8),
                    cfg.bucket_sizes, 256)
    ids = torch.as_tensor(batch.seq).to(dev)
    with torch.no_grad():
        want, got = source(ids), fresh.eval()(ids)
    require(got.shape == (8, 256, 24) and bool(torch.isfinite(got).all())
            and torch.equal(got, want),
            "the loaded flagship's forward equals the source model's bit "
            "for bit")
    print(f"[bench] reference checkpoint of the flagship (conv-enc d_model "
          f"512, 6 layers, {len(names)} tensors and the PE buffer, "
          f"{os.path.getsize(path) / 1e6:.1f} MB) written and loaded onto "
          f"the card in {seconds:.2f} s: forward on B=8 x L=256 equal bit "
          f"for bit ({card})")


def bench_child(out_dir: str) -> int:
    """One bench process of phase 21, started as ``chip_smoke.py
    --bench-child DIR`` with BENCH_MODE and BENCH_STEPS set: ``bench.main``
    on the card, then its kernel launches, its steps and what it computed
    (the headline's first loss, the eval step's metrics) into
    DIR/bench-<mode>.json."""
    reset_launches()
    result = bench.main([])
    mode = os.environ.get("BENCH_MODE", "raw")
    values = ([result["first_loss"]] if "first_loss" in result else
              result["metrics"].tolist() if "metrics" in result else [])
    with open(os.path.join(out_dir, f"bench-{mode}.json"), "w") as f:
        json.dump({"launches": read_launches(),
                   "steps_run": result["steps_run"], "values": values}, f)
    return 0


def bench_launches(mode: str, steps: int) -> dict:
    """The launches of ``steps`` steps of a bench mode: a combined-loss
    train step K1b and K6 twice, K2a and K2b once; the trainer loop K2a
    once more for each structure it logs (train every log_structure_step
    steps, each validation split every log_val_struct_step); an eval step
    K1a twice, K2a and K5 once."""
    if mode == "eval":
        return launched(drmsd_fwd=2 * steps, sidechain_fwd=steps,
                        kabsch_rmsd=steps)
    logged = 0
    if mode == "trainer":
        cfg = TrainConfig()
        logged = sum(1 for s in range(steps)
                     if s % cfg.log_structure_step == 0) + len(
            VALID_SPLITS) * sum(1 for s in range(steps)
                                if s % cfg.log_val_struct_step == 0)
    return launched(drmsd_fwd_grad=2 * steps, sidechain_fwd=steps + logged,
                    sidechain_bwd=steps, adam_update=ADAM_LAUNCHES * steps)


def bench_modes(card, out_dir) -> dict:
    """(b): the three modes at full width, each in a process of its own;
    returns their launches."""
    total = launched()
    for mode in BENCH_MODES:
        env = dict(os.environ, BENCH_MODE=mode, BENCH_STEPS=str(BENCH_STEPS))
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--bench-child",
                 out_dir], cwd=ROOT, env=env, capture_output=True,
                text=True, timeout=BENCH_TIMEOUT)
        except subprocess.TimeoutExpired:
            require(False, f"bench mode {mode} finished within "
                           f"{BENCH_TIMEOUT} s")
        require(proc.returncode == 0, f"bench mode {mode} exited with "
                f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        with open(os.path.join(out_dir, f"bench-{mode}.json")) as f:
            child = json.load(f)
        want = bench_launches(mode, child["steps_run"])
        require(set(line) == {"metric", "value", "unit", "vs_baseline"}
                and np.isfinite(line["value"]) and line["value"] > 0,
                f"bench mode {mode}: a finite positive value: {line}")
        require(f"# card: {card}" in proc.stderr,
                f"bench mode {mode} names the card: {proc.stderr[-2000:]}")
        require(np.isfinite(child["values"]).all()
                and len(child["values"]) == {"raw": 1, "trainer": 0}.get(
                    mode, len(METRIC_KEYS)),
                f"bench mode {mode}: finite outputs {child['values']}")
        require(child["launches"] == want,
                f"bench mode {mode}: launches {child['launches']} over "
                f"{child['steps_run']} steps, expected {want}")
        for ln in proc.stderr.splitlines():
            if ln.startswith("# "):
                print(f"[bench] {mode} {ln}")
        a_run = {k: v for k, v in child["launches"].items() if v}
        print(f"[bench] {mode}: {json.dumps(line)}; {child['steps_run']} "
              f"steps, launches {json.dumps(a_run)} ({card})")
        for k, v in child["launches"].items():
            total[k] += v
    return total


def bench_protocol_runs(card) -> None:
    """(c): the protocol at --runs 2 in raw mode; the kernels are built, so
    run 1 (and run 0) is warm."""
    lines, out = tool_lines(bench_protocol.main, [
        "--runs", "2", "--steps", str(BENCH_STEPS), "--per_run_timeout",
        str(BENCH_TIMEOUT)])
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    runs = [r for r in rows if "run" in r]
    require(not any("event" in r for r in rows),
            f"the protocol's runs each passed at their first attempt: {rows}")
    require(len(runs) == 2 and runs[1]["cold"] is False
            and out["metric"] == "p50_ms" and np.isfinite(out["median"])
            and out["median"] > 0 and len(out["spread"]) == 2,
            f"the protocol: a warm run 1, its median and spread: {out}")
    print(f"[bench] protocol --runs 2 (raw): {json.dumps(out)} ({card})")


def phase_bench(dev, card, out_dir) -> dict:
    """Phase 21; returns the launches of the bench modes' processes."""
    t0 = time.perf_counter()
    reference_checkpoint(dev, card, out_dir)
    launches = bench_modes(card, out_dir)
    bench_protocol_runs(card)
    print(f"[bench] phase 21 in {time.perf_counter() - t0:.1f} s ({card})")
    return launches


def print_mfu(card, fp32_step, bf16_step) -> None:
    """MFU of phase 6's fp32 and phase 16's bf16 flagship train steps
    against the card's bf16 dense peak (training/flops.py), by wall time
    and by device time; for information, no gate."""
    cfg, (bsz, length), *_ = fp32_step
    peak = flops.peak_flops_per_chip(torch.cuda.get_device_name(0))
    parts = []
    for label, step_cfg, ms, dev_ms in (
            ("fp32 (phase 6)", cfg, *fp32_step[2:]),
            ("bf16 (phase 16)", *bf16_step)):
        work = flops.train_step_flops(step_cfg, bsz, length)
        parts.append(f"{label} {work / 1e12:.3f} TFLOP a step, {ms:.2f} ms "
                     f"-> MFU {work / (ms * 1e-3 * peak):.4f}, "
                     f"{dev_ms:.2f} device ms -> "
                     f"{work / (dev_ms * 1e-3 * peak):.4f}")
    print(f"[mfu] flagship train step, B={bsz} x L={length}: "
          + "; ".join(parts) + f"; against the bf16 dense peak "
          f"{peak / 1e12:.1f} TFLOP/s of {torch.cuda.get_device_name(0)} "
          f"({card})")


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--rank-child":
        return rank_child(sys.argv[2], sys.argv[3:])
    if len(sys.argv) > 2 and sys.argv[1] == "--bench-child":
        return bench_child(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this smoke run "
              "needs one GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def timed(fn, *args):
        """fn(*args), with a line giving the seconds it took."""
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[time] {fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    dev, card = timed(phase_device)
    resources = timed(phase_build)
    table, structured, path_k1_errs = timed(phase_kernel, dev, card)
    variant_table, variant_errs, bench_launches = timed(phase_variants, dev,
                                                        card)
    sc_table, sc_errs = timed(phase_sidechain_kernel, dev, card)
    k5_table = timed(phase_kabsch_kernel, card)
    k6_row = timed(phase_adam_kernel, dev, card)
    attn_table = timed(phase_attention_kernel, dev, card)
    bf16_table = timed(phase_bf16_kernels, dev, card)
    timed(phase_goldens, dev)
    with tempfile.TemporaryDirectory() as out_dir:
        eval_launches = timed(phase_slice, dev, card, out_dir)
        train_launches, fp32_step = timed(phase_train, dev, card, out_dir)
        cli_launches = timed(phase_cli, dev, card, out_dir)
        predict_launches = timed(phase_predict, dev, card, out_dir)
        flash_launches = timed(phase_flash_train, dev, card, out_dir)
        enc_dec_launches, sampled_launches = timed(
            phase_enc_dec, dev, card, out_dir)
        timed(phase_data_path, dev, card, out_dir)
        timed(phase_dev_data, dev, card, out_dir)
        timed(phase_tools, dev, card, out_dir)
        bf16_flash_launches, bf16_predict_launches, bf16_step = timed(
            phase_bf16, dev, card, out_dir)
        print_mfu(card, fp32_step, bf16_step)
        probe_launches = timed(phase_wandb, dev, card, out_dir)
        rebuild_launches = timed(phase_data_tools, dev, card, out_dir)
        multi_gpu_launches = timed(phase_multi_gpu, dev, card, out_dir)
        scale_launches = timed(phase_scale_data, dev, card, out_dir)
        ladder_launches_all = timed(phase_ladder, dev, card, out_dir)
        bench_launches_all = timed(phase_bench, dev, card, out_dir)
    source = "protein_transformer_tpu_torch/csrc/"
    replaces = "protein_transformer_tpu/ops/"
    rows = []
    for name, src, line, case, launches in (
            ("drmsd_fwd", "drmsd_fwd.cu", 56, EVAL_CASE,
             eval_launches["drmsd_fwd"]),
            ("drmsd_fwd_grad", "drmsd_train.cu", 151, TRAIN_CASE,
             train_launches["drmsd_fwd_grad"]),
            ("drmsd_grad_b", "drmsd_train.cu", 87, TRAIN_CASE,
             train_launches["drmsd_grad_b"])):
        _, k_ms, p_ms, b_ms, b_by, d_ms = table[case][name]
        _, s_ms, s_plain, s_bound, s_by, s_dev = structured[case][name]
        rows.append({"name": name, "route": "cuda", "source": source + src,
                     "replaces": f"{replaces}drmsd_pallas.py:{line}",
                     "launches": launches,
                     "max_abs_err": max(path_k1_errs[name], *(
                         t[name][0] for t in [*table.values(),
                                              *structured.values()])),
                     "ms": k_ms, "device_ms": d_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     "structured_masks": {
                         "ms": s_ms, "device_ms": s_dev, "plain_ms": s_plain,
                         "bound_ms": s_bound, "bound_by": s_by}})
    for name, line in (("sidechain_fwd", 104), ("sidechain_bwd", 136)):
        k_ms, p_ms, b_ms, b_by, d_ms = sc_table[SIDECHAIN_TRAIN_CASE][name]
        rows.append({"name": name, "route": "cuda",
                     "source": source + "sidechain.cu",
                     "replaces": f"{replaces}sidechain_pallas.py:{line}",
                     # the enc-dec steps run K2a and K2b too: their count here
                     "launches": enc_dec_launches[name],
                     "launches_conv_enc_cli": cli_launches[name],
                     "max_abs_err": sc_errs[name], "ms": k_ms,
                     "device_ms": d_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
    flash = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    for name, line, case, launches, kernels in (
            ("flash_attn_fwd", 331, ATTENTION_PREDICT_CASE,
             predict_launches["flash_attn_fwd"], attn_table),
            # the backward replaces the dK/dV and the dQ bodies together
            ("flash_attn_bwd", 796, ATTENTION_TRAIN_CASE,
             flash_launches["flash_attn_bwd"], attn_table),
            ("flash_attn_bwd", 1146, ATTENTION_TRAIN_CASE,
             flash_launches["flash_attn_bwd"], attn_table),
            # the bf16 instances of the same TPU kernels
            ("flash_attn_fwd_bf16", 331, ATTENTION_PREDICT_CASE,
             bf16_predict_launches["flash_attn_fwd_bf16"], bf16_table),
            ("flash_attn_bwd_bf16", 796, ATTENTION_TRAIN_CASE,
             bf16_flash_launches["flash_attn_bwd_bf16"], bf16_table),
            ("flash_attn_bwd_bf16", 1146, ATTENTION_TRAIN_CASE,
             bf16_flash_launches["flash_attn_bwd_bf16"], bf16_table)):
        _, k_ms, p_ms, b_ms, b_by, lib_ms, d_ms, lib_d_ms = \
            kernels[case][name]
        rows.append({"name": name, "route": "cuda",
                     "source": source + "attention.cu",
                     "replaces": f"{flash}:{line}",
                     "reached_from": f"{replaces}attention.py:63",
                     "launches": launches,
                     "max_abs_err": max(t[name][0]
                                        for t in kernels.values()),
                     "ms": k_ms, "device_ms": d_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms, "library_device_ms": lib_d_ms})
        if name.endswith("_bf16"):  # ptxas -v, each head dimension
            rows[-1]["ptxas"] = {
                str(dim): dict(zip(("registers", "spill_stores",
                                    "spill_loads"), res))
                for (kernel, dim), res in sorted(resources.items())
                if kernel == name + "_kernel"}
    k5 = k5_table[K5_CASE]
    rows.append({"name": "kabsch_rmsd", "route": "cuda",
                 "source": source + "kabsch.cu",
                 # no TPU kernel: the JAX package's SVD is XLA's
                 "replaces": None,
                 "reached_from": "protein_transformer_tpu/losses.py:254",
                 "launches": eval_launches["kabsch_rmsd"],
                 "max_abs_err": max(k5_table[f"{b}x{n}"]["cuda"]["gap_fp64"]
                                    ["abs"] for b, n in bench_kabsch.SHAPES),
                 "max_rel_err": max(k5_table[f"{b}x{n}"]["cuda"]["gap_fp64"]
                                    ["rel"] for b, n in bench_kabsch.SHAPES),
                 "ms": k5["cuda"]["ms"], "device_ms": k5["cuda"]["device_ms"],
                 "plain_ms": k5["torch"]["ms"],
                 "plain_device_ms": k5["torch"]["device_ms"],
                 "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
                 "library_ms": None})
    rows.append({"name": "adam_update", "route": "cuda",
                 "source": source + "adam.cu",
                 # no TPU kernel: the JAX package's optimizer is optax's
                 # chain, which XLA fuses
                 "replaces": None,
                 "reached_from":
                     "protein_transformer_tpu/training/optim.py:38",
                 "launches": train_launches["adam_update"],
                 "max_abs_err": k6_row["max_abs_err"],
                 "max_rel_err": k6_row["max_rel_err"],
                 "ms": k6_row["cuda"]["ms"],
                 "device_ms": k6_row["cuda"]["device_ms"],
                 "plain_ms": k6_row["torch"]["ms"],
                 "plain_device_ms": k6_row["torch"]["device_ms"],
                 "bound_ms": k6_row["bound_ms"],
                 "bound_by": k6_row["bound_by"], "library_ms": None})
    # no one PyTorch call computes a masked pair statistic: no library time
    for name, line in (("drmsd_fwd_sqrt1", 42), ("drmsd_fwd_mxu", 84),
                       ("drmsd_grad_a_mxu", 105)):
        k_ms, p_ms, b_ms, b_by, d_ms = variant_table[name]
        rows.append({"name": name, "route": "cuda",
                     "source": source + "drmsd_variants.cu",
                     "replaces": f"tools/bench_drmsd_kernel.py:{line}",
                     "launches": bench_launches[name],
                     "max_abs_err": variant_errs[name], "ms": k_ms,
                     "device_ms": d_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
    for row in rows:  # the probe's, once an epoch with --use_wandb True
        if probe_launches[row["name"]]:
            row["launches_probe"] = probe_launches[row["name"]]
        if rebuild_launches[row["name"]]:
            row["launches_rebuild"] = rebuild_launches[row["name"]]
        # over every rank of phase 18's runs
        row["launches_multi_gpu"] = multi_gpu_launches[row["name"]]
        if scale_launches[row["name"]]:
            row["launches_scale_data"] = scale_launches[row["name"]]
        if ladder_launches_all[row["name"]]:
            row["launches_ladder"] = ladder_launches_all[row["name"]]
        if bench_launches_all[row["name"]]:
            row["launches_bench"] = bench_launches_all[row["name"]]
        # the enc-dec steps with scheduled sampling at full length
        if sampled_launches[row["name"]]:
            row["launches_enc_dec_sampled"] = sampled_launches[row["name"]]
    require(all(row["launches"] > 0 or row["name"] == "drmsd_grad_b"
                for row in rows),
            "every kernel of a main path was launched on it (K1c runs only "
            "when the true coordinates need a gradient)")
    print(f"[run] every phase passed in {time.perf_counter() - t_start:.1f} s "
          f"({card})")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
