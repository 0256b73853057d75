"""Drive ku_torch's main paths on one NVIDIA GPU and check every step.

Usage, from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: CUDA must be present; print the card's name and power limit.
2. Build: compile the six kernel sources of ku_torch/csrc with nvcc, and
   kernel #1's probe build (-DCD_PROBE), one process per build, all
   started together; print their register and spill lines (kept for phase
   19) and the CD cluster route's plans at the path's shapes.
3. CD kernel against its plain version on the card, same inputs, on both
   routes (the cluster route at 16 blocks and at 8, the global route),
   each launch's route, cluster size, batch tile and shared memory as the
   C entry reports them held against cluster_plan:
   - saturated biases (every draw certain), Bernoulli, k = 1 and 2, ragged
     last batch, 2 epochs: params and scores rtol 1e-5 / atol 1e-5;
   - random parameters, all three modes, shared Philox draws, V = 784,
     H = 128, B = 128, 3 steps, and the DBN's two layers: params rtol 1e-5
     / atol 1e-5, scores rtol 1e-4 / atol 1e-4 (float32 sums in another
     order; a few steps, so that no Bernoulli threshold moves by an ulp);
   - the card tests' ragged shapes (37 x 45 at batch 40, 6 x 4 at 16,
     200 x 70 at 150) and V = 100, which 16 and 8 blocks do not divide.
   Then the C entry's plans against cluster_plan, and a W past the shared-
   memory budget (4096 x 1024): the global route by the shape, a forced
   cluster launch refused.
4. RBM path: RBM({"lr": 1e-3, "batch_size": 128, "epochs": 3}, 128).fit on
   bench.py's synthetic MNIST-like data (N = 60,032, V = 784, p = 0.13);
   then the DBN 784 → 256 → 128, one epoch a layer, and its transform. The
   CD kernel must launch 3 times, all on the cluster route, every score be
   finite, and the reconstruction error fall.
5. RBM timing with CUDA events after warm-up: samples/s of RBM.fit, and the
   kernel (the cluster route), its plain version and the bound at the
   path's shape; the global route and the cluster route at 8 blocks beside
   it, in turns; each route's split of a step into its phases over 64
   steps (the probe build: every block stamps %globaltimer at each phase's
   end).
20. (Run right after phase 5, on its data.) Data-parallel CD-k, kernel #2
   (the statistics and apply step kernels), against its plain version on
   the card with the same Philox draws, at world size 1 and at 4 ranks
   emulated in one process (their buffers summed in rank order in place of
   the all-reduce), on both routes, with phase 3's cases and limits:
   saturated, k 1 and 2, 2 epochs, a ragged last shard; random parameters
   in all three modes, 3 steps. Then world size 1 against kernel #1 over
   the path's 3 epochs, bit for bit (the same device code and sums), on
   each route, and 4 ranks emulated against kernel #1 (saturated over 2
   epochs, random over 3 steps; params rtol/atol 1e-5, scores 1e-4: sums
   in another order).
21. The path: RBM({"lr": 1e-3, "batch_size": 128, "epochs": 3}, 128).fit(V,
   mesh=make_mesh()) in a real NCCL world of one process, on phase 4's
   data: 1,407 launches of each step kernel (the statistics all on the
   cluster route) and none of kernel #1, finite scores, a falling
   reconstruction error, params equal to phase 4's single-device fit bit
   for bit; then the DBN 784 -> 256 -> 128 with mesh=.
22. Timing: RBM.fit with and without the mesh in turns (samples/s); the
   data-parallel run beside kernel #1's; a torch.profiler window over 20
   steps (each step kernel's and the all-reduce's device time a step, the
   host time a step, the device busy share); the host time of each of a
   step's three calls (two launches and the all-reduce) over 200 steps;
   the step kernels alone at the path's shape, cold in L2, on the cluster
   route and on the global route, against their plain version and their
   bound.
   The process group is destroyed at the end of the phase.
6. Serving kernels against their plain versions on the card, f32
   (rtol/atol 1e-4: f32 sums in another order) and bf16 (rtol 1e-2, just
   above one bf16 ulp, for the output's own rounding; atol 2e-3 for the
   probabilities' rounding to bf16 against another running max): flash
   forward, every case in f32 through the CUDA-core kernel and in bf16
   through the tensor-core one, each launch's route and layout (as the C
   entry reports them) and copies checked: at the prefill's shape (the cache page read in place through a
   transposed view, no copy; per-row offsets) and at ragged shapes (N, KN
   not tile multiples, G 1 and 4, window, segment ids, softcap, scalar and
   per-row offsets, rows with no live key, D 40 / Dv 24 and D 36 / Dv 12);
   a slot-minor cache 203 slots wide, q with a stride of 2 along D and q 2
   bytes off 16 (each copied by the wrapper for the tensor cores); a bf16
   head 160 wide (the CUDA-core kernel, by shape); causal at N = KN = 256
   in rows (full key tiles that test no pair); flash decoding at the
   decode step's shape and at ragged ones (lengths 0, 1 and S, G 1 and 4,
   softcap), and its int8 variant; then at every edge of its chunk plan
   (lengths 0, -1, 1, 63, 64, 65, 511, 512, 513, S and S + 100) with G 4,
   1 and 16, Dv < D and int8 with softcap, on the 16-byte copies (S 1,024)
   and the element loads (S 77, 130), each launch's route and 8 blocks a
   cluster as the C entry reports them, rows of length <= 0 exactly 0; and
   a row of the decode step's shape read alone equals the same row read in
   its batch of 8, bit for bit.
7. The serving LM at full width: 16 Transformer blocks, d_model 2048, 16
   query heads over 4 KV heads (head dim 128), RoPE, use_flash, a
   1,024-slot dense cache, weights from a seed (flax's initialisers), a
   tied 1,024 × 2,048 embedding table. First in float32 with TF32 off:
   prefill plus 16 decode steps through the kernels, then through the plain
   paths; every output agrees at rtol/atol 1e-4. Then in bf16:
   - generate: 8 prompts of width 128, ragged lengths 64..128, 256 greedy
     steps with logprobs; the flash kernel must launch 32 times (one
     prefill × 32 attention sublayers) and the decode kernel 32 × 255;
   - ContinuousBatcher: 8 slots, prompt_len 64, chunk (8, 32), 24 requests
     with prompts of 16..192 tokens and budgets of 32..256; every request
     answered with exactly its budget.
8. Serving timing: generate's decode tokens/s (the slope between 256 and
   128 steps), prefill prompt tokens/s, batcher tokens/s and its ratio to
   generate; torch.profiler windows over one prefill and 8 decode steps
   (host wall time, device busy share, kernels by device time, the SM
   clock sampled by nvidia-smi meanwhile), which give each serving
   kernel's device time per launch on the path (`path_ms`; the prefill's
   flash launches on the tensor cores, none on the CUDA cores); each
   kernel at its path's shape, each call timed alone by CUDA events after
   a 256 MB write has evicted L2 (on the path a layer's weights stream
   through L2 between two attention calls) and the card has spun for
   about 0.1 ms, so that the host's work before the launch is not timed,
   against its plain version, its
   bound and one PyTorch call computing the same function (`ms`;
   scaled_dot_product_attention with a boolean mask, and for flash also
   with is_causal=True under each fused backend whose output agrees with
   the masked call's, all timed in turns, the fastest as `library_ms`);
   and the
   decode kernel alone under the profiler too, warm and cold, so that
   `ms` and `path_ms` are also compared by one clock; its route, stages
   and blocks a cluster (the 16-byte route, checked), its achieved GB/s,
   the host µs a launch of its wrapper and of each part of it, and every
   decode instantiation's registers and spills (none may spill).

9. (Run beside phase 6.) Paged flash decoding (kernel #7) against its
   plain version on the card:
   f32 (rtol/atol 1e-4), bf16 and int8 pools with scales (the bf16 limits
   above for bf16 queries); pages of 16 and 256 slots over tables in
   permuted order whose dead tails point at one pool page poisoned with
   NaN (NaN scales for int8 pools); ragged lengths including 1 and one past
   the table's end; every edge of the chunk plan over pages of 16, 20 (the
   element loads in bf16 and int8), 64 and 256 slots; G 4, D 128. Outputs
   finite, each launch's route checked. With an identity table and one
   page as wide as the cache (S 300 and 1,024, f32 and bf16), it equals
   the dense kernel bit for bit; a row read alone equals the same row in
   its batch of 8, bit for bit.
10. (Run after phase 7's f32 part.) The same f32 LM with a paged cache
   (256-slot pages, max_decode_len
   2,048, so 8 pages a row): 8 prompts of 640..1,024 tokens, right-padded
   to 1,024, prefilled, then 16 greedy steps. Its outputs agree with the
   dense-cache model's (max_decode_len 2,048) at rtol/atol 1e-4, with f32
   pools and with int8 ones (kv_cache_dtype='int8'), and with f32 pools
   through its kernels with its plain paths.
11. bf16 paged `generate` on those prompts, 256 steps: the flash kernel
   launches 32 times, the paged decode kernel 32 × 255, the dense one not
   at all. Timed as in phase 8 (decode slope, prefill rate) beside the
   dense-cache `generate` on the same prompts, one run each; then, since
   the host clock wanders more than that, every decode step timed alone,
   64 after a prefill, in the order paged, dense, dense, paged (medians).
12. bf16 paged `ContinuousBatcher`: 8 slots, prompt_len 256, chunk (8, 32),
   a pool of 24 pages (scratch page 0 and 23 allocatable) against the 64
   that 8 slots × 8 pages would take, a 300-token shared prefix (one full
   page and a 44-token tail), 24 requests of 64..704 prompt tokens with
   budgets 32..256. Admissions defer (shown once by driving submit / step);
   the timed `serve` answers every request with exactly its budget, within
   23 pages, with the prefix on 2 of them; the paged decode kernel launches
   32 times a step and the flash kernel 32 times a prefill round and once
   for the prefix.
13. The paged kernel alone at the path's shape (paged generate's middle
   step: lengths prompt + 128, B 8, pg 256, MP 8, bf16), cold in L2 and
   warm, against its bound (the live K/V bytes at the card's memory rate),
   its plain version and the dense kernel at the same lengths; and its
   device time a launch on the path from a profiler window over 8 paged
   decode steps; its route (16-byte, checked), stages and blocks a
   cluster, achieved GB/s and the host µs a launch of its wrapper and its
   parts. No single PyTorch call reads through a page table, so its
   `library_ms` is null. Then the dense kernel at every row's length 64 to
   16,384 slots, cold: its fixed cost and streaming rate by a line fit.
14. (After the serving models are freed.) The flash backward kernels (dq,
   and dk/dv) against their plain versions on the card, on the same o, lse
   and delta, f32 through the CUDA-core kernels and bf16 through the
   tensor-core ones, each launch's route and the wrapper's copies checked:
   f32 rtol/atol 1e-4; bf16 rtol 2e-2 and atol 1e-2 of each gradient's
   largest entry (p and ds are rounded to bf16 before their products).
   Ragged N and KN, G 1 and 4, window, segment ids, softcap, scalar and
   per-row offsets, dO through a transposed view, rows with no live key
   (dq 0), D 40 / Dv 24, D 36 / Dv 12 and D 32 / Dv 96, q strided or
   misaligned (copied for the tensor cores), and the training shape (B 8,
   H 16 over 4, N = KN = 1,024, D 128, causal).
15. The 0.87B LM trained at full width through ku_torch.engine_ext.Trainer:
   the serving LM's blocks between a tied 1,024 x 2,048 embedding and
   readout, next-token cross-entropy on sequences that repeat a 64-token
   motif, Adam at 3e-5. In f32 (TF32 off), batch 2 x 1,024: one step's
   loss and every gradient through the kernels against the plain paths
   (use_flash=False, the dense path), gradients at rtol 1e-3 and atol 1e-3
   of each tensor's largest entry; then `fit`, 2 epochs over 32 sequences
   at batch 4, whose loss must be finite and fall. In bf16, batch 8 x
   1,024: 2 warm-up `train_step`s and 8 timed ones, losses finite. Every
   step launches the forward, dq and dk/dv kernels 32 times each (one per
   attention sublayer; bf16 on the tensor-core route) and no decode
   kernel. Peak memory of each part.
16. Training timing: train tokens/s from the median of the 8 steps (CUDA
   events); a torch.profiler window over one bf16 step (wall time, device
   busy share, ops by device time, each tensor-core flash kernel's device
   time a launch: `path_ms`; no CUDA-core flash kernel may run); the same
   step through the plain paths (dense attention), 4 steps, as a
   yardstick; each flash instantiation's registers and spills (phase 2's
   build output) and its count of tensor-core instructions (cuobjdump
   -sass; each of the eight bf16 instantiations must have some); each
   flash kernel alone at the training shape in bf16, cold in L2, against
   its bound (4·D operations a live pair for the forward, 6·D for dq, 8·D
   for dk/dv, at the bf16 tensor-core peak, or the bytes at the memory
   rate), its plain version and `library_ms`: scaled_dot_product_attention
   with the boolean causal mask and with is_causal=True under each fused
   backend (flash, efficient, cudnn; K and V expanded to 16 heads where
   one refuses GQA) whose output and gradients agree with the masked
   call's, all timed in turns, the fastest; the backward as forward +
   backward minus forward (dq, dk and dv together). The forward kernel's
   output there is held against its plain version first (phase 6's
   limits); the difference joins its entry's `max_abs_err`. The forward's numbers there join its
   entry as `ms_train`, `path_ms_train`, `bound_ms_train` and
   `library_ms_train`. Each timed call runs once untimed first.
17. (After the training model is freed.) The block-sparse kernels
   (forward, dq, dk/dv) against their plain versions on the card, the
   backward on the forward kernel's o, lse and delta: every case in f32
   through the CUDA-core kernels (rtol/atol 1e-4) and in bf16 through the
   tensor-core ones (phase 6's limits for the forward and phase 14's for
   the backward), each launch's route checked. ku's four pattern
   primitives (tests/test_sparse_attention.py:88-94) at blocks of 16, a
   causal block pattern, the non-causal cross pattern whose unattended key
   blocks hold NaN (outputs finite, their dk/dv exactly 0), rows with no
   live key (o, dq 0), blocks of 64, of 128 x 64, and the LM's 512 x 512
   mask; G 1 and 4, D 64 and 128, Dv != D both ways, D 40 with Dv 24 and D
   36 with Dv 12 (widths the tensor-core tiles zero-fill), dO through a
   transposed view, q with a stride of 2 along D and q 2 bytes off 16
   (both copied by the wrapper for the tensor-core kernels); in bf16 also
   ku's sparse gate (bench.py:217-243: B 1, H 4, N 65,536, D 64, window
   4,096 + 128 sinks).
18. The same LM trained under a block mask through Trainer: every block
   called with the mask, which routes both attention sublayers through
   the sparse kernels. f32 (TF32 off), B 1 x 2,048, blocks of 128, window
   512 + 64 sinks: one step's loss and every gradient through the kernels
   against the same step through the plain versions (routed here only),
   rtol 1e-3 and atol 1e-3 of each tensor's largest entry; then `fit`, 2
   epochs over 8 sequences at B 1, whose loss must be finite and fall.
   bf16, B 1 x 8,192 under the main mask (512 x 512 blocks, window 2,048
   + 128 sinks: 81 of 256 blocks): 2 warm-up `train_step`s and 4 timed
   ones, losses finite, each step exactly 32 launches of each sparse
   kernel and none of the flash or decode kernels; `predict` launches the
   sparse forward only. Peak memory of each part.
19. Sparse timing: each sparse instantiation's registers and spills (from
   phase 2's build output) and its count of tensor-core instructions
   (HMMA / HGMMA in cuobjdump -sass of the built library; each of the six
   bf16 instantiations, D up to 64 and 128, must have some); train tokens/s from the median of the
   timed steps (CUDA events); a torch.profiler window over one bf16 step
   (each tensor-core sparse kernel's `path_ms`; no f32 sparse kernel may
   run); each sparse kernel alone at the LM's shape in bf16 (the
   tensor-core route, checked), cold in L2, against its plain version and
   its bound (4·D operations a kept pair for the forward, 6·D for dq, 8·D
   for dk/dv, from the mask's exact kept-pair count, at the bf16
   tensor-core peak, or the bytes at the memory rate) and `library_ms`:
   flex_attention, compiled, over a block mask from the same mask_mod
   (forward; forward + backward minus forward); then ku's sparse gate: the
   sparse kernels against the dense causal flash forward at 64k (ku's
   sparse_vs_causal_speedup; both on the tensor cores, the route checked).
23. The RBM examples on the card: examples_torch/rbm/rbm_softmax_mnist.py's
   MNISTClassifier (examples/rbm/rbm_softmax_mnist_conf.json) trains
   through train(V, gt) on phase 4's MNIST-like rows (x 255) with labels
   from the seed, and writes solution.csv to a temp dir through test(...):
   the header, one row per image, labels in 0-9 equal to the predictions'
   argmax; the RBM's fit must launch kernel #1 once. Then
   examples_torch/rbm/dbn_mnist.py's classifier the same way, kernel #1
   launched once a layer (2). The wall time of each.
24. The StyleGAN generator at __graft_entry__.entry's conf (128 px,
   ch_base 1024, max_ch 512, latent / dlatent / dense1 64, 8 mapping
   layers, 1,000 classes with labels, no mixing, psi 0.7, cutoff 8, lane
   packing on: the unpacked math), batch 4, weights drawn with numpy from a
   seed and loaded through state_dict_from_tree (strict): f32 with TF32
   off and deterministic=True against the same module on the CPU in
   float64 from the same weights (within 1e-4 of the output's largest
   entry); bf16 (dtype=torch.bfloat16) against f32 (4e-2 absolute, ku's
   own limit, tests/test_stylegan.py:182); in training mode with mixing
   0.9 and the noise on, a finite output and a moving mean that moved.
25. The discriminator at 128 px, batch 4, the same way: f32 against the
   CPU float64 forward (1e-4 of the largest entry); r1_penalty on real
   images and gradient_penalty on their interpolation with phase 24's
   images, against the same on the CPU in float64 (1e-4 of the largest
   entry); a second gradient, through the R1 penalty into the
   discriminator's parameters, finite, its norm printed and held against
   the CPU float64 one (the difference's norm within 1e-3 of it).
26. StyleGAN timing: the generator (f32, bf16) and the discriminator (f32,
   bf16) forward at batch 4, and the generator at batch 12 (bench.py's
   StyleGAN batch), each the median of 20 calls timed alone by CUDA events
   after 3 warm-up calls: ms and images/s; one torch.profiler window a
   case for the device-busy share and the device ops a forward; a bound:
   the FLOPs of the convolutions and products (FlopCounterMode over one
   forward, from the shapes) at the f32 peak (TF32 off) or the bf16
   tensor-core peak, or the bytes of the f32 parameters, the input and the
   output at the memory rate, whichever is larger. Printed as a
   `stylegan` JSON line. No TPU kernel lies on this path: the convolutions
   are cuDNN's.
27. The GAN step at bench.py's StyleGAN conf (benchmarks/
   stylegan_lane_packing.py:36-61: 128 px, ch_base 1024, max_ch 512,
   dlatent 512, 1,000 classes, mixing 0.9, psi 0.7, cutoff 8, bf16,
   softplus-R1 with gamma 10 every step, k = 2, batch 12, Adam 1.5e-4 /
   1.5e-3 with beta (0, 0.99)), its batches drawn as batches_stacked draws
   them, weights from seeds 27 / 28, through ku_torch.backprop.GAN:
   (a) one f32 train_step (TF32 off, no mixing, noise weights 0) at batch
   4 against the same step in float64 on the card, taken piece by piece
   (see gan_check): labels 1-3, not bench.py's 0-999 (which saturate the
   losses), and kernels scaled to He's fan-in (he_scaled: at unit scale
   the discriminator is blind to its image); each loss within 1e-4 plus
   what its logits' tolerance can move it by, and out of saturation; the
   moving mean within 1e-4; each update's gradient within 1e-2 of its
   tensor's largest entry (cuDNN's f32 convolutions); each parameter's
   change over the step within 1e-4 of the float64 change's largest
   entry, plus what the gradients' tolerance can move its Adam updates
   by, plus f32's rounding; (b)
   GAN(...).compose_gan_with_mode().compile().fit_generator(...) in bf16,
   1 epoch of 4 steps: a finite history, every parameter, buffer and Adam
   moment on the card; (c) the median of 20 steps by CUDA events after 3
   warm-up steps, ms a step and images/s ((k + 1) B / step, ku's
   formula), the peak memory, one profiled step (device ops, busy share,
   the top ops), the bound (the step's convolution and product FLOPs,
   backward passes included, at the bf16 peak, or the f32 parameters and
   Adam moments read and written, whichever is larger); printed as a
   `gan_step` JSON line. No TPU kernel lies on this path either.

The last lines are the `kernels` JSON line (10 kernels), the card's name
and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

import torch.distributed as dist

from examples_torch.rbm import dbn_mnist, rbm_softmax_mnist
from ku_torch.backprop import GAN, STYLE_GAN_SOFTPLUS_INVERSE_R1_GP
from ku_torch.core.config import load_config
from ku_torch.dist import make_mesh
from ku_torch.ebm import DBN, RBM
from ku_torch.engine_ext import Trainer, adam
from ku_torch.kernels import _build, cd_gibbs, cd_gibbs_dp
from ku_torch.kernels import decode_attention as da
from ku_torch.kernels import flash_attention as fa
from ku_torch.kernels import sparse_attention as sa
from ku_torch.loss_ext import gradient_penalty, r1_penalty
from ku_torch.models import StyleGANDiscriminator, StyleGANGenerator
from ku_torch.nn import ContinuousBatcher, MultiHeadAttention, Transformer, generate
from ku_torch.utility import _flatten, state_dict_from_tree, tree_from_state_dict

DECODE_KERNELS = (da.decode_attention_cuda, da.decode_attention_paged_cuda)
BWD_KERNELS = (fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda)
SPARSE_KERNELS = (sa.sparse_fwd_cuda, sa.sparse_bwd_dq_cuda, sa.sparse_bwd_dkv_cuda)
SPARSE_DISPATCH = (sa.sparse_fwd, sa.sparse_bwd)

N, V_DIM, H_DIM, BATCH, EPOCHS, K = 60032, 784, 128, 128, 3, 1
LR = 1e-3
DEVICE = "cuda"

# The serving LM (benchmarks/batcher_bench.py's "big" conf, use_flash, a
# 1,024-slot cache) and its workloads.
LM_BLOCKS, LM_HEADS, LM_KV_HEADS, LM_D, LM_VOCAB, LM_MAX_LEN = 16, 16, 4, 2048, 1024, 1024
GEN_B, GEN_P, GEN_STEPS = 8, 128, 256
CB_SLOTS, CB_PROMPT_LEN, CB_CHUNK, CB_REQUESTS = 8, 64, (8, 32), 24
# The paged phases: 256-slot pages over a 2,048-slot window (8 pages a row),
# prompts of 640..1,024 tokens padded to 1,024; the paged batcher's pool,
# prompt width, shared prefix and request lengths.
PAGE, PAGED_MAX_LEN, PG_P, PG_MIN = 256, 2048, 1024, 640
CBP_PAGES, CBP_PROMPT_LEN, CBP_PREFIX, CBP_MIN, CBP_MAX = 24, 256, 300, 64, 704
# The training phases: sequences of TRAIN_N + 1 tokens (a TRAIN_PERIOD-token
# motif repeated), TRAIN_SEQS of them; bf16 steps at batch TRAIN_B, f32
# gradients compared at F32_GRAD_B and `fit` at F32_FIT_B. Adam's rate: at
# 1e-4 this LM's loss spikes within its first steps from the seed (9.2 to
# 15.2 at step 3 in f32), through the kernels and the plain paths alike;
# 3e-5 falls smoothly.
TRAIN_N, TRAIN_PERIOD, TRAIN_SEQS, TRAIN_B, TRAIN_TIMED = 1024, 64, 32, 8, 8
F32_GRAD_B, F32_FIT_B, TRAIN_LR = 2, 4, 3e-5
FLUSH_BYTES = 256 << 20  # written before each cold call: past the 50 MB L2
# Cycles the card spins after the flush (about 0.1 ms at 2 GHz): longer than
# any wrapper's host work before its launch.
HOLD_CYCLES = 200_000
# The block-sparse phases: the same LM trained at SP_N tokens a sequence
# (B 1) under StreamingLLM's pattern, a window of SP_WINDOW keys plus
# SP_SINKS sinks, in ku's default 512 x 512 blocks; SP_TIMED timed bf16
# steps. The f32 check runs a smaller pattern of the same kind at SP32_N
# tokens, and `fit` 2 epochs over SP32_SEQS sequences at B 1. ku's sparse
# gate (bench.py:217-243): B 1, H 4, N 65,536, D 64, bf16, window 4,096.
SP_N, SP_BLOCK, SP_WINDOW, SP_SINKS, SP_TIMED = 8192, 512, 2048, 128, 4
SP32_N, SP32_BLOCK, SP32_WINDOW, SP32_SINKS, SP32_SEQS = 2048, 128, 512, 64, 8
GATE_H, GATE_N, GATE_D, GATE_WINDOW = 4, 65536, 64, 4096
# The StyleGAN phases: __graft_entry__.entry's generator conf (mixing on
# for the training-mode check only), its discriminator at the same width,
# the batches timed (entry's and bench.py's) and the calls timed a case.
SG_CONF = dict(resolution=128, ch_base=1024, max_ch=512, latent_dim=64, dlatent_dim=64,
               dense1_dim=64, num_mapping_layers=8, num_classes=1000, label_usage=True,
               mixing_prob=None, trunc_psi=0.7, trunc_cutoff=8, lane_packing=True)
SG_DISC = dict(resolution=128, ch_base=1024, max_ch=512, label_usage=True)
SG_BATCH, SG_BENCH_BATCH, SG_REPS = 4, 12, 20
# The GAN step (phase 27): bench.py's StyleGAN conf (bench.py:179, that is
# benchmarks/stylegan_lane_packing.py:36-61, read, not imported): 128 px,
# ch_base 1024, max_ch 512, latent 64, dlatent 512, dense1 512, 8 mapping
# layers, 1,000 classes with labels, mixing 0.9, psi 0.7, cutoff 8, lane
# packing (the unpacked math), bf16; softplus-R1 with gamma 10 every step, 2
# D updates a G update, batch 12, Adam at 1.5e-4 / 1.5e-3 with beta (0,
# 0.99). The f32 check against float64 runs at GAN_CHECK_B images with
# labels in GAN_CHECK_LABELS, within GAN_REL, the gradients within
# GAN_GRAD_REL (see gan_check); GAN_GROUPS step inputs are timed in turn.
# GAN_GRAD_REL: cuDNN's f32 convolution algorithms (TF32 off) put the
# step's gradients up to 2.2e-3 of a tensor's largest entry off float64
# on the H100 (the discriminator's first update, R1's double backward
# included; torch's own convolutions 1.8e-4), so 1e-2.
GAN_CONF = dict(resolution=128, ch_base=1024, max_ch=512, latent_dim=64, dlatent_dim=512,
                dense1_dim=512, num_mapping_layers=8, num_classes=1000, label_usage=True,
                mixing_prob=0.9, trunc_psi=0.7, trunc_cutoff=8, lane_packing=True)
GAN_DISC = dict(resolution=128, ch_base=1024, max_ch=512, label_usage=True, lane_packing=True)
GAN_K, GAN_B, GAN_CHECK_B, GAN_GROUPS, GAN_WARM, GAN_REPS, GAN_REL = 2, 12, 4, 4, 3, 20, 1e-4
GAN_GRAD_REL = 1e-2
GAN_LABELS, GAN_CHECK_LABELS = (0, GAN_CONF["num_classes"]), (1, 4)
GAN_LR = {"disc": 1.5e-4, "gen": 1.5e-3}
GAN_ENGINE = {
    "hps": {"composing_mode": STYLE_GAN_SOFTPLUS_INVERSE_R1_GP, "disc_k_step": GAN_K,
            "r_gamma": 10.0, "r1_interval": 1,
            "disc_ext_hps": {"lr": GAN_LR["disc"], "beta_1": 0.0, "beta_2": 0.99},
            "gen_disc_hps": {"lr": GAN_LR["gen"], "beta_1": 0.0, "beta_2": 0.99}},
    "nn_arch": {"gen_rng_streams": ["noise", "style"]},
}

# Published peaks (NVIDIA data sheets, dense): f32 outside the tensor cores
# and bf16 on the tensor cores in FLOP/s, and memory bandwidth in bytes/s,
# by the name nvidia-smi reports.
PEAKS = {
    "H100 PCIe": (51e12, 756e12, 2.0e12),
    "H100 NVL": (60e12, 835e12, 3.9e12),
    "H100": (67e12, 989e12, 3.35e12),  # SXM
    "H200": (67e12, 989e12, 4.8e12),
}


BUILD_REPORTS = {}  # nvcc's -Xptxas -v output by library name (phase 2)


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def peaks(name: str):
    for key, value in PEAKS.items():
        if key in name:
            return value
    raise RuntimeError(f"no published peaks recorded for {name!r}")


def timed_ms(fn, reps: int) -> float:
    """Mean ms per call of fn() over reps calls back to back, by CUDA
    events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_cold_ms(fn, reps: int) -> float:
    """Mean ms per call of fn(), each call timed alone by CUDA events after
    a FLUSH_BYTES write has evicted L2, so that it reads its inputs from
    device memory as a layer of the model does (between two layers' calls
    the weights of a layer stream through L2). The card then spins for
    HOLD_CYCLES before the start event, so that the host has enqueued the
    timed launches by the time the card reaches it: the time is the card's,
    not the host's work in fn before its first launch."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / reps


def wall_s(fn) -> float:
    """Host seconds of fn, ended by a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def sdpa_ms(q, k, v, scale, mask, do=None, reps=10, rounds=5):
    """scaled_dot_product_attention on (q, k, v), each call timed alone and
    cold in L2 (timed_cold_ms): {backend: (forward ms, backward ms or None,
    how it ran)}. "masked" passes the boolean `mask` to the default
    dispatch; each fused backend (flash, efficient, cudnn) runs with
    is_causal=True through sdpa_kernel, and with fewer queries than keys
    (the prefill over its cache page) also over the first N keys alone: at
    offset 0 causal query i reaches keys 0..i only, and on a square
    is_causal has one alignment. (The backward is timed at N = KN only.) A
    backend that refuses GQA or these strides gets K and V expanded to H
    heads, contiguous, before the timed window; one that refuses that too
    is left out. Each fused backend's output (and with `do` its gradients,
    those of expanded K and V summed over each group) is first held against
    the masked call's at twice phase 6's limits for the output and twice
    phase 14's for the gradients: two bf16 results that each lie within a
    limit of the exact function lie within twice it of each other, while
    another function (a causal edge aligned otherwise) differs by the
    values' own size. One that differs is left out. The backends are
    then timed in turns, `rounds` rounds of `reps` calls each, so that a
    drift of the card's clock reaches all alike; each time is the median of
    its rounds' means. With `do`, the backward is forward + backward minus
    forward (dq, dk and dv together). A yardstick only: nothing in ku_torch
    calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, h, n, hkv, kn = q.shape[0], q.shape[1], q.shape[2], k.shape[1], k.shape[2]
    check(do is None or n == kn, "SDPA's backward is timed at N = KN only")
    fused = (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION)
    runs = ([("masked", None, dict(attn_mask=mask), kn)]
            + [(be.name.lower(), be, dict(is_causal=True), kn) for be in fused]
            + [(f"{be.name.lower()}, first {n} keys", be, dict(is_causal=True), n)
               for be in (fused if n < kn else ())])
    timed, ref = {}, None
    for name, backend, kw, keys in runs:
        for expanded in (False, True):
            kk, vv = ((t[:, :, :keys].repeat_interleave(h // hkv, dim=1).contiguous()
                       for t in (k, v)) if expanded else (k[:, :, :keys], v[:, :, :keys]))
            qr, kr, vr = (t.detach().requires_grad_(do is not None) for t in (q, kk, vv))

            def fwd(qr=qr, kr=kr, vr=vr, backend=backend, kw=kw, gqa=not expanded):
                with sdpa_kernel(backend) if backend is not None else contextlib.nullcontext():
                    return F.scaled_dot_product_attention(qr, kr, vr, scale=scale,
                                                          enable_gqa=gqa, **kw)

            grad = None if do is None else (
                lambda fwd=fwd, ins=(qr, kr, vr): torch.autograd.grad(fwd(), ins, do))
            try:
                o = fwd()  # once untimed: workspaces, allocator
                got = (o,) if do is None else (o,) + torch.autograd.grad(o, (qr, kr, vr), do)
                torch.cuda.synchronize()
            except Exception as e:  # noqa: BLE001 - a backend that refuses these inputs
                log(f"  SDPA {name}{' (K/V expanded)' if expanded else ''} refused: "
                    f"{str(e).strip().splitlines()[0][:100]}")
                continue
            break
        else:
            continue
        got = tuple(t.detach() for t in got[:2]) + tuple(
            t.detach().reshape(b, hkv, -1, *t.shape[2:]).sum(2, dtype=torch.float32)
            .to(t.dtype) if t.shape[1] != hkv else t.detach() for t in got[2:])
        if ref is None:  # the masked call, first
            ref = got
        else:
            try:
                torch.testing.assert_close(got[0], ref[0], rtol=2 * TOLS[q.dtype]["rtol"],
                                           atol=2 * TOLS[q.dtype]["atol"])
                for what, x, want in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
                    bwd_close(x, want, q.dtype, f"SDPA {name} {what}", twice=True)
            except AssertionError as e:
                log(f"  SDPA {name} differs from the masked call, left out: "
                    + "; ".join(x.strip() for x in str(e).strip().splitlines()[:4])[:300])
                continue
        timed[name] = (fwd, grad, "K/V expanded to H heads" if expanded else "GQA")
    check("masked" in timed, "SDPA with the boolean mask did not run")
    fwd_ms = {name: [] for name in timed}
    bwd_ms = {name: [] for name in timed}
    for _ in range(rounds):
        for name, (fwd, grad, _) in timed.items():
            f_ms = timed_cold_ms(fwd, reps)
            fwd_ms[name].append(f_ms)
            if grad is not None:
                bwd_ms[name].append(timed_cold_ms(grad, reps) - f_ms)
    for name in timed:
        log(f"  SDPA {name}: forward rounds {[round(x, 4) for x in fwd_ms[name]]}"
            + (f", backward rounds {[round(x, 4) for x in bwd_ms[name]]}" if do is not None
               else ""))
    return {name: (float(np.median(fwd_ms[name])),
                   float(np.median(bwd_ms[name])) if do is not None else None, how)
            for name, (_, _, how) in timed.items()}


def sdpa_line(times) -> str:
    return "; ".join(f"{k} ({how}) fwd {f:.4f}" + ("" if b is None else f", bwd {b:.4f}")
                     for k, (f, b, how) in times.items())


# ---------------------------------------------------------------------------
# The RBM path (phases 3-5).
# ---------------------------------------------------------------------------


def mnist_like(seed=0) -> np.ndarray:
    """bench.py's data: MNIST-like sparse binary visibles."""
    rng = np.random.default_rng(seed)
    return (rng.random((N, V_DIM)) < 0.13).astype(np.float32)


def problem(dev, v_dim, h_dim, batch, steps, mode, saturated, seed):
    rng = np.random.default_rng(seed)
    if saturated:
        w = np.zeros((v_dim, h_dim))
        bh = np.where(np.arange(h_dim) % 2 == 0, 200.0, -200.0)
        bv = np.where(np.arange(v_dim) % 3 == 0, 200.0, -200.0)
    else:
        w = rng.uniform(-0.05, 0.05, (v_dim, h_dim))
        bh = rng.uniform(-0.05, 0.05, h_dim)
        bv = rng.uniform(-0.05, 0.05, v_dim)
    rows = batch * steps
    n = rows - 37 if saturated else rows
    if mode == cd_gibbs.MODE_VISIBLE_BERNOULLI:
        data = (rng.random((rows, v_dim)) < 0.13).astype(np.float32)
    else:
        data = rng.normal(size=(rows, v_dim)).astype(np.float32)
    data[n:] = 0.0
    mask = (np.arange(rows) < n).astype(np.float32)
    params = {name: torch.tensor(x, dtype=torch.float32, device=dev)
              for name, x in zip(("rbm_weight", "hidden_bias", "visible_bias"),
                                 (w, bh, bv))}
    return params, torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)


# Phase 3's cases, (V, H, batch, mode, k, saturated, steps, epochs): the
# RBM's shape, the DBN's two layers, the card tests' ragged shapes, and a V
# that 16 and 8 blocks do not divide.
CD_CASES = ([(V_DIM, H_DIM, BATCH, 0, k, True, 4, 2) for k in (1, 2)]
            + [(V_DIM, H_DIM, BATCH, mode, 1, False, 3, 1) for mode in (0, 1, 2)]
            + [(V_DIM, 256, BATCH, 0, 1, False, 2, 1), (256, H_DIM, BATCH, 0, 1, False, 2, 1)]
            + [(37, 45, 40, 0, 2, True, 3, 2), (6, 4, 16, 0, 1, True, 4, 2),
               (200, 70, 150, 0, 1, True, 2, 2), (37, 45, 40, 2, 1, False, 3, 1)]
            + [(100, H_DIM, BATCH, 0, 1, False, 3, 1)])
# The launches phase 3 makes of each case: (route, cluster size).
CD_ROUTES = (("cluster", None), ("global", None), ("cluster", 8))


def check_against_plain(dev) -> float:
    """Phase 3; returns the largest abs difference seen."""
    worst = 0.0
    for v_dim, h_dim, batch, mode, k, saturated, steps, epochs in CD_CASES:
        plan = cd_gibbs.cluster_plan(batch, v_dim, h_dim)
        check(plan["route"] == "cluster", f"{v_dim}x{h_dim} at batch {batch} is not on "
              f"the cluster route: {plan}")
        params, v_all, mask = problem(dev, v_dim, h_dim, batch, steps, mode,
                                      saturated, seed=10 + mode)
        args = (params, v_all, mask, 4321, LR, k, mode, batch, epochs)
        p_p, s_p = cd_gibbs.cd_train_torch(*args)
        torch.cuda.synchronize()
        s_tol = (1e-5, 1e-5) if saturated else (1e-4, 1e-4)
        for route, cluster in CD_ROUTES:
            if cluster is not None and cd_gibbs.cluster_plan(batch, v_dim, h_dim,
                                                             cluster)["route"] != "cluster":
                continue
            p_k, s_k = cd_gibbs.cd_train_cuda(*args, route=route, cluster=cluster)
            torch.cuda.synchronize()
            launch = cd_gibbs.last_launch()
            want = cd_gibbs.cluster_plan(batch, v_dim, h_dim, cluster or 16)
            check(launch["route"] == route, f"asked for the {route} route, got {launch}")
            if route == "cluster":
                check(launch["cluster"] == (cluster or 16)
                      and launch["batch_tile"] == want["batch_tile"]
                      and launch["smem_bytes"] == want["smem_bytes"],
                      f"the C entry launched {launch}, cluster_plan says {want}")
            what = f"{v_dim}x{h_dim} B {batch} mode {mode} k {k}, {route} route"
            for name in p_k:
                torch.testing.assert_close(p_k[name], p_p[name], rtol=1e-5, atol=1e-5,
                                           msg=f"{name}, {what}")
            torch.testing.assert_close(s_k, s_p, rtol=s_tol[0], atol=s_tol[1],
                                       msg=f"scores, {what}")
            p_diff = max(float((p_k[n] - p_p[n]).abs().max()) for n in p_k)
            s_diff = float((s_k - s_p).abs().max())
            worst = max(worst, p_diff, s_diff)
            log(f"kernel vs plain: {what} (C {launch['cluster']}, batch tile "
                f"{launch['batch_tile']}), saturated {saturated}, steps {steps * epochs}: "
                f"max abs diff params {p_diff:.3e}, scores {s_diff:.3e} (largest score "
                f"{float(s_p.abs().max()):.3e})")
    # The C entry's plans are cluster_plan's, and a W past the budget takes
    # the global route; the cluster route refuses it rather than fall back.
    for shape in [(BATCH, V_DIM, H_DIM), (BATCH, V_DIM, 256), (BATCH, 256, H_DIM),
                  (40, 37, 45), (BATCH // DP_WORLD, V_DIM, H_DIM), (BATCH, 4096, 1024)]:
        for cluster in (16, 8):
            want = cd_gibbs.cluster_plan(*shape, cluster)
            got = cd_gibbs.c_plan(*shape, cluster)
            check(all(got[key] == want[key] for key in got) or want["route"] == "global"
                  and got["smem_bytes"] == 0, f"plan at {shape}, C {cluster}: C {got}, "
                  f"Python {want}")
    params, v_all, mask = problem(dev, 4096, 1024, 8, 1, 0, True, seed=12)
    check(cd_gibbs.route_for(8, 4096, 1024) == "global", "4096x1024 is not global")
    try:
        cd_gibbs.cd_train_cuda(params, v_all, mask, 1, LR, 1, 0, 8, 1, route="cluster")
    except RuntimeError as e:
        log(f"a forced cluster launch past the budget is refused: {e}")
    else:
        check(False, "a cluster launch past the budget ran")
    return worst


def recon_error(rbm, x) -> float:
    g = torch.Generator(device=x.device).manual_seed(0)
    return float((rbm.inv_transform(rbm.transform(x, g), g) - x).abs().mean())


def rbm_path(dev, name):
    """Phases 3-5; returns the CD kernel's entry of the `kernels` line, the
    path's data and phase 4's fitted parameters (phases 20-22 reuse them)."""
    max_abs_err = check_against_plain(dev)

    V = torch.from_numpy(mnist_like()).to(dev)
    probe = V[:4096]
    cd_gibbs.cd_train_cuda.launches = 0
    cd_gibbs.cd_train_cuda.by_route = {r: 0 for r in cd_gibbs.ROUTES}
    rbm = RBM({"lr": LR, "batch_size": BATCH, "epochs": EPOCHS}, H_DIM,
              input_dim=V_DIM, seed=0, device=dev)
    err_before = recon_error(rbm, probe)
    rbm.fit(V)
    torch.cuda.synchronize()
    err_after = recon_error(rbm, probe)
    scores = rbm.last_scores
    check(scores.shape == (EPOCHS * N // BATCH,), f"scores shape {scores.shape}")
    check(bool(torch.isfinite(scores).all()), "non-finite score")
    for p in rbm.params.values():
        check(bool(torch.isfinite(p).all()), "non-finite parameter")
    check(err_after < err_before,
          f"reconstruction error did not fall: {err_before} -> {err_after}")
    log(f"RBM.fit: reconstruction error {err_before:.4f} -> {err_after:.4f}, "
        f"score first/last epoch {float(scores[:N // BATCH].mean()):.4f} / "
        f"{float(scores[-(N // BATCH):].mean()):.4f}")

    dbn = DBN()
    dbn.add_stack(RBM({"lr": LR, "batch_size": BATCH, "epochs": 1}, 256, seed=1,
                      device=dev))
    dbn.add_stack(RBM({"lr": LR, "batch_size": BATCH, "epochs": 1}, 128, seed=2,
                      device=dev))
    dbn.fit(V)
    h = dbn.transform(V)
    torch.cuda.synchronize()
    check(h.shape == (N, 128), f"DBN transform shape {h.shape}")
    check(bool(((h == 0) | (h == 1)).all()), "DBN transform is not binary")
    for layer in dbn.rbm_layers:
        check(bool(torch.isfinite(layer.last_scores).all()), "non-finite DBN score")
    launches = cd_gibbs.cd_train_cuda.launches
    check(launches == 3,
          f"expected 3 kernel launches (RBM + 2 DBN layers), got {launches}")
    by_route = dict(cd_gibbs.cd_train_cuda.by_route)
    check(by_route == {"global": 0, "cluster": 3},
          f"the path's launches by route: {by_route}")
    check(dbn.inv_transform(h).shape == (N, V_DIM), "DBN inv_transform shape")
    log(f"DBN 784-256-128: transform {tuple(h.shape)}, mean activation "
        f"{float(h.mean()):.4f}; kernel launches on the main path: {launches}, by "
        f"route {by_route}; the last {cd_gibbs.last_launch()}")

    fit_ms = timed_ms(lambda: RBM({"lr": LR, "batch_size": BATCH, "epochs": EPOCHS},
                                  H_DIM, input_dim=V_DIM, seed=3, device=dev
                                  ).fit(V, verbose=0), 2)
    samples_per_s = N * EPOCHS / (fit_ms / 1e3)
    log(f"RBM.fit {EPOCHS} epochs: {fit_ms:.3f} ms, {samples_per_s:.1f} samples/s")

    params = {n: t.contiguous() for n, t in rbm.params.items()}
    mask = torch.ones(N, device=dev)
    run = (params, V, mask, 99, LR, K, 0, BATCH, EPOCHS)
    launches_before = cd_gibbs.cd_train_cuda.launches
    kernel_ms = timed_ms(lambda: cd_gibbs.cd_train_cuda(*run), 3)
    check(cd_gibbs.last_launch()["route"] == "cluster", "the timed run's route")
    plain_ms = timed_ms(lambda: cd_gibbs.cd_train_torch(*run), 1)
    check(cd_gibbs.cd_train_cuda.launches == launches_before + 3, "timed launches")
    # The global route and the cluster route at 8 blocks beside it, in turns.
    routes = {"cluster 16": dict(route="cluster"), "global": dict(route="global"),
              "cluster 8": dict(route="cluster", cluster=8)}
    route_ms = {key: [] for key in routes}
    for key in list(routes) + list(routes)[::-1]:
        route_ms[key].append(timed_ms(lambda: cd_gibbs.cd_train_cuda(*run, **routes[key]), 1))
    steps = EPOCHS * N // BATCH
    for key, ms in route_ms.items():
        log(f"cd_gibbs {key:10s} at {N}x{V_DIM}x{H_DIM}, {EPOCHS} epochs: "
            f"{' / '.join(f'{t:.3f}' for t in ms)} ms, {min(ms) / steps * 1e3:.2f} us a step")
    # Where a step's time goes on each route: the probe build (%globaltimer
    # at each phase's end), 64 steps of the path's data.
    for key, kw in routes.items():
        split = cd_gibbs.phase_split(params, V[:64 * BATCH], mask[:64 * BATCH], 99, LR,
                                     K, 0, BATCH, 1, **kw)
        launch = split.pop("launch")
        log(f"phase split, {key} route ({launch['blocks']} blocks, batch tile "
            f"{launch['batch_tile']}), us a step: " + json.dumps(
                {k: round(v, 3) for k, v in split.items()}))

    flops = (2 * K + 3) * 2 * BATCH * V_DIM * H_DIM * steps
    nbytes = 4 * (N * V_DIM + N + 2 * (V_DIM * H_DIM + V_DIM + H_DIM) + steps)
    peak_f32, _, peak_bw = peaks(name)
    bound_flops_ms, bound_bytes_ms = flops / peak_f32 * 1e3, nbytes / peak_bw * 1e3
    bound_ms = max(bound_flops_ms, bound_bytes_ms)
    log(f"cd_gibbs at {N}x{V_DIM}x{H_DIM}, batch {BATCH}, {EPOCHS} epochs: "
        f"kernel {kernel_ms:.3f} ms ({kernel_ms / steps * 1e3:.2f} us a step), plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
        f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); "
        f"{flops / kernel_ms / 1e9:.2f} TFLOP/s achieved; global route "
        f"{min(route_ms['global']):.3f} ms")
    fitted = {n: t.clone() for n, t in rbm.params.items()}
    return {
        "name": "cd_gibbs",
        "route": "cuda",
        "source": "ku_torch/csrc/cd_gibbs.cu",
        "replaces": "ku/pallas/cd_gibbs.py:90",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        # The RBM path is not profiled: one launch is the whole fit, and
        # `ms` is timed at the path's own shape (the cluster route, which
        # the path launches); the global route beside it.
        "path_ms": None,
        "global_route_ms": min(route_ms["global"]),
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if bound_flops_ms >= bound_bytes_ms else "bytes",
        # No single PyTorch call computes a CD-k training run.
        "library_ms": None,
    }, V, fitted, kernel_ms


# ---------------------------------------------------------------------------
# The data-parallel RBM path (phases 20-22).
# ---------------------------------------------------------------------------

DP_STEP_KERNELS = (cd_gibbs_dp.cd_dp_stats_cuda, cd_gibbs_dp.cd_dp_apply_cuda)
DP_WORLD = 4  # ranks emulated in one process
NVLINK_BW = 450e9  # bytes/s each way between two H100 SXM cards


def dp_counts():
    return tuple(f.launches for f in DP_STEP_KERNELS)


def assert_params(got, want, tol, what):
    for n in want:
        torch.testing.assert_close(got[n], want[n], rtol=tol[0], atol=tol[1],
                                   msg=f"{n}, {what}")


def dp_against_plain(dev) -> float:
    """Phase 20, kernel #2 against its plain version at W = 1 and W = 4
    emulated, on both routes; returns the largest abs difference seen."""
    worst = 0.0
    # (mode, k, saturated, steps, epochs), at the RBM's shape.
    cases = [(0, k, True, 4, 2) for k in (1, 2)]
    cases += [(mode, 1, False, 3, 1) for mode in (0, 1, 2)]
    for mode, k, saturated, steps, epochs in cases:
        params, v_all, mask = problem(dev, V_DIM, H_DIM, BATCH, steps, mode,
                                      saturated, seed=20 + mode)
        for world in (1, DP_WORLD):
            args = (world, params, v_all, mask, 4321, LR, k, mode, BATCH, epochs)
            p_p, s_p = cd_gibbs_dp.cd_train_dp_emulated(*args, plain=True)
            for route in cd_gibbs.ROUTES:
                p_k, s_k = cd_gibbs_dp.cd_train_dp_emulated(*args, route=route)
                torch.cuda.synchronize()
                check(cd_gibbs_dp.last_launch()["route"] == route, f"DP route {route}")
                what = f"W {world}, mode {mode}, k {k}, {route} route"
                assert_params(p_k, p_p, (1e-5, 1e-5), what)
                s_tol = (1e-5, 1e-5) if saturated else (1e-4, 1e-4)
                torch.testing.assert_close(s_k, s_p, rtol=s_tol[0], atol=s_tol[1],
                                           msg=f"scores, {what}")
                p_diff = max(float((p_k[n] - p_p[n]).abs().max()) for n in p_k)
                s_diff = float((s_k - s_p).abs().max())
                worst = max(worst, p_diff, s_diff)
                log(f"cd_gibbs_dp vs plain: {what} saturated {saturated} steps "
                    f"{steps * epochs}: max abs diff params {p_diff:.3e}, scores "
                    f"{s_diff:.3e}")
    return worst


def dp_against_kernel_one(dev, V):
    """Phase 20, kernel #2 against kernel #1: W = 1 at the path's shape over
    its 3 epochs, bit for bit, on each route; W = 4 emulated in saturation
    over 2 epochs and on random parameters over 3 steps."""
    params, _, _ = problem(dev, V_DIM, H_DIM, BATCH, 1, 0, False, seed=30)
    mask = torch.ones(N, device=dev)
    args = (params, V, mask, 2024, LR, K, 0, BATCH, EPOCHS)
    for route in cd_gibbs.ROUTES:
        p_dp, s_dp = cd_gibbs_dp.cd_train_dp_emulated(1, *args, route=route)
        p_1, s_1 = cd_gibbs.cd_train_cuda(*args, route=route)
        torch.cuda.synchronize()
        check(cd_gibbs.last_launch()["route"] == route
              and cd_gibbs_dp.last_launch()["route"] == route, f"routes, {route}")
        same = all(torch.equal(p_dp[n], p_1[n]) for n in p_1) and torch.equal(s_dp, s_1)
        diff = max(float((p_dp[n] - p_1[n]).abs().max()) for n in p_1)
        log(f"cd_gibbs_dp W 1 vs cd_gibbs at {N}x{V_DIM}x{H_DIM}, {EPOCHS} epochs, "
            f"{route} route: bit for bit {same} (max abs diff params {diff:.3e}, scores "
            f"{float((s_dp - s_1).abs().max()):.3e})")
        check(same, f"kernel #2 at world size 1 differs from kernel #1 ({route} route)")
    for saturated, steps, epochs in ((True, 4, 2), (False, 3, 1)):
        params, v_all, mask = problem(dev, V_DIM, H_DIM, BATCH, steps, 0,
                                      saturated, seed=31)
        args = (params, v_all, mask, 4321, LR, K, 0, BATCH, epochs)
        p_dp, s_dp = cd_gibbs_dp.cd_train_dp_emulated(DP_WORLD, *args)
        p_1, s_1 = cd_gibbs.cd_train_cuda(*args)
        torch.cuda.synchronize()
        what = f"W {DP_WORLD} vs kernel #1, saturated {saturated}"
        assert_params(p_dp, p_1, (1e-5, 1e-5), what)
        torch.testing.assert_close(s_dp, s_1, rtol=1e-4, atol=1e-4, msg=what)
        log(f"cd_gibbs_dp {what}, {steps * epochs} steps: max abs diff params "
            f"{max(float((p_dp[n] - p_1[n]).abs().max()) for n in p_1):.3e}, "
            f"scores {float((s_dp - s_1).abs().max()):.3e}")


def dp_path(dev, name, V, fitted, kernel_one_ms) -> dict:
    """Phases 20-22; returns kernel #2's entry of the `kernels` line."""
    # 20. Kernel #2 against its plain version and against kernel #1.
    max_abs_err = dp_against_plain(dev)
    dp_against_kernel_one(dev, V)

    # 21. The path: RBM.fit(mesh=) in an NCCL world of one process.
    probe = V[:4096]
    mesh = make_mesh()
    try:
        log(f"mesh: {mesh}, backend {dist.get_backend()}, world "
            f"{dist.get_world_size()}")
        cd_gibbs.cd_train_cuda.launches = 0
        for f in DP_STEP_KERNELS:
            f.launches = 0
        cd_gibbs_dp.cd_dp_stats_cuda.by_route = {r: 0 for r in cd_gibbs.ROUTES}
        rbm = RBM({"lr": LR, "batch_size": BATCH, "epochs": EPOCHS}, H_DIM,
                  input_dim=V_DIM, seed=0, device=dev)
        err_before = recon_error(rbm, probe)
        rbm.fit(V, mesh=mesh)
        torch.cuda.synchronize()
        err_after = recon_error(rbm, probe)
        steps = EPOCHS * N // BATCH
        scores = rbm.last_scores
        check(dp_counts() == (steps, steps),
              f"expected {steps} launches of each step kernel, got {dp_counts()}")
        check(cd_gibbs.cd_train_cuda.launches == 0, "the mesh fit launched kernel #1")
        check(scores.shape == (steps,), f"scores shape {scores.shape}")
        check(bool(torch.isfinite(scores).all()), "non-finite score")
        check(err_after < err_before,
              f"reconstruction error did not fall: {err_before} -> {err_after}")
        same = all(torch.equal(rbm.params[n], fitted[n]) for n in fitted)
        log(f"RBM.fit(mesh=make_mesh()): reconstruction error {err_before:.4f} -> "
            f"{err_after:.4f}, score first/last epoch "
            f"{float(scores[:N // BATCH].mean()):.4f} / "
            f"{float(scores[-(N // BATCH):].mean()):.4f}; params equal phase 4's "
            f"single-device fit bit for bit: {same}")
        check(same, "the mesh fit differs from phase 4's single-device fit")

        dbn = DBN()
        dbn.add_stack(RBM({"lr": LR, "batch_size": BATCH, "epochs": 1}, 256,
                          seed=1, device=dev))
        dbn.add_stack(RBM({"lr": LR, "batch_size": BATCH, "epochs": 1}, 128,
                          seed=2, device=dev))
        dbn.fit(V, mesh=mesh)
        h = dbn.transform(V)
        torch.cuda.synchronize()
        check(h.shape == (N, 128), f"DBN transform shape {h.shape}")
        for layer in dbn.rbm_layers:
            check(bool(torch.isfinite(layer.last_scores).all()), "non-finite DBN score")
        steps_all = steps + 2 * N // BATCH
        check(dp_counts() == (steps_all, steps_all),
              f"expected {steps_all} launches of each step kernel, got {dp_counts()}")
        check(cd_gibbs.cd_train_cuda.launches == 0, "the mesh DBN launched kernel #1")
        by_route = dict(cd_gibbs_dp.cd_dp_stats_cuda.by_route)
        check(by_route == {"global": 0, "cluster": steps_all},
              f"the statistics launches by route: {by_route}")
        launches = sum(dp_counts())
        log(f"DBN 784-256-128 with mesh=: transform {tuple(h.shape)}, mean "
            f"activation {float(h.mean()):.4f}; step-kernel launches on the main "
            f"path: {dp_counts()} (stats, apply), kernel #1: 0; statistics by route "
            f"{by_route}, the last {cd_gibbs_dp.last_launch()}")

        # 22. Timing: the fit at W = 1 beside RBM.fit's, in turns.
        hps = {"lr": LR, "batch_size": BATCH, "epochs": EPOCHS}
        fits = {"mesh": lambda: RBM(hps, H_DIM, input_dim=V_DIM, seed=3,
                                    device=dev).fit(V, verbose=0, mesh=mesh),
                "single": lambda: RBM(hps, H_DIM, input_dim=V_DIM, seed=3,
                                      device=dev).fit(V, verbose=0)}
        fit_ms = {k: [] for k in fits}
        for key in ("single", "mesh", "mesh", "single"):
            fit_ms[key].append(timed_ms(fits[key], 1))
        for key, ms in fit_ms.items():
            log(f"RBM.fit {key:6s} {EPOCHS} epochs: {ms[0]:.3f} / {ms[1]:.3f} ms, "
                f"{N * EPOCHS / (min(ms) / 1e3):.1f} samples/s (best)")
        params = {n: t.clone() for n, t in fitted.items()}
        mask = torch.ones(N, device=dev)
        run_ms = timed_ms(lambda: cd_gibbs_dp.cd_train_dp(
            mesh, params, V, mask, 99, LR, K, 0, BATCH, EPOCHS), 2)
        log(f"cd_train_dp {EPOCHS} epochs at W 1: {run_ms:.3f} ms, "
            f"{run_ms / steps * 1e3:.2f} us a step; kernel #1's run (phase 5) "
            f"{kernel_one_ms:.3f} ms, {kernel_one_ms / steps * 1e3:.2f} us a step")

        # A profile of about 20 steps of the run.
        prof_steps = 20
        v20, m20 = V[:prof_steps * BATCH], mask[:prof_steps * BATCH]
        wall, rows, clocks = profiled(lambda: cd_gibbs_dp.cd_train_dp(
            mesh, params, v20, m20, 5, LR, K, 0, BATCH, 1))
        log_profile(f"{prof_steps} data-parallel CD steps, W 1", wall, rows,
                    clocks, steps=prof_steps)
        stats_path = per_launch_ms(rows, "cd_dp_stats")
        apply_path = per_launch_ms(rows, "cd_dp_apply")
        nccl = [r for r in rows if "nccl" in r[2].lower()]
        allreduce_ms = (sum(r[0] for r in nccl) / sum(r[1] for r in nccl) / 1e3
                        if nccl else None)
        log(f"on the path: stats {stats_path:.4f} ms, apply {apply_path:.4f} ms, "
            f"all-reduce {allreduce_ms if allreduce_ms is None else round(allreduce_ms, 6)}"
            f" ms a step (device time; {', '.join(r[2][:60] for r in nccl) or 'no NCCL kernel'}); "
            f"host {wall / prof_steps * 1e3:.3f} ms a step")

        # Host time of a step's three calls, as the run makes them, each
        # timed alone on the host clock (no synchronise inside the loop).
        n = min(200, N // BATCH)
        v_steps, m_steps = V[:n * BATCH].view(n, BATCH, V_DIM), mask[:n * BATCH].view(n, BATCH)
        stats = cd_gibbs_dp.stats_launcher(params, v_steps, m_steps, 5, K, 0, 0,
                                           cd_gibbs_dp.workspace(BATCH, V_DIM, H_DIM, dev))
        apply = cd_gibbs_dp.apply_launcher(params, LR, torch.zeros(n, device=dev))
        group = mesh.get_group("data")
        host = np.zeros(3)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for t in range(n):
            t0 = time.perf_counter()
            buf = stats(t, t)
            t1 = time.perf_counter()
            dist.all_reduce(buf, group=group)
            t2 = time.perf_counter()
            apply(buf, t)
            host += (t1 - t0, t2 - t1, time.perf_counter() - t2)
        enqueued = time.perf_counter() - start
        torch.cuda.synchronize()
        done = time.perf_counter() - start
        host_us = host / n * 1e6
        log(f"host a step over {n} steps: stats launch {host_us[0]:.1f} us, "
            f"all_reduce {host_us[1]:.1f} us, apply launch {host_us[2]:.1f} us "
            f"(loop {enqueued / n * 1e6:.1f} us a step to enqueue, "
            f"{done / n * 1e6:.1f} us a step to finish)")
    finally:
        dist.destroy_process_group()

    # The step kernels alone at the path's shape (W = 1: 128 rows), cold.
    step_v, step_m = V[:BATCH], torch.ones(BATCH, device=dev)
    work = cd_gibbs_dp.workspace(BATCH, V_DIM, H_DIM, dev)
    one = torch.zeros(1, device=dev)

    def step(stats, apply, **kw):
        buf = stats(params, step_v, step_m, 7, 0, K, 0, 0, **kw)
        apply(params, buf, LR, one, 0)

    kernels = lambda: step(*DP_STEP_KERNELS, work=work)  # noqa: E731
    plain = lambda: step(cd_gibbs_dp.cd_dp_stats_torch,  # noqa: E731
                         cd_gibbs_dp.cd_dp_apply_torch)
    kernels()
    plain()
    ms = timed_cold_ms(kernels, 20)
    check(cd_gibbs_dp.last_launch()["route"] == "cluster", "the timed step's route")
    stats_ms = timed_cold_ms(lambda: DP_STEP_KERNELS[0](
        params, step_v, step_m, 7, 0, K, 0, 0, work=work), 20)
    global_ms = timed_cold_ms(lambda: step(*DP_STEP_KERNELS, work=work, route="global"), 20)
    check(cd_gibbs_dp.last_launch()["route"] == "global", "the global step's route")
    plain_ms = timed_ms(plain, 5)

    flops = (2 * K + 3) * 2 * BATCH * V_DIM * H_DIM
    nbytes = 4 * (BATCH * V_DIM + BATCH + 2 * (V_DIM * H_DIM + V_DIM + H_DIM) + 1)
    peak_f32, _, peak_bw = peaks(name)
    # A rank's step also moves 2(W-1)/W of the payload over NVLink: nothing
    # at W = 1, the world this card runs.
    payload = 4 * cd_gibbs_dp.payload_size(V_DIM, H_DIM)
    bound_flops_ms, bound_bytes_ms = flops / peak_f32 * 1e3, nbytes / peak_bw * 1e3
    bound_ms = max(bound_flops_ms, bound_bytes_ms)
    log(f"cd_gibbs_dp step at W 1 ({BATCH} rows, {V_DIM}x{H_DIM}): stats + apply "
        f"{ms:.4f} ms cold (stats alone {stats_ms:.4f}; on the global route stats + "
        f"apply {global_ms:.4f}), plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.6f} ms ({flops / 1e6:.1f} MFLOP, {nbytes / 1e6:.3f} MB, "
        f"payload {payload} bytes: {2 * (DP_WORLD - 1) / DP_WORLD * payload / NVLINK_BW * 1e3:.6f} ms "
        f"on NVLink at W 4)")
    return {
        "name": "cd_gibbs_dp",
        "route": "cuda",
        "source": "ku_torch/csrc/cd_gibbs_dp.cu",
        "replaces": "ku/pallas/cd_gibbs.py:310",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "path_ms": stats_path + apply_path,
        "global_route_ms": global_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if bound_flops_ms >= bound_bytes_ms else "bytes",
        # No single PyTorch call computes a CD step; the all-reduce's time is
        # logged above.
        "library_ms": None,
    }


# ---------------------------------------------------------------------------
# The serving path (phases 6-8).
# ---------------------------------------------------------------------------

# bf16: rtol just above one bf16 ulp (2^-7 of the value), for the output's
# own rounding, which can fall either way; atol for the probabilities'
# rounding to bf16 against another running max (2^-9 of each term).
TOLS = {torch.float32: dict(rtol=1e-4, atol=1e-4),
        torch.bfloat16: dict(rtol=1e-2, atol=2e-3)}


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def flash_case(dev, dtype, b, h, hkv, n, kn, d, *, dv=None, causal=True, window=None,
               softcap=None, segments=False, q_offset=None, k_offset=None,
               cache_view=False, q_layout=None, seed=0) -> float:
    """One flash forward, kernel against plain on the same inputs; the
    launch's route (bf16 up to 128 wide on the tensor cores, else the CUDA
    cores) and, on the tensor cores, its layout and copies checked: none in
    layouts "a" (rows) and "b" (the slot-minor cache read in place), each
    tensor not in rows copied in "c". `q_layout`: q in a layout the
    tensor-core kernel cannot read as it is (q_in_layout)."""
    dv = dv or d
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, n, d, generator=g, device=dev).to(dtype)
    if q_layout:
        q = q_in_layout(q, q_layout)
    if cache_view:  # the prefill's read of the slot-minor cache page
        k = torch.randn(b, hkv, d, kn, generator=g, device=dev).to(dtype).transpose(2, 3)
        v = torch.randn(b, hkv, dv, kn, generator=g, device=dev).to(dtype).transpose(2, 3)
    else:
        k = torch.randn(b, hkv, kn, d, generator=g, device=dev).to(dtype)
        v = torch.randn(b, hkv, kn, dv, generator=g, device=dev).to(dtype)
    seg = None
    if segments:
        seg = torch.sort(torch.randint(0, 4, (b, n), generator=g, device=dev),
                         dim=1).values.to(torch.int32)
    kw = dict(softmax_scale=1.0 / math.sqrt(h * d), causal=causal, window=window,
              segment_ids=seg, q_offset=q_offset, k_offset=k_offset,
              logit_softcap=softcap)
    route = fa.flash_route(dtype, d)
    layout = fa.flash_layout(q, k, v) if route == "mma" else None
    copies = fa.flash_fwd_cuda.copies
    o_k, lse_k = fa.flash_fwd_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    copied = fa.flash_fwd_cuda.copies - copies
    check((fa.flash_fwd_cuda.route, fa.flash_fwd_cuda.layout) == (route, layout),
          f"flash forward took {fa.flash_fwd_cuda.route}/{fa.flash_fwd_cuda.layout}, "
          f"not {route}/{layout}")
    check((copied > 0) == (layout == "c"), f"layout {layout} with {copied} copies")
    o_p, lse_p = fa.flash_fwd_torch(q, k, v, **kw)
    torch.testing.assert_close(o_k, o_p, **TOLS[dtype])
    torch.testing.assert_close(lse_k, lse_p, rtol=1e-4, atol=1e-4)
    diff = _max_diff(o_k, o_p)
    log(f"  flash {str(dtype)[6:]} ({route}{'/' + layout if layout else ''}, {copied} "
        f"copies) B{b} H{h}/{hkv} N{n} KN{kn} D{d} Dv{dv} causal {causal} window {window} "
        f"softcap {softcap} segments {segments} "
        f"offsets {'rows' if torch.is_tensor(q_offset) else q_offset} q layout "
        f"{q_layout or 'as made'}: max abs diff out {diff:.3e}, lse "
        f"{_max_diff(lse_k, lse_p):.3e}")
    return diff


# Lengths at every edge of the decode kernels' chunk plan (da.split_plan:
# chunks of 64 slots from 1 to 512 live slots, of 128 above), before the
# window and the window + 100 that each case adds.
SPLIT_EDGES = [0, -1, 1, 63, 64, 65, 511, 512, 513]


def check_decode_launch(q, k, v, kw, what):
    """The C entry's report of the launch just made: the copy route and the
    fold that the wrapper's plan (da.copy_route, da.fold_route) names, 8
    blocks a cluster."""
    launched = da.last_launch()
    route = da.copy_route(k, v, kw.get("k_scale"), kw.get("v_scale"))
    fold = da.fold_route(q, k, v)
    check(launched is not None and launched["route"] == route
          and launched["fold"] == fold and launched["s_split"] == da.S_SPLIT,
          f"{what} launched {launched}, not the {route} route and the {fold} fold over "
          f"{da.S_SPLIT} blocks")
    return launched


def decode_case(dev, dtype, b, hkv, g_, d, s, lengths, *, dv=None, softcap=None,
                int8=False, seed=0) -> float:
    """One flash-decoding read, kernel against plain on the same inputs; the
    launch's copy route (16-byte copies where S is a multiple of a 16-byte
    segment's slots, else element loads) as the C entry reports it."""
    dv = dv or d
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, hkv, g_, d, generator=g, device=dev).to(dtype)
    kw = dict(softmax_scale=1.0 / math.sqrt(hkv * g_ * d), logit_softcap=softcap)
    if int8:
        k = torch.randint(-127, 128, (b, hkv, d, s), generator=g, device=dev).to(torch.int8)
        v = torch.randint(-127, 128, (b, hkv, dv, s), generator=g, device=dev).to(torch.int8)
        kw["k_scale"] = torch.rand(b, hkv, s, generator=g, device=dev) * 0.02
        kw["v_scale"] = torch.rand(b, hkv, s, generator=g, device=dev) * 0.02
    else:
        k = torch.randn(b, hkv, d, s, generator=g, device=dev).to(dtype)
        v = torch.randn(b, hkv, dv, s, generator=g, device=dev).to(dtype)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    o_k = da.decode_attention_cuda(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    launched = check_decode_launch(q, k, v, kw, "decode")
    check(bool(torch.isfinite(o_k).all()), "decode kernel output is not finite")
    check(bool((o_k[lengths <= 0] == 0).all()), "a decode row of length <= 0 is not 0")
    o_p = da.decode_attention_torch(q, k, v, lengths, **kw)
    torch.testing.assert_close(o_k, o_p, **TOLS[dtype])
    diff = _max_diff(o_k, o_p)
    log(f"  decode {str(dtype)[6:]} ({launched['route']}, {launched['fold']}, "
        f"{launched['stages']} stages) "
        f"B{b} Hkv{hkv} G{g_} D{d} Dv{dv} S{s} int8 {int8} softcap {softcap} lengths "
        f"{lengths.tolist()}: max abs diff {diff:.3e}")
    return diff


def alone_and_in_a_batch(read, b, what):
    """Row i of read(slice(None)) equals read(slice(i, i + 1)), bit for bit:
    a row's output depends on its own length and slots alone."""
    batch = read(slice(None))
    for i in range(b):
        check(torch.equal(read(slice(i, i + 1)), batch[i:i + 1]),
              f"{what}: row {i} read alone differs from the same row in the batch")
    log(f"  {what}: each of {b} rows read alone equals the batch's row, bit for bit")


def serving_kernels_vs_plain(dev):
    """Phase 6; returns the largest abs difference of each kernel."""
    rows = torch.tensor([0, 64, 128, 7, 0, 64, 100, 33], dtype=torch.int32, device=dev)
    flash, decode = 0.0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        # The prefill's shapes: a 128-token chunk over the 1,024-slot page,
        # first at offset 0 (generate), then at per-row offsets (later
        # chunked rounds of the batcher).
        flash = max(flash, flash_case(dev, dtype, GEN_B, LM_HEADS, LM_KV_HEADS, GEN_P,
                                      LM_MAX_LEN, 128, q_offset=0, cache_view=True))
        flash = max(flash, flash_case(dev, dtype, GEN_B, LM_HEADS, LM_KV_HEADS,
                                      CB_PROMPT_LEN, LM_MAX_LEN, 128, q_offset=rows,
                                      cache_view=True, seed=1))
        # Ragged shapes and every mask.
        flash = max(flash, flash_case(dev, dtype, 2, 4, 4, 37, 53, 64, window=7,
                                      softcap=1.5, q_offset=torch.tensor(
                                          [16, 3], dtype=torch.int32, device=dev),
                                      seed=2))
        flash = max(flash, flash_case(dev, dtype, 2, 4, 1, 70, 70, 32, segments=True,
                                      q_offset=3, k_offset=1, seed=3))
        flash = max(flash, flash_case(dev, dtype, 1, 3, 3, 5, 130, 128, causal=False,
                                      seed=4))
        # Rows with no live key (written as 0): queries 0..9 of row 0 inside
        # a visited tile, all of row 1 with no tile visited.
        flash = max(flash, flash_case(dev, dtype, 2, 2, 1, 70, 70, 32, k_offset=10,
                                      q_offset=torch.tensor([0, -80], dtype=torch.int32,
                                                            device=dev), seed=5))
        # Widths the tensor-core tiles zero-fill; a slot-minor cache whose
        # width is not a multiple of 8 and q in two layouts, all three copied
        # for the tensor cores (layout "c"); a bf16 head wider than 128 (the
        # CUDA cores, by shape).
        flash = max(flash, flash_case(dev, dtype, 2, 4, 2, 70, 90, 40, dv=24, window=30,
                                      seed=6))
        flash = max(flash, flash_case(dev, dtype, 1, 2, 2, 64, 128, 36, dv=12, seed=7))
        flash = max(flash, flash_case(dev, dtype, 2, 4, 2, 33, 203, 128, cache_view=True,
                                      q_offset=torch.tensor([0, 150], dtype=torch.int32,
                                                            device=dev), seed=8))
        flash = max(flash, flash_case(dev, dtype, 1, 4, 2, 65, 65, 64, q_layout="strided",
                                      seed=9))
        flash = max(flash, flash_case(dev, dtype, 1, 2, 1, 40, 70, 64, q_layout="offset",
                                      softcap=5.0, seed=10))
        flash = max(flash, flash_case(dev, dtype, 1, 2, 1, 50, 70, 160, dv=128, seed=11))
        # Causal with no segments, window or ragged edge, rows along D (layout
        # "a"): the key tiles below the diagonal are full and test no pair.
        flash = max(flash, flash_case(dev, dtype, 2, 4, 2, 256, 256, 128, seed=12))
        # The decode step's shape: 8 rows, 4 KV heads of 4 query heads each,
        # the 1,024-slot cache, ragged live prefixes.
        decode = max(decode, decode_case(dev, dtype, GEN_B, LM_KV_HEADS, 4, 128,
                                         LM_MAX_LEN, [64, 100, 128, 200, 257, 300,
                                                      383, 1024]))
        decode = max(decode, decode_case(dev, dtype, 3, 2, 1, 64, 300, [1, 300, 129],
                                         softcap=2.0, seed=1))
        decode = max(decode, decode_case(dev, dtype, 3, 2, 4, 64, 130, [0, 130, -1],
                                         seed=3))
        decode = max(decode, decode_case(dev, dtype, 2, 2, 4, 80, 77, [77, 5],
                                         int8=True, seed=2))
        # Every edge of the chunk plan, both copy routes: G 4, 1 and 16, Dv
        # < D, int8 with softcap; S 77 and 130 take the element loads.
        for s, g_, d, dv, int8, seed in ((LM_MAX_LEN, 4, 128, 128, False, 20),
                                         (LM_MAX_LEN, 1, 64, 64, False, 21),
                                         (LM_MAX_LEN, 16, 64, 32, False, 22),
                                         (LM_MAX_LEN, 4, 128, 96, True, 23),
                                         (77, 4, 64, 48, False, 24),
                                         (130, 16, 32, 32, True, 25)):
            decode = max(decode, decode_case(
                dev, dtype, len(SPLIT_EDGES) + 2, 2, g_, d, s, SPLIT_EDGES + [s, s + 100],
                dv=dv, softcap=2.0 if int8 else None, int8=int8, seed=seed))
    # A row of the decode step's shape reads alike alone and in the batch.
    g = torch.Generator(device=dev).manual_seed(26)
    q = torch.randn(GEN_B, LM_KV_HEADS, 4, 128, generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(GEN_B, LM_KV_HEADS, 128, LM_MAX_LEN, generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    lengths = torch.tensor([1, 64, 200, 511, 513, 700, 1000, 1024], dtype=torch.int32,
                           device=dev)
    alone_and_in_a_batch(lambda i: da.decode_attention_cuda(q[i], k[i], v[i], lengths[i]),
                         GEN_B, "decode bf16 at S 1,024")
    return flash, decode


class LM(torch.nn.Module):
    """The serving LM: LM_BLOCKS Transformer blocks named as ku names them
    (``block{i}``), following the cache protocol; ``block_mask``, when set,
    goes to every block (the block-sparse phases)."""

    def __init__(self, generator):
        super().__init__()
        self.block_mask = None
        for i in range(LM_BLOCKS):
            self.add_module(f"block{i}", Transformer(
                LM_HEADS, LM_D, 0.0, causal=True, rope=True, num_kv_head=LM_KV_HEADS,
                max_decode_len=LM_MAX_LEN, use_flash=True, device=DEVICE,
                dtype=torch.float32, generator=generator))

    def forward(self, xs, decode=False, prompt_lengths=None, cache=None,
                deterministic=True):
        x = xs[0]
        for i in range(LM_BLOCKS):
            out = getattr(self, f"block{i}")([x], deterministic=deterministic,
                                             decode=decode,
                                             block_mask=self.block_mask,
                                             prompt_lengths=prompt_lengths,
                                             cache=cache, scope=f"block{i}")
            x, cache = out if decode else (out, cache)
        return (x, cache) if decode else x


def zero_counts():
    for k in (fa.flash_fwd_cuda,) + BWD_KERNELS + DECODE_KERNELS + SPARSE_KERNELS:
        k.launches = 0


def counts():
    """(flash, dense decode, paged decode) launches since zero_counts()."""
    return (fa.flash_fwd_cuda.launches, da.decode_attention_cuda.launches,
            da.decode_attention_paged_cuda.launches)


def set_cache(model, max_decode_len, kv_page_size=None, kv_num_pages=None,
              kv_cache_dtype=None):
    """Re-shape every attention layer's KV cache (the weights stay): dense or
    paged, f32/bf16 or int8, for the next cache the model creates."""
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.max_decode_len = max_decode_len
            m.kv_page_size, m.kv_num_pages = kv_page_size, kv_num_pages
            m.kv_cache_dtype = kv_cache_dtype


def set_attention_paths(model, kernels: bool):
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.use_flash = kernels
            m.flash_decode = None if kernels else False


@torch.no_grad()
def f32_kernels_vs_plain(lm32, table32, prompts, lens, steps=16) -> float:
    """Phase 7a: the f32 model through the kernels, then the plain paths, on
    the same prompts and the same fed tokens."""
    g = torch.Generator(device=DEVICE).manual_seed(5)
    fed = torch.randint(0, LM_VOCAB, (GEN_B, steps), generator=g, device=DEVICE)

    def run(kernels):
        set_attention_paths(lm32, kernels)
        y, cache = lm32([table32[prompts]], decode=True, cache={},
                        prompt_lengths=lens)
        outs = [y]
        for i in range(steps):
            y, cache = lm32([table32[fed[:, i:i + 1]]], decode=True, cache=cache)
            outs.append(y)
        torch.cuda.synchronize()
        return outs

    before = (fa.flash_fwd_cuda.launches, da.decode_attention_cuda.launches)
    through_kernels = run(True)
    check(fa.flash_fwd_cuda.launches - before[0] == 2 * LM_BLOCKS
          and da.decode_attention_cuda.launches - before[1] == 2 * LM_BLOCKS * steps,
          "f32 kernel run did not go through both kernels")
    plain = run(False)
    set_attention_paths(lm32, True)
    worst = 0.0
    for i, (a, b) in enumerate(zip(through_kernels, plain)):
        check(bool(torch.isfinite(a).all()), f"non-finite f32 output at step {i}")
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4,
                                   msg=f"f32 kernels vs plain, step {i}")
        worst = max(worst, _max_diff(a, b))
    log(f"f32 LM ({LM_BLOCKS} x d{LM_D}, GQA {LM_HEADS}/{LM_KV_HEADS}), prefill + "
        f"{steps} decode steps, kernels vs plain paths: max abs diff {worst:.3e} "
        f"(largest output {float(through_kernels[-1].abs().max()):.3e})")
    return worst


def flash_bound(b, h, hkv, n, d, q_off, itemsize, peak_bf16, peak_bw):
    """(bound ms, bound_by) of one causal prefill at per-row offsets q_off:
    4·B·H·(live pairs)·D operations; Q, O, LSE and the live K/V once."""
    q_off = np.asarray(q_off, np.int64)
    pairs = int(sum(int(o) * n + n * (n + 1) // 2 for o in q_off))
    flops = 4 * h * pairs * d
    live_keys = int((q_off + n).sum())
    nbytes = (2 * b * h * n * d * itemsize + b * h * n * 4
              + 2 * hkv * live_keys * d * itemsize)
    t_ops, t_bytes = flops / peak_bf16 * 1e3, nbytes / peak_bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def decode_bytes(b, h, hkv, d, lengths, itemsize) -> int:
    """The bytes one decode step must move: q and the output once, each
    row's live K/V slots once."""
    live = int(np.asarray(lengths, np.int64).sum())
    return 2 * b * h * d * itemsize + 2 * hkv * live * d * itemsize


def decode_bound(b, h, hkv, d, lengths, itemsize, peak_bf16, peak_bw):
    """(bound ms, bound_by) of one decode step: 4·H·len·D operations per row,
    or decode_bytes at the memory rate."""
    flops = 4 * h * int(np.asarray(lengths, np.int64).sum()) * d
    t_ops = flops / peak_bf16 * 1e3
    t_bytes = decode_bytes(b, h, hkv, d, lengths, itemsize) / peak_bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def host_us(fn, reps=200, rounds=5) -> float:
    """Host microseconds a call of fn: the median over `rounds` of `reps`
    calls back to back (after a synchronise, none inside: fewer launches
    than the card's queue holds, so no call waits on the device)."""
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times))


def length_sweep(dev, lengths=(0, 1, 64, 256, 1024, 4096, 16384), reps=100):
    """The dense decode kernel alone at the path's widths (bf16, B 8, Hkv 4,
    G 4, D 128) with every row at one length, cold in L2: its time against
    the live bytes, and the least-squares line ms = fixed + bytes / rate
    over the lengths of 64 and more, which parts the kernel's fixed cost
    (launch, the chain of dependent loads, the cluster's barriers and
    merge) from its streaming rate. Length 0 times the skeleton alone (no
    tile, the merge of empty partials); length 1 one tile's chain."""
    g = torch.Generator(device=dev).manual_seed(13)
    bf, hd, s = torch.bfloat16, LM_D // LM_HEADS, max(lengths)
    q = torch.randn(GEN_B, LM_KV_HEADS, 4, hd, generator=g, device=dev).to(bf)
    k, v = (torch.randn(GEN_B, LM_KV_HEADS, hd, s, generator=g, device=dev).to(bf)
            for _ in range(2))
    rows = []
    for n in lengths:
        lens = torch.full((GEN_B,), n, dtype=torch.int32, device=dev)
        ms = timed_cold_ms(lambda: da.decode_attention_cuda(q, k, v, lens), reps)
        launched = da.last_launch()
        mb = decode_bytes(GEN_B, LM_HEADS, LM_KV_HEADS, hd, [n] * GEN_B, 2) / 1e6
        rows.append((n, mb, ms))
        log(f"  decode length sweep: {n} slots a row, {mb:.3f} MB, {launched['stages']} "
            f"stages: {ms:.4f} ms cold, {mb / ms:.1f} GB/s")
    mbs, mss = (np.array([r[i] for r in rows if r[0] >= 64]) for i in (1, 2))
    slope, fixed = np.polyfit(mbs, mss, 1)
    log(f"  decode length sweep fit: {fixed * 1e3:.2f} us fixed + {1 / slope:.1f} GB/s "
        f"streaming")
    del k, v


def decode_host_us(paged, q, k, v, lengths, table=None) -> dict:
    """Host µs a launch of a decode wrapper, and of each of its parts: the
    contract check (`_check`), the launch check (`_check_launch`), the
    output's `torch.empty`, the stream lookup, and the C entry through
    ctypes with its arguments made beforehand; beside them the stream
    lookup that the wrapper made before."""
    lib = da._library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty(*q.shape[:3], v.shape[2], dtype=q.dtype, device=q.device)
    scale, codes = 1.0 / math.sqrt(q.shape[-1]), (da._DTYPE_CODES[q.dtype],
                                                  da._DTYPE_CODES[k.dtype])
    ptrs = [t.data_ptr() for t in (q, k, v)]
    if paged:
        tensors, int32s = [q, k, v, table, lengths], [("lengths", lengths),
                                                      ("page_table", table)]
        args = (*ptrs, table.data_ptr(), lengths.data_ptr(), None, None, out.data_ptr(),
                *q.shape[:4], v.shape[2], k.shape[3], table.shape[1], scale, 0.0, *codes,
                stream)
        entry, wrapper = lib.decode_attention_paged_launch, (
            lambda: da.decode_attention_paged_cuda(q, k, v, table, lengths))
    else:
        tensors, int32s = [q, k, v, lengths], [("lengths", lengths)]
        args = (*ptrs, lengths.data_ptr(), None, None, out.data_ptr(), *q.shape[:4],
                v.shape[2], k.shape[3], scale, 0.0, *codes, stream)
        entry, wrapper = lib.decode_attention_launch, (
            lambda: da.decode_attention_cuda(q, k, v, lengths))
    shape = (*q.shape[:3], v.shape[2])
    parts = {
        "_check": lambda: da._check(q, k, v, lengths, None, None, table),
        "_check_launch": lambda: da._check_launch("decode", q, v, tensors, int32s,
                                                  None, None),
        "torch.empty": lambda: torch.empty(*shape, dtype=q.dtype, device=q.device),
        "stream": lambda: da._stream(q),
        "ctypes call": lambda: entry(*args),
        "wrapper": wrapper,
        # The stream lookup the wrapper made before, in place of "stream".
        "current_stream (former)": lambda: torch.cuda.current_stream(q.device).cuda_stream,
    }
    return {name: host_us(fn) for name, fn in parts.items()}


def decode_ptxas(report):
    """[(instantiation, registers, spill store bytes, spill load bytes)] of
    the decode kernel from nvcc's -Xptxas -v output."""
    names = {"f": "float", "a": "int8", "13__nv_bfloat16": "bf16"}
    out, kernel, spills = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '\w*?decode_split_kernelI"
                      r"(f|13__nv_bfloat16)(f|a|S\d*_)Li(\d+)ENS_\d+(\w+?Rows)ELb([01])ELb([01])E",
                      line)
        if m:
            kv = names.get(m[2], names[m[1]])
            kernel = (f"<{names[m[1]]}, {kv}, {m[3]}, {m[4]}, "
                      f"{('element', '16-byte')[int(m[5])]}, {da.fold(int(m[6]))}>")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m[1]), int(m[2]))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.append((kernel, int(m[1])) + spills)
            kernel = None
    return out


def profiled(fn, attempts=3):
    """Run fn once under torch.profiler while a thread samples the SM clock
    with nvidia-smi; returns (host wall s, device rows (us, count, name)
    sorted by time, SM clock samples in MHz). A window that records no
    device event at all runs fn again, up to `attempts` times (phase 8's
    window over 64 standalone decode launches once showed no launch of the
    kernel); the callers' checks then read the last window."""
    for attempt in range(1, attempts + 1):
        wall, rows, clocks = profile_once(fn)
        if rows:
            break
        log(f"profile window {attempt} recorded no device event")
    return wall, rows, clocks


def profile_once(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    clocks, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True).stdout.split()
            clocks.extend(int(x) for x in out[:1] if x.isdigit())

    sampler = threading.Thread(target=sample)
    sampler.start()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = wall_s(fn)
    finally:
        stop.set()
        sampler.join()
    # Device-side events only (kernels, copies); the host ops that launched
    # them carry the same time again.
    rows = [(getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0), e.count, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return wall, sorted((r for r in rows if r[0] > 0), reverse=True), clocks


def clock_range(clocks) -> str:
    return (f"{min(clocks)}..{max(clocks)} MHz over {len(clocks)} samples"
            if clocks else "not sampled")


def per_launch_ms(rows, kernel: str) -> float:
    """Device ms per launch of the kernels whose name holds `kernel`."""
    us = sum(r[0] for r in rows if kernel in r[2])
    count = sum(r[1] for r in rows if kernel in r[2])
    check(count > 0, f"the profile shows no launch of {kernel}: {len(rows)} device rows"
          + (f", the first {rows[0][2][:120]!r}" if rows else ""))
    return us / count / 1e3


def log_profile(what, wall, rows, clocks, steps=1):
    busy_us = sum(r[0] for r in rows)
    log(f"profile, {what}: wall {wall * 1e3 / steps:.3f} ms a step, device busy "
        f"{busy_us / steps / 1e3:.3f} ms a step ({busy_us / (wall * 1e6):.3f} of the "
        f"wall time), {sum(r[1] for r in rows) / steps:.0f} device ops a step; "
        f"SM clock {clock_range(clocks)}")
    for us, count, key in rows[:8]:
        log(f"  {us / steps:9.1f} us a step  {count // steps:5d} x  {key[:90]}")


@torch.no_grad()
def profile_path(lm, embed, readout, prompts, lens, steps=8, decode_key="DenseRows"):
    """Where the path's time goes: one prefill, then `steps` greedy decode
    steps, each under the profiler. Returns the device ms per launch of the
    flash kernel (prefill) and of the decode kernel whose name holds
    `decode_key` (decode steps: DenseRows or PagedRows)."""
    x0 = embed(prompts)
    prefill = lambda: lm([x0], decode=True, cache={}, prompt_lengths=lens)  # noqa: E731
    prefill()  # warm the profiler's first-use costs out of the window
    wall, rows, clocks = profiled(prefill)
    log_profile("one prefill", wall, rows, clocks)
    check(not any("flash_fwd_kernel" in r[2] for r in rows),
          "the CUDA-core flash forward ran in the bf16 prefill")
    flash_path_ms = per_launch_ms(rows, "flash_fwd_wgmma_kernel")

    y, cache = prefill()
    tok = readout(y[torch.arange(GEN_B, device=y.device), lens.long() - 1][:, None]
                  )[:, 0].argmax(-1)

    def run():
        nonlocal cache, tok
        for _ in range(steps):
            y, cache = lm([embed(tok[:, None])], decode=True, cache=cache)
            tok = readout(y)[:, 0].argmax(-1)

    run()
    wall, rows, clocks = profiled(run)
    log_profile(f"{steps} decode steps", wall, rows, clocks, steps)
    return flash_path_ms, per_launch_ms(rows, decode_key)

# ---------------------------------------------------------------------------
# The paged cache (phases 9-13).
# ---------------------------------------------------------------------------


def paged_case(dev, dtype, pg, mp, lengths, *, int8=False, softcap=None,
               seed=0) -> float:
    """One paged read, kernel against plain on the same inputs: B·MP + 1
    pool pages in permuted order, the page no row owns poisoned with NaN
    (its scales, for int8 pools) and every dead table entry pointing at
    it."""
    b, hkv, g_, d = len(lengths), LM_KV_HEADS, LM_HEADS // LM_KV_HEADS, LM_D // LM_HEADS
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pool = b * mp + 1
    order = torch.randperm(n_pool, generator=g, device=dev)
    poison, tbl = order[-1], order[:-1].view(b, mp).to(torch.int32)
    for row, n in enumerate(lengths):
        tbl[row, max(0, -(-n // pg)):] = poison
    q = torch.randn(b, hkv, g_, d, generator=g, device=dev).to(dtype)
    kw = dict(softmax_scale=1.0 / math.sqrt(LM_D), logit_softcap=softcap)
    if int8:
        k = torch.randint(-127, 128, (n_pool, hkv, d, pg), generator=g, device=dev).to(torch.int8)
        v = torch.randint(-127, 128, (n_pool, hkv, d, pg), generator=g, device=dev).to(torch.int8)
        kw["k_scale"] = torch.rand(n_pool, hkv, pg, generator=g, device=dev) * 0.02
        kw["v_scale"] = torch.rand(n_pool, hkv, pg, generator=g, device=dev) * 0.02
        kw["k_scale"][poison] = kw["v_scale"][poison] = float("nan")
    else:
        k = torch.randn(n_pool, hkv, d, pg, generator=g, device=dev).to(dtype)
        v = torch.randn(n_pool, hkv, d, pg, generator=g, device=dev).to(dtype)
        k[poison] = v[poison] = float("nan")
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    o_k = da.decode_attention_paged_cuda(q, k, v, tbl, lengths, **kw)
    torch.cuda.synchronize()
    launched = check_decode_launch(q, k, v, kw, "paged decode")
    check(bool(torch.isfinite(o_k).all()), "paged kernel output is not finite")
    check(bool((o_k[lengths <= 0] == 0).all()), "a paged row of length <= 0 is not 0")
    o_p = da.decode_attention_paged_torch(q, k, v, tbl, lengths, **kw)
    torch.testing.assert_close(o_k, o_p, **TOLS[dtype])
    diff = _max_diff(o_k, o_p)
    log(f"  paged {str(dtype)[6:]} ({launched['route']}, {launched['fold']}, "
        f"{launched['stages']} stages) "
        f"B{b} Hkv{hkv} G{g_} D{d} pg{pg} MP{mp} int8 {int8} softcap {softcap} lengths "
        f"{lengths.tolist()}: max abs diff {diff:.3e}")
    return diff


def paged_kernels_vs_plain(dev) -> float:
    """Phase 9; returns the largest abs difference."""
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for pg, mp in ((16, 72), (PAGE, PAGED_MAX_LEN // PAGE)):
            window = pg * mp
            lengths = [1, pg, 300, 640, 1000, window - 7, window + 100, 777]
            for int8 in (False, True):
                worst = max(worst, paged_case(dev, dtype, pg, mp, lengths, int8=int8,
                                              softcap=2.0 if int8 else None,
                                              seed=pg + int8))
        # Every edge of the chunk plan over pages of 16, 64 and 256 slots.
        # (pg 20: element loads in bf16 and int8, 16-byte copies in f32.)
        for pg, mp in ((16, 36), (20, 30), (64, 9), (PAGE, 3)):
            lengths = SPLIT_EDGES + [pg * mp, pg * mp + 100]
            for int8 in (False, True):
                worst = max(worst, paged_case(dev, dtype, pg, mp, lengths, int8=int8,
                                              softcap=2.0 if int8 else None,
                                              seed=2 * pg + int8))
    # An identity table with one page as wide as the cache is the dense read
    # of the same slots, bit for bit (the same chunks, folded alike): S 300
    # (bf16: element loads; f32: 16-byte copies) and S 1,024.
    g = torch.Generator(device=dev).manual_seed(11)
    for dtype in (torch.float32, torch.bfloat16):
        for s in (300, LM_MAX_LEN):
            q = torch.randn(GEN_B, LM_KV_HEADS, 4, 128, generator=g, device=dev).to(dtype)
            k, v = (torch.randn(GEN_B, LM_KV_HEADS, 128, s, generator=g, device=dev)
                    .to(dtype) for _ in range(2))
            lengths = torch.tensor([1, 64, 200, 299, 300, 700, 1000, 1024],
                                   dtype=torch.int32, device=dev)
            ident = torch.arange(GEN_B, dtype=torch.int32, device=dev)[:, None]
            o_p = da.decode_attention_paged_cuda(q, k, v, ident, lengths)
            launched = check_decode_launch(q, k, v, {}, "paged decode, identity table")
            o_d = da.decode_attention_cuda(q, k, v, lengths)
            torch.cuda.synchronize()
            check(da.last_launch() == launched, f"dense launched {da.last_launch()}, "
                  f"paged {launched}")
            check(torch.equal(o_p, o_d), f"paged with an identity table and pg = S = {s} "
                  f"differs from the dense kernel by {_max_diff(o_p, o_d):.3e}")
            log(f"  paged {str(dtype)[6:]} ({launched['route']}, {launched['fold']}) with an "
                f"identity table "
                f"and pg = S = {s} equals the dense kernel bit for bit")
    # A paged row reads alike alone and in the batch (the pool's pages in
    # permuted order).
    bf = torch.bfloat16
    mp = LM_MAX_LEN // PAGE
    q = torch.randn(GEN_B, LM_KV_HEADS, 4, 128, generator=g, device=dev).to(bf)
    perm = torch.randperm(GEN_B * mp, generator=g, device=dev)
    kp, vp = (torch.randn(GEN_B * mp, LM_KV_HEADS, 128, PAGE, generator=g, device=dev)
              .to(bf) for _ in range(2))
    tbl = torch.argsort(perm).to(torch.int32).view(GEN_B, mp)
    lengths = torch.tensor([1, 64, 200, 511, 513, 700, 1000, 1024], dtype=torch.int32,
                           device=dev)
    alone_and_in_a_batch(lambda i: da.decode_attention_paged_cuda(
        q[i], kp, vp, tbl[i], lengths[i]), GEN_B, f"paged bf16 at pg {PAGE}")
    return worst


def paged_workload(dev):
    """8 prompts of 640..1,024 tokens, right-padded to 1,024, from a seed."""
    rng = np.random.default_rng(1)
    lens = np.linspace(PG_MIN, PG_P, GEN_B).astype(np.int64)
    prompts = torch.from_numpy(rng.integers(0, LM_VOCAB, size=(GEN_B, PG_P))).to(dev)
    return prompts, torch.from_numpy(lens).to(torch.int32).to(dev)


@torch.no_grad()
def run_lm(lm, table, prompts, lens, fed=None, steps=16):
    """Prefill, then `steps` decode steps fed greedy tokens (or `fed`);
    returns (every output, the fed tokens)."""
    y, cache = lm([table[prompts]], decode=True, cache={}, prompt_lengths=lens)
    outs = [y]
    tok = (y[torch.arange(GEN_B, device=y.device), lens.long() - 1] @ table.T).argmax(-1)
    toks = []
    for i in range(steps):
        tok = tok if fed is None else fed[:, i]
        toks.append(tok)
        y, cache = lm([table[tok[:, None]]], decode=True, cache=cache)
        outs.append(y)
        tok = (y[:, 0] @ table.T).argmax(-1)
    torch.cuda.synchronize()
    return outs, torch.stack(toks, 1)


@torch.no_grad()
def step_times(lm, embed, readout, prompts, lens, steps=64):
    """(host s of one prefill, host s of each of `steps` greedy decode
    steps after it, each ended by a synchronise)."""
    x0 = embed(prompts)
    out = []
    t_pre = wall_s(lambda: out.append(lm([x0], decode=True, cache={},
                                         prompt_lengths=lens)))
    y, cache = out[0]
    tok = readout(y[torch.arange(GEN_B, device=y.device), lens.long() - 1][:, None]
                  )[:, 0].argmax(-1)
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        y, cache = lm([embed(tok[:, None])], decode=True, cache=cache)
        tok = readout(y)[:, 0].argmax(-1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return t_pre, times


def _agree(a_outs, b_outs, what) -> float:
    worst = 0.0
    for i, (a, b) in enumerate(zip(a_outs, b_outs)):
        check(bool(torch.isfinite(a).all()), f"{what}: non-finite output at step {i}")
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=f"{what}, step {i}")
        worst = max(worst, _max_diff(a, b))
    log(f"  {what}: max abs diff {worst:.3e} over the prefill and "
        f"{len(a_outs) - 1} steps")
    return worst


def paged_f32_phase(lm32, table32, prompts, lens, steps=16) -> float:
    """Phase 10: the f32 LM with a paged cache against the dense cache, f32
    and int8, and with f32 pools through its kernels against its plain
    paths; returns the largest difference between kernels and plain
    paths."""
    paged = dict(kv_page_size=PAGE)
    set_cache(lm32, PAGED_MAX_LEN, **paged)
    zero_counts()
    p_outs, fed = run_lm(lm32, table32, prompts, lens, steps=steps)
    want = (2 * LM_BLOCKS, 0, 2 * LM_BLOCKS * steps)
    check(counts() == want, f"f32 paged run launched {counts()}, expected {want}")
    log(f"f32 LM, paged cache (pg {PAGE}, MP {PAGED_MAX_LEN // PAGE}), prompt lengths "
        f"{lens.tolist()}: launches (flash, dense, paged) {counts()}")
    set_cache(lm32, PAGED_MAX_LEN)
    _agree(p_outs, run_lm(lm32, table32, prompts, lens, fed, steps)[0],
           "f32 paged vs dense cache")
    set_cache(lm32, PAGED_MAX_LEN, **paged)
    set_attention_paths(lm32, False)
    err = _agree(p_outs, run_lm(lm32, table32, prompts, lens, fed, steps)[0],
                 "f32 paged, kernels vs plain paths")
    # int8 pools: against the int8 dense cache, both through the kernels.
    # (Not kernels against plain paths at this depth: a 1e-6 difference in a
    # layer's input moves some K/V across an int8 rounding edge, a step of
    # 1/127 of the vector's largest value, far past 1e-4 downstream; the CPU
    # tests hold the int8 paths against ku at small sizes.)
    set_attention_paths(lm32, True)
    set_cache(lm32, PAGED_MAX_LEN, kv_cache_dtype="int8", **paged)
    p8 = run_lm(lm32, table32, prompts, lens, fed, steps)[0]
    set_cache(lm32, PAGED_MAX_LEN, kv_cache_dtype="int8")
    _agree(p8, run_lm(lm32, table32, prompts, lens, fed, steps)[0],
           "f32 int8 paged vs int8 dense cache")
    return err


@torch.no_grad()
def paged_serving(dev, name, lm, embed, readout, prompts, lens, max_abs_err) -> dict:
    """Phases 11-13 on the bf16 LM; returns the paged kernel's entry."""
    _, peak_bf16, peak_bw = peaks(name)
    n_prompt = int(lens.sum())

    def gen(steps):
        return generate(lm, prompts, steps, embed=embed, readout=readout,
                        prompt_lengths=lens, return_logprobs=True)

    # 11. Paged generate: the main path of the paged kernel.
    set_cache(lm, PAGED_MAX_LEN, kv_page_size=PAGE)
    zero_counts()
    ids, lps = gen(GEN_STEPS)
    torch.cuda.synchronize()
    launches = counts()
    want = (2 * LM_BLOCKS, 0, 2 * LM_BLOCKS * (GEN_STEPS - 1))
    check(launches == want, f"paged generate launched (flash, dense, paged) "
          f"{launches}, expected {want}")
    check(ids.shape == (GEN_B, GEN_STEPS) and bool(torch.isfinite(lps).all())
          and bool((lps <= 0).all()), "paged generate: bad ids or logprobs")
    log(f"paged generate bf16 {GEN_B} x {GEN_STEPS} steps after prompts of "
        f"{lens.tolist()}: mean logprob {float(lps.float().mean()):.4f}, first row "
        f"{ids[0, :12].tolist()}; launches (flash, dense, paged) {launches}")

    rates = {}
    for layout, kw in (("paged", dict(kv_page_size=PAGE)), ("dense", {})):
        set_cache(lm, PAGED_MAX_LEN, **kw)
        gen(GEN_STEPS // 2)  # warm this layout's allocations
        t_full = wall_s(lambda: gen(GEN_STEPS))
        t_half = wall_s(lambda: gen(GEN_STEPS // 2))
        x0 = embed(prompts)
        t_pre = min(wall_s(lambda: lm([x0], decode=True, cache={}, prompt_lengths=lens))
                    for _ in range(2))
        rates[layout] = (GEN_B * (GEN_STEPS - GEN_STEPS // 2) / (t_full - t_half),
                         n_prompt / t_pre, GEN_B * GEN_STEPS / t_full)
        log(f"{layout}-cache generate ({PAGED_MAX_LEN}-slot window): {GEN_STEPS} steps "
            f"{t_full:.4f} s, {GEN_STEPS // 2} steps {t_half:.4f} s; decode "
            f"{rates[layout][0]:.1f} tokens/s (slope), "
            f"{1e3 * (t_full - t_half) / (GEN_STEPS - GEN_STEPS // 2):.3f} ms a step; "
            f"prefill {n_prompt} tokens in {t_pre * 1e3:.3f} ms, {rates[layout][1]:.1f} "
            f"tokens/s; whole run {rates[layout][2]:.1f} tokens/s")
    log(f"paging costs (one run each): decode {rates['paged'][0] / rates['dense'][0]:.3f}, "
        f"prefill {rates['paged'][1] / rates['dense'][1]:.3f}, whole run "
        f"{rates['paged'][2] / rates['dense'][2]:.3f} of the dense cache's rate")
    # The host clock of a one-card machine wanders by more than the gap a
    # slope from one run of each can show: so also every decode step timed
    # alone, 64 after a prefill, in the order paged, dense, dense, paged.
    steps = {"paged": [], "dense": []}
    pre = {"paged": [], "dense": []}
    for layout in ("paged", "dense", "dense", "paged"):
        set_cache(lm, PAGED_MAX_LEN, **(dict(kv_page_size=PAGE) if layout == "paged" else {}))
        t_pre, times = step_times(lm, embed, readout, prompts, lens)
        pre[layout].append(t_pre)
        steps[layout] += times
    med = {}
    for layout in ("paged", "dense"):
        q1, med[layout], q3 = np.percentile(steps[layout], [25, 50, 75])
        log(f"{layout}-cache decode steps, one at a time ({len(steps[layout])}): median "
            f"{med[layout] * 1e3:.3f} ms (quartiles {q1 * 1e3:.3f}..{q3 * 1e3:.3f}), "
            f"{GEN_B / med[layout]:.1f} tokens/s; prefill best of 2 "
            f"{min(pre[layout]) * 1e3:.3f} ms, {n_prompt / min(pre[layout]):.1f} tokens/s")
    log(f"paging costs (step medians): decode {med['dense'] / med['paged']:.3f}, prefill "
        f"{min(pre['dense']) / min(pre['paged']):.3f} of the dense cache's rate")

    # 12. The paged batcher over a 24-page pool with a shared prefix.
    set_cache(lm, PAGED_MAX_LEN, kv_page_size=PAGE, kv_num_pages=CBP_PAGES)
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, LM_VOCAB, size=(CBP_PREFIX,))
    reqs = [rng.integers(0, LM_VOCAB, size=(int(n),))
            for n in rng.integers(CBP_MIN, CBP_MAX + 1, size=CB_REQUESTS)]
    budgets = [int(b) for b in rng.integers(32, 257, size=CB_REQUESTS)]
    cb = ContinuousBatcher(lm, embed=embed, readout=readout, num_slots=CB_SLOTS,
                           prompt_len=CBP_PROMPT_LEN, max_decode_len=PAGED_MAX_LEN,
                           chunk=CB_CHUNK)
    cb.reset(shared_prefix=prefix)
    for r, b in zip(reqs, budgets):
        cb.submit(r, b)
    deferred_at = None
    for step in range(64):
        cb._admit()  # what step() admits first: a free slot left with requests queued
        if cb._queue and not cb._active.all():
            deferred_at = (step, int((~cb._active).sum()), len(cb._queue),
                           len(cb._free_pages))
            break
        cb.step()
    check(deferred_at is not None, "no admission deferred for want of pages")
    log(f"paged batcher: at step {deferred_at[0]} {deferred_at[1]} slot(s) free with "
        f"{deferred_at[2]} request(s) queued and {deferred_at[3]} free page(s): deferred")
    cb.reset(force=True)
    zero_counts()
    out = []
    t_cb = wall_s(lambda: out.append(cb.serve(reqs, budgets, shared_prefix=prefix)))
    results, st = out[0], cb.last_stats
    cb_flash, cb_dense, cb_paged = counts()
    check(len(results) == CB_REQUESTS and all(
        r is not None and len(r) == b for r, b in zip(results, budgets)),
        "paged batcher: a request was not answered with exactly its budget")
    check(st["shared_prefix_pages"] == 2 and st["peak_pages_in_use"] <= CBP_PAGES - 1,
          f"paged batcher pages: {st}")
    steps_run = (st["decoded_tokens"] + st["wasted_slot_steps"]) // CB_SLOTS
    check(cb_dense == 0 and cb_paged == 2 * LM_BLOCKS * steps_run
          and cb_flash == 2 * LM_BLOCKS * (st["prefill_rounds"] + 1),
          f"paged batcher launched (flash, dense, paged) {counts()} for "
          f"{st['prefill_rounds']} prefill rounds + the prefix and {steps_run} steps")
    cb_tps = st["decoded_tokens"] / t_cb
    log(f"paged ContinuousBatcher: {CB_REQUESTS} requests, prompts "
        f"{min(len(r) for r in reqs)}..{max(len(r) for r in reqs)} after a "
        f"{CBP_PREFIX}-token prefix, budgets {min(budgets)}..{max(budgets)}, pool "
        f"{CBP_PAGES} pages, all answered; last_stats {st}; launches (flash, dense, "
        f"paged) {counts()}; {st['decoded_tokens']} tokens in {t_cb:.4f} s, "
        f"{cb_tps:.1f} tokens/s, {cb_tps / rates['paged'][2]:.3f} of paged generate's "
        f"whole-run rate")
    del cb

    # 13. The kernel alone at the path's shape, and on the path.
    set_cache(lm, PAGED_MAX_LEN, kv_page_size=PAGE)
    _, paged_path_ms = profile_path(lm, embed, readout, prompts, lens,
                                    decode_key="PagedRows")
    g = torch.Generator(device=dev).manual_seed(12)
    bf = torch.bfloat16
    hd, mp = LM_D // LM_HEADS, PAGED_MAX_LEN // PAGE
    kp, vp = (torch.randn(GEN_B * mp, LM_KV_HEADS, hd, PAGE, generator=g, device=dev).to(bf)
              for _ in range(2))
    tbl = torch.arange(GEN_B * mp, dtype=torch.int32, device=dev).view(GEN_B, mp)
    qd = torch.randn(GEN_B, LM_KV_HEADS, LM_HEADS // LM_KV_HEADS, hd, generator=g,
                     device=dev).to(bf)
    mid = lens + GEN_STEPS // 2
    kw = dict(softmax_scale=1.0 / math.sqrt(LM_D))
    paged_call = lambda: da.decode_attention_paged_cuda(qd, kp, vp, tbl, mid, **kw)  # noqa: E731
    ms = timed_cold_ms(paged_call, 300)
    warm_ms = timed_ms(paged_call, 300)
    plain_ms = timed_cold_ms(lambda: da.decode_attention_paged_torch(
        qd, kp, vp, tbl, mid, **kw), 30)
    ck, cv = (da.gather_pages(x, tbl).contiguous() for x in (kp, vp))
    dense_ms = timed_cold_ms(lambda: da.decode_attention_cuda(qd, ck, cv, mid, **kw), 300)
    bound_ms, bound_by = decode_bound(GEN_B, LM_HEADS, LM_KV_HEADS, hd, mid.tolist(), 2,
                                      peak_bf16, peak_bw)
    mb = decode_bytes(GEN_B, LM_HEADS, LM_KV_HEADS, hd, mid.tolist(), 2) / 1e6
    paged_call()
    torch.cuda.synchronize()
    launched = check_decode_launch(qd, kp, vp, {}, "paged decode at the path's shape")
    check((launched["route"], launched["fold"]) == ("16-byte", "mma"),
          f"the path's paged read took {launched}")
    host = decode_host_us(True, qd, kp, vp, mid, tbl)
    log(f"decode_attention_paged at B{GEN_B} Hkv{LM_KV_HEADS} G4 D{hd} pg{PAGE} MP{mp} "
        f"bf16, lengths {mid.tolist()} ({mb:.2f} MB), {launched['route']} copies, "
        f"{launched['fold']} fold, {launched['stages']} stages, S_SPLIT {launched['s_split']} ({launched['clusters']} "
        f"clusters held at once), cold L2: kernel "
        f"{ms:.4f} ms ({mb / ms:.1f} GB/s; warm {warm_ms:.4f} ms, {mb / warm_ms:.1f} "
        f"GB/s), plain {plain_ms:.4f} ms, dense kernel at the same lengths "
        f"{dense_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}); on the path "
        f"(profiler, the 8 steps after the prefill) {paged_path_ms:.4f} ms a launch")
    log("decode_attention_paged_cuda host us a launch: " + ", ".join(
        f"{k} {x:.2f}" for k, x in host.items()))
    log("decode_attention_paged library_ms: null, no single PyTorch call reads "
        "attention through a page table")
    length_sweep(dev)
    return {
        "name": "decode_attention_paged",
        "route": "cuda",
        "source": "ku_torch/csrc/decode_attention.cu",
        "replaces": "ku/pallas/decode_attention.py:224",
        "launches": launches[2],
        "max_abs_err": max_abs_err,
        "copy_route": launched["route"],
        "fold": launched["fold"],
        "s_split": launched["s_split"],
        "stages": launched["stages"],
        "clusters": launched["clusters"],
        "ms": ms,
        "warm_ms": warm_ms,
        "gbps": mb / ms,
        "host_us": host["wrapper"],
        "path_ms": paged_path_ms,
        "plain_ms": plain_ms,
        "dense_ms": dense_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def serving_path(dev, name) -> list:
    """Phases 6-13; returns the entries of the three serving kernels."""
    flash_err, decode_err = serving_kernels_vs_plain(dev)
    paged_err = paged_kernels_vs_plain(dev)
    _, peak_bf16, peak_bw = peaks(name)

    # 7. The LM at full width, weights from a seed.
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    lm32 = LM(g).eval()
    rng = np.random.default_rng(0)
    table_np = (rng.normal(size=(LM_VOCAB, LM_D)) * 0.05).astype(np.float32)
    table32 = torch.from_numpy(table_np).to(dev)
    n_params = sum(p.numel() for p in lm32.parameters())
    lens_np = np.linspace(64, GEN_P, GEN_B).astype(np.int64)
    prompts = torch.from_numpy(
        rng.integers(0, LM_VOCAB, size=(GEN_B, GEN_P))).to(dev)
    lens = torch.from_numpy(lens_np).to(torch.int32).to(dev)
    log(f"serving LM: {n_params / 1e9:.3f}B parameters, built in "
        f"{time.perf_counter() - t0:.2f} s; prompt lengths {lens_np.tolist()}")
    f32_err = f32_kernels_vs_plain(lm32, table32, prompts, lens)
    paged_prompts, paged_lens = paged_workload(dev)
    paged_f32_err = paged_f32_phase(lm32, table32, paged_prompts, paged_lens)
    set_cache(lm32, LM_MAX_LEN)

    lm = copy.deepcopy(lm32).to(torch.bfloat16)
    del lm32
    torch.cuda.empty_cache()
    table = table32.to(torch.bfloat16)
    embed = lambda ids, pos=None: table[ids]  # noqa: E731 (RoPE: no PE table)
    readout = lambda y: y @ table.T  # noqa: E731

    def gen(steps):
        return generate(lm, prompts, steps, embed=embed, readout=readout,
                        prompt_lengths=lens, return_logprobs=True)

    zero_counts()
    copies = fa.flash_fwd_cuda.copies
    ids, lps = gen(GEN_STEPS)
    torch.cuda.synchronize()
    gen_flash, gen_decode, gen_paged = counts()
    check((fa.flash_fwd_cuda.route, fa.flash_fwd_cuda.layout) == ("mma", "b")
          and fa.flash_fwd_cuda.copies == copies,
          f"generate's prefill took {fa.flash_fwd_cuda.route}/{fa.flash_fwd_cuda.layout} "
          f"with {fa.flash_fwd_cuda.copies - copies} copies, not the cache in place")
    check(gen_paged == 0, f"dense generate launched the paged kernel {gen_paged} times")
    check(ids.shape == (GEN_B, GEN_STEPS) and lps.shape == (GEN_B, GEN_STEPS),
          f"generate shapes {tuple(ids.shape)}, {tuple(lps.shape)}")
    check(bool(((ids >= 0) & (ids < LM_VOCAB)).all()), "ids out of the vocabulary")
    check(bool(torch.isfinite(lps).all() and (lps <= 0).all()), "bad logprobs")
    want = (2 * LM_BLOCKS, 2 * LM_BLOCKS * (GEN_STEPS - 1))
    check((gen_flash, gen_decode) == want,
          f"generate launched flash {gen_flash} / decode {gen_decode} times, "
          f"expected {want}")
    log(f"generate bf16 {GEN_B} x {GEN_STEPS} steps: ids {tuple(ids.shape)}, "
        f"mean logprob {float(lps.float().mean()):.4f}, first row "
        f"{ids[0, :12].tolist()}; launches flash {gen_flash}, decode {gen_decode}")

    # ContinuousBatcher: 24 requests through 8 slots.
    cb = ContinuousBatcher(lm, embed=embed, readout=readout, num_slots=CB_SLOTS,
                           prompt_len=CB_PROMPT_LEN, max_decode_len=LM_MAX_LEN,
                           chunk=CB_CHUNK)
    reqs = [rng.integers(0, LM_VOCAB, size=(int(n),))
            for n in rng.integers(16, 193, size=CB_REQUESTS)]
    budgets = [int(b) for b in rng.integers(32, 257, size=CB_REQUESTS)]
    cb.reset()  # builds the cache spec (one throwaway prefill) before counting
    zero_counts()
    results = cb.serve(reqs, budgets)
    torch.cuda.synchronize()
    cb_flash, cb_decode, cb_paged = counts()
    check(cb_paged == 0, f"dense batcher launched the paged kernel {cb_paged} times")
    st = cb.last_stats
    check(len(results) == CB_REQUESTS and all(
        r is not None and len(r) == b for r, b in zip(results, budgets)),
        "a request was not answered with exactly its budget")
    steps_run = (st["decoded_tokens"] + st["wasted_slot_steps"]) // CB_SLOTS
    check(cb_flash == 2 * LM_BLOCKS * st["prefill_rounds"]
          and cb_decode == 2 * LM_BLOCKS * steps_run,
          f"batcher launched flash {cb_flash} / decode {cb_decode} times for "
          f"{st['prefill_rounds']} prefill rounds and {steps_run} steps")
    log(f"ContinuousBatcher: {CB_REQUESTS} requests, prompts "
        f"{min(len(r) for r in reqs)}..{max(len(r) for r in reqs)}, budgets "
        f"{min(budgets)}..{max(budgets)}, all answered; last_stats {st}; "
        f"launches flash {cb_flash}, decode {cb_decode}")

    # 8. Timing (everything above warmed the kernels and the allocator).
    t_full = min(wall_s(lambda: gen(GEN_STEPS)) for _ in range(2))
    t_half = min(wall_s(lambda: gen(GEN_STEPS // 2)) for _ in range(2))
    decode_tps = GEN_B * (GEN_STEPS - GEN_STEPS // 2) / (t_full - t_half)
    gen_tps = GEN_B * GEN_STEPS / t_full
    with torch.no_grad():
        x0 = embed(prompts)
        t_pre = min(wall_s(lambda: lm([x0], decode=True, cache={},
                                      prompt_lengths=lens)) for _ in range(3))
    prefill_tps = float(lens_np.sum()) / t_pre
    t_cb = wall_s(lambda: cb.serve(reqs, budgets))
    cb_tps = cb.last_stats["decoded_tokens"] / t_cb
    flash_path_ms, decode_path_ms = profile_path(lm, embed, readout, prompts, lens)
    log(f"generate: {GEN_STEPS} steps {t_full:.4f} s, {GEN_STEPS // 2} steps "
        f"{t_half:.4f} s; decode {decode_tps:.1f} tokens/s (slope), "
        f"{1e3 * (t_full - t_half) / (GEN_STEPS - GEN_STEPS // 2):.3f} ms a step; "
        f"whole run {gen_tps:.1f} tokens/s")
    log(f"prefill: {int(lens_np.sum())} prompt tokens in {t_pre * 1e3:.3f} ms, "
        f"{prefill_tps:.1f} tokens/s")
    log(f"batcher: {cb.last_stats['decoded_tokens']} tokens in {t_cb:.4f} s, "
        f"{cb_tps:.1f} tokens/s, {cb_tps / gen_tps:.3f} of generate's whole-run rate")

    # Each kernel at its path's shape: flash at generate's prefill (bf16,
    # offset 0 over the 1,024-slot page), decode at the middle step of
    # generate (live lengths = prompt length + 128), each call cold in L2.
    g = torch.Generator(device=dev).manual_seed(9)
    bf = torch.bfloat16
    hd = LM_D // LM_HEADS
    scale = 1.0 / math.sqrt(LM_D)
    ck = torch.randn(GEN_B, LM_KV_HEADS, hd, LM_MAX_LEN, generator=g, device=dev).to(bf)
    cv = torch.randn(GEN_B, LM_KV_HEADS, hd, LM_MAX_LEN, generator=g, device=dev).to(bf)
    kT, vT = ck.transpose(2, 3), cv.transpose(2, 3)
    q = torch.randn(GEN_B, LM_HEADS, GEN_P, hd, generator=g, device=dev).to(bf)
    qd = torch.randn(GEN_B, LM_KV_HEADS, LM_HEADS // LM_KV_HEADS, hd, generator=g,
                     device=dev).to(bf)
    zero = torch.zeros(GEN_B, dtype=torch.int32, device=dev)
    fkw = dict(softmax_scale=scale, causal=True, q_offset=zero)
    causal_mask = (torch.arange(LM_MAX_LEN, device=dev)[None, :]
                   <= torch.arange(GEN_P, device=dev)[:, None])[None, None].expand(
                       GEN_B, 1, GEN_P, LM_MAX_LEN)
    copies = fa.flash_fwd_cuda.copies
    flash_ms = timed_cold_ms(lambda: fa.flash_fwd_cuda(q, kT, vT, **fkw), 60)
    check((fa.flash_fwd_cuda.route, fa.flash_fwd_cuda.layout) == ("mma", "b")
          and fa.flash_fwd_cuda.copies == copies,
          "the prefill's cache view did not go to the tensor cores in place")
    flash_plain_ms = timed_cold_ms(lambda: fa.flash_fwd_torch(q, kT, vT, **fkw), 6)
    with torch.no_grad():
        prefill_sdpa = sdpa_ms(q, kT, vT, scale, causal_mask, reps=60)
    flash_lib_ms = min(f for f, _, _ in prefill_sdpa.values())
    flash_bound_ms, flash_by = flash_bound(GEN_B, LM_HEADS, LM_KV_HEADS, GEN_P, hd,
                                           [0] * GEN_B, 2, peak_bf16, peak_bw)
    mid = lens + GEN_STEPS // 2
    dkw = dict(softmax_scale=scale)
    live_mask = (torch.arange(LM_MAX_LEN, device=dev)[None, :]
                 < mid[:, None])[:, None, None, :]
    decode = lambda: da.decode_attention_cuda(qd, ck, cv, mid, **dkw)  # noqa: E731
    decode_ms = timed_cold_ms(decode, 300)
    decode_plain_ms = timed_cold_ms(lambda: da.decode_attention_torch(
        qd, ck, cv, mid, **dkw), 60)
    decode_lib_ms = timed_cold_ms(lambda: F.scaled_dot_product_attention(
        qd.reshape(GEN_B, LM_HEADS, 1, hd), kT, vT, attn_mask=live_mask, scale=scale,
        enable_gqa=True), 300)
    decode_warm_ms = timed_ms(decode, 300)
    decode_bound_ms, decode_by = decode_bound(GEN_B, LM_HEADS, LM_KV_HEADS, hd,
                                              mid.tolist(), 2, peak_bf16, peak_bw)
    decode_mb = decode_bytes(GEN_B, LM_HEADS, LM_KV_HEADS, hd, mid.tolist(), 2) / 1e6
    decode()
    torch.cuda.synchronize()
    decode_launch = check_decode_launch(qd, ck, cv, {}, "decode at the path's shape")
    check((decode_launch["route"], decode_launch["fold"]) == ("16-byte", "mma"),
          f"the path's dense read took {decode_launch}")
    decode_host = decode_host_us(False, qd, ck, cv, mid)
    # Every instantiation of the decode kernel (both entries, both routes)
    # without a spill.
    ptxas = decode_ptxas(BUILD_REPORTS.get(da.NAME, ""))
    check(len(ptxas) == 36, f"ptxas reported {len(ptxas)} decode instantiations, not 36")
    for kernel, regs, st, ld in ptxas:
        log(f"  decode_split_kernel{kernel}: {regs} registers, spill stores {st} B, "
            f"loads {ld} B")
    check(all(st == ld == 0 for _, _, st, ld in ptxas), "a decode instantiation spills")
    # The standalone call under the profiler, warm and cold, to set beside
    # path_ms: one clock for all three.
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    wall, rows, clocks = profiled(lambda: [decode() for _ in range(64)])
    alone_warm_ms = per_launch_ms(rows, "DenseRows")
    wall, rows, clocks = profiled(lambda: [(flush.zero_(), decode()) for _ in range(64)])
    alone_cold_ms = per_launch_ms(rows, "DenseRows")
    del flush
    log(f"profile, 64 standalone decode launches: {alone_warm_ms:.4f} ms each warm, "
        f"{alone_cold_ms:.4f} ms each cold; SM clock {clock_range(clocks)}")
    log(f"flash_fwd at B{GEN_B} H{LM_HEADS}/{LM_KV_HEADS} N{GEN_P} KN{LM_MAX_LEN} "
        f"D{hd} bf16, offset 0, cold L2: kernel (mma, the cache read in place) "
        f"{flash_ms:.4f} ms, plain {flash_plain_ms:.4f} ms, SDPA fastest "
        f"{flash_lib_ms:.4f} ms ({sdpa_line(prefill_sdpa)}), bound "
        f"{flash_bound_ms:.5f} ms ({flash_by}); on the path (profiler, prefill "
        f"lengths {lens_np.tolist()}) {flash_path_ms:.4f} ms a launch")
    log(f"decode_attention at B{GEN_B} Hkv{LM_KV_HEADS} G4 D{hd} S{LM_MAX_LEN} bf16, "
        f"lengths {mid.tolist()} ({decode_mb:.2f} MB), {decode_launch['route']} "
        f"copies, {decode_launch['fold']} fold, {decode_launch['stages']} stages, S_SPLIT {decode_launch['s_split']} "
        f"({decode_launch['clusters']} clusters held at once), "
        f"cold L2: kernel {decode_ms:.4f} ms ({decode_mb / decode_ms:.1f} GB/s; warm "
        f"{decode_warm_ms:.4f} ms, {decode_mb / decode_warm_ms:.1f} GB/s), plain "
        f"{decode_plain_ms:.4f} ms, SDPA {decode_lib_ms:.4f} ms, bound "
        f"{decode_bound_ms:.5f} ms ({decode_by}); standalone under the profiler "
        f"{alone_cold_ms:.4f} ms cold, on the path (profiler, the 8 steps after the "
        f"prefill) {decode_path_ms:.4f} ms a launch")
    log("decode_attention_cuda host us a launch: " + ", ".join(
        f"{k} {x:.2f}" for k, x in decode_host.items()))
    log(f"max abs diff kernel vs plain: flash {flash_err:.3e}, decode "
        f"{decode_err:.3e}; f32 LM through the kernels vs plain {f32_err:.3e}")
    paged = paged_serving(dev, name, lm, embed, readout, paged_prompts, paged_lens,
                          max(paged_err, paged_f32_err))
    return [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "ku_torch/csrc/flash_fwd.cu",
        "replaces": "ku/pallas/flash_attention.py:154",
        "launches": gen_flash,
        "max_abs_err": max(flash_err, f32_err),
        "ms": flash_ms,
        "path_ms": flash_path_ms,
        "plain_ms": flash_plain_ms,
        "bound_ms": flash_bound_ms,
        "bound_by": flash_by,
        "library_ms": flash_lib_ms,
    }, {
        "name": "decode_attention",
        "route": "cuda",
        "source": "ku_torch/csrc/decode_attention.cu",
        "replaces": "ku/pallas/decode_attention.py:80",
        "launches": gen_decode,
        "max_abs_err": max(decode_err, f32_err),
        "copy_route": decode_launch["route"],
        "fold": decode_launch["fold"],
        "s_split": decode_launch["s_split"],
        "stages": decode_launch["stages"],
        "clusters": decode_launch["clusters"],
        "ms": decode_ms,
        "warm_ms": decode_warm_ms,
        "gbps": decode_mb / decode_ms,
        "host_us": decode_host["wrapper"],
        "path_ms": decode_path_ms,
        "plain_ms": decode_plain_ms,
        "bound_ms": decode_bound_ms,
        "bound_by": decode_by,
        "library_ms": decode_lib_ms,
    }, paged]


# ---------------------------------------------------------------------------
# The training path (phases 14-16).
# ---------------------------------------------------------------------------

# The backward kernels against their plain versions: f32 sums in another
# order (rtol/atol 1e-4); bf16 rtol 2e-2 and atol 1e-2 of the largest
# entry, since p and ds are rounded to bf16 before their products and an
# f32 ulp in a score can move one of those roundings (2^-8 of the value).
def bwd_close(got, want, dtype, what, twice=False):
    """Phase 14's limits (`twice`: twice them, for two results that each
    carry their own rounding, sdpa_ms)."""
    f = 2 if twice else 1
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=f * 1e-4, atol=f * 1e-4, msg=what)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=f * 2e-2,
                                   atol=f * 1e-2 * float(want.float().abs().max()), msg=what)


def bwd_case(dev, dtype, b, h, hkv, n, kn, d, *, dv=None, causal=True, window=None,
             softcap=None, segments=False, q_offset=None, k_offset=None,
             strided_do=False, q_layout=None, seed=0):
    """Both backward kernels against their plain versions on the same
    inputs (o and lse from the forward kernel), bf16 through the
    tensor-core kernels and f32 through the CUDA-core ones, each launch's
    route checked, and the wrapper's copies: on the tensor cores, one of
    each tensor whose rows are not 16-byte runs (q in `q_layout`, see
    q_in_layout; heads not a multiple of 8 wide), else none. Returns the
    largest abs difference of (dq, dk/dv)."""
    dv = dv or d
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, n, d, generator=g, device=dev).to(dtype)
    if q_layout:
        q = q_in_layout(q, q_layout)
    k = torch.randn(b, hkv, kn, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, hkv, kn, dv, generator=g, device=dev).to(dtype)
    if strided_do:  # as autograd hands it over, through the heads' transpose
        do = torch.randn(b, n, h, dv, generator=g, device=dev).to(dtype).transpose(1, 2)
    else:
        do = torch.randn(b, h, n, dv, generator=g, device=dev).to(dtype)
    seg = None
    if segments:
        seg = torch.sort(torch.randint(0, 4, (b, n), generator=g, device=dev),
                         dim=1).values.to(torch.int32)
    kw = dict(softmax_scale=1.0 / math.sqrt(h * d), causal=causal, window=window,
              segment_ids=seg, q_offset=q_offset, k_offset=k_offset,
              logit_softcap=softcap)
    o, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    delta = fa._delta(o, do)
    copies = [kn_.copies for kn_ in BWD_KERNELS]
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
    dk, dv_ = fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    route = fa.flash_route(dtype, d)
    check([kn_.route for kn_ in BWD_KERNELS] == [route] * 2,
          f"backward launches took {[kn_.route for kn_ in BWD_KERNELS]}, not {route}")
    copied = [kn_.copies - c for kn_, c in zip(BWD_KERNELS, copies)]
    want = sum(not fa._mma_ready(t) for t in (q, k, v, do)) if route == "mma" else 0
    check(copied == [want] * 2 and (want > 0) == (route == "mma" and (
        bool(q_layout) or d % 8 > 0 or dv % 8 > 0)),
          f"backward copies {copied}, expected {want} each, q layout {q_layout}")
    dq_p = fa.flash_bwd_dq_torch(q, k, v, do, lse, delta, **kw)
    dk_p, dv_p = fa.flash_bwd_dkv_torch(q, k, v, do, lse, delta, **kw)
    for what, got, want in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv_, dv_p)):
        check(got.dtype == dtype and bool(torch.isfinite(got).all()), f"{what} not finite")
        bwd_close(got, want, dtype, what)
    dead = lse == fa._MASKED  # rows with no live key
    check(bool((dq.float().abs().sum(-1) * dead).sum() == 0), "a dead row has dq != 0")
    diffs = (_max_diff(dq, dq_p), max(_max_diff(dk, dk_p), _max_diff(dv_, dv_p)))
    log(f"  flash bwd {str(dtype)[6:]} ({route}) B{b} H{h}/{hkv} N{n} KN{kn} D{d} Dv{dv} "
        f"causal {causal} window {window} softcap {softcap} segments {segments} offsets "
        f"{'rows' if torch.is_tensor(q_offset) else q_offset}/{k_offset} strided dO "
        f"{strided_do} q layout {q_layout or 'as made'}, {int(dead.sum())} dead rows: "
        f"max abs diff dq {diffs[0]:.3e} (largest {float(dq_p.float().abs().max()):.3e}), "
        f"dk/dv {diffs[1]:.3e} (largest "
        f"{float(torch.maximum(dk_p.float().abs().max(), dv_p.float().abs().max())):.3e})")
    return diffs


def backward_kernels_vs_plain(dev):
    """Phase 14; returns the largest abs difference of (dq, dk/dv)."""
    rows = lambda *x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    worst = [0.0, 0.0]
    for dtype in (torch.float32, torch.bfloat16):
        cases = [
            # Ragged shapes and every mask, G 1 and 4.
            dict(b=2, h=4, hkv=2, n=37, kn=53, d=64, window=7, softcap=1.5,
                 q_offset=rows(16, 3), seed=1),
            dict(b=2, h=4, hkv=1, n=70, kn=70, d=32, segments=True, q_offset=3,
                 k_offset=1, seed=2),
            dict(b=1, h=3, hkv=3, n=5, kn=130, d=128, causal=False, seed=3),
            dict(b=2, h=8, hkv=2, n=130, kn=130, d=128, softcap=30.0, strided_do=True,
                 seed=4),
            # Rows with no live key: queries 0..9 of row 0 inside a visited
            # tile, all of row 1 with no tile visited.
            dict(b=2, h=2, hkv=1, n=70, kn=70, d=32, k_offset=10,
                 q_offset=rows(0, -80), seed=5),
            # Widths the tensor-core tiles zero-fill, D != Dv both ways; q in
            # layouts the wrapper copies for the tensor cores.
            dict(b=2, h=4, hkv=2, n=70, kn=90, d=40, dv=24, window=30, seed=7),
            dict(b=1, h=2, hkv=2, n=64, kn=128, d=36, dv=12, strided_do=True, seed=8),
            dict(b=1, h=2, hkv=1, n=65, kn=65, d=32, dv=96, window=20, seed=9),
            dict(b=1, h=4, hkv=2, n=65, kn=65, d=64, q_layout="strided", seed=10),
            dict(b=1, h=2, hkv=1, n=40, kn=70, d=64, q_layout="offset", softcap=5.0,
                 seed=11),
            # The training step's shape.
            dict(b=TRAIN_B, h=LM_HEADS, hkv=LM_KV_HEADS, n=TRAIN_N, kn=TRAIN_N,
                 d=LM_D // LM_HEADS, strided_do=True, seed=6),
        ]
        for c in cases:
            dims = [c.pop(x) for x in ("b", "h", "hkv", "n", "kn", "d")]
            diffs = bwd_case(dev, dtype, *dims, **c)
            worst = [max(w, x) for w, x in zip(worst, diffs)]
    return worst


class TrainLM(torch.nn.Module):
    """The serving LM's blocks between a tied embedding and readout: a
    (LM_VOCAB, LM_D) table, ``ku``'s ``embed/embedding``, read out as
    ``y @ tableᵀ``; next-token logits (B, N, LM_VOCAB)."""

    def __init__(self, generator, table):
        super().__init__()
        self.embed = torch.nn.Embedding(LM_VOCAB, LM_D, device=DEVICE)
        with torch.no_grad():
            self.embed.weight.copy_(table)
        self.core = LM(generator)

    def forward(self, ids, deterministic=True):
        y = self.core([self.embed(ids)], deterministic=deterministic)
        return y @ self.embed.weight.T


def next_token_xent(y_true, logits):
    """Per-sequence mean next-token cross-entropy, in f32."""
    return F.cross_entropy(logits.float().transpose(1, 2), y_true,
                           reduction="none").mean(-1)


def train_counts():
    """(flash fwd, dq, dk/dv, dense decode, paged decode, sparse fwd, dq,
    dk/dv) launches."""
    return (fa.flash_fwd_cuda.launches,) + tuple(
        k.launches for k in BWD_KERNELS + DECODE_KERNELS + SPARSE_KERNELS)


def check_step_launches(steps, what, sparse=False):
    """Each step launched the three flash kernels (or, under a block mask,
    the three sparse ones) once per attention sublayer, and nothing else."""
    per = (2 * LM_BLOCKS * steps,) * 3
    want = ((0,) * 3 + (0, 0) + per) if sparse else (per + (0, 0) + (0,) * 3)
    check(train_counts() == want, f"{what}: launches (fwd, dq, dkv, dense, paged, "
          f"sparse fwd, dq, dkv) {train_counts()}, expected {want}")


def periodic_sequences(rng, rows, width):
    """Each row a random TRAIN_PERIOD-token motif repeated: after its first
    period, every next token is a copy from TRAIN_PERIOD back."""
    motif = rng.integers(0, LM_VOCAB, size=(rows, TRAIN_PERIOD))
    return torch.from_numpy(np.tile(motif, (1, -(-width // TRAIN_PERIOD)))[:, :width]
                            ).to(DEVICE)


def gib(nbytes) -> str:
    return f"{nbytes / 2 ** 30:.2f} GiB"


def f32_training(lm, seqs, grad_b, fit_b, route, what, sparse=False):
    """Phases 15 and 18, float32 (TF32 off): one step's loss and every
    gradient through the kernels against the same step through the plain
    paths (`route(kernels)` sends the model one way or the other), then
    `fit`, 2 epochs over `seqs` at batch `fit_b`. Returns the largest
    gradient difference relative to its tensor's largest entry."""
    x, y = seqs[:grad_b, :-1], seqs[:grad_b, 1:]
    initial = copy.deepcopy(lm.state_dict())
    runs = {}
    for kernels in (True, False):
        route(kernels)
        lm.load_state_dict(initial)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        tr = Trainer(lm, next_token_xent, optimizer=adam(TRAIN_LR))
        loss = tr.train_step(x, y)["loss"]
        torch.cuda.synchronize()
        if kernels:
            check_step_launches(1, f"{what}: f32 step through the kernels", sparse)
        else:
            check(train_counts() == (0,) * 8, f"{what}: plain step launched {train_counts()}")
        runs[kernels] = (loss, {n: p.grad.clone() for n, p in lm.named_parameters()},
                         torch.cuda.max_memory_allocated())
        del tr
    route(True)
    (loss_k, grads_k, peak_k), (loss_p, grads_p, peak_p) = runs[True], runs[False]
    check(math.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-4 * abs(loss_p),
          f"{what}: f32 step loss through the kernels {loss_k} against plain {loss_p}")
    worst, worst_name = 0.0, ""
    for n, gp in grads_p.items():
        gk, top = grads_k[n], float(gp.abs().max())
        check(bool(torch.isfinite(gk).all()), f"non-finite gradient {n}")
        torch.testing.assert_close(gk, gp, rtol=1e-3, atol=1e-3 * top, msg=n)
        rel = float((gk - gp).abs().max()) / max(top, 1e-30)
        if rel > worst:
            worst, worst_name = rel, n
    log(f"f32 LM train step ({what}), B {grad_b} x {seqs.shape[1] - 1} tokens: loss "
        f"{loss_k:.6f} through the kernels, {loss_p:.6f} through the plain paths; "
        f"{len(grads_k)} gradients agree, largest difference {worst:.3e} of its tensor's "
        f"largest entry ({worst_name}); peak memory {gib(peak_k)} (kernels), "
        f"{gib(peak_p)} (plain)")
    del runs, grads_k, grads_p

    # fit: 2 epochs, from the same initial weights.
    lm.load_state_dict(initial)
    del initial
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    tr = Trainer(lm, next_token_xent, optimizer=adam(TRAIN_LR))
    t0 = time.perf_counter()
    history = tr.fit(seqs[:, :-1], seqs[:, 1:], batch_size=fit_b, epochs=2, verbose=0)
    t_fit = time.perf_counter() - t0
    steps = 2 * (seqs.shape[0] // fit_b)
    check_step_launches(steps, f"{what}: f32 fit", sparse)
    check(all(math.isfinite(h) for h in history) and history[1] < history[0],
          f"{what}: f32 fit loss did not fall: {history}")
    log(f"f32 LM fit ({what}), {seqs.shape[0]} sequences of {seqs.shape[1] - 1}, batch "
        f"{fit_b}, 2 epochs ({steps} steps, {t_fit:.2f} s): epoch losses {history}; "
        f"launches (fwd, dq, dkv) {train_counts()[5:] if sparse else train_counts()[:3]}; "
        f"peak memory {gib(torch.cuda.max_memory_allocated())}")
    return worst


def timed_steps(tr, x, y, timed):
    """2 warm-up train_steps, then `timed` ones each between two CUDA
    events; returns (every loss, the timed steps' ms sorted)."""
    losses = [tr.train_step(x, y)["loss"] for _ in range(2)]
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(timed)]
    for start, end in events:
        start.record()
        losses.append(tr.train_step(x, y)["loss"])
        end.record()
    torch.cuda.synchronize()
    return losses, sorted(s.elapsed_time(e) for s, e in events)


def bwd_bound(which, b, h, hkv, n, d, itemsize, peak_bf16, peak_bw):
    """(bound ms, bound_by) of one causal backward kernel at offset 0: dq
    does 6·D operations a live pair (s, dp, dq), dk/dv 8·D (s, dp, dv, dk);
    each reads q, k, v, dO, lse and delta once and writes its gradients."""
    pairs = b * h * n * (n + 1) // 2
    flops = (6 if which == "dq" else 8) * pairs * d
    reads = (2 * b * h + 2 * b * hkv) * n * d * itemsize + 2 * b * h * n * 4
    writes = (b * h if which == "dq" else 2 * b * hkv) * n * d * itemsize
    t_ops, t_bytes = flops / peak_bf16 * 1e3, (reads + writes) / peak_bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def training_path(dev, name, fwd_entry) -> list:
    """Phases 14-16; returns the entries of the two backward kernels and
    adds the training shape's numbers to the forward's (`fwd_entry`)."""
    dq_err, dkv_err = backward_kernels_vs_plain(dev)
    _, peak_bf16, peak_bw = peaks(name)

    # 15. The LM trained at full width, weights from a seed.
    g = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(3)
    table = torch.from_numpy((rng.normal(size=(LM_VOCAB, LM_D)) * 0.05).astype(np.float32))
    lm = TrainLM(g, table)
    seqs = periodic_sequences(rng, TRAIN_SEQS, TRAIN_N + 1)
    log(f"training LM: {sum(p.numel() for p in lm.parameters()) / 1e9:.3f}B parameters "
        f"({LM_BLOCKS} blocks, tied {LM_VOCAB} x {LM_D} table), {TRAIN_SEQS} sequences of "
        f"{TRAIN_N + 1} tokens (a {TRAIN_PERIOD}-token motif repeated), Adam lr {TRAIN_LR}")
    grad_err = f32_training(lm, seqs, F32_GRAD_B, F32_FIT_B,
                            lambda kernels: set_attention_paths(lm, kernels),
                            "use_flash=False as the plain path")

    lm = lm.to(torch.bfloat16)
    torch.cuda.empty_cache()
    x, y = seqs[:TRAIN_B, :-1], seqs[:TRAIN_B, 1:]
    tr = Trainer(lm, next_token_xent, optimizer=adam(TRAIN_LR))
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, step_ms = timed_steps(tr, x, y, TRAIN_TIMED)
    launches = train_counts()
    check_step_launches(2 + TRAIN_TIMED, "bf16 train_step")
    routes = [kn.route for kn in (fa.flash_fwd_cuda,) + BWD_KERNELS]
    check(routes == ["mma"] * 3, f"bf16 steps' flash launches took {routes}")
    check(all(math.isfinite(v) for v in losses), f"bf16 losses {losses}")
    median_ms = float(np.median(step_ms))
    tokens_per_s = TRAIN_B * TRAIN_N / (median_ms / 1e3)
    log(f"bf16 LM train_step, B {TRAIN_B} x {TRAIN_N} tokens: losses {losses}; launches "
        f"(fwd, dq, dkv) {launches[:3]}; peak memory "
        f"{gib(torch.cuda.max_memory_allocated())}")
    log(f"train: step {median_ms:.3f} ms median of {TRAIN_TIMED} (CUDA events; "
        f"{step_ms[0]:.3f}..{step_ms[-1]:.3f}), {tokens_per_s:.1f} tokens/s")

    # 16. Where a step's time goes, and each flash kernel alone.
    wall, rows, clocks = profiled(lambda: tr.train_step(x, y))
    log_profile("one bf16 train step", wall, rows, clocks)
    check(not any(re.search(r"flash_(fwd|bwd_dq|bwd_dkv)_kernel", r[2]) for r in rows),
          "a CUDA-core (f32) flash kernel ran in the bf16 step")
    names = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel")
    path = {k: per_launch_ms(rows, k) for k in names}
    attn_us = sum(r[0] for r in rows if "flash_" in r[2])
    device_us = sum(r[0] for r in rows)
    log(f"profile: flash kernels (tensor cores) {attn_us / 1e3:.3f} ms of "
        f"{device_us / 1e3:.3f} ms device time ({attn_us / device_us:.3f}); a launch on "
        f"the path: fwd {path[names[0]]:.4f} ms, dq {path[names[1]]:.4f} ms, dk/dv "
        f"{path[names[2]]:.4f} ms")
    # The same step through the plain paths (use_flash=False: dense
    # attention, cuBLAS products), as a yardstick for the whole step.
    set_attention_paths(lm, False)
    tr.train_step(x, y)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(4)]
    for start, end in events:
        start.record()
        tr.train_step(x, y)
        end.record()
    torch.cuda.synchronize()
    check(train_counts() == (0,) * 8, f"plain steps launched {train_counts()}")
    plain_step_ms = float(np.median([s.elapsed_time(e) for s, e in events]))
    log(f"train through the plain paths: step {plain_step_ms:.3f} ms median of 4, "
        f"{TRAIN_B * TRAIN_N / (plain_step_ms / 1e3):.1f} tokens/s, "
        f"{median_ms / plain_step_ms:.3f} x the kernels' step time; peak memory "
        f"{gib(torch.cuda.max_memory_allocated())}")
    del tr, lm
    torch.cuda.empty_cache()

    # Each flash instantiation's registers and spills (phase 2's build
    # output) and its count of tensor-core instructions.
    for lib_name, source in ((fa.NAME, fa.SOURCE), (fa.BWD_NAME, fa.BWD_SOURCE)):
        sass = sass_mma_counts(_build.library_path(source, lib_name))
        table = ptxas_kernels(BUILD_REPORTS.get(lib_name, ""))
        check(table, f"no ptxas report of {lib_name}")
        for kn, regs, st, ld in table:
            log(f"  ptxas {kn}: {regs} registers, spill stores {st} bytes, spill loads {ld} "
                f"bytes; {sass.get(kn, 'no')} HMMA/HGMMA instructions in its SASS")
        tensor = {kn: n for kn, n in sass.items() if "_wgmma_" in kn}
        check(len(tensor) == 4 and all(tensor.values()),
              f"tensor-core instructions by kernel in {lib_name}: {sass}")

    gen = torch.Generator(device=dev).manual_seed(13)
    bf, hd = torch.bfloat16, LM_D // LM_HEADS
    q = torch.randn(TRAIN_B, LM_HEADS, TRAIN_N, hd, generator=gen, device=dev).to(bf)
    k, v = (torch.randn(TRAIN_B, LM_KV_HEADS, TRAIN_N, hd, generator=gen, device=dev).to(bf)
            for _ in range(2))
    do = torch.randn(TRAIN_B, LM_HEADS, TRAIN_N, hd, generator=gen, device=dev).to(bf)
    kw = dict(softmax_scale=1.0 / math.sqrt(LM_D), causal=True)
    o, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    check((fa.flash_fwd_cuda.route, fa.flash_fwd_cuda.layout) == ("mma", "a"),
          f"the training-shape forward took {fa.flash_fwd_cuda.route}/{fa.flash_fwd_cuda.layout}")
    # The forward the train step launches, against its plain version at the
    # step's shape (phase 6's limits); its difference joins the entry's
    # max_abs_err.
    o_p, lse_p = fa.flash_fwd_torch(q, k, v, **kw)
    torch.testing.assert_close(o, o_p, **TOLS[bf])
    torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=1e-4)
    fwd_err = _max_diff(o, o_p)
    log(f"flash_fwd at the training shape, kernel vs plain: max abs diff out {fwd_err:.3e}, "
        f"lse {_max_diff(lse, lse_p):.3e}")
    del o_p, lse_p
    delta = fa._delta(o, do)
    args = (q, k, v, do, lse, delta)
    mask = (torch.arange(TRAIN_N, device=dev)[None, :]
            <= torch.arange(TRAIN_N, device=dev)[:, None])[None, None].expand(
                TRAIN_B, 1, TRAIN_N, TRAIN_N)
    train_sdpa = sdpa_ms(q, k, v, kw["softmax_scale"], mask, do=do)
    lib_fwd_ms = min(f for f, _, _ in train_sdpa.values())
    lib_ms = min(b for _, b, _ in train_sdpa.values())
    log(f"SDPA at B{TRAIN_B} H{LM_HEADS}/{LM_KV_HEADS} N=KN={TRAIN_N} D{hd} bf16 causal, cold "
        f"L2: {sdpa_line(train_sdpa)}; fastest forward {lib_fwd_ms:.4f} ms, backward "
        f"{lib_ms:.4f} ms (the masked ones kept as earlier PRs measured them)")

    # The forward alone at the training shape (phase 8 times it at the
    # prefill's): its entry gains the *_train numbers.
    fwd_ms = timed_cold_ms(lambda: fa.flash_fwd_cuda(q, k, v, **kw), 10)
    fa.flash_fwd_torch(q, k, v, **kw)
    fwd_plain_ms = timed_cold_ms(lambda: fa.flash_fwd_torch(q, k, v, **kw), 3)
    fwd_bound_ms, fwd_by = flash_bound(TRAIN_B, LM_HEADS, LM_KV_HEADS, TRAIN_N, hd,
                                       [0] * TRAIN_B, 2, peak_bf16, peak_bw)
    log(f"flash_fwd at B{TRAIN_B} H{LM_HEADS}/{LM_KV_HEADS} N=KN={TRAIN_N} D{hd} bf16 causal, "
        f"cold L2: kernel (mma) {fwd_ms:.4f} ms, plain {fwd_plain_ms:.4f} ms, bound "
        f"{fwd_bound_ms:.5f} ms ({fwd_by}); on the path (profiler) {path[names[0]]:.4f} ms a "
        f"launch; SDPA forward fastest {lib_fwd_ms:.4f} ms, masked "
        f"{train_sdpa['masked'][0]:.4f} ms")
    fwd_entry.update(max_abs_err=max(fwd_entry["max_abs_err"], fwd_err), ms_train=fwd_ms, path_ms_train=path[names[0]], plain_ms_train=fwd_plain_ms,
                     bound_ms_train=fwd_bound_ms, bound_by_train=fwd_by,
                     library_ms_train=lib_fwd_ms)
    entries = []
    for which, kernel, plain, err in (
            ("dq", fa.flash_bwd_dq_cuda, fa.flash_bwd_dq_torch, dq_err),
            ("dkv", fa.flash_bwd_dkv_cuda, fa.flash_bwd_dkv_torch, dkv_err)):
        ms = timed_cold_ms(lambda: kernel(*args, **kw), 10)
        check(kernel.route == "mma", f"flash_bwd_{which} at the training shape took {kernel.route}")
        plain(*args, **kw)
        plain_ms = timed_cold_ms(lambda: plain(*args, **kw), 3)
        bound_ms, bound_by = bwd_bound(which, TRAIN_B, LM_HEADS, LM_KV_HEADS, TRAIN_N, hd,
                                       2, peak_bf16, peak_bw)
        path_ms = path[f"flash_bwd_{which}_wgmma_kernel"]
        log(f"flash_bwd_{which} at B{TRAIN_B} H{LM_HEADS}/{LM_KV_HEADS} N=KN={TRAIN_N} "
            f"D{hd} bf16 causal, cold L2: kernel (mma) {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.5f} ms ({bound_by}); on the path (profiler) {path_ms:.4f} ms a "
            f"launch; SDPA backward (fwd+bwd minus fwd, dq/dk/dv together) fastest "
            f"{lib_ms:.4f} ms, masked {train_sdpa['masked'][1]:.4f} ms")
        entries.append({
            "name": f"flash_bwd_{which}",
            "route": "cuda",
            "source": "ku_torch/csrc/flash_bwd.cu",
            "replaces": ("ku/pallas/flash_attention.py:503" if which == "dq"
                         else "ku/pallas/flash_attention.py:581"),
            "launches": launches[1 if which == "dq" else 2],
            "max_abs_err": err,
            "ms": ms,
            "path_ms": path_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # One SDPA backward computes dq, dk and dv together: the fastest
            # backend's.
            "library_ms": lib_ms,
        })
    log(f"max abs diff kernel vs plain: dq {dq_err:.3e}, dk/dv {dkv_err:.3e}; f32 LM "
        f"gradients through the kernels vs plain paths {grad_err:.3e} of each tensor's "
        f"largest entry")
    return entries


# ---------------------------------------------------------------------------
# The block-sparse training path (phases 17-19).
# ---------------------------------------------------------------------------


def main_mask():
    """The main path's mask: causal, a window of SP_WINDOW keys plus SP_SINKS
    sinks, over SP_N tokens in SP_BLOCK-square blocks."""
    return sa.make_block_mask(SP_N, block_q=SP_BLOCK, block_k=SP_BLOCK, causal=True,
                              window=SP_WINDOW, global_prefix=SP_SINKS)


def gate_mask():
    """ku's sparse gate's mask (bench.py:217-243)."""
    return sa.make_block_mask(GATE_N, block_q=512, block_k=512, causal=True,
                              window=GATE_WINDOW, global_prefix=SP_SINKS)


def q_in_layout(q, layout):
    """q's values in a layout the tensor-core kernels cannot copy as it is:
    "strided", every other element of rows twice as wide; "offset", one
    element into a flat buffer (2 bytes off 16 in bf16)."""
    if layout == "strided":
        wide = torch.zeros(*q.shape[:-1], 2 * q.shape[-1], dtype=q.dtype, device=q.device)
        wide[..., ::2] = q
        return wide[..., ::2]
    flat = torch.zeros(q.numel() + 1, dtype=q.dtype, device=q.device)
    out = flat[1:].view(q.shape)
    out.copy_(q)
    return out


def sparse_case(dev, dtype, b, h, hkv, d, dv, mask, *, poison=False, strided_do=False,
                q_layout=None, amplitude=1.0, seed=0):
    """The three sparse kernels against their plain versions on the same
    inputs (the backward on the forward kernel's o, lse and delta): bf16
    through the tensor-core kernels, f32 through the CUDA-core ones. With
    `poison`, the K and V rows of the key blocks no query attends hold NaN:
    every output must stay finite and their dk, dv be exactly 0. With
    `q_layout`, q lies in a layout the wrapper copies for the tensor-core
    kernels. Returns the largest abs difference of (o, dq, dk/dv)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, h, mask.n, d, generator=g, device=dev) * amplitude).to(dtype)
    if q_layout:
        q = q_in_layout(q, q_layout)
        check(not sa._mma_ready(q), f"q in layout {q_layout} needs no copy")
    k = (torch.randn(b, hkv, mask.kn, d, generator=g, device=dev) * amplitude).to(dtype)
    v = (torch.randn(b, hkv, mask.kn, dv, generator=g, device=dev) * amplitude).to(dtype)
    unattended = torch.from_numpy(mask.qcnt == 0).to(dev).repeat_interleave(mask.block_k)
    if poison:
        check(bool(unattended.any()), "no unattended key block to poison")
        k[:, :, unattended] = float("nan")
        v[:, :, unattended] = float("nan")
    if strided_do:  # as autograd hands it over, through the heads' transpose
        do = torch.randn(b, mask.n, h, dv, generator=g, device=dev).to(dtype).transpose(1, 2)
    else:
        do = torch.randn(b, h, mask.n, dv, generator=g, device=dev).to(dtype)
    scale = 1.0 / math.sqrt(h * d)
    o, lse = sa.sparse_fwd_cuda(q, k, v, mask, scale)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()), "sparse o not finite")
    o_p, lse_p = sa.sparse_fwd_torch(q, k, v, mask, scale)
    torch.testing.assert_close(o, o_p, **TOLS[dtype], msg="sparse o")
    torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=1e-4, msg="sparse lse")
    delta = fa._delta(o, do)
    dq = sa.sparse_bwd_dq_cuda(q, k, v, do, lse, delta, mask, scale)
    dk, dv_ = sa.sparse_bwd_dkv_cuda(q, k, v, do, lse, delta, mask, scale)
    torch.cuda.synchronize()
    dq_p = sa.sparse_bwd_dq_torch(q, k, v, do, lse, delta, mask, scale)
    dk_p, dv_p = sa.sparse_bwd_dkv_torch(q, k, v, do, lse, delta, mask, scale)
    for what, got, want in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv_, dv_p)):
        check(got.dtype == dtype and bool(torch.isfinite(got).all()), f"sparse {what} not finite")
        bwd_close(got, want, dtype, f"sparse {what}")
    if poison:
        check(bool((dk[:, :, unattended] == 0).all() and (dv_[:, :, unattended] == 0).all()),
              "an unattended key block has dk or dv != 0")
    dead = lse == fa._MASKED  # rows with no live key
    check(bool((o[dead] == 0).all() and (dq[dead] == 0).all()), "a dead row has o or dq != 0")
    route = fa.flash_route(dtype, d)
    check([kn.route for kn in SPARSE_KERNELS] == [route] * 3,
          f"sparse launches took {[kn.route for kn in SPARSE_KERNELS]}, not {route}")
    diffs = (_max_diff(o, o_p), _max_diff(dq, dq_p), max(_max_diff(dk, dk_p), _max_diff(dv_, dv_p)))
    log(f"  sparse {str(dtype)[6:]} ({route}) B{b} H{h}/{hkv} N{mask.n} KN{mask.kn} D{d} "
        f"Dv{dv} blocks {mask.block_q}x{mask.block_k} causal {mask.causal} window "
        f"{mask.window} sinks {mask.global_prefix} entries {mask.fmap.shape[0]} poison "
        f"{poison} strided dO {strided_do} q layout {q_layout or 'as made'}, "
        f"{int(dead.sum())} dead rows: max abs diff o {diffs[0]:.3e}, dq "
        f"{diffs[1]:.3e} (largest {float(dq_p.float().abs().max()):.3e}), dk/dv {diffs[2]:.3e}")
    return diffs


def sparse_kernels_vs_plain(dev):
    """Phase 17; returns the largest abs difference of (o, dq, dk/dv)."""
    M = sa.make_block_mask
    pattern = np.zeros((6, 6), bool)  # tests/test_sparse_attention.py:124-135
    for i in range(6):
        pattern[i, i] = pattern[i, max(0, i - 2)] = pattern[i, 0] = True
    cross = np.zeros((2, 6), bool)  # key blocks 3..5 unattended
    cross[0, 0] = cross[0, 2] = cross[1, 1] = True
    primitives = (dict(causal=True), dict(causal=True, window=20),
                  dict(causal=True, window=20, global_prefix=5),
                  dict(causal=True, window=20, global_prefix=5,
                       extra_blocks=((5, 1), (4, 0))))
    worst = [0.0, 0.0, 0.0]
    for dtype in (torch.float32, torch.bfloat16):
        # (B, H, Hkv, D, Dv, mask, options)
        cases = [(2, 2, 2, 64, 64, M(96, block_q=16, block_k=16, **c), {})
                 for c in primitives]
        cases += [
            (1, 4, 1, 64, 32, M(96, block_q=16, block_k=16, causal=True,
                                block_pattern=pattern), dict(strided_do=True)),
            (1, 2, 1, 128, 128, M(32, 96, block_q=16, block_k=16, block_pattern=cross),
             dict(poison=True)),
            # Rows with no live key: queries 55..63 see none of 32 keys.
            (1, 2, 1, 32, 32, M(64, 32, block_q=16, block_k=16, causal=True, window=24), {}),
            (2, 8, 2, 128, 128, M(512, block_q=64, block_k=64, causal=True, window=200,
                                  global_prefix=70), dict(strided_do=True)),
            (1, 4, 4, 64, 128, M(1024, block_q=128, block_k=64, causal=True, window=300,
                                 global_prefix=40, extra_blocks=((7, 2),)), {}),
            # Widths that are not multiples of 16, zero-filled in the
            # tensor-core kernels' tiles; q in layouts the wrapper copies
            # for them (a stride of 2 along D; 2 bytes off 16; rows 72
            # bytes apart).
            (2, 4, 2, 40, 24, M(96, block_q=16, block_k=16, causal=True, window=20,
                                global_prefix=5), {}),
            (1, 4, 2, 40, 24, M(512, block_q=128, block_k=64, causal=True, window=200,
                                global_prefix=70), dict(q_layout="strided")),
            (1, 2, 1, 64, 64, M(256, block_q=64, block_k=64, causal=True, window=100,
                                global_prefix=10), dict(q_layout="offset", strided_do=True)),
            (1, 2, 2, 36, 12, M(128, block_q=64, block_k=64, causal=True), {}),
            # The LM's shape and mask.
            (1, LM_HEADS, LM_KV_HEADS, LM_D // LM_HEADS, LM_D // LM_HEADS, main_mask(),
             dict(strided_do=True)),
        ]
        if dtype == torch.bfloat16:  # ku's sparse gate, its own inputs' scale
            cases.append((1, GATE_H, GATE_H, GATE_D, GATE_D, gate_mask(),
                          dict(amplitude=0.1)))
        for i, (b, h, hkv, d, dv, mask, kw) in enumerate(cases):
            diffs = sparse_case(dev, dtype, b, h, hkv, d, dv, mask, seed=i, **kw)
            worst = [max(w, x) for w, x in zip(worst, diffs)]
    return worst


def route_sparse(kernels):
    """The sparse layers through the kernels, or (the f32 check's plain run
    only) through the plain versions on the card: the package has no
    switch, so the dispatch is swapped here."""
    sa.sparse_fwd, sa.sparse_bwd = (SPARSE_DISPATCH if kernels
                                    else (sa.sparse_fwd_torch, sa.sparse_bwd_torch))


def sparse_bound(which, b, h, hkv, n, kn, d, dv, pairs, itemsize, peak_bf16, peak_bw):
    """(bound ms, bound_by) of one sparse kernel: 4·D operations a kept pair
    for the forward (s, PV), 6·D for dq (s, dp, dq), 8·D for dk/dv (s, dp, dv,
    dk), at the bf16 tensor-core peak; or its bytes at the memory rate: q, k,
    v (and dO, lse, delta for the backward) read once, its outputs written
    once. `pairs` is the mask's exact count over all heads."""
    flops = {"fwd": 4, "dq": 6, "dkv": 8}[which] * pairs * d
    qkv = (b * h * n * d + b * hkv * kn * (d + dv)) * itemsize
    if which == "fwd":
        nbytes = qkv + b * h * n * dv * itemsize + b * h * n * 4
    else:
        reads = qkv + b * h * n * dv * itemsize + 2 * b * h * n * 4
        writes = (b * h * n * d if which == "dq" else b * hkv * kn * (d + dv)) * itemsize
        nbytes = reads + writes
    t_ops, t_bytes = flops / peak_bf16 * 1e3, nbytes / peak_bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sparse_inputs(gen, b, h, hkv, n, d, amplitude=1.0):
    q = (torch.randn(b, h, n, d, generator=gen, device=DEVICE) * amplitude).bfloat16()
    k, v = ((torch.randn(b, hkv, n, d, generator=gen, device=DEVICE) * amplitude).bfloat16()
            for _ in range(2))
    do = torch.randn(b, h, n, d, generator=gen, device=DEVICE).bfloat16()
    return q, k, v, do


def flex_ms(q, k, v, do, scale):
    """flex_attention, compiled, over a block mask from the main mask's
    mask_mod (causal AND (window OR sink)): (forward ms, backward ms as
    forward + backward minus forward), each cold in L2, and its output. A
    yardstick only: nothing in ku_torch calls it."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    def mask_mod(b, h, q_idx, kv_idx):
        return (kv_idx <= q_idx) & ((q_idx - kv_idx < SP_WINDOW) | (kv_idx < SP_SINKS))

    flex = torch.compile(flex_attention)
    bm = create_block_mask(mask_mod, None, None, SP_N, SP_N, device=DEVICE)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    fwd = lambda: flex(qr, kr, vr, block_mask=bm, scale=scale, enable_gqa=True)  # noqa: E731
    grad = lambda: torch.autograd.grad(fwd(), (qr, kr, vr), do)  # noqa: E731
    grad()  # compiles both
    out = fwd().detach()
    fwd_ms = timed_cold_ms(fwd, 10)
    return fwd_ms, timed_cold_ms(grad, 10) - fwd_ms, out


# An instantiation's mangled name: the kernel, an element type (f: float,
# 13__nv_bfloat16: bf16) or none, the width, and a bool (layout "b") or none.
_INSTANCE = r"\w*?([a-z][a-z_]*_kernel)I(f|13__nv_bfloat16)?Li(\d+)E(?:Lb([01])E)?"


def _instance(m) -> str:
    """`sparse_fwd_wgmma_kernel<128>`, `sparse_fwd_kernel<float, 64>`,
    `flash_fwd_kernel<bf16, 128>` or `flash_fwd_wgmma_kernel<128, true>`."""
    dtype = {"f": "float, ", "13__nv_bfloat16": "bf16, "}.get(m[2], "")
    flag = {"0": ", false", "1": ", true"}.get(m[4], "")
    return f"{m[1]}<{dtype}{m[3]}{flag}>"


def ptxas_kernels(report):
    """[(kernel, registers, spill store bytes, spill load bytes)] from nvcc's
    -Xptxas -v output, one entry per instantiation (named by _instance)."""
    out, kernel, spills = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '" + _INSTANCE, line)
        if m:
            kernel = _instance(m)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m[1]), int(m[2]))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.append((kernel, int(m[1])) + spills)
            kernel = None
    return out


def sass_mma_counts(library):
    """{instantiation: tensor-core instructions (HMMA, HGMMA) in its SASS},
    from cuobjdump -sass of a built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], check=True, capture_output=True,
                          text=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : " + _INSTANCE, line)
        if m:
            kernel = _instance(m)
            counts[kernel] = 0
        elif kernel and re.search(r"\bH(G)?MMA\b", line):
            counts[kernel] += 1
    return counts


def sparse_training_path(dev, name) -> list:
    """Phases 17-19; returns the entries of the three sparse kernels."""
    errs = sparse_kernels_vs_plain(dev)
    _, peak_bf16, peak_bw = peaks(name)

    # 18. The LM trained at full width under a block mask, weights from a seed.
    g = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(3)
    table = torch.from_numpy((rng.normal(size=(LM_VOCAB, LM_D)) * 0.05).astype(np.float32))
    lm = TrainLM(g, table)
    lm.core.block_mask = sa.make_block_mask(SP32_N, block_q=SP32_BLOCK, block_k=SP32_BLOCK,
                                            causal=True, window=SP32_WINDOW,
                                            global_prefix=SP32_SINKS)
    grad_err = f32_training(lm, periodic_sequences(rng, SP32_SEQS, SP32_N + 1), 1, 1,
                            route_sparse, f"block mask, {SP32_BLOCK}-blocks, window "
                            f"{SP32_WINDOW} + {SP32_SINKS} sinks", sparse=True)

    lm = lm.to(torch.bfloat16)
    torch.cuda.empty_cache()
    mask = main_mask()
    lm.core.block_mask = mask
    seqs = periodic_sequences(rng, 1, SP_N + 1)
    x, y = seqs[:, :-1], seqs[:, 1:]
    tr = Trainer(lm, next_token_xent, optimizer=adam(TRAIN_LR))
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, step_ms = timed_steps(tr, x, y, SP_TIMED)
    launches = train_counts()
    check_step_launches(2 + SP_TIMED, "bf16 sparse train_step", sparse=True)
    check(all(math.isfinite(v) for v in losses), f"bf16 sparse losses {losses}")
    median_ms = float(np.median(step_ms))
    log(f"bf16 LM sparse train_step, B 1 x {SP_N} tokens, blocks {SP_BLOCK}, window "
        f"{SP_WINDOW} + {SP_SINKS} sinks ({mask.fmap.shape[0]} entries, "
        f"{1 - mask.sparsity:.4f} of the square): losses {losses}; launches (sparse fwd, "
        f"dq, dkv) {launches[5:]}, flash and decode none; peak memory "
        f"{gib(torch.cuda.max_memory_allocated())}")
    log(f"sparse train: step {median_ms:.3f} ms median of {SP_TIMED} (CUDA events; "
        f"{step_ms[0]:.3f}..{step_ms[-1]:.3f}), {SP_N / (median_ms / 1e3):.1f} tokens/s")
    zero_counts()
    logits = tr.predict(x, batch_size=1)
    check(train_counts() == (0,) * 5 + (2 * LM_BLOCKS, 0, 0),
          f"sparse predict launched {train_counts()}")
    check(logits.shape == (1, SP_N, LM_VOCAB) and bool(np.isfinite(logits).all()),
          f"sparse predict: {logits.shape}, finite {np.isfinite(logits).all()}")
    log(f"sparse predict: logits {logits.shape}, launches (sparse fwd, dq, dkv) "
        f"{train_counts()[5:]}")

    # 19. Each sparse instantiation's registers and spills; where a step's
    # time goes, and each sparse kernel alone.
    table = ptxas_kernels(BUILD_REPORTS.get(sa.NAME, ""))
    check(any("wgmma" in kn for kn, *_ in table), "no ptxas report of the sparse kernels")
    sass = sass_mma_counts(_build.library_path(sa.SOURCE, sa.NAME))
    for kn, regs, st, ld in table:
        log(f"  ptxas {kn}: {regs} registers, spill stores {st} bytes, spill loads {ld} "
            f"bytes; {sass.get(kn, 'no')} HMMA/HGMMA instructions in its SASS")
    tensor = {kn: n for kn, n in sass.items() if "_wgmma_" in kn}
    check(len(tensor) == 6 and all(tensor.values()),
          f"tensor-core instructions by kernel: {sass}")
    wall, rows, clocks = profiled(lambda: tr.train_step(x, y))
    log_profile("one bf16 sparse train step", wall, rows, clocks)
    check(not any("flash_" in r[2] for r in rows), "a flash kernel ran in the sparse step")
    check(not any(re.search(r"sparse_(fwd|dq|dkv)_kernel", r[2]) for r in rows),
          "a CUDA-core (f32) sparse kernel ran in the bf16 step")
    names = ("sparse_fwd_wgmma_kernel", "sparse_dq_wgmma_kernel", "sparse_dkv_wgmma_kernel")
    path = {k: per_launch_ms(rows, k) for k in names}
    attn_us = sum(r[0] for r in rows if "sparse_" in r[2])
    log(f"profile: sparse kernels (tensor cores) {attn_us / 1e3:.3f} ms of "
        f"{sum(r[0] for r in rows) / 1e3:.3f} ms device time; a launch on the path: fwd "
        f"{path[names[0]]:.4f} ms, dq {path[names[1]]:.4f} ms, dk/dv {path[names[2]]:.4f} ms")
    del tr, lm, logits
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(17)
    hd = LM_D // LM_HEADS
    scale = 1.0 / math.sqrt(LM_D)
    q, k, v, do = sparse_inputs(gen, 1, LM_HEADS, LM_KV_HEADS, SP_N, hd)
    o, lse = sa.sparse_fwd_cuda(q, k, v, mask, scale)
    delta = fa._delta(o, do)
    pairs = sa.kept_pairs(mask) * LM_HEADS
    lib_fwd_ms, lib_bwd_ms, lib_out = flex_ms(q, k, v, do, scale)
    log(f"flex_attention (compiled, same mask_mod) against the sparse forward kernel: max abs "
        f"diff {_max_diff(lib_out, o):.3e}")
    entries = []
    for which, kernel, plain, args, err, line, lib in (
            ("fwd", sa.sparse_fwd_cuda, sa.sparse_fwd_torch, (q, k, v), errs[0], 230,
             lib_fwd_ms),
            ("dq", sa.sparse_bwd_dq_cuda, sa.sparse_bwd_dq_torch,
             (q, k, v, do, lse, delta), errs[1], 278, lib_bwd_ms),
            ("dkv", sa.sparse_bwd_dkv_cuda, sa.sparse_bwd_dkv_torch,
             (q, k, v, do, lse, delta), errs[2], 320, lib_bwd_ms)):
        kernel(*args, mask, scale)
        ms = timed_cold_ms(lambda: kernel(*args, mask, scale), 5)
        route = kernel.route
        check(route == "mma", f"sparse_{which} at the LM shape took the {route} kernel")
        plain(*args, mask, scale)
        plain_ms = timed_cold_ms(lambda: plain(*args, mask, scale), 3)
        bound_ms, bound_by = sparse_bound(which, 1, LM_HEADS, LM_KV_HEADS, SP_N, SP_N, hd,
                                          hd, pairs, 2, peak_bf16, peak_bw)
        name_k = f"sparse_{which}_wgmma_kernel"
        log(f"sparse_{which} at B1 H{LM_HEADS}/{LM_KV_HEADS} N{SP_N} D{hd} bf16, "
            f"{pairs} kept pairs, cold L2: kernel ({route}: bf16 on the tensor cores) "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.5f} ms ({bound_by}); on the path (profiler) "
            f"{path[name_k]:.4f} ms a launch; flex_attention "
            f"{'forward' if which == 'fwd' else 'backward (fwd+bwd minus fwd)'} {lib:.4f} ms")
        entries.append({
            "name": "sparse_fwd" if which == "fwd" else f"sparse_bwd_{which}",
            "route": "cuda",
            "source": "ku_torch/csrc/sparse_attention.cu",
            "replaces": f"ku/pallas/sparse_attention.py:{line}",
            "launches": launches[5 + ("fwd", "dq", "dkv").index(which)],
            "max_abs_err": err,
            "ms": ms,
            "path_ms": path[name_k],
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # flex_attention over the same mask_mod; one backward computes
            # dq, dk and dv together.
            "library_ms": lib,
        })
    del q, k, v, do, o, lse, delta, lib_out

    # ku's sparse gate: the sparse kernels against the dense causal flash
    # forward at 64k (ku's sparse_vs_causal_speedup).
    gmask = gate_mask()
    q, k, v, do = sparse_inputs(gen, 1, GATE_H, GATE_H, GATE_N, GATE_D, 0.1)
    gscale = 1.0 / math.sqrt(GATE_D)
    o, lse = sa.sparse_fwd_cuda(q, k, v, gmask, gscale)
    delta = fa._delta(o, do)
    fwd_ms = timed_cold_ms(lambda: sa.sparse_fwd_cuda(q, k, v, gmask, gscale), 3)
    dq_ms = timed_cold_ms(lambda: sa.sparse_bwd_dq_cuda(q, k, v, do, lse, delta, gmask,
                                                        gscale), 3)
    dkv_ms = timed_cold_ms(lambda: sa.sparse_bwd_dkv_cuda(q, k, v, do, lse, delta, gmask,
                                                          gscale), 3)
    routes = [kn.route for kn in SPARSE_KERNELS]
    fa.flash_fwd_cuda(q, k, v, softmax_scale=gscale, causal=True)
    causal_ms = timed_cold_ms(lambda: fa.flash_fwd_cuda(q, k, v, softmax_scale=gscale,
                                                        causal=True), 2)
    check(fa.flash_fwd_cuda.route == "mma",
          f"the gate's dense causal forward took {fa.flash_fwd_cuda.route}")
    causal_bound_ms, causal_by = flash_bound(1, GATE_H, GATE_H, GATE_N, GATE_D, [0], 2,
                                             peak_bf16, peak_bw)
    gpairs = sa.kept_pairs(gmask) * GATE_H
    bounds = [sparse_bound(w, 1, GATE_H, GATE_H, GATE_N, GATE_N, GATE_D, GATE_D, gpairs, 2,
                           peak_bf16, peak_bw)[0] for w in ("fwd", "dq", "dkv")]
    log(f"sparse gate B1 H{GATE_H} N{GATE_N} D{GATE_D} bf16, window {GATE_WINDOW} + "
        f"{SP_SINKS} sinks ({gmask.fmap.shape[0]} entries, {1 - gmask.sparsity:.4f} of the "
        f"square, {gpairs} kept pairs), cold L2: sparse fwd {fwd_ms:.4f} ms, dq "
        f"{dq_ms:.4f} ms, dk/dv {dkv_ms:.4f} ms (bounds {bounds[0]:.5f}, {bounds[1]:.5f}, "
        f"{bounds[2]:.5f} ms; routes {routes}); dense causal flash forward {causal_ms:.4f} ms "
        f"(bound {causal_bound_ms:.5f} ms, {causal_by}): sparse_vs_causal_speedup "
        f"{causal_ms / fwd_ms:.3f} (the bf16 sparse forward against the dense causal one, "
        f"both on the tensor cores)")
    log(f"max abs diff kernel vs plain: sparse o {errs[0]:.3e}, dq {errs[1]:.3e}, dk/dv "
        f"{errs[2]:.3e}; f32 LM gradients under the mask through the kernels vs the plain "
        f"versions {grad_err:.3e} of each tensor's largest entry")
    return entries


# ---------------------------------------------------------------------------
# The RBM examples (phase 23) and StyleGAN (phases 24-26).
# ---------------------------------------------------------------------------


def read_solution(path, n) -> np.ndarray:
    with open(path) as f:
        lines = f.read().splitlines()
    check(lines[0] == "ImageId,Label", f"solution.csv header {lines[0]!r}")
    check(len(lines) == n + 1, f"solution.csv has {len(lines) - 1} rows, want {n}")
    rows = np.array([[int(x) for x in line.split(",")] for line in lines[1:]])
    check(bool((rows[:, 0] == np.arange(1, n + 1)).all()), "solution.csv ImageIds")
    check(rows[:, 1].min() >= 0 and rows[:, 1].max() <= 9, "solution.csv labels outside 0-9")
    return rows[:, 1]


def rbm_examples(dev):
    """Phase 23: the two RBM examples' classifiers, trained and tested on
    the card through their own surface."""
    V = mnist_like() * 255.0
    gt = np.random.default_rng(23).integers(0, 10, size=N)
    conf = load_config(rbm_softmax_mnist.CONF_PATH)
    examples = (
        ("rbm_softmax_mnist", lambda tmp: rbm_softmax_mnist.MNISTClassifier(
            conf, device=dev, model_dir=tmp), 1),
        ("dbn_mnist", lambda tmp: dbn_mnist.MNISTClassifier(device=dev), 2),
    )
    for what, make, want_launches in examples:
        with tempfile.TemporaryDirectory() as tmp:
            cd_gibbs.cd_train_cuda.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mc = make(tmp)
            mc.train(V, gt)
            res = mc.test(V, out_path=os.path.join(tmp, "solution.csv"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = cd_gibbs.cd_train_cuda.launches
            labels = read_solution(os.path.join(tmp, "solution.csv"), N)
        check(bool(np.isfinite(res).all()), f"{what}: non-finite predictions")
        check(bool((labels == np.argmax(res, -1)).all()), f"{what}: solution.csv labels")
        check(launches == want_launches,
              f"{what}: kernel #1 launched {launches} times, want {want_launches}")
        log(f"{what}: train + test on {N} rows in {wall:.3f} s; kernel #1 launches "
            f"{launches}; solution.csv {N} rows, labels 0-9; accuracy on the seed's random "
            f"labels {float((labels == gt).mean()):.4f}")


def stylegan_weights(module, seed):
    """(params, batch_stats): numpy trees in ku's names, drawn from a seed
    at the module's shapes. Equalized-LR kernels N(0, 1) (they are scaled
    at run time), flax dense kernels N(0, 1/in), the label table N(0,
    1/features), biases and noise weights N(0, 0.1²), the constant N(0, 1),
    the moving mean N(0, 0.5²); the blur keeps its fixed kernel."""
    rng = np.random.default_rng(seed)
    buffers = {n for n, _ in module.named_buffers()}
    params, stats = {}, {}
    for name, t in module.state_dict().items():
        owner, leaf = (".." + name).rsplit(".", 2)[-2:]
        shape = tuple(t.shape)
        if owner.startswith("blur_"):
            value = t.cpu().numpy()
        else:
            scale = {"bias": 0.1, "noise_weight": 0.1, "moving_mean": 0.5,
                     "embedding": 1 / math.sqrt(shape[-1])}.get(leaf, 1.0)
            if leaf == "kernel" and name.startswith("map."):
                scale = 1 / math.sqrt(shape[0])
            value = (scale * rng.standard_normal(shape)).astype(np.float32)
        (stats if name in buffers else params)[name] = value
    return tree_from_state_dict(params), tree_from_state_dict(stats)


def load_stylegan(cls, conf, weights, device, **kw):
    module = cls(**conf, device=device, **kw)
    module.load_state_dict(state_dict_from_tree(weights[0], device, batch_stats=weights[1]),
                           strict=True)
    return module


def gen_inputs(seed, batch, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    z1, z2 = (torch.from_numpy(rng.standard_normal((batch, SG_CONF["latent_dim"])))
              .to(device, dtype) for _ in range(2))
    label = torch.from_numpy(rng.integers(0, SG_CONF["num_classes"], (batch, 1))).to(device)
    return z1, label, z2


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|, in float64 on the CPU."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    check(got.shape == want.shape, f"shape {tuple(got.shape)} against {tuple(want.shape)}")
    return float((got - want).abs().max() / want.abs().max())


def stylegan_generator(dev):
    """Phase 24; returns the f32 generator, its weights and its images."""
    cpu = torch.device("cpu")
    template = StyleGANGenerator(**SG_CONF, device=cpu)
    weights = stylegan_weights(template, seed=24)
    gen = load_stylegan(StyleGANGenerator, SG_CONF, weights, dev)
    gen64 = load_stylegan(StyleGANGenerator, SG_CONF, weights, cpu).double()
    with torch.no_grad():
        img = gen(gen_inputs(0, SG_BATCH, dev), deterministic=True)
        img64 = gen64(gen_inputs(0, SG_BATCH, cpu, torch.float64), deterministic=True)
    torch.cuda.synchronize()
    check(img.shape == (SG_BATCH, 128, 128, 3) and img.dtype == torch.float32,
          f"generator output {tuple(img.shape)} {img.dtype}")
    check(bool(torch.isfinite(img).all()), "non-finite generator output")
    err = rel_err(img, img64)
    check(err <= 1e-4, f"generator f32 against CPU float64: {err:.3e} of the largest entry")
    gen16 = load_stylegan(StyleGANGenerator, SG_CONF, weights, dev, dtype=torch.bfloat16)
    with torch.no_grad():
        img16 = gen16(gen_inputs(0, SG_BATCH, dev), deterministic=True)
    check(img16.dtype == torch.float32, f"bf16 generator's output dtype {img16.dtype}")
    err16 = float((img16 - img).abs().max())
    check(err16 <= 4e-2, f"generator bf16 against f32: {err16:.3e} > 4e-2")
    train = load_stylegan(StyleGANGenerator, dict(SG_CONF, mixing_prob=0.9), weights, dev)
    before = train.truncation.moving_mean.clone()
    with torch.no_grad():
        out = train(gen_inputs(1, SG_BATCH, dev), deterministic=False,
                    generator=torch.Generator(device=dev).manual_seed(24))
    moved = float((train.truncation.moving_mean - before).abs().max())
    check(bool(torch.isfinite(out).all()) and out.shape == img.shape,
          "training-mode generator output")
    check(moved > 0, "training mode left the moving mean where it was")
    log(f"StyleGAN generator at entry's conf, batch {SG_BATCH}: f32 (TF32 off) against "
        f"the CPU in float64 {err:.3e} of the largest entry ({float(img64.abs().max()):.4f}); "
        f"bf16 against f32 {err16:.3e} abs; training mode (mixing 0.9, noise on): finite, "
        f"moving mean moved by up to {moved:.3e}")
    return gen, weights, img


def stylegan_discriminator(dev, fake):
    """Phase 25; returns the f32 discriminator's weights."""
    cpu = torch.device("cpu")
    weights = stylegan_weights(StyleGANDiscriminator(**SG_DISC, device=cpu), seed=25)
    disc = load_stylegan(StyleGANDiscriminator, SG_DISC, weights, dev)
    disc64 = load_stylegan(StyleGANDiscriminator, SG_DISC, weights, cpu).double()
    rng = np.random.default_rng(25)
    real = rng.uniform(-1, 1, (SG_BATCH, 128, 128, 3))
    labels = rng.integers(0, SG_CONF["num_classes"], (SG_BATCH, 1)).astype(np.float64)
    eps = rng.uniform(0, 1, (SG_BATCH, 1, 1, 1))
    interp = eps * real + (1 - eps) * fake.double().cpu().numpy()

    def on(device, dtype, a):
        return torch.from_numpy(np.asarray(a)).to(device, dtype)

    runs = {}
    for key, module, device, dtype in (("card", disc, dev, torch.float32),
                                       ("cpu64", disc64, cpu, torch.float64)):
        lab = on(device, dtype, labels)
        d_fn = lambda x, module=module, lab=lab: module((x, lab))  # noqa: E731
        with torch.no_grad():
            logits = d_fn(on(device, dtype, real))
        r1 = r1_penalty(d_fn, on(device, dtype, real))
        gp = gradient_penalty(d_fn, on(device, dtype, interp))
        module.zero_grad(set_to_none=True)
        r1.mean().backward()
        grad = torch.cat([p.grad.detach().double().cpu().reshape(-1)
                          for p in module.parameters() if p.grad is not None])
        runs[key] = (logits, r1.detach(), gp.detach(), grad)
    torch.cuda.synchronize()
    (logits, r1, gp, grad), (logits64, r1_64, gp64, grad64) = runs["card"], runs["cpu64"]
    check(logits.shape == (SG_BATCH, 1) and bool(torch.isfinite(logits).all()),
          f"discriminator logits {tuple(logits.shape)}")
    errs = {"logits": rel_err(logits, logits64), "r1_penalty": rel_err(r1, r1_64),
            "gradient_penalty": rel_err(gp, gp64)}
    for what, err in errs.items():
        check(err <= 1e-4, f"discriminator {what} against CPU float64: {err:.3e}")
    check(bool(torch.isfinite(grad).all()), "non-finite second-order gradient")
    norm, norm64 = float(grad.norm()), float(grad64.norm())
    grad_err = float((grad - grad64).norm()) / norm64
    check(grad_err <= 1e-3, f"second-order gradient against CPU float64: {grad_err:.3e}")
    log(f"StyleGAN discriminator at 128 px, batch {SG_BATCH}: against the CPU in float64 "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" of the largest entry; the R1 penalty's gradient in the parameters (second "
        f"order): norm {norm:.6e} (CPU float64 {norm64:.6e}), difference {grad_err:.3e} "
        f"of the norm")
    return weights


def forward_work(call):
    """FLOPs of the convolutions and products of one forward, from the
    shapes (torch.utils.flop_counter)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:  # (its module hooks refuse to run under no_grad)
        call()
    return counter.get_total_flops()


def stylegan_timing(dev, name, gen_weights, disc_weights):
    """Phase 26: the StyleGAN forwards timed at batch 4 (and the generator
    at 12) against their bound; the `stylegan` JSON line."""
    peak_f32, peak_bf16, peak_bw = peaks(name)
    rows = []
    cases = [("generator", StyleGANGenerator, SG_CONF, gen_weights, b, dt)
             for b in (SG_BATCH, SG_BENCH_BATCH) for dt in (torch.float32, torch.bfloat16)]
    cases[2:2] = [("discriminator", StyleGANDiscriminator, SG_DISC, disc_weights, SG_BATCH,
                   dt) for dt in (torch.float32, torch.bfloat16)]
    rng = np.random.default_rng(26)
    for what, cls, conf, weights, batch, dtype in cases:
        module = load_stylegan(cls, conf, weights, dev, dtype=dtype)
        if cls is StyleGANGenerator:
            inputs = gen_inputs(26, batch, dev)
            call = lambda m=module, i=inputs: m(i, deterministic=True)  # noqa: E731
            in_bytes = sum(t.numel() * t.element_size() for t in inputs)
            out_bytes = batch * 128 * 128 * 3 * 4
        else:
            inputs = (torch.from_numpy(rng.uniform(-1, 1, (batch, 128, 128, 3))).to(
                dev, torch.float32), torch.ones(batch, 1, device=dev))
            call = lambda m=module, i=inputs: m(i)  # noqa: E731
            in_bytes = sum(t.numel() * 4 for t in inputs)
            out_bytes = batch * 4
        param_bytes = sum(p.numel() * p.element_size() for p in module.parameters())
        flops = forward_work(call)
        with torch.no_grad():
            for _ in range(3):
                call()
            events = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)) for _ in range(SG_REPS)]
            for start, end in events:
                start.record()
                call()
                end.record()
            torch.cuda.synchronize()
            ms = float(np.median([s.elapsed_time(e) for s, e in events]))
            wall, prof_rows, clocks = profiled(call)
        busy_us = sum(r[0] for r in prof_rows)
        ops = sum(r[1] for r in prof_rows)
        peak = peak_f32 if dtype == torch.float32 else peak_bf16
        nbytes = param_bytes + in_bytes + out_bytes
        flops_ms, bytes_ms = flops / peak * 1e3, nbytes / peak_bw * 1e3
        row = {"what": f"{what} {str(dtype).split('.')[-1]} batch {batch}", "ms": ms,
               "images_per_s": batch / (ms / 1e3), "busy_share": busy_us / (wall * 1e6),
               "device_ops": ops, "device_ms": busy_us / 1e3, "gflop": flops / 1e9,
               "bytes": nbytes, "bound_ms": max(flops_ms, bytes_ms),
               "bound_by": "operations" if flops_ms >= bytes_ms else "bytes"}
        rows.append(row)
        log(f"{row['what']}: {ms:.4f} ms (median of {SG_REPS}), {row['images_per_s']:.1f} "
            f"images/s; bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
            f"({row['gflop']:.3f} GFLOP, {nbytes / 1e6:.2f} MB); one profiled forward: wall "
            f"{wall * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
            f"({row['busy_share']:.3f}), {ops} device ops; SM clock {clock_range(clocks)}")
        for us, count, key in prof_rows[:4]:
            log(f"  {us:9.1f} us  {count:4d} x  {key[:90]}")
        del module
    print(json.dumps({"stylegan": rows}), flush=True)


def stylegan_path(dev, name):
    """Phases 24-26."""
    gen, gen_weights, img = stylegan_generator(dev)
    del gen
    disc_weights = stylegan_discriminator(dev, img)
    stylegan_timing(dev, name, gen_weights, disc_weights)


# ---------------------------------------------------------------------------
# The GAN step (phase 27).
# ---------------------------------------------------------------------------


def gan_batches(seed, groups, b, labels=GAN_LABELS):
    """`groups` steps' inputs, K + 1 batches each, drawn in the order
    benchmarks/stylegan_lane_packing.py's `batches_stacked` draws them
    (:64-79): the labels (in [labels[0], labels[1]), bench.py's all the
    classes), the images, z1, z2."""
    rng = np.random.default_rng(seed)
    shape = (groups, GAN_K + 1, b)
    labels = rng.integers(*labels, size=shape + (1,))
    res = GAN_CONF["resolution"]
    x = rng.normal(size=shape + (res, res, 3)).astype(np.float32)
    z1 = rng.normal(size=shape + (GAN_CONF["latent_dim"],)).astype(np.float32)
    z2 = rng.normal(size=shape + (GAN_CONF["latent_dim"],)).astype(np.float32)
    return [[{"x": x[s, i], "z": (z1[s, i], labels[s, i], z2[s, i]),
              "label": labels[s, i].astype(np.float32)} for i in range(GAN_K + 1)]
            for s in range(groups)]


def gan_on(batch, dev, dtype=torch.float32):
    """A batch on the card, its floats in `dtype`."""
    z1, label, z2 = batch["z"]
    on = lambda a: torch.from_numpy(np.asarray(a)).to(dev, dtype)  # noqa: E731
    return {"x": on(batch["x"]), "z": (on(z1), torch.from_numpy(label).to(dev), on(z2)),
            "label": on(batch["label"])}


def gan_engine(gen_weights, disc_weights, dev, conf, hps=None, dtype=torch.float32,
               compute=None):
    """The engine over the StyleGAN pair loaded from the weights; the
    parameters in `dtype`, the compute in `compute` (bf16) where given."""
    kw = {"dtype": compute} if compute is not None else {}
    gen = load_stylegan(StyleGANGenerator, conf, gen_weights, dev, **kw).to(dtype)
    disc = load_stylegan(StyleGANDiscriminator, GAN_DISC, disc_weights, dev, **kw).to(dtype)
    engine_conf = dict(GAN_ENGINE, hps=dict(GAN_ENGINE["hps"], **(hps or {})))
    engine = GAN(engine_conf, gen, disc).compose_gan_with_mode().compile()
    engine.init_state(seed=27)
    return engine


def adam_spread(grads, deltas, lr, b2=0.99, eps=1e-8):
    """The widest change of the sum of an entry's Adam updates (beta1 0)
    when each update's gradient moves within +-deltas[s] of grads[s]: a
    grid of 9 points a step. Where a gradient's range holds 0, the update
    can take either sign: there the bound is the whole range, twice the
    sum of the largest updates, lr sqrt((1 - b2^t) / (1 - b2)) at step t."""
    def total(gs):
        v, out = 0.0, 0.0
        for t, g in enumerate(gs, 1):
            v = b2 * v + (1 - b2) * g * g
            out = out + lr * g / (torch.sqrt(v / (1 - b2 ** t)) + eps)
        return out

    nominal = total(grads)
    spread = torch.zeros_like(nominal)
    for point in itertools.product(np.linspace(-1.0, 1.0, 9).tolist(), repeat=len(grads)):
        moved = total([g + o * d for g, o, d in zip(grads, point, deltas)])
        spread = torch.maximum(spread, (moved - nominal).abs())
    crosses = torch.zeros_like(nominal, dtype=torch.bool)
    for g, d in zip(grads, deltas):
        crosses |= g.abs() <= d
    whole = 2 * lr * sum(math.sqrt((1 - b2 ** t) / (1 - b2)) for t in range(1, len(grads) + 1))
    return torch.where(crosses, torch.full_like(spread, whole), spread)


def grad_deltas(grads, batch):
    """The tolerance of each gradient tensor: GAN_GRAD_REL of its largest entry;
    the discriminator's output bias is a difference of the real and the
    fake rows' terms, so 8 f32 ulps (2^-20) of their summed magnitude, at
    most 2 sum|label| / B (softplus' slope is at most 1, each row's logit is
    scaled by its label)."""
    out = {n: GAN_GRAD_REL * float(g.abs().max()) for n, g in grads.items()}
    if "dense_out.bias" in out:
        bound = 2.0 * float(np.abs(batch["label"]).sum()) / batch["label"].shape[0]
        out["dense_out.bias"] = max(out["dense_out.bias"], 2.0 ** -20 * bound)
    return out


def loss_tolerance(loss, logits, slopes):
    """GAN_REL of the loss plus what logits within GAN_REL of their largest
    entry can move it by, to first order (`slopes`: the loss's derivative
    in each logit)."""
    scale = max(float(d.abs().max()) for d in logits)
    return GAN_REL * abs(float(loss.detach())) + GAN_REL * scale * sum(
        float(s.abs().sum()) for s in slopes)


def gan_pieces(engine, batches):
    """The step taken piece by piece as train_step takes it (the k fakes,
    k D updates, one G update), on `engine`: each loss with its tolerance
    (loss_tolerance) and each update's gradient by parameter name."""
    draws = engine.state["gen"].generator
    b = batches[0]["x"].shape[0]
    losses, tols, grads = [], [], []

    def update(side, module, loss):
        g = torch.autograd.grad(loss, engine.state[side].params, allow_unused=True,
                                materialize_grads=True)
        grads.append(dict(zip([n for n, _ in module.named_parameters()], g)))
        engine.state[side].apply_gradients(g)
        losses.append(loss.detach())

    for batch, fake in zip(batches, engine._gen_fakes(batches[:GAN_K], draws)):
        loss = engine._disc_loss(batch, draws, fake)
        with torch.no_grad():
            d_real = engine.disc((batch["x"], batch["label"]))
            d_fake = engine.disc((fake, batch["label"]))
        tols.append(loss_tolerance(loss, (d_real, d_fake),
                                   (torch.sigmoid(-d_real) / b, torch.sigmoid(d_fake) / b)))
        update("disc", engine.disc, loss)
    batch = batches[GAN_K]
    loss = engine._gen_loss(batch, draws)
    with torch.no_grad():
        d_fake = engine.disc((engine._gen_fake(batch, draws), batch["label"]))
    tols.append(loss_tolerance(loss, (d_fake,), (torch.sigmoid(-d_fake) / b,)))
    update("gen", engine.gen, loss)
    return torch.stack(losses), tols, grads


def he_scaled(cls, conf, weights, dev, *inputs):
    """`weights` with each equalized-LR kernel scaled by sqrt(fan_in_call /
    fan_in_kernel). ku's equalized-LR layers take the fan-in of their
    coefficient from the input at call time, spatial size included
    (ku/nn/convolution.py, as the port does), so at 128 px each
    convolution shrinks its output by up to sqrt(128 * 128 / 1): with
    kernels of unit scale the discriminator's logit does not depend on its
    image (to ~1e-12) and the generator's gradient is ~1e-14, far below
    Adam's epsilon. The scaled kernels give each layer He's scale, so that
    every gradient of the step carries a check. The fan-ins are read by
    hooks from one forward on `inputs`."""
    module = load_stylegan(cls, conf, weights, dev)
    ratios, hooks = {}, []
    for name, sub in module.named_modules():
        if hasattr(sub, "gain") and isinstance(getattr(sub, "kernel", None), torch.nn.Parameter):
            def hook(sub, args, name=name):
                ratios[name] = math.prod(args[0].shape[1:]) / math.prod(sub.kernel.shape[:-1])
            hooks.append(sub.register_forward_pre_hook(hook))
    with torch.no_grad():
        module(inputs, deterministic=True)
    for h in hooks:
        h.remove()
    del module
    params = _flatten(weights[0])
    for name, ratio in ratios.items():
        key = name.replace(".", "/") + "/kernel"
        params[key] = (params[key] * math.sqrt(ratio)).astype(np.float32)
    return tree_from_state_dict(params), weights[1]


def gan_check(dev, gen_weights, disc_weights):
    """Phase 27 (a): one f32 train_step (TF32 off, mixing off, every noise
    weight 0) against the same step in float64 on the card, taken piece by
    piece with torch's own convolutions (cuDNN's float64 ones took most of
    the check's time), same batches (labels in GAN_CHECK_LABELS, so that no
    loss saturates) and weights (he_scaled, so that no gradient vanishes).

    - Each loss within loss_tolerance, and above 1e-3 (out of saturation,
      where its gradient carries the check).
    - The moving mean within GAN_REL of its largest entry.
    - Each update's gradient, the f32 step taken piece by piece against
      the float64 one, within grad_deltas.
    - Each parameter's change over the step (after - before) within
      GAN_REL of the float64 change's largest entry, plus the widest change
      of its Adam updates over gradients within grad_deltas (Adam's first
      update with beta1 0, lr g / (|g| + 1e-8), has a slope of 1e5 at g =
      0, so an entry whose gradient is within rounding of 0 moves by up to
      2 lr), plus f32's rounding of each update, 2^-24 of the entry's
      magnitude. A skipped update or one of the wrong sign misses by about
      lr. The noise weights move by about +-lr (their gradient is the
      noise's), held to |w| <= lr."""
    conf = dict(GAN_CONF, mixing_prob=None)
    batches = gan_batches(0, 1, GAN_CHECK_B, GAN_CHECK_LABELS)[0]
    one = gan_on(batches[0], dev)
    params, stats = he_scaled(StyleGANGenerator, conf, gen_weights, dev, *one["z"])
    params = tree_from_state_dict({k: (np.zeros_like(v) if k.endswith("noise_weight") else v)
                                   for k, v in _flatten(params).items()})
    disc_weights = he_scaled(StyleGANDiscriminator, GAN_DISC, disc_weights, dev, one["x"],
                             one["label"])
    f32, f64 = torch.float32, torch.float64

    pieces = {}
    for dtype in (f32, f64):
        engine = gan_engine((params, stats), disc_weights, dev, conf, dtype=dtype)
        before = {side: {n: p.detach().clone() for n, p in getattr(engine, side)
                         .named_parameters()} for side in ("disc", "gen")}
        torch.backends.cudnn.enabled = dtype == f32
        try:
            pieces[dtype] = (before, engine, *gan_pieces(engine, [gan_on(b, dev, dtype)
                                                                    for b in batches]))
        finally:
            torch.backends.cudnn.enabled = True
    before, ref, l64, tols, grads64 = pieces[f64]
    grads32 = pieces[f32][4]
    del pieces
    deltas = [grad_deltas(g, raw) for g, raw in zip(grads64, batches)]
    worst_grad = (0.0, "")
    for i, (got, want, delta) in enumerate(zip(grads32, grads64, deltas)):
        check(got.keys() == want.keys(), f"update {i}: parameter names differ")
        for name, w in want.items():
            if name.endswith("noise_weight"):
                continue
            err = float((got[name].double() - w).abs().max())
            check(err <= delta[name], f"GAN step update {i} gradient {name}: f32 against "
                  f"float64 {err:.3e} > {delta[name]:.3e}")
            worst_grad = max(worst_grad, (err / max(delta[name], 1e-300), f"{i} {name}"))

    engine = gan_engine((params, stats), disc_weights, dev, conf, dtype=f32)
    d, g_loss = engine.train_step([gan_on(b, dev, f32) for b in batches], GAN_K)
    torch.cuda.synchronize()
    l32 = torch.cat([d, g_loss[None]])
    mm_err = rel_err(engine.gen.truncation.moving_mean, ref.gen.truncation.moving_mean)
    check(mm_err <= GAN_REL, f"GAN step moving mean: f32 against float64 {mm_err:.3e}")
    loss_ratios = [abs(float(a) - float(b)) / t for a, b, t in zip(l32, l64, tols)]
    check(max(loss_ratios) <= 1.0, f"GAN step losses {l32.tolist()} against float64 "
          f"{l64.tolist()}: {loss_ratios} of their tolerances {tols}")
    check(float(l64.min()) > 1e-3, f"GAN step losses {l64.tolist()} saturated")
    worst = (0.0, "")
    updates = {"disc": grads64[:GAN_K], "gen": grads64[GAN_K:]}
    for side in ("disc", "gen"):
        lr, n = GAN_LR[side], len(updates[side])
        got = dict(getattr(engine, side).named_parameters())
        for name, want in getattr(ref, side).named_parameters():
            if name.endswith("noise_weight"):
                check(float(got[name].detach().abs().max()) <= lr * (1 + 1e-5)
                      and float(want.abs().max()) <= lr * (1 + 1e-9), f"{name} moved past lr")
                continue
            start = before[side][name]
            want = want.detach() - start
            err = ((got[name].detach().double() - start) - want).abs()
            tol = (GAN_REL * float(want.abs().max())
                   + adam_spread([g[name] for g in updates[side]],
                                 [dl[name] for dl in (deltas[:GAN_K] if side == "disc"
                                                      else deltas[GAN_K:])], lr)
                   + n * 2.0 ** -24 * (start.abs() + 2 * n * lr))
            ratio = float((err / tol).max())
            check(ratio <= 1.0, f"GAN step {side} {name}: change f32 against float64 "
                  f"{float(err.max()):.3e}, {ratio:.3f} of its tolerance")
            worst = max(worst, (ratio, f"{side} {name}"))
    log(f"GAN step at bench.py's conf, batch {GAN_CHECK_B}, labels {GAN_CHECK_LABELS[0]}-"
        f"{GAN_CHECK_LABELS[1] - 1}, f32 (TF32 off, no mixing, noise weights 0) against "
        f"float64 on the card: D losses {l32[:GAN_K].tolist()}, G loss {float(l32[GAN_K]):.6e} "
        f"(float64 {l64[:GAN_K].tolist()}, {float(l64[GAN_K]):.6e}), each at most "
        f"{max(loss_ratios):.3e} of its tolerance ({', '.join(f'{t:.3e}' for t in tols)}); "
        f"moving mean {mm_err:.3e} of its largest entry (limit {GAN_REL}); gradients at most "
        f"{worst_grad[0]:.3e} of their tolerance ({GAN_GRAD_REL} of each tensor's largest "
        f"entry; update {worst_grad[1]}); parameters' "
        f"changes at most {worst[0]:.3f} of their tolerance ({worst[1]})")


def step_flops(call):
    """FLOPs of the convolutions and products of one call, its backward
    passes included, from the shapes: torch.utils.flop_counter's formulas
    read by a dispatch mode (FlopCounterMode's module hooks refuse
    torch.autograd.grad, which R1 takes)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Count(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                Count.total += formula(*args, **kwargs, out_val=out)
            return out

    with Count():
        call()
    return Count.total


def gan_state_on(engine, dev) -> bool:
    """Every parameter, buffer and optimizer state tensor of the engine on
    the card, and its draws too."""
    tensors = [*engine.gen.parameters(), *engine.gen.buffers(), *engine.disc.parameters(),
               *engine.disc.buffers()]
    for side in ("gen", "disc"):
        for state in engine.state[side].optimizer.state.values():
            tensors += [v for k, v in state.items() if k != "step"]
    return (all(t.device.type == dev.type for t in tensors)
            and engine.state["gen"].generator.device.type == dev.type)


def gan_path(dev, name, gen_weights, disc_weights):
    """Phase 27 (b) and (c): fit_generator in bf16 at bench.py's conf, then
    the step timed, profiled and held against its bound; the `gan_step`
    JSON line."""
    groups = gan_batches(0, GAN_GROUPS, GAN_B)
    engine = gan_engine(gen_weights, disc_weights, dev, GAN_CONF,
                        hps={"epochs": 1, "batch_step": GAN_GROUPS}, compute=torch.bfloat16)
    wall = time.perf_counter()
    history = engine.fit_generator(iter([b for group in groups for b in group]), verbose=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall
    check(all(np.isfinite(v).all() for v in history.values()),
          f"fit_generator history not finite: {history}")
    check(gan_state_on(engine, dev), "a parameter, buffer or optimizer state left the card")
    check(engine.state["gen"].step == GAN_GROUPS
          and engine.state["disc"].step == GAN_GROUPS * GAN_K,
          f"steps {engine.state['gen'].step} / {engine.state['disc'].step}")
    log(f"GAN.fit_generator, bf16, {GAN_GROUPS} steps of batch {GAN_B}: history {history}, "
        f"{wall:.3f} s with the first steps' warm-up; every parameter, buffer and Adam "
        f"moment on the card")

    on_card = [[gan_on(b, dev) for b in group] for group in groups]
    step = lambda i=0: engine.train_step(on_card[i % GAN_GROUPS], GAN_K)  # noqa: E731
    for i in range(GAN_WARM):
        step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(GAN_REPS)]
    for i, (start, end) in enumerate(events):
        start.record()
        step(i)
        end.record()
    torch.cuda.synchronize()
    times = [s.elapsed_time(e) for s, e in events]
    ms = float(np.median(times))
    peak_bytes = torch.cuda.max_memory_allocated()
    prof_wall, rows, clocks = profiled(step)
    flops = step_flops(step)
    peak_f32, peak_bf16, peak_bw = peaks(name)
    params = [*engine.gen.parameters(), *engine.disc.parameters()]
    # Each parameter and its two Adam moments read once and written once,
    # f32; the step's K + 1 batches read once.
    nbytes = 6 * sum(p.numel() * p.element_size() for p in params) + sum(
        t.numel() * t.element_size() for b in on_card[0] for t in (b["x"], *b["z"], b["label"]))
    flops_ms, bytes_ms = flops / peak_bf16 * 1e3, nbytes / peak_bw * 1e3
    busy_us = sum(r[0] for r in rows)
    row = {"what": f"StyleGAN GAN step bf16, batch {GAN_B}, {GAN_K} D + 1 G updates",
           "ms_per_step": ms, "ms_min": min(times), "ms_max": max(times),
           "images_per_s": (GAN_K + 1) * GAN_B / (ms / 1e3),
           "device_ops": sum(r[1] for r in rows), "device_ms": busy_us / 1e3,
           "profiled_wall_ms": prof_wall * 1e3, "busy_share": busy_us / (prof_wall * 1e6),
           "gflop": flops / 1e9, "bytes": nbytes, "bound_ms": max(flops_ms, bytes_ms),
           "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
           "peak_memory_gib": peak_bytes / 2 ** 30}
    log(f"{row['what']}: {ms:.4f} ms a step (median of {GAN_REPS}, {min(times):.4f}.."
        f"{max(times):.4f}), {row['images_per_s']:.1f} images/s ((k + 1) B / step); bound "
        f"{row['bound_ms']:.4f} ms by {row['bound_by']} ({row['gflop']:.3f} GFLOP at the bf16 "
        f"peak, {nbytes / 1e6:.2f} MB), {ms / row['bound_ms']:.1f}x off; peak memory "
        f"{row['peak_memory_gib']:.3f} GiB")
    log_profile("one GAN step", prof_wall, rows, clocks)
    print(json.dumps({"gan_step": row}), flush=True)
    return row


def stylegan_gan(dev, name):
    """Phase 27."""
    cpu = torch.device("cpu")
    gen_weights = stylegan_weights(StyleGANGenerator(**GAN_CONF, device=cpu), seed=27)
    disc_weights = stylegan_weights(StyleGANDiscriminator(**GAN_DISC, device=cpu), seed=28)
    gan_check(dev, gen_weights, disc_weights)
    torch.cuda.empty_cache()
    gan_path(dev, name, gen_weights, disc_weights)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}; nvidia-smi: {card}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # 2. Build, one nvcc per source, all started together.
    t0 = time.perf_counter()
    # Kernel #1's probe build (phase 5's phase split) beside the six.
    specs = [(cd_gibbs.SOURCE, cd_gibbs.NAME), (cd_gibbs_dp.SOURCE, cd_gibbs_dp.NAME),
             (fa.SOURCE, fa.NAME), (fa.BWD_SOURCE, fa.BWD_NAME), (da.SOURCE, da.NAME),
             (sa.SOURCE, sa.NAME), (cd_gibbs.SOURCE, cd_gibbs.NAME + "_probe", ("-DCD_PROBE",))]
    built = _build.build_many(specs)
    log(f"build: {', '.join(lib.name for lib, _ in built)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for spec, (_, report) in zip(specs, built):
        lib_name = spec[1]
        BUILD_REPORTS[lib_name] = report
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  {lib_name}: {line.strip()}")
    for shape in ((BATCH, V_DIM, H_DIM), (BATCH, V_DIM, 256), (BATCH, 256, H_DIM),
                  (BATCH // DP_WORLD, V_DIM, H_DIM)):
        plan = cd_gibbs.cluster_plan(*shape)
        log(f"cluster plan at batch {shape[0]}, {shape[1]}x{shape[2]}: route {plan['route']}, "
            f"{plan['cluster']} blocks of {plan['nr']} rows and {plan['hc']} columns, batch "
            f"tile {plan['batch_tile']} ({plan['tiles']} a step), {plan['smem_bytes']} bytes "
            f"a block (at 8 blocks: batch tile "
            f"{cd_gibbs.cluster_plan(*shape, 8)['batch_tile']})")
    log(f"global route's cooperative grid at {V_DIM}x{H_DIM}, batch {BATCH}: "
        f"{cd_gibbs.grid_size(BATCH, V_DIM, H_DIM)} blocks; kernel #2's at "
        f"{BATCH} rows: {cd_gibbs_dp.grid_size(BATCH, V_DIM, H_DIM)}, at "
        f"{BATCH // DP_WORLD}: {cd_gibbs_dp.grid_size(BATCH // DP_WORLD, V_DIM, H_DIM)}")

    rbm_entry, V, fitted, kernel_one_ms = rbm_path(dev, name)
    kernels = [rbm_entry, dp_path(dev, name, V, fitted, kernel_one_ms)]
    del V, fitted
    kernels += serving_path(dev, name)
    torch.cuda.empty_cache()  # the serving models are gone with serving_path
    kernels += training_path(dev, name, next(e for e in kernels if e["name"] == "flash_fwd"))
    torch.cuda.empty_cache()  # the dense-attention training model is gone
    kernels += sparse_training_path(dev, name)
    torch.cuda.empty_cache()  # the sparse-training model is gone
    rbm_examples(dev)
    stylegan_path(dev, name)
    stylegan_gan(dev, name)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
