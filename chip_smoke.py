"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the hand-written kernels of deephumor_tpu_torch from ops/csrc/ and
drives the port's two serving paths, each after its kernels have been
held against their plain PyTorch twins at that path's shapes:

* word: CaptioningTransformer V=29184, hid 512, 6 layers, 8 heads, pf 2048,
  beam 5, len 32, top_k 64, bf16, sampler="pallas", batch 1792 (K1, K2,
  K3);
* char: the same widths at V=128, beam 7, len 128, top_k 50, temperature
  1.1, EOS bias 1.0, batch 768 (K1, K2, K3 for the first draw, K4, K5, K6;
  early-EOS compaction and canonical-prefix attention on by default). K1
  is also held against its twin at the char length with canon off
  (p_eff 128), in bf16 and f32, and at head_dim 24 (its CUDA-core kernel).

K2 is also held against its twin at the word shape in f32, without a
bias, at head_dim 24 (bf16 and f32: its CUDA-core kernel) and with 0 and
500 live items; K3 on rows planted with UNK as the maximum, one value
throughout, 2048 logits tied at the top (its candidate list overflows)
and ties at the threshold, at top_k == num_draws, with live_rows 0, 1 and
half, in f32 at V 29184 and 52000 (rows too long for its vector table),
and at V 3001 (rows that start unaligned), and timed beside torch.topk
alone (a partial yardstick).

Each path also runs with the two kernel-selecting switches:
DH_FUSED_SURVIVOR=1 (the survivor update in K10) and DH_CROSS_PACK=4
(decode cross-attention in K9, in groups of four items, over a store padded
to 56 rows; prefill stays on K2). Between the two paths, the other two
caption families run at the word settings: CaptioningTransformerBase
(decoder-only, global embedding; K1, K3) without and with
DH_FUSED_SURVIVOR=1 (adding K10), and CaptioningLSTM (emb 256, hidden
512, 3 layers; the classifier a bf16 product before K3), both from 1792
cached embeddings; the LSTMs, with and without labels, also from images.
Eight serving legs in all: word, word_fused, word_packed_fused, base,
base_fused, lstm, char and char_packed_fused.

The three kernels that no path of the JAX package launches on the device
run in kernel phases alone, each against its twin at the word shapes and
again at the char shapes: K7 (read-only ancestry attention, each TPU
layout), K8 (K1 with the caches read in 8-position tiles, timed beside
K1) and K11 (the in-place cache column write, exact). They launch 0
times on every leg.

Weights are random from a seed. For each model it checks greedy f32
generation through the kernels (for CaptioningTransformer also with both
switches, and char also with canon off) against the plain path on the
CPU, then runs each leg once with
every launch count at zero and fails if one of its kernels was not
launched or one off its leg was. word_fused and base_fused must give
their default legs' sequences and scores exactly. K1, K5 and K6 also run
on the fused QKV product's row-strided views, bit-equal to contiguous
copies and timed beside them; K6 writing into K5's output equals the
row-mask merge bit for bit. After the char leg, K6 is held against its
twin and timed at each straggler count that leg showed, as the decode
step calls it, with an int and a device count (bit-equal). Kernels
shorter than their wrapper's host work (K2, K3, K4, K5,
K6, K9, K10, K11) are timed with the device queued: K4 at all char rows
and at C_LIVE live rows, beside bf16 F.linear + K3 (the unfused route) and
F.linear alone; K9 at the word and char shapes beside K2 on the same rows.
torch.profiler tables (kernel time by name, the device's idle share)
follow the word, word_packed_fused, base, base_fused and lstm legs, and
end the char path: one more call without and one with both switches;
each also counts the call's copy, where and cat kernels.

After the legs, a serving phase drives the product path at the word
width: a 29,184-token vocabulary, 256 random 300x400 uint8 templates
preprocessed on the card (held to their CPU run, atol 1e-4) and encoded
through the ResNet-50 trunk into the pipeline's store (one template held
to the f32 encoder on the CPU), token ids decoded to text and re-encoded
to the same ids, then, with every launch count at zero, the HTTP server
(64 concurrent /caption requests, /captions with an unknown id, /meme,
/healthz) and 2,048 requests from 8 threads through the dynamic batcher
(max_batch 256, the "auto" bucket ladder: captions/s, p50 and p99
latency), and two batchers of one seed fed the same ids one by one. Only
K1, K2 and K3 may launch there, and no plain twin may see a CUDA tensor.
A subprocess then shows that two batchers' first calls, made together in
a cold process, build the kernel library once.

Last, a train phase ([12]) trains the word model at full width (the JAX
package's train measurement config, benchmarks/train_ab.py: default
dropouts, bf16 compute, batch 256, captions of 32 tokens + EOS, a cache
of 300 random templates' trunk features) for 32 steps of
``Trainer.run_epoch`` (prefetch 2) over ``BatchIterator`` batches of an
in-memory dataset, with every launch count at zero, captured (the
default: one CUDA graph per step key) and eager (``compiled=False``)
from one seed: the loss must fall (the mean of the last 5 steps below
that of the first 5), no kernel may launch, the ResNet and the
batch-norm statistics must get no optimizer update and the statistics
must move; the captured losses, parameters and moments must equal the
eager run's bit for bit (or lie within the gap between two eager runs,
when that is not 0), and every step after the first runs under the sync
debug mode. It prints each run's median step time (CUDA events at each
step's start, after 5 warm-up steps), examples/s, peak memory and the
step's floor, the captured key's first step (eager, then capture) and
the memory it holds, then profiles 5 more steps of each (idle share,
top device ops). The trained model is saved, loaded with
``from_pretrained`` and served at batch 64 (greedy and sampled): K1, K2
and K3 must launch and no plain twin may see a CUDA tensor. Then 3 steps
from 224 x 224 images through the ResNet (batch 32; it takes no
gradient), 3 f32 steps at 2 layers, batch 16, dropout 0 on the card and
on the CPU (losses to rtol 1e-4, parameters to atol 2e-4), and 3 f32
steps of each other captioner at small widths.

Then a parallel phase ([13]) runs deephumor_tpu_torch.parallel on this
one card: a one-rank NCCL group and ``make_mesh("cuda")`` (data 1).
``dp_generate`` at the word leg's width and settings (batch 1792, from
embeddings; greedy, then sampled twice with one seed), with every launch
count at zero: K1, K2 and K3 must launch and no plain twin may see a CUDA
tensor; greedy must be token-equal to ``generate_from_emb`` and the two
sampled calls equal; sampled calls are then timed in turns beside
``generate_from_emb``. The word Trainer takes 6 steps at full width
(bf16, batch 256, the trunk cache) without the mesh and with it, captured
(the default over NCCL: the step's all-reduces inside its graph) and
eager (``compiled=False``): median step times, the key's first step;
every all-reduce counted (``utils.collectives``: a captured graph adds
its tally at each replay), the BN moments twice a step and the
gradients once, all over NCCL on the card, the same captured and eager;
captured and eager bit-equal (losses, parameters, moments), every
captured step after the first under the sync debug mode; then 5 more
steps of each under the profiler (idle share; the captured trainer's
second epoch replays its first epoch's key). Then 72 captured mesh
steps at the trainer's default log_flush_every (64): the device memory
held after a step may not grow past one summed-gradient buffer on any
rank. Then 3 f32 steps at 2 layers, batch 16, dropout 0, without and
with the mesh (losses to rtol 1e-4, parameters to atol 2e-4, the first
step's summed gradient within P_GRAD_RTOL of the plain one and of a
plain step whose first forward takes the mesh's ReLU pattern, the first
forward's ReLU inputs within P_RELU_RTOL). On the data 1 x model 1
mesh, ``place_train_state`` places a Shard on the size-1 model axis, so
the DP x TP step and a decode given ``mesh.get_group("model")`` run
their model-axis all-reduces over a one-rank group: the word step
captured beside eager (bit-equal, the same all-reduces), and the word
decode at the word leg's width over the local shards with that group,
captured beside eager (``compare_compiled``: bit-equal greedy and
sampled, launches per call equal, K1-K3 and no twin on the card, no
device read in a step). Last, a mesh pipeline behind a
``DynamicBatcher`` answers 64 greedy requests, equal to the pipeline
without a mesh (K1 and K2 launch, no twin on the card), the graphs are
cleared and the group is destroyed. The mesh spans one card here: the
collectives are one-rank NCCL calls, and nothing in the phase measures
scaling.

Last, a tensor-parallel phase ([14]). K1 and K2 at the word leg's rows,
K5, K6 and K4 at the char settings are held against their twins at the
head-local shapes of the word model at model 2 (D 256, 4 heads) and
model 4 (D 128, 2 heads), bf16, and timed beside their bounds; K3 at the
rows of [14]'s calls. Then two processes on this card (``--tp-rank``; a
gloo group, since NCCL takes one rank per card, whose all-reduce,
broadcast and all-gather of CUDA tensors are checked first) form a data 1
x model 2 mesh: ``generate_from_emb`` over ``make_param_shardings``
parameters (``tp_generate``) greedy in f32 at TP_F32_LAYERS layers must
be token-equal to one process's call; at the word leg's width in bf16
(batch TP_BATCH) greedy must be token-equal on >= TP_GREEDY_SHARE of
items, two sampled calls of one seed equal and equal on both ranks, and
each rank must launch K1, K2 and K3 and no other kernel, no twin seeing a
CUDA tensor (each rank's counts set to 0 before and read after); sampled
calls are timed in turns beside one process's call; T_PAR_STEPS f32 DP x
TP train steps at TP_F32_LAYERS layers, at the model's dropout, must give
the losses of one process that draws from the data block's generator
(rtol TP_TRAIN_RTOL), with at most a share TP_PARAM_SHARE of the trained
parameters past 2e-4 (the leaves past it are listed with their first-step
gradient and the rows that hold them). Each rank cuts its own shards of its equal copy and gathers
with ``dist.all_gather``: gloo scatters no CUDA tensor for
``distribute_tensor``, and ``full_tensor``'s functional collectives fail
there. The phase says nothing of scaling: both ranks share the card and
gloo stages each all-reduce through host memory.

Last, a product-surface phase ([15]). The C++ text core
(deephumor_tpu_torch.native) must build anew with this host's g++; a
memes900k-shaped train split (X_TEMPLATES templates x X_CAPTIONS captions
over the word vocabulary, written from a seed) goes through
``MemeDataset.materialize``, and the C++ ids and lengths must equal the
Python path's on a word sample of X_SAMPLE captions and a char sample
(both paths' captions/s on the host clock). K3 and K4 are held to their
twins and timed at the shapes the sweep and the demo give them, and K4
also at V 257 and 16,384 (K4 past V 256 runs its streamed path: the
product on the tensor cores into an L2-sized scratch, then K3's row
body). Then, with every launch count
at zero, ``sweep.main(["--synthetic"])``: 3,000 captions over 300
templates through the ResNet trunk and the pipeline (the phase's main
path; K1, K2, K3 for the first draw and K4 for the others (V 2,006) and
no other kernel, no twin on a CUDA tensor, captions in the
vocabulary without UNK; encode time, captions/s, first call and steady
state). ``generate_meme``: a reference-layout ``.pth`` of the word width
loaded with ``from_torch`` must give the weights written, and
``caption_image`` greedy at beam 1 (without and with a starting caption)
the CPU's text exactly. The demo's four architectures on X_DEMO_ITEMS images, word then
char, with the sampler kernels (char through compaction and canon: K4,
K5 and K6 must launch). An ExperimentConfig must survive JSON and build
the word model, and a word Trainer state ``save_state`` /
``restore_state`` must come back bit-equal, onto its template and whole.

Last, a compiled-generation phase ([16]). Every path above runs its
decode loop as CUDA graphs by default (models/graphs.py: every phase
and every phase boundary, char's included). K3 and K4 take the step's
seed from device memory: held to the int seed (equal draws) and to the
twin, and timed in both forms, K3 at word's rows, K4 at the sweep's and
char's. K1-K6, K9 and K10 take the count that a boundary sets (live
items, K3/K4's live rows, K6's stragglers) from device memory: at the
char shapes, at counts of 0, some and all (K6: 0, 1 and 8 stragglers,
both forms on one grid), held to the int count (bit-equal outputs) and
timed in both forms; K4 also on its streamed path.
Greedy text of the captured path at a small size (2 layers, hid 64, V
300, 8 items, f32) must equal the CPU's for the three families. Then
word, Base and LSTM (batch 1792), the sweep's shape (V 2,006, batch 256)
and char (batch 768, full width and depth) each run captured beside
eager (``compiled=False``) from the same inputs and generator seed:
sequences, scores, chosen and ended bit-equal, sampled
(``sampler="pallas"``) and greedy, boundaries equal, the same launches
per call and no eager tail; each path's captions/s (median of G_CALLS
calls of each, in turns; char G_CHAR_CALLS), the idle share of one
profiled call of each, the first captured call's time (warm-up and
capture), its graphs and the memory its key holds; and one call of each
path under ``torch.cuda.set_sync_debug_mode("error")``, with only the
reads through ``sampling.host_read`` allowed (``ended.all()`` between
graphs or eager steps, the boundaries' counts after the last graph). A
second temperature on a word key replays that key and draws what the
eager loop draws at it. ``generate`` from 224 x 224 images (the encoder
inside the prefill's graph) is held and timed the same way for the word
model at one image and at G_IMAGES and for the labelled LSTM at
G_IMAGES, then timed beside the encoder run eagerly before the captured
decode (outputs bit-equal); ``Trainer.build_trunk_cache`` over
T_TEMPLATES templates runs captured and eager in turns (features
bit-equal). Last, a burst of G_REQUESTS requests through
a warmed ``DynamicBatcher`` (buckets "auto") over a 32-template word
pipeline, captured and eager in turns, twice each, after the pipeline's
call of one full batch gave the same texts captured and eager.

Last, a Kimi-VL phase ([17]) at the kimi_vl.offline cell's shapes: K12
(the absorbed latent attention: 768 items x beam 5 x 16 heads over 64
prefix rows and a searched or all-distinct ancestry at three generated
positions), moe.cu's gather, SwiGLU and combine (3,840 tokens x 6 of 64
experts, 16 held) and K3 over [3,840, 163,840] bf16 rows (its streamed
path) are held to their twins, each tolerance failed by planted wrong
answers (the ancestry ignored, a row left out, gate and up swapped, the
absent experts' pairs added), and timed beside their twins and floors;
f32 and an unaligned width must raise on the card. Then
``CaptioningMLAMoE.generate_from_emb`` at Kimi-VL-A3B-Instruct's
published widths (27 layers, 16 of 64 experts held, V 163,840, bf16,
batch 768), with every launch count at zero: K12 once a layer-step,
each moe.cu kernel once an expert layer's prefill pass and step, K3
once a step, no other kernel and no twin on a CUDA tensor; then a
profiled call.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times [ROOT]
    python3 chip_smoke.py --leg-times [ROOT]
    python3 chip_smoke.py --tp
    python3 chip_smoke.py --product
    python3 chip_smoke.py --compiled
    python3 chip_smoke.py --train
    python3 chip_smoke.py --parallel
    python3 chip_smoke.py --kimi
    torchrun --nproc-per-node N chip_smoke.py --mesh-ranks [tp]

The second form only times K3 and K8 (word, first), K4 (all char rows,
C_LIVE live, and at X_SHAPES), K3 (the sweep's first draw), K9 (ng 2, 4,
8) and K2 on K9's rows, queued, through the deephumor_tpu_torch of the
tree at ROOT (default: this one), and prints one JSON line: run beside
a parent tree's root, it times the parent's kernels on the same inputs.
``--leg-times`` runs the word and char legs captured through the tree at
ROOT (captions/s of 10 calls, one profiled call's kernel time, idle
share and copy / where / cat kernels) and times K6 at 0-8 stragglers
with an int and a device count; one JSON line, for the same comparison.
The fourth builds the kernels and runs [14] alone, the fifth [15], the
sixth [16], the seventh [12], the eighth [13], the ninth [17]. The tenth
runs over N
ranks, one per card (N = 2 or 4), each phase within MESH_PHASE_S
seconds (a replayed collective is out of the process group's watchdog),
after printing the link between the cards: first [14]'s data N/2 x
model 2 NCCL mesh, ``tp_generate`` at the word leg (batch BATCH)
captured beside eager (bit-equal sampled and greedy on every rank,
launches per call equal, K1-K3 and no twin, no device read in the
rank's decode; greedy on >= TP_GREEDY_SHARE of items equal to one
card's call) timed in turns beside one card's captured call, and the
data-parallel step over every card and the DP x TP train step (bf16,
batch T_BATCH), each captured beside eager (bit-equal, the same
all-reduces), timed in turns beside one card's captured step; then,
unless given ``tp``, [13]'s checks over N ranks: each dp_generate and
mesh step does 1/N of the batch, timed beside a one-card plain call.
Greedy outputs are held to plain calls on each rank's block
(the same products; one call of the whole batch rounds its bf16
products at other shapes, and its share of equal items is reported).
The f32 mesh steps are held by their losses, ReLU inputs and the masked
plain gradient as on one card; their first summed gradient within
P_GRAD_RTOL_RANKS of the plain one (a ReLU input that rounds to the
other side of 0 at the local shape moves a whole outer product of the
gradients); at most a share P_PARAM_SHARE of the trained parameters past
2e-4 (Adam turns gradients that are rounding noise into steps of up to
lr). Mesh steps that take each shard's own means of the loss must fail
the three gates: they see that fault.

Exits non-zero, printing no result, without a CUDA device. Its last line
is ``{"ok": true, "device": {...}}``; the line before it gives the card's
name and power limit, and the one before that a JSON summary of the
kernels (times, launches per path, bounds, library yardsticks).
"""

import contextlib
import gc
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np
import torch

# word serving config (the JAX package's bench.py headline leg)
VOCAB, HID, LAYERS, HEADS, PF = 29184, 512, 6, 8, 2048
BEAM, MAX_LEN, TOP_K, BATCH, EOS_BIAS = 5, 32, 64, 1792, 1.5
ROWS, P, T_ENC = BATCH * BEAM, 40, 49
T_PAD, PACK = 56, 4  # the packed legs' padded cross store, items per block
# the LSTM leg (bench.py:164-194): emb 256, hidden 512, 3 layers
L_EMB, L_HID, L_LAYERS = 256, 512, 3
# char serving config (bench.py:63-70,225-251)
C_VOCAB, C_BEAM, C_LEN, C_TOP_K, C_BATCH = 128, 7, 128, 50, 768
C_EOS_BIAS, C_TEMP = 1.0, 1.1
# the greedy char check takes the first of these EOS biases at which a
# quarter of its items have ended by the last compaction while a canon
# boundary still has stragglers
C_GREEDY_EOS_BIASES = (0.0, 0.25, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
C_ROWS, C_P = C_BATCH * C_BEAM, 136  # 129 positions, padded to 8
C_LIVE = 160 * C_BEAM  # K4's rows in a late char step (~160 live items)
# the serving phase: templates, their size, the encoder's batch; the
# batcher's largest batch, the requests through it and their threads, and
# the concurrent HTTP requests
S_TEMPLATES, S_HW, S_CHUNK = 256, (300, 400), 32
S_MAX_BATCH, S_REQUESTS, S_THREADS, S_HTTP = 256, 2048, 8, 64
# a random classifier can draw PAD and, at the word legs' EOS bias, ends
# some captions at their first token; a trained captioner does neither.
# The served model pushes PAD down and takes an EOS bias that rarely ends
# a caption, so that the checks of the answers (non-empty, no PAD) test
# the serving path; the id round trip runs at both EOS biases
S_EOS_BIAS, S_PAD_BIAS = 0.5, -1e4
S_PRE_TOL = 1e-4  # preprocess_batch on the card vs on the CPU
S_ENC_TOL = 1e-3  # f32 encoder on the card (cuDNN, no TF32) vs the CPU
# the train phase: the JAX package's train measurement config
# (benchmarks/train_ab.py:30-45): the word model at its default dropouts,
# bf16 compute, batch 256, captions of 32 tokens + EOS, a trunk-feature
# cache of 300 templates; a caption per template, so that the set can be
# memorised. f32 parity with the CPU at 2 layers, batch 16; images through
# the ResNet at batch 32; the other captioners at small widths
T_BATCH, T_CAP, T_TEMPLATES, T_ITEMS = 256, 32, 300, 8192
T_STEPS, T_WARM, T_PROFILED = 32, 5, 5
T_PAR_LAYERS, T_PAR_BATCH, T_PAR_STEPS = 2, 16, 3
T_IMG_BATCH, T_SERVE_BATCH = 32, 64
T_PAR_RTOL, T_PAR_ATOL = 1e-4, 2e-4  # f32 card vs CPU: loss, parameters
# the parallel phase: word train steps with and without the mesh, the
# first P_WARM of them out of the median; the mesh batcher's requests
# over its templates
P_STEPS, P_WARM = 6, 2
# the mesh's memory check: steps past the trainer's log_flush_every
P_MEM_EXTRA = 8
P_REQUESTS, P_TEMPLATES = 64, 32
# f32, the mesh's steps vs the plain ones (parallel_train): the first
# summed gradient (norm of the difference over the norm) against the plain
# step's with the mesh's ReLU pattern, or on one rank the plain step's
# (f32 rounding alone, ~1e-6), and over several ranks the plain step's
# (where a ReLU input rounds to the other side of 0: 1.67e-4 at 2 H100s);
# the first forward's ReLU inputs (largest gap over the largest input);
# over several ranks, the share of trained parameters past T_PAR_ATOL
P_GRAD_RTOL, P_GRAD_RTOL_RANKS = 1e-5, 1e-3
P_RELU_RTOL, P_PARAM_SHARE = 1e-4, 1e-3
# the tensor-parallel phase ([14]): the head-local (width, heads) of the
# word model at model 2 and 4 (head_dim 64 in both); the batch of its
# two-process tp_generate calls on one card and of the f32 parity, the
# f32 parity's layers; the bf16 greedy gate (PERF.md section 2), the f32
# train steps' loss tolerance; the time limit of the two processes
TP_SHAPES = ((HID // 2, HEADS // 2), (HID // 4, HEADS // 4))
TP_RANKS, TP_BATCH, TP_F32_ITEMS, TP_F32_LAYERS = 2, 256, 64, 2
TP_GREEDY_SHARE, TP_TRAIN_RTOL, TP_TIMEOUT_S = 0.99, 1e-4, 600
# --mesh-ranks: the seconds a phase may take on a rank before it exits
MESH_PHASE_S = 300
# the share of the f32 DP x TP run's trained parameters past T_PAR_ATOL of
# one card's: elements whose gradient changes sign between the runs
# (rounding noise, a ReLU input that rounds across 0 at the head-local
# shapes) take Adam steps of up to lr the other way. PR 12 read 3.48e-6
# (137 of 39,397,376) on an H100
TP_PARAM_SHARE = 1e-4
# the product-surface phase ([15]): a memes900k-shaped train split for the
# text core (split_data's defaults: 300 templates x 2,500 captions) over
# the word vocabulary, TrainConfig's lengths, the samples that hold the
# C++ path to the Python one (word, char); the demo's items (enough for
# char's early-EOS compaction and canon stragglers)
X_TEMPLATES, X_CAPTIONS, X_CAP_LEN, X_LAB_LEN = 300, 2500, 32, 8
X_SAMPLE, X_CHAR_SAMPLE, X_CHAR_LEN, X_DEMO_ITEMS = 50_000, 5_000, 128, 64
# K3 and K4 at the shapes [15]'s paths give them: path, items, beam, top_k,
# V, D, 1/T. The sweep (batch 256, beam 5, top_k 64, V 2,006, D 512), the
# demo's word leg (64 images, beam 10, top_k 70, V 506, D 64) and char leg
# (V 37, top_k 37, beam 7, 1/T 1/1.1); and at the sweep's rows, K4's
# streamed path at its ends: V 257 (the smallest past the resident body)
# and FUSED_CLASSIFIER_MAX_V
# the compiled phase ([16]): timed calls of each path and of char, and the
# batcher burst's requests
G_CALLS, G_CHAR_CALLS, G_REQUESTS = 10, 5, 1024
G_IMAGES = 64  # generate from images ([16]): the word and labelled LSTM
X_SHAPES = (("sweep", 256, 5, 64, 2006, HID, 1.0),
            ("demo_word", X_DEMO_ITEMS, 10, 70, 506, 64, 1.0),
            ("demo_char", X_DEMO_ITEMS, 7, 37, 37, 64, 1 / 1.1),
            ("v257", 256, 5, 64, 257, HID, 1.0),
            ("v16384", 256, 5, 64, 16384, HID, 1.0))
# the Kimi-VL phase ([17]) at the kimi_vl.offline cell's shapes
# (perfbench/configs/kimi_vl.json): CaptioningMLAMoE at Kimi-VL-A3B-
# Instruct's published widths with 16 of its 64 routed experts held (one
# card of an EP4 host), 768 items of 64 prefix rows, beam 5, 32 tokens,
# top_k 64, V 163,840; the head's EOS row zeroed and its bias K_EOS_BIAS,
# as the cell's assumed shaping; K12 at the first, a middle and the last
# step's generated positions
K_ITEMS, K_PREFIX, K_HELD, K_VOCAB = 768, 64, 16, 163840
K_BEAM, K_LEN, K_TOP_K, K_EOS_BIAS = 5, 32, 64, 2.2
K_ROWS, K_PES = K_ITEMS * K_BEAM, (1, 16, 31)
# K12 and moe.cu's SwiGLU and combine vs their twins: each element within
# K_RTOL of its own size plus K_RTOL of the twin's RMS (a few bf16
# roundings, 2^-8 of a value each); the gather is a copy (exact)
K_RTOL = 2 ** -6
TOL = 2e-2  # bf16 kernel vs twin: one bf16 rounding of each output
TOL_F32 = 1e-5  # f32 kernel vs twin: the summation order only
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SPIN_CYCLES = 50_000_000  # ~25 ms of the device's clock: outlasts an enqueue


def log(*args):
    # under torchrun (--mesh-ranks) only rank 0 speaks
    if os.environ.get("RANK", "0") == "0":
        print(*args, flush=True)


@contextlib.contextmanager
def switches(pack=0, fused=False):
    """Runs the block with DH_CROSS_PACK / DH_FUSED_SURVIVOR set as given
    (unset when 0 / False), and restores the environment after."""
    keys = ("DH_CROSS_PACK", "DH_FUSED_SURVIVOR")
    old = {k: os.environ.pop(k, None) for k in keys}
    if pack:
        os.environ["DH_CROSS_PACK"] = str(pack)
    if fused:
        os.environ["DH_FUSED_SURVIVOR"] = "1"
    try:
        yield
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=2, queued=False):
    """Mean CUDA-event time of one call, after ``warmup`` calls. With
    ``queued`` the device first spins while the host enqueues every call,
    so that calls shorter than their own host overhead are timed on the
    device alone (fails if the spin ended before the last was enqueued)."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    if queued and start.query():
        raise AssertionError("timing: the spin ended before every call was "
                             "enqueued")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops, dtype):
    """The least time the card could take: the bytes each input is read
    and each output written once over the memory rate, or the operations
    over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def library_ms(fn):
    """Time of one PyTorch call computing the same function (yardstick
    only: the port never calls it)."""
    return cuda_ms(fn, iters=5)


def heads(x, n, length, h=HEADS):
    """[n, length, D] -> the [n, h, length, hd] layout of SDPA."""
    return x.reshape(n, length, h, -1).transpose(1, 2).contiguous()


def sdpa(q, k, v, mask):
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)


def attention_state(A, dev, gen, *, items, beam, p, pos, dt):
    """q, caches, k_new, v_new and the ancestry bias of a decode state at
    ``pos`` (valid positions at most ``pos``)."""
    rows = items * beam
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)  # noqa
    anc = torch.randint(0, beam, (items, beam, p), generator=gen, device=dev)
    valid = torch.rand(rows, p, generator=gen, device=dev) < 0.8
    valid[:, pos + 1:] = False
    valid[:, 0] = valid[:, pos] = True
    return (rnd(rows, HID), rnd(rows, p, HID), rnd(rows, p, HID),
            rnd(rows, HID), rnd(rows, HID), A.ancestry_bias(anc, valid, p))


def ancestry_sdpa_ms(q, k, v, bias, items, beam, p, pe, h=HEADS):
    """One SDPA call over the (slot, position) rows [0, pe) of every item
    with the same bias: the library yardstick of K1, K7 and K8."""
    qh = q.reshape(items, beam, h, -1).transpose(1, 2)
    kh, vh = (heads(x[:, :pe].reshape(items, beam * pe, x.shape[-1]), items,
                    beam * pe, h) for x in (k, v))
    mask = bias.reshape(items, beam, beam, p)[..., :pe].reshape(
        items, 1, beam, beam * pe).contiguous()
    return library_ms(lambda: sdpa(qh, kh, vh, mask))


def k1_bytes(live, beam, pe, elt, d=HID):
    """K/V prefix without the column at pos (pe - 1 positions: pos lies
    inside the prefix, and the kernels read it from k_new / v_new), q,
    k_new, v_new, out and the two written columns, plus the bias over the
    read positions."""
    lr = live * beam
    return (2 * lr * (pe - 1) * d + 6 * lr * d) * elt \
        + lr * beam * pe * 4


def fused_views(*ts):
    """q, k_new, v_new (each [rows, d]) copied into the three column
    views of one [rows, 3 d] tensor: rows 3 d apart, as decode_step's fused
    QKV product hands them to K1, K5 and K6."""
    rows, d = ts[0].shape
    base = torch.empty(rows, 3 * d, dtype=ts[0].dtype, device=ts[0].device)
    views = base.split(d, -1)
    for view, t in zip(views, ts):
        view.copy_(t)
    return views


def check_strided(label, run, views, timed):
    """``run(q, k_new, v_new, fresh)`` -> tensors (outputs, written
    caches; on fresh copies of what the kernel writes with ``fresh``) on
    the fused product's row-strided views and on contiguous copies: bit
    equal. Returns (strided ms, contiguous ms), queued, with ``timed``."""
    copies = [v.contiguous() for v in views]
    got, want = run(*views, True), run(*copies, True)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{label}: row-strided q/k/v views give other "
                             f"outputs than contiguous copies")
    if not timed:
        log(f"  {label} on the fused QKV product's views (rows "
            f"{views[0].stride(0)} apart): bit-equal to contiguous copies")
        return None
    ms = (cuda_ms(lambda: run(*views, False), queued=True),
          cuda_ms(lambda: run(*copies, False), queued=True))
    log(f"  {label} on the fused QKV product's views (rows "
        f"{views[0].stride(0)} apart): bit-equal to contiguous copies; "
        f"{ms[0]:.4f} ms strided, {ms[1]:.4f} ms contiguous (queued)")
    return ms


def check_k1(A, dev, gen, *, items, beam, p, pes, dt, live_items=None,
             label="K1", d=HID, heads=HEADS, timed=True):
    """K1 vs twin for each p_eff; caches bit-equal, rows past live_items
    zero; at the last p_eff also on the fused QKV product's row-strided
    views, bit-equal to contiguous copies. Returns the last p_eff's
    measurements (with ``timed``)."""
    rows = items * beam
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)  # noqa
    ck, cv = rnd(rows, p, d), rnd(rows, p, d)
    err = 0.0
    for pe in pes:
        pos = pe - 1
        q, kn, vn = rnd(rows, d), rnd(rows, d), rnd(rows, d)
        anc = torch.randint(0, beam, (items, beam, p), generator=gen,
                            device=dev)
        valid = torch.rand(rows, p, generator=gen, device=dev) < 0.8
        valid[:, pos + 1:] = False
        valid[:, 0] = valid[:, pos] = True
        bias = A.ancestry_bias(anc, valid, p)
        caches = [(ck.clone(), cv.clone()) for _ in range(2)]
        kw = dict(beam=beam, n_heads=heads, p_eff=pe, live_items=live_items)
        got = A.ancestry_attention_update(q, *caches[0], kn, vn, bias, pos,
                                          **kw)
        want = A.ancestry_attention_update_plain(q, *caches[1], kn, vn,
                                                 bias, pos, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(caches[0][0], caches[1][0])
                and torch.equal(caches[0][1], caches[1][1])):
            raise AssertionError(f"{label} p_eff={pe}: written caches differ")
        tol = TOL if dt == torch.bfloat16 else TOL_F32
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
        if live_items is not None and got[live_items * beam:].any():
            raise AssertionError(f"{label}: rows past live_items are not 0")
        e = (got.float() - want.float()).abs().max().item()
        err = max(err, e)
        log(f"  {label} {str(dt)[6:]} head_dim {d // heads} p_eff={pe} "
            f"live_items={live_items}: caches bit-equal, max|out-twin|="
            f"{e:.3e} (atol=rtol={tol})")
    k, v = caches[0]

    def run(q_, kn_, vn_, fresh):
        # the same column rewritten in place with the same values: timed
        # without the copies
        ck_, cv_ = (k.clone(), v.clone()) if fresh else (k, v)
        return (A.ancestry_attention_update(q_, ck_, cv_, kn_, vn_, bias, pos,
                                            **kw), ck_, cv_)

    strided = check_strided(f"{label} {str(dt)[6:]} p_eff={pos + 1}", run,
                            fused_views(q, kn, vn), timed)
    if not timed:
        return None
    ms = cuda_ms(lambda: A.ancestry_attention_update(
        q, k, v, kn, vn, bias, pos, **kw))
    plain_ms = cuda_ms(lambda: A.ancestry_attention_update_plain(
        q, k, v, kn, vn, bias, pos, **kw), iters=3)
    live = items if live_items is None else live_items
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                ms_strided=strided[0], ms_contiguous=strided[1],
                library_ms=ancestry_sdpa_ms(q, k, v, bias, items, beam, p, pe,
                                            heads),
                **bound(k1_bytes(live, beam, pe, k.element_size(), d),
                        4 * live * beam * beam * pe * d, dt))


def check_k7(A, dev, gen, *, items, beam, p, cases, label):
    """K7 vs its twin for each (impl, p_eff) of ``cases`` (valid
    positions below the smallest p_eff); returns the first case's
    measurements."""
    dt = torch.bfloat16
    pos = min(pe or p for _, pe in cases) - 1
    q, ck, cv, _, _, bias = attention_state(A, dev, gen, items=items,
                                            beam=beam, p=p, pos=pos, dt=dt)
    err, row = 0.0, None
    for impl, p_eff in cases:
        kw = dict(beam=beam, n_heads=HEADS, impl=impl, p_eff=p_eff)
        got = A.ancestry_attention(q, ck, cv, bias, **kw)
        want = A.ancestry_attention_plain(q, ck, cv, bias, **kw)
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
        e = (got.float() - want.float()).abs().max().item()
        err = max(err, e)
        ms = cuda_ms(lambda: A.ancestry_attention(q, ck, cv, bias, **kw))
        pe = p if impl != "native4d" or p_eff is None else p_eff
        log(f"  {label} impl={impl} p_eff={p_eff} (reads {pe} positions): "
            f"max|out-twin|={e:.3e} (atol=rtol={TOL}), {ms:.4f} ms")
        if row is None:
            rows = items * beam
            nbytes = (2 * rows * pe * HID + 2 * rows * HID) * 2 + (
                rows * beam * pe * 4)
            row = dict(ms=ms, plain_ms=cuda_ms(
                lambda: A.ancestry_attention_plain(q, ck, cv, bias, **kw),
                iters=3), library_ms=ancestry_sdpa_ms(
                    q, ck, cv, bias, items, beam, p, pe),
                **bound(nbytes, 4 * rows * beam * pe * HID, dt))
    return dict(row, max_abs_err=err)


def check_k8(A, dev, gen, *, items, beam, p, positions, label):
    """K8 vs its twin at each decode position (written caches bit-equal),
    timed beside K1 at the same read length; returns the last position's
    measurements."""
    dt = torch.bfloat16
    err = 0.0
    for pos in positions:
        q, ck, cv, kn, vn, bias = attention_state(
            A, dev, gen, items=items, beam=beam, p=p, pos=pos, dt=dt)
        caches = [(ck.clone(), cv.clone()) for _ in range(2)]
        kw = dict(beam=beam, n_heads=HEADS)
        got = A.ancestry_attention_update_flash(q, *caches[0], kn, vn, bias,
                                                pos, **kw)
        want = A.ancestry_attention_update_flash_plain(
            q, *caches[1], kn, vn, bias, pos, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(caches[0][0], caches[1][0])
                and torch.equal(caches[0][1], caches[1][1])):
            raise AssertionError(f"{label} pos={pos}: written caches differ")
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
        e = (got.float() - want.float()).abs().max().item()
        err = max(err, e)
        k, v = caches[0]
        ms = cuda_ms(lambda: A.ancestry_attention_update_flash(
            q, k, v, kn, vn, bias, pos, **kw))
        pe = 8 * (pos // 8 + 1)
        k1_ms = cuda_ms(lambda: A.ancestry_attention_update(
            q, k, v, kn, vn, bias, pos, p_eff=pe, **kw))
        log(f"  {label} pos={pos} (tiles through p_eff {pe}): caches "
            f"bit-equal, max|out-twin|={e:.3e} (atol=rtol={TOL}), "
            f"{ms:.4f} ms; K1 at p_eff {pe}: {k1_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=cuda_ms(
        lambda: A.ancestry_attention_update_flash_plain(
            q, k, v, kn, vn, bias, pos, **kw), iters=3),
        library_ms=ancestry_sdpa_ms(q, k, v, bias, items, beam, p, pe),
        **bound(k1_bytes(items, beam, pe, k.element_size()),
                4 * items * beam * beam * pe * HID, dt))


def check_k11(C, dev, gen, *, rows, p, positions, label):
    """K11 vs its twin at each position, bf16 caches from bf16 and from
    f32 columns: caches exactly equal. Returns the bf16 -> bf16
    measurements."""
    bf = torch.bfloat16
    ck, cv = (torch.randn(rows, p, HID, generator=gen, device=dev).to(bf)
              for _ in range(2))
    row = None
    for new_dt in (bf, torch.float32):
        news = [[torch.randn(rows, HID, generator=gen, device=dev).to(new_dt)
                 for _ in range(2)] for _ in range(8)]
        for pos in positions:
            got = C.cache_column_write(ck.clone(), cv.clone(), *news[0], pos)
            want = C.cache_column_write_plain(ck.clone(), cv.clone(),
                                              *news[0], pos)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{label} pos={pos} {new_dt}: caches "
                                     f"differ from the twin's")
        # eight column pairs written at eight positions, over 100 MB in
        # all: each timed call reads inputs that have left the 50 MB L2
        calls = itertools.cycle([(kn, vn, 5 * i % p)
                                 for i, (kn, vn) in enumerate(news)])
        k, v = ck.clone(), cv.clone()
        ms = cuda_ms(lambda: C.cache_column_write(k, v, *next(calls)),
                     queued=True)
        log(f"  {label} rows={rows} P={p} pos={positions} new {new_dt}: "
            f"caches equal to the twin's; {ms:.4f} ms (inputs cold in L2)")
        if row is None:
            def copies(kn, vn, pos):
                k[:, pos].copy_(kn)
                v[:, pos].copy_(vn)

            row = dict(ms=ms, max_abs_err=0.0, plain_ms=cuda_ms(
                lambda: C.cache_column_write_plain(k, v, *next(calls)),
                queued=True), library_ms=cuda_ms(
                lambda: copies(*next(calls)), queued=True),
                # read both new columns, write both cache columns
                **bound(4 * rows * HID * 2, 0, bf))
    return row


def check_k2(A, dev, gen, *, items, beam, live_items=None,
             dt=torch.bfloat16, d=HID, masked=True, timed=True,
             n_heads=HEADS):
    """K2 vs its twin with item 0's encoder rows all masked (or no bias),
    finite, rows past live_items zero. With ``timed``: the kernel, the
    twin and SDPA."""
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)  # noqa
    q, ek, ev = rnd(items * beam, d), rnd(items, T_ENC, d), rnd(
        items, T_ENC, d)
    bias = None
    if masked:
        mask = torch.rand(items, T_ENC, generator=gen, device=dev) < 0.1
        mask[0] = True  # one item with every encoder row masked
        bias = torch.where(mask[:, None, :], A.MASK_FILL, 0.0).float()
    kw = dict(n_heads=n_heads, live_items=live_items)
    got = A.grouped_cross_attention(q, ek, ev, bias, **kw)
    want = A.grouped_cross_attention_plain(q, ek, ev, bias, **kw)
    tol = TOL if dt == torch.bfloat16 else TOL_F32
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    live = items if live_items is None else live_items
    if not torch.isfinite(got.float()).all():
        raise AssertionError("K2: output not finite (item 0 fully masked)")
    if got[live * beam:].any():
        raise AssertionError("K2: rows past live_items are not 0")
    err = (got.float() - want.float()).abs().max().item()
    log(f"  K2 {str(dt)[6:]} head_dim {d // n_heads} G={items} r={beam} bias="
        f"{'item 0 fully masked' if masked else None} live_items="
        f"{live_items}: max|out-twin|={err:.3e} (atol=rtol={tol})")
    if not timed:
        return None
    ms = cuda_ms(lambda: A.grouped_cross_attention(q, ek, ev, bias, **kw),
                 queued=True)
    plain_ms = cuda_ms(lambda: A.grouped_cross_attention_plain(
        q, ek, ev, bias, **kw), iters=3)
    log(f"  K2 G={items} r={beam}: {ms:.4f} ms (device alone)")
    qh = q.reshape(items, beam, n_heads, -1).transpose(1, 2)
    kh, vh = (heads(x, items, T_ENC, n_heads) for x in (ek, ev))
    m4 = bias.reshape(items, 1, 1, T_ENC)
    nbytes = (2 * live * T_ENC * d + 2 * live * beam * d) * 2 + (
        live * T_ENC * 4)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms(lambda: sdpa(qh, kh, vh, m4)),
                **bound(nbytes, 4 * live * beam * T_ENC * d, dt))


def k9_inputs(A, dev, gen, items, beam):
    """q, a store padded from T_ENC to T_PAD rows (pad rows random, their
    bias columns 0, so only t_real keeps them out) and its bias, item 0
    fully masked."""
    dt = torch.bfloat16
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)  # noqa
    q, ek, ev = rnd(items * beam, HID), rnd(items, T_PAD, HID), rnd(
        items, T_PAD, HID)
    mask = torch.rand(items, T_PAD, generator=gen, device=dev) < 0.1
    mask[0] = True
    mask[:, T_ENC:] = False
    return q, ek, ev, torch.where(mask[:, None, :], A.MASK_FILL, 0.0).float()


def k2_on_k9_rows(A, q, ek, ev, bias, live_items):
    """K2's device time (queued) over the rows K9 reads: the first T_ENC
    rows of each item, in an unpadded store."""
    ek2, ev2 = (x[:, :T_ENC].contiguous() for x in (ek, ev))
    b2 = bias[..., :T_ENC].contiguous()
    return cuda_ms(lambda: A.grouped_cross_attention(
        q, ek2, ev2, b2, n_heads=HEADS, live_items=live_items), queued=True)


def check_k9(A, dev, gen, *, items, beam, ngs, live_items=None):
    """K9 vs its twin for each ng, timed with the device queued, beside K2
    on the same rows. Returns the measurements at ng = PACK."""
    dt = torch.bfloat16
    q, ek, ev, bias = k9_inputs(A, dev, gen, items, beam)
    live = items if live_items is None else live_items
    err, row = 0.0, None
    for ng in ngs:
        kw = dict(n_heads=HEADS, pack_items=ng, t_real=T_ENC,
                  live_items=live_items)
        got = A.grouped_cross_attention(q, ek, ev, bias, **kw)
        want = A.cross_attention_packed_plain(q, ek, ev, bias, **kw)
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
        if not torch.isfinite(got[:beam].float()).all():
            raise AssertionError("K9: all-masked item is not finite")
        if got[live * beam:].any():
            raise AssertionError("K9: rows past live_items are not 0")
        e = (got.float() - want.float()).abs().max().item()
        err = max(err, e)
        ms = cuda_ms(lambda: A.grouped_cross_attention(q, ek, ev, bias, **kw),
                     queued=True)
        log(f"  K9 G={items} r={beam} T {T_ENC} of {T_PAD} ng={ng} "
            f"live_items={live_items}: max|out-twin|={e:.3e} (atol=rtol="
            f"{TOL}), {ms:.4f} ms (device alone)")
        if ng == PACK:
            row = dict(ms=ms, plain_ms=cuda_ms(
                lambda: A.cross_attention_packed_plain(q, ek, ev, bias, **kw),
                iters=3))
    row["k2_ms"] = k2_on_k9_rows(A, q, ek, ev, bias, live_items)
    log(f"  K2 on the same rows: {row['k2_ms']:.4f} ms; K9 (ng {PACK}) / K2 "
        f"= {row['ms'] / row['k2_ms']:.3f}")
    qh = q.reshape(items, beam, HEADS, -1).transpose(1, 2)
    kh, vh = (heads(x[:, :T_ENC], items, T_ENC) for x in (ek, ev))
    m4 = bias[..., :T_ENC].reshape(items, 1, 1, T_ENC)
    nbytes = (2 * live * T_ENC * HID + 2 * live * beam * HID) * 2 + (
        live * T_ENC * 4)
    return dict(row, max_abs_err=err,
                library_ms=library_ms(lambda: sdpa(qh, kh, vh, m4)),
                **bound(nbytes, 4 * live * beam * T_ENC * HID, dt))


def check_k10(E, dev, gen, *, items, beam, length, live_items=None):
    """K10 vs its twin at one path's shapes (seq [items, beam, length],
    anc/valid [items, beam, length + 1]): every output equal exactly, and
    items at or past ``live_items`` left as they were."""
    from deephumor_tpu_torch import EOS, PAD

    p = length + 1
    ri = lambda hi, *s: torch.randint(0, hi, s, generator=gen,  # noqa: E731
                                      device=dev)
    new_idx = ri(C_VOCAB, items, beam, beam)
    new_idx[::5, 0, 0] = EOS  # planted EOS picks
    ended = torch.rand(items, beam, generator=gen, device=dev) < 0.2
    ended[::7] = True  # items whose branches have all ended
    args = [new_idx, torch.randn(items, beam, beam, generator=gen, device=dev),
            ri(beam * beam, items, beam), ended,
            torch.randn(items, beam, generator=gen, device=dev),
            ri(C_VOCAB, items, beam, length), ri(beam, items, beam, p),
            torch.rand(items, beam, p, generator=gen, device=dev) < 0.8]
    pos = length // 2
    kw = dict(beam=beam, eos_index=EOS, pad_index=PAD, live_items=live_items)
    got = E.fused_survivor_update(*[a.clone() for a in args], pos, **kw)
    want = E.fused_survivor_update_plain(*args, pos, **kw)
    names = ("chosen", "val", "ended", "seq", "anc", "valid")
    for name, x, y in zip(names, got, want):
        if not torch.equal(x, y):
            raise AssertionError(f"K10: {name} differs from the twin")
    live = items if live_items is None else live_items
    for name, x, a in zip(names[1:], got[1:], (args[4], args[3], *args[5:])):
        if not torch.equal(x[live:], a[live:]):
            raise AssertionError(f"K10: {name} of a dead item changed")
    # a call is shorter than its host overhead: time it queued, on the
    # device alone, and also paced by the host as the engine's loop runs it
    work = [a.clone() for a in args]
    ms, host_ms = (cuda_ms(lambda: E.fused_survivor_update(*work, pos, **kw),
                           queued=q) for q in (True, False))
    plain_ms, plain_host_ms = (cuda_ms(
        lambda: E.fused_survivor_update_plain(*args, pos, **kw), iters=3,
        queued=q) for q in (True, False))
    log(f"  K10 items={items} beam={beam} L={length} P={p} live_items="
        f"{live_items}: all six outputs equal to the twin; device "
        f"{ms:.4f} ms (twin {plain_ms:.4f} ms), host-paced {host_ms:.4f} ms "
        f"(twin {plain_host_ms:.4f} ms)")
    # live rows read new_idx, new_val (beam each), surv, ended, val, seq,
    # anc, valid and write all but the candidates and picks; chosen is
    # written for every row; no arithmetic to speak of
    rows = live * beam
    nbytes = rows * (beam * 12 + 8 + 1 + 4 + 2 * (length * 8 + p * 9)
                     + 1 + 4) + items * beam * 8
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                **bound(nbytes, 0, torch.float32))


def check_draws(ids, ids_p, logits, top_k, label):
    """ids in the exact keep-ties top-k support of ``logits``, no UNK, no
    repeats, equal to the twin's on >= 0.999 of rows."""
    x = logits.float()
    kth = x.topk(top_k, dim=1).values[:, -1:]
    in_support = (x.gather(1, ids) >= kth).all().item()
    no_unk = not (ids == 1).any().item()
    srt = ids.sort(dim=1).values
    distinct = (srt[:, 1:] != srt[:, :-1]).all().item()
    same = (ids == ids_p).all(dim=1).float().mean().item()
    log(f"  {label}: in exact top-{top_k} support={in_support}, no "
        f"UNK={no_unk}, no repeats={distinct}, rows equal to "
        f"twin={same:.6f} (>= 0.999)")
    if not (in_support and no_unk and distinct and same >= 0.999):
        raise AssertionError(f"{label} disagrees with its twin or the "
                             f"support")


def check_k3(S, dev, gen, *, rows, vocab, top_k, draws, inv_t, label,
             dt=torch.bfloat16, timed=True):
    """K3 vs its twin. Timed first on random logits (with ``timed``); then
    checked on them with rows planted that the kernel treats apart: UNK as
    the row's maximum, rows of one value and, at a vocabulary of 2048 or
    more, 2048 logits tied at the top (the candidate list overflows to the
    whole-row search), ties across the threshold; also at top_k ==
    num_draws, and with live_rows 0, 1 and half the rows."""
    logits = torch.randn(rows, vocab, generator=gen, device=dev).to(dt)
    kw = dict(top_k=top_k, num_draws=draws)
    row = None
    if timed:
        ms = cuda_ms(lambda: S.fused_topk_gumbel_sample(logits, 7, inv_t,
                                                        **kw), queued=True)
        plain_ms = cuda_ms(lambda: S.fused_topk_gumbel_sample_plain(
            logits, 7, inv_t, **kw), iters=2, warmup=1)
        topk_ms = cuda_ms(lambda: torch.topk(logits, top_k, dim=1),
                          queued=True)
        # reads the logits once, writes the ids; its integer compares have
        # no peak rate in the table, so the bytes bound it
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                   topk_ms=topk_ms, **bound(
                       rows * vocab * logits.element_size()
                       + rows * draws * 4, 0, torch.bfloat16))
        log(f"  {label} [{rows}, {vocab}] {str(dt)[6:]}: {ms:.4f} ms (device "
            f"alone), twin {plain_ms:.4f} ms, torch.topk(k={top_k}) alone "
            f"{topk_ms:.4f} ms (a partial yardstick), bound "
            f"{row['bound_ms']:.4f} ms")
    logits[:8, 1] = logits[:8].float().max() + 1.0  # UNK on top
    logits[8:16] = 0.5  # one value: every column kept
    if vocab >= 2048:
        logits[16:24, :2048] = 7.0  # 2048 tied at the top
    # 40 logits tied with the row's k-th largest: ties across the threshold
    c0 = min(100, vocab - 40)
    logits[24:32, c0:c0 + 40] = logits[24:32].float().topk(
        top_k, dim=1).values[:, -1:].to(dt)
    ids, vals = S.fused_topk_gumbel_sample(logits, 12345, inv_t, **kw)
    ids_p, vals_p = S.fused_topk_gumbel_sample_plain(logits, 12345, inv_t,
                                                     **kw)
    check_draws(ids, ids_p, logits, top_k, label)
    err = (vals - vals_p).abs().max().item()
    # top_k == num_draws: a row with UNK inside its top k exhausts its
    # support and draws column 0, so those rows are held to the twin alone
    ids_k, _ = S.fused_topk_gumbel_sample(logits, 5, inv_t, top_k=draws,
                                          num_draws=draws)
    ids_kp, _ = S.fused_topk_gumbel_sample_plain(logits, 5, inv_t,
                                                 top_k=draws, num_draws=draws)
    x = logits.float()
    clean = x[:, 1] < x.topk(draws, dim=1).values[:, -1]
    check_draws(ids_k[clean], ids_kp[clean], logits[clean], draws,
                f"{label} top_k=num_draws={draws}")
    if not torch.equal(ids_k[~clean], ids_kp[~clean]):
        raise AssertionError(f"{label}: top_k == num_draws, rows with UNK "
                             f"in the top k differ from the twin")
    # live rows draw what they drew, the others id 0, value 0
    for live in (0, 1, rows // 2):
        ids_h, vals_h = S.fused_topk_gumbel_sample(logits, 12345, inv_t,
                                                   live_rows=live, **kw)
        ids_hp, _ = S.fused_topk_gumbel_sample_plain(
            logits, 12345, inv_t, live_rows=live, **kw)
        if ids_h[live:].any() or vals_h[live:].any() or ids_hp[live:].any():
            raise AssertionError(f"{label}: rows past live_rows are not 0")
        if not (torch.equal(ids_h[:live], ids[:live])
                and torch.equal(vals_h[:live], vals[:live])
                and torch.equal(ids_hp[:live], ids_p[:live])):
            raise AssertionError(f"{label}: live rows differ from the full "
                                 f"call")
    log(f"  {label} live_rows 0, 1, {rows // 2}: live rows equal to the "
        f"full call's, the rest 0")
    return None if row is None else dict(row, max_abs_err=err)


def k4_inputs(dev, gen, d=HID, rows=C_ROWS, vocab=C_VOCAB):
    """x [rows, d], W [vocab, d] bf16 (by default the char shape: x [5376,
    512], W [128, 512] on one card) and an f32 bias with UNK on top of
    every row (it must never be drawn)."""
    bf = torch.bfloat16
    x = torch.randn(rows, d, generator=gen, device=dev).to(bf)
    w = (torch.randn(vocab, d, generator=gen, device=dev) / 8).to(bf)
    b = torch.randn(vocab, generator=gen, device=dev)
    b[1] = 30.0
    return x, w, b


def k4_bytes(live, d=HID, rows=C_ROWS, vocab=C_VOCAB, draws=C_BEAM):
    """x's live rows, W and b read; every row's ids (int64) and values
    (f32) written."""
    return live * d * 2 + vocab * d * 2 + vocab * 4 + rows * draws * 12


def check_k4_draws(S, x, w, b, inv_t, lives, label, **kw):
    """K4 vs its twin on ``x, w, b`` with each of ``lives`` live rows
    (None: all): rows past it 0, the live rows' ids in the exact support
    and equal to the twin's (``check_draws``). Returns the largest
    |vals - twin's| over the rows whose ids agree."""
    err = 0.0
    for live in lives:
        ids, vals = S.fused_classifier_topk_gumbel_sample(
            x, w, b, 4321, inv_t, live_rows=live, **kw)
        ids_p, vals_p = S.fused_classifier_topk_gumbel_sample_plain(
            x, w, b, 4321, inv_t, live_rows=live, **kw)
        n = x.shape[0] if live is None else live
        if live is not None and (ids[n:].any() or vals[n:].any()):
            raise AssertionError(f"{label}: rows past live_rows are not 0")
        logits = S.classifier_logits(x[:n], w, b)
        check_draws(ids[:n], ids_p[:n], logits, kw["top_k"],
                    f"{label} live_rows={live}")
        eq = (ids == ids_p).all(dim=1)
        err = max(err, (vals[eq] - vals_p[eq]).abs().max().item())
    return err


def check_k4(S, dev, gen, d=HID):
    """K4 at the char shapes (x and W ``d`` wide), all rows live and
    C_LIVE live (and 3000), timed with the device queued beside the
    unfused route (bf16 F.linear, then K3) and F.linear alone (partial
    yardsticks)."""
    bf = torch.bfloat16
    x, w, b = k4_inputs(dev, gen, d)
    kw = dict(top_k=C_TOP_K, num_draws=C_BEAM)
    err = check_k4_draws(S, x, w, b, 1 / C_TEMP, (None, 3000, C_LIVE), "K4",
                         **kw)
    row = {}
    for key, live in (("", None), ("_live", C_LIVE)):
        row["ms" + key] = cuda_ms(
            lambda: S.fused_classifier_topk_gumbel_sample(
                x, w, b, 7, 1 / C_TEMP, live_rows=live, **kw), queued=True)
        row["linear_k3_ms" + key] = cuda_ms(
            lambda: S.fused_topk_gumbel_sample(
                torch.nn.functional.linear(x, w, b.to(bf)), 7, 1 / C_TEMP,
                live_rows=live, **kw), queued=True)
        row["bound_ms" + key] = bound(
            k4_bytes(live or C_ROWS, d), 2 * (live or C_ROWS) * C_VOCAB * d,
            bf)["bound_ms"]
    row["linear_ms"] = cuda_ms(
        lambda: torch.nn.functional.linear(x, w, b.to(bf)), queued=True)
    plain_ms = cuda_ms(lambda: S.fused_classifier_topk_gumbel_sample_plain(
        x, w, b, 7, 1 / C_TEMP, **kw), iters=2, warmup=1)
    log(f"  K4 [{C_ROWS}, {d}] x [{C_VOCAB}, {d}]: {row['ms']:.4f} ms "
        f"(device alone; {C_LIVE} live rows {row['ms_live']:.4f} ms), twin "
        f"{plain_ms:.4f} ms; F.linear + K3 {row['linear_k3_ms']:.4f} ms "
        f"({C_LIVE} live {row['linear_k3_ms_live']:.4f} ms), F.linear alone "
        f"{row['linear_ms']:.4f} ms (partial yardsticks); bound "
        f"{row['bound_ms']:.4f} / {row['bound_ms_live']:.4f} ms")
    return dict(row, max_abs_err=err, plain_ms=plain_ms, library_ms=None,
                bound_by=bound(k4_bytes(C_ROWS, d),
                               2 * C_ROWS * C_VOCAB * d, bf)["bound_by"])


def check_k5_k6(A, dev, gen, d=HID, n_heads=HEADS):
    """K5 (pe 120: c 104, w 16; pe 128: c 120, w 8) and K6 (pe 128) at the
    char shapes (``d`` wide over ``n_heads`` heads), and K5 + K6 merged ==
    K1's full-width twin. K6 writing into K5's output (``out=``, the
    decode step's seam) equals the row-mask merge bit for bit, with an int
    count and with a count in device memory. K5 and K6 on the fused QKV
    product's row-strided views are bit-equal to contiguous copies. K5 is
    timed at both canon shapes (the row reports pe 120), K6 at 96 items,
    both on the device alone (queued), each also on the views."""
    from deephumor_tpu_torch.ops.testing import canon_state

    dt, items, beam = torch.bfloat16, C_BATCH, C_BEAM
    n = 96  # stragglers: the first n items, then the rest in order
    strag_ids = torch.arange(items, device=dev, dtype=torch.int32)
    err5 = err6 = 0.0
    ms5 = {}
    for c, pe, live in ((104, 120, None), (120, 128, None), (104, 120, 500)):
        s = canon_state(items=items, beam=beam, p=C_P, c=c, pe=pe, d=d,
                        dtype=dt, generator=gen, stragglers=range(n))
        kw = dict(beam=beam, n_heads=n_heads, c=c, p_eff=pe, live_items=live)
        caches = [(s["ck"].clone(), s["cv"].clone()) for _ in range(2)]
        args = (s["sk"], s["sv"], s["kn"], s["vn"], s["bias_sh"],
                s["bias_win"], s["pos"])
        got = A.ancestry_attention_update_canon(s["q"], *caches[0], *args,
                                                **kw)
        want = A.ancestry_attention_update_canon_plain(s["q"], *caches[1],
                                                       *args, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(caches[0][0], caches[1][0])
                and torch.equal(caches[0][1], caches[1][1])):
            raise AssertionError(f"K5 c={c} p_eff={pe}: caches differ")
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
        e = (got.float() - want.float()).abs().max().item()
        err5 = max(err5, e)
        log(f"  K5 c={c} p_eff={pe} live_items={live}: caches bit-equal, "
            f"max|out-twin|={e:.3e} (atol=rtol={TOL})")
        if live is not None:
            continue

        def run5(q, kn, vn, fresh, s=s, kw=kw):
            ck, cv = ((s["ck"].clone(), s["cv"].clone()) if fresh
                      else (s["ck"], s["cv"]))
            return (A.ancestry_attention_update_canon(
                q, ck, cv, s["sk"], s["sv"], kn, vn, s["bias_sh"],
                s["bias_win"], s["pos"], **kw), ck, cv)

        strided5 = check_strided(f"K5 c={c} p_eff={pe}", run5, fused_views(
            s["q"], s["kn"], s["vn"]), timed=pe == 120)
        # K6 on the written caches: the 96 stragglers, then the merge
        k6kw = dict(beam=beam, n_heads=n_heads, p_eff=pe)
        ck, cv = caches[0]
        out_s = A.ancestry_attention_ids(s["q"], ck, cv, s["bias"],
                                         strag_ids, n, **k6kw)
        want_s = A.ancestry_attention_ids_plain(
            s["q"], ck, cv, s["bias"], strag_ids, n, **k6kw)
        sr = slice(0, n * beam)
        torch.testing.assert_close(out_s[sr], want_s[sr], atol=TOL, rtol=TOL)
        e = (out_s[sr].float() - want_s[sr].float()).abs().max().item()
        err6 = max(err6, e)
        rows_mask = torch.zeros(items * beam, dtype=torch.bool, device=dev)
        rows_mask[sr] = True
        merged = torch.where(rows_mask[:, None], out_s, got)
        full = A.ancestry_attention_update_plain(
            s["q"], ck.clone(), cv.clone(), s["kn"], s["vn"], s["bias"],
            s["pos"], beam=beam, n_heads=n_heads, p_eff=pe)
        torch.testing.assert_close(merged, full, atol=TOL, rtol=TOL)
        em = (merged.float() - full.float()).abs().max().item()
        # the decode step's seam: K6 writes the stragglers' rows into K5's
        # output, with the count as an int and in device memory
        for count in (n, torch.tensor(n, dtype=torch.int32, device=dev)):
            seam = got.clone()
            A.ancestry_attention_ids(s["q"], ck, cv, s["bias"], strag_ids,
                                     count, out=seam, **k6kw)
            if not torch.equal(seam, merged):
                raise AssertionError(f"K6 p_eff={pe} out= ({type(count)}): "
                                     f"not the row-mask merge bit for bit")
        log(f"  K6 p_eff={pe} {n} stragglers: max|out-twin|="
            f"{e:.3e}; K5+K6 merged vs K1 twin full width: max|diff|="
            f"{em:.3e} (atol=rtol={TOL}); K6 into K5's output (int and "
            f"device count) bit-equal to the merge")

        seam_buf = got.clone()

        def run6(q, kn, vn, fresh, ck=ck, cv=cv, got=got, s=s,
                 seam_buf=seam_buf):
            seam = got.clone() if fresh else seam_buf
            A.ancestry_attention_ids(q, ck, cv, s["bias"], strag_ids, n,
                                     out=seam, **k6kw)
            return (seam,)

        strided6 = check_strided(f"K6 p_eff={pe} {n} stragglers", run6,
                                 fused_views(s["q"], s["kn"], s["vn"]),
                                 timed=pe == 128)
        ms5[pe] = cuda_ms(lambda: A.ancestry_attention_update_canon(
            s["q"], ck, cv, *args, **kw), queued=True)
        log(f"  K5 c={c} p_eff={pe} (joined support {c + beam * (pe - c)} "
            f"rows): {ms5[pe]:.4f} ms")
        if pe == 120:
            k5_state = (s, caches[0], args, kw)
            ms5_strided = strided5
        else:
            ms6_strided = strided6
    s, (ck, cv), args, kw = k5_state
    plain5 = cuda_ms(lambda: A.ancestry_attention_update_canon_plain(
        s["q"], ck, cv, *args, **kw), iters=3)
    c, pe, w = kw["c"], kw["p_eff"], kw["p_eff"] - kw["c"]
    qh = s["q"].reshape(items, beam, n_heads, -1).transpose(1, 2)
    kh, vh = (torch.cat([heads(sh, items, c, n_heads), heads(
        x[:, c:pe].reshape(items, beam * w, d), items, beam * w, n_heads)],
        dim=2)
        for sh, x in ((s["sk"], ck), (s["sv"], cv)))
    mask = torch.cat([s["bias_sh"].expand(items, beam, c), s["bias_win"]],
                     dim=-1)[:, None].contiguous()
    rows = items * beam
    # K+V: shared rows, the window's w - 1 cached positions, k_new / v_new
    # read and written at pos (inside the window); q and the output; biases
    nbytes5 = (2 * items * c * d + 2 * rows * (w - 1) * d
               + 4 * rows * d + 2 * rows * d) * 2 \
        + items * c * 4 + items * beam * beam * w * 4
    k5 = dict(max_abs_err=err5, ms=ms5[120], ms_pe128=ms5[128],
              ms_strided=ms5_strided[0], ms_contiguous=ms5_strided[1],
              plain_ms=plain5,
              library_ms=library_ms(lambda: sdpa(qh, kh, vh, mask)),
              **bound(nbytes5, 4 * rows * (c + beam * w) * d, dt))
    # K6 at pe 128 on the last state that ran it
    k6kw = dict(beam=beam, n_heads=n_heads, p_eff=128)
    s6 = canon_state(items=items, beam=beam, p=C_P, c=120, pe=128, d=d,
                     dtype=dt, generator=gen, stragglers=range(n))
    ms6 = cuda_ms(lambda: A.ancestry_attention_ids(
        s6["q"], s6["ck"], s6["cv"], s6["bias"], strag_ids, n, **k6kw),
        queued=True)
    n_ptr = torch.tensor(n, dtype=torch.int32, device=dev)
    ms6_ptr = cuda_ms(lambda: A.ancestry_attention_ids(
        s6["q"], s6["ck"], s6["cv"], s6["bias"], strag_ids, n_ptr, **k6kw),
        queued=True)
    log(f"  K6 p_eff=128 {n} stragglers: {ms6:.4f} ms (int count), "
        f"{ms6_ptr:.4f} ms (device count)")
    plain6 = cuda_ms(lambda: A.ancestry_attention_ids_plain(
        s6["q"], s6["ck"], s6["cv"], s6["bias"], strag_ids, n, **k6kw),
        iters=3)
    sel = slice(0, n * beam)
    qh = s6["q"][sel].reshape(n, beam, n_heads, -1).transpose(1, 2)
    kh, vh = (heads(x[sel, :128].reshape(n, beam * 128, d), n, beam * 128,
                    n_heads)
              for x in (s6["ck"], s6["cv"]))
    mask = s6["bias"][:n].reshape(n, beam, beam, C_P)[..., :128].reshape(
        n, 1, beam, beam * 128).contiguous()
    nbytes6 = (2 * n * beam * 128 * d + 2 * n * beam * d) * 2 + (
        n * beam * beam * 128 * 4 + n * 4)
    k6 = dict(max_abs_err=err6, ms=ms6, ms_count_ptr=ms6_ptr,
              ms_strided=ms6_strided[0], ms_contiguous=ms6_strided[1],
              plain_ms=plain6,
              library_ms=library_ms(lambda: sdpa(qh, kh, vh, mask)),
              **bound(nbytes6, 4 * n * beam * beam * 128 * d, dt))
    return k5, k6


def check_k6_leg(A, dev, gen, boundaries, k6):
    """K6 at the straggler counts the char leg showed (and at none), as
    the decode step calls it: q a row-strided view of the fused QKV
    product, the stragglers' rows written into K5's output (``out=``),
    the count an int and a 0-d int32 in device memory (a captured step's).
    At each canon boundary with stragglers, over that many items at the
    p_eff of the phase after it (the boundary's + 8, at most 128): the two
    count forms bit-equal on every row, the written rows within TOL of
    the twin, every other row unchanged, and both forms timed on the
    device alone (queued: a launch is shorter than its wrapper's host
    time). Adds [p_eff, stragglers, int ms, device-count ms, bound ms]
    rows to ``k6`` (the bound: the listed items' K and V over p_eff
    positions, q, the written rows, their bias and ids read once)."""
    from deephumor_tpu_torch.ops.testing import canon_state

    counts = [(min(pe + 8, 128), n) for pe, _, n in boundaries if n]
    if not counts:
        raise AssertionError("char leg: no canon boundary had stragglers")
    counts.append((128, 0))
    dt, items, beam = torch.bfloat16, C_BATCH, C_BEAM
    s = canon_state(items=items, beam=beam, p=C_P, c=120, pe=128, d=HID,
                    dtype=dt, generator=gen,
                    stragglers=range(max(n for _, n in counts)))
    ids = torch.arange(items, device=dev, dtype=torch.int32)
    q = fused_views(s["q"], s["kn"], s["vn"])[0]
    args = (q, s["ck"], s["cv"], s["bias"], ids)
    base = torch.randn(items * beam, HID, generator=gen, device=dev).to(dt)
    kw = dict(beam=beam, n_heads=HEADS)
    k6["ms_leg"] = []
    for pe, n in counts:
        forms = (n, torch.tensor(n, dtype=torch.int32, device=dev))
        outs = [base.clone() for _ in forms]
        for count, out in zip(forms, outs):
            A.ancestry_attention_ids(*args, count, p_eff=pe, out=out, **kw)
        want = A.ancestry_attention_ids_plain(*args, n, p_eff=pe, **kw)
        sel = slice(0, n * beam)
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"K6 p_eff={pe} {n} stragglers: a device "
                                 f"count gives other rows than the int")
        if not torch.equal(outs[0][n * beam:], base[n * beam:]):
            raise AssertionError(f"K6 p_eff={pe} {n} stragglers: rows past "
                                 f"the stragglers' were written")
        torch.testing.assert_close(outs[0][sel], want[sel], atol=TOL,
                                   rtol=TOL)
        if n:
            e = (outs[0][sel].float() - want[sel].float()).abs().max().item()
            k6["max_abs_err"] = max(k6["max_abs_err"], e)
        nbytes = (2 * n * beam * pe * HID + 2 * n * beam * HID) * 2 \
            + n * beam * beam * pe * 4 + n * 4
        k6["ms_leg"].append([pe, n] + [
            cuda_ms(lambda c=count, o=out: A.ancestry_attention_ids(
                *args, c, p_eff=pe, out=o, **kw), queued=True)
            for count, out in zip(forms, outs)] + [bound(
                nbytes, 4 * n * beam * beam * pe * HID, dt)["bound_ms"]])
    log(f"  K6 at the char leg's straggler counts and at none, as the "
        f"decode step calls it (strided q, out=): int and device count "
        f"bit-equal, within atol=rtol={TOL} of its twin; (p_eff, "
        f"stragglers, int ms, device-count ms, ratio, bound ms) "
        f"{[(pe, n, round(a, 4), round(b, 4), round(b / a, 3), round(f, 5)) for pe, n, a, b, f in k6['ms_leg']]}"
        f"; 96 items at p_eff 128: {k6['ms']:.4f} ms (int), "
        f"{k6['ms_count_ptr']:.4f} ms (device count)")


def make_model(CaptioningTransformer, dtype, dev, char):
    vocab, max_len, eos = ((C_VOCAB, C_LEN, C_EOS_BIAS) if char
                           else (VOCAB, MAX_LEN, EOS_BIAS))
    model = CaptioningTransformer(
        num_tokens=vocab, hid_dim=HID, n_layers=LAYERS, n_heads=HEADS,
        pf_dim=PF, max_len=max_len + 2, compute_dtype=dtype)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    params["decoder"]["classifier"]["bias"][3] = eos
    return model, params


def features(n, dev, seed):
    g = torch.Generator(dev).manual_seed(seed)
    return (torch.randn(n, HID, generator=g, device=dev),
            torch.randn(n, T_ENC, HID, generator=g, device=dev))


def marks(out):
    """(p_eff, live items after compaction, stragglers) per boundary."""
    return [(b["p_eff"], b["live"], b["stragglers"])
            for b in out["boundaries"]]


def retiring_greedy(model, params, enc, kw):
    """Greedy char generation on the kernel path at the first EOS bias of
    C_GREEDY_EOS_BIASES under which at least a quarter of the items have
    ended by the last compaction while a canon boundary still has
    stragglers, so that the check crosses the dead-item path (zero rows,
    ``live_rows``, the cross K/V and encoder mask moved with the items,
    the final un-permutation) as well as canon. Leaves that bias in
    ``params``."""
    n = enc[0].shape[0]
    for eos in C_GREEDY_EOS_BIASES:
        params["decoder"]["classifier"]["bias"][3] = eos
        out = model.generate_from_emb(params, enc, greedy=True, **kw)
        live = [b["live"] for b in out["boundaries"] if b["live"] is not None]
        log(f"  EOS bias {eos}: boundaries {marks(out)}")
        if (live and min(live) <= 3 * n // 4
                and any(b["stragglers"] for b in out["boundaries"])):
            return out
    raise AssertionError("greedy char: no EOS bias retired a quarter of the "
                         "items with stragglers left at a canon boundary")


def check_greedy(CaptioningTransformer, tree_map, _build, dev, char):
    """Greedy f32 generation through the kernels, without and with both
    switches (K9 and K10 then launch), vs the plain path on the CPU
    without switches at the serving widths (char: 32 items at several
    feature scales, compaction and canon on by the defaults, many items
    retired early, and the same boundaries on all three; then once more
    on the card with canon off)."""
    model, params = make_model(CaptioningTransformer, "float32", dev, char)
    n = 32 if char else 64
    enc = features(n, dev, 1)
    kw = (dict(max_len=C_LEN, beam_size=C_BEAM, top_k=C_TOP_K) if char
          else dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K))
    if char:
        # items at several feature scales end at different steps
        scale = torch.linspace(0.3, 2.0, n, device=dev)[:, None]
        enc = (enc[0] * scale, enc[1] * scale[:, :, None])
        got = retiring_greedy(model, params, enc, kw)
    else:
        got = model.generate_from_emb(params, enc, greedy=True, **kw)
    cpu = lambda t: t.cpu()  # noqa: E731
    want = model.generate_from_emb(tree_map(cpu, params),
                                   tuple(map(cpu, enc)), greedy=True, **kw)
    _build.reset_launch_counts()
    with switches(pack=PACK, fused=True):
        got_sw = model.generate_from_emb(params, enc, greedy=True, **kw)
    k9, k10 = (_build.LAUNCHES[k] for k in ("cross_attention_packed",
                                             "fused_survivor_update"))
    if not (k9 and k10):
        raise AssertionError(f"greedy with both switches: K9 {k9}, K10 {k10} "
                             f"launches")
    for label, g in (("kernel path", got),
                     (f"kernel path, both switches (K9 {k9}, K10 {k10} "
                      f"launches)", got_sw)):
        same = (g["chosen"].cpu() == want["chosen"]).all(dim=1).float().mean()
        log(f"  greedy f32, {n} items: {label} == CPU plain path on "
            f"{same.item():.4f} of items (>= 0.99); boundaries (kernels) "
            f"{marks(g)}; (CPU) {marks(want)}")
        if same < 0.99:
            raise AssertionError(f"greedy {label} disagrees with plain path")
        if char and g["boundaries"] != want["boundaries"]:
            raise AssertionError(f"greedy char, {label}: boundaries differ "
                                 f"from the CPU path's")
    if not char:
        return
    # canon off: K1 reads every per-slot row, through p_eff 128. Canon
    # changes no greedy token (K5 + K6 attend over the same rows as K1), so
    # the CPU plain path's tokens above are the reference, and the
    # compaction boundaries must be its
    _build.reset_launch_counts()
    got = model.generate_from_emb(params, enc, greedy=True, canon=False, **kw)
    k1, k5 = (_build.LAUNCHES[k] for k in ("ancestry_attention_update",
                                            "ancestry_attention_update_canon"))
    same = (got["chosen"].cpu() == want["chosen"]).all(dim=1).float().mean()
    compactions = [[(pe, live) for pe, live, _ in marks(o) if live is not None]
                   for o in (got, want)]
    log(f"  greedy f32, {n} items, canon off (K1 {k1}, K5 {k5} launches): "
        f"kernel path == CPU plain path on {same.item():.4f} of items (>= "
        f"0.99); compactions (p_eff, live) {compactions[0]}; (CPU) "
        f"{compactions[1]}")
    if k5 or not k1 or same < 0.99 or compactions[0] != compactions[1]:
        raise AssertionError("greedy char, canon off: disagrees with the "
                             "plain path or ran canon")


def make_lstm(cls, dtype, dev):
    model = cls(num_tokens=VOCAB, emb_dim=L_EMB, hidden_size=L_HID,
                num_layers=L_LAYERS, compute_dtype=dtype)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    params["decoder"]["classifier"]["bias"][3] = EOS_BIAS
    return model, params


def greedy_parity(model, params, enc, tree_map, label):
    """Greedy f32 generation at the word settings on the card vs the plain
    path on the CPU: token-equal on >= 99% of items."""
    kw = dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K)
    got = model.generate_from_emb(params, enc, greedy=True, **kw)
    cpu = lambda t: t.cpu()  # noqa: E731
    want = model.generate_from_emb(tree_map(cpu, params), tree_map(cpu, enc),
                                   greedy=True, **kw)
    same = (got["chosen"].cpu() == want["chosen"]).all(dim=1).float().mean()
    log(f"  greedy f32, {batch(enc).shape[0]} items: {label} on the card == "
        f"CPU plain path on {same.item():.4f} of items (>= 0.99)")
    if same < 0.99:
        raise AssertionError(f"greedy {label} disagrees with plain path")


def check_output(out, n, vocab, beam, max_len):
    seq = out["sequences"]
    if out["chosen"].shape != (n, max_len) or seq.shape != (n, beam,
                                                           max_len):
        raise AssertionError(f"unexpected output shape {tuple(seq.shape)}")
    if not (((seq >= 0) & (seq < vocab)).all() and not (seq == 1).any()
            and torch.isfinite(out["scores"]).all()):
        raise AssertionError("tokens out of range, UNK drawn or bad scores")


def batch(enc):
    """The global embeddings of ``encode`` output: the whole of it, or the
    first of the cross-attention model's pair."""
    return enc[0] if isinstance(enc, tuple) else enc


def timed_call(model, params, enc, kw, seed):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate_from_emb(
        params, enc, generator=torch.Generator(
            batch(enc).device).manual_seed(seed), **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def drive(model, params, enc, _build, kw, name_limit, label, path_kernels,
          pack=0, fused=False):
    """One warm-up call, then one call with every launch count at zero;
    fails unless each kernel of ``path_kernels`` launched (and no other).
    Two more calls (not counted) show the run-to-run spread. ``pack`` and
    ``fused`` set the two switches for this leg's calls."""
    with switches(pack, fused):
        model.generate_from_emb(params, enc, **kw)
        _build.reset_launch_counts()
        out, secs = timed_call(model, params, enc, kw, 5)
        launches = dict(_build.LAUNCHES)
        n = batch(enc).shape[0]
        steps = int((out["sequences"] != 0).any(dim=(0, 1)).sum())
        log(f"  {label} generate_from_emb: {n / secs:.1f} captions/s "
            f"({secs:.3f} s, {steps} positions, {name_limit}); launches "
            f"{launches}")
        again = [n / timed_call(model, params, enc, kw, s)[1]
                 for s in (6, 7)]
    log(f"  {label} two more calls (seeds 6, 7): "
        f"{', '.join(f'{r:.1f}' for r in again)} captions/s")
    missing = [k for k in path_kernels if launches[k] < 1]
    extra = [k for k, v in launches.items() if v and k not in path_kernels]
    if missing or extra:
        raise AssertionError(f"{label}: kernels not launched {missing}, "
                             f"launched off the path {extra}")
    return out, launches


def profile_call(model, params, enc, kw, name_limit, label, top, pack=0,
                 fused=False):
    """torch.profiler over one call with the switches as given: kernel
    time by name (the ``top`` largest), the device's idle share, and the
    call's copy, ``where`` and ``cat`` kernels (decode_step makes no
    per-layer-step q/k/v copy, QKV weight concatenation or K6 merge)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with switches(pack, fused), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.generate_from_emb(params, enc, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    busy = sum(e.device_time_total for e in events) / 1e3
    events.sort(key=lambda e: -e.device_time_total)
    lines = [f"{label} profile ({name_limit}): wall {wall * 1e3:.1f} ms "
             f"(profiled), device kernel time {busy:.1f} ms, idle share "
             f"{1 - busy / (wall * 1e3):.3f}"]
    for e in events[:top]:
        lines.append(f"  {e.device_time_total / 1e3:10.3f} ms "
                     f"{e.count:6d} calls  {e.key[:90]}")

    def tally(match):
        hits = [e for e in events if match(e.key)]
        return [sum(e.count for e in hits),
                sum(e.device_time_total for e in hits) / 1e3]

    found = {"copy": tally(lambda k: "copy" in k.lower()
                           and "CatArray" not in k),
             "where": tally(lambda k: "where" in k.lower()),
             "cat": tally(lambda k: "CatArray" in k)}
    lines.append("  a call's " + ", ".join(
        f"{kind} kernels {n} ({ms:.3f} ms)"
        for kind, (n, ms) in found.items()))
    for line in lines:
        log(line)
    return {"kernel_ms": busy, "wall_ms": wall * 1e3,
            "idle_share": 1 - busy / (wall * 1e3),
            **{f"{kind}_kernels": v for kind, v in found.items()}}


def check_leg_launches(label, launches, packed, steps):
    """A switched leg's counts: K10 once per decode step and, when packed,
    K2 only in the prefill's layers and K9 in every decode layer-step
    (else K2 in every layer of the prefill and of each step)."""
    got = tuple(launches[k] for k in ("grouped_cross_attention",
                                      "cross_attention_packed",
                                      "fused_survivor_update"))
    want = ((LAYERS, LAYERS * steps, steps) if packed
            else (LAYERS * (steps + 1), 0, steps))
    log(f"  {label}: {steps} decode steps; K2, K9, K10 launches {got} "
        f"(want {want})")
    if got != want:
        raise AssertionError(f"{label}: K2/K9/K10 launch counts")


def twin_guard(modules):
    """Wraps every plain twin of the kernel modules so that a call with a
    CUDA tensor is recorded (a wrapper takes its twin for CPU tensors
    only); returns the record and a function that puts the twins back."""
    hits, saved = [], []
    for mod in modules:
        for name in dir(mod):
            fn = getattr(mod, name)
            if not (name.endswith("_plain") and callable(fn)):
                continue

            def guard(*args, _fn=fn, _name=name, **kwargs):
                if any(isinstance(x, torch.Tensor) and x.is_cuda
                       for x in (*args, *kwargs.values())):
                    hits.append(_name)
                return _fn(*args, **kwargs)

            saved.append((mod, name, fn))
            setattr(mod, name, guard)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    return hits, restore


def host_ms(fn, iters=10):
    """Mean host time of ``fn`` (ms), the device synchronised around."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def check_caption(text, vocab, where):
    """A served caption: non-empty, every token in the vocabulary, no UNK
    and no PAD."""
    tokens = text.split(" ")
    if not text or any(t not in vocab.stoi for t in tokens) or (
            {"<unk>", "<pad>"} & set(tokens)):
        raise AssertionError(f"{where}: bad caption {text!r}")


def id_round_trip(model, params, pipe, ids, kw, seed):
    """Generates for ``ids`` on the card and decodes each chosen row to
    text; re-encoding the text gives the row's ids up to its first EOS.
    Returns the captions that ended early and those that are empty."""
    from deephumor_tpu_torch.data import EOS_ID, WordPunctTokenizer
    from deephumor_tpu_torch.experiments.inference import (seq_to_text,
                                                           text_to_seq)

    out = model.generate_from_emb(
        params, pipe._stack_features(ids),
        generator=torch.Generator(pipe.device).manual_seed(seed), **kw)
    tok, ended, empty = WordPunctTokenizer(), 0, 0
    for row in out["chosen"].cpu().numpy():
        eos = np.flatnonzero(row == EOS_ID)
        n = int(eos[0]) if eos.size else row.size
        back = text_to_seq(seq_to_text(row, pipe.vocab), pipe.vocab, tok)[0]
        if not np.array_equal(back, row[:n]):
            raise AssertionError(f"decoding: ids {row[:n]} -> text -> {back}")
        ended += n < row.size
        empty += n == 0
    return ended, empty


def http_phase(pipe, kw):
    """Serves ``pipe`` over HTTP on 127.0.0.1:0 through the port's
    ``serve`` and checks every answer."""
    import concurrent.futures
    import importlib.util
    import urllib.error
    import urllib.request
    from urllib.parse import urlencode

    from deephumor_tpu_torch import serve as serve_mod

    ev = threading.Event()
    server = threading.Thread(target=serve_mod.serve, args=(pipe, kw),
                              kwargs=dict(port=0, max_batch=S_MAX_BATCH,
                                          buckets="auto", ready_event=ev),
                              daemon=True)
    server.start()
    if not ev.wait(timeout=300):
        raise AssertionError("serving: the HTTP server did not come up")
    base = f"http://127.0.0.1:{ev.httpd.server_address[1]}"

    def get(route):
        try:
            with urllib.request.urlopen(base + route, timeout=120) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    ids = list(pipe._row)
    try:
        reqs = [ids[(37 * i) % len(ids)] for i in range(S_HTTP)]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(S_HTTP) as ex:
            answers = list(ex.map(
                lambda t: get("/caption?" + urlencode({"template": t})),
                reqs))
        secs = time.perf_counter() - t0
        for (status, body), t in zip(answers, reqs):
            if status != 200:
                raise AssertionError(f"/caption {t}: {status} {body[:200]}")
            check_caption(body.decode(), pipe.vocab, f"/caption {t}")
        status, body = get("/captions?" + urlencode(
            [("template", ids[1]), ("template", "no-such-template"),
             ("template", ids[2])], doseq=True))
        rows = json.loads(body)
        if status != 200 or [r["template"] for r in rows] != [
                ids[1], "no-such-template", ids[2]] or rows[1].get(
                "error_type") != "KeyError":
            raise AssertionError(f"/captions: {status} {rows}")
        for r in (rows[0], rows[2]):
            check_caption(r.get("caption", ""), pipe.vocab, "/captions")
        status, body = get("/meme?" + urlencode({"template": ids[0]}))
        # no Pillow: the route says so; with it, no template has an image
        want = 404 if importlib.util.find_spec("PIL") else 501
        if status != want:
            raise AssertionError(f"/meme: {status} {body[:200]} (want "
                                 f"{want})")
        status, body = get("/healthz")
        health = json.loads(body)
        if (status != 200 or not health["ok"]
                or health["requests"] < S_HTTP + 2):
            raise AssertionError(f"/healthz: {status} {health}")
        srv = ev.caption_srv
        log(f"  HTTP: {S_HTTP} concurrent /caption answered 200 in "
            f"{secs:.3f} s (batches {srv.batch_sizes}, padded to "
            f"{srv.pad_sizes}); /captions: two captions and {rows[1]}; "
            f"/meme {want}; /healthz {health}")
    finally:
        ev.httpd.shutdown()
        server.join(timeout=60)
    if server.is_alive():
        raise AssertionError("serving: the HTTP server did not stop")


def batcher_phase(pipe, kw, name_limit):
    """S_REQUESTS submits from S_THREADS threads through a
    DynamicBatcher: captions/s from the first submit to the last answer,
    and the latency of each request from its submit to its answer."""
    from deephumor_tpu_torch.serving import DynamicBatcher

    ids = list(pipe._row)
    n = S_REQUESTS
    t_sub, t_done, futs = [0.0] * n, [0.0] * n, [None] * n
    barrier = threading.Barrier(S_THREADS)

    with DynamicBatcher(pipe, max_batch=S_MAX_BATCH, buckets="auto", seed=2,
                        **kw) as srv:
        def client(k):
            barrier.wait()
            for i in range(k, n, S_THREADS):
                t_sub[i] = time.perf_counter()
                f = srv.submit(ids[i % len(ids)])
                f.add_done_callback(
                    lambda _, i=i: t_done.__setitem__(i, time.perf_counter()))
                futs[i] = f

        clients = [threading.Thread(target=client, args=(k,))
                   for k in range(S_THREADS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        texts = [f.result(timeout=300) for f in futs]
    for i, text in enumerate(texts):
        check_caption(text, pipe.vocab, f"batcher request {i}")
    wall = max(t_done) - min(t_sub)
    lat = np.array(t_done) - np.array(t_sub)
    stats = {
        "requests": srv.requests_served, "batches": srv.batches_dispatched,
        "batch_sizes": srv.batch_sizes, "buckets": sorted(set(srv.pad_sizes)),
        "captions_per_s": n / wall,
        "p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "p99_ms": float(np.percentile(lat, 99)) * 1e3, "card": name_limit}
    if stats["requests"] != n:
        raise AssertionError(f"batcher: served {stats['requests']} of {n}")
    log(f"  batcher: {n} requests from {S_THREADS} threads in "
        f"{stats['batches']} batches (sizes {stats['batch_sizes']}, buckets "
        f"{stats['buckets']}): {stats['captions_per_s']:.1f} captions/s, p50 "
        f"{stats['p50_ms']:.1f} ms, p99 {stats['p99_ms']:.1f} ms | "
        f"{name_limit}")
    return stats


def check_serving(CaptioningTransformer, tree_map, _build, modules, dev,
                  name_limit):
    """The serving phase (see the module docstring). Returns the launches
    of its main path and its numbers."""
    from deephumor_tpu_torch.data import Vocab
    from deephumor_tpu_torch.experiments.inference import seq_to_text
    from deephumor_tpu_torch.ops.image_ops import preprocess_batch
    from deephumor_tpu_torch.pipeline import MemeGenerationPipeline
    from deephumor_tpu_torch.serving import DynamicBatcher

    model, params = make_model(CaptioningTransformer, "bfloat16", dev, False)
    bias = params["decoder"]["classifier"]["bias"]
    bias[0], bias[3] = S_PAD_BIAS, S_EOS_BIAS
    vocab = Vocab([f"word{i}" for i in range(VOCAB - 6)])
    if len(vocab) != VOCAB:
        raise AssertionError(f"vocabulary of {len(vocab)} tokens")
    pipe = MemeGenerationPipeline(model, params, vocab)
    u8 = torch.randint(0, 256, (S_TEMPLATES, *S_HW, 3), dtype=torch.uint8,
                       device=dev,
                       generator=torch.Generator(dev).manual_seed(8))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = preprocess_batch(u8)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    err = (images.cpu() - preprocess_batch(u8.cpu())).abs().max().item()
    log(f"  preprocess_batch: {S_TEMPLATES} x {S_HW} uint8 -> "
        f"{tuple(images.shape)} f32 on the card in {t_pre * 1e3:.1f} ms; "
        f"max|card-CPU| {err:.3e} (atol {S_PRE_TOL})")
    if not err <= S_PRE_TOL:
        raise AssertionError("preprocess_batch: card and CPU disagree")
    ids = [f"t{i:03d}" for i in range(S_TEMPLATES)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.add_templates(ids, images, batch_size=S_CHUNK)
    pipe._stack_features(ids[:1])
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    k = 7
    got = pipe._stack_features([ids[k]])
    want = model.encode({"encoder": tree_map(lambda t: t.cpu(),
                                             params["encoder"])},
                        images[k:k + 1].cpu())
    errs = []
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=S_ENC_TOL, rtol=S_ENC_TOL)
        errs.append(((g.cpu() - w).abs().max().item(),
                     w.abs().max().item()))
    log(f"  add_templates: {S_TEMPLATES} templates in chunks of {S_CHUNK} "
        f"through ResNet-50 (f32) in {t_enc:.3f} s; template {k}'s (global, "
        f"spatial) encoding vs the CPU encoder: (max|diff|, max|value|) "
        f"{[(f'{e:.2e}', f'{m:.2e}') for e, m in errs]} (atol=rtol "
        f"{S_ENC_TOL})")

    kw = dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K, temperature=1.0,
              sampler="pallas")
    for eos_bias in (EOS_BIAS, S_EOS_BIAS):
        bias[3] = eos_bias
        ended, empty = id_round_trip(model, params, pipe, ids, kw, 9)
        log(f"  ids -> text -> ids equal up to the first EOS on all "
            f"{S_TEMPLATES} captions at EOS bias {eos_bias} ({ended} ended "
            f"early, {empty} empty)")
    # the batcher's largest call, alone and through the pipeline
    rows = ids[:S_MAX_BATCH]
    enc = pipe._stack_features(rows)
    rates = {}
    for label, fn in (
            ("generate_from_emb", lambda g: model.generate_from_emb(
                params, enc, generator=g, **kw)),
            ("pipeline.generate_captions",
             lambda g: pipe.generate_captions(rows, g, **kw))):
        secs = []
        for seed in (10, 11, 12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(torch.Generator(dev).manual_seed(seed))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        rates[label] = [S_MAX_BATCH / s for s in secs]
        log(f"  {label}, {S_MAX_BATCH} items: "
            f"{', '.join(f'{r:.1f}' for r in rates[label])} captions/s")
    # the pipeline's own work around that call: the gather from the
    # store, the chosen ids' copy to the host, the text decoding
    chosen = model.generate_from_emb(
        params, enc, generator=torch.Generator(dev).manual_seed(13),
        **kw)["chosen"]
    rows_np = chosen.cpu().numpy()
    own = {"gather_ms": host_ms(lambda: pipe._stack_features(rows)),
           "to_host_ms": host_ms(lambda: chosen.cpu()),
           "decode_ms": host_ms(lambda: [seq_to_text(r, vocab)
                                         for r in rows_np])}
    log(f"  the pipeline's own work at {S_MAX_BATCH} items (ms): {own}")

    hits, restore = twin_guard(modules)
    _build.reset_launch_counts()
    try:
        http_phase(pipe, kw)
        stats = batcher_phase(pipe, kw, name_limit)
        runs = []
        for _ in range(2):
            with DynamicBatcher(pipe, max_batch=S_MAX_BATCH, buckets="auto",
                                seed=5, **kw) as srv:
                runs.append([srv.submit(t).result(timeout=120)
                             for t in ids[:8]])
    finally:
        restore()
    launches = dict(_build.LAUNCHES)
    if runs[0] != runs[1]:
        raise AssertionError("batchers of one seed fed the same ids one by "
                             "one gave different texts")
    log(f"  two batchers of seed 5, 8 ids one by one: equal texts "
        f"({len(set(runs[0]))} distinct)")
    word = ("ancestry_attention_update", "grouped_cross_attention",
            "fused_topk_gumbel_sample")
    missing = [k for k in word if launches[k] < 1]
    extra = [k for k, v in launches.items() if v and k not in word]
    log(f"  serving launches {launches}; plain twins called with CUDA "
        f"tensors: {sorted(set(hits))}")
    if missing or extra or hits:
        raise AssertionError(f"serving: kernels not launched {missing}, "
                             f"launched off the path {extra}, twins on the "
                             f"card {sorted(set(hits))}")
    stats.update(own, preprocess_ms=t_pre * 1e3, encode_s=t_enc,
                 generate_from_emb_per_s=rates["generate_from_emb"],
                 pipeline_per_s=rates["pipeline.generate_captions"])
    return launches, stats


class MemorySet:
    """A dataset held in memory for ``BatchIterator``'s fast path: its id
    matrices come from ``materialize`` as the lengths ask (one caption
    per template, repeated), its images (if any) from ``images``."""

    preload_images = True

    def __init__(self, captions, keys, images=None):
        self.captions, self.keys = captions, keys
        self.images = images if images is not None else {}

    def __len__(self):
        return len(self.keys)

    def materialize(self, max_caption_len, max_label_len):
        from deephumor_tpu_torch.data.dataloaders import pad_ids

        rows = [self.captions[k] for k in self.keys]
        return {"captions": pad_ids(rows, max_caption_len),
                "labels": pad_ids([[int(k[1:]) % 97 + 6] * 3
                                   for k in self.keys], max_label_len),
                "image_keys": self.keys}


def memory_set(n_items, n_templates, vocab, seed, images=None):
    """``n_items`` captions over ``n_templates`` templates, each template
    with one caption of 8-32 tokens + EOS."""
    from deephumor_tpu_torch.data import EOS_ID

    rng = np.random.default_rng(seed)
    keys = [f"t{i:03d}" for i in range(n_templates)]
    captions = {k: list(rng.integers(6, vocab, rng.integers(8, T_CAP + 1)))
                + [EOS_ID] for k in keys}
    items = [keys[i] for i in rng.integers(0, n_templates, n_items)]
    return MemorySet(captions, items, images), keys


def train_step_cost(bs, seq, t_enc, d, layers, pf, vocab):
    """Operations of one train step of the cross-attention model at the
    padded length ``seq``: forward plus backward (2x) of every product,
    the encoder head's linear without an input gradient; and the bytes
    the step must move at least (the f32 masters, gradients and two
    moments, read and written, and the gathered features)."""
    per_pos = (layers * (8 * d * d + 2 * d * pf + 4 * seq * d)
               + d * vocab)
    head = bs * (t_enc + 1) * 2048 * d
    flops = 2 * (3 * bs * seq * per_pos + 2 * head)
    n_params = (2 * vocab * d + vocab + 50 * d + 2048 * d
                + layers * (8 * d * d + 2 * d * pf))
    nbytes = 4 * n_params * 7 + bs * t_enc * 2048 * 4
    return flops, nbytes


def restore_step(trainer, step):
    """Puts ``trainer._train_step`` back to ``step`` (what it was before a
    wrapper replaced it), without leaving the trainer's own bound method
    on the instance: that reference cycle would keep the trainer, its
    captured graphs and through them its NCCL communicators alive until
    the garbage collector runs, and a process group's destroy waits for
    such graphs."""
    if getattr(step, "__self__", None) is trainer and (
            step.__func__ is type(trainer)._train_step):
        del trainer._train_step
    else:
        trainer._train_step = step


def train_epoch_timed(trainer, state, loader, gen, mesh=None,
                      no_sync=False):
    """``run_epoch`` with a CUDA event at the start of every step (no
    sync in between): the device-side period of each step, the epoch's
    host time, and the peak memory. ``no_sync``: every step after the
    first runs under ``torch.cuda.set_sync_debug_mode("error")``, so a
    step that waits for the device raises (the first step of a captured
    key synchronises on purpose, around its capture)."""
    events = []
    step = trainer._train_step

    def timed(st, batch, g, *group):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        if not (no_sync and len(events) > 1):
            return step(st, batch, g, *group)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return step(st, batch, g, *group)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    trainer._train_step = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        state, loss, pp = trainer.run_epoch(state, loader, gen, mesh=mesh)
    finally:
        restore_step(trainer, step)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events.append(end)
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return state, ms, wall, torch.cuda.max_memory_allocated()


def train_profile(trainer, state, loader, gen, steps, mesh=None):
    """torch.profiler over ``steps`` train steps of ``loader`` (over
    ``mesh`` when given): (state, wall ms, device kernel ms, cuBLAS ms,
    events by device time)."""
    from torch.profiler import ProfilerActivity, profile

    window = itertools.islice(iter(loader), steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _, _ = trainer.run_epoch(state, window, gen, mesh=mesh)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    busy = sum(e.device_time_total for e in events) / 1e3
    # cuBLAS products (nvjet / gemm kernels) against the rest
    gemm = sum(e.device_time_total for e in events
               if "nvjet" in e.key or "gemm" in e.key) / 1e3
    events.sort(key=lambda e: -e.device_time_total)
    return state, wall, busy, gemm, events


def state_gap(a, b):
    """The largest difference between two train states' parameters and
    moments (of a state placed on a mesh: this rank's local tensors)."""
    from deephumor_tpu_torch.parallel.sharding import local_tree
    from deephumor_tpu_torch.utils.pytree import flatten_tree

    def flat(st):
        out = dict(flatten_tree(local_tree(st["params"])))
        for m in ("mu", "nu"):
            out.update({f"{m}/{k}": v for k, v in
                        local_tree(st["opt_state"][m]).items()})
        return out

    fa, fb = flat(a), flat(b)
    return max((fa[k].float() - fb[k].float()).abs().max().item()
               for k in fa)


def check_train(CaptioningTransformer, tree_map, _build, modules, dev,
                name_limit, logdir):
    """The train phase (module docstring, [12]), writing its logs and
    checkpoint under ``logdir``. Returns the launches of the trained
    model's serving calls and the phase's numbers."""
    import dataclasses
    import itertools

    from deephumor_tpu_torch.data.dataloaders import BatchIterator
    from deephumor_tpu_torch.experiments.trainer import Trainer
    from deephumor_tpu_torch.models import (CaptioningLSTM,
                                            CaptioningLSTMWithLabels,
                                            CaptioningTransformerBase)
    from deephumor_tpu_torch.models.encoders import image_encoder_apply
    from deephumor_tpu_torch.utils.pytree import flatten_tree

    out = {}
    model = CaptioningTransformer(num_tokens=VOCAB, hid_dim=HID,
                                  n_layers=LAYERS, n_heads=HEADS, pf_dim=PF,
                                  max_len=50)
    ds, _ = memory_set(T_ITEMS, T_TEMPLATES, VOCAB, 11)
    flops, nbytes = train_step_cost(T_BATCH, max(T_CAP + 1, T_ENC), T_ENC,
                                    HID, LAYERS, PF, VOCAB)
    floor = bound(nbytes, flops, torch.bfloat16)

    def word_run(compiled, title):
        """T_STEPS timed steps of the word model from one seed (the same
        weights, trunk features, batches and dropout draws for every
        run), each step after the first without a device read."""
        loader = BatchIterator(ds, T_BATCH, max_caption_len=T_CAP + 1,
                               seed=0, image_rows={
                                   f"t{i:03d}": i
                                   for i in range(T_TEMPLATES)})
        trainer = Trainer(model, title, log_dir=logdir,
                          compute_dtype="bfloat16", device=dev,
                          compiled=compiled)
        state = trainer.init_state(torch.Generator(dev).manual_seed(0))
        # random unit-scale trunk features, as the JAX package's
        # measurement (a random ResNet's features run ~30x hotter and
        # stall the cross-attention model: its docstring)
        trainer._trunk_cache = torch.randn(
            T_TEMPLATES, 7, 7, 2048, device=dev,
            generator=torch.Generator(dev).manual_seed(12))
        gen = torch.Generator(dev).manual_seed(13)
        steps = itertools.islice(itertools.chain.from_iterable(
            loader for _ in range(T_STEPS // len(loader) + 1)), T_STEPS)
        state0 = {k: v.clone()
                  for k, v in flatten_tree(state["params"]).items()
                  if "resnet" in k or k.startswith("encoder/bn/running")}
        _build.reset_launch_counts()
        state, ms, wall, peak = train_epoch_timed(trainer, state, steps, gen,
                                                  no_sync=True)
        if any(_build.LAUNCHES.values()):
            raise AssertionError(f"train steps launched kernels "
                                 f"{dict(_build.LAUNCHES)}")
        med = float(np.median(ms[T_WARM:]))
        res = {"step_ms_median": med, "step_ms": [round(x, 3) for x in ms],
               "examples_per_s": T_BATCH / med * 1e3, "epoch_wall_s": wall,
               "host_ms_per_step": wall / len(ms) * 1e3,
               "peak_mem_gib": peak / 2**30, "floor_share":
               floor["bound_ms"] / med, "card": name_limit}
        return trainer, state, state0, loader, gen, res

    def profiled(trainer, state, loader, gen, res, label):
        state, pwall, busy, gemm, events = train_profile(
            trainer, state, loader, gen, T_PROFILED)
        res["profile"] = {
            "wall_ms": pwall, "device_ms": busy, "matmul_ms": gemm,
            "idle_share": 1 - busy / pwall,
            "idle_share_unprofiled":
                1 - busy / T_PROFILED / res["step_ms_median"],
            "top": [[e.key[:80], e.device_time_total / 1e3, e.count]
                    for e in events[:20]]}
        log(f"  word train profile, {label}, {T_PROFILED} steps "
            f"({name_limit}): wall {pwall:.1f} ms, device kernel time "
            f"{busy:.1f} ms (matmuls {gemm:.1f} ms), idle share "
            f"{1 - busy / pwall:.3f} under the profiler, "
            f"{res['profile']['idle_share_unprofiled']:.3f} against the "
            f"unprofiled median step")
        for e in events[:12]:
            log(f"  {e.device_time_total / 1e3:10.3f} ms {e.count:6d} calls "
                f" {e.key[:90]}")
        return state

    # eager (compiled=False), then captured (the default), from one seed
    etrainer, estate, _, eloader, egen, eager = word_run(False, "smoke_eager")
    elosses = logged_losses(etrainer)
    trainer, state, flat0, loader, gen, res = word_run(None, "smoke")
    (key,) = [k for k in trainer._graphs.info() if k["kind"] == "train"]
    losses = logged_losses(trainer)
    gap = max([state_gap(state, estate)]
              + [abs(a - b) for a, b in zip(losses, elosses)])
    eager_gap = 0.0
    if gap:
        # not bit-equal: held within the gap between two eager runs
        t2, s2, _, _, _, _ = word_run(False, "smoke_eager2")
        eager_gap = max([state_gap(s2, estate)] + [
            abs(a - b) for a, b in zip(logged_losses(t2), elosses)])
        t2.close()
        del t2, s2
    flat = flatten_tree(state["params"])
    frozen_same = all(torch.equal(flat[k], v) for k, v in flat0.items()
                      if "resnet" in k)
    stats_moved = all(not torch.equal(flat[k], v) for k, v in flat0.items()
                      if k.startswith("encoder/bn/"))
    opt_keys = set(state["opt_state"]["mu"])
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    med = res["step_ms_median"]
    out["word"] = dict(
        res, steps=len(losses), loss_first5=first, loss_last5=last,
        tflop_per_step=flops / 1e12, bound_ms=floor["bound_ms"],
        bound_by=floor["bound_by"], capture_s=key["capture_s"],
        key_bytes=key["bytes"], key_replays=key["replays"],
        gap_to_eager=gap, gap_between_eager_runs=eager_gap, eager=eager)
    log(f"  word train, bf16, batch {T_BATCH}, {len(losses)} steps, "
        f"prefetch 2 ({name_limit}): captured median step {med:.2f} ms "
        f"after {T_WARM} warm-up steps, {T_BATCH / med * 1e3:.1f} "
        f"examples/s, peak memory {res['peak_mem_gib']:.2f} GiB; first "
        f"step (eager, then capture) {key['capture_s']:.2f} s, the key "
        f"holds {key['bytes'] / 2**30:.2f} GiB, {key['replays']} replays; "
        f"eager median step {eager['step_ms_median']:.2f} ms, "
        f"{eager['examples_per_s']:.1f} examples/s, peak memory "
        f"{eager['peak_mem_gib']:.2f} GiB; floor {floor['bound_ms']:.3f} ms "
        f"({flops / 1e12:.3f} TFLOP, by {floor['bound_by']}) = "
        f"{floor['bound_ms'] / med:.3f} of the captured step; loss first 5 "
        f"{first:.4f} -> last 5 {last:.4f}; captured vs eager: losses, "
        f"parameters and moments differ by at most {gap} (two eager runs: "
        f"{eager_gap}); no device read in a step after the first; launches "
        f"0")
    if not (len(losses) == T_STEPS and np.isfinite(losses).all()
            and last < first):
        raise AssertionError(f"word train: losses {losses}")
    if not (frozen_same and stats_moved) or any(
            "resnet" in k or "running" in k for k in opt_keys):
        raise AssertionError("word train: the ResNet moved, the BN "
                             "statistics did not, or either is trained")
    if gap > eager_gap:
        raise AssertionError(f"word train: captured steps differ from eager "
                             f"by {gap}, two eager runs by {eager_gap}")
    if key["replays"] != T_STEPS - 1:
        raise AssertionError(f"word train: {key['replays']} replays of "
                             f"{T_STEPS} steps")
    # one profiled window of T_PROFILED steps each
    profiled(etrainer, estate, eloader, egen, eager, "eager")
    etrainer.close()
    del etrainer, estate
    state = profiled(trainer, state, loader, gen, out["word"], "captured")

    # train, save, serve: the trained checkpoint through K1, K2 and K3
    path = os.path.join(logdir, "trained")
    model.save(state["params"], path)
    served, sparams = CaptioningTransformer.from_pretrained(path, device=dev)
    served = dataclasses.replace(served, compute_dtype="bfloat16")
    with torch.inference_mode():
        enc = image_encoder_apply(
            sparams["encoder"], trainer._trunk_cache[:T_SERVE_BATCH],
            spatial_features=True, from_trunk=True)
    kw = dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K)
    hits, restore = twin_guard(modules)
    _build.reset_launch_counts()
    try:
        outs = [served.generate_from_emb(sparams, enc, greedy=True, **kw),
                served.generate_from_emb(
                    sparams, enc, sampler="pallas",
                    generator=torch.Generator(dev).manual_seed(14), **kw)]
    finally:
        restore()
    launches = dict(_build.LAUNCHES)
    for o in outs:
        check_output(o, T_SERVE_BATCH, VOCAB, BEAM, MAX_LEN)
    word = ("ancestry_attention_update", "grouped_cross_attention",
            "fused_topk_gumbel_sample")
    missing = [k for k in word if launches[k] < 1]
    extra = [k for k, v in launches.items() if v and k not in word]
    log(f"  trained model saved, loaded on the card, served at batch "
        f"{T_SERVE_BATCH} (greedy, sampled): launches {launches}; plain "
        f"twins called with CUDA tensors: {sorted(set(hits))}")
    if missing or extra or hits:
        raise AssertionError(f"train_serve: kernels not launched {missing}, "
                             f"launched off the path {extra}, twins on the "
                             f"card {sorted(set(hits))}")
    del trainer, state, enc, outs, served, sparams

    # from images: the ResNet at 224 x 224, no cache; the trunk takes no
    # gradient
    rng = np.random.default_rng(15)
    images = {f"t{i:03d}": rng.normal(size=(224, 224, 3)).astype(np.float32)
              for i in range(8)}
    ids, _ = memory_set(3 * T_IMG_BATCH, 8, VOCAB, 16, images)
    trainer = Trainer(model, "smoke_images", log_dir=logdir,
                      compute_dtype="bfloat16", device=dev)
    state = trainer.init_state(torch.Generator(dev).manual_seed(0))
    resnet0 = {k: v.clone() for k, v in flatten_tree(state["params"]).items()
               if "resnet" in k}
    state, loss, _ = trainer.run_epoch(state, BatchIterator(
        ids, T_IMG_BATCH, max_caption_len=T_CAP + 1, seed=0),
        torch.Generator(dev).manual_seed(17))
    flat = flatten_tree(state["params"])
    grad_free = all(torch.equal(flat[k], v) and not flat[k].requires_grad
                    for k, v in resnet0.items())
    log(f"  word train from images (224 x 224, batch {T_IMG_BATCH}, 3 "
        f"steps, the ResNet in each): mean loss {loss:.4f}; ResNet "
        f"unchanged and without a gradient: {grad_free}")
    if not (np.isfinite(loss) and grad_free and state["step"] == 3):
        raise AssertionError("train from images")
    out["images"] = {"loss": loss}
    del trainer, state

    # f32 parity: the same weights and batches, 3 steps on the card and on
    # the CPU, dropout 0
    pmodel = CaptioningTransformer(
        num_tokens=VOCAB, hid_dim=HID, n_layers=T_PAR_LAYERS, n_heads=HEADS,
        pf_dim=PF, max_len=50, enc_dropout=0.0, dec_dropout=0.0)
    params = pmodel.init(torch.Generator().manual_seed(18), device="cpu")
    feats = torch.randn(16, 7, 7, 2048,
                        generator=torch.Generator().manual_seed(19))
    pds, _ = memory_set(T_PAR_BATCH * T_PAR_STEPS, 16, VOCAB, 20)
    pbatches = list(BatchIterator(pds, T_PAR_BATCH, max_caption_len=T_CAP + 1,
                                  seed=0, image_rows={
                                      f"t{i:03d}": i for i in range(16)}))
    runs = {}
    for i, where in enumerate(("cpu", dev)):
        tr = Trainer(pmodel, f"parity{i}", log_dir=logdir, device=where,
                     prefetch=0, log_flush_every=1)
        st = tr.init_state(params=tree_map(
            lambda t, w=where: t.clone().to(w), params))
        tr._trunk_cache = feats.to(where)
        st, _, _ = tr.run_epoch(st, pbatches, torch.Generator(where))
        lines = open(os.path.join(tr.experiment_dir, "train",
                                  "metrics.jsonl")).read().splitlines()
        runs[i] = (
            [json.loads(x)["value"] for x in lines
             if '"train/batch_loss"' in x],
            {k: v.cpu() for k, v in flatten_tree(st["params"]).items()})
    (l_cpu, p_cpu), (l_gpu, p_gpu) = runs[0], runs[1]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    param_err = max((p_gpu[k] - v).abs().max().item()
                    for k, v in p_cpu.items())
    log(f"  f32 parity, {T_PAR_LAYERS} layers, batch {T_PAR_BATCH}, "
        f"{T_PAR_STEPS} steps: losses card {l_gpu} vs CPU {l_cpu} (max rel "
        f"{loss_err:.2e}, rtol {T_PAR_RTOL}); parameters max|card-CPU| "
        f"{param_err:.2e} (atol {T_PAR_ATOL})")
    if not (len(l_gpu) == T_PAR_STEPS and loss_err <= T_PAR_RTOL
            and param_err <= T_PAR_ATOL):
        raise AssertionError("train f32 parity: card and CPU disagree")
    out["parity"] = {"loss_rel_err": loss_err, "param_abs_err": param_err}

    # the other three captioners, 3 f32 steps each at small widths
    small = dict(num_tokens=1000)
    for cls, hp in (
            (CaptioningLSTM, dict(emb_dim=64, hidden_size=64, num_layers=2)),
            (CaptioningLSTMWithLabels, dict(emb_dim=64, hidden_size=64,
                                            num_layers=2)),
            (CaptioningTransformerBase, dict(hid_dim=64, n_layers=2,
                                             n_heads=4, pf_dim=128,
                                             max_len=50))):
        m = cls(**small, **hp)
        tr = Trainer(m, "small", log_dir=logdir, device=dev)
        st = tr.init_state(torch.Generator(dev).manual_seed(0))
        tr._trunk_cache = feats[:8].to(dev)
        sds, _ = memory_set(3 * 32, 8, 1000, 21)
        st, loss, _ = tr.run_epoch(st, BatchIterator(
            sds, 32, max_caption_len=T_CAP + 1, seed=0,
            image_rows={f"t{i:03d}": i for i in range(8)}),
            torch.Generator(dev).manual_seed(22))
        log(f"  {cls.__name__}: 3 f32 steps from the trunk cache, mean "
            f"loss {loss:.4f}")
        if not (np.isfinite(loss) and st["step"] == 3):
            raise AssertionError(f"{cls.__name__}: train steps")
        out[cls.__name__] = {"loss": loss}
    return launches, out


def recorded_all_reduce():
    """Records the port's all-reduces from now on as (device type,
    elements, backend of its group), one entry a call: the counts of
    ``utils.collectives``, where an eager call counts once and a captured
    graph adds its tally at each replay. Returns the record and a
    function that fills it in."""
    import collections

    from deephumor_tpu_torch.utils import collectives

    seen, start = [], collections.Counter(collectives.COUNTS)

    def close():
        seen.extend(k for k, n in sorted((collectives.COUNTS - start).items())
                    for _ in range(n))

    return seen, close


def logged_losses(trainer):
    """The per-step train losses that ``trainer`` logged."""
    with open(os.path.join(trainer.experiment_dir, "train",
                           "metrics.jsonl")) as f:
        return [json.loads(line)["value"] for line in f
                if '"train/batch_loss"' in line]


def recorded_relu(limit, masks=None):
    """Wraps ``torch.relu`` (the decoder calls it through the module): the
    inputs of its first ``limit`` calls are kept and, with ``masks``,
    those calls pass their inputs (and gradients) where the mask is true
    instead of where the input is above 0. Returns the inputs and a
    function that puts the original back."""
    seen, real = [], torch.relu

    def relu(x):
        if len(seen) >= limit:
            return real(x)
        seen.append(x.detach().clone())
        if masks is None:
            return real(x)
        return torch.where(masks[len(seen) - 1], x, 0.0)

    torch.relu = relu
    return seen, lambda: setattr(torch, "relu", real)


def mesh_memory_held(trainer, state, loader, gen, mesh):
    """``run_epoch`` over ``mesh``; returns the device memory allocated
    after each step (read on the host: no sync)."""
    held = []
    step = trainer._train_step

    def recorded(*args):
        out = step(*args)
        held.append(torch.cuda.memory_allocated())
        return out

    trainer._train_step = recorded
    try:
        trainer.run_epoch(state, loader, gen, mesh=mesh)
    finally:
        restore_step(trainer, step)
    return held


def parallel_train(CaptioningTransformer, tree_map, dev, name_limit, logdir,
                   mesh):
    """[13]'s training checks: the word model's bf16 steps at full width
    with and without the mesh (each all-reduce recorded), then f32 steps
    at 2 layers with and without it, which must agree."""
    import torch.distributed as dist

    from deephumor_tpu_torch.data.dataloaders import BatchIterator
    from deephumor_tpu_torch.experiments.trainer import Trainer, frozen_mask
    from deephumor_tpu_torch.parallel import replicate
    from deephumor_tpu_torch.utils.pytree import flatten_tree

    lead = dist.get_rank() == 0  # the mesh's metrics are rank 0's
    out = {}
    model = CaptioningTransformer(num_tokens=VOCAB, hid_dim=HID,
                                  n_layers=LAYERS, n_heads=HEADS, pf_dim=PF,
                                  max_len=50)
    ds, _ = memory_set(T_BATCH * P_STEPS, T_TEMPLATES, VOCAB, 11)
    rows = {f"t{i:03d}": i for i in range(T_TEMPLATES)}
    loader = list(BatchIterator(ds, T_BATCH, max_caption_len=T_CAP + 1,
                                seed=0, image_rows=rows))[:P_STEPS]
    cache = torch.randn(T_TEMPLATES, 7, 7, 2048, device=dev,
                        generator=torch.Generator(dev).manual_seed(12))
    n_trainable = None
    runs = {}
    # without the mesh, and with it captured (the default over NCCL) and
    # eager (compiled=False), from one seed
    for label, m, compiled in (("plain", None, None), ("mesh", mesh, None),
                               ("mesh_eager", mesh, False)):
        trainer = Trainer(model, f"par_{label}", log_dir=logdir,
                          compute_dtype="bfloat16", device=dev,
                          log_flush_every=1, compiled=compiled)
        state = trainer.init_state(torch.Generator(dev).manual_seed(0))
        if m is not None:
            state = replicate(state, m)
        trainer._trunk_cache = cache
        n_trainable = sum(v.numel() for v in state["opt_state"]["mu"].values())
        gen = torch.Generator(dev).manual_seed(13)
        seen, close = recorded_all_reduce()
        try:
            # a captured step after the first reads nothing from the device
            state, ms, wall, peak = train_epoch_timed(
                trainer, state, loader, gen, m, no_sync=compiled is None)
        finally:
            close()
        # the mesh's losses are logged on rank 0 only
        losses = logged_losses(trainer) if m is None or lead else None
        med = float(np.median(ms[P_WARM:]))
        keys = [k for k in trainer._graphs.info() if k["kind"] == "train"]
        out[label] = {"losses": losses, "step_ms": ms, "step_ms_median": med,
                      "peak_mem_gib": peak / 2**30,
                      "all_reduces": len(seen), "keys": keys}
        log(f"  word train, bf16, batch {T_BATCH}, {len(ms)} steps, "
            f"{'with' if m is not None else 'without'} the mesh, "
            f"{'eager' if compiled is False else 'captured'} "
            f"({name_limit}): median step {med:.2f} ms (steps "
            f"{P_WARM + 1}-{len(ms)}; all: {[round(x, 2) for x in ms]}), "
            f"peak {peak / 2**30:.2f} GiB, losses "
            f"{losses and [round(x, 4) for x in losses]}; all-reduces "
            f"{len(seen)}" + "".join(
                f"; the key's first step (eager, then capture) "
                f"{k['capture_s']:.2f} s, it holds {k['bytes'] / 2**30:.2f} "
                f"GiB, {k['replays']} replays" for k in keys))
        if (m is None or lead) and not (
                len(losses) == P_STEPS and np.isfinite(losses).all()):
            raise AssertionError(f"parallel train ({label}): losses {losses}")
        if m is None and seen:
            raise AssertionError("train without a mesh all-reduced")
        if (len(keys) != (compiled is None)
                or any(k["replays"] != P_STEPS - 1 for k in keys)):
            raise AssertionError(f"parallel train ({label}): train keys "
                                 f"{keys}")
        if m is not None:
            # per step: the BN moments (sums, sums of squares, count) in
            # the forward and their gradient in the backward; the loss's
            # token count and row weights; the gradients with the loss and
            # perplexity, before the clip. Captured, each replay adds the
            # graph's tally: the same counts
            bn = [x for x in seen if x[1] == 2 * HID + 1]
            grad = [x for x in seen if x[1] == n_trainable + 2]
            log(f"  mesh all-reduces ({label}): {len(bn)} of the BN moments "
                f"({2 * HID + 1} elements), {len(grad)} of the gradients "
                f"({n_trainable + 2} elements), on {sorted(set(seen))[:1]}"
                f" ... ({len(seen)} in all)")
            if not (len(bn) == 2 * P_STEPS and len(grad) == P_STEPS and all(
                    d == "cuda" and b == "nccl" for d, _, b in seen)):
                raise AssertionError(f"mesh train all-reduces: {seen}")
            out[label]["seen"] = seen
        runs[label] = (trainer, state, gen)
    gap = state_gap(runs["mesh"][1], runs["mesh_eager"][1])
    same_losses = out["mesh"]["losses"] == out["mesh_eager"]["losses"]
    same_reduces = out["mesh"].pop("seen") == out["mesh_eager"].pop("seen")
    log(f"  mesh, captured vs eager: parameters and moments differ by at "
        f"most {gap}; losses equal: {same_losses}; the same all-reduces "
        f"per step: {same_reduces}")
    if gap or not (same_losses and same_reduces):
        raise AssertionError("the captured mesh step differs from the eager "
                             "one")
    # the idle share of T_PROFILED more steps each: a second epoch of the
    # captured mesh trainer replays its first epoch's key (its dropout
    # generator is reseeded, not made anew)
    for label in ("mesh", "mesh_eager"):
        trainer, state, gen = runs[label]
        _, pwall, busy, _, _ = train_profile(trainer, state, loader, gen,
                                             T_PROFILED, mesh)
        keys = [k for k in trainer._graphs.info() if k["kind"] == "train"]
        out[label]["profile"] = {
            "wall_ms": pwall, "device_ms": busy,
            "idle_share": 1 - busy / pwall, "idle_share_unprofiled":
                1 - busy / T_PROFILED / out[label]["step_ms_median"]}
        log(f"  word train profile with the mesh, {label}, {T_PROFILED} "
            f"steps ({name_limit}): wall {pwall:.1f} ms, device kernel time "
            f"{busy:.1f} ms, idle share {1 - busy / pwall:.3f} under the "
            f"profiler, {out[label]['profile']['idle_share_unprofiled']:.3f}"
            f" against the unprofiled median step; train keys after a "
            f"second epoch {[(k['replays'], k['capture_s']) for k in keys]}")
        if label == "mesh" and not (
                len(keys) == 1
                and keys[0]["replays"] == P_STEPS - 1 + T_PROFILED):
            raise AssertionError(f"the mesh's second epoch made a new key: "
                                 f"{keys}")
        trainer.close()
    del runs, trainer, state

    # the mesh at the trainer's default log_flush_every, for more steps
    # than it, captured (the default): what the deferred metrics hold must
    # not grow with the steps on any rank (a metric that is a view of the
    # summed-gradient buffer would keep the whole buffer alive)
    trainer = Trainer(model, "par_memory", log_dir=logdir,
                      compute_dtype="bfloat16", device=dev)
    state = replicate(trainer.init_state(torch.Generator(dev).manual_seed(0)),
                      mesh)
    trainer._trunk_cache = cache
    steps = trainer.log_flush_every + P_MEM_EXTRA
    held = mesh_memory_held(
        trainer, state, list(itertools.islice(itertools.cycle(loader),
                                              steps)),
        torch.Generator(dev).manual_seed(13), mesh)
    growth = [None] * dist.get_world_size()
    dist.all_gather_object(growth, max(held[P_WARM:]) - held[P_WARM])
    grad_bytes = 4 * (n_trainable + 2)
    keys = [(k["kind"], k["replays"]) for k in trainer._graphs.info()]
    out["memory"] = {"steps": len(held),
                     "log_flush_every": trainer.log_flush_every,
                     "growth_bytes_per_rank": growth,
                     "gradient_buffer_bytes": grad_bytes, "keys": keys}
    if keys != [("train", steps - 1)]:
        raise AssertionError(f"mesh memory run: keys {keys}")
    log(f"  word train, bf16, batch {T_BATCH}, {len(held)} captured steps "
        f"(keys {keys}) with the "
        f"mesh at log_flush_every {trainer.log_flush_every}: device memory "
        f"held after each step grew past step {P_WARM + 1}'s by at most "
        f"{growth} bytes on the ranks (<= {grad_bytes}, one summed-gradient "
        f"buffer)")
    if len(held) != steps or max(growth) > grad_bytes:
        raise AssertionError(f"mesh train memory grows with the steps: "
                             f"{growth} bytes per rank")
    trainer.close()
    del trainer, state

    # f32, dropout 0: the mesh's steps are the plain steps. Beside them:
    # the plain steps with the first forward's ReLUs set to the mesh's
    # pattern (which units pass), so that only rounding tells the two
    # first gradients apart; over several ranks, the mesh steps with each
    # shard's own means (the normalisation fault that the gates must see)
    from deephumor_tpu_torch.experiments import trainer as trainer_mod
    from deephumor_tpu_torch.parallel.mesh import all_gather_rows, data_index

    pmodel = CaptioningTransformer(
        num_tokens=VOCAB, hid_dim=HID, n_layers=T_PAR_LAYERS, n_heads=HEADS,
        pf_dim=PF, max_len=50, enc_dropout=0.0, dec_dropout=0.0)
    params = pmodel.init(torch.Generator().manual_seed(18), device="cpu")
    feats = torch.randn(16, 7, 7, 2048,
                        generator=torch.Generator().manual_seed(19))
    pds, _ = memory_set(T_PAR_BATCH * T_PAR_STEPS, 16, VOCAB, 20)
    pbatches = list(BatchIterator(pds, T_PAR_BATCH, max_caption_len=T_CAP + 1,
                                  seed=0, image_rows={
                                      f"t{i:03d}": i for i in range(16)}))
    own = trainer_mod.masked_ce_and_perplexity

    def per_shard(*args, group=None, **kwargs):
        return tuple(x / dist.get_world_size(group)
                     for x in own(*args, **kwargs))

    several = dist.get_world_size() > 1
    group = mesh.get_group("data")
    cases = [("plain", None, own), ("mesh", mesh, own)]
    if several:  # on one rank the shard's means are the batch's
        cases.append(("per_shard", mesh, per_shard))
    cases.append(("masked", None, own))
    runs, grads, pre = {}, {}, {}
    for label, m, loss_fn in cases:
        tr = Trainer(pmodel, f"par_f32_{label}", log_dir=logdir, device=dev,
                     prefetch=0, log_flush_every=1)
        st = tr.init_state(params=tree_map(lambda t: t.clone().to(dev),
                                           params))
        if m is not None:
            st = replicate(st, m)
        tr._trunk_cache = feats.to(dev)
        update = tr._opt.update

        def first_grads(leaves, g, keys, opt_state, *rest, _label=label,
                        _update=update, **kw):
            # the summed gradient of the first step, before the clip
            if _label not in grads:
                grads[_label] = dict(zip(keys, (x.clone() for x in g)))
            return _update(leaves, g, keys, opt_state, *rest, **kw)

        tr._opt.update = first_grads
        trainer_mod.masked_ce_and_perplexity = loss_fn
        pre[label], restore = recorded_relu(
            T_PAR_LAYERS, None if label != "masked" else
            [all_gather_rows(x > 0, group) for x in pre["mesh"]])
        try:
            st, _, _ = tr.run_epoch(st, pbatches, torch.Generator(dev),
                                    mesh=m)
        finally:
            restore()
            trainer_mod.masked_ce_and_perplexity = own
        runs[label] = (
            # the mesh's losses are logged on rank 0 only
            logged_losses(tr) if m is None or lead else None,
            {k: v.cpu() for k, v in flatten_tree(st["params"]).items()})
        tr.close()
    trained = [k for k, m in flatten_tree(frozen_mask(params)).items() if m]
    n_trained = sum(runs["plain"][1][k].numel() for k in trained)
    l_plain, p_plain = runs["plain"]
    g_norm = sum(v.norm().item() ** 2 for v in grads["plain"].values()) ** 0.5
    rows = T_PAR_BATCH // dist.get_world_size()
    block = slice(data_index(mesh) * rows, (data_index(mesh) + 1) * rows)

    def grad_gap(label, ref):
        """The first summed gradients of ``label`` and ``ref``: the norm
        of the difference over the plain one's, and the three leaves
        with the largest share of it."""
        diff = sorted(((grads[label][k] - v).norm().item() / g_norm, k)
                      for k, v in grads[ref].items())
        return (sum(d ** 2 for d, _ in diff) ** 0.5,
                [(k, d) for d, k in diff[-3:]])

    def gaps(label):
        """A mesh run against the plain one: the losses' largest relative
        gap; the first forward's ReLU inputs against the plain ones on
        this rank's rows, over the ranks: the units on the other side of
        0, and the largest gap over the largest input; the first summed
        gradients against the plain run's and the masked run's; the
        parameters' largest gap, its leaves, and the share of trained
        elements past T_PAR_ATOL."""
        losses, p = runs[label]
        flips, gap, top = 0, 0.0, 0.0
        for x, ref in zip(pre[label], pre["plain"]):
            flips += int(((x > 0) != (ref[block] > 0)).sum())
            gap = max(gap, (x - ref[block]).abs().max().item())
            top = max(top, ref.abs().max().item())
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, (flips, gap, top))
        errs = sorted(((p[k] - v).abs().max().item(), k)
                      for k, v in p_plain.items())
        (g_err, g_worst), (m_err, m_worst) = (grad_gap(label, "plain"),
                                              grad_gap(label, "masked"))
        return {"n_losses": None if losses is None else len(losses),
                "loss_rel_err": None if losses is None else max(
                    abs(a - b) / abs(b) for a, b in zip(losses, l_plain)),
                "relu_flips": sum(r[0] for r in ranks),
                "relu_rel_gap": max(r[1] for r in ranks)
                / max(r[2] for r in ranks),
                "grad_rel_err": g_err, "grad_worst": g_worst,
                "grad_rel_err_masked": m_err, "grad_worst_masked": m_worst,
                "param_abs_err": errs[-1][0],
                "param_worst": [(k, e) for e, k in errs[-3:]],
                "share_past_atol": sum(
                    int(((p[k] - p_plain[k]).abs() > T_PAR_ATOL).sum())
                    for k in trained) / n_trained}

    res = {label: gaps(label) for label, m, _ in cases if m is not None}

    def fmt(worst):
        return [(k, f"{e:.2e}") for k, e in worst]

    for label, r in res.items():
        log(f"  f32, {T_PAR_LAYERS} layers, batch {T_PAR_BATCH}, "
            f"{T_PAR_STEPS} steps, {label} vs plain: losses max rel "
            f"{r['loss_rel_err']}; first forward's ReLU inputs: "
            f"{r['relu_flips']} on the other side of 0, largest gap "
            f"{r['relu_rel_gap']:.3e} of the largest input; first step's "
            f"gradient |{label}-plain|/|plain| {r['grad_rel_err']:.3e} "
            f"(the largest leaves: {fmt(r['grad_worst'])}), "
            f"|{label}-masked|/|plain| {r['grad_rel_err_masked']:.3e} "
            f"({fmt(r['grad_worst_masked'])}); parameters "
            f"max|{label}-plain| {r['param_abs_err']:.3e}, a share "
            f"{r['share_past_atol']:.3e} of {n_trained} past {T_PAR_ATOL} "
            f"(the largest: {fmt(r['param_worst'])})")
    # with the mesh's ReLU pattern the plain step's first gradient is the
    # mesh's within f32 rounding (P_GRAD_RTOL) at any world size. On one
    # rank the mesh step does the plain step's arithmetic: its gradient
    # within P_GRAD_RTOL of the plain one and every parameter within
    # T_PAR_ATOL. Over several, each rank's products have other shapes and
    # round otherwise (ReLU inputs within P_RELU_RTOL); one that rounds to
    # the other side of 0 moves a whole outer product of the gradients
    # (P_GRAD_RTOL_RANKS), and Adam scales gradients that are rounding
    # noise up to steps of up to lr (a share P_PARAM_SHARE of the
    # parameters may pass T_PAR_ATOL). The per-shard means must fail the
    # three gates
    mesh_r, fault = res["mesh"], res.get("per_shard")
    grad_rtol = P_GRAD_RTOL_RANKS if several else P_GRAD_RTOL
    share = P_PARAM_SHARE if several else 0.0
    log(f"  f32 gates: mesh losses rtol {T_PAR_RTOL}, ReLU inputs' gap <= "
        f"{P_RELU_RTOL}, gradient vs masked <= {P_GRAD_RTOL}, vs plain <= "
        f"{grad_rtol}, a share <= {share} of the parameters past "
        f"{T_PAR_ATOL}" + (
            f"; the per-shard means read "
            f"{fault['grad_rel_err_masked'] / P_GRAD_RTOL:.1f}, "
            f"{fault['grad_rel_err'] / grad_rtol:.1f} and "
            f"{fault['share_past_atol'] / share:.1f} times those three"
            if fault else ""))
    if not ((mesh_r["n_losses"] is None
             or (mesh_r["n_losses"] == T_PAR_STEPS
                 and mesh_r["loss_rel_err"] <= T_PAR_RTOL))
            and mesh_r["relu_rel_gap"] <= P_RELU_RTOL
            and mesh_r["grad_rel_err_masked"] <= P_GRAD_RTOL
            and mesh_r["grad_rel_err"] <= grad_rtol
            and mesh_r["share_past_atol"] <= share
            and (several or mesh_r["param_abs_err"] <= T_PAR_ATOL)):
        raise AssertionError("parallel train f32: mesh and plain disagree")
    if fault is not None and not (fault["grad_rel_err_masked"] > P_GRAD_RTOL
                                  and fault["grad_rel_err"] > grad_rtol
                                  and fault["share_past_atol"] > share):
        raise AssertionError("parallel train f32: the gates do not see the "
                             "per-shard means")
    out["f32"] = res
    return out


def parallel_tp_one(CaptioningTransformer, _build, modules, dev, name_limit,
                    logdir, mesh):
    """[13]'s data 1 x model 1 part: ``place_train_state`` places a Shard on
    the one-rank mesh's model axis, so the DP x TP step and a decode given
    ``mesh.get_group("model")`` make their model-axis all-reduces over a
    one-rank NCCL group, inside their graphs. The word step (bf16, batch
    T_BATCH) captured beside eager: bit-equal, the same all-reduces a
    step; the word decode at the word leg's width with that group
    (``compare_compiled``): bit-equal, launches equal, K1-K3 and no twin
    on the card. Returns the decode's launches per call and the numbers."""
    from deephumor_tpu_torch.data.dataloaders import BatchIterator
    from deephumor_tpu_torch.experiments.trainer import Trainer
    from deephumor_tpu_torch.models import graphs
    from deephumor_tpu_torch.parallel import (make_param_shardings,
                                              place_train_state)
    from deephumor_tpu_torch.parallel.sharding import local_tree, model_group

    out = {}
    model = CaptioningTransformer(num_tokens=VOCAB, hid_dim=HID,
                                  n_layers=LAYERS, n_heads=HEADS, pf_dim=PF,
                                  max_len=50)
    ds, _ = memory_set(T_BATCH * P_STEPS, T_TEMPLATES, VOCAB, 11)
    rows = {f"t{i:03d}": i for i in range(T_TEMPLATES)}
    loader = list(BatchIterator(ds, T_BATCH, max_caption_len=T_CAP + 1,
                                seed=0, image_rows=rows))[:P_STEPS]
    cache = torch.randn(T_TEMPLATES, 7, 7, 2048, device=dev,
                        generator=torch.Generator(dev).manual_seed(12))
    runs = {}
    for label, compiled in (("captured", None), ("eager", False)):
        trainer = Trainer(model, f"tp1_{label}", log_dir=logdir,
                          compute_dtype="bfloat16", device=dev,
                          log_flush_every=1, compiled=compiled)
        state = place_train_state(
            trainer.init_state(torch.Generator(dev).manual_seed(0)), mesh)
        trainer._trunk_cache = cache
        seen, close = recorded_all_reduce()
        try:
            state, ms, _, peak = train_epoch_timed(
                trainer, state, loader, torch.Generator(dev).manual_seed(13),
                mesh, no_sync=compiled is None)
        finally:
            close()
        keys = [(k["kind"], k["replays"]) for k in trainer._graphs.info()]
        med = float(np.median(ms[P_WARM:]))
        out[label] = {"step_ms": ms, "step_ms_median": med,
                      "peak_mem_gib": peak / 2**30, "all_reduces": len(seen),
                      "keys": keys}
        runs[label] = (state, sorted(seen))
        trainer.close()
        log(f"  DP x TP word train on data 1 x model 1, bf16, batch "
            f"{T_BATCH}, {len(ms)} steps, {label} ({name_limit}): median "
            f"step {med:.2f} ms (all: {[round(x, 2) for x in ms]}), peak "
            f"{peak / 2**30:.2f} GiB, {len(seen)} all-reduces, keys {keys}")
    grouped = model_group(runs["captured"][0]["params"])
    gap = state_gap(runs["captured"][0], runs["eager"][0])
    same = runs["captured"][1] == runs["eager"][1]
    log(f"  DP x TP captured vs eager: the model group has "
        f"{grouped.size() if grouped is not None else None} rank(s); "
        f"parameters and moments differ by at most {gap}; the same "
        f"all-reduces: {same}")
    if grouped is None or gap or not same or out["captured"]["keys"] != [
            ("train", P_STEPS - 1)]:
        raise AssertionError("[13] the captured DP x TP step differs from "
                             "the eager one")
    del runs, state, trainer, cache

    model, params = make_model(CaptioningTransformer, "bfloat16", dev, False)
    local = local_tree(make_param_shardings(params, mesh))
    enc = features(BATCH, dev, 4)
    kw = dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K, temperature=1.0,
              sampler="pallas", model_group=mesh.get_group("model"))
    word = ("ancestry_attention_update", "grouped_cross_attention",
            "fused_topk_gumbel_sample")
    hits, restore = twin_guard(modules)
    try:
        res = compare_compiled(model, local, enc, kw, _build, graphs,
                               "word with a one-rank model group",
                               name_limit, path_kernels=word, tag="[13]")
    finally:
        restore()
    extra = [k for k, v in res["launches_per_call"].items()
             if v and k not in word]
    if hits or extra:
        raise AssertionError(f"[13] decode with a model group: twins on the "
                             f"card {sorted(set(hits))}, launched off the "
                             f"path {extra}")
    out["decode"] = res
    return res["launches_per_call"], out


def parallel_serving(CaptioningTransformer, _build, modules, dev, mesh):
    """[13]'s serving check: a mesh pipeline behind a DynamicBatcher
    answers P_REQUESTS greedy requests, handed over in one submit_many
    (one padded call, the composition of the plain pipeline's), equal to
    the pipeline without a mesh. Returns the launches of the batcher's
    run."""
    import torch.distributed as dist

    from deephumor_tpu_torch.data import Vocab
    from deephumor_tpu_torch.pipeline import MemeGenerationPipeline
    from deephumor_tpu_torch.serving import DynamicBatcher

    model, params = make_model(CaptioningTransformer, "bfloat16", dev, False)
    bias = params["decoder"]["classifier"]["bias"]
    bias[0], bias[3] = S_PAD_BIAS, S_EOS_BIAS
    vocab = Vocab([f"word{i}" for i in range(VOCAB - 6)])
    images = torch.randn(P_TEMPLATES, 224, 224, 3, device=dev,
                         generator=torch.Generator(dev).manual_seed(21))
    ids = [f"p{i:02d}" for i in range(P_TEMPLATES)]
    requests = [ids[(5 * i) % P_TEMPLATES] for i in range(P_REQUESTS)]
    kw = dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K, greedy=True)
    lead = dist.get_rank() == 0
    want = got = []
    if lead:
        # the plain pipeline on each rank's block of the one padded call
        plain = MemeGenerationPipeline(model, params, vocab)
        plain.add_templates(ids, images, batch_size=S_CHUNK)
        n = P_REQUESTS // dist.get_world_size()
        want = [t for i in range(0, P_REQUESTS, n)
                for t in plain.generate_captions(requests[i:i + n], **kw)]
    pipe = MemeGenerationPipeline(model, params, vocab, mesh=mesh)
    pipe.add_templates(ids, images, batch_size=S_CHUNK)
    hits, restore = twin_guard(modules)
    _build.reset_launch_counts()
    calls = 0
    try:
        if lead:
            with DynamicBatcher(pipe, max_batch=P_REQUESTS, **kw) as srv:
                got = [f.result(timeout=120)
                       for f in srv.submit_many(requests)]
            calls = srv.batches_dispatched
        else:
            pipe.follow()
    finally:
        restore()
        pipe.close()
    launches = dict(_build.LAUNCHES)
    # greedy at this EOS bias may end a caption at once: texts may be
    # empty, but hold no token outside the vocabulary, UNK or PAD
    bad = [t for t in got if {"<unk>", "<pad>"} & set(t.split())
           or any(w not in vocab.stoi for w in t.split())]
    log(f"  mesh pipeline behind a DynamicBatcher: {len(got)} greedy "
        f"requests in {calls} call(s), equal to the pipeline without a mesh "
        f"(on each rank's block): {got == want}; launches {launches}; plain "
        f"twins called with CUDA tensors: {sorted(set(hits))}")
    word = ("ancestry_attention_update", "grouped_cross_attention")
    if (lead and len(got) != P_REQUESTS) or got != want or bad or hits or any(
            launches[k] < 1 for k in word) or any(
            v for k, v in launches.items() if k not in word):
        raise AssertionError("mesh serving: texts, launches or twins")
    return launches


def check_parallel(CaptioningTransformer, tree_map, _build, modules, dev,
                   name_limit, logdir):
    """The parallel phase (module docstring, [13]) on this one card, at
    world size 1 over NCCL. Returns the launches of its dp_generate run
    and of the mesh batcher's, and its numbers."""
    import torch.distributed as dist

    from deephumor_tpu_torch.models import graphs
    from deephumor_tpu_torch.parallel import dp_generate, make_mesh, replicate

    mesh = make_mesh("cuda")
    try:
        backend = dist.get_backend(mesh.get_group("data"))
        world = dist.get_world_size()
        log(f"  mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}: world "
            f"size {world}, backend {backend}")
        if backend != "nccl" or world != int(os.environ.get("WORLD_SIZE",
                                                             1)):
            raise AssertionError("the mesh is not one NCCL rank per card")
        out = {"backend": backend, "world_size": world}

        model, params = make_model(CaptioningTransformer, "bfloat16", dev,
                                   False)
        params = replicate(params, mesh)
        enc = features(BATCH, dev, 4)
        kw = dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K,
                  temperature=1.0, sampler="pallas")
        hits, restore = twin_guard(modules)
        _build.reset_launch_counts()
        try:
            greedy = dp_generate(model, params, enc, mesh, greedy=True, **kw)
            sampled = [dp_generate(
                model, params, enc, mesh,
                generator=torch.Generator(dev).manual_seed(5), **kw)
                for _ in range(2)]
        finally:
            restore()
        launches = dict(_build.LAUNCHES)
        for o in (greedy, *sampled):
            check_output(o, BATCH, VOCAB, BEAM, MAX_LEN)
        # the plain call on each rank's block: the very products (shapes)
        # of that rank's call, so greedy is token-equal. The whole batch
        # in one plain call rounds its bf16 products at other shapes, so
        # over several ranks a near tie may go the other way: its share
        # of equal items is reported
        blocks = [model.generate_from_emb(
            params, tuple(x.chunk(world)[i] for x in enc), greedy=True,
            **kw) for i in range(world)]
        plain = {k: torch.cat([b[k] for b in blocks])
                 for k in ("sequences", "chosen", "ended")}
        same = all(torch.equal(greedy[k], plain[k]) for k in plain)
        whole = (plain if world == 1 else model.generate_from_emb(
            params, enc, greedy=True, **kw))
        share = (greedy["chosen"] == whole["chosen"]).all(dim=1).float()
        share = share.mean().item()
        repeat = all(torch.equal(sampled[0][k], sampled[1][k])
                     for k in ("sequences", "chosen", "scores"))
        word = ("ancestry_attention_update", "grouped_cross_attention",
                "fused_topk_gumbel_sample")
        missing = [k for k in word if launches[k] < 1]
        extra = [k for k, v in launches.items() if v and k not in word]
        out["greedy_equal_share_whole_batch"] = share
        log(f"  dp_generate, batch {BATCH} (greedy, then sampled twice with "
            f"seed 5): greedy token-equal to generate_from_emb on each "
            f"rank's block of {BATCH // world}: {same} (to one call of all "
            f"{BATCH}: {share:.4f} of items); the "
            f"sampled calls equal: {repeat}; launches {launches}; plain "
            f"twins called with CUDA tensors: {sorted(set(hits))}")
        if missing or extra or hits or not (same and repeat):
            raise AssertionError(f"dp_generate: kernels not launched "
                                 f"{missing}, launched off the path {extra}, "
                                 f"twins on the card {sorted(set(hits))}, "
                                 f"greedy equal {same}, repeat {repeat}")
        # sampled calls in turns: plain, dp_generate, dp_generate, plain
        calls = {"plain": lambda g: model.generate_from_emb(
                     params, enc, generator=g, **kw),
                 "dp_generate": lambda g: dp_generate(
                     model, params, enc, mesh, generator=g, **kw)}
        secs = {k: [] for k in calls}
        for i, label in enumerate(("plain", "dp_generate", "dp_generate",
                                   "plain") * 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[label](torch.Generator(dev).manual_seed(30 + i))
            torch.cuda.synchronize()
            secs[label].append((time.perf_counter() - t0) * 1e3)
        out["generate_ms"] = secs
        log(f"  sampled call, batch {BATCH} ({name_limit}): dp_generate "
            f"{[round(x, 1) for x in secs['dp_generate']]} ms, "
            f"generate_from_emb {[round(x, 1) for x in secs['plain']]} ms")
        del model, params, enc, greedy, sampled, plain, blocks, whole

        out["train"] = parallel_train(CaptioningTransformer, tree_map, dev,
                                      name_limit, logdir, mesh)
        if world == 1:
            out["tp_one_launches"], out["tp_one"] = parallel_tp_one(
                CaptioningTransformer, _build, modules, dev, name_limit,
                logdir, mesh)
        serving = parallel_serving(CaptioningTransformer, _build, modules,
                                   dev, mesh)
    except BaseException:
        # the error first, and the group left as it is: a graph that holds
        # its collectives may live on in the traceback, and a peer may be
        # inside a collective
        traceback.print_exc()
        sys.stderr.flush()
        raise
    # graphs that hold the group's collectives go before it
    gc.collect()
    graphs.clear()
    dist.destroy_process_group()
    return launches, serving, out


def check_tp_kernels(A, S, dev, gen, rows):
    """[14]'s kernels at the head-local shapes of TP_SHAPES, bf16: K1 and
    K2 at the word leg's rows, K5, K6 and K4 at the char settings, each
    against its twin and timed (K3, whose rows do not depend on the
    width, at the rows of [14]'s calls). Adds each one's numbers to its
    row under "tp"."""
    bf = torch.bfloat16
    for d, h in TP_SHAPES:
        key = f"D{d}_h{h}"
        log(f"    D {d}, {h} heads (head_dim {d // h}): K1 rows {ROWS}, "
            f"P {P}; K2 G {BATCH}, T {T_ENC}; K5/K6 rows {C_ROWS}, P {C_P}; "
            f"K4 x [{C_ROWS}, {d}] W [{C_VOCAB}, {d}]")
        got = {"ancestry_attention_update": check_k1(
            A, dev, gen, items=BATCH, beam=BEAM, p=P, pes=(16, 24, 32),
            dt=bf, d=d, heads=h, label=f"K1 {key}"),
               "grouped_cross_attention": check_k2(
            A, dev, gen, items=BATCH, beam=BEAM, d=d, n_heads=h)}
        (got["ancestry_attention_update_canon"],
         got["ancestry_attention_ids"]) = check_k5_k6(A, dev, gen, d=d,
                                                      n_heads=h)
        got["fused_classifier_topk_gumbel_sample"] = check_k4(S, dev, gen,
                                                              d=d)
        for name, r in got.items():
            rows[name].setdefault("tp", {})[key] = {
                k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                  "max_abs_err")}
            log(f"    {name} at {key}: {r['ms']:.4f} ms (twin "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
                f"{r['bound_ms']:.4f} ms), max|out-twin| "
                f"{r['max_abs_err']:.3e}")
    r = check_k3(S, dev, gen, rows=TP_BATCH * BEAM, vocab=VOCAB, top_k=TOP_K,
                 draws=BEAM, inv_t=1.0, label=f"K3 rows {TP_BATCH * BEAM}")
    rows["fused_topk_gumbel_sample"]["tp"] = {f"rows{TP_BATCH * BEAM}": {
        k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                          "max_abs_err")}}


def run_tp_phase(A, S, dev, gen, rows, name_limit):
    """[14]: the kernels at the head-local shapes, then the two processes
    of ``check_tp``. Returns the phase's numbers, with each rank's
    launches under ``launches_by_rank``."""
    log(f"[14] tensor parallel: K1, K2, K5, K6 and K4 at the head-local "
        f"shapes {TP_SHAPES} (width, heads), bf16, K3 at {TP_BATCH * BEAM} "
        f"rows; tp_generate on a data 1 x model {TP_RANKS} mesh over gloo, "
        f"two processes on this card (bf16 batch {TP_BATCH}, f32 parity at "
        f"{TP_F32_LAYERS} layers); the DP x TP train step")
    check_tp_kernels(A, S, dev, gen, rows)
    launches, tp = check_tp(card())
    tp["launches_by_rank"] = launches
    return tp


def tp_only():
    """``--tp``: builds the kernels and runs [14] alone; prints its numbers
    as one JSON line."""
    from deephumor_tpu_torch.ops import _build
    from deephumor_tpu_torch.ops import attention as A
    from deephumor_tpu_torch.ops import sampler as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.library()
    rows = {k: {} for k in ("ancestry_attention_update",
                            "grouped_cross_attention",
                            "fused_topk_gumbel_sample",
                            "fused_classifier_topk_gumbel_sample",
                            "ancestry_attention_update_canon",
                            "ancestry_attention_ids")}
    tp = run_tp_phase(A, S, dev, torch.Generator(dev).manual_seed(0), rows,
                      card())
    print(json.dumps({"tp": tp, "kernels": {k: r.get("tp")
                                            for k, r in rows.items()}}),
          flush=True)


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def check_tp(name_limit):
    """[14]'s two processes on this card: ``--tp-rank`` 0 and 1 over a
    gloo group (NCCL takes one rank per card), a data 1 x model 2 mesh.
    Runs them, checks their JSON results and returns each rank's launches
    and the numbers."""
    out = {}
    with tempfile.TemporaryDirectory(dir=_build_dir()) as outdir:
        port = free_port()
        logs = [open(os.path.join(outdir, f"rank{r}.log"), "w")
                for r in range(TP_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
             str(port), outdir], stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(TP_RANKS)]
        deadline = time.monotonic() + TP_TIMEOUT_S
        try:
            for p in procs:
                p.wait(max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        texts = [open(os.path.join(outdir, f"rank{r}.log")).read()
                 for r in range(TP_RANKS)]
        for r, t in enumerate(texts):
            for line in t.splitlines()[-40:]:
                log(f"    [rank {r}] {line}")
        if any(p.returncode for p in procs):
            raise AssertionError(f"[14] tp ranks exited "
                                 f"{[p.returncode for p in procs]}")
        res = [json.load(open(os.path.join(outdir, f"tp{r}.json")))
               for r in range(TP_RANKS)]
    word = ("ancestry_attention_update", "grouped_cross_attention",
            "fused_topk_gumbel_sample")
    for r, x in enumerate(res):
        missing = [k for k in word if x["launches"][k] < 1]
        extra = [k for k, v in x["launches"].items() if v and k not in word]
        if missing or extra or x["hits"]:
            raise AssertionError(f"[14] rank {r}: kernels not launched "
                                 f"{missing}, launched off the path {extra}, "
                                 f"twins on the card {x['hits']}")
        if not (x["gloo_cuda"] and x["f32_equal"] and x["repeat"]
                and x["greedy_share"] >= TP_GREEDY_SHARE):
            raise AssertionError(f"[14] rank {r}: gloo on CUDA tensors "
                                 f"{x['gloo_cuda']}, f32 greedy token-equal "
                                 f"{x['f32_equal']}, sampled repeatable "
                                 f"{x['repeat']}, bf16 greedy share "
                                 f"{x['greedy_share']}")
    x = res[0]
    p = x["params"]
    log(f"  DP x TP train step, f32, {TP_F32_LAYERS} layers, batch "
        f"{T_PAR_BATCH}, dropout {x['train']['dropout']}: losses "
        f"{x['train']['tp']} vs one card's {x['train']['plain']} (rtol "
        f"{TP_TRAIN_RTOL}); gathered parameters max|tp-card| "
        f"{p['max_abs_diff']:.3e}, a share {p['share_past_atol']:.3e} of "
        f"{p['n_trained']} past {T_PAR_ATOL} (<= {TP_PARAM_SHARE})")
    for k, over, rows, gap, g, g_med, g_max in p["past"][:12]:
        log(f"    {k}: {over} past in {rows} rows, largest gap {gap:.3e}, "
            f"first-step gradient there {g:.3e} (the leaf's median "
            f"{g_med:.3e}, largest {g_max:.3e})")
    for r in res:
        np.testing.assert_allclose(r["train"]["tp"], r["train"]["plain"],
                                   rtol=TP_TRAIN_RTOL)
        if r["params"]["share_past_atol"] > TP_PARAM_SHARE:
            raise AssertionError(f"[14] rank {r['rank']}: a share "
                                 f"{r['params']['share_past_atol']} of the "
                                 f"parameters past {T_PAR_ATOL}")
    if res[0]["sampled"] != res[1]["sampled"]:
        raise AssertionError("[14] the two model ranks drew apart")
    out.update(greedy_share=x["greedy_share"], generate_ms=x["secs"],
               train_losses=x["train"], gloo_cuda=x["gloo_cuda"],
               launches_by_rank=[r["launches"] for r in res],
               params=dict(p, past=p["past"][:12]))
    log(f"  tp_generate, data 1 x model 2 over gloo, two processes on "
        f"this card ({name_limit}): gloo all_reduce / broadcast / all_gather "
        f"of CUDA tensors {x['gloo_cuda']}; f32 greedy at {TP_F32_LAYERS} "
        f"layers ({TP_F32_ITEMS} items) token-equal to generate_from_emb: "
        f"{x['f32_equal']}; bf16 greedy at full width, batch {TP_BATCH}: "
        f"{x['greedy_share']:.4f} of items token-equal (>= "
        f"{TP_GREEDY_SHARE}); sampled twice with seed 5: repeatable, equal "
        f"on both ranks; launches per rank {out['launches_by_rank']}, no "
        f"twin on the card")
    log(f"  sampled call, batch {TP_BATCH}: tp_generate over the two "
        f"processes {[round(v, 1) for v in x['secs']['tp']]} ms, "
        f"generate_from_emb in one {[round(v, 1) for v in x['secs']['plain']]}"
        f" ms")
    return [r["launches"] for r in res], out


def _build_dir():
    from deephumor_tpu_torch.ops import _build

    return _build.BUILD_DIR


def _cut(x, mesh, placements):
    """This rank's shard of ``x`` (equal on every rank) as a DTensor of
    ``placements``, cut with no collective."""
    from torch.distributed.tensor import DTensor, Shard

    local = x
    for axis, p in enumerate(placements):
        if isinstance(p, Shard):
            local = local.tensor_split(mesh.size(axis), p.dim)[
                mesh.get_local_rank(axis)]
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def place_own(params, mesh):
    """``params`` (equal on every rank) placed as
    ``parallel.make_param_shardings`` places them, each rank cutting its
    own shards: ``distribute_tensor`` scatters from one rank, which gloo
    does not do with CUDA tensors."""
    from torch.distributed.tensor import Replicate, Shard

    from deephumor_tpu_torch.parallel import tp_param_specs

    names = mesh.mesh_dim_names

    def place(x, spec):
        if isinstance(x, dict):
            return {k: place(v, spec[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [place(v, sp) for v, sp in zip(x, spec)]
        return _cut(x, mesh, tuple(Shard(spec.index(n)) if n in spec
                                   else Replicate() for n in names))

    return place(params, tp_param_specs(params))


def place_state_own(state, mesh):
    """A train state placed as ``parallel.place_train_state`` places it
    (Adam's moments as their parameter), cut as :func:`place_own`."""
    from deephumor_tpu_torch.utils.pytree import flatten_tree

    params = place_own(state["params"], mesh)
    flat = flatten_tree(params)
    opt = dict(state["opt_state"])
    for name in ("mu", "nu"):
        opt[name] = {k: _cut(v, mesh, flat[k].placements)
                     for k, v in opt[name].items()}
    return dict(state, params=params, opt_state=opt)


def gather_own(tree):
    """``tree`` with every DTensor leaf gathered whole with
    ``dist.all_gather`` (gloo takes CUDA tensors there, not in the
    functional collectives of ``full_tensor``)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from deephumor_tpu_torch.utils.pytree import tree_map

    def whole(x):
        if not isinstance(x, DTensor):
            return x
        t = x.to_local()
        for axis, p in enumerate(x.placements):
            if isinstance(p, Shard):
                group = x.device_mesh.get_group(axis)
                parts = [torch.empty_like(t)
                         for _ in range(dist.get_world_size(group))]
                dist.all_gather(parts, t.contiguous(), group=group)
                t = torch.cat(parts, dim=p.dim)
        return t

    with torch.no_grad():
        return tree_map(whole, tree)


def tp_train_losses(model, dev, logdir, mesh, gen):
    """T_PAR_STEPS f32 steps of ``model`` at batch T_PAR_BATCH from a
    random trunk cache, dropout drawn from ``gen``: each step's loss, the
    parameters after them (gathered whole), and the first step's gradient
    as Adam applied it (after the clip; read from the second moment), by
    flat key, or None on a mesh. With ``mesh``, over a state placed as
    ``place_train_state`` places it (every rank holds the same initial
    state)."""
    from deephumor_tpu_torch.data.dataloaders import BatchIterator
    from deephumor_tpu_torch.experiments.trainer import Adam, Trainer

    ds, _ = memory_set(T_PAR_BATCH * T_PAR_STEPS, T_TEMPLATES, VOCAB, 11)
    rows = {f"t{i:03d}": i for i in range(T_TEMPLATES)}
    loader = list(BatchIterator(ds, T_PAR_BATCH, max_caption_len=T_CAP + 1,
                                seed=0, image_rows=rows))[:T_PAR_STEPS]
    trainer = Trainer(model, "tp" if mesh else "plain", log_dir=logdir,
                      device=dev, log_flush_every=1, prefetch=0)
    state = trainer.init_state(params=model.init(
        torch.Generator(dev).manual_seed(0), dev))
    if mesh is not None:
        state = place_state_own(state, mesh)
    trainer._trunk_cache = torch.randn(
        T_TEMPLATES, 7, 7, 2048, device=dev,
        generator=torch.Generator(dev).manual_seed(12))
    losses, first_grad, step = [], {}, trainer._train_step

    def recorded(*args):
        st, metrics = step(*args)
        losses.append(float(metrics["loss"]))
        if len(losses) == 1 and mesh is None:
            first_grad.update({
                k: (v / (1 - Adam.b2)).sqrt()
                for k, v in st["opt_state"]["nu"].items()})
        return st, metrics

    trainer._train_step = recorded
    state, _, _ = trainer.run_epoch(state, loader, gen, mesh=mesh)
    trainer.close()
    return losses, gather_own(state["params"]), first_grad or None


def param_gaps(plain, tp, grad):
    """The trained parameters (the keys of ``grad``, one card's first-step
    gradient) of a mesh run against one card's: the largest gap, the share
    of elements past T_PAR_ATOL, and the leaves with such elements, the
    largest gap first: each with their count, the rows (indices along
    axis 0) that hold them, its largest gap, the first-step gradient
    there, and the leaf's median and largest first-step gradient."""
    n, past, top, leaves = 0, 0, 0.0, []
    for k, g in grad.items():
        gap = (plain[k] - tp[k]).abs().flatten()
        n += gap.numel()
        at = (gap > T_PAR_ATOL).nonzero().flatten()
        past += at.numel()
        i = int(gap.argmax())
        top = max(top, gap[i].item())
        if at.numel():
            g = g.flatten()
            rows = at // (gap.numel() // grad[k].shape[0])
            leaves.append([k, at.numel(), int(rows.unique().numel()),
                           gap[i].item(), g[i].item(), g.median().item(),
                           g.max().item()])
    return {"max_abs_diff": top, "share_past_atol": past / n,
            "n_trained": n, "past": sorted(leaves, key=lambda r: -r[3])}


def tp_rank(rank, port, outdir, device_type="cuda"):
    """``--tp-rank``: one of [14]'s two processes on this card (module
    docstring). Writes its results as ``tp<rank>.json`` in ``outdir``.
    ``device_type="cpu"`` rehearses it on the CPU at widths the caller
    sets in this module's constants (the kernels' twins run there)."""
    import faulthandler

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from deephumor_tpu_torch.models import CaptioningTransformer
    from deephumor_tpu_torch.ops import _build
    from deephumor_tpu_torch.ops import attention as A
    from deephumor_tpu_torch.ops import cache as C
    from deephumor_tpu_torch.ops import engine as E
    from deephumor_tpu_torch.ops import sampler as S
    from deephumor_tpu_torch.parallel.mesh import shard_generator
    from deephumor_tpu_torch.utils.pytree import flatten_tree

    faulthandler.enable()  # a crash prints where it was
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device_type == "cuda"
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=TP_RANKS)
    try:
        if on_card:
            _build.library()
        out = {"rank": rank}
        # gloo on CUDA tensors: the collectives tp_generate and the step use
        x = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        y = torch.full((4,), float(rank + 7), device=dev)
        dist.broadcast(y, src=1)
        parts = [torch.empty(2, device=dev) for _ in range(TP_RANKS)]
        dist.all_gather(parts, torch.full((2,), float(rank), device=dev))
        out["gloo_cuda"] = bool(
            (x == 3).all() and (y == 8).all()
            and all((p == i).all() for i, p in enumerate(parts)))
        mesh = init_device_mesh(device_type, (1, TP_RANKS),
                                mesh_dim_names=("data", "model"))
        print(f"rank {rank}: mesh {mesh}, gloo on CUDA {out['gloo_cuda']}",
              flush=True)

        # f32 greedy at TP_F32_LAYERS layers: token-equal to one rank
        model = CaptioningTransformer(
            num_tokens=VOCAB, hid_dim=HID, n_layers=TP_F32_LAYERS,
            n_heads=HEADS, pf_dim=PF, max_len=MAX_LEN + 2)
        params = model.init(torch.Generator(dev).manual_seed(0), dev)
        params["decoder"]["classifier"]["bias"][3] = EOS_BIAS
        enc = features(TP_F32_ITEMS, dev, 1)
        kw = dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K)
        want = model.generate_from_emb(params, enc, greedy=True, **kw)
        got = model.generate_from_emb(
            place_own(params, mesh), enc,
            greedy=True, **kw)
        out["f32_equal"] = all(torch.equal(got[k], want[k])
                               for k in ("sequences", "chosen", "ended"))
        print(f"rank {rank}: f32 greedy equal {out['f32_equal']}",
              flush=True)

        # bf16 at full width: the kernels' launches, greedy, sampled
        model, params = make_model(CaptioningTransformer, "bfloat16", dev,
                                   False)
        tp = place_own(params, mesh)
        enc = features(TP_BATCH, dev, 4)
        kw = dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K,
                  temperature=1.0, sampler="pallas")
        model.generate_from_emb(tp, enc, **kw)  # warm-up
        hits, restore = twin_guard((A, C, E, S))
        _build.reset_launch_counts()
        try:
            greedy = model.generate_from_emb(tp, enc, greedy=True, **kw)
            sampled = [model.generate_from_emb(
                tp, enc, generator=torch.Generator(dev).manual_seed(5), **kw)
                for _ in range(2)]
        finally:
            restore()
        out["launches"] = dict(_build.LAUNCHES)
        out["hits"] = sorted(set(hits))
        for o in (greedy, *sampled):
            check_output(o, TP_BATCH, VOCAB, BEAM, MAX_LEN)
        plain = model.generate_from_emb(params, enc, greedy=True, **kw)
        out["greedy_share"] = (greedy["chosen"] == plain["chosen"]).all(
            dim=1).float().mean().item()
        out["repeat"] = all(torch.equal(sampled[0][k], sampled[1][k])
                            for k in ("sequences", "chosen", "scores"))
        out["sampled"] = sampled[0]["chosen"].tolist()
        print(f"rank {rank}: launches {out['launches']}, greedy share "
              f"{out['greedy_share']}", flush=True)
        # in turns: one rank's call (the other waits), the two ranks' call
        secs = {"plain": [], "tp": []}
        for i, label in enumerate(("plain", "tp", "tp", "plain")):
            g = torch.Generator(dev).manual_seed(30 + i)
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            if label == "tp":
                model.generate_from_emb(tp, enc, generator=g, **kw)
            elif rank == 0:
                model.generate_from_emb(params, enc, generator=g, **kw)
            sync()
            if label == "tp" or rank == 0:
                secs[label].append((time.perf_counter() - t0) * 1e3)
        out["secs"] = secs
        print(f"rank {rank}: timed {secs}", flush=True)
        del model, params, tp, enc, greedy, sampled, plain

        # the DP x TP train step, f32, at the model's dropout, against one
        # card's steps with the generator of this data block
        model = CaptioningTransformer(
            num_tokens=VOCAB, hid_dim=HID, n_layers=TP_F32_LAYERS,
            n_heads=HEADS, pf_dim=PF, max_len=50)
        logdir = os.path.join(outdir, f"train{rank}")
        plain_losses, plain_params, grad = tp_train_losses(
            model, dev, logdir, None,
            shard_generator(torch.Generator(dev).manual_seed(13), mesh))
        print(f"rank {rank}: one card's steps {plain_losses}", flush=True)
        tp_losses, tp_params, _ = tp_train_losses(
            model, dev, logdir, mesh, torch.Generator(dev).manual_seed(13))
        out["train"] = {"plain": plain_losses, "tp": tp_losses,
                        "dropout": [model.enc_dropout, model.dec_dropout]}
        out["params"] = param_gaps(flatten_tree(plain_params),
                                   flatten_tree(tp_params), grad)
        print(f"rank {rank}: train {out['train']}", flush=True)
        with open(os.path.join(outdir, f"tp{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def check_tp_mesh(CaptioningTransformer, _build, modules, dev, name_limit,
                  logdir):
    """``--mesh-ranks``' tensor-parallel part: a data N/2 x model 2 NCCL
    mesh, one rank per card. ``tp_generate`` at the word leg (batch BATCH)
    captured (the default) beside eager and beside one card's captured
    call; the data-parallel step over every card (data N) and the DP x TP
    step (bf16, batch T_BATCH), each captured beside eager, timed in turns
    beside one card's captured step. Returns the launches of a captured
    tp_generate call and its numbers."""
    import torch.distributed as dist

    from deephumor_tpu_torch.data.dataloaders import BatchIterator
    from deephumor_tpu_torch.experiments.trainer import Trainer
    from deephumor_tpu_torch.models import graphs
    from deephumor_tpu_torch.parallel import (make_mesh, make_param_shardings,
                                              place_train_state, replicate)
    from deephumor_tpu_torch.parallel.mesh import data_index
    from deephumor_tpu_torch.parallel.sharding import local_tree

    mesh = make_mesh("cuda", model=2)
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = {"mesh": shape}
    model, params = make_model(CaptioningTransformer, "bfloat16", dev, False)
    tp = make_param_shardings(params, mesh)
    enc = features(BATCH, dev, 4)
    kw = dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K, temperature=1.0,
              sampler="pallas")

    def call(params, compiled, seed=5, **extra):
        return model.generate_from_emb(
            params, enc, generator=torch.Generator(dev).manual_seed(seed),
            compiled=compiled, **dict(kw, **extra))

    graphs.clear()
    eager = call(tp, False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    captured = call(tp, None)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    info = graphs.cache_info()
    again = call(tp, None)
    greedy = [call(tp, c, greedy=True) for c in (False, None)]
    same = (same_outputs(captured, eager) and same_outputs(again, eager)
            and same_outputs(*greedy))
    hits, restore = twin_guard(modules)
    counts = []
    try:
        for compiled in (False, None):
            _build.reset_launch_counts()
            call(tp, compiled)
            counts.append(dict(_build.LAUNCHES))
    finally:
        restore()
    launches = counts[1]
    for o in (eager, captured, *greedy):
        check_output(o, BATCH, VOCAB, BEAM, MAX_LEN)
    # the rank's decode alone (its data block, the model group), which
    # replays the same key: no device read in a step or boundary
    rows = BATCH // shape["data"]
    block = slice(data_index(mesh) * rows, (data_index(mesh) + 1) * rows)
    _, reads = sync_checked(lambda: model.generate_from_emb(
        local_tree(tp), tuple(x[block] for x in enc),
        model_group=mesh.get_group("model"), **kw))
    whole = call(params, None, greedy=True)
    share = (greedy[1]["chosen"] == whole["chosen"]).all(dim=1).float()
    share = share.mean().item()
    word = ("ancestry_attention_update", "grouped_cross_attention",
            "fused_topk_gumbel_sample")
    missing = [k for k in word if launches[k] < 1]
    extra = [k for k, v in launches.items() if v and k not in word]
    keys = [(k["graphs"], k["collective"], k["replays"]) for k in info]
    log(f"  tp_generate over {shape}, batch {BATCH}: captured (the first "
        f"call {first_s:.2f} s, keys {keys}) bit-equal to eager, sampled "
        f"and greedy: {same}; launches per call equal: "
        f"{counts[0] == counts[1]} ({launches}); twins on the card "
        f"{sorted(set(hits))}; no device read in the rank's decode "
        f"({reads} host_read calls); greedy token-equal to one card's call "
        f"on {share:.4f} of items (>= {TP_GREEDY_SHARE})")
    if (missing or extra or hits or not same or counts[0] != counts[1]
            or share < TP_GREEDY_SHARE
            or [k["collective"] for k in info] != [True]):
        raise AssertionError(f"tp_generate over the cards: not launched "
                             f"{missing}, off the path {extra}, twins "
                             f"{sorted(set(hits))}, captured equal {same}, "
                             f"launches {counts}, greedy share {share}, "
                             f"keys {keys}")
    # in turns: one card's captured call, tp_generate eager and captured
    secs = {"plain": [], "tp_generate_eager": [], "tp_generate": []}
    for i, label in enumerate(
            ("plain", "tp_generate_eager", "tp_generate", "tp_generate",
             "tp_generate_eager", "plain") * 2):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(params if label == "plain" else tp,
             False if label == "tp_generate_eager" else None, seed=30 + i)
        torch.cuda.synchronize()
        secs[label].append((time.perf_counter() - t0) * 1e3)
    out.update(greedy_share=share, generate_ms=secs, first_call_s=first_s,
               host_reads=reads)
    log(f"  sampled call, batch {BATCH} ({name_limit}): tp_generate "
        f"captured {[round(x, 1) for x in secs['tp_generate']]} ms, eager "
        f"{[round(x, 1) for x in secs['tp_generate_eager']]} ms, one card's "
        f"captured generate_from_emb {[round(x, 1) for x in secs['plain']]}"
        f" ms")
    del tp, enc, eager, captured, again, greedy, whole
    graphs.clear()

    tmodel = CaptioningTransformer(num_tokens=VOCAB, hid_dim=HID,
                                   n_layers=LAYERS, n_heads=HEADS,
                                   pf_dim=PF, max_len=50)
    ds, _ = memory_set(T_BATCH * P_STEPS, T_TEMPLATES, VOCAB, 11)
    rows = {f"t{i:03d}": i for i in range(T_TEMPLATES)}
    loader = list(BatchIterator(ds, T_BATCH, max_caption_len=T_CAP + 1,
                                seed=0, image_rows=rows))[:P_STEPS]
    cache = torch.randn(T_TEMPLATES, 7, 7, 2048, device=dev,
                        generator=torch.Generator(dev).manual_seed(12))
    dp = make_mesh("cuda")
    runs = {}
    for label, m, compiled in (
            ("one_card", None, None), ("dp", dp, None),
            ("dp_eager", dp, False), ("dp_x_tp", mesh, None),
            ("dp_x_tp_eager", mesh, False)):
        trainer = Trainer(tmodel, f"tp_{label}", log_dir=logdir,
                          compute_dtype="bfloat16", device=dev,
                          log_flush_every=1, compiled=compiled)
        state = trainer.init_state(torch.Generator(dev).manual_seed(0))
        if m is dp:
            state = replicate(state, m)
        elif m is mesh:
            state = place_train_state(state, m)
        trainer._trunk_cache = cache
        runs[label] = [trainer, state, m, torch.Generator(dev).manual_seed(13),
                       [], [], compiled]
    # in turns, one epoch of P_STEPS steps each: the order, then back
    order = list(runs)
    for rnd, labels in enumerate((order, order[::-1])):
        for label in labels:
            r = runs[label]
            trainer, state, m, gen, ms, seen, compiled = r
            rec, close = recorded_all_reduce()
            dist.barrier()
            try:
                r[1], step_ms, _, _ = train_epoch_timed(
                    trainer, state, loader, gen, m, no_sync=compiled is None)
            finally:
                close()
            # the key's first step (round 0's first) holds its capture
            ms += step_ms[P_WARM:] if rnd == 0 else step_ms
            seen.append(sorted(rec))
        if rnd == 0:
            for label in ("dp", "dp_x_tp"):
                gap = state_gap(runs[label][1], runs[label + "_eager"][1])
                same = runs[label][5] == runs[label + "_eager"][5]
                log(f"  {label} captured vs eager after {P_STEPS} steps: "
                    f"parameters and moments differ by at most {gap}; the "
                    f"same all-reduces: {same}")
                if gap or not same:
                    raise AssertionError(f"{label}: the captured step "
                                         f"differs from the eager one")
    out["train"] = {}
    for label, (trainer, state, m, _, ms, seen, compiled) in runs.items():
        keys = [(k["kind"], k["replays"], k["capture_s"])
                for k in trainer._graphs.info()]
        med = float(np.median(ms))
        out["train"][label] = {"step_ms": ms, "step_ms_median": med,
                               "keys": keys, "all_reduces": len(seen[0])}
        where = (dict(zip(m.mesh_dim_names, m.shape)) if m is not None
                 else "one card, the whole batch")
        log(f"  word train, bf16, batch {T_BATCH}, {label} over {where} "
            f"({name_limit}): median step {med:.2f} ms of {len(ms)} steps "
            f"in two turns (all: {[round(x, 2) for x in ms]}); keys {keys}; "
            f"{len(seen[0])} all-reduces an epoch")
        if compiled is None and len(keys) != 1:
            raise AssertionError(f"{label}: train keys {keys}")
        trainer.close()
    del runs, trainer, state
    return launches, out


def mesh_ranks(tp_only=False):
    """``--mesh-ranks``, one process per card under ``torchrun``: [14]'s
    data N/2 x model 2 part, then [13]'s checks and timings over every
    rank (module docstring); ``--mesh-ranks tp`` runs the [14] part
    alone. Rank 0 builds the kernels while the others wait, then prints
    the phases' numbers. Each phase has MESH_PHASE_S seconds: a replayed
    collective is out of the process group's watchdog, so a rank that
    hangs in one dumps its stack and exits, which ends the run."""
    import faulthandler

    import torch.distributed as dist

    from deephumor_tpu_torch.models import CaptioningTransformer, graphs
    from deephumor_tpu_torch.ops import _build
    from deephumor_tpu_torch.ops import attention as A
    from deephumor_tpu_torch.ops import cache as C
    from deephumor_tpu_torch.ops import engine as E
    from deephumor_tpu_torch.ops import sampler as S
    from deephumor_tpu_torch.parallel import make_mesh
    from deephumor_tpu_torch.utils.pytree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    make_mesh("cuda")
    if dist.get_rank() == 0:
        _build.library()
    dist.barrier(device_ids=[torch.cuda.current_device()])
    _build.library()
    dev = torch.device("cuda", torch.cuda.current_device())
    name_limit = card()
    log("cards: " + " | ".join(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()))
    log(f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()} | "
        f"nvidia-smi: {name_limit} | torch {torch.__version__}")
    # the link between the cards (NVLink or PCIe) sets the all-reduces'
    # share of a step
    for args in (["topo", "-m"], ["nvlink", "--status"]):
        res = subprocess.run(["nvidia-smi", *args], capture_output=True,
                             text=True, timeout=60)
        log(f"nvidia-smi {' '.join(args)} (exit {res.returncode}):\n"
            + (res.stdout + res.stderr).rstrip())
    n = torch.cuda.device_count()
    log("peer access between the cards (torch): " + str(
        [[i == j or torch.cuda.can_device_access_peer(i, j)
          for j in range(n)] for i in range(n)]))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as logdir:
        log(f"[14] tensor parallel over {dist.get_world_size()} ranks, one "
            f"per card: tp_generate and the DP x TP train step")
        faulthandler.dump_traceback_later(MESH_PHASE_S, exit=True)
        tp_launches, tp = check_tp_mesh(CaptioningTransformer, _build,
                                        (A, C, E, S), dev, name_limit, logdir)
        tp.update(launches=tp_launches, card=name_limit,
                  seconds=time.perf_counter() - t0)
        log("tensor parallel: " + json.dumps(tp))
        faulthandler.cancel_dump_traceback_later()
        if tp_only:
            gc.collect()
            graphs.clear()
            dist.destroy_process_group()
            return
        log(f"[13] parallel over {dist.get_world_size()} ranks, one per "
            f"card")
        t0 = time.perf_counter()
        faulthandler.dump_traceback_later(MESH_PHASE_S, exit=True)
        launches, serving, out = check_parallel(
            CaptioningTransformer, tree_map, _build, (A, C, E, S), dev,
            name_limit, logdir)
        faulthandler.cancel_dump_traceback_later()
    out.update(launches=launches, serving_launches=serving, card=name_limit,
               seconds=time.perf_counter() - t0)
    log("parallel: " + json.dumps(out))


def cold_build():
    """``--cold-build``: two batchers' first calls, made together in this
    cold process, over a small model on the card, with the kernel library
    built into a fresh directory. Prints one JSON line: the nvcc runs,
    the library loads, and when each thread first asked for the library
    (seconds from the start of the build)."""
    import ctypes
    import shutil

    from deephumor_tpu_torch.data import Vocab
    from deephumor_tpu_torch.models import CaptioningTransformer
    from deephumor_tpu_torch.ops import _build
    from deephumor_tpu_torch.pipeline import MemeGenerationPipeline
    from deephumor_tpu_torch.serving import DynamicBatcher

    dev = torch.device("cuda", 0)
    _build.BUILD_DIR = _build.BUILD_DIR / f"cold-{os.getpid()}"
    runs, loads, first = [], [], {}
    run_all, library, cdll = _build._run_all, _build.library, ctypes.CDLL

    def counted_run_all(cmds, log_):
        start = time.perf_counter()
        run_all(cmds, log_)
        runs.append(("link" if "-shared" in cmds[0] else "compile", start,
                     time.perf_counter()))

    def recorded_library():
        first.setdefault(threading.get_ident(), time.perf_counter())
        return library()

    def counted_cdll(name, *args, **kwargs):
        if "libdh_kernels" in str(name):  # torch loads libraries too
            loads.append(name)
        return cdll(name, *args, **kwargs)

    _build._run_all, _build.library = counted_run_all, recorded_library
    ctypes.CDLL = counted_cdll
    try:
        vocab = Vocab([f"word{i}" for i in range(58)])
        model = CaptioningTransformer(num_tokens=len(vocab), hid_dim=64,
                                      n_layers=1, n_heads=4, pf_dim=128,
                                      max_len=18, compute_dtype="bfloat16")
        params = model.init(torch.Generator(dev).manual_seed(0), dev)
        pipe = MemeGenerationPipeline(model, params, vocab)
        pipe.add_templates(["a", "b"], torch.randn(
            2, 64, 64, 3, device=dev,
            generator=torch.Generator(dev).manual_seed(1)))
        # eager: a key's first captured call holds the capture lock, so
        # two captured first calls never ask for the library at once
        kw = dict(max_len=8, beam_size=2, top_k=8, sampler="pallas",
                  compiled=False)
        barrier, texts = threading.Barrier(2), []
        with DynamicBatcher(pipe, max_batch=4, seed=0, **kw) as one, \
                DynamicBatcher(pipe, max_batch=4, seed=1, **kw) as two:
            def request(srv, tid):
                barrier.wait()
                texts.append(srv.submit(tid).result(timeout=600))

            threads = [threading.Thread(target=request, args=a)
                       for a in ((one, "a"), (two, "b"))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
    finally:
        ctypes.CDLL = cdll
        shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    start = min((r[1] for r in runs), default=0.0)
    end = max((r[2] for r in runs), default=0.0)
    print(json.dumps({
        "compile_runs": sum(r[0] == "compile" for r in runs),
        "link_runs": sum(r[0] == "link" for r in runs),
        "loads": len(loads), "answers": len(texts),
        "first_calls_s": sorted(t - start for t in first.values()),
        "build_s": end - start}), flush=True)


def check_cold_build():
    """Runs ``--cold-build`` in a subprocess and checks its line: one
    compile run, one link, one load, and both batchers' threads asked for
    the library before the build had ended."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--cold-build"],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"cold build phase failed:\n"
                             f"{proc.stderr[-4000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"  cold process, two batchers' first calls together: {got}")
    if not (got["compile_runs"] == got["link_runs"] == got["loads"] == 1
            and got["answers"] == 2 and len(got["first_calls_s"]) == 2
            and max(got["first_calls_s"]) < got["build_s"]):
        raise AssertionError("cold build: the library was not built once "
                             "for two threads that asked at once")


# -- [15] the product surface ------------------------------------------------
def synthetic_words(rng, n, taken=()):
    """``n`` distinct random lowercase words of 2-9 letters, none in
    ``taken``."""
    words, seen = [], set(taken)
    while len(words) < n:
        lens = rng.integers(2, 10, 2 * (n - len(words)) + 16).tolist()
        text = (rng.integers(0, 26, sum(lens), dtype=np.uint8)
                + ord("a")).tobytes().decode()
        pos = 0
        for length in lens:
            word, pos = text[pos:pos + length], pos + length
            if word not in seen and len(words) < n:
                seen.add(word)
                words.append(word)
    return words


def memes_split(root, seed):
    """Writes a memes900k-shaped dataset under ``root``: X_TEMPLATES
    templates (no image files: the split is read without them) and
    ``captions_train.txt`` with X_CAPTIONS captions each, ``top <sep>
    bottom`` of 4 tokens and a geometric tail (mean 14, a few past
    X_CAP_LEN) drawn by a power law over the word vocabulary (VOCAB tokens
    with punctuation runs, in random rank order), 3% out of it, 30% of the
    captions upper-case. Returns the vocabulary and the captions."""
    from deephumor_tpu_torch.data import Vocab

    rng = np.random.default_rng(seed)
    punct = ["!", "?", ",", ".", "...", "!!!", "?!"]
    vocab = Vocab(synthetic_words(rng, VOCAB - 6 - len(punct)) + punct)
    assert len(vocab) == VOCAB
    known = vocab.tokens[6:]
    pool = np.array(known + synthetic_words(rng, 2000, known), dtype=object)
    n = X_TEMPLATES * X_CAPTIONS
    lens = 3 + rng.geometric(0.09, n)
    total = int(lens.sum())
    cdf = np.cumsum(1.0 / np.arange(1, len(known) + 1) ** 1.1)
    rank = np.searchsorted(cdf, rng.random(total) * cdf[-1])
    idx = np.where(rng.random(total) < 0.03,
                   len(known) + rng.integers(0, 2000, total),
                   rng.permutation(len(known))[rank])
    # every token followed by its glue: a space, " <sep> " after the top
    # half's last token, a newline after the caption's last
    ends = np.cumsum(lens)
    glue = np.full(total, " ", dtype=object)
    glue[ends - lens + rng.integers(0, lens - 1)] = " <sep> "
    glue[ends - 1] = "\n"
    pieces = np.empty(2 * total, dtype=object)
    pieces[0::2], pieces[1::2] = pool[idx], glue
    captions = "".join(pieces.tolist()).split("\n")[:-1]
    for i in np.flatnonzero(rng.random(n) < 0.3).tolist():
        captions[i] = captions[i].upper()
    labels = [f"{known[a].title()} {known[b].title()} {i}" for i, (a, b)
              in enumerate(rng.integers(0, len(known) // 8,
                                        (X_TEMPLATES, 2)).tolist())]
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    with open(os.path.join(root, "templates.txt"), "w") as f:
        f.writelines(f"{label}\tlink\thttp://x/{i}.jpg\n"
                     for i, label in enumerate(labels))
    scores = rng.integers(0, 10000, n).tolist()
    with open(os.path.join(root, "captions_train.txt"), "w") as f:
        f.writelines(f"{labels[i // X_CAPTIONS]}\t{scores[i]}\t{c}\n"
                     for i, c in enumerate(captions))
    return vocab, captions


def check_texts(texts, vocab, tokenizer, where):
    """Generated texts: every token in the vocabulary, no UNK (an empty
    text is a caption that ended at its first token)."""
    for text in texts:
        tokens = tokenizer.tokenize(text)
        if any(t not in vocab.stoi for t in tokens) or "<unk>" in tokens:
            raise AssertionError(f"{where}: bad caption {text!r}")


def check_native(tmp, seed):
    """The text core: built on this host, ``materialize`` of the
    memes900k-shaped split through it, and its ids equal to the Python
    path's on a word and a char sample. Returns the host rates and the
    split's vocabulary."""
    from deephumor_tpu_torch import native
    from deephumor_tpu_torch.data import (EOS_ID, UNK_ID, CharTokenizer,
                                          MemeDataset, Vocab,
                                          WordPunctTokenizer)

    if shutil.which("g++") is None:
        raise AssertionError("[15] native: no g++ on this host, so the text "
                             "core cannot be built (materialize would run "
                             "in Python)")
    # built here from the checkout's source, whatever the build directory
    # already holds
    t0 = time.perf_counter()
    if not (native.build(force=True) and native.available(autobuild=False)):
        raise AssertionError("[15] native: the text core did not build")
    build_s = time.perf_counter() - t0
    so = native._library_path(native.SOURCE, native.BUILD_DIR)
    log(f"  text core built and loaded in {build_s:.2f} s -> {so}")
    t0 = time.perf_counter()
    vocab, captions = memes_split(tmp, seed)
    ds = MemeDataset(tmp, vocab, split="train", num_classes=X_TEMPLATES,
                     preload_images=False)
    log(f"  split of {len(ds)} captions over {len(ds.templates)} templates "
        f"(V {len(vocab)}) written and read in "
        f"{time.perf_counter() - t0:.1f} s")
    if len(ds) != X_TEMPLATES * X_CAPTIONS:
        raise AssertionError(f"[15] native: the split has {len(ds)} captions")
    t0 = time.perf_counter()
    mat = ds.materialize(X_CAP_LEN, X_LAB_LEN)
    mat_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 1)
    sel = np.sort(rng.choice(len(captions), X_SAMPLE, replace=False))
    sample = [captions[i] for i in sel]
    out = {"build_s": build_s, "materialize_s": mat_s,
           "materialize_captions_per_s": len(ds) / mat_s}
    results = {}
    for mode, tok, v, n, length in (
            ("word", WordPunctTokenizer(), vocab, X_SAMPLE, X_CAP_LEN),
            ("char", CharTokenizer(), None, X_CHAR_SAMPLE, X_CHAR_LEN)):
        texts = sample[:n]
        if v is None:  # the sample's characters less two, which become UNK
            chars = sorted({c for t in texts for c in t.lower()} - set("qz"))
            v = Vocab(chars)
        t0 = time.perf_counter()
        got = native.encode_batch(texts, v, mode, length)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = native._python_encode([t.lower() for t in texts], v, tok,
                                     length, UNK_ID, EOS_ID, True, 0)
        python_s = time.perf_counter() - t0
        for g, w, what in zip(got, want, ("ids", "lengths")):
            if not np.array_equal(g, w):
                rows = np.flatnonzero((g != w).reshape(len(texts), -1)
                                      .any(axis=1))
                raise AssertionError(f"[15] native {mode}: {what} differ from "
                                     f"the Python path in {len(rows)} rows, "
                                     f"first {texts[rows[0]]!r}")
        results[mode] = got[0]
        unk = float((got[0] == UNK_ID).any(axis=1).mean())
        trunc = float((got[1] == length).mean())
        out[f"{mode}_native_captions_per_s"] = n / native_s
        out[f"{mode}_python_captions_per_s"] = n / python_s
        log(f"  {mode}, {n} captions, max_len {length}: ids and lengths "
            f"equal to the Python path (rows with UNK {unk:.3f}, cut at "
            f"max_len {trunc:.3f}); C++ {n / native_s:,.0f} captions/s, "
            f"Python {n / python_s:,.0f} captions/s ("
            f"{python_s / native_s:.1f}x; host clock)")
    if not np.array_equal(mat["captions"][sel], results["word"]):
        raise AssertionError("[15] native: materialize differs from "
                             "encode_batch on the sample")
    log(f"  materialize: {len(ds)} captions + {len(ds.templates)} labels in "
        f"{mat_s:.2f} s ({len(ds) / mat_s:,.0f} captions/s, host clock); "
        f"its sample rows equal the Python path's")
    return out, vocab


def check_product_kernels(S, dev, gen):
    """K3 and K4 at X_SHAPES, each against its twin and timed beside it,
    bf16. K3 at the sweep's first draw, [256, 2006] (and at K4's 1,280
    rows), and the demo's word leg, [64, 506]; K4 at every shape (x [items
    * beam, D], W [V, D]), timed beside the unfused route (bf16 F.linear,
    then K3) and F.linear alone. K4 past V 256 runs the streamed path; the
    char leg (V 37) the resident one. Returns {kernel: {path: numbers}}."""
    bf = torch.bfloat16
    out = {"fused_topk_gumbel_sample": {},
           "fused_classifier_topk_gumbel_sample": {}}
    for path, items, beam, top_k, vocab, d, inv_t in X_SHAPES:
        rows = items * beam
        if path in ("sweep", "demo_word"):  # K3 plants ties across 40 logits
            r = check_k3(S, dev, gen, rows=items, vocab=vocab, top_k=top_k,
                         draws=beam, inv_t=inv_t, label=f"K3 {path}")
            out["fused_topk_gumbel_sample"][path] = {
                k: r[k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")}
        if path == "sweep":
            check_k3(S, dev, gen, rows=rows, vocab=vocab, top_k=top_k,
                     draws=beam, inv_t=inv_t, label=f"K3 {path} rows {rows}",
                     timed=False)
        x, w, b = k4_inputs(dev, gen, d, rows, vocab)
        kw = dict(top_k=top_k, num_draws=beam)
        err = check_k4_draws(S, x, w, b, inv_t, (None, rows // 2),
                             f"K4 {path}", **kw)
        ms = cuda_ms(lambda: S.fused_classifier_topk_gumbel_sample(
            x, w, b, 7, inv_t, **kw), queued=True)
        plain_ms = cuda_ms(lambda: S.fused_classifier_topk_gumbel_sample_plain(
            x, w, b, 7, inv_t, **kw), iters=2, warmup=1)
        # the unfused route (bf16 F.linear, then K3) and F.linear alone:
        # partial yardsticks
        linear_k3_ms = cuda_ms(lambda: S.fused_topk_gumbel_sample(
            torch.nn.functional.linear(x, w, b.to(bf)), 7, inv_t, **kw),
            queued=True)
        linear_ms = cuda_ms(lambda: torch.nn.functional.linear(
            x, w, b.to(bf)), queued=True)
        r = dict(ms=ms, plain_ms=plain_ms, linear_k3_ms=linear_k3_ms,
                 linear_ms=linear_ms, max_abs_err=err,
                 **bound(k4_bytes(rows, d, rows, vocab, beam),
                         2 * rows * vocab * d, bf))
        out["fused_classifier_topk_gumbel_sample"][path] = r
        log(f"  K4 {path} x [{rows}, {d}] W [{vocab}, {d}], top_k {top_k}, "
            f"draws {beam}: {ms:.4f} ms (device alone), twin {plain_ms:.4f} "
            f"ms, F.linear + K3 {linear_k3_ms:.4f} ms, F.linear alone "
            f"{linear_ms:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), max|vals-twin| {err:.3e}")
    return out


def reference_state_dict(params):
    """The reference's ``state_dict`` of a CaptioningTransformer's
    parameters: the port's names with the ResNet's ``nn.Sequential``
    indices (the layout that convert/torch_import.py reads)."""
    import re

    from deephumor_tpu_torch.utils.pytree import flatten_tree

    sd = {}
    for key, t in flatten_tree(params).items():
        key = re.sub(r"^encoder/resnet/conv1/", "encoder/resnet/0/", key)
        key = re.sub(r"^encoder/resnet/bn1/", "encoder/resnet/1/", key)
        key = re.sub(r"^encoder/resnet/layer(\d)/",
                     lambda m: f"encoder/resnet/{3 + int(m.group(1))}/", key)
        key = key.replace("/downsample/conv/", "/downsample/0/")
        key = key.replace("/downsample/bn/", "/downsample/1/")
        sd[key.replace("/", ".")] = t.detach().cpu().clone()
    return sd


def check_generate_meme(CaptioningTransformer, _build, dev, vocab, tmp,
                        seed):
    """``generate_meme``: a reference-layout ``.pth`` of the word width
    (f32, random weights from ``seed``) loaded with ``from_torch`` on the
    card equals the weights written; ``caption_image`` greedy (beam 1) on
    a seeded image, without and with a starting caption, gives the CPU's
    text exactly. Returns the card calls' launches."""
    from deephumor_tpu_torch.generate_meme import caption_image
    from deephumor_tpu_torch.utils.pytree import flatten_tree

    model = CaptioningTransformer(num_tokens=VOCAB, hid_dim=HID,
                                  n_layers=LAYERS, n_heads=HEADS, pf_dim=PF,
                                  max_len=MAX_LEN + 2)
    params = model.init(torch.Generator(dev).manual_seed(seed), dev)
    path = os.path.join(tmp, "TransformerDecoderWords.best.pth")
    torch.save({"model": reference_state_dict(params), "hp": model.hp()},
               path)
    m_card, p_card = CaptioningTransformer.from_torch(path, device=dev)
    m_cpu, p_cpu = CaptioningTransformer.from_torch(path, device="cpu")
    written, loaded = flatten_tree(params), flatten_tree(p_card)
    if m_card != model or loaded.keys() != written.keys() or any(
            not same_leaf(loaded[k], w) for k, w in written.items()):
        raise AssertionError("[15] generate_meme: from_torch of the .pth "
                             "does not give the weights written")
    image = torch.randn(1, 224, 224, 3, device=dev,
                        generator=torch.Generator(dev).manual_seed(seed + 1))
    start = " ".join(vocab.tokens[6:9])
    kw = dict(greedy=True, beam_size=1)
    _build.reset_launch_counts()
    texts = [caption_image(m_card, p_card, image, vocab, "word", caption=c,
                           **kw) for c in (None, start)]
    launches = dict(_build.LAUNCHES)
    for c, got in zip((None, start), texts):
        want = caption_image(m_cpu, p_cpu, image.cpu(), vocab, "word",
                             caption=c, **kw)
        what = f"from {start!r}" if c else "from the image"
        if got != want:
            raise AssertionError(f"[15] generate_meme {what}: card {got!r} "
                                 f"!= CPU {want!r}")
        log(f"  caption {what}: card == CPU ({got[0][:48]!r}...)")
    if not (launches["ancestry_attention_update"]
            and launches["grouped_cross_attention"]):
        raise AssertionError(f"[15] generate_meme: launches {launches}")
    return launches


def check_demo(_build, modules, dev, seed):
    """``demo.demo_captions``: the four architectures at the notebook's
    settings on X_DEMO_ITEMS seeded images, word then char, with the
    sampler kernels. Returns each mode's launches."""
    from deephumor_tpu_torch import demo
    from deephumor_tpu_torch.data import CharTokenizer, WordPunctTokenizer

    images = torch.randn(X_DEMO_ITEMS, 224, 224, 3, device=dev,
                         generator=torch.Generator(dev).manual_seed(seed))
    want = {"word": ("ancestry_attention_update", "grouped_cross_attention",
                     "fused_topk_gumbel_sample",
                     "fused_classifier_topk_gumbel_sample"),
            "char": ("ancestry_attention_update", "grouped_cross_attention",
                     "fused_topk_gumbel_sample",
                     "fused_classifier_topk_gumbel_sample",
                     "ancestry_attention_update_canon",
                     "ancestry_attention_ids")}
    legs = {}
    for mode, tok in (("word", WordPunctTokenizer()),
                      ("char", CharTokenizer())):
        vocab = demo.synthetic_vocab(mode)
        hits, restore = twin_guard(modules)
        try:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            res = demo.demo_captions(images, {mode: vocab}, synthetic=True,
                                     device=dev)
            secs = time.perf_counter() - t0
            launches = legs[f"product_demo_{mode}"] = dict(_build.LAUNCHES)
        finally:
            restore()
        types = [r["model_type"] for r in res]
        for r in res:
            check_texts([c[0] for c in r["captions"]], vocab, tok,
                        f"[15] demo {mode} {r['model_type']}")
        log(f"  demo {mode}: {types} on {X_DEMO_ITEMS} images in {secs:.2f} "
            f"s; first captions {[r['captions'][0][0][:24] for r in res]}; "
            f"launches {launches}")
        missing = [k for k in want[mode] if not launches[k]]
        extra = [k for k, v in launches.items() if v and k not in want[mode]]
        if len(types) != 4 or missing or extra or hits:
            raise AssertionError(f"[15] demo {mode}: models {types}, kernels "
                                 f"not launched {missing}, off the path "
                                 f"{extra}, twins on the card {hits}")
    return legs


def same_leaf(got, want):
    """Bit-equal tensors (dtype and device too), or equal values."""
    if isinstance(want, torch.Tensor):
        return (isinstance(got, torch.Tensor) and got.dtype == want.dtype
                and got.device == want.device and torch.equal(got, want))
    return got == want


def check_config_checkpoint(CaptioningTransformer, dev, tmp, seed):
    """An ExperimentConfig through JSON builds the word model; a word
    Trainer state on the card (moments and counts past their initial
    values) through ``save_state`` / ``restore_state`` comes back bit-equal,
    onto its template and whole without one."""
    from deephumor_tpu_torch.experiments.trainer import Trainer
    from deephumor_tpu_torch.utils.checkpoint import (latest_step,
                                                      restore_state,
                                                      save_state)
    from deephumor_tpu_torch.utils.config import (ExperimentConfig,
                                                  SamplingConfig)
    from deephumor_tpu_torch.utils.pytree import flatten_tree

    model = CaptioningTransformer(num_tokens=VOCAB, hid_dim=HID,
                                  n_layers=LAYERS, n_heads=HEADS, pf_dim=PF,
                                  max_len=MAX_LEN + 2,
                                  compute_dtype="bfloat16")
    cfg = ExperimentConfig.from_model(
        model, sampling=SamplingConfig.word_default(), title="chip_smoke")
    cfg.save(os.path.join(tmp, "config.json"))
    back = ExperimentConfig.load(os.path.join(tmp, "config.json"))
    if back != cfg or back.build_model() != model:
        raise AssertionError("[15] config: the JSON round trip changed it")
    trainer = Trainer(back.build_model(), "product", log_dir=tmp, device=dev)
    g = torch.Generator(dev).manual_seed(seed)
    state = trainer.init_state(g)
    for name in ("mu", "nu"):
        for t in state["opt_state"][name].values():
            t.normal_(generator=g)
    state["opt_state"]["count"] = state["step"] = 3
    ckpt = os.path.join(tmp, "state")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_state(ckpt, state, 3)
    save_s = time.perf_counter() - t0
    if latest_step(ckpt) != 3:
        raise AssertionError(f"[15] checkpoint: latest_step "
                             f"{latest_step(ckpt)}")
    t0 = time.perf_counter()
    onto, step = restore_state(ckpt, template=state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    whole, _ = restore_state(ckpt, device=dev)
    want = flatten_tree(state)
    nbytes = sum(t.numel() * t.element_size() for t in want.values()
                 if isinstance(t, torch.Tensor))
    for label, got in (("onto the template", onto), ("whole", whole)):
        got = flatten_tree(got)
        bad = [k for k, w in want.items() if not same_leaf(got.get(k), w)]
        if step != 3 or got.keys() != want.keys() or bad:
            raise AssertionError(f"[15] checkpoint {label}: step {step}, "
                                 f"leaves that differ {bad[:5]}")
    log(f"  config: ExperimentConfig -> JSON -> build_model() == the word "
        f"model; checkpoint: {len(want)} leaves, {nbytes / 2 ** 20:.0f} MiB, "
        f"save_state {save_s:.2f} s, restore_state onto the template "
        f"{restore_s:.2f} s, bit-equal (and whole without one), "
        f"latest_step 3")
    return {"state_mib": nbytes / 2 ** 20, "save_s": save_s,
            "restore_s": restore_s}


def product_phase(CaptioningTransformer, _build, modules, dev, name_limit):
    """[15]: the native scanner behind ``materialize``, the 300-template
    sweep (the phase's main path), ``generate_meme`` from a ``.pth``, the
    demo's four architectures, and the config and checkpoint round trips.
    Returns the launches of each path and the phase's numbers."""
    from deephumor_tpu_torch import sweep
    from deephumor_tpu_torch.data import WordPunctTokenizer

    log(f"[15] product surface: the text core on a {X_TEMPLATES} x "
        f"{X_CAPTIONS} train split; K3 and K4 vs their twins at the sweep's "
        f"and the demo's shapes; sweep --synthetic (300 templates x 10 "
        f"captions, beam 5, len 32, top_k 64, batch 256); generate_meme "
        f"from a .pth; the demo's four models; config and checkpoint")
    t_phase = time.perf_counter()
    legs = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        numbers, vocab = check_native(os.path.join(tmp, "memes"), 15)
        numbers["kernels"] = check_product_kernels(
            modules[-1], dev, torch.Generator(dev).manual_seed(15))

        hits, restore = twin_guard(modules)
        try:
            _build.reset_launch_counts()
            res = sweep.main(["--synthetic"])
            launches = legs["product_sweep"] = dict(_build.LAUNCHES)
        finally:
            restore()
        sweep_vocab = res.pop("vocab")
        outputs = res.pop("outputs")
        check_texts([text for _, text in outputs], sweep_vocab,
                    WordPunctTokenizer(), "[15] sweep")
        # at V 2,006 each decode step's classifier and draw run in K4
        # (up to FUSED_CLASSIFIER_MAX_V), the first draw in K3
        path = ("ancestry_attention_update", "grouped_cross_attention",
                "fused_topk_gumbel_sample",
                "fused_classifier_topk_gumbel_sample")
        missing = [k for k in path if not launches[k]]
        extra = [k for k, v in launches.items() if v and k not in path]
        log(f"  sweep: {res['captions']} captions over {res['templates']} "
            f"templates, encode {res['encode_s']:.2f} s, "
            f"{res['captions_per_s']:.1f} captions/s, first call "
            f"{res['first_call_s']:.2f} s, steady state "
            f"{res['steady_captions_per_s']:.1f} captions/s ({name_limit}); "
            f"launches {launches}")
        if (len(outputs) != res["templates"] * 10 or missing or extra
                or hits):
            raise AssertionError(f"[15] sweep: {len(outputs)} captions, "
                                 f"kernels not launched {missing}, off the "
                                 f"path {extra}, twins on the card {hits}")
        numbers["sweep"] = res

        legs["product_meme"] = check_generate_meme(
            CaptioningTransformer, _build, dev, vocab, tmp, 15)
        legs.update(check_demo(_build, modules, dev, 15))
        numbers["checkpoint"] = check_config_checkpoint(
            CaptioningTransformer, dev, tmp, 15)
    numbers["phase_s"] = time.perf_counter() - t_phase
    log(f"    product phase {numbers['phase_s']:.1f} s")
    return legs, numbers


def product_only():
    """``--product``: builds the kernels and runs [15] alone; prints its
    numbers and launches as one JSON line."""
    from deephumor_tpu_torch.models import CaptioningTransformer
    from deephumor_tpu_torch.ops import _build
    from deephumor_tpu_torch.ops import attention as A
    from deephumor_tpu_torch.ops import cache as C
    from deephumor_tpu_torch.ops import engine as E
    from deephumor_tpu_torch.ops import sampler as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    legs, numbers = product_phase(CaptioningTransformer, _build,
                                  (A, C, E, S), torch.device("cuda", 0),
                                  card())
    print(json.dumps({"product": numbers, "launches": legs}), flush=True)


# -- [16] compiled generation ------------------------------------------------
def sync_checked(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: any op
    that waits for the device raises, except in ``sampling.host_read``,
    through which a call makes its reads on purpose (``ended.all()``
    between graphs or between eager steps, and the boundaries' counts
    once after the last graph). Returns ``fn()`` and the number of those
    reads."""
    from deephumor_tpu_torch.models import sampling

    real, reads = sampling.host_read, [0]

    def allowed(t):
        reads[0] += 1
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real(t)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    sampling.host_read = allowed
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(), reads[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
        sampling.host_read = real


def same_outputs(a, b, keys=("sequences", "scores", "chosen", "ended")):
    return all(torch.equal(a[k], b[k]) for k in keys)


def idle_share(fn):
    """torch.profiler over one call: (wall ms, device kernel ms, idle
    share)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.device_time_total for e in prof.key_averages()
               if getattr(e, "device_time_total", 0) > 0
               and e.device_type.name == "CUDA") / 1e3
    return wall, busy, 1 - busy / wall


def compare_compiled(model, params, enc, kw, _build, graphs, label,
                     name_limit, calls=G_CALLS, path_kernels=(), images=None,
                     tag="[16]"):
    """One path captured beside eager (``compiled=False``) from the same
    inputs and generator seed (``images``: ``generate`` from these
    positional inputs, the images and, for the labelled LSTM, the labels,
    the encoder inside the prefill's graph; else ``generate_from_emb`` of
    ``enc``): outputs bit-equal (sampled and greedy),
    boundaries equal, launches per call equal (and each of
    ``path_kernels`` launched), no part of the call eager (every segment
    and boundary a graph), the first captured call's warm-up and capture
    time and the memory its key holds (within ``graphs.MAX_SHARE`` of the
    card), captions/s (median of ``calls`` calls of each, in turns after
    warm-up), the idle share of one profiled call of each, and one call
    of each under the sync debug mode (the reads through
    ``sampling.host_read`` counted). Returns the path's numbers."""
    first = batch(enc) if images is None else images[0]
    n, dev = first.shape[0], first.device

    def call(compiled, seed=5, **extra):
        kwargs = dict(generator=torch.Generator(dev).manual_seed(seed),
                      compiled=compiled, **dict(kw, **extra))
        if images is not None:
            return model.generate(params, *images, **kwargs)
        return model.generate_from_emb(params, enc, **kwargs)

    graphs.clear()
    eager = call(False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    captured = call(None)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    (info,) = graphs.cache_info()
    if info["eager_tail"]:
        raise AssertionError(f"{tag} {label}: part of the call runs eagerly "
                             f"after its graphs")
    budget = graphs.MAX_SHARE * torch.cuda.get_device_properties(
        dev).total_memory
    if info["bytes"] > budget:
        raise AssertionError(f"{tag} {label}: the key holds {info['bytes']} "
                             f"bytes, above MAX_SHARE of the card")
    again = call(None)
    if not (same_outputs(captured, eager) and same_outputs(again, eager)):
        raise AssertionError(f"{tag} {label}: captured outputs differ from "
                             f"the eager loop's at the same seed")
    if captured.get("boundaries") != eager.get("boundaries"):
        raise AssertionError(f"{tag} {label}: boundaries differ")
    greedy = [call(c, greedy=True) for c in (False, None)]
    if not same_outputs(*greedy):
        raise AssertionError(f"{tag} {label}: greedy captured differs from "
                             f"greedy eager")
    counts = []
    for compiled in (False, None):
        _build.reset_launch_counts()
        call(compiled)
        counts.append(dict(_build.LAUNCHES))
    if counts[0] != counts[1]:
        raise AssertionError(f"{tag} {label}: launches per call, eager "
                             f"{counts[0]} != captured {counts[1]}")
    missing = [k for k in path_kernels if not counts[1][k]]
    if missing:
        raise AssertionError(f"{tag} {label}: kernels not launched {missing}")
    secs = {False: [], None: []}
    for i in range(calls):
        for compiled in (False, None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(compiled, seed=10 + i)
            torch.cuda.synchronize()
            secs[compiled].append(time.perf_counter() - t0)
    rates = {c: n / float(np.median(s)) for c, s in secs.items()}
    idle = {c: idle_share(lambda c=c: call(c)) for c in (False, None)}
    reads = {c: sync_checked(lambda c=c: call(c))[1] for c in (False, None)}
    res = {
        "items": n, "captions_per_s": rates[None],
        "captions_per_s_eager": rates[False],
        "captions_per_s_calls": [n / s for s in secs[None]],
        "captions_per_s_eager_calls": [n / s for s in secs[False]],
        "idle_share": idle[None][2], "idle_share_eager": idle[False][2],
        "device_ms": idle[None][1], "device_ms_eager": idle[False][1],
        "wall_ms_profiled": idle[None][0],
        "wall_ms_profiled_eager": idle[False][0],
        "first_call_s": first_s, "capture_s": info["capture_s"],
        "key_bytes": info["bytes"], "graphs": info["graphs"],
        "captured_segments": info["captured_segments"],
        "captured_boundaries": info["captured_boundaries"],
        "eager_tail": info["eager_tail"],
        "host_reads": reads[None], "host_reads_eager": reads[False],
        "launches_per_call": counts[1],
        "card": name_limit}
    log(f"  {label}: {n} items; captured {rates[None]:.1f} captions/s, eager "
        f"{rates[False]:.1f} (median of {calls} calls each, in turns); idle "
        f"share {idle[None][2]:.3f} captured, {idle[False][2]:.3f} eager "
        f"(device {idle[None][1]:.1f} / {idle[False][1]:.1f} ms a call); "
        f"first call {first_s:.2f} s (warm-up and capture "
        f"{info['capture_s']:.2f} s, {info['graphs']} graphs: "
        f"{info['captured_segments']} segments, "
        f"{info['captured_boundaries']} boundaries, no eager tail), key "
        f"holds {info['bytes'] / 2 ** 20:.1f} MiB; sampled and greedy "
        f"outputs bit-equal, launches per call equal, no device read in a "
        f"step or boundary (sync debug mode; host_read calls: captured "
        f"{reads[None]}, eager {reads[False]}) | {name_limit}")
    graphs.clear()
    return res


def check_seed_forms(S, dev, gen):
    """K3 and K4 with the step's seed in device memory (a one-element
    int32 tensor, as a captured step passes it) against the int seed and
    the twin, at word's K3 rows and at the sweep's and char's K4 rows;
    both forms timed queued. Returns each kernel's numbers."""
    bf = torch.bfloat16
    out = {}
    seed_t = torch.tensor([12345], dtype=torch.int32, device=dev)
    logits = torch.randn(ROWS, VOCAB, generator=gen, device=dev).to(bf)
    kw = dict(top_k=TOP_K, num_draws=BEAM)
    got = S.fused_topk_gumbel_sample(logits, seed_t, 1.0, **kw)
    want = S.fused_topk_gumbel_sample(logits, 12345, 1.0, **kw)
    twin = S.fused_topk_gumbel_sample_plain(logits, seed_t, 1.0, **kw)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("[16] K3: a device seed draws otherwise than "
                             "the int seed")
    check_draws(got[0], twin[0], logits, TOP_K, "K3 device seed (word)")
    out["fused_topk_gumbel_sample"] = {
        "ms_seed_ptr": cuda_ms(lambda: S.fused_topk_gumbel_sample(
            logits, seed_t, 1.0, **kw), queued=True),
        "ms_seed_int": cuda_ms(lambda: S.fused_topk_gumbel_sample(
            logits, 12345, 1.0, **kw), queued=True)}
    del logits
    rows = {}
    for label, (x, w, b), kw, inv_t in (
            ("sweep", k4_inputs(dev, gen, HID, 256 * BEAM, 2006),
             dict(top_k=64, num_draws=BEAM), 1.0),
            ("char", k4_inputs(dev, gen), dict(top_k=C_TOP_K,
                                               num_draws=C_BEAM),
             1 / C_TEMP)):
        got = S.fused_classifier_topk_gumbel_sample(x, w, b, seed_t, inv_t,
                                                    **kw)
        want = S.fused_classifier_topk_gumbel_sample(x, w, b, 12345, inv_t,
                                                     **kw)
        twin = S.fused_classifier_topk_gumbel_sample_plain(x, w, b, seed_t,
                                                           inv_t, **kw)
        if not (torch.equal(got[0], want[0])
                and torch.equal(got[1], want[1])):
            raise AssertionError(f"[16] K4 {label}: a device seed draws "
                                 f"otherwise than the int seed")
        check_draws(got[0], twin[0], S.classifier_logits(x, w, b),
                    kw["top_k"], f"K4 device seed ({label})")
        rows[f"ms_seed_ptr_{label}"] = cuda_ms(
            lambda: S.fused_classifier_topk_gumbel_sample(
                x, w, b, seed_t, inv_t, **kw), queued=True)
        rows[f"ms_seed_int_{label}"] = cuda_ms(
            lambda: S.fused_classifier_topk_gumbel_sample(
                x, w, b, 12345, inv_t, **kw), queued=True)
    out["fused_classifier_topk_gumbel_sample"] = rows
    log(f"  K3 and K4 with the seed in device memory: draws equal to the int "
        f"seed's and in the twin's support; queued ms (device seed / int "
        f"seed): {json.dumps(out)}")
    return out


def check_device_counts(dev, name_limit):
    """K1-K6, K9 and K10 with the count in device memory (a 0-d int32, as
    a captured char step passes it: the grid then covers every item)
    beside the int count, at the char shapes (768 items, beam 7, P 136, c
    120, p_eff 128, D 512 over 8 heads, 49 encoder rows, V 128, bf16):
    at counts of 0, C_LIVE // C_BEAM and all the items (K6: 0, 1 and 8
    stragglers), the outputs bit-equal on every row the count defines
    (K6 leaves the others unwritten), each form timed queued. K6's two
    forms launch one grid shape (a wave of list entries, each (item,
    head) over the same cluster of blocks), so they sum alike. K4 also on
    its streamed path at V 2,006 (1,280 rows) and V 16,384 (3,072 rows:
    two chunks). Returns name -> count -> numbers."""
    from deephumor_tpu_torch.ops import sampler as S
    from deephumor_tpu_torch.ops.testing import (COUNTED, count_rows,
                                                 counted_calls)

    shapes = dict(items=C_BATCH, beam=C_BEAM, p=C_P, c=120, pe=128, d=HID,
                  n_heads=HEADS, t_enc=T_ENC, vocab=C_VOCAB, top_k=C_TOP_K,
                  length=C_LEN, dtype=torch.bfloat16, pack=PACK,
                  generator=torch.Generator(dev).manual_seed(16))
    calls = counted_calls(**shapes)
    timed = counted_calls(**dict(shapes, fresh=False))
    out = {}

    def both(name, run, trun, n, per, rows=None):
        """int and device count of ``n`` items: bit-equal outputs (K6,
        given ``rows``: on those rows), queued ms."""
        t = torch.tensor(n * per, dtype=torch.int32, device=dev)
        for g, w in zip(run(t), run(n * per)):
            if rows is not None:
                g, w = g[rows], w[rows]
            if not torch.equal(g, w):
                raise AssertionError(f"[16] {name}: a device count of {n} "
                                     f"gives other outputs than the int")
        return {"ms_count_ptr": cuda_ms(lambda: trun(t), queued=True),
                "ms_count_int": cuda_ms(lambda: trun(n * per), queued=True),
                "bit_equal": True}

    for name in COUNTED:
        (per, run), (_, trun) = calls[name], timed[name]
        k6 = name == "ancestry_attention_ids"
        out[name] = {}
        for n in (0, 1, 8) if k6 else (0, C_LIVE // C_BEAM, C_BATCH):
            rows = count_rows(name, n, C_BATCH, C_BEAM).to(dev)
            out[name][str(n)] = both(
                name, run, trun, n, per,
                rows.repeat_interleave(C_BEAM) if k6 else None)
    del calls, timed
    g = torch.Generator(dev).manual_seed(17)
    seed = torch.tensor([77], dtype=torch.int32, device=dev)
    for v, n_rows in ((2006, 1280), (16384, 3072)):
        x = torch.randn(n_rows, HID, generator=g, device=dev).to(
            torch.bfloat16)
        w = torch.randn(v, HID, generator=g, device=dev).to(torch.bfloat16)
        b = torch.randn(v, generator=g, device=dev)

        def k4(n, x=x, w=w, b=b):
            return S.fused_classifier_topk_gumbel_sample(
                x, w, b, seed, 1 / C_TEMP, top_k=64, num_draws=BEAM,
                live_rows=n)

        name = f"fused_classifier_topk_gumbel_sample_v{v}"
        out[name] = {str(n): both(name, k4, k4, n, 1)
                     for n in (0, n_rows * 2 // 3, n_rows)}
    log(f"  K1-K6, K9, K10 with a device count beside the int count at the "
        f"char shapes (K4 also streamed at V 2006 and 16384): outputs "
        f"bit-equal; queued ms (device / int count): " + "; ".join(
            f"{k} " + ", ".join(
                f"{n}: {r['ms_count_ptr']:.4f} / {r['ms_count_int']:.4f}"
                for n, r in v.items()) for k, v in out.items())
        + f" | {name_limit}")
    return out


def check_second_temperature(model, params, enc, kw, graphs, name_limit):
    """A second temperature on an existing word key: it makes no new key
    (the key's graphs replay with the new 1/T in their input buffer), its
    draws equal an eager call's at that temperature and differ from the
    first temperature's. Returns the numbers."""
    dev = batch(enc).device

    def call(compiled, temperature):
        return model.generate_from_emb(
            params, enc, generator=torch.Generator(dev).manual_seed(5),
            compiled=compiled, **dict(kw, temperature=temperature))

    graphs.clear()
    first = call(None, 1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    second = call(None, 0.7)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    eager = call(False, 0.7)
    info = graphs.cache_info()
    if len(info) != 1 or info[0]["replays"] != 2:
        raise AssertionError(f"[16] a second temperature made a new key: "
                             f"{info}")
    if not same_outputs(second, eager):
        raise AssertionError("[16] at a second temperature the captured "
                             "draws differ from the eager loop's")
    if torch.equal(second["scores"], first["scores"]):
        raise AssertionError("[16] the second temperature drew as the "
                             "first")
    res = {"items": batch(enc).shape[0], "keys": len(info),
           "replays": info[0]["replays"], "second_temperature_call_s": secs,
           "card": name_limit}
    log(f"  word, {res['items']} items: temperature 0.7 after 1.0 replays "
        f"the same key ({len(info)} key, {info[0]['replays']} replays; "
        f"{secs:.3f} s), draws equal to eager at 0.7 | {name_limit}")
    graphs.clear()
    return res


def compiled_batcher(pipe, kw, name_limit):
    """The pipeline's call of one full batch, captured and eager from one
    generator seed: the same texts. Then G_REQUESTS submits from
    S_THREADS threads through a DynamicBatcher (buckets "auto", warmed
    up), captured and eager in turns: captions/s, p50 and p99 of each
    (which batch a request lands in depends on the threads' timing)."""
    from deephumor_tpu_torch.serving import DynamicBatcher

    ids = list(pipe._row)
    full = [ids[i % len(ids)] for i in range(S_MAX_BATCH)]
    texts = [pipe.generate_captions(
        full, torch.Generator(pipe.device).manual_seed(9),
        pad_to=S_MAX_BATCH, compiled=compiled, **kw)
        for compiled in (None, False)]
    if texts[0] != texts[1]:
        raise AssertionError("[16] pipeline: captured texts differ from "
                             "eager texts at the same seed")
    log(f"  pipeline.generate_captions, {S_MAX_BATCH} requests: captured "
        f"texts equal to eager texts at one seed")
    n = G_REQUESTS
    stats = {}
    for compiled in (None, False, None, False):
        t_sub, t_done, futs = [0.0] * n, [0.0] * n, [None] * n
        barrier = threading.Barrier(S_THREADS)
        with DynamicBatcher(pipe, max_batch=S_MAX_BATCH, buckets="auto",
                            seed=2, compiled=compiled, **kw) as srv:
            srv.warmup()

            def client(k):
                barrier.wait()
                for i in range(k, n, S_THREADS):
                    t_sub[i] = time.perf_counter()
                    f = srv.submit(ids[i % len(ids)])
                    f.add_done_callback(lambda _, i=i: t_done.__setitem__(
                        i, time.perf_counter()))
                    futs[i] = f

            clients = [threading.Thread(target=client, args=(k,))
                       for k in range(S_THREADS)]
            for c in clients:
                c.start()
            for c in clients:
                c.join()
            texts = [f.result(timeout=300) for f in futs]
        for i, text in enumerate(texts):
            check_caption(text, pipe.vocab, f"[16] batcher request {i}")
        lat = np.array(t_done) - np.array(t_sub)
        key = "captured" if compiled is None else "eager"
        stats.setdefault(key, []).append({
            "captions_per_s": n / (max(t_done) - min(t_sub)),
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "buckets": sorted(set(srv.pad_sizes))})
    log(f"  batcher burst, {n} requests from {S_THREADS} threads, captured "
        f"then eager, twice: " + "; ".join(
            f"{k} " + ", ".join(f"{r['captions_per_s']:.1f} captions/s (p50 "
                                f"{r['p50_ms']:.1f} ms, p99 "
                                f"{r['p99_ms']:.1f} ms)" for r in v)
            for k, v in stats.items()) + f" | {name_limit}")
    return dict(stats, card=name_limit)


def greedy_text_small(_build, graphs, tree_map, dev):
    """Greedy text of the captured path at a small size (2 layers, hid 64,
    V 300, 8 items, f32) equal to the CPU's, for the transformers and the
    LSTM."""
    from deephumor_tpu_torch.models import (CaptioningLSTM,
                                            CaptioningTransformer,
                                            CaptioningTransformerBase)

    cpu = lambda t: t.cpu()  # noqa: E731
    g = torch.Generator(dev).manual_seed(16)
    feats = (torch.randn(8, 64, generator=g, device=dev),
             torch.randn(8, T_ENC, 64, generator=g, device=dev))
    kw = dict(max_len=20, beam_size=3, top_k=8, greedy=True)
    for cls, enc in ((CaptioningTransformer, feats),
                     (CaptioningTransformerBase, feats[0]),
                     (CaptioningLSTM, feats[0])):
        if cls is CaptioningLSTM:
            model = cls(num_tokens=300, emb_dim=64, hidden_size=64,
                        num_layers=2)
        else:
            model = cls(num_tokens=300, hid_dim=64, n_layers=2, n_heads=2,
                        pf_dim=128, max_len=24)
        params = model.init(torch.Generator(dev).manual_seed(3), dev)
        params["decoder"]["classifier"]["bias"][3] = 0.5
        got = model.generate_from_emb(params, enc, **kw)
        want = model.generate_from_emb(tree_map(cpu, params),
                                       tree_map(cpu, enc), **kw)
        if not torch.equal(got["chosen"].cpu(), want["chosen"]):
            raise AssertionError(f"[16] greedy {cls.__name__}: captured text "
                                 f"differs from the CPU's")
    graphs.clear()
    log("  greedy text at 2 layers, hid 64, V 300, 8 items, f32: captured "
        "== CPU for the cross-attention, decoder-only and LSTM models")


def encoder_first(model, params, images, kw, graphs, label, name_limit,
                  calls=G_CALLS):
    """A call from images captured whole beside the route before the
    encoder joined the prefill's graph: ``encode`` eagerly, then the
    captured decode of its output (``generate_from_emb``), in turns, from
    the same generator seed; outputs bit-equal. Returns captions/s of
    both (median of ``calls`` calls each)."""
    n, dev = images[0].shape[0], images[0].device

    def whole(seed):
        return model.generate(params, *images, generator=torch.Generator(
            dev).manual_seed(seed), **kw)

    def split(seed):
        return model.generate_from_emb(
            params, model.encode(params, *images),
            generator=torch.Generator(dev).manual_seed(seed), **kw)

    graphs.clear()
    if not same_outputs(whole(5), split(5)):
        raise AssertionError(f"[16] {label}: a call from images differs "
                             f"from encode + generate_from_emb")
    secs = {whole: [], split: []}
    for i in range(calls):
        for fn in (whole, split):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(10 + i)
            torch.cuda.synchronize()
            secs[fn].append(time.perf_counter() - t0)
    graphs.clear()
    rates = [n / float(np.median(secs[fn])) for fn in (whole, split)]
    log(f"  {label}: captured whole {rates[0]:.1f} captions/s, encoder "
        f"eager then the captured decode {rates[1]:.1f} (median of {calls} "
        f"calls each, in turns); outputs bit-equal | {name_limit}")
    return {"captions_per_s": rates[0], "captions_per_s_encoder_eager":
            rates[1], "card": name_limit}


def images_phase(_build, graphs, dev, name_limit, paths):
    """``generate`` from 224 x 224 images, captured (the encoder in the
    prefill's graph) beside eager: the word model at one image
    (``caption_image``'s shape) and at G_IMAGES, and the labelled LSTM
    at G_IMAGES; each path's numbers go into ``paths``. Then each beside
    the encoder run eagerly before the captured decode
    (:func:`encoder_first`). Returns the numbers of both comparisons."""
    from deephumor_tpu_torch.models import (CaptioningLSTMWithLabels,
                                            CaptioningTransformer)

    kw = dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K,
              temperature=1.0, sampler="pallas")
    g = torch.Generator(dev).manual_seed(17)
    images = torch.randn(G_IMAGES, 224, 224, 3, device=dev, generator=g)
    labels = torch.randint(4, VOCAB, (G_IMAGES, 5), device=dev, generator=g)
    word = ("ancestry_attention_update", "grouped_cross_attention",
            "fused_topk_gumbel_sample")
    word_model = make_model(CaptioningTransformer, "bfloat16", dev, False)
    lstm_model = make_lstm(CaptioningLSTMWithLabels, "bfloat16", dev)
    cases = (("images_word_1", word_model, (images[:1],), word,
              "word from 1 image"),
             ("images_word", word_model, (images,), word,
              f"word from {G_IMAGES} images"),
             ("images_lstm_labels", lstm_model, (images, labels),
              ("fused_topk_gumbel_sample",),
              f"lstm_labels from {G_IMAGES} images and labels"))
    out = {}
    for name, (model, params), x, kernels, label in cases:
        paths[name] = compare_compiled(
            model, params, None, kw, _build, graphs, label, name_limit,
            path_kernels=kernels, images=x)
        out[name] = dict(encoder_first(model, params, x, kw, graphs, label,
                                       name_limit),
                         captions_per_s_eager=paths[name][
                             "captions_per_s_eager"],
                         key_bytes=paths[name]["key_bytes"])
    return out


def compare_trunk_cache(_build, dev, name_limit):
    """``Trainer.build_trunk_cache`` over T_TEMPLATES random 224 x 224
    templates in chunks of 16 (the last of 12: its own graph), captured
    beside eager, in turns: features bit-equal, seconds of each."""
    from deephumor_tpu_torch.experiments.trainer import Trainer
    from deephumor_tpu_torch.models import CaptioningTransformer

    model, params = make_model(CaptioningTransformer, "bfloat16", dev, False)
    rng = np.random.default_rng(18)
    data = MemorySet({}, [], {f"t{i:03d}": rng.normal(
        size=(224, 224, 3)).astype(np.float32) for i in range(T_TEMPLATES)})
    secs, feats = {False: [], None: []}, {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as logdir:
        for compiled in (False, None, None, False):
            trainer = Trainer(model, "trunk", log_dir=logdir, device=dev,
                              compiled=compiled)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.build_trunk_cache(params, data)
            torch.cuda.synchronize()
            secs[compiled].append(time.perf_counter() - t0)
            feats.setdefault(compiled, trainer._trunk_cache)
            trainer.close()
    if not torch.equal(feats[None], feats[False]):
        raise AssertionError("[16] trunk cache: captured features differ "
                             "from eager")
    res = {"templates": T_TEMPLATES, "chunk": 16,
           "s_captured": secs[None], "s_eager": secs[False],
           "card": name_limit}
    log(f"  trunk cache, {T_TEMPLATES} templates 224 x 224, chunks of 16: "
        f"captured {secs[None][0]:.3f} s (first: warm-up and two "
        f"captures) then {secs[None][1]:.3f} s, eager {secs[False][0]:.3f} "
        f"/ {secs[False][1]:.3f} s; features bit-equal | {name_limit}")
    return res


def compiled_phase(_build, modules, dev, name_limit):
    """[16]: the decode loop captured (models/graphs.py) beside the eager
    loop on word (batch 1792), Base, LSTM, the sweep's shape (V 2,006,
    batch 256), char (batch 768, every phase and boundary captured) and a
    batcher burst; a second temperature on a word key; K1-K6, K9 and K10
    with device counts (module docstring). Returns each path's launches
    and the phase's numbers."""
    from deephumor_tpu_torch.data import Vocab
    from deephumor_tpu_torch.models import (CaptioningLSTM,
                                            CaptioningTransformer,
                                            CaptioningTransformerBase,
                                            graphs)
    from deephumor_tpu_torch.pipeline import MemeGenerationPipeline
    from deephumor_tpu_torch.utils.pytree import tree_map

    S = modules[-1]
    log(f"[16] compiled generation: captured (CUDA graphs) beside eager on "
        f"word, base, lstm (batch {BATCH}), the sweep's shape (V 2006, "
        f"batch 256), char (batch {C_BATCH}, whole), a batcher burst; a "
        f"second temperature; device counts | {name_limit}")
    t_phase = time.perf_counter()
    out = {"kernels": check_seed_forms(
        S, dev, torch.Generator(dev).manual_seed(16))}
    out["device_counts"] = check_device_counts(dev, name_limit)
    greedy_text_small(_build, graphs, tree_map, dev)
    kw = dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K,
              temperature=1.0, sampler="pallas")
    word_kernels = ("ancestry_attention_update", "grouped_cross_attention",
                    "fused_topk_gumbel_sample")
    paths = {}
    model, params = make_model(CaptioningTransformer, "bfloat16", dev, False)
    paths["word"] = compare_compiled(
        model, params, features(BATCH, dev, 4), kw, _build, graphs, "word",
        name_limit, path_kernels=word_kernels)
    out["second_temperature"] = check_second_temperature(
        model, params, features(256, dev, 4), kw, graphs, name_limit)
    model, params = make_model(CaptioningTransformerBase, "bfloat16", dev,
                               False)
    paths["base"] = compare_compiled(
        model, params, features(BATCH, dev, 4)[0], kw, _build, graphs,
        "base", name_limit, path_kernels=("ancestry_attention_update",
                                          "fused_topk_gumbel_sample"))
    model, params = make_lstm(CaptioningLSTM, "bfloat16", dev)
    paths["lstm"] = compare_compiled(
        model, params, torch.randn(BATCH, L_EMB, device=dev,
                                   generator=torch.Generator(dev).manual_seed(
                                       4)), kw, _build, graphs, "lstm",
        name_limit, path_kernels=("fused_topk_gumbel_sample",))
    # the sweep's model (sweep.py --synthetic): V 2,006, batch 256
    model = CaptioningTransformer(num_tokens=2006, hid_dim=HID,
                                  n_layers=LAYERS, n_heads=HEADS, pf_dim=PF,
                                  max_len=MAX_LEN + 2,
                                  compute_dtype="bfloat16")
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    paths["sweep"] = compare_compiled(
        model, params, features(256, dev, 15), kw, _build, graphs, "sweep",
        name_limit, path_kernels=word_kernels + (
            "fused_classifier_topk_gumbel_sample",))
    # char: every phase and boundary captured, full width and depth
    model, params = make_model(CaptioningTransformer, "bfloat16", dev, True)
    paths["char"] = compare_compiled(
        model, params, features(C_BATCH, dev, 6), dict(
            max_len=C_LEN, beam_size=C_BEAM, top_k=C_TOP_K,
            temperature=C_TEMP, sampler="pallas"), _build, graphs, "char",
        name_limit, calls=G_CHAR_CALLS, path_kernels=(
            "ancestry_attention_update", "grouped_cross_attention",
            "fused_topk_gumbel_sample",
            "fused_classifier_topk_gumbel_sample",
            "ancestry_attention_update_canon", "ancestry_attention_ids"))
    del model, params
    out["images"] = images_phase(_build, graphs, dev, name_limit, paths)
    out["trunk_cache"] = compare_trunk_cache(_build, dev, name_limit)
    # a batcher burst over a word pipeline (32 templates)
    model, params = make_model(CaptioningTransformer, "bfloat16", dev, False)
    bias = params["decoder"]["classifier"]["bias"]
    bias[0], bias[3] = S_PAD_BIAS, S_EOS_BIAS
    pipe = MemeGenerationPipeline(
        model, params, Vocab([f"word{i}" for i in range(VOCAB - 6)]))
    pipe.add_templates([f"t{i}" for i in range(32)], torch.randn(
        32, 224, 224, 3, device=dev,
        generator=torch.Generator(dev).manual_seed(7)))
    out["batcher"] = compiled_batcher(
        pipe, dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K,
                   sampler="pallas"), name_limit)
    pipe.close()
    graphs.clear()
    out["paths"] = paths
    out["seconds"] = time.perf_counter() - t_phase
    log(f"    [16] {out['seconds']:.1f} s")
    return {f"compiled_{k}": v.pop("launches_per_call")
            for k, v in paths.items()}, out


def k_close(label, got, want, failures, planted=()):
    """``got`` within K_RTOL of ``want`` element by element (K_RTOL of
    the element plus K_RTOL of ``want``'s RMS), and each ``planted`` wrong
    answer ``(name, tensor)`` outside it somewhere, so that the tolerance
    fails a wrong kernel. A miss is logged and added to ``failures``.
    Returns the largest gap over the RMS."""
    w = want.float()
    rms = w.pow(2).mean().sqrt().item()

    def within(x):
        return bool(((x.float() - w).abs()
                     <= K_RTOL * (w.abs() + rms)).all())

    err = (got.float() - w).abs().max().item() / rms
    ok = within(got)
    missed = [name for name, x in planted if within(x)]
    log(f"  {label}: largest gap {err:.2e} of the twin's RMS {rms:.3e} "
        f"(within {K_RTOL:.4f}: {ok}); planted faults outside it: "
        f"{[n for n, _ in planted if n not in missed]}")
    if not ok:
        failures.append(f"{label}: outside the tolerance ({err:.2e})")
    if missed:
        failures.append(f"{label}: planted {missed} inside the tolerance")
    return err


def check_k12(A, dev, gen, failures):
    """K12 against its twin at the kimi_vl.offline cell's decode shape (768
    items x beam 5 x 16 heads, 64 prefix rows, dk 576 / dv 512), over a
    searched and an all-distinct ancestry at K_PES generated positions;
    planted: the ancestry ignored (every slot's rows read by every branch)
    and the step's own row left out. Times each (queued) beside its twin,
    with the floor of its bytes (each item's prefix and listed rows read
    once, the queries in, the latent out)."""
    heads, s, dk, dv = 16, K_LEN, 576, 512
    bf = torch.bfloat16
    rnd = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(bf)  # noqa
    q_lat, q_pe = rnd(heads, K_ROWS, dv), rnd(K_ROWS, heads, dk - dv)
    prefix, gen_rows = rnd(K_ITEMS, K_PREFIX, dk), rnd(K_ROWS, s, dk)
    scale = 1.0 / math.sqrt(192)
    row = {"ms": {}, "plain_ms": {}, "bound_ms": {}, "max_err": {}}
    for kind in ("searched", "distinct"):
        anc = torch.arange(K_BEAM, device=dev)[None, :, None].expand(
            K_ITEMS, K_BEAM, s).contiguous()
        for step in range(s):
            if kind == "searched":
                branch = torch.randint(0, K_BEAM, (K_ITEMS, K_BEAM),
                                       generator=gen, device=dev)
                anc = anc.gather(1, branch[:, :, None].expand_as(anc))
            anc[:, :, step] = torch.arange(K_BEAM, device=dev)
        for pe in K_PES:
            valid = (torch.arange(s, device=dev) < pe).expand(K_ROWS, s)
            bias = A.ancestry_bias(anc, valid, s)
            kw = dict(beam=K_BEAM, pe=pe, scale=scale)
            got = A.mla_attention(q_lat, q_pe, prefix, gen_rows, bias, **kw)
            want = A.mla_attention_plain(q_lat, q_pe, prefix, gen_rows, bias,
                                         **kw)
            own = bias.clone().reshape(K_ITEMS, K_BEAM, K_BEAM, s)
            own[:, torch.arange(K_BEAM), torch.arange(K_BEAM), pe - 1] = \
                A.MASK_FILL
            planted = (
                ("ancestry ignored", A.mla_attention_plain(
                    q_lat, q_pe, prefix, gen_rows, torch.zeros_like(bias),
                    **kw)),
                ("own row left out", A.mla_attention_plain(
                    q_lat, q_pe, prefix, gen_rows, own.reshape(bias.shape),
                    **kw)))
            key = f"{kind}_pe{pe}"
            row["max_err"][key] = k_close(f"K12 {kind} pe {pe}", got, want,
                                          failures, planted)
            listed = int((bias.reshape(K_ITEMS, K_BEAM, K_BEAM, s)[..., :pe]
                          == 0).any(1).sum())
            nbytes = ((K_ITEMS * K_PREFIX + listed) * dk * 2
                      + K_ROWS * heads * (dk * 2 + dv * 2)
                      + K_ITEMS * K_BEAM * K_BEAM * pe * 4)
            row["bound_ms"][key] = nbytes / HBM_BYTES_PER_S * 1e3
            row["ms"][key] = cuda_ms(lambda: A.mla_attention(
                q_lat, q_pe, prefix, gen_rows, bias, **kw), queued=True)
            row["plain_ms"][key] = cuda_ms(lambda: A.mla_attention_plain(
                q_lat, q_pe, prefix, gen_rows, bias, **kw), iters=3,
                warmup=1)
            log(f"  K12 {kind} pe {pe}: {row['ms'][key]:.4f} ms (device "
                f"alone; {listed} of {K_ITEMS * K_BEAM * pe} generated rows "
                f"listed), twin {row['plain_ms'][key]:.4f} ms, floor "
                f"{row['bound_ms'][key]:.4f} ms")
    return row


def check_moe_kernels(moe, dev, gen, failures):
    """moe.cu's gather, SwiGLU and combine against their twins at the
    kimi_vl.offline cell's decode step (3,840 tokens x 6 of 64 experts,
    16 held, D 2,048, I 1,408), routed by a seeded router as the model
    routes; the gather exact on the held rows, the SwiGLU and the combine
    within K_RTOL (planted: gate and up swapped; the absent experts'
    pairs added). Each timed (queued) beside its twin, with the floor of
    its bytes."""
    d, i, k, experts = 2048, 1408, 6, 64
    bf = torch.bfloat16
    h = torch.randn(K_ROWS, d, generator=gen, device=dev).to(bf)
    w_gate = (torch.rand(experts, d, generator=gen, device=dev) * 2 - 1) \
        / math.sqrt(d)
    e_bias = (torch.rand(experts, generator=gen, device=dev) * 2 - 1) * 0.05
    ids, w = moe.route(h, w_gate, e_bias, top_k=k, scaling=2.446)
    order, offs, mask, counts = moe.dispatch(ids, 0, K_HELD)
    held = int(offs[-1])
    pairs = order.numel()
    gu = torch.randn(pairs, 2 * i, generator=gen, device=dev).to(bf)
    y = torch.randn(pairs, d, generator=gen, device=dev).to(bf)
    cases = {
        "moe_gather": (
            lambda: moe.gather_pairs(h, order, offs, k),
            lambda: moe.gather_pairs_plain(h, order, offs, k),
            held * d * 2 * 2 + held * 8),
        "moe_swiglu": (
            lambda: moe.swiglu_rows(gu, offs),
            lambda: moe.swiglu_rows_plain(gu, offs),
            held * 3 * i * 2),
        "moe_combine": (
            lambda: moe.combine(y, order, mask, w, h),
            lambda: moe.combine_plain(y, order, mask, w, h),
            K_ROWS * d * 2 * 2 + held * d * 2 + pairs * (4 + 8 + 1)),
    }
    out = {}
    for name, (run, twin, nbytes) in cases.items():
        got, want = run(), twin()
        if name == "moe_gather":
            err = (got[:held].float() - want[:held].float()).abs().max()
            err = err.item()
            ok = torch.equal(got[:held], want[:held])
            log(f"  {name}: the {held} held rows equal to the twin's: {ok}")
            if not ok:
                failures.append(f"{name}: held rows differ from the twin")
        elif name == "moe_swiglu":
            swapped = moe.swiglu_rows_plain(
                torch.cat([gu[:, i:], gu[:, :i]], 1), offs)
            err = k_close(name, got[:held], want[:held], failures,
                          (("gate and up swapped", swapped[:held]),))
        else:
            every = moe.combine_plain(y, order, torch.ones_like(mask), w, h)
            err = k_close(name, got, want, failures,
                          (("absent experts' pairs added", every),))
        ms = cuda_ms(run, queued=True)
        plain_ms = cuda_ms(twin, iters=3, warmup=1)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "max_err": err,
                     "held_pairs": held, "pairs": pairs,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes", "library_ms": None}
        log(f"  {name}: {ms:.4f} ms (device alone, {held} held of {pairs} "
            f"pairs), twin {plain_ms:.4f} ms, floor "
            f"{out[name]['bound_ms']:.4f} ms")
    return out


def check_card_dtypes(moe, model_cls, dev, failures):
    """On the card the expert kernels and the model take bf16 alone: f32
    rows, and a width that is not a multiple of 8, raise ValueError."""
    h = torch.zeros(16, 64, device=dev)
    order = torch.arange(32, device=dev)
    offs = torch.full((4,), 8, dtype=torch.int32, device=dev)
    mask = torch.ones(32, dtype=torch.bool, device=dev)
    w = torch.ones(16, 2, device=dev)
    small = model_cls(num_tokens=64, hid_dim=64, n_layers=2, n_heads=4,
                      qk_nope=16, qk_rope=8, v_dim=16, kv_rank=32,
                      dense_width=64, expert_width=16, n_routed=8, n_held=4,
                      experts_per_token=2, n_shared=1, prefix_len=4)
    calls = {
        "gather f32": lambda: moe.gather_pairs(h, order, offs, 2),
        "swiglu f32": lambda: moe.swiglu_rows(h[:, :32].contiguous(), offs),
        "swiglu width 12": lambda: moe.swiglu_rows(
            h[:, :24].bfloat16().contiguous(), offs),
        "combine f32": lambda: moe.combine(torch.zeros(32, 64, device=dev),
                                           order, mask, w, h),
        "generate_from_emb f32": lambda: small.generate_from_emb(
            small.init(torch.Generator(dev).manual_seed(0), dev),
            torch.zeros(2, 4, 64, device=dev), max_len=2, beam_size=2,
            top_k=4)}
    refused = []
    for label, call in calls.items():
        try:
            call()
        except ValueError:
            refused.append(label)
    log(f"  on the card, refused with ValueError: {refused}")
    if len(refused) != len(calls):
        failures.append(f"not refused on the card: "
                        f"{sorted(set(calls) - set(refused))}")


def kimi_phase(_build, modules, dev, name_limit):
    """[17]: Kimi-VL-A3B-Instruct's language model (module docstring):
    K12, moe.cu's three kernels and K3's streamed rows held to their twins
    and timed at the kimi_vl.offline cell's shapes; then
    ``CaptioningMLAMoE.generate_from_emb`` at the published widths (27
    layers, 16 of 64 experts held, V 163,840, bf16) through BeamSearch,
    the captured graphs, K12, moe.cu and K3, with every launch count at
    zero, no plain twin seeing a CUDA tensor, and a profiled call. Returns
    the leg's launches and the phase's numbers."""
    from deephumor_tpu_torch.models import CaptioningMLAMoE, graphs, mla_moe
    from deephumor_tpu_torch.ops import moe

    A, S = modules[0], modules[-1]
    log(f"[17] Kimi-VL's language model: K12, moe.cu and K3 (V {K_VOCAB}) "
        f"at the kimi_vl.offline shapes, then generate_from_emb at the "
        f"published widths ({K_HELD} of 64 experts held, batch {K_ITEMS}, "
        f"{K_PREFIX} prefix rows, beam {K_BEAM}) | {name_limit}")
    t_phase = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(17)
    failures = []
    out = {"kernels": {"mla_attention": check_k12(A, dev, gen, failures)}}
    out["kernels"].update(check_moe_kernels(moe, dev, gen, failures))
    out["kernels"]["fused_topk_gumbel_sample_streamed"] = check_k3(
        S, dev, gen, rows=K_ROWS, vocab=K_VOCAB, top_k=K_TOP_K, draws=K_BEAM,
        inv_t=1.0, label="K3 streamed")
    check_card_dtypes(moe, CaptioningMLAMoE, dev, failures)
    torch.cuda.empty_cache()

    model = CaptioningMLAMoE(num_tokens=K_VOCAB, n_held=K_HELD,
                             prefix_len=K_PREFIX, compute_dtype="bfloat16")
    params = model.init(torch.Generator(dev).manual_seed(18), dev)
    cls = params["decoder"]["classifier"]
    cls["weight"][3] = 0.0
    cls["bias"][3] = K_EOS_BIAS
    enc = torch.randn(K_ITEMS, K_PREFIX, model.hid_dim, device=dev,
                      generator=torch.Generator(dev).manual_seed(19))
    kw = dict(max_len=K_LEN, beam_size=K_BEAM, top_k=K_TOP_K,
              temperature=1.0, sampler="pallas")
    kernels = ("mla_attention", "moe_gather", "moe_swiglu", "moe_combine",
               "fused_topk_gumbel_sample")
    hits, restore = twin_guard(modules + (moe,))
    try:
        res, launches = drive(model, params, enc, _build, kw, name_limit,
                              "kimi", kernels)
    finally:
        restore()
    check_output(res, K_ITEMS, K_VOCAB, K_BEAM, K_LEN)
    if hits:
        failures.append(f"kimi: plain twins called with CUDA tensors "
                        f"{sorted(set(hits))}")
    steps = launches["fused_topk_gumbel_sample"] - 1
    passes = -(-K_ITEMS // (mla_moe.PREFILL_TOKENS // K_PREFIX))
    moe_layers = model.n_layers - model.first_dense
    want = {"mla_attention": model.n_layers * steps,
            **{k: moe_layers * (passes + steps)
               for k in ("moe_gather", "moe_swiglu", "moe_combine")}}
    got = {k: launches[k] for k in want}
    log(f"  kimi: {steps} decode steps, {passes} prefill passes; launches "
        f"{got} (want {want}); plain twins on CUDA tensors: "
        f"{sorted(set(hits))}")
    if got != want:
        failures.append(f"kimi: launches {got}, want {want}")
    out["profile"] = profile_call(model, params, enc, kw, name_limit, "kimi",
                                  16)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["card"] = name_limit
    del model, params, enc, res
    graphs.clear()
    torch.cuda.empty_cache()
    log(f"  peak memory {out['peak_gb']:.2f} GB; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("[17] " + "; ".join(failures))
    return {"kimi": launches}, out


def kimi_only():
    """``--kimi``: builds the kernels and runs [17] alone; prints its
    numbers and launches as one JSON line."""
    from deephumor_tpu_torch.ops import _build
    from deephumor_tpu_torch.ops import attention as A
    from deephumor_tpu_torch.ops import cache as C
    from deephumor_tpu_torch.ops import engine as E
    from deephumor_tpu_torch.ops import sampler as S

    torch.backends.cuda.matmul.allow_tf32 = False
    for key in ("DH_CROSS_PACK", "DH_FUSED_SURVIVOR"):
        os.environ.pop(key, None)
    _build.library()
    legs, numbers = kimi_phase(_build, (A, C, E, S), torch.device("cuda", 0),
                               card())
    print(json.dumps({"kimi": numbers, "launches": legs}), flush=True)


def compiled_only():
    """``--compiled``: builds the kernels and runs [16] alone; prints its
    numbers and launches as one JSON line."""
    from deephumor_tpu_torch.ops import _build
    from deephumor_tpu_torch.ops import attention as A
    from deephumor_tpu_torch.ops import cache as C
    from deephumor_tpu_torch.ops import engine as E
    from deephumor_tpu_torch.ops import sampler as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for key in ("DH_CROSS_PACK", "DH_FUSED_SURVIVOR"):
        os.environ.pop(key, None)
    _build.library()
    legs, numbers = compiled_phase(_build, (A, C, E, S),
                                   torch.device("cuda", 0), card())
    print(json.dumps({"compiled": numbers, "launches": legs}), flush=True)


def train_only():
    """``--train``: builds the kernels and runs [12] alone; prints its
    numbers and the served model's launches as one JSON line."""
    from deephumor_tpu_torch.models import CaptioningTransformer
    from deephumor_tpu_torch.ops import _build
    from deephumor_tpu_torch.ops import attention as A
    from deephumor_tpu_torch.ops import cache as C
    from deephumor_tpu_torch.ops import engine as E
    from deephumor_tpu_torch.ops import sampler as S
    from deephumor_tpu_torch.utils.pytree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for key in ("DH_CROSS_PACK", "DH_FUSED_SURVIVOR"):
        os.environ.pop(key, None)
    _build.library()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as logdir:
        launches, train = check_train(
            CaptioningTransformer, tree_map, _build, (A, C, E, S),
            torch.device("cuda", 0), card(), logdir)
    print(json.dumps({"train": train, "launches": launches}), flush=True)


def parallel_only():
    """``--parallel``: builds the kernels and runs [13] alone on this card;
    prints its numbers as one JSON line."""
    from deephumor_tpu_torch.models import CaptioningTransformer
    from deephumor_tpu_torch.ops import _build
    from deephumor_tpu_torch.ops import attention as A
    from deephumor_tpu_torch.ops import cache as C
    from deephumor_tpu_torch.ops import engine as E
    from deephumor_tpu_torch.ops import sampler as S
    from deephumor_tpu_torch.utils.pytree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for key in ("DH_CROSS_PACK", "DH_FUSED_SURVIVOR"):
        os.environ.pop(key, None)
    _build.library()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as logdir:
        launches, serving, out = check_parallel(
            CaptioningTransformer, tree_map, _build, (A, C, E, S),
            torch.device("cuda", 0), card(), logdir)
    print(json.dumps({"parallel": out, "launches": launches,
                      "serving_launches": serving}), flush=True)


def kernel_split(fn, calls=10):
    """torch.profiler over ``calls`` calls of ``fn``: each kernel's device
    time per call (ms), by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.device_time_total > 0}


def kernel_times(root):
    """Device times (queued) of K3 and K8 at the word shape (first); of K4
    at the char shape, all rows and C_LIVE live, and at X_SHAPES (with
    each kernel's share, profiled); of K3 at the sweep's first draw and
    over K4's logits at X_SHAPES; and of K9 (ng 2, PACK, 8) beside K2 on
    the same rows at the word and char shapes, through the
    deephumor_tpu_torch of the tree at ``root``:
    given another tree's root, it times that tree's kernels on the same
    inputs (a change beside its parent, in one call). Prints one JSON
    line."""
    sys.path.insert(0, os.path.abspath(root))
    from deephumor_tpu_torch.ops import attention as A
    from deephumor_tpu_torch.ops import sampler as S

    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    out = {"tree": root, "card": card()}
    # K3 and K8 at the word shape first, in the process's first
    # allocations: later, what ran before moves memory-bound kernels by
    # a few percent either way
    logits = torch.randn(ROWS, VOCAB, generator=gen, device=dev).to(
        torch.bfloat16)
    out["k3_ms_word"] = cuda_ms(lambda: S.fused_topk_gumbel_sample(
        logits, 7, 1.0, top_k=TOP_K, num_draws=BEAM), queued=True)
    del logits
    q, ck, cv, kn, vn, bias = attention_state(
        A, dev, gen, items=BATCH, beam=BEAM, p=P, pos=31, dt=torch.bfloat16)
    out["k8_ms_word"] = cuda_ms(lambda: A.ancestry_attention_update_flash(
        q, ck, cv, kn, vn, bias, 31, beam=BEAM, n_heads=HEADS), queued=True)
    del q, ck, cv, kn, vn, bias
    x, w, b = k4_inputs(dev, gen)
    kw = dict(top_k=C_TOP_K, num_draws=C_BEAM)
    for key, live in (("k4_ms", None), ("k4_ms_live", C_LIVE)):
        out[key] = cuda_ms(lambda: S.fused_classifier_topk_gumbel_sample(
            x, w, b, 7, 1 / C_TEMP, live_rows=live, **kw), queued=True)
    for path, items, beam, top_k, vocab, d, inv_t in X_SHAPES:
        x, w, b = k4_inputs(dev, gen, d, items * beam, vocab)
        kw = dict(top_k=top_k, num_draws=beam)
        out[f"k4_ms_{path}"] = cuda_ms(
            lambda: S.fused_classifier_topk_gumbel_sample(
                x, w, b, 7, inv_t, **kw), queued=True)
        out[f"k4_kernels_{path}"] = kernel_split(
            lambda: S.fused_classifier_topk_gumbel_sample(x, w, b, 7, inv_t,
                                                          **kw))
        # K3 alone over the same logits: the draw half of F.linear + K3
        logits = S.classifier_logits(x, w, b)
        out[f"k3_ms_{path}"] = cuda_ms(
            lambda: S.fused_topk_gumbel_sample(logits, 7, inv_t, **kw),
            queued=True)
    logits = torch.randn(256, 2006, generator=gen, device=dev).to(
        torch.bfloat16)
    out["k3_ms_sweep"] = cuda_ms(lambda: S.fused_topk_gumbel_sample(
        logits, 7, 1.0, top_k=64, num_draws=5), queued=True)
    for label, items, beam in (("word", BATCH, BEAM),
                               ("char", C_BATCH, C_BEAM)):
        q, ek, ev, bias = k9_inputs(A, dev, gen, items, beam)
        for ng in (2, PACK, 8):
            kw9 = dict(n_heads=HEADS, pack_items=ng, t_real=T_ENC)
            out[f"k9_ms_{label}_ng{ng}"] = cuda_ms(
                lambda: A.grouped_cross_attention(q, ek, ev, bias, **kw9),
                queued=True)
        out[f"k2_ms_{label}"] = k2_on_k9_rows(A, q, ek, ev, bias, None)
    print(json.dumps(out), flush=True)


def leg_times(root, calls=10):
    """The word and char legs as they serve (bf16, sampler 'pallas', the
    legs' batches, inputs and seeds; captured, the default), through the
    deephumor_tpu_torch of the tree at ``root``: the captions/s of each of
    ``calls`` calls (host clock, synchronised), one profiled call's kernel
    time, idle share and copy / ``where`` / ``cat`` kernels, and K6 queued
    at 0, 1, 2, 4 and 8 stragglers of the char shape with an int and a
    device count (a contiguous q and no ``out=``, which every tree takes).
    Given another tree's root it runs that tree's code on the same
    inputs: a change beside its parent, in one call. Prints one JSON
    line."""
    sys.path.insert(0, os.path.abspath(root))
    from deephumor_tpu_torch.models import CaptioningTransformer, graphs
    from deephumor_tpu_torch.ops import attention as A
    from deephumor_tpu_torch.ops.testing import canon_state

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name_limit = card()
    out = {"tree": root, "card": name_limit}
    for label, char in (("word", False), ("char", True)):
        model, params = make_model(CaptioningTransformer, "bfloat16", dev,
                                   char)
        n = C_BATCH if char else BATCH
        kw = (dict(max_len=C_LEN, beam_size=C_BEAM, top_k=C_TOP_K,
                   temperature=C_TEMP, sampler="pallas") if char
              else dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K,
                        temperature=1.0, sampler="pallas"))
        enc = features(n, dev, 6 if char else 4)
        model.generate_from_emb(params, enc, **kw)  # warm-up and capture
        rates = [n / timed_call(model, params, enc, kw, seed)[1]
                 for seed in range(5, 5 + calls)]
        out[label] = dict(captions_per_s=rates, **profile_call(
            model, params, enc, kw, name_limit, f"{label} ({root})", 12))
        log(f"  {label} ({root}): captured captions/s "
            f"{[round(r, 1) for r in rates]} | {name_limit}")
        del model, params, enc
        graphs.clear()
    gen = torch.Generator(dev).manual_seed(0)
    s = canon_state(items=C_BATCH, beam=C_BEAM, p=C_P, c=120, pe=128, d=HID,
                    dtype=torch.bfloat16, generator=gen, stragglers=range(8))
    ids = torch.arange(C_BATCH, device=dev, dtype=torch.int32)
    args = (s["q"], s["ck"], s["cv"], s["bias"], ids)
    kw = dict(beam=C_BEAM, n_heads=HEADS, p_eff=128)
    out["k6_ms"] = {
        str(n): [cuda_ms(lambda c=c: A.ancestry_attention_ids(
            *args, c, **kw), queued=True)
            for c in (n, torch.tensor(n, dtype=torch.int32, device=dev))]
        for n in (0, 1, 2, 4, 8)}
    log(f"  K6 ({root}) at 0-8 stragglers, int / device count ms: "
        f"{out['k6_ms']}")
    print(json.dumps(out), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing is run")
    if sys.argv[1:2] == ["--kernel-times"]:
        return kernel_times(sys.argv[2] if len(sys.argv) > 2 else ".")
    if sys.argv[1:2] == ["--leg-times"]:
        return leg_times(sys.argv[2] if len(sys.argv) > 2 else ".")
    if sys.argv[1:2] == ["--cold-build"]:
        return cold_build()
    if sys.argv[1:2] == ["--mesh-ranks"]:
        return mesh_ranks(sys.argv[2:3] == ["tp"])
    if sys.argv[1:2] == ["--tp-rank"]:
        return tp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if sys.argv[1:2] == ["--tp"]:
        return tp_only()
    if sys.argv[1:2] == ["--product"]:
        return product_only()
    if sys.argv[1:2] == ["--compiled"]:
        return compiled_only()
    if sys.argv[1:2] == ["--train"]:
        return train_only()
    if sys.argv[1:2] == ["--parallel"]:
        return parallel_only()
    if sys.argv[1:2] == ["--kimi"]:
        return kimi_only()
    from deephumor_tpu_torch.models import (CaptioningLSTM,
                                            CaptioningLSTMWithLabels,
                                            CaptioningTransformer,
                                            CaptioningTransformerBase,
                                            graphs)
    from deephumor_tpu_torch.ops import _build
    from deephumor_tpu_torch.ops import attention as A
    from deephumor_tpu_torch.ops import cache as C
    from deephumor_tpu_torch.ops import engine as E
    from deephumor_tpu_torch.ops import sampler as S
    from deephumor_tpu_torch.utils.pytree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    # the f32 ResNet runs on cuDNN in full f32, as the JAX encoder does
    torch.backends.cudnn.allow_tf32 = False
    # the default legs run without the two switches; switched legs set them
    for key in ("DH_CROSS_PACK", "DH_FUSED_SURVIVOR"):
        os.environ.pop(key, None)
    dev = torch.device("cuda", 0)
    name_limit = card()
    t_start = time.perf_counter()
    log(f"[1] device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()} | nvidia-smi: {name_limit} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.library()
    log(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"-> {_build.BUILD_DIR}")
    for line in (_build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log("    " + line.strip())

    gen = torch.Generator(dev).manual_seed(0)
    rows = {}
    log(f"[3] word kernels: K1 rows {ROWS}, P {P}, D {HID}, bf16")
    rows["ancestry_attention_update"] = check_k1(
        A, dev, gen, items=BATCH, beam=BEAM, p=P, pes=(16, 24, 32),
        dt=torch.bfloat16)
    log(f"    K2 G {BATCH}, r {BEAM}, T {T_ENC}: bf16 timed; f32, no bias, "
        f"head_dim 24 (bf16, f32), 0 and 500 live items")
    rows["grouped_cross_attention"] = check_k2(A, dev, gen, items=BATCH,
                                               beam=BEAM)
    f32 = torch.float32
    for k2 in (dict(dt=f32), dict(masked=False), dict(d=24 * HEADS),
               dict(d=24 * HEADS, dt=f32), dict(live_items=0),
               dict(live_items=500)):
        check_k2(A, dev, gen, items=BATCH, beam=BEAM, timed=False, **k2)
    log(f"    K3 [{ROWS}, {VOCAB}] bf16, top_k {TOP_K}, draws {BEAM}; f32; "
        f"V 3001 (rows start unaligned); f32 at V 52000 (no vector table)")
    rows["fused_topk_gumbel_sample"] = check_k3(
        S, dev, gen, rows=ROWS, vocab=VOCAB, top_k=TOP_K, draws=BEAM,
        inv_t=1.0, label="K3")
    rows["fused_topk_gumbel_sample"]["ms_f32"] = check_k3(
        S, dev, gen, rows=ROWS, vocab=VOCAB, top_k=TOP_K, draws=BEAM,
        inv_t=1.0, label="K3 f32", dt=f32)["ms"]
    check_k3(S, dev, gen, rows=ROWS, vocab=3001, top_k=TOP_K, draws=BEAM,
             inv_t=1.0, label="K3 V 3001", timed=False)
    # rows too long for the vector table beside a full candidate list
    check_k3(S, dev, gen, rows=1000, vocab=52000, top_k=TOP_K, draws=BEAM,
             inv_t=1.0, label="K3 f32 V 52000", dt=f32, timed=False)
    log(f"    K9 G {BATCH}, r {BEAM}, T {T_ENC} padded to {T_PAD}, ng 2, 4, 8")
    rows["cross_attention_packed"] = check_k9(A, dev, gen, items=BATCH,
                                              beam=BEAM, ngs=(2, 4, 8))
    log(f"    K10 items {BATCH}, beam {BEAM}, L {MAX_LEN}, P {MAX_LEN + 1}")
    rows["fused_survivor_update"] = check_k10(E, dev, gen, items=BATCH,
                                              beam=BEAM, length=MAX_LEN)
    log(f"    K7 rows {ROWS}, P {P}: native4d p_eff 32, 16, 24; grouped, "
        f"blockdiag (all P)")
    rows["ancestry_attention"] = check_k7(
        A, dev, gen, items=BATCH, beam=BEAM, p=P, label="K7",
        cases=(("native4d", 32), ("native4d", 16), ("native4d", 24),
               ("grouped", None), ("blockdiag", None)))
    log(f"    K8 rows {ROWS}, P {P}, pos 7, 39, 31, beside K1")
    rows["ancestry_attention_update_flash"] = check_k8(
        A, dev, gen, items=BATCH, beam=BEAM, p=P, positions=(7, 39, 31),
        label="K8")
    log(f"    K11 rows {ROWS}, P {P}, D {HID}")
    rows["cache_column_write"] = check_k11(C, dev, gen, rows=ROWS, p=P,
                                           positions=(0, 17, 39), label="K11")

    log("[4] word greedy generate_from_emb, f32, kernels (without and with "
        "both switches) vs plain CPU path")
    check_greedy(CaptioningTransformer, tree_map, _build, dev, char=False)

    log(f"[5] word main path: bf16, sampler='pallas', batch {BATCH}")
    model, params = make_model(CaptioningTransformer, "bfloat16", dev, False)
    kw = dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K,
              temperature=1.0, sampler="pallas")
    images = torch.randn(8, 224, 224, 3, device=dev,
                         generator=torch.Generator(dev).manual_seed(2))
    out = model.generate(params, images,
                         generator=torch.Generator(dev).manual_seed(3), **kw)
    check_output(out, 8, VOCAB, BEAM, MAX_LEN)
    log("  generate(8 images 224x224): ok")
    word_kernels = ("ancestry_attention_update", "grouped_cross_attention",
                    "fused_topk_gumbel_sample")
    enc = features(BATCH, dev, 4)
    legs = {}
    out, legs["word"] = drive(model, params, enc, _build, kw, name_limit,
                              "word", word_kernels)
    check_output(out, BATCH, VOCAB, BEAM, MAX_LEN)
    profile_call(model, params, enc, kw, name_limit, "word", 12)
    fused, legs["word_fused"] = drive(
        model, params, enc, _build, kw, name_limit, "word_fused",
        word_kernels + ("fused_survivor_update",), fused=True)
    # K3 draws once after the prefill and once per decode step
    check_leg_launches("word_fused", legs["word_fused"], False,
                       legs["word_fused"]["fused_topk_gumbel_sample"] - 1)
    # no compaction at 32 steps: K10 changes no draw
    if not (torch.equal(fused["sequences"], out["sequences"])
            and torch.equal(fused["scores"], out["scores"])):
        raise AssertionError("word_fused: sequences or scores differ from "
                             "the default word leg's at the same seed")
    log("  word_fused: sequences and scores equal to the word leg's")
    out, legs["word_packed_fused"] = drive(
        model, params, enc, _build, kw, name_limit, "word_packed_fused",
        word_kernels + ("cross_attention_packed", "fused_survivor_update"),
        pack=PACK, fused=True)
    check_output(out, BATCH, VOCAB, BEAM, MAX_LEN)
    check_leg_launches(
        "word_packed_fused", legs["word_packed_fused"], True,
        legs["word_packed_fused"]["fused_topk_gumbel_sample"] - 1)
    profile_call(model, params, enc, kw, name_limit, "word_packed_fused", 12,
                 pack=PACK, fused=True)
    del model, params, out, fused, enc
    graphs.clear()
    log(f"    elapsed {time.perf_counter() - t_start:.1f} s")

    log("[6] decoder-only transformer and LSTM: greedy f32 on the card vs "
        "plain CPU path, then the serving legs (bf16, sampler='pallas', "
        f"batch {BATCH})")
    model, params = make_model(CaptioningTransformerBase, "float32", dev,
                               False)
    greedy_parity(model, params, features(64, dev, 1)[0], tree_map,
                  "CaptioningTransformerBase (K1)")
    model, params = make_lstm(CaptioningLSTM, "float32", dev)
    greedy_parity(model, params, torch.randn(
        64, L_EMB, device=dev, generator=torch.Generator(dev).manual_seed(1)),
        tree_map, "CaptioningLSTM")
    base_kernels = ("ancestry_attention_update", "fused_topk_gumbel_sample")
    model, params = make_model(CaptioningTransformerBase, "bfloat16", dev,
                               False)
    out = model.generate(params, images,
                         generator=torch.Generator(dev).manual_seed(3), **kw)
    check_output(out, 8, VOCAB, BEAM, MAX_LEN)
    log("  base generate(8 images 224x224): ok")
    enc = features(BATCH, dev, 4)[0]
    out, legs["base"] = drive(model, params, enc, _build, kw, name_limit,
                              "base", base_kernels)
    check_output(out, BATCH, VOCAB, BEAM, MAX_LEN)
    fused, legs["base_fused"] = drive(
        model, params, enc, _build, kw, name_limit, "base_fused",
        base_kernels + ("fused_survivor_update",), fused=True)
    # K3 draws once after the prefill and once per decode step
    steps = legs["base_fused"]["fused_topk_gumbel_sample"] - 1
    if legs["base_fused"]["fused_survivor_update"] != steps:
        raise AssertionError("base_fused: K10 not launched once per step")
    if not (torch.equal(fused["sequences"], out["sequences"])
            and torch.equal(fused["scores"], out["scores"])):
        raise AssertionError("base_fused: sequences or scores differ from "
                             "the base leg's at the same seed")
    log(f"  base_fused: K10 once in each of {steps} decode steps; sequences "
        f"and scores equal to the base leg's")
    profile_call(model, params, enc, kw, name_limit, "base", 12)
    profile_call(model, params, enc, kw, name_limit, "base_fused", 12,
                 fused=True)
    model, params = make_lstm(CaptioningLSTM, "bfloat16", dev)
    out = model.generate(params, images,
                         generator=torch.Generator(dev).manual_seed(3), **kw)
    check_output(out, 8, VOCAB, BEAM, MAX_LEN)
    lab_model, lab_params = make_lstm(CaptioningLSTMWithLabels, "bfloat16",
                                      dev)
    labels = torch.randint(4, VOCAB, (8, 5), device=dev,
                           generator=torch.Generator(dev).manual_seed(5))
    out = lab_model.generate(lab_params, images, labels,
                             generator=torch.Generator(dev).manual_seed(3),
                             **kw)
    check_output(out, 8, VOCAB, BEAM, MAX_LEN)
    log("  lstm generate(8 images) and lstm_labels generate(8 images, "
        "labels): ok")
    enc = torch.randn(BATCH, L_EMB, device=dev,
                      generator=torch.Generator(dev).manual_seed(4))
    out, legs["lstm"] = drive(model, params, enc, _build, kw, name_limit,
                              "lstm", ("fused_topk_gumbel_sample",))
    check_output(out, BATCH, VOCAB, BEAM, MAX_LEN)
    profile_call(model, params, enc, kw, name_limit, "lstm", 12)
    del model, params, lab_model, lab_params, out, fused, enc
    graphs.clear()
    log(f"    elapsed {time.perf_counter() - t_start:.1f} s")

    log(f"[7] char kernels: K4 x [{C_ROWS}, {HID}] W [{C_VOCAB}, {HID}] "
        f"bf16, top_k {C_TOP_K}, draws {C_BEAM}")
    rows["fused_classifier_topk_gumbel_sample"] = check_k4(S, dev, gen)
    log(f"    K5/K6 rows {C_ROWS}, P {C_P}, D {HID}, bf16")
    (rows["ancestry_attention_update_canon"],
     rows["ancestry_attention_ids"]) = check_k5_k6(A, dev, gen)
    log(f"    K3 (the first draw) [{C_BATCH}, {C_VOCAB}] bf16, top_k "
        f"{C_TOP_K}, draws {C_BEAM}, 1/T 1/{C_TEMP}")
    char_k3 = check_k3(S, dev, gen, rows=C_BATCH, vocab=C_VOCAB,
                       top_k=C_TOP_K, draws=C_BEAM, inv_t=1 / C_TEMP,
                       label="K3 char")
    log("    K1/K2 at the char shapes, all items live and 500 live; K1 to "
        "p_eff 128 (canon off) in bf16 and f32, and at head_dim 24")
    for live in (None, 500):
        char_k1 = check_k1(A, dev, gen, items=C_BATCH, beam=C_BEAM, p=C_P,
                           pes=(40, 128), dt=torch.bfloat16, live_items=live,
                           label="K1 char")
        check_k1(A, dev, gen, items=C_BATCH, beam=C_BEAM, p=C_P, pes=(128,),
                 dt=torch.float32, live_items=live, label="K1 char",
                 timed=False)
        char_k2 = check_k2(A, dev, gen, items=C_BATCH, beam=C_BEAM,
                           live_items=live)
        for name, r in (("K1 (p_eff 128)", char_k1), ("K2", char_k2)):
            log(f"    {name} at the char shape, live items {live}: "
                f"{r['ms']:.4f} ms (twin {r['plain_ms']:.4f} ms, SDPA "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms)")
        if live is None:
            rows["ancestry_attention_update"]["ms_char_pe128"] = char_k1["ms"]
            rows["grouped_cross_attention"].update(
                ms_char=char_k2["ms"], bound_ms_char=char_k2["bound_ms"])
    check_k2(A, dev, gen, items=C_BATCH, beam=C_BEAM, dt=torch.float32,
             timed=False)
    # head_dim 24: bf16 off the tensor cores, on the CUDA-core kernel
    check_k1(A, dev, gen, items=C_BATCH, beam=C_BEAM, p=C_P, pes=(128,),
             dt=torch.bfloat16, label="K1 char", d=24 * HEADS, timed=False)
    rows["fused_topk_gumbel_sample"]["ms_char"] = char_k3["ms"]
    log("    K9 and K10 at the char shapes, all items live and 500 live")
    for live in (None, 500):
        char_k9 = check_k9(A, dev, gen, items=C_BATCH, beam=C_BEAM,
                           ngs=(PACK,), live_items=live)
        char_k10 = check_k10(E, dev, gen, items=C_BATCH, beam=C_BEAM,
                             length=C_LEN, live_items=live)
        if live is None:
            rows["cross_attention_packed"].update(
                ms_char=char_k9["ms"], k2_ms_char=char_k9["k2_ms"],
                bound_ms_char=char_k9["bound_ms"])
        for name, r in (("K9 (ng 4)", char_k9), ("K10", char_k10)):
            log(f"    {name} at the char shape, live items {live}: "
                f"{r['ms']:.4f} ms (twin {r['plain_ms']:.4f} ms, SDPA "
                f"{r['library_ms']}, bound {r['bound_ms']:.4f} ms)")

    log(f"    K7 and K8 rows {C_ROWS}, P {C_P}; K11 rows {C_ROWS}, P {C_P}")
    char_k7 = check_k7(A, dev, gen, items=C_BATCH, beam=C_BEAM, p=C_P,
                       cases=(("native4d", 128), ("grouped", None)),
                       label="K7 char")
    char_k8 = check_k8(A, dev, gen, items=C_BATCH, beam=C_BEAM, p=C_P,
                       positions=(127,), label="K8 char")
    char_k11 = check_k11(C, dev, gen, rows=C_ROWS, p=C_P,
                         positions=(0, 64, 127), label="K11 char")
    for name, r in (("K7 (native4d, p_eff 128)", char_k7),
                    ("K8 (pos 127)", char_k8), ("K11 (pos 64)", char_k11)):
        log(f"    {name} at the char shape: {r['ms']:.4f} ms (twin "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms)")

    log("[8] char greedy generate_from_emb, f32, kernels (without and with "
        "both switches) vs plain CPU path")
    check_greedy(CaptioningTransformer, tree_map, _build, dev, char=True)

    log(f"[9] char main path: bf16, sampler='pallas', batch {C_BATCH}")
    model, params = make_model(CaptioningTransformer, "bfloat16", dev, True)
    kw = dict(max_len=C_LEN, beam_size=C_BEAM, top_k=C_TOP_K,
              temperature=C_TEMP, sampler="pallas")
    enc = features(C_BATCH, dev, 6)
    char_kernels = (
        "ancestry_attention_update", "grouped_cross_attention",
        "fused_topk_gumbel_sample", "fused_classifier_topk_gumbel_sample",
        "ancestry_attention_update_canon", "ancestry_attention_ids")
    out, legs["char"] = drive(model, params, enc, _build, kw, name_limit,
                              "char", char_kernels)
    check_output(out, C_BATCH, C_VOCAB, C_BEAM, C_LEN)
    log(f"  boundaries (p_eff, live items after compaction, stragglers): "
        f"{marks(out)}")
    check_k6_leg(A, dev, gen, marks(out), rows["ancestry_attention_ids"])
    profile_call(model, params, enc, kw, name_limit, "char", 25)
    out, legs["char_packed_fused"] = drive(
        model, params, enc, _build, kw, name_limit, "char_packed_fused",
        char_kernels + ("cross_attention_packed", "fused_survivor_update"),
        pack=PACK, fused=True)
    check_output(out, C_BATCH, C_VOCAB, C_BEAM, C_LEN)
    # K4 draws once per decode step
    check_leg_launches(
        "char_packed_fused", legs["char_packed_fused"], True,
        legs["char_packed_fused"]["fused_classifier_topk_gumbel_sample"])
    log(f"  boundaries (p_eff, live items after compaction, stragglers): "
        f"{marks(out)}")
    profile_call(model, params, enc, kw, name_limit, "char_packed_fused", 12,
                 pack=PACK, fused=True)
    for leg in ("char", "char_packed_fused"):
        if legs[leg]["fused_topk_gumbel_sample"] != 1:
            raise AssertionError(f"{leg}: K3 runs the first draw only")
    del model, params, out, enc
    graphs.clear()
    log(f"    elapsed {time.perf_counter() - t_start:.1f} s")

    log(f"[10] serving: the word model (bf16, sampler='pallas') behind the "
        f"pipeline, the HTTP server and the dynamic batcher (max_batch "
        f"{S_MAX_BATCH}, buckets 'auto')")
    legs["serving"], serving = check_serving(
        CaptioningTransformer, tree_map, _build, (A, C, E, S), dev,
        name_limit)
    log("serving: " + json.dumps(serving))
    graphs.clear()
    log("[11] kernel library build lock")
    check_cold_build()
    log(f"    elapsed {time.perf_counter() - t_start:.1f} s")
    log(f"[12] train: the word model (V {VOCAB}, hid {HID}, {LAYERS} layers, "
        f"bf16, batch {T_BATCH}) from a trunk cache of {T_TEMPLATES} "
        f"templates; then from images, f32 parity with the CPU, the trained "
        f"checkpoint served, and the other captioners")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as logdir:
        legs["train_serve"], train = check_train(
            CaptioningTransformer, tree_map, _build, (A, C, E, S), dev,
            name_limit, logdir)
    log("train: " + json.dumps(train))
    log(f"    train phase {time.perf_counter() - t0:.1f} s; elapsed "
        f"{time.perf_counter() - t_start:.1f} s")
    log(f"[13] parallel: a one-rank NCCL mesh on this card; dp_generate at "
        f"the word leg's width (batch {BATCH}), the word Trainer with the "
        f"mesh, captured beside eager (bf16, batch {T_BATCH}; f32 parity at "
        f"{T_PAR_LAYERS} layers), the DP x TP step and the word decode over "
        f"a one-rank model group captured beside eager, a mesh pipeline "
        f"behind the batcher ({P_REQUESTS} requests)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as logdir:
        legs["parallel"], legs["parallel_serving"], parallel = \
            check_parallel(CaptioningTransformer, tree_map, _build,
                           (A, C, E, S), dev, name_limit, logdir)
    legs["parallel_tp_one"] = parallel.pop("tp_one_launches")
    log("parallel: " + json.dumps(parallel))
    log(f"    parallel phase {time.perf_counter() - t0:.1f} s; elapsed "
        f"{time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    tp = run_tp_phase(A, S, dev, gen, rows, name_limit)
    legs.update({f"tp_rank{r}": x
                 for r, x in enumerate(tp.pop("launches_by_rank"))})
    log("tensor parallel: " + json.dumps(tp))
    log(f"    tensor-parallel phase {time.perf_counter() - t0:.1f} s; "
        f"elapsed {time.perf_counter() - t_start:.1f} s")
    product_legs, product = product_phase(
        CaptioningTransformer, _build, (A, C, E, S), dev, name_limit)
    legs.update(product_legs)
    log("product: " + json.dumps(product))
    for name, paths in product["kernels"].items():
        rows[name]["product"] = paths
    log(f"    elapsed {time.perf_counter() - t_start:.1f} s")
    compiled_legs, compiled = compiled_phase(_build, (A, C, E, S), dev,
                                             name_limit)
    legs.update(compiled_legs)
    log("compiled: " + json.dumps(compiled))
    for name, numbers in compiled["kernels"].items():
        rows[name]["seed_ptr"] = numbers
    for name in rows:
        if name in compiled["device_counts"]:
            rows[name]["count_ptr"] = compiled["device_counts"][name]
    rows["fused_classifier_topk_gumbel_sample"]["count_ptr_streamed"] = {
        k: v for k, v in compiled["device_counts"].items()
        if k.startswith("fused_classifier_topk_gumbel_sample_v")}
    log(f"    elapsed {time.perf_counter() - t_start:.1f} s")
    kimi_legs, kimi = kimi_phase(_build, (A, C, E, S), dev, name_limit)
    legs.update(kimi_legs)
    port_rows = kimi.pop("kernels")
    rows["fused_topk_gumbel_sample"]["streamed"] = port_rows.pop(
        "fused_topk_gumbel_sample_streamed")
    log("kimi: " + json.dumps(kimi))
    log(f"    elapsed {time.perf_counter() - t_start:.1f} s")

    sources = {
        "ancestry_attention_update": (
            "ancestry_attention.cu", "pallas_attention.py:535"),
        "grouped_cross_attention": (
            "cross_attention.cu", "pallas_attention.py:1182"),
        "fused_topk_gumbel_sample": (
            "topk_gumbel.cu", "pallas_sampler.py:303"),
        "fused_classifier_topk_gumbel_sample": (
            "classifier_topk_gumbel.cu", "pallas_sampler.py:376"),
        "ancestry_attention_update_canon": (
            "ancestry_attention_canon.cu", "pallas_attention.py:845"),
        "ancestry_attention_ids": (
            "ancestry_attention_ids.cu", "pallas_attention.py:1015"),
        "cross_attention_packed": (
            "cross_attention.cu", "pallas_attention.py:1275"),
        "fused_survivor_update": (
            "survivor_update.cu", "pallas_engine.py:154"),
        "ancestry_attention": (
            "ancestry_attention_ids.cu", "pallas_attention.py:264"),
        "ancestry_attention_update_flash": (
            "ancestry_attention_flash.cu", "pallas_attention.py:1459"),
        "cache_column_write": (
            "cache_column_write.cu", "pallas_cache.py:64"),
    }
    kernels = []
    for name, (src, tpu) in sources.items():
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deephumor_tpu_torch/ops/csrc/" + src,
            "replaces": "deephumor_tpu/ops/" + tpu,
            "launches": sum(leg.get(name, 0) for leg in legs.values()),
            "launches_by_path": {k: leg.get(name, 0)
                                 for k, leg in legs.items()},
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            # K5 at its second canon shape; K6 at the leg's straggler
            # counts; K1 at the char shape, p_eff 128; K2 and K9 at the
            # char shape, K9 beside K2 on the same rows; K3 at the char
            # shape, in f32, and torch.topk alone; K4 at C_LIVE live rows,
            # beside F.linear + K3 and F.linear alone (partial yardsticks);
            # [14]'s head-local shapes; K3 and K4 at [15]'s shapes, and
            # with the seed and the count in device memory ([16]); K1, K5
            # and K6 on the fused QKV product's views beside contiguous
            # copies, K6 at 96 stragglers with a device count
            **{k: row[k] for k in (
                "ms_strided", "ms_contiguous", "ms_count_ptr",
                "ms_pe128", "ms_leg", "ms_char_pe128", "ms_char",
                "bound_ms_char", "k2_ms", "k2_ms_char", "ms_f32", "topk_ms",
                "ms_live", "bound_ms_live", "linear_ms", "linear_k3_ms",
                "linear_k3_ms_live", "tp", "product", "seed_ptr",
                "count_ptr", "count_ptr_streamed", "streamed")
                if k in row}})
    # kernels of the port alone (no pallas_call behind them), at the
    # kimi_vl.offline cell's shapes ([17])
    port_sources = {"mla_attention": "mla_attention.cu",
                    "moe_gather": "moe.cu", "moe_swiglu": "moe.cu",
                    "moe_combine": "moe.cu"}
    for name, src in port_sources.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deephumor_tpu_torch/ops/csrc/" + src,
            "replaces": None,
            "launches": sum(leg.get(name, 0) for leg in legs.values()),
            "launches_by_path": {k: leg.get(name, 0)
                                 for k, leg in legs.items()},
            **port_rows[name]})
    print(json.dumps({"kernels": kernels}))
    print(f"card: {name_limit}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
