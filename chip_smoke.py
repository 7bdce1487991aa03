"""Smoke run of the PyTorch port (flexdm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. device: a CUDA device is present; prints torch/CUDA versions and the
   card's name and power limit; TF32 off, so float32 means float32;
2. build: compiles the CUDA libraries from ``flexdm_tpu_torch/csrc`` with
   nvcc for sm_90a, one nvcc per source, and the host record decoder
   (``csrc/tfrecord_io.cc``) with g++ at its first use, all at once
   (seconds, printed with the ptxas report and g++'s version, and the bf16
   forward's and backward's and the float32 backward's registers, spills
   and C7520 lines); fails if
   the native decoder is not in use (14(a)); (b) the static hazard check
   of ``tools/torch_sass_hazards.py`` over every kernel instance of the
   four libraries (``cuobjdump -sass``: an HGMMA's register operands or
   accumulators touched before their wait, a TMA copy over shared loads
   still in flight): each instance's registers, spills and hazards; fails
   on any hazard;
3. kernel: the flash-attention forward kernel (split-TF32 products on
   warpgroup wgmma over TMA-fed tiles) against its plain PyTorch version
   on the card (O and lse within 2e-5 abs + 2e-5 rel, float32) at the
   serving, training, crello_flat training and crello_flat ``elem``
   evaluation shapes, S=650, the kernel's tile edges (S = 15, 16, 17, 31,
   32, 33, 63, 64, 65, 97, 128, 129 at Dh 32, 64, 128) and persistent
   streams of more items than SMs, the head dims below the tile widths
   (Dh 8, 16, 20, 25, 48, 96, 120 at (8, 8, 50, Dh) and (2, 4, 500, Dh),
   causal and not, the last fifth of the keys masked; the two-stream
   (33, 8, 70, 25) and (33, 8, 70, 48)), and a second call bitwise equal
   to the first; the forward from a thread with no CUDA context; then kernel,
   plain version and one library call (``scaled_dot_product_attention``, a
   yardstick the port never calls) timed at (8, 8, 50, 32),
   (256, 8, 50, 32), (8, 8, 650, 32), (64, 8, 500, 32),
   (256, 8, 500, 32) and the head dims of ``--latent_dim`` 128 and 384,
   (256, 8, 50, 16) and (256, 8, 50, 48), beside the bound computed from
   the shapes (at the true Dh);
4. backward: the backward kernels (dq with delta, dk/dv; split-TF32
   products on warpgroup wgmma over TMA-fed tiles) through autograd
   against the plain backward and against autograd of the plain forward,
   dq, dk and dv within 1e-4 abs + 1e-4 rel at every shape, S=4096 (the
   regime of the TPU's stream kernels), S=500, the kernels' tile edges
   (S = 16, 17, 32, 33, 64, 65, 128, 129 at Dh 32, 64, 128), two
   streams of uneven items a block and phase 3's head dims included, and
   a second call bitwise equal to the first; (b) the float32 forward, dq
   and dk/dv kernels in autograd's order ``REPEATS`` times at
   (33, 8, 70, 32), causal and not (the two-stream instances at Dh 32),
   every output bitwise against the first call's; then the kernels, the
   plain autograd backward and the library call's backward timed at
   (256, 8, 50, 32), (1, 2, 4096, 64), (64, 8, 500, 32), (256, 8, 50, 16)
   and (256, 8, 50, 48), beside their bounds;
5. slice: the crello Ours-EXP job (D=256, 4 DeepSVG blocks, 8 heads,
   batch 8) with random weights from seed 0 on a synthetic data dir,
   served over HTTP through ``CoalescingEngine``; every answer is checked
   and the kernel's launch count over the requests must cover every
   attention call of every forward pass;
6. parity: the same masked batch through the model on the card (kernel)
   and on the CPU (plain attention); decoder outputs within 1e-4;
7. maskgit: ``/predict`` with ``num_iter=3`` over HTTP (crello Ours-EXP,
   random weights with the decoder heads x8 so the confidences spread,
   batch 8): only masked fields change, >= 3 x 4 forward launches per
   batch, answers equal to the CPU engine's except on documents with a
   field within 1e-5 of a round's threshold or of an argmax tie (counted);
8. train: crello Ours-EXP at full width and batch 256 on a synthetic
   512/64/64 data dir: (i) one step on the card against the same step on
   a CPU copy (dropout 0, same draws): loss, every clipped gradient leaf
   and the updated parameters; (ii) 30 steps on one fixed batch lower the
   loss, timed with CUDA events; (iii) ``python -m flexdm_tpu_torch``'s
   ``main()`` for 2 epochs, every ``history.jsonl`` value finite, and the
   serving engine loads its ``best`` and answers ``/predict``.  Each run
   counts the launches of every kernel: each backward kernel at least once
   per block per step;
9. rico: rico Ours-EXP at batch 256, as 8(i) and 8(ii), the pos-sort loss
   live (near-tie sort-key argmaxes counted);
10. flat: crello_flat (500 (element, field) tokens) at batch 64: 8(i) on
    16 documents (the CPU's plain attention at S=500 is slow), 8(ii), and
    the trained weights served over HTTP;
11. eval: ``python -m flexdm_tpu_torch.evaluation``'s ``main()`` on the
    card at batch 256 over a synthetic 2048-document test split (8 full
    batches): the job of 8(iii) with ``all_feat``, ``elem``, ``random`` and
    ``pos --num_iter 3``, the rico job of 9 with ``pos`` (sorted) and the
    crello_flat job of 10 with ``elem`` (forwards at (256, 8, 500, 32)).
    Each run: timed on the host clock, its CSV read back; the harness on
    the card over the same split, resident (the split decoded, stacked
    and uploaded once into one cache, its MiB and build seconds logged;
    every task a loop over the cache's index blocks with one host fetch)
    and streaming (``resident=False``: each batch stacked and copied),
    both timed, their sums within 2e-5 relative, the resident ones giving
    the CLI's scores, and the forward launched exactly ``num_blocks x
    blocks x num_iter`` times by the harness and by the CLI, as the index
    blocks predict; then card vs CPU on the jobs' 64-document test split
    (crello_flat its first 4 documents), the card at the CLI's batch of
    256 rows: every Σden and numerical Σnum within 1e-4 relative and every
    categorical Σnum equal, apart from rows or fields near a tie
    (counted).
12. bf16 (``--dtype bfloat16``): (a) the bf16 kernel instances against
    their plain bf16 versions at the serving, training and crello_flat
    shapes, S=650, the tile edges (causal, a fully masked row), phase 3's
    head dims (20 and 25 through padded copies) and, for the
    backward, S=4096: O, dq, dk and dv within one bf16 ulp (2^-7 relative)
    plus 2^-8 of the largest reference entry, lse and delta within 2e-5
    abs + 2e-5 rel, a second call bitwise equal; timed beside the plain
    bf16 version, one bf16 ``scaled_dot_product_attention`` call and the
    float32 kernel, with bounds at 2 bytes per bf16 element and the bf16
    tensor-core peak; (b) crello Ours-EXP at batch 256 in bf16: the card's
    decoder outputs (mean |difference|; the largest within twice) and loss
    no farther from the CPU's bf16 ones than the CPU's bf16 ones are from
    its float32 ones, 30 fixed-batch steps that
    track phase 8's float32 losses within 5%, a 2-epoch CLI run with
    ``--dtype bfloat16`` whose ``best`` is served over HTTP and evaluated
    with ``all_feat`` on phase 11's 2048-document split (card against CPU:
    numerical Σnum within one bf16 ulp relative, categorical Σnum equal
    apart from fields whose top two logits lie within four bf16 ulps);
    (c) crello_flat at batch 64 in bf16: (b)'s parity on 16 documents and
    30 timed steps, then ``elem`` over the first 512 documents of phase
    11's split with the trained weights (forwards at (256, 8, 500, 32)),
    resident: 4 bf16 forward launches a forward, the sums finite and equal
    to ``--attention_impl xla`` on the card at bf16's bars.  Every bf16
    path launches only bf16 kernels, every float32 path only float32 ones.
    12(a)'s times: at (8, 8, 50, 32), (256, 8, 50, 32), (64, 8, 500, 32),
    (256, 8, 500, 32), crello_scaled's (2048, 8, 50, 64), (256, 8, 50, 16)
    and (256, 8, 50, 48), each with the
    last fifth of the keys masked and with every key attended (the
    library with no mask then), beside the exponential floor.
13. trainer (crello Ours-EXP, batch 256, the 512/64/64 split of 8): (a)
    the ``Prefetcher`` with the trainer's ``PinnedCopy`` (pinned host
    arrays, a side-stream copy, an event the main stream waits on) over
    two passes of the loader while a training step runs on the main stream
    for each batch: every device batch equal to its host batch; (b) a
    2-epoch ``--input_mode device`` CLI run, ``--resume --num_epochs 3``
    on a copy of its job, against a fresh 3-epoch run: the histories
    within 1e-5 relative; (c) that fresh run with ``--enable_profile``: its
    trace names the forward, dq and dk/dv kernels; (d) one step with
    ``remat`` against the step without it (dropout on): loss within 1e-5
    relative, gradients within 1e-5 + 1e-3 of the leaf's largest entry,
    the forward launched 8 times a step instead of 4; the peak memory of
    a crello_flat step at batch 64 with and without ``remat``; (e) the
    CLI's documents per second from ``history.jsonl`` wall times, host
    mode without the prefetch thread (the parent's loop), host mode with
    it, and device mode, in turns.
14. decode and demo: (a) in phase 2; (b) every record of the first of
    the two shards of phase 11's 2048-document crello and rico test splits
    (1024 records each) decoded by the native decoder equals its
    pure-Python decode, column by column (same dtype and shape), and the
    native scan gives the Python scan's payloads with the CRCs verified
    (by the Python scan too on the rico shard);
    (c) one pass of a fresh loader over each split, the
    crello ``random`` harness (decode included) and the ``DeviceDataCache``
    build over phase 8's 512-record train split, native and pure Python
    in turns A B B A, where a native pass goes (scan, the C++ passes, the
    Python around them, batch stacking), and phase 11's harness times with
    the native decoder; (d) ``python -m flexdm_tpu_torch.demo``'s
    ``main()`` on the card, 8 documents: the float32 crello job of 8(iii)
    with ``pos``, ``elem --num-iter 2`` and ``elem --element 0``, the rico
    job of 9 with ``pos`` and the bf16 job of 12(b) with ``pos``.  Each
    page holds 8 rows of 3 SVGs that parse as XML; its predictions equal a
    CPU ``run_demo`` of the same job and batch (categorical argmaxes equal,
    numerical fields within 1e-4, bf16 one ulp) apart from documents with
    a near tie (counted); the forward of the job's dtype launched at least
    ``num_blocks x num_iter`` times and no other kernel; per-stage times.
15. baselines (crello CanvasVAE, LayoutVAE, AutoReg, BART; D=256, 8
    heads, 4 blocks, batch 64, float32, on the 512/64/64 split of 8): for
    each, (a) one training step on the card against the same step on a
    CPU copy, 16 documents (LayoutVAE 4; dropout 0, the same draws and VAE
    normals): the loss and its KL and length terms within 1e-5 relative,
    gradients as in 8(i); (b) 5 timed steps (LayoutVAE 2) with CUDA
    events, the peak memory and a ``torch.profiler`` window; (c) ``python
    -m flexdm_tpu_torch --preset crello_<name>`` for one epoch in device
    mode (validated; ``best``, ``last``, ``final``; LayoutVAE on a
    128/64/64 split of its own, 2 steps); (d) ``random`` and ``elem`` (AutoReg, BART,
    LayoutVAE: the queried element moved last) over the job's 64 test
    documents on the card against the CPU (``elem`` on the first 2), sums
    as in 11, whole rows near a tie allowed (a decode commits its
    argmaxes; CanvasVAE decodes an argmaxed length); (e) one ``/predict``
    of 8 documents over HTTP.  Every path's launches are exact: 4 / 200 /
    4 / 6 forward launches and as many of dq and of dk/dv per training
    step, 4 / 200 / 200 / 202 per eval forward; the plain attention never
    runs on the card.  Then the causal kernels alone at (64, 8, 50, 32),
    against their plain versions and timed beside them, the library call
    with the same causal key mask, and the bounds of the causal band.
16. more than one device (crello Ours-EXP, D=256, 4 blocks, 8 heads,
    global batch 256, float32, random weights from seed 0, dropout on, on
    the 512/64/64 split of 8): (a) ``python -m flexdm_tpu_torch
    --num_devices 1`` (NCCL, world size 1) for 2 epochs: its history and
    best/final/last bitwise the run without a process group, both under
    ``torch.use_deterministic_algorithms`` (``CUBLAS_WORKSPACE_CONFIG``
    is set for the whole script), where two runs alone are bitwise each
    other too; (b) 2
    data-parallel ranks on ``cuda:0`` under gloo, 3 steps on one fixed
    batch, against the single-process run of the same global batch: loss
    within 1e-5 relative, step 1's clipped gradients and every step's
    parameters within 1e-5 + 1e-3 of the leaf's largest entry (the
    attention key biases, zero-gradient in exact arithmetic: noise below
    1e-3, parameters within 2 lr a step); the ranks' parameters bitwise
    equal after every step; forward, dq and dk/dv launched exactly 4
    times per rank per step at (128, 8, 50, 32); (c) one data rank by 2
    model ranks (tensor-parallel), held to (b) at the same gate, launches
    4/4/4 per rank at (256, 4, 50, 32); each rank's step median (CUDA
    events, 20 steps), peak memory and one all-reduce's time; (d) a
    data-parallel job through ``train(..., devices=["cuda:0"] * 2,
    backend="gloo")``, scored with ``all_feat`` over phase 11's
    2048-document split by ``python -m flexdm_tpu_torch.evaluation
    --num_devices 2`` and alone (timed), the 2 ranks' sums (each from a
    cache of its own 1024 records, the only ones it decoded) against the
    sums alone (near ties counted), its ``best`` served alone; (e) on a
    machine with 2 cards, data parallelism under NCCL held to (b), else a
    line saying why not; (f) each baseline (CanvasVAE, LayoutVAE, AutoReg,
    BART at their presets, batch 64, dropout and VAE noise on)
    tensor-parallel on one data rank by 2 model ranks (gloo on one card,
    NCCL on two where there are two), all four in one spawn: 3 steps
    (LayoutVAE 2) held to the run alone at (c)'s gate, the ranks bitwise equal, the
    forward, dq and dk/dv launched 4 / 200 / 4 / 6 times a rank a step at
    (64, 4, 50, 32), as alone; then AutoReg's ``elem`` over 8 documents
    of phase 15's job on the grid against alone (near ties counted, the
    ranks equal, 200 launches a forward a rank); then the kernels timed
    at the per-rank shapes (128, 8, 50, 32), (256, 4, 50, 32),
    crello_flat's (32, 8, 500, 32) and the baselines' (64, 4, 50, 32)
    beside their bounds, and the causal kernels checked and timed at
    (64, 4, 50, 32).  Every spawned group has a hard time limit; a
    failing rank fails the phase.
17. the rest of the entry points (crello Ours-EXP at full width, batch
    256): (a) ``--attention_impl``: one step with ``xla`` (the plain
    attention on the card) against one with ``pallas`` (the kernels) on
    the same batch and draws, dropout 0, at 8(i)'s gate (loss 1e-5
    relative, gradients 1e-5 + 1e-3 of the leaf's largest entry, the key
    biases noise below 1e-3): ``pallas`` launches 4 forward, 4 dq and 4
    dk/dv a step and never the plain version, ``xla`` no kernel; a
    ``--dtype bfloat16`` ``pallas`` step only bf16 kernels; a 1-epoch CLI
    job trained with ``xla`` (no launch; ``args.json`` records it), its
    ``/predict`` (no launch), and ``all_feat`` over phase 11's split as
    recorded and with ``--attention_impl pallas``: the second launches the
    forward exactly ``num_blocks x blocks`` times, the sums as in 11 at
    ``EVAL_RTOL`` (near ties counted); (b) two "nodes" sharing the card
    under gloo (processes with the variables of ``torchrun --nnodes 2``,
    ``tests/_torch_node_worker.py``): ``python -m flexdm_tpu_torch
    --num_devices 2`` for 2 epochs on 8's split (device mode falls back to
    host mode, warned), then the eval CLI's ``all_feat`` over phase 11's
    split, streaming: the ranks' histories, test metrics and sums bitwise
    equal, only rank 0 writes, the run against one process fed the same
    global batches (training fields 1e-5, validation and test metrics
    ``EVAL_RTOL``) and the sums against the harness alone (``PATHS_RTOL``,
    near ties counted); each rank's step ms and seconds to its group and
    first step; (c) the tools at full width: ``torch_profile_step`` in
    float32 and bf16, ``torch_bench_attention`` at (256, 8, 50, 32) and
    (64, 8, 500, 32) in both dtypes, ``torch_bench_serve`` and
    ``torch_profile_demo`` on 8(iii)'s job, ``torch_train_baselines``
    for CanvasVAE, AutoReg and BART (1 epoch on 512 documents; LayoutVAE
    runs in 15).
18. raw crello ingestion to jobs (20000 raw templates from
    ``tools/torch_scale_drill.make_raw_dump``, release scale): (a)
    ``tools/torch_build_crello_dataset.py`` builds them: every template
    kept and counted in ``count.json``, each split non-empty,
    ``vocabulary.json`` naming every element type of the dump, a batch of
    256 from the port's ``DatasetSpec`` with ``left`` of shape (256, 50, 1),
    no position column with one value across 64 documents; (b)
    ``tools/torch_scale_drill.py`` at full width (D=256, 4 blocks, batch
    256, bf16) for 1 epoch: its dump and its build (the builder's second
    run) byte-equal to (a)'s, resident ``pos`` sums equal to streaming
    ones, the bf16 dq and dk/dv launched 4 times a step and the forward at
    least as often, no float32 kernel, the demo page written; (c)
    ``tools/torch_capstone.py`` on that corpus (reused) at full width,
    batch 256, float32: IMP, EXP and EXP-FT (warm-started from IMP's
    ``best``: its ``args.json`` names it and its first loss is not EXP's)
    for 2 epochs each, every loss finite, dq and dk/dv 4 a step; the seven
    eval runs of each with finite scores in [0, 1], MaskGIT ``elem``
    (``--num_iter 4``) launching the forward 4 times as often as
    ``elem``; (d) ``notebooks/demo_{crello,rico}_torch.ipynb`` through
    ``flexdm_tpu_torch.utils.notebook`` on the card (a toy job trained
    there first): at least 2 HTML outputs each, the forward launched.
    Each part prints its seconds.
19. head dims (run before 18): crello Ours-EXP (4 blocks, 8 heads, S=50,
    batch 256, the 512/64/64 split of 8) at ``--latent_dim`` 128 and 384
    (Dh 16 and 48, widths no preset has), ``--attention_impl pallas``
    against ``xla``: (a) one step (dropout 0, the same draws) at 8(i)'s
    gate, at 384 in bf16 too (no farther from the plain bf16 step than
    that is from float32); (b) ``python -m flexdm_tpu_torch`` for one
    epoch with a validation in float32 (and bf16 at 384), the histories
    within 1e-5 (training) and ``EVAL_RTOL`` (validation; bf16 one ulp);
    (c) the eval CLI's ``elem`` and ``all_feat`` on the pallas job over
    its 64 test documents, as 11 (near ties counted); (d) ``/predict`` of
    8 documents with ``num_iter`` 1 and 3 over HTTP against an engine on
    a copy of the job recording ``xla`` (decoder outputs within 1e-4,
    answers equal but for near ties).  Launches exact: the forward once
    for every attention call of the ``xla`` run, 4 of each backward kernel
    a step, 4 x ``num_iter`` a request.
Each step phase ends with a ``torch.profiler`` window: device kernel time
per step, its attention share and the busiest kernels.

The last lines are one JSON object per kernel, float32 and bf16 instances
(times at the training shape (256, 8, 50, 32), the float32 kernels' causal
figures at (64, 8, 50, 32) under ``causal``; ``launches`` from the
training CLI run of the instance's dtype and ``launches_by_path`` from
each training path's 30 steps, each eval path's CLI runs, each
trainer path of phase 13, the demo runs of phase 14, each baseline's
steps, CLI run and evaluation of phase 15 and one rank's step of phase
16's layouts and of each baseline's tensor-parallel step; a float32
kernel's ``multi_device`` times at phase 16's per-rank shapes, the
baselines' causal one too; the launches of phase 17's, 18's and 19's
paths too; each kernel's ``head_dims`` times at (256, 8, 50, 16) and
(256, 8, 50, 48)), the card's name and power limit from nvidia-smi, and
``{"ok": true,
"device": {...}}``.
"""

import copy
import csv
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

KERNEL_TOL = dict(atol=2e-5, rtol=2e-5)
BACKWARD_TOL = dict(atol=1e-4, rtol=1e-4)  # every shape, S=4096 included
SLICE_TOL = dict(atol=1e-4, rtol=1e-4)
BATCH = 8
TRAIN_BATCH = 256
TRAIN_STEPS = 30
TIMED_STEPS = 20
CONFIG = "configs/crello_ours_exp.json"
RICO_CONFIG = "configs/rico_ours_exp.json"
FLAT_CONFIG = "configs/crello_flat.json"
FLAT_BATCH = 64  # crello_flat's published batch
FLAT_PARITY_DOCS = 16  # the CPU copy's plain attention at S=500 is slow
MASKGIT_ITERS = 3
NEAR_TIE = 1e-5
# The shapes every kernel is timed at: serving, training, crello_flat.
FLAT_SHAPE = (64, 8, 500, 32)
EVAL_BATCH = 256  # the eval CLI's default batch
EVAL_FLAT_SHAPE = (EVAL_BATCH, 8, 500, 32)  # a crello_flat ``elem`` chunk
EVAL_DOCS = 2048  # the timed eval split: 8 full batches of EVAL_BATCH
EVAL_RTOL = 1e-4  # card vs CPU: Σden and numerical Σnum of the eval sums
PATHS_RTOL = 2e-5  # resident vs streaming sums (JAX's bar for its paths)
ELEM_CHUNK = 256  # the harness's default replicas an ``elem`` forward
FLAT_EVAL_DOCS = 4  # crello_flat eval compared on 4 documents (S=500 on CPU)
BF16 = "bfloat16"
BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative
# Top two logits this close (relative) make a near tie in bf16: the card's
# and the CPU's bf16 logits differ by a few ulps once a flipped rounding
# has travelled through the blocks.
BF16_TIE = 4 * BF16_ULP
F32_KERNELS = ("fwd", "dq", "dkv")
BF16_KERNELS = ("fwd_bf16", "dq_bf16", "dkv_bf16")
# Head dims below the kernels' tile widths (every Dh from 1 to 128 runs on
# tiles 32, 64 or 128 wide, zero-filled past Dh): 20 direct in float32 and
# copied onto padded rows in bf16, 25 copied in both, 96 a column block
# wholly past the row.  Checked at HEAD_DIM_SHAPES (B, H, S) + (Dh,),
# causal and not, the last fifth of the keys masked; the float32 two-stream
# instances at HEAD_DIM_STREAMS (more items than SMs, W = 32 and 64).
HEAD_DIMS = (8, 16, 20, 25, 48, 96, 120)
HEAD_DIM_SHAPES = ((8, 8, 50), (2, 4, 500))
HEAD_DIM_STREAMS = ((33, 8, 70, 25), (33, 8, 70, 48))
# 4(b): the kernels repeated at the two-stream Dh 32 shape.
REPEAT_SHAPE = (33, 8, 70, 32)
REPEATS = 10000
# The head dims of crello Ours-EXP at --latent_dim 128 and 384 (8 heads),
# timed at the training batch.
HEAD_DIM_TIMED = ((TRAIN_BATCH, 8, 50, 16), (TRAIN_BATCH, 8, 50, 48))
HEAD_DIM_LATENTS = (128, 384)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, samples=50, inner=20, warmup=10):
    """Median over ``samples`` of the mean time of ``inner`` back-to-back
    calls from Python, between CUDA events (warm).  For a kernel of a few
    microseconds this is bound by how fast the host issues the calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _median_event_ms(lambda: [fn() for _ in range(inner)], samples) / inner


def device_ms(fn, samples=50, inner=20):
    """Device time of one call: ``inner`` calls captured in a CUDA graph,
    replayed ``samples`` times between CUDA events (no host issue cost)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_event_ms(graph.replay, samples) / inner


def _median_event_ms(run, samples):
    import torch

    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def build_native_decoder():
    """14(a): the C++ record decoder, built with g++ from the checkout at
    its first use (before any loader of this run); seconds taken."""
    from flexdm_tpu_torch.data import tfrecord
    from flexdm_tpu_torch.ops import _build

    check(_build.find_cxx() is not None,
          "no host C++ compiler: the native record decoder cannot be built")
    t0 = time.perf_counter()
    check(tfrecord.native_available(), "the native record decoder is off")
    return time.perf_counter() - t0


def phase_build():
    """Every kernel library, one nvcc each, and the host record decoder
    (g++), all started together."""
    from flexdm_tpu_torch.data import tfrecord
    from flexdm_tpu_torch.ops import _build
    from flexdm_tpu_torch.ops import attention as attn

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(attn.LIBRARIES) + 1) as pool:
        native = pool.submit(build_native_decoder)
        list(pool.map(lambda lib: _build.build_library(*lib), attn.LIBRARIES))
        native_s = native.result()
    cxx = _build.find_cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, check=True).stdout.splitlines()[0]
    log(f"[build] {tfrecord.NATIVE_SOURCE.name} -> host library with "
        f"{version} ({' '.join(_build.CXX_FLAGS)}) in {native_s:.2f} s; "
        f"native decoder in use: {tfrecord.native_available()}")
    for dtype in attn.KERNEL_DTYPES:
        attn._kernel(dtype)
        attn._bwd_kernels(dtype)
    log(f"[build] {', '.join(src for _, lib in attn.LIBRARIES for src in lib)}"
        f" -> sm_90a in {time.perf_counter() - t0:.2f} s")
    for name, _ in attn.LIBRARIES:
        log(_build.BUILD_LOGS.get(name, f"{name}: (reused build)").strip())
    for label, lib in (("bf16 forward", attn.FWD_BF16_LIBRARY),
                       ("bf16 backward", attn.BWD_BF16_LIBRARY),
                       ("float32 forward", attn.FWD_LIBRARY),
                       ("float32 backward", attn.BWD_LIBRARY)):
        log(f"[build] {label} kernels (ptxas): " + "; ".join(
            ptxas_summary(_build.BUILD_LOGS.get(lib[0], ""))))
    sass_hazards()


def sass_hazards():
    """2(b): ``tools/torch_sass_hazards.py`` over every instance of the four
    libraries (``cuobjdump -sass``): registers, spills and hazards an
    instance; any hazard fails the run."""
    from flexdm_tpu_torch.ops import _build
    from flexdm_tpu_torch.ops import attention as attn
    from tools import torch_sass_hazards as hz

    t0 = time.perf_counter()
    reports = hz.check_dumps({
        name: (hz.cuobjdump_sass(_build.build_library(name, sources)),
               _build.BUILD_LOGS.get(name, ""))
        for name, sources in attn.LIBRARIES})
    total = sum(hz.log_report(name, report, log=log)
                for name, report in reports.items())
    log(f"[hazards] {total} hazards in the four libraries "
        f"({time.perf_counter() - t0:.1f} s)")
    check(total == 0, f"{total} hazards in the kernels' SASS")


def ptxas_summary(report):
    """``kernel<args>: N registers, S bytes spilled`` per kernel of a ptxas
    report (``-Xptxas -v``), spills as the larger of stores and loads, and
    any C7520 line (wgmma serialised) with the end of its text."""
    import re

    out, name, spill = [], None, 0
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '\S*?\d(flash_\w+?"
                          r"_kernel)(I(?:L[ib]\d+E)+)?", line)
        if entry:
            args = re.findall(r"L[ib](\d+)E", entry.group(2) or "")
            name = entry.group(1) + (f"<{','.join(args)}>" if args else "")
        if "C7520" in line:
            fn = re.search(r"\d(flash_\w+?_kernel)(I(?:L[ib]\d+E)+)?", line)
            why = re.search(r"due to (.*?) in the function", line)
            args = re.findall(r"L[ib](\d+)E", fn.group(2) or "") if fn else []
            out.append(f"C7520 in {fn.group(1) if fn else '?'}"
                       f"<{','.join(args)}>: "
                       f"{why.group(1) if why else line.strip()}")
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        if spills:
            spill = max(map(int, spills.groups()))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            out.append(f"{name}: {regs.group(1)} registers, {spill} bytes "
                       "spilled")
            name, spill = None, 0
    return out or ["(no ptxas report: reused build)"]


def phase_kernel(card):
    import torch

    from flexdm_tpu_torch.ops import attention as attn

    g = torch.Generator().manual_seed(0)
    cases = [  # (B, H, S, Dh), causal, fully masked last batch row
        ((8, 8, 50, 32), False, False),
        ((8, 8, 50, 32), True, False),
        ((8, 8, 50, 32), False, True),
        ((2, 8, 51, 32), False, False),
        ((2, 8, 51, 32), True, True),
        ((2, 4, 512, 64), False, False),
        ((2, 4, 512, 64), True, False),
        ((2, 4, 650, 32), False, True),
        ((2, 4, 650, 32), True, False),
        ((256, 8, 50, 32), False, True),
        (FLAT_SHAPE, False, True),
        (EVAL_FLAT_SHAPE, False, True),
    ]
    # The kernel's tile edges: items of 64 query rows; K/V tiles of 64 keys
    # at Dh=32, 32 at Dh=64, 16 at Dh=128.
    cases += [((2, 2, s, dh), causal, True)
              for s in (15, 16, 17, 31, 32, 33, 63, 64, 65, 97, 128, 129)
              for dh in (32, 64, 128) for causal in (False, True)]
    # Persistent streams: items outnumbering the SMs (two streams a block
    # at Dh <= 64, uneven counts; one at Dh = 128), several items a block.
    cases += [((33, 8, 70, 32), False, True), ((33, 8, 70, 32), True, True),
              ((17, 16, 130, 64), True, True),
              ((9, 8, 130, 128), False, True)]
    worst = 0.0
    for shape, causal, mask in head_dim_cases(cases, g):
        b, h, s, dh = shape
        q, k, v = (torch.randn(shape, generator=g).cuda() for _ in range(3))
        fully_masked = not mask[-1].any().item()
        o, lse = attn.flash_attention_forward(q, k, v, mask, causal)
        again = attn.flash_attention_forward(q, k, v, mask, causal)
        bias = attn.key_bias(mask, b, s, q.device)
        ref_o = attn.attention_reference(q, k, v, bias, causal)
        ref_lse = attn.attention_reference_lse(q, k, bias, causal)
        torch.cuda.synchronize()
        err_o = (o - ref_o).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        worst = max(worst, err_o, err_lse)
        log(f"[kernel] {shape} causal={causal} fully_masked_row="
            f"{fully_masked}: max|dO|={err_o:.3e} max|dlse|={err_lse:.3e} "
            f"(bound 2e-5 abs + 2e-5 rel); a second call bitwise equal")
        check(torch.isfinite(o).all().item(), f"non-finite O at {shape}")
        check(torch.allclose(o, ref_o, **KERNEL_TOL), f"O differs at {shape}")
        check(torch.allclose(lse, ref_lse, **KERNEL_TOL),
              f"lse differs at {shape}")
        check(torch.equal(o, again[0]) and torch.equal(lse, again[1]),
              f"two forward calls differ at {shape} causal={causal}")

    forward_off_thread(g)
    timings = {shape: forward_times(shape, g, card)
               for shape in ((8, 8, 50, 32), (256, 8, 50, 32), (8, 8, 650, 32),
                             FLAT_SHAPE, EVAL_FLAT_SHAPE) + HEAD_DIM_TIMED}
    return worst, timings


def fifth_masked(b, s):
    """A ``(B, S)`` key mask on the card dropping the last fifth of the
    keys."""
    import torch

    mask = torch.ones(b, s, dtype=torch.bool)
    mask[:, s - s // 5:] = False
    return mask.cuda()


def head_dim_cases(cases, g, streams=HEAD_DIM_STREAMS):
    """``(shape, causal, mask)`` of each of ``cases`` (``(shape, causal,
    fully masked last batch row)``: a random mask keeping key 0 of every
    row), then of the head dims below the tile widths: ``HEAD_DIMS`` at
    ``HEAD_DIM_SHAPES`` and ``streams``, causal and not, the last fifth of
    the keys masked."""
    import torch

    for shape, causal, fully_masked in cases:
        b, _, s, _ = shape
        mask = torch.rand(b, s, generator=g) > 0.3
        mask[:, 0] = True
        if fully_masked:
            mask[-1] = False
        yield shape, causal, mask.cuda()
    for shape in [bhs + (dh,) for dh in HEAD_DIMS
                  for bhs in HEAD_DIM_SHAPES] + list(streams):
        for causal in (False, True):
            yield shape, causal, fifth_masked(shape[0], shape[2])


def forward_off_thread(g):
    """The serving engine's case: the forward launched from a thread that
    has made no CUDA call of its own (no current context; the tensor maps'
    encode needs one) equals the calling thread's, bitwise."""
    import torch

    from flexdm_tpu_torch.ops import attention as attn

    shape = (8, 8, 50, 32)
    q, k, v = (torch.randn(shape, generator=g).cuda() for _ in range(3))
    mask = (torch.rand(shape[0], shape[2], generator=g) > 0.3).cuda()
    want = attn._forward(q, k, v, mask, False)
    torch.cuda.synchronize()
    out = {}

    def run():
        try:
            out["got"] = attn._forward(q, k, v, mask, False)
            torch.cuda.synchronize()
        except Exception as e:  # reported below, in the calling thread
            out["err"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=120)
    check(not thread.is_alive(), "the forward off the main thread hangs")
    check("err" not in out, f"forward off the main thread: {out.get('err')}")
    check(all(torch.equal(x, y) for x, y in zip(out["got"], want)),
          "the forward off the main thread differs from the main thread's")
    log("[kernel] the forward from a thread with no CUDA context: bitwise "
        "the calling thread's")


def forward_times(shape, g, card):
    """The forward kernel, its plain version and the library call at
    ``shape`` (a key mask dropping the last fifth of the keys), device
    time from CUDA graphs, beside the bound; logged."""
    import torch
    import torch.nn.functional as F

    from flexdm_tpu_torch.ops import attention as attn

    b, h, s, dh = shape
    q, k, v = (torch.randn(shape, generator=g).cuda() for _ in range(3))
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[:, s - s // 5:] = False
    mask = mask.cuda()
    bias = attn.key_bias(mask, b, s, q.device)
    sdpa_mask = bias[:, None, None, :]
    kernel = lambda: attn.flash_attention_forward(q, k, v, mask)  # noqa: E731
    plain = lambda: attn.attention_reference(q, k, v, bias)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=sdpa_mask)
    t = {"ms": device_ms(kernel), "plain_ms": device_ms(plain),
         "library_ms": device_ms(library)}
    t.update(forward_bound(shape))
    log(f"[time] attention {shape} device time (CUDA graph of 20 calls, "
        f"median of 50): kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, library (scaled_dot_product_attention"
        f", O only; {sdpa_kernels(library)}) {t['library_ms']:.4f} ms; "
        f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}; FP32 pipes "
        f"{t['fp32_bound_ms']:.4f} ms) [{card}]")
    log(f"[time] attention {shape} per call from Python (median of "
        f"50 x 20): kernel {time_ms(kernel):.4f} ms, plain "
        f"{time_ms(plain):.4f} ms [{card}]")
    return t


# Peaks of one NVIDIA H100 SXM (data sheet, dense): HBM bytes/s, TF32 and
# bf16 tensor-core and FP32 (FMA pipe) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989.4e12
FP32_FLOPS = 67e12


def bound(nbytes, flops, peak=TF32_FLOPS):
    """The least time (ms) for ``nbytes`` of device-memory traffic and
    ``flops`` of tensor-core work at ``peak`` (TF32 by default), and which
    of the two sets it, beside the same work on the FP32 pipes."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "fp32_bound_ms": max(t_bytes, flops / FP32_FLOPS * 1e3)}


# Exponentials an SM of sm_90 returns a clock (MUFU.EX2: 16).
EXPS_PER_SM_CLOCK = 16


def attention_exps(shape, causal=False):
    """Exponentials one pass over every (row, key) score of ``shape``
    needs: B H S^2, the causal band's (S + 1) / 2S of them with
    ``causal``."""
    b, h, s, _ = shape
    n = b * h * s * s
    return n * (s + 1) // (2 * s) if causal else n


@functools.lru_cache(maxsize=None)
def card_sm_rate():
    """(SMs, the largest SM clock in MHz) of card 0: ``torch`` and
    ``nvidia-smi --query-gpu=clocks.max.sm``."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count, mhz


def exp_floor_ms(n_exps, sms=None, mhz=None):
    """The least time (ms) for ``n_exps`` exponentials on the SFUs: 16 a
    clock an SM, over the card's SMs at its largest SM clock (those of
    card 0 unless given)."""
    if sms is None:
        sms, mhz = card_sm_rate()
    return n_exps / (EXPS_PER_SM_CLOCK * sms * mhz * 1e6) * 1e3


def forward_bound(shape, itemsize=4, peak=TF32_FLOPS):
    """Reads q, k, v and the (B, S) byte mask; writes O and (float32) lse,
    m, l.  Two products of 2 S^2 Dh FLOPs per (batch, head).  ``itemsize``:
    bytes per element of q, k, v and O (2 for bf16, with ``BF16_FLOPS``).
    Beside the bound, ``exp_floor_ms``: one exponential a score."""
    b, h, s, dh = shape
    rows = b * h * s
    return dict(bound(itemsize * 4 * rows * dh + 4 * 3 * rows + b * s,
                      4 * b * h * s * s * dh, peak),
                exp_floor_ms=exp_floor_ms(attention_exps(shape)))


def backward_bounds(shape, itemsize=4, peak=TF32_FLOPS):
    """dq: reads q, k, v, o, dO, m, l, mask, writes dq, delta; 3 products.
    dk/dv: reads q, k, v, dO, m, l, delta, mask, writes dk, dv; 4 products
    (2 S^2 Dh FLOPs each).  m, l and delta are float32.  Each kernel forms
    p once: one exponential a score each (``exp_floor_ms``)."""
    b, h, s, dh = shape
    rows = b * h * s
    product = 2 * b * h * s * s * dh
    nbytes = itemsize * 6 * rows * dh + 4 * 3 * rows + b * s
    floor = exp_floor_ms(attention_exps(shape))
    return (dict(bound(nbytes, 3 * product, peak), exp_floor_ms=floor),
            dict(bound(nbytes, 4 * product, peak), exp_floor_ms=floor))


def sdpa_kernels(fn):
    """The device kernels one call of ``fn`` runs (which backend of
    ``scaled_dot_product_attention`` served it), from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({e.name for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
    except Exception as e:  # the label only; the timing stands without it
        return f"kernels not read: {type(e).__name__}"
    return "kernels " + ", ".join(n[:60] for n in names) if names else \
        "no device kernel seen by the profiler"


def load_args(config, data_dir):
    """A preset of ``configs/`` pointing at ``data_dir``."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, config)) as f:
        args = json.load(f)
    args["data_dir"] = data_dir
    return args


def write_job(job, args, model):
    """A job dir: ``args.json`` and ``model``'s weights as ``best``."""
    from flexdm_tpu_torch.convert import save_weights

    os.makedirs(os.path.join(job, "checkpoints"))
    with open(os.path.join(job, "args.json"), "w") as f:
        json.dump(args, f)
    save_weights(os.path.join(job, "checkpoints", "best.torch.npz"), model)


def make_job(root, name="job", decoder_scale=1.0):
    """A crello data dir and an Ours-EXP job with port weights (seed 0);
    ``decoder_scale`` multiplies the decoder heads' kernels (peakier
    softmaxes, so MaskGIT confidences spread out)."""
    import torch

    from flexdm_tpu_torch.data import DatasetSpec, synthetic

    from flexdm_tpu_torch.config import TrainConfig, build_model
    from flexdm_tpu_torch.convert import init_params

    data_dir = synthetic.generate(
        "crello", os.path.join(root, name + "_data"), 64, 16, 16, seed=0
    )
    args = load_args(CONFIG, data_dir)
    spec = DatasetSpec("crello", data_dir, BATCH)
    model = init_params(build_model(TrainConfig.from_args(args), spec.schema), 0)
    with torch.no_grad():
        for head in model.decoder.children():
            head.weight.mul_(decoder_scale)
    job = os.path.join(root, name)
    write_job(job, args, model)
    return job, spec


def finite(x):
    if isinstance(x, float):
        return math.isfinite(x)
    if isinstance(x, dict):
        return all(finite(v) for v in x.values())
    if isinstance(x, list):
        return all(finite(v) for v in x)
    return True


def http(port, path, payload=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    t0 = time.perf_counter()
    with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                timeout=120) as r:
        check(r.status == 200, f"{path} answered {r.status}")
        body = json.load(r)
    return body, time.perf_counter() - t0


def check_predictions(spec, task, docs, preds, fields="all", element=None):
    schema = spec.schema
    check(len(preds) == len(docs), f"{task}: {len(preds)} docs for {len(docs)}")
    if task == "elem":
        in_scope = {c.name for c in schema.sequence_columns}
    else:
        in_scope = set(schema.attribute_groups[task])
    for doc, pred in zip(docs, preds):
        check(finite(pred), f"{task}: non-finite prediction")
        check(len(pred["elements"]) == len(doc["elements"]),
              f"{task}: element count changed")
        for i, (el_in, el_out) in enumerate(
                zip(doc["elements"], pred["elements"])):
            if fields == "changed":
                check(set(el_out) == in_scope, f"{task}: fields {set(el_out)}")
                continue
            for name, value in el_in.items():
                if name not in in_scope or (element is not None and i != element):
                    check(el_out[name] == value,
                          f"{task}: out-of-scope {name} of element {i} changed")
        if fields == "all":
            for name in doc:
                if name != "elements":
                    check(pred[name] == doc[name], f"{task}: canvas {name}")


def phase_slice(card):
    import torch

    from flexdm_tpu_torch.data import split_device_batch

    from flexdm_tpu_torch.ops import attention as attn
    from flexdm_tpu_torch.serve import CoalescingEngine, InferenceEngine, \
        _jsonable, serve

    with tempfile.TemporaryDirectory() as root:
        job, spec = make_job(root)
        engine = InferenceEngine(job, batch_size=BATCH, device="cuda")
        num_blocks = len(list(engine.model.blocks.children()))
        log(f"[slice] warmup {engine.warmup([('pos', 1), ('elem', 1)])}")
        docs = _jsonable(spec.unbatch(split_device_batch(
            next(iter(spec.make_dataset("test", batch_size=9))))))
        server = serve(CoalescingEngine(engine, window_ms=3.0), port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            port = server.server_address[1]
            health, _ = http(port, "/healthz")
            check(health == {"status": "ok"}, f"/healthz said {health}")
            info, _ = http(port, "/schema")
            check(info["dataset"] == "crello" and "txt" in info["tasks"],
                  f"/schema said {info}")

            requests = [
                ("pos", docs[:8], {}),
                ("attr", docs[:8], {}),
                ("txt", docs[:8], {"fields": "changed"}),
                ("elem", docs[:8], {"element": 0}),
                ("elem", docs[:8], {"seed": 5}),
                ("pos", docs[:9], {}),
            ]
            passes = 0
            attn.reset_launch_counts()
            for task, batch_docs, extra in requests:
                body, seconds = http(port, "/predict", dict(
                    task=task, documents=batch_docs, **extra))
                check_predictions(spec, task, batch_docs, body["predictions"],
                                  extra.get("fields", "all"),
                                  extra.get("element"))
                passes += -(-len(batch_docs) // BATCH)
                log(f"[slice] {task} {extra} x{len(batch_docs)} docs: 200 in "
                    f"{seconds * 1e3:.1f} ms")
            latency = {}
            for n in (1, 8):
                times = []
                for _ in range(20):
                    body, seconds = http(port, "/predict", dict(
                        task="pos", documents=docs[:n]))
                    check_predictions(spec, "pos", docs[:n], body["predictions"])
                    times.append(seconds * 1e3)
                    passes += 1
                latency[n] = statistics.median(times)
            launches = attn.KERNEL_LAUNCHES
            check_one_instance(launch_counts(), None, "slice")
        finally:
            server.shutdown()
            server.server_close()
        log(f"[slice] kernel launches {launches} over {passes} forward passes "
            f"x {num_blocks} blocks; no bf16 kernel launched")
        check(launches >= num_blocks * passes,
              f"kernel launched {launches} times for {passes} passes")
        for n, ms in latency.items():
            log(f"[time] HTTP /predict pos, {n} doc(s), warm: median "
                f"{ms:.2f} ms of 20 [{card}]")
        forward_ms, forward_device_ms, worst = phase_parity(
            engine, spec, docs[:8])
        log(f"[time] MFPModel forward at batch {BATCH}: {forward_ms:.3f} ms "
            f"per call from Python, {forward_device_ms:.3f} ms device time "
            f"(CUDA graph) [{card}]")
        return launches, latency, worst


def phase_parity(engine, spec, docs):
    """Model on the card (kernel) vs a CPU copy (plain attention)."""
    import torch

    from flexdm_tpu_torch.demo import build_task_masks
    from flexdm_tpu_torch.models.masking import preprocess_for_test

    schema = spec.schema
    batch = spec.batch_documents(docs)
    host = {k: torch.from_numpy(v) for k, v in batch.items()
            if v.dtype != object}
    cpu_model = copy.deepcopy(engine.model).cpu()
    worst = 0.0
    with torch.inference_mode():
        for task in ("pos", "elem"):
            masks = build_task_masks(schema, host, task)
            inputs = preprocess_for_test(host, schema, masks)
            want = cpu_model(inputs)
            dev_inputs = {k: v.cuda() for k, v in inputs.items()}
            got = engine.model(dev_inputs)
            for name, value in want.items():
                err = (got[name].cpu() - value).abs().max().item()
                worst = max(worst, err)
                check(torch.allclose(got[name].cpu(), value, **SLICE_TOL),
                      f"{task}/{name}: card and CPU differ by {err}")
        log(f"[parity] decoder outputs, card vs CPU: max abs diff {worst:.3e}")
        forward_ms = time_ms(lambda: engine.model(dev_inputs))
        forward_device_ms = device_ms(lambda: engine.model(dev_inputs))
    return forward_ms, forward_device_ms, worst


def phase_backward(card):
    """The backward kernels against the plain backward; returns the worst
    error per kernel and the timings."""
    import torch

    from flexdm_tpu_torch.ops import attention as attn

    g = torch.Generator().manual_seed(1)
    cases = [  # (B, H, S, Dh), causal, fully masked last batch row
        ((256, 8, 50, 32), False, False),
        ((8, 8, 51, 32), True, False),
        ((8, 8, 50, 32), False, True),
        ((8, 8, 51, 32), True, True),
        ((2, 4, 512, 64), False, False),
        ((2, 4, 650, 32), True, True),
        ((2, 2, 128, 128), False, True),
        ((1, 2, 4096, 64), False, False),
        ((1, 2, 4096, 64), True, True),
        (FLAT_SHAPE, False, True),
    ]
    # The kernels' tile edges: items of 64 rows or keys, tiles of the other
    # axis of 32 (16 at Dh=128).
    cases += [((2, 2, s, dh), causal, True)
              for s in (16, 17, 32, 33, 64, 65, 128, 129)
              for dh in (32, 64, 128) for causal in (False, True)]
    # Two streams a block (at least two items per SM) of uneven counts and,
    # causal, uneven lengths.
    cases += [((33, 8, 70, 32), True, True), ((17, 16, 130, 64), True, True)]
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    for shape, causal, mask in head_dim_cases(cases, g):
        b, h, s, dh = shape
        q, k, v = (torch.randn(shape, generator=g).cuda().requires_grad_()
                   for _ in range(3))
        do = torch.randn(shape, generator=g).cuda()
        fully_masked = not mask[-1].any().item()
        bias = attn.key_bias(mask, b, s, q.device)
        got, again = (torch.autograd.grad(
            attn.dot_product_attention(q, k, v, mask, causal), (q, k, v), do)
            for _ in range(2))
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"two backward calls differ at {shape} causal={causal}")
        ref_o = attn.attention_reference(q, k, v, bias, causal)
        autograd = torch.autograd.grad(ref_o, (q, k, v), do)
        plain = attn.attention_reference_backward(
            q.detach(), k.detach(), v.detach(), bias, ref_o.detach(), do,
            causal)
        torch.cuda.synchronize()
        errs = []
        for name, x, want_plain, want_auto in zip(
                ("dq", "dk", "dv"), got, plain, autograd):
            for want in (want_plain, want_auto):
                err = (x - want).abs().max().item()
                worst[name] = max(worst[name], err)
                errs.append(err)
                check(torch.isfinite(x).all().item(),
                      f"non-finite {name} at {shape}")
                check(torch.allclose(x, want, **BACKWARD_TOL),
                      f"{name} differs at {shape} causal={causal}: {err}")
        log(f"[backward] {shape} causal={causal} fully_masked_row="
            f"{fully_masked}: max|d(dq, dk, dv)| vs plain "
            f"{errs[0]:.2e} {errs[2]:.2e} {errs[4]:.2e}, vs autograd "
            f"{errs[1]:.2e} {errs[3]:.2e} {errs[5]:.2e} (bound 1e-4 abs + "
            f"1e-4 rel); a second call bitwise equal")

    backward_repeats()
    timings = {shape: backward_times(shape, g, card)
               for shape in ((256, 8, 50, 32), (1, 2, 4096, 64), FLAT_SHAPE)
               + HEAD_DIM_TIMED}
    return worst, timings


def backward_repeats():
    """4(b): the float32 forward, dq and dk/dv kernels in autograd's order
    ``REPEATS`` times at ``REPEAT_SHAPE``, causal and not, every output
    bitwise against the first call's (``tools/torch_kernel_repeats.py``):
    without the proxy fence of ``load_own_frags`` (csrc/wgmma_tf32.cuh) the
    two-stream dq instances at Dh 32 wrote wrong rows in 22 of 120000
    calls."""
    import torch

    from tools.torch_kernel_repeats import repeat_kernels

    g = torch.Generator().manual_seed(11)
    t0 = time.perf_counter()
    for causal in (False, True):
        got = repeat_kernels(REPEAT_SHAPE, causal, REPEATS, g)
        log(f"[backward] {REPEAT_SHAPE} causal={causal}: {REPEATS} calls "
            "of the forward, dq and dk/dv each bitwise against the first: "
            + ", ".join(f"{k} {v['differ']} differ" for k, v in got.items())
            + "".join(f"; {k} {c}" for k, v in got.items()
                      for c in v["cases"]))
        check(all(v["differ"] == 0 for v in got.values()),
              f"repeated kernel calls differ at {REPEAT_SHAPE} "
              f"causal={causal}")
    log(f"[time] repeats {time.perf_counter() - t0:.1f} s")


def backward_times(shape, g, card):
    """The dq and dk/dv kernels, the plain autograd backward and the
    library call's backward at ``shape`` (the last fifth of the keys
    masked), device time from CUDA graphs, beside their bounds; logged."""
    import torch
    import torch.nn.functional as F

    from flexdm_tpu_torch.ops import attention as attn

    b, h, s, dh = shape
    q, k, v, do = (torch.randn(shape, generator=g).cuda()
                   for _ in range(4))
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[:, s - s // 5:] = False
    mask = mask.cuda()
    o, _, m, l = attn._forward(q, k, v, mask, False)
    _, delta = attn._backward_dq(q, k, v, mask, o, m, l, do)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    bias = attn.key_bias(mask, b, s, q.device)
    ref_o = attn.attention_reference(qg, kg, vg, bias)

    sdpa_mask = bias[:, None, None, :]

    def plain_fwd(backward=False, forward=attn.attention_reference):
        # Autograd runs a backward op on the stream of its forward op
        # and of its leaves, so a graph captures the plain backward
        # only with its forward and leaves made inside the capture.
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = forward(*leaves)
        return torch.autograd.grad(out, leaves, do) if backward else out

    def library(*leaves):
        return F.scaled_dot_product_attention(*leaves,
                                              attn_mask=sdpa_mask)

    calls = {
        "dq": lambda: attn._backward_dq(q, k, v, mask, o, m, l, do),
        "dkv": lambda: attn._backward_dkv(q, k, v, mask, m, l, delta, do),
        "kernels": lambda: attn.flash_attention_backward(
            q, k, v, mask, o, m, l, do),
        "plain_fwd": lambda: plain_fwd(
            forward=lambda *x: attn.attention_reference(*x, bias)),
        "plain_fwd_bwd": lambda: plain_fwd(
            True, lambda *x: attn.attention_reference(*x, bias)),
        "library_fwd": lambda: plain_fwd(forward=library),
        "library_fwd_bwd": lambda: plain_fwd(True, library),
    }
    t = {name: device_ms(fn) for name, fn in calls.items()}
    t["plain"] = t["plain_fwd_bwd"] - t["plain_fwd"]
    t["library"] = t["library_fwd_bwd"] - t["library_fwd"]
    t["bounds"] = dict(zip(("dq", "dkv"), backward_bounds(shape)))
    per_call = {
        "kernels": time_ms(calls["kernels"]),
        "plain": time_ms(lambda: torch.autograd.grad(
            ref_o, (qg, kg, vg), do, retain_graph=True)),
    }
    log(f"[time] attention backward {shape} device time (CUDA graph of "
        f"20 calls, median of 50): dq {t['dq']:.4f} ms, dkv "
        f"{t['dkv']:.4f} ms, kernels (dq + dkv) {t['kernels']:.4f} ms; "
        f"plain autograd backward {t['plain']:.4f} ms (forward + "
        f"backward {t['plain_fwd_bwd']:.4f} ms less forward "
        f"{t['plain_fwd']:.4f} ms); library backward "
        f"(scaled_dot_product_attention, forward + backward "
        f"{t['library_fwd_bwd']:.4f} ms less forward "
        f"{t['library_fwd']:.4f} ms; "
        f"{sdpa_kernels(lambda: plain_fwd(True, library))}) "
        f"{t['library']:.4f} ms [{card}]")
    for name, bd in t["bounds"].items():
        log(f"[time] attention backward {shape} {name}: bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}; FP32 pipes "
            f"{bd['fp32_bound_ms']:.4f} ms), kernel {t[name]:.4f} ms")
    log(f"[time] attention backward {shape} per call from Python "
        f"(median of 50 x 20): kernels {per_call['kernels']:.4f} ms, "
        f"plain autograd backward {per_call['plain']:.4f} ms [{card}]")
    return t


def profile_by_name(fn, steps=5):
    """Device kernel ms per call of ``fn`` by kernel name over ``steps``
    calls from ``torch.profiler``, and the device kernels per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    count = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time", None)
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.cuda_time if us is None else us) / 1e3 / steps
        count += 1
    return by_name, count / steps


def top_kernels(by_name, n=3):
    """The ``n`` kernels of :func:`profile_by_name` that take the most
    time, as one line."""
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return ", ".join(f"{k[:50]} {v:.3f} ms" for k, v in top)


def profile_steps(fn, steps=5):
    """Device kernel time per call of ``fn`` over ``steps`` calls from
    ``torch.profiler``: total and attention kernels' ms, kernels per call,
    and the three kernels that take the most time."""
    by_name, kernels = profile_by_name(fn, steps)
    attention = sum(v for k, v in by_name.items() if "flash_" in k)
    return sum(by_name.values()), attention, kernels, top_kernels(by_name)


def launch_counts():
    from flexdm_tpu_torch.ops import attention as attn

    return attn.launch_counts()


def kernel_names(dtype):
    """``(fwd, dq, dkv)`` count names of the kernel instance a model of
    compute ``dtype`` runs."""
    return BF16_KERNELS if dtype == BF16 else F32_KERNELS


def check_one_instance(counts, dtype, label):
    """A path of compute ``dtype`` launched no kernel of the other dtype."""
    other = F32_KERNELS if dtype == BF16 else BF16_KERNELS
    check(not any(counts[n] for n in other),
          f"{label}: a kernel of the other dtype launched: {counts}")


def train_data(root, dataset, seed):
    """A synthetic 512/64/64 data dir (full batches of 256) and its first
    training batch of 256 as CPU tensors."""
    import torch

    from flexdm_tpu_torch.data import DatasetSpec, split_device_batch, \
        synthetic

    t0 = time.perf_counter()
    data_dir = synthetic.generate(
        dataset, os.path.join(root, f"{dataset}_train_data"),
        2 * TRAIN_BATCH, 64, 64, seed=seed)
    log(f"[train] synthetic {dataset} 512/64/64 in "
        f"{time.perf_counter() - t0:.1f} s")
    spec = DatasetSpec(dataset, data_dir, TRAIN_BATCH)
    batch = {k: torch.from_numpy(v) for k, v in split_device_batch(
        next(iter(spec.make_dataset("train")))).items()}
    return data_dir, spec, batch


def near_tie_argmaxes(model, batch, draws, task_config):
    """How many argmaxes the pos-sort protocol takes (the sort keys'
    predicted logits, valid elements of the pos-task rows) have their top
    two logits within ``NEAR_TIE``: where the card and the CPU may argmax
    differently, and then sort differently."""
    import torch

    from flexdm_tpu_torch.models.masking import get_seq_mask, \
        preprocess_for_train
    from flexdm_tpu_torch.models.sorting import SORT_KEYS

    schema = model.schema
    with torch.no_grad():
        _, modified, _ = preprocess_for_train(
            batch, schema, draws.tasks, draws.uniforms, draws.element,
            draws.values)
        outputs = model(modified)
    rows = (draws.tasks == task_config.pos_task_id)[:, None]
    valid = (get_seq_mask(batch["length"], schema.max_length) & rows)
    count = 0
    for name in SORT_KEYS:
        top = outputs[name].topk(2, -1).values
        near = (top[..., 0] - top[..., 1]) <= NEAR_TIE
        count += int((near & valid[..., None]).sum())
    return count, int(valid.sum())


def phase_train_parity(args, spec, batch, label="crello Ours-EXP"):
    """One step on the card against the same step on a CPU copy (dropout
    0, the same draws).  Loss and per-field losses within 1e-5 relative;
    every clipped gradient leaf (``mu / 0.1`` after the first keras-Adam
    step) within 1e-5 + 1e-3 of the leaf's largest entry, and nonzero;
    parameters within 1e-6 where |g| > 1e-3 on both, within 2 lr + 1e-6
    elsewhere (a near-zero gradient's sign decides a +-lr first step).
    Under the pos-sort protocol (rico) it also counts the near-tie
    argmaxes of the sort."""
    import torch

    from flexdm_tpu_torch.config import TrainConfig, build_model
    from flexdm_tpu_torch.convert import init_params
    from flexdm_tpu_torch.models import make_task_config
    from flexdm_tpu_torch.models.masking import draw_train
    from flexdm_tpu_torch.train.optim import KerasAdam
    from flexdm_tpu_torch.train.trainer import make_train_step

    config = TrainConfig.from_args(dict(args, dropout=0.0))
    schema = spec.schema
    task_config = make_task_config(schema, config.masking_method)
    cpu_model = init_params(build_model(config, schema), 0)
    card_model = copy.deepcopy(cpu_model).cuda()
    b = batch["length"].shape[0]
    draws = draw_train(schema, b, task_config.task_probs,
                       torch.Generator().manual_seed(3),
                       **cpu_model.draw_options())
    ties = ""
    if task_config.sort_pos:
        n, elements = near_tie_argmaxes(cpu_model, batch, draws, task_config)
        ties = (f"; sort_flag live on {elements} elements, {n} sort-key "
                f"argmaxes within {NEAR_TIE} of a tie")
    results = {}
    for where, model in (("cpu", cpu_model), ("cuda", card_model)):
        adam = KerasAdam(model.parameters(), config.learning_rate)
        step = make_train_step(model, task_config, adam, config.l2)
        metrics = step({k: v.to(where) for k, v in batch.items()},
                       draws.to(where))
        results[where] = (
            {k: v.item() for k, v in metrics.items()},
            [mu.cpu() / 0.1 for mu in adam.mu],
            [p.detach().cpu() for p in model.parameters()],
        )
    (want_m, want_g, want_p), (got_m, got_g, got_p) = (
        results["cpu"], results["cuda"])
    for name in sorted(want_m):
        if name == "loss" or name.endswith("_loss"):
            err = abs(got_m[name] - want_m[name])
            check(err <= 1e-5 * abs(want_m[name]) + 1e-7,
                  f"{name}: card {got_m[name]} vs CPU {want_m[name]}")
    worst_g = worst_p = 0.0
    names = [n for n, _ in cpu_model.named_parameters()]
    for name, g, w, p, wp in zip(names, got_g, want_g, got_p, want_p):
        err = (g - w).abs().max().item()
        worst_g = max(worst_g, err)
        check(err <= 1e-5 + 1e-3 * w.abs().max().item(),
              f"gradient of {name} differs by {err}")
        check(g.abs().max().item() > 0, f"{name} got no gradient")
        steady = (g.abs() > 1e-3) & (w.abs() > 1e-3)
        delta = (p - wp).abs()
        worst_p = max(worst_p, delta[steady].max().item() if steady.any()
                      else 0.0)
        check(delta[steady].max().item() <= 1e-6 if steady.any() else True,
              f"{name}: updated parameters differ")
        check(delta.max().item() <= 2 * config.learning_rate + 1e-6,
              f"{name}: updated parameters differ by more than 2 lr")
    log(f"[train] {label} step parity, card vs CPU, batch {b}: loss "
        f"{got_m['loss']:.6f} vs {want_m['loss']:.6f}; max |dg| "
        f"{worst_g:.2e} over {len(names)} leaves (all nonzero); max |dp| "
        f"{worst_p:.2e} where |g| > 1e-3{ties}")
    return got_m["loss"], want_m["loss"]


def phase_train_steps(args, spec, batch, card, label="crello Ours-EXP"):
    """30 steps on one fixed batch (fixed draws, dropout on): the loss
    falls; the last 20 steps timed one by one with CUDA events.  Each
    kernel must launch at least once per block per step.  Returns the
    median step, the losses, the launches and the trained model."""
    import torch

    from flexdm_tpu_torch.config import TrainConfig, build_model
    from flexdm_tpu_torch.convert import init_params
    from flexdm_tpu_torch.models import make_task_config
    from flexdm_tpu_torch.models.masking import draw_train
    from flexdm_tpu_torch.ops import attention as attn
    from flexdm_tpu_torch.train.optim import KerasAdam
    from flexdm_tpu_torch.train.trainer import make_train_step

    config = TrainConfig.from_args(args)
    schema = spec.schema
    task_config = make_task_config(schema, config.masking_method)
    model = init_params(build_model(config, schema), 0).cuda()
    step = make_train_step(model, task_config,
                           KerasAdam(model.parameters(), config.learning_rate),
                           config.l2)
    generator = torch.Generator("cuda").manual_seed(0)
    b = batch["length"].shape[0]
    draws = draw_train(schema, b, task_config.task_probs, generator,
                       **model.draw_options())
    draws.dropout = generator
    batch = {k: v.cuda() for k, v in batch.items()}
    num_blocks = len(list(model.blocks.children()))
    losses, times = [], []
    attn.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(batch, draws)
        stop.record()
        stop.synchronize()
        losses.append(metrics["loss"].item())
        if i >= TRAIN_STEPS - TIMED_STEPS:
            times.append(start.elapsed_time(stop))
    counts = launch_counts()
    log(f"[train] {label}: {TRAIN_STEPS} steps on one batch: loss "
        f"{losses[0]:.3f} -> {losses[-1]:.3f}; launches {counts} for "
        f"{TRAIN_STEPS} steps x {num_blocks} blocks")
    check(all(math.isfinite(x) for x in losses), "non-finite training loss")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name in kernel_names(config.dtype):
        check(counts[name] >= num_blocks * TRAIN_STEPS,
              f"{name} kernel launched {counts[name]} times for "
              f"{TRAIN_STEPS} steps")
    check_one_instance(counts, config.dtype, label)
    step_ms = statistics.median(times)
    log(f"[time] train step, {label}, batch {b} (fixed "
        f"batch, draws and dropout on the card; CUDA events, median of "
        f"{TIMED_STEPS} warm steps): {step_ms:.2f} ms, "
        f"{b / step_ms * 1e3:.0f} documents/s; min "
        f"{min(times):.2f} max {max(times):.2f} ms [{card}]")
    device, attention, kernels, top = profile_steps(
        lambda: step(batch, draws))
    log(f"[time] train step, {label}, torch.profiler over 5 more steps: "
        f"device kernel time {device:.3f} ms per step ({device / step_ms:.1%}"
        f" of the median step), attention kernels {attention:.3f} ms, "
        f"{kernels:.0f} device kernels per step; most time: {top} [{card}]")
    return step_ms, losses, counts, model


def phase_train_cli(root, data_dir, card, dtype=None):
    """``python -m flexdm_tpu_torch`` for 2 epochs (``--dtype``, if given),
    then serve its best."""
    import torch

    from flexdm_tpu_torch.cli import main as train_main
    from flexdm_tpu_torch.ops import attention as attn

    job = os.path.join(root, "train_job" + (f"_{dtype}" if dtype else ""))
    argv = ["--preset", "crello_ours_exp", "--data_dir", data_dir,
            "--job-dir", job, "--num_epochs", "2", "--validation_freq", "1",
            "--log_level", "WARNING"] + (["--dtype", dtype] if dtype else [])
    fwd, dq, dkv = kernel_names(dtype)
    attn.reset_launch_counts()
    t0 = time.perf_counter()
    train_main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    with open(os.path.join(job, "logs", "history.jsonl")) as f:
        history = [json.loads(line) for line in f]
    steps = history[-1]["step"]
    log(f"[train] CLI {' '.join(argv[:2])} ... --num_epochs 2"
        f"{' --dtype ' + dtype if dtype else ''}: {steps} steps "
        f"in {seconds:.1f} s (validation, test and checkpoints included) "
        f"[{card}]; launches {counts}")
    log(f"[train] history: " + "; ".join(
        f"epoch {h['epoch']} loss {h['loss']:.3f} val_total_score "
        f"{h['val_total_score']:.4f}" for h in history))
    check(len(history) == 2 and steps == 4, f"history {history}")
    check(all(finite(h) for h in history), "non-finite value in history")
    check(counts[dq] >= 4 * steps and counts[dkv] >= 4 * steps,
          f"backward kernels launched {counts} for {steps} steps")
    check(counts[fwd] >= 4 * steps, f"forward launched {counts}")
    check_one_instance(counts, dtype, "CLI training")

    serve_best(job, data_dir, dtype, "[train] the trained job's best")
    return counts, seconds, steps, job


def serve_once(job, data_dir):
    """The job's ``best`` served on the card by one engine: ``/predict``
    of 4 documents over HTTP, the answers checked.  Returns the engine,
    the launches, the plain attention's calls on the card, the seconds
    and the documents sent."""
    from flexdm_tpu_torch.data import DatasetSpec, split_device_batch
    from flexdm_tpu_torch.ops import attention as attn
    from flexdm_tpu_torch.serve import InferenceEngine, _jsonable, serve

    engine = InferenceEngine(job, batch_size=BATCH, device="cuda")
    spec = DatasetSpec("crello", data_dir, BATCH)
    docs = _jsonable(spec.unbatch(split_device_batch(
        next(iter(spec.make_dataset("test", batch_size=4))))))
    server = serve(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        attn.reset_launch_counts()
        with PlainOnCard() as plain:
            body, secs = http(server.server_address[1], "/predict",
                              dict(task="pos", documents=docs))
        counts = launch_counts()
    finally:
        server.shutdown()
        server.server_close()
    check_predictions(spec, "pos", docs, body["predictions"])
    return engine, counts, plain.calls, secs, docs


def serve_best(job, data_dir, dtype, label):
    """:func:`serve_once`, the forward of the job's dtype launched."""
    engine, serve_counts, _, secs, docs = serve_once(job, data_dir)
    check(engine.model.dtype == dtype, f"served {engine.model.dtype}")
    check(serve_counts[kernel_names(dtype)[0]] >= 4,
          f"/predict launched {serve_counts}")
    check_one_instance(serve_counts, dtype, f"{label} served")
    log(f"{label} served: /predict pos x{len(docs)} docs: 200 in "
        f"{secs * 1e3:.1f} ms; launches {serve_counts}")


def phase_train(card, root, data_dir, spec, batch):
    args = load_args(CONFIG, data_dir)
    phase_train_parity(args, spec, batch)
    step_ms, losses, counts, _ = phase_train_steps(args, spec, batch, card)
    cli_counts = phase_train_cli(root, data_dir, card)[0]
    return step_ms, losses, counts, cli_counts


def phase_rico(card, root):
    """rico Ours-EXP at full width and batch 256: the pos-sort loss.  The
    trained weights become ``rico_job`` for the eval phase."""
    data_dir, spec, batch = train_data(root, "rico", seed=1)
    args = load_args(RICO_CONFIG, data_dir)
    phase_train_parity(args, spec, batch, "rico Ours-EXP")
    step_ms, _, counts, model = phase_train_steps(args, spec, batch, card,
                                                  "rico Ours-EXP")
    write_job(os.path.join(root, "rico_job"), args, model)
    return step_ms, counts


def phase_flat(card, root, data_dir, spec, batch):
    """crello_flat (the VanillaTransformer over 50 x 10 = 500 tokens) at
    D=256, 4 blocks, batch 64: step parity on 16 documents, 30 steps, then
    the trained weights served over HTTP."""
    from flexdm_tpu_torch.data import split_device_batch

    from flexdm_tpu_torch.ops import attention as attn
    from flexdm_tpu_torch.serve import InferenceEngine, _jsonable, serve

    args = load_args(FLAT_CONFIG, data_dir)
    batch = {k: v[:FLAT_BATCH] for k, v in batch.items()}
    phase_train_parity(
        args, spec, {k: v[:FLAT_PARITY_DOCS] for k, v in batch.items()},
        f"crello_flat ({FLAT_PARITY_DOCS} of the {FLAT_BATCH} documents: "
        "the CPU copy's plain attention at S=500 is slow)")
    step_ms, _, counts, model = phase_train_steps(args, spec, batch, card,
                                                  "crello_flat")
    job = os.path.join(root, "flat_job")
    write_job(job, args, model)
    engine = InferenceEngine(job, batch_size=BATCH, device="cuda")
    check(engine.model.seq_type == "flat", "the flat job loaded another model")
    docs = _jsonable(spec.unbatch(split_device_batch(
        next(iter(spec.make_dataset("test", batch_size=BATCH))))))
    server = serve(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        attn.reset_launch_counts()
        body, secs = http(server.server_address[1], "/predict",
                          dict(task="pos", documents=docs))
        serve_counts = launch_counts()
    finally:
        server.shutdown()
        server.server_close()
    check_predictions(spec, "pos", docs, body["predictions"])
    num_blocks = len(list(engine.model.blocks.children()))
    check(serve_counts["fwd"] >= num_blocks,
          f"flat /predict launched {serve_counts}")
    check_one_instance(serve_counts, None, "flat /predict")
    log(f"[flat] the trained crello_flat weights served: /predict pos "
        f"x{len(docs)} docs: 200 in {secs * 1e3:.1f} ms; launches "
        f"{serve_counts} [{card}]")
    return step_ms, counts


def maskgit_reference(engine, cpu_model, docs, task,
                      num_iter=MASKGIT_ITERS, rel=0.0):
    """The CPU's MaskGIT decode of ``docs`` as the engine batches them:
    per document, how many masked fields had a confidence within
    ``NEAR_TIE`` of their round's threshold or a final argmax within
    ``NEAR_TIE`` of a tie (where the card may decode otherwise); ``rel``
    widens "within" by that fraction of the larger value (a bf16 model:
    ``BF16_TIE``)."""
    import torch

    from flexdm_tpu_torch.data import split_device_batch
    from flexdm_tpu_torch.demo import build_task_masks
    from flexdm_tpu_torch.models import forward_eval

    schema = engine.schema
    padded = list(docs) + [docs[-1]] * (engine.batch_size - len(docs))
    batch = {k: torch.from_numpy(v) for k, v in split_device_batch(
        engine.spec.batch_documents(padded)).items()}
    masks = build_task_masks(schema, batch, task)
    rounds = []
    out = forward_eval(cpu_model, batch, masks, num_iter=num_iter,
                       rounds=rounds)
    near = torch.zeros(engine.batch_size, dtype=torch.long)
    for r in rounds:
        thr = r["threshold"].float()[:, None]
        for conf in r["confidence"].values():
            conf = conf.float()
            gap = (conf - thr).abs()
            near += ((conf > 0) & (gap > 0)
                     & (gap <= NEAR_TIE + rel * thr)).sum(1)
    for c in schema.sequence_columns:
        if c.is_categorical:
            top = out[c.name].float().topk(2, -1).values
            tie = ((top[..., 0] - top[..., 1])
                   <= NEAR_TIE + rel * top[..., 0].abs()).any(-1)
            near += (tie & masks[c.name]).sum(1)
    return near[:len(docs)].tolist()


def phase_maskgit(card):
    """MaskGIT serving: ``/predict`` with ``num_iter=3`` over HTTP on a
    crello Ours-EXP job (random weights, decoder heads x8), batch 8.  Only
    masked fields change; the forward kernel launches >= 3 x 4 times per
    batch; the answers equal the CPU's but for documents with a near tie;
    the request is timed."""
    from flexdm_tpu_torch.data import split_device_batch

    from flexdm_tpu_torch.ops import attention as attn
    from flexdm_tpu_torch.serve import CoalescingEngine, InferenceEngine, \
        _jsonable, serve

    with tempfile.TemporaryDirectory() as root:
        job, spec = make_job(root, "maskgit_job", decoder_scale=8.0)
        engine = InferenceEngine(job, batch_size=BATCH, device="cuda")
        cpu = InferenceEngine(job, batch_size=BATCH, device="cpu")
        num_blocks = len(list(engine.model.blocks.children()))
        log(f"[maskgit] warmup {engine.warmup([('pos', MASKGIT_ITERS)])}")
        docs = _jsonable(spec.unbatch(split_device_batch(
            next(iter(spec.make_dataset("test", batch_size=BATCH))))))
        server = serve(CoalescingEngine(engine, window_ms=3.0), port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        times = []
        try:
            port = server.server_address[1]
            for task in ("pos", "attr"):
                attn.reset_launch_counts()
                body, seconds = http(port, "/predict", dict(
                    task=task, documents=docs, num_iter=MASKGIT_ITERS))
                counts = launch_counts()
                preds = body["predictions"]
                check_predictions(spec, task, docs, preds)
                check(counts["fwd"] >= MASKGIT_ITERS * num_blocks,
                      f"{task}: forward launched {counts['fwd']} times for "
                      f"{MASKGIT_ITERS} rounds x {num_blocks} blocks")
                check_one_instance(counts, None, f"maskgit {task}")
                want = cpu.predict(docs, task=task, num_iter=MASKGIT_ITERS)
                near = maskgit_reference(engine, cpu.model, docs, task)
                differ = [i for i, (g, w) in enumerate(zip(preds, want))
                          if g != w]
                check(all(near[i] for i in differ),
                      f"{task}: documents {differ} differ from the CPU's "
                      f"with no near tie (near-tie fields {near})")
                log(f"[maskgit] {task} num_iter={MASKGIT_ITERS} x{len(docs)} "
                    f"docs: 200 in {seconds * 1e3:.1f} ms; forward launches "
                    f"{counts['fwd']} (>= {MASKGIT_ITERS} x {num_blocks}); "
                    f"card = CPU on {len(docs) - len(differ)} of {len(docs)} "
                    f"documents; {sum(near)} fields within {NEAR_TIE} of a "
                    f"threshold or an argmax tie (per document {near})")
            for _ in range(20):
                body, seconds = http(port, "/predict", dict(
                    task="pos", documents=docs, num_iter=MASKGIT_ITERS))
                times.append(seconds * 1e3)
        finally:
            server.shutdown()
            server.server_close()
    ms = statistics.median(times)
    log(f"[time] HTTP /predict pos num_iter={MASKGIT_ITERS}, {BATCH} docs, "
        f"warm: median {ms:.2f} ms of 20 (min {min(times):.2f}, max "
        f"{max(times):.2f}) [{card}]")
    return ms


class NearTies:
    """The ``observe`` hook of a CPU reference run of the harness: where the
    card may score a categorical field otherwise.  A masked field is near a
    tie when its top two logits lie within ``NEAR_TIE`` or, under MaskGIT,
    its confidence lies within ``NEAR_TIE`` of its round's threshold.
    ``allowance[column]`` bounds |card Σnum - CPU Σnum|: the near-tie
    channels of the column in one unsorted pass; where one flip can move
    other fields of its row (the pos sort, MaskGIT), every masked channel
    of each row that holds a near tie.  ``rel`` widens "near" by that
    fraction of the larger value (a bf16 model: ``BF16_TIE``)."""

    def __init__(self, schema, whole_rows, rel=0.0):
        self.schema = schema
        self.whole_rows = whole_rows
        self.rel = rel
        self.columns = [c for c in schema.columns
                        if c.is_sequence and not c.demo_only]
        self.fields = self.rows = 0
        self.allowance = {c.name: 0 for c in self.columns}

    def __call__(self, batch, masks, weight, prediction, rounds):
        import torch

        from flexdm_tpu_torch.models.masking import get_seq_mask

        live = (get_seq_mask(batch["length"], self.schema.max_length)
                & (weight > 0)[:, None])
        masked = {c.name: masks[c.name] & live for c in self.columns}
        near_rows = torch.zeros(live.shape[0], dtype=torch.bool,
                                device=live.device)
        for c in self.columns:
            if not c.is_categorical:
                continue
            top = prediction[c.name].float().topk(2, -1).values
            near = ((top[..., 0] - top[..., 1])
                    <= NEAR_TIE + self.rel * top[..., 0].abs()) \
                & masked[c.name][..., None]
            self.fields += int(near.sum())
            self.allowance[c.name] += 0 if self.whole_rows else int(near.sum())
            near_rows |= near.flatten(1).any(1)
        for r in rounds or ():
            thr = r["threshold"].float()[:, None]
            for conf in r["confidence"].values():
                conf = conf.float()
                gap = (conf - thr).abs()
                near = ((conf > 0) & (gap > 0)
                        & (gap <= NEAR_TIE + self.rel * thr) & live)
                self.fields += int(near.sum())
                near_rows |= near.any(1)
        if self.whole_rows:
            self.rows += int(near_rows.sum())
            for c in self.columns:
                channels = c.shape[-1] if c.is_categorical else 1
                self.allowance[c.name] += channels * int(
                    (masked[c.name] & near_rows[:, None]).sum())


class FirstDocs:
    """The first ``n`` test documents as one batch: a loader for the
    harness."""

    def __init__(self, spec, n):
        self.loader = spec.make_dataset("test", batch_size=n)
        self.num_records = self.batch_size = n
        self._record = self.loader._record

    def __iter__(self):
        yield next(iter(self.loader))


def compare_sums(label, schema, got, want, ties, rtol=EVAL_RTOL):
    """Card sums against the CPU's: every Σden within ``EVAL_RTOL`` and
    every numerical Σnum within ``rtol`` relative, every categorical Σnum
    equal, each apart from its column's near-tie allowance.  Returns the
    largest relative difference of a numerical Σnum and the largest
    difference of a categorical one."""
    check(set(got) == set(want), f"{label}: metrics {set(got) ^ set(want)}")
    worst = worst_cat = 0.0
    for c in ties.columns:
        num, den = f"{c.name}_score_num", f"{c.name}_score_den"
        allow = ties.allowance[c.name]
        check(abs(got[den] - want[den]) <= EVAL_RTOL * abs(want[den]),
              f"{label}: {den} card {got[den]} vs CPU {want[den]}")
        diff = abs(got[num] - want[num])
        if c.is_categorical:
            worst_cat = max(worst_cat, diff)
            check(diff <= allow, f"{label}: {num} card {got[num]} vs CPU "
                  f"{want[num]} with {allow} near-tie channels")
        else:
            worst = max(worst, diff / max(abs(want[num]), 1e-30))
            check(diff <= rtol * abs(want[num]) + allow,
                  f"{label}: {num} card {got[num]} vs CPU {want[num]}")
    return worst, worst_cat


def eval_tasks(schema, mode):
    """``(task, group)`` of every task ``evaluate_all`` runs for ``mode``."""
    groups = schema.attribute_groups
    if mode in ("elem", "random"):
        return [(mode, None)]
    if mode == "all_feat":
        return [(n, (n, k)) for n, k in groups.items() if n != "type"]
    return [(mode, (mode, groups[mode]))]


def eval_data(root):
    """Synthetic crello and rico data dirs whose test split holds
    ``EVAL_DOCS`` documents: the split the eval CLI is timed on.  One
    pass of a fresh loader over each is timed: the host decode every eval
    run pays once."""
    from flexdm_tpu_torch.data import DatasetSpec, synthetic

    dirs = {}
    for dataset in ("crello", "rico"):
        t0 = time.perf_counter()
        dirs[dataset] = synthetic.generate(
            dataset, os.path.join(root, f"{dataset}_eval_data"), 0, 0,
            EVAL_DOCS, seed=1)
        generated = time.perf_counter() - t0
        t0 = time.perf_counter()
        batches = sum(1 for _ in DatasetSpec(
            dataset, dirs[dataset], EVAL_BATCH).make_dataset(
                "test", batch_size=EVAL_BATCH))
        log(f"[eval] synthetic {dataset} test split of {EVAL_DOCS} in "
            f"{generated:.1f} s")
        log(f"[time] eval decode: one pass of a fresh loader over the "
            f"{dataset} test split, {batches} batches of {EVAL_BATCH}: "
            f"{time.perf_counter() - t0:.3f} s on the host (native decoder)")
    return dirs


# (label, mode, num_iter) -> (CLI seconds, harness seconds) of each eval
# run, for phase 14's summary.
EVAL_SECONDS = {}


def eval_blocks(cache, task, seq_len):
    """The number of index blocks (forwards) a resident task runs at
    ``EVAL_BATCH`` documents or ``ELEM_CHUNK`` replicas a block."""
    blocks = (cache.elem_index_blocks(ELEM_CHUNK, seq_len) if task == "elem"
              else cache.eval_index_blocks(EVAL_BATCH))
    return blocks[0].shape[0]


def eval_run(card, root, label, job, mode, timed_dir, num_iter=1,
             compare_docs=None, compare_chunk=EVAL_BATCH):
    """``python -m flexdm_tpu_torch.evaluation`` on the card at batch
    ``EVAL_BATCH`` over the test split of ``timed_dir`` (timed, launches
    counted, its CSV read back); the harness on the card over that split,
    resident (one cache for every task, the split's blocks predicting the
    forward launches exactly: ``num_blocks x blocks x num_iter``, the CLI's
    too) and streaming (``resident=False``), the two paths' sums within
    ``PATHS_RTOL`` and the resident ones giving the CLI's scores; then the
    card against the CPU on the job's own test split (the whole of it, or
    its first ``compare_docs`` documents, the CPU in ``elem`` chunks of
    ``compare_chunk``), near ties counted; a bf16 job with bf16's bars
    (``BF16_ULP``, ``BF16_TIE``).  Returns the forward's launch counts."""
    import torch

    from flexdm_tpu_torch.data import DatasetSpec
    from flexdm_tpu_torch.demo import load_model
    from flexdm_tpu_torch.evaluation import harness
    from flexdm_tpu_torch.ops import attention as attn

    result_csv = os.path.join(root, f"{label}_{mode}.csv")
    argv = ["--job-dir", job, "--batch_size", str(EVAL_BATCH),
            "--task_mode", mode, "--num_iter", str(num_iter),
            "--result_csv", result_csv, "--data_dir", timed_dir]
    torch.cuda.synchronize()
    attn.reset_launch_counts()
    t0 = time.perf_counter()
    final = harness.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    with open(result_csv) as f:
        rows = list(csv.reader(f))
    check(len(rows) == 2 and rows[0] == list(final)
          and [float(v) for v in rows[1]] == list(final.values()),
          f"{label} {mode}: the CSV {rows} is not {final}")
    check(final and finite(final) and all(0.0 <= v <= 1.0
                                          for v in final.values()),
          f"{label} {mode}: scores {final}")

    card_model, spec = load_model(job, batch_size=EVAL_BATCH, device="cuda")
    cpu_model = copy.deepcopy(card_model).cpu()
    schema = spec.schema
    bf16 = card_model.dtype == BF16
    fwd = kernel_names(card_model.dtype)[0]
    num_blocks = len(list(card_model.blocks.children()))
    timed = DatasetSpec(spec.name, timed_dir, EVAL_BATCH).make_dataset(
        "test", batch_size=EVAL_BATCH)
    check(timed.num_records == EVAL_DOCS,
          f"{label}: {timed.num_records} timed test documents")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = harness._make_cache(timed, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    split = spec.make_dataset("test", batch_size=EVAL_BATCH)
    whole_rows = bool(schema.sort_pos and mode == "pos") or num_iter > 1
    ans, forwards, units, worst, worst_cat = {}, 0, 0, 0.0, 0.0
    fields = rows_near = 0
    t_resident = t_streaming = paths_gap = 0.0
    for task, group in eval_tasks(schema, mode):
        real = []  # rows of weight > 0 per forward: documents or replicas
        timed_rows = set()

        def observe(batch, masks, w, *_):  # no host fetch
            real.append((w > 0).sum())
            timed_rows.add(batch["length"].shape[0])

        blocks = eval_blocks(cache, task, schema.max_length)
        attn_reset()
        t0 = time.perf_counter()
        sums = harness.task_sums(card_model, timed, task, group, num_iter,
                                 observe=observe, cache=cache)
        torch.cuda.synchronize()
        t_resident += time.perf_counter() - t0
        launched = launch_counts()[fwd]
        check(len(real) == blocks
              and launched == num_blocks * blocks * max(num_iter, 1),
              f"{label} {task}: {len(real)} forwards and {launched} forward "
              f"launches, not {blocks} and {num_blocks} x {blocks} x "
              f"{max(num_iter, 1)} as the index blocks predict")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streamed = harness.task_sums(card_model, timed, task, group,
                                     num_iter, resident=False)
        torch.cuda.synchronize()
        t_streaming += time.perf_counter() - t0
        check(set(streamed) == set(sums), f"{label} {task}: metrics")
        for k, v in streamed.items():
            gap = abs(sums[k] - v) / max(abs(v), 1e-30)
            paths_gap = max(paths_gap, gap)
            check(gap <= PATHS_RTOL, f"{label} {task}: {k} resident "
                  f"{sums[k]} vs streaming {v}")
        ans[task] = harness._ratios(schema, sums)
        forwards += blocks * max(num_iter, 1)
        units += int(torch.stack(real).sum())

        ties = NearTies(schema, whole_rows, BF16_TIE if bf16 else 0.0)
        docs = split if compare_docs is None else FirstDocs(spec, compare_docs)
        rows_seen = []
        on_card = harness.task_sums(
            card_model, docs, task, group, num_iter,
            observe=lambda batch, *_: rows_seen.append(
                batch["length"].shape[0]))
        check(rows_seen and set(rows_seen) == timed_rows,
              f"{label} {task}: the card compared at batch rows "
              f"{rows_seen}, the CLI ran at {timed_rows}")
        want = harness.task_sums(cpu_model, docs, task, group, num_iter,
                                 elem_chunk=compare_chunk, observe=ties)
        rel, cat = compare_sums(f"{label} {task}", schema, on_card, want,
                                ties, BF16_ULP if bf16 else EVAL_RTOL)
        worst, worst_cat = max(worst, rel), max(worst_cat, cat)
        fields += ties.fields
        rows_near += ties.rows
    check(harness.merge_results(ans) == final,
          f"{label} {mode}: the harness on the card gave "
          f"{harness.merge_results(ans)}, the CLI {final}")
    check(counts[fwd] == num_blocks * forwards,
          f"{label} {mode}: the CLI launched the forward {counts[fwd]} "
          f"times for {forwards} forwards x {num_blocks} blocks")
    check(not any(counts[n] for n in ("dq", "dkv", "dq_bf16", "dkv_bf16")),
          f"{label} {mode}: a backward kernel ran in evaluation: {counts}")
    check_one_instance(counts, card_model.dtype, f"{label} {mode}")
    what = "replicas" if mode == "elem" else "documents x tasks"
    compared = ("the whole 64-document split" if compare_docs is None
                else f"the first {compare_docs} documents")
    log(f"[eval] {label} --task_mode {mode} --num_iter {num_iter}: "
        f"{len(final)} fields, e.g. {dict(list(final.items())[:3])}; forward "
        f"launches {counts[fwd]} (= {forwards} forwards x {num_blocks} "
        f"blocks, as the index blocks predict); resident = streaming sums "
        f"within {paths_gap:.2e} relative (bar {PATHS_RTOL:g}); card (the "
        f"CLI's {sorted(timed_rows)} rows a forward) = CPU on {compared} "
        f"(numerical Σnum within {worst:.2e} relative, categorical Σnum "
        f"apart by at most {worst_cat:g}); {fields} masked "
        f"fields within {NEAR_TIE}{' + 4 bf16 ulps' if bf16 else ''} of a "
        f"tie or a threshold"
        + (f" on {rows_near} rows" if whole_rows else ""))
    t_harness = build_s + t_resident
    EVAL_SECONDS[label, mode, num_iter] = (seconds, t_harness)
    log(f"[time] eval {label} --task_mode {mode} --num_iter {num_iter}, "
        f"{EVAL_DOCS} documents at batch {EVAL_BATCH}: CLI {seconds:.3f} s "
        f"(model load, decode, cache and CSV included), "
        f"{seconds / len(ans):.3f} s per task, {units} {what}, "
        f"{units / seconds:.1f} {what}/s; harness resident {t_harness:.3f} "
        f"s = cache {build_s:.3f} s ({cache.nbytes / 2**20:.2f} MiB: decode, "
        f"stack, upload) + {len(ans)} task(s) {t_resident:.3f} s "
        f"({t_resident / len(ans):.3f} s a task), {units / t_harness:.1f} "
        f"{what}/s; streaming (resident=False, the records decoded "
        f"already) {t_streaming:.3f} s ({t_streaming / len(ans):.3f} s a "
        f"task); {forwards} forwards [{card}]")
    return counts


def phase_eval(card, root, data):
    """``python -m flexdm_tpu_torch.evaluation`` on the card at batch 256
    over the 2048-document test splits of ``data`` (:func:`eval_data`):
    crello Ours-EXP (the CLI-trained job) ``all_feat``, ``elem``, ``random``
    and ``pos --num_iter 3``; rico Ours-EXP ``pos`` (the sort live);
    crello_flat ``elem`` (forwards at (256, 8, 500, 32)), then a
    ``torch.profiler`` window over one such chunk.  Returns the forward's
    launches per path."""
    import torch

    from flexdm_tpu_torch.demo import load_model
    from flexdm_tpu_torch.evaluation import harness

    t0 = time.perf_counter()
    crello_job = os.path.join(root, "train_job")
    by_path = {}
    for mode, num_iter in (("all_feat", 1), ("elem", 1), ("random", 1),
                           ("pos", MASKGIT_ITERS)):
        counts = eval_run(card, root, "crello Ours-EXP", crello_job, mode,
                          data["crello"], num_iter)
        total = by_path.setdefault("crello_ours_exp_eval",
                                   dict.fromkeys(counts, 0))
        for name, n in counts.items():
            total[name] += n
    label = "crello Ours-EXP"
    (cli_all, all_feat), (cli_random, random_s) = (
        EVAL_SECONDS[label, "all_feat", 1], EVAL_SECONDS[label, "random", 1])
    log(f"[time] eval {label} all_feat (4 tasks) against random (1 task), "
        f"{EVAL_DOCS} documents: harness resident {all_feat:.3f} s against "
        f"{random_s:.3f} s (cache build included), CLI {cli_all:.3f} s "
        f"against {cli_random:.3f} s [{card}]")
    by_path["rico_ours_exp_eval"] = eval_run(
        card, root, "rico Ours-EXP", os.path.join(root, "rico_job"), "pos",
        data["rico"])
    flat_job = os.path.join(root, "flat_job")
    by_path["crello_flat_eval"] = eval_run(
        card, root, "crello_flat", flat_job, "elem", data["crello"],
        compare_docs=FLAT_EVAL_DOCS, compare_chunk=64)

    model, spec = load_model(flat_job, batch_size=EVAL_BATCH, device="cuda")
    batch, weight, _, lengths = next(harness._batches(
        spec.make_dataset("test", batch_size=EVAL_BATCH), "cuda"))
    replicas = torch.from_numpy(harness._elem_replicas(
        lengths, spec.schema.max_length, EVAL_BATCH)[:EVAL_BATCH]).cuda()
    step, _ = harness.make_elem_step(model)
    device, attention, kernels, top = profile_steps(
        lambda: step(batch, replicas, weight), steps=3)
    bd = forward_bound(EVAL_FLAT_SHAPE)
    log(f"[time] eval crello_flat elem, one chunk of {EVAL_BATCH} replicas "
        f"(4 forward kernels at {EVAL_FLAT_SHAPE}), torch.profiler over 3 "
        f"chunks: device kernel time {device:.3f} ms per chunk, attention "
        f"kernels {attention:.3f} ms ({attention / 4:.4f} ms per launch; "
        f"bound {bd['bound_ms']:.4f} ms, {bd['bound_by']}), {kernels:.0f} "
        f"device kernels; most time: {top} [{card}]")
    log(f"[eval] phase done in {time.perf_counter() - t0:.1f} s")
    return by_path


def bf16_close(got, want):
    """The card's bar for the bf16 kernels: |got - want| <= 2^-7 |want| +
    2^-8 max|want|, elementwise; returns (within, max |got - want|)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bar = BF16_ULP * want.abs() + 2.0 ** -8 * want.abs().max()
    return bool((err <= bar).all()), err.max().item()


def phase_bf16_kernel(card):
    """12(a): the bf16 kernel instances against their plain bf16 versions,
    forward and backward (through autograd), a second call bitwise equal;
    then timed beside the plain bf16 version, one bf16
    ``scaled_dot_product_attention`` call and the float32 kernel.  Returns
    the worst errors and the timings per shape."""
    import torch
    import torch.nn.functional as F

    from flexdm_tpu_torch.ops import attention as attn

    bf16 = torch.bfloat16
    g = torch.Generator().manual_seed(12)
    cases = [  # (B, H, S, Dh), causal, fully masked last batch row
        ((8, 8, 50, 32), False, False),
        ((8, 8, 50, 32), True, True),
        ((256, 8, 50, 32), False, True),
        (FLAT_SHAPE, False, True),
        (EVAL_FLAT_SHAPE, False, True),
        ((2, 4, 650, 32), True, True),
        ((8, 8, 650, 32), False, False),
        ((1, 2, 4096, 64), False, False),
        ((1, 2, 4096, 64), True, True),
    ]
    cases += [((2, 2, s, dh), True, True)
              for s in (16, 17, 63, 64, 65, 128, 129) for dh in (32, 64, 128)]
    worst = dict.fromkeys(("O", "lse", "delta", "dq", "dk", "dv"), 0.0)
    n_cases = 0
    for shape, causal, mask in head_dim_cases(cases, g, streams=()):
        n_cases += 1
        b, h, s, dh = shape
        q, k, v, do = (torch.randn(shape, generator=g).to("cuda", bf16)
                       for _ in range(4))
        fully_masked = not mask[-1].any().item()
        bias = attn.key_bias(mask, b, s, q.device)
        o, lse, m, l = attn._forward(q, k, v, mask, causal)
        again = attn._forward(q, k, v, mask, causal)
        check(all(torch.equal(x, y) for x, y in zip((o, lse, m, l), again)),
              f"two bf16 forward calls differ at {shape} causal={causal}")
        check(o.dtype == bf16 and lse.dtype == torch.float32,
              f"bf16 forward wrote {o.dtype}, {lse.dtype}")
        ok, err = bf16_close(o, attn.attention_reference(q, k, v, bias,
                                                         causal))
        check(ok, f"bf16 O differs at {shape} causal={causal}: {err}")
        worst["O"] = max(worst["O"], err)
        ref_lse = attn.attention_reference_lse(q, k, bias, causal)
        check(torch.allclose(lse, ref_lse, **KERNEL_TOL),
              f"bf16 lse differs at {shape}")
        worst["lse"] = max(worst["lse"], (lse - ref_lse).abs().max().item())
        # The dq kernel alone on the kernels' rows of Dh (a zero-padded
        # copy where ``head_dim_plan`` says so).
        rows = attn._padded(dh, bf16, q, k, v, o, do)
        _, delta = attn._backward_dq(*rows[:3], mask, rows[3], m, l, rows[4],
                                     causal, dh)
        ref_delta = (do.float() * o.float()).sum(-1)
        check(torch.allclose(delta, ref_delta, **KERNEL_TOL),
              f"bf16 delta differs at {shape}")
        worst["delta"] = max(worst["delta"],
                             (delta - ref_delta).abs().max().item())
        grads = []
        for _ in range(2):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            grads.append(torch.autograd.grad(
                attn.dot_product_attention(*leaves, mask, causal), leaves, do))
        check(all(torch.equal(x, y) for x, y in zip(*grads)),
              f"two bf16 backward calls differ at {shape} causal={causal}")
        want = attn.attention_reference_backward(q, k, v, bias, o, do, causal)
        errs = []
        for name, x, w in zip(("dq", "dk", "dv"), grads[0], want):
            ok, err = bf16_close(x, w)
            check(x.dtype == bf16 and ok,
                  f"bf16 {name} differs at {shape} causal={causal}: {err}")
            worst[name] = max(worst[name], err)
            errs.append(err)
        torch.cuda.synchronize()
        log(f"[bf16 kernel] {shape} causal={causal} fully_masked_row="
            f"{fully_masked}: max|d(dq, dk, dv)| {errs[0]:.2e} {errs[1]:.2e} "
            f"{errs[2]:.2e} (bar one bf16 ulp + 2^-8 max|ref|); O, lse, "
            f"delta within their bars; second calls bitwise equal")

    fwd_t, bwd_t = {}, {}
    # crello_scaled's width (D=512 over 8 heads of 64) beside the paths'.
    for shape in ((8, 8, 50, 32), (256, 8, 50, 32), FLAT_SHAPE,
                  EVAL_FLAT_SHAPE, (2048, 8, 50, 64)) + HEAD_DIM_TIMED:
        b, h, s, dh = shape
        q, k, v = (torch.randn(shape, generator=g).to("cuda", bf16)
                   for _ in range(3))
        q32, k32, v32 = (t.float() for t in (q, k, v))
        mask = torch.ones(b, s, dtype=torch.bool)
        mask[:, s - s // 5:] = False
        mask = mask.cuda()
        every = torch.ones_like(mask)
        bias = attn.key_bias(mask, b, s, q.device)
        sdpa_mask = bias.to(bf16)[:, None, None, :]
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=sdpa_mask)
        unmasked = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v)
        t = {
            "ms": device_ms(lambda: attn.flash_attention_forward(q, k, v,
                                                                 mask)),
            "plain_ms": device_ms(lambda: attn.attention_reference(q, k, v,
                                                                   bias)),
            "library_ms": device_ms(library),
            "f32_ms": device_ms(lambda: attn.flash_attention_forward(
                q32, k32, v32, mask)),
            # Every key attended: the kernel with an all-True mask, the
            # library with none (another SDPA backend).
            "unmasked": {
                "ms": device_ms(lambda: attn.flash_attention_forward(
                    q, k, v, every)),
                "library_ms": device_ms(unmasked)},
        }
        t.update(forward_bound(shape, 2, BF16_FLOPS))
        fwd_t[shape] = t
        log(f"[time] bf16 attention {shape} device time (CUDA graph of 20 "
            f"calls, median of 50), last fifth of the keys masked: kernel "
            f"{t['ms']:.4f} ms, plain bf16 {t['plain_ms']:.4f} ms, library "
            f"(bf16 scaled_dot_product_attention with the additive key "
            f"bias, O only; {sdpa_kernels(library)}) {t['library_ms']:.4f} "
            f"ms, float32 kernel {t['f32_ms']:.4f} ms; every key attended: "
            f"kernel {t['unmasked']['ms']:.4f} ms, library (no mask; "
            f"{sdpa_kernels(unmasked)}) {t['unmasked']['library_ms']:.4f} "
            f"ms; bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
            f"exponential floor {t['exp_floor_ms']:.4f} ms [{card}]")
    for shape in ((256, 8, 50, 32), (1, 2, 4096, 64), FLAT_SHAPE) \
            + HEAD_DIM_TIMED:
        b, h, s, dh = shape
        q, k, v, do = (torch.randn(shape, generator=g).to("cuda", bf16)
                       for _ in range(4))
        mask = torch.ones(b, s, dtype=torch.bool)
        mask[:, s - s // 5:] = False
        mask = mask.cuda()
        bias = attn.key_bias(mask, b, s, q.device)
        sdpa_mask = bias.to(bf16)[:, None, None, :]
        o, _, m, l = attn._forward(q, k, v, mask, False)
        _, delta = attn._backward_dq(q, k, v, mask, o, m, l, do)
        q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
        o32, _, m32, l32 = attn._forward(q32, k32, v32, mask, False)
        _, delta32 = attn._backward_dq(q32, k32, v32, mask, o32, m32, l32,
                                       do32)

        def fwd_bwd(forward, backward=False):
            # Leaves made inside the captured function (see phase 4).
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = forward(*leaves)
            return torch.autograd.grad(out, leaves, do) if backward else out

        def plain(*x):
            return attn.attention_reference(*x, bias)

        def library(*x):
            return F.scaled_dot_product_attention(*x, attn_mask=sdpa_mask)

        t = {name: device_ms(fn) for name, fn in {
            "dq": lambda: attn._backward_dq(q, k, v, mask, o, m, l, do),
            "dkv": lambda: attn._backward_dkv(q, k, v, mask, m, l, delta, do),
            "f32_dq": lambda: attn._backward_dq(q32, k32, v32, mask, o32,
                                                m32, l32, do32),
            "f32_dkv": lambda: attn._backward_dkv(q32, k32, v32, mask, m32,
                                                  l32, delta32, do32),
            "plain_fwd": lambda: fwd_bwd(plain),
            "plain_fwd_bwd": lambda: fwd_bwd(plain, True),
            "library_fwd": lambda: fwd_bwd(library),
            "library_fwd_bwd": lambda: fwd_bwd(library, True),
        }.items()}
        t["plain"] = t["plain_fwd_bwd"] - t["plain_fwd"]
        t["library"] = t["library_fwd_bwd"] - t["library_fwd"]
        t["bounds"] = dict(zip(("dq", "dkv"),
                               backward_bounds(shape, 2, BF16_FLOPS)))
        bwd_t[shape] = t
        flops = 14 * b * h * s * s * dh  # 7 products of 2 S^2 Dh
        log(f"[time] bf16 attention backward {shape} device time (CUDA graph"
            f" of 20 calls, median of 50): dq {t['dq']:.4f} ms, dkv "
            f"{t['dkv']:.4f} ms (together {flops / (t['dq'] + t['dkv']) / 1e9:.1f}"
            f" TFLOP/s); float32 kernels dq {t['f32_dq']:.4f} ms, "
            f"dkv {t['f32_dkv']:.4f} ms; plain bf16 autograd backward "
            f"{t['plain']:.4f} ms; library bf16 backward "
            f"(scaled_dot_product_attention, "
            f"{sdpa_kernels(lambda: fwd_bwd(library, True))}) "
            f"{t['library']:.4f} ms; bounds dq "
            f"{t['bounds']['dq']['bound_ms']:.4f} ms "
            f"({t['bounds']['dq']['bound_by']}), dkv "
            f"{t['bounds']['dkv']['bound_ms']:.4f} ms "
            f"({t['bounds']['dkv']['bound_by']}) [{card}]")
    log(f"[bf16 kernel] worst errors over {n_cases} cases: "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    return worst, fwd_t, bwd_t


def model_distance(a, b):
    """Mean and max |a - b| over every decoder output, in float32."""
    import torch

    diffs = torch.cat([(a[k].float().cpu() - b[k].float().cpu()).abs()
                       .flatten() for k in sorted(b)])
    return diffs.mean().item(), diffs.max().item()


def phase_bf16_parity(args, spec, batch, label):
    """12(b)/(c): the bf16 model (dropout 0) on the card against the same
    bf16 model on the CPU: the decoder outputs on the step's masked batch
    (mean |difference|; the largest within twice) and the loss of one
    training step (the same draws) no farther from the CPU's bf16 ones than
    those are from the CPU's float32 ones.  The two bf16 runs round their
    products in other orders, and a flipped rounding travels through the
    blocks, so the card's distance is of the same order as bf16's own."""
    import torch

    from flexdm_tpu_torch.config import TrainConfig, build_model
    from flexdm_tpu_torch.convert import init_params
    from flexdm_tpu_torch.models import make_task_config
    from flexdm_tpu_torch.models.masking import draw_train, \
        preprocess_for_train
    from flexdm_tpu_torch.train.optim import KerasAdam
    from flexdm_tpu_torch.train.trainer import make_train_step

    schema = spec.schema
    config = TrainConfig.from_args(dict(args, dropout=0.0))
    cpu32 = init_params(build_model(TrainConfig.from_args(
        dict(args, dropout=0.0, dtype=None)), schema), 0)
    cpu16 = build_model(config, schema)
    cpu16.load_state_dict(cpu32.state_dict())
    card16 = copy.deepcopy(cpu16).cuda()
    task_config = make_task_config(schema, config.masking_method)
    b = batch["length"].shape[0]
    draws = draw_train(schema, b, task_config.task_probs,
                       torch.Generator().manual_seed(3),
                       **cpu16.draw_options())
    _, modified, _ = preprocess_for_train(
        batch, schema, draws.tasks, draws.uniforms, draws.element,
        draws.values)
    outputs = {}
    with torch.no_grad():
        for where, model in (("cpu32", cpu32), ("cpu16", cpu16),
                             ("card16", card16)):
            device = "cuda" if where == "card16" else "cpu"
            outputs[where] = model({k: v.to(device)
                                    for k, v in modified.items()})
    check(all(v.dtype == torch.bfloat16 for v in outputs["card16"].values()),
          f"{label}: bf16 outputs are not bf16")
    card_d = model_distance(outputs["card16"], outputs["cpu16"])
    ref_d = model_distance(outputs["cpu16"], outputs["cpu32"])
    losses = {}
    for where, model in (("cpu32", cpu32), ("cpu16", cpu16),
                         ("card16", card16)):
        device = "cuda" if where == "card16" else "cpu"
        adam = KerasAdam(model.parameters(), config.learning_rate)
        metrics = make_train_step(model, task_config, adam, config.l2)(
            {k: v.to(device) for k, v in batch.items()}, draws.to(device))
        losses[where] = metrics["loss"].item()
        check(all(p.dtype == torch.float32 for p in model.parameters())
              and all(mu.dtype == torch.float32 for mu in adam.mu),
              f"{label}: a parameter or Adam moment left float32")
    card_l = abs(losses["card16"] - losses["cpu16"])
    ref_l = abs(losses["cpu16"] - losses["cpu32"])
    log(f"[bf16] {label} parity, batch {b}: decoder outputs card-vs-CPU bf16 "
        f"mean {card_d[0]:.3e} max {card_d[1]:.3e}, CPU bf16-vs-float32 mean "
        f"{ref_d[0]:.3e} max {ref_d[1]:.3e}; loss card bf16 "
        f"{losses['card16']:.6f}, CPU bf16 {losses['cpu16']:.6f}, CPU "
        f"float32 {losses['cpu32']:.6f} (|card - CPU bf16| {card_l:.2e}, "
        f"|CPU bf16 - float32| {ref_l:.2e})")
    check(card_d[0] <= ref_d[0] and card_d[1] <= 2 * ref_d[1],
          f"{label}: card bf16 outputs {card_d} (mean, max) from the CPU's, "
          f"farther than CPU bf16 from float32 {ref_d} (max: twice)")
    check(card_l <= max(ref_l, 1e-5 * abs(losses["cpu32"])),
          f"{label}: card bf16 loss {card_l} from the CPU's, farther than "
          f"CPU bf16 from float32 {ref_l}")


def phase_bf16(card, root, data_dir, spec, batch, data, f32_losses,
               f32_step_ms, f32_flat_ms):
    """12(b) crello Ours-EXP and 12(c) crello_flat in bf16: parity, 30
    steps (crello's tracking phase 8's float32 losses within 5%), the
    bf16 CLI run served and evaluated.  Returns the step times and the
    launches per path."""
    t0 = time.perf_counter()
    args = dict(load_args(CONFIG, data_dir), dtype=BF16)
    label = "crello Ours-EXP bf16"
    phase_bf16_parity(args, spec, batch, label)
    step_ms, losses, counts, _ = phase_train_steps(args, spec, batch, card,
                                                   label)
    drift = [abs(a - b) / abs(a) for a, b in zip(f32_losses, losses)]
    log(f"[bf16] {label}: {TRAIN_STEPS} steps track phase 8's float32 run "
        f"from the same init, draws and dropout: largest relative loss gap "
        f"{max(drift):.2%} (bar 5%); median step {step_ms:.2f} ms against "
        f"float32 {f32_step_ms:.2f} ms [{card}]")
    check(max(drift) < 0.05, f"{label}: bf16 losses drift from float32: "
          f"{list(zip(f32_losses, losses))}")
    cli_counts, _, _, job = phase_train_cli(root, data_dir, card, BF16)
    eval_counts = eval_run(card, root, label, job, "all_feat",
                           data["crello"])

    flat_args = dict(load_args(FLAT_CONFIG, data_dir), dtype=BF16)
    flat_batch = {k: v[:FLAT_BATCH] for k, v in batch.items()}
    phase_bf16_parity(flat_args, spec, {k: v[:FLAT_PARITY_DOCS]
                                        for k, v in flat_batch.items()},
                      f"crello_flat bf16 ({FLAT_PARITY_DOCS} documents)")
    flat_ms, _, flat_counts, flat_model = phase_train_steps(
        flat_args, spec, flat_batch, card, "crello_flat bf16")
    log(f"[bf16] crello_flat: median step {flat_ms:.2f} ms against float32 "
        f"{f32_flat_ms:.2f} ms (batch {FLAT_BATCH}) [{card}]")
    flat_eval_counts = flat_bf16_elem(card, root, flat_args, flat_model, data)
    log(f"[bf16] phase done in {time.perf_counter() - t0:.1f} s")
    return step_ms, flat_ms, {
        "crello_ours_exp_bf16_steps": counts,
        "crello_ours_exp_bf16_cli": cli_counts,
        "crello_ours_exp_bf16_eval": eval_counts,
        "crello_flat_bf16_steps": flat_counts,
        "crello_flat_bf16_eval": flat_eval_counts,
    }


FLAT_BF16_EVAL_DOCS = 512  # 12(c)'s elem eval: the first of phase 11's


def flat_bf16_elem(card, root, args, model, data):
    """12(c): the trained bf16 crello_flat weights scored with ``elem``
    through the harness, resident, on the first ``FLAT_BF16_EVAL_DOCS``
    documents of phase 11's crello split (forwards at (256, 8, 500, 32)):
    the bf16 forward launched once a block a forward and no other kernel,
    the sums finite and equal to the same harness run with
    ``--attention_impl xla`` on the card at bf16's bars (numerical Σnum
    within one bf16 ulp relative, categorical Σnum equal apart from near
    ties, counted).  Returns the kernels' launch counts."""
    import torch

    from flexdm_tpu_torch.demo import load_model
    from flexdm_tpu_torch.evaluation import harness

    t0 = time.perf_counter()
    label = f"crello_flat bf16 elem ({FLAT_BF16_EVAL_DOCS} documents)"
    job = os.path.join(root, "flat_bf16_job")
    write_job(job, args, model)
    kernels, spec = load_model(job, batch_size=EVAL_BATCH, device="cuda",
                               data_dir=data["crello"])
    plain, _ = load_model(job, batch_size=EVAL_BATCH, device="cuda",
                          data_dir=data["crello"], attention_impl="xla")
    check(kernels.dtype == BF16 and impl_names(plain) == {"xla"},
          f"{label}: models {kernels.dtype} {impl_names(plain)}")
    docs = FirstDocs(spec, FLAT_BF16_EVAL_DOCS)
    cache = harness._make_cache(docs, "cuda")
    blocks = eval_blocks(cache, "elem", spec.schema.max_length)
    num_blocks = len(list(kernels.blocks.children()))
    attn_reset()
    t1 = time.perf_counter()
    got = harness.task_sums(kernels, docs, "elem", None, cache=cache)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t1
    counts = launch_counts()
    check(counts["fwd_bf16"] == num_blocks * blocks
          and not any(n for k, n in counts.items() if k != "fwd_bf16"),
          f"{label}: launches {counts}, not {num_blocks} x {blocks} bf16 "
          "forwards alone")
    check(got and finite(got), f"{label}: sums {got}")
    ties = NearTies(spec.schema, False, BF16_TIE)
    attn_reset()
    t1 = time.perf_counter()
    want = harness.task_sums(plain, docs, "elem", None, cache=cache,
                             observe=ties)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t1
    check(not any(launch_counts().values()),
          f"{label}: --attention_impl xla launched {launch_counts()}")
    rel, cat = compare_sums(label, spec.schema, got, want, ties, BF16_ULP)
    log(f"[bf16] {label}, resident: {blocks} forwards of {ELEM_CHUNK} "
        f"replicas at (256, 8, 500, 32), bf16 forward launched "
        f"{counts['fwd_bf16']} times (= {num_blocks} x {blocks}); sums "
        f"finite and equal to --attention_impl xla on the card (numerical "
        f"Σnum within {rel:.2e} relative, bar {BF16_ULP:g}; categorical "
        f"apart by at most {cat:g}; {ties.fields} masked fields near a "
        f"tie); kernels {kernel_s:.3f} s, xla {plain_s:.3f} s, "
        f"{time.perf_counter() - t0:.1f} s in all [{card}]")
    return counts



# ---------------------------------------------------------------------------
# 13. trainer: the prefetch thread, the device-resident split, resume,
# --enable_profile, remat and the CLI's documents per second.
# ---------------------------------------------------------------------------

TIMED_EPOCHS = 8  # 2 steps an epoch on the 512-record split


def _step_model(args, remat=False, dropout=None):
    """A crello-shaped model (seed 0) on the card with its step, task
    config and a generator on the card (seed 0)."""
    import torch

    from flexdm_tpu_torch.config import TrainConfig, build_model
    from flexdm_tpu_torch.convert import init_params
    from flexdm_tpu_torch.data import DatasetSpec
    from flexdm_tpu_torch.models import make_task_config
    from flexdm_tpu_torch.train.optim import KerasAdam
    from flexdm_tpu_torch.train.trainer import make_train_step

    overrides = {"remat": remat}
    if dropout is not None:
        overrides["dropout"] = dropout
    config = TrainConfig.from_args(dict(args, **overrides))
    schema = DatasetSpec(config.dataset_name, config.data_dir).schema
    task_config = make_task_config(schema, config.masking_method)
    model = init_params(build_model(config, schema), 0).cuda()
    adam = KerasAdam(model.parameters(), config.learning_rate)
    step = make_train_step(model, task_config, adam, config.l2)
    return model, adam, step, task_config, schema


def _draws(model, schema, task_config, b, generator):
    from flexdm_tpu_torch.models.masking import draw_train

    draws = draw_train(schema, b, task_config.task_probs, generator,
                       **model.draw_options())
    draws.dropout = generator
    return draws


def trainer_prefetch(args, spec, card):
    """13(a): the ``Prefetcher`` with the trainer's ``PinnedCopy`` over an
    epoch of the train split (2 repeats of the loader), a training step on
    the main stream reading each batch; each device batch equal to its
    host batch after ``.cpu()``."""
    import torch

    from flexdm_tpu_torch.data import split_device_batch
    from flexdm_tpu_torch.data.pipeline import Prefetcher
    from flexdm_tpu_torch.ops import attention as attn
    from flexdm_tpu_torch.train.trainer import PinnedCopy

    model, _, step, task_config, schema = _step_model(args)
    generator = torch.Generator("cuda").manual_seed(0)

    def loader():
        return spec.make_dataset("train", batch_size=TRAIN_BATCH,
                                 shuffle=True, repeat=True, seed=0,
                                 drop_remainder=True)

    n = 2 * (loader().num_records // TRAIN_BATCH)
    host = iter(loader())
    copy = PinnedCopy("cuda")
    prefetcher = Prefetcher(loader(), depth=2, transform=copy)
    batches = iter(prefetcher)
    attn.reset_launch_counts()
    try:
        for i in range(n):
            batch = copy.take(next(batches))
            metrics = step(batch, _draws(model, schema, task_config,
                                         TRAIN_BATCH, generator))
            want = split_device_batch(next(host))
            check(set(batch) == set(want), f"batch keys {sorted(batch)}")
            for k, v in want.items():
                check(torch.equal(batch[k].cpu(), torch.from_numpy(v)),
                      f"prefetched batch {i}: {k} differs from the host's")
        torch.cuda.synchronize()
    finally:
        prefetcher.close()
    counts = launch_counts()
    check(not prefetcher._thread.is_alive(), "the prefetch thread runs on")
    check(math.isfinite(metrics["loss"].item()), "non-finite loss")
    for name in F32_KERNELS:
        check(counts[name] >= 4 * n, f"{name} launched {counts} in {n} steps")
    log(f"[trainer] Prefetcher + PinnedCopy: {n} batches of {TRAIN_BATCH} "
        f"copied on a side stream while {n} steps ran on the main stream, "
        f"each equal to its host batch; launches {counts}")
    return counts


def _cli(argv, data_dir, job, extra=()):
    """``python -m flexdm_tpu_torch``'s ``main()`` on crello Ours-EXP;
    returns the history, the launches and the seconds."""
    import torch

    from flexdm_tpu_torch.cli import main as train_main
    from flexdm_tpu_torch.ops import attention as attn

    attn.reset_launch_counts()
    t0 = time.perf_counter()
    train_main(["--preset", "crello_ours_exp", "--data_dir", data_dir,
                "--job-dir", job, "--log_level", "WARNING", *argv, *extra])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    with open(os.path.join(job, "logs", "history.jsonl")) as f:
        history = [json.loads(line) for line in f]
    check(all(finite(h) for h in history), f"non-finite history {history}")
    return history, counts, seconds


def _history_gap(a, b):
    """Largest relative differences between two histories' numbers, of the
    training fields and of the validation (``val_*``) ones; wall times
    aside, every other value must be equal."""
    worst = {"train": 0.0, "val": 0.0}
    for x, y in zip(a, b):
        check(set(x) == set(y), f"history keys {sorted(x)} vs {sorted(y)}")
        for k, v in x.items():
            if k == "wall_time":
                continue
            if not isinstance(v, float):
                check(v == y[k], f"history {k}: {v} vs {y[k]}")
                continue
            part = "val" if k.startswith("val_") else "train"
            worst[part] = max(worst[part],
                              abs(v - y[k]) / max(abs(y[k]), 1e-30))
    return worst


def trainer_resume(root, data_dir, card):
    """13(b), 13(c): a 2-epoch ``--input_mode device`` CLI run, then
    ``--resume --num_epochs 3`` on a copy of its job, against a fresh
    3-epoch run with ``--enable_profile`` whose trace names the three
    kernels."""
    import shutil

    job = os.path.join(root, "trainer_job")
    argv = ["--input_mode", "device", "--validation_freq", "1"]
    first, first_counts, _ = _cli(argv + ["--num_epochs", "2"], data_dir,
                                  job)
    resumed_job = job + "_resumed"
    shutil.copytree(job, resumed_job)
    resumed, resume_counts, _ = _cli(
        argv + ["--num_epochs", "3", "--resume"], data_dir, resumed_job)
    fresh_job = os.path.join(root, "trainer_job_fresh")
    fresh, fresh_counts, _ = _cli(
        argv + ["--num_epochs", "3", "--enable_profile"], data_dir,
        fresh_job)
    steps = first[-1]["step"] // 2
    check([h["epoch"] for h in resumed] == [1, 2, 3]
          and resumed[:2] == first, f"resumed history {resumed}")
    check([h["step"] for h in fresh] == [steps, 2 * steps, 3 * steps],
          f"fresh history {fresh}")
    # One epoch of training (the forward also runs in validation and test).
    check(resume_counts["dq"] == resume_counts["dkv"] == 4 * steps
          and resume_counts["fwd"] >= 4 * steps,
          f"the resumed run (1 epoch) launched {resume_counts}")
    # Training fields to the step's loss bar, validation fields to the
    # eval sums' bar (PERF.md section 2): the card's validation losses
    # differ from run to run by ~1e-6 even where the training losses are
    # bitwise equal.
    gap = _history_gap(resumed, fresh)
    check(gap["train"] <= 1e-5 and gap["val"] <= EVAL_RTOL,
          f"resumed history differs from the fresh run by {gap} "
          f"(relative): {resumed} vs {fresh}")
    log(f"[trainer] --input_mode device: 2 epochs, then --resume to 3 on a "
        f"copy of the job, against a fresh 3-epoch run: largest relative "
        f"history difference {gap['train']:.3e} in the training fields "
        f"(bar 1e-5), {gap['val']:.3e} in the validation ones (bar "
        f"{EVAL_RTOL:g}); the 2-epoch run against the fresh run's first 2 "
        f"epochs: {_history_gap(first, fresh[:2])}; launches 2-epoch "
        f"{first_counts}, resumed epoch {resume_counts}")

    traces = [os.path.join(dirpath, f) for dirpath, _, files in
              os.walk(os.path.join(fresh_job, "logs", "trace"))
              for f in files if f.endswith(".json")]
    check(len(traces) == 1, f"--enable_profile wrote {traces}")
    with open(traces[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    found = {kernel: sum(1 for n in names if kernel in n) for kernel in
             ("flash_fwd_kernel", "flash_bwd_dq_kernel",
              "flash_bwd_dkv_kernel")}
    check(all(found.values()), f"the trace misses a kernel: {found} in "
          f"{sorted(names)[:20]}")
    log(f"[trainer] --enable_profile: {os.path.relpath(traces[0], root)} "
        f"({os.path.getsize(traces[0]) / 1e6:.1f} MB) names "
        f"{sorted(n for n in names if 'flash_' in n)}")
    return {"trainer_device_cli": first_counts,
            "trainer_resume_cli": resume_counts,
            "trainer_profiled_cli": fresh_counts}


def trainer_remat(args, flat_args, spec, batch, card):
    """13(d): one full-width crello Ours-EXP step with ``remat`` against
    the step without it (dropout on, the same draws): loss within 1e-5
    relative, gradients within 1e-5 + 1e-3 of the leaf's largest entry;
    the forward launched twice a block.  Then the peak memory of one
    crello_flat step at batch 64 with and without ``remat``."""
    import torch

    from flexdm_tpu_torch.ops import attention as attn

    b = batch["length"].shape[0]
    device_batch = {k: v.cuda() for k, v in batch.items()}
    results, counts = {}, {}
    for remat in (False, True):
        model, adam, step, task_config, schema = _step_model(args, remat)
        generator = torch.Generator("cuda").manual_seed(5)
        draws = _draws(model, schema, task_config, b, generator)
        attn.reset_launch_counts()
        metrics = step(device_batch, draws)
        torch.cuda.synchronize()
        counts[remat] = launch_counts()
        results[remat] = (metrics["loss"].item(),
                          [mu.cpu() / 0.1 for mu in adam.mu])
        del model, adam, step
    (loss, grads), (r_loss, r_grads) = results[False], results[True]
    check(abs(r_loss - loss) <= 1e-5 * abs(loss),
          f"remat loss {r_loss} vs {loss}")
    worst = 0.0
    for g, r in zip(grads, r_grads):
        err = (g - r).abs().max().item()
        worst = max(worst, err)
        check(err <= 1e-5 + 1e-3 * g.abs().max().item(),
              f"remat gradient differs by {err}")
    check(counts[False]["fwd"] == 4 and counts[True]["fwd"] == 8,
          f"forward launches per step {counts}")
    check(counts[True]["dq"] == counts[True]["dkv"] == 4,
          f"remat backward launches {counts[True]}")
    log(f"[trainer] remat, crello Ours-EXP batch {b}, dropout on: loss "
        f"{r_loss:.6f} vs {loss:.6f}, max |dg| {worst:.2e}; forward "
        f"launches per step {counts[False]['fwd']} without, "
        f"{counts[True]['fwd']} with remat; launches {counts[True]}")

    flat_batch = {k: v[:FLAT_BATCH].cuda() for k, v in batch.items()}
    peak = {}
    for remat in (False, True):
        model, adam, step, task_config, schema = _step_model(flat_args, remat)
        generator = torch.Generator("cuda").manual_seed(5)
        draws = _draws(model, schema, task_config, FLAT_BATCH, generator)
        step(flat_batch, draws)  # Adam's moments exist from here on
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        step(flat_batch, draws)
        torch.cuda.synchronize()
        peak[remat] = (torch.cuda.max_memory_allocated(), start)
        del model, adam, step, draws
        torch.cuda.empty_cache()
    # What was allocated before the step (the weights, Adam state and
    # batch, and whatever earlier phases still hold) is given apart.
    mib = {remat: [x / 2**20 for x in peak[remat]] for remat in peak}
    log(f"[trainer] remat memory, crello_flat batch {FLAT_BATCH} (S=500), "
        f"one step, torch.cuda.max_memory_allocated: without remat "
        f"{mib[False][0]:.1f} MiB ({mib[False][1]:.1f} before the step, "
        f"+{mib[False][0] - mib[False][1]:.1f} in it), with remat "
        f"{mib[True][0]:.1f} MiB ({mib[True][1]:.1f} before, "
        f"+{mib[True][0] - mib[True][1]:.1f}) [{card}]")
    check(peak[True][0] < peak[False][0], f"remat did not lower the peak: "
          f"{peak}")
    return {"trainer_remat_step": counts[True]}


class SerialHostBatches:
    """The parent's host loop, as ``HostBatches``'s stand-in: each batch
    decoded, stacked and copied on the main thread when the step asks for
    it (``to_device(next(batches))``); one process, so no ``rows``."""

    def __init__(self, loader, device, rows=None):
        from flexdm_tpu_torch.train.trainer import to_device

        check(rows is None, f"SerialHostBatches takes no rows ({rows})")

        self._batches, self._device, self._copy = iter(loader), device, \
            to_device

    def __next__(self):
        return self._copy(next(self._batches), self._device)

    def close(self):
        pass


def trainer_docs_per_s(root, data_dir, card):
    """13(e): the CLI's documents per second from ``history.jsonl`` wall
    times after the first epoch (validation only at the end), for host
    mode without the prefetch thread (:class:`SerialHostBatches`), host
    mode with it, and device mode, in turns (A B C C B A)."""
    from flexdm_tpu_torch.train import trainer

    setups = {"host, no prefetch": ["--input_mode", "host"],
              "host, prefetch": ["--input_mode", "host"],
              "device": ["--input_mode", "device"]}
    order = list(setups) + list(reversed(setups))
    rates = {name: [] for name in setups}
    counts = {}
    real = trainer.HostBatches
    for i, name in enumerate(order):
        job = os.path.join(root, f"trainer_rate_{i}")
        if name == "host, no prefetch":
            trainer.HostBatches = SerialHostBatches
        try:
            history, counts[name], _ = _cli(
                setups[name] + ["--num_epochs", str(TIMED_EPOCHS),
                                "--validation_freq", "1000"], data_dir, job)
        finally:
            trainer.HostBatches = real
        steps = history[-1]["step"] - history[0]["step"]
        seconds = history[-1]["wall_time"] - history[0]["wall_time"]
        rates[name].append(steps * TRAIN_BATCH / seconds)
        check(counts[name]["fwd"] >= 4 * history[-1]["step"],
              f"{name}: launches {counts[name]}")
    log(f"[time] CLI documents/s, crello Ours-EXP batch {TRAIN_BATCH}, "
        f"512-record split, epochs 2-{TIMED_EPOCHS} ({TIMED_EPOCHS - 1} x 2 "
        f"steps) from history.jsonl wall times, runs in turns A B C C B A: "
        + "; ".join(f"{name} {', '.join(f'{r:.1f}' for r in rs)}"
                    for name, rs in rates.items()) + f" [{card}]")
    return rates, {"trainer_host_serial_cli": counts["host, no prefetch"],
                   "trainer_host_prefetch_cli": counts["host, prefetch"],
                   "trainer_device_rate_cli": counts["device"]}


def phase_trainer(card, root, data_dir, spec, batch):
    """13. The trainer's input modes, resume, profiling and remat on the
    card; returns the documents per second and the launches per path."""
    t0 = time.perf_counter()
    args = load_args(CONFIG, data_dir)
    paths = {"trainer_prefetch_steps": trainer_prefetch(args, spec, card)}
    paths.update(trainer_resume(root, data_dir, card))
    paths.update(trainer_remat(args, load_args(FLAT_CONFIG, data_dir), spec,
                               batch, card))
    rates, rate_counts = trainer_docs_per_s(root, data_dir, card)
    paths.update(rate_counts)
    log(f"[trainer] phase done in {time.perf_counter() - t0:.1f} s")
    return rates, paths


# ---------------------------------------------------------------------------
# 14. decode and demo: the native record decoder against the pure-Python
# one (arrays and times), and the demo renderer on the card.
# ---------------------------------------------------------------------------

DEMO_DOCS = 8
DEMO_STAGES = ("load_model", "load_batch", "forward_eval", "unbatch",
               "svg_html")
# The same figures from an earlier run of this script, when the port decoded
# in pure Python only (PERF.md section 5).
EARLIER_PYTHON_DECODE_S = 2.147  # crello eval decode
EARLIER_ALL_FEAT_S = 3.220  # crello all_feat harness


def _records_equal(got, want):
    import numpy as np

    return set(got) == set(want) and all(
        got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        and np.array_equal(got[k], want[k]) for k in want)


def decode_parity(data):
    """14(b): every record of the first of the two shards of phase 11's
    test splits (1024 records each) decoded natively equals its
    pure-Python decode, column by column (dtype and shape included); the
    native scan gives the Python scan's payloads, with the CRCs verified
    by the native scan, and by the Python one on the rico shard (on a
    crello shard it takes ~20 s; tests/test_torch_native_io.py holds the
    two CRCs to each other on the CPU)."""
    from flexdm_tpu_torch.data import DatasetSpec, tfrecord

    t0 = time.perf_counter()
    for dataset, data_dir in data.items():
        native = DatasetSpec(dataset, data_dir)
        python = DatasetSpec(dataset, data_dir, native=False)
        check(native._native_decoder is not None
              and native._native_layout is not None,
              f"{dataset}: the native decoder is not in use")
        records = columns = 0
        shards = tfrecord.list_shards(data_dir, "test")
        check(len(shards) == 2, f"{dataset}: test shards {shards}")
        for shard in shards[:1]:
            payloads = tfrecord.read_records(shard, verify_crc=True)
            check(payloads == tfrecord.read_records(
                shard, verify_crc=dataset == "rico", native=False),
                f"{shard}: native and Python scans differ")
            for i, p in enumerate(payloads):
                got = native.decode_record(p)
                check(_records_equal(got, python.decode_record(p)),
                      f"{shard} record {i}: native decode != Python decode")
                records += 1
                columns += len(got)
        check(records == EVAL_DOCS // 2, f"{dataset}: {records} records")
        log(f"[decode] {dataset}: {records} records of the first test "
            f"shard, {columns} columns "
            f"decoded natively = pure Python (np.array_equal, same dtype "
            f"and shape); native scan (verify_crc=True) = Python scan "
            f"(verify_crc={dataset == 'rico'})")
    log(f"[decode] parity in {time.perf_counter() - t0:.1f} s")


def in_turns(runs):
    """Seconds of each ``(name, fn)`` in turns A B B A; ``{name: [s, s]}``."""
    out = {name: [] for name, _ in runs}
    for name, fn in runs + runs[::-1]:
        t0 = time.perf_counter()
        fn()
        out[name].append(time.perf_counter() - t0)
    return out


def decode_breakdown(card, dataset, data_dir):
    """Where one native pass over a test split goes: the shard scan, the
    two C++ passes alone, the rest of ``decode_record`` (Python row
    assembly, vocabulary lookups, bins) and the loader's batch stacking;
    then the eval harness's per-batch host-to-device copy of the split
    (``trainer.to_device``, as ``harness._batches`` makes it)."""
    import numpy as np
    import torch

    from flexdm_tpu_torch.data import DatasetSpec, split_device_batch, \
        tfrecord
    from flexdm_tpu_torch.train.trainer import to_device

    spec = DatasetSpec(dataset, data_dir, EVAL_BATCH)
    t0 = time.perf_counter()
    payloads = [p for shard in tfrecord.list_shards(data_dir, "test")
                for p in tfrecord.read_records(shard)]
    t_read = time.perf_counter() - t0
    numeric, layout = spec._native_decoder, spec._native_layout
    t0 = time.perf_counter()
    for p in payloads:
        numeric(p)
        layout(p)
    t_passes = time.perf_counter() - t0
    t0 = time.perf_counter()
    records = [spec.decode_record(p) for p in payloads]
    t_records = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches = []
    for i in range(0, len(records), EVAL_BATCH):
        chunk = records[i:i + EVAL_BATCH]
        batches.append({k: np.stack([r[k] for r in chunk])
                        for k in chunk[0]})
    t_stack = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches:
        to_device(batch, "cuda")
    torch.cuda.synchronize()
    t_copy = time.perf_counter() - t0
    nbytes = sum(v.nbytes for b in batches
                 for v in split_device_batch(b).values())
    log(f"[time] eval decode breakdown, {dataset} test split ({len(payloads)} "
        f"records): shard scan {t_read:.3f} s, the two C++ passes "
        f"{t_passes:.3f} s, the rest of decode_record (row assembly, "
        f"lookups, bins) {t_records - t_passes:.3f} s, batch stacking "
        f"{t_stack:.3f} s; then the harness's host-to-device copy of the "
        f"{len(batches)} batches ({nbytes / 1e6:.1f} MB) {t_copy:.3f} s "
        f"[{card}]")


def decode_times(card, root, train_dir, data):
    """14(c): the eval decode, the ``random`` harness and the
    ``DeviceDataCache`` build, native and pure Python in turns; phase 11's
    harness times with the native decoder beside the earlier pure-Python
    ones."""
    import torch

    from flexdm_tpu_torch.data import DatasetSpec
    from flexdm_tpu_torch.data.pipeline import DeviceDataCache
    from flexdm_tpu_torch.demo import load_model
    from flexdm_tpu_torch.evaluation import harness

    def fmt(t):
        return ", ".join(f"{k} " + " / ".join(f"{x:.3f}" for x in v) + " s"
                         for k, v in t.items())

    times = {}
    for dataset, data_dir in data.items():
        def one_pass(native, dataset=dataset, data_dir=data_dir):
            return lambda: sum(1 for _ in DatasetSpec(
                dataset, data_dir, EVAL_BATCH, native=native).make_dataset(
                    "test", batch_size=EVAL_BATCH))

        t = in_turns([("native", one_pass(True)),
                      ("Python", one_pass(False))])
        times[dataset] = t
        log(f"[time] eval decode: one pass of a fresh loader over the "
            f"{dataset} test split ({EVAL_DOCS} documents, batches of "
            f"{EVAL_BATCH}), in turns A B B A: {fmt(t)}"
            + (f" (earlier pure-Python run: {EARLIER_PYTHON_DECODE_S} s)"
               if dataset == "crello" else "") + f" [{card}]")

    for dataset, data_dir in data.items():
        decode_breakdown(card, dataset, data_dir)

    model, _ = load_model(os.path.join(root, "train_job"),
                          batch_size=EVAL_BATCH, device="cuda")

    def harness_random(native):
        def run():
            loader = DatasetSpec("crello", data["crello"], EVAL_BATCH,
                                 native=native).make_dataset(
                "test", batch_size=EVAL_BATCH)
            harness.task_sums(model, loader, "random", None, 1)
            torch.cuda.synchronize()
        return run

    t = in_turns([("native", harness_random(True)),
                  ("Python", harness_random(False))])
    times["random"] = t
    log(f"[time] eval harness crello Ours-EXP random, {EVAL_DOCS} documents "
        f"at batch {EVAL_BATCH} (a fresh loader, decode and 8 forwards), in "
        f"turns A B B A: {fmt(t)} [{card}]")
    phase11 = "; ".join(
        f"{label} {mode}{f' --num_iter {n}' if n > 1 else ''} harness "
        f"{h:.3f} s (CLI {c:.3f} s)"
        for (label, mode, n), (c, h) in EVAL_SECONDS.items())
    log(f"[time] eval with the native decoder (phase 11, 12): {phase11}; "
        f"an earlier run's crello all_feat harness with the pure-Python "
        f"decoder: {EARLIER_ALL_FEAT_S} s [{card}]")

    def cache(native):
        def run():
            DeviceDataCache(DatasetSpec("crello", train_dir, TRAIN_BATCH,
                                        native=native).make_dataset("train"),
                            "cuda")
            torch.cuda.synchronize()
        return run

    t = in_turns([("native", cache(True)), ("Python", cache(False))])
    times["cache"] = t
    log(f"[time] DeviceDataCache build over the 512-record crello train "
        f"split (a fresh loader, decode, stack, upload), in turns A B B A: "
        f"{fmt(t)} [{card}]")
    return times


def demo_near_ties(schema, out, rel):
    """Per document of a CPU demo run's ``outputs``: the masked categorical
    fields whose top two logits lie within ``NEAR_TIE`` (+ ``rel`` of the
    top logit) and, under MaskGIT, the confidences that close to their
    round's threshold: where the card may decide otherwise."""
    import numpy as np

    near = np.zeros(len(out["batch"]["length"]), dtype=np.int64)
    for c in schema.modeled:
        if c.is_sequence and c.is_categorical:
            top = np.sort(out["pred"][c.name], -1)[..., -2:]
            tie = ((top[..., 1] - top[..., 0])
                   <= NEAR_TIE + rel * np.abs(top[..., 1]))
            near += (tie & out["masks"][c.name][..., None]).reshape(
                len(near), -1).sum(1)
    for r in out["rounds"]:
        thr = r["threshold"][:, None]
        for conf in r["confidence"].values():
            gap = np.abs(conf - thr)
            near += ((conf > 0) & (gap > 0)
                     & (gap <= NEAR_TIE + rel * thr)).sum(1)
    return near


def compare_demo(label, schema, got, want, bf16):
    """The card's demo outputs against the CPU's: batch, masks and masked
    view equal; per document, every categorical field's argmax equal and
    every numerical field within ``SLICE_TOL`` (bf16: one bf16 ulp),
    except documents that hold a near tie (counted).  Returns (documents
    equal, near-tie fields, largest numerical difference)."""
    import numpy as np

    for part in ("batch", "masks", "view"):
        for k, w in want[part].items():
            if isinstance(w, np.ndarray) and w.dtype != object:
                check(np.array_equal(got[part][k], w),
                      f"{label}: {part} {k} differs between card and CPU")
    near = demo_near_ties(schema, want, BF16_TIE if bf16 else 0.0)
    columns = {c.name: c for c in schema.columns}
    differ, worst = [], 0.0
    for i in range(len(near)):
        same = True
        for name, w in want["pred"].items():
            g, w = got["pred"][name][i], w[i]
            c = columns[name]
            if c.is_categorical and c.is_sequence:
                same &= bool(np.array_equal(g.argmax(-1), w.argmax(-1)))
            elif c.is_categorical:
                same &= bool(np.array_equal(g, w))
            else:
                d = np.abs(g - w)
                bar = (BF16_ULP * np.abs(w) if bf16 else
                       SLICE_TOL["atol"] + SLICE_TOL["rtol"] * np.abs(w))
                worst = max(worst, float(d.max(initial=0.0)))
                same &= bool((d <= bar).all())
        if not same:
            differ.append(i)
    check(all(near[i] for i in differ),
          f"{label}: documents {differ} differ from the CPU's with no near "
          f"tie (near-tie fields per document {near.tolist()})")
    return len(near) - len(differ), int(near.sum()), worst


def check_page(path, n):
    """The page: ``n`` rows of 3 SVGs (ground truth, masked input,
    prediction), each of which parses as XML."""
    import xml.etree.ElementTree as ET

    with open(path) as f:
        rows = f.read().split("<tr>")[2:]  # after the header row
    check(len(rows) == n, f"{path}: {len(rows)} rows, not {n}")
    for r, row in enumerate(rows):
        cells = [cell.split("</td>")[0] for cell in row.split("<td>")[1:]]
        check(len(cells) == 3, f"{path} row {r}: {len(cells)} cells")
        for cell in cells:
            try:
                root = ET.fromstring(cell)
            except ET.ParseError as e:
                raise SmokeFailure(f"{path} row {r}: {e}")
            check(root.tag.endswith("svg"), f"{path} row {r}: {root.tag}")


def phase_demo(card, root):
    """14(d): ``python -m flexdm_tpu_torch.demo``'s ``main()`` on the card
    for the float32 crello job of 8(iii) (``pos``, ``elem --num-iter 2``,
    ``elem --element 0``), the rico job of 9 (``pos``) and the bf16 job of
    12(b) (``pos``), ``DEMO_DOCS`` documents each; each page checked, its
    predictions against a CPU ``run_demo`` of the same job and batch, the
    forward of its dtype launched ``num_blocks x num_iter`` times at least
    and no other kernel.  Returns the launches of the five runs."""
    import torch

    from flexdm_tpu_torch import demo
    from flexdm_tpu_torch.ops import attention as attn

    crello = os.path.join(root, "train_job")
    runs = [
        ("crello Ours-EXP", crello, "pos", 1, None),
        ("crello Ours-EXP", crello, "elem", 2, None),
        ("crello Ours-EXP", crello, "elem", 1, 0),
        ("rico Ours-EXP", os.path.join(root, "rico_job"), "pos", 1, None),
        ("crello Ours-EXP bf16", os.path.join(root, f"train_job_{BF16}"),
         "pos", 1, None),
    ]
    total = None
    for label, job, task, num_iter, element in runs:
        with open(os.path.join(job, "args.json")) as f:
            args = json.load(f)
        dtype = args.get("dtype")
        fwd = kernel_names(dtype)[0]
        name = f"demo_{label.replace(' ', '_')}_{task}_{num_iter}_{element}"
        page = os.path.join(root, name + ".html")
        argv = ["--job-dir", job, "--task", task, "--num-examples",
                str(DEMO_DOCS), "--num-iter", str(num_iter), "--out", page,
                "--device", "cuda"]
        argv += ["--element", str(element)] if element is not None else []
        got, timings = {}, {}
        torch.cuda.synchronize()
        attn.reset_launch_counts()
        demo.main(argv, timings=timings, outputs=got)
        counts = launch_counts()
        total = counts if total is None else {
            k: total[k] + n for k, n in counts.items()}
        check_page(page, DEMO_DOCS)
        check(counts[fwd] >= args["num_blocks"] * num_iter,
              f"{label} {task}: forward launched {counts[fwd]} times for "
              f"{num_iter} forwards x {args['num_blocks']} blocks")
        check(not any(counts[n] for n in ("dq", "dkv", "dq_bf16",
                                          "dkv_bf16")),
              f"{label} {task}: a backward kernel ran: {counts}")
        check_one_instance(counts, dtype, f"demo {label} {task}")
        want = {}
        demo.run_demo(job, task, DEMO_DOCS, num_iter,
                      os.path.join(root, name + "_cpu.html"),
                      element=element, device="cpu", outputs=want)
        schema = demo.load_model(job, device="cpu")[1].schema
        equal, near, worst = compare_demo(f"demo {label} {task}", schema,
                                          got, want, dtype == BF16)
        what = (f"{task}" + (f" --num-iter {num_iter}" if num_iter > 1 else "")
                + (f" --element {element}" if element is not None else ""))
        log(f"[demo] {label} {what}: a page of {DEMO_DOCS} rows x 3 SVGs; "
            f"card = CPU on {equal} of {DEMO_DOCS} documents ({near} "
            f"near-tie fields; numerical fields within {worst:.2e}); "
            f"launches {counts}")
        log(f"[time] demo {label} {what}, {DEMO_DOCS} documents: "
            + ", ".join(f"{k} {timings[k]:.3f} s" for k in DEMO_STAGES)
            + f" [{card}]")
    return total


def phase_decode_demo(card, root, train_dir, data):
    """14. The native decoder (built in phase 2) against the Python one,
    its times, and the demo on the card; returns the demo's launches."""
    from flexdm_tpu_torch.data import tfrecord

    t0 = time.perf_counter()
    check(tfrecord.native_available(), "the native record decoder is off")
    decode_parity(data)
    times = decode_times(card, root, train_dir, data)
    counts = phase_demo(card, root)
    log(f"[decode] phase done in {time.perf_counter() - t0:.1f} s")
    return times, counts


# --- 15. The baselines ------------------------------------------------------

BASELINES = ("canvasvae", "layoutvae", "autoreg", "bart")
BASELINE_BATCH = 64  # the presets' batch
BASELINE_PARITY_DOCS = 16  # the CPU copy's 50-pass LayoutVAE step is slow
BASELINE_STEPS = 5
# LayoutVAE's step runs the blocks 50 times (~3.5 s on the card, slower on
# the CPU): its parity takes fewer documents, its timing fewer steps and
# its CLI epoch a smaller train split, to keep the script inside its time.
LAYOUTVAE_PARITY_DOCS = 4  # the CPU copy's 50 passes: the script's time
LAYOUTVAE_STEPS = 1
LAYOUTVAE_TRAIN_DOCS = 2 * BASELINE_BATCH
BASELINE_ELEM_DOCS = 2  # the CPU's elem decodes: one replica per element
BASELINE_DOCS = 8  # one /predict
CAUSAL_SHAPE = (64, 8, 50, 32)  # AutoReg's and BART's training attention
# The attention key projection's bias gets a zero gradient in exact
# arithmetic; phase 15 holds it to be rounding noise, below this on the
# card and on the CPU, rather than to the other leaves' relative bar.
KEY_BIAS = (".key.bias",)
KEY_BIAS_NOISE = 1e-3
# Attention forward launches of one training step (each also of dq and of
# dk/dv) and of one eval forward, at the presets' 4 blocks and crello's
# S = 50: CanvasVAE 2 + 2 blocks; LayoutVAE 50 passes x 4; AutoReg one
# causal pass (training) or 49 decode steps x 4 + the final pass; BART 2
# encoder blocks + 2 decoder blocks of two attentions (self, cross), the
# decoder 49 + 1 times in the decode.
BASELINE_STEP_LAUNCHES = {"canvasvae": 4, "layoutvae": 200, "autoreg": 4,
                          "bart": 6}
BASELINE_EVAL_LAUNCHES = {"canvasvae": 4, "layoutvae": 200, "autoreg": 200,
                          "bart": 202}


def baseline_launches(name, num_blocks, s):
    """``(per training step, per eval forward)`` forward launches of a
    baseline, counted from its structure."""
    half = max(num_blocks // 2, 1)
    return {"canvasvae": (2 * half, 2 * half),
            "layoutvae": (s * num_blocks, s * num_blocks),
            "autoreg": (num_blocks, s * num_blocks),
            "bart": (3 * half, half + 2 * half * s)}[name]


class PlainOnCard:
    """Counts the calls of the plain attention on CUDA tensors (the kernels
    take every one; this must stay 0) while it is entered."""

    def __init__(self):
        self.calls = 0

    def __enter__(self):
        from flexdm_tpu_torch.ops import attention as attn

        self._plain = plain = attn.attention_reference

        def counted(q, *args, **kwargs):
            if q.is_cuda:
                self.calls += 1
            return plain(q, *args, **kwargs)

        attn.attention_reference = counted
        return self

    def __exit__(self, *exc):
        from flexdm_tpu_torch.ops import attention as attn

        attn.attention_reference = self._plain


class BaselineTies(NearTies):
    """:class:`NearTies` of a baseline's CPU reference, whole rows: a
    decode commits each element's argmaxes and later steps read them, and
    CanvasVAE decodes ``argmax(length_logits)`` elements, so a row with a
    near tie in either may differ anywhere it is masked."""

    def __init__(self, schema, model):
        super().__init__(schema, whole_rows=True)
        self.lengths = []
        if hasattr(model, "length_fc"):
            model.length_fc.register_forward_hook(
                lambda _m, _i, out: self.lengths.append(out.detach()))

    def __call__(self, batch, masks, weight, prediction, rounds):
        super().__call__(batch, masks, weight, prediction, rounds)
        if not self.lengths:
            return
        top = self.lengths.pop().topk(2, -1).values
        near = ((top[:, 0] - top[:, 1]) <= NEAR_TIE) & (weight > 0)
        self.rows += int(near.sum())
        for c in self.columns:
            channels = c.shape[-1] if c.is_categorical else 1
            self.allowance[c.name] += channels * int(
                (masks[c.name] & near[:, None]).sum())


def baseline_parity(args, spec, batch, label):
    """One training step on the card against the same step on a CPU copy:
    dropout 0, the same draws and the same VAE normals (a CPU generator
    of one seed for each).  The loss and every ``*_loss``, ``*_kl`` and
    ``kl_divergence`` term within 1e-5 relative; every clipped gradient
    leaf within 1e-5 + 1e-3 of its largest entry, zero on one side only
    where zero on both (counted), but the attention key biases, whose
    gradient is zero in exact arithmetic: those below ``KEY_BIAS_NOISE``
    on both sides; parameters as in :func:`phase_train_parity`."""
    import torch

    from flexdm_tpu_torch.config import TrainConfig, build_model
    from flexdm_tpu_torch.convert import init_params
    from flexdm_tpu_torch.models import make_task_config
    from flexdm_tpu_torch.models.masking import draw_train
    from flexdm_tpu_torch.models.mfp import draw_options
    from flexdm_tpu_torch.train.optim import KerasAdam
    from flexdm_tpu_torch.train.trainer import make_train_step

    config = TrainConfig.from_args(dict(args, dropout=0.0))
    schema = spec.schema
    task_config = make_task_config(schema, config.masking_method)
    cpu_model = init_params(build_model(config, schema), 0)
    card_model = copy.deepcopy(cpu_model).cuda()
    b = batch["length"].shape[0]
    draws = draw_train(schema, b, task_config.task_probs,
                       torch.Generator().manual_seed(3),
                       **draw_options(cpu_model))
    results = {}
    for where, model in (("cpu", cpu_model), ("cuda", card_model)):
        run = draws.to(where)
        run.vae = torch.Generator().manual_seed(4)
        adam = KerasAdam(model.parameters(), config.learning_rate)
        step = make_train_step(model, task_config, adam, config.l2)
        metrics = step({k: v.to(where) for k, v in batch.items()}, run)
        results[where] = (
            {k: v.item() for k, v in metrics.items()},
            [mu.cpu() / 0.1 for mu in adam.mu],
            [p.detach().cpu() for p in model.parameters()],
        )
    (want_m, want_g, want_p), (got_m, got_g, got_p) = (
        results["cpu"], results["cuda"])
    terms = sorted(k for k in want_m
                   if k.endswith(("loss", "_kl", "kl_divergence")))
    for name in terms:
        err = abs(got_m[name] - want_m[name])
        check(err <= 1e-5 * abs(want_m[name]) + 1e-7,
              f"{label} {name}: card {got_m[name]} vs CPU {want_m[name]}")
    worst_g = worst_p = worst_noise = 0.0
    zero, noise, off = [], [], []
    names = [n for n, _ in cpu_model.named_parameters()]
    for name, g, w, p, wp in zip(names, got_g, want_g, got_p, want_p):
        err = (g - w).abs().max().item()
        if name.endswith(KEY_BIAS):
            # Zero in exact arithmetic (softmax is blind to a shift shared
            # by every key): both sides hold rounding noise, which S passes
            # (LayoutVAE) add up; it must stay noise on both.
            big = max(g.abs().max().item(), w.abs().max().item())
            if big > KEY_BIAS_NOISE:
                off.append(f"{name} (|g| {big:.2e})")
            noise.append(name)
            worst_noise = max(worst_noise, err)
        else:
            worst_g = max(worst_g, err)
            if err > 1e-5 + 1e-3 * w.abs().max().item():
                off.append(f"{name} (|dg| {err:.2e}, max|g| "
                           f"{w.abs().max().item():.2e})")
        if not w.abs().max().item():
            check(not g.abs().max().item(),
                  f"{label}: {name} got a gradient on the card only")
            zero.append(name)
        steady = (g.abs() > 1e-3) & (w.abs() > 1e-3)
        delta = (p - wp).abs()
        if steady.any():
            worst_p = max(worst_p, delta[steady].max().item())
            if delta[steady].max().item() > 1e-6:
                off.append(f"{name}: updated parameters differ")
        if delta.max().item() > 2 * config.learning_rate + 1e-6:
            off.append(f"{name}: updated parameters differ by more than "
                       "2 lr")
    check(not off, f"{label}: {'; '.join(off)}")
    log(f"[baselines] {label} step parity, card vs CPU, {b} documents: "
        f"loss {got_m['loss']:.6f} vs {want_m['loss']:.6f}; "
        + ", ".join(f"{k} {got_m[k]:.6g}" for k in terms if k != "loss")
        + f"; max |dg| {worst_g:.2e} over {len(names) - len(noise)} leaves "
        f"({len(zero)} with no gradient on either side"
        + (f": {', '.join(zero[:6])}{' ...' if len(zero) > 6 else ''}"
           if zero else "")
        + f"); the {len(noise)} attention key biases (zero gradient in "
        f"exact arithmetic) below {KEY_BIAS_NOISE:g} on both sides, apart "
        f"by at most {worst_noise:.2e}; max |dp| {worst_p:.2e} where "
        "|g| > 1e-3")


def baseline_steps(args, spec, batch, card, label, per_step,
                   steps=BASELINE_STEPS):
    """``steps`` timed steps on the card (fixed batch and draws,
    dropout and VAE normals drawn on the card) after one warm step: each
    kernel launched exactly ``per_step`` times a step, the loss finite;
    CUDA-event step times, the peak memory and a ``torch.profiler``
    window.  Returns the median step and the launches."""
    import torch

    from flexdm_tpu_torch.config import TrainConfig, build_model
    from flexdm_tpu_torch.convert import init_params
    from flexdm_tpu_torch.models import make_task_config
    from flexdm_tpu_torch.models.masking import draw_train
    from flexdm_tpu_torch.models.mfp import draw_options
    from flexdm_tpu_torch.ops import attention as attn
    from flexdm_tpu_torch.train.optim import KerasAdam
    from flexdm_tpu_torch.train.trainer import make_train_step

    config = TrainConfig.from_args(args)
    schema = spec.schema
    task_config = make_task_config(schema, config.masking_method)
    model = init_params(build_model(config, schema), 0).cuda()
    step = make_train_step(model, task_config,
                           KerasAdam(model.parameters(), config.learning_rate),
                           config.l2)
    generator = torch.Generator("cuda").manual_seed(0)
    b = batch["length"].shape[0]
    draws = draw_train(schema, b, task_config.task_probs, generator,
                       **draw_options(model))
    draws.dropout = draws.vae = generator
    batch = {k: v.cuda() for k, v in batch.items()}
    step(batch, draws)  # warm
    torch.cuda.synchronize()
    attn.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    losses, times = [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(batch, draws)
        stop.record()
        stop.synchronize()
        losses.append(metrics["loss"].item())
        times.append(start.elapsed_time(stop))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), f"{label}: loss {losses}")
    for name in F32_KERNELS:
        check(counts[name] == per_step * steps,
              f"{label}: {name} launched {counts[name]} times in "
              f"{steps} steps, not {per_step} a step")
    check_one_instance(counts, None, label)
    step_ms = statistics.median(times)
    log(f"[time] train step, {label}, batch {b} (fixed batch and draws, "
        f"dropout and VAE normals on the card; CUDA events, median of "
        f"{steps} warm steps): {step_ms:.2f} ms, "
        f"{b / step_ms * 1e3:.0f} documents/s; min {min(times):.2f} max "
        f"{max(times):.2f} ms; peak memory {peak / 2**20:.1f} MiB "
        f"(+{(peak - base) / 2**20:.1f} MiB over the weights, Adam state and "
        f"batch); launches {per_step} of each kernel a step; losses "
        f"{losses[0]:.3f} ... {losses[-1]:.3f} [{card}]")
    device, attention, kernels, top = profile_steps(
        lambda: step(batch, draws), steps=1)
    log(f"[time] train step, {label}, torch.profiler over 1 more step: "
        f"device kernel time {device:.3f} ms per step ({device / step_ms:.1%}"
        f" of the median step), attention kernels {attention:.3f} ms, "
        f"{kernels:.0f} device kernels per step; most time: {top} [{card}]")
    return step_ms, counts


def baseline_cli(root, data_dir, card, name, per_step, per_forward):
    """``python -m flexdm_tpu_torch --preset crello_{name}`` for one epoch
    in device mode (a step for each 64 train documents of ``data_dir``,
    validation and test on 64 documents each, one batch each): ``best``,
    ``last`` and ``final`` written, the history finite, the launches
    exact."""
    import torch

    from flexdm_tpu_torch.cli import main as train_main

    job = os.path.join(root, f"{name}_job")
    argv = ["--preset", f"crello_{name}", "--data_dir", data_dir,
            "--job-dir", job, "--num_epochs", "1", "--validation_freq", "1",
            "--input_mode", "device", "--log_level", "WARNING"]
    attn_reset()
    t0 = time.perf_counter()
    train_main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    with open(os.path.join(job, "logs", "history.jsonl")) as f:
        history = [json.loads(line) for line in f]
    steps = history[-1]["step"]
    with open(os.path.join(data_dir, "count.json")) as f:
        train_docs = json.load(f)["train"]
    check(len(history) == 1 and steps == train_docs // BASELINE_BATCH,
          f"crello_{name} CLI history {history}")
    check(all(finite(h) for h in history), f"crello_{name}: non-finite "
          "history")
    for ckpt in ("best", "last", "final"):
        check(os.path.exists(os.path.join(job, "checkpoints",
                                          f"{ckpt}.torch.npz")),
              f"crello_{name}: no {ckpt} checkpoint")
    # Validation and test: one batch of 64 documents each, decoded.
    want_fwd = steps * per_step + 2 * per_forward
    check(counts["fwd"] == want_fwd and counts["dq"] == steps * per_step
          and counts["dkv"] == steps * per_step,
          f"crello_{name} CLI launches {counts}: want forward {want_fwd}, "
          f"dq and dk/dv {steps * per_step}")
    check_one_instance(counts, None, f"crello_{name} CLI")
    h = history[0]
    log(f"[baselines] CLI --preset crello_{name} --num_epochs 1 --input_mode "
        f"device: {steps} steps, validation and test in {seconds:.1f} s "
        f"[{card}]; loss {h['loss']:.3f}, val_loss {h['val_loss']:.3f}, "
        f"val_total_score {h['val_total_score']:.4f}; launches {counts} "
        f"(= {steps} x {per_step} + 2 x {per_forward} forwards)")
    return job, counts


def attn_reset():
    import torch

    from flexdm_tpu_torch.ops import attention as attn

    torch.cuda.synchronize()
    attn.reset_launch_counts()


def baseline_eval(card, label, job, per_forward):
    """``random`` and ``elem`` over the job's 64-document test split with
    the harness on the card, every forward launching the kernel exactly
    ``per_forward`` times (timed); card against the CPU on that split
    (``elem``: its first ``BASELINE_ELEM_DOCS`` documents), sums as
    :func:`compare_sums` compares them, whole rows near a tie allowed.
    Returns the launches."""
    import torch

    from flexdm_tpu_torch.demo import load_model
    from flexdm_tpu_torch.evaluation import harness

    card_model, spec = load_model(job, batch_size=BASELINE_BATCH,
                                  device="cuda")
    cpu_model = copy.deepcopy(card_model).cpu()
    schema = spec.schema
    split = spec.make_dataset("test", batch_size=BASELINE_BATCH)
    total = dict.fromkeys(launch_counts(), 0)
    for mode in ("random", "elem"):
        forwards = []
        attn_reset()
        t0 = time.perf_counter()
        sums = harness.task_sums(
            card_model, split, mode, None,
            observe=lambda batch, *_: forwards.append(
                batch["length"].shape[0]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        check(sums and finite(sums), f"{label} {mode}: sums {sums}")
        check(counts["fwd"] == per_forward * len(forwards)
              and not counts["dq"] and not counts["dkv"],
              f"{label} {mode}: launches {counts} for {len(forwards)} "
              f"forwards x {per_forward}")
        check_one_instance(counts, None, f"{label} {mode}")
        for k, n in counts.items():
            total[k] += n
        docs = split if mode == "random" else FirstDocs(spec,
                                                        BASELINE_ELEM_DOCS)
        on_card = sums if mode == "random" else harness.task_sums(
            card_model, docs, mode, None)
        ties = BaselineTies(schema, cpu_model)
        t1 = time.perf_counter()
        want = harness.task_sums(cpu_model, docs, mode, None, observe=ties)
        cpu_s = time.perf_counter() - t1
        rel, cat = compare_sums(f"{label} {mode}", schema, on_card, want,
                                ties)
        scores = harness._ratios(schema, sums)
        log(f"[baselines] {label} eval {mode}: {len(forwards)} forwards "
            f"({sum(forwards)} rows) on the card in {seconds:.3f} s "
            f"[{card}], {counts['fwd']} forward launches ({per_forward} a "
            f"forward); e.g. {dict(list(scores.items())[:3])}; card = CPU on "
            + ("the whole 64-document split" if mode == "random" else
               f"the first {BASELINE_ELEM_DOCS} documents")
            + f" (numerical Σnum within {rel:.2e} relative, categorical Σnum "
            f"apart by at most {cat:g}; {ties.rows} rows near a tie; the "
            f"CPU took {cpu_s:.1f} s)")
    return total


def baseline_serve(card, label, job, spec, per_forward):
    """One ``/predict`` of ``BASELINE_DOCS`` documents over HTTP on the
    job's ``best``: the answers checked, one engine step's launches."""
    from flexdm_tpu_torch.data import split_device_batch
    from flexdm_tpu_torch.serve import InferenceEngine, _jsonable, serve

    engine = InferenceEngine(job, batch_size=BASELINE_DOCS, device="cuda")
    docs = _jsonable(spec.unbatch(split_device_batch(next(iter(
        spec.make_dataset("test", batch_size=BASELINE_DOCS))))))
    server = serve(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        attn_reset()
        body, secs = http(server.server_address[1], "/predict",
                          dict(task="pos", documents=docs))
        counts = launch_counts()
    finally:
        server.shutdown()
        server.server_close()
    check_predictions(spec, "pos", docs, body["predictions"])
    check(counts["fwd"] == per_forward and not counts["dq"],
          f"{label} /predict launched {counts}, want {per_forward}")
    log(f"[baselines] {label} served: /predict pos x{len(docs)} docs: 200 in "
        f"{secs * 1e3:.1f} ms [{card}]; {counts['fwd']} forward launches")


def causal_bound(shape, causal_fraction):
    """:func:`forward_bound` and :func:`backward_bounds` with the products
    cut to the causal band's share of the (query, key) pairs."""
    b, h, s, dh = shape
    rows = b * h * s
    product = 2 * b * h * s * s * dh * causal_fraction
    fwd_bytes = 4 * 4 * rows * dh + 4 * 3 * rows + b * s
    bwd_bytes = 4 * 6 * rows * dh + 4 * 3 * rows + b * s
    return (bound(fwd_bytes, 2 * product),
            bound(bwd_bytes, 3 * product), bound(bwd_bytes, 4 * product))


def phase_causal(card, shape=CAUSAL_SHAPE):
    """The causal kernels alone at ``shape`` (the key mask of a training
    batch: the tails of the rows masked): forward O and lse and dq, dk, dv
    against the plain versions (the kernels' bars); then the forward, dq,
    dk/dv and the plain and library calls timed, the library with the same
    causal key mask as one float mask."""
    import torch
    import torch.nn.functional as F

    from flexdm_tpu_torch.ops import attention as attn

    g = torch.Generator().manual_seed(5)
    b, h, s, dh = shape
    q, k, v, do = (torch.randn(shape, generator=g).cuda() for _ in range(4))
    lengths = torch.randint(1, s + 1, (b,), generator=g)
    mask = (torch.arange(s)[None, :] < lengths[:, None]).cuda()
    bias = attn.key_bias(mask, b, s, q.device)
    o, lse, m, l = attn._forward(q, k, v, mask, True)
    ref_o = attn.attention_reference(q, k, v, bias, True)
    err_o = max((o - ref_o).abs().max().item(),
                (lse - attn.attention_reference_lse(q, k, bias, True)).abs()
                .max().item())
    check(torch.allclose(o, ref_o, **KERNEL_TOL), f"causal O at {shape}")
    got = attn.flash_attention_backward(q, k, v, mask, o, m, l, do, True)
    want = attn.attention_reference_backward(q, k, v, bias, ref_o, do, True)
    err_b = {}
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        err_b[name] = (x - w).abs().max().item()
        check(torch.allclose(x, w, **BACKWARD_TOL),
              f"causal {name} at {shape}: {err_b[name]}")
    _, delta = attn._backward_dq(q, k, v, mask, o, m, l, do, True)
    band = torch.ones(s, s, dtype=torch.bool, device="cuda").triu(1)
    sdpa_mask = bias[:, None, None, :].expand(b, 1, s, s).masked_fill(
        band, attn.NEG_INF).contiguous()

    def plain_fwd(backward=False, forward=None):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = forward(*leaves)
        return torch.autograd.grad(out, leaves, do) if backward else out

    def plain(*x):
        return attn.attention_reference(*x, bias, True)

    def library(*x):
        return F.scaled_dot_product_attention(*x, attn_mask=sdpa_mask)

    calls = {
        "fwd": lambda: attn.flash_attention_forward(q, k, v, mask, True),
        "dq": lambda: attn._backward_dq(q, k, v, mask, o, m, l, do, True),
        "dkv": lambda: attn._backward_dkv(q, k, v, mask, m, l, delta, do,
                                          True),
        "plain_fwd": lambda: plain_fwd(forward=plain),
        "plain_fwd_bwd": lambda: plain_fwd(True, plain),
        "library_fwd": lambda: plain_fwd(forward=library),
        "library_fwd_bwd": lambda: plain_fwd(True, library),
    }
    t = {name: device_ms(fn) for name, fn in calls.items()}
    t["plain_bwd"] = t["plain_fwd_bwd"] - t["plain_fwd"]
    t["library_bwd"] = t["library_fwd_bwd"] - t["library_fwd"]
    fraction = (s + 1) / (2 * s)  # key tiles the band leaves per query row
    fwd_bd, dq_bd, dkv_bd = causal_bound(shape, fraction)
    log(f"[kernel] causal {shape}, the key mask of a training batch: "
        f"max|d(O, lse)| {err_o:.2e} (bound 2e-5 abs + 2e-5 rel), max|dq| "
        f"{err_b['dq']:.2e}, |dk| {err_b['dk']:.2e}, |dv| {err_b['dv']:.2e} "
        f"(bound 1e-4 abs + 1e-4 rel)")
    log(f"[time] causal attention {shape} device time (CUDA graph of 20 "
        f"calls, median of 50): forward {t['fwd']:.4f} ms (plain "
        f"{t['plain_fwd']:.4f}, library {t['library_fwd']:.4f}; bound "
        f"{fwd_bd['bound_ms']:.4f} ms, {fwd_bd['bound_by']}); dq "
        f"{t['dq']:.4f} ms (bound {dq_bd['bound_ms']:.4f}, "
        f"{dq_bd['bound_by']}), dk/dv {t['dkv']:.4f} ms (bound "
        f"{dkv_bd['bound_ms']:.4f}, {dkv_bd['bound_by']}); plain backward "
        f"{t['plain_bwd']:.4f} ms, library backward {t['library_bwd']:.4f} "
        f"ms ({sdpa_kernels(lambda: plain_fwd(True, library))}); the band "
        f"keeps {fraction:.3f} of the products [{card}]")
    return {
        "fwd": {"shape": list(shape), "ms": t["fwd"],
                "plain_ms": t["plain_fwd"], "library_ms": t["library_fwd"],
                "bound_ms": fwd_bd["bound_ms"],
                "bound_by": fwd_bd["bound_by"], "max_abs_err": err_o},
        "dq": {"shape": list(shape), "ms": t["dq"],
               "plain_ms": t["plain_bwd"], "library_ms": t["library_bwd"],
               "bound_ms": dq_bd["bound_ms"], "bound_by": dq_bd["bound_by"],
               "max_abs_err": err_b["dq"]},
        "dkv": {"shape": list(shape), "ms": t["dkv"],
                "plain_ms": t["plain_bwd"], "library_ms": t["library_bwd"],
                "bound_ms": dkv_bd["bound_ms"],
                "bound_by": dkv_bd["bound_by"],
                "max_abs_err": max(err_b["dk"], err_b["dv"])},
    }


def phase_baselines(card, root, data_dir, spec, batch):
    """15. The four baseline presets (crello CanvasVAE, LayoutVAE, AutoReg,
    BART) at full width (D=256, 8 heads, 4 blocks, batch 64) on phase 8's
    512/64/64 split: step parity, timed steps, one CLI epoch (validated,
    ``best``/``last``/``final``), ``random`` and ``elem`` evaluation card
    against CPU, one ``/predict``; every path's launches exact and no
    plain attention on the card; then the causal kernels alone.  Returns
    the launches per path and the causal kernels' figures."""
    from flexdm_tpu_torch.config import TrainConfig
    from flexdm_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    batch = {k: v[:BASELINE_BATCH] for k, v in batch.items()}
    layoutvae_dir = synthetic.generate(
        "crello", os.path.join(root, "layoutvae_data"), LAYOUTVAE_TRAIN_DOCS,
        BASELINE_BATCH, BASELINE_BATCH, seed=0)
    by_path = {}
    with PlainOnCard() as plain:
        for name in BASELINES:
            t1 = time.perf_counter()
            label = f"crello_{name}"
            args = load_args(f"configs/crello_{name}.json", data_dir)
            config = TrainConfig.from_args(args)
            per_step, per_forward = baseline_launches(
                name, config.num_blocks, spec.schema.max_length)
            check((per_step, per_forward) == (BASELINE_STEP_LAUNCHES[name],
                                              BASELINE_EVAL_LAUNCHES[name]),
                  f"{label}: the model launches {per_step} a step and "
                  f"{per_forward} a forward")
            layoutvae = name == "layoutvae"
            docs = LAYOUTVAE_PARITY_DOCS if layoutvae else \
                BASELINE_PARITY_DOCS
            baseline_parity(
                args, spec, {k: v[:docs] for k, v in batch.items()},
                f"{label} ({docs} of the {BASELINE_BATCH} documents)")
            _, by_path[f"{label}_steps"] = baseline_steps(
                args, spec, batch, card, label, per_step,
                LAYOUTVAE_STEPS if layoutvae else BASELINE_STEPS)
            job, by_path[f"{label}_cli"] = baseline_cli(
                root, layoutvae_dir if layoutvae else data_dir, card, name,
                per_step, per_forward)
            by_path[f"{label}_eval"] = baseline_eval(card, label, job,
                                                     per_forward)
            baseline_serve(card, label, job, spec, per_forward)
            check(plain.calls == 0, f"{label}: the plain attention ran "
                  f"{plain.calls} times on the card")
            log(f"[baselines] {label} done in {time.perf_counter() - t1:.1f}"
                " s; no plain attention call on the card")
    causal = phase_causal(card)
    log(f"[baselines] phase done in {time.perf_counter() - t0:.1f} s")
    return by_path, causal


# Phase 16: more than one device.
RANKS = 2
MULTI_STEPS = 3
MULTI_TIMED = 20
MULTI_TIMEOUT = 300  # each spawned group's hard limit, seconds
DP_SHAPE = (TRAIN_BATCH // RANKS, 8, 50, 32)
TP_SHAPE = (TRAIN_BATCH, 8 // RANKS, 50, 32)
FLAT_DP_SHAPE = (FLAT_BATCH // RANKS, 8, 500, 32)
TP_BASELINE_SHAPE = (BASELINE_BATCH, 8 // RANKS, 50, 32)
TP_BASELINE_STEPS = 3
TP_LAYOUTVAE_STEPS = 1  # ~9 s a tensor-parallel LayoutVAE step on one card


def tp_steps(name):
    """16(f)'s steps of baseline ``name``."""
    return TP_LAYOUTVAE_STEPS if name == "layoutvae" else TP_BASELINE_STEPS
TP_ELEM_DOCS = 8  # 16(f)'s AutoReg elem: one chunk of replicas
TP_ELEM_CHUNK = 64
ON_ONE_CARD = dict(devices=["cuda:0"] * RANKS, backend="gloo")
ON_TWO_CARDS = dict(devices=[f"cuda:{r}" for r in range(RANKS)],
                    backend="nccl")


def _grid_steps(args, batch, grid=None, steps=MULTI_STEPS,
                timed=MULTI_TIMED, kinks=False):
    """``steps`` keras-Adam steps of the preset ``args`` (seed 0, dropout
    on) on one fixed global batch, the draws of every step from one card
    generator (seed 5), on ``grid`` (None: this process alone).  Per step:
    the loss over the global batch, the forward, dq and dk/dv launches and
    the forward's q shapes, the step's seconds (host clock, synchronised),
    a digest of the whole parameters and, from rank 0 (or alone), the
    whole parameters and, after step 1, the clipped gradients (``mu /
    0.1``).  Then, unless ``timed`` is 0, ``timed`` steps timed one by one
    with CUDA events after 3 warm ones, the peak memory, and one
    collective's time: the gradient bucket's all-reduce over the data
    ranks, or a block output's over the model ranks.  ``kinks``: the
    :class:`ReluPatterns` of those steps under ``"relu"``."""
    import hashlib

    import torch
    import torch.distributed as dist

    from flexdm_tpu_torch.config import TrainConfig, build_model
    from flexdm_tpu_torch.convert import init_params, params_to_jax
    from flexdm_tpu_torch.data import DatasetSpec
    from flexdm_tpu_torch.models import make_task_config
    from flexdm_tpu_torch.ops import attention as attn
    from flexdm_tpu_torch.parallel import mesh
    from flexdm_tpu_torch.train.optim import KerasAdam
    from flexdm_tpu_torch.train.trainer import global_metrics, \
        make_train_step, step_draws

    config = TrainConfig.from_args(args)
    schema = DatasetSpec(config.dataset_name, config.data_dir).schema
    task_config = make_task_config(schema, config.masking_method)
    model = init_params(build_model(config, schema), 0).cuda()
    adam = KerasAdam(model.parameters(), config.learning_rate)
    b = batch["length"].shape[0]
    rows = None
    if grid is not None:
        mesh.shard_params(model, grid, adam)
        rows = grid.rows(b)
    step = make_train_step(model, task_config, adam, config.l2, grid=grid)
    device_batch = {k: torch.from_numpy(v[slice(None) if rows is None
                                          else rows]).cuda()
                    for k, v in batch.items()}
    generator = torch.Generator("cuda").manual_seed(5)
    primary = grid is None or grid.is_primary
    shapes = []
    # The forward kernel's launch (on the kernels' rows; autograd's path).
    forward = attn._launch_forward

    def counted(q, *rest):
        shapes.append(tuple(q.shape))
        return forward(q, *rest)

    def one_step():
        return step(device_batch, step_draws(model, schema, task_config, b,
                                             generator, rows))

    def whole(tensors):
        names, params = zip(*model.named_parameters())
        return params_to_jax(dict(zip(names,
                                      mesh.gather_tensors(params, tensors))))

    out = {"steps": []}
    relu = ReluPatterns(model) if kinks else None
    attn._launch_forward = counted
    try:
        for i in range(steps):
            if relu is not None and i:
                relu.next_step()
            shapes.clear()
            attn.reset_launch_counts()
            t0 = time.perf_counter()
            metrics = one_step()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = launch_counts()
            loss = (metrics["loss"].item() if grid is None else
                    global_metrics(metrics, grid, b,
                                   len(schema.columns))["loss"])
            params = whole(list(model.parameters()))
            digest = hashlib.sha256(b"".join(
                params[k].tobytes() for k in sorted(params))).hexdigest()
            record = {"loss": loss, "counts": counts, "seconds": seconds,
                      "shapes": sorted(set(shapes)), "digest": digest}
            # Every rank gathers (a collective), rank 0 keeps.
            grads = ({k: v / 0.1 for k, v in whole(adam.mu).items()}
                     if i == 0 else None)
            if primary:
                record["params"] = params
                if grads is not None:
                    record["grads"] = grads
            out["steps"].append(record)
    finally:
        attn._launch_forward = forward
        if relu is not None:
            out["relu"] = relu.close()
    if not timed:
        return out
    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(timed):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        one_step()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    out["step_ms"] = statistics.median(times)
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    if grid is not None:
        if grid.data_size > 1:
            what, group = "gradient bucket over the data ranks", \
                grid.data_group
            n = sum(p.numel() for p in model.parameters())
        else:
            what, group = "block output over the model ranks", \
                grid.model_group
            n = b * schema.max_length * config.latent_dim
        flat = torch.ones(n, device="cuda")
        coll = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            dist.all_reduce(flat, group=group)
            stop.record()
            stop.synchronize()
            coll.append(start.elapsed_time(stop))
        out["collective"] = (what, n * 4, statistics.median(coll))
    return out


def multi_rank(rank, store, args, batch, layouts, devices, backend):
    """Rank ``rank`` of ``RANKS`` on ``devices[rank]``: :func:`_grid_steps`
    on a grid of each ``model_parallel`` of ``layouts`` in turn."""
    from flexdm_tpu_torch.parallel import mesh

    device = devices[rank]
    grid = mesh.init_grid(rank, RANKS, layouts[0], device, backend, store)
    try:
        return [_grid_steps(args, batch, grid if i == 0 else
                            mesh.new_grid(m, device))
                for i, m in enumerate(layouts)]
    finally:
        mesh.teardown()


def multi_eval_rank(rank, store, job, data_dir, tasks):
    """Rank ``rank`` of ``RANKS`` data ranks on ``cuda:0`` under gloo:
    the harness's sums of ``tasks`` over the test split of ``data_dir``
    at ``EVAL_BATCH`` rows (``EVAL_BATCH / RANKS`` a rank), from one cache
    spread over the ranks; with the cache's records, bytes and build
    seconds, and the records this rank decoded."""
    from flexdm_tpu_torch.demo import load_model
    from flexdm_tpu_torch.evaluation import harness
    from flexdm_tpu_torch.parallel import mesh

    grid = mesh.init_grid(rank, RANKS, 1, "cuda:0", "gloo", store)
    try:
        model, spec = load_model(job, batch_size=EVAL_BATCH, device="cuda",
                                 data_dir=data_dir)
        loader = spec.make_dataset("test", batch_size=EVAL_BATCH)
        cache = harness._make_cache(loader, "cuda:0", grid)
        decoded = sum(r is not None for r in loader._decoded)
        sums = {task: harness.task_sums(model, loader, task, group,
                                        grid=grid, cache=cache)
                for task, group in tasks}
        return sums, (cache.shard_size, cache.nbytes, cache.build_seconds,
                      decoded)
    finally:
        mesh.teardown()


# The Dense layers of the CVAE parts that a ReLU follows
# (models/baselines/cvae.py), by the class that holds them.
RELU_DENSE = {"VAEDecoder": ("fc1", "fc2"), "VAEEncoder": ("fc2",),
              "Prior": ("fc",)}


class ReluPatterns:
    """Forward hooks on the Dense layers a ReLU follows in the CVAE parts:
    for every call, each unit's (output feature's) fingerprint of which
    rows it let through, ``sum_r [x_rj > 0] u_r`` with fixed random
    float64 weights ``u``.  Two runs whose summation orders differ put a
    row on the other side of a kink where a pre-activation lies within
    their rounding of 0; the unit's gradient (its kernel column and bias
    entry) then takes that row's term in one run and not in the other.
    :func:`relu_flips` finds those units, as near ties are counted."""

    def __init__(self, model):
        self.steps = [[]]  # per step: [(leaf prefix, fingerprints)]
        self.weights = {}
        self.handles = []
        for name, m in model.named_modules():
            for attr in RELU_DENSE.get(type(m).__name__, ()):
                key = "/".join(["params", *name.split("."), attr])
                self.handles.append(getattr(m, attr).register_forward_hook(
                    self._hook(key)))

    def _hook(self, key):
        import torch

        def hook(_module, _inputs, out):
            x = out.detach().flatten(0, -2)
            rows = x.shape[0]
            if rows not in self.weights:
                self.weights[rows] = torch.rand(
                    rows, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(rows)).to(
                        x.device)
            self.steps[-1].append((key, ((x > 0).double()
                                         * self.weights[rows][:, None])
                                   .sum(0)))
        return hook

    def next_step(self):
        self.steps.append([])

    def close(self):
        """Remove the hooks; per step, ``[(leaf prefix, fingerprints)]``
        as numpy."""
        for h in self.handles:
            h.remove()
        return [[(k, fp.cpu().numpy()) for k, fp in calls]
                for calls in self.steps]


def relu_flips(a, b):
    """Per step, ``{leaf: bool mask}`` (flax layout, kernel ``(in, out)``)
    of the entries of the units whose ReLU let other rows through in the
    two runs' :meth:`ReluPatterns.close`, in that step or an earlier
    one."""
    import numpy as np

    out, units = [], {}
    for calls_a, calls_b in zip(a, b):
        check(len(calls_a) == len(calls_b)
              and [k for k, _ in calls_a] == [k for k, _ in calls_b],
              "the two runs called the CVAE layers otherwise")
        for (key, x), (_, y) in zip(calls_a, calls_b):
            units[key] = units.get(key, False) | (x != y)
        step = {}
        for key, flipped in units.items():
            step[key + "/bias"] = flipped
            step[key + "/kernel"] = flipped[None, :]
        out.append(step)
    return out


def step_gate(label, got, want, lr, flips=None):
    """``got``'s steps against ``want``'s: the loss within 1e-5 relative;
    the clipped gradients of step 1 and the parameters after each step
    within 1e-5 + 1e-3 of the leaf's largest entry, but the attention key
    biases, whose gradient is zero in exact arithmetic: their gradients
    noise below ``KEY_BIAS_NOISE`` on both sides, their parameters within
    2 lr a step (a noise gradient's sign decides a +-lr keras-Adam step);
    and, per step, the entries of ``flips`` (:func:`relu_flips`), held as
    the key biases' parameters and their gradients not compared.  Returns
    the largest differences and ``"kinks"``, the entries past the bar that
    ``flips`` excused."""
    import numpy as np

    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0, "noise": 0.0,
             "kinks": 0}
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        kinks = flips[i] if flips else {}
        rel = abs(g["loss"] - w["loss"]) / abs(w["loss"])
        worst["loss"] = max(worst["loss"], rel)
        check(rel <= 1e-5, f"{label} step {i + 1}: loss {g['loss']} vs "
              f"{w['loss']}")
        pairs = [("param", g["params"], w["params"], 2 * lr * (i + 1))]
        if i == 0:
            pairs.append(("grad", g["grads"], w["grads"], None))
        for kind, a, b, noise_bound in pairs:
            check(set(a) == set(b), f"{label}: leaves {set(a) ^ set(b)}")
            for k in b:
                err = float(abs(a[k] - b[k]).max())
                if k.endswith("/key/bias"):
                    worst["noise"] = max(worst["noise"], err)
                    big = max(float(abs(a[k]).max()), float(abs(b[k]).max()))
                    check(err <= noise_bound + 1e-6 if kind == "param"
                          else big <= KEY_BIAS_NOISE,
                          f"{label} step {i + 1}: {kind} {k} {err:.2e}")
                    continue
                diff = abs(a[k] - b[k])
                bar = 1e-5 + 1e-3 * float(abs(b[k]).max())
                if k in kinks:
                    excused = np.broadcast_to(kinks[k], diff.shape)
                    worst["kinks"] += int((diff[excused] > bar).sum())
                    near = float(diff[excused].max(initial=0.0))
                    check(kind == "grad" or near <= noise_bound + 1e-6,
                          f"{label} step {i + 1}: {kind} {k} near a ReLU "
                          f"kink differs by {near:.2e}")
                    diff = diff[~excused]
                err = float(diff.max(initial=0.0))
                worst[kind] = max(worst[kind], err)
                check(err <= bar, f"{label} step {i + 1}: {kind} {k} "
                      f"differs by {err:.2e}")
    return worst


def check_ranks(label, results, shape, per_step=4):
    """Every rank ends each step with the same parameters, bit for bit,
    and launched the forward, dq and dk/dv ``per_step`` times at
    ``shape``."""
    for i in range(len(results[0]["steps"])):
        digests = {r["steps"][i]["digest"] for r in results}
        check(len(digests) == 1, f"{label} step {i + 1}: the ranks' "
              f"parameters differ")
        for rank, r in enumerate(results):
            step = r["steps"][i]
            counts = {k: step["counts"][k] for k in F32_KERNELS}
            check(counts == dict.fromkeys(F32_KERNELS, per_step)
                  and step["shapes"] == [shape],
                  f"{label} rank {rank} step {i + 1}: launches {counts} "
                  f"at {step['shapes']}, not {per_step} each at {shape}")


def _same_job(a, b):
    """Two jobs' histories (wall times aside) and best/final/last arrays
    are equal, bit for bit; returns what differs."""
    import numpy as np

    from flexdm_tpu_torch.train.checkpoint import checkpoint_path

    differ = []
    histories = []
    for job in (a, b):
        with open(os.path.join(job, "logs", "history.jsonl")) as f:
            histories.append([{k: v for k, v in json.loads(line).items()
                               if k != "wall_time"} for line in f])
    if histories[0] != histories[1]:
        differ.append("history")
    for ckpt in ("best", "final", "last"):
        with np.load(checkpoint_path(a, ckpt)) as x, \
                np.load(checkpoint_path(b, ckpt)) as y:
            if sorted(x.files) != sorted(y.files) or not all(
                    np.array_equal(x[k], y[k]) for k in x.files):
                differ.append(ckpt)
    return differ


def multi_world1(card, root, data_dir):
    """16(a): ``--num_devices 1`` (NCCL, world 1) against two runs without
    a process group, all three under ``torch.use_deterministic_algorithms``
    (with ``CUBLAS_WORKSPACE_CONFIG``, set at the start of the script): the
    two runs alone must agree bit for bit, and the NCCL run with them."""
    import warnings

    import torch

    jobs, runs = {}, {}
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for name, extra in (("alone", ()), ("alone_again", ()),
                                ("nccl1", ("--num_devices", "1"))):
                jobs[name] = os.path.join(root, f"multi_{name}")
                runs[name] = _cli(
                    ["--num_epochs", "2", "--validation_freq", "1"],
                    data_dir, jobs[name], extra)
    finally:
        torch.use_deterministic_algorithms(before)
    nondeterministic = sorted({str(w.message).split(" does not have")[0]
                               for w in caught
                               if "deterministic" in str(w.message)})
    log(f"[multi] (a) deterministic algorithms: ops without a deterministic "
        f"implementation on this card: {nondeterministic or 'none'}")
    again = _same_job(jobs["alone"], jobs["alone_again"])
    check(not again, f"two runs alone differ in {again} under deterministic "
          "algorithms")
    nccl = _same_job(jobs["alone"], jobs["nccl1"])
    check(not nccl, f"NCCL world 1 differs from the run alone in {nccl}")
    log(f"[multi] (a) python -m flexdm_tpu_torch --num_devices 1 (NCCL, "
        f"world 1), 2 epochs: history and best/final/last bitwise the run "
        f"without a process group (and two runs alone bitwise each other); "
        f"{runs['nccl1'][2]:.1f} s vs {runs['alone'][2]:.1f} s; launches "
        f"{runs['nccl1'][1]}")


def multi_layouts(card, data_dir, batch):
    """16(b), (c): data-parallel 2, then tensor-parallel 2, on cuda:0 under
    gloo, against the single-process run of the same global batch.
    Returns the ranks' results, the run alone and the learning rate."""
    from flexdm_tpu_torch.config import TrainConfig
    from flexdm_tpu_torch.parallel import mesh

    args = load_args(CONFIG, data_dir)
    host_batch = {k: v.numpy() for k, v in batch.items()}
    alone = _grid_steps(args, host_batch)
    t0 = time.perf_counter()
    dp, tp = zip(*mesh.spawn(
        multi_rank, RANKS, (args, host_batch, (1, RANKS),
                            ON_ONE_CARD["devices"], ON_ONE_CARD["backend"]),
        timeout=MULTI_TIMEOUT))
    spawned_s = time.perf_counter() - t0
    lr = TrainConfig.from_args(args).learning_rate
    check_ranks("data-parallel 2", dp, DP_SHAPE)
    check_ranks("tensor-parallel 2", tp, TP_SHAPE)
    dp_gap = step_gate("data-parallel 2", dp[0], alone, lr)
    tp_gap = step_gate("tensor-parallel 2", tp[0], dp[0], lr)
    for label, gap, results, shape in (
            ("(b) data-parallel 2 vs alone", dp_gap, dp, DP_SHAPE),
            ("(c) tensor-parallel 2 vs data-parallel 2", tp_gap, tp,
             TP_SHAPE)):
        log(f"[multi] {label}, crello Ours-EXP batch {TRAIN_BATCH}, dropout "
            f"on, {MULTI_STEPS} steps: loss within {gap['loss']:.2e} "
            f"relative, max |dg| {gap['grad']:.2e}, max |dp| "
            f"{gap['param']:.2e} (key biases {gap['noise']:.2e}); the ranks' "
            f"parameters bitwise equal after every step; launches "
            f"fwd/dq/dkv 4/4/4 per rank per step at {shape}")
        for rank, r in enumerate(results):
            what, nbytes, ms = r["collective"]
            log(f"[time] multi {label.split(' vs')[0]} rank {rank}: step "
                f"median {r['step_ms']:.3f} ms ({MULTI_TIMED} steps, CUDA "
                f"events, both ranks on one card), peak memory "
                f"{r['peak_mib']:.1f} MiB; one all-reduce of the {what} "
                f"({nbytes / 2**20:.2f} MiB, gloo) {ms:.3f} ms [{card}]")
    log(f"[time] multi alone: step median {alone['step_ms']:.3f} ms "
        f"({MULTI_TIMED} steps, CUDA events), peak memory "
        f"{alone['peak_mib']:.1f} MiB; the 2-rank spawn (start, groups, "
        f"both layouts) {spawned_s:.1f} s [{card}]")
    return args, dp, tp, lr


def multi_host(card, root, args):
    """16(d): ``train()`` on 2 data ranks in host mode, the trainer's own
    rank loop (its draws and rows, the gradient bucket, ``global_metrics``,
    the validation and test sums over the ranks), against the same run
    alone: both see the same batches, so the training fields agree to the
    step's loss bar and the validation fields and test metrics to the eval
    sums' bar (PERF.md section 2)."""
    from flexdm_tpu_torch.config import TrainConfig
    from flexdm_tpu_torch.train import trainer

    runs, seconds = {}, {}
    for name, extra, where in (("alone", {}, {}),
                               ("ranks", {"num_devices": RANKS}, ON_ONE_CARD)):
        t0 = time.perf_counter()
        runs[name] = trainer.train(TrainConfig.from_args(dict(
            args, job_dir=os.path.join(root, f"multi_host_{name}"),
            num_epochs=2, validation_freq=1, input_mode="host", **extra)),
            **where)
        seconds[name] = time.perf_counter() - t0
    got, want = runs["ranks"], runs["alone"]
    check(len(got["history"]) == 2
          and all(finite(h) for h in got["history"]),
          f"history {got['history']}")
    gap = _history_gap(got["history"], want["history"])
    check(set(got["test_metrics"]) == set(want["test_metrics"]),
          f"test metrics {got['test_metrics']} vs {want['test_metrics']}")
    test = max(abs(v - got["test_metrics"][k]) / max(abs(v), 1e-30)
               for k, v in want["test_metrics"].items())
    check(gap["train"] <= 1e-5 and gap["val"] <= EVAL_RTOL
          and test <= EVAL_RTOL,
          f"2 ranks in host mode against the run alone: history {gap}, "
          f"test metrics {test:.2e} (relative): {got} vs {want}")
    log(f"[multi] (d) train(num_devices={RANKS}, input_mode='host', "
        f"devices=cuda:0 x{RANKS}, gloo), 2 epochs, against the run alone: "
        f"largest relative difference {gap['train']:.3e} in the training "
        f"fields (bar 1e-5), {gap['val']:.3e} in the validation ones and "
        f"{test:.3e} in the test metrics (bar {EVAL_RTOL:g}); "
        f"{seconds['ranks']:.1f} s (spawn included) vs "
        f"{seconds['alone']:.1f} s [{card}]")


def multi_eval(card, root, data_dir, args, data):
    """16(d): a data-parallel job through ``train()``, scored on 2 data
    ranks and alone over phase 11's test split, its best served alone."""
    from flexdm_tpu_torch.config import TrainConfig
    from flexdm_tpu_torch.data import DatasetSpec
    from flexdm_tpu_torch.demo import load_model
    from flexdm_tpu_torch.evaluation import harness
    from flexdm_tpu_torch.parallel import mesh
    from flexdm_tpu_torch.train import trainer

    job = os.path.join(root, "multi_dp_job")
    t0 = time.perf_counter()
    results = trainer.train(TrainConfig.from_args(dict(
        args, job_dir=job, num_epochs=2, validation_freq=1, num_devices=RANKS)),
        **ON_ONE_CARD)
    train_s = time.perf_counter() - t0
    history = results["history"]
    check(len(history) == 2 and history[-1]["step"] == 4
          and all(finite(h) for h in history), f"history {history}")
    argv = ["--job-dir", job, "--batch_size", str(EVAL_BATCH),
            "--task_mode", "all_feat", "--data_dir", data["crello"]]
    t0 = time.perf_counter()
    final = harness.main(argv + ["--num_devices", str(RANKS)], **ON_ONE_CARD)
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    final_alone = harness.main(argv)
    alone_s = time.perf_counter() - t0
    model, spec = load_model(job, batch_size=EVAL_BATCH, device="cuda",
                             data_dir=data["crello"])
    schema = spec.schema
    tasks = eval_tasks(schema, "all_feat")
    t0 = time.perf_counter()
    spread, caches = zip(*mesh.spawn(multi_eval_rank, RANKS,
                                     (job, data["crello"], tasks),
                                     timeout=MULTI_TIMEOUT))
    spread_s = time.perf_counter() - t0
    check(spread[0] == spread[1], "the data ranks' eval sums differ")
    for rank, (records, _, _, decoded) in enumerate(caches):
        check(records == decoded == EVAL_DOCS // RANKS,
              f"rank {rank}: a cache of {records} records, {decoded} "
              f"decoded, not the {EVAL_DOCS // RANKS} of its shard")
    loader = DatasetSpec("crello", data["crello"], EVAL_BATCH).make_dataset(
        "test", batch_size=EVAL_BATCH)
    ans, worst, worst_cat, fields = {}, 0.0, 0.0, 0
    for task, group in tasks:
        ties = NearTies(schema, False)
        want = harness.task_sums(model, loader, task, group, observe=ties)
        rel, cat = compare_sums(f"2 data ranks {task}", schema,
                                spread[0][task], want, ties)
        worst, worst_cat = max(worst, rel), max(worst_cat, cat)
        fields += ties.fields
        ans[task] = harness._ratios(schema, spread[0][task])
    check(harness.merge_results(ans) == final,
          f"the 2-rank CLI gave {final}, its sums {ans}")
    serve_best(job, data_dir, None, "[multi] (d) the data-parallel job's best")
    log(f"[multi] (d) train(num_devices={RANKS}, devices=cuda:0 x{RANKS}, "
        f"gloo), 2 epochs in {train_s:.1f} s; python -m "
        f"flexdm_tpu_torch.evaluation --task_mode all_feat --num_devices "
        f"{RANKS} over {EVAL_DOCS} documents: {final}; the ranks' sums "
        f"against the sums alone: Σden within {EVAL_RTOL}, numerical Σnum "
        f"within {worst:.2e} relative, categorical Σnum apart by at most "
        f"{worst_cat:g} ({fields} masked fields within {NEAR_TIE} of a tie); "
        f"the CLI alone {final_alone}")
    log(f"[time] multi eval all_feat, {EVAL_DOCS} documents at batch "
        f"{EVAL_BATCH}: {RANKS} data ranks on one card {eval_s:.2f} s "
        f"(spawn included; PR 14's streaming ranks: 11.23-12.69 s), alone "
        f"{alone_s:.2f} s; the harness's ranks {spread_s:.2f} s (spawn "
        f"included), each rank's cache "
        + ", ".join(f"{n} records, {b / 2**20:.2f} MiB in {t:.3f} s"
                    for n, b, t, _ in caches) + f" [{card}]")


def multi_nccl(card, args, batch, dp, lr):
    """16(e): data-parallel 2 under NCCL on two cards, held to (b) (the
    ranks bitwise equal, launches as there, each rank's step and
    all-reduce timed); or why not."""
    import torch

    from flexdm_tpu_torch.parallel import mesh

    if torch.cuda.device_count() >= RANKS:
        host_batch = {k: v.numpy() for k, v in batch.items()}
        nccl = [r[0] for r in mesh.spawn(
            multi_rank, RANKS, (args, host_batch, (1,),
                                ON_TWO_CARDS["devices"],
                                ON_TWO_CARDS["backend"]),
            timeout=MULTI_TIMEOUT)]
        check_ranks("NCCL data-parallel 2", nccl, DP_SHAPE)
        gap = step_gate("NCCL data-parallel 2", nccl[0], dp[0], lr)
        log(f"[multi] (e) data-parallel 2 under NCCL on 2 cards vs (b): "
            f"loss within {gap['loss']:.2e}, max |dg| {gap['grad']:.2e}, "
            f"max |dp| {gap['param']:.2e}; the ranks bitwise equal")
        for rank, r in enumerate(nccl):
            what, nbytes, ms = r["collective"]
            log(f"[time] multi (e) NCCL data-parallel 2 rank {rank}: step "
                f"median {r['step_ms']:.3f} ms ({MULTI_TIMED} steps, one "
                f"card each), peak memory {r['peak_mib']:.1f} MiB; one "
                f"all-reduce of the {what} ({nbytes / 2**20:.2f} MiB, NCCL) "
                f"{ms:.3f} ms [{card}]")
    else:
        log(f"[multi] (e) skipped: data-parallel 2 under NCCL needs 2 cards, "
            f"this machine has {torch.cuda.device_count()} (NCCL refuses "
            f"two ranks on one card; (b) ran them under gloo)")


def multi_baseline_rank(rank, store, data_dir, batch, job, devices,
                        backend):
    """Rank ``rank`` of one data rank by ``RANKS`` model ranks: each
    baseline's :func:`_grid_steps` (:func:`tp_steps` steps, no timed
    ones), then :func:`tp_elem` of the AutoReg ``job``."""
    from flexdm_tpu_torch.parallel import mesh

    grid = mesh.init_grid(rank, RANKS, RANKS, devices[rank], backend, store)
    try:
        out = {name: _grid_steps(load_args(f"configs/crello_{name}.json",
                                           data_dir),
                                 batch, grid, tp_steps(name), timed=0,
                                 kinks=grid.is_primary)
               for name in BASELINES}
        out["elem"] = tp_elem(job, data_dir, grid)
        return out
    finally:
        mesh.teardown()


def tp_elem(job, data_dir, grid=None):
    """``elem`` of the job's model over its first ``TP_ELEM_DOCS`` test
    documents in chunks of ``TP_ELEM_CHUNK`` replicas, on ``grid`` (its
    parameters split) or alone (near ties counted): the sums, the forward
    launches and the forwards."""
    from flexdm_tpu_torch.demo import load_model
    from flexdm_tpu_torch.evaluation import harness
    from flexdm_tpu_torch.parallel import mesh

    model, spec = load_model(job, batch_size=BASELINE_BATCH, device="cuda",
                             data_dir=data_dir)
    ties = None
    if grid is not None:
        mesh.shard_params(model, grid)
    else:
        ties = BaselineTies(spec.schema, model)
    forwards = []

    def observe(*args):
        forwards.append(args[0]["length"].shape[0])
        if ties is not None:
            ties(*args)

    attn_reset()
    sums = harness.task_sums(model, FirstDocs(spec, TP_ELEM_DOCS), "elem",
                             None, elem_chunk=TP_ELEM_CHUNK, grid=grid,
                             observe=observe)
    return {"sums": sums, "fwd": launch_counts()["fwd"],
            "forwards": len(forwards), "ties": ties}


def multi_baselines(card, root, data_dir, batch):
    """16(f): each baseline tensor-parallel (one data rank by ``RANKS``
    model ranks; gloo on one card, NCCL on two where there are two), all
    four in one spawn: :func:`tp_steps` steps held to the run alone
    at 16(c)'s step gate, the ranks bitwise equal, the launches a rank a
    step those alone (4 / 200 / 4 / 6) at ``TP_BASELINE_SHAPE``; then
    AutoReg's ``elem`` (phase 15's job) on the grid against alone.
    Returns the launches per path."""
    import torch

    from flexdm_tpu_torch.config import TrainConfig
    from flexdm_tpu_torch.parallel import mesh

    t_phase = time.perf_counter()
    batch = {k: v[:BASELINE_BATCH].numpy() for k, v in batch.items()}
    job = os.path.join(root, "autoreg_job")
    where = ON_TWO_CARDS if torch.cuda.device_count() >= RANKS \
        else ON_ONE_CARD
    t0 = time.perf_counter()
    results = mesh.spawn(multi_baseline_rank, RANKS,
                         (data_dir, batch, job, where["devices"],
                          where["backend"]), timeout=MULTI_TIMEOUT)
    spawned_s = time.perf_counter() - t0
    by_path = {}
    for name in BASELINES:
        args = load_args(f"configs/crello_{name}.json", data_dir)
        lr = TrainConfig.from_args(args).learning_rate
        per_step = BASELINE_STEP_LAUNCHES[name]
        t0 = time.perf_counter()
        alone = _grid_steps(args, batch, None, tp_steps(name), timed=0,
                            kinks=True)
        alone_s = time.perf_counter() - t0
        label = f"(f) crello_{name} tensor-parallel {RANKS}"
        ranks = [r[name] for r in results]
        check_ranks(label, ranks, TP_BASELINE_SHAPE, per_step)
        check(all(st["counts"]["fwd"] == per_step for st in alone["steps"]),
              f"{label}: alone launched {alone['steps'][0]['counts']}")
        flips = relu_flips(ranks[0]["relu"], alone["relu"])
        gap = step_gate(label, ranks[0], alone, lr, flips)
        biases = [m for k, m in flips[-1].items() if k.endswith("/bias")]
        flipped = sum(int(m.sum()) for m in biases)
        units = sum(m.size for m in biases)
        by_path[f"multi_tp_crello_{name}_step"] = ranks[0]["steps"][0][
            "counts"]
        step_s = [[st["seconds"] for st in r["steps"]] for r in ranks]
        log(f"[multi] {label} ({where['backend']}, "
            f"{len(set(where['devices']))} card(s)) vs alone, batch "
            f"{BASELINE_BATCH}, dropout and VAE noise on, "
            f"{tp_steps(name)} steps: loss within {gap['loss']:.2e} "
            f"relative, max |dg| {gap['grad']:.2e}, max |dp| "
            f"{gap['param']:.2e} (key biases {gap['noise']:.2e}); "
            f"{flipped} of {units} CVAE units' ReLUs let other rows "
            f"through, {gap['kinks']} of their entries past the bar; the ranks "
            f"bitwise equal after every step; launches fwd/dq/dkv "
            f"{per_step} each a rank a step at {TP_BASELINE_SHAPE}")
        log(f"[time] multi {label}: steps (host clock) "
            + "; ".join(f"rank {r} " + ", ".join(f"{x:.3f}" for x in t)
                        for r, t in enumerate(step_s))
            + " s; alone "
            + ", ".join(f"{st['seconds']:.3f}" for st in alone["steps"])
            + f" s ({alone_s:.1f} s with the setup) [{card}]")
    per_forward = BASELINE_EVAL_LAUNCHES["autoreg"]
    want = tp_elem(job, data_dir)
    ties = want["ties"]
    check(want["fwd"] == per_forward * want["forwards"],
          f"(f) AutoReg elem alone: {want['fwd']} forward launches for "
          f"{want['forwards']} forwards x {per_forward}")
    for rank, r in enumerate(results):
        got = r["elem"]
        check(got["sums"] == results[0]["elem"]["sums"],
              f"(f) AutoReg elem: rank {rank}'s sums differ from rank 0's")
        check(got["forwards"] == want["forwards"]
              and got["fwd"] == per_forward * got["forwards"],
              f"(f) AutoReg elem rank {rank}: {got['fwd']} forward launches "
              f"for {got['forwards']} forwards x {per_forward}")
    rel, cat = compare_sums("(f) AutoReg elem tensor-parallel",
                            ties.schema, results[0]["elem"]["sums"],
                            want["sums"], ties)
    by_path["multi_tp_crello_autoreg_elem"] = {
        **dict.fromkeys(launch_counts(), 0),
        "fwd": results[0]["elem"]["fwd"]}
    log(f"[multi] (f) AutoReg elem over {TP_ELEM_DOCS} documents "
        f"({want['forwards']} forward(s) of {TP_ELEM_CHUNK} replicas) on "
        f"the 1 x {RANKS} grid = alone: numerical Σnum within {rel:.2e} "
        f"relative, categorical Σnum apart by at most {cat:g} ({ties.rows} "
        f"rows near a tie); the ranks' sums equal; {per_forward} forward "
        f"launches a forward a rank")
    log(f"[time] multi (f) the {RANKS}-rank spawn (start, the four "
        f"baselines' steps, AutoReg elem) {spawned_s:.1f} s; 16(f) "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return by_path


def multi_kernels(card):
    """The kernels at the per-rank shapes, beside their bounds."""
    import torch

    g = torch.Generator().manual_seed(16)
    return {shape: (forward_times(shape, g, card),
                    backward_times(shape, g, card))
            for shape in (DP_SHAPE, TP_SHAPE, FLAT_DP_SHAPE,
                          TP_BASELINE_SHAPE)}


def phase_multi(card, root, data_dir, batch, data):
    """16: crello Ours-EXP at published width on more than one rank."""
    import torch
    import torch.distributed as dist

    t_phase = time.perf_counter()
    log(f"[multi] torch {torch.__version__}, distributed backends: gloo "
        f"{dist.is_gloo_available()}, nccl {dist.is_nccl_available()}; "
        f"{torch.cuda.device_count()} card(s) [{card}]")
    multi_world1(card, root, data_dir)
    args, dp, tp, lr = multi_layouts(card, data_dir, batch)
    multi_host(card, root, args)
    multi_eval(card, root, data_dir, args, data)
    multi_nccl(card, args, batch, dp, lr)
    baseline_counts = multi_baselines(card, root, data_dir, batch)
    kernels = multi_kernels(card)
    causal = phase_causal(card, TP_BASELINE_SHAPE)
    log(f"[time] phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return {"multi_dp_step": dp[0]["steps"][0]["counts"],
            "multi_tp_step": tp[0]["steps"][0]["counts"],
            **baseline_counts}, kernels, causal


# Phase 17: --attention_impl, two nodes, the tools.
NODES = 2
NODES_TIMEOUT = 300  # the two nodes' hard limit, seconds
TOOL_BASELINES = ("canvasvae", "autoreg", "bart_autoreg")  # LayoutVAE: 15


def node_worker():
    """``tests/_torch_node_worker.py`` (imports no JAX), loaded by path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "_torch_node_worker.py")
    spec = importlib.util.spec_from_file_location("_torch_node_worker", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def impl_names(model):
    """The ``attention_impl`` of every attention of ``model``."""
    from flexdm_tpu_torch.models.transformer import MultiHeadAttention

    return {m.attention_impl for m in model.modules()
            if isinstance(m, MultiHeadAttention)}


def impl_step(args, batch, impl, dtype=None):
    """One crello Ours-EXP step on the card (dropout 0, draws from seed 5)
    with ``attention_impl=impl``: the loss, each leaf's clipped gradient
    (``mu / 0.1``), the launches and the plain attention's calls on the
    card."""
    import torch

    overrides = dict(attention_impl=impl)
    if dtype:
        overrides["dtype"] = dtype
    model, adam, step, task_config, schema = _step_model(
        dict(args, **overrides), dropout=0.0)
    check(impl_names(model) == {impl}, f"attentions {impl_names(model)}")
    b = batch["length"].shape[0]
    draws = _draws(model, schema, task_config, b,
                   torch.Generator("cuda").manual_seed(5))
    attn_reset()
    with PlainOnCard() as plain:
        metrics = step({k: v.cuda() for k, v in batch.items()}, draws)
        torch.cuda.synchronize()
    names = [n for n, _ in model.named_parameters()]
    return (metrics["loss"].item(),
            dict(zip(names, (mu.cpu() / 0.1 for mu in adam.mu))),
            launch_counts(), plain.calls)


def impl_gate(label, xla, pallas):
    """A ``pallas`` step (:func:`impl_step`) held to the ``xla`` step at
    8(i)'s gate: loss 1e-5 relative, each gradient leaf within 1e-5 + 1e-3
    of its largest entry, the key biases' (0 in exact arithmetic) noise
    below ``KEY_BIAS_NOISE``; ``xla`` launches nothing and runs the plain
    attention 4 times, ``pallas`` 4 of each float32 kernel and never the
    plain attention.  Returns the largest gradient difference and the key
    biases' noise."""
    loss, grads, counts, plain = xla
    p_loss, p_grads, p_counts, p_plain = pallas
    check(abs(p_loss - loss) <= 1e-5 * abs(loss),
          f"{label}: pallas loss {p_loss} vs xla {loss}")
    worst = noise = 0.0
    for name, g in grads.items():
        err = (p_grads[name] - g).abs().max().item()
        if name.endswith(KEY_BIAS):
            noise = max(noise, g.abs().max().item(),
                        p_grads[name].abs().max().item())
            check(noise <= KEY_BIAS_NOISE,
                  f"{label}: {name}: gradient {noise:.2e}")
            continue
        worst = max(worst, err)
        check(err <= 1e-5 + 1e-3 * g.abs().max().item(),
              f"{label}: pallas gradient of {name} differs from xla's by "
              f"{err:.2e}")
    check(not any(counts.values()) and plain == 4,
          f"{label}: xla step: launches {counts}, plain attention {plain} "
          "times")
    check(p_counts == dict(fwd=4, dq=4, dkv=4, fwd_bf16=0, dq_bf16=0,
                           dkv_bf16=0) and p_plain == 0,
          f"{label}: pallas step: launches {p_counts}, plain attention "
          f"{p_plain}")
    return worst, noise


def impl_steps(args, batch):
    """17(a): the step with ``xla`` against the step with ``pallas``; the
    bf16 step with ``pallas``."""
    loss, grads, counts, plain = xla = impl_step(args, batch, "xla")
    p_loss, p_grads, p_counts, p_plain = pallas = impl_step(args, batch,
                                                            "pallas")
    worst, noise = impl_gate("17(a)", xla, pallas)
    _, _, b_counts, b_plain = impl_step(args, batch, "pallas", BF16)
    check(b_counts == dict(fwd=0, dq=0, dkv=0, fwd_bf16=4, dq_bf16=4,
                           dkv_bf16=4) and b_plain == 0,
          f"bf16 pallas step: launches {b_counts}, plain {b_plain}")
    log(f"[impl] (a) crello Ours-EXP step, batch {TRAIN_BATCH}, dropout 0, "
        f"the same draws: attention_impl pallas against xla: loss "
        f"{p_loss:.6f} vs {loss:.6f}, max |dg| {worst:.2e} (key biases "
        f"noise {noise:.2e}); launches xla {counts} (the plain attention "
        f"{plain} times on the card), pallas {p_counts}, --dtype bfloat16 "
        f"pallas {b_counts}")
    return {"impl_xla_step": counts, "impl_pallas_step": p_counts,
            "impl_pallas_bf16_step": b_counts}


def impl_cli(card, root, data_dir, data):
    """17(a): a 1-epoch CLI job trained with ``--attention_impl xla``:
    it and its ``/predict`` launch no kernel; ``all_feat`` over phase 11's
    split as recorded (xla) and with ``--attention_impl pallas``, the
    second launching the forward once a block a forward, the sums within
    ``EVAL_RTOL`` (near ties counted)."""
    import torch

    from flexdm_tpu_torch.demo import load_model
    from flexdm_tpu_torch.evaluation import harness

    worker = node_worker()
    job = os.path.join(root, "impl_xla_job")
    with PlainOnCard() as trained:
        history, counts, seconds = _cli(
            ["--num_epochs", "1", "--validation_freq", "1",
             "--attention_impl", "xla"], data_dir, job)
    with open(os.path.join(job, "args.json")) as f:
        check(json.load(f)["attention_impl"] == "xla", "args.json")
    check(not any(counts.values()) and trained.calls > 0,
          f"xla CLI launches {counts}, plain attention {trained.calls}")

    engine, serve_counts, served, secs, docs = serve_once(job, data_dir)
    check(impl_names(engine.model) == {"xla"}, "served impl")
    check(not any(serve_counts.values()) and served == 4,
          f"/predict of the xla job: launches {serve_counts}, plain "
          f"{served}")

    argv = ["--job-dir", job, "--batch_size", str(EVAL_BATCH),
            "--task_mode", "all_feat", "--data_dir", data["crello"]]
    sums, eval_counts, eval_s = {}, {}, {}
    for impl, extra in (("xla", []), ("pallas", ["--attention_impl",
                                                 "pallas"])):
        attn_reset()
        t0 = time.perf_counter()
        with worker.recorded_sums() as sums[impl], PlainOnCard() as plain:
            harness.main(argv + extra)
            torch.cuda.synchronize()
        eval_s[impl] = time.perf_counter() - t0
        eval_counts[impl] = dict(launch_counts(), plain=plain.calls)
    model, spec = load_model(job, batch_size=EVAL_BATCH, device="cuda",
                             data_dir=data["crello"])
    schema = spec.schema
    timed = spec.make_dataset("test", batch_size=EVAL_BATCH)
    cache = harness._make_cache(timed, "cuda")
    forwards = worst = worst_cat = 0
    for task, group in eval_tasks(schema, "all_feat"):
        ties = NearTies(schema, False)
        harness.task_sums(model, timed, task, group, observe=ties,
                          cache=cache)
        rel, cat = compare_sums(f"all_feat {task} pallas vs xla", schema,
                                sums["pallas"][task], sums["xla"][task],
                                ties)
        worst, worst_cat = max(worst, rel), max(worst_cat, cat)
        forwards += eval_blocks(cache, task, schema.max_length)
    num_blocks = len(list(model.blocks.children()))
    check(eval_counts["xla"]["fwd"] == 0 and eval_counts["xla"]["plain"]
          == num_blocks * forwards,
          f"xla eval: {eval_counts['xla']} for {forwards} forwards")
    check(eval_counts["pallas"]["fwd"] == num_blocks * forwards
          and eval_counts["pallas"]["plain"] == 0
          and not any(eval_counts["pallas"][k] for k in
                      ("dq", "dkv", "fwd_bf16", "dq_bf16", "dkv_bf16")),
          f"pallas eval: {eval_counts['pallas']}, not {num_blocks} x "
          f"{forwards} forwards")
    log(f"[impl] (a) python -m flexdm_tpu_torch --attention_impl xla, 1 "
        f"epoch in {seconds:.1f} s: loss {history[-1]['loss']:.3f}, "
        f"args.json records xla, launches {counts} (the plain attention "
        f"{trained.calls} times on the card); its /predict of {len(docs)} "
        f"documents in {secs * 1e3:.1f} ms: launches none, plain "
        f"{served}; all_feat over {EVAL_DOCS} documents as recorded "
        f"(xla, {eval_s['xla']:.2f} s, launches {eval_counts['xla']}) and "
        f"with --attention_impl pallas ({eval_s['pallas']:.2f} s, forward "
        f"launches {eval_counts['pallas']['fwd']} = {num_blocks} x "
        f"{forwards} forwards): numerical Σnum within {worst:.2e} "
        f"relative (bar {EVAL_RTOL:g}), categorical Σnum apart by at most "
        f"{worst_cat:g} [{card}]")
    return {"impl_xla_cli": counts,
            "impl_pallas_eval": {k: v for k, v in
                                 eval_counts["pallas"].items()
                                 if k != "plain"}}


# ---------------------------------------------------------------------------
# 19. head dims: crello Ours-EXP at --latent_dim 128 and 384 (Dh 16, 48).
# ---------------------------------------------------------------------------

def head_dim_steps(args, batch, latent):
    """19(a): one step at ``latent`` with ``pallas`` against ``xla``
    (dropout 0, the same draws) at 8(i)'s gate; at 384 also in bf16, at
    12(b)'s gate: the kernels' loss no farther from the plain bf16 step's
    than that is from the float32 one's.  Each bf16 gradient leaf's
    distance from the plain bf16 step's is logged as a share of bf16's own
    distance from float32 (plus 8(i)'s 1e-5 + 1e-3 of its largest entry),
    not gated: the kernels round p and ds to bf16 operands where the plain
    version keeps float32, and no bf16 gradient bar is set (PERF.md §2);
    the key biases (0 in exact arithmetic) as their noise."""
    label = f"19(a) latent {latent}"
    args = dict(args, latent_dim=latent)
    xla = impl_step(args, batch, "xla")
    pallas = impl_step(args, batch, "pallas")
    worst, noise = impl_gate(label, xla, pallas)
    out = {f"head_dim_{latent}_xla_step": xla[2],
           f"head_dim_{latent}_pallas_step": pallas[2]}
    line = (f"[head dims] (a) crello Ours-EXP --latent_dim {latent} (Dh "
            f"{latent // 8}) step, batch {TRAIN_BATCH}, dropout 0, the same "
            f"draws: pallas loss {pallas[0]:.6f} vs xla {xla[0]:.6f}, max "
            f"|dg| {worst:.2e} (key biases noise {noise:.2e}); launches "
            f"pallas {pallas[2]}, xla none (plain {xla[3]})")
    if latent == max(HEAD_DIM_LATENTS):
        b_xla = impl_step(args, batch, "xla", BF16)
        b_pallas = impl_step(args, batch, "pallas", BF16)
        own = abs(b_xla[0] - xla[0])
        check(abs(b_pallas[0] - b_xla[0]) <= max(own, 1e-5 * abs(b_xla[0])),
              f"{label} bf16: pallas loss {b_pallas[0]} vs xla {b_xla[0]} "
              f"(bf16 vs float32 {own:.3e})")
        worst_b, worst_leaf, noise_b = 0.0, None, 0.0
        for name, g in b_xla[1].items():
            err = (b_pallas[1][name] - g).abs().max().item()
            if name.endswith(KEY_BIAS):
                noise_b = max(noise_b, g.abs().max().item(),
                              b_pallas[1][name].abs().max().item())
                continue
            own_g = (1e-5 + 1e-3 * g.abs().max().item()
                     + (g - xla[1][name]).abs().max().item())
            if err / own_g > worst_b:
                worst_b, worst_leaf = err / own_g, name
        check(not any(b_xla[2].values()) and b_xla[3] == 4,
              f"{label} bf16 xla: {b_xla[2]}, plain {b_xla[3]}")
        check(b_pallas[2] == dict(fwd=0, dq=0, dkv=0, fwd_bf16=4, dq_bf16=4,
                                  dkv_bf16=4) and b_pallas[3] == 0,
              f"{label} bf16 pallas: {b_pallas[2]}, plain {b_pallas[3]}")
        out[f"head_dim_{latent}_pallas_bf16_step"] = b_pallas[2]
        line += (f"; --dtype bfloat16: pallas loss {b_pallas[0]:.6f} vs xla "
                 f"{b_xla[0]:.6f} (bf16 vs float32 {own:.2e}); the largest "
                 f"gradient distance {worst_b:.3f} x bf16's own ({worst_leaf}"
                 f"; key biases noise {noise_b:.2e}), launches "
                 f"{b_pallas[2]}")
    log(line)
    return out


def head_dim_cli(root, data_dir, latent, dtype):
    """19(b): ``python -m flexdm_tpu_torch --latent_dim <latent>`` for one
    epoch (2 steps) with a validation, once with ``--attention_impl
    pallas`` and once with ``xla``: the histories within 1e-5 relative in
    the training fields and ``EVAL_RTOL`` in the validation ones; in bf16
    within one bf16 ulp, the validation scores (argmax accuracies, which a
    near tie flips; the eval CLI of (c) counts those) logged, not gated.
    ``pallas`` launches the forward once for every attention call the
    ``xla`` run made (4 a model forward) and 4 of each backward kernel a
    step, ``xla`` none.  Returns the pallas job and its launches."""
    tag = f"{latent}_{dtype or 'float32'}"
    runs = {}
    for impl in ("pallas", "xla"):
        job = os.path.join(root, f"head_dim_{tag}_{impl}")
        argv = ["--num_epochs", "1", "--validation_freq", "1",
                "--latent_dim", str(latent), "--attention_impl", impl]
        with PlainOnCard() as plain:
            (history, counts, seconds), _ = quiet(
                _cli, argv + (["--dtype", dtype] if dtype else []),
                data_dir, job)
        runs[impl] = (job, history, counts, plain.calls, seconds)
    job, history, counts, plain, seconds = runs["pallas"]
    _, x_history, x_counts, x_plain, x_seconds = runs["xla"]
    steps = history[-1]["step"]
    fwd, dq, dkv = kernel_names(dtype)
    check(not any(x_counts.values()) and x_plain > 0,
          f"19(b) {tag} xla: launches {x_counts}, plain {x_plain}")
    check(plain == 0 and counts[fwd] == x_plain
          and counts[dq] == counts[dkv] == 4 * steps
          and x_plain % 4 == 0, f"19(b) {tag} pallas: launches {counts} "
          f"for {steps} steps, {x_plain} attention calls")
    check_one_instance(counts, dtype, f"19(b) {tag}")
    def gated(h):
        return {k: v for k, v in h.items() if not dtype
                or not (k.startswith("val_") and k.endswith("_score"))}

    gap = _history_gap([gated(h) for h in history],
                       [gated(h) for h in x_history])
    scores = _history_gap(history, x_history)["val"] if dtype else None
    bars = ((BF16_ULP, BF16_ULP) if dtype else (1e-5, EVAL_RTOL))
    check(gap["train"] <= bars[0] and gap["val"] <= bars[1],
          f"19(b) {tag}: pallas history differs from xla's by {gap}: "
          f"{history} vs {x_history}")
    log(f"[head dims] (b) python -m flexdm_tpu_torch --latent_dim {latent}"
        f"{' --dtype ' + dtype if dtype else ''}, 1 epoch ({steps} steps, "
        f"validated): pallas {seconds:.1f} s, launches {counts}; xla "
        f"{x_seconds:.1f} s, the plain attention {x_plain} times; histories"
        f" apart by {gap['train']:.2e} (training) and {gap['val']:.2e} "
        f"(validation), bars {bars[0]:g} / {bars[1]:g}"
        + ("" if scores is None else
           f" (validation scores, not gated: {scores:.2e})")
        + f"; loss {history[-1]['loss']:.4f}")
    return job, counts


def head_dim_eval(job, data_dir, dtype):
    """19(c): ``python -m flexdm_tpu_torch.evaluation`` on the pallas job
    over its 64-document test split, ``elem`` and ``all_feat``, as recorded
    (the kernels) and with ``--attention_impl xla``: the sums at phase
    11's bars (bf16: one bf16 ulp, near ties at ``BF16_TIE``), near ties
    counted; the forward launched once for every attention call of the
    ``xla`` run, no backward kernel."""
    import torch

    from flexdm_tpu_torch.demo import load_model
    from flexdm_tpu_torch.evaluation import harness

    worker = node_worker()
    model, spec = load_model(job, batch_size=EVAL_BATCH, device="cuda")
    schema = spec.schema
    loader = spec.make_dataset("test", batch_size=EVAL_BATCH)
    out, parts = {}, []
    for mode in ("elem", "all_feat"):
        argv = ["--job-dir", job, "--batch_size", str(EVAL_BATCH),
                "--task_mode", mode]
        sums, counts = {}, {}
        for impl in ("pallas", "xla"):
            attn_reset()
            with worker.recorded_sums() as sums[impl], \
                    PlainOnCard() as plain:
                quiet(harness.main, argv + ["--attention_impl", impl])
                torch.cuda.synchronize()
            counts[impl] = dict(launch_counts(), plain=plain.calls)
        fwd = kernel_names(dtype)[0]
        check(counts["pallas"][fwd] == counts["xla"]["plain"] > 0
              and counts["pallas"]["plain"] == 0
              and sum(counts["pallas"].values()) == counts["pallas"][fwd]
              and sum(counts["xla"].values()) == counts["xla"]["plain"],
              f"19(c) {job} {mode}: launches {counts}")
        worst = worst_cat = 0.0
        for task, group in eval_tasks(schema, mode):
            ties = NearTies(schema, False, BF16_TIE if dtype else 0.0)
            harness.task_sums(model, loader, task, group, observe=ties)
            rel, cat = compare_sums(
                f"19(c) {mode} {task} pallas vs xla", schema,
                sums["pallas"][task], sums["xla"][task], ties,
                BF16_ULP if dtype else EVAL_RTOL)
            worst, worst_cat = max(worst, rel), max(worst_cat, cat)
        out[mode] = {k: v for k, v in counts["pallas"].items()
                     if k != "plain"}
        parts.append(f"{mode}: forward launches {counts['pallas'][fwd]} = "
                     f"the xla run's attention calls, numerical Σnum within "
                     f"{worst:.2e}, categorical Σnum apart by at most "
                     f"{worst_cat:g}")
    return out, "; ".join(parts)


def head_dim_serve(job, data_dir, dtype):
    """19(d): the pallas job served over HTTP on the card, ``/predict`` of 8
    documents with ``num_iter`` 1 and 3, against an engine on a copy of
    the job that records ``--attention_impl xla`` (the same weights): the
    decoder outputs of one forward within 1e-4 (bf16: 12(b)'s bar, no
    farther from the plain bf16 model's than those are from the float32
    model's, mean and max within twice), the answers equal but for
    documents with a near tie on the CPU; the forward launched exactly
    4 x ``num_iter`` times a request."""
    import shutil

    import torch

    from flexdm_tpu_torch.config import TrainConfig, build_model
    from flexdm_tpu_torch.data import split_device_batch
    from flexdm_tpu_torch.demo import build_task_masks
    from flexdm_tpu_torch.models.masking import preprocess_for_test
    from flexdm_tpu_torch.serve import InferenceEngine, _jsonable, serve

    xla_job = job + "_served_xla"
    os.makedirs(xla_job)
    shutil.copytree(os.path.join(job, "checkpoints"),
                    os.path.join(xla_job, "checkpoints"))
    with open(os.path.join(job, "args.json")) as f:
        args = json.load(f)
    with open(os.path.join(xla_job, "args.json"), "w") as f:
        json.dump(dict(args, attention_impl="xla"), f)
    engine = InferenceEngine(job, batch_size=BATCH, device="cuda")
    reference = InferenceEngine(xla_job, batch_size=BATCH, device="cuda")
    check(impl_names(engine.model) == {"pallas"}
          and impl_names(reference.model) == {"xla"}, "served impls")
    cpu_model = copy.deepcopy(reference.model).cpu()
    spec = engine.spec
    docs = _jsonable(spec.unbatch(split_device_batch(
        next(iter(spec.make_dataset("test", batch_size=BATCH))))))
    host = {k: torch.from_numpy(v) for k, v in
            spec.batch_documents(docs).items() if v.dtype != object}
    if dtype:  # the same weights computing in float32
        f32 = build_model(TrainConfig.from_args(dict(
            args, dtype=None, attention_impl="xla")), spec.schema)
        f32.load_state_dict(reference.model.state_dict())
        f32 = f32.cuda().eval()
    with torch.inference_mode():
        inputs = preprocess_for_test(host, spec.schema, build_task_masks(
            spec.schema, host, "pos"))
        inputs = {k: v.cuda() for k, v in inputs.items()}
        got, want = engine.model(inputs), reference.model(inputs)
        if dtype:
            ref = model_distance(want, f32(inputs))
    if dtype:
        dist = model_distance(got, want)
        worst = dist[1]
        check(dist[0] <= ref[0] and dist[1] <= 2 * ref[1],
              f"19(d) {job}: bf16 decoder outputs pallas vs xla {dist} "
              f"(mean, max), farther than bf16 from float32 {ref}")
    else:
        worst = 0.0
        for name, value in want.items():
            err = (got[name] - value).abs().max().item()
            worst = max(worst, err)
            check(torch.allclose(got[name], value, **SLICE_TOL),
                  f"19(d) {job}: decoder output {name} pallas vs xla {err}")
    server = serve(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    counts, parts = {}, []
    try:
        for num_iter in (1, MASKGIT_ITERS):
            attn_reset()
            body, secs = http(server.server_address[1], "/predict", dict(
                task="pos", documents=docs, num_iter=num_iter))
            counts[num_iter] = launch_counts()
            preds = body["predictions"]
            check_predictions(spec, "pos", docs, preds)
            fwd = kernel_names(dtype)[0]
            check(counts[num_iter][fwd] == 4 * num_iter
                  and sum(counts[num_iter].values()) == 4 * num_iter,
                  f"19(d) num_iter {num_iter}: launches {counts[num_iter]}")
            want = reference.predict(docs, task="pos", num_iter=num_iter)
            near = maskgit_reference(engine, cpu_model, docs, "pos",
                                     num_iter, BF16_TIE if dtype else 0.0)
            differ = [i for i, (g, w) in enumerate(zip(preds, want))
                      if g != w]
            check(all(near[i] for i in differ),
                  f"19(d) num_iter {num_iter}: documents {differ} differ "
                  f"from xla's with no near tie ({near})")
            parts.append(f"num_iter {num_iter}: 200 in {secs * 1e3:.1f} ms, "
                         f"forward launches {counts[num_iter][fwd]}, "
                         f"{len(docs) - len(differ)} of {len(docs)} answers "
                         f"equal to xla's ({sum(near)} near-tie fields)")
    finally:
        server.shutdown()
        server.server_close()
    within = (f"decoder outputs within {worst:.2e}" if not dtype else
              f"bf16 decoder outputs pallas vs xla mean {dist[0]:.2e} max "
              f"{dist[1]:.2e}, bf16 vs float32 mean {ref[0]:.2e} max "
              f"{ref[1]:.2e}")
    return counts, within + "; " + "; ".join(parts)


def phase_head_dims(card, root, data_dir, batch):
    """19: crello Ours-EXP (4 blocks, 8 heads, S = 50, batch 256) at
    ``--latent_dim`` 128 and 384 (Dh 16 and 48, widths no preset has)
    through the entry points, ``pallas`` against ``xla``: (a) a step, (b)
    the training CLI (float32, and bf16 at 384), (c) the eval CLI's
    ``elem`` and ``all_feat``, (d) ``/predict`` with ``num_iter`` 1 and
    3."""
    args = load_args(CONFIG, data_dir)
    by_path = {}
    t0 = time.perf_counter()
    for latent in HEAD_DIM_LATENTS:
        by_path.update(head_dim_steps(args, batch, latent))
        for dtype in (None, BF16) if latent == max(HEAD_DIM_LATENTS) \
                else (None,):
            tag = f"{latent}_{dtype or 'float32'}"
            t1 = time.perf_counter()
            job, counts = head_dim_cli(root, data_dir, latent, dtype)
            by_path[f"head_dim_{tag}_cli"] = counts
            evals, eval_line = head_dim_eval(job, data_dir, dtype)
            for mode, c in evals.items():
                by_path[f"head_dim_{tag}_eval_{mode}"] = c
            served, serve_line = head_dim_serve(job, data_dir, dtype)
            for num_iter, c in served.items():
                by_path[f"head_dim_{tag}_predict_{num_iter}"] = c
            log(f"[head dims] (c) eval --latent_dim {latent}"
                f"{' --dtype ' + dtype if dtype else ''}, pallas vs xla "
                f"over 64 documents: {eval_line}")
            log(f"[head dims] (d) /predict pos x{BATCH} --latent_dim "
                f"{latent}{' --dtype ' + dtype if dtype else ''}, pallas "
                f"vs xla: {serve_line}; (b)-(d) "
                f"{time.perf_counter() - t1:.1f} s")
    log(f"[time] phase 19 (head dims) {time.perf_counter() - t0:.1f} s "
        f"[{card}]")
    return by_path


def phase_nodes(card, root, data_dir, data):
    """17(b): crello Ours-EXP at full width, global batch 256, on two
    "nodes" sharing the card under gloo (``tests/_torch_node_worker.py``,
    the variables ``torchrun --nnodes 2`` sets): ``python -m
    flexdm_tpu_torch --num_devices 2`` for 2 epochs on phase 8's split,
    then the eval CLI's ``all_feat`` over phase 11's split; held to the
    one-process run on the same global batches and the harness alone."""
    import torch

    from flexdm_tpu_torch.config import TrainConfig
    from flexdm_tpu_torch.data import DatasetSpec
    from flexdm_tpu_torch.demo import load_model
    from flexdm_tpu_torch.evaluation import harness
    from flexdm_tpu_torch.train import trainer

    worker = node_worker()
    eval_port = worker.free_port()
    jobs = [os.path.join(root, f"node_job_{r}") for r in range(NODES)]
    specs = [{"train_argv": ["--preset", "crello_ours_exp", "--data_dir",
                             data_dir, "--job-dir", jobs[r], "--num_epochs",
                             "2", "--validation_freq", "1", "--num_devices",
                             str(NODES), "--log_level", "WARNING"],
              "eval_argv": ["--job-dir", jobs[0], "--task_mode", "all_feat",
                            "--batch_size", str(EVAL_BATCH), "--data_dir",
                            data["crello"], "--num_devices", str(NODES)],
              "eval_port": eval_port, "backend": "gloo", "threads": 4,
              "out": os.path.join(root, f"node_{r}.json")}
             for r in range(NODES)]
    t0 = time.perf_counter()
    nodes = worker.wait_nodes(worker.start_nodes(specs, root), specs,
                              NODES_TIMEOUT)
    nodes_s = time.perf_counter() - t0
    for r, node in enumerate(nodes):
        check((node["num_hosts"], node["host_id"], node["world_size"])
              == (NODES, r, NODES), f"node {r}: grid {node}")
        check(any("input_mode='device' is one host's" in w
                  for w in node["warnings"]),
              f"node {r}: no host-mode fallback warning: {node['warnings']}")
        check(sorted(node["streamed"]) == sorted(node["sums"]),
              f"node {r}: streamed {node['streamed']}")
        steps = node["result"]["history"][-1]["step"]
        check(node["launches"]["dq"] == node["launches"]["dkv"] == 4 * steps
              and node["launches"]["fwd"] >= 4 * steps,
              f"node {r}: launches {node['launches']} for {steps} steps")
    one, two = (node["result"] for node in nodes)
    strip = [[{k: v for k, v in h.items() if k != "wall_time"}
              for h in run["history"]] for run in (one, two)]
    check(strip[0] == strip[1] and one["test_metrics"] ==
          two["test_metrics"] and nodes[0]["sums"] == nodes[1]["sums"],
          "the two nodes' histories, test metrics or eval sums differ")
    check(os.path.exists(os.path.join(jobs[0], "args.json")) and not any(
        os.path.exists(os.path.join(jobs[1], n))
        for n in ("args.json", "checkpoints",
                  os.path.join("logs", "history.jsonl"))),
          "a node other than rank 0 wrote to its job")

    args = load_args(CONFIG, data_dir)
    t0 = time.perf_counter()
    with worker.hosts_as_one(NODES):
        same = trainer.train(TrainConfig.from_args(dict(
            args, job_dir=os.path.join(root, "nodes_as_one"), num_epochs=2,
            validation_freq=1, input_mode="host")))
    same_s = time.perf_counter() - t0
    gap = _history_gap(one["history"], same["history"])
    test = max(abs(v - one["test_metrics"][k]) / max(abs(v), 1e-30)
               for k, v in same["test_metrics"].items())
    check(gap["train"] <= 1e-5 and gap["val"] <= EVAL_RTOL
          and test <= EVAL_RTOL,
          f"two nodes against one process on their global batches: "
          f"history {gap}, test metrics {test:.2e}")

    model, spec = load_model(jobs[0], batch_size=EVAL_BATCH, device="cuda",
                             data_dir=data["crello"])
    schema = spec.schema
    loader = DatasetSpec("crello", data["crello"], EVAL_BATCH).make_dataset(
        "test", batch_size=EVAL_BATCH)
    worst = worst_cat = 0.0
    t0 = time.perf_counter()
    for task, group in eval_tasks(schema, "all_feat"):
        ties = NearTies(schema, False)
        want = harness.task_sums(model, loader, task, group, observe=ties,
                                 resident=False)
        rel, cat = compare_sums(f"two nodes all_feat {task}", schema,
                                nodes[0]["sums"][task], want, ties,
                                PATHS_RTOL)
        worst, worst_cat = max(worst, rel), max(worst_cat, cat)
    torch.cuda.synchronize()
    alone_s = time.perf_counter() - t0
    log(f"[nodes] (b) two nodes (RANK 0/1, WORLD_SIZE 2, LOCAL_WORLD_SIZE "
        f"1) on cuda:0 under gloo, crello Ours-EXP batch {TRAIN_BATCH}, 2 "
        f"epochs: from_env gives 2 hosts, device mode fell back to host "
        f"mode (warned), the ranks' histories, test metrics and eval sums "
        f"bitwise equal, only rank 0 wrote; against one process on the "
        f"same global batches ({same_s:.1f} s): largest relative "
        f"difference {gap['train']:.3e} in the training fields (bar 1e-5), "
        f"{gap['val']:.3e} in validation, {test:.3e} in the test metrics "
        f"(bar {EVAL_RTOL:g}); eval all_feat over {EVAL_DOCS} documents "
        f"streamed on both nodes: numerical Σnum within {worst:.2e} of the "
        f"harness alone (bar {PATHS_RTOL:g}), categorical apart by at most "
        f"{worst_cat:g}")
    for r, node in enumerate(nodes):
        log(f"[time] nodes rank {r}: step median "
            f"{statistics.median(node['step_ms'][1:]):.3f} ms (the first "
            f"{node['step_ms'][0]:.1f} ms; {len(node['step_ms'])} steps, "
            f"synchronised host clock, both nodes on one card); from the "
            f"process start: imports {node['import_s']:.1f} s, group joined "
            f"{node['joined_s']:.1f} s, first step {node['first_step_s']:.1f}"
            f" s; eval CLI {node['eval_s']:.2f} s [{card}]")
    log(f"[time] nodes: the two nodes {nodes_s:.1f} s (start to end, "
        f"training and eval); the harness alone, streaming, "
        f"{alone_s:.2f} s [{card}]")
    return {f"nodes_rank{r}_cli": node["launches"]
            for r, node in enumerate(nodes)}


def quiet(fn, *args):
    """``fn(*args)`` with its standard output kept apart; returns its value
    and that output's last line."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        value = fn(*args)
    return value, out.getvalue().strip().splitlines()[-1]


def phase_tools(card, root):
    """17(c): the port's tools at full width on the card."""
    from tools import (
        torch_bench_attention,
        torch_bench_serve,
        torch_profile_demo,
        torch_profile_step,
        torch_train_baselines,
    )

    for dtype in (None, BF16):
        out, line = quiet(torch_profile_step.main, [
            "--batch-size", str(TRAIN_BATCH), "--iters", "20"]
            + (["--dtype", dtype] if dtype else []))
        fwd, dq, dkv = kernel_names(dtype)
        check(out["launches"][fwd] > 0 and out["launches"][dq] > 0
              and out["launches"][dkv] > 0, f"profile_step {out}")
        check_one_instance(out["launches"], dtype, "profile_step")
        log(f"[tools] torch_profile_step --batch-size {TRAIN_BATCH}"
            f"{' --dtype ' + dtype if dtype else ''}: {line}")
    for dtype in ("float32", BF16):
        for shape in ((TRAIN_BATCH, 8, 50, 32), FLAT_SHAPE):
            row = torch_bench_attention.measure(*shape, dtype)
            check(all(row["launches"].values()) and finite(row),
                  f"bench_attention {row}")
            log(f"[tools] torch_bench_attention {shape} {dtype}: "
                f"{json.dumps(row)} [{card}]")
    job = os.path.join(root, "train_job")
    out, line = quiet(torch_bench_serve.main, [
        "--job-dir", job, "--requests", "20", "--num_iter",
        str(MASKGIT_ITERS), "--concurrency", "4"])
    check(out["pos_1doc"]["p50_ms"] > 0 and out["launches"]["fwd"] > 0,
          f"bench_serve {out}")
    log(f"[tools] torch_bench_serve (phase 8's job): {line}")
    out, line = quiet(torch_profile_demo.main, [
        "--job-dir", job, "--num-examples", str(DEMO_DOCS)])
    check(out["launches"]["fwd"] > 0, f"profile_demo {out}")
    log(f"[tools] torch_profile_demo (phase 8's job): {line}")
    for arch in TOOL_BASELINES:
        out, line = quiet(torch_train_baselines.main, [
            "--arch", arch, "--docs", str(2 * TRAIN_BATCH), "--epochs", "1"])
        row = out["baselines"][arch]
        check(not row["stopped_on_nan"] and finite(row), f"{arch}: {row}")
        log(f"[tools] torch_train_baselines --arch {arch}: {line}")


def phase_entry_points(card, root, data_dir, batch, data):
    """17: ``--attention_impl``, two nodes, the tools."""
    t_phase = time.perf_counter()
    args = load_args(CONFIG, data_dir)
    counts = impl_steps(args, batch)
    counts.update(impl_cli(card, root, data_dir, data))
    counts.update(phase_nodes(card, root, data_dir, data))
    phase_tools(card, root)
    log(f"[time] phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return counts


# --- 18. Raw crello ingestion to jobs ---------------------------------------

RAW_DOCS = 20000  # release scale (~23k templates), the JAX drill's default
DRILL_EPOCHS = 1  # 70 steps of 256
CAPSTONE_EPOCHS = 1  # the last validates, so ``best`` exists
CAPSTONE_ITERS = 4
NOTEBOOK_DIRS = {"demo_crello_torch.ipynb": ("FLEXDM_JOB_DIR",
                                             "FLEXDM_DATA_DIR"),
                 "demo_rico_torch.ipynb": ("FLEXDM_RICO_JOB_DIR",
                                           "FLEXDM_RICO_DATA_DIR")}


def _dir_bytes(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def _summed(counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def ingest_build(card, root):
    """18(a): ``tools/torch_build_crello_dataset.py`` on a raw dump of
    ``RAW_DOCS`` templates: every template kept and counted, each split
    non-empty, every element type of the dump in ``vocabulary.json``, a
    batch of the port's ``DatasetSpec`` of shape (B, 50, 1) for ``left``,
    no degenerate position column.  Returns the dump and the data dir."""
    import numpy as np

    from flexdm_tpu_torch.data import DatasetSpec
    from tools.torch_build_crello_dataset import main as build_main
    from tools.torch_scale_drill import make_raw_dump

    raw = os.path.join(root, "ingest_dump.jsonl")
    make_raw_dump(raw, RAW_DOCS)
    data_dir = os.path.join(root, "ingest_data")
    t0 = time.perf_counter()
    _, line = quiet(build_main, ["--input", raw, "--out", data_dir,
                                 "--shards", "8", "--val-frac", "0.05",
                                 "--test-frac", "0.05"])
    seconds = time.perf_counter() - t0
    with open(os.path.join(data_dir, "count.json")) as f:
        counts = json.load(f)
    with open(os.path.join(data_dir, "vocabulary.json")) as f:
        vocab = json.load(f)
    check(line.startswith(f"wrote {sum(counts.values())} documents")
          and line.endswith("skipped 0") and sum(counts.values()) == RAW_DOCS,
          f"the builder kept {counts} of {RAW_DOCS}: {line}")
    check(all(counts[s] > 0 for s in ("train", "val", "test")),
          f"an empty split: {counts}")
    types = set()
    with open(raw) as f:
        for row in f:
            types.update(e["type"] for e in
                         json.loads(row)["template"][0]["elements"])
    check(set(vocab["type"]) == types,
          f"vocabulary types {sorted(vocab['type'])}, dump types "
          f"{sorted(types)}")
    spec = DatasetSpec("crello", data_dir, TRAIN_BATCH)
    batch = next(iter(spec.make_dataset("train")))
    check(batch["left"].shape == (TRAIN_BATCH, 50, 1),
          f"left {batch['left'].shape}")
    for col in ("left", "top", "width", "height"):
        check(len(np.unique(batch[col][:64])) >= 2,
              f"built dataset is degenerate: {col} has one value across "
              "64 documents")
    log(f"[ingest] (a) tools/torch_build_crello_dataset.py: {RAW_DOCS} raw "
        f"templates -> {counts}, {len(vocab['type'])} element types "
        f"{sorted(types)}; a batch of {TRAIN_BATCH} decodes, left "
        f"{batch['left'].shape}, no degenerate position column")
    log(f"[time] ingest (a) build of {RAW_DOCS} templates: {seconds:.1f} s "
        f"on the host [{card}]")
    return raw, data_dir


def ingest_drill(card, root, raw, data_dir):
    """18(b): ``tools/torch_scale_drill.py`` at full width (D=256, 4 blocks,
    batch 256, bf16) for ``DRILL_EPOCHS``: its dump and its build (the
    builder's second run) byte-equal to 18(a)'s, resident = streaming
    ``pos``, the bf16 dq and dk/dv launched 4 times a step, the forward
    at least as often, no float32 kernel; the demo page written.
    Returns the drill's root (its corpus) and the launches per path."""
    from tools import torch_scale_drill

    drill_root = os.path.join(root, "ingest_drill")
    t0 = time.perf_counter()
    row, _ = quiet(torch_scale_drill.main, [
        "--docs", str(RAW_DOCS), "--epochs", str(DRILL_EPOCHS), "--root",
        drill_root])
    seconds = time.perf_counter() - t0
    with open(raw, "rb") as a, \
            open(os.path.join(drill_root, "dump.jsonl"), "rb") as b:
        check(a.read() == b.read(), "the drill's dump differs from 18(a)'s")
    check(_dir_bytes(os.path.join(drill_root, "data")) ==
          _dir_bytes(data_dir), "a second build differs from the first")
    check(row["native_decoder"] and not row["stopped_on_nan"]
          and finite(row), f"drill row {row}")
    check(row["eval_paths_equal"], "drill: resident and streaming pos "
          f"sums differ by {row['eval_paths_max_rel_gap']:.2e} relative")
    train = row["launches"]["train"]
    check(train["dq_bf16"] == train["dkv_bf16"] == 4 * row["steps"] > 0
          and train["fwd_bf16"] >= 4 * row["steps"],
          f"drill: {row['steps']} steps launched {train}")
    by_path = {"ingest_drill_train": train,
               "ingest_drill_eval": _summed([row["launches"]["eval_resident"],
                                            row["launches"]["eval_streaming"]]),
               "ingest_drill_demo": row["launches"]["demo"]}
    for path, counts in by_path.items():
        check_one_instance(counts, BF16, path)
        check(counts["fwd_bf16"] > 0, f"{path}: {counts}")
    for stage in ("eval_resident", "eval_streaming", "demo"):
        check(row["launches"][stage]["dq_bf16"] == 0,
              f"drill {stage}: {row['launches'][stage]}")
    check(row["demo_html_bytes"] > 0 and os.path.exists(
        os.path.join(drill_root, "demo.html")), "drill: no demo page")
    log(f"[ingest] (b) tools/torch_scale_drill.py --docs {RAW_DOCS} --epochs "
        f"{DRILL_EPOCHS} (D=256, 4 blocks, batch 256, bf16): dump and build "
        f"byte-equal to (a)'s; {row['train_records']} train records, "
        f"{row['steps']} steps, loss {row['loss_first']:.3f} -> "
        f"{row['loss_last']:.3f}, best val {row['best_val_total_score']:.4f};"
        f" pos on {row['test_records']} test records {row['eval_pos_scores']}"
        f", resident = streaming sums (Σnum and Σden equal); launches "
        f"{row['launches']}")
    log(f"[time] ingest (b) drill: {seconds:.1f} s; build "
        f"{row['build_sec']:.1f} s, first-epoch decode "
        f"{row['first_epoch_decode_sec']:.2f} s "
        f"({row['decode_docs_per_sec']:.0f} documents/s, native decoder), "
        f"train {row['train_sec']:.1f} s (first epoch {row['startup_sec']:.1f}"
        f" s), eval pos resident {row['eval_resident_sec']:.2f} s, streaming "
        f"{row['eval_streaming_sec']:.2f} s, demo {row['demo_sec']:.2f} s "
        f"[{card}]")
    return drill_root, by_path


def ingest_capstone(card, drill_root):
    """18(c): ``tools/torch_capstone.py`` on the drill's corpus (reused) at
    full width, batch 256, float32, IMP -> EXP -> EXP-FT for
    ``CAPSTONE_EPOCHS`` and the seven eval runs (MaskGIT ``--num_iter
    CAPSTONE_ITERS``): every loss finite, EXP-FT warm-started from IMP's
    ``best`` (its first loss not EXP's), every score finite in [0, 1],
    dq and dk/dv 4 a step, MaskGIT ``elem`` launching the forward
    ``CAPSTONE_ITERS`` times as often as ``elem``.  Returns the launches
    per path."""
    from tools import torch_capstone

    t0 = time.perf_counter()
    result, _ = quiet(torch_capstone.main, [
        "--root", drill_root, "--docs", str(RAW_DOCS), "--epochs",
        str(CAPSTONE_EPOCHS), "--num_iter", str(CAPSTONE_ITERS)])
    seconds = time.perf_counter() - t0
    by_path = {}
    for name in torch_capstone.RECIPES:
        train, scores = result[name]["train"], result[name]["eval"]
        check(not train.get("skipped") and not train["stopped_on_nan"]
              and finite(train) and train["epochs_run"] == CAPSTONE_EPOCHS
              and train["n_best_saves"] == 1, f"capstone {name}: {train}")
        counts = train["launches"]
        check(counts["dq"] == counts["dkv"] == 4 * train["steps"] > 0
              and counts["fwd"] >= 4 * train["steps"],
              f"capstone {name}: {train['steps']} steps launched {counts}")
        check_one_instance(counts, None, f"capstone {name}")
        launches = scores.pop("_launches")
        wall = scores.pop("_eval_wall_sec")
        check(len(scores) == 7, f"capstone {name}: {sorted(scores)}")
        for task, got in scores.items():
            check(got and all(0 <= v <= 1 for v in got.values())
                  and finite(got), f"capstone {name} {task}: {got}")
            check(launches[task]["fwd"] > 0 and launches[task]["dq"] == 0,
                  f"capstone {name} {task}: {launches[task]}")
            check_one_instance(launches[task], None, f"capstone {task}")
        maskgit = launches[f"elem_maskgit{CAPSTONE_ITERS}"]["fwd"]
        check(maskgit == CAPSTONE_ITERS * launches["elem"]["fwd"],
              f"capstone {name}: MaskGIT elem launched {maskgit}, elem "
              f"{launches['elem']['fwd']}")
        by_path[f"capstone_{name}_train"] = counts
        by_path[f"capstone_{name}_eval"] = _summed(list(launches.values()))
        log(f"[ingest] (c) capstone {name}: {train['steps']} steps, loss "
            f"{train['loss_first']:.3f} -> {train['loss_last']:.3f}, best val "
            f"{train['best_val_total_score']:.4f}, test "
            f"{train['test_total_score']:.4f}; elem "
            f"{scores['elem']}, pos {scores['pos']}; MaskGIT elem "
            f"{maskgit} forward launches = {CAPSTONE_ITERS} x elem's "
            f"{launches['elem']['fwd']}")
        log(f"[time] ingest (c) capstone {name}: train "
            f"{train['train_wall_sec']:.1f} s, the seven eval runs "
            f"{wall:.1f} s [{card}]")
    with open(os.path.join(drill_root, "job_exp_ft", "args.json")) as f:
        weights = json.load(f)["weights"]
    check(weights == os.path.join(drill_root, "job_imp", "checkpoints",
                                  "best.torch.npz"), f"EXP-FT from {weights}")
    check(result["exp_ft"]["train"]["loss_first"]
          != result["exp"]["train"]["loss_first"],
          "EXP-FT's first loss is EXP's: no warm start")
    log(f"[time] ingest (c) capstone ({CAPSTONE_EPOCHS} epochs a recipe, "
        f"corpus reused): {seconds:.1f} s [{card}]")
    return by_path


def ingest_notebooks(card, root):
    """18(d): both port notebooks through the port's runner on the card
    (``FLEXDM_DEVICE`` unset: ``cuda``): at least 2 HTML outputs each, the
    float32 forward launched (the toy job trained on the card too)."""
    from flexdm_tpu_torch.utils import notebook

    by_path = {}
    for name, (job_var, data_var) in NOTEBOOK_DIRS.items():
        check("FLEXDM_DEVICE" not in os.environ, "FLEXDM_DEVICE is set")
        where = os.path.join(root, name.split(".")[0])
        saved = {k: os.environ.get(k) for k in (job_var, data_var)}
        os.environ.update({job_var: os.path.join(where, "job"),
                           data_var: os.path.join(where, "data")})
        attn_reset()
        t0 = time.perf_counter()
        try:
            outputs, _ = quiet(notebook.run_notebook, os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "notebooks",
                name))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        html = sum(1 for o in outputs if "text/html" in o)
        check(html >= 2 and counts["fwd"] > 0 and counts["dq"] > 0,
              f"{name}: {html} HTML outputs, launches {counts}")
        check_one_instance(counts, None, name)
        by_path[f"notebook_{name.split('_')[1]}"] = counts
        log(f"[ingest] (d) notebooks/{name}: {len(outputs)} outputs, {html} "
            f"HTML; launches {counts}")
        log(f"[time] ingest (d) notebooks/{name} (toy bootstrap included): "
            f"{seconds:.1f} s [{card}]")
    return by_path


def phase_ingestion(card, root):
    """18: raw crello JSONL to trained, evaluated and rendered jobs."""
    t_phase = time.perf_counter()
    raw, data_dir = ingest_build(card, root)
    drill_root, by_path = ingest_drill(card, root, raw, data_dir)
    by_path.update(ingest_capstone(card, drill_root))
    by_path.update(ingest_notebooks(card, root))
    log(f"[time] phase 18 took {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")
    return by_path


def main():
    # cuBLAS repeats its results only with a fixed workspace (16(a) runs
    # under torch.use_deterministic_algorithms); read when its first
    # handle is made.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke run needs one GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs accumulate in float32, as the TPU's do.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    log(f"[device] torch {torch.__version__} CUDA {torch.version.cuda} "
        f"python {sys.version.split()[0]}; {card}; allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"allow_bf16_reduced_precision_reduction "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")

    t_start = time.perf_counter()

    def lap(done):
        """The script's seconds so far, after the phases ``done``: where
        its time limit goes."""
        log(f"[time] after {done}: {time.perf_counter() - t_start:.1f} s "
            f"since the start")

    phase_build()
    lap("phase 2 (build)")
    kernel_err, timings = phase_kernel(card)
    backward_err, backward_timings = phase_backward(card)
    lap("the kernels' checks and times")
    phase_slice(card)
    maskgit_ms = phase_maskgit(card)
    lap("serving and MaskGIT")
    with tempfile.TemporaryDirectory() as root:
        data_dir, spec, batch = train_data(root, "crello", seed=0)
        step_ms, f32_losses, step_counts, train_counts = phase_train(
            card, root, data_dir, spec, batch)
        rico_ms, rico_counts = phase_rico(card, root)
        flat_ms, flat_counts = phase_flat(card, root, data_dir, spec, batch)
        lap("training crello, rico and crello_flat")
        data = eval_data(root)
        lap("the eval splits")
        eval_counts = phase_eval(card, root, data)
        bf16_err, bf16_fwd, bf16_bwd = phase_bf16_kernel(card)
        bf16_ms, bf16_flat_ms, bf16_counts = phase_bf16(
            card, root, data_dir, spec, batch, data, f32_losses, step_ms,
            flat_ms)
        rates, trainer_counts = phase_trainer(card, root, data_dir, spec,
                                              batch)
        decode_s, demo_counts = phase_decode_demo(card, root, data_dir, data)
        baseline_counts, causal = phase_baselines(card, root, data_dir, spec,
                                                  batch)
        multi_counts, multi_kernels, multi_causal = phase_multi(
            card, root, data_dir, batch, data)
        entry_counts = phase_entry_points(card, root, data_dir, batch, data)
        head_dim_counts = phase_head_dims(card, root, data_dir, batch)
        ingest_counts = phase_ingestion(card, root)
    lap("phase 18")
    log(f"[time] summary: train step crello Ours-EXP {step_ms:.2f} ms "
        f"(bf16 {bf16_ms:.2f} ms), rico Ours-EXP {rico_ms:.2f} ms (batch "
        f"{TRAIN_BATCH}), crello_flat {flat_ms:.2f} ms (bf16 "
        f"{bf16_flat_ms:.2f} ms, batch {FLAT_BATCH}); /predict num_iter="
        f"{MASKGIT_ITERS} {maskgit_ms:.2f} ms ({BATCH} docs); CLI "
        f"documents/s " + ", ".join(f"{k} {statistics.median(v):.1f}"
                                    for k, v in rates.items())
        + f"; eval decode crello native "
        f"{statistics.median(decode_s['crello']['native']):.3f} s, Python "
        f"{statistics.median(decode_s['crello']['Python']):.3f} s"
        + f" [{card}]")
    by_path = {"crello_ours_exp_steps": step_counts,
               "crello_ours_exp_cli": train_counts,
               "rico_ours_exp_steps": rico_counts,
               "crello_flat_steps": flat_counts, **eval_counts,
               **bf16_counts, **trainer_counts, "demo": demo_counts,
               **baseline_counts, **multi_counts, **entry_counts,
               **head_dim_counts, **ingest_counts}
    # The training shape, which every kernel of the path runs at (the
    # forward also serves at (8, 8, 50, 32) and crello_flat runs
    # (64, 8, 500, 32): the log lines above).
    shape = (256, 8, 50, 32)
    tpu = "flexdm_tpu/ops/attention.py"
    csrc = "flexdm_tpu_torch/csrc/"
    bf16_cli = bf16_counts["crello_ours_exp_bf16_cli"]

    def fwd_times(t):
        return {"ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "exp_floor_ms": t["exp_floor_ms"],
                "library_ms": t["library_ms"], "shape": list(shape)}

    def bwd_times(t, part):
        bd = t["bounds"][part]
        return {"ms": t[part], "plain_ms": t["plain"],
                "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
                "exp_floor_ms": bd["exp_floor_ms"],
                "library_ms": t["library"], "shape": list(shape)}

    def head_dim_times(table, part=None):
        """A kernel's times at the head dims of ``HEAD_DIM_TIMED``."""
        return {str(s): dict(fwd_times(table[s]) if part is None
                             else bwd_times(table[s], part), shape=list(s))
                for s in HEAD_DIM_TIMED}

    def multi_times(key):
        """A float32 kernel's times at phase 16's per-rank shapes."""
        out = {}
        for s, (f, b) in multi_kernels.items():
            t = fwd_times(f) if key == "fwd" else bwd_times(b, key)
            out[str(s)] = dict(t, shape=list(s))
        return out

    def entry(name, dtype, source, replaces, key, cli_counts, err, t):
        """One kernel: ``launches`` from the CLI run of its dtype; a
        float32 kernel also with its causal figures at ``CAUSAL_SHAPE``
        (phase 15) and its times at the per-rank shapes of phase 16."""
        out = {"name": name, "route": "cuda", "dtype": dtype,
               "source": csrc + source, "replaces": replaces,
               "launches": cli_counts[key],
               "launches_by_path": {path: counts[key]
                                    for path, counts in by_path.items()},
               "max_abs_err": err, **t}
        if key in causal:
            out["causal"] = causal[key]
        if key in F32_KERNELS:
            out["multi_device"] = multi_times(key)
            out["multi_device"][f"{TP_BASELINE_SHAPE} causal"] = \
                multi_causal[key]
        return out

    fwd, bwd = timings[shape], backward_timings[shape]
    fwd16, bwd16 = bf16_fwd[shape], bf16_bwd[shape]
    dq_tpu = f"{tpu}:116 and {tpu}:217"
    dkv_tpu = f"{tpu}:156 and {tpu}:254"
    kernels = [
        entry("flash_attention_fwd", "float32", "flash_attention_fwd.cu",
              f"{tpu}:77", "fwd", train_counts, kernel_err, fwd_times(fwd)),
        entry("flash_attention_bwd_dq", "float32", "flash_attention_bwd.cu",
              dq_tpu, "dq", train_counts, backward_err["dq"],
              bwd_times(bwd, "dq")),
        entry("flash_attention_bwd_dkv", "float32",
              "flash_attention_bwd.cu", dkv_tpu, "dkv", train_counts,
              max(backward_err["dk"], backward_err["dv"]),
              bwd_times(bwd, "dkv")),
        entry("flash_attention_fwd_bf16", BF16, "flash_attention_fwd_bf16.cu",
              f"{tpu}:77", "fwd_bf16", bf16_cli, bf16_err["O"],
              fwd_times(fwd16)),
        entry("flash_attention_bwd_dq_bf16", BF16,
              "flash_attention_bwd_bf16.cu", dq_tpu, "dq_bf16", bf16_cli,
              bf16_err["dq"], bwd_times(bwd16, "dq")),
        entry("flash_attention_bwd_dkv_bf16", BF16,
              "flash_attention_bwd_bf16.cu", dkv_tpu, "dkv_bf16", bf16_cli,
              max(bf16_err["dk"], bf16_err["dv"]), bwd_times(bwd16, "dkv")),
    ]
    # The head dims of --latent_dim 128 and 384, timed at the training
    # batch (Dh 16 on the 32-wide tiles, 48 on the 64-wide ones).
    for out, table, part in zip(kernels, (
            timings, backward_timings, backward_timings, bf16_fwd, bf16_bwd,
            bf16_bwd), (None, "dq", "dkv", None, "dq", "dkv")):
        out["head_dims"] = head_dim_times(table, part)
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
