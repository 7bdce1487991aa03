"""Smoke run of the PyTorch port (flexdm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. device: a CUDA device is present; prints torch/CUDA versions and the
   card's name and power limit; TF32 off, so float32 means float32;
2. build: compiles the CUDA libraries from ``flexdm_tpu_torch/csrc`` with
   nvcc for sm_90a, one nvcc per source, and the host record decoder
   (``csrc/tfrecord_io.cc``) with g++ at its first use, all at once
   (seconds, printed with the ptxas report and g++'s version); fails if
   the native decoder is not in use (14(a));
3. kernel: the flash-attention forward kernel (split-TF32 tensor-core
   products) against its plain PyTorch version on the card (O and lse
   within 2e-5 abs + 2e-5 rel, float32) at the serving, training,
   crello_flat training and crello_flat ``elem`` evaluation shapes, S=650
   and the kernel's tile edges (S = 16, 17, 63, 64, 65, 128, 129 at Dh 32,
   64, 128), and a second call bitwise equal to the first; then kernel,
   plain version and one library call (``scaled_dot_product_attention``, a
   yardstick the port never calls) timed at (8, 8, 50, 32),
   (256, 8, 50, 32), (8, 8, 650, 32), (64, 8, 500, 32) and
   (256, 8, 500, 32), beside the bound computed from the shapes;
4. backward: the backward kernels (dq with delta, dk/dv; split-TF32
   tensor-core products) through autograd against the plain backward and
   against autograd of the plain forward, dq, dk and dv within 1e-4 abs +
   1e-4 rel at every shape, S=4096 (the regime of the TPU's stream
   kernels), S=500 and the kernels' tile edges (S = 64, 65, 128, 129 at
   Dh 32, 64, 128) included, and a second call bitwise equal to the
   first; then the kernels, the plain autograd backward and the library
   call's backward timed at (256, 8, 50, 32), (1, 2, 4096, 64) and
   (64, 8, 500, 32), beside their bounds;
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
    Each run: timed on the host clock, its CSV read back, the harness's
    sums on the card over the same split give the CLI's scores, the
    forward launched at least once per block per forward; then card vs
    CPU on the jobs' 64-document test split (crello_flat its first 4
    documents), the card at the CLI's batch of 256 rows: every Σden and
    numerical Σnum within 1e-4 relative and every categorical Σnum equal,
    apart from rows or fields near a tie (counted).
12. bf16 (``--dtype bfloat16``): (a) the bf16 kernel instances against
    their plain bf16 versions at the serving, training and crello_flat
    shapes, S=650, the tile edges (causal, a fully masked row) and, for the
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
    30 timed steps.  Every bf16 path launches only bf16 kernels, every
    float32 path only float32 ones.
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
14. decode and demo: (a) in phase 2; (b) every record of phase 11's
    2048-document crello and rico test splits decoded by the native
    decoder equals its pure-Python decode, column by column (same dtype
    and shape), and the native scan gives the Python scan's payloads with
    the CRCs verified; (c) one pass of a fresh loader over each split, the
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
Each step phase ends with a ``torch.profiler`` window: device kernel time
per step, its attention share and the busiest kernels.

The last lines are one JSON object per kernel, float32 and bf16 instances
(times at the training shape (256, 8, 50, 32); ``launches`` from the
training CLI run of the instance's dtype and ``launches_by_path`` from
each training path's 30 steps, each eval path's CLI runs, each
trainer path of phase 13 and the demo runs of phase 14), the card's
name
and power limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.
"""

import copy
import csv
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
FLAT_EVAL_DOCS = 4  # crello_flat eval compared on 4 documents (S=500 on CPU)
BF16 = "bfloat16"
BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative
# Top two logits this close (relative) make a near tie in bf16: the card's
# and the CPU's bf16 logits differ by a few ulps once a flipped rounding
# has travelled through the blocks.
BF16_TIE = 4 * BF16_ULP
F32_KERNELS = ("fwd", "dq", "dkv")
BF16_KERNELS = ("fwd_bf16", "dq_bf16", "dkv_bf16")


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
    log("[build] bf16 backward kernels (ptxas): " + "; ".join(
        ptxas_summary(_build.BUILD_LOGS.get(attn.BWD_BF16_LIBRARY[0], ""))))


def ptxas_summary(report):
    """``kernel<args>: N registers, S bytes spilled`` per kernel of a ptxas
    report (``-Xptxas -v``), spills as the larger of stores and loads."""
    import re

    out, name, spill = [], None, 0
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '\S*?\d(flash_\w+?"
                          r"_kernel)(ILi\d+ELi\d+E)?", line)
        if entry:
            name = entry.group(1) + "".join(
                f"<{a},{b}>" for a, b in re.findall(
                    r"ILi(\d+)ELi(\d+)E", entry.group(2) or ""))
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
    import torch.nn.functional as F

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
    # The kernel's tile edges (64-row query tiles; 64-key K/V tiles, 32 at
    # Dh=128).
    cases += [((2, 2, s, dh), causal, True)
              for s in (16, 17, 63, 64, 65, 128, 129)
              for dh in (32, 64, 128) for causal in (False, True)]
    worst = 0.0
    for shape, causal, fully_masked in cases:
        b, h, s, dh = shape
        q, k, v = (torch.randn(shape, generator=g).cuda() for _ in range(3))
        mask = torch.rand(b, s, generator=g) > 0.3
        mask[:, 0] = True
        if fully_masked:
            mask[-1] = False
        mask = mask.cuda()
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

    timings = {}
    for shape in ((8, 8, 50, 32), (256, 8, 50, 32), (8, 8, 650, 32),
                  FLAT_SHAPE, EVAL_FLAT_SHAPE):
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
        timings[shape] = t
        log(f"[time] attention {shape} device time (CUDA graph of 20 calls, "
            f"median of 50): kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, library (scaled_dot_product_attention"
            f", O only; {sdpa_kernels(library)}) {t['library_ms']:.4f} ms; "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}; FP32 pipes "
            f"{t['fp32_bound_ms']:.4f} ms) [{card}]")
        log(f"[time] attention {shape} per call from Python (median of "
            f"50 x 20): kernel {time_ms(kernel):.4f} ms, plain "
            f"{time_ms(plain):.4f} ms [{card}]")
    return worst, timings


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


def forward_bound(shape, itemsize=4, peak=TF32_FLOPS):
    """Reads q, k, v and the (B, S) byte mask; writes O and (float32) lse,
    m, l.  Two products of 2 S^2 Dh FLOPs per (batch, head).  ``itemsize``:
    bytes per element of q, k, v and O (2 for bf16, with ``BF16_FLOPS``)."""
    b, h, s, dh = shape
    rows = b * h * s
    return bound(itemsize * 4 * rows * dh + 4 * 3 * rows + b * s,
                 4 * b * h * s * s * dh, peak)


def backward_bounds(shape, itemsize=4, peak=TF32_FLOPS):
    """dq: reads q, k, v, o, dO, m, l, mask, writes dq, delta; 3 products.
    dk/dv: reads q, k, v, dO, m, l, delta, mask, writes dk, dv; 4 products
    (2 S^2 Dh FLOPs each).  m, l and delta are float32."""
    b, h, s, dh = shape
    rows = b * h * s
    product = 2 * b * h * s * s * dh
    nbytes = itemsize * 6 * rows * dh + 4 * 3 * rows + b * s
    return (bound(nbytes, 3 * product, peak), bound(nbytes, 4 * product, peak))


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
    import torch.nn.functional as F

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
    # The kernels' tile edges (64 rows or keys; 32 Q/dO rows at Dh=128).
    cases += [((2, 2, s, dh), causal, True) for s in (64, 65, 128, 129)
              for dh in (32, 64, 128) for causal in (False, True)]
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    for shape, causal, fully_masked in cases:
        b, h, s, dh = shape
        q, k, v = (torch.randn(shape, generator=g).cuda().requires_grad_()
                   for _ in range(3))
        do = torch.randn(shape, generator=g).cuda()
        mask = torch.rand(b, s, generator=g) > 0.3
        mask[:, 0] = True
        if fully_masked:
            mask[-1] = False
        mask = mask.cuda()
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

    timings = {}
    for shape in ((256, 8, 50, 32), (1, 2, 4096, 64), FLAT_SHAPE):
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
        timings[shape] = t
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
    return worst, timings


def profile_steps(fn, steps=5):
    """Device kernel time per call of ``fn`` over ``steps`` calls from
    ``torch.profiler``: total and attention kernels' ms, kernels per call,
    and the three kernels that take the most time."""
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
            e.cuda_time if us is None else us)
        count += 1
    total = sum(by_name.values()) / 1e3 / steps
    attention = sum(v for k, v in by_name.items()
                    if "flash_" in k) / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    top = ", ".join(f"{k[:50]} {v / 1e3 / steps:.3f} ms" for k, v in top)
    return total, attention, count / steps, top


def launch_counts():
    from flexdm_tpu_torch.ops import attention as attn

    return {"fwd": attn.KERNEL_LAUNCHES, "dq": attn.BWD_DQ_LAUNCHES,
            "dkv": attn.BWD_DKV_LAUNCHES, "fwd_bf16": attn.BF16_FWD_LAUNCHES,
            "dq_bf16": attn.BF16_DQ_LAUNCHES,
            "dkv_bf16": attn.BF16_DKV_LAUNCHES}


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

    from flexdm_tpu_torch.data import DatasetSpec, split_device_batch

    from flexdm_tpu_torch.cli import main as train_main
    from flexdm_tpu_torch.ops import attention as attn
    from flexdm_tpu_torch.serve import InferenceEngine, _jsonable, serve

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

    engine = InferenceEngine(job, batch_size=BATCH, device="cuda")
    check(engine.model.dtype == dtype, f"served {engine.model.dtype}")
    spec = DatasetSpec("crello", data_dir, BATCH)
    docs = _jsonable(spec.unbatch(split_device_batch(
        next(iter(spec.make_dataset("test", batch_size=4))))))
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
    check(serve_counts[fwd] >= 4, f"/predict launched {serve_counts}")
    check_one_instance(serve_counts, dtype, "serving the CLI's best")
    log(f"[train] the trained job's best served: /predict pos x{len(docs)} "
        f"docs: 200 in {secs * 1e3:.1f} ms; launches {serve_counts}")
    return counts, seconds, steps, job


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


def maskgit_reference(engine, cpu_model, docs, task):
    """The CPU's MaskGIT decode of ``docs`` as the engine batches them:
    per document, how many masked fields had a confidence within
    ``NEAR_TIE`` of their round's threshold or a final argmax within
    ``NEAR_TIE`` of a tie (where the card may decode otherwise)."""
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
    out = forward_eval(cpu_model, batch, masks, num_iter=MASKGIT_ITERS,
                       rounds=rounds)
    near = torch.zeros(engine.batch_size, dtype=torch.long)
    for r in rounds:
        thr = r["threshold"][:, None]
        for conf in r["confidence"].values():
            gap = (conf - thr).abs()
            near += ((conf > 0) & (gap > 0) & (gap <= NEAR_TIE)).sum(1)
    for c in schema.sequence_columns:
        if c.is_categorical:
            top = out[c.name].topk(2, -1).values
            tie = ((top[..., 0] - top[..., 1]) <= NEAR_TIE).any(-1)
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
        near_rows = torch.zeros(live.shape[0], dtype=torch.bool)
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
        self.num_records = n

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


def eval_run(card, root, label, job, mode, timed_dir, num_iter=1,
             compare_docs=None, compare_chunk=EVAL_BATCH):
    """``python -m flexdm_tpu_torch.evaluation`` on the card at batch
    ``EVAL_BATCH`` over the test split of ``timed_dir`` (timed, launches
    counted, its CSV read back); the harness's sums on the card over that
    split equal to the CLI's scores; then the card against the CPU on the
    job's own test split (the whole of it, or its first ``compare_docs``
    documents, the CPU in ``elem`` chunks of ``compare_chunk``), near ties
    counted; a bf16 job with bf16's bars (``BF16_ULP``, ``BF16_TIE``).
    Returns the forward's launch counts."""
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
    split = spec.make_dataset("test", batch_size=EVAL_BATCH)
    whole_rows = bool(schema.sort_pos and mode == "pos") or num_iter > 1
    ans, forwards, units, worst, worst_cat = {}, 0, 0, 0.0, 0.0
    fields = rows_near = 0
    t_harness = 0.0
    for task, group in eval_tasks(schema, mode):
        real = []  # rows of weight > 0 per forward: documents or replicas
        timed_rows = set()

        def observe(batch, masks, w, *_):
            real.append(int((w > 0).sum()))
            timed_rows.add(batch["length"].shape[0])

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sums = harness.task_sums(card_model, timed, task, group, num_iter,
                                 observe=observe)
        torch.cuda.synchronize()
        t_harness += time.perf_counter() - t0
        ans[task] = harness._ratios(schema, sums)
        forwards += len(real) * max(num_iter, 1)
        units += sum(real)

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
    check(counts[fwd] >= num_blocks * forwards,
          f"{label} {mode}: forward launched {counts[fwd]} times for "
          f"{forwards} forwards x {num_blocks} blocks")
    check(not any(counts[n] for n in ("dq", "dkv", "dq_bf16", "dkv_bf16")),
          f"{label} {mode}: a backward kernel ran in evaluation: {counts}")
    check_one_instance(counts, card_model.dtype, f"{label} {mode}")
    what = "replicas" if mode == "elem" else "documents x tasks"
    compared = ("the whole 64-document split" if compare_docs is None
                else f"the first {compare_docs} documents")
    log(f"[eval] {label} --task_mode {mode} --num_iter {num_iter}: "
        f"{len(final)} fields, e.g. {dict(list(final.items())[:3])}; forward "
        f"launches {counts[fwd]} (>= {forwards} forwards x {num_blocks} "
        f"blocks); card (the CLI's {sorted(timed_rows)} rows a forward) = "
        f"CPU on {compared} (numerical Σnum within {worst:.2e} relative, "
        f"categorical Σnum apart by at most {worst_cat:g}); {fields} masked "
        f"fields within {NEAR_TIE}{' + 4 bf16 ulps' if bf16 else ''} of a "
        f"tie or a threshold"
        + (f" on {rows_near} rows" if whole_rows else ""))
    EVAL_SECONDS[label, mode, num_iter] = (seconds, t_harness)
    log(f"[time] eval {label} --task_mode {mode} --num_iter {num_iter}, "
        f"{EVAL_DOCS} documents at batch {EVAL_BATCH}: CLI {seconds:.3f} s "
        f"(model load, decode and CSV included), {seconds / len(ans):.3f} s "
        f"per task, {units} {what}, {units / seconds:.1f} {what}/s; harness "
        f"alone {t_harness:.3f} s (decode of the split included), "
        f"{units / t_harness:.1f} {what}/s, {forwards} forwards [{card}]")
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
    for shape, causal, fully_masked in cases:
        b, h, s, dh = shape
        q, k, v, do = (torch.randn(shape, generator=g).to("cuda", bf16)
                       for _ in range(4))
        mask = torch.rand(b, s, generator=g) > 0.3
        mask[:, 0] = True
        if fully_masked:
            mask[-1] = False
        mask = mask.cuda()
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
        _, delta = attn._backward_dq(q, k, v, mask, o, m, l, do, causal)
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
    for shape in ((8, 8, 50, 32), (256, 8, 50, 32), FLAT_SHAPE,
                  EVAL_FLAT_SHAPE):
        b, h, s, dh = shape
        q, k, v = (torch.randn(shape, generator=g).to("cuda", bf16)
                   for _ in range(3))
        q32, k32, v32 = (t.float() for t in (q, k, v))
        mask = torch.ones(b, s, dtype=torch.bool)
        mask[:, s - s // 5:] = False
        mask = mask.cuda()
        bias = attn.key_bias(mask, b, s, q.device)
        sdpa_mask = bias.to(bf16)[:, None, None, :]
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=sdpa_mask)
        t = {
            "ms": device_ms(lambda: attn.flash_attention_forward(q, k, v,
                                                                 mask)),
            "plain_ms": device_ms(lambda: attn.attention_reference(q, k, v,
                                                                   bias)),
            "library_ms": device_ms(library),
            "f32_ms": device_ms(lambda: attn.flash_attention_forward(
                q32, k32, v32, mask)),
        }
        t.update(forward_bound(shape, 2, BF16_FLOPS))
        fwd_t[shape] = t
        log(f"[time] bf16 attention {shape} device time (CUDA graph of 20 "
            f"calls, median of 50): kernel {t['ms']:.4f} ms, plain bf16 "
            f"{t['plain_ms']:.4f} ms, library (bf16 "
            f"scaled_dot_product_attention, O only; {sdpa_kernels(library)})"
            f" {t['library_ms']:.4f} ms, float32 kernel {t['f32_ms']:.4f} ms"
            f"; bound {t['bound_ms']:.4f} ms ({t['bound_by']}) [{card}]")
    for shape in ((256, 8, 50, 32), (1, 2, 4096, 64), FLAT_SHAPE):
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
    log(f"[bf16 kernel] worst errors over {len(cases)} cases: "
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
    flat_ms, _, flat_counts, _ = phase_train_steps(
        flat_args, spec, flat_batch, card, "crello_flat bf16")
    log(f"[bf16] crello_flat: median step {flat_ms:.2f} ms against float32 "
        f"{f32_flat_ms:.2f} ms (batch {FLAT_BATCH}) [{card}]")
    log(f"[bf16] phase done in {time.perf_counter() - t0:.1f} s")
    return step_ms, flat_ms, {
        "crello_ours_exp_bf16_steps": counts,
        "crello_ours_exp_bf16_cli": cli_counts,
        "crello_ours_exp_bf16_eval": eval_counts,
        "crello_flat_bf16_steps": flat_counts,
    }



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
    it (``to_device(next(batches))``)."""

    def __init__(self, loader, device):
        from flexdm_tpu_torch.train.trainer import to_device

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
    """14(b): every test record of phase 11's splits decoded natively
    equals its pure-Python decode, column by column (dtype and shape
    included); the native scan gives the Python scan's payloads, with the
    CRCs verified by each."""
    from flexdm_tpu_torch.data import DatasetSpec, tfrecord

    t0 = time.perf_counter()
    for dataset, data_dir in data.items():
        native = DatasetSpec(dataset, data_dir)
        python = DatasetSpec(dataset, data_dir, native=False)
        check(native._native_decoder is not None
              and native._native_layout is not None,
              f"{dataset}: the native decoder is not in use")
        records = columns = 0
        for shard in tfrecord.list_shards(data_dir, "test"):
            payloads = tfrecord.read_records(shard, verify_crc=True)
            check(payloads == tfrecord.read_records(
                shard, verify_crc=True, native=False),
                f"{shard}: native and Python scans differ")
            for i, p in enumerate(payloads):
                got = native.decode_record(p)
                check(_records_equal(got, python.decode_record(p)),
                      f"{shard} record {i}: native decode != Python decode")
                records += 1
                columns += len(got)
        check(records == EVAL_DOCS, f"{dataset}: {records} test records")
        log(f"[decode] {dataset}: {records} records, {columns} columns "
            f"decoded natively = pure Python (np.array_equal, same dtype "
            f"and shape); native scan = Python scan with verify_crc=True")
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


def main():
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

    phase_build()
    kernel_err, timings = phase_kernel(card)
    backward_err, backward_timings = phase_backward(card)
    phase_slice(card)
    maskgit_ms = phase_maskgit(card)
    with tempfile.TemporaryDirectory() as root:
        data_dir, spec, batch = train_data(root, "crello", seed=0)
        step_ms, f32_losses, step_counts, train_counts = phase_train(
            card, root, data_dir, spec, batch)
        rico_ms, rico_counts = phase_rico(card, root)
        flat_ms, flat_counts = phase_flat(card, root, data_dir, spec, batch)
        data = eval_data(root)
        eval_counts = phase_eval(card, root, data)
        bf16_err, bf16_fwd, bf16_bwd = phase_bf16_kernel(card)
        bf16_ms, bf16_flat_ms, bf16_counts = phase_bf16(
            card, root, data_dir, spec, batch, data, f32_losses, step_ms,
            flat_ms)
        rates, trainer_counts = phase_trainer(card, root, data_dir, spec,
                                              batch)
        decode_s, demo_counts = phase_decode_demo(card, root, data_dir, data)
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
               **bf16_counts, **trainer_counts, "demo": demo_counts}
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
                "library_ms": t["library_ms"], "shape": list(shape)}

    def bwd_times(t, part):
        bd = t["bounds"][part]
        return {"ms": t[part], "plain_ms": t["plain"],
                "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
                "library_ms": t["library"], "shape": list(shape)}

    def entry(name, dtype, source, replaces, key, cli_counts, err, t):
        """One kernel: ``launches`` from the CLI run of its dtype."""
        return {"name": name, "route": "cuda", "dtype": dtype,
                "source": csrc + source, "replaces": replaces,
                "launches": cli_counts[key],
                "launches_by_path": {path: counts[key]
                                     for path, counts in by_path.items()},
                "max_abs_err": err, **t}

    fwd, bwd = timings[shape], backward_timings[shape]
    fwd16, bwd16 = bf16_fwd[shape], bf16_bwd[shape]
    dq_tpu = f"{tpu}:116 and {tpu}:217"
    dkv_tpu = f"{tpu}:156 and {tpu}:254"
    log(json.dumps({"kernels": [
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
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
