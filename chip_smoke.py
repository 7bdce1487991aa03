"""Smoke run of the PyTorch port (flexdm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. device: a CUDA device is present; prints torch/CUDA versions and the
   card's name and power limit; TF32 off, so float32 means float32;
2. build: compiles the CUDA libraries from ``flexdm_tpu_torch/csrc`` with
   nvcc for sm_90a, one nvcc per source, all at once (seconds, printed
   with the ptxas report);
3. kernel: the flash-attention forward kernel (split-TF32 tensor-core
   products) against its plain PyTorch version on the card (O and lse
   within 2e-5 abs + 2e-5 rel, float32) at the serving and training
   shapes, S=650 and the kernel's tile edges (S = 16, 17, 63, 64, 65,
   128, 129 at Dh 32, 64, 128), and a second call bitwise equal to the
   first; then kernel, plain version and one library call
   (``scaled_dot_product_attention``, a yardstick the port never calls)
   timed at (8, 8, 50, 32), (256, 8, 50, 32) and (8, 8, 650, 32), beside
   the bound computed from the shapes;
4. backward: the backward kernels (dq with delta, dk/dv; split-TF32
   tensor-core products) through autograd against the plain backward and
   against autograd of the plain forward, dq, dk and dv within 1e-4 abs +
   1e-4 rel at every shape, S=4096 (the regime of the TPU's stream
   kernels) and the kernels' tile edges (S = 64, 65, 128, 129 at Dh 32,
   64, 128) included, and a second call bitwise equal to the first; then
   the kernels, the plain autograd backward and the library call's
   backward timed, beside their bounds;
5. slice: the crello Ours-EXP job (D=256, 4 DeepSVG blocks, 8 heads,
   batch 8) with random weights from seed 0 on a synthetic data dir,
   served over HTTP through ``CoalescingEngine``; every answer is checked
   and the kernel's launch count over the requests must cover every
   attention call of every forward pass;
6. parity: the same masked batch through the model on the card (kernel)
   and on the CPU (plain attention); decoder outputs within 1e-4;
7. train: crello Ours-EXP at full width and batch 256 on a synthetic
   512/64/64 data dir: (i) one step on the card against the same step on
   a CPU copy (dropout 0, same draws): loss, every clipped gradient leaf
   and the updated parameters; (ii) 30 steps on one fixed batch lower the
   loss, timed with CUDA events; (iii) ``python -m flexdm_tpu_torch``'s
   ``main()`` for 2 epochs, every ``history.jsonl`` value finite, and the
   serving engine loads its ``best`` and answers ``/predict``.  Each run
   counts the launches of every kernel: each backward kernel at least once
   per block per step.

The last lines are one JSON object per kernel (times at the training
shape (256, 8, 50, 32); launches from the training CLI run), the card's name
and power limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.
"""

import copy
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


def phase_build():
    """Every kernel library, one nvcc each, all started together."""
    from flexdm_tpu_torch.ops import _build
    from flexdm_tpu_torch.ops import attention as attn

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(attn.LIBRARIES)) as pool:
        list(pool.map(lambda lib: _build.build_library(*lib), attn.LIBRARIES))
    attn._kernel()
    attn._bwd_kernels()
    log(f"[build] {', '.join(src for _, lib in attn.LIBRARIES for src in lib)}"
        f" -> sm_90a in {time.perf_counter() - t0:.2f} s")
    for name, _ in attn.LIBRARIES:
        log(_build.BUILD_LOGS.get(name, f"{name}: (reused build)").strip())


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
    for shape in ((8, 8, 50, 32), (256, 8, 50, 32), (8, 8, 650, 32)):
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


# Peaks of one NVIDIA H100 SXM (data sheet, dense): HBM bytes/s, TF32
# tensor-core and FP32 (FMA pipe) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12


def bound(nbytes, flops):
    """The least time (ms) for ``nbytes`` of device-memory traffic and
    ``flops`` of TF32 tensor-core work, and which of the two sets it, beside
    the same work on the FP32 pipes."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / TF32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "fp32_bound_ms": max(t_bytes, flops / FP32_FLOPS * 1e3)}


def forward_bound(shape):
    """Reads q, k, v and the (B, S) byte mask; writes O, lse, m, l.  Two
    products of 2 S^2 Dh FLOPs per (batch, head)."""
    b, h, s, dh = shape
    rows = b * h * s
    return bound(4 * (4 * rows * dh + 3 * rows) + b * s,
                 4 * b * h * s * s * dh)


def backward_bounds(shape):
    """dq: reads q, k, v, o, dO, m, l, mask, writes dq, delta; 3 products.
    dk/dv: reads q, k, v, dO, m, l, delta, mask, writes dk, dv; 4 products
    (2 S^2 Dh FLOPs each)."""
    b, h, s, dh = shape
    rows = b * h * s
    product = 2 * b * h * s * s * dh
    return (bound(4 * (6 * rows * dh + 3 * rows) + b * s, 3 * product),
            bound(4 * (6 * rows * dh + 3 * rows) + b * s, 4 * product))


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


def make_job(root):
    """A crello data dir and an Ours-EXP job with port weights (seed 0)."""
    from flexdm_tpu_torch.data import DatasetSpec, synthetic

    from flexdm_tpu_torch.config import TrainConfig, build_model
    from flexdm_tpu_torch.convert import init_params, save_weights

    data_dir = synthetic.generate(
        "crello", os.path.join(root, "data"), 64, 16, 16, seed=0
    )
    job = os.path.join(root, "job")
    os.makedirs(os.path.join(job, "checkpoints"))
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, CONFIG)) as f:
        args = json.load(f)
    args["data_dir"] = data_dir
    with open(os.path.join(job, "args.json"), "w") as f:
        json.dump(args, f)
    spec = DatasetSpec("crello", data_dir, BATCH)
    model = init_params(build_model(TrainConfig.from_args(args), spec.schema), 0)
    save_weights(os.path.join(job, "checkpoints", "best.torch.npz"), model)
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
        finally:
            server.shutdown()
            server.server_close()
        log(f"[slice] kernel launches {launches} over {passes} forward passes "
            f"x {num_blocks} blocks")
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
    for shape in ((256, 8, 50, 32), (1, 2, 4096, 64)):
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


def launch_counts():
    from flexdm_tpu_torch.ops import attention as attn

    return {"fwd": attn.KERNEL_LAUNCHES, "dq": attn.BWD_DQ_LAUNCHES,
            "dkv": attn.BWD_DKV_LAUNCHES}


def train_setup(root):
    """A synthetic crello dir big enough for full batches of 256, and the
    Ours-EXP preset pointing at it."""
    from flexdm_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    data_dir = synthetic.generate(
        "crello", os.path.join(root, "train_data"), 2 * TRAIN_BATCH, 64, 64,
        seed=0)
    log(f"[train] synthetic crello 512/64/64 in "
        f"{time.perf_counter() - t0:.1f} s")
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, CONFIG)) as f:
        args = json.load(f)
    args["data_dir"] = data_dir
    return data_dir, args


def phase_train_parity(args, spec, batch):
    """One step on the card against the same step on a CPU copy (dropout
    0, the same draws).  Loss and per-field losses within 1e-5 relative;
    every clipped gradient leaf (``mu / 0.1`` after the first keras-Adam
    step) within 1e-5 + 1e-3 of the leaf's largest entry, and nonzero;
    parameters within 1e-6 where |g| > 1e-3 on both, within 2 lr + 1e-6
    elsewhere (a near-zero gradient's sign decides a +-lr first step)."""
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
    draws = draw_train(schema, TRAIN_BATCH, task_config.task_probs,
                       torch.Generator().manual_seed(3))
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
    log(f"[train] step parity, card vs CPU, batch {TRAIN_BATCH}: loss "
        f"{got_m['loss']:.6f} vs {want_m['loss']:.6f}; max |dg| "
        f"{worst_g:.2e} over {len(names)} leaves (all nonzero); max |dp| "
        f"{worst_p:.2e} where |g| > 1e-3")
    return got_m["loss"], want_m["loss"]


def phase_train_steps(args, spec, batch, card):
    """30 steps on one fixed batch (fixed draws, dropout on): the loss
    falls; the last 20 steps timed one by one with CUDA events."""
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
    draws = draw_train(schema, TRAIN_BATCH, task_config.task_probs, generator)
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
    log(f"[train] {TRAIN_STEPS} steps on one batch: loss {losses[0]:.3f} -> "
        f"{losses[-1]:.3f}; launches {counts} for {TRAIN_STEPS} steps x "
        f"{num_blocks} blocks")
    check(all(math.isfinite(x) for x in losses), "non-finite training loss")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name, n in counts.items():
        check(n >= num_blocks * TRAIN_STEPS,
              f"{name} kernel launched {n} times for {TRAIN_STEPS} steps")
    step_ms = statistics.median(times)
    log(f"[time] train step, crello Ours-EXP, batch {TRAIN_BATCH} (fixed "
        f"batch, draws and dropout on the card; CUDA events, median of "
        f"{TIMED_STEPS} warm steps): {step_ms:.2f} ms, "
        f"{TRAIN_BATCH / step_ms * 1e3:.0f} documents/s; min "
        f"{min(times):.2f} max {max(times):.2f} ms [{card}]")
    return step_ms, losses


def phase_train_cli(root, data_dir, card):
    """``python -m flexdm_tpu_torch`` for 2 epochs, then serve its best."""
    import torch

    from flexdm_tpu_torch.data import DatasetSpec, split_device_batch

    from flexdm_tpu_torch.cli import main as train_main
    from flexdm_tpu_torch.ops import attention as attn
    from flexdm_tpu_torch.serve import InferenceEngine, _jsonable, serve

    job = os.path.join(root, "train_job")
    argv = ["--preset", "crello_ours_exp", "--data_dir", data_dir,
            "--job-dir", job, "--num_epochs", "2", "--validation_freq", "1",
            "--log_level", "WARNING"]
    attn.reset_launch_counts()
    t0 = time.perf_counter()
    train_main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    with open(os.path.join(job, "logs", "history.jsonl")) as f:
        history = [json.loads(line) for line in f]
    steps = history[-1]["step"]
    log(f"[train] CLI {' '.join(argv[:2])} ... --num_epochs 2: {steps} steps "
        f"in {seconds:.1f} s (validation, test and checkpoints included) "
        f"[{card}]; launches {counts}")
    log(f"[train] history: " + "; ".join(
        f"epoch {h['epoch']} loss {h['loss']:.3f} val_total_score "
        f"{h['val_total_score']:.4f}" for h in history))
    check(len(history) == 2 and steps == 4, f"history {history}")
    check(all(finite(h) for h in history), "non-finite value in history")
    check(counts["dq"] >= 4 * steps and counts["dkv"] >= 4 * steps,
          f"backward kernels launched {counts} for {steps} steps")
    check(counts["fwd"] >= 4 * steps, f"forward launched {counts}")

    engine = InferenceEngine(job, batch_size=BATCH, device="cuda")
    spec = DatasetSpec("crello", data_dir, BATCH)
    docs = _jsonable(spec.unbatch(split_device_batch(
        next(iter(spec.make_dataset("test", batch_size=4))))))
    server = serve(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        body, secs = http(server.server_address[1], "/predict",
                          dict(task="pos", documents=docs))
    finally:
        server.shutdown()
        server.server_close()
    check_predictions(spec, "pos", docs, body["predictions"])
    log(f"[train] the trained job's best served: /predict pos x{len(docs)} "
        f"docs: 200 in {secs * 1e3:.1f} ms")
    return counts, seconds, steps


def phase_train(card):
    import torch

    from flexdm_tpu_torch.data import DatasetSpec, split_device_batch

    with tempfile.TemporaryDirectory() as root:
        data_dir, args = train_setup(root)
        spec = DatasetSpec("crello", data_dir, TRAIN_BATCH)
        batch = {k: torch.from_numpy(v) for k, v in split_device_batch(
            next(iter(spec.make_dataset("train")))).items()}
        phase_train_parity(args, spec, batch)
        step_ms, _ = phase_train_steps(args, spec, batch, card)
        counts, _, _ = phase_train_cli(root, data_dir, card)
    return step_ms, counts


def main():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke run needs one GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[device] torch {torch.__version__} CUDA {torch.version.cuda} "
        f"python {sys.version.split()[0]}; {card}")

    phase_build()
    kernel_err, timings = phase_kernel(card)
    backward_err, backward_timings = phase_backward(card)
    phase_slice(card)
    step_ms, train_counts = phase_train(card)
    # The training shape, which every kernel of the path runs at (the
    # forward also serves at (8, 8, 50, 32): the log lines above).
    shape = (256, 8, 50, 32)
    fwd = timings[shape]
    bwd = backward_timings[shape]
    source = "flexdm_tpu_torch/csrc/flash_attention_bwd.cu"
    tpu = "flexdm_tpu/ops/attention.py"

    def times(ms, plain_ms, library_ms, bd):
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bd["bound_ms"],
                "bound_by": bd["bound_by"], "library_ms": library_ms,
                "shape": list(shape)}

    log(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "flexdm_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": f"{tpu}:77",
        "launches": train_counts["fwd"],
        "max_abs_err": kernel_err,
        **times(fwd["ms"], fwd["plain_ms"], fwd["library_ms"], fwd),
    }, {
        "name": "flash_attention_bwd_dq",
        "route": "cuda",
        "source": source,
        "replaces": f"{tpu}:116 and {tpu}:217",
        "launches": train_counts["dq"],
        "max_abs_err": backward_err["dq"],
        **times(bwd["dq"], bwd["plain"], bwd["library"], bwd["bounds"]["dq"]),
    }, {
        "name": "flash_attention_bwd_dkv",
        "route": "cuda",
        "source": source,
        "replaces": f"{tpu}:156 and {tpu}:254",
        "launches": train_counts["dkv"],
        "max_abs_err": max(backward_err["dk"], backward_err["dv"]),
        **times(bwd["dkv"], bwd["plain"], bwd["library"],
                bwd["bounds"]["dkv"]),
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
