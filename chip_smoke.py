"""Smoke run of the PyTorch port (flexdm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. device: a CUDA device is present; prints torch/CUDA versions and the
   card's name and power limit; TF32 off, so float32 means float32;
2. build: compiles the CUDA kernels from ``flexdm_tpu_torch/csrc`` with
   nvcc for sm_90a (seconds, printed with the ptxas report);
3. kernel: the flash-attention forward kernel against its plain PyTorch
   version on the card (O and lse within 2e-5 abs + 2e-5 rel, float32),
   then both timed with CUDA events;
4. slice: the crello Ours-EXP job (D=256, 4 DeepSVG blocks, 8 heads,
   batch 8) with random weights from seed 0 on a synthetic data dir,
   served over HTTP through ``CoalescingEngine``; every answer is checked
   and the kernel's launch count over the requests must cover every
   attention call of every forward pass;
5. parity: the same masked batch through the model on the card (kernel)
   and on the CPU (plain attention); decoder outputs within 1e-4.

The last lines are one JSON object per kernel, the card's name and power
limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.
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

KERNEL_TOL = dict(atol=2e-5, rtol=2e-5)
SLICE_TOL = dict(atol=1e-4, rtol=1e-4)
BATCH = 8
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


def phase_kernel(card):
    import torch

    from flexdm_tpu_torch.ops import _build
    from flexdm_tpu_torch.ops import attention as attn

    t0 = time.perf_counter()
    attn._kernel()
    log(f"[build] flash_attention_fwd.cu -> sm_90a in "
        f"{time.perf_counter() - t0:.2f} s")
    log(_build.BUILD_LOGS.get("flexdm_attention", "(reused build)").strip())

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
    ]
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
        bias = attn.key_bias(mask, b, s, q.device)
        ref_o = attn.attention_reference(q, k, v, bias, causal)
        ref_lse = attn.attention_reference_lse(q, k, bias, causal)
        torch.cuda.synchronize()
        err_o = (o - ref_o).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        worst = max(worst, err_o, err_lse)
        log(f"[kernel] {shape} causal={causal} fully_masked_row="
            f"{fully_masked}: max|dO|={err_o:.3e} max|dlse|={err_lse:.3e}")
        check(torch.isfinite(o).all().item(), f"non-finite O at {shape}")
        check(torch.allclose(o, ref_o, **KERNEL_TOL), f"O differs at {shape}")
        check(torch.allclose(lse, ref_lse, **KERNEL_TOL),
              f"lse differs at {shape}")

    timings = {}
    for shape in ((8, 8, 50, 32), (8, 8, 650, 32)):
        b, h, s, dh = shape
        q, k, v = (torch.randn(shape, generator=g).cuda() for _ in range(3))
        mask = torch.ones(b, s, dtype=torch.bool)
        mask[:, s - s // 5:] = False
        mask = mask.cuda()
        bias = attn.key_bias(mask, b, s, q.device)
        kernel = lambda: attn.flash_attention_forward(q, k, v, mask)  # noqa: E731
        plain = lambda: attn.attention_reference(q, k, v, bias)  # noqa: E731
        kernel_ms, plain_ms = device_ms(kernel), device_ms(plain)
        timings[shape] = (kernel_ms, plain_ms)
        log(f"[time] attention {shape} device time (CUDA graph of 20 calls, "
            f"median of 50): kernel {kernel_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms [{card}]")
        log(f"[time] attention {shape} per call from Python (median of "
            f"50 x 20): kernel {time_ms(kernel):.4f} ms, plain "
            f"{time_ms(plain):.4f} ms [{card}]")
    return worst, timings


def make_job(root):
    """A crello data dir and an Ours-EXP job with port weights (seed 0)."""
    from flexdm_tpu.data import DatasetSpec, synthetic

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

    from flexdm_tpu.data import split_device_batch

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
            attn.KERNEL_LAUNCHES = 0
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


def main():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke run needs one GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[device] torch {torch.__version__} CUDA {torch.version.cuda} "
        f"python {sys.version.split()[0]}; {card}")

    kernel_err, timings = phase_kernel(card)
    launches, latency, slice_err = phase_slice(card)
    kernel_ms, plain_ms = timings[(8, 8, 50, 32)]
    log(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "flexdm_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "flexdm_tpu/ops/attention.py:77",
        "launches": launches,
        "max_abs_err": kernel_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
