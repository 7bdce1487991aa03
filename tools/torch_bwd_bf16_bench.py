"""Compare builds of the port's flash-attention backward on one GPU.

    python tools/torch_bwd_bf16_bench.py [--dtype bfloat16|float32]
        [--wide] [--other NAME=PATH.cu ...] [--steps] [--turns N]

Builds the backward source of ``--dtype`` as the port builds it
(``this``: ``flash_attention_bwd_bf16.cu`` for bfloat16, the default, or
``flash_attention_bwd.cu`` for float32; with ``--wide``, the kernels of
head dims above 128: ``flash_attention_bwd_wide.cu`` in float32,
``flash_attention_wide.cu`` in bfloat16) and every ``--other`` source with
the same C entry points (an earlier revision of the file, e.g. the parent
commit's ``csrc/`` unpacked with ``git archive`` under ``build/`` so that its
own headers sit beside it), one nvcc each, all at once.  Then:

* prints each build's ptxas report (registers, spills, any C7520 line) and,
  from ``cuobjdump -sass``, each backward instance's HGMMA, UTMALDG, HMMA
  and LDSM counts;
* checks every build's dq, dk and dv against the plain backward (bfloat16:
  one bf16 ulp plus 2^-8 of the largest entry; float32: 1e-4 abs + 1e-4
  rel) at each timed shape, and that a second call is bitwise equal;
* times every build's dq and dk/dv kernels at (256, 8, 50, 32),
  (64, 8, 500, 32) and (1, 2, 4096, 64) (float32 also at the causal
  (64, 8, 50, 32) of the baselines; with ``--wide`` at ``WIDE_SHAPES``
  instead: the ``--latent_dim 2048`` training and serving shapes, one
  512-wide head, S = 4096 and S = 500 at Dh 256) as device time (CUDA
  graph of 20 calls, median of 50; 10 at the wide shapes), in turns: the
  builds in the order given, then reversed, ``--turns`` times in all;
  beside them the library's backward (``scaled_dot_product_attention``
  forward + backward less the forward, in the same dtype), the bound of
  ``chip_smoke.backward_bounds`` (causal: ``chip_smoke.causal_bound``) and,
  in float32, the split-TF32 tensor floors (:func:`split_floors`), with
  the last fifth of the keys masked;
* with ``--steps``: the crello_flat training step at batch 64 in the dtype
  (with ``--wide``: crello Ours-EXP at ``--latent_dim 2048``, Dh 256,
  batch 256) (random weights, seed 0; one synthetic batch) with each
  build swapped in, in turns (A, B, B, A): median of 20 warm steps
  between CUDA events and on the host clock (each step synchronised), and
  from ``torch.profiler`` over 10 steps the device kernel time per step,
  the attention kernels' share, the forward kernel's and the backward
  kernels'.

Prints one line per measurement and, last, one JSON object with all of
them.
"""

import argparse
import collections
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SHAPES = ((256, 8, 50, 32), (64, 8, 500, 32), (1, 2, 4096, 64))
# float32 also at the baselines' causal training shape.
F32_SHAPES = SHAPES + (chip_smoke.CAUSAL_SHAPE,)
# The wide kernels' shapes: crello Ours-EXP at --latent_dim 2048 (Dh 256)
# trained and served, one 512-wide head (num_heads 1 at latent 512), and
# Dh 256 at S = 4096 and S = 500.
WIDE_SHAPES = ((256, 8, 50, 256), (256, 1, 50, 512), (8, 8, 50, 256),
               (1, 2, 4096, 256), (64, 8, 500, 256))
WIDE_LATENT = 2048
ENTRIES = {"bfloat16": ("flexdm_flash_attention_bwd_dq_bf16",
                        "flexdm_flash_attention_bwd_dkv_bf16"),
           "float32": ("flexdm_flash_attention_bwd_dq",
                       "flexdm_flash_attention_bwd_dkv")}


def entries(dtype, wide=False):
    """The ``(dq, dkv)`` C entry points of ``dtype`` (the wide kernels'
    with ``wide``)."""
    from flexdm_tpu_torch.ops import attention as attn

    bf16 = dtype == "bfloat16"
    return tuple(attn._symbol(k, bf16, wide) for k in ("dq", "dkv"))


def library(dtype, wide=False):
    """The port's (library name, sources) of the backward of ``dtype`` (the
    wide kernels' with ``wide``)."""
    from flexdm_tpu_torch.ops import attention as attn

    if wide:
        return (attn.WIDE_LIBRARY if dtype == "bfloat16"
                else attn.BWD_WIDE_LIBRARY)
    return (attn.BWD_BF16_LIBRARY if dtype == "bfloat16"
            else attn.BWD_LIBRARY)


def split_floors(shape, tile=64):
    """The split-TF32 tensor floors (ms) of dq and dk/dv at ``shape``:
    three TF32 products for each float32 product (dq 3, dk/dv 4, of
    2 B H S^2 Dh FLOPs each) at the TF32 peak (``split_floor_ms``), and
    with S rounded up to whole ``tile``-row items on both axes, as the
    kernels' tiles run it (``split_floor_padded_ms``)."""
    b, h, s, dh = shape
    padded = -(-s // tile) * tile
    out = {}
    for part, products in (("dq", 3), ("dkv", 4)):
        flops = [3 * products * 2 * b * h * n * n * dh for n in (s, padded)]
        out[part] = {"split_floor_ms": flops[0] / chip_smoke.TF32_FLOPS * 1e3,
                     "split_floor_padded_ms":
                         flops[1] / chip_smoke.TF32_FLOPS * 1e3}
    return out


def bind(lib, dtype, wide=False):
    """The ``(dq, dkv)`` entry points of a loaded library."""
    fns = []
    for symbol in entries(dtype, wide):
        fn = getattr(lib, symbol)
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns.append(fn)
    return tuple(fns)


def build(name, source, dtype, wide=False):
    """``(name, (dq, dkv), ptxas summary, library path)``: the port's own
    library for ``source`` None, else nvcc of ``source`` into the build
    dir."""
    from flexdm_tpu_torch.ops import _build

    if source is None:
        lib = library(dtype, wide)
        path = str(_build.build_library(*lib))
        report = _build.BUILD_LOGS.get(lib[0], "")
    else:
        path = os.path.join(_build.BUILD_DIR, f"libbwd_bench_{name}.so")
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", path, source]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        report = proc.stdout + proc.stderr
    return (name, bind(ctypes.CDLL(path), dtype, wide),
            chip_smoke.ptxas_summary(report), path)


def sass_counts(path):
    """Per backward instance of a library: HGMMA, UTMALDG, HMMA and LDSM
    counts and instructions, from ``cuobjdump -sass``."""
    import re

    from tools.torch_sass_hazards import sass_functions

    out = {}
    for fname, rows in sass_functions(path).items():
        if "flash_bwd" not in fname:
            continue
        kernel = re.search(r"(flash_bwd_\w+?_kernel)", fname).group(1)
        args = re.findall(r"L[ib](\d+)E", fname)
        ops = collections.Counter(op.split(".")[0] for op, _, _ in rows)
        out[f"{kernel}<{','.join(args)}>"] = dict(
            {op: ops[op] for op in ("HGMMA", "UTMALDG", "HMMA", "LDSM")},
            instructions=len(rows))
    return out


def inputs(shape, seed, dtype, causal=False):
    """q, k, v, dO of ``dtype`` with the last fifth of the keys masked, and
    the forward's O, m and l."""
    import torch

    from flexdm_tpu_torch.ops import attention as attn

    b, _, s, _ = shape
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g).to("cuda", dtype)
                   for _ in range(4))
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[:, s - s // 5:] = False
    mask = mask.cuda()
    o, _, m, l = attn._forward(q, k, v, mask, causal)
    return q, k, v, do, mask, o, m, l


def run(fns, q, k, v, do, mask, o, m, l, causal=False):
    """dq, dk, dv and delta through one build's two kernels."""
    import torch

    from flexdm_tpu_torch.ops import attention as attn

    b, h, s, dh = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = attn._stream(q)
    attn._launch("dq", fns[0], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 mask.data_ptr(), o.data_ptr(), do.data_ptr(), m.data_ptr(),
                 l.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, s, dh,
                 int(causal), stream)
    attn._launch("dkv", fns[1], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 mask.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(),
                 delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, s, dh,
                 int(causal), stream)
    return dq, dk, dv, delta


def close(dtype, got, want):
    """(within the bar, max |error|) of a kernel's gradient."""
    if dtype == "bfloat16":
        return chip_smoke.bf16_close(got, want)
    return (bool((got - want).abs().le(
        chip_smoke.BACKWARD_TOL["atol"]
        + chip_smoke.BACKWARD_TOL["rtol"] * want.abs()).all()),
            (got - want).abs().max().item())


def bench_kernels(builds, card, dtype="bfloat16", turns=2, wide=False):
    import torch
    import torch.nn.functional as F

    from flexdm_tpu_torch.ops import attention as attn

    torch_dtype = getattr(torch, dtype)
    results = {}
    shapes = (WIDE_SHAPES if wide else F32_SHAPES if dtype == "float32"
              else SHAPES)
    for shape in shapes:
        samples = 10 if wide else 50
        causal = shape == chip_smoke.CAUSAL_SHAPE and dtype == "float32"
        q, k, v, do, mask, o, m, l = inputs(shape, sum(shape), torch_dtype,
                                            causal)
        b, h, s, dh = shape
        bias = attn.key_bias(mask, b, s, q.device)
        want = attn.attention_reference_backward(q, k, v, bias, o, do,
                                                 causal)
        errs = {}
        for name, fns, _, _ in builds:
            got = run(fns, q, k, v, do, mask, o, m, l, causal)[:3]
            again = run(fns, q, k, v, do, mask, o, m, l, causal)[:3]
            chip_smoke.check(all(torch.equal(x, y) for x, y in
                                 zip(got, again)),
                             f"{name}: two calls differ at {shape}")
            errs[name] = 0.0
            for gname, x, w in zip(("dq", "dk", "dv"), got, want):
                ok, err = close(dtype, x, w)
                chip_smoke.check(ok, f"{name} {gname} at {shape}: {err}")
                errs[name] = max(errs[name], err)
        del want
        times = {name: {"dq": [], "dkv": []} for name, _, _, _ in builds}
        for name, fns, _, _ in (builds + builds[::-1]) * max(1, turns // 2):
            delta = run(fns, q, k, v, do, mask, o, m, l, causal)[3]
            dq, dk, dv = (torch.empty_like(q) for _ in range(3))
            # The stream is read at each call: device_ms captures on its own.
            times[name]["dq"].append(chip_smoke.device_ms(
                samples=samples, fn=lambda: fns[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               mask.data_ptr(), o.data_ptr(), do.data_ptr(),
                               m.data_ptr(), l.data_ptr(), delta.data_ptr(),
                               dq.data_ptr(), b, h, s, dh, int(causal),
                               attn._stream(q))))
            times[name]["dkv"].append(chip_smoke.device_ms(
                samples=samples, fn=lambda: fns[1](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               mask.data_ptr(), do.data_ptr(), m.data_ptr(),
                               l.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                               dv.data_ptr(), b, h, s, dh, int(causal),
                               attn._stream(q))))
        sdpa_mask = bias.to(torch_dtype)[:, None, None, :]

        def lib_call(backward):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(
                *leaves, attn_mask=None if causal else sdpa_mask,
                is_causal=causal)
            return torch.autograd.grad(out, leaves, do) if backward else out

        lib = (chip_smoke.device_ms(lambda: lib_call(True), samples)
               - chip_smoke.device_ms(lambda: lib_call(False), samples))
        if causal:
            bd = chip_smoke.causal_bound(shape, (s + 1) / (2 * s))[1:]
        elif dtype == "float32":
            bd = chip_smoke.backward_bounds(shape)
        else:
            bd = chip_smoke.backward_bounds(shape, 2, chip_smoke.BF16_FLOPS)
        bounds = dict(zip(("dq", "dkv"), bd))
        if dtype == "float32":
            for part, floors in split_floors(shape).items():
                bounds[part] = dict(bounds[part], **floors)
        label = f"{shape}{' causal' if causal else ''}"
        first = builds[0][0]
        med = {name: {part: statistics.median(v) for part, v in t.items()}
               for name, t in times.items()}
        for name in times:
            chip_smoke.log(
                f"[bwd {dtype}] {label} {name}: dq {times[name]['dq']} ms, "
                f"dkv {times[name]['dkv']} ms (turns); medians dq "
                f"{med[name]['dq']:.4f} ({med[name]['dq'] / med[first]['dq']:.3f}"
                f" x {first}), dkv {med[name]['dkv']:.4f} "
                f"({med[name]['dkv'] / med[first]['dkv']:.3f} x {first}); "
                f"max abs err {errs[name]:.2e} [{card}]")
        chip_smoke.log(
            f"[bwd {dtype}] {label}: library backward {lib:.4f} ms "
            f"(scaled_dot_product_attention{', is_causal' if causal else ''})"
            f"; bounds dq {bounds['dq']['bound_ms']:.4f} "
            f"({bounds['dq']['bound_by']}), dkv "
            f"{bounds['dkv']['bound_ms']:.4f} ({bounds['dkv']['bound_by']}) "
            f"ms" + "".join(
                f"; split-TF32 floor {part} {b['split_floor_ms']:.4f} "
                f"(S padded {b['split_floor_padded_ms']:.4f})"
                for part, b in bounds.items() if "split_floor_ms" in b)
            + f" [{card}]")
        results[label] = {"times": times, "medians": med, "max_abs_err": errs,
                          "library_ms": lib, "bounds": bounds}
    return results


def bench_steps(builds, card, attr="_bwd_kernels", tag="bwd bf16 steps",
                dtype="bfloat16", wide=False):
    """The crello_flat step in ``dtype`` (with ``wide``: crello Ours-EXP at
    ``--latent_dim`` ``WIDE_LATENT``, batch 256) with each build's entry
    points swapped in for ``attention.<attr>`` (the backward's pair by
    default; the forward tool swaps ``_kernel``) for that dtype and width,
    in turns (A, B, B, A)."""
    import time

    import torch

    from flexdm_tpu_torch.config import TrainConfig, build_model
    from flexdm_tpu_torch.convert import init_params
    from flexdm_tpu_torch.models import make_task_config
    from flexdm_tpu_torch.models.masking import draw_train
    from flexdm_tpu_torch.ops import attention as attn
    from flexdm_tpu_torch.train.optim import KerasAdam
    from flexdm_tpu_torch.train.trainer import make_train_step

    torch_dtype = getattr(torch, dtype)
    own = getattr(attn, attr)
    results = {name: [] for name, _, _ in builds}
    with tempfile.TemporaryDirectory() as root:
        data_dir, spec, batch = chip_smoke.train_data(root, "crello", 0)
        if wide:
            args = dict(chip_smoke.load_args(chip_smoke.CONFIG, data_dir),
                        latent_dim=WIDE_LATENT)
            rows, label = chip_smoke.TRAIN_BATCH, (
                f"crello Ours-EXP --latent_dim {WIDE_LATENT}")
        else:
            args = chip_smoke.load_args(chip_smoke.FLAT_CONFIG, data_dir)
            rows, label = chip_smoke.FLAT_BATCH, "crello_flat"
        if dtype == "bfloat16":
            args = dict(args, dtype=chip_smoke.BF16)
        config = TrainConfig.from_args(args)
        task_config = make_task_config(spec.schema, config.masking_method)
        model = init_params(build_model(config, spec.schema), 0).cuda()
        step = make_train_step(model, task_config,
                               KerasAdam(model.parameters(),
                                         config.learning_rate), config.l2)
        batch = {k: v[:rows].cuda() for k, v in batch.items()}
        generator = torch.Generator("cuda").manual_seed(0)
        draws = draw_train(spec.schema, rows, task_config.task_probs,
                           generator, **model.draw_options())
        draws.dropout = generator
        try:
            for name, fns, _ in [builds[0], *builds[1:], *builds[1:],
                                 builds[0]]:
                # The swapped entry points serve the bench's dtype and
                # width; every other instance stays the port's.
                setattr(attn, attr,
                        lambda dt=torch.float32, w=False, fns=fns:
                        fns if (dt, w) == (torch_dtype, wide)
                        else own(dt, w))
                for _ in range(5):
                    step(batch, draws)
                times, host = [], []
                for _ in range(20):
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    start.record()
                    step(batch, draws)
                    stop.record()
                    stop.synchronize()
                    host.append((time.perf_counter() - t0) * 1e3)
                    times.append(start.elapsed_time(stop))
                by_name, kernels = chip_smoke.profile_by_name(
                    lambda: step(batch, draws), steps=10)
                device = sum(by_name.values())
                attention = sum(v for k, v in by_name.items()
                                if "flash_" in k)
                fwd = sum(v for k, v in by_name.items() if "flash_fwd" in k)
                bwd = sum(v for k, v in by_name.items() if "flash_bwd" in k)
                top = chip_smoke.top_kernels(by_name)
                results[name].append({
                    "step_ms": statistics.median(times),
                    "host_ms": statistics.median(host), "device_ms": device,
                    "attention_ms": attention, "fwd_ms": fwd, "bwd_ms": bwd,
                    "kernels": kernels})
                chip_smoke.log(
                    f"[{tag}] {name}: {label} {dtype} step "
                    f"{statistics.median(times):.2f} ms between events, "
                    f"{statistics.median(host):.2f} ms on the host clock "
                    f"(medians of 20), device kernel time {device:.3f} ms "
                    f"per step, attention kernels {attention:.3f} ms (the "
                    f"forward {fwd:.3f}, the backward {bwd:.3f}), "
                    f"{kernels:.0f} kernels; most time: {top} [{card}]")
        finally:
            setattr(attn, attr, own)
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dtype", default="bfloat16",
                        choices=sorted(ENTRIES))
    parser.add_argument("--wide", action="store_true",
                        help="the kernels of head dims above 128, at "
                        "WIDE_SHAPES (--steps: --latent_dim 2048)")
    parser.add_argument("--other", action="append", default=[],
                        metavar="NAME=PATH.cu",
                        help="another build of the same entry points")
    parser.add_argument("--steps", action="store_true",
                        help="also time the crello_flat step")
    parser.add_argument("--turns", type=int, default=2,
                        help="times of each build at each shape, in pairs "
                        "(the order given, then reversed)")
    args = parser.parse_args(argv)
    for other in args.other:
        if "=" not in other:
            parser.error(f"--other takes NAME=PATH.cu, got {other!r}")
    return args


def main(argv=None):
    import torch

    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this bench needs one GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    jobs = [("this", None)] + [tuple(o.split("=", 1)) for o in args.other]
    with ThreadPoolExecutor(len(jobs)) as pool:
        builds = list(pool.map(
            lambda job: build(*job, args.dtype, args.wide), jobs))
    out = {"card": card, "dtype": args.dtype, "wide": args.wide,
           "ptxas": {}, "sass": {}}
    for name, _, summary, path in builds:
        chip_smoke.log(f"[build] {name}: " + "; ".join(summary))
        out["ptxas"][name] = summary
        out["sass"][name] = sass_counts(path)
        for kernel, counts in out["sass"][name].items():
            chip_smoke.log(f"[sass] {name} {kernel}: {counts}")
    out["kernels"] = bench_kernels(builds, card, args.dtype, args.turns,
                                   args.wide)
    if args.steps:
        out["steps"] = bench_steps(
            [b[:3] for b in builds], card, dtype=args.dtype,
            tag=f"bwd {args.dtype}{' wide' * args.wide} steps",
            wide=args.wide)
    chip_smoke.log(json.dumps(out))


if __name__ == "__main__":
    main()
