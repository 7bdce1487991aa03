"""Compare builds of the port's flash-attention forward kernel on one GPU.

    python tools/torch_fwd_bench.py [--dtype float32|bfloat16]
        [--other NAME=PATH.cu ...] [--steps] [--eval] [--sass-out DIR]
        [--turns N]

Builds the forward source of ``--dtype`` with the port's flags (``this``:
``flexdm_tpu_torch/csrc/flash_attention_fwd.cu`` for float32, the default,
or ``flash_attention_fwd_bf16.cu`` for bfloat16) and every ``--other``
source with the same C entry point (the parent commit's file, say, unpacked
with ``git archive`` under ``build/`` so that its own headers sit beside
it), one nvcc each, all at once, and prints each build's ptxas report
(registers, spills, any C7520 line).  Then:

* from ``cuobjdump -sass`` of each build: which of HGMMA, UTMALDG, HMMA and
  LDSM each forward instance holds, and the key loop's instructions per
  score (the loop is the backward branch whose body holds the most
  MUFU.EX2, the shortest of those; a thread forms 64 x (keys a tile) / 128
  scores a pass; the figure without the largest block a forward branch
  skips that holds no MUFU, matrix product or load is the path of a tile
  that needs no per-score checks), with the loop's opcode counts;
  ``--sass-out DIR`` writes each instance's SASS there;
* at each shape of the dtype (float32: (8, 8, 50, 32), (256, 8, 50, 32),
  (8, 8, 650, 32), (64, 8, 500, 32), (256, 8, 500, 32), the causal
  (64, 8, 50, 32) of the baselines and a rank's shapes of
  ``chip_smoke.py`` phase 16, (128, 8, 50, 32), (256, 4, 50, 32),
  (32, 8, 500, 32) and (64, 4, 50, 32), plain and causal, and
  crello_scaled's (2048, 8, 50, 64); bfloat16: (8, 8, 50, 32),
  (256, 8, 50, 32), (64, 8, 500, 32), (256, 8, 500, 32) and
  (2048, 8, 50, 64)), each with every key attended and with the last fifth
  of the keys masked: checks every build against the plain version
  (float32: O and lse within 2e-5 abs + 2e-5 rel; bfloat16: O within one
  bf16 ulp + 2^-8 max|ref|, lse within 2e-5 abs + rel) and a second call
  bitwise equal, then times every build in turns (the order given, then
  reversed, ``--turns`` times in all) as device time (CUDA graph of 20
  calls, median of 50) and per call from Python (median of 50 x 20);
  beside them the plain version, one ``scaled_dot_product_attention`` call
  of the dtype (no mask when every key is attended, the additive key bias
  otherwise, the causal band added to it) with the kernels it ran, the
  bound of ``chip_smoke.forward_bound`` (``causal_bound``: the band's
  products), the exponential floor and, for float32, the split-TF32 tensor
  floor (:func:`split_floor_ms`);
* with ``--steps``: the crello_flat training step of the dtype at batch 64
  (random weights, seed 0; one synthetic batch) with each build swapped in
  for the forward, in turns (A, B, B, A), as
  ``tools/torch_bwd_bf16_bench.py --steps`` times it: step time, device
  kernel time a step and the forward kernel's time a step;
* with ``--eval`` (float32): the crello_flat ``elem`` eval chunk of
  ``chip_smoke.py`` phase 11 (256 replicas, 4 forwards at
  (256, 8, 500, 32); random weights) with each build swapped in, A B B A:
  device kernel time a chunk and the forward kernel's share.

Prints one line per measurement and, last, one JSON object with all of
them.
"""

import argparse
import collections
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from tools.torch_sass_hazards import sass_functions  # noqa: E402

CASES = {  # (shape, causal) per dtype
    "float32": (((8, 8, 50, 32), False), ((256, 8, 50, 32), False),
                ((8, 8, 650, 32), False), ((64, 8, 500, 32), False),
                ((256, 8, 500, 32), False), (chip_smoke.CAUSAL_SHAPE, True),
                # A rank's shapes of chip_smoke.py phase 16: data- and
                # tensor-parallel crello, crello_flat data-parallel, the
                # baselines tensor-parallel.
                (chip_smoke.DP_SHAPE, False), (chip_smoke.TP_SHAPE, False),
                (chip_smoke.FLAT_DP_SHAPE, False),
                (chip_smoke.TP_BASELINE_SHAPE, False),
                (chip_smoke.TP_BASELINE_SHAPE, True),
                # crello_scaled (configs/crello_scaled.json): D=512 over 8
                # heads of 64 at batch 2048, the Dh = 64 traffic.
                ((2048, 8, 50, 64), False)),
    "bfloat16": (((8, 8, 50, 32), False), ((256, 8, 50, 32), False),
                 ((64, 8, 500, 32), False), ((256, 8, 500, 32), False),
                 ((2048, 8, 50, 64), False)),
}
ENTRIES = {"float32": "flexdm_flash_attention_fwd",
           "bfloat16": "flexdm_flash_attention_fwd_bf16"}
SOURCES = {"float32": "flash_attention_fwd.cu",
           "bfloat16": "flash_attention_fwd_bf16.cu"}


def scores_per_pass(dtype, dh):
    """A thread's scores per pass of the key loop: 64 query rows by the keys
    of a tile over a warpgroup's 128 threads (bf16: 64 keys; float32: 64 at
    Dh = 32, 32 at Dh = 64, 16 at Dh = 128)."""
    keys = {32: 64, 64: 32, 128: 16}[dh] if dtype == "float32" else 64
    return 64 * keys // 128


def split_floor_ms(shape):
    """The least time of the float32 forward's split-TF32 products: three
    TF32 products (lo hi' + hi lo' + hi hi') for each of S = Q K^T and
    O = P V, 3 x 4 B H S^2 Dh FLOPs, at the TF32 peak (every key tile is
    visited, causal too)."""
    b, h, s, dh = shape
    return 3 * 4 * b * h * s * s * dh / chip_smoke.TF32_FLOPS * 1e3


def case_bounds(shape, causal, dtype):
    """The bound (``bound_ms``, ``bound_by``), the exponential floor and,
    for float32, the split tensor floor of one case."""
    if dtype == "bfloat16":
        return chip_smoke.forward_bound(shape, 2, chip_smoke.BF16_FLOPS)
    if causal:
        s = shape[2]
        out = dict(chip_smoke.causal_bound(shape, (s + 1) / (2 * s))[0],
                   exp_floor_ms=chip_smoke.exp_floor_ms(
                       chip_smoke.attention_exps(shape, True)))
    else:
        out = chip_smoke.forward_bound(shape)
    return dict(out, split_floor_ms=split_floor_ms(shape))


def build(name, source, entry):
    """nvcc ``source`` into a library in the build dir; returns ``(name,
    entry point, ptxas report, library path)``."""
    from flexdm_tpu_torch.ops import _build

    out = os.path.join(_build.BUILD_DIR, f"libfwd_bench_{name}.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
           "-o", out, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return name, bind(out, entry), proc.stdout + proc.stderr, out


def bind(path, entry):
    fn = getattr(ctypes.CDLL(path), entry)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def call(fn, q, k, v, mask, causal=False):
    """The forward through ``fn`` (a C entry point), allocating its outputs
    as the port's wrapper does: O, lse, m, l."""
    import torch

    b, h, s, dh = q.shape
    o = torch.empty_like(q)
    lse, m, l = torch.empty((3, b, h, s), device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
             o.data_ptr(), lse.data_ptr(), m.data_ptr(), l.data_ptr(),
             b, h, s, dh, int(causal), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return o, lse, m, l


def loop_counts(rows, scores_per_pass):
    """The key loop of one kernel's SASS: its instructions, those of the
    largest block a forward branch skips inside it that holds no MUFU, no
    matrix product and no load (the per-score checks of a boundary tile),
    and the loop's opcode counts; per score at ``scores_per_pass`` scores a
    thread a pass."""
    loops = [(t, i) for i, (op, _, t) in enumerate(rows)
             if t is not None and t < i]
    if not loops:
        return None

    def ops(a, b):
        return collections.Counter(op.split(".")[0] for op, _, _ in
                                   rows[a:b + 1])

    def ex2(a, b):
        return sum(op.startswith("MUFU.EX2") for op, _, _ in rows[a:b + 1])

    start, end = max(loops, key=lambda r: (ex2(*r), -(r[1] - r[0])))
    skipped = 0
    heavy = ("MUFU", "HGMMA", "HMMA", "LDSM", "LDGSTS", "UTMALDG", "LDG")
    for i in range(start, end):
        op, text, t = rows[i]
        if t is not None and i < t <= end and text.startswith("@"):
            block = ops(i + 1, t - 1)
            if not any(block[h] for h in heavy):
                skipped = max(skipped, t - 1 - i)
    total = end - start + 1
    return {"loop_instructions": total, "checks_block": skipped,
            "per_score": total / scores_per_pass,
            "per_score_unmasked": (total - skipped) / scores_per_pass,
            "loop_opcodes": dict(ops(start, end).most_common())}


def sass_report(name, path, dtype, sass_out=None):
    """Per forward instance of a library (``kernel<template args>``): the
    opcodes the acceptance criteria name, and its key loop's counts;
    logged."""
    report = {}
    for fname, rows in sass_functions(path).items():
        if "flash_fwd" not in fname:
            continue
        kernel = re.search(r"(flash_fwd_\w*?kernel)", fname).group(1)
        args = re.findall(r"L[ib](\d+)E", fname)
        key = f"{kernel}<{','.join(args)}>"
        opcodes = collections.Counter(op.split(".")[0] for op, _, _ in rows)
        entry = {op: opcodes[op] for op in ("HGMMA", "UTMALDG", "HMMA",
                                            "LDSM", "MUFU")}
        entry["instructions"] = len(rows)
        entry["loop"] = loop_counts(rows, scores_per_pass(dtype,
                                                          int(args[0])))
        report[key] = entry
        if sass_out:
            os.makedirs(sass_out, exist_ok=True)
            with open(os.path.join(sass_out, f"{name}_{key}.sass"), "w") as f:
                f.write("\n".join(f"{i:5d} {text}" for i, (_, text, _)
                                  in enumerate(rows)))
        loop = entry["loop"] or {}
        chip_smoke.log(
            f"[sass] {name} {key}: HGMMA {entry['HGMMA']}, UTMALDG "
            f"{entry['UTMALDG']}, HMMA {entry['HMMA']}, LDSM {entry['LDSM']}; "
            f"key loop {loop.get('loop_instructions')} instructions, "
            f"{loop.get('per_score', float('nan')):.2f} per score, "
            f"{loop.get('per_score_unmasked', float('nan')):.2f} without the "
            f"checks block ({loop.get('checks_block')}); loop opcodes "
            f"{loop.get('loop_opcodes')}")
    return report


def inputs(shape, g, masked, dtype):
    import torch

    b, _, s, _ = shape
    q, k, v = (torch.randn(shape, generator=g).to("cuda", dtype)
               for _ in range(3))
    mask = torch.ones(b, s, dtype=torch.bool)
    if masked:
        mask[:, s - s // 5:] = False
    return q, k, v, mask.cuda()


def close(dtype, got, want_o, want_lse):
    """(O and lse within the dtype's bar, max |error|)."""
    import torch

    if dtype == "bfloat16":
        ok, err = chip_smoke.bf16_close(got[0], want_o)
    else:
        ok = torch.allclose(got[0], want_o, **chip_smoke.KERNEL_TOL)
        err = (got[0] - want_o).abs().max().item()
    ok = ok and torch.allclose(got[1], want_lse, **chip_smoke.KERNEL_TOL)
    return ok, max(err, (got[1] - want_lse).abs().max().item())


def bench(builds, card, dtype, turns=2):
    import torch
    import torch.nn.functional as F

    from flexdm_tpu_torch.ops import attention as attn

    torch_dtype = getattr(torch, dtype)
    g = torch.Generator().manual_seed(18)
    results = {}
    for shape, causal in CASES[dtype]:
        for masked in (False, True):
            b, h, s, dh = shape
            q, k, v, mask = inputs(shape, g, masked, torch_dtype)
            bias = attn.key_bias(mask, b, s, q.device)
            want_o = attn.attention_reference(q, k, v, bias, causal)
            want_lse = attn.attention_reference_lse(q, k, bias, causal)
            label = (f"{shape}{' causal' if causal else ''} "
                     f"{'last fifth masked' if masked else 'every key attended'}")
            row = {}
            for name, fn, _, _ in builds:
                got = call(fn, q, k, v, mask, causal)
                again = call(fn, q, k, v, mask, causal)
                ok, err = close(dtype, got, want_o, want_lse)
                chip_smoke.check(ok, f"{name} at {label}: {err}")
                chip_smoke.check(
                    all(torch.equal(x, y) for x, y in zip(got, again)),
                    f"{name}: two calls differ at {label}")
                row[name] = {"max_abs_err": err, "ms": [], "python_ms": []}
            del want_o, want_lse
            for name, fn, _, _ in (builds + builds[::-1]) * max(1, turns // 2):
                run = (lambda fn=fn: call(fn, q, k, v, mask, causal))
                row[name]["ms"].append(chip_smoke.device_ms(run))
                row[name]["python_ms"].append(chip_smoke.time_ms(run))
            plain_ms = chip_smoke.device_ms(
                lambda: attn.attention_reference(q, k, v, bias, causal))
            sdpa_mask = None
            if masked or causal:
                sdpa_mask = bias.to(torch_dtype)[:, None, None, :]
            if causal:
                band = torch.ones(s, s, dtype=torch.bool,
                                  device="cuda").triu(1)
                sdpa_mask = sdpa_mask.expand(b, 1, s, s).masked_fill(
                    band, attn.NEG_INF).contiguous()
            library = (lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=sdpa_mask))
            lib = {"ms": chip_smoke.device_ms(library),
                   "kernels": chip_smoke.sdpa_kernels(library)}
            bd = case_bounds(shape, causal, dtype)
            for name, r in row.items():
                chip_smoke.log(
                    f"[fwd {dtype}] {label} {name}: device ms {r['ms']} "
                    f"(turns), per call from Python "
                    f"{[round(x, 4) for x in r['python_ms']]} ms; max abs "
                    f"err {r['max_abs_err']:.2e} [{card}]")
            med = {name: (statistics.median(r["ms"]),
                          statistics.median(r["python_ms"]))
                   for name, r in row.items()}
            first = builds[0][0]
            chip_smoke.log(
                f"[fwd {dtype}] {label}, medians of the turns: " +
                "; ".join(f"{name} {d:.4f} ms device ({d / med[first][0]:.3f}"
                          f" x {first}), {p:.4f} ms per call from Python "
                          f"({p / med[first][1]:.3f} x {first})"
                          for name, (d, p) in med.items()) + f" [{card}]")
            floors = f"exponential floor {bd['exp_floor_ms']:.4f} ms"
            if "split_floor_ms" in bd:
                floors += (f", split-TF32 tensor floor "
                           f"{bd['split_floor_ms']:.4f} ms")
            chip_smoke.log(
                f"[fwd {dtype}] {label}: plain {plain_ms:.4f} ms; library "
                f"{lib['ms']:.4f} ms ({'no mask' if sdpa_mask is None else 'float mask'}"
                f"; {lib['kernels']}); bound {bd['bound_ms']:.4f} ms "
                f"({bd['bound_by']}), {floors} [{card}]")
            results[label] = {"builds": row, "medians": med,
                              "plain_ms": plain_ms, "library": lib,
                              "bound": bd}
    return results


def bench_eval(builds, card):
    """The crello_flat ``elem`` eval chunk (256 replicas of one test batch,
    4 float32 forwards at (256, 8, 500, 32); random weights, seed 0; one
    synthetic batch) with each build swapped in for the forward, in turns
    (A, B, B, A): from ``torch.profiler`` over 3 chunks the device kernel
    time a chunk and the forward kernel's share of it."""
    import tempfile

    import torch

    from flexdm_tpu_torch.config import TrainConfig, build_model
    from flexdm_tpu_torch.convert import init_params
    from flexdm_tpu_torch.data import DatasetSpec, synthetic
    from flexdm_tpu_torch.evaluation import harness
    from flexdm_tpu_torch.ops import attention as attn

    chunk = chip_smoke.EVAL_BATCH
    with tempfile.TemporaryDirectory() as root:
        data_dir = synthetic.generate("crello", root, 8, 8, chunk, seed=0)
        spec = DatasetSpec("crello", data_dir, chunk)
        batch, weight, _, lengths = next(harness._batches(
            spec.make_dataset("test", batch_size=chunk), "cuda"))
        config = TrainConfig.from_args(chip_smoke.load_args(
            chip_smoke.FLAT_CONFIG, data_dir))
    model = init_params(build_model(config, spec.schema), 0).cuda().eval()
    replicas = torch.from_numpy(harness._elem_replicas(
        lengths, spec.schema.max_length, chunk)[:chunk]).cuda()
    step, _ = harness.make_elem_step(model)
    own = attn._kernel
    results = {name: [] for name, _, _, _ in builds}
    try:
        for name, fn, _, _ in [builds[0], *builds[1:], *builds[1:],
                               builds[0]]:
            attn._kernel = (lambda dt=torch.float32, fn=fn:
                            fn if dt == torch.float32 else own(dt))
            with torch.no_grad():
                step(batch, replicas, weight)
                by_name, kernels = chip_smoke.profile_by_name(
                    lambda: step(batch, replicas, weight), steps=3)
            device = sum(by_name.values())
            fwd = sum(v for k, v in by_name.items() if "flash_fwd" in k)
            results[name].append({"device_ms": device, "fwd_ms": fwd,
                                  "kernels": kernels})
            chip_smoke.log(
                f"[fwd eval] {name}: crello_flat elem, a chunk of {chunk} "
                f"replicas (4 forwards at {chip_smoke.EVAL_FLAT_SHAPE}): "
                f"device kernel time {device:.3f} ms, the forward kernel "
                f"{fwd:.3f} ms ({fwd / device:.1%}), {kernels:.0f} kernels "
                f"[{card}]")
    finally:
        attn._kernel = own
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dtype", default="float32",
                        choices=sorted(ENTRIES))
    parser.add_argument("--other", action="append", default=[],
                        metavar="NAME=PATH.cu",
                        help="another build of the same entry point")
    parser.add_argument("--steps", action="store_true",
                        help="also time the crello_flat step of the dtype")
    parser.add_argument("--eval", action="store_true",
                        help="float32: also profile the crello_flat elem "
                        "eval chunk")
    parser.add_argument("--sass-out", default=None,
                        help="write each instance's SASS here")
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
    source = os.path.join(REPO, "flexdm_tpu_torch", "csrc",
                          SOURCES[args.dtype])
    jobs = [("this", source)] + [tuple(o.split("=", 1)) for o in args.other]
    with ThreadPoolExecutor(len(jobs)) as pool:
        builds = list(pool.map(
            lambda job: build(*job, ENTRIES[args.dtype]), jobs))
    out = {"card": card, "dtype": args.dtype, "ptxas": {}, "sass": {}}
    for name, _, report, path in builds:
        summary = chip_smoke.ptxas_summary(report)
        chip_smoke.log(f"[build] {name}: " + "; ".join(summary))
        out["ptxas"][name] = summary
        out["sass"][name] = sass_report(name, path, args.dtype, args.sass_out)
    out["kernels"] = bench(builds, card, args.dtype, args.turns)
    if args.steps:
        from tools import torch_bwd_bf16_bench

        out["steps"] = torch_bwd_bf16_bench.bench_steps(
            [b[:3] for b in builds], card, attr="_kernel",
            tag=f"fwd {args.dtype} steps", dtype=args.dtype)
    if args.eval and args.dtype == "float32":
        out["eval"] = bench_eval(builds, card)
    chip_smoke.log(json.dumps(out))


if __name__ == "__main__":
    main()
