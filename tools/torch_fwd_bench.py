"""Compare builds of the port's flash-attention forward kernel on one GPU.

    python tools/torch_fwd_bench.py [--other NAME=PATH.cu ...] [--steps]
    python tools/torch_fwd_bench.py --dtype bfloat16 \\
        [--other parent=PATH.cu ...] [--steps] [--sass-out DIR] [--turns N]

float32 (the default): builds ``flexdm_tpu_torch/csrc/flash_attention_fwd.cu``
three times, with 4, 2 and 1 warps per block (64-, 32- and 16-row query
tiles), plus every ``--other`` source that has the same C entry point (an
earlier revision of the file, or a variant of it), one nvcc each, all at
once.  Then:

* checks every build against the plain PyTorch version (O and lse within
  2e-5 abs + 2e-5 rel) at each timed shape;
* times every build at (8, 8, 50, 32), (256, 8, 50, 32) and (8, 8, 650, 32)
  as device time (CUDA graph of 20 calls, median of 50), in turns: each
  build twice, in the order given and then reversed;
* with ``--steps``: the crello Ours-EXP training step at batch 256 (random
  weights, seed 0; one synthetic batch; draws and dropout on the card) with
  the default build and with each ``--other`` build swapped in, in turns
  (A, B, B, A): median of 20 warm steps between CUDA events, and from
  ``torch.profiler`` over 10 steps the device kernel time per step, the
  forward kernel's time per step and the device kernels per step.

bfloat16: builds ``flexdm_tpu_torch/csrc/flash_attention_fwd_bf16.cu`` with
the port's flags (``this``) and every ``--other`` source with the entry
point ``flexdm_flash_attention_fwd_bf16`` (the parent commit's file, say,
unpacked with ``git archive`` under ``build/`` so that its own headers sit
beside it), one nvcc each, all at once, and prints each build's ptxas
report (registers, spills, any C7520 line).  Then:

* from ``cuobjdump -sass`` of each build: which of HGMMA, UTMALDG, HMMA and
  LDSM each instance holds, and the key loop's instructions per score (the
  loop is the backward branch whose body holds the most MUFU.EX2; a thread
  forms 32 scores a pass; the figure without the largest block a forward
  branch skips that holds no MUFU, HGMMA or load is the path of a tile that
  needs no per-score checks), with the loop's opcode counts;
  ``--sass-out DIR`` writes each instance's SASS there;
* at (8, 8, 50, 32), (256, 8, 50, 32), (64, 8, 500, 32),
  (256, 8, 500, 32) and (2048, 8, 50, 64), each with every key attended
  and with the last fifth of the keys masked: checks every build against
  the plain bf16 version (O within one bf16 ulp + 2^-8 max|ref|, lse within
  2e-5 abs + rel, a second call bitwise equal), then times every build in
  turns (the order given, then reversed, ``--turns`` times in all) as
  device time (CUDA graph of 20 calls, median of 50) and per call from
  Python (median of 50 x 20);
  beside them one bf16 ``scaled_dot_product_attention`` call (no mask when
  every key is attended, the additive key bias otherwise) with the kernels
  it ran, the bound of ``chip_smoke.forward_bound`` and its exponential
  floor;
* with ``--steps``: the crello_flat bf16 training step at batch 64 (random
  weights, seed 0; one synthetic batch) with each build swapped in for the
  bf16 forward, in turns (A, B, B, A), as
  ``tools/torch_bwd_bf16_bench.py --steps`` times it.

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
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SHAPES = ((8, 8, 50, 32), (256, 8, 50, 32), (8, 8, 650, 32))
BF16_SHAPES = ((8, 8, 50, 32), (256, 8, 50, 32), (64, 8, 500, 32),
               (256, 8, 500, 32), (2048, 8, 50, 64))
WARPS = (4, 2, 1)
BF16_ENTRY = "flexdm_flash_attention_fwd_bf16"
SCORES_PER_PASS = 32  # a thread's scores per key tile (64 x 64 per 128 lanes)


def build(name, source, flags, entry="flexdm_flash_attention_fwd"):
    """nvcc ``source`` into a library in the build dir; returns ``(name,
    entry point, ptxas report lines, library path)``."""
    from flexdm_tpu_torch.ops import _build

    out = os.path.join(_build.BUILD_DIR, f"libfwd_bench_{name}.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags,
           "-I", str(_build.CSRC_DIR), "-o", out, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return name, bind(out, entry), proc.stdout + proc.stderr, out


def bind(path, entry):
    fn = getattr(ctypes.CDLL(path), entry)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def call(fn, q, k, v, mask):
    """The forward through ``fn`` (a C entry point), allocating its outputs
    as the port's wrapper does: O, lse, m, l."""
    import torch

    b, h, s, dh = q.shape
    o = torch.empty_like(q)
    lse, m, l = torch.empty((3, b, h, s), device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
             o.data_ptr(), lse.data_ptr(), m.data_ptr(), l.data_ptr(),
             b, h, s, dh, 0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return o, lse, m, l


def bench_kernels(builds, card):
    import torch

    from flexdm_tpu_torch.ops import attention as attn

    g = torch.Generator().manual_seed(0)
    results = {}
    for shape in SHAPES:
        b, h, s, dh = shape
        q, k, v = (torch.randn(shape, generator=g).cuda() for _ in range(3))
        mask = torch.ones(b, s, dtype=torch.bool)
        mask[:, s - s // 5:] = False
        mask = mask.cuda()
        bias = attn.key_bias(mask, b, s, q.device)
        want = (attn.attention_reference(q, k, v, bias),
                attn.attention_reference_lse(q, k, bias))
        row = {}
        for name, fn, _, _ in builds:
            o, lse, _, _ = call(fn, q, k, v, mask)
            err = max((o - want[0]).abs().max().item(),
                      (lse - want[1]).abs().max().item())
            chip_smoke.check(
                torch.allclose(o, want[0], **chip_smoke.KERNEL_TOL)
                and torch.allclose(lse, want[1], **chip_smoke.KERNEL_TOL),
                f"{name} differs from plain at {shape}: {err}")
            row[name] = {"max_abs_err": err, "ms": []}
        order = builds + builds[::-1]
        for name, fn, _, _ in order:
            row[name]["ms"].append(chip_smoke.device_ms(
                lambda fn=fn: call(fn, q, k, v, mask)))
        for name, r in row.items():
            print(f"[fwd] {shape} {name}: device ms {r['ms'][0]:.4f}, "
                  f"{r['ms'][1]:.4f} (max abs err {r['max_abs_err']:.2e}) "
                  f"[{card}]", flush=True)
        results[str(shape)] = row
    return results


def device_kernels(prof, steps):
    """(device kernel ms per step, forward kernel ms per step, kernels per
    step) from a profile of ``steps`` steps."""
    import torch

    total = fwd = 0.0
    count = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time", None)
        if us is None:
            us = e.cuda_time
        total += us
        count += 1
        if "flash_fwd" in e.name:
            fwd += us
    return total / 1e3 / steps, fwd / 1e3 / steps, count / steps


def bench_steps(builds, card):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flexdm_tpu_torch.config import TrainConfig, build_model
    from flexdm_tpu_torch.convert import init_params
    from flexdm_tpu_torch.data import DatasetSpec, split_device_batch, \
        synthetic
    from flexdm_tpu_torch.models import make_task_config
    from flexdm_tpu_torch.models.masking import draw_train
    from flexdm_tpu_torch.ops import attention as attn
    from flexdm_tpu_torch.train.optim import KerasAdam
    from flexdm_tpu_torch.train.trainer import make_train_step

    batch_size = chip_smoke.TRAIN_BATCH
    with tempfile.TemporaryDirectory() as root:
        data_dir = synthetic.generate("crello", os.path.join(root, "data"),
                                      batch_size, 4, 4, seed=0)
        spec = DatasetSpec("crello", data_dir, batch_size)
        batch = {k: torch.from_numpy(v).cuda() for k, v in split_device_batch(
            next(iter(spec.make_dataset("train")))).items()}
    with open(os.path.join(REPO, chip_smoke.CONFIG)) as f:
        config = TrainConfig.from_args(dict(json.load(f), data_dir=data_dir))
    task_config = make_task_config(spec.schema, config.masking_method)
    default = attn._kernel
    first, *others = builds
    results = {}
    for name, fn, _, _ in [first, *others, *others, first]:
        attn._kernel = (lambda dtype=None, fn=fn: fn)  # float32 steps
        model = init_params(build_model(config, spec.schema), 0).cuda()
        step = make_train_step(
            model, task_config,
            KerasAdam(model.parameters(), config.learning_rate), config.l2)
        generator = torch.Generator("cuda").manual_seed(0)
        draws = draw_train(spec.schema, batch_size, task_config.task_probs,
                           generator)
        draws.dropout = generator
        for _ in range(20):
            step(batch, draws)
        times = []
        for _ in range(20):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            step(batch, draws)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                step(batch, draws)
            torch.cuda.synchronize()
        device, fwd, kernels = device_kernels(prof, 10)
        step_ms = statistics.median(times)
        r = {"step_ms": step_ms, "min_ms": min(times), "max_ms": max(times),
             "device_ms": device, "fwd_ms": fwd, "kernels": kernels,
             "busy": device / step_ms}
        results.setdefault(name, []).append(r)
        print(f"[step] {name}: step {step_ms:.2f} ms (min {min(times):.2f}, "
              f"max {max(times):.2f}); device kernel time {device:.3f} ms "
              f"per step, forward kernel {fwd:.3f} ms, {kernels:.0f} device "
              f"kernels per step, busy {device / step_ms:.1%} [{card}]",
              flush=True)
    attn._kernel = default
    return results


# ---------------------------------------------------------------------------
# bfloat16
# ---------------------------------------------------------------------------

def sass_functions(path):
    """``{mangled name: [(opcode, text, branch target index)]}`` of every
    function in a library, from ``cuobjdump -sass`` (found beside nvcc)."""
    from flexdm_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    dump = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    functions, current = {}, None
    for line in dump.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            current = functions.setdefault(head.group(1), [])
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if ins and current is not None:
            text = ins.group(2)
            op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]
            current.append((int(ins.group(1), 16), op, text))
    # A branch's target (an absolute address) as an instruction index.
    out = {}
    for name, body in functions.items():
        index = {addr: i for i, (addr, _, _) in enumerate(body)}
        rows = []
        for addr, op, text in body:
            hexa = re.findall(r"0x([0-9a-f]+)", text)
            target = (index.get(int(hexa[-1], 16))
                      if op.split(".")[0] == "BRA" and hexa else None)
            rows.append((op, text, target))
        out[name] = rows
    return out


def loop_counts(rows):
    """The key loop of one kernel's SASS: its instructions, those of the
    largest block a forward branch skips inside it that holds no MUFU, no
    matrix product and no load (the per-score checks of a boundary tile),
    and the loop's opcode counts."""
    loops = [(t, i) for i, (op, _, t) in enumerate(rows)
             if t is not None and t < i]
    if not loops:
        return None

    def ops(a, b):
        return collections.Counter(op.split(".")[0] for op, _, _ in
                                   rows[a:b + 1])

    start, end = max(loops, key=lambda r: (ops(*r)["MUFU"], -(r[1] - r[0])))
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
            "per_score": total / SCORES_PER_PASS,
            "per_score_unmasked": (total - skipped) / SCORES_PER_PASS,
            "loop_opcodes": dict(ops(start, end).most_common())}


def sass_report(name, path, sass_out=None):
    """Per forward instance of a library: the opcodes the acceptance
    criteria name, and its key loop's counts; logged."""
    report = {}
    for fname, rows in sass_functions(path).items():
        if "flash_fwd" not in fname:
            continue
        dh = re.search(r"ILi(\d+)E", fname)
        key = f"Dh={dh.group(1)}" if dh else fname
        opcodes = collections.Counter(op.split(".")[0] for op, _, _ in rows)
        entry = {op: opcodes[op] for op in ("HGMMA", "UTMALDG", "HMMA",
                                            "LDSM", "MUFU")}
        entry["instructions"] = len(rows)
        entry["loop"] = loop_counts(rows)
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


def bf16_inputs(shape, g, masked):
    import torch

    b, _, s, _ = shape
    q, k, v = (torch.randn(shape, generator=g).to("cuda", torch.bfloat16)
               for _ in range(3))
    mask = torch.ones(b, s, dtype=torch.bool)
    if masked:
        mask[:, s - s // 5:] = False
    return q, k, v, mask.cuda()


def bench_bf16(builds, card, turns=2):
    import torch
    import torch.nn.functional as F

    from flexdm_tpu_torch.ops import attention as attn

    g = torch.Generator().manual_seed(18)
    results = {}
    for shape in BF16_SHAPES:
        for masked in (False, True):
            b, h, s, dh = shape
            q, k, v, mask = bf16_inputs(shape, g, masked)
            bias = attn.key_bias(mask, b, s, q.device)
            want_o = attn.attention_reference(q, k, v, bias)
            want_lse = attn.attention_reference_lse(q, k, bias)
            row = {}
            for name, fn, _, _ in builds:
                got = call(fn, q, k, v, mask)
                again = call(fn, q, k, v, mask)
                ok, err = chip_smoke.bf16_close(got[0], want_o)
                chip_smoke.check(ok, f"{name} O at {shape} masked={masked}: "
                                 f"{err}")
                chip_smoke.check(
                    torch.allclose(got[1], want_lse, **chip_smoke.KERNEL_TOL),
                    f"{name} lse at {shape} masked={masked}")
                chip_smoke.check(
                    all(torch.equal(x, y) for x, y in zip(got, again)),
                    f"{name}: two calls differ at {shape} masked={masked}")
                row[name] = {"max_abs_err": err, "ms": [], "python_ms": []}
            del want_o
            for name, fn, _, _ in (builds + builds[::-1]) * (turns // 2):
                run = (lambda fn=fn: call(fn, q, k, v, mask))
                row[name]["ms"].append(chip_smoke.device_ms(run))
                row[name]["python_ms"].append(chip_smoke.time_ms(run))
            sdpa_mask = (bias.to(torch.bfloat16)[:, None, None, :] if masked
                         else None)
            library = (lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=sdpa_mask))
            lib = {"ms": chip_smoke.device_ms(library),
                   "kernels": chip_smoke.sdpa_kernels(library)}
            bd = chip_smoke.forward_bound(shape, 2, chip_smoke.BF16_FLOPS)
            label = "last fifth masked" if masked else "every key attended"
            for name, r in row.items():
                chip_smoke.log(
                    f"[fwd bf16] {shape} {label} {name}: device ms "
                    f"{r['ms']} (turns), per call from Python "
                    f"{[round(x, 4) for x in r['python_ms']]} ms; max abs "
                    f"err {r['max_abs_err']:.2e} [{card}]")
            med = {name: (statistics.median(r["ms"]),
                          statistics.median(r["python_ms"]))
                   for name, r in row.items()}
            first = builds[0][0]
            chip_smoke.log(
                f"[fwd bf16] {shape} {label}, medians of the turns: " +
                "; ".join(f"{name} {d:.4f} ms device ({d / med[first][0]:.3f}"
                          f" x {first}), {p:.4f} ms per call from Python "
                          f"({p / med[first][1]:.3f} x {first})"
                          for name, (d, p) in med.items()) + f" [{card}]")
            chip_smoke.log(
                f"[fwd bf16] {shape} {label}: library {lib['ms']:.4f} ms "
                f"({'additive key bias' if masked else 'no mask'}; "
                f"{lib['kernels']}); bound {bd['bound_ms']:.4f} ms "
                f"({bd['bound_by']}), exponential floor "
                f"{bd['exp_floor_ms']:.4f} ms [{card}]")
            results[f"{shape} {'masked' if masked else 'unmasked'}"] = {
                "builds": row, "library": lib, "bound": bd}
    return results


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--other", action="append", default=[],
                        metavar="NAME=PATH.cu")
    parser.add_argument("--steps", action="store_true")
    parser.add_argument("--sass-out", default=None,
                        help="bfloat16: write each instance's SASS here")
    parser.add_argument("--turns", type=int, default=2,
                        help="bfloat16: times of each build at each shape, "
                        "in pairs (the order given, then reversed)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    others = [other.split("=", 1) for other in args.other]
    if args.dtype == "bfloat16":
        source = os.path.join(REPO, "flexdm_tpu_torch", "csrc",
                              "flash_attention_fwd_bf16.cu")
        with ThreadPoolExecutor(len(others) + 1) as pool:
            builds = list(pool.map(lambda o: build(*o, [], BF16_ENTRY),
                                   [("this", source), *others]))
        out = {"card": card, "ptxas": {}, "sass": {}}
        for name, _, report, path in builds:
            summary = chip_smoke.ptxas_summary(report)
            chip_smoke.log(f"[build] {name}: " + "; ".join(summary))
            out["ptxas"][name] = summary
            out["sass"][name] = sass_report(name, path, args.sass_out)
        out["kernels"] = bench_bf16(builds, card, args.turns)
        if args.steps:
            from tools import torch_bwd_bf16_bench

            out["steps"] = torch_bwd_bf16_bench.bench_steps(
                [b[:3] for b in builds], card, attr="_kernel",
                tag="fwd bf16 steps")
        chip_smoke.log(json.dumps(out))
        return
    source = os.path.join(REPO, "flexdm_tpu_torch", "csrc",
                          "flash_attention_fwd.cu")
    jobs = [(f"w{w}", source, [f"-DFLEXDM_FWD_WARPS={w}"]) for w in WARPS]
    jobs += [(name, path, []) for name, path in others]
    with ThreadPoolExecutor(len(jobs)) as pool:
        builds = list(pool.map(lambda job: build(*job), jobs))
    for name, _, report, _ in builds:
        registers = [line.strip() for line in report.splitlines()
                     if "registers" in line]
        print(f"[build] {name}: {'; '.join(registers)}", flush=True)
    out = {"card": card, "kernels": bench_kernels(builds, card)}
    if args.steps:
        step_builds = [builds[0]] + builds[len(WARPS):]
        out["steps"] = bench_steps(step_builds, card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
