"""Static hazard check of the port's Hopper kernels, read from their SASS.

    python tools/torch_sass_hazards.py [--other NAME=PATH.cu ...]
        [--sass NAME=DUMP ...] [--ptxas NAME=REPORT ...]

With no ``--sass``, builds the port's four kernel libraries
(``ops/attention.py`` ``LIBRARIES``) as the port builds them, and every
``--other`` source with ``-I flexdm_tpu_torch/csrc`` (e.g. the parent
commit's ``csrc/`` unpacked with ``git archive`` under ``build/``), one
nvcc each, all at once (a card machine: nvcc and cuobjdump), and reads
each library's ``cuobjdump -sass``.  ``--sass NAME=DUMP`` reads a saved
dump instead (any machine; ``--ptxas NAME=REPORT`` adds its ptxas ``-v``
report for the registers and spills).

Per kernel instance (``kernel<template args>``) it follows every path of
the SASS, loop back-edges and calls included, tracking which warpgroup
products are in flight, and reports:

* ``operand``: an instruction other than the product chain itself that
  writes a register an issued HGMMA reads as its A operand, or writes or
  reads one of its accumulators, before the ``WARPGROUP.DEPBAR.LE gsb0, N``
  that retires the HGMMA's group.  A group is the HGMMAs up to one marked
  ``gsb0`` (a ``wgmma.commit_group``); ``DEPBAR.LE gsb0, N`` retires all
  but the newest N groups.  An HGMMA that accumulates into the same
  registers as an issued one is its chain, not a hazard; one whose A
  operand or accumulators overlap an issued one's otherwise is.
* ``tma``: a TMA copy into shared memory (``UTMALDG``) issued while a
  shared-memory load (``LDS``, ``LDSM``) may still be in flight: of the
  issuing warp, or of the warps that met it at the last block barrier
  (``BAR.SYNC``; they ran the same code to it, so what the issuing warp
  had in flight there stands for theirs, and its own later waits do not
  cover them).  In flight: its write scoreboard (the instruction's control
  bits) not yet waited on, and no proxy fence (``FENCE.VIEW.ASYNC``)
  since.  The copy writes through the async proxy, which neither a
  barrier nor program order keeps behind those loads, so it may overwrite
  what they have yet to read (PTX: ``fence.proxy.async``).  The check does
  not compare addresses: a load of another buffer is reported too.  A
  release through an mbarrier (the bf16 kernels' consumers hand a stage
  back to the producer warp with ``SYNCS.ARRIVE``) is not followed: their
  loads in flight there read row statistics the producer rewrites with
  generic stores, ordered by the barrier, and their TMA tiles they read
  only through HGMMA.
* ``undecided``: an opcode whose writes the check does not know touching
  a register in flight, an indirect branch, or more than ``MAX_GROUPS``
  groups or ``MAX_STATES`` states at one instruction: each is counted as a
  hazard.

Prints one line per instance (registers and spill bytes from ptxas,
HGMMAs, groups, hazards) with each hazard's SASS lines under it and, last,
one JSON object; exits 1 if any instance has a hazard.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MAX_GROUPS = 8
MAX_STATES = 512

# Opcodes (the part before the first dot) that write no general register.
NO_DEST = frozenset((
    "ST", "STS", "STG", "STL", "STAS", "RED", "REDG", "REDAS", "BAR", "BRA",
    "BRX", "JMP", "JMX", "EXIT", "RET", "CALL", "NOP", "YIELD", "WARPSYNC",
    "BSSY", "BSYNC", "BREAK", "BPT", "MEMBAR", "FENCE", "ERRBAR", "CCTL",
    "WARPGROUP", "ENDCOLLECTIVE", "DEPBAR", "KILL", "NANOSLEEP", "ISETP",
    "FSETP", "PLOP3", "PSETP", "DSETP", "HSETP2", "ELECT", "R2UR", "S2UR",
    "VOTEU", "R2P"))
# Opcodes whose first operand is the register they write.
FIRST_DEST = frozenset((
    "IMAD", "VIADD", "LOP3", "FADD", "LEA", "IADD3", "FFMA", "FMUL", "SHF",
    "LDS", "LDSM", "CS2R", "MOV", "F2FP", "IABS", "LDC", "FMNMX", "LDG",
    "SEL", "PRMT", "LDL", "LD", "I2F", "F2I", "F2F", "S2R", "VIMNMX", "P2R",
    "VIADDMNMX", "I2FP", "MUFU", "FSEL", "VOTE", "IMNMX", "IADD", "IMUL",
    "FLO", "POPC", "BREV", "BMSK", "SGXT", "FRND", "FCHK", "ATOM", "ATOMS",
    "ATOMG", "HADD2", "HMUL2", "HFMA2", "HMNMX2", "DADD", "DMUL", "DFMA",
    "LEPC", "SYNCS", "F2IP", "I2IP", "IDP", "IDP4A"))
SHARED_LOADS = frozenset(("LDS", "LDSM"))
NO_SCOREBOARD = 7

_REG = re.compile(r"\bR(\d+)(\.64)?\b")


class Instr(NamedTuple):
    addr: int
    op: str  # opcode with modifiers, no predicate
    text: str  # the instruction as printed, predicate included
    target: Optional[int]  # branch or call target, as an instruction index
    pred: str  # guarding predicate ("" when none)
    args: Tuple[str, ...]  # operands
    ctrl: Optional[int]  # control bits (bits 105.. of the encoding)


def _operands(rest: str) -> Tuple[str, ...]:
    out, depth, cur = [], 0, ""
    for ch in rest:
        if ch in "[(":
            depth += 1
        elif ch in "])":
            depth -= 1
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        out.append(cur.strip())
    return tuple(out)


def parse_sass(dump: str) -> Dict[str, List[Instr]]:
    """``{mangled name: [Instr]}`` of every function in a ``cuobjdump
    -sass`` listing."""
    raw: Dict[str, list] = {}
    current = None
    pending = None  # the last instruction, waiting for its encoding's high word
    for line in dump.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            current = raw.setdefault(head.group(1), [])
            pending = None
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if ins and current is not None:
            pending = [int(ins.group(1), 16), ins.group(2), None]
            current.append(pending)
            continue
        high = re.match(r"\s*/\* (0x[0-9a-f]+) \*/\s*$", line)
        if high and pending is not None and pending[2] is None:
            pending[2] = int(high.group(1), 16) >> 41
    functions = {}
    for name, body in raw.items():
        index = {addr: i for i, (addr, _, _) in enumerate(body)}
        rows = []
        for addr, text, ctrl in body:
            pred_m = re.match(r"(@!?U?P[T0-9]+)\s+", text)
            pred = pred_m.group(1) if pred_m else ""
            rest = text[pred_m.end():] if pred_m else text
            op, _, operands = rest.partition(" ")
            target = None
            if op.split(".")[0] in ("BRA", "CALL"):
                hexa = re.findall(r"0x([0-9a-f]+)", operands)
                if hexa:
                    target = index.get(int(hexa[-1], 16))
            rows.append(Instr(addr, op, text, target, pred,
                              _operands(operands), ctrl))
        functions[name] = rows
    return functions


def cuobjdump_sass(path) -> str:
    """``cuobjdump -sass`` of a library (cuobjdump beside nvcc)."""
    from flexdm_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout


def sass_functions(path):
    """``{mangled name: [(opcode, text, branch target index)]}`` of every
    function in a library, from ``cuobjdump -sass`` (found beside nvcc)."""
    return {name: [(i.op, i.text, i.target) for i in rows]
            for name, rows in parse_sass(cuobjdump_sass(path)).items()}


def instance_name(mangled: str) -> str:
    """``kernel<template args>`` of a mangled kernel name."""
    base = mangled
    for m in re.finditer(r"\d+(?=[A-Za-z_])", mangled):
        for k in range(m.start(), m.end()):  # every suffix of the digits
            word = mangled[m.end():m.end() + int(mangled[k:m.end()])]
            if word.endswith("_kernel") and len(word) == int(
                    mangled[k:m.end()]):
                base = word
    args = re.findall(r"L[ib](\d+)E", mangled)
    return f"{base}<{','.join(args)}>" if args else base


# ---------------------------------------------------------------------------
# Registers an instruction reads and writes
# ---------------------------------------------------------------------------

def _regs(operand: str) -> set:
    out = set()
    for m in _REG.finditer(operand):
        r = int(m.group(1))
        out.update((r, r + 1) if m.group(2) else (r,))
    return out


def _dest_width(op: str) -> int:
    base, *mods = op.split(".")
    if base == "LDSM":
        return int(mods[-1]) if mods and mods[-1] in ("1", "2", "4") else 4
    if base == "CS2R":
        return 1 if "32" in mods else 2
    if "128" in mods:
        return 4
    if "64" in mods or "WIDE" in mods or "F64" in mods[:1]:
        return 2
    return 2 if base in ("DADD", "DMUL", "DFMA") else 1


def writes_reads(ins: Instr) -> Tuple[set, set, bool]:
    """(registers written, registers read, undecided) of a non-HGMMA
    instruction; an opcode the check does not know counts as writing every
    register it names."""
    base = ins.op.split(".")[0]
    args = ins.args
    all_regs = set().union(*map(_regs, args)) if args else set()
    if base in NO_DEST or base.startswith("U"):
        return set(), all_regs, False
    if base == "SHFL":
        dest_i = 1
    elif base in FIRST_DEST:
        dest_i = 0
    else:
        return all_regs, all_regs, True
    if len(args) <= dest_i:
        return set(), all_regs, False
    m = re.fullmatch(r"R(\d+)(\.\w+)*", args[dest_i])
    reads = set().union(*(_regs(a) for i, a in enumerate(args) if i != dest_i))
    if not m:
        return set(), reads | _regs(args[dest_i]), False
    first = int(m.group(1))
    return set(range(first, first + _dest_width(ins.op))), reads, False


_NOTHING = (frozenset(), frozenset(), False)


class Product(NamedTuple):
    a: frozenset  # A operand registers (empty: A from shared memory)
    acc: frozenset  # accumulator registers
    acc_first: int
    commit: bool  # closes a group (gsb0)


def parse_hgmma(ins: Instr) -> Product:
    """The registers of one HGMMA: ``HGMMA.64xNxK.<acc>.<type> Rd, [Ra,]
    gdesc[..], Rc|RZ[, !UPT][, gsb0]``."""
    shape = re.match(r"HGMMA\.64x(\d+)x\d+\.(\w+)", ins.op)
    n, acc_type = int(shape.group(1)), shape.group(2)
    per_thread = n // 2 if acc_type == "F32" or acc_type == "S32" else n // 4
    d = int(re.fullmatch(r"R(\d+)", ins.args[0]).group(1))
    a = frozenset()
    a_m = re.fullmatch(r"R(\d+)", ins.args[1]) if len(ins.args) > 1 else None
    if a_m:
        a = frozenset(range(int(a_m.group(1)), int(a_m.group(1)) + 4))
    return Product(a, frozenset(range(d, d + per_thread)), d,
                   "gsb0" in ins.args)


# ---------------------------------------------------------------------------
# The walk
# ---------------------------------------------------------------------------

class Hazard(NamedTuple):
    kind: str  # "operand", "tma" or "undecided"
    at: int  # instruction index of the offending instruction
    product: Optional[int]  # instruction index of the HGMMA (or load)
    regs: Tuple[int, ...]
    why: str


def _successors(rows: List[Instr], i: int) -> List[int]:
    ins = rows[i]
    base = ins.op.split(".")[0]
    conditional = ins.pred not in ("", "@PT")
    out = []
    if base in ("EXIT", "RET", "BRX", "JMX"):
        return [i + 1] if conditional and i + 1 < len(rows) else []
    if base in ("BRA", "CALL"):
        if ins.target is not None:
            out.append(ins.target)
        falls = conditional or base == "CALL" or ".DIV" in ins.op
        if falls and i + 1 < len(rows):
            out.append(i + 1)
        return out
    return [i + 1] if i + 1 < len(rows) else []


def check_function(rows: List[Instr]) -> Tuple[List[Hazard], dict]:
    """Hazards of one function's SASS, and counts (HGMMAs, groups)."""
    products = {i: parse_hgmma(ins) for i, ins in enumerate(rows)
                if ins.op.startswith("HGMMA")}
    hazards: Dict[tuple, Hazard] = {}
    effects: Dict[int, tuple] = {}  # writes_reads of the instructions met

    def report(h: Hazard):  # one a faulty instruction and kind
        hazards.setdefault((h.kind, h.at), h)

    # A state: (closed groups oldest first, the open group, the warp's
    # shared loads in flight as (write scoreboard, load index), and those in
    # flight at the last block barrier it passed).  The other warps of a
    # barrier ran the same code to it, so what this warp had in flight there
    # stands for theirs, which no later wait of this warp covers.
    start = ((), frozenset(), frozenset(), frozenset())
    seen: Dict[int, set] = {0: {start}} if rows else {}
    work = [(0, start)] if rows else []
    while work:
        i, (closed, open_, loads, at_bar) = work.pop()
        ins = rows[i]
        base = ins.op.split(".")[0]
        pending = [p for g in closed for p in g] + list(open_)
        ctrl = ins.ctrl
        if ctrl is not None and loads:
            wait = (ctrl >> 11) & 0x3F
            loads = frozenset((sb, at) for sb, at in loads
                              if not wait >> sb & 1)
        if i in products:
            me = products[i]
            for j in pending:
                other = products[j]
                chain = other.acc == me.acc and other.acc_first == me.acc_first
                bad = (me.a & other.acc) | (me.acc & other.a)
                if not chain:
                    bad |= me.acc & other.acc
                if bad:
                    report(Hazard("operand", i, j, tuple(sorted(bad)),
                                  "HGMMA operands overlap an issued HGMMA's"))
            open_ = open_ | {i}
            if me.commit:
                closed, open_ = closed + (open_,), frozenset()
        elif ins.op.startswith("WARPGROUP.DEPBAR"):
            n = re.search(r"gsb0,\s*(0x[0-9a-f]+|\d+)", ins.text)
            keep = int(n.group(1), 0) if n else 0
            closed = closed[max(0, len(closed) - keep):] if keep else ()
        else:
            if pending and i not in effects:
                effects[i] = writes_reads(ins)
            written, read, undecided = effects.get(i, _NOTHING)
            for j in pending:
                p = products[j]
                bad_w = written & (p.a | p.acc)
                bad_r = read & p.acc
                if bad_w or bad_r:
                    kind = "undecided" if undecided else "operand"
                    what = ("writes" if bad_w else "reads")
                    part = ("A operand" if bad_w & p.a else "accumulators")
                    report(Hazard(kind, i, j, tuple(sorted(bad_w | bad_r)),
                                  f"{what} the {part} of an HGMMA in flight"))
            if base in ("BRX", "JMX") and (pending or loads):
                report(Hazard("undecided", i, None, (),
                              "indirect branch with work in flight"))
            if base == "UTMALDG":
                for sb, at in sorted(loads | at_bar):
                    whose = ("of this warp" if (sb, at) in loads
                             else "of the warps at the last barrier")
                    report(Hazard("tma", i, at, (),
                                  f"TMA copy into shared memory with a "
                                  f"shared load {whose} in flight "
                                  f"(scoreboard {sb}), no proxy fence"))
            if base == "FENCE" and "ASYNC" in ins.op:
                loads = frozenset()
            if base == "BAR" and ".ARV" not in ins.op:
                at_bar = loads
            if base in SHARED_LOADS and ctrl is not None:
                sb = (ctrl >> 5) & 7
                if sb != NO_SCOREBOARD:
                    loads = loads | {(sb, i)}
        if len(closed) > MAX_GROUPS:
            report(Hazard("undecided", i, None, (),
                          f"more than {MAX_GROUPS} groups in flight"))
            continue
        state = (closed, open_, loads, at_bar)
        for s in _successors(rows, i):
            states = seen.setdefault(s, set())
            if state in states:
                continue
            if len(states) >= MAX_STATES:
                report(Hazard("undecided", s, None, (),
                              f"more than {MAX_STATES} states"))
                continue
            states.add(state)
            work.append((s, state))
    groups = sum(p.commit for p in products.values())
    return (sorted(hazards.values(), key=lambda h: (h.at, h.kind)),
            {"hgmma": len(products), "groups": groups})


def ptxas_instances(report: str) -> Dict[str, dict]:
    """``{kernel<args>: {"registers": N, "spill_bytes": S}}`` from a ptxas
    ``-v`` report (spills: the larger of stores and loads)."""
    out, name, spill = {}, None, 0
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+?)'", line)
        if entry:
            name, spill = instance_name(entry.group(1)), 0
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        if spills:
            spill = max(map(int, spills.groups()))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            out[name] = {"registers": int(regs.group(1)),
                         "spill_bytes": spill}
            name = None
    return out


def check_dump(dump: str, ptxas: str = "") -> Dict[str, dict]:
    """Per kernel instance of a ``cuobjdump -sass`` listing: registers and
    spill bytes (from ``ptxas``, when given), HGMMAs, groups, and its
    hazards as printable lines."""
    regs = ptxas_instances(ptxas)
    out = {}
    for mangled, rows in parse_sass(dump).items():
        if not mangled.startswith("_Z") or "_kernel" not in mangled:
            continue
        name = instance_name(mangled)
        found, counts = check_function(rows)
        out[name] = dict(regs.get(name, {"registers": None,
                                         "spill_bytes": None}),
                         **counts, hazards=len(found),
                         lines=[describe(rows, h) for h in found])
    return out


def check_dumps(jobs: Dict[str, Tuple[str, str]]) -> Dict[str, dict]:
    """``check_dump`` of each ``{name: (dump, ptxas report)}``, one process
    a listing, all at once: ``{name: report}``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(
            len(jobs), mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {name: pool.submit(check_dump, *job)
                   for name, job in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


def describe(rows: List[Instr], h: Hazard) -> str:
    at = rows[h.at]
    text = f"{h.kind}: /*{at.addr:04x}*/ {at.text}: {h.why}"
    if h.product is not None:
        p = rows[h.product]
        text += f" (/*{p.addr:04x}*/ {p.text})"
    if h.regs:
        text += " [" + ", ".join(f"R{r}" for r in h.regs) + "]"
    return text


def log_report(label: str, report: Dict[str, dict], log=print) -> int:
    """One line per instance, each hazard's under it; returns the hazards
    in all."""
    total = 0
    for name, r in sorted(report.items()):
        total += r["hazards"]
        regs, spill = (("?" if r[k] is None else r[k])
                       for k in ("registers", "spill_bytes"))
        log(f"[hazards] {label} {name}: {regs} registers, "
            f"{spill} bytes spilled, {r['hgmma']} HGMMA in "
            f"{r['groups']} groups, {r['hazards']} hazards")
        for line in r["lines"]:
            log(f"[hazards]   {line}")
    return total


# ---------------------------------------------------------------------------
# Builds
# ---------------------------------------------------------------------------

def build_other(name: str, source: str) -> Tuple[str, str]:
    """nvcc of ``source`` (headers from ``flexdm_tpu_torch/csrc`` after its
    own directory) into the build dir: (library path, ptxas report)."""
    from flexdm_tpu_torch.ops import _build

    path = os.path.join(_build.BUILD_DIR, f"libhazards_{name}.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
           os.path.dirname(os.path.abspath(source)), "-I",
           str(_build.CSRC_DIR), "-o", path, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return path, proc.stdout + proc.stderr


def check_libraries(others=(), log=print) -> Dict[str, dict]:
    """Builds the port's kernel libraries and the ``others`` ((name,
    source) pairs), one nvcc each, all at once, and checks each: ``{library
    name: {instance: report}}``."""
    from flexdm_tpu_torch.ops import _build
    from flexdm_tpu_torch.ops import attention as attn

    def one(job):
        kind, name, arg = job
        if kind == "port":
            path = _build.build_library(*arg)
            report = _build.BUILD_LOGS.get(name, "")
        else:
            path, report = build_other(name, arg)
        return name, (cuobjdump_sass(path), report)

    jobs = ([("port", lib[0], lib) for lib in attn.LIBRARIES]
            + [("other", name, src) for name, src in others])
    with ThreadPoolExecutor(len(jobs)) as pool:
        results = check_dumps(dict(pool.map(one, jobs)))
    for name, report in results.items():
        log_report(name, report, log)
    return results


def _pairs(values, flag, parser):
    out = []
    for v in values:
        if "=" not in v:
            parser.error(f"{flag} takes NAME=PATH, got {v!r}")
        out.append(tuple(v.split("=", 1)))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", action="append", default=[],
                        metavar="NAME=PATH.cu",
                        help="another source to build and check")
    parser.add_argument("--sass", action="append", default=[],
                        metavar="NAME=DUMP",
                        help="a saved cuobjdump -sass listing to check "
                             "(nothing is built)")
    parser.add_argument("--ptxas", action="append", default=[],
                        metavar="NAME=REPORT",
                        help="the ptxas -v report of a --sass listing")
    args = parser.parse_args(argv)
    others = _pairs(args.other, "--other", parser)
    dumps = _pairs(args.sass, "--sass", parser)
    reports = dict(_pairs(args.ptxas, "--ptxas", parser))
    if dumps:
        jobs = {}
        for name, path in dumps:
            ptxas = ""
            if name in reports:
                with open(reports[name]) as f:
                    ptxas = f.read()
            with open(path) as f:
                jobs[name] = (f.read(), ptxas)
        results = check_dumps(jobs)
        for name, report in results.items():
            log_report(name, report)
    else:
        sys.path.insert(0, REPO)
        results = check_libraries(others)
    total = sum(r["hazards"] for lib in results.values()
                for r in lib.values())
    print(json.dumps({"hazards": total, "libraries": {
        lib: {name: {k: v for k, v in r.items() if k != "lines"}
              for name, r in rep.items()}
        for lib, rep in results.items()}}))
    return 1 if total else 0


if __name__ == "__main__":
    sys.exit(main())
