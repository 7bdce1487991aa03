"""The static hazard check of tools/torch_sass_hazards.py on SASS excerpts.

The excerpts are in ``cuobjdump -sass``'s own format, lines of the card's
dump of the parent commit's ``flash_bwd_dq_kernel<32,2,0>`` (sm_90a, CUDA
12.9) with their encodings; where a case needs an instruction the dump does
not have at that place, a line of the same dump is moved there with its
registers edited (named beside each case).  No nvcc, cuobjdump or card is
needed.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools import torch_sass_hazards as hz  # noqa: E402

NAME = ("_ZN55_GLOBAL__N__4224ddb5_22_flash_attention_bwd_cu_175866de19"
        "flash_bwd_dq_kernelILi32ELi2ELb0EEEv14CUtensorMap_stS1_S1_S1_PKhPKf"
        "S5_S5_S5_PfS6_iiifi")

# One line of the dump: its text and its encoding's two words.
LINES = {
    "arrive": ("WARPGROUP.ARRIVE", "0x00000000000079c5", "0x000fe20000000000"),
    "sc_first": ("HGMMA.64x32x8.F32.TF32 R40, R108, gdesc[UR4], RZ, !UPT",
                 "0x046000046c287df0", "0x000fe2000c7028ff"),
    "sc_last": ("HGMMA.64x32x8.F32.TF32 R40, R72, gdesc[UR4], R40, gsb0",
                "0x0460000448287df0", "0x000fe20008002828"),
    "dp_first": ("HGMMA.64x32x8.F32.TF32 R24, R116, gdesc[UR8], RZ, !UPT",
                 "0x0460000874187df0", "0x000fe2000c7028ff"),
    "dp_last": ("HGMMA.64x32x8.F32.TF32 R24, R96, gdesc[UR8], R24, gsb0",
                "0x0460000860187df0", "0x000fe20008002818"),
    "bar_arv": ("BAR.ARV R122, 0x100", "0x0004007a0000751d",
                "0x0001ec0000002000"),
    "wait1": ("WARPGROUP.DEPBAR.LE gsb0, 0x1", "0x00008000000079c5",
              "0x000fe40000010100"),
    "lds64": ("LDS.64 R120, [R126]", "0x000000007e787984",
              "0x000e640000000a00"),
    "wait0": ("WARPGROUP.DEPBAR.LE gsb0, 0x0", "0x00008000000079c5",
              "0x000fe40000010000"),
    "fadd_acc": ("FADD R25, -R7.reuse, R25", "0x0000001907197221",
                 "0x040fe20000000100"),
    "fmul_acc": ("FMUL R122, R25, R122", "0x0000007a197a7220",
                 "0x000fe20000400000"),
    # LDL R137, [R1+0xc] of the dump (/*2fb0*/), its destination edited.
    "ldl_dp_a": ("LDL R116, [R1+0xc]", "0x00000c0001897983",
                 "0x000ea80000100800"),
    "ldl_sc_a": ("LDL R108, [R1+0xc]", "0x00000c0001897983",
                 "0x000ea80000100800"),
    "ldl_dp_a2": ("LDL R97, [R1+0xc]", "0x00000c0001897983",
                  "0x000ea80000100800"),
    "lds_frag": ("LDS R85, [R22+0x6000]", "0x0060000016557984",
                 "0x0004220000000800"),
    "bar_sync": ("BAR.SYNC.DEFER_BLOCKING R0, 0x80", "0x000200000000751d",
                 "0x0005ec0000010000"),
    "iabs_wait_sb0": ("IABS R19, R151", "0x0000009700137213",
                      "0x001fe20000000000"),
    "utmaldg": ("UTMALDG.3D [UR8], [UR14]", "0x000000080e0075b4",
                "0x0001e40008010000"),
    "bsync": ("BSYNC B0", "0x0000000000007941", "0x000fea0003800000"),
    # This PR's build of the same instance: the fence before the barrier,
    # which then waits on the fence's scoreboard.
    "membar": ("MEMBAR.ALL.CTA", "0x0000000000007992", "0x000bec0000008000"),
    "fence": ("FENCE.VIEW.ASYNC.S", "0x00000000000073c6",
              "0x020f620000000000"),
    "bar_sync_fenced": ("BAR.SYNC.DEFER_BLOCKING R0, 0x80",
                        "0x000200000000751d", "0x0205e80000010000"),
    "exit": ("EXIT", "0x000000000000794d", "0x000fea0003800000"),
    # The trap a wait that never ends runs (mbar_wait, csrc/hopper.cuh), as
    # ptxas places it after the function's last EXIT (this PR's build of
    # flash_bwd_dq_wide_kernel<0>, /*dc50*/).
    "trap": ("BPT.TRAP 0x1", "0x000000040000795c", "0x000fea0003800000"),
}


def listing(*rows, name=NAME):
    """A cuobjdump listing of one function: ``rows`` are LINES keys or
    (text, low word, high word) tuples; branch rows are ("BRA", index,
    predicate), to the row at that index."""
    out = [f"\t\tFunction : {name}",
           '\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS '
           'EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"']
    for i, row in enumerate(rows):
        if isinstance(row, tuple) and row[0] == "BRA":
            pred = row[2] + " " if row[2] else ""
            text, lo, hi = (f"{pred}BRA {16 * row[1]:#x}", "0x0000000000fc0947",
                            "0x000fea0003800000")
        else:
            text, lo, hi = LINES[row] if isinstance(row, str) else row
        out.append(f"        /*{16 * i:04x}*/                   {text} ;"
                   f"{' ' * 20}/* {lo} */")
        out.append(f"{' ' * 95}/* {hi} */")
    return "\n".join(out) + "\n"


def hazards(dump):
    (rows,) = hz.parse_sass(dump).values()
    found, _ = hz.check_function(rows)
    return [(h.kind, rows[h.at].text, rows[h.product].text if h.product
             is not None else None, h.regs) for h in found]


SCORES = ("arrive", "sc_first", "sc_last", "dp_first", "dp_last", "bar_arv")


def test_reload_of_an_a_operand_before_its_wait_is_flagged():
    # dp's group still reads R116 (its first k8 step's lo fragment) after
    # DEPBAR.LE 1 retired only sc's.
    got = hazards(listing(*SCORES, "wait1", "lds64", "ldl_dp_a", "wait0",
                          "fadd_acc", "exit"))
    assert got == [("operand", "LDL R116, [R1+0xc]",
                    LINES["dp_first"][0], (116,))]


def test_the_same_reload_after_the_wait_is_clean():
    assert hazards(listing(*SCORES, "wait1", "lds64", "wait0", "ldl_dp_a",
                           "fadd_acc", "exit")) == []


def test_wait_le_1_retires_the_older_group_only():
    # Between DEPBAR.LE gsb0, 0x1 and DEPBAR.LE gsb0, 0x0: sc's operand R108
    # is free, dp's R97 (its last k8 step's hi fragment, R96..R99) is not.
    assert hazards(listing(*SCORES, "wait1", "ldl_sc_a", "wait0",
                           "exit")) == []
    got = hazards(listing(*SCORES, "wait1", "ldl_dp_a2", "wait0", "exit"))
    assert got == [("operand", "LDL R97, [R1+0xc]", LINES["dp_last"][0],
                    (97,))]
    # Before either wait both groups are in flight.
    got = hazards(listing(*SCORES, "ldl_sc_a", "wait0", "exit"))
    assert [g[:3] for g in got] == [("operand", "LDL R108, [R1+0xc]",
                                     LINES["sc_first"][0])]


def test_an_accumulator_written_or_read_before_its_wait_is_flagged():
    got = hazards(listing(*SCORES, "wait1", "fadd_acc", "wait0", "exit"))
    assert got == [("operand", LINES["fadd_acc"][0], LINES["dp_first"][0],
                    (25,))]
    got = hazards(listing(*SCORES, "wait1", "fmul_acc", "wait0", "exit"))
    assert [g[:2] for g in got] == [("operand", LINES["fmul_acc"][0])]
    # sc's accumulators are free after DEPBAR.LE 1.
    free = ("FFMA R41, R41, R10.reuse, R121.reuse", "0x0000000a29297223",
            "0x180fe20000000079")
    assert hazards(listing(*SCORES, "wait1", free, "wait0", "exit")) == []


def test_a_hazard_across_a_loop_back_edge_is_flagged():
    # The loop's first instruction reloads dp's A operand, then waits: the
    # group issued at the bottom of one iteration is still in flight at the
    # top of the next.
    loop = ("ldl_dp_a", "wait0", "arrive", "dp_first", "dp_last",
            ("BRA", 0, "@P0"), "wait0", "exit")
    got = hazards(listing(*loop))
    assert got == [("operand", "LDL R116, [R1+0xc]", LINES["dp_first"][0],
                    (116,))]
    # The wait before the reload: clean.
    assert hazards(listing("wait0", "ldl_dp_a", "arrive", "dp_first",
                           "dp_last", ("BRA", 0, "@P0"), "wait0",
                           "exit")) == []
    # No wait inside the loop: groups pile up without bound, undecided.
    got = hazards(listing("arrive", "dp_first", "dp_last", ("BRA", 0, "@P0"),
                          "wait0", "exit"))
    assert [g[0] for g in got] == ["undecided"]


def test_a_trap_ends_its_path():
    # A wait with products in flight may branch to its trap; the trap sits
    # after the last EXIT, and the code that follows it (here an
    # accumulator write, as another warpgroup's code is there) is not on
    # that path.
    trap_at = len(SCORES) + 4
    got = hazards(listing(*SCORES, ("BRA", trap_at, "@!P0"), "wait1",
                          "wait0", "exit", "trap", "fadd_acc", "exit"))
    assert got == []
    # Without the trap the same branch lands on the write with dp in
    # flight.
    got = hazards(listing(*SCORES, ("BRA", trap_at, "@!P0"), "wait1",
                          "wait0", "exit", "fadd_acc", "exit"))
    assert [g[:3] for g in got] == [("operand", LINES["fadd_acc"][0],
                                     LINES["dp_first"][0])]


def test_an_hgmma_chain_is_not_a_hazard_but_an_overlap_is():
    assert hazards(listing("arrive", "dp_first", "dp_last", "wait0",
                           "exit")) == []
    # An HGMMA reading R24.. as its A operand while one accumulating into
    # R24.. is in flight (sc's first line, its A operand edited).
    reads_acc = ("HGMMA.64x32x8.F32.TF32 R40, R24, gdesc[UR4], RZ, !UPT, "
                 "gsb0", "0x046000046c287df0", "0x000fe2000c7028ff")
    got = hazards(listing("arrive", "dp_first", reads_acc, "wait0", "exit"))
    assert [g[:3] for g in got] == [("operand", reads_acc[0],
                                     LINES["dp_first"][0])]


def test_a_tma_copy_after_the_barrier_over_loads_in_flight_is_flagged():
    # The parent: the fragments' LDS (write scoreboard 0), the barrier
    # waiting on nothing, the issuing warp waiting on scoreboard 0 before
    # its copy; the other warps skip the copy with their loads in flight.
    parent = listing("lds_frag", "bar_sync", ("BRA", 5, "@P0"),
                     "iabs_wait_sb0", "utmaldg", "bsync", "exit")
    got = hazards(parent)
    assert got == [("tma", LINES["utmaldg"][0], LINES["lds_frag"][0], ())]
    # Without the barrier the issuing warp's own wait covers the loads.
    assert hazards(listing("lds_frag", "iabs_wait_sb0", "utmaldg",
                           "exit")) == []
    # Nor its own wait: the copy right after the loads.
    got = hazards(listing("lds_frag", "utmaldg", "exit"))
    assert [g[:3] for g in got] == [("tma", LINES["utmaldg"][0],
                                     LINES["lds_frag"][0])]


def test_the_proxy_fence_before_the_barrier_is_clean():
    fixed = listing("lds_frag", "membar", "fence", "bar_sync_fenced",
                    ("BRA", 7, "@P0"), "iabs_wait_sb0", "utmaldg", "bsync",
                    "exit")
    assert hazards(fixed) == []


def test_an_unknown_opcode_on_a_register_in_flight_counts_as_a_hazard():
    # An opcode the check does not know (no such line in the dump).
    unknown = ("QFOO R116, R3", "0x0000000003747000", "0x000fe20000000000")
    got = hazards(listing("arrive", "dp_first", "dp_last", unknown, "wait0",
                          "exit"))
    assert [g[0] for g in got] == ["undecided"]


def test_instances_registers_spills_and_the_cli(tmp_path, capsys):
    assert hz.instance_name(NAME) == "flash_bwd_dq_kernel<32,2,0>"
    ptxas = (f"ptxas info    : Compiling entry function '{NAME}' for "
             "'sm_90a'\n"
             f"ptxas info    : Function properties for {NAME}\n"
             "    32 bytes stack frame, 36 bytes spill stores, 52 bytes "
             "spill loads\n"
             "ptxas info    : Used 168 registers, used 16 barriers, 32 bytes "
             "cumulative stack size\n")
    bad = tmp_path / "bad.sass"
    bad.write_text(listing(*SCORES, "wait1", "ldl_dp_a", "wait0", "exit"))
    good = tmp_path / "good.sass"
    good.write_text(listing(*SCORES, "wait1", "wait0", "exit"))
    report = tmp_path / "ptxas.txt"
    report.write_text(ptxas)
    assert hz.main(["--sass", f"good={good}", "--ptxas",
                    f"good={report}"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("[hazards] good flash_bwd_dq_kernel<32,2,0>: 168 "
                      "registers, 52 bytes spilled, 4 HGMMA in 2 groups, "
                      "0 hazards")
    assert json.loads(out[-1])["hazards"] == 0
    assert hz.main(["--sass", f"bad={bad}"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert "1 hazards" in out[0] and out[1].startswith(
        "[hazards]   operand: /*0070*/ LDL R116, [R1+0xc]")
    assert json.loads(out[-1])["libraries"]["bad"][
        "flash_bwd_dq_kernel<32,2,0>"]["hazards"] == 1
