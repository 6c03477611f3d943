"""The SASS instruction counter behind the kernels' bounds
(gym2048_tpu_torch._sass), on small hand-written listings in the format of
``cuobjdump -sass``."""

from pathlib import Path

import pytest

from gym2048_tpu_torch import _sass


def listing(name, body):
    """A cuobjdump-style listing of one function; ``body`` holds one
    instruction per line, at addresses 0x0, 0x10, ..."""
    lines = [f"\t\tFunction : {name}", "\t.headerflags\t@\"EF_CUDA_SM90\""]
    for i, text in enumerate(body):
        lines.append(f"        /*{16 * i:04x}*/                   {text} ;"
                     "                /* 0x000fe40000000f00 */")
        lines.append("                                          /* 0x000fc80000000000 */")
    return "\n".join(lines) + "\n"


STRAIGHT = [
    "S2R R0, SR_TID.X",             # 0x00
    "ISETP.GE.AND P0, PT, R0, c[0x0][0x210], PT",
    "@P0 EXIT",                     # 0x20: threads past the end leave
    "IADD3 R1, R0, 0x1, RZ",
    "STG.E desc[UR4][R2.64], R1",
    "EXIT",                         # 0x50
    "BRA 0x60",                     # padding loop after the exit
]

DIAMOND = [
    "ISETP.NE.AND P0, PT, R0, RZ, PT",  # 0x00
    "@P0 BRA 0x60",                      # 0x10
    "IADD3 R1, R1, 0x1, RZ",             # 0x20: long side, 4 instructions
    "IADD3 R1, R1, 0x1, RZ",
    "IADD3 R1, R1, 0x1, RZ",
    "BRA 0x70",                          # 0x50
    "IADD3 R1, R1, 0x2, RZ",             # 0x60: short side, 1 instruction
    "STG.E desc[UR4][R2.64], R1",        # 0x70
    "EXIT",
]

LOOP = [
    "MOV R4, RZ",                        # 0x00
    "ISETP.GE.AND P0, PT, R5, 0x1, PT",
    "@!P0 BRA 0xa0",                     # 0x20: no iteration at all
    "IADD3 R4, R4, 0x1, RZ",             # 0x30: loop head
    "ISETP.NE.AND P1, PT, R6, RZ, PT",
    "@!P1 BRA P2, 0x80",                 # 0x50: rare long side skipped
    "IADD3 R7, R7, 0x1, RZ",             # 0x60
    "IADD3 R7, R7, 0x1, RZ",             # 0x70
    "ISETP.GE.AND P0, PT, R4, R5, PT",   # 0x80
    "@!P0 BRA 0x30",                     # 0x90: back branch
    "STG.E desc[UR4][R2.64], R4",        # 0xa0
    "EXIT",
]


def test_short_name_strips_namespaces_and_arguments():
    mangled = "_ZN46_GLOBAL__N__71f402d8_13_fused_step_cu_22b194e817fused_move_kernelEPKiS1_PiS2_S2_x"
    assert _sass.short_name(mangled) == "fused_move_kernel"
    assert _sass.short_name("_Z11demo_kernelPi") == "demo_kernel"
    assert _sass.short_name("plain_name") == "plain_name"


def test_parse_reads_every_function_in_order():
    text = listing("_Z3onev", STRAIGHT) + listing("_Z3twov", DIAMOND)
    code = _sass.parse(text)
    assert list(code) == ["one", "two"]
    assert [a for a, _ in code["one"]] == [16 * i for i in range(len(STRAIGHT))]
    assert code["two"][1] == (0x10, "@P0 BRA 0x60")


@pytest.mark.parametrize("body, expected", [
    # the guarded exit falls through: an in-range thread runs all six
    (STRAIGHT, _sass.IssueCount(6, 0)),
    # the shorter side of the branch: 2 + 1 + 2
    (DIAMOND, _sass.IssueCount(5, 0)),
    # outside: 3 before the loop + 2 after it; one iteration: head to back
    # branch on the short side, 3 + 2
    (LOOP, _sass.IssueCount(5, 5)),
])
def test_issue_count_takes_the_shortest_path(body, expected):
    (code,) = _sass.parse(listing("_Z1kv", body)).values()
    assert _sass.issue_count(code) == expected


def test_per_thread_adds_the_iterations():
    assert _sass.IssueCount(139, 1400).per_thread(1024) == 139 + 1024 * 1400
    assert _sass.IssueCount(1518, 0).per_thread() == 1518


@pytest.mark.parametrize("body, match", [
    (LOOP[:-2] + ["@P3 BRA 0x00", "EXIT"], "back branches"),
    (["BRX R2 -0x10", "EXIT"], "indirect"),
    (["BRA 0x00"], "no path"),
])
def test_issue_count_refuses_what_it_cannot_bound(body, match):
    (code,) = _sass.parse(listing("_Z1kv", body)).values()
    with pytest.raises(ValueError, match=match):
        _sass.issue_count(code)


def test_dump_raises_without_cuobjdump(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    if Path("/usr/local/cuda/bin/cuobjdump").is_file():
        pytest.skip("a cuobjdump is installed at the default path")
    with pytest.raises(RuntimeError, match="cuobjdump not found"):
        _sass.dump(tmp_path / "lib.so")
