"""Instruction counts read off the SASS of the port's CUDA libraries.

The roofline of ``utils/vpu_probe.py`` divides instruction counts by
measured issue rates, so both sides have to be counted the same way: from
what the compiler emitted, not from the source. ``cuobjdump -sass`` of a
built library gives each kernel's instructions; this module counts those a
thread issues

  - per link of the chain probe (``csrc/chain_probe.cu``): the difference
    between the K=16 and K=8 instantiations of the reps loop, over 8;
  - per (row, candidate, element) of each rank-kernel family
    (``csrc/rank_counts.cu``, the instantiation with 16-byte copies that
    the published widths take): the chunk loop, the innermost loop with the
    most shared-memory loads, over its passes (one ``__syncthreads`` each)
    times the (row, candidate, element) terms a thread scores in one pass,
    which the tile shape gives (``rank_kernel.PAIR_ELEMENTS_PER_STEP``);
  - per complex element of each RotatE score kernel
    (``csrc/rotate_score.cu``, the instantiations with 16-byte loads): every
    instruction of the innermost loop with the most square roots, once,
    over its square roots (``MUFU.RSQ``, one an element).

The first two walk the fast path: a forward conditional branch over a
region that holds a call, a local-memory access, a global load or a loop (sqrtf's
special cases, sinf's large-argument reduction) is taken as the data of
the probe and of the rank kernels never enter it; the branch itself
issues and is counted. So is a region that holds a global atomic: the
rank kernel's one thread a block that takes the next tile from the
counter, once a tile. A region of asynchronous copies (``LDGSTS``, the
next chunk's staging) is walked: the steady state issues it every pass.
"""

from __future__ import annotations

import collections
import re
import subprocess
from typing import Dict, List, NamedTuple, Tuple

from ..ops import _nvcc


class Instr(NamedTuple):
    addr: int
    pred: str
    op: str
    args: str


_LINE = re.compile(r"\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_SLOW = ("CALL", "LDL", "STL", "LDG", "ATOMG", "ATOM", "RED")  # opcode bases; LDGSTS is not one
_FP32 = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK", "FRND")


def disassemble(so_path: str) -> str:
    """``cuobjdump -sass`` of a built library (raises without the tool)."""
    return subprocess.run([_nvcc.cuda_tool("cuobjdump"), "-sass", so_path],
                          capture_output=True, text=True, check=True).stdout


def parse(text: str) -> Dict[str, List[Instr]]:
    """{mangled kernel name: its instructions in address order}."""
    funcs: Dict[str, List[Instr]] = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _LINE.match(line)
        if cur is not None and m:
            cur.append(Instr(int(m.group(1), 16), (m.group(2) or "").strip(), m.group(3),
                             m.group(4).strip()))
    return funcs


def unit(op: str) -> str:
    """The class an opcode is counted under: fp32, mufu, lds or other."""
    base = op.split(".")[0]
    if base == "MUFU":
        return "mufu"
    if base == "LDS":
        return "lds"
    if base in _FP32:
        return "fp32"
    return "other"


def _target(ins: Instr) -> int:
    """A branch's target: its last operand (``BRA 0x1cf0``, ``BRA !P3, 0x1cf0``)."""
    return int(ins.args.split(",")[-1], 16)


def _loops(instrs: List[Instr]) -> List[Tuple[int, int]]:
    """(first, last) indices of every loop: a backward branch and the
    instructions from its target to it."""
    index = {ins.addr: i for i, ins in enumerate(instrs)}
    return [(index[_target(ins)], i) for i, ins in enumerate(instrs)
            if ins.op == "BRA" and _target(ins) < ins.addr]


def fast_path(instrs: List[Instr], first: int, last: int) -> collections.Counter:
    """Opcodes issued walking instructions ``first..last`` straight through,
    past every forward conditional branch over a slow region."""
    index = {ins.addr: i for i, ins in enumerate(instrs)}
    counts: collections.Counter = collections.Counter()
    i = first
    while i <= last:
        ins = instrs[i]
        counts[ins.op] += 1
        if ins.op == "BRA" and _target(ins) > ins.addr:
            j = index[_target(ins)]
            region = instrs[i + 1:j]
            slow = any(x.op.split(".")[0] in _SLOW or (x.op == "BRA" and _target(x) < x.addr)
                       for x in region)
            if not ins.pred or slow:
                i = j
                continue
        i += 1
    return counts


def by_unit(counts: collections.Counter, per: float = 1.0) -> Dict[str, float]:
    out = {"fp32": 0.0, "mufu": 0.0, "lds": 0.0, "other": 0.0}
    for op, n in counts.items():
        out[unit(op)] += n / per
    out["all"] = sum(counts.values()) / per
    return out


def chain_link_counts(text: str, ks=(8, 16)) -> Dict[int, collections.Counter]:
    """{link code: opcodes issued per link} of the chain probe: the fast
    path of the reps loop at K=ks[1] less that at K=ks[0], over the
    difference in K."""
    per_k: Dict[Tuple[int, int], collections.Counter] = {}
    for name, instrs in parse(text).items():
        m = re.search(r"chain_kernelILi(\d+)ELi(\d+)E", name)
        if not m or int(m.group(2)) not in ks:
            continue
        first, last = max(_loops(instrs), key=lambda fl: fl[1] - fl[0])
        per_k[(int(m.group(1)), int(m.group(2)))] = fast_path(instrs, first, last)
    out = {}
    for link in sorted({lk for lk, _ in per_k}):
        hi, lo = per_k[(link, ks[1])], per_k[(link, ks[0])]
        diff = collections.Counter()
        for op in set(hi) | set(lo):
            if hi[op] != lo[op]:
                diff[op] = (hi[op] - lo[op]) / (ks[1] - ks[0])
        out[link] = diff
    return out


def rank_element_counts(text: str, pair_elements_per_pass: int
                        ) -> Dict[int, collections.Counter]:
    """{family code: opcodes issued per (row, candidate, element)} of the
    rank kernel's 16-byte-copy instantiations: the fast path of the
    innermost loop with the most shared-memory loads, over (its barriers,
    one a pass) x ``pair_elements_per_pass``."""
    out = {}
    for name, instrs in parse(text).items():
        m = re.search(r"rank_counts_kernelILi(\d+)ELb1E", name)
        if not m:
            continue
        loops = _loops(instrs)
        inner = [(f, l) for f, l in loops
                 if not any(f <= f2 and l2 < l for f2, l2 in loops if (f2, l2) != (f, l))]
        first, last = max(inner, key=lambda fl: sum(unit(x.op) == "lds"
                                                     for x in instrs[fl[0]:fl[1] + 1]))
        counts = fast_path(instrs, first, last)
        passes = sum(n for op, n in counts.items() if op.startswith("BAR.SYNC"))
        if passes == 0:
            raise ValueError(f"{name}: the chunk loop holds no BAR.SYNC")
        per = passes * pair_elements_per_pass
        out[int(m.group(1))] = collections.Counter({op: n / per for op, n in counts.items()})
    return out


def score_element_counts(text: str) -> Dict[str, collections.Counter]:
    """{kernel: opcodes issued per complex element} of the RotatE score
    kernels' 16-byte instantiations (``score_forward``,
    ``score_grad_query``, ``score_grad_table``): the innermost loop with the
    most ``MUFU.RSQ`` (one a root, one a (row, element)), every instruction
    from its first to its back edge counted once, over those roots. The
    slow paths of the root and of the division are subroutines outside the
    loop, so the FP32 and MUFU counts are the fast path's; their call sites
    (a move, the call, a branch) add to ``other`` only. The loop's branch
    over a row index outside the table is walked: the data never takes it."""
    out = {}
    for name, instrs in parse(text).items():
        m = re.search(r"(score_forward|score_grad_query|score_grad_table)I6float4E", name)
        if not m:
            continue
        loops = _loops(instrs)
        inner = [(f, l) for f, l in loops
                 if not any(f <= f2 and l2 < l for f2, l2 in loops if (f2, l2) != (f, l))]

        def roots(fl):
            return sum(x.op.startswith("MUFU.RSQ") for x in instrs[fl[0]:fl[1] + 1])

        if not inner or roots(max(inner, key=roots)) == 0:
            raise ValueError(f"{name}: no loop holds a MUFU.RSQ")
        first, last = max(inner, key=roots)
        per = roots((first, last))
        counts = collections.Counter(x.op for x in instrs[first:last + 1])
        out[m.group(1)] = collections.Counter({op: n / per for op, n in counts.items()})
    return out
