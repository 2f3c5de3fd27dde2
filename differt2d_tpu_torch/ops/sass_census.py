"""What the built kernels are made of: registers, residency and the
instructions of their inner loops, read from the SASS of the libraries.

On a machine with the CUDA toolkit and a GPU::

    python3 -m differt2d_tpu_torch.ops.sass_census

builds ``csrc/power_map.cu`` and ``csrc/opt_solver.cu`` (``_build``), reads
each kernel's registers (``cuobjdump -res-usage``), its resident blocks per
SM (the libraries' ``*_occupancy`` exports, which call
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and, from ``cuobjdump
-sass``, the instructions on one pass of each innermost loop: the adam step
of the solver kernels and the blocked test of the gradient kernels, by
class (SFU ``MUFU``, FP32, integer, memory, control).  A pass follows the
common path: a branch around a slow path (a region that calls a
subroutine and holds no ``MUFU``: a division's or square root's, or the
solver's ``slow_step``) is taken; a branch around a short region (at most
:data:`SHORT` instructions, a ``where`` branch's arithmetic) is not; a
branch around a longer region forks the pass, and every pass is listed.
The counts are static (they say what one pass issues, not how often each
pass runs).

The issue-slot bound of a map is its thread instructions over ``SMs x 128
x SM clock`` (an H100 SM issues four warp instructions a clock): the
least time the card could take to issue them.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from typing import Optional

SHORT = 40
"""Longest region a branch may skip without forking the pass."""
_SLOW = "<slow path skipped>"
MAX_PASSES = 64
"""Most passes listed per loop (forks beyond are dropped)."""

_INS = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"\b(?:BRA|CALL\.REL(?:\.NOINC)?)\b[^;]*?(0x[0-9a-f]+)")


def _tool(name: str) -> str:
    for path in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if path and os.path.isfile(path):
            return path
    msg = f"{name} not found (the CUDA toolkit's bin directory)"
    raise RuntimeError(msg)


def demangle(names: list) -> list:
    """C++ names of the mangled ``names`` (``cu++filt``, else ``c++filt``,
    else as they are)."""
    for tool in ("cu++filt", "c++filt"):
        try:
            path = _tool(tool) if tool == "cu++filt" else shutil.which(tool)
        except RuntimeError:
            continue
        if path:
            out = subprocess.run([path], input="\n".join(names), capture_output=True,
                                 text=True, check=False).stdout.splitlines()
            if len(out) == len(names):
                return out
    return list(names)


def functions(sass: str) -> dict:
    """``{mangled name: [(address, instruction), ...]}`` of a ``cuobjdump
    -sass`` listing (the predicate kept, the encoding dropped)."""
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            out[cur] = []
            continue
        m = _INS.match(line)
        if m and cur is not None:
            out[cur].append((int(m.group(1), 16), m.group(2)))
    return out


def opcode(ins: str) -> str:
    """The opcode with its modifiers, predicate dropped (``MUFU.RCP``)."""
    return re.sub(r"^@!?U?P[T\d]+\s+", "", ins).split()[0]


def klass(op: str) -> str:
    base = op.split(".")[0]
    if base == "MUFU":
        return "sfu"
    if base in ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FCHK", "FSET", "FSWZADD",
                "HFMA2", "HADD2", "HMUL2"):
        return "fp32"
    if base.startswith(("LD", "ST", "ATOM", "RED")) or base in ("LDS", "STS", "LDG", "STG",
                                                                "LDC", "ULDC"):
        return "memory"
    if base in ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "VOTE", "VOTEU", "WARPSYNC",
                "BAR", "BREAK", "NOP", "YIELD", "JMP", "BPT"):
        return "control"
    return "integer"


def innermost_loops(ins: list) -> list:
    """``[(head index, back-edge index)]`` of the loops that hold no other
    loop, in address order."""
    index = {a: i for i, (a, _) in enumerate(ins)}
    loops = []
    for i, (a, text) in enumerate(ins):
        m = _TARGET.search(text)
        if m and opcode(text).startswith("BRA"):
            t = int(m.group(1), 16)
            if t <= a and t in index:
                loops.append((index[t], i))
    return [(h, t) for h, t in loops
            if not any(h <= h2 and t2 <= t and (h2, t2) != (h, t) for h2, t2 in loops)]


def passes(ins: list, head: int, tail: int) -> list:
    """Opcode counters of the passes through the loop ``[head, tail]``
    (module docstring)."""
    index = {a: i for i, (a, _) in enumerate(ins)}
    done, stack = [], [(head, collections.Counter())]
    while stack and len(done) < MAX_PASSES:
        i, count = stack.pop()
        while True:
            a, text = ins[i]
            op = opcode(text)
            count[op] += 1
            if i == tail:
                done.append(count)
                break
            m = _TARGET.search(text)
            if op.startswith(("EXIT", "RET")) and not text.startswith("@"):
                break  # leaves the kernel: not a pass
            if not (m and op.startswith("BRA")):
                i += 1
                continue
            t = int(m.group(1), 16)
            j = index.get(t)
            conditional = text.startswith("@")
            if j is None or not (head <= j <= tail):
                if conditional:
                    i += 1
                    continue
                break  # leaves the loop
            if not conditional:
                i = j
                continue
            region = [opcode(x) for _, x in ins[i + 1:j]]
            slow = (any(r.startswith("CALL") for r in region)
                    and not any(r.startswith("MUFU") for r in region))
            if slow:
                count[_SLOW] += 1
                i = j
            elif len(region) <= SHORT:
                i += 1
            else:
                stack.append((j, collections.Counter(count)))
                i += 1
    return done


def summary(count: collections.Counter) -> dict:
    """Instructions of a pass by class, with the SFU ops, bit scans and votes
    by kind."""
    out = collections.Counter()
    for op, n in count.items():
        if op != _SLOW:
            out[klass(op)] += n
    out["total"] = sum(n for op, n in count.items() if op != _SLOW)
    for op, n in count.items():
        if op.startswith(("MUFU", "FLO", "BREV", "VOTE")):
            out[op] += n
    # Branches around a division's or square root's slow path, and calls
    # left on the pass (a slow path taken inline).
    out["slow_path_branches"] = count[_SLOW]
    out["calls"] = sum(n for op, n in count.items() if op.startswith("CALL"))
    return dict(out)


def resource_usage(lib_path: str) -> dict:
    """``{mangled name: registers}`` from ``cuobjdump -res-usage``."""
    text = subprocess.run([_tool("cuobjdump"), "-res-usage", lib_path], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            cur = m.group(1)
        m = re.search(r"REG:(\d+)", line)
        if m and cur:
            out[cur] = int(m.group(1))
    return out


def kernel_loops(lib_path: str) -> dict:
    """``{C++ name: {"registers": n, "loops": [[pass summary, ...], ...]}}``
    of each kernel in ``lib_path``."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    funcs = functions(sass)
    regs = resource_usage(lib_path)
    names = dict(zip(funcs, demangle(list(funcs))))
    out = {}
    for mangled, ins in funcs.items():
        name = names[mangled]
        loops = [[summary(p) for p in passes(ins, h, t)] for h, t in innermost_loops(ins)]
        out[name] = {"registers": regs.get(mangled), "instructions": len(ins), "loops": loops}
    return out


def short_name(name: str) -> str:
    """``opt_solver_kernel<1, 1, true>`` from a demangled signature
    (either demangler's spelling of the template arguments)."""
    m = re.search(r"(\w+<[^>]*>)\(", name)
    name = m.group(1) if m else name
    name = re.sub(r"\((?:unsigned )?int\)(-?\d+)", r"\1", name)
    return name.replace("(bool)1", "true").replace("(bool)0", "false")


def census(out_path: Optional[str] = None) -> dict:
    """Registers, blocks per SM and loop passes of the solver kernels and
    of the gradient kernels (the redesign and its twin), as printed by
    :func:`main`."""
    import torch

    from . import _build
    from . import opt_solver_kernel as osk
    from . import power_map_kernel as pmk

    result = {"device": torch.cuda.get_device_name(0)}
    for source, mod in (("opt_solver.cu", osk), ("power_map.cu", pmk)):
        path, _ = _build.build(source)
        mod.load_library()
        result[source] = {short_name(k): v for k, v in kernel_loops(path).items()}
    occ = {}
    for objective in ("fermat", "mpt"):
        for soft in (0, 1, 2):
            for fast in (False, True):
                occ[f"opt_solver_kernel<{soft}, {osk.OBJECTIVES[objective]},"
                    f" {'true' if fast else 'false'}>"] = osk.occupancy(objective, soft, fast, 5)
    for soft in (0, 1, 2):
        occ[f"power_map_kernel<false, {soft}, false>"] = pmk.occupancy(False, soft, False, 7)
        occ[f"power_map_kernel<true, {soft}, false>"] = pmk.occupancy(True, soft, False, 7)
        occ[f"power_map_kernel<true, {soft}, true>"] = pmk.occupancy(True, soft, True, 7)
    result["blocks_per_sm"] = occ
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main() -> int:
    out = os.path.join(os.getcwd(), "chiprun_out", "sass_census.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    result = census(out)
    print(f"device: {result['device']}")
    for source in ("opt_solver.cu", "power_map.cu"):
        for name, k in result[source].items():
            print(f"{source} {name}: {k['registers']} registers, {k['instructions']}"
                  f" instructions")
            for n, loop in enumerate(k["loops"]):
                for p in loop:
                    print(f"  loop {n}: " + ", ".join(f"{c} {v}" for c, v in sorted(p.items())))
    for name, blocks in result["blocks_per_sm"].items():
        print(f"blocks per SM, {name}: {blocks}")
    print(f"written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
