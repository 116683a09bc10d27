"""What the compiler made of a kernel's substep loop: the SASS instructions
of one substep by pipe, and the time the card needs to issue them.

``cuobjdump -sass`` disassembles the built shared library.  A kernel's
loops are found from its backward branches; every substep of the mixing
kernels rounds its depth to the nearest level exactly once (``rintf``, one
``FRND``), so a loop's instructions divided by its ``FRND`` count are the
instructions of one element's substep whatever the unrolling or the number
of elements a thread walks.  The counts are static: both sides of a
branch inside the loop are counted, a called slow path (``CALL``) is not.

An SM of an H100 issues at most 4 x 32 = 128 thread-instructions a clock;
its integer lanes take 64 a clock and its special-function lanes
(``MUFU``: reciprocal, reciprocal square root) 16.  The issue bound of a
kernel is the largest of the three times at the SM clock it ran at.  The
float compares, selects and min/max share the integer lanes' pipe on this
architecture, so ``alu`` (integer without ``IMAD``, which goes through the
multiply-add lanes, plus ``FSETP``, ``FSEL``, ``FMNMX``, ``FSET``) over 64
is reported beside it as a tighter reading of the same counts.

    python -m opendrift_tpu_torch.tools.sass LIBRARY.so [name regex]
"""

import importlib.util
import os
import re
import shutil
import subprocess
import sys

SMS = 132
INSTRUCTIONS_PER_CLOCK = 128
INTEGER_PER_CLOCK = 64
MUFU_PER_CLOCK = 16

_FP32 = {"FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP", "FSET", "FCHK",
         "FSWZADD"}
_ALU_FLOAT = {"FMNMX", "FSEL", "FSETP", "FSET"}
_CONVERT = {"I2F", "I2FP", "F2I", "F2IP", "F2F", "FRND", "I2I"}
_INTEGER = {"IMAD", "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR",
            "LEA", "ISETP", "IMNMX", "SEL", "PRMT", "POPC", "FLO", "BFE",
            "BFI", "IABS", "ICMP", "PLOP3", "VIADD", "VIMNMX", "VABSDIFF",
            "BMSK", "SGXT", "IDP", "ISCADD"}
_BRANCH = {"BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT", "BSSY",
           "BSYNC", "BREAK", "WARPSYNC", "YIELD"}

_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")


def cuobjdump():
    """Path of a ``cuobjdump``, or None: the CUDA toolkit's first, then the
    one the ``triton`` package carries."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = [os.path.join(home, "bin", "cuobjdump"),
             shutil.which("cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        found.append(os.path.join(os.path.dirname(spec.origin), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    for path in found:
        if path and os.path.exists(path):
            return path
    return None


def pipe(opcode):
    stem = opcode.split(".")[0]
    if stem == "MUFU":
        return "mufu"
    if stem in _CONVERT:
        return "conversion"
    if stem in _FP32:
        return "fp32"
    if stem in _INTEGER:
        return "integer"
    if stem in _BRANCH:
        return "branch"
    if stem.startswith(("LD", "ST", "ATOM", "RED")):
        return "memory"
    return "other"


def parse(text):
    """{mangled function name: [(address, opcode, operands)]} of a
    ``cuobjdump -sass`` listing."""
    functions, current = {}, None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = functions.setdefault(m.group(1), [])
            continue
        m = _LINE.match(line)
        if m is None or current is None:
            continue
        words = m.group(2).split()
        if words and words[0].startswith("@"):       # a predicate
            words = words[1:]
        if words:
            current.append((int(m.group(1), 16), words[0],
                            " ".join(words[1:])))
    return functions


def loops(instructions):
    """[(first index, last index)] of the loops of a function: one for each
    backward branch, from its target to the branch."""
    index = {addr: i for i, (addr, _, _) in enumerate(instructions)}
    found = []
    for i, (addr, opcode, operands) in enumerate(instructions):
        if opcode.split(".")[0] != "BRA":
            continue
        targets = re.findall(r"0x([0-9a-f]+)", operands)
        if not targets:
            continue
        target = int(targets[-1], 16)
        if target <= addr and target in index:
            found.append((index[target], i))
    return found


def count(instructions):
    """Instruction counts of a stretch of SASS by pipe, with the opcodes'
    own counts."""
    pipes = {k: 0 for k in ("fp32", "integer", "mufu", "conversion",
                            "branch", "memory", "other")}
    opcodes = {}
    alu = 0
    for _, opcode, _ in instructions:
        pipes[pipe(opcode)] += 1
        stem = opcode.split(".")[0]
        opcodes[opcode] = opcodes.get(opcode, 0) + 1
        if stem in _ALU_FLOAT or (stem in _INTEGER and stem != "IMAD"):
            alu += 1
    return {"total": len(instructions), **pipes, "alu": alu,
            "opcodes": dict(sorted(opcodes.items()))}


def substep_counts(listing, name_regex, marker="FRND"):
    """The substep loops of every function of ``listing`` whose mangled
    name matches ``name_regex``: for each loop that holds the ``marker``
    opcode, its static instruction counts by pipe divided by the marker's
    count (one an element's substep).  Sorted by the total, so the first
    is the path that issues least."""
    out = []
    for name, instructions in parse(listing).items():
        if not re.search(name_regex, name):
            continue
        for first, last in loops(instructions):
            body = instructions[first:last + 1]
            c = count(body)
            marks = sum(n for op, n in c["opcodes"].items()
                        if op.split(".")[0] == marker)
            if marks == 0:
                continue
            per = {k: v / marks for k, v in c.items() if k != "opcodes"}
            out.append({"function": name, "loop_instructions": c["total"],
                        "substeps_in_loop": marks, "per_substep": per,
                        "opcodes": c["opcodes"]})
    out.sort(key=lambda row: row["per_substep"]["total"])
    return out


def issue_bound_ms(per_substep, elements, substeps, sm_mhz):
    """(the issue bound in ms, what sets it, the three terms and the
    ``alu`` reading in ms) for ``elements`` x ``substeps`` substeps at an
    SM clock of ``sm_mhz``."""
    work = elements * substeps / (SMS * sm_mhz * 1e6) * 1e3
    terms = {"all": per_substep["total"] / INSTRUCTIONS_PER_CLOCK * work,
             "integer": per_substep["integer"] / INTEGER_PER_CLOCK * work,
             "mufu": per_substep["mufu"] / MUFU_PER_CLOCK * work}
    by = max(terms, key=terms.get)
    terms["alu"] = per_substep["alu"] / INTEGER_PER_CLOCK * work
    return terms[by], by, terms


def listing_of(library):
    """The ``cuobjdump -sass`` listing of a built library, or None where no
    ``cuobjdump`` is found."""
    tool = cuobjdump()
    if tool is None:
        return None
    out = subprocess.run([tool, "-sass", library], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"{tool} failed on {library}:\n{out.stderr}")
    return out.stdout


def mixing_report(library, elements, substeps, sm_mhz, listing_file=None):
    """{kernel: substep loops} of the windspeed, oil and profile kernels
    of a built mixing library (Large1994 without mixing at the surface, the
    main path's options), each loop with its counts a substep and, where the
    clock is known, its issue bound; or "not available" without a
    ``cuobjdump``.  ``listing_file`` gets the disassembly."""
    listing = listing_of(library)
    if listing is None:
        return "not available"
    if listing_file:
        with open(listing_file, "w") as f:
            f.write(listing)
    out = {}
    # a substep rounds one depth to a level: FRND in the windspeed and oil
    # kernels, F2I (rounded to an integer) in the profile kernel
    for kernel, regex, marker in (
            ("visser_mixing", r"visser_mixing_kernelILi1ELb0E", "FRND"),
            ("visser_mixing_oil", r"visser_mixing_oil_kernelILi1ELb0ELb0E",
             "FRND"),
            ("visser_mixing_profile", r"visser_mixing_profile_kernelILb0E",
             "F2I")):
        rows = substep_counts(listing, regex, marker)
        for row in rows if sm_mhz else ():
            bound, by, terms = issue_bound_ms(row["per_substep"], elements,
                                              substeps, sm_mhz)
            row.update(issue_bound_ms=bound, issue_bound_by=by,
                       issue_terms_ms=terms, sm_mhz=sm_mhz)
        out[kernel] = rows
    return out


def main(argv):
    if not argv:
        print(__doc__)
        return 2
    listing = listing_of(argv[0])
    if listing is None:
        print("no cuobjdump found", file=sys.stderr)
        return 1
    import json
    for row in substep_counts(listing, argv[1] if len(argv) > 1 else "."):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
