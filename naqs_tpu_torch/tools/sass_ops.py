"""Count the floating-point instructions of the sampler split's operations in
the SASS that nvcc makes (cuobjdump -sass), for the operations bound of
`chip_smoke.py`.

    python -m naqs_tpu_torch.tools.sass_ops   # needs nvcc and cuobjdump

Prints one JSON object:
* "kernels": for each kernel of the built libsampler_step.so, its
  floating-point instructions by opcode (static counts: a loop body counts
  once, both sides of a branch count);
* "ops": for each operation of the split that is not one instruction (f64
  division, log1p, sqrt; f32 division, expf), the floating-point
  instructions of a probe kernel that does that one operation, built with
  the library's flags: "fast" before the kernel's first EXIT (the path a
  normal operand takes), "slow" after it (the subroutines for special
  operands).
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import tempfile

from naqs_tpu_torch.ops import _build

PROBES = {
    "f64_div": ("double", "__ddiv_rn(x[i], y[i])"),
    "log1p": ("double", "log1p(x[i])"),
    "sqrt": ("double", "sqrt(x[i])"),
    "f32_div": ("float", "__fdiv_rn(x[i], y[i])"),
    "expf": ("float", "expf(x[i])"),
}
# opcodes that compute a floating-point value; comparisons, moves and
# conversions are not counted
F64 = re.compile(r"^(DADD|DMUL|DFMA|MUFU\.(RCP|RSQ)64H|FRND\.F64)")
F32 = re.compile(r"^(FADD|FMUL|FFMA|MUFU\.(EX2|LG2|RCP|RSQ|SQRT)$|FRND$)")


def _cuobjdump() -> str:
    return os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")


def _functions(binary: str) -> dict:
    """function name -> its SASS opcodes in order (predicates dropped)."""
    out = subprocess.run([_cuobjdump(), "-sass", binary], capture_output=True, text=True,
                         check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name:
            funcs[name].append(m.group(2))
    return funcs


def _tally(ops) -> dict:
    count = collections.Counter(op for op in ops if F64.match(op) or F32.match(op))
    return {"f64": sum(n for op, n in count.items() if F64.match(op)),
            "f32": sum(n for op, n in count.items() if F32.match(op)),
            "by_opcode": dict(sorted(count.items()))}


def _probe_source() -> str:
    kernels = []
    for name, (t, expr) in PROBES.items():
        kernels.append(f'extern "C" __global__ void probe_{name}(const {t}* x, const {t}* y, '
                       f'{t}* o) {{ const int i = threadIdx.x; o[i] = {expr}; }}')
    return "\n".join(kernels) + "\n"


def main() -> None:
    _build.load("sampler_step")
    lib = _build._paths("sampler_step")[1]
    report = {"kernels": {name: _tally(ops) for name, ops in _functions(lib).items()},
              "ops": {}}
    with tempfile.TemporaryDirectory() as tmp:
        src, cubin = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "probe.cubin")
        with open(src, "w") as f:
            f.write(_probe_source())
        flags = [x for x in _build.NVCC_FLAGS if x not in ("-shared", "-Xcompiler", "-fPIC")]
        subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", cubin, src], check=True)
        for name, ops in _functions(cubin).items():
            cut = ops.index("EXIT") if "EXIT" in ops else len(ops)
            report["ops"][name.removeprefix("probe_")] = {
                "fast": _tally(ops[:cut]), "slow": _tally(ops[cut:])}
    print(json.dumps(report))


if __name__ == "__main__":
    main()
