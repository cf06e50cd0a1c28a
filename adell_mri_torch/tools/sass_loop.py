"""
Issue bound of the intensity kernel (K2/K3) from its SASS.

``python -m adell_mri_torch.tools.sass_loop`` builds the kernel library
(``ops/kernels/build.py``), disassembles it with ``cuobjdump -sass`` and,
for ``intensity_aug_kernel<float,true,true>`` and
``<__nv_bfloat16,true,true>`` (the Rician path), counts the instructions
of the chunk loop's body: from the target of the widest backward branch
to that branch. One iteration handles one 16-byte vector (4 f32 or 8
bf16 elements), and a warp issues one instruction for 32 iterations, so
the issue bound of a call over ``--elements`` elements is

    instructions x elements / (per iteration x 32) warp instructions
    / (SMs x 4 schedulers x SM clock),

at the card's maximum SM clock (``nvidia-smi clocks.max.sm``); the
instructions outside the loop (parameters, the Philox key schedule) run
once per thread and are counted in ``function_instructions``. Prints the
counts and the bounds, with the card's name and power limit, and writes
them to ``chiprun_out/sass_loop.json`` (or ``--out``), the loop's SASS
included. ``--library`` reads another build, for example the older
checkout's kernel that ``tools/time_intensity.py --compare`` compiles
(``build/intensity_compare/libintensity_other.so``). Needs the card and
the CUDA toolkit's ``cuobjdump``.
"""

import argparse
import json
import re
import shutil
import subprocess
from pathlib import Path

# kernel name (mangled template arguments) -> elements a loop iteration
KERNELS = {
    "intensity_aug_kernel<float,true,true>":
        ("intensity_aug_kernelIfLb1ELb1E", 4),
    "intensity_aug_kernel<bf16,true,true>":
        ("intensity_aug_kernelI13__nv_bfloat16Lb1ELb1E", 8),
}
SCHEDULERS_PER_SM = 4
WARP = 32

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA\b(?:\.\S+)?\s+(0x[0-9a-f]+)")


def parse_functions(sass: str):
    """{mangled name: [(address, instruction text)]} of a cuobjdump -sass
    listing."""
    funcs, current = {}, None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            current = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.match(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2)))
    return funcs


def loop_body(insns):
    """Instructions of the widest loop: from the target of the backward
    branch that jumps furthest back to that branch, inclusive."""
    best = None
    for addr, text in insns:
        m = _BRA.search(text)
        if not m:
            continue
        target = int(m.group(1), 16)
        if target < addr and (best is None or addr - target > best[1]
                              - best[0]):
            best = (target, addr)
    if best is None:
        raise ValueError("no backward branch: no loop found")
    return [(a, t) for a, t in insns if best[0] <= a <= best[1]]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--elements", type=int, default=4 * 128 * 128 * 32,
                        help="elements of the call (chip_smoke's K3 call)")
    parser.add_argument("--library", help="the shared library to read "
                        "(default: this checkout's build)")
    parser.add_argument("--out", default="sass_loop.json",
                        help="file name under chiprun_out/")
    args = parser.parse_args(argv)

    import torch

    from adell_mri_torch.ops.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("sass_loop: no CUDA device")
    if args.library:
        library = Path(args.library)
    else:
        build.load_library()
        library = build.BUILD_DIR / build.LIB_NAME
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [tool, "-sass", str(library)],
        check=True, capture_output=True, text=True, timeout=300).stdout
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, power, clock_mhz = [s.strip() for s in smi.split(",")]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    funcs = parse_functions(sass)
    rows = {}
    for label, (mangled, per_iter) in KERNELS.items():
        matches = [f for f in funcs if mangled in f]
        if len(matches) != 1:
            raise SystemExit(f"sass_loop: {label}: {len(matches)} functions "
                             f"match {mangled}")
        body = loop_body(funcs[matches[0]])
        n = len(body)
        issued = n * args.elements / (per_iter * WARP)
        bound_ms = issued / (sms * SCHEDULERS_PER_SM
                             * float(clock_mhz) * 1e6) * 1e3
        rows[label] = dict(
            function=matches[0], loop_instructions=n,
            loop_instructions_not_nop=sum(
                1 for _, t in body if not t.startswith("NOP")),
            function_instructions=len(funcs[matches[0]]),
            elements_per_iteration=per_iter,
            instructions_per_element=n / per_iter,
            warp_instructions=issued, issue_bound_ms=bound_ms,
            loop_sass=[f"{a:04x} {t}" for a, t in body])
        print(f"[sass_loop] {name}, {power} W, {sms} SMs at "
              f"{clock_mhz} MHz (clocks.max.sm): {label}: {n} instructions "
              f"a loop iteration ({n / per_iter:.1f} an element); "
              f"issue bound at {args.elements} elements {bound_ms:.5f} ms")
    out = dict(device=name, power_limit_w=power, sm_clock_mhz=clock_mhz,
               sms=sms, elements=args.elements, library=str(library),
               kernels=rows)
    out_dir = Path(__file__).resolve().parents[2] / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
