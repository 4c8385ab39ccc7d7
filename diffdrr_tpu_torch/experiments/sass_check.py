#!/usr/bin/env python3
"""Read the SASS of the forward gathers' loads, and diff a checkout's kernels.

    python3 diffdrr_tpu_torch/experiments/sass_check.py [--parent DIR] [--out DIR]

Builds the package's CUDA libraries (``ops/kernels/build.py``) and the
4x4x4 build of ``fwd_probes.cu`` (as ``fwd_timing.py`` does), and disassembles
them with ``cuobjdump -sass``. Needs nvcc and cuobjdump (the CUDA toolkit),
not a card.

For each forward gather on a bf16 copy (``siddon_fwd_kernel`` and
``joseph_fwd_kernel`` at each march axis, and every bf16 probe variant at
each unroll), and on a float32 copy for comparison, a straight walk over
its instructions counts the loads of the copy's voxels (``LDG`` of 16 bits
for bf16, of 32 for float32) and, at each instruction, how many of them are
in flight: issued, their register not yet read or overwritten. ``peak``,
the most in flight at once, is the batch of loads the thread waits on
together: 3U for Siddon with U slabs in flight, 4U (8U in blend mode) for
Joseph, when every load of a batch issues before the first of them is read;
1 or 2 when each read is widened where it lands. ``first_use_run`` is the
number of such loads issued before the first one is read. The walk takes
the instructions in address order, both arms of a branch alike: a load
read at once on one arm only counts as read.

The float32 ``joseph_fwd_kernel``'s blend-mode instantiation (``Blend``
true, at each march axis) loads its windows raw before any lerp: under
``float32_blend_forward`` its ``first_use_run``, the 32-bit loads issued
before the first read of a loaded value, is the batch a thread waits on
together (8U with U = ``kFwdBlendSteps``; window()'s order, which lerps each
pair as it lands, gives 1). ``fwd_probes.cu``'s float32 Joseph forwards
(``probe::joseph_fwd``: strided and bricked in window()'s order, and
``probe::joseph_fwd_raw``, bricked in the raw order, each at U = 1, 2, 4)
are counted beside it. The parent's kernels are matched by name, the
``Blend`` false instantiation of ``joseph_fwd_kernel`` with a parent's
kernel of its first two template arguments where the parent has no third.

With ``--parent DIR`` (a checkout of another commit, e.g. unpacked with
``git archive``), its ``csrc/*.cu`` are built with this checkout's nvcc
flags and every kernel's SASS is compared with this checkout's by name,
each instruction without its address and encoding: the kernels whose code
differs, and those in one build only; and for each forward, fused or
channel kernel that differs, the parent's loads in flight, counted as
above.

The bricked copy's kernel (``brick_copy_kernel``, its packed and general
instantiations, and ``brick_probes.cu``'s variants, built as
``fwd_timing.py`` builds them): their global and shared memory
instructions by opcode and width (``LDG.E.128`` a 16-byte load,
``STG.E.128`` a 16-byte store, ``UBLKCP`` a bulk copy) and their registers
and local-memory (spill) bytes a thread.

The fused pose kernels (``siddon_fwdgrad_kernel``, ``joseph_fwdgrad_kernel``
and the two-pass backwards' sum modes, ``siddon_bwd_rays_kernel`` and
``joseph_bwd_rays_kernel``, which run the same lanes, each at every march
axis and in both storages; and the bf16 build of ``fwdgrad_probes.cu``,
-DPROBE_BF16 at march axis 2, every variant, G and U), under ``fused``:
the same count of the copy's loads in the pass loop (the widest loop:
``fwdgrad_lanes``' passes), the most in flight at once (a bf16 kernel's
aim: 3U for Siddon with U slabs a lane, 4U for Joseph, 8U in blend mode,
whose loads of the second plane are predicated in the same code), their
registers and local-memory bytes a thread.

The channel kernels (``joseph_fwd_ch_kernel`` and ``joseph_bwd_rays_ch_kernel``,
each at every march axis and in both storages; and the bf16 builds of
``max_channel_probes.cu`` and ``channel_probes.cu``, -DPROBE_BF16 at march
axis 2, every variant, G and U), under ``channels``: the same count of the
density copy's loads in the widest loop (the forward's: its channel tiles,
each holding the pass loop; the ray backward's: its passes), the most in
flight at once (a bf16 kernel's aim: 4U with U steps a lane, 8U in blend
mode), their registers and local-memory bytes a thread. The labels' and
the cotangents' loads are 32-bit and not counted in a bf16 kernel.

Each kernel's registers and local-memory (spill) bytes a thread come from
``cuobjdump -res-usage``. Prints one line per kernel and, last, one JSON
object; with ``--out`` also writes the SASS of the forward gathers, the
fused and the channel kernels there.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# Opcodes whose first operand is read, not written.
_NO_DEST = ("ST", "RED", "BRA", "EXIT", "RET", "CALL", "BSYNC", "BSSY", "WARPSYNC", "NOP",
            "BAR", "BPT", "JMP", "YIELD")
_REG = re.compile(r"(?<![A-Z_])R(\d+)(\.64|\.128)?\b")
_FORWARDS = ("siddon_fwd_kernel", "joseph_fwd_kernel", "probe::siddon_fwd_bf16",
             "probe::joseph_fwd_bf16", "probe::joseph_fwd<", "probe::joseph_fwd_raw<")
_FUSED = ("siddon_fwdgrad_kernel", "joseph_fwdgrad_kernel", "siddon_bwd_rays_kernel<",
          "joseph_bwd_rays_kernel<", "probe::siddon_fwdgrad_bf16", "probe::joseph_fwdgrad_bf16")
_CHANNELS = ("joseph_fwd_ch_kernel", "joseph_bwd_rays_ch_kernel", "probe::fwd_ch_bf16",
             "probe::rays_ch_bf16")
_COPIES = ("brick_copy_kernel", "probe::parent_copy", "probe::bulk_copy", "probe::reads_only",
           "probe::writes_only")
_MEMORY_OP = re.compile(r"^(LDG|STG|LDS|STS|UBLKCP|LDGSTS)\b(\S*)")
# joseph_fwd_kernel's third template argument, Blend, true or false.
_BLEND = re.compile(r", (\(bool\)1|true)>")
_NOT_BLEND = re.compile(r"(joseph_fwd_kernel<[^<>]*?), (\(bool\)0|false)>")


def parent_name(name: str) -> str:
    """``name`` as the parent, before ``joseph_fwd_kernel`` took its Blend
    argument, names the same code: the Blend false instantiation."""
    return _NOT_BLEND.sub(r"\1>", name)


def _tool(name):
    for cand in (Path("/usr/local/cuda/bin") / name, shutil.which(name)):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError(f"{name} not found: needs the CUDA toolkit")


def disassemble(lib: Path) -> dict:
    """{demangled kernel name: [(address, instruction text without its
    address or encoding)]}."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    mangled, funcs, cur = [], {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            mangled.append(cur)
            funcs[cur] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            funcs[cur].append((int(m.group(1), 16), m.group(2)))
    names = demangle(mangled)
    return {n: funcs[m] for n, m in zip(names, mangled)}


def demangle(mangled):
    try:
        return subprocess.run([_tool("cu++filt")], input="\n".join(mangled),
                              capture_output=True, text=True, check=True,
                              timeout=60).stdout.splitlines()
    except (RuntimeError, subprocess.CalledProcessError):
        return list(mangled)


def registers(lib: Path, what: str = "REG") -> dict:
    """{mangled kernel name: registers (``what="LOCAL"``: local-memory bytes)
    a thread} (``cuobjdump -res-usage``)."""
    text = subprocess.run([_tool("cuobjdump"), "-res-usage", str(lib)], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    return {m.group(1): int(m.group(2))
            for m in re.finditer(rf"Function (\S+):\s*[^\n]*?\b{what}:(\d+)", text)}


def memory_ops(instrs) -> dict:
    """{opcode with its modifiers: count} of the global and shared memory
    instructions in ``instrs`` ((address, text) pairs)."""
    out = {}
    for _, ins in instrs:
        m = _MEMORY_OP.match(re.sub(r"^@!?U?P[T0-9]+\s+", "", ins))
        if m:
            op = m.group(1) + m.group(2)
            out[op] = out.get(op, 0) + 1
    return dict(sorted(out.items()))


def _regs(operand):
    out = []
    for m in _REG.finditer(operand):
        k = int(m.group(1))
        width = {".64": 2, ".128": 4}.get(m.group(2) or "", 1)
        out += range(k, k + width)
    return out


def main_loop(instrs):
    """The instructions of the widest loop (from the target of a backward
    branch to the branch), or all of them where there is none."""
    span = None
    for addr, ins in instrs:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            if span is None or addr - lo > span[1] - span[0]:
                span = (lo, addr)
    if span is None:
        return [ins for _, ins in instrs]
    return [ins for addr, ins in instrs if span[0] <= addr <= span[1]]


def loads_in_flight(instrs, bits):
    """(loads, peak, first_use_run) of the ``bits``-wide LDGs in ``instrs``
    (texts, in order)."""
    pending = set()
    loads = peak = 0
    first_use_run = None
    for ins in instrs:
        ins = re.sub(r"^@!?U?P[T0-9]+\s+", "", ins)
        parts = ins.split(None, 1)
        op = parts[0]
        operands = [o.strip() for o in parts[1].split(",")] if len(parts) > 1 else []
        has_dest = operands and not op.startswith(_NO_DEST)
        srcs = [r for o in (operands[1:] if has_dest else operands) for r in _regs(o)]
        if pending & set(srcs):
            if first_use_run is None:
                first_use_run = loads
            pending -= set(srcs)
        dests = _regs(operands[0]) if has_dest else []
        if has_dest and ".WIDE" in op and len(dests) == 1:
            dests.append(dests[0] + 1)
        pending -= set(dests)
        is_load = op.startswith("LDG") and (".U16" in op if bits == 16 else
                                            not re.search(r"\.(U|S)(8|16)|\.64|\.128", op))
        if is_load and dests:
            loads += 1
            pending.add(dests[0])
            peak = max(peak, len(pending))
    return loads, peak, first_use_run


def build_parent(parent: Path, out_dir: Path):
    """The parent checkout's libraries, built with this checkout's nvcc flags."""
    from diffdrr_tpu_torch.ops.kernels import build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs, libs = [], {}
    for name in build.SOURCES:
        lib = out_dir / f"lib{name}.so"
        src = parent / "diffdrr_tpu_torch" / "csrc" / f"{name}.cu"
        procs.append(subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                                       str(src)]))
        libs[name] = lib
    for p in procs:
        if p.wait(timeout=900) != 0:
            raise RuntimeError(f"nvcc failed on the parent: {p.args}")
    return libs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, help="checkout whose kernels to diff against")
    parser.add_argument("--out", type=Path, help="directory for the forwards' SASS")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(HERE.parents[1]))
    from diffdrr_tpu_torch.experiments.fwd_timing import build_sources
    from diffdrr_tpu_torch.ops.kernels import build

    build.build_all()
    libs = {name: build._lib_path(name) for name in build.SOURCES}
    libs["fwd_probes"] = build_sources(HERE / "fwd_probes.cu",
                                       [[f"-DBRICK_L{d}=2" for d in range(3)]])[0]
    libs["brick_probes"] = build_sources(HERE / "brick_probes.cu", [[]])[0]
    libs["fwdgrad_probes_bf16"] = build_sources(HERE / "fwdgrad_probes.cu",
                                                [["-DPROBE_BF16", "-DPROBE_AXIS=2"]])[0]
    for probes in ("max_channel_probes", "channel_probes"):
        libs[f"{probes}_bf16"] = build_sources(HERE / f"{probes}.cu",
                                               [["-DPROBE_BF16", "-DPROBE_AXIS=2"]])[0]
    sass, regs, local = {}, {}, {}
    for name, lib in libs.items():
        sass.update({(name, k): v for k, v in disassemble(lib).items()})
        used = registers(lib)
        regs.update(zip(demangle(list(used)), used.values()))
        spilt = registers(lib, "LOCAL")
        local.update(zip(demangle(list(spilt)), spilt.values()))
    report = {"kernels": {}, "fused": {}, "channels": {}, "copies": {}, "diff": None,
              "float32_blend_forward": {}}
    for (lib, name), instrs in sorted(sass.items()):
        if lib in ("brick", "brick_probes") and any(c in name for c in _COPIES):
            ops = memory_ops(instrs)
            report["copies"][f"{lib}: {name}"] = dict(ops=ops, registers=regs.get(name),
                                                      local_bytes=local.get(name))
            print(f"[sass] {lib}: {name}: {regs.get(name)} registers, {local.get(name)} local "
                  f"bytes; {ops}", flush=True)
    for (lib, name), instrs in sorted(sass.items()):
        group = ("kernels" if any(f in name for f in _FORWARDS) else
                 "fused" if any(f in name for f in _FUSED) else
                 "channels" if any(f in name for f in _CHANNELS) else None)
        if group is None:
            continue
        bits = 16 if ("unsigned short" in name or "_bf16" in name) else 32
        loop = main_loop(instrs)
        loads, peak, first = loads_in_flight(loop, bits)
        report[group][name] = dict(lib=lib, instructions=len(instrs), loop=len(loop),
                                   loads=loads, peak=peak, first_use_run=first,
                                   registers=regs.get(name), local_bytes=local.get(name))
        print(f"[sass] {name}: {len(instrs)} instructions, {regs.get(name)} registers, "
              f"{local.get(name)} local bytes, loop {len(loop)}: {loads} LDG of {bits} bits, "
              f"peak in flight {peak}, issued before the first read {first}", flush=True)
        if lib == "joseph" and "joseph_fwd_kernel<" in name and _BLEND.search(name):
            report["float32_blend_forward"][name] = first
            print(f"[sass] float32 blend forward {name}: {first} LDG of 32 bits issued before "
                  f"the first read of a loaded value", flush=True)
        if args.out is not None:
            args.out.mkdir(parents=True, exist_ok=True)
            safe = re.sub(r"[^A-Za-z0-9_]+", "_", name)[:150]
            (args.out / f"{lib}.{safe}.sass").write_text(
                "".join(f"/*{a:04x}*/ {t}\n" for a, t in instrs))
    if args.parent is not None:
        parent_libs = build_parent(args.parent.resolve(), build.BUILD_ROOT / "sass-parent")
        old = {}
        for name, lib in parent_libs.items():
            old.update({(name, k): v for k, v in disassemble(lib).items()})
        ours = {(k[0], k[1] if (k[0], k[1]) in old else parent_name(k[1])): [t for _, t in v]
                for k, v in sass.items() if k[0] in build.SOURCES}
        # The parent's loads in flight, for each of its forwards, fused and
        # channel kernels
        parent_loads = {}
        for (lib, name), instrs in old.items():
            if any(f in name for f in _FORWARDS + _FUSED + _CHANNELS):
                bits = 16 if "unsigned short" in name else 32
                parent_loads[name] = dict(zip(("loads", "peak", "first_use_run"),
                                              loads_in_flight(main_loop(instrs), bits)))
        old = {k: [t for _, t in v] for k, v in old.items()}
        same = sorted(k[1] for k in ours.keys() & old.keys() if ours[k] == old[k])
        differ = sorted(k[1] for k in ours.keys() & old.keys() if ours[k] != old[k])
        report["diff"] = dict(same=len(same), differ=differ,
                              only_here=sorted(k[1] for k in ours.keys() - old.keys()),
                              only_parent=sorted(k[1] for k in old.keys() - ours.keys()),
                              parent_loads={n: parent_loads[n] for n in differ
                                            if n in parent_loads})
        for n, v in report["diff"]["parent_loads"].items():
            print(f"[sass] parent {n}: {v['loads']} LDG, peak in flight {v['peak']}, issued "
                  f"before the first read {v['first_use_run']}", flush=True)
        float_differ = [n for n in differ if "unsigned short" not in n]
        print(f"[sass] against {args.parent}: {len(same)} kernels the same instruction for "
              f"instruction, {len(differ)} differ ({len(float_differ)} of them not bf16): "
              f"{differ}; only here {report['diff']['only_here']}; only in the parent "
              f"{report['diff']['only_parent']}", flush=True)
        if args.out is not None:
            for (lib, name), instrs in old.items():
                if name in differ:
                    safe = re.sub(r"[^A-Za-z0-9_]+", "_", name)[:150]
                    (args.out / f"parent.{lib}.{safe}.sass").write_text("\n".join(instrs) + "\n")
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
