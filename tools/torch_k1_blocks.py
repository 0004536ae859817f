#!/usr/bin/env python3
"""Build the greedy rollout kernel K1 (``csrc/rollout.cu``) at several block
sizes and launch bounds, print what the compiler made of each instance, and
time the builds in turns on one GPU.

    python3 tools/torch_k1_blocks.py [--csrc DIR ...] [--pair A,R ...]
        [--no-time] [--cell CONFIG[,KEY=VALUE...]:B ...]
        [lib | THREADS[:MIN_BLOCKS] ...]

``lib`` is ``rollout.cu`` as the library builds it: each instance's
launch bounds of ``K1_MAX_THREADS<A, R>``, and ``k1_threads``' block size
from B. A
variant ``THREADS[:MIN_BLOCKS]`` is a copy of the ``csrc/`` whose
``rollout.cu`` launches every instance at THREADS threads a CTA, whatever
B, with ``__launch_bounds__(THREADS, MIN_BLOCKS)``. Every variant's
``rollout.cu`` is compiled as ``build.py`` compiles it, all of them at
once, into a library of its own under the port's ``kernels/_build/
k1_blocks/``, and the script prints one line per variant: ``{"variant",
"csrc", "instances": {"A,R": {"registers", "stack_frame", "spill_stores",
"spill_loads", "ldl", "stl", "instructions"}}}``, the first four from
``-Xptxas -v``, the rest from the instance's SASS (``cuobjdump -sass``):
its local loads and stores and its instructions. ``--csrc DIR``
(repeatable) builds another ``csrc/`` instead of the port's (a parent's,
whose C entry may differ: ``lib`` and ``--no-time`` only). ``--pair A,R``
(repeatable) builds each variant for that (agents, queue) pair alone, as
``build.pair_library`` does (``-DWH_PAIR_A=A -DWH_PAIR_R=R``), instead of
the four presets; its label gains ``@aAqR``.

Unless ``--no-time``, each cell ``CONFIG[,KEY=VALUE...]:B`` (a preset of
``config.py`` with integer overrides, e.g.
``large,num_agents=12,queue_capacity=24,init_requests=12:8192``, and a
batch; default medium:131072 shelves:131072 large:131072 medium:4096
shelves:4096) runs one greedy episode (T = max_steps from a batched reset)
through ``kernels.rollout.greedy_rollout_launch`` on each build's library
that holds the cell's pair, its outputs held bit-equal to the first such
build's, and times it (the median of 5 by CUDA events, the wrapper inside)
in turns: the builds in order, then in reverse. One line per cell:
``{"cell", "T", "ms_in_turns": {variant: [ms, ms]}}``. The card's name and
power limit come first.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from warehouse_tpu_torch.kernels import build  # noqa: E402

VARIANTS = ("lib", "32", "64", "128", "256", "512")
CELLS = ("medium:131072", "shelves:131072", "large:131072", "medium:4096",
         "shelves:4096")
INSTANCE = re.compile(r"greedy_rollout_kernelILi(\d+)ELi(\d+)E")
# A SASS line that holds an instruction: /*offset*/ [predicate] OPCODE.
OPCODE = re.compile(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?[A-Z]")
# rollout.cu's block size and launch bounds, as a fixed variant rewrites
# them: (pattern, replacement with {threads} and {bounds}).
PATCHES = (
    (r"(constexpr int K1_MAX_THREADS =)[^;]+;", r"\g<1> {threads};"),
    (r"(int k1_threads\(int max_threads, long B, int sms\) \{).*?\n\}",
     r"\g<1>\n  return max_threads;\n}}"),
    (r"__launch_bounds__\(K1_MAX_THREADS<A, R>\)",
     r"__launch_bounds__({bounds})"),
)


def variant_source(csrc: Path, variant: str, out: Path) -> Path:
    """A copy of ``csrc`` in ``out``, its ``rollout.cu`` patched to the
    fixed block size of ``variant`` (``lib``: unchanged)."""
    shutil.copytree(csrc, out, dirs_exist_ok=True)
    if variant == "lib":
        return out / "rollout.cu"
    threads, _, min_blocks = variant.partition(":")
    bounds = f"{threads}, {min_blocks}" if min_blocks else threads
    src = (out / "rollout.cu").read_text()
    for pattern, repl in PATCHES:
        src, n = re.subn(pattern, repl.format(threads=threads, bounds=bounds),
                         src, flags=re.S)
        if n != 1:
            raise RuntimeError(f"{csrc}/rollout.cu: {pattern!r} matched "
                               f"{n} times, not once")
    (out / "rollout.cu").write_text(src)
    return out / "rollout.cu"


def compile_all(jobs: dict) -> dict:
    """``{label: (source, dir, defines)}`` -> ``{label: (object, library,
    log)}``: every ``nvcc -c`` started together, then each link."""
    nvcc = build.nvcc_path()
    procs = {}
    for label, (src, out, defines) in jobs.items():
        cmd = build.compile_command(nvcc, src, out / "rollout.o", defines)
        procs[label] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
    done = {}
    for label, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {label}: {log[-3000:]}")
        out = jobs[label][1]
        obj, lib = out / "rollout.o", out / "librollout.so"
        link = subprocess.run([nvcc, *build.ARCH_FLAGS, "-shared", "-o",
                               str(lib), str(obj)], capture_output=True,
                              text=True)
        if link.returncode:
            raise RuntimeError(f"link {label}: {link.stderr[-3000:]}")
        done[label] = (obj, lib, log)
    return done


def ptxas_report(log: str) -> dict:
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = INSTANCE.search(line)
            cur = (out.setdefault(f"{m.group(1)},{m.group(2)}", {}) if m
                   else None)
        elif cur is not None and "stack frame" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            cur.update(stack_frame=nums[0], spill_stores=nums[1],
                       spill_loads=nums[2])
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
    return out


def sass_local_ops(obj: Path) -> dict:
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass", str(obj)], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"cuobjdump: {res.stderr[-2000:]}")
    out, cur = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            m = INSTANCE.search(line)
            cur = (out.setdefault(f"{m.group(1)},{m.group(2)}",
                                  {"ldl": 0, "stl": 0, "instructions": 0})
                   if m else None)
        elif cur is not None:
            cur["ldl"] += bool(re.search(r"\bLDL(\.\w+)*\b", line))
            cur["stl"] += bool(re.search(r"\bSTL(\.\w+)*\b", line))
            cur["instructions"] += bool(OPCODE.match(line))
    return out


def load(lib_path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.wh_greedy_rollout
    fn.argtypes = build.SIGNATURES["wh_greedy_rollout"]
    fn.restype = ctypes.c_int
    return lib


def cell_config(cell: str):
    """``CONFIG[,KEY=VALUE...]:B`` -> (the config, B)."""
    from warehouse_tpu_torch import config

    spec, B = cell.split(":")
    name, *kvs = spec.split(",")
    kw = {k: int(v) for k, v in (kv.split("=") for kv in kvs)}
    return getattr(config, f"{name}_config")(**kw), int(B)


def time_cell(libs: dict, pairs: dict, cell: str) -> dict | None:
    import torch

    import chip_smoke as cs
    from warehouse_tpu_torch.kernels import rollout

    cfg, B = cell_config(cell)
    shape = (cfg.num_agents, cfg.queue_capacity)
    libs = {v: lib for v, lib in libs.items()
            if (pairs[v] or build.PRESET_SHAPES).count(shape)}
    if not libs:
        return None
    state, _ = cs.reset_envs(cfg, B, cs.SEED, torch.device("cuda", 0))
    T = cfg.max_steps
    want, times = None, {v: [] for v in libs}
    for v in [*libs, *reversed(list(libs))]:
        run = lambda lib=libs[v]: rollout.greedy_rollout_launch(
            lib, cfg, state, T)
        got = run()
        if want is None:
            want = got
        elif not (cs.state_equal(got[0], want[0])
                  and torch.equal(got[1], want[1])
                  and cs.bits_equal(got[2], want[2])):
            raise AssertionError(f"{cell}: build {v} differs from "
                                 f"{next(iter(libs))}")
        times[v].append(cs.timed(run, 5))
    return {"cell": cell, "T": T, "ms_in_turns": times}


def main(argv) -> int:
    csrcs, timing, cells, variants, shapes = [], True, [], [], []
    while argv:
        a = argv.pop(0)
        if a == "--csrc":
            csrcs.append(Path(argv.pop(0)).resolve())
        elif a == "--pair":
            shapes.append(tuple(int(x) for x in argv.pop(0).split(",")))
        elif a == "--no-time":
            timing = False
        elif a == "--cell":
            cells.append(argv.pop(0))
        else:
            variants.append(a)
    csrcs, variants = csrcs or [build.CSRC], variants or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    root = build.BUILD_DIR / "k1_blocks" / str(os.getpid())
    jobs, origin, pairs = {}, {}, {}
    for n, csrc in enumerate(csrcs):
        for v in variants:
            for shape in shapes or [None]:
                label = v if len(csrcs) == 1 else f"{csrc}@{v}"
                out = root / f"{n}_{v.replace(':', '_')}"
                defines = ()
                if shape:
                    label += "@a{}q{}".format(*shape)
                    out = out.with_name(out.name + "_a{}q{}".format(*shape))
                    defines = build.pair_defines(*shape)
                jobs[label] = (variant_source(csrc, v, out), out, defines)
                origin[label] = csrc
                pairs[label] = (shape,) if shape else ()
    libs = {}
    for label, (obj, lib, log) in compile_all(jobs).items():
        report = ptxas_report(log)
        for inst, ops in sass_local_ops(obj).items():
            report.setdefault(inst, {}).update(ops)
        print(json.dumps({"variant": label, "csrc": str(origin[label]),
                          "instances": report}), flush=True)
        libs[label] = lib
    if timing:
        loaded = {v: load(p) for v, p in libs.items()}
        for cell in cells or CELLS:
            line = time_cell(loaded, pairs, cell)
            if line:
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
