"""Builds the CUDA kernels of ``csrc/`` and loads them with ctypes.

The sources expose a plain C interface (no PyTorch headers), so each
compiles in seconds; a binding that includes PyTorch's headers takes
minutes per build. One ``nvcc -c`` per ``.cu`` source runs in parallel
(the ``.cuh`` headers are included by them), then one link. The library
goes to ``_build/`` under a name that hashes every file of ``csrc/``, so
an edited source or header is rebuilt and a process builds at most once.
Nothing here runs at import time.

The env kernels (K1, K2, K7, K10: ``ENV_SOURCES``) are templates on the
(agents, queue) pair ``(A, R)``. The library holds the four presets'
instances (``PRESET_SHAPES``). Any other pair gets a library of its own at
first use, ``pair_library(A, R)``: the four env sources compiled with
``-DWH_PAIR_A=A -DWH_PAIR_R=R`` (``env_tick.cuh`` ``dispatch_shape`` then
instantiates that pair alone), under a name that hashes ``csrc/`` and the
pair. It has the same C entry points; ``env_library`` picks the library of
a pair. A failed ``nvcc`` raises with its log; nothing falls back to the
plain twins.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
# (num_agents, queue_capacity) of the library's env instances: the four
# presets of config.py.
PRESET_SHAPES = ((2, 4), (4, 8), (6, 12), (8, 16))
# The sources whose kernels are templates on the pair: K1, K2, K7, K10.
ENV_SOURCES = ("rollout.cu", "act.cu", "act_rnn.cu", "act_cnn.cu")
# The env stage's threads a CTA (act_stages.cuh CNT): an env of more agents
# than this has no instance.
MAX_AGENTS = 128

P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
U = ctypes.c_uint
IP = ctypes.POINTER(ctypes.c_int)
LP = ctypes.POINTER(ctypes.c_long)

# argtypes of the C entry points: device pointers and the stream are
# c_void_p, so ctypes passes them as 64-bit values.
SIGNATURES = {
    "wh_error_string": [I],
    "wh_greedy_rollout": [I, I, L, I, I, I, I, U, I, I, U] + [F] * 5
                         + [P] * 23,
    "wh_spawn_draws": [L, I, I, U, I, I, U] + [P] * 7,
    "wh_act_weight_floats": [I, IP],
    "wh_act_workspace_floats": [I, I, L, I, IP, I],
    "wh_act_layout": [I, I, L, I, IP, I, LP],
    "wh_act_rollout": [I, I, L, I, I, I, F, I, I, I, I, F, F, F, F, F, F, I,
                       IP, P, P, I, IP, P] + [P] * 29 + [F, F, LP, P],
    "wh_act_stage": [I, I, I, I, L, I, I, I, F, I, I, I, I, F, F, F, F, F, F,
                     I, IP, P, P, I, IP, P] + [P] * 29 + [F, F, P, P],
    "wh_sgd_stage_smem_bytes": [I, IP],
    "wh_sgd_workspace_floats": [I, IP, I, L, I, I, I, IP],
    "wh_sgd_layout": [I, IP, I, L, I, I, I, IP, LP],
    "wh_sgd_grads": [I, IP, I, L, I, I, I, IP, I] + [P] * 9 + [F] * 5
                    + [P] * 3 + [I, P],
    "wh_sgd_stage": [I, I, IP, I, L, I, I, I, IP, I] + [P] * 9 + [F] * 5
                    + [P] * 3 + [I, P],
    "wh_sgd_clip_adam": [I, IP, I, L, I, I, I, IP, I] + [P] * 7 + [F] * 6
                        + [P] * 2,
    "wh_sgd_sumsq": [I, IP, I, L, I, I, I, IP] + [P] * 4,
    "wh_sgd_sq_layout": [I, IP, I, L, I, I, I, IP, LP],
    "wh_vtrace_workspace_floats": [I, IP, I, L, I, I],
    "wh_vtrace_layout": [I, IP, I, L, I, I, LP],
    "wh_vtrace_grads": [I, I, IP, I, L, I, I, I] + [P] * 10 + [F] * 5
                       + [P] * 3 + [LP, P],
    "wh_vtrace_clip_rms": [I, IP, I, L, I, I, I] + [P] * 4 + [F] * 4
                          + [P] * 2,
    "wh_vtrace_clip_adam": [I, IP, I, L, I, I, I] + [P] * 7 + [F] * 6
                           + [P] * 2,
    "wh_vtrace_sumsq": [I, IP, I, L, I, I] + [P] * 4,
    "wh_vtrace_sq_layout": [I, IP, I, L, I, I, LP],
    "wh_rnn_param_floats": [I, IP, I, I],
    "wh_act_rnn_workspace_floats": [I, I, L, I, IP, I, I],
    "wh_act_rnn_layout": [I, I, L, I, IP, I, I, LP],
    "wh_act_rnn_rollout": [I, I, L, I, I, I, F, I, I, I, F, F, F, F, F, F, I,
                           IP, I, I] + [P] * 33 + [LP, P],
    "wh_act_rnn_stage": [I, I, I, I, L, I, I, I, F, I, I, I, F, F, F, F, F, F,
                         I, IP, I, I] + [P] * 34 + [LP, P],
    "wh_rnn_sgd_smem_bytes": [I, IP, I, I],
    "wh_rnn_sgd_workspace_floats": [I, IP, I, I, I, L, I, I],
    "wh_rnn_sgd_grads": [I, IP, I, I, I, L, I, I, I] + [P] * 11 + [F] * 5
                        + [P] * 3 + [I, P],
    "wh_rnn_sgd_stage": [I, I, IP, I, I, I, L, I, I, I] + [P] * 11
                        + [F] * 5 + [P] * 3 + [I, P],
    "wh_rnn_sgd_layout": [I, IP, I, I, I, L, I, I, LP],
    "wh_rnn_sgd_clip_adam": [I, IP, I, I, I, L, I, I, I] + [P] * 7 + [F] * 6
                            + [P] * 2,
    "wh_rnn_sgd_sumsq": [I, IP, I, I, I, L, I, I] + [P] * 4,
    "wh_rnn_sgd_sq_layout": [I, IP, I, I, I, L, I, I, LP],
    "wh_cnn_param_floats": [I] * 5,
    "wh_act_cnn_smem_bytes": [I] * 8 + [IP],
    "wh_act_cnn_workspace_floats": [I, I, L] + [I] * 6,
    "wh_act_cnn_layout": [I, I, L] + [I] * 6 + [LP],
    "wh_act_cnn_rollout": [I, I, L, I, I, I, F, I, I, I, I, F, F, F, F, F, F,
                           I, I, I, I, I, IP] + [P] * 32 + [F, F, P],
    "wh_act_cnn_stage": [I, I, I, L, I, I, I, F, I, I, I, I, F, F, F, F, F, F,
                         I, I, I, I, I, IP] + [P] * 32 + [F, F, P, P],
    "wh_cnn_sgd_smem_bytes": [I] * 5,
    "wh_cnn_sgd_small_tile": [I] * 5,
    "wh_cnn_sgd_workspace_floats": [I] * 6 + [L, I, I],
    "wh_cnn_sgd_grads": [I] * 6 + [L, I, I, I] + [P] * 9 + [F] * 5
                        + [P] * 3 + [I, P],
    "wh_cnn_sgd_stage": [I] * 7 + [L, I, I, I] + [P] * 9 + [F] * 5
                        + [P] * 3 + [I, P],
    "wh_cnn_sgd_layout": [I] * 6 + [L, I, I, LP],
    "wh_cnn_sgd_clip_adam": [I] * 6 + [L, I, I, I] + [P] * 7 + [F] * 6
                            + [P] * 2,
    "wh_cnn_sgd_sumsq": [I] * 6 + [L, I, I] + [P] * 4,
    "wh_cnn_sgd_sq_layout": [I] * 6 + [L, I, I, LP],
}
RESTYPES = {"wh_act_weight_floats": L, "wh_act_workspace_floats": L,
            "wh_error_string": ctypes.c_char_p,
            "wh_sgd_stage_smem_bytes": L,
            "wh_sgd_workspace_floats": L,
            "wh_vtrace_workspace_floats": L, "wh_rnn_param_floats": L,
            "wh_act_rnn_workspace_floats": L, "wh_rnn_sgd_smem_bytes": L,
            "wh_rnn_sgd_workspace_floats": L, "wh_cnn_param_floats": L,
            "wh_act_cnn_smem_bytes": L, "wh_act_cnn_workspace_floats": L,
            "wh_cnn_sgd_smem_bytes": L,
            "wh_cnn_sgd_workspace_floats": L}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.insert(0, os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources_digest() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def compile_command(nvcc: str, src: Path, obj: Path,
                    defines=()) -> list[str]:
    """``nvcc -c`` of one source, with ``-D`` ``defines``."""
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
            "-Xptxas=-v", *(f"-D{d}" for d in defines), "-c", "-o",
            str(obj), str(src)]


def _compile(stem: str, sources, tmp: Path, defines=()) -> None:
    """One ``nvcc -c`` per source, all started together, then one link
    into ``tmp``; the log goes to ``build-{stem}.log``. Raises
    ``RuntimeError`` with the failed commands' errors and the log's path."""
    nvcc, log = nvcc_path(), []
    jobs = []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}-{stem}.{os.getpid()}.o"
        cmd = compile_command(nvcc, src, obj, defines)
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err[-4000:]}")
    objs = [str(obj) for _, obj, _ in jobs]
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stderr[-4000:]}")
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    log_path = BUILD_DIR / f"build-{stem}.log"
    log_path.write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed (the whole log: {log_path}): "
                           + "\n".join(failed))


def _load(lib_path: Path, stem: str, sources, defines=()) -> ctypes.CDLL:
    """Build ``lib_path`` unless it exists, load it and set the
    signatures of the C entry points it has."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not lib_path.exists():
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        _compile(stem, sources, tmp, defines)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = RESTYPES.get(name, I)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Compile ``csrc/*.cu`` (once per source digest) and load it."""
    digest = _sources_digest()
    return _load(BUILD_DIR / f"libwarehouse_kernels-{digest}.so", digest,
                 sorted(CSRC.glob("*.cu")))


def pair_digest(A: int, R: int) -> str:
    """The hash of ``csrc/`` and the pair that names a pair's library."""
    return hashlib.sha256(
        f"{_sources_digest()}:{int(A)}:{int(R)}".encode()).hexdigest()[:16]


def pair_stem(A: int, R: int) -> str:
    """A pair's library and log name: ``env-a{A}-q{R}-{pair_digest}``."""
    return f"env-a{int(A)}-q{int(R)}-{pair_digest(A, R)}"


def pair_defines(A: int, R: int) -> tuple[str, str]:
    return (f"WH_PAIR_A={int(A)}", f"WH_PAIR_R={int(R)}")


def check_pair(A: int, R: int) -> None:
    """Raise ``ValueError`` for a pair no env kernel can instantiate."""
    if not (1 <= A <= MAX_AGENTS and R >= 1):
        raise ValueError(
            f"the CUDA env kernels take 1 to {MAX_AGENTS} agents (a thread "
            f"of the env stage's {MAX_AGENTS} samples each agent's row) and a "
            f"queue of at least 1, got (num_agents, queue_capacity) = "
            f"({A}, {R})")


@functools.lru_cache(maxsize=None)
def pair_library(A: int, R: int) -> ctypes.CDLL:
    """The env kernels K1, K2, K7 and K10 instantiated for (A, R) alone:
    ``ENV_SOURCES`` compiled with ``pair_defines`` (once per source digest
    and pair; a process builds a pair at most once) and loaded. The
    learners are the library's."""
    check_pair(A, R)
    stem = pair_stem(A, R)
    return _load(BUILD_DIR / f"libwarehouse_{stem}.so", stem,
                 [CSRC / s for s in ENV_SOURCES], pair_defines(A, R))


def env_library(A: int, R: int) -> ctypes.CDLL:
    """The library whose env kernels take (A, R): ``library()`` for a
    preset, else ``pair_library(A, R)``."""
    if (int(A), int(R)) in PRESET_SHAPES:
        return library()
    return pair_library(int(A), int(R))


def build_log(A: int | None = None, R: int | None = None) -> str:
    """The compiler's output (``-Xptxas=-v``) for the current sources: the
    library's, or with a pair that pair's library's."""
    stem = _sources_digest() if A is None else pair_stem(A, R)
    path = BUILD_DIR / f"build-{stem}.log"
    return path.read_text() if path.exists() else ""


def check(err: int, what: str, lib: ctypes.CDLL | None = None) -> None:
    """Raise if a C entry point (of ``lib``, the library by default)
    returned a CUDA error code."""
    if err:
        name = (lib or library()).wh_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name})")


def smem_limit(device, default: int) -> int:
    """Bytes of shared memory a block may opt in to on ``device``
    (``default`` where torch does not report it)."""
    import torch

    return getattr(torch.cuda.get_device_properties(device),
                   "shared_memory_per_block_optin", default)


def int_array(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
