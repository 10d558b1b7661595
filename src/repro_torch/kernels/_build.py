"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use by its own ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so \
         csrc/<name>.cu

No ``--use_fast_math``: the compensated chains in the kernels rely on
IEEE ``expf``/division and on explicit ``__fadd_rn``/``__fmul_rn``.
Libraries land in ``build/kernels`` at the repository root (override
with ``REPRO_TORCH_BUILD_DIR``), named by a hash of the source and of
the shared headers (``csrc/*.cuh``) so a stale build is never loaded. ``build_all`` starts every compiler at once
and waits for all of them. Nothing here runs at import time.

``launches`` counts, per kernel, the wrapper calls that launched it on
the card: each ``*_cuda`` wrapper adds one right after its C entry point
returned success, and nothing else touches the count (one
``fused_reduce`` call is one kernel launch; one ``paged_attention`` call
is the split and the merge kernel, and so is one
``paged_latent_attention`` call; one route-S matmul call is the split
and the fold kernel). ``kahan_matmul`` and ``kahan_matmul_q8`` share
the source ``kahan_matmul.cu`` and are counted apart, each route apart:
the tile route (wgmma) under those names, the split route under
``kahan_matmul_split`` / ``kahan_matmul_q8_split``;
``flash_attention_wgmma`` (bf16) and ``flash_attention_wgmma_f32`` (the
same source's f32 kernel) are the two routes of one entry point; one
``serving_head`` call is one kernel launch, and so is one ``row_norm``
call (RMS or layer norm), and so is one ``invariant_gemm`` call
(its K split's parts are folded inside the kernel).
``reset_launches`` zeroes every count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fused_reduce", "paged_attention", "paged_latent_attention",
           "flash_attention_wgmma", "kahan_matmul", "kahan_acc",
           "serving_head", "row_norm", "invariant_gemm")
KERNELS = SOURCES + ("flash_attention_wgmma_f32", "kahan_matmul_split",
                     "kahan_matmul_q8", "kahan_matmul_q8_split")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register / shared-memory report) per source
BUILD_LOG: dict[str, str] = {}
launches: dict[str, int] = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent.parent / "build" / "kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built from csrc/ on a machine with the "
                           "CUDA toolkit")
    return found


def _target(name: str) -> Path:
    text = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def build_all(names=SOURCES) -> float:
    """Compile every listed source that has no current library, one
    ``nvcc`` per source, all running at once. Returns wall seconds."""
    t0 = time.perf_counter()
    todo = [n for n in names if not _target(n).exists()]
    if todo:
        build_dir().mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n in todo:
            tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOG[n] = out
            if proc.returncode != 0:
                failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, _target(n))
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib
