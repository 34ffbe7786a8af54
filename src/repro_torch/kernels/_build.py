"""Build and load the port's CUDA kernels.

Every source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` —
one ``nvcc`` process per source, all started together — and linked into
one shared library with a plain C interface, loaded with ``ctypes``.
The build happens at first use, into ``build/kernels/`` at the root of
the checkout, under a name that carries the hash of the sources and the
flags: a changed source builds anew, an unchanged one loads what is
there.  Nothing here runs when the module is imported.

A second path, :func:`build_generated`, builds a source the port
generates at run time (a map chain's kernel, ``map_chain.py``) into a
shared library of its own under the same directory, keyed by the hash of
its text and flags, with ``-fmad=false`` so that its arithmetic rounds
as the generic emitter's separate PyTorch operators do.  Its ``nvcc``
failing raises :class:`GeneratedBuildError`, the one build failure the
evaluate pipeline's kernel-failure rung acts on; every other failure
here (no ``nvcc``, the kernel library's own build, a CUDA error a C
entry returns) raises ``RuntimeError``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: flags of a generated source: no fused multiply-add contraction and no
#: fast math, so +, -, *, / and sqrt round as PyTorch's operators do
GEN_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-shared",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: what the last load did: {"built": bool, "seconds": float, "path": str,
#: "log": str (nvcc's output, ptxas register/spill lines included)}
build_info: dict = {}

_P = ctypes.c_void_p
_C_SIGNATURES = {
    # (dtype, vals, pred, n, a, partials, nblocks, out, stream)
    "weld_filter_reduce_sum": (
        ctypes.c_int, _P, _P, ctypes.c_longlong, ctypes.c_int, _P,
        ctypes.c_int, _P, _P),
    # (dtype, seg, vals, n, k, window, d, replicas, tiles, nblocks,
    #  partials, out, stream)
    "weld_segment_sum": (
        ctypes.c_int, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P),
    # (dtype, cols, k, lo, hi, val, n, partials, nblocks, out, stream)
    "weld_filter_reduce_q6": (
        ctypes.c_int, _P, ctypes.c_int, _P, _P, _P, ctypes.c_longlong, _P,
        ctypes.c_int, _P, _P),
    # (dtype, launch, a, b, c, m, n, k, stream)
    "weld_tiled_matmul": (
        ctypes.c_int, ctypes.c_int, _P, _P, _P, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, _P),
    # (keys, n, cap_table, slots, table, used, stream)
    "weld_hash_to_slot": (
        _P, ctypes.c_longlong, ctypes.c_int, _P, _P, _P, _P),
    # (table, cap, count, queries, n, pos, found, stream)
    "weld_dict_probe": (
        _P, ctypes.c_int, _P, _P, ctypes.c_longlong, _P, _P, _P),
    # (table, cap, count, queries, n, offsets, pos, found, sizes, stream)
    "weld_group_probe": (
        _P, ctypes.c_int, _P, _P, ctypes.c_longlong, _P, _P, _P, _P, _P),
    # (slots, n, num_slots, out, stream)
    "weld_slot_hist": (_P, ctypes.c_longlong, ctypes.c_int, _P, _P),
    # (q, k, v, o, strides[12], batch, heads, group, sq, skv, d, causal,
    #  scale, stream): f32
    "weld_flash_attention": (
        _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, _P),
    # (q, k, v, o, strides[12], plan[6], batch, heads, group, sq, skv, d,
    #  causal, scale, stream): bf16; plan: the three maps' widths, DP, kv
    #  rows, shared memory (flash_attention.sm90_plan)
    "weld_flash_attention_sm90": (
        _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, _P),
    # (n, desc[8 n], batch, d, w, stream)
    "weld_flash_attention_pack": (
        ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P),
    # (p_dtype, g_dtype, p, g, m, v, n, lr, b1, 1 - b1, b2, 1 - b2, eps, wd,
    #  c1, c2, stream)
    "weld_fused_adamw": (
        ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, ctypes.c_longlong,
        *(ctypes.c_float,) * 9, _P),
}


class GeneratedBuildError(RuntimeError):
    """``nvcc`` refused a source generated at run time."""


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are built from source at first use")
    return found


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load()
        return _lib


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _load() -> ctypes.CDLL:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    tag = h.hexdigest()[:16]
    out = BUILD_DIR / f"libweldkernels-{tag}.so"
    t0 = time.perf_counter()
    built = not out.exists()
    log = _build(out, tag) if built else ""
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _C_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.weld_error_string.argtypes = [ctypes.c_int]
    lib.weld_error_string.restype = ctypes.c_char_p
    build_info.update(built=built, seconds=time.perf_counter() - t0,
                      path=str(out), log=log)
    return lib


def _build(out: Path, tag: str) -> str:
    nvcc = nvcc_path()
    work = BUILD_DIR / f"obj-{tag}-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    cus = [p for p in _sources() if p.suffix == ".cu"]
    objs = [work / (p.stem + ".o") for p in cus]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                          "-o", str(obj)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for src, obj in zip(cus, objs)
    ]
    logs, failed = [], []
    for src, p in zip(cus, procs):
        text, _ = p.communicate()
        logs.append(f"== {src.name} (rc={p.returncode})\n{text}")
        if p.returncode != 0:
            failed.append(src.name)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
    tmp = work / out.name
    link = subprocess.run(
        [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
         *[str(o) for o in objs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log += f"\n== link (rc={link.returncode})\n{link.stdout}"
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link the kernel library:\n{log}")
    os.replace(tmp, out)
    shutil.rmtree(work, ignore_errors=True)
    (BUILD_DIR / f"build-{tag}.log").write_text(log)
    return log


def check(rc: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error code."""
    if rc != 0:
        msg = library().weld_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def build_generated(text: str, name: str) -> Tuple[ctypes.CDLL, dict]:
    """Build (once per checkout) and load one generated CUDA source.
    Returns the library and what its load did: {"built": bool,
    "seconds": float (nvcc included when built), "path": str}."""
    h = hashlib.sha256(" ".join(GEN_NVCC_FLAGS).encode())
    h.update(text.encode())
    tag = h.hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{tag}.so"
    t0 = time.perf_counter()
    built = not out.exists()
    if built:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stem = f"{name}-{tag}.{os.getpid()}.{threading.get_ident()}"
        src = BUILD_DIR / f"{stem}.cu"
        tmp = BUILD_DIR / f"{stem}.so"
        src.write_text(text)
        proc = subprocess.run(
            [nvcc_path(), *GEN_NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise GeneratedBuildError(
                f"nvcc failed on the generated source {src}:\n{proc.stdout}")
        os.replace(tmp, out)
        os.replace(src, BUILD_DIR / f"{name}-{tag}.cu")
    lib = ctypes.CDLL(str(out))
    return lib, {"built": built, "path": str(out),
                 "seconds": time.perf_counter() - t0}
