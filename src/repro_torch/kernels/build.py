"""Builds the CUDA sources under ``csrc/`` into one shared library, at first
use, and loads it with ``ctypes``.

Each ``*.cu`` exposes a plain C interface (no PyTorch headers), so ``nvcc``
needs seconds. One ``nvcc -c`` per source runs in parallel, then one link.
The library goes to ``build/repro_torch/`` at the root of the checkout and is
named after a hash of the sources, the headers they include and the flags, so
an edited source or header rebuilds.
A failed build or load raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    """The headers the sources include (``mma_tile.cuh``): not compiled on
    their own, but hashed with the sources, so an edited header rebuilds."""
    return sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH and under CUDA_HOME): "
                       "the CUDA kernels cannot be built on this machine")


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [*srcs, *headers()]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile (if the library for the current sources is not there yet) and
    return the library's path. ``verbose`` adds ``-Xptxas -v`` and prints
    what the compiler says (registers, shared memory, spills)."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    lib = BUILD_DIR / f"libkernels-{_digest(srcs)}.so"
    if lib.exists() and not verbose:
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if verbose else [])
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    procs = [subprocess.Popen([nvcc, *flags, "-c", str(s), "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        for s, p, log in zip(srcs, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name}:\n{log}")
            if verbose:
                print(f"--- nvcc {s.name}\n{log}", flush=True)
        tmp = BUILD_DIR / f"{tag}.so"
        link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o", str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link {lib.name}:\n{link.stdout}")
        os.replace(tmp, lib)       # atomic: a concurrent build sees all or nothing
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built library with every entry point's ``argtypes`` declared
    (without them ``ctypes`` passes pointers as 32-bit ints)."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # (q, k, v, out, lse, B, Sq, Skv, H, KVH, D, Dv, scale, causal, is_bf16, stream)
    lib.flash_attention_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr,
                                        i32, i32, i32, i32, i32, i32, i32,
                                        f32, i32, i32, ptr]
    lib.flash_attention_fwd.restype = i32
    # (q, k, v, dout, lse, delta, dq, B, Sq, Skv, H, KVH, D, Dv, scale, causal,
    #  is_bf16, key tile, grid x, y, z, stream): the tile and grid of `bwd_plan`
    lib.flash_attention_bwd_dq.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                           i32, i32, i32, i32, i32, i32, i32,
                                           f32, i32, i32, i32, i32, i32, i32, ptr]
    lib.flash_attention_bwd_dq.restype = i32
    # (q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, H, KVH, D, Dv, scale,
    #  causal, is_bf16, q_tile, grid x, y, z, cluster, heads_per_block, stream)
    lib.flash_attention_bwd_dkv.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                            i32, i32, i32, i32, i32, i32, i32,
                                            f32, i32, i32, i32, i32, i32, i32, i32, i32,
                                            ptr]
    lib.flash_attention_bwd_dkv.restype = i32
    # (B, Sq, Skv, H, KVH, D, Dv, q_tile, grid x, y, z, cluster, heads_per_block,
    #  int* max_clusters)
    lib.flash_attention_bwd_dkv_max_clusters.argtypes = [i32] * 13 + [ptr]
    lib.flash_attention_bwd_dkv_max_clusters.restype = i32
    # (q, k, v, out, int* kv_len or NULL, kv_len, B, S, H, KVH, D, scale,
    #  is_bf16, tile, cluster, grid x, device, stream): the plan of `decode_plan`
    lib.flash_decode_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr,
                                     i32, i32, i32, i32, i32, i32,
                                     f32, i32, i32, i32, i32, i32, ptr]
    lib.flash_decode_fwd.restype = i32
    # (q, k, v, out fp32, lse fp32, int* kv_len or NULL, kv_len, B, S, H, KVH,
    #  D, scale, is_bf16, tile, cluster, grid x, device, stream): the partial entry
    lib.flash_decode_partial_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                             i32, i32, i32, i32, i32, i32,
                                             f32, i32, i32, i32, i32, i32, ptr]
    lib.flash_decode_partial_fwd.restype = i32
    # (B, S, H, KVH, D, is_bf16, tile, cluster, grid x, partial, device,
    #  int* max_clusters)
    lib.flash_decode_max_clusters.argtypes = [i32] * 11 + [ptr]
    lib.flash_decode_max_clusters.restype = i32
    # (x, dt, A, b, c, y, state, B, S, H, P, N, is_bf16, route_mma, stream)
    lib.ssd_scan_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                 i32, i32, i32, i32, i32, i32, i32, ptr]
    lib.ssd_scan_fwd.restype = i32
    # (x, w_gate, w_up, w_down, y, partial or NULL, T, D, F, n_splits,
    #  f_tiles_per_split, is_bf16, stream)
    lib.fused_ffn_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                  i32, i32, i32, i32, i32, i32, ptr]
    lib.fused_ffn_fwd.restype = i32
    # (x, w_gate, w_up, w_down, y, h_scratch, T, D, F, chunk_rows, stream)
    lib.fused_ffn_tiled_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                        i32, i32, i32, i32, ptr]
    lib.fused_ffn_tiled_fwd.restype = i32
    lib.kernel_error_string.argtypes = [i32]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero return of a C entry point (a CUDA error code, or a
    negative code for an argument the kernel does not take)."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what}: launch failed with code {code}: {msg}")


def refuse_grad(what: str, *tensors) -> None:
    """A kernel writes its output through a raw pointer, so the output has no
    ``grad_fn``: called with grad mode on and an input that requires grad it
    would drop the gradient without a word. Raise instead; the autograd
    Function in ``kernels.ops`` is the caller that carries the gradient."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise RuntimeError(f"{what}: an input requires grad and grad mode is on, but the "
                           "kernel's output would carry no gradient; call it through "
                           "kernels.ops (or under torch.no_grad())")


def check_cuda_tensors(**tensors) -> None:
    """What every kernel asks of its tensor arguments: on one CUDA device, one
    dtype out of bf16 and fp32, contiguous, 16-byte aligned (the kernels load
    16 bytes at a time). A kernel whose arguments come in two dtypes checks
    each group by its own call."""
    first = next(iter(tensors.values()))
    for name, x in tensors.items():
        if not x.is_cuda:
            raise ValueError(f"{name} is on {x.device}: the kernel takes CUDA tensors "
                             "(kernels.ops takes the plain version for CPU tensors)")
        if x.device != first.device or x.dtype != first.dtype:
            raise ValueError(f"{', '.join(tensors)} must share device and dtype")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if first.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dtype {first.dtype} not supported (bfloat16, float32)")
