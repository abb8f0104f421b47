"""Build and load the port's CUDA kernels.

Every ``*.cu`` source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc -c`` per source, all started together, and linked
into one shared library with a plain C interface that ``ctypes`` loads.
The library is built at first use into ``build/torch_kernels/`` at the root
of the checkout and rebuilt whenever the sources' hash changes.  Nothing is
compiled when this module is imported.  Without ``nvcc`` the build raises:
there is no fall-back to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
CHECKOUT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = CHECKOUT / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_U = ctypes.c_uint
# C entry points: name -> argtypes.  Each returns cudaGetLastError() as int.
SIGNATURES = {
    # x, scale, y, n, d, eps, x_bf16, scale_bf16, lanes_log2, vecs_per_lane,
    # sms, stream
    "rmsnorm_launch": (_P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _I, _P),
    # x, scale, dy, dx, partial, dscale, n, d, eps, x_bf16, scale_bf16, blocks,
    # stream
    "rmsnorm_bwd_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _P),
    # x, scale, dy, dx, partial, dscale, n, d, eps, scale_bf16, blocks, stream
    "rmsnorm_bwd_regs_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _P),
    # q, k, v, o, lse (or NULL), b, tq, tk, hkv, g, dh, causal, window,
    # q_offset, kv_len, scale, stream (fma: fp32; mma: bf16)
    "flash_fma_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _F, _P),
    "flash_mma_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _F, _P),
    # q, o, do, lse, delta, qs (or NULL), rowstat (or NULL), rows, tq, hkv, g,
    # dh, rs_rows, scale, is_bf16, stream
    "flash_bwd_delta_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                               _P),
    # qs, k, v, do, rowstat, dq, dk, dv, b, tq, tk, hkv, g, dh, rs_rows, causal,
    # window, q_offset, kv_len, scale, stream (bf16)
    "flash_bwd_wgmma_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _F, _P),
    # qs, k, v, do, rowstat, pieces, npieces, tiles, partials, dq, dk, dv, b, tq,
    # tk, hkv, g, rs_rows, causal, window, q_offset, kv_len, scale, stream (bf16,
    # dh 256)
    "flash_bwd_wgmma256_launch": (_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # q, k, v, do, lse, delta, [qs, rowstat: mma only,] dq, dk, dv, b, tq, tk,
    # hkv, g, dh, causal, window, q_offset, kv_len, scale, stream (mma: bf16;
    # fma: fp32)
    "flash_bwd_mma_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _F, _P),
    "flash_bwd_fma_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _F, _P),
    # q, k, v, part, b, tq, tk, hkv, g, dh, causal, window, q_offset, kv_len,
    # nsplit, chunk, scale, stream
    "flash_split_partials_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                    _I, _I, _I, _I, _I, _F, _P),
    # part, o, b, tq, hkv, g, dh, nsplit, stream
    "flash_split_merge_launch": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, ks (or NULL), vs (or NULL), tables, kvl (int64), part, o, b, tq,
    # hkv, g, dh, bs, max_blocks, n_blocks, kv_int8, body, q_fp32, nsplit, chunk,
    # scale, stream
    "flash_paged_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # a, b, h0 (or NULL), h, h_last (or NULL), starts (or NULL), summary (or
    # NULL), B, T, C, nchunks, chunk_len, is_bf16, stream
    "rglru_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, wr, br, wi, bi, lam, h0 (or NULL), h, h_last, starts (or NULL), summary
    # (or NULL), B, T, C, nchunks, chunk_len, x_bf16, w_bf16, stream
    "rglru_gated_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _P),
    # a, b, dh, da, db, starts (or NULL), summary (or NULL), B, T, C, nchunks,
    # chunk_len, is_bf16, stream
    "rglru_bwd_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, wr, br, wi, bi, lam, dh, dx, partials, starts (or NULL), summary (or
    # NULL), dwr, dbr, dwi, dbi, dlam, B, T, C, nchunks, chunk_len, x_bf16,
    # w_bf16, stream
    "rglru_gated_bwd_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, q, s, rows, L, nb, x_bf16, stochastic, k_lo, k_hi, step (or NULL),
    # offset, vec, blocks, stream
    "quantize_launch": (_P, _P, _P, _LL, _I, _I, _I, _I, _U, _U, _P, _U, _I, _I, _P),
    # q, s, out, rows, L, nb, chunks, out_bf16, vec, blocks, stream
    "dequantize_launch": (_P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _P),
}


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from src/repro_torch/kernels/csrc at first use")
    return nvcc


def build_library(build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Compile (if the hash changed) and return the path of the ``.so``.

    The compiler's output, ``-Xptxas -v`` register and shared-memory
    counts included, is kept beside the library as ``<name>.log``.
    """
    if build_dir == BUILD_DIR and not (CHECKOUT / "src" / "repro_torch").is_dir():
        raise RuntimeError(
            f"repro_torch is not running from src/ of a checkout ({CHECKOUT} has no "
            "src/repro_torch): run it with PYTHONPATH=src from the checkout, so the "
            "kernels build inside it and not beside an installed copy")
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / f"libreprotorch_{source_hash()}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        objs, procs = [], []
        for src in (p for p in sources() if p.suffix == ".cu"):
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc={proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_lib = pathlib.Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc={link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        lib.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp_lib, lib)  # atomic: a reader never sees half a file
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, with ``argtypes``/``restype`` declared."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def sm_count(device_index: int) -> int:
    """The SM count of a CUDA device, which the kernels' plans size their grids by."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# Listeners of each launch's work (``roofline/op_stats.py`` counts a step's
# with them): a wrapper calls :func:`report` as it launches its kernel.
LISTENERS: list = []


def tensor_bytes(*ts) -> int:
    """The bytes of ``ts`` (None skipped): each read or written once."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def report(kernel: str, nbytes: float, dot_flops: float = 0.0) -> None:
    """One launch of ``kernel``: the bytes it must move (each input read
    once, each output written once) and the operations of its matrix
    products, the counts of its ``bound_ms`` (``PERF.md``'s kernel table),
    handed to every listener."""
    for fn in LISTENERS:
        fn(kernel, float(dot_flops), float(nbytes))


def check(err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
