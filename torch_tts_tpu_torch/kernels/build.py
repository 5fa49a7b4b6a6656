"""Build and load the package's CUDA kernels.

`csrc/*.cu` (with the `csrc/*.cuh` headers they include) compile with
nvcc, one process per source, all started together, into objects for
sm_90a (Hopper) that one more nvcc links into a shared library with a
plain C interface, loaded with ctypes. The library is
built at first use into `build/torch_kernels/<hash of sources and flags>/`
under the repository root (listed in .gitignore), so a changed source
rebuilds and an unchanged one loads at once. nvcc is found through
`CUDA_HOME`, else `torch.utils.cpp_extension.CUDA_HOME`; without it the
build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libtts_torch_kernels.so"
# one build at a time when several host threads make their first launch
# together; each wrapper's launch count is added to under a lock so that it
# stays exact when several threads launch (a server's batcher and handlers)
_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def count_launch(wrapper, n: int = 1, attr: str = "launches") -> None:
    """Add n (one by default) to `wrapper.launches` (or the counter `attr`
    names: a variant's own count), the count of its kernel's launches."""
    with _COUNT_LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + n)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, out, scratch0, scratch1, B, T, C, n_launch, meta (host int32),
    # w_ptrs, b_ptrs (host int64), stream
    "tts_mrf_fused_forward": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    # x, mask, gl, w_in, b_in, w_rs, b_rs, x_out, skip_out, save_x, save_xin,
    # wsplit, B, T, H, L, k, cluster, stream
    "tts_wn_group_forward": (_P,) * 12 + (_I,) * 6 + (_P,),
    # the same without wsplit and cluster (csrc/wn_stack_bf16.cu)
    "tts_wn_group_forward_bf16": (_P,) * 11 + (_I,) * 5 + (_P,),
    # cluster, k, out (host int32)
    "tts_wn_forward_max_clusters": (_I,) * 2 + (_P,),
    # mask, w_in, w_rs, save_x, save_xin, d_xo, d_sk, d_x, d_gl, d_w_in, d_b_in,
    # d_w_rs, d_b_rs, work, B, T, H, L, k, stream (the same for the bf16 variant)
    "tts_wn_group_backward": (_P,) * 14 + (_I,) * 5 + (_P,),
    "tts_wn_group_backward_bf16": (_P,) * 14 + (_I,) * 5 + (_P,),
    # neg_cent, t_ys, t_xs, path, bits, B, T_y, T_x, stream
    "tts_mas_forward": (_P,) * 5 + (_I,) * 3 + (_P,),
    # rows, bits, rec, n_rows, T_x, stream
    "tts_mas_chain_probe": (_P,) * 3 + (_I,) * 2 + (_P,),
    # ptrs (host int64, 35 device pointers), scalars (host float32 p_zoneout,
    # keep), B, L, D_mel, P, Dc, H1, H2, r, weights_bf16, tile_major,
    # counters (device uint32), epoch (the launch count's low 32 bits), stream
    "tts_taco_step_forward": (_P, _P) + (_I,) * 10 + (_P, _I, _P),
    # yp, window, twiddle, mel, ranges, out, B, Lp, T, n_fft, hop, n_mels, stream
    "tts_stft_mel_forward": (_P,) * 6 + (_I,) * 6 + (_P,),
    # x, w, bias, h, c, new_h, new_c, gates, B, I, H, stream
    "tts_lltm_forward": (_P,) * 8 + (_I,) * 3 + (_P,),
    # B, I, H, stream
    "tts_lltm_launch_floor": (_I,) * 3 + (_P,),
    # x, mask (or null), the slope's fp32 bits (1 for none), x_q, scale (s_x
    # and the CTAs' scratch words), B, C, C_pad (x_q's row stride), T, stream
    "tts_int8_quantize": (_P, _P, _I, _P, _P) + (_I,) * 4 + (_P,),
    # x_q, s_x, w_q, s_w, bias (or null), res (or null), out, B, T, C_pad, N,
    # k, dilation, pad_lo, T_out, phases, tile rows, tile columns, columns a
    # tile writes, stream
    "tts_int8_conv1d": (_P,) * 7 + (_I,) * 12 + (_P,),
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    nvcc = os.path.join(home, "bin", "nvcc") if home else ""
    if not nvcc or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return nvcc


def library_dir() -> Path:
    """Build directory of the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted((*CSRC.glob("*.cu"), *CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; nvcc's output,
    including ptxas's register and shared-memory report, is kept in
    `nvcc.log` beside it."""
    with _BUILD_LOCK:
        return _load_library()


def _load_library() -> ctypes.CDLL:
    out_dir = library_dir()
    lib_path = out_dir / LIB_NAME
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc, tag = nvcc_path(), os.getpid()
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = out_dir / f"{src.stem}.{tag}.o"
            objs.append(str(obj))
            procs.append((src.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for name, proc in procs:
            out = proc.communicate()[0]
            log.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{out[-4000:]}")
        tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
        if not failed:
            link = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp), *objs],
                                  capture_output=True, text=True)
            log.append(f"== link\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append(f"link ({link.returncode}):\n{link.stderr[-4000:]}")
        (out_dir / "nvcc.log").write_text("".join(log))
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_cuda_error(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} ({torch.cuda.get_device_name()})")
