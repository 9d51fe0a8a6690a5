"""Build, load and launch the hand-written CUDA kernels.

The sources in ``dagr_tpu_torch/csrc/*.cu`` have a plain C interface
(no PyTorch headers): one ``nvcc`` per source, all started together,
compiles each to an object, and one more links them into one shared
library, in seconds.  The build happens at first use, into
``dagr_tpu_torch/_build/`` (git-ignored), under a name keyed by the
sources' and flags' hash, so an edited source is rebuilt and a stale
library is never loaded.  The library is loaded with ``ctypes``.

Every C entry point takes its CUDA stream last and returns
``cudaGetLastError()`` after its launches; ``launch`` raises on a
non-zero code, because a refused launch never runs and a later
synchronise does not report it.  A source whose kernels need more than
48 KB of shared memory exports ``dagr_<stem>_init`` (``spline_conv.cu``:
``dagr_spline_conv_init``), which raises their dynamic shared-memory
limit; each runs once, when the library is loaded, so that no launch
sets an attribute (a launch may be inside a CUDA-graph capture).

``LAUNCHES`` counts the launches per kernel name.  It is process-wide on
purpose: a run resets it, drives the main path, and reads it to show
which kernels the path went through.  ``spline_conv_block_cluster``
counts the ``spline_conv_block`` calls (already counted there) whose
16-row tiles were split over a thread-block cluster and
``spline_conv_block_rows64`` those that ran the 16-row tile's 64-row
form; ``spline_conv_block_wide`` the wide eval block's calls
(``spline_conv_wide_block``) and ``spline_conv_block_wide_split`` those
of them whose tiles were split over the depth (more than one block over
a tile's input channels).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# --fmad=false: no multiply-add contraction, so the kernels' float
# arithmetic rounds op by op as the plain PyTorch versions' does (the
# pooled positions and the NMS IoU test must agree bit for bit)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler",
    "-fPIC",
)

LAUNCHES = {"graph_search": 0, "spline_conv": 0,
            "spline_conv_block": 0, "spline_conv_block_cluster": 0,
            "spline_conv_block_rows64": 0,
            "spline_conv_block_wide": 0, "spline_conv_block_wide_split": 0,
            "voxel_pool": 0,
            "nms": 0, "graph_search_store": 0, "spline_gather_block": 0,
            "stream_accumulate": 0, "serve_search": 0,
            "serve_ring_update": 0, "cell_max": 0,
            "spline_conv_backward": 0, "voxel_pool_backward": 0}

_library = None


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdagr_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of these exact sources exists.
    The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) is kept beside it as ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = BUILD_DIR / f"objs.{os.getpid()}"
    objs.mkdir(parents=True, exist_ok=True)
    jobs = [(src, objs / f"{src.stem}.o") for src in sources()]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in jobs]
    log, failed = [], []
    for (src, _), proc in zip(jobs, procs):
        stdout, stderr = proc.communicate()
        log.append(f"== {src.name}\n{stdout}{stderr}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{stderr}")
    if not failed:
        res = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
             *(str(obj) for _, obj in jobs)], capture_output=True, text=True)
        log.append(f"== link\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stderr}")
    shutil.rmtree(objs, ignore_errors=True)
    Path(f"{out}.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        lib.dagr_error_string.argtypes = [ctypes.c_int]
        lib.dagr_error_string.restype = ctypes.c_char_p
        for src in sources():
            init = getattr(lib, f"dagr_{src.stem}_init", None)
            if init is None:
                continue
            err = init()
            if err != 0:
                msg = lib.dagr_error_string(err).decode()
                raise RuntimeError(
                    f"dagr_{src.stem}_init: CUDA error {err}: {msg}")
        _library = lib
    return _library


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launch(kernel: str, symbol: str, *args) -> None:
    """Call C entry ``symbol`` on the current stream, count one launch
    of ``kernel`` and raise if the launch was refused.

    ``args`` are typed ctypes values (``ptr(t)``, ``c_int``, ``c_float``);
    the first call sets the entry's ``argtypes`` from them, with
    ``c_void_p`` for the stream."""
    fn = getattr(library(), symbol)
    if fn.argtypes is None:
        fn.argtypes = [type(a) for a in args] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = fn(*args, stream)
    if err != 0:
        msg = library().dagr_error_string(err).decode()
        raise RuntimeError(f"{symbol}: CUDA error {err}: {msg}")
    LAUNCHES[kernel] += 1


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Wrapper precondition: every tensor on one CUDA device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
