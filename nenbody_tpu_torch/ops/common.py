"""Shared helpers for the hand-written CUDA kernels (counterpart of
nenbody_tpu/ops/common.py, which holds TPU rules — interpret mode, the lane
width rule, tile fitting, eye unrolling — that a GPU does not need).

Build. The kernels are CUDA C++ for sm_90a in nenbody_tpu_torch/csrc/*.cu.
At first use, `nvcc` compiles them into one shared library with a plain C
interface under build/nenbody_tpu_torch/ at the root of the checkout (a
directory .gitignore lists), named by a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is loaded as it is. The
library is loaded with ctypes; every pointer goes in as c_void_p.

Flags. -fmad=false keeps every product rounded on its own, as the plain
PyTorch versions round them: the boids rules and the eyes' coverage are
threshold tests, and a contracted multiply-add flips pairs at the boundary.
No --use_fast_math.

Dispatch. Each wrapper in the ops modules runs its kernel's plain PyTorch
version for a tensor on the CPU, and the kernel for a CUDA tensor; for any
other device, or a tensor the kernel does not take, it raises. A wrapper
adds one to its kernel's launch count each time it launches the kernel
(the counter "launches.<kernel>" of utils/profiling.py's store).

Gradients. Under torch.is_grad_enabled(), an input that requires grad
routes a forward wrapper through its torch.autograd.Function (`needs_grad`),
whose backward is the backward kernel (the plain version on the CPU).
Without grad, the forward-only launch runs and saves nothing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from ..utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nenbody_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false", "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every kernel entry point (all return cudaGetLastError()).
SIGNATURES = {
    "nbt_gravity_forces": [_P, _P, _P, _I, _I, _I, _F, _F, _I, _P],
    "nbt_gravity_plan": [_I, _I, _I, _I, _P],  # the launch shape it picks (no launch)
    "nbt_boids_velocity": [_P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _I, _P],
    "nbt_boids_plan": [_I, _I, _I, _P],  # the launch shape it picks (no launch)
    "nbt_disc_eye": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _F, _F, _F, _F, _F, _F, _F, _F, _I, _P, _P],  # ..., counters, stream
    "nbt_gravity_vjp": [_P, _P, _P, _I, _I, _F, _F, _P],
    "nbt_disc_eye_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _F, _F, _F, _F, _F, _F, _F, _F, _I, _P],
    "nbt_wireframe_eye": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _F, _F, _F, _F, _F, _F, _F, _F, _I, _P],
    "nbt_boids_partials": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _F, _F, _F, _I, _P],
    "nbt_gravity_vjp_cross": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P],
    "nbt_gravity_vjp_plan": [_I, _I, _I, _I, _P],  # the launch shape it picks (no launch)
    "nbt_boids_partials_plan": [_I, _I, _I, _I, _P],
    "nbt_wireframe_eye_bwd": [_P] * 15 + [_I, _I, _I, _I, _I, _I,
                                          _F, _F, _F, _F, _F, _F, _F, _F, _I, _P],
    # the RDMA ring (csrc/rdma_ring.cu): shard table, local shards, their
    # count, shards, blocks per shard, envs, rows per env, then each kernel's own
    "nbt_rdma_gravity": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "nbt_rdma_gravity_plan": [_I, _I, _I, _I, _P],  # the launch shape of a plan (no launch)
    "nbt_rdma_boids": [_P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P],
    "nbt_rdma_vision": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P],
    "nbt_rdma_capacity": [_I, _I, _I, _I, _P],
    "nbt_enable_peer": [_I],
}

# Largest grid y/z extent a launch may use (the batch of envs rides it).
MAX_GRID_YZ = 65535


class KernelLibrary:
    """The built shared library: its ctypes handle, the seconds the build
    took (0 when it was already built), and nvcc's -Xptxas -v report."""

    def __init__(self, path: Path, build_seconds: float, ptxas_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.ptxas_log = ptxas_log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def call(self, name: str, *args) -> None:
        """Launch through the C entry point `name`; raise on a CUDA error."""
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")


_LIB: Optional[KernelLibrary] = None
_LIB_LOCK = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
            "kernels are built from nenbody_tpu_torch/csrc at first use"
        )
    return found


def _build(sources, out: Path) -> str:
    """Compile each source to an object in parallel, link them into `out`
    (atomically, via a temporary name), and return the ptxas report."""
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp_dir = out.parent / f".tmp-{out.stem}-{os.getpid()}"
    tmp_dir.mkdir(exist_ok=True)
    procs = []
    for src in sources:
        obj = tmp_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, objs = [], []
    for src, obj, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
        log.append(f"== {src.name}\n{text.strip()}")
        objs.append(str(obj))
    tmp_lib = tmp_dir / out.name
    link = subprocess.run(
        [nvcc, "-shared", *objs, "-o", str(tmp_lib)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    report = "\n".join(log)
    tmp_lib.with_suffix(".log").write_text(report)
    os.replace(tmp_lib.with_suffix(".log"), out.with_suffix(".log"))
    os.replace(tmp_lib, out)
    shutil.rmtree(tmp_dir, ignore_errors=True)
    return report


def library_path() -> Path:
    """Where the library of these sources and flags is (or will be) built."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and their headers
        digest.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"libnenbody_kernels_{digest.hexdigest()[:16]}.so"


def kernel_library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            sources = sorted(CSRC.glob("*.cu"))
            out = library_path()
            t0 = time.perf_counter()
            if out.exists():
                report = out.with_suffix(".log").read_text()
                seconds = 0.0
            else:
                report = _build(sources, out)
                seconds = time.perf_counter() - t0
            _LIB = KernelLibrary(out, seconds, report)
        return _LIB


class Kernel:
    """One hand-written kernel: its C entry point, counting its launches. A
    kernel may have a second entry point (gravity_vjp.cu's cross form), which
    counts as a launch of the same kernel; a source may hold two kernels
    (boids.cu: the fused rules and the ring's partials, each counted on its
    own)."""

    def __init__(self, name: str, symbol: str):
        self.name = name
        self.symbol = symbol
        self.counter = profiling.LAUNCHES + name

    def launch(self, *args, entry: Optional[str] = None) -> None:
        kernel_library().call(entry or self.symbol, *args)
        profiling.tally(self.counter)


KERNELS: Dict[str, Kernel] = {
    "gravity": Kernel("gravity", "nbt_gravity_forces"),
    "boids": Kernel("boids", "nbt_boids_velocity"),
    "disc_eye": Kernel("disc_eye", "nbt_disc_eye"),
    "gravity_vjp": Kernel("gravity_vjp", "nbt_gravity_vjp"),
    "disc_eye_bwd": Kernel("disc_eye_bwd", "nbt_disc_eye_bwd"),
    "wireframe_eye": Kernel("wireframe_eye", "nbt_wireframe_eye"),
    "boids_partials": Kernel("boids_partials", "nbt_boids_partials"),
    "wireframe_eye_bwd": Kernel("wireframe_eye_bwd", "nbt_wireframe_eye_bwd"),
    "rdma_gravity": Kernel("rdma_gravity", "nbt_rdma_gravity"),
    "rdma_boids": Kernel("rdma_boids", "nbt_rdma_boids"),
    "rdma_vision": Kernel("rdma_vision", "nbt_rdma_vision"),
}
# nbt_rdma_capacity's kernel numbers
RDMA_KINDS = {"rdma_gravity": 0, "rdma_boids": 1, "rdma_vision": 2}


@functools.lru_cache(maxsize=None)
def resident_blocks(kernel: str, threads: int, device: torch.device, rows: int = 1) -> int:
    """Blocks of `threads` threads of the RDMA ring kernel `kernel` (for
    rdma_gravity, its instantiation of `rows` rows a thread) that the CUDA
    `device` holds at once on all its SMs (the occupancy calculator's count;
    0 where the device has no cooperative launch): the most a persistent
    grid whose blocks wait on each other may launch."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        kernel_library().call("nbt_rdma_capacity", RDMA_KINDS[kernel], threads, rows,
                              device.index, ctypes.addressof(out))
    return out.value


def enable_peer_access(device: torch.device, peer: torch.device) -> None:
    """Let kernels on `device` read and write `peer`'s memory; raise where
    the two cards cannot."""
    if not torch.cuda.can_device_access_peer(device.index, peer.index):
        raise RuntimeError(f"{device} cannot access {peer}'s memory (no peer access)")
    with torch.cuda.device(device):
        kernel_library().call("nbt_enable_peer", peer.index)


def reset_launch_counts() -> None:
    profiling.reset_counters(profiling.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    counts = profiling.host_counters(profiling.LAUNCHES)
    return {name: counts.get(name, 0) for name in KERNELS}


def use_kernel(*tensors: torch.Tensor | None) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (run
    the plain version); raise for any other device or a device mix. None
    (an optional input left out) is skipped."""
    devices = {t.device.type for t in tensors if t is not None}
    if devices == {"cpu"}:
        return False
    if devices == {"cuda"}:
        return True
    raise ValueError(f"the kernels take CPU or CUDA tensors on one device, got {devices}")


def check_kernel_args(name: str, *tensors: torch.Tensor) -> None:
    """The checks every kernel wrapper makes before it passes pointers."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: needs float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous tensors")
        if t.shape[-1] != 2:
            raise ValueError(f"{name}: needs [..., N, 2] tensors, got {tuple(t.shape)}")


def appearance_args(name: str, tgt: torch.Tensor, albedo: torch.Tensor | None,
                    texture: torch.Tensor | None):
    """The eye kernels' appearance arguments, checked: (albedo pointer,
    texture pointer, Ht, Wt), a null pointer for each one left out. albedo
    has one float32 per target ([..., M] against targets [..., M, 2]),
    texture is a float32 [Ht, Wt]; both contiguous on the targets'
    device."""
    for label, t in (("albedo", albedo), ("texture", texture)):
        if t is None:
            continue
        if t.device != tgt.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous float32 on {tgt.device}")
    if albedo is not None and albedo.shape != tgt.shape[:-1]:
        raise ValueError(f"{name}: albedo {tuple(albedo.shape)} must be one per target "
                         f"{tuple(tgt.shape[:-1])}")
    if texture is not None and (texture.dim() != 2 or texture.numel() == 0):
        raise ValueError(f"{name}: texture must be [Ht, Wt], got {tuple(texture.shape)}")
    ht, wt = texture.shape if texture is not None else (0, 0)
    return (None if albedo is None else albedo.data_ptr(),
            None if texture is None else texture.data_ptr(), ht, wt)


def check_pullback_args(name: str, shape, device, winner, us, ud) -> None:
    """The checks of the eyes' backward kernels: the forward's int32 winner
    index and float32 cotangents, contiguous, of the rows' shape, on the
    eyes' device."""
    if winner is None or winner.dtype != torch.int32 or winner.shape != shape:
        raise ValueError(f"{name}: needs the forward's int32 winner index {tuple(shape)}")
    for t in (winner, us, ud):
        if t.device != device or not t.is_contiguous() or t.shape != shape:
            raise ValueError(
                f"{name}: cotangents and winner must be contiguous {tuple(shape)} on {device}"
            )
    if us.dtype != torch.float32 or ud.dtype != torch.float32:
        raise TypeError(f"{name}: needs float32 cotangents")


def needs_grad(*tensors: torch.Tensor | None) -> bool:
    """True when autograd must see the op: grad mode is on and an input
    requires grad. The wrappers then route through their autograd Function."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    )


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


def flat_batch(x: torch.Tensor) -> torch.Tensor:
    """[..., N, 2] -> [B, N, 2] (a view: the tensor is contiguous)."""
    return x.reshape(-1, x.shape[-2], 2)


def check_batch(name: str, batch: int) -> None:
    if batch > MAX_GRID_YZ:
        raise ValueError(f"{name}: at most {MAX_GRID_YZ} envs in one launch, got {batch}")
