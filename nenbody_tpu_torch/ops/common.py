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
adds one to its kernel's launch count each time it launches the kernel.

Gradients. Under torch.is_grad_enabled(), an input that requires grad
routes a forward wrapper through its torch.autograd.Function (`needs_grad`),
whose backward is the backward kernel (the plain version on the CPU).
Without grad, the forward-only launch runs and saves nothing.
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
from typing import Dict, Optional

import torch

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
    "nbt_boids_velocity": [_P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _I, _P],
    "nbt_disc_eye": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                     _F, _F, _F, _F, _F, _F, _F, _F, _I, _P],
    "nbt_gravity_vjp": [_P, _P, _P, _I, _I, _F, _F, _P],
    "nbt_disc_eye_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _F, _F, _F, _F, _F, _F, _F, _F, _I, _P],
    "nbt_wireframe_eye": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _F, _F, _F, _F, _F, _F, _F, _F, _I, _P],
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


def kernel_library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            sources = sorted(CSRC.glob("*.cu"))
            digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
            for src in sources:
                digest.update(src.name.encode() + src.read_bytes())
            out = BUILD_DIR / f"libnenbody_kernels_{digest.hexdigest()[:16]}.so"
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
    """One hand-written kernel: its C entry point and its launch count."""

    def __init__(self, name: str, symbol: str):
        self.name = name
        self.symbol = symbol
        self.launches = 0

    def launch(self, *args) -> None:
        kernel_library().call(self.symbol, *args)
        self.launches += 1


KERNELS: Dict[str, Kernel] = {
    "gravity": Kernel("gravity", "nbt_gravity_forces"),
    "boids": Kernel("boids", "nbt_boids_velocity"),
    "disc_eye": Kernel("disc_eye", "nbt_disc_eye"),
    "gravity_vjp": Kernel("gravity_vjp", "nbt_gravity_vjp"),
    "disc_eye_bwd": Kernel("disc_eye_bwd", "nbt_disc_eye_bwd"),
    "wireframe_eye": Kernel("wireframe_eye", "nbt_wireframe_eye"),
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (run
    the plain version); raise for any other device or a device mix."""
    devices = {t.device.type for t in tensors}
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
