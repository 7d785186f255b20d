"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process for ``sm_90a``
(all started together), then linked into one shared library with a plain C
interface that ``ctypes`` loads.  The library sits under
``build/repro_torch/<hash>/`` at the checkout's root, named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one is
reused.  Nothing is built or loaded at import: the first kernel launch
builds.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.

:func:`dry_run` is the dry run's context (``launch/dryrun.py``): inside
it a wrapper checks its fake inputs and allocates its fake outputs and
workspaces as always, then records the call (:func:`dry`) and returns
before any ``data_ptr()``, :func:`stream_ptr` or :func:`lib` call.
Nothing is computed and the outputs hold nothing.  Outside it a fake
tensor that reaches a wrapper raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C signature of every entry point: (argtypes), all return int.
SIGNATURES = {
    "repro_dispatch_build": [P, I, I, I, I, P, P, P, P, P, P],
    "repro_noop": [I, I, P],
    "repro_gather_gmm": [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                         P],
    "repro_gmm_dw": [I, P, P, P, P, I, I, I, I, P],
    "repro_flash_attention": [I, I, P, P, P, P, I, I, I, I, I, I, I, F, F,
                              P],
    "repro_combine": [I, P, P, P, P, I, I, I, P],
    "repro_paged_attention": [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                              I, I, F, F, P],
    "repro_fused_moe_fwd": [I, I, P, P, P, P, P, P, P, P, P, I, I, I, I,
                            I, I, P, P, I, P],
    "repro_fused_moe_bwd": [I, I, P, P, P, P, P, P, P, P, P, P, P, P, P, P,
                            P, I, I, I, I, I, I, P, P, I, P],
    "repro_fused_swiglu_fwd": [I, P, P, P, P, P, P, P, P, I, I, I, I, I,
                               P],
    "repro_fused_swiglu_bwd_x": [I, P, P, P, P, P, P, I, I, I, P],
    "repro_fused_swiglu_bwd_w": [I, P, P, P, P, P, P, I, I, I, P],
    "repro_paged_attention_int8": [I, P, P, P, P, P, P, P, P, P, P, I, I, I,
                                   I, I, I, I, I, F, F, P],
    "repro_gather_rows": [I, P, P, P, I, I, I, P],
}

_lib: ctypes.CDLL | None = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (one ``nvcc`` each, in parallel) and link the
    library; returns its path.  Reuses an existing build of the same
    sources.  Compiler output (register and shared-memory use from
    ``-Xptxas -v``) is kept in ``build.log`` beside the library."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "librepro_torch.so"
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        tmp = Path(tmp)
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, objs, failed = [], [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
            objs.append(str(obj))
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / lib_path.name), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking failed:\n{link.stdout}")
        (tmp / "build.log").write_text("\n".join(log))
        out_dir.mkdir(parents=True, exist_ok=True)
        shutil.move(str(tmp / "build.log"), out_dir / "build.log")
        os.replace(tmp / lib_path.name, lib_path)
    build_info.update(path=str(lib_path),
                      seconds=time.perf_counter() - t0, cached=False)
    return lib_path


@dataclass
class DryRecord:
    """The kernel calls of a dry run: per kernel its launches (the
    wrapper's count), operations (``kernels/cost.py``) and bytes (every
    input read and every output written once)."""

    kernels: dict = field(default_factory=dict)

    def add(self, name: str, ops: float, nbytes: int) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "ops": 0.0,
                                           "bytes": 0})
        k["launches"] += 1
        k["ops"] += float(ops)
        k["bytes"] += int(nbytes)


_DRY: list[DryRecord] = []

#: SMs of an H100 SXM, which a dry run plans the launches for when the
#: build it runs on has no card (``sm_count``)
DRY_SM_COUNT = 132


@contextlib.contextmanager
def dry_run():
    """Record the kernel calls made inside, on fake tensors, instead of
    launching them; yields the :class:`DryRecord`."""
    rec = DryRecord()
    _DRY.append(rec)
    try:
        yield rec
    finally:
        _DRY.remove(rec)


def is_dry() -> bool:
    """Whether a :func:`dry_run` is active."""
    return bool(_DRY)


def is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import is_fake as _is_fake
    return isinstance(t, torch.Tensor) and _is_fake(t)


def dry(name: str, ops: float, inputs, outputs) -> bool:
    """Called by a wrapper once its outputs and workspaces are allocated
    and before it touches a pointer.  Inside :func:`dry_run` it records
    the call and returns True (the wrapper returns its outputs
    unwritten); every tensor must then be fake.  Outside, it returns
    False (:func:`require` has refused a fake input there: a fake
    tensor's ``data_ptr()`` is no address)."""
    if not _DRY:
        return False
    ts = [t for t in (*inputs, *outputs) if t is not None]
    if not all(is_fake(t) for t in ts):
        raise RuntimeError(f"{name}: a real tensor reached the kernel "
                           "inside _lib.dry_run(), which launches nothing")
    nbytes = sum(t.numel() * t.element_size() for t in ts)
    for rec in _DRY:
        rec.add(name, ops, nbytes)
    return True


def aligned16(t: torch.Tensor) -> bool:
    """Whether ``t`` starts on a 16-byte boundary.  A fake tensor has no
    address: its storage is taken as the caching allocator places every
    block (512-byte aligned), so only its offset counts."""
    if is_fake(t):
        return t.storage_offset() * t.element_size() % 16 == 0
    return t.data_ptr() % 16 == 0


def sm_count(device: torch.device) -> int:
    """The SM count of ``device``'s card; in a dry run on a build with no
    card, :data:`DRY_SM_COUNT`."""
    if _DRY and not torch.cuda.is_available():
        return DRY_SM_COUNT
    return torch.cuda.get_device_properties(device).multi_processor_count


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def noop(device, launches: int = 1, dependent: bool = False) -> None:
    """Launch ``launches`` empty kernels on ``device``'s current stream,
    each after the first as its predecessor's programmatic dependent if
    ``dependent``: the launch floor that ``chip_smoke.py`` counts in the
    bound of a kernel launched in that pattern."""
    check("repro_noop", lib().repro_noop(
        launches, int(dependent),
        torch.cuda.current_stream(device).cuda_stream))


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, *, dtype, ndim: int,
            device=None) -> None:
    """Check what a kernel takes: a contiguous CUDA tensor of the given
    dtype, rank and device.  Raises ``ValueError`` otherwise."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if not _DRY and is_fake(t):
        raise RuntimeError(f"{name}: a fake tensor reached a kernel outside "
                           "_lib.dry_run()")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


#: dtype codes shared with the C sources (``common.cuh``)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
