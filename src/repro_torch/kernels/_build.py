"""Build and load the hand-written CUDA kernels at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  All sources build together, one
``nvcc`` process each, started at once.  The output directory is keyed by a
hash of every source and the flags, so an edited kernel rebuilds and an
unchanged one loads from ``build/`` (git-ignored) at the repository root.

``-Xptxas -v`` makes ptxas report each kernel's registers and spills; the
log is kept beside the library (:func:`resources`).

The C entry points take every pointer and the stream as ``void*`` and
return ``cudaGetLastError()``; :func:`check` raises when that is not 0.
The kernels that split a reduction over blocks and merge it in the same
launch take their partials and ticket counters from :func:`scratch`.

``csrc/index_host.cpp`` is built apart, by the host C++ compiler alone
(:func:`host_library`): the enumerators of the kernels' address arithmetic
(``csrc/index.cuh``) that ``repro_torch.analysis.bounds`` walks.  It needs
no card and no CUDA toolkit, so the bounds proofs run on any machine.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"

#: wall seconds spent compiling in this process (0.0 when loaded from cache)
BUILD_SECONDS = 0.0
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under CUDA_HOME")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source that has no library yet; returns the directory
    holding ``lib<name>.so``.  Raises with nvcc's output on failure."""
    global BUILD_SECONDS
    out = BUILD_ROOT / f"kernels-{_digest()}"
    todo = [s for s in _sources() if not (out / f"lib{s.stem}.so").exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = []
    for src in todo:
        tmp = out / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name}:\n{log}")
            continue
        (out / f"lib{src.stem}.log").write_text(log)
        os.replace(tmp, out / f"lib{src.stem}.so")
    BUILD_SECONDS += time.time() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


HOST_SOURCE = "index_host.cpp"
HOST_FLAGS = ["-std=c++17", "-O1", "-shared", "-fPIC"]
_HOST_LIBS: dict[Path, ctypes.CDLL] = {}


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (g++, c++ or clang++ on PATH, or $CXX): "
                       "the bounds proofs build csrc/index_host.cpp with it")


def host_library(csrc: Path = CSRC, build_root: Path = BUILD_ROOT) -> ctypes.CDLL:
    """The host enumerators built from ``csrc/index_host.cpp`` and the
    ``index.cuh`` beside it (``csrc`` may be a copy, as a mutation test's),
    compiled with the host C++ compiler into ``build_root/host-<hash>/``
    keyed by both sources and the flags, and loaded with ctypes.  Raises
    with the compiler's output on failure, or when there is no compiler."""
    csrc = Path(csrc)
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    for name in (HOST_SOURCE, "index.cuh"):
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    out = Path(build_root) / f"host-{h.hexdigest()[:16]}"
    so = out / "libindex_host.so"
    lib = _HOST_LIBS.get(so)
    if lib is not None:
        return lib
    if not so.exists():
        out.mkdir(parents=True, exist_ok=True)
        tmp = out / f"libindex_host.so.{os.getpid()}.tmp"
        proc = subprocess.run([_cxx(), *HOST_FLAGS, f"-I{csrc}", "-o", str(tmp),
                               str(csrc / HOST_SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"host build of {HOST_SOURCE} failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = _HOST_LIBS[so] = ctypes.CDLL(str(so))
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (builds all sources
    at first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
        _LIBS[name] = lib
    return lib


def resources(name: str) -> dict[str, dict[str, int]]:
    """Registers a thread, spill bytes and static shared memory of each
    kernel in ``csrc/<name>.cu`` as ptxas reported them at build time:
    {mangled name: {"registers", "spill_stores", "spill_loads", "smem"}}
    (dynamic shared memory is set at launch and not in the log)."""
    path = build_all() / f"lib{name}.log"
    log = path.read_text() if path.exists() else ""
    out: dict[str, dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
    return out


def bind(name: str, fn: str, argtypes: list) -> ctypes._CFuncPtr:
    """C entry ``fn`` of library ``name`` with its argument types set (so
    ctypes never truncates a pointer to a 32-bit int)."""
    f = getattr(library(name), fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def records(*tensors) -> bool:
    """Whether autograd records an op on ``tensors``: grad mode is on and
    one of them requires grad.  The one test behind the rule "the GEMM
    differentiates (``ops.cgra_matmul``), attention runs its plain version
    (``models.layers.dense_attention``), every other kernel refuses"."""
    import torch
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(what: str, *tensors):
    """Raise when autograd would record a kernel call (:func:`records`).
    The same check on the card and on the CPU (the plain version there
    would be differentiable, the kernel is not), so a missing gradient
    shows as an error on either device instead of a weight that silently
    gets none on the card."""
    if records(*tensors):
        raise RuntimeError(
            f"{what} has no backward: call it under torch.no_grad(), or use its "
            f"differentiable entry (ops.cgra_matmul for the GEMM; the plain "
            f"attention for training)")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


_SCRATCH: dict = {}  # (device, stream) -> (partials f32, tickets int32)


def scratch(dev, stream: int, n_part: int, n_tickets: int):
    """Partials and ticket counters for a split-and-merge launch on
    ``stream`` of ``dev``, kept between calls and grown when a call needs
    more.  The counters are zeroed once, when allocated: every launch
    leaves them at 0.  Launches on one stream run in order, so every such
    kernel may share both; each stream has its own, so launches on two
    streams never race on them."""
    import torch
    key = (dev, stream)
    part, tickets = _SCRATCH.get(key, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(max(n_part, 1), dtype=torch.float32, device=dev)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(n_tickets, 1), dtype=torch.int32, device=dev)
    _SCRATCH[key] = (part, tickets)
    return part, tickets


def stream_scratch(stream: int) -> list:
    """The (partials, tickets) entries of ``stream`` on every device: what a
    CUDA graph captured on that stream launches with.  Holding them keeps
    their memory out of the allocator's hands when a later call grows an
    entry."""
    return [v for (_, s), v in _SCRATCH.items() if s == stream]
