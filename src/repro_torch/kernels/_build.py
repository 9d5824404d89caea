"""Build the port's CUDA kernels and call them through a plain C interface.

All of ``csrc/*.cu`` is compiled at first use, from this package's sources
only, by one ``nvcc`` process per source, all started together, and then
linked into one shared library::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c csrc/<name>.cu -o <name>.o     # each source
    nvcc -shared -o build/torch_kernels/um_kernels-<hash>.so *.o

The file is named by a hash of the sources and the flags, so a later call,
in this process or another, loads it without building again.  ``ptxas -v``
(registers, shared memory and spills of each kernel) and the compilers'
output go to a ``.log`` beside it.  Each C entry point launches on the
stream it is given and returns ``cudaGetLastError()``; ``launch`` raises if
that is not 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from collections.abc import Iterable
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)

# ctypes argument types: every pointer and the stream are c_void_p (a plain
# int would be cut to 32 bits), every size is c_int64.
PTR = ctypes.c_void_p
I64 = ctypes.c_int64
F64 = ctypes.c_double


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from source at "
        "first use; put the CUDA toolkit's bin/ on PATH or set CUDA_HOME")


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256()
    for flag in (*NVCC_FLAGS, "--link", *LINK_FLAGS):
        h.update(flag.encode() + b"\0")
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    return BUILD_DIR / f"um_kernels-{h.hexdigest()[:16]}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built first if it is not there yet."""
    so = library_path()
    if not so.exists():
        _build(nvcc(), so)
    lib = ctypes.CDLL(str(so))
    lib.um_error_string.argtypes = [ctypes.c_int]
    lib.um_error_string.restype = ctypes.c_char_p
    return lib


def _build(compiler: str, so: Path) -> None:
    """Compile every source at once, one nvcc process each, then link."""
    work = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    work.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    objects = [work / f"{src.stem}.o" for src in sources]
    logs = [work / f"{src.stem}.log" for src in sources]
    procs = []
    for src, obj, log in zip(sources, objects, logs):
        with open(log, "w") as out:
            procs.append(subprocess.Popen(
                [compiler, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=out, stderr=subprocess.STDOUT))
    failed = [f"{src.name}: nvcc exited with code {code}\n{log.read_text()[-3000:]}"
              for src, log, code in zip(sources, logs, [p.wait() for p in procs])
              if code != 0]
    text = "".join(f"== {src.name}\n{log.read_text()}" for src, log in zip(sources, logs))
    if not failed:
        tmp = work / so.name
        link = subprocess.run([compiler, *LINK_FLAGS, "-o", str(tmp), *map(str, objects)],
                              capture_output=True, text=True)
        text += f"== link\n{link.stdout}{link.stderr}"
        if link.returncode != 0:
            failed.append(f"link: nvcc exited with code {link.returncode}\n"
                          f"{link.stderr[-3000:]}")
        else:
            os.replace(tmp, so)
    so.with_suffix(".log").write_text(text)
    shutil.rmtree(work, ignore_errors=True)
    if failed:
        raise RuntimeError("building the CUDA kernels failed:\n" + "\n".join(failed))


@functools.cache
def _entry(name: str, argtypes: tuple):
    fn = getattr(library(), name)
    fn.argtypes = [*argtypes, PTR]  # the stream comes last
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, argtypes: tuple, *args, device: torch.device) -> None:
    """Call C entry point ``name`` on ``device``'s current stream."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _entry(name, argtypes)(*args, stream)
    if err != 0:
        msg = library().um_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def require(name: str, tensors: Iterable[torch.Tensor],
            dtypes: tuple[torch.dtype, ...]) -> None:
    """Raise unless the tensors are contiguous, of one of ``dtypes`` and on
    one CUDA device."""
    tensors = list(tensors)
    device = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: the kernel takes tensors on one CUDA "
                             f"device, got {[str(u.device) for u in tensors]}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: the kernel takes {dtypes}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
