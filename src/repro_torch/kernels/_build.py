"""Build the package's CUDA kernels and load them through ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so`` beside this file,
at first use; the hash covers the source and the flags, so an edited source
is rebuilt. Nothing is built or imported when this module is imported.
Also keeps the ticket counters the kernels that count their blocks share
(:func:`tickets`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> Tuple[str, ...]:
    """Names of every kernel source under ``csrc/``."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): "
                           "the CUDA kernels are built on a machine with the "
                           "CUDA toolkit")
    return str(path)


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    process per source, all started together. Returns ``name -> compiler
    output`` (``-Xptxas -v``: registers, shared memory and spills per
    kernel) for every source, kept beside its library when it was built
    earlier; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in sources():
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{logs[name]}")
        else:
            out.with_suffix(".log").write_text(logs[name])
            os.replace(tmp, out)  # atomic: a half-written library never loads
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    for name in sources():
        log = _target(name).with_suffix(".log")
        if name not in logs and log.exists():
            logs[name] = log.read_text()
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    out = _target(name)
    if not out.exists():
        build_all()
    return ctypes.CDLL(str(out))


#: The largest size an ``int`` field of a kernel's argument struct holds.
INT32_MAX = 2**31 - 1


def check_int_sizes(op: str, **sizes: int) -> None:
    """Raise ``ValueError`` for a size a kernel's ``int`` field cannot
    hold: ``ctypes.c_int`` would wrap it silently and launch the kernel on
    the wrong width."""
    for name, n in sizes.items():
        if n > INT32_MAX:
            raise ValueError(f"{op}: {name} = {n} is over the kernel's limit "
                             f"of 2**31 - 1 = {INT32_MAX} (an int field of "
                             f"its argument struct)")


_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def tickets(dev: torch.device, n: int) -> torch.Tensor:
    """The int32 ticket counters of the current stream of ``dev``, at least
    ``n``, zeroed once when made on that stream. A kernel that takes
    tickets leaves them at 0 (the last block of each group resets its
    own), so calls in the stream's order reuse them, kernels of different
    sources included, and calls on two streams at once never share one."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 64), dtype=torch.int32,
                                        device=dev)
    return t
