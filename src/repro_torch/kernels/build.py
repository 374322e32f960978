"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use (or ahead of it, through :func:`build_all`), one ``nvcc``
process per source, all started together, into ``_build/`` beside this file
(listed in ``.gitignore``).  A library's file name carries a digest of the
sources and flags, so an edited source is rebuilt and a current one is
loaded as it is.  Nothing is compiled when this module is imported.
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
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: Sources, one shared library each.
SOURCES = ("segment_reduce", "radix_sort", "flash_attention", "signature",
           "tricluster_density", "decode_attention", "rmsnorm")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the
    PATH, or the toolkit's usual place."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's kernels are built from "
        f"{CSRC} on the machine with the card")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build_all(names=SOURCES) -> Dict[str, dict]:
    """Compile every library of ``names`` that is not built yet, all at
    once.  Returns, per library, whether it was built now, the seconds it
    took and what ``nvcc`` printed (``-Xptxas -v``: registers and shared
    memory of each kernel).  Raises when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, report = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"built": False, "seconds": 0.0, "log": ""}
            continue
        fd, tmp = tempfile.mkstemp(prefix=f".lib{name}-", suffix=".so",
                                   dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            Path(tmp).unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        report[name] = {"built": True, "seconds": secs, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def on_device(dev):
    """A context in which a launch goes to ``dev``'s card: none when
    ``dev`` is already the current device (the common case, which then
    costs no device switch), else ``torch.cuda.device(dev)``."""
    import torch
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def check(lib: ctypes.CDLL, name: str, err: int,
          kernel: Optional[str] = None) -> None:
    """Raise when a C entry returned a CUDA error code."""
    if err != 0:
        msg_fn = getattr(lib, f"{name}_error_string")
        msg_fn.restype = ctypes.c_char_p
        msg_fn.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"CUDA kernel {kernel or name} failed to launch: error {err} "
            f"({msg_fn(err).decode()})")
