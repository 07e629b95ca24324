"""Build and load the CUDA sources in ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles with one
``nvcc`` call into ``build/kernels/<name>-<digest>.so`` under the checkout
(the digest covers the source and the flags, so an edited source rebuilds),
which is then loaded with ``ctypes``.  ``build()`` starts one ``nvcc`` per
source, all at once, and waits for all of them; a failed build raises with
the compiler's output.  Nothing is built at import: the first kernel call
(or an explicit ``build()``) does it.

    PYTHONPATH=src python -m repro_torch.kernels.build

builds every source with ``-Xptxas=-v`` and prints each kernel's register
and spill report (those libraries are keyed apart from the ones the
wrappers load); ``ptxas_report`` parses it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("packed_matmul", "w8a8_matmul", "decode_attention", "xtramac_mac")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def nvcc_command(name: str, out: Path, extra: Sequence[str] = ()) -> list:
    return [nvcc_path(), *NVCC_FLAGS, *extra, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def library_path(name: str, extra: Sequence[str] = ()) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join((*NVCC_FLAGS, *extra)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None, *,
          extra: Sequence[str] = (), verbose: bool = False,
          logs: Optional[Dict[str, str]] = None) -> Dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` process per source, all started together.  Returns
    {name: library path}.  ``extra`` flags (e.g. ``-Xptxas=-v``) are added
    to every compile; ``verbose`` prints the compiler output, ``logs``
    (a dict) receives it by source."""
    names = tuple(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n, extra) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        procs[n] = (tmp, subprocess.Popen(
            nvcc_command(n, Path(tmp), extra), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if logs is not None:
            logs[n] = log
        if verbose and log:
            print(f"--- nvcc {n} ---\n{log}", flush=True)
        if proc.returncode != 0:
            failed.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """{kernel (mangled name): {"registers", "spill_stores", "spill_loads"}}
    from the output of a ``-Xptxas=-v`` build."""
    out: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn].update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return out


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The built library ``name`` (building it first if needed), with
    ``argtypes`` set from ``signatures`` {C function: [ctypes types]} and
    ``restype`` int (every entry point returns a ``cudaError_t``)."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, what: str, err: int) -> None:
    """Raise when a launch returned a non-zero ``cudaGetLastError()``."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


if __name__ == "__main__":
    build(extra=("-Xptxas=-v",), verbose=True)
