"""Build and load the CUDA kernels (nvcc -> one shared library -> ctypes).

The sources in ``csrc/`` have a plain C interface and include no PyTorch
headers, so nvcc builds each in seconds; one nvcc process per source (and
one per PTX file) is started at once, and the objects are then linked into
one library.  The library lands in ``build/kernels/<hash>/`` at the
repository root (gitignored), keyed by a hash of the sources and flags; the
first call in a fresh checkout builds it, later calls load it.  Flags:
``sm_90a`` (Hopper), ``--fmad=false`` and no fast math, because the kernels
must keep the JAX package's IEEE op sequence (see ``csrc/wavefront.cuh``).

Nothing here runs at import: ``library()`` builds on first use and raises if
nvcc is missing or the build fails.  There is no fallback.  It holds a lock,
so threads that launch at once start one build.

``tuner_library()`` builds the JAX package's native workload tuner
(``native/tuner.cpp``, read in place) with g++ into
``build/tuner/<hash>/`` the same way, for ``runtime/tuner.py``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
REPO = Path(__file__).resolve().parent.parent
BUILD_ROOT = REPO / "build" / "kernels"
SOURCES = ("megakernel.cu", "gridkernel.cu", "pagedkernel.cu", "intersect.cu")
HEADERS = ("wavefront.cuh",)
ARCH = "sm_90a"
FLAGS = ("-std=c++17", "-O3", "--fmad=false")
LIB_NAME = "libraytrace_kernels.so"
# PTX instructions that would break the IEEE contract (fast-math lowering)
FORBIDDEN_PTX = ("sqrt.approx.f32", "div.approx.f32", "div.full.f32", "rsqrt",
                 "sin.approx", "cos.approx")

_VOIDP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # 8 pointers, 14 ints, pmin, device, stream
    "rt_megakernel_step": [_VOIDP] * 8 + [_INT] * 14 + [_FLOAT, _INT, _VOIDP],
    # 14 pointers (tattrs and passign may be NULL), 19 ints, pmin, device, stream
    "rt_grid_megakernel_step": [_VOIDP] * 14 + [_INT] * 19 + [_FLOAT, _INT, _VOIDP],
    # five, n_slots, iterstats, device; out [4]
    "rt_grid_occupancy": [_INT] * 4 + [_VOIDP],
    # 13 pointers, 17 ints, pmin, device, stream
    "rt_paged_megakernel_step": [_VOIDP] * 13 + [_INT] * 17 + [_FLOAT, _INT, _VOIDP],
    # o, d, table, t, attrs; n, s_rows, device; stream
    "rt_intersect_shade": [_VOIDP] * 5 + [_INT] * 3 + [_VOIDP],
    # device; out [4]
    "rt_intersect_occupancy": [_INT, _VOIDP],
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the CUDA kernels cannot be built")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join((ARCH,) + FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def _run_all(cmds) -> str:
    """Run the nvcc commands at once; their joined output, or raise."""
    procs = [subprocess.Popen(c, cwd=CSRC, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> dict:
    """Build the shared library and one PTX file per kernel source if they
    are missing.  Returns {"lib", "ptx", "seconds", "log"}; ``seconds`` is 0
    when nothing was built, ``log`` holds ptxas' register report."""
    out = build_dir()
    lib = out / LIB_NAME
    ptx = {name: out / (Path(name).stem + ".ptx") for name in SOURCES}
    log_path = out / "build.log"
    if lib.exists() and all(p.exists() for p in ptx.values()):
        return dict(lib=lib, ptx=ptx, seconds=0.0,
                    log=log_path.read_text() if log_path.exists() else "")
    out.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out) as tmp:
        objs = [str(Path(tmp) / (Path(name).stem + ".o")) for name in SOURCES]
        log = _run_all(
            [[nvcc, "-gencode", f"arch=compute_90a,code={ARCH}", *FLAGS,
              "-Xptxas", "-v", "-Xcompiler", "-fPIC", "-c", "-o", obj, name]
             for name, obj in zip(SOURCES, objs)]
            + [[nvcc, "-arch=compute_90a", *FLAGS, "-ptx", "-o",
                str(Path(tmp) / dst.name), name] for name, dst in ptx.items()])
        tmp_lib = Path(tmp) / LIB_NAME
        log += _run_all([[nvcc, "-gencode", f"arch=compute_90a,code={ARCH}",
                          "-shared", "-o", str(tmp_lib), *objs]])
        for dst in ptx.values():
            os.replace(Path(tmp) / dst.name, dst)
        # the library last: its presence marks a complete build
        (Path(tmp) / "build.log").write_text(log)
        os.replace(Path(tmp) / "build.log", log_path)
        os.replace(tmp_lib, lib)
    return dict(lib=lib, ptx=ptx, seconds=time.perf_counter() - t0, log=log)


def forbidden_ptx(ptx_paths) -> dict:
    """{source: [forbidden instruction lines]} over the kernels' PTX."""
    found = {}
    for name, path in ptx_paths.items():
        bad = [ln.strip() for ln in Path(path).read_text().splitlines()
               if any(f in ln for f in FORBIDDEN_PTX)]
        if bad:
            found[name] = bad
    return found


_LOAD_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use; one build and one load
    however many threads ask at once)."""
    with _LOAD_LOCK:
        return _load_library()


@functools.lru_cache(maxsize=None)
def _load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()["lib"]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _INT
    lib.rt_error_string.argtypes = [_INT]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib


def error_string(err: int) -> str:
    return f"{err} ({library().rt_error_string(err).decode()})"


def occupancy(kernel: str, *args: int) -> dict:
    """What the card makes of one instance of a kernel, from
    ``rt_<kernel>_occupancy(*args, out)``: resident 128-thread blocks per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers per
    thread, local memory per thread (spills and stack) and static shared
    memory per block, in bytes."""
    out = (ctypes.c_int * 4)()
    err = getattr(library(), f"rt_{kernel}_occupancy")(*args, out)
    if err:
        raise RuntimeError(f"{kernel} occupancy query failed: {error_string(err)}")
    return dict(blocks_per_sm=out[0], registers=out[1], local_bytes=out[2],
                static_shared_bytes=out[3])


TUNER_SOURCE = REPO / "native" / "tuner.cpp"
TUNER_FLAGS = ("-O2", "-shared", "-fPIC", "-ffp-contract=off")
TUNER_LIB = "libraytrace_tuner.so"


def tuner_library() -> Path:
    """Path of the native workload tuner, built from ``native/tuner.cpp``
    with g++ into ``build/tuner/<hash of source and flags>/`` if missing.
    Raises if g++ is missing or the build fails."""
    h = hashlib.sha256(TUNER_SOURCE.read_bytes())
    h.update(" ".join(TUNER_FLAGS).encode())
    out = REPO / "build" / "tuner" / h.hexdigest()[:16]
    lib = out / TUNER_LIB
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native tuner cannot be built")
    out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out) as tmp:
        tmp_lib = Path(tmp) / TUNER_LIB
        res = subprocess.run([gxx, *TUNER_FLAGS, "-o", str(tmp_lib), str(TUNER_SOURCE)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}) on {TUNER_SOURCE}:\n{res.stdout}")
        os.replace(tmp_lib, lib)
    return lib
