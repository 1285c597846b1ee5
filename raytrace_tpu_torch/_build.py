"""Build and load the CUDA kernels (nvcc -> one shared library -> ctypes).

The sources are ``SOURCES`` in ``csrc/``: the brute-force megakernel, the
grid and paged wavefront kernels, the fused intersect kernel, a band's
set-up (``packstate.cu``) and the lane-gather probe with its loop baseline
(``bench_gather.cu``).  They have a
plain C interface and include no PyTorch headers, so nvcc builds each in seconds; one nvcc process per source (and
one per PTX file) is started at once, and the objects are then linked into
one library.  The library lands in ``build/kernels/<hash>/`` at the
repository root (gitignored), keyed by a hash of the sources and flags; the
first call in a fresh checkout builds it, later calls load it.  Flags:
``sm_90a`` (Hopper), ``--fmad=false`` and no fast math, because the kernels
must keep the JAX package's IEEE op sequence (see ``csrc/wavefront.cuh``).

Nothing here runs at import: ``library()`` builds on first use and raises if
nvcc is missing or the build fails.  There is no fallback.  It holds a lock,
so threads that launch at once start one build.

The grid kernel's threads per block is a define of its translation unit
(``-DRT_GRID_BLOCK``), part of the hash, so every block size has a library
of its own.  So are the section-cost probes' switch sets (``-DRT_ABLATE``, a
bitmask of ``ops.gridkernel.SWITCHES`` or ``ops.pagedkernel.SWITCHES``): a
variant library holds only the kernel it varies, the production library
(both masks 0) has no switch define at all, and ``build_many`` starts every
missing variant's nvcc at once.  Libraries export the same symbols and are
loaded side by side (ctypes' ``RTLD_LOCAL``).  ``grid_block()`` resolves it once per process, at the first
build: ``RAYTRACE_TORCH_GRID_BLOCK`` if set, else the ``block`` that the
autotuner's block sweep cached for CUDA device 0's kind
(``runtime/autotune.py``), else 128.

``tuner_library()`` builds the JAX package's native workload tuner
(``native/tuner.cpp``, read in place) with g++ into
``build/tuner/<hash>/`` the same way, for ``runtime/tuner.py``;
``abi_library()`` builds the port's C ABI shim and its demo executable
(``native/``) into ``build/abi/<hash>/``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
REPO = Path(__file__).resolve().parent.parent
BUILD_ROOT = REPO / "build" / "kernels"
SOURCES = ("megakernel.cu", "gridkernel.cu", "pagedkernel.cu", "intersect.cu",
           "packstate.cu", "bench_gather.cu")
HEADERS = ("wavefront.cuh",)
ARCH = "sm_90a"
FLAGS = ("-std=c++17", "-O3", "--fmad=false")
LIB_NAME = "libraytrace_kernels.so"
GRID_SOURCE = "gridkernel.cu"
PAGED_SOURCE = "pagedkernel.cu"
GRID_BLOCK_ENV = "RAYTRACE_TORCH_GRID_BLOCK"
DEFAULT_GRID_BLOCK = 128
# PTX instructions that would break the IEEE contract (fast-math lowering)
FORBIDDEN_PTX = ("sqrt.approx.f32", "div.approx.f32", "div.full.f32", "rsqrt",
                 "sin.approx", "cos.approx")

_VOIDP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # 8 pointers, 14 ints, pmin, device, stream
    "rt_megakernel_step": [_VOIDP] * 8 + [_INT] * 14 + [_FLOAT, _INT, _VOIDP],
    # 14 pointers (tattrs and passign may be NULL), 22 ints, pmin, device, stream
    "rt_grid_megakernel_step": [_VOIDP] * 14 + [_INT] * 22 + [_FLOAT, _INT, _VOIDP],
    # five, n_slots, iterstats, device; out [4]
    "rt_grid_occupancy": [_INT] * 4 + [_VOIDP],
    # 13 pointers, 18 ints, pmin, device, stream
    "rt_paged_megakernel_step": [_VOIDP] * 13 + [_INT] * 18 + [_FLOAT, _INT, _VOIDP],
    # o, d, table, t, attrs; n, s_rows, device; stream
    "rt_intersect_shade": [_VOIDP] * 5 + [_INT] * 3 + [_VOIDP],
    # device; out [4]
    "rt_intersect_occupancy": [_INT, _VOIDP],
    # vpr and scal on the host, passign, gscal, vpr, scal, fstate, ustate,
    # key (passign, gscal and key may be NULL); 7 ints, device; stream
    "rt_pack_state": [_VOIDP] * 9 + [_INT] * 8 + [_VOIDP],
    # tab, idx, out; iters, axis, blocks, device; stream
    "rt_gather_bench": [_VOIDP] * 3 + [_INT] * 4 + [_VOIDP],
    # tab, out; iters, blocks, device; stream
    "rt_gather_base": [_VOIDP] * 2 + [_INT] * 3 + [_VOIDP],
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the CUDA kernels cannot be built")


def check_block(block: int) -> int:
    """``block`` if the grid kernel can take it as its threads per block (a
    multiple of 32 dividing 1024), else raise."""
    block = int(block)
    if block < 32 or block % 32 or 1024 % block:
        raise ValueError(f"grid kernel block {block}: a multiple of 32 dividing 1024")
    return block


def resolve_grid_block(device_kind: str) -> int:
    """The grid kernel's threads per block for a card of ``device_kind``:
    ``RAYTRACE_TORCH_GRID_BLOCK`` if set, else the autotune cache's block for
    that kind, else 128."""
    env = os.environ.get(GRID_BLOCK_ENV)
    if env:
        return check_block(env)
    from .runtime.autotune import cached_block

    cached = cached_block(device_kind)
    return check_block(cached) if cached is not None else DEFAULT_GRID_BLOCK


@functools.lru_cache(maxsize=None)
def grid_block() -> int:
    """This process's grid kernel block, resolved at its first call (the
    first build) for CUDA device 0."""
    import torch

    return resolve_grid_block(torch.cuda.get_device_name(0))


def _defines(name: str, block: int, grid: int = 0, paged: int = 0) -> list:
    """nvcc defines of source ``name``: the grid kernel's block, and a switch
    mask where it is not 0."""
    mask = {GRID_SOURCE: grid, PAGED_SOURCE: paged}.get(name, 0)
    block_def = [f"-DRT_GRID_BLOCK={block}"] if name == GRID_SOURCE else []
    return block_def + ([f"-DRT_ABLATE={mask}"] if mask else [])


def variant_sources(grid: int = 0, paged: int = 0) -> tuple:
    """The sources of a library: all of ``SOURCES`` for the production
    build, else the kernels whose switch mask is set."""
    if not grid and not paged:
        return SOURCES
    return tuple(name for name, mask in ((GRID_SOURCE, grid), (PAGED_SOURCE, paged)) if mask)


def source_hash(block: int, grid: int = 0, paged: int = 0) -> str:
    h = hashlib.sha256()
    for name in variant_sources(grid, paged) + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
        h.update(" ".join(_defines(name, block, grid, paged)).encode())
    h.update(" ".join((ARCH,) + FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir(block: int, grid: int = 0, paged: int = 0) -> Path:
    return BUILD_ROOT / source_hash(block, grid, paged)


def _run_all(cmds, counts=None) -> list:
    """Run the nvcc commands at once, or raise; the joined output of each
    run of ``counts`` consecutive commands (default: one run of all)."""
    procs = [subprocess.Popen(c, cwd=CSRC, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    res, i = [], 0
    for n in counts or [len(cmds)]:
        res.append("".join(outs[i : i + n]))
        i += n
    return res


def build(block: int = None, grid: int = 0, paged: int = 0) -> dict:
    """Build the shared library, with the grid kernel at ``block`` threads
    per block (default ``grid_block()``) and the switch masks ``grid`` and
    ``paged``, if it is missing.  Returns {"lib", "ptx", "seconds", "log",
    "block", "grid", "paged"}; ``ptx`` holds one PTX file per source of the
    production build (none for a variant), ``seconds`` is 0 when nothing was
    built, ``log`` holds ptxas' register report."""
    return build_many([(block, grid, paged)])[0]


def build_many(keys) -> list:
    """``build`` for each (block, grid mask, paged mask) of ``keys``: every
    missing library's nvcc processes are started at once, then their links
    at once; ``seconds`` is the wall of the whole build."""
    keys = [(grid_block() if b is None else check_block(b), int(g), int(p))
            for b, g, p in keys]
    plan = {}
    for key in dict.fromkeys(keys):
        out = build_dir(*key)
        ptx = ({} if key[1] or key[2] else
               {name: out / (Path(name).stem + ".ptx") for name in SOURCES})
        built = (out / LIB_NAME).exists() and all(p.exists() for p in ptx.values())
        plan[key] = (out, ptx, built)
    todo = [key for key, (_, _, built) in plan.items() if not built]
    t0 = time.perf_counter()
    if todo:
        nvcc = nvcc_path()
        compiles, counts, links, tmps = [], [], [], []
        for key in todo:
            out, ptx, _ = plan[key]
            out.mkdir(parents=True, exist_ok=True)
            tmp = Path(tempfile.mkdtemp(dir=out))
            tmps.append(tmp)
            srcs = variant_sources(key[1], key[2])
            objs = [str(tmp / (Path(name).stem + ".o")) for name in srcs]
            compiles += [[nvcc, "-gencode", f"arch=compute_90a,code={ARCH}", *FLAGS,
                          *_defines(name, *key), "-Xptxas", "-v", "-Xcompiler", "-fPIC",
                          "-c", "-o", obj, name] for name, obj in zip(srcs, objs)]
            compiles += [[nvcc, "-arch=compute_90a", *FLAGS, *_defines(name, *key), "-ptx",
                          "-o", str(tmp / dst.name), name] for name, dst in ptx.items()]
            counts.append(len(srcs) + len(ptx))
            links.append([nvcc, "-gencode", f"arch=compute_90a,code={ARCH}", "-shared",
                          "-o", str(tmp / LIB_NAME), *objs])
        try:
            logs = _run_all(compiles, counts)
            link_logs = _run_all(links, [1] * len(links))
            for key, tmp, log, link_log in zip(todo, tmps, logs, link_logs):
                out, ptx, _ = plan[key]
                for dst in ptx.values():
                    os.replace(tmp / dst.name, dst)
                # the library last: its presence marks a complete build
                (tmp / "build.log").write_text(log + link_log)
                os.replace(tmp / "build.log", out / "build.log")
                os.replace(tmp / LIB_NAME, out / LIB_NAME)
        finally:
            for tmp in tmps:
                shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t0
    res = []
    for key in keys:
        out, ptx, built = plan[key]
        log_path = out / "build.log"
        res.append(dict(lib=out / LIB_NAME, ptx=ptx, seconds=0.0 if built else seconds,
                        log=log_path.read_text() if log_path.exists() else "",
                        block=key[0], grid=key[1], paged=key[2]))
    return res


def ptxas_report(log: str, kernel: str) -> dict:
    """{entry function: {"registers", "frame", "spill_stores"}} of the
    instances of ``kernel`` in a build's ptxas log (frame and spills in
    bytes)."""
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            cur = name if kernel in name else None
            if cur:
                out[cur] = {"registers": 0, "frame": 0, "spill_stores": 0}
        elif cur and "bytes spill stores" in ln:
            out[cur]["frame"] = int(ln.split("bytes stack frame")[0].split()[-1])
            out[cur]["spill_stores"] = int(ln.split("bytes stack frame,")[1].split()[0])
        elif cur and "Used" in ln and "registers" in ln:
            out[cur]["registers"] = int(ln.split("Used")[1].split()[0])
    return out


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


def library(grid: int = 0, paged: int = 0) -> ctypes.CDLL:
    """The loaded kernel library at this process's grid block and the
    switch masks ``grid`` and ``paged`` (built on first use; one build and
    one load however many threads ask at once).  A variant library exports
    only the kernels it varies."""
    with _LOAD_LOCK:
        return _load_library(grid_block(), int(grid), int(paged))


@functools.lru_cache(maxsize=None)
def _load_library(block: int, grid: int, paged: int) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(block, grid, paged)["lib"]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = _INT
    if getattr(lib, "rt_error_string", None) is not None:  # megakernel.cu's
        lib.rt_error_string.argtypes = [_INT]
        lib.rt_error_string.restype = ctypes.c_char_p
    return lib


def error_string(err: int) -> str:
    return f"{err} ({library().rt_error_string(err).decode()})"


_SASS_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_SASS_INSTR = re.compile(  # /*addr*/ [@predicate] OPCODE args ;
    r"/\*[0-9a-f]{4,}\*/\s+((?:@!?U?P[T0-9]+\s+)?[A-Z][A-Z0-9_.]*[^;]*);")


@functools.lru_cache(maxsize=None)
def _sass_text(lib: str) -> str:
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout


def sass(lib) -> dict:
    """{function: [instruction text]} of a built library, from
    ``cuobjdump -sass`` (the toolkit's, beside nvcc; one dump per library
    and process)."""
    text = _sass_text(str(lib))
    funcs, name = {}, None
    for line in text.splitlines():
        f = _SASS_FUNCTION.search(line)
        if f:
            name = f.group(1)
            funcs[name] = []
        elif name is not None:
            m = _SASS_INSTR.search(line)
            if m:
                funcs[name].append(" ".join(m.group(1).split()))
    return funcs


def occupancy(kernel: str, *args: int) -> dict:
    """What the card makes of one instance of a kernel, from
    ``rt_<kernel>_occupancy(*args, out)``: resident blocks per SM
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


ABI_DIR = Path(__file__).resolve().parent / "native"
ABI_LIB = "libraytrace_torch.so"
ABI_DEMO = "raytrace_torch_demo"


def _python_flags():
    """(include flags, link flags of libpython) of this interpreter, from
    ``sysconfig`` (``python3-config`` may be missing)."""
    inc = sysconfig.get_paths()["include"]
    if not (Path(inc) / "Python.h").exists():
        raise RuntimeError(f"Python.h not found in {inc}: the C ABI cannot be built")
    cv = sysconfig.get_config_var
    libdir, libpl = cv("LIBDIR") or "", cv("LIBPL") or ""
    extra = (cv("LIBS") or "").split() + (cv("SYSLIBS") or "").split()
    if cv("Py_ENABLE_SHARED"):
        link = [f"-L{libdir}", f"-Wl,-rpath,{libdir}", "-Wl,--no-as-needed",
                f"-lpython{cv('VERSION')}{cv('ABIFLAGS') or ''}"]
    else:  # a static libpython: all of it, its symbols exported (-rdynamic)
        link = ["-Wl,--whole-archive", str(Path(libpl) / cv("LIBRARY")),
                "-Wl,--no-whole-archive"]
    return [f"-I{inc}"], link + extra


def abi_library() -> dict:
    """{"lib", "demo"}: the C ABI shim ``libraytrace_torch.so``
    (``native/raytrace_abi.cpp``, g++; Python's symbols left to the process
    that loads it) and the demo executable ``raytrace_torch_demo``
    (``native/main.c``, cc; libpython linked in, rpath ``$ORIGIN``), built
    into ``build/abi/<hash of sources, flags and interpreter>/`` if missing.
    The shim starts the interpreter it was built with when it finds none.
    Raises if a compiler or Python's headers are missing or a build fails."""
    gxx, cc = shutil.which("g++"), shutil.which("cc") or shutil.which("gcc")
    if gxx is None or cc is None:
        raise RuntimeError("g++ or cc not found: the C ABI cannot be built")
    inc, link = _python_flags()
    shim = ["-O2", "-fPIC", "-shared", "-std=c++17", "-Wall", *inc,
            f'-DRT_PYTHON_EXECUTABLE="{sys.executable}"']
    demo = ["-O2", "-Wall", "-rdynamic", "-Wl,-rpath,$ORIGIN"]
    h = hashlib.sha256()
    for name in ("raytrace_abi.cpp", "main.c"):
        h.update((ABI_DIR / name).read_bytes())
    h.update(" ".join(shim + demo + link).encode())
    out = REPO / "build" / "abi" / h.hexdigest()[:16]
    lib, exe = out / ABI_LIB, out / ABI_DEMO
    if lib.exists() and exe.exists():
        return dict(lib=lib, demo=exe)
    out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out) as tmp:
        cmds = [[gxx, *shim, "-o", str(Path(tmp) / ABI_LIB), str(ABI_DIR / "raytrace_abi.cpp")],
                [cc, *demo, "-o", str(Path(tmp) / ABI_DEMO), str(ABI_DIR / "main.c"),
                 f"-L{tmp}", "-lraytrace_torch", *link]]
        for cmd in cmds:
            res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)
            if res.returncode != 0:
                raise RuntimeError(f"{cmd[0]} failed ({res.returncode}): "
                                   f"{' '.join(cmd)}\n{res.stdout}")
        os.replace(Path(tmp) / ABI_LIB, lib)
        os.replace(Path(tmp) / ABI_DEMO, exe)  # last: its presence marks a whole build
    return dict(lib=lib, demo=exe)
