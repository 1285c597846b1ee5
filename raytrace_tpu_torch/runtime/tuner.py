"""Workload tuner: the row-band load balancer between devices.

Port of ``raytrace_tpu/runtime/tuner.py``: the reference's tune:: algorithm
(workload_tuner.hpp:8-105):

1. relative variance of per-device busy times > 1.8 -> redistribute rows
   in proportion to measured throughput (rows / duration);
2. else with probability 2/3: hill-climb from the best distribution seen,
   moving one row between two random devices;
3. else: converged (``None``).

The RNG is an explicit seeded xorshift64*, so ``PyTuner`` (a plain Python
copy of the JAX package's) and the native ``native/tuner.cpp`` give equal
decision streams.  ``make_tuner(native=True)`` builds that source with g++
into the port's ``build/`` (``_build.tuner_library``) and raises if the
build fails.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

_M64 = (1 << 64) - 1


def _xorshift(s: int) -> tuple:
    s ^= s >> 12
    s ^= (s << 25) & _M64
    s ^= s >> 27
    return s, (s * 0x2545F4914F6CDD1D) & _M64


@dataclass
class _Frame:
    dist: List[int]
    duration: float
    est: List[float]


@dataclass
class PyTuner:
    """Pure-Python tuner (bit-exact with native/tuner.cpp)."""

    total: int
    devices: int
    seed: int = 0x9E3779B97F4A7C15
    frames: List[_Frame] = field(default_factory=list)

    def add_frame(self, dist: Sequence[int], duration: float, est: Sequence[float]):
        if len(self.frames) > 10:
            self.frames = [self.frames[-1]]
        self.frames.append(_Frame(list(dist), float(duration), list(est)))

    def _rng_below(self, n: int) -> int:
        self.seed, out = _xorshift(self.seed)
        return out % n

    def get_workload(self) -> Optional[List[int]]:
        if not self.frames or self.devices == 0:
            return None
        f = self.frames[-1]
        n = self.devices
        avg = sum(f.est) / n
        variance = 0.0
        if avg > 0:
            for e in f.est:
                v = (e - avg) / avg
                variance += v * v

        if variance > 1.8:
            vs = [
                (f.dist[i] / f.est[i]) if f.est[i] > 0 else 0.0 for i in range(n)
            ]
            total_v = sum(vs)
            if total_v <= 0:
                return None
            out = [int(self.total * vs[i] / total_v) for i in range(n)]
            remain = self.total - sum(out)
            for i in range(remain):
                out[i % n] += 1
            return out

        if self._rng_below(3) != 0:
            best = min(self.frames, key=lambda fr: fr.duration)
            out = list(best.dist)
            dec = self._rng_below(n)
            inc = self._rng_below(n)
            if out[dec] > 1:
                out[inc] += 1
                out[dec] -= 1
            return out

        return None


class NativeTuner:
    """ctypes wrapper over native/tuner.cpp (same contract as PyTuner)."""

    def __init__(self, total: int, devices: int, seed: int, lib_path: str):
        self._lib = ctypes.CDLL(str(lib_path))
        self._lib.tuner_create.restype = ctypes.c_void_p
        self._lib.tuner_create.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64]
        self._lib.tuner_destroy.restype = None
        self._lib.tuner_destroy.argtypes = [ctypes.c_void_p]
        self._lib.tuner_add_frame.restype = None
        self._lib.tuner_add_frame.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_double,
            ctypes.POINTER(ctypes.c_double)]
        self._lib.tuner_get_workload.restype = ctypes.c_int
        self._lib.tuner_get_workload.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32)]
        self._n = devices
        self._h = self._lib.tuner_create(total, devices, seed)

    def add_frame(self, dist, duration, est):
        d = (ctypes.c_uint32 * self._n)(*dist)
        e = (ctypes.c_double * self._n)(*est)
        self._lib.tuner_add_frame(self._h, d, duration, e)

    def get_workload(self):
        out = (ctypes.c_uint32 * self._n)()
        if self._lib.tuner_get_workload(self._h, out):
            return list(out)
        return None

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.tuner_destroy(h)


def make_tuner(total: int, devices: int, seed: int = 0x9E3779B97F4A7C15,
               native: bool = False):
    """``PyTuner``, or with ``native=True`` the native tuner built from
    ``native/tuner.cpp`` into the port's ``build/`` (raises if it cannot be
    built; no fallback)."""
    if not native:
        return PyTuner(total, devices, seed)
    from .._build import tuner_library

    return NativeTuner(total, devices, seed, lib_path=tuner_library())
