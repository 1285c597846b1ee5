// C ABI embedding library of the PyTorch/CUDA port -- signature-compatible
// with the reference's exported entry point (ray_trace.h:9-15): a host
// application links (or dlopens / ctypes-loads) libraytrace_torch.so and
// calls ray_trace(samples, storeRenderResult, width, height, gpu_count),
// as the reference's scripts/test.py does against its ray_trace.dll.
//
// The renderer is the Python package raytrace_tpu_torch, so this library
// embeds CPython and forwards to raytrace_tpu_torch.ray_trace.  Loaded into
// a running interpreter (ctypes) it uses that one; otherwise it starts the
// interpreter it was built with (RT_PYTHON_EXECUTABLE, so that a virtual
// environment's packages are found) once and keeps it for later calls.
//
// The C signature has no device argument: the render runs on the GPU
// unless RAYTRACE_TORCH_DEVICE names another torch device ("cpu").  Without
// a GPU the port's RuntimeError is printed and nothing is written.
//
// Build: raytrace_tpu_torch._build.abi_library() (build/abi/<hash>/).

#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>

#ifndef RT_PYTHON_EXECUTABLE
#define RT_PYTHON_EXECUTABLE "python3"
#endif

namespace {

// Starts the interpreter as RT_PYTHON_EXECUTABLE would start (its prefix,
// its site-packages, PYTHONPATH honoured), then releases the GIL.
bool start_interpreter() {
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  PyStatus st = PyConfig_SetBytesString(&config, &config.program_name, RT_PYTHON_EXECUTABLE);
  if (!PyStatus_Exception(st)) st = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(st)) {
    std::fprintf(stderr, "raytrace_torch: cannot start Python (%s): %s\n",
                 RT_PYTHON_EXECUTABLE, st.err_msg ? st.err_msg : "unknown error");
    return false;
  }
  PyEval_SaveThread();
  return true;
}

void flush_python_stream(const char* name) {
  PyObject* stream = PySys_GetObject(name);  // borrowed
  if (stream == nullptr || stream == Py_None) return;
  PyObject* res = PyObject_CallMethod(stream, "flush", nullptr);
  if (res == nullptr) PyErr_Clear();
  Py_XDECREF(res);
}

}  // namespace

extern "C"
#if defined(_WIN32)
__declspec(dllexport)
#endif
void ray_trace(uint32_t samples = 10, bool storeRenderResult = false,
               uint32_t width = 1920, uint32_t height = 1080,
               uint32_t gpu_count = 1) {
  if (!Py_IsInitialized() && !start_interpreter()) return;
  // ctypes releases the GIL around a foreign call; take it back
  PyGILState_STATE gil = PyGILState_Ensure();
  const char* device = std::getenv("RAYTRACE_TORCH_DEVICE");
  if (device == nullptr || device[0] == '\0') device = "cuda";

  PyObject* mod = PyImport_ImportModule("raytrace_tpu_torch");
  PyObject* fn = mod ? PyObject_GetAttrString(mod, "ray_trace") : nullptr;
  PyObject* args = fn ? Py_BuildValue("(IOIII)", samples,
                                      storeRenderResult ? Py_True : Py_False,
                                      width, height, gpu_count)
                      : nullptr;
  PyObject* kwargs = args ? Py_BuildValue("{s:s}", "device", device) : nullptr;
  PyObject* res = kwargs ? PyObject_Call(fn, args, kwargs) : nullptr;
  if (res == nullptr) {
    PyErr_Print();
    if (mod == nullptr) std::fprintf(stderr, "raytrace_tpu_torch import failed\n");
  }
  Py_XDECREF(res);
  Py_XDECREF(kwargs);
  Py_XDECREF(args);
  Py_XDECREF(fn);
  Py_XDECREF(mod);
  // the duration_per_frame line must reach a pipe before the caller exits
  flush_python_stream("stdout");
  flush_python_stream("stderr");
  PyGILState_Release(gil);
  std::fflush(stdout);
  std::fflush(stderr);
  // the interpreter stays alive for later calls (finalizing CUDA and torch
  // mid-process is not supported)
}
