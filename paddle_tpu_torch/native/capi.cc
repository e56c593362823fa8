// C inference API of the port — the counterpart of the reference's C
// prediction ABI (paddle/fluid/inference/capi/pd_predictor.cc,
// pd_config.cc; the Go client go/paddle/predictor.go wraps that ABI via
// cgo, and wraps this one the same way).  Port of the JAX package's
// paddle_tpu/native/capi.cc, with the same ABI (paddle_tpu_c.h).
//
// Design: the inference runtime IS the Python package (torch.export
// graphs whose hand kernels are custom operators) — so the C ABI embeds a
// CPython interpreter and drives paddle_tpu_torch.inference through it.
// That keeps ONE predictor implementation (no drift between language
// frontends) at the cost of an embedded interpreter per process.
//
// Contract (single-precision):
//   pd_predictor_create(model, params)     -> handle or NULL
//   pd_predictor_run(h, ins, shapes, ndims, n, &out, out_shape, &out_nd)
//       inputs are f32 row-major (cast to each input's declared dtype);
//       ONE f32 output is malloc'd into *out (caller frees with pd_free);
//       returns 0 on success
//   pd_last_error()                        -> per-thread error copy
//
// The predictor runs on the card (cuda:0); PADDLE_TPU_TORCH_C_DEVICE=cpu
// (or another device string) names another device.
//
// Build: paddle_tpu_torch.native.c_api_path() (g++ with the running
// interpreter's include and library flags).

#include <Python.h>

#include "paddle_tpu_c.h"  // the public ABI — signatures must match

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

std::mutex g_mu;
std::string g_error;
std::mutex g_init_mu;
bool g_py_inited = false;

void set_error(const std::string& e) {
  std::lock_guard<std::mutex> g(g_mu);
  g_error = e;
}

// Fetch and format the pending Python exception into g_error.
void capture_py_error(const char* where) {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  std::string msg = std::string(where) + ": ";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* u = PyUnicode_AsUTF8(s);
      msg += u ? u : "<unprintable exception>";
      Py_DECREF(s);
    }
  } else {
    msg += "unknown Python error";
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_error(msg);
}

struct Predictor {
  PyObject* predictor = nullptr;  // paddle_tpu_torch.inference.Predictor
  PyObject* np = nullptr;         // numpy module
};

bool ensure_python() {
  std::lock_guard<std::mutex> g(g_init_mu);
  if (g_py_inited) return true;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    // Release the GIL the initializing thread holds, or every other
    // thread's PyGILState_Ensure would deadlock (the header promises
    // thread-compatibility).  Done BEFORE the pin step so every exit
    // path below leaves the GIL released.
    PyEval_SaveThread();
  }
  g_py_inited = true;
  return true;
}

}  // namespace

extern "C" {

const char* pd_last_error() {
  // per-thread copy: the shared buffer may be reallocated by a concurrent
  // set_error while the caller still reads the returned pointer
  static thread_local std::string local;
  {
    std::lock_guard<std::mutex> g(g_mu);
    local = g_error;
  }
  return local.c_str();
}

void pd_free(void* p) { std::free(p); }

void* pd_predictor_create(const char* model_path, const char* params_path) {
  if (!ensure_python()) return nullptr;
  PyGILState_STATE gil = PyGILState_Ensure();
  Predictor* h = nullptr;
  PyObject *mod = nullptr, *cfg_cls = nullptr, *cfg = nullptr,
           *create = nullptr, *pred = nullptr, *np = nullptr;
  do {
    mod = PyImport_ImportModule("paddle_tpu_torch.inference");
    if (!mod) { capture_py_error("import paddle_tpu_torch.inference"); break; }
    np = PyImport_ImportModule("numpy");
    if (!np) { capture_py_error("import numpy"); break; }
    cfg_cls = PyObject_GetAttrString(mod, "Config");
    create = PyObject_GetAttrString(mod, "create_predictor");
    if (!cfg_cls || !create) { capture_py_error("inference API"); break; }
    cfg = PyObject_CallFunction(cfg_cls, "ss", model_path, params_path);
    if (!cfg) { capture_py_error("Config"); break; }
    const char* device = std::getenv("PADDLE_TPU_TORCH_C_DEVICE");
    if (device) {
      PyObject* dev = PyUnicode_FromString(device);
      int rc = dev ? PyObject_SetAttrString(cfg, "device", dev) : -1;
      Py_XDECREF(dev);
      if (rc != 0) { capture_py_error("Config.device"); break; }
    }
    pred = PyObject_CallFunctionObjArgs(create, cfg, nullptr);
    if (!pred) { capture_py_error("create_predictor"); break; }
    h = new Predictor();
    h->predictor = pred;
    h->np = np;
    pred = nullptr;
    np = nullptr;
  } while (false);
  Py_XDECREF(mod);
  Py_XDECREF(cfg_cls);
  Py_XDECREF(cfg);
  Py_XDECREF(create);
  Py_XDECREF(pred);
  Py_XDECREF(np);
  PyGILState_Release(gil);
  return h;
}

void pd_predictor_destroy(void* handle) {
  if (!handle) return;
  Predictor* h = static_cast<Predictor*>(handle);
  PyGILState_STATE gil = PyGILState_Ensure();
  Py_XDECREF(h->predictor);
  Py_XDECREF(h->np);
  PyGILState_Release(gil);
  delete h;
}

// inputs: n_inputs f32 row-major buffers with shapes[i][0..ndims[i]).
// On success: *out_data = malloc'd f32 of the FIRST output, out_shape
// gets its dims (caller provides space for out_shape_cap), *out_ndim set.
int pd_predictor_run(void* handle, const float** inputs,
                     const int64_t* const* shapes, const int* ndims,
                     int n_inputs, float** out_data, int64_t* out_shape,
                     int out_shape_cap, int* out_ndim) {
  if (!handle) {
    set_error("null predictor");
    return 1;
  }
  Predictor* h = static_cast<Predictor*>(handle);
  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = 1;
  PyObject *arg_list = nullptr, *result = nullptr;
  do {
    arg_list = PyList_New(n_inputs);
    if (!arg_list) { capture_py_error("alloc args"); break; }
    bool ok = true;
    for (int i = 0; i < n_inputs; ++i) {
      int64_t numel = 1;
      for (int d = 0; d < ndims[i]; ++d) numel *= shapes[i][d];
      PyObject* mv = PyMemoryView_FromMemory(
          reinterpret_cast<char*>(const_cast<float*>(inputs[i])),
          numel * sizeof(float), PyBUF_READ);
      if (!mv) { capture_py_error("memoryview"); ok = false; break; }
      PyObject* shape_t = PyTuple_New(ndims[i]);
      if (!shape_t) { capture_py_error("alloc shape"); Py_DECREF(mv);
                      ok = false; break; }
      for (int d = 0; d < ndims[i]; ++d)
        PyTuple_SET_ITEM(shape_t, d, PyLong_FromLongLong(shapes[i][d]));
      // np.frombuffer(mv, dtype=float32).reshape(shape) — the view
      // aliases caller memory only for the synchronous run call
      PyObject* arr = PyObject_CallMethod(h->np, "frombuffer", "Os", mv,
                                          "float32");
      Py_DECREF(mv);
      if (!arr) { capture_py_error("frombuffer"); Py_DECREF(shape_t);
                  ok = false; break; }
      PyObject* shaped = PyObject_CallMethod(arr, "reshape", "O", shape_t);
      Py_DECREF(arr);
      Py_DECREF(shape_t);
      if (!shaped) { capture_py_error("reshape"); ok = false; break; }
      PyList_SET_ITEM(arg_list, i, shaped);  // steals
    }
    if (!ok) break;
    result = PyObject_CallMethod(h->predictor, "run", "(O)", arg_list);
    if (!result) { capture_py_error("run"); break; }
    // Predictor.run returns a list of np arrays; take output 0 as f32
    PyObject* out0 = PySequence_GetItem(result, 0);
    if (!out0) { capture_py_error("output 0"); break; }
    PyObject* out_f32 = PyObject_CallMethod(h->np, "ascontiguousarray",
                                            "Os", out0, "float32");
    Py_DECREF(out0);
    if (!out_f32) { capture_py_error("cast output"); break; }
    PyObject* shape = PyObject_GetAttrString(out_f32, "shape");
    Py_ssize_t nd = shape ? PyTuple_Size(shape) : -1;
    if (nd < 0 || nd > out_shape_cap) {
      set_error(nd < 0 ? "reading output shape failed"
                       : "output rank exceeds out_shape_cap");
      // a failed GetAttr/Size leaves a pending CPython exception; clear it
      // so the next API call on this thread starts from a clean slate
      PyErr_Clear();
      Py_XDECREF(shape);
      Py_DECREF(out_f32);
      break;
    }
    int64_t numel = 1;
    for (Py_ssize_t d = 0; d < nd; ++d) {
      out_shape[d] = PyLong_AsLongLong(PyTuple_GET_ITEM(shape, d));
      numel *= out_shape[d];
    }
    if (PyErr_Occurred()) {  // non-int shape entry: PyLong_AsLongLong == -1
      capture_py_error("output shape entry");
      Py_DECREF(shape);
      Py_DECREF(out_f32);
      break;
    }
    *out_ndim = static_cast<int>(nd);
    Py_DECREF(shape);
    PyObject* bytes = PyObject_CallMethod(out_f32, "tobytes", nullptr);
    Py_DECREF(out_f32);
    if (!bytes) { capture_py_error("tobytes"); break; }
    char* src = nullptr;
    Py_ssize_t blen = 0;
    if (PyBytes_AsStringAndSize(bytes, &src, &blen) != 0) {
      capture_py_error("output bytes");
      Py_DECREF(bytes);
      break;
    }
    *out_data = static_cast<float*>(std::malloc(blen));
    if (*out_data == nullptr) {
      set_error("output allocation failed");
      Py_DECREF(bytes);
      break;
    }
    std::memcpy(*out_data, src, blen);
    Py_DECREF(bytes);
    rc = 0;
  } while (false);
  Py_XDECREF(arg_list);
  Py_XDECREF(result);
  PyGILState_Release(gil);
  return rc;
}

}  // extern "C"
