// tpu_infer_capi: C API over paddle_tpu_torch's inference Predictor
// (counterpart of native/tpu_infer_capi.cc, which fronts paddle_tpu's).
//
// Reference analog: paddle/fluid/inference/capi_exp/pd_inference_api.h
// (PD_PredictorCreate / PD_PredictorRun / PD_*Destroy for C and other
// FFI deployments). There the C API fronts a C++ AnalysisPredictor; here
// the predictor is Python over PyTorch (paddle_tpu_torch/inference), so
// the C API embeds the interpreter: each entry point grabs the GIL,
// calls the same Predictor a Python user gets (on the card by default),
// and marshals float32 buffers in/out. A C/C++/Go/Rust serving process
// links this .so and never touches Python itself. The exported program's
// kernels do the work; the interpreter only routes the call. PDT_Init
// must start the interpreter whose torch has CUDA.
//
// C ABI (all return 0 on success, -1 on error; PDT_LastError() explains):
//   PDT_Init(repo_path)                 start the interpreter (no-op if
//                                       already embedded), add repo_path
//                                       to sys.path when non-NULL
//   PDT_PredictorCreate(prefix) -> h    load a jit.save'd artifact (on
//                                       the card; raises without one)
//   PDT_PredictorCreateOn(prefix, dev)  the same on "cpu" or the card
//                                       (dev NULL or "cuda")
//   PDT_PredictorRun(h, in, shape, ndim,
//                    &out, &out_shape, &out_ndim)
//                                       run one float32 in -> float32 out
//   PDT_BufferFree(p)                   free a Run-returned buffer
//   PDT_PredictorDestroy(h)
//   PDT_LastError() -> const char*      thread-local message
//
// Build (the embed flags come from sysconfig via
// paddle_tpu_torch/inference/capi.py):
//   g++ -O2 -shared -fPIC -std=c++17 $(python3-config --includes) \
//       tpu_infer_capi.cc -o libtpu_infer_capi.so $(python3-config \
//       --ldflags --embed)

#include <Python.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>

namespace {

thread_local std::string g_last_error;

void set_error_from_python() {
  PyObject *ptype = nullptr, *pvalue = nullptr, *ptb = nullptr;
  PyErr_Fetch(&ptype, &pvalue, &ptb);
  g_last_error = "unknown python error";
  if (pvalue != nullptr) {
    PyObject* s = PyObject_Str(pvalue);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) g_last_error = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(ptype);
  Py_XDECREF(pvalue);
  Py_XDECREF(ptb);
}

// RAII GIL hold: every entry point may be called from a bare C thread.
struct GilGuard {
  PyGILState_STATE st;
  GilGuard() : st(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(st); }
};

}  // namespace

extern "C" {

const char* PDT_LastError() { return g_last_error.c_str(); }

int PDT_Init(const char* repo_path) {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    if (!Py_IsInitialized()) {
      g_last_error = "Py_InitializeEx failed";
      return -1;
    }
    // Py_InitializeEx leaves THIS thread holding the GIL; park it so
    // worker threads' PyGILState_Ensure can ever succeed — without this
    // a real C embedding deadlocks on its first cross-thread call
    PyEval_SaveThread();
  }
  GilGuard gil;
  if (repo_path != nullptr && repo_path[0] != '\0') {
    PyObject* sys_path = PySys_GetObject("path");  // borrowed
    PyObject* p = PyUnicode_FromString(repo_path);
    if (sys_path == nullptr || p == nullptr ||
        PyList_Insert(sys_path, 0, p) != 0) {
      Py_XDECREF(p);
      set_error_from_python();
      return -1;
    }
    Py_DECREF(p);
  }
  return 0;
}

void* PDT_PredictorCreateOn(const char* model_prefix, const char* device) {
  if (!Py_IsInitialized()) {
    g_last_error = "call PDT_Init first";
    return nullptr;
  }
  if (model_prefix == nullptr) {
    g_last_error = "null argument";
    return nullptr;
  }
  GilGuard gil;
  PyObject* mod = PyImport_ImportModule("paddle_tpu_torch.inference");
  if (mod == nullptr) {
    set_error_from_python();
    return nullptr;
  }
  PyObject* cfg = PyObject_CallMethod(mod, "Config", "s", model_prefix);
  if (cfg == nullptr) {
    Py_DECREF(mod);
    set_error_from_python();
    return nullptr;
  }
  // the Config's device choice: the card unless "cpu" is asked for
  if (device != nullptr && std::strcmp(device, "cpu") == 0) {
    PyObject* r = PyObject_CallMethod(cfg, "disable_gpu", nullptr);
    if (r == nullptr) {
      Py_DECREF(cfg);
      Py_DECREF(mod);
      set_error_from_python();
      return nullptr;
    }
    Py_DECREF(r);
  }
  PyObject* pred =
      PyObject_CallMethod(mod, "create_predictor", "O", cfg);
  Py_DECREF(cfg);
  Py_DECREF(mod);
  if (pred == nullptr) {
    set_error_from_python();
    return nullptr;
  }
  return pred;  // owned reference handed to the caller as the handle
}

void* PDT_PredictorCreate(const char* model_prefix) {
  return PDT_PredictorCreateOn(model_prefix, nullptr);
}

void PDT_PredictorDestroy(void* handle) {
  if (handle == nullptr || !Py_IsInitialized()) return;
  GilGuard gil;
  Py_DECREF(reinterpret_cast<PyObject*>(handle));
}

void PDT_BufferFree(void* p) { std::free(p); }

int PDT_PredictorRun(void* handle, const float* data,
                     const int64_t* shape, int ndim, float** out_data,
                     int64_t** out_shape, int* out_ndim) {
  if (handle == nullptr || data == nullptr || shape == nullptr ||
      out_data == nullptr || out_shape == nullptr || out_ndim == nullptr) {
    g_last_error = "null argument";
    return -1;
  }
  if (!Py_IsInitialized()) {
    g_last_error = "call PDT_Init first";
    return -1;
  }
  GilGuard gil;
  PyObject* np = PyImport_ImportModule("numpy");
  if (np == nullptr) {
    set_error_from_python();
    return -1;
  }

  int rc = -1;
  PyObject *bytes = nullptr, *flat = nullptr, *shape_tuple = nullptr,
           *arr = nullptr, *inputs = nullptr, *outs = nullptr,
           *first = nullptr, *shape_attr = nullptr;
  do {
    int64_t n = 1;
    for (int i = 0; i < ndim; ++i) n *= shape[i];
    bytes = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(data),
        static_cast<Py_ssize_t>(n * sizeof(float)));
    if (bytes == nullptr) break;
    flat = PyObject_CallMethod(np, "frombuffer", "(Os)", bytes, "float32");
    if (flat == nullptr) break;
    shape_tuple = PyTuple_New(ndim);
    if (shape_tuple == nullptr) break;
    for (int i = 0; i < ndim; ++i)
      PyTuple_SET_ITEM(shape_tuple, i,
                       PyLong_FromLongLong(static_cast<long long>(
                           shape[i])));
    arr = PyObject_CallMethod(flat, "reshape", "(O)", shape_tuple);
    if (arr == nullptr) break;
    inputs = PyList_New(1);
    if (inputs == nullptr) break;
    Py_INCREF(arr);
    PyList_SET_ITEM(inputs, 0, arr);
    outs = PyObject_CallMethod(reinterpret_cast<PyObject*>(handle),
                               "run", "(O)", inputs);
    if (outs == nullptr) break;
    first = PySequence_GetItem(outs, 0);
    if (first == nullptr) break;
    // normalize to contiguous float32 — a NO-OP copy when the model
    // already produced that (the normal path) — then read its memory
    // straight through the buffer protocol: ONE memcpy out
    PyObject* f32 = PyObject_CallMethod(
        np, "ascontiguousarray", "(Os)", first, "float32");
    if (f32 == nullptr) break;
    shape_attr = PyObject_GetAttrString(f32, "shape");
    if (shape_attr == nullptr) {
      Py_DECREF(f32);
      break;
    }
    Py_buffer view;
    if (PyObject_GetBuffer(f32, &view, PyBUF_C_CONTIGUOUS) != 0) {
      Py_DECREF(f32);
      break;
    }
    Py_ssize_t rank = PyTuple_Size(shape_attr);
    float* buf = static_cast<float*>(std::malloc(view.len));
    int64_t* shp = static_cast<int64_t*>(
        std::malloc(sizeof(int64_t) * (rank > 0 ? rank : 1)));
    if (buf == nullptr || shp == nullptr) {
      std::free(buf);
      std::free(shp);
      PyBuffer_Release(&view);
      Py_DECREF(f32);
      g_last_error = "out of memory";
      rc = -1;
      break;
    }
    std::memcpy(buf, view.buf, view.len);
    PyBuffer_Release(&view);
    Py_DECREF(f32);
    for (Py_ssize_t i = 0; i < rank; ++i)
      shp[i] = static_cast<int64_t>(
          PyLong_AsLongLong(PyTuple_GET_ITEM(shape_attr, i)));
    *out_data = buf;
    *out_shape = shp;
    *out_ndim = static_cast<int>(rank);
    rc = 0;
  } while (false);

  if (rc != 0 && PyErr_Occurred()) set_error_from_python();
  Py_XDECREF(shape_attr);
  Py_XDECREF(first);
  Py_XDECREF(outs);
  Py_XDECREF(inputs);
  Py_XDECREF(arr);
  Py_XDECREF(shape_tuple);
  Py_XDECREF(flat);
  Py_XDECREF(bytes);
  Py_DECREF(np);
  return rc;
}

}  // extern "C"
