// C predict API over the PyTorch port's exported artifacts: embeds CPython
// and serves a MXTPTEXP1 artifact with torch (see c_predict_api.h for the
// contract).  The structure is the JAX package's native/c_predict_api.cc:
// one interpreter for the process, started at the first MXTPUPredCreate,
// the serving code run once in a module of its own, a handle per
// predictor holding its _Served object, every call under the GIL.
#include "c_predict_api.h"

#include <Python.h>

#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;

void set_error(const std::string &msg) { g_last_error = msg; }

void set_py_error(const char *where) {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  std::string msg = where;
  if (value != nullptr) {
    PyObject *s = PyObject_Str(value);
    if (s != nullptr) {
      const char *u = PyUnicode_AsUTF8(s);
      if (u != nullptr) {
        msg += ": ";
        msg += u;
      } else {
        PyErr_Clear();  // un-encodable message; keep the location
      }
      Py_DECREF(s);
    } else {
      PyErr_Clear();
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_error(msg);
}

// The serving code: c_predict_serve.py, which the build turns into one
// raw string literal (c_predict_serve.inc).  It imports only numpy and
// torch.
const char *kServePy =
#include "c_predict_serve.inc"
    ;

std::once_flag g_py_once;
PyObject *g_module_dict = nullptr;  // dict holding _Served
std::string g_init_error;           // why the serving code did not load

bool ensure_python() {
  std::call_once(g_py_once, [&]() {
    bool we_initialized = false;
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      we_initialized = true;
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject *mod = PyImport_AddModule("__mxtpt_serve__");  // borrowed
    PyObject *dict = mod != nullptr ? PyModule_GetDict(mod) : nullptr;
    PyObject *res = nullptr;
    if (dict != nullptr) {
      // builtins must be reachable for exec of the serving code
      PyDict_SetItemString(dict, "__builtins__", PyEval_GetBuiltins());
      res = PyRun_String(kServePy, Py_file_input, dict, dict);
    }
    if (res == nullptr) {
      set_py_error("loading the serving code (is torch importable? set "
                   "PYTHONPATH to the site-packages that hold it)");
      g_init_error = g_last_error;
    } else {
      Py_DECREF(res);
      Py_INCREF(dict);
      g_module_dict = dict;
    }
    PyGILState_Release(gil);
    if (we_initialized) {
      // release the GIL our Py_InitializeEx took on this thread, so that
      // later PyGILState_Ensure calls from any thread work; when the host
      // process owns the runtime (a ctypes consumer), its GIL state is
      // its own
      PyEval_SaveThread();
    }
  });
  if (g_module_dict == nullptr) {
    set_error(g_init_error);
    return false;
  }
  return true;
}

struct Handle {
  PyObject *obj = nullptr;  // _Served instance
  std::vector<std::string> input_names;
  std::vector<std::vector<int64_t>> input_shapes;
  std::vector<std::vector<int64_t>> output_shapes;
  int n_outputs = -1;
};

class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

bool fill_shape_vec(PyObject *seq, std::vector<int64_t> *out) {
  PyObject *fast = PySequence_Fast(seq, "shape not a sequence");
  if (fast == nullptr) return false;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  out->clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    long long d = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(fast, i));
    if (d == -1 && PyErr_Occurred()) {
      Py_DECREF(fast);
      return false;
    }
    out->push_back(d);
  }
  Py_DECREF(fast);
  return true;
}

// Input names and shapes of a new _Served object, for the info getters.
bool cache_inputs(Handle *h) {
  PyObject *names = PyObject_GetAttrString(h->obj, "names");
  PyObject *shapes = PyObject_GetAttrString(h->obj, "shapes");
  bool ok = names != nullptr && shapes != nullptr && PyList_Check(names);
  Py_ssize_t n = ok ? PyList_Size(names) : 0;
  for (Py_ssize_t i = 0; ok && i < n; ++i) {
    PyObject *nm = PyList_GetItem(names, i);  // borrowed
    const char *u = PyUnicode_AsUTF8(nm);
    if (u == nullptr) {
      PyErr_Clear();
      u = "<unrepresentable>";
    }
    h->input_names.emplace_back(u);
    PyObject *shp = PyDict_GetItem(shapes, nm);  // borrowed
    std::vector<int64_t> dims;
    ok = shp != nullptr && fill_shape_vec(shp, &dims);
    h->input_shapes.push_back(std::move(dims));
  }
  Py_XDECREF(names);
  Py_XDECREF(shapes);
  return ok;
}

}  // namespace

extern "C" {

const char *MXTPUGetLastError(void) { return g_last_error.c_str(); }

int MXTPUPredCreate(const char *artifact_path, MXTPUPredictorHandle *out) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject *cls = PyDict_GetItemString(g_module_dict, "_Served");  // borrowed
  PyObject *obj =
      cls != nullptr ? PyObject_CallFunction(cls, "s", artifact_path) : nullptr;
  if (obj == nullptr) {
    set_py_error("MXTPUPredCreate");
    return -1;
  }
  auto *h = new Handle;
  h->obj = obj;
  if (!cache_inputs(h)) {
    set_py_error("MXTPUPredCreate (input metadata)");
    Py_DECREF(obj);
    delete h;
    return -1;
  }
  *out = h;
  return 0;
}

int MXTPUPredGetInputCount(MXTPUPredictorHandle hv, int *out) {
  *out = static_cast<int>(static_cast<Handle *>(hv)->input_names.size());
  return 0;
}

int MXTPUPredGetInputInfo(MXTPUPredictorHandle hv, int index,
                          const char **name, const int64_t **shape,
                          int *ndim) {
  auto *h = static_cast<Handle *>(hv);
  if (index < 0 || index >= static_cast<int>(h->input_names.size())) {
    set_error("input index out of range");
    return -1;
  }
  *name = h->input_names[index].c_str();
  *shape = h->input_shapes[index].data();
  *ndim = static_cast<int>(h->input_shapes[index].size());
  return 0;
}

int MXTPUPredSetInput(MXTPUPredictorHandle hv, const char *name,
                      const float *data, size_t size) {
  auto *h = static_cast<Handle *>(hv);
  Gil gil;
  PyObject *buf = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(data),
      static_cast<Py_ssize_t>(size * sizeof(float)));
  if (buf == nullptr) {
    set_py_error("MXTPUPredSetInput");
    return -1;
  }
  PyObject *res = PyObject_CallMethod(h->obj, "set_input", "sO", name, buf);
  Py_DECREF(buf);
  if (res == nullptr) {
    set_py_error("MXTPUPredSetInput");
    return -1;
  }
  Py_DECREF(res);
  return 0;
}

int MXTPUPredForward(MXTPUPredictorHandle hv) {
  auto *h = static_cast<Handle *>(hv);
  Gil gil;
  h->n_outputs = -1;
  PyObject *res = PyObject_CallMethod(h->obj, "forward", nullptr);
  if (res == nullptr) {
    set_py_error("MXTPUPredForward");
    return -1;
  }
  Py_DECREF(res);
  // refresh the output shape cache
  PyObject *outs = PyObject_GetAttrString(h->obj, "outputs");
  if (outs == nullptr || !PyList_Check(outs)) {
    Py_XDECREF(outs);
    set_py_error("MXTPUPredForward (outputs)");
    return -1;
  }
  int n = static_cast<int>(PyList_Size(outs));
  Py_DECREF(outs);
  h->output_shapes.assign(n, {});
  for (int i = 0; i < n; ++i) {
    PyObject *shp = PyObject_CallMethod(h->obj, "output_shape", "i", i);
    if (shp == nullptr || !fill_shape_vec(shp, &h->output_shapes[i])) {
      Py_XDECREF(shp);
      set_py_error("MXTPUPredForward (shapes)");
      return -1;
    }
    Py_DECREF(shp);
  }
  h->n_outputs = n;
  return 0;
}

int MXTPUPredGetOutputCount(MXTPUPredictorHandle hv, int *out) {
  auto *h = static_cast<Handle *>(hv);
  if (h->n_outputs < 0) {
    set_error("call MXTPUPredForward first");
    return -1;
  }
  *out = h->n_outputs;
  return 0;
}

int MXTPUPredGetOutputShape(MXTPUPredictorHandle hv, int index,
                            const int64_t **shape, int *ndim) {
  auto *h = static_cast<Handle *>(hv);
  if (index < 0 || index >= h->n_outputs) {
    set_error("output index out of range (forward not run?)");
    return -1;
  }
  *shape = h->output_shapes[index].data();
  *ndim = static_cast<int>(h->output_shapes[index].size());
  return 0;
}

int MXTPUPredGetOutput(MXTPUPredictorHandle hv, int index, float *out,
                       size_t size) {
  auto *h = static_cast<Handle *>(hv);
  if (index < 0 || index >= h->n_outputs) {
    set_error("output index out of range (forward not run?)");
    return -1;
  }
  Gil gil;
  PyObject *bytes = PyObject_CallMethod(h->obj, "output_bytes", "i", index);
  if (bytes == nullptr) {
    set_py_error("MXTPUPredGetOutput");
    return -1;
  }
  Py_ssize_t blen = PyBytes_Size(bytes);
  if (static_cast<size_t>(blen) != size * sizeof(float)) {
    Py_DECREF(bytes);
    set_error("output size mismatch: have " + std::to_string(blen / 4) +
              " elements, caller asked for " + std::to_string(size));
    return -1;
  }
  std::memcpy(out, PyBytes_AsString(bytes), blen);
  Py_DECREF(bytes);
  return 0;
}

int MXTPUPredFree(MXTPUPredictorHandle hv) {
  auto *h = static_cast<Handle *>(hv);
  {
    Gil gil;
    Py_XDECREF(h->obj);
  }
  delete h;
  return 0;
}

}  // extern "C"
