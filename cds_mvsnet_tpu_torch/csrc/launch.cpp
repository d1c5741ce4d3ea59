// The light launch path's binding (ops/kernels/_launch.py): Python entry
// points, called with METH_FASTCALL, that take the wrapper's checked
// tensors, allocate the output with at::empty on the input's device, launch
// the kernel through its plain C entry point (csrc/<lib>.cu, whose address
// `bind` receives once per process) on the caller's stream, given as its raw
// handle, and return the output. Compiled with g++ against torch's headers
// by ops/kernels/_build.py; no CUDA header.
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <torch/csrc/autograd/python_variable.h>

#include <cstring>
#include <exception>

namespace {

using RowGather = int (*)(const void*, const void*, void*, int, int, int, void*);
using Int16Arith = int (*)(const void*, void*, int, long long, void*);
using LaneSlice = int (*)(const void*, const void*, void*, int, int, void*);
using ErrorString = const char* (*)(int);

RowGather row_gather_launch = nullptr;
Int16Arith int16_arith_launch = nullptr;
LaneSlice lane_slice_launch = nullptr;
ErrorString error_string = nullptr;

PyObject* cuda_error(const char* what, int err) {
  PyErr_Format(PyExc_RuntimeError, "%s: CUDA error %d (%s)", what, err,
               error_string ? error_string(err) : "unknown");
  return nullptr;
}

bool arguments(const char* what, PyObject* const* args, Py_ssize_t nargs, Py_ssize_t want, int tensors,
               const void* fn) {
  if (!fn) {
    PyErr_Format(PyExc_RuntimeError, "%s: its C entry point is not bound", what);
    return false;
  }
  bool ok = nargs == want;
  for (int i = 0; ok && i < tensors; ++i) ok = THPVariable_Check(args[i]);
  if (!ok) PyErr_Format(PyExc_TypeError, "%s: %d tensors and %d ints expected", what, tensors, (int)want - tensors);
  return ok;
}

// bind(name, address): the C entry point `name` is at `address`.
PyObject* bind(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 2) {
    PyErr_SetString(PyExc_TypeError, "bind(name, address)");
    return nullptr;
  }
  const char* name = PyUnicode_AsUTF8(args[0]);
  void* address = PyLong_AsVoidPtr(args[1]);
  if (!name || PyErr_Occurred()) return nullptr;
  if (!std::strcmp(name, "row_gather_launch")) {
    row_gather_launch = reinterpret_cast<RowGather>(address);
  } else if (!std::strcmp(name, "int16_arith_launch")) {
    int16_arith_launch = reinterpret_cast<Int16Arith>(address);
  } else if (!std::strcmp(name, "lane_slice_launch")) {
    lane_slice_launch = reinterpret_cast<LaneSlice>(address);
  } else if (!std::strcmp(name, "cds_error_string")) {
    error_string = reinterpret_cast<ErrorString>(address);
  } else {
    PyErr_Format(PyExc_ValueError, "bind: no entry point %s", name);
    return nullptr;
  }
  Py_RETURN_NONE;
}

// row_gather(src, idx, form, stream) -> (R, L) fp32
PyObject* row_gather(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (!arguments("row_gather", args, nargs, 4, 2, reinterpret_cast<const void*>(row_gather_launch))) return nullptr;
  const int form = (int)PyLong_AsLong(args[2]);
  void* stream = PyLong_AsVoidPtr(args[3]);
  if (PyErr_Occurred()) return nullptr;
  try {
    const at::Tensor& src = THPVariable_Unpack(args[0]);
    const at::Tensor& idx = THPVariable_Unpack(args[1]);
    at::Tensor out = at::empty(src.sizes(), src.options().dtype(at::kFloat));
    const int err = row_gather_launch(src.const_data_ptr(), idx.const_data_ptr(), out.data_ptr(), form,
                                      (int)src.size(0), (int)src.size(1), stream);
    if (err) return cuda_error("row_gather_launch", err);
    return THPVariable_Wrap(std::move(out));
  } catch (const std::exception& e) {
    PyErr_SetString(PyExc_RuntimeError, e.what());
    return nullptr;
  }
}

// int16_arith(src, stream) -> like src
PyObject* int16_arith(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (!arguments("int16_arith", args, nargs, 2, 1, reinterpret_cast<const void*>(int16_arith_launch))) return nullptr;
  void* stream = PyLong_AsVoidPtr(args[1]);
  if (PyErr_Occurred()) return nullptr;
  try {
    const at::Tensor& src = THPVariable_Unpack(args[0]);
    at::Tensor out = at::empty(src.sizes(), src.options());
    const int err = int16_arith_launch(src.const_data_ptr(), out.data_ptr(), (int)src.size(1), src.numel(), stream);
    if (err) return cuda_error("int16_arith_launch", err);
    return THPVariable_Wrap(std::move(out));
  } catch (const std::exception& e) {
    PyErr_SetString(PyExc_RuntimeError, e.what());
    return nullptr;
  }
}

// lane_slice_sum(x, offs, stream) -> (R, 128) fp32
PyObject* lane_slice_sum(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (!arguments("lane_slice_sum", args, nargs, 3, 2, reinterpret_cast<const void*>(lane_slice_launch)))
    return nullptr;
  void* stream = PyLong_AsVoidPtr(args[2]);
  if (PyErr_Occurred()) return nullptr;
  try {
    const at::Tensor& x = THPVariable_Unpack(args[0]);
    const at::Tensor& offs = THPVariable_Unpack(args[1]);
    at::Tensor out = at::empty({x.size(0), 128}, x.options());
    const int err = lane_slice_launch(x.const_data_ptr(), offs.const_data_ptr(), out.data_ptr(), (int)x.size(0),
                                      (int)offs.size(0), stream);
    if (err) return cuda_error("lane_slice_launch", err);
    return THPVariable_Wrap(std::move(out));
  } catch (const std::exception& e) {
    PyErr_SetString(PyExc_RuntimeError, e.what());
    return nullptr;
  }
}

PyMethodDef methods[] = {
    {"bind", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(bind)), METH_FASTCALL,
     "bind(name, address): where the C entry point `name` is"},
    {"row_gather", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(row_gather)), METH_FASTCALL,
     "row_gather(src, idx, form, stream) -> out"},
    {"int16_arith", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(int16_arith)), METH_FASTCALL,
     "int16_arith(src, stream) -> out"},
    {"lane_slice_sum", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(lane_slice_sum)),
     METH_FASTCALL, "lane_slice_sum(x, offs, stream) -> out"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "cds_launch", "The light launch path of P1 and P2.", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit_cds_launch() { return PyModule_Create(&module); }
