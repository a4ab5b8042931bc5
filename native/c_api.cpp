// C-ABI shim: embeds CPython and delegates to gunrock_jax.capi.
//
// The reference implements its C tier by dispatching into the CUDA apps
// (app/*_app.cu behind gunrock/gunrock.h); here the engine is JAX, so
// the natural native boundary is an embedded interpreter: one
// Py_Initialize per process, zero-copy buffer handoff (pointer
// addresses -> numpy views in gunrock_jax/capi.py), results written
// straight into the caller's arrays.
//
// Build (native.py get_capi_lib does this automatically):
//   g++ -O2 -shared -fPIC -std=c++17 c_api.cpp -o libgunrock_jax.so \
//       -I$PY_INC -L$PY_LIBDIR -lpython3.12 \
//       -DGRJAX_PYPATH='"repo:site-packages"'
//
// Works both from a plain C program (interpreter created on demand) and
// when loaded into an existing Python process (GIL acquired instead).

#include <Python.h>

#include <cstdio>
#include <cstring>

#include "gunrock_jax.h"

#ifndef GRJAX_PYPATH
#define GRJAX_PYPATH ""
#endif

namespace {

// Ensure the interpreter is live and the GIL is held by this thread.
// Returns the GIL state token semantics via *created_state.
PyGILState_STATE ensure_python(bool* ok) {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    // Make the repo + build-time site-packages importable: an embedded
    // interpreter does not inherit a venv's sys.path.
    PyRun_SimpleString(
        "import sys\n"
        "for _p in \"" GRJAX_PYPATH "\".split(\":\"):\n"
        "    if _p and _p not in sys.path:\n"
        "        sys.path.insert(0, _p)\n");
    // Release the GIL acquired by Py_InitializeEx: PyGILState_Release
    // below only restores the pre-Ensure state, so without this the
    // initializing thread would keep the GIL forever and a call from
    // any OTHER thread would deadlock in PyGILState_Ensure.
    PyEval_SaveThread();
  }
  *ok = true;
  return PyGILState_Ensure();
}

// Call gunrock_jax.capi.<fn>(args...) where every arg is an integer
// (pointer addresses / sizes / flags). Returns elapsed ms or negative.
float call_capi(const char* fn, const long long* args, int nargs) {
  bool ok = false;
  PyGILState_STATE st = ensure_python(&ok);
  if (!ok) return -1.0f;
  float result = -1.0f;
  PyObject* mod = PyImport_ImportModule("gunrock_jax.capi");
  if (mod) {
    PyObject* f = PyObject_GetAttrString(mod, fn);
    if (f) {
      PyObject* tup = PyTuple_New(nargs);
      for (int i = 0; i < nargs; ++i)
        PyTuple_SET_ITEM(tup, i, PyLong_FromLongLong(args[i]));
      PyObject* r = PyObject_CallObject(f, tup);
      Py_DECREF(tup);
      if (r) {
        result = static_cast<float>(PyFloat_AsDouble(r));
        Py_DECREF(r);
      }
      Py_DECREF(f);
    }
    Py_DECREF(mod);
  }
  if (PyErr_Occurred()) {
    PyErr_Print();
    result = -1.0f;
  }
  PyGILState_Release(st);
  return result;
}

inline long long addr(const void* p) {
  return static_cast<long long>(reinterpret_cast<uintptr_t>(p));
}

}  // namespace

extern "C" {

float gunrock_jax_bfs(int* bfs_label, int* bfs_pred, const int num_nodes,
                      const int num_edges, const int* row_offsets,
                      const int* col_indices, const int source,
                      const bool mark_predecessors,
                      const bool direction_optimized) {
  long long a[] = {addr(bfs_label), addr(bfs_pred), num_nodes, num_edges,
                   addr(row_offsets), addr(col_indices), source,
                   mark_predecessors ? 1 : 0, direction_optimized ? 1 : 0};
  return call_capi("bfs_c", a, 9);
}

float gunrock_jax_bc(float* bc_scores, const int num_nodes,
                     const int num_edges, const int* row_offsets,
                     const int* col_indices, const int source) {
  long long a[] = {addr(bc_scores), num_nodes, num_edges,
                   addr(row_offsets), addr(col_indices), source};
  return call_capi("bc_c", a, 6);
}

float gunrock_jax_cc(int* component, int* num_components,
                     const int num_nodes, const int num_edges,
                     const int* row_offsets, const int* col_indices) {
  long long a[] = {addr(component), addr(num_components), num_nodes,
                   num_edges, addr(row_offsets), addr(col_indices)};
  return call_capi("cc_c", a, 6);
}

float gunrock_jax_sssp(float* distances, int* preds, const int num_nodes,
                       const int num_edges, const int* row_offsets,
                       const int* col_indices, const float* edge_values,
                       const int source, const bool mark_preds) {
  long long a[] = {addr(distances), addr(preds), num_nodes, num_edges,
                   addr(row_offsets), addr(col_indices),
                   addr(edge_values), source, mark_preds ? 1 : 0};
  return call_capi("sssp_c", a, 9);
}

float gunrock_jax_pagerank(int* node_ids, float* pagerank,
                           const int num_nodes, const int num_edges,
                           const int* row_offsets, const int* col_indices,
                           const bool normalized) {
  long long a[] = {addr(node_ids), addr(pagerank), num_nodes, num_edges,
                   addr(row_offsets), addr(col_indices),
                   normalized ? 1 : 0};
  return call_capi("pagerank_c", a, 7);
}

}  // extern "C"
