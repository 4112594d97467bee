/* C ABI over the auncel_tpu_torch runtime via an embedded CPython
 * interpreter (the port of auncel_tpu/c_api/auncel_c.c).
 *
 * Counterpart of the reference's c_api/ tree. The reference wraps its C++
 * classes function-by-function; here the runtime IS Python (PyTorch
 * driving the CUDA kernels), so the C surface embeds the interpreter once
 * and marshals flat float/int buffers in and out through the stable
 * CPython ABI (no numpy C headers needed: buffers cross as memoryviews,
 * results come back as bytes). AUNCEL_C_DEVICE (default "cuda") is the
 * device= of every index the factory makes.
 */

#include "auncel_c.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <pthread.h>
#include <string.h>
#include <stdio.h>
#include <stdlib.h>

static char last_error[4096] = "";

struct auncel_index { PyObject *obj; };
struct auncel_errsys { PyObject *obj; };

static void set_error_from_python(void) {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      snprintf(last_error, sizeof(last_error), "%s", PyUnicode_AsUTF8(s));
      Py_DECREF(s);
    }
  } else if (!last_error[0]) {
    /* no pending exception: keep any manual message already in
     * last_error (np_to_buf writes precise size-mismatch text) */
    snprintf(last_error, sizeof(last_error), "unknown python error");
  }
  Py_XDECREF(type); Py_XDECREF(value); Py_XDECREF(tb);
}

const char *auncel_last_error(void) { return last_error; }

/* one embedded interpreter; numpy + auncel_tpu_torch imported lazily */
static PyObject *g_np = NULL, *g_at = NULL;
static pthread_mutex_t g_init_lock = PTHREAD_MUTEX_INITIALIZER;

static int ensure_runtime(void) {
  /* serialized: the g_at fast path alone is a data race, and the
   * header promises concurrent (not parallel) calls are safe */
  pthread_mutex_lock(&g_init_lock);
  if (g_at) { pthread_mutex_unlock(&g_init_lock); return 0; }
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    /* Py_InitializeEx leaves this thread owning the GIL; hand it back
     * so OTHER threads' PyGILState_Ensure can ever succeed */
    PyEval_SaveThread();
  }
  PyGILState_STATE st = PyGILState_Ensure();
  /* The embedded interpreter does not put cwd on sys.path; make the
   * package importable from (a) $AUNCEL_PY_ROOT if set, (b) the process
   * cwd — covering both installed and in-tree clients. */
  PyRun_SimpleString(
      "import sys, os\n"
      "for _p in (os.environ.get('AUNCEL_PY_ROOT'), os.getcwd()):\n"
      "    if _p and _p not in sys.path:\n"
      "        sys.path.insert(0, _p)\n");
  g_np = PyImport_ImportModule("numpy");
  if (!g_np) {
    set_error_from_python();
    PyGILState_Release(st);
    pthread_mutex_unlock(&g_init_lock);
    return -1;
  }
  g_at = PyImport_ImportModule("auncel_tpu_torch");
  if (!g_at) {
    set_error_from_python();
    PyGILState_Release(st);
    pthread_mutex_unlock(&g_init_lock);
    return -1;
  }
  PyGILState_Release(st);
  pthread_mutex_unlock(&g_init_lock);
  return 0;
}

/* float32 [n, d] numpy array COPYING a C buffer (frombuffer alone is
 * zero-copy and ErrorSys.set_queries retains the array beyond the C
 * call — the caller is free to free() its buffer after we return) */
static PyObject *np_from_f32(const float *x, int64_t n, int64_t d) {
  PyObject *mv = PyMemoryView_FromMemory(
      (char *)x, (Py_ssize_t)(n * d * 4), PyBUF_READ);
  if (!mv) return NULL;
  PyObject *view = PyObject_CallMethod(
      g_np, "frombuffer", "Os", mv, "float32");
  Py_DECREF(mv);
  if (!view) return NULL;
  PyObject *arr = PyObject_CallMethod(view, "copy", NULL);
  Py_DECREF(view);
  if (!arr) return NULL;
  PyObject *shaped = PyObject_CallMethod(arr, "reshape", "(LL)",
                                         (long long)n, (long long)d);
  Py_DECREF(arr);
  return shaped;
}

/* copy a numpy array out as (dtype)->raw bytes into dst */
static int np_to_buf(PyObject *arr, const char *dtype, void *dst,
                     int64_t nbytes) {
  PyObject *cast = PyObject_CallMethod(arr, "astype", "s", dtype);
  if (!cast) return -1;
  PyObject *contig = PyObject_CallMethod(g_np, "ascontiguousarray", "O",
                                         cast);
  Py_DECREF(cast);
  if (!contig) return -1;
  PyObject *bytes = PyObject_CallMethod(contig, "tobytes", NULL);
  Py_DECREF(contig);
  if (!bytes) return -1;
  char *buf; Py_ssize_t len;
  if (PyBytes_AsStringAndSize(bytes, &buf, &len) < 0 || len != nbytes) {
    Py_DECREF(bytes);
    snprintf(last_error, sizeof(last_error),
             "result size mismatch (%zd vs %lld)", len, (long long)nbytes);
    return -1;
  }
  memcpy(dst, buf, (size_t)nbytes);
  Py_DECREF(bytes);
  return 0;
}

int auncel_index_factory(auncel_index_t **out, int d, const char *desc,
                         const char *metric) {
  if (ensure_runtime()) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  const char *dev = getenv("AUNCEL_C_DEVICE");
  PyObject *obj = NULL;
  PyObject *fn = PyObject_GetAttrString(g_at, "index_factory");
  PyObject *args = Py_BuildValue("(iss)", d, desc, metric ? metric : "l2");
  PyObject *kw = Py_BuildValue("{ss}", "device",
                               dev && *dev ? dev : "cuda");
  if (fn && args && kw) obj = PyObject_Call(fn, args, kw);
  Py_XDECREF(fn); Py_XDECREF(args); Py_XDECREF(kw);
  if (!obj) { set_error_from_python(); PyGILState_Release(st); return -2; }
  *out = (auncel_index_t *)malloc(sizeof(auncel_index_t));
  (*out)->obj = obj;
  PyGILState_Release(st);
  return 0;
}

static int call_with_array(PyObject *obj, const char *method,
                           const float *x, int64_t n, int64_t d) {
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject *arr = np_from_f32(x, n, d);
  if (!arr) { set_error_from_python(); PyGILState_Release(st); return -1; }
  PyObject *r = PyObject_CallMethod(obj, method, "O", arr);
  Py_DECREF(arr);
  if (!r) { set_error_from_python(); PyGILState_Release(st); return -2; }
  Py_DECREF(r);
  PyGILState_Release(st);
  return 0;
}

static long index_dim(auncel_index_t *idx) {
  /* attribute access needs the GIL like every other interpreter call */
  PyGILState_STATE st = PyGILState_Ensure();
  long d = -1;
  PyObject *dobj = PyObject_GetAttrString(idx->obj, "d");
  if (dobj) { d = PyLong_AsLong(dobj); Py_DECREF(dobj); }
  else set_error_from_python();
  PyGILState_Release(st);
  return d;
}

int auncel_index_train(auncel_index_t *idx, int64_t n, const float *x) {
  long d = index_dim(idx);
  if (d < 0) return -1;
  return call_with_array(idx->obj, "train", x, n, d);
}

int auncel_index_add(auncel_index_t *idx, int64_t n, const float *x) {
  long d = index_dim(idx);
  if (d < 0) return -1;
  return call_with_array(idx->obj, "add", x, n, d);
}

int auncel_index_ntotal(auncel_index_t *idx, int64_t *out) {
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject *n = PyObject_GetAttrString(idx->obj, "ntotal");
  if (!n) { set_error_from_python(); PyGILState_Release(st); return -1; }
  *out = (int64_t)PyLong_AsLongLong(n);
  Py_DECREF(n);
  PyGILState_Release(st);
  return 0;
}

int auncel_index_search(auncel_index_t *idx, int64_t nq, const float *q,
                        int k, int nprobe, float *out_d, int64_t *out_i) {
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject *dobj = PyObject_GetAttrString(idx->obj, "d");
  long d = PyLong_AsLong(dobj); Py_DECREF(dobj);
  PyObject *arr = np_from_f32(q, nq, d);
  if (!arr) { set_error_from_python(); PyGILState_Release(st); return -1; }
  PyObject *res;
  if (nprobe > 0)
    res = PyObject_CallMethod(idx->obj, "search", "Oii", arr, k, nprobe);
  else
    res = PyObject_CallMethod(idx->obj, "search", "Oi", arr, k);
  Py_DECREF(arr);
  if (!res) { set_error_from_python(); PyGILState_Release(st); return -2; }
  int rc = 0;
  rc |= np_to_buf(PyTuple_GetItem(res, 0), "float32", out_d, nq * k * 4);
  rc |= np_to_buf(PyTuple_GetItem(res, 1), "int64", out_i, nq * k * 8);
  Py_DECREF(res);
  if (rc) set_error_from_python();
  PyGILState_Release(st);
  return rc ? -3 : 0;
}

void auncel_index_free(auncel_index_t *idx) {
  if (!idx) return;
  PyGILState_STATE st = PyGILState_Ensure();
  Py_XDECREF(idx->obj);
  PyGILState_Release(st);
  free(idx);
}

int auncel_errsys_new(auncel_errsys_t **out, auncel_index_t *idx,
                      int64_t train_nq, const float *train_q,
                      int max_topk) {
  if (ensure_runtime()) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  int rc = -2;
  PyObject *dobj = PyObject_GetAttrString(idx->obj, "d");
  long d = PyLong_AsLong(dobj); Py_DECREF(dobj);
  PyObject *qarr = NULL, *gt = NULL, *es = NULL, *r = NULL;
  qarr = np_from_f32(train_q, train_nq, d);
  if (!qarr) goto fail;
  /* value-consistent GT from the index's own full scan */
  gt = PyObject_CallMethod(idx->obj, "exact_search", "Oi", qarr, max_topk);
  if (!gt) goto fail;
  {
    long long tn = ((train_nq + 9) / 10) * 10; /* train_num % 10 == 0 */
    es = PyObject_CallMethod(g_at, "ErrorSys", "OLi", idx->obj, tn,
                             max_topk);
  }
  if (!es) goto fail;
  r = PyObject_CallMethod(es, "set_gt", "OO", PyTuple_GetItem(gt, 0),
                          PyTuple_GetItem(gt, 1));
  if (!r) goto fail;
  Py_DECREF(r);
  r = PyObject_CallMethod(es, "sys_train", "LO", (long long)train_nq,
                          qarr);
  if (!r) goto fail;
  Py_DECREF(r);
  *out = (auncel_errsys_t *)malloc(sizeof(auncel_errsys_t));
  (*out)->obj = es;
  es = NULL;
  rc = 0;
fail:
  if (rc) set_error_from_python();
  Py_XDECREF(qarr); Py_XDECREF(gt); Py_XDECREF(es);
  PyGILState_Release(st);
  return rc;
}

int auncel_errsys_bounded_search(auncel_errsys_t *es, int64_t nq,
                                 const float *q, int k, float require_acc,
                                 float multipler, float std_m,
                                 float *out_d, int64_t *out_i) {
  PyGILState_STATE st = PyGILState_Ensure();
  int rc = -2;
  PyObject *idx = NULL, *dobj = NULL, *qarr = NULL, *acc = NULL;
  PyObject *r = NULL, *res = NULL;
  idx = PyObject_GetAttrString(es->obj, "index");
  if (!idx) goto fail;
  dobj = PyObject_GetAttrString(idx, "d");
  long d = PyLong_AsLong(dobj);
  qarr = np_from_f32(q, nq, d);
  if (!qarr) goto fail;
  r = PyObject_CallMethod(es->obj, "set_topk", "i", k);
  if (!r) goto fail;
  Py_DECREF(r);
  acc = PyObject_CallMethod(g_np, "full", "Lfs", (long long)nq,
                            (double)require_acc, "float32");
  if (!acc) goto fail;
  r = PyObject_CallMethod(es->obj, "set_queries", "LOO", (long long)nq,
                          qarr, acc);
  if (!r) goto fail;
  Py_DECREF(r);
  if (multipler > 0) {
    r = PyObject_CallMethod(es->obj, "set_hyper", "ff", multipler,
                            std_m > 0 ? std_m : 1.0f);
    if (!r) goto fail;
    Py_DECREF(r);
  }
  res = PyObject_CallMethod(es->obj, "search", "iL", 0, (long long)nq);
  if (!res) goto fail;
  rc = 0;
  rc |= np_to_buf(PyTuple_GetItem(res, 0), "float32", out_d, nq * k * 4);
  rc |= np_to_buf(PyTuple_GetItem(res, 1), "int64", out_i, nq * k * 8);
fail:
  if (rc) set_error_from_python();
  Py_XDECREF(idx); Py_XDECREF(dobj); Py_XDECREF(qarr);
  Py_XDECREF(acc); Py_XDECREF(res);
  PyGILState_Release(st);
  return rc ? -3 : 0;
}

void auncel_errsys_free(auncel_errsys_t *es) {
  if (!es) return;
  PyGILState_STATE st = PyGILState_Ensure();
  Py_XDECREF(es->obj);
  PyGILState_Release(st);
  free(es);
}
