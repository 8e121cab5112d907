/* _fastcall — CPython extension wrapper over the engine's blocking mux
 * RPC (engine.cpp nc_mux_call).
 *
 * Why not ctypes: the sync Python user API is GIL-throughput-bound.
 * Every microsecond of per-call GIL-held work caps aggregate qps at
 * 1s/that (ctypes argument marshalling + NcResponse bookkeeping is
 * ~3-5us -> ~100k qps hard ceiling before any real work).  This module
 * does the same call in ~0.3us of GIL-held time: METH_FASTCALL (no
 * args tuple), direct PyBytes pointer access, one PyTuple result, and
 * the GIL released across the whole blocking round trip.
 *
 * The engine's entry points are injected as raw addresses at setup()
 * (resolved by ctypes from the already-loaded _engine.so) so this
 * module needs no link-time dependency on the engine.
 *
 * Reference parity: the public CallMethod IS the native hot path in
 * the reference (channel.cpp:407-584); this restores that property for
 * Python callers.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* mirror of engine.cpp's NcResponse (C ABI) */
typedef struct {
  uint8_t *data;
  uint64_t body_len;
  uint64_t attachment_size;
  int32_t error_code;
  int32_t compress_type;
  char error_text[240];
} NcResponse;

/* mirror of engine.cpp's MuxCompletion (C ABI) */
typedef struct {
  uint64_t tag;
  int32_t rc;
  int32_t error_code;
  int32_t compress_type;
  uint32_t attachment_size;
  uint64_t body_len;
  uint8_t *data;
  char error_text[96];
} MuxCompletion;

typedef int (*nc_mux_call_fn)(void *h, const char *service,
                              size_t service_len, const char *method,
                              size_t method_len, uint64_t log_id,
                              const uint8_t *payload, uint64_t payload_len,
                              const uint8_t *attachment,
                              uint64_t attachment_len, int timeout_ms,
                              NcResponse *out);
typedef uint64_t (*nc_mux_submit_fn)(void *h, const char *service,
                                     const char *method, uint64_t log_id,
                                     const uint8_t *payload,
                                     uint64_t payload_len,
                                     const uint8_t *attachment,
                                     uint64_t attachment_len, int timeout_ms,
                                     uint64_t tag);
typedef int (*nc_mux_poll_fn)(void *h, MuxCompletion *out, int max_n,
                              int timeout_ms);
typedef int (*nc_mux_submit_many_fn)(void *h, const char *service,
                                     const char *method, uint64_t log_id,
                                     const uint8_t *const *payloads,
                                     const uint64_t *lens, int n,
                                     int timeout_ms, uint64_t tag_base);
typedef int (*nc_mux_harvest_fn)(void *h, MuxCompletion *out, int max_n,
                                 int timeout_ms);
typedef int (*ns_send_burst_fn)(void *h, uint64_t conn_id,
                                const uint8_t *const *frames,
                                const uint64_t *lens, int n);

static nc_mux_call_fn g_mux_call = NULL;
static nc_mux_submit_fn g_mux_submit = NULL;
static nc_mux_poll_fn g_mux_poll = NULL;
static nc_mux_submit_many_fn g_mux_submit_many = NULL;
static nc_mux_harvest_fn g_mux_harvest = NULL;
static ns_send_burst_fn g_srv_send_burst = NULL;

/* One-deep per-thread freelist for mux_call's 6-tuple result — the
 * same trick CPython's zip()/enumerate() use: if the caller dropped
 * its reference (refcount back to 1, ours), no live reference exists
 * and the tuple can be refilled in place instead of allocated.  The
 * sync fast path calls this once per RPC, so the tuple alloc/free pair
 * is pure per-call overhead when the caller unpacks and discards. */
static _Thread_local PyObject *result_cache;

/* Build (or refill) the result tuple from 6 NEW references. */
static PyObject *result_tuple(PyObject *items[6]) {
  PyObject *t = result_cache;
  int i;
  if (t != NULL && Py_REFCNT(t) == 1) {
    for (i = 0; i < 6; i++) {
      PyObject *old = PyTuple_GET_ITEM(t, i);
      PyTuple_SET_ITEM(t, i, items[i]);
      Py_XDECREF(old);
    }
    Py_INCREF(t);
    return t;
  }
  t = PyTuple_New(6);
  if (t == NULL) {
    for (i = 0; i < 6; i++) Py_DECREF(items[i]);
    return NULL;
  }
  for (i = 0; i < 6; i++) PyTuple_SET_ITEM(t, i, items[i]);
  Py_XDECREF(result_cache);
  result_cache = t;
  Py_INCREF(t);
  return t;
}

static PyObject *setup(PyObject *self, PyObject *args) {
  unsigned long long a_call, a_submit, a_poll;
  unsigned long long a_submit_many = 0, a_harvest = 0, a_srv_burst = 0;
  if (!PyArg_ParseTuple(args, "KKK|KKK", &a_call, &a_submit, &a_poll,
                        &a_submit_many, &a_harvest, &a_srv_burst))
    return NULL;
  g_mux_call = (nc_mux_call_fn)(uintptr_t)a_call;
  g_mux_submit = (nc_mux_submit_fn)(uintptr_t)a_submit;
  g_mux_poll = (nc_mux_poll_fn)(uintptr_t)a_poll;
  g_mux_submit_many = (nc_mux_submit_many_fn)(uintptr_t)a_submit_many;
  g_mux_harvest = (nc_mux_harvest_fn)(uintptr_t)a_harvest;
  g_srv_send_burst = (ns_send_burst_fn)(uintptr_t)a_srv_burst;
  Py_RETURN_NONE;
}

/* mux_call(handle, service, method, payload, attachment, timeout_ms,
 *          log_id) -> (rc, body|None, att_size, error_code,
 *                      error_text|None, compress_type)
 * handle: int (MuxClient*); service/method/payload/attachment: bytes.
 */
static PyObject *mux_call(PyObject *self, PyObject *const *args,
                          Py_ssize_t nargs) {
  if (nargs != 7) {
    PyErr_SetString(PyExc_TypeError, "mux_call expects 7 args");
    return NULL;
  }
  if (g_mux_call == NULL) {
    PyErr_SetString(PyExc_RuntimeError, "fastcall.setup() not called");
    return NULL;
  }
  void *h = (void *)(uintptr_t)PyLong_AsUnsignedLongLong(args[0]);
  if (h == NULL && PyErr_Occurred()) return NULL;
  PyObject *svc = args[1], *meth = args[2], *pay = args[3], *att = args[4];
  if (!PyBytes_CheckExact(svc) || !PyBytes_CheckExact(meth) ||
      !PyBytes_CheckExact(pay) || !PyBytes_CheckExact(att)) {
    PyErr_SetString(PyExc_TypeError,
                    "service/method/payload/attachment must be bytes");
    return NULL;
  }
  long timeout_ms = PyLong_AsLong(args[5]);
  if (timeout_ms == -1 && PyErr_Occurred()) return NULL;
  unsigned long long log_id = PyLong_AsUnsignedLongLong(args[6]);
  if (log_id == (unsigned long long)-1 && PyErr_Occurred()) return NULL;

  NcResponse resp;
  int rc;
  Py_BEGIN_ALLOW_THREADS
  rc = g_mux_call(
      h, PyBytes_AS_STRING(svc), (size_t)PyBytes_GET_SIZE(svc),
      PyBytes_AS_STRING(meth), (size_t)PyBytes_GET_SIZE(meth),
      (uint64_t)log_id, (const uint8_t *)PyBytes_AS_STRING(pay),
      (uint64_t)PyBytes_GET_SIZE(pay),
      (const uint8_t *)PyBytes_AS_STRING(att),
      (uint64_t)PyBytes_GET_SIZE(att), (int)timeout_ms, &resp);
  Py_END_ALLOW_THREADS

  if (rc != 0) {
    /* transport error: no body */
    PyObject *items[6];
    items[0] = PyLong_FromLong(rc);
    Py_INCREF(Py_None);
    items[1] = Py_None;
    items[2] = PyLong_FromLong(0);
    items[3] = PyLong_FromLong(0);
    Py_INCREF(Py_None);
    items[4] = Py_None;
    items[5] = PyLong_FromLong(0);
    return result_tuple(items);
  }
  PyObject *body =
      PyBytes_FromStringAndSize((const char *)resp.data, (Py_ssize_t)resp.body_len);
  if (resp.data) free(resp.data); /* same-process heap: plain free */
  if (body == NULL) return NULL;
  PyObject *etext;
  if (resp.error_code != 0) {
    etext = PyUnicode_DecodeUTF8(resp.error_text, strlen(resp.error_text),
                                 "replace");
    if (etext == NULL) {
      Py_DECREF(body);
      return NULL;
    }
  } else {
    etext = Py_None;
    Py_INCREF(etext);
  }
  PyObject *items[6];
  items[0] = PyLong_FromLong(0);
  items[1] = body;
  items[2] = PyLong_FromUnsignedLongLong(resp.attachment_size);
  items[3] = PyLong_FromLong(resp.error_code);
  items[4] = etext;
  items[5] = PyLong_FromLong(resp.compress_type);
  return result_tuple(items);
}

/* mux_submit(handle, service, method, payload, attachment, timeout_ms,
 *            log_id, tag) -> cid (0 = shutdown/backlogged)
 * Enqueue one async RPC; the C reactor batches staged submissions from
 * all threads into single writes. */
static PyObject *mux_submit(PyObject *self, PyObject *const *args,
                            Py_ssize_t nargs) {
  if (nargs != 8) {
    PyErr_SetString(PyExc_TypeError, "mux_submit expects 8 args");
    return NULL;
  }
  if (g_mux_submit == NULL) {
    PyErr_SetString(PyExc_RuntimeError, "fastcall.setup() not called");
    return NULL;
  }
  void *h = (void *)(uintptr_t)PyLong_AsUnsignedLongLong(args[0]);
  if (h == NULL && PyErr_Occurred()) return NULL;
  PyObject *svc = args[1], *meth = args[2], *pay = args[3], *att = args[4];
  if (!PyBytes_CheckExact(svc) || !PyBytes_CheckExact(meth) ||
      !PyBytes_CheckExact(pay) || !PyBytes_CheckExact(att)) {
    PyErr_SetString(PyExc_TypeError,
                    "service/method/payload/attachment must be bytes");
    return NULL;
  }
  long timeout_ms = PyLong_AsLong(args[5]);
  if (timeout_ms == -1 && PyErr_Occurred()) return NULL;
  unsigned long long log_id = PyLong_AsUnsignedLongLong(args[6]);
  if (log_id == (unsigned long long)-1 && PyErr_Occurred()) return NULL;
  unsigned long long tag = PyLong_AsUnsignedLongLong(args[7]);
  if (tag == (unsigned long long)-1 && PyErr_Occurred()) return NULL;
  /* Deliberately KEEP the GIL: the submit is ~1us of staging, and a
   * release here invites an OS switch to the harvester thread and back
   * on every call — two context switches per RPC on a single core.
   * Holding through keeps the submitter's timeslice intact so the GIL
   * changes hands per completion BATCH instead. */
  uint64_t cid = g_mux_submit(
      h, PyBytes_AS_STRING(svc), PyBytes_AS_STRING(meth), (uint64_t)log_id,
      (const uint8_t *)PyBytes_AS_STRING(pay),
      (uint64_t)PyBytes_GET_SIZE(pay),
      (const uint8_t *)PyBytes_AS_STRING(att),
      (uint64_t)PyBytes_GET_SIZE(att), (int)timeout_ms, (uint64_t)tag);
  return PyLong_FromUnsignedLongLong(cid);
}

#define POLL_BATCH 128

/* ---- submission/completion ring (io_uring-style vectorized calls) ---- */

#define RING_WINDOW_MAX 1024

/* mux_submit_many(handle, service, method, payloads, timeout_ms, log_id,
 *                 tag_base) -> staged count (k < len(payloads) means
 * slots k.. were NOT staged; the caller fails them)
 * payloads: list of bytes, one same-method request body per slot.  ONE
 * Python→C crossing stages the whole window (engine nc_mux_submit_many:
 * one lock pass, one staging append, one reactor wake).  The GIL is
 * RELEASED across the staging copy — a 128×64KB window is ~8MB of
 * memcpy, far past the keep-the-GIL threshold mux_submit sits under.
 * Each payload is INCREF'd across the release so a concurrent list
 * mutation cannot free a body mid-copy. */
static PyObject *mux_submit_many(PyObject *self, PyObject *const *args,
                                 Py_ssize_t nargs) {
  if (nargs != 7) {
    PyErr_SetString(PyExc_TypeError, "mux_submit_many expects 7 args");
    return NULL;
  }
  if (g_mux_submit_many == NULL) {
    PyErr_SetString(PyExc_RuntimeError,
                    "fastcall.setup() missing submit_many address");
    return NULL;
  }
  void *h = (void *)(uintptr_t)PyLong_AsUnsignedLongLong(args[0]);
  if (h == NULL && PyErr_Occurred()) return NULL;
  PyObject *svc = args[1], *meth = args[2], *payloads = args[3];
  if (!PyBytes_CheckExact(svc) || !PyBytes_CheckExact(meth)) {
    PyErr_SetString(PyExc_TypeError, "service/method must be bytes");
    return NULL;
  }
  if (!PyList_CheckExact(payloads)) {
    PyErr_SetString(PyExc_TypeError, "payloads must be a list of bytes");
    return NULL;
  }
  long timeout_ms = PyLong_AsLong(args[4]);
  if (timeout_ms == -1 && PyErr_Occurred()) return NULL;
  unsigned long long log_id = PyLong_AsUnsignedLongLong(args[5]);
  if (log_id == (unsigned long long)-1 && PyErr_Occurred()) return NULL;
  unsigned long long tag_base = PyLong_AsUnsignedLongLong(args[6]);
  if (tag_base == (unsigned long long)-1 && PyErr_Occurred()) return NULL;
  Py_ssize_t n = PyList_GET_SIZE(payloads);
  if (n <= 0) return PyLong_FromLong(0);
  if (n > RING_WINDOW_MAX) {
    PyErr_SetString(PyExc_ValueError, "window exceeds RING_WINDOW_MAX");
    return NULL;
  }
  static _Thread_local const uint8_t *ptrs[RING_WINDOW_MAX];
  static _Thread_local uint64_t lens[RING_WINDOW_MAX];
  static _Thread_local PyObject *held[RING_WINDOW_MAX];
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *b = PyList_GET_ITEM(payloads, i);
    if (!PyBytes_CheckExact(b)) {
      for (Py_ssize_t j = 0; j < i; j++) Py_DECREF(held[j]);
      PyErr_SetString(PyExc_TypeError, "payloads must be a list of bytes");
      return NULL;
    }
    Py_INCREF(b);
    held[i] = b;
    ptrs[i] = (const uint8_t *)PyBytes_AS_STRING(b);
    lens[i] = (uint64_t)PyBytes_GET_SIZE(b);
  }
  int staged;
  Py_BEGIN_ALLOW_THREADS
  staged = g_mux_submit_many(h, PyBytes_AS_STRING(svc),
                             PyBytes_AS_STRING(meth), (uint64_t)log_id, ptrs,
                             lens, (int)n, (int)timeout_ms,
                             (uint64_t)tag_base);
  Py_END_ALLOW_THREADS
  for (Py_ssize_t i = 0; i < n; i++) Py_DECREF(held[i]);
  return PyLong_FromLong(staged);
}

/* srv_send_burst(handle, conn_id, frames) -> rc
 * Server response ring: flush one harvested window of response frames
 * for a native connection as ONE writev burst (engine ns_send_burst —
 * the server half of mux_submit_many).  frames: list of bytes, one
 * serialized tpu_std response frame per slot.  Each frame is INCREF'd
 * across the GIL release so a concurrent mutation cannot free bytes
 * the engine is still reading (the engine copies any unsent remainder
 * before returning, so nothing is borrowed past the call). */
static PyObject *srv_send_burst(PyObject *self, PyObject *const *args,
                                Py_ssize_t nargs) {
  if (nargs != 3) {
    PyErr_SetString(PyExc_TypeError,
                    "srv_send_burst expects (handle, conn_id, frames)");
    return NULL;
  }
  if (g_srv_send_burst == NULL) {
    PyErr_SetString(PyExc_RuntimeError,
                    "fastcall.setup() missing srv_send_burst address");
    return NULL;
  }
  void *h = (void *)(uintptr_t)PyLong_AsUnsignedLongLong(args[0]);
  if (h == NULL && PyErr_Occurred()) return NULL;
  unsigned long long conn_id = PyLong_AsUnsignedLongLong(args[1]);
  if (conn_id == (unsigned long long)-1 && PyErr_Occurred()) return NULL;
  PyObject *frames = args[2];
  if (!PyList_CheckExact(frames)) {
    PyErr_SetString(PyExc_TypeError, "frames must be a list of bytes");
    return NULL;
  }
  Py_ssize_t n = PyList_GET_SIZE(frames);
  if (n <= 0) return PyLong_FromLong(0);
  if (n > RING_WINDOW_MAX) {
    PyErr_SetString(PyExc_ValueError, "window exceeds RING_WINDOW_MAX");
    return NULL;
  }
  static _Thread_local const uint8_t *ptrs[RING_WINDOW_MAX];
  static _Thread_local uint64_t lens[RING_WINDOW_MAX];
  static _Thread_local PyObject *held[RING_WINDOW_MAX];
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *b = PyList_GET_ITEM(frames, i);
    if (!PyBytes_CheckExact(b)) {
      for (Py_ssize_t j = 0; j < i; j++) Py_DECREF(held[j]);
      PyErr_SetString(PyExc_TypeError, "frames must be a list of bytes");
      return NULL;
    }
    Py_INCREF(b);
    held[i] = b;
    ptrs[i] = (const uint8_t *)PyBytes_AS_STRING(b);
    lens[i] = (uint64_t)PyBytes_GET_SIZE(b);
  }
  int rc;
  Py_BEGIN_ALLOW_THREADS
  rc = g_srv_send_burst(h, (uint64_t)conn_id, ptrs, lens, (int)n);
  Py_END_ALLOW_THREADS
  for (Py_ssize_t i = 0; i < n; i++) Py_DECREF(held[i]);
  return PyLong_FromLong(rc);
}

/* mux_harvest(handle, timeout_ms, ring) -> n
 * Harvest up to min(len(ring), 128) RING-lane completions into the
 * PREALLOCATED completion ring: ring is a list of 7-slot lists the
 * caller reuses across harvests, so the steady state allocates only
 * the per-field ints/bytes, never the containers.  Slot layout matches
 * mux_poll's tuples: [tag, rc, body|None, att_size, error_code,
 * error_text|None, compress_type]. */
static PyObject *mux_harvest(PyObject *self, PyObject *const *args,
                             Py_ssize_t nargs) {
  if (nargs != 3) {
    PyErr_SetString(PyExc_TypeError,
                    "mux_harvest expects (handle, timeout_ms, ring)");
    return NULL;
  }
  if (g_mux_harvest == NULL) {
    PyErr_SetString(PyExc_RuntimeError,
                    "fastcall.setup() missing harvest address");
    return NULL;
  }
  void *h = (void *)(uintptr_t)PyLong_AsUnsignedLongLong(args[0]);
  if (h == NULL && PyErr_Occurred()) return NULL;
  long timeout_ms = PyLong_AsLong(args[1]);
  if (timeout_ms == -1 && PyErr_Occurred()) return NULL;
  PyObject *ring = args[2];
  if (!PyList_CheckExact(ring)) {
    PyErr_SetString(PyExc_TypeError, "ring must be a list of 7-slot lists");
    return NULL;
  }
  Py_ssize_t depth = PyList_GET_SIZE(ring);
  int max_n = depth < POLL_BATCH ? (int)depth : POLL_BATCH;
  static _Thread_local MuxCompletion comps[POLL_BATCH];
  int n;
  Py_BEGIN_ALLOW_THREADS
  n = g_mux_harvest(h, comps, max_n, (int)timeout_ms);
  Py_END_ALLOW_THREADS
  for (int i = 0; i < n; i++) {
    MuxCompletion *c = &comps[i];
    PyObject *slot = PyList_GET_ITEM(ring, i);
    if (!PyList_CheckExact(slot) || PyList_GET_SIZE(slot) < 7) {
      PyErr_SetString(PyExc_TypeError, "ring slots must be 7-slot lists");
      goto fail;
    }
    PyObject *body, *etext;
    if (c->rc == 0) {
      body = PyBytes_FromStringAndSize((const char *)c->data,
                                       (Py_ssize_t)c->body_len);
    } else {
      body = Py_None;
      Py_INCREF(body);
    }
    if (c->data) {
      free(c->data);
      c->data = NULL;
    }
    if (body == NULL) goto fail;
    if (c->error_code != 0) {
      etext = PyUnicode_DecodeUTF8(c->error_text, strlen(c->error_text),
                                   "replace");
      if (etext == NULL) {
        Py_DECREF(body);
        goto fail;
      }
    } else {
      etext = Py_None;
      Py_INCREF(etext);
    }
    /* PyList_SetItem steals the new ref and releases the old slot */
    PyList_SetItem(slot, 0, PyLong_FromUnsignedLongLong(c->tag));
    PyList_SetItem(slot, 1, PyLong_FromLong(c->rc));
    PyList_SetItem(slot, 2, body);
    PyList_SetItem(slot, 3, PyLong_FromUnsignedLong(c->attachment_size));
    PyList_SetItem(slot, 4, PyLong_FromLong(c->error_code));
    PyList_SetItem(slot, 5, etext);
    PyList_SetItem(slot, 6, PyLong_FromLong(c->compress_type));
  }
  return PyLong_FromLong(n);
fail:
  for (int i = 0; i < n; i++) {
    if (comps[i].data) {
      free(comps[i].data);
      comps[i].data = NULL;
    }
  }
  return NULL;
}

/* mux_poll(handle, timeout_ms) -> list of
 *   (tag, rc, body|None, att_size, error_code, error_text|None, ctype)
 * Harvest up to 128 completions in one GIL-held pass: the tuples are
 * built in C, bodies become bytes and are freed inline. */
static PyObject *mux_poll(PyObject *self, PyObject *const *args,
                          Py_ssize_t nargs) {
  if (nargs != 2) {
    PyErr_SetString(PyExc_TypeError, "mux_poll expects (handle, timeout_ms)");
    return NULL;
  }
  if (g_mux_poll == NULL) {
    PyErr_SetString(PyExc_RuntimeError, "fastcall.setup() not called");
    return NULL;
  }
  void *h = (void *)(uintptr_t)PyLong_AsUnsignedLongLong(args[0]);
  if (h == NULL && PyErr_Occurred()) return NULL;
  long timeout_ms = PyLong_AsLong(args[1]);
  if (timeout_ms == -1 && PyErr_Occurred()) return NULL;
  static _Thread_local MuxCompletion comps[POLL_BATCH];
  int n;
  Py_BEGIN_ALLOW_THREADS
  n = g_mux_poll(h, comps, POLL_BATCH, (int)timeout_ms);
  Py_END_ALLOW_THREADS
  PyObject *list = PyList_New(n > 0 ? n : 0);
  if (list == NULL) goto fail;
  for (int i = 0; i < n; i++) {
    MuxCompletion *c = &comps[i];
    PyObject *body, *etext;
    if (c->rc == 0) {
      body = PyBytes_FromStringAndSize((const char *)c->data,
                                       (Py_ssize_t)c->body_len);
    } else {
      body = Py_None;
      Py_INCREF(body);
    }
    if (c->data) {
      free(c->data);
      c->data = NULL;
    }
    if (body == NULL) goto fail;
    if (c->error_code != 0) {
      etext = PyUnicode_DecodeUTF8(c->error_text, strlen(c->error_text),
                                   "replace");
      if (etext == NULL) {
        Py_DECREF(body);
        goto fail;
      }
    } else {
      etext = Py_None;
      Py_INCREF(etext);
    }
    PyObject *t = PyTuple_New(7);
    if (t == NULL) {
      Py_DECREF(body);
      Py_DECREF(etext);
      goto fail;
    }
    PyTuple_SET_ITEM(t, 0, PyLong_FromUnsignedLongLong(c->tag));
    PyTuple_SET_ITEM(t, 1, PyLong_FromLong(c->rc));
    PyTuple_SET_ITEM(t, 2, body);
    PyTuple_SET_ITEM(t, 3, PyLong_FromUnsignedLong(c->attachment_size));
    PyTuple_SET_ITEM(t, 4, PyLong_FromLong(c->error_code));
    PyTuple_SET_ITEM(t, 5, etext);
    PyTuple_SET_ITEM(t, 6, PyLong_FromLong(c->compress_type));
    PyList_SET_ITEM(list, i, t);
  }
  return list;
fail:
  /* free any bodies not yet converted so the malloc'd responses can't
   * leak on an allocation failure mid-batch */
  for (int i = 0; i < n; i++) {
    if (comps[i].data) {
      free(comps[i].data);
      comps[i].data = NULL;
    }
  }
  Py_XDECREF(list);
  return NULL;
}

/* mux_call_fast — same wire call as mux_call, leaner result contract:
 * the common shape (transport ok, no app error, no attachment, no
 * compression) returns the body BYTES directly — no 6-tuple to build,
 * refill, or unpack per call.  Anything else returns the same 6-tuple
 * as mux_call so the caller's slow path stays shared. */
static PyObject *mux_call_fast(PyObject *self, PyObject *const *args,
                               Py_ssize_t nargs) {
  if (nargs != 7) {
    PyErr_SetString(PyExc_TypeError, "mux_call_fast expects 7 args");
    return NULL;
  }
  if (g_mux_call == NULL) {
    PyErr_SetString(PyExc_RuntimeError, "fastcall.setup() not called");
    return NULL;
  }
  void *h = (void *)(uintptr_t)PyLong_AsUnsignedLongLong(args[0]);
  if (h == NULL && PyErr_Occurred()) return NULL;
  PyObject *svc = args[1], *meth = args[2], *pay = args[3], *att = args[4];
  if (!PyBytes_CheckExact(svc) || !PyBytes_CheckExact(meth) ||
      !PyBytes_CheckExact(pay) || !PyBytes_CheckExact(att)) {
    PyErr_SetString(PyExc_TypeError,
                    "service/method/payload/attachment must be bytes");
    return NULL;
  }
  long timeout_ms = PyLong_AsLong(args[5]);
  if (timeout_ms == -1 && PyErr_Occurred()) return NULL;
  unsigned long long log_id = PyLong_AsUnsignedLongLong(args[6]);
  if (log_id == (unsigned long long)-1 && PyErr_Occurred()) return NULL;

  NcResponse resp;
  int rc;
  Py_BEGIN_ALLOW_THREADS
  rc = g_mux_call(
      h, PyBytes_AS_STRING(svc), (size_t)PyBytes_GET_SIZE(svc),
      PyBytes_AS_STRING(meth), (size_t)PyBytes_GET_SIZE(meth),
      (uint64_t)log_id, (const uint8_t *)PyBytes_AS_STRING(pay),
      (uint64_t)PyBytes_GET_SIZE(pay),
      (const uint8_t *)PyBytes_AS_STRING(att),
      (uint64_t)PyBytes_GET_SIZE(att), (int)timeout_ms, &resp);
  Py_END_ALLOW_THREADS

  if (rc == 0 && resp.error_code == 0 && resp.attachment_size == 0 &&
      resp.compress_type == 0) {
    PyObject *body = PyBytes_FromStringAndSize((const char *)resp.data,
                                               (Py_ssize_t)resp.body_len);
    if (resp.data) free(resp.data);
    return body;
  }
  if (rc != 0) {
    PyObject *items[6];
    items[0] = PyLong_FromLong(rc);
    Py_INCREF(Py_None);
    items[1] = Py_None;
    items[2] = PyLong_FromLong(0);
    items[3] = PyLong_FromLong(0);
    Py_INCREF(Py_None);
    items[4] = Py_None;
    items[5] = PyLong_FromLong(0);
    return result_tuple(items);
  }
  PyObject *body = PyBytes_FromStringAndSize((const char *)resp.data,
                                             (Py_ssize_t)resp.body_len);
  if (resp.data) free(resp.data);
  if (body == NULL) return NULL;
  PyObject *etext;
  if (resp.error_code != 0) {
    etext = PyUnicode_DecodeUTF8(resp.error_text, strlen(resp.error_text),
                                 "replace");
    if (etext == NULL) {
      Py_DECREF(body);
      return NULL;
    }
  } else {
    etext = Py_None;
    Py_INCREF(etext);
  }
  PyObject *items[6];
  items[0] = PyLong_FromLong(0);
  items[1] = body;
  items[2] = PyLong_FromUnsignedLongLong(resp.attachment_size);
  items[3] = PyLong_FromLong(resp.error_code);
  items[4] = etext;
  items[5] = PyLong_FromLong(resp.compress_type);
  return result_tuple(items);
}

/* mux_poll_dispatch(handle, timeout_ms, cb) -> n
 * Harvest one batch and dispatch each completion from C:
 *   cb(tag, rc, body|None, att_size, error_code, error_text|None, ctype)
 * The per-completion list/tuple of mux_poll disappears — Python is
 * entered once per completion, for the dispatch itself (the user done
 * code).  A raising cb is reported via sys.unraisablehook and the
 * batch continues: one bad done() must not kill the harvester. */
static PyObject *mux_poll_dispatch(PyObject *self, PyObject *const *args,
                                   Py_ssize_t nargs) {
  if (nargs != 3) {
    PyErr_SetString(PyExc_TypeError,
                    "mux_poll_dispatch expects (handle, timeout_ms, cb)");
    return NULL;
  }
  if (g_mux_poll == NULL) {
    PyErr_SetString(PyExc_RuntimeError, "fastcall.setup() not called");
    return NULL;
  }
  void *h = (void *)(uintptr_t)PyLong_AsUnsignedLongLong(args[0]);
  if (h == NULL && PyErr_Occurred()) return NULL;
  long timeout_ms = PyLong_AsLong(args[1]);
  if (timeout_ms == -1 && PyErr_Occurred()) return NULL;
  PyObject *cb = args[2];
  static _Thread_local MuxCompletion comps[POLL_BATCH];
  int n;
  Py_BEGIN_ALLOW_THREADS
  n = g_mux_poll(h, comps, POLL_BATCH, (int)timeout_ms);
  Py_END_ALLOW_THREADS
  for (int i = 0; i < n; i++) {
    MuxCompletion *c = &comps[i];
    PyObject *argv[7];
    argv[0] = PyLong_FromUnsignedLongLong(c->tag);
    argv[1] = PyLong_FromLong(c->rc);
    if (c->rc == 0) {
      argv[2] = PyBytes_FromStringAndSize((const char *)c->data,
                                          (Py_ssize_t)c->body_len);
    } else {
      argv[2] = Py_None;
      Py_INCREF(Py_None);
    }
    if (c->data) {
      free(c->data);
      c->data = NULL;
    }
    argv[3] = PyLong_FromUnsignedLong(c->attachment_size);
    argv[4] = PyLong_FromLong(c->error_code);
    if (c->error_code != 0) {
      argv[5] = PyUnicode_DecodeUTF8(c->error_text, strlen(c->error_text),
                                     "replace");
    } else {
      argv[5] = Py_None;
      Py_INCREF(Py_None);
    }
    argv[6] = PyLong_FromLong(c->compress_type);
    int bad = 0;
    for (int j = 0; j < 7; j++) bad |= argv[j] == NULL;
    if (bad) {
      for (int j = 0; j < 7; j++) Py_XDECREF(argv[j]);
      for (int k = i + 1; k < n; k++) {
        if (comps[k].data) {
          free(comps[k].data);
          comps[k].data = NULL;
        }
      }
      return NULL;
    }
    PyObject *r = PyObject_Vectorcall(cb, argv, 7, NULL);
    if (r == NULL) {
      PyErr_WriteUnraisable(cb);
    } else {
      Py_DECREF(r);
    }
    for (int j = 0; j < 7; j++) Py_DECREF(argv[j]);
  }
  return PyLong_FromLong(n);
}

static PyMethodDef methods[] = {
    {"setup", setup, METH_VARARGS,
     "setup(nc_mux_call_addr) — inject the engine entry point"},
    {"mux_call", (PyCFunction)mux_call, METH_FASTCALL,
     "blocking mux RPC, GIL released for the round trip"},
    {"mux_call_fast", (PyCFunction)mux_call_fast, METH_FASTCALL,
     "blocking mux RPC; common shape returns body bytes directly"},
    {"mux_submit", (PyCFunction)mux_submit, METH_FASTCALL,
     "enqueue one async RPC on the mux reactor"},
    {"mux_poll", (PyCFunction)mux_poll, METH_FASTCALL,
     "harvest a batch of completions as tuples"},
    {"mux_poll_dispatch", (PyCFunction)mux_poll_dispatch, METH_FASTCALL,
     "harvest a batch and invoke cb per completion from C"},
    {"mux_submit_many", (PyCFunction)mux_submit_many, METH_FASTCALL,
     "stage a window of same-method RPCs in one crossing"},
    {"mux_harvest", (PyCFunction)mux_harvest, METH_FASTCALL,
     "harvest ring-lane completions into a preallocated ring"},
    {"srv_send_burst", (PyCFunction)srv_send_burst, METH_FASTCALL,
     "flush one window of server response frames as one writev burst"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fastcall",
    "low-overhead blocking RPC over the native mux reactor", -1, methods};

PyMODINIT_FUNC PyInit__fastcall(void) { return PyModule_Create(&moduledef); }
