/* Native sorted-array kernels — the framework's hottest host-side loops.
 *
 * Reference: accord/utils/SortedArrays.java:44 (linearUnion /
 * linearIntersection / linearSubtract and the binary-search family). These
 * run under every Keys/RoutingKeys/TxnId merge in the protocol engine, so
 * they get a C implementation mirroring accord_tpu_torch/utils/sorted_arrays.py
 * exactly — including the identity-return convention of linear_union (one
 * input subsuming the other is returned as the SAME object so singleton
 * checks like KeyDeps.NONE keep working).
 *
 * Elements are arbitrary Python objects ordered via rich comparison (<),
 * exactly like the Python tier; comparison errors propagate.
 *
 * Built on first import by accord_tpu_torch/native/__init__.py (g++ into a cached
 * shared object); everything falls back to the Python tier when no
 * toolchain is present.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

namespace {

/* a < b via rich comparison; -1 on error */
inline int lt(PyObject *a, PyObject *b) {
    return PyObject_RichCompareBool(a, b, Py_LT);
}

struct FastSeq {
    PyObject *seq = nullptr;
    PyObject **items = nullptr;
    Py_ssize_t n = 0;

    bool init(PyObject *obj) {
        seq = PySequence_Fast(obj, "expected a sequence");
        if (seq == nullptr) return false;
        items = PySequence_Fast_ITEMS(seq);
        n = PySequence_Fast_GET_SIZE(seq);
        return true;
    }
    ~FastSeq() { Py_XDECREF(seq); }
};

PyObject *linear_union(PyObject *, PyObject *args) {
    PyObject *ao, *bo;
    if (!PyArg_ParseTuple(args, "OO", &ao, &bo)) return nullptr;
    FastSeq a, b;
    if (!a.init(ao) || !b.init(bo)) return nullptr;
    if (a.n == 0) {
        if (PyList_Check(bo)) { Py_INCREF(bo); return bo; }
        return PySequence_List(bo);
    }
    if (b.n == 0) {
        if (PyList_Check(ao)) { Py_INCREF(ao); return ao; }
        return PySequence_List(ao);
    }
    PyObject *out = PyList_New(0);
    if (out == nullptr) return nullptr;
    Py_ssize_t i = 0, j = 0;
    while (i < a.n && j < b.n) {
        PyObject *x = a.items[i], *y = b.items[j];
        int xy = lt(x, y);
        if (xy < 0) goto fail;
        if (xy) {
            if (PyList_Append(out, x) < 0) goto fail;
            ++i;
        } else {
            int yx = lt(y, x);
            if (yx < 0) goto fail;
            if (yx) {
                if (PyList_Append(out, y) < 0) goto fail;
                ++j;
            } else {
                if (PyList_Append(out, x) < 0) goto fail;
                ++i; ++j;
            }
        }
    }
    for (; i < a.n; ++i)
        if (PyList_Append(out, a.items[i]) < 0) goto fail;
    for (; j < b.n; ++j)
        if (PyList_Append(out, b.items[j]) < 0) goto fail;
    return out;
fail:
    Py_DECREF(out);
    return nullptr;
}

PyObject *linear_intersection(PyObject *, PyObject *args) {
    PyObject *ao, *bo;
    if (!PyArg_ParseTuple(args, "OO", &ao, &bo)) return nullptr;
    FastSeq a, b;
    if (!a.init(ao) || !b.init(bo)) return nullptr;
    PyObject *out = PyList_New(0);
    if (out == nullptr) return nullptr;
    Py_ssize_t i = 0, j = 0;
    while (i < a.n && j < b.n) {
        PyObject *x = a.items[i], *y = b.items[j];
        int xy = lt(x, y);
        if (xy < 0) goto fail;
        if (xy) { ++i; continue; }
        int yx = lt(y, x);
        if (yx < 0) goto fail;
        if (yx) { ++j; continue; }
        if (PyList_Append(out, x) < 0) goto fail;
        ++i; ++j;
    }
    return out;
fail:
    Py_DECREF(out);
    return nullptr;
}

PyObject *linear_subtract(PyObject *, PyObject *args) {
    PyObject *ao, *bo;
    if (!PyArg_ParseTuple(args, "OO", &ao, &bo)) return nullptr;
    FastSeq a, b;
    if (!a.init(ao) || !b.init(bo)) return nullptr;
    PyObject *out = PyList_New(0);
    if (out == nullptr) return nullptr;
    Py_ssize_t i = 0, j = 0;
    while (i < a.n && j < b.n) {
        PyObject *x = a.items[i], *y = b.items[j];
        int xy = lt(x, y);
        if (xy < 0) goto fail;
        if (xy) {
            if (PyList_Append(out, x) < 0) goto fail;
            ++i; continue;
        }
        int yx = lt(y, x);
        if (yx < 0) goto fail;
        if (yx) { ++j; continue; }
        ++i; ++j;
    }
    for (; i < a.n; ++i)
        if (PyList_Append(out, a.items[i]) < 0) goto fail;
    return out;
fail:
    Py_DECREF(out);
    return nullptr;
}

/* binary_search(xs, target, lo=0, hi=None) -> match index or
 * -(insertion_point)-1, the Java convention the Python tier mirrors */
PyObject *binary_search(PyObject *, PyObject *args) {
    PyObject *xso, *target, *hio = Py_None;
    Py_ssize_t lo = 0;
    if (!PyArg_ParseTuple(args, "OO|nO", &xso, &target, &lo, &hio))
        return nullptr;
    FastSeq xs;
    if (!xs.init(xso)) return nullptr;
    Py_ssize_t hi = xs.n;
    if (hio != Py_None) {
        hi = PyNumber_AsSsize_t(hio, PyExc_OverflowError);
        if (hi == -1 && PyErr_Occurred()) return nullptr;
    }
    /* out-of-contract bounds raise exactly like the Python tier's xs[mid]
     * would — never read outside the item array */
    if (lo < 0 || hi > xs.n) {
        PyErr_SetString(PyExc_IndexError, "binary_search bounds outside sequence");
        return nullptr;
    }
    while (lo < hi) {
        Py_ssize_t mid = (lo + hi) / 2;
        PyObject *v = xs.items[mid];
        int vlt = lt(v, target);
        if (vlt < 0) return nullptr;
        if (vlt) { lo = mid + 1; continue; }
        int tlt = lt(target, v);
        if (tlt < 0) return nullptr;
        if (tlt) hi = mid;
        else return PyLong_FromSsize_t(mid);
    }
    return PyLong_FromSsize_t(-(lo + 1));
}

/* k-way union of sorted unique sequences: iterative pairwise merge run
 * entirely natively (the RelationMultiMap.LinearMerger id-pool union). */
PyObject *merge_two(PyObject *ao, PyObject *bo) {
    PyObject *args = PyTuple_Pack(2, ao, bo);
    if (args == nullptr) return nullptr;
    PyObject *out = linear_union(nullptr, args);
    Py_DECREF(args);
    return out;
}

PyObject *linear_merge_n(PyObject *, PyObject *args) {
    PyObject *listso;
    if (!PyArg_ParseTuple(args, "O", &listso)) return nullptr;
    FastSeq lists;
    if (!lists.init(listso)) return nullptr;
    if (lists.n == 0) return PyList_New(0);
    PyObject *acc = PySequence_List(lists.items[0]);
    if (acc == nullptr) return nullptr;
    for (Py_ssize_t i = 1; i < lists.n; ++i) {
        PyObject *next = merge_two(acc, lists.items[i]);
        Py_DECREF(acc);
        if (next == nullptr) return nullptr;
        acc = next;
    }
    return acc;
}

/* ---- CINTIA checkpoint-interval stabbing over int64 interval arrays ----
 * Mirrors accord_tpu_torch/utils/checkpoint_intervals.py exactly (reference
 * CheckpointIntervalArray.java:28-84): same checkpoint layout, same visit
 * order. Values must fit int64; the Python tier handles anything wider.
 *
 * cintia_build converts once and returns an opaque capsule holding the
 * int64 arrays (intervals + checkpoint CSR); queries run against the
 * capsule with NO per-query marshalling — the O(lg N + K) contract holds
 * natively. */

struct Cintia {
    long long *starts = nullptr, *ends = nullptr;
    long long *offsets = nullptr, *entries = nullptr;
    Py_ssize_t n = 0, n_offsets = 0, n_entries = 0, every = 1;

    ~Cintia() {
        PyMem_Free(starts); PyMem_Free(ends);
        PyMem_Free(offsets); PyMem_Free(entries);
    }
};

void cintia_destroy(PyObject *capsule) {
    delete (Cintia *)PyCapsule_GetPointer(capsule, "accord.cintia");
}

long long *to_i64(PyObject *obj, Py_ssize_t *out_n) {
    FastSeq seq;
    if (!seq.init(obj)) return nullptr;
    *out_n = seq.n;
    long long *v = (long long *)PyMem_Malloc(
        sizeof(long long) * (seq.n ? seq.n : 1));
    if (v == nullptr) { PyErr_NoMemory(); return nullptr; }
    for (Py_ssize_t i = 0; i < seq.n; ++i) {
        long long x = PyLong_AsLongLong(seq.items[i]);
        if (x == -1 && PyErr_Occurred()) { PyMem_Free(v); return nullptr; }
        v[i] = x;
    }
    return v;
}

/* count of elements <= x (bisect_right) / < x (bisect_left) */
inline Py_ssize_t upper_bound(const long long *v, Py_ssize_t n, long long x) {
    Py_ssize_t lo = 0, hi = n;
    while (lo < hi) {
        Py_ssize_t mid = (lo + hi) / 2;
        if (v[mid] <= x) lo = mid + 1; else hi = mid;
    }
    return lo;
}
inline Py_ssize_t lower_bound(const long long *v, Py_ssize_t n, long long x) {
    Py_ssize_t lo = 0, hi = n;
    while (lo < hi) {
        Py_ssize_t mid = (lo + hi) / 2;
        if (v[mid] < x) lo = mid + 1; else hi = mid;
    }
    return lo;
}

PyObject *cintia_build(PyObject *, PyObject *args) {
    PyObject *so, *eo;
    Py_ssize_t every;
    if (!PyArg_ParseTuple(args, "OOn", &so, &eo, &every)) return nullptr;
    Cintia *c = new Cintia();
    c->every = every > 0 ? every : 1;
    Py_ssize_t n_ends = 0;
    c->starts = to_i64(so, &c->n);
    if (c->starts == nullptr) { delete c; return nullptr; }
    c->ends = to_i64(eo, &n_ends);
    if (c->ends == nullptr || n_ends != c->n) {
        delete c;
        if (!PyErr_Occurred())
            PyErr_SetString(PyExc_ValueError, "starts/ends length mismatch");
        return nullptr;
    }
    Py_ssize_t n_cp = c->n ? (c->n + c->every - 1) / c->every : 0;
    c->offsets = (long long *)PyMem_Malloc(
        sizeof(long long) * (n_cp ? n_cp : 1));
    if (c->offsets == nullptr) { delete c; PyErr_NoMemory(); return nullptr; }
    /* single pass; entries grows by doubling */
    Py_ssize_t cap = 16;
    c->entries = (long long *)PyMem_Malloc(sizeof(long long) * cap);
    if (c->entries == nullptr) { delete c; PyErr_NoMemory(); return nullptr; }
    Py_ssize_t e = 0, ci = 0;
    for (Py_ssize_t cp = 0; cp < c->n; cp += c->every) {
        if (cp > 0) {
            long long boundary = c->starts[cp];
            for (Py_ssize_t i = 0; i < cp; ++i) {
                if (c->ends[i] > boundary) {
                    if (e == cap) {
                        cap *= 2;
                        long long *grown = (long long *)PyMem_Realloc(
                            c->entries, sizeof(long long) * cap);
                        if (grown == nullptr) {
                            delete c; PyErr_NoMemory(); return nullptr;
                        }
                        c->entries = grown;
                    }
                    c->entries[e++] = i;
                }
            }
        }
        c->offsets[ci++] = e;
    }
    c->n_offsets = ci;
    c->n_entries = e;
    if (e < cap) {  /* shrink the doubling overshoot to fit */
        long long *fit = (long long *)PyMem_Realloc(
            c->entries, sizeof(long long) * (e ? e : 1));
        if (fit != nullptr) c->entries = fit;
    }
    PyObject *capsule = PyCapsule_New(c, "accord.cintia", cintia_destroy);
    if (capsule == nullptr) delete c;
    return capsule;
}

inline Cintia *get_cintia(PyObject *capsule) {
    return (Cintia *)PyCapsule_GetPointer(capsule, "accord.cintia");
}

/* visit checkpoint-open intervals for the block of `j` (count of starts <=
 * point), then the run [cp, j), appending indices with end > point */
bool visit_stab(const Cintia *c, long long point, Py_ssize_t j,
                PyObject *out) {
    if (j == 0) return true;
    Py_ssize_t cp = ((j - 1) / c->every) * c->every;
    Py_ssize_t ci = cp / c->every;
    Py_ssize_t lo = ci > 0 ? (Py_ssize_t)c->offsets[ci - 1] : 0;
    Py_ssize_t hi = (Py_ssize_t)c->offsets[ci];
    for (Py_ssize_t e = lo; e < hi; ++e) {
        Py_ssize_t i = (Py_ssize_t)c->entries[e];
        if (c->ends[i] > point) {
            PyObject *idx = PyLong_FromSsize_t(i);
            if (idx == nullptr || PyList_Append(out, idx) < 0) {
                Py_XDECREF(idx); return false;
            }
            Py_DECREF(idx);
        }
    }
    for (Py_ssize_t i = cp; i < j; ++i) {
        if (c->ends[i] > point) {
            PyObject *idx = PyLong_FromSsize_t(i);
            if (idx == nullptr || PyList_Append(out, idx) < 0) {
                Py_XDECREF(idx); return false;
            }
            Py_DECREF(idx);
        }
    }
    return true;
}

PyObject *cintia_find(PyObject *, PyObject *args) {
    PyObject *capsule;
    long long point;
    if (!PyArg_ParseTuple(args, "OL", &capsule, &point)) return nullptr;
    Cintia *c = get_cintia(capsule);
    if (c == nullptr) return nullptr;
    PyObject *out = PyList_New(0);
    if (out == nullptr) return nullptr;
    Py_ssize_t j = upper_bound(c->starts, c->n, point);
    if (!visit_stab(c, point, j, out)) { Py_DECREF(out); return nullptr; }
    return out;
}

PyObject *cintia_overlaps(PyObject *, PyObject *args) {
    PyObject *capsule;
    long long qlo, qhi;
    if (!PyArg_ParseTuple(args, "OLL", &capsule, &qlo, &qhi)) return nullptr;
    Cintia *c = get_cintia(capsule);
    if (c == nullptr) return nullptr;
    PyObject *out = PyList_New(0);
    if (out == nullptr) return nullptr;
    Py_ssize_t j = lower_bound(c->starts, c->n, qhi);
    if (j > 0) {
        Py_ssize_t jlo = upper_bound(c->starts, c->n, qlo);
        if (!visit_stab(c, qlo, jlo, out)) { Py_DECREF(out); return nullptr; }
        for (Py_ssize_t i = jlo; i < j; ++i) {
            PyObject *idx = PyLong_FromSsize_t(i);
            if (idx == nullptr || PyList_Append(out, idx) < 0) {
                Py_XDECREF(idx); Py_DECREF(out); return nullptr;
            }
            Py_DECREF(idx);
        }
    }
    return out;
}

PyMethodDef methods[] = {
    {"linear_union", linear_union, METH_VARARGS,
     "union of two sorted unique sequences"},
    {"linear_intersection", linear_intersection, METH_VARARGS,
     "intersection of two sorted unique sequences"},
    {"linear_subtract", linear_subtract, METH_VARARGS,
     "difference of two sorted unique sequences"},
    {"binary_search", binary_search, METH_VARARGS,
     "Java-convention binary search"},
    {"linear_merge_n", linear_merge_n, METH_VARARGS,
     "k-way union of sorted unique sequences"},
    {"cintia_build", cintia_build, METH_VARARGS,
     "build checkpoint lists for the interval index"},
    {"cintia_find", cintia_find, METH_VARARGS,
     "stabbing query: indices of intervals containing a point"},
    {"cintia_overlaps", cintia_overlaps, METH_VARARGS,
     "overlap query: indices of intervals intersecting [lo, hi)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_accord_native",
    "native sorted-array kernels", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

extern "C" PyMODINIT_FUNC PyInit__accord_native(void) {
    return PyModule_Create(&moduledef);
}
