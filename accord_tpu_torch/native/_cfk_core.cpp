/* Native CommandsForKey core loops — PAPER.md's north-star kernel #1.
 *
 * Reference: accord/local/CommandsForKey.java:652-1000 (incremental update
 * with missing[] maintenance), :738-860 (the additions path installing an
 * entry's own divergence), :614-650 (mapReduceActive — the deps scan).
 *
 * The packed parallel arrays (_ids/_status/_eat/_missing/_wdeps) stay plain
 * Python lists owned by accord_tpu_torch/local/cfk.CommandsForKey — the shared
 * authoritative representation both tiers (and the device encoder) read —
 * and this module owns the three hot LOOPS over them, each one C pass where
 * the Python tier pays an interpreted iteration per entry:
 *
 *   add_missing_everywhere — the per-insert walk recording a new id's
 *       divergence in every bounded entry's missing[]
 *   remove_missing         — the per-commit elision walk over missing[]
 *   apply_deps             — the additions insert + own-missing[] install
 *       (replacing the per-call set()/sorted() allocations)
 *   map_reduce_active      — the deps scan with transitive elision
 *
 * and the device encoder's walk over the same arrays (ops/encode.py's
 * BatchEncoder): encode_window reads a flush window's timestamp universe
 * from the CFKs' lists, sorts and ranks it, and writes the int32 entry
 * columns and the batch's ranks, one C pass where the Python tier builds
 * a set, a sorted list, a rank dict and a tuple per entry.
 *
 * BIT-IDENTITY CONTRACT (same precedent as _wire_codec.cpp): every function
 * must leave the arrays in exactly the state the Python tier would — the
 * differential suite (tests/test_cfk_native.py) cross-checks randomized op
 * sequences tier-against-tier, and ops/deps_kernel's batched device path is
 * pinned bit-identical to whichever tier is live.
 *
 * Ordering rides each Timestamp's precomputed `_cmp` packed key (an int —
 * CPython long compares are C-level), never the Python-defined __lt__;
 * kind/domain tests decode `flags` exactly like timestamp.py's lookup
 * tables, with the witness matrix passed IN from the single source of truth
 * (timestamp._WITNESS_BITS), never duplicated here.
 *
 * Built on first use by accord_tpu_torch/native/__init__.get_cfk(); any build or
 * load failure (or ACCORD_NATIVE=0 / ACCORD_NO_NATIVE=1) degrades to the
 * behaviourally identical Python tier.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

PyObject *s_cmp = nullptr;    /* interned "_cmp" */
PyObject *s_flags = nullptr;  /* interned "flags" */
PyObject *s_ids = nullptr;    /* interned "_ids" */
PyObject *s_status = nullptr; /* interned "_status" */
PyObject *s_eat = nullptr;    /* interned "_eat" */

/* InternalStatus bands (accord_tpu_torch.local.cfk.InternalStatus) */
constexpr long ST_TRANSITIVELY_KNOWN = 0;
constexpr long ST_ACCEPTED = 3;   /* has_info low bound */
constexpr long ST_COMMITTED = 4;
constexpr long ST_APPLIED = 6;    /* has_info / is_committed high bound */
constexpr long ST_INVALID = 7;

inline bool has_info(long s) { return s >= ST_ACCEPTED && s <= ST_APPLIED; }
inline bool is_committed(long s) { return s >= ST_COMMITTED && s <= ST_APPLIED; }
inline bool is_decided(long s) { return s >= ST_COMMITTED; }

/* flags bit layout (timestamp.py): domain = bit 0, kind = bits 1..3 */
inline long kind_of(long flags) { return (flags >> 1) & 0x7; }
inline bool is_key_domain(long flags) { return (flags & 1) == 0; }
inline bool kind_is_write(long flags) {
    long k = kind_of(flags);
    return k == 2 || k == 5;  /* WRITE, EXCLUSIVE_SYNC_POINT */
}

/* new ref to o._cmp (the packed total-order int), or null on error */
inline PyObject *get_cmp(PyObject *o) { return PyObject_GetAttr(o, s_cmp); }

inline long get_flags(PyObject *o, bool *err) {
    PyObject *f = PyObject_GetAttr(o, s_flags);
    if (f == nullptr) { *err = true; return 0; }
    long v = PyLong_AsLong(f);
    Py_DECREF(f);
    if (v == -1 && PyErr_Occurred()) { *err = true; return 0; }
    return v;
}

/* a <op> b via rich comparison of the (long) cmp keys; -1 on error */
inline int cmp_bool(PyObject *a_cmp, PyObject *b_cmp, int op) {
    return PyObject_RichCompareBool(a_cmp, b_cmp, op);
}

/* entry j's deps-known-before bound: eat[j] while committed with a
 * recorded executeAt, its own id otherwise (InternalStatus.depsKnownBefore) */
inline PyObject *bound_of(PyObject *ids, PyObject *eat, Py_ssize_t j, long s) {
    PyObject *e = PyList_GET_ITEM(eat, j);
    if (is_committed(s) && e != Py_None) return e;
    return PyList_GET_ITEM(ids, j);
}

/* eat[i] if set else ids[i] (CommandsForKey._eat_of) */
inline PyObject *eat_of(PyObject *ids, PyObject *eat, Py_ssize_t i) {
    PyObject *e = PyList_GET_ITEM(eat, i);
    return e != Py_None ? e : PyList_GET_ITEM(ids, i);
}

inline long status_at(PyObject *status, Py_ssize_t j, bool *err) {
    long v = PyLong_AsLong(PyList_GET_ITEM(status, j));
    if (v == -1 && PyErr_Occurred()) { *err = true; }
    return v;
}

/* bisect_left over a list/tuple of timestamps by cmp key.
 * target_cmp is the probe's _cmp int. -1 on error. */
Py_ssize_t bisect_left_cmp(PyObject *seq, bool is_list, PyObject *target_cmp,
                           Py_ssize_t hi_in = -1) {
    Py_ssize_t lo = 0;
    Py_ssize_t hi = hi_in >= 0 ? hi_in
        : (is_list ? PyList_GET_SIZE(seq) : PyTuple_GET_SIZE(seq));
    while (lo < hi) {
        Py_ssize_t mid = (lo + hi) / 2;
        PyObject *item = is_list ? PyList_GET_ITEM(seq, mid)
                                 : PyTuple_GET_ITEM(seq, mid);
        PyObject *c = get_cmp(item);
        if (c == nullptr) return -1;
        int lt = cmp_bool(c, target_cmp, Py_LT);
        Py_DECREF(c);
        if (lt < 0) return -1;
        if (lt) lo = mid + 1; else hi = mid;
    }
    return lo;
}

/* does sorted tuple m contain an element with cmp == target_cmp?
 * out_idx receives the insertion point. -1 err / 0 no / 1 yes. */
int tuple_find_cmp(PyObject *m, PyObject *target_cmp, Py_ssize_t *out_idx) {
    Py_ssize_t k = bisect_left_cmp(m, false, target_cmp);
    if (k < 0) return -1;
    *out_idx = k;
    if (k >= PyTuple_GET_SIZE(m)) return 0;
    PyObject *c = get_cmp(PyTuple_GET_ITEM(m, k));
    if (c == nullptr) return -1;
    int eq = cmp_bool(c, target_cmp, Py_EQ);
    Py_DECREF(c);
    return eq;
}

/* tuple copy of m with `item` spliced in at k */
PyObject *tuple_insert(PyObject *m, Py_ssize_t k, PyObject *item) {
    Py_ssize_t n = PyTuple_GET_SIZE(m);
    PyObject *out = PyTuple_New(n + 1);
    if (out == nullptr) return nullptr;
    for (Py_ssize_t i = 0; i < k; ++i) {
        PyObject *v = PyTuple_GET_ITEM(m, i);
        Py_INCREF(v);
        PyTuple_SET_ITEM(out, i, v);
    }
    Py_INCREF(item);
    PyTuple_SET_ITEM(out, k, item);
    for (Py_ssize_t i = k; i < n; ++i) {
        PyObject *v = PyTuple_GET_ITEM(m, i);
        Py_INCREF(v);
        PyTuple_SET_ITEM(out, i + 1, v);
    }
    return out;
}

/* tuple copy of m without index k */
PyObject *tuple_remove(PyObject *m, Py_ssize_t k) {
    Py_ssize_t n = PyTuple_GET_SIZE(m);
    PyObject *out = PyTuple_New(n - 1);
    if (out == nullptr) return nullptr;
    for (Py_ssize_t i = 0; i < k; ++i) {
        PyObject *v = PyTuple_GET_ITEM(m, i);
        Py_INCREF(v);
        PyTuple_SET_ITEM(out, i, v);
    }
    for (Py_ssize_t i = k + 1; i < n; ++i) {
        PyObject *v = PyTuple_GET_ITEM(m, i);
        Py_INCREF(v);
        PyTuple_SET_ITEM(out, i - 1, v);
    }
    return out;
}

/* witness-bit table handed in from timestamp._WITNESS_BITS (8 ints) */
bool load_witness_bits(PyObject *wb_obj, long wb[8]) {
    if (!PyTuple_Check(wb_obj) || PyTuple_GET_SIZE(wb_obj) != 8) {
        PyErr_SetString(PyExc_TypeError, "witness_bits must be an 8-tuple");
        return false;
    }
    for (int i = 0; i < 8; ++i) {
        wb[i] = PyLong_AsLong(PyTuple_GET_ITEM(wb_obj, i));
        if (wb[i] == -1 && PyErr_Occurred()) return false;
    }
    return true;
}

/* ---- add_missing_everywhere: record a newly-witnessed undecided id in
 * every bounded has_info entry's missing[] (insertInfoAndOneMissing,
 * CommandsForKey.java:897-960).  Shared by the exported entry point and
 * apply_deps' additions path. */
int add_missing_impl(PyObject *ids, PyObject *status, PyObject *eat,
                     PyObject *missing, PyObject *new_id, const long wb[8]) {
    PyObject *new_cmp = get_cmp(new_id);
    if (new_cmp == nullptr) return -1;
    bool err = false;
    long new_flags = get_flags(new_id, &err);
    if (err) { Py_DECREF(new_cmp); return -1; }
    long new_kind = kind_of(new_flags);
    Py_ssize_t n = PyList_GET_SIZE(ids);
    for (Py_ssize_t j = 0; j < n; ++j) {
        long s = status_at(status, j, &err);
        if (err) { Py_DECREF(new_cmp); return -1; }
        if (!has_info(s)) continue;
        PyObject *entry = PyList_GET_ITEM(ids, j);
        PyObject *entry_cmp = get_cmp(entry);
        if (entry_cmp == nullptr) { Py_DECREF(new_cmp); return -1; }
        int eq = cmp_bool(entry_cmp, new_cmp, Py_EQ);
        Py_DECREF(entry_cmp);
        if (eq < 0) { Py_DECREF(new_cmp); return -1; }
        if (eq) continue;
        long entry_flags = get_flags(entry, &err);
        if (err) { Py_DECREF(new_cmp); return -1; }
        if (!((wb[kind_of(entry_flags)] >> new_kind) & 1)) continue;
        PyObject *bound = bound_of(ids, eat, j, s);
        PyObject *bound_cmp = get_cmp(bound);
        if (bound_cmp == nullptr) { Py_DECREF(new_cmp); return -1; }
        int gt = cmp_bool(bound_cmp, new_cmp, Py_GT);
        Py_DECREF(bound_cmp);
        if (gt < 0) { Py_DECREF(new_cmp); return -1; }
        if (!gt) continue;
        PyObject *m = PyList_GET_ITEM(missing, j);
        Py_ssize_t k;
        int found = tuple_find_cmp(m, new_cmp, &k);
        if (found < 0) { Py_DECREF(new_cmp); return -1; }
        if (found) continue;
        PyObject *grown = tuple_insert(m, k, new_id);
        if (grown == nullptr) { Py_DECREF(new_cmp); return -1; }
        PyList_SetItem(missing, j, grown);  /* steals grown, drops old m */
    }
    Py_DECREF(new_cmp);
    return 0;
}

PyObject *add_missing_everywhere(PyObject *, PyObject *args) {
    PyObject *ids, *status, *eat, *missing, *new_id, *wb_obj;
    if (!PyArg_ParseTuple(args, "O!O!O!O!OO", &PyList_Type, &ids,
                          &PyList_Type, &status, &PyList_Type, &eat,
                          &PyList_Type, &missing, &new_id, &wb_obj))
        return nullptr;
    long wb[8];
    if (!load_witness_bits(wb_obj, wb)) return nullptr;
    if (add_missing_impl(ids, status, eat, missing, new_id, wb) < 0)
        return nullptr;
    Py_RETURN_NONE;
}

/* ---- remove_missing: elide a newly-committed id from every missing
 * collection (removeMissing, CommandsForKey.java:962-987) */
PyObject *remove_missing(PyObject *, PyObject *args) {
    PyObject *missing, *txn_id;
    if (!PyArg_ParseTuple(args, "O!O", &PyList_Type, &missing, &txn_id))
        return nullptr;
    PyObject *cmp = get_cmp(txn_id);
    if (cmp == nullptr) return nullptr;
    Py_ssize_t n = PyList_GET_SIZE(missing);
    for (Py_ssize_t j = 0; j < n; ++j) {
        PyObject *m = PyList_GET_ITEM(missing, j);
        if (PyTuple_GET_SIZE(m) == 0) continue;
        Py_ssize_t k;
        int found = tuple_find_cmp(m, cmp, &k);
        if (found < 0) { Py_DECREF(cmp); return nullptr; }
        if (!found) continue;
        PyObject *shrunk = tuple_remove(m, k);
        if (shrunk == nullptr) { Py_DECREF(cmp); return nullptr; }
        PyList_SetItem(missing, j, shrunk);
    }
    Py_DECREF(cmp);
    Py_RETURN_NONE;
}

/* one parsed dep: borrowed object + owned cmp + flags */
struct Dep {
    PyObject *obj;
    PyObject *cmp;
    long flags;
};

void free_deps(Dep *d, Py_ssize_t n) {
    for (Py_ssize_t i = 0; i < n; ++i) Py_XDECREF(d[i].cmp);
    PyMem_Free(d);
}

/* binary search the sorted unique dep array for target_cmp */
int deps_contains(const Dep *deps, Py_ssize_t n, PyObject *target_cmp) {
    Py_ssize_t lo = 0, hi = n;
    while (lo < hi) {
        Py_ssize_t mid = (lo + hi) / 2;
        int lt = cmp_bool(deps[mid].cmp, target_cmp, Py_LT);
        if (lt < 0) return -1;
        if (lt) { lo = mid + 1; continue; }
        int eq = cmp_bool(deps[mid].cmp, target_cmp, Py_EQ);
        if (eq < 0) return -1;
        if (eq) return 1;
        hi = mid;
    }
    return 0;
}

/* ---- apply_deps: install an entry's own missing[] divergence + wdeps and
 * insert any dep ids never witnessed here as TRANSITIVELY_KNOWN (the
 * additions path, CommandsForKey.java:738-860).
 *
 * apply_deps(ids, status, eat, missing, wdeps, txn_id, status_int,
 *            dep_ids, tk_status, witness_bits)
 *   tk_status: the InternalStatus.TRANSITIVELY_KNOWN enum member, inserted
 *   verbatim so the status list stays homogeneous with the Python tier. */
PyObject *apply_deps(PyObject *, PyObject *args) {
    PyObject *ids, *status, *eat, *missing, *wdeps, *txn_id, *dep_obj,
        *tk_status, *wb_obj;
    long status_int;
    if (!PyArg_ParseTuple(args, "O!O!O!O!O!OlOOO", &PyList_Type, &ids,
                          &PyList_Type, &status, &PyList_Type, &eat,
                          &PyList_Type, &missing, &PyList_Type, &wdeps,
                          &txn_id, &status_int, &dep_obj, &tk_status,
                          &wb_obj))
        return nullptr;
    long wb[8];
    if (!load_witness_bits(wb_obj, wb)) return nullptr;

    PyObject *dep_seq = PySequence_Fast(dep_obj, "dep_ids must be a sequence");
    if (dep_seq == nullptr) return nullptr;
    Py_ssize_t raw_n = PySequence_Fast_GET_SIZE(dep_seq);
    Dep *deps = (Dep *)PyMem_Malloc(sizeof(Dep) * (raw_n ? raw_n : 1));
    if (deps == nullptr) { Py_DECREF(dep_seq); PyErr_NoMemory(); return nullptr; }
    Py_ssize_t dn = 0;
    bool err = false;
    for (Py_ssize_t i = 0; i < raw_n && !err; ++i) {
        PyObject *o = PySequence_Fast_GET_ITEM(dep_seq, i);
        PyObject *c = get_cmp(o);
        if (c == nullptr) { err = true; break; }
        long f = get_flags(o, &err);
        if (err) { Py_DECREF(c); break; }
        deps[dn].obj = o; deps[dn].cmp = c; deps[dn].flags = f;
        ++dn;
    }
    if (err) { free_deps(deps, dn); Py_DECREF(dep_seq); return nullptr; }
    /* sort ascending by cmp (dep lists arrive near-sorted from the CSR, so
     * insertion sort is ~linear), then dedup equal keys — the Python
     * tier's set() + sorted() */
    for (Py_ssize_t i = 1; i < dn && !err; ++i) {
        Dep cur = deps[i];
        Py_ssize_t j = i;
        while (j > 0) {
            int lt = cmp_bool(cur.cmp, deps[j - 1].cmp, Py_LT);
            if (lt < 0) { err = true; break; }
            if (!lt) break;
            deps[j] = deps[j - 1];
            --j;
        }
        deps[j] = cur;
    }
    if (!err && dn > 1) {
        Py_ssize_t w = 1;
        for (Py_ssize_t i = 1; i < dn; ++i) {
            int eq = cmp_bool(deps[i].cmp, deps[w - 1].cmp, Py_EQ);
            if (eq < 0) { err = true; break; }
            if (eq) { Py_DECREF(deps[i].cmp); continue; }
            deps[w++] = deps[i];
        }
        if (!err) dn = w;
    }
    if (err) { free_deps(deps, dn); Py_DECREF(dep_seq); return nullptr; }

    PyObject *empty = PyTuple_New(0);
    if (empty == nullptr) { free_deps(deps, dn); Py_DECREF(dep_seq); return nullptr; }

    /* additions: key-domain deps this key never witnessed enter all five
     * arrays as TRANSITIVELY_KNOWN, each followed by its own missing[]
     * walk — exactly the Python tier's per-addition _insert order */
    for (Py_ssize_t i = 0; i < dn && !err; ++i) {
        if (!is_key_domain(deps[i].flags)) continue;
        Py_ssize_t p = bisect_left_cmp(ids, true, deps[i].cmp);
        if (p < 0) { err = true; break; }
        if (p < PyList_GET_SIZE(ids)) {
            PyObject *c = get_cmp(PyList_GET_ITEM(ids, p));
            if (c == nullptr) { err = true; break; }
            int eq = cmp_bool(c, deps[i].cmp, Py_EQ);
            Py_DECREF(c);
            if (eq < 0) { err = true; break; }
            if (eq) continue;  /* already witnessed */
        }
        if (PyList_Insert(ids, p, deps[i].obj) < 0
            || PyList_Insert(status, p, tk_status) < 0
            || PyList_Insert(eat, p, Py_None) < 0
            || PyList_Insert(missing, p, empty) < 0
            || PyList_Insert(wdeps, p, empty) < 0) { err = true; break; }
        if (add_missing_impl(ids, status, eat, missing, deps[i].obj, wb) < 0) {
            err = true; break;
        }
    }
    if (err) {
        Py_DECREF(empty); free_deps(deps, dn); Py_DECREF(dep_seq);
        return nullptr;
    }

    /* own missing[]: every undecided witnessed id below the deps-known
     * bound that our kind witnesses but the dep set omits */
    PyObject *txn_cmp = get_cmp(txn_id);
    long txn_flags = txn_cmp != nullptr ? get_flags(txn_id, &err) : 0;
    if (txn_cmp == nullptr || err) {
        Py_XDECREF(txn_cmp); Py_DECREF(empty);
        free_deps(deps, dn); Py_DECREF(dep_seq);
        return nullptr;
    }
    long txn_wbits = wb[kind_of(txn_flags)];
    PyObject *out = nullptr, *result = nullptr;
    Py_ssize_t pos = bisect_left_cmp(ids, true, txn_cmp);
    if (pos < 0) goto fail;
    {
        /* pos references txn_id itself (update inserted it before this
         * call); bound = deps-known-before under the NEW status: the
         * recorded eat while committed, the id otherwise */
        PyObject *e = PyList_GET_ITEM(eat, pos);
        PyObject *bound = (is_committed(status_int) && e != Py_None)
            ? e : txn_id;
        PyObject *bound_cmp = get_cmp(bound);
        if (bound_cmp == nullptr) goto fail;
        Py_ssize_t hi = bisect_left_cmp(ids, true, bound_cmp);
        Py_DECREF(bound_cmp);
        if (hi < 0) goto fail;
        out = PyList_New(0);
        if (out == nullptr) goto fail;
        for (Py_ssize_t j = 0; j < hi; ++j) {
            if (j == pos) continue;
            long s = status_at(status, j, &err);
            if (err) goto fail;
            if (is_decided(s)) continue;  /* elided: committed visible */
            PyObject *t = PyList_GET_ITEM(ids, j);
            long tf = get_flags(t, &err);
            if (err) goto fail;
            if (!((txn_wbits >> kind_of(tf)) & 1)) continue;
            PyObject *tc = get_cmp(t);
            if (tc == nullptr) goto fail;
            int in_deps = deps_contains(deps, dn, tc);
            Py_DECREF(tc);
            if (in_deps < 0) goto fail;
            if (in_deps) continue;
            if (PyList_Append(out, t) < 0) goto fail;
        }
        PyObject *mt = PyList_AsTuple(out);
        if (mt == nullptr) goto fail;
        PyList_SetItem(missing, pos, mt);
        Py_CLEAR(out);
        /* wdeps: the registered key-domain WRITE deps, sorted unique */
        Py_ssize_t wn = 0;
        for (Py_ssize_t i = 0; i < dn; ++i)
            if (is_key_domain(deps[i].flags) && kind_is_write(deps[i].flags))
                ++wn;
        PyObject *wt = PyTuple_New(wn);
        if (wt == nullptr) goto fail;
        Py_ssize_t w = 0;
        for (Py_ssize_t i = 0; i < dn; ++i) {
            if (!(is_key_domain(deps[i].flags) && kind_is_write(deps[i].flags)))
                continue;
            Py_INCREF(deps[i].obj);
            PyTuple_SET_ITEM(wt, w++, deps[i].obj);
        }
        PyList_SetItem(wdeps, pos, wt);
    }
    result = Py_None;
    Py_INCREF(result);
fail:
    Py_XDECREF(out);
    Py_DECREF(txn_cmp);
    Py_DECREF(empty);
    free_deps(deps, dn);
    Py_DECREF(dep_seq);
    return result;
}

/* ---- map_reduce_active: the deps scan (mapReduceActive,
 * CommandsForKey.java:614-650).  Returns the visited ids as a list; the
 * caller computes the transitive-elision bound (a cheap bisect over the
 * committed view) and invokes its fn per element.
 *
 * map_reduce_active(ids, status, eat, before, kinds_mask, bound_or_None) */
PyObject *map_reduce_active(PyObject *, PyObject *args) {
    PyObject *ids, *status, *eat, *before, *bound;
    long kmask;
    if (!PyArg_ParseTuple(args, "O!O!O!OlO", &PyList_Type, &ids,
                          &PyList_Type, &status, &PyList_Type, &eat,
                          &before, &kmask, &bound))
        return nullptr;
    PyObject *before_cmp = get_cmp(before);
    if (before_cmp == nullptr) return nullptr;
    Py_ssize_t hi = bisect_left_cmp(ids, true, before_cmp);
    Py_DECREF(before_cmp);
    if (hi < 0) return nullptr;
    PyObject *bound_cmp = nullptr;
    if (bound != Py_None) {
        bound_cmp = get_cmp(bound);
        if (bound_cmp == nullptr) return nullptr;
    }
    PyObject *out = PyList_New(0);
    if (out == nullptr) { Py_XDECREF(bound_cmp); return nullptr; }
    bool err = false;
    for (Py_ssize_t i = 0; i < hi; ++i) {
        PyObject *t = PyList_GET_ITEM(ids, i);
        long tf = get_flags(t, &err);
        if (err) goto fail;
        if (!((kmask >> kind_of(tf)) & 1)) continue;
        long s = status_at(status, i, &err);
        if (err) goto fail;
        if (s == ST_TRANSITIVELY_KNOWN || s == ST_INVALID) continue;
        if (is_committed(s) && bound_cmp != nullptr) {
            PyObject *ec = get_cmp(eat_of(ids, eat, i));
            if (ec == nullptr) goto fail;
            int lt = cmp_bool(ec, bound_cmp, Py_LT);
            Py_DECREF(ec);
            if (lt < 0) goto fail;
            if (lt) continue;  /* transitively covered by the bound write */
        }
        if (PyList_Append(out, t) < 0) goto fail;
    }
    Py_XDECREF(bound_cmp);
    return out;
fail:
    Py_XDECREF(bound_cmp);
    Py_DECREF(out);
    return nullptr;
}

/* ---- pos: Java-convention bisect over the ids list by packed cmp key
 * (match index, or -(insertion)-1) — CommandsForKey._pos without the
 * Python-level __lt__ dispatch per probe */
PyObject *pos(PyObject *, PyObject *args) {
    PyObject *ids, *target;
    if (!PyArg_ParseTuple(args, "O!O", &PyList_Type, &ids, &target))
        return nullptr;
    PyObject *tc = get_cmp(target);
    if (tc == nullptr) return nullptr;
    Py_ssize_t i = bisect_left_cmp(ids, true, tc);
    if (i < 0) { Py_DECREF(tc); return nullptr; }
    if (i < PyList_GET_SIZE(ids)) {
        PyObject *c = get_cmp(PyList_GET_ITEM(ids, i));
        if (c == nullptr) { Py_DECREF(tc); return nullptr; }
        int eq = cmp_bool(c, tc, Py_EQ);
        Py_DECREF(c);
        Py_DECREF(tc);
        if (eq < 0) return nullptr;
        return PyLong_FromSsize_t(eq ? i : -i - 1);
    }
    Py_DECREF(tc);
    return PyLong_FromSsize_t(-i - 1);
}

/* ---- encode_window: the device encoder's walk (ops/encode.py,
 * BatchEncoder).  A timestamp's _cmp (epoch 48b | hlc 64b | flags 16b |
 * node 32b) is read as three 64-bit words, most significant first, so
 * word order and equality are _cmp's, which Timestamp's __lt__, __eq__ and
 * __hash__ read. */
struct Key3 {
    uint64_t w[3];
};

inline bool key_eq(const Key3 &a, const Key3 &b) {
    return a.w[0] == b.w[0] && a.w[1] == b.w[1] && a.w[2] == b.w[2];
}

/* an int _cmp -> its three words; -1 on error (negative or too wide) */
int cmp_to_key(PyObject *c, Key3 *out) {
    if (!PyLong_Check(c)) {
        PyErr_SetString(PyExc_TypeError, "_cmp must be an int");
        return -1;
    }
    unsigned char b[24];
#if PY_VERSION_HEX >= 0x030D0000
    Py_ssize_t need = PyLong_AsNativeBytes(
        c, b, 24, Py_ASNATIVEBYTES_LITTLE_ENDIAN
                      | Py_ASNATIVEBYTES_UNSIGNED_BUFFER
                      | Py_ASNATIVEBYTES_REJECT_NEGATIVE);
    if (need < 0) return -1;
    if (need > 24) {
        PyErr_SetString(PyExc_OverflowError, "_cmp wider than 192 bits");
        return -1;
    }
#else
    if (_PyLong_AsByteArray((PyLongObject *)c, b, 24, 1, 0) < 0) return -1;
#endif
    for (int k = 0; k < 3; ++k) {
        uint64_t v = 0;
        for (int j = 7; j >= 0; --j) v = (v << 8) | b[8 * k + j];
        out->w[2 - k] = v;
    }
    return 0;
}

/* Where a type keeps _cmp: the byte offset of its __slots__ member when
 * attribute lookup on it is the generic one (so reading the slot is what
 * getattr does), else -1 and the caller asks getattr.  The window's
 * objects are a few types, so the last one is cached. */
struct SlotCache {
    PyTypeObject *type = nullptr;
    Py_ssize_t offset = -1;

    Py_ssize_t offset_of(PyTypeObject *tp) {
        if (tp == type) return offset;
        type = tp;
        offset = -1;
        if (tp->tp_getattro != PyObject_GenericGetAttr) return offset;
        PyObject *d = _PyType_Lookup(tp, s_cmp);  /* borrowed */
        if (d != nullptr && Py_IS_TYPE(d, &PyMemberDescr_Type)) {
            PyMemberDef *m = ((PyMemberDescrObject *)d)->d_member;
            if (m->type == Py_T_OBJECT_EX) offset = m->offset;
        }
        return offset;
    }
};

/* one timestamp of the window: where its rank goes (an entry's id or
 * executeAt, or a batch row), and the object, borrowed from a list the
 * call holds.  Items are numbered in the Python tier's set insertion
 * order, which picks the object the universe keeps. */
enum Dest : uint8_t { DEST_ID, DEST_EAT, DEST_BATCH };

struct Item {
    PyObject *obj;
    uint32_t idx;
    Dest dest;
};

/* what is sorted: the key and the item's number, 32 bytes */
struct SortKey {
    Key3 key;
    uint32_t seq;
};

inline bool sort_lt(const SortKey &a, const SortKey &b) {
    if (a.key.w[0] != b.key.w[0]) return a.key.w[0] < b.key.w[0];
    unsigned __int128 x = ((unsigned __int128)a.key.w[1] << 64) | a.key.w[2];
    unsigned __int128 y = ((unsigned __int128)b.key.w[1] << 64) | b.key.w[2];
    if (x != y) return x < y;
    return a.seq < b.seq;
}

/* every item's key, into keys[i].  The objects lie scattered over the
 * heap, so the walk is a software pipeline: the object PREFETCH items
 * ahead is fetched, and the _cmp int of the one half as far ahead, whose
 * object has arrived. */
int read_keys(const std::vector<Item> &items, std::vector<SortKey> &keys) {
    constexpr size_t PREFETCH = 16;
    SlotCache cache;
    size_t n = items.size();
    keys.resize(n);
    auto cmp_of = [&cache](PyObject *o) -> PyObject * {
        Py_ssize_t off = cache.offset_of(Py_TYPE(o));
        return off >= 0 ? *(PyObject **)((char *)o + off) : nullptr;
    };
    for (size_t i = 0; i < n; ++i) {
        if (i + PREFETCH < n) __builtin_prefetch(items[i + PREFETCH].obj);
        if (i + PREFETCH / 2 < n) {
            PyObject *ahead = cmp_of(items[i + PREFETCH / 2].obj);
            if (ahead != nullptr) __builtin_prefetch(ahead);
        }
        keys[i].seq = (uint32_t)i;
        PyObject *c = cmp_of(items[i].obj);
        int rc;
        if (c != nullptr) {
            rc = cmp_to_key(c, &keys[i].key);
        } else {
            c = get_cmp(items[i].obj);  /* any other type, or unset slot */
            if (c == nullptr) return -1;
            rc = cmp_to_key(c, &keys[i].key);
            Py_DECREF(c);
        }
        if (rc < 0) return -1;
    }
    return 0;
}

/* encode_window(cfks, key_index, batch_ts, kind_bits, entry_rank,
 *               entry_eat_rank, entry_key, entry_status, entry_kind,
 *               txn_rank) -> universe
 *
 * cfks: the window's CommandsForKey in entry order; key_index[c] the key
 * column of cfks[c]; batch_ts the batch's timestamps; kind_bits bit k set
 * for each valid TxnKind k.  The six int32 buffers, already padded, take
 * the first E (or B) values.  The universe is the sorted distinct
 * timestamps, each the object the Python tier's set keeps: the first
 * inserted of batch_ts, then each CFK's ids and its executeAts. */
PyObject *encode_window(PyObject *, PyObject *args) {
    PyObject *cfks, *key_index, *batch_obj;
    long kind_bits;
    Py_buffer bufs[6];
    if (!PyArg_ParseTuple(args, "OO!Olw*w*w*w*w*w*", &cfks, &PyList_Type,
                          &key_index, &batch_obj, &kind_bits, &bufs[0],
                          &bufs[1], &bufs[2], &bufs[3], &bufs[4], &bufs[5]))
        return nullptr;
    int32_t *entry_rank = (int32_t *)bufs[0].buf;
    int32_t *entry_eat_rank = (int32_t *)bufs[1].buf;
    int32_t *entry_key = (int32_t *)bufs[2].buf;
    int32_t *entry_status = (int32_t *)bufs[3].buf;
    int32_t *entry_kind = (int32_t *)bufs[4].buf;
    int32_t *txn_rank = (int32_t *)bufs[5].buf;

    PyObject *result = nullptr, *universe = nullptr;
    PyObject *cfk_seq = nullptr, *batch = nullptr;
    std::vector<PyObject *> lists;  /* owned: each CFK's _ids, _status, _eat */
    std::vector<Item> items;
    std::vector<SortKey> keys;
    std::vector<uint32_t> eat_is_id;  /* entries whose executeAt is their id */
    std::vector<PyObject *> reps;     /* the universe, borrowed */
    Py_ssize_t n_cfks, n_batch, n = 0, e = 0;
    bool err = false;

    cfk_seq = PySequence_Fast(cfks, "cfks must be a sequence");
    if (cfk_seq == nullptr) goto done;
    batch = PySequence_Fast(batch_obj, "batch_ts must be a sequence");
    if (batch == nullptr) goto done;
    n_cfks = PySequence_Fast_GET_SIZE(cfk_seq);
    n_batch = PySequence_Fast_GET_SIZE(batch);
    if (PyList_GET_SIZE(key_index) != n_cfks) {
        PyErr_SetString(PyExc_ValueError, "one key index a CFK");
        goto done;
    }
    lists.reserve(3 * n_cfks);
    for (Py_ssize_t c = 0; c < n_cfks; ++c) {
        PyObject *cfk = PySequence_Fast_GET_ITEM(cfk_seq, c);
        PyObject *names[3] = {s_ids, s_status, s_eat};
        for (PyObject *name : names) {
            PyObject *l = PyObject_GetAttr(cfk, name);
            if (l == nullptr) goto done;
            lists.push_back(l);
            if (!PyList_Check(l)) {
                PyErr_SetString(PyExc_TypeError, "a CFK's arrays are lists");
                goto done;
            }
        }
        Py_ssize_t m = PyList_GET_SIZE(lists[3 * c]);
        if (PyList_GET_SIZE(lists[3 * c + 1]) != m
            || PyList_GET_SIZE(lists[3 * c + 2]) != m) {
            PyErr_SetString(PyExc_ValueError, "a CFK's arrays differ in length");
            goto done;
        }
        n += m;
    }
    for (int i = 0; i < 5; ++i) {
        if (bufs[i].len < n * (Py_ssize_t)sizeof(int32_t)) {
            PyErr_SetString(PyExc_ValueError, "an entry buffer is too short");
            goto done;
        }
    }
    if (bufs[5].len < n_batch * (Py_ssize_t)sizeof(int32_t)) {
        PyErr_SetString(PyExc_ValueError, "the batch buffer is too short");
        goto done;
    }
    if (2 * n + n_batch > (Py_ssize_t)INT32_MAX) {
        PyErr_SetString(PyExc_OverflowError, "window too large for int32");
        goto done;
    }

    /* the items in the Python tier's insertion order: the batch, then each
     * CFK's ids and its set executeAts; the key, status and kind columns */
    items.reserve(2 * n + n_batch);
    for (Py_ssize_t i = 0; i < n_batch; ++i) {
        items.push_back({PySequence_Fast_GET_ITEM(batch, i), (uint32_t)i,
                         DEST_BATCH});
    }
    for (Py_ssize_t c = 0; c < n_cfks; ++c) {
        PyObject *ids = lists[3 * c], *status = lists[3 * c + 1],
                 *eat = lists[3 * c + 2];
        long ki = PyLong_AsLong(PyList_GET_ITEM(key_index, c));
        if (ki == -1 && PyErr_Occurred()) goto done;
        Py_ssize_t m = PyList_GET_SIZE(ids);
        for (Py_ssize_t j = 0; j < m; ++j) {
            long st = status_at(status, j, &err);
            if (err) goto done;
            entry_key[e + j] = (int32_t)ki;
            entry_status[e + j] = (int32_t)st;
            items.push_back({PyList_GET_ITEM(ids, j), (uint32_t)(e + j),
                             DEST_ID});
        }
        for (Py_ssize_t j = 0; j < m; ++j) {
            PyObject *x = PyList_GET_ITEM(eat, j);
            if (x == Py_None)
                eat_is_id.push_back((uint32_t)(e + j));
            else
                items.push_back({x, (uint32_t)(e + j), DEST_EAT});
        }
        e += m;
    }
    if (read_keys(items, keys) < 0) goto done;
    for (size_t i = 0; i < items.size(); ++i) {
        if (items[i].dest != DEST_ID) continue;
        long flags = (long)((keys[i].key.w[2] >> 32) & 0xFFFF);
        long kind = kind_of(flags);
        if (!((kind_bits >> kind) & 1)) {
            PyErr_Format(PyExc_ValueError, "no TxnKind in flags 0x%x",
                         (int)flags);
            goto done;
        }
        entry_kind[items[i].idx] = (int32_t)kind;
    }

    /* sort by (key, insertion order): each run of equal keys is one rank,
     * and its first item is the object the Python tier's set kept */
    std::sort(keys.begin(), keys.end(), sort_lt);
    {
        int32_t r = -1;
        for (size_t i = 0; i < keys.size(); ++i) {
            const Item &it = items[keys[i].seq];
            if (i == 0 || !key_eq(keys[i].key, keys[i - 1].key)) {
                ++r;
                reps.push_back(it.obj);
            }
            switch (it.dest) {
            case DEST_ID: entry_rank[it.idx] = r; break;
            case DEST_EAT: entry_eat_rank[it.idx] = r; break;
            case DEST_BATCH: txn_rank[it.idx] = r; break;
            }
        }
    }
    for (uint32_t i : eat_is_id) entry_eat_rank[i] = entry_rank[i];
    universe = PyList_New((Py_ssize_t)reps.size());
    if (universe == nullptr) goto done;
    for (size_t i = 0; i < reps.size(); ++i) {
        Py_INCREF(reps[i]);
        PyList_SET_ITEM(universe, (Py_ssize_t)i, reps[i]);
    }
    result = universe;
    universe = nullptr;
done:
    Py_XDECREF(universe);
    for (PyObject *l : lists) Py_DECREF(l);
    Py_XDECREF(batch);
    Py_XDECREF(cfk_seq);
    for (Py_buffer &b : bufs) PyBuffer_Release(&b);
    return result;
}

PyMethodDef methods[] = {
    {"add_missing_everywhere", add_missing_everywhere, METH_VARARGS,
     "record a newly-witnessed undecided id in every bounded missing[]"},
    {"pos", pos, METH_VARARGS,
     "Java-convention bisect over sorted timestamps by packed cmp key"},
    {"remove_missing", remove_missing, METH_VARARGS,
     "elide a newly-committed id from every missing collection"},
    {"apply_deps", apply_deps, METH_VARARGS,
     "install an entry's missing[] divergence, wdeps and dep additions"},
    {"map_reduce_active", map_reduce_active, METH_VARARGS,
     "the active-conflict deps scan with transitive elision"},
    {"encode_window", encode_window, METH_VARARGS,
     "a flush window's sorted timestamp universe and int32 rank columns"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_accord_cfk",
    "native CommandsForKey core loops", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

extern "C" PyMODINIT_FUNC PyInit__accord_cfk(void) {
    s_cmp = PyUnicode_InternFromString("_cmp");
    s_flags = PyUnicode_InternFromString("flags");
    s_ids = PyUnicode_InternFromString("_ids");
    s_status = PyUnicode_InternFromString("_status");
    s_eat = PyUnicode_InternFromString("_eat");
    if (s_cmp == nullptr || s_flags == nullptr || s_ids == nullptr
        || s_status == nullptr || s_eat == nullptr)
        return nullptr;
    return PyModule_Create(&moduledef);
}
