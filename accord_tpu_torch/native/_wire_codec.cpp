/* Native binary frame codec — the TCP host's hot encode/decode path.
 *
 * Serialises the structural wire tree (accord_tpu_torch/host/wire.py `encode`
 * output: None/bool/int/float/str/list/dict, plus the single-key
 * timestamp/key fast-path dicts) into the tagged binary format defined in
 * host/wire.py.  The contract is BYTE-IDENTICAL output with the
 * pure-Python tier (`py_pack`/`py_unpack`): tests/test_wire_roundtrip.py
 * cross-checks both directions over every registered verb, so a host on
 * either tier interoperates bit-for-bit with the other.
 *
 * Built on first import by accord_tpu_torch/native/__init__.py (g++ into a
 * cached shared object, same lazy-build pattern as _sorted_arrays.cpp);
 * any build/load failure degrades silently to the Python tier.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>

namespace {

constexpr unsigned char T_NONE = 0x00, T_FALSE = 0x01, T_TRUE = 0x02,
    T_INT = 0x03, T_FLOAT = 0x04, T_STR = 0x05, T_LIST = 0x06,
    T_DICT = 0x07, T_TS = 0x08, T_TXNID = 0x09, T_BALLOT = 0x0A,
    T_KEY = 0x0B, T_RKEY = 0x0C, T_KEYS = 0x0D, T_RKEYS = 0x0E,
    T_ITUPLE = 0x0F, T_BIGINT = 0x10;

constexpr int MAX_DEPTH = 200;  /* hostile-input recursion bound */

/* ---- object-packing bindings (wire_bind) ----
 * The payload boundary: frame bodies are TREES (dict/list/scalar), but a
 * body's "payload" may be the RAW protocol message object — pack_value
 * switches to pack_object there and serialises the whole message in one
 * native pass (no intermediate encode() tree).  The Python tier mirrors
 * this byte-for-byte by packing encode(obj)'s tree. */
static PyObject *g_ts, *g_txnid, *g_ballot, *g_key, *g_rkey, *g_keys,
    *g_rkeys;
static PyObject *g_enum_base;         /* enum.Enum */
static PyObject *g_registry_provider; /* callable -> ({name: cls},
                                         {name: enum_cls}) */
static PyObject *g_registry;          /* cached classes dict */
static PyObject *g_enums;             /* cached enums dict */
static PyObject *g_slots_of;          /* callable cls -> [slot, ...] */
static PyObject *g_slots_cache;       /* dict cls -> list */
static PyObject *g_py_encode;         /* wire.encode (fallback) */
static PyObject *s_epoch, *s_hlc, *s_flags, *s_node, *s_token, *s_keys_attr,
    *s_dict_attr, *s_value_attr, *s_name_attr;
constexpr int HLC_LOW_BITS = 48;      /* timestamp.py _HLC_LOW_BITS */
constexpr uint64_t HLC_LOW_MASK = (1ULL << HLC_LOW_BITS) - 1;

struct Writer {
    std::string buf;

    void byte(unsigned char b) { buf.push_back((char)b); }
    void raw(const char *p, Py_ssize_t n) { buf.append(p, (size_t)n); }

    void varint(uint64_t v) {
        while (v >= 0x80) {
            byte((unsigned char)((v & 0x7F) | 0x80));
            v >>= 7;
        }
        byte((unsigned char)v);
    }
    void zigzag(int64_t n) {
        varint(((uint64_t)n << 1) ^ (uint64_t)(n >> 63));
    }
};

/* exact int64 value of an exact-type int, with ok=false on overflow */
inline bool as_i64(PyObject *obj, int64_t *out) {
    int overflow = 0;
    long long v = PyLong_AsLongLongAndOverflow(obj, &overflow);
    if (overflow != 0) return false;
    if (v == -1 && PyErr_Occurred()) return false;  /* propagated by caller */
    *out = (int64_t)v;
    return true;
}

/* all elements of a list are exact ints fitting int64 */
bool all_i64_list(PyObject *list) {
    Py_ssize_t n = PyList_GET_SIZE(list);
    for (Py_ssize_t i = 0; i < n; ++i) {
        PyObject *x = PyList_GET_ITEM(list, i);
        if (!PyLong_CheckExact(x)) return false;
        int64_t v;
        if (!as_i64(x, &v)) { PyErr_Clear(); return false; }
    }
    return true;
}

/* single-key fast-path tag for a dict key name, 0 when none */
unsigned char tag_for_key(PyObject *key) {
    if (!PyUnicode_Check(key)) return 0;
    Py_ssize_t n;
    const char *s = PyUnicode_AsUTF8AndSize(key, &n);
    if (s == nullptr) { PyErr_Clear(); return 0; }
    if (n < 2 || n > 4 || s[0] != '$') return 0;
    if (n == 2) {
        switch (s[1]) {
            case 'T': return T_TS;
            case 'I': return T_TXNID;
            case 'B': return T_BALLOT;
            case 'K': return T_KEY;
            case 't': return T_ITUPLE;
        }
        return 0;
    }
    if (n == 3 && s[1] == 'R' && s[2] == 'K') return T_RKEY;
    if (n == 3 && s[1] == 'K' && s[2] == 's') return T_KEYS;
    if (n == 4 && memcmp(s + 1, "RKs", 3) == 0) return T_RKEYS;
    return 0;
}

bool pack_value(PyObject *obj, Writer &w, int depth);
bool pack_object(PyObject *obj, Writer &w, int depth);

bool pack_generic_dict(PyObject *obj, Writer &w, int depth) {
    w.byte(T_DICT);
    w.varint((uint64_t)PyDict_GET_SIZE(obj));
    PyObject *key, *value;
    Py_ssize_t pos = 0;
    while (PyDict_Next(obj, &pos, &key, &value)) {
        if (!pack_value(key, w, depth + 1)) return false;
        if (!pack_value(value, w, depth + 1)) return false;
    }
    return true;
}

/* write one utf8 string value (tag + len + bytes) */
bool write_str(PyObject *s, Writer &w) {
    Py_ssize_t n;
    const char *p = PyUnicode_AsUTF8AndSize(s, &n);
    if (p == nullptr) return false;
    w.byte(T_STR);
    w.varint((uint64_t)n);
    w.raw(p, n);
    return true;
}

bool write_cstr(const char *p, Writer &w) {
    size_t n = strlen(p);
    w.byte(T_STR);
    w.varint((uint64_t)n);
    w.raw(p, (Py_ssize_t)n);
    return true;
}

/* exact unsigned-64 value of an exact-type int; ok=false on overflow/neg */
inline bool as_u64(PyObject *obj, uint64_t *out) {
    unsigned long long v = PyLong_AsUnsignedLongLong(obj);
    if (v == (unsigned long long)-1 && PyErr_Occurred()) {
        PyErr_Clear();
        return false;
    }
    *out = (uint64_t)v;
    return true;
}

bool all_u64_list(PyObject *list) {
    Py_ssize_t n = PyList_GET_SIZE(list);
    for (Py_ssize_t i = 0; i < n; ++i) {
        PyObject *x = PyList_GET_ITEM(list, i);
        uint64_t v;
        if (!PyLong_CheckExact(x) || !as_u64(x, &v)) return false;
    }
    return true;
}

bool pack_int(PyObject *obj, Writer &w) {
    int64_t v;
    if (as_i64(obj, &v)) {
        w.byte(T_INT);
        w.zigzag(v);
        return true;
    }
    if (PyErr_Occurred()) return false;
    /* > int64: decimal string, same as the Python tier */
    PyObject *s = PyObject_Str(obj);
    if (s == nullptr) return false;
    Py_ssize_t n;
    const char *p = PyUnicode_AsUTF8AndSize(s, &n);
    if (p == nullptr) { Py_DECREF(s); return false; }
    w.byte(T_BIGINT);
    w.varint((uint64_t)n);
    w.raw(p, n);
    Py_DECREF(s);
    return true;
}

void pack_float(PyObject *obj, Writer &w) {
    double d = PyFloat_AS_DOUBLE(obj);
    uint64_t bits;
    memcpy(&bits, &d, 8);
    w.byte(T_FLOAT);
    for (int i = 7; i >= 0; --i)
        w.byte((unsigned char)((bits >> (8 * i)) & 0xFF));
}

bool pack_value(PyObject *obj, Writer &w, int depth) {
    if (depth > MAX_DEPTH) {
        PyErr_SetString(PyExc_ValueError, "wire tree too deep");
        return false;
    }
    if (obj == Py_None) { w.byte(T_NONE); return true; }
    if (obj == Py_True) { w.byte(T_TRUE); return true; }
    if (obj == Py_False) { w.byte(T_FALSE); return true; }
    if (PyLong_CheckExact(obj)) return pack_int(obj, w);
    if (PyFloat_CheckExact(obj)) { pack_float(obj, w); return true; }
    if (PyUnicode_CheckExact(obj)) return write_str(obj, w);
    if (PyList_CheckExact(obj) || PyTuple_CheckExact(obj)) {
        Py_ssize_t n = PyList_CheckExact(obj) ? PyList_GET_SIZE(obj)
                                              : PyTuple_GET_SIZE(obj);
        w.byte(T_LIST);
        w.varint((uint64_t)n);
        for (Py_ssize_t i = 0; i < n; ++i) {
            PyObject *x = PyList_CheckExact(obj) ? PyList_GET_ITEM(obj, i)
                                                 : PyTuple_GET_ITEM(obj, i);
            if (!pack_value(x, w, depth + 1)) return false;
        }
        return true;
    }
    if (PyDict_CheckExact(obj)) {
        if (PyDict_GET_SIZE(obj) == 1) {
            PyObject *key, *value;
            Py_ssize_t pos = 0;
            PyDict_Next(obj, &pos, &key, &value);
            unsigned char tag = tag_for_key(key);
            if (tag == T_TS || tag == T_TXNID || tag == T_BALLOT) {
                /* timestamp packs are non-negative bit-packs whose lsb
                 * can exceed int64: UNSIGNED varints */
                if (PyList_CheckExact(value) && PyList_GET_SIZE(value) == 3
                        && all_u64_list(value)) {
                    w.byte(tag);
                    for (Py_ssize_t i = 0; i < 3; ++i) {
                        uint64_t v;
                        as_u64(PyList_GET_ITEM(value, i), &v);
                        w.varint(v);
                    }
                    return true;
                }
            } else if (tag == T_KEY || tag == T_RKEY) {
                int64_t v;
                if (PyLong_CheckExact(value) && as_i64(value, &v)) {
                    w.byte(tag);
                    w.zigzag(v);
                    return true;
                }
                if (PyErr_Occurred()) PyErr_Clear();
            } else if (tag != 0) {             /* $Ks / $RKs / $t */
                if (PyList_CheckExact(value) && all_i64_list(value)) {
                    Py_ssize_t n = PyList_GET_SIZE(value);
                    w.byte(tag);
                    w.varint((uint64_t)n);
                    for (Py_ssize_t i = 0; i < n; ++i) {
                        int64_t v;
                        as_i64(PyList_GET_ITEM(value, i), &v);
                        w.zigzag(v);
                    }
                    return true;
                }
            }
        }
        return pack_generic_dict(obj, w, depth);
    }
    /* not a tree node: the payload boundary — one-pass raw-object pack */
    return pack_object(obj, w, depth);
}

/* ---------------------------------------------------- raw object pack -- */

bool fetch_registry() {
    if (g_registry_provider == nullptr) return false;
    PyObject *pair = PyObject_CallNoArgs(g_registry_provider);
    if (pair == nullptr) return false;
    if (!PyTuple_Check(pair) || PyTuple_GET_SIZE(pair) != 2) {
        Py_DECREF(pair);
        PyErr_SetString(PyExc_TypeError,
                        "registry provider must return (classes, enums)");
        return false;
    }
    g_registry = PyTuple_GET_ITEM(pair, 0);
    g_enums = PyTuple_GET_ITEM(pair, 1);
    Py_INCREF(g_registry);
    Py_INCREF(g_enums);
    Py_DECREF(pair);
    return true;
}

bool fallback_py(PyObject *obj, Writer &w, int depth) {
    /* semantics of last resort: the Python structural walk builds the
     * tree (raising TypeError for unregistered types exactly like the
     * Python tier), and the tree packs as usual */
    if (g_py_encode == nullptr) {
        PyErr_Format(PyExc_TypeError, "binary wire codec cannot pack %s",
                     Py_TYPE(obj)->tp_name);
        return false;
    }
    PyObject *tree = PyObject_CallOneArg(g_py_encode, obj);
    if (tree == nullptr) return false;
    bool ok = pack_value(tree, w, depth);
    Py_DECREF(tree);
    return ok;
}

bool attr_u64(PyObject *obj, PyObject *name, uint64_t *out) {
    PyObject *v = PyObject_GetAttr(obj, name);
    if (v == nullptr) { PyErr_Clear(); return false; }
    bool ok = PyLong_CheckExact(v) && as_u64(v, out);
    Py_DECREF(v);
    return ok;
}

bool attr_i64(PyObject *obj, PyObject *name, int64_t *out) {
    PyObject *v = PyObject_GetAttr(obj, name);
    if (v == nullptr) { PyErr_Clear(); return false; }
    bool ok = false;
    if (PyLong_CheckExact(v)) {
        ok = as_i64(v, out);
        if (!ok && PyErr_Occurred()) PyErr_Clear();
    }
    Py_DECREF(v);
    return ok;
}

bool pack_object(PyObject *obj, Writer &w, int depth) {
    if (depth > MAX_DEPTH) {
        PyErr_SetString(PyExc_ValueError, "wire tree too deep");
        return false;
    }
    if (obj == Py_None) { w.byte(T_NONE); return true; }
    if (obj == Py_True) { w.byte(T_TRUE); return true; }
    if (obj == Py_False) { w.byte(T_FALSE); return true; }
    if (PyLong_CheckExact(obj)) return pack_int(obj, w);
    if (PyFloat_CheckExact(obj)) { pack_float(obj, w); return true; }
    if (PyUnicode_CheckExact(obj)) return write_str(obj, w);
    PyObject *t = (PyObject *)Py_TYPE(obj);
    if (t == g_ts || t == g_txnid || t == g_ballot) {
        uint64_t epoch, hlc, flags, node;
        if (attr_u64(obj, s_epoch, &epoch) && epoch <= HLC_LOW_MASK
                && attr_u64(obj, s_hlc, &hlc)
                && attr_u64(obj, s_flags, &flags)
                && attr_u64(obj, s_node, &node)) {
            /* mirror Timestamp.pack() exactly (timestamp.py msb/lsb) */
            uint64_t msb = (epoch << 16) | ((hlc >> HLC_LOW_BITS) & 0xFFFF);
            uint64_t lsb = ((hlc & HLC_LOW_MASK) << 16) | (flags & 0xFFFF);
            w.byte(t == g_ts ? T_TS : (t == g_txnid ? T_TXNID : T_BALLOT));
            w.varint(msb);
            w.varint(lsb);
            w.varint(node);
            return true;
        }
        return fallback_py(obj, w, depth);
    }
    if (t == g_key || t == g_rkey) {
        int64_t tok;
        if (attr_i64(obj, s_token, &tok)) {
            w.byte(t == g_key ? T_KEY : T_RKEY);
            w.zigzag(tok);
            return true;
        }
        return fallback_py(obj, w, depth);
    }
    if (t == g_keys || t == g_rkeys) {
        PyObject *elems = PyObject_GetAttr(obj, s_keys_attr);
        if (elems != nullptr && PyTuple_CheckExact(elems)) {
            PyObject *want = (t == g_keys) ? g_key : g_rkey;
            Py_ssize_t n = PyTuple_GET_SIZE(elems);
            Writer tokens;
            bool ok = true;
            for (Py_ssize_t i = 0; i < n && ok; ++i) {
                PyObject *k = PyTuple_GET_ITEM(elems, i);
                int64_t tok;
                ok = ((PyObject *)Py_TYPE(k) == want)
                     && attr_i64(k, s_token, &tok);
                if (ok) tokens.zigzag(tok);
            }
            Py_DECREF(elems);
            if (ok) {
                w.byte(t == g_keys ? T_KEYS : T_RKEYS);
                w.varint((uint64_t)n);
                w.buf.append(tokens.buf);
                return true;
            }
        } else {
            Py_XDECREF(elems);
            PyErr_Clear();
        }
        return fallback_py(obj, w, depth);
    }
    if (PyList_CheckExact(obj)) {
        Py_ssize_t n = PyList_GET_SIZE(obj);
        w.byte(T_LIST);
        w.varint((uint64_t)n);
        for (Py_ssize_t i = 0; i < n; ++i)
            if (!pack_object(PyList_GET_ITEM(obj, i), w, depth + 1))
                return false;
        return true;
    }
    if (PyTuple_CheckExact(obj)) {
        /* object-context tuples are {"$t": ...}: int-only fast tag, else
         * a generic single-key dict around the element list */
        Py_ssize_t n = PyTuple_GET_SIZE(obj);
        bool ints = true;
        for (Py_ssize_t i = 0; i < n && ints; ++i) {
            PyObject *x = PyTuple_GET_ITEM(obj, i);
            int64_t v;
            ints = PyLong_CheckExact(x) && as_i64(x, &v);
            if (!ints && PyErr_Occurred()) PyErr_Clear();
        }
        if (ints) {
            w.byte(T_ITUPLE);
            w.varint((uint64_t)n);
            for (Py_ssize_t i = 0; i < n; ++i) {
                int64_t v;
                as_i64(PyTuple_GET_ITEM(obj, i), &v);
                w.zigzag(v);
            }
            return true;
        }
        w.byte(T_DICT);
        w.varint(1);
        write_cstr("$t", w);
        w.byte(T_LIST);
        w.varint((uint64_t)n);
        for (Py_ssize_t i = 0; i < n; ++i)
            if (!pack_object(PyTuple_GET_ITEM(obj, i), w, depth + 1))
                return false;
        return true;
    }
    if (PyDict_CheckExact(obj)) {
        /* a DATA dict at object level: {"$d": [[k, v], ...]} */
        w.byte(T_DICT);
        w.varint(1);
        write_cstr("$d", w);
        w.byte(T_LIST);
        w.varint((uint64_t)PyDict_GET_SIZE(obj));
        PyObject *key, *value;
        Py_ssize_t pos = 0;
        while (PyDict_Next(obj, &pos, &key, &value)) {
            w.byte(T_LIST);
            w.varint(2);
            if (!pack_object(key, w, depth + 1)) return false;
            if (!pack_object(value, w, depth + 1)) return false;
        }
        return true;
    }
    if (PySet_Check(obj) || PyFrozenSet_Check(obj)) {
        if (PySet_CheckExact(obj) || PyFrozenSet_CheckExact(obj)) {
            w.byte(T_DICT);
            w.varint(1);
            write_cstr("$s", w);
            w.byte(T_LIST);
            w.varint((uint64_t)PySet_GET_SIZE(obj));
            PyObject *it = PyObject_GetIter(obj);
            if (it == nullptr) return false;
            PyObject *x;
            while ((x = PyIter_Next(it)) != nullptr) {
                bool ok = pack_object(x, w, depth + 1);
                Py_DECREF(x);
                if (!ok) { Py_DECREF(it); return false; }
            }
            Py_DECREF(it);
            return !PyErr_Occurred();
        }
        return fallback_py(obj, w, depth);
    }
    if (g_enum_base != nullptr) {
        int is_enum = PyObject_IsInstance(obj, g_enum_base);
        if (is_enum < 0) return false;
        if (is_enum) {
            PyObject *name = PyObject_GetAttr(t, s_name_attr);
            PyObject *value = PyObject_GetAttr(obj, s_value_attr);
            if (name == nullptr || value == nullptr) {
                Py_XDECREF(name);
                Py_XDECREF(value);
                return false;
            }
            w.byte(T_DICT);
            w.varint(2);
            bool ok = write_cstr("$e", w) && write_str(name, w)
                      && write_cstr("v", w)
                      && pack_object(value, w, depth + 1);
            Py_DECREF(name);
            Py_DECREF(value);
            return ok;
        }
    }
    if (PyExceptionInstance_Check(obj)) {
        PyObject *name = PyObject_GetAttr(t, s_name_attr);
        PyObject *msg = PyObject_Str(obj);
        if (name == nullptr || msg == nullptr) {
            Py_XDECREF(name);
            Py_XDECREF(msg);
            return false;
        }
        w.byte(T_DICT);
        w.varint(2);
        bool ok = write_cstr("$x", w) && write_str(name, w)
                  && write_cstr("msg", w) && write_str(msg, w);
        Py_DECREF(name);
        Py_DECREF(msg);
        return ok;
    }
    /* registered protocol class: {"$c": name, "f": {field: ...}} */
    if (g_registry == nullptr && !fetch_registry()) return false;
    if (g_registry != nullptr && g_slots_of != nullptr) {
        PyObject *name = PyObject_GetAttr(t, s_name_attr);
        if (name == nullptr) { PyErr_Clear(); return fallback_py(obj, w, depth); }
        PyObject *cls = PyDict_GetItemWithError(g_registry, name);
        if (cls != t) {  /* unregistered or shadowed: Python semantics */
            Py_DECREF(name);
            if (PyErr_Occurred()) return false;
            return fallback_py(obj, w, depth);
        }
        PyObject *slots = PyDict_GetItemWithError(g_slots_cache, t);
        if (slots == nullptr) {
            if (PyErr_Occurred()) { Py_DECREF(name); return false; }
            slots = PyObject_CallOneArg(g_slots_of, t);
            if (slots == nullptr
                    || PyDict_SetItem(g_slots_cache, t, slots) < 0) {
                Py_XDECREF(slots);
                Py_DECREF(name);
                return false;
            }
            Py_DECREF(slots);  /* cache holds it; borrow below */
            slots = PyDict_GetItemWithError(g_slots_cache, t);
        }
        PyObject *fields = PyDict_New();
        if (fields == nullptr) { Py_DECREF(name); return false; }
        Py_ssize_t ns = PySequence_Fast_GET_SIZE(slots);
        PyObject **slot_items = PySequence_Fast_ITEMS(slots);
        for (Py_ssize_t i = 0; i < ns; ++i) {
            PyObject *v = PyObject_GetAttr(obj, slot_items[i]);
            if (v == nullptr) { PyErr_Clear(); continue; }
            int rc = PyDict_SetItem(fields, slot_items[i], v);
            Py_DECREF(v);
            if (rc < 0) { Py_DECREF(fields); Py_DECREF(name); return false; }
        }
        PyObject *d = PyObject_GetAttr(obj, s_dict_attr);
        if (d == nullptr) {
            PyErr_Clear();
        } else {
            if (PyDict_CheckExact(d)) {
                PyObject *key, *value;
                Py_ssize_t pos = 0;
                while (PyDict_Next(d, &pos, &key, &value)) {
                    if (PyDict_SetItem(fields, key, value) < 0) {
                        Py_DECREF(d); Py_DECREF(fields); Py_DECREF(name);
                        return false;
                    }
                }
            }
            Py_DECREF(d);
        }
        w.byte(T_DICT);
        w.varint(2);
        bool ok = write_cstr("$c", w) && write_str(name, w)
                  && write_cstr("f", w);
        if (ok) {
            w.byte(T_DICT);
            w.varint((uint64_t)PyDict_GET_SIZE(fields));
            PyObject *key, *value;
            Py_ssize_t pos = 0;
            while (ok && PyDict_Next(fields, &pos, &key, &value)) {
                ok = pack_value(key, w, depth + 1)
                     && pack_object(value, w, depth + 1);
            }
        }
        Py_DECREF(fields);
        Py_DECREF(name);
        return ok;
    }
    return fallback_py(obj, w, depth);
}

PyObject *wire_pack(PyObject *, PyObject *args) {
    PyObject *obj;
    if (!PyArg_ParseTuple(args, "O", &obj)) return nullptr;
    Writer w;
    w.buf.reserve(256);
    if (!pack_value(obj, w, 0)) return nullptr;
    return PyBytes_FromStringAndSize(w.buf.data(),
                                     (Py_ssize_t)w.buf.size());
}

/* ------------------------------------------------------------- unpack -- */

struct Reader {
    const unsigned char *data;
    Py_ssize_t n, pos = 0;

    bool need(Py_ssize_t k) {
        if (pos + k > n) {
            PyErr_SetString(PyExc_ValueError, "truncated binary frame");
            return false;
        }
        return true;
    }
    bool byte(unsigned char *out) {
        if (!need(1)) return false;
        *out = data[pos++];
        return true;
    }
    bool varint(uint64_t *out) {
        uint64_t v = 0;
        int shift = 0;
        unsigned char b;
        do {
            if (shift > 70) {
                PyErr_SetString(PyExc_ValueError, "varint too long");
                return false;
            }
            if (!byte(&b)) return false;
            v |= (uint64_t)(b & 0x7F) << shift;
            shift += 7;
        } while (b & 0x80);
        *out = v;
        return true;
    }
    bool zigzag(int64_t *out) {
        uint64_t u;
        if (!varint(&u)) return false;
        *out = (int64_t)((u >> 1) ^ (~(u & 1) + 1));
        return true;
    }
};

/* the single-key dict {"<name>": value}, stealing `value` */
PyObject *dict1(const char *name, PyObject *value) {
    if (value == nullptr) return nullptr;
    PyObject *d = PyDict_New();
    if (d == nullptr || PyDict_SetItemString(d, name, value) < 0) {
        Py_XDECREF(d);
        Py_DECREF(value);
        return nullptr;
    }
    Py_DECREF(value);
    return d;
}

const char *key_for_tag(unsigned char tag) {
    switch (tag) {
        case T_TS: return "$T";
        case T_TXNID: return "$I";
        case T_BALLOT: return "$B";
        case T_KEY: return "$K";
        case T_RKEY: return "$RK";
        case T_KEYS: return "$Ks";
        case T_RKEYS: return "$RKs";
        case T_ITUPLE: return "$t";
    }
    return nullptr;
}

PyObject *unpack_value(Reader &r, int depth) {
    if (depth > MAX_DEPTH) {
        PyErr_SetString(PyExc_ValueError, "wire tree too deep");
        return nullptr;
    }
    unsigned char tag;
    if (!r.byte(&tag)) return nullptr;
    switch (tag) {
        case T_NONE: Py_RETURN_NONE;
        case T_TRUE: Py_RETURN_TRUE;
        case T_FALSE: Py_RETURN_FALSE;
        case T_INT: {
            int64_t v;
            if (!r.zigzag(&v)) return nullptr;
            return PyLong_FromLongLong((long long)v);
        }
        case T_FLOAT: {
            if (!r.need(8)) return nullptr;
            uint64_t bits = 0;
            for (int i = 0; i < 8; ++i)
                bits = (bits << 8) | r.data[r.pos++];
            double d;
            memcpy(&d, &bits, 8);
            return PyFloat_FromDouble(d);
        }
        case T_STR: {
            uint64_t n;
            if (!r.varint(&n) || !r.need((Py_ssize_t)n)) return nullptr;
            PyObject *s = PyUnicode_DecodeUTF8(
                (const char *)r.data + r.pos, (Py_ssize_t)n, nullptr);
            r.pos += (Py_ssize_t)n;
            return s;
        }
        case T_LIST: {
            uint64_t n;
            if (!r.varint(&n)) return nullptr;
            if ((Py_ssize_t)n > r.n - r.pos) {  /* >=1 byte per element */
                PyErr_SetString(PyExc_ValueError, "truncated binary frame");
                return nullptr;
            }
            PyObject *list = PyList_New((Py_ssize_t)n);
            if (list == nullptr) return nullptr;
            for (Py_ssize_t i = 0; i < (Py_ssize_t)n; ++i) {
                PyObject *x = unpack_value(r, depth + 1);
                if (x == nullptr) { Py_DECREF(list); return nullptr; }
                PyList_SET_ITEM(list, i, x);
            }
            return list;
        }
        case T_DICT: {
            uint64_t n;
            if (!r.varint(&n)) return nullptr;
            if ((Py_ssize_t)n > r.n - r.pos) {
                PyErr_SetString(PyExc_ValueError, "truncated binary frame");
                return nullptr;
            }
            PyObject *d = PyDict_New();
            if (d == nullptr) return nullptr;
            for (uint64_t i = 0; i < n; ++i) {
                PyObject *k = unpack_value(r, depth + 1);
                if (k == nullptr) { Py_DECREF(d); return nullptr; }
                PyObject *v = unpack_value(r, depth + 1);
                if (v == nullptr) { Py_DECREF(k); Py_DECREF(d);
                                    return nullptr; }
                int rc = PyDict_SetItem(d, k, v);
                Py_DECREF(k);
                Py_DECREF(v);
                if (rc < 0) { Py_DECREF(d); return nullptr; }
            }
            return d;
        }
        case T_TS: case T_TXNID: case T_BALLOT: {
            PyObject *list = PyList_New(3);
            if (list == nullptr) return nullptr;
            for (int i = 0; i < 3; ++i) {
                uint64_t v;           /* timestamp packs: UNSIGNED varints */
                if (!r.varint(&v)) { Py_DECREF(list); return nullptr; }
                PyObject *x = PyLong_FromUnsignedLongLong(v);
                if (x == nullptr) { Py_DECREF(list); return nullptr; }
                PyList_SET_ITEM(list, i, x);
            }
            return dict1(key_for_tag(tag), list);
        }
        case T_KEY: case T_RKEY: {
            int64_t v;
            if (!r.zigzag(&v)) return nullptr;
            return dict1(key_for_tag(tag),
                         PyLong_FromLongLong((long long)v));
        }
        case T_KEYS: case T_RKEYS: case T_ITUPLE: {
            uint64_t n;
            if (!r.varint(&n)) return nullptr;
            if ((Py_ssize_t)n > r.n - r.pos) {
                PyErr_SetString(PyExc_ValueError, "truncated binary frame");
                return nullptr;
            }
            PyObject *list = PyList_New((Py_ssize_t)n);
            if (list == nullptr) return nullptr;
            for (Py_ssize_t i = 0; i < (Py_ssize_t)n; ++i) {
                int64_t v;
                if (!r.zigzag(&v)) { Py_DECREF(list); return nullptr; }
                PyObject *x = PyLong_FromLongLong((long long)v);
                if (x == nullptr) { Py_DECREF(list); return nullptr; }
                PyList_SET_ITEM(list, i, x);
            }
            return dict1(key_for_tag(tag), list);
        }
        case T_BIGINT: {
            uint64_t n;
            if (!r.varint(&n) || !r.need((Py_ssize_t)n)) return nullptr;
            std::string s((const char *)r.data + r.pos, (size_t)n);
            r.pos += (Py_ssize_t)n;
            return PyLong_FromString(s.c_str(), nullptr, 10);
        }
    }
    PyErr_Format(PyExc_ValueError, "unknown binary wire tag 0x%02x",
                 (int)tag);
    return nullptr;
}

/* ---------------------------------------------- one-pass object decode --
 * bytes -> decoded frame: plain dicts stay dicts (frame/body structure),
 * tagged dicts and the primitive tags become PROTOCOL OBJECTS — the
 * native fusion of unpack_frame + decode_message the TCP host's ingress
 * runs per frame. */

static PyObject *s_unpack_attr, *s_new_attr, *s_presorted_kw;

PyObject *unpack_obj(Reader &r, int depth);

PyObject *unpack_obj_list(Reader &r, int depth, Py_ssize_t n) {
    PyObject *list = PyList_New(n);
    if (list == nullptr) return nullptr;
    for (Py_ssize_t i = 0; i < n; ++i) {
        PyObject *x = unpack_obj(r, depth);
        if (x == nullptr) { Py_DECREF(list); return nullptr; }
        PyList_SET_ITEM(list, i, x);
    }
    return list;
}

/* expect a T_LIST header and return its decoded elements */
PyObject *expect_list(Reader &r, int depth) {
    unsigned char tag;
    if (!r.byte(&tag)) return nullptr;
    if (tag != T_LIST) {
        PyErr_SetString(PyExc_ValueError, "malformed tagged container");
        return nullptr;
    }
    uint64_t n;
    if (!r.varint(&n)) return nullptr;
    if ((Py_ssize_t)n > r.n - r.pos) {
        PyErr_SetString(PyExc_ValueError, "truncated binary frame");
        return nullptr;
    }
    return unpack_obj_list(r, depth + 1, (Py_ssize_t)n);
}

/* read the next value and require a str (tagged-dict keys) */
PyObject *expect_str(Reader &r, int depth) {
    PyObject *k = unpack_obj(r, depth);
    if (k == nullptr) return nullptr;
    if (!PyUnicode_CheckExact(k)) {
        Py_DECREF(k);
        PyErr_SetString(PyExc_ValueError, "malformed tagged dict");
        return nullptr;
    }
    return k;
}

PyObject *call_ts_unpack(PyObject *cls, Reader &r) {
    uint64_t m, l, n;
    if (!r.varint(&m) || !r.varint(&l) || !r.varint(&n)) return nullptr;
    PyObject *pm = PyLong_FromUnsignedLongLong(m);
    PyObject *pl = PyLong_FromUnsignedLongLong(l);
    PyObject *pn = PyLong_FromUnsignedLongLong(n);
    PyObject *out = nullptr;
    if (pm != nullptr && pl != nullptr && pn != nullptr)
        out = PyObject_CallMethodObjArgs(cls, s_unpack_attr, pm, pl, pn,
                                         nullptr);
    Py_XDECREF(pm);
    Py_XDECREF(pl);
    Py_XDECREF(pn);
    return out;
}

PyObject *make_keys(PyObject *key_cls, PyObject *keys_cls, Reader &r) {
    uint64_t n;
    if (!r.varint(&n)) return nullptr;
    if ((Py_ssize_t)n > r.n - r.pos) {
        PyErr_SetString(PyExc_ValueError, "truncated binary frame");
        return nullptr;
    }
    PyObject *elems = PyList_New((Py_ssize_t)n);
    if (elems == nullptr) return nullptr;
    int64_t prev = 0;
    bool sorted_ok = true;  /* strictly ascending, like the Python tier */
    for (Py_ssize_t i = 0; i < (Py_ssize_t)n; ++i) {
        int64_t tok;
        if (!r.zigzag(&tok)) { Py_DECREF(elems); return nullptr; }
        if (i > 0 && tok <= prev) sorted_ok = false;
        prev = tok;
        PyObject *ptok = PyLong_FromLongLong((long long)tok);
        PyObject *k = ptok ? PyObject_CallOneArg(key_cls, ptok) : nullptr;
        Py_XDECREF(ptok);
        if (k == nullptr) { Py_DECREF(elems); return nullptr; }
        PyList_SET_ITEM(elems, i, k);
    }
    PyObject *kwargs = PyDict_New();
    PyObject *argt = PyTuple_Pack(1, elems);
    Py_DECREF(elems);
    PyObject *out = nullptr;
    if (kwargs != nullptr && argt != nullptr
            && PyDict_SetItem(kwargs, s_presorted_kw,
                              sorted_ok ? Py_True : Py_False) == 0)
        out = PyObject_Call(keys_cls, argt, kwargs);
    Py_XDECREF(kwargs);
    Py_XDECREF(argt);
    return out;
}

/* tagged-dict object semantics; consumes the remaining pairs after the
 * first key (already read).  Returns the decoded object. */
PyObject *unpack_tagged_dict(Reader &r, int depth, uint64_t count,
                             PyObject *first_key) {
    const char *k = PyUnicode_AsUTF8(first_key);
    if (k == nullptr) return nullptr;
    if (count == 1 && strcmp(k, "$d") == 0) {
        PyObject *pairs = expect_list(r, depth);
        if (pairs == nullptr) return nullptr;
        PyObject *d = PyDict_New();
        if (d == nullptr) { Py_DECREF(pairs); return nullptr; }
        for (Py_ssize_t i = 0; i < PyList_GET_SIZE(pairs); ++i) {
            PyObject *kv = PyList_GET_ITEM(pairs, i);
            if (!PyList_CheckExact(kv) || PyList_GET_SIZE(kv) != 2) {
                PyErr_SetString(PyExc_ValueError, "malformed $d pair");
                Py_DECREF(pairs); Py_DECREF(d);
                return nullptr;
            }
            if (PyDict_SetItem(d, PyList_GET_ITEM(kv, 0),
                               PyList_GET_ITEM(kv, 1)) < 0) {
                Py_DECREF(pairs); Py_DECREF(d);
                return nullptr;
            }
        }
        Py_DECREF(pairs);
        return d;
    }
    if (count == 1 && strcmp(k, "$s") == 0) {
        PyObject *items = expect_list(r, depth);
        if (items == nullptr) return nullptr;
        PyObject *out = PyFrozenSet_New(items);
        Py_DECREF(items);
        return out;
    }
    if (count == 1 && strcmp(k, "$t") == 0) {
        PyObject *items = expect_list(r, depth);
        if (items == nullptr) return nullptr;
        PyObject *out = PyList_AsTuple(items);
        Py_DECREF(items);
        return out;
    }
    if (count == 2 && strcmp(k, "$e") == 0) {
        PyObject *name = expect_str(r, depth);  /* enum type name */
        if (name == nullptr) return nullptr;
        PyObject *vkey = expect_str(r, depth);  /* "v" */
        if (vkey == nullptr) { Py_DECREF(name); return nullptr; }
        Py_DECREF(vkey);
        PyObject *value = unpack_obj(r, depth);
        if (value == nullptr) { Py_DECREF(name); return nullptr; }
        if (g_enums == nullptr && !fetch_registry()) {
            Py_DECREF(name); Py_DECREF(value);
            return nullptr;
        }
        PyObject *cls = PyDict_GetItemWithError(g_enums, name);
        if (cls == nullptr) {
            if (!PyErr_Occurred())
                PyErr_Format(PyExc_KeyError, "unknown wire enum %U", name);
            Py_DECREF(name); Py_DECREF(value);
            return nullptr;
        }
        Py_DECREF(name);
        PyObject *out = PyObject_CallOneArg(cls, value);
        Py_DECREF(value);
        return out;
    }
    if (count == 2 && strcmp(k, "$x") == 0) {
        PyObject *name = expect_str(r, depth);
        if (name == nullptr) return nullptr;
        PyObject *mkey = expect_str(r, depth);  /* "msg" */
        if (mkey == nullptr) { Py_DECREF(name); return nullptr; }
        Py_DECREF(mkey);
        PyObject *msg = unpack_obj(r, depth);
        if (msg == nullptr) { Py_DECREF(name); return nullptr; }
        if (g_registry == nullptr && !fetch_registry()) {
            Py_DECREF(name); Py_DECREF(msg);
            return nullptr;
        }
        PyObject *cls = PyDict_GetItemWithError(g_registry, name);
        PyObject *out = nullptr;
        if (cls != nullptr
                && PyObject_IsSubclass(cls, PyExc_BaseException) == 1) {
            out = PyObject_CallOneArg(cls, msg);
        } else {
            PyErr_Clear();
            out = PyObject_CallFunction(PyExc_RuntimeError, "N",
                                        PyUnicode_FromFormat("%U: %U",
                                                             name, msg));
        }
        Py_DECREF(name);
        Py_DECREF(msg);
        return out;
    }
    if (count == 2 && strcmp(k, "$c") == 0) {
        PyObject *name = expect_str(r, depth);
        if (name == nullptr) return nullptr;
        PyObject *fkey = expect_str(r, depth);  /* "f" */
        if (fkey == nullptr) { Py_DECREF(name); return nullptr; }
        Py_DECREF(fkey);
        if (g_registry == nullptr && !fetch_registry()) {
            Py_DECREF(name);
            return nullptr;
        }
        PyObject *cls = PyDict_GetItemWithError(g_registry, name);
        if (cls == nullptr) {
            if (!PyErr_Occurred())
                PyErr_Format(PyExc_TypeError, "unregistered wire type: %U",
                             name);
            Py_DECREF(name);
            return nullptr;
        }
        Py_DECREF(name);
        unsigned char tag;
        uint64_t nf;
        if (!r.byte(&tag) || tag != T_DICT || !r.varint(&nf)) {
            if (!PyErr_Occurred())
                PyErr_SetString(PyExc_ValueError, "malformed $c fields");
            return nullptr;
        }
        PyObject *obj = PyObject_CallMethodObjArgs(cls, s_new_attr, cls,
                                                   nullptr);
        if (obj == nullptr) return nullptr;
        for (uint64_t i = 0; i < nf; ++i) {
            PyObject *fname = unpack_obj(r, depth);
            if (fname == nullptr) { Py_DECREF(obj); return nullptr; }
            PyObject *fval = unpack_obj(r, depth);
            if (fval == nullptr) {
                Py_DECREF(fname); Py_DECREF(obj);
                return nullptr;
            }
            /* object.__setattr__ exactly like the Python tier */
            int rc = PyObject_GenericSetAttr(obj, fname, fval);
            Py_DECREF(fname);
            Py_DECREF(fval);
            if (rc < 0) { Py_DECREF(obj); return nullptr; }
        }
        return obj;
    }
    /* plain dict that merely starts with a $-named key: fall through to
     * dict semantics (no such frame exists today; belt only) */
    PyObject *d = PyDict_New();
    if (d == nullptr) return nullptr;
    PyObject *v = unpack_obj(r, depth);
    if (v == nullptr || PyDict_SetItem(d, first_key, v) < 0) {
        Py_XDECREF(v); Py_DECREF(d);
        return nullptr;
    }
    Py_DECREF(v);
    for (uint64_t i = 1; i < count; ++i) {
        PyObject *dk = unpack_obj(r, depth);
        PyObject *dv = dk ? unpack_obj(r, depth) : nullptr;
        int rc = (dk && dv) ? PyDict_SetItem(d, dk, dv) : -1;
        Py_XDECREF(dk);
        Py_XDECREF(dv);
        if (rc < 0) { Py_DECREF(d); return nullptr; }
    }
    return d;
}

PyObject *unpack_obj(Reader &r, int depth) {
    if (depth > MAX_DEPTH) {
        PyErr_SetString(PyExc_ValueError, "wire tree too deep");
        return nullptr;
    }
    unsigned char tag;
    if (!r.byte(&tag)) return nullptr;
    switch (tag) {
        case T_NONE: Py_RETURN_NONE;
        case T_TRUE: Py_RETURN_TRUE;
        case T_FALSE: Py_RETURN_FALSE;
        case T_INT: {
            int64_t v;
            if (!r.zigzag(&v)) return nullptr;
            return PyLong_FromLongLong((long long)v);
        }
        case T_FLOAT: {
            if (!r.need(8)) return nullptr;
            uint64_t bits = 0;
            for (int i = 0; i < 8; ++i)
                bits = (bits << 8) | r.data[r.pos++];
            double d;
            memcpy(&d, &bits, 8);
            return PyFloat_FromDouble(d);
        }
        case T_STR: {
            uint64_t n;
            if (!r.varint(&n) || !r.need((Py_ssize_t)n)) return nullptr;
            PyObject *s = PyUnicode_DecodeUTF8(
                (const char *)r.data + r.pos, (Py_ssize_t)n, nullptr);
            r.pos += (Py_ssize_t)n;
            return s;
        }
        case T_BIGINT: {
            uint64_t n;
            if (!r.varint(&n) || !r.need((Py_ssize_t)n)) return nullptr;
            std::string s((const char *)r.data + r.pos, (size_t)n);
            r.pos += (Py_ssize_t)n;
            return PyLong_FromString(s.c_str(), nullptr, 10);
        }
        case T_LIST: {
            uint64_t n;
            if (!r.varint(&n)) return nullptr;
            if ((Py_ssize_t)n > r.n - r.pos) {
                PyErr_SetString(PyExc_ValueError, "truncated binary frame");
                return nullptr;
            }
            return unpack_obj_list(r, depth + 1, (Py_ssize_t)n);
        }
        case T_DICT: {
            uint64_t n;
            if (!r.varint(&n)) return nullptr;
            if ((Py_ssize_t)n > r.n - r.pos) {
                PyErr_SetString(PyExc_ValueError, "truncated binary frame");
                return nullptr;
            }
            if (n == 0) return PyDict_New();
            PyObject *first = unpack_obj(r, depth + 1);
            if (first == nullptr) return nullptr;
            if (PyUnicode_CheckExact(first)) {
                PyObject *out = unpack_tagged_dict(r, depth + 1, n, first);
                Py_DECREF(first);
                return out;
            }
            /* non-str first key: plain dict */
            PyObject *d = PyDict_New();
            PyObject *v = d ? unpack_obj(r, depth + 1) : nullptr;
            int rc = (d && v) ? PyDict_SetItem(d, first, v) : -1;
            Py_DECREF(first);
            Py_XDECREF(v);
            if (rc < 0) { Py_XDECREF(d); return nullptr; }
            for (uint64_t i = 1; i < n; ++i) {
                PyObject *dk = unpack_obj(r, depth + 1);
                PyObject *dv = dk ? unpack_obj(r, depth + 1) : nullptr;
                rc = (dk && dv) ? PyDict_SetItem(d, dk, dv) : -1;
                Py_XDECREF(dk);
                Py_XDECREF(dv);
                if (rc < 0) { Py_DECREF(d); return nullptr; }
            }
            return d;
        }
        case T_TS: return call_ts_unpack(g_ts, r);
        case T_TXNID: return call_ts_unpack(g_txnid, r);
        case T_BALLOT: return call_ts_unpack(g_ballot, r);
        case T_KEY: case T_RKEY: {
            int64_t v;
            if (!r.zigzag(&v)) return nullptr;
            PyObject *tok = PyLong_FromLongLong((long long)v);
            if (tok == nullptr) return nullptr;
            PyObject *out = PyObject_CallOneArg(
                tag == T_KEY ? g_key : g_rkey, tok);
            Py_DECREF(tok);
            return out;
        }
        case T_KEYS:
            return make_keys(g_key, g_keys, r);
        case T_RKEYS:
            return make_keys(g_rkey, g_rkeys, r);
        case T_ITUPLE: {
            uint64_t n;
            if (!r.varint(&n)) return nullptr;
            if ((Py_ssize_t)n > r.n - r.pos) {
                PyErr_SetString(PyExc_ValueError, "truncated binary frame");
                return nullptr;
            }
            PyObject *t = PyTuple_New((Py_ssize_t)n);
            if (t == nullptr) return nullptr;
            for (Py_ssize_t i = 0; i < (Py_ssize_t)n; ++i) {
                int64_t v;
                if (!r.zigzag(&v)) { Py_DECREF(t); return nullptr; }
                PyObject *x = PyLong_FromLongLong((long long)v);
                if (x == nullptr) { Py_DECREF(t); return nullptr; }
                PyTuple_SET_ITEM(t, i, x);
            }
            return t;
        }
    }
    PyErr_Format(PyExc_ValueError, "unknown binary wire tag 0x%02x",
                 (int)tag);
    return nullptr;
}

PyObject *wire_unpack_obj(PyObject *, PyObject *args) {
    Py_buffer view;
    if (!PyArg_ParseTuple(args, "y*", &view)) return nullptr;
    if (g_ts == nullptr) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_RuntimeError,
                        "wire_unpack_obj requires wire_bind");
        return nullptr;
    }
    Reader r{(const unsigned char *)view.buf, view.len};
    PyObject *out = unpack_obj(r, 0);
    if (out != nullptr && r.pos != r.n) {
        Py_DECREF(out);
        out = nullptr;
        PyErr_SetString(PyExc_ValueError,
                        "trailing bytes after binary frame");
    }
    PyBuffer_Release(&view);
    return out;
}

PyObject *wire_unpack(PyObject *, PyObject *args) {
    Py_buffer view;
    if (!PyArg_ParseTuple(args, "y*", &view)) return nullptr;
    Reader r{(const unsigned char *)view.buf, view.len};
    PyObject *out = unpack_value(r, 0);
    if (out != nullptr && r.pos != r.n) {
        Py_DECREF(out);
        out = nullptr;
        PyErr_SetString(PyExc_ValueError,
                        "trailing bytes after binary frame");
    }
    PyBuffer_Release(&view);
    return out;
}

/* wire_bind(ts, txnid, ballot, key, rkey, keys, rkeys, enum_base,
 *           registry_provider, slots_of, py_encode)
 * Arms the raw-object packer with the primitive classes and the lazy
 * verb-registry/slots helpers.  Without a bind, pack falls back to the
 * Python structural walk for every non-tree object. */
PyObject *wire_bind(PyObject *, PyObject *args) {
    PyObject *ts, *txnid, *ballot, *key, *rkey, *keys, *rkeys, *enum_base,
        *provider, *slots_of, *py_encode;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOOO", &ts, &txnid, &ballot, &key,
                          &rkey, &keys, &rkeys, &enum_base, &provider,
                          &slots_of, &py_encode))
        return nullptr;
    Py_XDECREF(g_ts); Py_XDECREF(g_txnid); Py_XDECREF(g_ballot);
    Py_XDECREF(g_key); Py_XDECREF(g_rkey); Py_XDECREF(g_keys);
    Py_XDECREF(g_rkeys); Py_XDECREF(g_enum_base);
    Py_XDECREF(g_registry_provider); Py_XDECREF(g_slots_of);
    Py_XDECREF(g_py_encode); Py_XDECREF(g_registry);
    g_registry = nullptr;
    Py_INCREF(ts); g_ts = ts;
    Py_INCREF(txnid); g_txnid = txnid;
    Py_INCREF(ballot); g_ballot = ballot;
    Py_INCREF(key); g_key = key;
    Py_INCREF(rkey); g_rkey = rkey;
    Py_INCREF(keys); g_keys = keys;
    Py_INCREF(rkeys); g_rkeys = rkeys;
    Py_INCREF(enum_base); g_enum_base = enum_base;
    Py_INCREF(provider); g_registry_provider = provider;
    Py_INCREF(slots_of); g_slots_of = slots_of;
    Py_INCREF(py_encode); g_py_encode = py_encode;
    if (g_slots_cache == nullptr) g_slots_cache = PyDict_New();
    if (s_epoch == nullptr) {
        s_epoch = PyUnicode_InternFromString("epoch");
        s_hlc = PyUnicode_InternFromString("hlc");
        s_flags = PyUnicode_InternFromString("flags");
        s_node = PyUnicode_InternFromString("node");
        s_token = PyUnicode_InternFromString("token");
        s_keys_attr = PyUnicode_InternFromString("_keys");
        s_dict_attr = PyUnicode_InternFromString("__dict__");
        s_value_attr = PyUnicode_InternFromString("value");
        s_name_attr = PyUnicode_InternFromString("__name__");
        s_unpack_attr = PyUnicode_InternFromString("unpack");
        s_new_attr = PyUnicode_InternFromString("__new__");
        s_presorted_kw = PyUnicode_InternFromString("_presorted");
    }
    Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"wire_pack", wire_pack, METH_VARARGS,
     "pack one structural wire tree (or raw payload objects) into "
     "tagged binary"},
    {"wire_unpack", wire_unpack, METH_VARARGS,
     "unpack tagged binary into the structural wire tree"},
    {"wire_unpack_obj", wire_unpack_obj, METH_VARARGS,
     "unpack tagged binary straight into decoded frame/message objects"},
    {"wire_bind", wire_bind, METH_VARARGS,
     "bind primitive classes + registry/slots helpers for the raw-object "
     "packer"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_accord_wire",
    "native binary wire frame codec", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

extern "C" PyMODINIT_FUNC PyInit__accord_wire(void) {
    return PyModule_Create(&moduledef);
}
