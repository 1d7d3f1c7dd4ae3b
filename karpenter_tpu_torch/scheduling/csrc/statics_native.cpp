// The per-pod statics pass in native code: ``statics._build`` for a list of
// pods in one call, field for field.
//
// Each pod is worked out from its own values: nothing is keyed on the
// identity of a sub-object that pods share (containers, affinity terms,
// label selectors, dicts), and no ``_canon_key`` stash is read or written.
// The shared tables (the interning dicts, the topology-class registry) are
// the Python objects the caller passes in ``ctx``: hits are read here while
// the GIL is held; a miss calls back into the Python code that owns the
// table (``statics._intern``, ``statics._topo_code``, which holds the
// registry's lock). A pod of a shape this file does not cover (a mapping
// that is no dict, a memo of another form) is built by the Python
// ``_build`` instead, and so is a pod whose build raised here: Python then
// raises the same error, or serves.
//
// Quantities stay Python objects added with ``PyNumber_Add`` in
// ``resources.merge``'s order; every set is built in Python's insertion
// order, so iteration orders agree too.
//
// Build (see ``statics.py``): g++ -O2 -shared -fPIC -I<python include>

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#ifndef Py_T_OBJECT_EX
#include <structmember.h>
#define Py_T_OBJECT_EX T_OBJECT_EX
#endif

namespace {

// An owned reference; a null one marks a failure (an exception is set, or
// none when the pod's shape is not covered).
class Ref {
 public:
  Ref() = default;
  explicit Ref(PyObject *p) : p_(p) {}
  ~Ref() { Py_XDECREF(p_); }
  Ref(const Ref &) = delete;
  Ref &operator=(const Ref &) = delete;
  Ref(Ref &&o) noexcept : p_(o.p_) { o.p_ = nullptr; }
  Ref &operator=(Ref &&o) noexcept {
    if (this != &o) {
      Py_XDECREF(p_);
      p_ = o.p_;
      o.p_ = nullptr;
    }
    return *this;
  }
  static Ref borrow(PyObject *p) {
    Py_XINCREF(p);
    return Ref(p);
  }
  PyObject *get() const { return p_; }
  PyObject *release() {
    PyObject *r = p_;
    p_ = nullptr;
    return r;
  }
  explicit operator bool() const { return p_ != nullptr; }

 private:
  PyObject *p_ = nullptr;
};

#define TRY(x)           \
  do {                   \
    if (!(x)) return {}; \
  } while (0)

// interned attribute names and constants
PyObject *s_spec, *s_metadata, *s_node_selector, *s_affinity, *s_node_affinity,
    *s_preferred, *s_required, *s_weight, *s_preference, *s_match_expressions,
    *s_key, *s_operator, *s_values, *s_containers, *s_requests, *s_ports,
    *s_host_port, *s_host_ip, *s_protocol, *s_labels, *s_namespace,
    *s_pod_affinity, *s_pod_anti_affinity, *s_namespaces, *s_topology_key,
    *s_label_selector, *s_match_labels, *s_topology_spread_constraints,
    *s_max_skew, *s_when_unsatisfiable, *s_solve_statics, *s_requests_memo,
    *s_host_ports_memo, *s_aff_ref, *s_sel_ref, *s_sel_raw, *s_items, *s_In,
    *s_TCP, *f_zero, *f_one;
// one empty frozenset for every empty set of every pod: it is immutable
PyObject *empty_frozenset;

// PodStatics.__slots__, in the order of ``SLOTS`` below
enum Slot {
  SEL_RAW, SEL_REF, AFF_REF, CORE0, HOSTNAME0, AFF_ENTRIES, AFF_HOSTNAME,
  PINNED_AFF_HOSTNAME, REQ, REQ_KEY, EXTRA_RES, CPU, MEM, HOST_PORTS,
  LABELS_KEY, AFF_TERMS, SPREADS, TOPO_ANY, TOPO_CODE, KEY_ENTRIES,
  CONSTRAINS, MERGE_TID, REQ_TID, N_SLOTS
};
const char *const SLOTS[N_SLOTS] = {
    "sel_raw", "sel_ref", "aff_ref", "core0", "hostname0", "aff_entries",
    "aff_hostname", "pinned_aff_hostname", "req", "req_key", "extra_res",
    "cpu", "mem", "host_ports", "labels_key", "aff_terms", "spreads",
    "topo_any", "topo_code", "key_entries", "constrains", "merge_tid",
    "req_tid"};

// the slot offsets of the last PodStatics type seen
PyTypeObject *slots_type = nullptr;
Py_ssize_t slot_offset[N_SLOTS];

bool resolve_slots(PyTypeObject *type) {
  if (type == slots_type) return true;
  for (int i = 0; i < N_SLOTS; i++) {
    Ref descr(PyObject_GetAttrString((PyObject *)type, SLOTS[i]));
    if (!descr) return false;
    if (!Py_IS_TYPE(descr.get(), &PyMemberDescr_Type) ||
        ((PyMemberDescrObject *)descr.get())->d_member->type != Py_T_OBJECT_EX) {
      PyErr_Format(PyExc_TypeError, "%s is not an object slot", SLOTS[i]);
      return false;
    }
    slot_offset[i] = ((PyMemberDescrObject *)descr.get())->d_member->offset;
  }
  slots_type = type;
  return true;
}

// what ``statics.NATIVE_CTX`` holds, borrowed for one call
struct Ctx {
  PyTypeObject *statics_type;
  PyObject *build, *intern, *merge_interns, *req_interns, *topo_classes,
      *topo_code, *normalized, *ignored, *narrowed, *supported_aff, *hostname,
      *axis_index, *cpu, *memory, *pods, *wildcard_ip;
};

bool parse_ctx(PyObject *ctx, Ctx *c) {
  PyObject *type;
  if (!PyArg_ParseTuple(ctx, "OOOO!O!O!OO!OOOOO!OOOO;ctx", &type, &c->build,
                        &c->intern, &PyDict_Type, &c->merge_interns,
                        &PyDict_Type, &c->req_interns, &PyDict_Type,
                        &c->topo_classes, &c->topo_code, &PyDict_Type,
                        &c->normalized, &c->ignored, &c->narrowed,
                        &c->supported_aff, &c->hostname, &PyDict_Type,
                        &c->axis_index, &c->cpu, &c->memory, &c->pods,
                        &c->wildcard_ip))
    return false;
  if (!PyType_Check(type)) {
    PyErr_SetString(PyExc_TypeError, "ctx[0] must be the PodStatics type");
    return false;
  }
  c->statics_type = (PyTypeObject *)type;
  return resolve_slots(c->statics_type);
}

inline Ref attr(PyObject *o, PyObject *name) {
  return Ref(PyObject_GetAttr(o, name));
}

// getattr(o, name, None), without raising AttributeError on a miss
Ref attr_or_none(PyObject *o, PyObject *name) {
  PyObject *out;
#if PY_VERSION_HEX >= 0x030D0000
  int found = PyObject_GetOptionalAttr(o, name, &out);
#else
  int found = _PyObject_LookupAttr(o, name, &out);
#endif
  if (found < 0) return {};
  if (found == 0) return Ref::borrow(Py_None);
  return Ref(out);
}

// o.name = value, ignoring AttributeError (slotted or frozen objects skip
// their memos, as the Python path does)
bool set_memo(PyObject *o, PyObject *name, PyObject *value) {
  if (PyObject_SetAttr(o, name, value) == 0) return true;
  if (PyErr_ExceptionMatches(PyExc_AttributeError)) {
    PyErr_Clear();
    return true;
  }
  return false;
}

inline bool is_true(PyObject *o, bool *out) {
  int r = PyObject_IsTrue(o);
  if (r < 0) return false;
  *out = r != 0;
  return true;
}

inline bool eq(PyObject *a, PyObject *b, bool *out) {
  int r = PyObject_RichCompareBool(a, b, Py_EQ);
  if (r < 0) return false;
  *out = r != 0;
  return true;
}

inline bool contains(PyObject *container, PyObject *item, bool *out) {
  int r = PySequence_Contains(container, item);
  if (r < 0) return false;
  *out = r != 0;
  return true;
}

inline bool is_list_or_tuple(PyObject *o) {
  return PyList_CheckExact(o) || PyTuple_CheckExact(o);
}

// seq[i] of a list or tuple as an owned reference; null (no exception, so
// the pod falls back to Python) once the sequence has shrunk below i: a
// list can change under a finalizer that an allocation's collection runs
inline Ref item(PyObject *seq, Py_ssize_t i) {
  if (i >= PySequence_Fast_GET_SIZE(seq)) return {};
  return Ref::borrow(PySequence_Fast_GET_ITEM(seq, i));
}

// NORMALIZED_LABELS.get(key, key)
Ref normalize(const Ctx &c, PyObject *key) {
  PyObject *hit = PyDict_GetItemWithError(c.normalized, key);
  if (hit) return Ref::borrow(hit);
  if (PyErr_Occurred()) return {};
  return Ref::borrow(key);
}

// A tuple of strings, numbers or such tuples holds no reference cycle: the
// collector would untrack it at its first pass (as _PyTuple_MaybeUntrack
// does); untracking it now spares the young generation's passes the walk.
void untrack_if_atomic(PyObject *t) {
  for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(t); i++) {
    PyObject *e = PyTuple_GET_ITEM(t, i);
    if (PyObject_IS_GC(e) && (!PyTuple_CheckExact(e) || PyObject_GC_IsTracked(e)))
      return;
  }
  PyObject_GC_UnTrack(t);
}

// frozenset(s), or the shared empty frozenset for an empty or absent set
Ref frozen(PyObject *s) {
  if (s == nullptr || PySet_GET_SIZE(s) == 0) return Ref::borrow(empty_frozenset);
  return Ref(PyFrozenSet_New(s));
}

// tuple(sorted(d.items())) of a dict
Ref sorted_items(PyObject *d) {
  Ref out;
  if (PyDict_GET_SIZE(d) <= 1) {  // nothing to sort
    out = Ref(PyTuple_New(PyDict_GET_SIZE(d)));
    TRY(out);
    Py_ssize_t pos = 0;
    PyObject *k, *v;
    if (PyDict_Next(d, &pos, &k, &v)) {
      PyObject *item = PyTuple_Pack(2, k, v);
      TRY(item);
      PyTuple_SET_ITEM(out.get(), 0, item);
    }
  } else {
    Ref items(PyDict_Items(d));
    TRY(items);
    TRY(PyList_Sort(items.get()) == 0);
    out = Ref(PyList_AsTuple(items.get()));
    TRY(out);
  }
  for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(out.get()); i++)
    untrack_if_atomic(PyTuple_GET_ITEM(out.get(), i));
  untrack_if_atomic(out.get());
  return out;
}

// key_entries.setdefault(key, []).append(entry)
bool append_entry(PyObject *entries, PyObject *key, PyObject *entry) {
  PyObject *lst = PyDict_GetItemWithError(entries, key);
  if (!lst) {
    if (PyErr_Occurred()) return false;
    Ref fresh(PyList_New(0));
    if (!fresh || PyDict_SetItem(entries, key, fresh.get()) < 0) return false;
    lst = fresh.get();  // the dict holds it now
  }
  return PyList_Append(lst, entry) == 0;
}

// statics._selector_key, from the selector's own values
Ref selector_key(PyObject *sel) {
  if (sel == Py_None) return Ref(PyTuple_New(0));
  Ref labels = attr(sel, s_match_labels);
  TRY(labels);
  if (!PyDict_CheckExact(labels.get())) return {};
  Ref labels_key = sorted_items(labels.get());
  TRY(labels_key);
  Ref exprs = attr(sel, s_match_expressions);
  TRY(exprs);
  if (!is_list_or_tuple(exprs.get())) return {};
  Py_ssize_t n = PySequence_Fast_GET_SIZE(exprs.get());
  Ref exprs_key(PyTuple_New(n));
  TRY(exprs_key);
  for (Py_ssize_t i = 0; i < n; i++) {
    Ref e = item(exprs.get(), i);
    TRY(e);
    Ref k = attr(e.get(), s_key);
    TRY(k);
    Ref op = attr(e.get(), s_operator);
    TRY(op);
    Ref vals = attr(e.get(), s_values);
    TRY(vals);
    Ref vt(PySequence_Tuple(vals.get()));
    TRY(vt);
    PyObject *t = PyTuple_Pack(3, k.get(), op.get(), vt.get());
    TRY(t);
    PyTuple_SET_ITEM(exprs_key.get(), i, t);
    untrack_if_atomic(t);
  }
  untrack_if_atomic(exprs_key.get());
  Ref key(PyTuple_Pack(2, labels_key.get(), exprs_key.get()));
  if (key) untrack_if_atomic(key.get());
  return key;
}

// statics._intern: the table's canonical tuple, the Python code on a miss
Ref intern(const Ctx &c, PyObject *table, PyObject *key) {
  PyObject *hit = PyDict_GetItemWithError(table, key);
  if (hit) return Ref::borrow(hit);
  if (PyErr_Occurred()) return {};
  return Ref(PyObject_CallFunctionObjArgs(c.intern, table, key, nullptr));
}

// the sequence ``o.name`` as a list or tuple (a new reference), or a
// failure without an exception for any other type
Ref seq_attr(PyObject *o, PyObject *name) {
  Ref s = attr(o, name);
  TRY(s);
  if (!is_list_or_tuple(s.get())) return {};
  return s;
}

// The working state of one pod's node-selector and node-affinity fold.
struct Fold {
  Ref reqs, aff_entries, key_entries, constrains;
  Ref hostname = Ref::borrow(Py_None);
  Ref aff_hostname = Ref::borrow(Py_None);
  Ref pinned = Ref::borrow(Py_None);
};

// one folded expression: (key, operator, values) after normalization
bool fold_expression(const Ctx &c, Fold &f, PyObject *t) {
  Ref tkey = attr(t, s_key);
  if (!tkey) return false;
  Ref key = normalize(c, tkey.get());
  if (!key) return false;
  bool skip;
  if (!contains(c.ignored, key.get(), &skip)) return false;
  if (skip) return true;
  if (PySet_Add(f.constrains.get(), key.get()) < 0) return false;
  Ref op = attr(t, s_operator);
  if (!op) return false;
  Ref vals = attr(t, s_values);
  if (!vals) return false;
  Ref vt(PySequence_Tuple(vals.get()));
  if (!vt) return false;
  bool narrowed, is_host;
  if (!contains(c.narrowed, key.get(), &narrowed)) return false;
  if (narrowed) {
    Ref entry(PyTuple_Pack(2, op.get(), vt.get()));
    if (!entry || !append_entry(f.key_entries.get(), key.get(), entry.get()))
      return false;
  }
  if (!eq(key.get(), c.hostname, &is_host)) return false;
  if (is_host) {
    bool is_in;
    if (!eq(op.get(), s_In, &is_in)) return false;
    if (is_in) {
      Py_ssize_t n = PyObject_Size(vals.get());
      if (n < 0) return false;
      if (n == 1) {
        Ref v(PySequence_GetItem(vals.get(), 0));
        if (!v) return false;
        f.aff_hostname = std::move(v);
        return true;
      }
    }
  }
  Ref entry(PyTuple_Pack(3, key.get(), op.get(), vt.get()));
  return entry && PyList_Append(f.aff_entries.get(), entry.get()) == 0;
}

// constrains.add(NORMALIZED_LABELS.get(r.key, r.key)) for every expression
// of the terms; ``preference`` reads each term's ``.preference`` first
bool constrain_all(const Ctx &c, Fold &f, PyObject *terms, bool preference) {
  for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(terms); i++) {
    Ref term = item(terms, i);
    if (!term) return false;
    Ref owner = preference ? attr(term.get(), s_preference) : std::move(term);
    if (!owner) return false;
    Ref exprs = seq_attr(owner.get(), s_match_expressions);
    if (!exprs) return false;
    for (Py_ssize_t j = 0; j < PySequence_Fast_GET_SIZE(exprs.get()); j++) {
      Ref r = item(exprs.get(), j);
      if (!r) return false;
      Ref k = attr(r.get(), s_key);
      if (!k) return false;
      Ref key = normalize(c, k.get());
      if (!key || PySet_Add(f.constrains.get(), key.get()) < 0) return false;
    }
  }
  return true;
}

// list.extend(seq) of a list or tuple
inline bool extend(PyObject *lst, PyObject *seq) {
  Py_ssize_t n = PyList_GET_SIZE(lst);
  return PyList_SetSlice(lst, n, n, seq) == 0;
}

bool fold_node_affinity(const Ctx &c, Fold &f, PyObject *na) {
  Ref preferred = seq_attr(na, s_preferred);
  Ref required = seq_attr(na, s_required);
  if (!preferred || !required) return false;
  Ref folded(PyList_New(0));
  if (!folded) return false;
  Py_ssize_t n_pref = PySequence_Fast_GET_SIZE(preferred.get());
  if (n_pref > 0) {
    // max(na.preferred, key=weight): the first of the heaviest
    Ref heaviest = item(preferred.get(), 0);
    if (!heaviest) return false;
    Ref best = attr(heaviest.get(), s_weight);
    if (!best) return false;
    for (Py_ssize_t i = 1; i < n_pref; i++) {
      Ref t = item(preferred.get(), i);
      if (!t) return false;
      Ref w = attr(t.get(), s_weight);
      if (!w) return false;
      int gt = PyObject_RichCompareBool(w.get(), best.get(), Py_GT);
      if (gt < 0) return false;
      if (gt) {
        heaviest = std::move(t);
        best = std::move(w);
      }
    }
    Ref pref = attr(heaviest.get(), s_preference);
    if (!pref) return false;
    Ref exprs = seq_attr(pref.get(), s_match_expressions);
    if (!exprs || !extend(folded.get(), exprs.get())) return false;
  }
  Py_ssize_t n_req = PySequence_Fast_GET_SIZE(required.get());
  if (n_req > 0) {
    Ref first = item(required.get(), 0);
    if (!first) return false;
    Ref exprs = seq_attr(first.get(), s_match_expressions);
    if (!exprs || !extend(folded.get(), exprs.get())) return false;
  }
  for (Py_ssize_t i = 0; i < PyList_GET_SIZE(folded.get()); i++)
    if (!fold_expression(c, f, PyList_GET_ITEM(folded.get(), i))) return false;
  // the first In-len-1 hostname across ALL required terms, in order
  for (Py_ssize_t i = 0; i < n_req && f.pinned.get() == Py_None; i++) {
    Ref term = item(required.get(), i);
    if (!term) return false;
    Ref exprs = seq_attr(term.get(), s_match_expressions);
    if (!exprs) return false;
    for (Py_ssize_t j = 0; j < PySequence_Fast_GET_SIZE(exprs.get()); j++) {
      Ref r = item(exprs.get(), j);
      if (!r) return false;
      Ref k = attr(r.get(), s_key);
      if (!k) return false;
      bool hit;
      if (!eq(k.get(), c.hostname, &hit)) return false;
      if (!hit) continue;
      Ref op = attr(r.get(), s_operator);
      if (!op || !eq(op.get(), s_In, &hit)) return false;
      if (!hit) continue;
      Ref vals = attr(r.get(), s_values);
      if (!vals) return false;
      Py_ssize_t n = PyObject_Size(vals.get());
      if (n < 0) return false;
      if (n != 1) continue;
      Ref v(PySequence_GetItem(vals.get(), 0));
      if (!v) return false;
      f.pinned = std::move(v);
      break;
    }
  }
  return constrain_all(c, f, required.get(), false) &&
         constrain_all(c, f, preferred.get(), true);
}

// requests_for_pods(pod) and the (containers, dict(out)) memo it leaves
bool requests(const Ctx &c, PyObject *pod, PyObject *containers, Ref *req,
              Ref *memo) {
  Ref cached = attr_or_none(pod, s_requests_memo);
  if (!cached) return false;
  if (cached.get() != Py_None) {
    if (!PyTuple_CheckExact(cached.get()) || PyTuple_GET_SIZE(cached.get()) < 2 ||
        !PyDict_CheckExact(PyTuple_GET_ITEM(cached.get(), 1)))
      return false;
    if (PyTuple_GET_ITEM(cached.get(), 0) == containers) {
      *req = Ref(PyDict_Copy(PyTuple_GET_ITEM(cached.get(), 1)));
      return bool(*req);
    }
  }
  Ref out(PyDict_New());
  if (!out) return false;
  for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(containers); i++) {
    Ref container = item(containers, i);
    if (!container) return false;
    Ref rl = attr(container.get(), s_requests);
    if (!rl || !PyDict_CheckExact(rl.get())) return false;
    Py_ssize_t pos = 0;
    PyObject *name, *qty;
    while (PyDict_Next(rl.get(), &pos, &name, &qty)) {
      PyObject *prev = PyDict_GetItemWithError(out.get(), name);
      if (!prev && PyErr_Occurred()) return false;
      Ref sum(PyNumber_Add(prev ? prev : f_zero, qty));
      if (!sum || PyDict_SetItem(out.get(), name, sum.get()) < 0) return false;
    }
  }
  PyObject *prev = PyDict_GetItemWithError(out.get(), c.pods);
  if (!prev && PyErr_Occurred()) return false;
  Ref count(PyNumber_Add(prev ? prev : f_zero, f_one));
  if (!count || PyDict_SetItem(out.get(), c.pods, count.get()) < 0) return false;
  Ref copy(PyDict_Copy(out.get()));
  if (!copy) return false;
  *memo = Ref(PyTuple_Pack(2, containers, copy.get()));
  if (!*memo) return false;
  *req = std::move(out);
  return true;
}

// frozenset(pod.host_ports(pod)) and the (containers, frozenset) memo
bool host_ports(const Ctx &c, PyObject *pod, PyObject *containers, Ref *ports,
                Ref *memo) {
  Ref cached = attr_or_none(pod, s_host_ports_memo);
  if (!cached) return false;
  if (cached.get() != Py_None) {
    if (!PyTuple_CheckExact(cached.get()) || PyTuple_GET_SIZE(cached.get()) < 2)
      return false;
    if (PyTuple_GET_ITEM(cached.get(), 0) == containers) {
      Ref s(PySet_New(PyTuple_GET_ITEM(cached.get(), 1)));
      if (!s) return false;
      *ports = frozen(s.get());
      return bool(*ports);
    }
  }
  Ref out;  // the claims' set, made at the first claim
  for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(containers); i++) {
    Ref container = item(containers, i);
    if (!container) return false;
    Ref plist = seq_attr(container.get(), s_ports);
    if (!plist) return false;
    for (Py_ssize_t j = 0; j < PySequence_Fast_GET_SIZE(plist.get()); j++) {
      Ref port = item(plist.get(), j);
      if (!port) return false;
      Ref hp = attr(port.get(), s_host_port);
      bool claimed;
      if (!hp || !is_true(hp.get(), &claimed)) return false;
      if (!claimed) continue;
      Ref ip = attr(port.get(), s_host_ip);
      bool set;
      if (!ip || !is_true(ip.get(), &set)) return false;
      if (!set) ip = Ref::borrow(c.wildcard_ip);
      Ref proto = attr(port.get(), s_protocol);
      if (!proto || !is_true(proto.get(), &set)) return false;
      if (!set) proto = Ref::borrow(s_TCP);
      Ref claim(PyTuple_Pack(3, ip.get(), hp.get(), proto.get()));
      if (!claim) return false;
      if (!out) {
        out = Ref(PySet_New(nullptr));
        if (!out) return false;
      }
      if (PySet_Add(out.get(), claim.get()) < 0) return false;
    }
  }
  *ports = frozen(out.get());
  if (!*ports) return false;
  *memo = Ref(PyTuple_Pack(2, containers, ports->get()));
  return bool(*memo);
}

// the namespaces part of statics._affinity_key
Ref affinity_namespaces(PyObject *term, PyObject *ns) {
  Ref nss = attr(term, s_namespaces);
  TRY(nss);
  bool any;
  TRY(is_true(nss.get(), &any));
  Ref out;
  if (!any) {
    out = Ref(PyTuple_Pack(1, ns));
  } else {
    Ref lst(PySequence_List(nss.get()));
    TRY(lst);
    TRY(PyList_Sort(lst.get()) == 0);
    out = Ref(PyList_AsTuple(lst.get()));
  }
  if (out) untrack_if_atomic(out.get());
  return out;
}

// (group_key, term, anti) for the pod-(anti-)affinity terms of
// supported topology keys, appended to ``out``
bool affinity_terms(const Ctx &c, PyObject *aff, PyObject *ns, PyObject *out) {
  PyObject *const fields[2] = {s_pod_affinity, s_pod_anti_affinity};
  for (int a = 0; a < 2; a++) {
    Ref pa = attr(aff, fields[a]);
    if (!pa) return false;
    if (pa.get() == Py_None) continue;
    Ref terms = seq_attr(pa.get(), s_required);
    if (!terms) return false;
    PyObject *anti = a ? Py_True : Py_False;
    for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(terms.get()); i++) {
      Ref term = item(terms.get(), i);
      if (!term) return false;
      PyObject *t = term.get();
      Ref tk = attr(t, s_topology_key);
      bool supported;
      if (!tk || !contains(c.supported_aff, tk.get(), &supported)) return false;
      if (!supported) continue;
      Ref nss = affinity_namespaces(t, ns);
      if (!nss) return false;
      Ref sel = attr(t, s_label_selector);
      if (!sel) return false;
      Ref sk = selector_key(sel.get());
      if (!sk) return false;
      Ref key(PyTuple_Pack(4, anti, nss.get(), tk.get(), sk.get()));
      if (!key) return false;
      untrack_if_atomic(key.get());
      Ref entry(PyTuple_Pack(3, key.get(), t, anti));
      if (!entry || PyList_Append(out, entry.get()) < 0) return false;
    }
  }
  return true;
}

// tuple((group_key, c) for c in spec.topology_spread_constraints)
Ref spreads(PyObject *spec, PyObject *ns) {
  Ref cs = seq_attr(spec, s_topology_spread_constraints);
  TRY(cs);
  Py_ssize_t n = PySequence_Fast_GET_SIZE(cs.get());
  Ref out(PyTuple_New(n));
  TRY(out);
  for (Py_ssize_t i = 0; i < n; i++) {
    Ref constraint = item(cs.get(), i);
    TRY(constraint);
    PyObject *cst = constraint.get();
    Ref skew = attr(cst, s_max_skew);
    TRY(skew);
    Ref tk = attr(cst, s_topology_key);
    TRY(tk);
    Ref when = attr(cst, s_when_unsatisfiable);
    TRY(when);
    Ref sel = attr(cst, s_label_selector);
    TRY(sel);
    Ref sk = selector_key(sel.get());
    TRY(sk);
    Ref key(PyTuple_Pack(5, ns, skew.get(), tk.get(), when.get(), sk.get()));
    TRY(key);
    untrack_if_atomic(key.get());
    PyObject *entry = PyTuple_Pack(2, key.get(), cst);
    TRY(entry);
    PyTuple_SET_ITEM(out.get(), i, entry);
  }
  return out;
}

// The folded facts of one pod's node selector and node affinity.
struct Folded {
  Ref sel_raw, core0, aff_entries, key_entries, constrains;
  Ref hostname, aff_hostname, pinned;
};

// the first part of statics._build: the node selector's items, the
// selector and the node-affinity fold (the heaviest preferred term, the
// first required OR-term), the pinned hostname and the constrained keys
bool fold(const Ctx &c, PyObject *sel, PyObject *aff, Folded *out) {
  Ref na = Ref::borrow(Py_None);
  if (aff != Py_None) {
    na = attr(aff, s_node_affinity);
    TRY(na);
  }
  if (PyDict_GET_SIZE(sel) == 0 && na.get() == Py_None) {  // nothing to fold
    out->sel_raw = Ref(PyTuple_New(0));
    out->core0 = Ref(PyTuple_New(0));
    out->aff_entries = Ref(PyTuple_New(0));
    out->key_entries = Ref(PyDict_New());
    out->constrains = Ref::borrow(empty_frozenset);
    out->hostname = Ref::borrow(Py_None);
    out->aff_hostname = Ref::borrow(Py_None);
    out->pinned = Ref::borrow(Py_None);
    return out->sel_raw && out->core0 && out->aff_entries && out->key_entries;
  }
  out->sel_raw = Ref(PyTuple_New(PyDict_GET_SIZE(sel)));
  TRY(out->sel_raw);
  {
    Py_ssize_t pos = 0, i = 0;
    PyObject *k, *v;
    while (PyDict_Next(sel, &pos, &k, &v)) {
      PyObject *item = PyTuple_Pack(2, k, v);
      TRY(item);
      untrack_if_atomic(item);
      PyTuple_SET_ITEM(out->sel_raw.get(), i++, item);
    }
  }
  Fold f;
  f.reqs = Ref(PyList_New(0));
  f.aff_entries = Ref(PyList_New(0));
  f.key_entries = Ref(PyDict_New());
  f.constrains = Ref(PySet_New(nullptr));
  TRY(f.reqs && f.aff_entries && f.key_entries && f.constrains);
  for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(out->sel_raw.get()); i++) {
    PyObject *item = PyTuple_GET_ITEM(out->sel_raw.get(), i);
    PyObject *value = PyTuple_GET_ITEM(item, 1);
    Ref key = normalize(c, PyTuple_GET_ITEM(item, 0));
    TRY(key);
    bool skip, narrowed, is_host;
    TRY(contains(c.ignored, key.get(), &skip));
    if (skip) continue;
    TRY(PySet_Add(f.constrains.get(), key.get()) == 0);
    TRY(contains(c.narrowed, key.get(), &narrowed));
    Ref values(PyTuple_Pack(1, value));
    TRY(values);
    if (narrowed) {
      Ref entry(PyTuple_Pack(2, s_In, values.get()));
      TRY(entry && append_entry(f.key_entries.get(), key.get(), entry.get()));
    }
    TRY(eq(key.get(), c.hostname, &is_host));
    if (is_host) {
      f.hostname = Ref::borrow(value);
      continue;
    }
    Ref entry(PyTuple_Pack(3, key.get(), s_In, values.get()));
    TRY(entry && PyList_Append(f.reqs.get(), entry.get()) == 0);
  }
  if (na.get() != Py_None) TRY(fold_node_affinity(c, f, na.get()));
  if (f.aff_hostname.get() != Py_None)
    f.hostname = Ref::borrow(f.aff_hostname.get());
  Ref core(PySequence_Concat(f.reqs.get(), f.aff_entries.get()));
  TRY(core);
  TRY(PyList_Sort(core.get()) == 0);
  out->core0 = Ref(PyList_AsTuple(core.get()));
  TRY(out->core0);
  out->aff_entries = Ref(PyList_AsTuple(f.aff_entries.get()));
  TRY(out->aff_entries);
  out->key_entries = Ref(PyDict_New());
  TRY(out->key_entries);
  {
    Py_ssize_t pos = 0;
    PyObject *k, *v;
    while (PyDict_Next(f.key_entries.get(), &pos, &k, &v)) {
      Ref t(PyList_AsTuple(v));
      TRY(t && PyDict_SetItem(out->key_entries.get(), k, t.get()) == 0);
    }
  }
  out->constrains = frozen(f.constrains.get());
  TRY(out->constrains);
  out->hostname = std::move(f.hostname);
  out->aff_hostname = std::move(f.aff_hostname);
  out->pinned = std::move(f.pinned);
  return true;
}

// tuple(entry[0] for entry in entries)
Ref first_items(PyObject *entries) {
  Py_ssize_t n = PyTuple_GET_SIZE(entries);
  Ref out(PyTuple_New(n));
  TRY(out);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *k = PyTuple_GET_ITEM(PyTuple_GET_ITEM(entries, i), 0);
    Py_INCREF(k);
    PyTuple_SET_ITEM(out.get(), i, k);
  }
  return out;
}

// statics._build(pod) in native code; the pod's requests and host-port
// memos are set on success. A null result with no exception set: a shape
// this file does not cover.
Ref build(const Ctx &c, PyObject *pod) {
  Ref spec = attr(pod, s_spec);
  TRY(spec);
  Ref meta = attr(pod, s_metadata);
  TRY(meta);
  Ref sel = attr(spec.get(), s_node_selector);
  TRY(sel);
  if (!PyDict_CheckExact(sel.get())) return {};
  Ref aff = attr(spec.get(), s_affinity);
  TRY(aff);

  // -- canonical core + hostname (mirrors signature.pod_core_and_hostname)
  Folded f;
  TRY(fold(c, sel.get(), aff.get(), &f));

  // -- resources (the requests memo is utils.resources')
  Ref containers = seq_attr(spec.get(), s_containers);
  TRY(containers);
  Ref req, req_memo;
  TRY(requests(c, pod, containers.get(), &req, &req_memo));
  Ref req_key = sorted_items(req.get());
  TRY(req_key);
  Ref extra_res;  // made at the first name outside the reserved axes
  {
    Py_ssize_t pos = 0;
    PyObject *k, *v;
    while (PyDict_Next(req.get(), &pos, &k, &v)) {
      int axis = PyDict_Contains(c.axis_index, k);
      TRY(axis >= 0);
      if (axis) continue;
      if (!extra_res) {
        extra_res = Ref(PyFrozenSet_New(nullptr));
        TRY(extra_res);
      }
      TRY(PySet_Add(extra_res.get(), k) == 0);
    }
    if (!extra_res) extra_res = Ref::borrow(empty_frozenset);
  }
  PyObject *cpu = PyDict_GetItemWithError(req.get(), c.cpu);
  TRY(cpu || !PyErr_Occurred());
  Ref cpu_ref = Ref::borrow(cpu ? cpu : f_zero);
  PyObject *mem = PyDict_GetItemWithError(req.get(), c.memory);
  TRY(mem || !PyErr_Occurred());
  Ref mem_ref = Ref::borrow(mem ? mem : f_zero);

  Ref ports, ports_memo;
  TRY(host_ports(c, pod, containers.get(), &ports, &ports_memo));
  Ref labels = attr(meta.get(), s_labels);
  TRY(labels);
  if (!PyDict_CheckExact(labels.get())) return {};
  Ref labels_key = sorted_items(labels.get());
  TRY(labels_key);
  Ref merge_key(PyTuple_Pack(3, f.sel_raw.get(), f.aff_entries.get(),
                             f.aff_hostname.get()));
  TRY(merge_key);
  Ref merge_tid = intern(c, c.merge_interns, merge_key.get());
  TRY(merge_tid);
  Ref req_tid = intern(c, c.req_interns, req_key.get());
  TRY(req_tid);

  // -- topology group membership
  Ref ns = attr(meta.get(), s_namespace);
  TRY(ns);
  Ref terms(PyList_New(0));
  TRY(terms);
  if (aff.get() != Py_None) TRY(affinity_terms(c, aff.get(), ns.get(), terms.get()));
  Ref aff_terms(PyList_AsTuple(terms.get()));
  TRY(aff_terms);
  Ref spread = spreads(spec.get(), ns.get());
  TRY(spread);
  bool topo_any = PyTuple_GET_SIZE(aff_terms.get()) > 0 ||
                  PyTuple_GET_SIZE(spread.get()) > 0 ||
                  PySet_GET_SIZE(ports.get()) > 0;
  Ref topo_code;
  if (topo_any) {
    Ref aff_keys = first_items(aff_terms.get());
    TRY(aff_keys);
    Ref spread_keys = first_items(spread.get());
    TRY(spread_keys);
    Ref ckey(PyTuple_Pack(3, aff_keys.get(), spread_keys.get(),
                          PySet_GET_SIZE(ports.get()) > 0 ? Py_True : Py_False));
    TRY(ckey);
    PyObject *hit = PyDict_GetItemWithError(c.topo_classes, ckey.get());
    if (hit) {
      topo_code = Ref::borrow(hit);
    } else {
      TRY(!PyErr_Occurred());
      topo_code = Ref(PyObject_CallOneArg(c.topo_code, ckey.get()));
      TRY(topo_code);
    }
  } else {
    topo_code = Ref(PyLong_FromLong(0));
    TRY(topo_code);
  }

  Ref st(c.statics_type->tp_alloc(c.statics_type, 0));
  TRY(st);
  PyObject *values[N_SLOTS];
  values[SEL_RAW] = f.sel_raw.release();
  values[SEL_REF] = sel.release();
  values[AFF_REF] = aff.release();
  values[CORE0] = f.core0.release();
  values[HOSTNAME0] = f.hostname.release();
  values[AFF_ENTRIES] = f.aff_entries.release();
  values[AFF_HOSTNAME] = f.aff_hostname.release();
  values[PINNED_AFF_HOSTNAME] = f.pinned.release();
  values[REQ] = req.release();
  values[REQ_KEY] = Py_NewRef(req_tid.get());  // equal to req_key: its canonical copy
  values[EXTRA_RES] = extra_res.release();
  values[CPU] = cpu_ref.release();
  values[MEM] = mem_ref.release();
  values[HOST_PORTS] = ports.release();
  values[LABELS_KEY] = labels_key.release();
  values[AFF_TERMS] = aff_terms.release();
  values[SPREADS] = spread.release();
  values[TOPO_ANY] = Py_NewRef(topo_any ? Py_True : Py_False);
  values[TOPO_CODE] = topo_code.release();
  values[KEY_ENTRIES] = f.key_entries.release();
  values[CONSTRAINS] = f.constrains.release();
  values[MERGE_TID] = merge_tid.release();
  values[REQ_TID] = req_tid.release();
  for (int i = 0; i < N_SLOTS; i++) {
    PyObject **slot = (PyObject **)((char *)st.get() + slot_offset[i]);
    Py_XSETREF(*slot, values[i]);
  }
  if (req_memo) TRY(set_memo(pod, s_requests_memo, req_memo.get()));
  if (ports_memo) TRY(set_memo(pod, s_host_ports_memo, ports_memo.get()));
  return st;
}

// build(), or for a pod it does not cover or whose build raised an
// Exception, the Python ``_build``; ``*native`` says which served
Ref build_or_fall_back(const Ctx &c, PyObject *pod, bool *native) {
  Ref st = build(c, pod);
  *native = bool(st);
  if (st) return st;
  if (PyErr_Occurred()) {
    if (!PyErr_ExceptionMatches(PyExc_Exception)) return {};
    PyErr_Clear();
  }
  return Ref(PyObject_CallOneArg(c.build, pod));
}

// statics.statics()'s validity check: the pod's memo while its affinity
// object and its selector (by identity, else by items) are unchanged; a
// null Ref without an exception when it must be built
Ref memo_hit(PyObject *pod) {
  Ref st = attr_or_none(pod, s_solve_statics);
  TRY(st);
  if (st.get() == Py_None) return {};
  Ref spec = attr(pod, s_spec);
  TRY(spec);
  Ref aff_ref = attr(st.get(), s_aff_ref);
  TRY(aff_ref);
  Ref aff = attr(spec.get(), s_affinity);
  TRY(aff);
  if (aff_ref.get() != aff.get()) return {};
  Ref sel_ref = attr(st.get(), s_sel_ref);
  TRY(sel_ref);
  Ref sel = attr(spec.get(), s_node_selector);
  TRY(sel);
  if (sel_ref.get() == sel.get()) return st;
  Ref raw = attr(st.get(), s_sel_raw);
  TRY(raw);
  Ref items(PyObject_CallMethodNoArgs(sel.get(), s_items));
  TRY(items);
  Ref now(PySequence_Tuple(items.get()));
  TRY(now);
  bool same;
  TRY(eq(raw.get(), now.get(), &same));
  if (!same) return {};
  TRY(PyObject_SetAttr(st.get(), s_sel_ref, sel.get()) == 0);
  return st;
}

// pods between two releases of the GIL in a pass: about the interpreter's
// 5 ms switch interval of builds
constexpr Py_ssize_t YIELD_EVERY = 512;

PyObject *py_statics_pass(PyObject *, PyObject *args) {
  PyObject *pods, *ctx;
  if (!PyArg_ParseTuple(args, "OO!:statics_pass", &pods, &PyTuple_Type, &ctx))
    return nullptr;
  Ctx c;
  if (!parse_ctx(ctx, &c)) return nullptr;
  Ref seq(PySequence_Tuple(pods));  // the pods as handed over, held
  if (!seq) return nullptr;
  Py_ssize_t n = PyTuple_GET_SIZE(seq.get());
  Ref out(PyList_New(n));
  if (!out) return nullptr;
  Py_ssize_t built = 0, native = 0;
  for (Py_ssize_t i = 0; i < n; i++) {
    if (i % YIELD_EVERY == YIELD_EVERY - 1) {
      // as often as the interpreter would: other threads run, a signal
      // (an interrupt) is handled
      Py_BEGIN_ALLOW_THREADS
      Py_END_ALLOW_THREADS
      if (PyErr_CheckSignals() < 0) return nullptr;
    }
    PyObject *pod = PyTuple_GET_ITEM(seq.get(), i);
    Ref st = memo_hit(pod);
    if (!st) {
      if (PyErr_Occurred()) return nullptr;
      bool by_native;
      st = build_or_fall_back(c, pod, &by_native);
      if (!st) return nullptr;
      built++;
      native += by_native;
      if (!set_memo(pod, s_solve_statics, st.get())) return nullptr;
    }
    PyList_SET_ITEM(out.get(), i, st.release());
  }
  return Py_BuildValue("(Nnn)", out.release(), built, native);
}

PyObject *py_build(PyObject *, PyObject *args) {
  PyObject *pod, *ctx;
  if (!PyArg_ParseTuple(args, "OO!:build", &pod, &PyTuple_Type, &ctx))
    return nullptr;
  Ctx c;
  if (!parse_ctx(ctx, &c)) return nullptr;
  Ref st = build(c, pod);
  if (st) return st.release();
  if (PyErr_Occurred()) {
    if (!PyErr_ExceptionMatches(PyExc_Exception)) return nullptr;
    PyErr_Clear();
  }
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"statics_pass", py_statics_pass, METH_VARARGS,
     "statics_pass(pods, ctx) -> (statics, built, native): each pod's "
     "memoized statics, built where the memo is stale; built counts the "
     "builds, native those this module made (the rest fell back to ctx's "
     "Python build)."},
    {"build", py_build, METH_VARARGS,
     "build(pod, ctx) -> PodStatics, or None for a pod the native build does "
     "not cover (or whose build raised). Sets no statics memo."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "_statics_native",
                      "The per-pod statics pass in native code.", -1, methods,
                      nullptr, nullptr, nullptr, nullptr};

bool intern_all() {
  struct {
    PyObject **slot;
    const char *text;
  } names[] = {
      {&s_spec, "spec"}, {&s_metadata, "metadata"},
      {&s_node_selector, "node_selector"}, {&s_affinity, "affinity"},
      {&s_node_affinity, "node_affinity"}, {&s_preferred, "preferred"},
      {&s_required, "required"}, {&s_weight, "weight"},
      {&s_preference, "preference"}, {&s_match_expressions, "match_expressions"},
      {&s_key, "key"}, {&s_operator, "operator"}, {&s_values, "values"},
      {&s_containers, "containers"}, {&s_requests, "requests"},
      {&s_ports, "ports"}, {&s_host_port, "host_port"},
      {&s_host_ip, "host_ip"}, {&s_protocol, "protocol"},
      {&s_labels, "labels"}, {&s_namespace, "namespace"},
      {&s_pod_affinity, "pod_affinity"},
      {&s_pod_anti_affinity, "pod_anti_affinity"},
      {&s_namespaces, "namespaces"}, {&s_topology_key, "topology_key"},
      {&s_label_selector, "label_selector"}, {&s_match_labels, "match_labels"},
      {&s_topology_spread_constraints, "topology_spread_constraints"},
      {&s_max_skew, "max_skew"}, {&s_when_unsatisfiable, "when_unsatisfiable"},
      {&s_solve_statics, "_solve_statics"},
      {&s_requests_memo, "_requests_memo"},
      {&s_host_ports_memo, "_host_ports_memo"}, {&s_aff_ref, "aff_ref"},
      {&s_sel_ref, "sel_ref"}, {&s_sel_raw, "sel_raw"}, {&s_items, "items"},
      {&s_In, "In"}, {&s_TCP, "TCP"},
  };
  for (auto &n : names) {
    *n.slot = PyUnicode_InternFromString(n.text);
    if (!*n.slot) return false;
  }
  f_zero = PyFloat_FromDouble(0.0);
  f_one = PyFloat_FromDouble(1.0);
  empty_frozenset = PyFrozenSet_New(nullptr);
  return f_zero && f_one && empty_frozenset;
}

}  // namespace

PyMODINIT_FUNC PyInit__statics_native(void) {
  if (!intern_all()) return nullptr;
  return PyModule_Create(&module);
}
