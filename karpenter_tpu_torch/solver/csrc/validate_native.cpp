// The verdict on a decoded plan in one native pass: the invariants of
// ``TorchScheduler._validate_pack``, checked in its order, without a key
// string or a requests dict per pod.
//
// ``validate(nodes, pods, daemon, ctx)`` returns PASSED (-1) where the
// plan passes, the index of the first node that breaks an invariant, or
// UNDECIDED (-2) where this pass cannot prove what the Python loop would
// say. The caller runs the Python loop on any return but PASSED, so a
// violation is worded there, and a shape this file does not cover is
// judged there.
//
// Keys. ``pod.key`` is ``f"{namespace}/{name}"``. Placements are matched
// to the batch by object identity, which gives the keys' verdict once the
// placed pods' keys are shown unique: each an exact ``Pod`` whose metadata
// is an exact ``ObjectMeta`` with exact ``str`` namespace and name, no two
// (namespace, name) pairs equal, and no namespace holding "/" (only then
// could two pairs give one key). A
// repeated batch object, a placed pod from outside the batch, or a shape
// not covered is UNDECIDED; a pod placed twice, or a key met twice, is a
// violation at its node. Each placed pod's objects are read once.
//
// Requests. Each placed pod's requests are ``resources.requests_for_pods``'
// for one pod: the ``_requests_memo`` dict where its token is the pod's
// containers list, else the containers' ``requests`` summed in order and
// ``pods`` 1.0 added. A node's totals are ``resources.merge(daemon,
// *requests)``: one double per resource name, added in the same order from
// 0.0. ``resources.fits``' rule is ``round(q * 1000) <= round(t * 1000)``
// with round half to even (``nearbyint`` in the default rounding mode) and
// a name missing from an option counting 0. A quantity that is not an
// exact float or int, or a rounded value that is not finite (where Python's
// ``round`` raises), is UNDECIDED. Nothing is cached between calls, and
// nothing is keyed on an object that pods share.
//
// Build (see ``solver/validate.py``): g++ -O2 -shared -fPIC -I<python include>

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <utility>
#include <vector>

namespace {

constexpr long PASSED = -1, UNDECIDED = -2;

// An owned reference; null after a failed call.
class Ref {
 public:
  Ref() = default;
  explicit Ref(PyObject *p) : p_(p) {}
  ~Ref() { Py_XDECREF(p_); }
  Ref(const Ref &) = delete;
  Ref &operator=(const Ref &) = delete;
  PyObject *get() const { return p_; }
  explicit operator bool() const { return p_ != nullptr; }

 private:
  PyObject *p_ = nullptr;
};

// interned attribute names
PyObject *s_metadata, *s_namespace, *s_name, *s_spec, *s_containers,
    *s_requests, *s_requests_memo, *s_pods, *s_instance_type_options,
    *s_resources;

// o.name, or None where o has no such attribute (``getattr(o, name, None)``)
Ref attr_or_none(PyObject *o, PyObject *name) {
  PyObject *out;
#if PY_VERSION_HEX >= 0x030D0000
  int found = PyObject_GetOptionalAttr(o, name, &out);
#else
  int found = _PyObject_LookupAttr(o, name, &out);
#endif
  if (found < 0) return {};
  if (found == 0) {
    Py_INCREF(Py_None);
    return Ref(Py_None);
  }
  return Ref(out);
}

// what ``solver/validate.py``'s ``CTX`` holds, borrowed for one call
struct Ctx {
  PyTypeObject *pod_type, *meta_type, *spec_type;
  PyObject *pods_name;  // the name ``requests_for_pods`` counts a pod under
};

bool is_seq(PyObject *o) { return PyList_CheckExact(o) || PyTuple_CheckExact(o); }

// a quantity as Python's float arithmetic reads it
bool number(PyObject *q, double *out) {
  if (PyFloat_CheckExact(q)) {
    *out = PyFloat_AS_DOUBLE(q);
    return true;
  }
  if (PyLong_CheckExact(q)) {
    *out = PyLong_AsDouble(q);
    return !(*out == -1.0 && PyErr_Occurred());
  }
  return false;
}

// ``round(q * 1000.0)`` where it is finite
bool milli(double q, double *out) {
  *out = std::nearbyint(q * 1000.0);
  return std::isfinite(*out);
}

uint64_t mix(uint64_t h) {
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdULL;
  h ^= h >> 33;
  return h;
}

size_t table_size(size_t n) {
  size_t cap = 16;
  while (cap < 2 * n) cap <<= 1;
  return cap;
}

// The batch's pods by identity, open addressing; ``placed`` marks the
// pods the walk of the plan has met.
class Batch {
 public:
  explicit Batch(size_t n) : keys_(table_size(n), nullptr), placed_(keys_.size(), 0) {}

  // false where ``pod`` is in already
  bool insert(PyObject *pod) {
    size_t i = probe(pod);
    if (keys_[i] == pod) return false;
    keys_[i] = pod;
    return true;
  }

  // -1 a stranger, 0 first placement, 1 placed before
  int place(PyObject *pod) {
    size_t i = probe(pod);
    if (keys_[i] != pod) return -1;
    if (placed_[i]) return 1;
    placed_[i] = 1;
    return 0;
  }

 private:
  size_t probe(PyObject *pod) const {
    size_t mask = keys_.size() - 1, i = mix((uintptr_t)pod) & mask;
    while (keys_[i] != nullptr && keys_[i] != pod) i = (i + 1) & mask;
    return i;
  }
  std::vector<PyObject *> keys_;
  std::vector<uint8_t> placed_;
};

// The placed pods' (namespace, name) pairs, to show them unique, and the
// first placement (in the loop's order) whose key an earlier one has. The
// strings are borrowed from the pods' metadata, which outlives the call.
class Keys {
 public:
  explicit Keys(size_t n) : slots_(table_size(n), 0), ns_(n), name_(n) {}

  static constexpr size_t NONE = SIZE_MAX;
  size_t first_repeat = NONE;  // the loop's "assigned to more than one node"

  // the key of placement ``row``; false on an error
  bool insert(PyObject *ns, PyObject *name, size_t row) {
    Py_hash_t hn = PyObject_Hash(ns), hm = PyObject_Hash(name);
    if (hn == -1 || hm == -1) return false;
    ns_[row] = ns;
    name_[row] = name;
    // a slot holds the hash's high half and the row + 1 (0: empty)
    uint64_t h = mix((uint64_t)hn * 1000003ULL ^ (uint64_t)hm), tag = h >> 32 << 32;
    size_t mask = slots_.size() - 1;
    for (size_t i = h & mask;; i = (i + 1) & mask) {
      uint64_t &s = slots_[i];
      if (s == 0) {
        s = tag | (row + 1);
        return true;
      }
      if ((s & ~LOW) != tag) continue;
      size_t other = (s & LOW) - 1;
      int eq = PyUnicode_Compare(ns_[other], ns) == 0 && PyUnicode_Compare(name_[other], name) == 0;
      if (PyErr_Occurred()) return false;
      if (eq) {
        // rows come in any order: the slot keeps the key's earliest row, so
        // the least row recorded here is each key's second in the loop's order
        first_repeat = std::min(first_repeat, std::max(other, row));
        if (row < other) s = tag | (row + 1);
        return true;
      }
    }
  }

 private:
  static constexpr uint64_t LOW = 0xffffffffULL;
  std::vector<uint64_t> slots_;
  std::vector<PyObject *> ns_, name_;
};

// New references held until the end of a call.
class Held {
 public:
  explicit Held(size_t n) { refs_.reserve(n); }
  ~Held() {
    for (PyObject *o : refs_) Py_DECREF(o);
  }
  // ``o`` (a new reference or null), held; null where it is null
  PyObject *hold(PyObject *o) {
    if (o != nullptr) refs_.push_back(o);
    return o;
  }

 private:
  std::vector<PyObject *> refs_;
};

// Resource names met in this call, one slot each; each placement's
// requests as (slot, quantity) items; a node's totals over the slots.
class Totals {
 public:
  explicit Totals(size_t rows) : rows_(rows) { items_.reserve(4 * rows); }
  ~Totals() {
    for (PyObject *n : names_) Py_DECREF(n);
  }

  // the slot of ``name`` (an exact str), -1 where it is none or on error
  long slot(PyObject *name) {
    for (size_t i = 0; i < names_.size(); i++)
      if (names_[i] == name) return (long)i;
    if (!PyUnicode_CheckExact(name)) return -1;
    for (size_t i = 0; i < names_.size(); i++) {
      int c = PyUnicode_Compare(names_[i], name);
      if (c == 0) return (long)i;
      if (c == -1 && PyErr_Occurred()) return -1;
    }
    Py_INCREF(name);
    names_.push_back(name);
    node_.push_back(0.0);
    in_node_.push_back(0);
    pod_.push_back(0.0);
    in_pod_.push_back(0);
    return (long)names_.size() - 1;
  }

  // ``requests_for_pods(pod)``'s items, kept as placement ``row``'s, from
  // the pod's spec and its ``_requests_memo`` (None where it has none)
  bool read(PyObject *spec, PyObject *cached, PyObject *pods_name, size_t row) {
    Ref containers(PyObject_GetAttr(spec, s_containers));
    if (!containers) return false;
    rows_[row].first = (uint32_t)items_.size();
    if (cached != Py_None) {
      if (!PyTuple_CheckExact(cached) || PyTuple_GET_SIZE(cached) < 2 ||
          !PyDict_CheckExact(PyTuple_GET_ITEM(cached, 1)))
        return false;
      if (PyTuple_GET_ITEM(cached, 0) == containers.get()) {
        // ``dict(cached[1])``: its quantities as they are
        Py_ssize_t pos = 0;
        PyObject *name, *qty;
        while (PyDict_Next(PyTuple_GET_ITEM(cached, 1), &pos, &name, &qty)) {
          double q;
          long s = slot(name);
          if (s < 0 || !number(qty, &q)) return false;
          items_.push_back({s, q});
        }
        rows_[row].end = (uint32_t)items_.size();
        return true;
      }
    }
    // ``merge`` over the containers' requests, then ``pods`` + 1.0
    if (!is_seq(containers.get())) return false;
    for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(containers.get()); i++) {
      Ref rl(PyObject_GetAttr(PySequence_Fast_GET_ITEM(containers.get(), i), s_requests));
      if (!rl || !PyDict_CheckExact(rl.get())) return false;
      Py_ssize_t pos = 0;
      PyObject *name, *qty;
      while (PyDict_Next(rl.get(), &pos, &name, &qty)) {
        double q;
        long s = slot(name);
        if (s < 0 || !number(qty, &q)) return false;
        add_pod(s, q);
      }
    }
    long s = slot(pods_name);
    if (s < 0) return false;
    add_pod(s, 1.0);
    for (long t : touched_) {
      items_.push_back({t, pod_[t]});
      in_pod_[t] = 0;
    }
    touched_.clear();
    rows_[row].end = (uint32_t)items_.size();
    return true;
  }

  // ``merge(daemon, *requests of rows [begin, end))`` as the node's totals
  bool node(PyObject *daemon, size_t begin, size_t end) {
    for (size_t i = 0; i < names_.size(); i++) in_node_[i] = 0;
    Py_ssize_t pos = 0;
    PyObject *name, *qty;
    while (PyDict_Next(daemon, &pos, &name, &qty)) {
      double q;
      long s = slot(name);
      if (s < 0 || !number(qty, &q)) return false;
      add_node(s, q);
    }
    for (size_t r = begin; r < end; r++)
      for (uint32_t k = rows_[r].first; k < rows_[r].end; k++)
        add_node(items_[k].slot, items_[k].qty);
    return true;
  }

  // ``any(fits(totals, it.resources) for it in options)``: 1, 0, or -1
  // where Python's ``round`` could raise or a shape is not covered. Every
  // name of every option tried is read, so nothing Python reads is skipped.
  int fits_any(PyObject *options) {
    want_.clear();
    live_.clear();
    for (size_t i = 0; i < names_.size(); i++) {
      if (!in_node_[i]) continue;
      double m;
      if (!milli(node_[i], &m)) return -1;
      want_.push_back(m);
      live_.push_back((long)i);
    }
    for (Py_ssize_t o = 0; o < PySequence_Fast_GET_SIZE(options); o++) {
      Ref rl(PyObject_GetAttr(PySequence_Fast_GET_ITEM(options, o), s_resources));
      if (!rl || !PyDict_CheckExact(rl.get())) return -1;
      bool ok = true;
      for (size_t k = 0; k < live_.size(); k++) {
        PyObject *q = PyDict_GetItemWithError(rl.get(), names_[live_[k]]);
        double have = 0.0, m;
        if (q == nullptr && PyErr_Occurred()) return -1;
        if (q != nullptr && !number(q, &have)) return -1;
        if (!milli(have, &m)) return -1;
        ok = ok && want_[k] <= m;
      }
      if (ok) return 1;
    }
    return 0;
  }

 private:
  // totals.get(name, 0.0) + qty, as ``merge`` adds
  void add_pod(long s, double q) {
    if (!in_pod_[s]) touched_.push_back(s);
    pod_[s] = (in_pod_[s] ? pod_[s] : 0.0) + q;
    in_pod_[s] = 1;
  }
  void add_node(long s, double q) {
    node_[s] = (in_node_[s] ? node_[s] : 0.0) + q;
    in_node_[s] = 1;
  }

  struct Item {
    long slot;
    double qty;
  };
  struct Row {
    uint32_t first = 0, end = 0;
  };
  std::vector<PyObject *> names_;
  std::vector<double> node_, pod_, want_;
  std::vector<uint8_t> in_node_, in_pod_;
  std::vector<long> touched_, live_;
  std::vector<Item> items_;
  std::vector<Row> rows_;
};

// Placement ``row``'s key, from its metadata, into ``keys``; false where it
// is undecided. ``clean_ns`` is the last namespace seen without "/".
bool placed_key(PyObject *meta, size_t row, Keys &keys, PyObject **clean_ns) {
  Ref ns(PyObject_GetAttr(meta, s_namespace));
  Ref name(PyObject_GetAttr(meta, s_name));
  if (!ns || !name || !PyUnicode_CheckExact(ns.get()) || !PyUnicode_CheckExact(name.get()))
    return false;
  if (ns.get() != *clean_ns) {
    // -1: no "/"; an index, or -2 on an error, is undecided
    if (PyUnicode_FindChar(ns.get(), '/', 0, PyUnicode_GET_LENGTH(ns.get()), 1) != -1)
      return false;
    *clean_ns = ns.get();
  }
  return keys.insert(ns.get(), name.get(), row);
}

// A placed pod's parts, borrowed: a pod, its metadata and its spec of the
// exact dataclass types hold their attributes as plain values in their
// dicts, which no code run during the call can change.
struct Parts {
  PyObject *meta, *spec, *memo;  // memo: the tuple, or None
};

// ``o.name`` borrowed, where ``o`` holds it; null on an error
PyObject *borrow(PyObject *o, PyObject *name, PyTypeObject *type) {
  PyObject *v = PyObject_GetAttr(o, name);
  if (v == nullptr) return nullptr;
  Py_DECREF(v);
  return (type == nullptr || Py_TYPE(v) == type) ? v : nullptr;
}

// The verdict, or UNDECIDED with or without an exception set.
//
// 1. The walk, in the loop's order: each placement must be a batch object
//    (else undecided); the first met twice ends the walk at its node.
// 2. Each placement's key and requests, read in the order of the pods'
//    addresses (pods sorted for the solve lie scattered in memory, and
//    address order lets the host's caches read them as they were made), in
//    two sweeps: the pods, then their metadata, specs and memos. Each sweep
//    reads objects of one depth, so the reads of one row do not wait on
//    the row before.
// 3. Node by node, in the loop's order: a repeated placement or key, no
//    options, or totals that fit no option is a violation at that node.
//
// A placement's key, one no earlier placement has, is in the batch's keys
// and not yet in the loop's ``seen``; the keys of batch pods left unplaced
// never change the loop's verdict.
long verdict(PyObject *nodes, PyObject *pods, PyObject *daemon, const Ctx &c) {
  if (!is_seq(nodes) || !is_seq(pods) || !PyDict_CheckExact(daemon)) return UNDECIDED;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(pods), n_nodes = PySequence_Fast_GET_SIZE(nodes);
  Batch batch(n);
  for (Py_ssize_t i = 0; i < n; i++)
    if (!batch.insert(PySequence_Fast_GET_ITEM(pods, i))) return UNDECIDED;

  Held lists(n_nodes);  // each node's ``pods``
  std::vector<PyObject *> placed;
  std::vector<size_t> node_end;  // node i's placements are rows [end[i-1], end[i])
  Py_ssize_t twice = -1;         // the node of the first pod placed twice
  placed.reserve(n);
  for (Py_ssize_t i = 0; i < n_nodes && twice < 0; i++) {
    PyObject *list = lists.hold(PyObject_GetAttr(PySequence_Fast_GET_ITEM(nodes, i), s_pods));
    if (!list || !is_seq(list)) return UNDECIDED;
    for (Py_ssize_t j = 0; j < PySequence_Fast_GET_SIZE(list); j++) {
      PyObject *pod = PySequence_Fast_GET_ITEM(list, j);
      int seen = batch.place(pod);
      if (seen < 0) return UNDECIDED;
      if (seen > 0) {
        twice = i;
        break;
      }
      placed.push_back(pod);
    }
    node_end.push_back(placed.size());
  }

  std::vector<std::pair<uintptr_t, size_t>> by_address(placed.size());
  for (size_t r = 0; r < placed.size(); r++) by_address[r] = {(uintptr_t)placed[r], r};
  std::sort(by_address.begin(), by_address.end());
  size_t rows = by_address.size();
  std::vector<Parts> parts(rows);
  for (size_t k = 0; k < rows; k++) {
    PyObject *pod = (PyObject *)by_address[k].first;
    if (Py_TYPE(pod) != c.pod_type) return UNDECIDED;
    Ref memo = attr_or_none(pod, s_requests_memo);
    Parts &p = parts[k];
    p = {borrow(pod, s_metadata, c.meta_type), borrow(pod, s_spec, c.spec_type), memo.get()};
    if (!p.meta || !p.spec || !p.memo) return UNDECIDED;
  }
  Keys keys(rows);
  PyObject *clean_ns = nullptr;
  Totals t(rows);
  for (size_t k = 0; k < rows; k++) {
    size_t row = by_address[k].second;
    if (!placed_key(parts[k].meta, row, keys, &clean_ns) ||
        !t.read(parts[k].spec, parts[k].memo, c.pods_name, row))
      return UNDECIDED;
  }
  Py_ssize_t repeat = -1;  // the node of the first placement whose key an earlier one has
  if (keys.first_repeat != Keys::NONE)
    repeat = std::upper_bound(node_end.begin(), node_end.end(), keys.first_repeat) -
             node_end.begin();

  for (Py_ssize_t i = 0; i < (Py_ssize_t)node_end.size(); i++) {
    if (i == twice || i == repeat) return i;
    Ref options(PyObject_GetAttr(PySequence_Fast_GET_ITEM(nodes, i), s_instance_type_options));
    if (!options || !is_seq(options.get())) return UNDECIDED;
    if (PySequence_Fast_GET_SIZE(options.get()) == 0) return i;
    if (!t.node(daemon, i ? node_end[i - 1] : 0, node_end[i])) return UNDECIDED;
    int fit = t.fits_any(options.get());
    if (fit < 0) return UNDECIDED;
    if (fit == 0) return i;
  }
  return PASSED;
}

PyObject *py_validate(PyObject *, PyObject *args) {
  PyObject *nodes, *pods, *daemon, *pod_type, *meta_type, *spec_type;
  Ctx c;
  if (!PyArg_ParseTuple(args, "OOO(O!O!O!U):validate", &nodes, &pods, &daemon, &PyType_Type,
                        &pod_type, &PyType_Type, &meta_type, &PyType_Type, &spec_type,
                        &c.pods_name))
    return nullptr;
  c.pod_type = (PyTypeObject *)pod_type;
  c.meta_type = (PyTypeObject *)meta_type;
  c.spec_type = (PyTypeObject *)spec_type;
  long v = verdict(nodes, pods, daemon, c);
  if (PyErr_Occurred()) {
    // the Python loop meets the same error, or judges the plan
    if (!PyErr_ExceptionMatches(PyExc_Exception)) return nullptr;
    PyErr_Clear();
    v = UNDECIDED;
  }
  return PyLong_FromLong(v);
}

PyMethodDef methods[] = {
    {"validate", py_validate, METH_VARARGS,
     "validate(nodes, pods, daemon, (Pod, ObjectMeta, PodSpec, PODS)) -> int: -1 where the plan "
     "passes _validate_pack's invariants, the index of the first node that "
     "breaks one, or -2 where this pass cannot decide."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "_validate_native",
                      "The verdict on a decoded plan in native code.", -1, methods,
                      nullptr, nullptr, nullptr, nullptr};

bool intern_all() {
  struct {
    PyObject **slot;
    const char *text;
  } names[] = {
      {&s_metadata, "metadata"}, {&s_namespace, "namespace"}, {&s_name, "name"},
      {&s_spec, "spec"}, {&s_containers, "containers"}, {&s_requests, "requests"},
      {&s_requests_memo, "_requests_memo"}, {&s_pods, "pods"},
      {&s_instance_type_options, "instance_type_options"}, {&s_resources, "resources"},
  };
  for (auto &n : names) {
    *n.slot = PyUnicode_InternFromString(n.text);
    if (!*n.slot) return false;
  }
  return true;
}

}  // namespace

PyMODINIT_FUNC PyInit__validate_native(void) {
  if (!intern_all()) return nullptr;
  return PyModule_Create(&module);
}
