// Native parametric-ZX reduction engine.
//
// C++ port of the paramSafe rewrite system in tsim_tpu_torch/zx/{rules,simplify}.py
// (the TPU-era replacement for the reference's pyzx-param dependency, see
// reference SURVEY.md section 2.1 row 2). The graph arrives serialized as a
// flat int64/double stream, is reduced to a fixpoint with exact symbolic
// scalar tracking, and is serialized back. Any construct outside the engine's
// scope sets an error code and the Python caller falls back to the Python
// implementation (the graph is only replaced on status 0).
//
// Semantics are rule-for-rule identical to the Python engine; every rule is
// tensor-exact (validated by the oracle fuzz tests in tests/unit/zx and the
// native-vs-python differential tests).

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <iterator>
#include <map>
#include <utility>
#include <vector>

typedef int64_t i64;
typedef int32_t i32;
typedef __int128 i128;

namespace {

constexpr int BOUNDARY = 0, ZV = 1, XV = 2;
constexpr int SIMPLE = 1, HADAMARD = 2;
constexpr double PI = 3.14159265358979323846;

// Per-call error flag (single-threaded use; the Python side holds a lock).
static int g_err = 0;
static void fail(int code) {
  if (!g_err) g_err = code;
}

// ---------------------------------------------------------------- fractions
static i64 gcd64(i64 a, i64 b) {
  if (a < 0) a = -a;
  if (b < 0) b = -b;
  while (b) {
    i64 t = a % b;
    a = b;
    b = t;
  }
  return a;
}

struct Frac {
  i64 n = 0, d = 1;  // reduced, d > 0
};

static const i64 LIM = (i64)1 << 62;

static Frac frac_make(i128 n, i128 d) {
  if (d == 0) {
    fail(2);
    return Frac{0, 1};
  }
  if (d < 0) {
    n = -n;
    d = -d;
  }
  // Reduce with gcd on magnitudes that fit after reduction.
  i128 a = n < 0 ? -n : n, b = d;
  while (b) {
    i128 t = a % b;
    a = b;
    b = t;
  }
  if (a > 1) {
    n /= a;
    d /= a;
  }
  if (n >= (i128)LIM || n <= -(i128)LIM || d >= (i128)LIM) {
    fail(3);
    return Frac{0, 1};
  }
  return Frac{(i64)n, (i64)d};
}

// Canonicalize into [0, 2) (phases are defined mod 2).
static Frac frac_mod2(Frac f) {
  i128 two_d = (i128)2 * f.d;
  i128 n = (i128)f.n % two_d;
  if (n < 0) n += two_d;
  return frac_make(n, f.d);
}

static Frac frac_add(Frac a, Frac b) {
  return frac_mod2(frac_make((i128)a.n * b.d + (i128)b.n * a.d, (i128)a.d * b.d));
}

static Frac frac_neg_mod2(Frac a) { return frac_mod2(Frac{-a.n, a.d}); }

static bool frac_is(Frac a, i64 n, i64 d) {
  // both sides reduced & canonical
  Frac c = frac_make(n, d);
  return a.n == c.n && a.d == c.d;
}

static bool frac_zero(Frac a) { return a.n == 0; }

// int(p * 4) % 8 for p with denominator dividing 4 and p in [0, 2).
static int eighth_turns(Frac p) { return (int)(((i128)p.n * 4 / p.d) % 8); }

// --------------------------------------------------------------- param sets
typedef std::vector<i32> PSet;  // sorted, unique; id 0 is the "1" sentinel

static PSet pset_xor(const PSet& a, const PSet& b) {
  PSet out;
  out.reserve(a.size() + b.size());
  std::set_symmetric_difference(a.begin(), a.end(), b.begin(), b.end(),
                                std::back_inserter(out));
  return out;
}

static bool pset_has_one(const PSet& a) {
  return !a.empty() && a.front() == 0;
}

static PSet pset_drop_one(PSet a) {
  if (pset_has_one(a)) a.erase(a.begin());
  return a;
}

static PSet pset_with_one(PSet a) {
  if (!pset_has_one(a)) a.insert(a.begin(), 0);
  return a;
}

// ------------------------------------------------------------------- scalar
struct Dyadic {
  i64 a = 1, b = 0, c = 0, d = 0;  // a + b w + c i + d w^3, w = e^{i pi/4}
};

static Dyadic dy_mul(const Dyadic& x, const Dyadic& y) {
  return Dyadic{
      x.a * y.a - x.b * y.d - x.c * y.c - x.d * y.b,
      x.a * y.b + x.b * y.a - x.c * y.d - x.d * y.c,
      x.a * y.c + x.b * y.b + x.c * y.a - x.d * y.d,
      x.a * y.d + x.b * y.c + x.c * y.b + x.d * y.a,
  };
}

static bool dy_zero(const Dyadic& x) {
  return x.a == 0 && x.b == 0 && x.c == 0 && x.d == 0;
}

static Dyadic dy_omega_pow(int k) {
  Dyadic out;
  k = ((k % 8) + 8) % 8;
  for (int i = 0; i < k; ++i) out = Dyadic{-out.d, out.a, out.b, out.c};
  return out;
}

static Dyadic one_plus_omega(int k) {
  Dyadic d = dy_omega_pow(k);
  d.a += 1;
  return d;
}

struct PhasePairT {
  int alpha, beta;
  PSet A, B;
};

struct Scalar {
  i64 power2 = 0;
  Frac phase;  // e^{i pi phase}
  Dyadic ff;
  std::complex<double> approx{1.0, 0.0};
  bool is_zero = false;
  PSet pivars;
  std::vector<std::pair<int, PSet>> halfpi;  // (j in {1,3}, set)
  std::vector<std::pair<PSet, PSet>> pipairs;
  std::vector<std::pair<Frac, PSet>> nodes;
  std::vector<PhasePairT> pairs;

  void add_power(i64 p) { power2 += p; }
  void add_phase(Frac a) { phase = frac_add(phase, a); }
  void add_phase_int(i64 k) { phase = frac_add(phase, Frac{k, 1}); }
  void set_zero() { is_zero = true; }

  void mul_dyadic(const Dyadic& d) {
    ff = dy_mul(ff, d);
    if (dy_zero(ff)) set_zero();
  }

  void mul_float(std::complex<double> z) {
    approx *= z;
    if (std::abs(approx) < 1e-300) set_zero();
  }

  void add_pi_var(PSet params) {
    if (pset_has_one(params)) {
      add_phase_int(1);
      params = pset_drop_one(params);
    }
    if (!params.empty()) pipairs.emplace_back(params, PSet{0});
  }

  void add_halfpi(int j, PSet params) {
    params = pset_drop_one(params);
    j = ((j % 4) + 4) % 4;
    if (j == 0 || params.empty()) return;
    if (j == 2) {
      add_pi_var(params);
      return;
    }
    halfpi.emplace_back(j, params);
  }

  void add_pi_pair(PSet psi, PSet phi) {
    if (psi.empty() || phi.empty()) return;
    if (psi.size() == 1 && psi[0] == 0) {
      add_pi_var(phi);
      return;
    }
    if (phi.size() == 1 && phi[0] == 0) {
      add_pi_var(psi);
      return;
    }
    pipairs.emplace_back(psi, phi);
  }

  void add_node(Frac ph, PSet params) {
    ph = frac_mod2(ph);
    if (pset_has_one(params)) {
      ph = frac_add(ph, Frac{1, 1});
      params = pset_drop_one(params);
    }
    if (params.empty()) {
      if (frac_is(ph, 1, 1)) {
        set_zero();
        return;
      }
      if (ph.d == 1 || ph.d == 2 || ph.d == 4) {
        mul_dyadic(one_plus_omega(eighth_turns(ph)));
      } else {
        double a = PI * (double)ph.n / (double)ph.d;
        mul_float(std::complex<double>(1.0, 0.0) +
                  std::complex<double>(std::cos(a), std::sin(a)));
      }
      return;
    }
    if (ph.d == 1) {
      // Projector node 1 + (-1)^(ph + parity): a duplicate collapses to a
      // factor 2, the opposite-phase node on the same parity annihilates
      // (mirrors Scalar.add_node in zx/scalar.py).
      for (const auto& [ph2, vs2] : nodes) {
        if (ph2.d != 1 || vs2 != params) continue;
        if (((ph2.n - ph.n) % 2 + 2) % 2 == 0) {
          add_power(2);
        } else {
          set_zero();
        }
        return;
      }
    }
    nodes.emplace_back(ph, params);
  }

  void add_phase_pair(int a8, int b8, PSet pa, PSet pb) {
    pairs.push_back(PhasePairT{((a8 % 8) + 8) % 8, ((b8 % 8) + 8) % 8,
                               pset_drop_one(pa), pset_drop_one(pb)});
  }
};

// -------------------------------------------------------------------- graph
struct Vert {
  bool alive = false;
  uint8_t ty = ZV;
  Frac ph;
  PSet par;
  double q = -1, r = -1;
  std::vector<std::pair<i32, uint8_t>> adj;  // (neighbor, edge type), in order
};

struct Graph {
  std::vector<Vert> vs;
  std::vector<char> bnd;  // boundary-registered flag per id
  std::vector<i32> inputs, outputs;
  Scalar sc;

  int add_vertex(uint8_t ty, double q, double r, Frac ph = Frac{0, 1},
                 PSet par = {}) {
    vs.push_back(Vert{true, ty, frac_mod2(ph), std::move(par), q, r, {}});
    bnd.push_back(0);
    return (int)vs.size() - 1;
  }

  bool alive(int v) const { return v >= 0 && v < (int)vs.size() && vs[v].alive; }
  int degree(int v) const { return (int)vs[v].adj.size(); }
  bool is_b(int v) const { return bnd[v] != 0; }

  int adj_index(int u, int v) const {
    const auto& a = vs[u].adj;
    for (int i = 0; i < (int)a.size(); ++i)
      if (a[i].first == v) return i;
    return -1;
  }

  bool connected(int u, int v) const { return adj_index(u, v) >= 0; }

  int edge_type(int u, int v) const {
    int i = adj_index(u, v);
    return i < 0 ? 0 : vs[u].adj[i].second;
  }

  void add_edge(int u, int v, uint8_t ty) {
    // overwrite semantics, matching ZXGraph.add_edge
    int i = adj_index(u, v);
    if (i >= 0) {
      vs[u].adj[i].second = ty;
      vs[v].adj[adj_index(v, u)].second = ty;
    } else {
      vs[u].adj.emplace_back(v, ty);
      vs[v].adj.emplace_back(u, ty);
    }
  }

  void set_edge_type(int u, int v, uint8_t ty) { add_edge(u, v, ty); }

  void remove_edge(int u, int v) {
    int i = adj_index(u, v);
    if (i < 0) {
      fail(4);
      return;
    }
    vs[u].adj.erase(vs[u].adj.begin() + i);
    vs[v].adj.erase(vs[v].adj.begin() + adj_index(v, u));
  }

  void remove_vertex(int v) {
    for (auto& [n, t] : vs[v].adj) {
      auto& a = vs[n].adj;
      a.erase(a.begin() + adj_index(n, v));
    }
    vs[v].adj.clear();
    vs[v].alive = false;
    vs[v].par.clear();
    if (is_b(v)) {
      inputs.erase(std::remove(inputs.begin(), inputs.end(), v), inputs.end());
      outputs.erase(std::remove(outputs.begin(), outputs.end(), v),
                    outputs.end());
      bnd[v] = 0;
    }
  }

  void add_to_phase(int v, Frac p) { vs[v].ph = frac_add(vs[v].ph, p); }
  void add_to_phase_int(int v, i64 k) { add_to_phase(v, Frac{k, 1}); }
  void xor_params(int v, const PSet& p) { vs[v].par = pset_xor(vs[v].par, p); }

  int num_edges() const {
    int e = 0;
    for (const auto& v : vs)
      if (v.alive) e += (int)v.adj.size();
    return e / 2;
  }

  int num_vertices() const {
    int n = 0;
    for (const auto& v : vs) n += v.alive ? 1 : 0;
    return n;
  }

  std::vector<int> vertex_ids() const {
    std::vector<int> out;
    out.reserve(vs.size());
    for (int v = 0; v < (int)vs.size(); ++v)
      if (vs[v].alive) out.push_back(v);
    return out;
  }

  std::vector<int> neighbor_ids(int v) const {
    std::vector<int> out;
    out.reserve(vs[v].adj.size());
    for (const auto& [n, t] : vs[v].adj) out.push_back(n);
    return out;
  }
};

// ----------------------------------------------------- edge resolution rules
static void fuse_pair(Graph& g, int u, int v, int extra_h_loops = 0);

static void add_self_loop(Graph& g, int v, int ty) {
  if (g.vs[v].ty == BOUNDARY) {
    fail(5);
    return;
  }
  if (ty == SIMPLE) return;
  g.add_to_phase_int(v, 1);
  g.sc.add_power(-1);
}

static void add_edge_resolve(Graph& g, int u, int v, int ty) {
  if (g_err) return;
  if (u == v) {
    add_self_loop(g, u, ty);
    return;
  }
  if (!g.connected(u, v)) {
    g.add_edge(u, v, (uint8_t)ty);
    return;
  }
  int et = g.edge_type(u, v);
  int tu = g.vs[u].ty, tv = g.vs[v].ty;
  if (tu == BOUNDARY || tv == BOUNDARY) {
    fail(6);
    return;
  }
  if (tu != tv) {
    if (et == SIMPLE && ty == SIMPLE) {
      g.remove_edge(u, v);
      g.sc.add_power(-2);
      return;
    }
    fail(7);  // mixed-color parallel edges beyond Hopf
    return;
  }
  if (et == SIMPLE && ty == SIMPLE) return;
  if (et == HADAMARD && ty == HADAMARD) {
    g.remove_edge(u, v);
    g.sc.add_power(-2);
    return;
  }
  if (et == HADAMARD && ty == SIMPLE) {
    g.set_edge_type(u, v, SIMPLE);
    fuse_pair(g, u, v, 1);
  } else {
    fuse_pair(g, u, v, 1);
  }
}

static void fuse_pair(Graph& g, int u, int v, int extra_h_loops) {
  if (g_err) return;
  if (g.is_b(v)) {
    fail(8);
    return;
  }
  g.remove_edge(u, v);
  g.add_to_phase(u, g.vs[v].ph);
  g.xor_params(u, g.vs[v].par);
  std::vector<std::pair<int, int>> pending;
  pending.reserve(g.vs[v].adj.size());
  for (const auto& [n, t] : g.vs[v].adj) pending.emplace_back(n, t);
  g.remove_vertex(v);
  for (const auto& [n, t] : pending) {
    if (n == u || !g.alive(n))
      add_self_loop(g, u, t);
    else
      add_edge_resolve(g, u, n, t);
    if (g_err) return;
  }
  for (int i = 0; i < extra_h_loops; ++i) add_self_loop(g, u, HADAMARD);
}

// --------------------------------------------------------- structural passes
static bool to_gh(Graph& g) {
  bool changed = false;
  for (int v : g.vertex_ids()) {
    if (g.vs[v].ty != XV) continue;
    g.vs[v].ty = ZV;
    for (auto& [n, t] : g.vs[v].adj) {
      uint8_t nt = (t == HADAMARD) ? SIMPLE : HADAMARD;
      t = nt;
      g.vs[n].adj[g.adj_index(n, v)].second = nt;
    }
    changed = true;
  }
  return changed;
}

static bool fuse_spiders(Graph& g) {
  bool changed = false;
  bool again = true;
  while (again && !g_err) {
    again = false;
    for (int u : g.vertex_ids()) {
      if (!g.alive(u) || g.vs[u].ty != ZV) continue;
      for (int n : g.neighbor_ids(u)) {
        if (g.vs[n].ty == ZV && g.edge_type(u, n) == SIMPLE && !g.is_b(n)) {
          fuse_pair(g, u, n);
          changed = again = true;
          break;
        }
      }
      if (g_err) return changed;
    }
  }
  return changed;
}

static bool remove_identities(Graph& g) {
  bool changed = false;
  for (int v : g.vertex_ids()) {
    if (!g.alive(v)) continue;
    if (g.vs[v].ty != ZV || !frac_zero(g.vs[v].ph) || !g.vs[v].par.empty())
      continue;
    if (g.is_b(v)) continue;
    if (g.degree(v) != 2) continue;
    int a = g.vs[v].adj[0].first, b = g.vs[v].adj[1].first;
    int t1 = g.vs[v].adj[0].second, t2 = g.vs[v].adj[1].second;
    int ty = (t1 == t2) ? SIMPLE : HADAMARD;
    g.remove_vertex(v);
    if (a == b) {
      add_self_loop(g, a, ty);
    } else if (g.vs[a].ty != BOUNDARY && g.vs[b].ty != BOUNDARY) {
      add_edge_resolve(g, a, b, ty);
    } else if (!g.connected(a, b)) {
      g.add_edge(a, b, (uint8_t)ty);
    } else {
      // boundary + existing parallel edge: re-add an identity, no change
      int w = g.add_vertex(ZV, g.vs[a].q, g.vs[a].r);
      g.add_edge(a, w, (uint8_t)t1);
      int t2b = (ty == SIMPLE) ? t2 : (t2 == HADAMARD ? SIMPLE : HADAMARD);
      g.add_edge(w, b, (uint8_t)t2b);
      continue;
    }
    changed = true;
    if (g_err) return changed;
  }
  return changed;
}

static bool collect_terminals(Graph& g) {
  bool changed = false;
  for (int v : g.vertex_ids()) {
    if (!g.alive(v)) continue;
    if (g.vs[v].ty != ZV || g.is_b(v)) continue;
    int deg = g.degree(v);
    if (deg == 0) {
      i64 den = g.vs[v].ph.d;
      if (!g.vs[v].par.empty() && den != 1 && den != 2 && den != 4) continue;
      g.sc.add_node(g.vs[v].ph, g.vs[v].par);
      g.remove_vertex(v);
      changed = true;
    } else if (deg == 1) {
      int n = g.vs[v].adj[0].first;
      if (g.vs[n].ty != ZV || g.degree(n) != 1 || g.is_b(n)) continue;
      int ty = g.vs[v].adj[0].second;
      if (ty == SIMPLE) {
        fuse_pair(g, v, n);
        changed = true;
        if (g_err) return changed;
        continue;
      }
      Frac pa = g.vs[v].ph, pb = g.vs[n].ph;
      bool da = (pa.d == 1 || pa.d == 2 || pa.d == 4);
      bool db = (pb.d == 1 || pb.d == 2 || pb.d == 4);
      if (da && db) {
        g.sc.add_phase_pair(eighth_turns(pa), eighth_turns(pb), g.vs[v].par,
                            g.vs[n].par);
        g.sc.add_power(-1);
        g.remove_vertex(v);
        g.remove_vertex(n);
        changed = true;
      }
    }
  }
  return changed;
}

// ---------------------------------------------------------------- copy rule
static bool copy_rule(Graph& g) {
  bool changed = false;
  for (int u : g.vertex_ids()) {
    if (!g.alive(u)) continue;
    if (g.vs[u].ty != ZV || g.is_b(u)) continue;
    if (g.degree(u) != 1 || g.vs[u].ph.d > 1) continue;
    int v = g.vs[u].adj[0].first;
    if (g.vs[u].adj[0].second != HADAMARD) continue;
    if (g.vs[v].ty != ZV || g.is_b(v)) continue;
    if (g.degree(v) < 2) continue;
    std::vector<int> ws;
    bool bad = false;
    for (const auto& [w, t] : g.vs[v].adj) {
      if (w == u) continue;
      if (g.vs[w].ty == BOUNDARY) {
        bad = true;
        break;
      }
      ws.push_back(w);
    }
    if (bad) continue;
    int a0 = (int)(((g.vs[u].ph.n % 2) + 2) % 2);  // denominator 1
    PSet pu = g.vs[u].par;
    PSet pv = g.vs[v].par;
    Frac bphase = g.vs[v].ph;

    PSet alpha_set = a0 ? pset_with_one(pu) : pu;
    if (!alpha_set.empty() && !pu.empty() && bphase.d > 2) continue;

    int k = (int)ws.size();
    g.sc.add_power(1 - k);
    if (!alpha_set.empty()) {
      if (!pv.empty()) g.sc.add_pi_pair(alpha_set, pv);
      if (!frac_zero(bphase)) {
        if (pu.empty()) {
          if (a0) g.sc.add_phase(bphase);
        } else {
          int j = (int)(((i128)bphase.n * 2 / bphase.d) % 4);  // den <= 2
          if (a0) {
            g.sc.add_phase(bphase);
            g.sc.add_halfpi((4 - j) % 4, pu);
          } else {
            g.sc.add_halfpi(j, pu);
          }
        }
      }
    }
    g.remove_vertex(u);
    g.remove_vertex(v);
    for (int w : ws) {
      if (a0) g.add_to_phase_int(w, 1);
      g.xor_params(w, pu);
    }
    changed = true;
    if (g_err) return changed;
  }
  return changed;
}

// ------------------------------------------------------- lcomp, pivot, misc
static bool interior(const Graph& g, int v) {
  if (g.vs[v].ty != ZV || g.is_b(v)) return false;
  for (const auto& [n, t] : g.vs[v].adj)
    if (g.vs[n].ty == BOUNDARY) return false;
  return true;
}

static bool all_h_edges(const Graph& g, int v) {
  for (const auto& [n, t] : g.vs[v].adj)
    if (t != HADAMARD) return false;
  return true;
}

static bool has_gadget_leaf(const Graph& g, int v) {
  for (const auto& [n, t] : g.vs[v].adj)
    if (g.degree(n) == 1 && g.vs[n].ty == ZV && !g.is_b(n)) return true;
  return false;
}

static void lcomp(Graph& g, int u) {
  Frac ph = g.vs[u].ph;
  int s = frac_is(ph, 1, 2) ? 1 : -1;
  PSet P = g.vs[u].par;
  std::vector<int> nbrs = g.neighbor_ids(u);
  int n = (int)nbrs.size();
  g.remove_vertex(u);
  g.sc.add_power(((i64)(n - 1) * (n - 2)) / 2);
  g.sc.add_phase(frac_mod2(Frac{s, 4}));
  if (!P.empty()) g.sc.add_halfpi(((-s) % 4 + 4) % 4, P);
  for (int i = 0; i < n; ++i) {
    int a = nbrs[i];
    g.add_to_phase(a, frac_mod2(Frac{-s, 2}));
    g.xor_params(a, P);
    for (int j = i + 1; j < n; ++j) {
      int b = nbrs[j];
      if (g.connected(a, b) && g.edge_type(a, b) == HADAMARD) {
        g.remove_edge(a, b);
        g.sc.add_power(-2);
      } else {
        add_edge_resolve(g, a, b, HADAMARD);
      }
      if (g_err) return;
    }
  }
}

static bool lcomp_matcher(Graph& g) {
  bool changed = false;
  for (int u : g.vertex_ids()) {
    if (!g.alive(u)) continue;
    if (!interior(g, u) || !all_h_edges(g, u)) continue;
    Frac p = g.vs[u].ph;
    if (frac_is(p, 1, 2) || frac_is(p, 3, 2)) {
      lcomp(g, u);
      changed = true;
      if (g_err) return changed;
    }
  }
  return changed;
}

static i64 pivot_power(i64 na, i64 nb, i64 nc) {
  return na * nb + na * nc + nb * nc - na - nb - 2 * nc + 1;
}

static void pivot(Graph& g, int u, int v) {
  int a0 = frac_is(g.vs[u].ph, 1, 1) ? 1 : 0;
  int b0 = frac_is(g.vs[v].ph, 1, 1) ? 1 : 0;
  PSet Pa = g.vs[u].par, Pb = g.vs[v].par;

  std::vector<int> nu, nv;
  for (const auto& [n, t] : g.vs[u].adj)
    if (n != v) nu.push_back(n);
  for (const auto& [n, t] : g.vs[v].adj)
    if (n != u) nv.push_back(n);
  std::sort(nu.begin(), nu.end());
  std::sort(nv.begin(), nv.end());
  std::vector<int> C, A, B;
  std::set_intersection(nu.begin(), nu.end(), nv.begin(), nv.end(),
                        std::back_inserter(C));
  std::set_difference(nu.begin(), nu.end(), C.begin(), C.end(),
                      std::back_inserter(A));
  std::set_difference(nv.begin(), nv.end(), C.begin(), C.end(),
                      std::back_inserter(B));

  g.remove_vertex(u);
  g.remove_vertex(v);

  g.sc.add_power(pivot_power((i64)A.size(), (i64)B.size(), (i64)C.size()));
  PSet psi = a0 ? pset_with_one(Pa) : Pa;
  PSet phi = b0 ? pset_with_one(Pb) : Pb;
  g.sc.add_pi_pair(psi, phi);

  const std::vector<int>* groups[3][2] = {{&A, &B}, {&A, &C}, {&B, &C}};
  for (auto& gp : groups) {
    for (int x : *gp[0]) {
      for (int y : *gp[1]) {
        if (g.connected(x, y) && g.edge_type(x, y) == HADAMARD) {
          g.remove_edge(x, y);
          g.sc.add_power(-2);
        } else {
          add_edge_resolve(g, x, y, HADAMARD);
        }
        if (g_err) return;
      }
    }
  }
  for (int x : A) {
    if (b0) g.add_to_phase_int(x, 1);
    g.xor_params(x, Pb);
  }
  for (int x : B) {
    if (a0) g.add_to_phase_int(x, 1);
    g.xor_params(x, Pa);
  }
  PSet Pab = pset_xor(Pa, Pb);
  for (int x : C) {
    g.add_to_phase_int(x, (a0 + b0 + 1) % 2);
    g.xor_params(x, Pab);
  }
}

static bool is_pauli(Frac p) { return p.d == 1; }

static bool pivot_matcher(Graph& g) {
  bool changed = false;
  for (int u : g.vertex_ids()) {
    if (!g.alive(u)) continue;
    if (!interior(g, u) || !all_h_edges(g, u)) continue;
    if (!is_pauli(g.vs[u].ph)) continue;
    if (has_gadget_leaf(g, u) && g.degree(u) > 1) continue;
    for (int v : g.neighbor_ids(u)) {
      if (!g.alive(v)) break;
      if (!interior(g, v) || !all_h_edges(g, v)) continue;
      if (!is_pauli(g.vs[v].ph)) continue;
      if (g.edge_type(u, v) != HADAMARD) continue;
      if (has_gadget_leaf(g, v) && g.degree(u) != 1) continue;
      pivot(g, u, v);
      changed = true;
      break;
    }
    if (g_err) return changed;
  }
  return changed;
}

// ------------------------------------------------------------- simplify.py
static bool basic_fixpoint(Graph& g) {
  bool any_change = false;
  while (!g_err) {
    bool changed = fuse_spiders(g);
    changed |= remove_identities(g);
    if (!changed) return any_change;
    any_change = true;
  }
  return any_change;
}

static bool interior_clifford_simp(Graph& g) {
  bool any_change = to_gh(g);
  while (!g_err) {
    bool changed = basic_fixpoint(g);
    changed |= collect_terminals(g);
    basic_fixpoint(g);
    changed |= copy_rule(g);
    basic_fixpoint(g);
    changed |= lcomp_matcher(g);
    basic_fixpoint(g);
    changed |= pivot_matcher(g);
    if (g.sc.is_zero) return true;
    if (!changed) return any_change;
    any_change = true;
  }
  return any_change;
}

static std::pair<int, int> unfuse_to_gadget(Graph& g, int v) {
  double q = g.vs[v].q, r = g.vs[v].r;
  int hub = g.add_vertex(ZV, q - 0.5, r);
  int leaf = g.add_vertex(ZV, q - 1, r, g.vs[v].ph, g.vs[v].par);
  g.vs[v].ph = Frac{0, 1};
  g.vs[v].par.clear();
  g.add_edge(v, hub, HADAMARD);
  g.add_edge(hub, leaf, HADAMARD);
  return {hub, leaf};
}

static bool pivot_gadget_simp(Graph& g, bool allow_hubs) {
  bool changed = false;
  for (int u : g.vertex_ids()) {
    if (!g.alive(u)) continue;
    if (!interior(g, u) || !all_h_edges(g, u)) continue;
    if (!is_pauli(g.vs[u].ph)) continue;
    if (!allow_hubs && has_gadget_leaf(g, u)) continue;
    for (int v : g.neighbor_ids(u)) {
      if (!g.alive(v) || !interior(g, v)) continue;
      if (!all_h_edges(g, v)) continue;
      if (g.edge_type(u, v) != HADAMARD) continue;
      if (is_pauli(g.vs[v].ph)) continue;
      if (g.degree(v) == 1) continue;
      if (!allow_hubs && has_gadget_leaf(g, v)) continue;
      unfuse_to_gadget(g, v);
      pivot(g, u, v);
      changed = true;
      break;
    }
    if (g_err) return changed;
  }
  return changed;
}

static bool boundary_pivot_simp(Graph& g) {
  bool changed = false;
  for (int u : g.vertex_ids()) {
    if (!g.alive(u)) continue;
    if (!interior(g, u) || !all_h_edges(g, u)) continue;
    if (!is_pauli(g.vs[u].ph)) continue;
    if (has_gadget_leaf(g, u)) continue;
    for (int v : g.neighbor_ids(u)) {
      if (!g.alive(v)) continue;
      if (g.vs[v].ty != ZV || g.is_b(v)) continue;
      if (g.edge_type(u, v) != HADAMARD) continue;
      if (has_gadget_leaf(g, v) && g.degree(u) != 1) continue;
      std::vector<int> bnds;
      for (const auto& [n, t] : g.vs[v].adj)
        if (g.vs[n].ty == BOUNDARY) bnds.push_back(n);
      if (bnds.empty()) continue;
      bool ok = true;
      for (const auto& [n, t] : g.vs[v].adj)
        if (g.vs[n].ty != BOUNDARY && t != HADAMARD) ok = false;
      if (!ok) continue;
      for (int b : bnds) {
        int t = g.edge_type(v, b);
        g.remove_edge(v, b);
        int w = g.add_vertex(ZV, g.vs[b].q, (g.vs[v].r + g.vs[b].r) / 2);
        int w2 = g.add_vertex(ZV, g.vs[b].q, (g.vs[v].r + 2 * g.vs[b].r) / 3);
        g.add_edge(v, w, HADAMARD);
        g.add_edge(w, w2, HADAMARD);
        g.add_edge(w2, b, (uint8_t)t);
      }
      if (!is_pauli(g.vs[v].ph)) unfuse_to_gadget(g, v);
      pivot(g, u, v);
      changed = true;
      break;
    }
    if (changed || g_err) break;
  }
  return changed;
}

static bool gadget_simp(Graph& g) {
  bool changed = false;
  std::map<std::vector<int>, std::pair<int, int>> hubs;
  for (int v : g.vertex_ids()) {
    if (!g.alive(v)) continue;
    if (g.vs[v].ty != ZV || !frac_zero(g.vs[v].ph) || !g.vs[v].par.empty())
      continue;
    if (g.is_b(v)) continue;
    std::vector<int> leaves, targets;
    bool allh = true;
    for (const auto& [n, t] : g.vs[v].adj) {
      if (t != HADAMARD) allh = false;
      if (g.degree(n) == 1 && g.vs[n].ty == ZV && t == HADAMARD && !g.is_b(n))
        leaves.push_back(n);
    }
    if (leaves.size() != 1 || g.degree(v) < 2 || !allh) continue;
    int leaf = leaves[0];
    bool bad = false;
    for (const auto& [n, t] : g.vs[v].adj) {
      if (n == leaf) continue;
      if (g.vs[n].ty == BOUNDARY) bad = true;
      targets.push_back(n);
    }
    if (bad) continue;
    std::sort(targets.begin(), targets.end());
    auto it = hubs.find(targets);
    if (it != hubs.end()) {
      int leaf0 = it->second.second;
      g.add_to_phase(leaf0, g.vs[leaf].ph);
      g.xor_params(leaf0, g.vs[leaf].par);
      g.remove_vertex(leaf);
      g.remove_vertex(v);
      g.sc.add_power(1 - (i64)targets.size());
      changed = true;
    } else {
      hubs[targets] = {v, leaf};
    }
  }
  return changed;
}

static int nonclifford_count(const Graph& g) {
  int n = 0;
  for (const auto& v : g.vs)
    if (v.alive && v.ph.d > 2) ++n;
  return n;
}

struct Size3 {
  int ncc, nv, ne;
  bool operator>(const Size3& o) const {
    if (ncc != o.ncc) return ncc > o.ncc;
    if (nv != o.nv) return nv > o.nv;
    return ne > o.ne;
  }
  bool operator>=(const Size3& o) const { return *this > o || (*this == o); }
  bool operator==(const Size3& o) const {
    return ncc == o.ncc && nv == o.nv && ne == o.ne;
  }
};

static Size3 sizeof_graph(const Graph& g) {
  return Size3{nonclifford_count(g), g.num_vertices(), g.num_edges()};
}

static void shake(Graph& g, int rounds) {
  for (int i = 0; i < rounds && !g_err; ++i) {
    Size3 before = sizeof_graph(g);
    Graph snap = g;
    bool changed = pivot_gadget_simp(g, true);
    if (changed) {
      interior_clifford_simp(g);
      gadget_simp(g);
      interior_clifford_simp(g);
    }
    Size3 after = sizeof_graph(g);
    if (!changed || after >= before) {
      if (after > before) g = snap;
      return;
    }
  }
}

static void full_reduce(Graph& g, bool do_shake) {
  interior_clifford_simp(g);
  for (int i = 0; i < 1000 && !g_err; ++i) {
    bool changed = pivot_gadget_simp(g, false);
    if (changed) interior_clifford_simp(g);
    bool c2 = gadget_simp(g);
    if (c2) interior_clifford_simp(g);
    bool c3 = boundary_pivot_simp(g);
    if (c3) interior_clifford_simp(g);
    if (!(changed || c2 || c3)) break;
  }
  if (do_shake && !g_err) shake(g, 30);
}

// ------------------------------------------------------------ serialization
struct Reader {
  const i64* p;
  const i64* end;
  const double* f;
  const double* fend;
  i64 next() {
    if (p >= end) {
      fail(10);
      return 0;
    }
    return *p++;
  }
  double nextf() {
    if (f >= fend) {
      fail(10);
      return 0;
    }
    return *f++;
  }
  PSet pset() {
    i64 n = next();
    PSet out;
    out.reserve((size_t)n);
    for (i64 i = 0; i < n; ++i) out.push_back((i32)next());
    std::sort(out.begin(), out.end());
    return out;
  }
};

struct Writer {
  std::vector<i64> ints;
  std::vector<double> floats;
  void put(i64 x) { ints.push_back(x); }
  void putf(double x) { floats.push_back(x); }
  void pset(const PSet& s) {
    put((i64)s.size());
    for (i32 x : s) put(x);
  }
};

static Graph decode(Reader& r) {
  Graph g;
  i64 next_id = r.next();
  i64 n_verts = r.next();
  i64 n_edges = r.next();
  i64 n_in = r.next();
  i64 n_out = r.next();
  g.vs.resize((size_t)next_id);
  g.bnd.assign((size_t)next_id, 0);
  for (i64 i = 0; i < n_verts; ++i) {
    i64 id = r.next();
    if (id < 0 || id >= next_id) {
      fail(11);
      return g;
    }
    Vert& v = g.vs[(size_t)id];
    v.alive = true;
    v.ty = (uint8_t)r.next();
    i64 pn = r.next(), pd = r.next();
    v.ph = frac_mod2(frac_make(pn, pd));
    v.par = r.pset();
    v.q = r.nextf();
    v.r = r.nextf();
  }
  for (i64 i = 0; i < n_edges; ++i) {
    i64 u = r.next(), v = r.next(), t = r.next();
    if (!g.alive((int)u) || !g.alive((int)v)) {
      fail(12);
      return g;
    }
    g.add_edge((int)u, (int)v, (uint8_t)t);
  }
  for (i64 i = 0; i < n_in; ++i) {
    i64 v = r.next();
    g.inputs.push_back((i32)v);
    g.bnd[(size_t)v] = 1;
  }
  for (i64 i = 0; i < n_out; ++i) {
    i64 v = r.next();
    g.outputs.push_back((i32)v);
    g.bnd[(size_t)v] = 1;
  }
  Scalar& s = g.sc;
  s.is_zero = r.next() != 0;
  s.power2 = r.next();
  {
    i64 pn = r.next();
    i64 pd = r.next();
    s.phase = frac_mod2(frac_make(pn, pd));
  }
  s.ff.a = r.next();
  s.ff.b = r.next();
  s.ff.c = r.next();
  s.ff.d = r.next();
  {
    double re = r.nextf();
    double im = r.nextf();
    s.approx = std::complex<double>(re, im);
  }
  s.pivars = r.pset();
  i64 nh = r.next();
  for (i64 i = 0; i < nh; ++i) {
    int j = (int)r.next();
    s.halfpi.emplace_back(j, r.pset());
  }
  i64 np = r.next();
  for (i64 i = 0; i < np; ++i) {
    PSet a = r.pset();
    PSet b = r.pset();
    s.pipairs.emplace_back(std::move(a), std::move(b));
  }
  i64 nn = r.next();
  for (i64 i = 0; i < nn; ++i) {
    i64 pn = r.next(), pd = r.next();
    Frac ph = frac_mod2(frac_make(pn, pd));
    s.add_node(ph, r.pset());  // canonicalizes projector nodes
  }
  i64 npr = r.next();
  for (i64 i = 0; i < npr; ++i) {
    int a = (int)r.next(), b = (int)r.next();
    PSet pa = r.pset();
    PSet pb = r.pset();
    s.pairs.push_back(PhasePairT{a, b, std::move(pa), std::move(pb)});
  }
  return g;
}

static void encode(const Graph& g, Writer& w) {
  w.put((i64)g.vs.size());
  std::vector<int> ids = g.vertex_ids();
  w.put((i64)ids.size());
  // edge count
  i64 ne = 0;
  for (int v : ids) ne += g.degree(v);
  w.put(ne / 2);
  w.put((i64)g.inputs.size());
  w.put((i64)g.outputs.size());
  for (int v : ids) {
    const Vert& vv = g.vs[v];
    w.put(v);
    w.put(vv.ty);
    w.put(vv.ph.n);
    w.put(vv.ph.d);
    w.pset(vv.par);
    w.putf(vv.q);
    w.putf(vv.r);
  }
  for (int u : ids) {
    for (const auto& [v, t] : g.vs[u].adj) {
      if (u < v) {
        w.put(u);
        w.put(v);
        w.put(t);
      }
    }
  }
  for (i32 v : g.inputs) w.put(v);
  for (i32 v : g.outputs) w.put(v);
  const Scalar& s = g.sc;
  w.put(s.is_zero ? 1 : 0);
  w.put(s.power2);
  w.put(s.phase.n);
  w.put(s.phase.d);
  w.put(s.ff.a);
  w.put(s.ff.b);
  w.put(s.ff.c);
  w.put(s.ff.d);
  w.putf(s.approx.real());
  w.putf(s.approx.imag());
  w.pset(s.pivars);
  w.put((i64)s.halfpi.size());
  for (const auto& [j, ps] : s.halfpi) {
    w.put(j);
    w.pset(ps);
  }
  w.put((i64)s.pipairs.size());
  for (const auto& [a, b] : s.pipairs) {
    w.pset(a);
    w.pset(b);
  }
  w.put((i64)s.nodes.size());
  for (const auto& [ph, ps] : s.nodes) {
    w.put(ph.n);
    w.put(ph.d);
    w.pset(ps);
  }
  w.put((i64)s.pairs.size());
  for (const auto& pp : s.pairs) {
    w.put(pp.alpha);
    w.put(pp.beta);
    w.pset(pp.A);
    w.pset(pp.B);
  }
}

// -------------------------------------------- planned pair-projector leaves

// One branch (c = 0 equality / 1 anti-equality) of the gadget-pair
// parity-projector split; exact port of zx/decompose.py::apply_pair_projector
// (see there for the derivation; both branches sum to the original diagram).
static void apply_pair_projector(Graph& g, int l1, int h1, int l2, int h2,
                                 int c) {
  if (!g.alive(l1) || !g.alive(h1) || !g.alive(l2) || !g.alive(h2)) {
    fail(20);
    return;
  }
  Frac a1 = g.vs[l1].ph;
  Frac a2 = g.vs[l2].ph;
  PSet P1 = g.vs[l1].par;
  PSet Pd = pset_xor(P1, g.vs[l2].par);
  PSet Qd = pset_xor(g.vs[h1].par, g.vs[h2].par);
  std::vector<int> t1, t2;
  for (const auto& [n, t] : g.vs[h1].adj)
    if (n != l1) t1.push_back(n);
  for (const auto& [n, t] : g.vs[h2].adj)
    if (n != l2) t2.push_back(n);
  std::sort(t1.begin(), t1.end());
  std::sort(t2.begin(), t2.end());
  std::vector<int> D;
  std::set_symmetric_difference(t1.begin(), t1.end(), t2.begin(), t2.end(),
                                std::back_inserter(D));
  double qrow = (g.vs[h1].r + g.vs[h2].r) / 2.0;
  double qq = g.vs[h1].q - 0.5;
  g.remove_vertex(l1);
  g.remove_vertex(h1);
  g.vs[l2].ph =
      frac_mod2(c == 0 ? frac_add(a1, a2) : frac_add(a2, frac_neg_mod2(a1)));
  g.vs[l2].par = Pd;
  int hub = g.add_vertex(ZV, qq, qrow, Frac{c, 1});
  g.vs[hub].par = Qd;
  for (int t : D) g.add_edge(hub, t, HADAMARD);
  g.sc.add_power((i64)D.size() - (i64)t1.size() - 1);
  if (c) {
    g.sc.add_phase(a1);
    if (!P1.empty()) g.sc.add_pi_var(P1);
  }
}

}  // namespace

extern "C" {

// Reduce the serialized graph. Returns 0 on success (outputs malloc'd; caller
// frees via zx_free_*), nonzero error code otherwise (no outputs).
int zx_full_reduce(const i64* in, i64 in_len, const double* inf, i64 inf_len,
                   int do_shake, i64** out, i64* out_len, double** outf,
                   i64* outf_len) {
  g_err = 0;
  Reader r{in, in + in_len, inf, inf + inf_len};
  Graph g = decode(r);
  if (g_err) return g_err;
  full_reduce(g, do_shake != 0);
  if (g_err) return g_err;
  // normalize: phases already canonical mod 2.
  Writer w;
  encode(g, w);
  *out_len = (i64)w.ints.size();
  *out = (i64*)std::malloc(w.ints.size() * sizeof(i64));
  std::memcpy(*out, w.ints.data(), w.ints.size() * sizeof(i64));
  *outf_len = (i64)w.floats.size();
  *outf = (double*)std::malloc(w.floats.size() * sizeof(double));
  std::memcpy(*outf, w.floats.data(), w.floats.size() * sizeof(double));
  return 0;
}

// Enumerate the planned pair-projector leaves of the serialized graph: for
// each row of ``assigns`` (n_assigns x n_pairs branch bits), copy the graph,
// apply every pair's projector branch, full_reduce, and keep nonzero
// survivors. Output ints = [count] followed by the survivors' serialized
// streams back to back (same per-graph format as zx_full_reduce). This is
// the compile-time hot loop of the planned decomposition: the Python
// per-leaf loop costs ~13 ms/leaf in graph copies and Python<->native
// round-trips, ~200 s on the grown-cultivation full plug's 16k leaves.
int zx_planned_enumerate(const i64* in, i64 in_len, const double* inf,
                         i64 inf_len, int do_shake, const i64* pair_ids,
                         i64 n_pairs, const i64* assigns, i64 n_assigns,
                         i64** out, i64* out_len, double** outf,
                         i64* outf_len) {
  g_err = 0;
  Reader r{in, in + in_len, inf, inf + inf_len};
  Graph base = decode(r);
  if (g_err) return g_err;
  Writer w;
  w.put(0);  // survivor count, patched below
  i64 count = 0;
  for (i64 a = 0; a < n_assigns; ++a) {
    Graph g = base;
    const i64* cs = assigns + a * n_pairs;
    for (i64 k = 0; k < n_pairs; ++k) {
      const i64* p = pair_ids + 4 * k;
      apply_pair_projector(g, (int)p[0], (int)p[1], (int)p[2], (int)p[3],
                           (int)cs[k]);
      if (g_err) return g_err;
    }
    full_reduce(g, do_shake != 0);
    if (g_err) return g_err;
    if (g.sc.is_zero) continue;
    ++count;
    encode(g, w);
  }
  w.ints[0] = count;
  *out_len = (i64)w.ints.size();
  *out = (i64*)std::malloc(w.ints.size() * sizeof(i64));
  std::memcpy(*out, w.ints.data(), w.ints.size() * sizeof(i64));
  *outf_len = (i64)w.floats.size();
  *outf = (double*)std::malloc(std::max<size_t>(w.floats.size(), 1) *
                               sizeof(double));
  std::memcpy(*outf, w.floats.data(), w.floats.size() * sizeof(double));
  return 0;
}

// ----------------------------------------------- min-rank matching planner
//
// Native core of zx/decompose.py::plan_projector_cover: a dependent-first
// greedy matching over per-gadget constraint vectors followed by a seeded
// 2-swap iterated local search with a validity-filter-aware cost (see the
// Python docstring for the math). Vectors are fixed-width bitsets (w words
// of 64 coordinates each); the Python wrapper packs them. Deterministic:
// fixed xorshift seed, move-count budget.

namespace {

struct PlanCtx {
  i64 n, w;
  const uint64_t* umask;   // n x w
  const uint64_t* lhmask;  // n x w
  const uint64_t* dmask;   // n x n x w (0 for disallowed pairs)
  const uint8_t* allowed;  // n x n
  double drop_w;
  std::vector<uint64_t> scratch;

  const uint64_t* u(i64 i) const { return umask + i * w; }
  const uint64_t* lh(i64 i) const { return lhmask + i * w; }
  const uint64_t* d(i64 i, i64 j) const { return dmask + (i * n + j) * w; }
  bool ok(i64 i, i64 j) const { return allowed[i * n + j] != 0; }
};

static inline void vxor(uint64_t* a, const uint64_t* b, i64 w) {
  for (i64 k = 0; k < w; ++k) a[k] ^= b[k];
}

static inline void vor(uint64_t* a, const uint64_t* b, i64 w) {
  for (i64 k = 0; k < w; ++k) a[k] |= b[k];
}

static inline bool vzero(const uint64_t* a, i64 w) {
  for (i64 k = 0; k < w; ++k)
    if (a[k]) return false;
  return true;
}

// Lexicographic compare, most-significant word first (word w-1 highest).
static inline int vcmp(const uint64_t* a, const uint64_t* b, i64 w) {
  for (i64 k = w - 1; k >= 0; --k) {
    if (a[k] != b[k]) return a[k] < b[k] ? -1 : 1;
  }
  return 0;
}

static inline int vpopcount(const uint64_t* a, i64 w) {
  int c = 0;
  for (i64 k = 0; k < w; ++k) c += __builtin_popcountll(a[k]);
  return c;
}

// Reduce v in place against an echelon basis (rows descending, distinct
// leading words); one pass suffices.
static void vreduce(uint64_t* v, const std::vector<uint64_t>& basis, i64 nb,
                    i64 w) {
  std::vector<uint64_t> tmp((size_t)w);
  for (i64 b = 0; b < nb; ++b) {
    const uint64_t* row = basis.data() + b * w;
    std::memcpy(tmp.data(), v, (size_t)w * 8);
    vxor(tmp.data(), row, w);
    if (vcmp(tmp.data(), v, w) < 0) std::memcpy(v, tmp.data(), (size_t)w * 8);
  }
}

// Insert a (already fully reduced, nonzero) vector keeping descending order.
static void vinsert(std::vector<uint64_t>& basis, i64& nb, const uint64_t* v,
                    i64 w) {
  basis.resize((size_t)(nb + 1) * w);
  i64 pos = nb;
  while (pos > 0 && vcmp(basis.data() + (pos - 1) * w, v, w) < 0) {
    std::memcpy(basis.data() + pos * w, basis.data() + (pos - 1) * w,
                (size_t)w * 8);
    --pos;
  }
  std::memcpy(basis.data() + pos * w, v, (size_t)w * 8);
  ++nb;
}

static double plan_cost(const PlanCtx& c, const std::vector<std::pair<i32, i32>>& pl) {
  i64 w = c.w;
  std::vector<uint64_t> lhall((size_t)w, 0), own((size_t)w), v((size_t)w),
      t((size_t)w);
  for (const auto& [i, j] : pl) {
    vor(lhall.data(), c.lh(i), w);
    vor(lhall.data(), c.lh(j), w);
  }
  std::vector<uint64_t> basis;
  i64 nb = 0;
  int r = 0, dropped = 0;
  for (const auto& [i, j] : pl) {
    std::memcpy(own.data(), c.lh(i), (size_t)w * 8);
    vor(own.data(), c.lh(j), w);
    bool drop = false;
    const uint64_t* dm = c.d(i, j);
    for (i64 k = 0; k < w; ++k) {
      if (dm[k] & lhall[k] & ~own[k]) {
        drop = true;
        break;
      }
    }
    if (drop) {
      ++dropped;
      continue;
    }
    std::memcpy(v.data(), c.u(i), (size_t)w * 8);
    vxor(v.data(), c.u(j), w);
    vreduce(v.data(), basis, nb, w);
    if (!vzero(v.data(), w)) {
      vinsert(basis, nb, v.data(), w);
      ++r;
    }
  }
  return r + c.drop_w * dropped +
         0.5 * c.drop_w * (double)(c.n - 2 * (i64)pl.size());
}

struct XorShift {
  uint64_t s;
  explicit XorShift(uint64_t seed) : s(seed ? seed : 0x9E3779B97F4A7C15ull) {}
  uint64_t next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }
  i64 below(i64 n) { return (i64)(next() % (uint64_t)n); }
};

}  // namespace

// Plan the min-rank matching. pairs_out receives up to n/2 (i, j) index
// pairs; returns the number of pairs written (or -1 on bad input).
int zx_plan_cover(const uint64_t* umask, const uint64_t* lhmask,
                  const uint64_t* dmask, const uint8_t* allowed, i64 n, i64 w,
                  double drop_w, i64 budget, i64* pairs_out) {
  if (n <= 1 || w <= 0) return 0;
  PlanCtx c{n, w, umask, lhmask, dmask, allowed, drop_w, {}};

  // All-gadget leaf/hub union for the greedy's dirty ordering.
  std::vector<uint64_t> lhall((size_t)w, 0);
  for (i64 i = 0; i < n; ++i) vor(lhall.data(), c.lh(i), w);

  // Dependent-first greedy start.
  std::vector<char> un((size_t)n, 1);
  std::vector<uint64_t> basis;
  i64 nb = 0;
  std::vector<std::pair<i32, i32>> cur;
  std::vector<uint64_t> v((size_t)w), own((size_t)w);
  i64 remaining = n;
  while (remaining > 1) {
    int best_key = 1 << 30;
    i32 bi = -1, bj = -1;
    std::vector<uint64_t> bv((size_t)w);
    for (i64 i = 0; i < n && best_key > 0; ++i) {
      if (!un[i]) continue;
      for (i64 j = i + 1; j < n; ++j) {
        if (!un[j] || !c.ok(i, j)) continue;
        std::memcpy(own.data(), c.lh(i), (size_t)w * 8);
        vor(own.data(), c.lh(j), w);
        int dirty = 0;
        const uint64_t* dm = c.d(i, j);
        for (i64 k = 0; k < w; ++k) {
          if (dm[k] & lhall[k] & ~own[k]) {
            dirty = 1;
            break;
          }
        }
        std::memcpy(v.data(), c.u(i), (size_t)w * 8);
        vxor(v.data(), c.u(j), w);
        vreduce(v.data(), basis, nb, w);
        int indep = vzero(v.data(), w) ? 0 : 1;
        int key = dirty * (1 << 20) + indep * (1 << 10) + vpopcount(v.data(), w);
        if (key < best_key) {
          best_key = key;
          bi = (i32)i;
          bj = (i32)j;
          std::memcpy(bv.data(), v.data(), (size_t)w * 8);
          if (key == 0) break;
        }
      }
    }
    if (bi < 0) break;
    if (!vzero(bv.data(), w)) vinsert(basis, nb, bv.data(), w);
    cur.emplace_back(bi, bj);
    un[bi] = un[bj] = 0;
    remaining -= 2;
  }

  // Iterated local search: 2-swaps accepting cost-non-increasing moves,
  // kicks from the best on stalls.
  i64 m = (i64)cur.size();
  double cur_cost = plan_cost(c, cur);
  std::vector<std::pair<i32, i32>> best = cur;
  double best_cost = cur_cost;
  XorShift rnd(0x51AB51AB51ABull);
  i64 stall = budget / 8 > 1024 ? budget / 8 : 1024;
  i64 since = 0;
  auto norm = [](i32 a, i32 b) {
    return a < b ? std::pair<i32, i32>{a, b} : std::pair<i32, i32>{b, a};
  };
  while (budget > 0 && m >= 2) {
    --budget;
    ++since;
    if (since > stall) {
      cur = best;
      for (int t3 = 0; t3 < 3; ++t3) {
        i64 a = rnd.below(m), b = rnd.below(m - 1);
        if (b >= a) ++b;
        auto [i, j] = cur[a];
        auto [k, l] = cur[b];
        std::pair<i32, i32> o1, o2;
        bool have = false;
        if (c.ok(std::min(i, k), std::max(i, k)) &&
            c.ok(std::min(j, l), std::max(j, l))) {
          o1 = norm(i, k);
          o2 = norm(j, l);
          have = true;
        } else if (c.ok(std::min(i, l), std::max(i, l)) &&
                   c.ok(std::min(j, k), std::max(j, k))) {
          o1 = norm(i, l);
          o2 = norm(j, k);
          have = true;
        }
        if (have) {
          cur[a] = o1;
          cur[b] = o2;
        }
      }
      cur_cost = plan_cost(c, cur);
      since = 0;
      continue;
    }
    i64 a = rnd.below(m), b = rnd.below(m - 1);
    if (b >= a) ++b;
    auto [i, j] = cur[a];
    auto [k, l] = cur[b];
    std::pair<i32, i32> opts[2][2];
    int n_opts = 0;
    if (c.ok(std::min(i, k), std::max(i, k)) &&
        c.ok(std::min(j, l), std::max(j, l))) {
      opts[n_opts][0] = norm(i, k);
      opts[n_opts][1] = norm(j, l);
      ++n_opts;
    }
    if (c.ok(std::min(i, l), std::max(i, l)) &&
        c.ok(std::min(j, k), std::max(j, k))) {
      opts[n_opts][0] = norm(i, l);
      opts[n_opts][1] = norm(j, k);
      ++n_opts;
    }
    if (!n_opts) continue;
    int pick = n_opts == 1 ? 0 : (int)rnd.below(2);
    auto old_a = cur[a], old_b = cur[b];
    cur[a] = opts[pick][0];
    cur[b] = opts[pick][1];
    double cc = plan_cost(c, cur);
    if (cc <= cur_cost) {
      cur_cost = cc;
      if (cc < best_cost) {
        best = cur;
        best_cost = cc;
        since = 0;
      }
    } else {
      cur[a] = old_a;
      cur[b] = old_b;
    }
  }
  for (i64 k = 0; k < (i64)best.size(); ++k) {
    pairs_out[2 * k] = best[k].first;
    pairs_out[2 * k + 1] = best[k].second;
  }
  return (int)best.size();
}

void zx_free_i64(i64* p) { std::free(p); }
void zx_free_f64(double* p) { std::free(p); }

}  // extern "C"
