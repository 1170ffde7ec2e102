// Native sequential auction engine (CPU).
//
// Single-threaded C++ implementations of the two auction algorithms with
// the same sequential semantics as the Rust reference crate
// (/root/reference/src/ksparse.rs:153-251 and src/symmetric.rs:218-468):
// Khosla's stack-driven auction with the price-threshold drop rule, and
// the eps-scaling forward auction.  Used as
//   (a) the CPU performance baseline standing in for the Rust crate
//       (no Rust toolchain in this environment, see BASELINE.md), and
//   (b) an independent sequential oracle for cross-checking the TPU
//       solvers' objectives.
//
// Conventions: CSR with row offset array starts[n_rows+1]; indices are
// int32; "unassigned" is -1 internally (the Python wrapper converts to
// the package's INT32_MAX sentinel).  Values arrive already sign-adjusted
// for profit maximization (the wrapper replicates the reference's
// init_solve sign flip).

#include <cstdint>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <limits>
#include <vector>

namespace {

constexpr double kNegInf = -std::numeric_limits<double>::infinity();
constexpr double kPosInf = std::numeric_limits<double>::infinity();

// Env-gated stderr tracing — the native analogue of the reference's
// `tracing` crate call sites, which are compiled out of release builds
// (Cargo.toml:18-19) and dump per-pop state in the hot loops
// (ksparse.rs:182,189-190,216,232,246-248; symmetric.rs:406-407,
// 465-467).  SLAP_NATIVE_TRACE=1: per-phase summaries; =2: every-K-pop
// state lines (K = SLAP_NATIVE_TRACE_EVERY, default 65536); =3: every
// pop.  The level latches on first use; when unset the per-pop cost is
// one predicted-not-taken branch on a hoisted bool — no measurable
// delta on the ~70 ns/pop loops (verified against baseline_cpu rows).
inline int trace_level() {
  static const int level = [] {
    const char* e = std::getenv("SLAP_NATIVE_TRACE");
    return e ? std::atoi(e) : 0;
  }();
  return level;
}

inline int64_t trace_every() {
  static const int64_t every = [] {
    const char* e = std::getenv("SLAP_NATIVE_TRACE_EVERY");
    const int64_t v = e ? std::atoll(e) : 65536;
    return v > 0 ? v : 65536;
  }();
  return every;
}

// Best and second-best profit over one person's arcs.
struct Choice {
  double best_profit = kNegInf;
  double second_profit = kNegInf;
  double best_value = kNegInf;
  int32_t best_col = 0;
};

inline Choice scan_row(const int64_t* starts, const int32_t* cols,
                       const double* vals, const double* prices, int64_t u) {
  Choice c;
  for (int64_t a = starts[u]; a < starts[u + 1]; ++a) {
    const int32_t j = cols[a];
    const double value = vals[a];
    const double profit = value - prices[j];
    if (profit > c.best_profit) {
      c.second_profit = c.best_profit;
      c.best_profit = profit;
      c.best_value = value;
      c.best_col = j;
    } else if (profit > c.second_profit) {
      c.second_profit = profit;
    }
  }
  return c;
}

bool ecs_holds(int64_t n_rows, const int64_t* starts, const int32_t* cols,
               const double* vals, const double* prices, const int32_t* p2o,
               double eps, double tol) {
  for (int64_t i = 0; i < n_rows; ++i) {
    const int32_t j = p2o[i];
    double chosen = kNegInf;
    for (int64_t a = starts[i]; a < starts[i + 1]; ++a) {
      if (cols[a] == j) chosen = vals[a];
    }
    const double lhs = chosen - prices[j] + tol;
    for (int64_t a = starts[i]; a < starts[i + 1]; ++a) {
      if (lhs < vals[a] - prices[cols[a]] - eps) return false;
    }
  }
  return true;
}

// First-argmax top-2 of profit[j] = v[j] − p[j] over a dense row, in
// three vectorizable passes — the branchy single-pass top-2 defeats
// SIMD and the dense chain tail is scan-bound, so pop cost is pass
// count × bandwidth.  Semantics match the scalar loop exactly: best
// index = FIRST argmax, second = max over the remaining lanes (so a
// duplicated max yields second == best).
struct DenseTop2 {
  double best;
  double second;
  int64_t arg;
};

template <typename V>
inline DenseTop2 dense_top2(const V* __restrict v,
                            const double* __restrict p, int64_t len,
                            double sign) {
  double m1 = kNegInf;
#pragma omp simd reduction(max : m1)
  for (int64_t j = 0; j < len; ++j) {
    const double t = sign * static_cast<double>(v[j]) - p[j];
    m1 = t > m1 ? t : m1;
  }
  int64_t arg = 0;
  for (int64_t j = 0; j < len; ++j) {
    if (sign * static_cast<double>(v[j]) - p[j] == m1) {
      arg = j;
      break;
    }
  }
  double m2 = kNegInf;
#pragma omp simd reduction(max : m2)
  for (int64_t j = 0; j < arg; ++j) {
    const double t = sign * static_cast<double>(v[j]) - p[j];
    m2 = t > m2 ? t : m2;
  }
#pragma omp simd reduction(max : m2)
  for (int64_t j = arg + 1; j < len; ++j) {
    const double t = sign * static_cast<double>(v[j]) - p[j];
    m2 = t > m2 ? t : m2;
  }
  return {m1, m2, arg};
}

}  // namespace

extern "C" {

// Sequential Khosla auction from a warm state: prices / p2o / o2p /
// dropped arrive pre-populated (e.g. from the TPU bulk phases) and only
// the remaining unassigned, undropped people are auctioned.  The price
// threshold is passed explicitly so ε-scaling ladders can phase it.
int slap_khosla_finish(int64_t n_rows, int64_t n_cols, const int64_t* starts,
                       const int32_t* cols, const double* vals, double eps,
                       double threshold, int32_t* p2o, int32_t* o2p,
                       double* prices, uint8_t* dropped, int64_t* nits_out) {
  std::vector<int32_t> stack;
  stack.reserve(n_rows);
  for (int64_t i = n_rows - 1; i >= 0; --i) {
    if (p2o[i] < 0 && !dropped[i]) stack.push_back(static_cast<int32_t>(i));
  }

  const int tr = trace_level();  // hoisted: zero-cost branch when 0
  const int64_t tr_k = trace_every();
  if (tr >= 1) {
    std::fprintf(stderr,
                 "[slap.native] khosla_finish start: n=%lld m=%lld "
                 "warm_free=%zu eps=%g threshold=%g\n",
                 (long long)n_rows, (long long)n_cols, stack.size(),
                 eps, threshold);
  }

  int64_t nits = 0;
  while (!stack.empty()) {
    const int32_t u = stack.back();
    stack.pop_back();
    ++nits;

    const Choice c = scan_row(starts, cols, vals, prices, u);
    const int32_t v = c.best_col;
    if (tr >= 3 || (tr == 2 && nits % tr_k == 0)) {
      // per-pop state dump (ksparse.rs:189-190,216: person, choice,
      // best/second profit, current price of the chosen object)
      std::fprintf(stderr,
                   "[slap.native] pop=%lld u=%d v=%d best=%g second=%g "
                   "price_v=%g stack=%zu\n",
                   (long long)nits, u, v, c.best_profit, c.second_profit,
                   prices[v], stack.size());
    }
    if (prices[v] > threshold) {
      dropped[u] = 1;  // drop rule: u stays unassigned
      if (tr >= 2) {
        std::fprintf(stderr,
                     "[slap.native] pop=%lld DROP u=%d (price %g > "
                     "threshold %g)\n",
                     (long long)nits, u, prices[v], threshold);
      }
      continue;
    }

    if (std::isfinite(c.second_profit)) {
      prices[v] = c.best_value - c.second_profit + eps;
    } else {
      prices[v] += eps;
    }

    const int32_t displaced = o2p[v];
    if (displaced >= 0) {
      p2o[displaced] = -1;
      stack.push_back(displaced);
    }
    p2o[u] = v;
    o2p[v] = u;
  }
  if (tr >= 1) {
    int64_t unassigned = 0;
    for (int64_t i = 0; i < n_rows; ++i) unassigned += p2o[i] < 0;
    std::fprintf(stderr,
                 "[slap.native] khosla_finish done: pops=%lld "
                 "unassigned=%lld\n",
                 (long long)nits, (long long)unassigned);
  }
  *nits_out = nits;
  return 0;
}

// Sequential Khosla auction.  Returns 0 on success.
int slap_khosla_solve(int64_t n_rows, int64_t n_cols, const int64_t* starts,
                      const int32_t* cols, const double* vals, double eps,
                      int32_t* p2o, int32_t* o2p, double* prices,
                      int64_t* nits_out) {
  for (int64_t i = 0; i < n_rows; ++i) p2o[i] = -1;
  for (int64_t j = 0; j < n_cols; ++j) {
    o2p[j] = -1;
    prices[j] = 0.0;
  }

  double w_min = kPosInf, w_max = kNegInf;
  const int64_t nnz = starts[n_rows];
  for (int64_t a = 0; a < nnz; ++a) {
    if (vals[a] < w_min) w_min = vals[a];
    if (vals[a] > w_max) w_max = vals[a];
  }
  const double threshold =
      (static_cast<double>(n_cols) / 2.0) * (w_max - w_min + eps);

  std::vector<int32_t> stack;
  stack.reserve(n_rows);
  for (int64_t i = n_rows - 1; i >= 0; --i)
    stack.push_back(static_cast<int32_t>(i));

  const int tr = trace_level();  // hoisted: zero-cost branch when 0
  const int64_t tr_k = trace_every();
  if (tr >= 1) {
    // pre-loop state (ksparse.rs:182: eps, w span, threshold)
    std::fprintf(stderr,
                 "[slap.native] khosla_solve start: n=%lld m=%lld "
                 "arcs=%lld eps=%g w_span=[%g,%g] threshold=%g\n",
                 (long long)n_rows, (long long)n_cols, (long long)nnz,
                 eps, w_min, w_max, threshold);
  }

  int64_t nits = 0;
  while (!stack.empty()) {
    const int32_t u = stack.back();
    stack.pop_back();
    ++nits;

    const Choice c = scan_row(starts, cols, vals, prices, u);
    const int32_t v = c.best_col;
    if (tr >= 3 || (tr == 2 && nits % tr_k == 0)) {
      // per-pop state dump (ksparse.rs:189-190,216)
      std::fprintf(stderr,
                   "[slap.native] pop=%lld u=%d v=%d best=%g second=%g "
                   "price_v=%g stack=%zu\n",
                   (long long)nits, u, v, c.best_profit, c.second_profit,
                   prices[v], stack.size());
    }
    if (prices[v] > threshold) {
      if (tr >= 2) {
        std::fprintf(stderr,
                     "[slap.native] pop=%lld DROP u=%d (price %g > "
                     "threshold %g)\n",
                     (long long)nits, u, prices[v], threshold);
      }
      continue;  // drop rule: u stays unassigned
    }

    if (std::isfinite(c.second_profit)) {
      prices[v] = c.best_value - c.second_profit + eps;
    } else {
      prices[v] += eps;
    }

    const int32_t displaced = o2p[v];
    if (displaced >= 0) {
      p2o[displaced] = -1;
      stack.push_back(displaced);
    }
    p2o[u] = v;
    o2p[v] = u;
  }
  if (tr >= 1) {
    // final summary (ksparse.rs:246-248: nits, unassigned count)
    int64_t unassigned = 0;
    for (int64_t i = 0; i < n_rows; ++i) unassigned += p2o[i] < 0;
    std::fprintf(stderr,
                 "[slap.native] khosla_solve done: pops=%lld "
                 "unassigned=%lld\n",
                 (long long)nits, (long long)unassigned);
  }
  *nits_out = nits;
  return 0;
}

// Blocked sign-applying f64→f32 transpose: dst[j*n + i] = sign *
// src[i*m + j].  The chain tail's reverse scans need object-major
// access; a numpy `(-a).T.astype(f32)` pays a full f64 negation copy
// plus a strided transpose (~1-2 s at 8192²) — this fuses both at
// streaming speed.
void slap_negate_transpose_f32(const double* src, int64_t n, int64_t m,
                               double sign, float* dst) {
  constexpr int64_t B = 64;
  for (int64_t ib = 0; ib < n; ib += B) {
    const int64_t ie = ib + B < n ? ib + B : n;
    for (int64_t jb = 0; jb < m; jb += B) {
      const int64_t je = jb + B < m ? jb + B : m;
      for (int64_t i = ib; i < ie; ++i) {
        const double* __restrict s = src + i * m;
        for (int64_t j = jb; j < je; ++j) {
          dst[j * n + i] = static_cast<float>(sign * s[j]);
        }
      }
    }
  }
}

// Sequential combined forward-reverse auction on one dense instance,
// continued from a warm state — the chain-tail engine for the
// streaming-kernel big singles (batch.py `use_big`).  The device runs
// the massively parallel bulk rounds; the endgame is displacement
// chains that a lockstep device round walks one link per ~0.1 ms
// round, while this walks a link in one O(n) scan (~n ns).  The rules
// mirror the device engine's (ops/fr_dense.py _forward_sub /
// _reverse_sub with a single bidder, after Bertsekas & Castanon's
// combined algorithm), including the stalled-phase preemption with
// doubling horizon, so the handoff preserves the same eps-CS
// certificate: assigned pairs keep pi_i + p_j = a_ij and reverse
// price cuts stop at the second-best reverse profit, which bounds any
// other person's profit gain by pi_i + eps.
//
// a:  [n*m] row-major f64 person-row profit values (sign-adjusted for
//     maximization, like every engine here).
// at: [m*n] row-major f32 object-row values (the transpose — column
//     scans on `a` would stride the cache; f32 is exact for
//     integer-valued costs and within value rounding otherwise).
// prices[m] / profits[n] f64 and p2o[n] / o2p[m] int32 (-1 sentinel)
// are the warm state, updated in place.  Returns 0 on a complete
// matching, 1 if max_pops was hit first.
int slap_fr_dense_finish(int64_t n, int64_t m, const double* a,
                         double sign, const float* at, double eps,
                         double* prices, double* profits, int32_t* p2o,
                         int32_t* o2p, int64_t max_pops,
                         int64_t* pops_out) {
  std::vector<int32_t> free_p, free_o;
  int64_t cardinality = 0;
  for (int64_t i = n - 1; i >= 0; --i) {
    if (p2o[i] < 0) free_p.push_back(static_cast<int32_t>(i));
    else ++cardinality;
  }
  for (int64_t j = m - 1; j >= 0; --j) {
    if (o2p[j] < 0) free_o.push_back(static_cast<int32_t>(j));
  }

  const int tr = trace_level();  // hoisted: zero-cost branch when 0
  const int64_t tr_k = trace_every();
  if (tr >= 1) {
    std::fprintf(stderr,
                 "[slap.native] fr_dense_finish start: n=%lld m=%lld "
                 "cardinality=%lld free_p=%zu free_o=%zu eps=%g\n",
                 (long long)n, (long long)m, (long long)cardinality,
                 free_p.size(), free_o.size(), eps);
  }

  bool forward = true;
  int64_t since_inc = 0, stall_k = 8, pops = 0;
  while (cardinality < n) {
    if (tr >= 3 || (tr == 2 && pops > 0 && pops % tr_k == 0)) {
      std::fprintf(stderr,
                   "[slap.native] fr pop=%lld mode=%s cardinality=%lld "
                   "stall_k=%lld\n",
                   (long long)pops, forward ? "fwd" : "rev",
                   (long long)cardinality, (long long)stall_k);
    }
    if (pops >= max_pops) {
      *pops_out = pops;
      return 1;
    }
    bool increased = false;
    if (forward) {
      // pop a live free person (stack entries go stale when a reverse
      // bid assigns the person first)
      int32_t u = -1;
      while (!free_p.empty()) {
        const int32_t c = free_p.back();
        free_p.pop_back();
        if (p2o[c] < 0) { u = c; break; }
      }
      if (u < 0) { forward = false; continue; }  // all chains on the object side
      const double* row = a + static_cast<int64_t>(u) * m;
      const DenseTop2 t2 = dense_top2(row, prices, m, sign);
      const double w1 = t2.best, w2 = t2.second;
      const int32_t jbest = static_cast<int32_t>(t2.arg);
      const double floor = std::isfinite(w2) ? w2 : w1;
      const int32_t prev = o2p[jbest];
      prices[jbest] = sign * row[jbest] - floor + eps;  // pi + p = a exactly
      profits[u] = floor - eps;
      p2o[u] = jbest;
      o2p[jbest] = u;
      if (prev >= 0) {
        p2o[prev] = -1;
        free_p.push_back(prev);
      } else {
        ++cardinality;
        increased = true;
      }
      ++pops;
    } else {
      int32_t j = -1;
      while (!free_o.empty()) {
        const int32_t c = free_o.back();
        free_o.pop_back();
        if (o2p[c] < 0) { j = c; break; }
      }
      if (j < 0) { forward = true; continue; }
      const float* col = at + static_cast<int64_t>(j) * n;
      const DenseTop2 t2 = dense_top2(col, profits, n, 1.0);
      const double b1 = t2.best, b2 = t2.second;
      const int32_t ibest = static_cast<int32_t>(t2.arg);
      const double rfloor = std::isfinite(b2) ? b2 : b1;
      const int32_t prevj = p2o[ibest];
      prices[j] = rfloor - eps;
      // the new pair's dual from the f64 row values so pi + p = a
      profits[ibest] =
          sign * a[static_cast<int64_t>(ibest) * m + j] - rfloor + eps;
      p2o[ibest] = j;
      o2p[j] = ibest;
      if (prevj >= 0) {
        o2p[prevj] = -1;
        free_o.push_back(prevj);
      } else {
        ++cardinality;
        increased = true;
      }
      ++pops;
    }
    // mode switching: flip on a cardinality increase (fresh horizon) or
    // after stall_k no-progress pops (horizon doubles — the device
    // engine's exponential-backoff preemption, fr_dense.py)
    if (increased) {
      forward = !forward;
      since_inc = 0;
      stall_k = 8;
    } else if (++since_inc >= stall_k) {
      forward = !forward;
      since_inc = 0;
      stall_k *= 2;
    }
  }
  if (tr >= 1) {
    std::fprintf(stderr,
                 "[slap.native] fr_dense_finish done: pops=%lld "
                 "cardinality=%lld\n",
                 (long long)pops, (long long)cardinality);
  }
  *pops_out = pops;
  return 0;
}

// Sequential eps-scaling forward auction.  start_eps < 0 means "none".
int slap_forward_solve(int64_t n_rows, int64_t n_cols, const int64_t* starts,
                       const int32_t* cols, const double* vals,
                       double target_eps, double start_eps,
                       int64_t max_iterations, int32_t* p2o, int32_t* o2p,
                       double* prices, int64_t* nits_out,
                       int64_t* nreductions_out, int32_t* optimal_out,
                       double* final_eps_out) {
  for (int64_t i = 0; i < n_rows; ++i) p2o[i] = -1;
  for (int64_t j = 0; j < n_cols; ++j) {
    o2p[j] = -1;
    prices[j] = 0.0;
  }

  const int64_t nnz = starts[n_rows];
  double c_max = 0.0;
  for (int64_t a = 0; a < nnz; ++a) c_max = std::max(c_max, std::fabs(vals[a]));
  // ulp-scale certificate tolerance (reference get_toleration)
  int exp2 = static_cast<int>(std::log2(c_max + 1e-7));
  if (exp2 < 0) exp2 = 0;
  const double tol = std::ldexp(1.0, exp2 - 53);

  bool from_optimal_eps = start_eps >= 0.0 && start_eps < target_eps;
  double eps;
  if (n_rows != n_cols) {
    from_optimal_eps = true;  // no eps-scaling for asymmetric instances
    eps = target_eps - std::numeric_limits<double>::epsilon();
  } else {
    eps = start_eps >= 0.0 ? start_eps : c_max / 2.0;
  }

  std::vector<double> best_bid(n_cols, kNegInf);
  std::vector<int32_t> best_bidder(n_cols, -1);
  std::vector<int32_t> unassigned;
  unassigned.reserve(n_rows);
  for (int64_t i = 0; i < n_rows; ++i)
    unassigned.push_back(static_cast<int32_t>(i));

  int64_t nits = 0, nreductions = 0;
  bool optimal = false;

  const int tr = trace_level();  // hoisted: zero-cost branch when 0
  const int64_t tr_k = trace_every();
  if (tr >= 1) {
    // phase entry (symmetric.rs:247,249,264: C, eps schedule, target)
    std::fprintf(stderr,
                 "[slap.native] forward_solve start: n=%lld m=%lld "
                 "arcs=%lld c_max=%g start_eps=%g target_eps=%g "
                 "scaling=%d\n",
                 (long long)n_rows, (long long)n_cols, (long long)nnz,
                 c_max, eps, target_eps, from_optimal_eps ? 0 : 1);
  }

  while (true) {
    // --- one Jacobi round: every unassigned person bids ---
    std::vector<int32_t> touched;
    touched.reserve(unassigned.size());
    for (const int32_t i : unassigned) {
      const Choice ch = scan_row(starts, cols, vals, prices, i);
      if (ch.best_profit == kNegInf) continue;  // nothing biddable
      double bid = ch.best_value - ch.second_profit + eps;  // may be +inf
      const int32_t j = ch.best_col;
      if (bid > best_bid[j]) {
        if (best_bidder[j] < 0) touched.push_back(j);
        best_bid[j] = bid;
        best_bidder[j] = i;
      }
    }
    for (const int32_t j : touched) {
      const int32_t i = best_bidder[j];
      prices[j] = best_bid[j];
      const int32_t prev = o2p[j];
      if (prev >= 0) p2o[prev] = -1;
      p2o[i] = j;
      o2p[j] = i;
      best_bid[j] = kNegInf;
      best_bidder[j] = -1;
    }
    unassigned.clear();
    for (int64_t i = 0; i < n_rows; ++i) {
      if (p2o[i] < 0) unassigned.push_back(static_cast<int32_t>(i));
    }
    ++nits;
    if (tr >= 3 || (tr == 2 && nits % tr_k == 0)) {
      // per-round state (symmetric.rs:406-407,465-467: round,
      // unassigned count, current eps)
      std::fprintf(stderr,
                   "[slap.native] fwd round=%lld unassigned=%zu eps=%g\n",
                   (long long)nits, unassigned.size(), eps);
    }

    if (unassigned.empty()) {
      const bool is_optimal =
          from_optimal_eps ||
          ecs_holds(n_rows, starts, cols, vals, prices, p2o, target_eps, tol);
      if (is_optimal) {
        optimal = true;
        break;
      }
      if (eps < target_eps) break;  // optimal for eps < 1/n
      eps *= 0.15;
      ++nreductions;
      if (tr >= 1) {
        // ε-reduction event (symmetric.rs:297: kept prices, new eps)
        std::fprintf(stderr,
                     "[slap.native] fwd eps-reduction %lld: eps=%g "
                     "after round %lld\n",
                     (long long)nreductions, eps, (long long)nits);
      }
      for (int64_t i = 0; i < n_rows; ++i) p2o[i] = -1;
      for (int64_t j = 0; j < n_cols; ++j) o2p[j] = -1;
      unassigned.clear();
      for (int64_t i = 0; i < n_rows; ++i)
        unassigned.push_back(static_cast<int32_t>(i));
    }
    if (nits >= max_iterations) break;
  }

  if (tr >= 1) {
    std::fprintf(stderr,
                 "[slap.native] forward_solve done: rounds=%lld "
                 "reductions=%lld optimal=%d final_eps=%g\n",
                 (long long)nits, (long long)nreductions,
                 optimal ? 1 : 0, eps);
  }
  *nits_out = nits;
  *nreductions_out = nreductions;
  *optimal_out = optimal ? 1 : 0;
  *final_eps_out = eps;
  return 0;
}

}  // extern "C"
