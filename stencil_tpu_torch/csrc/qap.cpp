// Native quadratic-assignment solvers for topology-aware placement.
//
// Host code of the PyTorch port (a copy of the JAX package's
// csrc/qap.cpp): the reference's qap namespace
// (reference: include/stencil/qap.hpp:51-180), an exact brute-force
// search over permutations with a wall-clock timeout, and a greedy
// pairwise-swap hill climb with incremental cost updates. Exposed as a
// C ABI consumed from Python via ctypes (stencil_tpu_torch/qap.py);
// built with g++, not nvcc.
//
// Cost model: cost(f) = sum_{a,b} w[a][b] * d[f[a]][f[b]], with the
// convention that 0 * inf == 0 (the reference's cost-product rule,
// qap.hpp:16-21).

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

using Perm = std::vector<int64_t>;

// one term of the objective; zero traffic over an unreachable link
// costs nothing (0 * inf == 0)
inline double weighted_hop(double traffic, double hops) {
  if (traffic == 0 || hops == 0) return 0;
  return traffic * hops;
}

double total_cost(int64_t n, const double *w, const double *d,
                  const Perm &f) {
  double acc = 0;
  for (int64_t a = 0; a < n; ++a)
    for (int64_t b = 0; b < n; ++b)
      acc += weighted_hop(w[a * n + b], d[f[a] * n + f[b]]);
  return acc;
}

// Sum of every objective term that involves subdomain i or j under
// permutation f — exactly the terms a swap of f[i]/f[j] changes.
double pair_terms(int64_t n, const double *w, const double *d,
                  const Perm &f, int64_t i, int64_t j) {
  double acc = 0;
  for (int64_t k = 0; k < n; ++k) {
    acc += weighted_hop(w[i * n + k], d[f[i] * n + f[k]]);
    acc += weighted_hop(w[j * n + k], d[f[j] * n + f[k]]);
    if (k != i && k != j) {
      acc += weighted_hop(w[k * n + i], d[f[k] * n + f[i]]);
      acc += weighted_hop(w[k * n + j], d[f[k] * n + f[j]]);
    }
  }
  return acc;
}

Perm identity(int64_t n) {
  Perm f(n);
  for (int64_t i = 0; i < n; ++i) f[i] = i;
  return f;
}

}  // namespace

extern "C" {

// Exact search: all permutations, best kept; stops after timeout_s
// seconds of wall clock (reference qap::solve uses a fixed 10 s cap).
// Returns the best cost found; writes the permutation into out_f.
double qap_solve_exact(int64_t n, const double *w, const double *d,
                       int64_t *out_f, double timeout_s) {
  using Clock = std::chrono::steady_clock;
  const auto deadline =
      Clock::now() + std::chrono::duration_cast<Clock::duration>(
                         std::chrono::duration<double>(timeout_s));
  Perm f = identity(n);
  Perm winner = f;
  double winner_cost = total_cost(n, w, d, f);
  uint64_t tick = 0;
  while (std::next_permutation(f.begin(), f.end())) {
    // poll the clock every 1024 permutations, not every one
    if ((++tick & 0x3FF) == 0 && Clock::now() > deadline) break;
    const double c = total_cost(n, w, d, f);
    if (c < winner_cost) {
      winner_cost = c;
      winner = f;
    }
  }
  std::copy(winner.begin(), winner.end(), out_f);
  return winner_cost;
}

// Greedy pairwise-swap hill climb (the reference's qap::solve_catch,
// qap.hpp:87-180, restructured): each round tries every (i, j) swap of
// the current assignment, scoring candidates incrementally by removing
// the terms the swap touches and re-adding them post-swap; the round's
// best strictly-improving swap is adopted until a fixpoint.
double qap_solve_catch(int64_t n, const double *w, const double *d,
                       int64_t *out_f) {
  Perm assign = identity(n);
  double assign_cost = total_cost(n, w, d, assign);

  for (;;) {
    Perm round_best = assign;
    double round_cost = assign_cost;
    for (int64_t i = 0; i < n; ++i) {
      for (int64_t j = i + 1; j < n; ++j) {
        Perm trial = assign;
        double c = assign_cost - pair_terms(n, w, d, trial, i, j);
        std::swap(trial[i], trial[j]);
        c += pair_terms(n, w, d, trial, i, j);
        // inf - inf = NaN: the incremental update is invalid when
        // unreachable-link terms are involved; recompute from scratch
        if (!std::isfinite(c)) c = total_cost(n, w, d, trial);
        if (c < round_cost) {
          round_best = std::move(trial);
          round_cost = c;
        }
      }
    }
    if (round_cost >= assign_cost) break;  // fixpoint
    assign = std::move(round_best);
    assign_cost = round_cost;
  }

  std::copy(assign.begin(), assign.end(), out_f);
  return assign_cost;
}

double qap_cost(int64_t n, const double *w, const double *d,
                const int64_t *f) {
  return total_cost(n, w, d, Perm(f, f + n));
}

}  // extern "C"
