// Native C++ reference implementation of the box-DDP iLQR solve.
//
// Role in this framework (SURVEY.md §2 provenance note): the reference's
// native-code leverage was external (BLAS/cuBLAS through its array backend);
// ours is the Pallas GPU kernels for the hot path, plus this standalone
// double-precision C++ engine as (a) an independent parity oracle for the
// Python/JAX/Pallas solvers (tests/test_native_oracle.py) and (b) a
// dependency-free host-side solver for embedding.
//
// Algorithms implemented (same published recursions as the JAX engine;
// SURVEY.md §3.2):
//   - projected-Newton box QP with identity-masked Cholesky free-subspace
//     solves and a first-improving geometric step ladder,
//   - Riccati backward recursion in the delta-u formulation with clamped
//     gain rows zeroed,
//   - closed-loop rollout with a per-scenario alpha-ladder line search,
//   - fixed-point iteration with per-scenario best-trajectory tracking.
//
// Build: g++ -O2 -shared -fPIC -o libdiffmpc_native.so diffmpc_native.cpp
// (no external dependencies).

#include <cmath>
#include <cstring>
#include <vector>

namespace {

// Dense Cholesky of an SPD matrix (row-major, mm x mm), in place -> lower L.
bool cholesky(double* a, int mm, double reg) {
  for (int i = 0; i < mm; ++i) a[i * mm + i] += reg;
  for (int j = 0; j < mm; ++j) {
    double d = a[j * mm + j];
    for (int k = 0; k < j; ++k) d -= a[j * mm + k] * a[j * mm + k];
    if (d <= 0.0) return false;
    d = std::sqrt(d);
    a[j * mm + j] = d;
    for (int i = j + 1; i < mm; ++i) {
      double s = a[i * mm + j];
      for (int k = 0; k < j; ++k) s -= a[i * mm + k] * a[j * mm + k];
      a[i * mm + j] = s / d;
    }
  }
  return true;
}

// Solve A x = b given lower factor L (in a), overwrite b with x.
void cho_solve(const double* L, int mm, double* b) {
  for (int i = 0; i < mm; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i * mm + k] * b[k];
    b[i] = s / L[i * mm + i];
  }
  for (int i = mm - 1; i >= 0; --i) {
    double s = b[i];
    for (int k = i + 1; k < mm; ++k) s -= L[k * mm + i] * b[k];
    b[i] = s / L[i * mm + i];
  }
}

struct Work {
  std::vector<double> V, v, Q, q, Hm, rhs, K, kff, x, u, xt, ut, xb, ub;
};

double clampd(double x, double lo, double hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

}  // namespace

extern "C" {

// Solve one scenario's box-constrained iLQR on affine dynamics.
// Layouts (row-major):
//   C:  T * nm * nm      c: T * nm      F: T * n * nm    f: T * n
//   lo, hi: T * m (ignored if constrained == 0)
//   xs_out: T * n        us_out: T * m
// Returns the converged objective.
double diffmpc_solve_one(const double* C, const double* c, const double* F,
                         const double* f, const double* x_init, int T, int n,
                         int m, const double* lo, const double* hi,
                         int constrained, int ilqr_iter, int pnqp_iter,
                         double ls_decay, int ls_iter, double reg,
                         double* xs_out, double* us_out) {
  const int nm = n + m;
  // Fixed stack buffers below (tau[64], cd[64]) bound the problem size; the
  // oracle targets tiny systems (n+m <= ~8), so fail loudly past the limit
  // instead of silently overflowing the stack.
  if (nm > 64) return std::nan("");
  Work w;
  w.V.assign(n * n, 0.0);
  w.v.assign(n, 0.0);
  w.Q.assign(nm * nm, 0.0);
  w.q.assign(nm, 0.0);
  w.Hm.assign(m * m, 0.0);
  w.rhs.assign(m, 0.0);
  w.K.assign(T * m * n, 0.0);
  w.kff.assign(T * m, 0.0);
  w.x.assign(T * n, 0.0);
  w.u.assign(T * m, 0.0);
  w.xt.assign(T * n, 0.0);
  w.ut.assign(T * m, 0.0);
  w.xb.assign(T * n, 0.0);
  w.ub.assign(T * m, 0.0);

  auto rollout_cost = [&](const double* xs, const double* us) {
    double obj = 0.0;
    for (int t = 0; t < T; ++t) {
      double tau[64];
      for (int i = 0; i < n; ++i) tau[i] = xs[t * n + i];
      for (int i = 0; i < m; ++i) tau[n + i] = us[t * m + i];
      const double* Ct = C + t * nm * nm;
      const double* ct = c + t * nm;
      for (int i = 0; i < nm; ++i) {
        double Ctau = 0.0;
        for (int j = 0; j < nm; ++j) Ctau += Ct[i * nm + j] * tau[j];
        obj += (0.5 * Ctau + ct[i]) * tau[i];
      }
    }
    return obj;
  };

  auto advance = [&](int t, const double* xt, const double* ut, double* xn) {
    const double* Ft = F + t * n * nm;
    const double* ft = f + t * n;
    for (int i = 0; i < n; ++i) {
      double s = ft[i];
      for (int j = 0; j < n; ++j) s += Ft[i * nm + j] * xt[j];
      for (int j = 0; j < m; ++j) s += Ft[i * nm + n + j] * ut[j];
      xn[i] = s;
    }
  };

  // initial trajectory: zero controls
  std::memcpy(w.x.data(), x_init, n * sizeof(double));
  for (int t = 0; t < T - 1; ++t)
    advance(t, &w.x[t * n], &w.u[t * m], &w.x[(t + 1) * n]);
  double best = rollout_cost(w.x.data(), w.u.data());
  std::memcpy(w.xb.data(), w.x.data(), T * n * sizeof(double));
  std::memcpy(w.ub.data(), w.u.data(), T * m * sizeof(double));

  for (int it = 0; it < ilqr_iter; ++it) {
    // Riccati backward in delta-u form around (x, u)
    std::fill(w.V.begin(), w.V.end(), 0.0);
    std::fill(w.v.begin(), w.v.end(), 0.0);
    for (int t = T - 1; t >= 0; --t) {
      const double* Ct = C + t * nm * nm;
      const double* ct = c + t * nm;
      const double* Ft = F + t * n * nm;
      // c_delta = c + C tau_hat
      double tau[64], cd[64];
      for (int i = 0; i < n; ++i) tau[i] = w.x[t * n + i];
      for (int i = 0; i < m; ++i) tau[n + i] = w.u[t * m + i];
      for (int i = 0; i < nm; ++i) {
        double s = ct[i];
        for (int j = 0; j < nm; ++j) s += Ct[i * nm + j] * tau[j];
        cd[i] = s;
      }
      // Q = C + F' V F ; q = cd + F' v    (delta form: no f / V f terms)
      double W[64 * 8];  // W[k][j] = sum_l V[k][l] F[l][j], k<n, j<nm
      for (int k = 0; k < n; ++k)
        for (int j = 0; j < nm; ++j) {
          double s = 0.0;
          for (int l = 0; l < n; ++l) s += w.V[k * n + l] * Ft[l * nm + j];
          W[k * nm + j] = s;
        }
      for (int i = 0; i < nm; ++i) {
        for (int j = 0; j < nm; ++j) {
          double s = Ct[i * nm + j];
          for (int k = 0; k < n; ++k) s += Ft[k * nm + i] * W[k * nm + j];
          w.Q[i * nm + j] = s;
        }
        double s = cd[i];
        for (int k = 0; k < n; ++k) s += Ft[k * nm + i] * w.v[k];
        w.q[i] = s;
      }
      // symmetrize
      for (int i = 0; i < nm; ++i)
        for (int j = i + 1; j < nm; ++j) {
          double s = 0.5 * (w.Q[i * nm + j] + w.Q[j * nm + i]);
          w.Q[i * nm + j] = s;
          w.Q[j * nm + i] = s;
        }

      double* Kt = &w.K[t * m * n];
      double* kt = &w.kff[t * m];
      bool frozen[16] = {false};
      if (constrained) {
        // pnqp on Quu in delta-u coordinates
        double qlo[16], qhi[16], xq[16];
        for (int a = 0; a < m; ++a) {
          qlo[a] = lo[t * m + a] - w.u[t * m + a];
          qhi[a] = hi[t * m + a] - w.u[t * m + a];
        }
        // start from clamped Newton point
        double Lfull[256];
        for (int a = 0; a < m; ++a)
          for (int b = 0; b < m; ++b)
            Lfull[a * m + b] = w.Q[(n + a) * nm + (n + b)];
        cholesky(Lfull, m, reg);
        for (int a = 0; a < m; ++a) xq[a] = -w.q[n + a];
        cho_solve(Lfull, m, xq);
        for (int a = 0; a < m; ++a) xq[a] = clampd(xq[a], qlo[a], qhi[a]);
        for (int pit = 0; pit < pnqp_iter; ++pit) {
          double g[16];
          for (int a = 0; a < m; ++a) {
            double s = w.q[n + a];
            for (int b = 0; b < m; ++b)
              s += w.Q[(n + a) * nm + (n + b)] * xq[b];
            g[a] = s;
            frozen[a] = (xq[a] <= qlo[a] + 1e-10 && g[a] > 0) ||
                        (xq[a] >= qhi[a] - 1e-10 && g[a] < 0);
          }
          // masked system
          double Hm[256], dx[16];
          for (int a = 0; a < m; ++a)
            for (int b = 0; b < m; ++b)
              Hm[a * m + b] = (frozen[a] || frozen[b])
                                  ? (a == b ? 1.0 : 0.0)
                                  : w.Q[(n + a) * nm + (n + b)];
          cholesky(Hm, m, reg);
          for (int a = 0; a < m; ++a) dx[a] = frozen[a] ? 0.0 : -g[a];
          cho_solve(Hm, m, dx);
          // first-improving geometric ladder
          auto qobj = [&](const double* z) {
            double o = 0.0;
            for (int a = 0; a < m; ++a) {
              double Hz = 0.0;
              for (int b = 0; b < m; ++b)
                Hz += w.Q[(n + a) * nm + (n + b)] * z[b];
              o += (0.5 * Hz + w.q[n + a]) * z[a];
            }
            return o;
          };
          double f0 = qobj(xq), alpha = 1.0;
          bool moved = false;
          double cand[16];
          for (int ai = 0; ai < 8; ++ai) {
            for (int a = 0; a < m; ++a)
              cand[a] = clampd(xq[a] + alpha * dx[a], qlo[a], qhi[a]);
            if (qobj(cand) < f0) {
              std::memcpy(xq, cand, m * sizeof(double));
              moved = true;
              break;
            }
            alpha *= 0.5;
          }
          if (!moved) break;
        }
        // final active set + gains
        double g[16];
        for (int a = 0; a < m; ++a) {
          double s = w.q[n + a];
          for (int b = 0; b < m; ++b) s += w.Q[(n + a) * nm + (n + b)] * xq[b];
          g[a] = s;
          frozen[a] = (xq[a] <= qlo[a] + 1e-10 && g[a] > 0) ||
                      (xq[a] >= qhi[a] - 1e-10 && g[a] < 0);
          kt[a] = xq[a];
        }
      }
      // gains: solve (masked) Quu K = -Qux (and k for unconstrained)
      double Hm[256];
      for (int a = 0; a < m; ++a)
        for (int b = 0; b < m; ++b)
          Hm[a * m + b] = (constrained && (frozen[a] || frozen[b]))
                              ? (a == b ? 1.0 : 0.0)
                              : w.Q[(n + a) * nm + (n + b)];
      cholesky(Hm, m, reg);
      for (int j = 0; j < n; ++j) {
        double col[16];
        for (int a = 0; a < m; ++a)
          col[a] = (constrained && frozen[a]) ? 0.0 : -w.Q[(n + a) * nm + j];
        cho_solve(Hm, m, col);
        for (int a = 0; a < m; ++a) Kt[a * n + j] = col[a];
      }
      if (!constrained) {
        double col[16];
        for (int a = 0; a < m; ++a) col[a] = -w.q[n + a];
        cho_solve(Hm, m, col);
        for (int a = 0; a < m; ++a) kt[a] = col[a];
      }
      // V' and v'
      double Vn[64], vn[8];
      for (int i = 0; i < n; ++i) {
        for (int j = 0; j < n; ++j) {
          double s = w.Q[i * nm + j];
          for (int r = 0; r < m; ++r) {
            s += w.Q[i * nm + (n + r)] * Kt[r * n + j];
            s += Kt[r * n + i] * w.Q[(n + r) * nm + j];
            double QK = 0.0;
            for (int r2 = 0; r2 < m; ++r2)
              QK += w.Q[(n + r) * nm + (n + r2)] * Kt[r2 * n + j];
            s += Kt[r * n + i] * QK;
          }
          Vn[i * n + j] = s;
        }
        double s = w.q[i];
        for (int r = 0; r < m; ++r) {
          double Quuk = 0.0;
          for (int r2 = 0; r2 < m; ++r2)
            Quuk += w.Q[(n + r) * nm + (n + r2)] * kt[r2];
          s += w.Q[i * nm + (n + r)] * kt[r] +
               Kt[r * n + i] * (w.q[n + r] + Quuk);
        }
        vn[i] = s;
      }
      for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j)
          w.V[i * n + j] = 0.5 * (Vn[i * n + j] + Vn[j * n + i]);
      std::memcpy(w.v.data(), vn, n * sizeof(double));
    }

    // line-searched rollout
    bool accepted = false;
    double alpha = 1.0;
    for (int ai = 0; ai < ls_iter; ++ai) {
      std::memcpy(&w.xt[0], x_init, n * sizeof(double));
      for (int t = 0; t < T; ++t) {
        for (int a = 0; a < m; ++a) {
          double uu = w.u[t * m + a] + alpha * w.kff[t * m + a];
          for (int j = 0; j < n; ++j)
            uu += w.K[t * m * n + a * n + j] *
                  (w.xt[t * n + j] - w.x[t * n + j]);
          if (constrained) uu = clampd(uu, lo[t * m + a], hi[t * m + a]);
          w.ut[t * m + a] = uu;
        }
        if (t < T - 1)
          advance(t, &w.xt[t * n], &w.ut[t * m], &w.xt[(t + 1) * n]);
      }
      double obj = rollout_cost(w.xt.data(), w.ut.data());
      if (obj < best || ai == ls_iter - 1) {
        if (obj < best) {
          best = obj;
          std::memcpy(w.xb.data(), w.xt.data(), T * n * sizeof(double));
          std::memcpy(w.ub.data(), w.ut.data(), T * m * sizeof(double));
          accepted = true;
        }
        std::memcpy(w.x.data(), w.xt.data(), T * n * sizeof(double));
        std::memcpy(w.u.data(), w.ut.data(), T * m * sizeof(double));
        break;
      }
      alpha *= ls_decay;
    }
    (void)accepted;
  }

  std::memcpy(xs_out, w.xb.data(), T * n * sizeof(double));
  std::memcpy(us_out, w.ub.data(), T * m * sizeof(double));
  return best;
}

// Batched driver: scenario-major batch dim (arrays are (T, B, ...) like the
// Python engine; this entry takes per-scenario contiguous copies instead,
// i.e. (B, T, ...), to keep the C side simple).
void diffmpc_solve_batch(const double* C, const double* c, const double* F,
                         const double* f, const double* x_init, int T, int B,
                         int n, int m, const double* lo, const double* hi,
                         int constrained, int ilqr_iter, int pnqp_iter,
                         double ls_decay, int ls_iter, double reg,
                         double* xs_out, double* us_out, double* objs_out) {
  const int nm = n + m;
  for (int b = 0; b < B; ++b) {
    objs_out[b] = diffmpc_solve_one(
        C + (size_t)b * T * nm * nm, c + (size_t)b * T * nm,
        F + (size_t)b * T * n * nm, f + (size_t)b * T * n, x_init + b * n, T,
        n, m, lo ? lo + (size_t)b * T * m : nullptr,
        hi ? hi + (size_t)b * T * m : nullptr, constrained, ilqr_iter,
        pnqp_iter, ls_decay, ls_iter, reg, xs_out + (size_t)b * T * n,
        us_out + (size_t)b * T * m);
  }
}

}  // extern "C"
