// Reference float64 box-LP interior-point solver (CPU, C++).
//
// Solves  min c'x  s.t.  A x = b,  l <= x <= u  with a Mehrotra
// predictor-corrector primal-dual interior-point method — the same
// algorithm as the device engine (engines/lp_ipm.py) but in double
// precision with convergence-based termination. It is the trusted native
// oracle the batched f32 device solver is diffed against in tests (SURVEY.md §2.4: the
// reference suite leaned on MATPOWER's MIPS interior-point solver;
// this plays MIPS's role for verification).
//
// Build:  g++ -O2 -shared -fPIC -o libboxlp.so box_lp_ipm.cpp
// ABI: plain C, dense row-major arrays.

#include <cmath>
#include <cstring>
#include <vector>

namespace {

// Dense Cholesky factorization (in place, lower). Returns false if not PD.
bool cholesky(std::vector<double>& M, int n) {
  for (int j = 0; j < n; ++j) {
    double d = M[j * n + j];
    for (int k = 0; k < j; ++k) d -= M[j * n + k] * M[j * n + k];
    if (d <= 0.0) return false;
    const double L = std::sqrt(d);
    M[j * n + j] = L;
    for (int i = j + 1; i < n; ++i) {
      double s = M[i * n + j];
      for (int k = 0; k < j; ++k) s -= M[i * n + k] * M[j * n + k];
      M[i * n + j] = s / L;
    }
  }
  return true;
}

void cho_solve(const std::vector<double>& L, int n, double* x) {
  for (int i = 0; i < n; ++i) {
    double s = x[i];
    for (int k = 0; k < i; ++k) s -= L[i * n + k] * x[k];
    x[i] = s / L[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    double s = x[i];
    for (int k = i + 1; k < n; ++k) s -= L[k * n + i] * x[k];
    x[i] = s / L[i * n + i];
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, 1 if iteration limit hit without convergence,
// 2 on factorization failure.
int solve_box_lp_f64(const double* c, const double* A, const double* b,
                     const double* l, const double* u, int m, int n,
                     int max_iters, double tol, double* x_out,
                     double* obj_out) {
  std::vector<double> x(n), y(m, 0.0), zl(n, 1.0), zu(n, 1.0);
  for (int i = 0; i < n; ++i) x[i] = 0.5 * (l[i] + u[i]);

  std::vector<double> sl(n), su(n), d(n), rd(n), rp(m), rhat(n), rhs(m);
  std::vector<double> M(m * m), dx(n), dy(m), dzl(n), dzu(n);
  std::vector<double> dxa(n), dya(m), dzla(n), dzua(n);
  const double kTau = 0.9995;

  int status = 1;
  for (int it = 0; it < max_iters; ++it) {
    for (int i = 0; i < n; ++i) {
      sl[i] = std::max(x[i] - l[i], 1e-14);
      su[i] = std::max(u[i] - x[i], 1e-14);
    }
    // residuals
    for (int i = 0; i < n; ++i) {
      double aty = 0.0;
      for (int r = 0; r < m; ++r) aty += A[r * n + i] * y[r];
      rd[i] = c[i] - aty - zl[i] + zu[i];
    }
    double rp_inf = 0.0;
    for (int r = 0; r < m; ++r) {
      double ax = 0.0;
      for (int i = 0; i < n; ++i) ax += A[r * n + i] * x[i];
      rp[r] = b[r] - ax;
      rp_inf = std::max(rp_inf, std::fabs(rp[r]));
    }
    double mu = 0.0;
    for (int i = 0; i < n; ++i) mu += sl[i] * zl[i] + su[i] * zu[i];
    mu /= 2.0 * n;
    if (mu < tol && rp_inf < tol) { status = 0; break; }

    for (int i = 0; i < n; ++i) d[i] = zl[i] / sl[i] + zu[i] / su[i];
    // M = A D^-1 A' + delta I
    for (int r = 0; r < m; ++r)
      for (int s2 = 0; s2 <= r; ++s2) {
        double acc = 0.0;
        for (int i = 0; i < n; ++i)
          acc += A[r * n + i] * A[s2 * n + i] / d[i];
        M[r * m + s2] = acc;
        M[s2 * m + r] = acc;
      }
    for (int r = 0; r < m; ++r) M[r * m + r] += 1e-10;
    std::vector<double> L = M;
    if (!cholesky(L, m)) return 2;

    auto newton = [&](const double* rcl, const double* rcu, double* ddx,
                      double* ddy, double* ddzl, double* ddzu) {
      for (int i = 0; i < n; ++i)
        rhat[i] = rd[i] - rcl[i] / sl[i] + rcu[i] / su[i];
      for (int r = 0; r < m; ++r) {
        double acc = rp[r];
        for (int i = 0; i < n; ++i)
          acc += A[r * n + i] * rhat[i] / d[i];
        rhs[r] = acc;
      }
      std::memcpy(ddy, rhs.data(), m * sizeof(double));
      cho_solve(L, m, ddy);
      for (int i = 0; i < n; ++i) {
        double aty = 0.0;
        for (int r = 0; r < m; ++r) aty += A[r * n + i] * ddy[r];
        ddx[i] = (aty - rhat[i]) / d[i];
        ddzl[i] = (rcl[i] - zl[i] * ddx[i]) / sl[i];
        ddzu[i] = (rcu[i] + zu[i] * ddx[i]) / su[i];
      }
    };
    auto max_step = [&](const double* ddx, const double* ddzl,
                        const double* ddzu, double* ap, double* ad) {
      double a_p = 1.0 / kTau, a_d = 1.0 / kTau;
      for (int i = 0; i < n; ++i) {
        if (ddx[i] < 0) a_p = std::min(a_p, -sl[i] / ddx[i]);
        if (ddx[i] > 0) a_p = std::min(a_p, su[i] / ddx[i]);
        if (ddzl[i] < 0) a_d = std::min(a_d, -zl[i] / ddzl[i]);
        if (ddzu[i] < 0) a_d = std::min(a_d, -zu[i] / ddzu[i]);
      }
      *ap = std::min(kTau * a_p, 1.0);
      *ad = std::min(kTau * a_d, 1.0);
    };

    // affine
    std::vector<double> rcl(n), rcu(n);
    for (int i = 0; i < n; ++i) { rcl[i] = -sl[i] * zl[i]; rcu[i] = -su[i] * zu[i]; }
    newton(rcl.data(), rcu.data(), dxa.data(), dya.data(), dzla.data(),
           dzua.data());
    double apa, ada;
    max_step(dxa.data(), dzla.data(), dzua.data(), &apa, &ada);
    double mu_aff = 0.0;
    for (int i = 0; i < n; ++i)
      mu_aff += (sl[i] + apa * dxa[i]) * (zl[i] + ada * dzla[i])
              + (su[i] - apa * dxa[i]) * (zu[i] + ada * dzua[i]);
    mu_aff /= 2.0 * n;
    double sigma = std::pow(mu_aff / mu, 3);
    sigma = std::min(std::max(sigma, 0.0), 1.0);

    // corrector
    for (int i = 0; i < n; ++i) {
      rcl[i] = sigma * mu - sl[i] * zl[i] - dxa[i] * dzla[i];
      rcu[i] = sigma * mu - su[i] * zu[i] + dxa[i] * dzua[i];
    }
    newton(rcl.data(), rcu.data(), dx.data(), dy.data(), dzl.data(),
           dzu.data());
    double ap, ad;
    max_step(dx.data(), dzl.data(), dzu.data(), &ap, &ad);
    for (int i = 0; i < n; ++i) {
      x[i] += ap * dx[i];
      zl[i] = std::max(zl[i] + ad * dzl[i], 1e-14);
      zu[i] = std::max(zu[i] + ad * dzu[i], 1e-14);
    }
    for (int r = 0; r < m; ++r) y[r] += ad * dy[r];
  }

  double obj = 0.0;
  for (int i = 0; i < n; ++i) obj += c[i] * x[i];
  std::memcpy(x_out, x.data(), n * sizeof(double));
  *obj_out = obj;
  return status;
}

}  // extern "C"
