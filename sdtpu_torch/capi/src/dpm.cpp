// The port's copy of csrc/libsdtpu/src/dpm.cpp (unchanged but for this line).
#include "dpm.h"

#include <cmath>

#include "errors.h"

namespace sdtpu {

DpmSolver::DpmSolver(int32_t train_steps, double lin_start, double lin_end)
    : train_steps_(train_steps) {
  if (train_steps < 2)
    SDTPU_THROW(SDTPU_INVALID_ARGUMENT, "train_steps must be >= 2");
  t_grid_.resize(train_steps);
  log_alpha_grid_.resize(train_steps);
  double s0 = std::sqrt(lin_start), s1 = std::sqrt(lin_end);
  double log_cumprod = 0.0;
  for (int32_t i = 0; i < train_steps; ++i) {
    double beta_sqrt = s0 + (s1 - s0) * i / (train_steps - 1);
    log_cumprod += std::log1p(-beta_sqrt * beta_sqrt);
    t_grid_[i] = double(i + 1) / train_steps;
    log_alpha_grid_[i] = 0.5 * log_cumprod;
  }
}

double DpmSolver::log_alpha_at(double t) const {
  if (t <= t_grid_.front()) return log_alpha_grid_.front();
  if (t >= t_grid_.back()) return log_alpha_grid_.back();
  // uniform grid -> O(1) bracket
  double pos = t * train_steps_ - 1.0;
  auto i = size_t(pos);
  if (i + 1 >= t_grid_.size()) i = t_grid_.size() - 2;
  double w = (t - t_grid_[i]) / (t_grid_[i + 1] - t_grid_[i]);
  return log_alpha_grid_[i] + w * (log_alpha_grid_[i + 1] - log_alpha_grid_[i]);
}

void DpmSolver::prepare(int32_t steps) {
  if (steps < 1) SDTPU_THROW(SDTPU_INVALID_ARGUMENT, "steps must be >= 1");
  steps_ = steps;
  std::vector<double> ts(steps + 1), lam(steps + 1), alpha(steps + 1),
      sigma(steps + 1);
  double t1 = 1.0, t0 = 1.0 / train_steps_;
  for (int32_t i = 0; i <= steps; ++i) {
    ts[i] = t1 + (t0 - t1) * i / steps;
    double la = log_alpha_at(ts[i]);
    alpha[i] = std::exp(la);
    sigma[i] = std::sqrt(1.0 - std::exp(2.0 * la));
    lam[i] = la - 0.5 * std::log(1.0 - std::exp(2.0 * la));
  }
  model_ts_.resize(steps);
  inv_alpha_s_.resize(steps);
  sigma_s_.resize(steps);
  sigma_ratio_.resize(steps);
  alpha_phi_.resize(steps);
  i2r_.resize(steps);
  for (int32_t i = 0; i < steps; ++i) {
    model_ts_[i] = float((ts[i] - 1.0 / train_steps_) * train_steps_);
    double h = lam[i + 1] - lam[i];
    inv_alpha_s_[i] = float(1.0 / alpha[i]);
    sigma_s_[i] = float(sigma[i]);
    sigma_ratio_[i] = float(sigma[i + 1] / sigma[i]);
    alpha_phi_[i] = float(alpha[i + 1] * std::expm1(-h));
    if (i == 0) {
      i2r_[i] = 0.0f;  // 1st-order first step
    } else {
      double h_prev = lam[i] - lam[i - 1];
      i2r_[i] = float(h / (2.0 * h_prev));  // 1/(2r), r = h_prev/h
    }
  }
  prev_y_.clear();
}

void DpmSolver::update(int32_t step, float* x, const float* eps, size_t n) {
  if (steps_ == 0) SDTPU_THROW(SDTPU_RUNTIME_ERROR, "prepare() not called");
  if (step < 0 || step >= steps_)
    SDTPU_THROW(SDTPU_INVALID_ARGUMENT, "step out of range");
  if (step == 0) prev_y_.assign(n, 0.0f);
  if (prev_y_.size() != n)
    SDTPU_THROW(SDTPU_INVALID_ARGUMENT, "size changed between steps");
  const float ia = inv_alpha_s_[step], ss = sigma_s_[step],
              sr = sigma_ratio_[step], ap = alpha_phi_[step],
              i2r = i2r_[step];
  for (size_t i = 0; i < n; ++i) {
    float y = (x[i] - ss * eps[i]) * ia;
    float d = (1.0f + i2r) * y - i2r * prev_y_[i];
    x[i] = sr * x[i] - ap * d;
    prev_y_[i] = y;
  }
}

}  // namespace sdtpu
