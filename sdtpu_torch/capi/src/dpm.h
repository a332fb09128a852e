// The port's copy of csrc/libsdtpu/src/dpm.h (unchanged but for this line).
// DPM-Solver++(2M) host math — native mirror of sdtpu/samplers/dpm.py
// (the reference also implements this natively, dpm_solver.h:11-48).
#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace sdtpu {

class DpmSolver {
 public:
  DpmSolver(int32_t train_steps, double lin_start, double lin_end);

  void prepare(int32_t steps);
  // x <- one 2nd-order multistep update given the noise prediction eps.
  // Call with step = 0..steps-1 in order; keeps prev-y state between calls.
  void update(int32_t step, float* x, const float* eps, size_t n);

  const std::vector<float>& model_ts() const { return model_ts_; }
  int32_t steps() const { return steps_; }

  // precomputed per-step coefficient tables (exposed for golden tests)
  std::vector<float> inv_alpha_s_, sigma_s_, sigma_ratio_, alpha_phi_, i2r_;

 private:
  double log_alpha_at(double t) const;  // linear interp on the train grid

  int32_t train_steps_;
  std::vector<double> t_grid_, log_alpha_grid_;
  std::vector<float> model_ts_;
  std::vector<float> prev_y_;
  int32_t steps_ = 0;
};

}  // namespace sdtpu
