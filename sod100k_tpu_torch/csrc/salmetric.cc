// SalMetric's metric core on decoded 8-bit buffers (host C++, no OpenCV).
//
// Port of sod100k_tpu/native/salmetric/sal_metric.cc without its image
// reader: Python decodes each PNG (data/image_io.py) and feeds the u8
// buffers here in chunks, so a long list is never held decoded at once.
// The math is the reference SalMetric's: MAE over raw gray / 255;
// precision and recall at 256 strict thresholds (sal > th) with the GT
// binarized at > 128 and EPSILON 1e-4; F with beta^2 0.3 from the
// macro-averaged P/R; every average divides by the number of LISTED
// pairs, unreadable or mismatched ones included. One 256-bin histogram
// pass per image (#(sal > th) = npix - cdf[th]), a std::thread pool over
// the pairs of a chunk.
//
// C ABI (ctypes, sod100k_tpu_torch/metrics/native.py):
//   salmetric_new(num_threads) -> handle
//   salmetric_feed(handle, n, sal_paths, gt_paths, sal, gt, sal_hw, gt_hw)
//       sal[i] / gt[i]: row-major u8 planes of sal_hw[2i] x sal_hw[2i+1]
//       (gt_hw likewise); a null pointer marks a pair that could not be
//       decoded. Paths only name the pair in messages.
//   salmetric_finish(handle, n_listed, print_stdout, out) -> images
//       prints the skipped pairs to stderr and, if asked, the reference
//       report to stdout; out holds 7 + 2 * 256 doubles: mae, max_f,
//       mean_f, precision and recall at the max-F threshold, mean P,
//       mean R, precision[256], recall[256].
//   salmetric_free(handle)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace salmetric {

constexpr int kThresholds = 256;
constexpr double kEpsilon = 1e-4;
constexpr double kBeta2 = 0.3;

struct Partial {
  double mae = 0.0;
  double precision[kThresholds] = {0.0};
  double recall[kThresholds] = {0.0};
  long images = 0;
};

struct Accumulator {
  std::vector<Partial> partials;  // one per worker thread
  std::vector<std::string> errors;
};

struct Report {
  double mae = 0.0;
  double precision[kThresholds] = {0.0};
  double recall[kThresholds] = {0.0};
  double fmeasure[kThresholds] = {0.0};
  double max_f = 0.0;
  double mean_f = 0.0;
  int argmax = 0;
  double mean_precision = 0.0;
  double mean_recall = 0.0;
  long images = 0;
};

// One decoded pair of equal size: MAE and per-threshold P/R into `out`.
inline void accumulate_pair(const uint8_t* sal, const uint8_t* gt, long npix,
                            Partial* out) {
  long hist[kThresholds] = {0};
  long hist_fg[kThresholds] = {0};
  long abs_sum = 0;
  long fg = 0;
  for (long i = 0; i < npix; ++i) {
    const int s = sal[i];
    const int g = gt[i];
    abs_sum += std::abs(s - g);
    ++hist[s];
    if (g > kThresholds / 2) {  // gt > 128, strict
      ++fg;
      ++hist_fg[s];
    }
  }
  out->mae += static_cast<double>(abs_sum) / 255.0 / npix;
  long cdf = 0, cdf_fg = 0;
  for (int th = 0; th < kThresholds; ++th) {
    cdf += hist[th];
    cdf_fg += hist_fg[th];
    const double a_sum = static_cast<double>(npix - cdf);  // #(sal > th)
    const double ab = static_cast<double>(fg - cdf_fg);    // #(sal > th & fg)
    out->precision[th] += (ab + kEpsilon) / (a_sum + kEpsilon);
    out->recall[th] += (ab + kEpsilon) / (static_cast<double>(fg) + kEpsilon);
  }
  out->images += 1;
}

inline Report reduce(const Accumulator& acc, long n_listed) {
  Report rep;
  const double n = static_cast<double>(n_listed);
  for (const Partial& p : acc.partials) {
    rep.mae += p.mae / n;
    rep.images += p.images;
    for (int th = 0; th < kThresholds; ++th) {
      rep.precision[th] += p.precision[th] / n;
      rep.recall[th] += p.recall[th] / n;
    }
  }
  for (int th = 0; th < kThresholds; ++th) {
    const double f = ((1 + kBeta2) * rep.precision[th] * rep.recall[th]) /
                     (kBeta2 * rep.precision[th] + rep.recall[th]);
    rep.fmeasure[th] = f;
    rep.mean_f += f;
    rep.mean_precision += rep.precision[th];
    rep.mean_recall += rep.recall[th];
    if (f > rep.max_f) {
      rep.max_f = f;
      rep.argmax = th;
    }
  }
  rep.mean_f /= kThresholds;
  rep.mean_precision /= kThresholds;
  rep.mean_recall /= kThresholds;
  return rep;
}

// The reference's `cout << float`: "%g" of the value as a float (6
// significant digits, shortest form). stdio, not iostreams: built by a g++
// that links its C++ runtime statically, a std::ostringstream here crashed
// (SIGSEGV) in a process that had imported torch first.
inline void print_report(const Report& rep) {
  auto f = [](double v) { return static_cast<double>(static_cast<float>(v)); };
  for (int th = 0; th < kThresholds; ++th) {
    printf("Threshold %d:\tMAE: %g\tPrecision: %g\tRecall: %g\t"
           "Fmeasure: %g\n", th, f(rep.mae), f(rep.precision[th]),
           f(rep.recall[th]), f(rep.fmeasure[th]));
  }
  printf("Max_F-measre:   %g\n", f(rep.max_f));
  printf("Mean_F-measre:  %g\n", f(rep.mean_f));
  printf("Precision:      %g\n", f(rep.precision[rep.argmax]));
  printf("Recall:         %g\n", f(rep.recall[rep.argmax]));
  printf("Mean_Precision: %g\n", f(rep.mean_precision));
  printf("Mean_Recall:    %g\n", f(rep.mean_recall));
  printf("MAE:            %g\n", f(rep.mae));
  fflush(stdout);
}

}  // namespace salmetric

extern "C" {

void* salmetric_new(int num_threads) {
  auto* acc = new salmetric::Accumulator;
  acc->partials.resize(std::max(1, num_threads));
  return acc;
}

void salmetric_free(void* handle) {
  delete static_cast<salmetric::Accumulator*>(handle);
}

void salmetric_feed(void* handle, int n, const char** sal_paths,
                    const char** gt_paths, const uint8_t** sal,
                    const uint8_t** gt, const int* sal_hw, const int* gt_hw) {
  auto* acc = static_cast<salmetric::Accumulator*>(handle);
  std::vector<bool> usable(n, false);
  for (int i = 0; i < n; ++i) {
    if (sal[i] == nullptr || gt[i] == nullptr) {
      acc->errors.push_back(std::string("unreadable pair: ") + sal_paths[i] +
                            " " + gt_paths[i]);
    } else if (sal_hw[2 * i] != gt_hw[2 * i] ||
               sal_hw[2 * i + 1] != gt_hw[2 * i + 1]) {
      // the reference warns and reads out of bounds; this skips the pair
      acc->errors.push_back(std::string("size mismatch: ") + sal_paths[i]);
    } else {
      usable[i] = true;
    }
  }
  const int num_threads = static_cast<int>(acc->partials.size());
  std::atomic<int> next(0);
  std::vector<std::thread> pool;
  pool.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    pool.emplace_back([&, t]() {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
        if (!usable[i]) continue;
        const long npix = static_cast<long>(sal_hw[2 * i]) * sal_hw[2 * i + 1];
        salmetric::accumulate_pair(sal[i], gt[i], npix, &acc->partials[t]);
      }
    });
  }
  for (auto& th : pool) th.join();
}

int salmetric_finish(void* handle, int n_listed, int print_stdout,
                     double* out) {
  if (n_listed <= 0) return -1;
  auto* acc = static_cast<salmetric::Accumulator*>(handle);
  for (const std::string& e : acc->errors) fprintf(stderr, "%s\n", e.c_str());
  fflush(stderr);
  const salmetric::Report rep = salmetric::reduce(*acc, n_listed);
  if (print_stdout) salmetric::print_report(rep);
  out[0] = rep.mae;
  out[1] = rep.max_f;
  out[2] = rep.mean_f;
  out[3] = rep.precision[rep.argmax];
  out[4] = rep.recall[rep.argmax];
  out[5] = rep.mean_precision;
  out[6] = rep.mean_recall;
  std::memcpy(out + 7, rep.precision, sizeof(rep.precision));
  std::memcpy(out + 7 + salmetric::kThresholds, rep.recall,
              sizeof(rep.recall));
  return static_cast<int>(rep.images);
}

}  // extern "C"
