// Shared pieces of the native AutoDock-Vina-style scoring: the published
// empirical potential (Trott & Olson 2010) and a cell-list for 8 A cutoff
// neighbour queries. Used by vina_score.cc (rigid-pose scoring, the ETL /
// GAN-reward path) and vina_dock.cc (pose search). The reference ships only
// prebuilt vina *binaries* (autodock_vina/bin) and shells
// out per molecule (MakeGraph.py:103-111); everything here is an original
// in-process implementation of the published functional form.
#ifndef SINGA_TPU_VINA_COMMON_H_
#define SINGA_TPU_VINA_COMMON_H_

#include <algorithm>
#include <cmath>
#include <vector>

namespace vina {

constexpr double kCutoff = 8.0;
constexpr double kWGauss1 = -0.035579;
constexpr double kWGauss2 = -0.005156;
constexpr double kWRepulsion = 0.840245;
constexpr double kWHydrophobic = -0.035069;
constexpr double kWHBond = -0.587439;
constexpr double kWRot = 0.05846;

// XS van der Waals radii per type (Angstrom). Type ids documented in
// vina_score.cc / singa_tpu_torch/cpp/vina.py (keep all three in sync).
const double kRadius[18] = {
    1.9, 1.9,            // C_H, C_P
    1.8, 1.8, 1.8, 1.8,  // N_*
    1.7, 1.7, 1.7, 1.7,  // O_*
    2.0, 2.1,            // S, P
    1.5, 1.8, 2.0, 2.2,  // F, Cl, Br, I
    1.2,                 // Met
    1.9,                 // other
};

inline bool is_hydrophobic_type(int t) {
  return t == 0 || t == 12 || t == 13 || t == 14 || t == 15;
}
inline bool is_donor(int t) {
  return t == 3 || t == 5 || t == 7 || t == 9 || t == 16;
}
inline bool is_acceptor(int t) {
  return t == 4 || t == 5 || t == 8 || t == 9;
}
inline bool hbond_pair(int t1, int t2) {
  return (is_donor(t1) && is_acceptor(t2)) || (is_acceptor(t1) && is_donor(t2));
}

inline double pair_energy(double r, int t1, int t2) {
  double d = r - kRadius[t1] - kRadius[t2];  // surface distance
  double e = 0.0;
  double g1 = std::exp(-(d / 0.5) * (d / 0.5));
  double g2 = std::exp(-((d - 3.0) / 2.0) * ((d - 3.0) / 2.0));
  e += kWGauss1 * g1 + kWGauss2 * g2;
  if (d < 0) e += kWRepulsion * d * d;
  if (is_hydrophobic_type(t1) && is_hydrophobic_type(t2)) {
    double h = d <= 0.5 ? 1.0 : (d >= 1.5 ? 0.0 : (1.5 - d));
    e += kWHydrophobic * h;
  }
  if (hbond_pair(t1, t2)) {
    double h = d <= -0.7 ? 1.0 : (d >= 0 ? 0.0 : (-d / 0.7));
    e += kWHBond * h;
  }
  return e;
}

struct CellList {
  double origin[3];
  int dims[3];
  double cell;
  std::vector<std::vector<int>> cells;

  CellList(const double* xyz, int n, double cell_size) : cell(cell_size) {
    double lo[3] = {1e30, 1e30, 1e30}, hi[3] = {-1e30, -1e30, -1e30};
    for (int i = 0; i < n; ++i)
      for (int k = 0; k < 3; ++k) {
        lo[k] = std::min(lo[k], xyz[3 * i + k]);
        hi[k] = std::max(hi[k], xyz[3 * i + k]);
      }
    for (int k = 0; k < 3; ++k) {
      origin[k] = lo[k];
      dims[k] = std::max(1, (int)((hi[k] - lo[k]) / cell) + 1);
    }
    cells.resize((size_t)dims[0] * dims[1] * dims[2]);
    for (int i = 0; i < n; ++i) {
      int c[3];
      for (int k = 0; k < 3; ++k) {
        c[k] = (int)((xyz[3 * i + k] - origin[k]) / cell);
        c[k] = std::min(std::max(c[k], 0), dims[k] - 1);
      }
      cells[((size_t)c[0] * dims[1] + c[1]) * dims[2] + c[2]].push_back(i);
    }
  }

  template <typename F>
  void neighbors(const double* p, F&& fn) const {
    int c[3];
    for (int k = 0; k < 3; ++k)
      c[k] = (int)((p[k] - origin[k]) / cell);
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz) {
          int x = c[0] + dx, y = c[1] + dy, z = c[2] + dz;
          if (x < 0 || y < 0 || z < 0 || x >= dims[0] || y >= dims[1] ||
              z >= dims[2])
            continue;
          for (int idx : cells[((size_t)x * dims[1] + y) * dims[2] + z]) fn(idx);
        }
  }
};

}  // namespace vina

#endif  // SINGA_TPU_VINA_COMMON_H_
