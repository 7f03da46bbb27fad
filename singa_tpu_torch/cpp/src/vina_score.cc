// AutoDock Vina empirical scoring function — native implementation.
//
// The reference vendors the prebuilt `vina` binary and shells out per
// molecule for affinity labels (MakeGraph.py:103-111,
// autodock_vina/bin/). This library implements the published Vina scoring
// function (Trott & Olson 2010) as an in-process C++ routine so the ETL and
// the GAN reward loop can score poses at memory speed: pairwise terms
// (gauss1, gauss2, repulsion, hydrophobic, H-bond) over a surface-distance
// metric with an 8 A cutoff and cell-list acceleration, divided by the
// rotatable-bond penalty 1 + w_rot * N_rot. Pose *search* lives in
// vina_dock.cc (compiled into the same .so).
//
// Exposed C ABI (ctypes):
//   double vina_score(const double* lig_xyz, const int* lig_type, int n_lig,
//                     const double* rec_xyz, const int* rec_type, int n_rec,
//                     int n_rot);
//   void vina_score_batch(...) — many ligands against one receptor.
//
// Atom types (XS subset): 0=C_H (hydrophobic C), 1=C_P (polar C),
// 2=N_P, 3=N_D, 4=N_A, 5=N_DA, 6=O_P, 7=O_D, 8=O_A, 9=O_DA,
// 10=S, 11=P, 12=F_H, 13=Cl_H, 14=Br_H, 15=I_H, 16=Met_D (metal donor),
// 17=other.

#include <cmath>
#include <cstring>

#include "vina_common.h"

using vina::CellList;
using vina::kCutoff;
using vina::kWRot;
using vina::pair_energy;

extern "C" {

double vina_score(const double* lig_xyz, const int* lig_type, int n_lig,
                  const double* rec_xyz, const int* rec_type, int n_rec,
                  int n_rot) {
  if (n_lig <= 0 || n_rec <= 0) return 0.0;
  CellList cl(rec_xyz, n_rec, kCutoff);
  double inter = 0.0;
  for (int i = 0; i < n_lig; ++i) {
    const double* p = lig_xyz + 3 * i;
    cl.neighbors(p, [&](int j) {
      const double* q = rec_xyz + 3 * j;
      double dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
      double r2 = dx * dx + dy * dy + dz * dz;
      if (r2 > kCutoff * kCutoff) return;
      inter += pair_energy(std::sqrt(r2), lig_type[i], rec_type[j]);
    });
  }
  return inter / (1.0 + kWRot * std::max(0, n_rot));
}

void vina_score_batch(const double* lig_xyz, const int* lig_type,
                      const int* lig_offsets, const int* lig_nrot,
                      int n_ligands, const double* rec_xyz,
                      const int* rec_type, int n_rec, double* out) {
  if (n_rec <= 0) {
    for (int i = 0; i < n_ligands; ++i) out[i] = 0.0;
    return;
  }
  CellList cl(rec_xyz, n_rec, kCutoff);
  for (int li = 0; li < n_ligands; ++li) {
    int start = lig_offsets[li], end = lig_offsets[li + 1];
    double inter = 0.0;
    for (int i = start; i < end; ++i) {
      const double* p = lig_xyz + 3 * i;
      cl.neighbors(p, [&](int j) {
        const double* q = rec_xyz + 3 * j;
        double dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
        double r2 = dx * dx + dy * dy + dz * dz;
        if (r2 > kCutoff * kCutoff) return;
        inter += pair_energy(std::sqrt(r2), lig_type[i], rec_type[j]);
      });
    }
    out[li] = inter / (1.0 + kWRot * std::max(0, lig_nrot[li]));
  }
}

// Per-term breakdown for tests/debugging.
void vina_terms(const double* lig_xyz, const int* lig_type, int n_lig,
                const double* rec_xyz, const int* rec_type, int n_rec,
                double* terms /* [5]: g1, g2, rep, hph, hb (unweighted) */) {
  std::memset(terms, 0, 5 * sizeof(double));
  if (n_lig <= 0 || n_rec <= 0) return;
  CellList cl(rec_xyz, n_rec, kCutoff);
  for (int i = 0; i < n_lig; ++i) {
    const double* p = lig_xyz + 3 * i;
    cl.neighbors(p, [&](int j) {
      const double* q = rec_xyz + 3 * j;
      double dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
      double r2 = dx * dx + dy * dy + dz * dz;
      if (r2 > kCutoff * kCutoff) return;
      double r = std::sqrt(r2);
      int t1 = lig_type[i], t2 = rec_type[j];
      double d = r - vina::kRadius[t1] - vina::kRadius[t2];
      terms[0] += std::exp(-(d / 0.5) * (d / 0.5));
      terms[1] += std::exp(-((d - 3.0) / 2.0) * ((d - 3.0) / 2.0));
      if (d < 0) terms[2] += d * d;
      if (vina::is_hydrophobic_type(t1) && vina::is_hydrophobic_type(t2))
        terms[3] += d <= 0.5 ? 1.0 : (d >= 1.5 ? 0.0 : (1.5 - d));
      if (vina::hbond_pair(t1, t2))
        terms[4] += d <= -0.7 ? 1.0 : (d >= 0 ? 0.0 : (-d / 0.7));
    });
  }
}

}  // extern "C"
