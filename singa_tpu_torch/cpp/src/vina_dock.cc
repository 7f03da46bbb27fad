// Vina-style flexible-ligand pose search — native implementation.
//
// The reference generates docked poses by shelling out to the vendored
// AutoDock Vina binary (MakeGraph.py:103-111,
// autodock_vina/bin; no source is vendored). This is an original in-process
// implementation of the same published algorithm family (Trott & Olson
// 2010): Monte-Carlo basin hopping over the ligand's degrees of freedom —
// centroid translation, rigid orientation, and torsion angles around
// rotatable bonds — with a derivative-free pattern-search local optimiser
// after every mutation, Metropolis acceptance, multiple independent runs
// (``exhaustiveness``) on std::thread, and greedy RMSD clustering of the
// pooled candidates. The optimised objective is e_inter + e_intra on the
// published pairwise potential (vina_common.h); the reported affinity is
// e_inter / (1 + w_rot * N_rot), matching vina_score().
//
// Conformation model: torsions are applied leaves-first (the caller orders
// them by decreasing tree depth, singa_tpu_torch/dock/tree.py), each rotating its
// moving set around the CURRENT positions of its axis atoms; because a
// bond's axis atoms are never inside a deeper bond's moving set, each axis
// is still un-rotated by its own descendants when used, and shallower
// torsions then carry the already-torsioned subtree rigidly. The global
// orientation (Rodrigues rotation about the conformer centroid) and the
// centroid position are applied last.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <random>
#include <thread>
#include <vector>

#include "vina_common.h"

namespace {

using vina::CellList;
using vina::kCutoff;
using vina::kWRot;
using vina::pair_energy;

struct Task {
  const double* ref;  // [n, 3] reference ligand coordinates
  const int* lig_type;
  int n_lig;
  const double* rec_xyz;
  const int* rec_type;
  int n_rec;
  int n_tor;
  const int* tor_axis;      // [n_tor, 2]
  const int* tor_move_off;  // [n_tor + 1]
  const int* tor_move;      // concatenated moving sets
  int n_pairs;
  const int* pairs;  // [n_pairs, 2] torsion-dependent intra pairs
  double box_lo[3], box_hi[3];
  const CellList* cl;
};

// Rotate `idx`-selected rows of xyz about the axis through point a with unit
// direction u by angle ang (Rodrigues).
void rotate_about(double* xyz, const int* idx, int n_idx, const double a[3],
                  const double u[3], double ang) {
  double c = std::cos(ang), s = std::sin(ang), omc = 1.0 - c;
  for (int t = 0; t < n_idx; ++t) {
    double* p = xyz + 3 * idx[t];
    double v[3] = {p[0] - a[0], p[1] - a[1], p[2] - a[2]};
    double dot = u[0] * v[0] + u[1] * v[1] + u[2] * v[2];
    double cx = u[1] * v[2] - u[2] * v[1];
    double cy = u[2] * v[0] - u[0] * v[2];
    double cz = u[0] * v[1] - u[1] * v[0];
    p[0] = a[0] + v[0] * c + cx * s + u[0] * dot * omc;
    p[1] = a[1] + v[1] * c + cy * s + u[1] * dot * omc;
    p[2] = a[2] + v[2] * c + cz * s + u[2] * dot * omc;
  }
}

// dof layout: [cx, cy, cz, rx, ry, rz, tor_0 .. tor_{T-1}]
void build_conf(const Task& t, const double* x, double* out) {
  int n = t.n_lig;
  std::copy(t.ref, t.ref + 3 * n, out);
  for (int b = 0; b < t.n_tor; ++b) {
    double ang = x[6 + b];
    if (ang == 0.0) continue;
    const int a1 = t.tor_axis[2 * b], a2 = t.tor_axis[2 * b + 1];
    double* p1 = out + 3 * a1;
    double* p2 = out + 3 * a2;
    double u[3] = {p2[0] - p1[0], p2[1] - p1[1], p2[2] - p1[2]};
    double nr = std::sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2]);
    if (nr < 1e-9) continue;
    for (double& c : u) c /= nr;
    rotate_about(out, t.tor_move + t.tor_move_off[b],
                 t.tor_move_off[b + 1] - t.tor_move_off[b], p1, u, ang);
  }
  // global orientation about the torsioned conformer's centroid
  double cen[3] = {0, 0, 0};
  for (int i = 0; i < n; ++i)
    for (int k = 0; k < 3; ++k) cen[k] += out[3 * i + k];
  for (double& c : cen) c /= n;
  double ang = std::sqrt(x[3] * x[3] + x[4] * x[4] + x[5] * x[5]);
  if (ang > 1e-9) {
    double u[3] = {x[3] / ang, x[4] / ang, x[5] / ang};
    std::vector<int> all(n);
    for (int i = 0; i < n; ++i) all[i] = i;
    rotate_about(out, all.data(), n, cen, u, ang);
  }
  // centroid -> x[0..2]
  for (int i = 0; i < n; ++i)
    for (int k = 0; k < 3; ++k) out[3 * i + k] += x[k] - cen[k];
}

double inter_energy(const Task& t, const double* xyz) {
  double e = 0.0;
  for (int i = 0; i < t.n_lig; ++i) {
    const double* p = xyz + 3 * i;
    t.cl->neighbors(p, [&](int j) {
      const double* q = t.rec_xyz + 3 * j;
      double dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
      double r2 = dx * dx + dy * dy + dz * dz;
      if (r2 > kCutoff * kCutoff) return;
      e += pair_energy(std::sqrt(r2), t.lig_type[i], t.rec_type[j]);
    });
  }
  return e;
}

double intra_energy(const Task& t, const double* xyz) {
  double e = 0.0;
  for (int p = 0; p < t.n_pairs; ++p) {
    int i = t.pairs[2 * p], j = t.pairs[2 * p + 1];
    double dx = xyz[3 * i] - xyz[3 * j];
    double dy = xyz[3 * i + 1] - xyz[3 * j + 1];
    double dz = xyz[3 * i + 2] - xyz[3 * j + 2];
    double r2 = dx * dx + dy * dy + dz * dz;
    if (r2 > kCutoff * kCutoff) continue;
    e += pair_energy(std::sqrt(r2), t.lig_type[i], t.lig_type[j]);
  }
  return e;
}

struct Eval {
  const Task* t;
  std::vector<double> buf;
  int n_evals = 0;
  explicit Eval(const Task& task) : t(&task), buf(3 * task.n_lig) {}
  double operator()(const double* x) {
    ++n_evals;
    build_conf(*t, x, buf.data());
    return inter_energy(*t, buf.data()) + intra_energy(*t, buf.data());
  }
};

void clamp_box(const Task& t, double* x) {
  for (int k = 0; k < 3; ++k)
    x[k] = std::min(std::max(x[k], t.box_lo[k]), t.box_hi[k]);
}

// Derivative-free pattern search: per-dof +/- probes with step halving.
// Robust on the piecewise potential (the repulsion/hydrophobic/h-bond terms
// are only C0) where quasi-Newton steps thrash.
double local_opt(const Task& t, Eval& ev, std::vector<double>& x,
                 double e0, double step_scale) {
  int dof = 6 + t.n_tor;
  std::vector<double> step(dof);
  for (int k = 0; k < 3; ++k) step[k] = 0.6 * step_scale;
  for (int k = 3; k < dof; ++k) step[k] = 0.35 * step_scale;
  double e = e0;
  for (int iter = 0; iter < 64; ++iter) {
    bool improved = false;
    for (int d = 0; d < dof; ++d) {
      for (double sgn : {1.0, -1.0}) {
        double old = x[d];
        x[d] = old + sgn * step[d];
        if (d < 3) clamp_box(t, x.data());
        double e2 = ev(x.data());
        if (e2 < e - 1e-10) {
          e = e2;
          improved = true;
          break;  // keep; next dof
        }
        x[d] = old;
      }
    }
    if (!improved) {
      bool done = true;
      for (int d = 0; d < dof; ++d) {
        step[d] *= 0.5;
        if (step[d] > (d < 3 ? 0.03 : 0.02)) done = false;
      }
      if (done) break;
    }
  }
  return e;
}

struct Candidate {
  double e_total;
  std::vector<double> xyz;
};

void run_search(const Task& t, int n_steps, uint32_t seed,
                std::vector<Candidate>* out) {
  std::mt19937 rng(seed);
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  std::normal_distribution<double> gauss(0.0, 1.0);
  int dof = 6 + t.n_tor;
  auto rand_angle = [&] { return (2.0 * uni(rng) - 1.0) * M_PI; };

  Eval ev(t);
  std::vector<double> x(dof), best(dof);
  for (int k = 0; k < 3; ++k)
    x[k] = t.box_lo[k] + uni(rng) * (t.box_hi[k] - t.box_lo[k]);
  for (int k = 3; k < dof; ++k) x[k] = rand_angle();
  double e = local_opt(t, ev, x, ev(x.data()), 1.0);
  double e_best = e;
  best = x;
  out->push_back({e, {}});
  build_conf(t, x.data(), ev.buf.data());
  out->back().xyz = ev.buf;

  const double kT = 1.2;  // Metropolis temperature, kcal/mol scale
  std::vector<double> y(dof);
  for (int s = 0; s < n_steps; ++s) {
    y = x;
    int which = (int)(uni(rng) * (t.n_tor > 0 ? 3 : 2));
    if (which == 0) {  // translate centroid
      for (int k = 0; k < 3; ++k) y[k] += 2.0 * gauss(rng);
      clamp_box(t, y.data());
    } else if (which == 1) {  // re-orient: random axis, moderate angle
      double ax[3] = {gauss(rng), gauss(rng), gauss(rng)};
      double nr = std::sqrt(ax[0] * ax[0] + ax[1] * ax[1] + ax[2] * ax[2]);
      double ang = (uni(rng) * 0.8 + 0.2) * M_PI * 0.5;
      if (nr > 1e-9)
        for (int k = 0; k < 3; ++k) y[3 + k] += ax[k] / nr * ang;
    } else {  // one torsion fully randomised
      y[6 + (int)(uni(rng) * t.n_tor)] = rand_angle();
    }
    double e2 = local_opt(t, ev, y, ev(y.data()), 0.6);
    if (e2 < e || uni(rng) < std::exp((e - e2) / kT)) {
      x = y;
      e = e2;
      if (e < e_best) {
        e_best = e;
        best = x;
      }
      out->push_back({e, {}});
      build_conf(t, x.data(), ev.buf.data());
      out->back().xyz = ev.buf;
    }
  }
}

double rmsd(const double* a, const double* b, int n) {
  double s = 0.0;
  for (int i = 0; i < 3 * n; ++i) {
    double d = a[i] - b[i];
    s += d * d;
  }
  return std::sqrt(s / n);
}

}  // namespace

extern "C" {

// Returns the number of poses written (<= max_poses). out_xyz is
// [max_poses * n_lig * 3]; out_score holds the Vina affinity
// (e_inter / (1 + w_rot * n_rot)) per pose, best first.
int vina_dock(const double* lig_xyz0, const int* lig_type, int n_lig,
              const double* rec_xyz, const int* rec_type, int n_rec,
              int n_tor, const int* tor_axis, const int* tor_move_off,
              const int* tor_move, int n_pairs, const int* pairs,
              const double* box_center, const double* box_size,
              int exhaustiveness, int n_steps, int seed, int n_rot,
              int max_poses, double rmsd_thresh, double* out_xyz,
              double* out_score) {
  if (n_lig <= 0 || n_rec <= 0 || max_poses <= 0) return 0;
  CellList cl(rec_xyz, n_rec, kCutoff);
  Task t{lig_xyz0, lig_type, n_lig,    rec_xyz, rec_type, n_rec,
         n_tor,    tor_axis, tor_move_off, tor_move, n_pairs, pairs,
         {},       {},       &cl};
  for (int k = 0; k < 3; ++k) {
    t.box_lo[k] = box_center[k] - 0.5 * box_size[k];
    t.box_hi[k] = box_center[k] + 0.5 * box_size[k];
  }

  std::vector<std::vector<Candidate>> pools(exhaustiveness);
  std::vector<std::thread> threads;
  threads.reserve(exhaustiveness);
  for (int r = 0; r < exhaustiveness; ++r)
    threads.emplace_back(run_search, std::cref(t), n_steps,
                         (uint32_t)(seed + 7919 * r), &pools[r]);
  for (auto& th : threads) th.join();

  std::vector<Candidate> all;
  for (auto& p : pools)
    for (auto& c : p) all.push_back(std::move(c));
  std::sort(all.begin(), all.end(),
            [](const Candidate& a, const Candidate& b) {
              return a.e_total < b.e_total;
            });

  // greedy RMSD clustering, best first
  int n_out = 0;
  for (const auto& c : all) {
    bool dup = false;
    for (int k = 0; k < n_out; ++k)
      if (rmsd(c.xyz.data(), out_xyz + (size_t)k * 3 * n_lig, n_lig) <
          rmsd_thresh) {
        dup = true;
        break;
      }
    if (dup) continue;
    std::copy(c.xyz.begin(), c.xyz.end(), out_xyz + (size_t)n_out * 3 * n_lig);
    out_score[n_out] =
        inter_energy(t, c.xyz.data()) / (1.0 + kWRot * std::max(0, n_rot));
    if (++n_out >= max_poses) break;
  }
  return n_out;
}

// Single-conformation objective (tests): e_inter + e_intra at the given
// dof vector x; writes the built conformation to out_xyz if non-null.
double vina_conf_energy(const double* lig_xyz0, const int* lig_type,
                        int n_lig, const double* rec_xyz, const int* rec_type,
                        int n_rec, int n_tor, const int* tor_axis,
                        const int* tor_move_off, const int* tor_move,
                        int n_pairs, const int* pairs, const double* x,
                        double* out_xyz) {
  CellList cl(rec_xyz, n_rec, kCutoff);
  Task t{lig_xyz0, lig_type, n_lig,    rec_xyz, rec_type, n_rec,
         n_tor,    tor_axis, tor_move_off, tor_move, n_pairs, pairs,
         {},       {},       &cl};
  std::vector<double> buf(3 * n_lig);
  build_conf(t, x, buf.data());
  if (out_xyz) std::copy(buf.begin(), buf.end(), out_xyz);
  return inter_energy(t, buf.data()) + intra_energy(t, buf.data());
}

}  // extern "C"
