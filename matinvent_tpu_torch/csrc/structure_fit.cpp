// Native core of the exact structure fit (ordered and
// composition-anonymized): the port's copy of
// matinvent_tpu/native/structure_fit.cpp, built with g++ by csrc/build.py.
//
// Runs the search of chem/matcher.py ExactStructureMatcher.fit_prepared
// (pymatgen StructureMatcher defaults: Niggli-reduced cells in, unimodular
// lattice-correspondence search, anchor translations, per-species
// Hungarian assignment, RMS under stol) in native code; the Python loops
// cost tens of milliseconds per pair.
//
// Exported C ABI:
//   structure_fit(l1, f1, sp1, l2, f2, n, relabel, R,
//                 ltol, stol, angle_tol, scale) -> 1 fit / 0 no fit
//   l1,l2: 9 doubles row-major (Niggli-reduced lattices)
//   f1,f2: n*3 fractional coords (wrapped to [0,1))
//   sp1:   n int32 species ids of structure 1
//   relabel: R*n int32 — R candidate species arrays for structure 2 already
//            mapped into structure-1's vocabulary (ordered fit: R=1, sp2)
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Mat3 {
    double m[3][3];
};

inline Mat3 matmul(const Mat3& a, const Mat3& b) {
    Mat3 r{};
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            double s = 0.0;
            for (int k = 0; k < 3; ++k) s += a.m[i][k] * b.m[k][j];
            r.m[i][j] = s;
        }
    return r;
}

inline Mat3 transpose(const Mat3& a) {
    Mat3 r{};
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) r.m[i][j] = a.m[j][i];
    return r;
}

inline double det3(const Mat3& a) {
    return a.m[0][0] * (a.m[1][1] * a.m[2][2] - a.m[1][2] * a.m[2][1])
         - a.m[0][1] * (a.m[1][0] * a.m[2][2] - a.m[1][2] * a.m[2][0])
         + a.m[0][2] * (a.m[1][0] * a.m[2][1] - a.m[1][1] * a.m[2][0]);
}

inline void row_lengths(const Mat3& a, double out[3]) {
    for (int i = 0; i < 3; ++i)
        out[i] = std::sqrt(a.m[i][0] * a.m[i][0] + a.m[i][1] * a.m[i][1]
                           + a.m[i][2] * a.m[i][2]);
}

// cell angles in degrees (alpha = angle(b,c), beta = angle(a,c),
// gamma = angle(a,b)) — mirrors matcher.py _params
inline void row_angles(const Mat3& a, const double len[3], double out[3]) {
    const int pairs[3][2] = {{1, 2}, {0, 2}, {0, 1}};
    for (int k = 0; k < 3; ++k) {
        int i = pairs[k][0], j = pairs[k][1];
        double dot = a.m[i][0] * a.m[j][0] + a.m[i][1] * a.m[j][1]
                   + a.m[i][2] * a.m[j][2];
        double c = dot / (len[i] * len[j]);
        if (c > 1.0) c = 1.0;
        if (c < -1.0) c = -1.0;
        out[k] = std::acos(c) * 180.0 / M_PI;
    }
}

// All 3x3 integer matrices with entries in {-1,0,1} and det +-1 (3480),
// plus the integer inverse of each (adjugate / det — exact for unimodular).
struct Unimodular {
    int8_t m[3][3];
    int8_t inv[3][3];
};

const std::vector<Unimodular>& unimodular_candidates() {
    static const std::vector<Unimodular> table = [] {
        std::vector<Unimodular> out;
        out.reserve(3480);
        int e[9];
        for (int code = 0; code < 19683; ++code) {  // 3^9
            int c = code;
            for (int k = 0; k < 9; ++k) {
                e[k] = (c % 3) - 1;
                c /= 3;
            }
            // NOTE: iterate so e[0] is the fastest-varying digit; order of
            // the table only affects early-exit timing, not the result
            int a = e[0], b = e[1], d = e[2], p = e[3], q = e[4], r = e[5],
                s = e[6], t = e[7], u = e[8];
            int det = a * (q * u - r * t) - b * (p * u - r * s)
                    + d * (p * t - q * s);
            if (det != 1 && det != -1) continue;
            Unimodular um{};
            int mm[3][3] = {{a, b, d}, {p, q, r}, {s, t, u}};
            // adjugate (cofactor transpose) over integers
            int adj[3][3] = {
                {q * u - r * t, d * t - b * u, b * r - d * q},
                {r * s - p * u, a * u - d * s, d * p - a * r},
                {p * t - q * s, b * s - a * t, a * q - b * p},
            };
            for (int i = 0; i < 3; ++i)
                for (int j = 0; j < 3; ++j) {
                    um.m[i][j] = static_cast<int8_t>(mm[i][j]);
                    um.inv[i][j] = static_cast<int8_t>(adj[i][j] * det);
                }
            out.push_back(um);
        }
        return out;
    }();
    return table;
}

// Hungarian algorithm (Kuhn-Munkres with potentials, O(n^3)) for a square
// cost matrix; returns the minimal assignment cost. Sizes here are tiny
// (per-species site groups, <= max_atoms).
double hungarian_min_cost(const std::vector<double>& cost, int n) {
    const double INF = 1e300;
    std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0);
    std::vector<int> p(n + 1, 0), way(n + 1, 0);
    for (int i = 1; i <= n; ++i) {
        p[0] = i;
        int j0 = 0;
        std::vector<double> minv(n + 1, INF);
        std::vector<char> used(n + 1, false);
        do {
            used[j0] = true;
            int i0 = p[j0], j1 = -1;
            double delta = INF;
            for (int j = 1; j <= n; ++j) {
                if (used[j]) continue;
                double cur = cost[(i0 - 1) * n + (j - 1)] - u[i0] - v[j];
                if (cur < minv[j]) {
                    minv[j] = cur;
                    way[j] = j0;
                }
                if (minv[j] < delta) {
                    delta = minv[j];
                    j1 = j;
                }
            }
            for (int j = 0; j <= n; ++j) {
                if (used[j]) {
                    u[p[j]] += delta;
                    v[j] -= delta;
                } else {
                    minv[j] -= delta;
                }
            }
            j0 = j1;
        } while (p[j0] != 0);
        do {
            int j1 = way[j0];
            p[j0] = p[j1];
            j0 = j1;
        } while (j0);
    }
    double total = 0.0;
    for (int j = 1; j <= n; ++j) total += cost[(p[j] - 1) * n + (j - 1)];
    return total;
}

// anchor-translation + per-species assignment RMS test
// (matcher.py _sites_fit). gram is the averaged metric tensor; distances are
// minimum-image in fractional space.
bool sites_fit(const Mat3& gram, const double* f1, const double* f2,
               const int32_t* sp1, const int32_t* sp2, int n, double norm,
               double stol) {
    // species groups of sp1 (values ascending, first-seen index per value —
    // np.unique semantics)
    std::vector<int32_t> vals;
    std::vector<std::vector<int>> groups1;
    for (int i = 0; i < n; ++i) {
        size_t k = 0;
        while (k < vals.size() && vals[k] < sp1[i]) ++k;
        if (k == vals.size() || vals[k] != sp1[i]) {
            vals.insert(vals.begin() + k, sp1[i]);
            // NOTE: an explicit empty vector — a brace-only `{}` here picks
            // the initializer-list insert overload, which inserts NOTHING
            groups1.insert(groups1.begin() + k, std::vector<int>{});
        }
        // recompute position (may have shifted)
        size_t pos = 0;
        while (vals[pos] != sp1[i]) ++pos;
        groups1[pos].push_back(i);
    }
    // anchor = rarest sp1 species (ties: smallest value, np.unique order)
    size_t anchor = 0;
    for (size_t k = 1; k < vals.size(); ++k)
        if (groups1[k].size() < groups1[anchor].size()) anchor = k;
    const int a_idx = groups1[anchor][0];
    // per-species index groups of sp2
    std::vector<std::vector<int>> groups2(vals.size());
    for (int i = 0; i < n; ++i)
        for (size_t k = 0; k < vals.size(); ++k)
            if (sp2[i] == vals[k]) {
                groups2[k].push_back(i);
                break;
            }
    for (size_t k = 0; k < vals.size(); ++k)
        if (groups1[k].size() != groups2[k].size()) return false;

    std::vector<double> cost;
    for (int b_idx : groups2[anchor]) {
        double shift[3] = {f2[b_idx * 3] - f1[a_idx * 3],
                           f2[b_idx * 3 + 1] - f1[a_idx * 3 + 1],
                           f2[b_idx * 3 + 2] - f1[a_idx * 3 + 2]};
        double sq_sum = 0.0;
        int n_tot = 0;
        bool viable = true;
        for (size_t k = 0; k < vals.size() && viable; ++k) {
            const auto& i1 = groups1[k];
            const auto& i2 = groups2[k];
            const int g = static_cast<int>(i1.size());
            cost.assign(static_cast<size_t>(g) * g, 0.0);
            double lb = 0.0;  // sum of row minima <= assignment cost
            for (int r = 0; r < g; ++r) {
                double rmin = 1e300;
                for (int c = 0; c < g; ++c) {
                    double d[3];
                    for (int x = 0; x < 3; ++x) {
                        double dd = f1[i1[r] * 3 + x]
                                  - (f2[i2[c] * 3 + x] - shift[x]);
                        dd -= std::nearbyint(dd);  // minimum image
                        d[x] = dd;
                    }
                    double q = 0.0;
                    for (int x = 0; x < 3; ++x)
                        for (int y = 0; y < 3; ++y)
                            q += d[x] * gram.m[x][y] * d[y];
                    cost[static_cast<size_t>(r) * g + c] = q;
                    if (q < rmin) rmin = q;
                }
                lb += rmin;
            }
            // greedy bound prunes the O(g^3) Hungarian: if even the
            // bijection-free row-min sum already exceeds the budget, the
            // true assignment cost (>= lb) cannot save this anchor
            double bound = std::sqrt(
                (sq_sum + lb > 0.0 ? sq_sum + lb : 0.0)
                / static_cast<double>(n));
            if (bound / norm > stol) {
                viable = false;
                break;
            }
            sq_sum += hungarian_min_cost(cost, g);
            n_tot += g;
            // partial-sum early exit: sq_sum only grows with further groups
            // and the final denominator is the full atom count n
            double partial = std::sqrt((sq_sum > 0.0 ? sq_sum : 0.0)
                                       / static_cast<double>(n));
            if (partial / norm > stol) viable = false;
        }
        if (!viable) continue;
        if (std::sqrt((sq_sum > 0.0 ? sq_sum : 0.0)
                      / static_cast<double>(n_tot))
                / norm
            <= stol)
            return true;
    }
    return false;
}

}  // namespace

extern "C" int structure_fit(const double* l1_in, const double* f1,
                             const int32_t* sp1, const double* l2_in,
                             const double* f2, int n, const int32_t* relabel,
                             int n_relabel, double ltol, double stol,
                             double angle_tol, int scale) {
    if (n <= 0 || n_relabel <= 0) return 0;
    Mat3 l1{}, l2{};
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            l1.m[i][j] = l1_in[i * 3 + j];
            l2.m[i][j] = l2_in[i * 3 + j];
        }
    double norm;
    if (scale) {
        // normalize both to unit volume/atom (pymatgen scale=True)
        double v1 = std::fabs(det3(l1)) / n;
        double v2 = std::fabs(det3(l2)) / n;
        if (v1 <= 0.0 || v2 <= 0.0) return 0;
        double s1 = std::cbrt(v1), s2 = std::cbrt(v2);
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j) {
                l1.m[i][j] /= s1;
                l2.m[i][j] /= s2;
            }
        norm = 1.0;
    } else {
        double v1 = std::fabs(det3(l1)) / n;
        double v2 = std::fabs(det3(l2)) / n;
        double v = 0.5 * (v1 + v2);
        norm = std::cbrt(v > 1e-12 ? v : 1e-12);
    }
    double len1[3], ang1[3];
    row_lengths(l1, len1);
    row_angles(l1, len1, ang1);
    const Mat3 g1 = matmul(l1, transpose(l1));

    std::vector<double> f2m(static_cast<size_t>(n) * 3);
    for (const auto& um : unimodular_candidates()) {
        Mat3 mm{};
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j) mm.m[i][j] = um.m[i][j];
        const Mat3 l2m = matmul(mm, l2);
        double len[3], ang[3];
        row_lengths(l2m, len);
        bool ok = true;
        for (int i = 0; i < 3 && ok; ++i)
            ok = std::fabs(len[i] - len1[i]) / len1[i] <= ltol;
        if (!ok) continue;
        row_angles(l2m, len, ang);
        for (int i = 0; i < 3 && ok; ++i)
            ok = std::fabs(ang[i] - ang1[i]) <= angle_tol;
        if (!ok) continue;

        Mat3 gram{};
        const Mat3 g2 = matmul(l2m, transpose(l2m));
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j)
                gram.m[i][j] = 0.5 * (g1.m[i][j] + g2.m[i][j]);
        // f2 @ inv(M), wrapped — integer inverse is exact for unimodular M
        for (int i = 0; i < n; ++i)
            for (int j = 0; j < 3; ++j) {
                double s = 0.0;
                for (int k = 0; k < 3; ++k)
                    s += f2[i * 3 + k] * static_cast<double>(um.inv[k][j]);
                s -= std::floor(s);
                f2m[static_cast<size_t>(i) * 3 + j] = s;
            }
        for (int r = 0; r < n_relabel; ++r) {
            if (sites_fit(gram, f1, f2m.data(), sp1,
                          relabel + static_cast<size_t>(r) * n, n, norm,
                          stol))
                return 1;
        }
    }
    return 0;
}
