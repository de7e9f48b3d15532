// SMACT-style charge-balance + electronegativity validity check, host C++
// (a copy of matinvent_tpu/native/charge_balance.cpp, built with g++ by
// csrc/build.py). The plain Python version in chem/validity.py enumerates
// the full cartesian product of oxidation states; this DFS prunes on
//   (a) reachable-charge bounds of the remaining elements, and
//   (b) the running Pauling constraint (max cation EN <= min anion EN),
// and has no cap on the number of combinations.
//
// C ABI (ctypes):
//   int charge_balanced(const int* ox_flat, const int* ox_offsets,
//                       const int* counts, const double* en, int n_elements)
// ox_flat: concatenated oxidation-state lists; ox_offsets: n+1 prefix offsets;
// counts: reduced-formula counts; en: Pauling EN per element (-1 if unknown).
// Returns 1 when some assignment is charge neutral and Pauling-consistent.

#include <cstdint>
#include <vector>
#include <algorithm>

namespace {

struct Ctx {
    const int* ox_flat;
    const int* ox_offsets;
    const int* counts;
    const double* en;
    int n;
    // suffix bounds of achievable charge from element i onward
    std::vector<long long> min_rest;
    std::vector<long long> max_rest;
};

bool dfs(const Ctx& ctx, int i, long long charge, double max_cat_en,
         double min_an_en, bool has_cat, bool has_an) {
    if (i == ctx.n) {
        return charge == 0 && has_cat && has_an;
    }
    // prune: remaining elements cannot bring the charge back to zero
    long long lo = charge + ctx.min_rest[i];
    long long hi = charge + ctx.max_rest[i];
    if (lo > 0 || hi < 0) return false;

    const int begin = ctx.ox_offsets[i];
    const int end = ctx.ox_offsets[i + 1];
    const long long c = ctx.counts[i];
    const double e = ctx.en[i];

    for (int k = begin; k < end; ++k) {
        const int ox = ctx.ox_flat[k];
        double mc = max_cat_en, ma = min_an_en;
        bool hc = has_cat, ha = has_an;
        if (ox > 0) {
            hc = true;
            if (e >= 0 && e > mc) mc = e;
        } else if (ox < 0) {
            ha = true;
            if (e >= 0 && e < ma) ma = e;
        }
        // Pauling constraint: cations must not out-electronegate anions
        if (mc > ma) continue;
        if (dfs(ctx, i + 1, charge + (long long)ox * c, mc, ma, hc, ha)) {
            return true;
        }
    }
    return false;
}

}  // namespace

extern "C" int charge_balanced(const int* ox_flat, const int* ox_offsets,
                               const int* counts, const double* en,
                               int n_elements) {
    // an element with no oxidation states can never balance (also guards the
    // suffix-bound reads below against an empty [begin, end) range)
    for (int i = 0; i < n_elements; ++i) {
        if (ox_offsets[i] == ox_offsets[i + 1]) return 0;
    }
    Ctx ctx{ox_flat, ox_offsets, counts, en, n_elements, {}, {}};
    ctx.min_rest.assign(n_elements + 1, 0);
    ctx.max_rest.assign(n_elements + 1, 0);
    for (int i = n_elements - 1; i >= 0; --i) {
        int lo = ox_flat[ox_offsets[i]];
        int hi = lo;
        for (int k = ox_offsets[i]; k < ox_offsets[i + 1]; ++k) {
            lo = std::min(lo, ox_flat[k]);
            hi = std::max(hi, ox_flat[k]);
        }
        ctx.min_rest[i] = ctx.min_rest[i + 1] + (long long)lo * counts[i];
        ctx.max_rest[i] = ctx.max_rest[i + 1] + (long long)hi * counts[i];
    }
    return dfs(ctx, 0, 0, -1.0, 1e9, false, false) ? 1 : 0;
}

