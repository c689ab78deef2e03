// Exact k-nearest-neighbour search over integer voxel clouds.
//
// Host-side analog of the reference's nanoflann KD-tree
// (dependencies/nanoflann, used by
// PCCNormalsGenerator.cpp:61-533 and PCCPointSet.cpp:807-1110): V-PCC
// point clouds are voxel grids (coords are small non-negative integers),
// so a uniform-cell grid hash beats a KD-tree on the 1-core host this
// framework's CPU paths run on (~5x measured on vox10 density).  Results
// are exact: rings of cells are expanded until the k-th best distance is
// provably closer than any unexplored cell.
//
// Layout: data points are counting-sorted into cells (CSR); cell keys go
// into an open-addressing hash table.  Queries expand Chebyshev rings of
// cells around their own cell, maintaining a small insertion-sorted
// candidate list (k <= 64).  Ties break toward the smaller point index so
// results are deterministic (not necessarily the KD-tree's tie order).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

struct HashTable {
    // open addressing, power-of-two capacity, key -> cell slot
    std::vector<uint64_t> keys;
    std::vector<int32_t> vals;
    uint64_t mask = 0;

    void init(size_t n_cells) {
        size_t cap = 16;
        while (cap < n_cells * 2) cap <<= 1;
        keys.assign(cap, UINT64_MAX);
        vals.assign(cap, -1);
        mask = cap - 1;
    }
    static inline uint64_t mix(uint64_t x) {
        x ^= x >> 33; x *= 0xff51afd7ed558ccdULL;
        x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
        x ^= x >> 33; return x;
    }
    inline void insert(uint64_t key, int32_t val) {
        uint64_t h = mix(key) & mask;
        while (keys[h] != UINT64_MAX) {
            if (keys[h] == key) return;  // first insert wins
            h = (h + 1) & mask;
        }
        keys[h] = key; vals[h] = val;
    }
    inline int32_t find(uint64_t key) const {
        uint64_t h = mix(key) & mask;
        while (keys[h] != UINT64_MAX) {
            if (keys[h] == key) return vals[h];
            h = (h + 1) & mask;
        }
        return -1;
    }
};

}  // namespace

extern "C" {

// query (nq x 3) int32, data (nd x 3) int32, k <= 64.
// out_idx (nq x k) int32 (-1 padding when nd < k), out_d2 (nq x k) float32
// (inf padding).  cell_shift: log2 of the cell edge; pass -1 to auto-tune
// from density.  Returns 0 on success.
int64_t rbv_knn_grid(const int32_t* query, int64_t nq,
                     const int32_t* data, int64_t nd,
                     int64_t k, int32_t cell_shift,
                     int32_t* out_idx, float* out_d2) {
    if (k <= 0 || k > 64 || nq < 0 || nd <= 0) return -1;

    // bounding box of data (queries may lie outside; rings still reach)
    int32_t lo[3] = {data[0], data[1], data[2]};
    int32_t hi[3] = {data[0], data[1], data[2]};
    for (int64_t i = 0; i < nd; ++i)
        for (int a = 0; a < 3; ++a) {
            int32_t v = data[i * 3 + a];
            if (v < lo[a]) lo[a] = v;
            if (v > hi[a]) hi[a] = v;
        }

    int shift = cell_shift;
    if (shift < 0) {
        // occupancy probe: the right cell edge depends on the cloud's
        // local density (a vox10 surface is ~1 pt/voxel; a sparse cloud
        // can be 8+ voxels apart), so grow the cell until the average
        // occupied cell holds enough points that ring 0..1 can satisfy k
        double want = std::max(2.0, (double)k / 6.0);
        for (shift = 1; shift < 11; ++shift) {
            HashTable probe;
            probe.init((size_t)nd + 1);
            size_t uniq = 0;
            for (int64_t i = 0; i < nd; ++i) {
                int64_t cx = ((int64_t)data[i * 3] - lo[0]) >> shift;
                int64_t cy = ((int64_t)data[i * 3 + 1] - lo[1]) >> shift;
                int64_t cz = ((int64_t)data[i * 3 + 2] - lo[2]) >> shift;
                uint64_t kk = (((uint64_t)cx << 42) ^ ((uint64_t)cy << 21)
                               ^ (uint64_t)cz);
                uint64_t h = HashTable::mix(kk) & probe.mask;
                while (probe.keys[h] != UINT64_MAX && probe.keys[h] != kk)
                    h = (h + 1) & probe.mask;
                if (probe.keys[h] == UINT64_MAX) {
                    probe.keys[h] = kk;
                    ++uniq;
                }
            }
            if ((double)nd / (double)uniq >= want) break;
        }
        if (shift > 10) shift = 10;
    }
    const int32_t s = 1 << shift;

    const int64_t gx = ((int64_t)(hi[0] - lo[0]) >> shift) + 1;
    const int64_t gy = ((int64_t)(hi[1] - lo[1]) >> shift) + 1;
    const int64_t gz = ((int64_t)(hi[2] - lo[2]) >> shift) + 1;

    auto cell_of = [&](const int32_t* p, int64_t& cx, int64_t& cy,
                       int64_t& cz) {
        cx = ((int64_t)p[0] - lo[0]) >> shift;
        cy = ((int64_t)p[1] - lo[1]) >> shift;
        cz = ((int64_t)p[2] - lo[2]) >> shift;
    };
    auto key_of = [&](int64_t cx, int64_t cy, int64_t cz) -> uint64_t {
        return ((uint64_t)cx * (uint64_t)gy + (uint64_t)cy) *
                   (uint64_t)gz + (uint64_t)cz;
    };

    // counting sort data into cells
    std::vector<uint64_t> dkey(nd);
    for (int64_t i = 0; i < nd; ++i) {
        int64_t cx, cy, cz;
        cell_of(data + i * 3, cx, cy, cz);
        dkey[i] = key_of(cx, cy, cz);
    }
    std::vector<int64_t> order(nd);
    for (int64_t i = 0; i < nd; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return dkey[a] < dkey[b] || (dkey[a] == dkey[b] && a < b);
    });

    // CSR over unique cells + hash table key -> cell slot
    std::vector<int64_t> cell_start;
    std::vector<uint64_t> cell_key;
    cell_start.reserve(nd / 2 + 1);
    for (int64_t i = 0; i < nd; ++i) {
        uint64_t kk = dkey[order[i]];
        if (cell_key.empty() || cell_key.back() != kk) {
            cell_key.push_back(kk);
            cell_start.push_back(i);
        }
    }
    cell_start.push_back(nd);
    HashTable ht;
    ht.init(cell_key.size());
    for (size_t c = 0; c < cell_key.size(); ++c)
        ht.insert(cell_key[c], (int32_t)c);

    const int64_t keff = k < nd ? k : nd;
    const float finf = INFINITY;

    // process queries grouped by cell: neighbouring queries touch the
    // same ring cells, so cell order turns the CSR accesses sequential
    // (~1.6x on vox10 density vs input order)
    std::vector<int64_t> qorder(nq);
    {
        std::vector<uint64_t> qkey(nq);
        for (int64_t i = 0; i < nq; ++i) {
            int64_t cx, cy, cz;
            cell_of(query + i * 3, cx, cy, cz);
            // offset so out-of-bbox (negative) cells still sort coherently
            qkey[i] = key_of(cx + 1, cy + 1, cz + 1);
        }
        for (int64_t i = 0; i < nq; ++i) qorder[i] = i;
        std::sort(qorder.begin(), qorder.end(), [&](int64_t a, int64_t b) {
            return qkey[a] < qkey[b] || (qkey[a] == qkey[b] && a < b);
        });
    }

    // per-query ring expansion
    std::vector<int64_t> bd2(k);
    std::vector<int32_t> bidx(k);
    for (int64_t qi = 0; qi < nq; ++qi) {
        const int64_t q = qorder[qi];
        const int32_t* qp = query + q * 3;
        int64_t qcx, qcy, qcz;
        cell_of(qp, qcx, qcy, qcz);
        int64_t nbest = 0;
        int64_t worst = INT64_MAX;

        auto scan_cell = [&](int64_t cx, int64_t cy, int64_t cz) {
            if (cx < 0 || cy < 0 || cz < 0 || cx >= gx || cy >= gy ||
                cz >= gz)
                return;
            int32_t slot = ht.find(key_of(cx, cy, cz));
            if (slot < 0) return;
            for (int64_t j = cell_start[slot]; j < cell_start[slot + 1];
                 ++j) {
                int64_t di = order[j];
                const int32_t* dp = data + di * 3;
                int64_t dx = (int64_t)qp[0] - dp[0];
                int64_t dy = (int64_t)qp[1] - dp[1];
                int64_t dz = (int64_t)qp[2] - dp[2];
                int64_t d2 = dx * dx + dy * dy + dz * dz;
                if (nbest == keff && (d2 > worst ||
                    (d2 == worst && di >= bidx[nbest - 1])))
                    continue;
                // insertion sort by (d2, index)
                int64_t pos = nbest < keff ? nbest : keff - 1;
                while (pos > 0 && (bd2[pos - 1] > d2 ||
                       (bd2[pos - 1] == d2 && bidx[pos - 1] > di))) {
                    bd2[pos] = bd2[pos - 1];
                    bidx[pos] = bidx[pos - 1];
                    --pos;
                }
                bd2[pos] = d2; bidx[pos] = (int32_t)di;
                if (nbest < keff) ++nbest;
                if (nbest == keff) worst = bd2[keff - 1];
            }
        };

        // ring 0 is the query's own cell; ring r the Chebyshev shell
        int64_t max_ring = std::max({gx, gy, gz,
                                     qcx + 1, gx - qcx,
                                     qcy + 1, gy - qcy,
                                     qcz + 1, gz - qcz});
        for (int64_t r = 0; ; ++r) {
            if (r == 0) {
                scan_cell(qcx, qcy, qcz);
            } else {
                // shell faces: x = qcx +- r, y/z full range
                for (int64_t dx = -r; dx <= r; ++dx)
                    for (int64_t dy = -r; dy <= r; ++dy) {
                        bool xe = (dx == -r || dx == r);
                        bool ye = (dy == -r || dy == r);
                        if (xe || ye) {
                            for (int64_t dz = -r; dz <= r; ++dz)
                                scan_cell(qcx + dx, qcy + dy, qcz + dz);
                        } else {
                            scan_cell(qcx + dx, qcy + dy, qcz - r);
                            scan_cell(qcx + dx, qcy + dy, qcz + r);
                        }
                    }
            }
            if (r >= max_ring) break;
            if (nbest == keff) {
                // min distance from q to any cell outside rings<=r: the
                // explored box spans [cellbase - r*s, cellbase + (r+1)*s)
                int64_t m = INT64_MAX;
                int64_t base[3] = {qcx, qcy, qcz};
                const int32_t qv[3] = {qp[0], qp[1], qp[2]};
                for (int a = 0; a < 3; ++a) {
                    int64_t cell_lo =
                        lo[a] + ((base[a] - r) << shift);
                    int64_t cell_hi =
                        lo[a] + ((base[a] + r + 1) << shift);
                    int64_t d_lo = qv[a] - cell_lo + 1;
                    int64_t d_hi = cell_hi - qv[a];
                    if (d_lo < m) m = d_lo;
                    if (d_hi < m) m = d_hi;
                }
                if (m > 0 && m * m > worst) break;
            }
        }
        float* od = out_d2 + q * k;
        int32_t* oi = out_idx + q * k;
        for (int64_t j = 0; j < nbest; ++j) {
            od[j] = (float)bd2[j];
            oi[j] = bidx[j];
        }
        for (int64_t j = nbest; j < k; ++j) {
            od[j] = finf;
            oi[j] = -1;
        }
        (void)s;
    }
    return 0;
}

}  // extern "C"
