// Host-side point-cloud functions of the data pipeline, in C++ (a copy of
// the JAX package's cpd_tpu/native/src/pointcloud.cpp without its
// radius_neighbor_count: that search runs on the card as kernel R1,
// csrc/radius_count.cu). The data layer's per-sample work (points in boxes
// for gt sampling, prototypes and the gt database) runs here as -O3 C++
// threaded with std::thread, bound with ctypes (cpd_tpu_torch/native).
//
// All functions use raw float32/int32 buffers in C order; boxes are
// [x y z dx dy dz heading].

#include <cstdint>
#include <cmath>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>
#include <unordered_set>

namespace {

inline int n_threads_for(int64_t n) {
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 4;
    int64_t per = 20000;
    int t = static_cast<int>(std::min<int64_t>(hw, std::max<int64_t>(1, n / per)));
    return std::max(t, 1);
}

template <typename F>
void parallel_for(int64_t n, F&& body) {
    int t = n_threads_for(n);
    if (t <= 1) {
        body(0, n);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n + t - 1) / t;
    for (int i = 0; i < t; ++i) {
        int64_t lo = i * chunk;
        int64_t hi = std::min<int64_t>(lo + chunk, n);
        if (lo >= hi) break;
        threads.emplace_back([&body, lo, hi] { body(lo, hi); });
    }
    for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// For each point, index of the first containing box (or -1).
// points (N, pstride>=3), boxes (M, 7) -> out (N,) int32
void points_in_boxes_first(const float* points, int64_t n, int64_t pstride,
                           const float* boxes, int64_t m, int32_t* out) {
    std::vector<float> cosv(m), sinv(m);
    for (int64_t j = 0; j < m; ++j) {
        cosv[j] = std::cos(-boxes[j * 7 + 6]);
        sinv[j] = std::sin(-boxes[j * 7 + 6]);
    }
    parallel_for(n, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            const float* p = points + i * pstride;
            int32_t hit = -1;
            for (int64_t j = 0; j < m; ++j) {
                const float* b = boxes + j * 7;
                float dx = p[0] - b[0], dy = p[1] - b[1], dz = p[2] - b[2];
                if (std::fabs(dz) > b[5] * 0.5f) continue;
                float lx = dx * cosv[j] - dy * sinv[j];
                if (std::fabs(lx) > b[3] * 0.5f) continue;
                float ly = dx * sinv[j] + dy * cosv[j];
                if (std::fabs(ly) > b[4] * 0.5f) continue;
                hit = static_cast<int32_t>(j);
                break;
            }
            out[i] = hit;
        }
    });
}

// Per-box membership masks: out (M, N) uint8.
void points_in_boxes_mask(const float* points, int64_t n, int64_t pstride,
                          const float* boxes, int64_t m, uint8_t* out) {
    parallel_for(m, [&](int64_t lo, int64_t hi) {
        for (int64_t j = lo; j < hi; ++j) {
            const float* b = boxes + j * 7;
            float c = std::cos(-b[6]), s = std::sin(-b[6]);
            float hx = b[3] * 0.5f, hy = b[4] * 0.5f, hz = b[5] * 0.5f;
            uint8_t* row = out + j * n;
            for (int64_t i = 0; i < n; ++i) {
                const float* p = points + i * pstride;
                float dx = p[0] - b[0], dy = p[1] - b[1], dz = p[2] - b[2];
                float lx = dx * c - dy * s;
                float ly = dx * s + dy * c;
                row[i] = (std::fabs(lx) <= hx) & (std::fabs(ly) <= hy) &
                         (std::fabs(dz) <= hz);
            }
        }
    });
}

// Apply a row-major 4x4 pose to xyz (in place on a copy buffer).
void rigid_transform(const float* points, int64_t n, int64_t pstride,
                     const float* pose, float* out, int64_t ostride) {
    parallel_for(n, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            const float* p = points + i * pstride;
            float* q = out + i * ostride;
            float x = p[0], y = p[1], z = p[2];
            q[0] = pose[0] * x + pose[1] * y + pose[2] * z + pose[3];
            q[1] = pose[4] * x + pose[5] * y + pose[6] * z + pose[7];
            q[2] = pose[8] * x + pose[9] * y + pose[10] * z + pose[11];
        }
    });
}

// Waymo lidar decode: drop NLZ-flagged rows, tanh the intensity channel.
// in (N, 6) [x y z intensity elongation nlz] -> out (N, 5); returns kept count.
int64_t decode_waymo_points(const float* in, int64_t n, float* out) {
    int64_t k = 0;
    for (int64_t i = 0; i < n; ++i) {
        const float* p = in + i * 6;
        if (p[5] != -1.0f) continue;
        float* q = out + k * 5;
        q[0] = p[0]; q[1] = p[1]; q[2] = p[2];
        q[3] = std::tanh(p[3]);
        q[4] = p[4];
        ++k;
    }
    return k;
}

// Voxel-grid deduplication: keeps the first point of each voxel of a grid
// anchored at the origin (outline_utils' voxel_sampling keeps the last, on a
// grid at the cloud's minimum). Returns kept count; kept indices in out_idx.
int64_t voxel_downsample(const float* points, int64_t n, int64_t pstride,
                         float voxel, int32_t* out_idx) {
    std::unordered_set<int64_t> seen;
    seen.reserve(static_cast<size_t>(n));
    int64_t k = 0;
    const double inv = 1.0 / voxel;
    for (int64_t i = 0; i < n; ++i) {
        const float* p = points + i * pstride;
        int64_t gx = static_cast<int64_t>(std::floor(p[0] * inv));
        int64_t gy = static_cast<int64_t>(std::floor(p[1] * inv));
        int64_t gz = static_cast<int64_t>(std::floor(p[2] * inv));
        // 21 bits per axis, offset to positive
        int64_t key = ((gx + (1 << 20)) << 42) | ((gy + (1 << 20)) << 21) | (gz + (1 << 20));
        if (seen.insert(key).second) out_idx[k++] = static_cast<int32_t>(i);
    }
    return k;
}

}  // extern "C"
