// Bag decoder of the PyTorch/CUDA port (gcslam_torch): the host side of the
// offline frontend. It is native/gcslam_native.cpp (the JAX package's native
// bag-decode library) without its libjpeg decoder: the GPU hosts the port
// runs on have no libjpeg headers, and the port decodes JPEG frames with
// PIL, and without its stride point-budget resample, which no frontend
// calls. The rest is the same code: PointCloud2 / IMU / Odometry CDR
// parsing, the visual-feature stage and the async rosbag2 sqlite streamer.
//
// Plain C ABI (ctypes-friendly). Little-endian XCDR1 payloads only (the
// rosbag2 default); anything else is refused.
//
// Build: gcslam_torch/frontend/native.py (g++ -O3 -march=native -shared -fPIC)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

struct Reader {
    const uint8_t* buf;
    size_t len;
    size_t off;  // absolute offset; body starts at 4

    bool ok() const { return off <= len; }
    void align(size_t size) {
        size_t rel = off - 4;
        off += (size - (rel % size)) % size;
    }
    uint8_t u8() { return off < len ? buf[off++] : 0; }
    uint16_t u16() {
        align(2);
        uint16_t v = 0;
        if (off + 2 <= len) std::memcpy(&v, buf + off, 2);
        off += 2;
        return v;
    }
    uint32_t u32() {
        align(4);
        uint32_t v = 0;
        if (off + 4 <= len) std::memcpy(&v, buf + off, 4);
        off += 4;
        return v;
    }
    int32_t i32() { return (int32_t)u32(); }
    double f64() {
        align(8);
        double v = 0;
        if (off + 8 <= len) std::memcpy(&v, buf + off, 8);
        off += 8;
        return v;
    }
    void f64n(double* out, size_t n) {
        align(8);
        if (off + 8 * n <= len) std::memcpy(out, buf + off, 8 * n);
        off += 8 * n;
    }
    void skip_string() {
        uint32_t n = u32();
        off += n;
    }
    double header_stamp() {
        int32_t sec = i32();
        uint32_t nsec = u32();
        skip_string();  // frame_id
        return (double)sec + 1e-9 * (double)nsec;
    }
};

inline float read_field_f(const uint8_t* p, uint8_t dt) {
    switch (dt) {
        case 1: return (float)(int8_t)*p;
        case 2: return (float)*p;
        case 3: { int16_t v; std::memcpy(&v, p, 2); return (float)v; }
        case 4: { uint16_t v; std::memcpy(&v, p, 2); return (float)v; }
        case 5: { int32_t v; std::memcpy(&v, p, 4); return (float)v; }
        case 6: { uint32_t v; std::memcpy(&v, p, 4); return (float)v; }
        case 7: { float v; std::memcpy(&v, p, 4); return v; }
        case 8: { double v; std::memcpy(&v, p, 8); return (float)v; }
        default: return 0.f;
    }
}

}  // namespace

extern "C" {

// Decode one PointCloud2 CDR payload. Outputs must be preallocated to
// max_points. Returns the number of points written, or -1 on parse error.
// header_stamp_out receives the message stamp (seconds).
int32_t gcslam_parse_pointcloud2(
    const uint8_t* buf, int64_t len, int64_t max_points,
    float* xyz_out,      // (max_points, 3)
    double* t_out,       // (max_points,)
    int32_t* ring_out,   // (max_points,)
    int32_t* tag_out,    // (max_points,)
    double* header_stamp_out,
    double nonfinite_sentinel) {
    if (len < 8 || buf[1] != 0x01) return -1;  // LE CDR only
    Reader r{buf, (size_t)len, 4};
    *header_stamp_out = r.header_stamp();
    uint32_t height = r.u32();
    uint32_t width = r.u32();
    uint32_t n_fields = r.u32();

    struct F { uint32_t off; uint8_t dt; };
    F fx{0, 0}, fy{0, 0}, fz{0, 0}, fr{0, 0}, ft{0, 0};
    bool has_r = false, has_t = false;
    for (uint32_t i = 0; i < n_fields && r.ok(); ++i) {
        uint32_t nlen = r.u32();
        const char* name = (const char*)(buf + r.off);
        size_t name_len = nlen > 0 ? nlen - 1 : 0;
        r.off += nlen;
        uint32_t foff = r.u32();
        uint8_t dt = r.u8();
        r.u32();  // count
        if (name_len == 1 && name[0] == 'x') fx = {foff, dt};
        else if (name_len == 1 && name[0] == 'y') fy = {foff, dt};
        else if (name_len == 1 && name[0] == 'z') fz = {foff, dt};
        else if (name_len == 4 && !std::strncmp(name, "ring", 4)) { fr = {foff, dt}; has_r = true; }
        else if ((name_len == 1 && name[0] == 't') ||
                 (name_len == 4 && !std::strncmp(name, "time", 4))) { ft = {foff, dt}; has_t = true; }
    }
    r.u8();  // is_bigendian
    uint32_t point_step = r.u32();
    r.u32();  // row_step
    uint32_t data_len = r.u32();
    const uint8_t* data = buf + r.off;
    if (r.off + data_len > (size_t)len) return -1;

    int64_t n = (int64_t)height * (int64_t)width;
    if (n > max_points) n = max_points;
    if ((int64_t)point_step * n > (int64_t)data_len) n = data_len / point_step;

    double t_scale = 1.0;
    // detect ns vs s on the first point
    if (has_t && n > 0) {
        float t0 = read_field_f(data + ft.off, ft.dt);
        if (t0 > 1e6f) t_scale = 1e-9;
    }
    const double sent = nonfinite_sentinel;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* p = data + (size_t)i * point_step;
        float vx = read_field_f(p + fx.off, fx.dt);
        float vy = read_field_f(p + fy.off, fy.dt);
        float vz = read_field_f(p + fz.off, fz.dt);
        xyz_out[3 * i + 0] = std::isfinite(vx) ? vx : (float)sent;
        xyz_out[3 * i + 1] = std::isfinite(vy) ? vy : (float)sent;
        xyz_out[3 * i + 2] = std::isfinite(vz) ? vz : (float)sent;
        ring_out[i] = has_r ? (int32_t)read_field_f(p + fr.off, fr.dt) : 0;
        tag_out[i] = 0;
        if (has_t) {
            double tv = (double)read_field_f(p + ft.off, ft.dt) * t_scale;
            t_out[i] = (tv < 1e5) ? tv + *header_stamp_out : tv;
        } else {
            t_out[i] = *header_stamp_out;
        }
    }
    return (int32_t)n;
}

// Decode a batch of Imu CDR payloads (concatenated, with an offsets table).
// Outputs: stamps (n,), gyro (n,3), accel (n,3). Returns n decoded.
int32_t gcslam_parse_imu_batch(
    const uint8_t* blob, const int64_t* offsets, const int64_t* lengths,
    int64_t n_msgs, double* stamps_out, double* gyro_out, double* accel_out) {
    for (int64_t i = 0; i < n_msgs; ++i) {
        Reader r{blob + offsets[i], (size_t)lengths[i], 4};
        stamps_out[i] = r.header_stamp();
        double q[4], cov[9];
        r.f64n(q, 4);
        r.f64n(cov, 9);
        r.f64n(gyro_out + 3 * i, 3);
        r.f64n(cov, 9);
        r.f64n(accel_out + 3 * i, 3);
    }
    return (int32_t)n_msgs;
}

// Decode a batch of Odometry CDR payloads.
// Outputs: stamps (n,), pos (n,3), quat (n,4) xyzw, pose_cov (n,36),
// twist (n,6), twist_cov (n,36).
int32_t gcslam_parse_odometry_batch(
    const uint8_t* blob, const int64_t* offsets, const int64_t* lengths,
    int64_t n_msgs, double* stamps_out, double* pos_out, double* quat_out,
    double* pose_cov_out, double* twist_out, double* twist_cov_out) {
    for (int64_t i = 0; i < n_msgs; ++i) {
        Reader r{blob + offsets[i], (size_t)lengths[i], 4};
        stamps_out[i] = r.header_stamp();
        r.skip_string();  // child_frame_id
        r.f64n(pos_out + 3 * i, 3);
        r.f64n(quat_out + 4 * i, 4);
        r.f64n(pose_cov_out + 36 * i, 36);
        r.f64n(twist_out + 6 * i, 3);      // linear
        r.f64n(twist_out + 6 * i + 3, 3);  // angular
        r.f64n(twist_cov_out + 36 * i, 36);
    }
    return (int32_t)n_msgs;
}

// ---------------------------------------------------------------------------
// Visual feature extraction — the native preprocessing stage the reference
// implements as src/visual_feature_node.cpp (ORB + robust depth sampling +
// quadratic depth-surface fit). Clean-room equivalent: Shi-Tomasi min-eigen
// corners on Sobel gradients, 2D grid NMS, robust (median/MAD) depth window,
// and a least-squares depth plane fit giving normal + residual variance.
// One pass per frame on the host; the Gaussian/vMF lifting runs in torch.
// ---------------------------------------------------------------------------

int32_t gcslam_visual_features(
    const uint8_t* gray,   // (H*W) row-major
    const float* depth,    // (H*W) meters, <=0/NaN = invalid
    int32_t W, int32_t H,
    int32_t max_feat,
    float min_score,       // Shi-Tomasi threshold (relative to 8-bit scale)
    int32_t nms_radius,    // grid cell half-size, e.g. 6
    float* out_uv,         // (max_feat,2)
    float* out_score,      // (max_feat)
    float* out_z,          // (max_feat) robust window median depth
    float* out_zvar,       // (max_feat) MAD^2 + plane residual
    float* out_normal,     // (max_feat,3) camera-frame plane normal (unit, z<0 toward cam flipped to z>0 convention of caller)
    float* out_color)      // (max_feat) gray intensity [0,1]
{
    if (W < 8 || H < 8 || max_feat <= 0) return 0;
    const int B = 3;  // Sobel + window border
    std::vector<float> score((size_t)W * H, 0.f);

    // Shi-Tomasi: structure tensor over a 3x3 window of Sobel gradients.
    for (int y = B; y < H - B; ++y) {
        for (int x = B; x < W - B; ++x) {
            float sxx = 0.f, syy = 0.f, sxy = 0.f;
            for (int dy = -1; dy <= 1; ++dy) {
                for (int dx = -1; dx <= 1; ++dx) {
                    const int i = (y + dy) * W + (x + dx);
                    const float gx =
                        (float)(gray[i + 1] - gray[i - 1]) * 2.f +
                        (float)(gray[i - W + 1] - gray[i - W - 1]) +
                        (float)(gray[i + W + 1] - gray[i + W - 1]);
                    const float gy =
                        (float)(gray[i + W] - gray[i - W]) * 2.f +
                        (float)(gray[i + W - 1] - gray[i - W - 1]) +
                        (float)(gray[i + W + 1] - gray[i - W + 1]);
                    sxx += gx * gx;
                    syy += gy * gy;
                    sxy += gx * gy;
                }
            }
            const float tr = 0.5f * (sxx + syy);
            const float det = sxx * syy - sxy * sxy;
            const float disc = tr * tr - det;
            const float mineig = tr - std::sqrt(disc > 0.f ? disc : 0.f);
            score[(size_t)y * W + x] = mineig / (255.f * 255.f * 36.f);
        }
    }

    // Grid NMS: best corner per (2*nms_radius+1) cell, then global top-N.
    struct Cand { float s; int x, y; };
    std::vector<Cand> cands;
    const int cell = nms_radius > 0 ? 2 * nms_radius + 1 : 7;
    for (int cy = B; cy < H - B; cy += cell) {
        for (int cx = B; cx < W - B; cx += cell) {
            float best = min_score;
            int bx = -1, by = -1;
            const int ye = cy + cell < H - B ? cy + cell : H - B;
            const int xe = cx + cell < W - B ? cx + cell : W - B;
            for (int y = cy; y < ye; ++y)
                for (int x = cx; x < xe; ++x) {
                    const float s = score[(size_t)y * W + x];
                    if (s > best) { best = s; bx = x; by = y; }
                }
            if (bx >= 0) cands.push_back({best, bx, by});
        }
    }
    // partial selection of top max_feat by score
    if ((int32_t)cands.size() > max_feat) {
        std::nth_element(cands.begin(), cands.begin() + max_feat, cands.end(),
                         [](const Cand& a, const Cand& b) { return a.s > b.s; });
        cands.resize(max_feat);
    }

    int32_t n = 0;
    std::vector<float> zwin;
    zwin.reserve(49);
    for (const Cand& c : cands) {
        if (n >= max_feat) break;
        // robust depth over a 7x7 window
        zwin.clear();
        for (int dy = -3; dy <= 3; ++dy)
            for (int dx = -3; dx <= 3; ++dx) {
                const int x = c.x + dx, y = c.y + dy;
                if (x < 0 || y < 0 || x >= W || y >= H) continue;
                const float z = depth[(size_t)y * W + x];
                if (z > 0.f && std::isfinite(z)) zwin.push_back(z);
            }
        if (zwin.size() < 8) continue;  // no usable depth support
        std::sort(zwin.begin(), zwin.end());
        const float zmed = zwin[zwin.size() / 2];
        float mad = 0.f;
        {
            std::vector<float> dev(zwin.size());
            for (size_t i = 0; i < zwin.size(); ++i) dev[i] = std::fabs(zwin[i] - zmed);
            std::sort(dev.begin(), dev.end());
            mad = dev[dev.size() / 2];
        }
        const float sigma_z = 1.4826f * mad + 1e-4f;

        // depth plane fit z(dx,dy) = a*dx + b*dy + c over inliers (|z-med|<3sig)
        double Sxx = 0, Syy = 0, Sxy = 0, Sx = 0, Sy = 0, S1 = 0;
        double Sxz = 0, Syz = 0, Sz = 0;
        for (int dy = -3; dy <= 3; ++dy)
            for (int dx = -3; dx <= 3; ++dx) {
                const int x = c.x + dx, y = c.y + dy;
                if (x < 0 || y < 0 || x >= W || y >= H) continue;
                const float z = depth[(size_t)y * W + x];
                if (!(z > 0.f) || !std::isfinite(z)) continue;
                if (std::fabs(z - zmed) > 3.f * sigma_z + 1e-3f) continue;
                Sxx += dx * dx; Syy += dy * dy; Sxy += dx * dy;
                Sx += dx; Sy += dy; S1 += 1;
                Sxz += dx * z; Syz += dy * z; Sz += z;
            }
        double a = 0, b = 0, resid_var = sigma_z * sigma_z;
        if (S1 >= 6) {
            // solve [Sxx Sxy Sx; Sxy Syy Sy; Sx Sy S1] [a b c] = [Sxz Syz Sz]
            const double A[9] = {Sxx, Sxy, Sx, Sxy, Syy, Sy, Sx, Sy, S1};
            const double r[3] = {Sxz, Syz, Sz};
            const double det =
                A[0] * (A[4] * A[8] - A[5] * A[7]) -
                A[1] * (A[3] * A[8] - A[5] * A[6]) +
                A[2] * (A[3] * A[7] - A[4] * A[6]);
            if (std::fabs(det) > 1e-9) {
                const double inv0 = (A[4] * A[8] - A[5] * A[7]) / det;
                const double inv1 = (A[2] * A[7] - A[1] * A[8]) / det;
                const double inv2 = (A[1] * A[5] - A[2] * A[4]) / det;
                const double inv3 = (A[5] * A[6] - A[3] * A[8]) / det;
                const double inv4 = (A[0] * A[8] - A[2] * A[6]) / det;
                const double inv5 = (A[2] * A[3] - A[0] * A[5]) / det;
                a = inv0 * r[0] + inv1 * r[1] + inv2 * r[2];
                b = inv3 * r[0] + inv4 * r[1] + inv5 * r[2];
                (void)inv5;
            }
        }
        // camera-frame normal from image-space depth gradient (pinhole
        // small-window approximation): n ∝ (-a, -b, px_size) normalized,
        // where the caller rescales by fx/fy; we export the raw gradient
        // normal in the (du, dv, 1) basis and let Python apply intrinsics.
        const double nx = -a, ny = -b, nz = 1.0;
        const double nn = std::sqrt(nx * nx + ny * ny + nz * nz) + 1e-12;

        out_uv[2 * n + 0] = (float)c.x;
        out_uv[2 * n + 1] = (float)c.y;
        out_score[n] = c.s;
        out_z[n] = zmed;
        out_zvar[n] = (float)resid_var;
        out_normal[3 * n + 0] = (float)(nx / nn);
        out_normal[3 * n + 1] = (float)(ny / nn);
        out_normal[3 * n + 2] = (float)(nz / nn);
        out_color[n] = (float)gray[(size_t)c.y * W + c.x] / 255.f;
        ++n;
    }
    return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Async bag streamer (the data-loader's async half): a worker thread reads
// the LiDAR topic's rows straight out of the rosbag2 sqlite container and
// parses each PointCloud2 into fixed-shape buffers while the consumer
// assembles batches — the offline analog of the reference's async LiDAR
// worker + bounded queue (backend_node.py:1340-1388). libsqlite3 is loaded
// via dlopen (the image ships the runtime .so but no dev headers), so the
// minimal C API is declared here.

#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>

#include <dlfcn.h>

namespace {

typedef struct sqlite3 sqlite3;
typedef struct sqlite3_stmt sqlite3_stmt;
constexpr int SQLITE_OK_ = 0, SQLITE_ROW_ = 100, SQLITE_OPEN_READONLY_ = 1;

struct SqliteApi {
    void* dl = nullptr;
    int (*open_v2)(const char*, sqlite3**, int, const char*) = nullptr;
    int (*prepare_v2)(sqlite3*, const char*, int, sqlite3_stmt**, const char**) = nullptr;
    int (*bind_text)(sqlite3_stmt*, int, const char*, int, void (*)(void*)) = nullptr;
    int (*step)(sqlite3_stmt*) = nullptr;
    const void* (*column_blob)(sqlite3_stmt*, int) = nullptr;
    int (*column_bytes)(sqlite3_stmt*, int) = nullptr;
    long long (*column_int64)(sqlite3_stmt*, int) = nullptr;
    int (*finalize)(sqlite3_stmt*) = nullptr;
    int (*close_db)(sqlite3*) = nullptr;

    bool load() {
        if (dl) return true;
        dl = dlopen("libsqlite3.so.0", RTLD_NOW | RTLD_LOCAL);
        if (!dl) dl = dlopen("libsqlite3.so", RTLD_NOW | RTLD_LOCAL);
        if (!dl) return false;
        open_v2 = (decltype(open_v2))dlsym(dl, "sqlite3_open_v2");
        prepare_v2 = (decltype(prepare_v2))dlsym(dl, "sqlite3_prepare_v2");
        bind_text = (decltype(bind_text))dlsym(dl, "sqlite3_bind_text");
        step = (decltype(step))dlsym(dl, "sqlite3_step");
        column_blob = (decltype(column_blob))dlsym(dl, "sqlite3_column_blob");
        column_bytes = (decltype(column_bytes))dlsym(dl, "sqlite3_column_bytes");
        column_int64 = (decltype(column_int64))dlsym(dl, "sqlite3_column_int64");
        finalize = (decltype(finalize))dlsym(dl, "sqlite3_finalize");
        close_db = (decltype(close_db))dlsym(dl, "sqlite3_close");
        return open_v2 && prepare_v2 && bind_text && step && column_blob &&
               column_bytes && column_int64 && finalize && close_db;
    }
};

SqliteApi g_sql;

struct ScanSlot {
    std::vector<float> xyz;
    std::vector<double> t;
    std::vector<int32_t> ring, tag;
    double stamp = 0.0, bag_t = 0.0;
    int32_t n = 0;
};

struct StreamHandle {
    std::thread worker;
    std::mutex mu;
    std::condition_variable cv_space, cv_data;
    std::deque<ScanSlot> q;
    size_t depth;
    int64_t max_points;
    double sentinel;
    bool done = false, closed = false;
    int32_t n_skipped = 0;
    std::string db, topic;

    void run() {
        sqlite3* conn = nullptr;
        sqlite3_stmt* st = nullptr;
        if (!g_sql.load() ||
            g_sql.open_v2(db.c_str(), &conn, SQLITE_OPEN_READONLY_, nullptr) != SQLITE_OK_) {
            std::lock_guard<std::mutex> lk(mu);
            done = true;
            cv_data.notify_all();
            return;
        }
        const char* sql =
            "SELECT m.timestamp, m.data FROM messages m "
            "JOIN topics t ON m.topic_id = t.id WHERE t.name = ?1 "
            "ORDER BY m.timestamp";
        // Reused scratch (sized once): per-slot storage holds only the n
        // points actually parsed — per-scan max_points-sized zero-inits were
        // 28 MB/scan of pure memset.
        std::vector<float> sx((size_t)max_points * 3);
        std::vector<double> stm(max_points);
        std::vector<int32_t> srg(max_points), stg(max_points);
        if (g_sql.prepare_v2(conn, sql, -1, &st, nullptr) == SQLITE_OK_) {
            g_sql.bind_text(st, 1, topic.c_str(), -1, (void (*)(void*))(intptr_t)-1);
            while (g_sql.step(st) == SQLITE_ROW_) {
                {
                    std::unique_lock<std::mutex> lk(mu);
                    cv_space.wait(lk, [&] { return q.size() < depth || closed; });
                    if (closed) break;
                }
                ScanSlot s;
                s.bag_t = (double)g_sql.column_int64(st, 0) * 1e-9;
                const uint8_t* blob = (const uint8_t*)g_sql.column_blob(st, 1);
                int64_t blen = g_sql.column_bytes(st, 1);
                s.n = blob ? gcslam_parse_pointcloud2(
                                 blob, blen, max_points, sx.data(), stm.data(),
                                 srg.data(), stg.data(), &s.stamp, sentinel)
                           : -1;
                if (s.n > 0) {
                    s.xyz.assign(sx.begin(), sx.begin() + (size_t)s.n * 3);
                    s.t.assign(stm.begin(), stm.begin() + s.n);
                    s.ring.assign(srg.begin(), srg.begin() + s.n);
                    s.tag.assign(stg.begin(), stg.begin() + s.n);
                }
                std::unique_lock<std::mutex> lk(mu);
                if (closed) break;
                if (s.n < 0) {
                    ++n_skipped;
                } else {
                    q.push_back(std::move(s));
                    cv_data.notify_one();
                }
            }
            g_sql.finalize(st);
        }
        g_sql.close_db(conn);
        std::lock_guard<std::mutex> lk(mu);
        done = true;
        cv_data.notify_all();
    }
};

}  // namespace

extern "C" {

// Open an async PointCloud2 stream over a rosbag2 sqlite file. Returns an
// opaque handle, or null when libsqlite3 cannot be loaded.
void* gcslam_stream_open(const char* db_path, const char* topic,
                         int64_t max_points, double nonfinite_sentinel,
                         int32_t queue_depth) {
    if (!g_sql.load()) return nullptr;
    auto* h = new StreamHandle();
    h->db = db_path;
    h->topic = topic;
    h->max_points = max_points;
    h->sentinel = nonfinite_sentinel;
    h->depth = queue_depth > 0 ? (size_t)queue_depth : 4;
    h->worker = std::thread([h] { h->run(); });
    return h;
}

// Pop the next parsed scan into preallocated outputs (max_points-sized, as
// in gcslam_parse_pointcloud2). Blocks until data or end-of-topic.
// Returns n_points, or -1 at end of stream.
int32_t gcslam_stream_next(void* handle, float* xyz_out, double* t_out,
                           int32_t* ring_out, int32_t* tag_out,
                           double* header_stamp_out, double* bag_t_out) {
    auto* h = (StreamHandle*)handle;
    ScanSlot s;
    {
        std::unique_lock<std::mutex> lk(h->mu);
        h->cv_data.wait(lk, [&] { return !h->q.empty() || h->done; });
        if (h->q.empty()) return -1;
        s = std::move(h->q.front());
        h->q.pop_front();
        h->cv_space.notify_one();
    }
    std::memcpy(xyz_out, s.xyz.data(), sizeof(float) * 3 * s.n);
    std::memcpy(t_out, s.t.data(), sizeof(double) * s.n);
    std::memcpy(ring_out, s.ring.data(), sizeof(int32_t) * s.n);
    std::memcpy(tag_out, s.tag.data(), sizeof(int32_t) * s.n);
    *header_stamp_out = s.stamp;
    *bag_t_out = s.bag_t;
    return s.n;
}

// Number of rows skipped because their payload failed to parse.
int32_t gcslam_stream_skipped(void* handle) {
    auto* h = (StreamHandle*)handle;
    std::lock_guard<std::mutex> lk(h->mu);
    return h->n_skipped;
}

void gcslam_stream_close(void* handle) {
    auto* h = (StreamHandle*)handle;
    {
        std::lock_guard<std::mutex> lk(h->mu);
        h->closed = true;
        h->cv_space.notify_all();
        h->cv_data.notify_all();
    }
    if (h->worker.joinable()) h->worker.join();
    delete h;
}

}  // extern "C"
