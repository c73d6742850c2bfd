// Fast delimited numeric-table parser (native ingestion runtime).
//
// The reference loads OTU tables through Julia's readdlm (reference:
// src/io.jl:155-191), which is compiled native code; a pure-Python
// cell-by-cell loop is 50-100x slower at the 100k-variable scale the
// reference targets.  This parser mmaps the file, indexes line offsets in
// one memchr pass, and converts cells with std::from_chars across a thread
// pool, writing straight into a caller-provided (numpy) buffer.
//
// Exposed via ctypes (see flashweave_tpu/native/__init__.py); any parse
// failure returns a non-zero code and the caller falls back to the exact
// slow path, so behavior never diverges.

#include <atomic>
#include <cctype>
#include <charconv>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedFile {
    const char* data = nullptr;
    size_t size = 0;
    int fd = -1;

    bool open_map(const char* path) {
        fd = ::open(path, O_RDONLY);
        if (fd < 0) return false;
        struct stat st;
        if (fstat(fd, &st) != 0 || st.st_size == 0) return false;
        size = static_cast<size_t>(st.st_size);
        void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
        if (p == MAP_FAILED) return false;
        data = static_cast<const char*>(p);
        madvise(p, size, MADV_SEQUENTIAL);
        return true;
    }

    ~MappedFile() {
        if (data) munmap(const_cast<char*>(data), size);
        if (fd >= 0) ::close(fd);
    }
};

inline bool blank_line(const char* b, const char* e) {
    for (const char* p = b; p < e; ++p)
        if (!std::isspace(static_cast<unsigned char>(*p))) return false;
    return true;
}

// Collect [start, end) offsets of non-blank lines.
void index_lines(const MappedFile& f,
                 std::vector<std::pair<const char*, const char*>>& lines) {
    const char* p = f.data;
    const char* end = f.data + f.size;
    while (p < end) {
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        const char* le = nl ? nl : end;
        if (!blank_line(p, le)) lines.emplace_back(p, le);
        p = le + 1;
    }
}

// Parse one cell (trimmed of spaces/'\r') into out; false on failure.
inline bool parse_cell(const char* b, const char* e, double* out) {
    while (b < e && (*b == ' ' || *b == '\r' || *b == '\t')) ++b;
    while (e > b && (e[-1] == ' ' || e[-1] == '\r' || e[-1] == '\t')) --e;
    if (b >= e) return false;
    if (*b == '+') ++b;  // from_chars rejects leading '+'
    auto res = std::from_chars(b, e, *out);
    return res.ec == std::errc() && res.ptr == e;
}

// Parse row [b,e) into dst[0..n_cols), skipping skip_cols leading fields.
inline bool parse_row(const char* b, const char* e, char sep, long skip_cols,
                      double* dst, long n_cols) {
    long col = -skip_cols;
    const char* field = b;
    for (const char* p = b; ; ++p) {
        if (p == e || *p == sep) {
            if (col >= 0) {
                if (col >= n_cols) return false;  // too many fields
                if (!parse_cell(field, p, dst + col)) return false;
            }
            ++col;
            if (p == e) break;
            field = p + 1;
        }
    }
    return col == n_cols;
}

}  // namespace

extern "C" {

// Dimensions: non-blank line count, field count of the first and of the
// second non-blank line (header vs first data row).  Returns 0 on success.
long fw_scan_table(const char* path, char sep, long* n_lines,
                   long* n_cols_first, long* n_cols_second) {
    MappedFile f;
    if (!f.open_map(path)) return 1;
    std::vector<std::pair<const char*, const char*>> lines;
    index_lines(f, lines);
    *n_lines = static_cast<long>(lines.size());
    for (int i = 0; i < 2; ++i) {
        long* out = i == 0 ? n_cols_first : n_cols_second;
        *out = 0;
        if (static_cast<size_t>(i) >= lines.size()) continue;
        long n = 1;
        for (const char* p = lines[i].first; p < lines[i].second; ++p)
            if (*p == sep) ++n;
        *out = n;
    }
    return 0;
}

// Copy the first field of every non-blank line after the first (the
// candidate row-id column) into a fixed-width char buffer (width bytes per
// row, NUL-padded; ids longer than width-1 fail).  Returns 0 on success.
long fw_first_fields(const char* path, char sep, char* out, long width,
                     long n_rows) {
    MappedFile f;
    if (!f.open_map(path)) return 1;
    std::vector<std::pair<const char*, const char*>> lines;
    index_lines(f, lines);
    if (static_cast<long>(lines.size()) < n_rows + 1) return 2;
    for (long r = 0; r < n_rows; ++r) {
        auto [b, e] = lines[r + 1];
        const char* p = static_cast<const char*>(
            memchr(b, sep, static_cast<size_t>(e - b)));
        const char* fe = p ? p : e;
        while (fe > b && fe[-1] == '\r') --fe;
        long len = static_cast<long>(fe - b);
        if (len >= width) return 3;
        memcpy(out + r * width, b, static_cast<size_t>(len));
        memset(out + r * width + len, 0, static_cast<size_t>(width - len));
    }
    return 0;
}

// Parse the numeric block: rows [skip_rows, skip_rows + n_rows) of the
// non-blank lines, fields [skip_cols, skip_cols + n_cols), into out
// (row-major n_rows x n_cols).  Returns 0 on success, >0 on structural or
// cell-parse failure anywhere (caller falls back to the slow path).
long fw_parse_numeric(const char* path, char sep, long skip_rows,
                      long skip_cols, double* out, long n_rows, long n_cols,
                      long n_threads) {
    MappedFile f;
    if (!f.open_map(path)) return 1;
    std::vector<std::pair<const char*, const char*>> lines;
    index_lines(f, lines);
    if (static_cast<long>(lines.size()) < skip_rows + n_rows) return 2;

    if (n_threads <= 0) {
        n_threads = static_cast<long>(std::thread::hardware_concurrency());
        if (n_threads <= 0) n_threads = 1;
    }
    n_threads = std::min<long>(n_threads, std::max<long>(1, n_rows / 256));

    std::atomic<long> err{0};
    auto worker = [&](long r0, long r1) {
        for (long r = r0; r < r1; ++r) {
            if (err.load(std::memory_order_relaxed)) return;
            auto [b, e] = lines[skip_rows + r];
            if (!parse_row(b, e, sep, skip_cols, out + r * n_cols, n_cols)) {
                err.store(3 + r, std::memory_order_relaxed);
                return;
            }
        }
    };

    if (n_threads <= 1) {
        worker(0, n_rows);
    } else {
        std::vector<std::thread> pool;
        long chunk = (n_rows + n_threads - 1) / n_threads;
        for (long t = 0; t < n_threads; ++t) {
            long r0 = t * chunk;
            long r1 = std::min(n_rows, r0 + chunk);
            if (r0 >= r1) break;
            pool.emplace_back(worker, r0, r1);
        }
        for (auto& th : pool) th.join();
    }
    return err.load();
}

}  // extern "C"
