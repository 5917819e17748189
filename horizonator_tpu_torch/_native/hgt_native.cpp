// Native DEM loader: the hot path of the mosaic assembly.
//
// The reference implements its DEM layer in C (dem.c: mmap + per-sample
// byte-swap on demand). This is its native equivalent on the host, doing
// strictly more per pass: for each tile it fuses mmap -> big-endian decode ->
// north-first flip -> sea-level clamp -> window copy into the caller's
// mosaic grid, single pass, no temporaries. Exposed to Python via ctypes
// (horizonator_tpu_torch/_native/__init__.py), with a pure-numpy fallback;
// the DEM functions are those of horizonator_tpu/_native/hgt_native.cpp.
// The same library holds the PNG row unfilter of the map-tile decoder
// (horizonator_tpu_torch/_png.py), whose Average and Paeth rows are a
// byte-serial loop.
//
// Build: g++ -O3 -shared -fPIC hgt_native.cpp -o libhgt_native.so

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

inline int16_t decode_clamp(const unsigned char* p) {
    // big-endian int16; negative elevations clamp to 0 (dem.c:307-308)
    int16_t z = (int16_t)((p[0] << 8) | p[1]);
    return z < 0 ? 0 : z;
}

}  // namespace

extern "C" {

// Copy one .hgt tile's intersection with the mosaic window.
//
//   path           tile file
//   edge           1201 (SRTM3) or 3601 (SRTM1); file must be edge*edge*2 B
//   grid           (n x n) int16 row-major, row 0 = SOUTH edge of the window
//   n              window edge in cells
//   dst_i0,dst_j0  where the tile's (0,0) SOUTH-first sample lands in the
//                  window (may be negative)
//
// Returns 0 on success, 1 empty (zero-size) file (caller treats as silent
// sea, dem.c:210-221), 2 size mismatch, 3 io error, 4 open failure -- an
// EXISTING but unreadable tile (permissions, I/O race after the caller's
// exists() check) must be distinguishable from an empty one so the caller
// can warn instead of silently rendering ocean.
int hgt_blit_window(const char* path, int edge,
                    int16_t* grid, int n,
                    long dst_i0, long dst_j0) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return 4;
    struct stat sb;
    if (fstat(fd, &sb) != 0) { close(fd); return 3; }
    if (sb.st_size == 0) { close(fd); return 1; }
    if (sb.st_size != (long)edge * edge * 2) { close(fd); return 2; }

    const unsigned char* dem = (const unsigned char*)
        mmap(nullptr, sb.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (dem == MAP_FAILED) { close(fd); return 3; }

    // tile sample (i, j_south) lives at file row (edge-1-j_south), col i
    // intersection with [0, n) x [0, n) of the window
    long i_lo = dst_i0 < 0 ? -dst_i0 : 0;           // in tile coords
    long j_lo = dst_j0 < 0 ? -dst_j0 : 0;
    long i_hi = edge - 1;
    long j_hi = edge - 1;
    if (dst_i0 + i_hi > n - 1) i_hi = n - 1 - dst_i0;
    if (dst_j0 + j_hi > n - 1) j_hi = n - 1 - dst_j0;

    for (long j = j_lo; j <= j_hi; ++j) {
        const unsigned char* src =
            dem + 2 * ((long)(edge - 1 - j) * edge + i_lo);
        int16_t* dst = grid + (dst_j0 + j) * (long)n + (dst_i0 + i_lo);
        long cnt = i_hi - i_lo + 1;
        for (long i = 0; i < cnt; ++i)
            dst[i] = decode_clamp(src + 2 * i);
    }

    munmap((void*)dem, sb.st_size);
    close(fd);
    return 0;
}

// Standalone single-tile decode (row 0 = NORTH, like the file), used for
// parity tests against the numpy path.
int hgt_decode(const char* path, int edge, int16_t* out) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return 1;
    struct stat sb;
    if (fstat(fd, &sb) != 0 || sb.st_size != (long)edge * edge * 2) {
        close(fd);
        return 2;
    }
    const unsigned char* dem = (const unsigned char*)
        mmap(nullptr, sb.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (dem == MAP_FAILED) { close(fd); return 3; }
    for (long k = 0; k < (long)edge * edge; ++k)
        out[k] = (int16_t)((dem[2 * k] << 8) | dem[2 * k + 1]);
    munmap((void*)dem, sb.st_size);
    close(fd);
    return 0;
}

// Undo the PNG row filters in place (PNG spec 9.2-9.4).
//
//   buf     rows * (1 + stride) bytes: each row's filter type (0-4), then
//           its stride filtered bytes; on return each row holds its
//           unfiltered bytes after the (unchanged) filter byte
//   bpp     bytes per complete pixel, at least 1
//
// Returns 0, or 1 + the index of the first row whose filter type is not
// 0-4 (the rows before it are unfiltered, the rest untouched).
long png_unfilter(unsigned char* buf, long rows, long stride, int bpp) {
    const long pitch = 1 + stride;
    for (long r = 0; r < rows; ++r) {
        unsigned char* row = buf + r * pitch;
        unsigned char* cur = row + 1;
        const unsigned char* prev = r ? cur - pitch : nullptr;
        switch (row[0]) {
        case 0:
            break;
        case 1:
            for (long i = bpp; i < stride; ++i)
                cur[i] = (unsigned char)(cur[i] + cur[i - bpp]);
            break;
        case 2:
            if (prev)
                for (long i = 0; i < stride; ++i)
                    cur[i] = (unsigned char)(cur[i] + prev[i]);
            break;
        case 3:
            for (long i = 0; i < stride; ++i) {
                int a = i >= bpp ? cur[i - bpp] : 0;
                int b = prev ? prev[i] : 0;
                cur[i] = (unsigned char)(cur[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (long i = 0; i < stride; ++i) {
                int a = i >= bpp ? cur[i - bpp] : 0;
                int b = prev ? prev[i] : 0;
                int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                int p = a + b - c;
                int pa = p > a ? p - a : a - p;
                int pb = p > b ? p - b : b - p;
                int pc = p > c ? p - c : c - p;
                int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                cur[i] = (unsigned char)(cur[i] + pred);
            }
            break;
        default:
            return r + 1;
        }
    }
    return 0;
}

}  // extern "C"
