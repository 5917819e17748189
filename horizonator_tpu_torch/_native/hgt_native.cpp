// Native DEM loader: the hot path of the mosaic assembly.
//
// The reference implements its DEM layer in C (dem.c: mmap + per-sample
// byte-swap on demand). This is its native equivalent on the host, doing
// strictly more per pass: for each tile it fuses mmap -> big-endian decode ->
// north-first flip -> sea-level clamp -> window copy into the caller's
// mosaic grid, single pass, no temporaries. Exposed to Python via ctypes
// (horizonator_tpu_torch/_native/__init__.py), with a pure-numpy fallback;
// the same source as horizonator_tpu/_native/hgt_native.cpp.
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

}  // extern "C"
