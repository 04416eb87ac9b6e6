/* CRC32C (Castagnoli) — native implementation for TFRecord framing.
 *
 * The TensorBoard event writer (styletransfer_tpu_torch/utils/tb.py) frames
 * every record with two masked CRC32C checksums; image summaries are
 * megabytes per event, where a CRC in pure Python is slow.
 *
 * Built as a tiny shared library (no Python.h: called through ctypes, so
 * it compiles anywhere a C compiler exists, and the wrapper in
 * native/__init__.py falls back to the Python table when it does not).
 * Host code; no device kernel.
 *
 * Slicing-by-8 variant of the standard table algorithm.
 */

#include <stddef.h>
#include <stdint.h>

static uint32_t table[8][256];

/* Tables are built eagerly at library load (GCC/Clang constructor): a lazy
 * flag-guarded init is not thread-safe — a second thread could read
 * partially built tables while the first is still filling them. */
__attribute__((constructor)) static void init_tables(void) {
    const uint32_t poly = 0x82F63B78u; /* reflected CRC32C polynomial */
    for (int n = 0; n < 256; n++) {
        uint32_t crc = (uint32_t)n;
        for (int k = 0; k < 8; k++)
            crc = (crc & 1) ? (crc >> 1) ^ poly : crc >> 1;
        table[0][n] = crc;
    }
    for (int n = 0; n < 256; n++) {
        uint32_t crc = table[0][n];
        for (int k = 1; k < 8; k++) {
            crc = table[0][crc & 0xFF] ^ (crc >> 8);
            table[k][n] = crc;
        }
    }
}

uint32_t crc32c(const uint8_t *data, size_t len) {
    uint32_t crc = 0xFFFFFFFFu;
    /* 8 bytes at a time */
    while (len >= 8) {
        uint32_t lo = crc ^ ((uint32_t)data[0] | ((uint32_t)data[1] << 8) |
                             ((uint32_t)data[2] << 16) | ((uint32_t)data[3] << 24));
        uint32_t hi = (uint32_t)data[4] | ((uint32_t)data[5] << 8) |
                      ((uint32_t)data[6] << 16) | ((uint32_t)data[7] << 24);
        crc = table[7][lo & 0xFF] ^ table[6][(lo >> 8) & 0xFF] ^
              table[5][(lo >> 16) & 0xFF] ^ table[4][(lo >> 24) & 0xFF] ^
              table[3][hi & 0xFF] ^ table[2][(hi >> 8) & 0xFF] ^
              table[1][(hi >> 16) & 0xFF] ^ table[0][(hi >> 24) & 0xFF];
        data += 8;
        len -= 8;
    }
    while (len--) crc = table[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}
