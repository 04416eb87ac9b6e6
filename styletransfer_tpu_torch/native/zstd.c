/* A Zstandard decoder (RFC 8878), for reading Orbax checkpoints without
 * the zstd library.
 *
 * It decodes every frame of a buffer one after another: skippable frames
 * are passed over; raw, RLE and compressed blocks; Huffman-coded literals
 * (one or four streams, direct or FSE-coded weights, the treeless repeat);
 * sequences with predefined, RLE, FSE-coded and repeated tables; the three
 * repeat offsets; and the optional XXH64 content checksum, checked when
 * the frame carries one. Frames that need a dictionary are refused.
 *
 * Every read is bounds-checked. Malformed input returns an error message
 * and never touches memory outside the buffers.
 *
 * Interface (ctypes):
 *   int stx_zstd_decompress(const uint8_t *src, size_t n, uint8_t **out,
 *                           size_t *out_len, char *err, size_t err_cap);
 *     0 on success, *out allocated with malloc (free with stx_zstd_free);
 *     nonzero on failure, with a message in err.
 *   void stx_zstd_free(uint8_t *p);
 */

#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define ZSTD_MAGIC 0xFD2FB528u
#define SKIPPABLE_MASK 0xFFFFFFF0u
#define SKIPPABLE_MAGIC 0x184D2A50u
#define BLOCK_MAX (128 * 1024)
#define MAX_WINDOW_LOG 41

#define LL_MAX_SYMBOL 35
#define ML_MAX_SYMBOL 52
#define OF_MAX_SYMBOL 31
#define LL_MAX_LOG 9
#define ML_MAX_LOG 9
#define OF_MAX_LOG 8
#define HUF_MAX_BITS 11
#define FSE_MAX_LOG 9

typedef struct {
    char *msg;
    size_t cap;
    int failed;
} Err;

static int fail(Err *e, const char *fmt, ...) {
    if (!e->failed) {
        va_list ap;
        va_start(ap, fmt);
        vsnprintf(e->msg, e->cap, fmt, ap);
        va_end(ap);
        e->failed = 1;
    }
    return -1;
}

/* ------------------------------------------------------------------ */
/* Output buffer                                                      */

typedef struct {
    uint8_t *data;
    size_t len, cap;
} Buf;

static int buf_reserve(Buf *b, size_t extra, Err *e) {
    if (extra > SIZE_MAX - b->len) return fail(e, "output size overflows");
    size_t need = b->len + extra;
    if (need <= b->cap) return 0;
    size_t cap = b->cap ? b->cap : 4096;
    while (cap < need) cap = cap > SIZE_MAX / 2 ? need : cap * 2;
    uint8_t *p = (uint8_t *)realloc(b->data, cap);
    if (!p) return fail(e, "out of memory for %zu output bytes", need);
    b->data = p;
    b->cap = cap;
    return 0;
}

/* ------------------------------------------------------------------ */
/* Little-endian reads                                                */

static uint64_t le_read(const uint8_t *p, int nbytes) {
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    if (nbytes == 8) {
        uint64_t w;
        memcpy(&w, p, 8);
        return w;
    }
#endif
    uint64_t v = 0;
    for (int i = 0; i < nbytes; i++) v |= (uint64_t)p[i] << (8 * i);
    return v;
}

static int highbit(uint32_t v) { /* v > 0 */
    int r = 0;
    while (v >>= 1) r++;
    return r;
}

/* ------------------------------------------------------------------ */
/* Backward bit stream (Huffman and FSE payloads): bits are consumed   */
/* from the end of the buffer, after the final byte's marker bit.      */

typedef struct {
    const uint8_t *buf;
    size_t len;
    int64_t pos;      /* bits left before the start of the stream */
    int overflowed;   /* a read went past the start */
} BitB;

static int bitb_init(BitB *b, const uint8_t *buf, size_t len, Err *e) {
    if (len == 0) return fail(e, "empty bit stream");
    uint8_t last = buf[len - 1];
    if (last == 0) return fail(e, "bit stream has no end marker");
    b->buf = buf;
    b->len = len;
    b->pos = (int64_t)(len - 1) * 8 + highbit(last);
    b->overflowed = 0;
    return 0;
}

/* n bits (n <= 56) starting at bit position p (p >= 0) */
static uint64_t bits_at(const uint8_t *buf, size_t len, int64_t p, int n) {
    if (n == 0) return 0;
    size_t byte = (size_t)(p >> 3);
    int shift = (int)(p & 7);
    size_t avail = len > byte ? len - byte : 0;
    if (avail > 8) avail = 8;
    uint64_t v = le_read(buf + byte, (int)avail) >> shift;
    return v & ((1ULL << n) - 1);
}

/* Read n bits (n <= 56); past the start the missing low bits are zeros
 * and the stream is marked as overflowed. */
static uint64_t bitb_read(BitB *b, int n) {
    if (n == 0) return 0;
    if (b->pos >= n) {
        b->pos -= n;
        return bits_at(b->buf, b->len, b->pos, n);
    }
    uint64_t v = b->pos > 0 ? bits_at(b->buf, b->len, 0, (int)b->pos) << (n - b->pos) : 0;
    b->pos = 0;
    b->overflowed = 1;
    return v;
}

/* The next n bits without consuming them (zeros past the start). */
static uint32_t bitb_peek(const BitB *b, int n) {
    if (b->pos >= n) return (uint32_t)bits_at(b->buf, b->len, b->pos - n, n);
    return b->pos > 0 ? (uint32_t)(bits_at(b->buf, b->len, 0, (int)b->pos) << (n - b->pos)) : 0;
}

/* ------------------------------------------------------------------ */
/* FSE tables                                                         */

typedef struct {
    uint8_t symbol;
    uint8_t nbits;
    uint16_t base;
} FseCell;

typedef struct {
    int log;
    FseCell cells[1 << FSE_MAX_LOG];
} Fse;

static int fse_build(Fse *t, const int16_t *norm, int nsym, int log, Err *e) {
    int size = 1 << log;
    uint16_t next[256];
    int high = size - 1;
    t->log = log;
    for (int s = 0; s < nsym; s++) {
        if (norm[s] == -1) {
            t->cells[high--].symbol = (uint8_t)s;
            next[s] = 1;
        } else {
            next[s] = (uint16_t)norm[s];
        }
    }
    int pos = 0, step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    for (int s = 0; s < nsym; s++) {
        for (int i = 0; i < norm[s]; i++) {
            t->cells[pos].symbol = (uint8_t)s;
            do {
                pos = (pos + step) & mask;
            } while (pos > high);
        }
    }
    if (pos != 0) return fail(e, "FSE distribution does not fill its table");
    for (int i = 0; i < size; i++) {
        int s = t->cells[i].symbol;
        uint32_t n = next[s]++;
        int nb = log - highbit(n);
        t->cells[i].nbits = (uint8_t)nb;
        t->cells[i].base = (uint16_t)((n << nb) - size);
    }
    return 0;
}

static int fse_rle(Fse *t, uint8_t symbol) {
    t->log = 0;
    t->cells[0].symbol = symbol;
    t->cells[0].nbits = 0;
    t->cells[0].base = 0;
    return 0;
}

/* Read an FSE table description (RFC 8878 4.1.1) from src[0..n); returns
 * the bytes used, or -1. */
static int64_t fse_read_description(Fse *t, const uint8_t *src, size_t n, int max_log,
                                    int max_symbol, const char *what, Err *e) {
    if (n < 1) return fail(e, "%s: truncated FSE table description", what);
    int log = (src[0] & 15) + 5;
    if (log > max_log) return fail(e, "%s: FSE accuracy log %d above %d", what, log, max_log);
    int64_t bit = 4;
    int64_t nbits_total = (int64_t)n * 8;
    int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1;
    int16_t norm[256];
    int sym = 0, prev0 = 0;
#define NEED(k) \
    if (bit + (k) > nbits_total) return fail(e, "%s: truncated FSE table description", what)
    while (remaining > 1 && sym <= max_symbol) {
        if (prev0) {
            int n0 = sym;
            for (;;) {
                NEED(2);
                int r = (int)bits_at(src, n, bit, 2);
                bit += 2;
                n0 += r;
                if (r != 3) break;
            }
            if (n0 > max_symbol + 1) return fail(e, "%s: FSE zero run past the last symbol", what);
            while (sym < n0) norm[sym++] = 0;
            if (sym > max_symbol) break;
        }
        int max = (2 * threshold - 1) - remaining;
        int count;
        NEED(nb - 1);
        uint32_t low = (uint32_t)bits_at(src, n, bit, nb - 1);
        if ((int)(low & (threshold - 1)) < max) {
            count = (int)(low & (threshold - 1));
            bit += nb - 1;
        } else {
            NEED(nb);
            count = (int)bits_at(src, n, bit, nb);
            if (count >= threshold) count -= max;
            bit += nb;
        }
        count--;
        remaining -= count < 0 ? -count : count;
        norm[sym++] = (int16_t)count;
        prev0 = count == 0;
        while (remaining < threshold) {
            nb--;
            threshold >>= 1;
        }
    }
#undef NEED
    if (remaining != 1) return fail(e, "%s: FSE probabilities do not sum to the table size", what);
    if (sym > max_symbol + 1) return fail(e, "%s: FSE symbol above %d", what, max_symbol);
    if (fse_build(t, norm, sym, log, e)) return -1;
    return (bit + 7) / 8;
}

/* ------------------------------------------------------------------ */
/* Huffman literals                                                   */

typedef struct {
    int max_bits; /* 0: no table yet */
    uint8_t symbol[1 << HUF_MAX_BITS];
    uint8_t nbits[1 << HUF_MAX_BITS];
} Huf;

/* Decode FSE-coded Huffman weights: two interleaved states. */
static int huf_fse_weights(const uint8_t *src, size_t n, uint8_t *w, int *nw, Err *e) {
    Fse t;
    int64_t used = fse_read_description(&t, src, n, 6, 255, "Huffman weights", e);
    if (used < 0) return -1;
    if ((size_t)used >= n) return fail(e, "Huffman weights: no bit stream after the FSE table");
    BitB b = {0};
    if (bitb_init(&b, src + used, n - (size_t)used, e)) return -1;
    uint32_t s1 = (uint32_t)bitb_read(&b, t.log), s2 = (uint32_t)bitb_read(&b, t.log);
    if (b.overflowed) return fail(e, "Huffman weights: bit stream too short");
    int k = 0;
    for (;;) {
        if (k > 253) return fail(e, "Huffman weights: more than 255 weights");
        w[k++] = t.cells[s1].symbol;
        s1 = t.cells[s1].base + (uint32_t)bitb_read(&b, t.cells[s1].nbits);
        if (b.overflowed) {
            w[k++] = t.cells[s2].symbol;
            break;
        }
        w[k++] = t.cells[s2].symbol;
        s2 = t.cells[s2].base + (uint32_t)bitb_read(&b, t.cells[s2].nbits);
        if (b.overflowed) {
            w[k++] = t.cells[s1].symbol;
            break;
        }
    }
    *nw = k;
    return 0;
}

/* Read a Huffman tree description; returns bytes used or -1. */
static int64_t huf_read(Huf *h, const uint8_t *src, size_t n, Err *e) {
    if (n < 1) return fail(e, "truncated Huffman tree description");
    uint8_t w[256];
    int nw = 0;
    int64_t used;
    int header = src[0];
    if (header < 128) {
        if ((size_t)header + 1 > n) return fail(e, "truncated Huffman tree description");
        if (header == 0) return fail(e, "empty FSE-coded Huffman weights");
        if (huf_fse_weights(src + 1, (size_t)header, w, &nw, e)) return -1;
        used = 1 + header;
    } else {
        nw = header - 127;
        size_t bytes = (size_t)(nw + 1) / 2;
        if (1 + bytes > n) return fail(e, "truncated Huffman tree description");
        for (int i = 0; i < nw; i++) {
            uint8_t byte = src[1 + i / 2];
            w[i] = (i % 2 == 0) ? (byte >> 4) : (byte & 15);
        }
        used = 1 + (int64_t)bytes;
    }
    if (nw > 255) return fail(e, "more than 255 Huffman weights");
    uint32_t total = 0;
    for (int i = 0; i < nw; i++) {
        if (w[i] > HUF_MAX_BITS) return fail(e, "Huffman weight %d above %d", w[i], HUF_MAX_BITS);
        if (w[i]) total += 1u << (w[i] - 1);
    }
    if (total == 0) return fail(e, "Huffman weights are all zero");
    int max_bits = highbit(total) + 1;
    if (max_bits > HUF_MAX_BITS) return fail(e, "Huffman code longer than %d bits", HUF_MAX_BITS);
    uint32_t rest = (1u << max_bits) - total;
    if (rest & (rest - 1)) return fail(e, "Huffman weights leave no power of two for the last symbol");
    w[nw] = (uint8_t)(highbit(rest) + 1);
    nw++;
    /* Fill the table: weights in increasing order, symbols in order. */
    uint32_t start[HUF_MAX_BITS + 2] = {0};
    uint32_t count[HUF_MAX_BITS + 2] = {0};
    for (int i = 0; i < nw; i++) count[w[i]]++;
    uint32_t next = 0;
    for (int wt = 1; wt <= max_bits; wt++) {
        start[wt] = next;
        next += count[wt] << (wt - 1);
    }
    if (next != (1u << max_bits)) return fail(e, "Huffman weights do not fill the code space");
    for (int s = 0; s < nw; s++) {
        int wt = w[s];
        if (!wt) continue;
        uint32_t len = 1u << (wt - 1);
        for (uint32_t j = 0; j < len; j++) {
            h->symbol[start[wt] + j] = (uint8_t)s;
            h->nbits[start[wt] + j] = (uint8_t)(max_bits + 1 - wt);
        }
        start[wt] += len;
    }
    h->max_bits = max_bits;
    return used;
}

static int huf_stream(const Huf *h, const uint8_t *src, size_t n, uint8_t *out, size_t count, Err *e) {
    BitB b = {0};
    if (bitb_init(&b, src, n, e)) return -1;
    int mb = h->max_bits;
    for (size_t i = 0; i < count; i++) {
        uint32_t v = bitb_peek(&b, mb);
        int nb = h->nbits[v];
        if (b.pos < nb) return fail(e, "Huffman stream ends early");
        out[i] = h->symbol[v];
        b.pos -= nb;
    }
    if (b.pos != 0) return fail(e, "Huffman stream has %lld bits left over", (long long)b.pos);
    return 0;
}

/* ------------------------------------------------------------------ */
/* Sequence code tables                                               */

static const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                       2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

static const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                                     12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                                     48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
static const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  1,  1,
                                    1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
                                     17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
                                     31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
                                     99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
static const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                    2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

/* ------------------------------------------------------------------ */
/* Frame state                                                        */

typedef struct {
    Huf huf;
    Fse ll, of, ml;
    int have_ll, have_of, have_ml;
    uint64_t rep[3];
    uint64_t window;
    uint8_t lit[BLOCK_MAX];
} Frame;

static int read_seq_table(Fse *t, int *have, int mode, const uint8_t *src, size_t n, size_t *used,
                          const int16_t *dflt, int dflt_n, int dflt_log, int max_log, int max_sym,
                          const char *what, Err *e) {
    switch (mode) {
    case 0:
        *used = 0;
        if (fse_build(t, dflt, dflt_n, dflt_log, e)) return -1;
        break;
    case 1:
        if (n < 1) return fail(e, "%s: truncated RLE symbol", what);
        if (src[0] > max_sym) return fail(e, "%s: RLE symbol %d above %d", what, src[0], max_sym);
        fse_rle(t, src[0]);
        *used = 1;
        break;
    case 2: {
        int64_t u = fse_read_description(t, src, n, max_log, max_sym, what, e);
        if (u < 0) return -1;
        *used = (size_t)u;
        break;
    }
    default:
        if (!*have) return fail(e, "%s: repeat mode with no previous table", what);
        *used = 0;
        break;
    }
    *have = 1;
    return 0;
}

static int copy_literals(Buf *out, const uint8_t *lit, size_t n, Err *e) {
    if (buf_reserve(out, n, e)) return -1;
    memcpy(out->data + out->len, lit, n);
    out->len += n;
    return 0;
}

static int compressed_block(Frame *f, const uint8_t *src, size_t n, Buf *out, size_t frame_start,
                            Err *e) {
    size_t block_start = out->len;
    /* Literals section */
    if (n < 1) return fail(e, "empty compressed block");
    int ltype = src[0] & 3, sf = (src[0] >> 2) & 3;
    size_t regen, csize = 0, hdr;
    int streams = 1;
    if (ltype < 2) {
        if (sf == 0 || sf == 2) {
            hdr = 1;
            regen = src[0] >> 3;
        } else if (sf == 1) {
            hdr = 2;
            if (n < 2) return fail(e, "truncated literals header");
            regen = (src[0] >> 4) + ((size_t)src[1] << 4);
        } else {
            hdr = 3;
            if (n < 3) return fail(e, "truncated literals header");
            regen = (src[0] >> 4) + ((size_t)src[1] << 4) + ((size_t)src[2] << 12);
        }
    } else {
        if (sf < 2) {
            hdr = 3;
            if (n < 3) return fail(e, "truncated literals header");
            uint32_t v = (uint32_t)le_read(src, 3);
            regen = (v >> 4) & 0x3FF;
            csize = (v >> 14) & 0x3FF;
            streams = sf == 0 ? 1 : 4;
        } else if (sf == 2) {
            hdr = 4;
            if (n < 4) return fail(e, "truncated literals header");
            uint32_t v = (uint32_t)le_read(src, 4);
            regen = (v >> 4) & 0x3FFF;
            csize = (v >> 18) & 0x3FFF;
            streams = 4;
        } else {
            hdr = 5;
            if (n < 5) return fail(e, "truncated literals header");
            uint64_t v = le_read(src, 5);
            regen = (size_t)((v >> 4) & 0x3FFFF);
            csize = (size_t)((v >> 22) & 0x3FFFF);
            streams = 4;
        }
    }
    if (regen > BLOCK_MAX) return fail(e, "literals section of %zu bytes above the block maximum", regen);
    size_t pos = hdr;
    const uint8_t *lit;
    if (ltype == 0) {
        if (regen > n - pos) return fail(e, "raw literals run past the block");
        lit = src + pos;
        pos += regen;
    } else if (ltype == 1) {
        if (pos + 1 > n) return fail(e, "truncated RLE literal");
        memset(f->lit, src[pos], regen);
        lit = f->lit;
        pos += 1;
    } else {
        if (csize > n - pos) return fail(e, "compressed literals run past the block");
        const uint8_t *p = src + pos;
        size_t left = csize;
        if (ltype == 2) {
            int64_t u = huf_read(&f->huf, p, left, e);
            if (u < 0) return -1;
            p += u;
            left -= (size_t)u;
        } else if (!f->huf.max_bits) {
            return fail(e, "treeless literals with no previous Huffman table");
        }
        if (streams == 1) {
            if (regen == 0) return fail(e, "empty Huffman literals");
            if (huf_stream(&f->huf, p, left, f->lit, regen, e)) return -1;
        } else {
            if (left < 6) return fail(e, "truncated Huffman jump table");
            size_t s1 = (size_t)le_read(p, 2), s2 = (size_t)le_read(p + 2, 2), s3 = (size_t)le_read(p + 4, 2);
            if (s1 + s2 + s3 > left - 6) return fail(e, "Huffman jump table runs past the literals");
            size_t s4 = left - 6 - s1 - s2 - s3;
            size_t seg = (regen + 3) / 4;
            if (regen < 4 || 3 * seg > regen) return fail(e, "too few literals for four streams");
            const uint8_t *q = p + 6;
            if (huf_stream(&f->huf, q, s1, f->lit, seg, e)) return -1;
            if (huf_stream(&f->huf, q + s1, s2, f->lit + seg, seg, e)) return -1;
            if (huf_stream(&f->huf, q + s1 + s2, s3, f->lit + 2 * seg, seg, e)) return -1;
            if (huf_stream(&f->huf, q + s1 + s2 + s3, s4, f->lit + 3 * seg, regen - 3 * seg, e)) return -1;
        }
        lit = f->lit;
        pos += csize;
    }

    /* Sequences section */
    if (pos >= n) return fail(e, "truncated sequences section");
    size_t nseq = src[pos];
    if (nseq < 128) {
        pos += 1;
    } else if (nseq < 255) {
        if (pos + 2 > n) return fail(e, "truncated sequence count");
        nseq = ((nseq - 128) << 8) + src[pos + 1];
        pos += 2;
    } else {
        if (pos + 3 > n) return fail(e, "truncated sequence count");
        nseq = src[pos + 1] + ((size_t)src[pos + 2] << 8) + 0x7F00;
        pos += 3;
    }
    if (nseq == 0) {
        if (pos != n) return fail(e, "bytes after a block with no sequences");
        return copy_literals(out, lit, regen, e);
    }
    if (pos >= n) return fail(e, "truncated sequence modes");
    int modes = src[pos++];
    if (modes & 3) return fail(e, "reserved bits set in the sequence modes");
    size_t used;
    if (read_seq_table(&f->ll, &f->have_ll, modes >> 6, src + pos, n - pos, &used, LL_DEFAULT, 36, 6,
                       LL_MAX_LOG, LL_MAX_SYMBOL, "literal lengths", e))
        return -1;
    pos += used;
    if (read_seq_table(&f->of, &f->have_of, (modes >> 4) & 3, src + pos, n - pos, &used, OF_DEFAULT, 29,
                       5, OF_MAX_LOG, OF_MAX_SYMBOL, "offsets", e))
        return -1;
    pos += used;
    if (read_seq_table(&f->ml, &f->have_ml, (modes >> 2) & 3, src + pos, n - pos, &used, ML_DEFAULT, 53,
                       6, ML_MAX_LOG, ML_MAX_SYMBOL, "match lengths", e))
        return -1;
    pos += used;
    if (pos >= n) return fail(e, "no sequence bit stream");
    BitB b = {0};
    if (bitb_init(&b, src + pos, n - pos, e)) return -1;
    uint32_t sll = (uint32_t)bitb_read(&b, f->ll.log);
    uint32_t sof = (uint32_t)bitb_read(&b, f->of.log);
    uint32_t sml = (uint32_t)bitb_read(&b, f->ml.log);
    size_t lpos = 0;
    for (size_t i = 0; i < nseq; i++) {
        int ofc = f->of.cells[sof].symbol, mlc = f->ml.cells[sml].symbol, llc = f->ll.cells[sll].symbol;
        if (ofc > OF_MAX_SYMBOL || mlc > ML_MAX_SYMBOL || llc > LL_MAX_SYMBOL)
            return fail(e, "sequence code out of range");
        uint64_t ofv = (1ULL << ofc) + bitb_read(&b, ofc);
        uint64_t ml = ML_BASE[mlc] + bitb_read(&b, ML_BITS[mlc]);
        uint64_t ll = LL_BASE[llc] + bitb_read(&b, LL_BITS[llc]);
        uint64_t off;
        if (ofv > 3) {
            off = ofv - 3;
            f->rep[2] = f->rep[1];
            f->rep[1] = f->rep[0];
            f->rep[0] = off;
        } else {
            int idx = (int)ofv - 1 + (ll == 0);
            if (idx == 0) {
                off = f->rep[0];
            } else if (idx == 1) {
                off = f->rep[1];
                f->rep[1] = f->rep[0];
                f->rep[0] = off;
            } else {
                off = idx == 2 ? f->rep[2] : f->rep[0] - 1;
                f->rep[2] = f->rep[1];
                f->rep[1] = f->rep[0];
                f->rep[0] = off;
            }
        }
        if (i + 1 < nseq) {
            sll = f->ll.cells[sll].base + (uint32_t)bitb_read(&b, f->ll.cells[sll].nbits);
            sml = f->ml.cells[sml].base + (uint32_t)bitb_read(&b, f->ml.cells[sml].nbits);
            sof = f->of.cells[sof].base + (uint32_t)bitb_read(&b, f->of.cells[sof].nbits);
        }
        if (b.overflowed) return fail(e, "sequence bit stream ends early");
        if (ll > regen - lpos) return fail(e, "sequence uses more literals than the block holds");
        if (ll + ml > BLOCK_MAX - (out->len - block_start))
            return fail(e, "block decodes to more than 128 KiB");
        if (copy_literals(out, lit + lpos, (size_t)ll, e)) return -1;
        lpos += (size_t)ll;
        size_t produced = out->len - frame_start;
        if (off == 0 || off > produced) return fail(e, "match offset %llu outside the %zu bytes decoded",
                                                    (unsigned long long)off, produced);
        if (off > f->window) return fail(e, "match offset %llu beyond the window", (unsigned long long)off);
        if (buf_reserve(out, (size_t)ml, e)) return -1;
        uint8_t *d = out->data + out->len;
        const uint8_t *s = d - off;
        if (off >= ml) {
            memcpy(d, s, (size_t)ml);
        } else {
            for (size_t k = 0; k < ml; k++) d[k] = s[k];
        }
        out->len += (size_t)ml;
    }
    if (b.pos != 0) return fail(e, "sequence bit stream has %lld bits left over", (long long)b.pos);
    if (regen - lpos > BLOCK_MAX - (out->len - block_start)) return fail(e, "block decodes to more than 128 KiB");
    return copy_literals(out, lit + lpos, regen - lpos, e);
}

/* ------------------------------------------------------------------ */
/* XXH64                                                              */

#define P1 0x9E3779B185EBCA87ULL
#define P2 0xC2B2AE3D27D4EB4FULL
#define P3 0x165667B19E3779F9ULL
#define P4 0x85EBCA77C2B2AE63ULL
#define P5 0x27D4EB2F165667C5ULL

static uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
static uint64_t xround(uint64_t acc, uint64_t lane) { return rotl(acc + lane * P2, 31) * P1; }
static uint64_t xmerge(uint64_t h, uint64_t v) { return (h ^ xround(0, v)) * P1 + P4; }

static uint64_t xxh64(const uint8_t *p, size_t n) {
    const uint8_t *end = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
        while ((size_t)(end - p) >= 32) {
            v1 = xround(v1, le_read(p, 8));
            v2 = xround(v2, le_read(p + 8, 8));
            v3 = xround(v3, le_read(p + 16, 8));
            v4 = xround(v4, le_read(p + 24, 8));
            p += 32;
        }
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = xmerge(h, v1);
        h = xmerge(h, v2);
        h = xmerge(h, v3);
        h = xmerge(h, v4);
    } else {
        h = P5;
    }
    h += (uint64_t)n;
    while ((size_t)(end - p) >= 8) {
        h ^= xround(0, le_read(p, 8));
        h = rotl(h, 27) * P1 + P4;
        p += 8;
    }
    if ((size_t)(end - p) >= 4) {
        h ^= le_read(p, 4) * P1;
        h = rotl(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= (*p++) * P5;
        h = rotl(h, 11) * P1;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

/* ------------------------------------------------------------------ */
/* Frames                                                             */

static int64_t frame(Frame *f, const uint8_t *src, size_t n, Buf *out, Err *e) {
    size_t pos = 4;
    if (n < 5) return fail(e, "truncated frame header");
    int fhd = src[pos++];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
    if (fhd & 8) return fail(e, "reserved bit set in the frame header");
    uint64_t window = 0;
    if (!single) {
        if (pos >= n) return fail(e, "truncated frame header");
        int wd = src[pos++];
        int wlog = 10 + (wd >> 3);
        if (wlog > MAX_WINDOW_LOG) return fail(e, "window log %d too large", wlog);
        uint64_t base = 1ULL << wlog;
        window = base + (base / 8) * (uint64_t)(wd & 7);
    }
    static const int did_bytes[4] = {0, 1, 2, 4};
    int db = did_bytes[did_flag];
    if (pos + (size_t)db > n) return fail(e, "truncated frame header");
    if (db && le_read(src + pos, db) != 0)
        return fail(e, "frame needs dictionary %llu; dictionaries are not supported",
                    (unsigned long long)le_read(src + pos, db));
    pos += (size_t)db;
    int fcs_bytes = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
    int has_fcs = fcs_bytes > 0;
    uint64_t fcs = 0;
    if (pos + (size_t)fcs_bytes > n) return fail(e, "truncated frame header");
    if (has_fcs) {
        fcs = le_read(src + pos, fcs_bytes);
        if (fcs_bytes == 2) fcs += 256;
    }
    pos += (size_t)fcs_bytes;
    if (single) window = fcs;
    f->window = window;
    f->huf.max_bits = 0;
    f->have_ll = f->have_of = f->have_ml = 0;
    f->rep[0] = 1;
    f->rep[1] = 4;
    f->rep[2] = 8;
    size_t block_max = window < BLOCK_MAX ? (size_t)window : BLOCK_MAX;
    size_t start = out->len;
    /* Reserve the declared size up front, up to 64 MiB (a header alone
     * must not make the decoder allocate more). */
    if (has_fcs && buf_reserve(out, (size_t)(fcs < (1u << 26) ? fcs : (1u << 26)), e)) return -1;
    for (;;) {
        if (pos + 3 > n) return fail(e, "truncated block header");
        uint32_t bh = (uint32_t)le_read(src + pos, 3);
        pos += 3;
        int last = bh & 1, type = (bh >> 1) & 3;
        size_t size = bh >> 3;
        if (type == 3) return fail(e, "reserved block type");
        if (size > block_max) return fail(e, "block of %zu bytes above the block maximum %zu", size, block_max);
        if (type == 1) {
            if (pos + 1 > n) return fail(e, "truncated RLE block");
            if (buf_reserve(out, size, e)) return -1;
            memset(out->data + out->len, src[pos], size);
            out->len += size;
            pos += 1;
        } else {
            if (size > n - pos) return fail(e, "block runs past the end of the input");
            if (type == 0) {
                if (copy_literals(out, src + pos, size, e)) return -1;
            } else {
                if (compressed_block(f, src + pos, size, out, start, e)) return -1;
            }
            pos += size;
        }
        if (last) break;
    }
    size_t produced = out->len - start;
    if (has_fcs && produced != fcs)
        return fail(e, "frame decoded to %zu bytes but declares %llu", produced, (unsigned long long)fcs);
    if (checksum) {
        if (pos + 4 > n) return fail(e, "truncated content checksum");
        uint32_t want = (uint32_t)le_read(src + pos, 4);
        uint32_t got = (uint32_t)xxh64(out->data + start, produced);
        if (want != got) return fail(e, "content checksum mismatch (%08x stored, %08x computed)", want, got);
        pos += 4;
    }
    return (int64_t)pos;
}

int stx_zstd_decompress(const uint8_t *src, size_t n, uint8_t **out, size_t *out_len, char *err,
                        size_t err_cap) {
    Err e = {err, err_cap, 0};
    Buf b = {NULL, 0, 0};
    Frame *f = (Frame *)malloc(sizeof(Frame));
    *out = NULL;
    *out_len = 0;
    if (!f) {
        fail(&e, "out of memory");
        return 1;
    }
    size_t pos = 0;
    int frames = 0;
    while (pos < n) {
        if (n - pos < 4) {
            fail(&e, "%zu trailing bytes after frame %d", n - pos, frames);
            break;
        }
        uint32_t magic = (uint32_t)le_read(src + pos, 4);
        if ((magic & SKIPPABLE_MASK) == SKIPPABLE_MAGIC) {
            if (n - pos < 8) {
                fail(&e, "truncated skippable frame");
                break;
            }
            uint64_t size = le_read(src + pos + 4, 4);
            if (size > n - pos - 8) {
                fail(&e, "skippable frame runs past the end of the input");
                break;
            }
            pos += 8 + (size_t)size;
        } else if (magic == ZSTD_MAGIC) {
            int64_t used = frame(f, src + pos, n - pos, &b, &e);
            if (used < 0) break;
            pos += (size_t)used;
        } else {
            fail(&e, "bad magic 0x%08x at byte %zu (not a zstd frame)", magic, pos);
            break;
        }
        frames++;
    }
    if (!e.failed && frames == 0) fail(&e, "no zstd frame in the input");
    free(f);
    if (e.failed) {
        free(b.data);
        return 1;
    }
    if (!b.data) b.data = (uint8_t *)malloc(1);
    *out = b.data;
    *out_len = b.len;
    return 0;
}

void stx_zstd_free(uint8_t *p) { free(p); }
