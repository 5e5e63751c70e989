/* The LZF codec of h5py's lzf filter (HDF5 filter id 32000), host C.
 *
 * An LZF stream is a sequence of commands, each opened by a control byte c:
 *   c < 32:  a literal run: the next c + 1 bytes are copied to the output;
 *   c >= 32: a back reference: length L = c >> 5 (when 7, plus the next
 *            byte), then the offset's low byte; L + 2 bytes are copied from
 *            ((c & 31) << 8 | low) + 1 bytes back in the output.
 *
 * thz_lzf_decompress checks every command against both buffers.
 * thz_lzf_compress is this package's own compressor: the position of each
 * 3-byte prefix is kept in a hash table, a match is at most 8 KiB back and
 * 264 bytes long, and every position a match covers enters the table. It
 * writes nothing past out_len. io/lzf.py holds the same two algorithms in
 * Python, which must give the same bytes.
 */
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define HASH_BITS 14
#define MAX_LITERAL 32
#define MAX_OFFSET 8192
#define MAX_MATCH 264

/* Bytes written, -1 for a malformed stream (a command cut short or a
 * reference before the output's start), -2 when the output would pass
 * out_len. */
long long thz_lzf_decompress(const uint8_t *in, size_t in_len, uint8_t *out, size_t out_len) {
    size_t ip = 0, op = 0;
    while (ip < in_len) {
        unsigned ctrl = in[ip++];
        if (ctrl < 32) {
            size_t len = (size_t)ctrl + 1;
            if (len > in_len - ip) return -1;
            if (len > out_len - op) return -2;
            memcpy(out + op, in + ip, len);
            op += len;
            ip += len;
            continue;
        }
        size_t len = ctrl >> 5;
        if (len == 7) {
            if (ip >= in_len) return -1;
            len += in[ip++];
        }
        if (ip >= in_len) return -1;
        size_t back = (((size_t)ctrl & 31) << 8) + in[ip++] + 1;
        len += 2;
        if (back > op) return -1;
        if (len > out_len - op) return -2;
        for (size_t k = 0; k < len; k++, op++) out[op] = out[op - back];
    }
    return (long long)op;
}

static uint32_t hash3(const uint8_t *p) {
    uint32_t v = ((uint32_t)p[0] << 16) | ((uint32_t)p[1] << 8) | p[2];
    return (v * 2654435761u) >> (32 - HASH_BITS);
}

/* Bytes written; 0 when the stream does not fit out_len (h5py then stores
 * the chunk as it is), -1 for an input of 4 GiB or more or when the hash
 * table cannot be allocated. */
long long thz_lzf_compress(const uint8_t *in, size_t in_len, uint8_t *out, size_t out_len) {
    if (in_len == 0) return 0;
    if (in_len >= UINT32_MAX) return -1;
    uint32_t *table = calloc((size_t)1 << HASH_BITS, sizeof *table);  /* position + 1, 0: none */
    if (!table) return -1;
    size_t ip = 0, op = 0, run = op++;  /* run: the control byte of the open literal run */
    unsigned lit = 0;
    long long result = 0;
    while (ip < in_len) {
        if (ip + 2 < in_len) {
            uint32_t h = hash3(in + ip);
            size_t ref = table[h];
            table[h] = (uint32_t)(ip + 1);
            if (ref && ip - ref < MAX_OFFSET && memcmp(in + ref - 1, in + ip, 3) == 0) {
                ref -= 1;
                size_t max = in_len - ip < MAX_MATCH ? in_len - ip : MAX_MATCH;
                size_t len = 3;
                while (len < max && in[ref + len] == in[ip + len]) len++;
                if (lit) out[run] = (uint8_t)(lit - 1);
                else op--;  /* no literal before the match: give its control byte back */
                size_t off = ip - ref - 1, code = len - 2;
                if (op + (code < 7 ? 2 : 3) > out_len) goto done;
                if (code < 7) {
                    out[op++] = (uint8_t)((off >> 8) + (code << 5));
                } else {
                    out[op++] = (uint8_t)((off >> 8) + (7 << 5));
                    out[op++] = (uint8_t)(code - 7);
                }
                out[op++] = (uint8_t)(off & 0xff);
                for (size_t k = ip + 1; k < ip + len && k + 2 < in_len; k++)
                    table[hash3(in + k)] = (uint32_t)(k + 1);
                ip += len;
                lit = 0;
                run = op++;
                continue;
            }
        }
        if (op >= out_len) goto done;
        out[op++] = in[ip++];
        if (++lit == MAX_LITERAL) {
            out[run] = MAX_LITERAL - 1;
            lit = 0;
            run = op++;
        }
    }
    if (lit) out[run] = (uint8_t)(lit - 1);
    else op--;
    result = (long long)op;
done:
    free(table);
    return result;
}
