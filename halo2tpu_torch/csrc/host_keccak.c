/* Keccak-256 on the host (host C, built by _build.host_lib() into the same
 * library as host_pack.c).  This is Ethereum's keccak256: Keccak-f[1600]
 * at rate 136 bytes (capacity 512 bits) with the original Keccak padding
 * 0x01 ... 0x80, not SHA3-256's 0x06.  It uses no CPython API.
 *
 * keccak256(data, len, out32): the 32-byte hash of len bytes at data.
 * Lanes are read and written little-endian byte by byte, so the result
 * does not depend on the host's byte order.
 */
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define RATE 136

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

/* rho's rotations, lane A[x, y] at st[x + 5 y] */
static const int ROT[25] = {
     0,  1, 62, 28, 27,
    36, 44,  6, 55, 20,
     3, 10, 43, 25, 39,
    41, 45, 15, 21,  8,
    18,  2, 61, 56, 14,
};

static uint64_t rotl(uint64_t x, int n)
{
    return n == 0 ? x : (x << n) | (x >> (64 - n));
}

static void keccak_f(uint64_t st[25])
{
    for (int round = 0; round < 24; round++) {
        uint64_t c[5], b[25];
        for (int x = 0; x < 5; x++)     /* theta */
            c[x] = st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20];
        for (int x = 0; x < 5; x++) {
            uint64_t d = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
            for (int y = 0; y < 25; y += 5)
                st[x + y] ^= d;
        }
        for (int x = 0; x < 5; x++)     /* rho and pi */
            for (int y = 0; y < 5; y++)
                b[y + 5 * ((2 * x + 3 * y) % 5)] =
                    rotl(st[x + 5 * y], ROT[x + 5 * y]);
        for (int y = 0; y < 25; y += 5) /* chi */
            for (int x = 0; x < 5; x++)
                st[x + y] = b[x + y] ^ (~b[(x + 1) % 5 + y]
                                        & b[(x + 2) % 5 + y]);
        st[0] ^= RC[round];             /* iota */
    }
}

static void absorb(uint64_t st[25], const uint8_t *block)
{
    for (int i = 0; i < RATE / 8; i++) {
        uint64_t w = 0;
        for (int j = 7; j >= 0; j--)
            w = (w << 8) | block[8 * i + j];
        st[i] ^= w;
    }
    keccak_f(st);
}

void keccak256(const uint8_t *data, size_t len, uint8_t *out32)
{
    uint64_t st[25] = {0};
    uint8_t last[RATE] = {0};
    for (; len >= RATE; data += RATE, len -= RATE)
        absorb(st, data);
    if (len)
        memcpy(last, data, len);
    last[len] ^= 0x01;
    last[RATE - 1] ^= 0x80;
    absorb(st, last);
    for (int i = 0; i < 32; i++)
        out32[i] = (uint8_t)(st[i / 8] >> (8 * (i % 8)));
}
