/* RC4 keystream for MSE (fetch/mse.py).
 *
 * The reference's anacrolix client gets MSE's RC4 from Go's crypto/rc4
 * (native speed); a pure-Python RC4 runs ~2 MB/s and would cap every
 * encrypted peer connection, so the hot loop lives here. Built lazily
 * by rc4_native.py (cc -O2 -shared -fPIC); state is a 258-byte buffer:
 * S[256] then i, j.
 */

#include <stddef.h>

typedef unsigned char u8;

void rc4_init(u8 *st, const u8 *key, size_t keylen) {
    u8 *S = st;
    unsigned i, j = 0;
    for (i = 0; i < 256; i++) S[i] = (u8)i;
    for (i = 0; i < 256; i++) {
        j = (j + S[i] + key[i % keylen]) & 0xFFu;
        u8 t = S[i]; S[i] = S[j]; S[j] = t;
    }
    st[256] = 0;
    st[257] = 0;
}

void rc4_crypt(u8 *st, const u8 *in, u8 *out, size_t n) {
    u8 *S = st;
    unsigned i = st[256], j = st[257];
    for (size_t k = 0; k < n; k++) {
        i = (i + 1) & 0xFFu;
        j = (j + S[i]) & 0xFFu;
        u8 t = S[i]; S[i] = S[j]; S[j] = t;
        out[k] = in[k] ^ S[(S[i] + S[j]) & 0xFFu];
    }
    st[256] = (u8)i;
    st[257] = (u8)j;
}
