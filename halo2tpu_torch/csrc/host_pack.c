/* Host packing of Python ints into the port's limb wire (host C, built by
 * _build.host_lib() with the host compiler and loaded with ctypes.PyDLL,
 * so every call holds the interpreter lock).
 *
 * pack_limbs16(seq, out, n): the first n ints of seq -> n x 32 bytes at
 * out, each value little-endian over 32 bytes (= (n, 16) uint16 limbs);
 * pack_u16(seq, out, n): the first n ints of seq -> n uint16 values at out.
 *
 * seq is a list or tuple (read in place) or any other sequence, such as an
 * object ndarray (read through PySequence_Fast).  An int that CPython
 * stores in one digit (below 2^30) is written directly; any other goes
 * through _PyLong_AsByteArray.  An item that is not an int is read through
 * __index__ (a numpy integer), else TypeError.  A negative value, one of
 * 2^256 or more, and in pack_u16 one of 2^16 or more raise OverflowError:
 * nothing is truncated.  Each returns how many values took the long path,
 * or -1 with an exception set.
 *
 * reduce_be256(in, n, mod, out): n 32-byte big-endian words at in, each
 * reduced mod `mod` (four little-endian 64-bit words, the top one at least
 * 2^58, so a word takes at most 64 subtractions) -> n x 32 bytes at out,
 * little-endian (the limb wire); uses no CPython API.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

static int as_bytes32(PyLongObject *v, unsigned char *out)
{
#if PY_VERSION_HEX >= 0x030D0000
    return _PyLong_AsByteArray(v, out, 32, 1, 0, 1);
#else
    return _PyLong_AsByteArray(v, out, 32, 1, 0);
#endif
}

/* v (an exact int) -> row i of out; 1 if it took the long path, 0 if
   not, -1 with an exception set. */
static int pack_one(PyLongObject *v, unsigned char *out, Py_ssize_t i,
                    int wide)
{
    if (PyUnstable_Long_IsCompact(v)) {
        Py_ssize_t x = PyUnstable_Long_CompactValue(v);
        if (x < 0 || (!wide && x > 0xFFFF)) {
            PyErr_Format(PyExc_OverflowError, "pack: value %zd at %zd "
                         "outside [0, 2^%d)", x, i, wide ? 256 : 16);
            return -1;
        }
        if (wide) {
            unsigned char *o = out + 32 * i;
            o[0] = (unsigned char)x;
            o[1] = (unsigned char)(x >> 8);
            o[2] = (unsigned char)(x >> 16);
            o[3] = (unsigned char)(x >> 24);
            memset(o + 4, 0, 28);
        } else {
            out[2 * i] = (unsigned char)x;
            out[2 * i + 1] = (unsigned char)(x >> 8);
        }
        return 0;
    }
    if (!wide) {
        PyErr_Format(PyExc_OverflowError, "pack: value at %zd outside "
                     "[0, 2^16)", i);
        return -1;
    }
    return as_bytes32(v, out + 32 * i) < 0 ? -1 : 1;
}

static Py_ssize_t pack(PyObject *seq, unsigned char *out, Py_ssize_t n,
                       int wide)
{
    PyObject *fast = PySequence_Fast(seq, "pack: not a sequence of ints");
    if (fast == NULL)
        return -1;
    Py_ssize_t slow = 0;
    if (n < 0 || PySequence_Fast_GET_SIZE(fast) < n) {
        PyErr_Format(PyExc_ValueError, "pack: %zd values asked of %zd", n,
                     PySequence_Fast_GET_SIZE(fast));
        slow = -1;
    }
    PyObject **items = PySequence_Fast_ITEMS(fast);
    for (Py_ssize_t i = 0; slow >= 0 && i < n; i++) {
        PyObject *v = items[i], *owned = NULL;
        if (!PyLong_CheckExact(v)) {
            v = owned = PyNumber_Index(v);
            if (v == NULL) {
                slow = -1;
                break;
            }
        }
        int r = pack_one((PyLongObject *)v, out, i, wide);
        Py_XDECREF(owned);
        slow = r < 0 ? -1 : slow + r;
    }
    Py_DECREF(fast);
    return slow;
}

Py_ssize_t pack_limbs16(PyObject *seq, void *out, Py_ssize_t n)
{
    return pack(seq, (unsigned char *)out, n, 1);
}

Py_ssize_t pack_u16(PyObject *seq, void *out, Py_ssize_t n)
{
    return pack(seq, (unsigned char *)out, n, 0);
}

void reduce_be256(const unsigned char *in, Py_ssize_t n,
                  const uint64_t *mod, unsigned char *out)
{
    for (Py_ssize_t i = 0; i < n; i++, in += 32, out += 32) {
        uint64_t v[4];                  /* little-endian words */
        for (int w = 0; w < 4; w++) {
            uint64_t x = 0;
            for (int j = 0; j < 8; j++)
                x = (x << 8) | in[8 * (3 - w) + j];
            v[w] = x;
        }
        for (;;) {
            int ge = 1;                 /* v >= mod */
            for (int w = 3; w >= 0; w--)
                if (v[w] != mod[w]) {
                    ge = v[w] > mod[w];
                    break;
                }
            if (!ge)
                break;
            unsigned borrow = 0;
            for (int w = 0; w < 4; w++) {
                uint64_t d = v[w] - mod[w] - borrow;
                borrow = v[w] < mod[w] || (v[w] == mod[w] && borrow);
                v[w] = d;
            }
        }
        for (int j = 0; j < 32; j++)
            out[j] = (unsigned char)(v[j / 8] >> (8 * (j % 8)));
    }
}
