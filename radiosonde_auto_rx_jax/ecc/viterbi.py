"""Rate-1/2 K=7 convolutional code: encoder + soft-decision Viterbi.

Polynomials per the reference LMS6 decoder (reference
demod/mod/lms6Xmod.c:115-117): polyA = 0x4F (x^6+x^3+x^2+x+1),
polyB = 0x6D (x^6+x^5+x^3+x^2+1), d_free = 10; trellis construction
:208-344.  Implementation is new and fully vectorized: the
add-compare-select step runs over all 64 states at once (numpy on the
host frame plane; the identical array program maps to a ``lax.scan`` over
pairs with a [64]-state carry on device).
"""

import numpy as np

L = 7
NSTATES = 1 << L          # 128 "extended" states (state + input bit)
M = 1 << (L - 1)          # 64 trellis states
POLY_A = 0b1001111        # taps (bit i of state word)
POLY_B = 0b1101101

# vit_code[bits]: expected (cA, cB) for a 7-bit window `bits`
# (lms6Xmod.c:217-226: cA = XOR_i polyA[L-1-i] & bits_i)
_bits = np.arange(NSTATES)
_cA = np.zeros(NSTATES, dtype=np.int64)
_cB = np.zeros(NSTATES, dtype=np.int64)
for _i in range(L):
    # state word bit i = b[k-i] (bit 0 newest); tap = POLY bit i
    tap_a = (POLY_A >> _i) & 1
    tap_b = (POLY_B >> _i) & 1
    _cA ^= tap_a & (_bits >> _i)
    _cB ^= tap_b & (_bits >> _i)
_cA &= 1
_cB &= 1
VIT_CODE = (_cA << 1) | _cB               # [128]


def conv_encode(data_bits):
    """Data bits -> raw pairs (cA, cB) interleaved, zero initial state.

    Matches the reference deconv relation (lms6Xmod.c:346-377):
    cA(k) = XOR_j polyA[j]·b[k-6+j] with polyA string left-to-right.
    """
    b = np.asarray(data_bits, dtype=np.uint8)
    hist = np.concatenate([np.zeros(L - 1, dtype=np.uint8), b])
    cA = np.zeros(len(b), dtype=np.uint8)
    cB = np.zeros(len(b), dtype=np.uint8)
    # polyA char j taps b[k-6+j]; char j = bit (L-1-j) of POLY_A
    for j in range(L):
        tap_a = (POLY_A >> (L - 1 - j)) & 1
        tap_b = (POLY_B >> (L - 1 - j)) & 1
        if tap_a:
            cA ^= hist[j:j + len(b)]
        if tap_b:
            cB ^= hist[j:j + len(b)]
    out = np.empty(2 * len(b), dtype=np.uint8)
    out[0::2] = cA
    out[1::2] = cB
    return out


def viterbi_decode(soft_pairs):
    """Soft Viterbi over raw soft values [2T] (+1/-1-ish floats).

    Returns hard data bits [T].  Trellis per lms6Xmod.c: extended state =
    (prev_state*2 + input_bit) & 0x7F; expected pair = VIT_CODE[ext].

    Dispatches to the native C ACS loop when the host runtime is built
    (~400x over the per-step numpy loop); the numpy path below is the
    reference implementation and fallback.
    """
    # the short-input guard must run BEFORE native dispatch so both
    # builds return the same result (the native path would emit T bits
    # for T < L where the reference numpy path emits none); length only
    # — the float64 conversion is deferred to the numpy fallback
    if len(soft_pairs) // 2 < L:
        return np.zeros(0, dtype=np.uint8)
    from radiosonde_auto_rx_jax import native
    if native.available():
        return native.viterbi_k7(soft_pairs)
    s = np.asarray(soft_pairs, dtype=np.float64)
    T = len(s) // 2
    sA = s[0:2 * T:2]
    sB = s[1:2 * T:2]

    # branch metric per extended state at step t:
    # d2 = (cA' - sA)^2 + (cB' - sB)^2, c' in {-1,+1}
    cA_pm = 2.0 * _cA - 1.0                      # [128]
    cB_pm = 2.0 * _cB - 1.0

    INF = 1e30
    pw = np.full(M, INF)
    pw[0] = 0.0                                   # zero initial state
    prev = np.zeros((T, M), dtype=np.int8)        # surviving input bit
    prevstate = np.zeros((T, M), dtype=np.int32)

    states = np.arange(M)
    # extended index for (from_state j, bit b): n = j*2 + b  (0..127);
    # new trellis state = n & (M-1)?? — reference: nextState = j*2+b mod M
    # with VIT_CODE indexed by the full 7-bit n.
    n0 = states * 2          # bit 0
    n1 = states * 2 + 1      # bit 1
    for t in range(T):
        d0 = (cA_pm[n0] - sA[t]) ** 2 + (cB_pm[n0] - sB[t]) ** 2
        d1 = (cA_pm[n1] - sA[t]) ** 2 + (cB_pm[n1] - sB[t]) ** 2
        cand = np.empty(2 * M)
        cand[n0] = pw + d0
        cand[n1] = pw + d1
        # new state k receives from extended indices k and k+M
        lo = cand[states]
        hi = cand[states + M]
        take_hi = hi < lo
        pw = np.where(take_hi, hi, lo)
        ext = np.where(take_hi, states + M, states)
        prev[t] = (ext & 1).astype(np.int8)
        prevstate[t] = ext >> 1
    # traceback from best end state
    j = int(np.argmin(pw))
    bits = np.zeros(T, dtype=np.uint8)
    for t in range(T - 1, -1, -1):
        bits[t] = prev[t, j]
        j = int(prevstate[t, j])
    return bits
