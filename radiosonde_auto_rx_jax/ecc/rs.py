"""Batch-vectorized Reed-Solomon errors-and-erasures codec.

Decoding algorithm: Berlekamp-Massey with erasure initialisation + Chien
search + Forney, instead of the reference's extended-Euclid
(reference demod/mod/bch_ecc_mod.c rs_decode_ErrEra :877-960) — BM runs a
*fixed* 2t-iteration schedule with only elementwise selects, so one code
path decodes a whole batch of codewords at once (numpy here; the same
structure jit-compiles if moved on-device).

Codeword convention matches the reference: ``cw[i]`` is the coefficient of
X^i, ``cw[0:R]`` parity, ``cw[R:N]`` message; generator roots
beta^(b..b+2t-1) with beta = alpha^p.
"""

from dataclasses import dataclass, field

import numpy as np

from radiosonde_auto_rx_jax.ecc.gf import GF, GF256_RS, GF256_CCSDS


@dataclass
class RSCode:
    gf: GF
    n: int          # codeword length (= gf.q - 1)
    k: int          # message symbols
    b: int          # first consecutive generator root exponent
    g: np.ndarray = field(init=False)   # generator polynomial [R+1]

    def __post_init__(self):
        R = self.n - self.k
        g = np.array([1], dtype=np.int64)
        for i in range(R):
            root = self.gf.pow_beta(self.b + i)
            # g *= (X - root) == (X + root) in GF(2^m)
            g = self.gf.poly_mul(g, np.array([root, 1], dtype=np.int64))
        self.g = g
        # precomputed exponent matrices so syndrome/Chien/Forney
        # evaluation is one fused gather-XOR instead of a Python loop
        # per coefficient
        j = np.arange(self.n)
        i_r = np.arange(R)[:, None]
        self._e_syn = ((self.b + i_r) * j[None, :]) % self.gf.n    # [R, N]
        kk = np.arange(R + 1)[:, None]
        self._e_chien = (-kk * j[None, :]) % self.gf.n             # [R+1, N]
        xinv = (-j) % self.gf.n
        self._e_om = (xinv[None, :] * i_r) % self.gf.n             # [R, N]
        i2 = np.arange((R + 1) // 2)[:, None]
        self._e_dl = (xinv[None, :] * (2 * i2)) % self.gf.n        # [t, N]
        self._enc_basis = None       # lazy [K, R] systematic-parity basis

    @property
    def r(self) -> int:
        return self.n - self.k

    @property
    def t(self) -> int:
        return self.r // 2

    # ------------------------------------------------------------------
    def encode(self, msg: np.ndarray) -> np.ndarray:
        """msg [..., K] -> codeword [..., N] with parity in cw[..., :R].

        Systematic: c(X) = msg(X)*X^R + (msg(X)*X^R mod g(X)); by
        linearity parity = XOR_i msg_i · (X^{R+i} mod g), with the basis
        remainders computed once by long division and cached.
        """
        msg = np.asarray(msg, dtype=np.int64)
        batch = msg.shape[:-1]
        R = self.r
        if self._enc_basis is None:
            basis = np.zeros((self.k, R), dtype=np.int64)
            cur = np.zeros(R, dtype=np.int64)
            # cur = X^{R+i} mod g via repeated multiply-by-X reduction
            cur[0] = 1                           # start at X^0... shifted
            # compute X^R mod g first
            for _ in range(R):
                fb = cur[-1]
                cur[1:] = cur[:-1]
                cur[0] = 0
                cur ^= self.gf.mul(fb, self.g[:R])
            for i in range(self.k):
                basis[i] = cur
                fb = cur[-1]
                cur = np.concatenate([[0], cur[:-1]])
                cur ^= self.gf.mul(fb, self.g[:R])
            self._enc_basis = basis
        B = self._enc_basis                      # [K, R]
        nz = (msg[..., None] != 0) & (B != 0)
        terms = np.where(
            nz, self.gf.exp[self.gf.log[msg][..., None] + self.gf.log[B]],
            0)                                   # [..., K, R]
        parity = np.bitwise_xor.reduce(terms, axis=-2)
        cw = np.zeros(batch + (self.n,), dtype=np.int64)
        cw[..., R:] = msg
        cw[..., :R] = parity
        return cw

    # ------------------------------------------------------------------
    def syndromes(self, cw: np.ndarray) -> np.ndarray:
        """S[..., i] = c(beta^(b+i)), i = 0..R-1."""
        cw = np.asarray(cw, dtype=np.int64)
        # S_i = XOR_j cw[j] * beta^((b+i)*j): one [.., R, N] gather-XOR
        logc = self.gf.log[cw][..., None, :]
        terms = np.where((cw != 0)[..., None, :],
                         self.gf.exp[logc + self._e_syn], 0)
        return np.bitwise_xor.reduce(terms, axis=-1)

    # ------------------------------------------------------------------
    def decode(self, cw: np.ndarray, erase_pos: np.ndarray | None = None,
               n_era: np.ndarray | None = None):
        """Correct up to t errors (2*errors + erasures <= 2t) in place.

        cw: [..., N] int array (modified in place with corrections).
        erase_pos: [..., E] erasure positions (int), valid count per row in
            n_era [...] (0 if None).
        Returns n_corrected [...] int array, -1 where uncorrectable.
        Matches reference rs_decode/rs_decode_ErrEra semantics
        (bch_ecc_mod.c:877-966).
        """
        gf = self.gf
        cw = np.asarray(cw)
        if cw.ndim == 1:
            # the batch machinery below assumes a leading batch axis
            cwb = cw[None, :]
            n_err = self.decode(
                cwb,
                None if erase_pos is None else np.asarray(erase_pos)[None],
                None if n_era is None else np.asarray(n_era)[None])
            cw[:] = cwb[0]
            return int(n_err[0])
        batch = cw.shape[:-1]
        R, t = self.r, self.t

        S = self.syndromes(cw)                       # [..., R]
        all_zero = ~np.any(S != 0, axis=-1)          # already a codeword
        if (erase_pos is None or not erase_pos.size) and bool(
                np.all(all_zero)):
            # clean batch: skip BM/Chien/Forney entirely (the common
            # case; mirrors the reference's errors==0 early return)
            return np.zeros(batch, dtype=np.int64)

        # erasure locator Gamma(x) = prod (1 - X_j x), deg counts per row
        E = 0 if erase_pos is None else erase_pos.shape[-1]
        Lam = np.zeros(batch + (R + 1,), dtype=np.int64)
        Lam[..., 0] = 1
        rho = np.zeros(batch, dtype=np.int64)
        if E:
            n_era = np.asarray(n_era, dtype=np.int64)
            rho = n_era
            for e in range(E):
                active = e < n_era                   # [...]
                Xj = gf.pow_beta(erase_pos[..., e])
                term = np.zeros_like(Lam)
                term[..., 1:] = gf.mul(Xj[..., None], Lam[..., :-1])
                Lam = np.where(active[..., None], Lam ^ term, Lam)

        # Berlekamp-Massey with erasure init: Lambda=B=Gamma, L=rho,
        # iterate r = rho..2t-1.  All rows run all 2t steps; rows whose
        # rho is larger simply no-op the early steps.
        B = Lam.copy()
        L = rho.copy()
        bval = np.ones(batch, dtype=np.int64)
        m = np.ones(batch, dtype=np.int64)
        for r_it in range(R):
            step_active = r_it >= rho                # [...]
            # discrepancy Delta = sum_i Lam_i * S_{r-i} (one fused mul)
            delta = np.bitwise_xor.reduce(
                gf.mul(Lam[..., :r_it + 1], S[..., r_it::-1]), axis=-1)
            upd = step_active & (delta != 0)
            grow = upd & (2 * L <= r_it + rho)
            # shift = x^m * B
            coef = gf.div(delta, bval)               # delta/b
            # x^m shift with per-row m: gather-based shift
            idx = np.arange(R + 1)
            src = idx[None, :] - m.reshape(-1, 1)    # flatten batch
            Bf = B.reshape(-1, R + 1)
            valid = src >= 0
            xmBf = np.where(valid, np.take_along_axis(
                Bf, np.clip(src, 0, R), axis=1), 0)
            xmB = xmBf.reshape(Lam.shape)
            newLam = Lam ^ gf.mul(coef[..., None], xmB)
            # updates
            B = np.where(grow[..., None], Lam, B)
            Lam = np.where(upd[..., None], newLam, Lam)
            newL = r_it + 1 + rho - L
            bval = np.where(grow, delta, bval)
            L = np.where(grow, newL, L)
            m = np.where(grow, 1, np.where(step_active, m + 1, m))

        # Chien search: V[..., j] = Lambda(beta^{-j}) via one gather-XOR
        j = np.arange(self.n)
        V = np.bitwise_xor.reduce(
            np.where((Lam != 0)[..., None],
                     gf.exp[gf.log[Lam][..., None] + self._e_chien], 0),
            axis=-2)
        is_root = (V == 0)                            # [..., N]
        n_roots = is_root.sum(axis=-1)

        # Forney: Omega(x) = S(x)Lambda(x) mod x^R
        Om = np.zeros(batch + (R,), dtype=np.int64)
        for i in range(R):
            Om[..., i] = np.bitwise_xor.reduce(
                gf.mul(Lam[..., :i + 1], S[..., i::-1]), axis=-1)
        # Lambda'(x): odd coefficients
        dLam = Lam[..., 1::2]                          # coeffs of x^{2i}
        # error value at j: e_j = X_j^{1-b} * Om(X_j^{-1}) / Lam'(X_j^{-1})
        om_v = np.bitwise_xor.reduce(
            np.where((Om != 0)[..., None],
                     gf.exp[gf.log[Om][..., None] + self._e_om], 0),
            axis=-2)
        dl_v = np.bitwise_xor.reduce(
            np.where((dLam != 0)[..., None],
                     gf.exp[gf.log[dLam][..., None]
                            + self._e_dl[:dLam.shape[-1]]], 0),
            axis=-2)
        Xpow = gf.pow_beta((1 - self.b) * j)           # X_j^{1-b}
        ev = np.zeros(batch + (self.n,), dtype=np.int64)
        ev = gf.mul(Xpow[None, :] if ev.ndim > 1 else Xpow,
                    gf.div(om_v, np.where(dl_v == 0, 1, dl_v)))
        ev = np.where(is_root & (dl_v != 0), ev, 0)

        corrected = cw ^ ev
        # success check: L roots found, L == deg(Lambda) implied; verify
        # syndromes of corrected word are zero
        S2 = self.syndromes(corrected)
        ok = ~np.any(S2 != 0, axis=-1) & (n_roots == L)
        ok = ok | all_zero
        # write back corrections only for successful rows
        sel = (ok & ~all_zero)[..., None]
        cw[...] = np.where(sel, corrected, cw)
        n_corr = np.where(all_zero, 0, np.where(ok, n_roots, -1))
        return n_corr


RS255_231 = RSCode(GF256_RS, 255, 231, b=0)        # RS41/RS92
RS255_223_CCSDS = RSCode(GF256_CCSDS, 255, 223, b=112)  # LMS6
