"""Gumbel-statistics E-values, exact port of the ALP finite-size correction
(reference: lib/mmseqs/lib/alp/sls_pvalues.cpp:366-490,
sls_alignment_evaluer.cpp:989-1029, EvalueComputation.h:18-45).

Vectorized over scores (NumPy).
"""
import numpy as np

from .. import constants

_SQRT_HALF = np.sqrt(0.5)
_CONST_VAL = 1.0 / np.sqrt(2.0 * np.pi)
_NAT_CUTOFF = 2.0  # sls_pvalues.cpp:46


class EvalueComputer:
    """Equivalent of EvalueComputation for a fixed parameter set.

    params: 12-vector [lambda K aJ bJ aI bI alphaJ betaJ alphaI betaI sigma tau]
    db_res_count: total residues in the target DB.
    """

    def __init__(self, params, db_res_count):
        (self.lam, self.K, self.a_J, self.b_J, self.a_I, self.b_I,
         self.alpha_J, self.beta_J, self.alpha_I, self.beta_I,
         self.sigma, self.tau) = [float(x) for x in params]
        self.db_res_count = float(db_res_count)
        self.log_K = np.log(self.K)
        if self.lam > 0:
            self.vi_y_thr = max(_NAT_CUTOFF * self.alpha_I / self.lam, 0.0)
            self.vj_y_thr = max(_NAT_CUTOFF * self.alpha_J / self.lam, 0.0)
            self.c_y_thr = max(_NAT_CUTOFF * self.sigma / self.lam, 0.0)
        else:
            self.vi_y_thr = self.vj_y_thr = self.c_y_thr = 0.0

    @classmethod
    def for_matrix(cls, name, db_res_count):
        return cls(constants.evalue_params(name), db_res_count)

    def area(self, score, query_len, xp=np):
        """ALP area (m_ = dbResCount, n_ = queryLen)."""
        y = score
        m = self.db_res_count
        n = query_len

        m_li_y = m - (self.a_I * y + self.b_I)
        vi_y = xp.maximum(self.vi_y_thr, self.alpha_I * y + self.beta_I)
        sqrt_vi = xp.sqrt(vi_y)
        m_F = xp.where(sqrt_vi == 0.0, 1e100, m_li_y / xp.where(sqrt_vi == 0, 1.0, sqrt_vi))
        P_m = 0.5 * _erfc(-_SQRT_HALF * m_F, xp)
        E_m = -_CONST_VAL * xp.exp(-0.5 * m_F * m_F)
        p1 = m_li_y * P_m - sqrt_vi * E_m

        n_lj_y = n - (self.a_J * y + self.b_J)
        vj_y = xp.maximum(self.vj_y_thr, self.alpha_J * y + self.beta_J)
        sqrt_vj = xp.sqrt(vj_y)
        n_F = xp.where(sqrt_vj == 0.0, 1e100, n_lj_y / xp.where(sqrt_vj == 0, 1.0, sqrt_vj))
        P_n = 0.5 * _erfc(-_SQRT_HALF * n_F, xp)
        E_n = -_CONST_VAL * xp.exp(-0.5 * n_F * n_F)
        p2 = n_lj_y * P_n - sqrt_vj * E_n

        c_y = xp.maximum(self.c_y_thr, self.sigma * y + self.tau)
        return p1 * p2 + c_y * P_m * P_n

    def evalue(self, score, query_len, xp=np):
        score = xp.asarray(score, dtype=xp.float64)
        # association matters for subnormal E-values: the reference computes
        # evaluePerArea = K*exp(-lambda*s) first, then multiplies by area
        # (EvalueComputation.h:36-40, sls_alignment_evaluer.hpp:154-157)
        epa = self.K * xp.exp(-self.lam * score)
        return epa * self.area(score,
                               xp.asarray(query_len, dtype=xp.float64), xp)

    def bit_score(self, score, xp=np):
        return (self.lam * xp.asarray(score, dtype=xp.float64) - self.log_K) / np.log(2.0)

    def raw_score_from_bit(self, bit, xp=np):
        """computeRawScoreFromBitScore (EvalueComputation.h:22-24)."""
        return (self.log_K + xp.asarray(bit, dtype=xp.float64) * np.log(2.0)) / self.lam


def _erfc(x, xp):
    from scipy.special import erfc as _e  # pragma: no cover
    return _e(x)


# scipy may be unavailable; fall back to math.erfc elementwise
try:  # pragma: no cover
    from scipy.special import erfc as _scipy_erfc  # noqa: F401
except ImportError:  # pragma: no cover
    import math

    def _erfc(x, xp):  # noqa: F811
        return np.vectorize(math.erfc)(x)
