"""Number-theoretic transform (radix-2 FFT over Fr), batched.

Counterpart of ``constantine_tpu/ops/ntt.py``: ``bit_reversal_perm``,
``NTTDomain`` (per-stage twiddle tables, ``ntt``/``intt`` natural order in
and out, ``brp_permute``, ``coset_ntt``/``coset_intt`` with the shift
powers cached per shift) and ``get_domain``. Elements are (..., n, NL)
Montgomery Fr tensors.

Two routes, as the reference chooses them (its :208-214, minus the backend
test and the ``CTT_NTT_PALLAS`` switch), with one more condition: a 2-D
input with n >= 1024 whose two passes each fit a tile of shared memory (n
<= 2^22 at 8 limbs) takes the Bailey four-step (column transforms of size
n1 along the middle axis, the twiddle matrix, a transpose, row transforms
of size n2); anything else, batched inputs included, the radix-2 DIT. Each
pass of both (the bit reversal and its stages) is one K3′ ``ntt_stages``
call where its tile fits a block's shared memory, the stages left over one
``ntt_bfly`` call each (``cuda_ntt.py``: the kernels on CUDA tensors, their
plain versions on CPU tensors). The pointwise products ride on the passes
as factors: the four-step's column pass stores its product with the
twiddle matrix transposed, so a four-step transform is two launches; 1/n
is the last pass's store factor, and a coset transform's shift powers the
first pass's load factor (forward) or, with 1/n, the last pass's store
factor (inverse). Only where a radix-2 transform leaves stages to
``ntt_bfly`` does the store factor become a K1 product after them.

Tables are built here from python ints in the port's (m, NL) 32-bit
Montgomery form, the stage tables packed into one (n - 1, NL) table (stage
s at rows 2^s - 1 .. 2^(s+1) - 2). The four-step's column and row stages
reuse the radix-2 stage tables: stage s of a size-n1 transform with root
w^n2 has twiddles (w^n2)^((n1/2^(s+1)) k) = w^((n/2^(s+1)) k), stage s's
table of the size-n transform (likewise for the rows).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import limbs as lb
from .cuda_ntt import ntt_bfly, ntt_stages, pass_stages


def bit_reversal_perm(n: int) -> np.ndarray:
    """Bit-reversal index table for size n = 2^k."""
    k = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


def four_step_split(log_n: int, NL: int):
    """(n1, n2) of the four-step at n = 2^log_n, n1 = 2^(log_n // 2), where
    both passes take every stage in one ntt_stages launch (a column pass of
    n1 rows over n2 lanes, a row pass of n2 rows over n1); else None."""
    n1 = 1 << (log_n // 2)
    n2 = (1 << log_n) // n1
    if pass_stages(n1, n2, NL) == log_n // 2 and pass_stages(n2, n1, NL) == log_n - log_n // 2:
        return n1, n2
    return None


def _powers(w: int, count: int, p: int) -> list:
    out, cur = [], 1
    for _ in range(count):
        out.append(cur)
        cur = cur * w % p
    return out


class NTTDomain:
    """Radix-2 evaluation domain of size 2^log_n over a scalar field F."""

    FOUR_STEP_MIN = 1024

    def __init__(self, F, omega: int, log_n: int):
        self.F = F
        self.log_n = log_n
        self.n = n = 1 << log_n
        self.omega = omega
        p = F.p_int
        if pow(omega, n, p) != 1 or (n > 1 and pow(omega, n // 2, p) == 1):
            raise ValueError(f"omega is not a primitive 2^{log_n}-th root of unity")
        w_pows = _powers(omega, n // 2, p)
        wi_pows = _powers(pow(omega, -1, p), n // 2, p)
        enc = functools.partial(self._encode_host, F)
        # stage s (m = 2^(s+1)) twiddles: omega^((n/m) k), k < m/2, packed
        self._tw = {inv: enc([pows[(n >> (s + 1)) * k] for s in range(log_n)
                              for k in range(1 << s)]).reshape(-1, F.NL)
                    for inv, pows in ((False, w_pows), (True, wi_pows))}
        self.brp = bit_reversal_perm(n)
        self._n_inv = enc([pow(n, -1, p)])[0]
        self.domain_int = _powers(omega, n, p)
        self._host_fs = {}
        self._coset = {}
        self._dev = {}

    @staticmethod
    def _encode_host(F, ints) -> np.ndarray:
        """Python ints -> (len, NL) uint32 Montgomery limbs."""
        return lb.ints_to_limbs([v * F.R_int % F.p_int for v in ints], F.NL)

    def _on(self, device, key, make):
        """A host table as a tensor on `device`, made once per device."""
        device = torch.device(device)
        slot = self._dev.setdefault(device, {})
        if key not in slot:
            slot[key] = make(device)
        return slot[key]

    def packed_twiddles(self, inverse: bool, device):
        """The stage tables packed, (n - 1, NL) on `device`: stage s's 2^s
        twiddles at rows 2^s - 1 .. 2^(s+1) - 2."""
        return self._on(device, ("tw", inverse), lambda d: lb.to_tensor(self._tw[inverse], d))

    def twiddles(self, inverse: bool, device):
        """The per-stage tables [(2^s, NL)], views of the packed table."""
        tw = self.packed_twiddles(inverse, device)
        return [tw[(1 << s) - 1:(2 << s) - 1] for s in range(self.log_n)]

    def _brp_index(self, n: int, device):
        return self._on(device, ("brp", n),
                        lambda d: torch.as_tensor(bit_reversal_perm(n), device=d))

    def n_inv(self, device):
        return self._on(device, "n_inv", lambda d: lb.to_tensor(self._n_inv, d))

    def _n_inv_factor(self, device):
        """1/n as a factor table of period 1, (1, NL)."""
        return self.n_inv(device).reshape(1, self.F.NL)

    # -- radix-2 DIT --------------------------------------------------------------

    def _stages(self, y, tw, brp, in_fac=None, out_fac=None):
        """Bit-reverse axis 1 of y (B, ns, lanes, NL), then its log2(ns)
        radix-2 stages (tw: the packed tables, the first ns - 1 rows read):
        one K3′ ntt_stages pass over the stages whose tile fits a block,
        with in_fac on its load and, where it takes every stage, out_fac on
        its store; then one ntt_bfly per stage left, in place on the pass's
        output, and out_fac as a K1 product."""
        F, ns = self.F, y.shape[1]
        L = ns.bit_length() - 1
        if L == 0:                      # one row: no stage, the factors as products
            for f in (in_fac, out_fac):
                y = y if f is None else F.mul(y, f)
            return y
        k = pass_stages(ns, y.shape[2], F.NL)
        y = ntt_stages(F, y, tw, brp, k, in_fac=in_fac, out_fac=out_fac if k == L else None)
        for s in range(k, L):
            y = ntt_bfly(F, y, tw[(1 << s) - 1:(2 << s) - 1], 1 << s, out=y)
        if out_fac is not None and k < L:
            y = F.mul(y, out_fac.reshape(y.shape[1:]) if out_fac.shape[0] > 1 else out_fac)
        return y

    def _transform(self, x, inverse: bool, in_fac=None, out_fac=None):
        """Radix-2 DIT over axis -2 of x (..., n, NL): natural order in and
        out; in_fac (n or 1 rows) times the input, out_fac times the output
        (1/n on the inverse unless given)."""
        if x.shape[-2:] != (self.n, self.F.NL):
            raise ValueError(f"NTT of size {self.n} over {tuple(x.shape)}")
        dev = x.device
        if inverse and out_fac is None:
            out_fac = self._n_inv_factor(dev)
        y = x.reshape(-1, self.n, 1, self.F.NL)
        y = self._stages(y, self.packed_twiddles(inverse, dev), self._brp_index(self.n, dev),
                         in_fac, out_fac)
        return y.reshape(x.shape)

    # -- Bailey four-step (the reference's Pallas route) -----------------------------

    def _four_step_tables(self, inverse: bool, device):
        """(n1, n2, twiddle matrix (n2·n1, NL)) on `device`: w^(k1 i2) at
        row i2·n1 + k1, the place the column pass stores (k1, i2) to."""
        if inverse not in self._host_fs:
            F, p = self.F, self.F.p_int
            n1 = 1 << (self.log_n // 2)
            n2 = self.n // n1
            w = pow(self.omega, -1, p) if inverse else self.omega
            vals = []
            for i2 in range(n2):
                vals.extend(_powers(pow(w, i2, p), n1, p))
            self._host_fs[inverse] = (n1, n2, self._encode_host(F, vals))
        n1, n2, twm = self._host_fs[inverse]
        return n1, n2, self._on(device, ("twm", inverse), lambda d: lb.to_tensor(twm, d))

    def _transform_four_step(self, x, inverse: bool, in_fac=None, out_fac=None):
        """x (n, NL): read as (n1, n2) with i = i1·n2 + i2; column NTTs of
        size n1 over the n2 lanes, stored transposed with the twiddle
        matrix as the factor (in_fac on the load); row NTTs of size n2 over
        the n1 lanes, out_fac (1/n on the inverse unless given) on the
        store; written out as k = k2·n1 + k1. Two ntt_stages launches."""
        F, n, dev = self.F, self.n, x.device
        n1, n2, twm = self._four_step_tables(inverse, dev)
        tw = self.packed_twiddles(inverse, dev)
        if inverse and out_fac is None:
            out_fac = self._n_inv_factor(dev)
        y = ntt_stages(F, x.reshape(1, n1, n2, F.NL), tw, self._brp_index(n1, dev),
                       n1.bit_length() - 1, in_fac=in_fac, out_fac=twm, transposed=True)
        y = ntt_stages(F, y, tw, self._brp_index(n2, dev), n2.bit_length() - 1,
                       out_fac=out_fac)
        return y.reshape(n, F.NL)

    def _use_four_step(self, x) -> bool:
        return (x.dim() == 2 and self.n >= self.FOUR_STEP_MIN
                and four_step_split(self.log_n, self.F.NL) is not None)

    def _route(self, x, inverse, in_fac=None, out_fac=None):
        go = self._transform_four_step if self._use_four_step(x) else self._transform
        return go(x, inverse, in_fac, out_fac)

    def ntt(self, x):
        """Forward NTT, natural -> natural."""
        return self._route(x, False)

    def intt(self, x):
        """Inverse NTT, natural -> natural."""
        return self._route(x, True)

    def brp_permute(self, x):
        """Bit-reversal permute along the element axis (axis -2)."""
        return x.index_select(x.dim() - 2, self._brp_index(self.n, x.device))

    # -- coset (shifted-domain) transforms -------------------------------------------

    def _coset_factors(self, shift: int, inverse: bool, device):
        """(n, NL) Montgomery factors of the coset transform over shift·<omega>:
        s^i (forward, the input's), or n^-1 s^-k (inverse, the output's),
        built on the host once per shift and kept on each device."""
        key = ("coset", shift, inverse)
        if key not in self._coset:
            p = self.F.p_int
            s = pow(shift, -1, p) if inverse else shift
            c = pow(self.n, -1, p) if inverse else 1
            self._coset[key] = self._encode_host(self.F, [c * v % p for v in _powers(s, self.n, p)])
        return self._on(device, key, lambda d: lb.to_tensor(self._coset[key], d))

    def coset_ntt(self, coeffs, shift: int):
        """Evaluate a polynomial (coefficient form) on the coset shift·<omega>:
        coeff_i times shift^i on the first pass's load, then the NTT."""
        return self._route(coeffs, False, in_fac=self._coset_factors(shift, False,
                                                                     coeffs.device))

    def coset_intt(self, evals, shift: int):
        """Inverse: interpolate over the coset, return coefficients (n^-1
        shift^-k on the last pass's store)."""
        return self._route(evals, True, out_fac=self._coset_factors(shift, True, evals.device))


@functools.lru_cache(maxsize=None)
def get_domain(curve_name: str, log_n: int) -> NTTDomain:
    from ..named.precompute import get_curve
    ctx = get_curve(curve_name)
    return NTTDomain(ctx.fr, ctx.root_of_unity(log_n), log_n)
