"""FFT over G1 points (EC-FFT), batched butterflies.

Counterpart of ``constantine_tpu/ops/ec_fft.py`` (``ECFFTDomain``): the
radix-2 DIT of ``ops/ntt.py`` with G1 Jacobian points for elements, so a
twiddle product is a scalar multiplication by a root of unity. Every stage
is one batched ``ECGroup.scalar_mul`` (one ``ec_scalar_mul`` launch on the
card over the stage's n/2 x batch lanes, the twiddles expanded to every
lane) and one point add/sub pair (K3 add); the inverse adds one more
``scalar_mul`` by 1/n. FK20's transforms have 64-128 lanes, where the
kernel is bound by its chain of dependent multiplies, not by issue.

Unlike the reference, a transform takes trailing batch axes: points of
shape (n, ..., NL) are transformed along axis 0, so FK20's 64 EC-FFTs run
as one transform over (128, 64) points.
"""

from __future__ import annotations

import torch

from . import limbs as lb
from .ntt import bit_reversal_perm


class ECFFTDomain:
    def __init__(self, group, r_order: int, omega: int, log_n: int):
        """group: ECGroup (G1); omega: a primitive 2^log_n-th root in Fr."""
        self.group = group
        self.log_n = log_n
        self.n = 1 << log_n
        self.omega = omega
        self.r = r_order
        self.Ls = Ls = lb.num_limbs(r_order.bit_length())

        def stage_tables(w):
            return [lb.ints_to_limbs([pow(w, (self.n >> (s + 1)) * k, r_order)
                                      for k in range(1 << s)], Ls) for s in range(log_n)]

        self._tw = {False: stage_tables(omega), True: stage_tables(pow(omega, -1, r_order))}
        self._n_inv = lb.int_to_limbs(pow(self.n, -1, r_order), Ls)
        self.brp = bit_reversal_perm(self.n)
        self.scalar_bits = r_order.bit_length()
        self._dev = {}

    def _tables(self, device):
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = (
                {inv: [lb.to_tensor(t, device) for t in tabs] for inv, tabs in self._tw.items()},
                lb.to_tensor(self._n_inv, device),
                torch.as_tensor(self.brp, device=device))
        return self._dev[device]

    def _transform(self, P, inverse: bool):
        """P: Jacobian tuple of (n, ..., NL) tensors; natural order in and out."""
        g, n = self.group, self.n
        tws, n_inv, brp = self._tables(P[0].device)
        batch = tuple(P[0].shape[1:-1])
        P = tuple(t.index_select(0, brp) for t in P)
        for s, tw in enumerate(tws[inverse]):
            half = 1 << s
            blocks = n // (2 * half)
            split = [t.reshape((blocks, 2, half) + t.shape[1:]) for t in P]
            a = tuple(t[:, 0] for t in split)
            b = tuple(t[:, 1] for t in split)
            k = tw.reshape((1, half) + (1,) * len(batch) + (self.Ls,))
            t_pt = g.scalar_mul(k, b, scalar_bits=self.scalar_bits)
            lo = g.add(a, t_pt)
            hi = g.add(a, g.neg(t_pt))
            P = tuple(torch.stack([l, h], 1).reshape((n,) + l.shape[2:])
                      for l, h in zip(lo, hi))
        if inverse:
            P = g.scalar_mul(n_inv, P, scalar_bits=self.scalar_bits)
        return P

    def fft(self, P):
        """EC-FFT natural -> natural along axis 0."""
        return self._transform(P, False)

    def ifft(self, P):
        return self._transform(P, True)
