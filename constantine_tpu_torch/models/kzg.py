"""KZG commitments and opening proofs over the bit-reversed Lagrange basis.

Counterpart of ``constantine_tpu/models/kzg.py``: ``commit``,
``export_g1``, ``commit_export``, ``commit_batch_export``, the barycentric
``eval_at``, ``compute_quotient`` (off-domain and in-domain z), ``prove``
and ``prove_export``. With ``precompute=True`` (the reference's default on
an accelerator) an MSM over the setup is the fixed-base ``PrecomputedMSM``;
with ``precompute=False`` it is the online MSM (``msm`` with the GLV split).
The exports return canonical affine x, the y sign and the infinity flag in
one tensor so the host makes one copy. The evaluation form never goes
through the NTT: proving is a barycentric sum, one batched inversion
(K8-K10 on the card) and the MSM.
"""

from __future__ import annotations

import functools

import torch

from ..device import resolve_device
from ..ops import limbs as lb
from ..ops.msm import msm
from ..ops.msm_precomp import PrecomputedMSM
from ..ops.ntt import bit_reversal_perm
from .trusted_setup import FIELD_ELEMENTS_PER_BLOB, LOG_BLOB, KZGSettings, get_settings


def export_g1_points(ctx, P):
    """Jacobian G1 points (B, NL) -> (B, NL+2) int32 [x canonical | y is
    big | inf]: one batched inversion, and one copy to the host makes the
    compressed bytes (``KZG.unpack_export``, ``g1_compress_canonical``)."""
    fp = ctx.fp
    (xc, yc), inf = ctx.g1.to_affine(P, canonical=True)
    half = fp.from_int((fp.p_int + 1) // 2, xc.device)
    big = lb.geq(yc, half)
    return torch.cat([xc, big[..., None].to(torch.int32),
                      inf[..., None].to(torch.int32)], -1)


def _tree_sum(F, arr):
    """Sum over axis -2 (a power of two long) in a log-depth tree."""
    while arr.shape[-2] > 1:
        h = arr.shape[-2] // 2
        arr = F.add(arr[..., :h, :], arr[..., h:, :])
    return arr[..., 0, :]


class KZG:
    def __init__(self, settings: KZGSettings, precompute: bool = True):
        self.s = settings
        self.ctx = settings.ctx
        self.device = settings.device
        self._pm = (PrecomputedMSM(self.ctx.g1, settings.g1_lagrange_brp, scalar_bits=255)
                    if precompute else None)
        self.fr = fr = self.ctx.fr
        N = FIELD_ELEMENTS_PER_BLOB
        w = self.ctx.root_of_unity(LOG_BLOB)
        roots = [pow(w, int(i), fr.p_int) for i in bit_reversal_perm(N)]
        self.roots_brp = fr.encode(roots, self.device)               # (N, 8) Montgomery
        self.n_inv = fr.encode(pow(N, -1, fr.p_int), self.device)

    def _msm_srs(self, scalars_canonical):
        if self._pm is not None:
            return self._pm(scalars_canonical)
        return msm(self.ctx.g1, self.s.g1_lagrange_brp, scalars_canonical, scalar_bits=255)

    def commit(self, evals_brp_canonical):
        """evals (4096, 8) canonical Fr limbs, brp order -> Jacobian G1."""
        return self._msm_srs(evals_brp_canonical)

    def _export(self, P):
        return export_g1_points(self.ctx, P)

    def export_g1(self, P):
        """Jacobian point -> (1, NL+2) int32 [x canonical | y is big | inf]."""
        return self._export(tuple(t[None] for t in P))

    def commit_export(self, evals_brp_canonical):
        return self.export_g1(self.commit(evals_brp_canonical))

    def commit_batch_export(self, polys):
        """(B, 4096, 8) canonical evals -> (B, NL+2) exports. With the
        precompute, one pipeline for all B (PrecomputedMSM.batch); without,
        one online MSM per blob."""
        if self._pm is not None:
            P = self._pm.batch(polys)
        else:
            outs = [self.commit(polys[i]) for i in range(polys.shape[0])]
            P = tuple(torch.stack([o[k] for o in outs]) for k in range(3))
        return self._export(P)

    # -- barycentric evaluation and the quotient ----------------------------------

    def _eval(self, evals, z):
        F = self.fr
        roots = self.roots_brp
        diff = F.sub(z[..., None, :].expand_as(evals), roots.expand_as(evals))   # z - w_i
        in_dom = F.is_zero(diff)                                    # at most one a row
        inv_diff = F.batch_inv(diff)                                # 0 where in-domain
        ssum = _tree_sum(F, F.prod(evals, roots, inv_diff))          # roots read per blob
        zn = F.prod(z, squarings=LOG_BLOB)                          # z^N
        one = F.broadcast_one(z.shape[:-1], z.device)
        y_off = F.prod(F.sub(zn, one), self.n_inv, ssum)
        y_in = _tree_sum(F, lb.cselect(in_dom, evals, torch.zeros_like(evals)))
        hit = in_dom.any(-1)
        return lb.cselect(hit, y_in, y_off), hit, in_dom, inv_diff

    def eval_at(self, evals_brp_mont, z_mont):
        """p(z) from the brp evaluation form by the barycentric formula
        y = (z^N - 1)/N * sum_i p_i w_i / (z - w_i), with an in-domain z = w_m
        masked to y = p_m. evals (..., N, 8), z (..., 8) Montgomery.
        Returns (y_mont (..., 8), hit (...,), in_dom (..., N))."""
        y, hit, in_dom, _ = self._eval(evals_brp_mont, z_mont)
        return y, hit, in_dom

    def compute_quotient(self, evals_brp_mont, z_mont):
        """The quotient (p(X) - y)/(X - z) in brp evaluation form:
        q_i = (p_i - y)/(w_i - z) off the domain; for z = w_m, q_m =
        -sum_{i != m} (p_i - y) w_i / (w_m (w_i - w_m)). Returns (q_mont
        (N, 8), y_mont (8,))."""
        F = self.fr
        y, _, in_dom, inv_diff = self._eval(evals_brp_mont, z_mont)
        num = F.sub(evals_brp_mont, y.expand_as(evals_brp_mont))
        den_inv = F.neg(inv_diff)                                   # 1/(w_i - z)
        q = F.mul(num, den_inv)
        wm_inv = F.batch_inv(z_mont[None])[0]                       # z = w_m if in-domain
        t = F.prod(q, self.roots_brp, wm_inv)
        qm = F.neg(_tree_sum(F, t))
        return lb.cselect(in_dom, qm.expand_as(q), q), y

    def prove(self, evals_brp_mont, z_mont):
        """KZG opening: (proof, a Jacobian G1 point, y_mont)."""
        q, y = self.compute_quotient(evals_brp_mont, z_mont)
        return self._msm_srs(self.fr.from_mont(q)), y

    def prove_export(self, evals_brp_mont, z_mont):
        """(2, NL+2) int32: row 0 the proof's export, row 1 y canonical
        (zero-padded)."""
        proof, y = self.prove(evals_brp_mont, z_mont)
        g1p = self.export_g1(proof)
        yc = self.fr.from_mont(y)[None]
        return torch.cat([g1p, torch.nn.functional.pad(yc, (0, g1p.shape[1] - yc.shape[1]))])

    @staticmethod
    def unpack_export(packed):
        """(N, NL+2) export -> (x canonical u32 limbs, y_big, inf) numpy."""
        arr = lb.to_numpy(packed)
        return arr[:, :-2], arr[:, -2].astype(bool), arr[:, -1].astype(bool)


@functools.lru_cache(maxsize=None)
def _kzg_on(device: torch.device, precompute: bool) -> KZG:
    return KZG(get_settings(device), precompute=precompute)


def get_kzg(device="cuda", precompute: bool = True) -> KZG:
    """The process-wide KZG context of a device (setup, and with precompute
    the fixed-base tables, built once)."""
    return _kzg_on(resolve_device(device), precompute)
