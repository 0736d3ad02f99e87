"""KZG commitments over the bit-reversed Lagrange basis.

Counterpart of ``constantine_tpu/models/kzg.py`` for ``commit``,
``export_g1``, ``commit_export`` and ``commit_batch_export``. With
``precompute=True`` (the reference's default on an accelerator) the
commitment is one fixed-base MSM over the setup (``PrecomputedMSM``); with
``precompute=False`` it is the online MSM (``msm`` with the GLV split). The
exports return canonical affine x, the y sign and the infinity flag in one
tensor so the host makes one copy.
"""

from __future__ import annotations

import functools

import torch

from ..device import resolve_device
from ..ops import limbs as lb
from ..ops.msm import msm
from ..ops.msm_precomp import PrecomputedMSM
from .trusted_setup import KZGSettings


class KZG:
    def __init__(self, settings: KZGSettings, precompute: bool = True):
        self.s = settings
        self.ctx = settings.ctx
        self.device = settings.device
        self._pm = (PrecomputedMSM(self.ctx.g1, settings.g1_lagrange_brp, scalar_bits=255)
                    if precompute else None)

    def _msm_srs(self, scalars_canonical):
        if self._pm is not None:
            return self._pm(scalars_canonical)
        return msm(self.ctx.g1, self.s.g1_lagrange_brp, scalars_canonical, scalar_bits=255)

    def commit(self, evals_brp_canonical):
        """evals (4096, 8) canonical Fr limbs, brp order -> Jacobian G1."""
        return self._msm_srs(evals_brp_canonical)

    def _export(self, P):
        """Jacobian points (B, NL) -> (B, NL+2) int32 [x canonical | y is
        big | inf]."""
        fp = self.ctx.fp
        (x, y), inf = self.ctx.g1.to_affine(P)
        xc = fp.from_mont(x)
        yc = fp.from_mont(y)
        half = fp.from_int((fp.p_int + 1) // 2, xc.device)
        big = lb.geq(yc, half)
        return torch.cat([xc, big[..., None].to(torch.int32),
                          inf[..., None].to(torch.int32)], -1)

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

    @staticmethod
    def unpack_export(packed):
        """(N, NL+2) export -> (x canonical u32 limbs, y_big, inf) numpy."""
        arr = lb.to_numpy(packed)
        return arr[:, :-2], arr[:, -2].astype(bool), arr[:, -1].astype(bool)


@functools.lru_cache(maxsize=None)
def _kzg_on(device: torch.device, precompute: bool) -> KZG:
    return KZG(KZGSettings(device=device), precompute=precompute)


def get_kzg(device="cuda", precompute: bool = True) -> KZG:
    """The process-wide KZG context of a device (setup, and with precompute
    the fixed-base tables, built once)."""
    return _kzg_on(resolve_device(device), precompute)
