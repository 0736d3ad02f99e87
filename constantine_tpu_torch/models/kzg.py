"""KZG commitments over the bit-reversed Lagrange basis.

Counterpart of ``constantine_tpu/models/kzg.py`` for ``commit``,
``export_g1`` and ``commit_export``: the commitment is one fixed-base MSM
over the setup (``PrecomputedMSM``, the reference's default on an
accelerator), and the export returns canonical affine x, the y sign and the
infinity flag in one tensor so the host makes one copy.
"""

from __future__ import annotations

import functools

import torch

from ..device import resolve_device
from ..ops import limbs as lb
from ..ops.msm_precomp import PrecomputedMSM
from .trusted_setup import KZGSettings


class KZG:
    def __init__(self, settings: KZGSettings):
        self.s = settings
        self.ctx = settings.ctx
        self.device = settings.device
        self._pm = PrecomputedMSM(self.ctx.g1, settings.g1_lagrange_brp, scalar_bits=255)

    def _msm_srs(self, scalars_canonical):
        return self._pm(scalars_canonical)

    def commit(self, evals_brp_canonical):
        """evals (4096, 8) canonical Fr limbs, brp order -> Jacobian G1."""
        return self._msm_srs(evals_brp_canonical)

    def export_g1(self, P):
        """Jacobian point -> (1, NL+2) int32 [x canonical | y is big | inf]."""
        fp = self.ctx.fp
        (x, y), inf = self.ctx.g1.to_affine(tuple(t[None] for t in P))
        xc = fp.from_mont(x)
        yc = fp.from_mont(y)
        half = fp.from_int((fp.p_int + 1) // 2, xc.device)
        big = lb.geq(yc, half)
        return torch.cat([xc, big[..., None].to(torch.int32),
                          inf[..., None].to(torch.int32)], -1)

    def commit_export(self, evals_brp_canonical):
        return self.export_g1(self.commit(evals_brp_canonical))

    @staticmethod
    def unpack_export(packed):
        """(N, NL+2) export -> (x canonical u32 limbs, y_big, inf) numpy."""
        arr = lb.to_numpy(packed)
        return arr[:, :-2], arr[:, -2].astype(bool), arr[:, -1].astype(bool)


@functools.lru_cache(maxsize=None)
def _kzg_on(device: torch.device) -> KZG:
    return KZG(KZGSettings(device=device))


def get_kzg(device="cuda") -> KZG:
    """The process-wide KZG context of a device (setup and tables built once)."""
    return _kzg_on(resolve_device(device))
