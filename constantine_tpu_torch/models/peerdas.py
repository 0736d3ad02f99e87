"""EIP-7594 PeerDAS: cells, FK20 cell proofs, batch verification, recovery.

Counterpart of ``constantine_tpu/models/peerdas.py``: ``PeerDAS`` with
``compute_cells``, ``compute_cells_and_kzg_proofs``,
``verify_cell_kzg_proof_batch`` and ``recover_cells_and_kzg_proofs`` (the
consensus spec's transcript and rejection rules: every branch that returns
None in the reference returns None here), and the module-level entry
points of the same names, which run on `device` (default the card) or on
``das.device`` when a context is given.

The transforms are ``ops/ntt.py``'s (K3′ on the card): the blob's iNTT at
4096 and the extension NTT at 8192 take the four-step route, the FK20
circulant NTT over (64, 128) and the verify's cell iNTT over (n, 64) the
batched radix-2 one. FK20's point work composes K3 through
``ECGroup.scalar_mul``: the bank (the 64 EC-FFTs of the polyphase SRS) is
one EC-FFT over (128, 64) points, built on the device by ``get_peerdas``
(and on first use by a ``PeerDAS`` made directly), with no file cache. The
verify decompresses commitments and proofs in one K13 call, takes the
reference's four MSMs as two through ``ops/msm.py`` (the three on the
left-hand side as one) and its 2-pair check through K11/K12; recovery
inverts through K8-K10.

Two departures from the reference. FK20 takes the inverse EC-FFT that the
reference leaves out, without which no proof verifies (ROADMAP.md F5).
Infinity commitments and proofs are masked by zeroing their MSM scalars
(as ``models/verify_fused.py`` does), where the reference feeds their
decompressed (0, 2) into the MSMs; the verdicts agree.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from ..device import resolve_device
from ..ops import limbs as lb
from ..ops.cuda_g1 import get_cuda_g1
from ..ops.ec_fft import ECFFTDomain
from ..ops.msm import msm
from ..ops.ntt import bit_reversal_perm, get_domain
from ..ops.pairing import get_pairing
from ..utils.serialization import g1_compress_canonical, parse_g1_host, scalars_from_bytes
from .eip4844 import BYTES_PER_G1, blob_to_polynomial
from .kzg import KZG, export_g1_points
from .trusted_setup import FIELD_ELEMENTS_PER_BLOB, KZGSettings, get_settings

FIELD_ELEMENTS_PER_CELL = 64
CELLS_PER_EXT_BLOB = 128
FIELD_ELEMENTS_PER_EXT_BLOB = 8192
BYTES_PER_CELL = FIELD_ELEMENTS_PER_CELL * 32
RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN = b"RCKZGCBATCH__V1_"
RECOVERY_SHIFT = 7


def _compress(ctx, P) -> list:
    """Jacobian G1 points (B, NL) -> B 48-byte compressed encodings."""
    out = g1_compress_canonical(*KZG.unpack_export(export_g1_points(ctx, P)))
    return [out[48 * i:48 * (i + 1)] for i in range(len(out) // 48)]


class PeerDAS:
    def __init__(self, settings: KZGSettings):
        self.settings = settings
        self.device = dev = settings.device
        self.ctx = ctx = settings.ctx
        self.fr = ctx.fr
        self.dom_blob = get_domain("BLS12_381", 12)      # 4096
        self.dom_ext = get_domain("BLS12_381", 13)       # 8192
        self.dom_cds = get_domain("BLS12_381", 7)        # 128 (CDS)
        self.dom_cell = get_domain("BLS12_381", 6)       # 64
        self.ec_cds = ECFFTDomain(ctx.g1, ctx.r, ctx.root_of_unity(7), 7)
        self.brp128 = bit_reversal_perm(CELLS_PER_EXT_BLOB)
        self._brp = {n: torch.as_tensor(bit_reversal_perm(n), device=dev)
                     for n in (FIELD_ELEMENTS_PER_CELL, CELLS_PER_EXT_BLOB,
                               FIELD_ELEMENTS_PER_BLOB, FIELD_ELEMENTS_PER_EXT_BLOB)}
        # coset shifts h_i = omega_ext^rev7(i); h_i^64 are 128th roots
        w_ext = self.dom_ext.omega
        self.coset_shifts = [pow(w_ext, int(self.brp128[i]), ctx.r)
                             for i in range(CELLS_PER_EXT_BLOB)]
        # circulant gather indices and mask (the reference's toeplitz layout)
        n, L, cds = FIELD_ELEMENTS_PER_BLOB, FIELD_ELEMENTS_PER_CELL, CELLS_PER_EXT_BLOB
        idx = np.zeros((L, cds), np.int64)
        mask = np.zeros((L, cds), bool)
        for off in range(L):
            idx[off, 0] = n - 1 - off
            mask[off, 0] = True
            for j in range(1, cds // 2 - 1):
                idx[off, cds - j] = n - 1 - off - j * L
                mask[off, cds - j] = True
        self._circ_idx = torch.as_tensor(idx.reshape(-1), device=dev)
        self._circ_mask = torch.as_tensor(mask, device=dev)

    # -- FK20 precompute: the polyphase spectrum bank -----------------------------------

    @functools.cached_property
    def bank(self):
        """(64, 128) Jacobian spectrum bank of the monomial SRS: row `off` is
        the EC-FFT of [tau^(n-L-1-off-jL)]G1 for j < 63, padded with
        infinity to 128; all 64 rows in one EC-FFT over (128, 64) points."""
        g1 = self.ctx.g1
        n, L, cds = FIELD_ELEMENTS_PER_BLOB, FIELD_ELEMENTS_PER_CELL, CELLS_PER_EXT_BLOB
        sel = torch.as_tensor([[n - L - 1 - off - j * L for off in range(L)]
                               for j in range(cds // 2 - 1)], device=self.device)   # (63, 64)
        mx, my = self.settings.g1_monomial
        P = g1.from_affine((mx[sel], my[sel]))
        inf = g1.infinity((cds - sel.shape[0], L), self.device)
        P = tuple(torch.cat([a, b]) for a, b in zip(P, inf))                         # (128, 64)
        return tuple(t.transpose(0, 1).contiguous() for t in self.ec_cds.fft(P))

    # -- cells ------------------------------------------------------------------------------

    def _blob_to_coeffs(self, blob: bytes):
        """Blob -> polynomial coefficients (4096, 8) Montgomery, or None."""
        poly, ok = blob_to_polynomial(blob)
        if not ok:
            return None
        evals_brp = self.fr.to_mont(lb.to_tensor(poly, self.device))
        return self.dom_blob.intt(evals_brp.index_select(0, self._brp[FIELD_ELEMENTS_PER_BLOB]))

    def _coeffs_to_cells_bytes(self, coeffs):
        ext = torch.cat([coeffs, torch.zeros_like(coeffs)])
        evals = self.dom_ext.ntt(ext).index_select(0, self._brp[FIELD_ELEMENTS_PER_EXT_BLOB])
        data = lb.limbs_to_bytes_be(self.fr.from_mont(evals), 32)
        return [data[i * BYTES_PER_CELL:(i + 1) * BYTES_PER_CELL]
                for i in range(CELLS_PER_EXT_BLOB)]

    def compute_cells(self, blob: bytes):
        """-> list of 128 cells (2048 bytes each), or None."""
        coeffs = self._blob_to_coeffs(blob)
        if coeffs is None:
            return None
        return self._coeffs_to_cells_bytes(coeffs)

    def _fk20_proofs(self, coeffs):
        """The 128 cell proofs (Jacobian, brp cell order) by FK20: the
        circulant NTT, the Hadamard product with the bank as one 8192-lane
        scalar multiplication and a tree over its 64 rows, the inverse
        EC-FFT back to the Toeplitz product, its upper half zeroed, then the
        EC-FFT. The reference skips the inverse EC-FFT (ROADMAP.md F5)."""
        F, g1 = self.fr, self.ctx.g1
        L, cds = FIELD_ELEMENTS_PER_CELL, CELLS_PER_EXT_BLOB
        circ = coeffs.index_select(0, self._circ_idx).reshape(L, cds, F.NL)
        circ = torch.where(self._circ_mask[..., None], circ, torch.zeros_like(circ))
        w_canon = F.from_mont(self.dom_cds.ntt(circ))                   # (64, 128)
        u = g1.scalar_mul(w_canon, self.bank, scalar_bits=255)
        m = L
        while m > 1:
            h = m // 2
            u = g1.add(tuple(t[:h] for t in u), tuple(t[h:m] for t in u))
            m = h
        h_pts = self.ec_cds.ifft(tuple(t[0] for t in u))
        inf = g1.infinity((cds // 2,), self.device)
        h_pts = tuple(torch.cat([t[:cds // 2], i]) for t, i in zip(h_pts, inf))
        proofs = self.ec_cds.fft(h_pts)
        return tuple(t.index_select(0, self._brp[CELLS_PER_EXT_BLOB]) for t in proofs)

    def compute_cells_and_kzg_proofs(self, blob: bytes):
        """-> (128 cells, 128 48-byte proofs), or None."""
        coeffs = self._blob_to_coeffs(blob)
        if coeffs is None:
            return None
        cells = self._coeffs_to_cells_bytes(coeffs)
        return cells, _compress(self.ctx, self._fk20_proofs(coeffs))

    # -- batch verification -----------------------------------------------------------------

    def _batch_challenge(self, unique_commitments, commitment_indices, cell_indices, cells,
                         proofs) -> int:
        """The Fiat-Shamir r: sha256 of the spec's transcript, mod r."""
        t = [RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN,
             FIELD_ELEMENTS_PER_BLOB.to_bytes(8, "big"),
             FIELD_ELEMENTS_PER_CELL.to_bytes(8, "big"),
             len(unique_commitments).to_bytes(8, "big"),
             len(cell_indices).to_bytes(8, "big")]
        t.extend(unique_commitments)
        for k in range(len(cell_indices)):
            t.append(commitment_indices[k].to_bytes(8, "big"))
            t.append(cell_indices[k].to_bytes(8, "big"))
            t.append(cells[k])
            t.append(proofs[k])
        return int.from_bytes(hashlib.sha256(b"".join(t)).digest(), "big") % self.ctx.r

    def _decompress(self, data: bytes):
        """Compressed G1 points -> ((x, y) Montgomery, inf) on the device, or
        None if any is not a valid encoding of a point of G1 (host flags and
        range, then K13's square root and subgroup check)."""
        x, sign, inf, host_ok = parse_g1_host(data)
        if not host_ok.all():
            return None
        dev = self.device
        (xm, y), ok = get_cuda_g1(self.ctx.name).decompress(
            lb.to_tensor(x, dev), torch.as_tensor(sign, device=dev))
        inf = torch.as_tensor(inf, device=dev)
        if not bool((ok | inf).all()):
            return None
        return (xm, y), inf

    def _scalars(self, ints, mask_inf):
        """Canonical scalar limbs on the device, zero where the point is
        infinity."""
        s = self.ctx.scalars_to_limbs(ints, self.device)
        return torch.where(mask_inf[:, None], torch.zeros_like(s), s)

    def verify_cell_kzg_proof_batch(self, commitments, cell_indices, cells, proofs):
        """commitments and proofs: 48-byte strings; cells: 2048-byte strings;
        cell_indices: ints. -> True/False, or None on malformed input (the
        universal verification equation as one 2-pair check)."""
        n = len(cell_indices)
        if not (len(commitments) == len(cells) == len(proofs) == n):
            return None
        if n == 0:
            return True
        if any(i >= CELLS_PER_EXT_BLOB for i in cell_indices):
            return None
        if any(len(c) != BYTES_PER_CELL for c in cells):
            return None
        if any(c is None or len(c) != BYTES_PER_G1 for c in commitments):
            return None
        if any(p is None or len(p) != BYTES_PER_G1 for p in proofs):
            return None
        ctx, F, g1 = self.ctx, self.fr, self.ctx.g1
        r_mod = ctx.r

        unique, cidx = [], []                 # first-occurrence order
        for c in commitments:
            if c not in unique:
                unique.append(c)
            cidx.append(unique.index(c))
        pts = self._decompress(b"".join(unique) + b"".join(proofs))
        if pts is None:
            return None
        (xs, ys), inf = pts
        nu = len(unique)
        proofs_aff, p_inf = (xs[nu:], ys[nu:]), inf[nu:]
        limbs, ok = scalars_from_bytes(b"".join(cells))
        if not ok.all():
            return None

        r = self._batch_challenge(unique, cidx, cell_indices, cells, proofs)
        r_powers = [pow(r, k, r_mod) for k in range(n)]

        # sum_k r^k proof_k
        proof_lincomb = msm(g1, proofs_aff, self._scalars(r_powers, p_inf), scalar_bits=255)
        # the commitment weights sum_{k: commitment i} r^k
        weights = [0] * nu
        for k in range(n):
            weights[cidx[k]] = (weights[cidx[k]] + r_powers[k]) % r_mod
        # the aggregated interpolation polynomial: cell iNTTs (batched),
        # coefficient j scaled by r^k h_k^-j, summed over k
        evals = F.to_mont(lb.to_tensor(limbs, self.device).reshape(n, FIELD_ELEMENTS_PER_CELL,
                                                                   F.NL))
        col = self.dom_cell.intt(evals.index_select(1, self._brp[FIELD_ELEMENTS_PER_CELL]))
        scale = []
        for k in range(n):
            hinv = pow(self.coset_shifts[cell_indices[k]], -1, r_mod)
            cur = r_powers[k]
            for _ in range(FIELD_ELEMENTS_PER_CELL):
                scale.append(cur)
                cur = cur * hinv % r_mod
        # canonical (the MSM's scalars): a product by the canonical one leaves
        # the Montgomery domain, and the sums and negation below commute with it
        agg = F.prod(col, F.encode(scale, self.device).reshape(col.shape),
                     F.consts(self.device)["one_canon"])
        while agg.shape[0] > 1:
            h = agg.shape[0] // 2
            head = F.add(agg[:h], agg[h:2 * h])
            agg = torch.cat([head, agg[2 * h:]]) if agg.shape[0] % 2 else head
        # the proofs' weights r^k h_k^64
        ws = [r_powers[k] * pow(self.coset_shifts[cell_indices[k]], FIELD_ELEMENTS_PER_CELL,
                                r_mod) % r_mod for k in range(n)]
        # sum_i weight_i C_i - [I(tau)]G1 + sum_k ws_k proof_k, the reference's
        # three MSMs as one over the commitments, [tau^j]G1 (j < 64) and the proofs
        mx, my = self.settings.g1_monomial
        L = FIELD_ELEMENTS_PER_CELL
        final_g1 = msm(g1, (torch.cat([xs[:nu], mx[:L], xs[nu:]]),
                            torch.cat([ys[:nu], my[:L], ys[nu:]])),
                       torch.cat([self._scalars(weights, inf[:nu]), F.neg(agg[0]),
                                  self._scalars(ws, p_inf)]), scalar_bits=255)
        # e(final, [1]G2) * e(-proof_lincomb, [tau^64]G2) == 1
        P = tuple(torch.stack([a, b]) for a, b in zip(final_g1, g1.neg(proof_lincomb)))
        (fx, fy), skip = g1.to_affine(P)
        g2x, g2y = self.settings.g2_monomial
        sel = [0, FIELD_ELEMENTS_PER_CELL]
        return get_pairing(ctx.name).pairing_check((fx, fy), (g2x[sel], g2y[sel]),
                                                   skip_mask=skip)

    # -- recovery ---------------------------------------------------------------------------

    def recover_cells_and_kzg_proofs(self, cell_indices, cells):
        """At least half of the 128 cells -> (all 128 cells, their 128
        proofs), or None (erasure decoding by the vanishing polynomial)."""
        n = len(cell_indices)
        if len(cells) != n:
            return None
        if n < CELLS_PER_EXT_BLOB // 2 or n > CELLS_PER_EXT_BLOB:
            return None
        if len(set(cell_indices)) != n:
            return None
        if any(i >= CELLS_PER_EXT_BLOB for i in cell_indices):
            return None
        if any(len(c) != BYTES_PER_CELL for c in cells):
            return None
        limbs, ok = scalars_from_bytes(b"".join(cells))
        if not ok.all():
            return None
        cell_scalars = limbs.reshape(n, FIELD_ELEMENTS_PER_CELL, self.fr.NL)
        if n == CELLS_PER_EXT_BLOB:
            coeffs = self._cells_to_coeffs_full(cell_indices, cell_scalars)
        else:
            coeffs = self._recover_coeffs(cell_indices, cell_scalars)
        if coeffs is None:
            return None
        coeffs = coeffs[:FIELD_ELEMENTS_PER_BLOB]
        cells_out = self._coeffs_to_cells_bytes(coeffs)
        for idx, orig in zip(cell_indices, cells):     # the inputs must be reproduced
            if cells_out[idx] != orig:
                return None
        return cells_out, _compress(self.ctx, self._fk20_proofs(coeffs))

    def _assemble_ext_brp(self, cell_indices, cell_scalars):
        """(8192, 8) canonical limbs in brp order, zero where a cell is missing."""
        ext = np.zeros((FIELD_ELEMENTS_PER_EXT_BLOB, self.fr.NL), np.uint32)
        for idx, s in zip(cell_indices, cell_scalars):
            ext[idx * FIELD_ELEMENTS_PER_CELL:(idx + 1) * FIELD_ELEMENTS_PER_CELL] = s
        return ext

    def _ext_natural(self, cell_indices, cell_scalars):
        """The extended evaluations in natural order, Montgomery, on the device."""
        ext = self._assemble_ext_brp(cell_indices, cell_scalars)
        e_brp = self.fr.to_mont(lb.to_tensor(ext, self.device))
        return e_brp.index_select(0, self._brp[FIELD_ELEMENTS_PER_EXT_BLOB])

    @staticmethod
    def _low_degree(coeffs):
        """coeffs if the degree is below 4096, else None."""
        return None if bool(coeffs[FIELD_ELEMENTS_PER_BLOB:].any()) else coeffs

    def _cells_to_coeffs_full(self, cell_indices, cell_scalars):
        return self._low_degree(self.dom_ext.intt(self._ext_natural(cell_indices, cell_scalars)))

    def _recover_coeffs(self, cell_indices, cell_scalars):
        F, r_mod = self.fr, self.ctx.r
        present = set(cell_indices)
        missing = [i for i in range(CELLS_PER_EXT_BLOB) if i not in present]
        # the vanishing polynomial of the missing cosets, in X^64 (their
        # heads^64 are 128th roots), built on the host
        z_short = [1]
        for i in missing:
            root = pow(self.coset_shifts[i], FIELD_ELEMENTS_PER_CELL, r_mod)
            new = [0] * (len(z_short) + 1)
            for d, cv in enumerate(z_short):
                new[d] = (new[d] - cv * root) % r_mod
                new[d + 1] = (new[d + 1] + cv) % r_mod
            z_short = new
        z_coeffs = [0] * FIELD_ELEMENTS_PER_EXT_BLOB
        for d, cv in enumerate(z_short):
            z_coeffs[d * FIELD_ELEMENTS_PER_CELL] = cv
        zc = F.encode(z_coeffs, self.device)

        e_nat = self._ext_natural(cell_indices, cell_scalars)
        ez_coeffs = self.dom_ext.intt(F.mul(e_nat, self.dom_ext.ntt(zc)))
        # divide on a shifted coset, where Z has no zeros
        ez_shift = self.dom_ext.coset_ntt(ez_coeffs, RECOVERY_SHIFT)
        z_shift = self.dom_ext.coset_ntt(zc, RECOVERY_SHIFT)
        q_evals = F.mul(ez_shift, F.batch_inv(z_shift))
        return self._low_degree(self.dom_ext.coset_intt(q_evals, RECOVERY_SHIFT))


@functools.lru_cache(maxsize=None)
def _peerdas_on(device: torch.device) -> PeerDAS:
    das = PeerDAS(get_settings(device))
    das.bank                                   # built with the context, on the device
    return das


def get_peerdas(device="cuda") -> PeerDAS:
    """The process-wide PeerDAS context of a device: the setup (with the
    monomial points) and the FK20 bank, built once."""
    return _peerdas_on(resolve_device(device))


def _context(das, device) -> PeerDAS:
    return das or get_peerdas(device)


def compute_cells(blob: bytes, das: PeerDAS = None, device="cuda"):
    """-> 128 cells of 2048 bytes, or None on an invalid blob."""
    return _context(das, device).compute_cells(blob)


def compute_cells_and_kzg_proofs(blob: bytes, das: PeerDAS = None, device="cuda"):
    """-> (128 cells, 128 48-byte proofs), or None on an invalid blob."""
    return _context(das, device).compute_cells_and_kzg_proofs(blob)


def verify_cell_kzg_proof_batch(commitments, cell_indices, cells, proofs, das: PeerDAS = None,
                                device="cuda"):
    """True/False, or None on malformed input; True for an empty batch."""
    return _context(das, device).verify_cell_kzg_proof_batch(commitments, cell_indices, cells,
                                                             proofs)


def recover_cells_and_kzg_proofs(cell_indices, cells, das: PeerDAS = None, device="cuda"):
    """-> (128 cells, 128 proofs) from at least 64 distinct cells, or None."""
    return _context(das, device).recover_cells_and_kzg_proofs(cell_indices, cells)
